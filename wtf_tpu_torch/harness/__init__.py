"""Target/harness layer: the user extension surface (SURVEY.md §2.4).

  targets.py    - Target descriptor + self-registering singleton registry
                  (reference src/wtf/targets.h:14-48)
  crash_detection.py - user-mode crash-detection breakpoint set
                  (reference src/wtf/crash_detection_umode.cc:20-167)
  demo_tlv.py   - synthetic TLV-parser demo target with a planted stack
                  overflow (role of the reference's tlv_server demo,
                  src/tlv_server/tlv_server.cc + fuzzer_tlv_server.cc)
"""

from wtf_tpu_torch.harness.targets import Target, Targets, register_target  # noqa: F401
