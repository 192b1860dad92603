"""Target/harness layer: the user extension surface (SURVEY.md §2.4).

  targets.py    - Target descriptor + self-registering singleton registry
                  (reference src/wtf/targets.h:14-48)
  crash_detection.py - user-mode crash-detection breakpoint set
                  (reference src/wtf/crash_detection_umode.cc:20-167)
  demo_tlv.py   - synthetic TLV-parser demo target with a planted stack
                  overflow (role of the reference's tlv_server demo,
                  src/tlv_server/tlv_server.cc + fuzzer_tlv_server.cc)
  demo_kernel.py - synthetic ring-0 syscall handler with planted kernel
                  bugs (role of the reference's HEVD target)
  demo_usermode.py - guard-page stack growth and SEH dispatch through a
                  real IDT
  demo_maze.py  - a 4-stage input maze only coverage guidance walks
  demo_spin.py  - deep execution: the input picks the loop count
  demo_ioctl.py - in-place IOCTL rewrite with page-end payload placement
                  (role of the reference's fuzzer_ioctl.cc)
  demo_fs.py    - file I/O through the faked Nt* calls of guestfs.py
                  (reference src/wtf/fshooks.cc)
"""

from wtf_tpu_torch.harness.targets import Target, Targets, register_target  # noqa: F401
