"""Device-decode smoke: the zero-host steady state of `--device-decode`,
the counterpart of wtf_tpu/testing/decode_smoke.py.

    python -m wtf_tpu_torch.testing.decode_smoke --device cpu

(`--device` defaults to cuda, like every entry point of the port).  A
COLD-CACHE demo_tlv devmangle window campaign with device decode
(interp/devdec.py) must

  * finish its megachunk windows with ZERO host decode services — every
    decode-cache miss, the cold start's included, serviced inside the
    window, the host decoder running only as the harvest's cross-check;
  * cross-check clean: every device-published entry equal to the host
    decoder's (devdec.crosscheck_mismatches == 0);
  * be bit-identical to the host-serviced run at equal seeds —
    coverage/edge bitmap bytes, corpus digests, crash buckets, and the
    decode cache's entry INDICES (the coverage-bit mapping).

The JAX smoke also asks that a speculative next window be adopted.  The
port never launches a window ahead: its window updates the machine in
place (GpuBackend.run_megachunk), so a dropped speculation would have
nothing to fall back to — the same reason the JAX package does not
prelaunch its donated window.  This smoke asserts that none was
(megachunk.prelaunched == 0).

Exit 0 = all held; any assertion prints and exits 1.
"""

from __future__ import annotations

import argparse
import sys


def _leg(device) -> None:
    from wtf_tpu_torch.testing.fused_smoke import window_campaign

    def campaign(**kw):
        # long enough that finds land inside windows AND steady-state
        # windows (complete, find-free) exist
        loop, fp = window_campaign(device, 4 * 16, megachunk=4, **kw)
        fp["entries"] = loop.backend.runner.cache.checkpoint_entries()
        return loop, fp

    ref_loop, ref = campaign()
    dd_loop, dd = campaign(device_decode=True)
    for key in ref:
        assert dd[key] == ref[key], (
            f"--device-decode diverged from the host-serviced "
            f"reference on {key}")
    reg = dd_loop.backend.registry
    published = reg.counter("devdec.published").value
    mismatches = reg.counter("devdec.crosscheck_mismatches").value
    host_decodes = dd_loop.backend.runner.stats["decodes"]
    zero_windows = reg.counter("devdec.zero_host_windows").value
    windows = reg.counter("megachunk.windows").value
    prelaunched = reg.counter("megachunk.prelaunched").value
    assert published > 0, "no device-published decode entries"
    assert mismatches == 0, (
        f"{mismatches} device entries disagreed with the host decoder")
    assert host_decodes == 0, (
        f"{host_decodes} host decode services in a --device-decode "
        f"campaign — the zero-host window broke")
    assert zero_windows > 0, "no zero-host windows recorded"
    assert prelaunched == 0, (
        f"{prelaunched} windows launched ahead of their harvest")
    print(f"[decode-smoke] zero-host steady state held: "
          f"{published} entries device-published, cross-check clean, "
          f"0 host decode services "
          f"({ref_loop.backend.runner.stats['decodes']} in the reference), "
          f"{zero_windows}/{windows} zero-host windows, no window "
          f"launched ahead")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a CUDA device), "
                         "cuda:N, or cpu")
    device = ap.parse_args(argv).device
    try:
        _leg(device)
    except AssertionError as e:
        print(f"[decode-smoke] FAILED: {e}")
        return 1
    print("[decode-smoke] OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
