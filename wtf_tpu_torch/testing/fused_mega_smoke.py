"""Fused-megachunk smoke: the window-level bars of the fused step (K1)
inside megachunk windows, the counterpart of
wtf_tpu/testing/fused_mega_smoke.py.

    python -m wtf_tpu_torch.testing.fused_mega_smoke --device cpu

(`--device` defaults to cuda, like every entry point of the port):

  parity      a devmangle campaign through windows whose quiesce runs K1
              + the bounded precise resume (fused_step=on) must be
              bit-identical to the precise-step window campaign at equal
              seeds — coverage/edge bitmap bytes, corpus digests, crash
              buckets and counts — and must launch K1 inside its windows
              (device.fused_window_rounds > 0);
  occupancy   >= 0.95 of the fused campaign's retired instructions
              retire inside K1 (device.fused_steps / device.instructions);
  in place    what the port does where the JAX package donates the
              window's operands: the machine's 13 planes keep their
              storage across every window (the same data_ptr before and
              after it), and device.fused_window_bytes_saved equals
              fused_window_rounds x those planes' bytes.  The JAX smoke
              reads a jaxpr census and the compiled executable's aliasing
              here; torch has neither, and in-place planes are the
              property that census proves.

Exit 0 = all held; any assertion prints and exits 1.
"""

from __future__ import annotations

import argparse
import sys


def _plane_ptrs(m) -> list:
    ov = m.overlay
    return [t.data_ptr() for t in (
        m.gpr, m.rip, m.rflags, m.status, m.icount, m.bp_skip, m.ctr, m.cov,
        m.edge, ov.pfn, ov.data, ov.valid, ov.count)]


def _leg(device) -> None:
    from wtf_tpu_torch.testing.fused_smoke import (
        fingerprint, smoke_campaign, window_campaign,
    )

    # 8 batches: finds land in batches inside a window, so the find-stop
    # slab seam — where fused/ladder skew would surface — is hit
    ladder, fp_ladder = window_campaign(device, 4 * 8, megachunk=3,
                                        fused_step="off")
    fused = smoke_campaign(device, megachunk=3, fused_step="on")
    backend, moved = fused.backend, []
    dispatch = backend._dispatch_window

    def watched(*args):
        """The window, noting each one after which a plane changed
        storage."""
        before = _plane_ptrs(backend.runner.machine)
        out = dispatch(*args)
        if _plane_ptrs(backend.runner.machine) != before:
            moved.append(backend.registry.counter("megachunk.windows").value)
        return out

    backend._dispatch_window = watched
    fused.fuzz(runs=4 * 8)
    fp_fused = fingerprint(fused)
    for key in fp_ladder:
        assert fp_fused[key] == fp_ladder[key], (
            f"fused window diverged from the ladder window on {key}")
    reg = fused.registry
    rounds = int(reg.counter("device.fused_window_rounds").value)
    windows = int(reg.counter("megachunk.windows").value)
    assert rounds > 0, "fused campaign never launched K1 in a window"
    assert int(ladder.registry.counter(
        "device.fused_window_rounds").value) == 0
    print(f"[fused-mega-smoke] fused-window parity held "
          f"({fp_ladder['testcases']} testcases, {rounds} K1 launches in "
          f"{windows} windows)")

    instr = int(reg.counter("device.instructions").value)
    in_kernel = int(reg.counter("device.fused_steps").value)
    occ = in_kernel / max(instr, 1)
    print(f"[fused-mega-smoke] in-window occupancy {occ:.4f} "
          f"({in_kernel}/{instr} retired in-kernel)")
    assert instr > 1000, "campaign barely ran"
    assert occ >= 0.95, (
        f"in-window occupancy {occ:.4f} < 0.95 — lanes are retiring on "
        f"the park-resume leg instead of inside the kernel")

    assert not moved, f"planes changed storage in windows {moved}"
    saved = int(reg.counter("device.fused_window_bytes_saved").value)
    per = fused.backend._fused_alias_bytes()
    assert saved == rounds * per, (
        f"bytes-saved {saved} != {rounds} rounds x {per} in-place plane "
        f"bytes")
    print(f"[fused-mega-smoke] planes in place across all {windows} "
          f"windows ({saved} bytes = {rounds} K1 launches x {per} plane "
          f"bytes never copied through)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a CUDA device), "
                         "cuda:N, or cpu")
    device = ap.parse_args(argv).device
    try:
        _leg(device)
    except AssertionError as e:
        print(f"[fused-mega-smoke] FAILED: {e}")
        return 1
    print("[fused-mega-smoke] OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
