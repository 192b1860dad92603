"""Fused-step + megachunk smoke: a fast end-to-end pass over the fused
step (K1) and the megachunk window, the counterpart of
wtf_tpu/testing/fused_smoke.py.

    python -m wtf_tpu_torch.testing.fused_smoke --device cpu

(`--device` defaults to cuda, like every entry point of the port):

  occupancy   K1 (interp/pstep.py) must retire >= 0.95 of demo_tlv's
              instructions itself at small lanes, measured from the
              device counter block (CTR_FUSED / CTR_INSTR), with the park
              split reported so a regression names its reason;
  megachunk   a short devmangle campaign through multi-batch windows
              (wtf_tpu_torch/fuzz/megachunk.py) must be bit-identical to
              the batch-at-a-time device loop at equal seeds — aggregate
              coverage/edge bitmap bytes, corpus digests, crash buckets
              and counts.

Exit 0 = all held; any assertion prints and exits 1.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _occupancy_leg(device) -> str:
    from wtf_tpu_torch.analysis.trace import build_tlv_runner
    from wtf_tpu_torch.interp.machine import (
        CTR_FUSED, CTR_INSTR, CTR_PARK_MEM, CTR_PARK_SUBSET,
    )

    r = build_tlv_runner(n_lanes=2, chunk_steps=64,
                         payload=b"\x01\x08AAAAAAAA" * 50, limit=4_000,
                         fused_step="on", device=device)
    r.run()
    ctr = r.machine.ctr.cpu().numpy().view(np.uint32).astype(np.uint64)
    instr = int(ctr[:, CTR_INSTR].sum())
    fused = int(ctr[:, CTR_FUSED].sum())
    occ = fused / max(instr, 1)
    line = (f"[fused-smoke] occupancy {occ:.4f} "
            f"({fused}/{instr} in-kernel; parks "
            f"subset={int(ctr[:, CTR_PARK_SUBSET].sum())} "
            f"mem={int(ctr[:, CTR_PARK_MEM].sum())})")
    print(line)
    assert instr > 1000, "demo_tlv hot loop barely ran"
    assert occ >= 0.95, (
        f"fused occupancy {occ:.4f} < 0.95 — the memory subset "
        f"regressed out of the kernel (check the park split above)")
    return line


def smoke_campaign(device, **kw):
    """The smokes' demo_tlv devmangle campaign (4 lanes, limit 10,000,
    seed 0x5EED; `kw` to build_tlv_campaign), built, not yet fuzzed."""
    from wtf_tpu_torch.analysis.trace import build_tlv_campaign

    return build_tlv_campaign(mutator="devmangle", seed=0x5EED, n_lanes=4,
                              limit=10_000, chunk_steps=128,
                              overlay_slots=16, device=device, **kw)


def fingerprint(loop) -> dict:
    """What the smokes hold equal between two campaigns."""
    from wtf_tpu_torch.utils.hashing import hex_digest

    cov, edge = loop.backend.coverage_state()
    return {
        "cov": cov.tobytes(), "edge": edge.tobytes(),
        "corpus": [hex_digest(d) for d in loop.corpus],
        "buckets": sorted(loop.crash_buckets),
        "testcases": loop.stats.testcases,
        "crashes": loop.stats.crashes,
        "timeouts": loop.stats.timeouts,
    }


def window_campaign(device, runs: int, **kw):
    """smoke_campaign fuzzed for `runs` testcases -> (loop,
    fingerprint)."""
    loop = smoke_campaign(device, **kw)
    loop.fuzz(runs=runs)
    return loop, fingerprint(loop)


def window_fingerprint(device, runs: int, **kw) -> dict:
    """window_campaign's fingerprint alone."""
    return window_campaign(device, runs, **kw)[1]


def _megachunk_leg(device) -> None:
    # 8 batches, not a cold-cache handful: finds must land in batches
    # inside a window so the find-stop slab schedule (the seam where
    # parity can skew) is actually exercised
    legacy = window_fingerprint(device, 4 * 8, megachunk=0)
    windowed = window_fingerprint(device, 4 * 8, megachunk=3)
    for key in legacy:
        assert windowed[key] == legacy[key], (
            f"megachunk diverged from the batch-at-a-time loop on {key}")
    print(f"[fused-smoke] megachunk parity held "
          f"({legacy['testcases']} testcases, "
          f"{legacy['crashes']} crashes, "
          f"{len(legacy['corpus'])} corpus entries)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a CUDA device), "
                         "cuda:N, or cpu")
    device = ap.parse_args(argv).device
    try:
        _occupancy_leg(device)
        _megachunk_leg(device)
    except AssertionError as e:
        print(f"[fused-smoke] FAILED: {e}")
        return 1
    print("[fused-smoke] OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
