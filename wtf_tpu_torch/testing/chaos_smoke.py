"""Chaos smoke, resume leg: the counterpart of the resume leg of
wtf_tpu/testing/chaos_smoke.py.

    python -m wtf_tpu_torch.testing.chaos_smoke --device cpu [--seed N]

(`--device` defaults to cuda, like every entry point of the port).  A
seeded demo_tlv devmangle campaign on the GPU backend checkpoints every
batch and is killed at a batch boundary; the NEWEST checkpoint is then
torn (truncated), so the resume must detect the digest mismatch and fall
back to `.prev`.  The resumed run's final coverage, crash set, corpus,
stats and aggregate edge bitmap must be bit-identical to an
uninterrupted reference.

The JAX smoke's other leg (a master and an emu node under scripted
socket resets: no lost testcase) is held by tests/test_torch_chaos.py
and by chip_smoke.py phase 29 (the node under `chaos_dialing`).

Exit 0 and a PASS line when every assertion held; a failed one prints
and exits 1.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

SEED = 0xC4A05


def _state(loop) -> tuple:
    return (loop._coverage(), sorted(loop.corpus.digests),
            sorted(loop.crash_names), loop.stats.testcases,
            int(loop.backend.coverage_state()[1].astype("uint64").sum()))


def resume_leg(seed: int, device) -> dict:
    from wtf_tpu_torch.analysis.trace import build_tlv_campaign
    from wtf_tpu_torch.resume import load_campaign, restore_campaign
    from wtf_tpu_torch.testing.faultinject import (
        fuzz_until_killed, tear_file,
    )

    lanes, batches = 8, 4
    runs = lanes * batches
    # K1 on a card, the precise step alone on the CPU (bit-transparent)
    build = dict(n_lanes=lanes, mutator="devmangle", limit=20_000,
                 seed=seed & 0xFFFF, chunk_steps=128, overlay_slots=16,
                 fused_step="auto", device=device)

    # uninterrupted reference
    ref = build_tlv_campaign(**build)
    ref.fuzz(runs)
    ref_state = _state(ref)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "checkpoint"
        victim = build_tlv_campaign(**build)
        victim.checkpoint_dir = ckpt
        victim.checkpoint_every = 1
        fuzz_until_killed(victim, runs, kill_at_batch=2)
        # the kill also tore the newest checkpoint: the loader must
        # reject it by digest and fall back to .prev (batch 1)
        tear_file(ckpt / "checkpoint.json")
        state, fell_back = load_campaign(ckpt)
        assert fell_back, "torn newest checkpoint was not detected"
        resumed = build_tlv_campaign(**build)
        resumed.checkpoint_dir = ckpt
        resumed.checkpoint_every = 1
        batch = restore_campaign(resumed, state, ckpt)
        assert batch == 1, batch
        resumed.fuzz(runs)
        res_state = _state(resumed)
        assert res_state == ref_state, \
            f"resume parity broken:\n ref {ref_state}\n got {res_state}"
    return {"coverage": ref_state[0], "corpus": len(ref_state[1]),
            "resumed_from_batch": batch, "fell_back": fell_back}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a CUDA device), "
                         "cuda:N, or cpu")
    ap.add_argument("--seed", type=lambda v: int(v, 0), default=SEED)
    args = ap.parse_args(argv)
    print(f"chaos-smoke seed={args.seed:#x}")
    try:
        res = resume_leg(args.seed, args.device)
    except AssertionError as e:
        print(f"chaos-smoke FAILED: {e}")
        return 1
    print(f"resume leg OK: {res}")
    print("chaos-smoke PASS (torn-checkpoint fallback, resume parity)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
