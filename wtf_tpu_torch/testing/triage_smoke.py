"""Triage smoke: the counterpart of wtf_tpu/testing/triage_smoke.py.

    python -m wtf_tpu_torch.testing.triage_smoke --device cpu

(`--device` defaults to cuda, like every entry point of the port).  A
tiny end-to-end pass over the batched triage engine (wtf_tpu_torch/
triage) on demo_tlv, through the port's CLI:

  minimize  a seeded crasher (junk records around a type-3 stack smash)
            must shrink to the known-minimal 34-byte reproducer of the
            SAME crash bucket — header + zeroed filler + the 8 bytes
            that become the smashed return address;
  distill   the kept minset must be a subset of the input corpus (by
            content digest) with the full corpus' aggregate coverage
            (the set-cover invariant; distill() asserts equality).

Exit 0 = all held; any assertion prints and exits 1.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

# the canonical demo_tlv crasher family (the JAX package's
# tests/test_triage.py shares the layout): type-3 record copies 32 bytes
# into an 8-byte stack buffer — offsets 16..23 smash the saved rbp,
# 24..31 the return address
SMASH = bytes([3, 32]) + bytes(range(65, 89)) + b"\x41" * 8
CRASHER = b"\x01\x02XY" + SMASH + b"\x01\x03ZZZ"
MINIMAL = bytes([3, 32]) + bytes(24) + b"\x41" * 8

SEEDS = {
    "a": b"\x01\x02XY",
    "b": b"\x01\x03ABC",
    "c": b"\x02\x08QQQQQQQQ",
    "d": b"\x01\x02XY\x02\x08WWWWWWWW",
    "e": b"\x03\x04abcd",
}


def _engine(device: str) -> list:
    """The device and its engine: K1 on a card, the precise step alone on
    the CPU (the fused step is bit-transparent, so the pins are the
    same)."""
    return ["--device", device, "--fused-step", "auto"]


def _legs(device: str) -> None:
    from wtf_tpu_torch.cli import main as cli_main
    from wtf_tpu_torch.utils.hashing import hex_digest

    with tempfile.TemporaryDirectory(prefix="wtf-triage-smoke-") as td:
        root = Path(td)
        crash = root / "crash.bin"
        crash.write_bytes(CRASHER)
        target = root / "t"
        (target / "inputs").mkdir(parents=True)
        for name, data in SEEDS.items():
            (target / "inputs" / name).write_bytes(data)

        # -- minimize leg --------------------------------------------
        rc = cli_main(["triage", "minimize", "--name", "demo_tlv",
                       "--input", str(crash), "--lanes", "16",
                       "--limit", "20000", *_engine(device)])
        assert rc == 0, f"minimize rc={rc}"
        minimized = (root / "crash.bin.min").read_bytes()
        assert len(minimized) < len(CRASHER), (
            f"reproducer did not shrink: {len(minimized)} vs "
            f"{len(CRASHER)}")
        assert minimized == MINIMAL, (
            f"not the known-minimal reproducer: {minimized.hex()}")
        print(f"[triage-smoke] minimize: {len(CRASHER)} -> "
              f"{len(minimized)} bytes (known-minimal, same bucket)")

        # -- distill leg ---------------------------------------------
        rc = cli_main(["triage", "distill", "--name", "demo_tlv",
                       "--target", str(target), "--lanes", "16",
                       "--limit", "20000", *_engine(device)])
        assert rc == 0, f"distill rc={rc}"
        corpus_digests = {hex_digest(d) for d in SEEDS.values()}
        kept = sorted((target / "outputs").iterdir())
        assert kept, "distill kept nothing"
        assert len(kept) < len(SEEDS), (
            f"minset did not shrink: {len(kept)}/{len(SEEDS)}")
        for p in kept:
            digest = hex_digest(p.read_bytes())
            assert digest in corpus_digests, (
                f"minset member {p.name} is not in the input corpus")
            assert p.name == digest, f"non-digest-named output {p.name}"
        print(f"[triage-smoke] distill: kept {len(kept)}/{len(SEEDS)} "
              "seeds, minset ⊆ corpus, coverage preserved")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a CUDA device), "
                         "cuda:N, or cpu")
    device = ap.parse_args(argv).device
    try:
        _legs(device)
    except AssertionError as e:
        print(f"[triage-smoke] FAILED: {e}")
        return 1
    print("[triage-smoke] PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
