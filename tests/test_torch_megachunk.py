"""The port's megachunk window (wtf_tpu_torch/fuzz/megachunk.py) and
batch-at-a-time device loop against the JAX package, on the CPU.

  * a demo_tlv devmangle campaign of 12 batches of 8 lanes (limit 20000,
    16 overlay slots, seed 0x5EED: the shapes of tests/test_megachunk.py)
    with --megachunk 0, 1 and 4, fused step off and on, against the JAX
    ladder window campaign at the same seed: coverage/edge bytes, corpus
    digests in order, crash names and buckets, testcases, timeouts,
    new_coverage and retired instructions all equal.  12 batches, so new
    coverage lands in batches inside a window and the slab schedule's lag
    is exercised.  (The JAX package pins its fused window equal to its
    ladder window itself, and interpret-mode Pallas is slow on the CPU.)
  * the window's counters: K1 rounds only with the fused step, and the
    bytes-saved counter = rounds x the 13 planes' bytes
  * the three configuration errors
  * the CLI: `python -m wtf_tpu_torch campaign --mutator devmangle
    --megachunk 4 --device cpu` against `python -m wtf_tpu campaign ...
    --backend tpu` at equal seeds: the same final stats line (less its
    rates and times), outputs/ and crashes/
"""

import os
import random
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from wtf_tpu.analysis.trace import build_tlv_campaign
from wtf_tpu.utils.hashing import hex_digest
from tests.torchport import one_torch_thread  # noqa: F401  (module fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
BUILD = dict(n_lanes=8, limit=20_000, chunk_steps=128, overlay_slots=16)
RUNS = BUILD["n_lanes"] * 12
SEED = 0x5EED
SEED_INPUT = b"\x01\x04AAAA\x02\x08BBBBBBBB"   # build_tlv_campaign's seed
MAX_LEN = 0x400


def _fingerprint(loop, cov, edge) -> dict:
    return {
        "cov": cov.tobytes(),
        "edge": edge.tobytes(),
        "corpus_order": [hex_digest(d) for d in loop.corpus],
        "crashes": sorted(loop.crash_names),
        "buckets": sorted(loop.crash_buckets),
        "testcases": loop.stats.testcases,
        "timeouts": loop.stats.timeouts,
        "new_coverage": loop.stats.new_coverage,
        "instructions": loop.registry.counter("device.instructions").value,
    }


@pytest.fixture(scope="module")
def jax_window():
    """The JAX package's ladder window campaign (the reference)."""
    loop = build_tlv_campaign(mutator="devmangle", seed=SEED, megachunk=4,
                              max_len=MAX_LEN, fused_step="off", **BUILD)
    loop.fuzz(RUNS)
    cov, edge = loop.backend.coverage_state()
    fp = _fingerprint(loop, cov, edge)
    assert fp["new_coverage"] > 1 and fp["testcases"] == RUNS
    return fp


def _port_loop(megachunk: int, fused: str, limit: int = BUILD["limit"],
               mutator: str = "devmangle"):
    from wtf_tpu_torch.backend.gpu import GpuBackend
    from wtf_tpu_torch.fuzz.corpus import Corpus
    from wtf_tpu_torch.fuzz.loop import FuzzLoop
    from wtf_tpu_torch.fuzz.mutator import MangleMutator, create_mutator
    from wtf_tpu_torch.harness import demo_tlv

    backend = GpuBackend(demo_tlv.build_snapshot(),
                         n_lanes=BUILD["n_lanes"], limit=limit,
                         chunk_steps=BUILD["chunk_steps"],
                         overlay_slots=BUILD["overlay_slots"],
                         device="cpu", fused_step=fused)
    backend.initialize()
    demo_tlv.TARGET.init(backend)
    rng = random.Random(SEED)
    corpus = Corpus(rng=rng)
    corpus.add(SEED_INPUT)
    mut = (create_mutator("devmangle", rng, MAX_LEN)
           if mutator == "devmangle" else MangleMutator(rng, MAX_LEN))
    return FuzzLoop(backend, demo_tlv.TARGET, mut, corpus,
                    megachunk=megachunk)


@pytest.mark.parametrize("fused", ["off", "on"])
@pytest.mark.parametrize("megachunk", [0, 1, 4])
def test_port_campaign_equals_jax_window(jax_window, megachunk, fused):
    loop = _port_loop(megachunk, fused)
    loop.fuzz(RUNS)
    b = loop.backend
    fp = _fingerprint(loop, b._agg_cov.numpy().view(np.uint32),
                      b._agg_edge.numpy().view(np.uint32))
    assert fp == jax_window
    reg = loop.registry
    assert loop.batches_done == loop.mutator._batch - (megachunk == 0)
    windows = reg.counter("megachunk.windows").value
    rounds = reg.counter("device.fused_window_rounds").value
    assert (windows > 0) == (megachunk > 0)
    if megachunk:
        assert (rounds > 0) == (fused == "on")
        assert reg.counter("device.fused_window_bytes_saved").value \
            == rounds * b._fused_alias_bytes()
        assert reg.spans.seconds("mutate/device") == 0.0
        assert reg.spans.seconds("execute/device/generate") > 0.0
    if fused == "on":
        instr = reg.counter("device.instructions").value
        assert reg.counter("device.fused_steps").value / instr >= 0.95


def test_megachunk_configuration_errors():
    """Window without the device engine, on a backend without the window
    path, or without an instruction budget: refused at construction."""
    with pytest.raises(ValueError, match="devmangle"):
        _port_loop(4, "off", mutator="mangle")
    with pytest.raises(ValueError, match="limit"):
        _port_loop(4, "off", limit=0)

    from wtf_tpu_torch.fuzz.corpus import Corpus
    from wtf_tpu_torch.fuzz.loop import FuzzLoop

    inner = _port_loop(0, "off")

    class BatchOnly:
        """The backend without its window path."""

        def __getattr__(self, name):
            if name == "run_megachunk":
                raise AttributeError(name)
            return getattr(inner.backend, name)

    with pytest.raises(ValueError, match="GpuBackend"):
        FuzzLoop(BatchOnly(), inner.target,
                 type(inner.mutator)(seed=1, max_len=64), Corpus(),
                 megachunk=4)


def _final_line(stdout: str) -> str:
    """The last `#N cov: .. corp: ..` stats line without its rate and
    uptime (the only fields that depend on the clock)."""
    line = [ln for ln in stdout.splitlines() if ln.startswith("#")][-1]
    return re.sub(r" exec/s: \S+| uptime: \S+", "", line)


def _tree(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hex_digest(p.read_bytes())
            for sub in ("outputs", "crashes") if (root / sub).is_dir()
            for p in sorted((root / sub).iterdir())}


def test_cli_window_campaign_equals_jax_cli(tmp_path):
    args = ["campaign", "--name", "demo_tlv", "--mutator", "devmangle",
            "--megachunk", "4", "--lanes", "8", "--runs", "32", "--limit",
            "20000", "--max_len", "96", "--seed", "5"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {}
    for pkg, extra in (("wtf_tpu_torch", ["--device", "cpu"]),
                       ("wtf_tpu", ["--backend", "tpu"])):
        target = tmp_path / pkg
        procs[pkg] = (target, subprocess.Popen(
            [sys.executable, "-m", pkg] + args + extra
            + ["--target", str(target)], cwd=REPO,
            env=dict(env, OMP_NUM_THREADS="1") if pkg == "wtf_tpu_torch"
            else env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for pkg, (target, proc) in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode in (0, 2), stderr[-2000:]
        out[pkg] = (proc.returncode, _final_line(stdout), _tree(target))
    assert out["wtf_tpu_torch"] == out["wtf_tpu"]
    assert out["wtf_tpu"][1].startswith("#32 cov: ")
    assert any(k.startswith("outputs/") for k in out["wtf_tpu"][2])
