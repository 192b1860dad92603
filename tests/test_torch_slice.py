"""The port's first slice end to end: demo_tlv `run` and `campaign` with
`--fused-step on`, against the JAX package's tpu backend, on the CPU.

  * `run` on a demo_tlv crasher and a benign input: the same results and
    every machine plane (statuses, icount, counters, coverage/edge
    bitmaps, the raw overlay planes) and the pages the guest wrote
  * a seeded 8-lane campaign: the same corpus digests, crash names,
    coverage/edge aggregates and device counters; demo_tlv never reaches
    an opclass this slice leaves to the oracle
  * the package imports neither jax nor wtf_tpu (a fresh process, and an
    AST check of every module)
  * without `--device cpu` the entry points refuse to run on a machine
    without CUDA
"""

import ast
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import torchport as tp
from tests.torchport import one_torch_thread  # noqa: F401  (module fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
CRASHER = bytes([1, 8]) + b"A" * 8 + bytes([3, 0x30]) + b"B" * 0x30
BENIGN = bytes([1, 8]) + b"A" * 8 + bytes([2, 8]) + b"C" * 8
N_LANES = 8


def _jax_backend(limit=0):
    from wtf_tpu.backend import create_backend
    from wtf_tpu.harness import demo_tlv

    b = create_backend("tpu", demo_tlv.build_snapshot(), n_lanes=N_LANES,
                       limit=limit, fused_step="on")
    b.initialize()
    demo_tlv.TARGET.init(b)
    return b, demo_tlv.TARGET


def _port_backend(limit=0):
    from wtf_tpu_torch.backend.gpu import GpuBackend
    from wtf_tpu_torch.harness import demo_tlv

    b = GpuBackend(demo_tlv.build_snapshot(), n_lanes=N_LANES, limit=limit,
                   device="cpu", fused_step="on")
    b.initialize()
    demo_tlv.TARGET.init(b)
    return b, demo_tlv.TARGET


def test_run_matches_tpu_backend(tmp_path):
    from wtf_tpu_torch import cli
    from wtf_tpu_torch.harness.demo_tlv import INPUT_GVA

    jb, jt = _jax_backend()
    tb, tt = _port_backend()
    for data in (CRASHER, BENIGN):
        jt.insert_testcase(jb, data)
        tt.insert_testcase(tb, data)
        jr, tr = jb.run(), tb.run()
        assert str(jr) == str(tr)
        tp.assert_machines_equal(jb.runner.machine, tb.runner.machine,
                                 where=repr(data[:4]))
        jv, tv = jb.runner.view(), tb.runner.view()
        for gva in (INPUT_GVA, 0x0000_7FFF_E000):       # input, stack
            pfn = tv.translate(0, gva) >> 12
            assert jv.page(0, pfn) == tv.page(0, pfn)
        assert jb.last_new_coverage() == tb.last_new_coverage()
        jb.restore(), tb.restore()
    # the CLI's `run` reports the same crash, rip and icount
    path = tmp_path / "crasher.bin"
    path.write_bytes(CRASHER)
    args = cli.build_parser().parse_args(
        ["run", "--name", "demo_tlv", "--input", str(path),
         "--fused-step", "on", "--device", "cpu"])
    _, runs = cli.replay(args)
    assert str(runs[0].result) == "crash(crash-execute-0x4242424242424242)"
    assert runs[0].rip == 0x4242424242424242
    assert runs[0].icount > 0
    assert not any(k.startswith("not-yet-ported")
                   for k in tb.runner.stats["fallbacks_by_opclass"])


def test_campaign_matches_tpu_backend():
    from wtf_tpu.fuzz.corpus import Corpus
    from wtf_tpu.fuzz.loop import FuzzLoop
    from wtf_tpu_torch import cli

    runs, seed, max_len, limit = 32, 5, 96, 20000
    jb, jt = _jax_backend(limit)
    rng = random.Random(seed)
    jloop = FuzzLoop(jb, jt, jt.create_mutator(rng, max_len),
                     Corpus(rng=rng))
    jloop.fuzz(runs=runs)
    args = cli.build_parser().parse_args(
        ["campaign", "--name", "demo_tlv", "--fused-step", "on", "--lanes",
         str(N_LANES), "--runs", str(runs), "--limit", str(limit),
         "--max_len", str(max_len), "--seed", str(seed), "--device", "cpu"])
    tloop = cli.campaign(args)
    tb = tloop.backend
    assert sorted(jloop.corpus.digests) == sorted(tloop.corpus.digests)
    assert jloop.crash_names == tloop.crash_names
    assert jloop.crash_buckets == tloop.crash_buckets
    for f in ("testcases", "crashes", "timeouts", "new_coverage"):
        assert getattr(jloop.stats, f) == getattr(tloop.stats, f), f
    assert np.asarray(jb._agg_cov).tobytes() \
        == tb._agg_cov.numpy().tobytes()
    assert np.asarray(jb._agg_edge).tobytes() \
        == tb._agg_edge.numpy().tobytes()
    for name in ("device.instructions", "device.fused_steps",
                 "device.fused_park_subset", "device.fused_park_mem",
                 "device.decode_misses", "device.mem_faults"):
        assert jb.registry.counter(name).value \
            == tb.registry.counter(name).value, name
    fused = tb.registry.counter("device.fused_steps").value
    assert fused / tb.registry.counter("device.instructions").value >= 0.95
    assert not any(k.startswith("not-yet-ported")
                   for k in tb.runner.stats["fallbacks_by_opclass"])
    assert set(tb.status_counts) <= {"OK", "PAGE_FAULT", "TIMEDOUT"}


def test_package_imports_no_jax():
    code = ("import sys, pkgutil, importlib, wtf_tpu_torch\n"
            "for m in pkgutil.walk_packages(wtf_tpu_torch.__path__, "
            "'wtf_tpu_torch.'):\n"
            "    if not m.name.endswith('__main__'):\n"
            "        importlib.import_module(m.name)\n"
            "import wtf_tpu_torch.cli, wtf_tpu_torch.backend.gpu\n"
            "import wtf_tpu_torch.devmut, wtf_tpu_torch.fuzz.megachunk\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'wtf_tpu.')) or m == 'wtf_tpu']\n"
            "assert not bad, bad\n"
            "print(len([m for m in sys.modules "
            "if m.startswith('wtf_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 40


def test_no_module_imports_jax_or_wtf_tpu():
    files = sorted((REPO / "wtf_tpu_torch").rglob("*.py")) \
        + [REPO / "chip_smoke.py"]
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "wtf_tpu"):
                    offenders.append(f"{path.relative_to(REPO)}: {name}")
    assert len(files) > 40 and not offenders, offenders


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    from wtf_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "in.bin"
    path.write_bytes(BENIGN)
    for argv in (["run", "--name", "demo_tlv", "--input", str(path)],
                 ["campaign", "--name", "demo_tlv", "--runs", "4",
                  "--lanes", "2"]):
        with pytest.raises(RuntimeError, match="cuda.is_available"):
            cli.main(argv)
    from wtf_tpu_torch.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
