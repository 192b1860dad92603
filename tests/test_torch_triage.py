"""The port's batched triage and the rest of its single-device CLI
(wtf_tpu_torch/triage, `campaign --runs 0`, the common flags) against the
JAX package's, on the CPU; held against tests/test_triage.py and
tests/test_cli.py.

  * `first_hit_credit` on seeded random bitmaps with excluded lanes, and
    `build_candidates` / `zero_counts` over a seeded grid of ops,
    positions and sizes (the clamp edges included), against the JAX
    functions
  * `triage minimize`, `distill` (also `--from-checkpoint` on a port
    checkpoint) and `vbreak`, and `campaign --runs 0`, CLI against CLI at
    demo_tlv's 16 lanes on the crasher and seeds of
    wtf_tpu/testing/triage_smoke.py: the same printed lines, bytes,
    digests and captures; the sweep's credit planes byte for byte
  * vbreak's captures equal the port's own oracle (`oracle_capture` on
    EmuBackend), an unreached rip reports the natural result, and a rip
    the target already owns is refused
  * `campaign --stop-on-crash` with `--inputs/--outputs/--crashes`,
    `run --coverage`, `--telemetry-dir`, `--trace-out` and
    `--target-module`
  * the fuzz loop's harvest dedups crashes by triage bucket

The port runs with `--fused-step on` (K1's plain version), the JAX package
on its default step; every comparison is exact (integer state:
tolerance 0).  The port's minimize runs in a subprocess while the JAX
references run in this one.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from wtf_tpu.testing.triage_smoke import CRASHER, MINIMAL, SEEDS
from wtf_tpu_torch.utils.hashing import hex_digest
from tests.torchport import one_torch_thread  # noqa: F401  (module fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
LANES = ["--lanes", "16", "--limit", "20000"]
PORT = ["--fused-step", "on", "--device", "cpu"]
# the JAX package's verify recipe for vbreak: the loop
# head `cmp r8, r9` at tlv!parse+0x12, second arrival
VBREAK = ["--break-at", "tlv!parse+0x12", "--hit", "2", "--variants", "7"]
VBREAK_INPUT = b"\x01\x02XY\x02\x08WWWWWWWW"
NON_CRASHER = SEEDS["a"]


def _jax(argv):
    """(rc, stdout) of the JAX package's CLI, in this process."""
    from wtf_tpu import cli as jcli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = jcli.main(argv + ["--backend", "tpu"])
    return rc, out.getvalue()


def _port(argv):
    """(rc, stdout) of the port's CLI, in this process, on the CPU."""
    from wtf_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv + PORT)
    return rc, out.getvalue()


def _unclocked(stdout: str) -> list:
    """The printed lines without the clock-dependent fields and without
    the backends' own run-stats lines ([tpu] / [gpu])."""
    return [re.sub(r" exec/s: \S+| uptime: \S+", "", ln)
            for ln in stdout.splitlines() if not ln.startswith("[")]


def _digests(d: Path) -> list:
    return sorted(p.name for p in d.iterdir()) if d.is_dir() else []


def _target(root: Path, seeds=SEEDS) -> Path:
    (root / "inputs").mkdir(parents=True)
    for name, data in seeds.items():
        (root / "inputs" / name).write_bytes(data)
    return root


def _capturing(monkeypatch, module, name, into: list):
    """Wrap `module.name` so every call's return value lands in `into`."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        into.append(out)
        return out
    monkeypatch.setattr(module, name, wrapped)


# ---------------------------------------------------------------------------
# the device halves: first-hit credit and build_candidates
# ---------------------------------------------------------------------------

def _planes(rng, shape):
    """Sparse random u32 bitmaps (three-way AND: lanes overlap often)."""
    return (rng.integers(0, 1 << 32, shape, dtype=np.uint32)
            & rng.integers(0, 1 << 32, shape, dtype=np.uint32)
            & rng.integers(0, 1 << 32, shape, dtype=np.uint32))


def test_first_hit_credit_matches_jax():
    import jax.numpy as jnp

    from wtf_tpu.meshrun.reduce import first_hit_credit as jcredit
    from wtf_tpu_torch.meshrun.reduce import first_hit_credit

    rng = np.random.default_rng(0x7A1)
    t = lambda a: torch.from_numpy(a.view(np.int32).copy())  # noqa: E731
    agg_j = (jnp.zeros(8, jnp.uint32), jnp.zeros(32, jnp.uint32))
    agg_t = (torch.zeros(8, dtype=torch.int32),
             torch.zeros(32, dtype=torch.int32))
    start = np.zeros(40, np.uint32)
    seen = np.zeros(40, np.uint32)
    for batch in range(3):
        cov, edge = _planes(rng, (16, 8)), _planes(rng, (16, 32))
        include = rng.random(16) > 0.25
        include[0] = batch != 1     # an excluded first lane too
        want = jcredit(agg_j[0], agg_j[1], jnp.asarray(cov),
                       jnp.asarray(edge), jnp.asarray(include))
        got = first_hit_credit(agg_t[0], agg_t[1], t(cov), t(edge),
                               torch.from_numpy(include))
        for w, g in zip(want, got):
            assert np.asarray(w).tobytes() == g.numpy().tobytes()
        agg_j, agg_t = want[2:], got[2:]
        credit = np.concatenate([g.numpy().view(np.uint32)
                                 for g in got[:2]], axis=1)
        assert not credit[~include].any()
        seen |= np.bitwise_or.reduce(credit, axis=0)
        assert not (np.bitwise_and.reduce(credit[[1, 2]], axis=0)).any()
    total = np.concatenate([g.numpy().view(np.uint32) for g in agg_t])
    # OR of every credit == the aggregate delta over the sweep
    np.testing.assert_array_equal(seen, total & ~start)
    assert seen.any()


def _descriptor_grid(cur_len: int, max_len: int):
    big = (max_len, 0x7FFFFFFF, 0xFFFFFFF0, 0xFFFFFFFF)
    positions = (0, 1, cur_len - 1, cur_len, cur_len + 1) + big
    sizes = (0, 1, 2, cur_len, cur_len + 5) + big
    return [(op, p, s) for op in range(3) for p in positions for s in sizes]


@pytest.mark.parametrize("cur_len", [1, 2, 43, 64])
def test_build_candidates_matches_jax(cur_len):
    import jax.numpy as jnp

    from wtf_tpu.triage import candidates as jc
    from wtf_tpu_torch.triage import candidates as tc

    max_len = 64
    rng = np.random.default_rng(cur_len)
    data = rng.integers(0, 256, cur_len, dtype=np.uint8)
    data[::5] = 0                                       # zeros to count
    grid = _descriptor_grid(cur_len, max_len)
    grid += [(int(rng.integers(3)), int(rng.integers(max_len + 8)),
              int(rng.integers(max_len + 8))) for _ in range(256 - len(grid))]
    ops = np.array([d[0] for d in grid], np.int32)
    pos = np.array([d[1] for d in grid], np.uint32)
    size = np.array([d[2] for d in grid], np.uint32)
    words, n = jc.pack_testcase(data.tobytes(), max_len)
    assert n == cur_len
    jw, jl = jc.make_build()(jnp.asarray(words), jnp.uint32(n),
                             jnp.asarray(ops), jnp.asarray(pos),
                             jnp.asarray(size))
    jz = jc.make_zero_counts()(jw, jl)
    twords, tn = tc.pack_testcase(data.tobytes(), max_len)
    assert twords.tobytes() == words.tobytes() and tn == n
    tw, tl = tc.build_candidates(
        tc.upload(twords, "cpu"), tn, torch.from_numpy(ops),
        torch.from_numpy(pos.astype(np.int64)),
        torch.from_numpy(size.astype(np.int64)))
    tz = tc.zero_counts(tw, tl)
    assert tw.dtype == torch.int32 and tl.dtype == torch.int32
    assert np.asarray(jw).tobytes() == tw.numpy().tobytes()
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    np.testing.assert_array_equal(np.asarray(jz), tz.numpy())
    assert (tl >= 1).all() and (tl <= cur_len).all()


# ---------------------------------------------------------------------------
# triage distill and campaign --runs 0, CLI against CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def distilled(tmp_path_factory):
    """Both CLIs' `triage distill` over the smoke seeds plus a stale
    subsumed file in outputs/: {pkg: (rc, lines, outputs/, result)}."""
    import wtf_tpu.triage as jtriage
    import wtf_tpu_torch.triage as ttriage

    root = tmp_path_factory.mktemp("distill")
    out = {}
    stale = b"\x01\x02QQ"
    with pytest.MonkeyPatch.context() as mp:
        for pkg, mod, run in (("jax", jtriage, _jax),
                              ("port", ttriage, _port)):
            target = _target(root / pkg)
            (target / "outputs").mkdir()
            (target / "outputs" / hex_digest(stale)).write_bytes(stale)
            results: list = []
            _capturing(mp, mod, "distill", results)
            rc, stdout = run(["triage", "distill", "--name", "demo_tlv",
                              "--target", str(target)] + LANES)
            out[pkg] = (rc, _unclocked(stdout),
                        _digests(target / "outputs"), results[0])
    return out


def test_distill_equals_jax_cli(distilled):
    jrc, jlines, jouts, jres = distilled["jax"]
    prc, plines, pouts, pres = distilled["port"]
    assert (prc, plines[0], pouts) == (jrc, jlines[0], jouts)
    assert plines[0].startswith("distill: kept 2/6 seeds (exact cover, ")
    assert (pres.keep, pres.prefix_keep, pres.kept_bits, pres.total_bits) \
        == (jres.keep, jres.prefix_keep, jres.kept_bits, jres.total_bits)
    assert pres.kept_bits == pres.total_bits > 0
    np.testing.assert_array_equal(pres.credit_bits, jres.credit_bits)
    # the sweep's planes, field for field, byte for byte
    for field in ("cov", "edge", "credit_cov", "credit_edge"):
        want, got = getattr(jres.sweep, field), getattr(pres.sweep, field)
        assert got.dtype == np.uint32 == np.asarray(want).dtype, field
        assert got.tobytes() == np.asarray(want).tobytes(), field
    np.testing.assert_array_equal(pres.sweep.new_lane, jres.sweep.new_lane)
    assert [str(r) for r in pres.sweep.results] \
        == [str(r) for r in jres.sweep.results]
    # first-hit credit recounted on the host from the full rows
    planes = np.concatenate([pres.sweep.cov, pres.sweep.edge], axis=1)
    credit = np.concatenate([pres.sweep.credit_cov, pres.sweep.credit_edge],
                            axis=1)
    union = np.zeros(planes.shape[1], np.uint32)
    for i in range(len(planes)):
        np.testing.assert_array_equal(credit[i], planes[i] & ~union)
        union |= planes[i]


def test_distill_from_port_checkpoint_equals_jax_cli(tmp_path):
    """A port campaign checkpoint (the same format as the JAX package's)
    distilled by both CLIs."""
    ck = tmp_path / "ck"
    target = _target(tmp_path / "camp")
    rc, _ = _port(["campaign", "--name", "demo_tlv", "--runs", "16",
                   "--max_len", "96", "--seed", "5", "--target",
                   str(target), "--checkpoint-every", "1",
                   "--checkpoint-dir", str(ck)] + LANES)
    assert rc in (0, 2) and (ck / "checkpoint.json").exists()
    lines = {}
    for pkg, run in (("jax", _jax), ("port", _port)):
        out = tmp_path / f"min-{pkg}"
        rc, stdout = run(["triage", "distill", "--name", "demo_tlv",
                          "--from-checkpoint", str(ck), "--outputs",
                          str(out)] + LANES)
        lines[pkg] = (rc, _unclocked(stdout)[0], _digests(out))
    assert lines["port"] == lines["jax"]
    assert lines["port"][1].startswith("distill: kept ")


@pytest.fixture(scope="module")
def minsets(tmp_path_factory):
    """`campaign --runs 0` by both CLIs (tests/test_cli.py's seeds), run
    twice: again with a stale subsumed find in outputs/, and with
    --telemetry-dir.  {pkg: [(rc, lines, outputs/), (...), event types]}"""
    root = tmp_path_factory.mktemp("minset")
    seeds = {"a": b"\x01\x02XY", "b": b"\x01\x02ZW",
             "c": b"\x01\x02AA\x02\x08BBBBBBBB", "d": b"\x03\x02ok"}
    stale = b"\x01\x02QQ"
    out = {}
    for pkg, run in (("jax", _jax), ("port", _port)):
        target = _target(root / pkg, seeds)
        argv = ["campaign", "--name", "demo_tlv", "--runs", "0",
                "--target", str(target)] + LANES
        first = run(argv)
        (target / "outputs" / hex_digest(stale)).write_bytes(stale)
        second = run(argv + ["--telemetry-dir", str(root / f"tel-{pkg}")])
        types = [json.loads(ln)["type"] for ln in
                 (root / f"tel-{pkg}" / "events.jsonl").read_text()
                 .splitlines()]
        out[pkg] = [(rc, _unclocked(stdout), _digests(target / "outputs"))
                    for rc, stdout in (first, second)] + [types]
    return out


def test_minset_equals_jax_cli(minsets):
    assert minsets["port"][:2] == minsets["jax"][:2]
    (rc, lines, outs), (rc2, lines2, outs2) = minsets["port"][:2]
    assert rc == 0 and lines[-1] == "minset: kept 2/4 seeds"
    assert lines[-2].startswith("#4 cov: ")
    # the stale subsumed find is pruned: outputs/ is the measured subset
    assert outs2 == outs and len(outs) == 2
    assert lines2[-1] == "minset: kept 2/5 seeds"


def test_telemetry_dir_event_types(minsets):
    """events.jsonl: run-start first, run-end last, and the same record
    types in the same order as the JAX CLI's (heartbeats aside, which
    follow the clock)."""
    types = minsets["port"][2]
    assert types[0] == "run-start" and types[-1] == "run-end"
    drop = lambda ts: [t for t in ts if t != "heartbeat"]  # noqa: E731
    assert drop(types) == drop(minsets["jax"][2])


def test_trace_out_writes_trace_events(tmp_path):
    target = _target(tmp_path / "t", {"a": SEEDS["a"]})
    trace = tmp_path / "trace.json"
    rc, stdout = _port(["campaign", "--name", "demo_tlv", "--runs", "0",
                        "--target", str(target), "--trace-out", str(trace)]
                       + LANES)
    assert rc == 0 and f"-> {trace}" in stdout.splitlines()[-1]
    doc = json.loads(trace.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"execute", "restore", "harvest"} <= names


# ---------------------------------------------------------------------------
# triage vbreak
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vbreaks(tmp_path_factory):
    """`triage vbreak` JSON captures: the JAX CLI, the port's CLI on the
    device batch and on the oracle (`--backend emu`)."""
    root = tmp_path_factory.mktemp("vbreak")
    (root / "in.bin").write_bytes(VBREAK_INPUT)
    out = {}
    for key, run, extra in (("jax", _jax, []), ("port", _port, []),
                            ("emu", _port, ["--backend", "emu"])):
        dump = root / f"{key}.json"
        argv = ["triage", "vbreak", "--name", "demo_tlv", "--input",
                str(root / "in.bin"), "--out", str(dump)] + VBREAK + LANES
        if key == "jax":
            rc, stdout = run(argv)
        else:
            rc, stdout = run(argv + extra)
        out[key] = (rc, _unclocked(stdout)[:-1], json.loads(dump.read_text()))
    return out


def test_vbreak_equals_jax_cli_and_oracle(vbreaks):
    jrc, jlines, jcaps = vbreaks["jax"]
    assert vbreaks["port"] == (jrc, jlines, jcaps)
    assert vbreaks["emu"] == (jrc, jlines, jcaps)
    got = [c for c in jcaps if c is not None]
    assert jrc == 0 and len(got) >= 1 and jcaps[0] is not None
    assert all(c["icount"] > 0 and c["mem"] for c in got)
    assert jlines[0] == (f"vbreak: {len(got)}/8 replays captured at "
                         f"{0x1_4000_0012:#x} (hit 2)")


@pytest.fixture(scope="module")
def port_backend():
    from wtf_tpu_torch.backend.gpu import GpuBackend
    from wtf_tpu_torch.harness import demo_tlv

    backend = GpuBackend(demo_tlv.build_snapshot(), n_lanes=16, limit=20000,
                         device="cpu", fused_step="on")
    backend.initialize()
    demo_tlv.TARGET.init(backend)
    return backend


def test_vbreak_captures_equal_port_oracle(port_backend):
    """The library path: each batched capture equals `oracle_capture` on
    the port's EmuBackend at the same arrival (register file, flags,
    icount and the stack window)."""
    from wtf_tpu_torch.backend.emu import EmuBackend
    from wtf_tpu_torch.core.results import Ok
    from wtf_tpu_torch.harness import demo_tlv
    from wtf_tpu_torch.triage import oracle_capture, perturbations, vbreak

    rip = demo_tlv.CODE_GVA + 0x12
    emu = EmuBackend(demo_tlv.build_snapshot(), limit=20000)
    emu.initialize()
    demo_tlv.TARGET.init(emu)
    testcases = perturbations(VBREAK_INPUT, 4)
    captures, results = vbreak(port_backend, demo_tlv.TARGET, testcases,
                               rip, hit=2)
    assert captures[0] is not None
    for i, data in enumerate(testcases):
        oc = oracle_capture(emu, demo_tlv.TARGET, data, rip, hit=2,
                            index=i)
        c = captures[i]
        assert (c is None) == (oc is None), f"capture parity, tc {i}"
        if c is not None:
            assert isinstance(results[i], Ok)
            assert c.as_dict() == oc.as_dict() and c.icount > 0
    assert captures[0].gpr[8] > demo_tlv.INPUT_GVA
    assert not port_backend.runner.cache.has_breakpoint(rip)


def test_vbreak_unreached_rip_reports_natural_result(port_backend):
    from wtf_tpu_torch.core.results import Crash, Ok
    from wtf_tpu_torch.harness import demo_tlv
    from wtf_tpu_torch.triage import ReplayCore, vbreak

    rip = demo_tlv.CODE_GVA + 0x12
    captures, results = vbreak(port_backend, demo_tlv.TARGET, [MINIMAL],
                               rip, hit=99)
    assert captures == [None] and isinstance(results[0], Crash)
    assert rip not in port_backend.breakpoints
    sweep = ReplayCore(port_backend, demo_tlv.TARGET).replay([SEEDS["a"]])
    assert isinstance(sweep.results[0], Ok)


def test_vbreak_collision_with_target_bp(port_backend, tmp_path):
    from wtf_tpu_torch.harness import demo_tlv
    from wtf_tpu_torch.triage import vbreak

    with pytest.raises(ValueError, match="already armed"):
        vbreak(port_backend, demo_tlv.TARGET, [SEEDS["a"]],
               demo_tlv.FINISH_GVA)
    assert demo_tlv.FINISH_GVA in port_backend.breakpoints
    (tmp_path / "in.bin").write_bytes(SEEDS["a"])
    argv = ["triage", "vbreak", "--name", "demo_tlv", "--input",
            str(tmp_path / "in.bin"), "--break-at", "tlv!finish"] + LANES
    rc, stdout = _port(argv)
    assert (rc, stdout) == _jax(argv)
    assert rc == 1 and stdout.startswith("vbreak: breakpoint already armed")


# ---------------------------------------------------------------------------
# the rest of the CLI
# ---------------------------------------------------------------------------

def test_stop_on_crash_with_explicit_dirs_equals_jax_cli(tmp_path):
    """`campaign --stop-on-crash` with --inputs/--outputs/--crashes (no
    --target): both CLIs stop after the same batch, with the same line,
    finds and crash files."""
    seeds = {"crash": CRASHER, **SEEDS}
    out = {}
    for pkg, run in (("jax", _jax), ("port", _port)):
        root = _target(tmp_path / pkg, seeds)
        rc, stdout = run(["campaign", "--name", "demo_tlv", "--runs", "160",
                          "--max_len", "96", "--seed", "5", "--stop-on-crash",
                          "--inputs", str(root / "inputs"), "--outputs",
                          str(root / "found"), "--crashes",
                          str(root / "bugs")] + LANES)
        out[pkg] = (rc, [ln for ln in _unclocked(stdout)
                         if ln.startswith("#")][-1],
                    _digests(root / "found"), _digests(root / "bugs"))
    assert out["port"] == out["jax"]
    rc, line, found, bugs = out["port"]
    assert rc == 2 and bugs and found
    assert int(line.split()[0][1:]) < 160       # stopped early


def test_run_coverage_equals_jax_cli(tmp_path):
    from wtf_tpu_torch.harness import demo_tlv

    (tmp_path / "cov").mkdir()
    (tmp_path / "cov" / "tlv.cov").write_text(json.dumps({
        "name": "tlv", "addresses": [
            hex(demo_tlv.CODE_GVA), hex(demo_tlv.CODE_GVA + 0x12),
            demo_tlv.CODE_GVA + 0x800, hex(demo_tlv.FINISH_GVA + 0x40)]}))
    (tmp_path / "in").mkdir()
    (tmp_path / "in" / "a").write_bytes(VBREAK_INPUT)
    (tmp_path / "in" / "b").write_bytes(MINIMAL)
    argv = ["run", "--name", "demo_tlv", "--input", str(tmp_path / "in"),
            "--coverage", str(tmp_path / "cov")] + LANES
    jrc, jout = _jax(argv)
    prc, pout = _port(argv)
    assert (prc, _unclocked(pout)) == (jrc, _unclocked(jout))
    assert _unclocked(pout)[-1] == "coverage: 2/4 listed basic blocks hit"


def test_target_module_registers_a_target(tmp_path, monkeypatch):
    (tmp_path / "extra_port_target.py").write_text(
        "import dataclasses\n"
        "from wtf_tpu_torch.harness import demo_tlv\n"
        "from wtf_tpu_torch.harness.targets import Target\n"
        "TARGET = Target(**{f.name: getattr(demo_tlv.TARGET, f.name)\n"
        "                   for f in dataclasses.fields(Target)\n"
        "                   if f.name != 'name'}, name='demo_tlv_extra')\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    (tmp_path / "crash.bin").write_bytes(MINIMAL)
    rc, stdout = _port(["run", "--name", "demo_tlv_extra",
                        "--target-module", "extra_port_target", "--input",
                        str(tmp_path / "crash.bin")] + LANES)
    assert rc == 2
    assert stdout.startswith(
        "crash.bin: crash(crash-execute-0x4141414141414141) (|cov| = ")


def test_fuzz_loop_dedups_by_bucket(port_backend, tmp_path):
    """FuzzLoop's harvest and the triage helper share one bucket: the
    name-colliding pair lands as TWO buckets."""
    import random

    from wtf_tpu_torch.fuzz.corpus import Corpus
    from wtf_tpu_torch.fuzz.loop import FuzzLoop
    from wtf_tpu_torch.fuzz.mutator import ByteMutator
    from wtf_tpu_torch.harness import demo_tlv

    c = bytes([3, 40]) + bytes(24) + b"\x41" * 8 + b"\xAA" * 8
    d = bytes([3, 40]) + bytes(24) + b"\x41" * 8 + b"\xBB" * 8
    loop = FuzzLoop(port_backend, demo_tlv.TARGET,
                    ByteMutator(random.Random(1), 128), Corpus(),
                    crashes_dir=tmp_path / "crashes")
    results = port_backend.run_batch([c, d], demo_tlv.TARGET)
    for lane, (data, result) in enumerate(zip([c, d], results)):
        loop._harvest_lane(lane, data, result)
    demo_tlv.TARGET.restore()
    port_backend.restore()
    assert len(loop.crash_names) == 1          # filenames collide...
    assert len(loop.crash_buckets) == 2        # ...buckets do not


def test_triage_entry_points_default_to_cuda(monkeypatch, tmp_path):
    from wtf_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "in.bin"
    path.write_bytes(CRASHER)
    for argv in (["triage", "minimize", "--input", str(path)],
                 ["triage", "distill", "--inputs", str(tmp_path)],
                 ["triage", "vbreak", "--input", str(path), "--break-at",
                  "tlv!parse"],
                 ["campaign", "--runs", "0", "--inputs", str(tmp_path)]):
        with pytest.raises(RuntimeError, match="cuda.is_available"):
            cli.main(argv + ["--name", "demo_tlv", "--lanes", "2"])


# ---------------------------------------------------------------------------
# triage minimize, CLI against CLI (last: the port's run overlaps the rest)
# ---------------------------------------------------------------------------

def _minimize_argv(path: Path) -> list:
    return ["triage", "minimize", "--name", "demo_tlv", "--input",
            str(path)] + LANES


@pytest.fixture(scope="module", autouse=True)
def port_minimize(tmp_path_factory):
    """The port's `triage minimize` of the smoke crasher (about 90 s of
    K1's plain version on the CPU), started in a subprocess before the
    module's first test so that it runs beside them; `minimized` collects
    it.  Yields (dir, process)."""
    root = tmp_path_factory.mktemp("port-minimize")
    (root / "crash.bin").write_bytes(CRASHER)
    # one thread: its tensors are 16 lanes wide, and it leaves the other
    # cores to the tests it runs beside
    proc = subprocess.Popen(
        [sys.executable, "-m", "wtf_tpu_torch"]
        + _minimize_argv(root / "crash.bin") + PORT, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield root, proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def minimized(port_minimize, tmp_path_factory):
    """Both CLIs' `triage minimize` of the smoke crasher and of a
    non-crasher: {pkg: [(rc, lines, .min bytes), (rc, lines)]}."""
    root = tmp_path_factory.mktemp("minimize")
    (root / "crash.bin").write_bytes(CRASHER)
    (root / "benign.bin").write_bytes(NON_CRASHER)
    jrc, jout = _jax(_minimize_argv(root / "crash.bin"))
    out = {"jax": [(jrc, _unclocked(jout),
                    (root / "crash.bin.min").read_bytes()),
                   _unclocked_rc(_jax(_minimize_argv(root / "benign.bin")))]}
    benign = _unclocked_rc(_port(_minimize_argv(root / "benign.bin")))
    port_root, proc = port_minimize
    stdout, stderr = proc.communicate(timeout=900)
    assert proc.returncode == 0, stderr[-2000:]
    out["port"] = [(proc.returncode, _unclocked(stdout),
                    (port_root / "crash.bin.min").read_bytes()), benign]
    return out


def _unclocked_rc(rc_out):
    return rc_out[0], _unclocked(rc_out[1])


def test_minimize_equals_jax_cli(minimized):
    (jrc, jlines, jmin), _ = minimized["jax"]
    (prc, plines, pmin), _ = minimized["port"]
    assert (prc, pmin) == (jrc, jmin) == (0, MINIMAL)
    assert plines[0] == jlines[0]
    assert plines[0].startswith(
        f"minimize: {len(CRASHER)} -> {len(MINIMAL)} bytes (bucket ")
    # rounds, dispatches, candidates and bytes zeroed of the reference
    assert "3 rounds, 27 dispatches, 371 candidates, 24 bytes zeroed" \
        in plines[0]


def test_minimize_non_crasher_equals_jax_cli(minimized):
    _, jbenign = minimized["jax"]
    _, pbenign = minimized["port"]
    assert pbenign == jbenign
    assert pbenign[0] == 1 and pbenign[1][0].startswith(
        "minimize: input does not reproduce a crash under batch replay "
        "(got ok)")
