"""demo_maze, demo_spin, demo_ioctl and demo_fs through the port, against
the JAX package's tpu backend, on the CPU.

  * each target's cases through `GpuBackend(device="cpu")` with
    `--fused-step off` and `on`: the same result types, crash names and
    icounts, case for case, as the JAX tpu backend, with the values the
    reference tests pin (tests/test_harness.py's maze stages,
    tests/test_spin.py's depth scaling and its timeout exact to the
    instruction, tests/test_ioctl.py's page-end OOB read,
    tests/test_guestfs.py's file read through the faked Nt* calls)
  * results that repeat across `restore`
  * guestfs: streams, handle tables, lookup rules, per-lane isolation, the
    not-found path and the rollback of every registered instance
  * a seeded 16-lane, 32-run campaign per target, the port's CLI against
    the reference CLI (`python -m wtf_tpu campaign --backend tpu`, run in
    process): equal corpus digests, crash names, outputs/ and crashes/,
    cov/edge aggregates and the final stats line
"""

import random
import re
import struct

import numpy as np
import pytest
from tests.torchport import one_torch_thread  # noqa: F401  (module fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_LANES = 16
LIMIT = 100_000
SPIN_LIMIT = 300
SPIN_DEPTHS = (0, 10, 30)
FS_CASES = [b"HELLOWORLD123456", b"LANE1XXXYYYYZZZZ", b"LANE2...padding.",
            b"short", b""]
NAMES = ("demo_maze", "demo_spin", "demo_ioctl", "demo_fs")


def spin(k):
    return struct.pack("<I", k)


def ioctl(code, payload=b""):
    return struct.pack("<I", code) + payload


def _cases(name):
    from wtf_tpu_torch.harness import demo_ioctl as di

    return {
        "demo_maze": [b"wtf!", b"wtfx", b"wtxx", b"wxxx", b"", b"aaaa",
                      b"wtf!tail", b"xtf!"],
        "demo_spin": [spin(k) for k in SPIN_DEPTHS]
        + [spin(1 << 24), spin(3), b"", b"\x01"],
        "demo_ioctl": [ioctl(di.IOCTL_SUM, b"\x01\x02\x03"),
                       ioctl(di.IOCTL_PARSE, struct.pack("<H", 4) + b"ABCD"),
                       ioctl(di.IOCTL_PARSE, struct.pack("<H", 500) + b"xx"),
                       ioctl(0x999, b"whatever"), b"",
                       ioctl(di.IOCTL_PARSE, struct.pack("<H", 8)
                             + b"Z" * 8)],
        "demo_fs": FS_CASES,
    }[name]


def _limit(name):
    return SPIN_LIMIT if name == "demo_spin" else LIMIT


def _modules(name):
    import importlib

    return (importlib.import_module(f"wtf_tpu.harness.{name}"),
            importlib.import_module(f"wtf_tpu_torch.harness.{name}"))


@pytest.fixture(scope="module")
def jax_runs():
    """{name: (results, icounts)} of each target's cases on one JAX tpu
    backend per target, computed once per module (the first pays the
    JAX compile; the chunk ladder stays at its base rung, which changes
    no result, so no deeper rung compiles)."""
    from wtf_tpu.backend import create_backend

    out = {}

    def get(name):
        if name not in out:
            mod = _modules(name)[0]
            b = create_backend("tpu", mod.build_snapshot(), n_lanes=N_LANES,
                               limit=_limit(name), chunk_steps=64)
            b.initialize()
            b.runner._chunk_sizes = [64]
            mod.TARGET.init(b)
            cases = _cases(name)
            res = [str(r) for r in b.run_batch(cases, mod.TARGET)]
            icount = np.asarray(b.runner.machine.icount)[:len(cases)]
            out[name] = (res, [int(v) for v in icount])
            mod.TARGET.restore()
            b.restore()
        return out[name]
    return get


def _port_backend(name, fused, n_lanes=N_LANES):
    from wtf_tpu_torch.backend.gpu import GpuBackend

    mod = _modules(name)[1]
    b = GpuBackend(mod.build_snapshot(), n_lanes=n_lanes, limit=_limit(name),
                   device="cpu", fused_step=fused)
    b.initialize()
    mod.TARGET.init(b)
    return b, mod


def _port_run(name, fused):
    b, mod = _port_backend(name, fused)
    cases = _cases(name)
    res = [str(r) for r in b.run_batch(cases, mod.TARGET)]
    icount = [int(v) for v in b.runner.machine.icount[:len(cases)]]
    return b, mod, res, icount


@pytest.mark.parametrize("fused", ["off", "on"])
@pytest.mark.parametrize("name", NAMES)
def test_target_matches_tpu_backend(jax_runs, name, fused):
    b, mod, res, icount = _port_run(name, fused)
    assert (res, icount) == jax_runs(name)
    assert b.runner.stats["fallbacks"] == 0
    if fused == "on":
        assert b.registry.counter("device.fused_steps").value > 0
    if name == "demo_maze":
        # only the full "wtf!" reaches the int3
        assert res[0] == f"crash(crash-int-{mod.CODE_GVA + 0x3d:#x})"
        assert res[1:6] == ["ok"] * 5 and res[6] == res[0]
        # each matched byte unlocks one more stage
        assert icount[3] < icount[2] < icount[1]
    elif name == "demo_spin":
        for k, got in zip(SPIN_DEPTHS, icount):
            assert got == pytest.approx(k * mod.INSNS_PER_ITER, abs=16)
        # the budget lands on the exact instruction
        assert res[3] == "timedout" and icount[3] == SPIN_LIMIT
        assert res[4] == "ok"
    elif name == "demo_ioctl":
        assert res[:4] == ["ok", "ok",
                           f"crash(crash-read-{mod.INPUT_PAGE + 0x1000:#x})",
                           "ok"]
        assert mod.EXIT_GVA in b.breakpoints     # found at init, no symbol
    else:
        assert res == ["ok"] * len(FS_CASES)
        for lane, content in enumerate(FS_CASES):
            want = content[:8].ljust(8, b"\x00") if content else bytes(8)
            assert b.runner.view().virt_read(lane, mod.OUTSLOT, 8) == want


@pytest.mark.parametrize("name", NAMES)
def test_results_repeat_across_restore(name):
    b, mod = _port_backend(name, "on")
    cases = _cases(name)[-4:]
    first = [str(r) for r in b.run_batch(cases, mod.TARGET)]
    mod.TARGET.restore()
    b.restore()
    assert [str(r) for r in b.run_batch(cases, mod.TARGET)] == first


# ---------------------------------------------------------------------------
# guestfs
# ---------------------------------------------------------------------------

def test_guestfile_stream_offsets_and_restore():
    from wtf_tpu_torch.harness import guestfs

    f = guestfs.GuestFile("x.txt", b"hello world")
    f.save()
    assert f.read(5) == b"hello" and f.read(100) == b" world"
    assert f.read(5) == b""
    f.write(b"MORE")
    assert bytes(f.data) == b"hello worldMORE"
    f.restore()
    assert bytes(f.data) == b"hello world" and f.cursor == 0
    assert f.read(3, offset=4) == b"o w" and f.cursor == 7
    f.write(b"AB", offset=0)
    assert bytes(f.data) == b"ABllo world"


def test_handle_table_and_lookup_rules():
    from wtf_tpu_torch.harness import guestfs

    t = guestfs.HandleTable()
    f = guestfs.GuestFile("x")
    t.save()
    h1, h2 = t.allocate(f), t.allocate(f)
    assert h1 == guestfs.HANDLE_BASE and h2 < h1
    assert t.get(h1) is f and t.close(h1) and not t.close(h1)
    t.restore()
    assert t.get(h1) is None and t.allocate(f) == guestfs.HANDLE_BASE

    fs = guestfs.FsHandleTable()
    g = fs.map_existing_guest_file("\\??\\C:\\dir\\input.txt", b"data")
    assert fs.lookup("\\??\\C:\\dir\\input.txt") is g
    assert fs.lookup("C:\\other\\input.txt") is g     # leaf-name match
    assert fs.lookup("missing.bin") is None
    fs.blacklist_file("secret.txt")
    fs.map_existing_guest_file("secret.txt")
    assert fs.lookup("secret.txt") is None
    assert not fs.map_nonexisting_guest_file("ghost.txt").exists
    calls = []
    fs.unknown_file_handler = lambda name: calls.append(name) or None
    assert fs.lookup("what.dll") is None and calls == ["what.dll"]


def test_fs_restore_rolls_back_every_backend():
    """One GuestFs per backend; the target's restore() (no backend
    argument) rolls back every registered one, so no lane keeps a file
    offset or a handle across batches."""
    from wtf_tpu_torch.harness import guestfs

    backends = [_port_backend("demo_fs", "on", n_lanes=2)
                for _ in range(2)]
    for b, mod in backends:
        assert [str(r) for r in b.run_batch(FS_CASES[:2], mod.TARGET)] \
            == ["ok", "ok"]
        fs = mod._FS_BY_BACKEND[id(b)]
        assert fs.stats["opens"] == 2 and fs.stats["reads"] == 2
        assert fs.lane_state(0)[1]._next == guestfs.HANDLE_BASE - 2
    mod = backends[0][1]
    mod.TARGET.restore()
    for b, _ in backends:
        fs = mod._FS_BY_BACKEND[id(b)]
        assert fs._lanes == {}
        assert fs.lane_state(1)[1]._next == guestfs.HANDLE_BASE


def test_fs_not_found_path():
    b, mod = _port_backend("demo_fs", "on", n_lanes=2)
    fs = mod._FS_BY_BACKEND[id(b)]
    fs.fs.blacklist_file(mod.FILE_NAME)
    assert str(b.run_batch([b"whatever"], mod.TARGET)[0]) == "ok"
    # NtCreateFile fails, so the guest skips to its finish
    assert b.runner.view().virt_read(0, mod.OUTSLOT, 8) == bytes(8)
    assert fs.stats["not_found"] == 1 and fs.stats["reads"] == 0


# ---------------------------------------------------------------------------
# the CLI, port against reference
# ---------------------------------------------------------------------------

def _final_line(stdout: str) -> str:
    """The last `#N cov: ..` stats line without its rate and uptime."""
    line = [ln for ln in stdout.splitlines() if ln.startswith("#")][-1]
    return re.sub(r" exec/s: \S+| uptime: \S+", "", line)


def _tree(root):
    from wtf_tpu_torch.utils.hashing import hex_digest

    return {p.relative_to(root).as_posix(): hex_digest(p.read_bytes())
            for sub in ("outputs", "crashes") if (root / sub).is_dir()
            for p in sorted((root / sub).iterdir())}


@pytest.mark.parametrize("name", NAMES)
def test_campaign_matches_reference_cli(name, tmp_path, monkeypatch, capsys):
    from wtf_tpu import cli as jcli
    from wtf_tpu.fuzz.loop import FuzzLoop as JLoop
    from wtf_tpu_torch import cli
    from wtf_tpu_torch.fuzz.loop import FuzzLoop as TLoop

    argv = ["campaign", "--name", name, "--lanes", str(N_LANES), "--runs",
            "32", "--limit", str(_limit(name)), "--max_len", "24",
            "--seed", "7"]
    loops = {}

    def keeping(cls, key):
        init = cls.__init__

        def keep(self, *a, **kw):
            init(self, *a, **kw)
            loops[key] = self
        monkeypatch.setattr(cls, "__init__", keep)

    keeping(JLoop, "ref")
    keeping(TLoop, "port")
    jcli.main(argv + ["--backend", "tpu", "--target",
                      str(tmp_path / "ref")])
    jline = _final_line(capsys.readouterr().out)
    cli.main(argv + ["--fused-step", "on", "--device", "cpu", "--target",
                     str(tmp_path / "port")])
    tline = _final_line(capsys.readouterr().out)
    jloop, tloop = loops["ref"], loops["port"]
    assert tline == jline and jline.startswith("#32 cov: ")
    assert _tree(tmp_path / "port") == _tree(tmp_path / "ref")
    assert any(k.startswith("outputs/") for k in _tree(tmp_path / "ref"))
    assert type(tloop.mutator).__name__ == "NativeMangleMutator"
    assert sorted(jloop.corpus.digests) == sorted(tloop.corpus.digests)
    assert jloop.crash_names == tloop.crash_names
    jb, tb = jloop.backend, tloop.backend
    assert np.asarray(jb._agg_cov).tobytes() == tb._agg_cov.numpy().tobytes()
    assert np.asarray(jb._agg_edge).tobytes() \
        == tb._agg_edge.numpy().tobytes()
    assert tb.runner.stats["fallbacks"] == 0
