"""demo_pe and utils/pe.py of the port (wtf_tpu_torch) against the JAX
package's, bit for bit, on the CPU: compiler-made Windows code (the
`gle64.vc14.dll` of PyOpenGL's wheel) through the PE loader, the oracle,
the device path and the CLI.

The inputs are tests/test_pe_target.py's: BENIGN (4 points, Ok after
6,740 instructions), the overclaim (crash-read-0x24002000 after 5,605),
a count of 0 (the same crash after 662), the 3-point batch input (Ok
after 1,190), and 300 points with their data (Ok after 1,018,320 on the
oracle).  Limits, the same in both packages:
  - the oracle runs the first three at test_pe_target's 2,000,000 and the
    300-point input at 100,000 (it times out there in both; its full run
    is ~80 s of the Python oracle per package);
  - the device path runs the first four (BENIGN twice) as one 5-lane
    batch at 1,300: the 3-point input finishes, the count of 0 crashes,
    BENIGN and the overclaim run 1,300 instructions of the DLL's code and
    time out.  The port's precise step on the CPU costs ~11-16 ms per
    instruction on this FP-heavy code and a batch costs its longest
    lane's instruction count in steps (BENIGN's 6,740 alone take ~2
    minutes); the 300-point input (~10**6 steps) stays on the oracle;
  - the custom-mutator campaign (CLI against CLI) runs one batch of 8
    lanes at 1,200, where the 3-point seed finishes and longer mutants
    time out alike.
"""

import random
import re
import struct

import numpy as np
import pytest

from tests.torchport import (  # noqa: F401
    assert_machines_equal, one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PTS = struct.pack("<12d", 1.0, 2.0, 3.0, 2.0, 3.0, 4.0, 3.0, 4.0, 5.0,
                  4.0, 5.0, 6.0)
BENIGN = struct.pack("<Id", 4, 0.5) + PTS
OVERCLAIM = struct.pack("<Id", 100_000, 0.5) + PTS
ZERO = struct.pack("<Id", 0, 1.0)
SHORT = struct.pack("<Id", 3, 2.0) + PTS[:72]
P300 = struct.pack("<Id", 300, 0.5) + struct.pack(
    "<900d", *(float((i * 7) % 23) - 11.0 for i in range(900)))

ORACLE_LIMIT = 2_000_000
P300_ORACLE_LIMIT = 100_000
DEVICE_LIMIT = 1_300
CAMPAIGN_LIMIT = 1_200


@pytest.fixture(autouse=True)
def _needs_dll():
    from wtf_tpu_torch.harness import demo_pe

    if not demo_pe.available():
        pytest.skip("census DLL not present")


def _port_backend(kind, **kw):
    from wtf_tpu_torch.backend.emu import EmuBackend
    from wtf_tpu_torch.backend.gpu import GpuBackend
    from wtf_tpu_torch.harness import demo_pe

    snap = demo_pe.build_snapshot()
    if kind == "emu":
        backend = EmuBackend(snap, **kw)
    else:
        backend = GpuBackend(snap, device="cpu", **kw)
    backend.initialize()
    demo_pe.TARGET.init(backend)
    return backend


def _jax_backend(kind, **kw):
    from wtf_tpu.backend import create_backend
    from wtf_tpu.harness import demo_pe

    backend = create_backend(kind, demo_pe.build_snapshot(), **kw)
    backend.initialize()
    demo_pe.TARGET.init(backend)
    return backend


def test_pe_loader_exports_image_and_snapshot_equal_jax():
    from wtf_tpu.harness import demo_pe as jdemo
    from wtf_tpu.utils.pe import load_pe as j_load
    from wtf_tpu_torch.harness import demo_pe
    from wtf_tpu_torch.utils.pe import load_pe

    pe, jpe = load_pe(demo_pe.DEFAULT_DLL), j_load(jdemo.DEFAULT_DLL)
    exports = pe.exports()
    assert exports == jpe.exports()
    assert exports["glePolyCylinder"] > 0 and len(exports) == 25
    img = pe.mapped_image()
    assert img == jpe.mapped_image() and img[:2] == b"MZ"
    text = pe.section(".text")
    assert img[text.vaddr:text.vaddr + 16] == pe.section_bytes(".text")[:16]
    assert pe.function_ranges() == jpe.function_ranges()
    assert pe.data_directory(1) == jpe.data_directory(1)
    snap, jsnap = demo_pe.build_snapshot(), jdemo.build_snapshot()
    assert snap.symbols == jsnap.symbols
    assert np.array_equal(snap.physmem.pages,
                          np.asarray(jsnap.physmem.image.pages))
    assert np.array_equal(snap.physmem.frame_table,
                          np.asarray(jsnap.physmem.image.frame_table))
    assert snap.cpu.rip == jsnap.cpu.rip
    assert snap.cpu.gpr_list() == jsnap.cpu.gpr_list()


def test_structure_mutator_stream_equals_jax():
    from wtf_tpu.fuzz.corpus import Corpus as JCorpus
    from wtf_tpu.harness import demo_pe as jdemo
    from wtf_tpu_torch.fuzz.corpus import Corpus
    from wtf_tpu_torch.harness import demo_pe

    streams = []
    for corpus_cls, mod in ((Corpus, demo_pe), (JCorpus, jdemo)):
        rng = random.Random(7)
        corpus = corpus_cls(rng=rng)
        corpus.add(BENIGN)
        corpus.add(SHORT)
        mut = mod.TARGET.create_mutator(rng, 0x400)
        streams.append([mut.get_new_testcase(corpus) for _ in range(300)])
    assert streams[0] == streams[1]
    assert len(set(streams[0])) > 250


def _oracle_runs(backend_fn, target):
    out = []
    for data, limit in ((BENIGN, ORACLE_LIMIT), (OVERCLAIM, ORACLE_LIMIT),
                        (ZERO, ORACLE_LIMIT), (SHORT, ORACLE_LIMIT),
                        (P300, P300_ORACLE_LIMIT)):
        be = backend_fn("emu", limit=limit)
        target.insert_testcase(be, data)
        result = be.run()
        out.append((str(result), be.cpu.icount, sorted(
            be.last_new_coverage())))
    return out


def test_oracle_fixed_inputs_equal_jax():
    from wtf_tpu.harness import demo_pe as jdemo
    from wtf_tpu_torch.harness import demo_pe

    got = _oracle_runs(_port_backend, demo_pe.TARGET)
    want = _oracle_runs(_jax_backend, jdemo.TARGET)
    assert got == want
    assert [(r, n) for r, n, _ in got] == [
        ("ok", 6740), ("crash(crash-read-0x24002000)", 5605),
        ("crash(crash-read-0x24002000)", 662), ("ok", 1190),
        ("timedout", P300_ORACLE_LIMIT)]


def test_device_batch_equals_jax():
    """The first four inputs (BENIGN twice) as one 5-lane batch of the
    device path at 1,300: results, crash names, icount, rip and every
    plane of the final machine equal to the JAX package's, with no
    oracle fallback storm."""
    from wtf_tpu_torch.harness import demo_pe

    from wtf_tpu.harness import demo_pe as jdemo

    batch = [BENIGN, OVERCLAIM, SHORT, BENIGN, ZERO]
    port = _port_backend("gpu", n_lanes=5, limit=DEVICE_LIMIT)
    jbe = _jax_backend("tpu", n_lanes=5, limit=DEVICE_LIMIT)
    got = port.run_batch(batch, demo_pe.TARGET)
    want = jbe.run_batch(batch, jdemo.TARGET)
    assert [str(r) for r in got] == [str(r) for r in want]
    assert [str(r) for r in got] == [
        "timedout", "timedout", "ok", "timedout",
        "crash(crash-read-0x24002000)"]
    assert port.runner.machine.icount.tolist() == [
        DEVICE_LIMIT, DEVICE_LIMIT, 1190, DEVICE_LIMIT, 662]
    assert_machines_equal(jbe.runner.machine, port.runner.machine,
                          where="demo_pe batch")
    assert port.runner.stats["fallbacks"] < 50, port.runner.stats
    assert port.runner.stats["fallbacks"] == jbe.runner.stats["fallbacks"]
    assert port.aggregate_coverage() == jbe.aggregate_coverage()


def _final_line(stdout: str) -> str:
    line = [ln for ln in stdout.splitlines() if ln.startswith("#")][-1]
    return re.sub(r" exec/s: \S+| uptime: \S+", "", line)


def _tree(root):
    from wtf_tpu_torch.utils.hashing import hex_digest

    return {p.relative_to(root).as_posix(): hex_digest(p.read_bytes())
            for sub in ("outputs", "crashes") if (root / sub).is_dir()
            for p in sorted((root / sub).iterdir())}


def test_custom_mutator_campaign_cli_equals_jax_cli(tmp_path, capsys):
    """`campaign --name demo_pe` with the structure mutator, seeded with
    the 3-point input: the final count line, outputs/ and crashes/ equal
    between the CLIs; count lies walk the code off the points buffer."""
    from wtf_tpu import cli as jcli
    from wtf_tpu_torch import cli

    for side in ("ref", "port"):
        (tmp_path / side / "inputs").mkdir(parents=True)
        (tmp_path / side / "inputs" / "seed").write_bytes(SHORT)
    argv = ["campaign", "--name", "demo_pe", "--lanes", "8", "--runs",
            "8", "--limit", str(CAMPAIGN_LIMIT), "--max_len", "1024",
            "--seed", "7"]
    jcli.main(argv + ["--backend", "tpu", "--target",
                      str(tmp_path / "ref")])
    jline = _final_line(capsys.readouterr().out)
    cli.main(argv + ["--device", "cpu", "--target",
                     str(tmp_path / "port")])
    tline = _final_line(capsys.readouterr().out)
    assert tline == jline and tline.startswith("#8 cov: ")
    tree = _tree(tmp_path / "port")
    assert tree == _tree(tmp_path / "ref")
    assert any(k.startswith("crashes/crash-read-") for k in tree), tree
