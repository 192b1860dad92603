"""The port's native host layer against the JAX package's, on the CPU.

  * the native mangle engine (wtf_tpu_torch/native/mangle.cc, a byte copy
    of the reference's) at three seeds: the same testcases over 200 draws,
    one at a time and in batches, with and without a cross-over seed
  * with the native library forced off, both packages fall back alike to
    the Python MangleMutator
  * `write_kdmp`: byte-identical full and bitmap dumps
  * `parse_kdmp`/`parse_kdmp_info`, native and Python, against the
    reference's parse of the same file, both writers' files
  * a bad signature and a partial kernel dump raise the port's KdmpError
  * `load_snapshot` of a dump state equals that of the npz state, and a
    campaign from `--state <dump dir>` equals the synthetic snapshot's
  * the `snapshot` subcommand's three formats equal the reference CLI's
  * the C1 case, CLI against CLI: `campaign --name demo_kernel --lanes 8
    --runs 32 --limit 100000 --max_len 24 --seed 7`, the reference with
    `--backend tpu`, the port with `--device cpu`: the same outputs/ and
    the same final stats line
"""

import dataclasses
import random
import re
import struct
import zipfile

import numpy as np
import pytest

from tests.torchport import one_torch_thread  # noqa: F401  (module fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SEEDS = (1, 7, 123)
CORPUS_SEEDS = (b"\x01\x04AAAA\x02\x08BBBBBBBB", b"hello world!", b"\x00")
CROSS = b"MAGICMARKER-cross-over"
C1_ARGV = ["campaign", "--name", "demo_kernel", "--lanes", "8", "--runs",
           "32", "--limit", "100000", "--max_len", "24", "--seed", "7"]


def _packages():
    from wtf_tpu.fuzz import corpus as jcorpus, native_mutator as jnm
    from wtf_tpu_torch.fuzz import corpus as tcorpus, native_mutator as tnm

    return (jcorpus, jnm), (tcorpus, tnm)


def _draws(corpus_mod, mutator_mod, seed, cross, batch):
    rng = random.Random(seed)
    corpus = corpus_mod.Corpus(rng=rng)
    for data in CORPUS_SEEDS:
        corpus.add(data)
    m = mutator_mod.best_mangle_mutator(rng, 64)
    if cross:
        m.on_new_coverage(CROSS)
    if batch:
        return type(m).__name__, [tc for _ in range(4)
                                  for tc in m.get_new_batch(corpus, 50)]
    return type(m).__name__, [m.get_new_testcase(corpus)
                              for _ in range(200)]


@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("cross", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_native_mutator_matches_reference(seed, cross, batch):
    (jc, jn), (tc, tn) = _packages()
    want = _draws(jc, jn, seed, cross, batch)
    got = _draws(tc, tn, seed, cross, batch)
    assert got[0] == "NativeMangleMutator"
    assert got == want
    assert len(set(got[1])) > 100
    assert all(1 <= len(t) <= 64 for t in got[1])
    if cross and not batch:
        assert any(b"MAGIC" in t for t in got[1])


def test_fallback_without_native_matches_reference(monkeypatch):
    (jc, jn), (tc, tn) = _packages()
    for mod in (jn, tn):
        monkeypatch.setattr(mod, "_native_lib", lambda: None)
        assert not mod.native_available()
        with pytest.raises(RuntimeError, match="no toolchain"):
            mod.NativeMangleMutator(random.Random(0), 8)
    want = _draws(jc, jn, 7, True, False)
    assert want[0] == "MangleMutator"
    assert _draws(tc, tn, 7, True, False) == want


# ---------------------------------------------------------------------------
# crash dumps
# ---------------------------------------------------------------------------

def _pages():
    # non-contiguous pfns: several runs, holes in the bitmap
    rng = np.random.default_rng(5)
    pfns = (0x10, 0x11, 0x40, 0x1000, 0x1001, 0x7777)
    return {pfn: rng.integers(0, 256, 0x1000, dtype=np.uint8).tobytes()
            for pfn in pfns}


def _cpu(cpustate_mod):
    cpu = cpustate_mod.CpuState()
    cpu.rip = 0xFFFFF805_1087_76A0
    cpu.rsp = 0xFFFFF805_1356_84F8
    cpu.rax, cpu.rcx, cpu.r15 = 3, 1, 0x52
    cpu.rflags = 0x40202
    cpu.cs.selector, cpu.ss.selector = 0x10, 0x18
    cpu.mxcsr = 0x1FA0
    cpu.zmm[3][0] = 0x0123_4567_89AB_CDEF
    cpu.zmm[15][1] = (1 << 64) - 2
    return cpu


def _write(pkg, path, dump_type):
    import importlib

    kdmp = importlib.import_module(f"{pkg}.snapshot.kdmp")
    cpustate = importlib.import_module(f"{pkg}.core.cpustate")
    kdmp.write_kdmp(path, _pages(), dump_type=dump_type, dtb=0x6D4000,
                    cpu=_cpu(cpustate), bugcheck_code=0xDEADDEAD)
    return path.read_bytes()


@pytest.mark.parametrize("dump_type", ["full", "bmp"])
def test_write_kdmp_matches_reference(tmp_path, dump_type):
    want = _write("wtf_tpu", tmp_path / "ref.dmp", dump_type)
    assert _write("wtf_tpu_torch", tmp_path / "port.dmp", dump_type) == want


def _parsed(kdmp, path):
    info = kdmp.parse_kdmp_info(path)
    return (dataclasses.astuple(info), info.context_registers(),
            kdmp.parse_kdmp(path))


@pytest.mark.parametrize("writer", ["wtf_tpu", "wtf_tpu_torch"])
@pytest.mark.parametrize("parser", ["native", "python"])
@pytest.mark.parametrize("dump_type", ["full", "bmp"])
def test_parse_matches_reference(tmp_path, monkeypatch, dump_type, parser,
                                 writer):
    from wtf_tpu.snapshot import kdmp as jk
    from wtf_tpu_torch.snapshot import kdmp as tk

    path = tmp_path / "mem.dmp"
    _write(writer, path, dump_type)
    want = _parsed(jk, path)
    assert tk._parse_native(path) is not None      # the library builds
    if parser == "python":
        monkeypatch.setattr(tk, "_parse_native", lambda p: None)
    got = _parsed(tk, path)
    assert got == want
    assert got[2] == _pages()
    assert got[0][:4] == ({"full": 1, "bmp": 5}[dump_type], 0x6D4000,
                          0xDEADDEAD, len(_pages()))
    assert got[1]["rip"] == 0xFFFFF805_1087_76A0 and got[1]["ss"] == 0x18


@pytest.mark.parametrize("parser", ["native", "python"])
def test_bad_dumps_raise_kdmp_error(tmp_path, monkeypatch, parser):
    from wtf_tpu_torch.snapshot import kdmp

    if parser == "python":
        monkeypatch.setattr(kdmp, "_parse_native", lambda p: None)
    bad = tmp_path / "bad.dmp"
    bad.write_bytes(b"NOPE" * 0x1000)
    with pytest.raises(kdmp.KdmpError, match="bad signature"):
        kdmp.parse_kdmp(bad)
    partial = tmp_path / "partial.dmp"
    header = bytearray(0x3000)
    struct.pack_into("<II", header, 0, kdmp.SIG_PAGE, kdmp.SIG_DU64)
    struct.pack_into("<I", header, 0xF98, kdmp.KERNEL_DUMP)
    partial.write_bytes(bytes(header))
    with pytest.raises(kdmp.KdmpError, match="partial kernel"):
        kdmp.parse_kdmp(partial)


# ---------------------------------------------------------------------------
# snapshot states and the snapshot subcommand
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kernel_npz(tmp_path_factory):
    """demo_kernel's snapshot saved in the raw npz format by the port."""
    from wtf_tpu_torch.harness import demo_kernel

    state = tmp_path_factory.mktemp("state") / "npz"
    demo_kernel.build_snapshot().save_raw(state)
    return state


def _convert(cli_main, src, out, fmt):
    assert cli_main(["snapshot", "--state", str(src), "--out", str(out),
                     "--format", fmt]) == 0


@pytest.mark.parametrize("fmt", ["dmp-bmp", "dmp-full"])
def test_load_snapshot_of_dump_equals_npz(tmp_path, kernel_npz, fmt):
    from wtf_tpu_torch import cli
    from wtf_tpu_torch.snapshot.loader import load_snapshot

    _convert(cli.main, kernel_npz, tmp_path / fmt, fmt)
    want, got = load_snapshot(kernel_npz), load_snapshot(tmp_path / fmt)
    assert np.array_equal(got.physmem.pages, want.physmem.pages)
    assert np.array_equal(got.physmem.frame_table, want.physmem.frame_table)
    assert np.array_equal(got.physmem.present, want.physmem.present)
    assert got.cpu == want.cpu and got.symbols == want.symbols


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in z.namelist()}


@pytest.mark.parametrize("fmt", ["npz", "dmp-bmp", "dmp-full"])
def test_snapshot_subcommand_matches_reference(tmp_path, kernel_npz, fmt):
    """npz from a bitmap dump, the dumps from npz.  A .npz is a zip whose
    entries carry the time they were written, so its members are compared
    byte for byte; every other file is."""
    from wtf_tpu import cli as jcli
    from wtf_tpu_torch import cli

    src = kernel_npz
    if fmt == "npz":
        src = tmp_path / "src"
        _convert(cli.main, kernel_npz, src, "dmp-bmp")
    _convert(jcli.main, src, tmp_path / "ref", fmt)
    _convert(cli.main, src, tmp_path / "port", fmt)
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for name in names:
        ref, port = tmp_path / "ref" / name, tmp_path / "port" / name
        if name == "mem.npz":
            assert _members(port) == _members(ref)
        else:
            assert port.read_bytes() == ref.read_bytes(), name


def _final_line(stdout: str) -> str:
    """The last `#N cov: ..` stats line without its rate and uptime."""
    line = [ln for ln in stdout.splitlines() if ln.startswith("#")][-1]
    return re.sub(r" exec/s: \S+| uptime: \S+", "", line)


def _tree(root):
    from wtf_tpu_torch.utils.hashing import hex_digest

    return {p.relative_to(root).as_posix(): hex_digest(p.read_bytes())
            for sub in ("outputs", "crashes") if (root / sub).is_dir()
            for p in sorted((root / sub).iterdir())}


def test_campaign_from_dump_state_equals_synthetic(tmp_path, kernel_npz,
                                                   capsys):
    from wtf_tpu_torch import cli

    _convert(cli.main, kernel_npz, tmp_path / "dmp", "dmp-full")
    capsys.readouterr()
    lines = {}
    for key, extra in (("synthetic", []),
                       ("dmp", ["--state", str(tmp_path / "dmp")])):
        cli.main(C1_ARGV + ["--device", "cpu", "--target", str(tmp_path / key)]
                 + extra)
        lines[key] = _final_line(capsys.readouterr().out)
    assert lines["dmp"] == lines["synthetic"]
    assert _tree(tmp_path / "dmp") == _tree(tmp_path / "synthetic")
    assert any(k.startswith("outputs/") for k in _tree(tmp_path / "dmp"))


def test_c1_kernel_campaign_cli_matches_reference_cli(tmp_path, capsys):
    """The port's campaign picks the reference CLI's host mutator (the
    native engine), so both write the same corpus at equal seeds."""
    from wtf_tpu import cli as jcli
    from wtf_tpu_torch import cli

    argv = C1_ARGV
    jcli.main(argv + ["--backend", "tpu", "--target", str(tmp_path / "ref")])
    jline = _final_line(capsys.readouterr().out)
    cli.main(argv + ["--device", "cpu", "--target", str(tmp_path / "port")])
    tline = _final_line(capsys.readouterr().out)
    assert tline == jline == "#32 cov: 19 corp: 1 crash: 0 timeout: 0 cr3: 0"
    tree = _tree(tmp_path / "port")
    assert tree == _tree(tmp_path / "ref")
    (digest,) = tree.values()
    assert digest.startswith("fba1276a39295407")
