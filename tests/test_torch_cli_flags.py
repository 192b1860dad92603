"""The single-device CLI's last flags in the port (wtf_tpu_torch/cli.py)
against the JAX package, bit for bit, on the CPU:

  --burst-any-tier on|off   the oracle burst's any-instruction tier, on
                            four fxsave guests (test_spin's two, a
                            branchy loop, and a timeout inside a burst at
                            limit 800): the Runner's machine planes and
                            its fallbacks, fallback_burst_steps, chunks
                            and max_chunk_steps equal the JAX Runner's,
                            and the flag reaches the Runner from the CLI;
  campaign --mutator        byte, mangle and tlv, CLI against CLI;
  campaign --store DIR      CLI against CLI: outputs/, crashes/ and the
                            store's blobs;
  --backend emu             `run` and `campaign` on the single-step
                            oracle against the JAX CLI's.
"""

import re
import struct

import pytest

from tests.emurunner import DATA_BASE
from tests.emurunner import build_guest as jax_build_guest
from tests.torchport import (  # noqa: F401
    assert_machines_equal, build_guest, one_torch_thread,
)
from wtf_tpu_torch.utils.hashing import hex_digest

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (asm, data, n_lanes, integer-path lanes (rax = 1), limit)
FXSAVE_GUESTS = {
    # test_spin's chronic oracle lane beside integer lanes
    "oracle_lane": (f"""
        test rax, rax
        jz oracle_path
        mov ecx, 40
    int_loop:
        dec ecx
        jnz int_loop
        int3
    oracle_path:
        mov rbx, {DATA_BASE}
        fld qword ptr [rbx]
        mov ecx, 30
    oracle_loop:
        fxsave [rbx+0x200]
        fxsave [rbx+0x400]
        dec ecx
        jnz oracle_loop
        fstp qword ptr [rbx+8]
        int3
    """, {DATA_BASE: struct.pack("<d", 2.5).ljust(0x1000, b"\x00")}, 4,
        (1, 2, 3), 0),
    # test_spin's glue between two fxsaves
    "glue": (f"""
        mov rbx, {DATA_BASE}
        mov ecx, 12
    lp:
        fxsave [rbx+0x200]
        inc rax
        inc rdx
        fxsave [rbx+0x400]
        dec ecx
        jnz lp
        int3
    """, {DATA_BASE: bytes(0x1000)}, 2, (), 0),
    # a branchy loop: data-dependent jumps and a call between fxsaves
    "branchy": (f"""
        mov rbx, {DATA_BASE}
        mov ecx, 8
    top:
        fxsave [rbx+0x200]
        test ecx, 3
        jz skip
        add rdx, rcx
        call sub1
        jmp next
    skip:
        xor rdx, 0x55
    next:
        fxsave [rbx+0x400]
        dec ecx
        jnz top
        int3
    sub1:
        imul rdx, rdx, 3
        ret
    """, {DATA_BASE: bytes(0x1000)}, 2, (1,), 0),
    # a timeout inside a burst: the limit lands mid-run-ahead
    "timeout": (f"""
        mov rbx, {DATA_BASE}
    forever:
        fxsave [rbx+0x200]
        inc rax
        inc rdx
        add rsi, rax
        fxsave [rbx+0x400]
        jmp forever
    """, {DATA_BASE: bytes(0x1000)}, 2, (), 800),
}
STATS = ("fallbacks", "fallback_burst_steps", "chunks", "max_chunk_steps")


def _run_runner(runner_cls, snapshot, n_lanes, int_lanes, limit, tier,
                **kw):
    runner = runner_cls(snapshot, n_lanes=n_lanes, chunk_steps=64,
                        burst_any_tier=tier, **kw)
    runner._chunk_sizes = [64, 1024]
    runner.limit = limit
    view = runner.view()
    for lane in int_lanes:
        view.set_reg(lane, 0, 1)
    runner.push(view)
    runner.run()
    return runner


@pytest.mark.parametrize("tier", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("guest", sorted(FXSAVE_GUESTS))
def test_burst_any_tier_equals_jax(guest, tier):
    from wtf_tpu.interp.runner import Runner as JRunner
    from wtf_tpu.snapshot.loader import Snapshot as JSnapshot
    from wtf_tpu_torch.interp.runner import Runner
    from wtf_tpu_torch.snapshot.loader import Snapshot

    asm, data, n_lanes, int_lanes, limit = FXSAVE_GUESTS[guest]
    physmem, jcpu, _ = jax_build_guest(asm, data)
    want = _run_runner(JRunner, JSnapshot(physmem=physmem, cpu=jcpu),
                       n_lanes, int_lanes, limit, tier)
    pages, cpu = build_guest(asm, data)
    got = _run_runner(Runner, Snapshot.from_pages(pages, cpu), n_lanes,
                      int_lanes, limit, tier, device="cpu")
    assert got.burst_any_tier is tier
    assert_machines_equal(want.machine, got.machine, where=guest)
    assert {k: got.stats[k] for k in STATS} == {
        k: want.stats[k] for k in STATS}
    assert got.stats["fallbacks"] > 0
    if guest == "timeout":
        assert got.machine.icount.tolist() == [limit] * n_lanes


def test_burst_tier_flag_reaches_the_runner(tmp_path):
    from wtf_tpu_torch import cli

    seed = tmp_path / "seed"
    seed.write_bytes(b"\x01\x04AAAA")
    for flag, want in (("on", True), ("off", False), ("auto", False)):
        args = cli.build_parser().parse_args(
            ["run", "--name", "demo_tlv", "--input", str(seed),
             "--device", "cpu", "--burst-any-tier", flag])
        backend, runs = cli.replay(args)
        assert backend.runner.burst_any_tier is want, flag
        assert str(runs[0].result) == "ok"


# ---------------------------------------------------------------------------
# campaign, CLI against CLI
# ---------------------------------------------------------------------------

TLV_SEED = b"\x01\x04AAAA\x02\x08BBBBBBBB"
# a type-3 record past its buffer (chip_smoke's phase-4 crasher)
TLV_CRASHER = bytes([1, 8]) + b"A" * 8 + bytes([3, 0x30]) + b"B" * 0x30
CAMPAIGN = ["campaign", "--name", "demo_tlv", "--lanes", "8", "--runs",
            "24", "--limit", "20000", "--max_len", "64", "--seed", "5"]


def _final_line(stdout: str) -> str:
    line = [ln for ln in stdout.splitlines() if ln.startswith("#")][-1]
    return re.sub(r" exec/s: \S+| uptime: \S+", "", line)


def _tree(root):
    return {p.relative_to(root).as_posix(): hex_digest(p.read_bytes())
            for sub in ("outputs", "crashes") if (root / sub).is_dir()
            for p in sorted((root / sub).iterdir())}


def _both(tmp_path, capsys, argv, jax_extra, port_extra, seeds=(TLV_SEED,)):
    """Run `argv` through the JAX CLI and the port's, each over its own
    --target dir seeded with `seeds`; returns ((rc, final line, tree) for
    jax, the same for the port)."""
    from wtf_tpu import cli as jcli
    from wtf_tpu_torch import cli

    out = []
    for side, main, extra in (("ref", jcli.main, jax_extra),
                              ("port", cli.main, port_extra)):
        (tmp_path / side / "inputs").mkdir(parents=True)
        for i, data in enumerate(seeds):
            (tmp_path / side / "inputs" / f"seed{i}").write_bytes(data)
        extra = [a.replace("{dir}", str(tmp_path / side)) for a in extra]
        rc = main(argv + extra + ["--target", str(tmp_path / side)])
        out.append((rc, _final_line(capsys.readouterr().out),
                    _tree(tmp_path / side)))
    return out


@pytest.mark.parametrize("mutator", ["byte", "mangle", "tlv"])
def test_campaign_mutator_by_name_equals_jax_cli(mutator, tmp_path, capsys):
    want, got = _both(tmp_path, capsys, CAMPAIGN + ["--mutator", mutator],
                      ["--backend", "tpu"],
                      ["--device", "cpu", "--fused-step", "on"])
    assert got == want
    assert got[1].startswith("#24 cov: ")
    assert any(k.startswith("outputs/") for k in got[2])


def test_campaign_store_equals_jax_cli(tmp_path, capsys):
    from wtf_tpu_torch.fleet.store import FleetStore

    want, got = _both(tmp_path, capsys,
                      CAMPAIGN + ["--mutator", "tlv"],
                      ["--backend", "tpu", "--store", "{dir}/store"],
                      ["--device", "cpu", "--fused-step", "on", "--store",
                       "{dir}/store"], seeds=(TLV_SEED, TLV_CRASHER))
    assert got == want
    assert any(k.startswith("crashes/") for k in got[2]), got[2]

    def blobs(root):
        return sorted(p.name for p in (root / "store").rglob("*")
                      if p.is_file() and p.parent.name != "store")
    assert blobs(tmp_path / "port") == blobs(tmp_path / "ref")
    report = FleetStore(tmp_path / "port" / "store").verify()
    assert report["blobs"] > 0 and report["ok"] == report["blobs"]
    assert not (report["torn"] or report["missing"] or report["orphans"])


def test_campaign_backend_emu_equals_jax_cli(tmp_path, capsys):
    want, got = _both(tmp_path, capsys,
                      CAMPAIGN + ["--runs", "16", "--mutator", "tlv"],
                      ["--backend", "emu"], ["--backend", "emu"])
    assert got == want
    assert got[1].startswith("#16 cov: ")


def test_run_backend_emu_equals_jax_cli(tmp_path, capsys):
    from wtf_tpu import cli as jcli
    from wtf_tpu_torch import cli

    inputs = tmp_path / "in"
    inputs.mkdir()
    (inputs / "a-ok").write_bytes(TLV_SEED)
    (inputs / "b-crash").write_bytes(TLV_CRASHER)
    argv = ["run", "--name", "demo_tlv", "--input", str(inputs),
            "--limit", "20000"]
    outs = []
    for main in (jcli.main, cli.main):
        rc = main(argv + ["--backend", "emu"])
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith(("a-ok", "b-crash"))]
        outs.append((rc, lines))
    assert outs[1] == outs[0]
    assert outs[0][0] == 2 and "crash" in outs[0][1][1]
