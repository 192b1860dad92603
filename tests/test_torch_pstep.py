"""The port's fused step against the JAX package's Pallas kernel.

`fused_step_plain` (wtf_tpu_torch/interp/pstep.py) — the PyTorch version
of the CUDA kernel csrc/fused_step.cu, which chip_smoke.py holds against
it on the card — is run in lockstep with the JAX kernel in interpret mode
(`make_run_fused(k, interpret=True)`, as tests/test_pstep.py runs it) on
4 lanes, from the same converted state, on the inputs of
tests/test_pstep.py: the hot and memory grids, the park-and-resume seam,
the walk differential cases and the breakpoint / bp_skip case.  After
every kernel launch all 13 planes the kernel updates and every other
machine field must be equal bit for bit, the counter block included.
Between launches both sides run their resume leg (the precise step for
parked lanes); a lane parked on an opclass this slice leaves to the
oracle is checked to come out UNSUPPORTED and then takes the JAX state,
as the oracle would give it.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torchport as tp
from tests.emurunner import DATA_BASE
from tests.test_pstep import _gen_hot_program, _random_regs
from tests.test_torch_step import _NYP, _lane_regs, _mem_program
from wtf_tpu.interp.pstep import make_run_fused, make_run_resume
from wtf_tpu_torch import convert
from wtf_tpu_torch.core.results import StatusCode
from wtf_tpu_torch.interp import pstep as TP
from wtf_tpu_torch.interp import step as TS
from wtf_tpu_torch.interp.machine import CTR_FUSED, CTR_INSTR

N_LANES = 4
CAP = 1024
SLOTS = 8
K = 16

_REG = {"rax": 0, "rcx": 1, "rdx": 2, "rbx": 3, "rsi": 6, "rdi": 7,
        "r8": 8, "r9": 9, "r10": 10, "r11": 11}


def _rows_equal(mj, m, lanes):
    """Every lane-indexed plane equal on `lanes`."""
    want = tp.jax_leaves(mj)
    got = convert.machine_to_jax(m)
    for name, a in want.items():
        b = got[name]
        if a.ndim and a.shape[0] == N_LANES:
            ok = np.array_equal(a[lanes].view(np.uint8)
                                if a.dtype != bool else a[lanes],
                                b[lanes].view(np.uint8)
                                if b.dtype != bool else b[lanes])
            assert ok, f"{name} differs on lanes {np.nonzero(lanes)[0]}"


def fused_lockstep(asm, data=None, regs=None, lane_regs=None, limit=0,
                   bps=(), large=None, host_write=None, rounds=400):
    """Kernel launches and resume legs in lockstep until no lane runs.
    Returns (port machine, statuses seen, NYP parks, kernel launches)."""
    pages, cpu = tp.build_guest(asm, data, regs, large=large)
    r = tp.warm_runner(pages, cpu, N_LANES, CAP, SLOTS)
    for gva in bps:
        r.cache.set_breakpoint(gva)
    view = r.view()
    for lane, values in (lane_regs or {}).items():
        for idx, value in values.items():
            view.set_reg(lane, idx, value)
    if host_write is not None:
        for lane in range(N_LANES):
            view.virt_write(lane, *host_write)
    r.push(view)
    m = r.machine
    tab = r.cache.device("cpu")
    img_leaves = tp.padded_image(pages)
    img = convert.image_from_jax(img_leaves)
    img_j = tp.jax_image(img_leaves)
    tab_j = tp.jax_table(convert.table_to_jax(tab))
    mj = tp.to_jax(m)
    run_fused = make_run_fused(K, interpret=True)
    run_resume = make_run_resume(1, donate=False)
    lim = jnp.uint64(limit)
    seen, nyp_parks, launches = set(), 0, 0
    for i in range(rounds):
        if not bool((m.status == int(StatusCode.RUNNING)).any()):
            break
        mj = run_fused(tab_j, img_j, mj, lim)
        TP.fused_step_plain(tab, img, m, limit, K)
        launches += 1
        tp.assert_machines_equal(mj, m, where=f"kernel launch {i}")
        seen |= {StatusCode(int(s)) for s in m.status}
        # parked lanes about to run an opclass left to the oracle
        parked = m.status == int(StatusCode.NEEDS_XLA)
        _, _, d = TS.probe(tab, img, m)
        nyp = torch.zeros_like(parked)
        for opc in _NYP:
            nyp |= d.opc == opc
        nyp &= parked & ~((d.bp == 1) & (m.bp_skip == 0))
        mj = run_resume(tab_j, img_j, mj, lim)
        TP.fused_resume(tab, img, m, limit, 1)
        if nyp.any():
            nyp_parks += int(nyp.sum())
            assert (m.status[nyp] == int(StatusCode.UNSUPPORTED)).all()
            _rows_equal(mj, m, (~nyp).numpy())
            m = convert.machine_from_jax(tp.jax_leaves(mj))
        tp.assert_machines_equal(mj, m, where=f"resume leg {i}")
        # breakpoint lanes resume with bp_skip, as the runner does
        at_bp = m.status == int(StatusCode.BREAKPOINT)
        if at_bp.any():
            seen.add(StatusCode.BREAKPOINT)
            m.bp_skip[at_bp] = 1
            m.status[at_bp] = int(StatusCode.RUNNING)
            mj = tp.to_jax(m)
    return m, seen, nyp_parks, launches


def _occupancy(m):
    ctr = m.ctr.numpy().view(np.uint32).astype(np.int64)
    return int(ctr[:, CTR_FUSED].sum()), int(ctr[:, CTR_INSTR].sum())


@pytest.mark.parametrize("seed", range(3))
def test_fused_plain_hot_grids_match_kernel(seed):
    rng = random.Random(0xF05E + seed)
    asm = _gen_hot_program(rng)
    m, _, nyp, _ = fused_lockstep(asm, regs=_random_regs(rng),
                                  lane_regs=_lane_regs(seed))
    assert nyp == N_LANES                  # the closing int3, every lane
    fused, instr = _occupancy(m)
    assert fused == instr > 0              # all-hot code: 100% in-kernel


@pytest.mark.parametrize("seed", range(2))
def test_fused_plain_mem_grids_match_kernel(seed):
    m, _, _, _ = fused_lockstep(_mem_program(seed),
                                data={DATA_BASE: bytes(0x2000)},
                                lane_regs=_lane_regs(seed))
    fused, instr = _occupancy(m)
    assert 0 < fused <= instr


@pytest.mark.parametrize("seed", range(2))
def test_fused_plain_park_resume_seam_matches_kernel(seed):
    rng = random.Random(0x5EA9 + seed)
    cold = ["bswap rax", "xchg rax, rdx", "popcnt r10, rax", "bt rax, 3",
            "cqo", "lahf"]
    body = []
    for _ in range(20):
        if rng.random() < 0.4:
            body.append(rng.choice(cold))
        else:
            body.append(rng.choice([
                f"add rax, {rng.randrange(1, 1 << 20)}",
                f"mov [rbx + {rng.randrange(0, 0xE00)}], rcx",
                f"add rax, [rbx + {rng.randrange(0, 0xE00)}]",
                "push rax", "pop rsi", "inc r9", "dec rdx", "xor rsi, rax",
                "lea rdi, [rax + rdx*2 + 5]", "cmovnz r10, rax",
                "setc r11b"]))
    asm = (f"mov rbx, {DATA_BASE}\nmov rcx, 3\n1:\n" + "\n".join(body)
           + "\ndec rcx\njnz 1b\nint3")
    m, _, nyp, _ = fused_lockstep(asm, data={DATA_BASE: bytes(0x1000)})
    assert nyp > N_LANES                   # cold opclasses parked mid-run
    ctr = m.ctr.numpy().view(np.uint32)
    assert ctr[:, 4].sum() > 0 and ctr[:, 5].sum() == 0   # subset parks


@pytest.mark.parametrize("case", ("large2m", "fault", "overlay"))
def test_fused_plain_walk_differential_matches_kernel(case):
    if case == "large2m":
        big, gpa = 0x4000_0000, 0x0060_0000
        asm = f"""
            mov rbx, {big}
            mov rax, [rbx + 0x1F0000]
            add rax, [rbx + 8]
            mov [rbx + 0x100], rax
            push rax
            pop rcx
            int3
        """
        blobs = {gpa + 0x1F0000: (0x1111_2222_3333_4444).to_bytes(8, "little"),
                 gpa + 8: (0x10).to_bytes(8, "little")}
        m, _, _, _ = fused_lockstep(asm, large=(big, gpa, 21, blobs))
        assert int(m.gpr[0, 1]) == 0x1111_2222_3333_4454
        return
    if case == "fault":
        asm = f"""
            mov rbx, {DATA_BASE}
            mov rax, [rbx]
            mov rcx, [rbx + 0x200000]
            int3
        """
        m, seen, _, _ = fused_lockstep(asm, data={DATA_BASE: b"\x55" * 0x1000})
        assert StatusCode.PAGE_FAULT in seen or bool(
            (m.status == int(StatusCode.PAGE_FAULT)).all())
        assert m.ctr.numpy().view(np.uint32)[:, 5].sum() > 0  # mem parks
        return
    asm = f"""
        mov rbx, {DATA_BASE}
        mov rax, [rbx + 0x10]
        mov [rbx + 0x18], rax
        add rax, [rbx + 0x18]
        int3
    """
    m, _, _, _ = fused_lockstep(
        asm, data={DATA_BASE: bytes(0x1000)},
        host_write=(DATA_BASE + 0x10,
                    (0xDEAD_BEEF_0BAD_F00D).to_bytes(8, "little")))
    assert int(m.gpr[0, 0]) & ((1 << 64) - 1) \
        == (2 * 0xDEAD_BEEF_0BAD_F00D) & ((1 << 64) - 1)


def test_fused_plain_breakpoint_park_and_bp_skip_resume():
    asm = """
        mov rax, 0
        mov rcx, 5
    1:
        add rax, rcx
        inc rdx
        dec rcx
        jnz 1b
        int3
    """
    code = tp.assemble(asm)
    bp = tp.CODE_BASE + code.index(bytes.fromhex("48ffc2"))
    m, seen, _, _ = fused_lockstep(asm, bps=(bp,))
    assert StatusCode.BREAKPOINT in seen
    assert (m.gpr[:, 2] == 5).all()          # the bp'd inc ran 5 times


def test_fused_plain_timeout_in_kernel():
    asm = """
        mov rax, 1
        mov rcx, 1000
    1:
        add rax, rcx
        lea rdx, [rax + rcx*4 + 7]
        xor rsi, rdx
        dec rcx
        jnz 1b
        int3
    """
    m, seen, _, _ = fused_lockstep(asm, limit=137)
    assert StatusCode.TIMEDOUT in seen and (m.icount == 137).all()
