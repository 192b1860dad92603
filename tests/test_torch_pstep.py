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
parked lanes), and every plane is compared again.

The wrapper's own logic is tested last: the kernel's launch geometry
(one warp per lane, the row index in shared memory, the 227 KB limit)
and the dispatch (CPU tensors run the plain version; inputs on two
devices raise).
"""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torchport as tp
from tests.emurunner import DATA_BASE
from tests.test_pstep import _gen_hot_program, _random_regs
from tests.test_torch_step import _lane_regs, _mem_program
from wtf_tpu.interp.pstep import make_run_fused, make_run_resume
from wtf_tpu_torch import convert
from wtf_tpu_torch.core.results import StatusCode
from wtf_tpu_torch.interp import pstep as TP
from wtf_tpu_torch.interp.machine import CTR_FUSED, CTR_INSTR
from tests.torchport import one_torch_thread  # noqa: F401  (module fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_LANES = 4
CAP = 1024
SLOTS = 8
K = 16

_REG = {"rax": 0, "rcx": 1, "rdx": 2, "rbx": 3, "rsi": 6, "rdi": 7,
        "r8": 8, "r9": 9, "r10": 10, "r11": 11}


def fused_lockstep(asm, data=None, regs=None, lane_regs=None, limit=0,
                   bps=(), large=None, host_write=None, rounds=400):
    """Kernel launches and resume legs in lockstep until no lane runs.
    Returns (port machine, statuses seen, kernel launches)."""
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
    seen, launches = set(), 0
    for i in range(rounds):
        if not bool((m.status == int(StatusCode.RUNNING)).any()):
            break
        mj = run_fused(tab_j, img_j, mj, lim)
        TP.fused_step_plain(tab, img, m, limit, K)
        launches += 1
        tp.assert_machines_equal(mj, m, where=f"kernel launch {i}")
        seen |= {StatusCode(int(s)) for s in m.status}
        mj = run_resume(tab_j, img_j, mj, lim)
        TP.fused_resume(tab, img, m, limit, 1)
        tp.assert_machines_equal(mj, m, where=f"resume leg {i}")
        # breakpoint lanes resume with bp_skip, as the runner does
        at_bp = m.status == int(StatusCode.BREAKPOINT)
        if at_bp.any():
            seen.add(StatusCode.BREAKPOINT)
            m.bp_skip[at_bp] = 1
            m.status[at_bp] = int(StatusCode.RUNNING)
            mj = tp.to_jax(m)
    return m, seen, launches


def _occupancy(m):
    ctr = m.ctr.numpy().view(np.uint32).astype(np.int64)
    return int(ctr[:, CTR_FUSED].sum()), int(ctr[:, CTR_INSTR].sum())


@pytest.mark.parametrize("seed", range(3))
def test_fused_plain_hot_grids_match_kernel(seed):
    rng = random.Random(0xF05E + seed)
    asm = _gen_hot_program(rng)
    m, _, _ = fused_lockstep(asm, regs=_random_regs(rng),
                             lane_regs=_lane_regs(seed))
    # the closing int3 parks every lane, and the resume leg's precise step
    # retires it as CRASH (no lane goes to the oracle)
    assert (m.status == int(StatusCode.CRASH)).all()
    fused, instr = _occupancy(m)
    assert fused == instr > 0              # all-hot code: 100% in-kernel


@pytest.mark.parametrize("seed", range(2))
def test_fused_plain_mem_grids_match_kernel(seed):
    m, _, _ = fused_lockstep(_mem_program(seed),
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
    m, _, _ = fused_lockstep(asm, data={DATA_BASE: bytes(0x1000)})
    # cold opclasses parked mid-run, and the precise step resumed them
    # (every plane compared after each resume leg, no oracle resync)
    ctr = m.ctr.numpy().view(np.uint32)
    assert ctr[:, 4].sum() > N_LANES and ctr[:, 5].sum() == 0


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
        m, _, _ = fused_lockstep(asm, large=(big, gpa, 21, blobs))
        assert int(m.gpr[0, 1]) == 0x1111_2222_3333_4454
        return
    if case == "fault":
        asm = f"""
            mov rbx, {DATA_BASE}
            mov rax, [rbx]
            mov rcx, [rbx + 0x200000]
            int3
        """
        m, seen, _ = fused_lockstep(asm, data={DATA_BASE: b"\x55" * 0x1000})
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
    m, _, _ = fused_lockstep(
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
    m, seen, _ = fused_lockstep(asm, bps=(bp,))
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
    m, seen, _ = fused_lockstep(asm, limit=137)
    assert StatusCode.TIMEDOUT in seen and (m.icount == 137).all()


@pytest.mark.parametrize("seed", range(2))
def test_fused_plain_row_index_edges_match_kernel(seed):
    """The row-index states the kernel's ragged card check covers: pfns in
    rows past `count` (a lookup covers the whole capacity), one pfn in
    several rows (the first wins), a full overlay and one a row short of
    full.  One launch each side from the same state; every plane bit for
    bit."""
    asm = f"""
        mov rbx, {DATA_BASE}
        mov rcx, 3
    1:
        mov [rbx + 0x10], rcx
        add rax, [rbx + 0x18]
        mov [rbx + 0xffc], rax
        push rax
        pop rdx
        dec rcx
        jnz 1b
        int3
    """
    pages, cpu = tp.build_guest(asm, data={DATA_BASE: bytes(0x2000)})
    r = tp.warm_runner(pages, cpu, N_LANES, CAP, SLOTS)
    view = r.view()
    pfns = [view.translate(0, gva) >> 12 for gva in (
        DATA_BASE, DATA_BASE + 0x1000, tp.STACK_TOP - 0x108)]
    rng = np.random.default_rng(seed)
    m = r.machine
    ov = m.overlay
    choices = np.array(pfns + [7, 1 << 20], dtype=np.int32)
    rows = choices[rng.integers(0, len(choices), (N_LANES, SLOTS))]
    count = np.array([2, SLOTS, SLOTS - 1, 0])
    past = np.array([True, False, False, True])  # non-free rows past count
    used = (np.arange(SLOTS)[None, :] < count[:, None]) | past[:, None]
    ov.pfn.copy_(torch.from_numpy(np.where(used, rows, -1).astype(np.int32)))
    ov.count.copy_(torch.from_numpy(count.astype(np.int32)))
    ov.valid.copy_(torch.from_numpy(
        (rng.integers(0, 2, tuple(ov.valid.shape)) * used[..., None])
        .astype(np.uint8)))
    ov.data.copy_(torch.from_numpy(rng.integers(
        -2**63, 2**63 - 1, tuple(ov.data.shape), dtype=np.int64)))
    tab = r.cache.device("cpu")
    img_leaves = tp.padded_image(pages)
    mj = make_run_fused(K, interpret=True)(
        tp.jax_table(convert.table_to_jax(tab)), tp.jax_image(img_leaves),
        tp.to_jax(m), jnp.uint64(0))
    before = m.clone()
    TP.fused_step_plain(tab, convert.image_from_jax(img_leaves), m, 0, K)
    tp.assert_machines_equal(mj, m, where="one launch")
    ctr = (m.ctr - before.ctr).numpy()
    assert ctr[:, CTR_INSTR].sum() > 0
    assert ctr[1, 5] == 1                   # the full lane parks on memory
    assert int(m.overlay.count[2]) == SLOTS  # the last row claimed


# ---------------------------------------------------------------------------
# the wrapper: launch geometry and device dispatch
# ---------------------------------------------------------------------------

# the most rows whose per-warp row index fits one block's 227 KB of
# shared memory (4-byte rows, padded to whole rounds of 32)
_MAX_SLOTS = 232448 // (TP.WARPS * 32 * 4) * 32


@pytest.mark.parametrize("n_lanes", (1, TP.WARPS - 1, 1000, 1001, 4096))
@pytest.mark.parametrize("slots", (1, 31, 32, 50, 128, 1024, _MAX_SLOTS,
                                   _MAX_SLOTS + 1))
def test_launch_geometry(n_lanes, slots):
    if slots > _MAX_SLOTS:
        with pytest.raises(ValueError, match="shared memory"):
            TP.launch_geometry(n_lanes, slots)
        return
    grid, block, shared = TP.launch_geometry(n_lanes, slots)
    warps = block // 32
    assert block == 32 * TP.WARPS                 # one warp per lane
    assert (grid - 1) * warps < n_lanes <= grid * warps
    rounds = -(-slots // 32)
    assert shared == warps * rounds * 32 * 4      # every warp's row index
    assert shared >= warps * slots * 4 and shared <= 232448


def _small_state():
    pages, cpu = tp.build_guest("""
        mov rax, 1
        mov rcx, 7
    1:
        add rax, rcx
        push rax
        pop rdx
        dec rcx
        jnz 1b
        int3
    """)
    r = tp.warm_runner(pages, cpu, N_LANES, CAP, SLOTS)
    return r.cache.device("cpu"), r.image, r.machine


def test_fused_step_on_cpu_runs_the_plain_version(monkeypatch):
    tab, img, m0 = _small_state()
    want = m0.clone()
    TP.fused_step_plain(tab, img, want, 0, K)
    launches = dict(TP.LAUNCHES)

    def no_launch(*args):
        raise AssertionError("a CPU machine reached the kernel launch")

    monkeypatch.setattr(TP, "_launch", no_launch)
    got = m0.clone()
    TP.fused_step(tab, img, got, 0, K)
    assert TP.LAUNCHES == launches
    for (name, a), (_, b) in zip(want.planes(), got.planes()):
        assert torch.equal(a, b), name
    assert int(got.ctr[:, CTR_INSTR].sum()) > 0


@pytest.mark.parametrize("moved", ("hash_tab", "pages", "tenant"))
def test_fused_step_raises_on_a_mixed_device(moved):
    tab, img, m = _small_state()
    before = m.clone()
    if moved == "hash_tab":
        tab = tab._replace(hash_tab=tab.hash_tab.to("meta"))
    elif moved == "pages":
        img = dataclasses.replace(img, pages=img.pages.to("meta"))
    else:
        img = dataclasses.replace(img, tenant=torch.zeros(
            N_LANES, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match=f"{moved} is on meta"):
        TP.fused_step(tab, img, m, 0, K)
    for (name, a), (_, b) in zip(before.planes(), m.planes()):
        assert torch.equal(a, b), name
