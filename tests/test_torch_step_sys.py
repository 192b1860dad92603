"""The integer and system classes of the port's precise step (ROADMAP
A5(b): DIV, CONVERT, BT, BITSCAN, BMI, BSWAP, XCHG, CMPXCHG, XADD, the
string forms, LEAVE/ENTER, PUSHF/POPF, the flag ops, CPUID, RDTSC, RDRAND,
XGETBV, SYSCALL/SYSRET, SWAPGS, RD/WR{FS,GS}BASE, MOV CR, RDMSR/WRMSR and
INT/HLT) against the JAX package's step_lane, bit for bit.

Each case runs one guest on 4 lanes (different registers per lane) in
lockstep: one JAX `make_run_chunk(1)` step and one port step through
`run_steps` (which computes only the opclass groups its scan finds) from
the same converted state; then every machine plane must be equal.  Lanes
both engines leave to the host oracle (iretq, a 128-bit dividend, a
non-canonical wrfsbase, an unknown MSR) are single-stepped by the port
runner's oracle and the state carried over to the JAX machine, so the
lockstep goes on past them.

Cases: every hardware-differential snippet of tests/test_emu.py that
reaches one of these classes (both register sets), the memory snippets of
tests/test_step.py that do, its named system cases, and seeded operand
grids for DIV (divisors 0, +-1, INT64_MIN), BT on memory with negative bit
offsets and BITSCAN on zero.
"""

import random

import pytest
import torch

from tests import torchport as tp
from tests.asmhelper import assemble
from tests.emurunner import CODE_BASE, DATA_BASE
from tests.test_emu import HW_CASES, IRETQ_ASM, _ALT_REGS, _INIT_REGS
from tests.test_step import DIFF_CASES
from wtf_tpu_torch.core.cpustate import GPR_NAMES
from wtf_tpu_torch.core.results import StatusCode
from wtf_tpu_torch.cpu import uops as U
from wtf_tpu_torch.cpu.decoder import decode
from wtf_tpu_torch.interp import step as TS
from tests.torchport import one_torch_thread  # noqa: F401  (module fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_LANES = 4
CAP = 1024
SLOTS = 8
# the groups of ROADMAP A5(b); the SSE and x87 groups have their own
# files (test_torch_step_fp.py, test_torch_step_x87.py)
A5B_GROUPS = ("div", "bits", "string", "stack", "sys")
FP_GROUPS = ("sse", "ssefp", "x87")
_A5B = frozenset(getattr(U, f"OPC_{n}") for g in A5B_GROUPS
                 for n in TS.GROUPS[g]) - {U.OPC_HLT}
_FP = frozenset(getattr(U, f"OPC_{n}") for g in FP_GROUPS
                for n in TS.GROUPS[g])


def _opclasses(asm: str) -> set:
    code = tp.assemble_private(asm)
    out, off = set(), 0
    while off < len(code):
        uop = decode(code[off:off + 15], CODE_BASE + off)
        if uop.opc == U.OPC_INVALID or uop.length == 0:
            break
        out.add(uop.opc)
        off += uop.length
    return out


def _reaches_a5b(asm: str) -> bool:
    opcs = _opclasses(asm)
    return bool(opcs & _A5B) and not opcs & _FP


def _lane_regs(seed: int, fixed=()):
    """Random rax/rbx/rcx/rdx/rsi/rdi/r8-r11 for lanes 1..3 (lane 0 keeps
    the snapshot's); registers in `fixed` keep the snapshot's value."""
    rng = random.Random(seed)
    out = {}
    for lane in range(1, N_LANES):
        regs = {i: rng.getrandbits(64) for i in (0, 1, 2, 3, 6, 7, 8, 9,
                                                 10, 11) if i not in fixed}
        if rng.random() < 0.5 and 1 not in fixed:
            regs[1] = rng.randrange(4)
        out[lane] = regs
    return out


def lockstep(asm, data=None, regs=None, lane_regs=None, limit=0,
             max_steps=3000):
    """Step both engines from the same state until no lane runs; returns
    (port machine, statuses seen, lanes served by the oracle)."""
    return tp.lockstep(asm, data, regs, lane_regs, limit, N_LANES,
                       max_steps, CAP, SLOTS)


def _gpr(m, lane, idx):
    return int(m.gpr[lane, idx]) & (1 << 64) - 1


# ---------------------------------------------------------------------------
# the hardware-differential corpus and the memory snippets
# ---------------------------------------------------------------------------

_HW = [c for c in HW_CASES if _reaches_a5b(c[1] + "\nhlt")]
_MEM = [c for c in DIFF_CASES if _reaches_a5b(c[1])]


@pytest.mark.parametrize("name,snippet", [(c[0], c[1]) for c in _HW])
@pytest.mark.parametrize("initset", ["a", "b"])
def test_hw_cases_match_step_lane(name, snippet, initset):
    init = list(_INIT_REGS if initset == "a" else _ALT_REGS)
    regs = {n: v for n, v in zip(GPR_NAMES, init)}
    regs.pop("rsp")
    m, seen, _ = lockstep(snippet + "\nhlt", regs=regs,
                          lane_regs=_lane_regs(hash(name) & 0xFFFF))
    # lane 0 runs the snippet on the hardware suite's registers to its hlt
    assert int(m.status[0]) == int(StatusCode.CRASH), seen


@pytest.mark.parametrize("name,snippet,data",
                         [(c[0], c[1], c[2]) for c in _MEM])
def test_mem_cases_match_step_lane(name, snippet, data):
    m, seen, _ = lockstep(snippet, data=data)
    assert (m.status == int(StatusCode.CRASH)).all(), seen


def test_case_lists_cover_every_group():
    """The two corpora above reach every A5(b) group of the step."""
    opcs = set()
    for c in _HW:
        opcs |= _opclasses(c[1])
    for c in _MEM:
        opcs |= _opclasses(c[1])
    for group in A5B_GROUPS:
        if group == "sys":
            continue      # the named cases below carry the system classes
        names = TS.GROUPS[group]
        assert opcs & {getattr(U, f"OPC_{n}") for n in names}, group
    assert len(_HW) >= 40 and len(_MEM) >= 12


# ---------------------------------------------------------------------------
# the named system cases of tests/test_step.py
# ---------------------------------------------------------------------------

def test_wrfsbase_noncanonical_goes_to_the_oracle():
    m, seen, served = lockstep(
        "mov rax, 0x8000000000000000\nwrfsbase rax\nhlt")
    assert served == N_LANES
    assert (m.status == int(StatusCode.PAGE_FAULT)).all()
    assert (m.fault_gva == -2**63).all() and (m.fs_base == 0).all()


def test_syscall_sysret_swapgs_transition():
    asm = """
        mov r14, 0x123
        syscall
        hlt
        .org 0x40
        swapgs
        rdgsbase rax
        swapgs
        sysretq
    """
    regs = {"lstar": CODE_BASE + 0x40, "sfmask": 0x700,
            "star": 0x0023_0010_0000_0000, "kernel_gs_base": 0xFFFF_8000_1000}
    m, seen, served = lockstep(asm, regs=regs, lane_regs=_lane_regs(1))
    # sysret returns to the hlt after the syscall
    assert served == 0 and (m.status == int(StatusCode.CRASH)).all()
    assert (m.gpr[:, 0] == 0xFFFF_8000_1000).all()  # the swapped gs base
    assert (m.cs == 0x33).all() and (m.ss == 0x2B).all()


def test_rdrand_rdtsc_xgetbv_cpuid():
    leaves = [(0x0, 0), (0x1, 0), (0x9, 0), (0x1234, 0), (0x40000000, 0),
              (0x80000001, 0), (0x1, 7)]
    body = "\n".join(f"mov eax, {leaf:#x}\nmov ecx, {sub:#x}\ncpuid\n"
                     f"add r8, rax\nadd r9, rbx\nadd r10, rcx\nadd r11, rdx"
                     for leaf, sub in leaves)
    asm = ("rdrand rax\nrdrand ebx\nrdrand cx\nrdtsc\nxor ecx, ecx\n"
           "xgetbv\n" + body + "\nhlt")
    m, _, served = lockstep(asm, regs={"tsc": 0x1234_5678_9ABC},
                            lane_regs=_lane_regs(2))
    assert served == 0 and (m.status == int(StatusCode.CRASH)).all()


def test_divide_error_and_div128_oracle():
    m, seen, _ = lockstep("xor rcx, rcx\nmov rax, 5\ndiv rcx\nhlt")
    assert (m.status == int(StatusCode.DIVIDE_ERROR)).all()
    asm = "mov rdx, 1\nmov rax, 0\nmov rcx, 16\ndiv rcx\nhlt"
    m, _, served = lockstep(asm)
    assert served == N_LANES
    assert (m.status == int(StatusCode.CRASH)).all()
    assert _gpr(m, 0, 0) == 0x1000000000000000


def test_iretq_runs_on_the_oracle():
    m, _, served = lockstep(IRETQ_ASM)
    assert served >= N_LANES and (m.status == int(StatusCode.CRASH)).all()


def test_rdmsr_wrmsr_efer_and_cr3_change():
    asm = """
        mov ecx, 0xC0000082
        rdmsr
        shl rdx, 32
        or rax, rdx
        mov r12, rax
        mov ecx, 0xC0000102
        mov eax, 0x11223344
        mov edx, 0x55667788
        wrmsr
        mov ecx, 0x10
        mov eax, 0x1000
        xor edx, edx
        wrmsr
        rdtsc
        mov ecx, 0xC0000080
        rdmsr
        or eax, 0x4000
        wrmsr
        xor eax, eax
        rdmsr
        mov rbx, cr0
        mov cr0, rbx
        mov rbx, cr3
        mov cr3, rbx
        mov ecx, 0x12345
        rdmsr
        hlt
    """
    m, seen, served = lockstep(asm, regs={"lstar": 0xFFFFF00012345678},
                               lane_regs=_lane_regs(3, fixed=(1,)))
    # the unknown MSR goes to the oracle (which has no model of it)
    assert served == N_LANES
    assert _gpr(m, 0, 12) == 0xFFFFF00012345678
    assert int(m.kernel_gs_base[0]) == 0x5566778811223344
    assert int(m.efer[0]) & 0x4000
    # a new cr3 stops the lane
    m, seen, _ = lockstep("mov rax, cr3\nadd rax, 0x1000\nmov cr3, rax\n"
                          "hlt")
    assert (m.status == int(StatusCode.CR3_CHANGE)).all()


# ---------------------------------------------------------------------------
# seeded operand grids
# ---------------------------------------------------------------------------

_DIVISORS = [0, 1, -1, -2**63, 7, -3]


@pytest.mark.parametrize("op", ["div", "idiv"])
def test_div_grid(op):
    rng = random.Random(0xD1F + len(op))
    for reg in ("cl", "cx", "ecx", "rcx"):
        lanes = {}
        for lane in range(N_LANES):
            rax = rng.choice([rng.getrandbits(64), -2**63, 5, -5,
                              rng.getrandbits(16)]) & (1 << 64) - 1
            sign = (1 << 64) - 1 if rax >> 63 else 0
            rdx = rng.choice([0, sign, rng.getrandbits(64)])
            rcx = rng.choice(_DIVISORS + [rng.getrandbits(64)])
            lanes[lane] = {0: rax, 2: rdx, 1: rcx & (1 << 64) - 1}
        lockstep(f"{op} {reg}\nhlt", lane_regs=lanes)


def test_bt_memory_grid():
    data = {DATA_BASE: bytes(random.Random(5).getrandbits(8)
                             for _ in range(0x3000))}
    for form in ("bt qword ptr [rbx], rcx", "bts dword ptr [rbx], ecx",
                 "btr word ptr [rbx], cx", "btc qword ptr [rbx], rcx",
                 "bts rax, rcx", "btc edx, 37"):
        lanes = {lane: {3: DATA_BASE + 0x1800,
                        1: off & (1 << 64) - 1, 0: 0x1234_5678_9ABC_DEF0,
                        2: 0xFFFF_0000_FFFF_0000}
                 for lane, off in enumerate((-1, -9, -0x4000, 100))}
        lanes[0][1] = -0x7F31 & (1 << 64) - 1
        lockstep(f"{form}\n{form}\nhlt", data=data, lane_regs=lanes)


def test_bitscan_grid():
    asm = ("bsf rax, rcx\nbsr rdx, rcx\ntzcnt r8, rcx\nlzcnt r9, rcx\n"
           "popcnt r10, rcx\nbsf ax, cx\nlzcnt r11d, ecx\npopcnt bx, cx\n"
           "bsr esi, ecx\ntzcnt di, cx\nhlt")
    for values in ((0, 1, 1 << 63, (1 << 64) - 1),
                   (0x8000, 0x1_0000_0000, 0x80, 0xF0F0_0000_0000)):
        lanes = {lane: {1: v, 0: 0xAAAA, 2: 0x5555}
                 for lane, v in enumerate(values)}
        m, _, _ = lockstep(asm, lane_regs=lanes)
        assert (m.status == int(StatusCode.CRASH)).all()


def test_skipped_groups_change_no_bit():
    """A step given every group gives the same planes as one given only
    the groups `scan` finds, on a batch whose lanes sit at the hot, the
    string and the system classes and at a terminal status."""
    asm = (f"mov rsi, {DATA_BASE}\nmov rdi, {DATA_BASE + 0x100}\n"
           "mov rcx, 3\nrep movsb\nadd rax, 1\ncpuid\nsyscall\nhlt")
    code = assemble(asm)
    starts, off = [], 0
    while off < len(code):
        starts.append(CODE_BASE + off)
        off += decode(code[off:off + 15], CODE_BASE + off).length
    pages, cpu = tp.build_guest(asm, {DATA_BASE: bytes(range(256)) * 2},
                                {"lstar": CODE_BASE})
    r = tp.warm_runner(pages, cpu, N_LANES, CAP, SLOTS)
    tab, img = r.cache.device("cpu"), r.image
    m = r.machine
    m.rip = torch.tensor([starts[0], starts[3], starts[5], starts[6]])
    m.gpr[2, 1] = 2
    m.status[3] = int(StatusCode.OK)
    seen = set()
    for _ in range(12):
        full = m.clone()
        TS.step(tab, img, full, 0)
        pre, _, groups = TS.scan(tab, img, m)
        seen |= groups
        TS.step(tab, img, m, 0, pre, groups)
        for (name, a), (_, b) in zip(full.planes(), m.planes()):
            assert torch.equal(a, b), name
    assert {"string", "sys", "roles"} <= seen < TS.ALL_GROUPS
