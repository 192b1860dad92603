"""The SSE classes of the port's precise step (ROADMAP A5(c): SSEMOV,
SSEALU, SSEFP and VZEROALL) against the JAX package's step_lane, bit for
bit.

Each case runs one guest on 16 lanes in lockstep (tests/torchport.py
`lockstep`): one JAX `make_run_chunk(1)` step and one port step through
`run_steps` from the same converted state, then every machine plane must
be equal, the status plane included (tolerance 0).  A grid's operand
pairs ride the lanes of one guest.  Lanes both engines leave to the host
oracle (pinsrw from memory, an operation that touches the denormal range)
are single-stepped by the port runner's oracle and the state carried over.

Cases: the operand grids of tests/test_step_fp.py (values from
tests/test_ssefp.py), the snippets of tests/test_emu.py and
tests/test_step.py that reach these classes, a grid of results that are
denormal or underflow to zero, memory operands that end at a page end for
every load size of the class, seeded random batteries, and a runner-level
FP loop that must not fall back.
"""

import random
import struct

import pytest
import torch

from tests import torchport as tp
from tests.emurunner import DATA_BASE
from tests.test_emu import HW_CASES, _ALT_REGS, _INIT_REGS
from tests.test_ssefp import F32_PAIRS, F64, _sse_snippet
from tests.test_step import DIFF_CASES
from tests.test_step_fp import PS_OPS, SD_OPS, SS_OPS
from tests.test_torch_step_sys import _opclasses
from wtf_tpu_torch.core.cpustate import GPR_NAMES
from wtf_tpu_torch.core.results import StatusCode
from wtf_tpu_torch.cpu import uops as U
from wtf_tpu_torch.interp import step as TS
from tests.torchport import one_torch_thread  # noqa: F401  (module fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_LANES = 16
CAP = 1024
SLOTS = 8
CRASH = int(StatusCode.CRASH)
_REG = {name: i for i, name in enumerate(GPR_NAMES)}
_SSE = frozenset(getattr(U, f"OPC_{n}") for g in ("sse", "ssefp")
                 for n in TS.GROUPS[g])


def lockstep(asm, lane_values=(), data=None, regs=None):
    """`asm` on N_LANES lanes; lane i takes the registers of
    lane_values[i % len(lane_values)] ({name: value})."""
    lane_regs = {}
    if lane_values:
        for lane in range(N_LANES):
            vals = lane_values[lane % len(lane_values)]
            lane_regs[lane] = {_REG[k]: v & (1 << 64) - 1
                               for k, v in vals.items()}
    return tp.lockstep(asm, data, regs, lane_regs, 0, N_LANES, 3000, CAP,
                       SLOTS)


def _ends_at_hlt(m, seen):
    assert (m.status == CRASH).all(), seen


# ---------------------------------------------------------------------------
# the operand grids of tests/test_step_fp.py
# ---------------------------------------------------------------------------

_SD_PAIRS = [("one", "two"), ("pi", "neg"), ("pzero", "nzero"),
             ("pinf", "ninf"), ("pinf", "pinf"), ("qnan", "one"),
             ("one", "qnan"), ("snan", "one"), ("one", "snan"),
             ("qnan", "snan"), ("denorm", "denorm"), ("big", "big")]
_SS_PAIRS = [(0x3F800000, 0x40000000), (0x7FC00001, 0x3F800000),
             (0x7F800001, 0x3F800000), (0xFF800000, 0x7F800000),
             (0x80000000, 0x00000000), (0x00000001, 0x7F7FFFFF)]
_PS_QUADS = [("one_two", "nan_inf", "zeros", "denorm_big"),
             ("snan_neg", "one_two", "one_two", "nan_inf")]
_UCOMI_PAIRS = [("one", "two"), ("two", "one"), ("one", "one"),
                ("qnan", "one"), ("one", "snan"), ("pzero", "nzero"),
                ("pinf", "big"), ("ninf", "pinf")]
_IVALS = [0, 1, 2**63 - 1, 2**64 - 512, 0x8000000000000000,
          12345678901234567, 0xFFFFFFFF80000000]
_F2I_NAMES = ["one", "half", "pi", "neg", "big", "qnan", "pinf", "nzero",
              "tiny"]
_CVT_BITS = [(0x3FF0000000000000, 0x40091EB851EB851F),
             (0x7FF800000000BEEF, 0xC024000000000000),
             (0x41DFFFFFFFC00000, 0x00000000499602D2),
             (0xFFFFFFFF7FFFFFFF, 0x8000000180000000)]


def _kind(op):
    return "cmp" if op.startswith("cmp") else (
        "unary" if op.startswith("sqrt") else None)


@pytest.mark.parametrize("op", SD_OPS + ["sqrtsd", "cmpeqsd", "cmpltsd",
                                         "cmpnlesd", "cmpunordsd"])
def test_sd_grid(op):
    m, seen, _ = lockstep(_sse_snippet(op, _kind(op)) + "\nhlt",
                          [{"rax": F64[a], "rcx": F64[b]}
                           for a, b in _SD_PAIRS])
    _ends_at_hlt(m, seen)


@pytest.mark.parametrize("op", SS_OPS + ["sqrtss"])
def test_ss_grid(op):
    m, seen, _ = lockstep(_sse_snippet(op, _kind(op)) + "\nhlt",
                          [{"rax": a, "rcx": b} for a, b in _SS_PAIRS])
    _ends_at_hlt(m, seen)


@pytest.mark.parametrize("op", PS_OPS + ["sqrtps", "cmpleps"])
def test_ps_grid(op):
    m, seen, _ = lockstep(
        _sse_snippet(op, _kind(op), packed=True) + "\nhlt",
        [{"rax": F32_PAIRS[a], "rdx": F32_PAIRS[b], "rcx": F32_PAIRS[c],
          "rsi": F32_PAIRS[e]} for a, b, c, e in _PS_QUADS])
    _ends_at_hlt(m, seen)


@pytest.mark.parametrize("op", ["ucomisd", "comisd", "ucomiss", "comiss"])
def test_ucomi_grid(op):
    m, seen, _ = lockstep(f"movq xmm0, rax\nmovq xmm1, rcx\n{op} xmm0, xmm1"
                          "\nhlt", [{"rax": F64[a], "rcx": F64[b]}
                                    for a, b in _UCOMI_PAIRS])
    _ends_at_hlt(m, seen)


@pytest.mark.parametrize("op", ["cvtsi2sd xmm0, rcx", "cvtsi2ss xmm0, rcx",
                                "cvtsi2sd xmm0, ecx", "cvtsi2ss xmm0, ecx"])
def test_cvtsi2_grid(op):
    m, seen, _ = lockstep(f"pxor xmm0, xmm0\n{op}\nhlt",
                          [{"rcx": v} for v in _IVALS])
    _ends_at_hlt(m, seen)


@pytest.mark.parametrize("op", ["cvttsd2si rax, xmm1", "cvtsd2si rax, xmm1",
                                "cvttsd2si eax, xmm1", "cvtsd2si eax, xmm1",
                                "cvttss2si rax, xmm1", "cvtss2si eax, xmm1"])
def test_cvt2si_grid(op):
    m, seen, _ = lockstep(f"movq xmm1, rcx\nxor eax, eax\n{op}\nhlt",
                          [{"rcx": F64[n]} for n in _F2I_NAMES])
    _ends_at_hlt(m, seen)


@pytest.mark.parametrize("op", [
    "cvtss2sd xmm0, xmm1", "cvtsd2ss xmm0, xmm1", "cvtdq2ps xmm0, xmm1",
    "cvtps2dq xmm0, xmm1", "cvttps2dq xmm0, xmm1", "cvtdq2pd xmm0, xmm1",
    "cvtpd2dq xmm0, xmm1", "cvttpd2dq xmm0, xmm1", "cvtps2pd xmm0, xmm1",
    "cvtpd2ps xmm0, xmm1"])
def test_cvt_shapes_grid(op):
    m, seen, _ = lockstep(
        "movq xmm1, rax\nmovq xmm2, rdx\npunpcklqdq xmm1, xmm2\n"
        f"pxor xmm0, xmm0\n{op}\nhlt",
        [{"rax": lo, "rdx": hi} for lo, hi in _CVT_BITS])
    _ends_at_hlt(m, seen)


@pytest.mark.parametrize("op", [
    "shufps xmm0, xmm1, 0x1B", "shufps xmm0, xmm1, 0xE4",
    "shufpd xmm0, xmm1, 0x1", "shufpd xmm0, xmm1, 0x2",
    "unpcklps xmm0, xmm1", "unpckhps xmm0, xmm1",
    "unpcklpd xmm0, xmm1", "unpckhpd xmm0, xmm1"])
def test_shuffle_grid(op):
    rng = random.Random(op)
    m, seen, _ = lockstep(
        "movq xmm0, rax\nmovq xmm2, rdx\npunpcklqdq xmm0, xmm2\n"
        "movq xmm1, rcx\nmovq xmm3, rsi\npunpcklqdq xmm1, xmm3\n"
        f"{op}\nhlt",
        [{"rax": 0x1111111122222222, "rdx": 0x3333333344444444,
          "rcx": 0x5555555566666666, "rsi": 0x7777777788888888}]
        + [{r: rng.getrandbits(64) for r in ("rax", "rdx", "rcx", "rsi")}
           for _ in range(3)])
    _ends_at_hlt(m, seen)


@pytest.mark.parametrize("op", [
    "vaddsd xmm0, xmm0, xmm1", "vmulsd xmm0, xmm0, xmm1",
    "vdivsd xmm0, xmm0, xmm1", "vsqrtsd xmm0, xmm0, xmm1",
    "vucomisd xmm0, xmm1", "vcvtsi2sd xmm0, xmm0, rcx"])
def test_vex128_grid(op):
    m, seen, _ = lockstep(f"movq xmm0, rax\nmovq xmm1, rcx\n{op}\nhlt",
                          [{"rax": F64[a], "rcx": F64[b]}
                           for a, b in (("pi", "neg"), ("qnan", "one"))])
    _ends_at_hlt(m, seen)


def test_ssefp_memory_operands():
    data = struct.pack("<dd", 1.5, 2.25) + struct.pack("<4f", 1, 2, 3, 4)
    m, seen, _ = lockstep(f"""
        mov rbx, {DATA_BASE}
        movsd xmm0, [rbx]
        addsd xmm0, [rbx+8]
        movups xmm1, [rbx+16]
        addps xmm1, [rbx+16]
        cvtsi2sd xmm2, dword ptr [rbx+16]
        ucomisd xmm0, [rbx+8]
        hlt""", data={DATA_BASE: data.ljust(0x1000, b"\x00")})
    _ends_at_hlt(m, seen)


# ---------------------------------------------------------------------------
# the snippets of the hardware corpus and of tests/test_step.py
# ---------------------------------------------------------------------------

_HW = [c for c in HW_CASES if _opclasses(c[1] + "\nhlt") & _SSE]
_MEM = [c for c in DIFF_CASES if _opclasses(c[1]) & _SSE]


@pytest.mark.parametrize("name,snippet", [(c[0], c[1]) for c in _HW])
@pytest.mark.parametrize("initset", ["a", "b"])
def test_hw_cases_match_step_lane(name, snippet, initset):
    init = list(_INIT_REGS if initset == "a" else _ALT_REGS)
    regs = {n: v for n, v in zip(GPR_NAMES, init)}
    regs.pop("rsp")
    rng = random.Random(name)
    m, seen, _ = lockstep(snippet + "\nhlt", [{}] + [
        {r: rng.getrandbits(64) for r in ("rax", "rbx", "rcx", "rdx")}
        for _ in range(3)], regs=regs)
    assert int(m.status[0]) == CRASH, seen


@pytest.mark.parametrize("name,snippet,data",
                         [(c[0], c[1], c[2]) for c in _MEM])
def test_mem_cases_match_step_lane(name, snippet, data):
    m, seen, served = lockstep(snippet, data=data)
    _ends_at_hlt(m, seen)
    # pinsrw from memory is the oracle's; nothing else here is
    assert served == 0 or "pinsrw" in snippet


def test_case_lists_cover_every_class():
    opcs = set()
    for c in _HW + _MEM:
        opcs |= _opclasses(c[1])
    assert {U.OPC_SSEMOV, U.OPC_SSEALU} <= opcs
    assert len(_MEM) >= 7


def test_vzeroall_vzeroupper():
    m, seen, _ = lockstep("""
        movq xmm3, rax
        movq xmm9, rcx
        vzeroupper
        movq rbx, xmm3
        vzeroall
        movq rdx, xmm9
        hlt""", [{"rax": 0x1122334455667788, "rcx": -1}, {"rax": 5}],
        regs={"zmm": [[i + k for k in range(8)] for i in range(32)]})
    _ends_at_hlt(m, seen)
    assert (m.xmm == 0).all()


# ---------------------------------------------------------------------------
# denormal results and page ends
# ---------------------------------------------------------------------------

_TINY = 0x0010000000000000          # 2**-1022, the smallest normal f64
_DEN_PAIRS64 = [
    (0x2000000000000000, 0x2000000000000000),   # 2**-511 squared: normal
    (0x2000000000000000, 0x1FF0000000000000),   # 2**-1023: denormal
    (0x3FE0000000000000, _TINY),                # 0.5 * 2**-1022: denormal
    (0x3CB0000000000000, _TINY),                # 2**-52 * 2**-1022
    (0x3C90000000000000, _TINY),                # 2**-54 * ...: underflow
    (0x1FF8000000000000, 0x1FF8000000000000),   # rounds into the denormals
    (0x0000000000000000, _TINY),                # a true zero
    (0x8000000000000000, 0x3FF0000000000000),   # -0 * 1
    (0x3FF0000000000000, 0x0000000000000001),   # a denormal input
    (0x43E0000000000000, 0x43E0000000000000),   # 2**63 squared: normal
    (0x7FEFFFFFFFFFFFFF, 0x7FEFFFFFFFFFFFFF),   # overflow to inf
    (0x3FF8000000000000, 0xC000000000000000),   # plain normals
]
_DEN_PAIRS32 = [
    (0x20000000, 0x20000000), (0x1F800000, 0x1F800000),
    (0x3F000000, 0x00800000), (0x33800000, 0x00800000),
    (0x33000000, 0x00800000), (0x00000000, 0x00800000),
    (0x3F800000, 0x00000001), (0x3FC00000, 0xC0000000),
]
_DEN_DIV64 = [
    (_TINY, 0x4000000000000000),                # 2**-1022 / 2: denormal
    (_TINY, 0x7FE0000000000000),                # underflow to zero
    (0x0000000000000000, 0x3FF0000000000000),   # a true zero
    (0x3FF0000000000000, 0x7FF0000000000000),   # 1 / inf: a true zero
    (0x0018000000000000, 0x3FF8000000000000),   # 1.5 * tiny / 1.5
    (0x4000000000000000, 0x3FF0000000000000),
]
_DEN_ADD64 = [
    (0x0018000000000000, 0x8010000000000000),   # 1.5 tiny - tiny
    (_TINY, 0x8010000000000000),                # tiny - tiny: true zero
    (0x3FF0000000000000, 0x3FF0000000000000),
]


@pytest.mark.parametrize("op,pairs", [
    ("mulsd", _DEN_PAIRS64), ("mulss", _DEN_PAIRS32),
    ("divsd", _DEN_DIV64), ("addsd", _DEN_ADD64),
    ("mulpd", _DEN_PAIRS64), ("divss", _DEN_PAIRS32)])
def test_denormal_results_divert_like_step_lane(op, pairs):
    """A result that is denormal or underflows to zero sends its lane to
    the oracle exactly where the JAX step does (the status planes are
    compared lane by lane at every step), whether or not the platform
    flushes denormals."""
    packed = op.endswith("pd")
    m, seen, served = lockstep(
        _sse_snippet(op, None, packed=packed) + "\nhlt",
        [{"rax": a, "rcx": b, "rdx": b, "rsi": a} for a, b in pairs])
    _ends_at_hlt(m, seen)
    assert served > 0


def test_platform_keeps_denormals():
    """The premise of the divert test above: torch keeps denormal results
    on the CPU (so `fp.py` finds them by their bits)."""
    x = torch.tensor([1e-160], dtype=torch.float64)
    y = torch.tensor([1e-20], dtype=torch.float32)
    assert (x * x).item() != 0.0 and (y * y).item() != 0.0


# (instruction with its memory operand at [rbx], load size)
_PAGE_END_FORMS = [
    ("addsd xmm0, [rbx]", 8), ("addss xmm0, [rbx]", 4),
    ("addps xmm0, [rbx]", 16), ("sqrtsd xmm0, [rbx]", 8),
    ("cmpltps xmm0, [rbx]", 16), ("cvtsi2sd xmm0, dword ptr [rbx]", 4),
    ("cvtsi2ss xmm0, qword ptr [rbx]", 8), ("cvttsd2si eax, [rbx]", 8),
    ("cvtss2si rax, [rbx]", 4), ("ucomisd xmm0, [rbx]", 8),
    ("comiss xmm0, [rbx]", 4), ("cvtss2sd xmm0, [rbx]", 4),
    ("cvtsd2ss xmm0, [rbx]", 8), ("cvtps2pd xmm0, [rbx]", 8),
    ("cvtpd2ps xmm0, [rbx]", 16), ("cvtdq2ps xmm0, [rbx]", 16),
    ("cvtdq2pd xmm0, [rbx]", 16), ("shufps xmm0, [rbx], 0x1b", 16),
    ("movdqu xmm0, [rbx]", 16), ("movss xmm0, [rbx]", 4),
    ("movsd xmm0, [rbx]", 8), ("movlps xmm0, [rbx]", 8),
    ("movhps xmm0, [rbx]", 8), ("movq xmm0, [rbx]", 8),
    ("pxor xmm0, [rbx]", 16), ("movdqu [rbx], xmm1", 16),
    ("movss [rbx], xmm1", 4), ("movhps [rbx], xmm1", 8),
]


@pytest.mark.parametrize("form,size", _PAGE_END_FORMS)
def test_page_end_operands(form, size):
    """The operand ends at the page end (no fault) or 1, size - 1 or 8
    bytes past it (a fault, read or write, at the next page): the load
    sizes are the oracle's."""
    end = DATA_BASE + 0x1000        # the next page is not mapped
    m, seen, _ = lockstep(
        f"movq xmm1, rcx\n{form}\nhlt",
        [{"rbx": end - size + over, "rcx": 0x3FF8000000000000}
         for over in (0, 1, max(size - 1, 1), 8, -3)],
        data={DATA_BASE: bytes(range(256)) * 16})
    status = m.status.tolist()
    assert status[0] == CRASH and status[1] == int(StatusCode.PAGE_FAULT)


# ---------------------------------------------------------------------------
# seeded random batteries and the runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["addsd", "mulsd", "divsd", "minsd",
                                "cmplesd"])
def test_sd_random_battery(op):
    """test_step_fp.py's battery shapes (random bits, NaN payloads, close
    pairs) on every lane."""
    rng = random.Random(f"sd {op}")
    lanes = []
    for _ in range(N_LANES):
        shape = rng.randrange(3)
        if shape == 0:
            a, b = rng.getrandbits(64), rng.getrandbits(64)
        elif shape == 1:
            a = 0x7FF0000000000000 | rng.getrandbits(52) | (
                rng.getrandbits(1) << 63)
            b = rng.getrandbits(64)
        else:
            a = rng.getrandbits(52) | (rng.getrandbits(1) << 63)
            b = a ^ rng.getrandbits(3)
        lanes.append({"rax": a, "rcx": b})
    m, seen, _ = lockstep(_sse_snippet(op, _kind(op)) + "\nhlt", lanes)
    _ends_at_hlt(m, seen)


@pytest.mark.parametrize("op", ["addps", "divps", "mulps", "cmpleps",
                                "cvtps2dq", "cvtpd2ps"])
def test_packed_random_battery(op):
    rng = random.Random(f"ps {op}")
    lanes = [{r: rng.getrandbits(64) for r in ("rax", "rdx", "rcx", "rsi")}
             for _ in range(N_LANES)]
    kind = "cmp" if op.startswith("cmp") else None
    m, seen, _ = lockstep(_sse_snippet(op, kind, packed=True) + "\nhlt",
                          lanes)
    _ends_at_hlt(m, seen)


_FP_LOOP = f"""
    mov rbx, {DATA_BASE}
    movsd xmm0, [rbx]
    mov ecx, 50
loop_top:
    addsd xmm0, [rbx+8]
    mulsd xmm0, [rbx+16]
    sqrtsd xmm1, xmm0
    cvttsd2si rax, xmm1
    dec ecx
    jnz loop_top
    movsd [rbx+24], xmm0
    hlt"""


@pytest.mark.parametrize("fused", ["off", "on"])
def test_fp_lane_no_fallback(fused):
    """test_step_fp.py's FP loop completes on the port's runner with no
    oracle fallback and the oracle's final registers and memory."""
    from wtf_tpu_torch.cpu.emu import EmuCpu, EmuMem, GuestCrash
    from wtf_tpu_torch.interp.runner import Runner
    from wtf_tpu_torch.mem.physmem import PhysMem
    from wtf_tpu_torch.snapshot.loader import Snapshot

    data = struct.pack("<ddd", 100.0, 3.5, 1.0625).ljust(0x1000, b"\x00")
    pages, cpu = tp.build_guest(_FP_LOOP, {DATA_BASE: data})
    runner = Runner(Snapshot.from_pages(pages, cpu), n_lanes=4,
                    chunk_steps=64, fused_step=fused, device="cpu")
    status = runner.run()
    assert (status == CRASH).all()
    assert runner.stats["fallbacks"] == 0, runner.stats
    emu = EmuCpu(EmuMem(PhysMem.from_pages(pages)), cpu.copy())
    with pytest.raises(GuestCrash):
        for _ in range(10_000):
            emu.step()
    gpr = runner.machine.gpr.numpy().view("uint64")
    assert [int(v) for v in gpr[0]] == list(emu.gpr)
    view = runner.view()
    pfn = view.translate(0, DATA_BASE) >> 12
    assert view.page(0, pfn)[:32] == emu.virt_read(DATA_BASE, 32)
