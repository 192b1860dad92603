"""The x87 subset of the port's precise step (ROADMAP A5(d)) against the
JAX package's step_lane, bit for bit.

The lockstep of tests/test_torch_step_fp.py (16 lanes, one JAX step and
one port step from the same state, every plane equal after each step,
the x87 stack, tag, control and status words and the status plane
included): the snippet grids of tests/test_step_x87.py with their operand
pairs on the lanes, every rounding mode of fist, m16/m32/m64 operands
that end at a page end, the denormal diverts, a step given every group
against one given only the groups `scan` finds (lanes parked at x87
stores whose width is not the operand size), and the runner: an x87 loop
with no fallback, and FXSAVE still on the oracle.
"""

import struct

import pytest
import torch

from tests import torchport as tp
from tests.asmhelper import assemble
from tests.emurunner import CODE_BASE, DATA_BASE
from tests.test_step_x87 import ARITH_BODIES
from tests.test_torch_step_fp import N_LANES, _ends_at_hlt, lockstep
from tests.test_x87 import _EPILOGUE, _PRELUDE, F64
from wtf_tpu_torch.core.results import StatusCode
from wtf_tpu_torch.cpu.decoder import decode
from wtf_tpu_torch.interp import step as TS
from tests.torchport import one_torch_thread  # noqa: F401  (module fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CRASH = int(StatusCode.CRASH)
_OUT = "\nfstp qword ptr [rsp+16]\nmov rax, [rsp+16]"


_PAIRS = [("one5", "two25"), ("pi", "e"), ("big", "tiny"), ("pinf", "ninf"),
          ("qnan", "one5"), ("denorm", "denorm")]


@pytest.mark.parametrize("body", ARITH_BODIES)
def test_x87_arith_grid(body):
    m, seen, _ = lockstep(_PRELUDE + body + _OUT + _EPILOGUE + "\nhlt",
                          [{"rax": F64[a], "rcx": F64[b]} for a, b in _PAIRS])
    _ends_at_hlt(m, seen)


@pytest.mark.parametrize("width", ["word", "dword", "qword"])
def test_fild_fistp_grid(width):
    m, seen, _ = lockstep(
        _PRELUDE + f"fild qword ptr [rsp]\nfistp {width} ptr [rsp+16]\n"
        "mov rax, [rsp+16]" + _EPILOGUE + "\nhlt",
        [{"rax": v} for v in (0, 1, -1, 123456789, 0xFFFFFFFF00000000,
                              1 << 52, -2**63, 2**63 - 1, 40000, -32769)])
    _ends_at_hlt(m, seen)


_FIST_VALUES = [
    0xC0024CCCCCCCCCCD,     # -2.2875
    0x4005999999999999,     # 2.7
    0xC005999999999999,     # -2.7
    0x4004000000000000,     # 2.5
    0x400C000000000000,     # 3.5
    0xC004000000000000,     # -2.5
    0x3FE0000000000000,     # 0.5
    0x41DFFFFFFFA00000,     # 2**31 - 1.5
    0xC1E0000000100000,     # -(2**31) - 0.5
    0x43E0000000000000,     # 2**63
    0xC3E0000000000000,     # -2**63
    0x7FF0000000000000,     # inf
    0x7FF8000000000001,     # NaN
    0x4415AF1D78B58C40,     # 1e20
    0x8000000000000000,     # -0
    0x0000000000000001,     # a denormal (diverts)
]


@pytest.mark.parametrize("rc", [0, 1, 2, 3])
def test_fist_rounding_modes(rc):
    """fist honors fpcw.RC, fisttp always chops; NaN and overflow give the
    integer indefinite (test_step_x87.py's snippet, more values)."""
    cw = 0x27F | (rc << 10)
    m, seen, served = lockstep(f"""
        sub rsp, 40
        mov word ptr [rsp+34], {cw}
        fldcw [rsp+34]
        mov [rsp], rax
        fld qword ptr [rsp]
        fist dword ptr [rsp+16]
        fisttp qword ptr [rsp+24]
        mov rax, [rsp+16]
        mov rcx, [rsp+24]
        add rsp, 40
        hlt""", [{"rax": v} for v in _FIST_VALUES])
    _ends_at_hlt(m, seen)
    assert served == 2          # the denormal lane's fist and fisttp


# Values whose fist the JAX step gets wrong: it takes 2**(bits - 1) from
# exp2, which XLA computes inexactly on the CPU (a hair above 2**31, below
# 2**15 and 2**63), where the port uses exact constants.  These lanes are
# held against the oracle instead.
_FIST_EDGES = [
    (0x41DFFFFFFFE00000, "dword"),      # 2**31 - 0.5: 2**31, the indefinite
    (0x41E0000000000000, "dword"),      # 2**31
    (0x43DFFFFFFFFFFFFF, "qword"),      # 2**63 - 1024: fits
    (0xC3DFFFFFFFFFFFFF, "qword"),      # -(2**63 - 1024)
    (0x40DFFFFFE0000000, "word"),       # 32767.5
    (0xC0E0000000000000, "word"),       # -32768
]


@pytest.mark.parametrize("rc", [0, 2])
def test_fist_range_edges_match_the_oracle(rc):
    from wtf_tpu_torch.cpu.emu import EmuCpu, EmuMem, GuestCrash
    from wtf_tpu_torch.interp.runner import Runner
    from wtf_tpu_torch.mem.physmem import PhysMem
    from wtf_tpu_torch.snapshot.loader import Snapshot

    cw = 0x27F | (rc << 10)
    for bits, width in _FIST_EDGES:
        asm = f"""
            sub rsp, 40
            mov word ptr [rsp+34], {cw}
            fldcw [rsp+34]
            mov [rsp], rax
            fld qword ptr [rsp]
            fistp {width} ptr [rsp+16]
            mov rax, [rsp+16]
            add rsp, 40
            hlt"""
        pages, cpu = tp.build_guest(asm, regs={"rax": bits})
        runner = Runner(Snapshot.from_pages(pages, cpu), n_lanes=2,
                        chunk_steps=64, device="cpu")
        assert (runner.run() == CRASH).all()
        assert runner.stats["fallbacks"] == 0
        emu = EmuCpu(EmuMem(PhysMem.from_pages(pages)), cpu.copy())
        with pytest.raises(GuestCrash):
            for _ in range(100):
                emu.step()
        got = int(runner.machine.gpr[0, 0]) & (1 << 64) - 1
        assert got == emu.gpr[0], (hex(bits), width, hex(got))


def test_fcomi_fnstsw_grid():
    m, seen, _ = lockstep(_PRELUDE + """
    fld qword ptr [rsp+8]
    fld qword ptr [rsp]
    fcomip st, st(1)
    pushfq
    pop r8
    fstp st(0)
    fld qword ptr [rsp+8]
    fld qword ptr [rsp]
    fucompp
    fnstsw ax
    movzx rdx, ax
""" + _EPILOGUE + "\nhlt", [{"rax": F64[a], "rcx": F64[b]} for a, b in (
        ("one5", "two25"), ("two25", "one5"), ("one5", "one5"),
        ("qnan", "one5"), ("pinf", "big"), ("nzero", "pzero"))])
    _ends_at_hlt(m, seen)


def test_x87_control_ops():
    m, seen, _ = lockstep("""
        sub rsp, 48
        fninit
        fnstcw [rsp]
        fld1
        fldz
        ffree st(1)
        fnclex
        fnstsw [rsp+8]
        emms
        fnstcw [rsp+16]
        stmxcsr [rsp+24]
        ldmxcsr [rsp+24]
        fld1
        fld1
        fxch st(1)
        fchs
        fabs
        fst st(1)
        fcompp
        mov rax, [rsp]
        mov rcx, [rsp+8]
        mov rdx, [rsp+16]
        add rsp, 48
        hlt""")
    _ends_at_hlt(m, seen)


def test_fst_m32_and_fld_m32():
    data = struct.pack("<f", 1.75) + struct.pack("<f", -0.375)
    m, seen, _ = lockstep(f"""
        mov rbx, {DATA_BASE}
        fld dword ptr [rbx]
        fadd dword ptr [rbx+4]
        fst dword ptr [rbx+8]
        fstp qword ptr [rbx+16]
        hlt""", data={DATA_BASE: data.ljust(0x1000, b"\x00")})
    _ends_at_hlt(m, seen)


@pytest.mark.parametrize("op", ["fsubrp st(1), st", "fdivrp st(1), st",
                                "fsubp st(1), st", "fdivp st(1), st"])
def test_x87_two_nan_payload_routing(op):
    m, seen, _ = lockstep(
        _PRELUDE + f"fld qword ptr [rsp]\nfld qword ptr [rsp+8]\n{op}\n"
        + _OUT + _EPILOGUE + "\nhlt",
        [{"rax": 0x7FF8000000000001, "rcx": 0x7FF8000000000002},
         {"rax": 0x7FF0000000000003, "rcx": 0xFFF8000000000004},
         {"rax": 0x3FF0000000000000, "rcx": 0x7FF0000000000005},
         {"rax": 0x7FF0000000000000, "rcx": 0x7FF0000000000000}])
    _ends_at_hlt(m, seen)


# ---------------------------------------------------------------------------
# denormal diverts and page ends
# ---------------------------------------------------------------------------

_TINY = 0x0010000000000000


def test_x87_denormal_diverts_like_step_lane():
    """m32 denormal operands, products and quotients that are denormal or
    underflow, fst m32 of a value too small for f32, fist and fcom of a
    denormal: the lanes go to the oracle exactly where the JAX step's do
    (the status planes are compared at every step)."""
    data = struct.pack("<I", 0x00000001) + struct.pack("<d", 1.0)
    m, seen, served = lockstep(f"""
        mov rbx, {DATA_BASE}
        mov [rbx+16], rax
        mov [rbx+24], rcx
        fld qword ptr [rbx+16]
        fmul qword ptr [rbx+24]
        fst dword ptr [rbx+32]
        fld qword ptr [rbx+24]
        fdivp st(1), st
        fistp qword ptr [rbx+40]
        fld qword ptr [rbx+4]
        fmul dword ptr [rbx]
        fld dword ptr [rbx]
        fcomip st, st(1)
        fstp qword ptr [rbx+48]
        hlt""", [{"rax": a, "rcx": b} for a, b in (
            (0x2000000000000000, 0x1FF0000000000000),   # denormal product
            (0x3FE0000000000000, _TINY),
            (0x3C90000000000000, _TINY),                # underflow
            (0x0000000000000000, _TINY),                # a true zero
            (0x3FF8000000000000, 0x4000000000000000),   # normals
            (0x0000000000000003, 0x3FF0000000000000),   # denormal input
            (0x3800000000000000, 0x3FF0000000000000),   # too small for f32
        )], data={DATA_BASE: data.ljust(0x1000, b"\x00")})
    _ends_at_hlt(m, seen)
    # every lane diverts at fmul m32 (a denormal m32 operand) and fld m32
    assert served >= 2 * N_LANES


_X87_PAGE_END = [
    ("fld dword ptr [rbx]", 4), ("fld qword ptr [rbx]", 8),
    ("fild word ptr [rbx]", 2), ("fild dword ptr [rbx]", 4),
    ("fild qword ptr [rbx]", 8), ("fadd dword ptr [rbx]", 4),
    ("fmul qword ptr [rbx]", 8), ("fcom qword ptr [rbx]", 8),
    ("fst dword ptr [rbx]", 4), ("fstp qword ptr [rbx]", 8),
    ("fist word ptr [rbx]", 2), ("fistp dword ptr [rbx]", 4),
    ("fisttp qword ptr [rbx]", 8), ("fnstcw [rbx]", 2),
    ("fnstsw [rbx]", 2), ("fldcw [rbx]", 2), ("stmxcsr [rbx]", 4),
]


@pytest.mark.parametrize("form,size", _X87_PAGE_END)
def test_x87_page_end_operands(form, size):
    """Loads and stores at the page end and 1, size - 1 and 8 bytes past
    it (stores fault as writes, without a load)."""
    end = DATA_BASE + 0x1000
    m, seen, _ = lockstep(
        f"fld1\n{form}\nhlt",
        [{"rbx": end - size + over} for over in (0, 1, max(size - 1, 1), 8)],
        data={DATA_BASE: bytes(range(256)) * 16})
    status = m.status.tolist()
    assert status[0] == CRASH and status[1] == int(StatusCode.PAGE_FAULT)


def test_skipped_groups_change_no_bit():
    """A step given every group gives the same planes as one given only
    the groups `scan` finds, on a batch whose lanes sit at SSE, SSE-FP and
    x87 forms, and at x87 stores (narrower than the operand size) while
    not RUNNING: their store windows are written back at the store's
    width, which the "roles" group computes for them."""
    asm = (f"mov rbx, {DATA_BASE + 0xFFE}\nfist word ptr [rbx]\n"
           "fnstcw [rbx]\nfld1\naddsd xmm0, xmm1\npxor xmm2, xmm2\n"
           "fstp qword ptr [rbx]\nhlt")
    starts, off, code = [], 0, assemble(asm)
    while off < len(code):
        starts.append(CODE_BASE + off)
        off += decode(code[off:off + 15], CODE_BASE + off).length
    pages, cpu = tp.build_guest(asm, {DATA_BASE: bytes(0x1000)})
    r = tp.warm_runner(pages, cpu, 8, 1024, 8)
    tab, img = r.cache.device("cpu"), r.image
    m = r.machine
    m.rip = torch.tensor([starts[i] for i in (0, 1, 2, 3, 4, 5, 1, 2)])
    m.gpr[:, 3] = DATA_BASE + 0xFFE
    m.status[6:] = int(StatusCode.OK)
    seen = set()
    for _ in range(8):
        full = m.clone()
        TS.step(tab, img, full, 0)
        pre, _, groups = TS.scan(tab, img, m)
        seen |= groups
        TS.step(tab, img, m, 0, pre, groups)
        for (name, a), (_, b) in zip(full.planes(), m.planes()):
            assert torch.equal(a, b), name
    assert {"sse", "ssefp", "x87", "roles"} <= seen


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

_X87_LOOP = f"""
    mov rbx, {DATA_BASE}
    fld qword ptr [rbx]
    mov ecx, 40
top:
    fmul qword ptr [rbx+8]
    fld1
    faddp st(1), st
    dec ecx
    jnz top
    fstp qword ptr [rbx+16]
    hlt"""


@pytest.mark.parametrize("fused", ["off", "on"])
def test_x87_loop_no_fallback(fused):
    from wtf_tpu_torch.interp.runner import Runner
    from wtf_tpu_torch.snapshot.loader import Snapshot

    data = struct.pack("<dd", 100.0, 1.0625).ljust(0x1000, b"\x00")
    pages, cpu = tp.build_guest(_X87_LOOP, {DATA_BASE: data})
    runner = Runner(Snapshot.from_pages(pages, cpu), n_lanes=4,
                    chunk_steps=64, fused_step=fused, device="cpu")
    status = runner.run()
    assert (status == CRASH).all()
    assert runner.stats["fallbacks"] == 0, runner.stats


def test_fxsave_goes_to_the_oracle():
    """FXSAVE and FXRSTOR stay with the oracle: the step leaves those
    lanes UNSUPPORTED, and the runner counts them under "x87"."""
    from wtf_tpu_torch.interp.runner import Runner
    from wtf_tpu_torch.snapshot.loader import Snapshot

    asm = f"""
        mov rbx, {DATA_BASE}
        fld1
        fxsave [rbx]
        fstp st(0)
        fxrstor [rbx]
        fstp qword ptr [rbx+0x600]
        hlt"""
    data = {DATA_BASE: bytes(0x1000)}
    m, seen, served = lockstep(asm, data=data)
    _ends_at_hlt(m, seen)
    assert served == 2 * N_LANES
    pages, cpu = tp.build_guest(asm, data)
    runner = Runner(Snapshot.from_pages(pages, cpu), n_lanes=2,
                    chunk_steps=64, device="cpu")
    assert (runner.run() == CRASH).all()
    assert runner.stats["fallbacks_by_opclass"] == {"x87": 4}
