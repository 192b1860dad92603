"""The precise batched step: one instruction for every lane.

The counterpart of wtf_tpu/interp/step.py `step_lane`, written over the
lane axis directly:

  1. decode-cache probe with the tenant-tagged key -> NEED_DECODE on miss
  2. breakpoint check honoring bp_skip               -> BREAKPOINT
  3. SMC check of the live code bytes against the decode-time raw bytes
     (through the lane overlay)                       -> SMC
  4. effective address (with the BT bit-string displacement), six page
     walks (first/last byte of the load, the read-modify operand and the
     store; rsi/rdi for strings, rbp for LEAVE, rsp for the stack forms),
     the 3-word operand windows, PAGE_FAULT with the faulting address and
     access kind (SSE-FP loads at the oracle's byte counts, x87 stores at
     their operand width)
  5. the sixteen hot opclasses the fused kernel also runs
     (`HOT_OPCLASSES`); the integer and system classes: DIV (#DE ->
     DIVIDE_ERROR), CONVERT, BT, BITSCAN, BMI, BSWAP, XCHG, CMPXCHG, XADD,
     one string element per step (REP iterates by executing again),
     LEAVE/ENTER, PUSHF/POPF, the flag ops, CPUID, RDTSC, RDRAND, XGETBV,
     SYSCALL/SYSRET, SWAPGS, RD/WR{FS,GS}BASE, MOV CR (a new cr3 ->
     CR3_CHANGE), RDMSR/WRMSR of the MSRs the machine carries, and
     INT/INT1/HLT (-> CRASH); and the SSE and x87 classes (interp/fp.py):
     SSEMOV, SSEALU, SSEFP, VZEROALL and the x87 subset
  6. the overlay store (OVERLAY_FULL when a lane is out of rows), register
     writes in the JAX step's order (rsp/rsi/rdi/rcx, aux, primary, the
     CPUID rows), rflags, rip, control registers, MSRs, selectors, the
     xmm file and the x87 stack, tag, control and status words
  7. icount and the instruction budget (TIMEDOUT), the coverage bit of the
     uop entry, the edge bit at mix64(rip) ^ target, the counter block

What the JAX step sends to the host oracle stays UNSUPPORTED here too, and
the runner single-steps those lanes on the oracle (Runner._fallback_step):
`ORACLE_OPCLASSES`, unknown MSRs, 128-bit dividends, bad control registers,
non-canonical wr{fs,gs}base, 67h strings, pinsrw from memory, the
FXSAVE-class x87 state movers, and SSE-FP and x87 lanes whose operation
touches the denormal range.

A step computes each group of classes (`GROUPS`) only when the caller says
a lane may need it (`run_steps` reads which are present among the running
lanes, in its one read per step): a group's values are selected only where
its opclass predicate holds, so skipping an absent group changes no bit.

The step mutates the machine in place (the overlay rows are written with
indexed assignment; the small register tensors are replaced).
"""

from __future__ import annotations

import torch

from wtf_tpu_torch.core.results import StatusCode
from wtf_tpu_torch.cpu import uops as U
from wtf_tpu_torch.cpu.cpuid import CPUID_TABLE, MAX_BASIC_LEAF
from wtf_tpu_torch.cpu.emu import MSR_ATTR
from wtf_tpu_torch.interp import fp as F
from wtf_tpu_torch.interp import ints as I
from wtf_tpu_torch.interp.machine import (
    CTR_DECODE_MISS, CTR_INSTR, CTR_MEM_FAULT, Machine,
)
from wtf_tpu_torch.interp.uoptable import (
    F_A32, F_BASE_REG, F_COND, F_DST_KIND, F_DST_REG, F_IDX_REG, F_LENGTH,
    F_OPC, F_OPSIZE, F_REP, F_SCALE, F_SEG, F_SEXT, F_SRCSIZE, F_SRC_KIND,
    F_SRC_REG, F_SUB, M_BP, M_PFN0, M_PFN1, MU_DISP, MU_IMM, MU_RAW_HI,
    MU_RAW_LO, UopTable, uop_lookup,
)
from wtf_tpu_torch.mem.overlay import (
    extract_pair, load_windows3, store_window3,
)
from wtf_tpu_torch.mem.paging import translate
from wtf_tpu_torch.mem.physmem import MemImage, lane_image

# The fused kernel's subset (wtf_tpu/interp/pstep.py FUSED_OPCLASSES).
HOT_OPCLASSES = frozenset({
    "NOP", "FENCE", "MOV", "LEA", "ALU", "UNARY", "SETCC", "CMOVCC",
    "JCC", "JMP", "SHIFT", "MUL", "PUSH", "POP", "CALL", "RET",
})
HOT_OPCS = frozenset(getattr(U, f"OPC_{name}") for name in HOT_OPCLASSES)

# The other classes the step executes, in groups it computes only when
# present (see the module docstring).
GROUPS = {
    "div": ("DIV",),
    "bits": ("CONVERT", "BT", "BITSCAN", "PEXT", "BSWAP", "XCHG",
             "CMPXCHG", "XADD"),
    "string": ("STRING",),
    "stack": ("LEAVE", "PUSHF", "POPF", "FLAGOP"),
    "sys": ("SYSCALL", "INT", "HLT", "INT1", "RDTSC", "RDRAND", "CPUID",
            "XGETBV", "RDGSBASE", "MOVCR", "MSR"),
    "sse": ("SSEMOV", "SSEALU", "VZEROALL"),
    "ssefp": ("SSEFP",),
    "x87": ("X87",),
}
# Classes whose access is not at the generic effective address or size
# (strings, the rbp/rsp forms, BT's bit string, x87 stores of their
# operand width).  Every lane writes its store window back, storing or not
# (mem/overlay.py store_window3), so the "roles" group is computed when
# ANY lane, running or not, sits at one of these.
ROLES = ("STRING", "LEAVE", "PUSHF", "POPF", "BT", "X87")
ALL_GROUPS = frozenset(GROUPS) | {"roles"}

# Oracle-serviced in both packages.
ORACLE_OPCLASSES = frozenset({"INVALID", "IRET", "SSECVT", "PCLMUL",
                              "STACKSTR"})

_RUNNING = int(StatusCode.RUNNING)
_I64 = torch.int64
_LOW32 = 0xFFFFFFFF


_sel = I.select


def _mod(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a % b with a % 0 == a (XLA's unsigned remainder, which the JAX
    step inherits for lanes whose uop fields are not a shift's)."""
    return torch.where(b == 0, a, a % torch.where(b == 0, 1, b))


def _u32(x: torch.Tensor) -> torch.Tensor:
    """The u32 value of the low 32 bits, as a non-negative int64 (shift
    counts computed in u32 wrap past 2**32; ints.shl/shr read anything
    >= 64 as a full shift-out)."""
    return x & _LOW32


# ---------------------------------------------------------------------------
# register file
# ---------------------------------------------------------------------------

def _gather(gpr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(gpr, 1, idx.long().clamp(0, 15)[:, None])[:, 0]


def read64(gpr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Full qword read; REG_NONE (or any out-of-file index) reads 0."""
    ok = (idx >= 0) & (idx < 16)
    return torch.where(ok, _gather(gpr, idx), torch.zeros_like(gpr[:, 0]))


def read_reg(gpr: torch.Tensor, idx: torch.Tensor, nbytes) -> torch.Tensor:
    """Register read at a width; AH-view indices read bits 15:8."""
    high = idx >= U.REG_AH_BASE
    v = _gather(gpr, torch.where(high, idx - U.REG_AH_BASE, idx))
    return torch.where(high, (v >> 8) & 0xFF, I.zext(v, nbytes))


def gpr_write(gpr, cond, idx, val, nbytes):
    """Partial-register merge of cpu/emu.py write_reg: 32-bit writes
    zero-extend, 8/16-bit writes merge, AH-view writes hit bits 15:8."""
    high = idx >= U.REG_AH_BASE
    base = torch.where(high, idx - U.REG_AH_BASE, idx).long().clamp(0, 15)
    old = torch.gather(gpr, 1, base[:, None])[:, 0]
    n = nbytes.long() if torch.is_tensor(nbytes) else \
        torch.full_like(old, nbytes)
    m = I.size_mask(n)
    merged = torch.where(n >= 8, val, torch.where(
        n == 4, val & _LOW32, (old & ~m) | (val & m)))
    new = torch.where(high, (old & ~0xFF00) | ((val & 0xFF) << 8), merged)
    new = torch.where(cond, new, old)
    return gpr.scatter(1, base[:, None], new[:, None])


def scale_idx(v: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """index * scale for SIB scales {0, 1, 2, 4, 8}; 0 means no index."""
    lg = torch.where(scale == 2, 1, torch.where(
        scale == 4, 2, torch.where(scale == 8, 3, 0)))
    return torch.where(scale != 0, v << lg, torch.zeros_like(v))


def effective_address(disp, base, idx_scaled, seg, a32):
    """disp + base + scaled index, truncated to 32 bits under 67h BEFORE
    the segment base is added."""
    flat = disp + base + idx_scaled
    flat = torch.where(a32 != 0, flat & _LOW32, flat)
    return flat + seg


# ---------------------------------------------------------------------------
# the integer classes (the JAX alu_limb / unary_limb / shift_limb /
# mul_limb, on int64; `rf` is the full rflags and bits outside the
# arithmetic flags pass through)
# ---------------------------------------------------------------------------

def alu(sub, a, b, cf_in, opsize, rf):
    """add/adc/sub/sbb/cmp/and/or/xor/test -> (result, rflags, writes)."""
    r_add = I.zext(a + b, opsize)
    r_adc = I.zext(I.adc(a, b, cf_in)[0], opsize)
    r_sub = I.zext(a - b, opsize)
    r_sbb = I.zext(I.sbb(a, b, cf_in)[0], opsize)
    r_and, r_or, r_xor = a & b, a | b, a ^ b
    r = _sel([sub == U.ALU_ADD, sub == U.ALU_ADC, sub == U.ALU_SUB,
              sub == U.ALU_SBB, sub == U.ALU_CMP, sub == U.ALU_AND,
              sub == U.ALU_OR, sub == U.ALU_XOR, sub == U.ALU_TEST],
             [r_add, r_adc, r_sub, r_sbb, r_sub, r_and, r_or, r_xor, r_and],
             torch.zeros_like(a))
    fl_add = I.flags_add(a, b, r, opsize, (sub == U.ALU_ADC) & cf_in)
    fl_sub = I.flags_sub(a, b, r, opsize, (sub == U.ALU_SBB) & cf_in)
    fl_logic = I.flags_logic(r, opsize)
    is_add = (sub == U.ALU_ADD) | (sub == U.ALU_ADC)
    is_sub = (sub == U.ALU_SUB) | (sub == U.ALU_SBB) | (sub == U.ALU_CMP)
    fl = torch.where(is_add, fl_add, torch.where(is_sub, fl_sub, fl_logic))
    writes = ~((sub == U.ALU_CMP) | (sub == U.ALU_TEST))
    return r, (rf & ~I.FLAGS_ARITH) | fl, writes


def unary(sub, a, cf_in, opsize, rf):
    """inc/dec/not/neg -> (result, rflags); inc/dec keep CF, neg sets
    CF = (a != 0), not leaves rflags alone."""
    one = torch.ones_like(a)
    zero = torch.zeros_like(a)
    false = torch.zeros_like(cf_in)
    r_inc = I.zext(a + 1, opsize)
    r_dec = I.zext(a - 1, opsize)
    r_neg = I.zext(-a, opsize)
    r_not = I.zext(~a, opsize)
    r = _sel([sub == U.UN_INC, sub == U.UN_DEC, sub == U.UN_NOT,
              sub == U.UN_NEG], [r_inc, r_dec, r_not, r_neg], zero)
    fl = torch.where(
        sub == U.UN_INC, I.flags_add(a, one, r_inc, opsize, false),
        torch.where(sub == U.UN_DEC, I.flags_sub(a, one, r_dec, opsize, false),
                    I.flags_sub(zero, a, r_neg, opsize, false)))
    cf = torch.where((sub == U.UN_INC) | (sub == U.UN_DEC), cf_in,
                     I.zext(a, opsize) != 0)
    new_rf = torch.where(
        sub == U.UN_NOT, rf,
        (rf & ~I.FLAGS_ARITH) | (fl & ~I.CF) | cf.to(_I64) * I.CF)
    return r, new_rf


def shift(sub, sext_f, a, filler, cl, src, imm, cf_in, opsize, rf):
    """shl/shr/sar/rol/ror/rcl/rcr/shld/shrd -> (result, rflags, writes).
    Counts are u32 quantities as in shift_limb (`count - 1` at count 0
    wraps and shifts everything out)."""
    bits = opsize.long() * 8
    is_shxd = (sub == U.SH_SHLD) | (sub == U.SH_SHRD)
    cnt_src = torch.where(is_shxd, torch.where(sext_f == 3, _u32(imm),
                                               cl & 0xFF), _u32(src))
    count0 = cnt_src & torch.where(opsize >= 8, 0x3F, 0x1F)
    is_rc = (sub == U.SH_RCL) | (sub == U.SH_RCR)
    count = torch.where(is_rc, _mod(count0, bits + 1), count0)
    count = torch.where(is_shxd & (count > bits), _mod(count, bits), count)
    cnz = count != 0
    am = I.zext(a, opsize)
    sa = I.sext(a, opsize)
    cf01 = cf_in.to(_I64)
    c1m = _u32(count - 1)
    zero = torch.zeros_like(a)

    def bit0(p):
        return (p & 1) != 0

    shl_r = I.zext(I.shl(am, count), opsize)
    shl_cf = (count <= bits) & bit0(I.shr(am, _u32(bits - count)))
    shr_r = I.shr(am, count)
    shr_cf = (count <= bits) & bit0(I.shr(am, c1m))
    sar_r = I.zext(I.sar(sa, count), opsize)
    sar_cf = bit0(I.sar(sa, c1m))
    rot_c = _mod(count, bits)
    rol_r = torch.where(rot_c == 0, am, I.zext(
        I.shl(am, rot_c) | I.shr(am, bits - rot_c), opsize))
    rol_cf = bit0(rol_r)
    ror_r = torch.where(rot_c == 0, am, I.zext(
        I.shr(am, rot_c) | I.shl(am, bits - rot_c), opsize))
    ror_cf = I.msb(ror_r, opsize)
    rcl_r = I.zext(I.shl(am, count) | I.shl(cf01, c1m) | torch.where(
        count > 1, I.shr(am, bits + 1 - count), zero), opsize)
    rcl_cf = torch.where(cnz, bit0(I.shr(am, _u32(bits - count))), cf_in)
    rcr_r = I.zext(I.shr(am, count) | I.shl(cf01, _u32(bits - count))
                   | torch.where(count > 1, I.shl(am, bits + 1 - count),
                                 zero), opsize)
    rcr_cf = torch.where(cnz, bit0(I.shr(am, c1m)), cf_in)
    shld_r = I.zext(I.shl(am, count) | I.shr(filler, _u32(bits - count)),
                    opsize)
    shld_cf = bit0(I.shr(am, _u32(bits - count)))
    shrd_r = I.zext(I.shr(am, count) | I.shl(filler, _u32(bits - count)),
                    opsize)
    shrd_cf = bit0(I.shr(am, c1m))

    conds = [(sub == U.SH_SHL) | (sub == U.SH_SAL), sub == U.SH_SHR,
             sub == U.SH_SAR, sub == U.SH_ROL, sub == U.SH_ROR,
             sub == U.SH_RCL, sub == U.SH_RCR, sub == U.SH_SHLD,
             sub == U.SH_SHRD]
    r = _sel(conds, [shl_r, shr_r, sar_r, rol_r, ror_r, rcl_r, rcr_r,
                     shld_r, shrd_r], zero)
    false = torch.zeros_like(cf_in)
    cf = _sel(conds, [shl_cf, shr_cf, sar_cf, rol_cf, ror_cf, rcl_cf,
                      rcr_cf, shld_cf, shrd_cf], false)
    count1 = count == 1
    of_keep = (rf & I.OF) != 0
    r_msb = I.msb(r, opsize)
    am_msb = I.msb(am, opsize)
    ror_b2 = bit0(I.shr(ror_r, _u32(bits - 2)))
    of = _sel(conds, [
        torch.where(count1, r_msb != cf, of_keep),
        torch.where(count1, am_msb, of_keep),
        torch.where(count1, false, of_keep),
        torch.where(count1, r_msb != cf, of_keep),
        torch.where(count1, r_msb != ror_b2, of_keep),
        torch.where(count1, r_msb != cf, of_keep),
        torch.where(count1, am_msb != cf_in, of_keep),
        torch.where(count1, I.msb(shld_r ^ am, opsize), false),
        torch.where(count1, I.msb(shrd_r ^ am, opsize), false),
    ], of_keep)
    full = I.mkflags(cf, I.parity_even(r), false, r == 0, r_msb, of)
    mask = torch.where(is_rc, I.CF | I.OF, I.CF | I.OF | I.ZF | I.SF | I.PF)
    new_rf = torch.where(cnz, (rf & ~mask) | (full & mask), rf)
    return r, new_rf, cnz


def mul(sub, sext_f, a, b, rax, imm, opsize, rf):
    """2/3-operand imul and widening mul/imul -> (primary write, the
    widening high half, rflags).  An 8-bit widening multiply writes the
    full product to AX."""
    bits = opsize.long() * 8
    wide = opsize >= 8
    sb = I.sext(b, opsize)
    is_mul2 = sub == U.MUL_2OP
    mul2_a = torch.where(sext_f == 2, b, a)
    mul2_b = torch.where(sext_f == 2, I.zext(imm, opsize), b)
    m2sa, m2sb = I.sext(mul2_a, opsize), I.sext(mul2_b, opsize)
    m2_full = m2sa * m2sb
    mul2_lo = I.zext(m2_full, opsize)
    mul2_of = torch.where(wide, I.smulhi(m2sa, m2sb) != (mul2_lo >> 63),
                          m2_full != I.sext(mul2_lo, opsize))
    muw_full_u = rax * b
    muw_u_lo = torch.where(wide, muw_full_u, I.zext(muw_full_u, opsize))
    muw_u_hi = torch.where(wide, I.umulhi(rax, b),
                           I.zext(I.shr(muw_full_u, bits), opsize))
    sax = I.sext(rax, opsize)
    muw_full_s = sax * sb
    muw_s_small = I.zext(muw_full_s, opsize)
    muw_s_hi64 = I.smulhi(sax, sb)
    muw_s_lo = torch.where(wide, muw_full_s, muw_s_small)
    muw_s_hi = torch.where(wide, muw_s_hi64,
                           I.zext(I.shr(muw_full_s, bits), opsize))
    muw_s_of = torch.where(wide, muw_s_hi64 != (muw_full_s >> 63),
                           muw_full_s != I.sext(muw_s_small, opsize))
    signed = sub == U.MUL_WIDE_S
    muw_lo = torch.where(signed, muw_s_lo, muw_u_lo)
    muw_hi = torch.where(signed, muw_s_hi, muw_u_hi)
    muw_of = torch.where(signed, muw_s_of, muw_u_hi != 0)
    mul_of = torch.where(is_mul2, mul2_of, muw_of)
    prod16 = torch.where(signed, muw_full_s, muw_full_u) & 0xFFFF
    w1 = torch.where(is_mul2, mul2_lo,
                     torch.where(opsize == 1, prod16, muw_lo))
    false = torch.zeros_like(mul_of)
    rf2 = (rf & ~I.FLAGS_ARITH) | I.mkflags(
        mul_of, I.parity_even(mul2_lo), false, false,
        I.msb(mul2_lo, opsize), mul_of)
    rfw = (rf & ~(I.CF | I.OF)) | mul_of.to(_I64) * (I.CF | I.OF)
    return w1, muw_hi, torch.where(is_mul2, rf2, rfw)


# ---------------------------------------------------------------------------
# the integer and system classes of ROADMAP A5(b) (the JAX step's inline
# blocks, step.py:966-1219, as functions of [L] tensors)
# ---------------------------------------------------------------------------

def div(sub, rax_op, rdx_op, ax16, b, opsize):
    """div/idiv -> (quotient, remainder, #DE).  The dividend is AX at
    8 bits, DX:AX or EDX:EAX at 16 and 32, RAX at 64 (a 128-bit dividend
    never gets here: `div64_hard` sends it to the oracle).  No lane
    traps: a zero divisor reads as 1 and INT64_MIN / -1 as INT64_MIN / 1,
    and both raise #DE."""
    bits = opsize.long() * 8
    opmask = I.size_mask(opsize)
    dividend = torch.where(opsize == 1, ax16, torch.where(
        opsize >= 8, rax_op, I.shl(rdx_op, bits) | rax_op))
    div_b = b & opmask
    div_bz = div_b == 0
    q_u, rem_u = I.udivmod(dividend, torch.where(div_bz, 1, div_b))
    two, four = torch.full_like(opsize, 2), torch.full_like(opsize, 4)
    sdividend = torch.where(opsize == 1, I.sext(dividend, two), torch.where(
        opsize == 2, I.sext(dividend, four), torch.where(
            opsize == 4, dividend, rax_op)))
    sb = I.sext(div_b, opsize)
    q_s, rem_s = I.sdivmod(sdividend, sb)
    int_min_edge = (sdividend == I.s64(1 << 63)) & (sb == -1)
    half = I.shr(opmask, 1)
    is_s = sub == U.DIV_S
    q_over = torch.where(is_s, (q_s > half) | (q_s < -half - 1)
                         | int_min_edge, I.ltu(opmask, q_u))
    q = torch.where(is_s, q_s, q_u) & opmask
    rem = torch.where(is_s, rem_s, rem_u) & opmask
    return q, rem, div_bz | q_over


def bt(sub, val, offset, rf):
    """bt/bts/btr/btc of `val` at a bit offset already reduced to the
    width -> (result, rflags, writes)."""
    bit = (I.shr(val, offset) & 1) != 0
    one = I.shl(torch.ones_like(val), offset)
    r = _sel([sub == U.BT_BTS, sub == U.BT_BTR, sub == U.BT_BTC],
             [val | one, val & ~one, val ^ one], val)
    return r, (rf & ~I.CF) | bit.to(_I64) * I.CF, sub != U.BT_BT


def bitscan(sub, src, opsize, rf):
    """bsf/bsr/popcnt/tzcnt/lzcnt -> (result, rflags, writes)."""
    bits = opsize.long() * 8
    s = src & I.size_mask(opsize)
    zero = s == 0
    tz = I.popcnt(~s & (s - 1))
    length = I.bitlen(s)
    r = _sel([sub == U.BS_POPCNT, sub == U.BS_TZCNT, sub == U.BS_LZCNT,
              sub == U.BS_BSF, sub == U.BS_BSR],
             [I.popcnt(s), torch.where(zero, bits, tz),
              torch.where(zero, bits, bits - length), tz, length - 1],
             torch.zeros_like(s))
    z01 = zero.to(_I64)
    rf_r = _sel([sub == U.BS_POPCNT,
                 (sub == U.BS_TZCNT) | (sub == U.BS_LZCNT)],
                [(rf & ~I.FLAGS_ARITH) | z01 * I.ZF,
                 (rf & ~(I.CF | I.ZF)) | z01 * I.CF
                 | (r == 0).to(_I64) * I.ZF],
                (rf & ~I.ZF) | z01 * I.ZF)
    return r, rf_r, ~(((sub == U.BS_BSF) | (sub == U.BS_BSR)) & zero)


def bmi(sub, src, third, imm, opsize, rf):
    """The BMI1/BMI2 scalar ops (OPC_PEXT); `third` is the VEX.vvvv
    register -> (result, rflags)."""
    bits = opsize.long() * 8
    opmask = I.size_mask(opsize)
    s = src & opmask
    one = torch.ones_like(s)
    n8 = third & 0xFF
    bzhi = torch.where(I.ltu(n8, bits), s & (I.shl(one, n8) - 1), s)
    bx_len = I.shr(third, 8) & 0xFF
    bextr = torch.where(I.ltu(n8, bits), I.shr(s, n8)
                        & (I.shl(one, bx_len) - 1), 0) & opmask
    cnt = third & torch.where(opsize >= 8, 63, 31)
    rorx_n = imm & torch.where(opsize >= 8, 63, 31)
    res = _sel(
        [sub == U.BMI_ANDN, sub == U.BMI_BZHI, sub == U.BMI_BEXTR,
         sub == U.BMI_SHLX, sub == U.BMI_SHRX, sub == U.BMI_SARX,
         sub == U.BMI_PDEP, sub == U.BMI_PEXT_, sub == U.BMI_BLSR,
         sub == U.BMI_BLSMSK, sub == U.BMI_BLSI],
        [~third & s & opmask, bzhi, bextr, I.shl(s, cnt) & opmask,
         I.shr(s, cnt), I.sar(I.sext(s, opsize), cnt) & opmask,
         I.pdep(third, s), I.pext(third, s), s & (s - 1) & opmask,
         (s ^ (s - 1)) & opmask, s & (-s & opmask)],
        torch.where(rorx_n == 0, s, (I.shr(s, rorx_n)
                                     | I.shl(s, bits - rorx_n)) & opmask))
    false = torch.zeros_like(s, dtype=torch.bool)
    cf = _sel([sub == U.BMI_BZHI, sub == U.BMI_BLSR, sub == U.BMI_BLSMSK,
               sub == U.BMI_BLSI],
              [I.ltu(bits - 1, n8), s == 0, s == 0, s != 0], false)
    fl = I.mkflags(cf, false, false, res == 0, I.msb(res, opsize), false)
    szco = I.SF | I.ZF | I.CF | I.OF
    zco = I.ZF | I.CF | I.OF
    rf_r = _sel([(sub == U.BMI_ANDN) | (sub == U.BMI_BZHI)
                 | (sub == U.BMI_BLSR) | (sub == U.BMI_BLSMSK)
                 | (sub == U.BMI_BLSI), sub == U.BMI_BEXTR],
                [(rf & ~szco) | (fl & szco), (rf & ~zco) | (fl & zco)], rf)
    return res, rf_r


_CPUID_KEYS = [list(k) for k in CPUID_TABLE]
_CPUID_VALS = [list(v) for v in CPUID_TABLE.values()]
_CPUID_BASIC = _CPUID_VALS[list(CPUID_TABLE).index((MAX_BASIC_LEAF, 0))]


def cpuid(eax, ecx):
    """The oracle's CPUID table and fallback chain (cpu/cpuid.py): the
    exact (leaf, subleaf) row, else (leaf, 0), else the highest basic
    leaf for an out-of-range basic leaf, else zeros -> [L, 4] (eax, ebx,
    ecx, edx).  Keys are unique, so the masked sum of the matching rows
    is the row."""
    dev = eax.device
    keys = torch.tensor(_CPUID_KEYS, dtype=_I64, device=dev)
    vals = torch.tensor(_CPUID_VALS, dtype=_I64, device=dev)
    leaf, subleaf = (eax & _LOW32)[:, None], (ecx & _LOW32)[:, None]
    exact = (keys[:, 0] == leaf) & (keys[:, 1] == subleaf)
    leaf0 = (keys[:, 0] == leaf) & (keys[:, 1] == 0)
    in_basic = (leaf < 0x80000000) & (leaf > MAX_BASIC_LEAF)
    basic = torch.tensor(_CPUID_BASIC, dtype=_I64, device=dev)
    return torch.where(
        exact.any(1, keepdim=True), (exact[..., None] * vals).sum(1),
        torch.where(leaf0.any(1, keepdim=True),
                    (leaf0[..., None] * vals).sum(1),
                    torch.where(in_basic, basic, 0)))


def canonical(gva):
    """Bits 63:47 all equal."""
    top = gva >> 47
    return (top == 0) | (top == -1)


def fault_at(addr, first_ok):
    """A straddling access whose first page translates faults at the next
    page boundary (the oracle's per-page walk reports it there)."""
    return torch.where(first_ok, (addr & ~0xFFF) + 0x1000, addr)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

class Decoded:
    """The fetched uop fields of every lane ([L] tensors)."""

    def __init__(self, tab: UopTable, idxc: torch.Tensor):
        f = tab.meta_i32[idxc].long()
        mu = tab.meta_u64[idxc]
        self.opc = f[:, F_OPC]
        self.sub = f[:, F_SUB]
        self.cond = f[:, F_COND]
        self.length = f[:, F_LENGTH]
        self.opsize = f[:, F_OPSIZE]
        self.srcsize0 = f[:, F_SRCSIZE]
        self.sext = f[:, F_SEXT]
        self.dk, self.dr = f[:, F_DST_KIND], f[:, F_DST_REG]
        self.sk, self.sr = f[:, F_SRC_KIND], f[:, F_SRC_REG]
        self.breg, self.ireg = f[:, F_BASE_REG], f[:, F_IDX_REG]
        self.scale, self.seg, self.a32 = f[:, F_SCALE], f[:, F_SEG], \
            f[:, F_A32]
        self.rep = f[:, F_REP]
        self.pfn0, self.pfn1, self.bp = f[:, M_PFN0], f[:, M_PFN1], \
            f[:, M_BP]
        self.disp, self.imm = mu[:, MU_DISP], mu[:, MU_IMM]
        self.raw_lo, self.raw_hi = mu[:, MU_RAW_LO], mu[:, MU_RAW_HI]
        self.srcsize = torch.where(self.srcsize0 == 0, self.opsize,
                                   self.srcsize0)
        self.group_bits = None      # filled by _opc_bits on first use

    def is_(self, opc: int) -> torch.Tensor:
        return self.opc == opc

    def hot(self) -> torch.Tensor:
        out = torch.zeros_like(self.opc, dtype=torch.bool)
        for opc in HOT_OPCS:
            out |= self.opc == opc
        return out


def probe(tab: UopTable, image: MemImage, m: Machine):
    """Decode-cache probe of every lane's rip under its tenant tag ->
    (entry index or -1, the clamped index, its Decoded fields)."""
    key = m.rip if image.tenant is None else \
        m.rip ^ (image.tenant.long() << 48)
    idx = uop_lookup(tab, key)
    idxc = idx.clamp(min=0)
    return idx, idxc, Decoded(tab, idxc)


def address(d: Decoded, gpr, fs, gs, rip):
    """(fall-through rip, effective address) of every lane's uop."""
    next_rip = rip + d.length
    base_val = torch.where(d.breg == U.REG_RIP, next_rip, read64(gpr, d.breg))
    idx_val = scale_idx(read64(gpr, d.ireg), d.scale)
    seg = torch.where(d.seg == U.SEG_FS, fs, torch.where(
        d.seg == U.SEG_GS, gs, torch.zeros_like(fs)))
    ea = effective_address(d.disp, base_val, idx_val, seg, d.a32)
    return next_rip, ea


def values(d: Decoded, gpr, l1_lo, l2_lo):
    """(source, destination) operand values at the operand width."""
    zero = torch.zeros_like(l1_lo)
    src_raw = torch.where(d.sk == U.K_REG, read_reg(gpr, d.sr, d.srcsize),
                          torch.where(d.sk == U.K_MEM,
                                      I.zext(l1_lo, d.srcsize), zero))
    src_ext = torch.where(d.sext == 1,
                          I.zext(I.sext(src_raw, d.srcsize), d.opsize),
                          I.zext(src_raw, d.opsize))
    src_val = torch.where(d.sk == U.K_IMM, I.zext(d.imm, d.opsize), src_ext)
    dst_val = torch.where(d.dk == U.K_REG, read_reg(gpr, d.dr, d.opsize),
                          torch.where(d.dk == U.K_MEM,
                                      I.zext(l2_lo, d.opsize), zero))
    return src_val, dst_val


def execute(d: Decoded, gpr, rf, src_val, dst_val):
    """The integer classes of one instruction per lane."""
    cf_in = (rf & I.CF) != 0
    alu_r, alu_rf, alu_writes = alu(d.sub, dst_val, src_val, cf_in,
                                    d.opsize, rf)
    un_r, un_rf = unary(d.sub, dst_val, cf_in, d.opsize, rf)
    sh_r, sh_rf, sh_writes = shift(
        d.sub, d.sext, dst_val, read_reg(gpr, d.sr, d.opsize), gpr[:, 1],
        src_val, d.imm, cf_in, d.opsize, rf)
    mul_r1, mul_r2, mul_rf = mul(
        d.sub, d.sext, dst_val, src_val,
        read_reg(gpr, torch.zeros_like(d.sr), d.opsize), d.imm, d.opsize,
        rf)
    cc = I.eval_cond(rf, gpr[:, 1], d.cond)
    return dict(alu_r=alu_r, alu_rf=alu_rf, alu_writes=alu_writes,
                un_r=un_r, un_rf=un_rf, sh_r=sh_r, sh_rf=sh_rf,
                sh_writes=sh_writes, mul_r1=mul_r1, mul_r2=mul_r2,
                mul_rf=mul_rf, cc=cc)


def _bit_or(bitmap: torch.Tensor, word: torch.Tensor, bit: torch.Tensor,
            cond: torch.Tensor) -> torch.Tensor:
    """bitmap[lane, word] |= (1 << bit) where cond (int32 words)."""
    one = torch.ones_like(bit, dtype=torch.int32)
    val = torch.where(cond, one << bit.to(torch.int32), one - 1)
    w = word.long()[:, None]
    old = torch.gather(bitmap, 1, w)
    return bitmap.scatter(1, w, old | val[:, None])


_DF, _TF, _IF = 0x400, 0x100, 0x200

# The opclass table of `scan`: one int64 of group bits per opclass.
_GROUP_BITS = {name: 1 << i for i, name in enumerate(sorted(ALL_GROUPS))}
_ORACLE_BIT = 1 << len(_GROUP_BITS)
_RUN_BIT = _ORACLE_BIT << 1
_N_OPC = 64
_TABLES: dict = {}


def _opc_table(device):
    """(group bits per opclass, the powers of two `scan` reduces over)."""
    key = str(device)
    if key not in _TABLES:
        bits = [0] * _N_OPC
        for group, names in GROUPS.items():
            for name in names:
                bits[getattr(U, f"OPC_{name}")] |= _GROUP_BITS[group]
        for name in ROLES:
            bits[getattr(U, f"OPC_{name}")] |= _GROUP_BITS["roles"]
        for name in ORACLE_OPCLASSES:
            bits[getattr(U, f"OPC_{name}")] |= _ORACLE_BIT
        pow2 = [1 << i for i in range(_RUN_BIT.bit_length())]
        _TABLES[key] = (torch.tensor(bits, dtype=_I64, device=device),
                        torch.tensor(pow2, dtype=_I64, device=device))
    return _TABLES[key]


def _opc_bits(d: Decoded) -> torch.Tensor:
    """Each lane's group bits (kept on `d`: scan and step both read them)."""
    if d.group_bits is None:
        d.group_bits = _opc_table(d.opc.device)[0][d.opc.clamp(0, _N_OPC - 1)]
    return d.group_bits


def scan(tab: UopTable, image: MemImage, m: Machine):
    """The probe of the next step and its one host read -> (probe, whether
    any lane is RUNNING, the groups the step must compute: those of the
    running lanes' opclasses, and "roles" if any lane sits at one)."""
    pre = probe(tab, image, m)
    idx, _, d = pre
    bits = _opc_bits(d)
    run = m.status == _RUNNING
    word = (bits & torch.where(run & (idx >= 0), -1, _GROUP_BITS["roles"])) \
        | torch.where(run, _RUN_BIT, 0)
    flags = ((word[:, None] & _opc_table(d.opc.device)[1]) != 0).any(0)
    flags = flags.tolist()
    groups = frozenset(name for name, bit in _GROUP_BITS.items()
                       if flags[bit.bit_length() - 1])
    return pre, flags[_RUN_BIT.bit_length() - 1], groups


def _route(rows, default_idx, default_size, false, zero):
    """One register-write route of the JAX step (its w1/w2 select chains)
    from rows (class, cond, idx, val, size); None takes the default."""
    cls = [r[0] for r in rows]

    def pick(k, default):
        keep = [(c, r[k]) for c, r in zip(cls, rows) if r[k] is not None]
        return _sel([c for c, _ in keep], [v for _, v in keep], default)

    return (pick(1, false), pick(2, default_idx), pick(3, zero),
            pick(4, default_size))


def step(tab: UopTable, image: MemImage, m: Machine, limit: int,
         pre=None, groups=ALL_GROUPS) -> None:
    """Advance every RUNNING lane by one instruction, in place.  `pre` is
    this step's probe and `groups` what it computes (`scan` gives both);
    by default it probes and computes every group."""
    S = StatusCode
    image = lane_image(image, m.n_lanes)
    gpr, rip, rf = m.gpr, m.rip, m.rflags
    enabled = m.status == _RUNNING
    idx, idxc, d = probe(tab, image, m) if pre is None else pre
    g_div, g_bits, g_str, g_stack, g_sys, g_sse, g_fp, g_x87 = (
        name in groups for name in ("div", "bits", "string", "stack", "sys",
                                    "sse", "ssefp", "x87"))
    g_roles = "roles" in groups or g_str or g_stack or g_x87
    miss = enabled & (idx < 0)
    at_bp = enabled & ~miss & (d.bp == 1) & (m.bp_skip == 0)
    pre_live = enabled & ~miss & ~at_bp
    false = torch.zeros_like(enabled)
    true = ~false
    zero = torch.zeros_like(rip)
    is_ = d.is_
    opsize, sub = d.opsize, d.sub
    opmask = I.size_mask(opsize)
    bits = opsize * 8
    dk_reg = d.dk == U.K_REG

    def full(v):
        return torch.full_like(d.opc, v)

    is_push, is_pop = is_(U.OPC_PUSH), is_(U.OPC_POP)
    is_call, is_ret = is_(U.OPC_CALL), is_(U.OPC_RET)
    is_mul = is_(U.OPC_MUL)
    is_mul2 = sub == U.MUL_2OP
    rax, rcx, rdx = gpr[:, 0], gpr[:, 1], gpr[:, 2]
    rsp, rbp, rsi, rdi = gpr[:, 4], gpr[:, 5], gpr[:, 6], gpr[:, 7]
    rax_op = I.zext(rax, opsize)

    # -- what the oracle executes (the JAX step's `unsupported` set) --------
    unsup = (_opc_bits(d) & _ORACLE_BIT) != 0
    if g_div:
        is_div = is_(U.OPC_DIV)
        # a 128-bit dividend: rdx is not the zero / sign extension of rax
        div64_hard = is_div & (opsize >= 8) & ~torch.where(
            sub == U.DIV_U, rdx == 0, rdx == (rax >> 63))
        unsup = unsup | div64_hard
    if g_sys:
        msr_id = rcx & _LOW32
        msr_known = false
        for mid in MSR_ATTR:
            msr_known = msr_known | (msr_id == mid)
        is_movcr = is_(U.OPC_MOVCR)
        is_fsgs = is_(U.OPC_RDGSBASE)
        movcr_bad = is_movcr & ~((sub == 0) | (sub == 3) | (sub == 4)
                                 | (sub == 8) | ((d.sext == 0) & (sub == 2)))
        fsgs_val = read_reg(gpr, d.dr, opsize)
        unsup = (unsup | (is_(U.OPC_MSR) & ~msr_known) | movcr_bad
                 | (is_fsgs & ((sub == 2) | (sub == 3))
                    & ~canonical(fsgs_val)))
    if g_roles:
        is_string = is_(U.OPC_STRING)
        s_movs, s_stos, s_lods, s_scas, s_cmps = (
            is_string & (sub == k) for k in (
                U.STR_MOVS, U.STR_STOS, U.STR_LODS, U.STR_SCAS, U.STR_CMPS))
        rep_on = is_string & (d.rep != U.REP_NONE)
        rep_skip = rep_on & (rcx == 0)     # rep with rcx = 0: a no-op
        is_leave = is_(U.OPC_LEAVE) & (sub == 0)
        is_enter = is_(U.OPC_LEAVE) & (sub == 1)
        is_pushf, is_popf = is_(U.OPC_PUSHF), is_(U.OPC_POPF)
        # 67h string forms use 32-bit rsi/rdi/rcx, which neither engine
        # models
        unsup = unsup | (is_string & (d.a32 != 0))
        # x87 stores write [mem] at their operand width without reading it
        # (their fault is the store's, a WRITE)
        is_x87 = is_(U.OPC_X87)
        x87_store = is_x87 & (
            (sub == U.X87_FST_M) | (sub == U.X87_FIST)
            | (sub == U.X87_FIST_T) | (sub == U.X87_FNSTCW)
            | (sub == U.X87_FNSTSW_M) | (sub == U.X87_STMXCSR))
    else:
        is_string = s_movs = s_stos = s_lods = s_scas = s_cmps = rep_on = \
            rep_skip = is_leave = is_enter = is_pushf = is_popf = is_x87 = \
            x87_store = false
    if g_sse:
        is_ssemov, is_ssealu = is_(U.OPC_SSEMOV), is_(U.OPC_SSEALU)
        is_sse = is_ssemov | is_ssealu
        # pinsrw m16: a 2-byte load outside the 16-byte operand window
        unsup = unsup | (is_ssealu & (sub == U.SSE_PINSRW)
                         & (d.sk == U.K_MEM))
    if g_x87:
        # the FXSAVE-class state movers (512+ byte images)
        x87_oracle = is_x87 & (
            (sub == U.X87_FXSAVE) | (sub == U.X87_FXRSTOR)
            | (sub == U.X87_XSAVE) | (sub == U.X87_XRSTOR))
        unsup = unsup | x87_oracle
    unsupported = pre_live & unsup
    ok_path = pre_live & ~unsupported

    next_rip, ea = address(d, gpr, m.fs_base, m.gs_base, rip)
    if g_roles or g_bits:
        # BT bit strings: a register bit index moves the EA by opsize for
        # every `bits` of signed offset
        bt_signed = I.sext(read_reg(gpr, d.sr, opsize), opsize)
        log2bits = torch.where(opsize >= 8, 6, torch.where(opsize == 4, 5, 4))
        bt_mem_reg = is_(U.OPC_BT) & (d.dk == U.K_MEM) & (d.sk == U.K_REG)
        ea = torch.where(bt_mem_reg, ea + (bt_signed >> log2bits) * opsize,
                         ea)
    code_off = rip & 0xFFF
    code_crosses = (code_off + 16) > 4096
    gpa_c0 = (d.pfn0 << 12) + code_off
    gpa_c15 = torch.where(code_crosses,
                          (d.pfn1 << 12) + (code_off + 15 - 4096),
                          gpa_c0 + 15)

    # -- memory roles ------------------------------------------------------
    stack_pop = is_pop | is_popf | is_ret
    l1_need = ok_path & ~rep_skip & (
        ((d.sk == U.K_MEM) & ~x87_store) | stack_pop | is_leave | s_movs
        | s_lods | s_cmps | s_scas)
    l1_addr = _sel([s_movs | s_lods | s_cmps, s_scas, stack_pop, is_leave],
                   [rsi, rdi, rsp, rbp], ea) if g_roles \
        else torch.where(is_pop | is_ret, rsp, ea)
    l1_size = torch.where(is_popf | is_ret | is_leave, 8, torch.where(
        is_pop | is_string, opsize, d.srcsize))
    # store-only destinations write [mem] without reading it: their fault
    # is the store's (a WRITE); SSE reads only its source
    store_only = is_(U.OPC_MOV) | is_(U.OPC_SETCC) | is_pop
    if g_sse:
        l1_size = torch.where(is_sse, opsize, l1_size)
        store_only = store_only | is_sse
    if g_fp:
        is_ssefp = is_(U.OPC_SSEFP)
        l1_size = torch.where(is_ssefp, F.fp_ldsize(d), l1_size)
    l2_need = ok_path & ~rep_skip & (((d.dk == U.K_MEM) & ~store_only)
                                     | s_cmps)
    l2_addr = torch.where(s_cmps, rdi, ea) if g_roles else ea
    push_size = torch.where(is_pushf | is_call, 8, opsize)
    st_addr = _sel([is_push | is_pushf | is_call, is_enter, s_movs | s_stos],
                   [rsp - push_size, rsp - 8, rdi], ea) if g_roles \
        else torch.where(is_push | is_call, rsp - push_size, ea)
    st_size = torch.where(x87_store, d.srcsize, push_size) if g_roles \
        else push_size

    gva6 = torch.stack([l1_addr, l1_addr + l1_size - 1, l2_addr,
                        l2_addr + opsize - 1, st_addr, st_addr + st_size - 1],
                       dim=1)
    t6 = translate(image, m.overlay, m.cr3, gva6)
    fault1 = l1_need & ~(t6.ok[:, 0] & t6.ok[:, 1])
    fault2 = l2_need & ~(t6.ok[:, 2] & t6.ok[:, 3])

    wf = torch.stack([gpa_c0, t6.gpa[:, 0], t6.gpa[:, 2]], dim=1)
    wl = torch.stack([gpa_c15, t6.gpa[:, 1], t6.gpa[:, 3]], dim=1)
    w0, w1, w2 = load_windows3(image, m.overlay, wf, wl)
    lo3, hi3 = extract_pair(w0, w1, w2, wf)
    code_lo, code_hi = lo3[:, 0], hi3[:, 0]
    l1_lo, l1_hi, l2_lo = lo3[:, 1], hi3[:, 1], lo3[:, 2]

    lmask_lo = I.size_mask(d.length.clamp(max=8))
    lmask_hi = torch.where(d.length > 8, I.size_mask(d.length - 8),
                           torch.zeros_like(d.length))
    smc = pre_live & ((((code_lo ^ d.raw_lo) & lmask_lo) != 0)
                      | (((code_hi ^ d.raw_hi) & lmask_hi) != 0))
    live = pre_live & ~smc
    is_crash = live & (is_(U.OPC_INT) | is_(U.OPC_HLT) | is_(U.OPC_INT1)) \
        if g_sys else false

    # -- execute -----------------------------------------------------------
    src_val, dst_val = values(d, gpr, l1_lo, l2_lo)
    x = execute(d, gpr, rf, src_val, dst_val)
    cc = x["cc"]
    cc01 = cc.to(_I64)
    jcc_target = next_rip + d.imm
    jmp_target = torch.where(d.sk == U.K_IMM, jcc_target, src_val)
    pop_val = l1_lo & opmask
    is_mov, is_lea = is_(U.OPC_MOV), is_(U.OPC_LEA)
    is_alu, is_shift = is_(U.OPC_ALU), is_(U.OPC_SHIFT)
    is_unary, is_setcc = is_(U.OPC_UNARY), is_(U.OPC_SETCC)

    # register-write routes (class, cond, idx, val, size) and the class
    # chains of rflags, rip, the memory store
    w1 = [(is_mov, dk_reg, None, src_val, None),
          (is_lea, true, None, ea, None),
          (is_alu, x["alu_writes"] & dk_reg, None, x["alu_r"], None),
          (is_shift, x["sh_writes"] & dk_reg, None, x["sh_r"], None),
          (is_unary, dk_reg, None, x["un_r"], None),
          (is_mul, true, torch.where(is_mul2, d.dr, 0), x["mul_r1"],
           torch.where(is_mul2, opsize, torch.where(opsize == 1, 2,
                                                    opsize))),
          (is_pop, dk_reg, None, pop_val, None),
          (is_setcc, dk_reg, None, cc01, None),
          (is_(U.OPC_CMOVCC), true, None,
           torch.where(cc, src_val, dst_val), None)]
    w2 = [(is_mul, ~is_mul2 & (opsize > 1), None, x["mul_r2"], None)]
    rf_rows = [(is_alu, x["alu_rf"]), (is_unary, x["un_rf"]),
               (is_shift, x["sh_rf"]), (is_mul, x["mul_rf"])]
    rip_rows = [(is_(U.OPC_JMP) | is_call, jmp_target),
                (is_(U.OPC_JCC), torch.where(cc, jcc_target, next_rip)),
                (is_ret, l1_lo)]
    st_writes = [(is_mov, true), (is_alu, x["alu_writes"]),
                 (is_shift, x["sh_writes"]), (is_unary | is_setcc | is_pop,
                                              true)]
    st_rows = [(is_mov | is_push, src_val), (is_alu, x["alu_r"]),
               (is_shift, x["sh_r"]), (is_unary, x["un_r"]),
               (is_setcc, cc01), (is_pop, pop_val), (is_call, next_rip)]
    de = false

    if g_div:
        div_q, div_rem, div_fault = div(sub, rax_op, I.zext(rdx, opsize),
                                        rax & 0xFFFF, src_val, opsize)
        de = live & is_div & ~div64_hard & div_fault
        w1.append((is_div, true, 0, div_q, None))
        w2.append((is_div, true, torch.where(opsize == 1, U.REG_AH_BASE, 2),
                   div_rem, torch.where(opsize == 1, 1, opsize)))

    if g_bits:
        is_bt, is_bs = is_(U.OPC_BT), is_(U.OPC_BITSCAN)
        is_cvt, is_bsw = is_(U.OPC_CONVERT), is_(U.OPC_BSWAP)
        is_cx, is_xadd = is_(U.OPC_CMPXCHG), is_(U.OPC_XADD)
        is_xchg, is_bmi = is_(U.OPC_XCHG), is_(U.OPC_PEXT)
        half = (opsize // 2).clamp(min=1)
        cvt_widen = I.sext(rax_op & I.size_mask(half), half) & opmask
        cvt_sign = torch.where(I.msb(rax_op, opsize), opmask, 0)
        bt_off = torch.where(d.sk == U.K_IMM, d.imm, bt_signed) & (bits - 1)
        bt_r, bt_rf, bt_writes = bt(sub, dst_val, bt_off, rf)
        bs_r, bs_rf, bs_writes = bitscan(sub, src_val, opsize, rf)
        bmi_r, bmi_rf = bmi(sub, src_val, read_reg(gpr, d.cond, opsize),
                            d.imm, opsize, rf)
        src_reg = read_reg(gpr, d.sr, opsize)
        cx_eq = rax_op == dst_val
        cx_store = torch.where(cx_eq, src_reg, dst_val)
        cx_rf = (rf & ~I.FLAGS_ARITH) | I.flags_sub(
            rax_op, dst_val, (rax_op - dst_val) & opmask, opsize, false)
        xadd_r = (dst_val + src_reg) & opmask
        xadd_rf = (rf & ~I.FLAGS_ARITH) | I.flags_add(
            dst_val, src_reg, xadd_r, opsize, false)
        w1 += [(is_bt, bt_writes & dk_reg, None, bt_r, None),
               (is_bs, bs_writes, None, bs_r, None),
               (is_cvt, true, torch.where(sub == 0, 0, 2),
                torch.where(sub == 0, cvt_widen, cvt_sign), None),
               (is_bsw, true, None, I.bswap(dst_val & opmask, opsize), None),
               (is_cx, dk_reg, None, cx_store, None),
               (is_xadd, dk_reg, None, xadd_r, None),
               (is_xchg, dk_reg, None, src_val, None),
               (is_bmi, true, None, bmi_r, None)]
        w2 += [(is_xchg, d.sk == U.K_REG, d.sr, dst_val, None),
               (is_cx, ~cx_eq, 0, dst_val, None),
               (is_xadd, true, d.sr, dst_val, None)]
        rf_rows += [(is_bt, bt_rf), (is_bs, bs_rf), (is_cx, cx_rf),
                    (is_xadd, xadd_rf), (is_bmi, bmi_rf)]
        st_writes += [(is_cx | is_xadd | is_xchg, true), (is_bt, bt_writes)]
        st_rows += [(is_bt, bt_r), (is_cx, cx_store), (is_xadd, xadd_r),
                    (is_xchg, src_val)]

    if g_str:
        str_delta = torch.where((rf & _DF) != 0, -opsize, opsize)
        str_a = torch.where(s_cmps, l1_lo & opmask, rax_op)
        str_b = torch.where(s_cmps, l2_lo, l1_lo) & opmask
        str_r = (str_a - str_b) & opmask
        str_rf = (rf & ~I.FLAGS_ARITH) | I.flags_sub(str_a, str_b, str_r,
                                                     opsize, false)
        cc_done = (s_scas | s_cmps) & torch.where(
            d.rep == U.REP_REP, str_r != 0, str_r == 0)
        str_done = torch.where(rep_on, rep_skip | (rcx == 1) | cc_done, true)
        w1.append((is_string, s_lods & ~rep_skip, 0, l1_lo & opmask, None))
        rf_rows.append((is_string, torch.where(
            (s_scas | s_cmps) & ~rep_skip, str_rf, rf)))
        rip_rows.append((is_string, torch.where(str_done, next_rip, rip)))
        st_rows += [(s_stos, rax_op), (s_movs, l1_lo)]

    if g_stack:
        is_flagop = is_(U.OPC_FLAGOP)
        ah = (rax >> 8) & 0xFF
        flagop_rf = _sel(
            [sub == k for k in (U.FL_CLC, U.FL_STC, U.FL_CMC, U.FL_CLD,
                                U.FL_STD, U.FL_CLI, U.FL_STI, U.FL_SAHF)],
            [rf & ~I.CF, rf | I.CF, rf ^ I.CF, rf & ~_DF, rf | _DF,
             rf & ~_IF, rf | _IF, (rf & ~0xD5) | (ah & 0xD5) | 0x2], rf)
        w1 += [(is_flagop, sub == U.FL_LAHF, U.REG_AH_BASE,
                (rf & 0xD7) | 0x2, 1),
               (is_leave | is_enter, true, 5,
                torch.where(is_leave, l1_lo, rsp - 8), 8)]
        rf_rows += [(is_flagop, flagop_rf),
                    (is_popf, (l1_lo & 0x40FD5) | 0x2)]
        st_rows += [(is_pushf, rf | 0x2), (is_enter, rbp)]

    if g_sys:
        is_sysc = is_(U.OPC_SYSCALL)
        is_rdtsc, is_rdrand = is_(U.OPC_RDTSC), is_(U.OPC_RDRAND)
        is_xgetbv, is_msr = is_(U.OPC_XGETBV), is_(U.OPC_MSR)
        syscall_entry = sub == 0
        tsc_now = m.tsc + m.icount
        rdrand_next = I.splitmix64(m.rdrand)
        cr_read = _sel([sub == 0, sub == 2, sub == 3, sub == 4, sub == 8],
                       [m.cr0, m.cr2, m.cr3, m.cr4, m.cr8], zero)
        movcr_is_write = is_movcr & (d.sext != 0)
        msr_rval = _sel([msr_id == mid for mid in MSR_ATTR],
                        [tsc_now if attr == "tsc" else getattr(m, attr)
                         for attr in MSR_ATTR.values()], zero)
        msr_wval = ((rdx & _LOW32) << 32) | (rax & _LOW32)
        w1 += [(is_rdtsc, true, 0, tsc_now & _LOW32, 8),
               (is_rdrand, true, None, rdrand_next & opmask, None),
               (is_xgetbv, true, 0, 7, 4),
               (is_sysc, syscall_entry, 11, rf & ~0x10000, 8),
               (is_movcr, ~movcr_is_write, None, cr_read, 8),
               (is_msr, sub == 0, 0, msr_rval & _LOW32, 8),
               (is_fsgs, (sub == 0) | (sub == 1), None,
                torch.where(sub == 0, m.fs_base, m.gs_base), None)]
        w2 += [(is_rdtsc, true, 2, I.shr(tsc_now, 32), 8),
               (is_xgetbv, true, 2, 0, 4),
               (is_sysc, syscall_entry, 1, next_rip, 8),
               (is_msr, sub == 0, 2, I.shr(msr_rval, 32), 8)]
        rf_rows += [
            (is_rdrand, (rf & ~I.FLAGS_ARITH) | I.CF),
            (is_sysc, torch.where(
                syscall_entry, (rf & ~(m.sfmask | _TF)) | 0x2,
                (gpr[:, 11] & U.RF_WRITABLE) | 0x2))]
        rip_rows.append((is_sysc, torch.where(syscall_entry, m.lstar, rcx)))

    # the xmm write (cond, lo, hi) of each class; the FP divert
    wx_rows, fp_denorm = [], false
    if g_sse or g_fp:
        lanes = torch.arange(m.n_lanes, device=rip.device)
        xr = d.dr.clamp(0, 15)
        x_dst = m.xmm[lanes, xr]
        x_sreg = m.xmm[lanes, d.sr.clamp(0, 15)]
        k_xmm = d.sk == U.K_XMM
        x_src_lo = torch.where(k_xmm, x_sreg[:, 0], l1_lo)
        x_src_hi = torch.where(k_xmm, x_sreg[:, 1], l1_hi)
        gpr_src = read_reg(gpr, d.sr, opsize)
    if g_sse:
        v = F.sse(d, rf, x_dst[:, 0], x_dst[:, 1], x_src_lo, x_src_hi,
                  x_sreg[:, 0], x_sreg[:, 1], l1_lo, gpr_src,
                  read_reg(gpr, d.sr, full(2)))
        ssealu_gpr = (sub == U.SSE_PMOVMSKB) | (sub == U.SSE_PEXTRW)
        w1 += [(is_ssemov, (sub == 2) & dk_reg, None, x_sreg[:, 0], None),
               (is_ssealu, ssealu_gpr, None, v["gpr"], 4)]
        rf_rows.append((is_ssealu & (sub == U.SSE_PTEST), v["ptest_rf"]))
        st_writes.append((is_ssemov, true))
        # movhps to memory (sub 5) stores the high limb
        st_rows.append((is_ssemov, torch.where(sub == 5, x_sreg[:, 1],
                                               x_sreg[:, 0])))
        wx_rows += [(is_ssemov & (sub != 2) & (d.dk == U.K_XMM),
                     v["mov_lo"], v["mov_hi"]),
                    (is_ssealu & ~ssealu_gpr & (sub != U.SSE_PTEST),
                     v["alu_lo"], v["alu_hi"])]
    if g_fp:
        v = F.ssefp(d, rf, x_dst[:, 0], x_dst[:, 1], x_src_lo, x_src_hi,
                    l1_lo, gpr_src)
        w1.append((is_ssefp, v["is_f2i"], None, v["f2i"], None))
        rf_rows.append((is_ssefp & v["is_comi"], v["ucomi_rf"]))
        wx_rows.append((is_ssefp & v["writes_xmm"], v["lo"], v["hi"]))
        fp_denorm = is_ssefp & v["denorm"]
    if g_x87:
        x87v = F.x87(d, rf, m.fpst, m.fpcw, m.fpsw, m.fptw, m.mxcsr, l1_lo)
        w1.append((is_x87, sub == U.X87_FNSTSW_AX, None, m.fpsw & 0xFFFF,
                   2))
        rf_rows.append((is_x87 & (sub == U.X87_COMI), x87v["comi_rf"]))
        st_rows.append((is_x87, x87v["store"]))
        fp_denorm = fp_denorm | (is_x87 & ~x87_oracle & x87v["denorm"])

    # -- the memory store --------------------------------------------------
    mem_class_writes = _sel([c for c, _ in st_writes],
                            [v for _, v in st_writes], false)
    st_need = live & ~unsupported & ~rep_skip & (
        ((d.dk == U.K_MEM) & mem_class_writes) | is_push | is_pushf
        | is_call | is_enter | s_movs | s_stos | x87_store)
    st_lo = _sel([c for c, _ in st_rows], [v for _, v in st_rows], zero)
    st_hi = torch.where(s_movs, l1_hi, zero) if g_str else zero
    if g_sse:
        st_hi = torch.where(is_ssemov, x_sreg[:, 1], st_hi)
    ts_ok0 = t6.ok[:, 4] & t6.writable[:, 4]
    store_fault = st_need & ~(ts_ok0 & t6.ok[:, 5] & t6.writable[:, 5])
    page_fault = live & ~unsupported & ~is_crash & (fault1 | fault2
                                                    | store_fault)
    # FP lanes that touch the denormal range go to the oracle
    fp_oracle = live & ~unsupported & ~page_fault & fp_denorm
    commit_pre = live & ~unsupported & ~is_crash & ~de & ~page_fault \
        & ~fp_oracle
    store_ok = store_window3(image, m.overlay, t6.gpa[:, 4], t6.gpa[:, 5],
                             st_size, st_lo, st_hi, st_need & commit_pre)
    ovf = st_need & commit_pre & ~store_ok
    commit = commit_pre & ~ovf

    # -- register file, in the JAX step's order: rsp/rsi/rdi/rcx, aux,
    # primary, CPUID's four rows -------------------------------------------
    w3_cond = is_push | is_pushf | is_call | is_pop | stack_pop | is_leave \
        | is_enter
    w3_val = _sel([is_push | is_pushf | is_call, is_pop, is_popf, is_ret,
                   is_leave, is_enter],
                  [rsp - push_size, rsp + opsize, rsp + 8, rsp + 8 + d.imm,
                   rbp + 8, rsp - 8 - d.imm], rsp)
    new_gpr = gpr_write(gpr, commit & w3_cond, full(4), w3_val, 8)
    if g_str:
        ptr = commit & ~rep_skip
        new_gpr[:, 6] = torch.where(ptr & (s_movs | s_lods | s_cmps),
                                    rsi + str_delta, new_gpr[:, 6])
        new_gpr[:, 7] = torch.where(ptr & (s_movs | s_stos | s_scas | s_cmps),
                                    rdi + str_delta, new_gpr[:, 7])
        new_gpr[:, 1] = torch.where(ptr & rep_on, rcx - 1, new_gpr[:, 1])
    for rows, default in ((w2, full(2)), (w1, d.dr)):
        cond, widx, wval, wsize = _route(rows, default, opsize, false, zero)
        new_gpr = gpr_write(new_gpr, commit & cond, widx, wval, wsize)
    if g_sys:
        cpw = commit & is_(U.OPC_CPUID)
        cp = cpuid(rax, rcx)
        for ridx, col in ((0, 0), (3, 1), (1, 2), (2, 3)):
            new_gpr[:, ridx] = torch.where(cpw, cp[:, col], new_gpr[:, ridx])

    rf_exec = _sel([c for c, _ in rf_rows], [v for _, v in rf_rows], rf)
    new_rf = torch.where(commit, rf_exec | 0x2, rf)
    rip_exec = _sel([c for c, _ in rip_rows], [v for _, v in rip_rows],
                    next_rip)
    new_rip = torch.where(commit, rip_exec, rip)

    new_icount = m.icount + commit.to(_I64)
    ctr = m.ctr.clone()
    ctr[:, CTR_INSTR] += commit.to(torch.int32)
    ctr[:, CTR_MEM_FAULT] += page_fault.to(torch.int32)
    ctr[:, CTR_DECODE_MISS] += miss.to(torch.int32)
    timed = commit & (limit != 0) & ~I.ltu(
        new_icount, torch.full_like(new_icount, I.s64(limit)))

    cov = _bit_or(m.cov, idxc >> 5, idxc & 31, live)
    is_branch = (is_(U.OPC_JMP) | is_(U.OPC_JCC) | is_call | is_ret)
    ebits = m.edge.shape[1] * 32
    ei = (I.mix64(rip) ^ rip_exec) & (ebits - 1)
    edge = _bit_or(m.edge, ei >> 5, ei & 31, commit & is_branch)

    # -- control registers, gs bases, MSRs, selectors, rdrand --------------
    cr3_changed = false
    if g_sys:
        cr_w = commit & movcr_is_write
        cr_wval = _gather(gpr, d.sr)
        for k in (0, 3, 4, 8):
            name = f"cr{k}"
            setattr(m, name, torch.where(cr_w & (sub == k), cr_wval,
                                         getattr(m, name)))
        cr3_changed = cr_w & (sub == 3) & (cr_wval != m.cr3_base)
        sw = commit & is_fsgs & (sub == 4)
        fsgsw = commit & is_fsgs
        msrw = commit & is_msr & (sub == 1)
        state = {"gs_base": torch.where(fsgsw & (sub == 3), fsgs_val,
                                        torch.where(sw, m.kernel_gs_base,
                                                    m.gs_base)),
                 "kernel_gs_base": torch.where(sw, m.gs_base,
                                               m.kernel_gs_base),
                 "fs_base": torch.where(fsgsw & (sub == 2), fsgs_val,
                                        m.fs_base)}
        for mid, attr in MSR_ATTR.items():
            base = state.get(attr, getattr(m, attr))
            val = msr_wval - m.icount if attr == "tsc" else msr_wval
            state[attr] = torch.where(msrw & (msr_id == mid), val, base)
        sysc = commit & is_sysc
        star_k = I.shr(m.star, 32) & 0xFFFC
        star_u = I.shr(m.star, 48) & 0xFFFF
        m.cs = torch.where(sysc, torch.where(
            syscall_entry, star_k, (star_u + 16) | 3), m.cs)
        m.ss = torch.where(sysc, torch.where(
            syscall_entry, star_k + 8, (star_u + 8) | 3), m.ss)
        m.rdrand = torch.where(commit & is_rdrand, rdrand_next, m.rdrand)
        for attr, value in state.items():
            setattr(m, attr, value)

    chain = _sel([miss, at_bp, smc, unsupported, page_fault, fp_oracle, de,
                  is_crash, ovf, cr3_changed, timed],
                 [int(s) for s in (
                     S.NEED_DECODE, S.BREAKPOINT, S.SMC, S.UNSUPPORTED,
                     S.PAGE_FAULT, S.UNSUPPORTED, S.DIVIDE_ERROR, S.CRASH,
                     S.OVERLAY_FULL, S.CR3_CHANGE, S.TIMEDOUT)],
                 torch.full_like(m.status, _RUNNING))
    fault_gva = torch.where(
        enabled & page_fault,
        torch.where(fault1, fault_at(l1_addr, t6.ok[:, 0]),
                    torch.where(fault2, fault_at(l2_addr, t6.ok[:, 2]),
                                fault_at(st_addr, ts_ok0))),
        torch.where(enabled & is_crash, rip, m.fault_gva))
    fault_write = torch.where(
        enabled & page_fault,
        (~fault1 & ~fault2).to(torch.int32), m.fault_write)

    # -- xmm and x87 state ---------------------------------------------------
    if wx_rows:
        conds = [c for c, _, _ in wx_rows]
        wx = false
        for c in conds:
            wx = wx | c
        wx = commit & wx
        new_x = x_dst.clone()
        new_x[:, 0] = torch.where(wx, _sel(conds, [r[1] for r in wx_rows],
                                           zero), x_dst[:, 0])
        new_x[:, 1] = torch.where(wx, _sel(conds, [r[2] for r in wx_rows],
                                           zero), x_dst[:, 1])
        m.xmm = m.xmm.index_put((lanes, xr), new_x)
    if g_sse:
        # vzeroall (sub 0) zeroes the whole file, vzeroupper (sub 1) the
        # upper YMM halves (limbs 2-3)
        vz = commit & is_(U.OPC_VZEROALL)
        limb = torch.arange(4, device=rip.device)
        vz_limbs = (vz & (sub == 0))[:, None] | (vz[:, None] & (limb >= 2))
        m.xmm = torch.where(vz_limbs[:, None, :], 0, m.xmm)
    if g_x87:
        x87c = commit & is_x87
        widx = x87v["w1_idx"][:, None]
        fpst = m.fpst.scatter(1, widx, torch.where(
            x87c & x87v["w1_en"], x87v["w1_val"],
            torch.gather(m.fpst, 1, widx)[:, 0])[:, None])
        phi = x87v["phi"][:, None]
        m.fpst = fpst.scatter(1, phi, torch.where(
            x87c & x87v["fxch"], x87v["st0"],
            torch.gather(fpst, 1, phi)[:, 0])[:, None])
        for name in ("fpcw", "fpsw", "fptw", "mxcsr"):
            setattr(m, name, torch.where(x87c, x87v[name], getattr(m, name)))

    m.gpr, m.rip, m.rflags = new_gpr, new_rip, new_rf
    m.status = torch.where(enabled, chain, m.status).to(torch.int32)
    m.icount = new_icount
    m.bp_skip = torch.where(commit, torch.zeros_like(m.bp_skip), m.bp_skip)
    m.fault_gva, m.fault_write = fault_gva, fault_write
    m.ctr, m.cov, m.edge = ctr, cov, edge


def run_steps(tab: UopTable, image: MemImage, m: Machine, limit: int,
              n_steps: int) -> int:
    """Up to n_steps steps, stopping early once no lane is RUNNING (the
    JAX make_run_chunk's while loop); each step computes only the groups
    `scan` finds.  Returns the steps taken."""
    for i in range(n_steps):
        pre, running, groups = scan(tab, image, m)
        if not running:
            return i
        step(tab, image, m, limit, pre, groups)
    return n_steps
