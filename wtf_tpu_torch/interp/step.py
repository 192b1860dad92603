"""The precise batched step: one instruction for every lane.

The counterpart of wtf_tpu/interp/step.py `step_lane`, written over the
lane axis directly.  This slice carries the plumbing of the JAX step and
the sixteen opclasses the fused kernel runs (`HOT_OPCLASSES`):

  1. decode-cache probe with the tenant-tagged key -> NEED_DECODE on miss
  2. breakpoint check honoring bp_skip               -> BREAKPOINT
  3. SMC check of the live code bytes against the decode-time raw bytes
     (through the lane overlay)                       -> SMC
  4. effective address, six page walks (first/last byte of the load, the
     read-modify operand and the store), the 3-word operand windows,
     PAGE_FAULT with the faulting address and access kind
  5. MOV/LEA/ALU/UNARY/SHIFT/MUL/SETCC/CMOVCC/JCC/JMP/PUSH/POP/CALL/RET/
     NOP/FENCE, the overlay store (OVERLAY_FULL when a lane is out of
     rows), register writes in the JAX step's order (rsp, aux, primary)
  6. icount and the instruction budget (TIMEDOUT), the coverage bit of the
     uop entry, the edge bit at mix64(rip) ^ target, the counter block

Every other opclass (`NOT_YET_PORTED`) leaves the lane UNSUPPORTED before
anything changes, exactly like the JAX step's own `unsupported` set: the
runner single-steps it on the host oracle (Runner._fallback_step).  The
architectural result is the same; only the engine that retires those
instructions differs, and the runner counts them apart.

The step mutates the machine in place (the overlay rows are written with
indexed assignment; the small register tensors are replaced).
"""

from __future__ import annotations

import torch

from wtf_tpu_torch.core.results import StatusCode
from wtf_tpu_torch.cpu import uops as U
from wtf_tpu_torch.interp import ints as I
from wtf_tpu_torch.interp.machine import (
    CTR_DECODE_MISS, CTR_INSTR, CTR_MEM_FAULT, Machine,
)
from wtf_tpu_torch.interp.uoptable import (
    F_A32, F_BASE_REG, F_COND, F_DST_KIND, F_DST_REG, F_IDX_REG, F_LENGTH,
    F_OPC, F_OPSIZE, F_SCALE, F_SEG, F_SEXT, F_SRCSIZE, F_SRC_KIND,
    F_SRC_REG, F_SUB, M_BP, M_PFN0, M_PFN1, MU_DISP, MU_IMM, MU_RAW_HI,
    MU_RAW_LO, UopTable, uop_lookup,
)
from wtf_tpu_torch.mem.overlay import (
    extract_pair, load_windows3, store_window3,
)
from wtf_tpu_torch.mem.paging import translate
from wtf_tpu_torch.mem.physmem import MemImage, lane_image

# The opclasses this slice executes on the device — the fused kernel's
# subset (wtf_tpu/interp/pstep.py FUSED_OPCLASSES).
HOT_OPCLASSES = frozenset({
    "NOP", "FENCE", "MOV", "LEA", "ALU", "UNARY", "SETCC", "CMOVCC",
    "JCC", "JMP", "SHIFT", "MUL", "PUSH", "POP", "CALL", "RET",
})
HOT_OPCS = frozenset(getattr(U, f"OPC_{name}") for name in HOT_OPCLASSES)

# Opclasses the JAX step executes on the device but this slice does not
# yet (ROADMAP step slices 5(b)-(d)): they surface as UNSUPPORTED and run
# on the host oracle.  OPC_INVALID, IRET, SSECVT, PCLMUL and STACKSTR are
# oracle-serviced in the JAX package too and are not listed.
NOT_YET_PORTED = frozenset({
    "DIV", "STRING", "XCHG", "CONVERT", "BT", "BITSCAN", "SYSCALL", "INT",
    "HLT", "RDTSC", "RDRAND", "CPUID", "LEAVE", "PUSHF", "POPF", "FLAGOP",
    "BSWAP", "CMPXCHG", "XADD", "SSEMOV", "SSEALU", "XGETBV", "RDGSBASE",
    "MOVCR", "INT1", "PEXT", "MSR", "VZEROALL", "SSEFP", "X87",
})

_RUNNING = int(StatusCode.RUNNING)
_I64 = torch.int64
_LOW32 = 0xFFFFFFFF


def _sel(conds, vals, default):
    """First-true select over [L] masks (jnp.select / limbs.select64)."""
    out = default
    for c, v in zip(reversed(conds), reversed(vals)):
        out = torch.where(c, v, out)
    return out


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
        self.pfn0, self.pfn1, self.bp = f[:, M_PFN0], f[:, M_PFN1], \
            f[:, M_BP]
        self.disp, self.imm = mu[:, MU_DISP], mu[:, MU_IMM]
        self.raw_lo, self.raw_hi = mu[:, MU_RAW_LO], mu[:, MU_RAW_HI]
        self.srcsize = torch.where(self.srcsize0 == 0, self.opsize,
                                   self.srcsize0)

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


def step(tab: UopTable, image: MemImage, m: Machine, limit: int) -> None:
    """Advance every RUNNING lane by one instruction, in place."""
    S = StatusCode
    image = lane_image(image, m.n_lanes)
    gpr, rip, rf = m.gpr, m.rip, m.rflags
    enabled = m.status == _RUNNING
    idx, idxc, d = probe(tab, image, m)
    miss = enabled & (idx < 0)
    at_bp = enabled & ~miss & (d.bp == 1) & (m.bp_skip == 0)
    pre_live = enabled & ~miss & ~at_bp
    is_push, is_pop = d.is_(U.OPC_PUSH), d.is_(U.OPC_POP)
    is_call, is_ret = d.is_(U.OPC_CALL), d.is_(U.OPC_RET)
    is_mul = d.is_(U.OPC_MUL)
    is_mul2 = d.sub == U.MUL_2OP
    unsupported = pre_live & ~d.hot()
    ok_path = pre_live & ~unsupported

    next_rip, ea = address(d, gpr, m.fs_base, m.gs_base, rip)
    rsp = gpr[:, 4]
    code_off = rip & 0xFFF
    code_crosses = (code_off + 16) > 4096
    gpa_c0 = (d.pfn0 << 12) + code_off
    gpa_c15 = torch.where(code_crosses,
                          (d.pfn1 << 12) + (code_off + 15 - 4096),
                          gpa_c0 + 15)

    l1_need = ok_path & ((d.sk == U.K_MEM) | is_pop | is_ret)
    l1_addr = torch.where(is_pop | is_ret, rsp, ea)
    l1_size = torch.where(is_ret, 8, torch.where(is_pop, d.opsize,
                                                 d.srcsize))
    store_only = d.is_(U.OPC_MOV) | d.is_(U.OPC_SETCC) | is_pop
    l2_need = ok_path & (d.dk == U.K_MEM) & ~store_only
    push_size = torch.where(is_call, 8, d.opsize)
    st_addr = torch.where(is_push | is_call, rsp - push_size, ea)
    st_size = push_size

    gva6 = torch.stack([l1_addr, l1_addr + l1_size - 1, ea,
                        ea + d.opsize - 1, st_addr, st_addr + st_size - 1],
                       dim=1)
    t6 = translate(image, m.overlay, m.cr3, gva6)
    fault1 = l1_need & ~(t6.ok[:, 0] & t6.ok[:, 1])
    fault2 = l2_need & ~(t6.ok[:, 2] & t6.ok[:, 3])

    wf = torch.stack([gpa_c0, t6.gpa[:, 0], t6.gpa[:, 2]], dim=1)
    wl = torch.stack([gpa_c15, t6.gpa[:, 1], t6.gpa[:, 3]], dim=1)
    w0, w1, w2 = load_windows3(image, m.overlay, wf, wl)
    lo3, hi3 = extract_pair(w0, w1, w2, wf)
    code_lo, code_hi = lo3[:, 0], hi3[:, 0]
    l1_lo, l2_lo = lo3[:, 1], lo3[:, 2]

    lmask_lo = I.size_mask(d.length.clamp(max=8))
    lmask_hi = torch.where(d.length > 8, I.size_mask(d.length - 8),
                           torch.zeros_like(d.length))
    smc = pre_live & ((((code_lo ^ d.raw_lo) & lmask_lo) != 0)
                      | (((code_hi ^ d.raw_hi) & lmask_hi) != 0))
    live = pre_live & ~smc

    src_val, dst_val = values(d, gpr, l1_lo, l2_lo)
    x = execute(d, gpr, rf, src_val, dst_val)
    cc = x["cc"]
    cc01 = cc.to(_I64)
    jcc_target = next_rip + d.imm
    jmp_target = torch.where(d.sk == U.K_IMM, jcc_target, src_val)
    opmask = I.size_mask(d.opsize)
    pop_val = l1_lo & opmask

    is_mov, is_lea = d.is_(U.OPC_MOV), d.is_(U.OPC_LEA)
    is_alu, is_shift = d.is_(U.OPC_ALU), d.is_(U.OPC_SHIFT)
    is_unary, is_setcc = d.is_(U.OPC_UNARY), d.is_(U.OPC_SETCC)
    is_cmov = d.is_(U.OPC_CMOVCC)
    dk_reg = d.dk == U.K_REG
    true = torch.ones_like(enabled)
    w1_cond = _sel(
        [is_mov, is_lea, is_alu, is_shift, is_unary, is_mul, is_pop,
         is_setcc, is_cmov],
        [dk_reg, true, x["alu_writes"] & dk_reg, x["sh_writes"] & dk_reg,
         dk_reg, true, dk_reg, dk_reg, true], ~true)
    w1_idx = torch.where(is_mul, torch.where(is_mul2, d.dr, 0), d.dr)
    w1_val = _sel(
        [is_mov, is_lea, is_alu, is_shift, is_unary, is_mul, is_pop,
         is_setcc, is_cmov],
        [src_val, ea, x["alu_r"], x["sh_r"], x["un_r"], x["mul_r1"],
         pop_val, cc01, torch.where(cc, src_val, dst_val)],
        torch.zeros_like(rip))
    w1_size = torch.where(is_mul, torch.where(
        is_mul2, d.opsize, torch.where(d.opsize == 1, 2, d.opsize)),
        d.opsize)
    w2_cond = is_mul & ~is_mul2 & (d.opsize > 1)
    w3_cond = is_push | is_call | is_pop | is_ret
    w3_val = _sel([is_push | is_call, is_pop, is_ret],
                  [rsp - push_size, rsp + d.opsize, rsp + 8 + d.imm], rsp)

    mem_class_writes = _sel(
        [is_mov, is_alu, is_shift, is_unary | is_setcc | is_pop],
        [true, x["alu_writes"], x["sh_writes"], true], ~true)
    st_need = live & ~unsupported & (((d.dk == U.K_MEM) & mem_class_writes)
                                     | is_push | is_call)
    st_lo = _sel([is_mov | is_push, is_alu, is_shift, is_unary, is_setcc,
                  is_pop, is_call],
                 [src_val, x["alu_r"], x["sh_r"], x["un_r"], cc01, pop_val,
                  next_rip], torch.zeros_like(rip))
    ts_ok0 = t6.ok[:, 4] & t6.writable[:, 4]
    store_fault = st_need & ~(ts_ok0 & t6.ok[:, 5] & t6.writable[:, 5])
    page_fault = live & ~unsupported & (fault1 | fault2 | store_fault)
    commit_pre = live & ~unsupported & ~page_fault
    store_ok = store_window3(image, m.overlay, t6.gpa[:, 4], t6.gpa[:, 5],
                             st_size, st_lo, torch.zeros_like(st_lo),
                             st_need & commit_pre)
    ovf = st_need & commit_pre & ~store_ok
    commit = commit_pre & ~ovf

    gpr = gpr_write(gpr, commit & w3_cond, torch.full_like(d.dr, 4),
                    w3_val, 8)
    gpr = gpr_write(gpr, commit & w2_cond, torch.full_like(d.dr, 2),
                    x["mul_r2"], d.opsize)
    gpr = gpr_write(gpr, commit & w1_cond, w1_idx, w1_val, w1_size)

    hot_rf = is_alu | is_unary | is_shift | is_mul
    rf_exec = _sel([is_alu, is_unary, is_shift],
                   [x["alu_rf"], x["un_rf"], x["sh_rf"]], x["mul_rf"])
    rf_exec = torch.where(hot_rf, rf_exec, rf)
    new_rf = torch.where(commit, rf_exec | 0x2, rf)
    rip_exec = _sel([d.is_(U.OPC_JMP) | is_call, d.is_(U.OPC_JCC), is_ret],
                    [jmp_target, torch.where(cc, jcc_target, next_rip),
                     l1_lo], next_rip)
    new_rip = torch.where(commit, rip_exec, rip)

    new_icount = m.icount + commit.to(_I64)
    ctr = m.ctr.clone()
    ctr[:, CTR_INSTR] += commit.to(torch.int32)
    ctr[:, CTR_MEM_FAULT] += page_fault.to(torch.int32)
    ctr[:, CTR_DECODE_MISS] += miss.to(torch.int32)
    timed = commit & (limit != 0) & ~I.ltu(
        new_icount, torch.full_like(new_icount, I.s64(limit)))

    cov = _bit_or(m.cov, idxc >> 5, idxc & 31, live)
    is_branch = (d.is_(U.OPC_JMP) | d.is_(U.OPC_JCC) | is_call | is_ret)
    ebits = m.edge.shape[1] * 32
    ei = (I.mix64(rip) ^ rip_exec) & (ebits - 1)
    edge = _bit_or(m.edge, ei >> 5, ei & 31, commit & is_branch)

    chain = _sel([miss, at_bp, smc, unsupported, page_fault, ovf, timed],
                 [torch.full_like(m.status, int(s)) for s in (
                     S.NEED_DECODE, S.BREAKPOINT, S.SMC, S.UNSUPPORTED,
                     S.PAGE_FAULT, S.OVERLAY_FULL, S.TIMEDOUT)],
                 torch.full_like(m.status, _RUNNING))
    fault_gva = torch.where(
        enabled & page_fault,
        torch.where(fault1, fault_at(l1_addr, t6.ok[:, 0]),
                    torch.where(fault2, fault_at(ea, t6.ok[:, 2]),
                                fault_at(st_addr, ts_ok0))),
        m.fault_gva)
    fault_write = torch.where(
        enabled & page_fault,
        (~fault1 & ~fault2).to(torch.int32), m.fault_write)

    m.gpr, m.rip, m.rflags = gpr, new_rip, new_rf
    m.status = torch.where(enabled, chain, m.status)
    m.icount = new_icount
    m.bp_skip = torch.where(commit, torch.zeros_like(m.bp_skip), m.bp_skip)
    m.fault_gva, m.fault_write = fault_gva, fault_write
    m.ctr, m.cov, m.edge = ctr, cov, edge


def run_steps(tab: UopTable, image: MemImage, m: Machine, limit: int,
              n_steps: int) -> int:
    """Up to n_steps steps, stopping early once no lane is RUNNING (the
    JAX make_run_chunk's while loop).  Returns the steps taken."""
    for i in range(n_steps):
        if not bool((m.status == _RUNNING).any()):
            return i
        step(tab, image, m, limit)
    return n_steps
