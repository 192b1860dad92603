"""The precise step's SSE and x87 classes (ROADMAP A5(c) and A5(d)).

The counterpart of the SSE, SSE-FP and x87 blocks of wtf_tpu/interp/step.py
`step_lane`, written over the lane axis: each function takes [L] operand
tensors and returns what the step routes (register, xmm, rflags, store
and x87 values) for every lane; the step selects them where the opclass
holds and applies them where the lane commits (interp/step.py).

  `sse`    SSEMOV and SSEALU: the moves and their movss/movsd merges, the
           byte-level ALU on 16-byte vectors, paddq and psllq/psrlq,
           pmovmskb, pextrw and ptest
  `ssefp`  SSEFP over f32[4] and f64[2]: arithmetic, min/max, sqrt and the
           eight cmp predicates, the ucomi/comi flag image, the converts
           and the shuffles
  `x87`    the x87 subset on the oracle's f64 value model: `fpst` holds 8
           physical slots, TOP is fpsw bits 11-13

Representation: guest values are int64 tensors holding their bits.  An f64
is a `.view(torch.float64)` of its int64; 32 bits held in an int64 are
wrapped to the int32 range before `.view(torch.float32)`.  Every NaN the
step writes is built from bits (the destination's NaN wins, SNaNs are
quieted, anything else gives the real indefinite); none is taken from what
the CPU or the card produced.  Each arithmetic result is one torch op, so
it rounds once; the square root is corrected to the correctly rounded one
(`sqrt_rn`: torch.sqrt on the CPU is not).

Denormals: a lane whose operation touches the denormal range goes to the
oracle (the step's UNSUPPORTED), as in the JAX step.  The JAX step finds a
denormal result as a flushed zero, because XLA flushes them on its CPU
backend; torch on the CPU and on the card keeps them.  So a result here is
at risk when it is zero and not a true zero, OR a nonzero denormal: the
same lanes divert whether or not the platform flushes.  (One edge
differs: an exact result just under the smallest normal that a flushing
unit makes zero but that rounds up to the smallest normal here; the JAX
step diverts it, this one commits it.)
"""

from __future__ import annotations

import torch

from wtf_tpu_torch.cpu import uops as U
from wtf_tpu_torch.interp import ints as I

_I64 = torch.int64
M32 = 0xFFFFFFFF
MAG32, EXP32 = 0x7FFFFFFF, 0x7F800000
MAG64, EXP64 = (1 << 63) - 1, 0x7FF0000000000000
SIGN64 = I.s64(1 << 63)
QBIT32, QBIT64 = 0x00400000, 0x0008000000000000
INDEF32, INDEF64 = 0xFFC00000, I.s64(0xFFF8000000000000)
ONE64 = 0x3FF0000000000000
_sel = I.select


# ---------------------------------------------------------------------------
# bits and floats
# ---------------------------------------------------------------------------

def i32(u: torch.Tensor) -> torch.Tensor:
    """The low 32 bits as a signed int32 tensor (wrapped explicitly)."""
    return (((u & M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def f32(u: torch.Tensor) -> torch.Tensor:
    return i32(u).view(torch.float32)


def b32(f: torch.Tensor) -> torch.Tensor:
    """float32 -> its bits as a non-negative int64."""
    return f.view(torch.int32).to(_I64) & M32


def f64(u: torch.Tensor) -> torch.Tensor:
    return u.view(torch.float64)


def b64(f: torch.Tensor) -> torch.Tensor:
    return f.view(_I64)


def nan32(u):
    return (u & MAG32) > EXP32


def nan64(u):
    return (u & MAG64) > EXP64


def den32(u):
    return ((u & EXP32) == 0) & ((u & MAG32) != 0)


def den64(u):
    return ((u & EXP64) == 0) & ((u & MAG64) != 0)


def cvt_s2d(u, f, isnan):
    """f32 -> f64 bits; a NaN is rebuilt from its bits (payload shifted,
    quiet bit forced)."""
    sign = I.shl(I.shr(u, 31) & 1, 63)
    nan_bits = sign | EXP64 | QBIT64 | ((u & 0x7FFFFF) << 29)
    return torch.where(isnan, nan_bits, b64(f.to(torch.float64)))


def cvt_d2s(u, f, isnan):
    """f64 -> f32 bits (as a non-negative int64), NaNs from bits."""
    sign = (I.shr(u, 63) & 1) << 31
    nan_bits = sign | EXP32 | QBIT32 | (I.shr(u, 29) & 0x3FFFFF)
    return torch.where(isnan, nan_bits, b32(f.to(torch.float32)))


def fp_to_int(v, int_bits: int, truncate, src_nan):
    """The oracle's to_int on f64 values: round half to even or truncate;
    NaN and out-of-range give the integer indefinite 1 << (bits - 1).
    Out-of-range values never reach the cast (its result differs between
    the CPU and the card)."""
    limit = float(2 ** (int_bits - 1))
    r = torch.where(truncate, torch.trunc(v), torch.round(v))
    bad = src_nan | torch.isnan(v) | (r >= limit) | (r < -limit)
    val = torch.where(bad, 0.0, r).to(_I64)
    return torch.where(bad, I.s64(1 << (int_bits - 1)),
                       val & ((1 << int_bits) - 1 if int_bits < 64 else -1))


_SPLIT = 134217729.0            # 2**27 + 1, Veltkamp's splitter


def _prod_minus(a, b, y):
    """A double with the sign of the exact a * b - y, for a * b near y
    (Dekker's product without an FMA: every step is exact)."""
    p = a * b
    ca, cb = _SPLIT * a, _SPLIT * b
    ah, bh = ca - (ca - a), cb - (cb - b)
    al, bl = a - ah, b - bh
    e = (((ah * bh - p) + ah * bl) + al * bh) + al * bl
    return (p - y) + e


def sqrt_rn(y: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float64 square root.  torch.sqrt on the CPU
    is not (it is 1 ulp off on some inputs); its result is corrected to
    the one of its two neighbours or itself that passes Tuckerman's test
    c * pred(c) < y <= c * succ(c), decided exactly, after scaling y by an
    even power of two into the range where Dekker's product is exact.  A
    correctly rounded torch.sqrt (CUDA's) passes the test unchanged."""
    one = torch.ones_like(y)
    big, small = y > 2.0 ** 900, y < 2.0 ** -900
    ys = y * torch.where(big, 2.0 ** -1000, torch.where(small, 2.0 ** 1000,
                                                        one))
    r = torch.sqrt(ys)
    rb = b64(r)
    pred, succ = f64(rb - 1), f64(rb + 1)
    r = torch.where(_prod_minus(r, pred, ys) >= 0, pred, torch.where(
        _prod_minus(r, succ, ys) < 0, succ, r))
    r = r * torch.where(big, 2.0 ** 500, torch.where(small, 2.0 ** -500, one))
    regular = (y > 0) & (y < float("inf"))
    return torch.where(regular, r, torch.sqrt(y))


def _sqrt32(f: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded: the float64 one rounds
    once more to float32 without a double-rounding error (53 >= 2 * 24
    + 2)."""
    return sqrt_rn(f.to(torch.float64)).to(torch.float32)


def _bytes(lo, hi):
    """(lo, hi) -> [L, 16] bytes (as int64 0-255), little-endian."""
    sh = torch.arange(0, 64, 8, device=lo.device)
    return torch.cat([(lo[:, None] >> sh) & 0xFF, (hi[:, None] >> sh) & 0xFF],
                     1)


def _pack(b):
    """[L, 16] bytes -> (lo, hi); the shifted bytes share no bit, so the
    sum is their OR."""
    sh = torch.arange(0, 64, 8, device=b.device).repeat(2)
    w = b << sh
    return w[:, :8].sum(1), w[:, 8:].sum(1)


def _limbs32(v):
    """[L, 4] u32 -> the (lo, hi) limbs."""
    return v[:, 0] | (v[:, 1] << 32), v[:, 2] | (v[:, 3] << 32)


def _u32s(lo, hi):
    """(lo, hi) limbs -> [L, 4] u32 elements."""
    return torch.stack([lo & M32, I.shr(lo, 32), hi & M32, I.shr(hi, 32)], 1)


# ---------------------------------------------------------------------------
# SSEMOV and SSEALU
# ---------------------------------------------------------------------------

def sse(d, rf, x_dst_lo, x_dst_hi, x_src_lo, x_src_hi, xs_lo, xs_hi,
        l1_lo, gpr_src, gpr_word):
    """-> dict: `mov_lo/hi` (SSEMOV's xmm write), `alu_lo/hi` (SSEALU's),
    `gpr` (pextrw / pmovmskb) and `ptest_rf`.  `x_src_*` is the source
    operand (register or memory), `xs_*` the source register, `gpr_src`
    and `gpr_word` the source GPR at the operand width and at 16 bits."""
    sub, opsize, imm, cond = d.sub, d.opsize, d.imm, d.cond
    k_xmm = d.sk == U.K_XMM
    zero = torch.zeros_like(x_dst_lo)
    # movd/movq gpr -> xmm (sub 1): zero-extended into the register
    in_lo = torch.where(sub == 1, gpr_src, x_src_lo)
    in_hi = torch.where((sub != 1) & (opsize >= 16), x_src_hi, zero)
    # movss/movsd xmm, xmm merge the low lanes; loads and movq (sub 3)
    # zero the upper half
    merge = k_xmm & (opsize < 16) & (sub != 3) & (sub != 1)
    szm = I.size_mask(opsize)
    lo = torch.where(opsize >= 8, in_lo, torch.where(
        merge, (x_dst_lo & ~szm) | (in_lo & szm), in_lo & szm))
    hi = torch.where(opsize >= 16, in_hi, torch.where(merge, x_dst_hi, zero))
    hi = torch.where(sub == 1, zero, hi)
    # movlps/movhps (sub 4 low half, 5 high half): loads take l1; the
    # register forms cross halves (movhlps: source HIGH, movlhps: LOW)
    half4 = torch.where(k_xmm, x_src_hi, l1_lo)
    half5 = torch.where(k_xmm, x_src_lo, l1_lo)
    mov_lo = torch.where(sub == 4, half4, torch.where(sub == 5, x_dst_lo, lo))
    mov_hi = torch.where(sub == 4, x_dst_hi, torch.where(sub == 5, half5, hi))

    # the byte-level ALU on [L, 16] byte vectors
    n = x_dst_lo.shape[0]
    ba, bb = _bytes(x_dst_lo, x_dst_hi), _bytes(x_src_lo, x_src_hi)
    i16 = torch.arange(16, device=ba.device)
    eq = ba == bb
    eq_w = eq.view(n, 8, 2).all(2).repeat_interleave(2, 1)
    eq_d = eq.view(n, 4, 4).all(2).repeat_interleave(4, 1)
    shuf = ((imm[:, None] >> (i16 // 4) * 2) & 3) * 4 + i16 % 4
    sh_n = torch.where(I.ltu(imm, torch.full_like(imm, 16)), imm, 16)[:, None]
    punp = (i16 // 8) * 4 + i16 % 4
    pin_byte = torch.where(i16 % 2 == 0, gpr_word[:, None] & 0xFF,
                           (gpr_word[:, None] >> 8) & 0xFF)
    ones = torch.full_like(ba, 0xFF)
    c = sub[:, None]
    out = _sel(
        [c == U.SSE_PXOR, c == U.SSE_XORPS, c == U.SSE_POR, c == U.SSE_PAND,
         c == U.SSE_PANDN, c == U.SSE_PCMPEQB, c == U.SSE_PCMPEQW,
         c == U.SSE_PCMPEQD, c == U.SSE_PSUBB, c == U.SSE_PADDB,
         c == U.SSE_PMINUB, c == U.SSE_PUNPCKLQDQ, c == U.SSE_PSHUFD,
         c == U.SSE_PSLLDQ, c == U.SSE_PSRLDQ, c == U.SSE_PUNPCKLDQ,
         c == U.SSE_PINSRW],
        [ba ^ bb, ba ^ bb, ba | bb, ba & bb, (ba ^ 0xFF) & bb,
         torch.where(eq, ones, 0), torch.where(eq_w, ones, 0),
         torch.where(eq_d, ones, 0), (ba - bb) & 0xFF, (ba + bb) & 0xFF,
         torch.minimum(ba, bb), torch.cat([ba[:, :8], bb[:, :8]], 1),
         torch.gather(bb, 1, shuf),
         torch.where(i16 >= sh_n, torch.gather(
             ba, 1, (i16 - sh_n).clamp(0, 15)), 0),
         torch.where(i16 + sh_n < 16, torch.gather(
             ba, 1, (i16 + sh_n).clamp(0, 15)), 0),
         torch.where((i16 // 4) % 2 == 0, ba[:, punp], bb[:, punp]),
         torch.where(i16 // 2 == cond[:, None], pin_byte, ba)],
        ba)
    alu_lo, alu_hi = _pack(out)
    # paddq adds the qwords (byte adds would lose the carries); psllq and
    # psrlq shift them (a count above 63 zeroes the register)
    limb_ops = [(sub == U.SSE_PADDQ, x_dst_lo + x_src_lo, x_dst_hi + x_src_hi),
                (sub == U.SSE_PSLLQ_I, I.shl(x_dst_lo, imm),
                 I.shl(x_dst_hi, imm)),
                (sub == U.SSE_PSRLQ_I, I.shr(x_dst_lo, imm),
                 I.shr(x_dst_hi, imm))]
    alu_lo = _sel([r[0] for r in limb_ops], [r[1] for r in limb_ops], alu_lo)
    alu_hi = _sel([r[0] for r in limb_ops], [r[2] for r in limb_ops], alu_hi)

    # pmovmskb: the sign bit of each source byte -> GPR bit i; pextrw:
    # word `cond` of the source register, zero-extended
    pmov = (((_bytes(xs_lo, xs_hi) >> 7) & 1) << i16).sum(1)
    pextrw = (torch.where(cond < 4, xs_lo, xs_hi) >> (cond & 3) * 16) & 0xFFFF
    false = torch.zeros_like(sub, dtype=torch.bool)
    zf = ((x_dst_lo & x_src_lo) == 0) & ((x_dst_hi & x_src_hi) == 0)
    cf = ((~x_dst_lo & x_src_lo) == 0) & ((~x_dst_hi & x_src_hi) == 0)
    ptest_rf = (rf & ~I.FLAGS_ARITH) | I.mkflags(cf, false, false, zf, false,
                                                 false)
    return dict(mov_lo=mov_lo, mov_hi=mov_hi, alu_lo=alu_lo, alu_hi=alu_hi,
                gpr=torch.where(sub == U.SSE_PEXTRW, pextrw, pmov),
                ptest_rf=ptest_rf)


# ---------------------------------------------------------------------------
# SSEFP
# ---------------------------------------------------------------------------

def _elementwise(sub, pred, fa, fb, ua, ub, bits, qbit, indef, nanf, denf,
                 mag, exp, ones, sqrt):
    """arith / min/max / sqrt / cmp over one element width ([L, 4] f32 or
    [L, 2] f64; `sub` and `pred` are [L, 1]) -> (result bits, denormal
    risk) per element."""
    nan_a, nan_b = nanf(ua), nanf(ub)
    r = _sel([sub == U.FP_ADD, sub == U.FP_SUB, sub == U.FP_MUL,
              sub == U.FP_DIV], [fa + fb, fa - fb, fa * fb, fa / fb], fa)
    rb = bits(r)
    arith = torch.where(nan_a, ua | qbit, torch.where(
        nan_b, ub | qbit, torch.where(nanf(rb), indef, rb)))
    take_a = torch.where(sub == U.FP_MIN, fa < fb, fa > fb)
    mm = torch.where(nan_a | nan_b | (fa == fb), ub,
                     torch.where(take_a, ua, ub))
    sq = torch.where(nan_b, ub | qbit, torch.where(
        fb < 0, indef, bits(sqrt(fb))))
    unord = nan_a | nan_b
    eq, lt, le = fa == fb, fa < fb, fa <= fb
    cmp = _sel([pred == k for k in range(7)],
               [~unord & eq, ~unord & lt, ~unord & le, unord, unord | ~eq,
                unord | ~lt, unord | ~le], ~unord)
    is_arith = (sub >= U.FP_ADD) & (sub <= U.FP_DIV)
    out = _sel([is_arith, (sub == U.FP_MIN) | (sub == U.FP_MAX),
                sub == U.FP_SQRT], [arith, mm, sq],
               cmp.to(_I64) * ones)
    # a result a flushing unit would make zero (see the module docstring);
    # true zeros are exactly the listed cases
    true_zero = _sel(
        [sub == U.FP_ADD, sub == U.FP_SUB, sub == U.FP_MUL],
        [fa == -fb, fa == fb, ((ua & mag) == 0) | ((ub & mag) == 0)],
        ((ua & mag) == 0) | ((ub & mag) == exp))
    ftz = is_arith & ((((rb & mag) == 0) & ~true_zero) | denf(rb)) \
        & ~nan_a & ~nan_b
    den_in = torch.where(sub == U.FP_SQRT, denf(ub), denf(ua) | denf(ub))
    return out, ftz | den_in


def fp_ldsize(d):
    """The oracle's memory-operand byte counts for SSEFP (emu._exec_ssefp),
    which decide the faults at a page end: 16 for the packed elementwise
    forms and the DQ/PS/PD block, an element for the scalar ones, the
    converts their own shapes."""
    sub, src0 = d.sub, d.srcsize0
    is_ew = (sub <= U.FP_SQRT) | (sub == U.FP_CMP)
    return _sel(
        [sub == U.FP_CVT_I2F,
         (sub == U.FP_CVT_F2I) | (sub == U.FP_CVT_F2I_T)
         | (sub == U.FP_UCOMI) | (sub == U.FP_COMI),
         sub == U.FP_CVT_F2F, is_ew],
        [d.opsize, src0, torch.where(d.sext == 1, src0 * 2, src0),
         torch.where(d.sext == 1, 16, src0)], torch.full_like(src0, 16))


def ssefp(d, rf, x_dst_lo, x_dst_hi, x_src_lo, x_src_hi, l1_lo, gpr_src):
    """-> dict: `lo/hi` (the merged xmm write), `writes_xmm`, `is_f2i` and
    `f2i` (the GPR write of cvt(t)s{s,d}2si), `is_comi` and `ucomi_rf`,
    `denorm` (the lanes that go to the oracle)."""
    sub, imm, sext, opsize = d.sub, d.imm, d.sext, d.opsize
    elem8 = d.srcsize0 == 8            # 4: float32 elements, 8: float64
    ua32, ub32 = _u32s(x_dst_lo, x_dst_hi), _u32s(x_src_lo, x_src_hi)
    ua64 = torch.stack([x_dst_lo, x_dst_hi], 1)
    ub64 = torch.stack([x_src_lo, x_src_hi], 1)
    fa32, fb32 = f32(ua32), f32(ub32)
    fa64, fb64 = f64(ua64), f64(ub64)
    nan_a32, nan_b32 = nan32(ua32), nan32(ub32)
    nan_a64, nan_b64 = nan64(ua64), nan64(ub64)
    s1, p1 = sub[:, None], (imm & 7)[:, None]
    ew32, risk32 = _elementwise(s1, p1, fa32, fb32, ua32, ub32, b32, QBIT32,
                                INDEF32, nan32, den32, MAG32, EXP32, M32,
                                _sqrt32)
    ew64, risk64 = _elementwise(s1, p1, fa64, fb64, ua64, ub64, b64, QBIT64,
                                INDEF64, nan64, den64, MAG64, EXP64, -1,
                                sqrt_rn)
    ew_lo32, ew_hi32 = _limbs32(ew32)
    ew_lo = torch.where(elem8, ew64[:, 0], ew_lo32)
    ew_hi = torch.where(elem8, ew64[:, 1], ew_hi32)
    is_f2i = (sub == U.FP_CVT_F2I) | (sub == U.FP_CVT_F2I_T)
    is_comi = (sub == U.FP_UCOMI) | (sub == U.FP_COMI)
    is_ew = (sub <= U.FP_SQRT) | (sub == U.FP_CMP)

    # the elements an op reads (a scalar form must not flag junk in the
    # destination's upper elements)
    packed = (sext == 1)[:, None]
    i4 = torch.arange(4, device=sub.device)
    used32 = packed | (i4 == 0)
    used64 = packed | (i4[:2] == 0)
    ew_risk = torch.where(elem8, (risk64 & used64).any(1),
                          (risk32 & used32).any(1))
    comi_risk = torch.where(elem8, den64(ua64[:, 0]) | den64(ub64[:, 0]),
                            den32(ua32[:, 0]) | den32(ub32[:, 0]))
    # f2f: s2d flags denormal f32 inputs; d2s any f64 input small enough
    # that the f32 result lands at or under the smallest normal
    d2s_small = ((I.shr(ub64, 52) & 0x7FF) <= 897) & ((ub64 & MAG64) != 0)
    f2f_risk = torch.where(
        elem8, (d2s_small & used64).any(1),
        (den32(ub32) & torch.where(packed, i4 < 2, i4 == 0)).any(1))
    false = torch.zeros_like(elem8)
    denorm = _sel([is_ew, is_comi, sub == U.FP_CVT_F2F],
                  [ew_risk, comi_risk, f2f_risk], false)

    # ucomis/comis: unordered -> ZF = PF = CF = 1; else ZF = (a == b),
    # CF = (a < b), PF = 0; OF, AF, SF cleared
    unord = torch.where(elem8, nan_a64[:, 0] | nan_b64[:, 0],
                        nan_a32[:, 0] | nan_b32[:, 0])
    eq = torch.where(elem8, fa64[:, 0] == fb64[:, 0], fa32[:, 0] == fb32[:, 0])
    lt = torch.where(elem8, fa64[:, 0] < fb64[:, 0], fa32[:, 0] < fb32[:, 0])
    ucomi_rf = (rf & ~I.FLAGS_ARITH) | I.mkflags(
        unord | (~unord & lt), unord, false, unord | (~unord & eq), false,
        false)

    # cvtsi2ss/sd: a GPR or an opsize-wide load, sign-extended, rounded
    # once by the convert (int64 -> float32 directly)
    i2f = I.sext(torch.where(d.sk == U.K_REG, gpr_src,
                             l1_lo & I.size_mask(opsize)), opsize)
    i2f_lo = torch.where(elem8, b64(i2f.to(torch.float64)),
                         b32(i2f.to(torch.float32)))
    # fp -> int in f64 (f32 widens exactly first)
    f2i_src = torch.where(elem8, fb64[:, 0], fb32[:, 0].to(torch.float64))
    f2i_nan = torch.where(elem8, nan_b64[:, 0], nan_b32[:, 0])
    f2i_t = sub == U.FP_CVT_F2I_T
    f2i = torch.where(opsize >= 8, fp_to_int(f2i_src, 64, f2i_t, f2i_nan),
                      fp_to_int(f2i_src, 32, f2i_t, f2i_nan))
    # f32 <-> f64
    s2d = cvt_s2d(ub32, fb32, nan_b32)
    d2s = cvt_d2s(ub64, fb64, nan_b64)
    f2f_lo = torch.where(elem8, d2s[:, 0] | (d2s[:, 1] << 32), s2d[:, 0])
    f2f_hi = torch.where(elem8, 0, s2d[:, 1])
    # packed int <-> fp
    dq2ps_lo, dq2ps_hi = _limbs32(b32(i32(ub32).to(torch.float32)))
    ps2dq_lo, ps2dq_hi = _limbs32(fp_to_int(
        fb32.to(torch.float64), 32, (sub == U.FP_CVT_PS2DQ_T)[:, None],
        nan_b32))
    dq2pd = b64(i32(ub32[:, :2]).to(torch.float64))
    pd2dq = fp_to_int(fb64, 32, (sub == U.FP_CVT_PD2DQ_T)[:, None], nan_b64)
    pd2dq_lo = pd2dq[:, 0] | (pd2dq[:, 1] << 32)
    # shufps/shufpd, unpck{l,h}{ps,pd}: lane shuffles
    pick = torch.stack([(0 if i < 2 else 4) + (I.shr(imm, 2 * i) & 3)
                        for i in range(4)], 1)
    shufps_lo, shufps_hi = _limbs32(torch.gather(
        torch.cat([ua32, ub32], 1), 1, pick))
    shufpd_lo = torch.where((imm & 1) != 0, x_dst_hi, x_dst_lo)
    shufpd_hi = torch.where((imm & 2) != 0, x_src_hi, x_src_lo)
    unp_h = sub == U.FP_UNPCKH
    h1 = unp_h[:, None]
    unp32_lo, unp32_hi = _limbs32(torch.stack(
        [torch.where(unp_h, ua32[:, 2], ua32[:, 0]),
         torch.where(unp_h, ub32[:, 2], ub32[:, 0]),
         torch.where(unp_h, ua32[:, 3], ua32[:, 1]),
         torch.where(unp_h, ub32[:, 3], ub32[:, 1])], 1))
    unp64 = torch.where(h1, torch.stack([x_dst_hi, x_src_hi], 1),
                        torch.stack([x_dst_lo, x_src_lo], 1))

    conds = [sub == U.FP_CVT_I2F, sub == U.FP_CVT_F2F,
             sub == U.FP_CVT_DQ2PS,
             (sub == U.FP_CVT_PS2DQ) | (sub == U.FP_CVT_PS2DQ_T),
             sub == U.FP_CVT_DQ2PD,
             (sub == U.FP_CVT_PD2DQ) | (sub == U.FP_CVT_PD2DQ_T),
             sub == U.FP_SHUF, (sub == U.FP_UNPCKL) | (sub == U.FP_UNPCKH)]
    zero = torch.zeros_like(x_dst_lo)
    res_lo = _sel(conds, [
        i2f_lo, f2f_lo, dq2ps_lo, ps2dq_lo, dq2pd[:, 0], pd2dq_lo,
        torch.where(elem8, shufpd_lo, shufps_lo),
        torch.where(elem8, unp64[:, 0], unp32_lo)], ew_lo)
    res_hi = _sel(conds, [
        zero, f2f_hi, dq2ps_hi, ps2dq_hi, dq2pd[:, 1], zero,
        torch.where(elem8, shufpd_hi, shufps_hi),
        torch.where(elem8, unp64[:, 1], unp32_hi)], ew_hi)
    # the destination write width: 16 is the whole register, else the
    # low bytes merge
    wsz = _sel([sub == U.FP_CVT_I2F, sub == U.FP_CVT_F2F, is_ew],
               [d.srcsize0, torch.where(sext == 1, 16, 12 - d.srcsize0),
                torch.where(sext == 1, 16, d.srcsize0)],
               torch.full_like(sub, 16))
    wmask = I.size_mask(wsz.clamp(max=8))
    return dict(lo=(x_dst_lo & ~wmask) | (res_lo & wmask),
                hi=torch.where(wsz >= 16, res_hi, x_dst_hi),
                writes_xmm=~is_f2i & ~is_comi, is_f2i=is_f2i, f2i=f2i,
                is_comi=is_comi, ucomi_rf=ucomi_rf, denorm=denorm)


# ---------------------------------------------------------------------------
# X87
# ---------------------------------------------------------------------------

def _tag_set(tw, phys, val: int):
    sh = phys * 2
    return (tw & ~(3 << sh)) | (val << sh)


def x87(d, rf, fpst, fpcw, fpsw, fptw, mxcsr, l1_lo):
    """-> dict: the store value, the compare rflags, the register-stack
    write (`w1_en/idx/val`, the FXCH partner at `phi` <- `st0`), the new
    fpcw/fpsw/fptw/mxcsr and `denorm`, for x87 lanes (the step applies
    them where an x87 lane commits)."""
    sub, imm, cond, sext, src0 = d.sub, d.imm, d.cond, d.sext, d.srcsize0
    top = I.shr(fpsw, 11) & 7
    ph0, phi = top, (top + (imm & 7)) & 7
    pair = torch.gather(fpst, 1, torch.stack([ph0, phi], 1))
    st0_b, sti_b = pair[:, 0], pair[:, 1]
    st0_f = f64(st0_b)

    # memory operand -> f64 bits: m64 moves its bits, m32 widens NaN-safe,
    # integers convert as the oracle's int64 -> float64
    m32 = l1_lo & M32
    mem_b = torch.where(src0 >= 8, l1_lo, cvt_s2d(m32, f32(m32), nan32(m32)))
    fild_b = b64(I.sext(l1_lo, src0).to(torch.float64))

    # arithmetic by the encoded digit (COM/COMP digits compare instead);
    # DC/DE st(i) forms write st(i)
    arith_m, arith_st = sub == U.X87_ARITH_M, sub == U.X87_ARITH_ST
    arith = arith_m | arith_st
    dsti = arith_st & (d.dr == 1)
    xa_b = torch.where(dsti, sti_b, st0_b)
    xb_b = torch.where(arith_m, mem_b, torch.where(dsti, st0_b, sti_b))
    xa, xb = f64(xa_b), f64(xb_b)
    r_b = b64(_sel([cond == U.X87_OP_ADD, cond == U.X87_OP_MUL,
                    cond == U.X87_OP_SUB, cond == U.X87_OP_SUBR,
                    cond == U.X87_OP_DIV],
                   [xa + xb, xa * xb, xa - xb, xb - xa, xa / xb], xb / xa))
    nan_xa, nan_xb = nan64(xa_b), nan64(xb_b)
    # NaNs route by the OPERATION's operand order: the reversed forms
    # (b OP a) propagate xb's first
    rev = (cond == U.X87_OP_SUBR) | (cond == U.X87_OP_DIVR)
    n1 = torch.where(rev, nan_xb, nan_xa)
    n2 = torch.where(rev, nan_xa, nan_xb)
    n1_b = torch.where(rev, xb_b, xa_b)
    n2_b = torch.where(rev, xa_b, xb_b)
    arith_out = torch.where(n1, n1_b | QBIT64, torch.where(
        n2, n2_b | QBIT64, torch.where(nan64(r_b), INDEF64, r_b)))
    com_digit = (cond == U.X87_OP_COM) | (cond == U.X87_OP_COMP)
    arith_writes = arith & ~com_digit

    # fcom/fucom (C3/C2/C0) and fcomi/fucomi (ZF/PF/CF)
    cmp_b = torch.where(arith_m, mem_b, sti_b)
    unord = nan64(st0_b) | nan64(cmp_b)
    eq, lt = st0_f == f64(cmp_b), st0_f < f64(cmp_b)
    false = torch.zeros_like(unord)
    c_eq, c_lt = unord | (~unord & eq), unord | (~unord & lt)
    comi_rf = (rf & ~I.FLAGS_ARITH) | I.mkflags(c_lt, unord, false, c_eq,
                                                false, false)
    com_bits = (c_eq.to(_I64) * 0x4000) | (unord.to(_I64) * 0x400) \
        | (c_lt.to(_I64) * 0x100)
    is_com = (sub == U.X87_COM) | (arith & com_digit)

    # fist(p) rounds by fpcw.RC, fisttp chops; NaN or overflow gives the
    # integer indefinite
    rc = torch.where(sub == U.X87_FIST_T, 3, I.shr(fpcw, 10) & 3)
    limit = _sel([src0 == 2, src0 == 4, src0 == 8],
                 [2.0 ** 15, 2.0 ** 31, 2.0 ** 63],
                 torch.full_like(st0_f, 0.5))
    rounded = _sel([rc == 0, rc == 1, rc == 2],
                   [torch.round(st0_f), torch.floor(st0_f),
                    torch.ceil(st0_f)], torch.trunc(st0_f))
    fist_bad = nan64(st0_b) | (rounded >= limit) | (rounded < -limit)
    fist = torch.where(fist_bad, I.shl(torch.ones_like(src0), src0 * 8 - 1),
                       torch.where(fist_bad, 0.0, rounded).to(_I64)) \
        & I.size_mask(src0)
    fst32 = cvt_d2s(st0_b, st0_f, nan64(st0_b))
    store = _sel([sub == U.X87_FST_M,
                  (sub == U.X87_FIST) | (sub == U.X87_FIST_T),
                  sub == U.X87_FNSTCW, sub == U.X87_FNSTSW_M],
                 [torch.where(src0 >= 8, st0_b, fst32), fist,
                  fpcw & 0xFFFF, fpsw & 0xFFFF], mxcsr & M32)

    # pushes, the register-stack write and the FXCH partner
    is_push = (sub == U.X87_FLD_M) | (sub == U.X87_FILD) \
        | (sub == U.X87_FLD_STI) | (sub == U.X87_FLD_CONST)
    push_b = _sel([sub == U.X87_FLD_M, sub == U.X87_FILD,
                   sub == U.X87_FLD_STI], [mem_b, fild_b, sti_b],
                  (imm == 0).to(_I64) * ONE64)
    push_slot = (top - 1) & 7
    fst_sti = sub == U.X87_FST_STI
    fxch = sub == U.X87_FXCH
    w1_en = is_push | arith_writes | fst_sti | (sub == U.X87_FCHS) \
        | (sub == U.X87_FABS) | fxch
    w1_idx = _sel([is_push, arith_writes & dsti, fst_sti],
                  [push_slot, phi, phi], ph0)
    w1_val = _sel([is_push, arith_writes, fst_sti, sub == U.X87_FCHS,
                   sub == U.X87_FABS],
                  [push_b, arith_out, st0_b, st0_b ^ SIGN64, st0_b & MAG64],
                  sti_b)

    # stack top, tag word, control and status words
    fninit = sub == U.X87_FNINIT
    new_top = torch.where(fninit, 0, torch.where(is_push, push_slot,
                                                 (top + sext) & 7))
    tw = torch.where(is_push, _tag_set(fptw, push_slot, 0), fptw)
    tw = torch.where(fst_sti, _tag_set(tw, phi, 0), tw)
    tw = torch.where(sext >= 1, _tag_set(tw, ph0, 3), tw)
    tw = torch.where(sext >= 2, _tag_set(tw, (top + 1) & 7, 3), tw)
    tw = torch.where(sub == U.X87_FFREE, _tag_set(tw, phi, 3), tw)
    tw = torch.where(fninit | (sub == U.X87_EMMS), 0xFFFF, tw)
    cw = torch.where(sub == U.X87_FLDCW, l1_lo & 0xFFFF,
                     torch.where(fninit, 0x37F, fpcw))
    sw = torch.where(is_com, (fpsw & ~0x4500) | com_bits, fpsw)
    sw = torch.where(sub == U.X87_FNCLEX, sw & ~0x80FF, sw)
    sw = torch.where(fninit, 0, sw)
    sw = (sw & ~0x3800) | (new_top << 11)
    mx = torch.where(sub == U.X87_LDMXCSR, l1_lo & M32, mxcsr)

    # denormal risk -> oracle, as in `ssefp`
    r_zero = (r_b & MAG64) == 0
    div_a = torch.where(cond == U.X87_OP_DIV, xa_b, xb_b)
    div_b = torch.where(cond == U.X87_OP_DIV, xb_b, xa_b)
    true_zero = _sel(
        [cond == U.X87_OP_ADD,
         (cond == U.X87_OP_SUB) | (cond == U.X87_OP_SUBR),
         cond == U.X87_OP_MUL],
        [xa == -xb, xa == xb,
         ((xa_b & MAG64) == 0) | ((xb_b & MAG64) == 0)],
        ((div_a & MAG64) == 0) | ((div_b & MAG64) == EXP64))
    ftz = arith_writes & ((r_zero & ~true_zero) | den64(r_b)) \
        & ~nan_xa & ~nan_xb
    # an m32 operand needs the f32-level test: widened, a denormal f32 is
    # a normal f64
    den_arith = arith & (den64(xa_b) | den64(xb_b)
                         | (arith_m & (src0 < 8) & den32(m32)))
    fst32_small = ((I.shr(st0_b, 52) & 0x7FF) <= 897) \
        & ((st0_b & MAG64) != 0)
    denorm = _sel(
        [arith, (sub == U.X87_FLD_M) & (src0 < 8),
         (sub == U.X87_FST_M) & (src0 < 8),
         (sub == U.X87_FIST) | (sub == U.X87_FIST_T),
         (sub == U.X87_COM) | (sub == U.X87_COMI)],
        [ftz | den_arith, den32(m32), fst32_small, den64(st0_b),
         den64(st0_b) | den64(cmp_b)], false)
    return dict(store=store, comi_rf=comi_rf, w1_en=w1_en, w1_idx=w1_idx,
                w1_val=w1_val, fxch=fxch, phi=phi, st0=st0_b, fpcw=cw,
                fpsw=sw, fptw=tw, mxcsr=mx, denorm=denorm)
