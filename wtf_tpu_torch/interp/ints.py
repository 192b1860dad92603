"""64-bit guest integer arithmetic on `torch.int64` tensors.

The counterpart of wtf_tpu/interp/limbs.py.  The JAX package splits every
64-bit guest value into two u32 limbs because Pallas on a TPU holds no
64-bit integers; a Hopper card and PyTorch both do, so here a guest value
is one `int64` whose two's-complement bits ARE the u64 value.  Addition,
subtraction, multiplication (low half), and/or/xor and left shifts are the
native ops (they wrap mod 2**64 on every backend).  What PyTorch does not
provide for int64 is written out below: logical right shift, unsigned
compare, the high half of a 64x64 product, and carry/borrow outputs.
PyTorch on the CPU has no uint64 `>>` and no uint32 add, so unsigned
dtypes are not an option for the machine state.

Every shift amount is clamped into [0, 63] before it reaches a shift op,
and the >= 64 cases are selected explicitly, so no result depends on how a
backend treats out-of-range shifts.  All functions broadcast; shift
amounts, byte sizes and condition codes may be tensors of any integer
dtype.
"""

from __future__ import annotations

import torch

MASK64 = (1 << 64) - 1
MASK32 = 0xFFFFFFFF

# rflags bits (the arithmetic flags live in bits 0-11)
CF, PF, AF, ZF, SF, OF = 0x1, 0x4, 0x10, 0x40, 0x80, 0x800
FLAGS_ARITH = CF | PF | AF | ZF | SF | OF

_I64 = torch.int64


def s64(v: int) -> int:
    """Python int (any sign) -> the int64 value with the same low 64 bits."""
    v &= MASK64
    return v - (1 << 64) if v >> 63 else v


def u64(v: int) -> int:
    """int64 value -> the unsigned Python int with the same bits."""
    return int(v) & MASK64


_SIGN = s64(1 << 63)
_GOLDEN = s64(0x9E3779B97F4A7C15)
_MIX1 = s64(0xBF58476D1CE4E5B9)
_MIX2 = s64(0x94D049BB133111EB)


def _i64(x) -> torch.Tensor:
    return x if x.dtype == _I64 else x.to(_I64)


# ---------------------------------------------------------------------------
# shifts and rotates
# ---------------------------------------------------------------------------

def _out_of_range(s: torch.Tensor) -> torch.Tensor:
    """Counts are unsigned: a negative int64 count reads as >= 2**63."""
    return (s >= 64) | (s < 0)


def shl(a: torch.Tensor, s) -> torch.Tensor:
    """a << s; a count of 64 or more gives 0."""
    if isinstance(s, int):
        return a << s if 0 <= s < 64 else torch.zeros_like(a)
    s = _i64(s)
    return torch.where(_out_of_range(s), torch.zeros_like(a),
                       a << s.clamp(0, 63))


def shr(a: torch.Tensor, s) -> torch.Tensor:
    """Logical a >> s; a count of 64 or more gives 0."""
    if isinstance(s, int):
        if s == 0:
            return a
        return (a >> s) & ((1 << (64 - s)) - 1) if 0 < s < 64 \
            else torch.zeros_like(a)
    s = _i64(s)
    sc = s.clamp(1, 63)
    logical = (a >> sc) & ((torch.ones_like(sc) << (64 - sc)) - 1)
    return torch.where(s == 0, a, torch.where(
        _out_of_range(s), torch.zeros_like(a), logical))


def sar(a: torch.Tensor, s) -> torch.Tensor:
    """Arithmetic a >> s; a count of 64 or more fills with the sign."""
    if isinstance(s, int):
        return a >> (s if 0 <= s < 64 else 63)
    s = _i64(s)
    return a >> torch.where(_out_of_range(s), torch.full_like(s, 63), s)


def rol(a: torch.Tensor, s) -> torch.Tensor:
    k = _i64(torch.as_tensor(s, device=a.device)) & 63
    return torch.where(k == 0, a, shl(a, k) | shr(a, 64 - k))


def ror(a: torch.Tensor, s) -> torch.Tensor:
    k = _i64(torch.as_tensor(s, device=a.device)) & 63
    return torch.where(k == 0, a, shr(a, k) | shl(a, 64 - k))


# ---------------------------------------------------------------------------
# unsigned compare, carries, products
# ---------------------------------------------------------------------------

def ltu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b (flip the sign bit, compare signed)."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def leu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a ^ _SIGN) <= (b ^ _SIGN)


def adc(a, b, carry_in):
    """a + b + carry_in -> (sum, carry out)."""
    c = _i64(carry_in)
    r = a + b + c
    cout = ltu(r, a) | ((c != 0) & (r == a))
    return r, cout


def sbb(a, b, borrow_in):
    """a - b - borrow_in -> (difference, borrow out)."""
    c = _i64(borrow_in)
    r = a - b - c
    bout = ltu(a, b) | ((c != 0) & (a == b))
    return r, bout


def umulhi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """High 64 bits of the unsigned 128-bit product.  The four 32x32
    partial products are exact mod 2**64 (their bits are right even when
    the int64 holding them reads negative); logical shifts split them."""
    al, ah = a & MASK32, shr(a, 32)
    bl, bh = b & MASK32, shr(b, 32)
    ll, lh, hl, hh = al * bl, al * bh, ah * bl, ah * bh
    mid = shr(ll, 32) + (lh & MASK32) + (hl & MASK32)
    return hh + shr(lh, 32) + shr(hl, 32) + shr(mid, 32)


def smulhi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """High 64 bits of the signed 128-bit product."""
    hi = umulhi(a, b)
    hi = hi - torch.where(a < 0, b, torch.zeros_like(b))
    return hi - torch.where(b < 0, a, torch.zeros_like(a))


# ---------------------------------------------------------------------------
# hashing (bit-for-bit utils.hashing.mix64 / splitmix64)
# ---------------------------------------------------------------------------

def mix64(z: torch.Tensor) -> torch.Tensor:
    z = (z ^ shr(z, 30)) * _MIX1
    z = (z ^ shr(z, 27)) * _MIX2
    return z ^ shr(z, 31)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    return mix64(x + _GOLDEN)


# ---------------------------------------------------------------------------
# operand widths
# ---------------------------------------------------------------------------

def size_mask(nbytes) -> torch.Tensor:
    """nbytes -> value mask; >= 8 bytes (and only those) is all-ones."""
    bits = _i64(nbytes).clamp(0, 8) * 8
    return torch.where(bits >= 64, torch.full_like(bits, -1),
                       (torch.ones_like(bits) << bits.clamp(0, 63)) - 1)


def zext(a: torch.Tensor, nbytes) -> torch.Tensor:
    return a & size_mask(nbytes)


def sext(a: torch.Tensor, nbytes) -> torch.Tensor:
    """Sign-extend the low nbytes (1/2/4; >= 8 passes through).  As in
    limbs.sext a width above 4 and below 8 extends from bit 31, and a
    width of 0 gives 0."""
    n = _i64(nbytes)
    bits = n.clamp(0, 4) * 8
    sh = (64 - bits).clamp(0, 63)
    v = torch.where(bits == 0, torch.zeros_like(a), (a << sh) >> sh)
    return torch.where(n >= 8, a, v)


def msb(a: torch.Tensor, nbytes) -> torch.Tensor:
    """Sign bit of the low-nbytes value as bool (false for nbytes <= 0)."""
    n = _i64(nbytes)
    bit = torch.where(n >= 8, torch.full_like(n, 63), n.clamp(1, 4) * 8 - 1)
    return (n > 0) & ((shr(a, bit) & 1) != 0)


# ---------------------------------------------------------------------------
# x86 flag images
# ---------------------------------------------------------------------------

def parity_even(r: torch.Tensor) -> torch.Tensor:
    v = r & 0xFF
    v = v ^ (v >> 4)
    v = v ^ (v >> 2)
    v = v ^ (v >> 1)
    return (v & 1) == 0


def mkflags(cf, pf, af, zf, sf, of) -> torch.Tensor:
    return (cf.to(_I64) * CF | pf.to(_I64) * PF | af.to(_I64) * AF
            | zf.to(_I64) * ZF | sf.to(_I64) * SF | of.to(_I64) * OF)


def flags_add(a, b, r, nbytes, carry) -> torch.Tensor:
    """Flag image of a + b (+carry) = r at the operand width."""
    am, rm = zext(a, nbytes), zext(r, nbytes)
    cf = ltu(rm, am) | (carry & (rm == am))
    return mkflags(cf, parity_even(rm), ((a ^ b ^ r) & 0x10) != 0,
                   rm == 0, msb(rm, nbytes), msb((a ^ r) & (b ^ r), nbytes))


def flags_sub(a, b, r, nbytes, borrow) -> torch.Tensor:
    """Flag image of a - b (-borrow) = r at the operand width."""
    am, bm, rm = zext(a, nbytes), zext(b, nbytes), zext(r, nbytes)
    cf = torch.where(borrow, leu(am, bm), ltu(am, bm))
    return mkflags(cf, parity_even(rm), ((a ^ b ^ r) & 0x10) != 0,
                   rm == 0, msb(rm, nbytes), msb((a ^ b) & (a ^ r), nbytes))


def flags_logic(r, nbytes) -> torch.Tensor:
    rm = zext(r, nbytes)
    false = torch.zeros_like(rm, dtype=torch.bool)
    return mkflags(false, parity_even(rm), false, rm == 0, msb(rm, nbytes),
                   false)


def eval_cond(rf: torch.Tensor, rcx: torch.Tensor, cc) -> torch.Tensor:
    """cc 0-15: the x86 condition table; 16: jrcxz; 17: jecxz."""
    cf = (rf & CF) != 0
    pf = (rf & PF) != 0
    zf = (rf & ZF) != 0
    sf = (rf & SF) != 0
    of = (rf & OF) != 0
    table = torch.stack([
        of, ~of, cf, ~cf, zf, ~zf, cf | zf, ~(cf | zf),
        sf, ~sf, pf, ~pf, sf != of, sf == of,
        zf | (sf != of), ~zf & (sf == of),
    ], dim=-1)
    cc = _i64(torch.as_tensor(cc, device=rf.device)).expand(rf.shape)
    base = torch.gather(table, -1, cc.clamp(0, 15).unsqueeze(-1)).squeeze(-1)
    base = torch.where(cc == 16, rcx == 0, base)
    return torch.where(cc == 17, (rcx & MASK32) == 0, base)
