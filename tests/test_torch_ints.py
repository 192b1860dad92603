"""wtf_tpu_torch/interp/ints.py (64-bit guest arithmetic on int64) against
wtf_tpu/interp/limbs.py (the same on u32 limb pairs), bit for bit, on the
corner grids of tests/test_limbs.py: limb and sign boundaries, all-ones,
irregular patterns, and shift counts across the limb boundary and past 64.
The division, bit-count, byte-swap and BMI helpers the precise step's
integer classes use are held against the JAX step's own operations on the
same grids.  One parametrised test, one case per operation family.
"""

import jax.numpy as jnp
from jax import lax
import numpy as np
import pytest
import torch

from tests.test_limbs import CORNERS, SHIFTS
from wtf_tpu.interp import limbs as L
from wtf_tpu_torch.interp import ints as I

from tests.torchport import one_torch_thread  # noqa: F401  (module fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MASK64 = (1 << 64) - 1


def _cross(xs, ys):
    return [x for x in xs for _ in ys], [y for _ in xs for y in ys]


def _pair(values):
    u = L.unpack_np(np.array(values, dtype=np.uint64))
    return jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1])


def _from_pair(p):
    lo = np.asarray(p[0]).astype(np.uint64)
    hi = np.asarray(p[1]).astype(np.uint64)
    return lo | (hi << np.uint64(32))


def _t(values):
    return torch.from_numpy(np.array(values, dtype=np.uint64).view(np.int64))


def _u(t):
    return t.numpy().view(np.uint64)


def _b(x):
    return np.asarray(x).astype(bool)


def _case_add_sub():
    ax, bx = _cross(CORNERS, CORNERS)
    a, b = _pair(ax), _pair(bx)
    ta, tb = _t(ax), _t(bx)
    out = []
    for carry in (False, True):
        cin = jnp.full(len(ax), carry)
        tcin = torch.full((len(ax),), carry)
        s, cout = L.adc64(a, b, cin)
        d, bout = L.sbb64(a, b, cin)
        ts, tcout = I.adc(ta, tb, tcin)
        td, tbout = I.sbb(ta, tb, tcin)
        out += [(_from_pair(s), _u(ts)), (_b(cout), tcout.numpy()),
                (_from_pair(d), _u(td)), (_b(bout), tbout.numpy())]
    out += [(_from_pair(L.add64(a, b)), _u(ta + tb)),
            (_from_pair(L.sub64(a, b)), _u(ta - tb))]
    for small in (0, 1, 0xFF, 0xFFFFFFFF):
        s = jnp.full(len(CORNERS), small, dtype=jnp.uint32)
        out.append((_from_pair(L.add64_u32(_pair(CORNERS), s)),
                    _u(_t(CORNERS) + small)))
    return out


def _case_logic_compare():
    ax, bx = _cross(CORNERS, CORNERS)
    a, b = _pair(ax), _pair(bx)
    ta, tb = _t(ax), _t(bx)
    return [(_from_pair(L.and64(a, b)), _u(ta & tb)),
            (_from_pair(L.or64(a, b)), _u(ta | tb)),
            (_from_pair(L.xor64(a, b)), _u(ta ^ tb)),
            (_from_pair(L.not64(a)), _u(~ta)),
            (_from_pair(L.neg64(a)), _u(-ta)),
            (_b(L.eq64(a, b)), (ta == tb).numpy()),
            (_b(L.ltu64(a, b)), I.ltu(ta, tb).numpy()),
            (_b(L.leu64(a, b)), I.leu(ta, tb).numpy()),
            (_b(L.is_zero64(a)), (ta == 0).numpy())]


def _case_shifts_rotates():
    ax, sx = _cross(CORNERS, SHIFTS)
    a = _pair(ax)
    s = jnp.asarray(np.array(sx, dtype=np.uint32))
    ta, ts = _t(ax), torch.tensor(sx)
    return [(_from_pair(L.shl64(a, s)), _u(I.shl(ta, ts))),
            (_from_pair(L.shr64(a, s)), _u(I.shr(ta, ts))),
            (_from_pair(L.sar64(a, s)), _u(I.sar(ta, ts))),
            (_from_pair(L.rol64(a, s)), _u(I.rol(ta, ts))),
            (_from_pair(L.ror64(a, s)), _u(I.ror(ta, ts)))] + [
        (_from_pair(L.shl64_const(_pair(CORNERS), k)),
         _u(I.shl(_t(CORNERS), k))) for k in (0, 1, 7, 31, 32, 33, 63)] + [
        (_from_pair(L.shr64_const(_pair(CORNERS), k)),
         _u(I.shr(_t(CORNERS), k))) for k in (0, 1, 7, 31, 32, 33, 63)]


def _case_products_hashes():
    ax, bx = _cross(CORNERS, CORNERS)
    a, b = _pair(ax), _pair(bx)
    ta, tb = _t(ax), _t(bx)
    return [(_from_pair(L.mul64_lo(a, b)), _u(ta * tb)),
            (_from_pair(L.umulhi64(a, b)), _u(I.umulhi(ta, tb))),
            (_from_pair(L.smulhi64(a, b)), _u(I.smulhi(ta, tb))),
            (_from_pair(L.splitmix64(_pair(CORNERS))),
             _u(I.splitmix64(_t(CORNERS)))),
            (_from_pair(L.mix64(_pair(CORNERS))), _u(I.mix64(_t(CORNERS))))]


def _case_widths():
    out = []
    for nbytes in (0, 1, 2, 3, 4, 5, 8, 9):
        n = jnp.full(len(CORNERS), nbytes, dtype=jnp.int32)
        tn = torch.full((len(CORNERS),), nbytes)
        a, ta = _pair(CORNERS), _t(CORNERS)
        out += [(_from_pair(L.zext(a, n)), _u(I.zext(ta, tn))),
                (_from_pair(L.sext(a, n)), _u(I.sext(ta, tn))),
                (_b(L.msb(a, n)), I.msb(ta, tn).numpy()),
                (_from_pair(L.size_mask(n)), _u(I.size_mask(tn)))]
    return out


def _case_flags():
    out = []
    for nbytes in (1, 2, 4, 8):
        m = (1 << nbytes * 8) - 1
        ops = [v & m for v in CORNERS]
        ax, bx = _cross(ops, ops)
        a, b = _pair(ax), _pair(bx)
        ta, tb = _t(ax), _t(bx)
        n = jnp.full(len(ax), nbytes, dtype=jnp.int32)
        tn = torch.full((len(ax),), nbytes)
        for carry in (False, True):
            cin = jnp.full(len(ax), carry)
            tcin = torch.full((len(ax),), carry)
            r_add = L.zext(L.adc64(a, b, cin)[0], n)
            r_sub = L.zext(L.sbb64(a, b, cin)[0], n)
            tr_add = I.zext(I.adc(ta, tb, tcin)[0], tn)
            tr_sub = I.zext(I.sbb(ta, tb, tcin)[0], tn)
            out += [(np.asarray(L.flags_add(a, b, r_add, n, cin)),
                     I.flags_add(ta, tb, tr_add, tn, tcin).numpy()),
                    (np.asarray(L.flags_sub(a, b, r_sub, n, cin)),
                     I.flags_sub(ta, tb, tr_sub, tn, tcin).numpy())]
        r = L.zext(L.and64(a, b), n)
        out.append((np.asarray(L.flags_logic(r, n)),
                    I.flags_logic(I.zext(ta & tb, tn), tn).numpy()))
        out.append((_b(L.parity_even(a[0])), I.parity_even(ta).numpy()))
    return [(np.asarray(w).astype(np.int64), g) for w, g in out]


def _case_eval_cond():
    flags = []
    for mask in range(32):
        flags.append((mask & 1) * L.CF | ((mask >> 1) & 1) * L.PF
                     | ((mask >> 2) & 1) * L.ZF | ((mask >> 3) & 1) * L.SF
                     | ((mask >> 4) & 1) * L.OF)
    out = []
    for cc in range(18):
        for rcx in (0, 1, 0xFFFFFFFF, 0x100000000, 0x1_0000_0001):
            rf = jnp.asarray(np.array(flags, dtype=np.uint32))
            want = L.eval_cond(rf, _pair([rcx] * len(flags)), jnp.int32(cc))
            got = I.eval_cond(torch.tensor(flags), _t([rcx] * len(flags)),
                              cc)
            out.append((_b(want), got.numpy()))
    return out


def _case_division():
    """The JAX step divides u64 (`//`, `%`) and s64 (lax.div / lax.rem)
    with the divisor made safe; INT64_MIN / -1 is guarded there too."""
    ax, bx = _cross(CORNERS, [b for b in CORNERS if b])
    a = np.array(ax, dtype=np.uint64)
    b = np.array(bx, dtype=np.uint64)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    q, r = I.udivmod(_t(ax), _t(bx))
    sa, sb = ja.astype(jnp.int64), jb.astype(jnp.int64)
    edge = (sa == jnp.int64(-2**63)) & (sb == jnp.int64(-1))
    safe = jnp.where(edge, jnp.int64(1), sb)
    sq, sr = I.sdivmod(_t(ax), _t(bx))
    out = [(np.asarray(ja // jb), _u(q)), (np.asarray(ja % jb), _u(r)),
           (np.asarray(lax.div(sa, safe)).view(np.uint64), _u(sq)),
           (np.asarray(lax.rem(sa, safe)).view(np.uint64), _u(sr))]
    # a zero divisor reads as 1 (its lanes raise #DE in the step)
    zq, zr = I.sdivmod(_t(CORNERS), torch.zeros(len(CORNERS),
                                                dtype=torch.int64))
    out += [(np.array(CORNERS, dtype=np.uint64), _u(zq)),
            (np.zeros(len(CORNERS), dtype=np.uint64), _u(zr))]
    return out


def _case_bit_counts():
    from wtf_tpu.interp import step as JS

    a = jnp.asarray(np.array(CORNERS, dtype=np.uint64))
    ta = _t(CORNERS)
    out = [(np.asarray(JS._popcnt(a)), _u(I.popcnt(ta))),
           (np.asarray(JS._bitlen(a)), _u(I.bitlen(ta)))]
    for nbytes in (2, 4, 8):
        want = [int.from_bytes((v & ((1 << nbytes * 8) - 1)).to_bytes(
            nbytes, "little"), "big") for v in CORNERS]
        out.append((np.array(want, dtype=np.uint64),
                    _u(I.bswap(ta, torch.full((len(CORNERS),), nbytes)))))
    ax, bx = _cross(CORNERS, CORNERS)

    def pext(src, mask):
        bits = [(src >> i) & 1 for i in range(64) if (mask >> i) & 1]
        return sum(b << k for k, b in enumerate(bits))

    def pdep(src, mask):
        pos = [i for i in range(64) if (mask >> i) & 1]
        return sum(((src >> k) & 1) << i for k, i in enumerate(pos))

    out += [(np.array([pext(s, m) for s, m in zip(ax, bx)], dtype=np.uint64),
             _u(I.pext(_t(ax), _t(bx)))),
            (np.array([pdep(s, m) for s, m in zip(ax, bx)], dtype=np.uint64),
             _u(I.pdep(_t(ax), _t(bx))))]
    return out


CASES = {
    "add_sub_carry": _case_add_sub,
    "logic_compare": _case_logic_compare,
    "shifts_rotates": _case_shifts_rotates,
    "products_hashes": _case_products_hashes,
    "widths": _case_widths,
    "flags": _case_flags,
    "eval_cond": _case_eval_cond,
    "division": _case_division,
    "bit_counts": _case_bit_counts,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ints_match_limbs_on_corner_grids(case):
    for i, (want, got) in enumerate(CASES[case]()):
        assert want.shape == got.shape, (case, i)
        bad = np.nonzero(want != got)[0]
        assert not len(bad), (case, i, bad[:5], want[bad[:5]], got[bad[:5]])
