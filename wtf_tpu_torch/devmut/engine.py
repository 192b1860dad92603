"""The device mangle engine: a whole batch of testcases as tensor code.

The counterpart of wtf_tpu/devmut/engine.py (`generate`, engine.py:77-213):
one `generate` call produces every lane's next testcase from the corpus
slab (devmut/corpus.py) with one splitmix64 stream per lane and the 8-op
mangle table (hostref.OP_NAMES) over `[lanes, max_len]` byte planes, then
packs the bytes back into the u32 words the insert seam
(interp/runner.py `device_insert_impl`) writes into the lane overlays.
devmut/hostref.py is the spec; the result equals it bit for bit.

Representation: the JAX engine holds every value as u32 limb pairs; here
the PRNG state is one int64 (the u64 bits, two's complement, so the
GOLDEN add wraps mod 2**64 like the limb add), each draw's low 32 bits
are an int64 in [0, 2**32), and byte planes are int64.  Every quantity
derived from a draw is therefore non-negative and `%` on it is the u32
remainder.  The clamped gather of the shifting ops clamps at both ends:
a source the u32 engine computes as a wrapped (huge) value is negative
here, and both are selected away by the op's window.

Positional ops are broadcast compares against an index plane; the
shifting ops (copy, insert, erase, splice) are one gather each.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from wtf_tpu_torch.devmut.hostref import (
    GOLDEN, MAG_BYTES_NP, MAG_LEN_NP, N_MAGIC, N_OPS,
)
from wtf_tpu_torch.interp import ints as I

M32 = 0xFFFFFFFF
_GOLDEN = I.s64(GOLDEN)


def prng_next(state: torch.Tensor):
    """One splitmix64 draw on int64 states: state += GOLDEN; out =
    mix64(state).  Returns (state', out)."""
    state = state + _GOLDEN
    return state, I.mix64(state)


def pick_slot(cumw: torch.Tensor, r32: torch.Tensor) -> torch.Tensor:
    """Weighted corpus-slot pick for draws `r32` (int64 in [0, 2**32)):
    the inverse of the inclusive cumulative-weight table `cumw[S]` —
    count-of-(cumw <= r % total), so zero-weight slots are never chosen.
    Returns int64[L]."""
    total = cumw[-1].clamp(min=1)
    cnt = (cumw[None, :] <= (r32 % total)[:, None]).sum(1)
    return cnt.clamp(max=cumw.shape[0] - 1)


def unpack_bytes(rows: torch.Tensor) -> torch.Tensor:
    """Packed words [..., W] (int32 holding u32 bits) -> int64 byte plane
    [..., 4W] (little-endian)."""
    shifts = torch.tensor([0, 8, 16, 24], device=rows.device)
    b = (rows.long()[..., None] >> shifts) & 0xFF
    return b.reshape(rows.shape[:-1] + (rows.shape[-1] * 4,))


def pack_words(b: torch.Tensor) -> torch.Tensor:
    """int64 byte plane [..., 4W] -> packed words [..., W] as int32
    holding the u32 bits."""
    w = (b[..., 0::4] | (b[..., 1::4] << 8) | (b[..., 2::4] << 16)
         | (b[..., 3::4] << 24))
    return torch.where(w > 0x7FFFFFFF, w - (1 << 32), w).to(torch.int32)


def seeds_from_pairs(pairs: np.ndarray, device) -> torch.Tensor:
    """hostref.lane_seeds' uint32 [..., 2] (lo, hi) limb pairs -> the
    int64 seeds [...] `generate` takes."""
    s = np.ascontiguousarray(pairs, dtype=np.uint32).view(np.int64)
    return torch.from_numpy(s[..., 0].copy()).to(device)


def generate(data: torch.Tensor, lens: torch.Tensor, cumw: torch.Tensor,
             seeds: torch.Tensor, rounds: int = 5
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generate one testcase per lane.

    data  int32[S, W]   corpus slab (u32 bits; zero-padded past each
                        length)
    lens  int32[S]      per-slot byte lengths (>= 1 for live slots)
    cumw  int64[S]      inclusive cumulative favor weights (a zero total
                        = empty corpus -> fresh synthesis)
    seeds int64[L]      per-lane splitmix64 seeds (seeds_from_pairs of
                        hostref.lane_seeds)

    Returns (words int32[L, W], lens int32[L]).  Mirror of
    hostref.host_generate — see that module for the op spec.
    """
    dev = data.device
    n_words = data.shape[1]
    n_lanes = seeds.shape[0]
    ml = n_words * 4
    idx = torch.arange(ml, device=dev).expand(n_lanes, ml)
    mag_bytes = torch.from_numpy(MAG_BYTES_NP.astype(np.int64)).to(dev)
    mag_lens = torch.from_numpy(MAG_LEN_NP.astype(np.int64)).to(dev)

    def take(b, src):
        """b[lane, src] with the source clamped into the window (clamped
        positions are selected away by every caller)."""
        return b.gather(1, src.clamp(0, ml - 1))

    st = seeds
    st, r_slot = prng_next(st)
    st, r_len = prng_next(st)
    st, r_fill = prng_next(st)
    st, r_other = prng_next(st)

    have = cumw[-1] > 0

    def slab_row(r):
        slot = pick_slot(cumw, r & M32)
        return unpack_bytes(data[slot]), lens[slot].long().clamp(1, ml)

    base_b, base_ln = slab_row(r_slot)
    # empty-corpus synthesis: 1..64 stream bytes (generate_fresh role)
    fresh_ln = 1 + (r_len & M32) % min(64, ml)
    fill = I.mix64(r_fill[:, None] + idx) & 0xFF
    b = torch.where(have, base_b, fill)
    ln = torch.where(have, base_ln, fresh_ln.clamp(max=ml)).clamp(min=1)
    b = torch.where(idx < ln[:, None], b, 0)

    # splice partner: drawn once per testcase (self when corpus empty)
    ob_slab, oln_slab = slab_row(r_other)
    ob = torch.where(have, ob_slab, b)
    oln = torch.where(have, oln_slab, ln)

    for _ in range(rounds):
        st, r_op = prng_next(st)
        st, r1 = prng_next(st)
        st, r2 = prng_next(st)
        st, r3 = prng_next(st)
        op = (r_op & M32) % N_OPS
        x1, x2, x3 = r1 & M32, r2 & M32, r3 & M32
        lnc = ln[:, None]

        # 0/1/2: byte overwrite / word overwrite / arith delta at x1%len
        pos = (x1 % ln)[:, None]
        b_byte = torch.where(idx == pos, (x2 & 0xFF)[:, None], b)
        wwin = (idx >= pos) & (idx < pos + 4) & (idx < lnc)
        wsh = ((idx - pos) & 3) * 8
        b_word = torch.where(wwin, (x2[:, None] >> wsh) & 0xFF, b)
        delta = ((x2 % 71) + 221) & 0xFF
        b_arith = torch.where(idx == pos, (b + delta[:, None]) & 0xFF, b)

        # 3: magic value (clipped to len)
        mi = x1 % N_MAGIC
        mpos = (x2 % ln)[:, None]
        mwin = (idx >= mpos) & (idx < mpos + mag_lens[mi][:, None]) \
            & (idx < lnc)
        b_magic = torch.where(mwin, mag_bytes[mi].gather(
            1, (idx - mpos) & 7), b)

        # 4: block copy (reads the round-input bytes)
        cdst = (x2 % ln)[:, None]
        sidx = (x1 % ln)[:, None] + (idx - cdst)
        cwin = ((idx >= cdst) & (idx < cdst + (1 + x3 % 16)[:, None])
                & (idx < lnc) & (sidx < lnc))
        b_copy = torch.where(cwin, take(b, sidx), b)

        # 5: insert — duplicate the k bytes at pos, tail shifts right
        ipos = x1 % ln
        ik = torch.minimum(1 + x2 % 16, ml - ln)
        b_ins = take(b, torch.where(idx < (ipos + ik)[:, None], idx,
                                    idx - ik[:, None]))

        # 6: erase k bytes at pos (len stays >= 1)
        epos = x1 % ln
        ek = torch.minimum(torch.minimum(1 + x2 % 16, ln - epos), ln - 1)
        ek = torch.where(ln > 1, ek, 0)
        b_erase = take(b, torch.where(idx < epos[:, None], idx,
                                      idx + ek[:, None]))

        # 7: splice — our prefix [0, cut) + partner's bytes from cut2
        cut = x2 % (ln + 1)
        cut2 = x3 % (oln + 1)
        stake = torch.minimum(oln - cut2, ml - cut)
        b_spl = torch.where(idx < cut[:, None], b,
                            take(ob, cut2[:, None] + (idx - cut[:, None])))
        ln_spl = (cut + stake).clamp(min=1)

        cands = ((b_byte, ln), (b_word, ln), (b_arith, ln), (b_magic, ln),
                 (b_copy, ln), (b_ins, ln + ik), (b_erase, ln - ek),
                 (b_spl, ln_spl))
        nb, nl = b, ln
        for code, (cb, cl) in enumerate(cands):
            is_op = op == code
            nb = torch.where(is_op[:, None], cb, nb)
            nl = torch.where(is_op, cl, nl)
        # padded-slab contract: bytes past the new length are zero
        b = torch.where(idx < nl[:, None], nb, 0)
        ln = nl
    return pack_words(b), ln.to(torch.int32)
