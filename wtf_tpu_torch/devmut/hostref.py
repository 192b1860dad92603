"""devmangle host reference: the authoritative, jax-free op spec.

The device engine (wtf_tpu/devmut/engine.py) and this module implement
the SAME algorithm — one vectorized over lanes in u32 XLA ops, one as
plain Python ints — and the property tests (tests/test_devmut.py) pin
them bit-for-bit against each other.  When the two disagree, THIS file
is the spec: every op below is written as the scalar loop the device
formulas must reproduce.

Algorithm (per lane, per batch):

  PRNG      splitmix64 stream (utils.hashing semantics, matching
            interp/limbs.py bit-for-bit): state += GOLDEN; out =
            mix64(state).  All derived quantities use the LOW 32 bits
            of a draw (the device holds draws as u32 limb pairs).
  draws     r_slot, r_len, r_fill, r_other up front, then exactly
            (r_op, r1, r2, r3) per mangle round — the draw count is
            fixed so device and host streams can never skew.
  base      weighted corpus-slot pick (cumulative-weight inverse); an
            empty corpus synthesizes 1..64 fresh bytes from the stream.
  rounds    `rounds` mangle ops, each drawn uniformly from the 8-op
            table (honggfuzz-mangle classes, reference mutator.h role):
            byte/word overwrite, arith delta, magic value, block copy,
            insert(dup), erase, splice/cross-over with a second slot.
  invariant 1 <= len <= max_len always; bytes at positions >= len are
            ZERO after every round (the padded-slab contract device
            insertion relies on for deterministic page contents).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from wtf_tpu_torch.fuzz.mutator import _MAGIC
from wtf_tpu_torch.utils.hashing import MASK64, mix64

GOLDEN = 0x9E3779B97F4A7C15
M32 = 0xFFFFFFFF

# op table (order is the wire format of `op = r_op % N_OPS`; changing it
# changes every seeded campaign's stream)
OP_BYTE, OP_WORD, OP_ARITH, OP_MAGIC = 0, 1, 2, 3
OP_COPY, OP_INSERT, OP_ERASE, OP_SPLICE = 4, 5, 6, 7
N_OPS = 8
OP_NAMES = ("byte", "word", "arith", "magic",
            "copy", "insert", "erase", "splice")

# magic-value table shared with the host mangle engine (one table, one
# campaign behavior); padded to 8 bytes device-side
MAGIC: Tuple[bytes, ...] = tuple(_MAGIC)
N_MAGIC = len(MAGIC)
MAG_BYTES_NP = np.zeros((N_MAGIC, 8), dtype=np.uint32)
MAG_LEN_NP = np.zeros((N_MAGIC,), dtype=np.uint32)
for _i, _m in enumerate(MAGIC):
    MAG_LEN_NP[_i] = len(_m)
    for _j, _c in enumerate(_m):
        MAG_BYTES_NP[_i, _j] = _c

# favor weight for coverage-increasing finds vs plain seeds (weight 1)
FAVOR_WEIGHT = 4


def _mix64_np(z: np.ndarray) -> np.ndarray:
    """mix64 vectorized over uint64 arrays (wrapping multiply), bit-exact
    with utils.hashing.mix64 — asserted by tests/test_devmut.py."""
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def lane_seeds(seed: int, batch: int, n_lanes: int) -> np.ndarray:
    """Per-lane PRNG seeds as uint32[L, 2] limb pairs: a splitmix-style
    stream indexed by the flat (batch, lane) counter — deterministic for
    a given campaign seed, distinct across lanes AND batches.
    Vectorized (this runs on every batch dispatch; a python loop here
    would put O(n_lanes) host work back on the mutate path)."""
    idx = np.arange(n_lanes, dtype=np.uint64)
    counter = np.uint64(batch % (1 << 64)) * np.uint64(n_lanes) + idx \
        + np.uint64(1)
    with np.errstate(over="ignore"):
        s = _mix64_np(np.uint64(seed & MASK64)
                      + np.uint64(GOLDEN) * counter)
    out = np.empty((n_lanes, 2), dtype=np.uint32)
    out[:, 0] = (s & np.uint64(M32)).astype(np.uint32)
    out[:, 1] = (s >> np.uint64(32)).astype(np.uint32)
    return out


class _Stream:
    """The splitmix64 draw stream (device: prng_next on limb pairs)."""

    def __init__(self, seed: int):
        self.state = seed & MASK64

    def draw(self) -> int:
        self.state = (self.state + GOLDEN) & MASK64
        return mix64(self.state)


def _pick_slot(cumw: Sequence[int], r: int) -> int:
    """Weighted slot pick: inverse of the inclusive cumulative-weight
    table (zero-weight slots are never chosen)."""
    total = cumw[-1] if len(cumw) else 0
    rr = (r & M32) % max(total, 1)
    cnt = sum(1 for c in cumw if c <= rr)
    return min(cnt, len(cumw) - 1)


def _slab_bytes(data_u32: np.ndarray, length: int, max_len: int) -> List[int]:
    """One corpus slab row -> byte list (zero-padded to max_len)."""
    raw = np.ascontiguousarray(data_u32).view(np.uint8)[:max_len]
    b = [0] * max_len
    for i in range(min(length, max_len)):
        b[i] = int(raw[i])
    return b


def host_generate_lane(
    data: np.ndarray,        # uint32[S, W] corpus slab
    lens: np.ndarray,        # int32[S]
    cumw: np.ndarray,        # uint32[S] inclusive cumulative weights
    seed: int,               # this lane's 64-bit seed
    rounds: int,
    op_trace: Optional[List[int]] = None,
) -> Tuple[bytes, int]:
    """Generate ONE lane's testcase; returns (padded bytes[max_len], len).
    `op_trace`, when given, collects the op code of every round (test
    instrumentation for op-coverage assertions)."""
    max_len = data.shape[1] * 4
    st = _Stream(seed)
    r_slot, r_len, r_fill, r_other = (st.draw(), st.draw(), st.draw(),
                                      st.draw())
    total = int(cumw[-1]) if len(cumw) else 0

    if total > 0:
        slot = _pick_slot(cumw, r_slot)
        ln = max(1, min(int(lens[slot]), max_len))
        b = _slab_bytes(data[slot], ln, max_len)
    else:
        ln = 1 + ((r_len & M32) % min(64, max_len))
        ln = max(1, min(ln, max_len))
        b = [0] * max_len
        for i in range(ln):
            b[i] = mix64((r_fill + i) & MASK64) & 0xFF
    for i in range(ln, max_len):
        b[i] = 0

    if total > 0:
        oslot = _pick_slot(cumw, r_other)
        oln = max(1, min(int(lens[oslot]), max_len))
        ob = _slab_bytes(data[oslot], oln, max_len)
    else:
        ob, oln = list(b), ln

    for _ in range(rounds):
        r_op, r1, r2, r3 = st.draw(), st.draw(), st.draw(), st.draw()
        op = (r_op & M32) % N_OPS
        if op_trace is not None:
            op_trace.append(op)
        snap = list(b)
        if op == OP_BYTE:
            pos = (r1 & M32) % ln
            b[pos] = r2 & 0xFF
        elif op == OP_WORD:
            pos = (r1 & M32) % ln
            for j in range(4):
                if pos + j < ln:
                    b[pos + j] = (r2 >> (8 * j)) & 0xFF
        elif op == OP_ARITH:
            pos = (r1 & M32) % ln
            delta = (((r2 & M32) % 71) + 221) & 0xFF
            b[pos] = (b[pos] + delta) & 0xFF
        elif op == OP_MAGIC:
            m = (r1 & M32) % N_MAGIC
            pos = (r2 & M32) % ln
            for j, c in enumerate(MAGIC[m]):
                if pos + j < ln:
                    b[pos + j] = c
        elif op == OP_COPY:
            src = (r1 & M32) % ln
            dst = (r2 & M32) % ln
            k = 1 + ((r3 & M32) % 16)
            for j in range(k):
                if dst + j < ln and src + j < ln:
                    b[dst + j] = snap[src + j]
        elif op == OP_INSERT:
            pos = (r1 & M32) % ln
            k = min(1 + ((r2 & M32) % 16), max_len - ln)
            if k:
                b = (snap[:pos + k] + snap[pos:max_len - k])[:max_len]
                ln += k
        elif op == OP_ERASE:
            if ln > 1:
                pos = (r1 & M32) % ln
                k = min(1 + ((r2 & M32) % 16), ln - pos, ln - 1)
                b = (snap[:pos] + snap[pos + k:] + [0] * k)[:max_len]
                ln -= k
        else:  # OP_SPLICE
            cut = (r2 & M32) % (ln + 1)
            cut2 = (r3 & M32) % (oln + 1)
            take = min(oln - cut2, max_len - cut)
            new_ln = max(1, cut + take)
            b = [(snap[i] if i < cut
                  else ob[min(cut2 + (i - cut), max_len - 1)])
                 for i in range(new_ln)] + [0] * (max_len - new_ln)
            ln = new_ln
        for i in range(ln, max_len):
            b[i] = 0

    return bytes(b), ln


def host_generate(
    data: np.ndarray,
    lens: np.ndarray,
    cumw: np.ndarray,
    seeds: np.ndarray,       # uint32[L, 2] from lane_seeds()
    rounds: int,
    op_trace: Optional[List[int]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """The whole-batch mirror of engine.generate: returns
    (words uint32[L, W], lens int32[L])."""
    n_lanes = seeds.shape[0]
    words = np.zeros((n_lanes, data.shape[1]), dtype=np.uint32)
    out_lens = np.zeros((n_lanes,), dtype=np.int32)
    for lane in range(n_lanes):
        seed = int(seeds[lane, 0]) | (int(seeds[lane, 1]) << 32)
        raw, ln = host_generate_lane(data, lens, cumw, seed, rounds,
                                     op_trace=op_trace)
        words[lane] = np.frombuffer(raw, dtype=np.uint8).view(
            np.uint32).copy()
        out_lens[lane] = ln
    return words, out_lens
