"""Streaming coverage deltas: the cursor state machines behind WTF3.

The v1/v2 wire ships each new-coverage result's WHOLE coverage set —
O(covered blocks) u64 addresses per result, forever.  The `[words, 32]`
bit-plane formulation of coverage makes the delta trivially cheap to
extract instead: a lane's newly-set bits are one XOR/AND against the
client's last-acked aggregate, and popcount tells how many.  A WTF3
connection therefore sends, per result, only the bits the master has
not acked — as sparse (word index, u32 mask) pairs over the CLIENT's
own bit space — plus incremental bit->address table registrations so
the master can map them into its global address set.

Cursor protocol (all state machines in this module):

  client side   `DeltaCursor` tracks the acked aggregate + the one
                in-flight (pending) delta of a lock-step link.  A WORK
                frame is the implicit ack (the master only serves after
                accounting); a TAG_CURSOR frame after (re)connect is
                the explicit resync point: the master names the cursor
                it holds for this client identity, the client compares
                against its acked state (with and without the pending
                fold) and either resumes sparse deltas or resets to a
                whole-bitmap resync.
  server side   `ServerCursor` holds the per-client bit->address table
                + acked bitmap, maps incoming delta frames to address
                sets (idempotent under re-sends — the merge is a set
                union), and is what the master persists alongside its
                coverage file so a RESTARTED master can resume client
                cursors instead of forcing whole-bitmap resyncs.

Loss recovery never needs retransmission bookkeeping beyond the acked
bitmap: the next delta is always extracted against *acked*, so anything
lost in flight is simply re-extracted — the OR-merge makes duplicates
free.
"""

from __future__ import annotations

import hashlib
import os
import struct
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from wtf_tpu_torch.dist import wire

MASK32 = 0xFFFFFFFF


def cursor_digest(table: Sequence[int], words: np.ndarray,
                  n_table: int) -> bytes:
    """8-byte digest of an ack-cursor state: the first `n_table` table
    addresses plus the acked bitmap canonicalized to ceil(n_table/32)
    words (zero-padded — client and server arrays may differ in
    allocation length but never in set bits)."""
    h = hashlib.blake2b(digest_size=8)
    h.update(struct.pack("<I", n_table))
    h.update(struct.pack(f"<{n_table}Q", *[int(a) for a in
                                           table[:n_table]]))
    n_words = (n_table + 31) // 32
    canon = np.zeros(n_words, np.uint32)
    src = np.asarray(words[:n_words], np.uint32)
    canon[:len(src)] = src
    h.update(canon.tobytes())
    return h.digest()


def _grow(words: np.ndarray, n: int) -> np.ndarray:
    if len(words) >= n:
        return words
    out = np.zeros(n, np.uint32)
    out[:len(words)] = words
    return out


def _or_words(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = _grow(a.copy(), len(b))
    out[:len(b)] |= b
    return out


def pairs_of(words: np.ndarray) -> List[Tuple[int, int]]:
    """Sparse (word index, mask) encoding of a bitmap's nonzero words."""
    idx = np.nonzero(words)[0]
    return [(int(i), int(words[i])) for i in idx]


def popcount(words) -> int:
    if hasattr(np, "bitwise_count"):
        return int(np.bitwise_count(np.asarray(words, np.uint32)).sum())
    return sum(bin(int(w)).count("1") for w in np.asarray(words).ravel())


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------

class DeltaCursor:
    """Client-side ack-cursor for one master link (lock-step framing).

    Subclasses own the bit space and feed per-result deltas through
    `_emit`; this base holds the acked/pending bookkeeping, the cursor
    handshake, and the wire-byte accounting (`dist.cov_bytes_delta` vs
    `dist.cov_bytes_bitmap` — the measured delta-vs-whole-bitmap ratio
    the soak asserts on)."""

    def __init__(self, client_id: Optional[bytes] = None, registry=None):
        self.client_id = client_id or os.urandom(wire.CLIENT_ID_LEN)
        self.registry = registry
        self._acked_table = 0
        self._acked = np.zeros(0, np.uint32)
        # the one in-flight delta of a lock-step link: (words, table_len)
        self._pending: Optional[Tuple[np.ndarray, int]] = None
        # whole-bitmap resync owed (first contact / cursor mismatch)
        self._force_full = True
        self.full_resyncs = 0

    # -- the bit space (subclass) ---------------------------------------
    def _table(self) -> Sequence[int]:
        raise NotImplementedError

    # -- link callbacks (MasterLink drives these) -----------------------
    def on_cursor(self, n_table: int, digest: bytes) -> None:
        """TAG_CURSOR arrived after (re)connect: resolve our state
        against the cursor the master holds.  Three outcomes: the master
        saw our pending frame (fold it), it did not (drop pending — the
        bits stay unacked and re-extract into the next delta), or it
        holds something else entirely (fresh/older master: reset to a
        whole-bitmap resync)."""
        table = self._table()
        if self._pending is not None:
            words, tlen = self._pending
            folded = _or_words(self._acked, words)
            n = max(self._acked_table, tlen)
            if n == n_table and cursor_digest(table, folded, n) == digest:
                self._acked, self._acked_table = folded, n
                self._pending = None
                self._force_full = False
                return
        self._pending = None
        if (self._acked_table == n_table
                and cursor_digest(table, self._acked,
                                  self._acked_table) == digest):
            self._force_full = False
            return
        # cursor lost (restarted master without persisted cursors, or a
        # different master): whole-bitmap resync on the next frame
        self._acked_table = 0
        self._acked = np.zeros(0, np.uint32)
        self._force_full = True

    def on_ack(self) -> None:
        """A WORK frame landed: the master accounted everything we sent
        on this connection (it only serves after handling the result)."""
        if self._pending is not None:
            words, tlen = self._pending
            self._acked = _or_words(self._acked, words)
            self._acked_table = max(self._acked_table, tlen)
            self._pending = None

    # -- delta extraction ------------------------------------------------
    def unacked(self, current: np.ndarray) -> np.ndarray:
        """`current & ~acked`: every bit the master has not acked —
        including bits lost with a dropped frame, which is the whole
        loss-recovery story (re-extraction, not retransmission)."""
        out = np.array(current, np.uint32, copy=True)
        n = min(len(out), len(self._acked))
        out[:n] &= ~self._acked[:n]
        return out

    def _emit(self, testcase: bytes, result, delta_words: np.ndarray,
              table_len: int, bucket: str = "",
              full_equiv_bits: int = 0, first: bool = True) -> bytes:
        """Encode one delta-result body and note it as pending.  `first`
        is False for the 2nd..Nth bodies of one mux batch frame (they
        share the first body's full flag + table registration watermark).
        `full_equiv_bits` is what a v1/v2 client would have shipped for
        this result (|whole coverage set|), for the byte accounting."""
        full = self._force_full and first
        pairs = pairs_of(delta_words)
        if pairs or full:
            base = self._acked_table if not full else 0
            if self._pending is not None:
                base = max(base, self._pending[1])
            addrs = [int(a) for a in self._table()[base:table_len]]
        else:
            base, addrs, table_len = self._acked_table, [], self._acked_table
        frame = wire.DeltaFrame(full, base, addrs, pairs)
        body = wire.encode_result_delta(testcase, result, frame, bucket)
        if pairs or full:
            prev_words = (self._pending[0] if self._pending is not None
                          else np.zeros(0, np.uint32))
            prev_tlen = (self._pending[1] if self._pending is not None
                         else 0)
            self._pending = (_or_words(prev_words, delta_words),
                             max(prev_tlen, table_len))
        if full:
            self.full_resyncs += 1
            self._force_full = False
        if self.registry is not None:
            self.registry.counter("dist.cov_bytes_delta").inc(
                frame.cov_bytes())
            # what the v1/v2 coverage section would have cost for this
            # exact result: u32 n_cov + 8 bytes per address of the
            # whole set (0 addresses for revoked/no-new results)
            self.registry.counter("dist.cov_bytes_bitmap").inc(
                4 + 8 * full_equiv_bits)
        return body

    @property
    def wants_full(self) -> bool:
        return self._force_full

    def encode_empty(self, testcase: bytes, result,
                     bucket: str = "") -> bytes:
        """A zero-coverage body that carries NO delta bits and touches
        no cursor state — for results whose coverage is revoked
        (timeouts, overlay-full): unacked repair must never ride them,
        or the master would credit a hang-inducing testcase with lost
        coverage and admit it to the corpus."""
        frame = wire.DeltaFrame(False, self._acked_table, [], [])
        if self.registry is not None:
            self.registry.counter("dist.cov_bytes_delta").inc(
                frame.cov_bytes())
            self.registry.counter("dist.cov_bytes_bitmap").inc(4)
        return wire.encode_result_delta(testcase, result, frame, bucket)


class AddressDeltaCursor(DeltaCursor):
    """Delta cursor over an address-set coverage source (the emu/oracle
    backends, and the per-lane links of a non-mux batch node): bit
    indices are assigned in first-seen order, the client-side analog of
    the decode cache's insertion order."""

    def __init__(self, client_id: Optional[bytes] = None, registry=None):
        super().__init__(client_id, registry)
        self._addr_index: Dict[int, int] = {}
        self._table_list: List[int] = []
        self._current = np.zeros(0, np.uint32)

    def _table(self) -> Sequence[int]:
        return self._table_list

    def feed(self, coverage: Set[int]) -> None:
        """Record a result's coverage set into the client bit space."""
        for addr in coverage:
            idx = self._addr_index.get(addr)
            if idx is None:
                idx = len(self._table_list)
                self._addr_index[addr] = idx
                self._table_list.append(int(addr))
            self._current = _grow(self._current, idx // 32 + 1)
            self._current[idx // 32] |= np.uint32(1 << (idx % 32))

    def encode_result(self, testcase: bytes, result,
                      coverage: Optional[Set[int]] = None,
                      bucket: str = "") -> bytes:
        """One result -> one delta body.  `coverage` is the result's
        whole coverage set (None/empty for results with nothing new to
        report — the frame still repairs any unacked bits)."""
        full_bits = len(coverage) if coverage else 0
        if coverage:
            self.feed(coverage)
        delta = self.unacked(self._current)
        return self._emit(testcase, result, delta, len(self._table_list),
                          bucket=bucket, full_equiv_bits=full_bits)

    def has_unacked(self) -> bool:
        return self.wants_full or bool(np.any(self.unacked(self._current)))


class BitmapDeltaCursor(DeltaCursor):
    """Delta cursor over the batched backend's native bit space: bit i
    IS decode-cache entry i, so delta extraction is exactly the
    XOR/popcount the `[words, 32]` formulation promises — no address-set
    decode on the hot path.  One cursor per mux link."""

    def __init__(self, backend, client_id: Optional[bytes] = None,
                 registry=None):
        super().__init__(client_id, registry)
        self._backend = backend
        self._rips: List[int] = []

    def _table(self) -> Sequence[int]:
        cache = self._backend.runner.cache
        while len(self._rips) < cache.count:
            self._rips.append(int(cache.rip_of(len(self._rips))))
        return self._rips

    def table_len(self) -> int:
        return len(self._table())

    def encode_lane(self, testcase: bytes, result,
                    lane_words: Optional[np.ndarray], claimed: np.ndarray,
                    bucket: str = "", first: bool = True) -> bytes:
        """One lane's body within a batch frame.  `lane_words` is the
        lane's coverage bitmap (None for lanes with nothing to report);
        `claimed` accumulates the bits earlier lanes of this batch
        already carry, so each new bit rides exactly one body."""
        if lane_words is None:
            delta = np.zeros(0, np.uint32)
            full_bits = 0
        else:
            delta = self.unacked(lane_words)
            n = min(len(delta), len(claimed))
            delta[:n] &= ~claimed[:n]
            claimed[:len(delta)] |= delta
            full_bits = popcount(lane_words)
        return self._emit(testcase, result, delta, self.table_len(),
                          bucket=bucket, full_equiv_bits=full_bits,
                          first=first)


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------

class ServerCursor:
    """Master-side per-client ack cursor: the client's bit->address
    table plus the acked bitmap.  `apply` maps a delta frame to the
    address set the rest of the master already understands; re-applied
    frames are free (set-union merge).  `state`/`from_state` are the
    persistence hooks the master's coverage file uses so client cursors
    survive a master restart."""

    def __init__(self):
        self.table: List[int] = []
        self.words = np.zeros(0, np.uint32)
        # LRU bookkeeping for the master's eviction policy (a cursor is
        # a near-copy of the address table per client identity, and
        # identities are fresh per node process — dead ones must not
        # accumulate forever).  Not part of the digest.
        import time

        self.last_seen = time.time()

    def touch(self) -> None:
        import time

        self.last_seen = time.time()

    def summary(self) -> Tuple[int, bytes]:
        n = len(self.table)
        return n, cursor_digest(self.table, self.words, n)

    def apply(self, frame: wire.DeltaFrame) -> Set[int]:
        """Merge one delta frame; returns the addresses its bits name.
        Raises ValueError on protocol violations (table gaps, conflicting
        re-registrations, bits beyond the table) — the master treats
        that like any malformed frame: drop the node, reclaim its work."""
        self.touch()
        if frame.full:
            self.table = []
            self.words = np.zeros(0, np.uint32)
        base = frame.table_base
        if base > len(self.table):
            raise ValueError(
                f"delta table gap (base {base}, have {len(self.table)})")
        for i, addr in enumerate(frame.addrs):
            idx = base + i
            if idx < len(self.table):
                if self.table[idx] != addr:
                    raise ValueError(f"delta table conflict at bit {idx}")
            else:
                self.table.append(int(addr))
        out: Set[int] = set()
        if frame.pairs:
            self.words = _grow(self.words,
                               max(w for w, _ in frame.pairs) + 1)
            for word_idx, mask in frame.pairs:
                mask = int(mask) & MASK32
                base_bit = word_idx * 32
                self.words[word_idx] |= np.uint32(mask)
                while mask:
                    low = mask & -mask
                    idx = base_bit + low.bit_length() - 1
                    if idx >= len(self.table):
                        raise ValueError(
                            f"delta bit {idx} beyond table "
                            f"({len(self.table)} entries)")
                    out.add(self.table[idx])
                    mask ^= low
        return out

    # -- persistence (the master's coverage file) ------------------------
    def state(self) -> dict:
        return {"table": list(self.table),
                "words": self.words.tobytes().hex()}

    @classmethod
    def from_state(cls, state: dict) -> "ServerCursor":
        cur = cls()
        cur.table = [int(a) for a in state.get("table", [])]
        raw = bytes.fromhex(state.get("words", ""))
        cur.words = np.frombuffer(raw, np.uint32).copy()
        return cur
