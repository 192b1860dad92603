"""DeviceCorpus: the device-resident seed slab the devmangle engine reads.

Copied from wtf_tpu/devmut/corpus.py (`DeviceCorpus`, corpus.py:28-209)
with the upload rewritten for PyTorch: the host keeps the authoritative
numpy slab (`[slots, max_len/4]` u32 words, per-slot byte lengths and
favor weights) and `arrays()` copies it onto `device` — the mutator's
device, which the mutator sets — only after a mutating `add`.  On the
device the words are int32 holding the u32 bits and the cumulative
weights int64 (torch has no uint32 arithmetic on the CPU).

Slot policy: fill empty slots first; when full, evict the lowest-weight
slot (first index on ties) — coverage-increasing finds enter with
`hostref.FAVOR_WEIGHT`, plain seeds with weight 1, so favored testcases
both survive eviction longer AND are drawn proportionally more often by
the engine's cumulative-weight pick.

The undo log records each slot's pre-image at its first mutation since
the last upload, so `uploaded_state()` reconstructs the slab exactly as
the device last saw it.  The checkpoint/restore half of the JAX class
waits for the port of wtf_tpu/resume.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from wtf_tpu_torch.utils.hashing import hex_digest


class DeviceCorpus:
    def __init__(self, slots: int, max_len: int, device="cpu"):
        if max_len < 4:
            raise ValueError("devmut max_len must be >= 4 bytes")
        self.slots = slots
        self.max_len = max_len
        self.words = (max_len + 3) // 4
        self.device = torch.device(device)
        self._data = np.zeros((slots, self.words), dtype=np.uint32)
        self._len = np.zeros((slots,), dtype=np.int32)
        self._weight = np.zeros((slots,), dtype=np.uint32)
        self._slot_of: Dict[str, int] = {}   # digest -> slot
        self._digest_of: Dict[int, str] = {}
        self.count = 0
        self._dirty = True
        self._dev: Optional[Tuple] = None
        self._undo: Dict[int, Tuple] = {}
        self._uploaded_count = 0

    def __len__(self) -> int:
        return self.count

    def add(self, data: bytes, weight: int = 1) -> bool:
        """Insert a testcase (truncated to max_len, zero-padded into its
        slot).  Returns False for empties and content duplicates —
        a duplicate re-add BUMPS the existing slot to max(old, weight)
        so a favored re-find upgrades its seed."""
        data = data[:self.max_len]
        if not data:
            return False
        digest = hex_digest(data)
        slot = self._slot_of.get(digest)
        if slot is not None:
            if weight > self._weight[slot]:
                self._note_undo(slot)
                self._weight[slot] = weight
                self._dirty = True
            return False
        if self.count < self.slots:
            slot = self.count
            self.count += 1
        else:
            slot = int(np.argmin(self._weight))
            self._slot_of.pop(self._digest_of.pop(slot, ""), None)
        self._note_undo(slot)
        buf = np.zeros(self.words * 4, dtype=np.uint8)
        buf[:len(data)] = np.frombuffer(data, dtype=np.uint8)
        self._data[slot] = buf.view(np.uint32)
        self._len[slot] = len(data)
        self._weight[slot] = max(weight, 1)
        self._slot_of[digest] = slot
        self._digest_of[slot] = digest
        self._dirty = True
        return True

    def cumulative_weights(self) -> np.ndarray:
        """Inclusive cumulative favor weights (the engine's pick table).
        u32 by contract: weights are small ints, so the total cannot
        approach 2^32 at any plausible slot count."""
        cum = np.cumsum(self._weight, dtype=np.uint64)
        assert cum[-1] < (1 << 32), "favor-weight total overflows u32"
        return cum.astype(np.uint32)

    def arrays(self) -> Tuple:
        """(data int32[S, W], lens int32[S], cumw int64[S]) on `device`;
        copies only when a host-side add dirtied the slab.  Returns a 4th
        element `synced` telling the caller whether this call paid an
        upload.  The tensors are copies: later adds never reach them."""
        synced = False
        if self._dirty or self._dev is None:
            self._dev = (
                torch.tensor(self._data.view(np.int32), device=self.device),
                torch.tensor(self._len, device=self.device),
                torch.tensor(self.cumulative_weights().astype(np.int64),
                             device=self.device))
            self._dirty = False
            synced = True
            # the device now matches the host slab: new undo baseline
            self._undo.clear()
            self._uploaded_count = self.count
        return (*self._dev, synced)

    def arrays_pair(self) -> Tuple:
        """((data, lens, cumw) as-last-uploaded, (data, lens, cumw)
        current, synced) — the megachunk window's two slab views
        (fuzz/megachunk.py slab schedule).  The as-uploaded view is what
        a prelaunched batch would have sampled (the lag-preserving first
        batch of a window); identical to the current view when no add
        landed since the last upload."""
        old = self._dev
        data, lens, cumw, synced = self.arrays()
        if old is None:
            old = (data, lens, cumw)
        return old, (data, lens, cumw), synced

    def _note_undo(self, slot: int) -> None:
        """Record `slot`'s pre-image before its first mutation since the
        last upload."""
        if slot not in self._undo:
            self._undo[slot] = (self._data[slot].copy(),
                                int(self._len[slot]),
                                int(self._weight[slot]))

    def uploaded_state(self) -> dict:
        """The slab exactly as the device last saw it (undo applied over
        the current host slab) — what a prelaunched batch was generated
        from, as host numpy arrays."""
        data = self._data.copy()
        lens = self._len.copy()
        weight = self._weight.copy()
        for slot, (d, ln, wt) in self._undo.items():
            data[slot] = d
            lens[slot] = ln
            weight[slot] = wt
        return {"count": self._uploaded_count, "data": data,
                "lens": lens, "weight": weight}

    def checkpoint_state(self) -> dict:
        """Both slab views a resumable campaign needs: `current` (the
        host-authoritative slab with digests) and `uploaded` (what the
        in-flight prelaunched batch sampled) — host numpy arrays of the
        JAX package's dtypes, so both packages write the same payload."""
        return {
            "current": {
                "count": self.count,
                "data": self._data.copy(),
                "lens": self._len.copy(),
                "weight": self._weight.copy(),
                "digests": [(slot, digest)
                            for slot, digest in sorted(
                                self._digest_of.items())],
            },
            "uploaded": self.uploaded_state(),
        }

    def restore(self, state: dict) -> None:
        """Install a checkpoint_state(): host slab = `current`, device
        tensors = `uploaded` (so the pending batch regenerates from the
        exact slab it originally sampled), with the undo log rebuilt as
        the diff between the two — a checkpoint taken before the next
        upload still reconstructs `uploaded` faithfully."""
        cur, up = state["current"], state["uploaded"]
        shape = tuple(np.asarray(cur["data"]).shape)
        if shape != (self.slots, self.words):
            raise ValueError(
                f"devmut slab shape mismatch: checkpoint {shape} vs "
                f"configured ({self.slots}, {self.words}) — resume needs "
                "the same slot count and max_len")
        self._data = np.array(cur["data"], dtype=np.uint32)
        self._len = np.array(cur["lens"], dtype=np.int32)
        self._weight = np.array(cur["weight"], dtype=np.uint32)
        self.count = int(cur["count"])
        self._digest_of = {int(s): d for s, d in cur["digests"]}
        self._slot_of = {d: s for s, d in self._digest_of.items()}
        up_data = np.array(up["data"], dtype=np.uint32)
        up_len = np.array(up["lens"], dtype=np.int32)
        up_weight = np.array(up["weight"], dtype=np.uint32)
        self._uploaded_count = int(up["count"])
        cum = np.cumsum(up_weight, dtype=np.uint64).astype(
            np.uint32).astype(np.int64)
        self._dev = (
            torch.tensor(up_data.view(np.int32), device=self.device),
            torch.tensor(up_len, device=self.device),
            torch.tensor(cum, device=self.device))
        self._dirty = False
        self._undo = {
            slot: (up_data[slot].copy(), int(up_len[slot]),
                   int(up_weight[slot]))
            for slot in range(self.slots)
            if (not np.array_equal(self._data[slot], up_data[slot])
                or self._len[slot] != up_len[slot]
                or self._weight[slot] != up_weight[slot])}

    def mark_stale(self) -> None:
        """Force the next arrays() call to upload the host slab.  The
        restoring mutator calls this AFTER regenerating its pending batch
        from the restored as-uploaded view — marking stale earlier would
        make the regeneration upload the current slab and sample the
        wrong corpus (see DevMangleMutator.restore_state)."""
        self._dirty = True
