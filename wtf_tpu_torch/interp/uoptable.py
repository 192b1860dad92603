"""The decode cache: host decoder output published as device tensors.

The counterpart of wtf_tpu/interp/uoptable.py.  The host decodes each
unique rip once (cpu/decoder.py) and `DecodeCache` publishes the result
as fixed-width tensors the batched step and the fused kernel index with a
hash probe: open addressing over `hash_tab`, probe sequence
splitmix64(key) + k for k < PROBES, where the key is the rip tagged with
the lane's tenant (`tag_key`).  The host inserter enforces the same probe
bound, so a device miss means the rip is genuinely undecoded and surfaces
as per-lane NEED_DECODE for the runner to service.

Entry layout (capacity rows): the Uop integer fields (uops.INT_FIELDS
order), disp/imm, the first 16 raw bytes (SMC verification), the
decode-time code page frames pfn0/pfn1, and the breakpoint bit.

Rows the device decoder (interp/devdec.py) publishes inside a window come
back through `adopt_device_entries`, which re-decodes each on the host and
appends it in publish order; the device copy is then rebuilt from the
host arrays on the next `device()` call, row for row what the window
published.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Set, Tuple

import numpy as np
import torch

from wtf_tpu_torch.cpu.uops import INT_FIELDS, Uop
from wtf_tpu_torch.interp import ints as I
from wtf_tpu_torch.utils.hashing import splitmix64

NF = len(INT_FIELDS)
# Shared host/device probe bound.  The host re-hashes everything into a
# bigger table if an insert would exceed it, so device lookups stay O(PROBES).
PROBES = 8

_FIELD_INDEX = {name: i for i, name in enumerate(INT_FIELDS)}
F_OPC = _FIELD_INDEX["opc"]
F_SUB = _FIELD_INDEX["sub"]
F_COND = _FIELD_INDEX["cond"]
F_LENGTH = _FIELD_INDEX["length"]
F_OPSIZE = _FIELD_INDEX["opsize"]
F_SRCSIZE = _FIELD_INDEX["srcsize"]
F_SEXT = _FIELD_INDEX["sext"]
F_DST_KIND = _FIELD_INDEX["dst_kind"]
F_DST_REG = _FIELD_INDEX["dst_reg"]
F_SRC_KIND = _FIELD_INDEX["src_kind"]
F_SRC_REG = _FIELD_INDEX["src_reg"]
F_BASE_REG = _FIELD_INDEX["base_reg"]
F_IDX_REG = _FIELD_INDEX["idx_reg"]
F_SCALE = _FIELD_INDEX["scale"]
F_SEG = _FIELD_INDEX["seg"]
F_REP = _FIELD_INDEX["rep"]
F_LOCK = _FIELD_INDEX["lock"]
F_A32 = _FIELD_INDEX["a32"]


class UopTable(NamedTuple):
    """Device tensors of the decode cache (shared by every lane).

    Entry metadata sits in two row-gatherable arrays (one int32, one
    int64), and each hash row carries its probe key next to the entry
    index, so a probe is one gather of [PROBES, 3] rows."""

    rip: torch.Tensor       # int64[capacity] probe key per entry
    meta_i32: torch.Tensor  # int32[capacity, NF + 3]: fields, pfn0/1, bp
    meta_u64: torch.Tensor  # int64[capacity, 4]: disp, imm, raw_lo, raw_hi
    hash_tab: torch.Tensor  # int32[hash_size, 3]: entry or -1, key lo/hi


# meta_i32 column layout (first NF columns are uops.INT_FIELDS)
M_PFN0 = NF
M_PFN1 = NF + 1
M_BP = NF + 2
# meta_u64 column layout
MU_DISP, MU_IMM, MU_RAW_LO, MU_RAW_HI = 0, 1, 2, 3

_MASK64 = (1 << 64) - 1


def tag_key(rip: int, tenant: int = 0) -> int:
    """The probe key a (tenant, rip) pair hashes and verifies under
    (wtf_tpu/tenancy): rip ^ (tenant << 48).  Canonical x86-64 addresses
    carry bits 62:48 as copies of bit 47, so the tag occupies dead bits
    and two base images sharing a virtual address get distinct cache
    entries.  tenant 0 (every single-image campaign) leaves the rip
    untouched — the pre-tenancy key space, bit for bit."""
    return (rip ^ (tenant << 48)) & _MASK64


def _pack_raw(raw: bytes) -> Tuple[int, int]:
    padded = raw[:16].ljust(16, b"\x00")
    lo = int.from_bytes(padded[:8], "little")
    hi = int.from_bytes(padded[8:16], "little")
    return lo, hi


class DecodeCache:
    """Host mirror of the device table; owns insertion and breakpoint state."""

    def __init__(self, capacity: int = 1 << 15, hash_factor: int = 4):
        self.capacity = capacity
        self.hash_size = 1
        while self.hash_size < capacity * hash_factor:
            self.hash_size *= 2
        self.count = 0
        # self.rip holds the PROBE KEY per entry (tag_key(rip, tenant));
        # tenant_of untags it back to the real rip for reporting
        self.rip = np.zeros(capacity, dtype=np.uint64)
        self.tenant_of = np.zeros(capacity, dtype=np.int32)
        self.fields = np.zeros((capacity, NF), dtype=np.int32)
        self.disp = np.zeros(capacity, dtype=np.uint64)
        self.imm = np.zeros(capacity, dtype=np.uint64)
        self.raw_lo = np.zeros(capacity, dtype=np.uint64)
        self.raw_hi = np.zeros(capacity, dtype=np.uint64)
        self.pfn0 = np.zeros(capacity, dtype=np.int32)
        self.pfn1 = np.zeros(capacity, dtype=np.int32)
        self.bp = np.zeros(capacity, dtype=np.int32)
        self.hash_tab = np.full(self.hash_size, -1, dtype=np.int32)
        self.index: Dict[int, int] = {}      # probe key -> entry idx
        self.uops: Dict[int, Uop] = {}       # probe key -> host Uop
        # Breakpoints may be registered before their rip is ever decoded
        # (symbol breakpoints at Init time, reference backend.cc:214-239).
        # Keyed like entries: tag_key(gva, tenant).
        self.pending_bps: Set[int] = set()
        self._device: Optional[UopTable] = None
        self._device_on = ""

    # -- keyed lookups (tenant 0 == the pre-tenancy rip key space) -------
    def entry_index(self, rip: int, tenant: int = 0) -> Optional[int]:
        return self.index.get(tag_key(rip, tenant))

    def has(self, rip: int, tenant: int = 0) -> bool:
        return tag_key(rip, tenant) in self.index

    def uop_at(self, rip: int, tenant: int = 0) -> Optional[Uop]:
        return self.uops.get(tag_key(rip, tenant))

    # -- insertion -------------------------------------------------------
    def _hash_insert(self, rip: int, idx: int) -> bool:
        h = splitmix64(rip)
        mask = self.hash_size - 1
        for k in range(PROBES):
            slot = (h + k) & mask
            if self.hash_tab[slot] < 0:
                self.hash_tab[slot] = idx
                return True
        return False

    def _rehash(self) -> None:
        self.hash_size *= 2
        while True:
            self.hash_tab = np.full(self.hash_size, -1, dtype=np.int32)
            ok = all(
                self._hash_insert(int(self.rip[i]), i) for i in range(self.count)
            )
            if ok:
                return
            self.hash_size *= 2

    def add(self, rip: int, uop: Uop, pfn0: int, pfn1: int,
            tenant: int = 0) -> int:
        """Insert a decoded instruction; returns its entry index."""
        key = tag_key(rip, tenant)
        existing = self.index.get(key)
        if existing is not None:
            return existing
        if self.count >= self.capacity:
            raise RuntimeError(
                f"uop table full ({self.capacity}); raise capacity"
            )
        idx = self.count
        self.count += 1
        self.rip[idx] = np.uint64(key)
        self.tenant_of[idx] = tenant
        for f, name in enumerate(INT_FIELDS):
            self.fields[idx, f] = getattr(uop, name)
        self.disp[idx] = np.uint64(uop.disp & ((1 << 64) - 1))
        self.imm[idx] = np.uint64(uop.imm & ((1 << 64) - 1))
        lo, hi = _pack_raw(uop.raw)
        self.raw_lo[idx] = np.uint64(lo)
        self.raw_hi[idx] = np.uint64(hi)
        self.pfn0[idx] = pfn0
        self.pfn1[idx] = pfn1
        self.bp[idx] = 1 if key in self.pending_bps else 0
        if not self._hash_insert(key, idx):
            self._rehash()
        self.index[key] = idx
        self.uops[key] = uop
        self._device = None
        return idx

    def update(self, rip: int, uop: Uop, pfn0: int, pfn1: int,
               tenant: int = 0) -> int:
        """Re-publish a rip whose bytes changed (self-modifying code / SMC
        servicing).  Overwrites the existing entry in place — the entry index
        is stable, so coverage-bitmap indices stay valid — or inserts when
        the rip was never decoded."""
        key = tag_key(rip, tenant)
        idx = self.index.get(key)
        if idx is None:
            return self.add(rip, uop, pfn0, pfn1, tenant=tenant)
        for f, name in enumerate(INT_FIELDS):
            self.fields[idx, f] = getattr(uop, name)
        self.disp[idx] = np.uint64(uop.disp & ((1 << 64) - 1))
        self.imm[idx] = np.uint64(uop.imm & ((1 << 64) - 1))
        lo, hi = _pack_raw(uop.raw)
        self.raw_lo[idx] = np.uint64(lo)
        self.raw_hi[idx] = np.uint64(hi)
        self.pfn0[idx] = pfn0
        self.pfn1[idx] = pfn1
        self.uops[key] = uop
        self._device = None
        return idx

    # -- checkpoint stream -------------------------------------------------
    def checkpoint_entries(self) -> list:
        """Insertion-ordered entry snapshot: (rip, raw bytes, pfn0, pfn1)
        per entry, a 5th element carrying the tenant when it is nonzero
        (the JAX package's checkpoint stream).  Coverage bit i IS entry
        index i, so two caches with equal streams map coverage alike."""
        out = []
        for idx in range(self.count):
            key = int(self.rip[idx])
            tenant = int(self.tenant_of[idx])
            entry = (tag_key(key, tenant), self.uops[key].raw,
                     int(self.pfn0[idx]), int(self.pfn1[idx]))
            out.append(entry if tenant == 0 else entry + (tenant,))
        return out

    # -- device-published entry adoption (interp/devdec.py harvest) ------
    def adopt_device_entries(self, rip, meta_i32, meta_u64,
                             start: int, end: int) -> int:
        """Append rows [start, end) that the device decoder published
        during a megachunk window, in publish order, so host and device
        tables keep identical entry indices.  The arrays are the
        [start, end) SLICE of the device table (row 0 == entry `start`):
        `rip` int64 probe keys, `meta_i32`, `meta_u64` (int64 bits).  The
        host decoder stays the oracle: every row is re-decoded from its
        raw bytes and checked field for field, and the HOST result is
        stored.  Returns the number of rows the device decoded otherwise
        (0 unless the device decoder is wrong)."""
        from wtf_tpu_torch.cpu.decoder import decode

        if start != self.count:
            raise RuntimeError(
                f"device-entry adoption out of order: device rows start "
                f"at {start}, host cache has {self.count}")
        rip = np.asarray(rip)
        meta_i32 = np.asarray(meta_i32)
        meta_u64 = np.asarray(meta_u64).view(np.uint64)
        mismatches = 0
        for idx in range(end - start):
            key = int(rip[idx]) & _MASK64
            # untag: canonical rips carry bits 63:48 as copies of bit 47
            # (bit 47 is below the tag, so it survives tagging intact)
            tenant = (key >> 48) ^ (0xFFFF if (key >> 47) & 1 else 0)
            gva = tag_key(key, tenant)
            length = max(int(meta_i32[idx, F_LENGTH]), 0)
            raw = (int(meta_u64[idx, MU_RAW_LO]).to_bytes(8, "little")
                   + int(meta_u64[idx, MU_RAW_HI]).to_bytes(8, "little")
                   )[:length]
            uop = decode(raw, gva)
            bad = any(int(meta_i32[idx, f]) != int(getattr(uop, name))
                      for f, name in enumerate(INT_FIELDS))
            bad = bad or int(meta_u64[idx, MU_DISP]) != (uop.disp & _MASK64)
            bad = bad or int(meta_u64[idx, MU_IMM]) != (uop.imm & _MASK64)
            bad = bad or int(meta_i32[idx, M_BP]) != (
                1 if key in self.pending_bps else 0)
            mismatches += bool(bad)
            self.add(gva, uop, int(meta_i32[idx, M_PFN0]),
                     int(meta_i32[idx, M_PFN1]), tenant=tenant)
        return mismatches

    # -- breakpoints -----------------------------------------------------
    def set_breakpoint(self, gva: int, tenant: int = 0) -> None:
        key = tag_key(gva, tenant)
        self.pending_bps.add(key)
        idx = self.index.get(key)
        if idx is not None and self.bp[idx] != 1:
            self.bp[idx] = 1
            self._device = None

    def clear_breakpoint(self, gva: int, tenant: int = 0) -> None:
        key = tag_key(gva, tenant)
        self.pending_bps.discard(key)
        idx = self.index.get(key)
        if idx is not None and self.bp[idx] != 0:
            self.bp[idx] = 0
            self._device = None

    def has_breakpoint(self, gva: int, tenant: int = 0) -> bool:
        return tag_key(gva, tenant) in self.pending_bps

    # -- device view -----------------------------------------------------
    def device(self, device) -> UopTable:
        """Upload (or return the cached) device tensors on `device`."""
        if self._device is None or self._device_on != str(device):
            self._device_on = str(device)
            meta_i32 = np.concatenate(
                [self.fields, self.pfn0[:, None], self.pfn1[:, None],
                 self.bp[:, None]], axis=1)
            meta_u64 = np.stack(
                [self.disp, self.imm, self.raw_lo, self.raw_hi], axis=1)
            # hash rows carry the probe key's u32 halves beside the entry
            # index (one [PROBES, 3] gather per lookup)
            occ = self.hash_tab >= 0
            keys = self.rip[np.maximum(self.hash_tab, 0)]
            klo = np.where(occ, keys & np.uint64(0xFFFFFFFF), 0)
            khi = np.where(occ, keys >> np.uint64(32), 0)
            rows = np.stack(
                [self.hash_tab,
                 klo.astype(np.uint32).view(np.int32),
                 khi.astype(np.uint32).view(np.int32)], axis=1)

            def up(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device)

            self._device = UopTable(
                rip=up(self.rip.view(np.int64)),
                meta_i32=up(meta_i32),
                meta_u64=up(meta_u64.view(np.int64)),
                hash_tab=up(rows),
            )
        return self._device

    def rip_of(self, idx: int) -> int:
        """Real (untagged) rip of an entry."""
        return tag_key(int(self.rip[idx]), int(self.tenant_of[idx]))

    def rips_of_bits(self, words: np.ndarray) -> list:
        """Decode a coverage bitmap (u32 words over entry indices) to
        real (untagged) RIPs."""
        out = []
        bits = np.nonzero(words)[0]
        for word_idx in bits:
            word = int(words[word_idx])
            base = word_idx * 32
            while word:
                low = word & -word
                idx = base + low.bit_length() - 1
                out.append(tag_key(int(self.rip[idx]),
                                   int(self.tenant_of[idx])))
                word ^= low
        return out


def uop_lookup(tab: UopTable, key: torch.Tensor) -> torch.Tensor:
    """Probe the table for key [L] (int64) -> entry index or -1.  The
    counterpart of wtf_tpu/interp/step.py `uop_lookup`: the low 32 bits of
    splitmix64(key) plus k, masked to the table size, for k < PROBES; the
    first live slot whose stored key matches wins."""
    hmask = tab.hash_tab.shape[0] - 1
    h_lo = I.splitmix64(key) & 0xFFFFFFFF
    k = torch.arange(PROBES, device=key.device)
    slots = (h_lo[:, None] + k[None, :]) & hmask
    rows = tab.hash_tab[slots].long()                 # [L, PROBES, 3]
    e = rows[..., 0]
    key_lo = key & 0xFFFFFFFF
    key_hi = I.shr(key, 32)
    match = ((e >= 0) & ((rows[..., 1] & 0xFFFFFFFF) == key_lo[:, None])
             & ((rows[..., 2] & 0xFFFFFFFF) == key_hi[:, None]))
    first = match.to(torch.uint8).argmax(-1)
    found = match.any(-1)
    hit = torch.gather(e, 1, first[:, None])[:, 0]
    return torch.where(found, hit, torch.full_like(hit, -1))
