"""Guest physical memory: a host page store and its device image.

The counterpart of wtf_tpu/mem/physmem.py.  `PhysMem` is the host side and
holds numpy arrays only (the oracle, the snapshot loader and the host
views read it without touching a device); `PhysMem.image(device)` uploads
it once per device as a `MemImage` the batched interpreter and the fused
step kernel read.  Slot 0 of the page store is a shared zero page; pages
absent from the dump read as zeros.  Guest writes never touch the image —
they go to the per-lane dirty overlay (mem/overlay.py).

Pages are stored as little-endian 64-bit WORDS (`int64[slots, 512]`, the
u64 bits in two's complement), so a page-table entry is one word and any
<= 16-byte span is three.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from wtf_tpu_torch.core.gxa import PAGE_SHIFT, PAGE_SIZE

PAGE_WORDS = PAGE_SIZE // 8


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass
class MemImage:
    """Device half of PhysMem.

    `frame_table` carries a leading tenant axis (one pfn -> slot row per
    base image; a single snapshot is the [1, span] table) and `tenant` is
    the per-lane row selector, populated by `lane_image`."""

    pages: torch.Tensor        # int64[slots, PAGE_WORDS]; slot 0 = zeros
    frame_table: torch.Tensor  # int32[tenants, span]; pfn -> slot
    tenant: Optional[torch.Tensor] = None  # int32[L]

    @property
    def nframes(self) -> int:
        return self.frame_table.shape[-1]


@dataclasses.dataclass
class PhysMem:
    """Host-side page store built from a sparse {pfn: page} dict."""

    pages: np.ndarray        # uint64[slots, PAGE_WORDS]
    frame_table: np.ndarray  # int32[1, nframes]
    nframes: int
    present: np.ndarray      # bool[nframes] — page was present in the dump

    def __post_init__(self):
        self._images: Dict[str, MemImage] = {}

    @classmethod
    def from_pages(cls, pages: Dict[int, bytes],
                   min_frames: int = 16) -> "PhysMem":
        """Build from {pfn: 4KiB page bytes} (reference Ram_t::Populate,
        ram.h:96-152), both dims padded to powers of two like the JAX
        package so the two agree on every shape."""
        max_pfn = max(pages) if pages else 0
        nframes = _next_pow2(max(max_pfn + 1, min_frames))
        pfns = sorted(pages)
        packed = np.zeros((_next_pow2(len(pfns) + 1), PAGE_SIZE),
                          dtype=np.uint8)
        frame_table = np.zeros(nframes, dtype=np.int32)
        present = np.zeros(nframes, dtype=bool)
        for slot, pfn in enumerate(pfns, start=1):
            data = pages[pfn]
            if len(data) != PAGE_SIZE:
                raise ValueError(f"page {pfn:#x} has size {len(data)}")
            packed[slot] = np.frombuffer(data, dtype=np.uint8)
            frame_table[pfn] = slot
            present[pfn] = True
        return cls(pages=packed.view(np.uint64),
                   frame_table=frame_table[None, :], nframes=nframes,
                   present=present)

    @property
    def nbytes(self) -> int:
        return int(self.pages.size * 8 + self.frame_table.size * 4)

    def image(self, device) -> MemImage:
        """The device image on `device`, uploaded once and cached."""
        key = str(torch.device(device))
        img = self._images.get(key)
        if img is None:
            img = MemImage(
                pages=torch.from_numpy(self.pages.view(np.int64)).to(device),
                frame_table=torch.from_numpy(self.frame_table).to(device))
            self._images[key] = img
        return img

    def host_read(self, gpa: int, size: int) -> bytes:
        """Host read of the *base* image (no overlay)."""
        page_bytes = self.pages.view(np.uint8)
        table = self.frame_table[0]
        out = bytearray()
        pos = gpa
        end = gpa + size
        while pos < end:
            pfn = pos >> PAGE_SHIFT
            off = pos & (PAGE_SIZE - 1)
            chunk = min(end - pos, PAGE_SIZE - off)
            slot = int(table[pfn]) if pfn < self.nframes else 0
            out += page_bytes[slot, off:off + chunk].tobytes()
            pos += chunk
        return bytes(out)


def lane_image(image: MemImage, n_lanes: int) -> MemImage:
    """Normalize a dispatch image so `tenant` is a populated int32[L] row
    selector (zeros for the single-image case)."""
    if image.tenant is None:
        return dataclasses.replace(image, tenant=torch.zeros(
            n_lanes, dtype=torch.int32, device=image.pages.device))
    return image


def frame_slot(image: MemImage, pfn: torch.Tensor) -> torch.Tensor:
    """pfn [L, ...] -> image page slot; out-of-range pfns map to the zero
    page.  The frame-table row is the lane's tenant (row 0 when unset)."""
    span = image.frame_table.shape[-1]
    pfn = pfn.long()
    in_range = (pfn >= 0) & (pfn < span)
    if image.tenant is None:
        row = torch.zeros_like(pfn)
    else:
        row = image.tenant.long().view((-1,) + (1,) * (pfn.dim() - 1))
        row = row.expand_as(pfn)
    slot = image.frame_table[row, pfn.clamp(0, span - 1)]
    return torch.where(in_range, slot, torch.zeros_like(slot))
