"""x86-64 long-mode address translation, batched over lanes.

The counterpart of wtf_tpu/mem/paging.py (`translate_vec_l`): the same
4-level walk as the reference's software walkers (kvm_backend.cc:1937-1998,
whv_backend.cc:650-721), written with where-accumulation so every lane and
every address walks at once.  1GiB (PDPTE.PS) and 2MiB (PDE.PS) pages are
supported; accessed/dirty bits are NOT set (the JAX package's documented
divergence — bochs sets them, which only grows the dirty set).

Page-table reads go through the lane's overlay, so guest-modified page
tables are honored within a testcase.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from wtf_tpu_torch.interp import ints as I
from wtf_tpu_torch.mem.overlay import DirtyOverlay, pte_read
from wtf_tpu_torch.mem.physmem import MemImage

PHYS_MASK = 0x000F_FFFF_FFFF_F000
PHYS_MASK_1G = 0x000F_FFFF_C000_0000
PHYS_MASK_2M = 0x000F_FFFF_FFE0_0000

PTE_PRESENT = 1
PTE_WRITE = 1 << 1
PTE_USER = 1 << 2
PTE_PS = 1 << 7


class Translation(NamedTuple):
    gpa: torch.Tensor       # int64[L, K]
    ok: torch.Tensor        # bool: canonical and present all the way down
    writable: torch.Tensor  # bool: AND of the W bits along the walk
    user: torch.Tensor      # bool: AND of the U/S bits along the walk


def is_canonical(gva: torch.Tensor) -> torch.Tensor:
    """48-bit canonical check (bits 63:47 all equal)."""
    top = I.shr(gva, 47)
    return (top == 0) | (top == 0x1FFFF)


def translate(image: MemImage, ov: DirtyOverlay, cr3: torch.Tensor,
              gva: torch.Tensor) -> Translation:
    """Walk PML4 -> PDPT -> PD -> PT for gva [L, K] under each lane's cr3
    [L]; the K walks of a lane share one overlay lookup per level."""
    table = (cr3 & PHYS_MASK)[:, None].expand_as(gva)
    ok = is_canonical(gva)
    writable = torch.ones_like(ok)
    user = torch.ones_like(ok)
    done = torch.zeros_like(ok)
    gpa = torch.zeros_like(gva)
    for shift, large_mask in ((39, None), (30, PHYS_MASK_1G),
                              (21, PHYS_MASK_2M), (12, None)):
        index = I.shr(gva, shift) & 0x1FF
        entry = pte_read(image, ov, table + index * 8)
        present = (entry & PTE_PRESENT) != 0
        ok = ok & (done | present)
        writable = writable & (done | ((entry & PTE_WRITE) != 0))
        user = user & (done | ((entry & PTE_USER) != 0))
        if large_mask is not None:
            is_large = present & ((entry & PTE_PS) != 0) & ~done
            large_gpa = (entry & large_mask) | (gva & ((1 << shift) - 1))
            gpa = torch.where(is_large, large_gpa, gpa)
            done = done | is_large
        if shift == 12:
            leaf_gpa = (entry & PHYS_MASK) | (gva & 0xFFF)
            gpa = torch.where(done, gpa, leaf_gpa)
        table = entry & PHYS_MASK
    return Translation(gpa=gpa, ok=ok, writable=writable, user=user)
