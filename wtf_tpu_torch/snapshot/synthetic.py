"""Synthetic snapshots: tiny long-mode guests for tests and benches.

The reference's snapshots are Windows kernel crash-dumps taken with bdump.js
(reference README.md:168-240); none ship with the tree (targets/ is empty).
For unit tests, demo targets, and benchmarks we synthesize minimal but
architecturally real snapshots: 4-level page tables, long-mode CpuState, code
and data mapped at arbitrary GVAs.  The result loads through the same
`Snapshot` path as a parsed crash-dump, so everything downstream is exercised
identically.
"""

from __future__ import annotations

from typing import Dict, Optional

from wtf_tpu_torch.core.cpustate import (
    CR0_PE,
    CR0_PG,
    CR4_PAE,
    CpuState,
    EFER_LMA,
    EFER_LME,
    Seg,
)
from wtf_tpu_torch.core.gxa import PAGE_SHIFT, PAGE_SIZE

_PTE_P = 1
_PTE_W = 1 << 1
_PTE_U = 1 << 2


class SyntheticSnapshotBuilder:
    """Builds {pfn: page bytes} + a long-mode CpuState with real page tables.

    Guest-physical layout: page tables from `table_base`, mapped data pages
    allocated by a bump allocator above them.
    """

    def __init__(self, table_base: int = 0x10000):
        self._phys: Dict[int, bytearray] = {}
        self._mappings: Dict[int, int] = {}  # gva pfn -> gpa pfn
        self._writable: Dict[int, bool] = {}
        self._next_pfn = (table_base >> PAGE_SHIFT) + 0x100
        self._table_base = table_base
        self._large = []  # (gva, gpa, size_shift) large-page mappings
        self.cpu = CpuState()

    def _phys_page(self, pfn: int) -> bytearray:
        page = self._phys.get(pfn)
        if page is None:
            page = bytearray(PAGE_SIZE)
            self._phys[pfn] = page
        return page

    def alloc_phys(self) -> int:
        pfn = self._next_pfn
        self._next_pfn += 1
        self._phys_page(pfn)
        return pfn

    def map(self, gva: int, size: int, writable: bool = True) -> None:
        """Map [gva, gva+size) to freshly allocated physical pages."""
        start = gva >> PAGE_SHIFT
        end = (gva + size + PAGE_SIZE - 1) >> PAGE_SHIFT
        for vpn in range(start, end):
            if vpn not in self._mappings:
                self._mappings[vpn] = self.alloc_phys()
                self._writable[vpn] = writable

    def write(self, gva: int, data: bytes, map_if_needed: bool = True) -> None:
        """Write snapshot contents at a GVA (mapping pages on demand)."""
        if map_if_needed:
            self.map(gva, len(data))
        pos = 0
        while pos < len(data):
            vpn = (gva + pos) >> PAGE_SHIFT
            off = (gva + pos) & (PAGE_SIZE - 1)
            chunk = min(len(data) - pos, PAGE_SIZE - off)
            gpa_pfn = self._mappings[vpn]
            self._phys_page(gpa_pfn)[off : off + chunk] = data[pos : pos + chunk]
            pos += chunk

    def map_discontiguous_pair(self, gva: int) -> None:
        """Map two virtually-adjacent pages to non-adjacent frames (for
        page-crossing tests)."""
        vpn = gva >> PAGE_SHIFT
        self._mappings[vpn] = self.alloc_phys()
        self._writable[vpn] = True
        self.alloc_phys()  # hole
        self._mappings[vpn + 1] = self.alloc_phys()
        self._writable[vpn + 1] = True

    def _build_tables(self) -> int:
        """Materialize 4-level page tables; returns cr3."""
        import struct

        next_table = [self._table_base >> PAGE_SHIFT]

        def alloc_table() -> int:
            pfn = next_table[0]
            next_table[0] += 1
            if pfn >= (self._table_base >> PAGE_SHIFT) + 0x100:
                raise RuntimeError("page-table arena exhausted")
            self._phys_page(pfn)
            return pfn

        pml4_pfn = alloc_table()
        # level maps: {table pfn: {index: child pfn}}
        tables: Dict[int, Dict[int, int]] = {pml4_pfn: {}}

        def get_child(table_pfn: int, index: int) -> int:
            children = tables.setdefault(table_pfn, {})
            if index not in children:
                child = alloc_table()
                children[index] = child
                page = self._phys_page(table_pfn)
                entry = (child << PAGE_SHIFT) | _PTE_P | _PTE_W | _PTE_U
                page[index * 8 : index * 8 + 8] = struct.pack("<Q", entry)
            return children[index]

        for vpn, gpa_pfn in self._mappings.items():
            gva = vpn << PAGE_SHIFT
            i4 = (gva >> 39) & 0x1FF
            i3 = (gva >> 30) & 0x1FF
            i2 = (gva >> 21) & 0x1FF
            i1 = (gva >> 12) & 0x1FF
            pdpt = get_child(pml4_pfn, i4)
            pd = get_child(pdpt, i3)
            pt = get_child(pd, i2)
            flags = _PTE_P | _PTE_U | (_PTE_W if self._writable.get(vpn, True) else 0)
            entry = (gpa_pfn << PAGE_SHIFT) | flags
            self._phys_page(pt)[i1 * 8 : i1 * 8 + 8] = struct.pack("<Q", entry)

        return pml4_pfn << PAGE_SHIFT

    def add_large_page_mapping(self, gva: int, gpa: int, size_shift: int) -> None:
        """Map a 2MiB (size_shift=21) or 1GiB (30) large page (PS entries)."""
        assert size_shift in (21, 30)
        self._large.append((gva, gpa, size_shift))

    def build(self, rip: int = 0, rsp: int = 0):
        """Finalize -> (pages dict, CpuState in long mode)."""
        import struct

        cr3 = self._build_tables()
        # Splice in large-page mappings after regular tables exist.
        for gva, gpa, size_shift in self._large:
            i4 = (gva >> 39) & 0x1FF
            i3 = (gva >> 30) & 0x1FF
            i2 = (gva >> 21) & 0x1FF
            pml4_pfn = cr3 >> PAGE_SHIFT
            pml4 = self._phys_page(pml4_pfn)
            pdpt_entry = struct.unpack("<Q", pml4[i4 * 8 : i4 * 8 + 8])[0]
            if not pdpt_entry & _PTE_P:
                raise RuntimeError("large-page parent PML4E missing; map() a sibling first")
            pdpt_pfn = (pdpt_entry >> PAGE_SHIFT) & ((1 << 40) - 1)
            if size_shift == 30:
                entry = gpa | _PTE_P | _PTE_W | _PTE_U | (1 << 7)
                self._phys_page(pdpt_pfn)[i3 * 8 : i3 * 8 + 8] = struct.pack("<Q", entry)
            else:
                pdpt = self._phys_page(pdpt_pfn)
                pd_entry = struct.unpack("<Q", pdpt[i3 * 8 : i3 * 8 + 8])[0]
                if not pd_entry & _PTE_P:
                    raise RuntimeError("large-page parent PDPTE missing; map() a sibling first")
                pd_pfn = (pd_entry >> PAGE_SHIFT) & ((1 << 40) - 1)
                entry = gpa | _PTE_P | _PTE_W | _PTE_U | (1 << 7)
                self._phys_page(pd_pfn)[i2 * 8 : i2 * 8 + 8] = struct.pack("<Q", entry)

        cpu = self.cpu
        cpu.cr3 = cr3
        cpu.cr0 = CR0_PE | CR0_PG | 0x50030  # PE+PG plus typical NE/ET/MP bits
        cpu.cr4 = CR4_PAE | 0x668
        cpu.efer = EFER_LME | EFER_LMA | 0x1  # long mode + SCE
        cpu.rip = rip
        cpu.rsp = rsp
        cpu.rflags = 0x202
        # attr bits 8..11 mirror limit[16:19] (see core.cpustate.Seg).
        cpu.cs = Seg(present=True, selector=0x33, base=0, limit=0xFFFFFFFF, attr=0xAFFB)
        cpu.ss = Seg(present=True, selector=0x2B, base=0, limit=0xFFFFFFFF, attr=0xCFF3)
        pages = {pfn: bytes(page) for pfn, page in self._phys.items()}
        return pages, cpu
