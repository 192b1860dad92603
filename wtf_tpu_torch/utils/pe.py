"""Minimal PE (Windows image) reader: sections, .text bytes, and the
.pdata function table.

Purpose: the product domain is Windows snapshots, so
decoder coverage must be measured against real Windows-PE codegen, not
Linux ELFs.  `function_ranges` uses the x64 exception directory
(.pdata RUNTIME_FUNCTION entries: begin/end RVAs) so the decode census
sweeps actual function bodies instead of jump tables and padding —
the same ground truth a disassembler would use.

Only what the census and symbol tooling need is implemented: 64-bit
images (machine 0x8664), section headers, and .pdata.  The reference gets
module metadata from the debugger's symbol machinery instead
(debugger.h); parsing the on-disk PE keeps this framework usable where
no Windows host ever enters the loop.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Dict, List, Tuple

PE32PLUS_MACHINE_AMD64 = 0x8664


class PeError(ValueError):
    pass


@dataclasses.dataclass
class Section:
    name: str
    vaddr: int      # RVA
    vsize: int
    raw_off: int
    raw_size: int
    characteristics: int

    @property
    def executable(self) -> bool:
        return bool(self.characteristics & 0x2000_0000)


@dataclasses.dataclass
class PeImage:
    path: Path
    machine: int
    image_base: int
    sections: List[Section]
    _data: bytes

    def section(self, name: str) -> Section:
        for s in self.sections:
            if s.name == name:
                return s
        raise PeError(f"{self.path.name}: no section {name!r}")

    def section_bytes(self, name: str) -> bytes:
        s = self.section(name)
        raw = self._data[s.raw_off:s.raw_off + min(s.raw_size, s.vsize)]
        return raw

    def rva_bytes(self, rva: int, size: int) -> bytes:
        for s in self.sections:
            if s.vaddr <= rva < s.vaddr + max(s.vsize, s.raw_size):
                off = s.raw_off + (rva - s.vaddr)
                return self._data[off:off + size]
        raise PeError(f"rva {rva:#x} outside every section")

    def data_directory(self, index: int) -> Tuple[int, int]:
        """(rva, size) of optional-header data directory `index`
        (0 = exports, 1 = imports, 12 = IAT)."""
        data = self._data
        (pe_off,) = struct.unpack_from("<I", data, 0x3C)
        (magic,) = struct.unpack_from("<H", data, pe_off + 24)
        if magic != 0x20B:
            raise PeError(f"{self.path.name}: not PE32+")
        return struct.unpack_from("<II", data, pe_off + 24 + 112 + index * 8)

    def exports(self) -> Dict[str, int]:
        """name -> RVA from the export directory."""
        erva, esize = self.data_directory(0)
        if erva == 0:
            return {}
        exp = self.rva_bytes(erva, 40)
        addr_rva, names_rva, ord_rva = struct.unpack_from("<III", exp, 28)
        (nnames,) = struct.unpack_from("<I", exp, 24)
        out: Dict[str, int] = {}
        for i in range(nnames):
            (nrva,) = struct.unpack_from(
                "<I", self.rva_bytes(names_rva + 4 * i, 4))
            name = self.rva_bytes(nrva, 256).split(b"\x00")[0].decode(
                "latin-1")
            (ordinal,) = struct.unpack_from(
                "<H", self.rva_bytes(ord_rva + 2 * i, 2))
            (frva,) = struct.unpack_from(
                "<I", self.rva_bytes(addr_rva + 4 * ordinal, 4))
            out[name] = frva
        return out

    def mapped_image(self) -> bytes:
        """The image laid out as the loader would map it at image_base:
        headers + sections at their RVAs, zero-filled virtual slack."""
        end = max(s.vaddr + max(s.vsize, s.raw_size) for s in self.sections)
        end = (end + 0xFFF) & ~0xFFF
        img = bytearray(end)
        hdr = min(0x1000, len(self._data))
        img[:hdr] = self._data[:hdr]
        for s in self.sections:
            raw = self._data[s.raw_off:s.raw_off + min(s.raw_size, s.vsize)]
            img[s.vaddr:s.vaddr + len(raw)] = raw
        return bytes(img)

    def function_ranges(self) -> List[Tuple[int, int]]:
        """(begin, end) RVA pairs from the .pdata RUNTIME_FUNCTION table
        (x64 SEH unwind directory) — every non-leaf function the compiler
        emitted.  Sorted, overlap-merged."""
        try:
            pdata = self.section_bytes(".pdata")
        except PeError:
            return []
        ranges = []
        for off in range(0, len(pdata) - 11, 12):
            begin, end, _unwind = struct.unpack_from("<III", pdata, off)
            if begin == 0 or end <= begin:
                continue
            ranges.append((begin, end))
        ranges.sort()
        merged: List[Tuple[int, int]] = []
        for begin, end in ranges:
            if merged and begin <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], end))
            else:
                merged.append((begin, end))
        return merged


def load_pe(path) -> PeImage:
    path = Path(path)
    data = path.read_bytes()
    if len(data) < 0x40 or data[:2] != b"MZ":
        raise PeError(f"{path.name}: not a PE (no MZ)")
    (pe_off,) = struct.unpack_from("<I", data, 0x3C)
    if data[pe_off:pe_off + 4] != b"PE\x00\x00":
        raise PeError(f"{path.name}: bad PE signature")
    machine, nsections = struct.unpack_from("<HH", data, pe_off + 4)
    (opt_size,) = struct.unpack_from("<H", data, pe_off + 20)
    (magic,) = struct.unpack_from("<H", data, pe_off + 24)
    image_base = 0
    if magic == 0x20B:  # PE32+
        (image_base,) = struct.unpack_from("<Q", data, pe_off + 24 + 24)
    sections = []
    sect0 = pe_off + 24 + opt_size
    for i in range(nsections):
        off = sect0 + i * 40
        name = data[off:off + 8].rstrip(b"\x00").decode("latin-1")
        vsize, vaddr, raw_size, raw_off = struct.unpack_from(
            "<IIII", data, off + 8)
        (characteristics,) = struct.unpack_from("<I", data, off + 36)
        sections.append(Section(name, vaddr, vsize, raw_off, raw_size,
                                characteristics))
    return PeImage(path=path, machine=machine, image_base=image_base,
                   sections=sections, _data=data)


def decode_census(pe: PeImage, max_bytes: int = 0) -> Dict:
    """Linear-sweep the image's function bodies (from .pdata) through the
    framework decoder; returns totals + a histogram of the first bytes of
    undecodable sequences (what to implement next, by measured weight)."""
    from collections import Counter

    from wtf_tpu_torch.cpu.decoder import decode
    from wtf_tpu_torch.cpu.uops import OPC_INVALID

    text = pe.section(".text")
    blob = pe.section_bytes(".text")
    ranges = pe.function_ranges()
    if not ranges:  # no unwind info: whole section (less accurate)
        ranges = [(text.vaddr, text.vaddr + len(blob))]
    total_instr = 0
    bad_instr = 0
    bad_bytes = 0
    swept = 0
    unknown = Counter()
    for begin, end in ranges:
        pos = begin - text.vaddr
        stop = min(end - text.vaddr, len(blob))
        while pos < stop:
            window = blob[pos:pos + 15]
            if len(window) < 15:
                window = window + b"\x90" * (15 - len(window))
            uop = decode(window, pos)
            total_instr += 1
            swept += max(uop.length, 1)
            if uop.opc == OPC_INVALID:
                bad_instr += 1
                bad_bytes += 1
                unknown[window[:3].hex()] += 1
                pos += 1  # resync byte-wise, like the round-3 ELF census
            else:
                pos += uop.length
            if max_bytes and swept >= max_bytes:
                break
        if max_bytes and swept >= max_bytes:
            break
    return {
        "image": pe.path.name,
        "functions": len(ranges),
        "bytes_swept": swept,
        "instructions": total_instr,
        "undecodable_instr": bad_instr,
        "undecodable_bytes": bad_bytes,
        "undecodable_pct": round(100.0 * bad_bytes / max(swept, 1), 4),
        "top_unknown": unknown.most_common(20),
    }
