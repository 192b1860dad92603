"""Real-Windows-machine-code target: fuzz an exported function of an
actual MSVC-built DLL.  The counterpart of wtf_tpu/harness/demo_pe.py.

The reference ships snapshots of real programs and fuzzes them through
their harness modules (reference README.md:27-33; the tlv_server demo's
source is src/tlv_server/tlv_server.cc).  No Windows box exists in this
environment, so instead of a bdump capture this target builds the
snapshot the way the LOADER would: `utils/pe.py` maps a census-verified
MSVC PE (`gle64.vc14.dll`, the GLE extrusion library that ships inside
PyOpenGL) at its preferred base, fills its IAT with synthetic import
stubs (bump-allocator malloc/realloc, rep-stosb memset, sqrtsd sqrt,
zero-return for the GL/kernel32 surface — the guest-environment-faking
role the reference's fshooks layer plays for file I/O), and snapshots
the machine about to call a real export.

Default export: `glePolyCylinder(int npoints, gleDouble points[][3],
float colors[][3], gleDouble radius)` — real MSVC codegen with an
attacker-controlled element COUNT walking an attacker-placed array.
The testcase supplies fewer points than it claims and the points buffer
sits against the end of its mapping (the page-heap idiom the reference
demos use, fuzzer_ioctl.cc:82-89), so an over-count walks off the page
inside genuine `gle64` code and surfaces as an access violation.

  testcase format: u32 npoints | f64 radius | point data (24 B each)

Both engines run the same image; the decode census (README table) says
0.02% of this DLL's .text is undecodable, and the device step executes
its SSE/SSE2 floating point natively.

Limitation: the CRT math imports sin/cos/atan2/acos are zero-returning
stubs, so exports whose control flow branches on transcendental results
explore a distorted input space (every such call sees 0.0) — pick
exports that don't, or supply real implementations, when that matters.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Optional

from wtf_tpu_torch.core.results import Ok
from wtf_tpu_torch.fuzz.mutator import Mutator
from wtf_tpu_torch.harness.targets import Target
from wtf_tpu_torch.snapshot.loader import Snapshot
from wtf_tpu_torch.snapshot.synthetic import SyntheticSnapshotBuilder
from wtf_tpu_torch.utils.pe import PeImage, load_pe

# WTF_PE_DLL names another copy of the same DLL, for a machine whose
# Python has no PyOpenGL wheel
DEFAULT_DLL = Path(os.environ.get("WTF_PE_DLL") or
                   "/opt/venv/lib/python3.12/site-packages/OpenGL/DLLS/"
                   "gle64.vc14.dll")
DEFAULT_EXPORT = "glePolyCylinder"

EXIT_GVA = 0x1400_0000      # magic return address; bp -> Ok
STUB_GVA = 0x2100_0000      # synthetic import stubs
HEAP_BASE = 0x2200_0000     # bump-allocator arena (16 pages)
HEAP_PAGES = 16
HEAP_STATE = 0x2300_0000    # u64: current bump pointer (stub ABI)
POINTS_BASE = 0x2400_0000   # testcase point data; guard page follows
POINTS_PAGES = 2
STACK_TOP = 0x0000_7FFF_F000

# Hand-assembled stubs (source in tools/gen_pe_stubs.py); HEAP_STATE and
# the HEAP_END arena bound are baked into the malloc/realloc immediates.
# The RAW size is bounded by the arena size before 16-byte alignment (so
# sizes like -1 can't wrap through the +15 into a tiny allocation), then
# the bumped end by HEAP_END — out-of-arena requests return NULL, so
# allocation-heavy mangled inputs exercise the DLL's NULL-handling
# instead of crashing on harness-arena overruns that would be
# misattributed to gle64.
_STUBS = {
    "ret0": bytes.fromhex("31c0c3"),
    "fpzero": bytes.fromhex("0f57c0c3"),
    "sqrt": bytes.fromhex("f20f51c0c3"),
    "malloc": bytes.fromhex(
        "49c7c200000023498b0249c7c3000001004c39d9771c488d490f4883e1f048"
        "8d140849c7c3000001224c39da7704498912c331c0c3"),
    "realloc": bytes.fromhex(
        "49c7c200000023498b0249c7c3000001004c39da77384c8d420f4983e0f04e"
        "8d0c0049c7c3000001224d39d977204d890a4989f94989f34889c74889ce48"
        "89d14885f67402f3a44c89cf4c89dec331c0c3"),
    "memset": bytes.fromhex("4989f94989ca4889cf0fb6c24c89c1f3aa4c89d04c89cfc3"),
}

# import name -> stub kind; anything unlisted gets the zero-return stub
_STUB_FOR = {
    "malloc": "malloc",
    "realloc": "realloc",
    "memset": "memset",
    "sqrt": "sqrt",
    "sin": "fpzero",
    "cos": "fpzero",
    "atan2": "fpzero",
    "acos": "fpzero",
}


def _iter_imports(pe: PeImage):
    """Yield (name, iat_slot_rva) for every import thunk."""
    irva, _ = pe.data_directory(1)
    if irva == 0:
        return
    off = 0
    while True:
        ent = pe.rva_bytes(irva + off, 20)
        ilt, _ts, _fc, _name_rva, iat_rva = struct.unpack("<IIIII", ent)
        if ilt == 0 and iat_rva == 0:
            return
        j = 0
        while True:
            (thunk,) = struct.unpack("<Q", pe.rva_bytes(ilt + j * 8, 8))
            if thunk == 0:
                break
            if thunk >> 63:
                name = f"ordinal_{thunk & 0xFFFF}"
            else:
                name = pe.rva_bytes((thunk & 0x7FFFFFFF) + 2, 256).split(
                    b"\x00")[0].decode("latin-1")
            yield name, iat_rva + j * 8
            j += 1
        off += 20


def build_snapshot(dll_path=DEFAULT_DLL,
                   export: str = DEFAULT_EXPORT) -> Snapshot:
    pe = load_pe(dll_path)
    exports = pe.exports()
    if export not in exports:
        raise ValueError(f"{Path(dll_path).name} does not export {export!r}; "
                         f"has {sorted(exports)}")
    base = pe.image_base

    # lay the image out as the loader would and resolve the IAT onto the
    # synthetic stubs
    image = bytearray(pe.mapped_image())
    stub_addr = {}
    pos = 0
    blob = bytearray()
    for kind, code in _STUBS.items():
        stub_addr[kind] = STUB_GVA + pos
        blob += code + b"\xcc" * (16 - len(code) % 16)
        pos = len(blob)
    for name, slot_rva in _iter_imports(pe):
        kind = _STUB_FOR.get(name, "ret0")
        struct.pack_into("<Q", image, slot_rva, stub_addr[kind])

    b = SyntheticSnapshotBuilder()
    b.write(base, bytes(image))
    b.write(STUB_GVA, bytes(blob))
    b.map(HEAP_BASE, HEAP_PAGES * 0x1000)
    b.write(HEAP_STATE, HEAP_BASE.to_bytes(8, "little"))
    b.map(POINTS_BASE, POINTS_PAGES * 0x1000)   # guard page follows
    b.write(EXIT_GVA, b"\x90\xf4")              # nop; hlt (bp at init)
    b.map(STACK_TOP - 0x8000, 0x9000)
    rsp = STACK_TOP - 0x1000
    b.write(rsp, EXIT_GVA.to_bytes(8, "little"), map_if_needed=False)
    pages, cpu = b.build(rip=base + exports[export], rsp=rsp)
    name = Path(dll_path).name.split(".")[0]
    symbols = {f"{name}!{exp}": base + rva for exp, rva in exports.items()}
    symbols[f"{name}!__exit_magic"] = EXIT_GVA
    return Snapshot.from_pages(pages, cpu, symbols=symbols)


def _init(backend) -> bool:
    backend.set_breakpoint_by_symbol("gle64!__exit_magic",
                                     lambda b: b.stop(Ok()))
    return True


POINTS_CAP = (POINTS_PAGES * 0x1000) // 24 * 24  # whole 24-byte elements


def _insert_testcase(backend, data: bytes) -> bool:
    if len(data) < 12:
        data = data.ljust(12, b"\x00")
    (npoints,) = struct.unpack_from("<I", data, 0)
    (radius_bits,) = struct.unpack_from("<Q", data, 4)
    pts = data[12:12 + POINTS_CAP]
    # page-heap placement: the LAST supplied byte sits at the end of the
    # mapping, so reading element `len(pts)//24` faults
    addr = POINTS_BASE + POINTS_PAGES * 0x1000 - max(len(pts), 24)
    if pts:
        backend.virt_write(addr, pts)
    backend.set_reg(1, npoints)        # rcx: attacker-claimed count
    backend.set_reg(2, addr)           # rdx: gleDouble point_array[][3]
    backend.set_reg(8, 0)              # r8:  color_array = NULL
    backend.set_xmm(3, radius_bits)    # xmm3: gleDouble radius
    return True


class PeStructureMutator(Mutator):
    """Structure-aware mutator for the demo_pe testcase format
    {npoints:u32, radius:f64, points:f64[3][]} — the custom-mutator role
    the reference demonstrates on its tlv_server (CustomMutator_t,
    fuzzer_tlv_server.cc:204-365), here driving REAL MSVC code:
    count lies (the OOB trigger), adversarial FP values for the radius
    and coordinates (NaN payloads, infinities, denormals — the device
    FP path's divert stress), and element-level add/dup/delete."""

    # adversarial f64 bit patterns (denormals exercise the oracle divert)
    _SPECIALS = (0x0000000000000001, 0x000FFFFFFFFFFFFF,  # denormals
                 0x7FF0000000000000, 0xFFF0000000000000,  # +/-inf
                 0x7FF8000000001234, 0x7FF0000000000BAD,  # qnan/snan
                 0x8000000000000000, 0x3FF0000000000000,  # -0, 1.0
                 0x7FEFFFFFFFFFFFFF, 0x0010000000000000)  # max, min-normal

    def __init__(self, rng, max_len: int = 0x400):
        self.rng = rng
        self.max_len = max_len

    def get_new_testcase(self, corpus) -> bytes:
        rng = self.rng
        base = corpus.pick() if corpus is not None else None
        if not base or len(base) < 12:
            base = struct.pack("<Id", 2, 1.0) + struct.pack(
                "<6d", *(rng.uniform(-8, 8) for _ in range(6)))
        (npoints,) = struct.unpack_from("<I", base, 0)
        (radius,) = struct.unpack_from("<Q", base, 4)
        pts = bytearray(base[12:12 + POINTS_CAP])
        n_elem = len(pts) // 24
        for _ in range(rng.randrange(1, 4)):
            op = rng.randrange(6)
            if op == 0:    # count lies: boundary / overclaim / huge
                npoints = rng.choice(
                    (0, 1, n_elem, n_elem + 1, n_elem + rng.randrange(64),
                     0x7FFFFFFF, rng.getrandbits(32)))
            elif op == 1:  # adversarial radius
                radius = rng.choice(self._SPECIALS) ^ rng.getrandbits(2)
            elif op == 2 and n_elem:  # poison one coordinate
                off = rng.randrange(n_elem * 3) * 8
                struct.pack_into(
                    "<Q", pts, off,
                    rng.choice(self._SPECIALS) ^ rng.getrandbits(2))
            elif op == 3 and len(pts) + 24 <= POINTS_CAP:  # append element
                pts += struct.pack(
                    "<3d", *(rng.uniform(-100, 100) for _ in range(3)))
                n_elem += 1
            elif op == 4 and n_elem > 1:  # delete element
                k = rng.randrange(n_elem) * 24
                del pts[k:k + 24]
                n_elem -= 1
            else:          # raw byte flip inside the coordinates
                if pts:
                    pts[rng.randrange(len(pts))] ^= 1 << rng.randrange(8)
        out = struct.pack("<I", npoints & 0xFFFFFFFF) + struct.pack(
            "<Q", radius) + bytes(pts)
        return out[:self.max_len]


def _create_mutator(rng, max_len: int):
    return PeStructureMutator(rng, max_len)


TARGET = Target(
    name="demo_pe",
    init=_init,
    insert_testcase=_insert_testcase,
    create_mutator=_create_mutator,
    snapshot=build_snapshot,
)


def available() -> bool:
    """The census DLL ships with PyOpenGL; gate tests on its presence."""
    return DEFAULT_DLL.exists()
