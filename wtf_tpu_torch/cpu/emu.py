"""Pure-Python x86-64 oracle executor over decoded Uops.

Role in the system (SURVEY.md §4): the reference's development workflow
validates the fast backends against deterministic bochscpu `rip` traces; we
keep the same methodology with this module as the trace producer.  It shares
the decoder (cpu/decoder.py) with the device path, so a differential test
pins down exactly one thing: that the device executor (interp/step.py)
implements the same *semantics* for each uop.  It also powers the `emu` execution
backend (the "fake backend" seam, reference `Backend_t` §2.2) so the whole
harness/fuzz/distribution plane is testable without a TPU.

Unsupported-instruction policy: raise/flag, never guess — identical to the
device executor's UNSUPPORTED status.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from wtf_tpu_torch.core.cpustate import (
    CpuState,
    RFLAGS_AF, RFLAGS_CF, RFLAGS_DF, RFLAGS_OF, RFLAGS_PF, RFLAGS_SF,
    RFLAGS_ZF,
)
from wtf_tpu_torch.core.gxa import PAGE_SHIFT, PAGE_SIZE
from wtf_tpu_torch.cpu import uops as U
from wtf_tpu_torch.cpu.cpuid import cpuid, splitmix64
from wtf_tpu_torch.cpu.decoder import decode
from wtf_tpu_torch.mem.physmem import PhysMem

MASK64 = (1 << 64) - 1

# MSR number -> EmuCpu attribute for the rdmsr/wrmsr subset the snapshot
# carries (reference: bochs/KVM MSR state, kvm_backend.cc LoadMsrs)
MSR_ATTR = {0x10: "tsc", 0xC0000080: "efer", 0xC0000081: "star",
            0xC0000082: "lstar", 0xC0000084: "sfmask",
            0xC0000100: "fs_base", 0xC0000101: "gs_base",
            0xC0000102: "kernel_gs_base"}

PTE_P = 1
PTE_W = 1 << 1
PTE_PS = 1 << 7
PHYS_MASK = 0x000F_FFFF_FFFF_F000


class MemFault(Exception):
    """Unresolvable guest access (non-present / non-canonical / !W write)."""

    def __init__(self, gva: int, write: bool):
        super().__init__(f"#PF {'write' if write else 'read'} @ {gva:#x}")
        self.gva = gva
        self.write = write


class DivideError(Exception):
    pass


class UnsupportedInsn(Exception):
    def __init__(self, rip: int, raw: bytes):
        super().__init__(f"unsupported instruction @ {rip:#x}: {raw.hex()}")
        self.rip = rip
        self.raw = raw


class EmuMem:
    """Overlay-on-snapshot memory, mirroring mem/overlay.py semantics: the
    base image is immutable; writes copy pages into a dict overlay; reset()
    is O(dirty)."""

    def __init__(self, physmem: PhysMem):
        self.phys = physmem
        self.overlay: Dict[int, bytearray] = {}

    def reset(self) -> None:
        self.overlay.clear()

    def dirty_pfns(self) -> List[int]:
        return sorted(self.overlay)

    def _page(self, pfn: int, for_write: bool) -> bytes:
        if pfn in self.overlay:
            return self.overlay[pfn]
        if for_write:
            base = self.phys.host_read(pfn << PAGE_SHIFT, PAGE_SIZE)
            page = bytearray(base)
            self.overlay[pfn] = page
            return page
        return self.phys.host_read(pfn << PAGE_SHIFT, PAGE_SIZE)

    def phys_read(self, gpa: int, size: int) -> bytes:
        out = bytearray()
        pos = gpa
        while pos < gpa + size:
            pfn = pos >> PAGE_SHIFT
            off = pos & (PAGE_SIZE - 1)
            chunk = min(gpa + size - pos, PAGE_SIZE - off)
            page = self._page(pfn, for_write=False)
            out += page[off : off + chunk]
            pos += chunk
        return bytes(out)

    def phys_write(self, gpa: int, data: bytes) -> None:
        pos = 0
        while pos < len(data):
            addr = gpa + pos
            pfn = addr >> PAGE_SHIFT
            off = addr & (PAGE_SIZE - 1)
            chunk = min(len(data) - pos, PAGE_SIZE - off)
            page = self._page(pfn, for_write=True)
            page[off : off + chunk] = data[pos : pos + chunk]
            pos += chunk

    def phys_read_u64(self, gpa: int) -> int:
        return int.from_bytes(self.phys_read(gpa, 8), "little")


def _f80_to_f64_bits(v80: int) -> int:
    """80-bit x87 extended -> f64 bits (round-to-nearest-even on the
    mantissa; overflow -> inf, tiny -> 0; good enough for reducing a
    snapshot's FPU stack into the double-precision model)."""
    import struct as _struct

    sign = (v80 >> 79) & 1
    exp = (v80 >> 64) & 0x7FFF
    mant = v80 & ((1 << 64) - 1)
    if exp == 0x7FFF:  # inf / nan
        frac = (mant >> 11) & ((1 << 52) - 1)
        if mant & ((1 << 63) - 1):  # nan: keep top payload bits, quiet
            frac |= 1 << 51
        return (sign << 63) | (0x7FF << 52) | frac
    if exp == 0 and mant == 0:
        return sign << 63
    # normalize (pseudo-denormals included: integer bit may be 0)
    e = exp - 16383
    m = mant
    if m == 0:
        return sign << 63
    while not m >> 63:
        m <<= 1
        e -= 1
    import math

    try:
        f = math.ldexp(m / (1 << 63), e)  # m/2^63 rounds the mantissa once
    except OverflowError:
        f = math.inf
    if sign:
        f = -f
    return int.from_bytes(_struct.pack("<d", f), "little")


def _f64_to_f80(bits64: int) -> int:
    """f64 bits -> 80-bit x87 extended (exact; for the fxsave image)."""
    sign = (bits64 >> 63) & 1
    exp = (bits64 >> 52) & 0x7FF
    frac = bits64 & ((1 << 52) - 1)
    if exp == 0x7FF:  # inf / nan
        mant = (1 << 63) | (frac << 11)
        return (sign << 79) | (0x7FFF << 64) | mant
    if exp == 0:
        if frac == 0:
            return sign << 79
        # denormal: normalize into the explicit-integer-bit format
        e = -1022
        m = frac
        while not m >> 52:
            m <<= 1
            e -= 1
        return ((sign << 79) | ((e + 16383) << 64)
                | ((m & ((1 << 52) - 1)) << 11) | (1 << 63))
    return ((sign << 79) | ((exp - 1023 + 16383) << 64)
            | (1 << 63) | (frac << 11))


def _sx(value: int, bits: int) -> int:
    sign = 1 << (bits - 1)
    return ((value ^ sign) - sign)


def _parity(value: int) -> bool:
    return bin(value & 0xFF).count("1") % 2 == 0


class EmuCpu:
    """One guest vCPU interpreting over an EmuMem."""

    def __init__(self, mem: EmuMem, state: CpuState):
        self.mem = mem
        self.snapshot = state
        self.gpr: List[int] = [0] * 16
        self.xmm: List[List[int]] = [[0, 0] for _ in range(16)]
        # Upper YMM halves (2 limbs each): carried for AVX-bearing
        # snapshot round-trip and the xsave AVX component (reference
        # CpuState_t holds 32xZMM, globals.h:1020-1159); no instruction
        # in the executed subset COMPUTES on them — CPUID steers
        # feature-dispatched code onto SSE2 paths
        self.ymmh: List[List[int]] = [[0, 0] for _ in range(16)]
        self.rip = 0
        self.rflags = 0x2
        self.cr3 = 0
        self.cr0 = 0
        self.cr2 = 0
        self.cr4 = 0
        self.cr8 = 0
        self.cs_sel = 0
        self.ss_sel = 0
        # x87 state: values as f64 bits per PHYSICAL slot (see OPC_X87
        # note in cpu/uops.py for the precision model), TOP kept separate
        # and re-packed into fpsw bits 11-13 at observation points
        self.fpst: List[int] = [0] * 8
        self.fptop = 0
        self.fpcw = 0x27F
        self.fpsw = 0
        self.fptw = 0xFFFF
        self.mxcsr = 0x1F80
        self.fs_base = 0
        self.gs_base = 0
        self.kernel_gs_base = 0
        self.lstar = 0
        self.star = 0
        self.sfmask = 0
        self.efer = 0
        self.tsc = 0
        self.icount = 0
        self.rdrand_state = 0
        self.decode_cache: Dict[int, object] = {}
        # pfn -> rips decoded from that physical page (for SMC/restore flush)
        self.decode_pages: Dict[int, List[int]] = {}
        # when a list, virt_read/virt_write append ("mr"/"mw", gva, size) —
        # the tenet trace writer's lin_access-hook analog (SURVEY §5.1)
        self.access_log = None
        self.load_state(state)

    # -- state ----------------------------------------------------------
    def load_state(self, state: CpuState) -> None:
        self.gpr = state.gpr_list()
        self.rip = state.rip
        self.rflags = state.rflags | 0x2
        self.cr3 = state.cr3
        self.cr0 = state.cr0
        self.cr2 = state.cr2
        self.cr4 = state.cr4
        self.cr8 = state.cr8
        self.cs_sel = state.cs.selector
        self.ss_sel = state.ss.selector
        # snapshot fpst entries may be 80-bit extended (real dumps);
        # reduce to the f64 model on load
        self.fpst = [
            (_f80_to_f64_bits(v) if v >> 64 else v & MASK64)
            for v in state.fpst[:8]] + [0] * (8 - len(state.fpst[:8]))
        self.fpcw = state.fpcw & 0xFFFF
        self.fpsw = state.fpsw & 0xFFFF
        self.fptop = (state.fpsw >> 11) & 7
        self.fptw = state.fptw & 0xFFFF
        self.mxcsr = state.mxcsr & 0xFFFFFFFF
        self.fs_base = state.fs.base
        self.gs_base = state.gs.base
        self.kernel_gs_base = state.kernel_gs_base
        self.lstar = state.lstar
        self.star = state.star
        self.sfmask = state.sfmask
        self.efer = state.efer
        self.tsc = state.tsc
        self.icount = 0
        self.rdrand_state = 0
        self.cr3_event = None
        for i in range(16):
            self.xmm[i] = [state.zmm[i][0], state.zmm[i][1]]
            self.ymmh[i] = [state.zmm[i][2], state.zmm[i][3]]

    # -- registers ------------------------------------------------------
    def read_reg(self, idx: int, size: int) -> int:
        if idx >= U.REG_AH_BASE:
            return (self.gpr[idx - U.REG_AH_BASE] >> 8) & 0xFF
        val = self.gpr[idx]
        return val & ((1 << (size * 8)) - 1)

    def write_reg(self, idx: int, size: int, value: int) -> None:
        if idx >= U.REG_AH_BASE:
            base = idx - U.REG_AH_BASE
            self.gpr[base] = (self.gpr[base] & ~0xFF00) | ((value & 0xFF) << 8)
            return
        if size == 8:
            self.gpr[idx] = value & MASK64
        elif size == 4:
            self.gpr[idx] = value & 0xFFFFFFFF  # 32-bit writes zero-extend
        else:
            mask = (1 << (size * 8)) - 1
            self.gpr[idx] = (self.gpr[idx] & ~mask) | (value & mask)

    # -- translation / memory ------------------------------------------
    def translate(self, gva: int, write: bool) -> int:
        """4-level long-mode walk (reference kvm_backend.cc:1937-1998)."""
        gva &= MASK64
        top = gva >> 47
        if top != 0 and top != 0x1FFFF:
            raise MemFault(gva, write)
        table = self.cr3 & PHYS_MASK
        for shift, large_mask in ((39, None), (30, 0x000F_FFFF_C000_0000),
                                  (21, 0x000F_FFFF_FFE0_0000), (12, None)):
            index = (gva >> shift) & 0x1FF
            entry = self.mem.phys_read_u64(table + index * 8)
            if not entry & PTE_P:
                raise MemFault(gva, write)
            if write and not entry & PTE_W:
                raise MemFault(gva, write)
            if large_mask is not None and entry & PTE_PS:
                return (entry & large_mask) | (gva & ((1 << shift) - 1))
            if shift == 12:
                return (entry & PHYS_MASK) | (gva & 0xFFF)
            table = entry & PHYS_MASK
        raise AssertionError("unreachable")

    def virt_read(self, gva: int, size: int) -> bytes:
        out = bytearray()
        pos = gva
        while pos < gva + size:
            off = pos & (PAGE_SIZE - 1)
            chunk = min(gva + size - pos, PAGE_SIZE - off)
            gpa = self.translate(pos, write=False)
            out += self.mem.phys_read(gpa, chunk)
            pos += chunk
        if self.access_log is not None and size > 0:
            self.access_log.append(("mr", gva, size))
        return bytes(out)

    def virt_write(self, gva: int, data: bytes, enforce: bool = True) -> None:
        pos = 0
        while pos < len(data):
            addr = gva + pos
            off = addr & (PAGE_SIZE - 1)
            chunk = min(len(data) - pos, PAGE_SIZE - off)
            gpa = self.translate(addr, write=enforce)
            self.mem.phys_write(gpa, data[pos : pos + chunk])
            pos += chunk
        if self.access_log is not None and data:
            self.access_log.append(("mw", gva, len(data)))

    def read_u(self, gva: int, size: int) -> int:
        return int.from_bytes(self.virt_read(gva, size), "little")

    def write_u(self, gva: int, size: int, value: int) -> None:
        self.virt_write(gva, (value & ((1 << (size * 8)) - 1)).to_bytes(size, "little"))

    # -- exception-delivery ctx surface (cpu/interrupts.py) --------------
    # IDTR/TR come from the snapshot: lidt/ltr are not emulated, so the
    # tables a snapshot was taken with stay authoritative for its lifetime
    # (true of the reference too — bochs loads them once from CpuState_t).
    @property
    def rsp(self) -> int:
        return self.gpr[4]

    @rsp.setter
    def rsp(self, value: int) -> None:
        self.gpr[4] = value & MASK64

    @property
    def idt_base(self) -> int:
        return self.snapshot.idtr.base

    @property
    def idt_limit(self) -> int:
        return self.snapshot.idtr.limit

    @property
    def tss_base(self) -> int:
        return self.snapshot.tr.base

    def read_virt(self, gva: int, size: int) -> bytes:
        return self.virt_read(gva, size)

    def read_u64(self, gva: int) -> int:
        return self.read_u(gva, 8)

    def write_u64(self, gva: int, value: int) -> None:
        self.write_u(gva, 8, value)

    def set_cr2(self, value: int) -> None:
        self.cr2 = value & MASK64

    # -- x87 state observation (lane writeback / fxsave) -----------------
    def fp_state_list(self) -> List[int]:
        return list(self.fpst)

    def fpsw_packed(self) -> int:
        return (self.fpsw & ~0x3800) | ((self.fptop & 7) << 11)

    def deliver_exception(self, vector: int, error_code: int = 0,
                          cr2=None) -> None:
        """Vector a fault through the guest IDT (cpu/interrupts.py)."""
        from wtf_tpu_torch.cpu.interrupts import deliver_exception

        deliver_exception(self, vector, error_code, cr2)

    # -- flags ----------------------------------------------------------
    def get_flag(self, bit: int) -> bool:
        return bool(self.rflags & bit)

    def set_flags(self, **kw) -> None:
        table = {
            "cf": RFLAGS_CF, "pf": RFLAGS_PF, "af": RFLAGS_AF,
            "zf": RFLAGS_ZF, "sf": RFLAGS_SF, "of": RFLAGS_OF,
            "df": RFLAGS_DF,
        }
        for name, val in kw.items():
            bit = table[name]
            if val:
                self.rflags |= bit
            else:
                self.rflags &= ~bit

    def _flags_logic(self, result: int, bits: int) -> None:
        mask = (1 << bits) - 1
        r = result & mask
        self.set_flags(cf=False, of=False, af=False,
                       zf=r == 0, sf=bool(r >> (bits - 1)), pf=_parity(r))

    def _flags_add(self, a: int, b: int, r: int, bits: int, carry_in: int = 0) -> None:
        mask = (1 << bits) - 1
        full = (a & mask) + (b & mask) + carry_in
        rm = r & mask
        self.set_flags(
            cf=full > mask,
            af=bool((a ^ b ^ r) & 0x10),
            zf=rm == 0,
            sf=bool(rm >> (bits - 1)),
            of=bool(((a ^ r) & (b ^ r)) >> (bits - 1) & 1),
            pf=_parity(rm),
        )

    def _flags_sub(self, a: int, b: int, r: int, bits: int, borrow_in: int = 0) -> None:
        mask = (1 << bits) - 1
        self.set_flags(
            cf=(a & mask) < (b & mask) + borrow_in,
            af=bool((a ^ b ^ r) & 0x10),
            zf=(r & mask) == 0,
            sf=bool((r & mask) >> (bits - 1)),
            of=bool(((a ^ b) & (a ^ r)) >> (bits - 1) & 1),
            pf=_parity(r),
        )

    def eval_cond(self, cc: int) -> bool:
        f = self.rflags
        cf, zf = bool(f & RFLAGS_CF), bool(f & RFLAGS_ZF)
        sf, of = bool(f & RFLAGS_SF), bool(f & RFLAGS_OF)
        pf = bool(f & RFLAGS_PF)
        table = [
            of, not of, cf, not cf, zf, not zf, cf or zf, not (cf or zf),
            sf, not sf, pf, not pf, sf != of, sf == of,
            zf or (sf != of), not zf and sf == of,
        ]
        if cc == 16:  # jrcxz
            return self.gpr[1] == 0  # rcx
        if cc == 17:  # jecxz (67h form)
            return self.gpr[1] & 0xFFFFFFFF == 0
        return table[cc]

    # -- addressing -----------------------------------------------------
    def effective_addr(self, uop: U.Uop, next_rip: int) -> int:
        addr = uop.disp
        if uop.base_reg == U.REG_RIP:
            addr += next_rip
        elif uop.base_reg != U.REG_NONE:
            addr += self.gpr[uop.base_reg]
        if uop.idx_reg != U.REG_NONE:
            addr += self.gpr[uop.idx_reg] * uop.scale
        if uop.a32:
            # 67h truncates the un-segmented EA to 32 bits (SDM 64-bit
            # address-size override), BEFORE the segment base applies
            addr &= 0xFFFF_FFFF
        if uop.seg == U.SEG_FS:
            addr += self.fs_base
        elif uop.seg == U.SEG_GS:
            addr += self.gs_base
        return addr & MASK64

    # -- fetch/decode/execute -------------------------------------------
    def restore(self, state: Optional[CpuState] = None) -> None:
        """Per-testcase restore: flush uops decoded from pages this run
        dirtied (their bytes roll back with the overlay), reset memory, and
        reload registers.  The cheap path of the reference's
        `Backend_t::Restore` (SURVEY.md §5.4)."""
        for pfn in self.mem.dirty_pfns():
            for rip in self.decode_pages.pop(pfn, ()):
                self.decode_cache.pop(rip, None)
        self.mem.reset()
        self.load_state(state or self.snapshot)

    def fetch_decode(self) -> U.Uop:
        cached = self.decode_cache.get(self.rip)
        window = b""
        if cached is None:
            window = self._fetch_window()
            uop = decode(window, self.rip)
            self.decode_cache[self.rip] = uop
            try:
                first = self.translate(self.rip, write=False) >> PAGE_SHIFT
                last = self.translate(self.rip + max(uop.length - 1, 0),
                                      write=False) >> PAGE_SHIFT
                for pfn in {first, last}:
                    self.decode_pages.setdefault(pfn, []).append(self.rip)
            except MemFault:
                pass
            cached = uop
        else:
            # self-modifying-code guard: revalidate raw bytes if either page
            # the instruction spans is dirty (mirrors the device SMC check)
            dirty = False
            try:
                span = max(len(cached.raw) - 1, 0)
                for off in {0, span}:
                    pfn = self.translate(self.rip + off, write=False) >> PAGE_SHIFT
                    dirty |= pfn in self.mem.overlay
            except MemFault:
                pass
            if dirty:
                window = self._fetch_window()
                if not window.startswith(cached.raw):
                    cached = decode(window, self.rip)
                    self.decode_cache[self.rip] = cached
        return cached

    def _fetch_window(self) -> bytes:
        try:
            return self.virt_read(self.rip, 15)
        except MemFault:
            # near end of mapped region: fetch what we can, byte at a time
            out = bytearray()
            for i in range(15):
                try:
                    out += self.virt_read(self.rip + i, 1)
                except MemFault:
                    break
            if not out:
                raise
            return bytes(out)

    def step(self) -> None:
        """Execute exactly one instruction (one uop)."""
        # fetches are not data accesses: keep them out of the access log
        # (bochs' lin_access hook fires for data, not fetch)
        log, self.access_log = self.access_log, None
        try:
            uop = self.fetch_decode()
        finally:
            self.access_log = log
        self.execute(uop)
        self.icount += 1

    def execute(self, uop: U.Uop) -> None:  # noqa: C901 - one big dispatcher
        opc = uop.opc
        next_rip = (self.rip + uop.length) & MASK64
        opsize = uop.opsize
        bits = opsize * 8
        mask = (1 << bits) - 1

        if opc == U.OPC_INVALID:
            raise UnsupportedInsn(self.rip, uop.raw)

        if opc in (U.OPC_NOP, U.OPC_FENCE):
            self.rip = next_rip
            return

        # ---- generic source value -------------------------------------
        ea = None
        if uop.mem_operand() or opc == U.OPC_LEA:
            ea = self.effective_addr(uop, next_rip)

        def load_src() -> int:
            srcsize = uop.srcsize or opsize
            if uop.src_kind == U.K_REG:
                val = self.read_reg(uop.src_reg, srcsize)
            elif uop.src_kind == U.K_MEM:
                val = self.read_u(ea, srcsize)
            elif uop.src_kind == U.K_IMM:
                return uop.imm & mask
            else:
                return 0
            if uop.sext == 1:
                val = _sx(val, srcsize * 8) & mask
            else:
                val &= mask
            return val

        def load_dst() -> int:
            if uop.dst_kind == U.K_REG:
                return self.read_reg(uop.dst_reg, opsize)
            if uop.dst_kind == U.K_MEM:
                return self.read_u(ea, opsize)
            return 0

        def store_dst(value: int) -> None:
            if uop.dst_kind == U.K_REG:
                self.write_reg(uop.dst_reg, opsize, value)
            elif uop.dst_kind == U.K_MEM:
                self.write_u(ea, opsize, value)

        # ---- dispatch ---------------------------------------------------
        if opc == U.OPC_MOV:
            store_dst(load_src())
        elif opc == U.OPC_LEA:
            self.write_reg(uop.dst_reg, opsize, ea)
        elif opc == U.OPC_ALU:
            self._exec_alu(uop, load_src(), load_dst, store_dst, bits)
        elif opc == U.OPC_SHIFT:
            self._exec_shift(uop, load_src, load_dst, store_dst, bits)
        elif opc == U.OPC_UNARY:
            self._exec_unary(uop, load_dst, store_dst, bits)
        elif opc == U.OPC_MUL:
            self._exec_mul(uop, load_src(), bits)
        elif opc == U.OPC_DIV:
            self._exec_div(uop, load_src(), bits)
        elif opc == U.OPC_PUSH:
            # store before committing rsp: a faulting push must leave rsp
            # untouched so the #PF-deliver-and-retry path (interrupts.py)
            # re-executes it from pristine state, like the device path
            # which gates all commits on ~page_fault
            val = load_src()
            new_rsp = (self.gpr[4] - opsize) & MASK64
            self.write_u(new_rsp, opsize, val)
            self.gpr[4] = new_rsp
        elif opc == U.OPC_POP:
            val = self.read_u(self.gpr[4], opsize)
            self.gpr[4] = (self.gpr[4] + opsize) & MASK64
            store_dst(val)
        elif opc == U.OPC_CALL:
            target = (next_rip + uop.imm) & MASK64 if uop.src_kind == U.K_IMM \
                else load_src()
            new_rsp = (self.gpr[4] - 8) & MASK64
            self.write_u(new_rsp, 8, next_rip)  # may fault: commit after
            self.gpr[4] = new_rsp
            self.rip = target
            return
        elif opc == U.OPC_RET:
            self.rip = self.read_u(self.gpr[4], 8)
            self.gpr[4] = (self.gpr[4] + 8 + uop.imm) & MASK64
            return
        elif opc == U.OPC_IRET:
            if uop.sub == 1:
                # retf [imm16]: pop rip + cs; an inter-privilege far
                # return also pops SS:RSP (64-bit far forms, SDM RET)
                rsp = self.gpr[4]
                new_rip = self.read_u(rsp, 8)
                new_cs = self.read_u(rsp + 8, 8) & 0xFFFF
                rsp = (rsp + 16 + uop.imm) & MASK64
                if (new_cs & 3) != (self.cs_sel & 3):
                    self.gpr[4] = rsp  # frame continues at adjusted rsp
                    new_rsp = self.read_u(self.gpr[4], 8)
                    self.ss_sel = self.read_u(self.gpr[4] + 8, 8) & 0xFFFF
                    # SDM RET-far: imm16 releases parameter bytes from the
                    # NEW stack as well after popping SS:RSP
                    rsp = (new_rsp + uop.imm) & MASK64
                self.rip = new_rip
                self.cs_sel = new_cs
                self.gpr[4] = rsp
                return
            # iretq: pop rip, cs, rflags, rsp, ss (five qwords).  The
            # selectors track CPL for exception delivery (cpu/interrupts.py)
            # but are not validated against the GDT — flat memory model,
            # protection lives in the page tables.  Reference gets the full
            # check from bochs/KVM.
            if uop.opsize != 8:
                raise UnsupportedInsn(self.rip, uop.raw)  # iretd (no REX.W)
            rsp = self.gpr[4]
            new_rip = self.read_u(rsp, 8)
            new_cs = self.read_u(rsp + 8, 8)
            new_rflags = self.read_u(rsp + 16, 8)
            new_rsp = self.read_u(rsp + 24, 8)
            new_ss = self.read_u(rsp + 32, 8)
            self.rip = new_rip
            self.rflags = (new_rflags | 0x2) & U.RF_WRITABLE
            self.gpr[4] = new_rsp & MASK64
            self.cs_sel = new_cs & 0xFFFF
            self.ss_sel = new_ss & 0xFFFF
            return
        elif opc == U.OPC_JMP:
            self.rip = (next_rip + uop.imm) & MASK64 if uop.src_kind == U.K_IMM \
                else load_src()
            return
        elif opc == U.OPC_JCC:
            if self.eval_cond(uop.cond):
                self.rip = (next_rip + uop.imm) & MASK64
                return
        elif opc == U.OPC_SETCC:
            store_dst(1 if self.eval_cond(uop.cond) else 0)
        elif opc == U.OPC_CMOVCC:
            value = load_src() if self.eval_cond(uop.cond) else load_dst()
            store_dst(value)  # always writes (64-bit mode zero-extension)
        elif opc == U.OPC_STRING:
            if not self._exec_string(uop, opsize):
                return  # rip unchanged: more REP iterations pending
        elif opc == U.OPC_XCHG:
            a = load_dst()
            b = load_src()
            store_dst(b)
            if uop.src_kind == U.K_REG:
                self.write_reg(uop.src_reg, opsize, a)
        elif opc == U.OPC_CONVERT:
            self._exec_convert(uop, bits)
        elif opc == U.OPC_BT:
            self._exec_bt(uop, ea, bits)
        elif opc == U.OPC_BITSCAN:
            self._exec_bitscan(uop, load_src(), bits)
        elif opc == U.OPC_PUSHF:
            new_rsp = (self.gpr[4] - 8) & MASK64
            self.write_u(new_rsp, 8, self.rflags | 0x2)  # may fault
            self.gpr[4] = new_rsp
        elif opc == U.OPC_POPF:
            val = self.read_u(self.gpr[4], 8)
            self.gpr[4] = (self.gpr[4] + 8) & MASK64
            settable = 0xFD5 | RFLAGS_DF | 0x100 | 0x200 | (1 << 18)
            self.rflags = (val & settable) | 0x2
        elif opc == U.OPC_FLAGOP:
            self._exec_flagop(uop)
        elif opc == U.OPC_BSWAP:
            val = self.read_reg(uop.dst_reg, opsize)
            self.write_reg(uop.dst_reg, opsize,
                           int.from_bytes(val.to_bytes(opsize, "little"), "big"))
        elif opc == U.OPC_CMPXCHG:
            dst = load_dst()
            acc = self.read_reg(0, opsize)
            self._flags_sub(acc, dst, (acc - dst) & mask, bits)
            if acc == dst:
                store_dst(self.read_reg(uop.src_reg, opsize))
            else:
                # Intel: on failure the destination is still written back
                store_dst(dst)
                self.write_reg(0, opsize, dst)
        elif opc == U.OPC_XADD:
            dst = load_dst()
            src = self.read_reg(uop.src_reg, opsize)
            r = (dst + src) & mask
            self._flags_add(dst, src, r, bits)
            self.write_reg(uop.src_reg, opsize, dst)
            store_dst(r)
        elif opc == U.OPC_LEAVE:
            if uop.sub == 1:  # enter size, 0: push rbp; rbp = rsp; alloc
                new_rsp = (self.gpr[4] - 8) & MASK64
                self.write_u(new_rsp, 8, self.gpr[5])  # may fault: rsp last
                self.gpr[5] = new_rsp
                self.gpr[4] = (new_rsp - uop.imm) & MASK64
            else:
                self.gpr[4] = self.gpr[5]
                self.gpr[5] = self.read_u(self.gpr[4], 8)
                self.gpr[4] = (self.gpr[4] + 8) & MASK64
        elif opc == U.OPC_RDTSC:
            tsc = (self.tsc + self.icount) & MASK64
            self.write_reg(0, 8, tsc & 0xFFFFFFFF)
            self.write_reg(2, 8, tsc >> 32)
        elif opc == U.OPC_PEXT:
            # BMI1/BMI2 scalar bit ops (VEX-encoded).  Third operand
            # (VEX.vvvv) rides in uop.cond per the decoder's convention.
            src = load_src()                      # the r/m operand
            third = self.read_reg(uop.cond, opsize)
            sub = uop.sub
            if sub == U.BMI_ANDN:                 # dst = ~vvvv & r/m
                res = (~third & src) & mask
                self.set_flags(sf=bool(res >> (bits - 1)), zf=res == 0,
                               cf=False, of=False)
            elif sub == U.BMI_BZHI:               # zero bits >= vvvv[7:0]
                n = third & 0xFF
                res = src & ((1 << n) - 1) if n < bits else src
                self.set_flags(cf=n > bits - 1, zf=res == 0,
                               sf=bool(res >> (bits - 1)), of=False)
            elif sub == U.BMI_BEXTR:              # field extract by vvvv
                start = third & 0xFF
                ln = (third >> 8) & 0xFF
                res = (src >> start) & ((1 << ln) - 1) if start < bits else 0
                res &= mask
                self.set_flags(zf=res == 0, cf=False, of=False)
            elif sub in (U.BMI_SHLX, U.BMI_SHRX, U.BMI_SARX):  # no flags
                cnt = third & (63 if opsize == 8 else 31)
                if sub == U.BMI_SHLX:
                    res = (src << cnt) & mask
                elif sub == U.BMI_SHRX:
                    res = src >> cnt
                else:
                    res = (_sx(src, bits) >> cnt) & mask
            elif sub == U.BMI_PDEP:               # deposit vvvv into r/m mask
                res, k = 0, 0
                for i in range(bits):
                    if (src >> i) & 1:
                        res |= ((third >> k) & 1) << i
                        k += 1
            elif sub == U.BMI_PEXT_:              # extract r/m-mask bits of vvvv
                res, k = 0, 0
                for i in range(bits):
                    if (src >> i) & 1:
                        res |= ((third >> i) & 1) << k
                        k += 1
            elif sub == U.BMI_BLSR:               # clear lowest set bit
                res = src & (src - 1) & mask
                self.set_flags(cf=src == 0, zf=res == 0,
                               sf=bool(res >> (bits - 1)), of=False)
            elif sub == U.BMI_BLSMSK:             # mask up to lowest set bit
                res = (src ^ (src - 1)) & mask
                self.set_flags(cf=src == 0, zf=res == 0,
                               sf=bool(res >> (bits - 1)), of=False)
            elif sub == U.BMI_BLSI:               # isolate lowest set bit
                res = src & (-src & mask) & mask
                self.set_flags(cf=src != 0, zf=res == 0,
                               sf=bool(res >> (bits - 1)), of=False)
            elif sub == U.BMI_RORX:               # rotate right, no flags
                n = uop.imm & (63 if opsize == 8 else 31)
                res = ((src >> n) | (src << (bits - n))) & mask if n else src
            else:
                raise UnsupportedInsn(self.rip, uop.raw)
            self.write_reg(uop.dst_reg, opsize, res)
        elif opc == U.OPC_MSR:
            # rdmsr/wrmsr over the MSR-backed fields the snapshot carries
            # (reference: bochs/KVM MSR state, kvm_backend.cc LoadMsrs)
            msr = self.gpr[1] & 0xFFFFFFFF
            attr = MSR_ATTR.get(msr)
            if attr is None:
                raise UnsupportedInsn(self.rip, uop.raw)
            if uop.sub == 1:  # wrmsr: edx:eax
                value = ((self.gpr[2] & 0xFFFFFFFF) << 32) \
                    | (self.gpr[0] & 0xFFFFFFFF)
                if attr == "tsc":  # keep rdtsc = tsc_base + icount coherent
                    value = (value - self.icount) & MASK64
                setattr(self, attr, value)
            else:             # rdmsr -> edx:eax (32-bit zero-extending)
                value = getattr(self, attr)
                if attr == "tsc":
                    value = (value + self.icount) & MASK64
                self.write_reg(0, 8, value & 0xFFFFFFFF)
                self.write_reg(2, 8, value >> 32)
        elif opc == U.OPC_RDRAND:
            self.rdrand_state = splitmix64(self.rdrand_state)
            store_dst(self.rdrand_state & mask)
            self.set_flags(cf=True, of=False, af=False, zf=False, sf=False, pf=False)
        elif opc == U.OPC_CPUID:
            eax, ebx, ecx, edx = cpuid(self.gpr[0] & 0xFFFFFFFF,
                                       self.gpr[1] & 0xFFFFFFFF)
            self.write_reg(0, 4, eax)
            self.write_reg(3, 4, ebx)
            self.write_reg(1, 4, ecx)
            self.write_reg(2, 4, edx)
        elif opc == U.OPC_XGETBV:
            self.write_reg(0, 4, 0x7)  # x87+SSE+AVX state enabled
            self.write_reg(2, 4, 0)
        elif opc == U.OPC_VZEROALL:
            # sub 0: vzeroall — the full vector registers; sub 1:
            # vzeroupper — only the upper YMM halves
            for i in range(16):
                if uop.sub == 0:
                    self.xmm[i] = [0, 0]
                self.ymmh[i] = [0, 0]
        elif opc == U.OPC_SYSCALL:
            if uop.sub == 0:
                self.gpr[1] = next_rip                       # rcx
                self.gpr[11] = self.rflags & ~0x10000        # r11 (RF clear)
                self.rflags = (self.rflags & ~(self.sfmask | 0x100)) | 0x2
                self.rip = self.lstar
                # CS/SS from IA32_STAR[47:32] (SDM: SYSCALL loads CPL-0
                # selectors; tracked for exception delivery)
                self.cs_sel = (self.star >> 32) & 0xFFFC
                self.ss_sel = ((self.star >> 32) & 0xFFFC) + 8
                return
            else:  # sysret
                self.rip = self.gpr[1]
                self.rflags = (self.gpr[11] & U.RF_WRITABLE) | 0x2
                # CS/SS from IA32_STAR[63:48] (SYSRET 64-bit forms)
                self.cs_sel = (((self.star >> 48) & 0xFFFF) + 16) | 3
                self.ss_sel = (((self.star >> 48) & 0xFFFF) + 8) | 3
                return
        elif opc == U.OPC_RDGSBASE:
            if uop.sub == 4:  # swapgs
                self.gs_base, self.kernel_gs_base = \
                    self.kernel_gs_base, self.gs_base
            elif uop.sub == 0:  # rdfsbase
                self.write_reg(uop.dst_reg, uop.opsize, self.fs_base)
            elif uop.sub == 1:  # rdgsbase
                self.write_reg(uop.dst_reg, uop.opsize, self.gs_base)
            elif uop.sub in (2, 3):  # wrfsbase/wrgsbase (r32 zero-extends)
                value = self.read_reg(uop.dst_reg, uop.opsize)
                if (value >> 47) not in (0, 0x1FFFF):
                    # hardware #GPs on a non-canonical base; MemFault on
                    # the value routes through deliver_page_fault's
                    # non-canonical -> #GP(0) path (cpu/interrupts.py)
                    raise MemFault(value, write=False)
                if uop.sub == 2:
                    self.fs_base = value
                else:
                    self.gs_base = value
            else:
                raise UnsupportedInsn(self.rip, uop.raw)
        elif opc == U.OPC_MOVCR:
            self._exec_movcr(uop)
        elif opc == U.OPC_SSEMOV:
            self._exec_ssemov(uop, ea)
        elif opc == U.OPC_SSEALU:
            self._exec_ssealu(uop, ea)
        elif opc == U.OPC_SSEFP:
            self._exec_ssefp(uop, ea)
        elif opc == U.OPC_X87:
            self._exec_x87(uop, ea)
        elif opc in (U.OPC_INT, U.OPC_HLT, U.OPC_INT1):
            raise GuestCrash(self.rip, uop)
        else:
            raise UnsupportedInsn(self.rip, uop.raw)

        self.rip = next_rip

    # -- op-class helpers ----------------------------------------------
    def _exec_alu(self, uop, b, load_dst, store_dst, bits) -> None:
        mask = (1 << bits) - 1
        a = load_dst()
        sub = uop.sub
        if sub == U.ALU_ADD:
            r = (a + b) & mask
            self._flags_add(a, b, r, bits)
            store_dst(r)
        elif sub == U.ALU_ADC:
            c = int(self.get_flag(RFLAGS_CF))
            r = (a + b + c) & mask
            self._flags_add(a, b, r, bits, carry_in=c)
            store_dst(r)
        elif sub == U.ALU_SUB:
            r = (a - b) & mask
            self._flags_sub(a, b, r, bits)
            store_dst(r)
        elif sub == U.ALU_SBB:
            c = int(self.get_flag(RFLAGS_CF))
            r = (a - b - c) & mask
            self._flags_sub(a, b, r, bits, borrow_in=c)
            store_dst(r)
        elif sub == U.ALU_CMP:
            r = (a - b) & mask
            self._flags_sub(a, b, r, bits)
        elif sub == U.ALU_AND:
            r = a & b
            self._flags_logic(r, bits)
            store_dst(r)
        elif sub == U.ALU_OR:
            r = a | b
            self._flags_logic(r, bits)
            store_dst(r)
        elif sub == U.ALU_XOR:
            r = a ^ b
            self._flags_logic(r, bits)
            store_dst(r)
        elif sub == U.ALU_TEST:
            self._flags_logic(a & b, bits)

    def _exec_shift(self, uop, load_src, load_dst, store_dst, bits) -> None:
        mask = (1 << bits) - 1
        a = load_dst()
        sub = uop.sub
        if sub in (U.SH_SHLD, U.SH_SHRD):
            filler = self.read_reg(uop.src_reg, uop.opsize)
            count = (uop.imm if uop.sext == 3 else self.read_reg(1, 1)) \
                & (0x3F if bits == 64 else 0x1F)
            if count == 0:
                return
            if count > bits:
                count %= bits  # 16-bit forms w/ count>16: arch-undefined
            if sub == U.SH_SHLD:
                wide = (a << bits) | filler
                r = (wide >> (bits - count)) & mask
                cf = bool((a >> (bits - count)) & 1)
            else:
                wide = (filler << bits) | a
                r = (wide >> count) & mask
                cf = bool((a >> (count - 1)) & 1)
            self.set_flags(cf=cf, zf=r == 0, sf=bool(r >> (bits - 1)),
                           pf=_parity(r),
                           of=bool((r ^ a) >> (bits - 1)) if count == 1 else False)
            store_dst(r)
            return

        count_raw = load_src()
        count = count_raw & (0x3F if bits == 64 else 0x1F)
        if sub in (U.SH_RCL, U.SH_RCR):
            count = count % (bits + 1)
        if count == 0:
            return
        cf_in = int(self.get_flag(RFLAGS_CF))
        of = self.get_flag(RFLAGS_OF)

        if sub in (U.SH_SHL, U.SH_SAL):
            r = (a << count) & mask
            cf = bool((a >> (bits - count)) & 1) if count <= bits else False
            of = (bool(r >> (bits - 1)) != cf) if count == 1 else of
        elif sub == U.SH_SHR:
            r = (a >> count) & mask
            cf = bool((a >> (count - 1)) & 1) if count <= bits else False
            of = bool(a >> (bits - 1)) if count == 1 else of
        elif sub == U.SH_SAR:
            sa = _sx(a, bits)
            r = (sa >> count) & mask
            cf = bool((sa >> (count - 1)) & 1)
            of = False if count == 1 else of
        elif sub == U.SH_ROL:
            c = count % bits
            r = ((a << c) | (a >> (bits - c))) & mask if c else a
            cf = bool(r & 1)
            of = (bool(r >> (bits - 1)) != cf) if count == 1 else of
        elif sub == U.SH_ROR:
            c = count % bits
            r = ((a >> c) | (a << (bits - c))) & mask if c else a
            cf = bool(r >> (bits - 1))
            of = (bool(r >> (bits - 1)) != bool((r >> (bits - 2)) & 1)) \
                if count == 1 else of
        elif sub == U.SH_RCL:
            wide = (cf_in << bits) | a
            c = count
            full = bits + 1
            r_wide = ((wide << c) | (wide >> (full - c))) & ((1 << full) - 1)
            r = r_wide & mask
            cf = bool(r_wide >> bits)
            of = (bool(r >> (bits - 1)) != cf) if count == 1 else of
        else:  # RCR
            wide = (cf_in << bits) | a
            c = count
            full = bits + 1
            r_wide = ((wide >> c) | (wide << (full - c))) & ((1 << full) - 1)
            r = r_wide & mask
            cf = bool(r_wide >> bits)
            of = (bool(a >> (bits - 1)) != cf_in) if count == 1 else of

        if sub in (U.SH_RCL, U.SH_RCR):
            self.set_flags(cf=cf, of=of)
        else:
            self.set_flags(cf=cf, of=of, zf=(r & mask) == 0,
                           sf=bool((r & mask) >> (bits - 1)), pf=_parity(r))
        store_dst(r)

    def _exec_unary(self, uop, load_dst, store_dst, bits) -> None:
        mask = (1 << bits) - 1
        a = load_dst()
        sub = uop.sub
        if sub == U.UN_NOT:
            store_dst(~a & mask)
            return
        cf = self.get_flag(RFLAGS_CF)
        if sub == U.UN_INC:
            r = (a + 1) & mask
            self._flags_add(a, 1, r, bits)
            self.set_flags(cf=cf)  # inc/dec preserve CF
        elif sub == U.UN_DEC:
            r = (a - 1) & mask
            self._flags_sub(a, 1, r, bits)
            self.set_flags(cf=cf)
        else:  # NEG
            r = (-a) & mask
            self._flags_sub(0, a, r, bits)
            self.set_flags(cf=a != 0)
        store_dst(r)

    def _exec_mul(self, uop, b, bits) -> None:
        mask = (1 << bits) - 1
        if uop.sub == U.MUL_2OP:
            a = self.read_reg(uop.dst_reg, uop.opsize)
            if uop.sext == 2:  # 3-operand: r = r/m * imm
                a = b
                b = uop.imm & mask
            prod = _sx(a, bits) * _sx(b, bits)
            r = prod & mask
            overflow = prod != _sx(r, bits)
            self.write_reg(uop.dst_reg, uop.opsize, r)
            self.set_flags(cf=overflow, of=overflow, zf=False,
                           sf=bool(r >> (bits - 1)), pf=_parity(r), af=False)
            return
        a = self.read_reg(0, uop.opsize)
        if uop.sub == U.MUL_WIDE_U:
            prod = a * b
            overflow = prod >> bits != 0
        else:
            prod = _sx(a, bits) * _sx(b, bits)
            overflow = prod != _sx(prod & mask, bits)
            prod &= (1 << (bits * 2)) - 1
        lo, hi = prod & mask, (prod >> bits) & mask
        if uop.opsize == 1:
            self.write_reg(0, 2, prod & 0xFFFF)  # ax = al*src
        else:
            self.write_reg(0, uop.opsize, lo)
            self.write_reg(2, uop.opsize, hi)   # rdx
        self.set_flags(cf=overflow, of=overflow)

    def _exec_div(self, uop, b, bits) -> None:
        mask = (1 << bits) - 1
        if b == 0:
            raise DivideError()
        if uop.opsize == 1:
            dividend = self.read_reg(0, 2)  # ax
        else:
            dividend = (self.read_reg(2, uop.opsize) << bits) | \
                self.read_reg(0, uop.opsize)
        if uop.sub == U.DIV_U:
            q, r = divmod(dividend, b)
            if q > mask:
                raise DivideError()
        else:
            sd = _sx(dividend, bits * 2)
            sb = _sx(b, bits)
            q = int(sd / sb)  # truncation toward zero
            r = sd - q * sb
            if q > (mask >> 1) or q < -(mask >> 1) - 1:
                raise DivideError()
        if uop.opsize == 1:
            self.write_reg(0, 1, q & 0xFF)
            self.write_reg(U.REG_AH_BASE, 1, r & 0xFF)  # ah
        else:
            self.write_reg(0, uop.opsize, q & mask)
            self.write_reg(2, uop.opsize, r & mask)

    def _exec_string(self, uop, opsize) -> bool:
        if uop.a32:
            # 67h string forms address via 32-bit rsi/rdi/rcx — not
            # modeled; refuse rather than run with 64-bit registers
            raise UnsupportedInsn(self.rip, uop.raw)
        """One string-op iteration; returns True when rip should advance."""
        if uop.rep != U.REP_NONE and self.gpr[1] == 0:  # rcx
            return True
        delta = -opsize if self.get_flag(RFLAGS_DF) else opsize
        sub = uop.sub
        rsi, rdi = self.gpr[6], self.gpr[7]
        if sub == U.STR_MOVS:
            self.virt_write(rdi, self.virt_read(rsi, opsize))
            self.gpr[6] = (rsi + delta) & MASK64
            self.gpr[7] = (rdi + delta) & MASK64
        elif sub == U.STR_STOS:
            self.write_u(rdi, opsize, self.read_reg(0, opsize))
            self.gpr[7] = (rdi + delta) & MASK64
        elif sub == U.STR_LODS:
            self.write_reg(0, opsize, self.read_u(rsi, opsize))
            self.gpr[6] = (rsi + delta) & MASK64
        elif sub == U.STR_SCAS:
            a = self.read_reg(0, opsize)
            b = self.read_u(rdi, opsize)
            self._flags_sub(a, b, (a - b) & ((1 << (opsize * 8)) - 1), opsize * 8)
            self.gpr[7] = (rdi + delta) & MASK64
        elif sub == U.STR_CMPS:
            a = self.read_u(rsi, opsize)
            b = self.read_u(rdi, opsize)
            self._flags_sub(a, b, (a - b) & ((1 << (opsize * 8)) - 1), opsize * 8)
            self.gpr[6] = (rsi + delta) & MASK64
            self.gpr[7] = (rdi + delta) & MASK64

        if uop.rep == U.REP_NONE:
            return True
        self.gpr[1] = (self.gpr[1] - 1) & MASK64
        if self.gpr[1] == 0:
            return True
        if sub in (U.STR_SCAS, U.STR_CMPS):
            zf = self.get_flag(RFLAGS_ZF)
            if uop.rep == U.REP_REP and not zf:
                return True
            if uop.rep == U.REP_REPNE and zf:
                return True
        return False

    def _exec_convert(self, uop, bits) -> None:
        if uop.sub == 0:  # cbw/cwde/cdqe: widen half-size rax into rax
            half = bits // 2
            val = _sx(self.read_reg(0, uop.opsize) & ((1 << half) - 1), half)
            self.write_reg(0, uop.opsize, val & ((1 << bits) - 1))
        else:  # cwd/cdq/cqo: rdx = sign of rax
            sign = (self.read_reg(0, uop.opsize) >> (bits - 1)) & 1
            self.write_reg(2, uop.opsize, ((1 << bits) - 1) if sign else 0)

    def _exec_bt(self, uop, ea, bits) -> None:
        if uop.src_kind == U.K_IMM:
            offset = uop.imm & (bits - 1)
            bit_base_adjust = 0
        else:
            # register bit index addresses a bit *string* for memory forms:
            # EA moves by opsize for every `bits` of signed offset
            raw = self.read_reg(uop.src_reg, uop.opsize)
            signed = _sx(raw, bits)
            offset = signed & (bits - 1)
            bit_base_adjust = (signed - offset) // bits * uop.opsize
        if uop.dst_kind == U.K_MEM:
            addr = (ea + bit_base_adjust) & MASK64
            val = self.read_u(addr, uop.opsize)
        else:
            val = self.read_reg(uop.dst_reg, uop.opsize)
        bit = (val >> offset) & 1
        self.set_flags(cf=bool(bit))
        sub = uop.sub
        if sub == U.BT_BT:
            return
        if sub == U.BT_BTS:
            val |= 1 << offset
        elif sub == U.BT_BTR:
            val &= ~(1 << offset)
        else:
            val ^= 1 << offset
        if uop.dst_kind == U.K_MEM:
            self.write_u(addr, uop.opsize, val)
        else:
            self.write_reg(uop.dst_reg, uop.opsize, val)

    def _exec_bitscan(self, uop, src, bits) -> None:
        sub = uop.sub
        if sub == U.BS_POPCNT:
            r = bin(src).count("1")
            self.write_reg(uop.dst_reg, uop.opsize, r)
            self.set_flags(cf=False, of=False, af=False, sf=False,
                           pf=False, zf=src == 0)
            return
        if sub in (U.BS_TZCNT, U.BS_LZCNT):
            if src == 0:
                r = bits
            elif sub == U.BS_TZCNT:
                r = (src & -src).bit_length() - 1
            else:
                r = bits - src.bit_length()
            self.write_reg(uop.dst_reg, uop.opsize, r)
            self.set_flags(cf=src == 0, zf=r == 0)
            return
        if src == 0:
            self.set_flags(zf=True)
            return  # dest unmodified (Intel "undefined", hardware keeps it)
        if sub == U.BS_BSF:
            r = (src & -src).bit_length() - 1
        else:
            r = src.bit_length() - 1
        self.write_reg(uop.dst_reg, uop.opsize, r)
        self.set_flags(zf=False)

    def _exec_flagop(self, uop) -> None:
        sub = uop.sub
        if sub == U.FL_CLC:
            self.set_flags(cf=False)
        elif sub == U.FL_STC:
            self.set_flags(cf=True)
        elif sub == U.FL_CMC:
            self.set_flags(cf=not self.get_flag(RFLAGS_CF))
        elif sub == U.FL_CLD:
            self.set_flags(df=False)
        elif sub == U.FL_STD:
            self.set_flags(df=True)
        elif sub == U.FL_CLI:
            self.rflags &= ~0x200
        elif sub == U.FL_STI:
            self.rflags |= 0x200
        elif sub == U.FL_SAHF:
            ah = self.read_reg(U.REG_AH_BASE, 1)
            self.rflags = (self.rflags & ~0xD5) | (ah & 0xD5) | 0x2
        else:  # LAHF
            self.write_reg(U.REG_AH_BASE, 1, (self.rflags & 0xD7) | 0x2)

    def _exec_movcr(self, uop) -> None:
        cr = uop.sub
        if uop.sext == 0:  # read
            val = {0: self.cr0, 2: self.cr2, 3: self.cr3, 4: self.cr4,
                   8: self.cr8}.get(cr)
            if val is None:
                raise UnsupportedInsn(self.rip, uop.raw)
            self.write_reg(uop.dst_reg, 8, val)
        else:
            val = self.read_reg(uop.src_reg, 8)
            if cr == 2:
                self.cr2 = val
            elif cr == 3:
                # recorded, not raised: rip still advances; the backend turns
                # a differing cr3 into Cr3Change after the step (reference
                # tlb_cntrl hook bochscpu_backend.cc:628-657)
                self.cr3 = val
                self.cr3_event = val
            elif cr == 0:
                self.cr0 = val
            elif cr == 4:
                self.cr4 = val
            elif cr == 8:
                self.cr8 = val
            else:
                raise UnsupportedInsn(self.rip, uop.raw)

    # -- SSE -------------------------------------------------------------
    def _read_xmm_bytes(self, idx: int, size: int) -> bytes:
        lo, hi = self.xmm[idx]
        return (lo | (hi << 64)).to_bytes(16, "little")[:size]

    def _write_xmm_bytes(self, idx: int, data: bytes, merge: bool) -> None:
        if merge:
            cur = bytearray(self._read_xmm_bytes(idx, 16))
            cur[: len(data)] = data
            data = bytes(cur)
        else:
            data = data.ljust(16, b"\x00")
        val = int.from_bytes(data, "little")
        self.xmm[idx] = [val & MASK64, val >> 64]

    def _exec_ssemov(self, uop, ea) -> None:
        size = uop.opsize
        if uop.sub == 1:  # gpr -> xmm (zero upper)
            val = self.read_reg(uop.src_reg, size)
            self._write_xmm_bytes(uop.dst_reg, val.to_bytes(size, "little"),
                                  merge=False)
            return
        if uop.sub == 2:  # xmm -> gpr/mem
            data = self._read_xmm_bytes(uop.src_reg, size)
            if uop.dst_kind == U.K_MEM:
                self.virt_write(ea, data)
            else:
                self.write_reg(uop.dst_reg, size,
                               int.from_bytes(data, "little"))
            return
        if uop.sub in (4, 5):  # movlps/movhps family: one qword half
            hi = uop.sub == 5
            if uop.dst_kind == U.K_MEM:  # store the chosen half
                data = self._read_xmm_bytes(uop.src_reg, 16)
                self.virt_write(ea, data[8:] if hi else data[:8])
                return
            if uop.src_kind == U.K_MEM:
                half = self.virt_read(ea, 8)
            else:  # movhlps takes src HIGH; movlhps takes src LOW
                sdata = self._read_xmm_bytes(uop.src_reg, 16)
                half = sdata[:8] if hi else sdata[8:]
            dst = self._read_xmm_bytes(uop.dst_reg, 16)
            out = (dst[:8] + half) if hi else (half + dst[8:])
            self._write_xmm_bytes(uop.dst_reg, out, merge=False)
            return
        # plain moves
        if uop.src_kind == U.K_XMM:
            data = self._read_xmm_bytes(uop.src_reg, size)
        elif uop.src_kind == U.K_MEM:
            data = self.virt_read(ea, size)
        else:
            raise UnsupportedInsn(self.rip, uop.raw)
        if uop.dst_kind == U.K_XMM:
            # movss/movsd xmm,xmm merge low lanes; movq (sub=3) and loads
            # from memory zero the upper lane
            merge = uop.src_kind == U.K_XMM and size < 16 and uop.sub != 3
            self._write_xmm_bytes(uop.dst_reg, data, merge=merge)
        elif uop.dst_kind == U.K_MEM:
            self.virt_write(ea, data)
        else:
            raise UnsupportedInsn(self.rip, uop.raw)

    def _exec_ssealu(self, uop, ea) -> None:
        sub = uop.sub
        if sub == U.SSE_PINSRW:
            # word-granular insert: source is a gpr low word or an m16
            # (only 2 bytes read — a 16-byte load could fault at page end)
            if uop.src_kind == U.K_REG:
                word = self.read_reg(uop.src_reg, 2)
            else:
                word = self.read_u(ea, 2)
            dst = bytearray(self._read_xmm_bytes(uop.dst_reg, 16))
            dst[uop.cond * 2:uop.cond * 2 + 2] = word.to_bytes(2, "little")
            self._write_xmm_bytes(uop.dst_reg, bytes(dst), merge=False)
            return
        if sub == U.SSE_PEXTRW:
            src = self._read_xmm_bytes(uop.src_reg, 16)
            word = int.from_bytes(src[uop.cond * 2:uop.cond * 2 + 2],
                                  "little")
            self.write_reg(uop.dst_reg, 4, word)  # zero-extended to 32/64
            return
        if uop.src_kind == U.K_XMM:
            src = self._read_xmm_bytes(uop.src_reg, 16)
        elif uop.src_kind == U.K_MEM:
            src = self.virt_read(ea, 16)
        elif uop.src_kind == U.K_IMM:
            src = b""
        else:
            src = b"\x00" * 16

        if sub == U.SSE_PMOVMSKB:
            data = self._read_xmm_bytes(uop.src_reg, 16)
            maskbits = 0
            for i, byte in enumerate(data):
                maskbits |= ((byte >> 7) & 1) << i
            self.write_reg(uop.dst_reg, 4, maskbits)
            return

        dst = self._read_xmm_bytes(uop.dst_reg, 16)
        if sub == U.SSE_PTEST:
            d = int.from_bytes(dst, "little")
            s = int.from_bytes(src, "little")
            self.set_flags(zf=(d & s) == 0, cf=(~d & s) & ((1 << 128) - 1) == 0,
                           of=False, af=False, sf=False, pf=False)
            return
        if sub in (U.SSE_PXOR, U.SSE_XORPS):
            out = bytes(a ^ b for a, b in zip(dst, src))
        elif sub == U.SSE_POR:
            out = bytes(a | b for a, b in zip(dst, src))
        elif sub == U.SSE_PAND:
            out = bytes(a & b for a, b in zip(dst, src))
        elif sub == U.SSE_PANDN:
            out = bytes(~a & b & 0xFF for a, b in zip(dst, src))
        elif sub == U.SSE_PCMPEQB:
            out = bytes(0xFF if a == b else 0 for a, b in zip(dst, src))
        elif sub == U.SSE_PCMPEQW:
            out = b"".join(
                (b"\xff\xff" if dst[i : i + 2] == src[i : i + 2] else b"\x00\x00")
                for i in range(0, 16, 2))
        elif sub == U.SSE_PCMPEQD:
            out = b"".join(
                (b"\xff" * 4 if dst[i : i + 4] == src[i : i + 4] else b"\x00" * 4)
                for i in range(0, 16, 4))
        elif sub == U.SSE_PSUBB:
            out = bytes((a - b) & 0xFF for a, b in zip(dst, src))
        elif sub == U.SSE_PADDB:
            out = bytes((a + b) & 0xFF for a, b in zip(dst, src))
        elif sub == U.SSE_PMINUB:
            out = bytes(min(a, b) for a, b in zip(dst, src))
        elif sub == U.SSE_PUNPCKLQDQ:
            out = dst[:8] + src[:8]
        elif sub == U.SSE_PUNPCKLDQ:
            out = dst[:4] + src[:4] + dst[4:8] + src[4:8]
        elif sub == U.SSE_PADDQ:
            out = b"".join(
                ((int.from_bytes(dst[i:i + 8], "little")
                  + int.from_bytes(src[i:i + 8], "little"))
                 & MASK64).to_bytes(8, "little")
                for i in (0, 8))
        elif sub == U.SSE_PSHUFD:
            sel = uop.imm
            out = b"".join(
                src[((sel >> (2 * i)) & 3) * 4 : ((sel >> (2 * i)) & 3) * 4 + 4]
                for i in range(4))
        elif sub == U.SSE_PSLLDQ:
            n = min(uop.imm, 16)
            out = (b"\x00" * n + dst)[:16]
        elif sub == U.SSE_PSRLDQ:
            n = min(uop.imm, 16)
            out = (dst[n:] + b"\x00" * 16)[:16]
        elif sub in (U.SSE_PSLLQ_I, U.SSE_PSRLQ_I):
            n = uop.imm
            if n > 63:
                out = bytes(16)
            else:
                lo = int.from_bytes(dst[:8], "little")
                hi = int.from_bytes(dst[8:], "little")
                if sub == U.SSE_PSLLQ_I:
                    lo, hi = (lo << n) & MASK64, (hi << n) & MASK64
                else:
                    lo, hi = lo >> n, hi >> n
                out = lo.to_bytes(8, "little") + hi.to_bytes(8, "little")
        else:
            raise UnsupportedInsn(self.rip, uop.raw)
        self._write_xmm_bytes(uop.dst_reg, out, merge=False)

    # -- x87 -------------------------------------------------------------
    def _st_phys(self, i: int) -> int:
        return (self.fptop + i) & 7

    def _st_bits(self, i: int) -> int:
        return self.fpst[self._st_phys(i)]

    def _st_f(self, i: int) -> float:
        import struct as _s

        return _s.unpack("<d", self._st_bits(i).to_bytes(8, "little"))[0]

    def _st_set_f(self, i: int, value: float) -> None:
        import struct as _s

        self.fpst[self._st_phys(i)] = int.from_bytes(
            _s.pack("<d", value), "little")

    def _fp_tag(self, phys: int, empty: bool) -> None:
        self.fptw = (self.fptw & ~(3 << (phys * 2))) | (
            (3 if empty else 0) << (phys * 2))

    def _fp_push_bits(self, bits: int) -> None:
        self.fptop = (self.fptop - 1) & 7
        self.fpst[self.fptop] = bits & MASK64
        self._fp_tag(self.fptop, empty=False)

    def _fp_pop(self, count: int = 1) -> None:
        for _ in range(count):
            self._fp_tag(self.fptop, empty=True)
            self.fptop = (self.fptop + 1) & 7

    def _exec_x87(self, uop, ea) -> None:  # noqa: C901 - one dispatcher
        """x87 subset (OPC_X87): double-precision value model — bit-exact
        vs hardware under the PC=53 control word Windows runs with (see
        cpu/uops.py).  No x87 exceptions/faults are modeled beyond the
        memory accesses themselves."""
        import math
        import struct as _s

        sub = uop.sub
        i = uop.imm & 7
        if sub == U.X87_FLD_M:
            raw = self.virt_read(ea, uop.srcsize)
            f = _s.unpack("<f" if uop.srcsize == 4 else "<d", raw)[0]
            self._fp_push_bits(int.from_bytes(_s.pack("<d", f), "little"))
        elif sub == U.X87_FST_M:
            f = self._st_f(0)
            if uop.srcsize == 4:
                import numpy as np

                self.virt_write(ea, np.asarray(f, dtype="<f4").tobytes())
            else:
                self.virt_write(ea, _s.pack("<d", f))
            if uop.sext:
                self._fp_pop()
        elif sub == U.X87_FILD:
            v = _sx(self.read_u(ea, uop.srcsize), uop.srcsize * 8)
            import numpy as np

            f = float(np.asarray(v, dtype=np.int64).astype(np.float64))
            self._fp_push_bits(int.from_bytes(_s.pack("<d", f), "little"))
        elif sub in (U.X87_FIST, U.X87_FIST_T):
            import numpy as np

            bits = uop.srcsize * 8
            f = self._st_f(0)
            indefinite = 1 << (bits - 1)
            if f != f or f in (math.inf, -math.inf):
                r = indefinite
            else:
                # fisttp always chops; fist(p) honors fpcw.RC (bits 10-11:
                # 0 nearest-even, 1 down, 2 up, 3 chop) — the classic
                # pre-SSE truncation idiom rewrites RC around the store
                rc = 3 if sub == U.X87_FIST_T else (self.fpcw >> 10) & 3
                if rc == 0:
                    r = int(np.rint(np.asarray(f)))
                elif rc == 1:
                    r = math.floor(f)
                elif rc == 2:
                    r = math.ceil(f)
                else:
                    r = int(f)
                if not -(1 << (bits - 1)) <= r < (1 << (bits - 1)):
                    r = indefinite
            self.write_u(ea, uop.srcsize, r & ((1 << bits) - 1))
            if uop.sext:
                self._fp_pop()
        elif sub == U.X87_FLD_STI:
            self._fp_push_bits(self._st_bits(i))
        elif sub == U.X87_FST_STI:
            self.fpst[self._st_phys(i)] = self._st_bits(0)
            self._fp_tag(self._st_phys(i), empty=False)
            if uop.sext:
                self._fp_pop()
        elif sub == U.X87_FLD_CONST:
            f = 1.0 if uop.imm == 0 else 0.0
            self._fp_push_bits(int.from_bytes(_s.pack("<d", f), "little"))
        elif sub in (U.X87_ARITH_M, U.X87_ARITH_ST):
            if sub == U.X87_ARITH_M:
                raw = self.virt_read(ea, uop.srcsize)
                b = _s.unpack("<f" if uop.srcsize == 4 else "<d", raw)[0]
                a = self._st_f(0)
                dst = 0
            elif uop.dst_reg:  # DC/DE: st(i) = st(i) OP st(0)
                a, b = self._st_f(i), self._st_f(0)
                dst = i
            else:              # D8: st(0) = st(0) OP st(i)
                a, b = self._st_f(0), self._st_f(i)
                dst = 0
            op = uop.cond
            if op in (U.X87_OP_COM, U.X87_OP_COMP):
                self._x87_compare(a, b, into_rflags=False)
            else:
                import numpy as np

                an, bn = np.float64(a), np.float64(b)
                with np.errstate(all="ignore"):  # IEEE inf/nan semantics
                    if op == U.X87_OP_ADD:
                        r = an + bn
                    elif op == U.X87_OP_MUL:
                        r = an * bn
                    elif op == U.X87_OP_SUB:
                        r = an - bn
                    elif op == U.X87_OP_SUBR:
                        r = bn - an
                    elif op == U.X87_OP_DIV:
                        r = an / bn
                    else:  # X87_OP_DIVR
                        r = bn / an
                self._st_set_f(dst, float(r))
            if uop.sext:
                self._fp_pop()
        elif sub == U.X87_FXCH:
            pa, pb = self._st_phys(0), self._st_phys(i)
            self.fpst[pa], self.fpst[pb] = self.fpst[pb], self.fpst[pa]
        elif sub == U.X87_FCHS:
            self.fpst[self._st_phys(0)] ^= 1 << 63
        elif sub == U.X87_FABS:
            self.fpst[self._st_phys(0)] &= ~(1 << 63)
        elif sub == U.X87_FNSTCW:
            self.write_u(ea, 2, self.fpcw)
        elif sub == U.X87_FLDCW:
            self.fpcw = self.read_u(ea, 2)
        elif sub == U.X87_FNSTSW_AX:
            self.write_reg(0, 2, self.fpsw_packed())
        elif sub == U.X87_FNSTSW_M:
            self.write_u(ea, 2, self.fpsw_packed())
        elif sub == U.X87_COMI:
            a, b = self._st_f(0), self._st_f(i)
            self._x87_compare(a, b, into_rflags=True)
            if uop.sext:
                self._fp_pop(uop.sext)
        elif sub == U.X87_COM:
            a, b = self._st_f(0), self._st_f(i)
            self._x87_compare(a, b, into_rflags=False)
            if uop.sext:
                self._fp_pop(uop.sext)
        elif sub == U.X87_FNINIT:
            self.fpcw, self.fpsw, self.fptw, self.fptop = 0x37F, 0, 0xFFFF, 0
        elif sub == U.X87_FNCLEX:
            self.fpsw &= ~0x80FF
        elif sub == U.X87_FFREE:
            self._fp_tag(self._st_phys(i), empty=True)
        elif sub == U.X87_EMMS:
            self.fptw = 0xFFFF
        elif sub == U.X87_LDMXCSR:
            self.mxcsr = self.read_u(ea, 4)
        elif sub == U.X87_STMXCSR:
            self.write_u(ea, 4, self.mxcsr & 0xFFFFFFFF)
        elif sub == U.X87_FXSAVE:
            self.virt_write(ea, self._fxsave_image())
        elif sub == U.X87_FXRSTOR:
            self._fxrstor_image(self.virt_read(ea, 512))
        elif sub == U.X87_XSAVE:
            # XSAVE64 with RFBM = edx:eax; x87 (bit 0) + SSE (bit 1) +
            # AVX (bit 2, the upper YMM halves at the standard offset
            # 576) are the components this machine model carries — the
            # kernel context-switch path.  The legacy region is the
            # fxsave image; XSTATE_BV in the header records what saved.
            rfbm = ((self.gpr[2] << 32) | (self.gpr[0] & 0xFFFFFFFF)) & 0x7
            img = bytearray(self._fxsave_image())
            header = bytearray(64)
            _s.pack_into("<Q", header, 0, rfbm)  # XSTATE_BV
            out = bytes(img) + bytes(header)
            if rfbm & 4:
                avx = bytearray(256)
                for r in range(16):
                    _s.pack_into("<QQ", avx, 16 * r,
                                 self.ymmh[r][0], self.ymmh[r][1])
                out += bytes(avx)
            self.virt_write(ea, out)
        elif sub == U.X87_XRSTOR:
            rfbm = ((self.gpr[2] << 32) | (self.gpr[0] & 0xFFFFFFFF)) & 0x7
            raw = self.virt_read(ea, 576)
            (xstate_bv,) = _s.unpack_from("<Q", raw, 512)
            use = rfbm & xstate_bv
            if rfbm & 1:
                if use & 1:
                    self._fxrstor_x87_only(raw)
                else:  # component in init state
                    self.fpcw, self.fpsw = 0x37F, 0
                    self.fptw, self.fptop = 0xFFFF, 0
                    self.fpst = [0] * 8
            if rfbm & 2:
                if use & 2:
                    (self.mxcsr,) = _s.unpack_from("<I", raw, 24)
                    for r in range(16):
                        self._write_xmm_bytes(
                            r, raw[160 + 16 * r:176 + 16 * r], merge=False)
                else:
                    self.mxcsr = 0x1F80
                    for r in range(16):
                        self._write_xmm_bytes(r, bytes(16), merge=False)
            if rfbm & 4:
                if use & 4:
                    avx = self.virt_read((ea + 576) & MASK64, 256)
                    for r in range(16):
                        lo, hi = _s.unpack_from("<QQ", avx, 16 * r)
                        self.ymmh[r] = [lo, hi]
                else:
                    for r in range(16):
                        self.ymmh[r] = [0, 0]
        else:
            raise UnsupportedInsn(self.rip, uop.raw)

    def _x87_compare(self, a: float, b: float, into_rflags: bool) -> None:
        unord = a != a or b != b
        zf, pf, cf = (True, True, True) if unord else (
            a == b, False, a < b)
        if into_rflags:  # fcomi/fucomi family
            self.set_flags(zf=zf, pf=pf, cf=cf, of=False, af=False, sf=False)
        else:  # fcom family: C3/C2/C0 in the status word
            self.fpsw = (self.fpsw & ~0x4500) | (
                (0x4000 if zf else 0) | (0x400 if pf else 0)
                | (0x100 if cf else 0))

    def _fxsave_image(self) -> bytes:
        """The 512-byte FXSAVE64 area (SDM vol 1 10.5.1): control words,
        abridged tag, ST0-7 as 80-bit extended, XMM0-15."""
        out = bytearray(512)
        import struct as _s

        _s.pack_into("<HH", out, 0, self.fpcw & 0xFFFF, self.fpsw_packed())
        # abridged tag: bit i = 1 when physical reg i is NOT empty
        abridged = 0
        for phys in range(8):
            if (self.fptw >> (phys * 2)) & 3 != 3:
                abridged |= 1 << phys
        out[4] = abridged
        _s.pack_into("<I", out, 24, self.mxcsr & 0xFFFFFFFF)
        _s.pack_into("<I", out, 28, 0xFFBF)  # mxcsr_mask
        for j in range(8):
            # slots hold st(j) (top-relative), 80-bit value + 6 pad bytes
            v80 = _f64_to_f80(self._st_bits(j))
            out[32 + 16 * j:32 + 16 * j + 10] = v80.to_bytes(10, "little")
        for r in range(16):
            out[160 + 16 * r:176 + 16 * r] = self._read_xmm_bytes(r, 16)
        return bytes(out)

    def _fxrstor_x87_only(self, raw: bytes) -> None:
        import struct as _s

        self.fpcw, fpsw = _s.unpack_from("<HH", raw, 0)
        self.fpsw = fpsw
        self.fptop = (fpsw >> 11) & 7
        abridged = raw[4]
        self.fptw = 0
        for phys in range(8):
            tag = 0 if (abridged >> phys) & 1 else 3
            self.fptw |= tag << (phys * 2)
        for j in range(8):
            v80 = int.from_bytes(raw[32 + 16 * j:32 + 16 * j + 10], "little")
            self.fpst[self._st_phys(j)] = _f80_to_f64_bits(v80)

    def _fxrstor_image(self, raw: bytes) -> None:
        import struct as _s

        self._fxrstor_x87_only(raw)
        (self.mxcsr,) = _s.unpack_from("<I", raw, 24)
        for r in range(16):
            self._write_xmm_bytes(r, raw[160 + 16 * r:176 + 16 * r],
                                  merge=False)

    def _exec_ssefp(self, uop, ea) -> None:
        """SSE/SSE2 floating point (OPC_SSEFP) — semantics in _SseFp."""
        sub = uop.sub
        elem = uop.srcsize
        packed = uop.sext == 1
        fp = _SseFp(elem)
        n = (16 // elem) if packed else 1

        def src_bytes(nbytes):
            if uop.src_kind == U.K_XMM:
                return self._read_xmm_bytes(uop.src_reg, nbytes)
            return self.virt_read(ea, nbytes)

        def split(b, count):
            return [b[i * elem:(i + 1) * elem] for i in range(count)]

        # integer-involved converts first (different operand shapes)
        if sub == U.FP_CVT_I2F:
            if uop.src_kind == U.K_REG:
                ival = self.read_reg(uop.src_reg, uop.opsize)
            else:
                ival = self.read_u(ea, uop.opsize)
            ival = _sx(ival, uop.opsize * 8)
            # int64 -> float32 must round ONCE (cvtsi2ss semantics):
            # numpy's int64.astype(float32) is the direct C cast
            out = fp.np.asarray(ival, dtype=fp.np.int64).astype(
                fp.fdt).tobytes()
            self._write_xmm_bytes(uop.dst_reg, out, merge=True)
            return
        if sub in (U.FP_CVT_F2I, U.FP_CVT_F2I_T):
            b = src_bytes(elem)
            r = fp.to_int(b, uop.opsize * 8, sub == U.FP_CVT_F2I_T)
            self.write_reg(uop.dst_reg, uop.opsize, r)
            return
        if sub in (U.FP_UCOMI, U.FP_COMI):
            a_b = self._read_xmm_bytes(uop.dst_reg, elem)
            b_b = src_bytes(elem)
            if fp.isnan(a_b) or fp.isnan(b_b):
                zf = pf = cf = True
            else:
                a, b = fp.f(a_b), fp.f(b_b)
                zf, pf, cf = a == b, False, a < b
            self.set_flags(zf=zf, pf=pf, cf=cf, of=False, af=False, sf=False)
            return

        dst16 = self._read_xmm_bytes(uop.dst_reg, 16)
        if sub == U.FP_CVT_F2F:
            np = fp.np
            dst_elem = 12 - elem  # 4 <-> 8
            dst_dt = np.dtype("<f4") if dst_elem == 4 else np.dtype("<f8")
            count = 2 if packed else 1
            src = split(src_bytes(elem * count), count)
            vals = [np.frombuffer(b, dtype=fp.fdt)[0] for b in src]
            with np.errstate(all="ignore"):
                out = b"".join(np.asarray(v, dtype=dst_dt).tobytes()
                               for v in vals)
            if packed:
                # cvtps2pd fills 16; cvtpd2ps writes low 8, zeroes high
                out = out.ljust(16, b"\x00")
                self._write_xmm_bytes(uop.dst_reg, out, merge=False)
            else:
                self._write_xmm_bytes(uop.dst_reg, out, merge=True)
            return
        if sub in (U.FP_CVT_DQ2PS, U.FP_CVT_PS2DQ, U.FP_CVT_PS2DQ_T,
                   U.FP_CVT_DQ2PD, U.FP_CVT_PD2DQ, U.FP_CVT_PD2DQ_T):
            np = fp.np
            src = src_bytes(16)
            if sub == U.FP_CVT_DQ2PS:
                ints = np.frombuffer(src, dtype="<i4")
                out = ints.astype("<f4").tobytes()
            elif sub == U.FP_CVT_DQ2PD:
                ints = np.frombuffer(src[:8], dtype="<i4")
                out = ints.astype("<f8").tobytes()
            else:
                fp_in = _SseFp(4 if sub in (U.FP_CVT_PS2DQ,
                                            U.FP_CVT_PS2DQ_T) else 8)
                count = 16 // fp_in.elem
                trunc = sub in (U.FP_CVT_PS2DQ_T, U.FP_CVT_PD2DQ_T)
                pieces = [fp_in.to_int(b, 32, trunc).to_bytes(4, "little")
                          for b in (src[i * fp_in.elem:(i + 1) * fp_in.elem]
                                    for i in range(count))]
                out = b"".join(pieces).ljust(16, b"\x00")
            self._write_xmm_bytes(uop.dst_reg, out, merge=False)
            return

        # element-wise forms over the common (dst, src) vector shape
        src_v = split(src_bytes(16 if packed else elem), n)
        dst_v = split(dst16, n)
        if sub in (U.FP_ADD, U.FP_SUB, U.FP_MUL, U.FP_DIV):
            out_v = [fp.arith(sub, d, s) for d, s in zip(dst_v, src_v)]
        elif sub in (U.FP_MIN, U.FP_MAX):
            out_v = [fp.minmax(sub, d, s) for d, s in zip(dst_v, src_v)]
        elif sub == U.FP_SQRT:
            out_v = [fp.sqrt(s) for s in src_v]
        elif sub == U.FP_CMP:
            mask = (b"\xFF" * elem, b"\x00" * elem)
            out_v = [mask[0] if fp.cmp(uop.imm & 7, d, s) else mask[1]
                     for d, s in zip(dst_v, src_v)]
        elif sub == U.FP_SHUF:
            src16 = src_bytes(16)
            sel = uop.imm
            if elem == 4:
                picks = [dst16, dst16, src16, src16]
                out_v = [picks[i][((sel >> (2 * i)) & 3) * 4:
                                  ((sel >> (2 * i)) & 3) * 4 + 4]
                         for i in range(4)]
            else:
                out_v = [dst16[(sel & 1) * 8:(sel & 1) * 8 + 8],
                         src16[((sel >> 1) & 1) * 8:((sel >> 1) & 1) * 8 + 8]]
        elif sub in (U.FP_UNPCKL, U.FP_UNPCKH):
            src16 = src_bytes(16)
            d_v, s_v = split(dst16, 16 // elem), split(src16, 16 // elem)
            half = len(d_v) // 2
            base = 0 if sub == U.FP_UNPCKL else half
            out_v = []
            for i in range(half):
                out_v += [d_v[base + i], s_v[base + i]]
        else:
            raise UnsupportedInsn(self.rip, uop.raw)
        out = b"".join(out_v)
        self._write_xmm_bytes(uop.dst_reg, out, merge=not packed)
        return


class _SseFp:
    """SSE/SSE2 floating-point semantics for the oracle (OPC_SSEFP).

    Exact IEEE-754 via numpy (single-precision ops computed in float32 —
    no double rounding) with the x86 rules handled at the bit level: NaN
    payloads preserved, SNaNs quieted, the dst-operand NaN wins for
    arithmetic, min/max/cmp forward the SECOND operand on NaN/equality,
    out-of-range converts produce the integer indefinite.  Oracle-only by
    design: the census over real Windows PEs (tools/decode_census.py)
    shows FP dominates the decode gap, but snapshot-fuzzing guests run
    integer-heavy paths, so trapping FP to the host costs little.
    """

    def __init__(self, elem: int):
        import numpy as np

        self.np = np
        self.elem = elem
        self.fdt = np.dtype("<f4") if elem == 4 else np.dtype("<f8")

    def f(self, b: bytes):
        return self.np.frombuffer(b[:self.elem], dtype=self.fdt)[0]

    def bits(self, x) -> bytes:
        return self.np.asarray(x, dtype=self.fdt).tobytes()

    def isnan(self, b: bytes) -> bool:
        return bool(self.np.isnan(self.f(b)))

    def quiet(self, b: bytes) -> bytes:
        out = bytearray(b[:self.elem])
        if self.elem == 4:
            out[2] |= 0x40  # f32 QNaN bit 22
        else:
            out[6] |= 0x08  # f64 QNaN bit 51
        return bytes(out)

    @property
    def indefinite(self) -> bytes:
        return (b"\x00\x00\xC0\xFF" if self.elem == 4
                else b"\x00\x00\x00\x00\x00\x00\xF8\xFF")

    def arith(self, sub: int, a_b: bytes, b_b: bytes) -> bytes:
        import wtf_tpu_torch.cpu.uops as U

        np = self.np
        if self.isnan(a_b):
            return self.quiet(a_b)
        if self.isnan(b_b):
            return self.quiet(b_b)
        a, b = self.f(a_b), self.f(b_b)
        with np.errstate(all="ignore"):
            if sub == U.FP_ADD:
                r = a + b
            elif sub == U.FP_SUB:
                r = a - b
            elif sub == U.FP_MUL:
                r = a * b
            else:  # FP_DIV
                r = a / b
        if np.isnan(r):  # invalid operation (inf-inf, 0*inf, 0/0, inf/inf)
            return self.indefinite
        return self.bits(r)

    def minmax(self, sub: int, a_b: bytes, b_b: bytes) -> bytes:
        import wtf_tpu_torch.cpu.uops as U

        # SDM MINSS: NaN (either), or equal values (incl. ±0): the SECOND
        # operand is returned unchanged
        if self.isnan(a_b) or self.isnan(b_b):
            return b_b[:self.elem]
        a, b = self.f(a_b), self.f(b_b)
        if a == b:
            return b_b[:self.elem]
        take_a = a < b if sub == U.FP_MIN else a > b
        return a_b[:self.elem] if take_a else b_b[:self.elem]

    def sqrt(self, b_b: bytes) -> bytes:
        np = self.np
        if self.isnan(b_b):
            return self.quiet(b_b)
        v = self.f(b_b)
        if v < 0:
            return self.indefinite  # sqrt(-x) -> real indefinite
        with np.errstate(all="ignore"):
            return self.bits(np.sqrt(v))

    def cmp(self, pred: int, a_b: bytes, b_b: bytes) -> bool:
        unord = self.isnan(a_b) or self.isnan(b_b)
        a, b = self.f(a_b), self.f(b_b)
        if pred == 0:
            return not unord and a == b
        if pred == 1:
            return not unord and a < b
        if pred == 2:
            return not unord and a <= b
        if pred == 3:
            return unord
        if pred == 4:
            return unord or a != b
        if pred == 5:
            return unord or not a < b
        if pred == 6:
            return unord or not a <= b
        return not unord  # 7: ord

    def to_int(self, b_b: bytes, int_bits: int, truncate: bool) -> int:
        """cvt(t)ss/sd2si: rounded (half-even) or truncated, with the
        integer-indefinite on NaN/overflow."""
        np = self.np
        indefinite = 1 << (int_bits - 1)
        if self.isnan(b_b):
            return indefinite
        v = float(self.f(b_b))
        if v != v or v in (float("inf"), float("-inf")):
            return indefinite
        r = int(v) if truncate else int(np.rint(np.asarray(v)))
        if not -(1 << (int_bits - 1)) <= r < (1 << (int_bits - 1)):
            return indefinite
        return r & ((1 << int_bits) - 1)


class GuestCrash(Exception):
    """int3/int n/ud2/hlt executed — surfaced as a Crash result (matching the
    reference's interrupt/hlt handling, bochscpu_backend.cc:595-619,690-697)."""

    def __init__(self, rip: int, uop: U.Uop):
        super().__init__(f"guest fault at {rip:#x} (opc={uop.opc} sub={uop.sub})")
        self.rip = rip
        self.uop = uop


