"""Full x86-64 CPU state: the register half of a snapshot.

Equivalent of the reference's `CpuState_t` (reference src/wtf/globals.h:1020-1159)
plus its JSON loader `LoadCpuStateFromJSON` (src/wtf/utils.cc:57-193) and
`SanitizeCpuState` (src/wtf/utils.cc:195-258).  The on-disk format is the
`regs.json` emitted by the external bdump.js windbg script, so snapshots taken
for the reference load here unchanged.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Union

MASK64 = (1 << 64) - 1

# Canonical GPR order used across the whole framework (index into the
# interpreter's gpr array).  Matches x86-64 encoding order (reg field).
GPR_NAMES = (
    "rax", "rcx", "rdx", "rbx", "rsp", "rbp", "rsi", "rdi",
    "r8", "r9", "r10", "r11", "r12", "r13", "r14", "r15",
)

# RFLAGS bit positions (reference src/wtf/globals.h Rflags_t bitfield union).
RFLAGS_CF = 1 << 0
RFLAGS_RESERVED1 = 1 << 1  # always set
RFLAGS_PF = 1 << 2
RFLAGS_AF = 1 << 4
RFLAGS_ZF = 1 << 6
RFLAGS_SF = 1 << 7
RFLAGS_TF = 1 << 8
RFLAGS_IF = 1 << 9
RFLAGS_DF = 1 << 10
RFLAGS_OF = 1 << 11

# CR0 / CR4 / EFER bits we care about (globals.h Cr0_t/Cr4_t/Efer_t).
CR0_PE = 1 << 0
CR0_PG = 1 << 31
CR4_PAE = 1 << 5
CR4_LA57 = 1 << 12
EFER_LME = 1 << 8
EFER_LMA = 1 << 10
EFER_NXE = 1 << 11


@dataclasses.dataclass
class Seg:
    """Segment register (reference globals.h:33-64 `Seg_t`)."""

    present: bool = False
    selector: int = 0
    base: int = 0
    limit: int = 0
    attr: int = 0

    @property
    def reserved_bits(self) -> int:
        # Seg_t stores limit[16:20] in a Reserved attr subfield; bdump packs
        # them into attr bits 8..11 on the wtf side.  We only need them for the
        # sanitize-time validity check.
        return (self.attr >> 8) & 0xF


@dataclasses.dataclass
class GlobalSeg:
    """GDTR/IDTR (reference globals.h:66-76 `GlobalSeg_t`)."""

    base: int = 0
    limit: int = 0


def _zmm_default() -> list:
    # 32 ZMM registers x 64 bytes, stored as 8 u64 limbs each.
    return [[0] * 8 for _ in range(32)]


@dataclasses.dataclass
class CpuState:
    """Complete architectural state captured in `regs.json`.

    Field set mirrors reference `CpuState_t` (globals.h:1020-1159): 16 GPRs,
    rip/rflags, 8 segment registers, gdtr/idtr, control registers, debug
    registers, 13 MSRs, x87/SSE state, 32 ZMM registers.
    """

    # GPRs
    rax: int = 0
    rbx: int = 0
    rcx: int = 0
    rdx: int = 0
    rsi: int = 0
    rdi: int = 0
    rip: int = 0
    rsp: int = 0
    rbp: int = 0
    r8: int = 0
    r9: int = 0
    r10: int = 0
    r11: int = 0
    r12: int = 0
    r13: int = 0
    r14: int = 0
    r15: int = 0
    rflags: int = 0x2

    # Segments
    es: Seg = dataclasses.field(default_factory=Seg)
    cs: Seg = dataclasses.field(default_factory=Seg)
    ss: Seg = dataclasses.field(default_factory=Seg)
    ds: Seg = dataclasses.field(default_factory=Seg)
    fs: Seg = dataclasses.field(default_factory=Seg)
    gs: Seg = dataclasses.field(default_factory=Seg)
    tr: Seg = dataclasses.field(default_factory=Seg)
    ldtr: Seg = dataclasses.field(default_factory=Seg)
    gdtr: GlobalSeg = dataclasses.field(default_factory=GlobalSeg)
    idtr: GlobalSeg = dataclasses.field(default_factory=GlobalSeg)

    # Control / debug registers
    cr0: int = 0
    cr2: int = 0
    cr3: int = 0
    cr4: int = 0
    cr8: int = 0
    xcr0: int = 0
    dr0: int = 0
    dr1: int = 0
    dr2: int = 0
    dr3: int = 0
    dr6: int = 0
    dr7: int = 0

    # MSRs
    tsc: int = 0
    apic_base: int = 0
    sysenter_cs: int = 0
    sysenter_esp: int = 0
    sysenter_eip: int = 0
    pat: int = 0
    efer: int = 0
    star: int = 0
    lstar: int = 0
    cstar: int = 0
    sfmask: int = 0
    kernel_gs_base: int = 0
    tsc_aux: int = 0

    # x87 / SSE
    fpcw: int = 0x27F
    fpsw: int = 0
    fptw: int = 0xFFFF
    fpop: int = 0
    fpst: list = dataclasses.field(default_factory=lambda: [0] * 8)
    mxcsr: int = 0x1F80
    mxcsr_mask: int = 0xFFBF

    # Vector state: 32 regs x 8 u64 limbs (low 2 limbs = XMM, 4 = YMM).
    zmm: list = dataclasses.field(default_factory=_zmm_default)

    def gpr_list(self) -> list:
        """GPRs in x86 encoding order (GPR_NAMES)."""
        return [getattr(self, name) & MASK64 for name in GPR_NAMES]

    def set_gpr_list(self, values) -> None:
        for name, value in zip(GPR_NAMES, values):
            setattr(self, name, int(value) & MASK64)

    def long_mode(self) -> bool:
        return bool(self.efer & EFER_LMA)

    def paging_enabled(self) -> bool:
        return bool(self.cr0 & CR0_PG)

    def copy(self) -> "CpuState":
        new = dataclasses.replace(self)
        new.fpst = list(self.fpst)
        new.zmm = [list(limbs) for limbs in self.zmm]
        for seg in ("es", "cs", "ss", "ds", "fs", "gs", "tr", "ldtr"):
            setattr(new, seg, dataclasses.replace(getattr(self, seg)))
        new.gdtr = dataclasses.replace(self.gdtr)
        new.idtr = dataclasses.replace(self.idtr)
        return new


def _parse_u64(value: Union[str, int]) -> int:
    if isinstance(value, int):
        return value & MASK64
    return int(value, 0) & MASK64


_REG_KEYS = [
    "rax", "rbx", "rcx", "rdx", "rsi", "rdi", "rip", "rsp", "rbp",
    "r8", "r9", "r10", "r11", "r12", "r13", "r14", "r15", "rflags",
    "tsc", "apic_base", "sysenter_cs", "sysenter_esp", "sysenter_eip",
    "pat", "efer", "star", "lstar", "cstar", "sfmask", "kernel_gs_base",
    "tsc_aux", "fpcw", "fpsw", "fptw", "cr0", "cr2", "cr3", "cr4", "cr8",
    "xcr0", "dr0", "dr1", "dr2", "dr3", "dr6", "dr7", "mxcsr",
    "mxcsr_mask", "fpop",
]

_SEG_KEYS = ["es", "cs", "ss", "ds", "fs", "gs", "tr", "ldtr"]


def load_cpu_state_json(path) -> CpuState:
    """Load a bdump.js `regs.json` into a CpuState.

    Format compatibility with reference `LoadCpuStateFromJSON`
    (src/wtf/utils.cc:57-193): every scalar register is a hex string; segments
    are objects with present/selector/base/limit/attr; gdtr/idtr have
    base/limit; fpst is 8 entries that may be "Infinity"-style strings for an
    uninitialized x87 stack (in which case fptw is forced to 0xffff, matching
    the reference's windbg-fptw workaround at utils.cc:156-191).
    """
    data = json.loads(Path(path).read_text())
    state = CpuState()

    for key in _REG_KEYS:
        if key in data:
            setattr(state, key, _parse_u64(data[key]))

    for key in _SEG_KEYS:
        if key not in data:
            continue
        seg_json = data[key]
        seg = Seg(
            present=bool(seg_json.get("present", False)),
            selector=_parse_u64(seg_json.get("selector", 0)),
            base=_parse_u64(seg_json.get("base", 0)),
            limit=_parse_u64(seg_json.get("limit", 0)),
            attr=_parse_u64(seg_json.get("attr", 0)),
        )
        setattr(state, key, seg)

    for key, attr in (("gdtr", "gdtr"), ("idtr", "idtr")):
        if key in data:
            setattr(
                state,
                attr,
                GlobalSeg(
                    base=_parse_u64(data[key].get("base", 0)),
                    limit=_parse_u64(data[key].get("limit", 0)),
                ),
            )

    # x87 stack slots: bdump emits "0xInfinity"-ish strings when the FPU
    # state was never materialized; treat those as zero and force an empty
    # tag word if everything was empty (utils.cc:156-191).  NOT masked to
    # 64 bits: live entries are 80-bit extended values — consumers reduce
    # them to the double model (cpu/emu.py _f80_to_f64_bits).
    all_slots_zero = True
    if "fpst" in data:
        for idx, value in enumerate(data["fpst"][:8]):
            if isinstance(value, str) and "Infinity" in value:
                state.fpst[idx] = 0
            else:
                state.fpst[idx] = (int(value, 0) if isinstance(value, str)
                                   else int(value))
                all_slots_zero = False
    if state.fptw == 0 and all_slots_zero:
        state.fptw = 0xFFFF

    if "zmm" in data:
        for idx, reg in enumerate(data["zmm"][:32]):
            if isinstance(reg, dict):
                # bdump format: {"q": ["0x..", ...]} or flat hex string
                limbs = reg.get("q", [])
            else:
                limbs = reg
            if isinstance(limbs, str):
                raw = int(limbs, 0)
                parsed = [(raw >> (64 * i)) & MASK64 for i in range(8)]
            else:
                parsed = [_parse_u64(v) for v in limbs][:8]
            parsed += [0] * (8 - len(parsed))
            state.zmm[idx] = parsed

    return state


def sanitize_cpu_state(state: CpuState) -> bool:
    """Apply the reference's snapshot-state fixups (utils.cc:195-258).

    - cr8 forced to 0 when rip is user-mode,
    - hardware breakpoints (dr0-dr3, dr6, dr7) cleared,
    - segment attr sanity check (limit[16:20] must match the attr copy),
    - mxcsr_mask defaulted to 0xffbf when the dump recorded 0.

    Returns False when the state is unusable (bad segment attributes).
    """
    if state.rip < 0x7FFF_FFFF_0000 and state.cr8 != 0:
        state.cr8 = 0

    for name in ("dr0", "dr1", "dr2", "dr3", "dr6", "dr7"):
        if getattr(state, name) != 0:
            setattr(state, name, 0)

    for name in ("es", "fs", "cs", "gs", "ss", "ds"):
        seg: Seg = getattr(state, name)
        if seg.reserved_bits != ((seg.limit >> 16) & 0xF):
            return False

    if state.mxcsr_mask == 0:
        state.mxcsr_mask = 0xFFBF

    return True
