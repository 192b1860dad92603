"""x86-64 exception delivery through the guest IDT.

In the reference every hardware fault a guest takes is serviced BY THE
GUEST: bochs emulates the IDT/TSS walk internally, and the hypervisor
backends inject the event so the guest kernel runs its handler
(bochscpu_backend.cc:917-999 `PageFaultsMemoryIfNeeded` +
`bochscpu_cpu_set_exception`, kvm_backend.cc:2019-2042,
whv_backend.cc:1218-1247).  That is what makes guard-page stack growth,
SEH dispatch reaching `ntdll!RtlDispatchException`, and harness-forced
page-ins work on real Windows snapshots.

This module is the single delivery implementation both execution engines
share:

  - the oracle (`cpu/emu.py`) delivers synchronously when an instruction
    faults (`EmuBackend.run` catches the fault and injects),
  - the batched device path surfaces faults in the lane status
    (PAGE_FAULT/DIVIDE_ERROR + fault_gva/fault_write) and the host runner
    injects between chunks (`interp/runner.py::Runner._service_exception`),
  - `Backend.page_faults_memory_if_needed` injects a synthetic #PF the way
    the reference does to make the guest page memory in before host writes.

Scope: long-mode (64-bit) interrupt/trap gates, IST and CPL-change stack
switches through the TSS, error-code pushes, CR2 update.  Task gates and
16/32-bit gates raise `DeliveryFailed` and the fault stays terminal —
exactly the pre-delivery behavior (a crash named from the raw fault).

The `ctx` duck type (implemented by `EmuCpu` and the runner's `_LaneCtx`):
  read/write:  read_virt(gva, n) -> bytes, write_u64(gva, v), read_u64(gva)
  registers:   rip, rsp, rflags, cs_sel, ss_sel  (get/set attributes)
  tables:      idt_base, idt_limit, tss_base      (get attributes)
  faults:      set_cr2(v)
Memory accessors raise the engine's fault type on unmapped addresses; the
caller treats any such escape as an undeliverable (double-fault-like)
condition and keeps the lane terminal.
"""

from __future__ import annotations

import struct

MASK64 = (1 << 64) - 1

# vectors
VEC_DE = 0    # #DE divide error
VEC_BP = 3    # #BP int3
VEC_UD = 6    # #UD invalid opcode
VEC_DF = 8    # #DF double fault
VEC_GP = 13   # #GP general protection
VEC_PF = 14   # #PF page fault

# #PF error-code bits (Intel SDM Vol 3A 4.7)
PF_ERR_P = 1 << 0       # 0 = non-present, 1 = protection violation
PF_ERR_W = 1 << 1       # access was a write
PF_ERR_U = 1 << 2       # access from CPL 3

# vectors that push an error code (SDM Vol 3A 6.15)
_HAS_ERROR_CODE = frozenset({8, 10, 11, 12, 13, 14, 17, 21, 29, 30})

_RF_TF = 1 << 8
_RF_IF = 1 << 9
_RF_NT = 1 << 14
_RF_RF = 1 << 16


class DeliveryFailed(Exception):
    """The guest IDT cannot service this vector (absent/bad gate, no IDT,
    unsupported gate type).  Caller keeps the fault terminal."""


def pf_error_code(present: bool, write: bool, user: bool) -> int:
    return ((PF_ERR_P if present else 0)
            | (PF_ERR_W if write else 0)
            | (PF_ERR_U if user else 0))


def has_error_code(vector: int) -> bool:
    return vector in _HAS_ERROR_CODE


def deliver_page_fault(ctx, gva: int, write: bool, read_translates) -> None:
    """Route a memory fault to the architecturally correct vector and
    deliver it.

    Canonical addresses take #PF (error code P/W/U, CR2 = gva); a
    NON-canonical address is #GP(0) on real hardware — no CR2 update —
    and Windows' KiGeneralProtectionFault turns that into an A/V with no
    faulting address, which is exactly what harness hooks then observe.

    One implementation for both engines (the oracle backend and the batch
    runner) so what the guest handler sees can never diverge between
    them.  `read_translates(gva) -> bool` is the engine's presence probe
    (translate ignoring the access direction): P reflects whether the
    page is mapped — a faulting access to a PRESENT page is a protection
    violation (P=1), e.g. a write through a read-only PTE; anything
    unmapped is non-present (P=0), the demand-paging shape a real
    Windows MmAccessFault distinguishes.  U comes from the ctx's CPL.
    """
    if (gva >> 47) not in (0, 0x1FFFF):  # non-canonical: #GP, not #PF
        deliver_exception(ctx, VEC_GP, 0)
        return
    present = read_translates(gva)
    err = pf_error_code(present, write, (ctx.cs_sel & 3) == 3)
    deliver_exception(ctx, VEC_PF, err, cr2=gva)


def deliver_exception(ctx, vector: int, error_code: int = 0,
                      cr2=None) -> None:
    """Push the interrupt frame and vector `ctx` through its IDT.

    Mirrors the hardware event-delivery sequence (SDM Vol 3A 6.14
    "Exception and Interrupt Handling in 64-bit Mode"): 16-byte gate
    fetch, IST / CPL-change stack selection via the TSS, 16-byte stack
    alignment, SS:RSP/RFLAGS/CS:RIP[/error] pushes, IF masking for
    interrupt gates.  Raises DeliveryFailed when the gate cannot service
    the vector; lets the ctx's own fault type escape when the IDT/TSS/
    stack memory itself is unmapped (the double-fault analog).
    """
    if not 0 <= vector <= 255:
        raise DeliveryFailed(f"vector {vector} out of range")
    if ctx.idt_limit < vector * 16 + 15:
        raise DeliveryFailed(
            f"IDT limit {ctx.idt_limit:#x} does not cover vector {vector}")

    gate = ctx.read_virt((ctx.idt_base + vector * 16) & MASK64, 16)
    off_lo, sel, ist_byte, type_byte, off_mid, off_hi = struct.unpack(
        "<HHBBHI", gate[:12])
    if not type_byte & 0x80:
        raise DeliveryFailed(f"gate {vector} not present")
    gate_type = type_byte & 0xF
    if gate_type not in (0xE, 0xF):  # 64-bit interrupt / trap gate
        raise DeliveryFailed(f"gate {vector} type {gate_type:#x} unsupported")
    handler = off_lo | (off_mid << 16) | (off_hi << 32)

    old_cpl = ctx.cs_sel & 3
    new_cpl = sel & 3
    ist = ist_byte & 7
    if ist:
        rsp = ctx.read_u64((ctx.tss_base + 0x24 + (ist - 1) * 8) & MASK64)
    elif old_cpl != new_cpl:
        rsp = ctx.read_u64((ctx.tss_base + 4) & MASK64)  # TSS.RSP0
    else:
        rsp = ctx.rsp
    rsp &= ~0xF  # hardware aligns the frame base to 16 bytes

    frame = [ctx.ss_sel, ctx.rsp, (ctx.rflags | 0x2) & MASK64,
             ctx.cs_sel, ctx.rip]
    if vector in _HAS_ERROR_CODE:
        frame.append(error_code & MASK64)
    for value in frame:
        rsp = (rsp - 8) & MASK64
        ctx.write_u64(rsp, value)

    ctx.rsp = rsp
    ctx.rip = handler & MASK64
    ctx.cs_sel = sel
    if old_cpl != new_cpl:
        # long mode loads SS with the NULL selector (RPL = new CPL) on an
        # inter-privilege delivery; iretq restores the pushed one
        ctx.ss_sel = new_cpl
    rflags = ctx.rflags & ~(_RF_TF | _RF_NT | _RF_RF)
    if gate_type == 0xE:  # interrupt gate masks IF; trap gate leaves it
        rflags &= ~_RF_IF
    ctx.rflags = rflags | 0x2
    if cr2 is not None:
        ctx.set_cr2(cr2 & MASK64)
