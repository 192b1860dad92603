"""Batched machine state: every lane is one guest, stored as tensors.

The counterpart of wtf_tpu/interp/machine.py.  All architectural state
the interpreter reads or writes lives in `[lanes, ...]` tensors on one
device, so a batched step advances every guest at once and `Restore()` is
a copy of the snapshot's small register tensors plus an O(1) overlay
reset.

Representation: 64-bit guest values are `int64` tensors holding the u64
bits in two's complement (interp/ints.py); the JAX package's u32 limb
pairs exist only because a TPU kernel cannot hold 64-bit integers.  The
u32 device counters and coverage/edge bitmap words are `int32` holding
the u32 bits; the overlay's `valid` plane stays uint8.  `convert.py`
bitcasts between this layout and the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from wtf_tpu_torch.core.cpustate import CpuState
from wtf_tpu_torch.core.results import StatusCode
from wtf_tpu_torch.mem.overlay import DirtyOverlay, overlay_init, overlay_reset

# Device-side telemetry counter block (one u32 per lane per counter),
# accumulated by the step and the fused kernel, folded into the host
# registry once per batch.  Same indices as the JAX package.
CTR_INSTR = 0        # instructions retired (oracle fallbacks included)
CTR_MEM_FAULT = 1    # translation faults observed
CTR_DECODE_MISS = 2  # decode-cache misses (NEED_DECODE transitions)
CTR_FUSED = 3        # instructions retired inside the fused step kernel
CTR_PARK_SUBSET = 4  # fused-kernel parks for a subset reason (opclass,
                     # armed breakpoint, SMC-risk code)
CTR_PARK_MEM = 5     # fused-kernel parks for a memory reason (failing or
                     # unwritable walk, out-of-range frame, overlay full)
N_CTRS = 6


@dataclasses.dataclass
class Machine:
    """All fields carry a leading lane axis; int64 unless noted."""

    gpr: torch.Tensor          # [L, 16] (x86 encoding order)
    rip: torch.Tensor          # [L]
    rflags: torch.Tensor       # [L]
    xmm: torch.Tensor          # [L, 16, 4] YMM as four 64-bit limbs
    fs_base: torch.Tensor
    gs_base: torch.Tensor
    kernel_gs_base: torch.Tensor
    cr0: torch.Tensor
    cr2: torch.Tensor
    cr3: torch.Tensor
    cr4: torch.Tensor
    cr8: torch.Tensor
    cs: torch.Tensor
    ss: torch.Tensor
    lstar: torch.Tensor
    star: torch.Tensor
    sfmask: torch.Tensor
    efer: torch.Tensor
    tsc: torch.Tensor
    fpst: torch.Tensor         # [L, 8] f64 bits per physical slot
    fpcw: torch.Tensor
    fpsw: torch.Tensor
    fptw: torch.Tensor
    mxcsr: torch.Tensor
    status: torch.Tensor       # int32[L] (StatusCode)
    icount: torch.Tensor       # instructions executed this testcase
    rdrand: torch.Tensor
    cr3_base: torch.Tensor
    bp_skip: torch.Tensor      # int32[L]
    fault_gva: torch.Tensor
    fault_write: torch.Tensor  # int32[L]
    ctr: torch.Tensor          # int32[L, N_CTRS] (u32 bits)
    cov: torch.Tensor          # int32[L, capacity/32] bit per uop entry
    edge: torch.Tensor         # int32[L, EW] edge-hash bitmap
    overlay: DirtyOverlay

    @property
    def n_lanes(self) -> int:
        return self.rip.shape[0]

    @property
    def device(self) -> torch.device:
        return self.rip.device

    def planes(self):
        """(name, tensor) of every field, the overlay's as
        "overlay.<field>"."""
        for f in dataclasses.fields(self):
            if f.name == "overlay":
                for g in dataclasses.fields(self.overlay):
                    yield f"overlay.{g.name}", getattr(self.overlay, g.name)
            else:
                yield f.name, getattr(self, f.name)

    def clone(self) -> "Machine":
        """A deep copy (tests and kernel comparisons)."""
        kw = {f.name: getattr(self, f.name).clone()
              for f in dataclasses.fields(self) if f.name != "overlay"}
        ov = self.overlay
        return Machine(**kw, overlay=DirtyOverlay(
            ov.pfn.clone(), ov.data.clone(), ov.valid.clone(),
            ov.count.clone(), ov.overflow.clone()))


_I64 = torch.int64


def _f64_bits(v: int) -> int:
    """Snapshot fpst entry -> f64 bits (80-bit values reduce through the
    oracle's converter)."""
    if v >> 64:
        from wtf_tpu_torch.cpu.emu import _f80_to_f64_bits

        return _f80_to_f64_bits(v)
    return v & (1 << 64) - 1


def machine_init(cpu: CpuState, n_lanes: int, uop_capacity: int,
                 overlay_slots: int = 128, edge_bits: int = 17,
                 device="cpu") -> Machine:
    """Build the batch with every lane at the snapshot state."""

    def bcast(value: int) -> torch.Tensor:
        v = np.full(n_lanes, value & (1 << 64) - 1, dtype=np.uint64)
        return torch.from_numpy(v.view(np.int64)).to(device)

    def rows(values, shape) -> torch.Tensor:
        v = np.array([x & (1 << 64) - 1 for x in values], dtype=np.uint64)
        v = np.broadcast_to(v.reshape(shape), (n_lanes,) + shape)
        return torch.from_numpy(v.view(np.int64).copy()).to(device)

    xmm = [cpu.zmm[i][limb] for i in range(16) for limb in range(4)]
    return Machine(
        gpr=rows(cpu.gpr_list(), (16,)),
        rip=bcast(cpu.rip),
        rflags=bcast(cpu.rflags | 0x2),
        xmm=rows(xmm, (16, 4)),
        fs_base=bcast(cpu.fs.base),
        gs_base=bcast(cpu.gs.base),
        kernel_gs_base=bcast(cpu.kernel_gs_base),
        cr0=bcast(cpu.cr0), cr2=bcast(cpu.cr2), cr3=bcast(cpu.cr3),
        cr4=bcast(cpu.cr4), cr8=bcast(cpu.cr8),
        cs=bcast(cpu.cs.selector), ss=bcast(cpu.ss.selector),
        lstar=bcast(cpu.lstar), star=bcast(cpu.star),
        sfmask=bcast(cpu.sfmask), efer=bcast(cpu.efer), tsc=bcast(cpu.tsc),
        fpst=rows([_f64_bits(v) for v in cpu.fpst[:8]], (8,)),
        fpcw=bcast(cpu.fpcw), fpsw=bcast(cpu.fpsw), fptw=bcast(cpu.fptw),
        mxcsr=bcast(cpu.mxcsr),
        status=torch.full((n_lanes,), int(StatusCode.RUNNING),
                          dtype=torch.int32, device=device),
        icount=torch.zeros(n_lanes, dtype=_I64, device=device),
        rdrand=torch.zeros(n_lanes, dtype=_I64, device=device),
        cr3_base=bcast(cpu.cr3),
        bp_skip=torch.zeros(n_lanes, dtype=torch.int32, device=device),
        fault_gva=torch.zeros(n_lanes, dtype=_I64, device=device),
        fault_write=torch.zeros(n_lanes, dtype=torch.int32, device=device),
        ctr=torch.zeros((n_lanes, N_CTRS), dtype=torch.int32, device=device),
        cov=torch.zeros((n_lanes, (uop_capacity + 31) // 32),
                        dtype=torch.int32, device=device),
        edge=torch.zeros((n_lanes, (1 << edge_bits) // 32),
                         dtype=torch.int32, device=device),
        overlay=overlay_init(n_lanes, overlay_slots, device),
    )


def machine_restore(machine: Machine, template: Machine) -> None:
    """Restore(): every lane back to the snapshot, in place.  O(1) in
    guest memory: the template's register/bookkeeping tensors are copied
    over, the overlay index is dropped (its storage stays), and the
    counter block and bitmaps are zeroed.  Build the template with
    `overlay_slots=0` so no second overlay is held."""
    for f in dataclasses.fields(machine):
        if f.name in ("overlay", "ctr", "cov", "edge"):
            continue
        getattr(machine, f.name).copy_(getattr(template, f.name))
    overlay_reset(machine.overlay)
    machine.ctr.zero_()
    machine.cov.zero_()
    machine.edge.zero_()
