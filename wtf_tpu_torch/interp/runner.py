"""Host orchestration of the batched device interpreter.

The counterpart of wtf_tpu/interp/runner.py.  The device runs chunks of
batched steps (interp/step.py) — or, with the fused step on, rounds of the
fused kernel plus the precise resume leg (interp/pstep.py) — and the host
services whatever each lane reported in its status word:

  NEED_DECODE  - decode bytes at the lane's rip once, publish to the shared
                 uop table, resume
  SMC          - lane's code bytes diverged from the cache: re-decode and
                 update the entry in place
  UNSUPPORTED  - single-step the lane on the host EmuCpu oracle
  BREAKPOINT   - dispatch to the backend's registered handler
  PAGE_FAULT / DIVIDE_ERROR - deliver through the guest IDT when the
                 snapshot has one
  terminal     - OK/CRASH/TIMEDOUT/... mapped to results by the backend

Host<->device traffic is batched: one pull of the small per-lane register
tensors per service round (`HostView`), page reads on demand, and all
memory writes buffered host-side and applied in one pass
(`_apply_page_writes`) before the next chunk.  A device-generated batch
(wtf_tpu_torch/devmut) lands through `device_insert_impl` instead, and the
megachunk window (wtf_tpu_torch/fuzz/megachunk.py) is reached through
`megachunk_callable`.  With `device_decode` the window services decode
misses on the device (interp/devdec.py) and the host service fetches the
missing lanes' code windows in one device pass (`_gather_code_windows`).
Every device dispatch of the runner — the precise chunk, K1 and its
resume leg, the insert and the code-window gather — goes through the
backend's supervisor (wtf_tpu_torch/supervise), which is inert unless
supervision or a scripted fault is armed.

A heterogeneous batch (wtf_tpu_torch/tenancy, the `tenants=` kwarg) runs
several snapshots behind one stacked image: every lane carries its
tenant's row selector, and every host service — decode, SMC update,
breakpoint lookup, oracle step, exception delivery, page read — routes
through the lane's tenant (`tenant_of`, `cpu0_of`, `lane_physmem`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from wtf_tpu_torch.core.cpustate import CpuState
from wtf_tpu_torch.core.gxa import PAGE_SHIFT, PAGE_SIZE
from wtf_tpu_torch.core.results import StatusCode
from wtf_tpu_torch.cpu import uops as U
from wtf_tpu_torch.cpu.decoder import decode
from wtf_tpu_torch.cpu.emu import (
    DivideError, EmuCpu, GuestCrash, MemFault, UnsupportedInsn,
)
from wtf_tpu_torch.cpu.interrupts import (
    VEC_DE, DeliveryFailed, deliver_exception, deliver_page_fault,
)
from wtf_tpu_torch.device import resolve_device
from wtf_tpu_torch.interp import ints, pstep
from wtf_tpu_torch.interp.machine import (
    CTR_DECODE_MISS, CTR_FUSED, CTR_INSTR, CTR_MEM_FAULT, CTR_PARK_MEM,
    CTR_PARK_SUBSET, Machine, machine_init, machine_restore,
)
from wtf_tpu_torch.interp.step import run_steps
from wtf_tpu_torch.interp.uoptable import DecodeCache
from wtf_tpu_torch.mem.physmem import lane_image
from wtf_tpu_torch.snapshot.loader import Snapshot
from wtf_tpu_torch.supervise import Supervisor
from wtf_tpu_torch.telemetry import NULL, Registry, StatsDict

MASK64 = (1 << 64) - 1

# opc int -> lowercase class name ("alu", "ssefp", ...) for fallback stats
_OPC_NAMES = {
    value: name[len("OPC_"):].lower()
    for name, value in vars(U).items() if name.startswith("OPC_")
}

PTE_P = 1
PTE_W = 1 << 1
PTE_PS = 1 << 7
PHYS_MASK = 0x000F_FFFF_FFFF_F000

# Machine fields mirrored into HostView (everything except overlay and
# the bitmaps), grouped by dtype so a pull or a push is one transfer each.
# Host code sees the int64 fields as uint64 and the counter block as
# uint32, the JAX package's host views.
_MIRROR_I64 = (
    "gpr", "rip", "rflags", "xmm", "fs_base", "gs_base", "kernel_gs_base",
    "cr0", "cr2", "cr3", "cr4", "cr8", "cs", "ss",
    "lstar", "star", "sfmask", "efer", "tsc",
    "fpst", "fpcw", "fpsw", "fptw", "mxcsr",
    "icount", "rdrand", "fault_gva",
)
_MIRROR_I32 = ("status", "bp_skip", "fault_write", "ctr")
_HOST_VIEW = {"ctr": np.uint32}


def _pull(m: Machine, names) -> Dict[str, np.ndarray]:
    """One device->host copy for `names` (same dtype): a flat concat on
    the device, split into writable host arrays."""
    ts = [getattr(m, n) for n in names]
    flat = torch.cat([t.reshape(-1) for t in ts]).cpu().numpy()
    out, pos = {}, 0
    for n, t in zip(names, ts):
        k = t.numel()
        arr = flat[pos:pos + k].reshape(tuple(t.shape)).copy()
        if n in _HOST_VIEW:
            arr = arr.view(_HOST_VIEW[n])
        elif arr.dtype == np.int64:
            arr = arr.view(np.uint64)
        out[n] = arr
        pos += k
    return out


def _status(m: Machine) -> torch.Tensor:
    """What a supervised machine seam's watchdog waits on."""
    return m.status


def _push(m: Machine, host: Dict[str, np.ndarray], names, dtype) -> None:
    """One host->device copy for `names`; each field becomes a contiguous
    view of the uploaded buffer."""
    np_dtype = np.int64 if dtype == torch.int64 else np.int32
    flat = np.concatenate([np.ascontiguousarray(host[n]).view(np_dtype)
                           .reshape(-1) for n in names])
    dev = torch.from_numpy(flat).to(m.device)
    pos = 0
    for n in names:
        shape = tuple(getattr(m, n).shape)
        k = int(np.prod(shape))
        setattr(m, n, dev[pos:pos + k].view(shape))
        pos += k


class HostFault(Exception):
    """Host-side page walk failed (non-present / non-canonical)."""

    def __init__(self, gva: int, write: bool):
        super().__init__(f"host #PF {'write' if write else 'read'} @ {gva:#x}")
        self.gva = gva
        self.write = write


class HostView:
    """Mutable host mirror of the batch: registers as numpy arrays, guest
    memory as a merged (pending writes | device overlay | base image)
    view.  What breakpoint handlers and the target harness operate on,
    for all lanes at once; mutations stay host-side until `Runner.push`
    applies them in one batch."""

    def __init__(self, runner: "Runner"):
        self.runner = runner
        m = runner.machine
        self.r: Dict[str, np.ndarray] = _pull(m, _MIRROR_I64)
        self.r.update(_pull(m, _MIRROR_I32))
        # overlay index pulled once; data rows fetched lazily per (lane, pfn)
        self._ov_pfn = m.overlay.pfn.cpu().numpy()
        self._page_cache: Dict[Tuple[int, int], bytes] = {}
        self.pending: Dict[Tuple[int, int], bytearray] = {}

    # -- registers -------------------------------------------------------
    def get_reg(self, lane: int, idx: int) -> int:
        return int(self.r["gpr"][lane, idx])

    def set_reg(self, lane: int, idx: int, value: int) -> None:
        self.r["gpr"][lane, idx] = np.uint64(value & MASK64)

    def get_rip(self, lane: int) -> int:
        return int(self.r["rip"][lane])

    def set_rip(self, lane: int, value: int) -> None:
        self.r["rip"][lane] = np.uint64(value & MASK64)

    def set_status(self, lane: int, status: StatusCode) -> None:
        self.r["status"][lane] = np.int32(int(status))

    def get_status(self, lane: int) -> StatusCode:
        return StatusCode(int(self.r["status"][lane]))

    # -- physical memory -------------------------------------------------
    def _base_page(self, lane: int, pfn: int) -> bytes:
        return self.runner.lane_physmem(lane).host_read(pfn << PAGE_SHIFT,
                                                        PAGE_SIZE)

    def _device_overlay_page(self, lane: int, pfn: int) -> Optional[bytes]:
        slots = np.nonzero(self._ov_pfn[lane] == pfn)[0]
        if len(slots) == 0:
            return None
        slot = int(slots[0])
        ov = self.runner.machine.overlay
        data = ov.data[lane, slot].cpu().numpy().view(np.uint64)
        valid = ov.valid[lane, slot].cpu().numpy()
        # delta row: only valid words come from the overlay
        base = np.frombuffer(self._base_page(lane, pfn), dtype=np.uint64)
        return np.where(valid != 0, data, base).tobytes()

    def page(self, lane: int, pfn: int) -> bytes:
        """Current contents of a guest-physical page as this lane sees it."""
        key = (lane, pfn)
        if key in self.pending:
            return bytes(self.pending[key])
        cached = self._page_cache.get(key)
        if cached is None:
            cached = self._device_overlay_page(lane, pfn)
            if cached is None:
                cached = self._base_page(lane, pfn)
            self._page_cache[key] = cached
        return cached

    def page_dirty(self, lane: int, pfn: int) -> bool:
        return ((lane, pfn) in self.pending
                or bool(np.any(self._ov_pfn[lane] == pfn)))

    def phys_read(self, lane: int, gpa: int, size: int) -> bytes:
        out = bytearray()
        pos = gpa
        while pos < gpa + size:
            pfn = pos >> PAGE_SHIFT
            off = pos & (PAGE_SIZE - 1)
            chunk = min(gpa + size - pos, PAGE_SIZE - off)
            out += self.page(lane, pfn)[off:off + chunk]
            pos += chunk
        return bytes(out)

    def phys_write(self, lane: int, gpa: int, data: bytes) -> None:
        pos = 0
        while pos < len(data):
            addr = gpa + pos
            pfn = addr >> PAGE_SHIFT
            off = addr & (PAGE_SIZE - 1)
            chunk = min(len(data) - pos, PAGE_SIZE - off)
            key = (lane, pfn)
            if key not in self.pending:
                self.pending[key] = bytearray(self.page(lane, pfn))
            self.pending[key][off:off + chunk] = data[pos:pos + chunk]
            pos += chunk

    # -- virtual memory --------------------------------------------------
    def translate(self, lane: int, gva: int, write: bool = False) -> int:
        """4-level long-mode walk through this lane's memory view
        (reference kvm_backend.cc:1937-1998)."""
        gva &= MASK64
        top = gva >> 47
        if top != 0 and top != 0x1FFFF:
            raise HostFault(gva, write)
        table = int(self.r["cr3"][lane]) & PHYS_MASK
        for shift, large_mask in ((39, None), (30, 0x000F_FFFF_C000_0000),
                                  (21, 0x000F_FFFF_FFE0_0000), (12, None)):
            index = (gva >> shift) & 0x1FF
            entry = int.from_bytes(
                self.phys_read(lane, table + index * 8, 8), "little")
            if not entry & PTE_P:
                raise HostFault(gva, write)
            if write and not entry & PTE_W:
                raise HostFault(gva, write)
            if large_mask is not None and entry & PTE_PS:
                return (entry & large_mask) | (gva & ((1 << shift) - 1))
            if shift == 12:
                return (entry & PHYS_MASK) | (gva & 0xFFF)
            table = entry & PHYS_MASK
        raise AssertionError("unreachable")

    def virt_read(self, lane: int, gva: int, size: int) -> bytes:
        out = bytearray()
        pos = gva
        while pos < gva + size:
            off = pos & (PAGE_SIZE - 1)
            chunk = min(gva + size - pos, PAGE_SIZE - off)
            gpa = self.translate(lane, pos)
            out += self.phys_read(lane, gpa, chunk)
            pos += chunk
        return bytes(out)

    def virt_write(self, lane: int, gva: int, data: bytes) -> None:
        """Host-initiated guest write: through page protection (the
        reference's VirtWrite is a raw memcpy), dirty by construction."""
        pos = 0
        while pos < len(data):
            addr = gva + pos
            off = addr & (PAGE_SIZE - 1)
            chunk = min(len(data) - pos, PAGE_SIZE - off)
            gpa = self.translate(lane, addr, write=False)
            self.phys_write(lane, gpa, data[pos:pos + chunk])
            pos += chunk


class _LaneCtx:
    """Exception-delivery ctx (cpu/interrupts.py duck type) over one lane
    of a HostView; IDT/TSS anchors come from the snapshot CpuState."""

    def __init__(self, view: HostView, lane: int, snapshot_cpu: CpuState):
        self.view = view
        self.lane = lane
        self.idt_base = snapshot_cpu.idtr.base
        self.idt_limit = snapshot_cpu.idtr.limit
        self.tss_base = snapshot_cpu.tr.base

    @property
    def rip(self) -> int:
        return self.view.get_rip(self.lane)

    @rip.setter
    def rip(self, value: int) -> None:
        self.view.set_rip(self.lane, value)

    @property
    def rsp(self) -> int:
        return self.view.get_reg(self.lane, 4)

    @rsp.setter
    def rsp(self, value: int) -> None:
        self.view.set_reg(self.lane, 4, value)

    @property
    def rflags(self) -> int:
        return int(self.view.r["rflags"][self.lane])

    @rflags.setter
    def rflags(self, value: int) -> None:
        self.view.r["rflags"][self.lane] = np.uint64(value & MASK64)

    @property
    def cs_sel(self) -> int:
        return int(self.view.r["cs"][self.lane])

    @cs_sel.setter
    def cs_sel(self, value: int) -> None:
        self.view.r["cs"][self.lane] = np.uint64(value & 0xFFFF)

    @property
    def ss_sel(self) -> int:
        return int(self.view.r["ss"][self.lane])

    @ss_sel.setter
    def ss_sel(self, value: int) -> None:
        self.view.r["ss"][self.lane] = np.uint64(value & 0xFFFF)

    def set_cr2(self, value: int) -> None:
        self.view.r["cr2"][self.lane] = np.uint64(value & MASK64)

    def read_virt(self, gva: int, size: int) -> bytes:
        return self.view.virt_read(self.lane, gva, size)

    def read_u64(self, gva: int) -> int:
        return int.from_bytes(self.read_virt(gva, 8), "little")

    def write_u64(self, gva: int, value: int) -> None:
        self.view.virt_write(
            self.lane, gva, (value & MASK64).to_bytes(8, "little"))


class _FallbackMem:
    """EmuMem-compatible adapter running the EmuCpu oracle against one
    lane's HostView."""

    def __init__(self, view: HostView, lane: int):
        self.view = view
        self.lane = lane

    def phys_read(self, gpa: int, size: int) -> bytes:
        return self.view.phys_read(self.lane, gpa, size)

    def phys_write(self, gpa: int, data: bytes) -> None:
        self.view.phys_write(self.lane, gpa, data)

    def phys_read_u64(self, gpa: int) -> int:
        return int.from_bytes(self.phys_read(gpa, 8), "little")

    @property
    def overlay(self):
        # EmuCpu probes `pfn in mem.overlay` for its SMC check
        view, lane = self.view, self.lane

        class _DirtySet:
            def __contains__(self, pfn):
                return view.page_dirty(lane, pfn)

        return _DirtySet()


def _lane_cpu_state(view: HostView, lane: int,
                    snapshot_cpu: CpuState) -> CpuState:
    """A CpuState for the oracle from a lane's mirror (fields the device
    doesn't carry come from the snapshot)."""
    cpu = snapshot_cpu.copy()
    r = view.r
    cpu.set_gpr_list(list(r["gpr"][lane]))
    cpu.rip = int(r["rip"][lane])
    cpu.rflags = int(r["rflags"][lane])
    cpu.fs.base = int(r["fs_base"][lane])
    cpu.gs.base = int(r["gs_base"][lane])
    for name in ("kernel_gs_base", "cr0", "cr2", "cr3", "cr4", "cr8",
                 "lstar", "star", "sfmask", "efer", "tsc", "fpcw", "fpsw",
                 "fptw", "mxcsr"):
        setattr(cpu, name, int(r[name][lane]))
    cpu.cs.selector = int(r["cs"][lane])
    cpu.ss.selector = int(r["ss"][lane])
    cpu.fpst = [int(v) for v in r["fpst"][lane]]
    for i in range(16):
        for limb in range(4):
            cpu.zmm[i][limb] = int(r["xmm"][lane, i, limb])
    return cpu


def _writeback_lane(view: HostView, lane: int, cpu: EmuCpu) -> None:
    r = view.r
    r["gpr"][lane] = np.array(cpu.gpr, dtype=np.uint64)
    r["rip"][lane] = np.uint64(cpu.rip & MASK64)
    r["rflags"][lane] = np.uint64(cpu.rflags & MASK64)
    for name in ("fs_base", "gs_base", "kernel_gs_base", "cr0", "cr2",
                 "cr3", "cr4", "cr8", "lstar", "star", "sfmask", "efer",
                 "tsc", "mxcsr"):
        r[name][lane] = np.uint64(getattr(cpu, name) & MASK64)
    r["cs"][lane] = np.uint64(cpu.cs_sel & 0xFFFF)
    r["ss"][lane] = np.uint64(cpu.ss_sel & 0xFFFF)
    r["fpst"][lane] = np.array(
        [v & MASK64 for v in cpu.fp_state_list()], dtype=np.uint64)
    r["fpcw"][lane] = np.uint64(cpu.fpcw & 0xFFFF)
    r["fpsw"][lane] = np.uint64(cpu.fpsw_packed() & 0xFFFF)
    r["fptw"][lane] = np.uint64(cpu.fptw & 0xFFFF)
    for i in range(16):
        r["xmm"][lane, i, 0] = np.uint64(cpu.xmm[i][0] & MASK64)
        r["xmm"][lane, i, 1] = np.uint64(cpu.xmm[i][1] & MASK64)
        r["xmm"][lane, i, 2] = np.uint64(cpu.ymmh[i][0] & MASK64)
        r["xmm"][lane, i, 3] = np.uint64(cpu.ymmh[i][1] & MASK64)


def _apply_page_writes(m: Machine, items) -> None:
    """Apply buffered whole-page host writes [(lane, pfn, page bytes)],
    sorted by (lane, pfn), into the overlay: the JAX package's sequential
    scan, run as rounds that take at most one write per lane so each round
    is one batched update.  A write that finds its lane out of rows is
    dropped and the lane surfaces as OVERLAY_FULL."""
    ov = m.overlay
    capacity = ov.capacity
    by_lane: Dict[int, List] = {}
    for lane, pfn, page in items:
        by_lane.setdefault(lane, []).append((pfn, page))
    rounds = max(len(v) for v in by_lane.values())
    for k in range(rounds):
        batch = [(lane, w[k]) for lane, w in by_lane.items() if len(w) > k]
        lanes = torch.tensor([b[0] for b in batch], device=m.device)
        pfns = torch.tensor([b[1][0] for b in batch], dtype=torch.int32,
                            device=m.device)
        pages = torch.from_numpy(np.stack([
            np.frombuffer(bytes(b[1][1]), dtype=np.int64)
            for b in batch])).to(m.device)
        eq = ov.pfn[lanes] == pfns[:, None]
        hit = eq.any(1)
        idx0 = eq.to(torch.uint8).argmax(1)
        cnt = ov.count[lanes].long()
        can = cnt < capacity
        slot = torch.where(hit, idx0, cnt % capacity)
        do = hit | can
        dl, ds = lanes[do], slot[do]
        ov.data[dl, ds] = pages[do]
        ov.valid[dl, ds] = 1
        ov.pfn[dl, ds] = pfns[do]
        ov.count[lanes] += (~hit & can).to(torch.int32)
        ov.overflow[lanes] |= ~hit & ~can
    m.status = torch.where(
        ov.overflow & (m.status == int(StatusCode.RUNNING)),
        int(StatusCode.OVERLAY_FULL), m.status).to(torch.int32)


def device_insert_impl(m: Machine, words: torch.Tensor, lens: torch.Tensor,
                       pfns: torch.Tensor, gva: int, len_gpr: int,
                       ptr_gpr: int,
                       active: Optional[torch.Tensor] = None) -> None:
    """Land a device-generated batch in every lane, in place: `words`
    (int32[L, W], u32 bits) / `lens` (int32[L]) fill n_pages = len(pfns)
    FRESH overlay rows per lane from the lane's current `count` (rows a
    preceding host push claimed stay intact), and the target's length and
    pointer registers are set.  The counterpart of the JAX package's
    `device_insert_impl` (wtf_tpu/interp/runner.py:505-579), shared by
    Runner.device_insert and the megachunk window.

    Rows that already hold an insert-region pfn (a pushed host write into
    the input region) are retired first, so the testcase wins — lookups
    take the first matching row; the retired row leaks until restore.  A
    lane without n_pages free rows gets none, is flagged in `overflow`,
    and a RUNNING one becomes OVERLAY_FULL.

    `active` (bool[L], the masked insert of wtf_tpu_torch/tenancy) limits
    the insert to one tenant's lanes: inactive lanes keep their overlay
    rows, counters, status and ABI registers untouched, so per-tenant
    device batches land with one call per tenant.  The megachunk window
    inserts every lane (no mask)."""
    ov = m.overlay
    n_lanes, n_words = words.shape
    n_pages = pfns.shape[0]
    pad = n_pages * (PAGE_SIZE // 4) - n_words
    if pad < 0:
        raise ValueError("testcase words exceed the insert region")
    w = torch.nn.functional.pad(words, (0, pad)) if pad else words
    rows = w.contiguous().view(torch.int64).view(n_lanes, n_pages, -1)
    capacity = ov.capacity
    dead = (ov.pfn[:, :, None] == pfns[None, None, :]).any(-1)
    if active is not None:
        dead &= active[:, None]
    pfn0 = torch.where(dead, -1, ov.pfn)
    start = ov.count.long()
    can = start + n_pages <= capacity
    ok = can if active is None else can & active
    full = ~can if active is None else ~can & active
    li = torch.arange(n_lanes, device=m.device)[:, None]
    ridx = (start[:, None] + torch.arange(n_pages, device=m.device)
            ).clamp(max=capacity - 1)
    sel = ok[:, None]
    ov.data[li, ridx] = torch.where(sel[..., None], rows, ov.data[li, ridx])
    ov.valid[li, ridx] = torch.where(sel[..., None], 1, ov.valid[li, ridx]
                                     ).to(torch.uint8)
    pfn0[li, ridx] = torch.where(sel, pfns.expand(n_lanes, n_pages),
                                 pfn0[li, ridx])
    ov.pfn.copy_(pfn0)
    ov.count.copy_(torch.where(ok, start + n_pages, start))
    ov.overflow |= full
    m.status.copy_(torch.where(full & (m.status == int(StatusCode.RUNNING)),
                               int(StatusCode.OVERLAY_FULL), m.status))
    if active is None:
        m.gpr[:, len_gpr] = lens.long()
        m.gpr[:, ptr_gpr] = ints.s64(gva)
    else:
        m.gpr[:, len_gpr] = torch.where(active, lens.long(),
                                        m.gpr[:, len_gpr])
        m.gpr[:, ptr_gpr] = torch.where(active, ints.s64(gva),
                                        m.gpr[:, ptr_gpr])


class Runner:
    """Owns the device batch and the decode cache and drives the run loop.
    One Runner == one snapshot on one device == N lanes of it."""

    def __init__(
        self,
        snapshot: Snapshot,
        n_lanes: int,
        uop_capacity: int = 1 << 14,
        overlay_slots: int = 128,
        edge_bits: int = 17,
        chunk_steps: int = 256,
        deliver_exceptions: Optional[bool] = None,
        registry: Optional[Registry] = None,
        events=None,
        fused_step: str = "off",
        fused_k: int = 32,
        fused_rounds: int = 8,
        fused_resume_steps: int = 1,
        burst_any_tier: Optional[bool] = None,
        device="cuda",
        device_decode: bool = False,
        supervisor: Optional[Supervisor] = None,
        tenants=None,
    ):
        self.registry = registry if registry is not None else Registry()
        self.events = events if events is not None else NULL
        # Every device dispatch seam routes through the supervisor
        # (wtf_tpu_torch/supervise): inert by default, armed by the
        # backend for watchdog/recovery/chaos.  A rebuilt Runner SHARES
        # its backend's supervisor, so dispatch indices and telemetry
        # survive recovery.
        self.supervisor = supervisor if supervisor is not None \
            else Supervisor(registry=self.registry, events=self.events)
        self.device = resolve_device(device) if isinstance(device, str) \
            else device
        self.snapshot = snapshot
        self.physmem = snapshot.physmem
        self.n_lanes = n_lanes
        self.cache = DecodeCache(capacity=uop_capacity)
        if tenants is None:
            self.image = lane_image(snapshot.physmem.image(self.device),
                                    n_lanes)
            self.machine = machine_init(snapshot.cpu, n_lanes, uop_capacity,
                                        overlay_slots, edge_bits,
                                        self.device)
            self.template = machine_init(snapshot.cpu, n_lanes,
                                         uop_capacity, 0, edge_bits,
                                         self.device)
            self.tenant_of_lane = np.zeros(n_lanes, dtype=np.int32)
            self._physmems = [snapshot.physmem]
            self._cpu0s = [snapshot.cpu]
        else:
            # heterogeneous batch (wtf_tpu_torch/tenancy): per-lane base-
            # image ids over a stacked image table; per-lane machine state
            # initialized from each tenant's CpuState.  `snapshot` is the
            # table's primary (tenant 0) for the compat surfaces above.
            from wtf_tpu_torch.tenancy.image import build_batch_state

            built = build_batch_state(tenants, n_lanes, uop_capacity,
                                      overlay_slots, edge_bits, self.device)
            self.image = built.image
            self.machine = built.machine
            self.template = built.template
            self.tenant_of_lane = built.tenant_of_lane
            self._physmems = built.physmems
            self._cpu0s = built.cpus
        self.limit = 0
        self.chunk_steps = chunk_steps
        # Auto mode delivers guest exceptions when a snapshot carries an
        # IDT; a heterogeneous batch gates per lane (`_deliver_lane`), so
        # an IDT-less tenant's faults stay terminal exactly as they do
        # solo.
        if deliver_exceptions is None:
            deliver_exceptions = any(
                cpu.idtr.limit > 0 for cpu in self._cpu0s)
        self.deliver_exceptions = deliver_exceptions
        # Fused fast path (interp/pstep.py): per chunk the runner launches
        # the fused kernel, then a short precise resume leg for the lanes
        # it parked.  "on" and "auto" run it on a CUDA device and raise
        # when its kernel cannot be built or launched there; "on" runs
        # the plain version on the CPU, "auto" does not.
        if fused_step not in ("off", "auto", "on"):
            raise ValueError(
                f"fused_step must be off|auto|on, got {fused_step!r}")
        self.fused_step = fused_step
        self.fused_enabled = fused_step == "on" or (
            fused_step == "auto" and self.device.type == "cuda")
        if self.fused_enabled:
            ok, reason = pstep.fused_available(self.device)
            if not ok:
                raise RuntimeError(
                    f"fused_step={fused_step!r} but the fused kernel cannot "
                    f"run on {self.device}: {reason}")
        self.fused_k = fused_k
        self.fused_rounds = fused_rounds
        self.fused_resume_steps = fused_resume_steps
        # Device decode (interp/devdec.py): megachunk windows service
        # decode misses on the device, and host service rounds fetch only
        # the missing lanes' code windows instead of pulling page views.
        # The host decoder re-decodes and checks every device-published
        # entry at harvest (DecodeCache.adopt_device_entries).
        self.device_decode = device_decode
        self.lane_errors: Dict[int, str] = {}
        self._smc_updates: Dict[Tuple[int, int], int] = {}
        # adaptive chunk growth for deep executions (x16 rungs up to 65536)
        self.adaptive_chunks = True
        self._chunk_sizes = [chunk_steps]
        while self._chunk_sizes[-1] < (1 << 16):
            self._chunk_sizes.append(min(self._chunk_sizes[-1] * 16, 1 << 16))
        self._chunk_level = 0
        self._fallback_streak: Dict[int, int] = {}
        if burst_any_tier is None:
            burst_any_tier = self.device.type != "cpu"
        self.burst_any_tier = burst_any_tier
        # (lane, uop-entry) coverage bits and (lane, edge-index) edge bits
        # owed by oracle burst steps; OR-ed into the device bitmaps at
        # the next push
        self._pending_cov: List[Tuple[int, int]] = []
        self._pending_edge: List[Tuple[int, int]] = []
        # fallbacks_by_opclass: oracle single-steps by opcode class
        self.stats = StatsDict(
            self.registry, "runner",
            fields=("chunks", "decodes", "decodes_prefetched",
                    "decode_windows_gathered", "fallbacks",
                    "fallback_burst_steps", "smc_updates", "bp_dispatches",
                    "exceptions_delivered"),
            gauges=("max_chunk_steps",),
            labeled=("fallbacks_by_opclass",))
        self.stats["max_chunk_steps"] = chunk_steps
        self.supervisor.attach_runner(self)

    # -- per-lane tenant routing (single-image batches are tenant 0) -------
    def tenant_of(self, lane: int) -> int:
        return int(self.tenant_of_lane[lane])

    def cpu0_of(self, lane: int) -> CpuState:
        """The lane's snapshot CpuState (oracle fallback segments/x87,
        IDT/TSS anchors for exception delivery)."""
        return self._cpu0s[self.tenant_of(lane)]

    def lane_physmem(self, lane: int):
        """The lane's base-image PhysMem (host-side page reads)."""
        return self._physmems[self.tenant_of(lane)]

    def _deliver_lane(self, lane: int) -> bool:
        return self.cpu0_of(lane).idtr.limit > 0

    def device_tab(self):
        return self.cache.device(self.device)

    def view(self) -> HostView:
        return HostView(self)

    # -- checkpoint/resume (wtf_tpu_torch/resume) --------------------------
    def checkpoint_state(self) -> dict:
        """The runner state a campaign checkpoint must carry: the decode
        cache in insertion order (coverage-bitmap bit i is cache entry i,
        so restored aggregate bitmaps are meaningless without identical
        indices) plus the SMC thrash counters that gate the per-rip
        fallback cutover.  Machine state needs nothing — checkpoints are
        taken at batch boundaries, where the machine is freshly
        restored to the snapshot."""
        return {
            "cache": self.cache.checkpoint_entries(),
            # (tenant, rip) keys flatten to JSON-able triples
            "smc_updates": [[t, r, n]
                            for (t, r), n in self._smc_updates.items()],
        }

    def restore_state(self, state: dict) -> None:
        """Restore checkpoint_state() output into a freshly-initialized
        runner (empty decode cache; breakpoints from target.init may
        already be pending — add() re-arms them).  The device table is
        uploaded again from the restored host arrays at the next
        `device_tab()`."""
        self.cache.restore_entries(state.get("cache", []))
        self._smc_updates = {(int(t), int(r)): int(n)
                             for t, r, n in state.get("smc_updates", [])}

    # -- mutate-on-device seams (wtf_tpu_torch/devmut) ---------------------
    def device_insert(self, words, lens, pfns, gva: int, len_gpr: int,
                      ptr_gpr: int, active=None) -> None:
        """Insert a device-generated batch without a host round trip:
        `words` / `lens` (typically straight from devmut's generate) land
        in fresh overlay rows of every lane — or, with `active` (bool[L]),
        of the active lanes only — and the target's ABI registers are set
        (device_insert_impl).  Call after the push of any staged host
        writes, so the testcase wins an overlap."""
        n_pages = len(pfns)
        if n_pages > self.machine.overlay.capacity:
            raise ValueError(
                f"device-insert region spans {n_pages} pages but lanes "
                f"have only {self.machine.overlay.capacity} overlay slots "
                f"— raise overlay_slots or shrink the mutator/spec max_len")
        mask = None if active is None else torch.from_numpy(
            np.asarray(active, dtype=bool)).to(self.device)
        self.supervisor.dispatch(
            "device-insert", self._insert, words, lens,
            torch.tensor(pfns, dtype=torch.int32, device=self.device),
            gva, len_gpr, ptr_gpr, mask, sync=_status)

    def _insert(self, words, lens, pfns, gva, len_gpr, ptr_gpr,
                active=None) -> Machine:
        device_insert_impl(self.machine, words, lens, pfns, gva, len_gpr,
                           ptr_gpr, active)
        return self.machine

    def devmut_generate(self, rounds: int, data, lens, cumw, seeds):
        """One devmut batch generation on this runner's device (the seam
        the device mutator drives)."""
        from wtf_tpu_torch.devmut.engine import generate

        return generate(data, lens, cumw, seeds, rounds)

    def megachunk_callable(self, max_batches: int, len_gpr: int,
                           ptr_gpr: int, rounds: int):
        """The multi-batch window (wtf_tpu_torch/fuzz/megachunk.py) that
        GpuBackend.run_megachunk calls.  `fused_enabled` is read HERE, at
        call time, so the window's quiesce follows the runner's step
        engine."""
        from wtf_tpu_torch.fuzz.megachunk import make_megachunk

        return make_megachunk(max_batches, len_gpr, ptr_gpr, rounds,
                              deliver=self.deliver_exceptions,
                              fused=bool(self.fused_enabled),
                              fused_k=self.fused_k,
                              fused_resume_steps=self.fused_resume_steps)

    def devdec_operands(self):
        """The window's device-decode operands, or None when device decode
        is off: the live cache count, the pending-breakpoint keys (int64,
        padded to a power-of-two bucket of at least 8; 0 is a valid key,
        so the live length rides along) and that length."""
        if not self.device_decode:
            return None
        keys = sorted(self.cache.pending_bps)
        bucket = 8
        while bucket < len(keys):
            bucket *= 2
        padded = np.zeros(bucket, dtype=np.uint64)
        padded[:len(keys)] = keys
        return (self.cache.count,
                torch.from_numpy(padded.view(np.int64)).to(self.device),
                len(keys))

    def megachunk_place(self, slab_first, slab_rest, seeds):
        """Placement hook for one window's operands — identity on a
        single device."""
        return slab_first, slab_rest, seeds

    def push(self, view: HostView) -> None:
        """Apply a HostView's mutations (registers, buffered page writes,
        burst coverage bits) back to the device batch."""
        m = self.machine
        _push(m, view.r, _MIRROR_I64, torch.int64)
        _push(m, view.r, _MIRROR_I32, torch.int32)

        def apply_bits(bitmap: torch.Tensor, pending) -> torch.Tensor:
            acc: Dict[Tuple[int, int], int] = {}
            for lane, bit in pending:
                key = (lane, bit >> 5)
                acc[key] = acc.get(key, 0) | (1 << (bit & 31))
            lanes = torch.tensor([k[0] for k in acc], device=m.device)
            words = torch.tensor([k[1] for k in acc], device=m.device)
            bits = torch.tensor(
                np.array(list(acc.values()), dtype=np.uint32).view(np.int32),
                device=m.device)
            bitmap = bitmap.clone()
            bitmap[lanes, words] |= bits
            return bitmap

        if self._pending_cov:
            m.cov = apply_bits(m.cov, self._pending_cov)
            self._pending_cov.clear()
        if self._pending_edge:
            m.edge = apply_bits(m.edge, self._pending_edge)
            self._pending_edge.clear()
        if view.pending:
            _apply_page_writes(m, [(lane, pfn, page) for (lane, pfn), page
                                   in sorted(view.pending.items())])
            view.pending.clear()

    # -- servicing ---------------------------------------------------------
    def _decode_at(self, view: HostView, lane: int, rip: int,
                   prefetched=None) -> bool:
        """Decode the instruction at `rip` through `lane`'s memory view and
        publish it.  Returns False on a fetch fault (lane made terminal).

        `prefetched` is an optional (window, fault, pfn0, pfn14) tuple
        from the device window gather (device decode): the same bytes and
        fault/pfn facts, with no HostView page pulls for the fetch."""
        if prefetched is not None:
            window, faulted, pfn0, pfn14 = prefetched
        else:
            try:
                window = view.virt_read(lane, rip, 15)
                pfn0 = view.translate(lane, rip) >> PAGE_SHIFT
                faulted = False
            except HostFault:
                faulted = True
        if faulted:
            self.lane_errors[lane] = f"fetch fault @ {rip:#x}"
            view.r["ctr"][lane, CTR_MEM_FAULT] += np.uint32(1)
            view.set_status(lane, StatusCode.PAGE_FAULT)
            view.r["fault_gva"][lane] = np.uint64(rip & MASK64)
            view.r["fault_write"][lane] = np.int32(0)
            return False
        uop = decode(window, rip)
        if prefetched is not None:
            # a 15-byte window read that did not fault walked both pages:
            # the last instruction byte lies on the second exactly when
            # the instruction crosses the page
            crosses = (rip & (PAGE_SIZE - 1)) + max(uop.length - 1, 0) \
                >= PAGE_SIZE
            pfn1 = pfn14 if crosses else pfn0
        else:
            try:
                pfn1 = view.translate(
                    lane, rip + max(uop.length - 1, 0)) >> PAGE_SHIFT
            except HostFault:
                pfn1 = pfn0
        self.cache.add(rip, uop, pfn0, pfn1, tenant=self.tenant_of(lane))
        self.stats["decodes"] += 1
        self._prefetch_block(view, lane, uop, rip)
        return True

    # Decode-ahead bounds: block prefetch publishes up to this many extra
    # instructions per miss, and never within this margin of capacity
    PREFETCH_BUDGET = 48
    _PREFETCH_MARGIN = 64

    def _prefetch_block(self, view: HostView, lane: int, uop,
                        rip: int) -> None:
        """Recursive-descent decode-ahead from a fresh miss along the
        fallthrough and direct branch targets, so a basic block publishes
        in one servicing round (wrong-path prefetches are harmless)."""
        def succs(u, at):
            nxt = (at + u.length) & MASK64
            opc = u.opc
            if opc in (U.OPC_RET, U.OPC_IRET, U.OPC_HLT, U.OPC_INT,
                       U.OPC_INT1, U.OPC_INVALID, U.OPC_SYSCALL):
                return ()
            if opc == U.OPC_JMP:
                return ((nxt + u.imm) & MASK64,) if u.src_kind == U.K_IMM \
                    else ()
            if opc == U.OPC_JCC:
                return (nxt, (nxt + u.imm) & MASK64)
            if opc == U.OPC_CALL and u.src_kind == U.K_IMM:
                return (nxt, (nxt + u.imm) & MASK64)
            return (nxt,)

        budget = self.PREFETCH_BUDGET
        tenant = self.tenant_of(lane)
        work = list(succs(uop, rip))
        while work and budget > 0:
            if self.cache.count >= self.cache.capacity - self._PREFETCH_MARGIN:
                return
            at = work.pop()
            if self.cache.has(at, tenant):
                continue
            try:
                window = view.virt_read(lane, at, 15)
                pfn0 = view.translate(lane, at) >> PAGE_SHIFT
            except HostFault:
                continue
            u2 = decode(window, at)
            if u2.opc == U.OPC_INVALID:
                continue
            try:
                pfn1 = view.translate(
                    lane, at + max(u2.length - 1, 0)) >> PAGE_SHIFT
            except HostFault:
                pfn1 = pfn0
            self.cache.add(at, u2, pfn0, pfn1, tenant=tenant)
            self.stats["decodes_prefetched"] += 1
            budget -= 1
            work.extend(succs(u2, at))

    def _service_decode(self, view: HostView, lanes: List[int]) -> None:
        windows = (self._gather_code_windows(view, lanes)
                   if self.device_decode else {})
        done: Set[Tuple[int, int]] = set()
        for lane in lanes:
            rip = view.get_rip(lane)
            key = (self.tenant_of(lane), rip)
            if key not in done:
                if not self.cache.has(rip, key[0]):
                    if not self._decode_at(view, lane, rip,
                                           prefetched=windows.get(lane)):
                        continue
                done.add(key)
            view.set_status(lane, StatusCode.RUNNING)

    def _gather_code_windows(self, view: HostView, lanes: List[int]):
        """Device decode's host-service half: ONE device pass gathers the
        missing lanes' 15-byte code windows (and the fault/pfn facts of
        their walks) through the overlay-aware page walk, so servicing a
        decode miss moves k x 15 bytes instead of riding the HostView
        page pulls.  Lanes whose rip is cached, or repeats an earlier
        lane's this round, are skipped before the gather."""
        from wtf_tpu_torch.interp import devdec

        want: List[int] = []
        seen: Set[Tuple[int, int]] = set()
        for lane in lanes:
            rip = view.get_rip(lane)
            key = (self.tenant_of(lane), rip)
            if key in seen or self.cache.has(rip, key[0]):
                continue
            seen.add(key)
            want.append(lane)
        if not want:
            return {}
        m = self.machine
        rips = torch.from_numpy(view.r["rip"].view(np.int64)).to(self.device)
        out = self.supervisor.dispatch(
            "device-decode", devdec.gather_windows, self.image, m.overlay,
            m.cr3, rips,
            torch.tensor(want, dtype=torch.int64, device=self.device),
            sync=lambda o: o[1])
        wins, faults, pfn0s, pfn14s = (x.cpu().numpy() for x in out)
        self.stats["decode_windows_gathered"] += len(want)
        return {lane: (wins[j].tobytes(), bool(faults[j]), int(pfn0s[j]),
                       int(pfn14s[j]))
                for j, lane in enumerate(want)}

    def _service_smc(self, view: HostView, lanes: List[int]) -> None:
        for lane in lanes:
            rip = view.get_rip(lane)
            skey = (self.tenant_of(lane), rip)
            n = self._smc_updates.get(skey, 0) + 1
            self._smc_updates[skey] = n
            if n > 16:
                # cache thrash: lanes disagree about the bytes at this rip
                self._fallback_step(view, lane)
                continue
            try:
                window = view.virt_read(lane, rip, 15)
                pfn0 = view.translate(lane, rip) >> PAGE_SHIFT
            except HostFault:
                view.r["ctr"][lane, CTR_MEM_FAULT] += np.uint32(1)
                view.set_status(lane, StatusCode.PAGE_FAULT)
                continue
            uop = decode(window, rip)
            try:
                pfn1 = view.translate(
                    lane, rip + max(uop.length - 1, 0)) >> PAGE_SHIFT
            except HostFault:
                pfn1 = pfn0
            self.cache.update(rip, uop, pfn0, pfn1, tenant=skey[0])
            self.stats["smc_updates"] += 1
            view.set_status(lane, StatusCode.RUNNING)

    def _fallback_step(self, view: HostView, lane: int) -> None:
        """Single-step one lane on the EmuCpu oracle."""
        self.stats["fallbacks"] += 1
        uop = self.cache.uop_at(view.get_rip(lane), self.tenant_of(lane))
        opclass = (_OPC_NAMES.get(uop.opc, f"opc{uop.opc}")
                   if uop is not None else "undecoded")
        by_class = self.stats["fallbacks_by_opclass"]
        by_class[opclass] = by_class.get(opclass, 0) + 1
        cpu_state = _lane_cpu_state(view, lane, self.cpu0_of(lane))
        emu = EmuCpu(_FallbackMem(view, lane), cpu_state)
        icount_before = int(view.r["icount"][lane])
        emu.icount = icount_before
        emu.rdrand_state = int(view.r["rdrand"][lane])
        try:
            emu.step()
        except GuestCrash:
            view.set_status(lane, StatusCode.CRASH)
            view.r["fault_gva"][lane] = np.uint64(emu.rip & MASK64)
            return
        except MemFault as e:
            view.r["ctr"][lane, CTR_MEM_FAULT] += np.uint32(1)
            view.set_status(lane, StatusCode.PAGE_FAULT)
            view.r["fault_gva"][lane] = np.uint64(e.gva & MASK64)
            view.r["fault_write"][lane] = np.int32(1 if e.write else 0)
            return
        except DivideError:
            view.set_status(lane, StatusCode.DIVIDE_ERROR)
            return
        except UnsupportedInsn as e:
            self.lane_errors[lane] = str(e)
            view.set_status(lane, StatusCode.HARD_ERROR)
            return
        _writeback_lane(view, lane, emu)
        view.r["icount"][lane] = np.uint64(emu.icount)
        # keep CTR_INSTR == icount: every oracle-retired instruction lands
        # in the device counter block
        view.r["ctr"][lane, CTR_INSTR] += np.uint32(emu.icount - icount_before)
        view.r["rdrand"][lane] = np.uint64(emu.rdrand_state)
        view.r["bp_skip"][lane] = np.int32(0)
        if emu.cr3_event is not None \
                and emu.cr3_event != self.cpu0_of(lane).cr3:
            view.set_status(lane, StatusCode.CR3_CHANGE)
        elif self.limit and emu.icount >= self.limit:
            view.set_status(lane, StatusCode.TIMEDOUT)
        else:
            view.set_status(lane, StatusCode.RUNNING)

    # Opcode classes only the oracle executes (in both packages); the
    # burst below may run ahead through these
    _ORACLE_OPCS = frozenset((
        U.OPC_SSECVT, U.OPC_PCLMUL, U.OPC_STACKSTR, U.OPC_IRET,
    ))
    _X87_ORACLE_SUBS = frozenset((
        U.X87_FXSAVE, U.X87_FXRSTOR, U.X87_XSAVE, U.X87_XRSTOR,
    ))
    _BRANCH_OPCS = frozenset((U.OPC_JMP, U.OPC_JCC, U.OPC_CALL, U.OPC_RET))
    _COMMITTED_STATUSES = frozenset((
        StatusCode.RUNNING, StatusCode.TIMEDOUT, StatusCode.CR3_CHANGE))

    def _entry_at(self, view: HostView, lane: int, rip: int):
        """(uop-table entry index, uop) at `rip`, publishing the decode on
        a miss; None when the bytes can't be fetched or don't decode."""
        tenant = self.tenant_of(lane)
        uop = self.cache.uop_at(rip, tenant)
        if uop is None:
            try:
                window = view.virt_read(lane, rip, 15)
                pfn0 = view.translate(lane, rip) >> PAGE_SHIFT
            except HostFault:
                return None
            uop = decode(window, rip)
            if uop.opc == U.OPC_INVALID:
                return None
            try:
                pfn1 = view.translate(
                    lane, rip + max(uop.length - 1, 0)) >> PAGE_SHIFT
            except HostFault:
                pfn1 = pfn0
            self.cache.add(rip, uop, pfn0, pfn1, tenant=tenant)
        return self.cache.entry_index(rip, tenant), uop

    def _is_oracle_uop(self, uop) -> bool:
        return (uop.opc in self._ORACLE_OPCS
                or (uop.opc == U.OPC_X87
                    and uop.sub in self._X87_ORACLE_SUBS))

    def _fallback_burst(self, view: HostView, lane: int) -> None:
        """Service an UNSUPPORTED lane; a lane that needed the oracle for
        consecutive rounds keeps stepping host-side (the JAX runner's
        burst, with its coverage/edge parity bookkeeping)."""
        self._fallback_step(view, lane)
        streak = self._fallback_streak.get(lane, 0) + 1
        self._fallback_streak[lane] = streak
        if streak < 2:
            return
        budget = min(32 << min(streak, 6), 1024)
        any_budget = 24 if (streak >= 4 and self.burst_any_tier) else 0
        ebits = self.machine.edge.shape[1] * 32
        from wtf_tpu_torch.utils.hashing import mix64

        while budget > 0:
            if view.get_status(lane) != StatusCode.RUNNING:
                return
            rip = view.get_rip(lane)
            if self.cache.has_breakpoint(rip, self.tenant_of(lane)):
                return
            entry = self._entry_at(view, lane, rip)
            if entry is None:
                return
            idx, uop = entry
            if not self._is_oracle_uop(uop):
                if any_budget <= 0:
                    return
                any_budget -= 1
            self._fallback_step(view, lane)
            self._pending_cov.append((lane, idx))
            if (uop.opc in self._BRANCH_OPCS
                    and view.get_status(lane) in self._COMMITTED_STATUSES):
                eh = mix64(rip) ^ view.get_rip(lane)
                self._pending_edge.append((lane, eh & (ebits - 1)))
            self.stats["fallback_burst_steps"] += 1
            budget -= 1

    def _service_exception(self, view: HostView, lane: int) -> bool:
        """Vector a faulted lane through the guest IDT; returns whether the
        exception was delivered (the lane then resumes RUNNING)."""
        status = view.get_status(lane)
        ctx = _LaneCtx(view, lane, self.cpu0_of(lane))
        try:
            if status == StatusCode.PAGE_FAULT:
                gva = int(view.r["fault_gva"][lane])
                write = bool(view.r["fault_write"][lane])

                def reads(g):
                    try:
                        view.translate(lane, g, write=False)
                        return True
                    except HostFault:
                        return False

                deliver_page_fault(ctx, gva, write, reads)
            elif status == StatusCode.DIVIDE_ERROR:
                deliver_exception(ctx, VEC_DE)
            else:
                return False
        except (DeliveryFailed, HostFault) as e:
            self.lane_errors.setdefault(lane, f"undelivered exception: {e}")
            return False
        self.stats["exceptions_delivered"] += 1
        view.set_status(lane, StatusCode.RUNNING)
        return True

    # -- the fused fast path (interp/pstep.py) -----------------------------
    def _fused_dispatch(self, tab, spans) -> None:
        """One fused 'chunk': `fused_rounds` pairs of (fused kernel for up
        to fused_k hot steps) -> (the precise resume leg for the lanes it
        parked).  Stops early once no lane is RUNNING."""
        m = self.machine
        sup = self.supervisor
        for _ in range(max(self.fused_rounds, 1)):
            with spans.span("fused-step") as sp:
                sup.dispatch("fused", self._k1, tab, steps=self.fused_k,
                             sync=_status)
                sp.fence(m.status)
            with spans.span("device-step") as sp:
                sup.dispatch("fused-resume", self._resume_leg, tab,
                             steps=self.fused_resume_steps, sync=_status)
                sp.fence(m.status)
            if not bool((m.status == int(StatusCode.RUNNING)).any()):
                break

    def _k1(self, tab) -> Machine:
        pstep.fused_step(tab, self.image, self.machine, self.limit,
                         self.fused_k)
        return self.machine

    def _resume_leg(self, tab) -> Machine:
        pstep.fused_resume(tab, self.image, self.machine, self.limit,
                           self.fused_resume_steps)
        return self.machine

    def _chunk(self, tab, size: int) -> Machine:
        run_steps(tab, self.image, self.machine, self.limit, size)
        return self.machine

    # -- run loop ----------------------------------------------------------
    def run(self, bp_handler: Optional[Callable[["Runner", HostView, int],
                                                None]] = None,
            max_chunks: int = 1 << 20) -> np.ndarray:
        """Drive the batch until every lane reaches a terminal status;
        `bp_handler(runner, view, lane)` services BREAKPOINT lanes.
        Returns the final status array."""
        tab = self.device_tab()
        self._chunk_level = 0
        self._fallback_streak = {}
        spans = self.registry.spans
        undeliverable: Set[int] = set()
        fault_statuses = (int(StatusCode.PAGE_FAULT),
                          int(StatusCode.DIVIDE_ERROR))
        for _ in range(max_chunks):
            if self.fused_enabled:
                self._fused_dispatch(tab, spans)
            else:
                size = (self._chunk_sizes[self._chunk_level]
                        if self.adaptive_chunks else self.chunk_steps)
                self.stats["max_chunk_steps"] = max(
                    self.stats["max_chunk_steps"], size)
                with spans.span("device-step") as sp:
                    self.supervisor.dispatch("chunk", self._chunk, tab,
                                             size, steps=size, sync=_status)
                    sp.fence(self.machine.status)
            self.stats["chunks"] += 1
            status = self.machine.status.cpu().numpy()
            running = status == int(StatusCode.RUNNING)
            need = {
                int(StatusCode.NEED_DECODE): [],
                int(StatusCode.SMC): [],
                int(StatusCode.UNSUPPORTED): [],
                int(StatusCode.BREAKPOINT): [],
            }
            if self.deliver_exceptions:
                need[int(StatusCode.PAGE_FAULT)] = []
                need[int(StatusCode.DIVIDE_ERROR)] = []
            for lane in np.nonzero(np.isin(status, list(need)))[0]:
                if int(lane) in undeliverable:
                    continue
                if (int(status[lane]) in fault_statuses
                        and not self._deliver_lane(int(lane))):
                    # heterogeneous batch: this lane's tenant has no IDT,
                    # so its faults are terminal, as in a solo campaign
                    undeliverable.add(int(lane))
                    continue
                need[int(status[lane])].append(int(lane))
            total = sum(len(v) for v in need.values())
            if total == 0:
                if not running.any():
                    return status
                if (self.adaptive_chunks
                        and self._chunk_level < len(self._chunk_sizes) - 1):
                    self._chunk_level += 1
                continue
            # broad servicing (decode misses, SMC, breakpoints) drops back
            # to fine-grained chunks; oracle/fault-only rounds keep growing
            broad = bool(need[int(StatusCode.NEED_DECODE)]
                         or need[int(StatusCode.SMC)]
                         or need[int(StatusCode.BREAKPOINT)])
            if broad:
                self._chunk_level = 0
            elif (self.adaptive_chunks
                    and self._chunk_level < len(self._chunk_sizes) - 1):
                self._chunk_level += 1
            unsup_lanes = need[int(StatusCode.UNSUPPORTED)]
            self._fallback_streak = {
                lane: self._fallback_streak.get(lane, 0)
                for lane in unsup_lanes}

            with spans.span("service-pull"):
                view = self.view()
            if need[int(StatusCode.NEED_DECODE)] or need[int(StatusCode.SMC)]:
                with spans.span("service-decode"):
                    if need[int(StatusCode.NEED_DECODE)]:
                        self._service_decode(
                            view, need[int(StatusCode.NEED_DECODE)])
                    if need[int(StatusCode.SMC)]:
                        self._service_smc(view, need[int(StatusCode.SMC)])
            if unsup_lanes:
                with spans.span("oracle-fallback"):
                    for lane in unsup_lanes:
                        self._fallback_burst(view, lane)
            for lane in (need.get(int(StatusCode.PAGE_FAULT), [])
                         + need.get(int(StatusCode.DIVIDE_ERROR), [])):
                if not self._service_exception(view, lane):
                    undeliverable.add(lane)
            for lane in need[int(StatusCode.BREAKPOINT)]:
                self.stats["bp_dispatches"] += 1
                if bp_handler is None:
                    self.lane_errors[lane] = (
                        f"breakpoint @ {view.get_rip(lane):#x} with no "
                        f"handler")
                    view.set_status(lane, StatusCode.CRASH)
                    continue
                rip_before = view.get_rip(lane)
                bp_handler(self, view, lane)
                if view.get_status(lane) == StatusCode.BREAKPOINT:
                    # resume: suppress the bp for one step only if the
                    # handler left rip in place
                    if view.get_rip(lane) == rip_before:
                        view.r["bp_skip"][lane] = np.int32(1)
                    view.set_status(lane, StatusCode.RUNNING)
            with spans.span("service-push"):
                self.push(view)
                tab = self.device_tab()
        # max_chunks exhausted: revoke the lanes still making progress as
        # TIMEDOUT (their coverage is excluded from the merge)
        status = self.machine.status.cpu().numpy()
        nonterminal = [int(StatusCode.RUNNING), int(StatusCode.NEED_DECODE),
                       int(StatusCode.SMC), int(StatusCode.UNSUPPORTED),
                       int(StatusCode.BREAKPOINT), int(StatusCode.NEEDS_XLA)]
        if self.deliver_exceptions:
            nonterminal += list(fault_statuses)
        stuck = [int(lane)
                 for lane in np.nonzero(np.isin(status, nonterminal))[0]
                 if int(lane) not in undeliverable
                 and not (int(status[lane]) in fault_statuses
                          and not self._deliver_lane(int(lane)))]
        if stuck:
            view = self.view()
            for lane in stuck:
                self.lane_errors.setdefault(
                    lane, f"revoked: exceeded max_chunks={max_chunks}")
                view.set_status(lane, StatusCode.TIMEDOUT)
            self.push(view)
            self.registry.counter("runner.max_chunks_timeouts").inc(
                len(stuck))
            self.events.emit("timeout", kind="max-chunks", lanes=stuck,
                             chunks=max_chunks)
        return self.machine.status.cpu().numpy()

    def restore(self) -> None:
        """Every lane back to the snapshot: O(1) overlay reset + register
        copy, in place."""
        with self.registry.spans.span("overlay-restore") as sp:
            machine_restore(self.machine, self.template)
            sp.fence(self.machine.status)
        self.lane_errors.clear()
        self._pending_cov.clear()
        self._pending_edge.clear()
        self._smc_updates.clear()

    def statuses(self) -> np.ndarray:
        return self.machine.status.cpu().numpy()

    # -- device-side telemetry counters ------------------------------------
    def device_counters(self) -> np.ndarray:
        """The per-lane counter block (uint32[L, N_CTRS])."""
        return self.machine.ctr.cpu().numpy().view(np.uint32)

    def fold_counter_totals(self, totals) -> None:
        reg = self.registry
        reg.counter("device.instructions").inc(int(totals[CTR_INSTR]))
        reg.counter("device.mem_faults").inc(int(totals[CTR_MEM_FAULT]))
        reg.counter("device.decode_misses").inc(int(totals[CTR_DECODE_MISS]))
        reg.counter("device.fused_steps").inc(int(totals[CTR_FUSED]))
        reg.counter("device.fused_park_subset").inc(
            int(totals[CTR_PARK_SUBSET]))
        reg.counter("device.fused_park_mem").inc(int(totals[CTR_PARK_MEM]))

    def fold_device_counters(self) -> np.ndarray:
        """Pull the counter block once per batch and add the batch totals
        into the registry (`device.*`); returns the per-lane block."""
        ctr = self.device_counters()
        self.fold_counter_totals(ctr.sum(axis=0, dtype=np.uint64))
        return ctr

