"""GpuBackend: the batched device interpreter behind the Backend contract.

The counterpart of wtf_tpu/backend/tpu.py `TpuBackend`.  One testcase per
device lane per `run_batch()`; the single-testcase `run()` facade (lane 0)
keeps the reference's `Backend_t` calling convention for the `run`
subcommand and harness code.

Lane binding: register/memory accessors act on the backend's *current*
lane; during insertion and breakpoint dispatch the backend is bound to the
lane being serviced, so unmodified target modules work per lane.

Coverage: per-lane device bitmaps merge into device-resident aggregate
bitmaps after each batch (meshrun/reduce.py); timeout and OVERLAY_FULL
lanes are excluded from the merge, as the reference client revokes a
timeout's coverage (client.cc:122-125).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from wtf_tpu_torch import telemetry
from wtf_tpu_torch.backend.base import Backend, BreakpointHandler
from wtf_tpu_torch.core.results import (
    Cr3Change, Crash, Ok, OverlayFull, StatusCode, TestcaseResult, Timedout,
)
from wtf_tpu_torch.interp.runner import HostView, Runner
from wtf_tpu_torch.meshrun.reduce import merge_coverage
from wtf_tpu_torch.snapshot.loader import Snapshot
from wtf_tpu_torch.telemetry import Registry, StatsDict
from wtf_tpu_torch.utils.hashing import splitmix64

MASK64 = (1 << 64) - 1


class GpuBackend(Backend):
    def __init__(self, snapshot: Snapshot, n_lanes: int = 64,
                 limit: int = 0, registry: Optional[Registry] = None,
                 events=None, **runner_kwargs):
        self.snapshot = snapshot
        self.symbols = snapshot.symbols
        self.n_lanes = n_lanes
        self.limit = limit
        self.registry, self.events = telemetry.resolve(
            registry=registry, events=events)
        self._runner_kwargs = runner_kwargs
        self.runner: Optional[Runner] = None
        self.breakpoints: Dict[int, BreakpointHandler] = {}
        self._view: Optional[HostView] = None
        self._lane = 0
        self._lane_results: Dict[int, TestcaseResult] = {}
        self._agg_cov = None
        self._agg_edge = None
        self._new_lane = np.zeros(n_lanes, dtype=bool)
        self._last_new_words: Optional[np.ndarray] = None
        self._trace_request = None
        self.stats = StatsDict(self.registry, "backend",
                               fields=("batches", "testcases",
                                       "instructions"))
        # final status of every active lane of every batch, by name
        self.status_counts: Dict[str, int] = {}

    # -- lifecycle ---------------------------------------------------------
    def initialize(self) -> None:
        self.runner = Runner(self.snapshot, self.n_lanes,
                             registry=self.registry, events=self.events,
                             **self._runner_kwargs)
        m = self.runner.machine
        self._agg_cov = torch.zeros_like(m.cov[0])
        self._agg_edge = torch.zeros_like(m.edge[0])

    # -- lane binding ------------------------------------------------------
    @contextmanager
    def _bound(self, view: HostView, lane: int):
        old = (self._view, self._lane)
        self._view, self._lane = view, lane
        try:
            yield
        finally:
            self._view, self._lane = old

    def _ensure_view(self) -> HostView:
        if self._view is None:
            self._view = self.runner.view()
        return self._view

    # -- batch execution ---------------------------------------------------
    def run_batch(self, insert: Optional[Sequence] = None,
                  target=None) -> List[TestcaseResult]:
        """Run a batch of testcases (one per lane; lists longer than
        n_lanes run as several device rounds with a restore in between;
        shorter lists leave trailing lanes idle)."""
        if insert is not None and len(insert) > self.n_lanes:
            results: List[TestcaseResult] = []
            flags: List[bool] = []
            for start in range(0, len(insert), self.n_lanes):
                if start > 0:
                    target.restore()
                    self.restore()
                chunk = insert[start:start + self.n_lanes]
                results.extend(self.run_batch(chunk, target))
                flags.extend(self._new_lane[:len(chunk)])
            self._new_lane = np.array(flags)
            return results
        runner = self.runner
        runner.limit = self.limit
        self._lane_results = {}
        with self.registry.spans.span("insert"):
            view = self._ensure_view()
            n_active = self.n_lanes
            if insert is not None:
                n_active = len(insert)
                for lane, data in enumerate(insert):
                    with self._bound(view, lane):
                        target.insert_testcase(self, data)
                for lane in range(n_active, self.n_lanes):
                    view.set_status(lane, StatusCode.OK)  # idle lanes
            runner.push(view)
            self._view = None
        statuses = runner.run(bp_handler=self._dispatch_bp)
        self._finish_batch(statuses, n_active)
        return [self._map_result(lane, statuses[lane])
                for lane in range(n_active)]

    def _finish_batch(self, statuses, n_active: int) -> None:
        """Post-run accounting: the coverage merge on the device (timeouts
        and OVERLAY_FULL lanes excluded — the latter ran on truncated
        memory), backend counters, the once-per-batch counter fold."""
        runner = self.runner
        with self.registry.spans.span("cov-readback") as sp:
            m = runner.machine
            keep = ((statuses != int(StatusCode.TIMEDOUT))
                    & (statuses != int(StatusCode.OVERLAY_FULL))
                    & (np.arange(self.n_lanes) < n_active))
            self._merge(m, keep)
            for code in statuses[:n_active]:
                name = StatusCode(int(code)).name
                self.status_counts[name] = self.status_counts.get(name, 0) + 1
            self.stats["batches"] += 1
            self.stats["testcases"] += n_active
            self.stats["instructions"] += int(
                m.icount[:n_active].sum().item())
            runner.fold_device_counters()
            sp.fence(self._agg_cov)

    def _merge(self, m, keep: np.ndarray) -> None:
        include = torch.from_numpy(keep).to(m.device)
        (self._agg_cov, self._agg_edge, new_lane,
         new_words) = merge_coverage(self._agg_cov, self._agg_edge, m.cov,
                                     m.edge, include)
        self._new_lane = new_lane.cpu().numpy()
        self._last_new_words = new_words.cpu().numpy().view(np.uint32)

    def lane_found_new_coverage(self, lane: int) -> bool:
        return bool(self._new_lane[lane])

    def lane_coverage(self, lane: int) -> Set[int]:
        """This lane's executed-RIP set from its device bitmap (valid after
        run_batch, before restore)."""
        words = self.runner.machine.cov[lane].cpu().numpy().view(np.uint32)
        return set(self.runner.cache.rips_of_bits(words))

    def lane_result_detail(self, lane: int) -> str:
        return self.runner.lane_errors.get(lane, "")

    def _dispatch_bp(self, runner: Runner, view: HostView, lane: int) -> None:
        rip = view.get_rip(lane)
        handler = self.breakpoints.get(rip)
        if handler is None:
            runner.lane_errors[lane] = f"unexpected breakpoint @ {rip:#x}"
            view.set_status(lane, StatusCode.HARD_ERROR)
            return
        with self._bound(view, lane):
            handler(self)
            if lane in self._lane_results:
                # handler called stop(): park the lane terminally
                view.set_status(lane, _result_status(self._lane_results[lane]))

    def _result_from_fields(self, status: StatusCode, gva: int, write: int,
                            rip: int, detail: str) -> TestcaseResult:
        """Terminal status + crash-naming fields -> TestcaseResult (the JAX
        backend's naming, bit for bit)."""
        if status == StatusCode.OK:
            return Ok()
        if status == StatusCode.TIMEDOUT:
            return Timedout()
        if status == StatusCode.CR3_CHANGE:
            return Cr3Change()
        if status == StatusCode.CRASH:
            return Crash(f"crash-int-{gva:#x}")
        if status == StatusCode.PAGE_FAULT:
            if gva == rip and not write:
                kind = "execute"  # fetch-address fault
            else:
                kind = "write" if write else "read"
            return Crash(f"crash-{kind}-{gva:#x}")
        if status == StatusCode.DIVIDE_ERROR:
            return Crash(f"crash-de-{rip:#x}")
        if status == StatusCode.OVERLAY_FULL:
            return OverlayFull()
        if status == StatusCode.HARD_ERROR:
            return Crash(f"crash-{detail.split()[0]}")
        raise AssertionError(f"unmapped terminal status {status!r}")

    def _map_result(self, lane: int, status_val: int) -> TestcaseResult:
        if lane in self._lane_results:
            return self._lane_results[lane]
        status = StatusCode(int(status_val))
        if status in (StatusCode.OK, StatusCode.TIMEDOUT,
                      StatusCode.CR3_CHANGE):
            return self._result_from_fields(status, 0, 0, 0, "")
        m = self.runner.machine
        return self._result_from_fields(
            status,
            int(m.fault_gva[lane].item()) & MASK64,
            int(m.fault_write[lane].item()),
            int(m.rip[lane].item()) & MASK64,
            self.runner.lane_errors.get(lane, "hard-error"))

    # -- Backend facade (single testcase == lane 0) ------------------------
    def run(self) -> TestcaseResult:
        if self._trace_request is not None:
            return self._run_traced()
        view = self._ensure_view()
        for lane in range(1, self.n_lanes):
            view.set_status(lane, StatusCode.OK)
        runner = self.runner
        runner.limit = self.limit
        self._lane_results = {}
        runner.push(view)
        self._view = None
        statuses = runner.run(bp_handler=self._dispatch_bp)
        m = runner.machine
        keep = ((statuses != int(StatusCode.TIMEDOUT))
                & (statuses != int(StatusCode.OVERLAY_FULL))
                & (np.arange(self.n_lanes) == 0))
        self._merge(m, keep)
        self.stats["batches"] += 1
        self.stats["testcases"] += 1
        self.stats["instructions"] += int(m.icount[0].item())
        runner.fold_device_counters()
        return self._map_result(0, statuses[0])

    def _run_traced(self) -> TestcaseResult:
        """rip/cov/tenet traces run on the oracle for exact per-step
        ordering (the reference's rip traces are bochscpu-only the same
        way); device state is untouched."""
        from wtf_tpu_torch.backend.emu import EmuBackend

        path, trace_type = self._trace_request
        self._trace_request = None
        emu = EmuBackend(self.snapshot, limit=self.limit)
        emu.initialize()
        emu.breakpoints = dict(self.breakpoints)
        view = self._ensure_view()
        for (lane, pfn), page in sorted(view.pending.items()):
            if lane == 0:
                emu.cpu.mem.phys_write(pfn << 12, bytes(page))
        cpu = emu.cpu
        cpu.gpr = [int(v) for v in view.r["gpr"][0]]
        cpu.rip = int(view.r["rip"][0])
        cpu.rflags = int(view.r["rflags"][0])
        for name in ("fs_base", "gs_base", "kernel_gs_base", "cr0", "cr2",
                     "cr3", "cr4", "cr8", "lstar", "star", "sfmask", "efer",
                     "tsc", "fpcw", "fpsw", "fptw", "mxcsr"):
            setattr(cpu, name, int(view.r[name][0]))
        cpu.cs_sel = int(view.r["cs"][0])
        cpu.ss_sel = int(view.r["ss"][0])
        cpu.fpst = [int(v) for v in view.r["fpst"][0]]
        cpu.fptop = (int(view.r["fpsw"][0]) >> 11) & 7
        for i in range(16):
            cpu.xmm[i][0] = int(view.r["xmm"][0, i, 0])
            cpu.xmm[i][1] = int(view.r["xmm"][0, i, 1])
            cpu.ymmh[i][0] = int(view.r["xmm"][0, i, 2])
            cpu.ymmh[i][1] = int(view.r["xmm"][0, i, 3])
        cpu.icount = int(view.r["icount"][0])
        cpu.rdrand_state = int(view.r["rdrand"][0])
        self._view = None
        emu.set_trace_file(path, trace_type)
        return emu.run()

    def restore(self) -> None:
        self._view = None
        self.runner.restore()

    def stop(self, result: TestcaseResult) -> None:
        self._lane_results[self._lane] = result

    # -- registers / memory (current lane) ---------------------------------
    @property
    def current_lane(self) -> int:
        return self._lane

    def get_reg(self, idx: int) -> int:
        return self._ensure_view().get_reg(self._lane, idx)

    def set_reg(self, idx: int, value: int) -> None:
        self._ensure_view().set_reg(self._lane, idx, value)

    def get_rip(self) -> int:
        return self._ensure_view().get_rip(self._lane)

    def set_rip(self, value: int) -> None:
        self._ensure_view().set_rip(self._lane, value)

    def get_rflags(self) -> int:
        return int(self._ensure_view().r["rflags"][self._lane])

    def get_icount(self) -> int:
        return int(self._ensure_view().r["icount"][self._lane])

    def virt_translate(self, gva: int, write: bool = False) -> int:
        return self._ensure_view().translate(self._lane, gva, write)

    def inject_exception(self, vector: int, error_code: int = 0,
                         cr2: Optional[int] = None) -> None:
        from wtf_tpu_torch.cpu.interrupts import deliver_exception
        from wtf_tpu_torch.interp.runner import _LaneCtx

        ctx = _LaneCtx(self._ensure_view(), self._lane,
                       self.runner.cpu0_of(self._lane))
        deliver_exception(ctx, vector, error_code, cr2)

    def virt_read(self, gva: int, size: int) -> bytes:
        return self._ensure_view().virt_read(self._lane, gva, size)

    def virt_write(self, gva: int, data: bytes) -> None:
        self._ensure_view().virt_write(self._lane, gva, data)

    # -- breakpoints -------------------------------------------------------
    def set_breakpoint(self, gva: int, handler: BreakpointHandler) -> None:
        self.breakpoints[gva] = handler
        self.runner.cache.set_breakpoint(gva)

    # -- coverage ----------------------------------------------------------
    def last_new_coverage(self) -> Set[int]:
        if self._last_new_words is None:
            return set()
        return set(self.runner.cache.rips_of_bits(self._last_new_words))

    def aggregate_coverage(self) -> Set[int]:
        """All RIPs covered so far this campaign."""
        words = self._agg_cov.cpu().numpy().view(np.uint32)
        return set(self.runner.cache.rips_of_bits(words))

    def revoke_last_new_coverage(self) -> None:
        if self._last_new_words is not None:
            words = torch.from_numpy(
                self._last_new_words.view(np.int32)).to(self._agg_cov.device)
            self._agg_cov = self._agg_cov & ~words
            self._last_new_words = None

    # -- misc ---------------------------------------------------------------
    def rdrand(self) -> int:
        view = self._ensure_view()
        nxt = splitmix64(int(view.r["rdrand"][self._lane]))
        view.r["rdrand"][self._lane] = np.uint64(nxt)
        return nxt

    def set_trace_file(self, path, trace_type: str) -> None:
        if trace_type in ("rip", "cov", "tenet"):
            self._trace_request = (path, trace_type)
        else:
            raise ValueError(f"unsupported trace type {trace_type!r}")

    def print_run_stats(self) -> None:
        s = self.runner.stats
        from wtf_tpu_torch.utils.human import number_to_human as h

        print(f"[gpu] device={self.runner.device} lanes={self.n_lanes} "
              f"testcases={h(self.stats['testcases'])} "
              f"batches={self.stats['batches']} "
              f"instructions={h(self.stats['instructions'])} "
              f"chunks={s['chunks']} decodes={s['decodes']} "
              f"fallbacks={s['fallbacks']} "
              f"smc={s['smc_updates']} bp_dispatches={s['bp_dispatches']}")
        fused = self.registry.counter("device.fused_steps").value
        if fused or self.runner.fused_enabled:
            instr = max(self.registry.counter("device.instructions").value, 1)
            ps = self.registry.counter("device.fused_park_subset").value
            pm = self.registry.counter("device.fused_park_mem").value
            print(f"[gpu] fused steps: {h(fused)} "
                  f"({fused / instr:.1%} of instructions in-kernel; "
                  f"parks: subset={h(ps)} mem={h(pm)})")
        by_class = s.get("fallbacks_by_opclass", {})
        if by_class:
            top = ", ".join(
                f"{name}={count}" for name, count in sorted(
                    by_class.items(), key=lambda kv: -kv[1])[:10])
            print(f"[gpu] fallbacks by opclass: {top}")


def _result_status(result: TestcaseResult) -> StatusCode:
    if isinstance(result, Ok):
        return StatusCode.OK
    if isinstance(result, Timedout):
        return StatusCode.TIMEDOUT
    if isinstance(result, Cr3Change):
        return StatusCode.CR3_CHANGE
    if isinstance(result, OverlayFull):
        return StatusCode.OVERLAY_FULL
    return StatusCode.CRASH
