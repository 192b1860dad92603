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

Device-generated batches (wtf_tpu_torch/devmut) run through
`run_batch_device`, and whole multi-batch windows through
`run_megachunk` (wtf_tpu_torch/fuzz/megachunk.py); with device decode the
window's published decode entries are adopted into the host cache at
harvest (`_harvest_device_decode`).

Supervision (wtf_tpu_torch/supervise): the backend owns the Supervisor
and hands it to every Runner it builds, a recovery's rebuilt one
included; the integrity gate runs before every harvest, and lanes in
quarantine are parked idle at insert and kept out of the coverage merge.
`coverage_state` / `restore_coverage_state` are the coverage half of a
campaign checkpoint (wtf_tpu_torch/resume).
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
from wtf_tpu_torch.interp.machine import CTR_INSTR
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
        # the supervisor outlives the Runner it guards: initialize() hands
        # it to every (re)built Runner, so dispatch indices, ladder state
        # and the quarantine set survive recovery rebuilds
        from wtf_tpu_torch.supervise import Supervisor

        self.supervisor = Supervisor(
            registry=self.registry, events=self.events,
            enabled=bool(runner_kwargs.pop("supervise", False)),
            dispatch_timeout=float(
                runner_kwargs.pop("dispatch_timeout", 0.0) or 0.0),
            promote_after=int(runner_kwargs.pop("promote_after", 8)),
            max_batch_retries=int(
                runner_kwargs.pop("max_batch_retries", 4)),
            quarantine_threshold=int(
                runner_kwargs.pop("quarantine_threshold", 3)))
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
                             supervisor=self.supervisor,
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
                quarantined = runner.supervisor.quarantined
                for lane, data in enumerate(insert):
                    if lane in quarantined:
                        # a poisoned lane parked idle: no insert, terminal
                        # status, and _finish_batch's include mask keeps
                        # it out of the coverage merge
                        view.set_status(lane, StatusCode.OK)
                        continue
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

    def run_batch_device(self, mutator, target) -> List[TestcaseResult]:
        """One batch whose testcases were generated on the device
        (wtf_tpu_torch/devmut): insertion is one batched overlay/register
        update (Runner.device_insert) instead of per-lane
        target.insert_testcase calls.  `mutator` is a bound
        DevMangleMutator whose take_batch() already ran; every lane is
        active."""
        words, lens = mutator.current_batch()
        return self.run_batch_words(words, lens, mutator.pfns, mutator.spec)

    def run_batch_words(self, words, lens, pfns,
                        spec) -> List[TestcaseResult]:
        """The device-generated batch path: `words` (int32[L, W]) /
        `lens` (int32[L]) land in every lane's overlay through
        Runner.device_insert and the batch runs with every lane active.
        `spec` is the target's DeviceInsertSpec, `pfns` the input region's
        page frames."""
        runner = self.runner
        runner.limit = self.limit
        self._lane_results = {}
        spans = self.registry.spans
        with spans.span("insert"):
            # host state staged through the backend view (init-time
            # register/memory writes) lands first, so the testcase wins
            # any overlap
            if self._view is not None:
                runner.push(self._view)
                self._view = None
            qmask = runner.supervisor.quarantine_mask()
            with spans.span("device") as sp:
                runner.device_insert(words, lens, pfns, spec.gva,
                                     spec.len_gpr, spec.ptr_gpr)
                if qmask is not None:
                    # park the quarantined lanes terminal so the run loop
                    # never steps them (the port inserts every lane: the
                    # masked insert arrives with tenancy)
                    from wtf_tpu_torch.supervise import integrity

                    integrity.mask_idle(runner.machine, qmask)
                sp.fence(runner.machine.status)
        statuses = runner.run(bp_handler=self._dispatch_bp)
        self._finish_batch(statuses, self.n_lanes)
        return [self._map_result(lane, statuses[lane])
                for lane in range(self.n_lanes)]

    def run_megachunk(self, mutator, target, max_batches: int,
                      n_batches: int):
        """ONE megachunk window (wtf_tpu_torch/fuzz/megachunk.py): up to
        `n_batches` whole fuzz batches — restore, devmut generation,
        insert, the quiesce, the finish-breakpoint rewrite and the
        coverage merge — on the device; the host touches the window only
        for the status pull and the crash/new-coverage harvest.
        `max_batches` sizes the window's per-batch outputs; `n_batches
        <= max_batches` is this window's budget (runs-budget capping).

        Returns a list of (results, new_flags, datas) per PROCESSED
        batch, in batch order: `results` the per-lane TestcaseResults,
        `new_flags` the prefix-credit new-coverage flags, `datas` the
        fetched bytes of crash/new-coverage lanes.  A batch that needed
        host servicing is finished through the ordinary Runner.run loop
        before being returned.

        There is no speculative launch of the next window: the machine
        is updated in place, so (as for the JAX package's donated
        window) a dropped speculation would have nothing to fall back
        to."""
        runner = self.runner
        if not self.limit:
            raise ValueError(
                "megachunk windows need a nonzero --limit: the window's "
                "quiesce stops on the instruction budget")
        runner.limit = self.limit
        self._lane_results = {}
        # host state staged through the backend view (init-time target
        # writes) must land BEFORE the window, like run_batch_words
        if self._view is not None:
            runner.push(self._view)
            self._view = None
        reg = self.registry
        reg.counter("megachunk.windows").inc()
        out = self._dispatch_window(mutator, max_batches, n_batches)
        self._agg_cov, self._agg_edge = out.agg_cov, out.agg_edge
        # integrity gate before the harvest and before the mutator cursor
        # advances: a LanePoisoned raise here leaves the window fully
        # replayable (consume_window not yet called)
        runner.supervisor.raise_if_poisoned(runner, "megachunk")
        # device-decode harvest: adopt the window's published entries into
        # the host cache BEFORE anything can service those rips again (the
        # incomplete path's Runner.run below rebuilds the device table
        # from the cache — rows left out would publish again at new
        # indices and shift the coverage-bit mapping)
        if runner.device_decode:
            self._harvest_device_decode(out)
        self._last_new_words = out.new_words.cpu().numpy().view(np.uint32)
        b_done, incomplete = out.batches, out.incomplete
        statuses = out.statuses[:b_done].cpu().numpy()
        flags = out.new_flags[:b_done].cpu().numpy()
        ctr_sums = out.ctr_sums[:b_done].cpu().numpy().view(np.uint64)
        # [precise sweeps, K1 launches] over the window; each K1 launch
        # updates the 13 machine/overlay planes in place instead of
        # copying them through (the JAX window's donation leg)
        sweeps, launches = out.engine_rounds
        reg.counter("device.fused_window_xla_steps").inc(sweeps)
        if launches:
            reg.counter("device.fused_window_rounds").inc(launches)
            reg.counter("device.fused_window_bytes_saved").inc(
                launches * self._fused_alias_bytes())
        processed = b_done + (1 if incomplete else 0)
        mutator.consume_window(processed)
        if runner.device_decode and not incomplete:
            # a complete window needed no host decode service; its length
            # is the batches it carried without coming up for it
            reg.counter("devdec.zero_host_windows").inc()
            reg.counter("devdec.zero_host_batches").inc(b_done)

        batches = []
        for b in range(b_done):
            row, frow = statuses[b], flags[b]
            runner.fold_counter_totals(ctr_sums[b])
            if b == b_done - 1 and not incomplete:
                # the live machine IS this batch's final state (the
                # window stops on any non-clean terminal), so crash
                # naming reads it exactly like run_batch's path
                results = [self._map_result(lane, row[lane])
                           for lane in range(self.n_lanes)]
            else:
                # interior batches are clean by the stop rule
                results = [self._result_from_fields(
                    StatusCode(int(row[lane])), 0, 0, 0, "")
                    for lane in range(self.n_lanes)]
            self._count_statuses(row)
            snap = out.cur if b == processed - 1 else out.prev
            datas = {}
            wanted = [lane for lane in range(self.n_lanes)
                      if frow[lane] or isinstance(results[lane], Crash)]
            if wanted:
                mutator.set_current(snap.words, snap.lens)
                datas = mutator.fetch(wanted)
            self._new_lane = frow
            self.stats["batches"] += 1
            self.stats["testcases"] += self.n_lanes
            self.stats["instructions"] += int(ctr_sums[b][CTR_INSTR])
            batches.append((results, frow, datas))

        if incomplete:
            # finish the in-flight batch through the ordinary servicing
            # loop (decode/SMC/oracle/breakpoints), then account it the
            # host way — this IS the batch-at-a-time path
            reg.counter("megachunk.incomplete_windows").inc()
            statuses_fin = runner.run(bp_handler=self._dispatch_bp)
            self._finish_batch(statuses_fin, self.n_lanes)
            results = [self._map_result(lane, statuses_fin[lane])
                       for lane in range(self.n_lanes)]
            frow = np.asarray(self._new_lane)
            mutator.set_current(out.cur.words, out.cur.lens)
            wanted = [lane for lane in range(self.n_lanes)
                      if frow[lane] or isinstance(results[lane], Crash)]
            datas = mutator.fetch(wanted) if wanted else {}
            batches.append((results, frow, datas))
        return batches

    def _dispatch_window(self, mutator, max_batches: int, n_batches: int):
        """Run one window on the live machine and aggregates."""
        from wtf_tpu_torch.fuzz.megachunk import NO_FINISH

        runner = self.runner
        spec = mutator.spec
        finish = spec.finish_gva if spec.finish_gva is not None \
            else NO_FINISH
        fn = runner.megachunk_callable(max_batches, spec.len_gpr,
                                       spec.ptr_gpr, mutator.rounds)
        slab_first, slab_rest = mutator.window_slabs()
        seeds = mutator.window_seeds(max_batches)
        slab_first, slab_rest, seeds = runner.megachunk_place(
            slab_first, slab_rest, seeds)
        pfns = torch.tensor(mutator.pfns, dtype=torch.int32,
                            device=runner.device)
        spans = self.registry.spans
        with spans.span("device") as sp:
            out = runner.supervisor.dispatch(
                "megachunk", fn, runner.device_tab(), runner.image,
                runner.machine, runner.template, slab_first, slab_rest,
                seeds, pfns, spec.gva, finish, self.limit, n_batches,
                self._agg_cov, self._agg_edge, spans,
                runner.devdec_operands(), window=n_batches,
                sync=lambda o: o.agg_cov)
            sp.fence(out.agg_cov)
        return out

    def _harvest_device_decode(self, out) -> int:
        """Adopt the window's device-published decode entries into the
        host cache (publish order kept: coverage bit i IS entry index i),
        the host decoder cross-checking each, and fold the service stats.
        Returns the number of adopted entries.  The cache's device copy
        is rebuilt from the host arrays at the next `device()` call, row
        for row the window's table."""
        cache = self.runner.cache
        reg = self.registry
        serviced, published, parked, rounds = out.dd_stats
        reg.counter("devdec.serviced_lanes").inc(serviced)
        reg.counter("devdec.published").inc(published)
        reg.counter("devdec.parked_lanes").inc(parked)
        reg.counter("devdec.service_rounds").inc(rounds)
        reg.counter("devdec.service_k1_rounds").inc(out.service_k1)
        start, new_count = cache.count, out.count
        if new_count < start:
            raise RuntimeError(
                f"device decode count went backwards: {new_count} < "
                f"host cache {start}")
        if new_count == start:
            return 0
        rows = (out.tab.rip[start:new_count].cpu().numpy(),
                out.tab.meta_i32[start:new_count].cpu().numpy(),
                out.tab.meta_u64[start:new_count].cpu().numpy())
        mismatches = cache.adopt_device_entries(*rows, start, new_count)
        reg.counter("devdec.crosscheck_mismatches").inc(mismatches)
        if mismatches:
            self.events.emit("devdec-mismatch",
                             entries=new_count - start,
                             mismatches=mismatches)
        return new_count - start

    def _fused_alias_bytes(self) -> int:
        """Bytes of the 13 machine/overlay planes the fused kernel updates
        in place — the per-launch copy-through that in-place planes
        avoid, dominated by the `[lanes, slots, words]` overlay data."""
        m = self.runner.machine
        ov = m.overlay
        planes = (m.gpr, m.rip, m.rflags, m.status, m.icount, m.bp_skip,
                  m.ctr, m.cov, m.edge, ov.pfn, ov.data, ov.valid,
                  ov.count)
        return int(sum(t.numel() * t.element_size() for t in planes))

    def _count_statuses(self, statuses) -> None:
        for code in statuses:
            name = StatusCode(int(code)).name
            self.status_counts[name] = self.status_counts.get(name, 0) + 1

    def _finish_batch(self, statuses, n_active: int) -> None:
        """Post-run accounting: the coverage merge on the device (timeouts
        and OVERLAY_FULL lanes excluded — the latter ran on truncated
        memory), backend counters, the once-per-batch counter fold."""
        runner = self.runner
        # integrity gate BEFORE anything consumes the machine: a poisoned
        # status would crash StatusCode() in result mapping, poisoned
        # planes would credit coverage.  Raises LanePoisoned (the fuzz
        # loop's supervision wrapper replays the batch); inert when the
        # supervisor is disabled.
        runner.supervisor.raise_if_poisoned(runner, "batch")
        qmask = runner.supervisor.quarantine_mask()
        with self.registry.spans.span("cov-readback") as sp:
            m = runner.machine
            keep = ((statuses != int(StatusCode.TIMEDOUT))
                    & (statuses != int(StatusCode.OVERLAY_FULL))
                    & (np.arange(self.n_lanes) < n_active))
            if qmask is not None:
                keep &= ~qmask  # quarantined lanes never credit coverage
            self._merge(m, keep)
            self._count_statuses(statuses[:n_active])
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

    # -- checkpoint/resume (wtf_tpu_torch/resume) --------------------------
    def coverage_state(self):
        """(cov words, edge words) aggregate bitmaps as host uint32 arrays
        — the coverage half of a campaign checkpoint, the same payload
        the JAX package writes (the device keeps them as int32).  Bit
        indices are decode-cache entry indices; the checkpoint carries
        the cache alongside (Runner.checkpoint_state)."""
        return (self._agg_cov.cpu().numpy().view(np.uint32).copy(),
                self._agg_edge.cpu().numpy().view(np.uint32).copy())

    def restore_coverage_state(self, cov: np.ndarray,
                               edge: np.ndarray) -> None:
        """Install checkpointed aggregate bitmaps (uint32 words) on the
        runner's device."""
        dev = self.runner.device
        self._agg_cov = torch.from_numpy(np.ascontiguousarray(
            cov, dtype=np.uint32).view(np.int32).copy()).to(dev)
        self._agg_edge = torch.from_numpy(np.ascontiguousarray(
            edge, dtype=np.uint32).view(np.int32).copy()).to(dev)

    def lane_found_new_coverage(self, lane: int) -> bool:
        return bool(self._new_lane[lane])

    def lane_coverage(self, lane: int) -> Set[int]:
        """This lane's executed-RIP set from its device bitmap (valid after
        run_batch, before restore)."""
        words = self.runner.machine.cov[lane].cpu().numpy().view(np.uint32)
        return set(self.runner.cache.rips_of_bits(words))

    def lane_cov_words(self, lane: int) -> np.ndarray:
        """This lane's coverage bitmap as host uint32 words (valid after
        run_batch, before restore), with no address decode: what the mux
        node's delta frames ship (wtf_tpu_torch/fleet/delta
        `BitmapDeltaCursor`), since bit i is decode-cache entry i.  Only
        the lane's row leaves the device, as a copy."""
        return (self.runner.machine.cov[lane].to("cpu", copy=True)
                .numpy().view(np.uint32))

    def lane_result_detail(self, lane: int) -> str:
        return self.runner.lane_errors.get(lane, "")

    def _bp_handler(self, lane: int, rip: int):
        """The handler armed at `rip` for `lane` (a multi-tenant backend,
        wtf_tpu_torch/tenancy, keys handlers by the lane's tenant)."""
        return self.breakpoints.get(rip)

    def _dispatch_bp(self, runner: Runner, view: HostView, lane: int) -> None:
        rip = view.get_rip(lane)
        handler = self._bp_handler(lane, rip)
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

    def get_xmm(self, idx: int) -> int:
        r = self._ensure_view().r["xmm"]
        return int(r[self._lane, idx, 0]) | (int(r[self._lane, idx, 1]) << 64)

    def set_xmm(self, idx: int, value: int) -> None:
        r = self._ensure_view().r["xmm"]
        r[self._lane, idx, 0] = np.uint64(value & MASK64)
        r[self._lane, idx, 1] = np.uint64((value >> 64) & MASK64)

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
