"""TenancyBackend: many campaigns behind one batched backend.

The counterpart of wtf_tpu/tenancy/backend.py.  A tenant table
(TenantSpec per campaign: name, target, snapshot, lane quota) turns the
GpuBackend into a SERVING backend: lane ranges belong to tenants, one
`run_batch_tenants` call executes a heterogeneous batch through the one
step engine (K1 and the precise step over a stacked image), and the
coverage merge splits into per-tenant bit-planes by lane-ID masks — each
tenant's new-coverage credit is computed against ITS aggregate with the
prefix scan restricted to ITS lanes (`merge_coverage` called once per
tenant with that tenant's aggregate and lane mask), so a tenant's results
are bit-identical to the same campaign run alone.  The single-image
paths keep GpuBackend's `_merge` and its one aggregate.

Breakpoints key by (tenant, gva): `tenant_context(t)` scopes a target's
init-time registrations (and the backend's symbol store) to its lanes,
and dispatch routes by the faulting lane's tenant — two base images
sharing a virtual address never see each other's handlers (the decode
cache splits the entries by the same tag).

The mesh-sharded variant of the JAX package (`TenancyMeshBackend`) is not
part of the port: `create_tenancy_backend(mesh_devices=...)` raises.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from functools import reduce
from typing import List, Optional, Sequence

import numpy as np
import torch

from wtf_tpu_torch.backend.gpu import GpuBackend
from wtf_tpu_torch.core.results import StatusCode, TestcaseResult
from wtf_tpu_torch.meshrun.reduce import merge_coverage


@dataclasses.dataclass
class TenantSpec:
    """One tenant's placement row (what build_batch_state consumes)."""

    name: str
    target: object            # harness.targets.Target
    snapshot: object          # snapshot.loader.Snapshot
    lanes: int                # lane quota (== solo campaign lane count)


class _TenancyMixin:
    """The multi-tenant deltas over GpuBackend — everything rides the
    existing seams (`tenants=` runner kwarg, `_bp_handler`,
    `_dispatch_bp`, `_finish_batch`)."""

    def _init_tenancy(self, specs: Sequence[TenantSpec]) -> None:
        if not specs:
            raise ValueError("tenancy backend needs at least one tenant")
        self.tenant_specs = list(specs)
        quotas = [int(s.lanes) for s in specs]
        if sum(quotas) > self.n_lanes:
            raise ValueError(
                f"tenant quotas {quotas} exceed the {self.n_lanes}-lane "
                "batch")
        self._lane_lo = np.cumsum([0] + quotas)[:-1]
        self._quotas = quotas
        self._init_tenant = 0
        # trailing lanes beyond the placed quotas idle (status OK at
        # insert); build_batch_state pads them from tenant 0's snapshot
        self._runner_kwargs = dict(self._runner_kwargs,
                                   tenants=list(specs))
        self._agg_cov_t: List = []
        self._agg_edge_t: List = []
        self._new_words_t: List = []
        self._active_mask: Optional[np.ndarray] = None

    # -- placement helpers -------------------------------------------------
    def lane_range(self, t: int) -> range:
        lo = int(self._lane_lo[t])
        return range(lo, lo + self._quotas[t])

    def lane_mask(self, t: int) -> np.ndarray:
        mask = np.zeros(self.n_lanes, dtype=bool)
        mask[self.lane_range(t).start:self.lane_range(t).stop] = True
        return mask

    @contextmanager
    def tenant_context(self, t: int):
        """Scope breakpoint registration + the symbol store to tenant t
        (target.init time, and handler dispatch)."""
        old_t, old_sym = self._init_tenant, self.symbols
        self._init_tenant = t
        self.symbols = self.tenant_specs[t].snapshot.symbols
        try:
            yield
        finally:
            self._init_tenant, self.symbols = old_t, old_sym

    # -- overridden seams --------------------------------------------------
    def initialize(self) -> None:
        super().initialize()
        self._lane_masks = [self.lane_mask(t)
                            for t in range(len(self.tenant_specs))]
        self._agg_cov_t = [torch.zeros_like(self._agg_cov)
                           for _ in self.tenant_specs]
        self._agg_edge_t = [torch.zeros_like(self._agg_edge)
                            for _ in self.tenant_specs]
        self._new_words_t = [None for _ in self.tenant_specs]
        self.registry.gauge("tenancy.tenants").set(len(self.tenant_specs))

    def set_breakpoint(self, gva: int, handler) -> None:
        self.breakpoints[(self._init_tenant, gva)] = handler
        self.runner.cache.set_breakpoint(gva, tenant=self._init_tenant)

    def _bp_handler(self, lane: int, rip: int):
        return self.breakpoints.get((self.runner.tenant_of(lane), rip))

    def _dispatch_bp(self, runner, view, lane: int) -> None:
        # handlers run under their tenant's symbol scope
        with self.tenant_context(runner.tenant_of(lane)):
            super()._dispatch_bp(runner, view, lane)

    def _finish_batch(self, statuses, n_active: int) -> None:
        """Per-tenant prefix-credit merges by lane-ID mask: tenant t's
        aggregate only sees its own lanes, and a lane is credited new
        coverage only for bits new to ITS tenant — the isolation rule
        that makes mixed-batch results bit-identical to solo runs."""
        runner = self.runner
        with self.registry.spans.span("cov-readback") as sp:
            m = runner.machine
            # run_batch_tenants leaves the per-lane active mask (lane
            # ranges, not a prefix); prefix-count callers (the inherited
            # run_batch paths) fall back to the classic arange rule
            mask = self._active_mask
            self._active_mask = None
            lane_ok = (np.arange(self.n_lanes) < n_active
                       if mask is None else mask)
            base = ((statuses != int(StatusCode.TIMEDOUT))
                    & (statuses != int(StatusCode.OVERLAY_FULL))
                    & lane_ok)
            new_lane = np.zeros(self.n_lanes, dtype=bool)
            for t in range(len(self.tenant_specs)):
                inc = torch.from_numpy(base & self._lane_masks[t]).to(
                    m.device)
                (self._agg_cov_t[t], self._agg_edge_t[t], nl,
                 nw) = merge_coverage(self._agg_cov_t[t],
                                      self._agg_edge_t[t], m.cov, m.edge,
                                      inc)
                self._new_words_t[t] = nw.cpu().numpy().view(np.uint32)
                new_lane |= nl.cpu().numpy()
            self._new_lane = new_lane
            # global roll-up (heartbeat coverage display, minset compat)
            self._agg_cov = reduce(torch.bitwise_or, self._agg_cov_t)
            self._agg_edge = reduce(torch.bitwise_or, self._agg_edge_t)
            self._last_new_words = reduce(
                np.bitwise_or, [w for w in self._new_words_t
                                if w is not None])
            self._count_statuses(statuses[lane_ok])
            self.stats["batches"] += 1
            self.stats["testcases"] += n_active
            self.stats["instructions"] += int(
                m.icount.cpu().numpy()[lane_ok].sum())
            runner.fold_device_counters()
            sp.fence(self._agg_cov)

    # -- heterogeneous batch execution ------------------------------------
    def run_batch_tenants(self, plans) -> List[TestcaseResult]:
        """One mixed batch: `plans[t]` is either ("host", [bytes...]) —
        at most quota testcases inserted through tenant t's
        insert_testcase — or ("device", mutator) with a bound
        tenant-scoped devmangle engine whose take_batch() already ran.
        Unfilled/unplaced lanes idle.  Returns per-lane results."""
        runner = self.runner
        runner.limit = self.limit
        self._lane_results = {}
        spans = self.registry.spans
        active = np.zeros(self.n_lanes, dtype=bool)
        device_plans = []
        with spans.span("insert"):
            view = self._ensure_view()
            for t, plan in enumerate(plans):
                kind, payload = plan
                lo = int(self._lane_lo[t])
                if kind == "host":
                    if len(payload) > self._quotas[t]:
                        raise ValueError(
                            f"tenant {self.tenant_specs[t].name!r} plan "
                            f"has {len(payload)} testcases for "
                            f"{self._quotas[t]} lanes")
                    with self.tenant_context(t):
                        for i, data in enumerate(payload):
                            with self._bound(view, lo + i):
                                self.tenant_specs[t].target.insert_testcase(
                                    self, data)
                    active[lo:lo + len(payload)] = True
                elif kind == "device":
                    device_plans.append((t, payload))
                    active[lo:lo + self._quotas[t]] = True
                else:
                    raise ValueError(f"unknown plan kind {kind!r}")
            for lane in np.nonzero(~active)[0]:
                view.set_status(int(lane), StatusCode.OK)
            runner.push(view)
            self._view = None
            for t, mutator in device_plans:
                with spans.span("device") as sp:
                    words, lens = mutator.current_batch()
                    lo = int(self._lane_lo[t])
                    q = self._quotas[t]
                    full_w = torch.zeros((self.n_lanes, words.shape[1]),
                                         dtype=words.dtype,
                                         device=words.device)
                    full_w[lo:lo + q] = words
                    full_l = torch.zeros(self.n_lanes, dtype=lens.dtype,
                                         device=lens.device)
                    full_l[lo:lo + q] = lens
                    spec = mutator.spec
                    runner.device_insert(
                        full_w, full_l, mutator.pfns, spec.gva,
                        spec.len_gpr, spec.ptr_gpr,
                        active=self._lane_masks[t])
                    sp.fence(runner.machine.status)
        statuses = runner.run(bp_handler=self._dispatch_bp)
        self._active_mask = active
        self._finish_batch(statuses, int(active.sum()))
        return [self._map_result(lane, statuses[lane])
                for lane in range(self.n_lanes)]

    # -- per-tenant checkpoint seams (wtf_tpu_torch/tenancy/state.py) -----
    def tenant_coverage_state(self, t: int):
        """(cov words, edge words) of tenant t's aggregates as host uint32
        arrays."""
        return (self._agg_cov_t[t].cpu().numpy().view(np.uint32).copy(),
                self._agg_edge_t[t].cpu().numpy().view(np.uint32).copy())

    def restore_tenant_coverage(self, t: int, cov: np.ndarray,
                                edge: np.ndarray) -> None:
        dev = self.runner.device
        self._agg_cov_t[t] = torch.from_numpy(np.ascontiguousarray(
            cov, dtype=np.uint32).view(np.int32).copy()).to(dev)
        self._agg_edge_t[t] = torch.from_numpy(np.ascontiguousarray(
            edge, dtype=np.uint32).view(np.int32).copy()).to(dev)
        self._agg_cov = reduce(torch.bitwise_or, self._agg_cov_t)
        self._agg_edge = reduce(torch.bitwise_or, self._agg_edge_t)

    def tenant_coverage_rips(self, t: int) -> set:
        cov = self.tenant_coverage_state(t)[0]
        return set(self.runner.cache.rips_of_bits(cov))

    def print_run_stats(self) -> None:
        super().print_run_stats()
        parts = ", ".join(
            f"{s.name}={q}" for s, q in zip(self.tenant_specs,
                                            self._quotas))
        print(f"[gpu] tenants: {parts} (lanes {self.n_lanes})")


class TenancyBackend(_TenancyMixin, GpuBackend):
    """Single-device multi-tenant batch."""

    def __init__(self, specs: Sequence[TenantSpec], n_lanes: int,
                 **kwargs):
        super().__init__(specs[0].snapshot, n_lanes=n_lanes, **kwargs)
        self._init_tenancy(specs)


def create_tenancy_backend(specs: Sequence[TenantSpec], n_lanes: int,
                           mesh_devices: Optional[int] = None,
                           **kwargs):
    if mesh_devices is not None:
        raise ValueError(
            "a mesh-sharded tenancy batch (mesh_devices) is not part of "
            "the port yet: it arrives with the multi-device item "
            "(ROADMAP A13)")
    return TenancyBackend(specs, n_lanes, **kwargs)
