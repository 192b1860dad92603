"""The ONE batched replay core the triage workloads share.

The counterpart of wtf_tpu/triage/replay.py.  Everything in triage is
shaped "run N variants of testcases and look at what each lane did" —
the fuzz loop's execute phase with the mutation stage swapped out.  This
module is that shared execution path, driving the SAME dispatch seams
the campaign uses, so triage runs the fused step (K1) and the precise
step exactly as a campaign batch does:

  * host-bytes sweeps (`replay`): chunked through `backend.run_batch`
    (per-lane target.insert_testcase, trailing lanes idle) — corpus
    distillation, minset, vbreak sweeps;
  * device-built batches (`replay_device`): `[lanes, words]` int32
    tensors (triage/candidates.py builds, the devmut slab format) through
    `GpuBackend.run_batch_words` -> `Runner.device_insert` — the
    minimizer's candidate storm, whose bytes never visit the host;
  * per-testcase coverage out of the `[words]` bitmaps: raw cov/edge rows
    for the host set cover, and the exact first-hit attribution
    (meshrun/reduce.first_hit_credit) computed on the device with the
    revocation rule of the batch merge (timeout/overlay-full lanes credit
    nothing); each plane comes to the host in one read per batch, as
    uint32 rows (the JAX package's dtype);
  * triage-grade crash buckets per crashed lane (triage/bucket.py).

The JAX module also exports `REPLAY_CHUNK_FACTORY`, a lint pin of its
chunk executor; the port has no executor to pin, so it is left out.
FuzzLoop.minset (the campaign `--runs 0` path) runs on this same core.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from wtf_tpu_torch import telemetry
from wtf_tpu_torch.core.results import (
    Crash, OverlayFull, TestcaseResult, Timedout,
)
from wtf_tpu_torch.meshrun.reduce import first_hit_credit
from wtf_tpu_torch.telemetry import Registry, StatsDict
from wtf_tpu_torch.triage.bucket import bucket_of, crash_kind

PAGE = 4096


class ReplaySweep(NamedTuple):
    """One `replay()` call's harvest, indexed by testcase position."""

    results: List[TestcaseResult]
    new_lane: np.ndarray            # first-hit credit flags (merge order)
    buckets: Dict[int, str]         # index -> triage bucket (crashes only)
    cov: Optional[np.ndarray]       # uint32[N, Wc] per-testcase planes
    edge: Optional[np.ndarray]      # uint32[N, We]
    credit_cov: Optional[np.ndarray]   # uint32[N, Wc] first-hit credit
    credit_edge: Optional[np.ndarray]  # uint32[N, We]


def _include_mask(results: Sequence[TestcaseResult]) -> np.ndarray:
    """The batch merge's revocation rule as a mask: timeout and
    overlay-full lanes contribute no coverage (client.cc:122-125)."""
    return np.array([not isinstance(r, (Timedout, OverlayFull))
                     for r in results])


def _rows(plane: torch.Tensor, n: int) -> np.ndarray:
    """The first `n` lanes of an int32 bitmap plane as host uint32 rows
    (one device-to-host read)."""
    return plane[:n].cpu().numpy().view(np.uint32).copy()


class ReplayCore:
    """Batched replay over an initialized backend.

    Shares the backend's registry/events (spans nest like the fuzz loop's:
    execute / harvest / restore), and owns the `triage.*` counters."""

    def __init__(self, backend, target, registry: Optional[Registry] = None,
                 events=None, batch_size: Optional[int] = None):
        if not hasattr(backend, "run_batch"):
            raise ValueError(
                "triage replay needs a backend with the batch facade "
                "(run_batch)")
        self.backend = backend
        self.target = target
        self.registry, self.events = telemetry.resolve(
            backend, registry, events)
        # single-lane backends replay through the base-class batch facade
        # (minset keeps working on the oracle); the plane / attribution /
        # device-candidate paths need the real batch
        self.n_lanes = getattr(backend, "n_lanes", 1)
        self.batch_size = min(batch_size or self.n_lanes, self.n_lanes)
        self.stats = StatsDict(
            self.registry, "triage",
            fields=("candidates", "dispatches", "crashes"))
        self._spec = getattr(target, "device_insert", None)
        self._pfns: Optional[List[int]] = None

    # -- device-candidate seam (the devmut slab-upload scheme) -----------
    def _require_runner(self, what: str):
        runner = getattr(self.backend, "runner", None)
        if runner is None:
            raise ValueError(
                f"{what} requires the initialized batched GpuBackend; "
                "this backend has no device batch")
        return runner

    def device_spec(self):
        """(DeviceInsertSpec, input-region pfns) for device-built
        batches; translates the region once, like DevMangleMutator.bind."""
        self._require_runner("device-built triage batches")
        if self._spec is None:
            raise ValueError(
                f"target {getattr(self.target, 'name', self.target)!r} "
                "has no device_insert spec — device-built triage batches "
                "need the declarative insert seam "
                "(harness.targets.DeviceInsertSpec)")
        if self._pfns is None:
            n_pages = (self._spec.max_len + PAGE - 1) // PAGE
            view = self.backend.runner.view()
            self._pfns = [
                view.translate(0, self._spec.gva + i * PAGE) >> 12
                for i in range(n_pages)]
        return self._spec, self._pfns

    @property
    def device(self):
        return self._require_runner("device-built triage batches").device

    # -- the sweep --------------------------------------------------------
    def replay(self, testcases: Sequence[bytes], *,
               collect_planes: bool = False, attribute: bool = False,
               want_buckets: bool = False,
               on_batch_start: Optional[Callable[[int], None]] = None,
               on_batch: Optional[Callable] = None,
               after_batch: Optional[Callable[[], None]] = None
               ) -> ReplaySweep:
        """Replay host testcases in batches of `batch_size` lanes with a
        full snapshot restore in between (the batched
        RunTestcaseAndRestore).

        collect_planes  pull each testcase's cov/edge bitmap rows
                        (revoked lanes zeroed — the merge's include rule)
        attribute       also compute the exact first-hit credit planes on
                        the device (meshrun/reduce.first_hit_credit),
                        carrying the aggregate across batches
        want_buckets    triage bucket per crashed lane
        on_batch_start(start)           before each batch's execution
        on_batch(start, batch, results) harvest callback, inside the
                        `harvest` span, before the restore
        after_batch()   after the restore (heartbeat cadence)
        """
        backend = self.backend
        spans = self.registry.spans
        results_all: List[TestcaseResult] = []
        new_flags: List[bool] = []
        buckets: Dict[int, str] = {}
        cov_rows: List[np.ndarray] = []
        edge_rows: List[np.ndarray] = []
        credit_cov_rows: List[np.ndarray] = []
        credit_edge_rows: List[np.ndarray] = []
        agg = None
        testcases = list(testcases)
        for start in range(0, len(testcases), self.batch_size):
            batch = testcases[start:start + self.batch_size]
            if on_batch_start is not None:
                on_batch_start(start)
            with spans.span("execute"):
                results = backend.run_batch(batch, self.target)
            self.stats["dispatches"] += 1
            self.stats["candidates"] += len(batch)
            include = _include_mask(results)
            if collect_planes or attribute:
                m = self._require_runner("per-testcase bit-planes").machine
                if attribute:
                    if agg is None:
                        agg = (torch.zeros_like(m.cov[0]),
                               torch.zeros_like(m.edge[0]))
                    inc = torch.from_numpy(np.pad(
                        include, (0, self.n_lanes - len(batch)))).to(
                            m.cov.device)
                    ccov, cedge, agg_cov, agg_edge = first_hit_credit(
                        agg[0], agg[1], m.cov, m.edge, inc)
                    agg = (agg_cov, agg_edge)
                    credit_cov_rows.append(_rows(ccov, len(batch)))
                    credit_edge_rows.append(_rows(cedge, len(batch)))
                if collect_planes:
                    cov = _rows(m.cov, len(batch))
                    edge = _rows(m.edge, len(batch))
                    cov[~include] = 0
                    edge[~include] = 0
                    cov_rows.append(cov)
                    edge_rows.append(edge)
            for lane, result in enumerate(results):
                if isinstance(result, Crash):
                    self.stats["crashes"] += 1
                    if want_buckets:
                        buckets[start + lane] = bucket_of(
                            backend, lane, result)
            new_flags.extend(
                bool(backend.lane_found_new_coverage(lane))
                for lane in range(len(batch)))
            if on_batch is not None:
                with spans.span("harvest"):
                    on_batch(start, batch, results)
            results_all.extend(results)
            self._restore()
            if after_batch is not None:
                after_batch()
        return ReplaySweep(
            results=results_all,
            new_lane=np.array(new_flags, dtype=bool),
            buckets=buckets,
            cov=np.concatenate(cov_rows) if cov_rows else None,
            edge=np.concatenate(edge_rows) if edge_rows else None,
            credit_cov=(np.concatenate(credit_cov_rows)
                        if credit_cov_rows else None),
            credit_edge=(np.concatenate(credit_edge_rows)
                         if credit_edge_rows else None))

    def replay_device(self, words, lens, n_candidates: int,
                      base_kind: Optional[str] = None):
        """Run one device-built candidate batch (`words` int32[L, W] /
        `lens` int32[L] on the runner's device, every lane active) through
        the insert seam.  Returns (results, buckets) for the first
        `n_candidates` lanes; `base_kind` skips bucket computation for
        crashes of a different fault CLASS (the bucket embeds the kind,
        so a kind mismatch is a bucket mismatch).  The kind — not the full
        result name: a read/write crasher's name embeds the fault DATA
        address, which a still-same-bucket candidate legitimately
        changes."""
        spec, pfns = self.device_spec()
        spans = self.registry.spans
        with spans.span("execute"):
            results = self.backend.run_batch_words(words, lens, pfns, spec)
        self.stats["dispatches"] += 1
        self.stats["candidates"] += n_candidates
        buckets: Dict[int, str] = {}
        for lane in range(n_candidates):
            result = results[lane]
            if isinstance(result, Crash):
                self.stats["crashes"] += 1
                if base_kind is None or crash_kind(result) == base_kind:
                    buckets[lane] = bucket_of(self.backend, lane, result)
        self._restore()
        return results[:n_candidates], buckets

    def _restore(self) -> None:
        with self.registry.spans.span("restore"):
            self.target.restore()
            self.backend.restore()
