"""MultiTenantLoop: N campaigns, one batch, per-tenant everything.

The counterpart of wtf_tpu/tenancy/loop.py.
Each TenantRuntime is a mini fuzz campaign — its own corpus, mutation
engine (host mangle/byte/tlv or a tenant-scoped devmangle), RNG, crash
dirs, stats and checkpoint cadence — sharing ONE TenancyBackend batch.
Per batch the loop gathers every active tenant's insert plan, executes
them in one `run_batch_tenants` dispatch, and harvests each tenant's
lanes in lane order against its own aggregates, so every per-tenant
decision (mutation draws, corpus insertion order, new-coverage credit,
crash bucketing, devmut lane seeds) is a function of the tenant's OWN
stream and relative lane index — the isolation contract that makes a
lane-subset campaign bit-identical to the same campaign run alone.

Telemetry: per-tenant counters live under `tenant.<name>.*` (execs,
crashes, new-coverage, lane-milliseconds), tenant-tagged JSONL events
segment the shared events.jsonl per tenant (tools/telemetry_report.py
groups them), and the classic `campaign.*` namespace aggregates across
tenants so the heartbeat line keeps its shape.
"""

from __future__ import annotations

import random
import time
from pathlib import Path
from typing import Dict, List, Optional

from wtf_tpu_torch.core.results import (
    Cr3Change, Crash, OverlayFull, TestcaseResult, Timedout,
)
from wtf_tpu_torch.devmut.mutator import DevMangleMutator
from wtf_tpu_torch.fuzz.corpus import Corpus
from wtf_tpu_torch.fuzz.loop import CampaignStats
from wtf_tpu_torch import telemetry
from wtf_tpu_torch.telemetry import Registry, StatsDict
from wtf_tpu_torch.utils.hashing import hex_digest


class TenantStats:
    """`tenant.<name>.*` counters with the CampaignStats accounting
    rule (one shared account() path per result class)."""

    FIELDS = ("testcases", "crashes", "timeouts", "cr3s",
              "overlay_fulls", "new_coverage", "lane_ms", "batches")

    def __init__(self, registry: Registry, name: str):
        self.d = StatsDict(registry, f"tenant.{name}", fields=self.FIELDS)

    def __getitem__(self, key):
        return self.d[key]

    def __setitem__(self, key, value):
        self.d[key] = value

    def account(self, result: TestcaseResult) -> bool:
        self.d["testcases"] += 1
        if isinstance(result, Timedout):
            self.d["timeouts"] += 1
        elif isinstance(result, Cr3Change):
            self.d["cr3s"] += 1
        elif isinstance(result, OverlayFull):
            self.d["overlay_fulls"] += 1
        elif isinstance(result, Crash):
            self.d["crashes"] += 1
            return True
        return False


class TenantDevMutator(DevMangleMutator):
    """Devmangle scoped to one tenant's lane range: quota-sized batches
    on the tenant's own corpus slab and seed stream (relative lane
    indices — bit-exact with the same campaign run alone), the input
    region's pfns translated through the tenant's own page tables (its
    first lane; the snapshot mapping is per-tenant static), generation
    through the runner's plain engine (the byte stream is placement-
    invariant by the per-lane program)."""

    def __init__(self, seed: int, max_len: int, name: str, lane_lo: int,
                 quota: int, **kwargs):
        super().__init__(seed, max_len, **kwargs)
        self.tenant_name = name
        self.lane_lo = lane_lo
        self.quota = quota

    def first_lane(self) -> int:
        return self.lane_lo

    def bind(self, backend, target, registry: Optional[Registry] = None,
             events=None) -> None:
        super().bind(backend, target, registry=registry, events=events)
        # tenant deltas over the campaign bind: quota-sized batches and
        # stats under tenant.<name>.devmut
        self.stats = StatsDict(
            self.registry, f"tenant.{self.tenant_name}.devmut",
            fields=("batches", "generated", "fetched", "corpus_syncs"),
            gauges=("corpus_slots",))
        self.n_lanes = self.quota


class TenantRuntime:
    """One campaign-as-job bound to a lane range of the shared batch."""

    def __init__(self, spec, seed: int, runs: int, mutator_name: str,
                 max_len: int, lane_lo: int,
                 crashes_dir: Optional[Path] = None,
                 checkpoint_dir: Optional[Path] = None,
                 checkpoint_every: int = 0,
                 registry: Optional[Registry] = None, events=None,
                 store=None):
        self.spec = spec
        self.name = spec.name
        self.target = spec.target
        self.quota = int(spec.lanes)
        self.lane_lo = lane_lo
        self.seed = seed
        self.runs = runs
        self.mutator_name = mutator_name
        self.max_len = max_len
        self.registry = registry if registry is not None else Registry()
        self.events = events if events is not None else telemetry.NULL
        self.rng = random.Random(seed or None)
        # per-tenant store namespace (wtf_tpu/fleet/store): a root
        # FleetStore hands each tenant its own `tenant-<name>` corpus +
        # crash space — shared fanout layout, zero shared state
        self.store = (store.namespace(f"tenant-{spec.name}")
                      if store is not None else None)
        self.corpus = Corpus(rng=self.rng, store=self.store)
        self.crashes_dir = Path(crashes_dir) if crashes_dir else None
        if self.crashes_dir:
            self.crashes_dir.mkdir(parents=True, exist_ok=True)
        self.checkpoint_dir = (Path(checkpoint_dir) if checkpoint_dir
                               else None)
        self.checkpoint_every = checkpoint_every
        self.stats = TenantStats(self.registry, self.name)
        self.crash_names: set = set()
        self.crash_buckets: set = set()
        self.requeue: List[bytes] = []
        self.requeue_digests: set = set()
        self.batches_done = 0
        if mutator_name == "devmangle":
            self.mutator = TenantDevMutator(
                seed=self.rng.getrandbits(64), max_len=max_len,
                name=self.name, lane_lo=lane_lo, quota=self.quota)
            self.device = True
        else:
            from wtf_tpu_torch.fuzz.mutator import create_mutator

            if mutator_name == "auto":
                from wtf_tpu_torch.fuzz.native_mutator import (
                    best_mangle_mutator,
                )

                self.mutator = (spec.target.create_mutator(
                    self.rng, max_len)
                    if spec.target.create_mutator is not None
                    else best_mangle_mutator(self.rng, max_len))
            else:
                self.mutator = create_mutator(mutator_name, self.rng,
                                              max_len)
            self.device = False

    @property
    def done(self) -> bool:
        return self.runs > 0 and self.stats["testcases"] >= self.runs

    def seed_corpus(self, inputs_dir) -> None:
        if inputs_dir and Path(inputs_dir).is_dir():
            from wtf_tpu_torch.fuzz.corpus import seed_paths

            for _p, digest, data in seed_paths([inputs_dir],
                                               with_data=True):
                self.corpus.add_digested(data, digest)


class MultiTenantLoop:
    """Drive every active tenant one batch at a time on a shared
    TenancyBackend."""

    def __init__(self, backend, runtimes: List[TenantRuntime],
                 registry: Optional[Registry] = None, events=None,
                 stats_every: float = 10.0):
        self.backend = backend
        self.tenants = runtimes
        self.registry, self.events = telemetry.resolve(
            backend, registry, events)
        self.stats = CampaignStats(self.registry)  # cross-tenant roll-up
        self.stats_every = stats_every
        for t, rt in enumerate(runtimes):
            rt.registry = self.registry
            rt.events = self.events
            rt.stats = TenantStats(self.registry, rt.name)
            if rt.device:
                rt.mutator.bind(backend, rt.target,
                                registry=self.registry,
                                events=self.events)
                rt.mutator.seed_from(rt.corpus)

    # -- per-batch ---------------------------------------------------------
    def _plan(self, rt: TenantRuntime):
        if rt.done:
            return ("host", [])
        if rt.device:
            rt.mutator.take_batch()
            return ("device", rt.mutator)
        requeued = rt.requeue[:rt.quota]
        rt.requeue = rt.requeue[len(requeued):]
        fresh = rt.quota - len(requeued)
        testcases = requeued + [rt.mutator.get_new_testcase(rt.corpus)
                                for _ in range(fresh)]
        return ("host", testcases)

    def _save_crash(self, rt: TenantRuntime, data: bytes, result: Crash,
                    bucket: Optional[str]) -> None:
        name = result.name or f"crash-{hex_digest(data)[:16]}"
        bucket = bucket or name
        new = bucket not in rt.crash_buckets
        rt.crash_buckets.add(bucket)
        rt.crash_names.add(name)
        if rt.crashes_dir:
            from wtf_tpu_torch.utils.atomicio import atomic_write_bytes

            try:
                if rt.store is not None:
                    digest, _ = rt.store.put(data, kind="crash",
                                             name=name, bucket=bucket)
                    if rt.store.has(digest):
                        rt.store.link_into(rt.crashes_dir, digest,
                                           name=name)
                else:
                    atomic_write_bytes(rt.crashes_dir / name, data)
            except OSError as e:
                import logging

                logging.getLogger(__name__).warning(
                    "crash save failed for %r (%s): %s", name, rt.name, e)
                self.events.emit("error", kind="crash-save", name=name,
                                 tenant=rt.name, detail=str(e))
        self.events.emit("crash", tenant=rt.name, name=name,
                         size=len(data), new=new, bucket=bucket)

    def _harvest_tenant(self, t: int, rt: TenantRuntime, plan,
                        results) -> int:
        from wtf_tpu_torch.triage.bucket import bucket_of

        kind, payload = plan
        lo = rt.lane_lo
        crashes = 0
        timeouts_before = rt.stats["timeouts"]
        if kind == "device":
            rt.mutator.prelaunch()
            wanted = [rel for rel in range(rt.quota)
                      if self.backend.lane_found_new_coverage(lo + rel)
                      or isinstance(results[lo + rel], Crash)]
            datas = rt.mutator.fetch(wanted)
            lanes = [(rel, datas.get(rel, b"")) for rel in range(rt.quota)]
            requeue = False
        else:
            lanes = list(enumerate(payload))
            requeue = True
        for rel, data in lanes:
            lane = lo + rel
            result = results[lane]
            self.stats.account(result)
            if rt.stats.account(result):
                crashes += 1
                self._save_crash(rt, data, result,
                                 bucket_of(self.backend, lane, result))
            elif requeue and isinstance(result, OverlayFull):
                digest = hex_digest(data)
                if digest not in rt.requeue_digests:
                    rt.requeue_digests.add(digest)
                    rt.requeue.append(data)
            if self.backend.lane_found_new_coverage(lane):
                rt.stats["new_coverage"] += 1
                self.stats.new_coverage += 1
                if rt.corpus.add(data):
                    rt.mutator.on_new_coverage(data)
                    self.events.emit("new-coverage", tenant=rt.name,
                                     digest=hex_digest(data),
                                     size=len(data))
        timeouts = rt.stats["timeouts"] - timeouts_before
        if timeouts:
            self.events.emit("timeout", tenant=rt.name, count=timeouts)
        return crashes

    def run_one_batch(self) -> int:
        spans = self.registry.spans
        t0 = time.time()
        active = [t for t, rt in enumerate(self.tenants) if not rt.done]
        with spans.span("mutate"):
            plans = [self._plan(rt) for rt in self.tenants]
        with spans.span("execute"):
            results = self.backend.run_batch_tenants(plans)
        crashes = 0
        with spans.span("harvest"):
            for t in active:
                rt = self.tenants[t]
                crashes += self._harvest_tenant(t, rt, plans[t], results)
                rt.batches_done += 1
        with spans.span("restore"):
            for t in active:
                with self.backend.tenant_context(t):
                    self.tenants[t].target.restore()
            self.backend.restore()
        wall_ms = int((time.time() - t0) * 1000)
        for t in active:
            rt = self.tenants[t]
            rt.stats["lane_ms"] += wall_ms * rt.quota
            rt.stats["batches"] += 1
        self._maybe_checkpoint()
        self.stats.maybe_heartbeat(
            self.events, self.registry,
            lambda: self.stats.line(
                sum(len(rt.corpus) for rt in self.tenants)),
            every=self.stats_every, print_stats=True)
        return crashes

    def _maybe_checkpoint(self) -> None:
        for t, rt in enumerate(self.tenants):
            if not (rt.checkpoint_dir and rt.checkpoint_every):
                continue
            if rt.done or rt.batches_done == 0 \
                    or rt.batches_done % rt.checkpoint_every:
                continue
            self.checkpoint_tenant(t)

    def checkpoint_tenant(self, t: int) -> Optional[dict]:
        """Checkpoint one tenant now (cadence hits and the scheduler's
        preemption both land here).  Best-effort like the campaign
        checkpoint: a full disk degrades with a warning, never aborts."""
        from wtf_tpu_torch.tenancy.state import save_tenant

        rt = self.tenants[t]
        if rt.checkpoint_dir is None:
            return None
        try:
            with self.registry.spans.span("checkpoint"):
                info = save_tenant(self.backend, rt, t, rt.checkpoint_dir)
        except OSError as e:
            import logging

            logging.getLogger(__name__).warning(
                "tenant %s checkpoint failed at batch %d: %s",
                rt.name, rt.batches_done, e)
            self.events.emit("error", kind="checkpoint-write",
                             tenant=rt.name, batch=rt.batches_done,
                             detail=str(e))
            return None
        self.registry.counter(f"tenant.{rt.name}.checkpoints").inc()
        self.events.emit("checkpoint", tenant=rt.name,
                         batch=rt.batches_done, bytes=info["bytes"],
                         path=info["path"])
        return info

    def resume_tenant(self, t: int) -> Optional[int]:
        """Restore tenant t from its checkpoint dir when one exists."""
        from wtf_tpu_torch.resume.checkpoint import CKPT_NAME
        from wtf_tpu_torch.tenancy.state import restore_tenant

        rt = self.tenants[t]
        if (rt.checkpoint_dir is None
                or not (rt.checkpoint_dir / CKPT_NAME).exists()):
            return None
        return restore_tenant(self.backend, rt, t, rt.checkpoint_dir)

    def run(self, max_batches: int = 1 << 20) -> Dict[str, TenantStats]:
        """Run until every tenant's testcase budget is met."""
        for _ in range(max_batches):
            if all(rt.done for rt in self.tenants):
                break
            self.run_one_batch()
        return {rt.name: rt.stats for rt in self.tenants}
