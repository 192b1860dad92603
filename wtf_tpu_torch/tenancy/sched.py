"""Scheduler tier: campaigns as JOBS over the multi-tenant batch.

The counterpart of wtf_tpu/tenancy/sched.py, the serving-system half of
wtf_tpu_torch/tenancy (`python -m wtf_tpu_torch sched`): a jobs table
(jobs.json or programmatic `Job`s) is placed onto the lane budget of one
device batch by priority and lane quota, runs in quantum-sized rounds,
and is preempted through the per-tenant checkpoint (state.py) — the
contract of multi-tenant inference serving with persistent device
programs (PAPERS.md: Concordia):

  placement   first-fit by (priority desc, least-recently-run, submit
              order) until the lane budget is spent.  Each distinct
              placement is a fresh stacked image table + backend (an
              UNCHANGED placement stays live across rounds — no rebuild,
              no checkpoint restore); all per-job state crossing
              placements travels via the placement-free tenant
              checkpoint.
  quantum     each round runs at most `quantum` batches, then every
              still-unfinished placed job checkpoints at the batch
              boundary.  When jobs are waiting, that checkpoint IS the
              preemption: the next round's placement hands the lanes to
              the waiting job, and the preempted one resumes later
              bit-identically (tests/test_torch_tenancy.py).
  completion  a job is done when its testcase budget (`runs`) is met —
              counters restore with the checkpoint, so budgets span
              preemptions.

Telemetry: `sched.*` counters (rounds, placements, preemptions,
completions) + `sched-round`/`sched-preempt`/`sched-complete` JSONL
events alongside the per-tenant `tenant.<name>.*` namespaces the loop
maintains.
"""

from __future__ import annotations

import dataclasses
import json
import re
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from wtf_tpu_torch import telemetry
from wtf_tpu_torch.telemetry import Registry

DEFAULT_MAX_LEN = 1 << 20

# job names key `tenant.<name>.*` counters (dots are the namespace
# separator) and name dirs under --workdir (separators would escape it)
_NAME_RE = re.compile(r"^[A-Za-z0-9_-]+$")


@dataclasses.dataclass
class Job:
    """One campaign-as-job row of the jobs table."""

    name: str                  # tenant id (unique; names dirs + counters)
    target: str                # registered target name (--name equivalent)
    lanes: int                 # lane quota per placement
    runs: int                  # testcase budget (job done when met)
    priority: int = 0          # higher places first
    seed: int = 0
    mutator: str = "auto"
    max_len: int = DEFAULT_MAX_LEN
    inputs: Optional[str] = None    # seed corpus dir
    checkpoint_every: int = 0       # extra cadence inside a quantum
    # -- runtime state (scheduler-owned) --------------------------------
    done: bool = False
    seq: int = 0               # submit order (placement tiebreak)
    last_round: int = -1       # most recent round placed (round-robin)
    batches_done: int = 0
    testcases: int = 0
    crashes: int = 0
    preemptions: int = 0


def load_jobs(path) -> List[Job]:
    """Parse a jobs.json: either {"jobs": [...]} or a bare list of job
    objects.  Field names match Job; unknown keys are an error (a typoed
    "lanes" must not silently fall back)."""
    doc = json.loads(Path(path).read_text())
    rows = doc.get("jobs") if isinstance(doc, dict) else doc
    if not isinstance(rows, list) or not rows:
        raise ValueError(f"{path}: expected a non-empty job list "
                         '(either {"jobs": [...]} or a bare list)')
    fields = {f.name for f in dataclasses.fields(Job)}
    config_fields = fields - {"done", "seq", "last_round", "batches_done",
                              "testcases", "crashes", "preemptions"}
    jobs = []
    for i, row in enumerate(rows):
        unknown = set(row) - config_fields
        if unknown:
            raise ValueError(
                f"{path}: job {i} has unknown fields {sorted(unknown)} "
                f"(known: {sorted(config_fields)})")
        missing = {"name", "target", "lanes", "runs"} - set(row)
        if missing:
            raise ValueError(
                f"{path}: job {i} is missing {sorted(missing)}")
        jobs.append(Job(seq=i, **row))
    names = [j.name for j in jobs]
    if len(set(names)) != len(names):
        raise ValueError(f"{path}: duplicate job names in {names}")
    for job in jobs:
        if job.lanes <= 0 or job.runs <= 0:
            raise ValueError(
                f"{path}: job {job.name!r} needs lanes > 0 and runs > 0")
        if not _NAME_RE.match(job.name):
            raise ValueError(
                f"{path}: job name {job.name!r} must match "
                "[A-Za-z0-9_-]+ — it keys tenant.<name>.* counters "
                "(dots are the namespace separator) and names a "
                "directory under --workdir")
    return jobs


class Scheduler:
    """Drive a jobs table to completion over one shared lane budget."""

    def __init__(self, jobs: Sequence[Job], n_lanes: int, workdir,
                 limit: int = 0, quantum: int = 4,
                 registry: Optional[Registry] = None, events=None,
                 backend_tuning: Optional[dict] = None,
                 stats_every: float = 10.0, store=None):
        if not jobs:
            raise ValueError("scheduler needs at least one job")
        for job in jobs:
            if job.lanes > n_lanes:
                raise ValueError(
                    f"job {job.name!r} wants {job.lanes} lanes but the "
                    f"batch has {n_lanes} — no placement can ever fit it")
            if not _NAME_RE.match(job.name):
                raise ValueError(
                    f"job name {job.name!r} must match [A-Za-z0-9_-]+ "
                    "(telemetry namespace key and workdir subdirectory)")
        self.jobs = list(jobs)
        self.n_lanes = n_lanes
        self.workdir = Path(workdir)
        self.limit = limit
        self.quantum = max(int(quantum), 1)
        self.registry, self.events = telemetry.resolve(
            None, registry, events)
        self.backend_tuning = dict(backend_tuning or {})
        self.stats_every = stats_every
        # root content-addressed store (wtf_tpu_torch/fleet/store): each job
        # gets its own tenant-<name> namespace carved out at placement
        self.store = store
        self._snapshots: Dict[str, object] = {}  # target name -> Snapshot
        # live placement carried across rounds: when _place() returns
        # the same job set, the backend/loop are reused instead of a
        # checkpoint-restore round trip
        self._live: Optional[tuple] = None  # (names, backend, runtimes,
        #                                      loop)
        self.rounds = 0

    # -- placement ---------------------------------------------------------
    def _place(self) -> List[Job]:
        """First-fit into the lane budget by (priority desc, least-
        recently-run, submit order).  The least-recently-run key is what
        turns the quantum checkpoint into preemptive round-robin within
        a priority class."""
        order = sorted((j for j in self.jobs if not j.done),
                       key=lambda j: (-j.priority, j.last_round, j.seq))
        placed, free = [], self.n_lanes
        for job in order:
            if job.lanes <= free:
                placed.append(job)
                free -= job.lanes
        return placed

    def _snapshot_for(self, target) -> object:
        """One snapshot per target per scheduler (the base image is
        immutable; re-loading per round would only slow placement)."""
        snap = self._snapshots.get(target.name)
        if snap is None:
            if target.snapshot is None:
                raise ValueError(
                    f"target {target.name!r} has no snapshot factory — "
                    "sched jobs need self-contained targets")
            snap = target.snapshot()
            self._snapshots[target.name] = snap
        return snap

    # -- one scheduling round ---------------------------------------------
    def _build_placement(self, placed: List[Job]):
        """Fresh stacked image + backend + runtimes for a placement;
        every job resumes from its checkpoint when one exists."""
        from wtf_tpu_torch.harness.targets import Targets
        from wtf_tpu_torch.tenancy.backend import TenantSpec, \
            create_tenancy_backend
        from wtf_tpu_torch.tenancy.loop import MultiTenantLoop, TenantRuntime

        targets = Targets.instance()
        specs = [TenantSpec(name=job.name, target=targets.get(job.target),
                            snapshot=self._snapshot_for(
                                targets.get(job.target)),
                            lanes=job.lanes)
                 for job in placed]
        backend = create_tenancy_backend(
            specs, self.n_lanes, limit=self.limit, registry=self.registry,
            events=self.events, **self.backend_tuning)
        with self.registry.spans.span("sched-place"):
            backend.initialize()
            for t, spec in enumerate(specs):
                with backend.tenant_context(t):
                    spec.target.init(backend)
        runtimes = []
        for t, (job, spec) in enumerate(zip(placed, specs)):
            jobdir = self.workdir / job.name
            rt = TenantRuntime(
                spec, seed=job.seed, runs=job.runs,
                mutator_name=job.mutator, max_len=job.max_len,
                lane_lo=int(backend._lane_lo[t]),
                crashes_dir=jobdir / "crashes",
                checkpoint_dir=jobdir / "checkpoint",
                checkpoint_every=job.checkpoint_every,
                registry=self.registry, events=self.events,
                store=self.store)
            rt.seed_corpus(job.inputs)
            runtimes.append(rt)
        loop = MultiTenantLoop(backend, runtimes, registry=self.registry,
                               events=self.events,
                               stats_every=self.stats_every)
        for t, job in enumerate(placed):
            resumed = loop.resume_tenant(t)
            if resumed is not None:
                print(f"[sched] {job.name}: resumed at batch {resumed}")
        self.registry.counter("sched.builds").inc()
        return backend, runtimes, loop

    def _run_round(self, placed: List[Job]) -> None:
        names = tuple(j.name for j in placed)
        if self._live is not None and self._live[0] == names:
            # same placement as last round and state is live: keep the
            # backend/loop (no re-upload, no checkpoint restore)
            backend, runtimes, loop = self._live[1:]
        else:
            self._live = None  # release the old device state first
            backend, runtimes, loop = self._build_placement(placed)
            self._live = (names, backend, runtimes, loop)
        self.events.emit("sched-round", round=self.rounds,
                         placed=[j.name for j in placed],
                         lanes=[j.lanes for j in placed])
        batches = 0
        while batches < self.quantum and not all(rt.done
                                                 for rt in runtimes):
            loop.run_one_batch()
            batches += 1
        waiting = [j.name for j in self.jobs
                   if not j.done and j not in placed]
        for t, (job, rt) in enumerate(zip(placed, runtimes)):
            job.last_round = self.rounds
            job.batches_done = rt.batches_done
            job.testcases = int(rt.stats["testcases"])
            job.crashes = int(rt.stats["crashes"])
            # quantum boundary: persist so the NEXT placement (which may
            # not include this job) resumes bit-identically; for a DONE
            # job this is the final results checkpoint (corpus manifest,
            # coverage, crash buckets survive the scheduler exit)
            loop.checkpoint_tenant(t)
            if rt.done:
                job.done = True
                self.registry.counter("sched.completions").inc()
                self.events.emit("sched-complete", tenant=job.name,
                                 testcases=job.testcases,
                                 batches=job.batches_done)
                print(f"[sched] {job.name}: done "
                      f"({job.testcases} testcases, "
                      f"{job.crashes} crashes)")
                continue
            if waiting:
                job.preemptions += 1
                self.registry.counter("sched.preemptions").inc()
                self.events.emit("sched-preempt", tenant=job.name,
                                 batch=rt.batches_done,
                                 waiting=waiting)
                print(f"[sched] {job.name}: preempted at batch "
                      f"{rt.batches_done} (waiting: "
                      f"{', '.join(waiting)})")
        self.registry.counter("sched.rounds").inc()
        self.registry.counter("sched.placements").inc(len(placed))

    # -- the round loop ----------------------------------------------------
    def run(self, max_rounds: int = 1 << 12) -> Dict[str, dict]:
        """Round-robin the jobs table until every job's budget is met
        (or max_rounds).  Returns {job name: summary dict}."""
        t0 = time.time()
        while not all(j.done for j in self.jobs):
            if self.rounds >= max_rounds:
                break
            placed = self._place()
            if not placed:
                break  # unreachable: every job fits alone (ctor check)
            self._run_round(placed)
            self.rounds += 1
        self.registry.gauge("sched.wall_seconds").set(
            round(time.time() - t0, 3))
        return {
            job.name: {
                "done": job.done,
                "testcases": job.testcases,
                "crashes": job.crashes,
                "batches": job.batches_done,
                "preemptions": job.preemptions,
            }
            for job in self.jobs
        }
