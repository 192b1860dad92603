"""The standalone fuzz loop: mutate -> batch-execute -> harvest.

Copied from wtf_tpu/fuzz/loop.py and cut to the paths the port carries:
the host-mutation batch, the device-mutation batch (wtf_tpu_torch/devmut)
and the megachunk window (wtf_tpu_torch/fuzz/megachunk.py), with
supervision (wtf_tpu_torch/supervise: every batch under the snapshot ->
dispatch -> recover-and-replay wrapper) and crash-safe checkpoints
(wtf_tpu_torch/resume: `checkpoint_every` batches into `checkpoint_dir`),
the minset mode (`minset`, on the triage replay core) and the fleet
store (wtf_tpu_torch/fleet/store: finds and crashes journaled
content-addressed, outputs/ and crashes/ their flat views).  Resharding
and the --xprof-dir profiler window are not part of it.

This is the single-process campaign loop — the reference needs a master
process + N client processes even on one machine (README.md:34-110); here
one process drives a whole device batch, and the distributed mode
(dist/client.py speaking to dist/server.py) reuses the same harvest logic
per node.

Per batch (the batched RunTestcaseAndRestore, client.cc:88-180):
  1. draw one testcase per lane from the mutator (corpus-seeded)
  2. backend.run_batch: insert + run every lane
  3. harvest: new-coverage lanes -> corpus + mutator cross-over seed;
     crashes -> crashes/<name>; timeouts already coverage-revoked
  4. target.restore + backend.restore

Telemetry: every batch phase is a span (mutate / execute / harvest /
restore — they tile run_one_batch, so their totals account for the
campaign's wall-clock), counters live in the metrics registry behind
`CampaignStats`, and crash / new-coverage / timeout / heartbeat records
land in the JSONL event log when one is wired.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Optional

from wtf_tpu_torch.core.results import (
    Cr3Change, Crash, OverlayFull, TestcaseResult, Timedout,
)
from wtf_tpu_torch.fuzz.corpus import Corpus
from wtf_tpu_torch.fuzz.mutator import Mutator
from wtf_tpu_torch import telemetry
from wtf_tpu_torch.telemetry import NULL, Registry
from wtf_tpu_torch.utils.hashing import hex_digest
from wtf_tpu_torch.utils.human import seconds_to_human


def _campaign_counter(name: str):
    """Property proxying one `campaign.<name>` registry counter, so the
    reference-shaped attribute API (`stats.crashes += 1`) stays while the
    value lives in the registry (one namespace for the heartbeat line,
    the JSONL dump, and print_run_stats)."""
    key = f"campaign.{name}"

    def fget(self):
        return self.registry.counter(key).value

    def fset(self, value):
        self.registry.counter(key).set(value)

    return property(fget, fset)


class CampaignStats:
    """Counters behind the status line (reference ServerStats_t / client
    stats, server.h:24-240, client.cc:7-84), registry-backed."""

    testcases = _campaign_counter("testcases")
    crashes = _campaign_counter("crashes")
    timeouts = _campaign_counter("timeouts")
    cr3s = _campaign_counter("cr3s")
    overlay_fulls = _campaign_counter("overlay_fulls")
    new_coverage = _campaign_counter("new_coverage")

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry if registry is not None else Registry()
        self.start = time.time()
        self.last_print = 0.0

    def execs_per_sec(self) -> float:
        dt = time.time() - self.start
        return self.testcases / dt if dt > 0 else 0.0

    def account(self, result: TestcaseResult) -> bool:
        """Count one testcase result; returns True for a crash (saving /
        requeueing is the caller's business).  The ONE accounting path
        shared by fuzz, minset, the dist master, and the dist clients."""
        self.testcases += 1
        if isinstance(result, Timedout):
            self.timeouts += 1
        elif isinstance(result, Cr3Change):
            self.cr3s += 1
        elif isinstance(result, OverlayFull):
            self.overlay_fulls += 1
        elif isinstance(result, Crash):
            self.crashes += 1
            return True
        return False

    def line(self, corpus_len: Optional[int] = None,
             cov: Optional[int] = None) -> str:
        """The human heartbeat line (format stable — downstream eyeballs
        and scripts parse it).  cov/corp are omitted by callers that
        don't track them (dist clients)."""
        uptime = seconds_to_human(time.time() - self.start)
        ovf = f" ovf: {self.overlay_fulls}" if self.overlay_fulls else ""
        mid = ""
        if cov is not None:
            mid += f"cov: {cov} "
        if corpus_len is not None:
            mid += f"corp: {corpus_len} "
        return (f"#{self.testcases} {mid}"
                f"exec/s: {self.execs_per_sec():.1f} "
                f"crash: {self.crashes} timeout: {self.timeouts} "
                f"cr3: {self.cr3s}{ovf} uptime: {uptime}")

    def maybe_heartbeat(self, events, registry=None, line_fn=None,
                        every: float = 10.0, print_stats: bool = False,
                        **fields) -> Optional[str]:
        """Throttled heartbeat — the ONE emission path shared by the fused
        loop, the dist master, and the dist nodes: at most one per `every`
        seconds, print() the human line when asked (print, not logging —
        the line must reach stdout even for library callers that never
        configure logging), and land a JSONL heartbeat record carrying
        the full registry dump.  Returns the line when one was emitted."""
        if not print_stats and (events is None or type(events) is type(NULL)):
            # nobody consumes the line: skip building it — line_fn can
            # cost a device coverage readback.  Exact-type check: EventLog
            # SUBCLASSES NullEventLog and must not match.
            return None
        now = time.time()
        if now - self.last_print < every:
            return None
        self.last_print = now
        line = line_fn() if line_fn is not None else self.line()
        if print_stats:
            print(line)
        events.heartbeat(registry, line=line, **fields)
        return line


class FuzzLoop:
    def __init__(
        self,
        backend,
        target,
        mutator: Mutator,
        corpus: Corpus,
        crashes_dir: Optional[Path] = None,
        batch_size: Optional[int] = None,
        stats_every: float = 10.0,
        registry: Optional[Registry] = None,
        events=None,
        checkpoint_dir: Optional[Path] = None,
        checkpoint_every: int = 0,
        store=None,
        megachunk: int = 0,
    ):
        self.backend = backend
        self.target = target
        self.mutator = mutator
        self.corpus = corpus
        self.crashes_dir = Path(crashes_dir) if crashes_dir else None
        if self.crashes_dir:
            self.crashes_dir.mkdir(parents=True, exist_ok=True)
        self.batch_size = batch_size or getattr(backend, "n_lanes", 1)
        # default onto the BACKEND's registry/events so runner spans nest
        # under this loop's execute phase and one dump carries everything
        self.registry, self.events = telemetry.resolve(
            backend, registry, events)
        # device-resident mutation engine (wtf_tpu_torch/devmut): the
        # whole mutate->insert phase moves onto the device and batches run
        # through _run_one_batch_device.  bind() raises early for
        # backends or targets that can't take the device path.
        self.mutate_on_device = bool(getattr(mutator, "is_device", False))
        if self.mutate_on_device:
            mutator.bind(backend, target, registry=self.registry,
                         events=self.events)
            mutator.seed_from(corpus)
        # multi-batch windows (wtf_tpu_torch/fuzz/megachunk.py):
        # generation + insert + the quiesce + the coverage merge + restore
        # over up to `megachunk` batches per call; host work per batch
        # collapses to the status pull and the crash/new-coverage harvest
        self.megachunk = int(megachunk or 0)
        if self.megachunk:
            if not self.mutate_on_device:
                raise ValueError(
                    "--megachunk needs the device mutation engine "
                    "(--mutator devmangle): generation must live on the "
                    "device for the window to fold it in")
            if not hasattr(backend, "run_megachunk"):
                raise ValueError(
                    "--megachunk requires the batched GpuBackend")
            if not getattr(backend, "limit", 0):
                raise ValueError(
                    "--megachunk needs a nonzero --limit: the window's "
                    "quiesce stops on the instruction budget")
        self._runs_budget = 0
        self.stats = CampaignStats(self.registry)
        self.stats_every = stats_every
        self.crash_names = set()
        # triage-grade crash dedup (triage/bucket.py): found crashes
        # bucket by (kind, faulting RIP, top-of-stack hash)
        self.crash_buckets = set()
        # overlay-exhausted testcases get ONE honest re-run (they executed
        # on truncated memory); a second exhaustion drops them
        self._requeue: list = []
        self._requeue_digests = set()
        self.batches_done = 0
        # crash-safe checkpointing (wtf_tpu_torch/resume): every
        # `checkpoint_every` batches the minimal resumable state lands in
        # `checkpoint_dir` atomically; a kill at any point costs at most
        # one checkpoint interval, and --resume replays bit-identically
        self.checkpoint_dir = Path(checkpoint_dir) if checkpoint_dir else None
        self.checkpoint_every = checkpoint_every
        # content-addressed corpus/crash store (wtf_tpu_torch/fleet/store):
        # when attached, finds and crashes are journaled there and the
        # flat outputs/ and crashes/ dirs become hardlink views
        self.store = store
        if store is not None and getattr(corpus, "store", None) is None:
            corpus.store = store
        # self-healing device runtime (wtf_tpu_torch/supervise): when the
        # backend's supervisor is armed, every batch runs under the
        # snapshot -> dispatch -> (recover + replay)* -> post_batch
        # wrapper in run_one_batch; the ladder attaches lazily at the
        # first batch (the backend may not be initialized yet here)
        self.supervisor = getattr(backend, "supervisor", None)
        if self.checkpoint_every and not hasattr(backend, "coverage_state"):
            # fail at construction, not at the first cadence hit deep
            # into a campaign (the checkpoint needs the batched backend's
            # device state seams)
            raise ValueError(
                "checkpointing requires the batched GpuBackend; this "
                "backend has no coverage_state seam")

    def _account(self, data: bytes, result: TestcaseResult,
                 requeue: bool = False, lane: Optional[int] = None) -> int:
        """Per-result accounting shared by fuzz and minset (they used to
        carry copy-pasted blocks of this): counters via CampaignStats,
        crash saving + events, optional overlay-full requeue.  Returns 1
        for a crash so batch loops can sum."""
        if not self.stats.account(result):
            if requeue and isinstance(result, OverlayFull):
                digest = hex_digest(data)
                if digest not in self._requeue_digests:
                    self._requeue_digests.add(digest)
                    self._requeue.append(data)
            return 0
        from wtf_tpu_torch.triage.bucket import bucket_of

        self._save_crash(data, result, bucket_of(self.backend, lane, result))
        return 1

    def _harvest_lane(self, lane: int, data: bytes, result: TestcaseResult,
                      requeue: bool = False, found_new=None) -> int:
        """The one per-lane harvest body shared by the host, device and
        megachunk batch paths: result accounting (+ optional overlay-full
        requeue) and the new-coverage -> corpus/mutator/event chain.
        `found_new` overrides the backend's last-batch flag for callers
        harvesting several batches at once (the megachunk window's
        per-batch flag rows).  Returns 1 for a crash."""
        crashes = self._account(data, result, requeue=requeue, lane=lane)
        if (self.backend.lane_found_new_coverage(lane)
                if found_new is None else found_new):
            self.stats.new_coverage += 1
            if self.corpus.add(data):
                self.mutator.on_new_coverage(data)
                self.events.emit("new-coverage", digest=hex_digest(data),
                                 size=len(data))
        return crashes

    def _emit_timeouts(self, timeouts_before: int) -> None:
        """Aggregated: one record per batch, not one per timed-out lane."""
        timeouts = self.stats.timeouts - timeouts_before
        if timeouts:
            self.events.emit("timeout", count=timeouts)

    def _restore_batch(self) -> None:
        with self.registry.spans.span("restore"):
            self.target.restore()
            self.backend.restore()

    def _supervised(self):
        """The armed supervisor, ladder attached — or None (the common,
        unsupervised case)."""
        sup = self.supervisor
        if sup is None or not sup.enabled:
            return None
        if sup.ladder is None:
            sup.attach_loop(self)
        return sup

    def run_one_batch(self) -> int:
        """Mutate, execute and harvest one batch; returns its crashes (for
        a megachunk window: the whole window's, and the window's extra
        completed batches advance `batches_done` here).

        Under supervision (wtf_tpu_torch/supervise) the batch body runs
        inside the recovery wrapper: a DispatchFailure (hang, device
        error, poisoned lane) rebuilds the device plane from the
        batch-boundary snapshot and REPLAYS the batch — bit-identical,
        because the failed attempt consumed no host randomness and its
        decode work is a prefix of the same deterministic stream."""
        sup = self._supervised()
        if sup is None:
            return self._dispatch_batch()
        from wtf_tpu_torch.supervise import DispatchFailure

        sup.pre_batch(self)
        attempts = 0
        while True:
            try:
                crashes = self._dispatch_batch()
            except DispatchFailure as failure:
                attempts += 1
                if attempts > sup.max_batch_retries:
                    raise
                sup.recover(self, failure)
                continue
            sup.post_batch(self)
            return crashes

    def _dispatch_batch(self) -> int:
        if self.mutate_on_device:
            sup = self.supervisor
            if self.megachunk and not (
                    sup is not None and sup.megachunk_disabled):
                return self._run_megachunk_window()
            return self._run_one_batch_device()
        spans = self.registry.spans
        with spans.span("mutate"):
            requeued, self._requeue = \
                self._requeue[:self.batch_size], []
            fresh = self.batch_size - len(requeued)
            if hasattr(self.mutator, "get_new_batch"):
                # native engines mutate the whole batch in one C call
                testcases = requeued + (self.mutator.get_new_batch(
                    self.corpus, fresh) if fresh else [])
            else:
                testcases = requeued + [
                    self.mutator.get_new_testcase(self.corpus)
                    for _ in range(fresh)]
        with spans.span("execute"):
            results = self.backend.run_batch(testcases, self.target)
        crashes = 0
        timeouts_before = self.stats.timeouts
        with spans.span("harvest"):
            for lane, (data, result) in enumerate(zip(testcases, results)):
                crashes += self._harvest_lane(lane, data, result,
                                              requeue=True)
        self._emit_timeouts(timeouts_before)
        self._restore_batch()
        return crashes

    def _run_one_batch_device(self) -> int:
        """The devmangle batch: generation and insertion are device work,
        so `mutate`'s host share is launch overhead and the device wait
        sits under the nested `mutate/device` span.  Double-buffered:
        batch N+1 is generated at the top of N's harvest, before N's
        finds enter the slab (it samples the slab as of N-1's finds — the
        one-batch lag of a pipelined generator).  Host code pulls only
        the lanes the harvest wants (crashes, new coverage); overlay-full
        requeue does not apply — the stream has no host bytes to
        requeue."""
        spans = self.registry.spans
        with spans.span("mutate"):
            with spans.span("device") as sp:
                _, lens = self.mutator.take_batch()
                sp.fence(lens)
        with spans.span("execute"):
            results = self.backend.run_batch_device(self.mutator,
                                                    self.target)
        crashes = 0
        timeouts_before = self.stats.timeouts
        with spans.span("harvest"):
            # double buffer: batch N+1 generates before N's finds land
            self.mutator.prelaunch()
            wanted = [lane for lane, result in enumerate(results)
                      if self.backend.lane_found_new_coverage(lane)
                      or isinstance(result, Crash)]
            datas = self.mutator.fetch(wanted)
            for lane, result in enumerate(results):
                crashes += self._harvest_lane(lane, datas.get(lane, b""),
                                              result)
        self._emit_timeouts(timeouts_before)
        self._restore_batch()
        return crashes

    def _run_megachunk_window(self) -> int:
        """One megachunk window: up to `self.megachunk` whole batches in
        one backend call (restore/mutate/insert/execute/merge on the
        device), then a host harvest of just the batches' finds.  The
        window is capped so batch boundaries still line up with the
        checkpoint cadence and the runs budget — a `--resume` from any
        such boundary stays bit-identical."""
        spans = self.registry.spans
        # a batch prelaunched by the batch-at-a-time path is dropped and
        # the cursor rewound, so the window regenerates that stream index
        self.mutator.cancel_pending()
        window = self.megachunk
        if self.checkpoint_every:
            window = min(window, self.checkpoint_every
                         - self.batches_done % self.checkpoint_every)
        if self._runs_budget:
            remaining = self._runs_budget - self.stats.testcases
            window = min(window, max(1, -(-int(remaining)
                                         // self.batch_size)))
        with spans.span("execute"):
            batches = self.backend.run_megachunk(
                self.mutator, self.target, self.megachunk, window)
        crashes = 0
        timeouts_before = self.stats.timeouts
        with spans.span("harvest"):
            for j, (results, flags, datas) in enumerate(batches):
                if j == len(batches) - 1:
                    # pin the NEXT window's entitled slab view BEFORE the
                    # final batch's finds enter the corpus — the
                    # batch-at-a-time prelaunch samples batch k+1's slab
                    # at exactly this point of batch k's harvest
                    self.mutator.snapshot_entitled_slab()
                for lane, result in enumerate(results):
                    crashes += self._harvest_lane(
                        lane, datas.get(lane, b""), result,
                        found_new=bool(flags[lane]))
        self._emit_timeouts(timeouts_before)
        with spans.span("restore"):
            # the machine restore is each batch's first phase inside the
            # window; only the target's host-side state rolls back here,
            # once per window
            self.target.restore()
        # fuzz() advances batches_done by one per run_one_batch; fold this
        # window's extra batches in
        self.batches_done += len(batches) - 1
        return crashes

    def _save_crash(self, data: bytes, result: Crash,
                    bucket: Optional[str] = None) -> None:
        name = result.name or f"crash-{hex_digest(data)[:16]}"
        bucket = bucket or name
        new = bucket not in self.crash_buckets
        self.crash_buckets.add(bucket)
        self.crash_names.add(name)
        if self.crashes_dir:
            from wtf_tpu_torch.utils.atomicio import atomic_write_bytes

            try:
                # atomic (tmp+fsync+rename): a kill mid-save must not
                # leave a torn repro, and a full disk must not abort the
                # campaign from inside the harvest loop.  With a store
                # the blob is journaled content-addressed (bucket-
                # deduped) and crashes/<name> becomes a view of it.
                if self.store is not None:
                    digest, _ = self.store.put(data, kind="crash",
                                               name=name, bucket=bucket)
                    if self.store.has(digest):
                        self.store.link_into(self.crashes_dir, digest,
                                             name=name)
                else:
                    atomic_write_bytes(self.crashes_dir / name, data)
            except OSError as e:
                import logging

                logging.getLogger(__name__).warning(
                    "crash save failed for %r: %s", name, e)
                self.events.emit("error", kind="crash-save", name=name,
                                 detail=str(e))
        self.events.emit("crash", name=name, size=len(data), new=new,
                         bucket=bucket)

    def _peek(self, name: str):
        """Counter value WITHOUT registering it — the heartbeat must not
        seed zero-valued metrics into dumps of campaigns that never
        touched the subsystem."""
        metric = self.registry._metrics.get(name)
        return metric.value if metric is not None else 0

    def steady_state_fields(self) -> dict:
        """The window campaign's steady-state numbers as heartbeat fields:
        the share of windows that needed no host decode service, and the
        device decoder's cross-check mismatches once it published.  Empty
        for campaigns that never ran a window.  (The JAX package's
        prelaunch fields stay out: the port does not prelaunch.)"""
        fields = {}
        windows = self._peek("megachunk.windows")
        if windows:
            fields["zero_host_window_rate"] = round(
                self._peek("devdec.zero_host_windows") / windows, 3)
        crosschecks = self._peek("devdec.crosscheck_mismatches")
        if self._peek("devdec.published") or crosschecks:
            fields["devdec_crosscheck_mismatches"] = crosschecks
        return fields

    def _heartbeat(self, print_stats: bool) -> None:
        """stats_every cadence: the stable human line + one JSONL
        heartbeat carrying the full registry dump (per-phase span totals
        included) + an atomic status.json refresh next to the event log
        (what `wtf-tpu status` tails on a live local campaign).  Window
        campaigns add the steady-state fields, and ` zh: N%` to the line;
        supervised campaigns the supervisor's rung and quarantine size."""
        fields = (self.supervisor.heartbeat_fields()
                  if self.supervisor is not None
                  and self.supervisor.enabled else {})
        steady = self.steady_state_fields()
        fields.update(steady)
        suffix = (f" zh: {steady['zero_host_window_rate']:.0%}"
                  if "zero_host_window_rate" in steady else "")
        line = self.stats.maybe_heartbeat(
            self.events, self.registry,
            lambda: self.stats.line(len(self.corpus), self._coverage())
            + suffix,
            every=self.stats_every, print_stats=print_stats, **fields)
        if line is not None:
            self._write_status(line)

    def _write_status(self, line: str) -> None:
        """status.json beside events.jsonl, atomically replaced every
        heartbeat — readers (wtf-tpu status --watch) always see either
        the previous complete document or this one, never a torn
        middle.  Best-effort like every telemetry side channel."""
        path = getattr(self.events, "path", None)
        if path is None:
            return
        import json

        from wtf_tpu_torch.utils.atomicio import atomic_write_text

        doc = {"kind": "campaign", "ts": time.time(), "line": line,
               "batches": self.batches_done,
               "metrics": self.registry.dump()}
        try:
            atomic_write_text(Path(path).parent / "status.json",
                              json.dumps(doc, default=str), fsync=False)
        except OSError:
            pass

    def minset(self, outputs_dir, print_stats: bool = False) -> Corpus:
        """`--runs=0` mode: replay the seed corpus exactly once — no
        mutation — and write the coverage-increasing subset to outputs/
        (the reference master's minset, server.h:552-556; seeds are
        visited biggest-first per Corpus.load_dir, so the subset is
        coverage-minimal under that ordering).  Returns the kept Corpus
        (callers prune subsumed stale files with its digest set).

        Runs on the triage batch-replay core
        (wtf_tpu_torch/triage/replay.py) — minset and `triage distill`
        share ONE batched execution path; the accounting, span names,
        keep rule (first-hit credit via the backend's batch merge) and
        printed stats are the fuzz loop's."""
        from wtf_tpu_torch.triage.replay import ReplayCore

        # Corpus handles digest-named persistence + dedup; outputs_dir=None
        # (no outputs configured) counts without writing
        kept = Corpus(outputs_dir=outputs_dir)
        core = ReplayCore(self.backend, self.target,
                          registry=self.registry, events=self.events,
                          batch_size=self.batch_size)

        def harvest(start, batch, results):
            for lane, (data, result) in enumerate(zip(batch, results)):
                self._account(data, result, lane=lane)
                if self.backend.lane_found_new_coverage(lane):
                    self.stats.new_coverage += 1
                    kept.add(data)

        core.replay(list(self.corpus), on_batch=harvest,
                    after_batch=lambda: self._heartbeat(print_stats))
        return kept

    def fuzz(self, runs: int, print_stats: bool = False,
             stop_on_crash: bool = False) -> CampaignStats:
        """Run until `runs` testcases executed (0 = forever; the CLI maps
        --runs=0 to `minset` instead, matching the reference)."""
        self._runs_budget = runs
        while runs == 0 or self.stats.testcases < runs:
            found = self.run_one_batch()
            self.batches_done += 1
            self._maybe_checkpoint()
            self._heartbeat(print_stats)
            if stop_on_crash and found:
                break
        return self.stats

    def _maybe_checkpoint(self) -> None:
        """--checkpoint-every cadence: persist the resumable state at the
        batch boundary (wtf_tpu_torch/resume).  Best-effort like every
        other persistence side channel — a full disk degrades
        checkpointing with a warning + error event, it never aborts the
        campaign."""
        if not (self.checkpoint_dir and self.checkpoint_every):
            return
        if self.batches_done % self.checkpoint_every:
            return
        from wtf_tpu_torch.resume import save_campaign

        spans = self.registry.spans
        before = spans.seconds("checkpoint")
        try:
            with spans.span("checkpoint"):
                info = save_campaign(self, self.checkpoint_dir)
        except OSError as e:
            import logging

            logging.getLogger(__name__).warning(
                "checkpoint write failed at batch %d: %s",
                self.batches_done, e)
            self.events.emit("error", kind="checkpoint-write",
                             batch=self.batches_done, detail=str(e))
            return
        self.registry.counter("campaign.checkpoints").inc()
        self.events.emit("checkpoint", batch=self.batches_done,
                         bytes=info["bytes"], path=info["path"],
                         seconds=round(spans.seconds("checkpoint")
                                       - before, 4))

    def _coverage(self) -> int:
        """Bits set in the aggregate coverage bitmap (the oracle backend,
        which keeps no bitmap: its aggregate rip set's size)."""
        import numpy as np

        agg = getattr(self.backend, "_agg_cov", None)
        if agg is None:
            return len(getattr(self.backend, "_aggregate_cov", ()))
        words = agg.cpu().numpy()
        return int(np.count_nonzero(np.unpackbits(words.view(np.uint8))))
