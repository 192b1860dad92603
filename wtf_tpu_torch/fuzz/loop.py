"""The standalone fuzz loop: mutate -> batch-execute -> harvest.

Copied from wtf_tpu/fuzz/loop.py and cut to the host-mutation batch path
this slice carries: the device mutation engine, megachunk windows,
supervision, checkpoint/resume, the fleet store, resharding, the minset
mode and the --xprof-dir profiler window are not part of it.

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
                      requeue: bool = False) -> int:
        """Per-lane harvest: result accounting (+ optional overlay-full
        requeue) and the new-coverage -> corpus/mutator/event chain.
        Returns 1 for a crash."""
        crashes = self._account(data, result, requeue=requeue, lane=lane)
        if self.backend.lane_found_new_coverage(lane):
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

    def run_one_batch(self) -> int:
        """Mutate, execute and harvest one batch; returns its crashes."""
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
                # campaign from inside the harvest loop
                atomic_write_bytes(self.crashes_dir / name, data)
            except OSError as e:
                import logging

                logging.getLogger(__name__).warning(
                    "crash save failed for %r: %s", name, e)
                self.events.emit("error", kind="crash-save", name=name,
                                 detail=str(e))
        self.events.emit("crash", name=name, size=len(data), new=new,
                         bucket=bucket)

    def _heartbeat(self, print_stats: bool) -> None:
        """stats_every cadence: the stable human line + one JSONL
        heartbeat carrying the full registry dump (per-phase span totals
        included) + an atomic status.json refresh next to the event log
        (what `wtf-tpu status` tails on a live local campaign)."""
        line = self.stats.maybe_heartbeat(
            self.events, self.registry,
            lambda: self.stats.line(len(self.corpus), self._coverage()),
            every=self.stats_every, print_stats=print_stats)
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

    def fuzz(self, runs: int, print_stats: bool = False,
             stop_on_crash: bool = False) -> CampaignStats:
        """Run until `runs` testcases executed (0 = forever)."""
        while runs == 0 or self.stats.testcases < runs:
            found = self.run_one_batch()
            self.batches_done += 1
            self._heartbeat(print_stats)
            if stop_on_crash and found:
                break
        return self.stats

    def _coverage(self) -> int:
        """Bits set in the aggregate coverage bitmap."""
        import numpy as np

        words = self.backend._agg_cov.cpu().numpy()
        return int(np.count_nonzero(np.unpackbits(words.view(np.uint8))))
