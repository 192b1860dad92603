"""Master node: testcase generation, coverage aggregation, corpus, crashes.

Reference `Server_t` (src/wtf/server.h): a single-threaded select() reactor
(Run server.h:361-598) in lock-step request/response with each client
(state machine server.h:249-255).  Semantics preserved here:

  - seed paths: inputs/ files are streamed to clients biggest-first before
    any mutation happens (server.h:399-414, :629-706)
  - GetTestcase: corpus-file replay first, else mutate (server.h:629-714)
  - HandleNewResult: merge client coverage into the global set; if it grew,
    feed the mutator cross-over and save the testcase into outputs/
    (server.h:785-886); named crashes saved under crashes/ (:861-877)
  - run budget: stop once `mutations >= runs` and no seed paths remain
    (server.h:552-556); `runs=0` = minset mode — only replay the seeds,
    outputs/ ends up holding the coverage-minimal subset (README.md:81-92)
  - elasticity: clients may join/leave anytime; a dropped fd is just
    removed from the reactor (server.h:534-544,605-623)

A copy of wtf_tpu/dist/server.py with its imports rewritten, plus two
phase spans in the master's registry: `serve` (drawing a node's next
testcases: seeds, then the mutator) and `intake` (decoding and
accounting a result frame: coverage merge, corpus admission, crash
saves).
"""

from __future__ import annotations

import hashlib
import logging
import re
import selectors
import socket
import struct
import time
from collections import deque
from pathlib import Path
from typing import Deque, Dict, List, Optional, Set

from wtf_tpu_torch.core.results import OverlayFull
from wtf_tpu_torch.dist import wire
from wtf_tpu_torch.utils.atomicio import atomic_write_bytes, atomic_write_text
from wtf_tpu_torch.fuzz.corpus import Corpus
from wtf_tpu_torch.fuzz.loop import CampaignStats
from wtf_tpu_torch.fuzz.mutator import Mutator
from wtf_tpu_torch.telemetry import NULL, Registry
from wtf_tpu_torch.utils.hashing import hex_digest
from wtf_tpu_torch.utils.human import number_to_human, seconds_to_human

log = logging.getLogger(__name__)


class ServerStats(CampaignStats):
    """Status-line counters (reference ServerStats_t, server.h:24-240).
    Registry-backed via CampaignStats — the master's numbers live in the
    same `campaign.*` namespace the fused loop uses, so one report tool
    reads both — plus the master-only lastcov age."""

    def __init__(self, registry: Optional[Registry] = None):
        super().__init__(registry)
        self.last_cov = time.time()

    def line(self, cov: int, corpus_len: int, clients: int) -> str:
        dt = time.time() - self.start
        execs = self.testcases / dt if dt > 0 else 0.0
        return (f"#{number_to_human(self.testcases)} cov: {cov} "
                f"corp: {corpus_len} exec/s: {execs:.1f} "
                f"nodes: {clients} lastcov: "
                f"{seconds_to_human(time.time() - self.last_cov)} "
                f"crash: {self.crashes} timeout: {self.timeouts} "
                f"cr3: {self.cr3s} uptime: {seconds_to_human(dt)}")


class _Conn:
    """Per-connection master state: slot count from the node's hello frame
    (1 = reference shape; >1 = lane-multiplexed batch frames), the
    testcases in flight on it, whether the node speaks tagged (v2)
    frames or coverage deltas (v3, with its client identity), and when
    the in-flight batch was sent (reclaim timeout)."""

    __slots__ = ("slots", "mux", "inflight", "tagged", "since", "delta",
                 "client_id")

    def __init__(self):
        self.slots = 1
        self.mux = False
        self.inflight: List[bytes] = []
        self.tagged = False
        self.since = 0.0
        self.delta = False
        self.client_id: Optional[str] = None


class Server:
    def __init__(
        self,
        address: str,
        mutator: Mutator,
        corpus: Corpus,
        inputs_dir: Optional[Path] = None,
        crashes_dir: Optional[Path] = None,
        runs: int = 0,
        max_len: int = 1024 * 1024,
        stats_every: float = 10.0,
        print_stats: bool = False,
        coverage_path: Optional[Path] = None,
        registry: Optional[Registry] = None,
        events=None,
        reclaim_timeout: float = 0.0,
        drain_grace: float = 5.0,
        store=None,
        cursor_cap: int = 4096,
        telemetry_dir: Optional[Path] = None,
    ):
        self.address = address
        self.mutator = mutator
        self.corpus = corpus
        self.crashes_dir = Path(crashes_dir) if crashes_dir else None
        if self.crashes_dir:
            self.crashes_dir.mkdir(parents=True, exist_ok=True)
        self.runs = runs
        self.max_len = max_len
        self.coverage_path = Path(coverage_path) if coverage_path else None
        self.registry = registry if registry is not None else Registry()
        self.events = events if events is not None else NULL
        self.stats = ServerStats(self.registry)
        self.stats_every = stats_every
        self.print_stats = print_stats
        # seed queue: inputs/ plus any prior campaign's outputs/ — a
        # restarted master resumes by replaying its persisted corpus
        # (SURVEY §5.4; reference server.h:399-414).  Entries are Paths
        # read lazily at serve time (a resumed multi-GB corpus must not
        # materialize in memory at startup); dirwatch injections are bytes.
        from wtf_tpu_torch.fuzz.corpus import seed_paths

        self._paths: Deque = deque(
            p for p, _ in seed_paths([inputs_dir, corpus.outputs_dir]))
        self._dirwatch = None
        self._dirwatch_last = 0.0
        if inputs_dir:
            # mid-campaign injection: operators drop seeds into inputs/
            # while the master runs (reference dirwatch.h); constructed
            # even when the dir doesn't exist yet — it may appear later
            from wtf_tpu_torch.fuzz.dirwatch import DirWatcher

            self._dirwatch = DirWatcher(inputs_dir)
        self.coverage: Set[int] = set()
        self.mutations = 0
        self.crash_names: Set[str] = set()
        # crash dedup service: keyed by the triage bucket when the
        # node reports one (WTF3 frames), by sanitized name otherwise —
        # only novel keys are persisted/announced
        self.crash_buckets: Set[str] = set()
        # content-addressed corpus/crash store (wtf_tpu_torch/fleet/store);
        # None keeps the flat-directory behavior
        self.store = store
        if store is not None:
            corpus.store = store
        self._ovf_requeued: Set[str] = set()
        self._ever_served = False
        # streaming-coverage ack cursors, keyed by client identity
        # (wtf_tpu_torch/fleet/delta.ServerCursor); persisted with the
        # coverage file so a restarted master resumes them instead of
        # forcing whole-bitmap resyncs.  `_restored` holds addresses
        # implied by restored state: part of the persisted/served
        # aggregate but NOT of the corpus-admission test, so the
        # replayed outputs/ corpus still re-earns its entries.
        self._cursors: Dict[str, object] = {}
        # eviction bound: a cursor is a near-copy of the address table
        # per client IDENTITY, and identities are fresh per node
        # process/link — without a cap, restarts accumulate dead tables
        # in memory and in the persisted coverage file forever.  LRU
        # over the cap, never a cursor with a live connection; an
        # evicted identity that comes back just pays one bitmap resync.
        self.cursor_cap = cursor_cap
        self._restored: Set[int] = set()
        self._cov_dirty = False
        self._last_persist = time.time()
        self._load_coverage_state()
        self._listener: Optional[socket.socket] = None
        self._clients: Dict[socket.socket, _Conn] = {}
        self._sel: Optional[selectors.BaseSelector] = None
        # fault tolerance: in-flight work of a dead or silent node is
        # reclaimed to the pending deque (`dist.reclaimed`); 0 disables
        # the silence timeout (drop-detection reclaim is always on)
        self.reclaim_timeout = reclaim_timeout
        # fleet observability: TAG_TELEM snapshots from WTF3 nodes merge
        # here (wtf_tpu_torch/fleet/telemetry); exports land next to the other
        # interval persistence when a telemetry dir is configured
        from wtf_tpu_torch.fleet.telemetry import FleetTelemetry

        self.fleet_telem = FleetTelemetry(export_dir=telemetry_dir)
        # SIGTERM drain: stop serving, give in-flight results this long
        # to land, persist, notify nodes, exit the reactor cleanly
        self.drain_grace = drain_grace
        self._draining = False
        self._drain_deadline: Optional[float] = None
        self.drained = False

    @property
    def paths(self) -> Deque:
        """Seed queue (deque: popleft each serve, prepend on requeue —
        a plain list's pop(0)/[:0] is quadratic under a large resumed
        corpus with churn).  Assignment accepts any iterable."""
        return self._paths

    @paths.setter
    def paths(self, items) -> None:
        self._paths = deque(items)

    # -- testcase generation (server.h:629-714) ----------------------------
    def _torn_corpus_file(self, path: Path, data: bytes) -> bool:
        """outputs/ entries are content-addressed (name == digest): a
        mismatch means the file was torn by a kill mid-write (pre-atomic
        writers, or an external copy).  A restarted master must skip it
        loudly, not replay garbage or abort the whole resume."""
        if self.corpus.outputs_dir is None \
                or path.parent != self.corpus.outputs_dir:
            return False  # inputs/ names are operator-chosen: no contract
        name = path.name
        if len(name) != 64 or any(c not in "0123456789abcdef"
                                  for c in name):
            return False
        # the SAME digest Corpus.add names outputs/ files with — an
        # inline hash here would silently disagree if the content-digest
        # choice ever changes, and then "skip torn files" would discard
        # the entire persisted corpus on restart
        return hex_digest(data) != name

    def _next_seed(self) -> Optional[bytes]:
        while self.paths:
            item = self.paths.popleft()
            if isinstance(item, Path):
                try:
                    data = item.read_bytes()
                except OSError:
                    continue  # vanished since the startup scan
                if self._torn_corpus_file(item, data):
                    log.warning("skipping torn corpus file %s "
                                "(content fails its digest name)", item)
                    self.events.emit("error", kind="torn-corpus-file",
                                     path=str(item), size=len(data))
                    continue
                return data[:self.max_len]
            return item[:self.max_len]
        return None

    def get_testcase(self) -> Optional[bytes]:
        seed = self._next_seed()
        if seed is not None:
            return seed
        if self.runs and self.mutations >= self.runs:
            return None
        if self.runs == 0:
            return None  # minset mode: seeds only (server.h:552-556)
        self.mutations += 1
        return self.mutator.get_new_testcase(self.corpus)[:self.max_len]

    def done(self) -> bool:
        outstanding = any(conn.inflight for conn in self._clients.values())
        if outstanding:
            return False
        gen_done = self.mutations >= self.runs if self.runs else True
        if not gen_done:
            return False
        if self.paths:
            # original seed FILES (lazy Paths) always wait for a client to
            # (re)connect — a mid-replay disconnect must not end a minset
            # with the bulk unserved.  Only requeued/injected BYTE entries
            # (in-flight testcases of dead clients) are treated as lost
            # once every client is gone, as in the reference.
            if any(isinstance(item, Path) for item in self.paths):
                return False
            return self._ever_served and not self._clients
        return True

    # -- result handling (server.h:785-886) --------------------------------
    def handle_result(self, body: bytes) -> None:
        self._account_result(*wire.decode_result(body))

    def _account_result(self, testcase, coverage, result,
                        bucket: str = "") -> None:
        new = coverage - self.coverage
        if new:
            self.coverage |= new
            self._cov_dirty = self._cov_dirty or bool(new - self._restored)
            self.stats.last_cov = time.time()
            self.stats.new_coverage += 1  # same per-testcase semantics as
            self.mutator.on_new_coverage(testcase)  # FuzzLoop's counter
            self.corpus.add(testcase)
            self.events.emit("new-coverage", new_addresses=len(new),
                             total=len(self.coverage), size=len(testcase))
        if self.stats.account(result):
            self._save_crash(testcase, result, bucket)
        elif isinstance(result, OverlayFull):
            # node resource limit, not a finding: requeue ONCE for an
            # honest re-run (ideally on a node with more overlay slots);
            # never saved under crashes/, never bounced forever
            digest = hashlib.blake2b(testcase, digest_size=16).hexdigest()
            if digest not in self._ovf_requeued:
                self._ovf_requeued.add(digest)
                self.paths.append(testcase)

    def _save_crash(self, testcase: bytes, result, bucket: str) -> None:
        """Crash intake: dedup by triage bucket (reported by WTF3 nodes;
        sanitized name otherwise), persist only novel keys, and name the
        file from the digest of the BYTES — the one hex_digest source of
        truth, same as the torn-corpus check — so a malicious or buggy
        node can neither steer the write path nor collide/overwrite
        another node's crash file with a chosen name."""
        if not result.name:
            return
        # the name crossed the WIRE: whitelist-sanitize before any use
        # (events, store journal) — never trusted as a filename anymore
        name = re.sub(r"[^A-Za-z0-9._-]", "_",
                      result.name).lstrip(".")[:200] or "crash-unnamed"
        self.crash_names.add(name)
        key = bucket or name
        if key in self.crash_buckets:
            # known bucket: counted in the stats, but neither persisted
            # nor announced — the dedup half of the crash service
            self.registry.counter("fleet.bucket_dedup").inc()
            return
        self.crash_buckets.add(key)
        digest = hex_digest(testcase)
        self.events.emit("crash", name=name, size=len(testcase),
                         digest=digest, bucket=bucket or None, new=True)
        try:
            if self.store is not None:
                self.store.put(testcase, kind="crash", name=name,
                               bucket=bucket or None)
                if self.crashes_dir:
                    # flat digest-named view for operators/old tooling
                    self.store.link_into(self.crashes_dir, digest)
            elif self.crashes_dir:
                # atomic (tmp+fsync+rename): a kill mid-save must not
                # leave a torn repro under crashes/
                atomic_write_bytes(self.crashes_dir / digest, testcase)
        except (OSError, ValueError) as e:
            log.warning("crash save failed for %r: %s", name, e)
            self.events.emit("error", kind="crash-save",
                             name=name, detail=str(e))

    # -- drain (SIGTERM) ---------------------------------------------------
    def request_drain(self) -> None:
        """Graceful-shutdown request (SIGTERM handler, or any thread):
        stop serving new testcases, give in-flight results `drain_grace`
        seconds to land, persist, notify nodes (BYE on tagged
        connections), and return from run() with `drained` set.  Safe to
        call from a signal handler — it only flips a flag the reactor
        polls."""
        self._draining = True

    def _drain_step(self, now: float) -> bool:
        """True when the drain is complete and the reactor should exit."""
        if self._drain_deadline is None:
            self._drain_deadline = now + self.drain_grace
            outstanding = sum(len(c.inflight)
                              for c in self._clients.values())
            log.warning("drain requested: %d client(s), %d in-flight "
                        "testcase(s), grace %.1fs",
                        len(self._clients), outstanding, self.drain_grace)
            self.events.emit("drain", clients=len(self._clients),
                             inflight=outstanding,
                             grace_seconds=self.drain_grace)
        if not any(c.inflight for c in self._clients.values()):
            return True
        return now > self._drain_deadline

    # -- reactor (server.h:361-598) ----------------------------------------
    def run(self, max_seconds: Optional[float] = None) -> ServerStats:
        """Event loop on `selectors` (epoll on Linux) — unlike the
        reference's select() reactor (server.h:386-389) there is no
        FD_SETSIZE ceiling, so thousands of 1-fd-per-lane nodes work; a
        multiplexed node (wire.encode_hello(n) with n > 1) needs only ONE
        fd for a whole lane batch on top of that."""
        self._listener = wire.listen(self.address)
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._listener, selectors.EVENT_READ)
        deadline = time.time() + max_seconds if max_seconds else None
        restore_sigterm = self._install_sigterm()
        try:
            while True:
                if self.done():
                    break
                now = time.time()
                if self._draining and self._drain_step(now):
                    self.drained = True
                    break
                if deadline and now > deadline:
                    break
                for key, events in self._sel.select(timeout=0.5):
                    sock = key.fileobj
                    if sock is self._listener:
                        conn, _ = self._listener.accept()
                        self._clients[conn] = _Conn()
                        # not writable until the hello names its slot count
                        self._sel.register(conn, selectors.EVENT_READ)
                        continue
                    if sock not in self._clients:
                        continue  # dropped earlier in this pass
                    if events & selectors.EVENT_WRITE:
                        self._feed(sock)
                    if (events & selectors.EVENT_READ
                            and sock in self._clients):
                        self._on_readable(sock)
                now = time.time()
                if self.reclaim_timeout:
                    self._reclaim_silent(now)
                if (self._dirwatch is not None
                        and now - self._dirwatch_last >= 1.0):
                    # throttled: a directory scan per reactor pass would
                    # steal time from serving nodes on a hot master
                    self._dirwatch_last = now
                    injected = []
                    for path in self._dirwatch.poll():
                        try:
                            injected.append(path.read_bytes()[:self.max_len])
                        except OSError:
                            continue  # vanished after the scan
                    # prepend: freshly dropped seeds are served next,
                    # ahead of any undrained initial corpus
                    self.paths.extendleft(reversed(injected))
                self._maybe_print()
                if now - self._last_persist >= self.stats_every:
                    # interval persistence (dirty-flagged: no-op when the
                    # aggregate and cursors are unchanged) — what lets a
                    # restarted master resume client ack cursors
                    self._last_persist = now
                    self._evict_cursors()
                    self._write_coverage()
                    self.fleet_telem.write_exports()
        finally:
            restore_sigterm()
            for sock, conn in list(self._clients.items()):
                # orderly end (budget done / drain): tell v2 nodes not to
                # reconnect-retry against the closing listener
                if conn.tagged:
                    try:
                        wire.send_bye(sock)
                    except OSError:
                        pass
                sock.close()
            self._clients.clear()
            self._sel.close()
            self._sel = None
            self._listener.close()
            self._listener = None
            self._write_coverage(final=True)
            self.fleet_telem.close()
        return self.stats

    def _install_sigterm(self):
        """SIGTERM -> request_drain, main thread only (signal.signal
        raises elsewhere; threaded embedders call request_drain
        directly).  Returns a restore callable for the finally block."""
        import signal
        import threading

        if threading.current_thread() is not threading.main_thread():
            return lambda: None
        previous = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            self.request_drain()

        try:
            signal.signal(signal.SIGTERM, _on_term)
        except (ValueError, OSError):
            return lambda: None
        return lambda: signal.signal(signal.SIGTERM, previous)

    def _reclaim_silent(self, now: float) -> None:
        """Heartbeat-timeout reclaim: a node holding in-flight testcases
        in silence past `reclaim_timeout` is presumed dead (wedged chip,
        half-open TCP after a power cut) — its work goes back to the
        pending deque and the connection drops.  A merely-slow node
        reconnects and keeps serving; its late results are simply lost
        with the closed socket, so nothing double-counts."""
        for sock, conn in list(self._clients.items()):
            if conn.inflight and now - conn.since > self.reclaim_timeout:
                log.warning("reclaiming %d testcase(s) from silent node "
                            "(%.1fs > %.1fs timeout)", len(conn.inflight),
                            now - conn.since, self.reclaim_timeout)
                self._drop(sock, reason="timeout")

    def _load_coverage_state(self) -> None:
        """Resume the delta ack cursors (and the aggregate they imply)
        from a prior master's coverage file: a reconnecting WTF3 node
        whose cursor still matches resumes sparse deltas instead of a
        whole-bitmap resync.  Restored addresses land in `_restored`
        (served/persisted, but corpus admission still re-earns through
        the outputs/ replay).  Best-effort: an unreadable or pre-fleet
        file simply starts fresh."""
        if self.coverage_path is None or not self.coverage_path.exists():
            return
        import json

        from wtf_tpu_torch.fleet.delta import ServerCursor

        try:
            doc = json.loads(self.coverage_path.read_text(encoding="utf-8"))
            cursors = doc.get("cursors", {})
            for cid, state in cursors.items():
                self._cursors[cid] = ServerCursor.from_state(state)
            self._restored = set(int(a) for a in doc.get("addresses", []))
        except (ValueError, KeyError, OSError) as e:
            log.warning("coverage state unusable (%s); starting fresh", e)
            self._cursors = {}
            self._restored = set()
            return
        if self._cursors:
            self.registry.counter("fleet.cursor_resumes").inc(
                len(self._cursors))
            self.events.emit("cursor-resume", clients=len(self._cursors),
                             addresses=len(self._restored))

    def _write_coverage(self, final: bool = False) -> None:
        """Persist the aggregate coverage in the .cov JSON shape
        (reference coverage.cov aggregate, README.md:166; integer
        addresses per the gen_coveragefile_* format) plus the per-client
        delta ack cursors, so campaigns resume/compare offline and a
        restarted master resumes cursors.  Dirty-flagged: an interval
        where nothing changed costs no write.  Best-effort: also runs in
        the reactor's finally block and must not mask an in-flight
        exception."""
        if self.coverage_path is None:
            return
        if not self._cov_dirty and not (final
                                        and not self.coverage_path.exists()):
            return
        import json

        doc = {
            "name": "aggregate",
            "addresses": sorted(self.coverage | self._restored),
        }
        if self._cursors:
            doc["cursors"] = {cid: cur.state()
                              for cid, cur in self._cursors.items()}
        try:
            # atomic (utils/atomicio): a kill mid-write must leave the
            # previous coverage file intact, never a torn JSON — this is
            # the file a resumed/offline analysis reads
            atomic_write_text(self.coverage_path, json.dumps(doc))
            self._cov_dirty = False
            self.registry.counter("fleet.coverage_writes").inc()
        except OSError as e:
            log.warning("coverage.cov write failed: %s", e)
            self.events.emit("error", kind="coverage-write",
                             path=str(self.coverage_path), detail=str(e))

    def _set_writable(self, sock: socket.socket, want: bool) -> None:
        events = selectors.EVENT_READ | (selectors.EVENT_WRITE if want else 0)
        self._sel.modify(sock, events)

    def _feed(self, sock: socket.socket) -> None:
        conn = self._clients[sock]
        if self._draining:
            # drain: no new work leaves the master; the node is told to
            # go away for good (BYE) instead of reconnect-retrying
            self._drop(sock, bye=True)
            return
        batch: List[bytes] = []
        with self.registry.spans.span("serve"):
            while len(batch) < conn.slots:
                testcase = self.get_testcase()
                if testcase is None:
                    break
                batch.append(testcase)
        if not batch:
            # no work at all (budget exhausted / seeds drained): close the
            # idle client now — a batch node would otherwise block on this
            # socket while the master waits for its siblings (tail deadlock)
            self._drop(sock, bye=True)
            return
        try:
            if conn.mux:
                wire.send_work(sock, wire.encode_batch(batch), conn.tagged)
            else:
                wire.send_work(sock, batch[0], conn.tagged)
            conn.inflight = batch  # in-flight until their results return
            conn.since = time.time()
            self._ever_served = True
            self._set_writable(sock, False)
        except OSError:
            # undelivered: requeue (budget stays consumed — the requeued
            # entries re-serve from paths without a new mutation, so the
            # campaign executes exactly `runs` testcases as long as any
            # client remains connected; elasticity, server.h:534-544)
            self._clients[sock].inflight = []
            self._drop(sock)
            self.paths.extendleft(reversed(batch))

    def _on_readable(self, sock: socket.socket) -> None:
        conn = self._clients[sock]
        try:
            body = wire.recv_msg(sock)
        except (OSError, ValueError):
            body = None
        if body is None:
            self._drop(sock)
            return
        n_slots = wire.decode_hello(body)
        if n_slots is not None:
            conn.slots = max(1, n_slots)
            conn.mux = conn.slots > 1
            conn.tagged = wire.hello_is_tagged(body)
            client_id = wire.hello_client_id(body)
            if client_id is not None:
                conn.delta = True
                conn.client_id = client_id.hex()
                cursor = self._cursor_for(conn)
                try:
                    # name the ack cursor we hold for this identity so a
                    # reconnecting node resumes sparse deltas (or learns
                    # it must resync) BEFORE any work flows
                    wire.send_msg(sock, wire.encode_cursor(
                        *cursor.summary()))
                except OSError:
                    self._drop(sock)
                    return
            if not conn.inflight:
                self._set_writable(sock, True)  # greeted: open for work
            return
        if conn.delta and body and body[0] == wire.TAG_TELEM:
            # observability frame: no slot accounting, no writability
            # change — it rides BETWEEN work exchanges.  Malformed telem
            # is dropped without dropping the node (it carries no
            # campaign state, unlike a malformed result frame).
            self._handle_telem(conn, body[1:])
            return
        try:
            # decode EVERYTHING before accounting ANYTHING: a malformed
            # tail in a mux batch must not leave already-counted results
            # that then get requeued (double execution, stat skew)
            with self.registry.spans.span("intake"):
                if conn.delta:
                    items = self._decode_delta_frame(conn, body)
                elif conn.mux:
                    items = [wire.decode_result(b) + ("",)
                             for b in wire.decode_batch(body)]
                else:
                    items = [wire.decode_result(body) + ("",)]
        except (ValueError, IndexError, struct.error) as e:
            # desynced/malformed result frame: a broken node must not
            # take the master down — drop it, requeue its in-flight work.
            # Loudly: if every node trips this, the fleet has a wire
            # mismatch and the operator needs to see it.
            log.warning("dropping node (malformed result frame: %r); "
                        "requeueing %d in-flight testcase(s)",
                        e, len(conn.inflight))
            self.events.emit("error", kind="malformed-frame",
                             detail=repr(e), requeued=len(conn.inflight))
            self._drop(sock)
            return
        with self.registry.spans.span("intake"):
            for item in items:
                self._account_result(*item)
        conn.inflight = []
        self._set_writable(sock, True)

    def _handle_telem(self, conn: _Conn, payload: bytes) -> None:
        """One TAG_TELEM frame: merge the node's cumulative snapshot into
        the fleet aggregate, keyed by its WTF3 client identity.  The seq
        check inside the aggregator makes re-sent frames (reconnect
        replays, reclaim races) free of double-counting."""
        try:
            seq, snapshot, events = wire.decode_telem(payload)
        except (ValueError, KeyError, struct.error,
                UnicodeDecodeError) as e:
            self.registry.counter("fleet.telem_errors").inc()
            self.events.emit("error", kind="malformed-telem",
                             detail=repr(e))
            return
        applied = self.fleet_telem.apply(conn.client_id, seq, snapshot,
                                         events)
        self.registry.counter("fleet.telem_frames").inc()
        if not applied:
            self.registry.counter("fleet.telem_duplicates").inc()

    def _cursor_for(self, conn: _Conn):
        from wtf_tpu_torch.fleet.delta import ServerCursor

        cursor = self._cursors.get(conn.client_id)
        if cursor is None:
            cursor = self._cursors[conn.client_id] = ServerCursor()
        cursor.touch()
        return cursor

    def _evict_cursors(self) -> None:
        """Drop the least-recently-active cursors over `cursor_cap`,
        skipping identities with a live connection.  An evicted node
        that reconnects sees a fresh cursor and performs one
        whole-bitmap resync — slower, never wrong."""
        over = len(self._cursors) - self.cursor_cap
        if over <= 0:
            return
        live = {conn.client_id for conn in self._clients.values()
                if conn.client_id}
        victims = sorted(
            (cid for cid in self._cursors if cid not in live),
            key=lambda cid: self._cursors[cid].last_seen)[:over]
        for cid in victims:
            del self._cursors[cid]
        if victims:
            self._cov_dirty = True
            self.registry.counter("fleet.cursor_evictions").inc(
                len(victims))

    def _decode_delta_frame(self, conn: _Conn, body: bytes) -> List[tuple]:
        """One WTF3 upstream frame -> [(testcase, addresses, result,
        bucket)].  Applying a delta mutates only the CURSOR (idempotent
        set-union state); master accounting happens strictly after the
        whole frame decoded+mapped, so a malformed tail still accounts
        nothing and the re-served testcases re-send their bits."""
        if not body or body[0] != wire.TAG_COVDELTA:
            raise ValueError("untagged frame on a delta connection")
        payload = body[1:]
        bodies = wire.decode_batch(payload) if conn.mux else [payload]
        decoded = [wire.decode_result_delta(b) for b in bodies]
        cursor = self._cursor_for(conn)
        items = []
        changed = False
        for testcase, delta, result, bucket in decoded:
            if delta.full:
                self.registry.counter("fleet.full_resyncs").inc()
            changed = changed or delta.full or bool(delta.pairs) \
                or bool(delta.addrs)
            items.append((testcase, cursor.apply(delta), result, bucket))
        self.registry.counter("fleet.delta_frames").inc(len(bodies))
        self.registry.counter("fleet.delta_bytes").inc(len(body))
        if changed:
            self._cov_dirty = True
        return items

    def _drop(self, sock: socket.socket, bye: bool = False,
              reason: str = "drop") -> None:
        # a dying client's in-flight testcases are re-served to others —
        # the reclaim that makes node death cost retransmission, not work
        conn = self._clients.pop(sock, None)
        if conn is not None and conn.inflight:
            self.paths.extendleft(reversed(conn.inflight))
            self.registry.counter("dist.reclaimed").inc(len(conn.inflight))
            self.events.emit("reclaim", count=len(conn.inflight),
                             reason=reason)
        if bye and conn is not None and conn.tagged:
            # orderly goodbye: a v2 node stops reconnect-retrying
            try:
                wire.send_bye(sock)
            except OSError:
                pass
        try:
            self._sel.unregister(sock)
        except (KeyError, ValueError):
            pass
        sock.close()

    def _maybe_print(self) -> None:
        self.stats.maybe_heartbeat(
            self.events, self.registry,
            lambda: self.stats.line(len(self.coverage), len(self.corpus),
                                    len(self._clients)),
            every=self.stats_every, print_stats=self.print_stats,
            nodes=len(self._clients))
