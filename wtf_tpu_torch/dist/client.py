"""Fuzz node: dial the master, execute testcases, report coverage+result.

Reference `Client_t` (src/wtf/client.cc): Run (:210-263) = Target.Init once,
Dial, then loop { Receive testcase -> RunTestcaseAndRestore -> SendResult }.
`run_testcase_and_restore` below is the canonical per-testcase sequence
(client.cc:88-180): InsertTestcase -> Run -> (Timedout? revoke coverage)
-> Target.Restore -> Backend.Restore.

Two node shapes:

  Client      - one connection, one testcase at a time (any Backend; the
                reference's process-per-core model)
  BatchClient - one *lane batch* per round against a GpuBackend: opens
                n_lanes connections so the master remains completely
                unmodified (the north-star property — the master cannot
                tell a GPU node from n_lanes ordinary clients), collects one
                testcase per connection, runs them as one device batch, and
                replies on each connection with that lane's coverage delta.

A copy of wtf_tpu/dist/client.py with its imports rewritten, plus the
node's phase spans in its registry: `wire-recv` (waiting for and reading
work, reconnects included), `execute` (the testcase or the device batch,
with the backend's own spans beneath it), `harvest` (results, coverage
and crash buckets into reply bodies; on the one-link-per-lane shape each
lane's send too, as the reference sends it as soon as it is encoded),
`wire-send` and `restore`.
"""

from __future__ import annotations

import logging
import random
import time
from typing import List, Optional, Set, Tuple

from wtf_tpu_torch.core.results import (
    Crash, OverlayFull, TestcaseResult, Timedout,
)


def _coverage_revoked(result) -> bool:
    """Results whose coverage must not be reported (client.cc:122-125;
    overlay-full lanes ran on truncated memory): the delta path must
    also not piggyback unacked-bit repair on them — the master credits
    any new addresses on a frame to THAT frame's testcase."""
    return isinstance(result, (Timedout, OverlayFull))
from wtf_tpu_torch.dist import wire
from wtf_tpu_torch.fuzz.loop import CampaignStats
from wtf_tpu_torch import telemetry
from wtf_tpu_torch.telemetry import NULL, Registry

log = logging.getLogger(__name__)


class MasterLink:
    """One resilient master connection: dial + tagged hello, transparent
    reconnect with jittered exponential backoff bounded by
    `max_retry_secs` (0 = reference behavior: any loss ends the node).

    The re-handshake story: on socket loss the master reclaims this
    link's in-flight testcases (dist/server.py _drop) and re-serves them
    elsewhere, so the link never resends anything — it reconnects, says
    hello again, and asks for fresh work.  An unsent result is simply
    abandoned: its testcase re-executes somewhere, the master counts it
    once.  A TAG_BYE frame is the orderly end (budget done / drain) and
    permanently stops reconnection."""

    BACKOFF_BASE = 0.05
    BACKOFF_CAP = 2.0

    def __init__(self, address: str, n_slots: int = 1,
                 max_retry_secs: float = 0.0,
                 registry: Optional[Registry] = None, events=None,
                 rng: Optional[random.Random] = None,
                 tagged: bool = True, cursor=None):
        self.address = address
        self.n_slots = n_slots
        self.max_retry_secs = max_retry_secs
        self.registry = registry if registry is not None else Registry()
        self.events = events if events is not None else NULL
        self.rng = rng if rng is not None else random.Random()
        # tagged=False = full legacy (v1) wire behavior against a master
        # that predates WTF2: raw downstream frames, no BYE — and
        # therefore NO reconnect (a clean close is indistinguishable
        # from an orderly end on v1, so retrying would spin against a
        # finished master).  The rolling-upgrade escape hatch
        # (`fuzz --wire-v1`).
        self.tagged = tagged
        # streaming-coverage cursor (wtf_tpu_torch/fleet/delta.DeltaCursor):
        # upgrades the hello to WTF3 and every upstream result to a
        # TAG_COVDELTA frame; the link drives the cursor's handshake
        # (TAG_CURSOR after (re)connect) and implicit acks (each WORK
        # frame proves the master accounted everything sent before it)
        self.cursor = cursor if tagged else None
        self.sock = None
        self._bye = False

    def connect(self, retry_for: float = 10.0) -> None:
        """Initial dial + hello (the node-before-master startup race is
        covered by wire.dial's own transient retry window)."""
        self._drop_socket()  # never strand a previous fd
        sock = wire.dial(self.address, retry_for=retry_for)
        try:
            if self.cursor is not None:
                hello = wire.encode_hello_delta(self.n_slots,
                                                self.cursor.client_id)
            else:
                hello = wire.encode_hello(self.n_slots, tagged=self.tagged)
            wire.send_msg(sock, hello)
        except OSError:
            # hello lost with the connection (master died between accept
            # and read — the crash-loop shape): close, don't leak the fd
            # once per backoff attempt
            sock.close()
            raise
        self.sock = sock

    def close(self) -> None:
        if self.sock is not None:
            self.sock.close()
            self.sock = None

    def _drop_socket(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None

    def _reconnect(self) -> bool:
        """Backoff-reconnect within the retry budget; True once the
        re-handshake landed.  Every attempt is a `dist.retries` count and
        a `retry` event — the fleet's flap rate is an ops signal."""
        if self.max_retry_secs <= 0 or self._bye or not self.tagged:
            return False
        deadline = time.monotonic() + self.max_retry_secs
        delay = self.BACKOFF_BASE
        attempt = 0
        while time.monotonic() < deadline:
            attempt += 1
            self.registry.counter("dist.retries").inc()
            self.events.emit("retry", attempt=attempt,
                             address=self.address)
            try:
                self.connect(retry_for=0.0)
            except OSError:
                # jittered exponential backoff: a thousand nodes losing
                # one master must not reconnect in lockstep
                remaining = deadline - time.monotonic()
                sleep = min(delay, max(remaining, 0.0)) \
                    * (0.5 + self.rng.random() * 0.5)
                if sleep > 0:
                    time.sleep(sleep)
                delay = min(delay * 2, self.BACKOFF_CAP)
                continue
            log.warning("reconnected to master after %d attempt(s)",
                        attempt)
            self.events.emit("reconnect", attempts=attempt,
                             address=self.address)
            return True
        log.warning("master gone for > %.1fs; giving up",
                    self.max_retry_secs)
        return False

    def recv_work(self) -> Optional[bytes]:
        """The next work payload (testcase, or batch frame for mux
        links); None = campaign over — BYE received, or the connection
        died and the retry budget is spent."""
        while True:
            if self.sock is None and not self._reconnect():
                return None
            try:
                if self.tagged:
                    got = wire.recv_tagged(self.sock)
                else:
                    payload = wire.recv_msg(self.sock)
                    got = (None if payload is None
                           else (wire.TAG_WORK, payload))
            except (OSError, ValueError):
                got = None  # reset / desynced frame
            if got is None:
                # lost mid-campaign (or master closed without BYE, which
                # for a retrying node means "maybe it restarts")
                self._drop_socket()
                if not self._reconnect():
                    return None
                continue
            tag, payload = got
            if tag == wire.TAG_BYE:
                self._bye = True
                self._drop_socket()
                return None
            if tag == wire.TAG_CURSOR and self.cursor is not None:
                # the master names the ack cursor it holds for us:
                # resume sparse deltas or fall back to a bitmap resync.
                # A truncated frame (desynced master) is a connection
                # problem, not a node-fatal one — same error surface as
                # the master's own frame decode.
                import struct as _struct

                try:
                    self.cursor.on_cursor(*wire.decode_cursor(payload))
                except (ValueError, IndexError, _struct.error):
                    self._drop_socket()
                    if not self._reconnect():
                        return None
                continue
            if self.cursor is not None:
                # a WORK frame is the implicit ack: the master only
                # serves after accounting our previous result frame
                self.cursor.on_ack()
            return payload

    def send_delta(self, body: bytes) -> bool:
        """Send one TAG_COVDELTA frame (delta-result body, or a batch
        frame of them on mux links)."""
        return self.send(bytes((wire.TAG_COVDELTA,)) + body)

    def send_telem(self, body: bytes) -> bool:
        """Send one TAG_TELEM frame (wire.encode_telem body).  WTF3
        links only — v1/v2 masters would read the tag byte as the start
        of a result body.  Best-effort like every upstream send: a lost
        snapshot is superseded by the next one (they are cumulative)."""
        if self.cursor is None:
            return False
        return self.send(bytes((wire.TAG_TELEM,)) + body)

    def send(self, body: bytes) -> bool:
        """Best-effort result send.  On failure the socket drops and the
        result is abandoned (see class docstring); the next recv_work
        reconnects.  Returns False when the send was lost."""
        if self.sock is None:
            return False
        try:
            wire.send_msg(self.sock, body)
            return True
        except OSError:
            self._drop_socket()
            return False


class _NodeTelemetry:
    """Shared node-side telemetry: the same `campaign.*` counters and
    heartbeat line shape as the fused loop/master (cov/corp omitted — a
    node doesn't track them), wired identically for both node shapes.

    WTF3 nodes additionally ship a TAG_TELEM frame on the heartbeat
    cadence: the node's CUMULATIVE Registry.snapshot() plus a digest of
    recent node events, sequence-numbered so the master's aggregator
    stays idempotent under reconnect replays.  Emission rides the
    EXISTING heartbeat throttle — snapshot serialization never touches
    the per-testcase (or per-batch dispatch) path, which the telemetry
    lint family pins statically."""

    def _init_telemetry(self, backend, registry, events,
                        stats_every: float, print_stats: bool) -> None:
        self.registry, self.events = telemetry.resolve(
            backend, registry, events)
        # recent-event digest ring: node-level events (retry/reconnect/
        # crash/...) tap in here on their way to the JSONL sink and ride
        # the next telem frame upstream
        from collections import deque

        from wtf_tpu_torch.telemetry import TapEventLog

        self._recent_events = deque(maxlen=64)
        self.events = TapEventLog(self.events, self._tap_event)
        self.stats = CampaignStats(self.registry)
        self.stats_every = stats_every
        self.print_stats = print_stats
        self._telem_seq = 0
        self._telem_last = 0.0
        self._telem_link: Optional[MasterLink] = None

    def _tap_event(self, type_: str, fields: dict) -> None:
        if type_ == "heartbeat":
            return  # carried whole by the telem frame itself
        digest = {"type": type_}
        for key in ("name", "kind", "count", "attempts", "bucket"):
            if key in fields:
                digest[key] = fields[key]
        self._recent_events.append(digest)

    def _heartbeat(self) -> None:
        self.stats.maybe_heartbeat(self.events, self.registry,
                                   every=self.stats_every,
                                   print_stats=self.print_stats)
        # telem emission has its OWN throttle: a node with no local
        # event log (maybe_heartbeat early-returns there) still reports
        # to the master's fleet plane
        now = time.time()
        if now - self._telem_last >= self.stats_every:
            self._telem_last = now
            self._send_telem()

    def _send_telem(self) -> None:
        """One TAG_TELEM frame on the designated WTF3 link (no-op for
        v1/v2 wire shapes — those masters predate the frame)."""
        link = self._telem_link
        if link is None or link.cursor is None:
            return
        self._telem_seq += 1
        recent = list(self._recent_events)
        if link.send_telem(wire.encode_telem(
                self._telem_seq, self.registry.snapshot(), recent)):
            self._recent_events.clear()
            self.registry.counter("dist.telem_sent").inc()


def run_testcase_and_restore(backend, target, data: bytes,
                             want_bucket: bool = False):
    """The canonical sequence (client.cc:88-180).  `want_bucket` adds
    the triage bucket of a crash as a third return — it must be
    computed BEFORE the restore rolls the faulting state back, which is
    why it lives inside this sequence."""
    target.insert_testcase(backend, data)
    result = backend.run()
    if isinstance(result, Timedout):
        backend.revoke_last_new_coverage()  # client.cc:122-125
    coverage = backend.last_new_coverage()
    bucket = ""
    if want_bucket and isinstance(result, Crash):
        from wtf_tpu_torch.triage.bucket import bucket_of

        bucket = bucket_of(backend, 0, result)
    target.restore()
    backend.restore()
    if want_bucket:
        return result, coverage, bucket
    return result, coverage


class Client(_NodeTelemetry):
    """Single-slot node (reference shape).  `max_retry_secs` > 0 makes it
    survive mid-campaign socket loss: reconnect with jittered backoff,
    re-handshake, keep serving — a BYE (or the budget running out) still
    ends it, so the reference's 'master gone -> node exits' remains the
    terminal behavior (client.cc:228-231)."""

    def __init__(self, backend, target, address: str,
                 registry: Optional[Registry] = None, events=None,
                 stats_every: float = 10.0, print_stats: bool = False,
                 max_retry_secs: float = 0.0,
                 retry_rng: Optional[random.Random] = None,
                 wire_v1: bool = False, cov_delta: bool = False,
                 client_id: Optional[bytes] = None):
        self.backend = backend
        self.target = target
        self.address = address
        self.max_retry_secs = max_retry_secs
        self.retry_rng = retry_rng
        self.wire_v1 = wire_v1
        # cov_delta: speak WTF3 — results carry only newly-set coverage
        # bits against the master's ack cursor (wtf_tpu_torch/fleet/delta)
        # instead of the whole coverage set.  Needs a delta-capable
        # master; --no-cov-delta is the rolling-upgrade escape hatch.
        self.cov_delta = cov_delta and not wire_v1
        self.client_id = client_id
        self.runs = 0
        self._init_telemetry(backend, registry, events, stats_every,
                             print_stats)

    def run(self, max_runs: int = 0) -> int:
        """Serve until the master says BYE / stays gone (or max_runs)."""
        from wtf_tpu_torch.fleet.delta import AddressDeltaCursor

        self.target.init(self.backend)
        cursor = (AddressDeltaCursor(self.client_id, self.registry)
                  if self.cov_delta else None)
        link = MasterLink(self.address, 1, self.max_retry_secs,
                          registry=self.registry, events=self.events,
                          rng=self.retry_rng, tagged=not self.wire_v1,
                          cursor=cursor)
        link.connect(retry_for=10.0)
        self._telem_link = link
        try:
            spans = self.registry.spans
            while max_runs == 0 or self.runs < max_runs:
                with spans.span("wire-recv"):
                    testcase = link.recv_work()
                if testcase is None:
                    break  # campaign over / master gone for good
                with spans.span("execute"):
                    result, coverage, bucket = run_testcase_and_restore(
                        self.backend, self.target, testcase,
                        want_bucket=True)
                with spans.span("harvest"):
                    self.stats.account(result)
                    if cursor is not None:
                        if _coverage_revoked(result):
                            body = cursor.encode_empty(testcase, result,
                                                       bucket=bucket)
                        else:
                            body = cursor.encode_result(
                                testcase, result, coverage, bucket=bucket)
                # a lost result is fine: the master reclaimed this
                # testcase with the socket and re-serves it elsewhere
                with spans.span("wire-send"):
                    if cursor is not None:
                        link.send_delta(body)
                    else:
                        link.send(wire.encode_result(testcase, coverage,
                                                     result))
                self.runs += 1
                self._heartbeat()
        finally:
            link.close()
        return self.runs


class BatchClient(_NodeTelemetry):
    """GPU node: one device batch per round against the master.

    Two wire shapes (selected by `mux`):
      mux=False  n_lanes connections, one hello(1) each — byte-compatible
                 with the reference's process-per-core nodes; the master
                 cannot tell a GPU node from n_lanes ordinary clients.
      mux=True   ONE connection with hello(n_lanes): the master sends a
                 batch frame of up to n_lanes testcases per round and gets
                 one batch frame of results back.  This is what scales a
                 4096-lane node: 1 fd instead of 4096.
    """

    def __init__(self, backend, target, address: str, mux: bool = False,
                 registry: Optional[Registry] = None, events=None,
                 stats_every: float = 10.0, print_stats: bool = False,
                 max_retry_secs: float = 0.0,
                 retry_rng: Optional[random.Random] = None,
                 wire_v1: bool = False, cov_delta: bool = False):
        self.backend = backend
        self.target = target
        self.address = address
        self.mux = mux
        self.max_retry_secs = max_retry_secs
        self.retry_rng = retry_rng
        self.wire_v1 = wire_v1
        # WTF3 streaming deltas (wtf_tpu_torch/fleet/delta).  On the mux link
        # the cursor rides the backend's native `[words, 32]` bit space
        # — delta extraction is one XOR against the last-acked aggregate
        # and no per-lane address decode happens at all; on the
        # 1-fd-per-lane shape each link keeps its own address cursor.
        self.cov_delta = cov_delta and not wire_v1
        self.rounds = 0
        self.runs = 0
        self._init_telemetry(backend, registry, events, stats_every,
                             print_stats)

    def _link(self, n_slots: int, cursor=None) -> MasterLink:
        return MasterLink(self.address, n_slots, self.max_retry_secs,
                          registry=self.registry, events=self.events,
                          rng=self.retry_rng, tagged=not self.wire_v1,
                          cursor=cursor)

    def _lane_reportable(self, lane: int, result) -> bool:
        """Does this lane have coverage worth shipping?  Timeout lanes
        are revoked (client.cc:122-125) and no-new-coverage lanes have
        nothing the master hasn't seen from this client."""
        return (not isinstance(result, Timedout)
                and self.backend.lane_found_new_coverage(lane))

    def _bucket(self, lane: int, result) -> str:
        if not isinstance(result, Crash):
            return ""
        from wtf_tpu_torch.triage.bucket import bucket_of

        return bucket_of(self.backend, lane, result)

    def run(self, max_rounds: int = 0) -> int:
        if self.mux:
            return self._run_mux(max_rounds)
        from wtf_tpu_torch.fleet.delta import AddressDeltaCursor

        self.target.init(self.backend)
        links: List[MasterLink] = []
        for _ in range(self.backend.n_lanes):
            cursor = (AddressDeltaCursor(registry=self.registry)
                      if self.cov_delta else None)
            link = self._link(1, cursor=cursor)
            link.connect(retry_for=10.0)
            links.append(link)
        spans = self.registry.spans
        try:
            while max_rounds == 0 or self.rounds < max_rounds:
                batch: List[bytes] = []
                live: List[MasterLink] = []
                with spans.span("wire-recv"):
                    for link in links:
                        tc = link.recv_work()  # reconnects under the hood
                        if tc is None:
                            link.close()  # lane retired (BYE / budget spent)
                            if not link._bye:
                                # this lane burned its WHOLE retry budget:
                                # the master is gone for every lane — zero
                                # the siblings' budgets so shutdown costs
                                # one window, not n_lanes windows (they
                                # still drain whatever their live sockets
                                # already hold)
                                for rest in links:
                                    rest.max_retry_secs = 0.0
                            continue
                        batch.append(tc)
                        live.append(link)
                if not batch:
                    break
                links = live
                with spans.span("execute"):
                    results = self.backend.run_batch(batch, self.target)
                # one span for the per-lane replies: each lane's result is
                # sent as soon as it is encoded, as the reference does
                with spans.span("harvest"):
                    for lane, (link, data, result) in enumerate(
                            zip(links, batch, results)):
                        # the lane's whole coverage set decodes ONLY when
                        # there is something new to report (the v2 path
                        # used to pull it per lane unconditionally)
                        coverage = (self.backend.lane_coverage(lane)
                                    if self._lane_reportable(lane, result)
                                    else set())
                        self.stats.account(result)
                        # lost sends abandon the result (master reclaims);
                        # the lane stays — its next recv_work reconnects
                        if link.cursor is not None:
                            bucket = self._bucket(lane, result)
                            if _coverage_revoked(result):
                                body = link.cursor.encode_empty(
                                    data, result, bucket=bucket)
                            else:
                                body = link.cursor.encode_result(
                                    data, result, coverage, bucket=bucket)
                            link.send_delta(body)
                        else:
                            link.send(wire.encode_result(data, coverage,
                                                         result))
                        self.runs += 1
                with spans.span("restore"):
                    self.target.restore()
                    self.backend.restore()
                self.rounds += 1
                # ONE lane link carries the node's telem frames (the
                # registry is node-wide; one identity owns its totals)
                self._telem_link = links[0] if links else None
                self._heartbeat()
        finally:
            for link in links:
                link.close()
        return self.runs

    def _run_mux(self, max_rounds: int = 0) -> int:
        """Multiplexed rounds: one batch frame in, one batch frame out."""
        from wtf_tpu_torch.fleet.delta import BitmapDeltaCursor

        self.target.init(self.backend)
        cursor = (BitmapDeltaCursor(self.backend, registry=self.registry)
                  if self.cov_delta else None)
        link = self._link(self.backend.n_lanes, cursor=cursor)
        link.connect(retry_for=10.0)
        self._telem_link = link
        spans = self.registry.spans
        try:
            while max_rounds == 0 or self.rounds < max_rounds:
                with spans.span("wire-recv"):
                    frame = link.recv_work()
                    batch = (wire.decode_batch(frame) if frame is not None
                             else [])
                if frame is None:
                    break  # campaign over / master gone for good
                if not batch:
                    break
                with spans.span("execute"):
                    results = self.backend.run_batch(batch, self.target)
                with spans.span("harvest"):
                    if cursor is not None:
                        replies = self._delta_replies(cursor, batch,
                                                      results)
                        for result in results:
                            self.stats.account(result)
                    else:
                        replies = []
                        for lane, (data, result) in enumerate(
                                zip(batch, results)):
                            coverage = (
                                self.backend.lane_coverage(lane)
                                if self._lane_reportable(lane, result)
                                else set())
                            self.stats.account(result)
                            replies.append(
                                wire.encode_result(data, coverage, result))
                    body = wire.encode_batch(replies)
                with spans.span("wire-send"):
                    if cursor is not None:
                        link.send_delta(body)
                    else:
                        link.send(body)
                self.runs += len(batch)
                with spans.span("restore"):
                    self.target.restore()
                    self.backend.restore()
                self.rounds += 1
                self._heartbeat()
        finally:
            link.close()
        return self.runs

    def _delta_replies(self, cursor, batch, results) -> List[bytes]:
        """One round's delta bodies: each reportable lane carries the
        bits it is FIRST to claim against the acked aggregate (claim
        chaining mirrors the device merge's prefix credit); bits no lane
        of this round covers — coverage whose frame was lost with a
        dropped connection — ride the first NON-revoked body, so the
        link repairs loss by re-extraction, never by retransmission
        bookkeeping.  Revoked results (timeouts, overlay-full) always
        go out as empty bodies: the master credits a frame's addresses
        to its testcase, and a hang must never earn corpus admission."""
        import numpy as np

        agg = np.asarray(self.backend.coverage_state()[0], np.uint32)
        lane_words = {
            lane: self.backend.lane_cov_words(lane)
            for lane, result in enumerate(results)
            if self._lane_reportable(lane, result)}
        carried = np.zeros_like(agg)
        for words in lane_words.values():
            carried |= np.asarray(words, np.uint32)
        stale = cursor.unacked(agg) & ~carried
        carrier = next((lane for lane, result in enumerate(results)
                        if not _coverage_revoked(result)), None)
        claimed = np.zeros_like(agg)
        replies = []
        first = True
        for lane, (data, result) in enumerate(zip(batch, results)):
            bucket = self._bucket(lane, result)
            if _coverage_revoked(result):
                replies.append(cursor.encode_empty(data, result,
                                                   bucket=bucket))
                continue
            words = lane_words.get(lane)
            if lane == carrier and stale.any():
                words = stale if words is None \
                    else np.asarray(words, np.uint32) | stale
            replies.append(cursor.encode_lane(
                data, result, words, claimed, bucket=bucket,
                first=first))
            first = False
        return replies
