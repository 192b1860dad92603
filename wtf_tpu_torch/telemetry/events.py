"""Append-only JSONL event log: the machine-readable campaign stream.

The reference's operational record is whatever scrolled past on stdout;
here every noteworthy campaign event is one JSON object per line in
`<telemetry-dir>/events.jsonl`, so a run can be replayed, diffed, and
summarized offline (tools/telemetry_report.py) while the human heartbeat
line stays exactly what it always was.

Schema (every record):
  ts    float unix seconds
  seq   monotonically increasing per-log sequence number
  type  event type string
plus per-type payload fields.  The well-known types:

  run-start     campaign start (subcommand, name, backend, argv)
  heartbeat     periodic: the human status `line` + a full registry
                `metrics` dump (per-phase span totals ride in here)
  new-coverage  new coverage entered the corpus — fuzz loop records
                carry (digest, size); master records carry
                (new_addresses, total, size)
  crash         a crash was recorded (name, size, new) — cli run-mode
                records carry (name, input)
  timeout       per-batch timeout count (aggregated — a 4096-lane batch
                of timeouts is one record, not 4096)
  compile       a chunk executor's first dispatch pays its XLA compile
                (chunk_steps, donate); the wall shows inside the next
                device-step span
  error         operational failure that used to be a bare print()
                (kind, detail + per-kind fields)
  run-end       final registry dump at campaign end (metrics)

The fault-tolerance tier adds retry/reconnect/reclaim/drain/
checkpoint/resume records (wtf_tpu/resume, dist hardening) and the
fleet tier adds:

  store-put     a blob entered the content-addressed store
                (store, kind, digest, size, bucket)
  cursor-resume a restarted master resumed persisted delta ack
                cursors (clients, addresses)
  reshard       elastic placement change requested at a batch boundary
                (batch, devices, testcases); the campaign checkpoints
                and the campaign re-places it

`crash` records from the delta-speaking master additionally carry
(digest, bucket) — files are digest-named and bucket-deduped there.

Call sites hold a sink unconditionally: `NullEventLog` swallows
everything, so `self.events.emit(...)` never needs a None check on a hot
path.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Optional


class NullEventLog:
    """No-op sink with the full EventLog surface."""

    path = None

    def emit(self, type: str, **fields) -> None:  # noqa: A002
        pass

    def heartbeat(self, registry=None, line: Optional[str] = None,
                  **fields) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self) -> "NullEventLog":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


NULL = NullEventLog()


class EventLog(NullEventLog):
    """JSONL sink.  Every record is flushed on write — event rates are
    heartbeat-scale (not per-testcase), and a crashed run must not lose
    its tail."""

    def __init__(self, path, clock=time.time,
                 max_bytes: Optional[int] = None):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")
        self._clock = clock
        self._seq = 0
        self._broken = False
        # size-based rotation (events.jsonl -> events.jsonl.1): a
        # 1000-client soak or multi-day campaign must not grow the sink
        # unboundedly.  None (the default) keeps the historical
        # append-forever behavior; WTF_TPU_EVENTS_MAX_BYTES sets a
        # process-wide default cap.
        if max_bytes is None:
            env = os.environ.get("WTF_TPU_EVENTS_MAX_BYTES")
            max_bytes = int(env) if env else None
        self.max_bytes = max_bytes

    @classmethod
    def for_dir(cls, directory, max_bytes: Optional[int] = None
                ) -> "EventLog":
        """The --telemetry-dir convention: events.jsonl inside it."""
        return cls(Path(directory) / "events.jsonl", max_bytes=max_bytes)

    def emit(self, type: str, **fields) -> None:  # noqa: A002
        # Telemetry is an observability side-channel: a full disk or a
        # yanked --telemetry-dir must degrade it to a no-op, never abort
        # the campaign it is narrating (the crash-save/coverage-write
        # paths make the same call).  One warning, then silence.
        if self._broken:
            return
        record = {"ts": self._clock(), "seq": self._seq, "type": type}
        record.update(fields)
        self._seq += 1
        try:
            self._fh.write(json.dumps(record, default=str) + "\n")
            self._fh.flush()
            if self.max_bytes is not None and \
                    self._fh.tell() >= self.max_bytes:
                self._rotate()
        except OSError as e:
            self._disable(e)

    def _rotate(self) -> None:
        """events.jsonl -> events.jsonl.1 (replacing any prior .1) and
        reopen fresh.  One generation of history is the deliberate cap:
        the stream's job is the recent past; the registry carries the
        cumulative totals.  Torn tails survive rotation because readers
        (read_events) skip unparseable lines in EVERY generation."""
        self._fh.close()
        rotated = self.path.with_name(self.path.name + ".1")
        os.replace(self.path, rotated)
        self._fh = open(self.path, "a", encoding="utf-8")

    def heartbeat(self, registry=None, line: Optional[str] = None,
                  **fields) -> None:
        payload = dict(fields)
        if line is not None:
            payload["line"] = line
        if registry is not None:
            payload["metrics"] = registry.dump()
        self.emit("heartbeat", **payload)

    def flush(self) -> None:
        if self._broken:
            return
        try:
            self._fh.flush()
            os.fsync(self._fh.fileno())
        except OSError as e:
            self._disable(e)

    def _disable(self, e: OSError) -> None:
        self._broken = True
        import logging

        logging.getLogger(__name__).warning(
            "telemetry write failed (%s); disabling event log %s",
            e, self.path)

    def close(self) -> None:
        if not self._fh.closed:
            try:
                self._fh.close()
            except OSError:
                pass


def open_event_log(telemetry_dir) -> NullEventLog:
    """EventLog for a --telemetry-dir value, NULL for None — the one-line
    wiring every CLI subcommand uses."""
    if telemetry_dir is None:
        return NULL
    return EventLog.for_dir(telemetry_dir)


class TapEventLog(NullEventLog):
    """Wraps a sink and mirrors every record to a tap callable
    `tap(type, fields)` — how --trace-out turns point events (compile,
    checkpoint, recovery, prelaunch drops) into trace instants without
    every emitter learning about tracing.  Tap failures are swallowed:
    observability must never abort the campaign."""

    def __init__(self, inner, tap):
        self._inner = inner
        self._tap = tap

    @property
    def path(self):  # type: ignore[override]
        return self._inner.path

    def emit(self, type: str, **fields) -> None:  # noqa: A002
        try:
            self._tap(type, fields)
        except Exception:
            pass
        self._inner.emit(type, **fields)

    def heartbeat(self, registry=None, line: Optional[str] = None,
                  **fields) -> None:
        try:
            # the tap sees the light fields, not the full metrics dump —
            # serializing the registry belongs to the sink, not the trace
            self._tap("heartbeat", dict(fields, line=line))
        except Exception:
            pass
        self._inner.heartbeat(registry=registry, line=line, **fields)

    def flush(self) -> None:
        self._inner.flush()

    def close(self) -> None:
        self._inner.close()


def read_events(path, rotated: bool = False):
    """Yield records from an events.jsonl (skipping any torn final line —
    a killed run may die mid-write; rotation can freeze a torn tail into
    the .1 generation, so EVERY generation gets the same tolerance).
    With rotated=True, records from `<path>.1` come first."""
    paths = [Path(str(path) + ".1"), Path(path)] if rotated else [Path(path)]
    for p in paths:
        if not p.exists():
            continue
        with open(p, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    continue
