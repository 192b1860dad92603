"""Phase spans: where the wall-clock goes, fenced against async launches.

The counterpart of wtf_tpu/telemetry/spans.py.  CUDA launches are
asynchronous — `fused_step(...)` returns before the card finishes, so a
naive timer around it measures the enqueue, not device execution, and the
"missing" time surfaces in whichever later span happens to synchronize
first.  A Span therefore exposes `fence(value)`: for a tensor on a CUDA
device it is `torch.cuda.synchronize()` on that device, so the span's end
time is taken AFTER the device work is actually done:

    with spans.span("fused-step") as sp:
        fused_step(tab, image, machine, limit, k)
        sp.fence(machine.status)

Spans nest: a span opened inside another records under the joined path
("execute/device-step"), so a report can both account top-level phases
against wall-clock (paths without "/") and break a phase down.  Totals
land in the owning registry as `phase.seconds{path}` / `phase.calls{path}`
labeled counters — one metric namespace shared with everything else, one
heartbeat dump carries it all.
"""

from __future__ import annotations

import time
from typing import List, Optional

from wtf_tpu_torch.telemetry.metrics import Registry

SECONDS = "phase.seconds"
CALLS = "phase.calls"

# Span leaves that measure DEVICE work (each is fenced with
# torch.cuda.synchronize before its span closes): the precise step
# ("device-step"), the fused kernel ("fused-step"), the overlay restore
# and the coverage readback.  The trace collector files these under
# "device" and everything else under "host".  A fenced span also holds
# the host time spent issuing its launches, so the card's own busy time
# comes from a profiler trace, not from this split.
DEVICE_SPAN_LEAVES = frozenset((
    "device", "device-step", "fused-step", "overlay-restore",
    "cov-readback",
))


def block_until_ready(value) -> None:
    """Fence: wait until the device work producing `value` is done.  A
    no-op for host values and CPU tensors (CPU ops run synchronously)."""
    import torch

    if isinstance(value, torch.Tensor) and value.device.type == "cuda":
        torch.cuda.synchronize(value.device)


class Span:
    """One open phase measurement (context-managed via Spans.span)."""

    __slots__ = ("path", "_spans", "_t0")

    def __init__(self, spans: "Spans", path: str):
        self.path = path
        self._spans = spans
        self._t0 = spans._clock()

    def fence(self, value) -> None:
        """Block until `value`'s device buffers are ready — call on the
        chunk's outputs before the span closes so async dispatch can't
        shift its time into a later span."""
        block_until_ready(value)

    @property
    def elapsed(self) -> float:
        return self._spans._clock() - self._t0


class TraceCollector:
    """Chrome-trace-event sink for spans: every closed span becomes one
    "ph":"X" complete event (ts/dur in microseconds, category "device"
    for the fenced DEVICE_SPAN_LEAVES, "host" otherwise), and point
    events (compile, checkpoint, prelaunch drops, supervisor recoveries)
    become "ph":"i" instants — so chrome://tracing / Perfetto renders
    the host-vs-device overlap per batch directly.

    Collection is O(1) appends on close; nothing is serialized until
    write() (keeping the emit path off the dispatch seams — the
    telemetry lint family pins this).  `max_events` bounds memory on
    long campaigns by dropping the oldest half once full (the steady
    state is what a timeline capture is for)."""

    def __init__(self, clock=time.perf_counter, max_events: int = 200_000):
        self._clock = clock
        self._events: List[tuple] = []  # ("X", path, t0, dur) | ("i", ...)
        self._max = max_events
        self.dropped = 0

    def complete(self, path: str, t0: float, dur: float) -> None:
        self._append(("X", path, t0, dur))

    def instant(self, name: str, args=None) -> None:
        self._append(("i", name, self._clock(), args))

    def _append(self, event: tuple) -> None:
        if len(self._events) >= self._max:
            keep = self._max // 2
            self.dropped += len(self._events) - keep
            self._events = self._events[-keep:]
        self._events.append(event)

    def trace_events(self) -> List[dict]:
        """The Chrome trace-event list (ts rebased to the first event)."""
        if not self._events:
            return []
        epoch = min(ev[2] for ev in self._events)
        out = []
        for ev in self._events:
            ts = round((ev[2] - epoch) * 1e6, 3)
            if ev[0] == "X":
                path = ev[1]
                leaf = path.rsplit("/", 1)[-1]
                cat = "device" if leaf in DEVICE_SPAN_LEAVES else "host"
                out.append({"name": leaf, "cat": cat, "ph": "X",
                            "ts": ts, "dur": round(ev[3] * 1e6, 3),
                            "pid": 1, "tid": 1, "args": {"path": path}})
            else:
                record = {"name": ev[1], "cat": "event", "ph": "i",
                          "ts": ts, "pid": 1, "tid": 1, "s": "t"}
                if ev[3]:
                    record["args"] = ev[3]
                out.append(record)
        out.sort(key=lambda e: e["ts"])
        return out

    def write(self, path) -> int:
        """Write the JSON object form ({"traceEvents": [...]}) — the
        schema both chrome://tracing and Perfetto load.  Returns the
        event count."""
        import json
        from pathlib import Path

        events = self.trace_events()
        payload = {"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"producer": "wtf-tpu",
                                 "dropped_events": self.dropped}}
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(payload, fh)
        return len(events)


class Spans:
    """Registry-owned span timer.  Single-threaded by design (the run
    loop is); the nesting stack is just a list.  `collector` (normally
    None) mirrors every closed span into a TraceCollector for --trace-out
    timeline export."""

    def __init__(self, registry: Registry, clock=time.perf_counter):
        self._registry = registry
        self._clock = clock
        self._stack: List[str] = []
        self.collector: Optional[TraceCollector] = None

    def span(self, name: str) -> "_SpanCtx":
        """Open a phase span (context manager; call sp.fence(value) inside
        the with-block on the device values the phase produced)."""
        return _SpanCtx(self, name)

    def seconds(self, path: str) -> float:
        """Accumulated seconds recorded under `path` (0.0 if never hit)."""
        children = self._registry.counter(SECONDS).children
        child = children.get(path)
        return child.value if child is not None else 0.0

    def trace_mark(self, name: str) -> "_TraceMarkCtx":
        """A trace-timeline-only span: emits an "X" event to the
        collector (if attached) but does NOT enter the nesting stack or
        the phase.seconds counters — for visual grouping boxes whose
        extra path level would skew path-keyed accounting (e.g. the
        megachunk window drawn around execute/device)."""
        return _TraceMarkCtx(self, name)

    def _record(self, path: str, dt: float) -> None:
        self._registry.counter(SECONDS).labels(path).inc(dt)
        self._registry.counter(CALLS).labels(path).inc()


class _SpanCtx:
    __slots__ = ("_spans", "_name", "_span")

    def __init__(self, spans: Spans, name: str):
        self._spans = spans
        self._name = name
        self._span: Optional[Span] = None

    def __enter__(self) -> Span:
        spans = self._spans
        path = "/".join(spans._stack + [self._name])
        spans._stack.append(self._name)
        self._span = Span(spans, path)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> None:
        # record even on an in-span exception: a crashed phase's time
        # is exactly what a post-mortem wants attributed
        spans = self._spans
        dt = self._span.elapsed
        if spans._stack and spans._stack[-1] == self._name:
            spans._stack.pop()
        spans._record(self._span.path, dt)
        if spans.collector is not None:
            spans.collector.complete(self._span.path, self._span._t0, dt)
        return None


class _TraceMarkCtx:
    __slots__ = ("_spans", "_name", "_t0")

    def __init__(self, spans: Spans, name: str):
        self._spans = spans
        self._name = name
        self._t0 = 0.0

    def __enter__(self) -> "_TraceMarkCtx":
        self._t0 = self._spans._clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        spans = self._spans
        if spans.collector is not None:
            path = "/".join(spans._stack + [self._name])
            spans.collector.complete(path, self._t0,
                                     spans._clock() - self._t0)
        return None
