"""Metrics registry: named counters / gauges / histograms with labels.

The reference keeps its campaign numbers in ad-hoc structs
(ServerStats_t server.h:24-240, BochscpuRunStats_t backend.h:17-45) and
this repo grew three disconnected copies of that idea (CampaignStats,
ServerStats, Runner.stats).  The registry replaces all of them with one
namespace of metrics cheap enough for hot paths (attribute increments on
plain Python ints — no locks, no string formatting until dump time):

  reg = Registry()
  reg.counter("runner.fallbacks").inc()
  reg.counter("runner.fallbacks_by_opclass").labels("ssefp").inc()
  reg.gauge("runner.max_chunk_steps").set(4096)
  reg.histogram("phase.seconds").observe(0.012)
  reg.dump()  # one JSON-able dict of everything

Scoping: metrics aggregate per-Registry, and every component creates a
PRIVATE registry unless handed one — a FuzzLoop in a test does not bleed
counters into the next test.  The CLI passes ONE registry to the
backend, the loop/server, and the event log, which is what makes the
heartbeat line and the JSONL stream consistent; `get_registry()` is the
process-global default for code with no better scope.

`StatsDict` / `LabeledView` are dict facades over registry metrics so
existing call sites (`runner.stats["fallbacks"] += 1`,
`dict(stats["fallbacks_by_opclass"])`) keep working unchanged while the
values live in the registry.
"""

from __future__ import annotations

from collections.abc import Mapping, MutableMapping
from typing import Dict, Iterable, Optional, Tuple, Union

Number = Union[int, float]


class Counter:
    """Monotonic-by-convention accumulator.  `set` exists because the
    dict facades (and gauges-by-another-name like max_chunk_steps) need
    read-modify-write assignment."""

    __slots__ = ("name", "value", "_children")

    def __init__(self, name: str):
        self.name = name
        self.value: Number = 0
        self._children: Optional[Dict[str, "Counter"]] = None

    def inc(self, n: Number = 1) -> None:
        self.value += n

    def set(self, value: Number) -> None:
        self.value = value

    def labels(self, label: str) -> "Counter":
        """Child counter keyed by one label value (e.g. the opclass in
        fallbacks{opclass=ssefp}).  Children are cached; the parent's own
        value stays independent (normally unused when labeled)."""
        if self._children is None:
            self._children = {}
        child = self._children.get(label)
        if child is None:
            child = Counter(f"{self.name}{{{label}}}")
            self._children[label] = child
        return child

    @property
    def children(self) -> Dict[str, "Counter"]:
        return self._children or {}

    def dump(self):
        if self._children is not None:
            return {k: c.value for k, c in self._children.items()}
        return self.value


class Gauge(Counter):
    """A value that goes up and down (set-dominant)."""


class Histogram:
    """Constant-space summary: count / sum / min / max.  Cheap enough
    for per-span observation on the hot loop; full distributions belong
    in the JSONL stream, not here."""

    __slots__ = ("name", "count", "sum", "min", "max")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value: Number) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        if self.min is None or value < self.min:
            self.min = value
        if self.max is None or value > self.max:
            self.max = value

    def dump(self):
        return {"count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max}


class Registry:
    """Process- or campaign-scoped namespace of metrics."""

    def __init__(self):
        self._metrics: Dict[str, Union[Counter, Gauge, Histogram]] = {}
        self._spans = None

    def _get(self, name: str, cls):
        metric = self._metrics.get(name)
        if metric is None:
            metric = cls(name)
            self._metrics[name] = metric
        elif type(metric) is not cls:
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(metric).__name__}, not {cls.__name__}")
        return metric

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    @property
    def spans(self):
        """This registry's phase-span timer (telemetry.spans.Spans),
        created lazily so metrics-only users never import the fencing
        machinery."""
        if self._spans is None:
            from wtf_tpu_torch.telemetry.spans import Spans

            self._spans = Spans(self)
        return self._spans

    def dump(self) -> Dict[str, object]:
        """JSON-able snapshot of every metric: plain value for unlabeled
        counters/gauges, {label: value} for labeled ones,
        {count,sum,min,max} for histograms."""
        return {name: m.dump() for name, m in sorted(self._metrics.items())}

    # -- fleet snapshots (dist TAG_TELEM / fleet/telemetry.py) -------------
    def snapshot(self) -> Dict[str, object]:
        """Wire-portable FULL state — unlike counters_state this includes
        histograms and every namespace, because the fleet aggregator's
        job is to reproduce the node's registry exactly:
          {name: {"kind": "c"|"g", "value": n}           unlabeled
                 {"kind": "c"|"g", "labels": {l: n}}     labeled
                 {"kind": "h", "count","sum","min","max"} histogram}
        Snapshots are CUMULATIVE (a node resends its running totals), so
        the merge keeps only the latest per node and re-sends/reconnects
        can never double-count."""
        out: Dict[str, object] = {}
        for name, metric in self._metrics.items():
            if isinstance(metric, Histogram):
                out[name] = {"kind": "h", "count": metric.count,
                             "sum": metric.sum, "min": metric.min,
                             "max": metric.max}
                continue
            kind = "g" if isinstance(metric, Gauge) else "c"
            if metric._children is not None:
                out[name] = {"kind": kind, "labels": {
                    label: c.value for label, c in metric._children.items()}}
            else:
                out[name] = {"kind": kind, "value": metric.value}
        return out

    def restore_snapshot(self, state: Dict[str, object]) -> None:
        """Install a snapshot() (or merge_snapshots()) dict into this
        registry — the fleet aggregator renders its merged state through
        a real Registry so dump()/report code works unchanged."""
        for name, entry in state.items():
            kind = entry.get("kind")
            if kind == "h":
                hist = self.histogram(name)
                hist.count = entry.get("count", 0)
                hist.sum = entry.get("sum", 0.0)
                hist.min = entry.get("min")
                hist.max = entry.get("max")
                continue
            metric = self.gauge(name) if kind == "g" else self.counter(name)
            if "labels" in entry:
                if metric._children is None:
                    metric._children = {}  # declared labeled: dump as {}
                for label, v in entry["labels"].items():
                    metric.labels(label).set(v)
            else:
                metric.set(entry.get("value", 0))

    # -- checkpoint/resume (wtf_tpu/resume) --------------------------------
    def counters_state(self, prefixes) -> Dict[str, object]:
        """Counters/gauges under `prefixes` as {name: {kind, value}} —
        the resumable half of the registry (histograms and span timers
        are wall-clock observations of the killed process; they restart
        from zero by design)."""
        out: Dict[str, object] = {}
        for name, metric in self._metrics.items():
            if isinstance(metric, Histogram):
                continue
            if not any(name.startswith(p) for p in prefixes):
                continue
            kind = "g" if isinstance(metric, Gauge) else "c"
            out[name] = {"kind": kind, "value": metric.dump()}
        return out

    def restore_counters(self, state: Dict[str, object]) -> None:
        """Install counters_state() output (resume overwrites whatever the
        fresh process accumulated during its own warmup)."""
        for name, entry in state.items():
            getter = self.gauge if entry.get("kind") == "g" else self.counter
            metric = getter(name)
            value = entry.get("value")
            if isinstance(value, dict):
                for label, v in value.items():
                    metric.labels(label).set(v)
            else:
                metric.set(value)


def merge_snapshots(snapshots: Iterable[Dict[str, object]]
                    ) -> Dict[str, object]:
    """Sum N Registry.snapshot() dicts into one fleet-wide snapshot:
    counters and gauges add (per label for labeled ones), histograms
    combine (count/sum add, min/max extremize).  Kind conflicts take the
    first writer — a fleet of same-version nodes never has any.  The
    result is itself snapshot-shaped, so it round-trips through
    Registry.restore_snapshot for rendering."""
    merged: Dict[str, dict] = {}
    for snap in snapshots:
        for name, entry in snap.items():
            kind = entry.get("kind")
            cur = merged.get(name)
            if cur is None:
                cur = ({"kind": "h", "count": 0, "sum": 0.0,
                        "min": None, "max": None} if kind == "h"
                       else {"kind": kind}
                       | ({"labels": {}} if "labels" in entry
                          else {"value": 0}))
                merged[name] = cur
            if kind == "h":
                cur["count"] += entry.get("count", 0)
                cur["sum"] += entry.get("sum", 0.0)
                for field, pick in (("min", min), ("max", max)):
                    v = entry.get(field)
                    if v is not None:
                        cur[field] = (v if cur[field] is None
                                      else pick(cur[field], v))
            elif "labels" in entry:
                labels = cur.setdefault("labels", {})
                for label, v in entry["labels"].items():
                    labels[label] = labels.get(label, 0) + v
            else:
                cur["value"] = cur.get("value", 0) + entry.get("value", 0)
    return {name: merged[name] for name in sorted(merged)}


_GLOBAL: Optional[Registry] = None


def get_registry() -> Registry:
    """The process-global default registry (for code with no
    campaign-scoped registry in reach)."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = Registry()
    return _GLOBAL


class LabeledView(MutableMapping):
    """dict facade over one labeled counter: `view["ssefp"] += 1`,
    `dict(view)`, `view.get(k, 0)` all work; values live in the
    counter's children."""

    __slots__ = ("_counter",)

    def __init__(self, counter: Counter):
        self._counter = counter

    def __getitem__(self, label: str) -> Number:
        children = self._counter.children
        if label not in children:
            raise KeyError(label)
        return children[label].value

    def __setitem__(self, label: str, value: Number) -> None:
        self._counter.labels(label).set(value)

    def __delitem__(self, label: str) -> None:
        raise TypeError("labeled metrics cannot be deleted")

    def __iter__(self):
        return iter(self._counter.children)

    def __len__(self) -> int:
        return len(self._counter.children)

    def __repr__(self) -> str:
        return repr({k: c.value for k, c in self._counter.children.items()})


class StatsDict(MutableMapping):
    """dict facade over a fixed family of registry metrics under a
    prefix — what Runner.stats / backend.stats migrate onto without
    changing a single call site.

    `fields` declares the plain (counter-backed) keys, `gauges` the
    set-dominant ones, `labeled` the keys that expose a LabeledView.
    Unknown keys assigned later become counters (prefix applied), so the
    facade stays open like the dict it replaces.
    """

    def __init__(self, registry: Registry, prefix: str,
                 fields: Iterable[str] = (),
                 gauges: Iterable[str] = (),
                 labeled: Iterable[str] = ()):
        self._registry = registry
        self._prefix = prefix
        self._gauges = set(gauges)
        self._labeled = set(labeled)
        self._keys = list(fields) + list(gauges) + list(labeled)
        for key in self._keys:
            self._metric(key)  # register now so dump()/iteration see zeros

    def _name(self, key: str) -> str:
        return f"{self._prefix}.{key}"

    def _metric(self, key: str):
        if key in self._gauges:
            return self._registry.gauge(self._name(key))
        counter = self._registry.counter(self._name(key))
        if key in self._labeled and counter._children is None:
            counter._children = {}  # declared labeled: dump as {} not 0
        return counter

    def __getitem__(self, key: str):
        if key not in self._keys:
            raise KeyError(key)
        if key in self._labeled:
            return LabeledView(self._metric(key))
        return self._metric(key).value

    def __setitem__(self, key: str, value) -> None:
        if key not in self._keys:
            self._keys.append(key)
        if key in self._labeled:
            if not isinstance(value, Mapping):
                raise TypeError(f"{key} takes a mapping")
            counter = self._metric(key)
            for label, v in value.items():
                counter.labels(label).set(v)
            return
        self._metric(key).set(value)

    def __delitem__(self, key: str) -> None:
        raise TypeError("stats keys cannot be deleted")

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __repr__(self) -> str:
        return repr({k: (dict(self[k]) if k in self._labeled else self[k])
                     for k in self._keys})
