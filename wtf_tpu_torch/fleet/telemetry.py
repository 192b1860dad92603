"""Fleet telemetry aggregation: per-node registry snapshots -> one view.

WTF3 nodes piggyback TAG_TELEM frames on their existing work connection
(dist/wire.py): a sequence-numbered CUMULATIVE Registry.snapshot() plus
a digest of recent events, once per node heartbeat.  This module is the
master side — it merges those per-node snapshots into a single fleet
registry keyed by client identity, with three properties the wire makes
easy to get wrong:

  idempotent   snapshots are cumulative and the aggregator keeps only
               the LATEST (seq, state) per client identity, so a frame
               replayed across a reconnect — or a whole node re-sending
               its running totals after a reclaim — never double-counts
  exact        the merged registry equals the serial sum of the latest
               per-node registries (counters/gauges add per label,
               histograms combine count/sum and extremize min/max) —
               fleet_smoke/obs_smoke assert byte-equality against a
               serial replay
  namespaced   tenant.<name>.* / sched.* metric names pass through
               untouched, so per-tenant rows survive aggregation

Exports: a Prometheus-style text endpoint file (`telemetry.prom`,
atomically replaced), a `fleet-telem.jsonl` stream (one record per
applied snapshot — the fleet-wide analogue of the campaign event log),
and `fleet_registry()` — a real Registry holding the merged state, so
`python -m wtf_tpu_torch status` renders it with the same code that
renders a local campaign.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from wtf_tpu_torch.telemetry.metrics import Registry, merge_snapshots


class NodeTelemetry:
    """Latest snapshot state for one client identity."""

    __slots__ = ("client_id", "seq", "snapshot", "last_seen", "epoch",
                 "execs_per_s")

    def __init__(self, client_id: str):
        self.client_id = client_id
        self.seq = -1
        self.snapshot: dict = {}
        self.last_seen = 0.0
        self.epoch = 0
        # instantaneous rate between the last two applied frames — the
        # per-node execs/s column of `python -m wtf_tpu_torch status`
        self.execs_per_s = 0.0

    @staticmethod
    def _execs(snapshot: dict) -> float:
        entry = snapshot.get("campaign.testcases") or {}
        try:
            return float(entry.get("value", 0))
        except (TypeError, ValueError):
            return 0.0

    def apply(self, seq: int, snapshot: dict, now: float) -> bool:
        """Install a frame if it advances this node's sequence.  A
        RECONNECT restarts the client's seq at 0 (per connection epoch);
        the cumulative snapshot makes that safe — whatever the new epoch
        sends supersedes the old totals — so the only frames dropped are
        true duplicates within one epoch (seq <= last seen there)."""
        if seq <= self.seq and seq != 0:
            return False
        if seq == 0 and self.seq >= 0:
            self.epoch += 1  # reconnect: fresh connection epoch
        if self.last_seen and now > self.last_seen:
            delta = self._execs(snapshot) - self._execs(self.snapshot)
            if delta >= 0:
                self.execs_per_s = delta / (now - self.last_seen)
        self.seq = seq
        self.snapshot = snapshot
        self.last_seen = now
        return True


class FleetTelemetry:
    """The master's aggregator.  `apply()` from the reactor on every
    TAG_TELEM frame; `write_exports()` on the same cadence as coverage
    persistence (dirty-flag guarded, atomic replace)."""

    def __init__(self, export_dir=None, clock=time.time,
                 stream_max_bytes: int = 8 * 1024 * 1024):
        self.nodes: Dict[str, NodeTelemetry] = {}
        self._clock = clock
        self._dirty = False
        self.export_dir = Path(export_dir) if export_dir else None
        self.frames = 0
        self.duplicates = 0
        self._stream_fh = None
        self._stream_max = stream_max_bytes

    # -- intake ------------------------------------------------------------

    def apply(self, client_id: bytes, seq: int, snapshot: dict,
              events: Optional[list] = None) -> bool:
        """One decoded TAG_TELEM frame.  Returns True when it advanced
        the fleet state (False = duplicate/stale, dropped)."""
        key = client_id.hex() if isinstance(client_id, (bytes, bytearray)) \
            else str(client_id)
        node = self.nodes.get(key)
        if node is None:
            node = self.nodes[key] = NodeTelemetry(key)
        now = self._clock()
        if not node.apply(seq, snapshot, now):
            self.duplicates += 1
            return False
        self.frames += 1
        self._dirty = True
        self._stream({"ts": now, "node": key, "seq": seq,
                      "epoch": node.epoch,
                      "events": events or [],
                      "snapshot": snapshot})
        return True

    # -- aggregate views ---------------------------------------------------

    def fleet_snapshot(self) -> dict:
        """The merged snapshot: serial sum of every node's latest."""
        return merge_snapshots(n.snapshot for n in self.nodes.values())

    def fleet_registry(self) -> Registry:
        """The merged state as a real Registry (dump()/report-compatible)."""
        registry = Registry()
        registry.restore_snapshot(self.fleet_snapshot())
        return registry

    def per_node(self) -> List[Tuple[str, dict]]:
        """[(client_id_hex, latest snapshot)] sorted by identity."""
        return sorted((k, n.snapshot) for k, n in self.nodes.items())

    def status(self) -> dict:
        """The `python -m wtf_tpu_torch status` document for a fleet master."""
        def _val(snap, name, default=0):
            entry = snap.get(name) or {}
            return entry.get("value", default)

        per_node = []
        for key in sorted(self.nodes):
            node = self.nodes[key]
            per_node.append({
                "node": key,
                "seq": node.seq,
                "epoch": node.epoch,
                "last_seen": node.last_seen,
                "execs_per_s": round(node.execs_per_s, 1),
                "testcases": _val(node.snapshot, "campaign.testcases"),
                "crashes": _val(node.snapshot, "campaign.crashes"),
                "new_coverage": _val(node.snapshot,
                                     "campaign.new_coverage"),
            })
        return {
            "kind": "fleet",
            "ts": self._clock(),
            "nodes": len(self.nodes),
            "frames": self.frames,
            "duplicates_dropped": self.duplicates,
            "node_ids": sorted(self.nodes),
            "per_node": per_node,
            "metrics": self.fleet_registry().dump(),
        }

    # -- exports -----------------------------------------------------------

    def write_exports(self, force: bool = False) -> bool:
        """Refresh `telemetry.prom` + `status.json` under export_dir when
        dirty (atomic replace, same posture as coverage persistence).
        Returns True when files were written."""
        if self.export_dir is None or not (self._dirty or force):
            return False
        from wtf_tpu_torch.utils.atomicio import atomic_write_text

        self.export_dir.mkdir(parents=True, exist_ok=True)
        atomic_write_text(self.export_dir / "telemetry.prom",
                          render_prometheus(self.fleet_snapshot()))
        atomic_write_text(self.export_dir / "status.json",
                          json.dumps(self.status(), default=str))
        self._dirty = False
        return True

    def _stream(self, record: dict) -> None:
        """Append one applied snapshot to fleet-telem.jsonl (best-effort:
        a full disk degrades the stream, never the master)."""
        if self.export_dir is None:
            return
        try:
            if self._stream_fh is None:
                self.export_dir.mkdir(parents=True, exist_ok=True)
                self._stream_fh = open(
                    self.export_dir / "fleet-telem.jsonl", "a",
                    encoding="utf-8")
            self._stream_fh.write(json.dumps(record, default=str) + "\n")
            self._stream_fh.flush()
            if self._stream_fh.tell() >= self._stream_max:
                self._stream_fh.close()
                path = self.export_dir / "fleet-telem.jsonl"
                path.replace(path.with_name(path.name + ".1"))
                self._stream_fh = open(path, "a", encoding="utf-8")
        except OSError:
            self._stream_fh = None

    def close(self) -> None:
        self.write_exports(force=bool(self.nodes))
        if self._stream_fh is not None:
            try:
                self._stream_fh.close()
            except OSError:
                pass
            self._stream_fh = None


def _prom_name(name: str) -> str:
    """Metric name -> Prometheus identifier (dots/dashes -> underscores)."""
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    ident = "".join(out)
    return "wtf_" + ident


def render_prometheus(snapshot: dict) -> str:
    """A Registry.snapshot()-shaped dict as Prometheus text exposition
    (counters -> counter, gauges -> gauge, histograms -> the _count/_sum
    + min/max gauge pair summary form)."""
    lines: List[str] = []
    for name, entry in sorted(snapshot.items()):
        kind = entry.get("kind")
        pname = _prom_name(name)
        if kind == "h":
            lines.append(f"# TYPE {pname} summary")
            lines.append(f"{pname}_count {entry.get('count', 0)}")
            lines.append(f"{pname}_sum {entry.get('sum', 0.0)}")
            for field in ("min", "max"):
                value = entry.get(field)
                if value is not None:
                    lines.append(f"{pname}_{field} {value}")
            continue
        prom_type = "gauge" if kind == "g" else "counter"
        lines.append(f"# TYPE {pname} {prom_type}")
        if "labels" in entry:
            for label, value in sorted(entry["labels"].items()):
                escaped = str(label).replace("\\", "\\\\").replace(
                    '"', '\\"')
                lines.append(f'{pname}{{label="{escaped}"}} {value}')
        else:
            lines.append(f"{pname} {entry.get('value', 0)}")
    return "\n".join(lines) + "\n"
