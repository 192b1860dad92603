"""Fleet tier: the distribution layer that scales the master/node plane
from a handful of ad-hoc clients to a serving system (a copy of
wtf_tpu/fleet, imports rewritten).

  delta.py      streaming coverage deltas over the WTF2 wire (WTF3 hello /
                TAG_COVDELTA frames): results carry only newly-set
                coverage bits as sparse word+mask pairs against the
                master's per-client ack cursor, with whole-bitmap resync
                on first contact and cursor loss
  store.py      append-only content-addressed corpus/crash store: digest-
                named blobs in sharded fanout dirs, dedup on write, a
                manifest journal, crash intake deduped by the triage
                bucket, per-tenant namespaces
  elastic.py    elastic campaigns: checkpoint a running campaign at a
                batch boundary and resume it bit-identically under a
                different --mesh-devices placement
  telemetry.py  the master's fleet aggregate of node TAG_TELEM snapshots
                and its exports (status.json, telemetry.prom)
  soak.py       the proof harness: hundreds-to-1000 simulated clients over
                the real wire protocol with injected resets/reclaims,
                asserting zero lost testcases and exact aggregate-coverage
                agreement with a serial replay
"""

from wtf_tpu_torch.fleet.delta import (
    AddressDeltaCursor, BitmapDeltaCursor, DeltaCursor, ServerCursor,
    cursor_digest,
)
from wtf_tpu_torch.fleet.store import FleetStore

__all__ = [
    "AddressDeltaCursor", "BitmapDeltaCursor", "DeltaCursor",
    "FleetStore", "ServerCursor", "cursor_digest",
]
