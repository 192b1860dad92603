"""The fast fleet-tier end-to-end check.

A small (but still ≥64-client) run of the real soak harness
(wtf_tpu_torch/fleet/soak): simulated clients over the real WTF2/WTF3 wire —
master reactor, MasterLink reconnects, delta cursors, the
content-addressed store — with scripted result-frame drops and
post-send resets.  Asserts zero lost testcases, aggregate coverage
byte-identical to a serial replay (persisted coverage.cov included),
and coverage wire bytes ≥10x smaller than the whole-bitmap exchange,
then fsck's the store it just filled.

Exit 0 only when every assertion held.  Run via
`python -m wtf_tpu_torch.testing.fleet_smoke [seed]`.
"""

from __future__ import annotations

import json
import logging
import sys
import tempfile
from pathlib import Path

SEED = 0xF1EE7


def main(argv=None) -> int:
    seed = int((argv or sys.argv[1:] or [SEED])[0])
    # the scripted resets produce reconnect warnings by design; keep the
    # smoke's stdout to the report
    logging.getLogger("wtf_tpu_torch").setLevel(logging.ERROR)
    from wtf_tpu_torch.fleet.soak import run_soak
    from wtf_tpu_torch.fleet.store import FleetStore

    print(f"fleet-smoke seed={seed:#x}")
    with tempfile.TemporaryDirectory() as tmp:
        report = run_soak(tmp, clients=64, runs_per_client=40,
                          threads=8, seed=seed, min_ratio=10.0)
        # the store the soak filled must fsck clean (RUNBOOK drill:
        # "recover the corpus store after a torn write" runs the same
        # verify with repair=True)
        fsck = FleetStore(Path(tmp) / "store").verify()
        assert not fsck["torn"] and not fsck["missing"], fsck
        report["store_fsck_ok"] = fsck["ok"]
    print(json.dumps(report, indent=1))
    print("fleet-smoke PASS (zero lost, aggregate == serial replay, "
          f"delta {report['delta_ratio']}x smaller, store fsck clean)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
