"""Observability smoke: the counterpart of wtf_tpu/testing/obs_smoke.py.

    python -m wtf_tpu_torch.testing.obs_smoke --device cpu

(`--device` defaults to cuda, like every entry point of the port).  The
fleet telemetry plane + the trace timeline, two legs, both on the port's
production code paths:

  fleet    a real master (dist/server.py reactor) and 4 WTF3 sim
           clients (fleet/soak.py) with PRIVATE metric registries,
           scripted socket faults and scripted verbatim-duplicate
           TAG_TELEM frames.  Asserts the aggregated fleet snapshot is
           byte-equal to the serial sum (merge_snapshots) of the
           per-node snapshots the clients last sent — reconnects and
           re-sent frames must not double-count — and that the export
           surface (status.json / telemetry.prom / fleet-telem.jsonl)
           landed.

  local    one short demo_tlv megachunk campaign through the port's CLI
           on `--device` with --telemetry-dir and --trace-out from the
           SAME run.  Asserts `status` renders (human and --json), and
           the Chrome-trace JSON is schema-valid with >=1 fenced device
           span and >=1 megachunk-window span.

Exit 0 and a PASS line on success; any broken invariant raises.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import tempfile
import threading
from pathlib import Path


def _fleet_leg(tmp: Path, clients: int = 4, runs_per_client: int = 24,
               seed: int = 0x0B5) -> dict:
    from wtf_tpu_torch.dist.server import Server
    from wtf_tpu_torch.fleet.soak import CoverageModel, SimClient, _drive
    from wtf_tpu_torch.fuzz.corpus import Corpus
    from wtf_tpu_torch.fuzz.mutator import ByteMutator
    from wtf_tpu_torch.telemetry import Registry
    from wtf_tpu_torch.telemetry.metrics import merge_snapshots

    import random

    export = tmp / "export"
    address = f"unix://{tmp}/obs.sock"
    rng = random.Random(seed)
    seeds = [bytes(rng.randrange(256) for _ in range(32))]
    runs = clients * runs_per_client
    corpus = Corpus(outputs_dir=tmp / "outputs", rng=rng)
    server = Server(address, ByteMutator(rng, 64), corpus,
                    crashes_dir=tmp / "crashes", runs=runs,
                    coverage_path=tmp / "coverage.cov",
                    stats_every=2.0, telemetry_dir=export)
    server.paths = list(seeds)
    server_thread = threading.Thread(target=server.run,
                                     kwargs={"max_seconds": 300.0})
    server_thread.start()

    model = CoverageModel(common=200)
    sims = []
    for i in range(clients):
        # every client: telem each run, every 3rd frame sent twice; the
        # first takes a pre-send drop (reclaim), the second a post-send
        # reset (pure reconnect) — the chaos dial of the fleet soak
        faults = {}
        if i == 0:
            faults[2] = "drop"
        elif i == 1:
            faults[3] = "reset"
        sims.append(SimClient(address, model, "delta", seed ^ (i << 8),
                              Registry(), faults=faults,
                              telem_every=1, telem_dup_every=3))
    _drive(sims)
    server_thread.join(timeout=300.0)
    assert not server_thread.is_alive(), "master did not finish"

    fleet = server.fleet_telem
    assert len(fleet.nodes) == clients, \
        f"aggregator saw {len(fleet.nodes)} nodes, expected {clients}"
    dups_sent = sum(s.telem_dups_sent for s in sims)
    assert dups_sent > 0, "no duplicate frames were scripted"
    # a duplicate riding a socket a scripted fault then kills can be
    # lost with its original (symmetric, harmless), so the bar is that
    # the seq-dedup path FIRED — the JAX package's tests/test_obs.py pins
    # exact counts fault-free — and that it never misfired into an error
    assert fleet.duplicates >= 1, \
        "scripted duplicate frames were not dropped by sequence number"
    assert server.registry.counter("fleet.telem_errors").value == 0, \
        "telemetry frames were rejected as malformed"
    faults_hit = sum(s.drops + s.resets for s in sims)
    assert faults_hit >= 2, "scripted socket faults did not fire"

    # THE tentpole exactness bar: the aggregate == the serial sum of
    # what the nodes last reported, byte-equal after canonical dumps
    want = merge_snapshots(
        s.last_telem for s in sims if s.last_telem is not None)
    got = fleet.fleet_snapshot()
    assert json.dumps(got, sort_keys=True) == \
        json.dumps(want, sort_keys=True), \
        ("fleet aggregate diverged from the serial sum of node "
         f"snapshots: {len(got)} vs {len(want)} metrics")
    execs = sum(int((s.last_telem.get("campaign.testcases") or
                     {}).get("value", 0)) for s in sims if s.last_telem)
    assert execs > 0, "node snapshots carried no testcase counters"

    status = json.loads((export / "status.json").read_text())
    assert status["kind"] == "fleet" and status["nodes"] == clients
    assert len(status["per_node"]) == clients
    prom = (export / "telemetry.prom").read_text()
    assert prom.startswith("# TYPE wtf_") and "wtf_campaign_testcases" \
        in prom, "prometheus export malformed"
    stream = [json.loads(line) for line in
              (export / "fleet-telem.jsonl").read_text().splitlines()]
    assert len(stream) == fleet.frames, \
        f"stream has {len(stream)} records, aggregator applied " \
        f"{fleet.frames}"
    return {"nodes": clients, "frames": fleet.frames,
            "duplicates_dropped": fleet.duplicates,
            "faults": faults_hit, "fleet_execs": execs}


def _local_leg(tmp: Path, device: str) -> dict:
    from wtf_tpu_torch.cli import main as cli_main

    camp = tmp / "campaign"
    trace_path = tmp / "trace.json"
    rc = cli_main(["campaign", "--name", "demo_tlv", "--backend", "gpu",
                   "--device", device, "--fused-step", "auto",
                   "--runs", "64", "--lanes", "8", "--limit", "200",
                   "--mutator", "devmangle", "--megachunk", "2",
                   "--seed", "7", "--telemetry-dir", str(camp),
                   "--trace-out", str(trace_path)])
    assert rc == 0, f"campaign exited {rc}"

    status = json.loads((camp / "status.json").read_text())
    assert status["kind"] == "campaign" and status["line"], \
        "campaign status.json missing the heartbeat line"
    assert cli_main(["status", str(camp)]) == 0
    assert cli_main(["status", str(camp), "--json"]) == 0

    doc = json.loads(trace_path.read_text())
    events = doc["traceEvents"]
    assert isinstance(events, list) and events, "empty trace"
    for ev in events:
        assert ev["ph"] in ("X", "i") and ev["ts"] >= 0
        if ev["ph"] == "X":
            assert ev["dur"] >= 0
    device_spans = [ev for ev in events
                    if ev["ph"] == "X" and ev["cat"] == "device"]
    window_spans = [ev for ev in events
                    if ev["name"] == "megachunk-window"]
    assert device_spans, "no fenced device span in the trace"
    assert window_spans, "no megachunk-window span in the trace"
    return {"trace_events": len(events),
            "device_spans": len(device_spans),
            "window_spans": len(window_spans)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a CUDA device), "
                         "cuda:N, or cpu")
    device = ap.parse_args(argv).device
    logging.getLogger("wtf_tpu_torch").setLevel(logging.ERROR)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        fleet = _fleet_leg(tmp)
        local = _local_leg(tmp, device)
    report = {**fleet, **local}
    print(json.dumps(report, indent=1))
    print(f"obs smoke PASS ({report['nodes']} nodes aggregate == serial "
          f"sum with {report['duplicates_dropped']} duplicate(s) "
          f"dropped; trace valid with {report['device_spans']} device + "
          f"{report['window_spans']} window span(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
