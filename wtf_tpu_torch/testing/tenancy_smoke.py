"""Tenancy smoke: a fast end-to-end pass over the multi-tenant campaign
stack (wtf_tpu_torch/tenancy), the counterpart of
wtf_tpu/testing/tenancy_smoke.py.

    python -m wtf_tpu_torch.testing.tenancy_smoke --device cpu

(`--device` defaults to cuda, like every entry point of the port):

  isolation   a demo_tlv campaign run as a lane-subset of a mixed
              demo_tlv+demo_kernel batch must be bit-identical — local
              coverage plane, edge plane, corpus stream, crash buckets —
              to the same campaign run alone, and BOTH tenants of the
              mixed batch must find coverage (the heterogeneous dispatch
              really executes both base images);
  preemption  the `sched` drill: tenant A is checkpointed
              mid-campaign at a quantum boundary, its lanes backfilled
              with tenant B, and A resumed later — A's final corpus
              manifest, crash buckets and coverage planes must equal an
              uninterrupted run of the same job.

Exit 0 = all held; any assertion prints and exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

SEED_TLV = b"\x01\x04AAAA\x02\x08BBBBBBBB"
SEED_KERN = b"hello-world-123"
LIMIT = 50_000


def _runtime_cfg():
    return [("alice", "demo_tlv", 4, "tlv", 42, SEED_TLV),
            ("bob", "demo_kernel", 4, "mangle", 1337, SEED_KERN)]


def _run_mixed(cfg, batches, device):
    """Per-tenant fingerprints of a mixed MultiTenantLoop run."""
    from wtf_tpu_torch.harness.targets import Targets, load_builtin_targets
    from wtf_tpu_torch.tenancy.backend import TenantSpec, create_tenancy_backend
    from wtf_tpu_torch.tenancy.loop import MultiTenantLoop, TenantRuntime
    from wtf_tpu_torch.tenancy.state import extract_bits

    load_builtin_targets()
    targets = Targets.instance()
    specs = [TenantSpec(n, targets.get(t), targets.get(t).snapshot(), q)
             for n, t, q, _m, _s, _seed in cfg]
    backend = create_tenancy_backend(specs, sum(c[2] for c in cfg),
                                     limit=LIMIT, device=device)
    backend.initialize()
    for i, s in enumerate(specs):
        with backend.tenant_context(i):
            s.target.init(backend)
    runtimes, lane_lo = [], 0
    for i, (n, _t, q, m, seed, corpus_seed) in enumerate(cfg):
        rt = TenantRuntime(specs[i], seed=seed, runs=1 << 20,
                           mutator_name=m, max_len=256, lane_lo=lane_lo)
        rt.corpus.add(corpus_seed)
        runtimes.append(rt)
        lane_lo += q
    loop = MultiTenantLoop(backend, runtimes, stats_every=1e9)
    for _ in range(batches):
        loop.run_one_batch()
    out = {}
    for i, rt in enumerate(runtimes):
        cov, edge = backend.tenant_coverage_state(i)
        entries = backend.runner.cache.tenant_entries(i)
        local = extract_bits(cov, [e[0] for e in entries])
        out[rt.name] = {
            "local_cov": local.tobytes(),
            "edge": edge.tobytes(),
            "corpus": list(rt.corpus),
            "buckets": sorted(rt.crash_buckets),
            "covbits": int(sum(bin(int(w)).count("1") for w in cov)),
        }
    return out


def _ckpt_state(directory: Path) -> dict:
    from wtf_tpu_torch.resume.checkpoint import load_campaign

    state, _ = load_campaign(directory)
    return state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a CUDA device), "
                         "cuda:N, or cpu")
    device = ap.parse_args(argv).device
    cfg = _runtime_cfg()

    # -- isolation leg ---------------------------------------------------
    solo = _run_mixed(cfg[:1], batches=3, device=device)
    mixed = _run_mixed(cfg, batches=3, device=device)
    for name in ("alice", "bob"):
        assert mixed[name]["covbits"] > 0, f"{name}: no coverage in mix"
    for key in ("local_cov", "edge", "corpus", "buckets"):
        assert solo["alice"][key] == mixed["alice"][key], (
            f"isolation broken: alice {key} differs between solo and "
            "mixed batch")
    print(f"[tenancy-smoke] isolation: mixed batch == solo "
          f"(alice cov {mixed['alice']['covbits']} bits, "
          f"bob cov {mixed['bob']['covbits']} bits)")

    # -- preemption leg (the `sched` drill) -------------------------------
    from wtf_tpu_torch.cli import main as cli_main

    with tempfile.TemporaryDirectory(prefix="wtf-tenancy-smoke-") as td:
        root = Path(td)
        (root / "inputs_a").mkdir()
        (root / "inputs_a" / "seed").write_bytes(SEED_TLV)
        (root / "inputs_b").mkdir()
        (root / "inputs_b" / "seed").write_bytes(SEED_KERN)
        jobs = {"jobs": [
            {"name": "alice", "target": "demo_tlv", "lanes": 8,
             "runs": 48, "seed": 42, "mutator": "tlv", "max_len": 256,
             "inputs": str(root / "inputs_a")},
            {"name": "bob", "target": "demo_kernel", "lanes": 8,
             "runs": 32, "seed": 7, "mutator": "mangle", "max_len": 256,
             "inputs": str(root / "inputs_b")},
        ]}
        (root / "jobs.json").write_text(json.dumps(jobs))
        # lanes=8 fits ONE job at a time: with quantum=2 the scheduler
        # must preempt alice for bob and resume her later
        rc = cli_main(["sched", "--jobs", str(root / "jobs.json"),
                       "--workdir", str(root / "sched"),
                       "--lanes", "8", "--quantum", "2",
                       "--limit", str(LIMIT), "--device", device,
                       "--telemetry-dir", str(root / "tele")])
        assert rc in (0, 2), f"sched rc={rc}"
        events = [json.loads(line) for line in
                  (root / "tele" / "events.jsonl").read_text().splitlines()]
        kinds = {e["type"] for e in events}
        assert "sched-preempt" in kinds, "no preemption happened"
        completes = [e["tenant"] for e in events
                     if e["type"] == "sched-complete"]
        assert sorted(completes) == ["alice", "bob"], (
            f"jobs did not both complete: {completes}")
        resumes = [e for e in events if e["type"] == "tenant-resume"]
        assert resumes, "preempted job never resumed from its checkpoint"

        # parity: the preempted-and-resumed alice must end with the SAME
        # corpus manifest / crash buckets / coverage planes as one
        # uninterrupted run of the identical job
        from wtf_tpu_torch.tenancy.sched import Job, Scheduler

        straight = Scheduler(
            [Job(name="alice", target="demo_tlv", lanes=8, runs=48,
                 seed=42, mutator="tlv", max_len=256,
                 inputs=str(root / "inputs_a"))],
            n_lanes=8, workdir=root / "straight", limit=LIMIT,
            quantum=1 << 20, backend_tuning={"device": device})
        straight.run()
        got = _ckpt_state(root / "sched" / "alice" / "checkpoint")
        want = _ckpt_state(root / "straight" / "alice" / "checkpoint")
        for key in ("corpus_manifest", "crash_buckets", "batches"):
            assert got[key] == want[key], (
                f"preemption parity broken: {key} differs\n"
                f"  scheduled: {got[key]}\n  straight:  {want[key]}")
        for plane in ("cov", "edge"):
            assert (got["coverage"][plane]
                    == want["coverage"][plane]).all(), (
                f"preemption parity broken: {plane} plane differs")
        n_pre = sum(1 for e in events if e["type"] == "sched-preempt")
        print(f"[tenancy-smoke] preemption: {n_pre} preemption(s), "
              f"both jobs complete, resumed alice bit-identical to the "
              f"uninterrupted run ({len(got['corpus_manifest'])} corpus "
              f"entries, {len(got['crash_buckets'])} crash buckets)")
    print("[tenancy-smoke] PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
