"""Per-tenant checkpoints: the scheduler's preemption primitive.

The counterpart of wtf_tpu/tenancy/state.py.  A tenant checkpoint reuses
the campaign-checkpoint format (wtf_tpu_torch/resume: digest-embedded
atomic doc, content-addressed corpus blobs, `.prev` fallback) with two
placement-freeing twists:

  decode cache   only the TENANT's entries are persisted, untagged and
                 in insertion order — a resumed placement re-tags them
                 with whatever tenant index the scheduler assigns next;
  coverage       the tenant's cov bit-plane is REMAPPED from global
                 decode-cache entry indices to tenant-local positions
                 (bit j = the tenant's j-th entry).  Within-tenant
                 insertion order is placement-invariant (lane order is
                 preserved inside a tenant's range), so the local plane
                 equals what a solo run of the campaign would hold —
                 restore scatters it back through the indices the new
                 placement's cache assigns.  Edge planes are hash-
                 indexed and travel as-is.

Checkpoint tenant A at a batch boundary, hand its lanes to tenant B,
resume A later — bit-identically (tests/test_tenancy.py preemption
sweep; the acceptance drill rides `wtf-tpu sched`).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from wtf_tpu_torch.resume.checkpoint import (
    CheckpointError, _rng_state, _set_rng_state, load_campaign,
    restore_corpus, write_checkpoint,
)
from wtf_tpu_torch.utils.hashing import hex_digest

TENANT_COUNTER_KINDS = ("", ".devmut")  # tenant.<name>[kind].* namespaces


def extract_bits(words: np.ndarray, idxs: Sequence[int]) -> np.ndarray:
    """Global bit-plane -> tenant-local plane: local bit j is global bit
    idxs[j]."""
    out = np.zeros((max(len(idxs), 1) + 31) // 32, dtype=np.uint32)
    for j, i in enumerate(idxs):
        if (int(words[i >> 5]) >> (i & 31)) & 1:
            out[j >> 5] |= np.uint32(1 << (j & 31))
    return out


def scatter_bits(local: np.ndarray, idxs: Sequence[int],
                 n_words: int) -> np.ndarray:
    """Tenant-local plane -> global bit-plane under a new index map."""
    out = np.zeros(n_words, dtype=np.uint32)
    for j, i in enumerate(idxs):
        if (int(local[j >> 5]) >> (j & 31)) & 1:
            out[i >> 5] |= np.uint32(1 << (i & 31))
    return out


def _tenant_prefixes(name: str) -> Tuple[str, ...]:
    return tuple(f"tenant.{name}{kind}." for kind in TENANT_COUNTER_KINDS)


def save_tenant(backend, rt, t: int, directory) -> dict:
    """Checkpoint tenant `rt` (TenantRuntime at table index `t`) into
    `directory`.  Call at a batch boundary (machine freshly restored)."""
    runner = backend.runner
    cov, edge = backend.tenant_coverage_state(t)
    entries = runner.cache.tenant_entries(t)
    idxs = [e[0] for e in entries]
    mut_rng = getattr(rt.mutator, "rng", None)
    state = {
        "config": {
            "kind": "tenant",
            "target": rt.target.name,
            "lanes": rt.quota,
            "mutator": type(rt.mutator).__name__,
        },
        "batches": rt.batches_done,
        "stats": rt.registry.counters_state(_tenant_prefixes(rt.name)),
        "crash_names": sorted(rt.crash_names),
        "crash_buckets": sorted(rt.crash_buckets),
        "requeue": [data.hex() for data in rt.requeue],
        "requeue_digests": sorted(rt.requeue_digests),
        "rng": {
            "corpus": _rng_state(rt.rng),
            "mutator": ("shared" if mut_rng is rt.rng
                        else _rng_state(mut_rng)),
        },
        "mutator": rt.mutator.checkpoint_state(),
        "coverage": {"cov": extract_bits(cov, idxs), "edge": edge},
        "runner": {
            "cache": [(rip, raw, p0, p1)
                      for (_i, rip, raw, p0, p1) in entries],
            "smc_updates": [[r, n]
                            for (tt, r), n in runner._smc_updates.items()
                            if tt == t],
        },
        "corpus_manifest": [hex_digest(data) for data in rt.corpus],
    }
    return write_checkpoint(state, directory, list(rt.corpus))


def restore_tenant(backend, rt, t: int, directory) -> int:
    """Install a tenant checkpoint into a freshly-placed runtime (backend
    initialized, target init done).  Returns the batch index the tenant
    resumes after."""
    state, _fell_back = load_campaign(directory)
    cfg = state.get("config", {})
    checks = (("target", rt.target.name), ("lanes", rt.quota),
              ("mutator", type(rt.mutator).__name__))
    for key, current in checks:
        saved = cfg.get(key)
        if saved is not None and saved != current:
            raise CheckpointError(
                f"tenant checkpoint {key}={saved!r} but this placement "
                f"has {key}={current!r} — resume needs the same target, "
                "lane quota, and mutation engine (lane RANGE and mesh "
                "layout may differ; state is placement-free)")
    restore_corpus(rt.corpus, state, directory)
    rng = state.get("rng", {})
    _set_rng_state(rt.rng, rng.get("corpus"))
    mut_state = rng.get("mutator")
    if mut_state != "shared":
        _set_rng_state(getattr(rt.mutator, "rng", None), mut_state)
    rt.crash_names = set(state.get("crash_names", []))
    rt.crash_buckets = set(state.get("crash_buckets", []))
    rt.requeue = [bytes.fromhex(h) for h in state.get("requeue", [])]
    rt.requeue_digests = set(state.get("requeue_digests", []))
    runner = backend.runner
    # re-tag the tenant's decode entries under the NEW placement index
    # and record the global indices they land at — the coverage remap
    from wtf_tpu_torch.cpu.decoder import decode

    saved_cache = state.get("runner", {}).get("cache", [])
    idxs: List[int] = []
    for rip, raw, p0, p1 in saved_cache:
        idxs.append(runner.cache.add(int(rip), decode(raw, int(rip)),
                                     int(p0), int(p1), tenant=t))
    coverage = state.get("coverage", {})
    n_words = backend.tenant_coverage_state(t)[0].shape[0]
    backend.restore_tenant_coverage(
        t, scatter_bits(coverage["cov"], idxs, n_words),
        np.asarray(coverage["edge"]))
    for r, n in state.get("runner", {}).get("smc_updates", []):
        runner._smc_updates[(t, int(r))] = int(n)
    rt.mutator.restore_state(state.get("mutator", {}))
    rt.registry.restore_counters(state.get("stats", {}))
    rt.batches_done = int(state.get("batches", 0))
    rt.registry.counter(f"tenant.{rt.name}.resumes").inc()
    rt.events.emit("tenant-resume", tenant=rt.name,
                   batch=rt.batches_done, corpus=len(rt.corpus),
                   directory=str(Path(directory)))
    return rt.batches_done
