"""Corpus distillation: one batched sweep, exact attribution, set cover
(copied from wtf_tpu/triage/distill.py, its imports rewritten).

The campaign's `--runs 0` minset keeps testcases that were FIRST to set
a bit in replay order (the reference master's semantics, server.h:
552-556) — stateless and order-dependent.  This module replaces the
measurement half with an exact-attribution path on the same hardware:

  1. re-execute the whole corpus through the shared replay core
     (triage/replay.py — `FuzzLoop.minset` runs on the identical path);
  2. per-testcase edge attribution comes straight off the coverage
     bitmaps: the first-hit prefix credit, computed on the device
     (meshrun/reduce.first_hit_credit — `_merge_core`'s scan keeping
     the planes), plus each testcase's FULL cov/edge rows;
  3. the greedy set cover runs on host over the full rows, so the kept
     subset provably reproduces the complete corpus' aggregate coverage
     (usually strictly smaller than the prefix-credit keep set, which
     is also returned — it is byte-compatible with the old minset).

Determinism: replay order is the caller's list order; the credit scan,
cover tie-breaks (highest gain, lowest index) and all counters are pure
functions of the sweep, so the port's sweep equals the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from wtf_tpu_torch.telemetry import Registry
from wtf_tpu_torch.triage.replay import ReplayCore, ReplaySweep

# byte -> popcount table (numpy < 2.0 has no bitwise_count ufunc)
_POPCOUNT = np.array([bin(i).count("1") for i in range(256)],
                     dtype=np.uint16)


def popcount_rows(planes: np.ndarray) -> np.ndarray:
    """Per-row set-bit count of a [N, W] u32 bit-plane."""
    return _POPCOUNT[planes.view(np.uint8)].sum(axis=1).astype(np.int64)


def greedy_cover(planes: np.ndarray) -> List[int]:
    """Greedy set cover over [N, W] row bitmaps: repeatedly keep the row
    covering the most still-uncovered bits (ties: lowest index) until
    the union of kept rows equals the union of all rows.  Exact
    coverage preservation by construction; minimality is the usual
    greedy ln(n) approximation."""
    if planes.shape[0] == 0:
        return []
    union = np.bitwise_or.reduce(planes, axis=0)
    covered = np.zeros_like(union)
    keep: List[int] = []
    while not np.array_equal(covered, union):
        gains = popcount_rows(planes & ~covered[None, :])
        best = int(np.argmax(gains))  # argmax returns the first maximum
        if gains[best] == 0:
            break  # defensive: cannot happen while covered != union
        keep.append(best)
        covered |= planes[best]
    return keep


@dataclasses.dataclass
class DistillResult:
    keep: List[int]            # greedy-cover indices (replay order)
    prefix_keep: List[int]     # first-hit credit indices (old minset set)
    credit_bits: np.ndarray    # int64[N] exact per-testcase credit
    total_bits: int            # aggregate corpus coverage (cov+edge bits)
    kept_bits: int             # aggregate coverage of the kept subset
    sweep: ReplaySweep         # the raw sweep (results, planes, buckets)

    def __post_init__(self):
        # a real exception, not `assert`: the RUNBOOK promises this
        # invariant holds unconditionally, python -O included
        if self.kept_bits != self.total_bits:
            raise RuntimeError(
                f"greedy cover lost coverage ({self.kept_bits} of "
                f"{self.total_bits} bits) — set-cover invariant broken")


def distill(backend, target, testcases: Sequence[bytes],
            registry: Optional[Registry] = None, events=None,
            batch_size: Optional[int] = None,
            on_batch=None, after_batch=None) -> DistillResult:
    """Distill `testcases` (replayed in list order) to a minimal subset
    with identical aggregate coverage.  The optional callbacks thread
    straight through to the replay core (accounting / heartbeats)."""
    core = ReplayCore(backend, target, registry=registry, events=events,
                      batch_size=batch_size)
    registry, events = core.registry, core.events
    testcases = list(testcases)
    sweep = core.replay(testcases, collect_planes=True, attribute=True,
                        want_buckets=True, on_batch=on_batch,
                        after_batch=after_batch)
    n = len(testcases)
    if n == 0:
        empty = np.zeros(0, dtype=np.int64)
        return DistillResult([], [], empty, 0, 0, sweep)
    planes = np.concatenate([sweep.cov, sweep.edge], axis=1)
    credit = np.concatenate([sweep.credit_cov, sweep.credit_edge], axis=1)
    credit_bits = popcount_rows(credit)
    prefix_keep = [i for i in range(n) if credit_bits[i] > 0]
    keep = greedy_cover(planes)
    union = np.bitwise_or.reduce(planes, axis=0)
    total_bits = int(popcount_rows(union[None, :])[0])
    kept = (np.bitwise_or.reduce(planes[keep], axis=0)
            if keep else np.zeros_like(union))
    kept_bits = int(popcount_rows(kept[None, :])[0])
    registry.counter("triage.minset_before").inc(n)
    registry.counter("triage.minset_after").inc(len(keep))
    events.emit("triage-distill", corpus=n, kept=len(keep),
                prefix_kept=len(prefix_keep), total_bits=total_bits,
                dispatches=core.stats["dispatches"])
    return DistillResult(keep=keep, prefix_keep=prefix_keep,
                         credit_bits=credit_bits, total_bits=total_bits,
                         kept_bits=kept_bits, sweep=sweep)
