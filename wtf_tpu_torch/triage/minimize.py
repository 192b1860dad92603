"""Batched crash minimization: thousands of candidate reductions per
dispatch, bisecting to a minimal reproducer in a handful of dispatches.

The counterpart of wtf_tpu/triage/minimize.py.  The reference minimizes
host-serially (one emulator, one candidate at a time); here each round
builds a whole batch of candidates on the device from the current best
reproducer (triage/candidates.py), lands them through the insert seam
(`Runner.device_insert` via `GpuBackend.run_batch_words`), and keeps the
best candidate that still reproduces the SAME crash bucket
(triage/bucket.py — kind + faulting RIP + top-of-stack hash, so "still
reproduces" means the same bug).

Two phases, both greedy and fully deterministic (no RNG — the schedule
is a pure function of the current length):

  structural   rounds of all truncations + a coarse-to-fine grid of
               block deletions; each round keeps the strictly shortest
               surviving candidate (ties: most zero bytes, then lowest
               descriptor index) and re-derives the schedule from it
  simplify     one sweep of single-byte zeroing candidates; every byte
               whose zeroing individually preserved the bucket is
               applied at once, then the combined reproducer is
               verified in one more dispatch (afl-tmin's scheme) —
               falling back to the unsimplified reproducer when byte
               interactions break the combination

A round of a length-L reproducer is ~L truncations + ~2L deletions ≈
ceil(3L / lanes) dispatches.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from wtf_tpu_torch.core.results import Crash
from wtf_tpu_torch.telemetry import Registry
from wtf_tpu_torch.triage.bucket import crash_kind
from wtf_tpu_torch.triage.candidates import (
    OP_DELETE, OP_TRUNCATE, OP_ZERO, build_candidates, pack_testcase,
    upload, zero_counts,
)
from wtf_tpu_torch.triage.replay import ReplayCore

# descriptor ceiling per structural round; the schedule degrades from
# exhaustive to a pow2-spaced grid when a long input would exceed it
MAX_ROUND_CANDIDATES = 1 << 14


@dataclasses.dataclass
class MinimizeResult:
    data: bytes              # the minimized reproducer
    bucket: str              # its (and the original's) crash bucket
    from_len: int            # original crasher length
    rounds: int              # structural rounds executed
    dispatches: int          # device dispatches consumed (all phases)
    candidates: int          # candidates executed (all phases)
    simplified: int          # bytes zeroed by the simplify phase


def _structural_schedule(cur_len: int) -> List[Tuple[int, int, int]]:
    """(op, pos, size) descriptors for one structural round: every
    truncation (pow2-thinned past the candidate ceiling) + block
    deletions from half the length down to 1 byte, positions stepping
    by the block size."""
    descs: List[Tuple[int, int, int]] = []
    if cur_len <= 1:
        return descs
    step = 1
    while (cur_len - 1) // step > MAX_ROUND_CANDIDATES // 3:
        step *= 2
    for ln in range(1, cur_len, step):
        descs.append((OP_TRUNCATE, ln, 0))
    size = max(cur_len // 2, 1)
    while size >= 1:
        for pos in range(0, cur_len, size):
            descs.append((OP_DELETE, pos, size))
            if len(descs) >= MAX_ROUND_CANDIDATES:
                return descs
        if size == 1:
            break
        size //= 2
    return descs


def _descriptors(chunk, lanes: int, device):
    """One dispatch's (ops, pos, size) tensors, padded with identity
    zero-descriptors to the full lane count."""
    pad = lanes - len(chunk)
    ops = np.array([d[0] for d in chunk] + [OP_ZERO] * pad, dtype=np.int32)
    pos = np.array([d[1] for d in chunk] + [0] * pad, dtype=np.int64)
    size = np.array([d[2] for d in chunk] + [0] * pad, dtype=np.int64)
    return tuple(torch.from_numpy(a).to(device) for a in (ops, pos, size))


def _run_schedule(core: ReplayCore, cur: bytes, descs, max_len: int,
                  base_kind: str):
    """Execute a descriptor list against the current reproducer in
    n_lanes-sized dispatches.  Returns per-descriptor
    (len, zeros, bucket-or-None); winner bytes are re-built and fetched
    by `_fetch_candidate` — candidates are deterministic functions of
    (cur, descriptor), so dispatches need no retention."""
    cur_words, cur_len = pack_testcase(cur, max_len)
    cur_dev = upload(cur_words, core.device)
    lanes = core.n_lanes
    out = []
    for start in range(0, len(descs), lanes):
        chunk = descs[start:start + lanes]
        words, lens = build_candidates(
            cur_dev, cur_len, *_descriptors(chunk, lanes, core.device))
        zeros = zero_counts(words, lens)
        results, buckets = core.replay_device(words, lens, len(chunk),
                                              base_kind=base_kind)
        lens_h = lens.cpu().numpy()
        zeros_h = zeros.cpu().numpy()
        for lane in range(len(chunk)):
            out.append((int(lens_h[lane]), int(zeros_h[lane]),
                        buckets.get(lane)))
    return out


def _fetch_candidate(core: ReplayCore, cur: bytes, descs, max_len: int,
                     index: int) -> bytes:
    """Re-build the dispatch holding descriptor `index` and pull that
    one lane's bytes (ONE row read)."""
    cur_words, cur_len = pack_testcase(cur, max_len)
    lanes = core.n_lanes
    start = (index // lanes) * lanes
    chunk = descs[start:start + lanes]
    words, lens = build_candidates(
        upload(cur_words, core.device), cur_len,
        *_descriptors(chunk, lanes, core.device))
    lane = index - start
    row = words[lane].cpu().numpy()
    ln = int(lens[lane].item())
    return row.tobytes()[:ln]


def minimize(backend, target, crasher: bytes,
             registry: Optional[Registry] = None, events=None,
             max_rounds: int = 64) -> MinimizeResult:
    """Minimize `crasher` against `target` on an initialized batched
    backend.  Raises ValueError when the input does not reproduce a
    crash under batch replay (the identity dispatch is the baseline)."""
    core = ReplayCore(backend, target, registry=registry, events=events)
    registry, events = core.registry, core.events
    spec, _ = core.device_spec()
    max_len = spec.max_len
    crasher = bytes(crasher[:max_len])
    if not crasher:
        raise ValueError("empty testcase cannot be minimized")
    dispatches0 = core.stats["dispatches"]
    candidates0 = core.stats["candidates"]

    # baseline: the identity candidate through the SAME device insert
    # path every later candidate takes — one replay path, one bucket
    def identity_sweep(data: bytes):
        cur_words, cur_len = pack_testcase(data, max_len)
        words, lens = build_candidates(
            upload(cur_words, core.device), cur_len,
            *_descriptors([], core.n_lanes, core.device))
        return core.replay_device(words, lens, 1)

    results, buckets = identity_sweep(crasher)
    if not isinstance(results[0], Crash):
        raise ValueError(
            f"input does not reproduce a crash under batch replay "
            f"(got {results[0]}) — nothing to minimize")
    base_bucket = buckets[0]
    base_kind = crash_kind(results[0])
    events.emit("triage-minimize-start", bytes=len(crasher),
                bucket=base_bucket)

    cur = crasher
    rounds = 0
    # structural phase: shortest surviving candidate per round
    while rounds < max_rounds:
        descs = _structural_schedule(len(cur))
        if not descs:
            break
        outcomes = _run_schedule(core, cur, descs, max_len, base_kind)
        best = None  # (len, -zeros, index)
        for i, (ln, zeros, bucket) in enumerate(outcomes):
            if bucket != base_bucket or ln >= len(cur):
                continue
            key = (ln, -zeros, i)
            if best is None or key < best:
                best = key
        rounds += 1
        # attempted rounds, improving or not — the counter, the CLI
        # line and the minimize-end event must agree on one number
        registry.counter("triage.minimize_rounds").inc()
        if best is None:
            break
        cur = _fetch_candidate(core, cur, descs, max_len, best[2])

    # simplify phase: zero every byte that individually survives, then
    # verify the combination in one dispatch
    simplified = 0
    nonzero = [i for i, byte in enumerate(cur) if byte]
    if nonzero:
        descs = [(OP_ZERO, i, 1) for i in nonzero]
        outcomes = _run_schedule(core, cur, descs, max_len, base_kind)
        good = [pos for (_, _, bucket), (_, pos, _) in
                zip(outcomes, descs) if bucket == base_bucket]
        if good:
            combined = bytearray(cur)
            for pos in good:
                combined[pos] = 0
            combined = bytes(combined)
            _, buckets = identity_sweep(combined)
            if buckets.get(0) == base_bucket:
                cur = combined
                simplified = len(good)
            # else: byte interactions break the union — keep the
            # structurally-minimal reproducer (documented fallback)

    removed = len(crasher) - len(cur)
    registry.counter("triage.bytes_removed").inc(removed)
    registry.counter("triage.minimizations").inc()
    dispatches = core.stats["dispatches"] - dispatches0
    events.emit("triage-minimize-end", from_bytes=len(crasher),
                to_bytes=len(cur), bucket=base_bucket, rounds=rounds,
                dispatches=dispatches, simplified=simplified)
    return MinimizeResult(
        data=cur, bucket=base_bucket, from_len=len(crasher),
        rounds=rounds, dispatches=dispatches,
        candidates=core.stats["candidates"] - candidates0,
        simplified=simplified)
