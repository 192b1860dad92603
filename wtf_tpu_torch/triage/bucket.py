"""Triage-grade crash bucketing: the ONE dedup key for "same crash".

The reference buckets crashes by output filename, which here was the
`Crash.name` string — `crash-<kind>-<fault gva>`.  That key both
under-merges (the same bug reached through two corrupted pointers gets
two names) and over-merges (two distinct bugs faulting on the same
wild address get one).  The triage-grade key is the classic tuple:

  (crash kind, faulting RIP, top-of-stack hash)

  kind      the fault class token out of the result name ("execute",
            "read", "write", "de", "int", ...; harness-stopped crashes
            keep their full custom name as the kind)
  rip       the lane's RIP at the fault — the faulting instruction for
            read/write/#DE, the wild fetch target for execute faults
  tos hash  blake2b-64 of the TOS_BYTES bytes at rsp, read through the
            lane's own memory view — distinguishes call paths that
            fault at the same instruction

Every consumer goes through `bucket_of(backend, lane, result)`:
`FuzzLoop`'s harvest dedups found crashes by it, and
`triage/minimize.py`'s bisection accepts a candidate only when its
bucket equals the original crasher's — so "still reproduces" means the
same bug, not merely any crash.  It degrades to the result name on
backends without register/memory introspection, never raises.
"""

from __future__ import annotations

import hashlib

from wtf_tpu_torch.core.results import Crash, TestcaseResult

# stack window hashed into the bucket key.  Small enough that reading it
# costs one page probe per crash lane; large enough to cover the caller
# frame that distinguishes call paths.
TOS_BYTES = 64

# result names shaped `crash-<kind>-<hex>` (backend/tpu._map_result /
# the oracle's equivalents); anything else is a harness-named crash and
# keeps its full name as the kind token
_KINDS = ("execute", "read", "write", "de", "int")


def crash_kind(result: TestcaseResult) -> str:
    """The fault-class token of a Crash result."""
    name = getattr(result, "name", None) or "crash"
    parts = name.split("-")
    if len(parts) >= 3 and parts[0] == "crash" and parts[1] in _KINDS:
        return parts[1]
    return name


def stack_hash(data: bytes) -> str:
    """blake2b-64 of a top-of-stack window ("nostack" for unreadable)."""
    if not data:
        return "nostack"
    return hashlib.blake2b(data, digest_size=8).hexdigest()


def make_bucket(kind: str, rip: int, tos: str) -> str:
    """The canonical bucket string (stable: checkpointed sets and event
    streams carry it verbatim)."""
    return f"{kind}.{rip:#x}.{tos}"


def bucket_of(backend, lane, result: TestcaseResult) -> str:
    """The triage bucket of a crashed lane — shared by the fuzz-loop
    harvest and the triage minimizer so both agree on "same crash".

    `lane` addresses the batched backend's machine state; pass None (or
    any value) for single-lane backends.  Non-Crash results and backends
    without the introspection seams fall back to the result name — the
    filename-grade key, still a valid (coarser) bucket."""
    if not isinstance(result, Crash):
        return getattr(result, "name", None) or type(result).__name__
    kind = crash_kind(result)
    try:
        runner = getattr(backend, "runner", None)
        if runner is not None and hasattr(backend, "_ensure_view"):
            # batched backend: one pooled HostView pull per batch
            # (backend._view caches until restore), page reads lazy
            view = backend._ensure_view()
            lane = int(lane or 0)
            rip = view.get_rip(lane)
            rsp = view.get_reg(lane, 4)
            try:
                tos = stack_hash(view.virt_read(lane, rsp, TOS_BYTES))
            except Exception:
                tos = "nostack"
            return make_bucket(kind, rip, tos)
        cpu = getattr(backend, "cpu", None)
        if cpu is not None:
            rip = int(cpu.rip)
            rsp = int(cpu.gpr[4])
            try:
                tos = stack_hash(backend.virt_read(rsp, TOS_BYTES))
            except Exception:
                tos = "nostack"
            return make_bucket(kind, rip, tos)
    except Exception:
        pass
    return getattr(result, "name", None) or "crash"
