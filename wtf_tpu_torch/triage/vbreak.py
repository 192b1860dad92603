"""Virtual-breakpoint replay: batched root-cause snapshots (copied from
wtf_tpu/triage/vbreak.py, its imports rewritten).

The PAPERS.md "Virtual Breakpoints for x86/64" leg: the overlay/SMC
machinery already detects armed breakpoints per lane pre-execution (the
uop table's bp column — the batched 0xcc analog), so "break at
instruction N across thousands of perturbed replays" is one sweep of
the shared replay core with a capture handler armed:

  * arm a breakpoint at a target RIP (symbol or address);
  * replay a batch of testcases (typically a crasher and its perturbed
    neighborhood — `perturbations()` builds a deterministic one);
  * per lane, on the `hit`-th arrival at that RIP with at least
    `min_icount` instructions retired, snapshot the register file plus
    a guest-memory window (default: the top of stack) and park the
    lane; lanes that never arrive report their natural result.

Captures are exact: the device parks the lane AT the armed instruction
(nothing about it has executed), so a capture equals the EmuCpu
oracle's state at the same arrival — the differential
tests/test_torch_triage.py pins via `oracle_capture`, which runs the
identical handler on the single-step backend.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from wtf_tpu_torch.core.results import Ok, TestcaseResult
from wtf_tpu_torch.telemetry import Registry
from wtf_tpu_torch.triage.bucket import TOS_BYTES
from wtf_tpu_torch.triage.replay import ReplayCore


@dataclasses.dataclass
class BreakCapture:
    """One lane's snapshot at the armed instruction."""

    index: int                  # testcase index in the sweep
    hit: int                    # which arrival triggered the capture
    rip: int
    gpr: Tuple[int, ...]        # rax..r15 (encoding order)
    rflags: int
    icount: int
    mem_gva: int                # window base (rsp when unspecified)
    mem: bytes                  # the captured window (b"" = unreadable)

    def as_dict(self) -> dict:
        return {
            "index": self.index, "hit": self.hit,
            "rip": hex(self.rip),
            "gpr": [hex(v) for v in self.gpr],
            "rflags": hex(self.rflags), "icount": self.icount,
            "mem_gva": hex(self.mem_gva), "mem": self.mem.hex(),
        }


def _capture(backend, index: int, hit: int, mem_gva: Optional[int],
             mem_len: int) -> BreakCapture:
    gva = mem_gva if mem_gva is not None else backend.get_reg(4)
    try:
        mem = backend.virt_read(gva, mem_len)
    except Exception:
        mem = b""
    return BreakCapture(
        index=index, hit=hit, rip=backend.get_rip(),
        gpr=tuple(backend.get_reg(i) for i in range(16)),
        rflags=backend.get_rflags(), icount=backend.get_icount(),
        mem_gva=gva, mem=mem)


def vbreak(backend, target, testcases: Sequence[bytes], break_rip: int,
           *, hit: int = 1, min_icount: int = 0,
           mem_gva: Optional[int] = None, mem_len: int = TOS_BYTES,
           registry: Optional[Registry] = None, events=None
           ) -> Tuple[List[Optional[BreakCapture]], List[TestcaseResult]]:
    """Replay `testcases` with a virtual breakpoint armed at
    `break_rip`; returns (captures, results) index-aligned with the
    input.  A captured lane's result is Ok (parked at the break);
    None in `captures` means that replay never satisfied the break
    condition (crashed/finished/timed out first — its result says
    which)."""
    core = ReplayCore(backend, target, registry=registry, events=events)
    registry, events = core.registry, core.events
    if break_rip in backend.breakpoints:
        raise ValueError(
            f"breakpoint already armed at {break_rip:#x} (target init "
            "owns it) — vbreak needs an unclaimed RIP")
    captures: Dict[int, BreakCapture] = {}
    hits: Dict[int, int] = {}
    base = {"start": 0}

    def handler(b):
        index = base["start"] + b.current_lane
        n = hits.get(index, 0) + 1
        hits[index] = n
        if n < hit or b.get_icount() < min_icount:
            return  # not yet: lane resumes past the bp (bp_skip)
        captures[index] = _capture(b, index, n, mem_gva, mem_len)
        b.stop(Ok())

    backend.set_breakpoint(break_rip, handler)
    try:
        sweep = core.replay(
            testcases,
            on_batch_start=lambda start: base.update(start=start))
    finally:
        backend.breakpoints.pop(break_rip, None)
        runner = getattr(backend, "runner", None)
        if runner is not None:
            runner.cache.clear_breakpoint(break_rip)
    registry.counter("triage.captures").inc(len(captures))
    events.emit("triage-vbreak", rip=hex(break_rip),
                testcases=len(sweep.results), captures=len(captures))
    return ([captures.get(i) for i in range(len(sweep.results))],
            sweep.results)


def oracle_capture(emu_backend, target, data: bytes, break_rip: int,
                   *, hit: int = 1, min_icount: int = 0,
                   mem_gva: Optional[int] = None, mem_len: int = TOS_BYTES,
                   index: int = 0) -> Optional[BreakCapture]:
    """The same capture on the single-step EmuCpu backend — the
    differential oracle for `vbreak` (and a debugging convenience:
    `python -m wtf_tpu_torch triage vbreak --backend emu` routes here).
    `index` labels the capture with the caller's sweep position, matching
    the batched path's indexing."""
    state: Dict[int, BreakCapture] = {}
    hits = {"n": 0}

    def handler(b):
        hits["n"] += 1
        if hits["n"] < hit or b.get_icount() < min_icount:
            return
        state[0] = _capture(b, index, hits["n"], mem_gva, mem_len)
        b.stop(Ok())

    emu_backend.set_breakpoint(break_rip, handler)
    try:
        target.insert_testcase(emu_backend, data)
        emu_backend.run()
    finally:
        emu_backend.breakpoints.pop(break_rip, None)
        emu_backend.restore()
        target.restore()
    return state.get(0)


def perturbations(data: bytes, count: int) -> List[bytes]:
    """A deterministic perturbed neighborhood of `data` for vbreak
    sweeps: variant k flips byte (k * PHI) mod len by XOR with a
    splitmix-derived value — pure function of (data, count), so sweeps
    replay identically anywhere."""
    from wtf_tpu_torch.utils.hashing import splitmix64

    out = [bytes(data)]
    if not data:
        return out[:max(count, 1)]
    for k in range(1, count):
        x = splitmix64(k)
        pos = x % len(data)
        flip = (x >> 32) & 0xFF or 0xFF
        b = bytearray(data)
        b[pos] ^= flip
        out.append(bytes(b))
    return out
