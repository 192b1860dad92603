"""Deterministic chaos harness: scripted fault schedules over real seams.

The counterpart of wtf_tpu/testing/faultinject.py for the device plane,
checkpoint I/O and process death (a copy, imports rewritten; the socket
chaos of the JAX module arrives with the master/client plane).  Every
recovery path of the fault-tolerance tier is exercised against the code
that ships — not mocks of it — by wrapping its seams:

  checkpoint I/O `chaos_checkpoint_io(plan)` arms utils/atomicio's
                 `_WRITE_FAULT` hook to raise ENOSPC (or any OSError) on
                 scheduled atomic writes
  process death  `fuzz_until_killed(loop, ...)` drives the REAL
                 FuzzLoop.fuzz loop and "kills" it at a chosen batch
                 boundary; `tear_file(path)` simulates the torn file a
                 kill during a non-atomic write would have left
  device plane   `chaos_device(plan)` arms wtf_tpu_torch/supervise's
                 `_DEVICE_FAULT` hook: scripted hangs, device errors and
                 lane poisoning fire on exact GLOBAL DISPATCH INDICES
                 (every supervised seam counts one), so watchdog /
                 rebuild / quarantine recovery is provable with no wall
                 clock — an injected hang raises DispatchHang at once
                 rather than sleeping out a real timeout

Determinism contract: faults fire on operation indices, not on wall clock
or rates, so the same plan against the same (single-threaded) campaign
faults at exactly the same points on every run.
"""

from __future__ import annotations

import errno
from contextlib import contextmanager
from typing import Dict, List, Optional

from wtf_tpu_torch.supervise import DEVICE_POISON, MACHINE_SEAMS
from wtf_tpu_torch.supervise import supervisor as _supervisor
from wtf_tpu_torch.utils import atomicio


class SimulatedKill(Exception):
    """Raised by fuzz_until_killed at the scheduled batch boundary."""


class FaultPlan:
    """A set of faulting atomic-write indices and a device-fault schedule.

    `write_faults` are global atomic-write indices that raise
    `write_error` (default ENOSPC) before any byte lands.
    `device_faults` maps a global supervised-dispatch index to a kind or
    (kind, arg) — arg is the lane for DEVICE_POISON.  (The JAX plan's
    per-socket schedules arrive with the master/client plane.)"""

    def __init__(self, write_faults=(), write_error: Optional[OSError]
                 = None, device_faults: Optional[Dict[int, object]] = None):
        self.write_faults = set(write_faults)
        self.write_error = write_error
        self.device_faults = dict(device_faults or {})
        self._next_write = 0
        # observability for assertions: what actually fired
        self.fired: List[tuple] = []

    def note(self, *what) -> None:
        self.fired.append(what)

    def count_fired(self, kind: str) -> int:
        return sum(1 for f in self.fired if f[0] == kind)

    # -- the supervise hook ------------------------------------------------
    def _device_hook(self, seam: str, index: int):
        """Supervisor.dispatch consults this with the seam name and the
        global dispatch index.  Poison scheduled on a seam whose output
        carries no machine state (devmut-generate, device-decode) slides
        to the next index instead of silently vanishing."""
        fault = self.device_faults.pop(index, None)
        if fault is None:
            return None
        kind, arg = fault if isinstance(fault, tuple) else (fault, None)
        if kind == DEVICE_POISON and seam not in MACHINE_SEAMS:
            self.device_faults[index + 1] = (kind, arg)
            return None
        self.note(kind, seam, index)
        return (kind, arg)

    # -- the atomicio hook -------------------------------------------------
    def _write_hook(self, path) -> None:
        i = self._next_write
        self._next_write += 1
        if i in self.write_faults:
            self.note("write-fault", i, str(path))
            raise self.write_error or OSError(
                errno.ENOSPC, f"chaos: injected ENOSPC for {path}")


class SeamFaultPlan(FaultPlan):
    """A device-fault schedule written by seam instead of by index:
    `seam_faults` is a list of (seam, kind | (kind, arg)[, nth]), fired
    in order, each at the nth (default first) dispatch of its seam that
    comes at least `gap` dispatches after the previous fault fired (the
    first at index `start` or later).  The dispatch right
    after a fault is the recovery's own regeneration of the pending
    batch (a device-mutator campaign), which the default gap of 2 skips.
    Each fault is written into `device_faults` at the index it lands
    on, so `fired` reads as for any FaultPlan — and the same plan lands
    on the same dispatches wherever the campaign's dispatch sequence is
    the same, whatever its length (the card and the CPU, 4096 lanes or
    64).  A poison is found when its batch ends, so the recovery's
    regeneration comes later than `gap` covers: a devmut-generate fault
    after one names nth=2."""

    def __init__(self, seam_faults, gap: int = 2, start: int = 0,
                 **kwargs):
        super().__init__(**kwargs)
        self.seam_faults = list(seam_faults)
        self.gap = int(gap)
        # the first fault lands at index `start` or later
        self._last = int(start) - self.gap
        self._seen = 0

    def _device_hook(self, seam: str, index: int):
        if (self.seam_faults and seam == self.seam_faults[0][0]
                and index >= self._last + self.gap):
            self._seen += 1
            entry = self.seam_faults[0]
            if self._seen >= (entry[2] if len(entry) > 2 else 1):
                self.seam_faults.pop(0)
                self.device_faults[index] = entry[1]
                self._seen = 0
        fault = super()._device_hook(seam, index)
        if fault is not None:
            self._last = index
        return fault


@contextmanager
def chaos_checkpoint_io(plan: FaultPlan):
    """Within the context, scheduled atomic writes (utils/atomicio —
    checkpoints, coverage files, crash saves, corpus entries) raise the
    plan's write error before touching disk."""
    previous = atomicio._WRITE_FAULT
    atomicio._WRITE_FAULT = plan._write_hook
    try:
        yield plan
    finally:
        atomicio._WRITE_FAULT = previous


@contextmanager
def chaos_device(plan: FaultPlan):
    """Within the context, every supervised device dispatch consults the
    plan's device schedule (supervise/supervisor.py's `_DEVICE_FAULT`
    global — the same arming pattern as atomicio's `_WRITE_FAULT`)."""
    previous = _supervisor._DEVICE_FAULT
    _supervisor._DEVICE_FAULT = plan._device_hook
    try:
        yield plan
    finally:
        _supervisor._DEVICE_FAULT = previous


def fuzz_until_killed(loop, runs: int, kill_at_batch: int) -> None:
    """Drive the REAL FuzzLoop.fuzz loop and simulate a kill at the end
    of batch `kill_at_batch` — after that batch's checkpoint cadence ran,
    exactly where a SIGKILL between batches lands.  The loop object is
    left as the dead process would have left its disk state: resume from
    the checkpoint dir with a FRESH loop, never reuse this one."""
    original = loop._heartbeat

    def heartbeat(print_stats):
        if loop.batches_done >= kill_at_batch:
            raise SimulatedKill(f"killed at batch {loop.batches_done}")
        original(print_stats)

    loop._heartbeat = heartbeat
    try:
        loop.fuzz(runs)
        raise AssertionError(
            f"campaign finished {runs} runs before batch {kill_at_batch}")
    except SimulatedKill:
        pass
    finally:
        loop._heartbeat = original


def tear_file(path, keep_fraction: float = 0.5) -> None:
    """Truncate `path` mid-content — the torn file a kill during a
    non-atomic write (or a bit-rotted disk) leaves behind."""
    from pathlib import Path

    path = Path(path)
    data = path.read_bytes()
    path.write_bytes(data[:max(1, int(len(data) * keep_fraction))])
