"""Deterministic chaos harness: scripted fault schedules over real seams.

The counterpart of wtf_tpu/testing/faultinject.py (a copy, imports
rewritten, plus `SeamFaultPlan`).  Every recovery path of the
fault-tolerance tier is exercised against the code that ships — not mocks
of it — by wrapping its seams:

  socket I/O     `chaos_dialing(plan)` wraps every socket `wire.dial`
                 returns in a ChaosSocket that injects connection
                 resets, partial sends/recvs, and delays on scheduled
                 operation indices
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

Determinism contract: a schedule is either scripted explicitly or drawn
once from `random.Random(seed)` at plan construction.  Faults fire on
per-socket / per-write / per-dispatch OPERATION INDICES, not on wall
clock or rates, so the same plan against the same (single-threaded) node
or campaign faults at exactly the same points on every run.
"""

from __future__ import annotations

import errno
import random
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

from wtf_tpu_torch.dist import wire
from wtf_tpu_torch.supervise import DEVICE_POISON, MACHINE_SEAMS
from wtf_tpu_torch.supervise import supervisor as _supervisor
from wtf_tpu_torch.utils import atomicio

RESET = "reset"
PARTIAL_SEND = "partial-send"
PARTIAL_RECV = "partial-recv"
DELAY = "delay"

_KINDS = (RESET, PARTIAL_SEND, PARTIAL_RECV, DELAY)


class SimulatedKill(Exception):
    """Raised by fuzz_until_killed at the scheduled batch boundary."""


class FaultPlan:
    """A fixed sequence of per-socket fault schedules, a set of faulting
    atomic-write indices and a device-fault schedule.

    `socket_schedules[i]` is handed to the i-th socket the harness wraps
    (dial order — deterministic for the single-threaded node loops); it
    maps that socket's operation index (each sendall/recv call counts
    one) to a fault kind.  Sockets beyond the list run fault-free.
    `write_faults` are global atomic-write indices that raise
    `write_error` (default ENOSPC) before any byte lands.
    `device_faults` maps a global supervised-dispatch index to a kind or
    (kind, arg) — arg is the lane for DEVICE_POISON."""

    def __init__(self, socket_schedules: Optional[List[Dict[int, str]]]
                 = None, write_faults=(), delay_secs: float = 0.005,
                 write_error: Optional[OSError] = None,
                 device_faults: Optional[Dict[int, object]] = None):
        self.socket_schedules = [dict(s) for s in (socket_schedules or [])]
        self.write_faults = set(write_faults)
        self.delay_secs = delay_secs
        self.write_error = write_error
        self.device_faults = dict(device_faults or {})
        self._next_socket = 0
        self._next_write = 0
        # observability for assertions: what actually fired
        self.fired: List[tuple] = []

    @classmethod
    def seeded(cls, seed: int, n_sockets: int, faults_per_socket: int = 1,
               ops_range: tuple = (2, 40), kinds=(RESET, PARTIAL_SEND,
                                                  PARTIAL_RECV, DELAY),
               delay_secs: float = 0.005) -> "FaultPlan":
        """Draw a reproducible plan from `seed`: for each of `n_sockets`,
        `faults_per_socket` faults at operation indices uniform in
        `ops_range` with kinds uniform over `kinds`."""
        rng = random.Random(seed)
        schedules = []
        for _ in range(n_sockets):
            sched: Dict[int, str] = {}
            for _ in range(faults_per_socket):
                sched[rng.randrange(*ops_range)] = rng.choice(list(kinds))
            schedules.append(sched)
        return cls(schedules, delay_secs=delay_secs)

    def next_schedule(self) -> Dict[int, str]:
        i = self._next_socket
        self._next_socket += 1
        if i < len(self.socket_schedules):
            return self.socket_schedules[i]
        return {}

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


class ChaosSocket:
    """Socket proxy executing one FaultPlan schedule.  Everything not
    faulted delegates to the real socket, so framing, TCP_NODELAY, and
    close semantics are exactly production's."""

    def __init__(self, sock, schedule: Dict[int, str], plan: FaultPlan):
        # plain attributes; delegation via __getattr__ only for names not
        # defined here
        self._sock = sock
        self._sched = dict(schedule)
        self._plan = plan
        self._op = 0

    def _fault(self) -> Optional[str]:
        kind = self._sched.pop(self._op, None)
        self._op += 1
        return kind

    def _die(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
        raise ConnectionResetError(errno.ECONNRESET,
                                   "chaos: injected connection reset")

    def sendall(self, data):
        kind = self._fault()
        if kind == RESET:
            self._plan.note(RESET, "send")
            self._die()
        if kind == PARTIAL_SEND:
            # half the bytes land, then the connection dies: the peer
            # sees a torn frame (recv_exact returns None mid-body)
            self._plan.note(PARTIAL_SEND, len(data))
            try:
                self._sock.sendall(data[:max(1, len(data) // 2)])
            except OSError:
                pass
            self._die()
        if kind == DELAY:
            self._plan.note(DELAY, "send")
            time.sleep(self._plan.delay_secs)
        return self._sock.sendall(data)

    def recv(self, n):
        kind = self._fault()
        if kind == RESET:
            self._plan.note(RESET, "recv")
            self._die()
        if kind == PARTIAL_RECV:
            # deliver a single byte now and schedule the reset for the
            # very next operation: the reader tears mid-frame
            self._plan.note(PARTIAL_RECV, n)
            self._sched[self._op] = RESET
            return self._sock.recv(min(1, n) if n else n)
        if kind == DELAY:
            self._plan.note(DELAY, "recv")
            time.sleep(self._plan.delay_secs)
        return self._sock.recv(n)

    def __getattr__(self, name):
        return getattr(self._sock, name)


@contextmanager
def chaos_dialing(plan: FaultPlan):
    """Within the context, every socket `wire.dial` hands out is wrapped
    with the plan's next schedule (dial order)."""
    original = wire.dial

    def dial(*args, **kwargs):
        return ChaosSocket(original(*args, **kwargs),
                           plan.next_schedule(), plan)

    wire.dial = dial
    try:
        yield plan
    finally:
        wire.dial = original


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
