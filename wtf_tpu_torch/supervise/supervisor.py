"""The device-dispatch supervisor: watchdog, recovery, quarantine.

The counterpart of wtf_tpu/supervise/supervisor.py: the host logic is a
copy, and the wait on the device is written for CUDA.  The Supervisor
owns every device dispatch seam of the port (Runner chunk/fused/insert,
the megachunk window, devmut generation, the device-decode gather —
enumerated in `SEAM_SITES`) with four capabilities:

  watchdog     `dispatch()` bounds the wait on a dispatch with a host
               timer thread (`--dispatch-timeout`, scaled by the
               dispatch's step budget and megachunk window).  A hang is
               abandoned — the waiting thread is left parked on the dead
               dispatch, never joined — and surfaces as DispatchHang.
  recovery     `recover()` rebuilds the backend from live host-side
               state (the decode cache and SMC counters are host dicts,
               the coverage aggregates and the mutator state were
               mirrored at the batch boundary by `pre_batch()`) and the
               batch replays bit-identically: the failed attempt only
               ever decoded a prefix of the same deterministic stream.
  degradation  repeated failures step down the `DegradationLadder`
               (megachunk -> batch at a time -> fused off -> fixed
               chunks); N clean batches re-promote.  Every rung is held
               bit-identical at equal seeds elsewhere in the tree, so
               rungs trade wall-clock, never results.
  quarantine   an integrity fold over the machine planes runs once per
               batch (supervise/integrity.py); violating lanes raise
               LanePoisoned (the batch replays from the restore state)
               and repeat offenders enter the persistent quarantine mask
               — parked idle, excluded from the coverage merge, never
               harvested.

What the watchdog bounds on a CUDA device.  A CUDA launch returns before
the card finishes, but many seams of the port read the device back
inside the call itself (the precise step's `scan` reads once per step,
the window reads its loop flags), so a device that never finishes blocks
the call, not a later wait.  `dispatch` therefore runs every waited
seam's call, and the wait on an event recorded after it, in the
watchdog's thread: the main thread waits at most the timeout.

What recovery can do on a CUDA device.  A dispatch that raised a
recoverable error (out of memory) leaves the context usable, and
`recover()` rebuilds and replays.  A sticky error (illegal address,
launch failure) fails every later call in the process, and a kernel
that never ends holds the stream the rebuild would use: `recover()`
checks that the device drains within the timeout and raises DeviceLost
when it does not.  DeviceLost is not a DispatchFailure, so the campaign
ends at once with its last checkpoint intact; `campaign --resume` in a
new process continues it.  A kernel that fails to build, refuses its
arguments or fails to launch (csrc/build.KernelError) is never replayed
either: it passes through `dispatch` unwrapped and ends the campaign,
since a replay fails the same way and the ladder's rungs below it would
carry on without the kernel.

Fault injection: `wtf_tpu_torch.testing.faultinject.chaos_device(plan)`
arms the module-global `_DEVICE_FAULT` hook (the atomicio `_WRITE_FAULT`
pattern) so scripted hang/error/poison faults fire on exact dispatch
indices — no wall clock.

An inert Supervisor (enabled=False, no hook armed) adds one attribute
load and one `is None` test per dispatch — standalone Runners pay
nothing for the seam routing.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Set

import numpy as np

from wtf_tpu_torch.csrc.build import KernelError
from wtf_tpu_torch.telemetry import NULL, Registry

# Seam names -> the code location that must route through
# Supervisor.dispatch (tests/test_torch_supervise.py resolves each site
# and checks the routing call is in its source).
SEAM_SITES: Dict[str, str] = {
    "chunk": "wtf_tpu_torch.interp.runner:Runner.run",
    "fused": "wtf_tpu_torch.interp.runner:Runner._fused_dispatch",
    "fused-resume": "wtf_tpu_torch.interp.runner:Runner._fused_dispatch",
    "device-insert": "wtf_tpu_torch.interp.runner:Runner.device_insert",
    "devmut-generate":
        "wtf_tpu_torch.devmut.mutator:DevMangleMutator._dispatch",
    "megachunk": "wtf_tpu_torch.backend.gpu:GpuBackend._dispatch_window",
    "device-decode":
        "wtf_tpu_torch.interp.runner:Runner._gather_code_windows",
}

# seams whose dispatch output carries machine state — the only ones a
# scripted poison fault can corrupt (faultinject slides poison scheduled
# on other seams to the next dispatch index)
MACHINE_SEAMS = frozenset(
    ("chunk", "fused", "fused-resume", "device-insert", "megachunk"))

# scripted device-fault kinds (testing/faultinject.FaultPlan.device_faults)
DEVICE_HANG = "device-hang"
DEVICE_ERROR = "device-error"
DEVICE_POISON = "device-poison"

# armed by testing.faultinject.chaos_device: callable(seam, index) ->
# Optional[(kind, arg)].  Module global like utils/atomicio._WRITE_FAULT
# so production code never imports the chaos harness.
_DEVICE_FAULT = None


class DispatchFailure(RuntimeError):
    """Base of every supervised-dispatch failure.  Carries the seam name
    and the global dispatch index so recovery events are attributable."""

    kind = "failure"

    def __init__(self, seam: str, index: int, detail: str):
        super().__init__(f"{seam} dispatch #{index}: {detail}")
        self.seam = seam
        self.index = index
        self.detail = detail


class DispatchHang(DispatchFailure):
    """The watchdog expired waiting on a dispatch (real or injected)."""

    kind = "hang"


class DispatchError(DispatchFailure):
    """The dispatch raised (a CUDA or PyTorch error, or injected)."""

    kind = "error"


class LanePoisoned(DispatchFailure):
    """The per-batch integrity check found lanes violating machine-state
    invariants; `lanes` are the violators."""

    kind = "poison"

    def __init__(self, seam: str, index: int, lanes, detail: str):
        super().__init__(seam, index, detail)
        self.lanes = tuple(int(x) for x in lanes)


class DeviceLost(RuntimeError):
    """The device cannot be rebuilt in this process: a sticky CUDA error,
    or a dispatch that never drained.  Not a DispatchFailure — the
    campaign stops; resume from its last checkpoint in a new process."""


def _mark(value):
    """What the watchdog waits on for `value`: an event recorded on the
    current stream of a CUDA tensor's device (everything queued before
    it, the dispatch included), else None (CPU work is already done)."""
    import torch

    if isinstance(value, torch.Tensor) and value.device.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(value.device))
        return event
    return None


def _wait_ready(value) -> None:
    """The blocking wait the watchdog thread runs — a module function so
    tests can substitute a slow waiter.  `value` is what `_mark` gave:
    a CUDA event to synchronize on, or None (returns at once)."""
    if value is not None:
        value.synchronize()


class Supervisor:
    """One per backend; shared with the Runner it rebuilds (the global
    dispatch index and telemetry survive rebuilds by construction)."""

    def __init__(self, registry: Optional[Registry] = None, events=None,
                 enabled: bool = False, dispatch_timeout: float = 0.0,
                 promote_after: int = 8, max_batch_retries: int = 4,
                 quarantine_threshold: int = 3):
        self.registry = registry if registry is not None else Registry()
        self.events = events if events is not None else NULL
        self.enabled = bool(enabled)
        self.dispatch_timeout = float(dispatch_timeout)
        self.promote_after = int(promote_after)
        self.max_batch_retries = int(max_batch_retries)
        self.quarantine_threshold = int(quarantine_threshold)
        self.ladder = None          # built by attach_loop
        self.quarantined: Set[int] = set()
        self._violations: Dict[int, int] = {}
        self._op_index = 0          # global supervised-dispatch counter
        self._snap: Optional[dict] = None
        self._base_steps = 256      # refined by attach_runner
        self.n_lanes = 0
        self.device = None
        # (thread, timeout) of the last dispatch a real watchdog fire
        # abandoned: recover() waits for the device to drain first
        self._abandoned = None

    # -- wiring ------------------------------------------------------------
    def attach_runner(self, runner) -> None:
        """Called from Runner.__init__ — including the rebuilt Runner
        after a recovery, which shares THIS supervisor."""
        self._base_steps = max(int(runner.chunk_steps), 1)
        self.n_lanes = runner.n_lanes
        self.device = runner.device

    def attach_loop(self, loop) -> None:
        """Called at the first supervised batch: builds the degradation
        ladder against the loop's configuration."""
        from wtf_tpu_torch.supervise.ladder import DegradationLadder

        self.ladder = DegradationLadder(loop, self.promote_after)
        self.apply_rung(loop)

    @property
    def megachunk_disabled(self) -> bool:
        """Megachunk windows are off when the ladder stepped below them
        OR any lane is persistently quarantined (the window cannot mask
        lanes; the batch-at-a-time path can)."""
        if self.quarantined:
            return True
        return bool(self.ladder is not None and self.ladder.megachunk_off)

    def _active(self) -> bool:
        return self.enabled or _DEVICE_FAULT is not None

    # -- the dispatch guard --------------------------------------------------
    def dispatch(self, seam: str, fn, *args, steps: int = 0,
                 window: int = 1, sync=None):
        """Route one device dispatch: scripted-fault check, then the
        call — when a timeout is configured, the call and the wait on
        `sync(out)` (or `out` itself) together, bounded by the watchdog.
        `steps`/`window` scale the timeout.  A KernelError passes
        through unwrapped (see the module docstring)."""
        if not self._active():
            return fn(*args)
        index = self._op_index
        self._op_index += 1
        self.registry.counter("supervise.dispatches").inc()
        hook = _DEVICE_FAULT
        fault = hook(seam, index) if hook is not None else None
        if fault is not None:
            kind = fault[0]
            if kind == DEVICE_HANG:
                # scripted hangs never wait wall-clock: the watchdog
                # outcome (abandon + rebuild) is identical either way
                self._note_watchdog(seam, index, injected=True)
                raise DispatchHang(seam, index,
                                   "injected hung dispatch (watchdog)")
            if kind == DEVICE_ERROR:
                self._note_error(seam, index, "injected device error")
                raise DispatchError(seam, index, "injected device error")
        try:
            if self.dispatch_timeout <= 0:
                out = fn(*args)
            else:
                self.registry.counter("supervise.bounded_waits").inc()
                out = self._bounded_call(seam, index, fn, args, sync,
                                         steps, window)
        except (DispatchFailure, KernelError):
            raise
        except Exception as exc:
            if not self.enabled:
                raise
            self._note_error(seam, index, repr(exc))
            raise DispatchError(seam, index, repr(exc)) from exc
        if fault is not None and fault[0] == DEVICE_POISON:
            from wtf_tpu_torch.supervise import integrity

            out = integrity.poison_output(out, int(fault[1] or 0))
        return out

    def timeout_for(self, steps: int, window: int) -> float:
        """--dispatch-timeout is calibrated to ONE base chunk; bigger
        dispatches (adaptive chunk rungs, the instruction-budget-bound
        megachunk window) get proportionally longer before the watchdog
        calls them hung."""
        scale = max(1.0, steps / self._base_steps) if steps else 1.0
        return self.dispatch_timeout * scale * max(1, window)

    def _bounded_call(self, seam: str, index: int, fn, args, sync,
                      steps: int, window: int):
        """One seam under the watchdog: the call and the wait on an event
        recorded after it both run in the watchdog's thread, so a device
        that never finishes (also at a host read inside the call) blocks
        that thread, not this one."""
        timeout = self.timeout_for(steps, window)
        result = []
        done = threading.Event()
        raised = []

        def waiter():
            try:
                out = fn(*args)
                result.append(out)
                _wait_ready(_mark(sync(out) if sync is not None else out))
            except BaseException as exc:  # surfaces as DispatchError
                raised.append(exc)
            finally:
                done.set()

        thread = threading.Thread(
            target=waiter, daemon=True, name=f"wtf-watchdog-{seam}-{index}")
        thread.start()
        if not done.wait(timeout):
            # abandon, don't join: the thread stays parked on the dead
            # dispatch; recover() checks the device drains before it
            # rebuilds, and nothing consumes the wedged buffers
            self._abandoned = (thread, timeout)
            self._note_watchdog(seam, index, injected=False)
            raise DispatchHang(
                seam, index,
                f"no completion within {timeout:.1f}s (watchdog)")
        if raised:
            raise raised[0]
        return result[0]

    def _note_watchdog(self, seam: str, index: int, injected: bool) -> None:
        self.registry.counter("supervise.watchdog_fires").inc()
        self.events.emit("watchdog", seam=seam, index=index,
                         injected=injected)

    def _note_error(self, seam: str, index: int, detail: str) -> None:
        self.registry.counter("supervise.device_errors").inc()
        self.events.emit("device-error", seam=seam, index=index,
                         detail=detail[:200])

    # -- per-batch integrity + quarantine ------------------------------------
    def check_batch_integrity(self, runner) -> Optional[np.ndarray]:
        """Run the invariant fold over the live machine (called by the
        backend BEFORE the coverage merge and result mapping — a poisoned
        status must never reach StatusCode() or the aggregate bitmaps).
        Returns the violation mask, or None when inert."""
        if not self.enabled:
            return None
        from wtf_tpu_torch.supervise import integrity

        with self.registry.spans.span("integrity") as sp:
            bad_dev, digest = integrity.check_machine(runner.machine)
            bad = bad_dev.cpu().numpy()
            sp.fence(bad_dev)
        self.registry.counter("supervise.integrity_checks").inc()
        if bad.any():
            lanes = [int(x) for x in np.nonzero(bad)[0]]
            for lane in lanes:
                self._violations[lane] = self._violations.get(lane, 0) + 1
                self.registry.counter("device.quarantined").inc()
                if self._violations[lane] >= self.quarantine_threshold:
                    self.quarantined.add(lane)
            self.events.emit("poisoned-lane", lanes=lanes,
                             digest=int(digest.item()),
                             quarantined=sorted(self.quarantined))
            self.registry.counter("supervise.poisoned_lanes").inc(len(lanes))
            self.registry.gauge("supervise.quarantined_lanes").set(
                len(self.quarantined))
        return bad

    def raise_if_poisoned(self, runner, seam: str) -> None:
        """Integrity gate the backend drops before every harvest: run the
        check and raise LanePoisoned on any violating lane, so the batch
        is replayed (the fuzz loop's supervision wrapper) instead of
        harvested.  Inert when supervision is disabled."""
        bad = self.check_batch_integrity(runner)
        if bad is not None and bad.any():
            lanes = np.nonzero(bad)[0]
            raise LanePoisoned(
                seam, self._op_index, lanes,
                f"machine-state invariants violated on lanes "
                f"{[int(x) for x in lanes]}")

    def quarantine_mask(self) -> Optional[np.ndarray]:
        """bool[L] — True for persistently quarantined lanes (parked
        idle: skipped at insert, excluded from the coverage merge).
        None while the set is empty (the common case costs nothing)."""
        if not self.quarantined or not self.n_lanes:
            return None
        mask = np.zeros(self.n_lanes, dtype=bool)
        mask[sorted(self.quarantined)] = True
        return mask

    # -- batch-boundary snapshot + recovery ----------------------------------
    def pre_batch(self, loop) -> None:
        """Mirror the batch-boundary state a replay needs: the coverage
        aggregates, the FULL mutator checkpoint, the campaign RNG and
        the overlay-full requeue.  The mutator snapshot must be the full
        checkpoint (slab included), not just the cursor: the prelaunch
        seam syncs the slab's as-uploaded view before its generate
        dispatch can fail, so a cursor-only snapshot would regenerate
        the pending batch from a newer slab than the original sampled.
        Everything else is either host-side and monotone (decode cache,
        SMC counters — captured live at recovery time) or derived
        deterministically from these."""
        backend = loop.backend
        mutator = loop.mutator
        with self.registry.spans.span("supervise-snapshot"):
            cov, edge = backend.coverage_state()
            if hasattr(mutator, "checkpoint_state"):
                mut = mutator.checkpoint_state()
            else:
                mut = None
            corpus_rng = getattr(loop.corpus, "rng", None)
            mut_rng = getattr(mutator, "rng", None)
            self._snap = {
                "coverage": (cov, edge),
                "mutator": mut,
                "rng_corpus": (corpus_rng.getstate()
                               if corpus_rng is not None else None),
                # most campaigns share ONE rng between corpus and mutator
                # (resume/checkpoint.py's "shared" idiom)
                "rng_mutator": ("shared" if mut_rng is corpus_rng else
                                (mut_rng.getstate()
                                 if mut_rng is not None else None)),
                "requeue": list(loop._requeue),
                "requeue_digests": set(loop._requeue_digests),
            }

    def post_batch(self, loop) -> None:
        """A clean batch: drop the snapshot and feed the ladder's
        hysteresis — `promote_after` consecutive clean batches win one
        rung back."""
        self._snap = None
        if self.ladder is not None and self.ladder.on_clean():
            self.registry.counter("supervise.promotions").inc()
            self.events.emit("promote", rung=self.ladder.rung_name,
                             level=self.ladder.level)
            self.apply_rung(loop)
        if self.ladder is not None:
            self.registry.gauge("supervise.rung").set(self.ladder.level)

    def _check_device(self) -> None:
        """Raise DeviceLost unless the device drains within the timeout
        and answers (a sticky CUDA error fails the synchronize; a kernel
        that never ends never drains).  Also waits for the thread of an
        abandoned dispatch to leave the old runner's state.  Nothing to
        check on the CPU, where every call has finished when it
        returns."""
        device = self.device
        abandoned, self._abandoned = self._abandoned, None
        if device is None or getattr(device, "type", "cpu") != "cuda":
            return
        import torch

        timeout = max(self.dispatch_timeout, 1.0)
        if abandoned is not None:
            timeout = max(timeout, abandoned[1])
        done = threading.Event()
        raised = []

        def drain():
            try:
                torch.cuda.synchronize(device)
            except BaseException as exc:
                raised.append(exc)
            finally:
                done.set()

        threading.Thread(target=drain, daemon=True,
                         name="wtf-watchdog-drain").start()
        if not done.wait(timeout):
            raise DeviceLost(
                f"{device} did not drain within {timeout:.1f}s after a "
                f"watchdog fire; resume from the last checkpoint in a new "
                f"process")
        if raised:
            raise DeviceLost(
                f"{device} is unusable in this process ({raised[0]!r}); "
                f"resume from the last checkpoint in a new process"
            ) from raised[0]
        if abandoned is not None:
            abandoned[0].join(timeout)
            if abandoned[0].is_alive():
                raise DeviceLost(
                    f"the dispatch abandoned on {device} did not finish "
                    f"within {timeout:.1f}s after the device drained; "
                    f"resume from the last checkpoint in a new process")

    def recover(self, loop, failure: DispatchFailure) -> None:
        """Abandon the failed dispatch, rebuild the device plane from
        host-side state, and leave the loop ready to replay the batch
        bit-identically.

        Why the replay is exact: the failed attempt consumed no host
        randomness (RNG/requeue restored from the snapshot), its decode
        work is a PREFIX of the same deterministic stream (cache entries
        keep their insertion indices — captured live, they are host
        state), and the mutator byte stream is a pure function of
        (seed, batch cursor, slab as uploaded) — all three restored from
        the pre_batch snapshot, including the slab's as-uploaded view
        (which the failing dispatch itself may have re-synced).

        Raises DeviceLost (before touching anything) when the device
        cannot be rebuilt in this process."""
        if self._snap is None:
            raise RuntimeError(
                "supervised recovery without a pre_batch snapshot") \
                from failure
        self._check_device()
        backend = loop.backend
        mutator = loop.mutator
        self.registry.counter("supervise.batch_retries").inc()
        with self.registry.spans.span("supervise-recover"):
            runner_state = backend.runner.checkpoint_state()
            device_mut = bool(getattr(mutator, "is_device", False))
            backend.initialize()  # fresh Runner (shares this supervisor)
            runner = backend.runner
            # re-arm breakpoints directly from the backend's table —
            # target.init already ran once and must not run twice
            for gva in getattr(backend, "breakpoints", {}):
                runner.cache.set_breakpoint(gva)
            runner.restore_state(runner_state)
            cov, edge = self._snap["coverage"]
            backend.restore_coverage_state(cov, edge)
            if device_mut:
                mutator.bind(backend, loop.target,
                             registry=loop.registry, events=loop.events)
                # regenerate=True: even a megachunk-boundary snapshot
                # (pending=False) must re-prelaunch from the entitled
                # as-uploaded slab view, because the replay runs batch at
                # a time (the ladder stepped below megachunk)
                mutator.restore_state(self._snap["mutator"],
                                      regenerate=True)
            elif (self._snap["mutator"] is not None
                    and hasattr(mutator, "restore_state")):
                mutator.restore_state(self._snap["mutator"])
            corpus_rng = getattr(loop.corpus, "rng", None)
            if corpus_rng is not None and self._snap["rng_corpus"]:
                corpus_rng.setstate(self._snap["rng_corpus"])
            mut_rng_state = self._snap["rng_mutator"]
            if mut_rng_state not in (None, "shared"):
                getattr(mutator, "rng").setstate(mut_rng_state)
            loop._requeue = list(self._snap["requeue"])
            loop._requeue_digests = set(self._snap["requeue_digests"])
            backend._view = None
            loop.target.restore()
        self.registry.counter("supervise.rebuilds").inc()
        self.events.emit("rebuild", seam=failure.seam, index=failure.index,
                         kind=failure.kind)
        if self.ladder is not None:
            if self.ladder.on_failure():
                self.registry.counter("supervise.degradations").inc()
                self.events.emit("degrade", rung=self.ladder.rung_name,
                                 level=self.ladder.level,
                                 kind=failure.kind)
            self.registry.gauge("supervise.rung").set(self.ladder.level)
        # the NEW runner needs the current rung's flags re-applied
        self.apply_rung(loop)

    def apply_rung(self, loop) -> None:
        if self.ladder is not None:
            self.ladder.apply(loop)

    # -- heartbeat -----------------------------------------------------------
    def heartbeat_fields(self) -> dict:
        """Extra JSONL heartbeat fields (the full supervise.* counter set
        rides in the registry dump already)."""
        return {
            "supervise_rung": (self.ladder.rung_name
                               if self.ladder is not None else "full"),
            "supervise_quarantined": len(self.quarantined),
        }
