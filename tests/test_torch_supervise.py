"""The port's self-healing device runtime (wtf_tpu_torch/supervise)
against the JAX package's (wtf_tpu/supervise), on the CPU; held against
tests/test_supervise.py.

  * the supervisor alone: the inert passthrough, the watchdog firing on a
    substituted slow `_wait_ready` and on a call that never returns,
    error wrapping, timeout scaling, scripted faults on exact dispatch
    indices, and DeviceLost for a device that raises or never drains
  * a failed K1 launch ending a supervised campaign, unreplayed, batch at
    a time and in a window
  * the degradation ladder: rungs, hysteresis, the bottom-of-ladder flag
  * the integrity check flagging only the poisoned lane, its violation
    mask and digest equal to `wtf_tpu.supervise.integrity.check_machine`
    on the same planes (numpy seed, carried across by convert.py)
  * demo_tlv devmangle campaigns of 4 batches of 8 lanes against the JAX
    package's unsupervised run (computed once, on its base chunk rung):
    fault-free supervised runs batch at a time and in windows; runs whose
    scripted hang, error or transient poison lands on the `fused`,
    `fused-resume`, `device-insert`, `devmut-generate`, `chunk` and
    `megachunk` seams, each replayed bit-identically; a megachunk hang
    that degrades and re-promotes after a cold-window error; persistent
    quarantine; a supervised
    campaign with a scripted error, killed and resumed
  * every SEAM_SITES entry routes its seam through supervisor.dispatch

Every comparison is exact (integer state: tolerance 0).
"""

import inspect
import importlib
import time
import types

import numpy as np
import pytest
import torch

from tests.torchport import (
    build_port_tlv_campaign, campaign_fingerprint, initial_machine, to_jax,
)
from wtf_tpu.analysis.trace import build_tlv_campaign
from wtf_tpu_torch.core.results import StatusCode
from wtf_tpu_torch.resume import load_campaign, restore_campaign
from wtf_tpu_torch.supervise import (
    DEVICE_ERROR, DEVICE_HANG, DEVICE_POISON, SEAM_SITES, DegradationLadder,
    DeviceLost, DispatchError, DispatchHang, Supervisor,
)
from wtf_tpu_torch.supervise import integrity
from wtf_tpu_torch.supervise import supervisor as sup_mod
from wtf_tpu_torch.testing.faultinject import (
    FaultPlan, SeamFaultPlan, chaos_device, fuzz_until_killed,
)

# tests/test_supervise.py's campaign shape
LANES, BATCHES = 8, 4
RUNS = LANES * BATCHES
SEED = 0xC4A05 & 0xFFFF
BUILD = dict(n_lanes=LANES, mutator="devmangle", limit=20_000, seed=SEED,
             chunk_steps=128, overlay_slots=16)
SUPERVISED = dict(supervise=True, dispatch_timeout=30.0)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's unsupervised, fault-free campaign: the
    bit-identity bar of every port variant."""
    loop = build_tlv_campaign(**BUILD)
    loop.fuzz(RUNS)
    fp = campaign_fingerprint(loop)
    assert fp["testcases"] == RUNS and fp["new_coverage"] > 0
    return fp


def _port(fused_step="on", **kw):
    return build_port_tlv_campaign(fused_step=fused_step, **{**BUILD, **kw})


def _reg(loop):
    return loop.backend.supervisor.registry


# ---------------------------------------------------------------------------
# supervisor unit: dispatch guard, watchdog, timeout scaling
# ---------------------------------------------------------------------------

def test_dispatch_passthrough_when_inactive():
    """Supervision off and no chaos armed: the guard is a plain call —
    no op-index advance, no counters, nothing wrapped."""
    sup = Supervisor()
    sentinel = object()
    assert sup.dispatch("chunk", lambda: sentinel) is sentinel
    assert sup.registry.counter("supervise.dispatches").value == 0
    assert sup._op_index == 0


@pytest.mark.parametrize("hung", ["wait", "call"])
@pytest.mark.parametrize("seam", ["chunk", "fused"])
def test_watchdog_abandons_hung_dispatch(monkeypatch, seam, hung):
    """A dispatch that never completes within the deadline raises
    DispatchHang from the host timer thread — the waiter is abandoned,
    not joined, so the guard returns promptly.  Every waited seam runs
    its call and the wait on its event in the watchdog's thread, so a
    device read inside the call (`call`) is bounded like the event's
    wait (`wait`)."""
    def sleep(*args):
        time.sleep(5.0)

    if hung == "wait":
        monkeypatch.setattr(sup_mod, "_wait_ready", sleep)
    sup = Supervisor(enabled=True, dispatch_timeout=0.05)
    t0 = time.monotonic()
    with pytest.raises(DispatchHang) as ei:
        sup.dispatch(seam, sleep if hung == "call" else object)
    assert time.monotonic() - t0 < 2.0, "watchdog waited on the dead wait"
    assert ei.value.seam == seam
    assert sup.registry.counter("supervise.watchdog_fires").value == 1
    assert sup.registry.counter("supervise.bounded_waits").value == 1


def test_dispatch_error_wraps_backend_exception():
    """A recoverable error of the dispatch (out of memory) becomes a
    DispatchError, which the loop replays."""
    sup = Supervisor(enabled=True)
    boom = torch.cuda.OutOfMemoryError("CUDA out of memory (stand-in)")

    def fn():
        raise boom

    with pytest.raises(DispatchError) as ei:
        sup.dispatch("chunk", fn)
    assert ei.value.__cause__ is boom
    assert ei.value.index == 0
    assert sup.registry.counter("supervise.device_errors").value == 1


@pytest.mark.parametrize("megachunk", [0, 2])
def test_k1_launch_failure_ends_the_supervised_campaign(monkeypatch,
                                                        megachunk):
    """K1's wrapper (`pstep._launch`, its library call answering a CUDA
    error) raises KernelError, which the supervisor passes on unwrapped:
    no rebuild, no step down the ladder to the precise engine, and the
    supervised campaign fails — batch at a time (the `fused` seam) and
    in a window (`megachunk`)."""
    from wtf_tpu_torch.csrc import build
    from wtf_tpu_torch.csrc.build import KernelError
    from wtf_tpu_torch.interp import pstep

    loop = _port(megachunk=megachunk, **SUPERVISED)
    # route the CPU tensors through the CUDA wrapper, whose launch fails
    # with cudaErrorInvalidDeviceFunction (98)
    monkeypatch.setattr(pstep, "fused_step_plain", pstep._launch)
    monkeypatch.setattr(build, "library", lambda name: types.SimpleNamespace(
        wtf_fused_step=lambda *args: 98))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        types.SimpleNamespace(cuda_stream=0))
    with pytest.raises(KernelError, match="kernel launch failed: cuda "
                                          "error 98"):
        loop.fuzz(RUNS)
    reg = _reg(loop)
    assert reg.counter("supervise.dispatches").value > 0
    assert reg.counter("supervise.device_errors").value == 0
    assert reg.counter("supervise.rebuilds").value == 0
    assert reg.counter("supervise.degradations").value == 0
    assert loop.backend.runner.fused_enabled


def test_timeout_scales_with_steps_and_window():
    """--dispatch-timeout is calibrated to one base chunk; adaptive
    rungs and megachunk windows get proportionally longer."""
    sup = Supervisor(enabled=True, dispatch_timeout=2.0)
    assert sup.timeout_for(0, 1) == 2.0
    assert sup.timeout_for(128, 1) == 2.0          # below base: no shrink
    assert sup.timeout_for(512, 1) == 4.0          # 2x the 256 base
    assert sup.timeout_for(0, 3) == 6.0            # 3-batch window
    assert sup.timeout_for(512, 2) == 8.0


def test_scripted_faults_are_operation_indexed():
    """The chaos schedule keys on the global dispatch index — the same
    plan fires on the same dispatch every run, no wall clock anywhere."""
    plan = FaultPlan(device_faults={2: DEVICE_HANG, 4: DEVICE_ERROR})
    sup = Supervisor(enabled=True)
    seen = []
    with chaos_device(plan):
        for i in range(6):
            try:
                sup.dispatch("chunk", lambda: i)
            except DispatchHang:
                seen.append(("hang", i))
            except DispatchError:
                seen.append(("error", i))
    assert seen == [("hang", 2), ("error", 4)]
    assert [f[:2] for f in plan.fired] == [("device-hang", "chunk"),
                                           ("device-error", "chunk")]


@pytest.mark.parametrize("how", ["sticky-error", "never-drains"])
def test_recover_refuses_a_lost_device(monkeypatch, how):
    """A sticky CUDA error fails every later call, and a kernel that
    never ends holds the stream: recover() raises DeviceLost (not a
    DispatchFailure, so the campaign stops) before it rebuilds
    anything."""
    def synchronize(device=None):
        if how == "sticky-error":
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")
        time.sleep(5.0)

    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    sup = Supervisor(enabled=True, dispatch_timeout=0.05)
    sup.device = torch.device("cuda")
    sup._snap = {}
    failure = DispatchHang("fused", 7, "watchdog")
    t0 = time.monotonic()
    with pytest.raises(DeviceLost, match="new process"):
        sup.recover(object(), failure)   # touches no loop state first
    assert time.monotonic() - t0 < 3.0
    assert sup.registry.counter("supervise.rebuilds").value == 0


# ---------------------------------------------------------------------------
# degradation ladder unit
# ---------------------------------------------------------------------------

def _stub_loop(megachunk=2, fused=True, adaptive=True):
    runner = types.SimpleNamespace(fused_enabled=fused,
                                   adaptive_chunks=adaptive)
    return types.SimpleNamespace(
        backend=types.SimpleNamespace(runner=runner), megachunk=megachunk)


def test_ladder_rungs_skip_inapplicable_features():
    full = DegradationLadder(_stub_loop())
    assert full.rungs == ["full", "no-megachunk", "no-fused", "fixed-chunk"]
    bare = DegradationLadder(_stub_loop(megachunk=0, fused=False,
                                        adaptive=False))
    assert bare.rungs == ["full"]
    assert not bare.on_failure()       # nothing left to turn off
    assert bare.wants_reshard


def test_ladder_degrade_apply_and_hysteresis_promotion():
    loop = _stub_loop()
    ladder = DegradationLadder(loop, promote_after=2)
    assert ladder.rung_name == "full" and not ladder.megachunk_off

    assert ladder.on_failure() and ladder.rung_name == "no-megachunk"
    assert ladder.megachunk_off
    assert ladder.on_failure() and ladder.rung_name == "no-fused"
    ladder.apply(loop)
    assert loop.backend.runner.fused_enabled is False
    assert loop.backend.runner.adaptive_chunks is True

    # hysteresis: promote_after CONSECUTIVE cleans win one rung back
    assert not ladder.on_clean()
    assert ladder.on_clean() and ladder.rung_name == "no-megachunk"
    assert not ladder.on_clean()       # streak reset by the promotion
    ladder.on_failure()                # a failure resets the streak too
    assert ladder.rung_name == "no-fused"
    assert not ladder.on_clean()
    assert ladder.on_clean()

    ladder.apply(loop)                 # back at no-megachunk: fused back on
    assert loop.backend.runner.fused_enabled is True


def test_ladder_bottom_sets_the_flag():
    ladder = DegradationLadder(_stub_loop())
    for _ in range(len(ladder.rungs) - 1):
        assert ladder.on_failure()
    assert ladder.rung_name == "fixed-chunk"
    assert not ladder.wants_reshard
    assert not ladder.on_failure()     # bottom: no rung change
    assert ladder.wants_reshard


def test_heartbeat_fields():
    sup = Supervisor(enabled=True)
    assert sup.heartbeat_fields() == {"supervise_rung": "full",
                                     "supervise_quarantined": 0}
    sup.ladder = DegradationLadder(_stub_loop())
    sup.ladder.on_failure()
    sup.quarantined.add(3)
    fields = sup.heartbeat_fields()
    assert fields["supervise_rung"] == "no-megachunk"
    assert fields["supervise_quarantined"] == 1


def test_cli_flags():
    """--dispatch-timeout implies --supervise, on `run` and `campaign`,
    with the reference CLI's help text."""
    from wtf_tpu_torch import cli

    p = cli.build_parser()
    for sub in ("run", "campaign"):
        base = [sub, "--name", "demo_tlv"] + (
            ["--input", "x"] if sub == "run" else ["--runs", "8"])
        assert cli._supervise_kwargs(p.parse_args(base)) == {}
        assert cli._supervise_kwargs(p.parse_args(
            base + ["--supervise"])) == {"supervise": True,
                                         "dispatch_timeout": 0.0}
        assert cli._supervise_kwargs(p.parse_args(
            base + ["--dispatch-timeout", "30"])) == {
                "supervise": True, "dispatch_timeout": 30.0}
    help_text = p._subparsers._group_actions[0].choices[
        "campaign"].format_help()
    assert "Implies --supervise" in help_text


# ---------------------------------------------------------------------------
# integrity check against the JAX package's
# ---------------------------------------------------------------------------

def _random_planes(n_lanes=32, seed=11):
    """A port machine with seeded random rip/status/ctr/overlay planes:
    canonical and non-canonical rips, statuses in and out of range, ctr
    words above 2**31, overlay counts right and wrong."""
    from wtf_tpu_torch.harness import demo_tlv

    rng = np.random.default_rng(seed)
    m = initial_machine(demo_tlv.build_snapshot().cpu, n_lanes, 64, 8)
    hi = rng.choice([0, 0xFFFF8000, 0x00007FFF, 0x00DEAD00, 0xFFFFFFFF],
                    n_lanes).astype(np.uint64)
    rip = (hi << np.uint64(32)) | rng.integers(0, 2**32, n_lanes,
                                               dtype=np.uint64)
    m.rip = torch.from_numpy(rip.view(np.int64).copy())
    m.status = torch.from_numpy(rng.choice(
        [0, 1, 3, int(StatusCode.NEEDS_XLA), 77, -1], n_lanes)
        .astype(np.int32))
    ctr = rng.integers(0, 2**32, (n_lanes, m.ctr.shape[1]),
                       dtype=np.uint64).astype(np.uint32)
    m.ctr = torch.from_numpy(ctr.view(np.int32).copy())
    slots = m.overlay.capacity
    pfn = np.where(rng.random((n_lanes, slots)) < 0.4,
                   rng.integers(0, 1000, (n_lanes, slots)), -1)
    m.overlay.pfn = torch.from_numpy(pfn.astype(np.int32))
    count = (pfn >= 0).sum(1) + rng.choice([0, 0, 0, 1, -1], n_lanes)
    m.overlay.count = torch.from_numpy(count.astype(np.int32))
    return m


def test_integrity_flags_only_the_poisoned_lane():
    loop = _port(**SUPERVISED)
    machine = loop.backend.runner.machine
    bad, digest = integrity.check_machine(machine)
    assert not bad.any(), "clean snapshot machine flagged"

    integrity.poison_machine(machine, 2)
    bad2, digest2 = integrity.check_machine(machine)
    assert bad2.tolist() == [lane == 2 for lane in range(LANES)]
    assert int(digest2) != int(digest)

    # the write-side mask parks lanes the way untasked lanes idle
    integrity.mask_idle(machine, np.arange(LANES) == 2)
    assert int(machine.status[2]) == int(StatusCode.OK)


CRASHER = bytes([1, 8]) + b"A" * 8 + bytes([3, 0x30]) + b"B" * 0x30


def test_integrity_passes_a_wild_execute_crash():
    """A TLV record that overwrites the return address: every lane jumps
    to 0x4242424242424242 and stops on the fetch fault there, rip
    non-canonical.  The port's check lets the crash through to harvest
    (the supervised batch returns it, no replay); the JAX package's check
    flags the same planes (ROADMAP C: a supervised JAX campaign replays
    such a batch and quarantines the lane)."""
    from wtf_tpu.supervise import integrity as jintegrity

    loop = _port(**SUPERVISED)
    results = loop.backend.run_batch([CRASHER] * LANES, loop.target)
    assert {str(r) for r in results} == {
        "crash(crash-execute-0x4242424242424242)"}
    m = loop.backend.runner.machine
    assert not integrity.check_machine(m)[0].any()
    assert np.asarray(jintegrity.check_machine(to_jax(m))[0]).all()
    assert _reg(loop).counter("supervise.integrity_checks").value == 1
    # the same wild rip on a lane stopped before its fetch (a decode miss
    # a window leaves for the host, a timeout) passes; on a lane that
    # fetched there (OK, BREAKPOINT) it is corruption
    for lane, code in enumerate((StatusCode.NEED_DECODE,
                                 StatusCode.TIMEDOUT, StatusCode.OK,
                                 StatusCode.BREAKPOINT)):
        m.status[lane] = int(code)
    assert integrity.check_machine(m)[0].tolist() == [
        lane in (2, 3) for lane in range(LANES)]
    integrity.poison_machine(m, 5)
    assert integrity.check_machine(m)[0].tolist() == [
        lane in (2, 3, 5) for lane in range(LANES)]


@pytest.mark.parametrize("seed", [11, 12])
def test_integrity_equals_jax(seed):
    """The violation mask and the u32 digest equal the JAX package's
    check_machine on the same planes (every predicate, the u32 ctr
    compare and the wraparound fold included; no lane of these planes
    is a fetch fault at its rip)."""
    from wtf_tpu.supervise import integrity as jintegrity

    m = _random_planes(seed=seed)
    bad, digest = integrity.check_machine(m)
    jbad, jdigest = jintegrity.check_machine(to_jax(m))
    assert bad.numpy().tolist() == np.asarray(jbad).tolist()
    assert 0 < bad.sum() < len(bad)
    assert int(digest) == int(np.asarray(jdigest))
    # and after the scripted poison of both packages
    lane = int(np.nonzero(~bad.numpy())[0][0])
    jm = jintegrity.poison_machine(to_jax(m), lane)
    integrity.poison_machine(m, lane)
    bad, digest = integrity.check_machine(m)
    jbad, jdigest = jintegrity.check_machine(jm)
    assert bool(bad[lane]) and bad.numpy().tolist() == \
        np.asarray(jbad).tolist()
    assert int(digest) == int(np.asarray(jdigest))


# ---------------------------------------------------------------------------
# recovery parity: every leg bit-identical to the fault-free reference
# ---------------------------------------------------------------------------

def test_supervised_fault_free_is_bit_identical(ref):
    """The window campaign of the card's main path, supervised with a
    watchdog and no fault: bit-identical, no rebuild.  (The batch-at-a-
    time seams run supervised in test_seam_faults_replay_bit_identical.)"""
    loop = _port(megachunk=2, **SUPERVISED)
    loop.fuzz(RUNS)
    assert campaign_fingerprint(loop) == ref
    reg = _reg(loop)
    assert reg.counter("supervise.dispatches").value > 0
    assert reg.counter("supervise.bounded_waits").value > 0
    assert reg.counter("supervise.integrity_checks").value >= 1
    assert reg.counter("supervise.rebuilds").value == 0
    assert loop.registry.counter("device.fused_steps").value > 0


def _faulted(plan, **kw):
    loop = _port(**{**SUPERVISED, **kw})
    with chaos_device(plan):
        loop.fuzz(RUNS)
    return loop


@pytest.mark.parametrize("case", ["batch-seams", "chunk"])
def test_seam_faults_replay_bit_identical(ref, case):
    """Scripted faults at every batch-at-a-time seam, one campaign each
    engine: K1 (`fused`), its resume leg, the insert, the generation
    (batch at a time, fused step on), and the precise `chunk` (fused step
    off) — each abandoned, rebuilt and replayed bit-identically, the
    ladder stepping down and (promote_after=1) back up."""
    if case == "batch-seams":
        faults = [("fused", DEVICE_HANG), ("fused-resume", DEVICE_ERROR),
                  ("device-insert", (DEVICE_POISON, 3)),
                  ("devmut-generate", DEVICE_HANG, 2)]
        kw = dict(fused_step="on")
    else:
        faults = [("chunk", DEVICE_ERROR), ("chunk", DEVICE_HANG),
                  ("chunk", (DEVICE_POISON, 5))]
        kw = dict(fused_step="off")
    plan = SeamFaultPlan(faults)
    loop = _faulted(plan, promote_after=1, **kw)
    assert campaign_fingerprint(loop) == ref
    assert [f[:2] for f in plan.fired] == [
        (f[1][0] if isinstance(f[1], tuple) else f[1], f[0])
        for f in faults]
    reg = _reg(loop)
    assert reg.counter("supervise.rebuilds").value == len(faults)
    assert reg.counter("supervise.poisoned_lanes").value == 1
    assert reg.counter("supervise.degradations").value >= 1
    assert reg.counter("supervise.promotions").value >= 1
    assert loop.backend.supervisor.quarantined == set()


def test_fused_window_error_and_hang_replay_bit_identical(ref):
    """Two faults on K1's windows: a device error on the cold window
    (dispatch 0), whose in-place planes are rebuilt from the pristine
    snapshot, then — after promote_after=1 re-promoted the campaign to
    windows — a hang on a steady-state window that the watchdog abandons.
    Each drops the ladder to batch at a time, each batch replays
    bit-identically, and the campaign ends back in windows."""
    plan = SeamFaultPlan([("megachunk", DEVICE_ERROR),
                          ("megachunk", DEVICE_HANG)])
    loop = _faulted(plan, megachunk=2, promote_after=1)
    assert campaign_fingerprint(loop) == ref
    assert [f[:3] for f in plan.fired][0] == ("device-error", "megachunk",
                                              0)
    assert [f[:2] for f in plan.fired][1] == ("device-hang", "megachunk")
    reg = _reg(loop)
    assert reg.counter("supervise.rebuilds").value == 2
    assert reg.counter("supervise.watchdog_fires").value == 1
    assert reg.counter("supervise.degradations").value >= 2
    assert reg.counter("supervise.promotions").value >= 2
    assert loop.backend.supervisor.ladder.rung_name == "full"
    assert loop.registry.counter("device.fused_window_rounds").value > 0


def test_persistent_quarantine_masks_lane_and_completes():
    """quarantine_threshold=1: the violating lane is quarantined on
    first sight, parked idle (never harvested), and the campaign still
    completes every testcase on the surviving lanes, batch at a time
    (windows cannot mask lanes).  Two batches: the quarantine is in place
    from the first."""
    plan = SeamFaultPlan([("device-insert", (DEVICE_POISON, 3))])
    loop = _port(quarantine_threshold=1, **SUPERVISED)
    with chaos_device(plan):
        loop.fuzz(RUNS // 2)
    sup = loop.backend.supervisor
    assert sup.quarantined == {3}
    assert loop.stats.testcases == RUNS // 2
    assert sup.registry.counter("device.quarantined").value == 1
    assert sup.heartbeat_fields()["supervise_quarantined"] == 1
    assert sup.megachunk_disabled
    assert loop.backend.status_counts.get("OK", 0) >= 2


def test_device_chaos_with_kill_and_resume_parity(ref, tmp_path):
    """The combined soak: a supervised campaign takes a scripted error on
    K1, checkpoints every batch, is killed at a batch boundary, and the
    resumed campaign ends bit-identical to the fault-free run."""
    ckpt = tmp_path / "checkpoint"
    victim = _port(**SUPERVISED)
    victim.checkpoint_dir, victim.checkpoint_every = ckpt, 1
    plan = SeamFaultPlan([("fused", DEVICE_ERROR)], start=4)
    with chaos_device(plan):
        fuzz_until_killed(victim, RUNS, kill_at_batch=2)
    assert len(plan.fired) == 1, "scripted error never fired before kill"

    state, fell_back = load_campaign(ckpt)
    assert not fell_back
    resumed = _port(**SUPERVISED)
    resumed.checkpoint_dir, resumed.checkpoint_every = ckpt, 1
    assert restore_campaign(resumed, state, ckpt) == 2
    resumed.fuzz(RUNS)
    assert campaign_fingerprint(resumed) == ref


# ---------------------------------------------------------------------------
# seam routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seam", sorted(SEAM_SITES))
def test_seam_site_routes_through_the_supervisor(seam):
    """The port's counterpart of the reference's `supervise` lint family:
    each SEAM_SITES entry resolves, and its source dispatches the seam
    through supervisor.dispatch by name."""
    module, _, qual = SEAM_SITES[seam].partition(":")
    obj = importlib.import_module(module)
    for part in qual.split("."):
        obj = getattr(obj, part)
    src = inspect.getsource(obj)
    assert "supervisor.dispatch(" in src or "sup.dispatch(" in src, seam
    assert f'"{seam}"' in src, seam
