"""The port's fused mesh window against the JAX package's, and the mesh
window under the supervisor and checkpoints, on the CPU.

  * the 4-shard fused window campaign's counters (windows, K1 launches
    and precise sweeps, both sums over the shards) equal the JAX
    4-device fused mesh window's (tests/test_megachunk.py's
    test_fused_window_mesh_parity campaign at 4 devices)
  * a supervised 2-shard window campaign with a scripted hang on its
    second window: the watchdog abandons it, the ladder steps down to
    batch at a time and back, and the campaign ends equal to the
    fault-free mesh window campaign
  * a 2-shard window campaign checkpointed at every window boundary and
    killed after its first window, resumed on a new mesh: equal to the
    uninterrupted run

Every comparison is exact (tolerance 0).
"""

import pytest

from tests.torchport import (
    build_port_tlv_campaign, campaign_fingerprint,
    one_torch_thread,  # noqa: F401  (module fixture)
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BUILD = dict(n_lanes=8, mutator="devmangle", limit=20_000, seed=0x5EED,
             chunk_steps=128, overlay_slots=16)
RUNS = BUILD["n_lanes"] * 3
COUNTERS = ("megachunk.windows", "device.fused_window_rounds",
            "device.fused_window_xla_steps")


def test_fused_mesh_window_counters_equal_jax():
    from wtf_tpu.analysis.trace import build_tlv_campaign

    jax = build_tlv_campaign(megachunk=3, mesh_devices=4, fused_step="on",
                             **BUILD)
    jax.fuzz(RUNS)
    port = build_port_tlv_campaign(megachunk=3, mesh_devices=4,
                                   fused_step="on", **BUILD)
    port.fuzz(RUNS)
    assert campaign_fingerprint(port) == campaign_fingerprint(jax)
    got = {n: port.registry.counter(n).value for n in COUNTERS}
    assert got == {n: jax.registry.counter(n).value for n in COUNTERS}
    assert got["device.fused_window_rounds"] > 0


@pytest.fixture(scope="module")
def fault_free():
    loop = build_port_tlv_campaign(megachunk=3, mesh_devices=2,
                                   fused_step="on", **BUILD)
    loop.fuzz(RUNS)
    fp = campaign_fingerprint(loop)
    assert fp["new_coverage"] > 0
    return fp


def test_supervised_mesh_window_hang_replays(fault_free):
    """tests/test_supervise.py's megachunk rung on a mesh window: a hang
    on the second window's dispatch -> watchdog, rung down to batch at a
    time, replay, rung back up; the result is the fault-free run's."""
    from wtf_tpu_torch.supervise import DEVICE_HANG
    from wtf_tpu_torch.testing.faultinject import SeamFaultPlan, chaos_device

    plan = SeamFaultPlan([("megachunk", DEVICE_HANG, 2)])
    loop = build_port_tlv_campaign(megachunk=3, mesh_devices=2,
                                   fused_step="on", supervise=True,
                                   dispatch_timeout=30.0, promote_after=1,
                                   **BUILD)
    with chaos_device(plan):
        loop.fuzz(RUNS)
    assert [f[:2] for f in plan.fired] == [(DEVICE_HANG, "megachunk")]
    assert campaign_fingerprint(loop) == fault_free
    reg = loop.backend.supervisor.registry
    assert reg.counter("supervise.watchdog_fires").value == 1
    assert reg.counter("supervise.degradations").value >= 1
    assert reg.counter("megachunk.windows").value >= 2


def test_mesh_window_kill_and_resume(fault_free, tmp_path):
    from wtf_tpu_torch.resume import load_campaign, restore_campaign
    from wtf_tpu_torch.testing.faultinject import fuzz_until_killed

    ckpt = tmp_path / "ck"
    victim = build_port_tlv_campaign(megachunk=3, mesh_devices=2,
                                     fused_step="on", **BUILD)
    victim.checkpoint_dir, victim.checkpoint_every = ckpt, 1
    fuzz_until_killed(victim, RUNS, kill_at_batch=1)
    killed_at = victim.batches_done
    assert 0 < killed_at < RUNS // BUILD["n_lanes"]
    resumed = build_port_tlv_campaign(megachunk=3, mesh_devices=2,
                                      fused_step="on", **BUILD)
    state, fell_back = load_campaign(ckpt)
    assert not fell_back
    assert restore_campaign(resumed, state, ckpt) == killed_at
    resumed.fuzz(RUNS)
    assert campaign_fingerprint(resumed) == fault_free
