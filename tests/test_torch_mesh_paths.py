"""The paths that ride on the port's lane mesh, against the JAX package,
on the CPU: triage, checkpoint/resume, elastic resharding, the
supervisor's recovery and reshard rung, and the multi-tenant batch.
Held against tests/test_triage.py, test_resume.py, test_fleet.py,
test_supervise.py and test_tenancy.py's mesh cases.

  * triage on a mesh: minimize, distill (the keep sets and the per-
    testcase credit ledger) and vbreak's captures equal the JAX package's
  * a devmangle campaign (8 lanes, 2 batches, K1's plain version on every
    shard) equal to the JAX package's, resumed from a checkpoint on the
    mesh, moved from one device onto a mesh by `run_elastic` at a batch
    boundary, and replayed after a scripted device error on the mesh;
    placements whose lane count does not divide are refused
  * the degradation ladder's bottom rung flags a reshard, and on a mesh
    with checkpoints the supervisor turns it into a request for half the
    shards (the campaign then stops at the batch boundary)
  * TenancyMeshBackend with lane quotas that straddle shard boundaries
    (a devmangle tenant's masked insert cut across shards): each tenant
    equal to the JAX package's run of the same table

The JAX side runs on one device (its own tests pin its mesh equal to it);
the port runs on meshes of 2 shards of `cpu` (4 for the tenancy quotas,
so that both straddle a boundary): the port's precise step costs the
same per shard at any lane count, so these multi-batch cases stay
affordable there, while tests/test_torch_meshrun.py holds the 8-shard
mesh itself.  Every comparison is exact (tolerance 0).
"""

import types

import numpy as np
import pytest

from tests import test_tenancy as jt
from tests.torchport import (
    build_port_tlv_campaign, campaign_fingerprint,
    one_torch_thread,  # noqa: F401  (module fixture)
)
from wtf_tpu.analysis.trace import build_tlv_campaign
from wtf_tpu.testing.triage_smoke import MINIMAL

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BUILD = dict(n_lanes=8, mutator="devmangle", limit=20_000, seed=0x5EED,
             chunk_steps=128, overlay_slots=16)
RUNS = BUILD["n_lanes"] * 2
SHARDS = 2


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's campaign: the bit-identity bar of every port
    placement below."""
    loop = build_tlv_campaign(**BUILD)
    loop.fuzz(RUNS)
    fp = campaign_fingerprint(loop)
    assert fp["testcases"] == RUNS and fp["new_coverage"] > 0
    return fp


def _port(mesh_devices=SHARDS, **kw):
    return build_port_tlv_campaign(fused_step="on",
                                   mesh_devices=mesh_devices,
                                   **{**BUILD, **kw})


# ---------------------------------------------------------------------------
# triage
# ---------------------------------------------------------------------------

TRIAGE_LANES = 64   # minimize's 4 dispatches of the crasher (16 lanes: 9)
TRIAGE = dict(uop_capacity=1 << 10, overlay_slots=16, edge_bits=12,
              chunk_steps=64)
CORPUS = [b"\x01\x02XY", b"\x01\x03ABC", b"\x02\x08QQQQQQQQ",
          b"\x01\x02XY\x02\x08WWWWWWWW", b"\x03\x04abcd"]
VBREAK_INPUT = b"\x01\x02XY\x02\x08WWWWWWWW"


def _triage_all(backend, target, triage, next_record):
    """minimize, distill and vbreak on one backend -> comparable tuple."""
    m = triage.minimize(backend, target, MINIMAL)
    d = triage.distill(backend, target, CORPUS)
    captures, _ = triage.vbreak(
        backend, target, triage.perturbations(VBREAK_INPUT, 3),
        next_record, hit=2)
    return ((m.data, m.bucket, m.rounds, m.dispatches, m.simplified),
            (d.keep, d.prefix_keep, np.asarray(d.credit_bits).tolist(),
             d.total_bits, d.kept_bits),
            [(c.gpr, c.rflags, c.icount, c.mem) if c is not None else None
             for c in captures])


def test_mesh_bit_parity_all_three():
    """Triage on a 2-shard mesh (the replay core dispatching through
    MeshRunner, its first-hit credit over the gathered planes) == the JAX
    package on one device: minimize's bytes, bucket and dispatch count,
    distill's keep sets and credit ledger, vbreak's captures."""
    from wtf_tpu import triage as jtriage
    from wtf_tpu.backend.tpu import TpuBackend
    from wtf_tpu.harness import demo_tlv as jtlv
    from wtf_tpu_torch import triage
    from wtf_tpu_torch.backend import create_backend
    from wtf_tpu_torch.harness import demo_tlv

    jb = TpuBackend(jtlv.build_snapshot(), n_lanes=TRIAGE_LANES,
                    limit=20_000, **TRIAGE)
    jb.initialize()
    jtlv.TARGET.init(jb)
    want = _triage_all(jb, jtlv.TARGET, jtriage, jtlv.CODE_GVA + 18)

    b = create_backend("gpu", demo_tlv.build_snapshot(),
                       n_lanes=TRIAGE_LANES, limit=20_000, device="cpu",
                       fused_step="on", mesh_devices=2, **TRIAGE)
    b.initialize()
    demo_tlv.TARGET.init(b)
    got = _triage_all(b, demo_tlv.TARGET, triage, demo_tlv.CODE_GVA + 18)
    assert got[0] == want[0] and got[0][0] == MINIMAL
    assert got[1] == want[1]
    assert got[2] == want[2] and any(c is not None for c in got[2])
    by_shard = b.registry.counter("device.shard_instructions").dump()
    assert len(by_shard) == 2 and sum(by_shard.values()) == \
        b.registry.counter("device.instructions").value > 0


# ---------------------------------------------------------------------------
# resume, elastic reshard, recovery
# ---------------------------------------------------------------------------

def test_resume_parity_mesh(jax_ref, tmp_path):
    """A mesh campaign checkpointed every batch, killed after the first,
    resumed on the mesh from the checkpoint (placement-free: the
    aggregates come back on the mesh's first device and are copied to
    each shard's at the merge): equal to the uninterrupted JAX run."""
    from wtf_tpu_torch.resume import load_campaign, restore_campaign
    from wtf_tpu_torch.testing.faultinject import fuzz_until_killed

    ckpt = tmp_path / "ck"
    victim = _port()
    victim.checkpoint_dir, victim.checkpoint_every = ckpt, 1
    fuzz_until_killed(victim, RUNS, kill_at_batch=1)
    resumed = _port()
    state, _ = load_campaign(ckpt)
    assert state["config"]["mesh_devices"] == SHARDS
    restore_campaign(resumed, state, ckpt)
    resumed.fuzz(RUNS)
    assert campaign_fingerprint(resumed) == jax_ref
    assert resumed.backend._agg_cov.device == \
        resumed.backend.mesh.devices[0]


def test_elastic_reshard_bit_identical(jax_ref, tmp_path):
    """The in-loop policy moves a single-device campaign onto a 2-shard
    mesh at the first batch boundary (checkpoint, rebuild, restore):
    it finishes bit-identical to the JAX package's unmoved run."""
    from wtf_tpu_torch.fleet.elastic import ScheduledReshard, run_elastic

    def build_loop(mesh_devices):
        return _port(mesh_devices=mesh_devices)

    policy = ScheduledReshard({1: SHARDS})
    loop = run_elastic(build_loop, RUNS, tmp_path / "ck", policy=policy,
                       start_devices=None)
    assert policy.fired == [(1, SHARDS)]
    assert loop.backend.mesh.size == SHARDS
    assert campaign_fingerprint(loop) == jax_ref
    assert loop.registry.counter("campaign.reshards").value == 1


def test_reshard_refuses_indivisible_lanes(tmp_path):
    from wtf_tpu.fleet.elastic import validate_placement as jvalidate
    from wtf_tpu_torch import cli
    from wtf_tpu_torch.fleet.elastic import validate_placement

    for fn in (validate_placement, jvalidate):
        with pytest.raises(ValueError, match="not divisible"):
            fn({"config": {"lanes": 8}}, 3)
        fn({"config": {"lanes": 8}}, 4)
    # the CLI refuses before it builds anything
    loop = _port(mesh_devices=None)
    loop.checkpoint_dir, loop.checkpoint_every = tmp_path / "ck", 1
    loop.fuzz(BUILD["n_lanes"])
    rc = cli.main(["fleet", "reshard", "--name", "demo_tlv", "--checkpoint",
                   str(tmp_path / "ck"), "--runs", "16", "--lanes", "8",
                   "--mesh-devices", "3", "--device", "cpu"])
    assert rc == 1


def test_mesh_error_recovery_replays_bit_identical(jax_ref):
    """A scripted device error on the mesh: the batch is abandoned, the
    MeshRunner rebuilt from host state, the batch replayed — equal to
    the JAX package's fault-free run."""
    from wtf_tpu_torch.supervise import DEVICE_ERROR
    from wtf_tpu_torch.testing.faultinject import FaultPlan, chaos_device

    plan = FaultPlan([], device_faults={6: DEVICE_ERROR})
    loop = _port(supervise=True, dispatch_timeout=30.0)
    with chaos_device(plan):
        loop.fuzz(RUNS)
    assert [f[0] for f in plan.fired] == [DEVICE_ERROR]
    assert campaign_fingerprint(loop) == jax_ref
    assert loop.backend.supervisor.registry.counter(
        "supervise.rebuilds").value >= 1


def test_ladder_bottom_requests_reshard(tmp_path):
    """Below the ladder's last rung a failure flags `wants_reshard` (the
    JAX ladder's rule); on a mesh with a checkpoint dir the supervisor
    installs its reshard rung as the loop's policy, which asks for half
    the shards once and stops the campaign at the batch boundary."""
    from wtf_tpu.supervise.ladder import DegradationLadder as JLadder
    from wtf_tpu_torch.supervise import DegradationLadder

    def stub():
        runner = types.SimpleNamespace(fused_enabled=True,
                                       adaptive_chunks=True)
        return types.SimpleNamespace(
            backend=types.SimpleNamespace(runner=runner), megachunk=2)

    for cls in (DegradationLadder, JLadder):
        ladder = cls(stub())
        for _ in range(len(ladder.rungs) - 1):
            assert ladder.on_failure()
        assert ladder.rung_name == "fixed-chunk"
        assert not ladder.wants_reshard
        assert not ladder.on_failure()     # bottom: no rung change
        assert ladder.wants_reshard

    loop = _port(supervise=True)
    loop.checkpoint_dir, loop.checkpoint_every = tmp_path / "ck", 1
    sup = loop.backend.supervisor
    sup.attach_loop(loop)
    assert loop.reshard_policy == sup.reshard_request
    assert sup.reshard_request(loop) is None       # nothing failing yet
    for _ in range(len(sup.ladder.rungs)):
        sup.ladder.on_failure()
    assert sup.reshard_request(loop) == SHARDS // 2
    assert sup.reshard_request(loop) is None       # asked once
    sup.ladder.wants_reshard = True
    loop.fuzz(RUNS)
    assert loop.reshard_to == SHARDS // 2
    assert loop.batches_done == 1
    assert (tmp_path / "ck" / "checkpoint.json").exists()
    # a single-device campaign records the flag and never reshards
    single = _port(mesh_devices=None, supervise=True)
    single.checkpoint_dir = tmp_path / "ck1"
    single.backend.supervisor.attach_loop(single)
    assert single.reshard_policy is None


# ---------------------------------------------------------------------------
# the multi-tenant batch on a mesh
# ---------------------------------------------------------------------------

TENANTS = [("alice", "demo_tlv", 3), ("bob", "demo_kernel", 5)]
TENANT_MUTS = dict(jt.MUTS, alice=("devmangle", 42, jt.SEED_TLV))
TENANT_LIMIT = 20_000
TENANT_SHARDS = 4


def test_mesh_tenancy_bit_parity():
    """TenancyMeshBackend over 4 shards of 2 lanes with quotas 3 + 5 —
    both straddle a shard boundary, the devmangle tenant's masked insert
    and every per-tenant merge mask cut across shards: each tenant's
    coverage planes, corpus, crash buckets and decoded rips equal the JAX
    package's run of the same table on one device."""
    from wtf_tpu_torch.harness.targets import Targets, load_builtin_targets
    from wtf_tpu_torch.tenancy import (
        MultiTenantLoop, TenancyMeshBackend, TenantRuntime, TenantSpec,
        create_tenancy_backend,
    )
    from tests.test_torch_tenancy import _fingerprint

    _b, _r, want = jt._campaign(TENANTS, batches=2, muts=TENANT_MUTS,
                                limit=TENANT_LIMIT)
    load_builtin_targets()
    targets = Targets.instance()
    specs = [TenantSpec(n, targets.get(t), targets.get(t).snapshot(), q)
             for n, t, q in TENANTS]
    backend = create_tenancy_backend(specs, 8, mesh_devices=TENANT_SHARDS,
                                     limit=TENANT_LIMIT, device="cpu",
                                     fused_step="on")
    assert isinstance(backend, TenancyMeshBackend)
    backend.initialize()
    for i, s in enumerate(specs):
        with backend.tenant_context(i):
            s.target.init(backend)
    runtimes, lane_lo = [], 0
    for spec in specs:
        mut, seed, data = TENANT_MUTS[spec.name]
        rt = TenantRuntime(spec, seed=seed, runs=1 << 20, mutator_name=mut,
                           max_len=256, lane_lo=lane_lo)
        rt.corpus.add(data)
        runtimes.append(rt)
        lane_lo += spec.lanes
    loop = MultiTenantLoop(backend, runtimes, stats_every=1e9)
    for _ in range(2):
        loop.run_one_batch()
    got = _fingerprint(backend, runtimes)
    for name in ("alice", "bob"):
        assert got[name]["rips"] and any(got[name]["local_cov"])
    assert got == want
