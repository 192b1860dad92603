"""The port's multi-tenant campaign stack (wtf_tpu_torch/tenancy) against
the JAX package's (wtf_tpu/tenancy), bit for bit, on the CPU.

Each case mirrors one of tests/test_tenancy.py's and holds the port's
result against the JAX package's on the same inputs (the JAX side runs
through that file's own helpers, each reference once per module):

  stacked image / batch state   stack_images, build_batch_state (padded
                                lanes included) and the tenant-tagged
                                decode cache, array for array;
  masked insert                 device_insert_impl with `active` against
                                the JAX masked insert, inactive lanes
                                untouched;
  isolation                     the port's mixed batch equals the JAX
                                package's mixed batch AND its solo runs
                                (coverage planes, corpus, crash buckets,
                                decoded rips), the devmangle tenant
                                stream and the three-tenant mix with
                                demo_pe included;
  preemption                    a tenant checkpointed and resumed into a
                                different placement equals the JAX
                                package's uninterrupted run;
  scheduler                     load_jobs, placement, rotation, the
                                preemption events and the `sched` CLI
                                against the JAX CLI at equal seeds.

The three-tenant mix runs one batch at a limit of 1,200 in both packages
(the JAX test's 2,000,000 lets a demo_pe mutant run ~10**6 precise
steps, hours of the port's CPU step), with carol seeded by
test_pe_target's 3-point input (Ok after 1,190 instructions) so her
lanes finish inside it.  The
mesh parity case is tests/test_torch_mesh_paths.py's; the two lint
cases wait for the port-side checks.
"""

import json
import struct

import numpy as np
import pytest
import torch

from tests import test_tenancy as jt
from tests.torchport import (  # noqa: F401
    assert_machines_equal, one_torch_thread,
)
from wtf_tpu_torch import convert
from wtf_tpu_torch.harness.targets import Targets, load_builtin_targets
from wtf_tpu_torch.interp.uoptable import DecodeCache, tag_key
from wtf_tpu_torch.tenancy.backend import TenantSpec, create_tenancy_backend
from wtf_tpu_torch.tenancy.image import build_batch_state, stack_images
from wtf_tpu_torch.tenancy.loop import MultiTenantLoop, TenantRuntime
from wtf_tpu_torch.tenancy.sched import Job, Scheduler, load_jobs
from wtf_tpu_torch.tenancy.state import (
    extract_bits, restore_tenant, scatter_bits,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LIMIT = jt.LIMIT
MUTS = jt.MUTS
SEED_TLV = jt.SEED_TLV
SEED_KERN = jt.SEED_KERN
PE_LIMIT = 1_200
SCHED_LIMIT = 5_000        # the scheduler cases' budget, both packages
PE_PTS = struct.pack("<12d", 1.0, 2.0, 3.0, 2.0, 3.0, 4.0, 3.0, 4.0, 5.0,
                     4.0, 5.0, 6.0)
PE_SHORT = struct.pack("<Id", 3, 2.0) + PE_PTS[:72]   # Ok, 1,190 insns


def _targets():
    load_builtin_targets()
    return Targets.instance()


def _build(cfg, n_lanes=None, limit=LIMIT, fused="on"):
    """The port's (backend, specs) for a tenant table of (name, target,
    quota): K1's plain version on by default (its tenant row and key tag
    are what the mixed batch exercises)."""
    targets = _targets()
    specs = [TenantSpec(n, targets.get(t), targets.get(t).snapshot(), q)
             for n, t, q in cfg]
    n_lanes = n_lanes if n_lanes else sum(q for _, _, q in cfg)
    backend = create_tenancy_backend(specs, n_lanes, limit=limit,
                                     device="cpu", fused_step=fused)
    backend.initialize()
    for i, s in enumerate(specs):
        with backend.tenant_context(i):
            s.target.init(backend)
    return backend, specs


def _runtimes(backend, specs, cfg_mut):
    out, lane_lo = [], 0
    for spec in specs:
        mut, seed, data = cfg_mut[spec.name]
        rt = TenantRuntime(spec, seed=seed, runs=1 << 20,
                           mutator_name=mut, max_len=256, lane_lo=lane_lo)
        rt.corpus.add(data)
        out.append(rt)
        lane_lo += spec.lanes
    return out


def _fingerprint(backend, runtimes):
    """jt._fingerprint's fields from the port's backend."""
    out = {}
    for i, rt in enumerate(runtimes):
        cov, edge = backend.tenant_coverage_state(i)
        entries = backend.runner.cache.tenant_entries(i)
        out[rt.name] = {
            "local_cov": extract_bits(cov, [e[0] for e in entries]
                                      ).tobytes(),
            "edge": edge.tobytes(),
            "corpus": list(rt.corpus),
            "buckets": sorted(rt.crash_buckets),
            "rips": sorted(e[1] for e in entries),
        }
    return out


def _campaign(cfg, batches=3, capture_devmut=None, muts=None, limit=LIMIT,
              fused="on"):
    backend, specs = _build(cfg, limit=limit, fused=fused)
    runtimes = _runtimes(backend, specs, muts if muts else MUTS)
    loop = MultiTenantLoop(backend, runtimes, stats_every=1e9)
    for _ in range(batches):
        loop.run_one_batch()
        if capture_devmut is not None:
            for rt in runtimes:
                if rt.device:
                    words, lens = rt.mutator.current_batch()
                    capture_devmut.setdefault(rt.name, []).append(
                        (words.numpy().tobytes(), lens.numpy().tobytes()))
    return backend, runtimes, _fingerprint(backend, runtimes)


# ---------------------------------------------------------------------------
# the JAX references, once per module
# ---------------------------------------------------------------------------

TWO = [("alice", "demo_tlv", 4), ("bob", "demo_kernel", 4)]


@pytest.fixture(scope="module")
def jax_two():
    """JAX solo alice, solo bob and the two-tenant mix (3 batches)."""
    return {"alice": jt._campaign(TWO[:1])[2],
            "bob": jt._campaign(TWO[1:])[2],
            "mixed": jt._campaign(TWO)[2]}


# ---------------------------------------------------------------------------
# stacked image table + batch state + tagged decode cache
# ---------------------------------------------------------------------------

def _pe_available():
    from wtf_tpu_torch.harness import demo_pe

    return demo_pe.available()


def test_stack_images_equals_jax():
    from wtf_tpu.harness.targets import Targets as JTargets
    from wtf_tpu.tenancy.image import stack_images as j_stack

    names = ["demo_tlv", "demo_kernel", "demo_maze"]
    if _pe_available():
        names.append("demo_pe")
    targets = _targets()
    jt._targets()
    pms = [targets.get(n).snapshot().physmem for n in names]
    jpms = [JTargets.instance().get(n).snapshot().physmem for n in names]
    image = stack_images(pms)
    want = j_stack(jpms)
    assert np.array_equal(image.frame_table.numpy(),
                          np.asarray(want.frame_table))
    assert np.array_equal(image.pages.numpy().view(np.uint64),
                          np.asarray(want.pages))
    # every tenant's present pfns route to its own page bytes
    table = image.frame_table.numpy()
    pages = image.pages.numpy()
    for t, pm in enumerate(pms):
        own = pm.frame_table[0]
        present = np.nonzero(own)[0]
        assert present.size
        for pfn in present[:: max(1, present.size // 16)]:
            assert (pages[table[t, pfn]]
                    == pm.pages[own[pfn]].view(np.int64)).all()
        if own.shape[0] < table.shape[1]:
            assert (table[t, own.shape[0]:] == 0).all()


def test_build_batch_state_equals_jax():
    """Machine, restore template, selector and image of a padded
    three-tenant batch (10 lanes, quotas 3/2/3, 2 idle) against the JAX
    package's, plane for plane."""
    from wtf_tpu.harness.targets import Targets as JTargets
    from wtf_tpu.tenancy.backend import TenantSpec as JSpec
    from wtf_tpu.tenancy.image import build_batch_state as j_build

    cfg = [("a", "demo_tlv", 3), ("b", "demo_kernel", 2),
           ("c", "demo_maze", 3)]
    targets = _targets()
    jt._targets()
    specs = [TenantSpec(n, None, targets.get(t).snapshot(), q)
             for n, t, q in cfg]
    jspecs = [JSpec(n, None, JTargets.instance().get(t).snapshot(), q)
              for n, t, q in cfg]
    got = build_batch_state(specs, 10, 256, 4, 10)
    want = j_build(jspecs, 10, 256, 4, 10)
    assert got.tenant_of_lane.tolist() == [0, 0, 0, 1, 1, 2, 2, 2, 0, 0]
    assert np.array_equal(got.tenant_of_lane, want.tenant_of_lane)
    assert np.array_equal(got.image.tenant.numpy(),
                          np.asarray(want.image.tenant))
    assert_machines_equal(want.machine, got.machine, where="machine")
    assert_machines_equal(want.template, got.template, where="template")


def test_decode_cache_tenant_tagged_keys_equal_jax():
    from wtf_tpu.cpu.decoder import decode as j_decode
    from wtf_tpu.interp.uoptable import DecodeCache as JCache
    from wtf_tpu.interp.uoptable import tag_key as j_tag
    from wtf_tpu_torch.cpu.decoder import decode

    rip = 0x1400_0000
    neg = 0xFFFF_F800_0000_1000          # canonical-negative (demo_kernel)
    cache, jcache = DecodeCache(capacity=64), JCache(capacity=64)
    for c, dec in ((cache, decode), (jcache, j_decode)):
        c.add(rip, dec(b"\x90", rip), 5, 5, tenant=0)
        c.add(rip, dec(b"\xc3", rip), 7, 7, tenant=1)
        c.add(neg, dec(b"\x0f\x05", neg), 9, 9, tenant=2)
        c.add(rip + 1, dec(b"\x90", rip + 1), 5, 5, tenant=1)
        c.set_breakpoint(rip, tenant=1)
    i0, i1 = cache.entry_index(rip, 0), cache.entry_index(rip, 1)
    assert i0 != i1
    assert cache.uop_at(rip, 1).raw == b"\xc3"
    assert cache.has_breakpoint(rip, 1) and not cache.has_breakpoint(rip, 0)
    assert cache.bp[i1] == 1 and cache.bp[i0] == 0
    for t in (0, 1, 2, 3):
        assert cache.tenant_entries(t) == jcache.tenant_entries(t), t
    assert cache.rip_of(cache.entry_index(neg, 2)) == neg
    assert cache.checkpoint_entries() == jcache.checkpoint_entries()
    assert np.array_equal(cache.rip, jcache.rip)
    fresh = DecodeCache(capacity=64)
    fresh.restore_entries(cache.checkpoint_entries())
    assert fresh.entry_index(rip, 1) == i1
    for key in (0x7FFF_1234, neg, 0):
        for t in (0, 1, 3, (1 << 15) - 1):
            assert tag_key(key, t) == j_tag(key, t)
            assert tag_key(tag_key(key, t), t) == key


def test_extract_scatter_bits_equal_jax():
    from wtf_tpu.tenancy.state import extract_bits as j_extract
    from wtf_tpu.tenancy.state import scatter_bits as j_scatter

    rng = np.random.default_rng(7)
    words = rng.integers(0, 1 << 32, size=8, dtype=np.uint64).astype(
        np.uint32)
    for idxs in ([3, 17, 64, 200, 255], [], list(range(0, 256, 3)),
                 [255, 0, 31, 32]):
        local = extract_bits(words, idxs)
        assert np.array_equal(local, j_extract(words, idxs))
        back = scatter_bits(local, idxs, 8)
        assert np.array_equal(back, j_scatter(local, idxs, 8))
        for j, i in enumerate(idxs):
            want = (int(words[i >> 5]) >> (i & 31)) & 1
            assert ((int(back[i >> 5]) >> (i & 31)) & 1) == want


# ---------------------------------------------------------------------------
# the masked device insert
# ---------------------------------------------------------------------------

def test_masked_insert_equals_jax():
    """device_insert_impl with `active`: the JAX masked insert's overlay
    rows, counters, overflow, status and ABI registers, with every
    inactive lane exactly as it was (rows a host push claimed, a lane
    one row short of the region, a non-RUNNING lane, a pushed row that
    already holds an insert pfn)."""
    import jax.numpy as jnp

    from tests.torchport import jax_leaves, jax_machine
    from wtf_tpu.interp.machine import machine_init as j_machine_init
    from wtf_tpu.interp.runner import device_insert_impl as j_insert
    from wtf_tpu.harness.targets import Targets as JTargets
    from wtf_tpu_torch.interp.runner import device_insert_impl

    jt._targets()
    snap = JTargets.instance().get("demo_tlv").snapshot()
    n, slots, n_pages = 8, 4, 2
    leaves = {k: np.array(v) for k, v in jax_leaves(
        j_machine_init(snap.cpu, n, 64, slots, 10)).items()}
    rng = np.random.default_rng(11)
    pfns = np.array([0x120, 0x121], dtype=np.int32)
    ov_pfn = leaves["overlay.pfn"]
    ov_count = leaves["overlay.count"]
    ov_pfn[1, 0], ov_count[1] = 0x55, 1          # a host-pushed row
    ov_pfn[2, :3], ov_count[2] = [0x56, 0x57, 0x58], 3   # one row short
    ov_pfn[5, 0], ov_count[5] = 0x121, 1          # holds an insert pfn
    ov_pfn[6, :3], ov_count[6] = [0x59, 0x5A, 0x5B], 3
    leaves["overlay.data"][...] = rng.integers(
        0, 1 << 63, size=leaves["overlay.data"].shape, dtype=np.uint64)
    leaves["status"][3] = 1                        # not RUNNING
    active = np.array([1, 1, 1, 0, 0, 1, 1, 0], dtype=bool)
    words = rng.integers(0, 1 << 32, size=(n, 1500), dtype=np.uint64
                         ).astype(np.uint32)
    lens = rng.integers(0, 6000, size=n).astype(np.int32)
    gva = 0x0000_7FFF_1234_5000
    gva_l = np.array([gva & 0xFFFF_FFFF, gva >> 32], dtype=np.uint32)
    want = j_insert(n_pages, 1, 2, masked=True)(
        jax_machine(leaves), jnp.asarray(words), jnp.asarray(lens),
        jnp.asarray(pfns), jnp.asarray(gva_l), jnp.asarray(active))
    m = convert.machine_from_jax(leaves)
    before = m.clone()
    device_insert_impl(m, torch.from_numpy(words.view(np.int32)),
                       torch.from_numpy(lens), torch.from_numpy(pfns),
                       gva, 1, 2, torch.from_numpy(active))
    assert_machines_equal(want, m, where="masked insert")
    off = torch.from_numpy(~active)
    for name, a in before.planes():
        b = dict(m.planes())[name]
        assert torch.equal(a[off], b[off]), f"inactive lanes' {name}"
    # the active lanes did land: lane 0 holds both pages, lane 2 (one
    # row short) and lane 6 overflowed
    assert m.overlay.count.tolist()[0] == 2
    assert m.overlay.overflow.tolist() == [False, False, True, False,
                                           False, False, True, False]


# ---------------------------------------------------------------------------
# isolation: the port's mixed batch == the JAX package's mixed and solo
# ---------------------------------------------------------------------------

def test_mixed_batch_isolation_equals_jax(jax_two):
    backend, _r, mixed = _campaign(TWO)
    for name in ("alice", "bob"):
        assert mixed[name]["rips"], f"{name} decoded nothing"
        assert any(b != 0 for b in mixed[name]["local_cov"])
    assert mixed == jax_two["mixed"]
    assert mixed["alice"] == jax_two["alice"]["alice"]
    assert mixed["bob"] == jax_two["bob"]["bob"]
    shared = set(mixed["alice"]["rips"]) & set(mixed["bob"]["rips"])
    cache = backend.runner.cache
    for rip in list(shared)[:4]:
        assert cache.entry_index(rip, 0) != cache.entry_index(rip, 1)


def test_mixed_batch_isolation_precise_step_equals_jax(jax_two):
    """The same mix with the fused step off: the precise step and the
    host services alone route by tenant."""
    _b, _r, mixed = _campaign(TWO, fused="off")
    assert mixed == jax_two["mixed"]


def test_devmangle_tenant_stream_equals_jax():
    muts = dict(MUTS, alice=("devmangle", 42, SEED_TLV))
    cap_jax: dict = {}
    cap_port: dict = {}
    _b1, _r1, want = jt._campaign(TWO, capture_devmut=cap_jax, muts=muts)
    _b2, _r2, got = _campaign(TWO, capture_devmut=cap_port, muts=muts)
    assert [c for c in cap_port["alice"]] == [
        (w, ln) for w, ln in cap_jax["alice"]]
    assert got == want


def test_three_tenant_mix_with_demo_pe_equals_jax():
    """demo_tlv + demo_kernel + demo_pe (compiler-made code) through one
    batch: the mix equal to the JAX package's mixed run and carol
    (demo_pe) equal to her solo run (one batch at limit 1,200, carol
    seeded by the 3-point input: the module docstring says why; alice's
    and bob's solo equality is test_mixed_batch_isolation_equals_jax's)."""
    if not _pe_available():
        pytest.skip("census DLL not present")
    muts = dict(MUTS, carol=("auto", 7, PE_SHORT))
    cfg3 = [("alice", "demo_tlv", 4), ("bob", "demo_kernel", 4),
            ("carol", "demo_pe", 4)]
    _b, _r, want = jt._campaign(cfg3, batches=1, muts=muts, limit=PE_LIMIT)
    _b, _r, solo = _campaign(cfg3[2:], batches=1, muts=muts,
                             limit=PE_LIMIT, fused="off")
    backend, _r, got = _campaign(cfg3, batches=1, muts=muts,
                                 limit=PE_LIMIT, fused="off")
    for name in ("alice", "bob", "carol"):
        assert got[name]["rips"], f"{name} decoded nothing"
    assert got == want
    assert got["carol"] == solo["carol"]
    assert any(b != 0 for b in got["carol"]["local_cov"])
    assert backend.status_counts.get("OK", 0) > 0


def test_partial_plans_leave_unfilled_lanes_idle():
    from wtf_tpu_torch.core.results import Ok

    backend, _specs = _build(TWO)
    jbackend, _jspecs = jt._build(TWO)
    results = backend.run_batch_tenants(
        [("host", [SEED_TLV]), ("host", [])])
    jresults = jbackend.run_batch_tenants(
        [("host", [SEED_TLV]), ("host", [])])
    assert len(results) == 8
    assert all(isinstance(r, Ok) for r in results)
    assert [str(r) for r in results] == [str(r) for r in jresults]
    assert [backend.lane_found_new_coverage(lane) for lane in range(8)] \
        == [jbackend.lane_found_new_coverage(lane) for lane in range(8)]
    assert not any(backend.lane_found_new_coverage(lane)
                   for lane in range(4, 8))
    assert np.array_equal(backend.tenant_coverage_state(0)[0],
                          jbackend.tenant_coverage_state(0)[0])
    with pytest.raises(ValueError, match="5 testcases for 4 lanes"):
        backend.run_batch_tenants([("host", [b"x"] * 5), ("host", [])])
    with pytest.raises(ValueError, match="unknown plan kind"):
        backend.run_batch_tenants([("bogus", []), ("host", [])])


# ---------------------------------------------------------------------------
# preemption: checkpoint -> a different placement -> resume
# ---------------------------------------------------------------------------

def _ckpt(directory):
    """A checkpoint's state, its wall-clock counter (lane_ms) dropped."""
    from wtf_tpu_torch.resume.checkpoint import load_campaign

    state = load_campaign(directory)[0]
    state["stats"] = {k: v for k, v in state.get("stats", {}).items()
                      if not k.endswith(".lane_ms")}
    return state


def test_preemption_resume_into_different_placement_equals_jax(tmp_path):
    _b, _r, want = jt._campaign([("alice", "demo_tlv", 4)], batches=4)

    # leg 1 in both packages: alice alone, 2 batches, checkpoint
    jbackend1, jspecs1 = jt._build([("alice", "demo_tlv", 4)])
    jrts1 = jt._runtimes(jbackend1, jspecs1, MUTS)
    jrts1[0].checkpoint_dir = tmp_path / "jax"
    jloop1 = jt.MultiTenantLoop(jbackend1, jrts1, stats_every=1e9)
    backend1, specs1 = _build([("alice", "demo_tlv", 4)])
    rts1 = _runtimes(backend1, specs1, MUTS)
    rts1[0].checkpoint_dir = tmp_path / "alice"
    loop1 = MultiTenantLoop(backend1, rts1, stats_every=1e9)
    for loop in (jloop1, loop1):
        loop.run_one_batch()
        loop.run_one_batch()
    info = loop1.checkpoint_tenant(0)
    assert info and info["batches"] == 2
    assert jloop1.checkpoint_tenant(0)
    got_state, want_state = _ckpt(tmp_path / "alice"), _ckpt(
        tmp_path / "jax")
    for key in ("config", "batches", "crash_buckets", "crash_names",
                "corpus_manifest", "rng", "mutator", "stats"):
        assert got_state[key] == want_state[key], key
    for plane in ("cov", "edge"):
        assert np.array_equal(got_state["coverage"][plane],
                              want_state["coverage"][plane]), plane
    assert [list(map(str, e)) for e in got_state["runner"]["cache"]] == \
        [list(map(str, e)) for e in want_state["runner"]["cache"]]

    # leg 2: alice re-placed as tenant 1 behind bob
    backend2, specs2 = _build([("bob", "demo_kernel", 4),
                               ("alice", "demo_tlv", 4)])
    rts2 = _runtimes(backend2, specs2, MUTS)
    rts2[1].checkpoint_dir = tmp_path / "alice"
    loop2 = MultiTenantLoop(backend2, rts2, stats_every=1e9)
    assert loop2.resume_tenant(1) == 2
    rts2[0].runs = 0
    loop2.run_one_batch()
    loop2.run_one_batch()
    assert _fingerprint(backend2, rts2)["alice"] == want["alice"]


def test_restore_tenant_rejects_mismatched_placement(tmp_path):
    from wtf_tpu_torch.resume.checkpoint import CheckpointError

    backend1, specs1 = _build([("alice", "demo_tlv", 4)])
    rts1 = _runtimes(backend1, specs1, MUTS)
    rts1[0].checkpoint_dir = tmp_path / "alice"
    loop1 = MultiTenantLoop(backend1, rts1, stats_every=1e9)
    loop1.run_one_batch()
    assert loop1.checkpoint_tenant(0)
    backend2, specs2 = _build([("alice", "demo_tlv", 8)])
    rt = _runtimes(backend2, specs2, MUTS)[0]
    with pytest.raises(CheckpointError, match="lanes"):
        restore_tenant(backend2, rt, 0, tmp_path / "alice")


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,match", [
    ([{"name": "a", "target": "t", "lanes": 4, "runs": 8, "lane": 9}],
     "unknown fields"),
    ([{"name": "a", "target": "t"}], "missing"),
    ([{"name": "a", "target": "t", "lanes": 4, "runs": 8},
      {"name": "a", "target": "t", "lanes": 4, "runs": 8}], "duplicate"),
    ([{"name": "a", "target": "t", "lanes": 0, "runs": 8}], "lanes > 0"),
    ([{"name": "team.alice", "target": "t", "lanes": 4, "runs": 8}],
     "must match"),
    ([{"name": "../other", "target": "t", "lanes": 4, "runs": 8}],
     "must match"),
    ([{"name": "", "target": "t", "lanes": 4, "runs": 8}], "must match"),
    ([], "non-empty"),
])
def test_load_jobs_validation_equals_jax(tmp_path, rows, match):
    from wtf_tpu.tenancy.sched import load_jobs as j_load

    path = tmp_path / "jobs.json"
    path.write_text(json.dumps(rows))
    with pytest.raises(ValueError, match=match) as got:
        load_jobs(path)
    with pytest.raises(ValueError) as want:
        j_load(path)
    assert str(got.value) == str(want.value)


def test_load_jobs_and_scheduler_checks(tmp_path):
    import dataclasses

    from wtf_tpu.tenancy.sched import load_jobs as j_load

    path = tmp_path / "jobs.json"
    path.write_text(json.dumps({"jobs": [
        {"name": "a", "target": "demo_tlv", "lanes": 4, "runs": 8},
        {"name": "b", "target": "demo_tlv", "lanes": 4, "runs": 8,
         "priority": 2, "mutator": "tlv", "seed": 3, "max_len": 64},
    ]}))
    jobs = load_jobs(path)
    assert [dataclasses.asdict(j) for j in jobs] == [
        dataclasses.asdict(j) for j in j_load(path)]
    assert [j.name for j in jobs] == ["a", "b"]
    assert jobs[1].priority == 2 and jobs[0].seq == 0
    with pytest.raises(ValueError, match="no placement"):
        Scheduler([Job(name="a", target="demo_tlv", lanes=64, runs=8)],
                  n_lanes=8, workdir=tmp_path)
    with pytest.raises(ValueError, match="must match"):
        Scheduler([Job(name="x.y", target="demo_tlv", lanes=4, runs=8)],
                  n_lanes=8, workdir=tmp_path)


def test_scheduler_placement_priority_and_rotation_equals_jax(tmp_path):
    from wtf_tpu.tenancy.sched import Job as JJob
    from wtf_tpu.tenancy.sched import Scheduler as JScheduler

    def table(job_cls):
        return [job_cls(name="lo", target="demo_tlv", lanes=8, runs=8,
                        seq=0),
                job_cls(name="hi", target="demo_tlv", lanes=8, runs=8,
                        priority=1, seq=1),
                job_cls(name="mid", target="demo_tlv", lanes=8, runs=8,
                        seq=2),
                job_cls(name="x", target="demo_tlv", lanes=4, runs=8,
                        priority=1, seq=3)]

    steps = [(), (("hi", "last_round", 0),), (("hi", "done", True),),
             (("lo", "last_round", 1),), (("mid", "last_round", 2),),
             (("x", "done", True),)]
    placed = {}
    for name, job_cls, sched_cls in (("port", Job, Scheduler),
                                     ("jax", JJob, JScheduler)):
        jobs = table(job_cls)
        by = {j.name: j for j in jobs}
        sched = sched_cls(jobs, n_lanes=12, workdir=tmp_path)
        seq = []
        for step in steps:
            for job, field, value in step:
                setattr(by[job], field, value)
            seq.append([j.name for j in sched._place()])
        placed[name] = seq
    assert placed["port"] == placed["jax"]
    assert placed["port"][0] == ["hi", "x"]


def test_scheduler_reuses_placement_across_rounds(tmp_path):
    from wtf_tpu_torch.telemetry import Registry

    _targets()
    registry = Registry()
    jobs = [Job(name="alice", target="demo_tlv", lanes=8, runs=16,
                seed=42, mutator="tlv", max_len=256)]
    sched = Scheduler(jobs, n_lanes=8, workdir=tmp_path / "work",
                      limit=SCHED_LIMIT, quantum=1, registry=registry,
                      backend_tuning={"device": "cpu", "fused_step": "on"})
    summary = sched.run()
    assert summary["alice"]["done"]
    assert sched.rounds == 2
    assert registry.counter("sched.builds").value == 1
    assert registry.counter("tenant.alice.checkpoints").value == 2


def _sched_jobs(inputs):
    return [dict(name="alice", target="demo_tlv", lanes=8, runs=24,
                 seed=42, mutator="tlv", max_len=256, inputs=str(inputs)),
            dict(name="bob", target="demo_kernel", lanes=8, runs=16,
                 seed=7, mutator="mangle", max_len=256)]


def test_scheduler_preemption_and_report_equals_jax(tmp_path):
    from telemetry_report import summarize

    from wtf_tpu.tenancy.sched import Job as JJob
    from wtf_tpu.tenancy.sched import Scheduler as JScheduler
    from wtf_tpu.telemetry import Registry as JRegistry
    from wtf_tpu_torch.telemetry import Registry, open_event_log

    inputs = tmp_path / "inputs"
    inputs.mkdir()
    (inputs / "seed").write_bytes(SEED_TLV)
    _targets()
    jt._targets()
    registry = Registry()
    events = open_event_log(tmp_path / "tele")
    sched = Scheduler([Job(**row) for row in _sched_jobs(inputs)],
                      n_lanes=8, workdir=tmp_path / "work",
                      limit=SCHED_LIMIT,
                      quantum=1, registry=registry, events=events,
                      backend_tuning={"device": "cpu", "fused_step": "on"})
    summary = sched.run()
    events.emit("run-end", metrics=registry.dump())
    events.close()
    jsched = JScheduler([JJob(**row) for row in _sched_jobs(inputs)],
                        n_lanes=8, workdir=tmp_path / "jwork",
                        limit=SCHED_LIMIT,
                        quantum=1, registry=JRegistry())
    assert summary == jsched.run()
    assert summary["alice"]["done"] and summary["bob"]["done"]
    assert summary["alice"]["preemptions"] >= 1
    for job in ("alice", "bob"):
        got = _ckpt(tmp_path / "work" / job / "checkpoint")
        want = _ckpt(tmp_path / "jwork" / job / "checkpoint")
        for key in ("batches", "corpus_manifest", "crash_buckets",
                    "crash_names", "stats"):
            assert got[key] == want[key], (job, key)
        for plane in ("cov", "edge"):
            assert np.array_equal(got["coverage"][plane],
                                  want["coverage"][plane]), (job, plane)
    s = summarize(tmp_path / "tele")
    ten = s["tenants"]
    assert set(ten["by_tenant"]) == {"alice", "bob"}
    assert ten["by_tenant"]["alice"]["testcases"] == 24
    assert ten["by_tenant"]["alice"]["batches"] == 3
    assert ten["sched"]["preemptions"] >= 1
    assert ten["sched"]["completions"] == 2


def _sched_lines(text: str) -> list:
    return [line for line in text.splitlines() if line.startswith("[sched]")]


def test_sched_cli_equals_jax_cli(tmp_path, capsys):
    """`sched` through both CLIs at equal seeds (8 lanes, quantum 1: alice
    and bob preempt each other; --store): the [sched] lines, the exit
    code, every job's final checkpoint, crash file names and store
    namespace."""
    from wtf_tpu.cli import main as jax_main
    from wtf_tpu.fleet.store import FleetStore as JStore
    from wtf_tpu_torch.cli import main as port_main
    from wtf_tpu_torch.fleet.store import FleetStore

    inputs = tmp_path / "inputs"
    inputs.mkdir()
    (inputs / "seed").write_bytes(SEED_TLV)
    rows = _sched_jobs(inputs)
    rows[0]["runs"], rows[1]["runs"] = 16, 16
    (tmp_path / "jobs.json").write_text(json.dumps({"jobs": rows}))
    common = ["sched", "--jobs", str(tmp_path / "jobs.json"),
              "--lanes", "8", "--quantum", "1", "--limit", str(LIMIT)]
    rc_jax = jax_main(common + ["--workdir", str(tmp_path / "jw"),
                                "--store", str(tmp_path / "js")])
    out_jax = capsys.readouterr().out
    rc_port = port_main(common + ["--workdir", str(tmp_path / "pw"),
                                  "--store", str(tmp_path / "ps"),
                                  "--device", "cpu", "--fused-step", "on",
                                  "--telemetry-dir", str(tmp_path / "t")])
    out_port = capsys.readouterr().out
    assert rc_port == rc_jax
    assert _sched_lines(out_port) == _sched_lines(out_jax)
    assert any("preempted" in line for line in _sched_lines(out_port))
    for job in ("alice", "bob"):
        got = _ckpt(tmp_path / "pw" / job / "checkpoint")
        want = _ckpt(tmp_path / "jw" / job / "checkpoint")
        for key in ("batches", "corpus_manifest", "crash_buckets",
                    "crash_names"):
            assert got[key] == want[key], (job, key)
        assert sorted(p.name for p in (tmp_path / "pw" / job / "crashes")
                      .iterdir()) == sorted(
            p.name for p in (tmp_path / "jw" / job / "crashes").iterdir())
        ns = f"tenant-{job}"
        report = FleetStore(tmp_path / "ps", namespace=ns).verify()
        jreport = JStore(tmp_path / "js", namespace=ns).verify()
        assert not (report["torn"] or report["missing"]
                    or report["orphans"])
        assert report["ok"] == jreport["ok"] == report["blobs"]
    kinds = [json.loads(line)["type"] for line in
             (tmp_path / "t" / "events.jsonl").read_text().splitlines()]
    for kind in ("sched-round", "sched-preempt", "sched-complete",
                 "tenant-resume"):
        assert kind in kinds, kind


def test_print_run_stats_names_the_tenants(capsys):
    backend, _specs = _build(TWO)
    backend.run_batch_tenants([("host", [SEED_TLV]), ("host", [SEED_KERN])])
    backend.print_run_stats()
    out = capsys.readouterr().out
    assert "[gpu] tenants: alice=4, bob=4 (lanes 8)" in out
    assert backend.registry.gauge("tenancy.tenants").value == 2


def test_tenant_context_scopes_symbols_and_breakpoints():
    backend, specs = _build(TWO)
    keys = set(backend.breakpoints)
    assert {t for t, _ in keys} == {0, 1}
    with backend.tenant_context(1):
        assert backend.symbols is specs[1].snapshot.symbols
    assert backend.symbols is specs[0].snapshot.symbols
