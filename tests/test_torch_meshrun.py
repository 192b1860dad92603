"""The port's lane mesh (wtf_tpu_torch/meshrun) against the JAX package's
(wtf_tpu/meshrun), on the CPU; held against tests/test_meshrun.py and
tests/test_parallel.py.

The JAX side runs on the conftest's 8 virtual CPU devices, the port on a
LaneMesh of 8 shards of `cpu` (its counterpart: every shard on one
device), at the reference tests' sizes (16 lanes, test_meshrun's runner
geometry):

  * one mesh chunk: every machine plane and the merged cov/edge bitmaps
    equal the JAX mesh chunk's
  * MeshRunner.run (decode misses and breakpoints serviced on the host):
    statuses, every plane and the merged view equal the JAX MeshRunner's;
    per-shard counters sum to the merged `device.*` view
  * the mesh merge on seeded random bitmaps, several lane orders and
    include masks, 1/2/4/8 shards: equal to the JAX single-device merge
  * a devmangle campaign on the mesh: equal to the JAX mesh campaign and
    to the port's single-device one (coverage, crashes, corpus, the
    devmut byte stream); `campaign --mesh-devices 8` CLI against the JAX
    CLI in subprocesses
  * two worker processes (gloo over the CPU, 4 shards each): the same
    merged-coverage digest in both, equal to the JAX mesh chunk's, and
    the mesh merge across the processes equal to the JAX merge_coverage;
    `campaign --coordinator` in two processes (2 shards each) is one
    mesh whose campaign equals the JAX CLI's
  * the flags: --mesh-devices plumbs to MeshBackend; indivisible lanes
    and more cuda shards than cards are refused (the mesh window and
    device decode on a mesh: tests/test_torch_mesh_window*.py)

Every comparison is exact (integer state: tolerance 0).  The port's
precise step costs the same per shard at any lane count, so a mesh of 8
shards runs its CPU cases ~6x slower than one device: the cases stay at
the reference sizes and low limits.
"""

import contextlib
import io
import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torchport import (
    assert_machines_equal, build_port_tlv_campaign, campaign_fingerprint,
    one_torch_thread,  # noqa: F401  (module fixture)
)
from wtf_tpu_torch.core.results import StatusCode
from wtf_tpu_torch.meshrun import LaneMesh
from wtf_tpu_torch.testing.multihost_worker import (
    PAYLOAD, RUNNER, run_mesh_chunk, run_mesh_rows, seed_runner,
)
from wtf_tpu_torch.utils.hashing import hex_digest

REPO = Path(__file__).resolve().parent.parent
N_DEVICES = 8
N_LANES = 16
LIMIT = 500
SMALL = dict(overlay_slots=16, **RUNNER)   # tests/test_meshrun.py's SMALL
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _stop_handler(runner, view, lane):
    view.set_status(lane, StatusCode.OK)


def _cpu_mesh(n=N_DEVICES) -> LaneMesh:
    return LaneMesh(["cpu"] * n)


@pytest.fixture(scope="module")
def jax_mesh():
    import jax

    from wtf_tpu.meshrun import make_mesh

    assert len(jax.devices()) >= N_DEVICES, "conftest should provision 8"
    return make_mesh(N_DEVICES)


def _jax_runner(cls=None, **extra):
    """tests/test_meshrun.py's `_runner`: 16 lanes, the decode cache
    warmed from the payload, lane i running its first 4 + (i % 3) * 5
    bytes."""
    from wtf_tpu.harness import demo_tlv
    from wtf_tpu.interp.runner import Runner, warm_decode_cache

    runner = (cls or Runner)(demo_tlv.build_snapshot(), n_lanes=N_LANES,
                             **SMALL, **extra)
    warm_decode_cache(runner, demo_tlv.TARGET, PAYLOAD, limit=4096)
    view = runner.view()
    for lane in range(N_LANES):
        data = PAYLOAD[:4 + (lane % 3) * 5]
        view.virt_write(lane, demo_tlv.INPUT_GVA, data)
        view.r["gpr"][lane, 2] = np.uint64(len(data))
    runner.push(view)
    return runner


def _port_runner(cls=None, **extra):
    from wtf_tpu_torch.harness import demo_tlv
    from wtf_tpu_torch.interp.runner import Runner

    runner = (cls or Runner)(demo_tlv.build_snapshot(), n_lanes=N_LANES,
                             device="cpu", **SMALL, **extra)
    seed_runner(runner)
    return runner


@pytest.fixture(scope="module")
def jax_chunk(jax_mesh):
    """The JAX mesh chunk of 8 steps: (machine, merged cov, merged
    edge)."""
    import jax.numpy as jnp

    from wtf_tpu.meshrun import make_mesh_chunk, replicate, shard_machine

    r = _jax_runner()
    machine, cov, edge = make_mesh_chunk(8, jax_mesh, donate=False)(
        replicate(r.cache.device(), jax_mesh),
        replicate(r.physmem.image, jax_mesh),
        shard_machine(r.machine, jax_mesh), jnp.uint64(LIMIT))
    return machine, np.asarray(cov), np.asarray(edge)


def _digest(cov: np.ndarray) -> str:
    """tests/multihost_worker.py's coverage digest."""
    cov = cov.astype(np.uint64)
    return hex(int(np.bitwise_xor.reduce(
        cov * np.arange(1, len(cov) + 1, dtype=np.uint64))))


# ---------------------------------------------------------------------------
# the executors and the runner
# ---------------------------------------------------------------------------

def test_mesh_chunk_bit_parity_and_merged_bitmaps(jax_chunk):
    """The port's mesh chunk on 8 CPU shards == the JAX mesh chunk on 8
    virtual devices: every plane, and the merged cov/edge bitmaps (also
    the host union of the lane planes)."""
    from wtf_tpu_torch.meshrun import (
        MeshMachine, make_mesh_chunk, merged_coverage, replicate,
        shard_image, shard_machine,
    )

    jm, jcov, jedge = jax_chunk
    mesh = _cpu_mesh()
    r = _port_runner()
    shards = shard_machine(r.machine, mesh)
    _, cov, edge = make_mesh_chunk(8, mesh)(
        replicate(r.cache.device("cpu"), mesh), shard_image(r.image, mesh),
        shards, LIMIT)
    machine = MeshMachine(shards, mesh)
    assert_machines_equal(jm, machine, where="chunk")
    assert cov.numpy().view(np.uint32).tobytes() == jcov.tobytes()
    assert edge.numpy().view(np.uint32).tobytes() == jedge.tobytes()
    assert [t.numpy().tobytes() for t in merged_coverage(machine)] == \
        [cov.numpy().tobytes(), edge.numpy().tobytes()]
    union = np.bitwise_or.reduce(np.asarray(jm.cov), axis=0)
    assert union.tobytes() == jcov.tobytes() and union.sum() > 0


def test_mesh_runner_full_run_parity(jax_mesh):
    """MeshRunner.run (host decode and breakpoint services) on 8 shards
    == the JAX MeshRunner on 8 devices: statuses and every plane; the
    per-shard counters sum to the merged view, and the merged bitmaps of
    the last chunk equal the union of the lane planes."""
    from wtf_tpu.harness import demo_tlv as jtlv
    from wtf_tpu.meshrun import MeshRunner as JMeshRunner
    from wtf_tpu_torch.harness import demo_tlv
    from wtf_tpu_torch.meshrun import MeshRunner

    jr = _jax_runner(cls=JMeshRunner, mesh=jax_mesh)
    jr.cache.set_breakpoint(jtlv.FINISH_GVA)
    want = jr.run(bp_handler=_stop_handler)

    r = _port_runner(cls=MeshRunner, mesh=_cpu_mesh())
    r.cache.set_breakpoint(demo_tlv.FINISH_GVA)
    got = r.run(bp_handler=_stop_handler)
    assert got.tolist() == np.asarray(want).tolist()
    assert_machines_equal(jr.machine, r.machine, where="full run")

    ctr = r.fold_device_counters()
    dump = r.registry.counter("device.shard_instructions").dump()
    assert len(dump) == N_DEVICES
    assert sum(dump.values()) == int(ctr[:, 0].sum(dtype=np.uint64)) \
        == r.registry.counter("device.instructions").value > 0
    jr.fold_device_counters()
    assert dump == jr.registry.counter("device.shard_instructions").dump()
    cov, edge = r.merged_coverage()
    assert cov.tobytes() == np.bitwise_or.reduce(
        r.machine.cov.numpy(), axis=0).tobytes()
    assert edge.tobytes() == np.bitwise_or.reduce(
        r.machine.edge.numpy(), axis=0).tobytes()
    assert cov.view(np.uint32).tobytes() == jr.merged_coverage()[0].tobytes()


def test_mesh_merge_matches_single_device():
    """make_mesh_merge (1/2/4/8 shards) == the JAX merge_coverage on
    seeded random bitmaps with a nonzero aggregate, duplicate rows (the
    prefix credit must discriminate) and masked lanes, in several lane
    orders: union, per-lane credit and new words."""
    import jax.numpy as jnp

    from wtf_tpu.meshrun.reduce import merge_coverage as jmerge
    from wtf_tpu_torch.meshrun.mesh import split_lanes
    from wtf_tpu_torch.meshrun.reduce import make_mesh_merge

    rng = np.random.default_rng(0xC07)
    t = lambda a: torch.from_numpy(a.view(np.int32).copy())  # noqa: E731
    for case in range(4):
        cov = rng.integers(0, 1 << 32, (N_LANES, 24), dtype=np.uint32)
        edge = rng.integers(0, 1 << 32, (N_LANES, 40), dtype=np.uint32)
        cov &= rng.integers(0, 1 << 32, cov.shape, dtype=np.uint32)
        cov[3], edge[3] = cov[1], edge[1]
        cov[11], edge[11] = cov[6], edge[6]   # a duplicate across shards
        order = rng.permutation(N_LANES) if case else np.arange(N_LANES)
        cov, edge = cov[order], edge[order]
        agg_cov = cov[5] & rng.integers(0, 1 << 32, 24, dtype=np.uint32)
        agg_edge = (np.zeros(40, np.uint32) if case % 2 else
                    edge[2] & rng.integers(0, 1 << 32, 40, dtype=np.uint32))
        include = rng.random(N_LANES) > 0.2
        include[[2, 9]] = False
        want = [np.asarray(x) for x in jmerge(
            jnp.asarray(agg_cov), jnp.asarray(agg_edge), jnp.asarray(cov),
            jnp.asarray(edge), jnp.asarray(include))]
        assert want[2].any() and not want[2].all()
        for shards in (1, 2, 4, 8):
            mesh = _cpu_mesh(shards)
            got = make_mesh_merge(mesh)(
                t(agg_cov), t(agg_edge), split_lanes(t(cov), mesh),
                split_lanes(t(edge), mesh),
                split_lanes(torch.from_numpy(include), mesh))
            assert got[0].numpy().view(np.uint32).tobytes() \
                == want[0].tobytes(), (case, shards)
            assert got[1].numpy().view(np.uint32).tobytes() \
                == want[1].tobytes(), (case, shards)
            assert torch.cat(got[2]).numpy().tolist() == want[2].tolist(), \
                (case, shards)
            assert got[3].numpy().view(np.uint32).tobytes() \
                == want[3].tobytes(), (case, shards)


# ---------------------------------------------------------------------------
# the campaign and its CLI
# ---------------------------------------------------------------------------

CAMPAIGN = dict(n_lanes=8, mutator="devmangle", limit=20_000, seed=0x5EED,
                chunk_steps=128, overlay_slots=16)


def test_mesh_campaign_devmangle_parity():
    """tests/test_meshrun.py's acceptance campaign: the port on 8 shards
    == the JAX package on 8 devices == the port on one device, over two
    devmangle batches — merged coverage, crashes, corpus, the last
    batch's device-generated bytes; the mesh gauges and per-shard
    counters."""
    from wtf_tpu.analysis.trace import build_tlv_campaign

    j = build_tlv_campaign(mesh_devices=N_DEVICES, **CAMPAIGN)
    a = build_port_tlv_campaign(**CAMPAIGN)
    b = build_port_tlv_campaign(mesh_devices=N_DEVICES, **CAMPAIGN)
    for loop in (j, a, b):
        for _ in range(2):
            loop.run_one_batch()
    want = campaign_fingerprint(j)
    assert want["testcases"] == 16 and want["new_coverage"] > 0
    assert campaign_fingerprint(a) == want
    assert campaign_fingerprint(b) == want
    ww, wl = j.mutator.current_batch()
    for loop in (a, b):
        w, n = loop.mutator.current_batch()
        assert w.numpy().view(np.uint32).tobytes() == \
            np.asarray(ww).tobytes()
        assert n.numpy().tolist() == np.asarray(wl).tolist()
        assert loop.mutator.fetch(range(8)) == j.mutator.fetch(range(8))
    reg = b.registry
    assert reg.gauge("mesh.devices").value == N_DEVICES
    assert reg.gauge("mesh.lanes_per_shard").value == 1
    by_shard = reg.counter("device.shard_instructions").dump()
    assert sum(by_shard.values()) == reg.counter(
        "device.instructions").value == j.registry.counter(
        "device.instructions").value > 0
    assert by_shard == j.registry.counter(
        "device.shard_instructions").dump()


def _final_line(stdout: str) -> str:
    line = [ln for ln in stdout.splitlines() if ln.startswith("#")][-1]
    return re.sub(r" exec/s: \S+| uptime: \S+", "", line)


def _tree(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hex_digest(p.read_bytes())
            for sub in ("outputs", "crashes") if (root / sub).is_dir()
            for p in sorted((root / sub).iterdir())}


CLI_CAMPAIGN = ["campaign", "--name", "demo_tlv", "--mutator", "devmangle",
                "--lanes", "8", "--runs", "8", "--limit", "20000",
                "--max_len", "96", "--seed", "5"]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """CLI_CAMPAIGN in subprocesses, all at once: the JAX CLI on 8
    devices, the port's on 8 CPU shards, and the port's in two processes
    joined over gloo (`--coordinator`, 2 CPU shards each).  {name:
    (rc, final line, outputs/ and crashes/ digests, stdout)}."""
    root = tmp_path_factory.mktemp("cli")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    port_env = dict(env, OMP_NUM_THREADS="1")
    torch_cli = [sys.executable, "-m", "wtf_tpu_torch"] + CLI_CAMPAIGN + [
        "--device", "cpu"]
    runs = {"wtf_tpu": ([sys.executable, "-m", "wtf_tpu"] + CLI_CAMPAIGN
                        + ["--backend", "tpu", "--mesh-devices", "8"], env),
            "wtf_tpu_torch": (torch_cli + ["--mesh-devices", "8"],
                              port_env)}
    try:
        port = _free_port()
    except OSError as e:
        port = None
        why = f"gloo needs a local TCP port and none binds: {e}"
    if port is not None:
        for pid in range(2):
            runs[f"process{pid}"] = (torch_cli + [
                "--mesh-devices", "2", "--coordinator",
                f"127.0.0.1:{port}", "--num-processes", "2",
                "--process-id", str(pid)], port_env)
    procs = {name: subprocess.Popen(
        argv + ["--target", str(root / name)], cwd=REPO, env=run_env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, (argv, run_env) in runs.items()}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode in (0, 2), (name, stderr[-2000:])
            out[name] = (proc.returncode, _final_line(stdout),
                         _tree(root / name), stdout)
    finally:
        for proc in procs.values():
            proc.kill()
    if port is None:
        out["skip"] = why
    return out


def test_cli_mesh_campaign_equals_jax_cli(cli_runs):
    """`campaign --mesh-devices 8` CLI against CLI at equal seeds (both in
    subprocesses): the final count line and outputs/ and crashes/, and
    the port's mesh line."""
    port, jax = cli_runs["wtf_tpu_torch"], cli_runs["wtf_tpu"]
    assert "[gpu] mesh: 8 shards x 1 lanes/shard on cpu\n" in port[3]
    assert port[:3] == jax[:3]
    assert jax[1].startswith("#8 cov: ")


def test_two_process_campaign_is_one_mesh(cli_runs):
    """`campaign --coordinator --num-processes 2 --process-id i
    --mesh-devices 2` in two processes: one mesh of 4 shards over the
    global 8-lane batch (the exclusive prefix credit, the devmut stream
    and the host seams across the processes), each process's campaign
    equal to the JAX CLI's on 8 devices."""
    if "skip" in cli_runs:
        pytest.skip(cli_runs["skip"])
    for pid in range(2):
        got = cli_runs[f"process{pid}"]
        assert "[gpu] mesh: 4 shards x 2 lanes/shard on cpu, 2 processes" \
            in got[3]
        assert got[:3] == cli_runs["wtf_tpu"][:3], pid


# ---------------------------------------------------------------------------
# two processes
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_mesh(jax_chunk):
    """tests/test_parallel.py::test_two_process_distributed_mesh's
    contract on the port: two worker processes (gloo on the CPU, 4 shards
    of 8 lanes each) run one mesh chunk; both report 8 devices and the
    same merged-coverage digest and instruction count — equal to a
    one-process 8-shard run and to the JAX mesh chunk's merged bitmap.
    Then the mesh batch merge across the two processes on seeded
    bitmaps: in both, equal to the JAX merge_coverage of the whole
    batch; and a MeshRunner over both: every lane's input, pushed to its
    owner, reads back through a HostView in each process."""
    import jax.numpy as jnp

    from wtf_tpu.meshrun.reduce import merge_coverage as jmerge
    from wtf_tpu_torch.testing.multihost_worker import merge_case

    try:
        port = _free_port()
    except OSError as e:
        pytest.skip(f"gloo needs a local TCP port and none binds: {e}")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=f"{REPO}:" + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "wtf_tpu_torch.testing.multihost_worker",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(pid), "--device", "cpu", "--shards", "4",
         "--lanes", "8", "--limit", str(LIMIT), "--merge-seed", "7",
         "--rows"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=240) + (p.returncode,))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for out, err, rc in outs:
        assert rc == 0, err[-2000:]
    reports = [json.loads(next(ln for ln in out.splitlines()
                               if ln.startswith("{")))
               for out, _, _ in outs]
    assert reports[0]["devices"] == reports[1]["devices"] == 8
    assert reports[0]["lanes"] == N_LANES
    assert reports[0]["min_lane_icount"] > 0
    assert reports[0]["cov_words_set"] > 0
    assert reports[0]["cov_digest"] == reports[1]["cov_digest"]
    assert reports[0]["instructions"] == reports[1]["instructions"]
    one = run_mesh_chunk(_cpu_mesh(), N_LANES, limit=LIMIT)
    rows = run_mesh_rows(_cpu_mesh(), N_LANES)
    assert rows["rows_ok"]
    for r in reports:
        assert (r["rows_ok"], r["rows_digest"]) == \
            (True, rows["rows_digest"])
    assert (one["cov_digest"], one["instructions"]) == \
        (reports[0]["cov_digest"], reports[0]["instructions"])
    jm, jcov, _ = jax_chunk
    assert one["cov_digest"] == _digest(jcov)
    assert one["instructions"] == int(np.asarray(jm.icount).sum())
    want = [np.asarray(x) for x in jmerge(
        *(jnp.asarray(a) for a in merge_case(7, N_LANES)))]
    assert want[2].any() and not want[2].all()
    for r in reports:
        assert r["merge"] == {"agg_cov": want[0].tobytes().hex(),
                              "agg_edge": want[1].tobytes().hex(),
                              "new_lane": want[2].astype(int).tolist(),
                              "new_words": want[3].tobytes().hex()}


# ---------------------------------------------------------------------------
# the flags, and what a mesh refuses
# ---------------------------------------------------------------------------

def test_cli_mesh_flag_plumbs_to_backend():
    """--mesh-devices parses on campaign/fuzz/sched/triage/fleet reshard,
    flows through the tuning kwargs, and create_backend routes it to
    MeshBackend (0 = every visible device); the oracle backend ignores
    it."""
    from wtf_tpu_torch.backend import create_backend
    from wtf_tpu_torch.cli import _tuning_kwargs, build_parser
    from wtf_tpu_torch.harness import demo_tlv
    from wtf_tpu_torch.meshrun.backend import MeshBackend

    parser = build_parser()
    for argv in (["campaign", "--name", "demo_tlv"],
                 ["fuzz", "--name", "demo_tlv"],
                 ["sched", "--jobs", "j.json", "--workdir", "w"],
                 ["triage", "minimize", "--name", "demo_tlv", "--input",
                  "x"],
                 ["triage", "distill", "--name", "demo_tlv"],
                 ["triage", "vbreak", "--name", "demo_tlv", "--input", "x",
                  "--break-at", "0x10"],
                 ["fleet", "reshard", "--name", "demo_tlv", "--checkpoint",
                  "c", "--runs", "8"]):
        args = parser.parse_args(argv + ["--mesh-devices", "8"])
        assert _tuning_kwargs(args)["mesh_devices"] == 8, argv
        assert "mesh_devices" not in _tuning_kwargs(parser.parse_args(argv))
    args = parser.parse_args(["campaign", "--name", "demo_tlv",
                              "--coordinator", "127.0.0.1:1",
                              "--num-processes", "2", "--process-id", "1"])
    assert (args.coordinator, args.num_processes, args.process_id) == \
        ("127.0.0.1:1", 2, 1)
    with pytest.raises(SystemExit):
        parser.parse_args(["run", "--name", "demo_tlv", "--input", "x",
                           "--mesh-devices", "2"])

    backend = create_backend("gpu", demo_tlv.build_snapshot(), n_lanes=8,
                             mesh_devices=0, device="cpu")
    assert isinstance(backend, MeshBackend)
    backend.initialize()
    assert backend.mesh.size == 1
    emu = create_backend("emu", demo_tlv.build_snapshot(), mesh_devices=8,
                         n_lanes=8, device="cpu")
    assert not isinstance(emu, MeshBackend)


def test_mesh_backend_rejects_indivisible_lanes():
    from wtf_tpu_torch.backend import create_backend
    from wtf_tpu_torch.harness import demo_tlv

    backend = create_backend("gpu", demo_tlv.build_snapshot(), n_lanes=6,
                             mesh_devices=4, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        backend.initialize()


def _port_cli(argv):
    from wtf_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        return cli.main(argv), out.getvalue()


def test_cuda_mesh_wider_than_the_cards_raises(monkeypatch):
    """On cuda the mesh takes the first N cards; more shards than cards
    raise (the JAX message: "sees only"), in make_mesh and through the
    CLI; without a card at all, cuda raises as every entry point does."""
    from wtf_tpu_torch.meshrun import make_mesh

    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh(2, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="mesh wants 2 devices but torch "
                                         "sees only 1"):
        make_mesh(2, "cuda")
    assert make_mesh(1, "cuda").devices == (torch.device("cuda", 0),)
    with pytest.raises(SystemExit, match="sees only 1"):
        _port_cli(["campaign", "--name", "demo_tlv", "--lanes", "8",
                   "--runs", "8", "--mesh-devices", "2"])
