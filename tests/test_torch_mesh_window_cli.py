"""The port's mesh window (wtf_tpu_torch/fuzz/megachunk.py
`make_mesh_megachunk`) through its entry points, on the CPU: the CLI
against the JAX CLI, two processes, device decode against the single
device, and the multi-tenant batch with device decode on a mesh.

  * `campaign --mesh-devices 2 --megachunk 3 --mutator devmangle
    --device cpu`, with and without `--device-decode`, against the JAX
    CLI's `--backend tpu --mesh-devices 2` at equal seeds (subprocesses,
    started together): the final count line, outputs/ and crashes/, and
    the window counters of the run-end telemetry record (the mesh
    window's sweeps and K1 launches are sums over the shards, the
    device-decode service's counts global)
  * two worker processes (gloo over the CPU, 2 shards of 4 lanes each)
    running a device-decode window campaign, and the same campaign batch
    at a time: the same fingerprints in both, equal to one process's 4
    shards (the commit's blocks, every flag of the batch and the host
    service's code windows cross the processes)
  * a `--device-decode` window campaign on 2 and 4 shards equal to the
    single-device one, the decode cache's entries in slot order included,
    with 0 cross-check mismatches
  * TenancyMeshBackend with device decode (the host service's code
    windows gathered per shard): each tenant equal to the JAX package's
    run of the same table

Every comparison is exact (tolerance 0).
"""

import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from tests import test_tenancy as jt
from tests.torchport import (
    build_port_tlv_campaign, campaign_fingerprint,
    one_torch_thread,  # noqa: F401  (module fixture)
)
from wtf_tpu_torch.utils.hashing import hex_digest

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
BUILD = dict(n_lanes=8, mutator="devmangle", limit=20_000, seed=0x5EED,
             chunk_steps=128, overlay_slots=16)
RUNS = BUILD["n_lanes"] * 3
CLI = ["campaign", "--name", "demo_tlv", "--mutator", "devmangle",
       "--megachunk", "3", "--mesh-devices", "2", "--lanes", "8", "--runs",
       "24", "--limit", "20000", "--max_len", "96", "--seed", "5"]
COUNTERS = ("megachunk.windows", "device.fused_window_rounds",
            "device.fused_window_xla_steps", "devdec.published",
            "devdec.service_rounds", "devdec.serviced_lanes",
            "devdec.parked_lanes", "devdec.zero_host_windows")


def _final_line(stdout: str) -> str:
    line = [ln for ln in stdout.splitlines() if ln.startswith("#")][-1]
    return re.sub(r" exec/s: \S+| uptime: \S+", "", line)


def _tree(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hex_digest(p.read_bytes())
            for sub in ("outputs", "crashes") if (root / sub).is_dir()
            for p in sorted((root / sub).iterdir())}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def subprocess_runs(tmp_path_factory):
    """The two CLIs (with and without --device-decode) and the two gloo
    worker processes, all started at once: {name: (rc, stdout,
    stderr, target dir)}."""
    root = tmp_path_factory.mktemp("mesh_window")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    port_env = dict(env, OMP_NUM_THREADS="1",
                    PYTHONPATH=f"{REPO}:" + os.environ.get("PYTHONPATH", ""))
    runs = {}
    for dd in ([], ["--device-decode"]):
        key = "dd" if dd else "plain"
        runs[f"jax {key}"] = ([sys.executable, "-m", "wtf_tpu"] + CLI + dd
                              + ["--backend", "tpu"], env, True)
        runs[f"port {key}"] = ([sys.executable, "-m", "wtf_tpu_torch"] + CLI
                               + dd + ["--device", "cpu"], port_env, True)
    try:
        port = _free_port()
    except OSError as e:
        port, why = None, f"gloo needs a local TCP port and none binds: {e}"
    if port is not None:
        for pid in range(2):
            runs[f"process{pid}"] = ([
                sys.executable, "-m",
                "wtf_tpu_torch.testing.multihost_worker", "--coordinator",
                f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
                str(pid), "--device", "cpu", "--shards", "2", "--lanes", "4",
                "--window", "3", "--device-decode"], port_env, False)
    procs = {}
    for name, (argv, run_env, cli) in runs.items():
        target = root / name.replace(" ", "_")
        procs[name] = (target, subprocess.Popen(
            argv + (["--target", str(target), "--telemetry-dir",
                     str(target / "telem")] if cli else []), cwd=REPO,
            env=run_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    out = {}
    try:
        for name, (target, proc) in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            out[name] = (proc.returncode, stdout, stderr, target)
    finally:
        for _, proc in procs.values():
            proc.kill()
    if port is None:
        out["skip"] = why
    return out


@pytest.mark.parametrize("key", ["plain", "dd"])
def test_cli_mesh_window_equals_jax_cli(subprocess_runs, key):
    """`campaign --mesh-devices 2 --megachunk 3` (and with
    --device-decode) prints the JAX CLI's final line and writes its
    outputs/ and crashes/."""
    got = {}
    for pkg in ("jax", "port"):
        rc, stdout, stderr, target = subprocess_runs[f"{pkg} {key}"]
        assert rc in (0, 2), stderr[-2000:]
        end = json.loads((target / "telem" / "events.jsonl").read_text()
                         .splitlines()[-1])
        got[pkg] = (rc, _final_line(stdout), _tree(target),
                    {n: end["metrics"].get(n, 0) for n in COUNTERS})
    assert got["port"] == got["jax"]
    assert got["jax"][1].startswith("#24 cov: ")
    assert got["jax"][3]["megachunk.windows"] > 0
    assert (got["jax"][3]["devdec.published"] > 0) == (key == "dd")
    assert "[gpu] mesh: 2 shards x 4 lanes/shard on cpu" in \
        subprocess_runs[f"port {key}"][1]


def test_two_process_window_is_one_mesh(subprocess_runs):
    """Two gloo processes of 2 shards each run the device-decode window
    campaign as ONE 4-shard mesh: both report the fingerprint of the
    same campaign on one process's 4 shards."""
    from wtf_tpu_torch.meshrun import LaneMesh
    from wtf_tpu_torch.testing.multihost_worker import run_mesh_window

    if "skip" in subprocess_runs:
        pytest.skip(subprocess_runs["skip"])
    reports = []
    for pid in range(2):
        rc, stdout, stderr, _ = subprocess_runs[f"process{pid}"]
        assert rc == 0, stderr[-2000:]
        reports.append(json.loads(next(
            ln for ln in stdout.splitlines() if ln.startswith("{"))))
    mesh = LaneMesh(["cpu"] * 4)
    one = run_mesh_window(mesh, 8, 3, RUNS, True)
    assert reports[0]["window"] == reports[1]["window"] == one
    assert one["counters"]["devdec.published"] > 0
    assert one["counters"]["devdec.crosscheck_mismatches"] == 0
    assert one["counters"]["device.fused_window_rounds"] > 0
    batch = run_mesh_window(mesh, 8, 0, RUNS, True)
    assert reports[0]["host_decode"] == reports[1]["host_decode"] == batch
    assert batch["code_windows"] > 0
    assert (batch["cov_edge"], batch["corpus"]) == \
        (one["cov_edge"], one["corpus"])


@pytest.fixture(scope="module")
def dd_single():
    loop = build_port_tlv_campaign(megachunk=3, device_decode=True, **BUILD)
    loop.fuzz(RUNS)
    return (campaign_fingerprint(loop),
            list(loop.backend.runner.cache.checkpoint_entries()))


@pytest.mark.parametrize("shards", [2, 4])
def test_device_decode_mesh_window_equals_single_device(dd_single, shards):
    """tests/test_devdec.py::test_device_decode_mesh_parity on the port:
    the window's service commits every shard's blocks in global lane
    order, so the table's slot order (and the coverage bits it indexes)
    equals the single-device window's."""
    loop = build_port_tlv_campaign(megachunk=3, device_decode=True,
                                   mesh_devices=shards, **BUILD)
    loop.fuzz(RUNS)
    fp, entries = dd_single
    assert campaign_fingerprint(loop) == fp
    assert list(loop.backend.runner.cache.checkpoint_entries()) == entries
    reg = loop.registry
    assert reg.counter("devdec.crosscheck_mismatches").value == 0
    assert reg.counter("devdec.published").value > 0
    assert loop.backend.runner.stats["decodes"] == 0


TENANTS = [("alice", "demo_tlv", 3), ("bob", "demo_kernel", 5)]
TENANT_MUTS = dict(jt.MUTS, alice=("devmangle", 42, jt.SEED_TLV))
TENANT_LIMIT = 20_000


def test_mesh_tenancy_with_device_decode():
    """TenancyMeshBackend over 4 shards with device decode: the host
    service fetches the missing lanes' code windows per shard (through
    each shard's image, its tenant row cut with the lanes), and each
    tenant equals the JAX package's run of the same table."""
    from tests.test_torch_tenancy import _fingerprint
    from wtf_tpu_torch.harness.targets import Targets, load_builtin_targets
    from wtf_tpu_torch.tenancy import (
        MultiTenantLoop, TenancyMeshBackend, TenantRuntime, TenantSpec,
        create_tenancy_backend,
    )

    _b, _r, want = jt._campaign(TENANTS, batches=2, muts=TENANT_MUTS,
                                limit=TENANT_LIMIT)
    load_builtin_targets()
    targets = Targets.instance()
    specs = [TenantSpec(n, targets.get(t), targets.get(t).snapshot(), q)
             for n, t, q in TENANTS]
    backend = create_tenancy_backend(specs, 8, mesh_devices=4,
                                     limit=TENANT_LIMIT, device="cpu",
                                     fused_step="on", device_decode=True)
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
    assert backend.runner.stats["decode_windows_gathered"] > 0
    assert _fingerprint(backend, runtimes) == want
