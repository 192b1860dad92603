"""The lint's op census (wtf_tpu_torch/analysis/rules.py, `budget` family)
and mesh gathers against the checked-in pins.

  * the census of the four steady-state programs equals the port's
    analysis/budgets.json, exactly (total, top ops, K1 launches, host
    reads; the host reads also under `host_transfer`), and the mesh
    chunk's cross-shard gathers equal `mesh_chunk` (one: the JAX pin's
    one coverage all-reduce);
  * it is deterministic: two census runs at once, in two processes, give
    the same counts;
  * K1 counts once per fused round: the window program's K1 ops equal
    the rounds the backend's own counters saw, and none of the plain
    version's ops leak into the count.

Each census runs in a child process on one torch thread (the counts do
not depend on threads); the two are started together.
"""

import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

from tests.torchport import one_torch_thread  # noqa: F401
from wtf_tpu_torch.analysis import rules as R
from wtf_tpu_torch.analysis.contracts import TRANSFER_ENTRY

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JAX_BUDGETS = (Path(__file__).resolve().parents[1] / "wtf_tpu" / "analysis"
               / "budgets.json")


@pytest.fixture(scope="module")
def censuses():
    with ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(R.census_subprocess) for _ in range(2)]
        return [r.result() for r in runs]


@pytest.mark.parametrize("name", R.CENSUS_PROGRAMS)
def test_census_equals_the_checked_in_budget(censuses, name):
    budget = R.load_budgets()[name]
    pinned = R.pinned_counts(censuses[0][name])
    assert pinned == budget
    assert R.check_budget(pinned, budget, entry=name) == []


def test_host_reads_equal_the_transfer_pin(censuses):
    census = censuses[0]
    assert list(census) == list(R.CENSUS_PROGRAMS)
    reads = {name: census[name]["host_reads"] for name in R.CENSUS_PROGRAMS}
    reads["total"] = sum(reads.values())
    assert reads == {k: v for k, v in R.load_budgets()[TRANSFER_ENTRY].items()
                     if k != "entry"}


@pytest.mark.parametrize("name", R.CENSUS_PROGRAMS)
def test_census_is_deterministic(censuses, name):
    assert censuses[0][name] == censuses[1][name]


def test_mesh_chunk_gathers_equal_the_pin():
    counts = R.measure_mesh_chunk()
    pin = R.load_budgets()[R.MESH_ENTRY]
    assert counts == {k: v for k, v in pin.items() if k != "entry"}
    # the JAX package's pin of the same mesh chunk: its one all-reduce
    jax_pin = json.loads(JAX_BUDGETS.read_text())[R.MESH_ENTRY]
    assert counts["total"] == jax_pin["all-reduce"] == jax_pin["total"]


def test_k1_counts_once_per_fused_round():
    from wtf_tpu_torch.analysis.trace import build_tlv_campaign
    from wtf_tpu_torch.telemetry.spans import CALLS

    cfg = R.MEGA_CONFIG
    loop = build_tlv_campaign(n_lanes=cfg["n_lanes"], mutator="devmangle",
                              limit=cfg["limit"], seed=cfg["seed"],
                              megachunk=cfg["max_batches"],
                              fused_step="on", device="cpu")
    loop.fuzz(cfg["n_lanes"] * cfg["max_batches"])
    reg = loop.backend.registry

    def rounds():
        # every K1 round, in a window or a host-finished batch, runs
        # inside one `fused-step` span (one shard here)
        calls = reg.counter(CALLS).dump()
        return (sum(v for path, v in calls.items()
                    if path.endswith("fused-step")),
                reg.counter("device.fused_window_rounds").value)

    before = rounds()
    n = cfg["max_batches"]
    census = R.op_census(lambda: loop.backend.run_megachunk(
        loop.mutator, loop.target, n, n))
    spans, in_windows = (a - b for a, b in zip(rounds(), before))
    assert census["fused_step"] == spans > 0
    assert 0 < in_windows <= spans
    pinned = R.load_budgets()[R.MEGA_ENTRY]
    assert census["fused_step"] == pinned["fused_step"]
    assert census["total"] == pinned["total"]
