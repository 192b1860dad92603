"""The port's mesh window (wtf_tpu_torch/fuzz/megachunk.py
`make_mesh_megachunk`) against the JAX package's window campaign, on the
CPU; held against tests/test_megachunk.py's mesh parity cases.

  * a demo_tlv devmangle campaign of 3 batches of 8 lanes (limit 20000,
    16 overlay slots, seed 0x5EED: tests/test_megachunk.py's BUILD)
    through windows of 3 batches on 2 and 4 shards of the CPU, precise
    and fused quiesce: equal to the JAX package's single-device window
    campaign in the fields of tests/test_megachunk.py::_fingerprint (the
    JAX package pins its own mesh window equal to it)
  * the window counters of the 2-shard precise campaign equal the JAX
    2-device mesh window's: windows and the precise sweeps, a sum over
    the shards (each shard's quiesce runs until its own lanes are quiet)
  * K1 per shard: every call of the fused step (the plain version on the
    CPU) lands in `device.shard_fused_dispatches{i}` of its shard, and
    the window's launches sum into `device.fused_window_rounds`

Every comparison is exact (tolerance 0).
"""

import pytest

from tests.torchport import (
    build_port_tlv_campaign, one_torch_thread,  # noqa: F401
)
from wtf_tpu.analysis.trace import build_tlv_campaign
from wtf_tpu.utils.hashing import hex_digest

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BUILD = dict(n_lanes=8, mutator="devmangle", limit=20_000, seed=0x5EED,
             chunk_steps=128, overlay_slots=16)
RUNS = BUILD["n_lanes"] * 3
COUNTERS = ("megachunk.windows", "device.fused_window_rounds",
            "device.fused_window_xla_steps")


def _fingerprint(loop) -> dict:
    """tests/test_megachunk.py::_fingerprint of either package's loop."""
    import numpy as np

    cov, edge = loop.backend.coverage_state()
    return {
        "cov": np.asarray(cov).tobytes(),
        "edge": np.asarray(edge).tobytes(),
        "cov_bits": loop._coverage(),
        "corpus_order": [hex_digest(d) for d in loop.corpus],
        "crashes": sorted(loop.crash_names),
        "buckets": sorted(loop.crash_buckets),
        "testcases": loop.stats.testcases,
        "timeouts": loop.stats.timeouts,
        "new_coverage": loop.stats.new_coverage,
    }


@pytest.fixture(scope="module")
def jax_window():
    loop = build_tlv_campaign(megachunk=3, **BUILD)
    loop.fuzz(RUNS)
    fp = _fingerprint(loop)
    assert fp["testcases"] == RUNS and fp["new_coverage"] > 0
    return fp


@pytest.fixture(scope="module")
def jax_mesh_counters():
    loop = build_tlv_campaign(megachunk=3, mesh_devices=2, **BUILD)
    loop.fuzz(RUNS)
    return {n: loop.registry.counter(n).value for n in COUNTERS}


@pytest.mark.parametrize("fused", ["off", "on"])
@pytest.mark.parametrize("shards", [2, 4])
def test_mesh_window_equals_jax_window(jax_window, jax_mesh_counters,
                                       monkeypatch, shards, fused):
    from wtf_tpu_torch.interp import pstep

    calls = []
    k1 = pstep.fused_step
    monkeypatch.setattr(pstep, "fused_step",
                        lambda *a: calls.append(1) or k1(*a))
    loop = build_port_tlv_campaign(megachunk=3, mesh_devices=shards,
                                   fused_step=fused, **BUILD)
    loop.fuzz(RUNS)
    assert _fingerprint(loop) == jax_window
    reg = loop.registry
    got = {n: reg.counter(n).value for n in COUNTERS}
    per_shard = {k: c.value for k, c in reg.counter(
        "device.shard_fused_dispatches").children.items()}
    assert sum(per_shard.values()) == len(calls)
    assert got["megachunk.windows"] > 0
    if fused == "off":
        assert not calls and got["device.fused_window_rounds"] == 0
        if shards == 2:
            assert got == jax_mesh_counters
    else:
        assert sorted(per_shard) == [str(s) for s in range(shards)]
        assert 0 < got["device.fused_window_rounds"] <= len(calls)
        assert reg.counter("device.fused_window_bytes_saved").value == \
            got["device.fused_window_rounds"] \
            * loop.backend._fused_alias_bytes()
