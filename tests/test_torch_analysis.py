"""The package's builders (wtf_tpu_torch/analysis/trace.py) against the
JAX package's (wtf_tpu/analysis/trace.py), on the CPU.

  * build_tlv_campaign at the window smokes' own settings (demo_tlv
    devmangle, 4 lanes, limit 10000, windows of 3 batches, 8 batches,
    seed 0x5EED): coverage and edge bytes, corpus digests in order,
    crashes and counts equal the JAX builder's campaign
  * build_tlv_runner + timed_chunk (2 lanes, chunks of 16 steps): the
    same instructions retired, every machine plane equal after the two
    chunks
  * build_tenant_runner: the same lane-to-tenant placement and initial
    planes

Every comparison is exact (tolerance 0).
"""

import pytest

from tests.torchport import (
    assert_machines_equal, campaign_fingerprint,
    one_torch_thread,  # noqa: F401  (module fixture)
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMOKE = dict(mutator="devmangle", seed=0x5EED, n_lanes=4, limit=10_000,
             chunk_steps=128, overlay_slots=16, megachunk=3)
RUNNER = dict(n_lanes=2, chunk_steps=16, payload=b"\x01\x08AAAAAAAA" * 4)


def test_build_tlv_campaign_equals_jax():
    from wtf_tpu.analysis.trace import build_tlv_campaign as jax_build
    from wtf_tpu_torch.analysis.trace import build_tlv_campaign

    jax = jax_build(**SMOKE)
    port = build_tlv_campaign(device="cpu", **SMOKE)
    for loop in (jax, port):
        loop.fuzz(4 * 8)
    assert campaign_fingerprint(port) == campaign_fingerprint(jax)
    assert port.stats.testcases == 32
    assert port.registry is port.backend.registry


def test_timed_chunk_equals_jax():
    from wtf_tpu.analysis import trace as jt
    from wtf_tpu_torch.analysis import trace as pt

    jr = jt.build_tlv_runner(**RUNNER)
    want = jt.timed_chunk(jr)
    pr = pt.build_tlv_runner(device="cpu", **RUNNER)
    got = pt.timed_chunk(pr)
    assert got["instr"] == want["instr"] > 0
    assert got["cold_wall_s"] > 0 and got["warm_wall_s"] > 0
    assert_machines_equal(jr.machine, pr.machine, where="after two chunks")


def test_build_tenant_runner_equals_jax():
    from wtf_tpu.analysis.trace import build_tenant_runner as jax_build
    from wtf_tpu_torch.analysis.trace import build_tenant_runner

    jr, pr = jax_build(), build_tenant_runner(device="cpu")
    assert pr.tenant_of_lane.tolist() == jr.tenant_of_lane.tolist() \
        == [0, 0, 1, 1]
    assert_machines_equal(jr.machine, pr.machine, where="at build")
