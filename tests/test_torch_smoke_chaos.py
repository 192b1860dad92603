"""The port's device-chaos smoke (wtf_tpu_torch/testing/
device_chaos_smoke.py) on the CPU: its error, megachunk and quarantine
legs — scripted device faults by dispatch index on the supervisor —
each end bit-identical to the fault-free campaign, and `main` returns 0
with its PASS line."""

import pytest

from tests.torchport import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_device_chaos_smoke_passes_on_the_cpu(capsys):
    from wtf_tpu_torch.testing import device_chaos_smoke

    assert device_chaos_smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "device-chaos-smoke PASS" in out
    for leg in ("error", "megachunk", "quarantine"):
        assert f"{leg} leg OK: " in out
