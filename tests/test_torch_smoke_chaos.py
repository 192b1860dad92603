"""The port's device-chaos smoke (wtf_tpu_torch/testing/
device_chaos_smoke.py) on the CPU: its error, megachunk and quarantine
legs — scripted device faults by dispatch index on the supervisor —
each end bit-identical to the fault-free campaign, and `main` returns 0
with its PASS line.  The test runs the quarantine leg in a spawned
process while `main` runs the other two, and hands `main` its result:
the file is handed out last (one test)."""

import pytest

from tests.torchport import (  # noqa: F401
    one_torch_thread, spawned_pool, submit_now,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_device_chaos_smoke_passes_on_the_cpu(capsys, monkeypatch):
    from wtf_tpu_torch.testing import device_chaos_smoke

    with spawned_pool(1) as pool:
        quarantine = submit_now(pool, device_chaos_smoke._quarantine_leg,
                                device_chaos_smoke.SEED, "cpu")

        def quarantine_leg(seed, device):
            assert (seed, device) == (device_chaos_smoke.SEED, "cpu")
            return quarantine.result()

        monkeypatch.setattr(device_chaos_smoke, "_quarantine_leg",
                            quarantine_leg)
        assert device_chaos_smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "device-chaos-smoke PASS" in out
    for leg in ("error", "megachunk", "quarantine"):
        assert f"{leg} leg OK: " in out
