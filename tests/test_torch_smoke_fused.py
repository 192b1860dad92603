"""The port's fused-step + megachunk smoke (wtf_tpu_torch/testing/
fused_smoke.py) on the CPU: K1's occupancy on demo_tlv (its plain
version here: ~1 min) and the window campaign equal to the
batch-at-a-time loop; `main` returns 0 with its OK line.  The test runs
the occupancy leg and the megachunk leg's two campaigns in three spawned
processes at once and hands their results to `main`, which makes the
same checks as when it runs them itself: the file is handed out last
(one test), so its wall is the suite's tail."""

import pytest

from tests.torchport import (  # noqa: F401
    one_torch_thread, spawned_pool, submit_now,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_fused_smoke_passes_on_the_cpu(capsys, monkeypatch):
    from wtf_tpu_torch.testing import fused_smoke

    with spawned_pool(3) as pool:
        occupancy = submit_now(pool, fused_smoke._occupancy_leg, "cpu")
        prints = {m: submit_now(pool, fused_smoke.window_fingerprint, "cpu",
                                4 * 8, megachunk=m) for m in (0, 3)}

        def occupancy_leg(device):
            assert device == "cpu"
            print(occupancy.result())

        def window_fingerprint(device, runs, megachunk):
            assert (device, runs) == ("cpu", 4 * 8)
            return prints[megachunk].result()

        monkeypatch.setattr(fused_smoke, "_occupancy_leg", occupancy_leg)
        monkeypatch.setattr(fused_smoke, "window_fingerprint",
                            window_fingerprint)
        assert fused_smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "[fused-smoke] OK" in out
    assert any(ln.startswith("[fused-smoke] occupancy ") for ln in out)
    assert any(ln.startswith("[fused-smoke] megachunk parity held")
               for ln in out)
