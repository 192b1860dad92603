"""The port's fused-step + megachunk smoke (wtf_tpu_torch/testing/
fused_smoke.py) on the CPU: K1's occupancy on demo_tlv (its plain
version here: ~1 min of the file) and the window campaign equal to the
batch-at-a-time loop; `main` returns 0 with its OK line."""

import pytest

from tests.torchport import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_fused_smoke_passes_on_the_cpu(capsys):
    from wtf_tpu_torch.testing import fused_smoke

    assert fused_smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "[fused-smoke] OK" in out
    assert any(ln.startswith("[fused-smoke] occupancy ") for ln in out)
    assert any(ln.startswith("[fused-smoke] megachunk parity held")
               for ln in out)
