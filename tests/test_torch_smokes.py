"""The window-family smokes of the port (wtf_tpu_torch/testing:
fused_mega_smoke, decode_smoke; fused_smoke and device_chaos_smoke have
files of their own) on the CPU: each smoke's `main(["--device", "cpu"])`
returns 0 (every check held) and prints its OK line.  The campaign
builder they share is held against the JAX package's in
tests/test_torch_analysis.py."""

import pytest

from tests.torchport import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("name,ok", [
    ("fused_mega_smoke", "[fused-mega-smoke] OK"),
    ("decode_smoke", "[decode-smoke] OK"),
])
def test_smoke_passes_on_the_cpu(name, ok, capsys):
    import importlib

    smoke = importlib.import_module(f"wtf_tpu_torch.testing.{name}")
    assert smoke.main(["--device", "cpu"]) == 0
    assert ok in capsys.readouterr().out.splitlines()
