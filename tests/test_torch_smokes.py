"""The smokes of the port (wtf_tpu_torch/testing: fused_mega_smoke,
decode_smoke, triage_smoke, obs_smoke and chaos_smoke; fused_smoke and
device_chaos_smoke have files of their own) on the CPU: each smoke's
`main(["--device", "cpu"])` returns 0 (every check held) and prints its
OK line.

Each runs as `python -m wtf_tpu_torch.testing.<name> --device cpu` on one
torch thread, all five started together by the module's first test (the
file's wall is its slowest smoke, triage_smoke's minimize).  The campaign
builder they share is held against the JAX package's in
tests/test_torch_analysis.py.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SMOKES = [
    ("fused_mega_smoke", "[fused-mega-smoke] OK"),
    ("decode_smoke", "[decode-smoke] OK"),
    ("triage_smoke", "[triage-smoke] PASS"),
    ("obs_smoke", "obs smoke PASS"),
    ("chaos_smoke", "chaos-smoke PASS"),
]
# lines each smoke must print besides its OK line
PINS = {
    "triage_smoke": ["[triage-smoke] minimize: 43 -> 34 bytes "
                     "(known-minimal, same bucket)"],
    "chaos_smoke": ["resume leg OK: "],
    "obs_smoke": ["obs smoke PASS (4 nodes aggregate == serial sum"],
}


@pytest.fixture(scope="module")
def smoke_runs():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"wtf_tpu_torch.testing.{name}", "--device",
         "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, _ in SMOKES}
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def smoke_out(smoke_runs):
    """(returncode, stdout, stderr) of each smoke, as each ends."""
    done = {}

    def out(name):
        if name not in done:
            stdout, stderr = smoke_runs[name].communicate(timeout=900)
            done[name] = (smoke_runs[name].returncode, stdout, stderr)
        return done[name]

    return out


@pytest.mark.parametrize("name,ok", SMOKES)
def test_smoke_passes_on_the_cpu(name, ok, smoke_out):
    rc, stdout, stderr = smoke_out(name)
    lines = stdout.splitlines()
    assert rc == 0, (stdout + stderr)[-3000:]
    assert ok in lines or any(ln.startswith(ok) for ln in lines)


@pytest.mark.parametrize("name,pin", [(n, p) for n, pins in PINS.items()
                                      for p in pins])
def test_smoke_prints_its_pin(name, pin, smoke_out):
    rc, stdout, _ = smoke_out(name)
    assert rc == 0
    assert any(ln.startswith(pin) for ln in stdout.splitlines()), pin
