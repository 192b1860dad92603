"""The port's telemetry report (`python -m wtf_tpu_torch.telemetry.report`)
against tools/telemetry_report.py at equal seeds.

A small master + `fuzz --mux` round (4 lanes, 24 runs) and a `triage
minimize` run through each package's CLI with `--telemetry-dir`, every
process started together; each report reads its own package's dirs.  The
fleet, triage and tenants sections must be equal, the fields that follow
the clock aside, and the port's report prints them.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from wtf_tpu_torch.telemetry import report as port_report

REPO = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, JAX_PLATFORMS="cpu")
MASTER = ["master", "--name", "demo_tlv", "--runs", "24", "--seed", "5",
          "--max_len", "64"]
NODE = ["fuzz", "--name", "demo_tlv", "--lanes", "4", "--mux", "--limit",
        "20000", "--seed", "5"]
# the triage smoke's known-minimal reproducer (one round of bisection)
MINIMAL = bytes([3, 32]) + bytes(24) + b"\x41" * 8
# the triage smoke's lanes (the JAX executable other tests compile too)
TRIAGE = ["triage", "minimize", "--name", "demo_tlv", "--lanes", "16",
          "--limit", "20000"]
FLAGS = {"wtf_tpu_torch": ["--device", "cpu"], "wtf_tpu": ["--backend", "tpu"]}
SECTIONS = ("fleet", "triage", "tenants")
# fields that follow the clock: a rate, and the master's interval writes
# of coverage.cov (one per `stats_every` seconds while the aggregate
# changed, so a slower node gives its master more of them)
CLOCKED = ("candidates_per_s", "coverage_writes")


def _jax_report():
    spec = importlib.util.spec_from_file_location(
        "telemetry_report", REPO / "tools" / "telemetry_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _popen(pkg, argv):
    env = dict(ENV, OMP_NUM_THREADS="1") if pkg == "wtf_tpu_torch" else ENV
    return subprocess.Popen([sys.executable, "-m", pkg] + argv, cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("report")
    procs = []
    for pkg in FLAGS:
        root = base / pkg
        (root / "t" / "inputs").mkdir(parents=True)
        (root / "t" / "inputs" / "seed").write_bytes(
            b"\x01\x04AAAA\x02\x08BBBBBBBB")
        (root / "crash.bin").write_bytes(MINIMAL)
        addr = f"unix://{root}/m.sock"
        master = _popen(pkg, MASTER + [
            "--target", str(root / "t"), "--address", addr,
            "--telemetry-dir", str(root / "master")])
        procs.append(master)
        procs.append(_popen(pkg, TRIAGE + FLAGS[pkg] + [
            "--input", str(root / "crash.bin"),
            "--telemetry-dir", str(root / "triage")]))
        deadline = time.monotonic() + 120
        while not (root / "m.sock").exists():
            assert master.poll() is None and time.monotonic() < deadline, \
                master.communicate()[1][-2000:]
            time.sleep(0.05)
        node_flags = FLAGS[pkg] + (["--fused-step", "on"]
                                   if pkg == "wtf_tpu_torch" else [])
        procs.append(_popen(pkg, NODE + node_flags + [
            "--address", addr, "--telemetry-dir", str(root / "node")]))
    for proc in procs:
        _, stderr = proc.communicate(timeout=600)
        assert proc.returncode in (0, 2), stderr[-2000:]
    return base


def _sections(summarize, root: Path) -> dict:
    out = {}
    for run in ("master", "node", "triage"):
        s = summarize(root / run)
        out[run] = {k: ({f: v for f, v in s[k].items() if f not in CLOCKED}
                        if isinstance(s[k], dict) else s[k])
                    for k in SECTIONS}
    return out


@pytest.fixture(scope="module")
def sections(dirs):
    return {"port": _sections(port_report.summarize, dirs / "wtf_tpu_torch"),
            "jax": _sections(_jax_report().summarize, dirs / "wtf_tpu")}


@pytest.mark.parametrize("section", SECTIONS)
@pytest.mark.parametrize("run", ["master", "node", "triage"])
def test_report_sections_equal_jax(sections, run, section):
    assert sections["port"][run][section] == sections["jax"][run][section]


def test_report_sections_hold_the_runs(sections):
    port = sections["port"]
    assert port["master"]["fleet"]["delta_frames"] == 25
    assert port["node"]["fleet"]["cov_bytes_delta"] > 0
    assert port["triage"]["triage"]["minimizations"] == 1
    assert port["triage"]["fleet"] is None and port["node"]["triage"] is None


def test_report_cli_prints_the_sections(dirs):
    for run, title in (("node", "fleet"), ("triage", "triage")):
        proc = subprocess.run(
            [sys.executable, "-m", "wtf_tpu_torch.telemetry.report",
             str(dirs / "wtf_tpu_torch" / run)], cwd=REPO,
            capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert title in proc.stdout
        doc = json.loads(subprocess.run(
            [sys.executable, "-m", "wtf_tpu_torch.telemetry.report",
             str(dirs / "wtf_tpu_torch" / run), "--json"], cwd=REPO,
            capture_output=True, text=True, timeout=120).stdout)
        assert doc[title] == port_report.summarize(
            dirs / "wtf_tpu_torch" / run)[title]
