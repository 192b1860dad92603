"""`campaign --xprof-dir D --xprof-batches 2` (wtf_tpu_torch/fuzz/loop.py:
one torch.profiler window over steady-state batches) against the JAX
CLI's `campaign --xprof-dir` at equal seeds, both CLIs in subprocesses
started together:

  * the window changes nothing: the final `#N cov: .. corp: ..` line, the
    exit code, outputs/ and crashes/ equal the JAX CLI's;
  * D holds a Chrome trace that parses, with CPU op events inside it;
  * events.jsonl holds `xprof-start`/`xprof-stop` at the JAX run's batch
    numbers, with its fields.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from wtf_tpu_torch.fuzz.loop import FuzzLoop
from wtf_tpu_torch.utils.hashing import hex_digest

REPO = Path(__file__).resolve().parent.parent
# four batches: two skipped, two in the window (a CPU trace records ~0.5M
# op events a batch: the precise step is thousands of ops a step)
ARGS = ["campaign", "--name", "demo_tlv", "--lanes", "16", "--runs", "64",
        "--limit", "20000", "--max_len", "8", "--seed", "5",
        "--xprof-batches", "2"]


def _final_line(stdout: str) -> str:
    line = [ln for ln in stdout.splitlines() if ln.startswith("#")][-1]
    return re.sub(r" exec/s: \S+| uptime: \S+", "", line)


def _tree(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hex_digest(p.read_bytes())
            for sub in ("outputs", "crashes") if (root / sub).is_dir()
            for p in sorted((root / sub).iterdir())}


def _trace_events(path: Path):
    """The traceEvents of a Chrome trace, decoded one at a time (the
    whole document would take gigabytes as Python objects)."""
    text = path.read_text()
    decoder = json.JSONDecoder()
    pos = text.index("[", text.index('"traceEvents"')) + 1
    while True:
        while text[pos] in " \t\r\n,":
            pos += 1
        if text[pos] == "]":
            break
        event, pos = decoder.raw_decode(text, pos)
        yield event
    tail = json.loads("{" + text[text.index("]", pos) + 1:].lstrip(" \n,"))
    assert isinstance(tail, dict)


def _xprof_events(telem: Path) -> list:
    keep = ("type", "batch", "batches", "kind")
    return [{k: r[k] for k in keep if k in r}
            for r in map(json.loads,
                         (telem / "events.jsonl").read_text().splitlines())
            if r["type"].startswith("xprof")
            or (r["type"] == "error" and "xprof" in r.get("kind", ""))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("xprof")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {}
    for pkg, extra in (("wtf_tpu_torch", ["--device", "cpu"]),
                       ("wtf_tpu", ["--backend", "tpu"])):
        d = root / pkg
        procs[pkg] = (d, subprocess.Popen(
            [sys.executable, "-m", pkg] + ARGS + extra
            + ["--target", str(d / "t"), "--xprof-dir", str(d / "xprof"),
               "--telemetry-dir", str(d / "telem")], cwd=REPO,
            env=dict(env, OMP_NUM_THREADS="1") if pkg == "wtf_tpu_torch"
            else env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for pkg, (d, proc) in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode in (0, 2), stderr[-2000:]
        out[pkg] = {"dir": d, "result": (proc.returncode, _final_line(stdout),
                                         _tree(d / "t"))}
    return out


@pytest.mark.parametrize("part", ["exit code", "final line", "outputs and "
                                  "crashes"])
def test_xprof_campaign_equals_jax_cli(runs, part):
    i = ["exit code", "final line", "outputs and crashes"].index(part)
    port, jax = runs["wtf_tpu_torch"], runs["wtf_tpu"]
    assert port["result"][i] == jax["result"][i]
    assert jax["result"][1].startswith("#64 cov: ")
    assert any(k.startswith("outputs/") for k in jax["result"][2])


def test_xprof_trace_parses(runs):
    trace = runs["wtf_tpu_torch"]["dir"] / "xprof" / FuzzLoop.XPROF_TRACE
    ops = 0
    for e in _trace_events(trace):
        assert "ph" in e and "name" in e
        if e["ph"] == "X" and e.get("cat") == "cpu_op":
            assert e["dur"] >= 0
            ops += e["name"].startswith("aten::")
    assert ops > 0


@pytest.mark.parametrize("event", ["xprof-start", "xprof-stop"])
def test_xprof_events_at_the_jax_batches(runs, event):
    port = _xprof_events(runs["wtf_tpu_torch"]["dir"] / "telem")
    jax = _xprof_events(runs["wtf_tpu"]["dir"] / "telem")
    assert [e["type"] for e in port] == ["xprof-start", "xprof-stop"]
    got = [e for e in port if e["type"] == event]
    assert got == [e for e in jax if e["type"] == event]
    assert got[0]["batch"] == {"xprof-start": 2, "xprof-stop": 4}[event]
    if event == "xprof-stop":
        assert got[0]["batches"] == 2
