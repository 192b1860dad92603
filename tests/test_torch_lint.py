"""The port's lint (wtf_tpu_torch/analysis) against the JAX package's.

  * the lint is CLEAN on the port's tree over its AST families, in a
    subprocess that never imports jax;
  * every ported rule fires on a doctored source or table, the way
    tests/test_flow.py and tests/test_analysis.py doctor the JAX ones
    (throwaway modules under tmp_path): an uncheckpointed attribute, a
    hidden host read in a seam, an unlocked shared write, stale and
    undocumented entries, a parity claim mismatch (the CUDA side
    included), a census budget that rises and one that falls, a mesh
    gather too many, the rebaseline ratchets;
  * the parity extractors give the JAX package's opclass sets, and the
    state/transfer/thread analyses of each copied class name the JAX
    package's attributes except where the port's contracts.json states
    why (its `jax_differences` section, held exact here);
  * `dtype` and `recompile` exit 1 with their reason; the SARIF document
    equals the JAX package's.

Tolerance 0: findings, sets and counts are exact.
"""

import importlib
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from tests.torchport import one_torch_thread  # noqa: F401
from wtf_tpu.analysis import contracts as JCT
from wtf_tpu.analysis import parity as JP
from wtf_tpu.analysis.findings import Finding as JFinding
from wtf_tpu.analysis.findings import to_sarif as jax_to_sarif
from wtf_tpu_torch.analysis import contracts as CT
from wtf_tpu_torch.analysis import flow
from wtf_tpu_torch.analysis import parity as P
from wtf_tpu_torch.analysis import rules as R
from wtf_tpu_torch.analysis.findings import Finding, to_sarif

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = Path(__file__).resolve().parent.parent
AST_FAMILIES = "parity,supervise,telemetry,state,transfer,thread,contracts"


def _tmp_module(tmp_path, monkeypatch, name, src):
    """An importable throwaway module (names unique per test: flow's
    caches key on the module name)."""
    (tmp_path / f"{name}.py").write_text(textwrap.dedent(src))
    monkeypatch.syspath_prepend(str(tmp_path))
    importlib.invalidate_caches()
    return name


def _jax_site(site: str) -> str:
    return (site.replace("wtf_tpu_torch.", "wtf_tpu.")
            .replace("backend.gpu:GpuBackend", "backend.tpu:TpuBackend"))


# ---------------------------------------------------------------------------
# clean on the port's tree, without jax
# ---------------------------------------------------------------------------

def test_lint_clean_on_the_port_without_jax():
    code = textwrap.dedent(f"""
        import json, sys
        from wtf_tpu_torch.analysis import lint_main
        rc = lint_main(families={AST_FAMILIES.split(',')!r}, as_json=True,
                       device="cpu")
        assert "jax" not in sys.modules, "the lint imported jax"
        assert not any(m == "wtf_tpu" or m.startswith("wtf_tpu.")
                       for m in sys.modules), "the lint imported wtf_tpu"
        sys.exit(rc)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert doc["clean"] and doc["findings"] == []
    assert doc["families"] == AST_FAMILIES.split(",")


@pytest.mark.parametrize("family", ["dtype", "recompile"])
def test_families_without_counterpart_exit_1(family, capsys):
    from wtf_tpu_torch.cli import main

    assert main(["lint", "--device", "cpu", "--families", family]) == 1
    out = capsys.readouterr().out.strip().splitlines()
    assert out == [f"wtf-tpu lint: family {family!r} has no counterpart "
                   f"in the port: {R.NO_COUNTERPART[family]}"]


def test_unknown_family_and_rebaseline_refusals(capsys):
    from wtf_tpu_torch.analysis import lint_main

    assert lint_main(families=["nope"], device="cpu") == 1
    assert lint_main(families=["parity"], rebaseline=True,
                     device="cpu") == 1
    out = capsys.readouterr().out
    assert "unknown lint families: ['nope']" in out
    assert "--rebaseline rewrites" in out


@pytest.mark.parametrize("flags", [["budget"], ["mesh"],
                                   ["transfer", "--deep"]])
def test_lint_defaults_to_the_card_and_raises_without_one(flags,
                                                          monkeypatch):
    # the families that run programs resolve the default --device cuda
    # before any work; only an explicit --device cpu runs them here
    import torch

    from wtf_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["lint", "--families", *flags])


def test_ast_families_need_no_device(monkeypatch, capsys):
    import torch

    from wtf_tpu_torch.analysis import lint_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert lint_main(families=["parity", "supervise"]) == 0
    assert "wtf-tpu lint: CLEAN" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# parity: the extractors against the JAX package's, and seeded violations
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_parity():
    return {"hot": JP.kernel_hot_opclasses(),
            "unsupported": JP.step_unsupported_opclasses()}


def test_parity_extractors_equal_jax(jax_parity):
    from wtf_tpu.interp.pstep import FUSED_OPCLASSES as JCLAIM
    from wtf_tpu_torch.interp.pstep import FUSED_OPCLASSES

    assert P.kernel_hot_opclasses() == jax_parity["hot"]
    assert P.step_unsupported_opclasses() == jax_parity["unsupported"]
    assert set(FUSED_OPCLASSES) == set(JCLAIM)
    assert P.plain_opclasses() | P.IMPLICIT_NOOPS == set(JCLAIM)
    assert P.check_fused_parity() == []


def test_parity_fires_on_the_cuda_side():
    cu = P.KERNEL_SOURCE.read_text()
    assert "is_alu || is_shift ||" in cu
    dropped = cu.replace("is_alu || is_shift ||", "is_alu ||")
    findings = P.check_fused_parity(cu_src=dropped)
    assert [(f.rule, f.primitive) for f in findings] == [
        ("parity.claim-vs-kernel", "OPC_SHIFT")]
    assert "never matches" in findings[0].message
    # a class the kernel runs but the claim lacks, through a new local
    added = cu.replace("const bool hot = ",
                       "const bool is_bt = opc == OPC_BT;\n"
                       "    const bool hot = is_bt || ")
    findings = P.check_fused_parity(cu_src=added)
    assert [(f.rule, f.primitive) for f in findings] == [
        ("parity.claim-vs-kernel", "OPC_BT")]


def test_parity_fires_on_the_plain_version_and_step():
    pstep_src = flow.module_source("wtf_tpu_torch.interp.pstep")
    doctored = pstep_src.replace("d.is_(U.OPC_MUL)", "d.is_(U.OPC_DIV)")
    findings = P.check_fused_parity(pstep_src=doctored)
    assert {(f.rule, f.primitive) for f in findings} == {
        ("parity.claim-vs-plain", "OPC_MUL"),
        ("parity.claim-vs-plain", "OPC_DIV")}
    step_src = flow.module_source("wtf_tpu_torch.interp.step")
    anchor = "    unsupported = pre_live & unsup\n"
    assert anchor in step_src
    bad = step_src.replace(anchor, "    unsup = unsup | is_(U.OPC_MOV)\n"
                           + anchor)
    findings = P.check_fused_parity(step_src=bad)
    assert [(f.rule, f.primitive) for f in findings] == [
        ("parity.fused-vs-unsupported", "OPC_MOV")]


# ---------------------------------------------------------------------------
# the contract families: seeded violations
# ---------------------------------------------------------------------------

def test_state_uncheckpointed_fires_with_provenance(tmp_path, monkeypatch):
    mod = _tmp_module(tmp_path, monkeypatch, "tflow_state", """
        class Camp:
            def __init__(self):
                self.a = 0
            def step(self):
                self.cursor = 1
            def checkpoint_state(self):
                return {"a": self.a}
    """)
    surface = {f"{mod}:Camp": [(mod, "Camp.checkpoint_state", "self")]}
    findings = CT.check_state_contracts({"state": {}}, surface=surface)
    assert [(f.rule, f.primitive, f.line) for f in findings] == [
        ("state.uncheckpointed", "cursor", 6)]
    assert findings[0].file.endswith("tflow_state.py")
    declared = {"state": {f"{mod}:Camp": {
        "cursor": {"kind": "transient", "reason": "per-step"}}}}
    assert CT.check_state_contracts(declared, surface=surface) == []


@pytest.mark.parametrize("expr,kind", [
    ("x.item()", ".item()"), ("x.tolist()", ".tolist()"),
    ("x.cpu()", ".cpu()"), ("x.numpy()", ".numpy()"),
    ("bool(x.any())", "bool()"), ("int(x[0])", "int()"),
    ("float(x.sum())", "float()"), ("np.asarray(x)", "np.asarray()"),
])
def test_hidden_host_read_in_a_seam_fires(expr, kind, tmp_path,
                                          monkeypatch):
    name = "tflow_seam_" + kind.strip(".()").replace(".", "_")
    mod = _tmp_module(tmp_path, monkeypatch, name, f"""
        import numpy as np
        def seam(x):
            y = int(0) + int(Status.RUNNING)
            return {expr}
    """)
    findings = CT.check_transfer_seams({"transfer": {}},
                                       sites={"s": f"{mod}:seam"})
    assert [(f.rule, f.primitive, f.count, f.budget, f.line)
            for f in findings] == [("transfer.hidden-sync", kind, 1, 0, 5)]
    allowed = {"transfer": {f"{mod}:seam": [
        {"call": kind, "count": 1, "reason": "the seam's harvest"}]}}
    assert CT.check_transfer_seams(allowed, sites={"s": f"{mod}:seam"}) \
        == []


def test_unlocked_shared_write_fires(tmp_path, monkeypatch):
    mod = _tmp_module(tmp_path, monkeypatch, "tflow_thread", """
        class Srv:
            def run(self):
                while not self._stop:
                    pass
            def stop(self):
                self._stop = True
    """)
    surface = {f"{mod}:Srv": {"reactor": ("run",), "control": ("stop",)}}
    findings = CT.check_thread_contracts({"thread": {}}, surface=surface)
    assert [(f.rule, f.primitive, f.line) for f in findings] == [
        ("thread.unlocked-shared-write", "_stop", 7)]
    declared = {"thread": {f"{mod}:Srv": {
        "_stop": {"owner": "control", "reason": "GIL-atomic flag"}}}}
    assert CT.check_thread_contracts(declared, surface=surface) == []


def test_stale_and_undocumented_entries_fire(tmp_path, monkeypatch):
    mod = _tmp_module(tmp_path, monkeypatch, "tflow_hyg", """
        class Camp:
            def step(self):
                self.cursor = 1
        def seam(x):
            return x.item()
    """)
    state_a = CT.analyze_state({f"{mod}:Camp": []})
    transfer_a = CT.analyze_transfer({"s": f"{mod}:seam"})
    con = {"state": {f"{mod}:Camp": {
        "deleted_attr": {"kind": "transient", "reason": "was real once"},
        "cursor": {"kind": "transient", "reason": ""}}},
        "transfer": {f"{mod}:seam": [
            {"call": ".item()", "count": 3, "reason": "r"}]},
        "thread": {},
        "jax_differences": {"state": {f"{mod}:Camp": {"cursor": " "}}}}
    findings = CT.check_contract_hygiene(con, state_a, transfer_a, {})
    assert sorted((f.rule, f.primitive) for f in findings) == [
        ("contracts.stale-entry", ".item()"),
        ("contracts.stale-entry", "deleted_attr"),
        ("contracts.undocumented", "cursor"),
        ("contracts.undocumented", "state:cursor")]


def test_contracts_rebaseline_ratchet():
    old = {"state": {"m:C": {
        "x": {"kind": "derived", "reason": "documented"},
        "gone": {"kind": "transient", "reason": "dead"}}},
        "transfer": {}, "thread": {},
        "jax_differences": {"state": {"m:C": {"x": "why"}}}}
    grown = {"state": {"m:C": {"x": {"kind": "transient", "reason": ""},
                               "y": {"kind": "transient", "reason": ""}}},
             "transfer": {}, "thread": {}}
    with pytest.raises(ValueError, match="GROW.*state:m:C.y"):
        CT.apply_contracts_rebaseline(old, grown)
    shrunk = {"state": {"m:C": {"x": {"kind": "transient", "reason": ""}}},
              "transfer": {}, "thread": {}}
    merged = CT.apply_contracts_rebaseline(old, shrunk)
    assert merged["state"] == {"m:C": {
        "x": {"kind": "derived", "reason": "documented"}}}
    assert merged["jax_differences"] == old["jax_differences"]


def test_supervise_and_telemetry_rules_fire():
    bad = {"chunk": "wtf_tpu_torch.supervise.ladder:DegradationLadder.apply"}
    findings = R.check_supervised_seams(sites=bad)
    assert [(f.rule, f.primitive) for f in findings] == [
        ("supervise.seam-routing", "chunk")]
    assert findings[0].file.endswith("ladder.py")
    findings = R.check_supervised_seams(
        sites={"x": "wtf_tpu_torch.interp.runner:Runner.no_such"})
    assert findings[0].rule == "supervise.seam-routing"
    bad = {"exports":
           "wtf_tpu_torch.fleet.telemetry:FleetTelemetry.write_exports"}
    findings = R.check_telemetry_seams(sites=bad)
    assert [f.rule for f in findings] == ["telemetry.seam-serialization"]
    assert "json.dumps(" in findings[0].primitive
    # the port's alias style `sup = self.supervisor; sup.dispatch(...)`
    assert R.check_supervised_seams() == []


def test_triage_replay_pin_fires(monkeypatch):
    from wtf_tpu_torch.triage.replay import ReplayCore

    assert R.check_triage_chunk() == []
    monkeypatch.setattr(ReplayCore, "_chunk", lambda self, tab, size: None,
                        raising=False)
    findings = R.check_triage_chunk()
    assert [(f.rule, f.primitive) for f in findings] == [
        ("budget.triage-chunk", "_chunk")]


# ---------------------------------------------------------------------------
# the census and mesh pins: seeded drifts and the ratchet
# ---------------------------------------------------------------------------

def test_census_budget_fires_on_a_rise_and_a_fall():
    budget = R.load_budgets()[R.BUDGET_ENTRY]
    counts = {k: budget[k] for k in ("total", "fused_step", "host_reads")}
    counts["top"] = dict(budget["top"])
    assert R.check_budget(counts, budget, entry=R.BUDGET_ENTRY) == []
    top_op = sorted(budget["top"])[0]
    up = dict(counts, total=counts["total"] + 1,
              top=dict(counts["top"], **{top_op: budget["top"][top_op] + 1}))
    findings = R.check_budget(up, budget, entry=R.BUDGET_ENTRY)
    assert sorted((f.primitive, f.count - f.budget) for f in findings) == \
        sorted([("total", 1), (top_op, 1)])
    assert all("over" in f.message for f in findings)
    down = dict(counts, host_reads=counts["host_reads"] - 1)
    findings = R.check_budget(down, budget, entry=R.BUDGET_ENTRY)
    assert [(f.rule, f.primitive) for f in findings] == [
        ("budget.op-count", "host_reads")]
    assert "under" in findings[0].message


def test_census_rebaseline_ratchet():
    budgets = {"xla_step": {"total": 10}, "mesh_chunk": {"total": 1}}
    with pytest.raises(ValueError, match=r"xla_step: 10 -> 11"):
        R.apply_rebaseline(budgets, {"xla_step": {"total": 11}})
    merged = R.apply_rebaseline(budgets, {"xla_step": {"total": 11}},
                                allow_regression=True)
    assert merged["xla_step"]["total"] == 11
    merged = R.apply_rebaseline(budgets, {"xla_step": {"total": 9}})
    assert merged == {"xla_step": {"total": 9}, "mesh_chunk": {"total": 1}}


def test_mesh_and_transfer_census_drift_fire():
    pin = R.load_budgets()[R.MESH_ENTRY]
    assert pin["total"] == 1   # the JAX pin's one coverage all-reduce
    findings = R.check_mesh_gathers(
        {"gather_shards": 2, "gather_processes": 2, "total": 2}, pin,
        entry="m")
    assert sorted(f.primitive for f in findings) == [
        "gather_processes", "gather_shards", "total"]
    reads = R.load_budgets()[CT.TRANSFER_ENTRY]
    measured = {k: v for k, v in reads.items() if k != "entry"}
    assert CT.check_transfer_census(measured, reads) == []
    measured["xla_step"] += 1
    measured["total"] += 1
    findings = CT.check_transfer_census(measured, reads)
    assert sorted((f.rule, f.primitive) for f in findings) == [
        ("transfer.census-drift", "total"),
        ("transfer.census-drift", "xla_step")]


# ---------------------------------------------------------------------------
# the analyses of the copied classes against the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def analyses():
    return {"port": (CT.analyze_state(), CT.analyze_transfer(),
                     CT.analyze_thread()),
            "jax": (JCT.analyze_state(), JCT.analyze_transfer(),
                    JCT.analyze_thread())}


def _uncovered(a):
    return set(a["mutable"]) - a["covered"]


def test_state_analysis_equals_jax_but_documented(analyses):
    port, jax = analyses["port"][0], analyses["jax"][0]
    documented = CT.load_contracts()["jax_differences"]["state"]
    seen = {}
    for site, a in port.items():
        jsite = _jax_site(site)
        if jsite not in jax:
            continue   # a class the JAX lint does not analyse (tenancy)
        diff = _uncovered(a) ^ _uncovered(jax[jsite])
        if diff:
            seen[site] = diff
    assert seen == {site: set(rows) for site, rows in documented.items()}
    assert set(JCT.STATE_SURFACE) <= {_jax_site(s) for s in port}


def test_transfer_analysis_equals_jax_but_documented(analyses):
    from wtf_tpu.supervise import SEAM_SITES as JSITES
    from wtf_tpu_torch.supervise import SEAM_SITES

    port, jax = analyses["port"][1], analyses["jax"][1]
    documented = CT.load_contracts()["jax_differences"]["transfer"]
    assert set(SEAM_SITES) == set(JSITES)
    seen = {}
    for seam in SEAM_SITES:
        p_calls = {k: len(v) for k, v in
                   port[SEAM_SITES[seam]]["calls"].items()}
        j_calls = {k: len(v) for k, v in jax[JSITES[seam]]["calls"].items()}
        diff = {k for k in set(p_calls) | set(j_calls)
                if p_calls.get(k) != j_calls.get(k)}
        if diff:
            seen[SEAM_SITES[seam]] = diff
    assert seen == {site: set(rows) for site, rows in documented.items()}


def test_thread_analysis_equals_jax_but_documented(analyses):
    port, jax = analyses["port"][2], analyses["jax"][2]
    documented = CT.load_contracts()["jax_differences"]["thread"]
    seen = {}
    for site, a in port.items():
        diff = set(a["shared"]) ^ set(jax[_jax_site(site)]["shared"])
        if diff:
            seen[site] = diff
    assert seen == {site: set(rows) for site, rows in documented.items()}
    assert {_jax_site(s) for s in port} == set(jax)


def test_checked_in_contracts_fully_documented():
    con = CT.load_contracts()
    for cls, attrs in con["state"].items():
        for attr, d in attrs.items():
            assert d["kind"] in CT.STATE_KINDS, (cls, attr)
            assert d["reason"].strip(), (cls, attr)
    for site, rows in con["transfer"].items():
        for row in rows:
            assert row["reason"].strip(), (site, row["call"])
    for cls, attrs in con["thread"].items():
        for attr, d in attrs.items():
            assert d.get("owner") or d.get("lock"), (cls, attr)
            assert d["reason"].strip(), (cls, attr)
    for family, owners in con["jax_differences"].items():
        for owner, rows in owners.items():
            assert all(str(r).strip() for r in rows.values()), owner


# ---------------------------------------------------------------------------
# findings plumbing
# ---------------------------------------------------------------------------

def test_sarif_document_equals_jax():
    rows = [dict(rule="state.uncheckpointed", entry="e", message="m",
                 file="a/b.py", line=7),
            dict(rule="budget.op-count", entry="e", message="m",
                 primitive="total", count=3, budget=2)]
    doc = to_sarif([Finding(**r) for r in rows])
    assert doc == jax_to_sarif([JFinding(**r) for r in rows])
    with_loc, without_loc = doc["runs"][0]["results"]
    assert with_loc["locations"][0]["physicalLocation"]["region"][
        "startLine"] == 7
    assert "locations" not in without_loc


def test_lint_cli_writes_sarif_and_events(tmp_path, capsys):
    from wtf_tpu_torch.cli import main

    sarif = tmp_path / "lint.sarif"
    telem = tmp_path / "telem"
    assert main(["lint", "--device", "cpu", "--families",
                 "parity,supervise", "--sarif", str(sarif),
                 "--telemetry-dir", str(telem)]) == 0
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1].startswith(
        "wtf-tpu lint: CLEAN (parity,supervise; ")
    doc = json.loads(sarif.read_text())
    assert doc["runs"][0]["results"] == []
    events = [json.loads(ln) for ln in
              (telem / "events.jsonl").read_text().splitlines()]
    assert [e["type"] for e in events][0] == "run-start"
    metrics = events[-1]["metrics"]
    assert metrics["analysis.families_run"] == 2
