"""The port's lint: static and census checks of the hot-path contracts.

The counterpart of wtf_tpu/analysis.  Its families keep the JAX lint's
names (rules.py's FAMILIES): the AST families (parity, supervise,
telemetry, state, transfer, thread, contracts) run over the port's own
tree; `budget` is an op census of the steady-state programs (what
torch.profiler records of them, run on the CPU at fixed seeds, pinned in
analysis/budgets.json) and `mesh` counts the cross-shard gathers of a
mesh chunk.  `dtype` and `recompile` are rules about XLA programs and
have no counterpart (rules.NO_COUNTERPART): selecting either exits 1 with
its reason.  Both tables (analysis/budgets.json, analysis/contracts.json)
are ratchets: `--rebaseline` rewrites them and refuses growth without
`--allow-regression`.

Entry points:
    python -m wtf_tpu_torch.analysis [--json] [--families ...] [--rebaseline]
    python -m wtf_tpu_torch lint ...     (same flags, telemetry-wired)

Like every entry point of the port, the lint runs on the card by
default (`--device cuda`): the census runs there as well as in its CPU
child, and prints, per program, its CUDA kernel launches and
device-to-host copies beside the pinned CPU counts (the pins stay the
CPU's).  Without a card the families that run programs (budget, mesh,
and transfer with --deep or --rebaseline) raise unless given `--device
cpu`; the AST families alone need no device.  The campaign and runner
constructors the smokes and tests share live in trace.py.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from wtf_tpu_torch.analysis.rules import (
    CENSUS_PROGRAMS, FAMILIES, NO_COUNTERPART, run_lint,
)


def add_lint_arguments(p: argparse.ArgumentParser) -> None:
    """The lint's flags (the JAX lint's, plus --device), shared by
    `python -m wtf_tpu_torch.analysis` and the `lint` subcommand."""
    p.add_argument("--json", action="store_true",
                   help="machine-readable output (one JSON object)")
    p.add_argument("--families", default=None,
                   help=f"comma list from {','.join(FAMILIES)} (default: "
                        f"every family the port has; "
                        f"{','.join(NO_COUNTERPART)} have no counterpart)")
    p.add_argument("--budgets", default=None,
                   help="alternate budgets.json (default: the checked-in "
                        "wtf_tpu_torch/analysis/budgets.json)")
    p.add_argument("--rebaseline", action="store_true",
                   help="measure the census and gathers and REWRITE the "
                        "budget file (and the contract tables) instead of "
                        "checking them (record why in PERF.md).  "
                        "Ratcheted: refuses a total INCREASE without "
                        "--allow-regression")
    p.add_argument("--allow-regression", action="store_true",
                   help="let --rebaseline record a budget increase or "
                        "contract growth (name the reason in PERF.md)")
    p.add_argument("--telemetry-dir", default=None,
                   help="write lint findings as events.jsonl records")
    p.add_argument("--deep", action="store_true",
                   help="pin the census's host reads (transfer family) "
                        "even without the budget family")
    p.add_argument("--sarif", default=None, metavar="OUT.json",
                   help="also write the findings as a SARIF 2.1.0 "
                        "document (file:line provenance mapped to "
                        "physical locations)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; the census also runs on the "
                        "card, beside the pinned CPU counts, and raises "
                        "without one), cuda:N, or cpu")


def _census_lines(info: dict) -> List[str]:
    census = info.get("census") or {}
    device = info.get("device_census") or {}
    lines = []
    for name in CENSUS_PROGRAMS:
        if name not in census:
            continue
        c = census[name]
        line = (f"op census {name}: {c['total']} ops, K1 "
                f"{c['fused_step']}, host reads {c['host_reads']}")
        if name in device:
            d = device[name]
            line += (f"; on {info.get('device')}: {d['total']} ops, K1 "
                     f"{d['fused_step']}, {d['cuda_launches']} CUDA "
                     f"launches, {d['memcpy_dtoh']} DtoH copies")
        lines.append(line)
    return lines


def lint_main(families=None, budgets=None, rebaseline: bool = False,
              allow_regression: bool = False,
              as_json: bool = False, deep: bool = False,
              sarif: Optional[str] = None, device: str = "cuda",
              registry=None, events=None, out=None) -> int:
    """Run the lint and print results; returns the process exit code
    (0 clean, 1 findings or a refusal)."""
    out = out or sys.stdout
    t0 = time.time()
    try:
        findings, info = run_lint(families=families, budgets_path=budgets,
                                  rebaseline=rebaseline,
                                  allow_regression=allow_regression,
                                  deep=deep, device=device,
                                  registry=registry, events=events)
    except ValueError as e:
        # operator-facing refusals (the ratchets, bad family lists, the
        # families without a counterpart) print as one line
        print(f"wtf-tpu lint: {e}", file=out)
        return 1
    info["device"] = str(device)
    wall = round(time.time() - t0, 1)
    if sarif:
        from pathlib import Path

        from wtf_tpu_torch.analysis.findings import to_sarif

        Path(sarif).write_text(
            json.dumps(to_sarif(findings), indent=2) + "\n")
    if as_json:
        print(json.dumps({
            "clean": not findings, "wall_seconds": wall,
            "findings": [f.as_dict() for f in findings], **info,
        }), file=out)
    else:
        for f in findings:
            print(f"FAIL {f}", file=out)
        for line in _census_lines(info):
            print(line, file=out)
        gathers = info.get("mesh_gathers")
        if gathers:
            print("mesh gathers: " + " ".join(
                f"{k}={v}" for k, v in gathers.items()), file=out)
        reads = info.get("transfer_census")
        if reads:
            print("host reads: " + " ".join(
                f"{k}={v}" for k, v in reads.items()), file=out)
        for key in ("budgets_written", "contracts_written"):
            if key in info:
                print(f"re-baselined -> {info[key]}", file=out)
        state = ("CLEAN" if not findings
                 else f"{len(findings)} finding(s)")
        print(f"wtf-tpu lint: {state} "
              f"({','.join(info['families'])}; {wall}s)", file=out)
    return 0 if not findings else 1


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="wtf_tpu_torch.analysis",
        description="the port's lint (hot-path contracts and op census)")
    add_lint_arguments(p)
    args = p.parse_args(argv)
    families = args.families.split(",") if args.families else None
    from wtf_tpu_torch.telemetry import Registry, open_event_log

    registry = Registry()
    events = open_event_log(args.telemetry_dir)
    events.emit("run-start", subcommand="lint",
                argv=list(argv) if argv is not None else sys.argv[1:])
    try:
        return lint_main(families=families, budgets=args.budgets,
                         rebaseline=args.rebaseline,
                         allow_regression=args.allow_regression,
                         as_json=args.json, deep=args.deep,
                         sarif=args.sarif, device=args.device,
                         registry=registry, events=events)
    finally:
        events.emit("run-end", metrics=registry.dump())
        events.close()
