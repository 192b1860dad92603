"""Finding: one named lint violation with actionable provenance.

A copy of wtf_tpu/analysis/findings.py.  Every rule of the port's lint
(wtf_tpu_torch/analysis/rules.py) reports violations as Finding records
— rule name + entry point + offending primitive — so a regression shows
up in CI as e.g.

    budget.op-count @ xla_step [total]: ... (measured 9120 vs budget 9004)

The dataflow families (state/transfer/thread, wtf_tpu_torch/analysis/
contracts.py) additionally carry file:line provenance, which the SARIF
output mode maps to physical locations for review annotation.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import List, Optional


@dataclass
class Finding:
    rule: str                      # e.g. "state.uncheckpointed", "budget.op-count"
    entry: str                     # traced entry point (function / executor)
    message: str                   # one-line human explanation
    primitive: Optional[str] = None  # offending op / attribute / opclass
    count: Optional[int] = None      # measured value (budget rules)
    budget: Optional[int] = None     # pinned value  (budget rules)
    file: Optional[str] = None       # source file (dataflow families)
    line: Optional[int] = None       # 1-based line in `file`

    def as_dict(self) -> dict:
        return {k: v for k, v in asdict(self).items() if v is not None}

    def __str__(self) -> str:
        extra = f" [{self.primitive}]" if self.primitive else ""
        vs = (f" (measured {self.count} vs budget {self.budget})"
              if self.count is not None and self.budget is not None else "")
        loc = f" ({self.file}:{self.line})" if self.file else ""
        return f"{self.rule} @ {self.entry}{extra}: {self.message}{vs}{loc}"


def to_sarif(findings: List[Finding], tool_version: str = "0") -> dict:
    """SARIF 2.1.0 document for review-annotation pipelines — one result
    per finding, physical location attached when the rule carries
    file:line provenance."""
    results = []
    for f in findings:
        result: dict = {
            "ruleId": f.rule,
            "level": "error",
            "message": {"text": str(f)},
        }
        if f.file:
            result["locations"] = [{
                "physicalLocation": {
                    "artifactLocation": {"uri": f.file},
                    "region": {"startLine": int(f.line or 1)},
                },
            }]
        results.append(result)
    rules = sorted({f.rule for f in findings})
    return {
        "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json"),
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "wtf-tpu-lint",
                "version": tool_version,
                "rules": [{"id": r} for r in rules],
            }},
            "results": results,
        }],
    }
