"""Fused-subset parity: K1's in-kernel opclass claim against its reality.

The counterpart of wtf_tpu/analysis/parity.py.  The fused step (K1,
csrc/fused_step.cu on a card, `fused_step_plain` on the CPU) and the
precise step (interp/step.py) duplicate instruction semantics by design:
the kernel runs a hot subset, everything else parks to the precise step.
Nothing at run time keeps them in sync, so this module checks the
contract statically:

  1. `FUSED_OPCLASSES` (interp/pstep.py, which is step.py's
     `HOT_OPCLASSES`) is the *claim*.
  2. The kernel's reality is read twice, and each must equal the claim:
       * the `hot = ...` predicate of csrc/fused_step.cu, read from the
         CUDA source text (its `is_x = opc == OPC_X` locals resolved);
       * the opclasses `fused_step_plain` executes (every `U.OPC_*` it
         names; NOP and FENCE retire through its default no-write path).
  3. step.py's `unsupported` expression (resolved through `unsup` and its
     locals, plus `ORACLE_OPCLASSES`, which `unsup` reads through the
     opclass table's oracle bit) names no claimed class, even
     conditionally.
  4. Every claimed class is dispatched somewhere in step.py — named there
     — or is a documented implicit no-op (NOP/FENCE).

Tests seed violations through the `*_src` parameters; the lint runs
against the real files.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Set

from wtf_tpu_torch.analysis import flow
from wtf_tpu_torch.analysis.findings import Finding

# opclasses both engines execute through their default no-write commit
# path without ever naming them
IMPLICIT_NOOPS = frozenset({"NOP", "FENCE"})

KERNEL_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / \
    "fused_step.cu"
KERNEL_ENTRY = "csrc/fused_step.cu:hot"
PLAIN_FUNCTION = "fused_step_plain"


def _opc_names(node: ast.AST) -> Set[str]:
    """All `U.OPC_*` attribute references under `node`, without prefix."""
    names: Set[str] = set()
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Attribute)
                and isinstance(sub.value, ast.Name)
                and sub.value.id == "U"
                and sub.attr.startswith("OPC_")):
            names.add(sub.attr[len("OPC_"):])
    return names


def _str_names(node: ast.AST) -> Set[str]:
    return {sub.value for sub in ast.walk(node)
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str)}


# -- the CUDA side -----------------------------------------------------------

_C_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
# `name = rhs` up to the next `,` or `;` — C declarators and assignments
# (`==`, `<=`, `>=`, `!=` are not assignments)
_C_ASSIGN = re.compile(r"\b([A-Za-z_]\w*)\s*=(?!=)\s*([^,;{}]+)")
_C_IDENT = re.compile(r"\b[A-Za-z_]\w*\b")


def c_bindings(src: str) -> Dict[str, List[str]]:
    """name -> [RHS text] over every assignment in a CUDA source (the C
    counterpart of flow.name_bindings)."""
    defs: Dict[str, List[str]] = {}
    for name, rhs in _C_ASSIGN.findall(_C_COMMENT.sub("", src)):
        defs.setdefault(name, []).append(rhs)
    return defs


def kernel_hot_opclasses(cu_src: Optional[str] = None,
                         target: str = "hot") -> Set[str]:
    """Opclasses in K1's `hot` predicate (csrc/fused_step.cu), its locals
    resolved transitively."""
    src = cu_src if cu_src is not None else KERNEL_SOURCE.read_text()
    defs = c_bindings(src)
    if target not in defs:
        raise ValueError(f"no `{target} = ...` assignment in the CUDA "
                         "source")
    names: Set[str] = set()
    seen = {target}
    work = [target]
    while work:
        for rhs in defs[work.pop()]:
            for ident in _C_IDENT.findall(rhs):
                if ident.startswith("OPC_"):
                    names.add(ident[len("OPC_"):])
                elif ident in defs and ident not in seen:
                    seen.add(ident)
                    work.append(ident)
    return names


# -- the Python sides --------------------------------------------------------

def plain_opclasses(pstep_src: Optional[str] = None) -> Set[str]:
    """Opclasses `fused_step_plain` executes: every `U.OPC_*` it names."""
    src = pstep_src if pstep_src is not None else flow.module_source(
        "wtf_tpu_torch.interp.pstep")
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.FunctionDef) and node.name == PLAIN_FUNCTION:
            return _opc_names(node)
    raise ValueError(f"no `def {PLAIN_FUNCTION}` in the pstep source")


def _step_src(step_src: Optional[str]) -> str:
    return step_src if step_src is not None else flow.module_source(
        "wtf_tpu_torch.interp.step")


def _reaching_opc_names(func: ast.AST, target: str) -> Set[str]:
    """OPC_* names reachable from the assignments to `target` in one
    function, following each local only through its bindings ABOVE the
    line that reads it (the step function rebinds `gpr`, `rax`... after
    its `unsupported` gate; a whole-module resolver would pull the
    commit's opclasses into the gate)."""
    defs: Dict[str, List[tuple]] = {}
    for node in ast.walk(func):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                for name, value in flow.bound_pairs(t, node.value):
                    defs.setdefault(name, []).append((node.lineno, value))
        elif isinstance(node, ast.AugAssign) and \
                isinstance(node.target, ast.Name):
            defs.setdefault(node.target.id, []).append(
                (node.lineno, node.value))
    if target not in defs:
        raise ValueError(f"no `{target} = ...` assignment found in source")
    names: Set[str] = set()
    work = [(target, float("inf"))]
    seen = set()
    while work:
        name, below = work.pop()
        if (name, below) in seen:
            continue
        seen.add((name, below))
        for lineno, rhs in defs[name]:
            if lineno >= below:
                continue
            names |= _opc_names(rhs)
            for sub in ast.walk(rhs):
                if isinstance(sub, ast.Name) and sub.id in defs:
                    work.append((sub.id, lineno))
    return names


def step_unsupported_opclasses(step_src: Optional[str] = None) -> Set[str]:
    """Opclasses named (even conditionally, even through locals like
    `movcr_bad`) in the step function's `unsupported` expression, plus
    the always-oracle `ORACLE_OPCLASSES` its `unsup` reads through the
    opclass table — the oracle-diverting set, conservatively."""
    src = _step_src(step_src)
    tree = ast.parse(src)
    func = next((node for node in ast.walk(tree)
                 if isinstance(node, ast.FunctionDef)
                 and any(isinstance(sub, ast.Assign) and any(
                     isinstance(t, ast.Name) and t.id == "unsupported"
                     for t in sub.targets) for sub in ast.walk(node))),
                None)
    if func is None:
        raise ValueError("no `unsupported = ...` assignment found in source")
    return _reaching_opc_names(func, "unsupported") | \
        flow.resolve_transitive(src, "ORACLE_OPCLASSES", _str_names)


def step_referenced_opclasses(step_src: Optional[str] = None) -> Set[str]:
    """Every opclass step.py names as `U.OPC_*` (dispatch superset)."""
    return _opc_names(ast.parse(_step_src(step_src)))


def check_fused_parity(claimed: Optional[Set[str]] = None,
                       cu_src: Optional[str] = None,
                       pstep_src: Optional[str] = None,
                       step_src: Optional[str] = None) -> List[Finding]:
    """The fused-subset parity rule family.  Returns [] when the claim,
    the CUDA kernel's predicate, the plain version and step.py's
    dispatch all agree."""
    if claimed is None:
        from wtf_tpu_torch.interp.pstep import FUSED_OPCLASSES

        claimed = set(FUSED_OPCLASSES)
    findings: List[Finding] = []

    kernel = kernel_hot_opclasses(cu_src)
    for opc in sorted(kernel - claimed):
        findings.append(Finding(
            rule="parity.claim-vs-kernel", entry=KERNEL_ENTRY,
            primitive=f"OPC_{opc}",
            message=("K1's hot predicate executes an opclass absent from "
                     "FUSED_OPCLASSES — update the claim (and this check's "
                     "step.py cross-checks will vet it)")))
    for opc in sorted(claimed - kernel):
        findings.append(Finding(
            rule="parity.claim-vs-kernel", entry=KERNEL_ENTRY,
            primitive=f"OPC_{opc}",
            message=("FUSED_OPCLASSES claims an opclass K1's hot predicate "
                     "never matches — stale claim")))

    plain = plain_opclasses(pstep_src)
    for opc in sorted(claimed - plain - IMPLICIT_NOOPS):
        findings.append(Finding(
            rule="parity.claim-vs-plain",
            entry=f"interp/pstep.py:{PLAIN_FUNCTION}",
            primitive=f"OPC_{opc}",
            message=("FUSED_OPCLASSES claims an opclass the plain version "
                     "admits as hot but never executes — the CPU engine "
                     "would retire it as a no-op")))
    for opc in sorted(plain - claimed):
        findings.append(Finding(
            rule="parity.claim-vs-plain",
            entry=f"interp/pstep.py:{PLAIN_FUNCTION}",
            primitive=f"OPC_{opc}",
            message=("the plain version executes an opclass outside "
                     "FUSED_OPCLASSES — dead code, or a claim that lost a "
                     "class")))

    unsupported = step_unsupported_opclasses(step_src)
    for opc in sorted(claimed & unsupported):
        findings.append(Finding(
            rule="parity.fused-vs-unsupported",
            entry="interp/step.py:unsupported", primitive=f"OPC_{opc}",
            message=("opclass claimed in-kernel appears in step.py's "
                     "oracle-diverting `unsupported` set — a parked lane "
                     "would diverge from the kernel")))

    referenced = step_referenced_opclasses(step_src) | IMPLICIT_NOOPS
    for opc in sorted(claimed - referenced):
        findings.append(Finding(
            rule="parity.fused-vs-dispatch", entry="interp/step.py",
            primitive=f"OPC_{opc}",
            message=("opclass claimed in-kernel is never dispatched by "
                     "step.py (and is not a documented implicit no-op) — "
                     "the resume leg cannot execute it")))
    return findings
