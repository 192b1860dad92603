"""Whole-program contract families: state, transfer, thread, contracts.

A copy of wtf_tpu/analysis/contracts.py run over the port's classes
(`wtf_tpu_torch.*`, the GPU backend in the TPU backend's place, the
tenancy classes added) against the port's own contracts.json.

Three dynamic guarantees of the stack are pinned statically here, on the
shared dataflow engine (wtf_tpu_torch/analysis/flow.py):

  * **state** — bit-identical checkpoint/resume requires that
    every mutable attribute on the campaign objects is either carried by
    the checkpoint field sets or consciously declared derived/transient.
    The family enumerates `self.X = ...` writes outside `__init__` per
    class, subtracts what the checkpoint/restore/recovery-snapshot
    extractors touch, and demands a disposition in `contracts.json` for
    the rest (`state.uncheckpointed`).
  * **transfer** — the steady state must not grow a hidden device→host
    sync.  AST rule: every `.item()` / `.tolist()` / `.cpu()` /
    `.numpy()` / `float()` / `bool()` / `int()` / `np.asarray()` call
    inside a supervise.SEAM_SITES function must match an allowlist row
    (`transfer.hidden-sync`), and the device-to-host reads the op census
    (rules.py) counts in the steady-state programs are pinned in
    budgets.json under `host_transfer` (`transfer.census-drift`).
  * **thread** — the watchdog/prelaunch/reactor/reconnect paths run on
    real host threads.  Attributes shared across declared thread roots
    (written by one root, written or read by another) must appear in an
    ownership/lock table (`thread.unlocked-shared-write`).
  * **contracts** — the tables themselves are audited: entries naming
    deleted attributes or unmatched allowlist rows are
    `contracts.stale-entry`, entries without a reason are
    `contracts.undocumented` — an allowlist you can't grow silently and
    can't let rot.

`contracts.json` is a RATCHET with budgets.json semantics:
`--rebaseline` regenerates the tables but REFUSES to add entries unless
`--allow-regression` is passed, and new entries land with an empty
reason — which the contracts family flags until a human documents them.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from wtf_tpu_torch.analysis import flow
from wtf_tpu_torch.analysis.findings import Finding

CONTRACTS_PATH = Path(__file__).with_name("contracts.json")

# contracts.json section names / valid state dispositions
SECTIONS = ("state", "transfer", "thread", "jax_differences")
STATE_KINDS = ("derived", "transient", "config", "rebind")

# ---------------------------------------------------------------------------
# the analyzed surfaces
# ---------------------------------------------------------------------------

_CKPT = "wtf_tpu_torch.resume.checkpoint"
_SUP = "wtf_tpu_torch.supervise.supervisor"
_TEN = "wtf_tpu_torch.tenancy.state"

# class site -> the checkpoint/restore/recovery extractors whose
# attribute accesses (through the named parameter) count as coverage.
# checkpoint_state READS what it saves; restore_state WRITES what it
# reinstates; the recovery snapshot (Supervisor.pre_batch/recover) and
# the campaign checkpoint (_campaign_state/restore_campaign) reach into
# the loop/backend from outside — both directions count.
STATE_SURFACE: Dict[str, List[Tuple[str, str, str]]] = {
    "wtf_tpu_torch.interp.runner:Runner": [
        ("wtf_tpu_torch.interp.runner", "Runner.checkpoint_state", "self"),
        ("wtf_tpu_torch.interp.runner", "Runner.restore_state", "self"),
    ],
    "wtf_tpu_torch.meshrun.runner:MeshRunner": [
        ("wtf_tpu_torch.interp.runner", "Runner.checkpoint_state", "self"),
        ("wtf_tpu_torch.interp.runner", "Runner.restore_state", "self"),
    ],
    "wtf_tpu_torch.fuzz.loop:FuzzLoop": [
        (_CKPT, "_campaign_state", "loop"),
        (_CKPT, "restore_campaign", "loop"),
        (_SUP, "Supervisor.pre_batch", "loop"),
        (_SUP, "Supervisor.recover", "loop"),
    ],
    "wtf_tpu_torch.fuzz.mutator:ByteMutator": [
        ("wtf_tpu_torch.fuzz.mutator", "Mutator.checkpoint_state", "self"),
        ("wtf_tpu_torch.fuzz.mutator", "Mutator.restore_state", "self"),
    ],
    "wtf_tpu_torch.fuzz.mutator:MangleMutator": [
        ("wtf_tpu_torch.fuzz.mutator", "Mutator.checkpoint_state", "self"),
        ("wtf_tpu_torch.fuzz.mutator", "Mutator.restore_state", "self"),
    ],
    "wtf_tpu_torch.fuzz.mutator:TlvStructureMutator": [
        ("wtf_tpu_torch.fuzz.mutator", "Mutator.checkpoint_state", "self"),
        ("wtf_tpu_torch.fuzz.mutator", "Mutator.restore_state", "self"),
    ],
    "wtf_tpu_torch.devmut.mutator:DevMangleMutator": [
        ("wtf_tpu_torch.devmut.mutator",
         "DevMangleMutator.checkpoint_state", "self"),
        ("wtf_tpu_torch.devmut.mutator",
         "DevMangleMutator.restore_state", "self"),
    ],
    "wtf_tpu_torch.devmut.corpus:DeviceCorpus": [
        ("wtf_tpu_torch.devmut.corpus", "DeviceCorpus.checkpoint_state", "self"),
        ("wtf_tpu_torch.devmut.corpus", "DeviceCorpus.uploaded_state", "self"),
        ("wtf_tpu_torch.devmut.corpus", "DeviceCorpus.restore", "self"),
    ],
    "wtf_tpu_torch.backend.gpu:GpuBackend": [
        ("wtf_tpu_torch.backend.gpu", "GpuBackend.coverage_state", "self"),
        ("wtf_tpu_torch.backend.gpu",
         "GpuBackend.restore_coverage_state", "self"),
    ],
    "wtf_tpu_torch.meshrun.backend:MeshBackend": [
        ("wtf_tpu_torch.backend.gpu", "GpuBackend.coverage_state", "self"),
        ("wtf_tpu_torch.backend.gpu",
         "GpuBackend.restore_coverage_state", "self"),
    ],
    f"{_SUP}:Supervisor": [
        (_SUP, "Supervisor.pre_batch", "self"),
        (_SUP, "Supervisor.recover", "self"),
    ],
    # the node-telemetry mixin checkpoints NOTHING by design —
    # every mutable attribute needs an explicit disposition
    "wtf_tpu_torch.dist.client:_NodeTelemetry": [],
    # the port's tenancy classes (wtf_tpu_torch/tenancy): a tenant's
    # checkpoint is save_tenant/restore_tenant, through the backend and
    # the tenant's runtime
    "wtf_tpu_torch.tenancy.backend:_TenancyMixin": [
        (_TEN, "save_tenant", "backend"),
        (_TEN, "restore_tenant", "backend"),
        ("wtf_tpu_torch.tenancy.backend",
         "_TenancyMixin.tenant_coverage_state", "self"),
        ("wtf_tpu_torch.tenancy.backend",
         "_TenancyMixin.restore_tenant_coverage", "self"),
    ],
    "wtf_tpu_torch.tenancy.loop:TenantRuntime": [
        (_TEN, "save_tenant", "rt"),
        (_TEN, "restore_tenant", "rt"),
    ],
}

# class site -> thread roots: each root is one real host-thread entry
# point (the function a thread starts in, or the surface another thread
# calls into), closed over self.method() calls but never into another
# root's entry functions.
THREAD_SURFACE: Dict[str, Dict[str, Sequence[str]]] = {
    # dispatcher thread vs the watchdog's threads (the bounded call's
    # waiter, the device drain)
    f"{_SUP}:Supervisor": {
        "dispatcher": ("dispatch",),
        "watchdog": ("_bounded_call.waiter", "_check_device.drain"),
    },
    # single-threaded selector reactor vs the drain surface, which the
    # SIGTERM handler or any embedding thread may call
    "wtf_tpu_torch.dist.server:Server": {
        "reactor": ("run",),
        "control": ("request_drain",),
    },
    # a soak worker thread owns its links; the reconnect path re-enters
    # the socket state from inside the serve loop
    "wtf_tpu_torch.dist.client:MasterLink": {
        "serve": ("connect", "recv_work", "send", "send_delta",
                  "send_telem", "close"),
        "reconnect": ("_reconnect",),
    },
    # megachunk window loop vs the pipelined-harvest prelaunch seam
    "wtf_tpu_torch.backend.gpu:GpuBackend": {
        "window": ("run_megachunk",),
        "prelaunch": ("_dispatch_window",),
    },
}

# transfer census subjects: steady-state programs whose device-to-host
# reads (rules.py's op census) are pinned in budgets.json under
# `host_transfer`
TRANSFER_ENTRY = "host_transfer"
TRANSFER_CENSUS_ENTRY = ("host reads of tensors (.item/.tolist/.cpu, "
                         "bool/int/float/index of a tensor) in the op "
                         "census's programs")


# ---------------------------------------------------------------------------
# contracts.json I/O + ratchet
# ---------------------------------------------------------------------------

def load_contracts(path: Optional[Path] = None) -> Dict:
    p = Path(path) if path else CONTRACTS_PATH
    if not p.exists():
        return {s: {} for s in SECTIONS}
    doc = json.loads(p.read_text())
    for s in SECTIONS:
        doc.setdefault(s, {})
    return doc


def save_contracts(contracts: Dict, path: Optional[Path] = None) -> Path:
    p = Path(path) if path else CONTRACTS_PATH
    p.write_text(json.dumps(contracts, indent=2, sort_keys=True) + "\n")
    return p


def _entry_keys(contracts: Dict) -> set:
    """Flat (section, owner, entry) key set — the ratchet's unit of
    growth.  Transfer rows key on their call kind."""
    keys = set()
    for cls, attrs in contracts.get("state", {}).items():
        for attr in attrs:
            keys.add(("state", cls, attr))
    for site, rows in contracts.get("transfer", {}).items():
        for row in rows:
            keys.add(("transfer", site, row.get("call")))
    for cls, attrs in contracts.get("thread", {}).items():
        for attr in attrs:
            keys.add(("thread", cls, attr))
    return keys


def apply_contracts_rebaseline(contracts: Dict, needed: Dict,
                               allow_regression: bool = False) -> Dict:
    """Merge regenerated contract tables over the checked-in ones — a
    RATCHET: entries that are no longer needed drop silently (every
    drop is a contract getting stronger), but a NEW entry is allowlist
    growth — a new undispositioned attribute, hidden coercion, or
    shared write — and is refused unless `allow_regression` names the
    act.  Existing reasons/dispositions are carried over; genuinely new
    entries land with whatever skeleton `needed` carries (empty reasons,
    which the contracts family keeps flagging until documented)."""
    grown = sorted(_entry_keys(needed) - _entry_keys(contracts))
    if grown and not allow_regression:
        what = ", ".join(f"{s}:{owner}.{entry}"
                         for s, owner, entry in grown[:6])
        more = f" (+{len(grown) - 6} more)" if len(grown) > 6 else ""
        raise ValueError(
            f"rebaseline would GROW the contract allowlist ({what}{more})"
            " — each new entry is a new undispositioned mutable "
            "attribute, hidden host coercion, or unlocked shared write; "
            "fix the code or document the disposition and re-run with "
            "--allow-regression")
    merged: Dict = {s: {} for s in SECTIONS}
    for cls, attrs in needed.get("state", {}).items():
        old = contracts.get("state", {}).get(cls, {})
        merged["state"][cls] = {
            attr: old.get(attr, skel) for attr, skel in attrs.items()}
    for site, rows in needed.get("transfer", {}).items():
        old_rows = {r.get("call"): r
                    for r in contracts.get("transfer", {}).get(site, [])}
        out = []
        for row in rows:
            kept = dict(old_rows.get(row["call"], row))
            kept["call"] = row["call"]
            kept["count"] = row["count"]
            out.append(kept)
        merged["transfer"][site] = out
    for cls, attrs in needed.get("thread", {}).items():
        old = contracts.get("thread", {}).get(cls, {})
        merged["thread"][cls] = {
            attr: old.get(attr, skel) for attr, skel in attrs.items()}
    # the documented differences from the JAX package's tables are
    # written by hand (tests/test_torch_lint.py holds them exact)
    merged["jax_differences"] = contracts.get("jax_differences", {})
    return merged


# ---------------------------------------------------------------------------
# tree analysis (pure AST — shared by all four families)
# ---------------------------------------------------------------------------

def _split_site(site: str) -> Tuple[str, str]:
    mod, _, cls = site.partition(":")
    return mod, cls


def analyze_state(surface: Optional[Dict] = None) -> Dict[str, Dict]:
    """Per class: the full write surface, the mutable subset (written
    outside __init__) with first-write provenance, and the covered set
    the extractors reach."""
    surface = STATE_SURFACE if surface is None else surface
    out: Dict[str, Dict] = {}
    for cls_site, extractors in surface.items():
        mod, cls = _split_site(cls_site)
        writes = flow.class_attribute_writes(mod, cls)
        mutable: Dict[str, Tuple[str, int]] = {}
        for attr, sites in writes.items():
            outside = [(m, ln) for m, ln in sites
                       if m not in ("__init__", "__post_init__")]
            if outside:
                mutable[attr] = min(outside, key=lambda s: s[1])
        covered = set()
        for ex_mod, ex_qual, ex_param in extractors:
            info = flow.function_index(ex_mod).get(ex_qual)
            if info is None:
                raise KeyError(
                    f"state extractor {ex_mod}:{ex_qual} not found "
                    f"(STATE_SURFACE for {cls_site})")
            covered |= flow.function_param_accesses(info, ex_param)
        out[cls_site] = {"writes": writes, "mutable": mutable,
                         "covered": covered,
                         "file": flow.module_file(mod)}
    return out


def analyze_transfer(sites: Optional[Dict[str, str]] = None) -> Dict:
    """Per seam site: measured coercion calls {kind: [lineno…]} plus
    file provenance.  Unresolvable sites are skipped — the supervise
    family owns that finding."""
    if sites is None:
        from wtf_tpu_torch.supervise import SEAM_SITES

        sites = SEAM_SITES
    out: Dict[str, Dict] = {}
    for site in sorted(set(sites.values())):
        try:
            info = flow.resolve_site(site)
        except Exception:
            continue
        calls: Dict[str, List[int]] = {}
        for kind, lineno in flow.coercion_calls(info.node):
            calls.setdefault(kind, []).append(lineno)
        out[site] = {"calls": calls, "file": info.file,
                     "lineno": info.lineno}
    return out


def analyze_thread(surface: Optional[Dict] = None) -> Dict[str, Dict]:
    """Per class: per-root access sets plus the shared-attribute set
    (written by one root, written or read by another)."""
    surface = THREAD_SURFACE if surface is None else surface
    out: Dict[str, Dict] = {}
    for cls_site, roots in surface.items():
        mod, cls = _split_site(cls_site)
        accesses = flow.thread_root_accesses(
            mod, cls, {r: list(q) for r, q in roots.items()})
        shared: Dict[str, Dict] = {}
        for root, acc in accesses.items():
            for attr, lines in acc["writes"].items():
                for other, oacc in accesses.items():
                    if other == root:
                        continue
                    if (attr in oacc["writes"]
                            or attr in oacc["reads"]):
                        entry = shared.setdefault(
                            attr, {"writers": {}, "line": min(lines)})
                        entry["writers"][root] = min(lines)
        out[cls_site] = {"accesses": accesses, "shared": shared,
                         "file": flow.module_file(mod)}
    return out


# ---------------------------------------------------------------------------
# the state family
# ---------------------------------------------------------------------------

def check_state_contracts(contracts: Optional[Dict] = None,
                          surface: Optional[Dict] = None,
                          analysis: Optional[Dict] = None
                          ) -> List[Finding]:
    """`state.uncheckpointed`: a mutable attribute with neither
    checkpoint coverage nor a declared disposition."""
    contracts = load_contracts() if contracts is None else contracts
    analysis = analyze_state(surface) if analysis is None else analysis
    table = contracts.get("state", {})
    findings: List[Finding] = []
    for cls_site in sorted(analysis):
        a = analysis[cls_site]
        declared = table.get(cls_site, {})
        for attr in sorted(a["mutable"]):
            if attr in a["covered"]:
                continue
            disp = declared.get(attr)
            if disp and disp.get("kind") in STATE_KINDS:
                continue
            method, lineno = a["mutable"][attr]
            findings.append(Finding(
                rule="state.uncheckpointed", entry=cls_site,
                primitive=attr, file=a["file"], line=lineno,
                message=(f"mutable attribute `{attr}` (written in "
                         f"{method}) is neither carried by the "
                         "checkpoint/restore/recovery field sets nor "
                         "declared derived/transient in contracts.json "
                         "— a resumed campaign would silently diverge; "
                         "checkpoint it or document the disposition")))
    return findings


# ---------------------------------------------------------------------------
# the transfer family
# ---------------------------------------------------------------------------

def check_transfer_seams(contracts: Optional[Dict] = None,
                         sites: Optional[Dict[str, str]] = None,
                         analysis: Optional[Dict] = None
                         ) -> List[Finding]:
    """`transfer.hidden-sync`: a host-coercion call inside a dispatch
    seam beyond what the harvest/readback allowlist declares."""
    contracts = load_contracts() if contracts is None else contracts
    analysis = analyze_transfer(sites) if analysis is None else analysis
    table = contracts.get("transfer", {})
    findings: List[Finding] = []
    for site in sorted(analysis):
        a = analysis[site]
        allowed = {row.get("call"): int(row.get("count", 0))
                   for row in table.get(site, [])}
        for kind in sorted(a["calls"]):
            lines = a["calls"][kind]
            if len(lines) <= allowed.get(kind, 0):
                continue
            over = sorted(lines)[allowed.get(kind, 0):]
            findings.append(Finding(
                rule="transfer.hidden-sync", entry=site, primitive=kind,
                count=len(lines), budget=allowed.get(kind, 0),
                file=a["file"], line=over[0],
                message=(f"{kind} coercion inside a dispatch seam "
                         "beyond the harvest/readback allowlist — a "
                         "hidden device->host sync here re-serializes "
                         "the zero-host steady state; batch the "
                         "readback through the documented harvest or "
                         "allowlist it with a reason")))
    return findings


def check_transfer_census(measured: Dict[str, int],
                          budget: Dict,
                          budgets_file: str = "budgets.json"
                          ) -> List[Finding]:
    """`transfer.census-drift`: a steady-state program's device-to-host
    read count exceeds the pin.  Lint only fails on growth; the pin
    follows a fall on --rebaseline."""
    findings: List[Finding] = []
    for prog in sorted(measured):
        if prog not in measured:
            continue
        pinned = budget.get(prog)
        if pinned is None or measured[prog] <= int(pinned):
            continue
        findings.append(Finding(
            rule="transfer.census-drift", entry=TRANSFER_ENTRY,
            primitive=prog, count=measured[prog], budget=int(pinned),
            file=budgets_file, line=1,
            message=("device-to-host reads grew in a steady-state "
                     "program — every one blocks the host on the card; "
                     "batch the read into an existing harvest or "
                     "re-baseline with the regression documented")))
    return findings


# ---------------------------------------------------------------------------
# the thread family
# ---------------------------------------------------------------------------

def check_thread_contracts(contracts: Optional[Dict] = None,
                           surface: Optional[Dict] = None,
                           analysis: Optional[Dict] = None
                           ) -> List[Finding]:
    """`thread.unlocked-shared-write`: an attribute written by one
    thread root and touched by another with no declared owner/lock."""
    contracts = load_contracts() if contracts is None else contracts
    analysis = analyze_thread(surface) if analysis is None else analysis
    table = contracts.get("thread", {})
    findings: List[Finding] = []
    for cls_site in sorted(analysis):
        a = analysis[cls_site]
        declared = table.get(cls_site, {})
        for attr in sorted(a["shared"]):
            entry = declared.get(attr)
            if entry and (entry.get("owner") or entry.get("lock")):
                continue
            writers = a["shared"][attr]["writers"]
            findings.append(Finding(
                rule="thread.unlocked-shared-write", entry=cls_site,
                primitive=attr, file=a["file"],
                line=a["shared"][attr]["line"],
                message=(f"`{attr}` is written from thread root(s) "
                         f"{sorted(writers)} and touched from another "
                         "root with no declared ownership/lock in "
                         "contracts.json — an unlocked cross-thread "
                         "write; serialize it or declare the owner "
                         "and discipline")))
    return findings


# ---------------------------------------------------------------------------
# the contracts family (table hygiene)
# ---------------------------------------------------------------------------

def check_contract_hygiene(contracts: Optional[Dict] = None,
                           state_analysis: Optional[Dict] = None,
                           transfer_analysis: Optional[Dict] = None,
                           thread_analysis: Optional[Dict] = None
                           ) -> List[Finding]:
    """The tables themselves under lint: `contracts.stale-entry` for
    rows naming deleted attributes/calls, `contracts.undocumented` for
    rows without a reason, `contracts.unknown-kind` for dispositions
    outside the vocabulary."""
    contracts = load_contracts() if contracts is None else contracts
    state_analysis = (analyze_state() if state_analysis is None
                      else state_analysis)
    transfer_analysis = (analyze_transfer() if transfer_analysis is None
                         else transfer_analysis)
    thread_analysis = (analyze_thread() if thread_analysis is None
                       else thread_analysis)
    findings: List[Finding] = []

    for cls_site in sorted(contracts.get("state", {})):
        entries = contracts["state"][cls_site]
        known = state_analysis.get(cls_site)
        for attr in sorted(entries):
            disp = entries[attr] or {}
            if known is None or attr not in known["writes"]:
                findings.append(Finding(
                    rule="contracts.stale-entry", entry=cls_site,
                    primitive=attr,
                    message=("contracts.json state entry names an "
                             "attribute no longer assigned on the class"
                             " — delete the row (stale allowlist rows "
                             "hide future regressions under a familiar "
                             "name)")))
                continue
            if disp.get("kind") not in STATE_KINDS:
                findings.append(Finding(
                    rule="contracts.unknown-kind", entry=cls_site,
                    primitive=attr,
                    message=(f"state disposition kind "
                             f"{disp.get('kind')!r} is not one of "
                             f"{list(STATE_KINDS)}")))
            if not str(disp.get("reason") or "").strip():
                findings.append(Finding(
                    rule="contracts.undocumented", entry=cls_site,
                    primitive=attr,
                    message=("state disposition has no reason — every "
                             "allowlist row must say WHY the attribute "
                             "may skip the checkpoint")))

    for site in sorted(contracts.get("transfer", {})):
        rows = contracts["transfer"][site]
        measured = transfer_analysis.get(site, {}).get("calls", {})
        for row in rows:
            kind = row.get("call")
            n = len(measured.get(kind, []))
            if site not in transfer_analysis or n == 0:
                findings.append(Finding(
                    rule="contracts.stale-entry", entry=site,
                    primitive=kind,
                    message=("transfer allowlist row matches no call in "
                             "the seam anymore — delete it")))
            elif n < int(row.get("count", 0)):
                findings.append(Finding(
                    rule="contracts.stale-entry", entry=site,
                    primitive=kind, count=n,
                    budget=int(row.get("count", 0)),
                    message=("transfer allowlist row allows more "
                             f"{kind} calls than the seam contains — "
                             "tighten the count (the ratchet only "
                             "tightens itself on --rebaseline)")))
            if not str(row.get("reason") or "").strip():
                findings.append(Finding(
                    rule="contracts.undocumented", entry=site,
                    primitive=kind,
                    message=("transfer allowlist row has no reason — "
                             "every allowed coercion must name its "
                             "harvest/readback purpose")))

    for cls_site in sorted(contracts.get("thread", {})):
        entries = contracts["thread"][cls_site]
        known = thread_analysis.get(cls_site)
        for attr in sorted(entries):
            row = entries[attr] or {}
            touched = known is not None and any(
                attr in acc["writes"] or attr in acc["reads"]
                for acc in known["accesses"].values())
            if not touched:
                findings.append(Finding(
                    rule="contracts.stale-entry", entry=cls_site,
                    primitive=attr,
                    message=("thread ownership row names an attribute "
                             "no thread root touches anymore — delete "
                             "it")))
                continue
            roots = set(known["accesses"]) | {"any"}
            if row.get("owner") not in roots:
                findings.append(Finding(
                    rule="contracts.unknown-kind", entry=cls_site,
                    primitive=attr,
                    message=(f"thread owner {row.get('owner')!r} is not "
                             f"a declared root of the class "
                             f"({sorted(set(known['accesses']))}) or "
                             "'any'")))
            if not str(row.get("reason") or "").strip():
                findings.append(Finding(
                    rule="contracts.undocumented", entry=cls_site,
                    primitive=attr,
                    message=("thread ownership row has no reason — "
                             "declare the lock/discipline that makes "
                             "the sharing safe")))

    # the documented differences from the JAX package's analyses:
    # {family: {class or seam site: {attribute or call: reason}}}
    for family, owners in sorted(contracts.get("jax_differences",
                                               {}).items()):
        for owner, rows in sorted(owners.items()):
            for name, reason in sorted(rows.items()):
                if not str(reason or "").strip():
                    findings.append(Finding(
                        rule="contracts.undocumented", entry=owner,
                        primitive=f"{family}:{name}",
                        message=("a difference from the JAX package's "
                                 "analysis without a reason — say why "
                                 "the port differs")))
    return findings


# ---------------------------------------------------------------------------
# rebaseline skeleton generation
# ---------------------------------------------------------------------------

def needed_contracts(state_analysis: Optional[Dict] = None,
                     transfer_analysis: Optional[Dict] = None,
                     thread_analysis: Optional[Dict] = None) -> Dict:
    """The minimal tables the current tree requires — what
    `--rebaseline` merges (under the growth ratchet) over the
    checked-in file.  New entries carry empty reasons on purpose."""
    state_analysis = (analyze_state() if state_analysis is None
                      else state_analysis)
    transfer_analysis = (analyze_transfer() if transfer_analysis is None
                         else transfer_analysis)
    thread_analysis = (analyze_thread() if thread_analysis is None
                       else thread_analysis)
    needed: Dict = {"state": {}, "transfer": {}, "thread": {}}
    for cls_site, a in state_analysis.items():
        attrs = {attr: {"kind": "transient", "reason": ""}
                 for attr in sorted(a["mutable"])
                 if attr not in a["covered"]}
        if attrs:
            needed["state"][cls_site] = attrs
    for site, a in transfer_analysis.items():
        rows = [{"call": kind, "count": len(lines), "reason": ""}
                for kind, lines in sorted(a["calls"].items())]
        if rows:
            needed["transfer"][site] = rows
    for cls_site, a in thread_analysis.items():
        attrs = {attr: {"owner": "", "reason": ""}
                 for attr in sorted(a["shared"])}
        if attrs:
            needed["thread"][cls_site] = attrs
    return needed
