"""The rule engine of the port's lint: its families of static checks.

The counterpart of wtf_tpu/analysis/rules.py, with the JAX package's
FAMILIES names.  The AST families are copies run over the port's tree;
the families that read XLA programs are rebuilt over what an eager
PyTorch program has instead:

  budget    an op census of the steady-state programs: the ops that
            torch.profiler records, run on the CPU at fixed seeds (top
            level only — an op's own internals do not count — and K1 as
            ONE op per launch, its plain version's insides excluded, as
            the JAX pin counts a `pallas-call` once), and the host reads
            of tensors inside them (`.item()`, `.tolist()`, `.cpu()`,
            `bool()`/`int()`/`float()`/indexing of a tensor — each a
            blocking device-to-host copy on a card).  Pinned exactly in
            analysis/budgets.json at the JAX pin's entries and configs:
            `xla_step` (the precise step's 64-step run chunk, demo_tlv,
            4 lanes), `tenant_chunk` (16 steps over a demo_tlv +
            demo_kernel stacked image), `megachunk_window_fused` (one
            two-batch devmangle window with the fused step) and
            `decode_service` (one device-decode round).  Plus the triage
            replay pin: ReplayCore runs the Runner's own dispatch seams
  mesh      the cross-shard gathers of one mesh chunk (meshrun/reduce.py's
            `gather_shards`, meshrun/mesh.py's `gather_processes`) on a
            CPU mesh of 8 shards x 2 lanes, pinned as `mesh_chunk`: one
            gather of every shard's coverage union, then a local OR — the
            JAX pin's one coverage all-reduce
  parity    the fused-subset contract between K1 (its CUDA source and
            its plain version) and step.py (analysis/parity.py)
  supervise every device dispatch entry point routes through the
            Supervisor — seam routing + enumeration completeness over
            supervise.SEAM_SITES
  telemetry no dispatch seam serializes the metric registry inline
  state, transfer, thread, contracts
            the dataflow contract families (analysis/contracts.py on the
            engine in analysis/flow.py) against analysis/contracts.json;
            the transfer family also pins the census's host reads per
            program under budgets.json's `host_transfer` entry

`dtype` and `recompile` have no counterpart (NO_COUNTERPART): they are
rules about XLA programs — u64 limb arithmetic in the ported integer
core, and jit signature stability and buffer donation — and the port
computes in int64 with eager PyTorch, which has no traced program to
hold them against.  Selecting either is refused with its reason.

`run_lint` orchestrates the families and reports Findings; helpers are
public so tests can seed violations directly.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import Counter
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from wtf_tpu_torch.analysis.findings import Finding
from wtf_tpu_torch.analysis.parity import check_fused_parity

BUDGETS_PATH = Path(__file__).with_name("budgets.json")

FAMILIES = ("dtype", "budget", "recompile", "parity", "mesh", "supervise",
            "telemetry", "state", "transfer", "thread", "contracts")
NO_COUNTERPART = {
    "dtype": ("the JAX rule pins zero u64 ops in traced XLA programs of "
              "the u32-limb integer core; the port computes in int64 "
              "with eager PyTorch and traces no program"),
    "recompile": ("the JAX rule pins jit signature stability and buffer "
                  "donation of compiled XLA programs; the port runs eager "
                  "PyTorch, which compiles no program"),
}
PORTED_FAMILIES = tuple(f for f in FAMILIES if f not in NO_COUNTERPART)

# families that (re)write budgets.json vs contracts.json on --rebaseline
_BUDGET_FAMILIES = frozenset(("budget", "mesh", "transfer"))
_CONTRACT_FAMILIES = frozenset(("state", "transfer", "thread"))

# the census programs, at the JAX budget entries' configurations; every
# program runs from a fixed seed, so its counts are exact
BUDGET_ENTRY = "xla_step"
BUDGET_CONFIG = dict(n_lanes=4, chunk_steps=64, n_steps=64)
# sixteen 10-byte TLV records: every lane runs all 64 steps
CENSUS_PAYLOAD = b"\x01\x08AAAAAAAA" * 16
TENANT_ENTRY = "tenant_chunk"
TENANT_CONFIG = dict(n_steps=16, quotas=(2, 2),
                     order=("demo_tlv", "demo_kernel"),
                     uop_capacity=1 << 10, overlay_slots=8, edge_bits=12)
MEGA_ENTRY = "megachunk_window_fused"
MEGA_CONFIG = dict(n_lanes=4, max_batches=2, limit=10_000, seed=0x77F)
DECODE_ENTRY = "decode_service"
CENSUS_PROGRAMS = (BUDGET_ENTRY, TENANT_ENTRY, MEGA_ENTRY, DECODE_ENTRY)

MESH_ENTRY = "mesh_chunk"
MESH_DEVICES = 8
MESH_CONFIG = dict(n_steps=16, lanes_per_shard=2,
                   uop_capacity=1 << 10, overlay_slots=8, edge_bits=12)

# the op name K1 counts under (one per launch, on a card and on the CPU),
# and the name of its kernel in a card's trace (csrc/fused_step.cu)
K1_OP = "wtf_tpu_torch::fused_step"
K1_KERNEL = "fused_step_kernel"
# Tensor methods that read a tensor's value on the host; on a CUDA
# tensor each is a blocking device-to-host copy
HOST_READS = frozenset(("item", "tolist", "cpu", "__bool__", "__int__",
                        "__float__", "__index__"))
TOP_OPS = 8


# ---------------------------------------------------------------------------
# the op census (budget family)
# ---------------------------------------------------------------------------

def _host_read_mode():
    """A TorchFunctionMode counting HOST_READS calls on tensors."""
    from torch.overrides import TorchFunctionMode

    class HostReads(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") in HOST_READS:
                self.n += 1
            return func(*args, **(kwargs or {}))

    return HostReads()


@contextmanager
def _k1_as_one_op(prof, plain: bool):
    """K1 under the census: each `pstep.fused_step` call counts as ONE
    K1_OP op (yielded dict).  Its plain version (`plain`: the census runs
    on the CPU) is left out of the record — the profiler's CPU collection
    and the host-read mode are off while it runs — as a launch on a card
    records nothing inside the kernel."""
    import torch
    from torch.profiler import ProfilerActivity

    from wtf_tpu_torch.interp import pstep

    inner = pstep.fused_step
    calls = {K1_OP: 0}

    def fused_step(*args, **kwargs):
        calls[K1_OP] += 1
        if not plain:
            return inner(*args, **kwargs)
        prof.toggle_collection_dynamic(False, [ProfilerActivity.CPU])
        try:
            with torch._C.DisableTorchFunction():
                return inner(*args, **kwargs)
        finally:
            prof.toggle_collection_dynamic(True, [ProfilerActivity.CPU])

    pstep.fused_step = fused_step
    try:
        yield calls
    finally:
        pstep.fused_step = inner


def _top_level(events) -> Counter:
    """Top-level aten ops of a profiler session: the aten events no
    other aten event on the same thread encloses (read from the raw
    kineto events — building the profiler's FunctionEvent tree costs
    ~60 us an event)."""
    rows = []
    for e in events:
        name = e.name()
        if name.startswith("aten::"):
            rows.append((e.start_ns(), -e.duration_ns(), name,
                         e.start_thread_id()))
    rows.sort()
    ops: Counter = Counter()
    reach: Dict[int, int] = {}
    for start, neg_dur, name, tid in rows:
        if start >= reach.get(tid, -1):
            ops[name] += 1
            reach[tid] = start - neg_dur
    return ops


def op_census(fn: Callable[[], object], device="cpu") -> Dict:
    """Run `fn` once under torch.profiler and count what it dispatched:
    `total` top-level ops (aten ops and K1; an op's internals are its
    own), `top` the most frequent names, `fused_step` K1's launches and
    `host_reads` the tensor reads on the host.  On a CUDA device also
    `cuda_launches` (kernels in the trace's device activity), `k1_kernels`
    (K1's among them) and `memcpy_dtoh` (device-to-host copies)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    reads = _host_read_mode()
    with profile(activities=activities) as prof, \
            _k1_as_one_op(prof, dev.type == "cpu") as k1:
        with reads:
            fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    events = prof.profiler.kineto_results.events()
    ops = _top_level(e for e in events
                     if e.device_type() == torch.autograd.DeviceType.CPU)
    ops.update(k1)
    out = {"total": sum(ops.values()),
           "top": dict(sorted(ops.most_common(TOP_OPS),
                              key=lambda kv: (-kv[1], kv[0]))),
           "fused_step": k1[K1_OP], "host_reads": reads.n}
    if dev.type == "cuda":
        launches = dtoh = k1 = 0
        for e in events:
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            name = e.name()
            if "DtoH" in name:
                dtoh += 1
            elif not name.startswith(("Memcpy", "Memset")):
                launches += 1
                k1 += K1_KERNEL in name
        out["cuda_launches"] = launches
        out["memcpy_dtoh"] = dtoh
        out["k1_kernels"] = k1
    return out


def _census_xla_step(device) -> Callable:
    from wtf_tpu_torch.analysis.trace import build_tlv_runner
    from wtf_tpu_torch.interp.step import run_steps

    cfg = BUDGET_CONFIG
    runner = build_tlv_runner(n_lanes=cfg["n_lanes"],
                              chunk_steps=cfg["chunk_steps"],
                              payload=CENSUS_PAYLOAD, device=device)
    tab = runner.device_tab()
    return lambda: run_steps(tab, runner.image, runner.machine, 1 << 40,
                             cfg["n_steps"])


def _census_tenant_chunk(device) -> Callable:
    from wtf_tpu_torch.analysis.trace import build_tenant_runner
    from wtf_tpu_torch.interp.step import run_steps

    cfg = TENANT_CONFIG
    runner = build_tenant_runner(
        quotas=cfg["quotas"], order=cfg["order"],
        chunk_steps=cfg["n_steps"], uop_capacity=cfg["uop_capacity"],
        overlay_slots=cfg["overlay_slots"], edge_bits=cfg["edge_bits"],
        device=device)
    runner.limit = 20_000
    # one batch to the end warms the decode cache through the host
    # services; the census chunk then runs from the restored snapshot
    runner.run()
    runner.restore()
    tab = runner.device_tab()
    return lambda: run_steps(tab, runner.image, runner.machine, 1 << 40,
                             cfg["n_steps"])


def _census_megachunk(device) -> Callable:
    from wtf_tpu_torch.analysis.trace import build_tlv_campaign

    cfg = MEGA_CONFIG
    loop = build_tlv_campaign(n_lanes=cfg["n_lanes"], mutator="devmangle",
                              limit=cfg["limit"], seed=cfg["seed"],
                              megachunk=cfg["max_batches"],
                              fused_step="on", device=device)
    # a first window warms the decode cache; the census takes the second
    loop.fuzz(cfg["n_lanes"] * cfg["max_batches"])
    n = cfg["max_batches"]
    return lambda: loop.backend.run_megachunk(loop.mutator, loop.target,
                                              n, n)


def _census_decode_service(device) -> Callable:
    import torch

    from wtf_tpu_torch.analysis.trace import build_tlv_runner
    from wtf_tpu_torch.interp import devdec
    from wtf_tpu_torch.interp.step import run_steps

    runner = build_tlv_runner(n_lanes=BUDGET_CONFIG["n_lanes"],
                              chunk_steps=16, payload=None, device=device)
    # one step on the cold cache leaves every lane at NEED_DECODE
    run_steps(runner.device_tab(), runner.image, runner.machine, 1 << 40, 1)
    tab, m = runner.device_tab(), runner.machine
    bp_keys = torch.zeros(8, dtype=torch.int64, device=m.device)

    def service():
        blocks = devdec.compute_blocks(tab, runner.image, m, bp_keys, 0)
        return devdec.commit_blocks(tab, runner.cache.count, blocks,
                                    m.status, runner.cache.capacity)

    return service


CENSUS_SETUPS = {
    BUDGET_ENTRY: (_census_xla_step,
                   "run_steps(64) / demo_tlv / n_lanes=4"),
    TENANT_ENTRY: (_census_tenant_chunk,
                   "run_steps(16) / demo_tlv+demo_kernel / quotas=[2, 2]"),
    MEGA_ENTRY: (_census_megachunk,
                 "run_megachunk(max_batches=2, fused_step=on) / demo_tlv /"
                 " n_lanes=4"),
    DECODE_ENTRY: (_census_decode_service,
                   "decode_service(1 round) / demo_tlv / n_lanes=4"),
}


def measure_census(programs: Sequence[str] = CENSUS_PROGRAMS,
                   device="cpu") -> Dict[str, Dict]:
    """The op census of each program, built and run on `device` from
    fixed seeds."""
    out = {}
    for name in programs:
        build, entry = CENSUS_SETUPS[name]
        out[name] = {"entry": entry, **op_census(build(device), device)}
    return out


def census_subprocess(programs: Sequence[str] = CENSUS_PROGRAMS,
                      device="cpu") -> Dict[str, Dict]:
    """measure_census in a child interpreter on one torch thread, so a
    census never competes with its caller's threads (the counts do not
    depend on threads; the wall does)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    code = ("import json, sys, torch; torch.set_num_threads(1); "
            "from wtf_tpu_torch.analysis.rules import measure_census; "
            "print(json.dumps(measure_census(sys.argv[1].split(','), "
            "sys.argv[2])))")
    proc = subprocess.run(
        [sys.executable, "-c", code, ",".join(programs), str(device)],
        env=env, capture_output=True, text=True, timeout=1800,
        cwd=str(Path(__file__).resolve().parents[2]))
    line = next((ln for ln in reversed(proc.stdout.splitlines())
                 if ln.startswith("{")), None)
    if proc.returncode != 0 or line is None:
        raise RuntimeError(f"op census subprocess failed (rc="
                           f"{proc.returncode}): "
                           f"{(proc.stderr or proc.stdout)[-400:]}")
    return json.loads(line)


def pinned_counts(census: Dict) -> Dict:
    """The pinned part of one program's census: its CPU counts."""
    return {k: census[k] for k in ("entry", "total", "top", "fused_step",
                                   "host_reads")}


def check_budget(counts: Dict, budget: Dict, entry: str) -> List[Finding]:
    """Exact pin: any drift (up OR down) of the total, K1's launches,
    the host reads or a pinned top op is a finding — an improvement is
    re-baselined consciously, a regression explained or fixed."""
    findings = []
    keys = [("total", counts.get("total", 0), budget.get("total")),
            ("fused_step", counts.get("fused_step", 0),
             budget.get("fused_step")),
            ("host_reads", counts.get("host_reads", 0),
             budget.get("host_reads"))]
    for name, want in sorted((budget.get("top") or {}).items()):
        keys.append((name, (counts.get("top") or {}).get(name, 0), want))
    for name, got, want in keys:
        if want is None or got == want:
            continue
        direction = "over" if got > want else "under"
        findings.append(Finding(
            rule="budget.op-count", entry=entry, primitive=name,
            count=got, budget=want,
            message=(f"`{name}` count {direction} the checked-in op census "
                     "— if the change is intentional, re-baseline with "
                     "`python -m wtf_tpu_torch lint --rebaseline` and "
                     "record why in PERF.md")))
    return findings


def check_triage_chunk() -> List[Finding]:
    """The triage replay core must run the campaign's own dispatch seams
    (Runner.run and its chunk/K1/resume executors, whose ops the census
    counts), never a private program of its own."""
    from wtf_tpu_torch.triage import replay as TR

    private = [name for name in ("_chunk", "_k1", "_resume_leg",
                                 "_fused_dispatch", "device_tab")
               if name in vars(TR.ReplayCore)]
    if not private:
        return []
    return [Finding(
        rule="budget.triage-chunk", entry="triage.replay.ReplayCore",
        primitive=", ".join(private),
        message=("ReplayCore overrides the Runner dispatch seam — triage "
                 "batches must run the campaign's own executors (the "
                 "census's programs), not a private one"))]


def apply_rebaseline(budgets: Dict, measured: Dict,
                     allow_regression: bool = False) -> Dict:
    """Merge freshly measured entries over the checked-in ones —
    RATCHETED: an entry whose `total` INCREASED is refused (ValueError
    naming every offender) unless `allow_regression`.  Pure, so tests
    can pin the ratchet without running a census."""
    regressions = [
        (name, budgets[name].get("total"), entry.get("total"))
        for name, entry in measured.items()
        if name in budgets
        and entry.get("total", 0) > budgets[name].get("total", 0)]
    if regressions and not allow_regression:
        detail = ", ".join(f"{n}: {old} -> {new}"
                           for n, old, new in regressions)
        raise ValueError(
            f"--rebaseline would RAISE an op/gather budget ({detail}); "
            f"the pin is a ratchet — re-run with --allow-regression and "
            f"record why in PERF.md, or fix the regression")
    merged = dict(budgets)
    merged.update(measured)
    return merged


def load_budgets(path: Optional[Path] = None) -> Dict:
    path = Path(path) if path else BUDGETS_PATH
    return json.loads(path.read_text()) if path.exists() else {}


def save_budgets(budgets: Dict, path: Optional[Path] = None) -> Path:
    path = Path(path) if path else BUDGETS_PATH
    path.write_text(json.dumps(budgets, indent=2, sort_keys=True) + "\n")
    return path


# ---------------------------------------------------------------------------
# mesh family
# ---------------------------------------------------------------------------

@contextmanager
def count_gathers():
    """Count the cross-shard gathers (meshrun/reduce.py `gather_shards`,
    meshrun/mesh.py `gather_processes`) made inside the block."""
    from wtf_tpu_torch.meshrun import mesh as MM
    from wtf_tpu_torch.meshrun import reduce as MR

    counts = {"gather_shards": 0, "gather_processes": 0}
    saved = (MR.gather_shards, MM.gather_processes)

    def wrap(name, fn):
        def counted(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return counted

    MR.gather_shards = wrap("gather_shards", saved[0])
    MM.gather_processes = wrap("gather_processes", saved[1])
    try:
        yield counts
    finally:
        MR.gather_shards, MM.gather_processes = saved


def measure_mesh_chunk(n_shards: int = MESH_DEVICES,
                       device="cpu") -> Dict:
    """The gathers of one mesh chunk (make_mesh_chunk) over `n_shards`
    shards of MESH_CONFIG's lanes on `device`."""
    from wtf_tpu_torch.analysis.trace import build_tlv_runner
    from wtf_tpu_torch.meshrun.executor import make_mesh_chunk
    from wtf_tpu_torch.meshrun.mesh import (
        LaneMesh, replicate, shard_image, shard_machine,
    )
    import torch

    cfg = MESH_CONFIG
    runner = build_tlv_runner(
        n_lanes=cfg["lanes_per_shard"] * n_shards,
        chunk_steps=cfg["n_steps"], uop_capacity=cfg["uop_capacity"],
        overlay_slots=cfg["overlay_slots"], edge_bits=cfg["edge_bits"],
        device=device)
    mesh = LaneMesh([torch.device(device)] * n_shards)
    shards = shard_machine(runner.machine, mesh)
    images = shard_image(runner.image, mesh)
    tab = replicate(runner.device_tab(), mesh)
    chunk = make_mesh_chunk(cfg["n_steps"], mesh)
    with count_gathers() as counts:
        chunk(tab, images, shards, 1 << 40)
    return {**counts, "total": counts["gather_shards"]}


def check_mesh_gathers(counts: Dict, budget: Dict,
                       entry: str) -> List[Finding]:
    """Exact pin against budgets.json's `mesh_chunk` entry: the chunk's
    only cross-shard traffic is the one gather of the coverage unions."""
    findings = []
    for name in ("gather_shards", "gather_processes", "total"):
        got, want = counts.get(name, 0), budget.get(name)
        if want is None or got == want:
            continue
        direction = "over" if got > want else "under"
        findings.append(Finding(
            rule="mesh.collectives", entry=entry, primitive=name,
            count=got, budget=want,
            message=(f"cross-shard `{name}` count {direction} the checked-in"
                     " mesh budget — the chunk's only gather is the "
                     "coverage union's; anything else moves machine state "
                     "between shards.  If intentional, re-baseline and "
                     "record why in PERF.md")))
    return findings


# ---------------------------------------------------------------------------
# supervise + telemetry families (AST, copied)
# ---------------------------------------------------------------------------

def check_supervised_seams(sites: Optional[Dict[str, str]] = None
                           ) -> List[Finding]:
    """Every device dispatch entry point must route through the
    supervisor: each supervise.SEAM_SITES site must contain a
    `supervisor.dispatch("<seam>"...)` routing call (AST-level, on the
    shared engine).  `sites` parameterizes the enumeration for tests."""
    from wtf_tpu_torch.analysis import flow

    if sites is None:
        from wtf_tpu_torch.supervise import SEAM_SITES

        sites = SEAM_SITES
    findings: List[Finding] = []
    for seam, site in sorted(sites.items()):
        try:
            info = flow.resolve_site(site)
        except Exception as e:  # unresolvable site IS the finding
            findings.append(Finding(
                rule="supervise.seam-routing", entry=site, primitive=seam,
                message=(f"supervised seam site unresolvable ({e}) — "
                         "supervise.SEAM_SITES must name the live "
                         "module:Class.method of every dispatch seam")))
            continue
        if seam not in flow.dispatch_seams(info.node):
            findings.append(Finding(
                rule="supervise.seam-routing", entry=site, primitive=seam,
                file=info.file, line=info.lineno,
                message=(f"dispatch seam {seam!r} does not route through "
                         "Supervisor.dispatch — a hang/error/poison here "
                         "would bypass watchdog + rebuild-and-replay "
                         "recovery; route the call or update "
                         "supervise.SEAM_SITES")))
    return findings


def check_telemetry_seams(sites: Optional[Dict[str, str]] = None
                          ) -> List[Finding]:
    """No supervised dispatch seam may serialize the metric registry
    inline (`.snapshot()`, `encode_telem`, `render_prometheus`,
    `json.dumps`): the seams run per chunk, serialization rides the
    heartbeat/TAG_TELEM cadence.  `sites` parameterizes for tests."""
    from wtf_tpu_torch.analysis import flow

    if sites is None:
        from wtf_tpu_torch.supervise import SEAM_SITES

        sites = SEAM_SITES
    findings: List[Finding] = []
    for seam, site in sorted(sites.items()):
        try:
            info = flow.resolve_site(site)
        except Exception:
            continue   # the supervise family's finding
        calls = flow.serialization_calls(info.node)
        if calls:
            hits = sorted({pat for pat, _ in calls})
            findings.append(Finding(
                rule="telemetry.seam-serialization", entry=site,
                primitive=f"{seam}: {', '.join(hits)}",
                count=len(hits), file=info.file,
                line=min(ln for _, ln in calls),
                message=("dispatch seam serializes telemetry inline — "
                         "registry snapshots / telem encoding are "
                         "O(registry)+JSON and this seam runs per chunk; "
                         "move the serialization to the heartbeat or "
                         "TAG_TELEM cadence (counter bumps stay, "
                         "serialization goes)")))
    return findings


def check_seam_enumeration() -> List[Finding]:
    """Completeness of the export hook: the known dispatch seams must
    each be claimed by some SEAM_SITES entry."""
    from wtf_tpu_torch.supervise import SEAM_SITES

    required = {"chunk", "fused", "fused-resume", "device-insert",
                "devmut-generate", "megachunk", "device-decode"}
    return [Finding(
        rule="supervise.seam-enumeration", entry="supervise.SEAM_SITES",
        primitive=seam,
        message=(f"dispatch seam {seam!r} dropped from "
                 "supervise.SEAM_SITES — the routing rule no longer "
                 "covers it"))
        for seam in sorted(required - set(SEAM_SITES))]


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------

def _select(families: Optional[Sequence[str]]) -> List[str]:
    if not families:
        return list(PORTED_FAMILIES)
    families = list(families)
    unknown = set(families) - set(FAMILIES)
    if unknown:
        raise ValueError(f"unknown lint families: {sorted(unknown)} "
                         f"(known: {list(FAMILIES)})")
    for fam in families:
        if fam in NO_COUNTERPART:
            raise ValueError(f"family {fam!r} has no counterpart in the "
                             f"port: {NO_COUNTERPART[fam]}")
    return families


def run_lint(families: Optional[Sequence[str]] = None,
             budgets_path: Optional[Path] = None,
             rebaseline: bool = False,
             allow_regression: bool = False,
             deep: bool = False,
             contracts_path: Optional[Path] = None,
             device: str = "cuda",
             registry=None, events=None) -> Tuple[List[Finding], Dict]:
    """Run the requested families (default: every ported one) against
    the real tree.  The census always runs on the CPU in a child process
    (what the pins hold); on a CUDA `device` (the default, which raises
    without a card when a family runs programs) it runs there as well
    and its launches and device-to-host copies ride along in `info`.
    Returns (findings, info); wires results into the telemetry registry
    under `analysis.*` and emits one `lint-finding` event per finding.

    `deep` makes the transfer family pin the census's host reads even
    when the budget family (whose census it reuses) is not selected.
    Both tables are RATCHETS: --rebaseline refuses growth without
    `allow_regression`."""
    from wtf_tpu_torch.telemetry import NULL, Registry

    registry = registry if registry is not None else Registry()
    events = events if events is not None else NULL
    families = _select(families)
    if rebaseline and not (_BUDGET_FAMILIES
                           | _CONTRACT_FAMILIES) & set(families):
        raise ValueError(
            "--rebaseline rewrites the op/gather budgets and the contract "
            "tables, which only the budget/mesh/transfer and "
            "state/transfer/thread families measure — drop the families "
            "filter or include one of them")
    findings: List[Finding] = []
    info: Dict = {"families": families, "seconds": {}, "entries": []}
    measured_budgets: Dict[str, Dict] = {}
    budgets = load_budgets(budgets_path)

    needs_census = "budget" in families or ("transfer" in families
                                            and (deep or rebaseline))
    if needs_census or "mesh" in families:
        from wtf_tpu_torch.device import resolve_device

        device = resolve_device(device)
    census = None
    if needs_census:
        from concurrent.futures import ThreadPoolExecutor

        t0 = time.time()
        with ThreadPoolExecutor(1) as pool:
            # the pinned CPU census in its child process, beside the
            # card's census in this one
            cpu = pool.submit(census_subprocess)
            if device.type != "cpu":
                info["device_census"] = measure_census(device=str(device))
            census = cpu.result()
        info["census"] = census
        info["seconds"]["census"] = round(time.time() - t0, 1)

    if "budget" in families:
        t0 = time.time()
        for name in CENSUS_PROGRAMS:
            counts = pinned_counts(census[name])
            info["entries"].append(f"{name}: {counts['entry']}")
            if rebaseline:
                measured_budgets[name] = counts
            else:
                findings.extend(check_budget(
                    counts, budgets.get(name, {}), entry=name))
            registry.gauge("analysis.op_count").labels(name).set(
                counts["total"])
        findings.extend(check_triage_chunk())
        info["seconds"]["budget"] = round(time.time() - t0, 1)

    if "parity" in families:
        t0 = time.time()
        findings.extend(check_fused_parity())
        info["seconds"]["parity"] = round(time.time() - t0, 1)
        info["entries"].append(
            "csrc/fused_step.cu:hot + fused_step_plain vs step.unsupported")

    if "mesh" in families:
        t0 = time.time()
        counts = measure_mesh_chunk()
        entry = (f"make_mesh_chunk({MESH_CONFIG['n_steps']}) / demo_tlv / "
                 f"{MESH_DEVICES} shards x "
                 f"{MESH_CONFIG['lanes_per_shard']} lanes (cpu)")
        info["mesh_gathers"] = counts
        info["entries"].append(entry)
        if rebaseline:
            measured_budgets[MESH_ENTRY] = {"entry": entry, **counts}
        else:
            findings.extend(check_mesh_gathers(
                counts, budgets.get(MESH_ENTRY, {}), entry=entry))
        for name, value in counts.items():
            registry.gauge("analysis.mesh_gathers").labels(name).set(value)
        info["seconds"]["mesh"] = round(time.time() - t0, 1)

    if "supervise" in families:
        t0 = time.time()
        findings.extend(check_supervised_seams())
        findings.extend(check_seam_enumeration())
        from wtf_tpu_torch.supervise import SEAM_SITES

        info["entries"].append(
            f"supervise.SEAM_SITES ({len(SEAM_SITES)} seams)")
        info["seconds"]["supervise"] = round(time.time() - t0, 1)

    if "telemetry" in families:
        t0 = time.time()
        findings.extend(check_telemetry_seams())
        from wtf_tpu_torch.supervise import SEAM_SITES

        info["entries"].append(
            f"telemetry over SEAM_SITES ({len(SEAM_SITES)} seams)")
        info["seconds"]["telemetry"] = round(time.time() - t0, 1)

    contract_fams = ({"state", "transfer", "thread", "contracts"}
                     & set(families))
    if contract_fams:
        from wtf_tpu_torch.analysis import contracts as CT

        t0 = time.time()
        con = CT.load_contracts(contracts_path)
        state_a = CT.analyze_state()
        transfer_a = CT.analyze_transfer()
        thread_a = CT.analyze_thread()
        info["seconds"]["contract-analysis"] = round(time.time() - t0, 1)

        if "state" in families:
            if not rebaseline:
                findings.extend(CT.check_state_contracts(
                    con, analysis=state_a))
            n_mut = sum(len(a["mutable"]) for a in state_a.values())
            n_cov = sum(len(set(a["mutable"]) & a["covered"])
                        for a in state_a.values())
            registry.gauge("analysis.state_attrs").labels(
                "mutable").set(n_mut)
            registry.gauge("analysis.state_attrs").labels(
                "covered").set(n_cov)
            info["entries"].append(
                f"state surface ({len(state_a)} classes, "
                f"{n_mut} mutable attrs)")

        if "transfer" in families:
            if not rebaseline:
                findings.extend(CT.check_transfer_seams(
                    con, analysis=transfer_a))
            if census is not None:
                reads = {name: census[name]["host_reads"]
                         for name in CENSUS_PROGRAMS}
                reads["total"] = sum(reads.values())
                info["transfer_census"] = reads
                for name, value in reads.items():
                    registry.gauge("analysis.transfer_census").labels(
                        name).set(value)
                if rebaseline:
                    measured_budgets[CT.TRANSFER_ENTRY] = {
                        "entry": CT.TRANSFER_CENSUS_ENTRY, **reads}
                else:
                    findings.extend(CT.check_transfer_census(
                        reads, budgets.get(CT.TRANSFER_ENTRY, {}),
                        budgets_file=str(budgets_path or BUDGETS_PATH)))
            info["entries"].append(
                "transfer over SEAM_SITES"
                + (" + census host reads" if census is not None else ""))

        if "thread" in families:
            if not rebaseline:
                findings.extend(CT.check_thread_contracts(
                    con, analysis=thread_a))
            n_shared = sum(len(a["shared"]) for a in thread_a.values())
            registry.gauge("analysis.thread_shared_attrs").set(n_shared)
            info["entries"].append(
                f"thread roots ({len(thread_a)} classes, "
                f"{n_shared} shared attrs)")

        if "contracts" in families:
            if not rebaseline:
                findings.extend(CT.check_contract_hygiene(
                    con, state_a, transfer_a, thread_a))
            for section in CT.SECTIONS:
                n = sum(len(v) for v in con.get(section, {}).values())
                registry.gauge("analysis.contract_entries").labels(
                    section).set(n)
            info["entries"].append("contracts.json hygiene")

        if rebaseline and _CONTRACT_FAMILIES & set(families):
            needed = CT.needed_contracts(state_a, transfer_a, thread_a)
            merged = CT.apply_contracts_rebaseline(
                con, needed, allow_regression=allow_regression)
            info["contracts_written"] = str(
                CT.save_contracts(merged, contracts_path))
        info["seconds"]["contracts"] = round(time.time() - t0, 1)

    if rebaseline and measured_budgets:
        merged = apply_rebaseline(budgets, measured_budgets,
                                  allow_regression=allow_regression)
        info["budgets_written"] = str(save_budgets(merged, budgets_path))

    registry.gauge("analysis.families_run").set(len(families))
    for f in findings:
        registry.counter("analysis.findings").labels(f.rule).inc()
        events.emit("lint-finding", **f.as_dict())
    info["n_findings"] = len(findings)
    return findings, info
