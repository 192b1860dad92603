#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (wtf_tpu_torch) end to end on one NVIDIA card.

    python3 chip_smoke.py            # every phase, on cuda:0

Phases (each prints one line; any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi); build both hand-written
     kernels from csrc/ (one nvcc each, started together)
  2. launch the availability probe kernel (K2) and check it returns 1
  3. the fused step kernel (K1) against its plain PyTorch version at 4096
     lanes, k=32, on seeded random machines (hot register grids, memory and
     stack forms, page crossings, park causes, a breakpoint with bp_skip,
     full overlays, the instruction budget): all 13 planes bit-identical
  4. `run --name demo_tlv` on a crashing type-3 record, on the card and on
     --device cpu: the same crash name, rip and icount
  5. the main path: `campaign --name demo_tlv --fused-step on --lanes 4096
     --runs 16384 --limit 20000 --max_len 96 --seed 5` on the card, with
     every kernel's launch count zeroed just before and read just after;
     K1 must have launched, fused occupancy must be >= 0.95 and every lane
     must end terminal.  Then K1's time per dispatch on a main-path state
     (CUDA events), its plain version's time, and a bit-identity check
     there; then the same campaign again under torch.profiler, for the
     card's busy time (the union of its kernel and copy intervals) and
     so the host's share of the first run's wall
  6. a 64-lane, 256-run campaign at the same seed on the card and on the
     CPU: equal corpus digests, crash names and coverage/edge bitmaps

Every phase always runs, at the sizes above.  The card's nvidia-smi line
comes before the last, the kernels' JSON record before that; the last
line is {"ok": true, "device": {...}}.  Without a CUDA device, or without the rest
of the repository beside it, the script exits non-zero before printing
any result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12       # H100 SXM (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12        # float32 outside the tensor cores (same)

LANES = 4096                    # phases 3 and 5
RUNS = 16384                    # testcases of the phase-5 campaign
CAMPAIGN = ["campaign", "--name", "demo_tlv", "--fused-step", "on",
            "--lanes", str(LANES), "--runs", str(RUNS), "--limit", "20000",
            "--max_len", "96", "--seed", "5"]

# Phase 3's guest: a loop over every hot opclass form, memory and stack
# operands, page-crossing stores, and the cold opclasses that park (the
# source is kept beside the bytes; GNU as, Intel syntax).
GRID_ASM = """
top: add rax, rcx ; adc edx, 0x12345 ; sub r8w, r9w ; sbb r10b, 7
     and rsi, rdi ; or r11d, eax ; xor ah, bl ; cmp rax, -5 ; test ecx, edx
     inc r9 ; dec cx ; neg r10d ; not rdx
     shl rax, 3 ; shr edx, cl ; sar r8, 63 ; rol r9w, 5 ; ror r10, cl
     rcl r11, 1 ; rcr eax, 3 ; shld rax, rdx, 11 ; shrd r9, r10, cl
     imul rdx, rax, 3 ; imul r9, rdx ; mul rcx ; imul r8d ; mul bl
     movzx eax, cl ; movsx r10, dx ; movsxd r11, eax
     lea rdi, [rax + rdx*4 + 0x40] ; lea r9d, [rsi + rcx*8 - 8]
     setc r11b ; setg al ; cmovnz r10, rax ; cmovbe ecx, edx
     mov r12, 0x123456789abcdef0
     mov [rbx + 0x10], rcx ; mov [rbx + 0x24], edx ; mov [rbx + 0x3a], r8w
     mov byte ptr [rbx + 0x51], 0x7f ; mov rax, [rbx + 0x18]
     add [rbx + 0x100], rax ; xor rdx, [rbx + 0x108]
     shl dword ptr [rbx + 0x120], 3 ; neg word ptr [rbx + 0x130]
     inc qword ptr [rbx + 0xffc] ; mov [rbx + 0x1ffd], rcx
     cmovz r8, qword ptr [rbx + 0x40] ; setnz byte ptr [rbx + 0x58]
     movzx r9, word ptr [rbx + 0x1ff]
     push qword ptr [rbx + 0x10] ; pop r11 ; push 0x1234 ; pop r10
     push rax ; pop rsi ; call sub1 ; jrcxz skip1 ; mov rax, [rsi]
skip1: add rax, [r13] ; mov [r14 + 8], rdx
     bswap rax ; xchg rax, rdx ; popcnt r10, rax ; bt rax, 3 ; cqo ; lahf
     jmp top
sub1: add rax, 7 ; ret
"""
GRID_CODE = bytes.fromhex(
    "4801c881d245230100664529c84180da074821fe4109c330dc4883f8fb85d149"
    "ffc166ffc941f7da48f7d248c1e003d3ea49c1f83f6641c1c10549d3ca49d1d3"
    "c1d803480fa4d00b4d0fadd1486bd0034c0fafca48f7e141f7e8f6e30fb6c14c"
    "0fbfd24c63d8488d7c9040448d4ccef8410f92c30f9fc04c0f45d00f46ca49bc"
    "f0debc9a7856341248894b10895324664489433ac643517f488b431848018300"
    "01000048339308010000c1a3200100000366f79b3001000048ff83fc0f000048"
    "898bfd1f00004c0f4443400f9543584c0fb78bff010000ff7310415b68341200"
    "00415a505ee824000000e303488b064903450049895608480fc84892f34c0fb8"
    "d0480fbae00348999fe9f2feffff4883c007c3")
GRID_CODE_GVA = 0x0001_4000_0000
GRID_DATA_GVA = 0x0002_0000_0000       # 4 writable pages
GRID_RO_GVA = 0x0002_0000_8000         # 1 read-only page
GRID_STACK_TOP = 0x0000_7FFF_F000


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, setup=None) -> float:
    """Mean device milliseconds of fn() over reps runs (CUDA events around
    each call; `setup` runs untimed before each)."""
    import torch

    total = 0.0
    for _ in range(reps):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def plane_diff(a, b) -> tuple:
    """(names of differing planes, max |a - b| over them) of two machines."""
    import torch

    bad, err = [], 0
    for (name, x), (_, y) in zip(a.planes(), b.planes()):
        if not bool((x == y).all()):
            bad.append(name)
            d = 1 if x.dtype == torch.bool else \
                int((x.long() - y.long()).abs().max().item())
            err = max(err, d if d >= 0 else 1 << 63)
    return bad, err


# ---------------------------------------------------------------------------
# phase 3: seeded random machines
# ---------------------------------------------------------------------------

def grid_state(n_lanes: int, seed: int, dev):
    """(tab, image, machine, limit) of n_lanes random lanes of the grid
    guest, every lane at a random instruction boundary."""
    import torch

    from wtf_tpu_torch.core.results import StatusCode
    from wtf_tpu_torch.cpu.decoder import decode
    from wtf_tpu_torch.interp.runner import Runner
    from wtf_tpu_torch.snapshot.loader import Snapshot
    from wtf_tpu_torch.snapshot.synthetic import SyntheticSnapshotBuilder

    b = SyntheticSnapshotBuilder()
    b.write(GRID_CODE_GVA, GRID_CODE)
    b.map(GRID_DATA_GVA, 0x4000)
    b.map(GRID_RO_GVA, 0x1000, writable=False)
    b.map(GRID_STACK_TOP - 0x8000, 0x9000)
    pages, cpu = b.build(rip=GRID_CODE_GVA, rsp=GRID_STACK_TOP - 0x1000)
    r = Runner(Snapshot.from_pages(pages, cpu), n_lanes=n_lanes,
               device=dev)
    view = r.view()
    rips, off = [], 0
    while off < len(GRID_CODE):
        rip = GRID_CODE_GVA + off
        rips.append(rip)
        r._decode_at(view, 0, rip)
        off += decode(GRID_CODE[off:off + 15], rip).length
    # breakpoints on two hot instructions (lanes with bp_skip pass them)
    for rip in (rips[3], rips[40]):
        r.cache.set_breakpoint(rip)
    g = torch.Generator(device=dev).manual_seed(seed)
    m = r.machine
    n = n_lanes

    def rint(lo, hi, shape=(n,)):
        return torch.randint(lo, hi, shape, generator=g, device=dev)

    def pick(values, shape=(n,)):
        v = torch.tensor(values, dtype=torch.int64, device=dev)
        return v[rint(0, len(values), shape)]

    m.rip = pick(rips)
    m.gpr = rint(-2**63, 2**63 - 1, (n, 16))
    small = rint(0, 2, (n,)) == 1
    m.gpr[:, 1] = torch.where(small, rint(0, 4), m.gpr[:, 1])
    m.gpr[:, 3] = GRID_DATA_GVA + rint(0, 0x1000)              # rbx
    bad_rbx = rint(0, 16) == 0
    m.gpr[:, 3] = torch.where(bad_rbx, rint(0, 2**40), m.gpr[:, 3])
    m.gpr[:, 4] = GRID_STACK_TOP - 0x1000 - 8 * rint(0, 64)    # rsp
    m.gpr[:, 4] = torch.where(rint(0, 16) == 0, rint(0, 2**40), m.gpr[:, 4])
    m.gpr[:, 13] = pick([GRID_DATA_GVA + 0x40, GRID_RO_GVA + 8,
                         GRID_DATA_GVA + 0x3ffc, 0x7000_0000_0000])
    m.gpr[:, 14] = pick([GRID_DATA_GVA + 0x80, GRID_RO_GVA, 0x1000])
    m.rflags = (rint(0, 1 << 12) | 2) | (rint(0, 1 << 20) << 32)
    m.icount = rint(0, 1030)        # limit 1000: a few lanes time out
    m.bp_skip = (rint(0, 3) == 0).to(torch.int32)
    status = torch.full((n,), int(StatusCode.RUNNING), device=dev)
    others = pick([int(StatusCode.OK), int(StatusCode.CRASH),
                   int(StatusCode.NEED_DECODE), int(StatusCode.NEEDS_XLA)])
    m.status = torch.where(rint(0, 10) == 0, others, status).int()
    m.ctr = rint(0, 1 << 20, (n, 6)).int()
    m.cov = rint(-2**31, 2**31 - 1, tuple(m.cov.shape)).int()
    m.edge = rint(-2**31, 2**31 - 1, tuple(m.edge.shape)).int()
    ov = m.overlay
    slots = ov.capacity
    data_pfns = [view.translate(0, GRID_DATA_GVA + i * 0x1000) >> 12
                 for i in range(4)]
    count = torch.where(rint(0, 10) == 0, slots, rint(0, 6))
    rows = torch.arange(slots, device=dev)[None, :]
    ov.pfn.copy_(torch.where(rows < count[:, None],
                             pick(data_pfns + [7, 1 << 20], (n, slots)),
                             -1).int())
    ov.count.copy_(count.int())
    ov.valid.copy_((rint(0, 2, tuple(ov.valid.shape)) *
                    (rows < count[:, None])[..., None]).to(torch.uint8))
    ov.data.copy_(rint(-2**63, 2**63 - 1, tuple(ov.data.shape)))
    return r.cache.device(dev), r.image, m, 1000


# ---------------------------------------------------------------------------
# phases (each a function, so one phase's tensors are freed before the next)
# ---------------------------------------------------------------------------

def kernel_record(name, source, replaces) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": None,
            "ms": None, "plain_ms": None, "bound_ms": None,
            "bound_by": "bytes", "library_ms": None}


def phase_build() -> str:
    from wtf_tpu_torch.csrc import build

    card = gpu_line()
    print(f"phase 1: card: {card}")
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    regs = {name: [ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln]
            for name, log in build.PTXAS.items()}
    print(f"phase 1: built {sorted(build.KERNELS)} in {build_s:.2f} s "
          f"(nvcc per kernel: "
          f"{ {k: round(v, 2) for k, v in build.BUILD_SECONDS.items()} }); "
          f"ptxas: {json.dumps(regs)}")
    return card


def phase_probe(dev, k2: dict) -> None:
    import torch

    from wtf_tpu_torch.interp import pstep

    x = torch.tensor([41], dtype=torch.int32, device=dev)
    got = int(pstep.probe_kernel(x).item())
    check(got == 42, f"probe kernel returned {got} for 41")
    k2["max_abs_err"] = abs(got - 42)
    k2["ms"] = cuda_ms(lambda: pstep.probe_kernel(x), 20)
    k2["plain_ms"] = cuda_ms(lambda: x + 1, 20)
    k2["bound_ms"] = 8 / HBM_BYTES_PER_S * 1e3
    print(f"phase 2: probe kernel ok ({k2['ms']:.4f} ms per launch)")


def phase_random(dev, k1: dict) -> None:
    import numpy as np
    import torch

    from wtf_tpu_torch.interp import pstep
    from wtf_tpu_torch.interp.machine import CTR_INSTR

    t0 = time.perf_counter()
    tab, img, m0, limit = grid_state(LANES, 3, dev)
    mk, mp = m0.clone(), m0.clone()
    pstep.fused_step(tab, img, mk, limit, 32)
    torch.cuda.synchronize()
    pstep.fused_step_plain(tab, img, mp, limit, 32)
    torch.cuda.synchronize()
    bad, err = plane_diff(mk, mp)
    check(not bad, f"K1 differs from fused_step_plain in {bad} "
                   f"(max abs err {err})")
    st = mk.status.cpu().numpy()
    ctr = (mk.ctr - m0.ctr).cpu().numpy().astype(np.int64)
    counts = {int(k): int(v) for k, v in zip(*np.unique(
        st, return_counts=True))}
    print(f"phase 3: K1 == fused_step_plain on {LANES} random lanes, "
          f"k=32, all planes bit-identical: retired "
          f"{int(ctr[:, CTR_INSTR].sum())}, parks subset/mem "
          f"{int(ctr[:, 4].sum())}/{int(ctr[:, 5].sum())}, statuses "
          f"{counts} ({time.perf_counter() - t0:.1f} s)")
    k1["max_abs_err"] = err


def phase_run() -> None:
    from wtf_tpu_torch import cli

    crasher = bytes([1, 8]) + b"A" * 8 + bytes([3, 0x30]) + b"B" * 0x30
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "crasher.bin"
        path.write_bytes(crasher)
        outs = {}
        for device in ("cuda", "cpu"):
            a = cli.build_parser().parse_args(
                ["run", "--name", "demo_tlv", "--input", str(path),
                 "--fused-step", "on", "--device", device])
            _, runs = cli.replay(a)
            outs[device] = (str(runs[0].result), runs[0].rip,
                            runs[0].icount)
    check(outs["cuda"] == outs["cpu"] and "crash" in outs["cuda"][0],
          f"run differs: card {outs['cuda']} cpu {outs['cpu']}")
    print(f"phase 4: run demo_tlv crasher: {outs['cuda'][0]} rip "
          f"{outs['cuda'][1]:#x} icount {outs['cuda'][2]} (card == cpu)")


def device_busy(prof) -> tuple:
    """(seconds the card was busy, {kernel name: (count, seconds)}) from a
    torch.profiler trace: the union of its device intervals (kernels,
    copies, sets), so overlapping work is counted once."""
    from torch.autograd import DeviceType

    spans, per_kernel = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        n, us = per_kernel.get(e.name, (0, 0.0))
        per_kernel[e.name] = (n + 1, us + (t1 - t0))
    busy_us, reach = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > reach:
            busy_us += t1 - max(t0, reach)
            reach = t1
    return busy_us / 1e6, {k: (n, us / 1e6) for k, (n, us) in
                           per_kernel.items()}


def phase_campaign(k1: dict, k2: dict, record: dict) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from wtf_tpu_torch import cli
    from wtf_tpu_torch.interp import pstep

    a = cli.build_parser().parse_args(CAMPAIGN)
    torch.cuda.reset_peak_memory_stats()
    for name in pstep.LAUNCHES:
        pstep.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    loop = cli.campaign(a)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pstep.LAUNCHES)
    in_use, peak = torch.cuda.memory_allocated(), \
        torch.cuda.max_memory_allocated()
    backend = loop.backend
    reg = backend.registry
    instr = reg.counter("device.instructions").value
    fused = reg.counter("device.fused_steps").value
    occupancy = fused / max(instr, 1)
    terminal = {"OK", "CRASH", "TIMEDOUT", "PAGE_FAULT", "OVERLAY_FULL",
                "CR3_CHANGE", "DIVIDE_ERROR", "HARD_ERROR"}
    counts = backend.status_counts
    check(launches["fused_step"] > 0, f"K1 never launched: {launches}")
    check(launches["probe"] > 0, f"K2 never launched: {launches}")
    check(occupancy >= 0.95, f"fused occupancy {occupancy:.4f} < 0.95")
    check(set(counts) <= terminal
          and sum(counts.values()) == loop.stats.testcases >= RUNS,
          f"non-terminal lanes: {counts}")
    check(reg.counter("runner.max_chunks_timeouts").value == 0,
          "lanes revoked at max_chunks")
    spans = reg.spans
    print(f"phase 5: campaign {loop.stats.testcases} testcases in "
          f"{wall:.2f} s = {loop.stats.testcases / wall:.1f} execs/s; "
          f"K1 launches {launches['fused_step']} "
          f"({launches['fused_step'] / backend.stats['batches']:.1f} per "
          f"batch); fused occupancy {occupancy:.4f} ({fused}/{instr}); "
          f"device bytes in use {in_use} (peak {peak}); statuses "
          f"{counts}; crashes {loop.stats.crashes}, corpus "
          f"{len(loop.corpus)}")
    k1["launches"] = launches["fused_step"]
    k2["launches"] = launches["probe"]
    record["campaign"] = {
        "testcases": loop.stats.testcases, "wall_s": wall,
        "execs_per_s": loop.stats.testcases / wall,
        "k1_launches": launches["fused_step"],
        "batches": backend.stats["batches"],
        "occupancy": occupancy, "instructions": instr,
        "spans": {p: spans.seconds(p) for p in (
            "mutate", "execute", "harvest", "restore", "execute/insert",
            "execute/fused-step", "execute/device-step",
            "execute/service-pull", "execute/service-decode",
            "execute/service-push", "execute/cov-readback",
            "restore/overlay-restore")},
        "bytes_in_use": in_use, "peak_bytes": peak,
        "statuses": counts, "crashes": loop.stats.crashes}

    # K1 on a main-path state: a fresh batch of this campaign's inputs,
    # from its start (decode cache warm: every lane runs K steps)
    runner = backend.runner
    view = backend._ensure_view()
    for lane in range(backend.n_lanes):
        with backend._bound(view, lane):
            loop.target.insert_testcase(
                backend, loop.mutator.get_new_testcase(loop.corpus))
    runner.push(view)
    backend._view = None
    tab, img = runner.device_tab(), runner.image
    m0 = runner.machine.clone()
    work = {}

    def fresh():
        work["m"] = m0.clone()

    k1["ms"] = cuda_ms(lambda: pstep.fused_step(
        tab, img, work["m"], runner.limit, 32), 10, setup=fresh)
    work.clear()
    mk = m0.clone()
    pstep.fused_step(tab, img, mk, runner.limit, 32)
    mp = m0.clone()
    k1["plain_ms"] = cuda_ms(lambda: pstep.fused_step_plain(
        tab, img, mp, runner.limit, 32), 1)
    bad, err = plane_diff(mk, mp)
    check(not bad, f"K1 differs from plain on the main-path state: {bad}")
    k1["max_abs_err"] = max(k1["max_abs_err"] or 0, err)
    k1["bound_ms"], k1["bound_by"], bound_detail = k1_bound(
        m0, mk, runner, tab)
    print(f"phase 5: K1 on a main-path batch start: {k1['ms']:.3f} ms per "
          f"dispatch, plain version {k1['plain_ms']:.1f} ms, bound "
          f"{k1['bound_ms']:.5f} ms ({bound_detail}); bit-identical")
    backend.restore()
    del loop, backend, runner, view, tab, img, m0, mk, mp
    torch.cuda.empty_cache()

    # the same campaign under the profiler: what the card itself was busy
    # with (the first run stays unprofiled, so its wall is the user's)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loop = cli.campaign(cli.build_parser().parse_args(CAMPAIGN))
        torch.cuda.synchronize()
    wall_prof = time.perf_counter() - t0
    check(loop.stats.testcases == record["campaign"]["testcases"],
          "the profiled campaign ran a different number of testcases")
    busy, per_kernel = device_busy(prof)
    check(busy > 0, "torch.profiler recorded no device activity")
    k1_n, k1_s = (sum(v[i] for name, v in per_kernel.items()
                      if "fused_step_kernel" in name)
                  for i in (0, 1))
    check(k1_n == launches["fused_step"],
          f"the trace holds {k1_n} K1 launches, the campaign made "
          f"{launches['fused_step']}")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])
    n_dev = sum(n for n, _ in per_kernel.values())
    print(f"phase 5: profiled rerun ({wall_prof:.2f} s wall): card busy "
          f"{busy:.3f} s over {n_dev} kernels and copies = host share "
          f"{1 - busy / wall:.3f} of the unprofiled run's {wall:.2f} s; "
          f"K1 {k1_n} launches, {k1_s / k1_n * 1e3:.3f} ms mean; top by "
          f"device time: " + "; ".join(
              f"{name[:40]} x{n} {sec:.3f} s" for name, (n, sec) in top[:4]))
    record["campaign"].update({
        "profiled_wall_s": wall_prof, "device_busy_s": busy,
        "host_share": 1 - busy / wall, "device_launches": n_dev,
        "k1_ms_mean_trace": k1_s / k1_n * 1e3,
        "top_device": [(name, n, sec) for name, (n, sec) in top[:20]]})


def phase_card_vs_cpu() -> None:
    from wtf_tpu_torch import cli

    outs = {}
    for device in ("cuda", "cpu"):
        a = cli.build_parser().parse_args(
            ["campaign", "--name", "demo_tlv", "--fused-step", "on",
             "--lanes", "64", "--runs", "256", "--limit", "20000",
             "--max_len", "96", "--seed", "5", "--device", device])
        t0 = time.perf_counter()
        loop = cli.campaign(a)
        b = loop.backend
        outs[device] = (sorted(loop.corpus.digests), sorted(
            loop.crash_names), b._agg_cov.cpu().numpy().tobytes(),
            b._agg_edge.cpu().numpy().tobytes(), time.perf_counter() - t0)
    check(all(outs["cuda"][i] == outs["cpu"][i] for i in range(4)),
          "64-lane campaign differs between card and cpu")
    print(f"phase 6: 64-lane 256-run campaign, card == cpu: "
          f"{len(outs['cuda'][0])} corpus digests, "
          f"{len(outs['cuda'][1])} crash names, equal cov/edge bytes "
          f"(card {outs['cuda'][4]:.1f} s, cpu {outs['cpu'][4]:.1f} s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the kernels' record and the nvcc "
                         "logs into this directory")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    from wtf_tpu_torch.csrc import build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    record = {}
    k1 = kernel_record("fused_step", "wtf_tpu_torch/csrc/fused_step.cu",
                       "wtf_tpu/interp/pstep.py:742")
    k2 = kernel_record("probe", "wtf_tpu_torch/csrc/probe.cu",
                       "wtf_tpu/interp/pstep.py:144")
    card = phase_build()
    phase_probe(dev, k2)
    phase_random(dev, k1)
    phase_run()
    phase_campaign(k1, k2, record)
    phase_card_vs_cpu()

    kernels = {"kernels": [k1, k2]}
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "chip_smoke.json").write_text(json.dumps(
            {"card": card, **kernels, **record, "ptxas": build.PTXAS},
            indent=1, default=str))
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def k1_bound(m0, m1, runner, tab):
    """The least time the card could take for one K1 dispatch from m0:
    the bytes it must move over the memory rate, or its operations over
    the scalar peak, whichever is larger.  Bytes: each lane's register
    and bookkeeping planes read and written, its overlay row index read
    (a store or load must know which rows exist), the bitmap and overlay
    words this dispatch changed read and written, and the decode entries
    in use; operations: one per instruction retired."""
    from wtf_tpu_torch.interp.machine import CTR_INSTR

    n = m0.n_lanes
    scalar = 8 * (16 + 1 + 1 + 1) + 4 * (1 + 1 + 6 + 1)   # rw planes
    read_only = 4 + 8 * 3                                # tenant cr3 fs gs
    per_lane = 2 * scalar + read_only + 4 * m0.overlay.capacity
    changed = 0
    for a, b, width in ((m0.cov, m1.cov, 4), (m0.edge, m1.edge, 4),
                        (m0.overlay.data, m1.overlay.data, 8),
                        (m0.overlay.valid, m1.overlay.valid, 1),
                        (m0.overlay.pfn, m1.overlay.pfn, 4)):
        changed += 2 * width * int((a != b).sum())
    table = runner.cache.count * (4 * tab.meta_i32.shape[1] + 32 + 12)
    total = n * per_lane + changed + table
    ops = int((m1.ctr[:, CTR_INSTR] - m0.ctr[:, CTR_INSTR]).long().sum())
    t_bytes = total / HBM_BYTES_PER_S
    t_ops = ops / SCALAR_OPS_PER_S
    by = "bytes" if t_bytes >= t_ops else "operations"
    detail = (f"{total} bytes at 3.35 TB/s, {ops} instructions at 67 T/s; "
              f"bound by {by}")
    return max(t_bytes, t_ops) * 1e3, by, detail


if __name__ == "__main__":
    sys.exit(main())
