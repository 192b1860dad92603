#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (wtf_tpu_torch) end to end on one NVIDIA card.

    python3 chip_smoke.py            # every phase, on cuda:0

Phases (each prints one line; any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi); build both hand-written
     kernels from csrc/ (one nvcc each, started together)
  2. launch the availability probe kernel (K2) and check it returns 1,
     and time it and an empty kernel from the same source (the launch
     floor, K2's honest bound) alike, as raw launches, each after a
     warm-up call (K2 through its wrapper and `x + 1` are timed too);
     phase 1 prints K1's ptxas report, its shared bytes per block and the
     warps one SM holds (the CUDA occupancy calculator)
  3. the fused step kernel (K1) against its plain PyTorch version at 4096
     lanes, k=32, on seeded random machines (hot register grids, memory and
     stack forms, page crossings, park causes, a breakpoint with bp_skip,
     full overlays, the instruction budget, a high-half copy of the code
     and data at canonical-negative addresses): all 13 planes
     bit-identical;
     then a ragged set: 1001 lanes (not a whole number of blocks) of 50
     overlay rows (not a whole number of 32-row lookup rounds), with one
     pfn in several rows, rows claimed up to count == slots, pfns found
     only in the second lookup round, and non-free rows past `count`;
     then a stacked three-tenant image at 4096 lanes: three images whose
     code and data share virtual addresses (other pages and other code
     behind them; the third only at canonical-negative addresses), the
     lanes' tenants interleaved (lane % 3), every tenant retiring
     instructions in K1: all planes bit-identical
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
  7. the precise step's integer and system classes on the card against the
     CPU: 4096 seeded random lanes whose next instruction is DIV/IDIV at
     every width (divisors 0, -1, INT64_MIN on some lanes), a string form
     with or without REP, BT on memory with negative bit offsets, a bit
     scan, CMPXCHG/XADD/XCHG on memory, CPUID, RDMSR/WRMSR, SYSCALL/SYSRET,
     SWAPGS, MOV CR, PUSHF/POPF, ENTER/LEAVE or a flag op; a few steps of
     `step` on each (the card computing only the groups its scan finds,
     the CPU every group): every plane bit-identical
  8. the second main path: `campaign --name demo_kernel --fused-step on
     --lanes 4096 --runs 16384 --limit 100000 --max_len 96 --seed 5` (ring
     0 at canonical-negative addresses through syscall/swapgs/sysretq),
     counts zeroed just before and read just after: K1 launched, no oracle
     fallback, every lane terminal; execs/s, spans, occupancy, statuses,
     crash names, device memory
  9. demo_kernel and demo_usermode card against CPU: `run` on the crash
     classes and benign inputs of tests/test_kernel.py and the cases of
     tests/test_usermode.py, and a 64-lane, 256-run campaign of each at
     the same seed: equal results, crash names, corpus digests and
     coverage/edge bitmaps
 10. the third main path, device mutation in megachunk windows:
     `campaign --name demo_tlv --mutator devmangle --megachunk 8
     --fused-step on` at phase 5's size, counts zeroed just before and
     read just after: K1 launched from the window, fused occupancy >=
     0.95, windows > 0, every lane terminal; execs/s, spans, windows
     (and how many ended incomplete, finished by the host service),
     batches and K1 launches per window, the window's precise sweeps,
     device memory; the same campaign with --megachunk 0 once, in turns
     with the window (equal results, execs/s of each, spans);
     then the window campaign under torch.profiler for the host share
 11. a 64-lane, 256-run window campaign at the same seed on the card and
     on the CPU, and on the card with --megachunk 0: equal corpus
     digests, crash names and coverage/edge bitmaps
 12. device decode's parts on the card against the CPU: `decode_window`
     over the random encoding grid of tests/test_torch_devdec.py (and the
     host decoder on its known rows), and `gather_windows` on 4096 lanes
     of phase 3's guest (random overlays; instruction, page-crossing,
     high-half, data and wild rips)
 13. the fourth main path, device decode in the windows: phase 10's
     campaign with --device-decode, counts zeroed just before and read
     just after: K1 launched (its launches from the service rounds'
     re-quiesces counted apart), published entries > 0 with no
     cross-check mismatch, and corpus digests, crash names and cov/edge
     bytes equal to phase 10's; host decodes, zero-host windows against
     windows, batches per window, service rounds and their seconds,
     execs/s; the same campaign without and with --device-decode in
     turns; then a profiled rerun for the host share
 14. a 64-lane, 256-run --device-decode window campaign on the card, on
     the CPU and (phase 11) on the card without device decode: equal
     results; and --megachunk 0 --device-decode on the card once
 15. crash-dump snapshots: demo_kernel exported by the `snapshot`
     subcommand as dmp-full (it must load back equal) and dmp-bmp, the
     bitmap dump padded with 262,144 seeded filler pages (1 GiB) at pfns
     no guest table reaches (a walk from cr3 shows it), then phase 8's
     campaign with --state on the padded dump: results equal phase 8's,
     the native parser must have parsed it; dump bytes, parse,
     PhysMem.from_pages and upload seconds, device peak
 16. demo_maze, demo_ioctl and demo_fs campaigns at phase 8's size, each
     seeded with its reference test's input, counts zeroed just before
     and read just after: the native host mutator, K1 launched, no
     oracle fallback, every lane terminal; execs/s, K1 launches per
     batch, occupancy, spans, breakpoint services (demo_fs); K1 against
     its plain version on a crafted batch start of each (payloads at
     ioctl's page end); a profiled rerun of demo_fs for the host share
 17. a 64-lane, 256-run campaign of demo_maze, demo_ioctl, demo_fs and
     demo_spin on the card and on the CPU: equal results
 18. demo_spin deep, bench.py's chip workload (1024 lanes, max_len 4, the
     native engine behind bench's spin-count cap, --fused-k 32) at limit
     125,000: a warm-up batch with K1 rounds 3,000-3,100 traced by
     torch.profiler, then unprofiled batches for 10 s; execs/s,
     instructions/s, timeout fraction, K1 launches per batch and per
     second, K1's and the resume legs' shares of the wall, the host
     share of the traced rounds against their unprofiled wall
 19. the precise step's SSE, SSE-FP and x87 classes on the card against
     the CPU: 4096 seeded random lanes whose next instruction is one of
     ~170 forms (moves and merges, the byte ALU, every SSE-FP op at f32
     and f64, packed and scalar, the converts, VZEROALL, x87 arithmetic
     on memory and st(i), loads, stores, fist under each rounding mode,
     compares and control ops), with operands from the FP value sets
     (signed zeros, infinities, NaN payloads, denormals, products that
     are denormal or underflow, +-2**63) and memory operands at a page
     end; a few steps of `step` on each: every plane bit-identical, the
     status plane (the denormal divert set) included; ms per step, with
     and without the FP groups
 20. the fused step parking at FP code, at full width: a Runner with
     --fused-step on at 4096 lanes x 128 overlay rows on a loop mixing
     integer code, an SSE copy and zeroing, SSE FP and x87 arithmetic,
     trip counts 1-12 per lane; counts zeroed just before and read just
     after: K1 launched and parked lanes at the FP classes, no SSE or
     x87 fallback, every lane terminal; K1 launches, resume legs,
     instructions, wall, the legs' share, device peak; the same batch
     on the CPU (a worker process, burst_any_tier on on both sides):
     every plane and the copy pages equal
 21. the fault-tolerance tier on phase 10's window campaign: the same
     campaign with --supervise --dispatch-timeout 30 --checkpoint-every 1
     (counts zeroed just before and read just after: K1 launched from
     supervised windows and the supervised host finish): its final line,
     outputs/, crashes/ and cov/edge bytes equal phase 10's; supervised
     dispatches by seam, bounded waits, the integrity, snapshot and
     checkpoint spans' shares of the wall, checkpoint bytes and seconds;
     then, in turns with that run, phase 10's campaign writing a target
     dir (T) and supervised without checkpoints (S): each equal, and the
     mean wall differences that the target dir, the supervisor and the
     checkpoints cost
 22. scripted faults at full width, one plan (a hang on K1's `fused`
     seam, an error on a window, a poison on an insert, a hang on a
     generation; promote_after 1): replayed bit-identically, equal to
     phase 10's; then a poison on the same lane of three windows, which
     quarantines it and completes; supervise counters, the rung history
     (degradations and re-promotions), the rebuilds' seconds, K1
     launches (replays included) and K2's (one per Runner, rebuilds
     included)
 23. phase 21's campaign in a subprocess, SIGKILLed once its checkpoint
     has been written twice, then `campaign --resume` in a new process:
     the final line, outputs/ and crashes/ equal phase 21's; the batch it
     resumed after and whether it fell back to .prev
     (phases 21-23 also run at 64 lanes on the card and, in a worker
     process, on the CPU: equal, and equal to phase 11 but for the
     quarantine run)
 24. triage, the minset: `campaign --runs 0 --fused-step on --lanes
     4096 --limit 20000` over phase 21's outputs/ and crashes/ copied
     into a fresh inputs/, through the CLI with --telemetry-dir (K1's
     counts zeroed just before each triage command and read just after):
     K1 launched, outputs/ ends as the kept subset, every lane terminal;
     kept against the corpus, dispatches, K1 launches, the wall
 25. `triage distill` of the same inputs (full coverage, no more kept than
     phase 24's prefix minset, which it also prints; the host set cover's
     seconds) and `triage minimize` of phase 21's largest crasher (no
     longer than it, the same crash bucket when both are replayed):
     rounds, dispatches, candidates per dispatch, lanes filled, K1
     launches, the wall
 26. `triage vbreak --break-at tlv!parse+0x12 --hit 2 --variants 4095` on
     phase 25's result (triage_smoke's crasher if that never reaches the
     second arrival): captures > 0, each at icount > 0; the wall and the
     share of it in the host breakpoint services (handlers, view pulls
     and pushes)
     (phases 24-26 also run at 64 lanes on the card and, in two worker
     processes, on the CPU, on the 96 largest files and triage_smoke's
     crasher: equal printed lines, kept digests, minimized bytes and
     captures)
 27. the distributed main path: the port's `master --name demo_tlv --runs
     16384 --seed 5 --max_len 96 --store DIR --telemetry-dir DIR` in a
     subprocess (no device work) over a unix socket serves a 4096-lane
     `fuzz --mux --fused-step on --limit 20000 --seed 5` node on the card,
     in this process through `cli.fuzz` (K1's counts zeroed just before
     and read just after): K1 launched in the node's rounds, the node
     served every testcase the master counted (16384), every crash file
     is named by its digest, coverage.cov holds the master's count and
     the node's own aggregate coverage, `fleet fsck --store` is clean and
     `status` renders the master's fleet view; execs/s (the master's
     testcases over the node's wall), rounds, K1 launches per round, the
     node's spans (wire-recv, execute, harvest, wire-send, restore), the
     master's intake and serve seconds, the coverage bytes on the delta
     wire against whole sets, the per-lane device reads per round
     (coverage rows, crash buckets) and their seconds, the device peak
 28. a 64-lane mux node against a fresh 256-run master, on the card and
     on the CPU, with the delta wire and with --no-cov-delta: equal count
     lines (without the clock fields), outputs/, crashes/ and coverage.cov
     (addresses and the cursor's table and words, without the node's
     random client id)
 29. phase 27's node under `chaos_dialing` against a master of 8192 (and
     testcases of at most 32 bytes): a scripted reset of its first reply
     fires once, the node reconnects (dist.retries >= 1), the master
     reclaims the batch in flight (dist.reclaimed >= 1) and counts every
     testcase once, and outputs/ stays content-addressed
 30. demo_pe, compiler-made Windows code: `campaign --name demo_pe
     --fused-step on --lanes 4096 --runs 4096 --limit 1500 --seed 5`
     seeded with test_pe_target's BENIGN, its structure mutator, counts
     zeroed just before and read just after: K1 launched, every lane
     terminal; execs/s, K1 launches, precise steps and the share of them
     that computed an FP group, the resume legs' share of the wall,
     fallbacks by opclass, TIMEDOUT lanes, device peak.  Where the DLL
     is missing (PyOpenGL's wheel is not installed; --pe-dll names a
     copy) it prints a skip line
 31. the slice's main path, `sched --lanes 4096 --limit 50000 --quantum 2
     --fused-step on --store DIR --telemetry-dir DIR` over four jobs
     (demo_tlv devmangle 2048 lanes, demo_kernel 1024, demo_pe 512,
     demo_maze 1024: 4608 > 4096, so one waits; without the DLL demo_maze
     takes demo_pe's lanes and priority): every job finishes its runs, at
     least one preemption and one resume, K1 launched in every round and
     K2 once per placement build, each job's store namespace fsck-clean;
     testcases, crashes and preemptions per job, execs/s, K1 launches
     per round, the sched-place and checkpoint spans, the resume legs'
     share, device peak
 32. the table at 64 lanes (32/16/8/16, quantum 1, limit 20,000) on the
     card and on the CPU: equal summaries, final checkpoints and crash
     names per job; a demo_tlv + demo_kernel + demo_pe mix (4 lanes
     each, 2 batches) equal, tenant by tenant, to each solo run on the
     card; a 32-lane x 64-run demo_pe campaign card == CPU

Phase 8 fails unless its host mutator is the native engine (the one the
reference CLI picks).  Every phase always runs, at the sizes above.
Phases 6, 9, 11, 14, 17, 28 and 32 and the comparisons of phases 20-26
run last, after the timed phases: their CPU sides run in worker processes started
together (spawned, and joined before the script ends) while this process
runs their card sides.  The line before the kernels' JSON record gives
the seconds the phases took; the card's nvidia-smi line
comes before the last, the kernels' JSON record before that; the last
line is {"ok": true, "device": {...}}.  Without a CUDA device, or without the rest
of the repository beside it, the script exits non-zero before printing
any result.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12       # H100 SXM (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12        # float32 outside the tensor cores (same)

LANES = 4096                    # phases 3 and 5
SLOTS = 128                     # overlay rows per lane (Runner's default)
RAGGED_LANES = 1001             # phase 3's ragged set
RAGGED_SLOTS = 50
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
GRID_KCODE_GVA = 0xFFFF_8000_4000_0000  # the grid code again, high half
GRID_KDATA_GVA = 0xFFFF_8000_5000_0000  # 2 writable high-half pages

# phase 10: the device mutation engine in megachunk windows
WINDOW = ["--mutator", "devmangle", "--megachunk", "8"]
WCAMPAIGN = CAMPAIGN + WINDOW
# phase 13: decode-cache misses serviced on the card inside the windows
DCAMPAIGN = WCAMPAIGN + ["--device-decode"]
# phases 21-23: the window campaign supervised (a 30 s watchdog) and
# checkpointed after every batch; phase 22's quarantined lane
SUPERVISE = ["--supervise", "--dispatch-timeout", "30"]
SCAMPAIGN = WCAMPAIGN + SUPERVISE + ["--checkpoint-every", "1"]
QUARANTINE_LANE = 9
# phases 24-26: triage of phase 21's corpus; the vbreak drive of the
# reference's verify recipe (the loop head `cmp r8, r9`, second arrival)
VBREAK_AT = ["--break-at", "tlv!parse+0x12", "--hit", "2"]
TWIN_LANES = 64                 # the 64-lane twins, card == cpu
TWIN_CORPUS = 96                # the twins' corpus: the largest files
# wtf_tpu/testing/triage_smoke.py's crasher (junk records around a type-3
# stack smash) and its known-minimal reproducer: the twins' minimize
# input, and phase 26's if phase 25's never reaches the second hit
SMOKE_CRASHER = (b"\x01\x02XY" + bytes([3, 32]) + bytes(range(65, 89))
                 + b"\x41" * 8 + b"\x01\x03ZZZ")
SMOKE_MINIMAL = bytes([3, 32]) + bytes(24) + b"\x41" * 8

KCAMPAIGN = ["campaign", "--name", "demo_kernel", "--fused-step", "on",
             "--lanes", str(LANES), "--runs", str(RUNS), "--limit",
             "100000", "--max_len", "96", "--seed", "5"]

# phase 15: demo_kernel's bitmap dump padded with 1 GiB of filler pages
DUMP_FILLER_PAGES = 262_144
DUMP_FILLER_BASE = 0x100000            # the first filler pfn (4 GiB up)
# phases 16 and 17: the remaining synthetic targets, each campaign seeded
# with its reference test's input
NEW_TARGETS = ("demo_maze", "demo_ioctl", "demo_fs")
TARGET_SEEDS = {"demo_maze": [b"aaaa"],
                "demo_ioctl": [b"\x03\x20\x22\x00\x02\x00AB"],
                "demo_fs": [b"HELLOWORLD123456"]}
# phase 18: bench.py's deep workload, its limit cut from 10M
SPIN_LANES = 1024
SPIN_LIMIT = 125_000
SPIN_SECONDS = 10.0
SPIN_WINDOW = (3_000, 3_100)           # K1 rounds traced for the host share
SPIN_SMALL_LIMIT = 500                 # phase 17's 64-lane demo_spin
TERMINAL = {"OK", "CRASH", "TIMEDOUT", "PAGE_FAULT", "OVERLAY_FULL",
            "CR3_CHANGE", "DIVIDE_ERROR", "HARD_ERROR"}
SPANS = ("mutate", "execute", "harvest", "restore", "execute/insert",
         "execute/fused-step", "execute/device-step", "execute/service-pull",
         "execute/service-decode", "execute/service-push",
         "execute/cov-readback", "restore/overlay-restore")

# phases 30-32: demo_pe (compiler-made code; tests/test_pe_target.py's
# inputs: BENIGN's 4 points finish after 6,740 instructions) and the
# multi-tenant scheduler
PE_PTS = struct.pack("<12d", 1.0, 2.0, 3.0, 2.0, 3.0, 4.0, 3.0, 4.0, 5.0,
                     4.0, 5.0, 6.0)
PE_BENIGN = struct.pack("<Id", 4, 0.5) + PE_PTS
PE_ZERO = struct.pack("<Id", 0, 1.0)   # a count of 0: crashes after 662
PE_RUNS = LANES                        # phase 30: one batch
# phase 30's limit, cut from 50,000: each K1 park at an FP instruction
# costs a ~70 ms precise step over all 4096 lanes, so a batch costs its
# longest lane's FP instructions in legs (657.6 s at 50,000)
PE_LIMIT = 1_500
PCAMPAIGN = ["campaign", "--name", "demo_pe", "--fused-step", "on",
             "--lanes", str(LANES), "--runs", str(PE_RUNS), "--limit",
             str(PE_LIMIT), "--seed", "5"]
# phase 31's jobs table: (name, target, mutator, lanes, runs, priority);
# the quotas sum to 4608 over 4096 lanes, so one job always waits.  A
# batch lasts as long as its slowest lane, and a demo_pe lane parks K1 at
# every FP instruction, so carol runs one batch (2048 runs cut to 512)
# from the count-0 seed, whose mutants stay near 1,200 instructions
SCHED_JOBS = (("alice", "demo_tlv", "devmangle", 2048, 16384, 2),
              ("bob", "demo_kernel", "auto", 1024, 8192, 1),
              ("carol", "demo_pe", "auto", 512, 512, 1),
              ("dave", "demo_maze", "auto", 1024, 4096, 0))
SCHED_SEEDS = {"demo_tlv": b"\x01\x04AAAA\x02\x08BBBBBBBB",
               "demo_kernel": b"hello-world-123",
               "demo_pe": PE_ZERO, "demo_maze": b"aaaa"}
SCHED_LIMIT = 50_000                   # tests/test_tenancy.py's LIMIT
TWIN_LIMIT = 20_000                    # phase 32's twins
TWIN_SCHED_RUNS = {"alice": 64, "bob": 32, "carol": 8, "dave": 32}
TWIN_PE_LANES = 32
TWIN_PE_RUNS = 64

# Phase 7's guest: the integer and system classes of the precise step, one
# after another (GNU as, Intel syntax; ` ; ` separates instructions).
SYS_ASM = """
top: div cl ; div cx ; div ecx ; div rcx ; idiv cl ; idiv cx ; idiv ecx
     idiv rcx ; div byte ptr [rbx] ; idiv qword ptr [rbx + 8]
     movsb ; movsq ; stosd ; lodsw ; scasb ; cmpsq
     rep movsb ; rep stosq ; repe cmpsb ; repne scasb ; rep lodsd
     bt qword ptr [rbx], rcx ; bts dword ptr [rbx], ecx
     btr word ptr [rbx], cx ; btc qword ptr [rbx], rdx
     bt rax, rcx ; bts r8d, 17 ; btr r9, rcx ; btc ax, cx
     bsf rax, rcx ; bsr edx, ecx ; tzcnt r8, rcx ; lzcnt r9d, ecx
     popcnt r10, rcx ; popcnt ax, cx ; bsf dx, cx
     cmpxchg [rbx + 0x10], rcx ; cmpxchg ecx, edx
     xadd [rbx + 0x18], rax ; xadd r9w, r10w
     xchg [rbx + 0x20], rdx ; xchg ecx, r8d
     bswap rax ; bswap r9d ; cbw ; cwde ; cdqe ; cwd ; cdq ; cqo
     andn rax, rbx, rcx ; bzhi rdx, rcx, rax ; bextr r8, rcx, rdx
     shlx r9, rcx, rax ; shrx r10d, ecx, edx ; sarx r11, rcx, rax
     pdep rax, rcx, rdx ; pext rdx, rcx, rax ; blsr r8, rcx
     blsmsk r9, rcx ; blsi r10, rcx ; rorx r11, rcx, 13
     cpuid ; rdtsc ; rdrand rax ; rdrand cx ; xgetbv
     rdmsr ; wrmsr ; syscall ; sysretq ; swapgs
     rdfsbase rax ; rdgsbase r9 ; wrfsbase rax ; wrgsbase rcx
     mov rax, cr0 ; mov cr0, rax ; mov rdx, cr3 ; mov cr3, rdx
     mov cr4, rcx ; mov r8, cr8 ; mov cr8, r9 ; mov rax, cr2
     pushfq ; popfq ; lahf ; sahf ; clc ; stc ; cmc ; cld ; std
     enter 0x20, 0 ; leave ; add rax, rcx ; int3 ; hlt ; int 0x29
     jmp top
"""
SYS_CODE = bytes.fromhex(
    "f6f166f7f1f7f148f7f1f6f966f7f9f7f948f7f9f63348f77b08a448a5ab66ad"
    "ae48a7f3a4f348abf3a6f2aef3ad480fa30b0fab0b660fb30b480fbb13480fa3"
    "c8410fbae811490fb3c9660fbbc8480fbcc10fbdd1f34c0fbcc1f3440fbdc9f3"
    "4c0fb8d166f30fb8c1660fbcd1480fb14b100fb1d1480fc1431866450fc1d148"
    "8753204487c1480fc8410fc966989848986699994899c4e2e0f2c1c4e2f8f5d1"
    "c462e8f7c1c462f9f7c9c4626bf7d1c462faf7d9c4e2f3f5c2c4e2f2f5d0c4e2"
    "b8f3c9c4e2b0f3d1c4e2a8f3d9c463fbf0d90d0fa20f31480fc7f0660fc7f10f"
    "01d00f320f300f05480f070f01f8f3480faec0f3490faec9f3480faed0f3480f"
    "aed90f20c00f22c00f20da0f22da0f22e1450f20c0450f22c10f20d09c9d9f9e"
    "f8f9f5fcfdc8200000c94801c8ccf4cd29e9cafeffff")
SYS_CODE_GVA = 0x0001_5000_0000
SYS_STEPS = 6

# Phase 19's guest: the SSE, SSE-FP and x87 forms of the precise step, one
# after another (GNU as, Intel syntax; ` ; ` separates instructions).
FP_ASM = """
top: movdqu xmm0, [rbx] ; movdqa xmm1, xmm2 ; movups [rbx], xmm3
     movss xmm4, [rbx] ; movsd xmm5, xmm6 ; movss xmm7, xmm8
     movq xmm9, rax ; movd xmm10, ecx ; movq rdx, xmm11 ; movd esi, xmm12
     movq xmm13, [rbx] ; movlps xmm14, [rbx] ; movhps xmm15, [rbx]
     movhlps xmm0, xmm1 ; movlhps xmm2, xmm3 ; movlps [rbx], xmm4
     movhps [rbx], xmm5 ; movsd [rbx], xmm6 ; movss [rbx], xmm7
     pxor xmm0, xmm1 ; xorps xmm2, [rbx] ; por xmm3, xmm4 ; pand xmm5, xmm6
     pandn xmm7, xmm8 ; pcmpeqb xmm9, xmm10 ; pcmpeqw xmm11, [rbx]
     pcmpeqd xmm12, xmm13 ; psubb xmm14, xmm15 ; paddb xmm0, [rbx]
     pminub xmm1, xmm2 ; punpcklqdq xmm3, xmm4 ; pshufd xmm5, xmm6, 0x1b
     pslldq xmm7, 3 ; psrldq xmm8, 13 ; punpckldq xmm9, [rbx]
     paddq xmm10, [rbx] ; psllq xmm11, 5 ; psrlq xmm12, 63 ; psllq xmm13, 64
     pinsrw xmm14, eax, 3 ; pinsrw xmm15, word ptr [rbx], 1
     pextrw ecx, xmm0, 5 ; pmovmskb edx, xmm1 ; ptest xmm2, xmm3
     addss xmm0, xmm1 ; addsd xmm2, [rbx] ; addps xmm3, xmm4
     addpd xmm5, [rbx] ; subss xmm6, [rbx] ; subsd xmm7, xmm8
     subps xmm9, [rbx] ; subpd xmm10, xmm11 ; mulss xmm12, xmm13
     mulsd xmm14, [rbx] ; mulps xmm15, xmm0 ; mulpd xmm1, xmm2
     divss xmm3, [rbx] ; divsd xmm4, xmm5 ; divps xmm6, xmm7
     divpd xmm8, [rbx] ; minss xmm9, xmm10 ; minsd xmm11, [rbx]
     minps xmm12, xmm13 ; minpd xmm14, xmm15 ; maxss xmm0, [rbx]
     maxsd xmm1, xmm2 ; maxps xmm3, [rbx] ; maxpd xmm4, xmm5
     sqrtss xmm6, xmm7 ; sqrtsd xmm8, [rbx] ; sqrtps xmm9, xmm10
     sqrtpd xmm11, xmm12 ; cmpeqss xmm13, xmm14 ; cmpltsd xmm15, [rbx]
     cmpleps xmm0, xmm1 ; cmpunordpd xmm2, xmm3 ; cmpneqsd xmm4, xmm5
     cmpnltss xmm6, [rbx] ; cmpnlepd xmm7, xmm8 ; cmpordps xmm9, xmm10
     ucomiss xmm11, xmm12 ; ucomisd xmm13, [rbx] ; comiss xmm14, [rbx]
     comisd xmm15, xmm0
     cvtsi2ss xmm1, eax ; cvtsi2ss xmm2, rcx ; cvtsi2sd xmm3, eax
     cvtsi2sd xmm4, rcx ; cvtsi2sd xmm5, dword ptr [rbx]
     cvtsi2ss xmm6, qword ptr [rbx]
     cvtss2si eax, xmm7 ; cvtsd2si rcx, xmm8 ; cvttss2si rdx, xmm9
     cvttsd2si esi, xmm10 ; cvtsd2si eax, [rbx] ; cvttss2si rcx, [rbx]
     cvtss2sd xmm11, xmm12 ; cvtsd2ss xmm13, [rbx] ; cvtps2pd xmm14, xmm15
     cvtpd2ps xmm0, [rbx] ; cvtdq2ps xmm1, xmm2 ; cvtps2dq xmm3, [rbx]
     cvttps2dq xmm4, xmm5 ; cvtdq2pd xmm6, xmm7 ; cvtpd2dq xmm8, xmm9
     cvttpd2dq xmm10, [rbx] ; shufps xmm11, xmm12, 0x4e
     shufpd xmm13, [rbx], 1 ; unpcklps xmm14, xmm15 ; unpckhps xmm0, [rbx]
     unpcklpd xmm1, xmm2 ; unpckhpd xmm3, xmm4
     vaddsd xmm5, xmm5, xmm6 ; vsqrtsd xmm7, xmm7, xmm8 ; vucomisd xmm9, xmm10
     vzeroupper ; vzeroall
     fadd dword ptr [rbx] ; fmul qword ptr [rbx] ; fsub dword ptr [rbx]
     fsubr qword ptr [rbx] ; fdiv dword ptr [rbx] ; fdivr qword ptr [rbx]
     fcom qword ptr [rbx] ; fcomp dword ptr [rbx]
     fadd st, st(3) ; fmul st(2), st ; fsub st, st(1) ; fdivr st(4), st
     faddp st(1), st ; fsubp st(2), st ; fdivrp st(1), st ; fmulp st(3), st
     fld dword ptr [rbx] ; fld qword ptr [rbx] ; fild word ptr [rbx]
     fild dword ptr [rbx] ; fild qword ptr [rbx] ; fld st(2) ; fld1 ; fldz
     fst dword ptr [rbx] ; fstp qword ptr [rbx] ; fst st(3) ; fstp st(1)
     fist word ptr [rbx] ; fist dword ptr [rbx] ; fistp word ptr [rbx]
     fistp dword ptr [rbx] ; fistp qword ptr [rbx] ; fisttp dword ptr [rbx]
     fisttp qword ptr [rbx] ; fxch st(3) ; fchs ; fabs
     fcomi st, st(2) ; fucomi st, st(1) ; fcomip st, st(3) ; fucom st(1)
     fucompp ; fnstsw ax ; fnstsw [rbx] ; fnstcw [rbx] ; fldcw [rbx]
     fnclex ; ffree st(2) ; stmxcsr [rbx] ; ldmxcsr [rbx] ; emms ; fninit
     fxsave [rbx]
     jmp top
"""
FP_CODE = bytes.fromhex(
    "f30f6f03660f6fca0f111bf30f1023f20f10eef3410f10f8664c0f6ec866440f"
    "6ed1664c0f7eda66440f7ee6f3440f7e2b440f1233440f163b0f12c10f16d30f"
    "13230f172bf20f1133f30f113b660fefc10f5713660febdc660fdbee66410fdf"
    "f866450f74ca66440f751b66450f76e566450ff8f7660ffc03660fdaca660f6c"
    "dc660f70ee1b660f73ff0366410f73d80d66440f620b66440fd41366410f73f3"
    "0566410f73d43f66410f73f54066440fc4f00366440fc43b01660fc5c805660f"
    "d7d1660f3817d3f30f58c1f20f58130f58dc660f582bf30f5c33f2410f5cf844"
    "0f5c0b66450f5cd3f3450f59e5f2440f5933440f59f8660f59caf30f5e1bf20f"
    "5ee50f5ef766440f5e03f3450f5dcaf2440f5d1b450f5de566450f5df7f30f5f"
    "03f20f5fca0f5f1b660f5fe5f30f51f7f2440f5103450f51ca66450f51dcf345"
    "0fc2ee00f2440fc23b010fc2c102660fc2d303f20fc2e504f30fc2330566410f"
    "c2f806450fc2ca07450f2edc66440f2e2b440f2f3366440f2ff8f30f2ac8f348"
    "0f2ad1f20f2ad8f2480f2ae1f20f2a2bf3480f2a33f30f2dc7f2490f2dc8f349"
    "0f2cd1f2410f2cf2f20f2d03f3480f2c0bf3450f5adcf2440f5a2b450f5af766"
    "0f5a030f5bca660f5b1bf30f5be5f30fe6f7f2450fe6c166440fe613450fc6dc"
    "4e66440fc62b01450f14f70f1503660f14ca660f15dcc5d358eec4c14351f8c4"
    "41792ecac5f877c5fc77d803dc0bd823dc2bd833dc3bdc13d81bd8c3dccad8e1"
    "dcf4dec1deeadef1decbd903dd03df03db03df2bd9c2d9e8d9eed913dd1bddd3"
    "ddd9df13db13df1bdb1bdf3bdb0bdd0bd9cbd9e0d9e1dbf2dbe9dff3dde1dae9"
    "dfe0dd3bd93bd92bdbe2ddc20fae1b0fae130f77dbe30fae03e982fdffff")
FP_CODE_GVA = 0x0001_6000_0000
FP_STEPS = 6
# the operand values of tests/test_ssefp.py and tests/test_x87.py: signed
# zeros and infinities, NaNs with payloads, denormals, normals, values
# whose products are denormal or underflow, +-2**63 and the 2**31 edge
F64_VALUES = [
    0x0, 0x8000000000000000, 0x7FF0000000000000, 0xFFF0000000000000,
    0x7FF8000000001234, 0x7FF0000000000BAD, 0xFFF8000000000000, 0x1,
    0x800FFFFFFFFFFFFF, 0x0010000000000000, 0x7FEFFFFFFFFFFFFF,
    0x3FF0000000000000, 0x4000000000000000, 0x3FE0000000000000,
    0xC045000000000000, 0x400921FB54442D18, 0x2000000000000000,
    0x1FF0000000000000, 0x3C90000000000000, 0x43E0000000000000,
    0xC3E0000000000000, 0x43DFFFFFFFFFFFFF, 0x41E0000000000000,
    0x41DFFFFFFFE00000, 0x4004000000000000, 0xC004000000000000]
F32_VALUES = [
    0x0, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00123, 0x7F800001,
    0xFFC00000, 0x1, 0x807FFFFF, 0x00800000, 0x7F7FFFFF, 0x3F800000,
    0x40000000, 0x3F000000, 0xC2280000, 0x40490FDB, 0x20000000,
    0x1F800000, 0x5F000000, 0xDF000000, 0x4F000000, 0x40200000]
INT_VALUES = [0, 1, -1, 2**31 - 1, -2**31, 2**63 - 1, -2**63,
              12345678901234567, 0x7FFF_FFFF_FFFF_FC00]

# Phase 20's guest: a loop of integer code, an SSE copy and zeroing, SSE
# FP and x87 arithmetic; rcx is its trip count (GNU as, Intel syntax).
FPLOOP_ASM = """
top: add r8, rcx ; imul r9, r8, 0x9e37 ; xor r10, r9 ; lea rdx, [r8 + r9*2]
     movdqu xmm0, [rbx] ; movdqu xmm1, [rbx + 16] ; movdqu [rdi], xmm0
     movdqu [rdi + 16], xmm1 ; pxor xmm2, xmm2 ; movdqu [rdi + 32], xmm2
     cvtsi2sd xmm3, r8 ; mulsd xmm3, [rsi] ; divsd xmm3, [rsi + 8]
     sqrtsd xmm4, xmm3 ; cvttsd2si rax, xmm4 ; add r11, rax
     mov [rdi + 48], r8 ; fild qword ptr [rdi + 48]
     fmul qword ptr [rsi + 16] ; fistp qword ptr [rdi + 56] ; fnstsw ax
     add r12, [rdi + 56] ; add rbx, 8 ; dec rcx ; jnz top
     int3
"""
FPLOOP_CODE = bytes.fromhex(
    "4901c84d69c8379e00004d31ca4b8d1448f30f6f03f30f6f4b10f30f7f07f30f"
    "7f4f10660fefd2f30f7f5720f2490f2ad8f20f591ef20f5e5e08f20f51e3f248"
    "0f2cc44901c34c894730df6f30dc4e10df7f38dfe04c0367384883c30848ffc9"
    "759ecc")
FPLOOP_GVA = 0x0001_7000_0000
FPLOOP_CONSTS = (1.5, 3.0, 0.25)


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
    each call; `setup` runs untimed before each), after one untimed
    warm-up call, so a first launch's cost is not in the mean."""
    import torch

    if setup is not None:
        setup()
    fn()
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
# phases 3 and 7: seeded random machines
# ---------------------------------------------------------------------------

def s64(v: int) -> int:
    """The int64 with the low 64 bits of v (guest addresses above 2**63)."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def decode_all(runner, view, code: bytes, base: int) -> list:
    """Publish every instruction of `code` at `base` -> their rips."""
    from wtf_tpu_torch.cpu.decoder import decode

    rips, off = [], 0
    while off < len(code):
        rip = base + off
        rips.append(rip)
        runner._decode_at(view, 0, rip)
        off += decode(code[off:off + 15], rip).length
    return rips


def grid_state(n_lanes: int, seed: int, dev, slots: int = SLOTS,
               ragged: bool = False):
    """(tab, image, machine, limit) of n_lanes random lanes of the grid
    guest, every lane at a random instruction boundary.  `ragged` fills
    the overlay row index the way the first set never does: counts up to
    `slots`, a quarter of the lanes with their data pfns only past row
    31, and a quarter with non-free rows past `count`."""
    import torch

    from wtf_tpu_torch.core.results import StatusCode
    from wtf_tpu_torch.interp.runner import Runner
    from wtf_tpu_torch.snapshot.loader import Snapshot
    from wtf_tpu_torch.snapshot.synthetic import SyntheticSnapshotBuilder

    b = SyntheticSnapshotBuilder()
    b.write(GRID_CODE_GVA, GRID_CODE)
    b.write(GRID_KCODE_GVA, GRID_CODE)
    b.map(GRID_DATA_GVA, 0x4000)
    b.map(GRID_KDATA_GVA, 0x2000)
    b.map(GRID_RO_GVA, 0x1000, writable=False)
    b.map(GRID_STACK_TOP - 0x8000, 0x9000)
    pages, cpu = b.build(rip=GRID_CODE_GVA, rsp=GRID_STACK_TOP - 0x1000)
    r = Runner(Snapshot.from_pages(pages, cpu), n_lanes=n_lanes,
               overlay_slots=slots, device=dev)
    view = r.view()
    rips = decode_all(r, view, GRID_CODE, GRID_CODE_GVA)
    krips = decode_all(r, view, GRID_CODE, GRID_KCODE_GVA)
    # breakpoints on two hot instructions (lanes with bp_skip pass them)
    for rip in (rips[3], rips[40]):
        r.cache.set_breakpoint(rip)
    g = torch.Generator(device=dev).manual_seed(seed)
    m = r.machine
    n = n_lanes

    def rint(lo, hi, shape=(n,)):
        return torch.randint(lo, hi, shape, generator=g, device=dev)

    def pick(values, shape=(n,)):
        v = torch.tensor([s64(x) for x in values], dtype=torch.int64,
                         device=dev)
        return v[rint(0, len(values), shape)]

    # a quarter of the lanes run the high-half copy of the code, and a
    # quarter address the high-half data (canonical-negative walks, and
    # mix64 of a negative rip in the edge hash)
    m.rip = torch.where(rint(0, 4) == 0, pick(krips), pick(rips))
    m.gpr = rint(-2**63, 2**63 - 1, (n, 16))
    small = rint(0, 2, (n,)) == 1
    m.gpr[:, 1] = torch.where(small, rint(0, 4), m.gpr[:, 1])
    m.gpr[:, 3] = torch.where(rint(0, 4) == 0, s64(GRID_KDATA_GVA),
                              GRID_DATA_GVA) + rint(0, 0x1000)  # rbx
    bad_rbx = rint(0, 16) == 0
    m.gpr[:, 3] = torch.where(bad_rbx, rint(0, 2**40), m.gpr[:, 3])
    m.gpr[:, 4] = GRID_STACK_TOP - 0x1000 - 8 * rint(0, 64)    # rsp
    m.gpr[:, 4] = torch.where(rint(0, 16) == 0, rint(0, 2**40), m.gpr[:, 4])
    m.gpr[:, 13] = pick([GRID_DATA_GVA + 0x40, GRID_RO_GVA + 8,
                         GRID_DATA_GVA + 0x3ffc, 0x7000_0000_0000,
                         GRID_KDATA_GVA + 0x1ffc, -2**47])
    m.gpr[:, 14] = pick([GRID_DATA_GVA + 0x80, GRID_RO_GVA, 0x1000,
                         GRID_KDATA_GVA + 0x80])
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
    if ragged:
        count = pick([0, 3, slots - 2, slots - 1, slots]).where(
            rint(0, 2) == 0, rint(0, slots + 1))
    else:
        count = torch.where(rint(0, 10) == 0, slots, rint(0, 6))
    rows = torch.arange(slots, device=dev)[None, :]
    pfns = pick(data_pfns + [7, 1 << 20], (n, slots))
    used = rows < count[:, None]
    if ragged:
        # pfns no lookup asks for (past the image's frames, not PFN_OOB)
        junk = (1 << 21) + rows.expand(n, slots)
        deep = (rint(0, 4) == 0)[:, None] & (rows < 32)
        pfns = torch.where(deep, junk, pfns)
        used |= (rint(0, 4) == 0)[:, None]      # non-free rows past count
    ov.pfn.copy_(torch.where(used, pfns, -1).int())
    ov.count.copy_(count.int())
    ov.valid.copy_((rint(0, 2, tuple(ov.valid.shape)) *
                    used[..., None]).to(torch.uint8))
    ov.data.copy_(rint(-2**63, 2**63 - 1, tuple(ov.data.shape)))
    return r.cache.device(dev), r.image, m, 1000


def sys_state(n_lanes: int, seed: int, dev):
    """(runner, machine) of n_lanes random lanes of the phase-7 guest, each
    at a random instruction of it, with registers drawn to reach the
    classes' corner cases (divisors 0, -1 and INT64_MIN, negative bit
    offsets, known MSR ids and CPUID leaves, rep counts 0-3, DF set or
    clear, canonical and non-canonical fs/gs bases)."""
    import torch

    from wtf_tpu_torch.core.results import StatusCode
    from wtf_tpu_torch.interp.runner import Runner
    from wtf_tpu_torch.snapshot.loader import Snapshot
    from wtf_tpu_torch.snapshot.synthetic import SyntheticSnapshotBuilder

    b = SyntheticSnapshotBuilder()
    b.write(SYS_CODE_GVA, SYS_CODE)
    b.map(GRID_DATA_GVA, 0x4000)
    b.map(GRID_KDATA_GVA, 0x2000)
    b.map(GRID_STACK_TOP - 0x8000, 0x9000)
    pages, cpu = b.build(rip=SYS_CODE_GVA, rsp=GRID_STACK_TOP - 0x1000)
    cpu.lstar = SYS_CODE_GVA
    cpu.star = 0x0023_0010_0000_0000
    cpu.sfmask = 0x4700
    cpu.kernel_gs_base = GRID_KDATA_GVA
    r = Runner(Snapshot.from_pages(pages, cpu), n_lanes=n_lanes,
               overlay_slots=16, device=dev)
    rips = decode_all(r, r.view(), SYS_CODE, SYS_CODE_GVA)
    g = torch.Generator(device=dev).manual_seed(seed)
    m = r.machine
    n = n_lanes

    def rint(lo, hi, shape=(n,)):
        return torch.randint(lo, hi, shape, generator=g, device=dev)

    def pick(values, shape=(n,)):
        v = torch.tensor([s64(x) for x in values], dtype=torch.int64,
                         device=dev)
        return v[rint(0, len(values), shape)]

    def data_ptr(span):
        base = torch.where(rint(0, 4) == 0, s64(GRID_KDATA_GVA),
                           GRID_DATA_GVA)
        ptr = base + rint(0, span)
        return torch.where(rint(0, 16) == 0, rint(0, 2**40), ptr)

    m.rip = pick(rips)
    m.gpr = rint(-2**63, 2**63 - 1, (n, 16))
    m.gpr[:, 0] = torch.where(rint(0, 2) == 0, pick(
        [0, 1, 7, 0xD, 0x1234, 0x4000_0000, 0x8000_0001, -2**63, -5]),
        m.gpr[:, 0])
    m.gpr[:, 1] = pick([0, 1, 2, 3, -1, -2**63, 7, -9, -0x4000, 100,
                        0x10, 0xC000_0080, 0xC000_0082, 0xC000_0102,
                        0x1234_5678]).where(rint(0, 4) > 0, m.gpr[:, 1])
    m.gpr[:, 2] = torch.where(rint(0, 2) == 0, 0, m.gpr[:, 2])
    m.gpr[:, 3] = data_ptr(0x1000)                              # rbx
    m.gpr[:, 4] = GRID_STACK_TOP - 0x1000 - 8 * rint(0, 64)    # rsp
    m.gpr[:, 5] = GRID_STACK_TOP - 0x800 - 8 * rint(0, 64)     # rbp
    m.gpr[:, 6] = data_ptr(0x1000)                              # rsi
    m.gpr[:, 7] = data_ptr(0x1000)                              # rdi
    m.rflags = (rint(0, 1 << 12) | 2) | (rint(0, 1 << 20) << 32)
    m.icount = rint(0, 1 << 40)
    m.tsc = rint(0, 1 << 50)
    m.rdrand = rint(-2**63, 2**63 - 1)
    m.fs_base = pick([0, GRID_DATA_GVA, -2**63])
    m.gs_base = pick([0, GRID_KDATA_GVA])
    m.star = pick([0x0023_0010_0000_0000, 0x0033_0008_0000_0000])
    m.bp_skip = (rint(0, 3) == 0).to(torch.int32)
    status = torch.full((n,), int(StatusCode.RUNNING), device=dev)
    others = pick([int(StatusCode.OK), int(StatusCode.CRASH),
                   int(StatusCode.NEEDS_XLA)])
    m.status = torch.where(rint(0, 10) == 0, others, status).int()
    m.ctr = rint(0, 1 << 20, (n, 6)).int()
    return r, m


def fp_state(n_lanes: int, seed: int, dev):
    """(runner, machine) of n_lanes random lanes of the phase-19 guest,
    each at a random instruction of it: xmm registers, x87 slots and data
    pages from the FP value sets, a random stack top, tag word and
    rounding control, integers for the converts, and on a quarter of the
    lanes a memory operand at the end of the data pages (the page after
    them is not mapped)."""
    import random
    import struct

    import torch

    from wtf_tpu_torch.core.results import StatusCode
    from wtf_tpu_torch.interp.runner import Runner
    from wtf_tpu_torch.snapshot.loader import Snapshot
    from wtf_tpu_torch.snapshot.synthetic import SyntheticSnapshotBuilder

    rng = random.Random(seed)
    words = [rng.choice(F64_VALUES) if rng.random() < 0.5 else
             rng.choice(F32_VALUES) | rng.choice(F32_VALUES) << 32
             for _ in range(0x4000 // 8)]
    b = SyntheticSnapshotBuilder()
    b.write(FP_CODE_GVA, FP_CODE)
    b.write(GRID_DATA_GVA, struct.pack(f"<{len(words)}Q", *words))
    b.map(GRID_STACK_TOP - 0x8000, 0x9000)
    pages, cpu = b.build(rip=FP_CODE_GVA, rsp=GRID_STACK_TOP - 0x1000)
    r = Runner(Snapshot.from_pages(pages, cpu), n_lanes=n_lanes,
               overlay_slots=16, device=dev)
    rips = decode_all(r, r.view(), FP_CODE, FP_CODE_GVA)
    g = torch.Generator(device=dev).manual_seed(seed)
    m = r.machine
    n = n_lanes

    def rint(lo, hi, shape=(n,)):
        return torch.randint(lo, hi, shape, generator=g, device=dev)

    def pick(values, shape=(n,)):
        v = torch.tensor([s64(x) for x in values], dtype=torch.int64,
                         device=dev)
        return v[rint(0, len(values), shape)]

    m.rip = pick(rips)
    half = (n, 16, 2)
    f32x2 = pick(F32_VALUES, half) | (pick(F32_VALUES, half) << 32)
    vals = torch.where(rint(0, 2, half) == 0, pick(F64_VALUES, half), f32x2)
    vals = torch.where(rint(0, 8, half) == 0, rint(-2**63, 2**63 - 1, half),
                       vals)
    m.xmm = torch.cat([vals, rint(-2**63, 2**63 - 1, half)], 2)
    m.fpst = pick(F64_VALUES, (n, 8))
    m.fpsw = (rint(0, 1 << 16) & ~0x3800) | (rint(0, 8) << 11)
    m.fpcw = 0x27F | (rint(0, 4) << 10)
    m.fptw = rint(0, 1 << 16)
    m.gpr = rint(-2**63, 2**63 - 1, (n, 16))
    m.gpr[:, 0] = pick(INT_VALUES)
    m.gpr[:, 1] = pick(INT_VALUES)
    m.gpr[:, 3] = torch.where(rint(0, 4) == 0,
                              GRID_DATA_GVA + 0x4000 - rint(1, 20),
                              GRID_DATA_GVA + rint(0, 0x3FF0))      # rbx
    m.gpr[:, 4] = GRID_STACK_TOP - 0x1000 - 8 * rint(0, 64)        # rsp
    m.rflags = (rint(0, 1 << 12) | 2) | (rint(0, 1 << 20) << 32)
    m.icount = rint(0, 1 << 40)
    status = torch.full((n,), int(StatusCode.RUNNING), device=dev)
    others = pick([int(StatusCode.OK), int(StatusCode.CRASH),
                   int(StatusCode.NEEDS_XLA)])
    m.status = torch.where(rint(0, 10) == 0, others, status).int()
    m.ctr = rint(0, 1 << 20, (n, 6)).int()
    return r, m


def fp_loop(n_lanes: int, dev, burst_any_tier: bool):
    """A Runner (fused step on, n_lanes x SLOTS overlay rows) on phase 20's
    guest, every instruction decoded, each lane with its own trip count
    (1-12), seed value and buffer offsets (drawn on the CPU, so the same
    on any device)."""
    import random
    import struct

    import torch

    from wtf_tpu_torch.interp.runner import Runner
    from wtf_tpu_torch.snapshot.loader import Snapshot
    from wtf_tpu_torch.snapshot.synthetic import SyntheticSnapshotBuilder

    rng = random.Random(20)
    b = SyntheticSnapshotBuilder()
    b.write(FPLOOP_GVA, FPLOOP_CODE)
    b.write(GRID_DATA_GVA, bytes(rng.getrandbits(8) for _ in range(0x1000)))
    b.map(GRID_DATA_GVA + 0x1000, 0x1000)                 # the copies
    b.write(GRID_DATA_GVA + 0x2000, struct.pack("<3d", *FPLOOP_CONSTS))
    b.map(GRID_STACK_TOP - 0x8000, 0x9000)
    pages, cpu = b.build(rip=FPLOOP_GVA, rsp=GRID_STACK_TOP - 0x1000)
    r = Runner(Snapshot.from_pages(pages, cpu), n_lanes=n_lanes,
               overlay_slots=SLOTS, fused_step="on",
               burst_any_tier=burst_any_tier, device=dev)
    decode_all(r, r.view(), FPLOOP_CODE, FPLOOP_GVA)
    g = torch.Generator().manual_seed(20)

    def rint(lo, hi):
        return torch.randint(lo, hi, (n_lanes,), generator=g)

    regs = {1: 1 + rint(0, 12), 8: rint(-2**40, 2**40),
            3: GRID_DATA_GVA + 8 * rint(0, 32),
            6: torch.full((n_lanes,), GRID_DATA_GVA + 0x2000),
            7: GRID_DATA_GVA + 0x1000 + 8 * rint(0, 0x100)}
    for idx, value in regs.items():
        r.machine.gpr[:, idx] = value.to(r.machine.device)
    return r


def loop_outcome(runner) -> dict:
    """sha256 of every plane of a finished phase-20 batch and of the copy
    page of its first 64 lanes, as each lane's view reads it."""
    import hashlib

    out = {name: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
           for name, t in runner.machine.planes()}
    view = runner.view()
    pfn = view.translate(0, GRID_DATA_GVA + 0x1000) >> 12
    out["copy pages"] = hashlib.sha256(b"".join(
        view.page(lane, pfn) for lane in range(64))).hexdigest()
    return out


def fp_loop_cpu() -> dict:
    """The CPU side of phase 20: the same batch, the same burst tier."""
    r = fp_loop(LANES, "cpu", True)
    t0 = time.perf_counter()
    r.run()
    return {"outcome": loop_outcome(r), "s": time.perf_counter() - t0,
            "fallbacks": r.stats["fallbacks"]}


def machine_to_cpu(dst, src) -> None:
    """Copy every plane of machine `src` into the same-shaped `dst`."""
    for (_, a), (_, b) in zip(dst.planes(), src.planes()):
        a.copy_(b.cpu())


# ---------------------------------------------------------------------------
# phases (each a function, so one phase's tensors are freed before the next)
# ---------------------------------------------------------------------------

def kernel_record(name, source, replaces) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": None,
            "ms": None, "plain_ms": None, "bound_ms": None,
            "bound_by": "bytes", "library_ms": None,
            "launch_floor_ms": None}


def phase_build(record: dict) -> str:
    import torch

    from wtf_tpu_torch.csrc import build
    from wtf_tpu_torch.interp import pstep

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
    grid, block, shared = pstep.launch_geometry(LANES, SLOTS)
    warps = pstep.occupancy(LANES, SLOTS)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"phase 1: K1 at {LANES} lanes x {SLOTS} rows: {grid} blocks of "
          f"{block} threads (one warp per lane), {shared} shared bytes per "
          f"block; {warps} warps resident per SM (occupancy calculator), "
          f"{warps * sms} on the card's {sms} SMs")
    record["k1_geometry"] = {"grid": grid, "block": block,
                             "shared_bytes": shared,
                             "warps_per_sm": warps, "sms": sms}
    return card


def phase_probe(dev, k1: dict, k2: dict) -> None:
    import torch

    from wtf_tpu_torch.csrc import build
    from wtf_tpu_torch.interp import pstep

    x = torch.tensor([41], dtype=torch.int32, device=dev)
    got = int(pstep.probe_kernel(x).item())
    check(got == 42, f"probe kernel returned {got} for 41")
    k2["max_abs_err"] = abs(got - 42)
    # K2 and the launch floor (an empty kernel from the same source, so no
    # launch, K2's above all, reads as faster than the card can start one)
    # are timed alike: the raw ctypes call of each.  The wrapper's time
    # (a library lookup, an output allocation and the call) is kept apart.
    lib = build.library("probe")
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty_like(x)

    def raw():
        err = lib.wtf_probe(x.data_ptr(), out.data_ptr(), stream)
        check(err == 0, f"probe kernel launch failed: cuda error {err}")

    def empty():
        err = lib.wtf_empty(stream)
        check(err == 0, f"empty kernel launch failed: cuda error {err}")

    k2["ms"] = cuda_ms(raw, 20)
    check(int(out.item()) == 42, f"raw probe launch gave {int(out.item())}")
    k2["wrapper_ms"] = cuda_ms(lambda: pstep.probe_kernel(x), 20)
    # the plain version is itself one PyTorch call of the same function
    k2["plain_ms"] = k2["library_ms"] = cuda_ms(lambda: x + 1, 20)
    k2["bound_ms"] = 8 / HBM_BYTES_PER_S * 1e3
    floor = cuda_ms(empty, 20)
    k1["launch_floor_ms"] = k2["launch_floor_ms"] = floor
    print(f"phase 2: probe kernel ok ({k2['ms']:.4f} ms per raw launch, "
          f"{k2['wrapper_ms']:.4f} ms through its wrapper); launch floor "
          f"(empty kernel) {floor:.4f} ms; x + 1 {k2['plain_ms']:.4f} ms "
          f"(each timed warm, CUDA events)")


def phase_random(dev, k1: dict) -> None:
    import numpy as np
    import torch

    from wtf_tpu_torch.interp import pstep
    from wtf_tpu_torch.interp.machine import CTR_INSTR

    for n, slots, ragged in ((LANES, SLOTS, False),
                             (RAGGED_LANES, RAGGED_SLOTS, True)):
        t0 = time.perf_counter()
        tab, img, m0, limit = grid_state(n, 3, dev, slots, ragged)
        mk, mp = m0.clone(), m0.clone()
        pstep.fused_step(tab, img, mk, limit, 32)
        torch.cuda.synchronize()
        pstep.fused_step_plain(tab, img, mp, limit, 32)
        torch.cuda.synchronize()
        bad, err = plane_diff(mk, mp)
        check(not bad, f"K1 differs from fused_step_plain in {bad} on "
                       f"{n} lanes x {slots} rows (max abs err {err})")
        st = mk.status.cpu().numpy()
        ctr = (mk.ctr - m0.ctr).cpu().numpy().astype(np.int64)
        counts = {int(k): int(v) for k, v in zip(*np.unique(
            st, return_counts=True))}
        full = int((mk.overlay.count == slots).sum())
        print(f"phase 3: K1 == fused_step_plain on {n} random lanes x "
              f"{slots} overlay rows{' (ragged)' if ragged else ''}, k=32, "
              f"all planes bit-identical: retired "
              f"{int(ctr[:, CTR_INSTR].sum())}, parks subset/mem "
              f"{int(ctr[:, 4].sum())}/{int(ctr[:, 5].sum())}, rows "
              f"claimed {int((mk.overlay.count - m0.overlay.count).sum())}, "
              f"lanes ending at count == slots {full}, statuses {counts} "
              f"({time.perf_counter() - t0:.1f} s)")
        k1["max_abs_err"] = max(k1["max_abs_err"] or 0, err)


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
    k1["launches_by_path"] = {"demo_tlv": launches["fused_step"]}
    k2["launches_by_path"] = {"demo_tlv": launches["probe"]}
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
    k1["plain_ms"] = cuda_ms(lambda: pstep.fused_step_plain(
        tab, img, work["m"], runner.limit, 32), 1, setup=fresh)
    mp = work.pop("m")
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

    profiled_rerun("phase 5", CAMPAIGN, record["campaign"],
                   launches["fused_step"], wall)


def profiled_rerun(phase: str, argv: list, rec: dict, k1_launches: int,
                   wall: float) -> None:
    """The same campaign again under torch.profiler: what the card itself
    was busy with (the first run stays unprofiled, so its wall is the
    user's) and so the host's share of that wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from wtf_tpu_torch import cli
    from wtf_tpu_torch.interp import pstep

    launched = pstep.LAUNCHES["fused_step"]
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loop = cli.campaign(cli.build_parser().parse_args(argv))
        torch.cuda.synchronize()
    wall_prof = time.perf_counter() - t0
    launched = pstep.LAUNCHES["fused_step"] - launched
    check(loop.stats.testcases == rec["testcases"],
          "the profiled campaign ran a different number of testcases")
    busy, per_kernel = device_busy(prof)
    check(busy > 0, "torch.profiler recorded no device activity")
    k1_n, k1_s = (sum(v[i] for name, v in per_kernel.items()
                      if "fused_step_kernel" in name)
                  for i in (0, 1))
    check(k1_n == k1_launches,
          f"the trace holds {k1_n} K1 launches, the campaign made "
          f"{k1_launches} ({launched} in the profiled rerun itself, "
          f"{sum(n for n, _ in per_kernel.values())} device records in "
          f"the trace)")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])
    n_dev = sum(n for n, _ in per_kernel.values())
    print(f"{phase}: profiled rerun ({wall_prof:.2f} s wall): card busy "
          f"{busy:.3f} s over {n_dev} kernels and copies = host share "
          f"{1 - busy / wall:.3f} of the unprofiled run's {wall:.2f} s; "
          f"K1 {k1_n} launches, {k1_s / k1_n * 1e3:.3f} ms mean; top by "
          f"device time: " + "; ".join(
              f"{name[:40]} x{n} {sec:.3f} s" for name, (n, sec) in top[:4]))
    rec.update({
        "profiled_wall_s": wall_prof, "device_busy_s": busy,
        "host_share": 1 - busy / wall, "device_launches": n_dev,
        "k1_ms_mean_trace": k1_s / k1_n * 1e3,
        "top_device": [(name, n, sec) for name, (n, sec) in top[:20]]})
    del loop
    torch.cuda.empty_cache()


def small_campaign(name: str, device: str, limit: int = 20000,
                   extra: tuple = (), seeded: bool = False) -> tuple:
    """(corpus digests, crash names, cov bytes, edge bytes, statuses,
    seconds) of a 64-lane, 256-run campaign at seed 5 on `device`
    (`extra`: more campaign flags; `seeded`: inputs/ holds the target's
    seed input)."""
    from wtf_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        a = cli.build_parser().parse_args(
            ["campaign", "--name", name, "--fused-step", "on", "--lanes",
             "64", "--runs", "256", "--limit", str(limit), "--max_len", "96",
             "--seed", "5", "--device", device, *extra,
             *(seeded_target(name, tmp) if seeded else [])])
        t0 = time.perf_counter()
        loop = cli.campaign(a)
        return outcome(loop) + (time.perf_counter() - t0,)


def seeded_target(name: str, tmp: str) -> list:
    """`--target` flags for a fresh target dir under `tmp` whose inputs/
    holds `name`'s seed inputs (none for a target without seeds)."""
    if name not in TARGET_SEEDS:
        return []
    inputs = Path(tmp) / "target" / "inputs"
    inputs.mkdir(parents=True, exist_ok=True)
    for i, data in enumerate(TARGET_SEEDS[name]):
        (inputs / f"seed{i}").write_bytes(data)
    return ["--target", str(Path(tmp) / "target")]


def outcome(loop) -> tuple:
    """(corpus digests, crash names, cov bytes, edge bytes, statuses) of a
    finished campaign."""
    b = loop.backend
    return (sorted(loop.corpus.digests), sorted(loop.crash_names),
            b._agg_cov.cpu().numpy().tobytes(),
            b._agg_edge.cpu().numpy().tobytes(), dict(b.status_counts))


def replay_runs(name: str, inputs: dict, device: str) -> list:
    """[(input, result, rip, icount)] of `run --name name` over inputs."""
    from wtf_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        for key, data in inputs.items():
            (Path(tmp) / key).write_bytes(data)
        a = cli.build_parser().parse_args(
            ["run", "--name", name, "--input", tmp, "--fused-step", "on",
             "--limit", "100000", "--device", device])
        _, runs = cli.replay(a)
    return [(r.path.name, str(r.result), r.rip, r.icount) for r in runs]


def cpu_job(fn, threads: int, *args):
    """Run fn(*args) in a worker process on `threads` CPU threads."""
    import torch

    torch.set_num_threads(threads)
    return fn(*args)


def phase_card_vs_cpu(cpu) -> None:
    card = small_campaign("demo_tlv", "cuda")
    want = cpu["demo_tlv"].result()
    check(all(card[i] == want[i] for i in range(4)),
          "64-lane campaign differs between card and cpu")
    print(f"phase 6: 64-lane 256-run campaign, card == cpu: "
          f"{len(card[0])} corpus digests, {len(card[1])} crash names, "
          f"equal cov/edge bytes (card {card[5]:.1f} s, cpu {want[5]:.1f} s "
          f"in a worker process)")


def phase_step_sys(dev, record: dict) -> None:
    import numpy as np
    import torch

    from wtf_tpu_torch.interp import step as S
    from wtf_tpu_torch.interp.machine import CTR_INSTR

    t0 = time.perf_counter()
    rg, mg = sys_state(LANES, 7, dev)
    rc, mc = sys_state(LANES, 7, "cpu")      # same guest, same decode order
    machine_to_cpu(mc, mg)
    tab_g, tab_c = rg.cache.device(dev), rc.cache.device("cpu")
    start = mg.clone()
    groups_seen, ms = [], 0.0
    for _ in range(SYS_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pre, _, groups = S.scan(tab_g, rg.image, mg)
        S.step(tab_g, rg.image, mg, 1 << 41, pre, groups)
        torch.cuda.synchronize()
        ms += (time.perf_counter() - t1) * 1e3
        S.step(tab_c, rc.image, mc, 1 << 41)
        groups_seen.append(sorted(groups))
    bad = [name for (name, a), (_, b) in zip(mc.planes(), mg.planes())
           if not torch.equal(a, b.cpu())]
    check(not bad, f"the precise step differs between card and cpu in {bad}")
    st = mg.status.cpu().numpy()
    counts = {int(k): int(v) for k, v in zip(*np.unique(
        st, return_counts=True))}
    retired = int((mg.ctr[:, CTR_INSTR] - start.ctr[:, CTR_INSTR]).sum())
    print(f"phase 7: precise step on {LANES} random lanes of the integer and "
          f"system classes, {SYS_STEPS} steps, card == cpu on every plane: "
          f"retired {retired}, statuses {counts}, groups per step "
          f"{groups_seen[0]}; card {ms / SYS_STEPS:.1f} ms per step "
          f"(host clock) ({time.perf_counter() - t0:.1f} s)")
    record["step_sys"] = {"lanes": LANES, "steps": SYS_STEPS,
                          "retired": retired, "statuses": counts,
                          "card_ms_per_step": ms / SYS_STEPS}


FP_GROUPS = frozenset({"sse", "ssefp", "x87"})


def phase_step_fp(dev, record: dict) -> None:
    import numpy as np
    import torch

    from wtf_tpu_torch.core.results import StatusCode
    from wtf_tpu_torch.interp import step as S
    from wtf_tpu_torch.interp.machine import CTR_INSTR

    t0 = time.perf_counter()
    rg, mg = fp_state(LANES, 19, dev)
    rc, mc = fp_state(LANES, 19, "cpu")      # same guest, same decode order
    machine_to_cpu(mc, mg)
    tab_g, tab_c = rg.cache.device(dev), rc.cache.device("cpu")
    start = mg.clone()
    groups_seen, ms = [], 0.0
    for _ in range(FP_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pre, _, groups = S.scan(tab_g, rg.image, mg)
        S.step(tab_g, rg.image, mg, 1 << 41, pre, groups)
        torch.cuda.synchronize()
        ms += (time.perf_counter() - t1) * 1e3
        S.step(tab_c, rc.image, mc, 1 << 41)
        groups_seen.append(sorted(groups))
    bad = [name for (name, a), (_, b) in zip(mc.planes(), mg.planes())
           if not torch.equal(a, b.cpu())]
    check(not bad, f"the precise step's SSE and x87 classes differ "
                   f"between card and cpu in {bad}")
    check(FP_GROUPS <= set(groups_seen[0]),
          f"phase 19's first step computed only {groups_seen[0]}")
    st = mg.status.cpu().numpy()
    counts = {int(k): int(v) for k, v in zip(*np.unique(
        st, return_counts=True))}
    check(counts.get(int(StatusCode.UNSUPPORTED), 0) > 0
          and counts.get(int(StatusCode.PAGE_FAULT), 0) > 0,
          f"phase 19 reached no oracle divert or no page fault: {counts}")
    retired = int((mg.ctr[:, CTR_INSTR] - start.ctr[:, CTR_INSTR]).sum())
    # the FP groups' cost on the card: one step from the start state with
    # the groups scan finds, and with the FP groups left out (whose lanes
    # then compute nothing right: timed only), in turns
    per = {"with": [], "without": []}
    for key in ("with", "without", "without", "with"):
        m = start.clone()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pre, _, groups = S.scan(tab_g, rg.image, m)
        if key == "without":
            groups = groups - FP_GROUPS
        S.step(tab_g, rg.image, m, 1 << 41, pre, groups)
        torch.cuda.synchronize()
        per[key].append((time.perf_counter() - t1) * 1e3)
    with_ms, without_ms = min(per["with"]), min(per["without"])
    print(f"phase 19: precise step on {LANES} random lanes of the SSE, "
          f"SSE-FP and x87 classes, {FP_STEPS} steps, card == cpu on every "
          f"plane (status included): retired {retired}, statuses {counts}, "
          f"groups per step {groups_seen[0]}; card "
          f"{ms / FP_STEPS:.1f} ms per step (host clock); one step from the "
          f"start {with_ms:.1f} ms with the FP groups, {without_ms:.1f} ms "
          f"without ({time.perf_counter() - t0:.1f} s)")
    record["step_fp"] = {"lanes": LANES, "steps": FP_STEPS,
                         "retired": retired, "statuses": counts,
                         "groups": groups_seen,
                         "card_ms_per_step": ms / FP_STEPS,
                         "step_ms_with_fp_groups": per["with"],
                         "step_ms_without_fp_groups": per["without"]}


def phase_fp_loop(k1: dict, k2: dict, record: dict) -> dict:
    """Phase 20's card side -> its outcome digests (held against the CPU
    run at the end)."""
    import numpy as np
    import torch

    from wtf_tpu_torch.core.results import StatusCode
    from wtf_tpu_torch.interp import pstep
    from wtf_tpu_torch.interp.machine import (
        CTR_FUSED, CTR_INSTR, CTR_PARK_SUBSET,
    )
    from wtf_tpu_torch.telemetry.spans import CALLS

    for name in pstep.LAUNCHES:
        pstep.LAUNCHES[name] = 0
    r = fp_loop(LANES, "cuda", True)        # the Runner launches K2 once
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    status = r.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(pstep.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ctr = r.machine.ctr.cpu().numpy().view(np.uint32).astype(np.int64)
    instr, fused = int(ctr[:, CTR_INSTR].sum()), int(ctr[:, CTR_FUSED].sum())
    parks = int(ctr[:, CTR_PARK_SUBSET].sum())
    by_class = dict(r.stats["fallbacks_by_opclass"])
    fp_classes = {"ssemov", "ssealu", "ssefp", "vzeroall", "x87"}
    names = {int(c): StatusCode(int(c)).name for c in np.unique(status)}
    counts = {names[int(k)]: int(v) for k, v in zip(*np.unique(
        status, return_counts=True))}
    check(launches["fused_step"] > 0, f"K1 never launched: {launches}")
    check(parks > 0, "K1 parked no lane at the FP classes")
    check(not fp_classes & set(by_class),
          f"SSE or x87 lanes fell back to the oracle: {by_class}")
    check(set(counts) <= TERMINAL, f"non-terminal lanes: {counts}")
    spans, calls = r.registry.spans, r.registry.counter(CALLS).children
    legs = int(calls["device-step"].value)
    legs_s = spans.seconds("device-step")
    k1_s = spans.seconds("fused-step")
    print(f"phase 20: {LANES}-lane x {SLOTS}-row FP loop (fused step on, "
          f"burst_any_tier on, the card's default): {instr} instructions in "
          f"{wall:.2f} s ({fused} in K1, {parks} parks at the FP classes); "
          f"K1 launches {launches['fused_step']}, resume legs {legs}; K1 "
          f"share of the wall {k1_s / wall:.3f}, resume legs "
          f"{legs_s / wall:.3f}; oracle fallbacks {r.stats['fallbacks']} "
          f"{by_class}; statuses {counts}; peak device bytes {peak}")
    k1["launches_by_path"]["fp loop"] = launches["fused_step"]
    k2["launches_by_path"]["fp loop"] = launches["probe"]
    record["fp_loop"] = {"lanes": LANES, "slots": SLOTS, "wall_s": wall,
                         "instructions": instr, "fused": fused,
                         "park_subset": parks, "k1_launches":
                         launches["fused_step"], "resume_legs": legs,
                         "k1_share": k1_s / wall,
                         "resume_share": legs_s / wall,
                         "fallbacks": r.stats["fallbacks"],
                         "by_class": by_class, "statuses": counts,
                         "peak_bytes": peak}
    outcome_ = loop_outcome(r)
    del r
    torch.cuda.empty_cache()
    return outcome_


def phase_fp_loop_card_vs_cpu(cpu, card: dict) -> None:
    want = cpu["fp loop"].result()
    bad = sorted(k for k in card if card[k] != want["outcome"][k])
    check(not bad, f"phase 20's FP loop differs between card and cpu in "
                   f"{bad}")
    print(f"phase 20: card == cpu on every plane of the {LANES} lanes and "
          f"on the copy pages (cpu {want['s']:.1f} s in a worker process, "
          f"{want['fallbacks']} fallbacks)")


def phase_kernel_campaign(k1: dict, k2: dict, record: dict) -> tuple:
    import torch

    from wtf_tpu_torch import cli
    from wtf_tpu_torch.interp import pstep

    a = cli.build_parser().parse_args(KCAMPAIGN)
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
    counts = backend.status_counts
    fallbacks = backend.runner.stats["fallbacks"]
    terminal = {"OK", "CRASH", "TIMEDOUT", "PAGE_FAULT", "OVERLAY_FULL",
                "CR3_CHANGE", "DIVIDE_ERROR", "HARD_ERROR"}
    check(launches["fused_step"] > 0, f"K1 never launched: {launches}")
    check(launches["probe"] > 0, f"K2 never launched: {launches}")
    check(fallbacks == 0, f"demo_kernel fell back to the oracle "
                          f"{fallbacks} times: "
                          f"{backend.runner.stats['fallbacks_by_opclass']}")
    check(set(counts) <= terminal
          and sum(counts.values()) == loop.stats.testcases >= RUNS,
          f"non-terminal lanes: {counts}")
    engine = type(loop.mutator).__name__
    check(engine == "NativeMangleMutator",
          f"demo_kernel's host mutator is {engine}, not the native engine "
          f"the reference CLI picks")
    batches = backend.stats["batches"]
    spans = reg.spans
    span_s = {p: spans.seconds(p) for p in (
        "mutate", "execute", "harvest", "restore", "execute/insert",
        "execute/fused-step", "execute/device-step", "execute/service-pull",
        "execute/service-decode", "execute/service-push",
        "execute/cov-readback", "restore/overlay-restore")}
    names = sorted(loop.crash_names)
    print(f"phase 8: demo_kernel campaign ({engine}) {loop.stats.testcases} "
          f"testcases in {wall:.2f} s = {loop.stats.testcases / wall:.1f} "
          f"execs/s; K1 "
          f"launches {launches['fused_step']} ({launches['fused_step'] / batches:.1f} "
          f"per batch), K2 {launches['probe']}; fused occupancy "
          f"{occupancy:.4f} ({fused}/{instr}); oracle fallbacks {fallbacks}; "
          f"device bytes in use {in_use} (peak {peak}); statuses {counts}; "
          f"{len(names)} crash names {names[:6]}; spans "
          + ", ".join(f"{k} {v:.2f}" for k, v in span_s.items()))
    k1["launches_by_path"]["demo_kernel"] = launches["fused_step"]
    k2["launches_by_path"]["demo_kernel"] = launches["probe"]
    record["kernel_campaign"] = {
        "testcases": loop.stats.testcases, "wall_s": wall,
        "execs_per_s": loop.stats.testcases / wall,
        "k1_launches": launches["fused_step"], "batches": batches,
        "occupancy": occupancy, "instructions": instr,
        "fallbacks": fallbacks, "spans": span_s, "bytes_in_use": in_use,
        "peak_bytes": peak, "statuses": counts, "crash_names": names,
        "mutator": engine}
    kernel_out = outcome(loop)
    backend.restore()
    del loop, backend
    torch.cuda.empty_cache()
    return kernel_out


KERNEL_RUNS = {
    "benign": b"\x01\x01\x02\x03\x04",
    "bugcheck": b"\x02\xef\xbe\xad\xde\x41\x00\x00\x00\x00\x00\x00\x00pad",
    "oob_write": b"\x03" + b"A" * 200,
    "wild_jump": b"\x04\x00\x00\xad\xde\x00\x00\x00\x00x",
    "sum": b"\x01" + bytes(range(250)),
}
USER_RUNS = {f"case{i}": data for i, data in enumerate(
    [b"\x01\x04", b"\x02", b"\x03", b"", b"\x01\x0e", b"\x01\x00",
     b"\x04\x05", b"\x05"])}


def phase_targets_card_vs_cpu(cpu) -> None:
    for name, inputs in (("demo_kernel", KERNEL_RUNS),
                         ("demo_usermode", USER_RUNS)):
        card = replay_runs(name, inputs, "cuda")
        want = cpu[f"run {name}"].result()
        check(card == want, f"run {name} differs: card {card} cpu {want}")
        print(f"phase 9: run {name}, card == cpu: " + "; ".join(
            f"{k} {res} icount {ic}" for k, res, _, ic in card))
        card = small_campaign(name, "cuda", 100000)
        want = cpu[name].result()
        check(all(card[i] == want[i] for i in range(5)),
              f"64-lane {name} campaign differs between card and cpu")
        print(f"phase 9: 64-lane 256-run {name} campaign, card == cpu: "
              f"{len(card[0])} corpus digests, crash names {card[1]}, "
              f"statuses {card[4]}, equal cov/edge bytes (card "
              f"{card[5]:.1f} s, cpu {want[5]:.1f} s in a worker process)")


def phase_window_campaign(k1: dict, k2: dict, record: dict) -> None:
    import torch

    from wtf_tpu_torch import cli
    from wtf_tpu_torch.interp import pstep

    a = cli.build_parser().parse_args(WCAMPAIGN)
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
    windows = reg.counter("megachunk.windows").value
    rounds = reg.counter("device.fused_window_rounds").value
    sweeps = reg.counter("device.fused_window_xla_steps").value
    parks = (reg.counter("device.fused_park_subset").value,
             reg.counter("device.fused_park_mem").value)
    batches = backend.stats["batches"]
    incomplete = reg.counter("megachunk.incomplete_windows").value
    decodes = backend.runner.stats["decodes"]
    counts = backend.status_counts
    terminal = {"OK", "CRASH", "TIMEDOUT", "PAGE_FAULT", "OVERLAY_FULL",
                "CR3_CHANGE", "DIVIDE_ERROR", "HARD_ERROR"}
    check(launches["fused_step"] > 0, f"K1 never launched: {launches}")
    check(launches["probe"] > 0, f"K2 never launched: {launches}")
    check(windows > 0, "no megachunk window ran")
    check(rounds > 0, "K1 never launched from a megachunk window")
    check(occupancy >= 0.95, f"fused occupancy {occupancy:.4f} < 0.95")
    check(set(counts) <= terminal
          and sum(counts.values()) == loop.stats.testcases >= RUNS,
          f"non-terminal lanes: {counts}")
    check(reg.counter("runner.max_chunks_timeouts").value == 0,
          "lanes revoked at max_chunks")
    spans = reg.spans
    span_s = {p: spans.seconds(p) for p in (
        "mutate", "execute", "harvest", "restore", "execute/device",
        "execute/device/overlay-restore", "execute/device/generate",
        "execute/device/insert", "execute/device/fused-step",
        "execute/device/device-step", "execute/device/merge",
        "execute/fused-step", "execute/device-step",
        "execute/service-pull", "execute/service-decode",
        "execute/service-push", "execute/cov-readback",
        "restore/overlay-restore")}
    print(f"phase 10: window campaign {loop.stats.testcases} testcases in "
          f"{wall:.2f} s = {loop.stats.testcases / wall:.1f} execs/s; "
          f"{windows} windows ({incomplete} ended incomplete; host decodes "
          f"{decodes}), {batches / windows:.2f} batches and "
          f"{rounds / windows:.1f} window K1 launches per window; K1 "
          f"launches {launches['fused_step']} ({rounds} in windows, "
          f"{launches['fused_step'] / batches:.1f} per batch), K2 "
          f"{launches['probe']}; window precise sweeps {sweeps}; K1 parks "
          f"subset/mem {parks[0]}/{parks[1]}; fused "
          f"occupancy {occupancy:.4f} ({fused}/{instr}); device bytes in "
          f"use {in_use} (peak {peak}); statuses {counts}; crashes "
          f"{loop.stats.crashes}, corpus {len(loop.corpus)}; spans "
          + ", ".join(f"{k} {v:.2f}" for k, v in span_s.items()))
    k1["launches_by_path"]["demo_tlv window"] = launches["fused_step"]
    k2["launches_by_path"]["demo_tlv window"] = launches["probe"]
    record["window_campaign"] = {
        "testcases": loop.stats.testcases, "wall_s": wall,
        "execs_per_s": loop.stats.testcases / wall,
        "k1_launches": launches["fused_step"], "k1_window_rounds": rounds,
        "windows": windows, "incomplete_windows": incomplete,
        "host_decodes": decodes, "batches": batches,
        "window_xla_steps": sweeps, "parks_subset_mem": parks,
        "occupancy": occupancy,
        "instructions": instr, "spans": span_s, "bytes_in_use": in_use,
        "peak_bytes": peak, "statuses": counts,
        "crashes": loop.stats.crashes, "final_line": stats_line(loop)}
    window_out = outcome(loop)
    backend.restore()
    del loop, backend
    torch.cuda.empty_cache()

    # the same devmangle campaign batch at a time (--megachunk 0), in
    # turns with the window on this card (window, batch): the window's
    # own effect at full width, and the same results
    walls = {"8": [wall], "0": []}
    for mc in ("0",):
        t0 = time.perf_counter()
        loop = cli.campaign(cli.build_parser().parse_args(
            CAMPAIGN + ["--mutator", "devmangle", "--megachunk", mc]))
        torch.cuda.synchronize()
        walls[mc].append(time.perf_counter() - t0)
        check(outcome(loop) == window_out,
              f"--megachunk {mc} differs from the window campaign at full "
              f"width")
        if mc == "0":
            spans0 = {p: loop.registry.spans.seconds(p) for p in (
                "mutate", "execute", "harvest", "restore", "execute/insert",
                "execute/fused-step", "execute/device-step",
                "execute/service-decode", "execute/cov-readback")}
        loop.backend.restore()
        del loop
        torch.cuda.empty_cache()
    print(f"phase 10: in turns (window, batch), equal corpus, "
          f"crashes and cov/edge bytes: execs/s --megachunk 8 "
          f"{[round(RUNS / w, 1) for w in walls['8']]}, --megachunk 0 "
          f"{[round(RUNS / w, 1) for w in walls['0']]}; --megachunk 0 spans "
          + ", ".join(f"{k} {v:.2f}" for k, v in spans0.items()))
    record["window_campaign"]["turns_wall_s"] = walls
    record["window_campaign"]["megachunk0_spans"] = spans0
    profiled_rerun("phase 10", WCAMPAIGN, record["window_campaign"],
                   launches["fused_step"], wall)
    return window_out


def phase_window_card_vs_cpu(cpu) -> tuple:
    card = small_campaign("demo_tlv", "cuda", extra=tuple(WINDOW))
    want = cpu["demo_tlv window"].result()
    check(all(card[i] == want[i] for i in range(4)),
          "64-lane window campaign differs between card and cpu")
    batch = small_campaign("demo_tlv", "cuda",
                           extra=("--mutator", "devmangle"))
    check(all(card[i] == batch[i] for i in range(4)),
          "64-lane window campaign differs from --megachunk 0 on the card")
    print(f"phase 11: 64-lane 256-run window campaign, card == cpu == card "
          f"--megachunk 0: {len(card[0])} corpus digests, {len(card[1])} "
          f"crash names, equal cov/edge bytes (card {card[5]:.1f} s, "
          f"--megachunk 0 {batch[5]:.1f} s, cpu {want[5]:.1f} s in a worker "
          f"process)")
    return card


# phase 12's encoding grid (tests/test_torch_devdec.py::_decode_grid)
DECODE_PREFIXES = [b"", b"\x66", b"\x67", b"\xf0", b"\xf2", b"\xf3", b"\x64",
                   b"\x65", b"\x2e", b"\x66\xf3", b"\xf2\xf3", b"\x66\x67\x65",
                   b"\xf0\x66", b"\x66\x66"]
DECODE_REXES = [b"", b"\x40", b"\x48", b"\x41", b"\x44", b"\x42", b"\x4f",
                b"\x45", b"\x4c"]


def decode_grid():
    """uint8[6048, 15]: opcode-map and ModRM skeletons with random prefix
    and REX dressing, fully random windows, and prefix runs that
    truncate (seed 0x77F)."""
    import numpy as np

    rng = np.random.default_rng(0x77F)
    cases = []
    for m in (0, 1):
        for op in range(256):
            for _ in range(4):
                digit, mod = rng.integers(8), rng.integers(4)
                rm = int(rng.choice([0, 3, 4, 5]))
                modrm = (int(mod) << 6) | (int(digit) << 3) | rm
                pfx = DECODE_PREFIXES[rng.integers(len(DECODE_PREFIXES))]
                rex = DECODE_REXES[rng.integers(len(DECODE_REXES))]
                body = bytes([0x0F, op] if m else [op]) + bytes([modrm])
                tail = rng.integers(0, 256, 14, dtype=np.uint8).tobytes()
                cases.append((pfx + rex + body + tail)[:15])
    for _ in range(3000):
        cases.append(rng.integers(0, 256, 15, dtype=np.uint8).tobytes())
    for _ in range(1000):
        n = rng.integers(8, 15)
        pfx = bytes(rng.choice(
            [0x66, 0x67, 0xF0, 0xF2, 0xF3, 0x64, 0x2E], n))
        body = rng.integers(0, 256, 15, dtype=np.uint8).tobytes()
        cases.append((pfx + body)[:15])
    return np.frombuffer(b"".join(cases), np.uint8).reshape(len(cases), 15)


def phase_decode(dev, record: dict) -> None:
    import numpy as np
    import torch

    from wtf_tpu_torch.cpu.decoder import decode
    from wtf_tpu_torch.cpu.uops import INT_FIELDS
    from wtf_tpu_torch.interp import devdec
    from wtf_tpu_torch.mem.overlay import DirtyOverlay
    from wtf_tpu_torch.mem.physmem import MemImage

    wins = torch.from_numpy(decode_grid().copy())
    got = devdec.decode_window(wins.to(dev))
    want = devdec.decode_window(wins)
    bad = [name for name, a, b in zip(got._fields, got, want)
           if not torch.equal(a.cpu(), b)]
    check(not bad, f"decode_window differs between card and cpu in {bad}")
    known = want.known.numpy()
    f, disp, imm = want.f.numpy(), want.disp.numpy(), want.imm.numpy()
    for i in np.nonzero(known)[0]:
        hu = decode(wins[i].numpy().tobytes(), 0)
        check([int(v) for v in f[i]] == [int(getattr(hu, name))
                                         for name in INT_FIELDS]
              and int(disp[i]) & (1 << 64) - 1 == hu.disp & (1 << 64) - 1
              and int(imm[i]) & (1 << 64) - 1 == hu.imm & (1 << 64) - 1,
              f"decode_window differs from the host decoder on "
              f"{wins[i].numpy().tobytes().hex()}")
    wins_dev = wins.to(dev)
    dec_ms = cuda_ms(lambda: devdec.decode_window(wins_dev), 5)

    # gather_windows on phase 3's guest: random overlays, rips at
    # instruction starts (a quarter high-half), across a page end, in the
    # data pages (overlay words) and wild (unmapped, non-canonical)
    tab, img, m, _ = grid_state(LANES, 5, dev)
    g = torch.Generator(device=dev).manual_seed(12)
    n = LANES

    def rint(lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, device=dev)

    kind = rint(0, 5)
    rips = torch.where(kind == 1, GRID_CODE_GVA + 0x1000 - rint(1, 15),
                       m.rip)
    rips = torch.where(kind == 2, s64(GRID_KDATA_GVA) + rint(0, 0x2000),
                       rips)
    rips = torch.where(kind == 3, GRID_DATA_GVA + rint(0, 0x4000), rips)
    rips = torch.where(kind == 4, rint(-2**63, 2**63 - 1), rips)
    idx = torch.randperm(n, generator=g, device=dev)[:3000]
    got = devdec.gather_windows(img, m.overlay, m.cr3, rips, idx)
    ov = m.overlay
    cpu_img = MemImage(img.pages.cpu(), img.frame_table.cpu(),
                       img.tenant.cpu())
    cpu_ov = DirtyOverlay(ov.pfn.cpu(), ov.data.cpu(), ov.valid.cpu(),
                          ov.count.cpu(), ov.overflow.cpu())
    want = devdec.gather_windows(cpu_img, cpu_ov, m.cr3.cpu(), rips.cpu(),
                                 idx.cpu())
    bad = [name for name, a, b in zip(("win", "fault", "pfn0", "pfn14"),
                                      got, want)
           if not torch.equal(a.cpu(), b)]
    check(not bad, f"gather_windows differs between card and cpu in {bad}")
    faults = int(want[1].sum())
    gather_ms = cuda_ms(lambda: devdec.gather_windows(
        img, m.overlay, m.cr3, rips, idx), 5)
    print(f"phase 12: decode_window card == cpu on {len(wins)} windows "
          f"({int(known.sum())} in the device subset, == the host decoder "
          f"there), {dec_ms:.2f} ms on the card; gather_windows card == cpu "
          f"on {len(idx)} of {n} lanes x {SLOTS} overlay rows ({faults} "
          f"faulting), {gather_ms:.2f} ms on the card")
    record["decode"] = {"windows": len(wins), "known": int(known.sum()),
                        "decode_window_ms": dec_ms,
                        "gather_lanes": len(idx), "gather_faults": faults,
                        "gather_windows_ms": gather_ms}
    del tab, img, m, ov, cpu_ov, got, want
    torch.cuda.empty_cache()


def phase_dd_window_campaign(k1: dict, k2: dict, record: dict,
                             window_out: tuple) -> None:
    import torch

    from wtf_tpu_torch import cli
    from wtf_tpu_torch.interp import pstep

    a = cli.build_parser().parse_args(DCAMPAIGN)
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
    c = {name: reg.counter(name).value for name in (
        "megachunk.windows", "megachunk.incomplete_windows",
        "device.fused_window_rounds",
        "device.fused_window_xla_steps", "devdec.serviced_lanes",
        "devdec.published", "devdec.parked_lanes", "devdec.service_rounds",
        "devdec.service_k1_rounds", "devdec.crosscheck_mismatches",
        "devdec.zero_host_windows", "devdec.zero_host_batches",
        "device.instructions", "device.fused_steps")}
    occupancy = c["device.fused_steps"] / max(c["device.instructions"], 1)
    windows, batches = c["megachunk.windows"], backend.stats["batches"]
    decodes = backend.runner.stats["decodes"]
    counts = backend.status_counts
    terminal = {"OK", "CRASH", "TIMEDOUT", "PAGE_FAULT", "OVERLAY_FULL",
                "CR3_CHANGE", "DIVIDE_ERROR", "HARD_ERROR"}
    check(launches["fused_step"] > 0, f"K1 never launched: {launches}")
    check(launches["probe"] > 0, f"K2 never launched: {launches}")
    check(windows > 0, "no megachunk window ran")
    check(c["device.fused_window_rounds"] > 0,
          "K1 never launched from a megachunk window")
    check(c["devdec.published"] > 0, "the device decoder published nothing")
    check(c["devdec.crosscheck_mismatches"] == 0,
          f"{c['devdec.crosscheck_mismatches']} device-published entries "
          f"disagree with the host decoder")
    check(occupancy >= 0.95, f"fused occupancy {occupancy:.4f} < 0.95")
    check(set(counts) <= terminal
          and sum(counts.values()) == loop.stats.testcases >= RUNS,
          f"non-terminal lanes: {counts}")
    check(outcome(loop) == window_out,
          "the --device-decode window campaign differs from phase 10's")
    spans = reg.spans
    span_s = {p: spans.seconds(p) for p in (
        "mutate", "execute", "harvest", "restore", "execute/device",
        "execute/device/devdec-service", "execute/device/generate",
        "execute/device/fused-step", "execute/device/device-step",
        "execute/device/merge", "execute/fused-step",
        "execute/device-step", "execute/service-decode",
        "execute/cov-readback")}
    rounds = c["devdec.service_rounds"]
    print(f"phase 13: --device-decode window campaign "
          f"{loop.stats.testcases} testcases in {wall:.2f} s = "
          f"{loop.stats.testcases / wall:.1f} execs/s, equal corpus, "
          f"crashes and cov/edge bytes to phase 10; {windows} windows, "
          f"{c['devdec.zero_host_windows']} of them zero-host "
          f"({c['devdec.zero_host_batches']} batches), "
          f"{c['megachunk.incomplete_windows']} incomplete, "
          f"{batches / windows:.2f} batches per window; host decodes "
          f"{decodes}; service rounds {rounds} "
          f"({span_s['execute/device/devdec-service']:.3f} s = "
          f"{span_s['execute/device/devdec-service'] / max(rounds, 1):.3f} s "
          f"per round), serviced lanes {c['devdec.serviced_lanes']}, "
          f"published {c['devdec.published']}, parked "
          f"{c['devdec.parked_lanes']}, cross-check mismatches "
          f"{c['devdec.crosscheck_mismatches']}; K1 launches "
          f"{launches['fused_step']} ({c['device.fused_window_rounds']} in "
          f"windows, {c['devdec.service_k1_rounds']} of them in service "
          f"re-quiesces), K2 {launches['probe']}; fused occupancy "
          f"{occupancy:.4f}; device bytes in use {in_use} (peak {peak}); "
          f"statuses {counts}; spans "
          + ", ".join(f"{k} {v:.2f}" for k, v in span_s.items()))
    k1["launches_by_path"]["demo_tlv dd window"] = launches["fused_step"]
    k2["launches_by_path"]["demo_tlv dd window"] = launches["probe"]
    record["dd_window_campaign"] = {
        "testcases": loop.stats.testcases, "wall_s": wall,
        "execs_per_s": loop.stats.testcases / wall,
        "k1_launches": launches["fused_step"], "counters": c,
        "batches": batches, "host_decodes": decodes, "occupancy": occupancy,
        "spans": span_s, "bytes_in_use": in_use, "peak_bytes": peak,
        "statuses": counts}
    backend.restore()
    del loop, backend
    torch.cuda.empty_cache()

    # in turns on this card (dd, window): equal results
    walls = {"dd": [wall], "window": []}
    for argv, key in ((WCAMPAIGN, "window"),):
        t0 = time.perf_counter()
        loop = cli.campaign(cli.build_parser().parse_args(argv))
        torch.cuda.synchronize()
        walls[key].append(time.perf_counter() - t0)
        check(outcome(loop) == window_out,
              f"the {key} campaign of phase 13's turns differs")
        loop.backend.restore()
        del loop
        torch.cuda.empty_cache()
    print(f"phase 13: in turns (dd, window), equal corpus, "
          f"crashes and cov/edge bytes: execs/s --device-decode "
          f"{[round(RUNS / w, 1) for w in walls['dd']]}, without "
          f"{[round(RUNS / w, 1) for w in walls['window']]}")
    record["dd_window_campaign"]["turns_wall_s"] = walls
    profiled_rerun("phase 13", DCAMPAIGN, record["dd_window_campaign"],
                   launches["fused_step"], wall)


def phase_dd_card_vs_cpu(cpu, card_window: tuple) -> None:
    from wtf_tpu_torch import cli

    def run(extra):
        a = cli.build_parser().parse_args(
            ["campaign", "--name", "demo_tlv", "--fused-step", "on",
             "--lanes", "64", "--runs", "256", "--limit", "20000",
             "--max_len", "96", "--seed", "5", *extra])
        loop = cli.campaign(a)
        reg = loop.registry
        return (outcome(loop), reg.counter("devdec.published").value,
                reg.counter("devdec.crosscheck_mismatches").value,
                loop.backend.runner.stats["decode_windows_gathered"])

    card, published, mismatches, _ = run(WINDOW + ["--device-decode"])
    want = cpu["demo_tlv window dd"].result()
    check(all(card[i] == want[i] for i in range(4)),
          "64-lane --device-decode window campaign differs between card "
          "and cpu")
    check(all(card[i] == card_window[i] for i in range(4)),
          "64-lane --device-decode window campaign differs from the "
          "window campaign without it")
    check(published > 0 and mismatches == 0,
          f"64-lane --device-decode: published {published}, cross-check "
          f"mismatches {mismatches}")
    batch, _, _, gathered = run(["--mutator", "devmangle", "--megachunk",
                                 "0", "--device-decode"])
    check(all(card[i] == batch[i] for i in range(4)) and gathered > 0,
          f"64-lane --megachunk 0 --device-decode differs from the window "
          f"campaign (windows gathered {gathered})")
    print(f"phase 14: 64-lane 256-run --device-decode window campaign, card "
          f"== cpu == card without device decode == card --megachunk 0 "
          f"--device-decode: {len(card[0])} corpus digests, {len(card[1])} "
          f"crash names, equal cov/edge bytes; {published} entries "
          f"published on the card, 0 cross-check mismatches; {gathered} "
          f"code windows gathered for the host service at --megachunk 0")


# ---------------------------------------------------------------------------
# phases 15-18: crash-dump snapshots, the remaining targets, demo_spin deep
# ---------------------------------------------------------------------------

def mapped_pfns(pages: dict, cr3: int) -> set:
    """Every pfn the 4-level tables under cr3 reach: the tables themselves
    and the pages they map (a large page counts its whole range)."""
    import numpy as np

    pfn_mask = (1 << 40) - 1
    out, tables = set(), [((cr3 >> 12) & pfn_mask, 4)]
    while tables:
        pfn, level = tables.pop()
        out.add(pfn)
        if pfn not in pages:
            continue
        for e in np.frombuffer(pages[pfn], dtype="<u8").tolist():
            if not e & 1:
                continue
            nxt = (e >> 12) & pfn_mask
            if level == 1:
                out.add(nxt)
            elif level in (2, 3) and e & 0x80:
                out.update(range(nxt, nxt + 512 ** (level - 1)))
            else:
                tables.append((nxt, level - 1))
    return out


def phase_dump(k1: dict, k2: dict, record: dict, kernel_out: tuple) -> None:
    import numpy as np
    import torch

    from wtf_tpu_torch import cli
    from wtf_tpu_torch.harness import demo_kernel
    from wtf_tpu_torch.interp import pstep
    from wtf_tpu_torch.mem.physmem import PhysMem
    from wtf_tpu_torch.snapshot import kdmp
    from wtf_tpu_torch.snapshot.loader import load_snapshot

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        snap = demo_kernel.build_snapshot()
        snap.save_raw(tmp / "npz")
        for fmt in ("dmp-bmp", "dmp-full"):
            check(cli.main(["snapshot", "--state", str(tmp / "npz"), "--out",
                            str(tmp / fmt), "--format", fmt]) == 0,
                  f"snapshot --format {fmt} failed")
        full = load_snapshot(tmp / "dmp-full")
        check(np.array_equal(full.physmem.pages, snap.physmem.pages)
              and np.array_equal(full.physmem.frame_table,
                                 snap.physmem.frame_table)
              and full.cpu == snap.cpu and full.symbols == snap.symbols,
              "the dmp-full export does not load back to demo_kernel's "
              "snapshot")
        # pad the bitmap dump with seeded filler pages no table reaches
        pages = kdmp.parse_kdmp(tmp / "dmp-bmp" / "mem.dmp")
        reach = mapped_pfns(pages, snap.cpu.cr3)
        check(max(max(pages), max(reach)) < DUMP_FILLER_BASE,
              "demo_kernel's pages reach the filler pfns")
        filler = np.random.default_rng(5).integers(
            0, 256, (DUMP_FILLER_PAGES, 4096), dtype=np.uint8)
        for i in range(DUMP_FILLER_PAGES):
            pages[DUMP_FILLER_BASE + i] = filler[i].tobytes()
        del filler
        padded = tmp / "padded"
        padded.mkdir()
        t0 = time.perf_counter()
        kdmp.write_kdmp(padded / "mem.dmp", pages, dump_type="bmp",
                        dtb=snap.cpu.cr3, cpu=snap.cpu)
        write_s = time.perf_counter() - t0
        del pages
        for name in ("regs.json", "symbol-store.json"):
            (padded / name).write_bytes((tmp / "dmp-bmp" / name).read_bytes())
        dump_bytes = (padded / "mem.dmp").stat().st_size

        # phase 8's campaign from the padded dump, its load timed in parts
        times = {"parse": 0.0, "from_pages": 0.0, "upload": 0.0}
        natives = []
        orig = (kdmp._parse_native, kdmp.parse_kdmp,
                PhysMem.__dict__["from_pages"], PhysMem.image)

        def timed(key, fn):
            def wrapped(*args, **kwargs):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                times[key] += time.perf_counter() - t1
                return out
            return wrapped

        def native(path):
            out = orig[0](path)
            natives.append(out is not None)
            return out

        kdmp._parse_native = native
        kdmp.parse_kdmp = timed("parse", orig[1])
        PhysMem.from_pages = classmethod(timed("from_pages", orig[2].__func__))
        PhysMem.image = timed("upload", orig[3])
        try:
            torch.cuda.reset_peak_memory_stats()
            for name in pstep.LAUNCHES:
                pstep.LAUNCHES[name] = 0
            t0 = time.perf_counter()
            loop = cli.campaign(cli.build_parser().parse_args(
                KCAMPAIGN + ["--state", str(padded)]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            (kdmp._parse_native, kdmp.parse_kdmp, PhysMem.from_pages,
             PhysMem.image) = orig
        launches = dict(pstep.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
    check(natives and all(natives),
          f"the native kdmp parser did not parse the dump ({natives})")
    check(launches["fused_step"] > 0, f"K1 never launched: {launches}")
    check(outcome(loop) == kernel_out,
          "the campaign from the padded dump differs from phase 8's")
    backend = loop.backend
    frames = backend.snapshot.physmem.nframes
    load_s = loop.registry.spans.seconds("snapshot-load")
    print(f"phase 15: demo_kernel exported as dmp-bmp and dmp-full (the full "
          f"dump loads back equal), the bitmap dump padded with "
          f"{DUMP_FILLER_PAGES} seeded filler pages at pfn "
          f"{DUMP_FILLER_BASE:#x}+ (no table reaches them): {dump_bytes} "
          f"bytes, written in {write_s:.2f} s; phase 8's campaign from it "
          f"({wall:.2f} s with the load = "
          f"{loop.stats.testcases / wall:.1f} execs/s, "
          f"{loop.stats.testcases / (wall - load_s):.1f} without it) equals "
          f"phase 8's corpus, crashes and cov/edge bytes; "
          f"native parse {times['parse']:.2f} s, PhysMem.from_pages "
          f"{times['from_pages']:.2f} s, upload {times['upload']:.3f} s "
          f"(snapshot-load span {load_s:.2f} s, {frames} frames); K1 "
          f"launches {launches['fused_step']}; device bytes peak {peak}")
    k1["launches_by_path"]["demo_kernel dmp state"] = launches["fused_step"]
    k2["launches_by_path"]["demo_kernel dmp state"] = launches["probe"]
    record["dump_campaign"] = {
        "dump_bytes": dump_bytes, "filler_pages": DUMP_FILLER_PAGES,
        "write_s": write_s, "parse_s": times["parse"],
        "from_pages_s": times["from_pages"], "upload_s": times["upload"],
        "snapshot_load_s": load_s, "frames": frames, "wall_s": wall,
        "execs_per_s": loop.stats.testcases / wall,
        "execs_per_s_without_load": loop.stats.testcases / (wall - load_s),
        "k1_launches": launches["fused_step"], "peak_bytes": peak}
    backend.restore()
    del loop, backend
    torch.cuda.empty_cache()


def hold_k1(loop, testcases: list, rounds: int = 2) -> tuple:
    """K1 against its plain version on a fresh batch of `testcases` from
    its start, `rounds` dispatches in a row: (max abs err, instructions
    retired, lanes parked).  These launches are comparisons: the counts
    are put back as they were."""
    import torch

    from wtf_tpu_torch.interp import pstep
    from wtf_tpu_torch.interp.machine import CTR_INSTR

    backend, runner = loop.backend, loop.backend.runner
    counts = dict(pstep.LAUNCHES)
    view = backend._ensure_view()
    for lane, data in enumerate(testcases):
        with backend._bound(view, lane):
            loop.target.insert_testcase(backend, data)
    runner.push(view)
    backend._view = None
    tab, img = runner.device_tab(), runner.image
    m0 = runner.machine.clone()
    mk, mp = m0.clone(), m0.clone()
    for _ in range(rounds):
        pstep.fused_step(tab, img, mk, runner.limit, runner.fused_k)
        pstep.fused_step_plain(tab, img, mp, runner.limit, runner.fused_k)
    torch.cuda.synchronize()
    pstep.LAUNCHES.update(counts)
    bad, err = plane_diff(mk, mp)
    check(not bad, f"K1 differs from fused_step_plain on a "
                   f"{loop.target.name} batch in {bad}")
    retired = int((mk.ctr[:, CTR_INSTR] - m0.ctr[:, CTR_INSTR]).sum())
    parked = int((mk.status == pstep._NEEDS_XLA).sum())
    loop.target.restore()
    backend.restore()
    return err, retired, parked


def held_batch(name: str, loop, n: int) -> list:
    """A batch for hold_k1: crafted inputs that reach each target's
    interesting paths inside two dispatches, and mutated ones."""
    import struct

    def ioctl(code, payload):
        return struct.pack("<I", code) + payload

    crafted = {
        "demo_maze": [b"wtf!", b"wtfx", b"wtxx", b"wxxx", b"aaaa", b""],
        # payloads pushed against the end of the input page: a lying
        # length reads across it, the sum reads up to its last byte
        "demo_ioctl": [ioctl(0x222003, struct.pack("<H", 500) + b"x" * k)
                       for k in range(7)]
        + [ioctl(0x222007, b"\x01" * k) for k in (1, 5, 9)]
        + [ioctl(0x222003, struct.pack("<H", 3) + b"abc")],
        "demo_fs": [b"HELLOWORLD123456", b"short", b""],
        "demo_spin": [struct.pack("<I", k) for k in (0, 1, 3, 1 << 30)],
    }[name]
    mutated = loop.mutator.get_new_batch(loop.corpus, n)
    return [crafted[i % len(crafted)] if i % 2 == 0 else mutated[i]
            for i in range(n)]


def target_argv(name: str) -> list:
    return ["campaign", "--name", name, "--fused-step", "on", "--lanes",
            str(LANES), "--runs", str(RUNS), "--limit", "100000",
            "--max_len", "96", "--seed", "5"]


def phase_targets(k1: dict, k2: dict, record: dict) -> None:
    import torch

    from wtf_tpu_torch import cli
    from wtf_tpu_torch.harness import demo_fs
    from wtf_tpu_torch.interp import pstep

    record["targets"] = {}
    for name in NEW_TARGETS:
        with tempfile.TemporaryDirectory() as tmp:
            argv = target_argv(name) + seeded_target(name, tmp)
            torch.cuda.reset_peak_memory_stats()
            for key in pstep.LAUNCHES:
                pstep.LAUNCHES[key] = 0
            t0 = time.perf_counter()
            loop = cli.campaign(cli.build_parser().parse_args(argv))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(pstep.LAUNCHES)
            rec = target_record(name, loop, wall, launches)
            err, retired, parked = hold_k1(
                loop, held_batch(name, loop, loop.backend.n_lanes))
            k1["max_abs_err"] = max(k1["max_abs_err"] or 0, err)
            extra = ""
            if name == "demo_fs":
                bp = rec["bp_dispatches"]
                rec["guestfs"] = dict(
                    demo_fs._FS_BY_BACKEND[id(loop.backend)].stats)
                extra = (f"; breakpoint services {bp} "
                         f"({bp / rec['batches']:.0f} per batch), guestfs "
                         f"{rec['guestfs']}")
            print(f"phase 16: {name} campaign ({rec['mutator']}) "
                  f"{rec['testcases']} testcases in {wall:.2f} s = "
                  f"{rec['execs_per_s']:.1f} execs/s; K1 launches "
                  f"{rec['k1_launches']} "
                  f"({rec['k1_launches'] / rec['batches']:.1f} per batch); "
                  f"fused occupancy {rec['occupancy']:.4f}; oracle fallbacks "
                  f"{rec['fallbacks']}; statuses {rec['statuses']}; corpus "
                  f"{rec['corpus']}, crash names {rec['crash_names'][:4]}; "
                  f"device bytes peak {rec['peak_bytes']}{extra}; K1 == "
                  f"plain on a batch start over 2 dispatches (retired "
                  f"{retired}, parked {parked}); spans "
                  + ", ".join(f"{k} {v:.2f}" for k, v in rec["spans"].items()))
            k1["launches_by_path"][name] = launches["fused_step"]
            k2["launches_by_path"][name] = launches["probe"]
            record["targets"][name] = rec
            del loop
            torch.cuda.empty_cache()
        if name == "demo_fs":
            with tempfile.TemporaryDirectory() as tmp:
                profiled_rerun("phase 16 demo_fs",
                               target_argv(name) + seeded_target(name, tmp),
                               rec, launches["fused_step"], wall)


def target_record(name: str, loop, wall: float, launches: dict) -> dict:
    """A finished main-path-shaped campaign of `name`, checked: the native
    host mutator, K1 launched, no oracle fallback, every lane terminal."""
    import torch

    backend = loop.backend
    reg = backend.registry
    instr = reg.counter("device.instructions").value
    fused = reg.counter("device.fused_steps").value
    counts = backend.status_counts
    stats = backend.runner.stats
    engine = type(loop.mutator).__name__
    check(engine == "NativeMangleMutator" or (
        name == "demo_spin" and type(loop.mutator.inner).__name__
        == "NativeMangleMutator"),
          f"{name}'s host mutator is {engine}, not the native engine")
    check(launches["fused_step"] > 0, f"K1 never launched: {launches}")
    check(launches["probe"] > 0, f"K2 never launched: {launches}")
    check(stats["fallbacks"] == 0,
          f"{name} fell back to the oracle {stats['fallbacks']} times")
    check(set(counts) <= TERMINAL
          and sum(counts.values()) == loop.stats.testcases,
          f"non-terminal lanes: {counts}")
    return {"testcases": loop.stats.testcases, "wall_s": wall,
            "execs_per_s": loop.stats.testcases / wall,
            "k1_launches": launches["fused_step"],
            "batches": backend.stats["batches"],
            "occupancy": fused / max(instr, 1), "instructions": instr,
            "fallbacks": stats["fallbacks"],
            "spans": {p: reg.spans.seconds(p) for p in SPANS},
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "statuses": dict(counts),
            "crash_names": sorted(loop.crash_names),
            "corpus": len(loop.corpus), "mutator": engine,
            "bp_dispatches": stats["bp_dispatches"]}


class CappedSpin:
    """bench.py `_deepbench`'s mutator: the host engine's testcases with
    the spin count taken modulo `max_iters` (1.1x the budget's
    iterations), so most lanes finish and a few time out."""

    def __init__(self, inner, max_iters: int):
        self.inner, self.max_iters = inner, max_iters

    def _cap(self, raw: bytes) -> bytes:
        import struct

        (count,) = struct.unpack("<I", raw.ljust(4, b"\x00")[:4])
        return struct.pack("<I", count % self.max_iters)

    def get_new_testcase(self, corpus) -> bytes:
        return self._cap(self.inner.get_new_testcase(corpus))

    def get_new_batch(self, corpus, count: int) -> list:
        return [self._cap(t) for t in self.inner.get_new_batch(corpus, count)]

    def on_new_coverage(self, testcase: bytes) -> None:
        self.inner.on_new_coverage(testcase)


def spin_loop(device: str, lanes: int = SPIN_LANES, limit: int = SPIN_LIMIT):
    """bench.py `_deepbench`'s workload on the port: demo_spin at `lanes`
    lanes (chunk_steps 512, 16 overlay slots), the native engine behind
    the spin-count cap, the corpus seeded as bench seeds it, the fused
    step at --fused-k 32."""
    import random
    import struct

    from wtf_tpu_torch.backend.gpu import GpuBackend
    from wtf_tpu_torch.fuzz.corpus import Corpus
    from wtf_tpu_torch.fuzz.loop import FuzzLoop
    from wtf_tpu_torch.fuzz.native_mutator import best_mangle_mutator
    from wtf_tpu_torch.harness import demo_spin
    from wtf_tpu_torch.telemetry import Registry

    registry = Registry()
    backend = GpuBackend(demo_spin.build_snapshot(), n_lanes=lanes,
                         limit=limit, registry=registry, device=device,
                         chunk_steps=512, overlay_slots=16,
                         fused_step="on", fused_k=32)
    with registry.spans.span("init"):
        backend.initialize()
    demo_spin.TARGET.init(backend)
    rng = random.Random(0xD33B)
    corpus = Corpus(rng=rng)
    max_iters = max(int(limit / demo_spin.INSNS_PER_ITER * 1.1), 1)
    corpus.add(struct.pack("<I", max(max_iters // 2, 1)))
    mutator = CappedSpin(best_mangle_mutator(rng, max_len=4), max_iters)
    return FuzzLoop(backend, demo_spin.TARGET, mutator, corpus,
                    registry=registry)


def phase_spin(k1: dict, k2: dict, record: dict) -> None:
    """bench.py's deep workload: a warm-up batch, with K1 rounds
    SPIN_WINDOW of it traced by torch.profiler, then unprofiled batches
    for SPIN_SECONDS.  A profiled batch runs ~3x slower than a plain one,
    so only that window is traced; the host share is 1 - the card's busy
    time in the traced window / the wall of the same rounds of the first
    timed batch (host clock before each K1 launch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from wtf_tpu_torch.interp import pstep

    for key in pstep.LAUNCHES:
        pstep.LAUNCHES[key] = 0
    loop = spin_loop("cuda")
    backend, reg = loop.backend, loop.registry
    launch = pstep.fused_step
    stamps, traced, hook = [], {}, {"prof": None}

    def on_trace(prof):
        t1 = time.perf_counter()
        traced["busy"], traced["kernels"] = device_busy(prof)
        traced["read_s"] = time.perf_counter() - t1

    def stamped(*args, **kwargs):
        stamps.append(time.perf_counter())
        if hook["prof"] is not None:
            hook["prof"].step()
        return launch(*args, **kwargs)

    lo, hi = SPIN_WINDOW
    pstep.fused_step = stamped
    try:
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=lo, warmup=1, active=hi - lo,
                                       repeat=1),
                     on_trace_ready=on_trace) as prof:
            hook["prof"] = prof
            t0 = time.perf_counter()
            loop.run_one_batch()                # warm-up: decode, trace
            torch.cuda.synchronize()
            warm = time.perf_counter() - t0
            hook["prof"] = None
        k1_warm = pstep.LAUNCHES["fused_step"]
        traced_wall = stamps[hi] - stamps[lo]
        stamps.clear()
        before = {"i": backend.stats["instructions"],
                  "c": loop.stats.testcases, "t": loop.stats.timeouts,
                  "b": backend.stats["batches"],
                  "spans": {p: reg.spans.seconds(p) for p in SPANS}}
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < SPIN_SECONDS:
            loop.run_one_batch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        pstep.fused_step = launch
    launches = dict(pstep.LAUNCHES)
    timed_k1 = launches["fused_step"] - k1_warm
    check("busy" in traced, f"the profiler traced no window of K1 rounds "
                            f"{lo}-{hi} in the warm-up batch")
    check(len(stamps) > hi, f"the first timed batch made {len(stamps)} K1 "
                            f"launches, fewer than {hi}")
    k1_n, k1_s = (sum(v[i] for n, v in traced["kernels"].items()
                      if "fused_step_kernel" in n) for i in (0, 1))
    check(k1_n > 0, "the traced window holds no K1 launch")
    window_wall = stamps[hi] - stamps[lo]
    execs = loop.stats.testcases - before["c"]
    batches = backend.stats["batches"] - before["b"]
    instr = backend.stats["instructions"] - before["i"]
    spans = {p: reg.spans.seconds(p) - before["spans"][p] for p in SPANS}
    rec = target_record("demo_spin", loop, wall, launches)
    rec.update({"warmup_s": warm, "testcases": execs, "batches": batches,
                "instructions": instr, "spans": spans,
                "execs_per_s": execs / wall, "instr_per_s": instr / wall,
                "timeout_frac": (loop.stats.timeouts - before["t"])
                / max(execs, 1),
                "k1_share": spans["execute/fused-step"] / wall,
                "resume_share": spans["execute/device-step"] / wall,
                "k1_launches_timed": timed_k1,
                "rounds_per_s": timed_k1 / wall,
                "window_rounds": (lo, hi), "window_wall_s": window_wall,
                "window_wall_traced_s": traced_wall,
                "trace_read_s": traced["read_s"],
                "device_busy_window_s": traced["busy"],
                "host_share": 1 - traced["busy"] / window_wall,
                "k1_ms_mean_trace": k1_s / k1_n * 1e3,
                "top_device_window": sorted(
                    ((n, c, t) for n, (c, t) in traced["kernels"].items()),
                    key=lambda v: -v[2])[:10]})
    err, retired, _ = hold_k1(loop, held_batch("demo_spin", loop,
                                               backend.n_lanes))
    k1["max_abs_err"] = max(k1["max_abs_err"] or 0, err)
    print(f"phase 18: demo_spin deep (bench's chip workload at limit "
          f"{SPIN_LIMIT}, {SPIN_LANES} lanes; warm-up batch {warm:.2f} s "
          f"with K1 rounds {lo}-{hi} traced: {traced_wall:.2f} s, and "
          f"{traced['read_s']:.2f} s to read the trace): {batches} batches, "
          f"{execs} "
          f"testcases in {wall:.2f} s = {rec['execs_per_s']:.1f} execs/s, "
          f"{rec['instr_per_s']:.4g} instructions/s; timeout fraction "
          f"{rec['timeout_frac']:.3f}; K1 launches {launches['fused_step']} "
          f"({timed_k1} after the warm-up = {timed_k1 / batches:.0f} per "
          f"batch, {rec['rounds_per_s']:.0f} per s), "
          f"{rec['k1_ms_mean_trace']:.4f} ms mean (profiler, {k1_n} in the "
          f"window); K1 share of the wall {rec['k1_share']:.3f}, resume "
          f"legs {rec['resume_share']:.3f}; the window's rounds took "
          f"{window_wall:.2f} s unprofiled, card busy {traced['busy']:.3f} s "
          f"= host share {rec['host_share']:.3f}; fused occupancy "
          f"{rec['occupancy']:.4f}; breakpoint services "
          f"{rec['bp_dispatches']}; K1 == plain on a batch start over 2 "
          f"dispatches (retired {retired}); spans "
          + ", ".join(f"{k} {v:.2f}" for k, v in spans.items()))
    k1["launches_by_path"]["demo_spin deep"] = launches["fused_step"]
    k2["launches_by_path"]["demo_spin deep"] = launches["probe"]
    record["spin_deep"] = rec
    del loop, backend
    torch.cuda.empty_cache()


def phase_new_targets_card_vs_cpu(cpu) -> None:
    for name in NEW_TARGETS + ("demo_spin",):
        limit = SPIN_SMALL_LIMIT if name == "demo_spin" else 100000
        card = small_campaign(name, "cuda", limit, seeded=True)
        want = cpu[name].result()
        check(all(card[i] == want[i] for i in range(5)),
              f"64-lane {name} campaign differs between card and cpu")
        print(f"phase 17: 64-lane 256-run {name} campaign, card == cpu: "
              f"{len(card[0])} corpus digests, crash names {card[1][:4]}, "
              f"statuses {card[4]}, equal cov/edge bytes (card "
              f"{card[5]:.1f} s, cpu {want[5]:.1f} s in a worker process)")


# ---------------------------------------------------------------------------
# phases 21-23: the fault-tolerance tier on phase 10's window campaign
# ---------------------------------------------------------------------------

def stats_line(loop) -> str:
    """The final `#N cov: .. corp: ..` line without its rate and uptime
    (the only fields that depend on the clock)."""
    return strip_clock(loop.stats.line(len(loop.corpus), loop._coverage()))


def strip_clock(line: str) -> str:
    import re

    return re.sub(r" exec/s: \S+| uptime: \S+", "", line.strip())


def tree_digests(root: Path) -> tuple:
    """(outputs/ content digests, crashes/ names) of a campaign's target
    directory."""
    from wtf_tpu_torch.utils.hashing import hex_digest

    outputs = sorted(hex_digest(p.read_bytes())
                     for p in (root / "outputs").iterdir()) \
        if (root / "outputs").is_dir() else []
    crashes = sorted(p.name for p in (root / "crashes").iterdir()) \
        if (root / "crashes").is_dir() else []
    return outputs, crashes


class SeamCount:
    """A supervisor fault hook that fires nothing and counts dispatches
    by seam (armed through chaos_device's hook global)."""

    def __init__(self):
        self.by_seam = {}

    def _device_hook(self, seam: str, index: int):
        self.by_seam[seam] = self.by_seam.get(seam, 0) + 1
        return None


class EventLog:
    """Keeps the supervisor's events (watchdog, rebuild, degrade,
    promote, poisoned-lane) for the rung history."""

    def __init__(self):
        self.events = []

    def emit(self, type, **fields):  # noqa: A002
        self.events.append((type, fields))

    def heartbeat(self, *args, **kwargs):
        pass


def fault_plan(lanes_poison: int):
    """Phase 22's one plan: a hang on K1 (`fused`, in the first window's
    host finish), an error on a window (`megachunk`), a poison on an
    insert (`device-insert`, in the batch-at-a-time replay that follows)
    and a hang on a generation (`devmut-generate`, the third after the
    poison: the next batch's prelaunch)."""
    from wtf_tpu_torch.testing.faultinject import SeamFaultPlan

    return SeamFaultPlan([
        ("fused", "device-hang"), ("megachunk", "device-error"),
        ("device-insert", ("device-poison", lanes_poison)),
        ("devmut-generate", "device-hang", 3)])


def quarantine_plan():
    """A poison on the same lane of three windows: quarantined at the
    third (the supervisor's default threshold)."""
    from wtf_tpu_torch.testing.faultinject import SeamFaultPlan

    return SeamFaultPlan([("megachunk", ("device-poison", QUARANTINE_LANE))]
                         * 3)


def faulted_campaign(argv: list, plan) -> tuple:
    """Run `argv` under chaos_device(plan) with promote_after=1 (a clean
    batch wins one rung back).  Returns (loop, event log, wall)."""
    import torch

    from wtf_tpu_torch import cli
    from wtf_tpu_torch.testing.faultinject import chaos_device

    loop = cli.build_campaign(cli.build_parser().parse_args(argv))
    sup = loop.backend.supervisor
    sup.promote_after = 1
    log = EventLog()
    sup.events = log
    t0 = time.perf_counter()
    with chaos_device(plan):
        loop.fuzz(runs=loop_runs(argv))
    if loop.backend.runner.device.type == "cuda":
        torch.cuda.synchronize()
    return loop, log, time.perf_counter() - t0


def loop_runs(argv: list) -> int:
    return int(argv[argv.index("--runs") + 1])


def rung_history(log: EventLog) -> list:
    return [f"{kind}:{fields['rung']}" for kind, fields in log.events
            if kind in ("degrade", "promote")]


def timed_campaign(argv: list) -> tuple:
    """(outcome, wall) of the 16384-run campaign `argv` writing a fresh
    target dir; the wall runs from the campaign's build to the card's
    last work, as phase 21's own run."""
    import torch

    from wtf_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        a = cli.build_parser().parse_args(
            argv + ["--target", str(Path(tmp) / "t")])
        t0 = time.perf_counter()
        loop = cli.build_campaign(a)
        loop.fuzz(runs=RUNS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out = outcome(loop)
    del loop
    torch.cuda.empty_cache()
    return out, wall


def phase_supervised(k1: dict, k2: dict, record: dict,
                     window_out: tuple, keep: Path) -> tuple:
    """Phase 21: phase 10's window campaign supervised, with a watchdog
    and a checkpoint after every batch: equal to phase 10's; then its
    cost in parts, in turns.  Its outputs/ and crashes/ are copied into
    `keep` (the corpus phases 24-26 triage).  Returns (final line,
    outputs/ digests) for phase 23."""
    import shutil

    import torch

    from wtf_tpu_torch import cli
    from wtf_tpu_torch.interp import pstep
    from wtf_tpu_torch.testing.faultinject import chaos_device

    with tempfile.TemporaryDirectory() as tmp:
        target = Path(tmp) / "t21"
        a = cli.build_parser().parse_args(SCAMPAIGN + ["--target",
                                                       str(target)])
        for name in pstep.LAUNCHES:
            pstep.LAUNCHES[name] = 0
        seams = SeamCount()
        log = EventLog()
        t0 = time.perf_counter()
        loop = cli.build_campaign(a)
        loop.backend.supervisor.events = log
        with chaos_device(seams):
            loop.fuzz(runs=RUNS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(pstep.LAUNCHES)
        tree = tree_digests(target)
        for sub in ("outputs", "crashes"):
            shutil.copytree(target / sub, keep / sub)
        ckpt = target / "checkpoint" / "checkpoint.json"
        ckpt_bytes = ckpt.stat().st_size
        blob_bytes = sum(p.stat().st_size for p in
                         (target / "checkpoint" / "corpus").iterdir())
    reg = loop.registry
    spans = reg.spans
    line = stats_line(loop)
    out = outcome(loop)
    check(all(out[i] == window_out[i] for i in range(4)),
          f"the supervised window campaign differs from phase 10's "
          f"(corpus, crashes, cov, edge equal: "
          f"{[out[i] == window_out[i] for i in range(4)]}; rebuilds "
          f"{reg.counter('supervise.rebuilds').value}, poisoned lanes "
          f"{reg.counter('supervise.poisoned_lanes').value})")
    check(line == record["window_campaign"]["final_line"],
          f"final line {line!r} differs from phase 10's "
          f"{record['window_campaign']['final_line']!r}")
    check(tree[0] == sorted(window_out[0]),
          "outputs/ differs from phase 10's corpus")
    check(tree[1] == sorted(window_out[1]),
          "crashes/ differs from phase 10's crash names")
    dispatches = reg.counter("supervise.dispatches").value
    waits = reg.counter("supervise.bounded_waits").value
    saves = reg.counter("campaign.checkpoints").value
    check(launches["fused_step"] > 0 and dispatches > 0
          and seams.by_seam.get("megachunk", 0) > 0,
          f"K1 did not run under supervision: {launches}, {seams.by_seam}")
    check(reg.counter("supervise.rebuilds").value == 0,
          f"a fault-free supervised campaign rebuilt: {log.events[:6]}")
    check(saves == loop.batches_done, f"{saves} checkpoints for "
          f"{loop.batches_done} batches")
    share = {p: spans.seconds(p) / wall
             for p in ("integrity", "supervise-snapshot", "checkpoint")}
    per_save = spans.seconds("checkpoint") / max(saves, 1)
    print(f"phase 21: supervised window campaign (--dispatch-timeout 30, "
          f"--checkpoint-every 1) == phase 10: {line}; {len(tree[0])} "
          f"outputs, {len(tree[1])} crashes, equal cov/edge bytes; "
          f"{wall:.2f} s = {loop.stats.testcases / wall:.1f} execs/s; "
          f"supervised dispatches {dispatches} ({seams.by_seam}), bounded "
          f"waits {waits}; K1 launches {launches['fused_step']}, K2 "
          f"{launches['probe']}; integrity {share['integrity']:.4f}, "
          f"supervise-snapshot {share['supervise-snapshot']:.4f}, "
          f"checkpoint {share['checkpoint']:.4f} of the wall; "
          f"{saves} checkpoints of {ckpt_bytes} bytes "
          f"(+{blob_bytes} bytes of corpus blobs), {per_save * 1e3:.1f} ms "
          f"per save")
    k1["launches_by_path"]["demo_tlv window supervised"] = \
        launches["fused_step"]
    k2["launches_by_path"]["demo_tlv window supervised"] = launches["probe"]
    record["supervised"] = {
        "wall_s": wall, "dispatches": dispatches, "by_seam": seams.by_seam,
        "bounded_waits": waits, "k1_launches": launches["fused_step"],
        "k2_launches": launches["probe"], "wall_shares": share,
        "checkpoints": saves, "checkpoint_bytes": ckpt_bytes,
        "blob_bytes": blob_bytes, "seconds_per_save": per_save,
        "final_line": line}
    del loop
    torch.cuda.empty_cache()

    # the cost in parts, in turns T S after the run above (C): T is phase 10's campaign writing outputs/ and crashes/
    # into a target dir, S adds the supervisor (watchdog, integrity,
    # snapshot), C adds a checkpoint after every batch
    argvs = {"T": WCAMPAIGN, "S": WCAMPAIGN + SUPERVISE, "C": SCAMPAIGN}
    walls = {"T": [], "S": [], "C": [wall]}
    for key in "TS":
        got, seconds = timed_campaign(argvs[key])
        check(got[:4] == window_out[:4],
              f"phase 21's {key} run differs from phase 10's")
        walls[key].append(seconds)
    mean = {k: sum(v) / len(v) for k, v in walls.items()}
    p10 = record["window_campaign"]["turns_wall_s"]["8"]
    parts = {"target dir": mean["T"] - sum(p10) / len(p10),
             "supervisor": mean["S"] - mean["T"],
             "checkpoints": mean["C"] - mean["S"]}
    print(f"phase 21: in turns (C, T, S), equal results: walls "
          f"T (phase 10 + --target) {walls['T']}, S (+ {' '.join(SUPERVISE)}"
          f") {walls['S']}, C (+ --checkpoint-every 1) {walls['C']}; "
          f"phase 10's {p10}; mean differences: "
          + ", ".join(f"{k} {v:+.4f} s ({v / mean['C']:+.4f} of C)"
                      for k, v in parts.items())
          + f"; checkpoint span of the first C "
            f"{spans.seconds('checkpoint'):.4f} s")
    record["supervised"].update(turns_wall_s=walls, parts_s=parts)
    return line, tree


def phase_faults(k1: dict, k2: dict, record: dict,
                 window_out: tuple) -> None:
    """Phase 22: one scripted plan of a hang on K1, an error on a window,
    a poison on an insert and a hang on a generation, replayed
    bit-identically (equal to phase 10's); then a poison repeated at one
    lane until it is quarantined (that run completes)."""
    import torch

    from wtf_tpu_torch.interp import pstep

    argv = WCAMPAIGN + SUPERVISE
    rec = {}
    for name, plan in (("faults", fault_plan(7)),
                       ("quarantine", quarantine_plan())):
        for key in pstep.LAUNCHES:
            pstep.LAUNCHES[key] = 0
        loop, log, wall = faulted_campaign(argv, plan)
        launches = dict(pstep.LAUNCHES)
        reg = loop.registry
        sup = loop.backend.supervisor
        counters = {k: reg.counter(f"supervise.{k}").value for k in (
            "dispatches", "bounded_waits", "watchdog_fires",
            "device_errors", "poisoned_lanes", "batch_retries", "rebuilds",
            "degradations", "promotions", "integrity_checks")}
        history = rung_history(log)
        rebuild_s = reg.spans.seconds("supervise-recover")
        fired = [f[:2] for f in plan.fired]
        check(not plan.seam_faults, f"phase 22 {name}: faults left unfired "
              f"{plan.seam_faults} (fired {fired})")
        check(counters["degradations"] >= 1 and counters["promotions"] >= 1,
              f"phase 22 {name}: rung history {history}")
        check(launches["fused_step"] > 0,
              f"phase 22 {name}: K1 never launched")
        check(launches["probe"] == 1 + counters["rebuilds"],
              f"phase 22 {name}: K2 launched {launches['probe']} times for "
              f"{counters['rebuilds']} rebuilds")
        check(loop.stats.testcases == RUNS,
              f"phase 22 {name}: {loop.stats.testcases} testcases")
        if name == "faults":
            out = outcome(loop)
            check(all(out[i] == window_out[i] for i in range(4)),
                  f"phase 22: the faulted campaign differs from phase "
                  f"10's (equal: "
                  f"{[out[i] == window_out[i] for i in range(4)]}; "
                  f"{counters}; fired {fired})")
            check(stats_line(loop) ==
                  record["window_campaign"]["final_line"],
                  "phase 22: the faulted campaign's final line differs")
            check(counters["rebuilds"] == 4 and sup.quarantined == set(),
                  f"phase 22: {counters}, quarantined {sup.quarantined}")
        else:
            check(sup.quarantined == {QUARANTINE_LANE},
                  f"phase 22: quarantined {sup.quarantined}")
            rec["quarantine_outcome"] = outcome(loop)[:4]
        print(f"phase 22: {name}: fired {fired}; supervise counters "
              f"{counters}; rung history {history}; quarantined "
              f"{sorted(sup.quarantined)}; rebuilds took "
              f"{rebuild_s:.2f} s of the {wall:.2f} s wall "
              f"({rebuild_s / max(counters['rebuilds'], 1):.2f} s each); "
              f"K1 launches {launches['fused_step']} (replays included), "
              f"K2 {launches['probe']} (1 + one per rebuild); "
              + (f"equal to phase 10: {stats_line(loop)}" if name == "faults"
                 else f"{loop.stats.testcases} testcases, "
                      f"{len(loop.corpus)} corpus entries"))
        k1["launches_by_path"][f"demo_tlv window {name}"] = \
            launches["fused_step"]
        k2["launches_by_path"][f"demo_tlv window {name}"] = launches["probe"]
        rec[name] = {"wall_s": wall, "counters": counters,
                     "rung_history": history, "rebuild_s": rebuild_s,
                     "fired": fired, "k1_launches": launches["fused_step"],
                     "k2_launches": launches["probe"]}
        del loop
        torch.cuda.empty_cache()
    record["faults"] = rec


def phase_kill_resume(record: dict, supervised: tuple) -> None:
    """Phase 23: phase 21's campaign in a subprocess, SIGKILLed once its
    checkpoint has been written twice, then `campaign --resume` in a new
    process: the same final line and outputs/ as phase 21."""
    import os
    import signal

    line21, tree21 = supervised
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    with tempfile.TemporaryDirectory() as tmp:
        target = Path(tmp) / "t23"
        ckpt = target / "checkpoint"
        argv = [sys.executable, "-m", "wtf_tpu_torch"] + SCAMPAIGN + [
            "--target", str(target)]
        t0 = time.perf_counter()
        victim = subprocess.Popen(argv, cwd=Path(__file__).resolve().parent,
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
        try:
            while victim.poll() is None and not (
                    ckpt / "checkpoint.json.prev").exists():
                time.sleep(0.01)
            killed = victim.poll() is None
            if killed:
                victim.send_signal(signal.SIGKILL)
            victim.communicate(timeout=120)
        finally:
            if victim.poll() is None:
                victim.kill()
                victim.wait()
        victim_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        resumed = subprocess.run(argv + ["--resume", str(ckpt)],
                                 cwd=Path(__file__).resolve().parent,
                                 env=env, capture_output=True, text=True,
                                 timeout=600)
        resume_s = time.perf_counter() - t1
        check(resumed.returncode in (0, 2),
              f"phase 23: the resumed campaign failed: "
              f"{resumed.stderr[-2000:]}")
        lines = resumed.stdout.splitlines()
        note = [ln for ln in lines if ln.startswith("resumed at batch")]
        final = [ln for ln in lines if ln.startswith("#")]
        check(bool(note) and bool(final),
              f"phase 23: no resume note or final line: {lines[-5:]}")
        tree = tree_digests(target)
    line = strip_clock(final[-1])
    check(line == line21, f"phase 23: final line {line!r} differs from "
          f"phase 21's {line21!r}")
    check(tree == tree21, "phase 23: outputs/ or crashes/ differ from "
          "phase 21's")
    after = int(note[0].split()[3].rstrip(":"))
    fell_back = "from .prev" in note[0]
    print(f"phase 23: SIGKILL {'sent' if killed else 'not needed (the '
                                'campaign ended first)'} after "
          f"{victim_s:.2f} s; `campaign --resume` in a new process "
          f"({resume_s:.2f} s) resumed after batch {after}, fell back to "
          f".prev: {fell_back}; == phase 21: {line}, {len(tree[0])} "
          f"outputs, {len(tree[1])} crashes")
    record["kill_resume"] = {"killed": killed, "victim_s": victim_s,
                             "resume_s": resume_s, "resumed_after": after,
                             "fell_back": fell_back}


def small_tier(device: str) -> dict:
    """The CPU twins of phases 21-23 (and their card sides), at 64 lanes
    and 256 runs: the supervised window campaign, the faulted one, the
    quarantine one, and the window campaign killed at batch 2 and
    resumed in a fresh loop.  Returns {name: outcome[:4]}."""
    from wtf_tpu_torch import cli
    from wtf_tpu_torch.resume import load_campaign, restore_campaign
    from wtf_tpu_torch.testing.faultinject import fuzz_until_killed

    base = ["campaign", "--name", "demo_tlv", "--fused-step", "on",
            "--lanes", "64", "--runs", "256", "--limit", "20000",
            "--max_len", "96", "--seed", "5", "--device", device, *WINDOW,
            *SUPERVISE]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        ck = Path(tmp) / "ck"
        a = cli.build_parser().parse_args(
            base + ["--checkpoint-every", "1", "--checkpoint-dir", str(ck)])
        out["supervised"] = outcome(cli.campaign(a))[:4]
        for name, plan in (("faults", fault_plan(7)),
                           ("quarantine", quarantine_plan())):
            loop, _, _ = faulted_campaign(base, plan)
            out[name] = outcome(loop)[:4] + (
                [f[:2] for f in plan.fired], sorted(
                    loop.backend.supervisor.quarantined))
        ck2 = Path(tmp) / "ck2"
        victim = cli.build_campaign(cli.build_parser().parse_args(
            base + ["--checkpoint-every", "1", "--checkpoint-dir",
                    str(ck2)]))
        fuzz_until_killed(victim, 256, kill_at_batch=2)
        loop = cli.build_campaign(cli.build_parser().parse_args(
            base + ["--checkpoint-every", "1", "--checkpoint-dir",
                    str(ck2)]))
        state, _ = load_campaign(ck2)
        restore_campaign(loop, state, ck2)
        loop.fuzz(256)
        out["resumed"] = outcome(loop)[:4]
    return out


def phase_tier_card_vs_cpu(cpu, card_window: tuple) -> None:
    """Phases 21-23 at 64 lanes: the card equals the CPU on every run,
    and the runs without repeated poison equal the unsupervised window
    campaign of phase 11."""
    t0 = time.perf_counter()
    card = small_tier("cuda")
    card_s = time.perf_counter() - t0
    want = cpu["fault tolerance"].result()
    for name in ("supervised", "faults", "resumed", "quarantine"):
        check(card[name] == want[name],
              f"64-lane {name} campaign differs between card and cpu")
    for name in ("supervised", "faults", "resumed"):
        check(all(card[name][i] == card_window[i] for i in range(4)),
              f"64-lane {name} campaign differs from phase 11's window "
              f"campaign")
    check(card["quarantine"][5] == [QUARANTINE_LANE],
          f"64-lane quarantine: {card['quarantine'][5]}")
    print(f"phases 21-23: 64-lane 256-run supervised, faulted (fired "
          f"{card['faults'][4]}), killed-and-resumed and quarantine "
          f"(fired {card['quarantine'][4]}, quarantined "
          f"{card['quarantine'][5]}) window campaigns: card == cpu, the "
          f"first three == phase 11 ({card_s:.1f} s on the card)")


# ---------------------------------------------------------------------------
# phases 24-26: batched triage of phase 21's corpus at the main path's width
# ---------------------------------------------------------------------------

def triage_corpus(keep: Path, root: Path, n=None) -> Path:
    """A target dir whose inputs/ holds every file of phase 21's outputs/
    and crashes/ (the `n` largest, ties by name, when `n` is given; a
    find that also crashed is in both, and the minset's walk keeps one of
    each content); returns it."""
    import shutil

    inputs = root / "inputs"
    inputs.mkdir(parents=True)
    files = sorted((p for d in ("outputs", "crashes")
                    for p in (keep / d).iterdir()),
                   key=lambda p: (-p.stat().st_size, p.name))
    for path in files[:n]:
        shutil.copy(path, inputs / path.name)
    return root


def triage_run(cmd: str, source: Path, lanes: int, device: str,
               work: Path) -> dict:
    """One triage command through the port's CLI (`cli.main`, with
    --telemetry-dir), at `lanes` lanes on `device` with the main path's
    engine and limit: `minset` (`campaign --runs 0`) and `distill` of the
    target dir `source`, `minimize` and `vbreak` (lanes - 1 variants) of
    the testcase file `source`.  Returns its rc, printed lines (without
    the clock, the backend's run-stats lines and the lines naming a
    temporary path), run-end metrics (counters and span seconds), the K1
    and K2 launches it made (counts zeroed just before, read just after),
    the final statuses of its lanes, its wall to the card's last work,
    and what it left: the kept digests, the minimized bytes or the
    captures."""
    import contextlib
    import io

    import torch

    from wtf_tpu_torch import cli
    from wtf_tpu_torch.interp import pstep
    from wtf_tpu_torch.telemetry import read_events

    dump = work / f"{cmd}-captures.json"
    argv = {"minset": ["campaign", "--runs", "0", "--max_len", "96",
                       "--seed", "5", "--target", str(source)],
            "distill": ["triage", "distill", "--target", str(source)],
            "minimize": ["triage", "minimize", "--input", str(source)],
            "vbreak": ["triage", "vbreak", "--input", str(source),
                       "--variants", str(lanes - 1), "--out", str(dump)]
            + VBREAK_AT}[cmd]
    telemetry = work / f"{cmd}-telemetry"
    built = []
    build_backend = cli.build_backend

    def keeping(*args, **kwargs):
        backend, paths = build_backend(*args, **kwargs)
        built.append(backend)
        return backend, paths

    for key in pstep.LAUNCHES:
        pstep.LAUNCHES[key] = 0
    out = io.StringIO()
    cli.build_backend = keeping
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv + [
                "--name", "demo_tlv", "--fused-step", "on", "--lanes",
                str(lanes), "--limit", "20000", "--device", device,
                "--telemetry-dir", str(telemetry)])
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        cli.build_backend = build_backend
    launches = dict(pstep.LAUNCHES)
    statuses = dict(built[0].status_counts)
    del built
    if device == "cuda":
        torch.cuda.empty_cache()
    end = [e for e in read_events(telemetry / "events.jsonl")
           if e["type"] == "run-end"]
    check(bool(end), f"{cmd}: no run-end record in events.jsonl")
    lines = [strip_clock(ln) for ln in out.getvalue().splitlines()
             if not ln.startswith(("[", "wrote "))]
    rec = {"rc": rc, "lines": lines, "metrics": end[-1]["metrics"],
           "launches": launches, "statuses": statuses, "wall": wall}
    if cmd in ("minset", "distill"):
        rec["left"] = tree_digests(source)[0]
    elif cmd == "minimize":
        done = source.with_name(source.name + ".min")
        rec["left"] = done.read_bytes() if done.exists() else None
    else:
        rec["left"] = json.loads(dump.read_text()) if dump.exists() \
            else None
    return rec


def span_s(metrics: dict, path: str) -> float:
    return float(metrics.get("phase.seconds", {}).get(path, 0.0))


def line_with(lines: list, prefix: str) -> str:
    found = [ln for ln in lines if ln.startswith(prefix)]
    check(bool(found), f"no {prefix!r} line in {lines[-4:]}")
    return found[-1]


def replay_buckets(testcases: list, device: str) -> list:
    """The crash bucket of each testcase (None for a non-crash), replayed
    in one batch of a fresh TWIN_LANES-lane backend."""
    from wtf_tpu_torch.backend.gpu import GpuBackend
    from wtf_tpu_torch.harness import demo_tlv
    from wtf_tpu_torch.triage import ReplayCore

    backend = GpuBackend(demo_tlv.build_snapshot(), n_lanes=TWIN_LANES,
                         limit=20000, device=device, fused_step="on")
    backend.initialize()
    demo_tlv.TARGET.init(backend)
    sweep = ReplayCore(backend, demo_tlv.TARGET).replay(
        testcases, want_buckets=True)
    return [sweep.buckets.get(i) for i in range(len(testcases))]


def hex_of(path: Path) -> str:
    from wtf_tpu_torch.utils.hashing import hex_digest

    return hex_digest(path.read_bytes())


def phase_triage(k1: dict, k2: dict, record: dict, keep: Path,
                 work: Path, device: str = "cuda",
                 lanes: int = LANES) -> bytes:
    """Phases 24-26: the minset, distill, minimize and vbreak of phase
    21's corpus at 4096 lanes x 128 rows, K1 on (each command's counts
    zeroed just before it and read just after).  Returns vbreak's input
    for the 64-lane twins."""
    import importlib
    import re

    from wtf_tpu_torch.backend.gpu import GpuBackend

    rec = {}
    t24 = triage_corpus(keep, work / "minset")
    rec["minset"] = m = triage_run("minset", t24, lanes, device, work)
    files = sorted((t24 / "inputs").iterdir())
    corpus = sorted({hex_of(p) for p in files})
    kept_line = line_with(m["lines"], "minset: kept ")
    n_kept = int(kept_line.split()[2].split("/")[0])
    check(m["rc"] in (0, 2), f"phase 24: rc {m['rc']}")
    check(m["launches"]["fused_step"] > 0, "phase 24: K1 never launched")
    check(len(m["left"]) == n_kept and set(m["left"]) <= set(corpus)
          and kept_line.endswith(f"/{len(corpus)} seeds"),
          f"phase 24: outputs/ holds {len(m['left'])} files for "
          f"{kept_line!r}")
    check(sum(m["statuses"].values()) == len(corpus)
          and set(m["statuses"]) <= TERMINAL,
          f"phase 24: statuses {m['statuses']} for {len(corpus)} seeds")
    print(f"phase 24: minset (`campaign --runs 0`) of phase 21's "
          f"{len(files)} outputs and crashes ({len(corpus)} distinct) at "
          f"{lanes} lanes: {kept_line!r}, outputs/ == the kept subset; "
          f"{line_with(m['lines'], '#')}; "
          f"{m['metrics'].get('triage.dispatches', 0)} dispatches, K1 "
          f"launches {m['launches']['fused_step']}, K2 "
          f"{m['launches']['probe']}; statuses {m['statuses']}; "
          f"{m['wall']:.2f} s wall (execute "
          f"{span_s(m['metrics'], 'execute'):.2f} s)")

    dmod = importlib.import_module("wtf_tpu_torch.triage.distill")
    greedy_cover, cover_s = dmod.greedy_cover, []

    def timed_cover(planes):
        t0 = time.perf_counter()
        try:
            return greedy_cover(planes)
        finally:
            cover_s.append(time.perf_counter() - t0)

    t25 = triage_corpus(keep, work / "distill")
    dmod.greedy_cover = timed_cover
    try:
        rec["distill"] = d = triage_run("distill", t25, lanes, device, work)
    finally:
        dmod.greedy_cover = greedy_cover
    line = line_with(d["lines"], "distill: kept ")
    bits = re.search(r"exact cover, (\d+)/(\d+) bits; prefix minset would "
                     r"keep (\d+);", line)
    check(bits is not None and bits[1] == bits[2],
          f"phase 25: distill lost coverage: {line!r}")
    n_keep = int(line.split()[2].split("/")[0])
    check(int(bits[3]) == n_kept, f"phase 25: the prefix minset keeps "
          f"{bits[3]}, phase 24 kept {n_kept}")
    check(n_keep <= n_kept and len(d["left"]) == n_keep,
          f"phase 25: the exact cover keeps {n_keep} ({len(d['left'])} in "
          f"outputs/), phase 24 kept {n_kept}")
    check(d["launches"]["fused_step"] > 0, "phase 25: distill without K1")
    print(f"phase 25: distill of the same {len(corpus)} seeds: {line!r}; "
          f"{d['metrics'].get('triage.dispatches', 0)} dispatches, K1 "
          f"launches {d['launches']['fused_step']}; {d['wall']:.2f} s wall "
          f"(execute {span_s(d['metrics'], 'execute'):.2f} s, the greedy "
          f"set cover on the host {sum(cover_s):.2f} s)")

    largest = max((keep / "crashes").iterdir(),
                  key=lambda p: (p.stat().st_size, p.name))
    crash_file = work / largest.name
    crash_file.write_bytes(largest.read_bytes())
    rec["minimize"] = mz = triage_run("minimize", crash_file, lanes, device,
                                      work)
    line = line_with(mz["lines"], "minimize: ")
    minimized, met = mz["left"], mz["metrics"]
    check(mz["rc"] == 0 and minimized is not None,
          f"phase 25: minimize failed: {line!r}")
    check(len(minimized) <= largest.stat().st_size
          and mz["launches"]["fused_step"] > 0,
          f"phase 25: minimize gave {len(minimized)} bytes from "
          f"{largest.stat().st_size}, K1 {mz['launches']}")
    bucket = re.search(r"\(bucket (\S+);", line)[1]
    replayed = replay_buckets([largest.read_bytes(), minimized], device)
    check(replayed == [bucket, bucket], f"phase 25: replayed buckets "
          f"{replayed}, the minimizer's {bucket}")
    disp = met.get("triage.dispatches", 0)
    cands = met.get("triage.candidates", 0)
    print(f"phase 25: minimize of phase 21's largest crasher {largest.name} "
          f"({largest.stat().st_size} bytes): {line!r}; {disp} dispatches, "
          f"{cands / max(disp, 1):.1f} candidates per dispatch "
          f"({cands / max(disp, 1) / lanes:.3f} of the lanes; the rest "
          f"replay the current reproducer), "
          f"{met.get('triage.minimize_rounds', 0)} rounds, K1 launches "
          f"{mz['launches']['fused_step']}; {mz['wall']:.2f} s wall "
          f"(execute {span_s(met, 'execute'):.2f} s); the crasher and the "
          f"result replayed apart: both bucket {bucket}")

    vbreak_input, note = minimized, ""
    timed = {"s": 0.0, "n": 0}
    dispatch_bp = GpuBackend._dispatch_bp

    def timed_bp(self, runner, view, lane):
        t0 = time.perf_counter()
        try:
            return dispatch_bp(self, runner, view, lane)
        finally:
            timed["s"] += time.perf_counter() - t0
            timed["n"] += 1

    vb_file = work / "vbreak.bin"
    GpuBackend._dispatch_bp = timed_bp
    try:
        for attempt in range(2):
            vb_file.write_bytes(vbreak_input)
            timed.update(s=0.0, n=0)
            rec["vbreak"] = vb = triage_run("vbreak", vb_file, lanes,
                                            device, work)
            caps = [c for c in vb["left"] or [] if c]
            if caps or attempt:
                break
            vbreak_input = SMOKE_CRASHER
            note = (" (phase 25's minimized crasher never reached the "
                    "second hit: triage_smoke's crasher instead)")
    finally:
        GpuBackend._dispatch_bp = dispatch_bp
    met = vb["metrics"]
    check(vb["rc"] == 0 and caps and all(c["icount"] > 0 for c in caps),
          f"phase 26: {len(caps)} captures, rc {vb['rc']}")
    check(vb["launches"]["fused_step"] > 0, "phase 26: vbreak without K1")
    pull, push = (span_s(met, "execute/service-pull"),
                  span_s(met, "execute/service-push"))
    services = timed["s"] + pull + push
    print(f"phase 26: vbreak at tlv!parse+0x12, hit 2, over {lanes} "
          f"replays{note}: {line_with(vb['lines'], 'vbreak: ')!r}; K1 "
          f"launches {vb['launches']['fused_step']}; {vb['wall']:.2f} s "
          f"wall; host breakpoint services {services:.2f} s = "
          f"{services / vb['wall']:.3f} of the wall ({timed['n']} handler "
          f"calls {timed['s']:.2f} s, "
          f"{timed['s'] / max(timed['n'], 1) * 1e3:.3f} ms each; view pulls "
          f"{pull:.2f} s, pushes {push:.2f} s; "
          f"{met.get('runner.bp_dispatches', 0)} bp dispatches)")
    for name, r in rec.items():
        k1["launches_by_path"][f"demo_tlv triage {name}"] = \
            r["launches"]["fused_step"]
        k2["launches_by_path"][f"demo_tlv triage {name}"] = \
            r["launches"]["probe"]
    record["triage"] = {
        name: {"wall_s": r["wall"], "rc": r["rc"], "lines": r["lines"][:4],
               "k1_launches": r["launches"]["fused_step"],
               "k2_launches": r["launches"]["probe"],
               "statuses": r["statuses"],
               "counters": {k: v for k, v in r["metrics"].items()
                            if k.startswith(("triage.", "runner."))},
               "spans": r["metrics"].get("phase.seconds", {})}
        for name, r in rec.items()}
    record["triage"]["minset"].update(files=len(files), seeds=len(corpus),
                                      kept=n_kept)
    record["triage"]["distill"]["greedy_cover_s"] = sum(cover_s)
    record["triage"]["minimize"].update(
        input=largest.name, from_len=largest.stat().st_size,
        to_len=len(minimized))
    record["triage"]["vbreak"].update(
        handler_s=timed["s"], handler_calls=timed["n"],
        service_share=services / vb["wall"], captures=len(caps),
        input_note=note)
    return vbreak_input


def triage_twin(device: str, which: str, keep: Path,
                vbreak_input: bytes) -> tuple:
    """Half of the 64-lane twins of phases 24-26 (worker processes run the
    CPU side): `corpus` runs the minset and distill of phase 21's
    TWIN_CORPUS largest files, `crasher` minimize of triage_smoke's
    crasher and vbreak of phase 26's input.  Returns (what must be equal
    between card and CPU, seconds)."""
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        if which == "corpus":
            runs = [(cmd, triage_corpus(keep, work / cmd, TWIN_CORPUS))
                    for cmd in ("minset", "distill")]
        else:
            (work / "crash.bin").write_bytes(SMOKE_CRASHER)
            (work / "vbreak.bin").write_bytes(vbreak_input)
            runs = [("minimize", work / "crash.bin"),
                    ("vbreak", work / "vbreak.bin")]
        for cmd, source in runs:
            r = triage_run(cmd, source, TWIN_LANES, device, work)
            # the minset's heartbeat lines follow the clock: its last two
            # lines (the stats line and `minset: kept`) are the result
            out[cmd] = (r["rc"], r["lines"][-2:] if cmd == "minset"
                        else r["lines"], r["left"])
    return out, time.perf_counter() - t0


def phase_triage_card_vs_cpu(cpu, keep: Path, vbreak_input: bytes) -> None:
    """Phases 24-26 at 64 lanes: the card equals the CPU on every printed
    line, kept digest, minimized byte and capture."""
    card, card_s, cpu_s = {}, 0.0, []
    for which in ("corpus", "crasher"):
        got, seconds = triage_twin("cuda", which, keep, vbreak_input)
        want, cpu_seconds = cpu[f"triage {which}"].result()
        card.update(got)
        card_s += seconds
        cpu_s.append(cpu_seconds)
        for cmd in got:
            check(got[cmd] == want[cmd],
                  f"{TWIN_LANES}-lane triage {cmd} differs between card "
                  f"and cpu: "
                  f"{got[cmd][1][-2:]} vs {want[cmd][1][-2:]}")
    check(card["minimize"][2] == SMOKE_MINIMAL,
          f"{TWIN_LANES}-lane minimize: not the known-minimal reproducer")
    caps = [c for c in card["vbreak"][2] or [] if c]
    print(f"phases 24-26: {TWIN_LANES}-lane minset "
          f"({card['minset'][1][-1]!r}), distill, minimize "
          f"({len(SMOKE_CRASHER)} -> {len(card['minimize'][2])} bytes) and "
          f"vbreak ({len(caps)} captures of {TWIN_LANES}): card == cpu on "
          f"every line, digest, byte and "
          f"capture (card {card_s:.1f} s, cpu {cpu_s[0]:.1f} s and "
          f"{cpu_s[1]:.1f} s in two worker processes)")


# ---------------------------------------------------------------------------
# phases 27-29: the master/client plane, a mux node on the card
# ---------------------------------------------------------------------------

NODE_RUNS = 16384               # phase 27's master budget
CHAOS_RUNS = 8192               # phase 29's
CHAOS_MAX_LEN = 32              # phase 29's testcases: a work frame of
                                # 4096 fits one socket send buffer
TWIN_RUNS = 256                 # phase 28's, at TWIN_LANES
MASTER = ["master", "--name", "demo_tlv", "--seed", "5"]
NODE = ["fuzz", "--name", "demo_tlv", "--mux", "--fused-step", "on",
        "--limit", "20000", "--seed", "5"]
NODE_SPANS = ("wire-recv", "execute", "harvest", "wire-send", "restore",
              "execute/insert", "execute/fused-step", "execute/device-step",
              "execute/service-decode", "execute/cov-readback")


def start_master(root: Path, runs: int, max_len: int = 96) -> tuple:
    """The port's `master` CLI in a subprocess (no device work) over a
    unix socket under `root`, with its target dir, content-addressed
    store and telemetry dir there too.  Returns (address, process)."""
    root.mkdir(parents=True)
    addr = f"unix://{root}/m.sock"
    proc = subprocess.Popen(
        [sys.executable, "-m", "wtf_tpu_torch", *MASTER, "--runs",
         str(runs), "--max_len", str(max_len), "--target", str(root / "t"),
         "--address", addr,
         "--store", str(root / "store"), "--telemetry-dir",
         str(root / "telem")],
        cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    # a node dials for 10 s; a cold interpreter can take longer than that
    # to import torch and listen, so wait for the socket to appear
    deadline = time.monotonic() + 120
    while not (root / "m.sock").exists():
        if proc.poll() is not None or time.monotonic() > deadline:
            proc.kill()
            fail(f"master never listened: {proc.communicate()[1][-2000:]}")
        time.sleep(0.05)
    return addr, proc


def finish_master(root: Path, proc) -> dict:
    """Wait for a master; its rc, final count line (without the clock
    fields), run-end metrics, coverage.cov (each node's random client id
    left out), and the names in outputs/ and crashes/."""
    import re

    from wtf_tpu_torch.telemetry import read_events

    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode in (0, 2), f"master failed: {err[-2000:]}")
    counts = [ln for ln in out.splitlines() if ln.startswith("#")]
    check(bool(counts), f"master printed no count line: {out[-500:]}")
    end = [e for e in read_events(root / "telem" / "events.jsonl")
           if e["type"] == "run-end"]
    check(bool(end), "master: no run-end record")
    doc = json.loads((root / "t" / "coverage.cov").read_text())
    target = root / "t"
    return {"rc": proc.returncode,
            "line": re.sub(r" (exec/s|lastcov|uptime): \S+", "",
                           counts[-1].strip()),
            "metrics": end[-1]["metrics"],
            "addresses": doc["addresses"],
            "cursors": sorted((c["table"], c["words"])
                              for c in doc.get("cursors", {}).values()),
            "outputs": sorted(p.name for p in (target / "outputs").iterdir())
            if (target / "outputs").is_dir() else [],
            "crashes": sorted(p.name for p in (target / "crashes").iterdir())
            if (target / "crashes").is_dir() else []}


def run_node(addr: str, lanes: int, device: str, extra: tuple = ()):
    """`fuzz --mux` through the port's CLI (`cli.fuzz`) in this process,
    with K1's and K2's counts zeroed just before and read just after.
    Returns (node, wall to the card's last work, launches)."""
    import contextlib
    import io

    import torch

    from wtf_tpu_torch import cli
    from wtf_tpu_torch.interp import pstep
    from wtf_tpu_torch.telemetry import Registry

    a = cli.build_parser().parse_args(
        NODE + ["--lanes", str(lanes), "--device", device, "--address",
                addr, *extra])
    for key in pstep.LAUNCHES:
        pstep.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        node = cli.fuzz(a, Registry())
    if device == "cuda":
        torch.cuda.synchronize()
    return node, time.perf_counter() - t0, dict(pstep.LAUNCHES)


class LaneReads:
    """Counts and times the node's per-lane device reads: a lane's
    coverage words (the delta wire's `lane_cov_words`) and a crashing
    lane's bucket (`triage.bucket.bucket_of`)."""

    def __init__(self):
        self.n = {"cov": 0, "bucket": 0}
        self.s = {"cov": 0.0, "bucket": 0.0}

    def _timed(self, key, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.s[key] += time.perf_counter() - t0
                self.n[key] += 1
        return wrapped

    def __enter__(self):
        from wtf_tpu_torch.backend.gpu import GpuBackend
        from wtf_tpu_torch.triage import bucket

        self._saved = (GpuBackend.lane_cov_words, bucket.bucket_of)
        GpuBackend.lane_cov_words = self._timed("cov", self._saved[0])
        bucket.bucket_of = self._timed("bucket", self._saved[1])
        return self

    def __exit__(self, *exc):
        from wtf_tpu_torch.backend.gpu import GpuBackend
        from wtf_tpu_torch.triage import bucket

        GpuBackend.lane_cov_words, bucket.bucket_of = self._saved


def cli_lines(argv: list) -> tuple:
    """(rc, printed lines) of one port CLI command in this process."""
    import contextlib
    import io

    from wtf_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue().splitlines()


def phase_node(k1: dict, k2: dict, record: dict, work: Path) -> None:
    """Phase 27: the distributed main path.  A port `master --runs 16384`
    in a subprocess serves a 4096-lane `fuzz --mux --fused-step on` node
    on the card (this process); K1 must launch in the node's rounds, the
    node must serve every testcase the master counts, the crash files
    must be named by their digests, coverage.cov must hold the node's own
    aggregate coverage, the store must fsck clean and `status` must
    render the master's fleet view."""
    import torch

    from wtf_tpu_torch.utils.covfiles import parse_cov_files
    from wtf_tpu_torch.utils.hashing import hex_digest

    root = work / "phase27"
    addr, master = start_master(root, NODE_RUNS)
    torch.cuda.reset_peak_memory_stats()
    with LaneReads() as reads:
        node, wall, launches = run_node(addr, LANES, "cuda")
    peak = torch.cuda.max_memory_allocated()
    m = finish_master(root, master)
    backend, reg = node.backend, node.registry
    served = m["metrics"].get("campaign.testcases", 0)
    check(launches["fused_step"] > 0, f"phase 27: K1 never launched in the "
          f"node's rounds: {launches}")
    check(served == NODE_RUNS and node.runs == served,
          f"phase 27: the master counted {served} testcases, the node "
          f"served {node.runs}, the budget is {NODE_RUNS}")
    counts = backend.status_counts
    check(set(counts) <= TERMINAL and sum(counts.values()) == node.runs,
          f"phase 27: non-terminal lanes: {counts}")
    crashes = sorted((root / "t" / "crashes").iterdir())
    check(bool(crashes) and all(hex_digest(p.read_bytes()) == p.name
                                for p in crashes),
          "phase 27: a crash file not named by its digest")
    addresses = set(m["addresses"])
    check(parse_cov_files(root / "t") == addresses
          and f" cov: {len(addresses)} " in m["line"]
          and addresses == backend.aggregate_coverage(),
          f"phase 27: coverage.cov ({len(addresses)} addresses) is not the "
          f"master's count line {m['line']!r} or the node's aggregate "
          f"({len(backend.aggregate_coverage())})")
    rc, fsck = cli_lines(["fleet", "fsck", "--store", str(root / "store")])
    check(rc == 0, f"phase 27: the store does not fsck clean: {fsck}")
    rc, status = cli_lines(["status", str(root / "telem")])
    check(rc == 0 and status and status[0].startswith("fleet: 1 node(s)"),
          f"phase 27: status did not render the fleet: {status}")
    rounds = node.rounds
    spans = reg.spans
    node_spans = {p: spans.seconds(p) for p in NODE_SPANS}
    msp = m["metrics"].get("phase.seconds", {})
    delta = reg.counter("dist.cov_bytes_delta").value
    bitmap = reg.counter("dist.cov_bytes_bitmap").value
    print(f"phase 27: master (subprocess, {m['line']!r}) + a {LANES}-lane "
          f"`fuzz --mux --fused-step on` node on the card: {node.runs} "
          f"testcases in {wall:.2f} s = {served / wall:.1f} execs/s, "
          f"{rounds} rounds, K1 launches {launches['fused_step']} "
          f"({launches['fused_step'] / max(rounds, 1):.1f} per round), K2 "
          f"{launches['probe']}; node spans "
          f"{ {k: round(v, 3) for k, v in node_spans.items() if v} }; the "
          f"master's intake {msp.get('intake', 0.0):.3f} s "
          f"({msp.get('intake', 0.0) / max(rounds, 1) * 1e3:.1f} ms per "
          f"round), serve {msp.get('serve', 0.0):.3f} s; coverage bytes on "
          f"the wire {delta} against {bitmap} for whole sets "
          f"({bitmap / max(delta, 1):.1f}x smaller); per-lane reads "
          f"{reads.n['cov'] / max(rounds, 1):.1f} coverage rows "
          f"({reads.s['cov']:.3f} s in all) and "
          f"{reads.n['bucket'] / max(rounds, 1):.1f} crash buckets "
          f"({reads.s['bucket']:.3f} s) per round; "
          f"{len(crashes)} crash files by digest, coverage.cov == the "
          f"node's aggregate ({len(addresses)}), {fsck[-1]!r}, status "
          f"{status[0]!r}; device peak {peak}; statuses {counts}")
    k1["launches"] += launches["fused_step"]
    k1["launches_by_path"]["demo_tlv fuzz --mux node"] = \
        launches["fused_step"]
    k2["launches_by_path"]["demo_tlv fuzz --mux node"] = launches["probe"]
    record["node"] = {
        "testcases": served, "wall_s": wall, "execs_per_s": served / wall,
        "rounds": rounds, "k1_launches": launches["fused_step"],
        "k2_launches": launches["probe"], "node_spans": node_spans,
        "master_spans": msp, "master_line": m["line"],
        "cov_bytes_delta": delta, "cov_bytes_bitmap": bitmap,
        "lane_reads": {"n": reads.n, "s": reads.s}, "peak_bytes": peak,
        "statuses": counts, "crash_files": len(crashes),
        "coverage": len(addresses), "telem_sent":
            reg.counter("dist.telem_sent").value}
    del node, backend
    torch.cuda.empty_cache()


def node_twin(device: str, delta: bool) -> tuple:
    """A TWIN_LANES-lane mux node on `device` against a fresh master of
    TWIN_RUNS (phase 28), with the delta wire or `--no-cov-delta`.
    Returns (what must equal between card and CPU, seconds)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "twin"
        addr, master = start_master(root, TWIN_RUNS)
        node, _, _ = run_node(addr, TWIN_LANES, device,
                              () if delta else ("--no-cov-delta",))
        m = finish_master(root, master)
        out = (node.runs, m["line"], m["outputs"], m["crashes"],
               m["addresses"], m["cursors"])
    return out, time.perf_counter() - t0


def phase_node_card_vs_cpu(cpu) -> None:
    """Phase 28: the same seeded master serves a node on the card and one
    on the CPU (a worker process), each with a fresh master: equal count
    lines, outputs/, crashes/ and coverage.cov, on both wires."""
    card_s, cpu_s, seen = [], [], {}
    for delta in (True, False):
        got, seconds = node_twin("cuda", delta)
        want, cpu_seconds = cpu[f"node delta={delta}"].result()
        card_s.append(seconds)
        cpu_s.append(cpu_seconds)
        check(got == want, f"phase 28: the {TWIN_LANES}-lane node differs "
              f"between card and cpu (delta={delta}): {got[1]!r} vs "
              f"{want[1]!r}")
        check(got[0] == TWIN_RUNS and got[2] and (
            len(got[5]) == (1 if delta else 0)),
              f"phase 28: {got[0]} served, {len(got[5])} cursors")
        seen[delta] = got
    check(seen[True][1:5] == seen[False][1:5],
          "phase 28: the delta and whole-set wires disagree")
    print(f"phase 28: {TWIN_LANES}-lane mux node, master --runs "
          f"{TWIN_RUNS}: card == cpu on the count line "
          f"({seen[True][1]!r}), {len(seen[True][2])} outputs, "
          f"{len(seen[True][3])} crashes and coverage.cov's "
          f"{len(seen[True][4])} addresses and cursor, with the delta wire "
          f"and with --no-cov-delta (card {card_s[0]:.1f} + "
          f"{card_s[1]:.1f} s, cpu {cpu_s[0]:.1f} + {cpu_s[1]:.1f} s in "
          f"worker processes)")


def phase_node_chaos(k1: dict, record: dict, work: Path) -> None:
    """Phase 29: the 4096-lane mux node under a scripted socket reset
    against a master of 8192: the reset fires once, on the node's first
    reply, the node reconnects, the master reclaims the in-flight batch
    and counts every testcase once, and outputs/ stays content-addressed.

    A ChaosSocket counts operations (each sendall or recv call is one),
    and a large frame is read in as many recv calls as the socket hands
    out, so the plan first delays the node's read of the first work
    frame's header (op 3, after the hello and the two reads of the
    cursor frame) until the master has queued the whole frame; with
    testcases of at most CHAOS_MAX_LEN bytes a 4096-testcase frame fits
    one socket send buffer, the body comes in one read (op 4), and op 5
    is the first reply's send: the reset always lands with the batch in
    flight on the master."""
    import torch

    from wtf_tpu_torch.testing.faultinject import (
        DELAY, FaultPlan, RESET, chaos_dialing,
    )
    from wtf_tpu_torch.utils.hashing import hex_digest

    root = work / "phase29"
    addr, master = start_master(root, CHAOS_RUNS, CHAOS_MAX_LEN)
    plan = FaultPlan([{3: DELAY, 5: RESET}, {}, {}], delay_secs=2.0)
    with chaos_dialing(plan):
        node, wall, launches = run_node(addr, LANES, "cuda")
    m = finish_master(root, master)
    served = m["metrics"].get("campaign.testcases", 0)
    retries = node.registry.counter("dist.retries").value
    reclaimed = m["metrics"].get("dist.reclaimed", 0)
    check(plan.fired == [(DELAY, "recv"), (RESET, "send")],
          f"phase 29: fired {plan.fired}, not the delayed read and one "
          f"reset of the first reply")
    check(served == CHAOS_RUNS, f"phase 29: the master counted {served} "
          f"testcases of {CHAOS_RUNS}")
    check(retries >= 1 and reclaimed >= 1,
          f"phase 29: retries {retries}, reclaimed {reclaimed}")
    outputs = sorted((root / "t" / "outputs").iterdir())
    check(bool(outputs) and all(hex_digest(p.read_bytes()) == p.name
                                for p in outputs),
          "phase 29: outputs/ is not content-addressed")
    check(launches["fused_step"] > 0, "phase 29: K1 never launched")
    print(f"phase 29: the {LANES}-lane mux node under a scripted reset of "
          f"its first reply ({plan.fired}) against master --runs "
          f"{CHAOS_RUNS} --max_len {CHAOS_MAX_LEN}: "
          f"{m['line']!r}, zero lost; node retries {retries}, reclaimed "
          f"{reclaimed}, executed {node.runs} in {wall:.2f} s, {node.rounds} "
          f"rounds, K1 launches {launches['fused_step']}; {len(outputs)} "
          f"outputs content-addressed")
    record["node_chaos"] = {"fired": plan.fired, "testcases": served,
                            "executed": node.runs, "retries": retries,
                            "reclaimed": reclaimed, "wall_s": wall,
                            "k1_launches": launches["fused_step"]}
    del node
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3's stacked case and phases 30-32: demo_pe and the scheduler
# ---------------------------------------------------------------------------

def grid_tenant(variant: int):
    """(pages, cpu, [(code, base)]) of one tenant of phase 3's stacked
    image.  Every variant maps the grid's virtual addresses with other
    bytes behind them: 0 is phase 3's guest; 1 shifts its physical pages
    (a filler mapping first), fills its data pages and starts its code
    0x40 bytes in behind a NOP sled; 2 runs only at canonical-negative
    addresses, its code 0x10 bytes in, and holds int3s where the others
    hold code."""
    import random as _random

    from wtf_tpu_torch.snapshot.synthetic import SyntheticSnapshotBuilder

    b = SyntheticSnapshotBuilder()
    rng = _random.Random(variant)
    if variant == 1:
        b.map(0x0003_0000_0000, 0x3000)
    pad = {0: 0, 1: 0x40, 2: 0x10}[variant]
    fill = {0: b"", 1: b"\x90" * pad, 2: b"\xcc" * pad}[variant]
    if variant == 2:
        b.write(GRID_CODE_GVA, b"\xcc" * len(GRID_CODE))
    else:
        b.write(GRID_CODE_GVA, fill + GRID_CODE)
    b.write(GRID_KCODE_GVA, fill + GRID_CODE)
    if variant == 1:
        b.write(GRID_DATA_GVA, bytes(rng.getrandbits(8)
                                     for _ in range(0x4000)))
    else:
        b.map(GRID_DATA_GVA, 0x4000)
    b.map(GRID_KDATA_GVA, 0x2000)
    b.map(GRID_RO_GVA, 0x1000, writable=False)
    b.map(GRID_STACK_TOP - 0x8000, 0x9000)
    start = (GRID_KCODE_GVA if variant == 2 else GRID_CODE_GVA) + pad
    pages, cpu = b.build(rip=start, rsp=GRID_STACK_TOP - 0x1000)
    code = [(GRID_CODE, GRID_KCODE_GVA + pad)]
    if variant != 2:
        code.append((GRID_CODE, GRID_CODE_GVA + pad))
    return pages, cpu, code


def stacked_state(n_lanes: int, seed: int, dev):
    """(tab, image, machine, limit, tenant of each lane) of n_lanes random
    lanes over a stacked three-tenant image (grid_tenant 0, 1, 2), the
    lanes' tenants interleaved (lane % 3, not in blocks): each lane at a
    random instruction boundary of its own tenant's code, its data
    pointers in its own tenant's pages."""
    import dataclasses

    import numpy as np
    import torch

    from wtf_tpu_torch.core.results import StatusCode
    from wtf_tpu_torch.interp.runner import Runner
    from wtf_tpu_torch.snapshot.loader import Snapshot

    class Spec:
        def __init__(self, snapshot, lanes):
            self.snapshot, self.lanes = snapshot, lanes

    built = [grid_tenant(v) for v in range(3)]
    snaps = [Snapshot.from_pages(pages, cpu) for pages, cpu, _ in built]
    third = n_lanes // 3
    quotas = [third, third, n_lanes - 2 * third]
    r = Runner(snaps[0], n_lanes=n_lanes, overlay_slots=SLOTS, device=dev,
               tenants=[Spec(s, q) for s, q in zip(snaps, quotas)])
    # re-deal the block layout into an interleaved one: every plane of
    # lane l comes from the first lane of tenant l % 3's block
    tenant = np.arange(n_lanes, dtype=np.int32) % 3
    lo = np.cumsum([0] + quotas)[:-1]
    src = torch.from_numpy(lo[tenant]).to(dev)
    m = r.machine
    for f in dataclasses.fields(m):
        if f.name != "overlay":
            setattr(m, f.name, getattr(m, f.name)[src].clone())
    r.tenant_of_lane = tenant
    r.image = dataclasses.replace(
        r.image, tenant=torch.from_numpy(tenant).to(dev))
    view = r.view()
    rips = []
    for t, (_, _, code) in enumerate(built):
        rips.append([])
        for blob, base in code:
            off = 0
            while off < len(blob):
                rip = base + off
                rips[t].append(rip)
                r._decode_at(view, t, rip)
                off += r.cache.uop_at(rip, t).length
    r.cache.set_breakpoint(rips[0][3], tenant=0)
    r.cache.set_breakpoint(rips[1][3], tenant=1)
    g = torch.Generator(device=dev).manual_seed(seed)
    n = n_lanes
    t_of = torch.from_numpy(tenant).to(dev)

    def rint(lo_, hi, shape=(n,)):
        return torch.randint(lo_, hi, shape, generator=g, device=dev)

    def pick(values, shape=(n,)):
        v = torch.tensor([s64(x) for x in values], dtype=torch.int64,
                         device=dev)
        return v[rint(0, len(values), shape)]

    m.rip = torch.stack([pick(rips[t]) for t in range(3)])[t_of,
                                                           torch.arange(n)]
    m.gpr = rint(-2**63, 2**63 - 1, (n, 16))
    m.gpr[:, 1] = torch.where(rint(0, 2) == 1, rint(0, 4), m.gpr[:, 1])
    high = (t_of == 2) | ((t_of == 0) & (rint(0, 4) == 0))
    m.gpr[:, 3] = torch.where(high, s64(GRID_KDATA_GVA),
                              GRID_DATA_GVA) + rint(0, 0x1000)
    m.gpr[:, 4] = GRID_STACK_TOP - 0x1000 - 8 * rint(0, 64)
    m.gpr[:, 13] = torch.where(high, s64(GRID_KDATA_GVA + 0x40),
                               GRID_DATA_GVA + 0x40)
    m.gpr[:, 14] = torch.where(high, s64(GRID_KDATA_GVA + 0x80),
                               GRID_DATA_GVA + 0x80)
    m.rflags = (rint(0, 1 << 12) | 2) | (rint(0, 1 << 20) << 32)
    m.icount = rint(0, 1030)
    m.bp_skip = (rint(0, 3) == 0).to(torch.int32)
    m.status = torch.where(rint(0, 10) == 0, int(StatusCode.OK),
                           int(StatusCode.RUNNING)).int()
    m.ctr = rint(0, 1 << 20, (n, 6)).int()
    ov = m.overlay
    data_pfns = torch.tensor(
        [[view.translate(t, GRID_DATA_GVA + i * 0x1000) >> 12
          for i in range(4)] for t in range(3)], device=dev)
    count = torch.where(rint(0, 10) == 0, SLOTS, rint(0, 6))
    rows = torch.arange(SLOTS, device=dev)[None, :]
    pfns = data_pfns[t_of][torch.arange(n, device=dev)[:, None],
                           rint(0, 4, (n, SLOTS))]
    used = rows < count[:, None]
    ov.pfn.copy_(torch.where(used, pfns, -1).int())
    ov.count.copy_(count.int())
    ov.valid.copy_((rint(0, 2, tuple(ov.valid.shape)) *
                    used[..., None]).to(torch.uint8))
    ov.data.copy_(rint(-2**63, 2**63 - 1, tuple(ov.data.shape)))
    return r.cache.device(dev), r.image, m, 1000, tenant


def phase_random_stacked(dev, k1: dict, record: dict) -> None:
    """Phase 3's third set: K1 against its plain version on the stacked
    three-tenant image, tenants interleaved, 4096 lanes, k=32; then K1's
    time per dispatch there against phase 3's single-image set, in turns
    (single, stacked, stacked, single)."""
    import numpy as np
    import torch

    from wtf_tpu_torch.interp import pstep
    from wtf_tpu_torch.interp.machine import CTR_INSTR

    t0 = time.perf_counter()
    tab, img, m0, limit, tenant = stacked_state(LANES, 5, dev)
    mk, mp = m0.clone(), m0.clone()
    pstep.fused_step(tab, img, mk, limit, 32)
    torch.cuda.synchronize()
    pstep.fused_step_plain(tab, img, mp, limit, 32)
    torch.cuda.synchronize()
    bad, err = plane_diff(mk, mp)
    check(not bad, f"K1 differs from fused_step_plain in {bad} on the "
                   f"stacked three-tenant image (max abs err {err})")
    retired = (mk.ctr - m0.ctr)[:, CTR_INSTR].long().cpu().numpy()
    per_tenant = [int(retired[tenant == t].sum()) for t in range(3)]
    check(min(per_tenant) > 0,
          f"phase 3: a tenant of the stacked image retired nothing "
          f"in K1: {per_tenant}")
    counts = {int(k): int(v) for k, v in zip(*np.unique(
        mk.status.cpu().numpy(), return_counts=True))}
    states = {"stacked": (tab, img, m0, limit)}
    states["single"] = grid_state(LANES, 3, dev)
    work = {}
    ms = {"single": [], "stacked": []}
    for name in ("single", "stacked", "stacked", "single"):
        s_tab, s_img, s_m0, s_limit = states[name]

        def fresh():
            work["m"] = s_m0.clone()
        ms[name].append(cuda_ms(lambda: pstep.fused_step(
            s_tab, s_img, work["m"], s_limit, 32), 10, setup=fresh))
    record["stacked_k1_ms"] = ms
    print(f"phase 3: K1 == fused_step_plain on {LANES} lanes of a stacked "
          f"three-tenant image (tenants interleaved lane % 3; shared "
          f"virtual addresses, other pages and code behind them; tenant 2 "
          f"at canonical-negative addresses only), k=32, all planes "
          f"bit-identical: retired per tenant {per_tenant}, statuses "
          f"{counts}; K1 {[round(x, 4) for x in ms['stacked']]} ms per "
          f"dispatch there against {[round(x, 4) for x in ms['single']]} "
          f"on the single-image set (in turns, CUDA events) "
          f"({time.perf_counter() - t0:.1f} s)")
    k1["max_abs_err"] = max(k1["max_abs_err"] or 0, err)


def span_totals(registry) -> dict:
    """{span path: seconds} of every span a registry recorded."""
    from wtf_tpu_torch.telemetry.spans import SECONDS

    return {path: c.value
            for path, c in registry.counter(SECONDS).children.items()}


def pe_available() -> bool:
    from wtf_tpu_torch.harness import demo_pe

    return demo_pe.available()


def count_precise_steps():
    """Wrap the precise step so each call is counted, and apart those
    that computed an FP group (sse, ssefp, x87).  Returns (counts dict,
    undo)."""
    from wtf_tpu_torch.interp import step as step_mod

    counts = {"steps": 0, "fp_steps": 0}
    original = step_mod.step

    def counted(tab, image, m, limit, pre=None,
                groups=step_mod.ALL_GROUPS):
        counts["steps"] += 1
        if groups & FP_GROUPS:
            counts["fp_steps"] += 1
        return original(tab, image, m, limit, pre, groups)

    step_mod.step = counted

    def undo():
        step_mod.step = original
    return counts, undo


def phase_pe_campaign(k1: dict, k2: dict, record: dict, work: Path) -> None:
    """Phase 30: the 4096-lane demo_pe campaign (compiler-made code)."""
    import torch

    from wtf_tpu_torch import cli
    from wtf_tpu_torch.interp import pstep

    if not pe_available():
        print("phase 30: skipped: demo_pe's DLL (gle64.vc14.dll of "
              "PyOpenGL's wheel) is not on this machine; --pe-dll names "
              "a copy")
        record["pe_campaign"] = {"skipped": True}
        return
    root = work / "pe"
    (root / "inputs").mkdir(parents=True)
    (root / "inputs" / "benign").write_bytes(PE_BENIGN)
    a = cli.build_parser().parse_args(
        PCAMPAIGN + ["--target", str(root)])
    counts, undo = count_precise_steps()
    torch.cuda.reset_peak_memory_stats()
    for name in pstep.LAUNCHES:
        pstep.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    try:
        loop = cli.campaign(a)
        torch.cuda.synchronize()
    finally:
        undo()
    wall = time.perf_counter() - t0
    launches = dict(pstep.LAUNCHES)
    backend = loop.backend
    reg = backend.registry
    status = backend.status_counts
    check(launches["fused_step"] > 0, f"phase 30: K1 never launched")
    check(set(status) <= TERMINAL
          and sum(status.values()) == loop.stats.testcases == PE_RUNS,
          f"phase 30: non-terminal lanes: {status}")
    totals = span_totals(reg)
    legs = totals.get("execute/device-step", 0.0)
    by_class = dict(backend.runner.stats["fallbacks_by_opclass"])
    instr = reg.counter("device.instructions").value
    fused = reg.counter("device.fused_steps").value
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 30: demo_pe campaign {loop.stats.testcases} testcases in "
          f"{wall:.2f} s = {loop.stats.testcases / wall:.1f} execs/s; K1 "
          f"launches {launches['fused_step']}, K2 {launches['probe']}; "
          f"precise steps {counts['steps']} (FP groups in "
          f"{counts['fp_steps']}, {counts['fp_steps'] / max(counts['steps'], 1):.3f}); "
          f"resume legs {legs:.2f} s = {legs / wall:.3f} of the wall; "
          f"fused occupancy {fused / max(instr, 1):.4f} ({fused}/{instr}); "
          f"fallbacks {backend.runner.stats['fallbacks']} {by_class}; "
          f"statuses {status} (TIMEDOUT {status.get('TIMEDOUT', 0)}); "
          f"crashes {loop.stats.crashes}, corpus {len(loop.corpus)}; "
          f"device peak {peak}")
    k1["launches_by_path"]["demo_pe"] = launches["fused_step"]
    k2["launches_by_path"]["demo_pe"] = launches["probe"]
    record["pe_campaign"] = {
        "testcases": loop.stats.testcases, "wall_s": wall,
        "execs_per_s": loop.stats.testcases / wall,
        "k1_launches": launches["fused_step"],
        "k2_launches": launches["probe"], "precise_steps": counts,
        "legs_s": legs, "legs_share": legs / wall,
        "occupancy": fused / max(instr, 1), "fallbacks_by_opclass":
        by_class, "statuses": status, "device_peak": peak,
        "spans": {k: round(v, 3) for k, v in totals.items()}}


def write_jobs(root: Path, jobs) -> Path:
    """A jobs.json for `jobs` ((name, target, mutator, lanes, runs,
    priority) rows), each job's inputs/ holding its target's seed."""
    rows = []
    for name, target, mutator, lanes, runs, priority in jobs:
        inputs = root / "inputs" / name
        inputs.mkdir(parents=True)
        (inputs / "seed").write_bytes(SCHED_SEEDS[target])
        rows.append({"name": name, "target": target, "lanes": lanes,
                     "runs": runs, "priority": priority, "seed": 5,
                     "mutator": mutator, "inputs": str(inputs),
                     "max_len": 1024 if target == "demo_pe" else 96})
    path = root / "jobs.json"
    path.write_text(json.dumps({"jobs": rows}))
    return path


def sched_jobs(scale: int = 1, runs: dict = None) -> list:
    """The phase-31 jobs table, lane quotas divided by `scale` and runs
    replaced from `runs`.  Where demo_pe's DLL is missing carol's row is
    left out and dave takes her lanes (runs in proportion) and her
    priority, so the quotas still oversubscribe the batch and dave, at
    bob's priority, rotates with bob: a preemption and a resume."""
    rows = [list(row) for row in SCHED_JOBS]
    if not pe_available():
        carol = next(r for r in rows if r[1] == "demo_pe")
        dave = next(r for r in rows if r[0] == "dave")
        dave[4] = dave[4] * (dave[3] + carol[3]) // dave[3]
        dave[3] += carol[3]
        dave[5] = carol[5]
        rows.remove(carol)
    return [(name, target, mutator, lanes // scale,
             (runs or {}).get(name, n_runs), priority)
            for name, target, mutator, lanes, n_runs, priority in rows]


def run_sched(root: Path, jobs, lanes: int, limit: int, device: str,
              quantum: int, extra: tuple = ()) -> tuple:
    """`sched` through cli.sched over a fresh `root`: (summary, registry,
    wall seconds, the workdir, the store root, K1/K2 launches per round
    [(placed names, k1, k2)])."""
    from wtf_tpu_torch import cli
    from wtf_tpu_torch.interp import pstep
    from wtf_tpu_torch.tenancy.sched import Scheduler
    from wtf_tpu_torch.telemetry import Registry, open_event_log

    path = write_jobs(root, jobs)
    a = cli.build_parser().parse_args(
        ["sched", "--jobs", str(path), "--workdir", str(root / "work"),
         "--lanes", str(lanes), "--limit", str(limit), "--quantum",
         str(quantum), "--fused-step", "on", "--device", device,
         "--store", str(root / "store"), "--telemetry-dir",
         str(root / "tele"), *extra])
    rounds = []
    original = Scheduler._run_round

    def counted(self, placed):
        before = dict(pstep.LAUNCHES)
        original(self, placed)
        rounds.append((tuple(j.name for j in placed),
                       pstep.LAUNCHES["fused_step"] - before["fused_step"],
                       pstep.LAUNCHES["probe"] - before["probe"]))

    registry = Registry()
    events = open_event_log(root / "tele")
    Scheduler._run_round = counted
    t0 = time.perf_counter()
    try:
        _sched, summary = cli.sched(a, registry, events)
    finally:
        Scheduler._run_round = original
    wall = time.perf_counter() - t0
    events.emit("run-end", metrics=registry.dump())
    events.close()
    return summary, registry, wall, root / "work", root / "store", rounds


def sched_outcome(work: Path, summary: dict) -> dict:
    """Per job what must equal between two runs of one jobs table: the
    summary, the final checkpoint (wall-clock counters dropped) and the
    crash file names."""
    from wtf_tpu_torch.resume.checkpoint import load_campaign

    out = {}
    for job, s in summary.items():
        state, _ = load_campaign(work / job / "checkpoint")
        state["stats"] = {k: v for k, v in state["stats"].items()
                          if not k.endswith(".lane_ms")}
        crashes = work / job / "crashes"
        out[job] = (s, json.dumps(state, sort_keys=True, default=str),
                    sorted(p.name for p in crashes.iterdir())
                    if crashes.is_dir() else [])
    return out


def phase_sched(k1: dict, k2: dict, record: dict, work: Path) -> None:
    """Phase 31: `sched` over 4096 lanes, four jobs whose quotas
    oversubscribe the batch."""
    import torch

    from wtf_tpu_torch.fleet.store import FleetStore
    from wtf_tpu_torch.interp import pstep

    jobs = sched_jobs()
    torch.cuda.reset_peak_memory_stats()
    for name in pstep.LAUNCHES:
        pstep.LAUNCHES[name] = 0
    summary, reg, wall, wdir, store, rounds = run_sched(
        work / "sched", jobs, LANES, SCHED_LIMIT, "cuda", 2)
    launches = dict(pstep.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    testcases = sum(s["testcases"] for s in summary.values())
    for name, _t, _m, _l, runs, _p in jobs:
        s = summary[name]
        check(s["done"] and s["testcases"] >= runs,
              f"phase 31: job {name} did not finish its runs: {s}")
        report = FleetStore(store, namespace=f"tenant-{name}").verify()
        check(not (report["torn"] or report["missing"]
                   or report["orphans"]),
              f"phase 31: {name}'s store namespace fails fsck: {report}")
    builds = reg.counter("sched.builds").value
    preempt = reg.counter("sched.preemptions").value
    resumes = sum(reg.counter(f"tenant.{j[0]}.resumes").value for j in jobs)
    check(preempt >= 1 and resumes >= 1,
          f"phase 31: preemptions {preempt}, resumes {resumes}")
    check(all(k1_n > 0 for _, k1_n, _ in rounds),
          f"phase 31: a round launched no K1: {rounds}")
    check(launches["probe"] == builds,
          f"phase 31: K2 launched {launches['probe']} times for {builds} "
          f"placement builds")
    batches = sum(s["batches"] for s in summary.values())
    totals = span_totals(reg)
    legs = totals.get("execute/device-step", 0.0)
    place = totals.get("sched-place", 0.0)
    ckpt = totals.get("checkpoint", 0.0)
    rows = {name: (s["testcases"], s["crashes"], s["preemptions"])
            for name, s in summary.items()}
    print(f"phase 31: sched over {LANES} lanes, {len(jobs)} jobs "
          f"({', '.join(f'{j[0]}={j[3]}' for j in jobs)} lanes), quantum 2: "
          f"{testcases} testcases in {wall:.2f} s = {testcases / wall:.1f} "
          f"execs/s; per job (testcases, crashes, preemptions) {rows}; "
          f"{len(rounds)} rounds, {builds} placement builds "
          f"(sched-place {place:.2f} s), {preempt} preemptions, {resumes} "
          f"resumes; K1 {launches['fused_step']} launches "
          f"({launches['fused_step'] / max(len(rounds), 1):.1f} per round, "
          f"in every round: {[r[1] for r in rounds]}), K2 "
          f"{launches['probe']}; checkpoints {ckpt:.2f} s; resume legs "
          f"{legs:.2f} s = {legs / wall:.3f} of the wall; every job done, "
          f"store fsck clean; device peak {peak}")
    # the slice's main path: its launches join the JSON's count
    k1["launches"] += launches["fused_step"]
    k2["launches"] += launches["probe"]
    k1["launches_by_path"]["sched"] = launches["fused_step"]
    k2["launches_by_path"]["sched"] = launches["probe"]
    record["sched"] = {
        "jobs": jobs, "summary": summary, "wall_s": wall,
        "execs_per_s": testcases / wall, "rounds": rounds,
        "builds": builds, "preemptions": preempt, "resumes": resumes,
        "k1_launches": launches["fused_step"],
        "k2_launches": launches["probe"], "batches": batches,
        "sched_place_s": place, "checkpoint_s": ckpt, "legs_s": legs,
        "device_peak": peak,
        "spans": {k: round(v, 3) for k, v in totals.items()}}


# The twins force the oracle burst's any-instruction tier on (the card's
# default; the CPU's is off): a burst publishes only the decodes it steps
# through, where the device's decode service also prefetches, so the
# decode cache's entries (and with them checkpoints and bitmaps, which
# index coverage by entry) differ between the tiers, though corpus,
# crashes and covered rips do not.
TWIN_TIER = ("--burst-any-tier", "on")


def sched_twin(device: str) -> tuple:
    """Phase 32(a): the jobs table at 64 lanes (quotas / 64), small runs,
    quantum 1, limit 20,000 on `device` -> (sched_outcome, seconds)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        summary, *_rest = run_sched(Path(tmp) / "twin",
                                    sched_jobs(64, TWIN_SCHED_RUNS),
                                    TWIN_LANES, TWIN_LIMIT, device, 1,
                                    TWIN_TIER)
        out = sched_outcome(_rest[2], summary)
    return out, time.perf_counter() - t0


def tenancy_fingerprint(cfg, device: str, batches: int = 2) -> dict:
    """Phase 32(b): each tenant's fingerprint (its local coverage plane,
    edge bytes, corpus, crash buckets, decoded rips) after `batches`
    batches of the tenant table `cfg` ((name, target, mutator, lanes)
    rows), each seeded with its target's seed."""
    from wtf_tpu_torch.harness.targets import Targets, load_builtin_targets
    from wtf_tpu_torch.tenancy import (
        MultiTenantLoop, TenantRuntime, TenantSpec, create_tenancy_backend,
    )
    from wtf_tpu_torch.tenancy.state import extract_bits

    load_builtin_targets()
    targets = Targets.instance()
    specs = [TenantSpec(n, targets.get(t), targets.get(t).snapshot(), q)
             for n, t, _m, q in cfg]
    backend = create_tenancy_backend(specs, sum(row[3] for row in cfg),
                                     limit=TWIN_LIMIT, device=device,
                                     fused_step="on")
    backend.initialize()
    for i, s in enumerate(specs):
        with backend.tenant_context(i):
            s.target.init(backend)
    runtimes, lane_lo = [], 0
    for spec, (_n, target, mutator, _q) in zip(specs, cfg):
        rt = TenantRuntime(spec, seed=5, runs=1 << 20, mutator_name=mutator,
                           max_len=1024 if target == "demo_pe" else 96,
                           lane_lo=lane_lo)
        rt.corpus.add(SCHED_SEEDS[target])
        runtimes.append(rt)
        lane_lo += spec.lanes
    loop = MultiTenantLoop(backend, runtimes, stats_every=1e9)
    for _ in range(batches):
        loop.run_one_batch()
    out = {}
    for i, rt in enumerate(runtimes):
        cov, edge = backend.tenant_coverage_state(i)
        entries = backend.runner.cache.tenant_entries(i)
        out[rt.name] = (extract_bits(cov, [e[0] for e in entries]).tobytes(),
                        edge.tobytes(), list(rt.corpus),
                        sorted(rt.crash_buckets),
                        sorted(e[1] for e in entries))
    return out


def pe_twin(device: str) -> tuple:
    """Phase 32(c): a TWIN_PE_LANES-lane demo_pe campaign of
    TWIN_PE_RUNS runs at limit 20,000 on `device`, the fused step on
    (as on the card: the engine decides when each lane meets a decode
    miss, so the decode cache's entry order and with it the coverage
    bitmap's layout) -> ((outcome), seconds)."""
    from wtf_tpu_torch import cli

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "target"
        (root / "inputs").mkdir(parents=True)
        (root / "inputs" / "seed").write_bytes(SCHED_SEEDS["demo_pe"])
        a = cli.build_parser().parse_args(
            ["campaign", "--name", "demo_pe", "--lanes", str(TWIN_PE_LANES),
             "--runs", str(TWIN_PE_RUNS), "--limit", str(TWIN_LIMIT),
             "--seed", "5", "--device", device, "--fused-step", "on",
             *TWIN_TIER, "--target", str(root)])
        loop = cli.campaign(a)
        return outcome(loop), time.perf_counter() - t0


def phase_tenancy_card_vs_cpu(cpu) -> None:
    """Phase 32: the sched twins card == cpu, the three-tenant mix ==
    its solo runs on the card, demo_pe card == cpu."""
    got, card_s = sched_twin("cuda")
    want, cpu_s = cpu["sched"].result()
    bad = {job: [i for i, (a, b) in enumerate(zip(got.get(job, ()), w))
                 if a != b]
           for job, w in want.items() if got.get(job) != w}
    check(not bad and set(got) == set(want),
          f"phase 32: sched twins differ between card and cpu: {bad} "
          f"(job: differing fields of (summary, checkpoint, crashes))")
    ran = ", ".join(f"{k}={v[0]['testcases']}" for k, v in got.items())
    print(f"phase 32: {TWIN_LANES}-lane sched twin ({ran} testcases), "
          f"quantum 1: card == cpu on every job's summary, "
          f"final checkpoint and crash names (card {card_s:.1f} s, cpu "
          f"{cpu_s:.1f} s in a worker process)")
    cfg = [("alice", "demo_tlv", "tlv", 4), ("bob", "demo_kernel", "mangle",
                                             4)]
    if pe_available():
        cfg.append(("carol", "demo_pe", "auto", 4))
    t0 = time.perf_counter()
    mixed = tenancy_fingerprint(cfg, "cuda")
    for row in cfg:
        solo = tenancy_fingerprint([row], "cuda")
        check(solo[row[0]] == mixed[row[0]],
              f"phase 32: {row[0]} differs between its solo run and the "
              f"{len(cfg)}-tenant mix on the card")
        check(mixed[row[0]][4], f"phase 32: {row[0]} decoded nothing")
    print(f"phase 32: {len(cfg)}-tenant mix (4 lanes each, 2 batches) == "
          f"each tenant's solo run on the card: local coverage, edge "
          f"bytes, corpus, buckets and rips ("
          f"{time.perf_counter() - t0:.1f} s)")
    if not pe_available():
        print("phase 32: demo_pe twin skipped (no DLL)")
        return
    got, card_s = pe_twin("cuda")
    want, cpu_s = cpu["pe"].result()
    check(got == want, "phase 32: the demo_pe twin differs between card "
                       "and cpu")
    print(f"phase 32: {TWIN_PE_LANES}-lane x {TWIN_PE_RUNS}-run demo_pe "
          f"campaign card == cpu: {len(got[0])} corpus, crashes {got[1]} "
          f"(card {card_s:.1f} s, cpu {cpu_s:.1f} s in a worker process)")


def start_cpu_references(pool, keep: Path, vbreak_input: bytes) -> dict:
    """The CPU sides of phases 6, 9, 11, 14, 17, 20, 21-23, 24-26, 28 and
    32, started together in worker processes once the card's timed phases
    are done."""
    import os

    # the node twins first: each also waits on a master subprocess, and
    # they are the longest of the jobs
    jobs = {"sched": (sched_twin, "cpu"),
            "node delta=True": (node_twin, "cpu", True),
            "node delta=False": (node_twin, "cpu", False),
            "demo_tlv": (small_campaign, "demo_tlv", "cpu"),
            "demo_tlv window": (small_campaign, "demo_tlv", "cpu", 20000,
                                tuple(WINDOW)),
            "demo_tlv window dd": (small_campaign, "demo_tlv", "cpu", 20000,
                                   tuple(WINDOW) + ("--device-decode",)),
            "demo_kernel": (small_campaign, "demo_kernel", "cpu", 100000),
            "demo_usermode": (small_campaign, "demo_usermode", "cpu",
                              100000),
            "run demo_kernel": (replay_runs, "demo_kernel", KERNEL_RUNS,
                                "cpu"),
            "run demo_usermode": (replay_runs, "demo_usermode", USER_RUNS,
                                  "cpu"),
            "demo_spin": (small_campaign, "demo_spin", "cpu",
                          SPIN_SMALL_LIMIT, (), True),
            "fp loop": (fp_loop_cpu,),
            "fault tolerance": (small_tier, "cpu"),
            "triage corpus": (triage_twin, "cpu", "corpus", keep,
                              vbreak_input),
            "triage crasher": (triage_twin, "cpu", "crasher", keep,
                               vbreak_input)}
    if pe_available():
        jobs = {"pe": (pe_twin, "cpu"), **jobs}
    for name in NEW_TARGETS:
        jobs[name] = (small_campaign, name, "cpu", 100000, (), True)
    threads = max(1, (os.cpu_count() or 1) // len(jobs))
    return {key: pool.submit(cpu_job, job[0], threads, *job[1:])
            for key, job in jobs.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the kernels' record and the nvcc "
                         "logs into this directory")
    ap.add_argument("--pe-dll", type=Path, default=None,
                    help="a copy of demo_pe's DLL (gle64.vc14.dll) for a "
                         "machine whose Python has no PyOpenGL wheel; "
                         "without it phases 30 and 32's demo_pe parts "
                         "skip there")
    args = ap.parse_args(argv)
    if args.pe_dll is not None:
        # read by wtf_tpu_torch/harness/demo_pe.py at import, here and in
        # the worker processes (spawned with this environment)
        os.environ["WTF_PE_DLL"] = str(args.pe_dll.resolve())

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    record = {}
    k1 = kernel_record("fused_step", "wtf_tpu_torch/csrc/fused_step.cu",
                       "wtf_tpu/interp/pstep.py:742")
    k2 = kernel_record("probe", "wtf_tpu_torch/csrc/probe.cu",
                       "wtf_tpu/interp/pstep.py:144")
    elapsed = {}
    t_start = time.perf_counter()

    def stamp(name: str) -> None:
        elapsed[name] = round(time.perf_counter() - t_start, 1)

    card = phase_build(record)
    phase_probe(dev, k1, k2)
    phase_random(dev, k1)
    phase_random_stacked(dev, k1, record)
    phase_run()
    stamp("1-4")
    phase_campaign(k1, k2, record)
    stamp("5")
    phase_step_sys(dev, record)
    stamp("7")
    kernel_out = phase_kernel_campaign(k1, k2, record)
    stamp("8")
    window_out = phase_window_campaign(k1, k2, record)
    stamp("10")
    phase_decode(dev, record)
    phase_dd_window_campaign(k1, k2, record, window_out)
    stamp("12-13")
    phase_dump(k1, k2, record, kernel_out)
    stamp("15")
    phase_targets(k1, k2, record)
    stamp("16")
    phase_spin(k1, k2, record)
    stamp("18")
    phase_step_fp(dev, record)
    fp_card = phase_fp_loop(k1, k2, record)
    stamp("19-20")
    work = tempfile.TemporaryDirectory()
    keep = Path(work.name) / "phase21"
    keep.mkdir()
    supervised = phase_supervised(k1, k2, record, window_out, keep)
    phase_faults(k1, k2, record, window_out)
    phase_kill_resume(record, supervised)
    stamp("21-23")
    vbreak_input = phase_triage(k1, k2, record, keep,
                                Path(work.name) / "triage")
    stamp("24-26")
    phase_node(k1, k2, record, Path(work.name))
    phase_node_chaos(k1, record, Path(work.name))
    stamp("27-29")
    phase_pe_campaign(k1, k2, record, Path(work.name))
    stamp("30")
    phase_sched(k1, k2, record, Path(work.name))
    stamp("31")
    # the CPU references of phases 6, 9, 11, 14, 17, 20, 21-23, 24-26, 28
    # and 32 run in worker processes, after every timed phase, while this
    # process runs their card sides
    with ProcessPoolExecutor(
            max_workers=14, mp_context=multiprocessing.get_context(
                "spawn")) as pool:
        cpu = start_cpu_references(pool, keep, vbreak_input)
        phase_card_vs_cpu(cpu)
        phase_targets_card_vs_cpu(cpu)
        card_window = phase_window_card_vs_cpu(cpu)
        phase_dd_card_vs_cpu(cpu, card_window)
        phase_new_targets_card_vs_cpu(cpu)
        phase_fp_loop_card_vs_cpu(cpu, fp_card)
        phase_tier_card_vs_cpu(cpu, card_window)
        phase_triage_card_vs_cpu(cpu, keep, vbreak_input)
        phase_node_card_vs_cpu(cpu)
        phase_tenancy_card_vs_cpu(cpu)
    work.cleanup()
    stamp("twins")
    record["elapsed_s"] = elapsed
    print(f"chip_smoke: every phase passed in {elapsed['twins']:.1f} s "
          f"(seconds from the start at the end of each group: {elapsed})")

    kernels = {"kernels": [k1, k2]}
    if args.out is not None:
        from wtf_tpu_torch.csrc import build

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
