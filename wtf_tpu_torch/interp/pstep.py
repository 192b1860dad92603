"""The fused step: up to K hot instructions per lane in one kernel launch.

The counterpart of wtf_tpu/interp/pstep.py.  On a CUDA tensor
`fused_step` launches the hand-written Hopper kernel
`csrc/fused_step.cu` (the port of the JAX package's Pallas kernel
`_build_kernel`, launched there by `fused_call_impl`); on a CPU tensor it
runs `fused_step_plain`, the same function written in PyTorch.  Per lane
and per step both do, in order: the decode-cache probe, the breakpoint /
bp_skip gate, the hot-opclass test, the SMC byte compare through the
overlay, the effective address, the page walks through the lane overlay,
the operand loads, the MOV/LEA/ALU/UNARY/SHIFT/MUL/SETCC/CMOVCC/JCC/JMP/
PUSH/POP/CALL/RET execute, the store into the overlay, and the icount /
limit, coverage, edge and counter bookkeeping.

A lane whose next instruction the kernel does not run PARKS before any
state changes (status NEEDS_XLA): a non-hot opclass, an armed breakpoint
or SMC-risk code counts in CTR_PARK_SUBSET; a failing or unwritable walk,
an out-of-range store frame or a full overlay counts in CTR_PARK_MEM.
`fused_resume` then runs the precise step (interp/step.py) for exactly
those lanes, so every instruction retires through one of the two engines
and the result equals the precise step alone.

The 13 state planes (gpr, rip, rflags, status, icount, bp_skip, ctr, cov,
edge and the overlay's pfn/data/valid/count) are updated in place on the
tensors the machine holds, by the kernel and by the plain version alike.
"""

from __future__ import annotations

import ctypes

import torch

from wtf_tpu_torch.core.results import StatusCode
from wtf_tpu_torch.csrc.build import KernelArgumentError, KernelError
from wtf_tpu_torch.cpu import uops as U
from wtf_tpu_torch.interp import ints as I
from wtf_tpu_torch.interp import step as S
from wtf_tpu_torch.interp.machine import (
    CTR_DECODE_MISS, CTR_FUSED, CTR_INSTR, CTR_PARK_MEM, CTR_PARK_SUBSET,
    Machine,
)
from wtf_tpu_torch.interp.uoptable import UopTable
from wtf_tpu_torch.mem.overlay import (
    PFN_OOB, extract_pair, load_windows3, lookup, read_words, split_gpa,
)
from wtf_tpu_torch.mem.paging import translate
from wtf_tpu_torch.mem.physmem import PAGE_WORDS, MemImage, frame_slot, \
    lane_image

# the opclasses the kernel runs (the JAX package's FUSED_OPCLASSES)
FUSED_OPCLASSES = S.HOT_OPCLASSES

_RUNNING = int(StatusCode.RUNNING)
_NEED_DECODE = int(StatusCode.NEED_DECODE)
_NEEDS_XLA = int(StatusCode.NEEDS_XLA)
_TIMEDOUT = int(StatusCode.TIMEDOUT)

# Launches of each hand-written kernel, counted by its wrapper where it
# launches (chip_smoke.py zeroes these before driving the main path)
LAUNCHES = {"fused_step": 0, "probe": 0}

# the fused kernel runs one warp per lane, WARPS lanes per block
WARP = 32
WARPS = 4
# dynamic shared memory one block may use on Hopper (227 KB)
MAX_SHARED = 232448


# ---------------------------------------------------------------------------
# availability probe (K2)
# ---------------------------------------------------------------------------

def probe_kernel(x: torch.Tensor) -> torch.Tensor:
    """o[0] = i[0] + 1 (the JAX package's availability probe,
    `fused_available`'s inner kernel): the CUDA kernel csrc/probe.cu on a
    CUDA tensor, the plain version on a CPU one.  x: int32[1]."""
    if x.device.type == "cpu":
        return x + 1
    if x.dtype != torch.int32 or x.numel() != 1 or not x.is_contiguous() \
            or x.device.type != "cuda":
        raise KernelArgumentError("probe_kernel takes one contiguous int32 "
                                  "element on a CUDA device")
    from wtf_tpu_torch.csrc.build import library

    lib = library("probe")
    out = torch.empty_like(x)
    err = lib.wtf_probe(ctypes.c_void_p(x.data_ptr()),
                        ctypes.c_void_p(out.data_ptr()),
                        ctypes.c_void_p(torch.cuda.current_stream(
                            x.device).cuda_stream))
    LAUNCHES["probe"] += 1
    if err:
        raise KernelError(f"probe kernel launch failed: cuda error {err}")
    return out


def fused_available(device="cuda"):
    """(ok, reason): whether the fused step can run on `device`.  On a CUDA
    device both kernels must build from the repo's sources and the probe
    kernel must return 1 (one launch per call; the libraries are built
    once per process).  A CPU device runs the plain versions."""
    if torch.device(device).type == "cpu":
        return True, "cpu: the plain PyTorch versions run"
    try:
        from wtf_tpu_torch.csrc.build import library

        library("fused_step")
        x = torch.zeros(1, dtype=torch.int32, device=device)
        got = int(probe_kernel(x).item())
    except Exception as e:  # noqa: BLE001 - the reason is reported
        return False, f"{type(e).__name__}: {e}"
    return got == 1, "ok" if got == 1 else f"probe returned {got}"


# ---------------------------------------------------------------------------
# the fused step
# ---------------------------------------------------------------------------

def launch_geometry(n_lanes: int, slots: int) -> tuple:
    """(grid, block, dynamic shared bytes) of a fused-kernel launch over
    n_lanes lanes of `slots` overlay rows: one warp per lane, WARPS warps
    per block (the last block's spare warps return at once), and in
    shared memory each warp's copy of its lane's row index, padded to
    whole rounds of 32 rows (the lookup masks the rows past `slots`)."""
    if n_lanes < 0 or slots < 1:
        raise KernelArgumentError(f"fused_step: {n_lanes} lanes of {slots} "
                                  f"overlay rows")
    rounds = -(-slots // WARP)
    shared = WARPS * rounds * WARP * 4
    if shared > MAX_SHARED:
        raise KernelArgumentError(
            f"fused_step: {slots} overlay rows need {shared} bytes of "
            f"shared memory per block, over the card's {MAX_SHARED}")
    return -(-n_lanes // WARPS), WARPS * WARP, shared


def occupancy(n_lanes: int, slots: int) -> int:
    """Warps of the fused kernel one SM holds at once at the geometry of
    launch_geometry(n_lanes, slots), from the CUDA occupancy calculator
    (needs the card and the built library)."""
    from wtf_tpu_torch.csrc.build import library

    _, block, shared = launch_geometry(n_lanes, slots)
    blocks = ctypes.c_int(0)
    err = library("fused_step").wtf_fused_occupancy(block, shared,
                                                    ctypes.byref(blocks))
    if err:
        raise KernelError(f"fused_step occupancy query failed: cuda error "
                          f"{err}")
    return blocks.value * block // WARP


def fused_step(tab: UopTable, image: MemImage, m: Machine, limit: int,
               k_steps: int) -> None:
    """Up to k_steps hot instructions per lane, in place.  CUDA tensors
    launch the kernel; CPU tensors run the plain version.  Every input
    must lie on the machine's device."""
    image = lane_image(image, m.n_lanes)
    for name, t in (("hash_tab", tab.hash_tab), ("meta_i32", tab.meta_i32),
                    ("meta_u64", tab.meta_u64), ("pages", image.pages),
                    ("frame_table", image.frame_table),
                    ("tenant", image.tenant)):
        if t.device != m.device:
            raise KernelArgumentError(f"fused_step: {name} is on "
                                      f"{t.device}, the machine on "
                                      f"{m.device}")
    if m.device.type == "cuda":
        _launch(tab, image, m, limit, k_steps)
    elif m.device.type == "cpu":
        fused_step_plain(tab, image, m, limit, k_steps)
    else:
        raise KernelArgumentError(f"no fused step for device {m.device}")


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.device != device:
        raise KernelArgumentError(
            f"fused_step: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)} on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def _launch(tab: UopTable, image: MemImage, m: Machine, limit: int,
            k_steps: int) -> None:
    from wtf_tpu_torch.csrc.build import library

    n = m.n_lanes
    image = lane_image(image, n)
    dev = m.device
    ov = m.overlay
    slots = ov.pfn.shape[1]
    cap = tab.meta_i32.shape[0]
    i64, i32 = torch.int64, torch.int32
    checks = [
        ("hash_tab", tab.hash_tab, i32, (tab.hash_tab.shape[0], 3)),
        ("meta_i32", tab.meta_i32, i32, tuple(tab.meta_i32.shape)),
        ("meta_u64", tab.meta_u64, i64, (cap, 4)),
        ("pages", image.pages, i64, (image.pages.shape[0], PAGE_WORDS)),
        ("frame_table", image.frame_table, i32,
         tuple(image.frame_table.shape)),
        ("tenant", image.tenant, i32, (n,)),
        ("cr3", m.cr3, i64, (n,)), ("fs_base", m.fs_base, i64, (n,)),
        ("gs_base", m.gs_base, i64, (n,)),
        ("gpr", m.gpr, i64, (n, 16)), ("rip", m.rip, i64, (n,)),
        ("rflags", m.rflags, i64, (n,)), ("status", m.status, i32, (n,)),
        ("icount", m.icount, i64, (n,)), ("bp_skip", m.bp_skip, i32, (n,)),
        ("ctr", m.ctr, i32, (n, 6)),
        ("cov", m.cov, i32, (n, m.cov.shape[1])),
        ("edge", m.edge, i32, (n, m.edge.shape[1])),
        ("overlay.pfn", ov.pfn, i32, (n, slots)),
        ("overlay.data", ov.data, i64, (n, slots, PAGE_WORDS)),
        ("overlay.valid", ov.valid, torch.uint8, (n, slots, PAGE_WORDS)),
        ("overlay.count", ov.count, i32, (n,)),
    ]
    for name, t, dtype, shape in checks:
        _check(name, t, dtype, shape, dev)
    ebits = m.edge.shape[1] * 32
    if ebits & (ebits - 1) or tab.hash_tab.shape[0] & (
            tab.hash_tab.shape[0] - 1):
        raise KernelArgumentError("edge bitmap and hash table sizes must "
                                  "be powers of two")
    if ov.valid.data_ptr() % 16:
        raise KernelArgumentError("fused_step: overlay.valid must be "
                                  "16-byte aligned (a claimed row is "
                                  "cleared in 16-byte stores)")
    grid, block, shared = launch_geometry(n, slots)
    lib = library("fused_step")
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = torch.cuda.current_stream(dev)
    err = lib.wtf_fused_step(
        p(tab.hash_tab), tab.hash_tab.shape[0],
        p(tab.meta_i32), tab.meta_i32.shape[1], p(tab.meta_u64),
        p(image.pages), p(image.frame_table), image.frame_table.shape[1],
        p(image.tenant), p(m.cr3), p(m.fs_base), p(m.gs_base),
        p(m.gpr), p(m.rip), p(m.rflags), p(m.status), p(m.icount),
        p(m.bp_skip), p(m.ctr), p(m.cov), m.cov.shape[1], p(m.edge),
        m.edge.shape[1], p(ov.pfn), p(ov.data), p(ov.valid), p(ov.count),
        slots, ctypes.c_int64(I.s64(limit)), n, k_steps, grid, block,
        shared, ctypes.c_void_p(stream.cuda_stream))
    LAUNCHES["fused_step"] += 1
    if err:
        raise KernelError(f"fused_step kernel launch failed: cuda error "
                          f"{err}")


def _win16(image: MemImage, ov, pfn_a, pfn_b, off):
    """16 bytes at page offset `off` of frame pfn_a, straddling into
    pfn_b: three overlay-aware words and shifts.  The frames are used as
    given (the kernel's load_win16_pfn); only the image slot is
    range-checked."""
    w0 = off >> 3
    words = []
    for j in range(3):
        on_first = (w0 + j) < PAGE_WORDS
        widx = torch.where(on_first, w0 + j, w0 + j - PAGE_WORDS)
        pfn = torch.where(on_first, pfn_a, pfn_b)
        row, hit = lookup(ov, pfn)
        words.append(read_words(image, ov, frame_slot(image, pfn)[:, None],
                                row[:, None], hit[:, None],
                                widx[:, None])[:, 0])
    sh = (off & 7) * 8
    inv = 64 - sh
    lo = I.shr(words[0], sh) | I.shl(words[1], inv)
    hi = I.shr(words[1], sh) | I.shl(words[2], inv)
    return lo, hi


def fused_step_plain(tab: UopTable, image: MemImage, m: Machine,
                     limit: int, k_steps: int) -> None:
    """The fused kernel's function in PyTorch, batched over lanes and
    looping over the K steps; updates the 13 planes in place."""
    image = lane_image(image, m.n_lanes)
    ov = m.overlay
    n = m.n_lanes
    lanes = torch.arange(n, device=m.device)
    capacity = ov.capacity
    zeros = torch.zeros(n, dtype=torch.int64, device=m.device)
    d_instr, d_miss, d_ps, d_pm = zeros.clone(), zeros.clone(), \
        zeros.clone(), zeros.clone()
    limit_t = torch.full_like(zeros, I.s64(limit))
    ebits = m.edge.shape[1] * 32
    for _ in range(k_steps):
        gpr, rip, rf = m.gpr, m.rip, m.rflags
        run = m.status == _RUNNING
        if not bool(run.any()):
            break       # a step with no running lane changes nothing
        idx, idxc, d = S.probe(tab, image, m)
        miss = run & (idx < 0)
        at_bp = run & ~miss & (d.bp == 1) & (m.bp_skip == 0)
        hot = d.hot()
        is_mov, is_lea = d.is_(U.OPC_MOV), d.is_(U.OPC_LEA)
        is_alu, is_shift = d.is_(U.OPC_ALU), d.is_(U.OPC_SHIFT)
        is_mul, is_unary = d.is_(U.OPC_MUL), d.is_(U.OPC_UNARY)
        is_setcc, is_cmov = d.is_(U.OPC_SETCC), d.is_(U.OPC_CMOVCC)
        is_jcc, is_jmp = d.is_(U.OPC_JCC), d.is_(U.OPC_JMP)
        is_push, is_pop = d.is_(U.OPC_PUSH), d.is_(U.OPC_POP)
        is_call, is_ret = d.is_(U.OPC_CALL), d.is_(U.OPC_RET)
        live = run & ~miss & hot

        next_rip, ea = S.address(d, gpr, m.fs_base, m.gs_base, rip)
        rsp = gpr[:, 4]
        push_size = torch.where(is_call, 8, d.opsize)
        l1_need = live & ((d.sk == U.K_MEM) | is_pop | is_ret)
        l1_addr = torch.where(is_pop | is_ret, rsp, ea)
        l1_size = torch.where(is_ret, 8, torch.where(is_pop, d.opsize,
                                                     d.srcsize))
        l2_need = live & (d.dk == U.K_MEM) & (is_alu | is_shift | is_unary)
        st_addr = torch.where(is_push | is_call, rsp - push_size, ea)
        st_size = push_size
        t = translate(image, ov, m.cr3, torch.stack(
            [l1_addr, l1_addr + l1_size - 1, ea, ea + d.opsize - 1,
             st_addr, st_addr + st_size - 1], dim=1))

        code_off = rip & 0xFFF
        code_crosses = (code_off + 16) > 4096
        code_lo, code_hi = _win16(image, ov, d.pfn0,
                                  torch.where(code_crosses, d.pfn1, d.pfn0),
                                  code_off)
        lm_lo = I.size_mask(d.length.clamp(max=8))
        lm_hi = I.size_mask((d.length - 8).clamp(min=0))
        smc_risk = ((((code_lo ^ d.raw_lo) & lm_lo) != 0)
                    | (((code_hi ^ d.raw_hi) & lm_hi) != 0))

        firsts = t.gpa[:, 0::2][:, :2]         # l1 and l2 first bytes
        lo, _ = extract_pair(*load_windows3(
            image, ov, firsts, t.gpa[:, 1::2][:, :2]), firsts)
        l1_lo, l2_lo = lo[:, 0], lo[:, 1]
        src_val, dst_val = S.values(d, gpr, l1_lo, l2_lo)
        x = S.execute(d, gpr, rf, src_val, dst_val)
        cc = x["cc"]
        cc01 = cc.to(torch.int64)
        jcc_t = next_rip + d.imm
        jmp_t = torch.where(d.sk == U.K_IMM, jcc_t, src_val)
        pop_val = I.zext(l1_lo, d.opsize)

        # store plan + park decision (before any mutation)
        mem_writes = (is_mov | (is_alu & x["alu_writes"])
                      | (is_shift & x["sh_writes"]) | is_unary | is_setcc
                      | is_pop)
        st_need = live & (((d.dk == U.K_MEM) & mem_writes) | is_push
                          | is_call)
        s_off = t.gpa[:, 4] & 0xFFF
        crosses = (s_off + st_size) > 4096
        s_pfn0 = split_gpa(image, t.gpa[:, 4])[0]
        s_pfn1 = split_gpa(image, t.gpa[:, 5])[0]
        row0, hit0 = lookup(ov, s_pfn0)
        row1, hit1 = lookup(ov, s_pfn1)
        st_alias = s_pfn1 == s_pfn0
        oob = (s_pfn0 == PFN_OOB) | (crosses & (s_pfn1 == PFN_OOB))
        need_new = (~hit0).long() + (crosses & ~hit1 & ~st_alias).long()
        can_alloc = (ov.count.long() + need_new) <= capacity
        f_l1 = l1_need & ~(t.ok[:, 0] & t.ok[:, 1])
        f_l2 = l2_need & ~(t.ok[:, 2] & t.ok[:, 3])
        f_st = st_need & ~(t.ok[:, 4] & t.ok[:, 5] & t.writable[:, 4]
                           & t.writable[:, 5])
        mem_park = f_l1 | f_l2 | f_st | (st_need & (oob | ~can_alloc))
        park = run & ~miss & (at_bp | ~hot | smc_risk | mem_park)
        commit = run & ~miss & ~park
        park_mem = run & ~miss & ~at_bp & hot & ~smc_risk & mem_park
        park_sub = park & ~park_mem
        do_store = commit & st_need

        # in-kernel store: claim rows (clearing validity), then the
        # <= 8-byte masked read-modify-write over three words
        cnt0 = ov.count.long()
        alloc0 = do_store & ~hit0
        rowa = torch.where(alloc0, cnt0, row0)
        ov.pfn[lanes[alloc0], rowa[alloc0]] = s_pfn0[alloc0].to(torch.int32)
        ov.valid[lanes[alloc0], rowa[alloc0]] = 0
        cnt1 = cnt0 + alloc0.long()
        alloc1 = do_store & crosses & ~hit1 & ~st_alias
        rowb = torch.where(alloc1, cnt1, torch.where(crosses & hit1, row1,
                                                     rowa))
        ov.pfn[lanes[alloc1], rowb[alloc1]] = s_pfn1[alloc1].to(torch.int32)
        ov.valid[lanes[alloc1], rowb[alloc1]] = 0
        ov.count += (alloc0.long() + alloc1.long()).to(torch.int32)
        st_val = S._sel(
            [is_mov | is_push, is_alu, is_shift, is_unary, is_setcc, is_pop,
             is_call],
            [src_val, x["alu_r"], x["sh_r"], x["un_r"], cc01, pop_val,
             next_rip], torch.zeros_like(rip))
        sh = (s_off & 7) * 8
        end_bit = sh + st_size * 8
        vs = (I.shl(st_val, sh), I.shr(st_val, 64 - sh),
              torch.zeros_like(st_val))
        w0i = s_off >> 3
        sl = lanes[do_store]
        for j in range(3):
            lo_bit = 64 * j
            start_in = sh.clamp(min=lo_bit)
            end_in = end_bit.clamp(max=lo_bit + 64)
            has = end_in > start_in
            n_bits = torch.where(has, end_in - start_in, zeros)
            off_in = torch.where(has, start_in - lo_bit, zeros)
            mask = I.shl(I.shl(torch.ones_like(zeros), n_bits) - 1, off_in)
            on_first = (w0i + j) < PAGE_WORDS
            widx = torch.where(on_first, w0i + j, w0i + j - PAGE_WORDS)
            row = torch.where(on_first, rowa, rowb)
            slot = frame_slot(image, torch.where(on_first, s_pfn0, s_pfn1))
            r_, w_ = row[do_store], widx[do_store]
            vbyte = ov.valid[sl, r_, w_]
            old = torch.where(vbyte != 0, ov.data[sl, r_, w_],
                              image.pages[slot[do_store], w_])
            mk = mask[do_store]
            ov.data[sl, r_, w_] = (old & ~mk) | (vs[j][do_store] & mk)
            ov.valid[sl, r_, w_] = torch.where(mk != 0, vbyte | 1, vbyte)

        # register writes in the precise step's order: rsp, aux, primary
        w3_cond = is_push | is_call | is_pop | is_ret
        w3_val = S._sel([is_push | is_call, is_pop],
                        [rsp - push_size, rsp + d.opsize],
                        rsp + 8 + d.imm)
        four = torch.full_like(d.dr, 4)
        gpr = S.gpr_write(gpr, commit & w3_cond, four, w3_val, 8)
        is_mul2 = d.sub == U.MUL_2OP
        gpr = S.gpr_write(gpr, commit & is_mul & ~is_mul2 & (d.opsize > 1),
                          torch.full_like(d.dr, 2), x["mul_r2"], d.opsize)
        dk_reg = d.dk == U.K_REG
        true = torch.ones_like(run)
        classes = [is_mov, is_lea, is_alu, is_shift, is_unary, is_mul,
                   is_pop, is_setcc, is_cmov]
        w1_cond = S._sel(classes, [
            dk_reg, true, x["alu_writes"] & dk_reg, x["sh_writes"] & dk_reg,
            dk_reg, true, dk_reg, dk_reg, true], ~true)
        w1_idx = torch.where(is_mul, torch.where(is_mul2, d.dr, 0), d.dr)
        w1_val = S._sel(classes, [
            src_val, ea, x["alu_r"], x["sh_r"], x["un_r"], x["mul_r1"],
            pop_val, cc01, torch.where(cc, src_val, dst_val)],
            torch.zeros_like(rip))
        w1_size = torch.where(is_mul, torch.where(
            is_mul2, d.opsize, torch.where(d.opsize == 1, 2, d.opsize)),
            d.opsize)
        gpr = S.gpr_write(gpr, commit & w1_cond, w1_idx, w1_val, w1_size)

        # rflags (bits 32+ pass through) / rip
        hot_rf = is_alu | is_unary | is_shift | is_mul
        rf_exec = S._sel([is_alu, is_unary, is_shift],
                         [x["alu_rf"], x["un_rf"], x["sh_rf"]], x["mul_rf"])
        rf_cand = torch.where(hot_rf, rf_exec, rf)
        new_rf = torch.where(commit, (rf & ~0xFFFFFFFF)
                             | ((rf_cand | 0x2) & 0xFFFFFFFF), rf)
        rip_exec = S._sel([is_jmp | is_call, is_jcc, is_ret],
                          [jmp_t, torch.where(cc, jcc_t, next_rip), l1_lo],
                          next_rip)

        # bookkeeping: icount/limit, counters, coverage, edges
        new_ic = m.icount + commit.long()
        timed = commit & (limit != 0) & ~I.ltu(new_ic, limit_t)
        status = torch.where(miss, _NEED_DECODE, torch.where(
            park, _NEEDS_XLA, torch.where(timed, _TIMEDOUT,
                                          m.status.long())))
        ei = ((I.mix64(rip) ^ rip_exec) & 0xFFFFFFFF) & (ebits - 1)
        is_branch = is_jmp | is_jcc | is_call | is_ret
        # in-place writes last: rip/rflags/... above alias these planes
        m.gpr.copy_(gpr)
        m.rip.copy_(torch.where(commit, rip_exec, rip))
        m.rflags.copy_(new_rf)
        m.icount.copy_(new_ic)
        m.status.copy_(status.to(torch.int32))
        m.bp_skip.copy_(torch.where(commit, 0, m.bp_skip))
        m.cov.copy_(S._bit_or(m.cov, idxc >> 5, idxc & 31, commit))
        m.edge.copy_(S._bit_or(m.edge, ei >> 5, ei & 31,
                               commit & is_branch))
        d_instr += commit.long()
        d_miss += miss.long()
        d_ps += park_sub.long()
        d_pm += park_mem.long()

    for col, delta in ((CTR_INSTR, d_instr), (CTR_DECODE_MISS, d_miss),
                       (CTR_FUSED, d_instr), (CTR_PARK_SUBSET, d_ps),
                       (CTR_PARK_MEM, d_pm)):
        m.ctr[:, col] += delta.to(torch.int32)


# ---------------------------------------------------------------------------
# the resume leg
# ---------------------------------------------------------------------------

def fused_resume(tab: UopTable, image: MemImage, m: Machine, limit: int,
                 n_steps: int) -> int:
    """Run the precise step for the lanes the kernel parked: parked
    (NEEDS_XLA) lanes run while still-RUNNING lanes — hot lanes that only
    used up their K steps — are HELD for the leg and released after.
    Without the hold every round would retire n_steps hot instructions
    per lane on the precise step and occupancy would fall.  Returns the
    precise steps taken."""
    st = m.status
    m.status = torch.where(st == _NEEDS_XLA, _RUNNING, torch.where(
        st == _RUNNING, _NEEDS_XLA, st)).to(torch.int32)
    iters = S.run_steps(tab, image, m, limit, n_steps)
    # the precise step never emits NEEDS_XLA, so every one left is a
    # lane held above
    m.status = torch.where(m.status == _NEEDS_XLA, _RUNNING,
                           m.status).to(torch.int32)
    return iters
