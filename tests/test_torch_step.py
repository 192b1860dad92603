"""The port's precise step (wtf_tpu_torch/interp/step.py) against the JAX
package's step_lane, bit for bit.

Each case runs one guest on 4 lanes (different registers per lane) in
lockstep: one JAX `make_run_chunk(1)` step and one port `step` from the
same converted state, then every machine plane — registers, rip, rflags,
status, icount, bp_skip, fault address and kind, the counter block, the
coverage and edge bitmaps and the raw overlay planes — must be equal.
The integer cores are also held against the JAX limb cores on random
operand grids, and a runner-level case runs hot code interleaved with the
SSE and x87 opclasses on the device step, to the JAX ladder's final state.
"""

import random
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torchport as tp
from tests.emurunner import DATA_BASE
from tests.test_pstep import _gen_hot_program, _random_regs
from wtf_tpu.interp import limbs as L
from wtf_tpu.interp import step as JS
from wtf_tpu_torch import convert
from wtf_tpu_torch.core.results import StatusCode
from wtf_tpu_torch.interp import step as TS
from tests.torchport import one_torch_thread  # noqa: F401  (module fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_LANES = 4
CAP = 1024
SLOTS = 8


def _lane_regs(seed: int):
    rng = random.Random(seed)
    names = ("rax", "rbx", "rcx", "rdx", "rsi", "rdi", "r8", "r9", "r10",
             "r11")
    idx = {"rax": 0, "rcx": 1, "rdx": 2, "rbx": 3, "rsi": 6, "rdi": 7,
           "r8": 8, "r9": 9, "r10": 10, "r11": 11}
    out = {}
    for lane in range(1, N_LANES):
        regs = {idx[n]: rng.getrandbits(64) for n in names}
        if rng.random() < 0.5:
            regs[1] = rng.randrange(4)
        out[lane] = regs
    return out


def lockstep(asm, data=None, regs=None, lane_regs=None, limit=0, bps=(),
             bp_skip_lanes=(), readonly=None, large=None, keep=(),
             max_steps=3000):
    """Step both engines from the same state until no lane runs; returns
    (jax machine, port machine, set of statuses seen)."""
    pages, cpu = tp.build_guest(asm, data, regs, readonly, large)
    r = tp.warm_runner(pages, cpu, N_LANES, CAP, SLOTS)
    for gva in bps:
        r.cache.set_breakpoint(gva)
    tab = r.cache.device("cpu")
    img_leaves = tp.padded_image(pages)
    img = convert.image_from_jax(img_leaves)
    img_j = tp.jax_image(img_leaves)
    tab_j = tp.jax_table(convert.table_to_jax(tab))
    m = tp.initial_machine(cpu, N_LANES, CAP, SLOTS, lane_regs)
    for lane in bp_skip_lanes:
        m.bp_skip[lane] = 1
    mj = tp.to_jax(m)
    run1 = JS.make_run_chunk(1, donate=False)
    seen = set()
    for i in range(max_steps):
        if not bool((m.status == int(StatusCode.RUNNING)).any()):
            break
        mj = run1(tab_j, img_j, mj, jnp.uint64(limit))
        TS.step(tab, img, m, limit)
        tp.assert_machines_equal(mj, m, where=f"step {i}")
        seen |= {StatusCode(int(s)) for s in m.status}
        for lane in keep:
            # breakpoint lanes resume with bp_skip like the runner does
            if m.status[lane] == int(StatusCode.BREAKPOINT):
                m.status[lane] = int(StatusCode.RUNNING)
                m.bp_skip[lane] = 1
                mj = tp.to_jax(m)
    return mj, m, seen


@pytest.mark.parametrize("seed", range(4))
def test_step_hot_grids_match_step_lane(seed):
    rng = random.Random(0xF05E + seed)
    asm = _gen_hot_program(rng)
    _, m, seen = lockstep(asm, regs=_random_regs(rng),
                          lane_regs=_lane_regs(seed))
    # every lane ends at the int3, which the step itself retires as CRASH
    assert (m.status == int(StatusCode.CRASH)).all()
    assert (m.icount > 10).all()


def _mem_program(seed: int) -> str:
    rng = random.Random(0x3E30 + seed)
    body = []
    for _ in range(24):
        disp = rng.randrange(0, 0xE00) & ~7
        width, reg = rng.choice((("qword", "rcx"), ("dword", "ecx"),
                                 ("word", "cx"), ("byte", "cl")))
        body.append(rng.choice([
            f"mov [rbx + {disp}], {reg}",
            f"mov {reg}, [rbx + {disp}]",
            f"mov {width} ptr [rbx + {disp}], {rng.getrandbits(7)}",
            f"add [rbx + {disp}], {reg}",
            f"xor rax, [rbx + {disp}]",
            f"cmp [rbx + {disp}], {reg}",
            f"shl {width} ptr [rbx + {disp}], {rng.randrange(1, 7)}",
            f"neg {width} ptr [rbx + {disp}]",
            f"inc qword ptr [rbx + {disp + 0xFFC}]",
            f"ror rdx, {rng.randrange(1, 63)}",
            "shld rax, rdx, 11",
            "imul rdx, rax, 3",
            "mul rcx",
            f"setc byte ptr [rbx + {disp}]",
            f"cmovnz r10, qword ptr [rbx + {disp}]",
            "push rax\npop rsi",
            f"push qword ptr [rbx + {disp}]\npop r11",
            "call 1f\njmp 2f\n1: add rax, 7\nret\n2:",
        ]))
    return (f"mov rbx, {DATA_BASE}\nmov rcx, 0x1122334455667788\n"
            f"mov r14, 2\n3:\n" + "\n".join(body) + "\ndec r14\njnz 3b\nint3")


@pytest.mark.parametrize("seed", range(3))
def test_step_mem_grids_match_step_lane(seed):
    """Memory operands through the walk and the overlay, including stores
    straddling two pages (the +0xFFC displacement)."""
    _, m, _ = lockstep(_mem_program(seed),
                       data={DATA_BASE: bytes(0x2000)},
                       lane_regs=_lane_regs(seed))
    assert (m.overlay.count > 0).all()


@pytest.mark.parametrize("case", ("read", "write", "readonly", "straddle",
                                  "noncanonical", "push"))
def test_step_page_faults(case):
    asm = {
        "read": f"mov rbx, {DATA_BASE}\nmov rax, [rbx + 0x200000]\nint3",
        "write": f"mov rbx, {DATA_BASE}\nmov [rbx + 0x3000], rax\nint3",
        "readonly": f"mov rbx, {DATA_BASE + 0x1000}\nadd [rbx], rax\nint3",
        "straddle": f"mov rbx, {DATA_BASE}\nmov rax, [rbx + 0x1FFC]\nint3",
        "noncanonical": "mov rbx, 0x8000000000000000\nmov rax, [rbx]\nint3",
        "push": "mov rsp, 0x10000\npush rax\nint3",
    }[case]
    _, m, seen = lockstep(asm, data={DATA_BASE: b"\x55" * 0x1000},
                          readonly={DATA_BASE + 0x1000: 0x1000})
    assert seen >= {StatusCode.PAGE_FAULT}
    assert (m.ctr[:, 1] == 1).all()      # CTR_MEM_FAULT


def test_step_breakpoint_and_bp_skip():
    asm = """
        mov rax, 0
        mov rcx, 3
    1:
        add rax, rcx
        inc rdx
        dec rcx
        jnz 1b
        int3
    """
    code = tp.assemble(asm)
    bp = tp.CODE_BASE + code.index(bytes.fromhex("48ffc2"))
    _, m, seen = lockstep(asm, bps=(bp,), bp_skip_lanes=(1,),
                          keep=range(N_LANES))
    assert StatusCode.BREAKPOINT in seen


def test_step_smc_timeout_overlay_full():
    # a store into the next instruction's bytes -> SMC at that rip
    smc = """
        lea rbx, [rip + 1f]
        mov byte ptr [rbx], 0x90
    1:
        inc rax
        int3
    """
    _, _, seen = lockstep(smc)
    assert StatusCode.SMC in seen
    # the instruction budget stops a hot loop mid-way
    loop = "mov rcx, 1000\n1:\nadd rax, rcx\ndec rcx\njnz 1b\nint3"
    _, m, seen = lockstep(loop, limit=37)
    assert StatusCode.TIMEDOUT in seen and (m.icount == 37).all()
    # more dirty pages than overlay rows
    stores = "\n".join(f"mov [rbx + {0x1000 * i}], rax"
                       for i in range(SLOTS + 2))
    _, m, seen = lockstep(f"mov rbx, {DATA_BASE}\n{stores}\nint3",
                          data={DATA_BASE: bytes(0x1000 * (SLOTS + 2))})
    assert StatusCode.OVERLAY_FULL in seen
    assert bool(m.overlay.overflow.all())


def test_step_large_pages():
    big = 0x4000_0000
    gpa = 0x0060_0000
    asm = f"""
        mov rbx, {big}
        mov rax, [rbx + 0x1F0000]
        add rax, [rbx + 8]
        mov [rbx + 0x100], rax
        int3
    """
    blobs = {gpa + 0x1F0000: (0x1111_2222_3333_4444).to_bytes(8, "little"),
             gpa + 8: (0x10).to_bytes(8, "little")}
    _, m, _ = lockstep(asm, large=(big, gpa, 21, blobs))
    assert int(m.gpr[0, 0]) == 0x1111_2222_3333_4454


# ---------------------------------------------------------------------------
# the integer cores against the JAX limb cores
# ---------------------------------------------------------------------------

def _grid(seed, k=256):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 64, k, dtype=np.uint64)
    b = rng.integers(0, 1 << 64, k, dtype=np.uint64)
    a[:8] = [0, 1, 0x7F, 0x80, 0xFFFF, 0x8000_0000, 1 << 63, (1 << 64) - 1]
    b[:8] = [0, 0xFF, 1, 0x7FFF_FFFF, 3, 1 << 63, 63, 64]
    sub = rng.integers(0, 10, k).astype(np.int32)
    sext = rng.integers(0, 4, k).astype(np.int32)
    nbytes = rng.choice([1, 2, 4, 8], k).astype(np.int32)
    rf = (rng.integers(0, 1 << 32, k, dtype=np.uint64) | 2) \
        | (np.uint64(0xAB) << np.uint64(40))
    return a, b, sub, sext, nbytes, rf


def _pair(v):
    u = L.unpack_np(v)
    return jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1])


def _u64(p):
    return (np.asarray(p[0]).astype(np.uint64)
            | (np.asarray(p[1]).astype(np.uint64) << np.uint64(32)))


def _t(v):
    return torch.from_numpy(np.ascontiguousarray(v).view(np.int64)
                            if v.dtype == np.uint64 else v)


def _u(t):
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("core", ("alu", "unary", "shift", "mul"))
def test_integer_core_matches_limb_core(core):
    a, b, sub, sext, n, rf = _grid(0xC0DE + len(core))
    am = a & np.where(n >= 8, np.uint64((1 << 64) - 1),
                      (np.uint64(1) << (n.astype(np.uint64) * 8)) - 1)
    bm = b & np.where(n >= 8, np.uint64((1 << 64) - 1),
                      (np.uint64(1) << (n.astype(np.uint64) * 8)) - 1)
    cf = (rf & np.uint64(1)) != 0
    rf_lo = jnp.asarray((rf & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    ja, jb, jsub, jsx, jn = _pair(am), _pair(bm), jnp.asarray(sub), \
        jnp.asarray(sext), jnp.asarray(n)
    ta, tb, tsub, tsx, tn, trf = _t(am), _t(bm), _t(sub), _t(sext), \
        _t(n), _t(rf)
    tcf = torch.from_numpy(cf)
    hi = rf & np.uint64(0xFFFFFFFF_00000000)
    if core == "alu":
        r, jrf, w = JS.alu_limb(jsub, ja, jb, jnp.asarray(cf), jn, rf_lo)
        tr, trf2, tw = TS.alu(tsub, ta, tb, tcf, tn, trf)
        got = [(_u64(r), _u(tr)), (np.asarray(w), tw.numpy())]
    elif core == "unary":
        r, jrf = JS.unary_limb(jsub, ja, jnp.asarray(cf), jn, rf_lo)
        tr, trf2 = TS.unary(tsub, ta, tcf, tn, trf)
        got = [(_u64(r), _u(tr))]
    elif core == "shift":
        cnt = (b & np.uint64(0xFF)).astype(np.uint32)
        r, jrf, w = JS.shift_limb(jsub, jsx, ja, jb, jnp.asarray(cnt),
                                  jnp.asarray(cnt), jnp.asarray(cnt),
                                  jnp.asarray(cf), jn, rf_lo)
        tc = _t(cnt.astype(np.int64))
        tr, trf2, tw = TS.shift(tsub, tsx, ta, tb, tc, tc, tc, tcf, tn, trf)
        got = [(_u64(r), _u(tr)), (np.asarray(w), tw.numpy())]
    else:
        sub3 = sub % 3
        r1, r2, jrf = JS.mul_limb(jnp.asarray(sub3), jsx, ja, jb, ja, jb, jn,
                                  rf_lo)
        tr1, tr2, trf2 = TS.mul(_t(sub3), tsx, ta, tb, ta, tb, tn, trf)
        got = [(_u64(r1), _u(tr1)), (_u64(r2), _u(tr2))]
    want_rf = hi | np.asarray(jrf).astype(np.uint64)
    got.append((want_rf, _u(trf2)))
    for want, have in got:
        assert np.array_equal(want, have), (core, np.argwhere(want != have))


def test_sse_and_x87_opclasses_run_on_the_device_step():
    """Runner level: a program of hot code interleaved with SSE, SSE-FP
    and x87 instructions ends in the JAX ladder's exact state with no
    oracle fallback: the port's step runs those classes (the int3 at the
    end is the step's own)."""
    from wtf_tpu.interp.runner import Runner as JRunner
    from wtf_tpu.mem.physmem import PhysMem as JPhysMem
    from wtf_tpu.snapshot.loader import Snapshot as JSnapshot
    from wtf_tpu_torch.interp.runner import Runner
    from wtf_tpu_torch.snapshot.loader import Snapshot

    asm = f"""
        mov rbx, {DATA_BASE}
        mov rax, 0x1122334455667788
        mov rcx, 3
    1:
        movdqu xmm0, [rbx]
        movdqa xmm1, xmm0
        paddq xmm1, xmm0
        movsd xmm2, [rbx + 16]
        addsd xmm2, [rbx + 24]
        movq rdx, xmm2
        fld qword ptr [rbx + 16]
        fnstsw ax
        add [rbx + 8], rax
        inc r9
        dec rcx
        jnz 1b
        int3
    """
    data = {DATA_BASE: bytes(16) + struct.pack("<dd", 1.5, 2.25)
            + bytes(0x1000 - 32)}
    pages, cpu = tp.build_guest(asm, data)
    jpages, jcpu = tp.jax_guest(asm, data)
    assert pages == jpages
    jr = JRunner(JSnapshot(physmem=JPhysMem.from_pages(jpages), cpu=jcpu),
                 n_lanes=2, chunk_steps=64)
    js = jr.run()
    js_fallbacks = jr.stats["fallbacks"]
    for fused in ("off", "on"):
        tr = Runner(Snapshot.from_pages(pages, cpu), n_lanes=2,
                    chunk_steps=64, fused_step=fused, device="cpu")
        ts = tr.run()
        assert np.array_equal(js, ts)
        assert all(StatusCode(int(s)) == StatusCode.CRASH for s in ts)
        # the fused ladder adds its own counters, and its kernel stores
        # only where it stores (the precise step writes every lane's
        # store window back): compare those planes through the view
        skip = ("ctr", "overlay.data", "overlay.valid") \
            if fused == "on" else ()
        tp.assert_machines_equal(jr.machine, tr.machine, skip=skip,
                                 where=f"fused={fused}")
        jv, tv = jr.view(), tr.view()
        pfn = tv.translate(0, DATA_BASE) >> 12
        assert jv.page(0, pfn) == tv.page(0, pfn)
        assert tr.stats["fallbacks"] == 0, tr.stats["fallbacks_by_opclass"]
        assert js_fallbacks == 0
