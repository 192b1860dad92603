"""demo_kernel and demo_usermode through the port, against the JAX
package's tpu backend, on the CPU.

demo_kernel is the port's first path in ring 0: syscall through
IA32_LSTAR, swapgs, a kernel stack at canonical-negative (high-half)
addresses and sysretq.  demo_usermode grows a guard-page stack through #PF
delivery and dispatches #DE and #GP through a real IDT; its iretq returns
run on the host oracle in both packages.

  * the cases of tests/test_kernel.py and tests/test_usermode.py through
    `GpuBackend(device="cpu")` with `--fused-step off` and `on`: the same
    result types and crash names, case for case, as the JAX tpu backend
  * demo_kernel runs with no oracle fallback; demo_usermode falls back at
    most twice per delivered exception, and only for iretq
  * results repeat across `restore`
  * a seeded 16-lane campaign on each target, the reference side with the
    reference CLI's host mutator rule: the same corpus digests, crash
    names, coverage/edge aggregates and device counters
  * demo_usermode's stack growth through a faulting PUSH, its undoing by
    `restore`, and a breakpoint handler's injected #PF, with the values
    tests/test_usermode.py pins
"""

import random
import struct

import numpy as np
import pytest
from tests.torchport import one_torch_thread  # noqa: F401  (module fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_LANES = 16
LIMIT = 100_000
KERNEL_CASES = [
    b"\x01" + bytes([1, 2, 3, 4]),                            # benign
    b"\x02" + struct.pack("<IQ", 0xDEADBEEF, 0x41) + b"pad",  # bugcheck
    b"\x03" + b"A" * 200,                                     # OOB write
    b"\x04" + struct.pack("<Q", 0xDEAD0000) + b"x",           # wild jump
    b"", b"\x03\x41", b"\x02short", b"\x01" + bytes(range(40)),
]
USER_CASES = [b"\x01\x04", b"\x02", b"\x03", b"", b"\x01\x0e", b"\x01\x00",
              b"\x04\x05", b"\x05"]
_JAX_RESULTS = {}


def _modules(name):
    from wtf_tpu.harness import demo_kernel as jk, demo_usermode as ju
    from wtf_tpu_torch.harness import demo_kernel as tk, demo_usermode as tu

    return {"demo_kernel": (jk, tk), "demo_usermode": (ju, tu)}[name]


def _jax_backend(name):
    from wtf_tpu.backend import create_backend

    mod = _modules(name)[0]
    b = create_backend("tpu", mod.build_snapshot(), n_lanes=N_LANES,
                       limit=LIMIT)
    b.initialize()
    mod.TARGET.init(b)
    return b, mod.TARGET


def _port_backend(name, fused):
    from wtf_tpu_torch.backend.gpu import GpuBackend

    mod = _modules(name)[1]
    b = GpuBackend(mod.build_snapshot(), n_lanes=N_LANES, limit=LIMIT,
                   device="cpu", fused_step=fused)
    b.initialize()
    mod.TARGET.init(b)
    return b, mod.TARGET


def _jax_results(name, cases):
    if name not in _JAX_RESULTS:
        b, t = _jax_backend(name)
        _JAX_RESULTS[name] = [str(r) for r in b.run_batch(cases, t)]
    return _JAX_RESULTS[name]


def _same_results(name, cases, fused):
    want = _jax_results(name, cases)
    b, t = _port_backend(name, fused)
    got = [str(r) for r in b.run_batch(cases, t)]
    assert got == want
    return b, got


@pytest.mark.parametrize("fused", ["off", "on"])
def test_kernel_matches_tpu_backend(fused):
    from wtf_tpu_torch.harness.demo_kernel import KBUF_PAGE

    b, got = _same_results("demo_kernel", KERNEL_CASES, fused)
    assert got[:4] == ["ok", "crash(crash-bugcheck-0xdeadbeef-0x41)",
                       f"crash(crash-write-{KBUF_PAGE + 0x1000:#x})",
                       "crash(crash-execute-0xdead0000)"]
    # the ring-0 path runs on the step, with no oracle fallback
    assert b.runner.stats["fallbacks"] == 0
    if fused == "on":
        reg = b.registry
        assert reg.counter("device.fused_steps").value > 0


@pytest.mark.parametrize("fused", ["off", "on"])
def test_usermode_matches_tpu_backend(fused):
    from wtf_tpu_torch.harness.demo_usermode import STACK_TOP

    b, got = _same_results("demo_usermode", USER_CASES, fused)
    assert got[1] == "crash(crash-read-0xdead0000)"
    assert got[7] == "crash(crash-read-0x0)"
    stats = b.runner.stats
    assert stats["exceptions_delivered"] > 0
    assert stats["fallbacks"] <= 2 * stats["exceptions_delivered"]
    assert set(stats["fallbacks_by_opclass"]) == {"iret"}
    # lane 0 grew its stack: each grown page holds the loop's countdown
    rsp0 = STACK_TOP - 0x10
    for n in range(1, 5):
        assert int.from_bytes(b.virt_read(rsp0 - n * 0x1000, 8),
                              "little") == 5 - n


@pytest.mark.parametrize("name", ["demo_kernel", "demo_usermode"])
def test_results_repeat_across_restore(name):
    cases = KERNEL_CASES[:4] if name == "demo_kernel" else USER_CASES[:4]
    b, t = _port_backend(name, "on")
    first = [str(r) for r in b.run_batch(cases, t)]
    t.restore()
    b.restore()
    assert [str(r) for r in b.run_batch(cases, t)] == first


@pytest.mark.parametrize("name", ["demo_kernel", "demo_usermode"])
def test_campaign_matches_tpu_backend(name):
    from wtf_tpu.cli import _mutator_for
    from wtf_tpu.fuzz.corpus import Corpus
    from wtf_tpu.fuzz.loop import FuzzLoop
    from wtf_tpu_torch import cli

    runs, seed, max_len = 32, 7, 24
    jb, jt = _jax_backend(name)
    rng = random.Random(seed)
    # the reference CLI's host mutator rule (the native engine when it
    # builds), which the port's `campaign` follows
    jloop = FuzzLoop(jb, jt, _mutator_for(jt, rng, max_len), Corpus(rng=rng))
    jloop.fuzz(runs=runs)
    args = cli.build_parser().parse_args(
        ["campaign", "--name", name, "--fused-step", "on", "--lanes",
         str(N_LANES), "--runs", str(runs), "--limit", str(LIMIT),
         "--max_len", str(max_len), "--seed", str(seed), "--device", "cpu"])
    tloop = cli.campaign(args)
    tb = tloop.backend
    assert type(tloop.mutator).__name__ == type(jloop.mutator).__name__
    assert sorted(jloop.corpus.digests) == sorted(tloop.corpus.digests)
    assert jloop.crash_names == tloop.crash_names
    for f in ("testcases", "crashes", "timeouts", "new_coverage"):
        assert getattr(jloop.stats, f) == getattr(tloop.stats, f), f
    assert np.asarray(jb._agg_cov).tobytes() == tb._agg_cov.numpy().tobytes()
    assert np.asarray(jb._agg_edge).tobytes() \
        == tb._agg_edge.numpy().tobytes()
    for counter in ("device.instructions", "device.decode_misses",
                    "device.mem_faults"):
        assert jb.registry.counter(counter).value \
            == tb.registry.counter(counter).value, counter
    if name == "demo_kernel":
        assert tb.runner.stats["fallbacks"] == 0


def _small_usermode():
    from wtf_tpu_torch.backend.gpu import GpuBackend
    from wtf_tpu_torch.harness import demo_usermode as du

    b = GpuBackend(du.build_snapshot(), n_lanes=2, limit=LIMIT,
                   device="cpu", fused_step="on")
    b.initialize()
    du.TARGET.init(b)
    return b, du


def test_usermode_stack_grows_through_faulting_push():
    """The faulting micro-op is the PUSH's own store: the retry after
    delivery runs it with rsp not yet decremented (tests/test_usermode.py
    pins the same final rsp and stored values)."""
    b, du = _small_usermode()
    assert str(b.run_batch([b"\x04\x03"], du.TARGET)[0]) == "ok"
    rsp0 = du.STACK_TOP - 0x10
    assert b.get_reg(4) == rsp0 - 3 * 0x1000
    for k in range(1, 4):
        assert int.from_bytes(b.virt_read(rsp0 - k * 0x1000, 8),
                              "little") == 4 - k
    b.restore()
    with pytest.raises(Exception):
        b.virt_translate(du.STACK_TOP - 0x2000)      # a guard page again


def test_usermode_page_faults_memory_if_needed_injects():
    """The breakpoint handler probes, injects a #PF and returns; the guest
    maps the page and retries; the breakpoint fires again and the host
    write proceeds."""
    b, du = _small_usermode()
    target_gva = du.STACK_TOP - 0x3000
    fires = []

    def on_entry(backend):
        fires.append(backend.rip())
        if backend.page_faults_memory_if_needed(target_gva, 8):
            return
        backend.virt_write(target_gva, b"paged-in")
        backend.rip(du.FINISH_GVA)

    b.set_breakpoint(du.USER_CODE, on_entry)
    assert str(b.run_batch([b""], du.TARGET)[0]) == "ok"
    assert len(fires) == 2, fires
    assert b.virt_read(target_gva, 8) == b"paged-in"
