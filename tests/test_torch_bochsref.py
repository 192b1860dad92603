"""The port's copy of the bench's host interpreter (wtf_tpu_torch/native/
bochsref.cc) and its ctypes binding (native/bochsref.py).

  * the source is byte-identical to wtf_tpu/native/bochsref.cc;
  * through the port's binding it gives tests/test_bochsref.py's verdicts
    — the same ok/crash verdict per testcase as the port's EmuCpu oracle
    and the JAX package's, on the same mangle-mutated demo_tlv stream;
  * a batch campaign counts what one-at-a-time calls count.
"""

import random
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _testcases():
    from wtf_tpu_torch.fuzz.corpus import Corpus
    from wtf_tpu_torch.fuzz.native_mutator import best_mangle_mutator

    rng = random.Random(0xBEEF)
    corpus = Corpus(rng=rng)
    corpus.add(b"\x01\x04AAAA\x02\x08BBBBBBBB")
    corpus.add(b"\x03\x30" + b"C" * 0x30)     # the planted smash
    mutator = best_mangle_mutator(rng, max_len=0x200)
    tcs = [mutator.get_new_testcase(corpus) for _ in range(64)]
    return tcs + [b"\x01\x04AAAA", b"\x03\x30" + b"C" * 0x30, b"",
                  b"\x02\x03AB"]


def _oracle(backend_cls, target_mod, results_mod, tcs):
    be = backend_cls(target_mod.build_snapshot(), limit=100_000)
    be.initialize()
    target_mod.TARGET.init(be)
    out = []
    for tc in tcs:
        target_mod.TARGET.insert_testcase(be, tc)
        r = be.run()
        out.append("ok" if isinstance(r, results_mod.Ok)
                   else "timeout" if isinstance(r, results_mod.Timedout)
                   else "crash")
        be.restore()
    return out


def test_source_is_a_byte_identical_copy():
    ours = REPO / "wtf_tpu_torch" / "native" / "bochsref.cc"
    assert ours.read_bytes() == \
        (REPO / "wtf_tpu" / "native" / "bochsref.cc").read_bytes()


def test_bochsref_matches_both_oracles():
    from wtf_tpu.backend.emu import EmuBackend as JEmuBackend
    from wtf_tpu.core import results as JR
    from wtf_tpu.harness import demo_tlv as JT
    from wtf_tpu_torch.backend.emu import EmuBackend
    from wtf_tpu_torch.core import results as R
    from wtf_tpu_torch.harness import demo_tlv as T
    from wtf_tpu_torch.native.bochsref import BochsRef

    vm = BochsRef.demo_tlv()
    if vm is None:
        pytest.skip("no native toolchain")
    tcs = _testcases()
    try:
        native = [vm.verdict(tc) for tc in tcs]
        batch = vm.campaign(tcs, 100_000)
    finally:
        vm.close()
    port = _oracle(EmuBackend, T, R, tcs)
    jax = _oracle(JEmuBackend, JT, JR, tcs)
    assert port == jax
    for tc, o, n in zip(tcs, port, native):
        assert o == n, f"verdict diverged on {tc.hex()}: oracle={o} native={n}"
    assert "crash" in native and "ok" in native
    assert batch[0] == len(tcs) and batch[2] == native.count("crash")
