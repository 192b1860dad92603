"""The port's device mutation engine (wtf_tpu_torch/devmut) and its insert
seam against the JAX package, on the CPU.

  * `generate` against wtf_tpu.devmut.engine.generate and
    hostref.host_generate: the seeds of tests/test_devmut.py (including
    2**64 - 3), a live corpus and an empty one (the fresh path), rounds 1
    and 5, max_len 64 and 36 (not a multiple of 16), batch indices 0, 1
    and 1000 — words and lengths equal (tolerance 0: integer state)
  * `lane_seeds` against the JAX copy and the scalar splitmix formula
  * DeviceCorpus slab semantics, and that an uploaded view is a copy
  * `device_insert` against the JAX `device_insert_impl` on the same
    machine: a fresh restore, a pushed host write into the input region,
    and a lane with too few free overlay rows (OVERLAY_FULL) — every
    machine plane, the raw overlay planes included, equal
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torchport as tp
from wtf_tpu.devmut import hostref as jhostref
from wtf_tpu.devmut.engine import make_generate
from wtf_tpu_torch.devmut import hostref
from wtf_tpu_torch.devmut.corpus import DeviceCorpus
from wtf_tpu_torch.devmut.engine import generate, seeds_from_pairs

from tests.torchport import one_torch_thread  # noqa: F401  (module fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SEEDS = [0xDEAD_BEEF_1234, 7, (1 << 64) - 3]
N_LANES = 16


def _slab(rng, max_len, slots=4, live=3):
    """A corpus slab of `live` random rows (lengths 1..max_len) with
    weights 1..live; live=0 is the empty corpus."""
    words = max_len // 4
    data = np.zeros((slots, words), np.uint32)
    lens = np.zeros((slots,), np.int32)
    weights = np.zeros((slots,), np.uint32)
    for s in range(live):
        n = rng.randint(1, max_len + 1)
        buf = np.zeros(max_len, np.uint8)
        buf[:n] = rng.randint(0, 256, n).astype(np.uint8)
        data[s] = buf.view(np.uint32)
        lens[s] = n
        weights[s] = 1 + s
    cumw = np.cumsum(weights, dtype=np.uint64).astype(np.uint32)
    return data, lens, cumw


def _port_generate(data, lens, cumw, seeds, rounds):
    words, out_lens = generate(
        torch.tensor(data.view(np.int32)), torch.tensor(lens),
        torch.tensor(cumw.astype(np.int64)),
        seeds_from_pairs(seeds, "cpu"), rounds)
    return words.numpy().view(np.uint32), out_lens.numpy()


@pytest.mark.parametrize("rounds", [1, 5])
@pytest.mark.parametrize("max_len,live", [(64, 3), (36, 3), (64, 0)])
@pytest.mark.parametrize("seed", SEEDS)
def test_generate_matches_jax_engine_and_host_reference(seed, max_len, live,
                                                        rounds):
    rng = np.random.RandomState(seed & 0xFFFF)
    data, lens, cumw = _slab(rng, max_len, live=live)
    gen = make_generate(rounds)
    for batch in (0, 1, 1000):
        seeds = hostref.lane_seeds(seed, batch, N_LANES)
        j_words, j_lens = gen(jnp.asarray(data), jnp.asarray(lens),
                              jnp.asarray(cumw), jnp.asarray(seeds))
        h_words, h_lens = hostref.host_generate(data, lens, cumw, seeds,
                                                rounds)
        t_words, t_lens = _port_generate(data, lens, cumw, seeds, rounds)
        assert np.array_equal(np.asarray(j_words), h_words)
        assert np.array_equal(t_words, h_words), (batch, seed)
        assert np.array_equal(t_lens, np.asarray(j_lens))
        assert np.array_equal(t_lens, h_lens)
        assert (t_lens >= 1).all() and (t_lens <= max_len).all()
        if live == 0:
            assert (t_lens <= 64).all()       # fresh synthesis: 1..64


def test_generate_exercises_every_op():
    """Enough draws that all 8 mangle ops run, still equal to hostref."""
    rng = np.random.RandomState(11)
    data, lens, cumw = _slab(rng, 64)
    trace = []
    for batch in range(3):
        seeds = hostref.lane_seeds(0x5EED, batch, N_LANES)
        h_words, h_lens = hostref.host_generate(data, lens, cumw, seeds, 5,
                                                op_trace=trace)
        t_words, t_lens = _port_generate(data, lens, cumw, seeds, 5)
        assert np.array_equal(t_words, h_words)
        assert np.array_equal(t_lens, h_lens)
    assert set(trace) == set(range(hostref.N_OPS))


@pytest.mark.parametrize("batch", [0, 1, 1000])
def test_lane_seeds_match_jax_and_scalar_spec(batch):
    from wtf_tpu_torch.utils.hashing import MASK64, mix64

    for seed in SEEDS + [0]:
        got = hostref.lane_seeds(seed, batch, 33)
        assert np.array_equal(got, jhostref.lane_seeds(seed, batch, 33))
        for lane in range(33):
            want = mix64((seed + hostref.GOLDEN
                          * (batch * 33 + lane + 1)) & MASK64)
            assert int(got[lane, 0]) == want & 0xFFFFFFFF
            assert int(got[lane, 1]) == want >> 32
        # the int64 form generate takes is the same 64-bit value
        as_i64 = seeds_from_pairs(got, "cpu").numpy().view(np.uint64)
        assert np.array_equal(
            as_i64, got[:, 0].astype(np.uint64)
            | (got[:, 1].astype(np.uint64) << np.uint64(32)))


def test_device_corpus_slab_semantics():
    """add/dedup/evict as the JAX class: zero padding, favored entries
    out-rank plain seeds and survive eviction; the device tensors are
    copies re-made only after an add, and arrays_pair keeps the view as
    last uploaded."""
    from wtf_tpu.devmut.corpus import DeviceCorpus as JCorpus

    c, jc = DeviceCorpus(slots=3, max_len=16), JCorpus(slots=3, max_len=16)
    for data, weight in ((b"AAAA", 1), (b"AAAA", 1),
                         (b"BBBBBBBB", hostref.FAVOR_WEIGHT), (b"CC", 1),
                         (b"DDDD", 2), (b"E" * 64, 1),
                         (b"CC", hostref.FAVOR_WEIGHT)):
        assert c.add(data, weight) == jc.add(data, weight)
        assert np.array_equal(c._data, jc._data)
        assert np.array_equal(c._len, jc._len)
        assert np.array_equal(c._weight, jc._weight)
        assert np.array_equal(c.cumulative_weights(),
                              jc.cumulative_weights())
    assert len(c) == 3
    assert not c._data[0].view(np.uint8)[4:].any()
    data, lens, cumw, synced = c.arrays()
    assert synced and data.dtype == torch.int32 and cumw.dtype == torch.int64
    assert np.array_equal(data.numpy().view(np.uint32), c._data)
    assert np.array_equal(cumw.numpy(), c.cumulative_weights())
    assert not c.arrays()[3]
    # an add after the upload reaches neither the uploaded tensors nor
    # the as-uploaded view, and the undo log rebuilds that view
    before = data.clone()
    assert c.add(b"FFFFFF", weight=hostref.FAVOR_WEIGHT)
    assert torch.equal(data, before)
    old, cur, synced = c.arrays_pair()
    assert synced and torch.equal(old[0], before)
    assert np.array_equal(cur[0].numpy().view(np.uint32), c._data)
    assert not torch.equal(cur[0], before)
    c.add(b"GG")
    up = c.uploaded_state()
    assert np.array_equal(up["data"], cur[0].numpy().view(np.uint32))


# ---------------------------------------------------------------------------
# the insert seam
# ---------------------------------------------------------------------------

def _runners(slots):
    from wtf_tpu.harness import demo_tlv as jtlv
    from wtf_tpu.interp.runner import Runner as JRunner
    from wtf_tpu_torch.harness import demo_tlv
    from wtf_tpu_torch.interp.runner import Runner

    jr = JRunner(jtlv.build_snapshot(), n_lanes=4, chunk_steps=32,
                 overlay_slots=slots)
    tr = Runner(demo_tlv.build_snapshot(), n_lanes=4, overlay_slots=slots,
                device="cpu")
    return jr, tr


def _batch(seed):
    rng = np.random.RandomState(seed)
    words = rng.randint(0, 1 << 32, (4, 24), dtype=np.uint64) \
        .astype(np.uint32)
    lens = rng.randint(1, 97, 4).astype(np.int32)
    return words, lens


def _insert_both(jr, tr, words, lens):
    from wtf_tpu_torch.harness.demo_tlv import INPUT_GVA

    pfns = [tr.view().translate(0, INPUT_GVA) >> 12]
    jpfns = [jr.view().translate(0, INPUT_GVA) >> 12]
    assert pfns == jpfns
    jr.device_insert(jnp.asarray(words), jnp.asarray(lens), pfns, INPUT_GVA,
                     len_gpr=2, ptr_gpr=6)
    tr.device_insert(torch.tensor(words.view(np.int32)), torch.tensor(lens),
                     pfns, INPUT_GVA, len_gpr=2, ptr_gpr=6)
    tp.assert_machines_equal(jr.machine, tr.machine, where="device_insert")
    return pfns


def test_device_insert_on_a_fresh_restore():
    from wtf_tpu_torch.harness.demo_tlv import INPUT_GVA

    jr, tr = _runners(8)
    words, lens = _batch(1)
    pfns = _insert_both(jr, tr, words, lens)
    view = tr.view()
    for lane in range(4):
        raw = words[lane].tobytes()
        assert view.virt_read(lane, INPUT_GVA, 96) == raw
        assert view.get_reg(lane, 2) == lens[lane]
        assert view.get_reg(lane, 6) == INPUT_GVA
    # a second batch after restore claims the same rows again
    jr.restore(), tr.restore()
    _insert_both(jr, tr, *_batch(2))
    assert int((tr.machine.overlay.pfn[0] == pfns[0]).sum()) == 1


def test_device_insert_retires_a_pushed_input_write():
    """Host writes pushed before the insert: one outside the input region
    survives, one inside it is retired (the testcase wins)."""
    from wtf_tpu_torch.harness.demo_tlv import INPUT_GVA, SCRATCH_GVA

    jr, tr = _runners(8)
    for r in (jr, tr):
        view = r.view()
        view.virt_write(0, SCRATCH_GVA, b"INITDATA")
        view.virt_write(0, INPUT_GVA, b"STALEINPUT")
        view.virt_write(2, INPUT_GVA + 0x800, b"STALE2")
        r.push(view)
    tp.assert_machines_equal(jr.machine, tr.machine, where="push")
    words, lens = _batch(3)
    pfns = _insert_both(jr, tr, words, lens)
    view = tr.view()
    assert view.virt_read(0, SCRATCH_GVA, 8) == b"INITDATA"
    assert view.virt_read(0, INPUT_GVA, 96) == words[0].tobytes()
    assert view.virt_read(2, INPUT_GVA + 0x800, 6) == bytes(6)
    assert int((tr.machine.overlay.pfn[0] == pfns[0]).sum()) == 1
    assert int((tr.machine.overlay.pfn[0] == -1).sum()) == 8 - 2


def test_device_insert_overlay_full():
    """A lane whose pushed writes used every overlay row gets no insert
    and goes OVERLAY_FULL; the other lanes insert normally."""
    from wtf_tpu_torch.core.results import StatusCode
    from wtf_tpu_torch.harness.demo_tlv import SCRATCH_GVA, STACK_TOP

    jr, tr = _runners(4)
    for r in (jr, tr):
        view = r.view()
        for gva in (SCRATCH_GVA, STACK_TOP - 0x2000, STACK_TOP - 0x3000,
                    STACK_TOP - 0x4000):
            view.virt_write(1, gva, b"FULL")
        view.virt_write(3, SCRATCH_GVA, b"ONE")
        r.push(view)
    _insert_both(jr, tr, *_batch(4))
    st = tr.machine.status.tolist()
    assert st[1] == int(StatusCode.OVERLAY_FULL)
    assert st.count(int(StatusCode.RUNNING)) == 3
    assert tr.machine.overlay.overflow.tolist() == [False, True, False, False]
