"""DevMangleMutator: the `devmangle` engine behind the Mutator contract.

The counterpart of wtf_tpu/devmut/mutator.py.  Where every other engine's
`get_new_testcase` returns host bytes for the backend to insert lane by
lane, this one generates the WHOLE batch on the runner's device
(devmut/engine.py) and hands the batched `[lanes, words]` tensor straight
to the Runner's insert seam.  Host code only ever pulls the few lanes the
harvest wants (crashes, new coverage) via `fetch`.

Double buffering: `prelaunch()` generates batch N+1 while the host is
still harvesting batch N, before N's finds enter the slab, so batch N+1
samples the slab as of batch N-1's harvest — the one-batch lag of a
pipelined generator.  PyTorch runs the generation when it is called (on a
CUDA device it is queued behind batch N's work), so the call order alone
carries the lag.

Determinism: the whole stream is a pure function of (campaign seed,
batch index, lane) via hostref.lane_seeds, and slab evolution is
host-ordered — a seeded `--mutator devmangle` campaign replays exactly,
and equals the JAX package's at the same seed.  `checkpoint_state` /
`restore_state` carry the stream across a campaign checkpoint
(wtf_tpu_torch/resume) and a supervisor's rebuild (wtf_tpu_torch/
supervise).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from wtf_tpu_torch import telemetry
from wtf_tpu_torch.devmut import hostref
from wtf_tpu_torch.devmut.corpus import DeviceCorpus
from wtf_tpu_torch.devmut.engine import seeds_from_pairs
from wtf_tpu_torch.fuzz.mutator import Mutator
from wtf_tpu_torch.telemetry import NULL, Registry, StatsDict


class DevMangleMutator(Mutator):
    """Device-resident mangle engine (fuzz.mutator name: "devmangle")."""

    is_device = True

    def __init__(self, seed: int, max_len: int, rounds: int = 5,
                 slots: int = 256):
        self.seed = seed & ((1 << 64) - 1)
        self.max_len = max_len
        self.rounds = rounds
        self.slots = slots
        self.corpus: Optional[DeviceCorpus] = None
        self.spec = None
        self.pfns: List[int] = []
        self.n_lanes = 0
        self._batch = 0
        self._pending: Optional[Tuple] = None
        self._current: Optional[Tuple] = None
        self.registry: Registry = Registry()
        self.events = NULL
        self.stats: Optional[StatsDict] = None

    # -- device binding ----------------------------------------------------
    def bind(self, backend, target, registry: Optional[Registry] = None,
             events=None) -> None:
        """Attach to the batched backend + target insert spec.  Called by
        FuzzLoop before the first batch; raises early (with the fix) for
        backends/targets that can't run the device path."""
        spec = getattr(target, "device_insert", None)
        if spec is None:
            raise ValueError(
                f"target {getattr(target, 'name', target)!r} has no "
                "device_insert spec — devmangle needs the declarative "
                "insert seam (harness.targets.DeviceInsertSpec)")
        runner = getattr(backend, "runner", None)
        if runner is None or not hasattr(backend, "run_batch_device"):
            raise ValueError(
                "devmangle requires the batched GpuBackend; host backends "
                "have no device to generate on")
        self.registry, self.events = telemetry.resolve(
            backend, registry, events)
        self.stats = StatsDict(
            self.registry, "devmut",
            fields=("batches", "generated", "fetched", "corpus_syncs"),
            gauges=("corpus_slots",))
        self.max_len = min(self.max_len, spec.max_len)
        self.corpus = DeviceCorpus(self.slots, self.max_len,
                                   device=runner.device)
        self.spec = spec
        self.runner = runner
        self.n_lanes = runner.n_lanes
        # input-region pfns through the first lane's page tables — the
        # snapshot mapping is static, so translate ONCE at bind time and
        # the insert seam never page-walks again
        page = 4096
        n_pages = (self.max_len + page - 1) // page
        view = runner.view()
        lane = self.first_lane()
        self.pfns = [view.translate(lane, spec.gva + i * page) >> 12
                     for i in range(n_pages)]

    def first_lane(self) -> int:
        """The first lane this engine fills (a tenant-scoped engine,
        wtf_tpu_torch/tenancy, fills a lane range of a mixed batch)."""
        return 0

    def seed_from(self, corpus) -> int:
        """Load a host Corpus' testcases into the device slab (campaign
        startup: inputs/ seeds).  Returns how many entered."""
        n = 0
        for data in corpus:
            n += bool(self.corpus.add(data))
        return n

    # -- batch generation --------------------------------------------------
    def _dispatch(self) -> Tuple:
        data, lens, cumw, synced = self.corpus.arrays()
        if synced:
            self.stats["corpus_syncs"] += 1
        self.stats["corpus_slots"] = len(self.corpus)
        seeds = seeds_from_pairs(
            hostref.lane_seeds(self.seed, self._batch, self.n_lanes),
            self.runner.device)
        # through the runner's supervisor, waited on (the JAX package
        # leaves its prelaunch unwaited, for the overlap with the
        # harvest): the harvest's fetch right after a prelaunch reads the
        # device anyway, so the wait costs nothing here, and without it a
        # hang would block that read, outside every seam
        out = self.runner.supervisor.dispatch(
            "devmut-generate", self.generate, self.rounds,
            data, lens, cumw, seeds, sync=lambda o: o[1])
        self._batch += 1
        self.stats["batches"] += 1
        self.stats["generated"] += self.n_lanes
        return out

    def generate(self, rounds: int, data, lens, cumw, seeds):
        """One batch through the runner's generator (per shard on a
        mesh)."""
        return self.runner.devmut_generate(rounds, data, lens, cumw, seeds)

    def prelaunch(self) -> None:
        """Generate the NEXT batch now, from the slab as it stands (the
        double-buffer half that keeps the one-batch lag)."""
        if self._pending is None:
            self._pending = self._dispatch()

    def take_batch(self) -> Tuple:
        """The batch to execute now: the prelaunched one when present
        (the first batch generates inline).  Returns (words int32[L, W],
        lens int32[L]) on the runner's device."""
        if self._pending is None:
            self._pending = self._dispatch()
        self._current, self._pending = self._pending, None
        return self._current

    def current_batch(self) -> Tuple:
        """The batch taken for execution (what the insert seam writes)."""
        if self._current is None:
            raise RuntimeError("no device batch taken yet "
                               "(call take_batch first)")
        return self._current

    # -- megachunk window seams (wtf_tpu_torch/fuzz/megachunk.py) ----------
    def window_slabs(self) -> Tuple:
        """(slab_first, slab_rest) tensor triples for one megachunk
        window: the first batch samples the slab as the device LAST saw
        it — which the harvest pinned via `snapshot_entitled_slab` to
        exclude exactly the PREVIOUS window's final batch's finds (the
        prelaunch lag, preserved exactly) — later batches the current
        host slab."""
        first, rest, synced = self.corpus.arrays_pair()
        if synced:
            self.stats["corpus_syncs"] += 1
        self.stats["corpus_slots"] = len(self.corpus)
        return first, rest

    def window_seeds(self, n: int) -> torch.Tensor:
        """int64 [n, L] seeds for the next `n` batches of the stream —
        hostref.lane_seeds at consecutive ABSOLUTE batch indices, so the
        byte stream is the same whether batches are generated one at a
        time or in a window."""
        return seeds_from_pairs(np.stack([
            hostref.lane_seeds(self.seed, self._batch + j, self.n_lanes)
            for j in range(n)]), self.runner.device)

    def snapshot_entitled_slab(self) -> None:
        """Pin the slab view the NEXT window's FIRST batch is entitled
        to.  The prelaunch generates batch k+1 during batch k's harvest
        BEFORE k's finds are folded in, so batch k+1 samples finds <=
        k-1.  The harvest therefore calls this just BEFORE the window's
        final processed batch's corpus adds: the upload makes the
        as-uploaded view (window_slabs' slab_first) exclude exactly that
        batch's finds (free when nothing was added)."""
        *_rest, synced = self.corpus.arrays()
        if synced:
            self.stats["corpus_syncs"] += 1

    def consume_window(self, n: int) -> None:
        """Advance the stream cursor past `n` window-generated batches."""
        self._batch += n
        self._pending = None
        self.stats["batches"] += n
        self.stats["generated"] += n * self.n_lanes

    def cancel_pending(self) -> None:
        """Entering window mode with a prelaunched batch pending: drop it
        and REWIND the cursor so the window regenerates the same stream
        index — without the rewind, consume_window would skip one batch
        of the deterministic stream.  The slab's as-uploaded view (synced
        by that prelaunch, before any harvest adds) is exactly the view
        the window's first batch is entitled to."""
        if self._pending is not None:
            self._pending = None
            self._batch -= 1
            self.stats["batches"] -= 1
            self.stats["generated"] -= self.n_lanes

    def set_current(self, words, lens) -> None:
        """Point the harvest seam (fetch / current_batch) at one window
        batch's tensors — the window keeps the last two batches; the
        backend swaps each in before fetching its crash/new-coverage
        lanes."""
        self._current = (words, lens)

    # -- host harvest seam -------------------------------------------------
    def fetch(self, lanes: Sequence[int]) -> Dict[int, bytes]:
        """Pull the generated bytes of just `lanes` to the host (crash
        saving / corpus insertion) — one gather and one copy for all of
        them, the only point where testcase bytes leave the device."""
        if not lanes:
            return {}
        words, lens = self.current_batch()
        lane_list = [int(lane) for lane in lanes]
        sel = torch.tensor(lane_list, device=words.device)
        rows = words[sel].cpu().numpy().view(np.uint8)
        lens_h = lens[sel].cpu().numpy()
        out = {lane: rows[j].tobytes()[:int(lens_h[j])]
               for j, lane in enumerate(lane_list)}
        self.stats["fetched"] += len(lane_list)
        return out

    # -- checkpoint/resume (wtf_tpu_torch/resume) --------------------------
    def checkpoint_state(self) -> dict:
        """Everything a bit-identical resume of the device stream needs:
        the engine seed (drawn once from the campaign RNG at create time
        — the restored run must NOT redraw), the batch cursor, whether a
        prelaunched batch is in flight, and both slab views
        (DeviceCorpus.checkpoint_state).  The byte stream is a pure
        function of (seed, batch, lane, slab as uploaded), so this is
        sufficient: the restore regenerates the pending batch instead of
        persisting its bytes."""
        if self.corpus is None:
            raise RuntimeError("devmangle checkpoint before bind()")
        return {
            "seed": self.seed,
            "batch": self._batch,
            "pending": self._pending is not None,
            "slab": self.corpus.checkpoint_state(),
        }

    def restore_state(self, state: dict,
                      regenerate: Optional[bool] = None) -> None:
        """Install a checkpoint into a freshly-bound mutator (bind() and
        seed_from() already ran; their slab is discarded wholesale).  Any
        batch in flight is dropped.  Regenerates the prelaunched batch
        from the slab view the original run uploaded, then marks the
        slab stale so the next prelaunch uploads the current
        (post-harvest) view — exactly the upload the uninterrupted run
        would have paid.

        `regenerate` defaults to the checkpoint's own pending flag.  The
        supervisor's recovery passes True: a megachunk-boundary snapshot
        carries pending=False, but when the replay runs batch at a time
        (the ladder stepped below megachunk) the NEXT batch is still
        entitled to the as-uploaded slab view — without regeneration,
        take_batch's inline generation would upload the newer host slab
        (mark_stale below) and break the one-batch lag."""
        if self.corpus is None:
            raise RuntimeError("devmangle restore before bind()")
        self.seed = int(state["seed"]) & ((1 << 64) - 1)
        self.corpus.restore(state["slab"])
        self._current = None
        self._pending = None
        had_pending = bool(state.get("pending"))
        if had_pending if regenerate is None else regenerate:
            # _dispatch consumes the restored as-uploaded view; the cursor
            # of a pending=True checkpoint already counted the prelaunched
            # batch, a window-boundary one did not
            self._batch = int(state["batch"]) - (1 if had_pending else 0)
            if int(state["batch"]) == 0:
                # the snapshot predates the FIRST slab upload (no batch
                # generated yet): there is no as-uploaded view to honor —
                # the entitled view is a fresh sync of the current slab,
                # exactly the upload the inline take_batch generation
                # would have paid.  (The JAX package tests the uploaded
                # view's count instead, which is also 0 when a campaign
                # began with an empty corpus and uploaded it; it then
                # regenerates from a newer slab than the original run
                # sampled — ROADMAP C.)
                self.corpus.mark_stale()
            self._pending = self._dispatch()
        else:
            self._batch = int(state["batch"])
        self.corpus.mark_stale()

    # -- Mutator contract --------------------------------------------------
    def on_new_coverage(self, testcase: bytes) -> None:
        self.corpus.add(testcase, weight=hostref.FAVOR_WEIGHT)

    def get_new_testcase(self, corpus) -> bytes:
        raise RuntimeError(
            "devmangle generates whole batches on device; drive it "
            "through FuzzLoop's device path (or pick a host engine)")
