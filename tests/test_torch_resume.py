"""The port's checkpoint/resume (wtf_tpu_torch/resume) against the JAX
package's (wtf_tpu/resume), on the CPU; held against tests/test_resume.py.

  * the file format: atomic writes, the torn-file fallback to `.prev`,
    the digest and version gates
  * the devmangle demo_tlv campaign of 4 batches of 8 lanes (the shapes of
    tests/test_resume.py, fused step on in the port, the JAX side on its
    base chunk rung) checkpointed at every batch boundary: the port's
    uninterrupted run equals the JAX package's, and the campaign resumed
    from each interior boundary in a fresh loop equals it too —
    coverage/edge bytes, corpus order, crash names and buckets,
    testcases, new coverage, and the devmut byte stream of every
    remaining batch
  * the host-mangle engine resumed the same way, equal to the JAX run
  * the guard rails: a mismatched configuration, a torn corpus blob,
    ENOSPC on every write, a backend without device state
  * the CLI: `campaign --checkpoint-every 1` stopped after one batch and
    continued with `--resume` equals the uninterrupted CLI run, and the
    reference's refusals
  * the payload: at equal seeds and the same kill point the port's
    checkpoint.json payload equals the JAX package's, field for field,
    except for the counters listed in ONE_PACKAGE_COUNTERS

Every comparison is exact (integer state: tolerance 0).
"""

import json
import re
import shutil

import pytest

from tests.torchport import (
    build_port_tlv_campaign, campaign_fingerprint,
    checkpoint_at_every_boundary, record_devmut_stream,
)
from wtf_tpu.analysis.trace import build_tlv_campaign
from wtf_tpu_torch.resume import (
    CKPT_NAME, CheckpointError, load_campaign, restore_campaign,
)
from wtf_tpu_torch.resume import checkpoint as ck
from wtf_tpu_torch.testing.faultinject import (
    FaultPlan, chaos_checkpoint_io, fuzz_until_killed, tear_file,
)
from wtf_tpu_torch.utils.atomicio import atomic_write_bytes
from wtf_tpu_torch.utils.hashing import hex_digest

BUILD = dict(n_lanes=8, limit=20_000, chunk_steps=128, overlay_slots=16)
BATCHES = 4
RUNS = BUILD["n_lanes"] * BATCHES
SEED = 0x5EED
HOST_SEED = 0xAB

# Counters one package keeps and the other does not, left out of the
# payload comparison (the rest of the payload is compared field for
# field).  None at the compared configuration (devmangle, batch at a
# time, fused step off on both sides): both packages count the same
# campaign., backend., device., devmut. and runner. names.
ONE_PACKAGE_COUNTERS = ()


def _port(mutator="devmangle", seed=SEED, fused_step="on", **kw):
    return build_port_tlv_campaign(mutator=mutator, seed=seed,
                                   fused_step=fused_step, **{**BUILD, **kw})


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX package's devmangle campaign, checkpointed at every batch
    boundary: (fingerprint, devmut stream, dir of the per-boundary
    checkpoint copies)."""
    root = tmp_path_factory.mktemp("jax")
    loop = build_tlv_campaign(mutator="devmangle", seed=SEED, **BUILD)
    stream: list = []
    record_devmut_stream(loop, stream)
    checkpoint_at_every_boundary(loop, root / "ck", root / "at")
    loop.fuzz(RUNS)
    fp = campaign_fingerprint(loop)
    assert len(stream) == BATCHES and fp["cov_bits"] > 0
    return fp, stream, root / "at"


@pytest.fixture(scope="module")
def port_ref(tmp_path_factory):
    """The port's uninterrupted run of the same campaign, checkpointed
    at every batch boundary the same way."""
    root = tmp_path_factory.mktemp("port")
    loop = _port()
    stream: list = []
    record_devmut_stream(loop, stream)
    checkpoint_at_every_boundary(loop, root / "ck", root / "at")
    loop.fuzz(RUNS)
    return campaign_fingerprint(loop), stream, root / "at"


# ---------------------------------------------------------------------------
# file format: atomicity, torn detection, .prev fallback
# ---------------------------------------------------------------------------

def _doc(payload: dict) -> str:
    body = json.dumps(payload, sort_keys=True)
    return json.dumps({"format": ck.CKPT_FORMAT, "version": ck.CKPT_VERSION,
                       "digest": hex_digest(body.encode()),
                       "payload": body})


def test_format_constants_match_the_reference():
    from wtf_tpu.resume import checkpoint as jck

    assert (ck.CKPT_FORMAT, ck.CKPT_VERSION, ck.CKPT_NAME,
            ck.COUNTER_PREFIXES) == (jck.CKPT_FORMAT, jck.CKPT_VERSION,
                                     jck.CKPT_NAME, jck.COUNTER_PREFIXES)


def test_atomic_write_leaves_no_tmp(tmp_path):
    target = tmp_path / "sub" / "file.bin"
    atomic_write_bytes(target, b"payload")
    assert target.read_bytes() == b"payload"
    assert [p.name for p in target.parent.iterdir()] == ["file.bin"]
    atomic_write_bytes(target, b"replaced")  # overwrite is atomic too
    assert target.read_bytes() == b"replaced"


def test_torn_checkpoint_falls_back_to_prev(tmp_path):
    (tmp_path / CKPT_NAME).write_text(_doc({"batches": 9})[:40])  # torn
    (tmp_path / (CKPT_NAME + ".prev")).write_text(_doc({"batches": 3}))
    state, fell_back = load_campaign(tmp_path)
    assert fell_back and state["batches"] == 3


def test_digest_mismatch_detected(tmp_path):
    # same length, one payload byte flipped, still valid JSON: only the
    # embedded digest catches it
    doc = json.loads(_doc({"batches": 5}))
    doc["payload"] = doc["payload"].replace("5", "6")
    assert json.loads(doc["payload"]) == {"batches": 6}  # parses fine
    (tmp_path / CKPT_NAME).write_text(json.dumps(doc))
    with pytest.raises(CheckpointError, match="no usable checkpoint"):
        load_campaign(tmp_path)


def test_version_gate(tmp_path):
    body = json.dumps({"batches": 1})
    (tmp_path / CKPT_NAME).write_text(json.dumps({
        "format": ck.CKPT_FORMAT, "version": 99,
        "digest": hex_digest(body.encode()), "payload": body}))
    with pytest.raises(CheckpointError):
        load_campaign(tmp_path)


# ---------------------------------------------------------------------------
# kill-at-every-batch-boundary parity sweep
# ---------------------------------------------------------------------------

def test_uninterrupted_run_equals_jax(jax_ref, port_ref):
    """Checkpointing perturbs nothing, and the port's run is the JAX
    package's: state and the generated bytes of every batch."""
    assert port_ref[0] == jax_ref[0]
    assert port_ref[1] == jax_ref[1]


@pytest.mark.parametrize("kill_at", range(1, BATCHES))
def test_resume_parity_sweep_devmangle(jax_ref, port_ref, kill_at):
    """Resume in a fresh loop from the disk state a kill at batch
    boundary `kill_at` leaves: bit-identical coverage/corpus/crashes AND
    the exact generated bytes of every remaining batch."""
    ckpt = port_ref[2] / str(kill_at)
    resumed = _port()
    state, fell_back = load_campaign(ckpt)
    assert not fell_back
    assert restore_campaign(resumed, state, ckpt) == kill_at
    stream: list = []
    record_devmut_stream(resumed, stream)
    resumed.fuzz(RUNS)
    assert campaign_fingerprint(resumed) == jax_ref[0], \
        f"kill at batch {kill_at}: state diverged"
    assert stream == jax_ref[1][kill_at:], \
        f"kill at batch {kill_at}: generated bytes diverged"
    assert resumed.registry.counter("campaign.resumes").value == 1


def test_resume_parity_host_mangle(tmp_path):
    """The host-engine path: shared campaign RNG + cross-over seed +
    corpus order restore reproduce the stream exactly, and equal the JAX
    package's run."""
    runs = BUILD["n_lanes"] * 2
    ref = build_tlv_campaign(mutator="mangle", seed=HOST_SEED, **BUILD)
    ref.fuzz(runs)
    ckpt = tmp_path / "ck"
    victim = _port("mangle", HOST_SEED)
    victim.checkpoint_dir, victim.checkpoint_every = ckpt, 1
    fuzz_until_killed(victim, runs, kill_at_batch=1)
    resumed = _port("mangle", HOST_SEED)
    state, _ = load_campaign(ckpt)
    assert restore_campaign(resumed, state, ckpt) == 1
    resumed.fuzz(runs)
    assert campaign_fingerprint(resumed) == campaign_fingerprint(ref)


# ---------------------------------------------------------------------------
# guard rails
# ---------------------------------------------------------------------------

def test_resume_rejects_mismatched_config(port_ref):
    ckpt = port_ref[2] / "1"
    state, _ = load_campaign(ckpt)
    other = _port(n_lanes=4)
    with pytest.raises(CheckpointError, match="lanes"):
        restore_campaign(other, state, ckpt)


def test_corpus_blob_verified_on_restore(port_ref, tmp_path):
    ckpt = tmp_path / "ck"
    shutil.copytree(port_ref[2] / "2", ckpt)
    state, _ = load_campaign(ckpt)
    blobs = sorted((ckpt / "corpus").iterdir())
    assert blobs
    tear_file(blobs[0], keep_fraction=0.4)
    with pytest.raises(CheckpointError, match="digest|missing"):
        restore_campaign(_port(), state, ckpt)


def test_checkpoint_enospc_degrades_not_aborts(tmp_path):
    """A full disk mid-campaign loses checkpoints, not the campaign:
    warn + `checkpoint-write` error event, fuzzing continues."""
    events = []

    class _Capture:
        def emit(self, type, **fields):  # noqa: A002
            events.append({"type": type, **fields})

        def heartbeat(self, *a, **k):
            pass

    loop = _port(seed=3)
    loop.checkpoint_dir, loop.checkpoint_every = tmp_path / "ck", 1
    loop.events = _Capture()
    plan = FaultPlan(write_faults=range(0, 10_000))  # every write fails
    with chaos_checkpoint_io(plan):
        loop.fuzz(BUILD["n_lanes"])  # one batch
    assert loop.stats.testcases == BUILD["n_lanes"]
    kinds = [e for e in events if e["type"] == "error"
             and e.get("kind") == "checkpoint-write"]
    assert kinds, events
    assert plan.count_fired("write-fault") >= 1
    assert not (tmp_path / "ck" / CKPT_NAME).exists()


def test_checkpoint_requires_device_backend():
    import random as _random

    from wtf_tpu_torch.backend.emu import EmuBackend
    from wtf_tpu_torch.fuzz.corpus import Corpus
    from wtf_tpu_torch.fuzz.loop import FuzzLoop
    from wtf_tpu_torch.fuzz.mutator import MangleMutator
    from wtf_tpu_torch.harness import demo_tlv

    backend = EmuBackend(demo_tlv.build_snapshot())
    backend.initialize()
    with pytest.raises(ValueError, match="GpuBackend"):
        FuzzLoop(backend, demo_tlv.TARGET,
                 MangleMutator(_random.Random(1), 64), Corpus(),
                 checkpoint_dir="/tmp/x", checkpoint_every=1)


def test_fuzz_until_killed_is_a_real_boundary():
    """The harness kills AFTER the batch's checkpoint cadence — i.e. at
    the exact point a SIGKILL between batches lands."""
    loop = _port(seed=4)
    with pytest.raises(AssertionError):
        # campaign completes before the kill point: harness must say so
        fuzz_until_killed(loop, BUILD["n_lanes"], kill_at_batch=5)
    assert loop.batches_done == 1


# ---------------------------------------------------------------------------
# CLI plumbing
# ---------------------------------------------------------------------------

def _final_line(stdout: str) -> str:
    """The last `#N cov: .. corp: ..` stats line without its rate and
    uptime (the only fields that depend on the clock)."""
    line = [ln for ln in stdout.splitlines() if ln.startswith("#")][-1]
    return re.sub(r" exec/s: \S+| uptime: \S+", "", line)


def _cli_tree(root):
    return {p.relative_to(root).as_posix(): hex_digest(p.read_bytes())
            for sub in ("outputs", "crashes") if (root / sub).is_dir()
            for p in sorted((root / sub).iterdir())}


@pytest.mark.parametrize("seeded", [True, False])
def test_cli_checkpoint_resume_roundtrip(tmp_path, capsys, seeded):
    """`campaign --checkpoint-every 1` writes under <target>/checkpoint;
    stopped after its first batch and continued with `--resume`, it ends
    as the uninterrupted CLI run: the same final stats line, outputs/,
    crashes/ and verdict.  Unseeded, the campaign's first upload is of
    an empty slab: the JAX package's restore takes that for "never
    uploaded" and regenerates the pending batch from the newer slab
    (`#8 cov: 21 corp: 1` against the uninterrupted `#8 cov: 29 corp:
    2`, ROADMAP C); the port's resumes as the uninterrupted run."""
    from wtf_tpu_torch.cli import main

    argv = ["campaign", "--name", "demo_tlv", "--mutator", "devmangle",
            "--lanes", "4", "--seed", "9", "--limit", "20000",
            "--max_len", "64", "--fused-step", "on", "--device", "cpu"]
    whole, split = tmp_path / "whole", tmp_path / "split"
    for root in (whole, split) if seeded else ():
        # the reference test's seed input (tests/test_resume.py)
        (root / "inputs").mkdir(parents=True)
        (root / "inputs" / "seed").write_bytes(b"\x01\x04AAAA\x02\x08BBBBBBBB")
    rc_whole = main(argv + ["--runs", "8", "--target", str(whole)])
    line_whole = _final_line(capsys.readouterr().out)
    main(argv + ["--runs", "4", "--target", str(split),
                 "--checkpoint-every", "1"])
    capsys.readouterr()
    ckpt = split / "checkpoint"
    assert (ckpt / CKPT_NAME).exists()
    rc = main(argv + ["--runs", "8", "--target", str(split),
                      "--resume", str(ckpt)])
    out = capsys.readouterr().out
    assert "resumed at batch 1" in out
    assert (rc, _final_line(out)) == (rc_whole, line_whole)
    assert _cli_tree(split) == _cli_tree(whole)
    assert line_whole.startswith("#8 cov: ")


def test_cli_resume_guards(tmp_path):
    """The reference CLI's refusals, in its order: --checkpoint-every
    without a directory, and --resume with --runs 0 (before the port's
    own refusal of --runs 0)."""
    from wtf_tpu_torch.cli import main

    with pytest.raises(SystemExit, match="checkpoint-every"):
        main(["campaign", "--name", "demo_tlv", "--runs", "4",
              "--checkpoint-every", "1", "--device", "cpu"])
    with pytest.raises(SystemExit, match="minset"):
        main(["campaign", "--name", "demo_tlv", "--runs", "0",
              "--resume", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="--runs must be > 0"):
        main(["campaign", "--name", "demo_tlv", "--runs", "0",
              "--device", "cpu"])


# ---------------------------------------------------------------------------
# the payload against the JAX package's
# ---------------------------------------------------------------------------

def _payload(directory) -> dict:
    doc = json.loads((directory / CKPT_NAME).read_text())
    return json.loads(doc["payload"])


def test_checkpoint_payload_equals_jax(jax_ref, tmp_path):
    """At equal seeds and the same kill point (batch 2, both packages
    batch at a time with the fused step off), checkpoint.json's payload
    is the JAX package's field for field — the same JSON text for every
    field, the arrays' dtype strings included — but for the counters in
    ONE_PACKAGE_COUNTERS."""
    kill_at = 2
    victim = _port(fused_step="off")
    victim.checkpoint_dir, victim.checkpoint_every = tmp_path, 1
    fuzz_until_killed(victim, RUNS, kill_at_batch=kill_at)
    port = _payload(tmp_path)
    ref = _payload(jax_ref[2] / str(kill_at))
    for name in ONE_PACKAGE_COUNTERS:
        port["stats"].pop(name, None)
        ref["stats"].pop(name, None)
    assert sorted(port) == sorted(ref)
    for field in ref:
        assert json.dumps(port[field], sort_keys=True) == \
            json.dumps(ref[field], sort_keys=True), field
    # and the port reads the JAX package's checkpoint back into a run
    # that ends as the JAX run did
    resumed = _port()
    restore_campaign(resumed, load_campaign(jax_ref[2] / str(kill_at))[0],
                     jax_ref[2] / str(kill_at))
    resumed.fuzz(RUNS)
    assert campaign_fingerprint(resumed) == jax_ref[0]
