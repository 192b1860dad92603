"""Versioned campaign checkpoints: atomic save, torn-file-safe load.

A copy of wtf_tpu/resume/checkpoint.py (the same format, so a payload of
either package reads the same), with the imports and the backend's name
rewritten.

What a checkpoint carries (the minimal resumable state around the
persistent device loop — Concordia's shape, PAPERS.md):

  corpus     manifest of content digests in insertion order; the bytes
             live content-addressed under <dir>/corpus/<digest> (so
             repeated checkpoints re-write nothing that already exists,
             and the checkpoint is self-contained even when the campaign
             has no outputs/ dir)
  coverage   the backend's aggregate cov/edge bitmaps
  decode     the runner's decode cache in insertion order — coverage-
             bitmap bit i IS cache entry index i, so restored bitmaps
             are meaningless without identical indices
  mutator    engine state: cross-over seed for host engines; for devmut
             the engine seed, batch cursor, both slab views and the
             pending-batch flag (the prelaunched batch is REGENERATED on
             resume from the slab view it originally sampled)
  rng        the shared campaign random.Random state
  stats      campaign/backend/device/devmut/runner counters (telemetry
             continuity; campaign.testcases also drives the run budget)

File format: `checkpoint.json` = {"format", "version", "digest",
"payload"} where `payload` is the state as ONE canonical JSON string and
`digest` is its blake2b hex — a torn or bit-rotted file fails the digest
check instead of resuming silently wrong.  Writes go tmp+fsync+rename
(utils/atomicio) with the previous checkpoint rotated to `.prev`, and
the loader falls back to `.prev` when the newest file is torn.
"""

from __future__ import annotations

import base64
import json
import logging
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from wtf_tpu_torch.utils.atomicio import atomic_write_text
from wtf_tpu_torch.utils.hashing import hex_digest

log = logging.getLogger(__name__)

CKPT_VERSION = 1
CKPT_NAME = "checkpoint.json"
CKPT_FORMAT = "wtf-tpu-campaign-checkpoint"

# the resumable counter namespaces (Registry.counters_state)
COUNTER_PREFIXES = ("campaign.", "backend.", "device.", "devmut.",
                    "runner.", "dist.")


class CheckpointError(RuntimeError):
    """Unusable checkpoint: torn, version-mismatched, or inconsistent
    with the campaign it is being restored into."""


# ---------------------------------------------------------------------------
# JSON transport for binary state (numpy arrays, raw bytes)
# ---------------------------------------------------------------------------

def _jsonify(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return {"__nd__": base64.b64encode(obj.tobytes()).decode(),
                "dtype": str(obj.dtype), "shape": list(obj.shape)}
    if isinstance(obj, (bytes, bytearray)):
        return {"__bytes__": base64.b64encode(bytes(obj)).decode()}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return obj


def _unjsonify(obj):
    if isinstance(obj, dict):
        if "__nd__" in obj:
            raw = base64.b64decode(obj["__nd__"])
            return np.frombuffer(raw, dtype=np.dtype(obj["dtype"])).reshape(
                obj["shape"]).copy()
        if "__bytes__" in obj:
            return base64.b64decode(obj["__bytes__"])
        return {k: _unjsonify(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unjsonify(v) for v in obj]
    return obj


def _rng_state(rng) -> Optional[list]:
    if rng is None:
        return None
    version, internal, gauss = rng.getstate()
    return [version, list(internal), gauss]


def _set_rng_state(rng, state) -> None:
    if rng is None or state is None:
        return
    version, internal, gauss = state
    rng.setstate((version, tuple(internal), gauss))


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def _campaign_state(loop) -> dict:
    backend = loop.backend
    runner = getattr(backend, "runner", None)
    if runner is None or not hasattr(backend, "coverage_state"):
        raise CheckpointError(
            "checkpoint/resume needs the batched GpuBackend; this "
            "backend has no device state to checkpoint")
    cov, edge = backend.coverage_state()
    mutator = loop.mutator
    mut_rng = getattr(mutator, "rng", None)
    corpus_rng = getattr(loop.corpus, "rng", None)
    return {
        "config": {
            "target": getattr(loop.target, "name", None),
            "lanes": getattr(backend, "n_lanes", None),
            "mutator": type(mutator).__name__,
            "mesh_devices": getattr(getattr(backend, "mesh", None),
                                    "size", None),
        },
        "batches": loop.batches_done,
        "stats": loop.registry.counters_state(COUNTER_PREFIXES),
        "crash_names": sorted(loop.crash_names),
        # triage-grade dedup keys (triage/bucket.py): without
        # them a resumed campaign would re-announce known buckets as new
        "crash_buckets": sorted(loop.crash_buckets),
        "requeue": [data.hex() for data in loop._requeue],
        "requeue_digests": sorted(loop._requeue_digests),
        "rng": {
            "corpus": _rng_state(corpus_rng),
            # most campaigns share ONE campaign rng between corpus and
            # mutator; serialize the mutator's only when distinct
            "mutator": ("shared" if mut_rng is corpus_rng
                        else _rng_state(mut_rng)),
        },
        "mutator": mutator.checkpoint_state(),
        "coverage": {"cov": cov, "edge": edge},
        "runner": runner.checkpoint_state(),
        "corpus_manifest": [hex_digest(data) for data in loop.corpus],
    }


def write_checkpoint(state: dict, directory, corpus_items) -> dict:
    """The atomic persistence tail shared by whole-campaign checkpoints
    and the JAX package's per-tenant checkpoints: content-
    addressed corpus blobs (only new content costs a write), then the
    digest-embedded doc written tmp+fsync+rename with one `.prev`
    generation kept for torn-file fallback."""
    directory = Path(directory)
    blob_dir = directory / "corpus"
    blob_dir.mkdir(parents=True, exist_ok=True)
    from wtf_tpu_torch.utils.atomicio import atomic_write_bytes

    for digest, data in zip(state["corpus_manifest"], corpus_items):
        path = blob_dir / digest
        if not path.exists():
            atomic_write_bytes(path, data)
    payload = json.dumps(_jsonify(state), sort_keys=True)
    doc = json.dumps({
        "format": CKPT_FORMAT,
        "version": CKPT_VERSION,
        "digest": hex_digest(payload.encode()),
        "payload": payload,
    })
    path = directory / CKPT_NAME
    prev = directory / (CKPT_NAME + ".prev")
    if path.exists():
        path.replace(prev)  # keep one generation for torn-file fallback
    atomic_write_text(path, doc)
    return {"path": str(path), "bytes": len(doc),
            "batches": state.get("batches", 0)}


def save_campaign(loop, directory) -> dict:
    """Checkpoint `loop` into `directory` (created on demand).  Returns
    {"path", "bytes", "batches"}.  Atomic: a kill at any point leaves
    either the previous checkpoint, the new one, or the previous one
    under `.prev` with the new one complete — never a torn file that
    loads."""
    state = _campaign_state(loop)
    return write_checkpoint(state, directory, list(loop.corpus))


# ---------------------------------------------------------------------------
# load + restore
# ---------------------------------------------------------------------------

def _load_one(path: Path) -> dict:
    doc = json.loads(path.read_text(encoding="utf-8"))
    if doc.get("format") != CKPT_FORMAT:
        raise CheckpointError(f"{path}: not a campaign checkpoint")
    if doc.get("version") != CKPT_VERSION:
        raise CheckpointError(
            f"{path}: checkpoint version {doc.get('version')} "
            f"(this build reads {CKPT_VERSION})")
    payload = doc.get("payload", "")
    if hex_digest(payload.encode()) != doc.get("digest"):
        raise CheckpointError(f"{path}: digest mismatch (torn write?)")
    return _unjsonify(json.loads(payload))


def load_campaign(directory) -> Tuple[dict, bool]:
    """Load the newest usable checkpoint from `directory`.  Returns
    (state, fell_back) — fell_back is True when the newest file was torn
    and `.prev` was used.  Raises CheckpointError when neither loads."""
    directory = Path(directory)
    path = directory / CKPT_NAME
    prev = directory / (CKPT_NAME + ".prev")
    errors = []
    for candidate, fell_back in ((path, False), (prev, True)):
        if not candidate.exists():
            errors.append(f"{candidate}: missing")
            continue
        try:
            state = _load_one(candidate)
        except (CheckpointError, json.JSONDecodeError, OSError) as e:
            errors.append(str(e))
            log.warning("checkpoint unusable: %s", e)
            continue
        if fell_back:
            log.warning("newest checkpoint torn; resuming from %s "
                        "(one checkpoint interval of work re-executes)",
                        candidate)
        return state, fell_back
    raise CheckpointError(
        "no usable checkpoint in " + str(directory) + ": "
        + "; ".join(errors))


def _check_config(loop, state) -> None:
    cfg = state.get("config", {})
    checks = (
        ("target", getattr(loop.target, "name", None)),
        ("lanes", getattr(loop.backend, "n_lanes", None)),
        ("mutator", type(loop.mutator).__name__),
    )
    for key, current in checks:
        saved = cfg.get(key)
        if saved is not None and current is not None and saved != current:
            raise CheckpointError(
                f"checkpoint {key}={saved!r} but this campaign has "
                f"{key}={current!r} — resume needs the same target, "
                f"lane count, and mutation engine (mesh layout may "
                f"differ; streams are shard-count invariant)")


def restore_corpus(corpus, state, directory) -> None:
    """Rebuild the host corpus in manifest order from the checkpoint's
    content-addressed blobs, verifying each digest (a corrupt blob would
    silently fork the mutation stream)."""
    blob_dir = Path(directory) / "corpus"
    corpus.clear()
    for digest in state.get("corpus_manifest", []):
        path = blob_dir / digest
        try:
            data = path.read_bytes()
        except OSError as e:
            raise CheckpointError(f"corpus blob missing: {e}") from e
        if hex_digest(data) != digest:
            raise CheckpointError(
                f"corpus blob {digest[:16]}… fails its digest "
                "(torn write?)")
        corpus.add_digested(data, digest)


def restore_campaign(loop, state, directory) -> int:
    """Install a load_campaign() state into a freshly-built FuzzLoop
    (backend initialized, target init done, inputs possibly preloaded —
    preloads are discarded wholesale).  Returns the batch index the
    campaign resumes after."""
    _check_config(loop, state)
    restore_corpus(loop.corpus, state, directory)
    rng = state.get("rng", {})
    _set_rng_state(getattr(loop.corpus, "rng", None), rng.get("corpus"))
    mut_state = rng.get("mutator")
    if mut_state != "shared":
        _set_rng_state(getattr(loop.mutator, "rng", None), mut_state)
    loop.crash_names = set(state.get("crash_names", []))
    loop.crash_buckets = set(state.get("crash_buckets", []))
    loop._requeue = [bytes.fromhex(h) for h in state.get("requeue", [])]
    loop._requeue_digests = set(state.get("requeue_digests", []))
    runner = getattr(loop.backend, "runner", None)
    if runner is None:
        raise CheckpointError(
            "resume needs the batched GpuBackend")
    runner.restore_state(state.get("runner", {}))
    coverage = state.get("coverage", {})
    loop.backend.restore_coverage_state(coverage["cov"], coverage["edge"])
    # mutator last-but-one: devmut regeneration dispatches device work
    # whose stat side effects the counter restore below then overwrites
    loop.mutator.restore_state(state.get("mutator", {}))
    loop.registry.restore_counters(state.get("stats", {}))
    loop.batches_done = int(state.get("batches", 0))
    loop.registry.counter("campaign.resumes").inc()
    loop.events.emit("resume", batch=loop.batches_done,
                     testcases=loop.stats.testcases,
                     corpus=len(loop.corpus),
                     directory=str(directory))
    return loop.batches_done
