"""Append-only content-addressed corpus/crash store.

The flat `outputs/` and `crashes/` directories scale poorly past a few
thousand entries (one directory, one file per testcase, no journal to
recover from) and give the master no dedup memory beyond what it holds
in RAM.  The fleet store is the durable half of the corpus/crash
service:

  blobs       <root>/<namespace>/blobs/<d0d1>/<digest> — content-
              addressed (utils.hashing.hex_digest, the ONE digest that
              also names flat outputs/ files) in 256-way fanout dirs,
              written atomically; a blob is immutable once written
  journal     <root>/<namespace>/manifest.jsonl — one JSON line per
              ACCEPTED blob in arrival order: digest, size, kind
              (corpus/crash), the reported name and triage bucket for
              crashes.  Append-only with a torn-tail-tolerant loader
              (same contract as the telemetry JSONL)
  dedup       content dedup on write (digest already journaled = a
              `fleet.store_dedup` hit, no I/O); crash intake
              additionally dedups by the triage bucket — only
              novel buckets are persisted and announced
  namespaces  `namespace(name)` opens a sibling store under the same
              root — the per-tenant isolation seam (multi-tenancy)
  fsck        `verify(repair=True)` recovers after torn writes or a
              lost journal: blobs failing their digest name are
              quarantined (.torn suffix), journal entries whose blob
              vanished are dropped, orphan blobs are re-journaled

Flat views: `link_into(dir, digest)` materializes a blob in a flat
directory (hardlink when the filesystem allows, copy otherwise) — how
`outputs/` and `crashes/` remain byte-compatible views for the seed
replay scan, minset pruning, and operators' eyeballs while the store is
the system of record.
"""

from __future__ import annotations

import json
import logging
import os
import re
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

from wtf_tpu_torch.utils.atomicio import atomic_write_bytes
from wtf_tpu_torch.utils.hashing import hex_digest

log = logging.getLogger(__name__)

_NS_RE = re.compile(r"^[A-Za-z0-9_.-]+$")


class StoreError(RuntimeError):
    pass


class FleetStore:
    def __init__(self, root, namespace: str = "default",
                 registry=None, events=None):
        if not _NS_RE.match(namespace):
            raise StoreError(f"bad store namespace {namespace!r}")
        self.root = Path(root)
        self.ns = namespace
        self.dir = self.root / namespace
        self.blob_dir = self.dir / "blobs"
        self.journal_path = self.dir / "manifest.jsonl"
        self.registry = registry
        self.events = events
        self._digests: Dict[str, dict] = {}
        self._buckets: Dict[str, str] = {}  # bucket -> first digest
        self._load_journal()

    # -- journal ---------------------------------------------------------
    def _load_journal(self) -> None:
        if not self.journal_path.exists():
            return
        for line in self.journal_path.read_text(
                encoding="utf-8", errors="replace").splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                # torn tail from a kill mid-append: everything before it
                # is intact (one record per line), the partial line is
                # simply re-earned on the next put
                log.warning("store %s: torn journal tail ignored", self.ns)
                break
            self._index(rec)

    def _index(self, rec: dict) -> None:
        digest = rec.get("digest", "")
        if digest:
            self._digests.setdefault(digest, rec)
        bucket = rec.get("bucket")
        if bucket:
            self._buckets.setdefault(bucket, digest)

    def _append_journal(self, rec: dict) -> None:
        self.dir.mkdir(parents=True, exist_ok=True)
        with open(self.journal_path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(rec, sort_keys=True) + "\n")
            fh.flush()
            os.fsync(fh.fileno())

    # -- blobs -----------------------------------------------------------
    def blob_path(self, digest: str) -> Path:
        return self.blob_dir / digest[:2] / digest

    def _count(self, name: str, n: int = 1) -> None:
        if self.registry is not None:
            self.registry.counter(name).inc(n)

    def put(self, data: bytes, kind: str = "corpus",
            name: Optional[str] = None,
            bucket: Optional[str] = None) -> Tuple[str, bool]:
        """Store one blob; returns (digest, accepted).  Content
        duplicates cost nothing (`fleet.store_dedup`); crash blobs with
        a known triage bucket are dropped entirely
        (`fleet.bucket_dedup`) — only novel buckets persist."""
        digest = hex_digest(data)
        if digest in self._digests:
            self._count("fleet.store_dedup")
            return digest, False
        if kind == "crash" and bucket and bucket in self._buckets:
            self._count("fleet.bucket_dedup")
            return digest, False
        path = self.blob_path(digest)
        if not path.exists():
            atomic_write_bytes(path, data)
        rec = {"digest": digest, "size": len(data), "kind": kind}
        if name:
            rec["name"] = name
        if bucket:
            rec["bucket"] = bucket
        self._append_journal(rec)
        self._index(rec)
        self._count("fleet.store_puts")
        if self.events is not None:
            self.events.emit("store-put", store=self.ns, kind=kind,
                             digest=digest, size=len(data),
                             bucket=bucket or None)
        return digest, True

    def get(self, digest: str) -> bytes:
        data = self.blob_path(digest).read_bytes()
        if hex_digest(data) != digest:
            raise StoreError(f"blob {digest[:16]}… fails its digest "
                             "(torn write?)")
        return data

    def has(self, digest: str) -> bool:
        return digest in self._digests

    def has_bucket(self, bucket: str) -> bool:
        return bucket in self._buckets

    def __len__(self) -> int:
        return len(self._digests)

    def records(self, kind: Optional[str] = None) -> Iterator[dict]:
        """Journal records in arrival order (optionally one kind)."""
        for rec in self._digests.values():
            if kind is None or rec.get("kind") == kind:
                yield rec

    @property
    def buckets(self) -> Dict[str, str]:
        return dict(self._buckets)

    # -- flat views ------------------------------------------------------
    def link_into(self, directory, digest: str,
                  name: Optional[str] = None) -> Path:
        """Materialize a blob as `<directory>/<name or digest>` — the
        flat-view seam that keeps outputs//crashes/ byte-compatible.
        Hardlink when possible (no data copied), atomic copy otherwise."""
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        dest = directory / (name or digest)
        if dest.exists():
            return dest
        try:
            os.link(self.blob_path(digest), dest)
        except OSError:
            atomic_write_bytes(dest, self.get(digest))
        return dest

    # -- namespaces (tenancy) --------------------------------------------
    def namespace(self, name: str) -> "FleetStore":
        """A sibling store under the same root — per-tenant corpus and
        crash spaces share the fanout tree layout but nothing else."""
        return FleetStore(self.root, namespace=name,
                          registry=self.registry, events=self.events)

    # -- recovery --------------------------------------------------------
    def verify(self, repair: bool = False) -> dict:
        """fsck: walk every blob, check content against its digest name,
        and reconcile with the journal.  With `repair`: quarantine torn
        blobs (renamed `<digest>.torn`), drop journal entries whose blob
        is missing or torn, journal orphan blobs (valid content, no
        record — e.g. the journal itself was lost).  The journal is then
        rewritten atomically.  Returns the report dict the RUNBOOK drill
        prints."""
        report = {"blobs": 0, "ok": 0, "torn": [], "missing": [],
                  "orphans": [], "repaired": repair}
        on_disk = {}
        if self.blob_dir.exists():
            for sub in sorted(self.blob_dir.iterdir()):
                if not sub.is_dir():
                    continue
                for p in sorted(sub.iterdir()):
                    if p.suffix == ".torn" or not p.is_file():
                        continue
                    report["blobs"] += 1
                    try:
                        data = p.read_bytes()
                    except OSError:
                        continue
                    if hex_digest(data) != p.name:
                        report["torn"].append(p.name)
                        if repair:
                            p.replace(p.with_name(p.name + ".torn"))
                        continue
                    on_disk[p.name] = len(data)
                    report["ok"] += 1
        for digest in list(self._digests):
            if digest not in on_disk:
                report["missing"].append(digest)
                if repair:
                    del self._digests[digest]
        for digest, size in on_disk.items():
            if digest not in self._digests:
                report["orphans"].append(digest)
                if repair:
                    self._index({"digest": digest, "size": size,
                                 "kind": "corpus", "recovered": True})
        if repair:
            self._buckets = {}
            lines = []
            for rec in self._digests.values():
                self._index(rec)
                lines.append(json.dumps(rec, sort_keys=True))
            from wtf_tpu_torch.utils.atomicio import atomic_write_text

            atomic_write_text(self.journal_path,
                              "\n".join(lines) + ("\n" if lines else ""))
        return report
