"""Corpus: the set of coverage-increasing testcases.

Reference `Corpus_t` (src/wtf/corpus.h): an in-memory vector of buffers with
uniform-random `PickTestcase` (corpus.h:89-102) and digest-named saves into
outputs/ (corpus.h:56-87; names are content hashes so re-finding the same
input is a no-op).
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import List, Optional, Tuple

from wtf_tpu_torch.utils.hashing import hex_digest


class Corpus:
    def __init__(self, outputs_dir: Optional[Path] = None,
                 rng: Optional[random.Random] = None, store=None):
        self.outputs_dir = Path(outputs_dir) if outputs_dir else None
        if self.outputs_dir:
            self.outputs_dir.mkdir(parents=True, exist_ok=True)
        self.rng = rng or random.Random()
        # content-addressed store (wtf_tpu/fleet/store.FleetStore): when
        # attached, the store is the system of record and the flat
        # outputs/ dir becomes a hardlink VIEW of it — same digest-named
        # files for the seed replay scan and minset pruning, but writes
        # land once, journaled, in the sharded blob tree
        self.store = store
        self._items: List[bytes] = []
        self._digests = set()
        self.bytes_total = 0

    def add(self, data: bytes) -> bool:
        """Insert + persist; returns False for duplicates (content hash)."""
        return self.add_digested(data, hex_digest(data))

    def add_digested(self, data: bytes, digest: str) -> bool:
        """`add` for callers that already hold the content digest."""
        if digest in self._digests:
            return False
        self._digests.add(digest)
        self._items.append(data)
        self.bytes_total += len(data)
        if self.store is not None:
            self.store.put(data, kind="corpus")
            if self.outputs_dir:
                self.store.link_into(self.outputs_dir, digest)
        elif self.outputs_dir:
            # atomic: a campaign killed mid-save must not leave a torn
            # outputs/ entry for the restarted master to replay (the
            # file IS the persistence the resume path relies on)
            from wtf_tpu_torch.utils.atomicio import atomic_write_bytes

            atomic_write_bytes(self.outputs_dir / digest, data)
        return True

    def clear(self) -> None:
        """Drop every in-memory testcase (checkpoint restore rebuilds the
        corpus in manifest order).  Persisted outputs/ files stay — they
        are content-addressed and the restore re-adds by digest."""
        self._items.clear()
        self._digests.clear()
        self.bytes_total = 0

    def pick(self) -> Optional[bytes]:
        """Uniform random pick (corpus.h:89-102); None while empty."""
        if not self._items:
            return None
        return self.rng.choice(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    @property
    def digests(self) -> set:
        return set(self._digests)

    @staticmethod
    def load_dir(path: Path, rng: Optional[random.Random] = None,
                 outputs_dir: Optional[Path] = None) -> "Corpus":
        """Seed from a directory of input files, biggest first (the
        reference master replays inputs/ sorted by size, server.h:399-414)."""
        corpus = Corpus(outputs_dir=outputs_dir, rng=rng)
        # with_data: each file is read exactly once (seed_paths already
        # read+digested it; a second read_bytes would double startup I/O
        # and open a TOCTOU window between digest and content)
        for _f, digest, data in seed_paths([path], with_data=True):
            corpus.add_digested(data, digest)
        return corpus


def seed_paths(dirs, with_data: bool = False,
               keep_dups: bool = False) -> List[tuple]:
    """Seed files from one or more directories as (path, content digest)
    pairs — (path, digest, bytes) triples when `with_data` — size-sorted
    biggest first and content-deduped (the reference master's replay
    ordering, server.h:399-414): the ONE implementation of that policy.
    `keep_dups` keeps content-duplicate files in the listing (callers
    that also need the full directory census, e.g. minset pruning).
    Without `with_data`, bytes are read transiently for digesting; files
    vanishing mid-scan are skipped either way."""
    sized = []
    for d in dirs:
        if not (d and Path(d).is_dir()):
            continue
        for p in Path(d).iterdir():
            try:
                if p.is_file():
                    sized.append((p.stat().st_size, p))
            except OSError:
                continue  # vanished mid-scan
    seen, out = set(), []
    for _, p in sorted(sized, key=lambda t: t[0], reverse=True):
        try:
            data = p.read_bytes()
        except OSError:
            continue  # vanished mid-scan
        digest = hex_digest(data)
        if keep_dups or digest not in seen:
            seen.add(digest)
            out.append((p, digest, data) if with_data else (p, digest))
    return out
