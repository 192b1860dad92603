"""Hashing utilities: testcase digests and coverage hashes.

The reference names corpus/crash files by BLAKE3 hex digest
(src/wtf/utils.cc:279-300) and hashes coverage edges with splitmix64
(src/wtf/bochscpu_backend.cc:699-728).  We use blake2b (CPython's native C
implementation) for file digests — the digest choice is an internal detail,
not a wire contract — and reimplement splitmix64 both host-side (here) and
device-side (wtf_tpu/interp/coverage math) so hashes agree bit-for-bit.
"""

from __future__ import annotations

import hashlib

MASK64 = (1 << 64) - 1


def hex_digest(data: bytes) -> str:
    """Stable content digest used for corpus/crash filenames."""
    return hashlib.blake2b(data, digest_size=32).hexdigest()


def splitmix64(x: int) -> int:
    """Full splitmix64 step (increment + finalizer).  Used for internal hash
    tables (decode-cache probing); NOT the edge hash — the reference's edge
    mix skips the additive increment (see mix64)."""
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    return mix64(x)


def mix64(z: int) -> int:
    """splitmix64's mixing steps only (no increment) — bit-for-bit the chain
    the reference's RecordEdge applies to RIP
    (src/wtf/bochscpu_backend.cc:699-728).  Must match the device-side
    version in wtf_tpu/interp/step.py exactly."""
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return (z ^ (z >> 31)) & MASK64


def edge_hash(rip: int, next_rip: int) -> int:
    """Edge identity: mix64(rip) xor next_rip — bit-for-bit the reference's
    RecordEdge (bochscpu_backend.cc:699-724)."""
    return (mix64(rip) ^ next_rip) & MASK64
