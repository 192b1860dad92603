"""Mutation engines.

Reference surface (src/wtf/mutator.h:10-20): `Mutator_t` with
`GetNewTestcase(corpus)` and `OnNewCoverage(testcase)` (cross-over seeding),
backed by two generic engines — LLVM libFuzzer's MutationDispatcher and the
honggfuzz mangle port (honggfuzz.cc:836) — plus per-target custom mutators
(fuzzer_tlv_server.cc:204-365).  This module provides original equivalents
of all three roles:

  ByteMutator      - libFuzzer-style single-op dispatch (erase / insert /
                     change byte / change bit / copy part / change ASCII
                     integer / cross-over)
  MangleMutator    - honggfuzz-style: several mutations per testcase drawn
                     from a wider op table (magic values, expands, shifts)
  TlvStructureMutator - structure-aware {type,len,payload} record mutator,
                     the example custom mutator for the demo_tlv target

All engines are seeded-deterministic (reference --seed, wtf.cc:108,363).
"""

from __future__ import annotations

import random
import struct
from typing import List, Optional

_MAGIC = [
    b"\x00", b"\xff", b"\x7f", b"\x80", b"\x01",
    b"\x00\x00", b"\xff\xff", b"\xff\x7f", b"\x00\x80",
    b"\x00\x00\x00\x00", b"\xff\xff\xff\xff", b"\xff\xff\xff\x7f",
    b"\x00\x00\x00\x80",
    b"\xff\xff\xff\xff\xff\xff\xff\xff",
    b"\x00\x00\x00\x00\x00\x00\x00\x80",
]


def generate_fresh(rng: random.Random, max_len: int) -> bytes:
    """Empty-corpus testcase synthesis, shared by every engine: 1..64
    random bytes, bounded by the campaign's max_len contract."""
    n = rng.randint(1, min(64, max(1, max_len)))
    return bytes(rng.randrange(256) for _ in range(n))


class Mutator:
    """Interface (reference mutator.h:10-20)."""

    def get_new_testcase(self, corpus) -> bytes:
        raise NotImplementedError

    def on_new_coverage(self, testcase: bytes) -> None:
        """Called when `testcase` produced new coverage; engines use it to
        seed cross-over (reference LibfuzzerMutator_t::SetCrossOverWith)."""

    # -- checkpoint/resume (wtf_tpu/resume) --------------------------------
    # Engine-private state beyond the shared campaign RNG (which the
    # checkpoint carries separately).  The default covers every host
    # engine here and the native binding: the only such state is the
    # cross-over seed.  Engines with more (devmut's slab + batch cursor)
    # override both.

    def checkpoint_state(self) -> dict:
        cross = getattr(self, "_cross", None)
        return {"cross": cross.hex() if cross else None}

    def restore_state(self, state: dict) -> None:
        if hasattr(self, "_cross"):
            cross = state.get("cross")
            self._cross = bytes.fromhex(cross) if cross else None


class ByteMutator(Mutator):
    """One mutation per testcase, libFuzzer-dispatch style."""

    def __init__(self, rng: random.Random, max_len: int):
        self.rng = rng
        self.max_len = max_len
        self._cross: Optional[bytes] = None

    def on_new_coverage(self, testcase: bytes) -> None:
        self._cross = testcase

    def get_new_testcase(self, corpus) -> bytes:
        base = corpus.pick() if corpus is not None else None
        if not base:
            return generate_fresh(self.rng, self.max_len)
        data = bytearray(base)
        self._mutate_once(data)
        return bytes(data[:self.max_len])

    def _mutate_once(self, data: bytearray) -> None:
        rng = self.rng
        op = rng.randrange(8)
        if op == 0 and len(data) > 1:          # erase range
            start = rng.randrange(len(data))
            count = rng.randint(1, max(1, len(data) - start))
            del data[start:start + count]
        elif op == 1 and len(data) < self.max_len:   # insert byte(s)
            pos = rng.randrange(len(data) + 1)
            data[pos:pos] = bytes(rng.randrange(256)
                                  for _ in range(rng.randint(1, 8)))
        elif op == 2 and data:                 # change byte
            data[rng.randrange(len(data))] = rng.randrange(256)
        elif op == 3 and data:                 # change bit
            pos = rng.randrange(len(data))
            data[pos] ^= 1 << rng.randrange(8)
        elif op == 4 and len(data) >= 2:       # copy part within
            src = rng.randrange(len(data))
            count = rng.randint(1, len(data) - src)
            dst = rng.randrange(len(data))
            data[dst:dst + count] = data[src:src + count]
            del data[self.max_len:]
        elif op == 5 and data:                 # change ASCII integer
            self._change_ascii_int(data)
        elif op == 6 and data:                 # interesting byte (libFuzzer
            pos = rng.randrange(len(data))     #  InterestingValues role)
            if rng.randrange(2):
                data[pos] = rng.choice((0x00, 0x01, 0x7F, 0x80, 0xFF, 0x20))
            else:
                data[pos] = 0x20 + rng.randrange(95)  # printable ascii
        else:                                  # cross-over
            other = self._cross
            if other and data:
                pos = rng.randrange(len(data))
                take = rng.randrange(len(other) + 1)
                data[pos:] = other[:take]
                del data[self.max_len:]
            elif data:
                data[rng.randrange(len(data))] = rng.randrange(256)

    def _change_ascii_int(self, data: bytearray) -> None:
        rng = self.rng
        digits = [i for i, b in enumerate(data) if 0x30 <= b <= 0x39]
        if not digits:
            data[rng.randrange(len(data))] = rng.randrange(256)
            return
        i = rng.choice(digits)
        data[i] = 0x30 + rng.randrange(10)


class MangleMutator(Mutator):
    """Several mutations per testcase from a wide op table, the
    honggfuzz-mangle approach (reference applies 5 per run, mutator.cc:66)."""

    N_PER_RUN = 5

    def __init__(self, rng: random.Random, max_len: int):
        self.rng = rng
        self.max_len = max_len
        self._cross: Optional[bytes] = None

    def on_new_coverage(self, testcase: bytes) -> None:
        self._cross = testcase

    def get_new_testcase(self, corpus) -> bytes:
        base = corpus.pick() if corpus is not None else None
        if not base:
            return generate_fresh(self.rng, self.max_len)
        data = bytearray(base)
        for _ in range(self.rng.randint(1, self.N_PER_RUN)):
            self._mangle(data)
            if not data:
                data = bytearray(b"\x00")
        return bytes(data[:self.max_len])

    def _mangle(self, data: bytearray) -> None:
        rng = self.rng
        op = rng.randrange(10)
        n = len(data)
        if op == 0 and n:                      # bit flip
            pos = rng.randrange(n)
            data[pos] ^= 1 << rng.randrange(8)
        elif op == 1 and n:                    # random byte
            data[rng.randrange(n)] = rng.randrange(256)
        elif op == 2 and n:                    # inc/dec byte
            pos = rng.randrange(n)
            data[pos] = (data[pos] + rng.choice((1, 255))) & 0xFF
        elif op == 3:                          # magic value splice
            magic = rng.choice(_MAGIC)
            if n >= len(magic):
                pos = rng.randrange(n - len(magic) + 1)
                data[pos:pos + len(magic)] = magic
        elif op == 4 and n >= 2:               # shift/copy block
            src = rng.randrange(n)
            count = rng.randint(1, min(n - src, 32))
            dst = rng.randrange(n)
            data[dst:dst] = data[src:src + count]
            del data[self.max_len:]
        elif op == 5 and n and len(data) < self.max_len:  # expand (dup tail)
            pos = rng.randrange(n)
            count = rng.randint(1, min(16, self.max_len - n))
            data[pos:pos] = bytes(data[pos:pos + count])
        elif op == 6 and n > 1:                # shrink
            start = rng.randrange(n)
            count = rng.randint(1, max(1, (n - start) // 2 or 1))
            del data[start:start + count]
        elif op == 7 and n >= 4:               # ascii-num rewrite
            pos = rng.randrange(n - 3)
            data[pos:pos + 4] = str(rng.randrange(10000)).zfill(4).encode()
        elif op == 8 and n >= 2:               # swap two bytes
            i, j = rng.randrange(n), rng.randrange(n)
            data[i], data[j] = data[j], data[i]
        else:                                  # cross-over splice
            other = self._cross
            if other and n:
                pos = rng.randrange(n)
                take = rng.randrange(min(len(other), self.max_len - pos) + 1)
                data[pos:pos + take] = other[:take]


class TlvStructureMutator(Mutator):
    """Structure-aware mutator for {type:u8, len:u8, payload} record lists
    (the example custom mutator role, fuzzer_tlv_server.cc:204-365):
    generates, duplicates, deletes and corrupts whole records — including
    the len-field lies that trigger parser overflows."""

    def __init__(self, rng: random.Random, max_len: int):
        self.rng = rng
        self.max_len = max_len

    def _parse(self, data: bytes) -> List[bytearray]:
        records, pos = [], 0
        while pos + 2 <= len(data):
            length = data[pos + 1]
            end = min(pos + 2 + length, len(data))
            records.append(bytearray(data[pos:end]))
            pos = end
        return records

    def _random_record(self) -> bytearray:
        rng = self.rng
        rtype = rng.choice((1, 2, 3, rng.randrange(256)))
        length = rng.choice((0, 1, 8, rng.randrange(64), rng.randrange(256)))
        payload = bytes(rng.randrange(256) for _ in range(min(length, 64)))
        return bytearray([rtype, length]) + payload

    def get_new_testcase(self, corpus) -> bytes:
        base = corpus.pick() if corpus is not None else None
        records = self._parse(base) if base else []
        rng = self.rng
        op = rng.randrange(5)
        if not records or op == 0:             # append fresh record
            records.append(self._random_record())
        elif op == 1:                          # duplicate a record
            records.append(bytearray(rng.choice(records)))
        elif op == 2 and len(records) > 1:     # delete a record
            records.pop(rng.randrange(len(records)))
        elif op == 3:                          # corrupt a len field
            rec = rng.choice(records)
            rec[1] = rng.randrange(256)
        else:                                  # mutate payload bytes
            rec = rng.choice(records)
            if len(rec) > 2:
                rec[2 + rng.randrange(len(rec) - 2)] = rng.randrange(256)
        out = b"".join(bytes(r) for r in records)
        return out[:self.max_len]

    def on_new_coverage(self, testcase: bytes) -> None:
        pass


def create_mutator(name: str, rng: random.Random, max_len: int) -> Mutator:
    """By-name factory (reference CLI picks libfuzzer vs honggfuzz)."""
    engines = {
        "byte": ByteMutator,
        "mangle": MangleMutator,
        "tlv": TlvStructureMutator,
    }
    if name not in engines:
        raise ValueError(f"unknown mutator {name!r} "
                         f"(known: {sorted(engines)})")
    return engines[name](rng, max_len)
