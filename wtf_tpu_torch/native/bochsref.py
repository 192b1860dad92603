"""The ctypes binding of bochsref.cc, the host interpreter of the bench's
denominator.

`bochsref.cc` is a byte-identical copy of wtf_tpu/native/bochsref.cc: a
small C++ x86-64 interpreter in the role bochs plays for the reference
fuzzer (flat memory, per-instruction coverage insert, per-exec restore),
run over the same demo_tlv code bytes and testcase stream as the device.
Its exec/s is the denominator a benchmark divides the card's by; this
module builds and binds it and does no measuring.

    vm = BochsRef.demo_tlv()            # None without a C++ compiler
    execs, instr, crashes = vm.campaign(testcases, limit=100_000)
    vm.close()
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

from wtf_tpu_torch.native import build_library

_U64, _U32 = ctypes.c_uint64, ctypes.c_uint32
_U8P = ctypes.POINTER(ctypes.c_uint8)


def load_library() -> Optional[ctypes.CDLL]:
    """libbochsref, built at first use, with its three entry points
    typed; None when no compiler can build it."""
    path = build_library("bochsref", ["bochsref.cc"])
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.bochsref_create.restype = ctypes.c_void_p
    lib.bochsref_create.argtypes = [ctypes.POINTER(_U64),
                                    ctypes.POINTER(_U64),
                                    ctypes.POINTER(_U8P), ctypes.c_int]
    lib.bochsref_campaign.restype = None
    lib.bochsref_campaign.argtypes = [
        ctypes.c_void_p, _U64, _U64, _U64, _U64, _U64,
        _U8P, ctypes.POINTER(_U32), ctypes.c_int, _U64, _U64,
        ctypes.POINTER(_U64), ctypes.POINTER(_U64), ctypes.POINTER(_U64)]
    lib.bochsref_destroy.restype = None
    lib.bochsref_destroy.argtypes = [ctypes.c_void_p]
    return lib


class BochsRef:
    """One interpreter VM over a set of (base, bytes) memory spans, with
    the entry point, stack, input, finish and scratch addresses of the
    harness it runs."""

    def __init__(self, lib: ctypes.CDLL, spans: Sequence[Tuple[int, bytes]],
                 rip: int, rsp: int, input_gva: int, finish_gva: int,
                 scratch_gva: int):
        self._lib = lib
        bases = (_U64 * len(spans))(*[base for base, _ in spans])
        sizes = (_U64 * len(spans))(*[len(data) for _, data in spans])
        bufs = [(ctypes.c_uint8 * len(data)).from_buffer_copy(data)
                for _, data in spans]
        datas = (_U8P * len(spans))(*[ctypes.cast(b, _U8P) for b in bufs])
        self._vm = lib.bochsref_create(bases, sizes, datas, len(spans))
        self.rip, self.rsp = rip, rsp
        self.input_gva, self.finish_gva = input_gva, finish_gva
        self.scratch_gva = scratch_gva

    @classmethod
    def demo_tlv(cls) -> Optional["BochsRef"]:
        """The VM of demo_tlv's snapshot (its code, finish stub, input,
        scratch and stack pages, the return address at rsp pointing at
        the finish stub); None without a compiler."""
        from wtf_tpu_torch.harness import demo_tlv as T

        lib = load_library()
        if lib is None:
            return None
        rsp = T.STACK_TOP - 0x1000
        stack_base = T.STACK_TOP - 0x8000
        stack = bytearray(0x9000)
        stack[rsp - stack_base:rsp - stack_base + 8] = \
            T.FINISH_GVA.to_bytes(8, "little")
        spans = [
            (T.CODE_GVA, T._GUEST_CODE.ljust(0x1000, b"\xcc")),
            (T.FINISH_GVA, b"\x90\xf4".ljust(0x1000, b"\xcc")),
            (T.INPUT_GVA, bytes(T.MAX_INPUT)),
            (T.SCRATCH_GVA, bytes(0x1000)),
            (stack_base, bytes(stack)),
        ]
        return cls(lib, spans, T.CODE_GVA, rsp, T.INPUT_GVA, T.FINISH_GVA,
                   T.SCRATCH_GVA)

    def campaign(self, testcases: Sequence[bytes], limit: int,
                 repeat: int = 1) -> Tuple[int, int, int]:
        """Run every testcase `repeat` times from the restored state, at
        most `limit` instructions each; returns (execs, instructions,
        crashes)."""
        flat = b"".join(testcases)
        buf = (ctypes.c_uint8 * max(len(flat), 1)).from_buffer_copy(
            flat or b"\x00")
        lens = (_U32 * len(testcases))(*[len(t) for t in testcases])
        execs, instr, crashes = _U64(0), _U64(0), _U64(0)
        self._lib.bochsref_campaign(
            self._vm, self.rip, self.rsp, self.input_gva, self.finish_gva,
            self.scratch_gva, ctypes.cast(buf, _U8P), lens, len(testcases),
            limit, repeat, ctypes.byref(execs), ctypes.byref(instr),
            ctypes.byref(crashes))
        return execs.value, instr.value, crashes.value

    def verdict(self, testcase: bytes, limit: int = 100_000) -> str:
        """"crash" or "ok" for one testcase (the interpreter has no
        timeout verdict: a testcase that runs out of `limit` is "ok")."""
        return "crash" if self.campaign([testcase], limit)[2] else "ok"

    def close(self) -> None:
        if self._vm:
            self._lib.bochsref_destroy(self._vm)
            self._vm = None
