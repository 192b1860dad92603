"""NT guest-structure definitions and status codes.

Role of the reference's nt.h (src/wtf/nt.h, 342 LoC): the Windows-shaped
constants and struct layouts harness code needs to introspect a guest —
EXCEPTION_RECORD parsing for user-mode crash detection
(crash_detection_umode.cc:53-129), NTSTATUS codes for guest-fs hook
returns (fshooks.cc), IO_STATUS_BLOCK/OBJECT_ATTRIBUTES shapes, and the
exception-code pretty printer (utils.cc:416-472).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List

# -- NTSTATUS ----------------------------------------------------------------

STATUS_SUCCESS = 0x00000000
STATUS_PENDING = 0x00000103
STATUS_BUFFER_OVERFLOW = 0x80000005
STATUS_UNSUCCESSFUL = 0xC0000001
STATUS_NOT_IMPLEMENTED = 0xC0000002
STATUS_INVALID_HANDLE = 0xC0000008
STATUS_INVALID_PARAMETER = 0xC000000D
STATUS_NO_SUCH_FILE = 0xC000000F
STATUS_END_OF_FILE = 0xC0000011
STATUS_ACCESS_DENIED = 0xC0000022
STATUS_OBJECT_NAME_NOT_FOUND = 0xC0000034
STATUS_OBJECT_PATH_NOT_FOUND = 0xC000003A
STATUS_MEMORY_NOT_ALLOCATED = 0xC00000A0

# -- exception codes ---------------------------------------------------------

EXCEPTION_ACCESS_VIOLATION = 0xC0000005
EXCEPTION_DATATYPE_MISALIGNMENT = 0x80000002
EXCEPTION_BREAKPOINT = 0x80000003
EXCEPTION_SINGLE_STEP = 0x80000004
EXCEPTION_ARRAY_BOUNDS_EXCEEDED = 0xC000008C
EXCEPTION_FLT_DIVIDE_BY_ZERO = 0xC000008E
EXCEPTION_INT_DIVIDE_BY_ZERO = 0xC0000094
EXCEPTION_INT_OVERFLOW = 0xC0000095
EXCEPTION_PRIV_INSTRUCTION = 0xC0000096
EXCEPTION_ILLEGAL_INSTRUCTION = 0xC000001D
EXCEPTION_STACK_OVERFLOW = 0xC00000FD
EXCEPTION_STACK_BUFFER_OVERRUN = 0xC0000409
EXCEPTION_GUARD_PAGE = 0x80000001
EXCEPTION_HEAP_CORRUPTION = 0xC0000374
DBG_PRINTEXCEPTION_C = 0x40010006
DBG_PRINTEXCEPTION_WIDE_C = 0x4001000A
CPP_EH_EXCEPTION = 0xE06D7363  # msvc c++ throw ('msc'|0xE0)

_EXCEPTION_NAMES = {
    EXCEPTION_ACCESS_VIOLATION: "access-violation",
    EXCEPTION_BREAKPOINT: "breakpoint",
    EXCEPTION_SINGLE_STEP: "single-step",
    EXCEPTION_INT_DIVIDE_BY_ZERO: "divide-by-zero",
    EXCEPTION_INT_OVERFLOW: "integer-overflow",
    EXCEPTION_ILLEGAL_INSTRUCTION: "illegal-instruction",
    EXCEPTION_PRIV_INSTRUCTION: "privileged-instruction",
    EXCEPTION_STACK_OVERFLOW: "stack-overflow",
    EXCEPTION_STACK_BUFFER_OVERRUN: "stack-buffer-overrun",
    EXCEPTION_GUARD_PAGE: "guard-page",
    EXCEPTION_HEAP_CORRUPTION: "heap-corruption",
    DBG_PRINTEXCEPTION_C: "dbg-print",
    DBG_PRINTEXCEPTION_WIDE_C: "dbg-print-wide",
    CPP_EH_EXCEPTION: "cpp-exception",
}


def exception_code_to_str(code: int) -> str:
    """Pretty name for crash filenames (reference ExceptionCodeToStr,
    utils.cc:416-472)."""
    return _EXCEPTION_NAMES.get(code, f"exception-{code:#x}")


# -- ntdll pointer encoding --------------------------------------------------

_M64 = (1 << 64) - 1


def decode_pointer(cookie: int, value: int) -> int:
    """ntdll's DecodePointer: ror64(value, 0x40 - (cookie & 0x3F)) ^ cookie
    (reference utils.cc:302-304).  Harnesses need it to walk encoded
    handler lists (PEB fast-fail handlers, KernelCallbackTable, etc.);
    the cookie comes from the guest (e.g. ntdll!RtlpProcessCookie or a
    NtQueryInformationProcess(ProcessCookie) result read at init)."""
    rot = 0x40 - (cookie & 0x3F)
    value &= _M64
    rotated = ((value >> rot) | (value << (64 - rot))) & _M64
    return rotated ^ cookie


def encode_pointer(cookie: int, value: int) -> int:
    """Inverse of decode_pointer (ntdll EncodePointer): xor first, then
    rotate left by 0x40 - (cookie & 0x3F)."""
    rot = 0x40 - (cookie & 0x3F)
    mixed = (value ^ cookie) & _M64
    return ((mixed << rot) | (mixed >> (64 - rot))) & _M64


# -- EXCEPTION_RECORD64 ------------------------------------------------------

@dataclasses.dataclass
class ExceptionRecord:
    """EXCEPTION_RECORD64 (the same wire layout nt.h declares and the
    crash dump header embeds):
      u32 ExceptionCode; u32 ExceptionFlags; u64 ExceptionRecord;
      u64 ExceptionAddress; u32 NumberParameters; u32 pad;
      u64 ExceptionInformation[15];"""

    code: int
    flags: int
    nested: int
    address: int
    parameters: List[int]

    SIZE = 0x98

    @classmethod
    def parse(cls, raw: bytes) -> "ExceptionRecord":
        code, flags = struct.unpack_from("<II", raw, 0)
        nested, address = struct.unpack_from("<QQ", raw, 8)
        (n_params,) = struct.unpack_from("<I", raw, 0x18)
        params = list(struct.unpack_from("<15Q", raw, 0x20))
        return cls(code=code, flags=flags, nested=nested, address=address,
                   parameters=params[:min(n_params, 15)])

    def av_kind(self) -> str:
        """Refine an access violation into read/write/execute via
        ExceptionInformation[0] (0=read, 1=write, 8=DEP/execute) — the
        reference's refinement in crash_detection_umode.cc:104-121."""
        if self.code != EXCEPTION_ACCESS_VIOLATION or not self.parameters:
            return ""
        kind = self.parameters[0]
        return {0: "read", 1: "write", 8: "execute"}.get(kind, f"av{kind}")


# -- OBJECT_ATTRIBUTES / IO_STATUS_BLOCK (guest-fs hook surface) ------------

@dataclasses.dataclass
class IoStatusBlock:
    """u64 Status (union w/ Pointer); u64 Information."""

    status: int
    information: int

    SIZE = 0x10

    @classmethod
    def parse(cls, raw: bytes) -> "IoStatusBlock":
        status, info = struct.unpack_from("<QQ", raw, 0)
        return cls(status=status, information=info)

    def pack(self) -> bytes:
        return struct.pack("<QQ", self.status, self.information)


@dataclasses.dataclass
class ObjectAttributes:
    """OBJECT_ATTRIBUTES (x64): Length, RootDirectory, ObjectName(PUNICODE),
    Attributes, SecurityDescriptor, SecurityQualityOfService."""

    length: int
    root_directory: int
    object_name_ptr: int
    attributes: int

    SIZE = 0x30

    @classmethod
    def parse(cls, raw: bytes) -> "ObjectAttributes":
        length, root, name_ptr, attrs = struct.unpack_from("<QQQQ", raw, 0)
        return cls(length=length & 0xFFFFFFFF, root_directory=root,
                   object_name_ptr=name_ptr, attributes=attrs & 0xFFFFFFFF)


def read_unicode_string(virt_read, ptr: int) -> str:
    """UNICODE_STRING {u16 Length; u16 Max; pad; u64 Buffer} -> str
    (reference HostObjectAttributes_t reader, utils.h:55-224)."""
    hdr = virt_read(ptr, 16)
    length, _maxlen = struct.unpack_from("<HH", hdr, 0)
    (buffer_ptr,) = struct.unpack_from("<Q", hdr, 8)
    if length == 0 or buffer_ptr == 0:
        return ""
    return virt_read(buffer_ptr, length).decode("utf-16-le", "replace")
