"""Demo target: user-mode guest that does real file I/O via the faked
Nt* syscalls (the guest-fs emulation proof).

The guest opens '\\??\\C:\\fuzz\\input.txt' with NtCreateFile (parsing
OBJECT_ATTRIBUTES/UNICODE_STRING planted in its data pages), NtReadFile's
16 bytes into a buffer, copies the first qword to an output slot, and
NtCloses the handle.  All three syscalls are stub routines (nop;hlt)
whose entry breakpoints the GuestFs hook set services entirely host-side
(SimulateReturnFromFunction), exactly like the reference fakes
ntdll!NtCreateFile & co in breakpoint handlers (fshooks.cc:115-929).

The fuzzing surface: insert_testcase REPLACES THE FILE CONTENT — the
testcase travels into the guest through the faked filesystem, the
standard wtf pattern for file-parsing targets.
"""

from __future__ import annotations

import struct

from wtf_tpu_torch.core.results import Ok
from wtf_tpu_torch.harness import guestfs
from wtf_tpu_torch.harness.targets import Target
from wtf_tpu_torch.snapshot.loader import Snapshot
from wtf_tpu_torch.snapshot.synthetic import SyntheticSnapshotBuilder

# All absolute addresses fit in 31 bits: the guest loads them with
# sign-extended imm32 movs (mov r64, imm32).
CODE_GVA = 0x1400_0000
NTCREATE = 0x1500_0000
NTREAD = 0x1500_1000
NTCLOSE = 0x1500_2000
DATA = 0x2100_0000
HSLOT = DATA
IOSB = DATA + 0x10
OBJATTR = DATA + 0x40
UNICODE = DATA + 0x80
NAMEBUF = DATA + 0xC0
RBUF = DATA + 0x100
OUTSLOT = DATA + 0x200
STACK_TOP = 0x0000_7FFF_F000
FILE_NAME = "\\??\\C:\\fuzz\\input.txt"
_FINISH_OFF = 167

_GUEST_CODE = bytes.fromhex(
    "4883ec5848c7c10000002148c7c28900120049c7c04000002149c7c110000021"
    "48c7c000000015ffd085c0757a48c7c000000021488b084831d24d31c04d31c9"
    "48c7c010000021488944242048c7c000010021488944242848c7442430100000"
    "0048c74424380000000048c74424400000000048c7c000100015ffd085c07527"
    "48c7c000010021488b1848c7c00002002148891848c7c000000021488b0848c7"
    "c000200015ffd090f4"
)

FINISH_GVA = CODE_GVA + _FINISH_OFF

# One GuestFs per initialized backend (differential runs init several
# backends in one process; each keeps its own hook state).  restore()
# has no backend argument in the Target contract — like the reference's
# global fshooks state — so it rolls every registered instance back.
_FS_BY_BACKEND = {}
_FS: guestfs.GuestFs = None  # most recent (test/inspection convenience)


def build_snapshot() -> Snapshot:
    b = SyntheticSnapshotBuilder()
    b.write(CODE_GVA, _GUEST_CODE)
    for stub in (NTCREATE, NTREAD, NTCLOSE):
        b.write(stub, b"\x90\xf4")  # nop ; hlt — hook fires pre-execution
    b.map(DATA, 0x1000)
    # OBJECT_ATTRIBUTES {Length, Root, &UNICODE_STRING, Attributes, 0, 0}
    b.write(OBJATTR, struct.pack("<QQQQQQ", 0x30, 0, UNICODE, 0x40, 0, 0))
    name16 = FILE_NAME.encode("utf-16-le")
    b.write(UNICODE, struct.pack("<HHIQ", len(name16), len(name16), 0,
                                 NAMEBUF))
    b.write(NAMEBUF, name16)
    b.map(STACK_TOP - 0x4000, 0x5000)
    rsp = STACK_TOP - 0x1000
    pages, cpu = b.build(rip=CODE_GVA, rsp=rsp)
    return Snapshot.from_pages(
        pages, cpu, symbols={
            "fsdemo!entry": CODE_GVA,
            "fsdemo!finish": FINISH_GVA,
            guestfs.SYM_NTCREATEFILE: NTCREATE,
            guestfs.SYM_NTREADFILE: NTREAD,
            guestfs.SYM_NTCLOSE: NTCLOSE,
        })


def _init(backend) -> bool:
    global _FS
    fs = guestfs.GuestFs()
    fs.fs.map_existing_guest_file(FILE_NAME, b"default contents")
    fs.install(backend)
    fs.save()
    _FS_BY_BACKEND[id(backend)] = fs
    _FS = fs
    backend.set_breakpoint(FINISH_GVA, lambda b: b.stop(Ok()))
    return True


def _insert_testcase(backend, data: bytes) -> bool:
    # the testcase IS the file content (file-format fuzzing shape),
    # planted into THIS backend's view of THIS lane's file
    fs = _FS_BY_BACKEND[id(backend)]
    f = fs.lane_file(backend, FILE_NAME)
    f.data = bytearray(data)
    f.cursor = 0
    return True


def _restore() -> bool:
    for fs in _FS_BY_BACKEND.values():
        fs.restore()
    return True


TARGET = Target(
    name="demo_fs",
    init=_init,
    insert_testcase=_insert_testcase,
    restore=_restore,
    snapshot=build_snapshot,
)
