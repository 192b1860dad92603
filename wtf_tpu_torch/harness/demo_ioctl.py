"""Demo target: generic IOCTL-style in-place rewriting (fuzzer_ioctl role).

The reference's fuzzer_ioctl.cc fuzzes any NtDeviceIoControlFile snapshot
by rewriting IoControlCode / InputBuffer / InputLength in place
(fuzzer_ioctl.cc:25-135), pushing the payload against the end of the
snapshot buffer so OOB reads fault immediately (page-heap idiom, :82-89),
and planting its stop breakpoint DYNAMICALLY on the saved return address
instead of a fixed symbol (:144-173).  This target reproduces all three
idioms on a synthetic dispatcher snapshot:

  guest ABI at snapshot time (an ioctl dispatch about to run):
    ecx = IoControlCode, rdx = InputBuffer, r8 = InputLength
    handlers: 0x222007 byte-sum (benign), 0x222003 trusts a u16 length
    field at buf[0] and copies that many bytes -> OOB READ past the
    page-end-placed buffer

  testcase format: u32 IoControlCode | payload  (insert_testcase
  rewrites registers + places payload at the end of the input page)
"""

from __future__ import annotations

import struct

from wtf_tpu_torch.core.results import Ok
from wtf_tpu_torch.harness.targets import Target
from wtf_tpu_torch.snapshot.loader import Snapshot
from wtf_tpu_torch.snapshot.synthetic import SyntheticSnapshotBuilder

CODE_GVA = 0x1400_0000
EXIT_GVA = 0x1400_2000      # where the snapshot's saved return address points
INPUT_PAGE = 0x2000_0000    # one page; payload pushed against its end
SCRATCH = 0x2200_0000
STACK_TOP = 0x0000_7FFF_F000
IOCTL_SUM = 0x222007
IOCTL_PARSE = 0x222003

_GUEST_CODE = bytes.fromhex(
    "81f903202200742781f9072022007402eb484831c04989d14d89c24d85d2743a"
    "490fb6194801d849ffc149ffcaebec4983f80272254c0fb7124c8d4a0249c7c3"
    "000000224d85d27411418a0141880349ffc149ffc349ffcaebeac3"
)


def build_snapshot() -> Snapshot:
    b = SyntheticSnapshotBuilder()
    b.write(CODE_GVA, _GUEST_CODE)
    b.write(EXIT_GVA, b"\x90\xf4")      # nop ; hlt (bp planted at init)
    b.map(INPUT_PAGE, 0x1000)           # guard page follows (unmapped)
    b.map(SCRATCH, 0x1000)
    b.map(STACK_TOP - 0x4000, 0x5000)
    rsp = STACK_TOP - 0x1000
    b.write(rsp, EXIT_GVA.to_bytes(8, "little"), map_if_needed=False)
    pages, cpu = b.build(rip=CODE_GVA, rsp=rsp)
    cpu.rcx = IOCTL_SUM
    cpu.rdx = INPUT_PAGE
    cpu.r8 = 0
    return Snapshot.from_pages(
        pages, cpu, symbols={
            "ioctl!dispatch": CODE_GVA,
            # note: no exit symbol on purpose — init() discovers it
        })


def _init(backend) -> bool:
    # dynamic exit breakpoint: read the snapshot's saved return address
    # off the stack (fuzzer_ioctl.cc:144-173's first-return-address idiom)
    ret_addr = int.from_bytes(backend.virt_read(backend.get_reg(4), 8),
                              "little")
    backend.set_breakpoint(ret_addr, lambda b: b.stop(Ok()))
    return True


def _insert_testcase(backend, data: bytes) -> bool:
    if len(data) < 4:
        data = data.ljust(4, b"\x00")
    (code,) = struct.unpack_from("<I", data, 0)
    payload = data[4:4 + 0xF00]
    # page-heap placement: payload ends exactly at the page boundary so
    # one byte of OOB read faults (fuzzer_ioctl.cc:82-89)
    addr = INPUT_PAGE + 0x1000 - len(payload)
    if payload:
        backend.virt_write(addr, payload)
    backend.set_reg(1, code)            # rcx = IoControlCode
    backend.set_reg(2, addr)            # rdx = InputBuffer
    backend.set_reg(8, len(payload))    # r8  = InputLength
    return True


TARGET = Target(
    name="demo_ioctl",
    init=_init,
    insert_testcase=_insert_testcase,
    snapshot=build_snapshot,
)
