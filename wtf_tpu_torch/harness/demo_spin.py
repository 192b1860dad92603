"""Demo target: deep-execution workload (BASELINE config 5's shape).

The reference's deep-kernel campaigns run 100M+ instructions per
testcase (--limit up to ~1.5B on KVM, README.md:307).  This target's
guest spins a hash loop for u32(payload[0:4]) iterations (~8
instructions each), so testcases dial in execution depth directly —
the workload that exposes chunk-servicing overhead and validates the
runner's adaptive chunk growth.
"""

from __future__ import annotations

from wtf_tpu_torch.core.results import Ok
from wtf_tpu_torch.harness.targets import Target
from wtf_tpu_torch.snapshot.loader import Snapshot
from wtf_tpu_torch.snapshot.synthetic import SyntheticSnapshotBuilder

CODE_GVA = 0x1400_0000
FINISH_GVA = 0x1400_2000
INPUT_GVA = 0x2000_0000
STACK_TOP = 0x0000_7FFF_F000
INSNS_PER_ITER = 8  # test/bench helpers size --limit with this

_GUEST_CODE = bytes.fromhex(
    "4883fa04721c8b064831db4885c074124801c34889d948c1e90d4831cb48ffc8"
    "ebe9c3"
)


def build_snapshot() -> Snapshot:
    b = SyntheticSnapshotBuilder()
    b.write(CODE_GVA, _GUEST_CODE)
    b.write(FINISH_GVA, b"\x90\xf4")
    b.map(INPUT_GVA, 0x1000)
    b.map(STACK_TOP - 0x2000, 0x3000)
    rsp = STACK_TOP - 0x1000
    b.write(rsp, FINISH_GVA.to_bytes(8, "little"), map_if_needed=False)
    pages, cpu = b.build(rip=CODE_GVA, rsp=rsp)
    cpu.rsi = INPUT_GVA
    cpu.rdx = 0
    return Snapshot.from_pages(
        pages, cpu, symbols={
            "spin!entry": CODE_GVA,
            "spin!finish": FINISH_GVA,
        })


def _init(backend) -> bool:
    backend.set_breakpoint(FINISH_GVA, lambda b: b.stop(Ok()))
    return True


def _insert_testcase(backend, data: bytes) -> bool:
    data = data[:0x1000]
    backend.virt_write(INPUT_GVA, data)
    backend.set_reg(6, INPUT_GVA)
    backend.set_reg(2, len(data))
    return True


TARGET = Target(
    name="demo_spin",
    init=_init,
    insert_testcase=_insert_testcase,
    snapshot=build_snapshot,
)
