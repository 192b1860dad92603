"""Demo target: a 4-stage input maze only coverage guidance walks through.

Each correct input byte unlocks a new basic block (new coverage -> corpus
entry -> mutation base), the standard demonstration that the
coverage->corpus->mutate feedback loop works end-to-end; random fuzzing of
the 2^32 input space essentially never finds the final int3 crash, the
guided loop finds it in seconds.  Role model: the reference's hevd demo
campaign walkthrough (README.md:34-110).

Guest ABI: rsi = buffer, rdx = length; "wtf!" -> int3 (Crash).
"""

from __future__ import annotations

from wtf_tpu_torch.core.results import Ok
from wtf_tpu_torch.harness.targets import Target
from wtf_tpu_torch.snapshot.loader import Snapshot
from wtf_tpu_torch.snapshot.synthetic import SyntheticSnapshotBuilder

CODE_GVA = 0x0001_5000_0000
FINISH_GVA = 0x0001_5000_2000
INPUT_GVA = 0x0002_1000_0000
STACK_TOP = 0x0000_7FFF_F000
MAX_INPUT = 0x100

# cmp rdx,4 / jb out ; buf[0]=='w' ... buf[3]=='!' -> int3 ; out: ret
_GUEST_CODE = bytes.fromhex(
    "4883fa0472388a063c77753248c7c3010000008a46013c74752448c7c3020000"
    "008a46023c66751648c7c3030000008a46033c21750848c7c304000000ccc3"
)


def build_snapshot() -> Snapshot:
    b = SyntheticSnapshotBuilder()
    b.write(CODE_GVA, _GUEST_CODE)
    b.write(FINISH_GVA, b"\x90\xf4")
    b.map(INPUT_GVA, MAX_INPUT)
    b.map(STACK_TOP - 0x4000, 0x5000)
    rsp = STACK_TOP - 0x1000
    b.write(rsp, FINISH_GVA.to_bytes(8, "little"), map_if_needed=False)
    pages, cpu = b.build(rip=CODE_GVA, rsp=rsp)
    cpu.rsi = INPUT_GVA
    cpu.rdx = 0
    return Snapshot.from_pages(
        pages, cpu, symbols={
            "maze!entry": CODE_GVA,
            "maze!finish": FINISH_GVA,
        })


def _init(backend) -> bool:
    backend.set_breakpoint(FINISH_GVA, lambda b: b.stop(Ok()))
    return True


def _insert_testcase(backend, data: bytes) -> bool:
    data = data[:MAX_INPUT]
    backend.virt_write(INPUT_GVA, data)
    backend.set_reg(6, INPUT_GVA)
    backend.set_reg(2, len(data))
    return True


TARGET = Target(
    name="demo_maze",
    init=_init,
    insert_testcase=_insert_testcase,
    snapshot=build_snapshot,
)
