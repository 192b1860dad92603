"""Demo target: synthetic TLV parser with a planted stack overflow.

Plays the role of the reference's tlv_server demo (a deliberately vulnerable
TLV heap server snapshot fuzzed by fuzzer_tlv_server.cc).  The reference
ships Windows crash-dump snapshots of its demo programs; we synthesize the
equivalent: a long-mode guest whose code is a hand-written TLV parser with
the classic bug.

Guest ABI (set by insert_testcase, mirroring fuzzer_hevd.cc:20-59's
register+buffer insertion):
  rsi = input buffer GVA, rdx = input length
  records: { type:u8, len:u8, payload[len] }
    type 1: sum payload bytes into rbx
    type 2: len>=8 -> store first qword at [r15] (scratch page)
    type 3: copy payload into an 8-byte stack buffer  <-- NO length check:
            len > ~24 smashes the saved return address; `ret` then jumps
            to attacker bytes -> fetch fault -> Crash (the detection path
            a real campaign exercises)
  returns (ret) to FINISH_GVA where init() plants the stop breakpoint -> Ok

Assembled with binutils at build time; bytes embedded so runtime needs no
toolchain (source in _GUEST_ASM for auditability/regeneration).
"""

from __future__ import annotations

from wtf_tpu_torch.core.results import Ok
from wtf_tpu_torch.harness.targets import DeviceInsertSpec, Target
from wtf_tpu_torch.snapshot.loader import Snapshot
from wtf_tpu_torch.snapshot.synthetic import SyntheticSnapshotBuilder

CODE_GVA = 0x0001_4000_0000
FINISH_GVA = 0x0001_4000_2000
INPUT_GVA = 0x0002_0000_0000
SCRATCH_GVA = 0x0002_0000_4000
STACK_TOP = 0x0000_7FFF_F000
MAX_INPUT = 0x1000

_GUEST_ASM = """
    push rbp ; mov rbp, rsp ; sub rsp, 0x40
    mov r8, rsi ; lea r9, [rsi + rdx] ; xor rbx, rbx
next_record:
    cmp r8, r9 ; jae done
    lea r10, [r8+2] ; cmp r10, r9 ; ja done
    movzx rax, byte ptr [r8] ; movzx rcx, byte ptr [r8+1]
    lea r8, [r8+2] ; lea r10, [r8+rcx] ; cmp r10, r9 ; ja done
    cmp al, 1 ; je t_sum ; cmp al, 2 ; je t_store ; cmp al, 3 ; je t_copy
    mov r8, r10 ; jmp next_record
t_sum:
    test rcx, rcx ; jz sum_done
    movzx rax, byte ptr [r8] ; add rbx, rax ; inc r8 ; dec rcx ; jmp t_sum
sum_done: jmp next_record
t_store:
    cmp rcx, 8 ; jb store_skip
    mov rax, [r8] ; mov [r15], rax
store_skip: mov r8, r10 ; jmp next_record
t_copy:
    lea r11, [rbp-0x10]
copy_loop:
    test rcx, rcx ; jz copy_done
    mov al, byte ptr [r8] ; mov byte ptr [r11], al
    inc r8 ; inc r11 ; dec rcx ; jmp copy_loop
copy_done: jmp next_record
done:
    mov rax, rbx ; mov rsp, rbp ; pop rbp ; ret
"""

_GUEST_CODE = bytes.fromhex(
    "554889e54883ec404989f04c8d0c164831db4d39c873734d8d50024d39ca776a"
    "490fb600490fb648014d8d40024d8d14084d39ca77543c01740d3c02741f3c03"
    "742c4d89d0ebcb4885c9740f490fb6004801c349ffc048ffc9ebecebb54883f9"
    "087206498b004989074d89d0eba44c8d5df04885c97411418a0041880349ffc0"
    "49ffc348ffc9ebeaeb884889d84889ec5dc3"
)


def build_snapshot() -> Snapshot:
    """Synthesize the snapshot: parser entered as if just called, return
    address pointing at FINISH_GVA (so `ret` = end of testcase)."""
    b = SyntheticSnapshotBuilder()
    b.write(CODE_GVA, _GUEST_CODE)
    b.write(FINISH_GVA, b"\x90\xf4")          # nop; hlt (never reached: bp)
    b.map(INPUT_GVA, MAX_INPUT)
    b.map(SCRATCH_GVA, 0x1000)
    b.map(STACK_TOP - 0x8000, 0x9000)
    rsp = STACK_TOP - 0x1000
    b.write(rsp, FINISH_GVA.to_bytes(8, "little"), map_if_needed=False)
    pages, cpu = b.build(rip=CODE_GVA, rsp=rsp)
    cpu.rsi = INPUT_GVA
    cpu.rdx = 0
    cpu.r15 = SCRATCH_GVA
    return Snapshot.from_pages(
        pages, cpu, symbols={
            "tlv!parse": CODE_GVA,
            "tlv!finish": FINISH_GVA,
        })


def _init(backend) -> bool:
    # stop bp where `ret` lands (reference: bp after the DeviceIoControl
    # call site, fuzzer_hevd.cc:66-74)
    backend.set_breakpoint(
        FINISH_GVA, lambda b: b.stop(Ok()))
    return True


def _insert_testcase(backend, data: bytes) -> bool:
    data = data[:MAX_INPUT]
    backend.virt_write(INPUT_GVA, data)
    backend.set_reg(6, INPUT_GVA)        # rsi
    backend.set_reg(2, len(data))        # rdx
    return True


def _create_mutator(rng, max_len: int):
    from wtf_tpu_torch.fuzz.mutator import TlvStructureMutator

    return TlvStructureMutator(rng, max_len)


TARGET = Target(
    name="demo_tlv",
    init=_init,
    insert_testcase=_insert_testcase,
    create_mutator=_create_mutator,
    snapshot=build_snapshot,
    # declarative twin of _insert_testcase for the device-resident
    # mutation path: bytes at INPUT_GVA, pointer in rsi (6), len in rdx
    # (2); finish_gva is the stop bp _init plants (stop(Ok()) exactly),
    # which lets the megachunk window retire clean lanes in-graph
    device_insert=DeviceInsertSpec(gva=INPUT_GVA, max_len=MAX_INPUT,
                                   len_gpr=2, ptr_gpr=6,
                                   finish_gva=FINISH_GVA),
)
