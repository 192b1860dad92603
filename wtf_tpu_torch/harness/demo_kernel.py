"""Demo target: synthetic ring-0 syscall handler with planted kernel bugs.

Role of the reference's HEVD kernel target (fuzzer_hevd.cc + the hevd
crash-dump snapshot): an end-to-end kernel-mode campaign exercising the
privilege-boundary machinery — syscall via IA32_LSTAR, swapgs, kernel
stack switch, high-half (canonical negative) addresses, sysret — plus the
kernel crash-detection hook set (harness/crash_detection.py).

Guest layout:
  user  @ 0x14000000:        syscall ; nop(FINISH bp) ; hlt
  kernel @ 0xffff8000_00200000 (LSTAR): swapgs, stack switch, dispatch on
  the first input byte:
    cmd 1: benign byte-sum loop
    cmd 2 (len>=16): load bugcheck code+arg from input, jmp bugcheck
           routine -> the nt!KeBugCheck2-analog bp names the crash
    cmd 3: copy len-1 bytes into a 32-byte kernel buffer sitting at the
           end of a mapped page -> OOB kernel WRITE into the guard page
    cmd 4 (len>=9): jmp to an attacker-controlled address -> EXEC fault
  then swapgs ; sysretq back to user FINISH.

Testcase ABI (insert_testcase): rsi = user buffer GVA, rdx = length.

Assembled with binutils at build time; bytes embedded (source in
_KERN_ASM / _USER_ASM for regeneration).
"""

from __future__ import annotations

from wtf_tpu_torch.core.results import Ok
from wtf_tpu_torch.harness import crash_detection
from wtf_tpu_torch.harness.targets import Target
from wtf_tpu_torch.snapshot.loader import Snapshot
from wtf_tpu_torch.snapshot.synthetic import SyntheticSnapshotBuilder

USER_CODE = 0x0000_1400_0000
FINISH_GVA = USER_CODE + 2          # the nop after syscall
USER_BUF = 0x0000_2000_0000
MAX_INPUT = 0x1000

KERN_CODE = 0xFFFF_8000_0020_0000
KBUF_PAGE = 0xFFFF_8000_0020_2000   # 32-byte buffer at page end; next
KBUF = KBUF_PAGE + 0xFE0            #   page is unmapped (kernel guard)
KSTACK_PAGE = 0xFFFF_8000_0021_0000
KSTACK_TOP = KSTACK_PAGE + 0xFF0
KGS_PAGE = 0xFFFF_8000_0022_0000    # kernel_gs_base target of swapgs
_BUGCHECK_OFF = 155                 # k_bugcheck label offset in _KERN_CODE

_USER_ASM = "syscall ; nop ; hlt"
_USER_CODE = bytes.fromhex("0f0590f4")

_KERN_ASM = """
    swapgs ; mov r13, rsp ; mov rsp, KSTACK_TOP
    cmp rdx, 1 ; jb kout
    movzx rax, byte ptr [rsi]
    cmp al, 1 ; je k_sum ; cmp al, 2 ; je k_bug
    cmp al, 3 ; je k_copy ; cmp al, 4 ; je k_exec ; jmp kout
k_sum:
    xor rbx, rbx ; lea r8, [rsi+1] ; mov r12, rdx ; dec r12
k_sum_loop:
    test r12, r12 ; jz kout
    movzx rax, byte ptr [r8] ; add rbx, rax ; inc r8 ; dec r12
    jmp k_sum_loop
k_bug:
    cmp rdx, 16 ; jb kout
    mov ecx, dword ptr [rsi+1] ; mov rdx, qword ptr [rsi+5]
    jmp k_bugcheck
k_copy:
    lea r8, [rsi+1] ; mov r9, KBUF ; mov r12, rdx ; dec r12
k_copy_loop:
    test r12, r12 ; jz kout
    mov al, byte ptr [r8] ; mov byte ptr [r9], al
    inc r8 ; inc r9 ; dec r12 ; jmp k_copy_loop
k_exec:
    cmp rdx, 9 ; jb kout
    mov rax, qword ptr [rsi+1] ; jmp rax
kout:
    mov rsp, r13 ; swapgs ; sysretq
k_bugcheck:
    nop ; hlt
"""

_KERN_CODE = bytes.fromhex(
    "0f01f84989e548bcf00f21000080ffff4883fa01727c480fb6063c01740e3c02"
    "742b3c0374363c04745ceb664831db4c8d46014989d449ffcc4d85e47454490f"
    "b6004801c349ffc049ffccebec4883fa10723f8b4e01488b5605eb3f4c8d4601"
    "49b9e02f20000080ffff4989d449ffcc4d85e4741d418a0041880149ffc049ff"
    "c149ffccebea4883fa097206488b4601ffe04c89ec0f01f8480f0790f4"
)


def build_snapshot() -> Snapshot:
    b = SyntheticSnapshotBuilder()
    b.write(USER_CODE, _USER_CODE)
    b.write(KERN_CODE, _KERN_CODE)
    b.map(USER_BUF, MAX_INPUT)
    b.map(KBUF_PAGE, 0x1000)        # exactly one page: guard after KBUF
    b.map(KSTACK_PAGE, 0x1000)
    b.map(KGS_PAGE, 0x1000)
    pages, cpu = b.build(rip=USER_CODE, rsp=0)
    cpu.rsi = USER_BUF
    cpu.rdx = 0
    # privilege-boundary machinery (the state bdump captures from MSRs)
    cpu.lstar = KERN_CODE
    cpu.sfmask = 0x300              # mask TF|IF on syscall entry
    cpu.gs_base = 0                 # user gs
    cpu.kernel_gs_base = KGS_PAGE   # swapped in by swapgs
    return Snapshot.from_pages(
        pages, cpu, symbols={
            "user!entry": USER_CODE,
            "user!finish": FINISH_GVA,
            "kernel!entry": KERN_CODE,
            "nt!KeBugCheck2": KERN_CODE + _BUGCHECK_OFF,
        })


def _init(backend) -> bool:
    backend.set_breakpoint(FINISH_GVA, lambda b: b.stop(Ok()))
    crash_detection.setup_kernel_crash_detection(backend)
    return True


def _insert_testcase(backend, data: bytes) -> bool:
    data = data[:MAX_INPUT]
    backend.virt_write(USER_BUF, data)
    backend.set_reg(6, USER_BUF)    # rsi
    backend.set_reg(2, len(data))   # rdx
    return True


TARGET = Target(
    name="demo_kernel",
    init=_init,
    insert_testcase=_insert_testcase,
    snapshot=build_snapshot,
)
