"""Demo target: user-mode guest with a real IDT — guard-page stack growth
and SEH dispatch, the two behaviors every actual Windows user-mode
snapshot depends on.

Role in the reference's capability set: a user-mode target under the
reference runs with the guest kernel IN the snapshot, so a #PF is serviced
by the guest (bochs emulates the IDT walk; KVM/WHV inject the event —
bochscpu_backend.cc:917-999, whv_backend.cc:1218-1247).  That is what
makes (a) thread stacks grow through guard-page faults instead of
false-crashing and (b) unhandled exceptions travel kernel->user into
`ntdll!RtlDispatchException` where the crash-detection hooks parse the
EXCEPTION_RECORD (crash_detection_umode.cc:53-129).  This synthetic guest
reproduces both flows end to end against this framework's host-side
exception delivery (cpu/interrupts.py).

Guest layout:
  user  @ 0x15000000 (CPL3, cs=0x33): dispatch on input byte 0:
    cmd 1 (len>=2): touch N = byte1&0xF pages below rsp -> each lands in
          the unmapped guard region, #PF(CPL3 write), kernel handler maps
          the page by writing the PTE through a kernel window, iretq,
          store retries and succeeds: the stack GROWS.
    cmd 2: read 0xDEAD0000 -> non-growable #PF: kernel builds an
          EXCEPTION_RECORD64 (code 0xC0000005, info = [write?, cr2]) at
          XRECORD, points the iretq frame at user_dispatch and returns —
          the KiUserExceptionDispatcher/RtlDispatchException-analog, where
          setup_usermode_crash_detection's hook names the crash.
    cmd 3: div by zero -> #DE via IDT gate 0 -> same dispatch with
          code 0xC0000094.
    cmd 4: grow the stack through the faulting PUSH itself.
    cmd 5: read a NON-canonical address -> #GP (vector 13, not #PF — the
          delivery layer routes by canonicality) -> dispatched as an A/V
          with no faulting address, like KiGeneralProtectionFault.
  kernel @ 0xFFFF800000410000: #PF handler (gate 14) + #DE handler
          (gate 0), entered through a real 64-bit interrupt-gate IDT with
          a CPL3->0 stack switch via TSS.RSP0.
  KPTWIN @ 0xFFFF800000400000: kernel-mode alias of the page-table page
          covering the user stack region (patched post-build), so the
          handler can map guard pages with one PTE store.

The grown pages map to the low frames 1..0xF — inside the dump's frame
range (the device image rejects stores past it) but absent from the dump
itself, so physmem reads them as zeros and every write lands in the
per-lane overlay: Restore() undoes the growth for free.

Assembled with binutils (Intel syntax); bytes embedded, sources kept in
_USER_ASM/_KERN_ASM for regeneration (tests/test_usermode.py re-assembles
and checks the hex stays in sync when binutils is available).

Testcase ABI (insert_testcase): rsi = user buffer GVA, rdx = length.
"""

from __future__ import annotations

import struct

from wtf_tpu_torch.core.cpustate import GlobalSeg, Seg
from wtf_tpu_torch.core.results import Ok
from wtf_tpu_torch.harness import crash_detection
from wtf_tpu_torch.harness.targets import Target
from wtf_tpu_torch.snapshot.loader import Snapshot
from wtf_tpu_torch.snapshot.synthetic import SyntheticSnapshotBuilder

USER_CODE = 0x0000_1500_0000
FINISH_GVA = USER_CODE + 148        # `finish` label
USER_DISPATCH = USER_CODE + 150     # `user_dispatch` label
USER_BUF = 0x0000_2100_0000
XRECORD = 0x0000_2200_0000          # kernel-built EXCEPTION_RECORD64
MAX_INPUT = 0x1000

STACK_TOP = 0x0000_3000_0000        # top page mapped; below it: guard
STACK_LO = 0x0000_2FFF_0000         # growable region floor
GROW_FRAME_BASE = 0x1               # pfn of the first grown stack frame

KPTWIN = 0xFFFF_8000_0040_0000      # alias of the stack-region PT page
KERN_CODE = 0xFFFF_8000_0041_0000
_GP_HANDLER_OFF = 170               # `gp_handler` label
_DE_HANDLER_OFF = 251               # `de_handler` label
KSTACK_PAGE = 0xFFFF_8000_0042_0000
KSTACK_TOP = KSTACK_PAGE + 0xF80    # TSS.RSP0
KIDT = 0xFFFF_8000_0043_0000
KTSS = 0xFFFF_8000_0044_0000

_USER_ASM = """
user_entry:
    cmp rdx, 1 ; jb finish
    movzx rax, byte ptr [rsi]
    cmp al, 1 ; je u_grow
    cmp al, 2 ; je u_wild
    cmp al, 3 ; je u_div
    cmp al, 4 ; je u_push
    cmp al, 5 ; je u_noncanon
    jmp finish
u_grow:
    cmp rdx, 2 ; jb finish
    movzx rcx, byte ptr [rsi+1]
    and rcx, 0xF ; jz finish
    mov rbx, rsp
grow_loop:
    sub rbx, 0x1000
    mov [rbx], rcx                  # guard-page write -> #PF -> growth
    dec rcx ; jnz grow_loop
    jmp finish
u_wild:
    mov rax, 0xDEAD0000
    mov rax, [rax]                  # unmapped read -> SEH dispatch
    jmp finish
u_div:
    xor edx, edx ; mov eax, 1 ; xor ecx, ecx
    div ecx                         # #DE via IDT gate 0
    jmp finish
u_push:
    cmp rdx, 2 ; jb finish
    movzx rcx, byte ptr [rsi+1]
    and rcx, 0xF ; jz finish
push_loop:
    sub rsp, 0xFF8
    push rcx                        # the PUSH itself faults mid-insn:
    dec rcx ; jnz push_loop         # must retry with rsp NOT yet moved
    jmp finish
u_noncanon:
    mov rax, 0x800000000000
    mov rax, [rax]                  # non-canonical -> #GP via gate 13
    jmp finish
finish:
    nop ; hlt
user_dispatch:                      # RtlDispatchException analog (hooked)
    nop ; hlt
"""

_USER_CODE = bytes.fromhex(
    "4883fa010f828a000000480fb6063c0174123c0274333c03743e3c0474473c05"
    "7463eb704883fa02726a480fb64e014883e10f745f4889e34881eb0010000048"
    "890b48ffc975f1eb4b48b80000adde00000000488b00eb3c31d2b80100000031"
    "c9f7f1eb2f4883fa027229480fb64e014883e10f741e4881ecf80f00005148ff"
    "c975f3eb0f48b80000000000800000488b00eb0090f490f4"
)

_KERN_ASM = """
pf_handler:                         # IDT gate 14 (interrupt gate)
    push rax ; push rbx ; push rcx
    mov rax, cr2
    mov rbx, 0x2FFF0000             # STACK_LO
    cmp rax, rbx ; jb seh
    mov rbx, 0x30000000             # STACK_TOP
    cmp rax, rbx ; jae seh
    # growable: map frame GROW_FRAME_BASE+(idx-0x1F0) at the faulting page
    mov rbx, rax ; shr rbx, 12 ; and rbx, 0x1FF
    lea rcx, [rbx - 0x1EF]          # + GROW_FRAME_BASE - 0x1F0
    shl rcx, 12 ; or rcx, 7         # P|W|U
    mov rax, 0xFFFF800000400000     # KPTWIN (stack PT alias)
    mov [rax + rbx*8], rcx
    pop rcx ; pop rbx ; pop rax
    add rsp, 8                      # drop error code
    iretq                           # faulting store retries, now mapped
seh:
    # build EXCEPTION_RECORD64 at XRECORD and dispatch to user
    mov rbx, 0x22000000             # XRECORD
    mov dword ptr [rbx], 0xC0000005 # ExceptionCode = ACCESS_VIOLATION
    mov dword ptr [rbx+4], 0        # ExceptionFlags
    mov qword ptr [rbx+8], 0        # nested record
    mov rcx, [rsp+32]               # interrupted rip (3 saves + err)
    mov [rbx+16], rcx               # ExceptionAddress
    mov dword ptr [rbx+24], 2       # NumberParameters
    mov rcx, [rsp+24] ; shr rcx, 1 ; and rcx, 1
    mov [rbx+32], rcx               # info[0]: 0=read 1=write (err.W)
    mov rax, cr2
    mov [rbx+40], rax               # info[1]: faulting VA
    mov rcx, rbx                    # rcx = &record (dispatch ABI)
    mov rax, 0x15000096             # USER_DISPATCH
    mov [rsp+32], rax               # iretq frame rip -> dispatcher
    add rsp, 32                     # drop saves + error code
    iretq
gp_handler:                         # IDT gate 13 (#GP, error code)
    mov rbx, 0x22000000
    mov dword ptr [rbx], 0xC0000005 # Windows: #GP surfaces as an A/V
    mov dword ptr [rbx+4], 0
    mov qword ptr [rbx+8], 0
    mov rcx, [rsp+8]                # rip (past the error code)
    mov [rbx+16], rcx
    mov dword ptr [rbx+24], 2
    mov qword ptr [rbx+32], 0       # read
    mov qword ptr [rbx+40], 0       # no faulting address for #GP
    mov rcx, rbx
    mov rax, 0x15000096             # USER_DISPATCH
    mov [rsp+8], rax
    add rsp, 8                      # drop error code
    iretq
de_handler:                         # IDT gate 0 (no error code)
    mov rbx, 0x22000000
    mov dword ptr [rbx], 0xC0000094 # INT_DIVIDE_BY_ZERO
    mov dword ptr [rbx+4], 0
    mov qword ptr [rbx+8], 0
    mov rcx, [rsp]                  # interrupted rip
    mov [rbx+16], rcx
    mov dword ptr [rbx+24], 0
    mov rcx, rbx
    mov rax, 0x15000096             # USER_DISPATCH
    mov [rsp], rax
    iretq
"""

_KERN_CODE = bytes.fromhex(
    "5053510f20d048c7c30000ff2f4839d8724048c7c3000000304839d873344889"
    "c348c1eb0c4881e3ff010000488d8b11feffff48c1e10c4883c90748b8000040"
    "000080ffff48890cd8595b584883c40848cf48c7c300000022c703050000c0c7"
    "43040000000048c7430800000000488b4c242048894b10c7431802000000488b"
    "4c241848d1e94883e10148894b200f20d0488943284889d948c7c09600001548"
    "894424204883c42048cf48c7c300000022c703050000c0c743040000000048c7"
    "430800000000488b4c240848894b10c743180200000048c743200000000048c7"
    "4328000000004889d948c7c09600001548894424084883c40848cf48c7c30000"
    "0022c703940000c0c743040000000048c7430800000000488b0c2448894b10c7"
    "4318000000004889d948c7c0960000154889042448cf"
)


def _idt_gate(handler: int, selector: int = 0x10, gate_type: int = 0xE,
              ist: int = 0, dpl: int = 0) -> bytes:
    """One 16-byte long-mode gate descriptor (SDM Vol 3A 6.14.1)."""
    return struct.pack(
        "<HHBBHII",
        handler & 0xFFFF, selector, ist & 7,
        0x80 | (dpl << 5) | gate_type,
        (handler >> 16) & 0xFFFF, (handler >> 32) & 0xFFFFFFFF, 0)


def _walk_to_pt(pages: dict, cr3: int, gva: int) -> tuple:
    """Host-side 3-level descent to (pt_pfn, pte_index) for a GVA in the
    freshly built snapshot pages."""
    table_pfn = cr3 >> 12
    for shift in (39, 30, 21):
        idx = (gva >> shift) & 0x1FF
        entry = struct.unpack_from("<Q", pages[table_pfn], idx * 8)[0]
        assert entry & 1, f"level {shift} not present for {gva:#x}"
        table_pfn = (entry >> 12) & ((1 << 40) - 1)
    return table_pfn, (gva >> 12) & 0x1FF


def build_snapshot() -> Snapshot:
    b = SyntheticSnapshotBuilder()
    b.write(USER_CODE, _USER_CODE)
    b.write(KERN_CODE, _KERN_CODE)
    b.map(USER_BUF, MAX_INPUT)
    b.map(XRECORD, 0x1000)
    b.map(STACK_TOP - 0x1000, 0x1000)   # stack top page; guard below
    b.map(KSTACK_PAGE, 0x1000)
    b.map(KPTWIN, 0x1000)               # placeholder; PTE patched below

    idt = bytearray(0x1000)
    idt[0:16] = _idt_gate(KERN_CODE + _DE_HANDLER_OFF)   # #DE
    idt[13 * 16:14 * 16] = _idt_gate(KERN_CODE + _GP_HANDLER_OFF)  # #GP
    idt[14 * 16:15 * 16] = _idt_gate(KERN_CODE)          # #PF
    b.write(KIDT, bytes(idt))

    tss = bytearray(0x68)
    struct.pack_into("<Q", tss, 4, KSTACK_TOP)           # RSP0
    struct.pack_into("<H", tss, 0x66, 0x68)              # IOPB = limit
    b.write(KTSS, bytes(tss))

    pages, cpu = b.build(rip=USER_CODE, rsp=STACK_TOP - 0x10)
    cpu.rsi = USER_BUF
    cpu.rdx = 0
    cpu.idtr = GlobalSeg(base=KIDT, limit=0xFFF)
    cpu.tr = Seg(present=True, selector=0x40, base=KTSS, limit=0x67,
                 attr=0x8B)

    # Alias KPTWIN onto the PT page that maps the user stack region, so
    # the kernel handler can install guard-page PTEs with a plain store.
    stack_pt_pfn, _ = _walk_to_pt(pages, cpu.cr3, STACK_LO)
    win_pt_pfn, win_idx = _walk_to_pt(pages, cpu.cr3, KPTWIN)
    pt_page = bytearray(pages[win_pt_pfn])
    struct.pack_into("<Q", pt_page, win_idx * 8, (stack_pt_pfn << 12) | 0x3)
    pages[win_pt_pfn] = bytes(pt_page)

    return Snapshot.from_pages(
        pages, cpu, symbols={
            "user!entry": USER_CODE,
            "user!finish": FINISH_GVA,
            "ntdll!RtlDispatchException": USER_DISPATCH,
        })


def _init(backend) -> bool:
    backend.set_breakpoint(FINISH_GVA, lambda b: b.stop(Ok()))
    crash_detection.setup_usermode_crash_detection(backend)
    return True


def _insert_testcase(backend, data: bytes) -> bool:
    data = data[:MAX_INPUT]
    backend.virt_write(USER_BUF, data)
    backend.set_reg(6, USER_BUF)    # rsi
    backend.set_reg(2, len(data))   # rdx
    return True


TARGET = Target(
    name="demo_usermode",
    init=_init,
    insert_testcase=_insert_testcase,
    snapshot=build_snapshot,
)
