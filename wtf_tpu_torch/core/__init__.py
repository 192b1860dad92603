"""Core types: strong addresses, CPU state, testcase results, options."""

from wtf_tpu_torch.core.gxa import Gva, Gpa, PAGE_SIZE, PAGE_SHIFT, page_align, page_offset
from wtf_tpu_torch.core.cpustate import (
    CpuState,
    Seg,
    GlobalSeg,
    load_cpu_state_json,
    sanitize_cpu_state,
)
from wtf_tpu_torch.core.results import (
    TestcaseResult,
    Ok,
    Timedout,
    Cr3Change,
    Crash,
)
