"""Execution-trace writers (reference TraceType_t surface, SURVEY §5.1)."""

from wtf_tpu_torch.trace.writers import (
    CovTraceWriter, RipTraceWriter, TenetTraceWriter, TraceWriter,
)

__all__ = ["CovTraceWriter", "RipTraceWriter", "TenetTraceWriter",
           "TraceWriter"]
