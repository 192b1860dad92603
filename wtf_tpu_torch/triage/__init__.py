"""Batched triage: crash minimization, corpus distillation and
virtual-breakpoint replay as device workloads (the counterpart of
wtf_tpu/triage).

Anything shaped "run thousands of variants of one testcase" is a batch
dispatch, so triage runs on the same card, the same seams and the same
kernels as fuzzing.  The workloads share one batch-replay core:

  bucket.py      the triage-grade crash key (kind, faulting RIP,
                 top-of-stack hash) — ONE dedup helper shared by the
                 fuzz-loop harvest and the minimizer
  candidates.py  device-built candidates (truncate / block-delete /
                 zero) in the devmut byte-plane idiom
  replay.py      ReplayCore — chunked host-bytes sweeps and device-built
                 batches, per-testcase planes, exact first-hit credit;
                 FuzzLoop.minset runs on it
  minimize.py    bisecting batch minimizer (`triage minimize`)
  distill.py     exact-attribution corpus distillation + greedy set
                 cover (`triage distill`)
  vbreak.py      batched register+memory snapshots at an armed RIP
                 (`triage vbreak`)

All three land as `python -m wtf_tpu_torch triage
{minimize,distill,vbreak}`.
"""

from wtf_tpu_torch.triage.bucket import (  # noqa: F401
    bucket_of, crash_kind, make_bucket,
)
from wtf_tpu_torch.triage.distill import (  # noqa: F401
    DistillResult, distill, greedy_cover,
)
from wtf_tpu_torch.triage.minimize import (  # noqa: F401
    MinimizeResult, minimize,
)
from wtf_tpu_torch.triage.replay import ReplayCore, ReplaySweep  # noqa: F401
from wtf_tpu_torch.triage.vbreak import (  # noqa: F401
    BreakCapture, oracle_capture, perturbations, vbreak,
)
