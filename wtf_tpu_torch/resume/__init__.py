"""Crash-safe campaign checkpoint/resume (the fault-tolerance tier), the
counterpart of wtf_tpu/resume.

A campaign killed at any batch boundary and restarted with `--resume`
must be bit-identical — coverage, crash set, corpus, devmut byte
streams — to the uninterrupted run (the same parity bar as the mesh
campaign).  `checkpoint.py` holds the format and the save/restore logic;
the state seams live with their owners (Runner.checkpoint_state,
GpuBackend.coverage_state, DeviceCorpus/DevMangleMutator checkpoint
methods, Registry.counters_state).
"""

from wtf_tpu_torch.resume.checkpoint import (  # noqa: F401
    CKPT_NAME, CKPT_VERSION, CheckpointError, load_campaign,
    restore_campaign, save_campaign,
)
