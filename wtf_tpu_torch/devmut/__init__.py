"""Device-resident mutation engine: the testcase stream lives on the card.

The counterpart of wtf_tpu/devmut: the host mutate -> insert phase moves
onto the device, so `mutate -> insert -> execute` touches host bytes only
for crashes, new coverage and corpus I/O:

  corpus.py   DeviceCorpus — the [slots, max_len/4] u32 seed slab with
              per-slot lengths and favor weights
  engine.py   the batched mangle engine (per-lane splitmix64 streams on
              int64; the 8-op honggfuzz-class table) as PyTorch code
  hostref.py  the authoritative op spec and bit-exact host mirror (a
              copy of the JAX package's)
  mutator.py  DevMangleMutator — the `devmangle` fuzz.mutator engine,
              double-buffered so batch N+1 is generated before batch N's
              finds enter the slab

The insert seam lives in interp/runner.py (`device_insert_impl`,
`Runner.device_insert`) and the batch paths in backend/gpu.py
(`run_batch_device`, `run_megachunk`) and fuzz/loop.py.
"""

from wtf_tpu_torch.devmut.corpus import DeviceCorpus  # noqa: F401
from wtf_tpu_torch.devmut.hostref import (  # noqa: F401
    FAVOR_WEIGHT, N_OPS, OP_NAMES, host_generate, lane_seeds,
)
from wtf_tpu_torch.devmut.mutator import DevMangleMutator  # noqa: F401
