"""wtf_tpu_torch: the snapshot fuzzer's batched x86-64 interpreter in
PyTorch, with its TPU kernels rewritten by hand for NVIDIA Hopper.

A port of the JAX package `wtf_tpu` (which stays the reference), slice by
slice; module paths mirror it, so `wtf_tpu_torch/interp/step.py` is the
counterpart of `wtf_tpu/interp/step.py`.  The package imports torch,
numpy and the standard library — never jax and nothing of `wtf_tpu`: the
JAX-free host layers it needs (core, cpu, snapshot, symbols, harness,
backend/base, fuzz corpus and mutators, telemetry, utils, trace) are
copied in with only their imports rewritten.

Layering:
  core/ cpu/ snapshot/ symbols/ harness/ utils/ trace/  host layers (copied)
  mem/      - physical image, page walk, per-lane delta overlay (torch)
  interp/   - ints (64-bit guest arithmetic), machine, decode cache, the
              precise step, the fused step + its CUDA kernel, the runner
  csrc/     - hand-written CUDA kernels for sm_90a and their build helper
  meshrun/  - the batch coverage merge and the lane mesh (shards of the
              batch over devices, one logical backend)
  backend/  - Backend contract, the oracle backend, GpuBackend
  fuzz/     - corpus, mutators, the campaign loop
  device.py - device choice: CUDA unless the CPU is asked for
  convert.py- state conversion to and from the JAX package's layout
  cli.py    - `run` and `campaign`
"""

__version__ = "0.1.0"
