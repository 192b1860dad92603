"""`python -m wtf_tpu_torch` -> CLI (wtf_tpu_torch/cli.py)."""

from wtf_tpu_torch.cli import console_main

console_main()
