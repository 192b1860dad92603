"""Fuzzing layer: corpus, mutators (copied from wtf_tpu/fuzz) and the
single-process campaign loop."""

from wtf_tpu_torch.fuzz.corpus import Corpus  # noqa: F401
from wtf_tpu_torch.fuzz.mutator import (  # noqa: F401
    ByteMutator, MangleMutator, Mutator, TlvStructureMutator,
    create_mutator,
)
