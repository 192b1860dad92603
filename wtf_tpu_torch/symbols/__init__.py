"""Symbolization layer (reference L3, debugger.{h,cc})."""

from wtf_tpu_torch.symbols.debugger import Debugger

__all__ = ["Debugger"]
