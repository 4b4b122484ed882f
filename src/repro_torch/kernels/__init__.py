"""Hand-written Hopper kernels of the port and their plain twins.

flash_attention.py — blocked online-softmax attention
(``csrc/flash_attention.cu``); cpm_kernels.py — the fused CPM instruction
stream (``csrc/fused_stream.cu``); ref.py — plain attention oracles;
ops.py — device dispatch and launch counters; _build.py — nvcc build and
ctypes loading.  No module builds or loads a kernel at import time.
"""

from . import cpm_kernels, flash_attention, ops, ref

__all__ = ["cpm_kernels", "flash_attention", "ops", "ref"]
