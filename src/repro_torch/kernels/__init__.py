"""Hand-written Hopper kernels of the port and their plain twins.

flash_attention.py — blocked online-softmax attention
(``csrc/flash_attention.cu``); cpm_kernels.py — the fused CPM instruction
stream (``csrc/fused_stream.cu``), the paged-row moves ``gather_rows``
/ ``scatter_rows`` (``csrc/rows.cu``) and the per-op ``compare``,
``substring_match``, ``section_sum`` / ``section_limit``, ``compact``,
``histogram``, ``super_sum`` / ``super_limit`` and ``oddeven_sort``
(``csrc/compare.cu``, ``substring_match.cu``, ``reduce.cu``,
``compact.cu``, ``histogram.cu``, ``super_reduce.cu``,
``oddeven_sort.cu``); ref.py — plain oracles;
ops.py — device dispatch and launch counters; _build.py — nvcc build and
ctypes loading.  No module builds or loads a kernel at import time.
"""

from . import cpm_kernels, flash_attention, ops, ref

__all__ = ["cpm_kernels", "flash_attention", "ops", "ref"]
