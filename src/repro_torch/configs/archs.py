"""Aggregator for the ten architectures (one module per arch), a copy of
the JAX package's ``configs/archs.py``.

Sources per architecture:
  granite-moe-1b-a400m   [hf:ibm-granite/granite-3.0-1b-a400m-base]
  phi3.5-moe-42b-a6.6b   [hf:microsoft/Phi-3.5-MoE-instruct]
  seamless-m4t-large-v2  [arXiv:2308.11596]
  recurrentgemma-9b      [arXiv:2402.19427]
  qwen2-72b              [arXiv:2407.10671]
  command-r-35b          [hf:CohereForAI/c4ai-command-r-v01]
  granite-8b             [arXiv:2405.04324]
  qwen2.5-32b            [hf:Qwen/Qwen2.5-32B]
  xlstm-1.3b             [arXiv:2405.04517]
  qwen2-vl-7b            [arXiv:2409.12191]

Every config is registered, and the port's model stack serves all ten.
"""

from .granite_moe_1b_a400m import GRANITE_MOE_1B
from .phi35_moe_42b_a6_6b import PHI35_MOE
from .seamless_m4t_large_v2 import SEAMLESS_M4T
from .recurrentgemma_9b import RECURRENTGEMMA_9B
from .qwen2_72b import QWEN2_72B
from .command_r_35b import COMMAND_R_35B
from .granite_8b import GRANITE_8B
from .qwen25_32b import QWEN25_32B
from .xlstm_1_3b import XLSTM_1_3B
from .qwen2_vl_7b import QWEN2_VL_7B

ALL_ARCHS = [
    GRANITE_MOE_1B, PHI35_MOE, SEAMLESS_M4T, RECURRENTGEMMA_9B, QWEN2_72B,
    COMMAND_R_35B, GRANITE_8B, QWEN25_32B, XLSTM_1_3B, QWEN2_VL_7B,
]
