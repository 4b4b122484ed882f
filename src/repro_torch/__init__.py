"""repro_torch — the PyTorch/CUDA port of the CPM serving stack.

A second package beside the JAX reference ``repro``: same layout and
public names, written in PyTorch, with hand-written CUDA kernels for the
NVIDIA H100 in place of the TPU's Pallas kernels.  It imports nothing of
``repro`` and never imports JAX.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for CUDA without a card raises.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the
    caller's choice otherwise; CUDA without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for (the default) but no GPU is "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch versions")
    return dev
