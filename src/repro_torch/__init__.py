"""PyTorch/CUDA port of the Jenga serving system (``repro`` is the JAX
reference it is held against).

The package keeps the reference's layout (``configs``, ``core``,
``analysis``, ``models``, ``kernels``, ``serving``) so each module's
counterpart is easy to find. It imports torch and numpy only. Entry points
run on ``"cuda"`` unless the caller passes ``device="cpu"``; they raise when
asked for CUDA and no GPU is present (see ``resolve_device``).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default; asking for
    it without a visible GPU raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run on the CPU")
    return dev
