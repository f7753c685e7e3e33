"""Where the port's entry points run: the card unless the caller asks for
the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card.  Asking for
    CUDA without one raises: there is no silent fallback to the CPU.  On the
    card, float32 products stay float32 (no TF32), as the reference's."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA was asked for and is not available; "
                               "pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
