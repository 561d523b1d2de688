"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``cuda``, and a CUDA device that is not there raises instead of
falling back silently.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "visitron_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
