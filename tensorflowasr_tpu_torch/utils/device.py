"""Where the port's entry points run: on the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means the first CUDA card; raises when a CUDA device is asked
    for and there is none. The CPU runs only when named (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available: the port runs on the card; pass device='cpu' to run the plain versions on the CPU")
    return dev
