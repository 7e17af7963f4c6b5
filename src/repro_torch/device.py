"""Where the port runs: the card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[torch.device | str] = None) -> torch.device:
    """``None`` means the card; without one that raises rather than falling
    back to the CPU.  Pass ``"cpu"`` to run there on purpose."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev
