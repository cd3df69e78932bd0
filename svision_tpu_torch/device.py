"""Where the port runs: the card unless the caller asks for the CPU.

Every entry point resolves its device here (the engine, the trainers, the
AlexNet constructors), so none of them carries on on the CPU without being
asked. A leaf module: the models and the engine both import it.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> the current CUDA device. Raises when CUDA is asked for (or
    implied) and no GPU is present: the port never carries on on the CPU
    unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "(--device cpu) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
