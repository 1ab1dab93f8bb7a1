"""Device policy of the port's entry points.

`device=None` means the CUDA card.  Without CUDA an entry point raises
unless the caller asked for the CPU explicitly — the port never drops to
the CPU on its own, so a run that was meant for the card cannot quietly
measure the host instead.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The torch.device an entry point runs on (see module docstring)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the CPU")
    return dev
