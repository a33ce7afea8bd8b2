"""Device resolution for the port's entry points.

The default is the CUDA device.  The CPU is used only when the caller asks
for it (the tests do); a missing GPU is an error, never a silent fallback.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``"cuda"`` (default) or ``"cpu"`` -> a :class:`torch.device`.

    Raises ``RuntimeError`` when CUDA is asked for and absent, and
    ``ValueError`` for any other device type.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(
            f"unsupported device {device!r}; expected 'cuda' or 'cpu'")
    return dev
