"""Device resolution for the port's entry points.

Every entry point runs on ``cuda`` unless its caller passes
``device="cpu"``. A CUDA request on a machine without CUDA raises: the
port never moves to the CPU on its own, so a run that meant to measure the
card can not quietly measure the host instead.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. Returns a ``torch.device`` of type ``cuda``
    (with the index of the current card when none is given) or ``cpu``;
    raises ``RuntimeError`` for ``cuda`` without CUDA and
    ``ValueError`` for any other device type."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "apex_tpu_torch runs on CUDA by default and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch versions on the host")
        if dev.index is None:
            # "cuda" and "cuda:<current>" name one card: compare equal
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
