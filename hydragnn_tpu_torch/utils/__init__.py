"""Utilities of the port: device resolution shared by the entry points
(here), the retry policy (``utils.retry``) and the wire transport of the
serving fleet (``utils.wire``)."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when no card is
    present: the entry points run on the card unless the caller asks for
    the CPU (``device="cpu"``). A CUDA device gets its index, so it compares
    equal to the device of the tensors placed on it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hydragnn_tpu_torch runs on a CUDA device by default and none is "
            "available (torch.cuda.is_available() is False); pass device='cpu' "
            "to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device} (cuda or cpu)")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


__all__ = ["resolve_device"]
