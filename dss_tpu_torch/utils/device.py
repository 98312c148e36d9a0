"""Where the port's entry points put their tensors when the caller names no
device: on the card."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as given; None means the card, cuda:0.  Without a card, None
    raises: a caller that wants the CPU passes device="cpu"."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "dss_tpu_torch builds on the CUDA card by default and found none: "
            "pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", 0)
