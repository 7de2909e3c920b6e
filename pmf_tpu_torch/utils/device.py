"""Device choice of the port's entry points, and their float32 setting."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The entry points run on the card unless the caller asks for the CPU;
    a request for CUDA without a card raises instead of falling back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def disable_tf32() -> None:
    """Run float32 convolutions and matmuls on the card in float32, not in
    TF32 (PyTorch's default for cuDNN convolutions): the float32 configs
    (SalsaNext, SensatUrban) then compute as the CPU reference does."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
