"""The device an entry point runs on.

Entry points (``CountingService``, ``python -m desco_tpu_torch.serve``)
run on CUDA unless the caller asks for another device; with no GPU
visible they raise instead of falling back to the CPU. The parity
reference is desco_tpu's XLA float32 path, so float32 matmuls and
convolutions run in full float32: TF32 is switched off for both.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Raises when CUDA is asked for and absent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "desco_tpu_torch runs on a CUDA device by default and none is "
            "visible; pass device='cpu' to run on the CPU")
    return dev


def device_label(device) -> str:
    """What a tool prints beside its numbers: the card's name, or "cpu"."""
    dev = torch.device(device)
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)
