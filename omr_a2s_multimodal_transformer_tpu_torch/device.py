"""Device selection and float32 precision policy for the port.

Entry points run on ``cuda`` unless the caller names another device. With
no device given and no GPU present they raise: a measurement or a train
run never falls back to the CPU silently.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``; raises if that is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port on the CPU"
        )
    return dev


def set_float32_precision() -> None:
    """float32 means float32: no TF32 in matmuls or cuDNN convolutions.

    PyTorch's defaults differ between the two (matmul full float32, cuDNN
    convolutions TF32), so both are set here. The fast training mode is
    bf16 compute (``training/train_state.py``), not TF32.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def module_device(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def check_module_device(module: torch.nn.Module, device: DeviceLike) -> torch.device:
    """Resolve ``device`` by the entry-point rule and require the module on it."""
    dev = resolve_device(device)
    have = module_device(module)
    if have.type != dev.type or (dev.index is not None and have.index != dev.index):
        raise ValueError(f"model lives on {have}, entry point asked for {dev}")
    return have
