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
    """``None`` means ``cuda``; raises if that is asked for and absent. A
    CUDA device without an index is the runtime's current device, named
    with its index (in a run of a rank a card, the rank's card:
    ``parallel/multihost.py`` ``initialize`` makes it current)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the port on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
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
    """Check ``device`` by the entry-point rule and require the module on
    it (on any card for ``cuda`` without an index); returns the module's."""
    resolve_device(device)
    asked = torch.device("cuda" if device is None else device)
    have = module_device(module)
    if have.type != asked.type or (asked.index is not None and have.index != asked.index):
        raise ValueError(f"model lives on {have}, entry point asked for {asked}")
    return have
