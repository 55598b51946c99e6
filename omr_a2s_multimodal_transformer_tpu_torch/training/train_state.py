"""Train state and train step.

Port of ``omr_a2s_multimodal_transformer_tpu/training/train_state.py``:
Adam(0.9, 0.999, 1e-8) with an optional warmup-cosine schedule and an
optional global-norm clip, and a step that corrupts the decoder input,
runs the teacher-forced forward with dropout and takes one update.

bf16 compute mode casts the whole parameter tree and the image to bf16 for
the forward, as the JAX step does (``_cast_tree``); it is not
``torch.autocast``. Gradients reach the float32 parameters through the
casts, and Adam's state stays float32. ``train_only`` is not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch
from torch.func import functional_call

from omr_a2s_multimodal_transformer_tpu_torch.device import DeviceLike, check_module_device
from omr_a2s_multimodal_transformer_tpu_torch.training.corruption import corrupt_tokens
from omr_a2s_multimodal_transformer_tpu_torch.training.losses import cross_entropy_ignore_pad


def warmup_cosine(count: int, lr: float, warmup_steps: int, decay_steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, max(warmup, 1),
    max(decay, warmup + 1), end=lr/10) at update ``count`` (0-based)."""
    warmup = max(warmup_steps, 1)
    decay = max(decay_steps, warmup_steps + 1)
    if count < warmup:
        return lr * count / warmup
    span = decay - warmup
    c = min(count - warmup, span)
    cosine = 0.5 * (1.0 + math.cos(math.pi * c / span))
    return lr * ((1.0 - 0.1) * cosine + 0.1)


@dataclass
class TrainState:
    """The model (its parameters) and Adam, with the schedule and clip."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    lr: float
    warmup_steps: int = 0
    decay_steps: int = 0
    clip_norm: float = 0.0
    step: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module, lr: float = 1e-4, warmup_steps: int = 0, decay_steps: int = 0,
               clip_norm: float = 0.0) -> "TrainState":
        opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
        return cls(model, opt, lr, warmup_steps, decay_steps, clip_norm)

    def current_lr(self) -> float:
        if self.warmup_steps > 0 or self.decay_steps > 0:
            return warmup_cosine(self.step, self.lr, self.warmup_steps, self.decay_steps)
        return self.lr

    @torch.no_grad()
    def apply_gradients(self) -> None:
        """Clip (optax.clip_by_global_norm: scale by clip/norm when norm >=
        clip), set the scheduled lr and take the Adam step."""
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        if self.clip_norm and self.clip_norm > 0:
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = torch.where(norm < self.clip_norm, 1.0, self.clip_norm / norm)
            torch._foreach_mul_(grads, scale)
        for group in self.optimizer.param_groups:
            group["lr"] = self.current_lr()
        self.optimizer.step()
        self.step += 1


def make_train_step(model: torch.nn.Module, vocab_size: int, teacher_forcing_prob: float = 0.2,
                    bf16_compute: bool = True, pad_id: int = 0, device: DeviceLike = None) -> Callable:
    """step(state, batch{x, x_hw, y_in, y_out}, generator) -> (state, loss).

    ``generator`` (a torch.Generator on the model's device) drives token
    corruption and every dropout site. The model must live on ``device``
    (``cuda`` unless the caller says otherwise).
    """
    check_module_device(model, device)

    def loss_fn(batch: Dict[str, torch.Tensor], y_in: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        if bf16_compute:
            params = {n: p.to(torch.bfloat16) if p.is_floating_point() else p
                      for n, p in model.named_parameters()}
            x = batch["x"].to(torch.bfloat16)
            logits = functional_call(model, params, (x, batch["x_hw"], y_in), {"generator": generator})
        else:
            logits = model(batch["x"], batch["x_hw"], y_in, generator=generator)
        return cross_entropy_ignore_pad(logits, batch["y_out"], pad_id)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator) -> Tuple[TrainState, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the train state holds another model than the step was built for")
        y_in = corrupt_tokens(generator, batch["y_in"], vocab_size, teacher_forcing_prob, pad_id)
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(batch, y_in, generator)
        loss.backward()
        state.apply_gradients()
        return state, loss.detach()

    return step

