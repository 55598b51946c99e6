"""Train state and train step.

Port of ``omr_a2s_multimodal_transformer_tpu/training/train_state.py``:
Adam(0.9, 0.999, 1e-8) with an optional warmup-cosine schedule and an
optional global-norm clip, and a step that corrupts the decoder input,
runs the teacher-forced forward with dropout and takes one update.

bf16 compute mode casts the whole parameter tree and the inputs (the image
or spectrogram ``x``; ``xi`` and ``xa`` of a multimodal batch) to bf16 for
the forward, as the JAX step does (``_cast_tree``); it is not
``torch.autocast``. Gradients reach the float32 parameters through the
casts, and Adam's state stays float32.

``train_only`` names the top-level parameter groups that train (the JAX
param tree's top-level keys, which are the port model's top-level modules
and parameters by ``training/jax_import.py``'s layout: ``encoder``,
``decoder``; for a multimodal model ``image_encoder``, ``audio_encoder``,
``decoder``, ``cross_attn`` and ``mix_gate``); the others stay frozen, with
no Adam moments, as under ``optax.set_to_zero``.

On a mesh (a model built with ``build_model(..., mesh=)``) the step is
JAX's GSPMD step over the global batch: the loss is the global token mean
(the NLL summed over the data ranks over the summed count, not a mean of
the ranks' means), the gradients are summed over 'data', and the clip's
global norm counts every full parameter once (a sharded parameter's
squares summed over 'model', a replicated one taken once). The step's
generator must be the mesh's (``Mesh.generator``: every draw at the global
shape, ``parallel/mesh.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.func import functional_call

from omr_a2s_multimodal_transformer_tpu_torch.device import DeviceLike, check_module_device
from omr_a2s_multimodal_transformer_tpu_torch.parallel.collectives import all_reduce
from omr_a2s_multimodal_transformer_tpu_torch.training.corruption import corrupt_tokens
from omr_a2s_multimodal_transformer_tpu_torch.training.losses import cross_entropy_sums
from omr_a2s_multimodal_transformer_tpu_torch.utils.debug import check_finite, check_token_ids, debug_checks_enabled


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


def param_groups(model: torch.nn.Module) -> Dict[str, List[torch.nn.Parameter]]:
    """Parameters by top-level group (the first part of each name)."""
    groups: Dict[str, List[torch.nn.Parameter]] = {}
    for name, p in model.named_parameters():
        groups.setdefault(name.split(".")[0], []).append(p)
    return groups


def trainable_parameters(model: torch.nn.Module, train_only: Optional[Sequence[str]] = None
                         ) -> List[torch.nn.Parameter]:
    """Every parameter, or those of the groups named in ``train_only``. A
    name that matches no group raises (the JAX package freezes everything
    then, silently)."""
    if not train_only:
        return list(model.parameters())
    groups = param_groups(model)
    unknown = sorted(set(train_only) - set(groups))
    if unknown:
        raise ValueError(f"train_only names {unknown}, which match no parameter group of {sorted(groups)}")
    return [p for name, ps in groups.items() if name in train_only for p in ps]


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
               clip_norm: float = 0.0, train_only: Optional[Sequence[str]] = None) -> "TrainState":
        """Adam over every parameter, or over the groups in ``train_only``."""
        opt = torch.optim.Adam(trainable_parameters(model, train_only), lr=lr, betas=(0.9, 0.999), eps=1e-8)
        return cls(model, opt, lr, warmup_steps, decay_steps, clip_norm)

    @property
    def mesh(self):
        return getattr(self.model, "mesh", None)

    def _global_norm(self) -> torch.Tensor:
        """The gradients' global norm over the full parameters: on a mesh,
        a sharded parameter's squares summed over 'model', a replicated
        one's taken once."""
        named = [(n, p.grad) for n, p in self.model.named_parameters() if p.grad is not None]
        mesh = self.mesh
        if mesh is None or mesh.size == 1:
            return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for _, g in named]))
        specs = getattr(self.model, "tp_specs", {})
        zero = torch.zeros((), dtype=torch.float32, device=named[0][1].device)
        sharded = sum((g.float().square().sum() for n, g in named if specs.get(n) is not None), zero)
        replicated = sum((g.float().square().sum() for n, g in named if specs.get(n) is None), zero)
        return torch.sqrt(all_reduce(sharded, mesh.model_axis) + replicated)

    def _sum_over_data(self) -> None:
        """Every gradient summed over the data ranks (one flat all-reduce)."""
        mesh = self.mesh
        if mesh is None or mesh.data == 1:
            return
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh.data_axis)
        torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(torch.split(flat, [g.numel() for g in grads]), grads)])

    def current_lr(self) -> float:
        if self.warmup_steps > 0 or self.decay_steps > 0:
            return warmup_cosine(self.step, self.lr, self.warmup_steps, self.decay_steps)
        return self.lr

    @torch.no_grad()
    def apply_gradients(self) -> None:
        """Clip (optax.clip_by_global_norm: scale by clip/norm when norm >=
        clip), set the scheduled lr and take the Adam step.

        The norm runs over the gradients of every parameter, frozen groups
        included, as the JAX package's chain clips before it zeroes the
        frozen groups: a known fault of the reference (frozen gradients
        shrink the trainable step), matched here for parity.

        Adam steps every trainable parameter, as optax does: one that the
        forward did not reach (the encoder of the modality not drawn in a
        multimodal step) takes a zero gradient, so its moments decay and it
        moves by them."""
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self._sum_over_data()
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        if self.clip_norm and self.clip_norm > 0:
            norm = self._global_norm()
            scale = torch.where(norm < self.clip_norm, 1.0, self.clip_norm / norm)
            torch._foreach_mul_(grads, scale)
        for group in self.optimizer.param_groups:
            group["lr"] = self.current_lr()
        self.optimizer.step()
        self.step += 1


def make_train_step(model: torch.nn.Module, vocab_size: int, teacher_forcing_prob: float = 0.2,
                    bf16_compute: bool = True, pad_id: int = 0, multimodal: bool = False,
                    device: DeviceLike = None) -> Callable:
    """Unimodal:   step(state, batch{x, x_hw, y_in, y_out}, generator) -> (state, loss).
    Multimodal: step(state, batch{xi, xi_hw, xa, xa_hw, y_in, y_out}, generator,
                     modality) with modality in {image, audio, both}.

    ``generator`` (a torch.Generator on the model's device) drives token
    corruption and every dropout site. The model must live on ``device``
    (``cuda`` unless the caller says otherwise). Under
    ``OMR_A2S_DEBUG_CHECKS`` (``utils/debug.py``) the step raises on token
    ids outside the vocabulary and on a non-finite loss or gradient.
    """
    check_module_device(model, device)
    checks = debug_checks_enabled()
    mesh = getattr(model, "mesh", None)
    sharded = mesh is not None and mesh.size > 1

    def loss_fn(batch: Dict[str, torch.Tensor], y_in: torch.Tensor, generator: torch.Generator,
                modality: Optional[str]) -> torch.Tensor:
        def cast(x):
            return x.to(torch.bfloat16) if bf16_compute else x

        if multimodal:
            args = (cast(batch["xi"]), batch["xi_hw"], cast(batch["xa"]), batch["xa_hw"], y_in, modality)
        else:
            args = (cast(batch["x"]), batch["x_hw"], y_in)
        if bf16_compute:
            params = {n: p.to(torch.bfloat16) if p.is_floating_point() else p
                      for n, p in model.named_parameters()}
            logits = functional_call(model, params, args, {"generator": generator})
        else:
            logits = model(*args, generator=generator)
        nll, count = cross_entropy_sums(logits, batch["y_out"], pad_id)
        if sharded:  # the global token count (the model ranks hold the same rows)
            count = all_reduce(count.detach().clone(), mesh.data_axis)
        return nll / count.clamp_min(1.0)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator,
             modality: Optional[str] = None) -> Tuple[TrainState, torch.Tensor]:
        if state.model is not model:
            raise ValueError("the train state holds another model than the step was built for")
        if sharded and getattr(generator, "mesh", None) is not mesh:
            raise ValueError("a step on a mesh draws from the mesh's generator (Mesh.generator)")
        if multimodal != (modality is not None):
            raise ValueError(f"a {'multi' if multimodal else 'uni'}modal step takes "
                             f"{'a' if multimodal else 'no'} modality, got {modality!r}")
        if checks:
            check_token_ids("the batch's y_in", batch["y_in"], vocab_size)
            check_token_ids("the batch's y_out", batch["y_out"], vocab_size)
        y_in = corrupt_tokens(generator, batch["y_in"], vocab_size, teacher_forcing_prob, pad_id)
        model.zero_grad(set_to_none=True)  # frozen groups too: their gradients enter the clip's norm
        loss = loss_fn(batch, y_in, generator, modality)
        loss.backward()
        if checks:
            check_finite("the train loss", [loss.detach()])
            check_finite("the gradients", [p.grad for p in model.parameters()])
        state.apply_gradients()
        loss = loss.detach()
        if sharded:  # the global mean: each data rank's part of it summed
            loss = all_reduce(loss.clone(), mesh.data_axis)
        return state, loss

    return step
