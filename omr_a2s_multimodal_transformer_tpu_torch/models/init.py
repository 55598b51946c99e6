"""Flax's default initialisers on torch's parameter layouts.

The JAX package's ``nn.Dense`` and ``nn.Conv`` keep flax's defaults: the
kernel from ``lecun_normal`` (a normal truncated at +-2 standard
deviations, scaled to variance 1/fan_in) and a zero bias. Every port
module draws its ``Linear``/``Conv`` parameters here, in its own
constructor, so a layer built alone is drawn as it is inside a model.

fan_in on torch's layouts is the product of every weight dim but the
first: ``Linear [out, in]`` -> in; ``Conv2d [out, in/groups, kh, kw]`` ->
in/groups * kh * kw (9 for a 3x3 depthwise conv); the classifier's
``Conv1d [V, d, 1]`` -> d; the packed ``in_proj_weight [3d, d]`` -> d, as
for each of JAX's three [d, d] kernels.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# The standard deviation of a unit normal truncated to [-2, 2]: flax divides by it so the
# truncated draw keeps variance 1/fan_in (jax.nn.initializers.variance_scaling).
TRUNC_STD = 0.87962566103423978


def fan_in(weight: torch.Tensor) -> int:
    return math.prod(weight.shape[1:])


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor) -> torch.Tensor:
    """flax's ``lecun_normal``: truncated_normal(-2, 2) * sqrt(1/fan_in) / TRUNC_STD.
    ``trunc_normal_`` takes absolute bounds: +-2 standard deviations of its own."""
    s = math.sqrt(1.0 / fan_in(weight)) / TRUNC_STD
    return nn.init.trunc_normal_(weight, 0.0, s, -2.0 * s, 2.0 * s)


@torch.no_grad()
def dense_(layer: nn.Module) -> nn.Module:
    """A ``Linear`` or ``Conv`` drawn as flax's ``Dense``/``Conv``: lecun_normal kernel, zero bias."""
    lecun_normal_(layer.weight)
    if layer.bias is not None:
        layer.bias.zero_()
    return layer
