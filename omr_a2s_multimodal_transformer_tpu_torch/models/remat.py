"""Rematerialization: a block's activations recomputed in the backward.

The counterpart of ``flax.linen.remat`` on the JAX package's encoder blocks
and decoder layers (``encoder.py:323-325``, ``decoder.py:248``), on
``torch.utils.checkpoint`` (non-reentrant). Two things the checkpoint does
not do by itself:

- The port's dropout draws from explicit ``torch.Generator``s, whose state
  ``preserve_rng_state`` does not restore (it restores only the default
  generators, which the port never draws from; it is off). ``remat``
  takes the generator's state at the forward, sets it again for the
  recompute and puts the state the backward found back after it, so the
  recompute draws the forward's masks and the next draws are unchanged.
- The bf16 train step swaps bf16 copies of the parameters in for the
  forward (``torch.func.functional_call``), and the swap has ended when
  the backward recomputes. The parameters the forward used are passed to
  the checkpoint as inputs and swapped in again for the recompute.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint


def remat(module: torch.nn.Module, generator: Optional[torch.Generator], *args):
    """``module(*args)``, its activations recomputed in the backward;
    ``generator`` is the one the module draws its dropout from (None: it
    draws nothing)."""
    names, params = zip(*module.named_parameters())
    n = len(params)
    state = None if generator is None else generator.get_state()
    ran = []

    def run(*flat):
        call = lambda: functional_call(module, dict(zip(names, flat[:n])), flat[n:])  # noqa: E731
        if not ran or generator is None:  # the forward
            ran.append(True)
            return call()
        found = generator.get_state()
        generator.set_state(state)
        try:
            return call()
        finally:
            generator.set_state(found)

    return checkpoint(run, *params, *args, use_reentrant=False, preserve_rng_state=False)
