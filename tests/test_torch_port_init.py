"""The port's initial weights against JAX's own ``model.init``.

The parity tests convert one set of weights for both packages, so they
cannot see how each package draws its first weights. Here JAX initialises
its model, the port builds its own from a seed, and the port's state_dict
goes through the JAX package's converters: the two trees must have the
same leaves and shapes, zeros and ones at the same leaves, and kernels of
the same distribution, flax's ``lecun_normal`` (a normal truncated at
+-2 standard deviations, scaled to variance 1/fan_in).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omr_a2s_multimodal_transformer_tpu.training.torch_import import convert_unimodal_state_dict
from omr_a2s_multimodal_transformer_tpu_torch.models import build_model
from torch_port_common import (
    AUDIO_T,
    IMG_H,
    IMG_W,
    MAXLEN,
    hparams,
    jax_mm_model,
    jax_model,
    mm_hparams,
    mm_state_dict_to_jax,
)

TRUNC_STD = 0.87962566103423978  # a unit normal cut at +-2 has this std
LIMIT = 2.0 / TRUNC_STD  # flax's truncation of w * sqrt(fan_in)
MIN_LEAF = 2304  # elements: a sample std within 7% is 5 of its sigmas
MIXER = dict(mixer_type="attn_both", mixer_residual=True)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v, np.float64)})
    return out


def _spec(shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


TOKENS, HW = _spec((2, MAXLEN), jnp.int32), _spec((2, 2), jnp.int32)
IMAGE, AUDIO = _spec((2, IMG_H, IMG_W, 1)), _spec((2, 195, AUDIO_T, 1))


# flax's ``lazy_init`` draws the parameters as ``init`` does, on abstract
# inputs: the forward is traced, not compiled and run.
def _jax_image():
    return jax_model().lazy_init(jax.random.PRNGKey(0), IMAGE, HW, TOKENS)["params"]


def _jax_audio():
    return jax_model().lazy_init(jax.random.PRNGKey(0), AUDIO, HW, TOKENS)["params"]


def _jax_mixer():
    return jax_mm_model(**MIXER).lazy_init(jax.random.PRNGKey(0), IMAGE, HW, AUDIO, HW, TOKENS, "both")["params"]


def _port(kind, seed=0):
    if kind == "mixer":
        model, _ = build_model(mm_hparams(**MIXER), device="cpu", seed=seed)
        return mm_state_dict_to_jax(model.state_dict())
    model, _ = build_model(hparams(input_modality=kind), device="cpu", seed=seed)
    return convert_unimodal_state_dict({k: v.detach().clone() for k, v in model.state_dict().items()})


# the image model first: the other two reuse most of its compiled draws
JAX_INIT = {"image": _jax_image, "mixer": _jax_mixer, "audio": _jax_audio}


@pytest.fixture(scope="module", params=list(JAX_INIT))
def trees(request):
    return request.param, _flat(JAX_INIT[request.param]()), _flat(_port(request.param))


def _kernels(leaves):
    """{path: (values, fan_in)} of every Dense/Conv kernel; flax's layouts
    are [in, out] and [kh, kw, in/groups, out]."""
    return {p: (v, math.prod(v.shape[:-1])) for p, v in leaves.items() if p.endswith("/kernel")}


def _std_checks(leaves):
    """(name, sample std * sqrt(fan_in), tolerance) for each kernel of at
    least MIN_LEAF elements and for the smaller ones pooled by fan_in."""
    checks, small = [], {}
    for p, (v, fan) in _kernels(leaves).items():
        if v.size >= MIN_LEAF:
            checks.append((p, v.std() * math.sqrt(fan), 0.07))
        else:
            small.setdefault(fan, []).append(v.ravel())
    for fan, parts in small.items():
        v = np.concatenate(parts)
        tol = 0.07 if v.size >= MIN_LEAF else 5.0 / math.sqrt(2.0 * v.size)
        checks.append((f"kernels of fan_in {fan} ({len(parts)} pooled)", v.std() * math.sqrt(fan), tol))
    return checks


def test_port_init_has_jax_leaves_and_shapes(trees):
    _, want, got = trees
    assert sorted(got) == sorted(want)
    for p in want:
        assert got[p].shape == want[p].shape, p


def test_port_init_has_zeros_and_ones_where_jax_has_them(trees):
    """Every bias, LayerNorm and gate leaf JAX starts at a constant starts
    there in the port, and no other port leaf is constant."""
    _, want, got = trees
    for p, w in want.items():
        for const in (0.0, 1.0):
            assert np.all(w == const) == np.all(got[p] == const), f"{p}: JAX all {const} {np.all(w == const)}"
    assert any(np.all(w == 1.0) for w in want.values()) and any(np.all(w == 0.0) for w in want.values())


@pytest.mark.parametrize("side", ["jax", "port"])
def test_kernels_have_lecun_normal_std(trees, side):
    """Each kernel's std within 7% of sqrt(1/fan_in) (JAX's own draw meets
    the same checks), and the embedding's within 7% of 1."""
    _, want, got = trees
    leaves = want if side == "jax" else got
    for name, ratio, tol in _std_checks(leaves):
        assert abs(ratio - 1.0) <= tol, f"{side} {name}: std * sqrt(fan_in) = {ratio:.4f}"
    emb = leaves["decoder/embedding"]
    assert abs(emb.std() - 1.0) <= 0.07 and abs(emb.mean()) <= 0.05


@pytest.mark.parametrize("side", ["jax", "port"])
def test_kernels_pooled_are_truncated_at_two_sigma(trees, side):
    """w * sqrt(fan_in) of all kernels pooled: variance 1 +- 1%, every value
    inside flax's truncation +-2 / 0.8796."""
    _, want, got = trees
    z = np.concatenate([v.ravel() * math.sqrt(fan) for v, fan in _kernels(want if side == "jax" else got).values()])
    assert abs(z.var() - 1.0) <= 0.01, f"{side}: pooled variance {z.var():.4f} over {z.size} values"
    assert np.abs(z).max() <= LIMIT * (1 + 1e-6), f"{side}: max |w| sqrt(fan_in) {np.abs(z).max():.4f}"
    # a truncated normal reaches close to its bounds in millions of draws
    assert np.abs(z).max() >= 0.99 * LIMIT


def test_port_init_is_seeded():
    """The same seed draws the same weights; another seed draws other ones."""
    a, b, c = (build_model(hparams(), device="cpu", seed=s)[0].state_dict() for s in (0, 0, 1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    drawn = [k for k in a if a[k].dtype.is_floating_point and a[k].numel() > 1 and a[k].std() > 0]
    assert drawn and not any(torch.equal(a[k], c[k]) for k in drawn)
