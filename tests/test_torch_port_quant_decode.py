"""The port's quantized cross-KV decode (``cache_dtype`` int8 and int4)
against the JAX package's, on the CPU.

- The quantizer on identical float K/V (the cross projections set to the
  identity, so both packages quantize the same float32 arrays): codes bit
  for bit, scales to 1 ulp; int4 codes through ``pack_int4`` and
  ``unpack_int4`` (even channel in the low nibble, sign-extended).
- ``attend_packed_single_query`` on the same codes and scales, int8 and
  int4: outputs within 1e-5 of max |out| (both fold the scales at the same
  points and round q and the softmax weights to bf16; only the float32
  summation order differs).
- ``prefill`` and one decoder step of a small model initialised by JAX
  and loaded into the port by ``training/jax_import.py``. The encoders'
  float32 sums run in another order (their memories lie ~1e-5 apart), so:
  codes equal but where t / scale lies within 0.05 of a rounding
  boundary, and there within one step; scales within 1e-4 (they are
  maxima of that memory's projections, seen 3e-5 apart); step logits
  within 5e-3 of max |logits|: a code that flips moves one element by a
  quantization step, as a bf16 rounding flip moves it in the bf16 cache,
  whose own port-vs-JAX gap on such JAX-initialised models is 2.2-3.1e-3
  (int8 2.3-3.4e-3, int4 2.1-2.9e-3; float32 1e-5; seeds 21-23).
- greedy and beam-2 decoding over 20 steps: tokens equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import EOS, SOS, V, batch, hparams, jax_model, port_and_jax_params, to_torch

from omr_a2s_multimodal_transformer_tpu.models.decoder import KernDecoder as JaxDecoder
from omr_a2s_multimodal_transformer_tpu.ops import attention as jattn
from omr_a2s_multimodal_transformer_tpu.training import decode as jdecode
from omr_a2s_multimodal_transformer_tpu_torch.models import build_model
from omr_a2s_multimodal_transformer_tpu_torch.models.decoder import KernDecoder, quantize_cross
from omr_a2s_multimodal_transformer_tpu_torch.ops import attention as pattn
from omr_a2s_multimodal_transformer_tpu_torch.training import decode as pdecode
from omr_a2s_multimodal_transformer_tpu_torch.training.jax_import import load_jax_params

QUANT = ["int8", "int4"]
D, HEADS, S = 32, 4, 40


def _outlier_kv(seed, b=2, s=S, d=D):
    """K/V-like float32 [B, S, D] with a tail of outlier positions (padded
    memory columns through the projections) and one all-zero channel."""
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(b, s, d)).astype(np.float32)
    t[:, s - 6:, :] *= 8.0
    t[:, :, 3] = 0.0  # a zero channel: its scale is the 1e-8 floor
    return t


def _jax_codes(x):
    return np.asarray(x).astype(np.int8)


def _identity_prefill_jax(mem, cache_dtype):
    """JAX's KernDecoder.prefill with every layer's cross k/v projections
    the identity: it quantizes ``mem`` itself (v: -mem)."""
    dec = JaxDecoder(vocab_size=5, max_seq_len=4, d_model=D, n_heads=HEADS, ff_dim=D, n_layers=1,
                     cache_dtype=cache_dtype)
    params = dec.init(jax.random.PRNGKey(0), jnp.zeros((1, 2), jnp.int32), jnp.zeros((1, 3, D)))
    params = jax.tree.map(np.asarray, params)
    ca = params["params"]["layer0"]["cross_attn"]
    ca["k_proj"] = {"kernel": np.eye(D, dtype=np.float32), "bias": np.zeros(D, np.float32)}
    ca["v_proj"] = {"kernel": -np.eye(D, dtype=np.float32), "bias": np.zeros(D, np.float32)}
    return dec.apply(params, jnp.asarray(mem), method=JaxDecoder.prefill)["layer0"]


def _identity_prefill_port(mem, cache_dtype):
    dec = KernDecoder(vocab_size=5, max_seq_len=4, d_model=D, n_heads=HEADS, ff_dim=D, n_layers=1,
                      cache_dtype=cache_dtype)
    with torch.no_grad():
        eye = torch.eye(D)
        dec.layers[0].multihead_attn.in_proj_weight[D:] = torch.cat([eye, -eye])
        dec.layers[0].multihead_attn.in_proj_bias[D:] = 0.0
        return dec.prefill(torch.from_numpy(mem))["layer0"]


@pytest.mark.parametrize("cache_dtype", QUANT)
def test_quantizer_codes_bit_equal_jax(cache_dtype):
    mem = _outlier_kv(1)
    got, want = _identity_prefill_port(mem, cache_dtype), _identity_prefill_jax(mem, cache_dtype)
    names = ("k", "v", "k_scale", "v_scale") + (("k_tscale", "v_tscale") if cache_dtype == "int4" else ())
    assert sorted(got) == sorted(want) == sorted(names)
    for name in ("k", "v"):
        codes = got[name]
        if cache_dtype == "int4":
            assert codes.dtype == torch.uint8 and codes.shape == (2, S, D // 2)
            codes = pattn.unpack_int4(codes)
            assert torch.equal(pattn.pack_int4(codes), got[name])
        else:
            assert codes.dtype == torch.int8 and codes.shape == (2, S, D)
        np.testing.assert_array_equal(codes.numpy(), _jax_codes(want[name]), err_msg=name)
        qmax = 127 if cache_dtype == "int8" else 7
        assert int(codes.abs().max()) == qmax
    for name in names[2:]:
        np.testing.assert_array_max_ulp(got[name].numpy(), np.asarray(want[name]), maxulp=1)
    # the same function, called alone
    direct = quantize_cross(torch.from_numpy(mem), cache_dtype)
    assert torch.equal(direct["q"], got["k"]) and torch.equal(direct["scale"], got["k_scale"])


def test_int4_packing_sign_extends_every_code():
    codes = torch.arange(-8, 8, dtype=torch.int8).repeat(3, 2)  # [3, 32]: every nibble in both positions
    packed = pattn.pack_int4(codes)
    assert packed.dtype == torch.uint8 and packed.shape == (3, 16)
    assert int(packed[0, 0]) == ((-8) & 0xF) | (((-7) & 0xF) << 4)  # even channel low, odd channel high
    assert torch.equal(pattn.unpack_int4(packed), codes)


@pytest.mark.parametrize("cache_dtype", QUANT)
def test_attend_single_query_quantized_equals_jax(cache_dtype):
    rng = np.random.default_rng(2)
    entry = _identity_prefill_jax(_outlier_kv(3), cache_dtype)
    q = rng.normal(size=(2, D)).astype(np.float32)
    bias = np.where(np.arange(S)[None, :] < S - 6, 0.0, -1e9).astype(np.float32).repeat(2, 0)
    kw = {n: entry[n] for n in ("k_scale", "v_scale", "k_tscale", "v_tscale") if n in entry}
    want = np.asarray(jattn.attend_packed_single_query(jnp.asarray(q), entry["k"], entry["v"], HEADS,
                                                       jnp.asarray(bias), **kw))
    codes = {n: torch.from_numpy(_jax_codes(entry[n])) for n in ("k", "v")}
    if cache_dtype == "int4":
        codes = {n: pattn.pack_int4(c) for n, c in codes.items()}
    got = pattn.attend_packed_single_query(torch.from_numpy(q), codes["k"], codes["v"], HEADS,
                                           torch.from_numpy(bias),
                                           **{n: torch.from_numpy(np.array(t)) for n, t in kw.items()})
    assert got.dtype == torch.float32 and got.shape == (2, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("cache_dtype", QUANT)
def test_prefill_and_one_step_equal_jax(cache_dtype):
    jm = jax_model(cache_dtype=cache_dtype)
    b = batch(seed=21)
    params = jm.init(jax.random.PRNGKey(21), jnp.asarray(b["x"]), jnp.asarray(b["x_hw"]), jnp.asarray(b["y_in"]))
    model, _ = build_model(hparams(cache_dtype=cache_dtype), device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params["params"]))
    cross_j, valid_j = jm.apply(params, jnp.asarray(b["x"]), jnp.asarray(b["x_hw"]), method=type(jm).decode_prefill)
    tb = to_torch(b)
    with torch.no_grad():
        cross_p, valid_p = model.decode_prefill(tb["x"], tb["x_hw"])
    np.testing.assert_array_equal(valid_p.numpy(), np.asarray(valid_j))
    assert self_cache_is_bf16(model.decode_init_cache(2))
    with torch.no_grad():
        memory, _ = model.encode(tb["x"], tb["x_hw"])
    for i, layer in enumerate(cross_j):
        cj, cp = cross_j[layer], cross_p[layer]
        assert sorted(cj) == sorted(cp)
        with torch.no_grad():
            floats = model.decoder.layers[i].cross_kv(memory)
        for n, t in zip(("k", "v"), floats):
            codes = pattn.unpack_int4(cp[n]) if cache_dtype == "int4" else cp[n]
            diff = np.abs(codes.numpy().astype(np.int32) - _jax_codes(cj[n]).astype(np.int32))
            # t / scale before the rounding: a code may differ only where it lies by a rounding boundary
            ratio = t.float() / cp[f"{n}_scale"][:, None, :]
            if cache_dtype == "int4":
                ratio = ratio / cp[f"{n}_tscale"][:, :, None]
            to_boundary = ((ratio - ratio.floor()) - 0.5).abs().numpy()
            assert diff.max() <= 1 and (to_boundary[diff > 0] < 0.05).all(), (layer, n, diff.mean())
        for n in cj:
            if "scale" in n:
                np.testing.assert_allclose(cp[n].numpy(), np.asarray(cj[n]), rtol=1e-4, err_msg=f"{layer} {n}")
    tok = np.array([SOS, SOS], np.int32)
    cache_j = jm.apply(params, 2, method=type(jm).decode_init_cache)
    logits_j, _ = jm.apply(params, jnp.asarray(tok), 0, cache_j, cross_j, valid_j, method=type(jm).decode_step)
    with torch.no_grad():
        logits_p, _ = model.decode_step(torch.from_numpy(tok).long(), 0, model.decode_init_cache(2), cross_p,
                                        valid_p)
    want = np.asarray(logits_j)
    np.testing.assert_allclose(logits_p.numpy(), want, rtol=0, atol=5e-3 * float(np.abs(want).max()))


def self_cache_is_bf16(cache) -> bool:
    return all(t.dtype == torch.bfloat16 for layer in cache.values() for t in layer.values())


STEPS = 20


@pytest.mark.parametrize("beam", [1, 2], ids=["greedy", "beam2"])
@pytest.mark.parametrize("cache_dtype", QUANT)
def test_decode_tokens_equal_jax(cache_dtype, beam):
    """Greedy: 20 steps with an eos no model emits, so every step runs.
    Beam 2 (eos a token the model emits, so beams finish and freeze)
    reorders the self-cache and repeats every cross entry, scales among
    them, for its rows."""
    over = dict(cache_dtype=cache_dtype, max_seq_len=STEPS)
    model, params = port_and_jax_params(seed=22, **over)
    b = batch(seed=22)
    tb = to_torch(b)
    if beam == 1:
        tok_j, _ = jax.jit(jdecode.greedy_decode_fn(jax_model(**over), STEPS, SOS, V))(
            params, jnp.asarray(b["x"]), jnp.asarray(b["x_hw"]))
        tok_p, _ = pdecode.greedy_decode_fn(model, STEPS, SOS, V)(tb["x"], tb["x_hw"])
        assert int((tok_p != 0).sum()) == 2 * STEPS
    else:
        tok_j, _ = jax.jit(jdecode.beam_decode_fn(jax_model(**over), STEPS, SOS, EOS, beam_size=beam))(
            params, jnp.asarray(b["x"]), jnp.asarray(b["x_hw"]))
        tok_p, _ = pdecode.beam_decode_fn(model, STEPS, SOS, EOS, beam_size=beam)(tb["x"], tb["x_hw"])
    assert tok_p.shape == (2, STEPS)
    np.testing.assert_array_equal(tok_p.numpy(), np.asarray(tok_j))
