"""The port's inference layer against the JAX package's, on the CPU.

- ``weighted_decode_fn``: two unimodal models (an image and an audio one)
  in lockstep: tokens equal, the mixed top-1 probabilities within 1e-5.
  With two models of different ``max_seq_len`` the shorter one is stepped
  past its length: JAX clamps its positional row and cache slot, and so
  does the port (greedy decoding past ``max_seq_len`` too, on the flat
  cache and on the ring).
- ``beam_decode_fn`` at beam 1, 2 and 4 and length penalty 0 and 0.6 on
  the flat cache, the windowed ring cache and the multimodal model, with
  an eos id the models emit, so beams finish and freeze: tokens equal,
  scores within 1e-4 (the port in float32, JAX in float64); beam 1 gives
  greedy's tokens up to the first eos.
- ``fusion/smith_waterman.py``: ``_sw_python`` equals JAX's, and
  ``align_tokens`` and ``fuse_predictions`` equal JAX's by whichever route
  JAX takes, on random sequences over a small vocabulary (ties occur),
  with several penalty sets (``gap_extend > gap_open`` among them).
- ``preprocess_image_batch``'s bicubic resize equals ``jax.image.resize``
  within 1e-5 (down- and up-scaling, odd widths) with ``hw`` equal.
- ``make_fused_transcriber`` (and the image transcriber with
  ``img_height``) give JAX's tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import (
    EOS,
    IMG_H,
    IMG_W,
    MAXLEN,
    SOS,
    V,
    batch,
    jax_mm_model,
    jax_model,
    mm_batch,
    mm_port_and_jax_params,
    port_and_jax_params,
    to_torch,
)

from omr_a2s_multimodal_transformer_tpu.fusion import smith_waterman as jsw
from omr_a2s_multimodal_transformer_tpu.training import decode as jdecode
from omr_a2s_multimodal_transformer_tpu_torch.fusion import smith_waterman as psw
from omr_a2s_multimodal_transformer_tpu_torch.ops.image import preprocess_image_batch
from omr_a2s_multimodal_transformer_tpu_torch.training import decode as pdecode
import torch_port_cache  # noqa: F401, E402  (a frontend cache folder of this process)

NO_DROPOUT = dict(encoder_dropout=0.0, decoder_dropout=0.0, pos_dropout=0.0)
AUDIO_T = 24


def _count_steps(model):
    """Positions at which ``model.decode_step`` is called, from now on."""
    seen, step = [], model.decode_step

    def counting(tok, pos, *rest):
        seen.append(pos)
        return step(tok, pos, *rest)

    model.decode_step = counting
    return seen


def _audio_inputs(seed, b=2):
    """Spectrogram-like inputs [B, 195, T, 1] of an audio model, ragged frames."""
    rng = np.random.default_rng(seed)
    xa = rng.uniform(size=(b, 195, AUDIO_T, 1)).astype(np.float32)
    hwa = np.array([[195, AUDIO_T]] + [[195, AUDIO_T - 9]] * (b - 1), np.int32)
    xa[1:, :, AUDIO_T - 9:] = 0.0
    return xa, hwa


# ------------------------------------------------------------------ weighted


@pytest.mark.parametrize("case", [dict(alpha=0.5, audio_len=MAXLEN, eos=EOS), dict(alpha=0.3, audio_len=MAXLEN, eos=22),
                                  dict(alpha=0.5, audio_len=MAXLEN + 6, eos=V)],
                         ids=["a05", "a03_eos22", "clamp"])
def test_weighted_decode_equals_jax(case):
    """The last case decodes to the audio model's max_seq_len 18 with an eos
    no model emits: the image model (max_seq_len 12) runs 6 steps past its
    length, its positional row and cache slot clamped as JAX clamps them."""
    img, pi = port_and_jax_params(seed=11)
    aud, pa = port_and_jax_params(seed=12, max_seq_len=case["audio_len"], input_modality="audio")
    b = batch(seed=11)
    xa, hwa = _audio_inputs(12)
    max_len = max(MAXLEN, case["audio_len"])
    fn = jax.jit(jdecode.weighted_decode_fn(jax_model(), jax_model(max_seq_len=case["audio_len"]), max_len, SOS,
                                            case["eos"]))
    tok_j, score_j = fn(pi, pa, jnp.asarray(b["x"]), jnp.asarray(b["x_hw"]), jnp.asarray(xa), jnp.asarray(hwa),
                        jnp.float32(case["alpha"]))
    positions = _count_steps(img)
    tok_p, score_p = pdecode.weighted_decode_fn(img, aud, max_len, SOS, case["eos"])(
        torch.from_numpy(b["x"]), torch.from_numpy(b["x_hw"]), torch.from_numpy(xa), torch.from_numpy(hwa),
        case["alpha"])
    assert tok_p.shape == (2, max_len)
    np.testing.assert_array_equal(tok_p.numpy(), np.asarray(tok_j))
    np.testing.assert_allclose(score_p.numpy(), np.asarray(score_j), rtol=0, atol=1e-5)
    assert float(score_p.max()) <= 1.0 + 1e-6  # a probability, not a logit
    if case["eos"] == V:  # every step ran, the image model's past its length
        assert positions == list(range(max_len))


@pytest.mark.parametrize("window", [-1, 4], ids=["flat", "ring"])
def test_greedy_past_max_seq_len_equals_jax(window):
    """Greedy decode to max_seq_len + 5 steps: JAX clamps the positional
    row (and on the flat cache the write slot) to the last one; so does the
    port, which would index past its tables otherwise."""
    over = dict(attn_window=window)
    model, params = port_and_jax_params(seed=13, **over)
    b = batch(seed=13)
    steps = MAXLEN + 5
    tok_j, score_j = jax.jit(jdecode.greedy_decode_fn(jax_model(**over), steps, SOS, V))(
        params, jnp.asarray(b["x"]), jnp.asarray(b["x_hw"]))
    tb = to_torch(b)
    positions = _count_steps(model)
    tok_p, score_p = pdecode.greedy_decode_fn(model, steps, SOS, V)(tb["x"], tb["x_hw"])
    assert positions == list(range(steps))
    np.testing.assert_array_equal(tok_p.numpy(), np.asarray(tok_j))
    np.testing.assert_allclose(score_p.numpy(), np.asarray(score_j), rtol=1e-3, atol=5e-4)


# ---------------------------------------------------------------------- beam

# a token each of these seeds' models emits, so beams finish at different lengths: at JAX's initialisers an
# untrained model repeats one token a row, so each kind's seed is one whose rows share a token at different steps
# (greedy: flat at steps 0, 0, 8; ring 6, 1, 3; multimodal 0, 5, 0)
BEAM_SEED = {"flat": 15, "ring": 28, "multimodal": 8}
BEAM_EOS = {"flat": 5, "ring": 20, "multimodal": 13}
BEAM_CASES = ([("flat", k, lp) for k in (1, 2, 4) for lp in (0.0, 0.6)]
              + [(m, k, lp) for m in ("ring", "multimodal") for k, lp in ((2, 0.0), (4, 0.6))])


def _beam_inputs(kind):
    seed = BEAM_SEED[kind]
    if kind == "multimodal":
        model, params = mm_port_and_jax_params(seed=seed, mixer_type="attn_both", mixer_residual=True, **NO_DROPOUT)
        b = mm_batch(seed=seed, b=3)
        keys = ("xi", "xi_hw", "xa", "xa_hw")
        return model, params, jax_mm_model(mixer_type="attn_both", mixer_residual=True, **NO_DROPOUT), b, keys
    over = dict(attn_window=4) if kind == "ring" else {}
    model, params = port_and_jax_params(seed=seed, **over)
    return model, params, jax_model(**over), batch(seed=seed, b=3), ("x", "x_hw")


@pytest.mark.parametrize("kind,k,lp", BEAM_CASES, ids=[f"{m}_k{k}_lp{lp}" for m, k, lp in BEAM_CASES])
def test_beam_decode_equals_jax(kind, k, lp):
    """The port in float32 against JAX's weights and inputs in float64
    (its caches and log-softmax stay float32): at JAX's initialisers JAX's
    own float32 summed log-probabilities lie up to 5e-4 from the port's,
    and the port's 2.1e-5 from JAX's float64 ones."""
    model, params, jm, b, keys = _beam_inputs(kind)
    if kind == "ring":
        assert model.decoder.cache_len == 5 < MAXLEN
    mm, eos = kind == "multimodal", BEAM_EOS[kind]
    b64 = {n: v.astype(np.float64) if v.dtype == np.float32 else v for n, v in b.items()}
    with jax.enable_x64(True):
        fn = jax.jit(jdecode.beam_decode_fn(jm, MAXLEN, SOS, eos, k, lp, multimodal=mm))
        tok_j, score_j = fn(jax.tree.map(lambda w: jnp.asarray(w, np.float64), params),
                            *[jnp.asarray(b64[n]) for n in keys])
    tb = to_torch(b)
    tok_p, score_p = pdecode.beam_decode_fn(model, MAXLEN, SOS, eos, k, lp, multimodal=mm)(*[tb[n] for n in keys])
    assert tok_p.shape == (3, MAXLEN) and score_p.shape == (3,)
    np.testing.assert_array_equal(tok_p.numpy(), np.asarray(tok_j))
    np.testing.assert_allclose(score_p.numpy(), np.asarray(score_j), rtol=0, atol=1e-4)
    assert (np.asarray(tok_j) == eos).any(axis=1).all()  # every row's best beam finished
    if k == 1:  # beam 1 is greedy, up to the first eos
        greedy = pdecode.greedy_decode_fn(model, MAXLEN, SOS, eos, multimodal=mm)(*[tb[n] for n in keys])[0]
        assert pdecode.cut_at_eos(tok_p, tok_p, eos)[0] == pdecode.cut_at_eos(greedy, greedy, eos)[0]


def test_beam_reorder_copies_rows():
    """Two beams that take one source beam get two copies of its cache rows:
    a later in-place write to one leaves the other as it was."""
    cache = {"layer0": {"k": torch.arange(12.0).reshape(3, 4), "v": torch.zeros(3, 4)}}
    out = pdecode._reorder(cache, torch.tensor([1, 1, 0]))
    out["layer0"]["k"][0, 0] = -1.0
    assert out["layer0"]["k"][1].tolist() == [4.0, 5.0, 6.0, 7.0] and cache["layer0"]["k"][1, 0] == 4.0


# ------------------------------------------------------------ Smith-Waterman

PENALTIES = [(2, -1, -1, -1), (1, -1, -2, -0.5), (3, -2, -1, -2), (2, -1, -0.5, -1.5)]  # last two: extend > open


def _sequences(seed, n_pairs=12, vocab=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_pairs):
        a = [f"t{x}" for x in rng.integers(0, vocab, rng.integers(0, 30))]
        b = list(a)
        for _ in range(rng.integers(0, 8)):  # edits: substitutions, deletions, insertions
            op, pos = rng.integers(0, 3), rng.integers(0, max(len(b), 1))
            if op == 0 and b:
                b[pos] = f"t{rng.integers(0, vocab)}"
            elif op == 1 and b:
                del b[pos]
            else:
                b.insert(pos, f"t{rng.integers(0, vocab)}")
        out.append((a, b, rng.uniform(size=len(a)).round(1).tolist(), rng.uniform(size=len(b)).round(1).tolist()))
    return out


@pytest.mark.parametrize("pen", PENALTIES, ids=[f"m{p[0]}_x{p[1]}_o{p[2]}_e{p[3]}" for p in PENALTIES])
def test_smith_waterman_equals_jax(pen):
    for a, b, pa, pb in _sequences(seed=int(abs(sum(pen)) * 10)):
        ia = np.array([int(t[1:]) for t in a], np.int32)
        ib = np.array([int(t[1:]) for t in b], np.int32)
        assert psw._sw_python(ia, ib, *pen) == jsw._sw_python(ia, ib, *pen)
        assert psw.align_tokens(a, b, *pen) == jsw.align_tokens(a, b, *pen)
        # probabilities rounded to 0.1: mismatches with equal probabilities go to the query in both
        assert psw.fuse_predictions(a, pa, b, pb, *pen) == jsw.fuse_predictions(a, pa, b, pb, *pen)


# -------------------------------------------------------------------- resize

RESIZE_CASES = [(32, 71, 16), (33, 97, 20), (17, 29, 40), (20, 31, 23), (45, 128, 45)]


@pytest.mark.parametrize("h,w,th", RESIZE_CASES, ids=[f"{h}x{w}_to{th}" for h, w, th in RESIZE_CASES])
def test_resize_equals_jax_image_resize(h, w, th):
    from omr_a2s_multimodal_transformer_tpu.ops.image import preprocess_image_batch as j_pre

    rng = np.random.default_rng(h * w)
    raw = rng.integers(0, 256, size=(3, h, w), dtype=np.uint8)
    hw = np.array([[h, w], [h - 3, w - 7], [h // 2, w // 3]], np.int32)
    xj, hwj = j_pre(jnp.asarray(raw), jnp.asarray(hw), target_height=th)
    xp, hwp = preprocess_image_batch(torch.from_numpy(raw), torch.from_numpy(hw), target_height=th)
    assert xp.shape == xj.shape and xp.dtype == torch.float32
    np.testing.assert_allclose(xp.numpy(), np.asarray(xj), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(hwp.numpy(), np.asarray(hwj))


# --------------------------------------------------------------- transcribers


def _raw_and_wave(seed):
    from omr_a2s_multimodal_transformer_tpu.data.sources import SyntheticSource

    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(2, IMG_H, IMG_W), dtype=np.uint8)
    hw = np.array([[IMG_H, IMG_W], [IMG_H - 5, IMG_W - 13]], np.int32)
    src = SyntheticSource(n=2, seed=seed, audio_seconds_range=(0.3, 0.5), n_measures=1, audio_style="bands")
    waves = [src[i]["audio"]["array"] for i in range(2)]
    n = np.array([len(x) for x in waves], np.int32)
    wave = np.zeros((2, int(n.max())), np.float32)
    for i, x in enumerate(waves):
        wave[i, :len(x)] = x
    return raw, hw, wave, n


@pytest.mark.parametrize("img_height", [None, 24])
def test_fused_transcriber_equals_jax(img_height):
    from omr_a2s_multimodal_transformer_tpu.inference import make_fused_transcriber as j_make
    from omr_a2s_multimodal_transformer_tpu_torch.inference import make_fused_transcriber

    img, pi = port_and_jax_params(seed=14)
    aud, pa = port_and_jax_params(seed=15, input_modality="audio")
    raw, hw, wave, n = _raw_and_wave(14)
    tok_j, score_j = j_make(jax_model(), jax_model(), SOS, 22, img_height=img_height)(
        pi, pa, *map(jnp.asarray, (raw, hw, wave, n)), 0.5)
    tok_p, score_p = make_fused_transcriber(img, aud, SOS, 22, img_height=img_height, device="cpu")(
        *map(torch.from_numpy, (raw, hw, wave, n)), 0.5)
    np.testing.assert_array_equal(tok_p.numpy(), np.asarray(tok_j))
    np.testing.assert_allclose(score_p.numpy(), np.asarray(score_j), rtol=0, atol=1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_fused_transcriber(img, aud, SOS, 22)


def test_image_transcriber_with_img_height_equals_jax():
    from omr_a2s_multimodal_transformer_tpu.inference import make_image_transcriber as j_make
    from omr_a2s_multimodal_transformer_tpu_torch.inference import make_image_transcriber

    model, params = port_and_jax_params(seed=16)
    raw, hw, _, _ = _raw_and_wave(16)
    tok_j, _ = j_make(jax_model(), SOS, EOS, img_height=48)(params, jnp.asarray(raw), jnp.asarray(hw))
    tok_p, _ = make_image_transcriber(model, SOS, EOS, img_height=48, device="cpu")(
        torch.from_numpy(raw), torch.from_numpy(hw))
    np.testing.assert_array_equal(tok_p.numpy(), np.asarray(tok_j))
