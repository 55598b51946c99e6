"""The port's native host routes and small modules against the JAX
package, on the CPU:

- ``csrc/editdist.cpp`` (built here by the host's C++ compiler): on 200
  random pairs of up to 700 tokens over a small vocabulary (so matches,
  mismatches and ties occur), Levenshtein distances of the native route
  equal the numpy route's and JAX's ``levenshtein``; Smith-Waterman
  alignments (cigar and starts) of the native route equal the Python
  Gotoh route's and JAX's ``align_tokens``, with two penalty sets.
- ``cli/params.py``: the parameter count of every modality x mixer equals
  the JAX CLI's.
- ``cli/import_torch.py``: a reference Lightning checkpoint (the torch
  reference modules of tests/test_torch_parity.py) imported into a port
  checkpoint gives the logits of JAX's ``convert_unimodal_state_dict`` of
  the same state_dict, within the float32 model tolerance of
  tests/test_torch_port_model.py.
- ``utils/debug.py``: under ``OMR_A2S_DEBUG_CHECKS`` the train step raises
  on an injected NaN and on a token id out of range, the decode on NaN
  logits; with the switch off neither checks.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import MAXLEN, SOS, V, batch, jax_model

from omr_a2s_multimodal_transformer_tpu.fusion import smith_waterman as jsw
from omr_a2s_multimodal_transformer_tpu.utils import edit_distance as jed
from omr_a2s_multimodal_transformer_tpu_torch.fusion import smith_waterman as psw
from omr_a2s_multimodal_transformer_tpu_torch.utils import edit_distance as ped

PAIRS, MAX_TOKENS = 200, 700


def _pairs(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(PAIRS):
        vocab = [f"t{j}" for j in range(int(rng.integers(2, 12)))]
        n, m = (0, int(rng.integers(0, 20))) if i == 0 else rng.integers(0, MAX_TOKENS + 1, size=2)
        a = [vocab[j] for j in rng.integers(0, len(vocab), size=n)]
        b = list(a[: len(a) // 2]) + [vocab[j] for j in rng.integers(0, len(vocab), size=m)] if i % 3 == 0 else \
            [vocab[j] for j in rng.integers(0, len(vocab), size=m)]
        out.append((a, b))
    return out


def test_native_levenshtein_equals_numpy_route_and_jax():
    for a, b in _pairs(0):
        d = ped.levenshtein(a, b)
        assert d == ped.levenshtein(a, b, route="numpy") == jed.levenshtein(a, b), (len(a), len(b))
    assert ped.levenshtein(["x"] * 700, []) == 700
    with pytest.raises(ValueError, match="route"):
        ped.levenshtein(["a"], ["b"], route="python")


@pytest.mark.parametrize("penalties", [(2, -1, -1, -1), (3, -2, -1, -2)], ids=["default", "extend_lt_open"])
def test_native_smith_waterman_equals_python_route_and_jax(penalties):
    for i, (a, b) in enumerate(_pairs(1)[: PAIRS // 2] if penalties[0] == 3 else _pairs(1)[PAIRS // 2:]):
        got = psw.align_tokens(a, b, *penalties)
        assert got == psw.align_tokens(a, b, *penalties, route="python") == jsw.align_tokens(a, b, *penalties), i
    a, b = _pairs(2)[5]
    probs = list(np.linspace(0.1, 1.0, len(a))), list(np.linspace(1.0, 0.1, len(b)))
    assert psw.fuse_predictions(a, probs[0], b, probs[1]) == psw.fuse_predictions(a, probs[0], b, probs[1],
                                                                                  route="python")


def test_native_build_failure_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """No fallback: a source the compiler rejects raises with its output."""
    from omr_a2s_multimodal_transformer_tpu_torch.ops import cuda_build

    (tmp_path / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        cuda_build.host_library("broken")


def test_params_cli_counts_equal_jax(capsys):
    from omr_a2s_multimodal_transformer_tpu.cli import params as jparams
    from omr_a2s_multimodal_transformer_tpu_torch.cli import params as pparams

    argv = ["--vocab_size", "215", "--max_seq_len", "670"]
    jparams.main(argv)
    want = {name: int(n.replace(",", "")) for name, n in re.findall(r"(\S+): ([\d,]+) trainable", capsys.readouterr().out)}
    got = pparams.main(argv + ["--device", "cpu"])
    assert len(got) == 6 and got == want


def test_import_torch_round_trip_gives_jax_logits(tmp_path):
    from test_torch_parity import TDecoder, TEncoder

    from omr_a2s_multimodal_transformer_tpu.training.torch_import import convert_unimodal_state_dict
    from omr_a2s_multimodal_transformer_tpu_torch.cli import common
    from omr_a2s_multimodal_transformer_tpu_torch.cli import import_torch

    torch.manual_seed(7)
    ref = torch.nn.Module()
    ref.encoder, ref.decoder = TEncoder(), TDecoder(V, MAXLEN)
    sd = ref.state_dict()
    assert "decoder.pe" in sd  # a buffer the port recomputes
    torch.save({"state_dict": sd, "hyper_parameters": {"max_seq_len": MAXLEN, "input_modality": "image"}},
               tmp_path / "ref.ckpt")
    hp = import_torch.main(["--torch_ckpt", str(tmp_path / "ref.ckpt"), "--out", str(tmp_path / "port")])
    assert hp["vocab_size"] == V and hp["max_seq_len"] == MAXLEN and hp["input_modality"] == "image"
    model, _, multimodal = common.build_from_checkpoint(str(tmp_path / "port"), device="cpu")
    assert not multimodal
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    b = batch(seed=7)
    with torch.no_grad():
        got = model(torch.from_numpy(b["x"]), torch.from_numpy(b["x_hw"]), torch.from_numpy(b["y_in"]).long())
    params = {"params": jax.tree.map(jnp.asarray, convert_unimodal_state_dict({k: v.clone() for k, v in sd.items()}))}
    want = jax_model().apply(params, jnp.asarray(b["x"]), jnp.asarray(b["x_hw"]), jnp.asarray(b["y_in"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_debug_checks_raise_on_nan_and_bad_token_ids(monkeypatch):
    from omr_a2s_multimodal_transformer_tpu_torch.models import build_model
    from omr_a2s_multimodal_transformer_tpu_torch.training.decode import greedy_decode_fn
    from omr_a2s_multimodal_transformer_tpu_torch.training.train_state import TrainState, make_train_step

    b = {k: torch.from_numpy(v) for k, v in batch(seed=8).items()}
    hp = dict(vocab_size=V, max_seq_len=MAXLEN, input_modality="image", encoder_dropout=0.0, decoder_dropout=0.0,
              pos_dropout=0.0)

    def poisoned_model():
        model, _ = build_model(hp, device="cpu", seed=8)
        with torch.no_grad():
            model.decoder.out_layer.bias[3] = float("nan")
        return model

    gen = torch.Generator().manual_seed(0)
    monkeypatch.setenv("OMR_A2S_DEBUG_CHECKS", "0")  # off: the NaN goes through
    model = poisoned_model()
    _, loss = make_train_step(model, V, bf16_compute=False, device="cpu")(TrainState.create(model), b, gen)
    assert not torch.isfinite(loss)
    greedy_decode_fn(model, 3, SOS, V)(b["x"], b["x_hw"])

    monkeypatch.setenv("OMR_A2S_DEBUG_CHECKS", "1")
    model = poisoned_model()
    step = make_train_step(model, V, bf16_compute=False, device="cpu")
    with pytest.raises(FloatingPointError, match="train loss"):
        step(TrainState.create(model), b, gen)
    with pytest.raises(FloatingPointError, match="decode logits"):
        greedy_decode_fn(model, 3, SOS, V)(b["x"], b["x_hw"])
    clean, _ = build_model(hp, device="cpu", seed=8)
    bad = dict(b, y_in=torch.where(b["y_in"] == 5, V + 2, b["y_in"]))
    with pytest.raises(IndexError, match="y_in"):
        make_train_step(clean, V, bf16_compute=False, device="cpu")(TrainState.create(clean), bad, gen)
    with pytest.raises(IndexError, match="input token"):
        greedy_decode_fn(clean, 3, V + 1, V)(b["x"], b["x_hw"])  # sos outside the vocabulary


def test_environment_equals_jax(monkeypatch):
    from omr_a2s_multimodal_transformer_tpu.utils import environment as jenv
    from omr_a2s_multimodal_transformer_tpu_torch.utils import environment as penv

    monkeypatch.setenv("OMR_A2S_SET", "1")
    monkeypatch.delenv("OMR_A2S_UNSET", raising=False)
    for env in (jenv, penv):
        env.init_environment(["OMR_A2S_SET"])
    messages = []
    for env in (jenv, penv):
        with pytest.raises(OSError) as e:
            env.init_environment(["OMR_A2S_SET", "OMR_A2S_UNSET"])
        messages.append(str(e.value))
    assert messages[0] == messages[1] and "OMR_A2S_UNSET" in messages[1]
