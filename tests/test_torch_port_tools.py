"""The port's experiment layer (``omr_a2s_multimodal_transformer_tpu_torch/tools/``)
against the repository's JAX tools (``tools/``), on the CPU, function by
function on the same inputs:

- ``run_grid``: ``MIXERS``, ``leg_spec`` (its ``ValueError`` too) and
  ``_markdown`` on one report: equal text.
- ``run_convergence`` and ``run_real_shape_e2e``: ``synth_cfg`` (smoke and
  full, with and without a measure range and 'bands' audio): equal
  strings; ``read_trajectory`` on a ``metrics.jsonl`` written here and
  ``assemble_report``'s trajectory match: equal; ``seed_caches``' max-lens
  files: the same bytes (the vocabulary copied only when a file is given).
- ``diagnose_seq_errors``: ``token_class`` and the report built from a
  predictions .jsonl: equal.
- ``diagnose_errors``: ``ser`` and ``error_census`` on the same pairs:
  equal; ``tf_eval`` (loss to 1e-5 relative, accuracy equal) and
  ``decode_batches`` (tokens equal) on a small float32 model initialised
  by JAX and loaded into the port by ``training/jax_import.py``.
- ``diagnose_audio_errors``: the cases of ``tests/test_diagnose_audio.py``
  and random pairs through both: equal classes and masses.
- ``oracle_synth_floor`` (``decode_image``, ``decode_image_grand``) and
  ``oracle_audio_floor`` (``_candidate_maps``, ``bayes_decode_slot``,
  ``oracle_transcript``) on samples of the two packages'
  ``SyntheticSource`` with the same seeds: equal images, strings and SER.
"""

import json
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import EOS, SOS, V, batch, hparams, jax_model

from omr_a2s_multimodal_transformer_tpu.data import sources as jsources
from omr_a2s_multimodal_transformer_tpu.data.encoding import KrnParser as JaxKrnParser
from omr_a2s_multimodal_transformer_tpu.utils.metrics import compute_ed_metrics as jax_ed_metrics
from omr_a2s_multimodal_transformer_tpu_torch.data import sources as psources
from omr_a2s_multimodal_transformer_tpu_torch.data.encoding import KrnParser
from omr_a2s_multimodal_transformer_tpu_torch.models import build_model
from omr_a2s_multimodal_transformer_tpu_torch.tools import diagnose_audio_errors as pdae
from omr_a2s_multimodal_transformer_tpu_torch.tools import diagnose_errors as pde
from omr_a2s_multimodal_transformer_tpu_torch.tools import diagnose_seq_errors as pdse
from omr_a2s_multimodal_transformer_tpu_torch.tools import oracle_audio_floor as poa
from omr_a2s_multimodal_transformer_tpu_torch.tools import oracle_synth_floor as pos
from omr_a2s_multimodal_transformer_tpu_torch.tools import run_convergence as pconv
from omr_a2s_multimodal_transformer_tpu_torch.tools import run_grid as pgrid
from omr_a2s_multimodal_transformer_tpu_torch.tools import run_real_shape_e2e as pe2e
from omr_a2s_multimodal_transformer_tpu_torch.training.jax_import import load_jax_params
from omr_a2s_multimodal_transformer_tpu_torch.utils.metrics import compute_ed_metrics
from tools import diagnose_audio_errors as jdae
from tools import diagnose_errors as jde
from tools import diagnose_seq_errors as jdse
from tools import oracle_audio_floor as joa
from tools import oracle_synth_floor as jos
from tools import run_convergence as jconv
from tools import run_grid as jgrid
from tools import run_real_shape_e2e as je2e
import torch_port_cache  # noqa: F401, E402  (a frontend cache folder of this process)

TF_LOSS_RTOL = 1e-5  # tf_eval's loss: the float32 forwards of the two packages sum in other orders


# ------------------------------------------------------------------ run_grid


@pytest.mark.parametrize("leg", ["image", "audio", "concat", "attn_img", "attn_audio", "attn_both"])
def test_leg_spec_equals_jax(leg):
    assert pgrid.MIXERS == jgrid.MIXERS
    assert pgrid.leg_spec(leg) == jgrid.leg_spec(leg)


@pytest.mark.parametrize("leg", ["both", "video", ""])
def test_leg_spec_refuses_what_jax_refuses(leg):
    with pytest.raises(ValueError) as pe:
        pgrid.leg_spec(leg)
    with pytest.raises(ValueError) as je:
        jgrid.leg_spec(leg)
    assert str(pe.value) == str(je.value)


def _report(rng):
    def metrics(prefix):
        return {f"{prefix}sym-er": round(float(rng.uniform(0, 100)), 3),
                f"{prefix}seq-er": round(float(rng.uniform(0, 100)), 3), "wall_s": 1.5}

    legs = {leg + suffix: {"modality": pgrid.leg_spec(leg)[0], "mixer": pgrid.leg_spec(leg)[1],
                           "best_val_sym-er": float(rng.uniform(0, 100)), "trajectory": [], **metrics("test_")}
            for leg, suffix in (("image", ""), ("audio", ""), ("attn_img", "_warm"))}
    legs["attn_img_warm"].pop("test_seq-er")  # a leg without a key prints None in both
    fusion = {"smith_waterman": metrics(""), "weighted_a0.5": metrics(""), "weighted_a0.3": {"wall_s": 2.0}}
    return {"config": {}, "legs": legs, "fusion": fusion}


def test_markdown_equals_jax():
    report = _report(np.random.default_rng(3))
    text = pgrid._markdown(report)
    assert text == jgrid._markdown(report)
    assert len(text.splitlines()) == 2 + 3 + 3


# ------------------------------------------------------------------ synth_cfg, trajectories, caches


@pytest.mark.parametrize("case", [
    dict(n=4, n_eval=2, smoke=True),
    dict(n=1024, n_eval=128, smoke=False),
    dict(n=256, n_eval=64, smoke=False, n_measures=10, render_style="grand", img_height=400),
    dict(n=1024, n_eval=128, smoke=False, n_measures=30, render_style="grand", measures_range=[2, 30],
         audio_style="bands"),
    dict(n=16, n_eval=8, smoke=False, n_measures=4, render_style="grand", measures_range=(2, 4), audio_style="tones"),
], ids=["smoke", "default", "n10_grand_h400", "r05_bands", "short_tones"])
def test_convergence_synth_cfg_equals_jax(case):
    assert pconv.synth_cfg(**case) == jconv.synth_cfg(**case)


@pytest.mark.parametrize("smoke", [True, False])
def test_real_shape_synth_cfg_equals_jax(smoke):
    assert pe2e.synth_cfg(48, smoke=smoke) == je2e.synth_cfg(48, smoke=smoke)
    assert pe2e.REAL_MAX_LENS == je2e.REAL_MAX_LENS and pe2e.SMOKE_MAX_LENS == je2e.SMOKE_MAX_LENS


def _write_metrics(run_dir, rng, epochs, val_every):
    """A Trainer-like metrics.jsonl: a config line, epoch lines, validation lines, a test line."""
    run_dir.mkdir(parents=True)
    rows = [{"step": -1, "time": 0.0, "config": {"lr": 3e-4}}]
    for e in range(1, epochs + 1):
        rows.append({"step": 2 * e, "time": float(e), "epoch": e, "train_loss": float(rng.uniform(0.1, 5.0)),
                     "samples_per_sec": float(rng.uniform(10, 20)), "time_step_total_s": 1.0})
        if e % val_every == 0:
            rows.append({"step": 2 * e, "time": float(e), "val_decode_s": 0.5, "val_decode_steps": 12})
            rows.append({"step": 2 * e, "time": float(e), "epoch": e, "val_sym-er": float(rng.uniform(0, 100)),
                         "val_seq-er": 100.0})
    rows.append({"step": 2 * epochs, "time": 9.0, "test_sym-er": 50.0, "test_seq-er": 100.0})
    (run_dir / "metrics.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")


def test_read_trajectory_and_assemble_report_equal_jax(tmp_path):
    rng = np.random.default_rng(7)
    for name, epochs in (("control", 6), ("production", 5), ("variant", 4)):
        _write_metrics(tmp_path / "runs" / name, rng, epochs, val_every=2)
    for name in ("control", "production", "variant"):
        got = pconv.read_trajectory(str(tmp_path / "runs" / name))
        assert got == jconv.read_trajectory(str(tmp_path / "runs" / name))
        assert [r["epoch"] for r in got] == list(range(1, len(got) + 1)) and "val_sym-er" in got[1]
    assert pconv.read_trajectory(str(tmp_path / "none")) == jconv.read_trajectory(str(tmp_path / "none")) == []
    for run_name in ("production", "variant"):
        want = jconv.assemble_report(str(tmp_path), run_name)
        got = pconv.assemble_report(str(tmp_path), run_name)
        assert got == want and got["trajectory_match"]["epochs_compared"] == (3 if run_name == "production" else 2)


@pytest.mark.parametrize("smoke", [True, False])
def test_seed_caches_writes_the_jax_max_lens_files(tmp_path, monkeypatch, smoke):
    vocab = tmp_path / "ar_w2i_kern.json"
    vocab.write_text(json.dumps({"<PAD>": 0, "<eos>": 1, "<sos>": 2, "4c": 3}))
    monkeypatch.setattr(je2e, "REF_VOCAB", str(vocab))  # the JAX tool's vocabulary file, outside the repository
    je2e.seed_caches(str(tmp_path / "jax"), smoke=smoke)
    pe2e.seed_caches(str(tmp_path / "port"), smoke=smoke, vocab_path=str(vocab))
    pe2e.seed_caches(str(tmp_path / "corpus_vocab"), smoke=smoke)
    pe2e.seed_caches(str(tmp_path / "corpus_all"), smoke=smoke, max_lens=False)
    for name in pe2e.MAX_LENS_FILES:
        want = (tmp_path / "jax" / "max_lens" / name).read_bytes()
        assert (tmp_path / "port" / "max_lens" / name).read_bytes() == want
        assert (tmp_path / "corpus_vocab" / "max_lens" / name).read_bytes() == want
        assert json.loads(want) == (je2e.SMOKE_MAX_LENS if smoke else je2e.REAL_MAX_LENS)
    assert sorted(p.name for p in (tmp_path / "jax" / "max_lens").iterdir()) == sorted(pe2e.MAX_LENS_FILES)
    assert (tmp_path / "port" / "vocabs" / "ar_w2i_kern.json").read_bytes() == vocab.read_bytes()
    # no vocabulary file given: the corpus builds its own; max_lens=False: the corpus scans its own
    assert list((tmp_path / "corpus_vocab" / "vocabs").iterdir()) == []
    assert list((tmp_path / "corpus_all" / "max_lens").iterdir()) == []
    with pytest.raises(FileNotFoundError):
        pe2e.seed_caches(str(tmp_path / "missing"), vocab_path=str(tmp_path / "no_such.json"))


# ------------------------------------------------------------------ diagnostics on token pairs

TOKENS = ["=", "<coc>", "<cor>", "<con>", "DOT", "4c", "8dd#", "16B-", "2a", "*clefG2", "*M4/4", "*-", "", "."]


def _pairs(seed, n=12):
    """(gt, pred) token lists: the pred a copy of the gt with random edits."""
    rng = np.random.default_rng(seed)
    pool = TOKENS[:-2] + [f"{d}{p}{a}" for d in (2, 4, 8, 16) for p in psources._PITCHES[:5] for a in ("", "#", "-")]
    pairs = []
    for _ in range(n):
        g = [pool[i] for i in rng.integers(0, len(pool), size=int(rng.integers(5, 40)))]
        p = list(g)
        for _ in range(int(rng.integers(0, 6))):
            op, k = int(rng.integers(0, 3)), int(rng.integers(0, max(1, len(p))))
            if op == 0 and p:
                p[k % len(p)] = pool[int(rng.integers(0, len(pool)))]
            elif op == 1:
                p.insert(k, pool[int(rng.integers(0, len(pool)))])
            elif p:
                del p[k % len(p)]
        pairs.append((g, p))
    return pairs


def test_token_class_equals_jax():
    for t in TOKENS + ["4c#", "16B-", "12", "x", "<pad>"]:
        assert pdse.token_class(t) == jdse.token_class(t), t


@pytest.mark.parametrize("window", [2, 0, 5])
def test_seq_error_report_equals_jax(tmp_path, monkeypatch, capsys, window):
    preds = tmp_path / "preds.jsonl"
    preds.write_text("".join(json.dumps({"y_true": g, "y_pred": p}) + "\n" for g, p in _pairs(11)))
    out_j, out_p = tmp_path / "jax.json", tmp_path / "port.json"
    monkeypatch.setattr(sys, "argv", ["diagnose_seq_errors", "--preds", str(preds), "--out", str(out_j),
                                      "--window", str(window)])
    jdse.main()
    got = pdse.main(["--preds", str(preds), "--out", str(out_p), "--window", str(window)])
    capsys.readouterr()
    assert got == json.loads(out_j.read_text()) == json.loads(out_p.read_text())
    assert got["total_error_tokens"] > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ser_and_error_census_equal_jax(seed):
    pairs = _pairs(seed)
    assert pde.ser(pairs) == jde.ser(pairs)
    assert pde.error_census(pairs) == jde.error_census(pairs)


# ------------------------------------------------------------------ diagnose_errors on a model


@pytest.fixture(scope="module")
def jax_initialised():
    """A small float32 image model (float32 decode cache) initialised by
    JAX, its params loaded into the port by training/jax_import.py; the
    batches a loader would give."""
    jm = jax_model(cache_dtype="float32")
    loader = [batch(seed=s) for s in (31, 32, 33)]
    b = loader[0]
    params = jm.init(jax.random.PRNGKey(31), jnp.asarray(b["x"]), jnp.asarray(b["x_hw"]), jnp.asarray(b["y_in"]))
    model, _ = build_model(hparams(cache_dtype="float32"), device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params["params"]))
    vocab = SimpleNamespace(sos_id=SOS, eos_id=EOS, i2w={i: f"t{i}" for i in range(V + 1)})
    return jm, params["params"], model, loader, vocab


@pytest.mark.parametrize("n_batches", [1, 3])
def test_tf_eval_equals_jax(jax_initialised, n_batches):
    jm, params, model, loader, _ = jax_initialised
    loss_j, acc_j = jde.tf_eval(jm, params, loader, n_batches)
    loss_p, acc_p = pde.tf_eval(model, loader, n_batches)
    assert abs(loss_p - loss_j) <= TF_LOSS_RTOL * abs(loss_j), (loss_p, loss_j)
    assert acc_p == acc_j


@pytest.mark.parametrize("n_batches", [1, 2])
def test_decode_batches_equal_jax(jax_initialised, n_batches):
    jm, params, model, loader, vocab = jax_initialised
    got = pde.decode_batches(model, vocab, loader, n_batches)
    want = jde.decode_batches(jm, params, vocab, loader, n_batches)
    assert len(got) == 2 * n_batches and got == want
    assert pde.ser(got) == jde.ser(want)


# ------------------------------------------------------------------ diagnose_audio_errors

P = psources._PITCHES


def _line(mod, toks):
    lines = mod.lines_from_tokens(toks + ["<cor>"], P)
    assert len(lines) == 1
    return lines[0]


# the line pairs of tests/test_diagnose_audio.py, each with its class there
AUDIO_CASES = [
    ([f"4{P[3]}#", "<coc>", "4a"], [f"4{P[4]}-", "<coc>", "4a"], "audio_identical"),
    (["DOT", "<coc>", "16b#", "<con>", "8ee-"], ["DOT", "<coc>", "8ee-", "<con>", "16b#"], "audio_identical"),
    (["4a", "<coc>", "4c"], ["8a", "<coc>", "4c"], "duration_error"),
    (["DOT", "<coc>", "4c"], ["4a", "<coc>", "4c"], "structure_error"),
    (["4a", "<coc>", "4c"], ["4d", "<coc>", "4c"], "pitch_error"),
    (["=", "<coc>", "="], ["*-", "<coc>", "*-"], "line_count"),
    (["4a", "<coc>", "4c"], ["4a", "<coc>", "4c"], "equal"),
]


@pytest.mark.parametrize("g, p, cls", AUDIO_CASES, ids=[c[2] + str(i) for i, c in enumerate(AUDIO_CASES)])
def test_audio_line_classes_equal_jax(g, p, cls):
    assert jsources._PITCHES == P
    gl, pl = _line(pdae, g), _line(pdae, p)
    assert (gl, pl) == (_line(jdae, g), _line(jdae, p))
    assert pdae.classify_line_pair(gl, pl) == jdae.classify_line_pair(gl, pl) == cls
    assert pdae.line_token_cost(gl, pl) == jdae.line_token_cost(gl, pl)
    for q in (False, True):
        assert pdae.tone_multiset(gl[1], q) == jdae.tone_multiset(gl[1], q)


def test_audio_tokens_and_f0_equal_jax():
    for tok in ["16b#", "4cc-", "2G", "DOT", "=", "<coc>", "8x", "12ee"]:
        assert pdae.parse_token(tok, P) == jdae.parse_token(tok, P), tok
    for v in (0, 1):
        for rank in range(len(P)):
            for acc in (-1, 0, 1):
                assert pdae.tones_f0(v, rank, acc) == jdae.tones_f0(v, rank, acc)


@pytest.mark.parametrize("seed", [0, 5])
def test_audio_decompose_equals_jax(seed):
    g = ["4a", "<coc>", "16b#", "<con>", "8ee-", "<cor>", "=", "<coc>", "=", "<cor>"]
    p = ["4a", "<coc>", "8ee-", "<con>", "16b#", "<cor>", "=", "<coc>", "=", "<cor>"]
    pairs = [(g, p), (g, g)] + _pairs(seed)
    got, want = pdae.decompose(pairs, P), jdae.decompose(pairs, P)
    assert got == want and got[0]["audio_identical"] > 0


# ------------------------------------------------------------------ corpus oracles


@pytest.mark.parametrize("style, geometry", [
    ("blob", dict(n_measures=4, img_height_range=(355, 362), img_width_range=(573, 588))),
    ("blob", dict(n_measures=2, img_height_range=(64, 72), img_width_range=(300, 340))),
    ("grand", dict(n_measures=4, img_height_range=(355, 362), img_width_range=(573, 588))),
    ("grand", dict(n_measures=3, n_measures_range=(2, 3), img_height_range=(355, 362), img_width_range=(430, 441))),
], ids=["blob_short", "blob_small", "grand_short", "grand_range"])
def test_image_oracle_equals_jax(style, geometry):
    kw = dict(n=3, seed=1, encoding="kern", render_style=style, **geometry)
    jsrc, psrc = jsources.SyntheticSource(**kw), psources.SyntheticSource(**kw)
    decode = "decode_image_grand" if style == "grand" else "decode_image"
    y_true, y_pred_j, y_pred_p = [], [], []
    for i in range(kw["n"]):
        ej, ep = jsrc[i], psrc[i]
        img = np.asarray(ep["image"])
        np.testing.assert_array_equal(img, np.asarray(ej["image"]))
        assert ep["transcript"] == ej["transcript"]
        rec_p = getattr(pos, decode)(img, n_pitches=len(P))
        rec_j = getattr(jos, decode)(np.asarray(ej["image"]), n_pitches=len(P))
        assert rec_p == rec_j and rec_p.startswith("**kern")
        y_true.append(KrnParser("kern").encode(ep["transcript"]))
        y_pred_p.append(KrnParser("kern").encode(rec_p))
        y_pred_j.append(JaxKrnParser("kern").encode(rec_j))
    assert compute_ed_metrics(y_true, y_pred_p) == jax_ed_metrics(y_true, y_pred_j)


@pytest.mark.parametrize("style, bin_quantized", [("tones", False), ("tones", True), ("bands", False)])
def test_audio_oracle_equals_jax(style, bin_quantized):
    maps_p, maps_j = poa._candidate_maps(style, bin_quantized), joa._candidate_maps(style, bin_quantized)
    assert [dict(m) for m in maps_p] == [dict(m) for m in maps_j]
    kw = dict(n=6, seed=3, n_measures=4, encoding="kern", n_measures_range=(2, 4))
    truths = psources.SyntheticSource(**kw).transcripts()
    assert truths == jsources.SyntheticSource(**kw).transcripts()
    y_true, y_pred = [], []
    for truth in truths:
        rec = poa.oracle_transcript(truth, style, maps_p, bin_quantized)
        assert rec == joa.oracle_transcript(truth, style, maps_j, bin_quantized)
        y_true.append(KrnParser("kern").encode(truth))
        y_pred.append(KrnParser("kern").encode(rec))
    ser = compute_ed_metrics(y_true, y_pred)["sym-er"]
    assert ser == jax_ed_metrics(y_true, y_pred)["sym-er"]
    assert (ser == 0.0) == (style == "bands")
    # single slots, colliding and not: the keys of random notes in each structural slot
    rng = np.random.default_rng(4)
    slots = [(0, 0), (1, 0), (1, 1)]
    for _ in range(30):
        notes = [(*slots[j], int(rng.integers(0, len(P))), int(rng.integers(-1, 2)), int(rng.choice([2, 4, 8, 16])))
                 for j in range(int(rng.integers(1, 4)))]
        observed = [(poa._f0_key(v, ci, r, a, style, bin_quantized), d) for v, ci, r, a, d in notes]
        assert observed == [(joa._f0_key(v, ci, r, a, style, bin_quantized), d) for v, ci, r, a, d in notes]
        assert poa.bayes_decode_slot(observed, maps_p) == joa.bayes_decode_slot(observed, maps_j)


def test_oracle_mains_equal_jax(monkeypatch, capsys):
    got = pos.main(["--n", "2", "--measures", "2", "--h_range", "64", "72", "--w_range", "300", "340"])
    monkeypatch.setattr(sys, "argv", ["oracle_synth_floor", "--n", "2", "--measures", "2", "--h_range", "64", "72",
                                      "--w_range", "300", "340"])
    jos.main()
    assert got == json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    argv = ["--n", "4", "--measures", "4", "--measures_range", "2", "4"]
    got = poa.main(argv)
    monkeypatch.setattr(sys, "argv", ["oracle_audio_floor", *argv])
    joa.main()
    assert got == json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["oracle_sym_er"] > 0.0

