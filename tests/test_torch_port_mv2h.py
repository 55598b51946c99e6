"""The port's MV2H against the JAX package's, on the CPU.

``utils/mv2h.py``'s ``seq2kern_lines`` and ``seq2kern``, all of
``utils/mv2h_native.py`` (``kern_to_notes``, ``mv2h_from_kern_lines``,
``compute_mv2h_metrics_native``) and ``compute_metrics(compute_mv2h=True)``
give JAX's results on the synthetic corpus's transcripts and on
predictions made from them by random edits (substitutions, deletions,
insertions, dropped rows). music21 and pyMV2H are not installed, so both
packages take the native route; the pyMV2H route is copied and not tested.
"""

import numpy as np
import pytest

from omr_a2s_multimodal_transformer_tpu.utils import metrics as jmetrics
from omr_a2s_multimodal_transformer_tpu.utils import mv2h as jmv2h
from omr_a2s_multimodal_transformer_tpu.utils import mv2h_native as jnative
from omr_a2s_multimodal_transformer_tpu_torch.data import dataset as pds
from omr_a2s_multimodal_transformer_tpu_torch.utils import metrics as pmetrics
from omr_a2s_multimodal_transformer_tpu_torch.utils import mv2h as pmv2h
from omr_a2s_multimodal_transformer_tpu_torch.utils import mv2h_native as pnative

SYN = dict(n=6, img_height_range=[32, 33], img_width_range=[64, 96], n_measures_range=[1, 3])


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """(ground truth, prediction) token lists: the corpus's transcripts and
    random edits of them, and a few degenerate predictions."""
    ds = pds.ARDataset("synthetic", "train", krn_encoding="kern", input_modality="image", synthetic=True,
                       synthetic_kwargs=SYN, cache_root=str(tmp_path_factory.mktemp("mv2h")))
    truth = [[ds.i2w[int(i)] for i in ds[k]["y"]][1:-1] for k in range(len(ds))]  # without <sos>, <eos>
    vocab = sorted({t for row in truth for t in row})
    rng = np.random.default_rng(0)
    out = []
    for t in truth:
        out.append((t, list(t)))
        for n_edits in (1, 4, 12):
            p = list(t)
            for _ in range(n_edits):
                op, pos = rng.integers(0, 3), int(rng.integers(0, len(p)))
                if op == 0:
                    p[pos] = vocab[rng.integers(0, len(vocab))]
                elif op == 1:
                    del p[pos]
                else:
                    p.insert(pos, vocab[rng.integers(0, len(vocab))])
            out.append((t, p))
    out += [(truth[0], []), (truth[1], ["<cor>"]), (truth[2], truth[2][: len(truth[2]) // 2])]
    return out


def test_seq2kern_equals_jax(pairs, tmp_path):
    for t, p in pairs:
        for seq in (t, p):
            assert pmv2h.seq2kern_lines(seq) == jmv2h.seq2kern_lines(seq)
    t = pairs[0][0]
    pmv2h.seq2kern(t, str(tmp_path / "p.krn"))
    jmv2h.seq2kern(t, str(tmp_path / "j.krn"))
    assert (tmp_path / "p.krn").read_bytes() == (tmp_path / "j.krn").read_bytes()


def test_native_mv2h_equals_jax(pairs):
    for t, p in pairs:
        gl, pl = pmv2h.seq2kern_lines(t), pmv2h.seq2kern_lines(p)
        assert repr(pnative.kern_to_notes(pl)) == repr(jnative.kern_to_notes(pl))
        assert pnative.mv2h_from_kern_lines(gl, pl) == jnative.mv2h_from_kern_lines(gl, pl)
    y_true, y_pred = [t for t, _ in pairs], [p for _, p in pairs]
    got = pnative.compute_mv2h_metrics_native(y_true, y_pred)
    assert got == jnative.compute_mv2h_metrics_native(y_true, y_pred)
    assert 0.0 < got["mv2h"] < 1.0 and got["harmony"] is None


def test_compute_metrics_with_mv2h_equals_jax(pairs):
    y_true, y_pred = [t for t, _ in pairs], [p for _, p in pairs]
    got = pmetrics.compute_metrics(y_true, y_pred, compute_mv2h=True)
    assert got == jmetrics.compute_metrics(y_true, y_pred, compute_mv2h=True)
    assert {"sym-er", "seq-er", "multi-pitch", "voice", "meter", "note_value", "mv2h"} == set(got)  # harmony dropped
    with pytest.raises(ImportError, match="music21"):
        pmv2h.compute_mv2h_metrics(y_true[:1], y_pred[:1])
