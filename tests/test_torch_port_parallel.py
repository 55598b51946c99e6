"""The port's data- and tensor-parallel step and decode, in gloo
processes on the CPU, against JAX's single-device step and the port's
single-process run.

Each case starts the ranks (``torch_port_dist``) of a 2 x 1 ('dp'), a
1 x 2 ('tp') or a 2 x 2 ('2x2': four ranks, the data groups' gradient
all-reduce and the model groups' collectives both live) mesh of the tiny
image model (vocab 31, odd: the classifier stays replicated under tp, as
in JAX), dropout and teacher forcing off, the float32 non-flash path.
While they run, the parent computes JAX's single-device step and the
port's single-process one.

- One Adam step (lr 3e-3, global-norm clip 0.5, which clips here), JAX's
  in float64 (``_jax_step``: at JAX's initialisers its float32 gradients
  lie 3-4e-3 in relative L2 from its float64 ones, the port's 5e-5): the
  loss is JAX's to 1e-4 relative; the gradients after the clip, gathered
  to full tensors, have the global norm 0.5 to 1e-5 relative (the clip
  fired, and the mesh's norm counted every full parameter once: Adam's
  first update g/|g| does not show the clip's scale, so the gradients are
  held themselves) and are the single-process port's to 1e-3 and JAX's
  (its first Adam moment over 1 - b1) to 2e-3 in relative L2 norm over
  all leaves; each parameter's update is JAX's to
  5e-2 in relative L2 norm (test_torch_port_trajectory.py's tolerance:
  Adam divides by the gradient's own scale, so an element whose gradient
  is near zero carries its rounding noise into the update; the
  key-projection biases, whose exact gradient is zero, are left out); the
  update of all parameters together is the single-process port's to 1e-3
  in relative L2 norm (the same noise from other summation orders; leaf
  by leaf it reaches 1e-2 in a bias before an instance norm).
- Greedy decode of a b4 batch and of a remainder b3 batch (padded to b4
  by ``shard_batch``, the padded row dropped): the tokens of the
  single-process decode, exactly, as JAX's test_parallel.py holds its
  sharded decode.
- int4's per-token scale of the cross cache under tp (an all-reduce max
  over 'model'): the single-process scales bit for bit.
- The gated attn_both multimodal model (both modalities, the mixer's own
  attention dropout off on both sides, as in test_torch_port_trainer.py)
  on the 2 x 2 mesh: one clipped Adam step held to JAX's single-device
  multimodal step and to the port's single-process one, at the tolerances
  of the image model's step above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_port_dist as D
from torch_port_common import (
    V,
    assert_rel_l2,
    batch,
    jax_mm_model,
    jax_model,
    mm_batch,
    mm_port_and_jax_params,
    mm_state_dict_to_jax,
    port_and_jax_params,
    to_torch,
)

from omr_a2s_multimodal_transformer_tpu.models import multimodal as j_multimodal

from omr_a2s_multimodal_transformer_tpu.training.torch_import import convert_unimodal_state_dict
from omr_a2s_multimodal_transformer_tpu.training.train_state import TrainState as JTrainState
from omr_a2s_multimodal_transformer_tpu.training.train_state import adam as j_adam
from omr_a2s_multimodal_transformer_tpu.training.train_state import make_train_step as j_make_train_step
from omr_a2s_multimodal_transformer_tpu_torch.training.decode import greedy_decode_fn
from omr_a2s_multimodal_transformer_tpu_torch.training.train_state import TrainState, make_train_step

NO_DROPOUT = dict(encoder_dropout=0.0, decoder_dropout=0.0, pos_dropout=0.0)
SEED, LR, CLIP = 5, 3e-3, 0.5
MESHES = {"dp": (2, 1), "tp": (1, 2), "2x2": (2, 2)}  # (data, model) ranks
MM_GATE = (0.7, -1.3)  # the multimodal model's mix_gate: nonzero, so that the gated paths are read


def _jax_step(jstep, params, b, *args):
    """JAX's single-device Adam step in float64, from the port's weights."""
    with jax.enable_x64(True):
        state = JTrainState.create(jax.tree.map(lambda w: jnp.asarray(w, np.float64), params["params"]),
                                   j_adam(LR, 0, 0, CLIP))
        jb = {k: jnp.asarray(v, np.float64 if v.dtype == np.float32 else v.dtype) for k, v in b.items()}
        return jstep(state, jb, jax.random.PRNGKey(0), *args)


def _inputs():
    b = batch(seed=3, b=4)
    return b, [(b["x"], b["x_hw"]), (b["x"][:3], b["x_hw"][:3])]


@pytest.fixture(scope="module")
def runs():
    """Both meshes' ranks, started at once; the references computed while they run."""
    b, dec = _inputs()
    started = {tag: D.Ranks(D.step_and_decode, data * model, model, SEED, b, LR, CLIP, dec, {})
               for tag, (data, model) in MESHES.items()}

    model, params = port_and_jax_params(seed=SEED, **NO_DROPOUT)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    jstep = j_make_train_step(jax_model(**NO_DROPOUT), V, teacher_forcing_prob=0.0, bf16_compute=False)
    jstate, jloss = _jax_step(jstep, params, b)

    with torch.no_grad():
        decode = greedy_decode_fn(model, 12, sos_id=1, eos_id=V - 1)
        tokens = [decode(torch.from_numpy(x), torch.from_numpy(hw))[0].numpy() for x, hw in dec]
        q_model = D._tiny(None, SEED, cache_dtype="int4")
        cross, _ = q_model.decode_prefill(torch.from_numpy(dec[0][0]), torch.from_numpy(dec[0][1]))
    step = make_train_step(model, V, teacher_forcing_prob=0.0, bf16_compute=False, device="cpu")
    _, loss = step(TrainState.create(model, LR, clip_norm=CLIP), to_torch(b), torch.Generator().manual_seed(0))

    adam_state, = [s for s in jax.tree_util.tree_leaves(jstate.opt_state,
                                                         is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
                   if isinstance(s, optax.ScaleByAdamState)]
    ref = dict(jax_loss=float(jloss), jax_params=jstate.params, loss=float(loss), before=before,
               params={k: v.detach().numpy() for k, v in model.state_dict().items()}, tokens=tokens,
               tscale=cross["layer0"]["k_tscale"].numpy(),
               grads={n: p.grad.numpy().copy() for n, p in model.named_parameters()},
               jax_grads=jax.tree.map(lambda m: np.asarray(m) / (1 - 0.9), adam_state.mu))
    return ref, {tag: r.results() for tag, r in started.items()}


def _update(params, before):
    return np.concatenate([(params[k] - before[k].numpy()).reshape(-1) for k in sorted(before)])


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_parallel_step_loss_matches_jax_single_device(runs, mesh):
    ref, got = runs
    losses = [r["loss"] for r in got[mesh]]
    assert len(losses) == np.prod(MESHES[mesh]) and len(set(losses)) == 1  # the global mean on every rank
    np.testing.assert_allclose(losses[0], ref["jax_loss"], rtol=1e-4)
    np.testing.assert_allclose(losses[0], ref["loss"], rtol=1e-6)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_parallel_step_params_match_jax_and_single_process(runs, mesh):
    ref, got = runs
    params = got[mesh][0]["params"]
    assert set(params) == set(ref["params"]) and all(params[k].shape == ref["params"][k].shape for k in params)
    assert_rel_l2(_update(params, ref["before"]), _update(ref["params"], ref["before"]), 1e-3,
                  f"{mesh} vs single process")
    after_t = convert_unimodal_state_dict(params)
    before_j = convert_unimodal_state_dict({k: v.numpy() for k, v in ref["before"].items()})
    flat_b = dict(jax.tree_util.tree_leaves_with_path(before_j))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(ref["jax_params"]))
    for path, pt in jax.tree_util.tree_leaves_with_path(after_t):
        name = jax.tree_util.keystr(path)
        if "['k_proj']['bias']" not in name:
            assert_rel_l2(pt - flat_b[path], np.asarray(flat_j[path]) - flat_b[path], 5e-2, f"{mesh} vs JAX {name}")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_parallel_step_clipped_gradients_match_jax_and_single_process(runs, mesh):
    ref, got = runs
    grads = got[mesh][0]["grads"]
    assert set(grads) == set(ref["grads"])
    flat = np.concatenate([grads[k].reshape(-1) for k in sorted(grads)]).astype(np.float64)
    np.testing.assert_allclose(np.linalg.norm(flat), CLIP, rtol=1e-5)
    want = np.concatenate([ref["grads"][k].reshape(-1) for k in sorted(grads)])
    assert_rel_l2(flat, want, 1e-3, f"{mesh} vs single process")
    got_j = dict(jax.tree_util.tree_leaves_with_path(convert_unimodal_state_dict(grads)))
    flat_j = jax.tree_util.tree_leaves_with_path(ref["jax_grads"])
    want_j = np.concatenate([np.ravel(g) for _, g in flat_j]).astype(np.float64)
    np.testing.assert_allclose(np.linalg.norm(want_j), CLIP, rtol=1e-5)
    assert_rel_l2(np.concatenate([got_j[path].reshape(-1) for path, _ in flat_j]), want_j, 2e-3, f"{mesh} vs JAX")


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_parallel_greedy_decode_and_remainder_equal_single_process(runs, mesh):
    ref, got = runs
    assert got[mesh][0]["local_heads"] == 4 // MESHES[mesh][1]
    for rank in got[mesh]:
        for tok, want in zip(rank["tokens"], ref["tokens"]):
            np.testing.assert_array_equal(tok, want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_parallel_int4_token_scale_equals_single_process(runs, mesh):
    ref, got = runs
    for rank in got[mesh]:
        np.testing.assert_array_equal(rank["tscale"], ref["tscale"])


class _NoDropoutCrossAttention(j_multimodal.CrossAttention):
    """The JAX mixer's CrossAttention with its weight dropout (0.1, not an
    hparam) off, as the ranks' mixer; same params."""

    dropout: float = 0.0


def _flat(tree_or_dict, keys):
    return np.concatenate([np.ravel(np.asarray(tree_or_dict[k])) for k in keys]).astype(np.float64)


def test_multimodal_step_on_the_2x2_mesh_matches_jax_and_single_process(monkeypatch):
    """The gated attn_both step (modality 'both') on four ranks of a 2 x 2
    mesh: two rows and two mixer heads a rank. The loss is JAX's to 1e-4
    relative and the single process's to 1e-6; the clipped gradients,
    gathered, have the global norm CLIP to 1e-5 (the clip fired, every full
    parameter counted once) and are the single process's to 1e-3 and JAX's
    (its first Adam moment over 1 - b1) to 2e-3 in relative L2 norm over all
    leaves; the update of all parameters is the single process's to 1e-3 and
    JAX's to 5e-2 (the image model's tolerances above, for the same
    reasons)."""
    hp = dict(mixer_type="attn_both", mixer_residual=True, **NO_DROPOUT)
    b = mm_batch(seed=4, b=4)
    ranks = D.Ranks(D.multimodal_step, 4, 2, SEED, b, LR, CLIP, MM_GATE)

    model, params = mm_port_and_jax_params(seed=SEED, gate=MM_GATE, **hp)
    model.cross_attn.dropout = 0.0
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    monkeypatch.setattr(j_multimodal, "CrossAttention", _NoDropoutCrossAttention)
    jstep = j_make_train_step(jax_mm_model(**hp), V, teacher_forcing_prob=0.0, bf16_compute=False, multimodal=True)
    jstate, jloss = _jax_step(jstep, params, b, "both")
    adam_state, = [s for s in jax.tree_util.tree_leaves(jstate.opt_state,
                                                         is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
                   if isinstance(s, optax.ScaleByAdamState)]
    step = make_train_step(model, V, teacher_forcing_prob=0.0, bf16_compute=False, multimodal=True, device="cpu")
    _, loss = step(TrainState.create(model, LR, clip_norm=CLIP), to_torch(b), torch.Generator().manual_seed(0),
                   "both")
    grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    params_after = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    got = ranks.results()

    assert [(r["local_rows"], r["local_heads"]) for r in got] == [(2, 2)] * 4
    losses = {r["loss"] for r in got}
    assert len(losses) == 1
    np.testing.assert_allclose(losses.pop(), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(got[0]["loss"], float(loss), rtol=1e-6)
    g_mesh = got[0]["grads"]
    keys = sorted(grads)
    assert set(g_mesh) == set(grads)
    np.testing.assert_allclose(np.linalg.norm(_flat(g_mesh, keys)), CLIP, rtol=1e-5)
    assert_rel_l2(_flat(g_mesh, keys), _flat(grads, keys), 1e-3, "2x2 gradients vs single process")
    flat_t = dict(jax.tree_util.tree_leaves_with_path(mm_state_dict_to_jax(
        {k: torch.from_numpy(v) for k, v in g_mesh.items()})))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda m: np.asarray(m) / (1 - 0.9), adam_state.mu)))
    assert flat_t.keys() == flat_j.keys()
    jkeys = list(flat_j)
    np.testing.assert_allclose(np.linalg.norm(_flat(flat_j, jkeys)), CLIP, rtol=1e-5)
    assert_rel_l2(_flat(flat_t, jkeys), _flat(flat_j, jkeys), 2e-3, "2x2 gradients vs JAX")
    p_mesh = got[0]["params"]
    assert set(p_mesh) == set(params_after)
    upd = {k: p_mesh[k] - before[k].numpy() for k in p_mesh}
    assert_rel_l2(_flat(upd, keys), _flat({k: params_after[k] - before[k].numpy() for k in keys}, keys), 1e-3,
                  "2x2 update vs single process")
    after_j = dict(jax.tree_util.tree_leaves_with_path(jstate.params))
    before_j = dict(jax.tree_util.tree_leaves_with_path(mm_state_dict_to_jax(before)))
    upd_t = dict(jax.tree_util.tree_leaves_with_path(mm_state_dict_to_jax(
        {k: torch.from_numpy(v) for k, v in upd.items()})))
    assert_rel_l2(_flat(upd_t, jkeys), _flat({k: np.asarray(after_j[k]) - before_j[k] for k in jkeys}, jkeys), 5e-2,
                  "2x2 update vs JAX")


def test_row_parallel_sums_in_float32_closer_to_the_single_process():
    """A row-parallel layer on two gloo ranks in bf16: its float32 partial
    sums, all-reduced and rounded once, lie closer to the single process's
    one bf16 product (the same bf16 operands) than bf16 partial sums
    all-reduced in bf16 do, in max and mean |difference|; both ranks hold
    the same output."""
    from omr_a2s_multimodal_transformer_tpu_torch.models.decoder import linear

    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 32, 1024)).astype(np.float32)
    w = (rng.standard_normal((256, 1024)) / 32).astype(np.float32)
    b = rng.standard_normal(256).astype(np.float32)
    ranks = D.run_ranks(D.row_parallel_sums, 2, x, w, b)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, w, b)]
    single = linear(*bf).float().numpy()
    (wide, narrow), (wide1, narrow1) = ranks
    assert np.array_equal(wide, wide1) and np.array_equal(narrow, narrow1)
    d_wide, d_narrow = np.abs(wide - single), np.abs(narrow - single)
    got = dict(max=(d_wide.max(), d_narrow.max()), mean=(d_wide.mean(), d_narrow.mean()),
               equal=((d_wide == 0).mean(), (d_narrow == 0).mean()))
    assert d_wide.max() <= d_narrow.max() and d_wide.mean() < d_narrow.mean() / 2, got
    assert (d_wide == 0).mean() > (d_narrow == 0).mean(), got


def test_column_parallel_input_gradient_sums_in_float32_closer_to_the_single_process():
    """A column-parallel layer on two gloo ranks in bf16: its input
    gradient, float32 partial products all-reduced and rounded once, lies
    at half or less of the mean |difference| from the single process's
    (one bf16 product of the same bf16 operands) that bf16 partial sums
    all-reduced in bf16 do, and no farther in max; both ranks hold the same
    input gradient; each rank's weight and bias gradients are autograd's
    through ``linear``."""
    from omr_a2s_multimodal_transformer_tpu_torch.models.decoder import linear

    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 32, 256)).astype(np.float32)
    w = (rng.standard_normal((1024, 256)) / 16).astype(np.float32)
    b = rng.standard_normal(1024).astype(np.float32)
    g = rng.standard_normal((4, 32, 1024)).astype(np.float32)
    ranks = D.run_ranks(D.column_parallel_grads, 2, x, w, b, g)
    xs = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    linear(xs, *(torch.from_numpy(a).to(torch.bfloat16) for a in (w, b))).backward(
        torch.from_numpy(g).to(torch.bfloat16))
    single = xs.grad.float().numpy()
    (wide, narrow), (wide1, narrow1) = ranks
    assert np.array_equal(wide[0], wide1[0]) and np.array_equal(narrow[0], narrow1[0])
    for r in ranks:
        assert all(np.array_equal(a, c) for a, c in zip(r[0][1:], r[1][1:]))
    d_wide, d_narrow = np.abs(wide[0] - single), np.abs(narrow[0] - single)
    got = dict(max=(d_wide.max(), d_narrow.max()), mean=(d_wide.mean(), d_narrow.mean()),
               equal=((d_wide == 0).mean(), (d_narrow == 0).mean()))
    assert d_wide.max() <= d_narrow.max() and d_wide.mean() <= d_narrow.mean() / 2, got
    assert (d_wide == 0).mean() > (d_narrow == 0).mean(), got


def test_memory_gradient_summed_over_layers_in_float32_then_all_reduced_once():
    """A memory read by eight column-parallel layers on two gloo ranks in
    bf16, as the decoder's is by its layers' k and v: through
    ``summed_once`` its gradient is all-reduced once (one [B, S, D] float32
    tensor; eight all-reduces without it), both ranks hold the same one, and
    it lies at half or less of the mean |difference| from the float64 sum
    of the same bf16 operands, and no farther in max, than the per-layer
    sums summed in bf16 do; the outputs and the weight and bias gradients
    equal the per-layer path's bit for bit."""
    rng = np.random.default_rng(3)
    m = rng.standard_normal((2, 48, 256)).astype(np.float32)
    w = (rng.standard_normal((8, 512, 256)) / 16).astype(np.float32)
    b = rng.standard_normal((8, 512)).astype(np.float32)
    g = rng.standard_normal((8, 2, 48, 512)).astype(np.float32)
    ranks = D.run_ranks(D.memory_grads, 2, m, w, b, g)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).double().numpy()  # noqa: E731
    exact = np.einsum("lbsn,lnd->bsd", bf(g), bf(w))
    r0, r1 = ranks
    assert r0["once"]["all_reduces"] == [(2, 48, 256)] and len(r0["per_layer"]["all_reduces"]) == 8
    assert np.array_equal(r0["once"]["mem"], r1["once"]["mem"])
    for r in ranks:
        assert all(np.array_equal(a, c) for a, c in zip(r["once"]["y"] + r["once"]["w"],
                                                        r["per_layer"]["y"] + r["per_layer"]["w"]))
    d_once, d_layer = np.abs(r0["once"]["mem"] - exact), np.abs(r0["per_layer"]["mem"] - exact)
    got = dict(max=(d_once.max(), d_layer.max()), mean=(d_once.mean(), d_layer.mean()))
    assert d_once.max() <= d_layer.max() and d_once.mean() <= d_layer.mean() / 2, got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_column_parallel_without_an_axis_is_linear_bit_for_bit(dtype):
    """``column_parallel`` with no 'model' axis runs ``linear`` on each
    pair: the outputs and the input, weight and bias gradients equal the
    plain layer's bit for bit."""
    from omr_a2s_multimodal_transformer_tpu_torch.models.decoder import column_parallel, linear

    rng = np.random.default_rng(2)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in ((2, 16, 64), (48, 64), (48,), (32, 64), (32,))]
    runs = []
    for fn in (lambda x, *p: column_parallel(x, None, p[0:2], p[2:4]),
               lambda x, *p: (linear(x, *p[0:2]), linear(x, *p[2:4]))):
        ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
        ys = fn(*ts)
        sum((y.float() * (i + 1)).sum() for i, y in enumerate(ys)).backward()
        runs.append([y.detach() for y in ys] + [t.grad for t in ts])
    assert all(torch.equal(a, c) for a, c in zip(*runs))
