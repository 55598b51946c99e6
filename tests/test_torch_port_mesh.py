"""The port's mesh layer against the JAX package's ``parallel/``.

- Placement: every element of every parameter is held by the same model
  rank in both packages. The port's parameters are filled with distinct
  values and converted by the JAX package's own converter; on a 4 x 2 JAX
  mesh, the values that ``param_shardings`` puts on the device of model
  index m are exactly those that the port's rules (``placement``,
  ``local_shard``) give model rank m: flax [in, out] against torch [out,
  in], the packed ``in_proj`` cut by heads within each q/k/v block, the
  odd vocabulary (31) replicated and an even one (32) sharded, the
  multimodal mixer's projections.
- ``shard_batch``: a remainder batch padded as JAX pads it (inputs repeat
  the last row, ``y*`` zeros), each data rank's rows in order.
- ``multihost``: the JAX package's environment fallbacks and precedence
  (tests/test_multihost.py:31-72) with ``init_process_group`` recorded,
  torchrun's variables, the backend choice and ``is_primary``.
- ``make_mesh``'s checks, and the global-shape dropout draws on a 2 x 1
  and a 1 x 2 mesh of two gloo processes: each rank's bits are its slice
  of the single-process draw, and the generators stay in lockstep.
- The worker loader's per-process shards have the record sets of grain's
  ``ShardByJaxProcess(drop_remainder=True)``: disjoint, balanced, covering
  the truncated range (tests/test_multihost.py:92-140).
"""

import jax
import numpy as np
import pytest
import torch
import torch_port_dist as D
from torch_port_common import mm_state_dict_to_jax

from omr_a2s_multimodal_transformer_tpu.parallel import mesh as jmesh
from omr_a2s_multimodal_transformer_tpu.training.torch_import import convert_unimodal_state_dict
from omr_a2s_multimodal_transformer_tpu_torch.models import build_model
from omr_a2s_multimodal_transformer_tpu_torch.parallel import mesh as M
from omr_a2s_multimodal_transformer_tpu_torch.parallel import multihost


def _numbered(model):
    """The model's state_dict with every element a distinct float64 value."""
    out, base = {}, 0
    for k, v in model.state_dict().items():
        out[k] = torch.arange(base, base + v.numel(), dtype=torch.float64).reshape(v.shape)
        base += v.numel()
    return out


@pytest.mark.parametrize("vocab,modality", [(31, "image"), (32, "image"), (31, "both")])
def test_every_element_sits_on_the_model_rank_jax_puts_it(vocab, modality):
    hp = dict(vocab_size=vocab, max_seq_len=6, input_modality=modality)
    if modality == "both":
        hp.update(mixer_type="attn_both", mixer_residual=True)
    model, _ = build_model(hp, device="cpu")
    sd = _numbered(model)
    tree = mm_state_dict_to_jax(sd) if modality == "both" else convert_unimodal_state_dict(sd)
    mesh = jmesh.make_mesh(model=2)
    shardings = jmesh.param_shardings(tree, mesh)
    leaves = jax.tree_util.tree_leaves(tree)
    specs = jax.tree_util.tree_leaves(shardings, is_leaf=lambda s: isinstance(s, jax.sharding.NamedSharding))
    sharded = 0
    for m in range(2):
        dev = mesh.devices[0, m]
        want = np.sort(np.concatenate([np.asarray(leaf)[s.devices_indices_map(leaf.shape)[dev]].reshape(-1)
                                       for leaf, s in zip(leaves, specs)]))
        got = []
        for name, t in sd.items():
            spec = M.placement(name, tuple(t.shape), 2)
            sharded += spec is not None
            got.append(M.local_shard(t, spec, 2, m).reshape(-1).numpy())
        np.testing.assert_array_equal(np.sort(np.concatenate(got)), want)
    per_layer = 2 * 3 + 2 + 1  # two attentions (in_proj weight and bias, out_proj weight), linear1 (2), linear2
    assert sharded // 2 == 8 * per_layer + (2 if vocab % 2 == 0 else 0) + (3 if modality == "both" else 0)


def _full_from_shards(shards, spec):
    """The full tensor from every model rank's shard, in rank order."""
    if spec is None:
        return shards[0]
    shape = list(shards[0].shape)
    per = shape[spec.dim] // spec.blocks
    views = [s.reshape(shape[:spec.dim] + [spec.blocks, per] + shape[spec.dim + 1:]) for s in shards]
    return torch.cat(views, dim=spec.dim + 1).reshape(shape[:spec.dim] + [-1] + shape[spec.dim + 1:])


def test_local_shards_reassemble():
    t = torch.arange(3 * 8 * 5, dtype=torch.float32).reshape(24, 5)
    for spec in (M.COLS, M.ROWS, M.QKV):
        for model in (2, 4):
            if spec == M.ROWS and 5 % model:
                assert M.placement("decoder.x.out_proj.weight", (24, 5), model) is None
                continue
            shards = [M.local_shard(t, spec, model, i) for i in range(model)]
            torch.testing.assert_close(_full_from_shards(shards, spec), t, rtol=0, atol=0)


def _fake_mesh(data, index):
    return M.Mesh(M.Axis("data", data, index), M.Axis("model", 1, 0), index)


def test_shard_batch_pads_a_remainder_as_jax_does():
    batch = {"x": np.arange(3 * 4, dtype=np.float32).reshape(3, 4), "y_out": np.ones((3, 5), np.int32),
             "n": np.int32(7)}
    jax_out = jmesh.shard_batch(batch, jmesh.make_mesh(model=1))  # data axis 8
    parts = [M.shard_batch(batch, _fake_mesh(8, i)) for i in range(8)]
    for key in ("x", "y_out"):
        got = np.concatenate([p[key] for p in parts])
        np.testing.assert_array_equal(got, np.asarray(jax_out[key]))
        assert all(p[key].shape[0] == 1 for p in parts)
    assert all(p["n"] == 7 for p in parts)
    tparts = [M.shard_batch({k: torch.as_tensor(v) for k, v in batch.items()}, _fake_mesh(2, i)) for i in range(2)]
    np.testing.assert_array_equal(torch.cat([p["x"] for p in tparts]).numpy(),
                                  np.concatenate([batch["x"], batch["x"][-1:]]))
    assert (torch.cat([p["y_out"] for p in tparts])[3:] == 0).all()


@pytest.fixture()
def recorded_init(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group", lambda backend, **kw: calls.append((backend, kw)))
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    return calls


def test_initialize_needs_an_address_a_size_and_a_rank(recorded_init):
    with pytest.raises(ValueError, match="address"):
        multihost.initialize(device="cpu")  # nothing tells a process of its cluster here
    assert not recorded_init


def test_initialize_explicit_args(recorded_init):
    multihost.initialize("10.0.0.1:1234", num_processes=4, process_id=2, device="cpu")
    backend, kw = recorded_init[0]
    assert backend == "gloo" and kw["init_method"] == "tcp://10.0.0.1:1234"
    assert (kw["world_size"], kw["rank"]) == (4, 2) and kw["timeout"].total_seconds() == multihost.TIMEOUT_S


def test_initialize_env_fallbacks_and_precedence(recorded_init, monkeypatch):
    monkeypatch.setenv("COORDINATOR_ADDRESS", "host0:9000")
    monkeypatch.setenv("NUM_PROCESSES", "8")
    monkeypatch.setenv("PROCESS_ID", "0")  # PROCESS_ID=0 is honoured (falsy-string pitfall)
    multihost.initialize(device="cpu")
    assert recorded_init[-1][1]["init_method"] == "tcp://host0:9000"
    assert (recorded_init[-1][1]["world_size"], recorded_init[-1][1]["rank"]) == (8, 0)
    multihost.initialize("arg-host:2", process_id=3, device="cpu")  # explicit arguments win
    assert recorded_init[-1][1]["init_method"] == "tcp://arg-host:2" and recorded_init[-1][1]["rank"] == 3


def test_initialize_takes_torchruns_variables(recorded_init, monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert multihost.launched()
    multihost.initialize(device="cpu")
    kw = recorded_init[-1][1]
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == ("tcp://127.0.0.1:29500", 2, 1)


def test_backend_and_primary(monkeypatch):
    assert multihost.choose_backend("cpu", 2) == "gloo"
    if not torch.cuda.is_available():
        assert multihost.choose_backend("cuda", 1) == "gloo"
    assert multihost.is_primary()  # no process group: the only process
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 3)
    assert not multihost.is_primary()


def test_make_mesh_checks_the_world():
    mesh = M.make_mesh()
    assert (mesh.data, mesh.model, mesh.size, mesh.rank) == (1, 1, 1, 0)
    with pytest.raises(ValueError, match="not divisible"):
        M.make_mesh(model=2)  # --mesh_model larger than the world
    with pytest.raises(ValueError, match="!="):
        M.make_mesh(data=2)


@pytest.mark.parametrize("model_axis", [1, 2], ids=["dp", "tp"])
def test_draws_are_the_single_process_draw_sliced(model_axis):
    shape, model_dim = (2, 3, 5), 1
    res = D.run_ranks(D.sharded_draws, 2, model_axis, shape, model_dim)
    g = torch.Generator().manual_seed(5)
    full_shape = (shape[0] * (2 // model_axis), shape[1] * model_axis, shape[2])
    full = torch.rand(full_shape, generator=g).numpy()
    for r in res:
        d, m = r["data_index"], r["model_index"]
        want = full[d * shape[0]:(d + 1) * shape[0], m * shape[1]:(m + 1) * shape[1]]
        np.testing.assert_array_equal(r["local"], want)
        np.testing.assert_array_equal(r["state"], g.get_state().numpy())


def _grain_sets(n_records, n_proc):
    pg = pytest.importorskip("grain.python")
    out = []
    for i in range(n_proc):
        opts = pg.ShardOptions(shard_index=i, shard_count=n_proc, drop_remainder=True)
        sampler = pg.IndexSampler(num_records=n_records, shard_options=opts, shuffle=True, num_epochs=1, seed=0)
        ids, k = set(), 0
        while True:
            try:
                ids.add(int(sampler[k].record_key))
            except IndexError:
                break
            k += 1
        out.append(ids)
    return out


class _Records:
    """A stand-in dataset of n records for the loader's batching."""

    input_modality = "image"
    max_image_height = max_image_width = max_audio_height = max_audio_width = max_seq_len = 8

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("n_proc", [2, 4])
def test_worker_loader_shards_like_shard_by_jax_process(monkeypatch, n_proc):
    from omr_a2s_multimodal_transformer_tpu_torch.data.grain_pipeline import GrainLoader

    n_records = 41  # not divisible by n_proc
    want = _grain_sets(n_records, n_proc)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: n_proc)
    got = []
    for i in range(n_proc):
        monkeypatch.setattr(torch.distributed, "get_rank", lambda i=i: i)
        loader = GrainLoader(_Records(n_records), batch_size=3, shuffle=True, seed=0, num_workers=1)
        assert (loader.shard_index, loader.shard_count) == (i, n_proc)
        ids = [r for b in loader._epoch_batches() for r in b]
        assert len(ids) == len(set(ids)) == n_records // n_proc
        got.append(set(ids))
    assert got == want
    union = set().union(*got)
    assert len(union) == sum(map(len, got)) == (n_records // n_proc) * n_proc and union <= set(range(n_records))
