"""Multi-process runs of the port for its tests: gloo process groups on the
CPU, one process a rank, started with ``spawn``.

``Ranks(fn, world, *args).results()`` runs ``fn(rank, *args)`` in each of
``world`` fresh processes joined into a gloo process group and returns
their results in rank order. Every wait is bounded: a rank that raises, a
hung collective or a slow rank fails the caller within ``timeout``
seconds, and every process is killed before the call returns. This module
imports no JAX (the ranks import it), so the rank functions the tests run
live here too, and the tests compare their results with JAX in the
parent process.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import traceback

import torch
import torch.multiprocessing as mp

RANK_TIMEOUT_S = 90  # a launch's default bound: the whole launch, and each wait on a collective


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, port, args, out, timeout):
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    try:
        torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                             world_size=world,
                                             timeout=datetime.timedelta(seconds=timeout))
        out.put((rank, "ok", fn(rank, *args)))
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails the test
        out.put((rank, "error", traceback.format_exc()))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


class Ranks:
    """``world`` ranks running ``fn(rank, *args)``, started at once; the
    caller may work while they run and then reads ``results()``."""

    def __init__(self, fn, world: int, *args, timeout: float = RANK_TIMEOUT_S):
        ctx = mp.get_context("spawn")
        self._out = ctx.Queue()
        port = _free_port()
        self._procs = [ctx.Process(target=_entry, args=(fn, r, world, port, args, self._out, timeout), daemon=True)
                       for r in range(world)]
        for p in self._procs:
            p.start()
        self._deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)

    def results(self) -> list:
        got, errors = {}, []
        try:
            while len(got) + len(errors) < len(self._procs):
                left = (self._deadline - datetime.datetime.now()).total_seconds()
                try:
                    rank, status, value = self._out.get(timeout=max(left, 0.1))
                except queue.Empty:
                    raise AssertionError(f"ranks {sorted(set(range(len(self._procs))) - set(got))} did not "
                                         "finish in time (a hung collective?)") from None
                if status == "ok":
                    got[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
                    break
            if errors:
                raise AssertionError("\n".join(errors))
            return [got[r] for r in range(len(self._procs))]
        finally:
            for p in self._procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)


def run_ranks(fn, world: int, *args, timeout: float = RANK_TIMEOUT_S) -> list:
    return Ranks(fn, world, *args, timeout=timeout).results()


# ------------------------------------------------------------ rank functions


def _np(sd):
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def _tiny(mesh, seed, **over):
    from omr_a2s_multimodal_transformer_tpu_torch.models import build_model

    hp = dict(vocab_size=31, max_seq_len=12, input_modality="image", encoder_dropout=0.0, decoder_dropout=0.0,
              pos_dropout=0.0)
    hp.update(over)
    return build_model(hp, device="cpu", seed=seed, mesh=mesh)[0]


def step_and_decode(rank, model_axis, seed, batch, lr, clip, decode_batches, hp):
    """On a mesh of ``model_axis`` model ranks: one Adam step of the tiny
    model (seeded weights) on the global ``batch`` (numpy), then greedy
    decodes of each of ``decode_batches`` (x, hw; remainders padded by
    shard_batch). Returns the global loss, the gathered parameters after
    the step and its gathered gradients after the clip (``apply_gradients``
    scales them in place), the decoded tokens of the model before the step
    (the padded rows dropped) and the int4 cross cache's token scales of
    layer 0 (gathered over 'data')."""
    from omr_a2s_multimodal_transformer_tpu_torch.parallel import tp
    from omr_a2s_multimodal_transformer_tpu_torch.parallel.collectives import all_gather
    from omr_a2s_multimodal_transformer_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from omr_a2s_multimodal_transformer_tpu_torch.training.decode import greedy_decode_fn
    from omr_a2s_multimodal_transformer_tpu_torch.training.train_state import TrainState, make_train_step

    mesh = make_mesh(model=model_axis)
    model = _tiny(mesh, seed, **hp)
    step = make_train_step(model, 31, teacher_forcing_prob=0.0, bf16_compute=False, device="cpu")
    state = TrainState.create(model, lr, clip_norm=clip)
    local = {k: torch.from_numpy(v) for k, v in shard_batch(batch, mesh).items()}
    state, loss = step(state, local, mesh.generator("cpu", 0))
    params = _np(tp.full_state_dict(model, mesh))
    grads = _np({n: tp.gather_full(p.grad, model.tp_specs.get(n), mesh) for n, p in model.named_parameters()})
    decode = greedy_decode_fn(_tiny(mesh, seed, **hp), 12, sos_id=1, eos_id=30)
    tokens = []
    for x, hw in decode_batches:
        b = shard_batch({"x": x, "x_hw": hw}, mesh)
        tok, _ = decode(torch.from_numpy(b["x"]), torch.from_numpy(b["x_hw"]))
        tokens.append(all_gather(tok, mesh.data_axis, 0)[:len(x)].numpy())
    q_model = _tiny(mesh, seed, cache_dtype="int4", **hp)
    with torch.no_grad():
        b = shard_batch({"x": decode_batches[0][0], "x_hw": decode_batches[0][1]}, mesh)
        cross, _ = q_model.decode_prefill(torch.from_numpy(b["x"]), torch.from_numpy(b["x_hw"]))
    tscale = all_gather(cross["layer0"]["k_tscale"], mesh.data_axis, 0).numpy()
    return dict(loss=float(loss), params=params if rank == 0 else None, grads=grads if rank == 0 else None,
                tokens=tokens, tscale=tscale,
                local_heads=model.decoder.layers[0].self_attn.heads)


def multimodal_step(rank, model_axis, seed, batch, lr, clip, gate):
    """On a mesh of ``model_axis`` model ranks: one Adam step of the tiny
    gated attn_both multimodal model (seeded weights, ``mix_gate`` set to
    ``gate``, the mixer's own attention dropout off as every other) on the
    global ``batch`` (numpy), both modalities. Returns the global loss and,
    on rank 0, the gathered parameters after the step and the gathered
    gradients after the clip."""
    from omr_a2s_multimodal_transformer_tpu_torch.parallel import tp
    from omr_a2s_multimodal_transformer_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from omr_a2s_multimodal_transformer_tpu_torch.training.train_state import TrainState, make_train_step

    mesh = make_mesh(model=model_axis)
    model = _tiny(mesh, seed, input_modality="both", mixer_type="attn_both", mixer_residual=True)
    model.cross_attn.dropout = 0.0
    with torch.no_grad():
        model.mix_gate.copy_(torch.tensor(gate))
    step = make_train_step(model, 31, teacher_forcing_prob=0.0, bf16_compute=False, multimodal=True, device="cpu")
    state = TrainState.create(model, lr, clip_norm=clip)
    local = {k: torch.from_numpy(v) for k, v in shard_batch(batch, mesh).items()}
    state, loss = step(state, local, mesh.generator("cpu", 0), "both")
    params = _np(tp.full_state_dict(model, mesh))
    grads = _np({n: tp.gather_full(p.grad, model.tp_specs.get(n), mesh) for n, p in model.named_parameters()})
    return dict(loss=float(loss), params=params if rank == 0 else None, grads=grads if rank == 0 else None,
                local_rows=int(local["xi"].shape[0]), local_heads=model.cross_attn.attention.heads)


def partition_loss(rank, seed, batch, spec):
    """The loss of the tiny model under tensor parallelism, with and without
    ``memory_partition`` (deterministic), and its gradient norm with."""
    from omr_a2s_multimodal_transformer_tpu_torch.parallel.mesh import make_mesh
    from omr_a2s_multimodal_transformer_tpu_torch.training.losses import cross_entropy_ignore_pad

    mesh = make_mesh(model=2)
    out = {}
    for tag, part in (("plain", None), ("partitioned", tuple(spec))):
        model = _tiny(mesh, seed, memory_partition=part)
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        loss = cross_entropy_ignore_pad(model(b["x"], b["x_hw"], b["y_in"]), b["y_out"])
        loss.backward()
        out[tag] = float(loss.detach())
        out[tag + "_grad"] = float(sum(p.grad.square().sum() for p in model.encoder.parameters()))
    return out


def cli_main(rank, module, argv):
    """``module.main(argv)`` of a port CLI on this rank (as torchrun runs it)."""
    import importlib

    return importlib.import_module(module).main(argv)


def sharded_draws(rank, model_axis, shape, model_dim):
    """This rank's slice of a global draw from the mesh's generator, and
    the generator's state after it."""
    from omr_a2s_multimodal_transformer_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh(model=model_axis)
    g = mesh.generator("cpu", 5)
    local = mesh_lib.rand(shape, g, "cpu", model_dim=model_dim)
    return dict(local=local.numpy(), state=g.get_state().numpy(), data_index=mesh.data_index,
                model_index=mesh.model_index)




def flash_heads_gathered(rank, n_heads, q, k, v, kv_len, kv_valid, seed, rate):
    """The sharded flash dispatch on a 1 x 2 mesh whose heads do not split
    into whole 128-lane groups (2 heads of 64): each rank gives its head,
    the dispatch gathers q/k/v to both heads, runs the kernel and cuts o
    back. Returns this rank's o and the gradients of sum(o * w) (w fixed)
    with respect to its q/k/v columns."""
    from omr_a2s_multimodal_transformer_tpu_torch.ops import flash_packed as fp
    from omr_a2s_multimodal_transformer_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(model=2)
    cols = slice(mesh.model_index * 64, (mesh.model_index + 1) * 64)
    ql, kl, vl = (torch.from_numpy(t[:, :, cols]).requires_grad_() for t in (q, k, v))
    flash = fp.flash_attention_packed_auto(n_heads, 64, q.shape[0], dropout_rate=rate, block_q=128, block_k=128,
                                           mesh=mesh)
    o = flash(ql, kl, vl, torch.from_numpy(kv_len), torch.from_numpy(kv_valid), seed)
    w = torch.linspace(-1.0, 1.0, o.numel()).reshape(o.shape)
    (o * w).sum().backward()
    return dict(o=o.detach().numpy(), dq=ql.grad.numpy(), dk=kl.grad.numpy(), dv=vl.grad.numpy(),
                split=fp.shard_heads(n_heads, 64, 2))


def row_parallel_sums(rank, x, w, b):
    """On a 1 x 2 mesh in bf16: this rank's half of the input columns of
    ``x @ w.T + b`` through ``row_parallel`` (float32 partial sums) and
    through a bf16 partial sum all-reduced in bf16; both as float32 numpy."""
    from omr_a2s_multimodal_transformer_tpu_torch.models.decoder import linear, row_parallel
    from omr_a2s_multimodal_transformer_tpu_torch.parallel.collectives import reduce_from
    from omr_a2s_multimodal_transformer_tpu_torch.parallel.mesh import make_mesh

    axis = make_mesh(model=2).model_axis
    k = x.shape[-1] // 2
    xs = torch.from_numpy(x[..., rank * k:(rank + 1) * k]).to(torch.bfloat16)
    ws = torch.from_numpy(w[:, rank * k:(rank + 1) * k]).to(torch.bfloat16)
    bias = torch.from_numpy(b).to(torch.bfloat16)
    wide = row_parallel(xs, ws, bias, axis)
    narrow = reduce_from(linear(xs, ws, None), axis) + bias
    assert wide.dtype == narrow.dtype == torch.bfloat16
    return wide.float().numpy(), narrow.float().numpy()


def column_parallel_grads(rank, x, w, b, g):
    """On a 1 x 2 mesh in bf16: the gradients of ``x @ w.T + b``, whose
    output columns (w's rows) are split over the two ranks, under the
    upstream gradient ``g`` (this rank's columns of it), through
    ``column_parallel`` (the input gradient's float32 partial sums) and
    through ``linear`` with its bf16 input gradient all-reduced in bf16
    (the bf16 partial sums); each path's input, weight and bias gradients
    as float32 numpy."""
    from omr_a2s_multimodal_transformer_tpu_torch.models.decoder import column_parallel, linear
    from omr_a2s_multimodal_transformer_tpu_torch.parallel.collectives import all_reduce
    from omr_a2s_multimodal_transformer_tpu_torch.parallel.mesh import make_mesh

    axis = make_mesh(model=2).model_axis
    n = w.shape[0] // 2
    rows = slice(rank * n, (rank + 1) * n)
    out = []
    for wide in (True, False):
        xs = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
        ws = torch.from_numpy(w[rows]).to(torch.bfloat16).requires_grad_()
        bs = torch.from_numpy(b[rows]).to(torch.bfloat16).requires_grad_()
        y = column_parallel(xs, axis, (ws, bs))[0] if wide else linear(xs, ws, bs)
        y.backward(torch.from_numpy(g[..., rows]).to(torch.bfloat16))
        if not wide:
            all_reduce(xs.grad, axis)
        assert xs.grad.dtype == torch.bfloat16
        out.append([t.grad.float().numpy() for t in (xs, ws, bs)])
    return out


def memory_grads(rank, m, w, b, g):
    """On a 1 x 2 mesh in bf16: a memory ``m`` read by len(w) column-parallel
    layers (this rank's half of each layer's rows of ``w`` [L, N, D] and
    ``b`` [L, N], upstream gradients ``g`` [L, ..., N] at this rank's
    columns), its gradient through ``summed_once`` (the layers' float32
    partials summed, all-reduced once) and through ``column_parallel``
    alone (each layer's all-reduced and rounded, the layers summed in
    bf16 by autograd). Each path's outputs, memory and weight gradients as
    float32 numpy, and the all-reduces its backward ran."""
    import torch.distributed as dist

    from omr_a2s_multimodal_transformer_tpu_torch.models.decoder import column_parallel, summed_once
    from omr_a2s_multimodal_transformer_tpu_torch.parallel.mesh import make_mesh

    axis = make_mesh(model=2).model_axis
    n = w.shape[1] // 2
    rows = slice(rank * n, (rank + 1) * n)
    real, calls = dist.all_reduce, []

    def counting(t, *a, **kw):
        calls.append(tuple(t.shape))
        return real(t, *a, **kw)

    out = {}
    for once in (True, False):
        mem = torch.from_numpy(m).to(torch.bfloat16).requires_grad_()
        ws = [torch.from_numpy(wl[rows]).to(torch.bfloat16).requires_grad_() for wl in w]
        bs = [torch.from_numpy(bl[rows]).to(torch.bfloat16).requires_grad_() for bl in b]
        x = summed_once(mem, axis) if once else mem
        ys = [column_parallel(x, axis, (wl, bl), dtype=mem.dtype if once else None)[0] for wl, bl in zip(ws, bs)]
        calls.clear()
        dist.all_reduce = counting
        try:
            torch.autograd.backward(ys, [torch.from_numpy(gl[..., rows]).to(torch.bfloat16) for gl in g])
        finally:
            dist.all_reduce = real
        assert mem.grad.dtype == torch.bfloat16
        out["once" if once else "per_layer"] = dict(
            y=[y.detach().float().numpy() for y in ys], mem=mem.grad.float().numpy(),
            w=[t.grad.float().numpy() for t in ws + bs], all_reduces=list(calls))
    return out


def write_frontend_key(root, start, wave, sr, n):
    """A process of its own: ``preprocess_audio(wave, sr)`` n times into the
    frontend cache at ``root``, from when ``start`` is set."""
    from omr_a2s_multimodal_transformer_tpu_torch.data import frontends

    os.environ[frontends.CACHE_ENV] = root
    start.wait(60)
    for _ in range(n):
        frontends.preprocess_audio(wave, sr)
