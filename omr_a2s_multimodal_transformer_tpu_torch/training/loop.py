"""Training runtime: the epoch loop, validation, checkpoints and test.

Port of ``Trainer`` from ``omr_a2s_multimodal_transformer_tpu/training/loop.py``
(the reference's Lightning Trainer, its ``train.py:115-158``): epoch loop,
validation every N epochs by greedy decode + SER/seq-ER, best-checkpoint
tracking on val_sym-er (min), early stopping (min_delta 0.01), resume from
``weights_dir/last``, final reload of the best weights, test, metric logging.

The train step is the port's eager step (``training/train_state.py``); the
host runs ahead of the device, as the JAX loop does: no step waits for the
device, and the epoch's train loss is one read of the mean of the step
losses. Batches go to the device from pinned memory without a wait, and the
inputs (image, spectrogram) are cast to bf16 there under bf16 compute.
Per-step randomness (token corruption, dropout) comes from one
``torch.Generator`` seeded with ``seed + 1``, the counterpart of the JAX
loop's ``PRNGKey(seed + 1)``; its bits differ from JAX's. The multimodal
model's per-step modality (modality dropout, ``draw_modality``) is drawn
from ``np.random.default_rng(seed)`` as in the JAX loop, draw for draw.
``warm_start_from_unimodal`` loads trained unimodal encoders and decoder
into the multimodal model before ``fit``. Evaluation decodes greedily, or
by beam search with ``beam_size > 1``, and adds MV2H with
``compute_mv2h``. ``device_cache`` holds the train corpus on the device
(``data/device_cache.py``, images as uint8 with ``device_cache_u8`` too),
batches gathered there, bit-identical to the streaming loader's.

``mesh`` (``parallel/mesh.py``; the model built on it by ``build_model(...,
mesh=)``) trains on a ('data', 'model') grid of processes, as JAX's Trainer
under a mesh: each batch goes through ``shard_batch`` (a data rank's rows,
a remainder batch padded), the step is the global step (``train_state``),
the dropout draws come from the mesh's generator, evaluation decodes each
rank's rows and gathers the tokens over 'data' before SER (padded rows
dropped), and only rank 0 logs and writes checkpoints, whose tensors every
rank gathers first: a checkpoint is the file of a single-process run, and
restore and warm start slice it back onto the mesh. A train loader that
shards by process (``--loader_backend grain``, JAX's
``ShardByJaxProcess``) is sharded over the data ranks and its batches are
the rank's rows already: its global batch is ``batch_size`` times the data
ranks. The device cache is ignored under a mesh, with JAX's warning. The
fit ends with a barrier.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from omr_a2s_multimodal_transformer_tpu_torch.data.vocab import Vocabulary
from omr_a2s_multimodal_transformer_tpu_torch.device import DeviceLike, check_module_device
from omr_a2s_multimodal_transformer_tpu_torch.parallel import multihost, tp
from omr_a2s_multimodal_transformer_tpu_torch.parallel.collectives import all_gather
from omr_a2s_multimodal_transformer_tpu_torch.parallel.mesh import shard_batch
from omr_a2s_multimodal_transformer_tpu_torch.training import checkpoint as ckpt_lib
from omr_a2s_multimodal_transformer_tpu_torch.training.corruption import draw_modality
from omr_a2s_multimodal_transformer_tpu_torch.training.decode import beam_decode_fn, cut_at_eos, greedy_decode_fn
from omr_a2s_multimodal_transformer_tpu_torch.training.train_state import (
    TrainState,
    make_train_step,
    param_groups,
    trainable_parameters,
)
from omr_a2s_multimodal_transformer_tpu_torch.utils.logging import MetricsLogger, NullLogger
from omr_a2s_multimodal_transformer_tpu_torch.utils.metrics import compute_metrics
from omr_a2s_multimodal_transformer_tpu_torch.utils.profiling import StepTimer, trace


class Trainer:
    def __init__(
        self,
        model,
        vocab: Vocabulary,
        hparams: Dict,
        weights_dir: str,
        run_dir: str = "runs/default",
        epochs: int = 1000,
        patience: int = 20,
        min_delta: float = 0.01,
        check_val_every_n_epoch: int = 5,
        learning_rate: float = 1e-4,
        warmup_steps: int = 0,
        decay_steps: int = 0,
        clip_norm: float = 0.0,  # >0: global-norm gradient clipping (post-LN spike guard)
        train_only=None,  # e.g. ("cross_attn", "mix_gate"): freeze all other top-level param groups
        teacher_forcing_prob: float = 0.2,
        teacher_forcing_modality_prob: float = 0.2,  # multimodal: the chance of a single-modality step
        bf16_compute: bool = True,
        multimodal: bool = False,
        mesh=None,
        use_wandb: bool = False,
        wandb_group: Optional[str] = None,
        wandb_name: Optional[str] = None,
        seed: int = 42,
        ytest_i2w: Optional[Dict[int, str]] = None,
        compute_mv2h: bool = False,
        profile_first_epoch: bool = False,
        beam_size: int = 1,  # >1: beam search at eval (the reference is greedy-only)
        length_penalty: float = 0.0,  # GNMT length penalty for beam search
        device_cache: bool = False,
        device_cache_u8: bool = False,
        device: DeviceLike = None,  # cuda unless the caller asks for another device
    ):
        if mesh is not None and getattr(model, "mesh", None) is not mesh:
            raise ValueError("Trainer(mesh=...) trains a model built on that mesh (build_model(..., mesh=mesh))")
        self.mesh = mesh
        self.primary = mesh is None or mesh.rank == 0
        self.device = check_module_device(model, device)
        self.model = model
        self.vocab = vocab
        self.hparams = hparams
        self.weights_dir = weights_dir
        self.epochs = epochs
        self.patience = patience
        self.min_delta = min_delta
        self.check_every = check_val_every_n_epoch
        self.multimodal = multimodal
        self.tf_modality_prob = teacher_forcing_modality_prob
        self.seed = seed
        self.ytest_i2w = ytest_i2w  # cross-domain eval: GT decoded in test vocab
        self.profile_first_epoch = profile_first_epoch
        self.compute_mv2h = compute_mv2h
        self.beam_size, self.length_penalty = beam_size, length_penalty
        self.learning_rate, self.warmup_steps, self.decay_steps = learning_rate, warmup_steps, decay_steps
        self.clip_norm = clip_norm
        self.train_only = tuple(train_only) if train_only else None
        trainable_parameters(model, self.train_only)  # a name that matches no group raises here
        self.logger = MetricsLogger(
            run_dir, use_wandb=use_wandb, wandb_group=wandb_group, wandb_name=wandb_name, config=hparams
        ) if self.primary else NullLogger(run_dir)
        self.train_step = make_train_step(
            model, vocab_size=len(vocab), teacher_forcing_prob=teacher_forcing_prob,
            bf16_compute=bf16_compute, multimodal=multimodal, device=self.device,
        )
        self.bf16_compute = bf16_compute
        # the train corpus in device memory; u8 image residency only with it, as in the JAX Trainer
        self.device_cache, self.device_cache_u8 = device_cache, device_cache_u8
        self._decode = None
        self.state: Optional[TrainState] = None
        self.last_eval: Dict[str, float] = {}  # decode time and steps of the last evaluate

    # ------------------------------------------------------------------ setup
    def init_state(self, sample_batch: Optional[Dict] = None) -> TrainState:
        """Adam over the model's current weights (random from build_model's
        seed, or loaded). ``sample_batch`` is taken for the JAX signature:
        the port's model holds its weights before the first batch."""
        self.state = self._new_state()
        # model summary (the reference prints torchinfo tables at init)
        groups = param_groups(self.model)
        n_params = sum(p.numel() for ps in groups.values() for p in ps)
        per_top = {k: sum(p.numel() for p in ps) for k, ps in groups.items()}
        self.logger.log({"trainable_params": n_params, **{f"params_{k}": v for k, v in per_top.items()}},
                        step=0, quiet=False)
        return self.state

    def _new_state(self) -> TrainState:
        return TrainState.create(self.model, self.learning_rate, self.warmup_steps, self.decay_steps,
                                 self.clip_norm, self.train_only)

    def restore(self, path: str) -> None:
        """Restore params (+ optimizer state and step when present and
        structurally compatible — full resume semantics). Params that do
        not fit the model (a name or a shape, e.g. a ``mix_gate`` of
        another mixer) raise ``ValueError`` naming the leaf."""
        restored = ckpt_lib.restore_checkpoint(path, map_location=self.device)
        ckpt_lib.load_params(self.model, ckpt_lib.params_of(restored), self.mesh)
        if self.state is None:
            self.state = self._new_state()
            return
        try:  # full resume
            opt = self.state.optimizer
            opt.load_state_dict(tp.local_optimizer_state(self.model, opt, restored["opt_state"], self.mesh))
            self.state.step = int(restored["step"])
        except (KeyError, ValueError) as e:
            # LOUD fallback: silently resetting Adam moments mid-run after
            # a structural mismatch (e.g. an optimizer/model refactor)
            # would corrupt a resumed training trajectory undetected.
            msg = (
                f"full resume from {path} failed ({type(e).__name__}: {e}); "
                "falling back to PARAMS-ONLY restore — optimizer state and "
                "step counter are reset"
            )
            logging.getLogger(__name__).warning(msg)
            if self.logger is not None:
                self.logger.log({"resume_degraded": msg}, step=0)

    def warm_start_from_unimodal(self, image_ckpt: Optional[str] = None, audio_ckpt: Optional[str] = None,
                                 decoder_from: str = "image") -> None:
        """Overwrite the multimodal encoders/decoder with trained unimodal
        checkpoints (ckpt_lib.stitch_multimodal_params); mixer params
        (cross_attn, mix_gate) keep their fresh init and the optimizer
        restarts from step 0. Call after init_state, before fit."""
        if self.state is None:
            raise RuntimeError("init_state first")
        if not self.multimodal:
            raise ValueError("warm start targets the multimodal model")

        def _load(path):
            return ckpt_lib.params_of(ckpt_lib.restore_checkpoint(path, map_location=self.device)) if path else None

        stitched = ckpt_lib.stitch_multimodal_params(
            tp.full_state_dict(self.model, self.mesh), _load(image_ckpt), _load(audio_ckpt), decoder_from,
            mixer_type=self.model.mixer_type if self.model.mixer_residual else None)
        ckpt_lib.load_params(self.model, stitched, self.mesh)
        self.state = self._new_state()
        self.logger.log({"warm_start_image": image_ckpt or "", "warm_start_audio": audio_ckpt or "",
                         "warm_start_decoder_from": decoder_from}, step=0, quiet=False)

    # ------------------------------------------------------------------ train
    # float32 inputs the bf16 train step reads in bf16 anyway: cast on the
    # device after the transfer (the JAX loop casts them on the host)
    _BF16_SHIP_KEYS = ("x", "xi", "xa")

    def _put(self, batch: Dict, bf16_inputs: bool = False, local: bool = False) -> Dict[str, torch.Tensor]:
        """A loader's batch on the device: numpy arrays, host tensors (the
        worker loader's, pinned on a card) or tensors already there (the
        device cache's, already cast). On a mesh, this rank's rows of it
        (``shard_batch``), unless the loader gave them (``local``)."""
        if self.mesh is not None and not local:
            batch = shard_batch(batch, self.mesh)
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            if t.device == self.device:
                pass
            elif self.device.type == "cuda":
                t = (t if t.is_pinned() else t.pin_memory()).to(self.device, non_blocking=True)
            else:
                t = t.to(self.device)
            if bf16_inputs and k in self._BF16_SHIP_KEYS and t.dtype == torch.float32:
                t = t.to(torch.bfloat16)
            out[k] = t
        return out

    def fit(self, datamodule, auto_resume: bool = True) -> Dict[str, float]:
        datamodule.setup("fit")
        train_loader = datamodule.train_dataloader()
        val_loader = datamodule.val_dataloader()
        local_batches = False  # whether the train loader gives this rank's rows
        if self.mesh is not None:
            if self.device_cache:
                logging.getLogger(__name__).warning(
                    "device_cache ignored under a mesh (streaming loader keeps host->device sharding explicit)")
            if hasattr(train_loader, "set_shard"):  # a loader that shards by process: over the data ranks
                train_loader.set_shard(self.mesh.data_index, self.mesh.data)
            local_batches = getattr(train_loader, "shard_count", 1) > 1
            val_loader = self._whole(val_loader)
        elif self.device_cache:
            from omr_a2s_multimodal_transformer_tpu_torch.data.device_cache import DeviceCacheLoader

            train_loader = DeviceCacheLoader(train_loader, self.device, cast_bf16=self.bf16_compute,
                                             store_u8=self.device_cache_u8)
        start_epoch = 1
        best = float("inf")
        best_epoch = -1
        if self.state is None:
            # JAX's init takes the loader's first batch, which moves its shuffle stream on one epoch; the port's
            # init needs no batch, so the fit only moves the stream on (no batch rendered, no worker started)
            train_loader._epoch_batches()
            self.init_state()
            last = os.path.join(self.weights_dir, "last")
            if auto_resume and os.path.exists(last):
                # crash/restart recovery: resume the latest full state AND
                # the epoch/best-metric bookkeeping from the hparams sidecars
                # (otherwise a resumed run restarts epoch numbering at 1 —
                # retraining self.epochs MORE epochs — and best=inf lets the
                # first post-resume val overwrite a better pre-crash 'best').
                self.restore(last)
                meta = ckpt_lib.load_hparams(last)
                start_epoch = int(meta.get("epoch", 0)) + 1
                best_path = os.path.join(self.weights_dir, "best")
                if os.path.exists(best_path):
                    bmeta = ckpt_lib.load_hparams(best_path)
                    if "val_sym-er" in bmeta:
                        best = float(bmeta["val_sym-er"])
                        best_epoch = int(bmeta.get("epoch", -1))
                self.logger.log(
                    {"resumed_from": last, "resumed_step": int(self.state.step),
                     "resumed_epoch": start_epoch - 1, "resumed_best": best},
                    step=int(self.state.step),
                )
        # where this fit starts: epoch, best val_sym-er and its epoch (from the sidecars on resume)
        self.start_epoch, self.best, self.best_epoch = start_epoch, best, best_epoch

        host_rng = np.random.default_rng(self.seed)
        generator = (torch.Generator(device=self.device).manual_seed(self.seed + 1) if self.mesh is None
                     else self.mesh.generator(self.device, self.seed + 1))
        bad_checks = 0
        step = int(self.state.step)
        timer = StepTimer()

        for epoch in range(start_epoch, self.epochs + 1):
            t0 = time.time()
            losses = []
            it = iter(train_loader)
            ctx = (
                trace(self.logger.path + "_trace.json")
                if (self.profile_first_epoch and epoch == 1)
                else contextlib.nullcontext()
            )
            with ctx:
                while True:
                    with timer.phase("data"):
                        batch = next(it, None)
                    if batch is None:
                        break
                    with timer.phase("step"):
                        b = self._put(batch, bf16_inputs=self.bf16_compute, local=local_batches)
                        if self.multimodal:
                            modality = draw_modality(host_rng, self.tf_modality_prob)
                            self.state, loss = self.train_step(self.state, b, generator, modality)
                        else:
                            self.state, loss = self.train_step(self.state, b, generator)
                    losses.append(loss)
                    step += 1
            train_loss = float(torch.stack(losses).mean()) if losses else float("nan")
            dt = time.time() - t0
            n_samples = len(losses) * train_loader.batch_size * (self.mesh.data if local_batches else 1)
            self.logger.log(
                {"epoch": epoch, "train_loss": train_loss,
                 "samples_per_sec": n_samples / max(dt, 1e-9), **timer.summary()},
                step=step,
            )

            if epoch % self.check_every == 0:
                metrics = self.evaluate(val_loader, name="val")
                self.logger.log({"epoch": epoch, **metrics}, step=step)
                score = metrics["val_sym-er"]
                self.save(tag="last", extra={"val_sym-er": score, "epoch": epoch})
                if score < best - self.min_delta:
                    best, best_epoch, bad_checks = score, epoch, 0
                    self.save(tag="best", extra={"val_sym-er": score, "epoch": epoch})
                else:
                    bad_checks += 1
                    if bad_checks >= self.patience:
                        self.logger.log({"early_stop_epoch": epoch, "best_val_sym-er": best}, step=step)
                        break

        if self.device_cache and self.mesh is None:
            self.logger.log({"device_cache_bytes": train_loader.nbytes(),
                             "device_cache_samples": len(train_loader.ds)}, step=step)
        # the worker loader's processes end with the fit, and the device cache's stacks leave the card
        for loader in (train_loader, val_loader):
            getattr(loader, "close", lambda: None)()
        # reload best weights (reference train.py:156-158)
        best_path = os.path.join(self.weights_dir, "best")
        if os.path.exists(best_path):
            self.restore(best_path)
        if self.mesh is not None:
            multihost.barrier()
        return {"best_val_sym-er": best, "best_epoch": best_epoch}

    # ------------------------------------------------------------------- eval
    @staticmethod
    def _whole(loader):
        """An evaluation loader over the whole split: one that shards by
        process is given one shard (every rank decodes its rows of each
        global batch, ``_put``)."""
        if hasattr(loader, "set_shard"):
            loader.set_shard(0, 1)
        return loader

    def _get_decode(self):
        if self._decode is None:
            kw = dict(max_len=self.model.max_seq_len, sos_id=self.vocab.sos_id, eos_id=self.vocab.eos_id,
                      multimodal=self.multimodal)
            if self.beam_size > 1:
                self._decode = beam_decode_fn(self.model, beam_size=self.beam_size,
                                              length_penalty=self.length_penalty, **kw)
            else:
                self._decode = greedy_decode_fn(self.model, **kw)
        return self._decode

    def evaluate(self, loader, name: str = "val", gt_i2w: Optional[Dict[int, str]] = None,
                 save_preds: Optional[str] = None) -> Dict[str, float]:
        decode = self._get_decode()
        i2w = self.vocab.i2w
        gt_i2w = gt_i2w or (self.ytest_i2w if name == "test" and self.ytest_i2w else i2w)
        eos = self.vocab.eos_id
        y_true, y_pred = [], []
        t0 = time.perf_counter()
        # Keep decode outputs on device while the loop streams batches; one
        # bulk transfer at the end.
        pending = []
        for batch in loader:
            b = self._put(batch)
            if self.multimodal:
                tokens, _ = decode(b["xi"], b["xi_hw"], b["xa"], b["xa_hw"])
            else:
                tokens, _ = decode(b["x"], b["x_hw"])
            if self.mesh is not None:  # every data rank's rows, the padded ones dropped
                tokens = all_gather(tokens, self.mesh.data_axis, 0)[:len(batch["y_out"])]
            pending.append((tokens, batch["y_out"]))
        host = [(tokens.cpu().numpy(), y_out) for tokens, y_out in pending]
        decode_s = time.perf_counter() - t0
        steps = max((int((tokens != 0).any(0).sum()) for tokens, _ in host), default=0)
        for tokens, y_out in host:
            pred_ids, _ = cut_at_eos(tokens, tokens, eos)
            gt_ids, _ = cut_at_eos(y_out, y_out, eos)
            # GT rows are padded with 0s; strip pads when no eos was found
            for p_row, g_row in zip(pred_ids, gt_ids):
                g_row = [g for g in g_row if g != 0]
                y_pred.append([i2w[i] for i in p_row])
                y_true.append([gt_i2w[i] for i in g_row])
        self.last_eval = {f"{name}_decode_s": decode_s, f"{name}_decode_steps": steps,
                          f"{name}_decode_batches": len(host)}
        self.logger.log(self.last_eval, step=int(self.state.step) if self.state is not None else 0, quiet=True)
        metrics = compute_metrics(y_true, y_pred, compute_mv2h=self.compute_mv2h)
        if save_preds and self.primary:
            os.makedirs(os.path.dirname(save_preds) or ".", exist_ok=True)
            with open(save_preds, "w") as f:
                for g, p in zip(y_true, y_pred):
                    f.write(json.dumps({"y_true": g, "y_pred": p}) + "\n")
        return {f"{name}_{k}": v for k, v in metrics.items()}

    def test(self, datamodule, save_preds: Optional[str] = None) -> Dict[str, float]:
        datamodule.setup("test")
        metrics = self.evaluate(self._whole(datamodule.test_dataloader()), name="test", save_preds=save_preds)
        self.logger.log(metrics, step=int(self.state.step))
        return metrics

    # ------------------------------------------------------------------- ckpt
    def save(self, tag: str = "best", extra: Optional[Dict] = None) -> str:
        path = os.path.join(self.weights_dir, tag)
        hp = dict(self.hparams)
        if extra:
            hp.update(extra)
        state = {  # full tensors: every rank gathers, rank 0 writes
            "params": tp.full_state_dict(self.model, self.mesh),
            "opt_state": tp.full_optimizer_state(self.model, self.state.optimizer, self.mesh),
            "step": int(self.state.step),
        }
        if self.primary:
            ckpt_lib.save_checkpoint(path, state, hparams=hp)
        if self.mesh is not None:  # no rank reads it before it is written
            multihost.barrier()
        return path
