"""The port's convergence and real-shape pipelines end to end on the CPU
(``--device cpu``, the smoke corpus's tiny shapes), and the verify
recipe's PNG export:

- ``run_convergence --smoke``: the control (plain cross-attention) and the
  production run (flash cross-attention) for 3 epochs each, dropouts and
  token corruption 0: both trajectories of 3 epochs with finite losses
  and a finite last validation, and ``trajectory_match`` equal to the JAX
  tool's ``assemble_report`` over the same runs' ``metrics.jsonl``. The
  production run's flash function rounds q, k, v, p and o to bf16 at the
  kernel boundary (``flash_attention_plain`` on the CPU, as the kernels and
  JAX's do), which at JAX's initialisers moves the loss by 2e-3 in the
  first epoch; the control's cross-attention is given the same boundary
  (``_attend_at_flash_boundary``), so both runs compute the same function
  and their losses agree to float32 rounding (mean relative difference
  <= 1e-4). The production
  run's CLI argv holds ``--use_flash_cross`` and the control's does not;
  both hold ``--keep_cache`` and no other argv does, as in the JAX tool.
- ``run_real_shape_e2e --smoke``: its five stages run and report their
  walls and both trajectories.
- ``export_verify_imgs``: the same PNG pixels as the JAX tool's.
"""

import argparse
import json
import math
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from omr_a2s_multimodal_transformer_tpu_torch.models import decoder as pdecoder
from omr_a2s_multimodal_transformer_tpu_torch.tools import export_verify_imgs as pexport
from omr_a2s_multimodal_transformer_tpu_torch.tools import run_convergence as pconv
from omr_a2s_multimodal_transformer_tpu_torch.tools import run_real_shape_e2e as pe2e
from tools import export_verify_imgs as jexport
from tools import run_convergence as jconv
import torch_port_cache  # noqa: F401, E402  (a frontend cache folder of this process)

torch.set_num_threads(2)  # several pytest workers share the host

CPU_MATCH_TOL = 1e-4  # the control and the production run on the CPU: the same attention, other op order


def _attend_at_flash_boundary(q, k, v, mask=None, dropout_rate=0.0, generator=None, heads_sharded=False):
    """``ops/attention.py`` ``attend`` with the flash kernels' bf16 boundary
    (``flash_attention_plain``): q, k, v and p rounded to bf16, softmax in
    float32, o returned in bf16."""
    assert dropout_rate == 0.0
    bf16 = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    logits = torch.einsum("bqhd,bkhd->bhqk", bf16(q), bf16(k)) * (1.0 / q.shape[-1] ** 0.5)
    if mask is not None:
        logits = logits + mask.float()
    p = bf16(torch.softmax(logits, dim=-1))
    return torch.einsum("bhqk,bkhd->bqhd", p, bf16(v)).to(torch.bfloat16)


def _cross_attention_at_flash_boundary(real):
    """``MultiheadProj.forward`` whose decoder cross-attention (the call
    that passes ``kv_dtype``) takes ``_attend_at_flash_boundary``."""

    def forward(self, q_in, kv_in, mask, dropout_rate=0.0, generator=None, kv_dtype=None):
        if kv_dtype is None:
            return real(self, q_in, kv_in, mask, dropout_rate, generator, kv_dtype)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pdecoder, "attend", _attend_at_flash_boundary)
            return real(self, q_in, kv_in, mask, dropout_rate, generator, kv_dtype)

    return forward


def _recording(argvs):
    parse = argparse.ArgumentParser.parse_args

    def recording(self, args=None, namespace=None):
        if args is not None:
            argvs.append([str(a) for a in args])
        return parse(self, args, namespace)

    return recording


def test_run_convergence_smoke_matches_jax_trajectory_match(tmp_path):
    argvs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", _recording(argvs))
        mp.setattr(pdecoder.MultiheadProj, "forward", _cross_attention_at_flash_boundary(pdecoder.MultiheadProj.forward))
        report = pconv.main(["--smoke", "--device", "cpu", "--workdir", str(tmp_path / "conv"), "--train_n", "4",
                             "--eval_n", "2", "--batch", "2", "--epochs", "3", "--control_epochs", "3",
                             "--check_val_every_n_epoch", "3", "--encoder_dropout", "0", "--decoder_dropout", "0",
                             "--pos_dropout", "0", "--teacher_forcing_prob", "0", "--learning_rate", "3e-4"])
    for name in ("control", "production"):
        traj = report[f"{name}_trajectory"]
        assert [t["epoch"] for t in traj] == [1, 2, 3] and all(math.isfinite(t["train_loss"]) for t in traj)
        assert math.isfinite(traj[-1]["val_sym-er"]) and report[f"{name}_wall_s"] > 0
    match = report["trajectory_match"]
    assert match["epochs_compared"] == 1 and match["mean_rel_loss_diff"] <= CPU_MATCH_TOL
    # the JAX tool's own comparison of the same runs (it writes report.json into the directory it reads)
    shutil.copytree(tmp_path / "conv" / "runs", tmp_path / "jax" / "runs")
    assert jconv.assemble_report(str(tmp_path / "jax"))["trajectory_match"] == match
    assert json.loads((tmp_path / "conv" / "report.json").read_text())["trajectory_match"] == match
    trains = [a for a in argvs if "--ds_name" in a]
    assert [("--use_flash_cross" in a, "--remat" in a, "--device_cache" in a) for a in trains] == [
        (False, True, True), (True, True, True)]
    assert all(a[a.index("--device") + 1] == "cpu" for a in trains)
    assert [a for a in argvs if "--keep_cache" in a] == trains


def test_run_real_shape_e2e_smoke_stages(tmp_path):
    argvs = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", _recording(argvs))
        report = pe2e.main(["--smoke", "--device", "cpu", "--workdir", str(tmp_path / "e2e"), "--train_n", "4",
                            "--epochs", "1", "--check_val_every_n_epoch", "1", "--image_batch", "2", "--audio_batch",
                            "2", "--eval_batch", "2"])
    assert list(report["stages"]) == ["train_image", "train_audio", "test_image", "sw_fusion", "weighted_fusion"]
    for modality in ("image", "audio"):
        traj = report[f"{modality}_trajectory"]
        assert traj and all(math.isfinite(t["train_loss"]) for t in traj if "train_loss" in t)
    # the seeded smoke max lengths, and the vocabulary the corpus built
    cache = tmp_path / "e2e" / "grandstaff_cache"
    assert json.loads((cache / "max_lens" / "ImgDist_ar_w2i_kern.json").read_text()) == pe2e.SMOKE_MAX_LENS
    assert (cache / "vocabs" / "ar_w2i_kern.json").exists()
    clis = [a for a in argvs if "--ds_name" in a]
    assert len(clis) == 5 and [a for a in argvs if "--keep_cache" in a] == [a for a in clis if "--epochs" in a]
    assert all(a[a.index("--device") + 1] == "cpu" for a in clis)


def test_export_verify_imgs_equals_jax(tmp_path):
    paths = pexport.main(str(tmp_path / "port"))
    jexport.main(str(tmp_path / "jax"))
    assert len(paths) == 4
    for p in paths:
        name = p.rsplit("/", 1)[-1]
        got, want = (np.asarray(Image.open(d / name)) for d in (tmp_path / "port", tmp_path / "jax"))
        assert got.dtype == np.uint8 and got.shape == want.shape and np.array_equal(got, want)
