"""Shared CLI plumbing.

Port of ``omr_a2s_multimodal_transformer_tpu/cli/common.py``: the same flag
surface (the reference's fire CLIs, its ``train.py:21-36`` and
``test.py:19-26``, plus the JAX package's knobs), and ``--device`` (default
``cuda``), the port's counterpart of ``JAX_PLATFORMS``: without a GPU the
CLIs raise unless given ``--device cpu``.

Data and tensor parallelism: launched by ``python -m torch.distributed.run
--nproc_per_node N`` (or with the JAX package's COORDINATOR_ADDRESS,
NUM_PROCESSES and PROCESS_ID), a CLI starts the process group
(``parallel/multihost.py``: NCCL when each rank has a card, gloo when the
ranks share one or run on the CPU; each rank prints its rank, backend and
device) and runs on a ('data', 'model') mesh of the world with
``--mesh_model`` ranks on 'model' (``make_mesh_if_needed``).

``cli.train``'s ``--keep_cache`` keeps the frontend disk cache
(``data/frontends.py``) after the run, which it empties otherwise, as the
JAX package's does. ``--threefry_prng`` picks a JAX PRNG and is accepted
and ignored; ``--conv_mode`` is accepted and read nowhere, as in
``build_model``.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import torch

from omr_a2s_multimodal_transformer_tpu_torch.data.dataset import ARDataModule
from omr_a2s_multimodal_transformer_tpu_torch.device import DeviceLike, resolve_device
from omr_a2s_multimodal_transformer_tpu_torch.models import build_model
from omr_a2s_multimodal_transformer_tpu_torch.parallel import multihost
from omr_a2s_multimodal_transformer_tpu_torch.parallel.mesh import make_mesh
from omr_a2s_multimodal_transformer_tpu_torch.utils.seed import seed_everything


def add_data_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--ds_name", required=True,
                   help="grandstaff|beethoven|chopin|hummel|joplin|mozart|scarlatti-d|synthetic")
    p.add_argument("--krn_encoding", default="bekern", choices=["kern", "bekern"])
    p.add_argument("--use_distorted_images", action="store_true")
    p.add_argument("--img_height", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--eval_batch_size", type=int, default=None)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--data_root", default=None, help="local grandstaff tree (else HF Hub)")
    p.add_argument("--cache_root", default=None, help="vocab/max-lens cache dir (default ./grandstaff)")
    p.add_argument("--synthetic", action="store_true", help="use the synthetic corpus (smoke runs)")
    p.add_argument("--synthetic_config", default=None,
                   help="JSON dict of SyntheticSource kwargs (smoke runs)")
    p.add_argument("--width_buckets", type=int, default=1,
                   help=">1: geometric width-bucket ladder (fewer padded FLOPs, more distinct shapes)")
    p.add_argument("--loader_backend", default="threads", choices=["threads", "grain"],
                   help="'grain': --num_workers worker processes build the batches (torch DataLoader workers "
                        "in the port, data/grain_pipeline.py); the same batches as the thread loader's")


def add_runtime_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no_bf16", action="store_true", help="disable bf16 compute")
    p.add_argument("--mesh_model", type=int, default=1, help="tensor-parallel mesh axis size")
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--run_dir", default=None)
    p.add_argument("--threefry_prng", action="store_true",
                   help="picks a JAX PRNG: accepted and ignored by the port")
    p.add_argument("--cache_dtype", default=None,
                   choices=["float32", "bfloat16", "int8", "int4"],
                   help="override the decode KV-cache dtype from the checkpoint hparams "
                        "(int8/int4: quantized cross K/V, the self cache in bfloat16)")
    p.add_argument("--device", default="cuda", help="torch device to run on: cuda (default) or cpu")


def make_datamodule(args, input_modality: str) -> ARDataModule:
    return ARDataModule(
        ds_name=args.ds_name,
        krn_encoding=args.krn_encoding,
        input_modality=input_modality,
        use_distorted_images=args.use_distorted_images,
        img_height=args.img_height,
        batch_size=args.batch_size,
        eval_batch_size=args.eval_batch_size,
        num_workers=args.num_workers,
        data_root=args.data_root,
        synthetic=args.synthetic or args.ds_name == "synthetic",
        synthetic_kwargs=json.loads(args.synthetic_config) if args.synthetic_config else None,
        cache_root=args.cache_root,
        seed=args.seed,
        loader_backend=args.loader_backend,
        width_buckets=args.width_buckets,
    )


def model_name_from_args(args, input_modality: str, mixer_type: Optional[str]) -> str:
    """Reference checkpoint naming (train.py:107-112)."""
    name = input_modality
    if input_modality == "image" and args.use_distorted_images:
        name += "_distorted"
    if input_modality == "image" and args.img_height is not None:
        name += f"_height{args.img_height}"
    if mixer_type is not None and input_modality == "both":
        name += f"_{mixer_type}"
    name += f"_{args.krn_encoding}"
    return name


def build_from_checkpoint(checkpoint_path: str, hparams_override: Optional[Dict] = None,
                          device: DeviceLike = None, mesh=None):
    """Load hparams + weights from a checkpoint dir -> (model on ``device``,
    hparams, multimodal flag); with ``mesh``, sharded for this rank.

    hparams_override entries (with non-None values) replace the stored
    hparams — e.g. {"cache_dtype": "float32"} switches the decode cache
    dtype without retraining (runtime knob, not an architecture change)."""
    from omr_a2s_multimodal_transformer_tpu_torch.training import checkpoint as ckpt_lib

    hp = ckpt_lib.load_hparams(checkpoint_path)
    for k, v in (hparams_override or {}).items():
        if v is not None:
            hp[k] = v
    model, multimodal = build_model(hp, device=device, mesh=mesh)
    state = ckpt_lib.restore_checkpoint(checkpoint_path, map_location=next(model.parameters()).device)
    ckpt_lib.load_params(model, ckpt_lib.params_of(state), mesh)
    return model, hp, multimodal


def to_device(batch: Dict, keys, device) -> list:
    """The batch's arrays (numpy, or the worker loader's host tensors)
    under ``keys`` as tensors on ``device``."""
    return [torch.as_tensor(batch[k]).to(device) for k in keys]


def init_cli(args) -> bool:
    """Check the device, start the process group of a multi-process launch
    (when nothing started it yet) and seed. Returns whether it started
    the group (``finish_cli`` then ends it)."""
    resolve_device(args.device)  # without a GPU, fail before any work unless --device cpu
    started = multihost.launched() and not torch.distributed.is_initialized()
    if started:
        multihost.initialize(device=args.device)
        dist = torch.distributed
        # one write, newline included: the ranks share torchrun's stdout
        print(f"process group: rank {dist.get_rank()} of {dist.get_world_size()}, backend {dist.get_backend()}, "
              f"device {resolve_device(args.device)}\n", end="", flush=True)
    seed_everything(args.seed)
    return started


def finish_cli(started: bool) -> None:
    if started:
        multihost.shutdown()


def make_mesh_if_needed(args):
    """The ('data', 'model') mesh of a multi-process run or of
    ``--mesh_model`` > 1 (``--mesh_model`` larger than the world raises,
    as JAX's mesh assert does), else None."""
    world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    if args.mesh_model > 1 or world > 1:
        return make_mesh(model=args.mesh_model)
    return None


def dump_args(args) -> Dict:
    return {k: v for k, v in vars(args).items() if not k.startswith("_")}


def print_config(title: str, args) -> None:
    print(title)
    print(json.dumps(dump_args(args), indent=2, default=str))
