"""Serving daemon CLI: load a checkpoint and serve transcription over HTTP.

Port of ``omr_a2s_multimodal_transformer_tpu/cli/serve.py``: the
dynamic-batching server (``serving.py``) around the end-to-end
transcribers, with the same flags and ``--device`` (``cuda`` unless given
``cpu``). ``--threefry_prng`` picks a JAX PRNG and is accepted and
ignored; ``--cache_dtype int8|int4`` serves from quantized cross K/V.

Example:
  python -m omr_a2s_multimodal_transformer_tpu_torch.cli.serve \
    --checkpoint_path weights/grandstaff/image_kern/best \
    --vocab_path grandstaff/vocabs/ar_w2i_kern.json \
    --image_height 368 --image_widths 1104,2208,4416 --port 8787
"""

from __future__ import annotations

import argparse
import time

from omr_a2s_multimodal_transformer_tpu_torch.cli import common
from omr_a2s_multimodal_transformer_tpu_torch.data.vocab import Vocabulary
from omr_a2s_multimodal_transformer_tpu_torch.serving import TranscriptionServer, serve_http


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint_path", required=True, help="checkpoint dir (state.pt + hparams.json)")
    p.add_argument("--audio_checkpoint_path", default="",
                   help="serve weighted late fusion: --checkpoint_path is the image "
                        "model, this the audio model; requests are (image, wave) pairs "
                        "(HTTP: .npz with arrays 'image' and 'wave')")
    p.add_argument("--alpha", type=float, default=0.5,
                   help="fusion mix weight: alpha*softmax(img) + (1-alpha)*softmax(audio)")
    p.add_argument("--vocab_path", required=True, help="vocabs/ar_w2i_<enc>.json")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--max_batch", type=int, default=16)
    p.add_argument("--max_wait_ms", type=float, default=5.0)
    p.add_argument("--image_height", type=int, default=368,
                   help="padded canvas height (image modality)")
    p.add_argument("--image_widths", default="1104,2208,4416",
                   help="comma-separated width bucket ladder (image modality)")
    p.add_argument("--audio_seconds", default="5,10,19",
                   help="comma-separated waveform bucket ladder in seconds @22.05kHz (audio)")
    p.add_argument("--img_height", type=int, default=None,
                   help="on-device aspect-preserving resize target (reference img_height flag)")
    p.add_argument("--cache_dtype", default=None, choices=["float32", "bfloat16", "int8", "int4"],
                   help="override the decode KV-cache dtype (int8/int4 are not ported yet)")
    p.add_argument("--packed_stem", choices=["on", "off"], default=None,
                   help="override the checkpoint's lane-packed-stem setting (numerics-equivalent)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--threefry_prng", action="store_true",
                   help="picks a JAX PRNG: accepted and ignored by the port")
    p.add_argument("--device", default="cuda", help="torch device to run on: cuda (default) or cpu")
    return p


def start(args):
    """Build the server and its HTTP front from parsed flags -> (server,
    httpd, modality); the caller stops both (``httpd.shutdown()``,
    ``server.stop()``)."""
    common.init_cli(args)
    model, hp, multimodal = common.build_from_checkpoint(args.checkpoint_path, hparams_override={
        "cache_dtype": args.cache_dtype,
        "packed_stem": None if args.packed_stem is None else args.packed_stem == "on",
    }, device=args.device)
    modality = hp.get("input_modality", "image")
    if multimodal or modality == "both":
        raise SystemExit("serving supports unimodal checkpoints; split the multimodal "
                         "checkpoint first (cli.split_ckpt)")
    vocab = Vocabulary.load(args.vocab_path)
    kw = {}
    if args.audio_checkpoint_path:
        if modality != "image":
            raise SystemExit("fused serving: --checkpoint_path must be the IMAGE model "
                             f"(got input_modality={modality!r})")
        audio_model, ahp, amulti = common.build_from_checkpoint(
            args.audio_checkpoint_path, hparams_override={"cache_dtype": args.cache_dtype}, device=args.device)
        if amulti or ahp.get("input_modality") != "audio":
            raise SystemExit("fused serving: --audio_checkpoint_path must be a unimodal "
                             "audio checkpoint")
        modality = "fused"
        kw.update(audio_model=audio_model, alpha=args.alpha)
    if modality in ("image", "fused"):
        kw["image_height"] = args.image_height
        kw["image_widths"] = [int(w) for w in args.image_widths.split(",")]
        kw["img_height"] = args.img_height
    if modality in ("audio", "fused"):
        kw["audio_samples"] = [int(float(s) * 22050) for s in args.audio_seconds.split(",")]
    server = TranscriptionServer(model, modality, vocab=vocab, max_batch=args.max_batch,
                                 max_wait_ms=args.max_wait_ms, device=args.device, **kw)
    httpd = serve_http(server, host=args.host, port=args.port)
    print(f"serving {modality} checkpoint {args.checkpoint_path} "
          f"on http://{args.host}:{httpd.server_address[1]} "
          f"(POST /transcribe with a raw .npy body; GET /healthz)")
    return server, httpd, modality


def main(argv=None) -> None:
    server, httpd, _ = start(build_parser().parse_args(argv))
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        server.stop()


if __name__ == "__main__":
    main()
