"""Pre-render a synthetic corpus' frontend cache on the host.

Port of ``tools/prerender_corpus.py``: fills the frontend disk cache
(``data/frontends.py``: ``$OMR_A2S_CACHE_DIR``, default
``./frontend_cache``; JAX's is joblib's ``./joblib_cache``) with
``preprocess_audio`` of every sample of a synthetic config, so that a
later training run of the same config reads it back (``cli.train
--keep_cache`` keeps it after it). It calls ``preprocess_image`` too, as
JAX does, but the port caches an image only when it is resized
(``img_height``), which the training runs this corpus feeds do not ask
for. Rendering
(the synthetic score and audio, the STFT) is host work; ``--device`` is
checked as every tool checks it (``cuda`` unless given ``--device cpu``),
and ``--smoke`` is the tiny shapes:

    python -m omr_a2s_multimodal_transformer_tpu_torch.tools.prerender_corpus --train_n 4096 --eval_n 128 \\
        --measures_range 2 30 [--render_style grand]
"""

from __future__ import annotations

import argparse
import json
import time

from omr_a2s_multimodal_transformer_tpu_torch.tools.run_convergence import synth_cfg


def main(argv=None) -> dict:
    from omr_a2s_multimodal_transformer_tpu_torch.data.frontends import preprocess_audio, preprocess_image
    from omr_a2s_multimodal_transformer_tpu_torch.data.sources import make_source
    from omr_a2s_multimodal_transformer_tpu_torch.device import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train_n", type=int, default=4096)
    p.add_argument("--eval_n", type=int, default=128)
    p.add_argument("--n_measures", type=int, default=30)
    p.add_argument("--measures_range", nargs=2, type=int, default=None)
    p.add_argument("--render_style", default="grand")
    p.add_argument("--audio_style", default="tones", choices=["tones", "bands"])
    p.add_argument("--img_height", type=int, default=361)
    p.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    p.add_argument("--smoke", action="store_true", help="tiny shapes")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    args = p.parse_args(argv)
    resolve_device(args.device)  # without a GPU, fail before any work unless --device cpu

    cfg = json.loads(synth_cfg(args.train_n, args.eval_n, args.smoke, args.n_measures, args.render_style,
                               args.img_height, args.measures_range, args.audio_style))
    out = {}
    for split in args.splits:
        src = make_source("synthetic", split, encoding="kern", synthetic=True, synthetic_kwargs=dict(cfg))
        t0 = time.time()
        for i in range(len(src)):
            s = src[i]
            preprocess_image(s["image"], None)
            preprocess_audio(s["audio"]["array"], s["audio"]["sampling_rate"])
            if i % 100 == 0:
                el = time.time() - t0
                print(f"[{split}] {i + 1}/{len(src)} ({el:.0f}s, "
                      f"{(i + 1) / max(el, 1e-9):.2f}/s)", flush=True)
        out[split] = dict(samples=len(src), wall_s=time.time() - t0)
        print(f"[{split}] done: {len(src)} samples in {time.time() - t0:.0f}s", flush=True)
    return out


if __name__ == "__main__":
    main()
