"""The port of the repository's ``tools/``: the per-head legacy flash
attention and the bench that holds it against the head-packed kernels, and
the experiment layer (the grid driver, the convergence and real-shape runs,
the checkpoint evaluators, the diagnostics and the corpus oracles), each
module under its JAX file's name, run as ``python -m
omr_a2s_multimodal_transformer_tpu_torch.tools.<name>``."""
