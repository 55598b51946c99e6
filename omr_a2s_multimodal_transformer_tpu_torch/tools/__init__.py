"""The port of the repository's ``tools/``: the per-head legacy flash
attention and the bench that holds it against the head-packed kernels, the
experiment layer (the grid driver, the convergence and real-shape runs,
the checkpoint evaluators, the diagnostics and the corpus oracles), the
measurement tools (``bench_train_max``, ``bench_decode_max``,
``bench_serve``, ``bench_ingest``) and the profiling tools
(``profile_flagship``, ``trace_breakdown``, ``hlo_bytes``, ``hbm_ledger``,
``microbench_decode_step``, ``bench_stem``, ``bench_fused_block``,
``sweep_flash_blocks``, ``measure_stream_rate``, ``summarize_ingest``,
``prerender_corpus``), each module under its JAX file's name, run as
``python -m omr_a2s_multimodal_transformer_tpu_torch.tools.<name>``."""
