"""The round-1 per-head flash attention (L1 forward; L2a forward with lse,
L2b dq, L2c dk/dv), kept only as the comparison baseline of
``tools/bench_flash_packed.py``. The production kernels are the head-packed
ones of ``ops/flash_packed.py``; no model calls these."""
