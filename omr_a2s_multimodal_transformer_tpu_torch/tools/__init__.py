"""The port of the repository's ``tools/`` that reach a kernel: the per-head
legacy flash attention and the bench that holds it against the head-packed
kernels."""
