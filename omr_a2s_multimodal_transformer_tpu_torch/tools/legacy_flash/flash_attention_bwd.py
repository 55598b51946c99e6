"""Per-head flash attention with its backward: the legacy kernels L2a
(forward with lse), L2b (dq) and L2c (dk, dv).

Port of ``tools/legacy_flash/flash_attention_bwd.py``. The forward is L1's
function with the per-position key mask ``kv_valid[b, k]`` as well, and
saves lse = m + log(sum exp) (0 on a row with no key). With p = exp(s -
lse) on the keys a query sees (0 elsewhere) and delta = rowsum(do * o),
the backward is

    ds = p * (do v^T - delta),  dq = ds k / sqrt(D),
    dk = ds^T q / sqrt(D),      dv = p^T do.

``make_flash_attention(causal, window, ...)`` returns a differentiable
f(q, k, v, kv_len, kv_valid) on [B, H, L, D] tensors. CPU tensors take the
plain version (``attention_plain``, dense masked softmax in float32,
differentiated by autograd); CUDA tensors go through
``LegacyFlashAttention``, whose forward launches L2a
(``csrc/legacy_flash_fwd.cu``) and whose backward launches L2b
(``csrc/legacy_flash_dq.cu``) and then L2c (``csrc/legacy_flash_dkv.cu``).
Both backward kernels write each row once: no atomics, deterministic. What
the bf16 tensor-core kernels do not take (float16, float32, heads wider
than 128, misaligned rows) goes to the any-dtype kernels
(``csrc/legacy_flash_any_{fwd,dq,dkv}.cu``, float32 on the CUDA cores), as
in L1; the wrappers raise for another dtype, non-contiguous tensors or
mixed devices.
"""

from __future__ import annotations

import functools

import torch

from omr_a2s_multimodal_transformer_tpu_torch.ops import cuda_build
from omr_a2s_multimodal_transformer_tpu_torch.ops.flash_packed import band_window
from omr_a2s_multimodal_transformer_tpu_torch.tools.legacy_flash.flash_attention import (
    KERNEL_DTYPES, attention_plain, check_backward_inputs, check_inputs, kv_len_tensor, launch_fwd,
    legacy_any_fwd_cuda, pad_head_dim, tensor_core_route, unpad_head_dim)


def legacy_fwd_lse_cuda(q, k, v, kv_len, kv_valid, causal: bool = False, window: int = -1):
    """Launch L2a (bf16, D <= 128) or, for what it does not take, the
    any-dtype forward. Returns (o [B, H, Lq, D] in q's dtype, lse f32
    [B, H, Lq])."""
    check_inputs(q, k, v, kv_len, kv_valid)
    if not tensor_core_route(q, k, v):
        return legacy_any_fwd_cuda(q, k, v, kv_len, kv_valid, causal, window, with_lse=True)
    out = launch_fwd(q, k, v, kv_len, kv_valid, causal, window, with_lse=True)
    legacy_fwd_lse_cuda.launches += 1
    return out


legacy_fwd_lse_cuda.launches = 0


def attention_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do * o), f32 [B, H, Lq]: a PyTorch expression, as it
    is XLA outside the JAX kernels (flash_attention_bwd.py:304)."""
    return (do.float() * o.float()).sum(-1)


def _bwd_args(q, k, v, kv_len, kv_valid, do, lse, delta, causal, window):
    check_inputs(q, k, v, kv_len, kv_valid)
    check_backward_inputs(q, do, lse, delta)
    b, h, lq, d = q.shape
    padded = [pad_head_dim(t) for t in (q, k, v, do)]  # the caller keeps them alive until the launch
    qp, kp, vp, dop = padded
    ptrs = [t.data_ptr() for t in (qp, kp, vp, kv_len, kv_valid, dop, lse, delta)]
    ints = [b, h, lq, k.shape[2], qp.shape[3], int(causal), band_window(causal, window)]
    return padded, ptrs, ints, 1.0 / d ** 0.5, torch.cuda.current_stream(q.device).cuda_stream


def _any_args(q, k, v, kv_len, kv_valid, do, lse, delta, causal, window):
    b, h, lq, d = q.shape
    ptrs = [t.data_ptr() for t in (q, k, v, kv_len, kv_valid, do, lse, delta)]
    ints = [KERNEL_DTYPES[q.dtype], b, h, lq, k.shape[2], d, int(causal), band_window(causal, window)]
    return ptrs, ints, 1.0 / d ** 0.5, torch.cuda.current_stream(q.device).cuda_stream


def legacy_any_dq_cuda(q, k, v, kv_len, kv_valid, do, lse, delta, causal: bool = False, window: int = -1):
    """Launch the any-dtype dq (``csrc/legacy_flash_any_dq.cu``) on checked
    inputs: dq [B, H, Lq, D] in q's dtype. Deterministic."""
    ptrs, ints, scale, stream = _any_args(q, k, v, kv_len, kv_valid, do, lse, delta, causal, window)
    dq = torch.empty_like(q)
    err = cuda_build.load("legacy_flash_any_dq")(*ptrs, dq.data_ptr(), *ints, scale, stream)
    if err != 0:
        raise RuntimeError(f"legacy_flash_any_dq launch failed: cudaError {err}")
    legacy_any_dq_cuda.launches += 1
    return dq


legacy_any_dq_cuda.launches = 0


def legacy_any_dkv_cuda(q, k, v, kv_len, kv_valid, do, lse, delta, causal: bool = False, window: int = -1):
    """Launch the any-dtype dk/dv (``csrc/legacy_flash_any_dkv.cu``) on
    checked inputs: (dk, dv) [B, H, Lk, D] in q's dtype. Deterministic."""
    ptrs, ints, scale, stream = _any_args(q, k, v, kv_len, kv_valid, do, lse, delta, causal, window)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = cuda_build.load("legacy_flash_any_dkv")(*ptrs, dk.data_ptr(), dv.data_ptr(), *ints, scale, stream)
    if err != 0:
        raise RuntimeError(f"legacy_flash_any_dkv launch failed: cudaError {err}")
    legacy_any_dkv_cuda.launches += 1
    return dk, dv


legacy_any_dkv_cuda.launches = 0


def legacy_dq_cuda(q, k, v, kv_len, kv_valid, do, lse, delta, causal: bool = False, window: int = -1):
    """Launch L2b (bf16, D <= 128) or, for what it does not take, the
    any-dtype dq: dq [B, H, Lq, D] in q's dtype, given L2a's lse and
    ``attention_delta``. Deterministic: each row is written once."""
    if not tensor_core_route(q, k, v, do):
        check_inputs(q, k, v, kv_len, kv_valid)
        check_backward_inputs(q, do, lse, delta)
        return legacy_any_dq_cuda(q, k, v, kv_len, kv_valid, do, lse, delta, causal, window)
    padded, ptrs, ints, scale, stream = _bwd_args(q, k, v, kv_len, kv_valid, do, lse, delta, causal, window)
    dq = torch.empty_like(padded[0])
    err = cuda_build.load("legacy_flash_dq")(*ptrs, dq.data_ptr(), *ints, scale, stream)
    if err != 0:
        raise RuntimeError(f"legacy_flash_dq launch failed: cudaError {err}")
    legacy_dq_cuda.launches += 1
    return unpad_head_dim(dq, q.shape[3])


legacy_dq_cuda.launches = 0


def legacy_dkv_cuda(q, k, v, kv_len, kv_valid, do, lse, delta, causal: bool = False, window: int = -1):
    """Launch L2c (bf16, D <= 128) or, for what it does not take, the
    any-dtype dk/dv: (dk, dv) [B, H, Lk, D] in q's dtype, given L2a's lse
    and ``attention_delta``. Deterministic: each row is written once."""
    if not tensor_core_route(q, k, v, do):
        check_inputs(q, k, v, kv_len, kv_valid)
        check_backward_inputs(q, do, lse, delta)
        return legacy_any_dkv_cuda(q, k, v, kv_len, kv_valid, do, lse, delta, causal, window)
    padded, ptrs, ints, scale, stream = _bwd_args(q, k, v, kv_len, kv_valid, do, lse, delta, causal, window)
    dk, dv = torch.empty_like(padded[1]), torch.empty_like(padded[1])
    err = cuda_build.load("legacy_flash_dkv")(*ptrs, dk.data_ptr(), dv.data_ptr(), *ints, scale, stream)
    if err != 0:
        raise RuntimeError(f"legacy_flash_dkv launch failed: cudaError {err}")
    legacy_dkv_cuda.launches += 1
    d = k.shape[3]
    return unpad_head_dim(dk, d), unpad_head_dim(dv, d)


legacy_dkv_cuda.launches = 0


class LegacyFlashAttention(torch.autograd.Function):
    """L2a forward; L2b then L2c backward, with delta computed between them
    in float32. Saves q, k, v, kv_len, kv_valid, o and lse (no score
    tensor); kv_len and kv_valid get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, kv_valid, causal, window):
        o, lse = legacy_fwd_lse_cuda(q, k, v, kv_len, kv_valid, causal, window)
        ctx.save_for_backward(q, k, v, kv_len, kv_valid, o, lse)
        ctx.band = (causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_len, kv_valid, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        args = (q, k, v, kv_len, kv_valid, do, lse, attention_delta(do, o), *ctx.band)
        dq = legacy_dq_cuda(*args)
        dk, dv = legacy_dkv_cuda(*args)
        return dq, dk, dv, None, None, None, None


def make_flash_attention(causal: bool = False, window: int = -1, block_q: int = 256, block_k: int = 512):
    """Build a differentiable flash attention f(q, k, v, kv_len, kv_valid) -> o.

    q: [B, H, Lq, D]; k, v: [B, H, Lk, D]; kv_len: [B] prefix lengths;
    kv_valid: [B, Lk] per-position key validity (all True for none), which
    covers non-prefix masks such as the concat mixer's fused image + audio
    memories. The JAX signature (``interpret`` aside): ``block_q`` and
    ``block_k`` are accepted and change nothing, since these kernels have no
    dropout hash seeded by the JAX blocks and the CUDA kernels pick their
    own tiles. CPU tensors take the plain version; CUDA tensors launch L2a
    and, in the backward, L2b and L2c.
    """
    del block_q, block_k
    window = band_window(causal, window)

    def flash(q, k, v, kv_len, kv_valid):
        kv_len = kv_len_tensor(kv_len, q, k.shape[2])
        kv_valid = kv_valid.to(torch.bool)
        if q.device.type == "cpu":
            return attention_plain(q, k, v, kv_len, kv_valid, causal, window)[0]
        if q.device.type != "cuda":
            raise ValueError(f"flash attention runs on CPU or CUDA tensors, got {q.device}")
        return LegacyFlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), kv_len, kv_valid,
                                          causal, window)

    return flash


@functools.lru_cache(maxsize=16)
def flash_attention_cached(causal: bool = False, window: int = -1, block_q: int = 256, block_k: int = 512):
    """Memoized ``make_flash_attention``: one function per configuration."""
    return make_flash_attention(causal=causal, window=window, block_q=block_q, block_k=block_k)
