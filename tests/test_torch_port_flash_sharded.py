"""The port's sharded flash dispatch (``ops/flash_packed.py``
``flash_attention_packed_auto``) against JAX's under a device mesh.

- JAX's ``flash_attention_packed_auto`` under a (2, 2) and a (4, 1) mesh
  of the 8 CPU devices, in interpret mode, at the shape of
  tests/test_flash_sharded.py (B 8, 128 x 256, 4 heads of 64) and with
  dropout 0.1 and ragged keys, against the port's plain flash run shard by
  shard in this process, each shard on its rows and heads with its mixed
  seed: equal to 2e-5 (both float32; JAX's own sharded test holds 2e-5).
  The mixing matters: without it the output differs.
- The seed mix itself: JAX's int32 products, wrapped, for indices past the
  int32 range.
- A head count that does not split into whole 128-lane groups (2 heads of
  64 on a 1 x 2 mesh, two gloo processes): each rank's head is gathered
  back, the kernel runs on both heads and o is cut back; o and the
  gradients equal the unsharded call's to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_dist as D
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from omr_a2s_multimodal_transformer_tpu.ops import flash_packed as jfp
from omr_a2s_multimodal_transformer_tpu_torch.ops import flash_packed as fp
from omr_a2s_multimodal_transformer_tpu_torch.parallel.mesh import Axis, Mesh

H, DH = 4, 64
B, LQ, LK = 8, 128, 256
RATE, SEED = 0.1, 1234


def _inputs(b=B, heads=H):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((b, n, heads * DH)).astype(np.float32) for n in (LQ, LK, LK))
    kv_len = np.full((b,), LK, np.int32)
    kv_valid = np.ones((b, LK), bool)
    kv_valid[1::2, LK - 37:] = False
    return q, k, v, kv_len, kv_valid


def _jax_sharded(shape):
    q, k, v, kv_len, kv_valid = _inputs()
    mesh = JMesh(np.array(jax.devices()[: shape[0] * shape[1]]).reshape(shape), ("data", "model"))
    with mesh:
        auto = jfp.flash_attention_packed_auto(n_heads=H, dh=DH, batch=B, block_q=128, block_k=128,
                                               dropout_rate=RATE, interpret=True)
        sh = NamedSharding(mesh, P("data"))
        args = [jax.device_put(jnp.asarray(a), sh) for a in (q, k, v, kv_len, kv_valid)]
        return np.asarray(jax.jit(auto)(*args, jnp.int32(SEED)))


def _port_sharded(shape, mixed=True):
    data, model = shape
    q, k, v, kv_len, kv_valid = (torch.from_numpy(a) for a in _inputs())
    out = torch.zeros_like(q)
    split = fp.shard_heads(H, DH, model)
    for d in range(data):
        for m in range(model):
            rows = slice(d * B // data, (d + 1) * B // data)
            cols = slice(m * H * DH // model, (m + 1) * H * DH // model) if split else slice(None)
            mesh = Mesh(Axis("data", data, d), Axis("model", model, m), d * model + m)
            flash = fp.flash_attention_packed_auto(H, DH, B, block_q=128, block_k=128, dropout_rate=RATE,
                                                   mesh=mesh if mixed else None)
            n = H // model if split else H
            if not mixed:
                flash = fp.make_flash_attention_packed(n, block_q=128, block_k=128, dropout_rate=RATE)
            out[rows, :, cols] = flash(q[rows, :, cols].contiguous(), k[rows, :, cols].contiguous(),
                                       v[rows, :, cols].contiguous(), kv_len[rows], kv_valid[rows], SEED)
    return out.numpy()


@pytest.mark.parametrize("shape", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
def test_port_sharded_flash_with_dropout_equals_jax_auto(shape):
    want = _jax_sharded(shape)
    got = _port_sharded(shape)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert np.abs(_port_sharded(shape, mixed=False) - want).max() > 1e-2  # the shards' seeds are mixed


def test_shard_seed_is_jax_int32_mix():
    for d, m, split in ((0, 0, True), (1, 1, True), (3, 0, False), (7, 5, True), (11, 3, False)):
        want = jnp.int32(d) * jnp.int32(479001599)
        if split:
            want = want ^ (jnp.int32(m) * jnp.int32(15485863))
        assert fp.shard_seed(d, m, split) == int(want)
        assert -2 ** 31 <= fp.shard_seed(d, m, split) < 2 ** 31
    assert fp.shard_heads(4, 64, 2) and not fp.shard_heads(4, 64, 4) and not fp.shard_heads(2, 64, 2)


def test_unsplit_heads_are_gathered_for_the_kernel():
    q, k, v, kv_len, kv_valid = _inputs(b=2, heads=2)
    res = D.run_ranks(D.flash_heads_gathered, 2, 2, q, k, v, kv_len, kv_valid, SEED, RATE)
    assert not res[0]["split"]
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    # the model ranks share the data index 0: the seed is mixed with 0, i.e. unchanged
    o = fp.make_flash_attention_packed(2, block_q=128, block_k=128, dropout_rate=RATE)(
        qt, kt, vt, torch.from_numpy(kv_len), torch.from_numpy(kv_valid), SEED)
    for m, r in enumerate(res):
        cols = slice(m * DH, (m + 1) * DH)
        w = torch.linspace(-1.0, 1.0, r["o"].size).reshape(r["o"].shape)
        (o[:, :, cols] * w).sum().backward(retain_graph=True)
        np.testing.assert_allclose(r["o"], o[:, :, cols].detach().numpy(), rtol=1e-6, atol=1e-6)
    for name, t in (("dq", qt), ("dk", kt), ("dv", vt)):
        got = np.concatenate([r[name] for r in res], axis=-1)
        np.testing.assert_allclose(got, t.grad.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
