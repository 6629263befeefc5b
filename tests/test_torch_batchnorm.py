"""K13's plain version, `gat_tpu_torch/ops/batchnorm.py::
batch_norm_train_plain`, against flax's `nn.BatchNorm(
use_running_average=False, momentum=0.9, epsilon=1e-5)` in train mode, as
the JAX CNN calls it: the output, the running statistics, and jax.grad of
a weighted sum of the output (weights from the same numpy seed: the
gradient of a plain sum with respect to x is 0) with respect to x, scale
and bias, in float32 and in bfloat16 (flax's `dtype`; the statistics in
float32 either way). Inputs are NHWC for flax and the same values NCHW for
the port.

Tolerances: float32, output 1e-5 and gradients 1e-4 of their largest
value (sums over the batch in another order, and E[x²] - E[x]² loses the
digits of E[x²] to var); running statistics 1e-6 relative. bfloat16:
output and the x gradient within two bf16 ulps of each value plus 1e-3 of
the largest (the float32 values they round from differ in their last
bits, and flax rounds its normalized output before the weighted sum's
backward while the port's autograd does not), scale and bias gradients
2e-2 relative; running statistics 1e-6 relative (float32 in both).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_tpu_torch.ops import batchnorm

SHAPE = (6, 5, 7, 4)  # NHWC: 6 rows, 5 x 7 positions, 4 channels


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.3, 1.7, SHAPE).astype(np.float32)
    r = rng.normal(0.0, 1.0, SHAPE).astype(np.float32)
    scale = (1.0 + 0.2 * rng.normal(size=SHAPE[-1])).astype(np.float32)
    bias = (0.1 * rng.normal(size=SHAPE[-1])).astype(np.float32)
    mean0 = rng.normal(size=SHAPE[-1]).astype(np.float32)
    var0 = np.abs(rng.normal(size=SHAPE[-1])).astype(np.float32)
    return x, r, scale, bias, mean0, var0


def _flax(x, r, scale, bias, mean0, var0, dtype):
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       dtype=dtype)
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}

    def f(xx, s, b):
        y, mut = bn.apply({"params": {"scale": s, "bias": b},
                           "batch_stats": stats}, xx,
                          mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * r), (y, mut)
    (_, (y, mut)), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                              has_aux=True)(
        jnp.asarray(x, dtype), jnp.asarray(scale), jnp.asarray(bias))
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(mut["batch_stats"]["mean"]),
            np.asarray(mut["batch_stats"]["var"]),
            *(np.asarray(g.astype(jnp.float32)) for g in grads))


def _port(x, r, scale, bias, mean0, var0, dtype):
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2)
    xt = nchw(x).to(dtype).requires_grad_(True)
    w = torch.from_numpy(scale).requires_grad_(True)
    b = torch.from_numpy(bias).requires_grad_(True)
    rm, rv = torch.from_numpy(mean0.copy()), torch.from_numpy(var0.copy())
    y = batchnorm.batch_norm_train(xt, w, b, rm, rv, 1e-5, 0.9)
    assert y.dtype == dtype
    (y.float() * nchw(r)).sum().backward()
    nhwc = lambda t: t.detach().float().permute(0, 2, 3, 1).numpy()
    return (nhwc(y), rm.numpy(), rv.numpy(), nhwc(xt.grad),
            w.grad.numpy(), b.grad.numpy())


def _ulps(got, want, slack: float) -> None:
    """|got - want| within two bf16 ulps of want plus `slack`."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= 2.0 * ulp + slack)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_mode_matches_flax(dtype):
    args = _inputs(seed=4)
    ref = _flax(*args, dtype=jnp.dtype(dtype))
    got = _port(*args, dtype=getattr(torch, dtype))
    y, rm, rv, gx, gs, gb = got
    ry, rrm, rrv, rgx, rgs, rgb = ref
    np.testing.assert_allclose(rm, rrm, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(rv, rrv, rtol=1e-6)
    if dtype == "float32":
        for a, b, tol in ((y, ry, 1e-5), (gx, rgx, 1e-4), (gs, rgs, 1e-4),
                          (gb, rgb, 1e-4)):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=tol * np.abs(b).max())
    else:
        _ulps(y, ry, 1e-3 * np.abs(ry).max())
        _ulps(gx, rgx, 1e-3 * np.abs(rgx).max())
        np.testing.assert_allclose(gs, rgs, rtol=2e-2)
        np.testing.assert_allclose(gb, rgb, rtol=2e-2)


def test_reduce_sees_the_moments_and_the_empty_batch():
    """`reduce` receives the float32 moments and the row count, its result
    normalizes; a batch without rows gives zero moments and still moves
    the running statistics (a data-parallel rank without rows)."""
    x, _, scale, bias, mean0, var0 = _inputs(seed=2)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    seen = []

    def reduce(mean, sq, rows):
        seen.append((mean.dtype, tuple(mean.shape), rows))
        return mean, sq
    rm, rv = torch.from_numpy(mean0.copy()), torch.from_numpy(var0.copy())
    got = batchnorm.batch_norm_train(xt, torch.from_numpy(scale),
                                     torch.from_numpy(bias), rm, rv, 1e-5,
                                     0.9, reduce)
    ref = batchnorm.batch_norm_train_plain(
        xt, torch.from_numpy(scale), torch.from_numpy(bias),
        torch.from_numpy(mean0.copy()), torch.from_numpy(var0.copy()), 1e-5,
        0.9)
    assert seen == [(torch.float32, (4,), 6)]
    assert torch.equal(got, ref)
    rm, rv = torch.from_numpy(mean0.copy()), torch.from_numpy(var0.copy())
    empty = batchnorm.batch_norm_train(xt[:0], torch.from_numpy(scale),
                                       torch.from_numpy(bias), rm, rv, 1e-5,
                                       0.9)
    assert empty.shape == (0, 4, 5, 7)
    np.testing.assert_allclose(rm.numpy(), 0.9 * mean0, rtol=1e-6)
