"""K11's plain version, `gat_tpu_torch/ops/loss.py::softmax_xent_plain`,
against the JAX trainer's `_loss` (optax.smooth_labels +
softmax_cross_entropy, the mean) and `jnp.argmax`, on inputs made from a
numpy seed: the loss at the three scales the port uses, its gradient
against jax.grad, the correct count and the argmaxes with ties among the
logits and a row whose label is the argmax. The kernel itself is held to
this plain version under the emulation (`test_torch_kernels_emulated_train.py`)
and on the card (`test_torch_cuda.py`).

Tolerances: the loss within 1e-6 relative and its gradient within 1e-6 of
its largest value (float32, log_softmax by another formula and sums in
another order); the count and the argmaxes exact.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_tpu.train import Trainer as JTrainer
from gat_tpu_torch.ops import loss as loss_mod

SMOOTHING = 0.05


def _inputs(b: int, c: int, seed: int):
    """(logits, labels) as numpy: row 0 ties its maximum at classes 1 and
    c - 1, row 1's label is its argmax, row 2 ties three classes at the
    maximum with the label on the second of them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 3.0, (b, c)).astype(np.float32)
    y = rng.integers(0, c, b)
    x[0, [1, c - 1]] = x[0].max() + 0.5
    y[1] = int(np.argmax(x[1]))
    x[2, [0, 4, 9]] = x[2].max() + 1.0
    y[2] = 4
    return x, y.astype(np.int64)


def _jax_loss(logits, labels):
    """The JAX trainer's `_loss` (a mean over the rows)."""
    return JTrainer._loss(SimpleNamespace(label_smoothing=SMOOTHING),
                          logits, labels)


@pytest.mark.parametrize("b, c", [(32, 47), (8, 10), (100, 47)])
def test_loss_and_gradient_match_jax(b, c):
    """The mean (scale 1/B), the eval's sum (scale 1) and a data-parallel
    rank's share of a global batch of 2B (scale 1/(2B)), each with its
    gradient against jax.grad of the same scaling of `_loss`."""
    x, y = _inputs(b, c, seed=b + c)
    ref = float(_jax_loss(jnp.asarray(x), jnp.asarray(y)))
    jgrad = np.asarray(jax.grad(_jax_loss)(jnp.asarray(x), jnp.asarray(y)))
    for scale, factor in ((1.0 / b, 1.0), (1.0, b), (1.0 / (2 * b), 0.5)):
        t = torch.from_numpy(x).requires_grad_(True)
        got, _ = loss_mod.softmax_xent_plain(t, torch.from_numpy(y),
                                             SMOOTHING, scale)
        got.backward()
        np.testing.assert_allclose(float(got.detach()), ref * factor,
                                   rtol=1e-6)
        np.testing.assert_allclose(t.grad.numpy(), jgrad * factor, rtol=0,
                                   atol=1e-6 * np.abs(jgrad * factor).max())


def test_correct_count_and_argmax_match_jax():
    """The first of equal maxima, as jnp.argmax takes it."""
    x, y = _inputs(16, 47, seed=3)
    _, correct, preds = loss_mod.softmax_xent_plain(
        torch.from_numpy(x), torch.from_numpy(y), SMOOTHING, preds=True)
    jpred = np.asarray(jnp.argmax(jnp.asarray(x), axis=-1))
    np.testing.assert_array_equal(preds.numpy(), jpred)
    assert int(preds[0]) == 1 and int(preds[2]) == 0
    assert int(correct) == int(np.sum(jpred == y))
    assert int(correct) >= 1  # row 1


def test_label_outside_the_classes_has_no_one_hot():
    """A label outside [0, C) smooths to alpha / C everywhere, as
    jax.nn.one_hot gives it no one."""
    x, y = _inputs(4, 10, seed=9)
    y[3] = 10
    got, _ = loss_mod.softmax_xent_plain(torch.from_numpy(x),
                                         torch.from_numpy(y), SMOOTHING,
                                         1.0 / 4)
    ref = float(_jax_loss(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(float(got), ref, rtol=1e-6)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    """A CPU tensor goes to the plain version and launches nothing; shapes
    that do not fit are refused."""
    x, y = _inputs(8, 47, seed=1)
    before = loss_mod.softmax_xent.launches
    got = loss_mod.softmax_xent(torch.from_numpy(x), torch.from_numpy(y),
                                SMOOTHING, 0.125, preds=True)
    ref = loss_mod.softmax_xent_plain(torch.from_numpy(x),
                                      torch.from_numpy(y), SMOOTHING, 0.125,
                                      preds=True)
    assert loss_mod.softmax_xent.launches == before
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        loss_mod.softmax_xent(torch.zeros(4, 3), torch.zeros(5).long(),
                              SMOOTHING)
