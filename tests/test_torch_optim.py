"""K12's plain version, through the port's optimizer
(`gat_tpu_torch/train/optim.py::ClipAdamW` on the CPU), against optax:
the JAX trainer's `optax.chain(clip_by_global_norm(1.0),
inject_hyperparams(adamw)(lr, wd))` over three steps, below and above the
clip threshold, with the learning rate changed after the first step as
the trainer's plateau scheduler changes it; and the data-parallel step's
`optax.adamw` (no clip). Inputs are made from a numpy seed and go
through both. Also the optimizer's flat buffers: each parameter's data
and gradient are views of them.

Tolerances: parameters, moments and the pre-clip norm within 1e-6
relative and 1e-9 absolute (float32 in both, the norm summed in another
order and b^count by another pow), the count exact.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gat_tpu_torch.train import optim

SHAPES = {"a": (5, 3), "b": (7,), "c": (2, 2, 3)}


def _tree(rng, scale: float) -> dict:
    return {k: rng.normal(0.0, scale, s).astype(np.float32)
            for k, s in SHAPES.items()}


def _torch_params(tree: dict) -> list:
    return [torch.nn.Parameter(torch.from_numpy(tree[k].copy()))
            for k in SHAPES]


def _close(got, want) -> None:
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize("g_scale", [0.05, 5.0])
def test_clip_adamw_matches_optax_chain(g_scale):
    """Three steps of the JAX trainer's chain: g_scale 0.05 stays below the
    global norm of 1.0, 5.0 is clipped every step; the learning rate goes
    from 1e-3 to 4e-4 after the first step."""
    rng = np.random.default_rng(int(g_scale * 100))
    params = _tree(rng, 1.0)
    grads = [_tree(rng, g_scale) for _ in range(3)]
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.inject_hyperparams(optax.adamw)(
                         learning_rate=1e-3, weight_decay=1e-4))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = _torch_params(params)
    opt = optim.ClipAdamW(tp, lr=1e-3, weight_decay=1e-4, max_norm=1.0)
    for step, g in enumerate(grads):
        if step == 1:
            opt.set_lr(4e-4)
            state[1].hyperparams["learning_rate"] = jnp.asarray(
                4e-4, jnp.float32)
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        norm = float(optax.global_norm(jg))
        assert (norm >= 1.0) == (g_scale > 1.0)
        updates, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        for p, k in zip(tp, SHAPES):
            p.grad.add_(torch.from_numpy(g[k]))
        got_norm = opt.step()
        _close(float(got_norm), norm)
        assert int(opt.count) == int(state[1].count) == step + 1
        inner = state[1].inner_state[0]
        for i, k in enumerate(SHAPES):
            _close(tp[i].detach().numpy(), jp[k])
            _close(opt.views(opt.mu)[i].numpy(), inner.mu[k])
            _close(opt.views(opt.nu)[i].numpy(), inner.nu[k])


def test_adamw_without_clip_matches_optax_adamw():
    """The data-parallel step's factory (`parallel.sharded.adamw`) is
    optax.adamw(1e-3): no clip, even far above a norm of 1."""
    from gat_tpu_torch.parallel.sharded import adamw
    rng = np.random.default_rng(7)
    params = _tree(rng, 1.0)
    tx = optax.adamw(1e-3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = _torch_params(params)
    opt = adamw(1e-3)(tp)
    for _ in range(3):
        g = _tree(rng, 5.0)
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.zero_grad()
        for p, k in zip(tp, SHAPES):
            p.grad.add_(torch.from_numpy(g[k]))
        opt.step()
    for i, k in enumerate(SHAPES):
        _close(tp[i].detach().numpy(), jp[k])


def test_flat_buffers_are_the_parameters_and_gradients():
    """Each parameter's data and gradient are views of the optimizer's flat
    buffers (autograd accumulates into them; zero_grad zeroes them in
    place); torch.optim's read-only views of the state are empty before
    the first step; parameters that are not float32 are refused."""
    lin = torch.nn.Linear(3, 2)
    w0 = lin.weight.detach().clone()
    opt = optim.ClipAdamW(lin.parameters(), lr=1e-2, max_norm=1.0)
    assert torch.equal(lin.weight.detach(), w0)
    assert opt.state == {} and opt.param_groups[0]["lr"] == 1e-2
    lin(torch.ones(4, 3)).sum().backward()
    flat = opt.flat_grad
    assert lin.weight.grad.data_ptr() == flat.data_ptr()
    assert torch.equal(flat[:6].view(2, 3), lin.weight.grad)
    assert float(flat.abs().sum()) > 0
    before = lin.weight.detach().clone()
    opt.step()
    assert not torch.equal(lin.weight.detach(), before)
    assert int(opt.state[lin.weight]["step"]) == 1
    opt.zero_grad()
    assert float(flat.abs().sum()) == 0 and lin.weight.grad is not None
    with pytest.raises(ValueError):
        optim.ClipAdamW([torch.nn.Parameter(torch.zeros(2,
                                                        dtype=torch.float64))])
