"""The port's Trainer against gat_tpu's (CPU, small widths): scheduler and
early stop, one step and three epochs from JAX's initial weights, the
flax-semantics BatchNorm, weights and optimizer state carried across in
both directions, and checkpoints that each package reads.

Tolerances, stated per test:
- one step, fp32: loss rtol 1e-6; clipped gradients rtol 1e-4 with atol
  1e-6 (the conv biases ahead of BatchNorm have a true gradient of zero,
  so both sides hold rounding noise of ~1e-8 there); BN running stats
  rtol 1e-5 (fp32 sums over the batch in another order; E[x²] − E[x]²
  loses the digits of E[x²]/var). Gradients, not parameters: Adam's first
  update is ≈ ±lr for every component whose gradient is well above eps,
  so rounding on a near-zero gradient flips a ±1e-3 step.
- one step, bf16 CNN: loss 2e-3, gradients atol 2e-3 (bf16's 8 bits),
  but for the conv biases ahead of BatchNorm, whose true gradient of 0
  shows as bf16 noise of up to 3e-3 on each side.
- three epochs, dropout 0: loss and accuracy histories 1e-5; the MLP's
  val losses and eval logits 1e-4. The CNN's eval logits 2e-2 and val
  losses rtol 5e-3: its conv biases (true gradient 0) take ±lr Adam steps of
  either sign on each side, which move the BN running means that the eval
  forward reads.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gat_tpu.models import CNN as JCNN, MLP as JMLP
from gat_tpu.models.baselines import SoftmaxRegression as JSoftmax
from gat_tpu.train import (ArrayDataLoader as JDL, ReduceLROnPlateau as JPlateau,
                           Trainer as JTrainer)
from gat_tpu.train.checkpoint import load_checkpoint as jload
from gat_tpu_torch.config import CHECKPOINTS_ROOT, TORCH_CHECKPOINTS_ROOT
from gat_tpu_torch.models import CNN, MLP, SoftmaxRegression
from gat_tpu_torch.models import cnn as tcnn, mlp as tmlp
from gat_tpu_torch.train import (ArrayDataLoader as TDL,
                                 ReduceLROnPlateau as TPlateau,
                                 Trainer as TTrainer)
from gat_tpu_torch.train import trainer as ttrainer
from gat_tpu_torch.train.checkpoint import load_checkpoint as tload

REPO = Path(__file__).resolve().parent.parent
SHIPPED = {"cnn": REPO / "data/checkpoints/cnn/cnn_v1.0.0.gtckpt.npz",
           "mlp": REPO / "data/checkpoints/mlp/mlp_synth_v1.0.0.gtckpt.npz"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(kind: str, n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 5, n)
    if kind == "mlp":
        X = rng.normal(size=(n, 65)).astype(np.float32) + 0.3 * y[:, None]
    else:
        X = (rng.normal(-40.0, 20.0, (n, 16, 12, 1)) + 3.0 * y[:, None, None,
                                                             None])
    return X.astype(np.float32), y


def _models(kind: str, bf16: bool = False):
    if kind == "mlp":
        return (JMLP(num_features=65, hidden_dim=16, num_classes=5,
                     dropout=0.0), MLP(65, 16, 2, 5, 0.0), tmlp)
    return (JCNN(num_classes=5, base_channels=4, num_blocks=2, hidden_dim=8,
                 dropout=0.0, dtype=jnp.bfloat16 if bf16 else jnp.float32),
            CNN(num_classes=5, base_channels=4, num_blocks=2, hidden_dim=8,
                dropout=0.0, dtype=torch.bfloat16 if bf16 else torch.float32),
            tcnn)


def _pair(kind: str, n: int = 70, n_val: int = 20, bf16: bool = False):
    """A JAX and a port Trainer on the same data, the port's weights set
    to JAX's initial ones."""
    X, y = _data(kind, n)
    jm, tm, codec = _models(kind, bf16)
    jt = JTrainer(jm, JDL(X, y, 8, seed=1),
                  JDL(X[:n_val], y[:n_val], 8, shuffle=False), seed=0)
    tt = TTrainer(tm, TDL(X, y, 8, seed=1),
                  TDL(X[:n_val], y[:n_val], 8, shuffle=False), seed=0,
                  device="cpu")
    tm.load_state_dict(codec.params_from_flax(_np(jt.variables)))
    return jt, tt, codec, X, y


# ---------------------------------------------------------------------------
# scheduler and early stop
# ---------------------------------------------------------------------------
VAL_LOSSES = [
    [1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.98, 0.89, 0.9, 0.91, 0.92, 0.93,
     0.94, 0.8],
    [2.0, 1.5, 1.2, 1.1, 1.05, 1.04, 1.039, 1.0389, 1.0388, 1.05, 1.06, 1.1,
     1.2, 1.3, 1.4, 1.5, 1.6],
    list(np.linspace(3.0, 0.5, 25)),
]


@pytest.mark.parametrize("seq", range(len(VAL_LOSSES)))
def test_plateau_lr_sequence_equal(seq):
    j, t = JPlateau(1e-3), TPlateau(1e-3)
    assert ([t.step(v) for v in VAL_LOSSES[seq]]
            == [j.step(v) for v in VAL_LOSSES[seq]])
    assert (t.best, t.num_bad) == (j.best, j.num_bad)


@pytest.mark.parametrize("seq", range(len(VAL_LOSSES)))
def test_early_stop_epoch_equal(seq):
    """Recorded val losses fed to both epoch loops: the same stop epoch,
    histories and LR in the optimizer."""
    losses = VAL_LOSSES[seq]
    jt, tt, *_ = _pair("mlp", n=24, n_val=8)
    it = iter(losses)
    jt.evaluate = lambda: (0.5, next(it))
    it_t = iter(losses)

    def fake_eval(dl):
        return (torch.tensor(next(it_t) * 8.0), torch.tensor(4), None, 8,
                None)
    tt._evaluate_device = fake_eval
    jt.train(epochs=len(losses), es_window_len=4, es_slope_limit=-0.00015,
             verbose=False)
    tt.train(epochs=len(losses), es_window_len=4, es_slope_limit=-0.00015,
             verbose=False)
    assert tt.epoch == jt.epoch
    assert tt.val_loss_history == pytest.approx(jt.val_loss_history,
                                                rel=1e-6)
    assert tt.scheduler.lr == jt.scheduler.lr
    assert tt.optimizer.param_groups[0]["lr"] == pytest.approx(
        float(jt.opt_state[1].hyperparams["learning_rate"]), rel=1e-7)


# ---------------------------------------------------------------------------
# one step and three epochs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,bf16", [("mlp", False), ("cnn", False),
                                       ("cnn", True)])
def test_one_step_matches_jax(kind, bf16):
    jt, tt, codec, X, y = _pair(kind, n=40, bf16=bf16)
    xb, yb = X[:8], y[:8]

    def loss_fn(p):
        logits, mut = jt._apply_train(p, jt.extra, jnp.asarray(xb),
                                      jax.random.PRNGKey(0))
        return jt._loss(logits, jnp.asarray(yb)), mut
    (loss, mut), grads = jax.value_and_grad(loss_fn, has_aux=True)(jt.params)
    clipped, _ = optax.clip_by_global_norm(1.0).update(grads,
                                                       optax.EmptyState())
    t_loss, _, t_norm = tt._step(torch.from_numpy(xb),
                                 torch.from_numpy(yb).long())
    ref = codec.params_from_flax({"params": _np(clipped)})
    tol = (dict(rtol=0, atol=2e-3) if bf16 else dict(rtol=1e-4, atol=1e-6))
    np.testing.assert_allclose(float(t_loss), float(loss),
                               **({"atol": 2e-3} if bf16 else {"rtol": 1e-6}))
    np.testing.assert_allclose(float(t_norm), float(optax.global_norm(grads)),
                               rtol=2e-3 if bf16 else 1e-5)
    for name, p in tt.model.named_parameters():
        if bf16 and name.startswith("conv_") and name.endswith(".bias"):
            continue  # true gradient 0: bf16 noise up to 3e-3 on each side
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   err_msg=name, **tol)
    if kind == "cnn":
        stats = codec.params_to_flax(tt.model.state_dict())["batch_stats"]
        for layer, s in _np(mut["batch_stats"]).items():
            for field in ("mean", "var"):
                np.testing.assert_allclose(
                    stats[layer][field], s[field],
                    rtol=5e-3 if bf16 else 1e-5, atol=1e-6,
                    err_msg=f"{layer}/{field}")


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_three_epochs_match_jax(kind):
    """70 examples in batches of 8 (a trailing batch of 6), shuffled by
    the loader's seeded rng: the same batches in the same order."""
    jt, tt, codec, X, _ = _pair(kind)
    jt.train(epochs=3, verbose=False)
    tt.train(epochs=3, verbose=False)
    np.testing.assert_allclose(tt.train_loss_history, jt.train_loss_history,
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tt.train_accuracy_history,
                               jt.train_accuracy_history, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tt.val_accuracy_history,
                               jt.val_accuracy_history, atol=1e-5, rtol=0)
    loose = kind == "cnn"
    np.testing.assert_allclose(tt.val_loss_history, jt.val_loss_history,
                               rtol=5e-3 if loose else 0,
                               atol=0 if loose else 1e-4)
    ref = np.asarray(jt._apply_eval(jt.params, jt.extra, jnp.asarray(X[:20])))
    got = tt._eval_logits(torch.from_numpy(X[:20])).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-2 if loose else 1e-4,
                               rtol=0)
    assert tt.epoch == jt.epoch == 3
    np.testing.assert_array_equal(tt.predict(X[:20]), jt.predict(X[:20]))


def test_trailing_batch_and_host_transfers(monkeypatch):
    """An epoch's numbers come to the host in one transfer, its
    validation numbers with them; a trailing partial batch is a step."""
    calls = []
    real = ttrainer._to_host
    monkeypatch.setattr(ttrainer, "_to_host",
                        lambda outs: calls.append(len(outs)) or real(outs))
    _, tt, *_ = _pair("mlp", n=70)
    steps = []
    step = tt._step
    tt._step = lambda xb, yb, *n: steps.append(len(yb)) or step(xb, yb, *n)
    tt.train(epochs=2, verbose=False)
    assert calls == [5, 5]
    assert steps == [8] * 8 + [6] + [8] * 8 + [6]


def test_loop_path_equals_resident_path():
    """Any iterable of batches trains as the device-resident path does."""
    class Plain:
        def __init__(self, dl):
            self.dl = dl

        def __len__(self):
            return len(self.dl)

        def __iter__(self):
            return iter(self.dl)
    _, a, *_ = _pair("mlp")
    _, b, *_ = _pair("mlp")
    b.train_dl = Plain(b.train_dl)
    a.train(epochs=2, verbose=False)
    b.train(epochs=2, verbose=False)
    np.testing.assert_allclose(a.train_loss_history, b.train_loss_history,
                               rtol=1e-6)
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        np.testing.assert_allclose(pa.detach(), pb.detach(), atol=1e-6)


def test_dropout_draws_from_the_trainer_generator():
    X, y = _data("mlp", 32)
    runs = []
    for _ in range(2):
        t = TTrainer(MLP(65, 16, 2, 5, 0.5), TDL(X, y, 8, seed=1), seed=3,
                     device="cpu")
        t.train(epochs=2, verbose=False)
        runs.append(t.train_loss_history)
    assert runs[0] == runs[1]
    t = TTrainer(MLP(65, 16, 2, 5, 0.5), TDL(X, y, 8, seed=1), seed=4,
                 device="cpu")
    t.train(epochs=2, verbose=False)
    assert t.train_loss_history != runs[0]


def test_kaiming_reinit():
    g = torch.Generator().manual_seed(0)
    m = CNN(base_channels=32, num_blocks=3, hidden_dim=256)
    ttrainer.kaiming_reinit(m, g)
    w = m.fc.weight.detach()
    assert abs(float(w.std()) - ttrainer._kaiming_std(2048)) < 2e-3
    assert all(float(m.get_submodule(n).bias.detach().abs().max()) == 0.0
               for n in ("conv_0", "bn_0", "fc", "out"))
    assert float(m.bn_1.weight.detach().min()) == 1.0


# ---------------------------------------------------------------------------
# layers and weights
# ---------------------------------------------------------------------------
def test_batchnorm_train_mode_is_flax():
    """(4, 3, 5, 2) NHWC batch: flax's output and running statistics
    (biased variance, momentum 0.9), which nn.BatchNorm2d's unbiased
    running variance would miss (0.98859 against 0.99009)."""
    import flax.linen as fnn
    x = np.random.default_rng(0).normal(size=(4, 3, 5, 2)).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), x)
    ref, mut = bn.apply(v, x, mutable=["batch_stats"])
    m = CNN(in_channels=2, base_channels=2, num_blocks=1)
    m.train()
    got = m._batch_norm("bn_0", torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(ref), atol=1e-6)
    np.testing.assert_allclose(m.bn_0.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-6)
    np.testing.assert_allclose(m.bn_0.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               atol=1e-7)


@pytest.mark.parametrize("family", ["mlp", "cnn"])
def test_params_to_flax_inverts_from_flax(family):
    v = tload(SHIPPED[family])["variables"]
    codec = tcnn if family == "cnn" else tmlp
    back = codec.params_to_flax(codec.params_from_flax(v))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(dict(v))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(dict(v))):
        np.testing.assert_array_equal(a, b)


def test_init_args_equal_flax():
    assert CNN().init_args == JCNN().init_args
    assert (CNN(num_classes=5, hidden_dim=0, adaptive_pool=(2, 3)).init_args
            == JCNN(num_classes=5, hidden_dim=0,
                    adaptive_pool=(2, 3)).init_args)
    assert MLP(65).init_args == JMLP(num_features=65).init_args
    assert (SoftmaxRegression(65, 47).init_args
            == JSoftmax(num_features=65, num_classes=47).init_args)


def test_softmax_regression_matches_flax():
    x = np.random.default_rng(1).normal(size=(6, 65)).astype(np.float32)
    jm = JSoftmax(num_features=65, num_classes=7)
    v = jm.init(jax.random.PRNGKey(0), x)
    m = SoftmaxRegression(65, 7)
    m.load_state_dict(tmlp.params_from_flax(_np(v)))
    with torch.no_grad():
        np.testing.assert_allclose(m(torch.from_numpy(x)).numpy(),
                                   np.asarray(jm.apply(v, x)), atol=1e-5)
    X, y = _data("mlp", 24)
    t = TTrainer(SoftmaxRegression(65, 5), TDL(X, y, 8), device="cpu")
    t.train(epochs=1, verbose=False)
    assert t.model_type == "softmaxregression"
    assert t._ckpt_defaults()[0] == TORCH_CHECKPOINTS_ROOT / t.model_type


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_optimizer_state_in_optax_layout(kind):
    """After the same three steps the port's saved optimizer leaves are
    JAX's: counts, hyperparameters, mu and nu in optax's order."""
    jt, tt, codec, X, y = _pair(kind, n=24)
    for i in range(3):
        xb, yb = X[8 * i:8 * i + 8], y[8 * i:8 * i + 8]
        jt.params, jt.extra, jt.opt_state, *_ = jt._train_step(
            jt.params, jt.extra, jt.opt_state, jnp.asarray(xb),
            jnp.asarray(yb), jax.random.PRNGKey(0))
        tt._step(torch.from_numpy(xb), torch.from_numpy(yb).long())
    got = tt._opt_state_tree()
    ref = jax.tree_util.tree_leaves(jt.opt_state)
    assert sorted(got) == [f"leaf_{i:04d}" for i in range(len(ref))]
    for i, r in enumerate(ref):
        g = got[f"leaf_{i:04d}"]
        assert g.shape == np.shape(r) and g.dtype == np.asarray(r).dtype
        if i < 8:
            np.testing.assert_allclose(g, np.asarray(r), rtol=1e-7)
        else:  # Adam moments of the same gradients
            np.testing.assert_allclose(g, np.asarray(r), rtol=1e-3,
                                       atol=1e-7)


@pytest.mark.parametrize("family,n_leaves", [("cnn", 40), ("mlp", 28)])
def test_port_loads_shipped_checkpoint_with_optimizer(family, n_leaves):
    ck = jload(SHIPPED[family])
    assert len(ck["opt_state"]) == n_leaves
    if family == "cnn":
        m, X = CNN(), np.zeros((2, 64, 22, 1), np.float32)
    else:
        m, X = MLP(65), np.zeros((2, 65), np.float32)
    t = TTrainer(m, TDL(X, np.arange(2)), device="cpu", model_type=family)
    t.load(root=SHIPPED[family].parent, filename=SHIPPED[family].name)
    assert t.epoch == ck["epoch"]
    # the shipped files predate the scheduler record: the LR is the one
    # their optimizer state carries
    lr = float(ck["opt_state"]["leaf_0005"])
    assert t.scheduler.lr == lr == t.optimizer.param_groups[0]["lr"]
    tree = t._opt_state_tree()
    for k, v in ck["opt_state"].items():
        np.testing.assert_array_equal(tree[k], v, err_msg=k)
    for a, b in zip(jax.tree_util.tree_leaves(t.variables),
                    jax.tree_util.tree_leaves(ck["variables"])):
        np.testing.assert_array_equal(a, b)


def test_port_checkpoint_resumes_in_jax(tmp_path, capsys):
    """A port checkpoint loads in JAX's Trainer, which warns (no
    fingerprint) and restores the optimizer by position; one more epoch
    in each package gives the same numbers."""
    jt, tt, codec, X, y = _pair("mlp")
    tt.train(epochs=1, verbose=False)
    path = tt.save(root=tmp_path, filename="m.gtckpt.npz")
    jt.load(root=tmp_path, filename=path.name)
    assert "no optimizer fingerprint" in capsys.readouterr().out
    assert jt.epoch == 1 and jt.scheduler.lr == tt.scheduler.lr
    # the loaders' shuffle streams at the same point
    jt.train_dl = JDL(X, y, 8, seed=1)
    tt.train_dl = TDL(X, y, 8, seed=1)
    jt.train(epochs=1, verbose=False)
    tt.train(epochs=1, verbose=False)
    np.testing.assert_allclose(tt.train_loss_history, jt.train_loss_history,
                               atol=1e-5)
    np.testing.assert_allclose(tt.val_loss_history, jt.val_loss_history,
                               atol=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(tt.variables),
                    jax.tree_util.tree_leaves(_np(jt.variables))):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_jax_checkpoint_resumes_in_port(tmp_path):
    jt, tt, codec, X, y = _pair("cnn")
    jt.train(epochs=1, verbose=False)
    path = jt.save(root=tmp_path, filename="c.gtckpt")
    tt.load(root=tmp_path, filename=path.name)
    assert tt.epoch == 1 and tt.val_loss_history == jt.val_loss_history
    for a, b in zip(jax.tree_util.tree_leaves(tt.variables),
                    jax.tree_util.tree_leaves(_np(jt.variables))):
        np.testing.assert_array_equal(a, b)
    assert int(tt.optimizer.state[tt._params[0]]["step"]) == 9


def test_round_trip_and_suffix(tmp_path):
    X, y = _data("cnn", 24)
    t = TTrainer(CNN(num_classes=5, base_channels=4, num_blocks=2,
                     hidden_dim=8), TDL(X, y, 8), TDL(X, y, 8, shuffle=False),
                 device="cpu", reverse_map={i: f"N{i}" for i in range(5)})
    t.train(epochs=2, verbose=False)
    path = t.save(root=tmp_path, filename="x.gtckpt")
    assert path.name == "x.gtckpt.npz" and path.is_file()
    ck = jload(path)
    assert ck["model_init_args"]["adaptive_pool"] == [4, 4]
    assert ck["config"]["model"]["params"]["USE_AMP"] is True
    assert "opt_state_fingerprint" not in ck
    u = TTrainer(CNN(num_classes=5, base_channels=4, num_blocks=2,
                     hidden_dim=8), TDL(X, y, 8), device="cpu", seed=9)
    u.load(root=tmp_path, filename=path.name)
    for a, b in zip(jax.tree_util.tree_leaves(u.variables),
                    jax.tree_util.tree_leaves(t.variables)):
        np.testing.assert_array_equal(a, b)
    for k, v in t._opt_state_tree().items():
        np.testing.assert_array_equal(u._opt_state_tree()[k], v)
    assert (u.scheduler.best, u.scheduler.num_bad, u.epoch) == (
        t.scheduler.best, t.scheduler.num_bad, 2)
    assert u.reverse_map is None  # reverse_map is the caller's, as in JAX


def test_load_refuses_mismatch_before_mutating(tmp_path):
    X, y = _data("mlp", 24)
    t = TTrainer(MLP(65, 16, 2, 5), TDL(X, y, 8), device="cpu")
    t.train(epochs=1, verbose=False)
    path = t.save(root=tmp_path, filename="m.npz")
    ck = np.load(path)
    payload = {k: ck[k] for k in ck.files if k != "opt_state/leaf_0027"}
    np.savez(tmp_path / "short.npz", **payload)
    other = TTrainer(MLP(65, 16, 2, 5), TDL(X, y, 8), device="cpu", seed=5)
    before = [p.detach().clone() for p in other.model.parameters()]
    with pytest.raises(ValueError, match="leaves"):
        other.load(root=tmp_path, filename="short.npz")
    wide = TTrainer(MLP(65, 32, 2, 5), TDL(X, y, 8), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        wide.load(root=tmp_path, filename="m.npz")
    assert all(torch.equal(a, b)
               for a, b in zip(before, other.model.parameters()))
    assert other.epoch == 0 and other.optimizer.state == {}


def test_checkpoint_defaults_under_torch_root():
    assert TORCH_CHECKPOINTS_ROOT == CHECKPOINTS_ROOT / "torch"
    X, y = _data("mlp", 16)
    for mtype, name in (("mlp", "mlp_synth_v1.0.0.gtckpt.npz"),
                        ("cnn", "cnn_v1.0.0.gtckpt.npz")):
        t = TTrainer(MLP(65, 16, 2, 5), TDL(X, y, 8), device="cpu",
                     model_type=mtype)
        assert t._ckpt_defaults() == (TORCH_CHECKPOINTS_ROOT / mtype, name)
