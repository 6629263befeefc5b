"""Trainer for the MLP and CNN classifiers, the twin of
`gat_tpu/train/trainer.py`, with the same recipe:

  * a step is forward + cross entropy with label smoothing 0.05 +
    backward + clip by global norm 1.0 (optax's rule: scale by
    max_norm / norm only when the norm reaches max_norm) + AdamW (lr
    1e-3, wd 1e-4, betas (0.9, 0.999), eps 1e-8, the decay on every
    parameter, as optax's unmasked adamw);
  * on the card the loss, its gradient and the correct count are one
    launch of K11 (`ops/loss.py`) and the clip and AdamW two of K12
    (`train/optim.py::ClipAdamW`, flat buffers behind the parameters and
    their gradients, the LR and step count on the device);
  * ReduceLROnPlateau(factor 0.5, patience 3, rel threshold 1e-4), the
    JAX package's class, its LR written into the optimizer's device
    scalar;
  * slope early stop: np.polyfit over the last `es_window_len` val
    losses once past 1.5x the window, checked before the epoch's metrics
    are appended;
  * Kaiming-normal(a=0.01, fan_in = prod(shape[1:])) weights, zero
    biases;
  * dropout masks from a torch.Generator on the trainer's device, seeded
    from `seed` (they differ from JAX's masks by design);
  * the CNN's bf16 compute through its `dtype`.

An epoch keeps what the JAX package's scanned epoch buys without a scan:
X and y go to the device once per `train()` call, each batch is gathered
there from the loader's permutation, the trailing partial batch runs as
its own step, and the loss, correct count and grad norm accumulate on the
device, so the epoch's training and validation numbers come to the host
in one transfer.

Checkpoints are the JAX package's schema, read by both packages: flax
variables, and the optimizer state as optax's leaves in optax's order
(outer count, the six injected hyperparameters, inner count, mu, nu in
sorted flax keypath order and flax layout). The port writes no optimizer
fingerprint (it hashes a JAX treedef), so JAX's `Trainer.load` restores
a port checkpoint by position; the port checks leaf count and shapes.
"""
from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np
import torch

from ..config import (CLIP_DURATION, CNN_CONFIG, CONFIG_VERSION,
                      MELSPEC_CONFIG, MFCC_CONFIG, MLP_CONFIG, TARGET_SR,
                      TORCH_CHECKPOINTS_ROOT, config_dict)
from ..models import cnn as cnn_mod, mlp as mlp_mod
from ..ops.loss import softmax_xent
from ..utils.device import (fp32_reference_math, resolve_device,
                            to_host as _to_host)
from .checkpoint import (flatten_tree, load_checkpoint, save_checkpoint,
                         unflatten_tree)
from .data import ArrayDataLoader
from .metrics import classification_report, confusion_matrix, plot_curves
from .optim import ClipAdamW

__all__ = ["ReduceLROnPlateau", "Trainer", "kaiming_reinit"]

# optax's adamw state after the outer count: the injected hyperparameters
# in sorted order, then the inner count
_HYPERPARAMS = ("b1", "b2", "eps", "eps_root", "learning_rate",
                "weight_decay")
_OPT_HEAD = 2 + len(_HYPERPARAMS)


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau semantics (mode='min',
    threshold_mode='rel'), without its eps rule and cooldown, as the JAX
    package's class."""

    def __init__(self, init_lr: float, factor: float = 0.5,
                 patience: int = 3, threshold: float = 1e-4,
                 min_lr: float = 0.0):
        self.lr = float(init_lr)
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad = 0
        return self.lr


def _kaiming_std(fan_in: int, a: float = 0.01) -> float:
    return float(np.sqrt(2.0 / (1.0 + a * a)) / np.sqrt(fan_in))


@torch.no_grad()
def kaiming_reinit(model: torch.nn.Module,
                   generator: torch.Generator) -> None:
    """Kaiming-normal(a=0.01, fan_in) on every weight of rank ≥ 2, zeros
    on biases, drawn on the host from `generator` (the same weights on
    any device); norm scales keep their ones."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and p.ndim >= 2:
            fan_in = math.prod(p.shape[1:])
            p.copy_(torch.randn(tuple(p.shape), generator=generator)
                    * _kaiming_std(fan_in))
        elif leaf == "bias":
            p.zero_()


def _optax_order(flat: dict) -> list[str]:
    """The '/'-joined keypaths of a flattened flax tree in JAX's
    flattening order (keys sorted at every level)."""
    return sorted(flat, key=lambda k: k.split("/"))


class Trainer:
    """Unified MLP/CNN trainer on one device (default the card; 'cpu'
    runs there), or data-parallel over a mesh's `data` axis."""

    # whole-set eval granularity (examples per forward on the fast path);
    # class attributes so tests can shrink them
    _EVAL_CHUNK = 65536
    # largest val set kept on the device across the per-epoch evaluate
    # calls (float32 feature bytes); larger sets upload a slice per chunk
    _EVAL_RESIDENT_BYTES = 1 << 29  # 512 MB

    def __init__(self, model, train_dl, val_dl=None, reverse_map=None,
                 lr: float = 1e-3, weight_decay: float = 1e-4,
                 scaler=None, seed: int = 0, label_smoothing: float = 0.05,
                 max_clip_norm: float = 1.0, model_type: str | None = None,
                 mesh=None, device=None):
        """`mesh` (a DeviceMesh from `parallel.make_mesh`, every rank
        making the same call) runs every training and evaluation step
        data-parallel over its `data` axis: each rank holds the data and
        the model replicated, computes its rows of every global batch, and
        the gradients, loss and correct counts are summed over `data`
        (`parallel/sharded.py::data_parallel_backward`), so the histories
        and weights are the single-device run's up to summation order
        (the same batches, dropout masks and BatchNorm statistics). The
        device is then the rank's; only rank 0 writes checkpoints."""
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.mesh import mesh_device
            device = mesh_device(mesh) if device is None else device
        self.device = resolve_device(device)
        fp32_reference_math()
        self.model = model
        self.model_type = model_type or type(model).__name__.lower()
        self.train_dl = train_dl
        self.val_dl = val_dl
        self.scaler = scaler
        self.label_smoothing = label_smoothing
        self.max_clip_norm = float(max_clip_norm)

        self.reverse_map = reverse_map
        self.class_names = ([str(reverse_map[k])
                             for k in sorted(reverse_map)]
                            if reverse_map else [])
        self.num_classes = (len(self.class_names)
                            or model.init_args["num_classes"])

        self._check_dims(train_dl)
        if val_dl is not None:
            self._check_dims(val_dl)
        # the JAX trainer draws one more batch here to build its
        # variables; so does this one, so that the loader's shuffle
        # stream, and with it every epoch's batch order, stays the same
        next(iter(train_dl))

        self._codec = cnn_mod if isinstance(model, cnn_mod.CNN) else mlp_mod
        kaiming_reinit(model, torch.Generator().manual_seed(seed))
        model.to(self.device)
        if mesh is not None:
            from ..parallel.mesh import replicated
            replicated(model, mesh)
        self._dropout_gen = torch.Generator(self.device).manual_seed(seed)
        for m in model.modules():
            if isinstance(m, mlp_mod.Dropout):
                m.generator = self._dropout_gen
        self._names = [n for n, _ in model.named_parameters()]
        self._params = [p for _, p in model.named_parameters()]
        self.optimizer = ClipAdamW(self._params, lr=lr, betas=(0.9, 0.999),
                                   eps=1e-8, weight_decay=weight_decay,
                                   max_norm=self.max_clip_norm)
        self.scheduler = ReduceLROnPlateau(lr)

        self.train_loss_history: list[float] = []
        self.train_accuracy_history: list[float] = []
        self.val_loss_history: list[float] = []
        self.val_accuracy_history: list[float] = []
        self.epoch = 0
        self.last_grad_norm = 0.0
        # single-entry device copies of (dl.X, dl.y), keyed by the
        # identity of (loader, X, y) held by strong reference: one for
        # the training set, one for the val set
        self._dev_data: tuple | None = None
        self._val_data: tuple | None = None
        # True only inside train()'s epoch loop: gates _val_data reuse
        self._in_train = False

    # ------------------------------------------------------------------
    def _check_dims(self, dl):
        """Input/feature-dim guards."""
        if len(dl) == 0:
            raise ValueError("[_check_dims] Provided DataLoader is empty.")
        xb, _ = next(iter(dl))
        if hasattr(self.model, "num_features"):  # vector models (MLP, …)
            if xb.shape[1] != self.model.num_features:
                raise ValueError(
                    f"[_check_dims] Input feature dimension mismatch: "
                    f"DataLoader provides {xb.shape[1]}, but model expects "
                    f"{self.model.num_features}")
        elif xb.ndim != 4:
            raise ValueError(
                f"[_check_dims] CNN expects rank-4 input, got {xb.ndim}-D")

    def _upload(self, a, dtype=torch.float32) -> torch.Tensor:
        """A host array on the trainer's device, as its own copy (the
        loaders' arrays may be read-only)."""
        return torch.as_tensor(np.array(a)).to(self.device, dtype)

    def _dev_cached(self, attr: str, dl):
        """Identity-keyed device copy of (dl.X, dl.y), cached on
        `self.<attr>`; blind to in-place mutation, so train() clears both
        slots per call and a direct evaluate() clears its own."""
        c = getattr(self, attr)
        if not (c and c[0] is dl and c[1] is dl.X and c[2] is dl.y):
            setattr(self, attr, (dl, dl.X, dl.y, self._upload(dl.X),
                                 self._upload(dl.y, torch.int64)))
            c = getattr(self, attr)
        return c[3], c[4]

    def _rows(self, n: int) -> tuple[int, int]:
        """[start, stop) of this rank's rows of a global batch of n (all
        of them without a mesh)."""
        if self.mesh is None:
            return 0, n
        from ..parallel.mesh import row_range
        return row_range(n, self.mesh)

    def _step(self, xb: torch.Tensor, yb: torch.Tensor, n: int | None = None):
        """One optimizer step on a device batch: (mean loss, correct
        count, pre-clip grad norm), all device scalars (the norm is the
        optimizer's, overwritten by the next step). Under a mesh, xb and yb
        are this rank's rows (`_rows`) of a global batch of n."""
        if self.mesh is not None:
            from ..parallel.sharded import data_parallel_backward
            loss_sum, correct = data_parallel_backward(
                self.model, self.optimizer, xb, yb, n, self._rows(n)[0],
                self.mesh, self.label_smoothing)
            return loss_sum / n, correct, self.optimizer.step()
        self.model.train()
        logits = self.model(xb)
        # K11: the mean loss, the correct count and the logits' gradient
        loss, correct = softmax_xent(logits, yb, self.label_smoothing,
                                     1.0 / len(yb))
        self.optimizer.zero_grad()
        loss.backward()
        # K12: the pre-clip norm, the clip and the AdamW update
        return loss.detach(), correct, self.optimizer.step()

    def _perm_on_device(self, idx: np.ndarray) -> torch.Tensor:
        """The epoch's permutation on the device, copied from pinned
        memory without a wait; the pinned buffer is kept until the next
        epoch's copy replaces it."""
        host = torch.from_numpy(idx)
        if self.device.type != "cuda":
            return host
        self._perm_host = host.pin_memory()
        return self._perm_host.to(self.device, non_blocking=True)

    def _run_epoch_resident(self, train_dl):
        """One epoch over device-resident X, y: the loader's permutation
        (same rng stream as its iteration), batches gathered on the
        device, the trailing partial batch as its own step. Returns
        (loss_sum, correct, total) with the first two device tensors."""
        X_dev, Y_dev = self._dev_cached("_dev_data", train_dl)
        idx = np.arange(len(train_dl.X))
        if train_dl.shuffle:
            train_dl._rng.shuffle(idx)
        bs = train_dl.batch_size
        end = (len(idx) // bs * bs if train_dl.drop_last else len(idx))
        perm = self._perm_on_device(idx)
        loss_sum = torch.zeros((), device=self.device)
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        for i in range(0, end, bs):
            jdx = perm[i:min(i + bs, end)]
            n = len(jdx)
            lo, hi = self._rows(n)
            jdx = jdx[lo:hi]
            loss, corr, self._gnorm = self._step(
                X_dev.index_select(0, jdx), Y_dev.index_select(0, jdx), n)
            loss_sum += loss * n
            correct += corr
        return loss_sum, correct, end

    def _run_epoch_loop(self, train_dl):
        """One epoch over any iterable of host (X, y) batches."""
        loss_sum = torch.zeros((), device=self.device)
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        total = 0
        for xb, yb in train_dl:
            lo, hi = self._rows(len(yb))
            loss, corr, self._gnorm = self._step(
                self._upload(xb[lo:hi]), self._upload(yb[lo:hi], torch.int64),
                len(yb))
            loss_sum += loss * len(yb)
            correct += corr
            total += len(yb)
        return loss_sum, correct, total

    def train(self, epochs: int = 20, train_dl=None, es_window_len: int = 4,
              es_slope_limit: float = 1e-5, plot_metrics: bool = False,
              verbose: bool = True, scan_epoch: bool = True):
        """Epoch loop with per-epoch validation, plateau LR and slope
        early stop. With `scan_epoch` a plain ArrayDataLoader trains from
        device-resident X, y; `scan_epoch=False`, or any other iterable
        of batches, uploads the loader's batches one by one (the same
        math)."""
        # `is None`, not truthiness: a zero-length drop_last loader is
        # falsy via __len__
        train_dl = self.train_dl if train_dl is None else train_dl
        if train_dl is None:
            print("[train] No train dataloader provided. Exiting [train].")
            return
        self._check_dims(train_dl)
        if verbose:
            print("[train] Training start.")
        t0 = time.time()
        self.last_grad_norm = 0.0
        self._gnorm = torch.zeros((), device=self.device)
        # device copies are reused across THIS call's epochs only: a
        # caller may mutate X/y in place between train() calls
        self._dev_data = None
        self._val_data = None
        resident = scan_epoch and type(train_dl) is ArrayDataLoader
        self._in_train = True
        try:
            self._train_epochs(epochs, train_dl, resident, es_window_len,
                               es_slope_limit, verbose)
        finally:
            self._in_train = False

        if plot_metrics:
            plot_curves({"Accuracy": self.train_accuracy_history,
                         "Loss": self.train_loss_history},
                        title="Training Curves")
            plot_curves({"Accuracy": self.val_accuracy_history,
                         "Loss": self.val_loss_history},
                        title="Validation Curves")
        if verbose:
            print(f"\n[train] Training complete. "
                  f"({time.time() - t0:.1f}s)\n")

    def _train_epochs(self, epochs, train_dl, resident, es_window_len,
                      es_slope_limit, verbose):
        for ep in range(1, epochs + 1):
            if verbose:
                print(f"[train] EPOCH {ep}/{epochs}")
            loss_sum, correct, total = (
                self._run_epoch_resident(train_dl) if resident
                else self._run_epoch_loop(train_dl))
            val = self._evaluate_device(self.val_dl)
            # the epoch's one transfer: its training numbers and the
            # validation numbers together
            host = _to_host((loss_sum, correct, self._gnorm)
                            + (val[:2] if val else ()))
            self.last_grad_norm = float(host[2])
            epoch_loss = float(host[0]) / total if total else 0.0
            epoch_acc = int(host[1]) / total if total else 0.0
            self.train_loss_history.append(epoch_loss)
            self.train_accuracy_history.append(epoch_acc)
            self.epoch += 1
            if val is None:
                continue
            n_val = val[3]
            val_loss = float(host[3]) / n_val if n_val else 0.0
            val_acc = int(host[4]) / n_val if n_val else 0.0
            self._set_lr(self.scheduler.step(val_loss))

            # early-stop check precedes appending this epoch's metrics
            if ep > int(es_window_len * 1.5):
                last_losses = self.val_loss_history[-es_window_len:]
                if len(last_losses) >= 2:
                    slope, _ = np.polyfit(np.arange(len(last_losses)),
                                          last_losses, 1)
                    if verbose:
                        print(f"[train] early stop slope value: "
                              f"{slope:.4f}, over last {es_window_len} "
                              f"epochs")
                    if slope >= es_slope_limit:
                        if verbose:
                            print("[train] early stop triggered: loss no "
                                  "longer decreasing")
                        break

            self.val_accuracy_history.append(val_acc)
            self.val_loss_history.append(val_loss)
            if verbose:
                print(f"[train] train loss: {epoch_loss:.4f} | "
                      f"train accuracy: {epoch_acc:.4f} | "
                      f"val loss: {val_loss:.4f} | "
                      f"val accuracy: {val_acc:.4f}")

    def _set_lr(self, lr: float) -> None:
        self.optimizer.set_lr(lr)

    @torch.no_grad()
    def _eval_logits(self, xb: torch.Tensor) -> torch.Tensor:
        self.model.eval()
        return self.model(xb)

    @torch.no_grad()
    def _evaluate_device(self, dl):
        """(loss_sum, correct, preds, total, y) over `dl`, the first three
        device tensors, or None without a loader. A plain ArrayDataLoader
        that neither shuffles nor drops goes in chunks of _EVAL_CHUNK;
        others batch by batch."""
        if dl is None:
            return None
        loss_sum = torch.zeros((), device=self.device)
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        preds, ys, chunks = [], [], []
        total = 0
        if (type(dl) is ArrayDataLoader and not dl.shuffle
                and not dl.drop_last):
            n = len(dl.y)
            resident = (np.asarray(dl.X).nbytes
                        <= self._EVAL_RESIDENT_BYTES)
            if resident:
                if not self._in_train:
                    # a direct evaluate() must never read a stale copy of
                    # an array mutated in place
                    self._val_data = None
                X_dev, Y_dev = self._dev_cached("_val_data", dl)
            for i in range(0, n, self._EVAL_CHUNK):
                if resident:
                    xc = X_dev[i:i + self._EVAL_CHUNK]
                    yc = Y_dev[i:i + self._EVAL_CHUNK]
                else:
                    xc = self._upload(dl.X[i:i + self._EVAL_CHUNK])
                    yc = self._upload(dl.y[i:i + self._EVAL_CHUNK],
                                      torch.int64)
                chunks.append((xc, yc, dl.y[i:i + self._EVAL_CHUNK]))
        else:
            chunks = ((self._upload(xb), self._upload(yb, torch.int64),
                       np.asarray(yb)) for xb, yb in dl)
        for xb, yb, y_host in chunks:
            n = len(yb)
            lo, hi = self._rows(n)
            logits = self._eval_logits(xb[lo:hi])
            if hi > lo:  # under a mesh a rank may hold no row of it
                # K11: the loss sum, the correct count and the argmaxes
                part, corr, p = softmax_xent(logits, yb[lo:hi],
                                             self.label_smoothing, 1.0,
                                             preds=True)
                loss_sum += part
                correct += corr
            else:
                p = logits.argmax(dim=-1)
            if self.mesh is not None:
                from ..parallel.mesh import gather_batch
                p = gather_batch(p, n, self.mesh)
            preds.append(p)
            ys.append(y_host)
            total += n
        if self.mesh is not None:
            import torch.distributed as dist
            from ..parallel.mesh import axis_group
            sums = torch.stack([loss_sum, correct.float()])
            dist.all_reduce(sums, group=axis_group(self.mesh))
            loss_sum, correct = sums[0], sums[1].round().to(torch.int64)
        preds = (torch.cat(preds) if preds
                 else torch.zeros(0, dtype=torch.int64, device=self.device))
        y = np.concatenate(ys) if ys else np.zeros(0, np.int64)
        return loss_sum, correct, preds, total, y

    def evaluate(self, val_dl=None, cm: bool = False, report: bool = False,
                 plot_metrics: bool = False):
        """Weighted val loss + accuracy; optional confusion matrix /
        classification report. One transfer from the device."""
        # `is None`, not truthiness: an explicit zero-length drop_last
        # loader must not be swapped for the default loader
        dl = self.val_dl if val_dl is None else val_dl
        if dl is None:
            print("[evaluate] No val dataloader provided.")
            return None, None
        loss_sum, correct, preds, total, y_all = self._evaluate_device(dl)
        loss_sum, correct, preds = _to_host((loss_sum, correct, preds))
        acc = int(correct) / total if total else 0.0
        avg_loss = float(loss_sum) / total if total else 0.0
        if cm:
            print(confusion_matrix(y_all, preds, self.num_classes))
        if report:
            print(classification_report(y_all, preds, self.class_names))
        return acc, avg_loss

    def predict(self, xb) -> np.ndarray:
        logits = self._eval_logits(self._upload(xb))
        return logits.argmax(dim=-1).cpu().numpy()

    # ------------------------------------------------------------------
    @property
    def variables(self) -> dict:
        """The model's weights as flax variables (numpy trees)."""
        return self._codec.params_to_flax(self.model.state_dict())

    def _default_cfg(self):
        if self.model_type in ("mlp", "logreg", "softmaxregression"):
            return ("mfcc", config_dict(MFCC_CONFIG),
                    config_dict(MLP_CONFIG))
        return ("melspec", config_dict(MELSPEC_CONFIG),
                config_dict(CNN_CONFIG))

    def _ckpt_defaults(self):
        """Default checkpoint dir + filename per model family. Unlike the
        JAX trainer, whose defaults are the shipped files under
        data/checkpoints/{mlp,cnn}/, the port writes under its own root,
        data/checkpoints/torch/<family>/, with the same file names."""
        if self.model_type == "mlp":
            return (TORCH_CHECKPOINTS_ROOT / "mlp",
                    MLP_CONFIG.DEFAULT_CKPT_NAME)
        if self.model_type == "cnn":
            return (TORCH_CHECKPOINTS_ROOT / "cnn",
                    CNN_CONFIG.DEFAULT_CKPT_NAME)
        return (TORCH_CHECKPOINTS_ROOT / self.model_type,
                f"{self.model_type}_v{CONFIG_VERSION}.gtckpt.npz")

    def _moments_tree(self, key: str) -> dict:
        """One Adam moment ("mu" or "nu") of every parameter (zeros before
        the first step) as a flax params tree."""
        flat = getattr(self.optimizer, key)
        sd = dict(zip(self._names, self.optimizer.views(flat)))
        return self._codec.params_to_flax(sd)["params"]

    def _opt_state_tree(self) -> dict:
        """The optimizer state as optax's adamw leaves, in its order."""
        opt = self.optimizer
        count = np.int32(int(opt.count))
        hyper = {"b1": opt.b1, "b2": opt.b2, "eps": opt.eps, "eps_root": 0.0,
                 "learning_rate": opt.lr_value,
                 "weight_decay": opt.weight_decay}
        mu, nu = (flatten_tree(self._moments_tree(k)) for k in ("mu", "nu"))
        order = _optax_order(mu)
        leaves = ([count] + [np.float32(hyper[k]) for k in _HYPERPARAMS]
                  + [count] + [mu[k] for k in order]
                  + [nu[k] for k in order])
        return {f"leaf_{i:04d}": np.asarray(l) for i, l in enumerate(leaves)}

    def save(self, filename=None, root=None, target_sr: int = TARGET_SR,
             clip_length: float = CLIP_DURATION, include_opt: bool = True):
        """Self-describing checkpoint in the JAX package's schema."""
        feat_type, feat_params, model_params = self._default_cfg()
        d_root, d_name = self._ckpt_defaults()
        root = Path(root) if root else d_root
        filename = filename or d_name
        ckpt = {
            "meta": {"config_version": CONFIG_VERSION,
                     "datetime": time.strftime("%d/%m/%Y %H:%M:%S"),
                     "model_type": self.model_type},
            "config": {
                "features": {"type": feat_type, "params": feat_params},
                "model": {"type": self.model_type, "params": model_params},
                "target_sr": target_sr,
                "clip_length": clip_length,
            },
            "variables": self.variables,
            "model_init_args": dict(self.model.init_args),
            "train_loss_history": self.train_loss_history,
            "train_accuracy_history": self.train_accuracy_history,
            "val_loss_history": self.val_loss_history,
            "val_accuracy_history": self.val_accuracy_history,
            "epoch": self.epoch,
            "reverse_map": self.reverse_map,
            "num_classes": self.num_classes,
            "class_names": self.class_names,
        }
        if self.scaler is not None:
            if hasattr(self.scaler, "to_dict"):
                ckpt["scaler"] = self.scaler.to_dict()
            elif hasattr(self.scaler, "mean_"):
                # an sklearn-style scaler becomes the schema's two arrays
                # now: pickled into the npz it could never be read back
                from ..utils.scaler import FeatureScaler
                ckpt["scaler"] = FeatureScaler.from_sklearn(
                    self.scaler).to_dict()
            else:
                raise TypeError(
                    "[save] scaler must be a FeatureScaler (or expose "
                    "sklearn's mean_/scale_): a foreign object would be "
                    f"pickled unreadably. Got {type(self.scaler)!r}.")
        if include_opt:
            ckpt["opt_state"] = self._opt_state_tree()
            ckpt["scheduler"] = {"lr": self.scheduler.lr,
                                 "best": self.scheduler.best,
                                 "num_bad": self.scheduler.num_bad}
        if self.mesh is None:
            return save_checkpoint(root / filename, ckpt)
        # every rank holds the same weights: rank 0 writes, the others
        # wait until the file is there
        import torch.distributed as dist
        path = (save_checkpoint(root / filename, ckpt)
                if dist.get_rank() == 0 else None)
        box = [str(path) if path is not None else None]
        dist.broadcast_object_list(box, src=0)
        return Path(box[0])

    def _restored_moments(self, opt_tree: dict) -> tuple:
        """(count, lr, mu, nu) from optax leaves, mu and nu as torch
        tensors by parameter name; raises on a leaf count or shape that
        does not fit this model."""
        leaves = [opt_tree[k] for k in sorted(opt_tree)]
        template = flatten_tree(self._moments_tree("mu"))
        paths = _optax_order(template)
        want = _OPT_HEAD + 2 * len(paths)
        if len(leaves) != want:
            raise ValueError(
                f"[load] optimizer state has {len(leaves)} leaves; this "
                f"model's AdamW state has {want} (optax order: count, "
                f"{len(_HYPERPARAMS)} hyperparameters, count, mu, nu)")
        moments = []
        for part in (leaves[_OPT_HEAD:_OPT_HEAD + len(paths)],
                     leaves[_OPT_HEAD + len(paths):]):
            for path, got in zip(paths, part):
                if np.shape(got) != template[path].shape:
                    raise ValueError(
                        f"[load] optimizer leaf {path} has shape "
                        f"{np.shape(got)}, the model's "
                        f"{template[path].shape}")
            moments.append(self._codec.params_from_flax(
                {"params": unflatten_tree(dict(zip(paths, part)))}))
        lr = float(leaves[1 + _HYPERPARAMS.index("learning_rate")])
        return int(leaves[0]), lr, moments[0], moments[1]

    def load(self, filename=None, root=None):
        """Restore weights, histories, epoch counter and, when present,
        the optimizer state and scheduler record, from a checkpoint of
        either package. Everything is checked before anything changes."""
        d_root, d_name = self._ckpt_defaults()
        root = Path(root) if root else d_root
        filename = filename or d_name
        ck = load_checkpoint(Path(root) / filename)
        restored = (self._restored_moments(ck["opt_state"])
                    if "opt_state" in ck else None)
        sd = self._codec.params_from_flax(ck["variables"])
        current = self.model.state_dict()
        bad = sorted(set(sd) ^ set(current)) or [
            k for k in sd if tuple(sd[k].shape) != tuple(current[k].shape)]
        if bad:
            raise ValueError(f"[load] checkpoint variables do not fit the "
                             f"model: {bad[:6]}")
        saved_args = ck.get("model_init_args", {})
        cur_args = dict(self.model.init_args)
        # compare only the keys the checkpoint recorded (init_args grows)
        norm_saved = {k: tuple(v) if isinstance(v, list) else v
                      for k, v in saved_args.items()}
        if saved_args and norm_saved != {k: cur_args[k] for k in norm_saved
                                         if k in cur_args}:
            print("[load] WARNING: Mismatch between saved model init args "
                  "and current model init args!")
            print("Saved:", saved_args)
            print("Current:", cur_args)

        self.model.load_state_dict(sd)
        if restored is not None:
            count, lr, mu, nu = restored
            self.optimizer.load_state(count, [mu[n] for n in self._names],
                                      [nu[n] for n in self._names])
            self._set_lr(lr)
        self.train_loss_history = list(ck.get("train_loss_history", []))
        self.train_accuracy_history = list(
            ck.get("train_accuracy_history", []))
        self.val_loss_history = list(ck.get("val_loss_history", []))
        self.val_accuracy_history = list(
            ck.get("val_accuracy_history", []))
        self.epoch = int(ck.get("epoch", 0))
        if restored is not None:
            sch = ck.get("scheduler")
            if sch is not None:
                self.scheduler.lr = float(sch["lr"])
                self.scheduler.best = float(sch["best"])
                self.scheduler.num_bad = int(sch["num_bad"])
            else:
                # no scheduler record: keep the LR the optimizer state
                # carried, so the next step does not re-inject the initial
                self.scheduler.lr = restored[1]
        print(f"[load] Checkpoint loaded from {Path(root) / filename}")
