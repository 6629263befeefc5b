"""TrainingManager: dataset → features → model → trainer → checkpoint for
each model family, the twin of `gat_tpu/train/manager.py`.

The dataset is chosen by name, index or path (the registry under
`datasets_root` first), or interactively. Datasets rendered by the
eval-only modal engine are refused. One loader is kept per dataset
directory signature, so `train_all` decodes the WAVs once for both
families and a regenerated directory is read again.

Checkpoints go under the port's own root, `data/checkpoints/torch/
<family>/`, with the shipped file names; unlike the JAX manager, whose
defaults are the shipped files themselves, a port run never overwrites
`data/checkpoints/{mlp,cnn}/`. Both packages load either's checkpoints.
"""
from __future__ import annotations

import os
import time
from dataclasses import asdict
from pathlib import Path

import torch

from ..config import (CLIP_DURATION, CNN_CONFIG, DATASETS_ROOT,
                      MELSPEC_CONFIG, MFCC_CONFIG, MLP_CONFIG, TARGET_SR)
from ..data.loader import AudioDatasetLoader, get_available_datasets
from ..features import FeatureBuilder
from ..models import CNN, MLP
from ..utils.device import resolve_device
from .data import build_mfcc_train_val, build_melspec_train_val
from .trainer import Trainer

__all__ = ["TrainingManager"]


class TrainingManager:
    """Both models must be trained on the same dataset (reference rule).
    Everything runs on `device` (default the card: the front-end kernels,
    then cuBLAS/cuDNN for the models); 'cpu' runs the plain versions."""

    def __init__(self, mlp_cfg=None, cnn_cfg=None,
                 datasets_root=DATASETS_ROOT, target_sr: int = TARGET_SR,
                 clip_duration: float = CLIP_DURATION,
                 use_bf16_cnn: bool | None = None,
                 mesh_devices: int | None = None, mesh=None, device=None):
        """`mesh_devices=N` (a mesh of the world's N ranks on `device`'s
        kind, `parallel.make_mesh`) or an explicit `mesh` trains both
        families data-parallel: every rank makes the same calls, builds
        the features on its device and runs `Trainer(mesh=)`, whose
        steps split each batch over `data`; rank 0 writes the
        checkpoints."""
        self.mlp_cfg = mlp_cfg or MLP_CONFIG
        self.cnn_cfg = cnn_cfg or CNN_CONFIG
        self.datasets_root = Path(datasets_root)
        self.target_sr = target_sr
        self.clip_duration = clip_duration
        if mesh is None and mesh_devices:
            from ..parallel.mesh import make_mesh
            mesh = make_mesh(mesh_devices, device=device)
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.mesh import mesh_device
            device = mesh_device(mesh)
        self.device = resolve_device(device)
        # bf16 CNN compute with float32 weights (the reference's AMP)
        self.use_bf16_cnn = (self.cnn_cfg.USE_AMP if use_bf16_cnn is None
                             else use_bf16_cnn)
        self._loaders: dict[tuple, AudioDatasetLoader] = {}

    def _get_loader(self, ds_path) -> AudioDatasetLoader:
        # the key holds a walk signature (paths, mtimes, sizes), so a
        # directory regenerated between trainings is decoded again
        key = (str(ds_path), self.target_sr, self.clip_duration,
               self._dir_signature(ds_path))
        if key not in self._loaders:
            self._loaders.clear()  # at most one live decode cache
            self._loaders[key] = AudioDatasetLoader(
                [ds_path], target_sr=self.target_sr,
                duration=self.clip_duration, device=self.device)
        return self._loaders[key]

    def _dir_signature(self, ds_path) -> int:
        # the loader's own walk, so the signature covers exactly the
        # files it would decode
        sig = 0
        walk = AudioDatasetLoader([ds_path], device=self.device)
        for p, _label in walk.iter_paths():
            st = p.stat()
            sig = hash((sig, p.name, st.st_mtime_ns, st.st_size))
        return sig

    @staticmethod
    def _print_config(cfg):
        print("\nConfiguration Values: ")
        for k, v in asdict(cfg).items():
            print(f" -\t{k}: {v}")
        print()

    @staticmethod
    def _refuse_eval_only(p: Path) -> Path:
        """Datasets rendered by the held-out modal engine carry an
        EVAL_ONLY.json marker (data/modal.py) and must never reach
        training: that would void the unseen-timbre evaluation."""
        from ..data.modal import EVAL_ONLY_MARKER
        if (Path(p) / EVAL_ONLY_MARKER).exists():
            raise ValueError(
                f"[_choose_dataset] {p} is an EVAL-ONLY dataset (it "
                f"carries {EVAL_ONLY_MARKER}: rendered by the held-out "
                "modal family, data/modal.py). Training on it would "
                "invalidate the unseen-family evaluation; pick a "
                "training-family dataset (data/synth.py) instead.")
        return p

    def _choose_dataset(self, dataset=None) -> Path:
        """Programmatic or interactive dataset selection."""
        if dataset is not None:
            # Path(int) raises TypeError: stringify so an int index
            # reaches the numeric branch
            p = Path(str(dataset))
            # explicit path forms keep path semantics; bare names resolve
            # through the registry first, so a same-named directory in the
            # working directory cannot shadow a registered dataset
            if (isinstance(dataset, (Path, os.PathLike))
                    or p.is_absolute()):
                if p.is_dir():
                    return self._refuse_eval_only(p)
                raise FileNotFoundError(
                    f"[_choose_dataset] Not a dataset directory: {p}")
            names, paths = get_available_datasets(self.datasets_root)
            if isinstance(dataset, int) or str(dataset).isdigit():
                i = int(dataset)
                if not 0 <= i < len(paths):
                    raise FileNotFoundError(
                        f"[_choose_dataset] dataset index {i} out of "
                        f"range (0 to {len(paths) - 1})")
                return self._refuse_eval_only(paths[i])
            for n, pp in zip(names, paths):
                if n == dataset or n.endswith(f"/{dataset}"):
                    return self._refuse_eval_only(pp)
            if p.is_dir():
                return self._refuse_eval_only(p)
            raise FileNotFoundError(
                f"[_choose_dataset] Unknown dataset: {dataset}")
        names, paths = get_available_datasets(self.datasets_root)
        print("Available datasets:", *names, sep="\n", end="\n\n")
        idx = int(input(f"Enter dataset index (0 to {len(names) - 1}): "))
        print(f"Selected dataset: {paths[idx]}\n")
        return self._refuse_eval_only(paths[idx])

    # ------------------------------------------------------------------
    def train_mlp(self, dataset=None, epochs: int | None = None,
                  save: bool | None = None, seed: int = 42,
                  verbose: bool = True, ckpt_root=None):
        """MFCC → MLP pipeline."""
        t0 = time.time()
        if verbose:
            self._print_config(MFCC_CONFIG)
            self._print_config(self.mlp_cfg)
        ds_path = self._choose_dataset(dataset)
        t_feat = time.time()

        loader = self._get_loader(ds_path)
        builder = FeatureBuilder(device=self.device)
        (dl_tr, dl_val, X, y, num_classes, reverse_map,
         scaler) = build_mfcc_train_val(
            builder, loader, n_mfcc=MFCC_CONFIG.N_MFCC,
            batch_size=MFCC_CONFIG.BATCH_SIZE,
            normalize_audio_volume=MFCC_CONFIG.NORMALIZE_AUDIO_VOLUME,
            standard_scaler=MFCC_CONFIG.STANDARD_SCALER, seed=seed)
        if verbose:
            print(f"audio loading & feature extraction time: "
                  f"{time.time() - t_feat:.2f}s\n")
            print("num_features:", X.shape[1])
            print("num_classes:", num_classes)

        model = MLP(num_features=X.shape[1],
                    hidden_dim=self.mlp_cfg.HIDDEN_DIM,
                    num_hidden_layers=self.mlp_cfg.NUM_HIDDEN_LAYERS,
                    num_classes=num_classes,
                    dropout=self.mlp_cfg.DROPOUT)
        trainer = Trainer(model, dl_tr, dl_val, reverse_map=reverse_map,
                          lr=self.mlp_cfg.LR,
                          weight_decay=self.mlp_cfg.DECAY, scaler=scaler,
                          seed=seed, max_clip_norm=self.mlp_cfg.MAX_CLIP_NORM,
                          model_type="mlp", device=self.device,
                          mesh=self.mesh)
        t_train = time.time()
        trainer.train(epochs=epochs or self.mlp_cfg.EPOCHS,
                      es_window_len=self.mlp_cfg.ES_WINDOW_LEN,
                      es_slope_limit=self.mlp_cfg.ES_SLOPE_LIMIT,
                      verbose=verbose)
        trainer.stage_seconds = {"load_features": t_train - t_feat,
                                 "train": time.time() - t_train}
        if save if save is not None else self.mlp_cfg.SAVE_CHECKPOINT:
            trainer.save(root=ckpt_root, target_sr=self.target_sr,
                         clip_length=self.clip_duration)
        if verbose:
            print(f"[train_mlp] total time: {time.time() - t0:.1f}s")
        return trainer

    def train_cnn(self, dataset=None, epochs: int | None = None,
                  save: bool | None = None, seed: int = 42,
                  verbose: bool = True, ckpt_root=None):
        """mel-spec → CNN pipeline."""
        t0 = time.time()
        if verbose:
            self._print_config(MELSPEC_CONFIG)
            self._print_config(self.cnn_cfg)
        ds_path = self._choose_dataset(dataset)
        t_feat = time.time()

        loader = self._get_loader(ds_path)
        builder = FeatureBuilder(device=self.device)
        (dl_tr, dl_val, X, y, num_classes,
         reverse_map) = build_melspec_train_val(
            builder, loader, n_mels=MELSPEC_CONFIG.N_MELS,
            n_fft=MELSPEC_CONFIG.N_FFT,
            hop_length=MELSPEC_CONFIG.HOP_LENGTH,
            batch_size=MELSPEC_CONFIG.BATCH_SIZE,
            normalize_audio_volume=MELSPEC_CONFIG.NORMALIZE_AUDIO_VOLUME,
            seed=seed)
        if verbose:
            print(f"audio loading & feature extraction time: "
                  f"{time.time() - t_feat:.2f}s\n")
            print("X shape:", X.shape, "num_classes:", num_classes)

        model = CNN(num_classes=num_classes,
                    base_channels=self.cnn_cfg.BASE_CHANNELS,
                    num_blocks=self.cnn_cfg.NUM_BLOCKS,
                    hidden_dim=self.cnn_cfg.HIDDEN_DIM,
                    dropout=self.cnn_cfg.DROPOUT,
                    kernel_size=self.cnn_cfg.KERNEL_SIZE,
                    dtype=torch.bfloat16 if self.use_bf16_cnn
                    else torch.float32)
        trainer = Trainer(model, dl_tr, dl_val, reverse_map=reverse_map,
                          lr=self.cnn_cfg.LR,
                          weight_decay=self.cnn_cfg.DECAY, seed=seed,
                          max_clip_norm=self.cnn_cfg.MAX_CLIP_NORM,
                          model_type="cnn", device=self.device,
                          mesh=self.mesh)
        t_train = time.time()
        trainer.train(epochs=epochs or self.cnn_cfg.EPOCHS,
                      es_window_len=self.cnn_cfg.ES_WINDOW_LEN,
                      es_slope_limit=self.cnn_cfg.ES_SLOPE_LIMIT,
                      verbose=verbose)
        trainer.stage_seconds = {"load_features": t_train - t_feat,
                                 "train": time.time() - t_train}
        if save if save is not None else self.cnn_cfg.SAVE_CHECKPOINT:
            trainer.save(root=ckpt_root, target_sr=self.target_sr,
                         clip_length=self.clip_duration)
        if verbose:
            print(f"[train_cnn] total time: {time.time() - t0:.1f}s")
        return trainer

    def train_all(self, dataset=None, **kw):
        """MLP then CNN on the same dataset, resolved once (an interactive
        choice must not prompt twice)."""
        ds_path = self._choose_dataset(dataset)
        mlp_trainer = self.train_mlp(dataset=ds_path, **kw)
        cnn_trainer = self.train_cnn(dataset=ds_path, **kw)
        return mlp_trainer, cnn_trainer
