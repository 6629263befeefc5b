"""Train/val splitting and minibatch iteration, the twin of
`gat_tpu/train/data.py` (numpy only).

`stratified_split` is sklearn's `train_test_split(stratify=y,
random_state=seed)` written out in numpy, draw for draw, so the port
trains and validates on the same clips as the JAX package without
needing sklearn.
"""
from __future__ import annotations

import math

import numpy as np

from ..utils.scaler import FeatureScaler

__all__ = ["ArrayDataLoader", "stratified_split", "build_mfcc_train_val",
           "build_melspec_dataloader", "build_melspec_train_val"]


class ArrayDataLoader:
    """Minibatch iterator over (X, y) numpy arrays; reshuffles each epoch
    when `shuffle`."""

    def __init__(self, X, y, batch_size: int = 32, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = False):
        self.X = np.asarray(X)
        self.y = np.asarray(y)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.X) // self.batch_size
        if not self.drop_last and len(self.X) % self.batch_size:
            n += 1
        return n

    def __iter__(self):
        idx = np.arange(len(self.X))
        if self.shuffle:
            self._rng.shuffle(idx)
        end = (len(idx) - len(idx) % self.batch_size if self.drop_last
               else len(idx))
        for i in range(0, end, self.batch_size):
            j = idx[i:i + self.batch_size]
            yield self.X[j], self.y[j]


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """Per-class draws nearest the multivariate hypergeometric's mode:
    the floors of the proportional shares, then one more for the largest
    remainders, ties broken by `rng` (sklearn's `_approximate_mode`)."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _stratified_indices(y, val_size: float | int, seed: int):
    """(train, test) indices of sklearn's StratifiedShuffleSplit, first
    split, random_state = seed. `val_size` is sklearn's test_size: a
    float in (0, 1) is a fraction, test_size = ceil(val_size·n); an
    integer in [1, n) is the count itself."""
    y = np.asarray(y)
    n = len(y)
    kind = np.asarray(val_size).dtype.kind
    if kind == "i":
        if not 0 < val_size < n:
            raise ValueError(f"val_size={val_size} must be a count in "
                             f"[1, {n}) or a fraction in (0, 1)")
        n_test = int(val_size)
    elif kind == "f":
        if not 0.0 < val_size < 1.0:
            raise ValueError(f"val_size={val_size} must be a fraction in "
                             f"(0, 1) or a count in [1, {n})")
        n_test = math.ceil(val_size * n)
    else:
        raise ValueError(f"Invalid value for val_size: {val_size!r}")
    n_train = n - n_test
    classes, y_indices, class_counts = np.unique(
        y, return_inverse=True, return_counts=True)
    if class_counts.min() < 2:
        raise ValueError(
            f"The least populated classes in y have only 1 member: "
            f"{classes[class_counts < 2].tolist()}")
    if n_train < len(classes) or n_test < len(classes):
        raise ValueError(
            f"train ({n_train}) and val ({n_test}) sizes must each be at "
            f"least the number of classes ({len(classes)})")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]),
                                     mode="clip")
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def stratified_split(X, y, val_size: float | int = 0.2, seed: int = 42):
    """Stratified split → (X_train, X_val, y_train, y_val), the same
    indices as `sklearn.model_selection.train_test_split(X, y,
    test_size=val_size, stratify=y, random_state=seed)`: a float
    `val_size` is a fraction, an integer a count."""
    train, test = _stratified_indices(y, val_size, seed)
    X, y = np.asarray(X), np.asarray(y)
    return X[train], X[test], y[train], y[test]


def build_mfcc_train_val(feature_builder, audio_loader, n_mfcc: int = 64,
                         batch_size: int = 32, val_size: float = 0.2,
                         normalize_audio_volume: bool = True,
                         standard_scaler: bool = True, seed: int = 42,
                         drop_last: bool = False):
    """MFCC train/val loaders for the MLP. Returns (dl_tr, dl_val, X, y,
    num_classes, reverse_map, scaler)."""
    X, y, num_classes, reverse_map = feature_builder.extract_mfcc_features(
        audio_loader, n_mfcc, normalize_audio_volume)
    X_tr, X_val, y_tr, y_val = stratified_split(X, y, val_size, seed)
    scaler = None
    if standard_scaler:
        scaler = FeatureScaler().fit(X_tr)
        X_tr = scaler.transform(X_tr)
        X_val = scaler.transform(X_val)
        feature_builder.scaler = scaler
    dl_tr = ArrayDataLoader(X_tr, y_tr, batch_size, shuffle=True, seed=seed,
                            drop_last=drop_last)
    dl_val = ArrayDataLoader(X_val, y_val, batch_size, shuffle=False)
    return dl_tr, dl_val, X, y, num_classes, reverse_map, scaler


def build_melspec_dataloader(feature_builder, audio_loader,
                             n_mels: int = 64, n_fft: int = 2048,
                             hop_length: int = 256, batch_size: int = 32,
                             shuffle: bool = True,
                             normalize_audio_volume: bool = False):
    """Single mel-spec loader without a split. Returns (dataloader,
    num_classes, reverse_map)."""
    X, y, num_classes, reverse_map = \
        feature_builder.extract_melspec_features(
            audio_loader, n_mels, n_fft, hop_length, normalize_audio_volume)
    dl = ArrayDataLoader(X, y, batch_size, shuffle=shuffle)
    return dl, num_classes, reverse_map


def build_melspec_train_val(feature_builder, audio_loader, n_mels: int = 64,
                            n_fft: int = 2048, hop_length: int = 256,
                            batch_size: int = 32, val_size: float = 0.2,
                            normalize_audio_volume: bool = True,
                            seed: int = 42, drop_last: bool = False):
    """Mel-spec train/val loaders for the CNN (no scaler). Returns
    (dl_tr, dl_val, X, y, num_classes, reverse_map)."""
    X, y, num_classes, reverse_map = \
        feature_builder.extract_melspec_features(
            audio_loader, n_mels, n_fft, hop_length, normalize_audio_volume)
    train, test = _stratified_indices(y, val_size, seed)
    dl_tr = ArrayDataLoader(X[train], y[train], batch_size, shuffle=True,
                            seed=seed, drop_last=drop_last)
    dl_val = ArrayDataLoader(X[test], y[test], batch_size, shuffle=False)
    return dl_tr, dl_val, X, y, num_classes, reverse_map
