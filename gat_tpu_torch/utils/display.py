"""Waveform, spectrogram and series plots, the twins of
`gat_tpu/utils/display.py`: PNG out through matplotlib's Agg backend, the
spectrogram from the port's own mel front-end. matplotlib is imported
inside each function, so the module imports without it; where it is not
installed a plot raises ImportError."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["plot_waveform", "plot_spectrogram", "plot_series"]


def _get_plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("[display] plotting needs matplotlib, which is "
                          "not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _save(plt, fig, out_path):
    if out_path is not None:
        fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return fig


def plot_waveform(y, sr: int, title: str = "Waveform", out_path=None):
    plt = _get_plt()
    y = np.asarray(y)
    fig, ax = plt.subplots(figsize=(10, 3))
    ax.plot(np.arange(len(y)) / sr, y, linewidth=0.5)
    ax.set_xlabel("time (s)")
    ax.set_ylabel("amplitude")
    ax.set_title(title)
    return _save(plt, fig, out_path)


def plot_spectrogram(y, sr: int, n_fft: int = 2048, hop_length: int = 256,
                     title: str = "Mel spectrogram", out_path=None):
    """Log-mel image of `y` through `ops.spectral.melspectrogram_torchaudio`
    on the CPU."""
    plt = _get_plt()
    from ..ops.spectral import melspectrogram_torchaudio
    S = melspectrogram_torchaudio(
        torch.as_tensor(np.asarray(y, np.float32)), sr, n_fft=n_fft,
        hop_length=hop_length).numpy()  # (T, M)
    fig, ax = plt.subplots(figsize=(10, 4))
    im = ax.imshow(S.T, origin="lower", aspect="auto", cmap="magma",
                   extent=[0, len(y) / sr, 0, S.shape[1]])
    fig.colorbar(im, label="dB")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("mel bin")
    ax.set_title(title)
    return _save(plt, fig, out_path)


def plot_series(series, labels=None, title: str = "Series", out_path=None):
    """One or more 1-D series on shared axes (loss curves, envelopes)."""
    plt = _get_plt()
    if not isinstance(series, (list, tuple)):
        series = [series]
    labels = labels or [f"series_{i}" for i in range(len(series))]
    fig, ax = plt.subplots(figsize=(8, 4))
    for s, lab in zip(series, labels):
        ax.plot(np.asarray(s), label=lab)
    ax.legend()
    ax.grid(alpha=0.3)
    ax.set_title(title)
    return _save(plt, fig, out_path)
