#!/usr/bin/env python
"""Pure-numpy per-clip transcription, the CPU floor of the PyTorch port's
bench: the twin of `tools/numpy_reference_pipeline.py`.

    python tools/torch_numpy_reference_pipeline.py

Replicates the reference's per-clip processing shape (a Python loop of
DSP and model forwards, clip by clip) with the numerical recipe of the
port: framing, Hann rfft, mel projection, per-clip dB, DCT, YIN and both
model forwards, all in plain numpy on the host. Its constants (the mel
filterbanks, the Hann window, the DCT matrix) and the checkpoints come
from the port's own modules (`gat_tpu_torch.ops.mel`,
`gat_tpu_torch.ops.spectral`, `gat_tpu_torch.train.checkpoint`,
`gat_tpu_torch.config`); only their construction is shared, every
per-clip step stays numpy. `main` prints `NUMPY_BASELINE=` in audio
seconds per second over 32 synthetic clips. Imports nothing of JAX.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from gat_tpu_torch.ops.mel import (mel_filterbank_librosa,  # noqa: E402
                                   mel_filterbank_torchaudio)
from gat_tpu_torch.ops.spectral import (_dct_ii_np as _dct_ii,  # noqa: E402
                                        _hann_np as _hann)


def _adaptive_pool_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) averaging weights of torch's AdaptiveAvgPool bins:
    bin i spans [floor(i·n/o), ceil((i+1)·n/o))."""
    w = np.zeros((n_in, n_out), dtype=np.float32)
    for i in range(n_out):
        lo = (i * n_in) // n_out
        hi = -(-((i + 1) * n_in) // n_out)  # ceil
        w[lo:hi, i] = 1.0 / (hi - lo)
    return w


def _frame(y: np.ndarray, frame_length: int, hop: int) -> np.ndarray:
    nf = 1 + (len(y) - frame_length) // hop
    idx = np.arange(nf)[:, None] * hop + np.arange(frame_length)[None, :]
    return y[idx]


def yin_numpy(y: np.ndarray, sr: int, fmin: float = 50.0,
              fmax: float = 1000.0, frame_length: int = 2048,
              trough_threshold: float = 0.1) -> float:
    """Single-clip YIN median pitch, the librosa recipe in numpy."""
    win = frame_length // 2
    hop = frame_length // 4
    y = np.pad(y, frame_length // 2)
    frames = _frame(y, frame_length, hop)
    min_p = max(int(np.floor(sr / fmax)), 1)
    max_p = min(int(np.ceil(sr / fmin)), frame_length - win - 1)

    rev = frames[:, win:0:-1]
    a = np.fft.rfft(frames, frame_length, axis=-1)
    b = np.fft.rfft(rev, frame_length, axis=-1)
    acf = np.fft.irfft(a * b, frame_length, axis=-1)[:, win:win + max_p + 1]
    acf[np.abs(acf) < 1e-6] = 0.0

    csum = np.cumsum(frames ** 2, axis=-1)
    energy = csum[:, win:win + max_p + 1] - csum[:, :max_p + 1]
    energy[np.abs(energy) < 1e-6] = 0.0
    diff = energy[:, :1] + energy - 2.0 * acf

    tau = np.arange(1, max_p + 1)
    cum_mean = np.cumsum(diff[:, 1:max_p + 1], axis=-1) / tau
    cmnd = diff[:, min_p:max_p + 1] / (
        cum_mean[:, min_p - 1:max_p] + 1.1754944e-38)

    a2 = (cmnd[:, :-2] + cmnd[:, 2:] - 2.0 * cmnd[:, 1:-1]) / 2.0
    b2 = (cmnd[:, 2:] - cmnd[:, :-2]) / 2.0
    inner = -b2 / (2.0 * a2 + 1.1754944e-38)
    inner[np.abs(inner) > 1.0] = 0.0
    shifts = np.pad(inner, ((0, 0), (1, 1)))

    left = np.concatenate([cmnd[:, :1], cmnd[:, :-1]], axis=-1)
    right = np.concatenate([cmnd[:, 1:], cmnd[:, -1:]], axis=-1)
    is_trough = (cmnd < left) & (cmnd <= right)
    is_trough[:, 0] = cmnd[:, 0] < cmnd[:, 1]

    below = is_trough & (cmnd < trough_threshold)
    f0 = np.empty(len(cmnd))
    for i in range(len(cmnd)):
        idx = (np.argmax(below[i]) if below[i].any()
               else np.argmin(cmnd[i]))
        f0[i] = sr / (min_p + idx + shifts[i, idx])
    return float(np.median(f0))


class NumpyReferencePipeline:
    """Per-clip ensemble transcription with numpy only."""

    def __init__(self, mlp_ck: dict, cnn_ck: dict):
        self.sr = int(mlp_ck["config"]["target_sr"])
        mfcc_p = mlp_ck["config"]["features"]["params"]
        mel_p = cnn_ck["config"]["features"]["params"]
        self.n_mfcc = int(mfcc_p["N_MFCC"])
        self.norm_mfcc = bool(mfcc_p["NORMALIZE_AUDIO_VOLUME"])
        self.n_mels_cnn = int(mel_p["N_MELS"])
        self.n_fft_cnn = int(mel_p["N_FFT"])
        self.hop_cnn = int(mel_p["HOP_LENGTH"])
        self.norm_mel = bool(mel_p["NORMALIZE_AUDIO_VOLUME"])

        self.fb_librosa = np.asarray(
            mel_filterbank_librosa(self.sr, 2048, 128), np.float32)
        self.fb_torch = np.asarray(
            mel_filterbank_torchaudio(self.sr, self.n_fft_cnn,
                                      self.n_mels_cnn), np.float32)
        self.dct = _dct_ii(128, self.n_mfcc)
        self.win2048 = _hann(2048)
        self.win_cnn = _hann(self.n_fft_cnn)

        sc = mlp_ck["scaler"]
        self.sc_mean = np.asarray(sc["mean"], np.float32)
        self.sc_scale = np.asarray(sc["scale"], np.float32)
        self.mlp_params = mlp_ck["variables"]["params"]
        self.cnn_params = cnn_ck["variables"]["params"]
        self.cnn_stats = cnn_ck["variables"]["batch_stats"]
        self.cnn_args = cnn_ck["model_init_args"]

    # ----- DSP -----------------------------------------------------------
    def mfcc_vector(self, clip: np.ndarray) -> np.ndarray:
        y = clip
        if self.norm_mfcc:
            y = y / (np.sqrt(np.mean(y * y)) + 1e-9)
        yp = np.pad(y, 1024)
        frames = _frame(yp, 2048, 512) * self.win2048
        spec = np.abs(np.fft.rfft(frames, 2048, axis=-1)) ** 2
        mel = spec @ self.fb_librosa.T
        db = 10.0 * np.log10(np.maximum(mel, 1e-10))
        db = np.maximum(db, db.max() - 80.0)
        vec = (db @ self.dct).mean(axis=0)
        hz = yin_numpy(clip, self.sr)
        return np.concatenate([vec, [np.log10(hz)]]).astype(np.float32)

    def melspec_image(self, clip: np.ndarray) -> np.ndarray:
        y = clip
        if self.norm_mel:
            y = y / (np.sqrt(np.mean(y * y)) + 1e-9)
        yp = np.pad(y, self.n_fft_cnn // 2, mode="reflect")
        frames = _frame(yp, self.n_fft_cnn, self.hop_cnn) * self.win_cnn
        spec = np.abs(np.fft.rfft(frames, self.n_fft_cnn, axis=-1)) ** 2
        mel = spec @ self.fb_torch.T
        db = 10.0 * np.log10(np.maximum(mel, 1e-10))
        return db.T[None, :, :, None].astype(np.float32)  # (1, M, T, 1)

    # ----- model forwards --------------------------------------------------
    def mlp_forward(self, x: np.ndarray) -> np.ndarray:
        p = self.mlp_params
        i = 0
        while f"dense_{i}" in p:
            x = x @ p[f"dense_{i}"]["kernel"] + p[f"dense_{i}"]["bias"]
            ln = p[f"ln_{i}"]
            mu = x.mean(-1, keepdims=True)
            var = x.var(-1, keepdims=True)
            x = (x - mu) / np.sqrt(var + 1e-5) * ln["scale"] + ln["bias"]
            x = np.where(x >= 0, x, 0.1 * x)
            i += 1
        return x @ p["out"]["kernel"] + p["out"]["bias"]

    def _conv2d_same(self, x: np.ndarray, w: np.ndarray,
                     b: np.ndarray) -> np.ndarray:
        """NHWC conv, stride 1, same padding, via im2col matmul (the
        numpy analog of what torch does on CPU)."""
        kh, kw, cin, cout = w.shape
        n, h, ww, _ = x.shape
        xp = np.pad(x, ((0, 0), (kh // 2, kh // 2), (kw // 2, kw // 2),
                        (0, 0)))
        cols = np.empty((n, h, ww, kh * kw * cin), np.float32)
        c = 0
        for dy in range(kh):
            for dx in range(kw):
                cols[..., c:c + cin] = xp[:, dy:dy + h, dx:dx + ww, :]
                c += cin
        return cols @ w.reshape(-1, cout) + b

    def cnn_forward(self, x: np.ndarray) -> np.ndarray:
        p, s = self.cnn_params, self.cnn_stats
        for bi in range(int(self.cnn_args["num_blocks"])):
            x = self._conv2d_same(x, p[f"conv_{bi}"]["kernel"],
                                  p[f"conv_{bi}"]["bias"])
            bn, st = p[f"bn_{bi}"], s[f"bn_{bi}"]
            x = ((x - st["mean"]) / np.sqrt(st["var"] + 1e-5)
                 * bn["scale"] + bn["bias"])
            x = np.where(x >= 0, x, 0.01 * x)
            n, h, w, c = x.shape
            x = x[:, :h - h % 2, :w - w % 2, :].reshape(
                n, h // 2, 2, w // 2, 2, c).max(axis=(2, 4))
        # adaptive avg pool to (4, 4), torch bin edges
        ph = _adaptive_pool_matrix(x.shape[1], 4)
        pw = _adaptive_pool_matrix(x.shape[2], 4)
        x = np.einsum("nhwc,hp->npwc", x, ph)
        x = np.einsum("npwc,wq->npqc", x, pw)
        x = np.transpose(x, (0, 3, 1, 2)).reshape(x.shape[0], -1)
        x = x @ p["fc"]["kernel"] + p["fc"]["bias"]
        x = np.where(x >= 0, x, 0.01 * x)
        return x @ p["out"]["kernel"] + p["out"]["bias"]

    # ----- per-clip transcription -----------------------------------------
    @staticmethod
    def _softmax(z: np.ndarray) -> np.ndarray:
        e = np.exp(z - z.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    def transcribe_clip(self, clip: np.ndarray) -> np.ndarray:
        """One clip → blended ensemble probs (+ the YIN baseline pass the
        reference also runs per clip, included in mfcc_vector)."""
        mf = (self.mfcc_vector(clip) - self.sc_mean) / self.sc_scale
        mlp_p = self._softmax(self.mlp_forward(mf[None]))
        cnn_p = self._softmax(self.cnn_forward(self.melspec_image(clip)))
        return 0.2 * mlp_p + 0.8 * cnn_p


def main():
    import json
    import time
    from gat_tpu_torch.config import CNN_CONFIG, MLP_CONFIG
    from gat_tpu_torch.train.checkpoint import load_checkpoint

    mlp_ck = load_checkpoint(MLP_CONFIG.CHECKPOINTS_DIR
                             / MLP_CONFIG.DEFAULT_CKPT_NAME)
    cnn_ck = load_checkpoint(CNN_CONFIG.CHECKPOINTS_DIR
                             / CNN_CONFIG.DEFAULT_CKPT_NAME)
    pipe = NumpyReferencePipeline(mlp_ck, cnn_ck)
    sr = pipe.sr
    clip_len = int(sr * float(mlp_ck["config"]["clip_length"]))
    rng = np.random.default_rng(0)
    t = np.arange(clip_len) / sr
    clips = (0.3 * np.sin(2 * np.pi * rng.uniform(80, 700, 32)[:, None]
                          * t[None, :])
             + rng.normal(0, 0.01, (32, clip_len))).astype(np.float32)

    pipe.transcribe_clip(clips[0])  # warm numpy caches
    t0 = time.perf_counter()
    for c in clips:
        pipe.transcribe_clip(c)
    dt = time.perf_counter() - t0
    v = len(clips) * (clip_len / sr) / dt
    print("NUMPY_BASELINE=" + json.dumps(v))


if __name__ == "__main__":
    main()
