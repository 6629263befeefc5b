"""Static configuration of the PyTorch port.

The values mirror `gat_tpu/config.py` one for one, so that both packages
read the same shipped checkpoints with the same defaults. At inference the
checkpoint's embedded config is the source of truth; these are the
defaults a checkpoint falls back on and the names of the shipped files.
"""
from __future__ import annotations

import os
from dataclasses import asdict, dataclass
from pathlib import Path

CONFIG_VERSION = "1.0.0"

PROJECT_ROOT = Path(__file__).resolve().parent.parent
# Data lives beside the package in a checkout; GAT_TPU_DATA_ROOT points an
# installed package at a checkout's data/ directory (same variable as the
# JAX package, so both read one tree).
DATA_ROOT = Path(os.environ.get("GAT_TPU_DATA_ROOT", PROJECT_ROOT / "data"))
DATASETS_ROOT = DATA_ROOT / "datasets"
PERSONAL_DATASETS_ROOT = DATASETS_ROOT / "personal"
INFERENCE_ROOT = DATA_ROOT / "inference"
INFERENCE_CLIPS_ROOT = INFERENCE_ROOT / "sliced_clips"
INFERENCE_AUDIO_ROOT = INFERENCE_ROOT / "in_audio"
CHECKPOINTS_ROOT = DATA_ROOT / "checkpoints"
# The port's trainer writes its checkpoints under a root of its own, so a
# training run never overwrites the shipped files of CHECKPOINTS_ROOT/mlp
# and /cnn (the JAX trainer's defaults).
TORCH_CHECKPOINTS_ROOT = CHECKPOINTS_ROOT / "torch"
# `Transcriber.transcribe(save_clips=True)` writes the sliced clips here.
INFERENCE_OUTPUT_ROOT = INFERENCE_ROOT / "output"
# Hand-written CUDA kernels are compiled here at first use.
KERNEL_BUILD_DIR = PROJECT_ROOT / "build" / "gat_tpu_torch"

TARGET_SR = 11025 * 2  # 22050 Hz: slicing rate of the file path
CLIP_DURATION = 0.50   # seconds per note clip
DEFAULT_MAX_ONSETS = 64  # onset slots per file of the file path
# files per wave of the many-file path (`transcribe_files`); the server's
# warmup derives its shapes from it, so both stay one family
DEFAULT_MAX_BATCH = 4


@dataclass(frozen=True)
class MFCCConfig:
    """MFCC-vector front-end of the MLP."""
    N_MFCC: int = 64
    BATCH_SIZE: int = 32
    STANDARD_SCALER: bool = True
    NORMALIZE_AUDIO_VOLUME: bool = True
    ADD_PITCH_FEATURES: bool = True


@dataclass(frozen=True)
class MelSpecConfig:
    """Mel-spectrogram front-end of the CNN."""
    N_MELS: int = 64
    N_FFT: int = 2048
    HOP_LENGTH: int = 256
    BATCH_SIZE: int = 32
    NORMALIZE_AUDIO_VOLUME: bool = True
    TO_DB: bool = True


@dataclass(frozen=True)
class MLPConfig:
    """MLP checkpoints, topology and training recipe. DEFAULT_CKPT_NAME is
    the shipped synthetic-trained MLP; REFERENCE_CKPT_NAME the imported
    reference weights."""
    CHECKPOINTS_DIR: Path = CHECKPOINTS_ROOT / "mlp"
    DEFAULT_CKPT_NAME: str = f"mlp_synth_v{CONFIG_VERSION}.gtckpt.npz"
    REFERENCE_CKPT_NAME: str = f"mlp_v{CONFIG_VERSION}.gtckpt.npz"
    SAVE_CHECKPOINT: bool = True
    HIDDEN_DIM: int = 128
    NUM_HIDDEN_LAYERS: int = 2
    DROPOUT: float = 0.1
    LR: float = 1e-3
    DECAY: float = 1e-4
    EPOCHS: int = 10
    MAX_CLIP_NORM: float = 1.0
    ES_WINDOW_LEN: int = 4
    ES_SLOPE_LIMIT: float = -0.00015


@dataclass(frozen=True)
class CNNConfig:
    """CNN checkpoints, topology and training recipe. USE_AMP trains the
    CNN in bf16 compute with float32 weights."""
    CHECKPOINTS_DIR: Path = CHECKPOINTS_ROOT / "cnn"
    DEFAULT_CKPT_NAME: str = f"cnn_v{CONFIG_VERSION}.gtckpt.npz"
    SAVE_CHECKPOINT: bool = True
    BASE_CHANNELS: int = 32
    NUM_BLOCKS: int = 3
    KERNEL_SIZE: int = 3
    HIDDEN_DIM: int = 256
    DROPOUT: float = 0.1
    LR: float = 1e-3
    DECAY: float = 1e-4
    EPOCHS: int = 3
    MAX_CLIP_NORM: float = 1.0
    ES_WINDOW_LEN: int = 4
    ES_SLOPE_LIMIT: float = -0.00015
    USE_AMP: bool = True


@dataclass(frozen=True)
class AudioSlicerConfig:
    """Noise gating and onset slicing of the file path."""
    MIN_IN_DB_THRESHOLD: float = -32.5  # per-sample amplitude gate
    MIN_SLICE_RMS_DB: float = -37.0     # per-slice loudness gate
    HOP_LEN: int = 512
    MIN_SEP: float = 0.3                # minimum onset separation (s)
    ATTACK_SKIP_SEC: float = 0.1        # note attack skipped when slicing


@dataclass(frozen=True)
class ParallelConfig:
    """The mesh layout and static padding budgets: the axis names of
    `parallel.make_mesh`'s (data, model) DeviceMesh, one rank per card."""
    DATA_AXIS: str = "data"
    MODEL_AXIS: str = "model"
    MAX_ONSETS: int = 64        # max onsets per file-level transcription
    MAX_CLIPS_PER_BATCH: int = 1024


MFCC_CONFIG = MFCCConfig()
MELSPEC_CONFIG = MelSpecConfig()
MLP_CONFIG = MLPConfig()
CNN_CONFIG = CNNConfig()
SLICER_CONFIG = AudioSlicerConfig()
PARALLEL_CONFIG = ParallelConfig()


def config_dict(cfg) -> dict:
    """JSON-safe asdict (Paths → str), as a checkpoint embeds it."""
    return {k: (str(v) if isinstance(v, Path) else v)
            for k, v in asdict(cfg).items()}
