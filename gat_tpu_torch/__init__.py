"""gat_tpu_torch — the PyTorch and CUDA port of gat_tpu for NVIDIA Hopper.

The single-file path of `gat_tpu` (a WAV resampled to 22050 Hz, noise
gates, spectral-flux onsets, slicing, clips re-rated to the checkpoint
rate), its many-file serving path (`transcribe_files`, and the watch-folder
and HTTP server in `serve.py`), its two streaming engines (`stream`: the
chunked `ScanStreamer` and the ring-buffer `LiveTranscriber`), its CLI
(`cli.py`) and its clip-ensemble path (MFCC + YIN features into the MLP,
the mel image into the CNN, a weighted softmax vote, and the YIN pitch
baseline) rebuilt on PyTorch, with the two spectral front-ends, YIN, the
onset envelope and the onset pick as hand-written CUDA kernels (`csrc/`).
`train` trains the MLP and CNN on the synthetic dataset (`data`) and
writes checkpoints that both packages read.
Entry points run on the card unless the caller passes device="cpu" (the
CLI and the server: `--device cpu`), which runs the plain PyTorch
versions of the kernels. `gat_tpu` stays the reference the port is tested
against.
"""

__version__ = "1.0.0"

from .config import (  # noqa: F401
    CONFIG_VERSION, TARGET_SR, CLIP_DURATION,
    MFCC_CONFIG, MELSPEC_CONFIG, MLP_CONFIG, CNN_CONFIG, SLICER_CONFIG,
    PARALLEL_CONFIG,
    MFCCConfig, MelSpecConfig, MLPConfig, CNNConfig, AudioSlicerConfig,
)

# The top-level API, imported when first read: `import gat_tpu_torch` for
# the config alone does not load torch's models or the kernels' wrappers.
_LAZY = {
    "Transcriber": ".infer",
    "NotePredictor": ".infer",
    "FeatureBuilder": ".features",
    "AudioSlicer": ".segment.slicing",
    "AudioDatasetLoader": ".data.loader",
    "TrainingManager": ".train",
    "Trainer": ".train",
    "LiveTranscriber": ".stream",
    "ScanStreamer": ".stream",
    "MLP": ".models",
    "CNN": ".models",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module = importlib.import_module(_LAZY[name], __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
