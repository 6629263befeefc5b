"""The port's numpy baseline, `tools/torch_numpy_reference_pipeline.py`,
against the JAX package's, `tools/numpy_reference_pipeline.py`: the same
clips and the shipped checkpoints through both, each loaded from its own
package's modules.

Bounds: both sides are plain numpy over the same float32 constants and
weights, so the ensemble probs are held to atol 1e-6 (equal in practice)
and the YIN pitch, the MFCC vector and the mel image to equality.
"""
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_numpy_ref_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pipes():
    from gat_tpu.config import CNN_CONFIG as JCNN, MLP_CONFIG as JMLP
    from gat_tpu.train.checkpoint import load_checkpoint as jload
    from gat_tpu_torch.config import CNN_CONFIG, MLP_CONFIG
    from gat_tpu_torch.train.checkpoint import load_checkpoint
    ref_tool = _tool("numpy_reference_pipeline")
    port_tool = _tool("torch_numpy_reference_pipeline")
    ref = ref_tool.NumpyReferencePipeline(
        jload(JMLP.CHECKPOINTS_DIR / JMLP.DEFAULT_CKPT_NAME),
        jload(JCNN.CHECKPOINTS_DIR / JCNN.DEFAULT_CKPT_NAME))
    port = port_tool.NumpyReferencePipeline(
        load_checkpoint(MLP_CONFIG.CHECKPOINTS_DIR
                        / MLP_CONFIG.DEFAULT_CKPT_NAME),
        load_checkpoint(CNN_CONFIG.CHECKPOINTS_DIR
                        / CNN_CONFIG.DEFAULT_CKPT_NAME))
    return ref_tool, port_tool, ref, port


def main_clips(sr: int) -> np.ndarray:
    """The 32 synthetic clips of the tools' `main`: tones of 80-700 Hz
    plus noise, 0.5 s at `sr`, from seed 0."""
    rng = np.random.default_rng(0)
    t = np.arange(sr // 2) / sr
    return (0.3 * np.sin(2 * np.pi * rng.uniform(80, 700, 32)[:, None]
                         * t[None, :])
            + rng.normal(0, 0.01, (32, sr // 2))).astype(np.float32)


def test_transcribe_clip_matches(pipes):
    """The blended probs of every one of main's 32 clips and of 8 noisy
    plucks, and the argmax."""
    from emulated_kernels import port_pluck_clips
    _, _, ref, port = pipes
    assert port.sr == ref.sr == 11025
    clips = np.concatenate([main_clips(port.sr), port_pluck_clips(0.1)[::6]])
    for clip in clips:
        got, want = port.transcribe_clip(clip), ref.transcribe_clip(clip)
        assert got.shape == want.shape == (1, 47)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert got.argmax() == want.argmax()


def test_features_and_yin_equal(pipes):
    """The MFCC vector with its pitch, the mel image and `yin_numpy`."""
    ref_tool, port_tool, ref, port = pipes
    for clip in main_clips(port.sr)[:8]:
        assert port_tool.yin_numpy(clip, 11025) == ref_tool.yin_numpy(
            clip, 11025)
        np.testing.assert_array_equal(port.mfcc_vector(clip),
                                      ref.mfcc_vector(clip))
        np.testing.assert_array_equal(port.melspec_image(clip),
                                      ref.melspec_image(clip))
    np.testing.assert_array_equal(port_tool._adaptive_pool_matrix(7, 4),
                                  _jax_pool(7, 4))


def _jax_pool(n_in, n_out):
    from gat_tpu.models.cnn import _adaptive_pool_matrix
    return _adaptive_pool_matrix(n_in, n_out)


def test_main_prints_the_baseline():
    """`main` prints NUMPY_BASELINE= and a positive rate in audio-s/s."""
    out = subprocess.run(
        [sys.executable, str(REPO / "tools"
                             / "torch_numpy_reference_pipeline.py")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("NUMPY_BASELINE=")
    assert float(line.split("=", 1)[1]) > 0
