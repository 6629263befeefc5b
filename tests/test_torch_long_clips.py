"""The port's plain path against gat_tpu at clips far past what one block
of the card's clip kernels used to take: one 120 s clip at 11025 Hz (5,168
frames at the mel's hop 256, 2,584 at the MFCC's and YIN's 512), the same
seeded numpy input to both packages, at the stated tolerances (ROADMAP
"Stated tolerances"), and `transcribe_note` of a 60 s clip. The card's
split route (`csrc/dsp_common.cuh`) is held to this plain path by the
emulated tests (`test_torch_kernels_emulated_clips.py`) and on the card
(`test_torch_cuda.py -k long_clip`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_tpu import features as jf
from gat_tpu.infer import Transcriber as JTranscriber
from gat_tpu.ops import spectral as js
from gat_tpu.ops import yin as jyin
from gat_tpu_torch import features as tf
from gat_tpu_torch.infer import Transcriber
from gat_tpu_torch.ops import spectral as ts
from gat_tpu_torch.ops import yin as ty

from emulated_kernels import long_riff

SR = 11025
SECONDS = 120.0


@pytest.fixture(scope="module")
def clip() -> np.ndarray:
    return long_riff(SECONDS)


@pytest.fixture
def route(request):
    """Both packages on the FFT or the matmul route (fp32), with the
    shared front-end on or off; the defaults back afterwards."""
    name, shared = request.param
    try:
        for mod in (js, ts):
            mod.set_stft_backend(name)
        tf.SHARED_BLOCK_FRONTEND = shared
        if jf.SHARED_BLOCK_FRONTEND != shared:
            jf.SHARED_BLOCK_FRONTEND = shared
            jax.clear_caches()
        yield request.param
    finally:
        for mod in (js, ts):
            mod.set_stft_backend("auto")
        tf.SHARED_BLOCK_FRONTEND = True
        if not jf.SHARED_BLOCK_FRONTEND:
            jf.SHARED_BLOCK_FRONTEND = True
            jax.clear_caches()


def test_melspec_features_at_120s(clip):
    """The mel image: 0.1 dB where gat_tpu reads above -60 dB."""
    got = tf.melspec_features(torch.from_numpy(clip), SR).numpy()
    ref = np.asarray(jf.melspec_features(jnp.asarray(clip), SR))
    assert got.shape == ref.shape == (1, 64, 5168, 1)
    mask = ref > -60.0
    np.testing.assert_allclose(got[mask], ref[mask], atol=0.1, rtol=0)
    assert np.isfinite(got).all() and got.min() >= -100.0


@pytest.mark.parametrize("route", [("fft", False), ("matmul", False),
                                   ("matmul", True)], indirect=True,
                         ids=["fft", "matmul", "shared"])
def test_mfcc_feature_vectors_at_120s(clip, route):
    """The MFCC mean and the log10 pitch feature on the FFT route, on the
    matmul route's separate front-ends, and on its shared front-end (one
    block DFT for both): MFCC atol 1e-3, pitch rtol 2e-3."""
    got = tf.mfcc_feature_vectors(torch.from_numpy(clip), SR).numpy()
    ref = np.asarray(jf.mfcc_feature_vectors(jnp.asarray(clip), SR))
    assert got.shape == ref.shape == (1, 65)
    np.testing.assert_allclose(got[:, :64], ref[:, :64], atol=1e-3, rtol=0)
    np.testing.assert_allclose(10.0 ** (got[:, 64] - ref[:, 64]), 1.0,
                               atol=2e-3, rtol=0)


@pytest.mark.parametrize("route", [("fft", True), ("matmul", True)],
                         indirect=True, ids=["fft", "matmul"])
def test_yin_pitch_at_120s(clip, route):
    """The median YIN pitch over 2,584 frames: rtol 2e-3."""
    got = ty.yin_pitch(torch.from_numpy(clip), SR).numpy()
    ref = np.asarray(jyin.yin_pitch(jnp.asarray(clip), SR))
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=0)


def test_transcribe_note_at_60s(clip):
    """`transcribe_note(audio, clip_duration=60.0)` of the first 60 s:
    the same labels as gat_tpu's, probabilities within 1e-2."""
    audio = clip[0, :int(60.0 * SR)]
    got = Transcriber(device="cpu").transcribe_note(audio, clip_duration=60.0,
                                                    sr_in=SR)
    ref = JTranscriber().transcribe_note(audio, clip_duration=60.0, sr_in=SR)
    assert got["labels"] == ref["labels"]
    np.testing.assert_allclose(got["probs"], ref["probs"], atol=1e-2)
