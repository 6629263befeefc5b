"""The emulated-kernel tests of K1, the mel front-end, and K2, the MFCC
front-end: the kernels' own source compiled by g++ under
`emulated_kernels.EMULATION_HEADER`, against their plain PyTorch
versions."""
import pytest
import torch

from gat_tpu_torch import features
from gat_tpu_torch.ops import spectral

from emulated_kernels import (CPU, SR, _clips, _fn, _melspec_emulated,
                              _mfcc_emulated, check_mel_image,
                              check_mfcc_level_step, frames_clips,
                              level_step_clip, mfcc_level_step_clip,
                              libs_fixture)

libs = libs_fixture(("melspec_frontend", "mfcc_frontend"))


@pytest.mark.parametrize("length", [5512, 5300, 1100])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("to_db", [True, False])
def test_melspec_kernel_emulated(libs, normalize, to_db, length):
    """22, 21 and 5 frames: the odd counts run the last frame of a clip
    with a zero partner in its FFT."""
    x = _clips(length)
    out = _melspec_emulated(libs, x, normalize, to_db)
    ref = features.melspec_features_plain(x, SR,
                                          normalize_audio_volume=normalize,
                                          to_db=to_db)
    check_mel_image(out, ref, to_db)


def test_melspec_kernel_emulated_level_step(libs):
    """A silent frame sharing its FFT with a loud one keeps its level."""
    x = torch.from_numpy(level_step_clip())
    ref = features.melspec_features_plain(x, SR)
    step = ref[0, :, 7, 0] - ref[0, :, 6, 0]  # onset 2560: frames 6 and 7
    assert float(step.max()) >= 55.0
    check_mel_image(_melspec_emulated(libs, x, True, True), ref, True)


@pytest.mark.parametrize("length", [5512, 4608, 1100])
@pytest.mark.parametrize("normalize", [True, False])
def test_mfcc_kernel_emulated(libs, normalize, length):
    """11, 10 and 3 frames: the odd counts run the last frame with a zero
    partner in its FFT."""
    x = _clips(length)
    ref = features.mfcc_frontend_plain(x, SR, 64, normalize)
    torch.testing.assert_close(_mfcc_emulated(libs, x, normalize), ref,
                               atol=1e-3, rtol=0)


def test_mfcc_kernel_emulated_level_step(libs):
    """A near-silent frame sharing its FFT with a loud one, below the
    clip's top_db clamp."""
    x = torch.from_numpy(mfcc_level_step_clip())
    check_mfcc_level_step(x)
    torch.testing.assert_close(_mfcc_emulated(libs, x, True),
                               features.mfcc_frontend_plain(x, SR),
                               atol=1e-3, rtol=0)


def test_melspec_kernel_emulated_past_the_image_limit(libs):
    """K1 at 800 frames (hop 256; it refused 745 or more): the image is
    written straight to the output, to K1's tolerance against the plain
    version, on the noisy rows. The clean decaying tone (row 0) is left
    out: its bands 66 dB below its peak differ from the plain version by
    up to 0.22 dB at 744 frames too, with the image in shared memory,
    which is fp32 FFT leakage and not where the image is kept."""
    x = frames_clips(800, hop=256)[[1, 2, 3]]
    check_mel_image(_melspec_emulated(libs, x, True, True),
                    features.melspec_features_plain(x, SR), True)


def test_mfcc_kernel_emulated_refuses_missing_workspace(libs):
    """A launch whose dB image needs the workspace is refused without
    one, and writes nothing."""
    x = frames_clips(400)[:1]
    out = torch.full((1, 64), float("nan"))
    hann, tw, fb, lo, hi = features._kernel_tables(SR, 128, False, CPU)
    fn = _fn(libs["mfcc_frontend"], "gat_mfcc_frontend", features._MFCC_ARGS)
    assert fn(x.data_ptr(), out.data_ptr(), hann.data_ptr(), tw.data_ptr(),
              fb.data_ptr(), lo.data_ptr(), hi.data_ptr(),
              spectral.dct_ii_matrix(128, 64).data_ptr(), None, 1,
              x.shape[1], 512, 400, 128, 64, 1, 80.0, None) != 0
    assert bool(out.isnan().all())
