"""The emulated-kernel tests of K3, the YIN pitch: the kernels' own source
compiled by g++ under `emulated_kernels.EMULATION_HEADER`, against their
plain PyTorch versions."""
import ctypes

import pytest
import torch

from gat_tpu_torch.ops import spectral, yin

from emulated_kernels import (CLIP_LONG_FRAMES, SR, _clips, _fn, frames_clips,
                              k2_k3_emulated, libs_fixture)

libs = libs_fixture(("yin_pitch", "mfcc_frontend"))


@pytest.mark.parametrize("sr", [11025, 22050])
@pytest.mark.parametrize("length", [5512, 4608, 1500])
def test_yin_kernel_emulated(libs, length, sr):
    """11, 10 and 3 frames: odd and even medians. At 22050 Hz the lags
    0..441 take two lag blocks of the ACF, the second one partly."""
    x = _clips(length)
    n = x.shape[0]
    min_p, max_p = yin.yin_periods(sr, 50.0, 1000.0, 2048, 1024)
    out = torch.empty(n)
    fn = _fn(libs["yin_pitch"], "gat_yin_pitch", yin._YIN_ARGS)
    assert fn(x.data_ptr(), out.data_ptr(), n, length, 2048, 1024, 512,
              spectral.n_frames(length, 2048, 512), min_p, max_p, 0.1,
              float(sr), None) == 0
    torch.testing.assert_close(out, yin.yin_pitch_plain(x, sr), rtol=2e-3,
                               atol=0)


@pytest.mark.parametrize("noise", [0.0, 0.1])
def test_yin_kernel_emulated_plucks(libs, noise):
    """On the 47 plucks K3 agrees with the plain version to rtol 2e-3,
    the pinned near-tie of test_torch_yin apart. A single running fp32
    sum per lag failed this on the clean 1174.7 Hz pluck (9.6%); the
    kernel's interleaved partial sums pass."""
    from tests.test_torch_spectral import pluck_clips
    from tests.test_torch_yin import NEAR_TIE
    x = torch.from_numpy(pluck_clips(noise))
    n, length = x.shape
    out = torch.empty(n)
    fn = _fn(libs["yin_pitch"], "gat_yin_pitch", yin._YIN_ARGS)
    assert fn(x.data_ptr(), out.data_ptr(), n, length, 2048, 1024, 512,
              spectral.n_frames(length, 2048, 512), 11, 221, 0.1,
              float(SR), None) == 0
    keep = torch.ones(n, dtype=torch.bool)
    if noise == 0.0:
        keep[NEAR_TIE] = False
    torch.testing.assert_close(out[keep], yin.yin_pitch_plain(x, SR)[keep],
                               rtol=2e-3, atol=0)


def test_shared_memory_limit_refused(libs):
    """A launch K3's one-block route cannot hold is refused with a nonzero
    status, which the wrappers raise on: a clip of 60,000 frames, whose f0
    table alone exceeds a block's shared memory (the wrappers take the
    split route long before, `test_torch_kernels_emulated_clips.py`), and
    a period range whose single frame exceeds a block's shared memory.
    Longer clips than one block holds at once run in groups of frames
    (`test_yin_kernel_emulated_long`)."""
    fn = _fn(libs["yin_pitch"], "gat_yin_pitch", yin._YIN_ARGS)
    for length, max_p in ((59999 * 512, 221), (5512, 60000)):
        x = torch.zeros(1, length)
        out = torch.empty(1)
        assert fn(x.data_ptr(), out.data_ptr(), 1, length, 2048, 1024, 512,
                  spectral.n_frames(length, 2048, 512), 11, max_p, 0.1,
                  float(SR), None) != 0


@pytest.mark.parametrize("n_frames", CLIP_LONG_FRAMES)
def test_yin_kernel_emulated_long(libs, n_frames):
    """K3 at 71, 100 and 200 frames, where its clip no longer fits a block
    whole: it runs in groups of frames and agrees with the plain version
    to rtol 2e-3, as at 11 frames."""
    x = frames_clips(n_frames)
    group = _fn(libs["yin_pitch"], "gat_yin_group", [ctypes.c_int] * 4)(
        1024, 512, n_frames, 221)
    assert 0 < group < n_frames
    _, k3 = k2_k3_emulated(libs, x, SR, True)
    torch.testing.assert_close(k3, yin.yin_pitch_plain(x, SR), rtol=2e-3,
                               atol=0)
