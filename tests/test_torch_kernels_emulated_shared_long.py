"""The emulated-kernel tests of K6 at clips longer than one group of YIN
frames and past the dB image's room in shared memory, held to K2 and K3:
the kernels' own source compiled by g++ under
`emulated_kernels.EMULATION_HEADER`, against their plain PyTorch
versions."""
import ctypes

import pytest
import torch

from gat_tpu_torch import features

from emulated_kernels import (CLIP_LONG_FRAMES, SR, _fn, frames_clips,
                              k2_k3_emulated, matmul_route,
                              mfcc_pitch_emulated, libs_fixture)

libs = libs_fixture(("mfcc_pitch_frontend", "mfcc_frontend", "yin_pitch"))


@pytest.mark.parametrize("n_frames", CLIP_LONG_FRAMES)
def test_mfcc_pitch_kernel_emulated_long(libs, matmul_route, n_frames):
    """K6 at 71, 100 and 200 frames, YIN in groups of frames: against the
    plain shared front-end to `test_mfcc_pitch_kernel_emulated`'s
    tolerances, its MFCC K2's and its pitch K3's bit for bit (chains that
    cross a group's end are summed again in the next group)."""
    x = frames_clips(n_frames)
    group = _fn(libs["mfcc_pitch_frontend"], "gat_mfcc_pitch_group",
                [ctypes.c_int] * 6)(n_frames, 128, 64, 1024, 512, 221)
    assert 0 < group < n_frames
    status, out, hz = mfcc_pitch_emulated(libs, x, SR, True, False)
    assert status == 0
    ref, ref_hz = features.mfcc_pitch_features_plain(x, SR, 64, True, False)
    torch.testing.assert_close(out[:, :64], ref[:, :64], atol=1e-3,
                               rtol=2e-6)
    torch.testing.assert_close(hz, ref_hz, rtol=2e-3, atol=0)
    k2, k3 = k2_k3_emulated(libs, x, SR, True)
    assert torch.equal(out[:, :64], k2) and torch.equal(hz, k3)


@pytest.mark.parametrize("pitch_normalized", [True, False])
def test_mfcc_pitch_kernel_emulated_long_normalized(libs, matmul_route,
                                                    pitch_normalized):
    """Each group's copy is divided by the clip's volume divisor when both
    flags ask for it: 100 frames, against the plain version."""
    x = frames_clips(100)
    status, out, hz = mfcc_pitch_emulated(libs, x, SR, True,
                                          pitch_normalized)
    assert status == 0
    ref, ref_hz = features.mfcc_pitch_features_plain(x, SR, 64, True,
                                                     pitch_normalized)
    torch.testing.assert_close(out[:, :64], ref[:, :64], atol=1e-3,
                               rtol=2e-6)
    torch.testing.assert_close(hz, ref_hz, rtol=2e-3, atol=0)


@pytest.mark.parametrize("n_frames", [354, 355, 400])
def test_mfcc_kernels_emulated_past_the_image_limit(libs, matmul_route,
                                                    n_frames):
    """K2 and K6 at 354 frames keep the dB image in shared memory, and from
    355 frames (K2 refused 355 or more) in a workspace of n_frames x 128
    floats per clip: K2 against the plain version (atol 1e-3 and rtol
    2e-6, as K6's test: the mostly silent pluck row's c0 is -261, a mean
    over 355 frames summed in another order than torch.mean's), K6's MFCC
    K2's and its pitch K3's bit for bit."""
    x = frames_clips(n_frames)[[1, 3]]
    floats = n_frames * 128 if n_frames >= 355 else 0
    sizes = (n_frames, 128, 64, 1024, 512, 221)
    assert _fn(libs["mfcc_frontend"], "gat_mfcc_workspace_floats",
               [ctypes.c_int] * 2)(128, n_frames) == floats
    assert _fn(libs["mfcc_pitch_frontend"],
               "gat_mfcc_pitch_workspace_floats",
               [ctypes.c_int] * 6)(*sizes) == floats
    k2, k3 = k2_k3_emulated(libs, x, SR, True)
    torch.testing.assert_close(k2, features.mfcc_frontend_plain(x, SR),
                               atol=1e-3, rtol=2e-6)
    status, out, hz = mfcc_pitch_emulated(libs, x, SR, True, False)
    assert status == 0
    assert torch.equal(out[:, :64], k2) and torch.equal(hz, k3)
