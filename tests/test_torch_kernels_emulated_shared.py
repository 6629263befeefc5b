"""The emulated-kernel tests of K6, the shared MFCC and YIN front-end, held
to K2 and K3: the kernels' own source compiled by g++ under
`emulated_kernels.EMULATION_HEADER`, against their plain PyTorch
versions."""
import ctypes

import numpy as np
import pytest
import torch

from gat_tpu_torch import features
from gat_tpu_torch.ops import spectral, yin

from emulated_kernels import (CPU, PLUCK_NEAR_TIE, SR, _fn, frame_count_clips,
                              k2_k3_emulated, matmul_route,
                              mfcc_pitch_emulated, port_pluck_clips,
                              shared_frontend_clips, yin_float64, libs_fixture)

libs = libs_fixture(("mfcc_pitch_frontend", "mfcc_frontend", "yin_pitch"))


@pytest.mark.parametrize("sr", [11025, 22050])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("pitch_normalized", [True, False])
def test_mfcc_pitch_kernel_emulated(libs, matmul_route, sr, normalize,
                                    pitch_normalized):
    """K6 against the plain shared front-end (one block DFT): MFCC atol
    1e-3 and rtol 2e-6 (the silent clip's c0 is -1131, where one fp32
    ulp is 1.2e-4 and the two summation orders differ by 1.5e-3), pitch
    rtol 2e-3, the log column log10 of the pitch; the silent clip's pitch
    is sr / min_p in both. Its MFCC is K2's bit for bit (the
    same rounds over the same samples), its pitch K3's bit for bit
    whenever it reads the raw clip. At 22050 Hz the lags 0..441 take two
    lag blocks of the ACF and the 22 frames 6 rounds."""
    x = shared_frontend_clips(sr)
    status, out, hz = mfcc_pitch_emulated(libs, x, sr, normalize,
                                          pitch_normalized)
    assert status == 0
    ref, ref_hz = features.mfcc_pitch_features_plain(
        x, sr, 64, normalize, pitch_normalized)
    torch.testing.assert_close(out[:, :64], ref[:, :64], atol=1e-3,
                               rtol=2e-6)
    torch.testing.assert_close(hz, ref_hz, rtol=2e-3, atol=0)
    torch.testing.assert_close(out[:, 64], torch.log10(hz), rtol=0,
                               atol=1e-6)
    min_p = yin.yin_periods(sr, 50.0, 1000.0, 2048, 1024)[0]
    assert float(hz[-1]) == pytest.approx(sr / min_p, rel=1e-6)
    hann, tw, fb, lo, hi = features._kernel_tables(sr, 128, False, CPU)
    k2 = torch.empty((x.shape[0], 64))
    fn = _fn(libs["mfcc_frontend"], "gat_mfcc_frontend",
             features._MFCC_ARGS)
    assert fn(x.data_ptr(), k2.data_ptr(), hann.data_ptr(), tw.data_ptr(),
              fb.data_ptr(), lo.data_ptr(), hi.data_ptr(),
              spectral.dct_ii_matrix(128, 64).data_ptr(), None, x.shape[0],
              x.shape[1], 512, spectral.n_frames(x.shape[1], 2048, 512), 128,
              64, int(normalize), 80.0, None) == 0
    assert torch.equal(out[:, :64], k2)
    if features.shared_pitch_is_raw(normalize, pitch_normalized):
        k3 = torch.empty(x.shape[0])
        fn = _fn(libs["yin_pitch"], "gat_yin_pitch", yin._YIN_ARGS)
        min_p, max_p = yin.yin_periods(sr, 50.0, 1000.0, 2048, 1024)
        assert fn(x.data_ptr(), k3.data_ptr(), x.shape[0], x.shape[1], 2048,
                  1024, 512, spectral.n_frames(x.shape[1], 2048, 512), min_p,
                  max_p, 0.1, float(sr), None) == 0
        assert torch.equal(hz, k3)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("pitch_normalized", [True, False])
def test_mfcc_pitch_kernel_emulated_bf16(libs, matmul_route, normalize,
                                         pitch_normalized):
    """With bfloat16 operands the wrapper hands K6 the clips rounded to
    bfloat16 (`spectral.kernel_signal`'s rounding) and K6's twiddles stay
    float32: K6 then computes the float32 shared front-end of the rounded
    clips, to the fp32 tolerances. The plain bfloat16 route rounds its
    DFT matrices too, which on the clean tones here lifts the spectrum's
    floor and moves c0 by up to 5.6: that gap is the route's, not the
    kernel's (`chip_smoke.py` holds the two on noisy clips)."""
    spectral.set_matmul_dtype(torch.bfloat16)
    x = shared_frontend_clips(SR)
    xr = x.to(torch.bfloat16).float()
    status, out, hz = mfcc_pitch_emulated(libs, xr, SR, normalize,
                                          pitch_normalized)
    assert status == 0
    ref, ref_hz = features.mfcc_pitch_features_plain(
        xr, SR, 64, normalize, pitch_normalized, bf16=False)
    torch.testing.assert_close(out[:, :64], ref[:, :64], atol=1e-3,
                               rtol=2e-6)
    torch.testing.assert_close(hz, ref_hz, rtol=2e-3, atol=0)
    plain_bf16 = features.mfcc_pitch_features_plain(x, SR, 64, normalize,
                                                    pitch_normalized)[0]
    assert float((plain_bf16 - ref).abs().max()) > 1.0


def test_mfcc_pitch_kernel_emulated_plucks(libs, matmul_route):
    """On the 47 clean plucks K6 holds K3's near-tie pin and agrees with a
    float64 YIN on every other clip to rtol 2e-3; the fp32 block route of
    the plain version (the JAX package's matmul route) misses four of the
    clean plucks above fmax = 1000 Hz (indices 41-46: 880-1175 Hz), which
    is why K6 keeps K3's direct ACF."""
    from tests.test_torch_spectral import pluck_clips
    from tests.test_torch_yin import NEAR_TIE
    assert NEAR_TIE == PLUCK_NEAR_TIE
    assert np.array_equal(port_pluck_clips(0.0), pluck_clips(0.0))
    x = torch.from_numpy(port_pluck_clips(0.0))
    status, _, hz = mfcc_pitch_emulated(libs, x, SR, True, False)
    assert status == 0
    truth = yin_float64(x, SR)
    keep = torch.ones(len(x), dtype=torch.bool)
    keep[NEAR_TIE] = False
    torch.testing.assert_close(hz[keep], truth[keep], rtol=2e-3, atol=0)
    _, plain_hz = features.mfcc_pitch_features_plain(x, SR)
    assert int(((plain_hz / truth - 1).abs() > 2e-3).sum()) >= 4


def test_mfcc_pitch_kernel_emulated_zero_rows(libs):
    """A batch of no clips launches nothing and writes nothing (the
    wrapper returns its empty outputs before the launch, as K2's and
    K3's do)."""
    status, out, hz = mfcc_pitch_emulated(libs, torch.zeros(0, 5512), SR,
                                          True, False)
    assert status == 0 and out.shape == (0, 65) and hz.shape == (0,)
    got, got_hz = features.mfcc_pitch_features(torch.zeros(0, 5512), SR)
    assert got.shape == (0, 65) and got_hz.shape == (0,)


def test_mfcc_pitch_kernel_emulated_refusals(libs):
    """K6's one-block route refuses a clip of 60,000 frames, whose f0
    table alone exceeds a block's shared memory (the wrappers take the
    split route long before, `test_torch_kernels_emulated_clips.py`), and
    a period range whose single frame of YIN exceeds a block's shared
    memory, with a nonzero status the wrapper raises on (its workspace
    query says -1). Longer clips than one block holds at once run in
    groups of frames (`test_mfcc_pitch_kernel_emulated_long`)."""
    x = torch.zeros(1, 59999 * 512)
    assert mfcc_pitch_emulated(libs, x, SR, True, False)[0] != 0
    x = torch.zeros(1, 5512)
    assert mfcc_pitch_emulated(libs, x, SR, True, False,
                               periods=(11, 60000))[0] != 0


@pytest.mark.parametrize("sr, length", [(11025, 4608), (11025, 5512),
                                        (11025, 6000), (22050, 11025)])
@pytest.mark.parametrize("normalize", [True, False])
def test_mfcc_pitch_kernel_emulated_frame_counts(libs, sr, length,
                                                 normalize):
    """10, 11, 12 and 22 frames: 11, 12, 13 and 23 hop-blocks of shared
    ACF chains (44, 48, 52 and 92 chains), so rounds of two hop-blocks
    with an odd count and a last round of one block, and at 22050 Hz two
    lag blocks. K6's MFCC is K2's and its raw pitch K3's bit for bit."""
    x = frame_count_clips(length)
    status, out, hz = mfcc_pitch_emulated(libs, x, sr, normalize, False)
    assert status == 0
    k2, k3 = k2_k3_emulated(libs, x, sr, normalize)
    assert torch.equal(out[:, :64], k2)
    assert torch.equal(hz, k3)
    torch.testing.assert_close(out[:, 64], torch.log10(hz), rtol=0,
                               atol=1e-6)


def test_mfcc_pitch_kernel_emulated_unaligned_rows(libs):
    """11,025-sample rows (44,100 bytes) at 22050 Hz: the clip copy for
    YIN is 16-byte copies on the first row and 4-byte copies on the other
    three. The same rows at a one-float offset, all copied 4 bytes at a
    time, give the same floats, and those are K2's and K3's."""
    x = frame_count_clips(11025)
    status, out, hz = mfcc_pitch_emulated(libs, x, 22050, True, False)
    assert status == 0
    shifted = torch.empty(x.numel() + 1)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0
    status, out_s, hz_s = mfcc_pitch_emulated(libs, shifted, 22050, True,
                                              False)
    assert status == 0
    assert torch.equal(out, out_s) and torch.equal(hz, hz_s)
    k2, k3 = k2_k3_emulated(libs, x, 22050, True)
    assert torch.equal(out[:, :64], k2) and torch.equal(hz, k3)


@pytest.mark.parametrize("hop", [256, 384])
def test_mfcc_pitch_kernel_emulated_other_hops(libs, hop):
    """A hop of 2 or 3 segments of win / 8 = 128 shares 6 or 5 of each
    frame's 8 chains with the frames after it: K6 is still K2 and K3 bit
    for bit at that hop."""
    x = frame_count_clips(5512)
    status, out, hz = mfcc_pitch_emulated(libs, x, SR, False, False, hop=hop)
    assert status == 0
    k2, k3 = k2_k3_emulated(libs, x, SR, False, hop=hop)
    assert torch.equal(out[:, :64], k2) and torch.equal(hz, k3)


@pytest.mark.parametrize("hop, win", [(500, 1024), (512, 1020),
                                      (64, 1024)])
def test_mfcc_pitch_kernel_emulated_refuses_hop(libs, hop, win):
    """The shared ACF chains need win / 8 to tile the hop: K6 and its
    occupancy query refuse any other (hop, win) with a nonzero status,
    and write nothing."""
    x = frame_count_clips(5512)
    status, out, hz = mfcc_pitch_emulated(libs, x, SR, True, False, hop=hop,
                                          win=win)
    assert status != 0
    assert bool(out.isnan().all()) and bool(hz.isnan().all())
    fn = _fn(libs["mfcc_pitch_frontend"],
             "gat_mfcc_pitch_frontend_blocks_per_sm",
             [ctypes.c_int] * 6 + [ctypes.c_void_p])
    blocks = ctypes.c_int(-1)
    assert fn(5512, hop, spectral.n_frames(5512, 2048, hop), 128, win, 221,
              ctypes.addressof(blocks)) != 0
