"""The emulated-kernel tests of K6's split route, the shared MFCC and
YIN front-end with a clip's frames in tiles, one block a tile: held to
K6's one-block route, to K2's and K3's split routes and to the plain
shared front-end (`emulated_kernels.mfcc_pitch_split`; the other clip
front-ends' split route is `test_torch_kernels_emulated_clips.py`)."""
import pytest
import torch

from gat_tpu_torch import features

from emulated_kernels import (SR, libs_fixture, matmul_route,
                              mfcc_pitch_emulated, mfcc_pitch_split,
                              mfcc_split, split_clips, yin_split)

libs = libs_fixture(("mfcc_pitch_frontend", "mfcc_frontend", "yin_pitch"))


@pytest.mark.parametrize("n_frames, tile", [(41, 4), (64, 10), (140, 24)])
@pytest.mark.parametrize("normalize, pitch_normalized",
                         [(True, False), (True, True), (False, False)])
def test_mfcc_pitch_kernel_emulated_split(libs, matmul_route, n_frames, tile,
                                          normalize, pitch_normalized):
    """K6's split route: its pitch and its MFCC the one-block route's bit
    for bit, its pitch K3's split route's when it reads the raw clips and
    its MFCC K2's split route's; against the plain shared front-end to
    K6's tolerances; two runs the same bits."""
    x = split_clips(n_frames, 512)
    out, hz = mfcc_pitch_split(libs, x, normalize, pitch_normalized, tile)
    status, one, one_hz = mfcc_pitch_emulated(libs, x, SR, normalize,
                                              pitch_normalized)
    assert status == 0
    assert torch.equal(hz, one_hz)
    assert torch.equal(out[:, :64], one[:, :64])
    assert torch.equal(out[:, :64], mfcc_split(libs, x, normalize, tile))
    torch.testing.assert_close(out[:, 64], torch.log10(hz), rtol=0,
                               atol=1e-6)
    if features.shared_pitch_is_raw(normalize, pitch_normalized):
        assert torch.equal(hz, yin_split(libs, x, tile))
    ref, ref_hz = features.mfcc_pitch_features_plain(x, SR, 64, normalize,
                                                     pitch_normalized)
    torch.testing.assert_close(out[:, :64], ref[:, :64], atol=1e-3,
                               rtol=2e-6)
    torch.testing.assert_close(hz, ref_hz, rtol=2e-3, atol=0)
    again = mfcc_pitch_split(libs, x, normalize, pitch_normalized, tile)
    assert torch.equal(again[0], out) and torch.equal(again[1], hz)
