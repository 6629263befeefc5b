"""The emulated-kernel tests of the clip front-ends K1, K2, K3 and K6
together: their occupancy queries and plans, the golden digests, and the
split route that takes clips of any length (a clip's frames in tiles, one
block a tile) against the one-block route and the plain versions (K6's
split route: `test_torch_kernels_emulated_shared_split.py`): the
kernels' own source compiled by g++ under
`emulated_kernels.EMULATION_HEADER`."""
import ctypes

import pytest
import torch

from gat_tpu_torch import features, kernels
from gat_tpu_torch.ops import yin

from emulated_kernels import (GOLDEN, PLANS, SR, _digest, _fn,
                              _melspec_emulated, _mfcc_emulated,
                              check_mel_image, emulated_sms, golden_clips,
                              k2_k3_emulated, libs_fixture, matmul_route,
                              melspec_split, mfcc_pitch_emulated, mfcc_split,
                              mfcc_pitch_split, plan, samples, split_clips,
                              split_tile_rule, yin_split)

libs = libs_fixture(("melspec_frontend", "mfcc_frontend", "yin_pitch",
                     "mfcc_pitch_frontend", "onset_envelope"))


@pytest.mark.parametrize("name, symbol, args, too_big", [
    ("melspec_frontend", "gat_melspec_blocks_per_sm", (64, 22), (2000, 22)),
    ("mfcc_frontend", "gat_mfcc_blocks_per_sm", (128, 11), (2000, 11)),
    ("yin_pitch", "gat_yin_blocks_per_sm", (1024, 512, 11, 221),
     (1024, 512, 60000, 221)),
    ("onset_envelope", "gat_onset_envelope_blocks_per_sm", (365, 512),
     (60000, 512)),
    ("mfcc_pitch_frontend", "gat_mfcc_pitch_frontend_blocks_per_sm",
     (5512, 512, 11, 128, 1024, 221), (0, 512, 60000, 128, 1024, 221)),
])
def test_occupancy_entry_points(libs, name, symbol, args, too_big):
    """Each kernel's occupancy query takes the main path's sizes (the
    emulation has no occupancy to report, so it writes 0), and refuses
    what its launch refuses: more shared memory than a block has, which
    2000 mel bands' partial sums take in K1 and K2, a one-block clip of
    60,000 frames' f0 table in K3 and K6 (the wrappers take the split
    route long before: `test_occupancy_queries_answer_at_any_length`),
    and 60000 mel items in K4. K5's shared memory does not depend on the
    length: `test_onset_pick_emulated_any_length`."""
    fn = _fn(libs[name], symbol, [ctypes.c_int] * len(args)
             + [ctypes.c_void_p])
    blocks = ctypes.c_int(-1)
    assert fn(*args, ctypes.addressof(blocks)) == 0 and blocks.value == 0
    assert fn(*too_big, ctypes.addressof(blocks)) != 0


@pytest.mark.parametrize("sr, length", list(GOLDEN))
def test_clip_kernels_emulated_golden(libs, matmul_route, sr, length):
    """At up to 69 frames every clip front-end gives the floats it gave
    before this length handling, bit for bit: the one-group layout at 11
    frames, groups of frames at 22 (22050 Hz) and 69 (K3)."""
    x = golden_clips(length)
    want = GOLDEN[(sr, length)]
    k2, k3 = k2_k3_emulated(libs, x, sr, True)
    _, k6, hz = mfcc_pitch_emulated(libs, x, sr, True, False)
    got = {"K2": _digest(k2), "K3": _digest(k3), "K6": _digest(k6)}
    if "K1" in want:
        got["K1"] = _digest(_melspec_emulated(libs, x, True, True))
    assert {k: got[k] for k in want} == want
    assert torch.equal(hz, k3)


@pytest.mark.parametrize("name, symbol, args", [
    ("melspec_frontend", "gat_melspec_blocks_per_sm", (64,)),
    ("mfcc_frontend", "gat_mfcc_blocks_per_sm", (128,)),
    ("yin_pitch", "gat_yin_blocks_per_sm", (1024, 512, None, 221)),
    ("mfcc_pitch_frontend", "gat_mfcc_pitch_frontend_blocks_per_sm",
     (0, 512, None, 128, 1024, 221)),
])
def test_occupancy_queries_answer_at_any_length(libs, name, symbol, args):
    """Each clip front-end's occupancy query answers at 2000 frames (the
    limit the wrappers' guard once set) and at 20,000 (a 15 min clip at
    hop 512), its plan takes the split route for one such clip, and the
    wrappers' frame count raises only past what the C entry points
    address."""
    def query(n_frames):
        full = [n_frames if a is None else a for a in args]
        if None not in args:
            full.append(n_frames)
        fn = _fn(libs[name], symbol, [ctypes.c_int] * len(full)
                 + [ctypes.c_void_p])
        blocks = ctypes.c_int(-1)
        return fn(*full, ctypes.addressof(blocks))
    plan_sizes = PLANS[name][0]
    for n_frames in (2000, 20000):
        assert query(n_frames) == 0
        tile, tiles, _, floats = plan(
            libs, name, plan_sizes(1, samples(name, n_frames), n_frames))
        assert 0 < tile < n_frames and tiles == -(-n_frames // tile)
        assert floats >= 0
        assert features.kernel_frames((n_frames - 1) * 512, 512,
                                      name) == n_frames
    with pytest.raises(ValueError, match="addresses at most"):
        features.kernel_frames(kernels.MAX_SAMPLES + 1, 512, name)


# ---------------------------------------------------------------------------
# The split route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(PLANS))
@pytest.mark.parametrize("sms", [4, 132])
def test_clip_kernel_plans(libs, name, sms):
    """Each clip front-end's plan is `split_tile_rule` on the emulated
    card's SMs (one resident block an SM under the emulation): one block
    a clip at the shipped 0.5 s clips (11 and 22 frames) at any count and
    wherever the clips fill the card, tiles past that, and past 512
    frames always for K3 and K6, whose one block keeps every f0 in shared
    memory; the split route's scratch as the entry points carve it."""
    sizes, quantum, max_tile, floats = PLANS[name]
    with emulated_sms(libs, sms, name):
        for n, t in [(1, 11), (1, 22), (4096, 22), (1, 63), (1, 64),
                     (3, 87), (256, 87), (1, 173), (64, 1292), (1, 2584),
                     (1, 5168), (sms, 600), (sms, 20000), (1, 19380)]:
            tile = split_tile_rule(n, t, sms, quantum, max_tile)
            length = samples(name, t)
            got = plan(libs, name, sizes(n, length, t))
            tiles = -(-t // tile) if tile else 1
            assert got[:2] == [tile, tiles], (n, t)
            if t <= 22:
                assert tile == 0
            if tile:
                assert got[3] == floats(length, t, tiles)


@pytest.mark.parametrize("n_frames, tile", [(41, 4), (64, 6), (64, 10),
                                            (300, 40)])
@pytest.mark.parametrize("normalize, to_db", [(True, True), (False, False)])
def test_melspec_kernel_emulated_split(libs, n_frames, tile, normalize,
                                       to_db):
    """K1's split route, tiles of a few frames with a short last one: the
    one-block route's image bit for bit (the tiles pair the same frames in
    each FFT and scale by the divisor summed from the pre-pass's lane sums
    of each chunk of 65,536 samples, the one-block route's float; two
    chunks at 300 frames), K1's tolerance against the plain version, two
    runs the same bits."""
    x = split_clips(n_frames, 256)
    got = melspec_split(libs, x, normalize, to_db, tile)
    assert torch.equal(got, _melspec_emulated(libs, x, normalize, to_db))
    check_mel_image(got, features.melspec_features_plain(
        x, SR, normalize_audio_volume=normalize, to_db=to_db), to_db)
    assert torch.equal(melspec_split(libs, x, normalize, to_db, tile), got)


@pytest.mark.parametrize("n_frames, tile", [(41, 4), (64, 6), (70, 12),
                                            (300, 40)])
@pytest.mark.parametrize("normalize", [True, False])
def test_mfcc_kernel_emulated_split(libs, n_frames, tile, normalize):
    """K2's split route: the one-block route's mean bit for bit (the same
    divisor, dB values and peak, the frames' clamped dB summed in the same
    chunks of 128 frames; three chunks of samples and of frames at 300
    frames), K2's tolerance against the plain version, two runs the same
    bits."""
    x = split_clips(n_frames, 512)
    got = mfcc_split(libs, x, normalize, tile)
    assert torch.equal(got, _mfcc_emulated(libs, x, normalize))
    torch.testing.assert_close(
        got, features.mfcc_frontend_plain(x, SR, 64, normalize), atol=1e-3,
        rtol=2e-6)
    assert torch.equal(mfcc_split(libs, x, normalize, tile), got)


@pytest.mark.parametrize("n_frames, tile", [(41, 3), (64, 7), (70, 32),
                                            (64, 64)])
def test_yin_kernel_emulated_split(libs, n_frames, tile):
    """K3's split route, every frame's f0 in device memory and the median
    by a radix selection (odd and even frame counts, one tile up to tiles
    of a few frames): the one-block route's pitch bit for bit, rtol 2e-3
    against the plain version, two runs the same bits."""
    x = split_clips(n_frames, 512)
    got = yin_split(libs, x, tile)
    _, one = k2_k3_emulated(libs, x, SR, True)
    assert torch.equal(got, one)
    torch.testing.assert_close(got, yin.yin_pitch_plain(x, SR), rtol=2e-3,
                               atol=0)
    assert torch.equal(yin_split(libs, x, tile), got)


@pytest.mark.parametrize("name", ["melspec_frontend", "mfcc_frontend",
                                  "mfcc_pitch_frontend"])
def test_split_entry_points_refuse_odd_tiles(libs, name):
    """K1's, K2's and K6's split routes take even tiles only (an odd one
    would pair other frames in an FFT than the one-block route does), and
    refuse with a nonzero status before writing anything."""
    x = split_clips(41, 512)
    with pytest.raises(AssertionError):
        {"melspec_frontend": lambda: melspec_split(libs, x, True, True, 5),
         "mfcc_frontend": lambda: mfcc_split(libs, x, True, 5),
         "mfcc_pitch_frontend": lambda: mfcc_pitch_split(libs, x, True,
                                                         False, 5)}[name]()
