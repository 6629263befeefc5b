"""The emulated-kernel tests of K9, the polyphase resampler: the kernels'
own source compiled by g++ under `emulated_kernels.EMULATION_HEADER`,
against their plain PyTorch versions."""
import ctypes

import numpy as np
import pytest
import torch

from gat_tpu_torch.ops import resample

from emulated_kernels import (RESAMPLE_PINS, RESAMPLE_RATES, _fn, emulated_sms,
                              resample_emulated, resample_layout,
                              resample_pin_digest, resample_rows_np,
                              resample_taps, resample_tiles, libs_fixture)

libs = libs_fixture(("resample",))


@pytest.mark.parametrize("orig,target", RESAMPLE_RATES)
@pytest.mark.parametrize("length", [0, 1, 7, 1001, 4099])
def test_resample_kernel_emulated(libs, orig, target, length):
    """K9 on stereo rows (2, n), as `resample` flattens them, against
    `resample_plain` at atol 1e-5 (float32 sums of 49 to 209 taps in
    another order); the first outputs of every row have a negative u,
    the last read past the row. A row of 0 samples is refused by the C
    entry point, and the wrapper launches nothing for it."""
    x = resample_rows_np(length)
    ref = resample.resample_plain(x, orig, target)
    if length == 0:
        up, down = resample._ratio(orig, target)
        fn = _fn(libs["resample"], "gat_resample", resample._RESAMPLE_ARGS)
        out = torch.empty(2, 1)
        assert fn(x.data_ptr(), None, x.data_ptr(), out.data_ptr(), 2, 0,
                  2, 1, up, down, 1, 0, None) != 0
        assert ref.shape == (2, 0)
        return
    got = resample_emulated(libs, x, orig, target)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("orig,target", [(22050, 11025), (48000, 22050),
                                         (16000, 22050)])
def test_resample_rows_kernel_emulated(libs, orig, target):
    """`resample_rows`' launch: a permuted selection with a repeat, a
    single row, out_len above m (zeros past it) and below it (a cut, the
    file body's 11,025 -> 5,512), against `resample_rows_plain`; a row
    index outside x's rows gives a row of NaN."""
    x = resample_rows_np(4099, rows=5)
    m = -(-4099 * resample._ratio(orig, target)[0]
          // resample._ratio(orig, target)[1])
    for rows, out_len in (([3, 0, 4, 1, 3], m), ([2], m), ([4, 1], m + 700),
                          ([0, 2, 1], m // 2), (None, m - 1)):
        got = resample_emulated(libs, x, orig, target, rows, out_len)
        ref = resample.resample_rows_plain(x, rows, orig, target, out_len)
        assert got.shape == ref.shape
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    got = resample_emulated(libs, x, orig, target, [1, 5, -1], 300)
    assert not bool(got[0].isnan().any())
    assert bool(got[1:].isnan().all())


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_resample_kernel_emulated_unaligned_rows(libs, offset):
    """Rows at a pointer 1-3 floats past 16-byte alignment: the copies'
    cover stops at the tensor's aligned interior and its first and last
    floats are read one at a time; the bits are those of the same rows
    at an aligned pointer, and the plain version's within 1e-5."""
    n = 1003
    x = resample_rows_np(n, seed=offset)
    buf = torch.empty(2 * n + 4)
    moved = buf[offset:offset + 2 * n].view(2, n)
    moved.copy_(x)
    assert moved.data_ptr() % 16 == 4 * offset
    for orig, target in ((22050, 11025), (48000, 22050)):
        got = resample_emulated(libs, moved, orig, target)
        assert torch.equal(got, resample_emulated(libs, x, orig, target))
        torch.testing.assert_close(
            got, resample.resample_plain(x, orig, target), atol=1e-5,
            rtol=0)


def test_resample_kernel_emulated_taps_through_the_cache(libs):
    """7999 -> 22050 Hz (up 22050, down 7999): a phase table of 22050 x
    49 floats (4.3 MB) does not fit a block's shared memory, so K9 reads
    its taps through the read-only cache, builds no banded table, and
    stages rows; the outputs are the plain version's within 1e-5."""
    up, down, k_taps = resample_taps(7999, 22050)
    lay = resample_layout(libs, up, down, k_taps)
    assert (up, k_taps, lay["taps"], lay["rows"]) == (22050, 49, 0, 1)
    assert lay["bytes"] == 4 * (152 + 2 * lay["buf"]
                                + lay["frames"] * (4 * lay["groups"] + 1))
    x = resample_rows_np(301)
    torch.testing.assert_close(resample_emulated(libs, x, 7999, 22050),
                               resample.resample_plain(x, 7999, 22050),
                               atol=1e-5, rtol=0)


def test_resample_kernel_emulated_cache_route_grid(libs):
    """The read-only-cache route with the grid sized to the card: a 2003
    sample row at 7999 Hz (5,522 outputs in one frame of 44,100 phases,
    87 tiles of 16 groups) on 3 blocks gives the bits of 64 blocks, and
    the plain version's within 1e-5."""
    x = resample_rows_np(2003, rows=1)
    assert resample_tiles(libs, 7999, 22050, 2003, 1) == 87
    with emulated_sms(libs, 3):
        got = resample_emulated(libs, x, 7999, 22050)
    with emulated_sms(libs, 64):
        assert torch.equal(got, resample_emulated(libs, x, 7999, 22050))
    torch.testing.assert_close(got, resample.resample_plain(x, 7999, 22050),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("orig,target", list(RESAMPLE_PINS))
def test_resample_kernel_emulated_pins(libs, orig, target):
    """K9 gives the bits its first design gave at every rate pair, the
    read-only-cache route included: each output still adds its taps in
    ascending k with fmaf from 0, and the banded table's zeros around
    them leave the sum as it was."""
    def run(x, rows, out_len):
        return resample_emulated(libs, x, orig, target, rows, out_len)
    assert resample_pin_digest(run, orig, target) == RESAMPLE_PINS[
        (orig, target)]


@pytest.mark.parametrize("orig,target", [(22050, 11025), (48000, 22050),
                                         (16000, 22050), (44100, 11025)])
@pytest.mark.parametrize("sms", [1, 7])
def test_resample_kernel_emulated_grid(libs, orig, target, sms):
    """Blocks that compute several tiles each, a block's tiles crossing
    rows' ends (3 rows of 9001 samples at 48 and 16 kHz, of 33,000 and
    66,000 in the span's tiles of 4096 outputs): the span route at lags 8
    and 16 and the rows route give on 1 and 7 blocks the bits of 64
    blocks (one a tile but at 16 kHz's 84 tiles), and the plain version's
    within 1e-5."""
    n = {22050: 33000, 44100: 66000}.get(orig, 9001)
    x = resample_rows_np(n, rows=3, seed=2)
    tiles = resample_tiles(libs, orig, target, n, 3)
    assert tiles >= 2 * sms
    with emulated_sms(libs, sms):
        got = resample_emulated(libs, x, orig, target)
    with emulated_sms(libs, 64):
        assert torch.equal(got, resample_emulated(libs, x, orig, target))
    torch.testing.assert_close(got, resample.resample_plain(x, orig, target),
                               atol=1e-5, rtol=0)


def test_resample_kernel_emulated_tiles_not_a_multiple_of_the_grid(libs):
    """30 tiles (10 parts of 16 groups x 3 rows at 48 kHz) on 4 blocks:
    blocks of 7 and 8 tiles, parts changing inside a block (its banded
    table rebuilt), the same bits as one block a tile."""
    x = resample_rows_np(9001, rows=3, seed=2)
    sel = [2, 0, 1]
    tiles = resample_tiles(libs, 48000, 22050, 9001, 3)
    assert tiles == 30 and tiles % 4
    with emulated_sms(libs, 4):
        got = resample_emulated(libs, x, 48000, 22050, sel, 4000)
    with emulated_sms(libs, tiles):
        assert torch.equal(got, resample_emulated(libs, x, 48000, 22050,
                                                  sel, 4000))
    torch.testing.assert_close(
        got, resample.resample_rows_plain(x, sel, 48000, 22050, 4000),
        atol=1e-5, rtol=0)


def test_resample_kernel_emulated_buffer_parity(libs):
    """One block computes all 6 tiles of 6 rows at 22050 -> 11025 Hz, so
    each input buffer serves 3 tiles, its k-th use waiting on its
    mbarrier's parity k & 1: a wrong parity would read a buffer before its
    copy landed (stale outputs) or wait forever."""
    x = resample_rows_np(4099, rows=6, seed=8)
    assert resample_tiles(libs, 22050, 11025, 4099, 6) == 6
    with emulated_sms(libs, 1):
        got = resample_emulated(libs, x, 22050, 11025)
    torch.testing.assert_close(got, resample.resample_plain(x, 22050, 11025),
                               atol=1e-5, rtol=0)


def test_resample_kernel_emulated_short_rows(libs):
    """Rows shorter than a tile (9 rows of 37 samples) at every rate pair
    on 2 blocks: a tile or a few parts a row, a frame holding every output
    (fewer outputs than a frame's phases), within 1e-5 of the plain
    version."""
    x = resample_rows_np(37, rows=9, seed=3)
    with emulated_sms(libs, 2):
        for orig, target in RESAMPLE_RATES + [(7999, 22050)]:
            torch.testing.assert_close(
                resample_emulated(libs, x, orig, target),
                resample.resample_plain(x, orig, target), atol=1e-5, rtol=0)


@pytest.mark.parametrize("orig", [11025, 24000, 32000, 88200, 192000,
                                  384000])
def test_resample_kernel_emulated_other_rates(libs, orig):
    """Rates of WAVs users load, to 22050 Hz, beyond the tests' pairs: up 2
    (a span at lag 2), down 160 and 640 (rows), up 1 at down 4 (a span at
    lag 16), and 192 and 384 kHz, whose phase tables (246 and 492 KB) go
    through the read-only cache in rows of 32 and 16 frames of 8 groups;
    within 1e-5 of the plain version."""
    up, down, k = resample_taps(orig, 22050)
    lay = resample_layout(libs, up, down, k)
    assert lay["bytes"] > 0
    assert lay["frames"] == {11025: 1024, 24000: 32, 32000: 32, 88200: 1024,
                             192000: 32, 384000: 16}[orig]
    assert (lay["taps"] == 0) == (orig >= 192000)
    x = resample_rows_np(3001)
    torch.testing.assert_close(resample_emulated(libs, x, orig, 22050),
                               resample.resample_plain(x, orig, 22050),
                               atol=1e-5, rtol=0)


def test_resample_layout_and_attribute_only_grows(libs):
    """Every rate pair of the tests fits a block: rows of 32 frames x 16
    groups, one frame a lane, at lag 4 where a frame's samples lie a
    multiple of 32 floats apart (48, 16, 96 and 8 kHz; 96 kHz's rows and
    table take 200,160 bytes), a span of 1024 frames of one group, four a
    lane, elsewhere at lag gcd(D, 32) (8 at 22050 -> 11025: 89,488
    bytes); a thread walks the group's window, K +
    ceil(3·down / up) positions, lagged and rounded up to 4. The occupancy
    query (a launch does the same) raises the dynamic shared-memory
    attribute and never lowers it: after 96 kHz, 48 kHz and 22050 Hz leave
    it at 96 kHz's bytes."""
    sizes = {}
    for orig, target in RESAMPLE_RATES:
        up, down, k = resample_taps(orig, target)
        lay = resample_layout(libs, up, down, k)
        stride = lay["phases"] // up * down
        rows = stride % 32 == 0
        assert lay["phases"] == up * 4 // np.gcd(up, 4)
        want = ((1, 32, 16, 4, 1) if rows
                else (0, 1024, 1, np.gcd(stride, 32), 4))
        assert (lay["rows"], lay["frames"], lay["groups"], lay["lag"],
                lay["per_lane"]) == want
        assert lay["tile"] == lay["frames"] * 4 * lay["groups"]
        window = -(-3 * down // up) + k + lay["lag"] - 1
        assert lay["steps"] == -(-window // 4) * 4
        assert lay["taps"] == lay["groups"] * (lay["steps"] + lay["lag"]
                                               - 1) * 4
        assert 0 < lay["bytes"] <= 232448
        sizes[(orig, target)] = (up, down, k, lay["bytes"])
    assert sizes[(96000, 22050)] == (147, 640, 209, 200160)
    assert sizes[(22050, 11025)][3] == 89488
    lib = libs["resample"]
    attr = ctypes.c_int.in_dll(lib, "emu_smem_attr")
    attr.value = 48 * 1024
    fn = _fn(lib, "gat_resample_blocks_per_sm",
             [ctypes.c_int] * 3 + [ctypes.c_void_p])
    blocks = ctypes.c_int(-1)
    held = []
    for rates in ((96000, 22050), (48000, 22050), (22050, 11025)):
        assert fn(*sizes[rates][:3], ctypes.addressof(blocks)) == 0
        assert blocks.value == 0
        held.append(attr.value)
    assert held == [sizes[(96000, 22050)][3]] * 3
    resample_emulated(libs, resample_rows_np(500), 48000, 22050)
    assert attr.value == sizes[(96000, 22050)][3]
    assert fn(1, 0, 97, ctypes.addressof(blocks)) != 0
