"""The emulated-kernel tests of K4, the onset envelope, and K5, the onset
pick: the kernels' own source compiled by g++ under
`emulated_kernels.EMULATION_HEADER`, against their plain PyTorch
versions."""
import ctypes
import re

import numpy as np
import pytest
import torch

from gat_tpu_torch import features, kernels
from gat_tpu_torch.ops import onset, spectral

from emulated_kernels import (CPU, FILE_SR, LIVE_MIN_SEP, LIVE_RING,
                              PICK_LONG_FRAMES, _fn, check_pick,
                              check_zero_row, edge_envelopes, edge_onsets,
                              file_batch, flux_emulated, mel_db_emulated,
                              onset_envelope_emulated, onset_passes_emulated,
                              onset_pick_emulated, padded_wave,
                              random_envelopes, riffs, scan_envelopes, stitch,
                              time_shards, libs_fixture)

libs = libs_fixture(("onset_envelope", "onset_pick"))


@pytest.mark.parametrize("n", [22050, 45000])
@pytest.mark.parametrize("padded", [False, True])
def test_onset_envelope_emulated(libs, n, padded):
    """44 and 88 frames (11 and 22 rounds of four per file); with a valid
    prefix the top_db peak reads the valid frames only."""
    y = torch.from_numpy(riffs(n))
    t = spectral.n_frames(n, 2048, 512)
    nvf = (torch.tensor([t, t - 5, 1 + int(0.6 * n) // 512]) if padded
           else None)
    got = onset_envelope_emulated(libs, y, nvf)
    ref = onset.onset_strength_plain(y, FILE_SR, n_valid_frames=nvf)
    torch.testing.assert_close(got, ref, atol=1e-3, rtol=0)
    assert float(ref.max()) > 1.0  # the tones give the flux real peaks


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("n", [22562, 23586])
def test_onset_envelope_emulated_batches(libs, b, n):
    """One file and four, at 45 and 47 frames: the last round of each
    file holds one or three frames, so an FFT runs with a zero partner,
    and a block's share of rounds crosses from one file to the next."""
    y, nvf = file_batch(n, b)
    got = onset_envelope_emulated(libs, y, nvf, grid=7)
    ref = onset.onset_strength_plain(y, FILE_SR, n_valid_frames=nvf)
    torch.testing.assert_close(got, ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("n", [45000, 88200])
def test_onset_kernels_emulated_zero_row(libs, n):
    """A padding row of n_valid 0 (one valid frame, its min equal to its
    max): K4 and K5 agree with their plain versions and give no onset."""
    y, nvf = padded_wave(n)
    env = onset_envelope_emulated(libs, y, nvf)
    check_zero_row(y, nvf, env, lambda e, v, c: onset_pick_emulated(
        libs, e, v, 64, c))


def test_onset_envelope_emulated_grid_invariant(libs):
    """The envelope is the same, bit for bit, whatever the first pass's
    grid: one block for all rounds, three, and more blocks than rounds
    (cut to one round each)."""
    y, nvf = file_batch(22562, 4)
    rounds = 4 * -(-spectral.n_frames(22562, 2048, 512) // 4)  # 4 files
    envs = [onset_envelope_emulated(libs, y, nvf, grid=g)
            for g in (1, 3, rounds + 1)]
    assert torch.equal(envs[0], envs[1]) and torch.equal(envs[0], envs[2])


@pytest.mark.parametrize("n,loud_tail", [(45000, False), (175616, False),
                                         (60000, True)])
def test_onset_mel_db_shards_stitch_to_envelope(libs, n, loud_tail):
    """`gat_onset_mel_db` over 4 shards that carry their left context and
    right halo (origin 0), stitched, gives `gat_onset_envelope`'s pre-clamp
    dB and peak bit for bit, and `gat_onset_flux` over the stitched rows
    its envelope; the plain halves stitch to `onset_strength_plain`.
    Each shard holds whole rounds of four frames, so every FFT pairs the
    frames the whole file's pass pairs: 88 frames in shards of 24, 344 in
    shards of 88; the loud tail puts the file's peak in its last frames,
    where the budget frames past the end would move it."""
    y = riffs(n)[0]
    if loud_tail:
        y = y * 0.05
        y[-400:] = 0.9
    t = spectral.n_frames(n, 2048, 512)
    env, db, peak = onset_passes_emulated(libs, torch.from_numpy(y)[None],
                                          None)
    shards = time_shards(y, 4)
    got_db, got_peak = stitch(
        [mel_db_emulated(libs, ext, frames, 0, nvf)
         for ext, frames, nvf in shards], t)
    assert torch.equal(got_db, db) and torch.equal(got_peak, peak)
    torch.testing.assert_close(flux_emulated(libs, got_db, got_peak), env,
                               atol=1e-6, rtol=0)
    ref = onset.onset_strength_plain(torch.from_numpy(y)[None], FILE_SR)
    torch.testing.assert_close(env, ref, atol=1e-3, rtol=0)
    plain_db, plain_peak = stitch(
        [onset.onset_mel_db_plain(ext, FILE_SR, origin=0, frames=frames,
                                  n_valid_frames=nvf)
         for ext, frames, nvf in shards], t)
    torch.testing.assert_close(onset.onset_flux_plain(plain_db, plain_peak),
                               ref, atol=1e-5, rtol=0)


def test_onset_passes_emulated_match_plain(libs):
    """The two entry points on their own against their plain versions, on
    centred files with valid prefixes: dB within 1e-3 where the plain dB
    is above -60, the peak keys' dB within 1e-3, the flux of the same
    rows within 1e-5."""
    y, nvf = file_batch(23586, 4)
    db, peak = mel_db_emulated(libs, y, spectral.n_frames(23586, 2048, 512),
                               -1024, nvf)
    ref_db, ref_peak = onset.onset_mel_db_plain(y, FILE_SR,
                                                n_valid_frames=nvf)
    loud = ref_db > -60.0
    torch.testing.assert_close(db[loud], ref_db[loud], atol=1e-3, rtol=0)
    torch.testing.assert_close(onset.key_value(peak),
                               onset.key_value(ref_peak), atol=1e-3, rtol=0)
    torch.testing.assert_close(flux_emulated(libs, ref_db, ref_peak),
                               onset.onset_flux_plain(ref_db, ref_peak),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(
        onset.onset_flux_plain(ref_db, ref_peak),
        onset.onset_strength_plain(y, FILE_SR, n_valid_frames=nvf),
        atol=1e-5, rtol=0)


def test_order_keys_keep_the_order():
    v = torch.tensor([-np.inf, -3.5, -0.0, 0.0, 1e-30, 2.0, np.inf],
                     dtype=torch.float32)
    k = onset.order_key(v)
    assert torch.equal(k, torch.sort(k).values)
    assert torch.equal(onset.key_value(k), v)
    assert int(onset.order_key(v[:1])) == onset._NEG_INF_KEY


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("padded", [False, True])
def test_onset_envelope_emulated_hop_1024(libs, b, padded):
    """The live path's shape: rings of 33,075 samples at hop 1024 (33
    frames, the first lag + 2048 / (2 * 1024) = 2 of them zero), one ring
    and a batch of 3, with and without valid prefixes."""
    y = torch.from_numpy(riffs(LIVE_RING)[:b])
    t = spectral.n_frames(LIVE_RING, 2048, 1024)
    nvf = torch.tensor([t, t - 5, 20][:b]) if padded else None
    got = onset_envelope_emulated(libs, y, nvf, hop=1024)
    ref = onset.onset_strength_plain(y, FILE_SR, hop_length=1024,
                                     n_valid_frames=nvf)
    assert got.shape == (b, 33)
    torch.testing.assert_close(got, ref, atol=1e-3, rtol=0)
    assert float(ref.max()) > 1.0 and not bool(got[:, :2].any())


def test_onset_envelope_attribute_only_grows(libs):
    """K4's occupancy query raises the first pass's shared-memory
    attribute and never lowers it: after hop 1024 (59,088 B at 365 mel
    items) a query at hop 512 (52,944 B) leaves 59,088 B, so a later
    launch at hop 1024, whose query is cached, still fits."""
    lib = libs["onset_envelope"]
    attr = ctypes.c_int.in_dll(lib, "emu_smem_attr")
    attr.value = 48 * 1024
    fn = _fn(lib, "gat_onset_envelope_blocks_per_sm",
             [ctypes.c_int] * 2 + [ctypes.c_void_p])
    n_items = onset._mel_items(FILE_SR, 128, CPU)[2]
    blocks = ctypes.c_int(-1)
    held = []
    for hop in (1024, 512, 1024):
        assert fn(n_items, hop, ctypes.addressof(blocks)) == 0
        held.append(attr.value)
    assert n_items == 365 and held == [59088] * 3


def test_mel_items_cover_the_filterbank():
    """K4's mel table gives every band exactly its nonzero bins and
    weights, in order, cut into runs of at most ceil(nnz / threads); each
    thread's items close where a band or its run ends."""
    _, _, fb, lo, hi = features._kernel_tables(FILE_SR, 128, False, CPU)
    tab, weights, n_items = onset._mel_items(FILE_SR, 128, CPU)
    tab, weights = tab.numpy(), weights.numpy()
    nnz = int((hi - lo).sum())
    run = -(-nnz // onset._THREADS)
    thread_first = tab[:onset._THREADS + 1]
    band_first = tab[onset._THREADS + 1:onset._THREADS + 130]
    codes = tab[onset._THREADS + 130:]
    assert len(codes) == len(weights) == nnz and run <= onset._MEL_RUN
    bins, ends = codes & 0xFFFF, codes >> 16
    edges = np.cumsum((hi - lo).numpy())
    np.testing.assert_array_equal(np.flatnonzero(ends) + 1, edges)
    for m in range(128):
        a = edges[m - 1] if m else 0
        np.testing.assert_array_equal(bins[a:edges[m]],
                                      np.arange(int(lo[m]), int(hi[m])))
        np.testing.assert_array_equal(weights[a:edges[m]],
                                      fb[m, lo[m]:hi[m]].numpy())
    # items: pieces of each thread's run split at band ends
    closes = ends.astype(bool) | (np.arange(nnz) % run == run - 1)
    closes[-1] = True
    assert n_items == int(closes.sum()) == thread_first[-1]
    np.testing.assert_array_equal(
        thread_first[:-(-nnz // run)],
        np.concatenate([[0], np.cumsum(closes)])[::run][:-(-nnz // run)])
    assert band_first[0] == 0 and band_first[-1] == n_items
    np.testing.assert_array_equal(np.diff(band_first),
                                  [int(closes[(edges[m - 1] if m else 0):
                                              edges[m]].sum())
                                   for m in range(128)])


@pytest.mark.parametrize("cand_budget", [None, 0, 3])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("backtrack", [True, False])
def test_onset_pick_emulated(libs, cand_budget, seed, backtrack):
    """All five outputs identical to the plain version, over full and
    short valid prefixes, with budgets that truncate (3 candidates, a
    4-onset cap) and that do not."""
    env = torch.from_numpy(random_envelopes(300, seed))
    nvf = torch.tensor([300, 211, 40])
    for max_onsets in (4, 64):
        got = onset_pick_emulated(libs, env, nvf, max_onsets, cand_budget,
                                  backtrack)
        ref = check_pick(got, env, nvf, max_onsets, cand_budget, backtrack)
        assert bool(ref[1].any())


@pytest.mark.parametrize("cand_budget", [None, 0, 3])
@pytest.mark.parametrize("backtrack", [True, False])
def test_onset_pick_emulated_long(libs, cand_budget, backtrack):
    """A 400 s envelope (17 tiles), over full and short valid prefixes:
    all five outputs identical to the plain version."""
    t = PICK_LONG_FRAMES
    env = torch.from_numpy(random_envelopes(t, 3))
    nvf = torch.tensor([t, t - 1500, 40])
    for max_onsets in (4, 64):
        got = onset_pick_emulated(libs, env, nvf, max_onsets, cand_budget,
                                  backtrack)
        check_pick(got, env, nvf, max_onsets, cand_budget, backtrack)


def test_onset_pick_emulated_any_length(libs):
    """20,000 frames, beyond what the first K5 could hold in a block's
    shared memory, are taken and picked as the plain version picks them;
    the occupancy query takes no length."""
    t = 20000
    env = torch.from_numpy(random_envelopes(t, 4))
    nvf = torch.tensor([t, 12345, 1])
    got = onset_pick_emulated(libs, env, nvf, 256, 0)
    assert bool(check_pick(got, env, nvf, 256, 0, True)[1].any())
    blocks = ctypes.c_int(-1)
    fn = _fn(libs["onset_pick"], "gat_onset_pick_blocks_per_sm",
             [ctypes.c_void_p])
    assert fn(ctypes.addressof(blocks)) == 0 and blocks.value == 0


@pytest.mark.parametrize("cand_budget", [None, 0])
def test_onset_pick_emulated_live_windows(libs, cand_budget):
    """K5 at the live path's windows, 22050 Hz at hop 1024: a moving max
    of size 1 (left 0), averages over 2 + 3 frames and a wait of 0, at
    the live min separation and 64 slots; 33-frame envelopes of live
    rings (K4's plain version) and random ones, with short valid
    prefixes."""
    assert onset._pick_windows(FILE_SR, 1024) == (1, 0, 2, 3, 0)
    rings = torch.from_numpy(riffs(LIVE_RING))
    env = torch.cat([onset.onset_strength_plain(rings, FILE_SR,
                                                hop_length=1024),
                     torch.from_numpy(random_envelopes(33, 5))])
    nvf = torch.tensor([33, 33, 20, 33, 25, 3])
    got = onset_pick_emulated(libs, env, nvf, 64, cand_budget, hop=1024,
                              min_sep=LIVE_MIN_SEP)
    ref = check_pick(got, env, nvf, 64, cand_budget, True, hop=1024,
                     min_sep=LIVE_MIN_SEP)
    assert bool(ref[1][0].any()) and bool(ref[1][1].any())


@pytest.mark.parametrize("cand_budget", [None, 0])
def test_onset_pick_emulated_scan_budget(libs, cand_budget):
    """K5 at the scan engine's budget: 8 slots, min_sep 0, 65 frames, so
    candidate_limit(65, 8, None) = 32; the dense row's walk is cut by
    both the candidate limit and the cap, and flags it."""
    assert onset.candidate_limit(65, 8, None) == 32
    env = torch.from_numpy(scan_envelopes())
    got = onset_pick_emulated(libs, env, None, 8, cand_budget, min_sep=0.0)
    ref = check_pick(got, env, None, 8, cand_budget, True, min_sep=0.0)
    assert bool(ref[2][-1]) and bool(ref[3][-1])
    if cand_budget is None:  # the limit truncated the dense row's walk
        full = onset.pick_onsets_plain(env, FILE_SR, 512, 0.0, 8,
                                       cand_budget=0)
        assert int(ref[4][-1]) < int(full[4][-1])


@pytest.mark.parametrize("t", [onset._PICK_TILE - 1, onset._PICK_TILE,
                               onset._PICK_TILE + 1])
@pytest.mark.parametrize("cand_budget", [None, 0, 3])
@pytest.mark.parametrize("backtrack", [True, False])
def test_onset_pick_emulated_tile_edges(libs, t, cand_budget, backtrack):
    """T at the tile size and one either side (one tile or two), with a
    candidate and a backtrack minimum on each side of a tile edge and no
    valid counts (all T frames): identical to the plain version, and the
    planted onsets are picked where the budget lets them be."""
    env = torch.from_numpy(edge_envelopes(t))
    for max_onsets in (4, 64):
        got = onset_pick_emulated(libs, env, None, max_onsets, cand_budget,
                                  backtrack)
        ref = check_pick(got, env, None, max_onsets, cand_budget, backtrack)
        if max_onsets == 64 and cand_budget != 3:
            for row, (dip, burst) in enumerate(edge_onsets(t)):
                frame = dip if backtrack else burst
                assert 512 * frame in ref[0][row][ref[1][row]].tolist()


def test_onset_pick_refuses_windows_past_halo(libs):
    """Peak-pick windows wider than the compiled halo are refused: the
    wrapper raises and the C entry point returns an error."""
    assert onset._pick_windows(FILE_SR, 512)[2] + 1 <= onset._PICK_HALO
    with pytest.raises(ValueError, match="halo"):
        onset._pick_windows(384000, 128)
    env = torch.zeros(1, 500)
    outs = onset._pick_outputs(1, 4, CPU)
    fn = _fn(libs["onset_pick"], "gat_onset_pick", onset._PICK_ARGS)
    assert fn(env.data_ptr(), None, *(o.data_ptr() for o in outs), 1, 500,
              2, 1, onset._PICK_HALO, 5, 0.07, 1, 512, 6615, 4, 500, 1,
              None) != 0


def test_pick_constants_match_kernel():
    """The wrapper's tile and halo are the kernel's."""
    src = (kernels.CSRC / "onset_pick.cu").read_text()
    assert re.search(rf"kTile = {onset._PICK_TILE};", src)
    assert re.search(rf"kHalo = {onset._PICK_HALO};", src)


def test_function_resolves_once(libs, monkeypatch):
    """`kernels.function` sets an entry point's argument types at its
    first resolve and hands the same object back after that."""
    monkeypatch.setitem(kernels._libs, "onset_pick", libs["onset_pick"])
    monkeypatch.setattr(kernels, "_functions", {})
    first = kernels.function("onset_pick", "gat_onset_pick", onset._PICK_ARGS)
    again = kernels.function("onset_pick", "gat_onset_pick", [])
    assert again is first and list(first.argtypes) == onset._PICK_ARGS
    assert first.restype is ctypes.c_int
    assert kernels._functions == {("onset_pick", "gat_onset_pick"): first}
