"""The emulated-kernel tests of K7, the noise gate, and K8, the clip
slicer: the kernels' own source compiled by g++ under
`emulated_kernels.EMULATION_HEADER`, against their plain PyTorch
versions."""
import ctypes

import numpy as np
import pytest
import torch

from gat_tpu_torch.ops import onset
from gat_tpu_torch.segment import gating, slicing

from emulated_kernels import (FILE_SR, GATE_MIN_DB, GATE_PINS, SLICE_PINS,
                              SLICE_PINS_PAST_ROW, _digest, _fn, check_gate,
                              check_slice, gate_counts, gate_rows,
                              noise_gate_emulated, onset_rows, pass_blocks,
                              past_row_inputs, pin_inputs,
                              slice_clips_emulated, libs_fixture)

libs = libs_fixture(("noise_gate", "slice_clips"))


@pytest.mark.parametrize("hop", [512, 256, 700])
@pytest.mark.parametrize("counted", [True, False])
@pytest.mark.parametrize("min_db", [GATE_MIN_DB, None])
def test_noise_gate_emulated(libs, hop, counted, min_db):
    """K7 against `gate_parts_plain` (gate_waveform with min_db, rms_gate
    without) on 2 s rows with valid counts 0, 1000, 2047, 2048, 5000 and
    the row (or none), at hop 512, 256 and 700 (runs of 21, 41 and 15
    frames), at the bounds of `check_gate`."""
    n = 2 * FILE_SR
    y = torch.from_numpy(gate_rows(n))
    nv = torch.from_numpy(gate_counts(n)) if counted else None
    got = noise_gate_emulated(libs, y, nv, min_db, hop)
    ref = gating.gate_parts_plain(y, min_db, hop, nv)
    check_gate(got, ref, y, min_db, hop)
    assert bool(got["out"].any())
    if counted:
        assert not bool(got["out"][0].any())


@pytest.mark.parametrize("n", [44100, 44104, 44101])
def test_noise_gate_emulated_vector_path(libs, n):
    """Rows whose length is a multiple of 4 take the 16-byte apply path,
    others (44101) the scalar one; both give the plain gate."""
    y = torch.from_numpy(gate_rows(n, seed=n)[:3])
    nv = torch.tensor([n, 30001, 2048])
    check_gate(noise_gate_emulated(libs, y, nv, GATE_MIN_DB),
               gating.gate_parts_plain(y, GATE_MIN_DB, 512, nv), y,
               GATE_MIN_DB, 512)


def test_noise_gate_emulated_grid_invariant(libs):
    """The gate does not depend on its grid: 1 block, 5, and more than
    there are runs of frames give the same bits."""
    n = 2 * FILE_SR
    y = torch.from_numpy(gate_rows(n)[:2])
    nv = torch.tensor([n, 30000])
    first = noise_gate_emulated(libs, y, nv, GATE_MIN_DB, grid=1)
    for grid in (5, 64):
        again = noise_gate_emulated(libs, y, nv, GATE_MIN_DB, grid=grid)
        assert all(torch.equal(first[k], again[k]) for k in first)


@pytest.mark.parametrize("hop", [4096, 20000])
def test_noise_gate_emulated_long_hops(libs, hop):
    """Hops past the stage's room: runs of 3 frames, then of 1 frame."""
    n = 3 * FILE_SR
    y = torch.from_numpy(gate_rows(n)[:2])
    nv = torch.tensor([n, 40000])
    check_gate(noise_gate_emulated(libs, y, nv, GATE_MIN_DB, hop),
               gating.gate_parts_plain(y, GATE_MIN_DB, hop, nv), y,
               GATE_MIN_DB, hop)


def test_noise_gate_emulated_percentile_ties(libs):
    """Envelopes with long runs of equal frames (a row of silence and a
    row of a held level under a step): the order statistics at and
    next to the 20th percentile come from a run of equal keys."""
    n = 2 * FILE_SR
    y = np.zeros((3, n), np.float32)
    y[1] = 0.25
    y[1, n // 2:] = 0.5
    y[2] = np.sign(np.sin(np.arange(n) / 7.0)) * 0.1
    y = torch.from_numpy(y)
    nv = torch.tensor([n, n, 33333])
    for min_db in (GATE_MIN_DB, None):
        got = noise_gate_emulated(libs, y, nv, min_db)
        ref = gating.gate_parts_plain(y, min_db, 512, nv)
        check_gate(got, ref, y, min_db, 512)
        assert torch.equal(got["gate_db"], ref["gate_db"])


@pytest.mark.parametrize("hop, counted, min_db", list(GATE_PINS))
def test_noise_gate_emulated_pins(libs, hop, counted, min_db):
    """K7 gives the bits its first design gave: gate_db, the frame mask and
    the gated rows bit-equal to the pins, and the envelope and its median
    too (hop blocks summed in fp64 give each frame's float32 sum of its
    2048 squares as a warp per frame did)."""
    n = 2 * FILE_SR
    y = torch.from_numpy(gate_rows(n))
    nv = torch.from_numpy(gate_counts(n)) if counted else None
    got = noise_gate_emulated(libs, y, nv, min_db, hop)
    keys = ("gate_db", "frame_mask", "out", "env", "med")
    assert tuple(_digest(got[k]) for k in keys) == GATE_PINS[
        (hop, counted, min_db)]


@pytest.mark.parametrize("n", [gating.GATE_STAGED_FRAMES - 1,
                               gating.GATE_STAGED_FRAMES])
def test_noise_gate_emulated_threshold_in_device_memory(libs, n):
    """At hop 1 the threshold pass stages 24,576 frames in shared memory
    (the row of 24,575 samples) and keeps 24,577 in device memory (one
    sample more): both give the plain gate at `check_gate`'s bounds, with
    1024 threads a file."""
    y = torch.from_numpy(gate_rows(n, seed=7)[:2])
    nv = torch.tensor([n, 20001])
    assert pass_blocks(libs, n, 1)[3:] == [
        1024, int(n < gating.GATE_STAGED_FRAMES)]
    check_gate(noise_gate_emulated(libs, y, nv, GATE_MIN_DB, 1),
               gating.gate_parts_plain(y, GATE_MIN_DB, 1, nv), y,
               GATE_MIN_DB, 1)


def test_noise_gate_emulated_pass_blocks(libs):
    """The passes' query refuses hop 0 and n 0. The threshold block has 256
    threads up to 2,048 frames, then twice as many while a thread would
    hold more than 8 frames, 1024 at most; it stages the envelope in
    shared memory up to `GATE_STAGED_FRAMES` frames (192 KB with the
    median): the file path's 2 s file, serving wave and 400 s riff at hop
    512, the riff at hop 128 (past the limit) and hop 700."""
    for n, hop, threads in ((44100, 512, 256), (1048064, 512, 256),
                            (1048576, 512, 512), (1323000, 512, 512),
                            (8820000, 512, 1024), (8820000, 128, 1024),
                            (44100, 700, 256)):
        staged = int(1 + n // hop <= gating.GATE_STAGED_FRAMES)
        assert pass_blocks(libs, n, hop) == [0, 0, 0, threads, staged]
    assert pass_blocks(libs, 8820000, 128)[4] == 0
    assert gating.GATE_STAGED_FRAMES * 8 == 192 * 1024
    fn = _fn(libs["noise_gate"], "gat_noise_gate_pass_blocks",
             [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    out = (ctypes.c_int * 5)()
    assert fn(44100, 0, ctypes.addressof(out)) != 0
    assert fn(0, 512, ctypes.addressof(out)) != 0


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_noise_gate_emulated_unaligned_rows(libs, offset):
    """Rows of an odd length at a pointer 1-3 floats past 16-byte
    alignment: the rms pass shifts its stages to the rows' phase and the
    apply pass takes its scalar path; the bits are those of the same rows
    at an aligned pointer, and the plain gate's at `check_gate`'s
    bounds."""
    n = 44101
    y = torch.from_numpy(gate_rows(n, seed=offset)[:3])
    nv = torch.tensor([n, 30001, 2048])
    buf = torch.empty(3 * n + 4)
    moved = buf[offset:offset + 3 * n].view(3, n)
    moved.copy_(y)
    assert moved.data_ptr() % 16 == 4 * offset
    got = noise_gate_emulated(libs, moved, nv, GATE_MIN_DB)
    aligned = noise_gate_emulated(libs, y, nv, GATE_MIN_DB)
    assert all(torch.equal(got[k], aligned[k]) for k in got)
    check_gate(got, gating.gate_parts_plain(y, GATE_MIN_DB, 512, nv), y,
               GATE_MIN_DB, 512)


def test_noise_gate_emulated_sample_gate_band(libs):
    """Samples swept across min_db from 0.05 dB below to 0.05 dB above, in
    steps of 1e-4 dB: inside the 0.01 dB band the kernel takes the log10,
    outside it the amplitude alone decides; every sample farther than
    1e-4 dB from min_db takes the formula's decision, on both sides of
    the band's edges."""
    n = 4 * 4096
    db = GATE_MIN_DB + np.linspace(-0.05, 0.05, n)
    amp = (10.0 ** (db / 20.0)).astype(np.float32)
    sign = np.where(np.arange(n) % 2, -1.0, 1.0).astype(np.float32)
    y = torch.from_numpy(np.stack([amp * sign, amp[::-1] * sign]))
    nv = torch.tensor([n, n])
    got = noise_gate_emulated(libs, y, nv, GATE_MIN_DB)
    ref = gating.gate_parts_plain(y, GATE_MIN_DB, 512, nv)
    check_gate(got, ref, y, GATE_MIN_DB, 512)
    kept = gating.sample_db_gate(y, GATE_MIN_DB) != 0
    assert 0 < int(kept.sum()) < y.numel()


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("onset_hop", [None, 512])
@pytest.mark.parametrize("counted", [True, False])
def test_slice_clips_emulated(libs, strict, onset_hop, counted):
    """K8 against `slice_at_onsets_plain` on 3 s rows, both gathers, both
    last-note rules, valid counts short of the rows (clips cut and
    refused there) or none."""
    n = 3 * FILE_SR
    y = torch.from_numpy(gate_rows(n)[:3])
    onsets, valid = onset_rows(n, onset_hop is not None)
    nv = torch.tensor([n, n - 3000, 40000]) if counted else None
    got = slice_clips_emulated(libs, y, onsets, valid, nv, strict, onset_hop)
    ref = slicing.slice_at_onsets_plain(y, onsets, valid, FILE_SR,
                                        0.5, 0.01, -40.0, strict,
                                        onset_hop=onset_hop, n_valid=nv)
    check_slice(got, ref)
    assert bool(ref[1].any()) and not bool(ref[1].all())


def test_slice_clips_emulated_on_detected_onsets(libs):
    """K8 on the onsets the plain detection finds in the gated riffs, as
    `segment_waveform` hands them over (hop 512, 112 slots mostly
    empty), padding rows of n_valid 0 and 1500 among the rows."""
    n = 3 * FILE_SR
    y = torch.from_numpy(gate_rows(n)[:4])
    nv = torch.tensor([n, 50001, 0, 1500])
    gated = gating.gate_waveform_plain(y, GATE_MIN_DB, n_valid=nv)
    onsets, valid, *_ = onset.detect_onsets(gated, sr=FILE_SR, min_sep=0.25,
                                            max_onsets=16, n_valid=nv)
    assert int(valid.sum()) >= 6 and not bool(valid[2:].any())
    for strict in (True, False):
        got = slice_clips_emulated(libs, y, onsets, valid, nv, strict, 512)
        ref = slicing.slice_at_onsets_plain(y, onsets, valid, FILE_SR, 0.5,
                                            0.01, -40.0, strict,
                                            onset_hop=512, n_valid=nv)
        check_slice(got, ref)


def test_slice_clips_emulated_edges(libs):
    """A skip past the row (every clip empty), a clip longer than the row,
    unaligned onsets with the row gather (the reference's rows, not the
    samples), negative and past-the-end onsets, and a row with no valid
    slot: the plain slicer's outputs."""
    y = torch.from_numpy(gate_rows(3000)[:2])
    onsets = torch.tensor([[-700, 3, 1500, 2999], [100, 200, 5000, 900]],
                          dtype=torch.int32)
    valid = torch.tensor([[True, True, True, True], [False] * 4])
    for skip_sec, length_sec, hop in ((0.2, 0.5, 512), (0.0, 0.2, None),
                                      (0.001, 0.2, 512), (0.0, 0.01, 7)):
        for strict in (True, False):
            got = slice_clips_emulated(libs, y, onsets, valid, None, strict,
                                       hop, length_sec, skip_sec)
            ref = slicing.slice_at_onsets_plain(
                y, onsets, valid, FILE_SR, length_sec, skip_sec, -40.0,
                strict, onset_hop=hop)
            check_slice(got, ref)


@pytest.mark.parametrize("length_sec, onset_hop, strict", list(SLICE_PINS))
def test_slice_clips_emulated_pins(libs, length_sec, onset_hop, strict):
    """K8 gives the bits its first design gave on `pin_inputs`: clips of
    0.5 s (shorter than the stage ring, odd) and 4.0 s (seven times the
    ring) by both gathers and both last-note rules; and the plain
    slicer's at `check_slice`'s bounds."""
    y, onsets, valid, nv = pin_inputs(length_sec, onset_hop)
    assert y.data_ptr() % 16 == 0
    got = slice_clips_emulated(libs, y, onsets, valid, nv, strict, onset_hop,
                               length_sec)
    check_slice(got, slicing.slice_at_onsets_plain(
        y, onsets, valid, FILE_SR, length_sec, 0.01, -40.0, strict,
        onset_hop=onset_hop, n_valid=nv))
    assert tuple(_digest(t) for t in got) == SLICE_PINS[
        (length_sec, onset_hop, strict)]


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_slice_clips_emulated_unaligned_rows(libs, offset):
    """Rows at a pointer 1-3 floats past 16-byte alignment, windows from
    the tensor's first sample to its last: the staged route reads the
    floats its copies' rounding would take from outside the tensor one at
    a time; the bits are those of the same rows at an aligned pointer,
    and the plain slicer's at `check_slice`'s bounds."""
    n = 3001
    y = torch.from_numpy(gate_rows(n, seed=offset)[:2])
    onsets = torch.tensor([[0, 1, 1500, 2000], [0, 700, 2990, 2999]],
                          dtype=torch.int32)
    valid = torch.ones(2, 4, dtype=torch.bool)
    buf = torch.empty(2 * n + 4)
    moved = buf[offset:offset + 2 * n].view(2, n)
    moved.copy_(y)
    assert moved.data_ptr() % 16 == 4 * offset
    for hop, strict in ((None, False), (1, True)):
        got = slice_clips_emulated(libs, moved, onsets, valid, None, strict,
                                   hop, 0.1, 0.0)
        aligned = slice_clips_emulated(libs, y, onsets, valid, None, strict,
                                       hop, 0.1, 0.0)
        assert all(torch.equal(a, b) for a, b in zip(got, aligned))
        check_slice(got, slicing.slice_at_onsets_plain(
            y, onsets, valid, FILE_SR, 0.1, 0.0, -40.0, strict,
            onset_hop=hop))


@pytest.mark.parametrize("onset_hop, strict", list(SLICE_PINS_PAST_ROW))
def test_slice_clips_emulated_pins_past_the_row(libs, onset_hop, strict):
    """A valid count past the row's end opens windows that cross it: K8
    reads them as the plain slicer does (clamped, never a sample past the
    row) and gives its first design's bits."""
    y, onsets, valid, nv = past_row_inputs(onset_hop)
    got = slice_clips_emulated(libs, y, onsets, valid, nv, strict, onset_hop,
                               0.1)
    check_slice(got, slicing.slice_at_onsets_plain(
        y, onsets, valid, FILE_SR, 0.1, 0.01, -40.0, strict,
        onset_hop=onset_hop, n_valid=nv))
    assert tuple(_digest(t) for t in got) == SLICE_PINS_PAST_ROW[
        (onset_hop, strict)]


def test_slice_clips_ring_fits_shared_memory(libs):
    """K8's ring (`gat_slice_clips_ring`): a 0.5 s clip at 22050 Hz is in
    flight at once, a 4.0 s one goes round it, and the block's static
    shared memory stays within 48 KB and leaves 4 blocks an SM room."""
    shape = [ctypes.c_int(0) for _ in range(3)]
    assert _fn(libs["slice_clips"], "gat_slice_clips_ring",
               [ctypes.c_void_p] * 3)(*map(ctypes.addressof, shape)) == 0
    stages, chunk, smem = (v.value for v in shape)
    assert stages >= 2 and chunk % 4 == 0
    assert stages * chunk >= int(0.5 * FILE_SR)
    assert stages * chunk < int(4.0 * FILE_SR)
    assert 4 * stages * chunk < smem <= 48 * 1024
    assert 4 * (smem + 1024) <= 228 * 1024


def test_gate_and_slice_occupancy_and_guards(libs):
    """K7's occupancy query takes every hop of 1 or more and refuses 0,
    as its launch and the wrapper's guard do (the guard names the
    limit); K8's shared memory is fixed, its query has no size. Both
    wrappers' other guards name what they refuse, and the C entry points
    refuse the same."""
    blocks = ctypes.c_int(-1)
    q7 = _fn(libs["noise_gate"], "gat_noise_gate_blocks_per_sm",
             [ctypes.c_int, ctypes.c_void_p])
    assert q7(1, ctypes.addressof(blocks)) == 0 and blocks.value == 0
    assert q7(0, ctypes.addressof(blocks)) != 0
    q8 = _fn(libs["slice_clips"], "gat_slice_clips_blocks_per_sm",
             [ctypes.c_void_p])
    blocks.value = -1
    assert q8(ctypes.addressof(blocks)) == 0 and blocks.value == 0
    with pytest.raises(ValueError, match="hop_length must be >= 1"):
        gating.check_gate(44100, 0, True)
    with pytest.raises(ValueError, match="more than 1024 samples"):
        gating.check_gate(1024, 512, False)
    gating.check_gate(1025, 1, False)
    gating.check_gate(1, 512, True)
    with pytest.raises(ValueError, match="1 or more samples"):
        slicing.check_slice(1, 4, 0, 0, 512)
    with pytest.raises(ValueError, match="onset_hop must be >= 1"):
        slicing.check_slice(1, 4, 100, 0, 0)
    y = torch.zeros(1, 4096)
    fn = _fn(libs["noise_gate"], "gat_noise_gate", gating._GATE_ARGS)
    ws = torch.empty(64)
    assert fn(y.data_ptr(), y.data_ptr(), None, ws.data_ptr(),
              ws.data_ptr(), ws.data_ptr(), ws.data_ptr(), 1, 4096, 0, 1,
              -45.0, 3, None) != 0
    fn = _fn(libs["slice_clips"], "gat_slice_clips", slicing._SLICE_ARGS)
    ons = torch.zeros(1, 4, dtype=torch.int32)
    assert fn(y.data_ptr(), ons.data_ptr(), ons.data_ptr(), None,
              ws.data_ptr(), ws.data_ptr(), ws.data_ptr(), 1, 4096, 4, 0,
              0, 512, 1, -40.0, 1.0 / FILE_SR, None) != 0
