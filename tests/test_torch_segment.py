"""PyTorch port vs gat_tpu: the gating filters, the onset envelope and
pick, slicing and whole-file segmentation (CPU, plain versions).

Bounds, each with its reason:
* median filter, masked percentile, the onset pick's five outputs and
  the segmentation's onsets, valid, kept, times: identical (order
  statistics, integer walks, and float32 ops done in the same order);
* the frame RMS in dB: atol 1e-4 dB (means of 2048 squares summed in
  another order);
* the onset envelope: atol 1e-3 (its FFT and mel sums in another order);
* clips: atol 1e-6 (gathered samples, exact unless a window edge moves).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_tpu.ops import filters as jfl
from gat_tpu.ops import onset as jo
from gat_tpu.segment import gating as jg
from gat_tpu.segment import slicing as js
from gat_tpu_torch.ops import filters as tfl
from gat_tpu_torch.ops import onset as to
from gat_tpu_torch.segment import gating as tg
from gat_tpu_torch.segment import slicing as ts
from emulated_kernels import (RIFF_NOTES as NOTES,
                              pluck_riff, random_envelopes)

SR = 22050


def riff(sr: int = SR, dur: float = 3.9, notes=NOTES) -> np.ndarray:
    """A2 D3 G3 B3 E4 plucked from 0.4 s, 0.7 s apart."""
    return pluck_riff(sr, dur, notes)


@pytest.mark.parametrize("size", [4, 5])
def test_median_filter_with_ties(size):
    rng = np.random.default_rng(size)
    x = rng.integers(0, 4, (3, 23)).astype(np.float32)  # many ties
    ref = np.asarray(jfl.median_filter1d(jnp.asarray(x), size))
    got = tfl.median_filter1d(torch.from_numpy(x), size).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("q", [20.0, 75.0, 50.0])
def test_masked_percentile(q):
    rng = np.random.default_rng(int(q))
    x = rng.normal(-40, 10, (4, 31)).astype(np.float32)
    mask = np.arange(31)[None, :] < np.array([31, 17, 1, 0])[:, None]
    ref = np.asarray(jfl.masked_percentile(jnp.asarray(x), q,
                                           jnp.asarray(mask)))
    got = tfl.masked_percentile(torch.from_numpy(x), q,
                                torch.from_numpy(mask)).numpy()
    assert np.isnan(got[3]) and np.isnan(ref[3])  # an empty mask
    np.testing.assert_array_equal(got, ref)


def _jax_rows(fn, *rows):
    return np.stack([np.asarray(fn(*(jnp.asarray(r[i]) for r in rows)))
                     for i in range(len(rows[0]))])


@pytest.mark.parametrize("nv", [[88200, 60001, 1500], [40000, 2047, 300]])
def test_rms_db_envelope_n_valid(nv):
    """A valid region shorter than the frame (2047, 1500, 300 samples)
    has no exact counterpart; both packages mirror zeros there."""
    y = np.stack([riff(dur=4.0)] * 3)
    ref = _jax_rows(lambda a, b: jg.rms_db_envelope(a, n_valid_samples=b),
                    y, np.asarray(nv))
    got = tg.rms_db_envelope(torch.from_numpy(y),
                             n_valid=torch.tensor(nv)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_rms_gate_padded_equals_exact():
    """A zero-padded row gives bit-identical gated samples on its valid
    region to its exact-length signal."""
    y = riff(dur=3.9)
    n = len(y)
    exact = tg.rms_gate(torch.from_numpy(y)[None])[0]
    padded = torch.from_numpy(np.pad(y, (0, 4000)))[None]
    got = tg.rms_gate(padded, n_valid=torch.tensor([n]))[0]
    assert torch.equal(got[:n], exact)
    assert not bool(got[n:].any())


def test_gate_waveform_matches():
    y = riff(dur=3.0) + np.random.default_rng(1).normal(
        0, 0.003, int(3.0 * SR)).astype(np.float32)
    ref = np.asarray(jg.gate_waveform(jnp.asarray(y), -32.5,
                                      n_valid_samples=jnp.asarray(60000)))
    got = tg.gate_waveform(torch.from_numpy(y)[None], -32.5,
                           n_valid=torch.tensor([60000]))[0].numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("padded", [False, True])
def test_onset_strength_matches(padded):
    y = np.stack([riff(dur=3.0), riff(dur=3.0, notes=NOTES[1:])])
    t = 1 + y.shape[1] // 512
    nvf = np.array([t, 70])
    valid = (np.arange(t)[None, :] < nvf[:, None]) if padded else None
    ref = np.asarray(jo.onset_strength(
        jnp.asarray(y), SR,
        valid_frames=None if valid is None else jnp.asarray(valid)))
    got = to.onset_strength(torch.from_numpy(y), SR,
                            n_valid_frames=torch.from_numpy(nvf)
                            if padded else None).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("cand_budget", [None, 0, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pick_onsets_matches(cand_budget, seed):
    env = random_envelopes(260, seed)
    nvf = np.array([260, 190, 23])
    valid = np.arange(260)[None, :] < nvf[:, None]
    for max_onsets in (4, 64):
        pick = jax.jit(jax.vmap(functools.partial(
            jo.pick_onsets_from_envelope, sr=SR, hop_length=512,
            min_sep=0.3, max_onsets=max_onsets, cand_budget=cand_budget)))
        ref = pick(jnp.asarray(env), valid_frames=jnp.asarray(valid))
        got = to.pick_onsets(torch.from_numpy(env), SR, 512, 0.3,
                             max_onsets, n_valid_frames=torch.from_numpy(nvf),
                             cand_budget=cand_budget)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("backtrack", [True, False])
def test_pick_onsets_matches_long(backtrack):
    """A 400 s envelope, 17,227 frames: the length the first K5 refused.
    The mean-centred prefix sum keeps the moving average exact there."""
    t = 1 + 400 * SR // 512
    env = random_envelopes(t, 5)
    nvf = np.array([t, t - 2000, 500])
    valid = np.arange(t)[None, :] < nvf[:, None]
    pick = jax.jit(jax.vmap(functools.partial(
        jo.pick_onsets_from_envelope, sr=SR, hop_length=512, min_sep=0.3,
        max_onsets=512, backtrack=backtrack, cand_budget=0)))
    ref = pick(jnp.asarray(env), valid_frames=jnp.asarray(valid))
    got = to.pick_onsets(torch.from_numpy(env), SR, 512, 0.3, 512, backtrack,
                         n_valid_frames=torch.from_numpy(nvf), cand_budget=0)
    assert int(np.asarray(ref[4]).min()) >= 20
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_greedy_walk_keeps_samples_in_order():
    """The kept samples leave the walk nondecreasing (bt is a cummax and
    min_samples >= 0), which is why K5 writes them without a sort."""
    for seed in range(20):
        env = torch.from_numpy(random_envelopes(400, seed))
        valid = torch.ones_like(env, dtype=torch.bool)
        bt = to.backtrack_indices(env, valid).numpy()
        for row in range(3):
            frames = np.flatnonzero(env[row].numpy() > 0.3).tolist()
            for min_samples in (0, 6615):
                kept, _, _ = to.greedy_walk(
                    frames, [int(bt[row, i]) * 512 for i in frames], 1,
                    min_samples)
                assert kept == sorted(kept)


def test_candidate_budget_validation():
    with pytest.raises(ValueError, match="cand_budget"):
        to.candidate_limit(100, 64, -1)
    assert to.candidate_limit(100, 64, 0) == 100
    assert to.candidate_limit(100, 64, None) == 100
    assert to.candidate_limit(4000, 64, None) == 1000
    assert to.candidate_limit(4000, 64, 7) == 7


def _segment_jax(y, nv, **kw):
    outs = [js.segment_waveform(jnp.asarray(y[i]), sr=SR,
                                n_valid_samples=jnp.asarray(nv[i]), **kw)
            for i in range(len(y))]
    return [np.stack([np.asarray(o[j]) for o in outs])
            for j in range(len(outs[0]))]


@pytest.mark.parametrize("kw", [{}, {"max_onsets": 3, "cand_budget": 2},
                                {"strict_reference_compat": False}])
def test_segment_waveform_matches(kw):
    y = np.stack([riff(dur=4.0), np.pad(riff(dur=3.0), (0, SR))])
    nv = np.array([len(y[0]), 3 * SR])
    ref = _segment_jax(y, nv, **kw)
    got = ts.segment_waveform(torch.from_numpy(y), sr=SR,
                              n_valid=torch.from_numpy(nv), **kw)
    names = ("clips", "kept", "onsets", "onsets_valid", "times", "overflow",
             "cap_overflow", "n_detected")
    for name, g, r in zip(names, got, ref):
        if name == "clips":
            np.testing.assert_allclose(g.numpy(), r, atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    assert got[1].sum() >= 2


def test_slice_skip_past_the_end():
    """An attack skip longer than the signal: every clip is empty and
    dropped, in both packages."""
    y = np.ones((1, 1000), np.float32)
    onsets = np.array([[0, 512]], np.int32)
    valid = np.array([[True, True]])
    clips, kept, times = ts.slice_at_onsets(
        torch.from_numpy(y), torch.from_numpy(onsets),
        torch.from_numpy(valid), sr=SR)
    jc, jk, jt = js.slice_at_onsets(jnp.asarray(y[0]), jnp.asarray(onsets[0]),
                                    jnp.asarray(valid[0]), sr=SR,
                                    onset_hop=512)
    np.testing.assert_array_equal(clips[0].numpy(), np.asarray(jc))
    np.testing.assert_array_equal(kept[0].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(times[0].numpy(), np.asarray(jt))
    assert not bool(kept.any())


def test_save_clip_names(tmp_path):
    ts.save_clip(torch.zeros(100), SR, tmp_path, 3, 1.23456, "riff")
    assert [p.name for p in tmp_path.iterdir()] == ["0003_riff__1.235s.wav"]


def test_audio_slicer_slice_and_save_matches(tmp_path):
    """`AudioSlicer.slice_and_save` of a 44.1 kHz WAV (resampled to 22050
    Hz on load): the same onsets, the same clip file names, and clips
    within 1e-5 of the JAX slicer's; the last onset's clip is dropped in
    both (the reference slicer's rule)."""
    from gat_tpu_torch.utils.wavio import read_wav, write_wav
    path = tmp_path / "riff.wav"
    write_wav(path, pluck_riff(44100, 3.0, NOTES[:4]), 44100)
    got = ts.AudioSlicer(device="cpu").slice_and_save(
        path, tmp_path / "port", verbose=False)
    ref = js.AudioSlicer().slice_and_save(path, tmp_path / "jax",
                                          verbose=False)
    assert got == ref and len(got) == 4
    names = sorted(p.name for p in (tmp_path / "port").glob("*.wav"))
    assert names == sorted(p.name for p in (tmp_path / "jax").glob("*.wav"))
    assert len(names) == 3 and names[0].startswith("0000_clip__")
    for name in names:
        a, _ = read_wav(tmp_path / "port" / name)
        b, _ = read_wav(tmp_path / "jax" / name)
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert ts.AudioSlicer.sliceNsave is ts.AudioSlicer.slice_and_save


def test_audio_slicer_methods_match(tmp_path):
    """load_wav, both gates, detect_onsets (with its overflow warning) and
    the loudness check against the JAX slicer's."""
    from gat_tpu_torch.utils.wavio import write_wav
    path = tmp_path / "riff.wav"
    write_wav(path, pluck_riff(22050, 3.0, NOTES[:4]), 22050)
    port, ref = ts.AudioSlicer(device="cpu"), js.AudioSlicer()
    y, sr = port.load_wav(path)
    y_ref, sr_ref = ref.load_wav(path)
    assert sr == sr_ref == 11025 and y.dtype == np.float32
    np.testing.assert_allclose(y, y_ref, atol=1e-5)
    np.testing.assert_allclose(port.apply_db_threshold(y),
                               ref.apply_db_threshold(y), atol=1e-6)
    np.testing.assert_allclose(port.apply_rms_threshold(y),
                               ref.apply_rms_threshold(y), atol=1e-6)
    assert port.detect_onsets(y) == ref.detect_onsets(y)
    with pytest.warns(UserWarning, match="budget"):
        capped = port.detect_onsets(y, max_onsets=2)
    with pytest.warns(UserWarning, match="budget"):
        capped_ref = ref.detect_onsets(y, max_onsets=2)
    assert capped == capped_ref == ref.detect_onsets(y)[:2]
    for clip in (y[:5512], 1e-4 * y[:5512]):
        assert (port.is_slice_loud_enough(clip)
                == ref.is_slice_loud_enough(clip))
