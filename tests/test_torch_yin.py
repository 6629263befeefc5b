"""PyTorch port vs gat_tpu: YIN (CPU; both take the FFT route).

One known near-tie is pinned: the 880 Hz pluck karplus_strong(880.03,
11025, 0.5, seed=41) holds, in one frame, two CMND troughs whose order
flips under any change of summation order. JAX picks the trough that gives
945.3 Hz for that frame and the clip's median; the port's FFT route gives
1002.3 Hz, which a float64 YIN confirms. The CUDA kernel sums its lags in
yet another order and lands on a third value. Every other clip is held to
rtol 2e-3."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_tpu.data.synth import karplus_strong
from gat_tpu.ops import spectral as js
from gat_tpu.ops import yin as jy
from gat_tpu_torch.ops import spectral as ts
from gat_tpu_torch.ops import yin as ty
from tests.test_torch_spectral import pluck_clips

SR = 11025
NEAR_TIE = 41   # index of the 880 Hz pluck (seed 41) in pluck_clips


def _frames(clips):
    pad = js._pad_center(jnp.asarray(clips), 1024, "constant")
    return np.array(js.frame(pad, 2048, 512))


@pytest.fixture(scope="module")
def plucks():
    return pluck_clips(0.0)


def test_periods():
    assert ty.yin_periods(SR, 50.0, 1000.0, 2048, 1024) == (11, 221)


@pytest.mark.parametrize("noise", [0.1, 0.03])
def test_cmnd_matches(noise):
    """The CMND agrees to 1e-4 where noise keeps d(τ) off zero. On a
    noise-free periodic frame d(τ) at the period is a difference of
    numbers 1e5 times larger, and both fp32 versions stray from the
    float64 CMND by up to 0.1 there; the pitch tests below cover those
    clips."""
    frames = _frames(pluck_clips(noise))
    ref = np.asarray(jy._cmnd(jnp.asarray(frames), 2048, 1024, 11, 221))
    got = ty._cmnd(torch.from_numpy(frames), 2048, 1024, 11, 221).numpy()
    assert got.shape == ref.shape == (47, 11, 211)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("noise", [0.0, 0.1])
def test_f0_from_jax_cmnd_identical(noise):
    """Fed JAX's own CMND, the port picks the same trough in every frame
    (any other trough moves f0 by at least 1/221 relative)."""
    frames = _frames(pluck_clips(noise))
    cmnd = np.array(jy._cmnd(jnp.asarray(frames), 2048, 1024, 11, 221))
    ref = np.asarray(jy._f0_from_cmnd(jnp.asarray(cmnd), 11, 0.1, SR))
    got = ty._f0_from_cmnd(torch.from_numpy(cmnd), 11, 0.1, SR).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_f0_trough_rules():
    """Position 0 is a trough iff c0 < c1; no trough below the threshold
    falls back to the first global minimum; edges get no shift."""
    c = np.array([[0.05, 0.06, 0.5, 0.04, 0.3],     # position 0 trough
                  [0.5, 0.4, 0.3, 0.2, 0.2],        # min at 3 (first)
                  [0.9, 0.8, 0.7, 0.6, 0.5],        # min at right edge
                  [0.5, 0.09, 0.5, 0.08, 0.5]],     # first trough wins
                 np.float32)
    ref = np.asarray(jy._f0_from_cmnd(jnp.asarray(c), 11, 0.1, SR))
    got = ty._f0_from_cmnd(torch.from_numpy(c), 11, 0.1, SR).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("noise", [0.0, 0.1])
def test_yin_pitch_plucks(noise):
    clips = pluck_clips(noise)
    ref = np.asarray(jy.yin_pitch(clips, SR))
    got = ty.yin_pitch(torch.from_numpy(clips), SR).numpy()
    keep = np.ones(47, bool)
    if noise == 0.0:
        keep[NEAR_TIE] = False
    np.testing.assert_allclose(got[keep], ref[keep], rtol=2e-3)


def test_yin_near_tie_pinned():
    """The stated near-tie: one frame's two troughs swap order, so the
    median lands on another frame value. The 65th feature then differs by
    log10(1002.3/945.3) = 0.025."""
    x = karplus_strong(880.03, SR, 0.5, seed=41)
    ref = float(np.asarray(jy.yin_pitch(x, SR))[0])
    got = float(ty.yin_pitch(torch.from_numpy(x), SR).numpy()[0])
    assert ref == pytest.approx(945.325, rel=1e-4)
    assert got == pytest.approx(1002.273, rel=1e-4)
    f_ref = np.asarray(jy.yin(x, sr=SR))[0]
    f_got = ty.yin(torch.from_numpy(x), sr=SR).numpy()[0]
    assert int(np.sum(np.abs(f_got - f_ref) / f_ref > 2e-3)) == 1


@pytest.mark.parametrize("length", [4608, 5000, 3584])
def test_yin_pitch_even_frame_count(plucks, length):
    """An even frame count (10, 8 here) takes the mean of the two middle
    frame values, as jnp.median does."""
    clips = plucks[:40, :length]
    assert ts.n_frames(length, 2048, 512) % 2 == 0
    ref = np.asarray(jy.yin_pitch(clips, SR))
    got = ty.yin_pitch(torch.from_numpy(np.ascontiguousarray(clips)),
                       SR).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-3)


@pytest.mark.parametrize("n", [1, 2, 7, 10, 11])
def test_median_midpoint(n):
    x = np.random.default_rng(n).normal(size=(5, n)).astype(np.float32)
    np.testing.assert_allclose(ty._median(torch.from_numpy(x)).numpy(),
                               np.asarray(jnp.median(x, axis=-1)),
                               rtol=1e-7)


def test_parabolic_shifts_match():
    x = np.random.default_rng(4).uniform(size=(6, 40)).astype(np.float32)
    np.testing.assert_allclose(
        ty._parabolic_shifts(torch.from_numpy(x)).numpy(),
        np.asarray(jy._parabolic_shifts(jnp.asarray(x))), rtol=1e-6,
        atol=1e-7)


@pytest.mark.parametrize("hz", [82.41, 440.0, 1174.66, float("nan"), 0.0,
                                -3.0])
def test_estimate_note_matches(hz):
    assert ty.estimate_note(hz) == jy.estimate_note(hz)
