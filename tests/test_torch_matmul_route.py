"""PyTorch port vs gat_tpu on the matmul ("DFT-GEMM") route, every case
of tests/test_matmul_backend.py, port against JAX (CPU; both packages set
to the matmul route, at float32 and at bfloat16 GEMM operands).

Tolerances, each measured on these inputs and stated with its test: the
two packages form the same float32 products of the same operands (rounded
to bfloat16 alike in the bf16 cases), so they differ by summation order
only, at both dtypes:
- power spectrogram and the sweep: rtol 5e-4 of a bin plus atol 2e-3
  (measured 1.4e-4 relative, 1.0e-3 absolute on bins up to 770);
- MFCC: atol 2e-3 (measured 6.7e-4 fp32, 2.4e-4 bf16);
- torchaudio mel dB: atol 0.02 where JAX reads above -60 dB (measured
  3.2e-3), 0.1 everywhere (measured 0.028);
- YIN pitch and frame f0: rtol 1e-4 (measured 4.2e-7);
- block spectra and the Hann in frequency: atol 2e-4 (measured 4.6e-5 on
  spectra of magnitude up to 150).
Every test that sets a switch restores both packages to "auto" and float32
in the `route` fixture's teardown, even when it fails; the last test of
the file holds that."""
import threading

import numpy as np
import pytest
import torch

from gat_tpu.ops import spectral as js
from gat_tpu.ops import yin as jy
from gat_tpu_torch.ops import spectral as ts
from gat_tpu_torch.ops import yin as ty
from gat_tpu_torch.utils.device import tf32_off
from tests.conftest import make_pluck, make_sine

DTYPES = {"float32": (torch.float32, "float32"),
          "bfloat16": (torch.bfloat16, "bfloat16")}


def reset_routes() -> None:
    for mod in (js, ts):
        mod.set_stft_backend("auto")
    ts.set_matmul_dtype(torch.float32)
    js.set_matmul_dtype("float32")


@pytest.fixture(params=list(DTYPES))
def route(request):
    """Both packages on the matmul route at one GEMM operand dtype; both
    back at "auto" and float32 afterwards."""
    tdt, jdt = DTYPES[request.param]
    try:
        for mod in (js, ts):
            mod.set_stft_backend("matmul")
        ts.set_matmul_dtype(tdt)
        js.set_matmul_dtype(jdt)
        yield request.param
    finally:
        reset_routes()


@pytest.fixture
def restore():
    """For tests that flip the switches themselves."""
    yield
    reset_routes()


def rng_signal(seed: int, shape, scale: float = 0.3) -> np.ndarray:
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("hop", [512, 500])
def test_power_spectrogram(route, hop):
    """Frame GEMMs with the window folded in; hop 500 does not divide
    n_fft (frames by unfold, no block path)."""
    y = rng_signal(42, (3, 5512))
    ref = np.asarray(js.power_spectrogram(y, 2048, hop))
    got = ts.power_spectrogram(torch.from_numpy(y), 2048, hop).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=5e-4, atol=2e-3)


@pytest.mark.parametrize("n_freqs", [1024, 700])
def test_power_spectrogram_n_freqs(route, n_freqs):
    y = rng_signal(3, (2, 4000))
    ref = np.asarray(js.power_spectrogram(y, 2048, 512, n_freqs=n_freqs))
    got = ts.power_spectrogram(torch.from_numpy(y), 2048, 512,
                               n_freqs=n_freqs).numpy()
    assert got.shape == ref.shape == (2, 8, n_freqs)
    np.testing.assert_allclose(got, ref, rtol=5e-4, atol=2e-3)


@pytest.mark.parametrize("power", [1.0, 3.0])
def test_power_spectrogram_powers(route, power):
    y = rng_signal(4, (2, 4000))
    ref = np.asarray(js.power_spectrogram(y, 2048, 512, power=power))
    got = ts.power_spectrogram(torch.from_numpy(y), 2048, 512,
                               power=power).numpy()
    np.testing.assert_allclose(got, ref, rtol=5e-4, atol=2e-3)


def test_stft(route):
    y = rng_signal(5, (2, 4396), 1.0)
    ref = np.asarray(js.stft(y, 2048, 512))
    got = ts.stft(torch.from_numpy(y), 2048, 512).numpy()
    assert got.dtype == np.complex64 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)


def test_mfcc(route):
    y = np.stack([make_pluck(f, 11025, 0.5, seed=1) for f in (110., 220.)])
    ref = np.asarray(js.mfcc(y, 11025, n_mfcc=64))
    got = ts.mfcc(torch.from_numpy(y), 11025, n_mfcc=64).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)


def test_melspectrogram_torchaudio(route):
    """Tight in signal-bearing bins; near the -90 dB floor fp32 rounding
    of near-zero power moves the log (the JAX test's signal-bin rule)."""
    y = make_pluck(196.0, 11025, 0.5, seed=2)[None]
    ref = np.asarray(js.melspectrogram_torchaudio(y, 11025))
    got = ts.melspectrogram_torchaudio(torch.from_numpy(y), 11025).numpy()
    signal = ref > -60.0
    assert signal.mean() > 0.3
    np.testing.assert_allclose(got[signal], ref[signal], rtol=0, atol=0.02)
    np.testing.assert_allclose(got, ref, rtol=0, atol=0.1)


def test_yin_pitch(route, monkeypatch):
    """The median pitch through the block selector (librosa's window and
    hop: `_cmnd_block`, no frames)."""
    calls = []
    block = ty._cmnd_block
    monkeypatch.setattr(ty, "_cmnd_block",
                        lambda *a, **k: (calls.append(1), block(*a, **k))[1])
    clips = np.stack([make_pluck(f, 11025, 0.5, seed=3)
                      for f in (82.41, 146.83, 329.63)])
    ref = np.asarray(jy.yin_pitch(clips, 11025))
    got = ty.yin_pitch(torch.from_numpy(clips), 11025).numpy()
    assert calls
    np.testing.assert_allclose(got, ref, rtol=1e-4)


@pytest.mark.parametrize("hop", [None, 1024, 256])
def test_yin_frames(route, hop, monkeypatch):
    """Frame f0 on both branches of the selector: the block DFT (hop
    None, 512 and 256: hop < window and divides it) and the framed GEMM
    autocorrelation (hop 1024 == window)."""
    calls = []
    block = ty._cmnd_block
    monkeypatch.setattr(ty, "_cmnd_block",
                        lambda *a, **k: (calls.append(1), block(*a, **k))[1])
    s = make_sine(220.0, 11025, 0.5)
    ref = np.asarray(jy.yin(s, sr=11025, hop_length=hop))
    got = ty.yin(torch.from_numpy(s), sr=11025, hop_length=hop).numpy()
    assert got.shape == ref.shape
    assert bool(calls) == (hop != 1024)
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_autocorr_lags_framed_gemm(route):
    """The framed GEMM branch of the autocorrelation on its own, against
    JAX's (atol 2e-4 on lags of magnitude up to 200)."""
    frames = rng_signal(6, (3, 5, 2048), 0.5)
    ref = np.asarray(jy._autocorr_lags(frames, 2048, 1024, 222))
    got = ty._autocorr_lags(torch.from_numpy(frames), 2048, 1024,
                            222).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)


def test_block_spectra(route):
    """The hop-block DFT and its twiddle combine; in float32 also equal
    to the rfft of the materialized frames (the JAX test's 2e-3)."""
    import jax.numpy as jnp
    y = np.random.default_rng(42).normal(size=(2, 4396)).astype(np.float32)
    nf = 1 + (y.shape[-1] - 2048) // 512
    ref = js.block_spectra(jnp.asarray(y), 2048, 512, nf)
    got = ts.block_spectra(torch.from_numpy(y), 2048, 512, nf)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=2e-4)
    if route == "float32":
        spec = np.fft.rfft(np.lib.stride_tricks.sliding_window_view(
            y, 2048, axis=-1)[:, ::512][:, :nf], 2048, axis=-1)
        np.testing.assert_allclose(got[0].numpy(), spec.real, atol=2e-3)
        np.testing.assert_allclose(got[1].numpy(), spec.imag, atol=2e-3)


def test_block_coeffs_and_combine(route):
    """block_coeffs pads a short signal to whole blocks; combine_blocks
    with fewer blocks is the DFT of the frame's first blocks."""
    import jax.numpy as jnp
    y = rng_signal(7, (2, 3000), 1.0)
    ref = js.block_coeffs(jnp.asarray(y), 2048, 512, 4)
    got = ts.block_coeffs(torch.from_numpy(y), 2048, 512, 4)
    assert got[0].shape == (2, 7, 1025)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=2e-4)
    ref2 = js.combine_blocks(*ref, 2048, 512, 4, n_blocks=2)
    got2 = ts.combine_blocks(*got, 2048, 512, 4, n_blocks=2)
    for g, r in zip(got2, ref2):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=2e-4)


def test_hann_in_frequency(route):
    """The 3-tap Hann in frequency; in float32 also equal to windowing in
    time (the JAX test's 2e-3)."""
    import jax.numpy as jnp
    y = np.random.default_rng(42).normal(size=(1, 6144)).astype(np.float32)
    nf = 1 + (y.shape[-1] - 2048) // 512
    ref = js.hann_in_frequency(*js.block_spectra(jnp.asarray(y), 2048, 512,
                                                 nf))
    got = ts.hann_in_frequency(*ts.block_spectra(torch.from_numpy(y), 2048,
                                                 512, nf))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=2e-4)
    if route == "float32":
        win = np.hanning(2049)[:-1]
        frames = np.lib.stride_tricks.sliding_window_view(
            y, 2048, axis=-1)[:, ::512][:, :nf]
        spec = np.fft.rfft(frames * win, 2048, axis=-1)
        np.testing.assert_allclose(got[0].numpy(), spec.real, atol=2e-3)
        np.testing.assert_allclose(got[1].numpy(), spec.imag, atol=2e-3)


@pytest.mark.parametrize("n_fft, hop", [(1024, 256), (1024, 512),
                                        (2048, 512), (2048, 1024),
                                        (512, 128)])
def test_randomized_configs(route, n_fft, hop):
    """The JAX test's (n_fft, hop) sweep at a length drawn from a seed."""
    rng = np.random.default_rng(n_fft + hop)
    n = int(rng.integers(3 * n_fft, 5 * n_fft))
    y = (rng.normal(size=(2, n)) * 0.3).astype(np.float32)
    ref = np.asarray(js.power_spectrogram(y, n_fft, hop))
    got = ts.power_spectrogram(torch.from_numpy(y), n_fft, hop).numpy()
    np.testing.assert_allclose(got, ref, rtol=5e-4, atol=2e-3,
                               err_msg=f"n_fft={n_fft} hop={hop} n={n}")


def test_backend_switches(restore):
    """"auto" resolves to "fft" on the CPU in both packages; a bad name
    is refused; the dtype takes torch dtypes and the JAX names."""
    for mod in (js, ts):
        mod.set_stft_backend("auto")
        assert mod.stft_backend() == "fft"
        mod.set_stft_backend("matmul")
        assert mod.stft_backend() == "matmul"
        with pytest.raises(AssertionError):
            mod.set_stft_backend("cufft")
    for name, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32),
                     (torch.bfloat16, torch.bfloat16)):
        ts.set_matmul_dtype(name)
        assert ts.matmul_dtype() is dt
    with pytest.raises(ValueError):
        ts.set_matmul_dtype(torch.float16)


def test_kernel_signal_rounds_on_the_bf16_matmul_route(restore):
    """The signal a front-end kernel is handed: itself, except on the
    matmul route at bfloat16, where it is rounded to bfloat16."""
    x = torch.from_numpy(rng_signal(8, (2, 100)))
    assert ts.kernel_signal(x) is x
    ts.set_matmul_dtype("bfloat16")
    assert ts.kernel_signal(x) is x  # the FFT route rounds nothing
    ts.set_stft_backend("matmul")
    got = ts.kernel_signal(x)
    assert got.dtype == torch.float32
    assert torch.equal(got, x.to(torch.bfloat16).float())
    assert not torch.equal(got, x)


def test_no_tf32_restores_the_callers_flag():
    """The GEMMs turn TF32 off for their call on the card and leave the
    caller's setting as it was; nothing changes for the CPU."""
    m = torch.backends.cuda.matmul
    before = m.allow_tf32
    try:
        m.allow_tf32 = True
        with tf32_off(torch.device("cuda")):
            assert m.allow_tf32 is False
            with tf32_off(torch.device("cuda")):  # nested: re-entrant
                assert m.allow_tf32 is False
            assert m.allow_tf32 is False
        assert m.allow_tf32 is True
        with tf32_off(torch.device("cpu")):
            assert m.allow_tf32 is True
    finally:
        m.allow_tf32 = before


def test_tf32_off_serialises_threads():
    """While one thread is inside, another waits at the door, so neither
    restores the flag under the other's GEMMs."""
    m = torch.backends.cuda.matmul
    before = m.allow_tf32
    inside, release, seen = threading.Event(), threading.Event(), []

    def first():
        with tf32_off(torch.device("cuda")):
            inside.set()
            release.wait(10)

    def second():
        with tf32_off(torch.device("cuda")):
            seen.append(release.is_set())

    try:
        m.allow_tf32 = True
        a = threading.Thread(target=first)
        a.start()
        assert inside.wait(10)
        b = threading.Thread(target=second)
        b.start()
        b.join(0.2)
        assert b.is_alive() and not seen
        release.set()
        a.join(10)
        b.join(10)
        assert seen == [True] and m.allow_tf32 is True
    finally:
        release.set()
        m.allow_tf32 = before


def test_no_switch_leaks_from_earlier_tests():
    """Runs last in this file: every test before it restored both
    packages' switches."""
    for mod in (js, ts):
        assert mod._STFT_BACKEND == "auto"
        assert mod.stft_backend() == "fft"
    assert ts.matmul_dtype() is torch.float32
    assert js.matmul_dtype() == np.float32
