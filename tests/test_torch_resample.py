"""PyTorch port vs gat_tpu: the polyphase resampler, `resample_rows` (the
file body's gather, re-rate and cut in one step), fix_length, the WAV
codec and the clip ensemble's re-rate (CPU).

Bounds: the filter tables are identical (the same scipy design); the
resampled signals agree to atol 1e-5 (float32 sums of 1,000 to 21,000
taps in another order); the codec is bit-exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_tpu.ops import resample as jr
from gat_tpu.utils import wavio as jw
from gat_tpu_torch.ops import resample as tr
from gat_tpu_torch.utils import wavio as tw

RATES = [(44100, 22050), (22050, 11025), (48000, 22050), (16000, 22050)]


@pytest.mark.parametrize("orig,target", RATES)
@pytest.mark.parametrize("length", [0, 1, 7, 1001, 4099])
def test_resample_matches(orig, target, length):
    x = np.random.default_rng(length).normal(0, 0.3, (2, length)).astype(
        np.float32)
    ref = np.asarray(jr.resample(jnp.asarray(x), orig, target))
    got = tr.resample(torch.from_numpy(x), orig, target).numpy()
    assert got.shape == ref.shape == (2, -(-length * target // orig))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("orig,target", RATES)
def test_resample_plucks_one_second(orig, target):
    """A 1 s pluck-like tone, one row, the length of the file path's
    whole-second pad."""
    t = np.arange(orig) / orig
    x = (np.sin(2 * np.pi * 196.0 * t) * np.exp(-4 * t)).astype(np.float32)
    ref = np.asarray(jr.resample(jnp.asarray(x), orig, target))
    got = tr.resample(torch.from_numpy(x), orig, target).numpy()
    assert got.shape == ref.shape == (target,)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("orig,target", RATES + [(22050, 22050)])
@pytest.mark.parametrize("rows, extra", [([3, 0, 4, 3], -37),
                                         ([2], 201), (None, 0)])
def test_resample_rows_matches(orig, target, rows, extra):
    """`resample_rows` against the reference's composition
    fix_length(resample(x[sel]), size): a permuted selection with a
    repeat cut short of m, one row padded past it, every row at m; the
    same rate is the gather and the cut alone."""
    x = np.random.default_rng(9).normal(0, 0.3, (5, 4099)).astype(
        np.float32)
    size = -(-4099 * target // orig) + extra
    sel = x if rows is None else x[np.asarray(rows)]
    ref = np.asarray(jr.fix_length(jr.resample(jnp.asarray(sel), orig,
                                               target), size))
    got = tr.resample_rows(torch.from_numpy(x), rows, orig, target,
                           size).numpy()
    assert got.shape == ref.shape == (len(sel), size)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_resample_rows_of_no_samples():
    """Rows of 0 samples give rows of `out_len` zeros, as fix_length of
    the reference's empty resample."""
    x = torch.zeros(2, 0)
    got = tr.resample_rows(x, [1, 1, 0], 48000, 22050, 5)
    ref = jr.fix_length(jr.resample(jnp.zeros((3, 0)), 48000, 22050), 5)
    assert got.shape == ref.shape == (3, 5) and not bool(got.any())
    assert tr.resample_rows(x, None, 44100, 22050, 0).shape == (2, 0)


@pytest.mark.parametrize("orig,target", RATES)
def test_filter_tables_identical(orig, target):
    g = np.gcd(orig, target)
    up, down = target // g, orig // g
    np.testing.assert_array_equal(tr.resample_filter(up, down),
                                  jr.resample_filter(up, down))
    for a, b in zip(tr._polyphase_plan(3000, up, down, 24, 9.58),
                    jr._polyphase_plan(3000, up, down, 24, 9.58)):
        np.testing.assert_array_equal(a, b)
    if up == 1:
        np.testing.assert_array_equal(
            tr._decimation_band_np(up, down, 24, 9.58, 128),
            jr._decimation_band_np(up, down, 24, 9.58, 128))


@pytest.mark.parametrize("orig,target", [(48000, 22050), (16000, 22050),
                                         (96000, 22050), (22050, 11025)])
@pytest.mark.parametrize("length", [1, 1001, 4099])
def test_polyphase_bank_matches_plain(orig, target, length):
    """The library's one `F.conv1d` that K9 is timed against at every rate
    pair (`polyphase_bank`, torchaudio's form: up channels at stride
    down, then interleaved) gives `resample_plain`'s outputs within 1e-5
    at the smoke's rate pairs, and the reference's too; at up == 1 the
    bank is the filter itself."""
    x = np.random.default_rng(length).normal(0, 0.3, (2, length)).astype(
        np.float32)
    got = tr.resample_conv(torch.from_numpy(x), orig, target)
    ref = tr.resample_plain(torch.from_numpy(x), orig, target)
    assert got.shape == ref.shape == (2, -(-length * target // orig))
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jr.resample(jnp.asarray(x), orig, target)),
        atol=1e-5, rtol=0)
    up, down = target // np.gcd(orig, target), orig // np.gcd(orig, target)
    bank, lpad = tr.polyphase_bank(up, down)
    k_taps = tr._polyphase_plan(1, up, down, 24, 9.58)[0].shape[1]
    assert bank.shape[:2] == (up, 1) and bank.shape[2] >= k_taps
    if up == 1:
        np.testing.assert_array_equal(bank[0, 0], tr.resample_filter(1, down))
        assert lpad == (bank.shape[2] - 1) // 2


def test_same_rate_is_identity():
    x = torch.ones(3, 10)
    assert tr.resample(x, 22050, 22050) is x


def test_resample_restores_tf32_flags():
    """The resampler runs in full fp32 and leaves the caller's TF32
    settings as they were."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        for orig, target in RATES:
            tr.resample(torch.zeros(1, 2000), orig, target)
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize("size", [3, 10, 17])
def test_fix_length_matches(size):
    x = np.arange(20, dtype=np.float32).reshape(2, 10)
    np.testing.assert_array_equal(tr.fix_length(torch.from_numpy(x),
                                                size).numpy(),
                                  np.asarray(jr.fix_length(jnp.asarray(x),
                                                           size)))


@pytest.mark.parametrize("subtype", ["PCM_16", "PCM_24", "PCM_32", "FLOAT"])
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_codec_matches(tmp_path, subtype, channels):
    rng = np.random.default_rng(3)
    audio = rng.uniform(-0.9, 0.9, (1001, channels)).astype(np.float32)
    if channels == 1:
        audio = audio[:, 0]
    tw.write_wav(tmp_path / "t.wav", audio, 44100, subtype)
    jw.write_wav(tmp_path / "j.wav", audio, 44100, subtype)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav"
                                                 ).read_bytes()
    got, sr = tw.read_wav(tmp_path / "j.wav")
    ref, sr_ref = jw.read_wav(tmp_path / "j.wav")
    assert sr == sr_ref == 44100
    np.testing.assert_array_equal(got, ref)
    # several channels load channels-first
    got, _ = tw.read_wav(tmp_path / "j.wav", mono=False)
    ref, _ = jw.read_wav(tmp_path / "j.wav", mono=False)
    np.testing.assert_array_equal(got, ref.T if channels > 1 else ref)


def test_wav_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        tw.read_wav(tmp_path / "missing.wav")
    (tmp_path / "bad.wav").write_bytes(b"RIFF0000WAVX")
    with pytest.raises(ValueError, match="RIFF/WAVE"):
        tw.read_wav(tmp_path / "bad.wav")
    with pytest.raises(ValueError, match="subtype"):
        tw.write_wav(tmp_path / "x.wav", np.zeros(4), 8000, "PCM_12")
