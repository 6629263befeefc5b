"""The port's native WAV codec (`gat_tpu_torch/native/wav_codec.cpp`,
bound by `gat_tpu_torch/utils/native_wav.py`) against the port's Python
codec and gat_tpu's `read_wav` on the same files.

Bounds: PCM_16 and FLOAT decode bit-identically (mono, and stereo
averaged); PCM_24 and PCM_32 within 1e-6; the native encoder's samples
bit-identical to the Python encoder's. The tests that need the codec
skip, with the reason, where g++ is missing."""
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gat_tpu.utils.wavio import read_wav as jax_read_wav
from gat_tpu_torch.utils import native_wav
from gat_tpu_torch.utils.wavio import read_wav, write_wav

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def native():
    if not native_wav.native_available():
        pytest.skip("the native codec did not build here (g++ missing)")
    return native_wav


def _signal(n: int, channels: int, seed: int = 0) -> np.ndarray:
    x = np.random.default_rng(seed).uniform(-0.8, 0.8, (n, channels))
    return x[:, 0].astype(np.float32) if channels == 1 else \
        x.astype(np.float32)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("subtype", ["PCM_16", "FLOAT"])
def test_decode_bit_identical(native, tmp_path, subtype, channels):
    p = tmp_path / "a.wav"
    write_wav(p, _signal(3001, channels), 22050, subtype=subtype)
    nat, sr_n = native.read_wav_native(p)
    py, sr_p = read_wav(p)
    ref, sr_j = jax_read_wav(p)
    assert sr_n == sr_p == sr_j == 22050
    assert nat.dtype == py.dtype == np.float32 and nat.shape == (3001,)
    np.testing.assert_array_equal(nat, py)
    np.testing.assert_array_equal(nat, ref)


@pytest.mark.parametrize("subtype", ["PCM_24", "PCM_32"])
def test_decode_deep_pcm(native, tmp_path, subtype):
    p = tmp_path / "a.wav"
    write_wav(p, _signal(3001, 1), 44100, subtype=subtype)
    nat, sr = native.read_wav_native(p)
    assert sr == 44100
    np.testing.assert_allclose(nat, read_wav(p)[0], atol=1e-6)
    np.testing.assert_allclose(nat, jax_read_wav(p)[0], atol=1e-6)


def test_decode_errors(native, tmp_path):
    """A missing file is FileNotFoundError; anything else that fails,
    a directory or a file that is not a WAV, is ValueError, which the
    batch decoder retries through the Python decoder."""
    with pytest.raises(FileNotFoundError):
        native.read_wav_native(tmp_path / "missing.wav")
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"definitely not a wav")
    d = tmp_path / "adir.wav"
    d.mkdir()
    for p in (bad, d):
        with pytest.raises(ValueError, match=r"\[read_wav_native\]"):
            native.read_wav_native(p)


def _fmt_after_data(path, y: np.ndarray, sr: int) -> None:
    """A PCM_16 WAV whose fmt chunk follows the data and declares more
    bytes than the file holds: the native parser refuses it, the Python
    one reads it."""
    pcm = np.round(y * 32768.0).astype("<i2").tobytes()
    fmt = struct.pack("<HHIIHH", 1, 1, sr, 2 * sr, 2, 16)
    body = (b"WAVE" + b"data" + struct.pack("<I", len(pcm)) + pcm
            + b"fmt " + struct.pack("<I", 100) + fmt)
    path.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def test_batch_order_and_per_file_fallback(native, tmp_path):
    paths = []
    for i in range(8):
        p = tmp_path / f"{i}.wav"
        write_wav(p, np.full(100 + i, 0.01 * (i + 1), np.float32), 8000,
                  subtype="FLOAT")
        paths.append(p)
    odd = tmp_path / "odd.wav"
    _fmt_after_data(odd, _signal(500, 1, seed=3), 16000)
    with pytest.raises(ValueError):
        native.read_wav_native(odd)
    paths.insert(3, odd)
    out = native.read_wav_batch(paths, max_workers=4)
    assert len(out) == 9
    y, sr = out.pop(3)
    assert sr == 16000
    np.testing.assert_array_equal(y, read_wav(odd)[0])
    for i, (x, sr) in enumerate(out):
        assert sr == 8000 and len(x) == 100 + i
        np.testing.assert_array_equal(x, np.float32(0.01 * (i + 1)))
    garbage = tmp_path / "garbage.wav"
    garbage.write_bytes(b"not a wav" * 9)
    with pytest.raises(ValueError):
        native.read_wav_batch(paths + [garbage])


@pytest.mark.parametrize("subtype", ["PCM_16", "FLOAT"])
def test_encode_matches_python(native, tmp_path, subtype):
    """The native encoder quantizes as the Python one does (×32768,
    round-half-even, clipped), and the float round trip is exact."""
    x = np.random.default_rng(1).uniform(-1.2, 1.2, 4321).astype(np.float32)
    pn, pp = tmp_path / "n.wav", tmp_path / "p.wav"
    native.write_wav_native(pn, x, 22050, subtype=subtype)
    write_wav(pp, x, 22050, subtype=subtype)
    a, sr_a = read_wav(pn)
    b, sr_b = read_wav(pp)
    assert sr_a == sr_b == 22050
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(native.read_wav_native(pn)[0], a)
    if subtype == "FLOAT":
        np.testing.assert_array_equal(a, x)
        raw = pn.read_bytes()  # an 18-byte fmt (cbSize 0) and a fact chunk
        assert struct.unpack("<I", raw[16:20])[0] == 18
        assert raw[38:42] == b"fact"
        assert struct.unpack("<I", raw[46:50])[0] == len(x)


def test_encode_refuses_and_batch_falls_back(native, tmp_path):
    with pytest.raises(ValueError, match="unsupported subtype"):
        native.write_wav_native(tmp_path / "x.wav", np.zeros(10, np.float32),
                                22050, subtype="PCM_24")
    with pytest.raises(ValueError, match="mono"):
        native.write_wav_native(tmp_path / "y.wav",
                                np.zeros((10, 2), np.float32), 22050)
    x = _signal(300, 1, seed=2)
    items = [(tmp_path / "c16.wav", x, 11025),
             (tmp_path / "cst.wav", _signal(300, 2, seed=4), 11025)]
    native.write_wav_batch(items)
    np.testing.assert_allclose(read_wav(items[0][0])[0], x, atol=1 / 32768)
    np.testing.assert_allclose(read_wav(items[1][0])[0],
                               items[1][1].mean(axis=1), atol=1 / 32768)
    native.write_wav_batch([(tmp_path / "c24.wav", x, 44100)],
                           subtype="PCM_24")
    np.testing.assert_allclose(read_wav(tmp_path / "c24.wav")[0], x,
                               atol=1.0 / (1 << 23))


def test_non_utf8_filename(native, tmp_path):
    p = tmp_path / os.fsdecode(b"weird_\xff_name.wav")
    y = (np.sin(np.arange(400) * 0.1) * 0.3).astype(np.float32)
    native.write_wav_native(p, y, 22050)
    got, sr = native.read_wav_native(p)
    assert sr == 22050
    np.testing.assert_array_equal(got, read_wav(p)[0])


def test_library_is_hashed_and_not_built_at_import(monkeypatch, tmp_path):
    """The library's name follows its source, under the port's build
    directory; importing the module builds nothing."""
    from gat_tpu_torch.config import KERNEL_BUILD_DIR
    lib = native_wav._library_path()
    assert lib.parent == KERNEL_BUILD_DIR and lib.name.startswith(
        "libwavcodec-")
    src = tmp_path / "wav_codec.cpp"
    src.write_text(native_wav._SRC.read_text() + "\n// edit\n")
    monkeypatch.setattr(native_wav, "_SRC", src)
    assert native_wav._library_path() != lib
    code = ("from gat_tpu_torch.utils import native_wav as n\n"
            "print(n._tried, n._lib)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.stdout.split() == ["False", "None"], out.stderr
