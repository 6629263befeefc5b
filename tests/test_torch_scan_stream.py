"""The port's chunked streaming engine, `gat_tpu_torch/stream/scan.py`,
against `gat_tpu.stream.scan.ScanStreamer` on the CPU.

Bounds, each with its reason:
* per-chunk onsets, takes and overflow flags: identical to the JAX scan's
  (onsets, emits, ovf) (integer onsets, the loudness gate on the same
  clip, the same integer walk);
* emitted notes: the same onset times and labels; probs within 1e-2
  (the ensemble's float32 sums in another order).
"""
import numpy as np
import pytest

import jax.numpy as jnp

from gat_tpu.infer import Transcriber as JTranscriber
from gat_tpu.stream.scan import ScanStreamer as JScanStreamer
from gat_tpu_torch.infer import Transcriber
from gat_tpu_torch.stream import ArraySource, LiveTranscriber, ScanStreamer
from gat_tpu_torch.stream import scan
from tests.conftest import make_pluck

SR = 22050


def _place(y, t0: float, f: float, dur: float, seed: int) -> None:
    n = make_pluck(f, SR, dur, seed=seed)
    fade = int(0.3 * len(n))
    n[-fade:] *= np.linspace(1, 0, fade, dtype=np.float32)
    s = int(t0 * SR)
    y[s:s + len(n)] += n[:len(y) - s]


def sparse_song() -> np.ndarray:
    """A2 D3 G3 B3 at 0.6, 1.5, 2.4 and 3.3 s (tests/test_scan_stream.py)."""
    y = np.zeros(int(4.6 * SR), np.float32)
    for t0, f in ((0.6, 110.0), (1.5, 146.83), (2.4, 196.0), (3.3, 246.94)):
        _place(y, t0, f, 0.45, int(f))
    return y


def dense_riff() -> np.ndarray:
    """8 notes in 2 s: two onsets in every 0.5 s chunk."""
    y = np.zeros(int(3.0 * SR), np.float32)
    for i, f in enumerate((110.0, 146.83, 196.0, 246.94, 329.63, 440.0,
                           587.33, 784.0)):
        _place(y, 0.3 + 0.25 * i, f, 0.22, i)
    return y


def tiny_budget_riff() -> np.ndarray:
    """10 plucks 0.25 s apart, for a 2-slot budget that must flag."""
    y = np.zeros(int(3.0 * SR), np.float32)
    for k in range(10):
        _place(y, 0.2 + 0.25 * k, 110.0 * (1 + (k % 3)), 0.2, k)
    return y


# (streamer options, waveform): the sparse riff and silence share one
# shape, so the JAX scan compiles once for both
CASES = {
    "sparse": ({}, sparse_song),
    "silence": ({}, lambda: np.zeros(int(4.6 * SR), np.float32)),
    "dense": ({"min_sep": 0.2}, dense_riff),
    "tiny_budget": ({"min_sep": 0.0, "max_notes_per_chunk": 2},
                    tiny_budget_riff),
}


@pytest.fixture(scope="module")
def port_t():
    return Transcriber(device="cpu")


@pytest.fixture(scope="module")
def jax_t():
    return JTranscriber()


@pytest.fixture(scope="module")
def runs(port_t, jax_t):
    """Per case, lazily: (port streamer, y, the JAX scan's (onsets, emits,
    ovf), JAX's notes)."""
    jax_streamers, cache = {}, {}

    def get(case):
        if case not in cache:
            kw, make = CASES[case]
            key = tuple(sorted(kw.items()))
            if key not in jax_streamers:
                jax_streamers[key] = JScanStreamer(jax_t, sr=SR, **kw)
            js = jax_streamers[key]
            y = make()
            n_chunks = int(np.ceil((len(y) + js.context) / js.chunk))
            chunks = np.pad(y, (0, n_chunks * js.chunk - len(y))).reshape(
                n_chunks, js.chunk)
            _, onsets, emits, ovf = js._scan_fn(jnp.asarray(chunks))
            cache[case] = (ScanStreamer(port_t, sr=SR, **kw), y,
                           (np.asarray(onsets), np.asarray(emits),
                            np.asarray(ovf)),
                           js.transcribe_stream(y))
        return cache[case]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_chunk_slots_match_jax(runs, case):
    st, y, (onsets, emits, ovf), _ = runs(case)
    got_onsets, takes, overflow = st.segment_stream(y)
    np.testing.assert_array_equal(got_onsets, onsets)
    np.testing.assert_array_equal(takes, emits)
    np.testing.assert_array_equal(overflow, ovf)
    if case == "tiny_budget":
        assert overflow.any()
    if case == "silence":
        assert not takes.any()


@pytest.mark.parametrize("case", list(CASES))
def test_transcribe_stream_matches_jax(runs, case):
    st, y, _, ref = runs(case)
    got = st.transcribe_stream(y)
    assert [r["onset_s"] for r in got] == [r["onset_s"] for r in ref]
    assert [r["labels"] for r in got] == [r["labels"] for r in ref]
    assert ([r["onset_overflow"] for r in got]
            == [r["onset_overflow"] for r in ref])
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        np.testing.assert_allclose(g["probs"], r["probs"], atol=1e-2)
        np.testing.assert_allclose(g["confidences"], r["confidences"],
                                   atol=1e-2)
    if case == "sparse":
        assert [r["labels"][0] for r in got][:4] == ["A2", "D3", "G3", "B3"]
    if case == "dense":
        assert len(got) == 8
    if case == "silence":
        assert got == []


def test_windows_equal_one_window(runs, monkeypatch):
    """A stream cut into 3 windows of chunks (the carry of the walk passed
    from one to the next) gives what one window gives."""
    st, y, _, _ = runs("dense")
    one = st.segment_stream(y), st.transcribe_stream(y)
    n_chunks = len(one[0][0])
    monkeypatch.setattr(scan, "_WINDOW_CHUNKS", -(-n_chunks // 3))
    three = st.segment_stream(y), st.transcribe_stream(y)
    for a, b in zip(one[0], three[0]):
        np.testing.assert_array_equal(a, b)
    assert ([(r["onset_s"], r["labels"]) for r in one[1]]
            == [(r["onset_s"], r["labels"]) for r in three[1]])
    for a, b in zip(one[1], three[1]):
        np.testing.assert_allclose(a["probs"], b["probs"], atol=1e-6)


def test_stream_takes_a_tensor(runs):
    """A 1-D tensor at the stream's rate streams as its numpy array does
    (the CLI hands over the resampled tensor)."""
    import torch
    st, y, _, _ = runs("sparse")
    a = st.transcribe_stream(y)
    b = st.transcribe_stream(torch.from_numpy(y))
    assert [(r["onset_s"], r["labels"]) for r in a] == \
        [(r["onset_s"], r["labels"]) for r in b]


def _collapse(labels):
    """Consecutive duplicates dropped: per-ring normalization can add
    same-label echoes in either engine."""
    out = []
    for lab in labels:
        if not out or out[-1] != lab:
            out.append(lab)
    return out


@pytest.mark.parametrize("riff", ["dense", "sparse"])
def test_cross_engine_note_sequence_parity(port_t, riff):
    """The port's two engines, ScanStreamer and LiveTranscriber, on the
    same audio emit the same note sequence up to same-label echoes
    (tests/test_scan_stream.py's test on the JAX engines)."""
    if riff == "dense":
        notes = [("A2", 110.0), ("D3", 146.83), ("G3", 196.0),
                 ("B3", 246.94), ("E4", 329.63), ("A4", 440.0)]
        spacing = 0.55
    else:
        notes = [("G3", 196.0), ("D3", 146.83)]
        spacing = 1.6
    y = np.zeros(int((0.4 + spacing * len(notes) + 1.0) * SR), np.float32)
    for i, (_, f) in enumerate(notes):
        _place(y, 0.4 + spacing * i, f, 0.45, i)
    expected = [name for name, _ in notes]
    scan_seq = _collapse([r["labels"][0] for r in
                          ScanStreamer(port_t, sr=SR).transcribe_stream(y)])
    live = LiveTranscriber(port_t, sample_rate=SR, verbose=False)
    live_seq = _collapse([r["labels"][0] for r in
                          live.run_on_source(ArraySource(y, blocksize=1024))])
    assert scan_seq == live_seq == expected
