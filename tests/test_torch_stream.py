"""The port's live engine, `gat_tpu_torch/stream/{ring,live}.py`, against
`gat_tpu.stream` on the CPU, and the ports of tests/test_stream.py's live
cases.

Bounds, each with its reason:
* the ring's snapshots, absolute positions, `overwritten` and
  `overwritten_ranges`: identical (the same numpy arithmetic);
* `run_on_source`: the same note count, labels and `queue_drops`
  (integer onsets and slicing), confidences within 1e-2 (the ensemble's
  float32 sums in another order).
"""
import queue
import sys
import threading
import time
import types

import numpy as np
import pytest

from gat_tpu.infer import Transcriber as JTranscriber
from gat_tpu.stream import ArraySource as JArraySource
from gat_tpu.stream import LiveTranscriber as JLiveTranscriber
from gat_tpu.stream import RingBuffer as JRingBuffer
from gat_tpu_torch.infer import Transcriber
from gat_tpu_torch.stream import (ArraySource, LiveTranscriber, MicSource,
                                  RingBuffer)
from tests.conftest import make_pluck
from emulated_kernels import LIVE_MIN_SEP

SR = 22050


@pytest.fixture(scope="module")
def port_t():
    return Transcriber(device="cpu")


@pytest.fixture(scope="module")
def jax_t():
    return JTranscriber()


def riff(notes, spacing: float, dur: float = 0.45) -> np.ndarray:
    """Plucks of the given Hz from 0.4 s, `spacing` apart, each `dur` long
    with the last 30 % faded out, and 1 s of silence after the last."""
    y = np.zeros(int((0.4 + spacing * len(notes) + 1.0) * SR), np.float32)
    for i, f in enumerate(notes):
        n = make_pluck(f, SR, dur, seed=i)
        fade = int(0.3 * len(n))
        n[-fade:] *= np.linspace(1, 0, fade, dtype=np.float32)
        s = int((0.4 + spacing * i) * SR)
        y[s:s + len(n)] += n
    return y


SPARSE = ([196.0, 146.83], 1.6)  # G3 D3
DENSE = ([110.0, 146.83, 196.0, 246.94, 329.63, 440.0], 0.55)  # A2..A4


# ---------------------------------------------------------------------------
# RingBuffer
# ---------------------------------------------------------------------------
def _ring_state(r) -> tuple:
    snap, start = r.snapshot()
    return (snap.tolist(), start, r.size(), r.is_full(), r.overwritten,
            [list(x) for x in r.overwritten_ranges])


@pytest.mark.parametrize("maxlen", [7, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_random_ops_match_jax(maxlen, seed):
    """Seeded random sequences of push (below, at and above maxlen), pop,
    clear_from, clear_until, clear and get_slice leave both rings in the
    same state after every step."""
    rng = np.random.default_rng(seed)
    a, b = RingBuffer(maxlen), JRingBuffer(maxlen)
    pushed = 0
    for _ in range(300):
        op = rng.integers(0, 7)
        if op <= 2:
            n = int(rng.choice([1, maxlen - 1, maxlen, maxlen + 3,
                                rng.integers(1, 2 * maxlen)]))
            x = np.arange(pushed, pushed + n, dtype=np.float32)
            pushed += n
            a.push(x)
            b.push(x)
        elif op == 3:
            a.pop()
            b.pop()
        elif op == 4:
            k = int(rng.integers(-2, maxlen + 3))
            a.clear_from(k)
            b.clear_from(k)
        elif op == 5:
            pos = int(rng.integers(max(0, pushed - 2 * maxlen), pushed + 2))
            a.clear_until(pos)
            b.clear_until(pos)
        else:
            i, j = sorted(int(v) for v in rng.integers(-2, maxlen + 2, 2))
            np.testing.assert_array_equal(a.get_slice(i, j),
                                          b.get_slice(i, j))
            if rng.random() < 0.1:
                a.clear()
                b.clear()
        assert _ring_state(a) == _ring_state(b)
    assert a.overwritten > 0


def test_ring_exact_fit_push_logs_no_empty_span():
    """A maxlen block landing on a consumed ring overwrites nothing and
    logs no empty span; a larger one counts everything it lost."""
    r = RingBuffer(4)
    r.push(np.arange(4, dtype=np.float32))
    r.clear_from(4)
    r.push(np.arange(4, dtype=np.float32))
    assert r.overwritten == 0 and r.overwritten_ranges == []
    r.push(np.arange(5, dtype=np.float32))
    assert r.overwritten == 5
    assert all(hi > lo for lo, hi in r.overwritten_ranges)


def test_ring_clear_until_is_push_safe():
    """clear_until drops by absolute position: samples pushed after the
    consumer's snapshot survive."""
    rb = RingBuffer(8)
    rb.push(np.arange(8, dtype=np.float32))
    snap, start = rb.snapshot()
    assert start == 0
    rb.push(np.asarray([100.0, 101.0], np.float32))
    rb.clear_until(start + 5)
    np.testing.assert_array_equal(rb.get_buffer(),
                                  [5.0, 6.0, 7.0, 100.0, 101.0])
    rb.clear_until(3)
    assert rb.size() == 5


# ---------------------------------------------------------------------------
# LiveTranscriber against gat_tpu
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["sparse", "dense"])
def test_run_on_source_matches_jax(port_t, jax_t, case):
    notes, spacing = SPARSE if case == "sparse" else DENSE
    y = riff(notes, spacing)
    live = LiveTranscriber(port_t, verbose=False)
    got = live.run_on_source(ArraySource(y, blocksize=1024))
    jlive = JLiveTranscriber(jax_t, verbose=False)
    ref = jlive.run_on_source(JArraySource(y, blocksize=1024))
    assert [r["labels"] for r in got] == [r["labels"] for r in ref]
    assert len(got) >= len(notes)
    assert live.queue_drops == jlive.queue_drops == 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g["confidences"], r["confidences"],
                                   atol=1e-2)


def test_detect_onsets_matches_jax(port_t, jax_t):
    """One poll's onsets over a full 1.5 s ring (hop 1024, 33 frames) and
    a shorter flush snapshot."""
    y = riff(*DENSE)
    live = LiveTranscriber(port_t, verbose=False)
    jlive = JLiveTranscriber(jax_t, verbose=False)
    for lo, n in ((int(0.2 * SR), 33075), (int(1.0 * SR), 9000)):
        snap = y[lo:lo + n]
        assert live.detect_onsets(snap) == jlive.detect_onsets(snap)
    assert live.detect_onsets(y[int(0.2 * SR):int(0.2 * SR) + 33075])


# ---------------------------------------------------------------------------
# the live cases of tests/test_stream.py
# ---------------------------------------------------------------------------
def test_mic_source_gated(monkeypatch):
    monkeypatch.setitem(sys.modules, "sounddevice", None)
    with pytest.raises(ImportError, match="sounddevice"):
        MicSource()


def test_live_short_audio_flush(port_t):
    """Audio shorter than the ring is examined at the end-of-stream
    flush."""
    live = LiveTranscriber(port_t, verbose=False)
    note = make_pluck(196.0, SR, 0.9, seed=2)  # < 1.5 s buffer
    results = live.run_on_source(ArraySource(note))
    assert len(results) >= 1
    assert results[0]["labels"] == ["G3"]


def test_queue_drop_oldest_backpressure():
    live = LiveTranscriber.__new__(LiveTranscriber)
    live.note_q = queue.Queue(maxsize=2)
    live.queue_drops = 0
    for i in range(4):
        live._enqueue(np.full(3, i, np.float32))
    assert live.note_q.qsize() == 2
    assert live.queue_drops == 2
    assert live.note_q.get_nowait()[0] == 2.0


def _bare_live(sr=SR, ring=22050, min_slice_t=0.3, qsize=4):
    """LiveTranscriber without a model: the slicing tests stub
    detect_onsets and never drain into inference."""
    live = LiveTranscriber.__new__(LiveTranscriber)
    live.sample_rate = sr
    live.buffer = RingBuffer(ring)
    live.note_q = queue.Queue(maxsize=qsize)
    live.min_slice_len = int(min_slice_t * sr)
    live.clip_duration = 0.5
    live._onset_ctx = 4 * 1024
    live._attack_guard = 2 * 1024 + 1
    live._edge_latency = 6 * 1024
    live.verbose = False
    live.results = []
    live.queue_drops = 0
    return live


def _fake_drain(live, drained: list):
    def drain():
        while not live.note_q.empty():
            drained.append(live.note_q.get_nowait())
    return drain


def test_force_flush_drains_full_queue_instead_of_dropping():
    """At the end-of-stream flush a full queue drains before an enqueue,
    never evicts."""
    live = _bare_live(ring=33075, qsize=2)
    drained: list = []
    live.drain_queue = _fake_drain(live, drained)
    live.detect_onsets = lambda y: [1000, 10000, 19000]
    live.buffer.push(np.ones(30000, np.float32))
    assert live.process_buffer(force=True) == 3
    assert live.queue_drops == 0
    assert len(drained) + live.note_q.qsize() == 3


def test_min_sep_floors_at_min_slice_len(port_t):
    """The detector's min separation covers min_slice_t, with one hop of
    margin over the strict `len > min_slice_len` check."""
    live = LiveTranscriber(port_t, verbose=False, min_slice_t=0.5)
    assert live._min_sep_s * live.sample_rate > live.min_slice_len
    live_d = LiveTranscriber(port_t, verbose=False)
    assert live_d._min_sep_s * live_d.sample_rate > live_d.min_slice_len
    assert live_d._min_sep_s == LIVE_MIN_SEP  # K5's live-window tests


def test_process_buffer_consumes_onset_at_index_zero():
    live = _bare_live()
    live.detect_onsets = lambda y: [0]
    live.buffer.push(np.arange(22050, dtype=np.float32))
    assert live.process_buffer() == 1
    _, start = live.buffer.snapshot()
    assert start >= 1, "the consumed prefix was not cleared"
    live.detect_onsets = lambda y: []
    assert live.process_buffer(force=True) == 0
    assert live.note_q.qsize() == 1


def test_process_buffer_no_consumption_clears_nothing():
    live = _bare_live(ring=8192, min_slice_t=4096 / 22050)
    live.detect_onsets = lambda y: []
    live.buffer.push(np.arange(8192, dtype=np.float32))
    assert live.process_buffer() == 0
    assert live.buffer.size() == 8192


def test_single_onset_clear_preserves_undetectable_next_attack():
    """A single-onset slice's clear stops short of a next attack that the
    detector cannot see yet (inside its right-edge latency), which then
    surfaces exactly once on the next poll."""
    ring_n = 33075
    live = _bare_live(ring=ring_n)
    a_abs, b_abs = 23075, 31500

    def fake_detect(buf):
        _, start = live.buffer.snapshot()
        return [o - start for o in (a_abs, b_abs)
                if o >= start and (o - start) + live._edge_latency
                <= len(buf)]

    live.detect_onsets = fake_detect
    live.buffer.push(np.ones(ring_n, np.float32))
    assert live.process_buffer() == 1
    _, start = live.buffer.snapshot()
    assert start > a_abs + live._attack_guard - 1
    assert start <= b_abs - live._onset_ctx
    while live.buffer.size() < ring_n:
        need = ring_n - live.buffer.size()
        live.buffer.push(np.ones(min(1024, need), np.float32))
    assert live.process_buffer() == 1
    assert live.note_q.qsize() == 2
    assert live.buffer.overwritten == 0


def test_force_flush_slices_trailing_onset_after_pairs():
    live = _bare_live(ring=33075)
    live.detect_onsets = lambda y: [1000, 10000, 19000]
    live.buffer.push(np.ones(30000, np.float32))
    assert live.process_buffer() == 0
    assert live.process_buffer(force=True) == 3
    assert live.note_q.qsize() == 3


def test_multi_pair_poll_drains_instead_of_evicting():
    live = _bare_live(ring=33075, qsize=2)
    drained: list = []
    live.drain_queue = _fake_drain(live, drained)
    live.detect_onsets = lambda y: [1000, 10000, 19000, 28000]
    live.buffer.push(np.ones(33075, np.float32))
    assert live.process_buffer() == 3
    assert live.queue_drops == 0
    assert len(drained) + live.note_q.qsize() == 3


def test_live_clip_length_follows_checkpoint():
    class StubT:
        clip_length = 1.0

    live = LiveTranscriber(transcriber=StubT(), verbose=False)
    assert live.clip_duration == 1.0
    clip = live.pad_or_trim_audio(np.ones(30000, np.float32),
                                  live.clip_duration, live.sample_rate)
    assert len(clip) == 22050


def test_live_mic_loop_with_fake_sounddevice(port_t, monkeypatch):
    """`live()` end to end with a fake sounddevice module: the callback
    thread pushes (frames, 1) blocks at about real time, the consumer
    loop polls, slices and infers, and the session ends after its
    duration with a flush."""
    y = riff([110.0, 196.0, 246.94], 1.1)
    played = {"A2", "G3", "B3"}

    class FakeInputStream:
        def __init__(self, samplerate, channels, blocksize, callback,
                     dtype):
            assert samplerate == SR and channels == 1
            assert dtype == "float32"
            self._cb, self._bs = callback, blocksize
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._run, daemon=True)

        def _run(self):
            for i in range(0, len(y), self._bs):
                if self._stop.is_set():
                    return
                block = y[i:i + self._bs]
                self._cb(block.reshape(-1, 1), len(block), None, None)
                time.sleep(0.04)  # about real time (1024 / 22050 s)

        def __enter__(self):
            self._thread.start()
            return self

        def __exit__(self, *exc):
            self._stop.set()
            self._thread.join(timeout=10)
            assert not self._thread.is_alive()
            return False

    fake_sd = types.ModuleType("sounddevice")
    fake_sd.InputStream = FakeInputStream
    monkeypatch.setitem(sys.modules, "sounddevice", fake_sd)

    live = LiveTranscriber(port_t, verbose=False)
    labels = []
    for _ in range(3):  # a stalled poll on a loaded host can lap the ring
        live.buffer.clear()
        live.results.clear()
        labels = [r["labels"][0] for r in live.live(duration=len(y) / SR)]
        if len(labels) >= 2 and set(labels) <= played:
            break
    assert len(labels) >= 2, labels
    assert set(labels) <= played, labels
