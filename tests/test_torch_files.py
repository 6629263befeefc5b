"""PyTorch port vs gat_tpu: the many-file serving path,
`Transcriber.transcribe_files` (CPU, the shipped checkpoints, plain
versions of the kernels).

Bounds, as test_torch_file_path holds the single-file path: labels,
`onsets_s`, `times`, `onset_overflow` and the order of the results
identical; ensemble probs within atol 1e-2; the YIN baseline within rtol
2e-3. JAX compiles each new (B, n) and budget, so the shapes here are
few: buckets of 2, 4 and 16 s, waves of 2 and 4."""
import sys
import threading
import time

import numpy as np
import pytest

from gat_tpu.infer import Transcriber as JTranscriber
from gat_tpu_torch.infer import Transcriber
from gat_tpu_torch.infer import transcriber as ttr
from gat_tpu_torch.utils.wavio import write_wav
from emulated_kernels import RIFF_NOTES, pluck_riff

SR = 22050
HZ = [f for _, f in RIFF_NOTES]                    # A2 D3 G3 B3 E4
NAMES = ["A2", "D3", "G3", "B3", "E4"]


def _same(got: dict, ref: dict) -> None:
    assert got["labels"] == ref["labels"]
    assert got["onsets_s"] == ref["onsets_s"]
    assert got["times"] == ref["times"]
    assert got["onset_overflow"] == ref["onset_overflow"]
    assert got["probs"].shape == ref["probs"].shape
    np.testing.assert_allclose(got["probs"], ref["probs"], atol=1e-2)
    np.testing.assert_allclose([p for p, _ in got["dsp_info"]],
                               [p for p, _ in ref["dsp_info"]], rtol=2e-3)


def _all_same(got: list, ref: list) -> None:
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _same(g, r)


@pytest.fixture(scope="module")
def jax_t():
    return JTranscriber()


@pytest.fixture(scope="module")
def port_t():
    return Transcriber(device="cpu")


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """`mixed`: 2.6 s at 22050 Hz (bucket 4), 9.5 s at 44100 (bucket 16),
    a silent 2.5 s at 22050 (bucket 4), 1.9 s at 48000 (bucket 2), in
    that order. `scan`: six 3.5 s files, file i playing its notes in a
    rotated order. `four`: five 4-note riffs. `five`: one 5-note riff."""
    d = tmp_path_factory.mktemp("files")

    def wav(name, y, sr):
        write_wav(d / name, y, sr)
        return d / name
    mixed = [wav("a.wav", pluck_riff(SR, 2.6, RIFF_NOTES[:3]), SR),
             wav("long.wav", pluck_riff(44100, 9.5), 44100),
             wav("silent.wav", np.zeros(int(2.5 * SR), np.float32), SR),
             wav("b.wav", pluck_riff(48000, 1.9, RIFF_NOTES[:2]), 48000)]
    scan = [wav(f"scan{i}.wav", pluck_riff(
        SR, 3.5, [(0.4 + 0.7 * j, HZ[(i + j) % 5]) for j in range(4)]), SR)
        for i in range(6)]
    four = [wav(f"four{i}.wav", pluck_riff(SR, 3.3, RIFF_NOTES[:4]), SR)
            for i in range(5)]
    five = [wav("five.wav", pluck_riff(SR, 3.9), SR)]
    return dict(mixed=mixed, scan=scan, four=four, five=five)


def test_mixed_buckets_rates_and_silence(jax_t, port_t, wavs):
    """Three buckets at three input rates, a silent file in a wave: the
    results equal gat_tpu's, in input order; the silent file's result is
    empty with the schema of a full one."""
    paths = wavs["mixed"]
    got = port_t.transcribe_files(paths)
    _all_same(got, jax_t.transcribe_files(paths))
    assert [r["labels"] for r in got] == [
        NAMES[:2], NAMES[:4], [], NAMES[:1]]
    silent = got[2]
    assert silent["probs"].shape == (0, 47) and silent["onsets_s"] == []
    assert silent["per_model_probs"]["cnn"].shape == (0, 47)
    assert port_t.transcribe_files([]) == []


def test_files_equal_transcribe(port_t, wavs):
    """transcribe_files equals the port's own transcribe, file by file
    (the silent file, where transcribe raises, aside)."""
    paths = wavs["mixed"]
    for p, r in zip(paths, port_t.transcribe_files(paths)):
        if not r["labels"]:
            with pytest.raises(ValueError, match="No clips survived"):
                port_t.transcribe(p)
            continue
        _same(r, port_t.transcribe(p))


def test_scanned_chunk_and_remainder(jax_t, port_t, wavs, monkeypatch):
    """Six same-bucket files at max_batch=2: one chunk of K=2 waves and a
    remainder wave, two host transfers in all; every file's result lands
    at its own index."""
    paths = wavs["scan"]
    transfers = []
    to_host = ttr._to_host

    def counting(outs):
        transfers.append(tuple(None if x is None else tuple(x.shape)
                               for x in outs)[0])
        return to_host(outs)
    monkeypatch.setattr(ttr, "_to_host", counting)
    got = port_t.transcribe_files(paths, max_batch=2)
    assert transfers == [(2, 2, 64, 47), (2, 64, 47)]
    _all_same(got, jax_t.transcribe_files(paths, max_batch=2))
    for i, r in enumerate(got):
        assert r["labels"] == [NAMES[(i + j) % 5] for j in range(3)]


def test_exact_fallback_equals_exact_run(jax_t, port_t, wavs):
    """A starved clip budget and candidate walk flag every file; the
    fallback re-runs them through the exact body, regrouped into waves
    of 4 + 1, and gives the exact run's results with no flag."""
    paths = wavs["four"]
    exact = port_t.transcribe_files(paths, max_onsets=8,
                                    wave_clip_budget=None, cand_budget=0,
                                    exact_fallback=False)
    raw = port_t.transcribe_files(paths, max_onsets=8, wave_clip_budget=3,
                                  cand_budget=1, exact_fallback=False)
    assert all(r["onset_overflow"] for r in raw)
    fixed = port_t.transcribe_files(paths, max_onsets=8, wave_clip_budget=3,
                                    cand_budget=1)
    _all_same(fixed, exact)
    assert not any(r["onset_overflow"] for r in fixed)
    _all_same(fixed, jax_t.transcribe_files(paths, max_onsets=8,
                                            wave_clip_budget=3,
                                            cand_budget=1))


def test_starved_clip_budget_keeps_earliest(jax_t, port_t, wavs):
    """Three clip slots for a wave of two 4-note files and no fallback:
    each file keeps its earliest clips, the budget splits fairly, the
    flags rise; equal to gat_tpu's."""
    paths = wavs["four"][:2]
    exact = port_t.transcribe_files(paths, max_onsets=8)
    starved = port_t.transcribe_files(paths, max_onsets=8,
                                      wave_clip_budget=3,
                                      exact_fallback=False)
    _all_same(starved, jax_t.transcribe_files(paths, max_onsets=8,
                                              wave_clip_budget=3,
                                              exact_fallback=False))
    counts = [len(r["labels"]) for r in starved]
    assert sum(counts) == 3 and max(counts) - min(counts) <= 1
    assert all(r["onset_overflow"] for r in starved)
    for rs, re_ in zip(starved, exact):
        assert rs["labels"] == re_["labels"][:len(rs["labels"])]
        assert not re_["onset_overflow"]


def test_cap_scaling(jax_t, port_t, wavs, monkeypatch):
    """max_onsets=2 on a 5-note riff: one re-run at the power of two
    that fits the count (8), equal to a roomy cap's result; a ceiling of
    4 keeps the flag and the first onsets."""
    paths = wavs["five"]
    roomy = port_t.transcribe_files(paths, max_onsets=16)[0]
    calls = []
    files_fn = Transcriber._files_fn

    def spy(self, *a, **kw):
        calls.append(a)
        return files_fn(self, *a, **kw)
    monkeypatch.setattr(Transcriber, "_files_fn", spy)
    auto = port_t.transcribe_files(paths, max_onsets=2)
    assert [a[2] for a in calls if a[2] > 2] == [8]
    _same(auto[0], roomy)
    _all_same(auto, jax_t.transcribe_files(paths, max_onsets=2))
    low = port_t.transcribe_files(paths, max_onsets=2, max_onsets_ceiling=4)
    _all_same(low, jax_t.transcribe_files(paths, max_onsets=2,
                                          max_onsets_ceiling=4))
    assert low[0]["onset_overflow"]
    assert 0 < len(low[0]["labels"]) < len(roomy["labels"])
    assert low[0]["labels"] == roomy["labels"][:len(low[0]["labels"])]


def test_cap_only_overflow_skips_exact_run(port_t, wavs, monkeypatch):
    """A cap-only flag pays no exact re-run (the exact walk gives the
    same first max_onsets onsets) and keeps its flag; a candidate-budget
    flag does re-run."""
    paths = wavs["five"]
    calls = []
    files_fn = Transcriber._files_fn

    def spy(self, *a, **kw):
        calls.append(a)
        return files_fn(self, *a, **kw)
    monkeypatch.setattr(Transcriber, "_files_fn", spy)

    def exact_builds():
        return [a for a in calls if a[3] is None and a[4] == 0]
    r = port_t.transcribe_files(paths, max_onsets=2,
                                max_onsets_ceiling=None)[0]
    assert r["onset_overflow"] and not exact_builds()
    raw = port_t.transcribe_files(paths, max_onsets=2,
                                  exact_fallback=False)[0]
    _same(r, raw)
    calls.clear()
    fixed = port_t.transcribe_files(paths, max_onsets=8, cand_budget=1)[0]
    assert exact_builds() and not fixed["onset_overflow"]


def test_files_fn_built_once_across_threads(port_t, monkeypatch):
    """Threads asking at once for one parameter set share one body (the
    HTTP server's dispatchers share a Transcriber); the clip budget is
    part of the key."""
    built = []

    def slow_build(*a, **kw):
        time.sleep(0.01)  # widen a check-then-build race
        built.append(kw["wave_clip_budget"])
        return lambda ys, nvs: None
    monkeypatch.setattr(ttr, "build_files_fn", slow_build)
    monkeypatch.setattr(port_t, "_files_fns", {})
    got = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: got.append(
            port_t._files_fn(SR, 0.5, 64, 96, None))) for _ in range(32)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    assert built == [96] and len(got) == 32
    assert all(g is got[0] for g in got)
    assert port_t._files_fn(SR, 0.5, 64, None, None) is not got[0]
    assert built == [96, None]


@pytest.mark.parametrize("kwargs,match", [
    (dict(wave_clip_budget="some"), "wave_clip_budget must be"),
    (dict(cand_budget="some"), "cand_budget must be"),
    (dict(wave_clip_budget=-1), "wave_clip_budget must be >= 1"),
    (dict(wave_clip_budget=0), "wave_clip_budget must be >= 1"),
])
def test_bad_budgets_raise(port_t, wavs, kwargs, match):
    with pytest.raises(ValueError, match=match):
        port_t.transcribe_files(wavs["five"], **kwargs)
