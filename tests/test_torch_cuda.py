"""The CUDA kernels against their plain versions on the card. Every test
carries the `cuda` marker and skips without a card. On a machine with one
(`--noconftest`: the tests directory's conftest imports jax, which the
port does not need):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from gat_tpu_torch import features
from gat_tpu_torch.ops import compaction, onset, resample, spectral, yin
from gat_tpu_torch.segment import gating, slicing
from emulated_kernels import (FILE_SR, GATE_MIN_DB, LIVE_MIN_SEP,
                              WAVE_SHAPES, WAVE_SHAPES_PAST,
                              check_selection,
                              scatter_parts, wave_flags, wave_kept,
                              LIVE_RING, RESAMPLE_PINS,
                              RESAMPLE_RATES,
                              RIFF_NOTES, SLICE_PINS,
                              SLICE_PINS_PAST_ROW, _digest,
                              check_gate,
                              check_mel_image, check_slice,
                              check_mfcc_level_step,
                              check_zero_row, edge_envelopes,
                              file_batch, frame_count_clips,
                              frames_clips, level_step_clip,
                              mfcc_level_step_clip, padded_wave,
                              PLUCK_NEAR_TIE, past_row_inputs,
                              pin_inputs,
                              pluck_riff, port_pluck_clips,
                              random_envelopes,
                              resample_pin_digest, riffs, scan_envelopes,
                              shared_frontend_clips, stitch,
                              time_shards, yin_float64)

pytestmark = pytest.mark.cuda

SR = 11025


def _tones(noise: float) -> torch.Tensor:
    """47 decaying tones from 82.4 to 1174.7 Hz plus noise, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(3)
    t = np.arange(5512) / SR
    x = np.stack([np.sin(2 * np.pi * f * t) * np.exp(-3 * t)
                  for f in np.geomspace(82.4, 1174.7, 47)])
    x = x + rng.normal(0, noise, x.shape)
    return torch.from_numpy(x.astype(np.float32)).cuda()


@pytest.fixture
def clips():
    return _tones(0.1)


@pytest.mark.parametrize("length", [5512, 5300, 1100])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("to_db", [True, False])
def test_melspec_kernel(clips, normalize, to_db, length):
    """22, 21 and 5 frames: the odd counts run the last frame with a zero
    partner in its FFT."""
    x = clips[:, :length].contiguous()
    before = features.melspec_features.launches
    got = features.melspec_features(x, SR, normalize_audio_volume=normalize,
                                    to_db=to_db)
    ref = features.melspec_features_plain(x, SR,
                                          normalize_audio_volume=normalize,
                                          to_db=to_db)
    torch.cuda.synchronize()
    assert features.melspec_features.launches == before + 1
    assert got.shape == (47, 64, spectral.n_frames(length, 2048, 256), 1)
    check_mel_image(got, ref, to_db)


def test_melspec_kernel_level_step():
    """A silent frame sharing its FFT with a loud one keeps its level."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.from_numpy(level_step_clip()).cuda()
    got = features.melspec_features(x, SR)
    ref = features.melspec_features_plain(x, SR)
    torch.cuda.synchronize()
    check_mel_image(got, ref, True)


@pytest.mark.parametrize("length", [5512, 4608, 1100])
@pytest.mark.parametrize("normalize", [True, False])
def test_mfcc_kernel(clips, normalize, length):
    """11, 10 and 3 frames: the odd counts run the last frame with a zero
    partner in its FFT."""
    x = clips[:, :length].contiguous()
    before = features.mfcc_frontend.launches
    got = features.mfcc_frontend(x, SR, 64, normalize)
    ref = features.mfcc_frontend_plain(x, SR, 64, normalize)
    torch.cuda.synchronize()
    assert features.mfcc_frontend.launches == before + 1
    torch.testing.assert_close(got, ref, atol=1e-3, rtol=0)


def test_mfcc_kernel_level_step():
    """A near-silent frame sharing its FFT with a loud one, below the
    clip's top_db clamp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.from_numpy(mfcc_level_step_clip()).cuda()
    check_mfcc_level_step(x)
    got = features.mfcc_frontend(x, SR)
    ref = features.mfcc_frontend_plain(x, SR)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("noise", [0.1, 0.0])
@pytest.mark.parametrize("length", [5512, 4608, 3000])
def test_yin_kernel(noise, length):
    x = _tones(noise)[:, :length].contiguous()
    got = yin.yin_pitch(x, SR)
    ref = yin.yin_pitch_plain(x, SR)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=2e-3, atol=0)


@pytest.mark.parametrize("length", [5512, 4608])
def test_yin_kernel_22050(length):
    """At 22050 Hz: lags 0..441, two lag blocks of the ACF."""
    x = _tones(0.1)[:, :length].contiguous()
    got = yin.yin_pitch(x, 22050)
    ref = yin.yin_pitch_plain(x, 22050)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=2e-3, atol=0)


@pytest.mark.parametrize("wrapper", [features.melspec_features,
                                     features.mfcc_frontend, yin.yin_pitch],
                         ids=lambda f: f.__name__)
def test_wrappers_check_inputs(clips, wrapper):
    with pytest.raises(ValueError, match="float32"):
        wrapper(clips.double(), SR)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(clips.t().contiguous().t(), SR)
    assert wrapper(clips[:0], SR).shape[0] == 0


def test_transcribe_clips_card_vs_cpu(clips):
    from gat_tpu_torch.infer import Transcriber
    got = Transcriber(device="cuda").transcribe_clips(clips)
    ref = Transcriber(device="cpu").transcribe_clips(clips.cpu())
    assert got["labels"] == ref["labels"]
    np.testing.assert_allclose(got["probs"], ref["probs"], atol=1e-2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [22050, 45000, 176400])
@pytest.mark.parametrize("padded", [False, True])
def test_onset_envelope_kernel(n, padded):
    """44, 88 and 345 frames (11 to 87 rounds of four per file), with
    and without a valid prefix."""
    dev = _card()
    y = torch.from_numpy(riffs(n)).to(dev)
    t = spectral.n_frames(n, 2048, 512)
    nvf = (torch.tensor([t, t - 5, 1 + int(0.6 * n) // 512], device=dev)
           if padded else None)
    before = onset.onset_strength.launches
    got = onset.onset_strength(y, FILE_SR, n_valid_frames=nvf)
    ref = onset.onset_strength_plain(y, FILE_SR, n_valid_frames=nvf)
    torch.cuda.synchronize()
    assert onset.onset_strength.launches == before + 1
    torch.testing.assert_close(got, ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("n", [88200, 22562])
def test_onset_envelope_kernel_batches(b, n):
    """One file and a wave of four: 4 s files (173 frames, the file
    path's shape) and 45 frames (a last round of one frame)."""
    dev = _card()
    y, nvf = file_batch(n, b)
    y, nvf = y.to(dev), nvf.to(dev)
    before = onset.onset_strength.launches
    got = onset.onset_strength(y, FILE_SR, n_valid_frames=nvf)
    ref = onset.onset_strength_plain(y, FILE_SR, n_valid_frames=nvf)
    torch.cuda.synchronize()
    assert onset.onset_strength.launches == before + 1
    torch.testing.assert_close(got, ref, atol=1e-3, rtol=0)


def test_onset_envelope_kernel_grid_invariant():
    """Bit-identical envelopes for first-pass grids of 1 and 3 blocks, the
    card-sized default, and more blocks than rounds."""
    dev = _card()
    y, nvf = file_batch(88200, 4)
    y, nvf = y.to(dev), nvf.to(dev)
    ref = onset.onset_strength(y, FILE_SR, n_valid_frames=nvf)
    for grid in (1, 3, 4 * 44 + 1):
        got = onset.onset_strength(y, FILE_SR, n_valid_frames=nvf, grid=grid)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("cand_budget", [None, 0, 3])
@pytest.mark.parametrize("backtrack", [True, False])
@pytest.mark.parametrize("t", [300, 2584, 17227])
def test_onset_pick_kernel(cand_budget, backtrack, t):
    """All five outputs identical to the plain version, for a 7 s, a 60 s
    and a 400 s envelope (17 tiles; the first K5 refused it)."""
    dev = _card()
    env = torch.from_numpy(random_envelopes(t, 0)).to(dev)
    nvf = torch.tensor([t, t - 89, 40], device=dev)
    for max_onsets in (4, 64):
        before = onset.pick_onsets.launches
        got = onset.pick_onsets(env, FILE_SR, 512, 0.3, max_onsets,
                                backtrack, nvf, cand_budget)
        ref = onset.pick_onsets_plain(env, FILE_SR, 512, 0.3, max_onsets,
                                      backtrack, nvf, cand_budget)
        torch.cuda.synchronize()
        assert onset.pick_onsets.launches == before + 1
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


@pytest.mark.parametrize("b", [1, 4])
def test_onset_pick_kernel_batches(b):
    """One 4 s file and a wave of four (173 frames), from the plain
    envelope, with int32 counts as `detect_onsets` gives them and with
    none; the planted tile-edge onsets too."""
    dev = _card()
    y, nvf = file_batch(88200, b)
    env = onset.onset_strength_plain(y, FILE_SR, n_valid_frames=nvf).to(dev)
    for counts in (nvf.to(device=dev, dtype=torch.int32), None):
        got = onset.pick_onsets(env, FILE_SR, 512, 0.3, 64,
                                n_valid_frames=counts)
        ref = onset.pick_onsets_plain(env, FILE_SR, 512, 0.3, 64,
                                      n_valid_frames=counts)
        torch.cuda.synchronize()
        assert bool(ref[1].any())
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
    edges = torch.from_numpy(edge_envelopes(1025)).to(dev)
    for g, r in zip(onset.pick_onsets(edges, FILE_SR, 512, 0.3, 64),
                    onset.pick_onsets_plain(edges, FILE_SR, 512, 0.3, 64)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("n", [45000, 88200])
def test_onset_kernels_zero_row(n):
    """A wave padded as `transcribe_files` pads it, a zero row of n_valid
    0 among two riffs: K4 and K5 equal their plain versions, and the zero
    row gives no onset and no flag."""
    dev = _card()
    y, nvf = padded_wave(n)
    y, nvf = y.to(dev), nvf.to(dev)
    before = [onset.onset_strength.launches, onset.pick_onsets.launches]
    env = onset.onset_strength(y, FILE_SR, n_valid_frames=nvf)
    check_zero_row(y, nvf, env, lambda e, v, c: onset.pick_onsets(
        e, FILE_SR, 512, 0.3, 64, n_valid_frames=v, cand_budget=c))
    assert onset.onset_strength.launches == before[0] + 1
    assert onset.pick_onsets.launches == before[1] + 2


def test_onset_wrappers_check_inputs():
    dev = _card()
    env = torch.from_numpy(random_envelopes(300, 0)).to(dev)
    for call in (lambda x: onset.onset_strength(x, FILE_SR),
                 lambda x: onset.pick_onsets(x, FILE_SR, 512, 0.3, 64)):
        with pytest.raises(ValueError, match="float32"):
            call(env.double())
        with pytest.raises(ValueError, match="contiguous"):
            call(env.t().contiguous().t())


def test_transcribe_card_vs_cpu(tmp_path):
    """The whole-file path on the card, both routes, against the plain
    path on the CPU; all five kernels launch."""
    _card()
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.utils.wavio import write_wav
    path = tmp_path / "riff.wav"
    write_wav(path, pluck_riff(44100, 3.9), 44100)
    ref = Transcriber(device="cpu").transcribe(path)
    card = Transcriber(device="cuda")
    for fused in (False, True):
        counts = [f.launches for f in (features.melspec_features,
                                       features.mfcc_frontend, yin.yin_pitch,
                                       onset.onset_strength,
                                       onset.pick_onsets)]
        got = card.transcribe(path, fused=fused)
        after = [f.launches for f in (features.melspec_features,
                                      features.mfcc_frontend, yin.yin_pitch,
                                      onset.onset_strength, onset.pick_onsets)]
        assert all(a > b for a, b in zip(after, counts))
        assert got["labels"] == ref["labels"] == ["A2", "D3", "G3", "B3"]
        assert got["onsets_s"] == ref["onsets_s"]
        assert got["times"] == ref["times"]
        np.testing.assert_allclose(got["probs"], ref["probs"], atol=1e-2)


def test_transcribe_files_card_vs_cpu(tmp_path):
    """The many-file path on the card against the CPU's: three buckets at
    three rates, a silent file, six same-bucket files at max_batch=2 (a
    chunk of K = 2 waves and a remainder), the exact fallback; all five
    kernels launch."""
    _card()
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.utils.wavio import write_wav
    specs = [(22050, 2.6, RIFF_NOTES[:3]), (44100, 9.5, RIFF_NOTES),
             (22050, 2.5, ()), (48000, 1.9, RIFF_NOTES[:2])]
    specs += [(22050, 3.5, RIFF_NOTES[i:i + 4]) for i in (0, 1)] * 3
    paths = []
    for i, (sr, dur, notes) in enumerate(specs):
        paths.append(tmp_path / f"f{i}.wav")
        write_wav(paths[-1], pluck_riff(sr, dur, notes), sr)
    cpu, card = Transcriber(device="cpu"), Transcriber(device="cuda")
    wrappers = (features.melspec_features, features.mfcc_frontend,
                yin.yin_pitch, onset.onset_strength, onset.pick_onsets)
    for kwargs in (dict(), dict(max_batch=2),
                   dict(wave_clip_budget=3, cand_budget=1)):
        before = [f.launches for f in wrappers]
        got = card.transcribe_files(paths, **kwargs)
        assert all(f.launches > b for f, b in zip(wrappers, before))
        ref = cpu.transcribe_files(paths, **kwargs)
        assert [g["labels"] for g in got] == [r["labels"] for r in ref]
        assert got[2]["labels"] == [] and got[2]["probs"].shape == (0, 47)
        for g, r in zip(got, ref):
            assert g["onsets_s"] == r["onsets_s"] and g["times"] == r["times"]
            assert g["onset_overflow"] == r["onset_overflow"]
            np.testing.assert_allclose(g["probs"], r["probs"], atol=1e-2)


def test_transcribe_clips_card_bf16(clips):
    """The bf16 CNN on the card gives the labels of the CPU's bf16 CNN."""
    from gat_tpu_torch.infer import Transcriber
    got = Transcriber(cnn_dtype=torch.bfloat16,
                      device="cuda").transcribe_clips(clips)
    ref = Transcriber(cnn_dtype=torch.bfloat16,
                      device="cpu").transcribe_clips(clips.cpu())
    assert got["labels"] == ref["labels"]
    np.testing.assert_allclose(got["probs"], ref["probs"], atol=1e-2)


def test_onset_envelope_kernel_hops_1024_512_1024():
    """K4 at hop 1024, 512, then 1024 again in one process from a cold
    grid cache (the live engine's hop, the file path's, the live one's):
    every launch runs and equals its plain version. The parent's third
    launch failed: its cached hop-1024 grid never set the 59,088 B
    shared-memory attribute again after the hop-512 query set 52,944 B."""
    dev = _card()
    onset._envelope_grid.cache_clear()
    y = torch.from_numpy(riffs(LIVE_RING)).to(dev)
    for hop in (1024, 512, 1024):
        before = onset.onset_strength.launches
        got = onset.onset_strength(y, FILE_SR, hop_length=hop)
        ref = onset.onset_strength_plain(y, FILE_SR, hop_length=hop)
        torch.cuda.synchronize()
        assert onset.onset_strength.launches == before + 1
        torch.testing.assert_close(got, ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("cand_budget", [None, 0])
def test_onset_pick_kernel_stream_windows(cand_budget):
    """K5 at the live engine's windows (22050 Hz, hop 1024: a moving max
    of size 1, wait 0; 33 frames, its min separation) on K4's envelopes
    of live rings and random ones, and at the scan engine's budget (8
    slots, min_sep 0, 65 frames, 32 candidates walked)."""
    dev = _card()
    rings = torch.from_numpy(riffs(LIVE_RING)).to(dev)
    env = torch.cat([onset.onset_strength(rings, FILE_SR, hop_length=1024),
                     torch.from_numpy(random_envelopes(33, 5)).to(dev)])
    nvf = torch.tensor([33, 33, 20, 33, 25, 3], dtype=torch.int32,
                       device=dev)
    scan_env = torch.from_numpy(scan_envelopes()).to(dev)
    for args, env, counts in (((FILE_SR, 1024, LIVE_MIN_SEP, 64), env, nvf),
                              ((FILE_SR, 512, 0.0, 8), scan_env, None)):
        got = onset.pick_onsets(env, *args, n_valid_frames=counts,
                                cand_budget=cand_budget)
        ref = onset.pick_onsets_plain(env, *args, n_valid_frames=counts,
                                      cand_budget=cand_budget)
        torch.cuda.synchronize()
        assert bool(ref[1].any())
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


def _stream_riff(seconds: float) -> np.ndarray:
    """RIFF_NOTES' five notes in turn, a pluck every 0.55 s from 0.4 s."""
    freqs = [f for _, f in RIFF_NOTES]
    notes = [(0.4 + 0.55 * i, freqs[i % 5])
             for i in range(int((seconds - 0.85) / 0.55) + 1)]
    return pluck_riff(FILE_SR, seconds, notes)


def test_scan_streamer_card_vs_cpu():
    """ScanStreamer on the card against the CPU on a 5 s riff: the same
    slots, takes and flags, the same notes; K1-K5 launch."""
    _card()
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.stream import ScanStreamer
    y = _stream_riff(5.0)
    card = ScanStreamer(Transcriber(device="cuda"))
    cpu = ScanStreamer(Transcriber(device="cpu"))
    for a, b in zip(card.segment_stream(y), cpu.segment_stream(y)):
        np.testing.assert_array_equal(a, b)
    wrappers = (features.melspec_features, features.mfcc_frontend,
                yin.yin_pitch, onset.onset_strength, onset.pick_onsets)
    before = [f.launches for f in wrappers]
    got = card.transcribe_stream(y)
    assert all(f.launches > b for f, b in zip(wrappers, before))
    ref = cpu.transcribe_stream(y)
    assert [(r["onset_s"], r["labels"]) for r in got] == \
        [(r["onset_s"], r["labels"]) for r in ref]
    assert len(got) >= 8
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g["probs"], r["probs"], atol=1e-2)


def test_live_transcriber_card_vs_cpu():
    """LiveTranscriber.run_on_source on the card against the CPU: the same
    notes; K4 and K5 launch at hop 1024 once per poll."""
    _card()
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.stream import ArraySource, LiveTranscriber
    y = _stream_riff(4.0)
    card = LiveTranscriber(Transcriber(device="cuda"), verbose=False)
    before = [onset.onset_strength.launches, onset.pick_onsets.launches]
    got = card.run_on_source(ArraySource(y))
    launches = [onset.onset_strength.launches - before[0],
                onset.pick_onsets.launches - before[1]]
    ref = LiveTranscriber(Transcriber(device="cpu"),
                          verbose=False).run_on_source(ArraySource(y))
    assert [r["labels"] for r in got] == [r["labels"] for r in ref]
    assert len(got) >= 5 and launches[0] == launches[1] > 0
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g["probs"], r["probs"], atol=1e-2)


def test_audio_slicer_card_vs_cpu(tmp_path):
    """AudioSlicer.slice_and_save on the card: the CPU's onsets and clip
    files, their samples within one step of 16-bit PCM (the files are
    16-bit, and the card's resample differs from the CPU's in the last
    float32 bits, which can move a sample across a rounding edge)."""
    _card()
    from gat_tpu_torch.segment.slicing import AudioSlicer
    from gat_tpu_torch.utils.wavio import read_wav, write_wav
    path = tmp_path / "riff.wav"
    write_wav(path, pluck_riff(44100, 3.0, RIFF_NOTES[:4]), 44100)
    got = AudioSlicer().slice_and_save(path, tmp_path / "card",
                                       verbose=False)
    ref = AudioSlicer(device="cpu").slice_and_save(path, tmp_path / "cpu",
                                                   verbose=False)
    assert got == ref and len(got) == 4
    names = sorted(p.name for p in (tmp_path / "card").glob("*.wav"))
    assert names == sorted(p.name for p in (tmp_path / "cpu").glob("*.wav"))
    for name in names:
        np.testing.assert_allclose(read_wav(tmp_path / "card" / name)[0],
                                   read_wav(tmp_path / "cpu" / name)[0],
                                   atol=1 / 32768)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def recipe_dataset(tmp_path_factory):
    """The shipped recipe at 16 variants per class: 752 clips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gat_tpu_torch.data.synth import synthesize_note_dataset
    root = tmp_path_factory.mktemp("train") / "synthetic" / "recipe"
    synthesize_note_dataset(root, variants_per_class=16, seed=42,
                            verbose=False, noise_snr_db=(8.0, 40.0),
                            family="all3", stressor="mix", stressor_prob=0.5,
                            channel="mix", channel_prob=0.25)
    return root


def test_feature_builder_752_clips_kernels_vs_plain(recipe_dataset):
    """K1-K3 through the FeatureBuilder at the dataset's shape, each
    launched once, against the CPU plain path."""
    from gat_tpu_torch.data.loader import AudioDatasetLoader
    loaders = {dev: AudioDatasetLoader([recipe_dataset], target_sr=SR,
                                       duration=0.5, device=dev)
               for dev in ("cuda", "cpu")}
    before = [features.melspec_features.launches,
              features.mfcc_frontend.launches, yin.yin_pitch.launches]
    out = {dev: (features.FeatureBuilder(device=dev)
                 .extract_mfcc_features(loaders[dev])[0],
                 features.FeatureBuilder(device=dev)
                 .extract_melspec_features(loaders[dev])[0])
           for dev in ("cuda", "cpu")}
    after = [features.melspec_features.launches,
             features.mfcc_frontend.launches, yin.yin_pitch.launches]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    (mf, mel), (mf_ref, mel_ref) = out["cuda"], out["cpu"]
    assert mf.shape == (752, 65) and mel.shape == (752, 64, 22, 1)
    np.testing.assert_allclose(mf[:, :64], mf_ref[:, :64], atol=1e-3, rtol=0)
    np.testing.assert_allclose(10.0 ** (mf[:, 64] - mf_ref[:, 64]), 1.0,
                               atol=2e-3, rtol=0)
    mask = mel_ref > -60.0
    np.testing.assert_allclose(mel[mask], mel_ref[mask], atol=0.1, rtol=0)


def _step_pair(make, x, y):
    from gat_tpu_torch.train import ArrayDataLoader, Trainer
    pair = [Trainer(make(), ArrayDataLoader(x, y), seed=0, device=dev)
            for dev in ("cuda", "cpu")]
    for t in pair:
        t._step(torch.as_tensor(x).to(t.device),
                torch.as_tensor(y).long().to(t.device))
    return pair


@pytest.mark.parametrize("kind", ["mlp", "cnn", "cnn_bf16"])
def test_one_step_card_vs_cpu(kind, clips):
    """One dropout-0 step from the same weights on the mel images (CNN) or
    MFCC features (MLP) of 32 tones: fp32 gradients within 1e-3 of their
    largest CPU element; bf16 gradients within 2e-2 of the CPU's in norm
    (cuDNN's and the CPU's bf16 convolutions round differently, element
    by element). The conv biases ahead of BatchNorm (true gradient 0) are
    left out."""
    from gat_tpu_torch.models import CNN, MLP
    y = np.arange(32)
    if kind == "mlp":
        x = features.mfcc_feature_vectors(clips[:32], SR).cpu().numpy()
        x = (x - x.mean(0)) / x.std(0)
        make = lambda: MLP(65, 128, 2, 47, 0.0)  # noqa: E731
    else:
        x = features.melspec_features(clips[:32], SR).cpu().numpy()
        dtype = torch.bfloat16 if kind == "cnn_bf16" else torch.float32
        make = lambda: CNN(47, dropout=0.0, dtype=dtype)  # noqa: E731
    card, cpu = _step_pair(make, x, y)
    for (name, p), q in zip(card.model.named_parameters(),
                            cpu.model.parameters()):
        if name.startswith("conv_") and name.endswith(".bias"):
            continue
        got, ref = p.grad.cpu(), q.grad
        if kind == "cnn_bf16":
            assert float((got - ref).norm() / ref.norm()) <= 2e-2, name
        else:
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                       err_msg=name,
                                       atol=1e-3 * float(ref.abs().max()))


def test_batchnorm_biased_running_variance_on_card():
    """Train mode moves the running variance toward the biased batch
    variance (flax), by momentum 0.1, on the card as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gat_tpu_torch.models import CNN
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 2, 3, 5)).astype(np.float32))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    for dev in ("cuda", "cpu"):
        m = CNN(in_channels=2, base_channels=2, num_blocks=1).to(dev).train()
        m._batch_norm("bn_0", x.to(dev))
        np.testing.assert_allclose(m.bn_0.running_var.cpu().numpy(),
                                   (0.9 + 0.1 * var).numpy(), rtol=1e-6)


def test_saved_checkpoint_loads_in_transcriber(tmp_path):
    """A card-trained pair saved and loaded back: transcribe_clips with all
    weight on one model gives that trainer's predictions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gat_tpu_torch.data.synth import DEFAULT_CLASS_NAMES
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.models import CNN, MLP
    from gat_tpu_torch.train import ArrayDataLoader, Trainer
    from gat_tpu_torch.utils.scaler import FeatureScaler
    clips = _tones(0.05)
    y = np.arange(47)
    rm = dict(enumerate(sorted(DEFAULT_CLASS_NAMES)))
    mf = features.mfcc_feature_vectors(clips, SR).cpu().numpy()
    mel = features.melspec_features(clips, SR).cpu().numpy()
    scaler = FeatureScaler().fit(mf)
    mlp = Trainer(MLP(65), ArrayDataLoader(scaler.transform(mf), y),
                  reverse_map=rm, scaler=scaler, model_type="mlp")
    cnn = Trainer(CNN(47), ArrayDataLoader(mel, y), reverse_map=rm,
                  model_type="cnn")
    for t in (mlp, cnn):
        t.train(epochs=2, verbose=False)
    paths = [t.save(root=tmp_path, target_sr=SR) for t in (mlp, cnn)]
    for w, t, x in ((0.0, mlp, scaler.transform(mf)), (1.0, cnn, mel)):
        tr = Transcriber(mlp_ckpt=paths[0], cnn_ckpt=paths[1], cnn_weight=w,
                         device="cuda")
        got = tr.transcribe_clips(clips)["labels"]
        assert got == [rm[int(i)] for i in t.predict(x)]


# ---------------------------------------------------------------------------
# the rest of the public API, and the note-accuracy harness
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("valid_end", [None, 200])
def test_pick_onsets_from_envelope_card_vs_plain(valid_end):
    """The reference's signature on the card: K5 launched once per call,
    every output identical to the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    y = torch.from_numpy(riffs(8 * FILE_SR, seed=4)).cuda()
    env = onset.onset_strength(y, FILE_SR)
    valid = (None if valid_end is None
             else torch.arange(env.shape[-1], device="cuda") < valid_end)
    for e in (env, env[1]):
        before = onset.pick_onsets.launches
        got = onset.pick_onsets_from_envelope(e, FILE_SR, 512, 0.3, 16,
                                              True, valid)
        ref = onset.pick_onsets_from_envelope(
            e.cpu(), FILE_SR, 512, 0.3, 16, True,
            None if valid is None else valid.cpu())
        assert onset.pick_onsets.launches == before + 1
        for g, r in zip(got, ref):
            assert g.is_cuda
            np.testing.assert_array_equal(g.cpu().numpy(), r.numpy())


def test_inference_features_card_vs_cpu(clips):
    """FeatureBuilder's three inference extractors on the card: K1-K3
    launched, features held to the CPU plain path as the kernels are
    (MFCC 1e-3, pitch rel 2e-3, mel 0.1 dB where > -60 dB)."""
    from gat_tpu_torch.infer import Transcriber
    t = Transcriber(device="cuda")
    cpu = features.FeatureBuilder(device="cpu")
    mfcc, mel = t.mfcc_params, t.melspec_params
    calls = (
        ("extract_inference_features_from_clips",
         (clips, SR, mfcc, mel, t.scaler), (clips.cpu(), SR, mfcc, mel,
                                            t.scaler)),
        ("extract_inference_features_from_audio",
         (clips[5], SR, mfcc, mel), (clips[5].cpu(), SR, mfcc, mel)))
    for name, args, cpu_args in calls:
        before = [w.launches for w in (features.melspec_features,
                                       features.mfcc_frontend,
                                       yin.yin_pitch)]
        mf, ms = getattr(t.feature_builder, name)(*args)
        after = [w.launches for w in (features.melspec_features,
                                      features.mfcc_frontend, yin.yin_pitch)]
        assert [a - b for a, b in zip(after, before)] == [1, 1, 1], name
        rmf, rms = getattr(cpu, name)(*cpu_args)
        mf, ms = mf.cpu().numpy(), ms.cpu().numpy()
        rmf, rms = rmf.numpy(), rms.numpy()
        if name.endswith("clips"):   # unscaled: the scale amplifies
            mf = mf * t.scaler.scale_ + t.scaler.mean_
            rmf = rmf * t.scaler.scale_ + t.scaler.mean_
        np.testing.assert_allclose(mf[:, :64], rmf[:, :64], atol=1e-3,
                                   rtol=0)
        np.testing.assert_allclose(10.0 ** (mf[:, 64] - rmf[:, 64]), 1.0,
                                   atol=2e-3, rtol=0)
        mask = rms > -60.0
        np.testing.assert_allclose(ms[mask], rms[mask], atol=0.1, rtol=0)


def test_feature_builder_long_clips_on_the_card(tmp_path):
    """Clips past the 2000 frames the clip kernels once refused run on the
    card, by the dataset and the inference extractors alike: a loader
    holding one 100 s file, and 2 x (256 x 2000) samples. Each call
    launches the kernels (no plain version, no CPU) and gives the CPU
    plain path's features."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses
    from gat_tpu_torch.data.loader import AudioDatasetLoader
    from gat_tpu_torch.utils.wavio import write_wav
    from emulated_kernels import long_riff
    (tmp_path / "E2").mkdir()
    write_wav(tmp_path / "E2" / "long.wav", long_riff(100.0)[0], 11025)
    fb, cpu = (features.FeatureBuilder(device="cuda"),
               features.FeatureBuilder(device="cpu"))
    loader = AudioDatasetLoader([tmp_path], target_sr=11025, device="cuda")
    cpu_loader = AudioDatasetLoader([tmp_path], target_sr=11025,
                                    device="cpu")
    mfcc = dataclasses.asdict(features.MFCC_CONFIG)
    mel = dataclasses.asdict(features.MELSPEC_CONFIG)
    long = torch.from_numpy(np.concatenate(
        [long_riff(46.5), long_riff(46.5, seed=7)])[:, :256 * 2000])

    def check(got, ref):
        for g, r in zip(got, ref):
            g = np.asarray(g.cpu() if isinstance(g, torch.Tensor) else g)
            r = np.asarray(r)
            assert g.shape == r.shape
            if g.ndim == 4:  # the mel image
                mask = r > -60.0
                np.testing.assert_allclose(g[mask], r[mask], atol=0.1)
            else:
                np.testing.assert_allclose(g[:, :64], r[:, :64], atol=1e-3)
                np.testing.assert_allclose(10.0 ** (g[:, 64] - r[:, 64]),
                                           1.0, atol=2e-3)
    calls = (
        (lambda b, ld: b.extract_mfcc_features(ld)[:1], True),
        (lambda b, ld: b.extract_melspec_features(ld)[:1], True),
        (lambda b, ld: b.extract_inference_features(ld), True),
        (lambda b, ld: b.extract_inference_features_from_clips(
            long.to(b.device), 11025, mfcc, mel), False),
        (lambda b, ld: b.extract_inference_features_from_audio(
            long[0].to(b.device), 11025, mfcc, mel), False))
    wrappers = (features.melspec_features, features.mfcc_frontend,
                yin.yin_pitch)
    for call, _ in calls:
        before = [w.launches for w in wrappers]
        got = call(fb, loader)
        after = [w.launches for w in wrappers]
        assert sum(a - b for a, b in zip(after, before)) >= 1
        check(got, call(cpu, cpu_loader))


def test_evaluate_set_card_vs_cpu(tmp_path):
    """tools/torch_evaluate.py's evaluate_set at 2 variants with the
    witness: the card's correct counts equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import importlib.util
    from pathlib import Path
    from gat_tpu_torch.config import MLP_CONFIG
    from gat_tpu_torch.infer import Transcriber
    tools = Path(__file__).resolve().parent.parent / "tools"
    spec = importlib.util.spec_from_file_location(
        "torch_evaluate", tools / "torch_evaluate.py")
    teval = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(teval)
    witness = str(MLP_CONFIG.CHECKPOINTS_DIR / MLP_CONFIG.REFERENCE_CKPT_NAME)
    out = {}
    for dev in ("cuda", "cpu"):
        t = Transcriber(device=dev)
        w = Transcriber(mlp_ckpt=witness, use_cnn=False, device=dev)
        out[dev] = teval.evaluate_set(t, tmp_path / dev, 2, 777, witness=w)
    assert out["cuda"]["_correct"] == out["cpu"]["_correct"]
    assert out["cuda"]["_disagree"] == out["cpu"]["_disagree"]


# ---------------------------------------------------------------------------
# the tools' twins
# ---------------------------------------------------------------------------
def _tool(name: str):
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parent.parent / "tools"
        / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dataset_creator_slice_all_card_vs_cpu(tmp_path):
    """tools/torch_dataset_creator.py slice-all on 44100 Hz recordings:
    K4 and K5 launched once per recording, the CPU's onsets and file
    names, samples within 1e-5 (no resample at 44100 Hz)."""
    _card()
    from gat_tpu_torch.utils.wavio import read_wav, write_wav
    creator = _tool("torch_dataset_creator")
    for i, (s, f) in enumerate(((6, 0), (2, 3), (1, 5))):
        d = tmp_path / "raw" / f"String_{s}" / f"Fret_{f}"
        d.mkdir(parents=True)
        write_wav(d / "take.wav", pluck_riff(44100, 3.0 + 0.4 * i,
                                             RIFF_NOTES[:4]), 44100)
    before = (onset.onset_strength.launches, onset.pick_onsets.launches)
    n_card = creator.slice_all_clips(tmp_path / "raw", tmp_path / "card")
    assert (onset.onset_strength.launches - before[0],
            onset.pick_onsets.launches - before[1]) == (3, 3)
    n_cpu = creator.slice_all_clips(tmp_path / "raw", tmp_path / "cpu",
                                    device="cpu")
    assert n_card == n_cpu > 0
    names = sorted(p.relative_to(tmp_path / "card")
                   for p in (tmp_path / "card").rglob("*.wav"))
    assert names and names == sorted(p.relative_to(tmp_path / "cpu")
                                     for p in (tmp_path / "cpu").rglob(
                                         "*.wav"))
    for name in names:
        np.testing.assert_allclose(read_wav(tmp_path / "card" / name)[0],
                                   read_wav(tmp_path / "cpu" / name)[0],
                                   rtol=0, atol=1e-5)


def test_eda_card_vs_cpu(tmp_path):
    """tools/torch_eda.py's three analyses on the card against the CPU:
    dataset counts, report and per-WAV stats equal; slices' names equal,
    rms and peak within 1e-5; the feature matrix element by element (MFCC
    1e-3, pitch 2e-3 relative; K2 and K3 launched once), the feature
    report's statistics within 1e-3, the rest equal."""
    _card()
    from gat_tpu_torch.data.synth import synthesize_note_dataset
    from gat_tpu_torch.utils.reports import feature_report
    from gat_tpu_torch.utils.wavio import write_wav
    eda = _tool("torch_eda")
    root = synthesize_note_dataset(tmp_path / "ds", variants_per_class=2,
                                   seed=1, verbose=False)
    got, ref = (eda.dataset_analysis(root, device=d) for d in ("cuda", "cpu"))
    assert got["counts"] == ref["counts"] and got["report"] == ref["report"]
    assert got["stats"] == ref["stats"]
    wav = tmp_path / "riff.wav"
    write_wav(wav, pluck_riff(44100, 3.0, RIFF_NOTES[:4]), 44100)
    got, ref = (eda.slice_analysis(wav, device=d) for d in ("cuda", "cpu"))
    assert [c["clip"] for c in got] == [c["clip"] for c in ref] and got
    for a, b in zip(got, ref):
        assert abs(a["rms"] - b["rms"]) <= 1e-5
        assert abs(a["peak"] - b["peak"]) <= 1e-5
    before = (features.mfcc_frontend.launches, yin.yin_pitch.launches)
    mats = eda.feature_matrix(root, device="cuda")
    assert (features.mfcc_frontend.launches - before[0],
            yin.yin_pitch.launches - before[1]) == (1, 1)
    mats_ref = eda.feature_matrix(root, device="cpu")
    _same_mfcc(mats[0], mats_ref[0])
    np.testing.assert_array_equal(mats[1], mats_ref[1])
    assert mats[2] == mats_ref[2]
    got, ref = (feature_report(*m) for m in (mats, mats_ref))
    stats = ("X_min", "X_max", "X_mean", "X_std")
    for k in ref:
        if k in stats:
            assert abs(got[k] - ref[k]) <= 1e-3, k
        else:
            assert got[k] == ref[k], k


def _same_mfcc(x, ref):
    """MFCC-and-pitch vectors of the card against the CPU's: the MFCCs
    within 1e-3, the pitch (log10 Hz) within 2e-3 relative."""
    np.testing.assert_allclose(x[:, :64], ref[:, :64], atol=1e-3, rtol=0)
    np.testing.assert_allclose(10.0 ** (x[:, 64] - ref[:, 64]), 1.0,
                               atol=2e-3, rtol=0)


def test_cross_family_features_card_vs_cpu(tmp_path):
    """tools/torch_cross_family_eval.py's raw features of an fm evaluation
    set on the card against the CPU: the MLP's vectors as eda's (K2 and
    K3 launched once), the CNN's mel images within 0.1 dB where the CPU's
    read above -60 dB (K1 launched once); labels and classes equal."""
    _card()
    from gat_tpu_torch.data.synth import synthesize_note_dataset
    cross = _tool("torch_cross_family_eval")
    fm = synthesize_note_dataset(tmp_path / "fm", family="fm",
                                 variants_per_class=2, seed=777,
                                 verbose=False)
    wrappers = (features.melspec_features, features.mfcc_frontend,
                yin.yin_pitch)
    for kind, launched in (("mlp", [0, 1, 1]), ("cnn", [1, 0, 0])):
        before = [w.launches for w in wrappers]
        x, y, rmap = cross.raw_features(kind, fm, 11025, "cuda")
        assert [w.launches - b for w, b in zip(wrappers, before)] == launched
        x_ref, y_ref, rmap_ref = cross.raw_features(kind, fm, 11025, "cpu")
        np.testing.assert_array_equal(y, y_ref)
        assert rmap == rmap_ref and x.shape == x_ref.shape
        if kind == "mlp":
            _same_mfcc(x, x_ref)
        else:
            mask = x_ref > -60.0
            np.testing.assert_allclose(x[mask], x_ref[mask], atol=0.1,
                                       rtol=0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n,loud_tail", [(45000, False), (175616, False),
                                         (60000, True)])
def test_onset_mel_db_shards_stitch_on_card(n, loud_tail):
    """K4's first pass over 4 shards with their halos (origin 0),
    stitched, gives its first pass over the centred file bit for bit, and
    its second pass over the stitched rows `onset_strength`'s envelope;
    one launch of each entry point per call."""
    dev = _card()
    y = riffs(n)[0]
    if loud_tail:
        y = y * 0.05
        y[-400:] = 0.9
    t = spectral.n_frames(n, 2048, 512)
    whole = torch.from_numpy(y)[None].to(dev)
    db, key = onset.onset_mel_db(whole, FILE_SR)
    before = onset.onset_mel_db.launches
    parts = [onset.onset_mel_db(ext.to(dev), FILE_SR, origin=0,
                                frames=frames, n_valid_frames=nvf)
             for ext, frames, nvf in time_shards(y, 4)]
    assert onset.onset_mel_db.launches == before + 4
    got_db, got_key = stitch(parts, t)
    assert torch.equal(got_db, db) and torch.equal(got_key, key)
    before = onset.onset_flux.launches
    env = onset.onset_flux(got_db, got_key)
    torch.cuda.synchronize()
    assert onset.onset_flux.launches == before + 1
    ref = onset.onset_strength(whole, FILE_SR)
    torch.testing.assert_close(env, ref, atol=1e-3, rtol=0)
    torch.testing.assert_close(
        env.cpu(), onset.onset_strength_plain(whole.cpu(), FILE_SR),
        atol=1e-3, rtol=0)


def test_onset_passes_card_vs_plain():
    dev = _card()
    y, nvf = file_batch(23586, 4)
    db, key = onset.onset_mel_db(y.to(dev), FILE_SR, n_valid_frames=nvf)
    ref_db, ref_key = onset.onset_mel_db_plain(y, FILE_SR,
                                               n_valid_frames=nvf)
    loud = ref_db > -60.0
    torch.testing.assert_close(db.cpu()[loud], ref_db[loud], atol=1e-3,
                               rtol=0)
    torch.testing.assert_close(onset.key_value(key.cpu()),
                               onset.key_value(ref_key), atol=1e-3, rtol=0)
    env = onset.onset_flux(ref_db.to(dev), ref_key.to(dev))
    torch.testing.assert_close(env.cpu(), onset.onset_flux_plain(
        ref_db, ref_key), atol=1e-5, rtol=0)


def _nccl_rank(y: np.ndarray, clips: np.ndarray) -> dict:
    import torch.distributed as dist
    from gat_tpu_torch.parallel import make_mesh, sharded_batch_pitch
    from gat_tpu_torch.parallel.mesh import gather_batch
    from gat_tpu_torch.parallel.timeshard import onset_envelope_timesharded
    mesh = make_mesh(1)
    flags = torch.tensor([True, False, True], device="cuda")
    return {"backend": dist.get_backend(), "device": mesh.device_type,
            "env": onset_envelope_timesharded(y, mesh, FILE_SR).cpu(),
            "pitch": sharded_batch_pitch(mesh, SR)(
                torch.from_numpy(clips)).cpu(),
            "flags": gather_batch(flags, 3, mesh).cpu()}


def test_nccl_world_1():
    """A world of one rank on NCCL (`parallel.launch.spawn`): the mesh is
    the card's, and the time-sharded envelope and the sharded YIN equal
    the single-device kernels' results."""
    from gat_tpu_torch.parallel import launch
    dev = _card()
    y = riffs(45000)[0]
    clips = _tones(0.1).cpu().numpy()
    got = launch.spawn(_nccl_rank, 1, y, clips, device="cuda",
                       timeout_s=300)[0]
    assert got["backend"] == "nccl" and got["device"] == "cuda"
    ref = onset.onset_strength(torch.from_numpy(y)[None].to(dev), FILE_SR)
    torch.testing.assert_close(got["env"], ref[0].cpu(), atol=1e-3, rtol=0)
    torch.testing.assert_close(got["pitch"], yin.yin_pitch(
        torch.from_numpy(clips).to(dev), SR).cpu())
    assert got["flags"].tolist() == [True, False, True]


# ---------------------------------------------------------------------------
# K6: the shared MFCC and YIN front-end of the matmul route
# ---------------------------------------------------------------------------
@pytest.fixture
def matmul_route():
    """The matmul route for one test; "auto", float32 and the shared
    front-end on afterwards."""
    _card()
    spectral.set_stft_backend("matmul")
    yield
    spectral.set_stft_backend("auto")
    spectral.set_matmul_dtype(torch.float32)
    features.SHARED_BLOCK_FRONTEND = True


@pytest.mark.parametrize("sr", [11025, 22050])
@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("pitch_normalized", [True, False])
def test_mfcc_pitch_kernel(matmul_route, sr, normalize, pitch_normalized):
    """K6 against the plain shared front-end (the fp32 block DFT) at the
    emulated test's bounds (MFCC atol 1e-3 and rtol 2e-6, pitch rtol
    2e-3), and against K2 and K3 on the card: its MFCC is K2's bit for
    bit, its pitch K3's whenever it reads the raw clips."""
    x = shared_frontend_clips(sr).cuda()
    before = features.mfcc_pitch_features.launches
    got, hz = features.mfcc_pitch_features(x, sr, 64, normalize,
                                           pitch_normalized)
    torch.cuda.synchronize()
    assert features.mfcc_pitch_features.launches == before + 1
    ref, ref_hz = features.mfcc_pitch_features_plain(
        x.cpu(), sr, 64, normalize, pitch_normalized)
    torch.testing.assert_close(got[:, :64].cpu(), ref[:, :64], atol=1e-3,
                               rtol=2e-6)
    torch.testing.assert_close(hz.cpu(), ref_hz, rtol=2e-3, atol=0)
    torch.testing.assert_close(got[:, 64], torch.log10(hz), rtol=0,
                               atol=1e-6)
    assert torch.equal(got[:, :64], features.mfcc_frontend(x, sr, 64,
                                                           normalize))
    if features.shared_pitch_is_raw(normalize, pitch_normalized):
        assert torch.equal(hz, yin.yin_pitch(x, sr))


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("pitch_normalized", [True, False])
def test_mfcc_pitch_kernel_bf16(matmul_route, normalize, pitch_normalized):
    """At bfloat16 operands the wrapper hands K6 the clips rounded to
    bfloat16: the result is K6's of the rounded clips, bit for bit, and
    the fp32 shared front-end's of them to the fp32 bounds."""
    spectral.set_matmul_dtype(torch.bfloat16)
    x = shared_frontend_clips(SR).cuda()
    xr = x.to(torch.bfloat16).float()
    got, hz = features.mfcc_pitch_features(x, SR, 64, normalize,
                                           pitch_normalized)
    same, same_hz = features.mfcc_pitch_features(xr, SR, 64, normalize,
                                                 pitch_normalized,
                                                 bf16=False)
    assert torch.equal(got, same) and torch.equal(hz, same_hz)
    ref, ref_hz = features.mfcc_pitch_features_plain(
        xr.cpu(), SR, 64, normalize, pitch_normalized, bf16=False)
    torch.testing.assert_close(got[:, :64].cpu(), ref[:, :64], atol=1e-3,
                               rtol=2e-6)
    torch.testing.assert_close(hz.cpu(), ref_hz, rtol=2e-3, atol=0)


def test_mfcc_pitch_kernel_plucks(matmul_route):
    """On the 47 clean plucks K6 agrees with a float64 YIN to rtol 2e-3,
    the pinned near-tie apart."""
    x = torch.from_numpy(port_pluck_clips(0.0))
    _, hz = features.mfcc_pitch_features(x.cuda(), SR)
    truth = yin_float64(x, SR)
    keep = torch.ones(47, dtype=torch.bool)
    keep[PLUCK_NEAR_TIE] = False
    torch.testing.assert_close(hz.cpu()[keep], truth[keep], rtol=2e-3,
                               atol=0)


def test_mfcc_pitch_wrapper_edges(matmul_route, clips):
    """Zero rows, the input checks, a clip of 2000 x 512 samples (1997
    frames), which the wrapper refused before the split route, and a clip
    of 60,000 samples (118 frames), which the launch refused while YIN
    staged the whole clip, run in groups of frames: K2's MFCC and K3's
    pitch bit for bit."""
    from emulated_kernels import long_riff
    got, hz = features.mfcc_pitch_features(clips[:0], SR)
    assert got.shape == (0, 65) and hz.shape == (0,)
    with pytest.raises(ValueError, match="float32"):
        features.mfcc_pitch_features(clips.double(), SR)
    with pytest.raises(ValueError, match="contiguous"):
        features.mfcc_pitch_features(clips.t().contiguous().t(), SR)
    long = torch.from_numpy(long_riff(93.0)[:, :2000 * 512]).cuda()
    for x in (long, frame_count_clips(60000).cuda()):
        got, hz = features.mfcc_pitch_features(x, SR)
        assert torch.equal(got[:, :64], features.mfcc_frontend(x, SR))
        assert torch.equal(hz, yin.yin_pitch(x, SR))


def test_mfcc_pitch_frontend_four_blocks_per_sm(matmul_route, clips):
    """At the clip path's 1024 x 5512 (11 frames, 222 lags) K6 fits four
    resident blocks per SM, as K2 and K3 do: one buffer of K2's 56,832
    bytes, 64 registers a thread. The launch at that shape is K2's and
    K3's bit for bit."""
    import ctypes

    from gat_tpu_torch import kernels
    max_p = yin.yin_periods(SR, 50.0, 1000.0, 2048, 1024)[1]
    blocks = ctypes.c_int(0)
    args = (5512, 512, spectral.n_frames(5512, 2048, 512), 128, 1024, max_p)
    kernels.check(kernels.function(
        "mfcc_pitch_frontend", "gat_mfcc_pitch_frontend_blocks_per_sm",
        [ctypes.c_int] * len(args) + [ctypes.c_void_p])(
            *args, ctypes.addressof(blocks)), "mfcc_pitch_frontend")
    assert blocks.value >= 4
    x = clips[torch.arange(1024, device=clips.device) % len(clips)]
    got, hz = features.mfcc_pitch_features(x.contiguous(), SR, 64, True,
                                           False)
    assert torch.equal(got[:, :64], features.mfcc_frontend(x, SR, 64, True))
    assert torch.equal(hz, yin.yin_pitch(x, SR))


def test_transcribe_clips_shared_route_card_vs_cpu(matmul_route, clips):
    """On the shared route `transcribe_clips` launches K6 and K1 once and
    K2 and K3 never, and gives the CPU plain path's labels."""
    from gat_tpu_torch.infer import Transcriber
    t = Transcriber(device="cuda")
    t.transcribe_clips(clips)
    wrappers = (features.melspec_features, features.mfcc_frontend,
                yin.yin_pitch, features.mfcc_pitch_features)
    torch.cuda.synchronize()
    for w in wrappers:
        w.launches = 0
    got = t.transcribe_clips(clips)
    torch.cuda.synchronize()
    assert [w.launches for w in wrappers] == [1, 0, 0, 1]
    ref = Transcriber(device="cpu").transcribe_clips(clips.cpu())
    assert got["labels"] == ref["labels"]
    np.testing.assert_allclose(got["probs"], ref["probs"], atol=1e-2)
    np.testing.assert_allclose([p for p, _ in got["dsp_info"]],
                               [p for p, _ in ref["dsp_info"]], rtol=2e-3)


# ---------------------------------------------------------------------------
# K1, K2, K3 and K6 past what a block held at once before (PR 16's repair)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_frames", [71, 100, 200])
def test_clip_kernels_long_card(matmul_route, n_frames):
    """K3 and K6 at 71, 100 and 200 frames (they refused 71 and 70 or
    more), YIN in groups of frames: K3 against its plain version to rtol
    2e-3, K6 against the plain shared front-end (MFCC atol 1e-3 and rtol
    2e-6, pitch rtol 2e-3), its MFCC K2's and its pitch K3's bit for bit;
    K1 and K2 at the same clips, the mel image at its hop of 256."""
    x = frames_clips(n_frames).cuda()
    hz3 = yin.yin_pitch(x, SR)
    torch.testing.assert_close(hz3, yin.yin_pitch_plain(x, SR), rtol=2e-3,
                               atol=0)
    got, hz = features.mfcc_pitch_features(x, SR, 64, True, False)
    ref, ref_hz = features.mfcc_pitch_features_plain(x.cpu(), SR, 64, True,
                                                     False)
    torch.testing.assert_close(got[:, :64].cpu(), ref[:, :64], atol=1e-3,
                               rtol=2e-6)
    torch.testing.assert_close(hz.cpu(), ref_hz, rtol=2e-3, atol=0)
    k2 = features.mfcc_frontend(x, SR)
    assert torch.equal(got[:, :64], k2) and torch.equal(hz, hz3)
    torch.testing.assert_close(k2, features.mfcc_frontend_plain(x, SR),
                               atol=1e-3, rtol=2e-6)
    rows = x[1:].contiguous()  # the noisy rows, as the emulated K1 test
    check_mel_image(features.melspec_features(rows, SR),
                    features.melspec_features_plain(rows, SR), True)


@pytest.mark.parametrize("n_frames", [354, 355, 400])
def test_mfcc_kernels_past_the_image_limit_card(matmul_route, n_frames):
    """K2 and K6 keep the dB image in shared memory at 354 frames and in
    the wrapper's workspace from 355 (K2 refused 355 or more): K2 against
    its plain version (atol 1e-3, rtol 2e-6), K6 K2's and K3's bit for
    bit."""
    x = frames_clips(n_frames)[[1, 3]].cuda()
    k2 = features.mfcc_frontend(x, SR)
    torch.testing.assert_close(k2, features.mfcc_frontend_plain(x, SR),
                               atol=1e-3, rtol=2e-6)
    got, hz = features.mfcc_pitch_features(x, SR, 64, True, False)
    assert torch.equal(got[:, :64], k2)
    assert torch.equal(hz, yin.yin_pitch(x, SR))


def test_melspec_kernel_past_the_image_limit_card():
    """K1 at 800 frames (it refused 745 or more) writes its image straight
    to the output: to K1's tolerance on the noisy rows (the emulated
    test says why the clean decaying tone is left out)."""
    _card()
    x = frames_clips(800, hop=256)[[1, 2, 3]].cuda()
    check_mel_image(features.melspec_features(x, SR),
                    features.melspec_features_plain(x, SR), True)


# ---------------------------------------------------------------------------
# K1, K2, K3 and K6 at any length: the split route (csrc/dsp_common.cuh)
# ---------------------------------------------------------------------------
LONG_CLIP_SHAPES = ((1, 120.0), (64, 60.0), (1, 900.0))


def long_clip_batch(n: int, seconds: float) -> torch.Tensor:
    """(n, seconds x SR) on the card: `emulated_kernels.long_riff`
    rows from seeds 0..n-1."""
    from emulated_kernels import long_riff
    return torch.from_numpy(np.concatenate(
        [long_riff(seconds, seed=i) for i in range(n)])).cuda()


def one_block_plan(name, symbol, device, *sizes):
    """`kernels.plan` bound to the one-block route, with its workspace."""
    import ctypes

    from gat_tpu_torch import kernels
    if symbol == "gat_mfcc_plan":
        _, _, t, mels = sizes
        return (0, 1, 0, kernels.function(
            name, "gat_mfcc_workspace_floats", [ctypes.c_int] * 2)(mels, t))
    if symbol == "gat_mfcc_pitch_plan":
        _, _, t, mels, n_mfcc, win, hop, max_p = sizes
        return (0, 1, 0, kernels.function(
            name, "gat_mfcc_pitch_workspace_floats", [ctypes.c_int] * 6)(
                t, mels, n_mfcc, win, hop, max_p))
    return (0, 1, 0, 0)


@pytest.mark.parametrize("n, seconds", LONG_CLIP_SHAPES)
def test_clip_kernels_long_clip_card(n, seconds):
    """K1, K2, K3 and K6 at 1 x 120 s, 64 x 60 s and 1 x 15 min (5,168,
    2,584 and 38,760 frames at hop 256; 2,584, 1,292 and 19,380 at 512),
    which the card refused before its split route: each wrapper launches
    its kernel once on the split route (the plan's tiles) and agrees with
    its plain version on the card (K1 0.1 dB above -60 dB, MFCC atol 1e-3
    and rtol 2e-6, pitch rtol 2e-3); K6's MFCC is K2's and its pitch K3's
    bit for bit."""
    from gat_tpu_torch import kernels
    _card()
    x = long_clip_batch(n, seconds)
    t_mel = spectral.n_frames(x.shape[1], 2048, 256)
    t = spectral.n_frames(x.shape[1], 2048, 512)
    assert kernels.plan("melspec_frontend", "gat_melspec_plan", x.device,
                        n, x.shape[1], t_mel, 64, 1)[0] > 0
    wrappers = (features.melspec_features, features.mfcc_frontend,
                yin.yin_pitch, features.mfcc_pitch_features)
    before = [w.launches for w in wrappers]
    mel = features.melspec_features(x, SR)
    k2 = features.mfcc_frontend(x, SR)
    k3 = yin.yin_pitch(x, SR)
    k6, hz = features.mfcc_pitch_features(x, SR, 64, True, False, bf16=False)
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1] * 4
    assert mel.shape == (n, 64, t_mel, 1) and k2.shape == (n, 64)
    check_mel_image(mel, features.melspec_features_plain(x, SR), True)
    torch.testing.assert_close(k2, features.mfcc_frontend_plain(x, SR),
                               atol=1e-3, rtol=2e-6)
    torch.testing.assert_close(k3, yin.yin_pitch_plain(x, SR), rtol=2e-3,
                               atol=0)
    assert torch.equal(k6[:, :64], k2) and torch.equal(hz, k3)
    ref, ref_hz = features.mfcc_pitch_features_plain(x, SR, 64, True, False,
                                                     bf16=False)
    torch.testing.assert_close(k6[:, :64], ref[:, :64], atol=1e-3,
                               rtol=2e-6)
    torch.testing.assert_close(hz, ref_hz, rtol=2e-3, atol=0)
    assert t > 0 and bool(torch.isfinite(k6).all())


@pytest.mark.parametrize("n, seconds", [(256, 4.0), (64, 60.0)])
def test_split_route_matches_one_block_card(monkeypatch, n, seconds):
    """Where both routes run a shape, the split route gives the one-block
    route's floats on the card: K1's image, K2's and K6's MFCC mean (the
    same chunks of frames summed in the same order) and K3's and K6's
    pitch, bit for bit; and two runs of the split route the same bits."""
    from gat_tpu_torch import kernels
    _card()
    x = long_clip_batch(n, seconds)
    t = spectral.n_frames(x.shape[1], 2048, 512)
    assert kernels.plan("mfcc_frontend", "gat_mfcc_plan", x.device, n,
                        x.shape[1], t, 128)[0] > 0

    def run():
        return (features.melspec_features(x, SR),
                features.mfcc_frontend(x, SR), yin.yin_pitch(x, SR),
                *features.mfcc_pitch_features(x, SR, 64, True, False,
                                              bf16=False))
    split, again = run(), run()
    monkeypatch.setattr(kernels, "plan", one_block_plan)
    one = run()
    for a, b, c in zip(split, again, one):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_yin_four_blocks_per_sm_at_the_clip_path():
    """K3 at the clip path's 11 frames runs the whole clip as one group at
    four resident blocks per SM, as before groups."""
    import ctypes

    from gat_tpu_torch import kernels
    _card()
    max_p = yin.yin_periods(SR, 50.0, 1000.0, 2048, 1024)[1]
    args = (1024, 512, spectral.n_frames(5512, 2048, 512), max_p)
    assert kernels.function("yin_pitch", "gat_yin_group",
                            [ctypes.c_int] * 4)(*args) == args[2]
    blocks = ctypes.c_int(0)
    kernels.check(kernels.function(
        "yin_pitch", "gat_yin_blocks_per_sm",
        [ctypes.c_int] * 4 + [ctypes.c_void_p])(
            *args, ctypes.addressof(blocks)), "yin_pitch")
    assert blocks.value >= 4


def test_transcribe_clip_duration_4_card_vs_cpu(tmp_path):
    """`transcribe(clip_duration=4.0)` on a 12 s riff, whose clips of 4 s
    (87 frames at the MFCC's hop) the card refused on both routes: labels,
    onsets and times equal to the CPU plain path's, on the FFT route and
    on the matmul route."""
    _card()
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.utils.wavio import write_wav
    notes = ((0.4, 110.0), (4.6, 196.0), (8.8, 329.63))
    path = tmp_path / "riff.wav"
    write_wav(path, pluck_riff(22050, 12.0, notes), 22050)
    card, cpu = Transcriber(device="cuda"), Transcriber(device="cpu")
    try:
        for backend in ("fft", "matmul"):
            spectral.set_stft_backend(backend)
            got = card.transcribe(path, clip_duration=4.0)
            ref = cpu.transcribe(path, clip_duration=4.0)
            assert got["labels"] == ref["labels"] and got["labels"]
            assert got["onsets_s"] == ref["onsets_s"]
            assert got["times"] == ref["times"]
            np.testing.assert_allclose(got["probs"], ref["probs"], atol=1e-2)
    finally:
        spectral.set_stft_backend("auto")


# K7 (noise gate) and K8 (clip slicer) at the shapes of chip_smoke's
# [gate] phase: the serving wave (4 files x 60 s at 22050 Hz, 112 onsets a
# file, 448 slots of 11,025 samples) and one 400 s riff
def tiled_riffs(files: int, seconds: float, seed: int = 0) -> torch.Tensor:
    """(files, seconds at 22050 Hz) on the card: the 3.9 s plucked riff
    repeated, at a level of its own per file, plus noise of sigma 0.01."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = int(seconds * FILE_SR)
    riff = pluck_riff(FILE_SR, 3.9)
    rng = np.random.default_rng(seed)
    y = np.stack([(0.5 + 0.25 * f) * np.resize(riff, n)
                  + rng.normal(0, 0.01, n) for f in range(files)])
    return torch.from_numpy(y.astype(np.float32)).cuda()


def _counts(values) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("case", ["whole", "edges", "none", "hop256",
                                  "rms_only"])
def test_noise_gate_card_vs_plain(case):
    """K7 against the plain gate at the wave's shape, at `check_gate`'s
    bounds: counts of the whole rows and one off the 512 grid; rows of
    n_valid 0, 1500 and a third of the row; no counts; hop 256; the RMS
    gate alone. One launch a call."""
    y = tiled_riffs(4, 60.0)
    n = y.shape[1]
    nv = {"edges": _counts([0, 1500, n // 3 // 512 * 512 + 77, n]),
          "none": None}.get(case, _counts([n, n, n - 12345, n]))
    hop = 256 if case == "hop256" else 512
    min_db = None if case == "rms_only" else GATE_MIN_DB
    before = gating.noise_gate.launches
    out, got = gating.noise_gate(y, min_db, hop, nv, parts=True)
    ref = gating.gate_parts_plain(y, min_db, hop, nv)
    torch.cuda.synchronize()
    assert gating.noise_gate.launches == before + 1
    check_gate({k: v.cpu() for k, v in got.items()},
               {k: v.cpu() for k, v in ref.items()}, y.cpu(), min_db, hop)
    if case == "edges":
        assert not bool(out[:2, 1500:].any()) and not bool(out[0].any())


@pytest.mark.parametrize("hop", [512, 128])
def test_noise_gate_card_400s(hop):
    """K7 on one 400 s riff against the plain gate: 17,227 frames at hop
    512, whose threshold pass stages them in shared memory, and 68,907 at
    hop 128, past `GATE_STAGED_FRAMES`, in device memory."""
    y = tiled_riffs(1, 400.0, seed=1)
    nv = _counts([y.shape[1]])
    t = 1 + y.shape[1] // hop
    assert (t <= gating.GATE_STAGED_FRAMES) == (hop == 512)
    got = gating.noise_gate(y, GATE_MIN_DB, hop, nv, parts=True)[1]
    ref = gating.gate_parts_plain(y, GATE_MIN_DB, hop, nv)
    torch.cuda.synchronize()
    check_gate({k: v.cpu() for k, v in got.items()},
               {k: v.cpu() for k, v in ref.items()}, y.cpu(),
               GATE_MIN_DB, hop)


@pytest.mark.parametrize("offset", [1, 3])
def test_noise_gate_card_unaligned_rows(offset):
    """Rows of an odd length at a pointer 4 or 12 bytes past 16-byte
    alignment (the rms pass's copies shifted to the rows' phase, the
    apply pass's scalar path) give the bits of the same rows at an
    aligned pointer, and the plain gate's at `check_gate`'s bounds."""
    y = tiled_riffs(3, 20.0, seed=4)[:, :441001].contiguous()
    n = y.shape[1]
    nv = _counts([n, 300001, 2048])
    buf = torch.empty(3 * n + 4, device="cuda")
    moved = buf[offset:offset + 3 * n].view(3, n)
    moved.copy_(y)
    assert moved.data_ptr() % 16 == 4 * offset
    got = gating.noise_gate(moved, GATE_MIN_DB, 512, nv, parts=True)[1]
    aligned = gating.noise_gate(y, GATE_MIN_DB, 512, nv, parts=True)[1]
    ref = gating.gate_parts_plain(y, GATE_MIN_DB, 512, nv)
    torch.cuda.synchronize()
    assert all(torch.equal(got[k], aligned[k]) for k in got)
    check_gate({k: v.cpu() for k, v in got.items()},
               {k: v.cpu() for k, v in ref.items()}, y.cpu(),
               GATE_MIN_DB, 512)


@pytest.mark.parametrize("hop", [512, 1])
def test_noise_gate_card_grid_invariant(hop):
    """K7's result does not depend on its grid: 1 block, 97, and the
    card's default give the same bits, at hop 512 and at hop 1 (hop
    blocks of one sample, the threshold pass in device memory)."""
    y = tiled_riffs(2, 20.0, seed=2)
    if hop == 1:
        y = y[:, :60000].contiguous()
    nv = _counts([y.shape[1], min(300001, y.shape[1] - 7)])
    g = gating
    first = g.noise_gate(y, GATE_MIN_DB, hop, nv, parts=True)[1]
    for grid in (1, 97):
        again = g.noise_gate(y, GATE_MIN_DB, hop, nv, grid=grid,
                             parts=True)[1]
        assert all(torch.equal(again[k], first[k]) for k in first)


def test_gate_wrappers_one_signal_card():
    """`gate_waveform` and `rms_gate` of one signal (n,) on the card equal
    their batch of one, and K7's plain twin at the bounds."""
    y = tiled_riffs(1, 8.0, seed=3)[0]
    g = gating
    a = g.gate_waveform(y, GATE_MIN_DB, n_valid_samples=100000)
    b = g.gate_waveform(y[None], GATE_MIN_DB,
                        n_valid=_counts([100000]))[0]
    assert torch.equal(a, b)
    assert torch.equal(g.rms_gate(y), g.rms_gate(y[None])[0])


@pytest.mark.parametrize("onset_hop", [512, None])
@pytest.mark.parametrize("strict", [True, False])
def test_slice_clips_card_vs_plain(onset_hop, strict):
    """K8 against the plain slicer at the wave's shape, on the onsets
    K4/K5 find in K7's output (112 slots a file), at `check_slice`'s
    bounds; one launch a call."""
    g, sl = gating, slicing
    y = tiled_riffs(4, 60.0)
    n = y.shape[1]
    nv = _counts([n, n, n - 12345, n])
    gated = g.gate_waveform(y, GATE_MIN_DB, n_valid=nv)
    ons, valid, *_ = onset.detect_onsets(gated, sr=FILE_SR, min_sep=0.25,
                                         max_onsets=112, n_valid=nv)
    before = sl.slice_at_onsets.launches
    got = sl.slice_at_onsets(y, ons, valid, FILE_SR,
                             strict_reference_compat=strict, n_valid=nv,
                             onset_hop=onset_hop)
    ref = sl.slice_at_onsets_plain(y, ons, valid, FILE_SR,
                                   strict_reference_compat=strict,
                                   n_valid=nv, onset_hop=onset_hop)
    torch.cuda.synchronize()
    assert sl.slice_at_onsets.launches == before + 1
    assert got[0].shape == (4, 112, 11025) and int(valid.sum()) > 200
    check_slice(tuple(x.cpu() for x in got), tuple(x.cpu() for x in ref),
                -37.0)


def test_slice_clips_card_400s_and_edges():
    """K8 on the 400 s riff's onsets, and on the edge cases of the
    emulated test: a skip past the row, negative and past-the-end onsets,
    unaligned onsets with the row gather, a row with no valid slot."""
    g, sl = gating, slicing
    y = tiled_riffs(1, 400.0, seed=1)
    nv = _counts([y.shape[1]])
    ons, valid, *_ = onset.detect_onsets(
        g.gate_waveform(y, GATE_MIN_DB, n_valid=nv), sr=FILE_SR,
        min_sep=0.25, max_onsets=112, n_valid=nv)
    check_slice(tuple(x.cpu() for x in sl.slice_at_onsets(
        y, ons, valid, FILE_SR, n_valid=nv, onset_hop=512)),
        tuple(x.cpu() for x in sl.slice_at_onsets_plain(
            y, ons, valid, FILE_SR, n_valid=nv, onset_hop=512)), -37.0)
    y = tiled_riffs(2, 1.0)[:, :3000].contiguous()
    onsets = torch.tensor([[-700, 3, 1500, 2999], [100, 200, 5000, 900]],
                          dtype=torch.int32, device="cuda")
    valid = torch.tensor([[True] * 4, [False] * 4], device="cuda")
    for skip_sec, length_sec, hop in ((0.2, 0.5, 512), (0.0, 0.2, None),
                                      (0.001, 0.2, 512), (0.0, 0.01, 7)):
        for strict in (True, False):
            kw = dict(length_sec=length_sec, attack_skip_sec=skip_sec,
                      min_slice_rms_db=-40.0,
                      strict_reference_compat=strict, onset_hop=hop)
            check_slice(
                tuple(x.cpu() for x in sl.slice_at_onsets(
                    y, onsets, valid, FILE_SR, **kw)),
                tuple(x.cpu() for x in sl.slice_at_onsets_plain(
                    y, onsets, valid, FILE_SR, **kw)), -40.0)


@pytest.mark.parametrize("length_sec, onset_hop, strict", list(SLICE_PINS))
def test_slice_clips_card_pins(length_sec, onset_hop, strict):
    """K8 on the card on the emulated pins' inputs (`pin_inputs`): 0.5 s
    clips (odd: every destination phase) and 4.0 s clips (the ring goes
    round 7 times) at every source phase, windows cut by the next onset,
    by n_valid and by the tensor's end, the general route's rows, both
    gathers and both last-note rules: clips and times bit-equal to the
    pins and kept to the plain slicer at `check_slice`'s bounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    y, onsets, valid, nv = pin_inputs(length_sec, onset_hop)
    before = slicing.slice_at_onsets.launches
    got = slicing.slice_at_onsets(
        y.cuda(), onsets.cuda(), valid.cuda(), FILE_SR, length_sec, 0.01,
        -40.0, strict, onset_hop=onset_hop, n_valid=nv.cuda())
    torch.cuda.synchronize()
    assert slicing.slice_at_onsets.launches == before + 1
    got = tuple(x.cpu() for x in got)
    check_slice(got, slicing.slice_at_onsets_plain(
        y, onsets, valid, FILE_SR, length_sec, 0.01, -40.0, strict,
        onset_hop=onset_hop, n_valid=nv), -40.0)
    pins = SLICE_PINS[(length_sec, onset_hop, strict)]
    assert (_digest(got[0]), _digest(got[2])) == (pins[0], pins[2])


@pytest.mark.parametrize("onset_hop, strict", list(SLICE_PINS_PAST_ROW))
def test_slice_clips_card_past_the_row(onset_hop, strict):
    """K8 on the card with valid counts past the row's end
    (`past_row_inputs`: windows that cross it, in the last row past the
    tensor's end): the plain slicer's bits at `check_slice`'s bounds, and
    the pins' clips and times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    y, onsets, valid, nv = past_row_inputs(onset_hop)
    got = slicing.slice_at_onsets(
        y.cuda(), onsets.cuda(), valid.cuda(), FILE_SR, 0.1, 0.01, -40.0,
        strict, onset_hop=onset_hop, n_valid=nv.cuda())
    got = tuple(x.cpu() for x in got)
    check_slice(got, slicing.slice_at_onsets_plain(
        y, onsets, valid, FILE_SR, 0.1, 0.01, -40.0, strict,
        onset_hop=onset_hop, n_valid=nv), -40.0)
    pins = SLICE_PINS_PAST_ROW[(onset_hop, strict)]
    assert (_digest(got[0]), _digest(got[2])) == (pins[0], pins[2])


@pytest.mark.parametrize("onset_hop", [512, None])
def test_slice_clips_card_4s_clips(onset_hop):
    """K8 at `transcribe(clip_duration=4.0)`'s clips of 88,200 samples on
    every 8th onset K4/K5 find in the wave (windows of 4.4 s; without a
    hop slot j's onset moved by j samples, every source phase), both
    last-note rules, against the plain slicer at `check_slice`'s
    bounds."""
    y = tiled_riffs(4, 60.0)
    n = y.shape[1]
    nv = _counts([n, n, n - 12345, n])
    ons, valid, *_ = onset.detect_onsets(
        gating.gate_waveform(y, GATE_MIN_DB, n_valid=nv), sr=FILE_SR,
        min_sep=0.25, max_onsets=112, n_valid=nv)
    ons, valid = ons[:, ::8].contiguous(), valid[:, ::8].contiguous()
    if onset_hop is None:
        ons = ons + torch.arange(ons.shape[1], dtype=ons.dtype,
                                 device="cuda")
    for strict in (True, False):
        kw = dict(strict_reference_compat=strict, n_valid=nv,
                  onset_hop=onset_hop)
        got = slicing.slice_at_onsets(y, ons, valid, FILE_SR, 4.0, **kw)
        ref = slicing.slice_at_onsets_plain(y, ons, valid, FILE_SR, 4.0,
                                            **kw)
        torch.cuda.synchronize()
        assert got[0].shape == (4, 14, 88200) and int(ref[1].sum()) > 20
        check_slice(tuple(x.cpu() for x in got),
                    tuple(x.cpu() for x in ref), -37.0)


@pytest.mark.parametrize("offset", [1, 3])
def test_slice_clips_card_unaligned_rows(offset):
    """Rows at a pointer 4 or 12 bytes past 16-byte alignment, windows from
    the tensor's first sample to its last: the bits of the same rows at an
    aligned pointer, and the plain slicer's at `check_slice`'s bounds."""
    y = tiled_riffs(2, 1.0, seed=offset)[:, :3001].contiguous()
    n = y.shape[1]
    onsets = torch.tensor([[0, 1, 1500, 2000], [0, 700, 2990, 2999]],
                          dtype=torch.int32, device="cuda")
    valid = torch.ones(2, 4, dtype=torch.bool, device="cuda")
    buf = torch.empty(2 * n + 4, device="cuda")
    moved = buf[offset:offset + 2 * n].view(2, n)
    moved.copy_(y)
    assert moved.data_ptr() % 16 == 4 * offset
    for hop, strict in ((None, False), (1, True)):
        kw = dict(length_sec=0.1, attack_skip_sec=0.0,
                  min_slice_rms_db=-40.0, strict_reference_compat=strict,
                  onset_hop=hop)
        got = slicing.slice_at_onsets(moved, onsets, valid, FILE_SR, **kw)
        aligned = slicing.slice_at_onsets(y, onsets, valid, FILE_SR, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, aligned))
        check_slice(tuple(x.cpu() for x in got), tuple(
            x.cpu() for x in slicing.slice_at_onsets_plain(
                y, onsets, valid, FILE_SR, **kw)), -40.0)


# ---------------------------------------------------------------------------
# K9 (polyphase resampler)
# ---------------------------------------------------------------------------
def card_rows(rows: int, seconds: float, sr: int, seed: int = 0
              ) -> torch.Tensor:
    """(rows, seconds at sr) of the plucked riff at 22050 Hz's notes
    resized to that length, plus noise of sigma 0.05, on the card."""
    dev = _card()
    n = int(seconds * sr)
    rng = np.random.default_rng(seed)
    riff = pluck_riff(sr, 3.9)
    y = np.resize(riff, (rows, n)) + rng.normal(0, 0.05, (rows, n))
    return torch.from_numpy(y.astype(np.float32)).to(dev)


# chip_smoke's [resample] shapes: the serving wave's 384 clips of 0.5 s at
# 22050 Hz, one 60 s and one 400 s file at 48 kHz (m = 8.82 M outputs:
# j·down passes 2^31), one 60 s file at 16 kHz and one at 44.1 kHz, and
# one note of 0.5 s at 22050 Hz (`transcribe_note`'s re-rate)
RESAMPLE_SHAPES = [(384, 0.5, 22050, 11025), (1, 60.0, 48000, 22050),
                   (1, 400.0, 48000, 22050), (1, 60.0, 16000, 22050),
                   (1, 60.0, 44100, 22050), (1, 0.5, 22050, 11025)]


@pytest.mark.parametrize("rows, seconds, orig, target", RESAMPLE_SHAPES)
def test_resample_kernel_card_vs_plain(rows, seconds, orig, target):
    """K9 against `resample_plain` on the card at atol 1e-5, one launch a
    call; at 400 s the last outputs' j·down is past 2^31."""
    y = card_rows(rows, seconds, orig)
    before = resample.resample.launches
    got = resample.resample(y, orig, target)
    ref = resample.resample_plain(y, orig, target)
    torch.cuda.synchronize()
    assert resample.resample.launches == before + 1
    assert got.shape == ref.shape == (rows, -(-y.shape[1] * target // orig))
    if seconds == 400.0:
        assert (got.shape[1] - 1) * 320 > 2 ** 31
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("orig,target", list(RESAMPLE_PINS))
def test_resample_card_pins(orig, target):
    """K9 on the card gives the emulated pins' bits at every rate pair,
    the read-only-cache route included: the card's fmaf is the
    emulation's, each output's taps in the same order."""
    _card()

    def run(x, rows, out_len):
        x = x.cuda()
        got = (resample.resample(x, orig, target) if rows is None
               and out_len is None else
               resample.resample_rows(x, rows, orig, target, out_len))
        return got.cpu()
    assert resample_pin_digest(run, orig, target) == RESAMPLE_PINS[
        (orig, target)]


@pytest.mark.parametrize("orig,target", RESAMPLE_RATES)
@pytest.mark.parametrize("length", [1, 7, 1001, 4099])
def test_resample_kernel_card_lengths(orig, target, length):
    """The emulated test's rate pairs and lengths on the card: stereo
    (2, n) and one (2, 1, n), against the plain version at 1e-5."""
    dev = _card()
    x = torch.from_numpy(np.random.default_rng(length).normal(
        0, 0.3, (2, length)).astype(np.float32)).to(dev)
    for y in (x, x[:, None]):
        got = resample.resample(y, orig, target)
        ref = resample.resample_plain(y, orig, target)
        assert got.shape == ref.shape
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


def test_resample_rows_card_vs_plain():
    """`resample_rows` on the card against `resample_rows_plain`: the
    wave's budget (384 of 448 slots, permuted, cut to 5,512), one row
    padded past m, every row, rows from the host, and the empty
    selection's one dummy row; a row index outside x gives NaN."""
    x = card_rows(448, 0.5, 22050, seed=4)
    sel = torch.randperm(448, generator=torch.Generator().manual_seed(0)
                         )[:384].cuda()
    for rows, out_len in ((sel, 5512), (sel[:1], 6000), (None, 5512),
                          (np.array([7, 3]), 100), (sel.new_zeros(1), 5512)):
        before = resample.resample.launches
        got = resample.resample_rows(x, rows, 22050, 11025, out_len)
        ref = resample.resample_rows_plain(x, rows, 22050, 11025, out_len)
        torch.cuda.synchronize()
        assert resample.resample.launches == before + 1
        assert got.shape == ref.shape
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    bad = resample.resample_rows(x, [0, 448], 48000, 22050, 50).cpu()
    assert not bool(bad[0].isnan().any()) and bool(bad[1].isnan().all())


def test_resample_card_never_reaches_conv_or_matmul(monkeypatch):
    """A CUDA-tensor call of `resample` or `resample_rows` launches K9 for
    every rate pair and calls neither `F.conv1d` nor `torch.matmul`;
    n = 0 launches nothing."""
    dev = _card()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 0.3, (2, 3000)).astype(np.float32)).to(dev)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain route on the card")
    monkeypatch.setattr(torch.nn.functional, "conv1d", refuse)
    monkeypatch.setattr(torch, "matmul", refuse)
    for orig, target in RESAMPLE_RATES:
        before = resample.resample.launches
        resample.resample(x, orig, target)
        resample.resample_rows(x, [1], orig, target, 777)
        assert resample.resample.launches == before + 2
    before = resample.resample.launches
    assert resample.resample(x[:, :0], 48000, 22050).shape == (2, 0)
    assert resample.resample_rows(x[:, :0], None, 48000, 22050, 5).shape \
        == (2, 5)
    assert resample.resample.launches == before


def test_resample_attribute_only_grows_card():
    """96 kHz's 147 x 209 table (123 KB), then 48 kHz (62 KB), then 96 kHz
    again, then 44100 Hz (97 taps) in one process: every launch fits, and
    the occupancy queries report resident blocks."""
    y = card_rows(2, 3.0, 96000)
    for orig in (96000, 48000, 96000, 44100):
        x = y[:, :int(3.0 * orig)].contiguous()
        torch.testing.assert_close(resample.resample(x, orig, 22050),
                                   resample.resample_plain(x, orig, 22050),
                                   atol=1e-5, rtol=0)
        assert resample.resample_blocks_per_sm(orig, 22050) >= 1
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", WAVE_SHAPES + ((64, 112),))
@pytest.mark.parametrize("density", [0.0, 0.3, 0.97, 1.0])
def test_wave_select_card_vs_plain(shape, density):
    """K10's selection on the card equal to `wave_select_plain`'s on the
    same bits, field by field (sel in the reference's order), at budget
    1, around the kept count, the serving wave's 3/4 and every slot; one
    launch a call and no read of the count on one device."""
    dev = _card()
    n_files, k = shape
    kept = wave_kept(n_files, k, density, seed=n_files * k).to(dev)
    ovf, fix = (f.to(dev) for f in wave_flags(n_files, n_files * k))
    n_kept = int(kept.sum())
    for budget in sorted({1, max(1, n_kept - 1), max(1, n_kept), n_kept + 1,
                          max(1, 3 * n_files * k // 4), n_files * k}):
        before = compaction.wave_select.launches
        got = compaction.wave_select(kept, budget, overflow=ovf,
                                     fixable=fix)
        ref = compaction.wave_select_plain(kept, budget, overflow=ovf,
                                           fixable=fix)
        torch.cuda.synchronize()
        assert compaction.wave_select.launches == before + 1
        check_selection(got, ref)


@pytest.mark.parametrize("shape, world", [((4, 112), 2), ((4, 112), 4),
                                          ((64, 112), 4), ((8, 112), 8)])
def test_wave_select_card_mesh(shape, world):
    """Every rank's (first, n_local) of the whole wave's bits: its slots of
    the wave's selection in the same order, as the plain code's filter."""
    dev = _card()
    n_files, k = shape
    kept = wave_kept(n_files, k, 0.7, seed=world).to(dev)
    b = n_files // world
    for budget in (1, 3 * n_files * k // 4, n_files * k - 1):
        for rank in range(world):
            got = compaction.wave_select(kept, budget, rank * b, b)
            check_selection(got, compaction.wave_select_plain(
                kept, budget, rank * b, b))


@pytest.mark.parametrize("c, cnn", [(47, True), (47, False), (1, True)])
def test_wave_scatter_card_vs_plain(c, cnn):
    """K10's scatter on the card bit-equal to the plain scatter at the
    serving wave and the 64-file wave, a dummy row past n_sel unread; a
    CNN-less build's None stays None; one launch a call."""
    dev = _card()
    for shape, budget in (((4, 112), 384), ((64, 112), 5376)):
        kept = wave_kept(*shape, 0.5, seed=c).to(dev)
        s = compaction.wave_select(kept, budget)
        parts = tuple(None if x is None else x.to(dev) for x in
                      scatter_parts(s.n_sel + 1, c, seed=budget, cnn=cnn))
        before = compaction.wave_scatter.launches
        got = compaction.wave_scatter(s.pos, parts)
        ref = compaction.wave_scatter_plain(s.pos, parts)
        torch.cuda.synchronize()
        assert compaction.wave_scatter.launches == before + 1
        for g, r in zip(got, ref):
            assert (g is None and r is None) or torch.equal(g, r)


@pytest.mark.parametrize("shape", WAVE_SHAPES_PAST + ((83, 100),))
@pytest.mark.parametrize("world", [1, 2])
def test_wave_compact_card_past_a_tile(shape, world):
    """K10 on the card at 7,168 slots (one tile) and past the selection's
    tile of 8,192 positions (64 x 129, 83 x 100, and 8,200 files: tiles of
    part of the files), on one device and every rank of a world of 2:
    the selection equal to the plain one field by field and the scatter
    bit-equal, at budget 1, 3/4 of the slots and all but one; a second
    run of both kernels gives the same bits."""
    dev = _card()
    n_files, k = shape
    kept = wave_kept(n_files, k, 0.6, seed=n_files + k).to(dev)
    b = n_files // world
    for budget in (1, 3 * n_files * k // 4, n_files * k - 1):
        for rank in range(world):
            got = compaction.wave_select(kept, budget, rank * b, b)
            again = compaction.wave_select(kept, budget, rank * b, b)
            check_selection(got, compaction.wave_select_plain(
                kept, budget, rank * b, b))
            check_selection(again, got)
            parts = tuple(x.to(dev) for x in scatter_parts(
                max(got.n_sel, 1), 47, seed=budget))
            out = compaction.wave_scatter(got.pos, parts)
            out2 = compaction.wave_scatter(got.pos, parts)
            for g, g2, r in zip(out, out2, compaction.wave_scatter_plain(
                    got.pos, parts)):
                assert torch.equal(g, r) and torch.equal(g, g2)
    torch.cuda.synchronize()


def test_files_body_compacts_on_card():
    """The file body with a clip budget on the card: K10 launched once
    each, no sort kernel, outputs equal to the CPU body's (kept, flags,
    labels; probs within 1e-2)."""
    from torch.profiler import ProfilerActivity, profile

    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.infer.pipeline import build_files_fn
    dev = _card()
    ys = np.stack([pluck_riff(FILE_SR, 3.0), pluck_riff(FILE_SR, 3.0)[::-1],
                   pluck_riff(FILE_SR, 3.0), np.zeros(3 * FILE_SR)]
                  ).astype(np.float32)
    nv = np.array([3 * FILE_SR] * 3 + [0], dtype=np.int32)
    outs = []
    for device in ("cpu", "cuda"):
        t = Transcriber(device=device)
        fn = build_files_fn(t.predictor, t.scaler, t.ckpt_sr, t.mfcc_params,
                            t.melspec_params, FILE_SR, 0.5, 8,
                            wave_clip_budget=6)
        args = (torch.from_numpy(ys).to(device), torch.from_numpy(nv).to(
            device))
        if device == "cuda":
            fn(*args)
            before = (compaction.wave_select.launches,
                      compaction.wave_scatter.launches)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = fn(*args)
                torch.cuda.synchronize()
            assert (compaction.wave_select.launches,
                    compaction.wave_scatter.launches) == (before[0] + 1,
                                                          before[1] + 1)
            assert not [e.key for e in prof.key_averages()
                        if "sort" in e.key.lower()]
        else:
            out = fn(*args)
        outs.append([None if x is None else x.cpu().numpy() for x in out])
    cpu, card = outs
    for i in range(4, 10):
        np.testing.assert_array_equal(card[i], cpu[i])
    assert cpu[4].sum() <= 6 and dev.type == "cuda"
    kept = cpu[4]
    np.testing.assert_array_equal(card[0].argmax(-1)[kept],
                                  cpu[0].argmax(-1)[kept])
    for i in range(3):
        np.testing.assert_allclose(card[i], cpu[i], atol=1e-2)


# ---------------------------------------------------------------------------
# K11-K13, the training step's kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b", [32, 65536])
@pytest.mark.parametrize("grad", [True, False])
def test_softmax_xent_kernel(b, grad):
    """K11 against its plain version on the card, at a step's 32 rows and
    an eval chunk's 65,536, with and without the gradient: loss within
    1e-5 relative (sums in another order, over up to 65,536 rows), count
    and argmaxes exact, the gradient within 1e-6 of its largest value; one
    launch."""
    from gat_tpu_torch.ops import loss as loss_mod
    from emulated_kernels import xent_inputs
    dev = _card()
    logits, labels = (t.to(dev) for t in xent_inputs(b, 47, seed=b))
    scale = 1.0 / b
    x = logits.clone().requires_grad_(grad)
    ref = logits.clone().requires_grad_(grad)
    before = loss_mod.softmax_xent.launches
    got = loss_mod.softmax_xent(x, labels, 0.05, scale, preds=not grad)
    want = loss_mod.softmax_xent_plain(ref, labels, 0.05, scale,
                                       preds=not grad)
    if grad:
        got[0].backward()
        want[0].backward()
    torch.cuda.synchronize()
    assert loss_mod.softmax_xent.launches == before + 1
    torch.testing.assert_close(got[0].detach(), want[0].detach(), rtol=1e-5,
                               atol=0)
    assert int(got[1]) == int(want[1])
    if grad:
        torch.testing.assert_close(x.grad, ref.grad, rtol=0,
                                   atol=1e-6 * float(ref.grad.abs().max()))
    else:
        assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("b, offset", [(32, 0), (65536, 0), (64, 0),
                                       (65, 0), (300, 1), (20000, 1)])
@pytest.mark.parametrize("grad", [True, False])
def test_softmax_xent_kernel_forms(b, offset, grad):
    """K11's two forms on the card against the plain version: the step's
    32 rows and 64 (one block of two tiles, no ticket), 65 and an eval
    chunk's 65,536 (a grid sized to the card), and logits one row into
    their buffer (off
    16 bytes: the element route) at 300 and 20,000 rows (several tiles a
    block): loss within 1e-5 relative, the gradient within 1e-6 of its
    largest value, count and argmaxes exact; a second run gives the same
    bits and the ticket is back at 0."""
    from gat_tpu_torch import kernels
    from gat_tpu_torch.ops import loss as loss_mod
    from emulated_kernels import xent_inputs
    dev = torch.device("cuda", _card().index or 0)
    x, y = xent_inputs(b + offset, 47, seed=b)
    logits, labels = x.to(dev)[offset:], y.to(dev)[offset:]
    assert (logits.data_ptr() % 16 == 0) == (offset == 0)
    grid = loss_mod.xent_grid(b, 47, dev)
    assert (grid[0] == 1) == (b <= 64)
    assert grid[0] <= torch.cuda.get_device_properties(
        dev).multi_processor_count * grid[1]
    scale = 1.0 / b
    runs = []
    for _ in range(2):
        xg = logits.clone().requires_grad_(grad) if grad else logits
        got = loss_mod.softmax_xent(xg, labels, 0.05, scale, preds=not grad)
        if grad:
            got[0].backward()
            runs.append((got[0].detach(), got[1], xg.grad))
        else:
            runs.append(got)
    ref = logits.clone().requires_grad_(grad)
    want = loss_mod.softmax_xent_plain(ref, labels, 0.05, scale,
                                       preds=not grad)
    if grad:
        want[0].backward()
    torch.cuda.synchronize()
    for a, c in zip(*runs):
        assert torch.equal(a, c)
    torch.testing.assert_close(runs[0][0], want[0].detach(), rtol=1e-5,
                               atol=0)
    assert int(runs[0][1]) == int(want[1])
    if grad:
        torch.testing.assert_close(runs[0][2], ref.grad, rtol=0,
                                   atol=1e-6 * float(ref.grad.abs().max()))
    else:
        assert torch.equal(runs[0][2], want[2])
    assert int(kernels.ticket(logits.device)) == 0


@pytest.mark.parametrize("max_norm, g_scale", [(1.0, 0.01), (1.0, 10.0),
                                               (None, 10.0)])
def test_clip_adamw_kernel(max_norm, g_scale):
    """K12 (`ClipAdamW` on the card, two launches a step) against its plain
    version (the same optimizer on the CPU) for three steps at the shipped
    CNN's 629,743 parameters, the learning rate changed after the first:
    the norm within 1e-5 relative (a sum of 629,743 squares in another
    order), parameters and moments within 1e-5 relative and 1e-6 of their
    largest value (the norm's last bits through the clip, powf), the count
    exact."""
    from gat_tpu_torch.train import optim
    from emulated_kernels import adamw_inputs
    dev = _card()
    n = 629743
    st = adamw_inputs(n, seed=1, g_scale=g_scale)
    pair = []
    for device in (dev, torch.device("cpu")):
        p = torch.nn.Parameter(st["p"].clone().to(device))
        pair.append((p, optim.ClipAdamW([p], lr=1e-3, max_norm=max_norm)))
    before = (optim.clip_norm.launches, optim.adamw_update.launches)
    for step in range(3):
        g = adamw_inputs(n, seed=2 + step, g_scale=g_scale)["g"]
        norms = []
        for p, opt in pair:
            if step == 1:
                opt.set_lr(5e-4)
            opt.zero_grad()
            p.grad.add_(g.to(p.device))
            norms.append(float(opt.step()))
        torch.testing.assert_close(norms[0], norms[1], rtol=1e-5, atol=0)
    torch.cuda.synchronize()
    assert (optim.clip_norm.launches, optim.adamw_update.launches) == (
        before[0] + 3, before[1] + 3)
    (p0, o0), (p1, o1) = pair
    assert int(o0.count) == int(o1.count) == 3
    for a, b in ((p0, p1), (o0.mu, o1.mu), (o0.nu, o1.nu),
                 (o0.flat_grad, o1.flat_grad)):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-5,
                                   atol=1e-6 * float(b.detach().abs().max()))


@pytest.mark.parametrize("shape", [(32, 32, 64, 22), (32, 64, 32, 11),
                                   (32, 128, 16, 5), (3, 4, 5, 6)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [True, False])
def test_batchnorm_kernels(shape, dtype, channels_last):
    """K13 (two launches forward, two backward) against its plain version
    and its autograd on the card, at the shipped CNN's three layers at a
    step of 32 clips and a small shape, both layouts: the tolerances of
    the emulated test (`test_batchnorm_kernels_emulated`), the per-channel
    sums over up to 45,056 positions within 1e-4 of their scale."""
    from gat_tpu_torch.ops import batchnorm
    from emulated_kernels import bn_inputs
    dev = _card()
    d = {k: v.to(dev) for k, v in bn_inputs(shape, seed=sum(shape),
                                            dtype=dtype,
                                            channels_last=channels_last
                                            ).items()}
    outs = []
    counts = [0, 0, 0, 0]
    for fn in (batchnorm.batch_norm_train, batchnorm.batch_norm_train_plain):
        x = d["x"].clone().requires_grad_(True)
        w = d["w"].clone().requires_grad_(True)
        b = d["b"].clone().requires_grad_(True)
        rm, rv = d["rm"].clone(), d["rv"].clone()
        wrappers = (batchnorm.bn_moments, batchnorm.bn_apply,
                    batchnorm.bn_apply_grad, batchnorm.bn_moments_grad)
        before = [f.launches for f in wrappers]
        y = fn(x, w, b, rm, rv, 1e-5, 0.9)
        y.backward(d["dy"])
        torch.cuda.synchronize()
        counts = [f.launches - k for f, k in zip(wrappers, before)]
        outs.append((y.detach(), rm, rv, x.grad, w.grad, b.grad, counts))
    (y, rm, rv, dx, dw, db, counts), ref = outs
    assert counts == [1, 1, 1, 1] and ref[-1] == [0, 0, 0, 0]
    assert y.stride() == d["x"].stride() and dx.stride() == d["x"].stride()
    for name, g, r in zip(("y", "rm", "rv", "dx", "dw", "db"),
                          (y, rm, rv, dx, dw, db), ref[:6]):
        g, r = g.float().cpu(), r.float().cpu()
        scale = float(r.abs().max())
        if dtype == torch.bfloat16 and name in ("y", "dx"):
            bound = 2.0 * 2.0 ** (torch.floor(torch.log2(
                r.abs().clamp_min(1e-30))) - 7)
            assert bool(((g - r).abs() <= bound + 1e-5 * scale).all()), name
        else:
            tol = 1e-6 if name in ("rm", "rv") else 1e-4
            torch.testing.assert_close(g, r, rtol=0, atol=tol * scale,
                                       msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.parametrize("case", ["nchw", "expanded_dy", "expanded_dy_nchw",
                                  "unaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_kernels_other_layouts(case, dtype):
    """K13 on the card off the rows map's 16-byte route, at the emulated
    test's cases (`bn_layout_case`: NCHW, dy expanded along N beside
    channels-last and NCHW x, tensors one element past a 16-byte
    boundary): two runs give the same bits, and both are within
    `test_batchnorm_kernels`' tolerances of the plain version."""
    from gat_tpu_torch.ops import batchnorm
    from emulated_kernels import bn_layout_case
    dev = _card()
    d = bn_layout_case(case, dtype)
    if case == "unaligned":
        for k in ("x", "dy"):
            t = d[k]
            base = torch.empty(t.numel() + 1, dtype=dtype, device=dev)
            d[k] = base[1:].as_strided(t.shape, t.stride())
            d[k].copy_(t)
    if case.startswith("expanded_dy"):  # the one image, then expanded
        d["dy"] = d["dy"][:1].to(dev).expand(d["x"].shape)
        assert d["dy"].stride()[0] == 0
    d = {k: v if v.device == dev else v.to(dev) for k, v in d.items()}
    runs = []
    for fn in (batchnorm.batch_norm_train, batchnorm.batch_norm_train,
               batchnorm.batch_norm_train_plain):
        x = d["x"].detach().requires_grad_(True)
        w = d["w"].clone().requires_grad_(True)
        b = d["b"].clone().requires_grad_(True)
        rm, rv = d["rm"].clone(), d["rv"].clone()
        y = fn(x, w, b, rm, rv, 1e-5, 0.9)
        y.backward(d["dy"])
        torch.cuda.synchronize()
        runs.append((y.detach(), rm, rv, x.grad, w.grad, b.grad))
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)
    for name, g, r in zip(("y", "rm", "rv", "dx", "dw", "db"), runs[0],
                          runs[2]):
        g, r = g.float().cpu(), r.float().cpu()
        scale = float(r.abs().max())
        if dtype == torch.bfloat16 and name in ("y", "dx"):
            bound = 2.0 * 2.0 ** (torch.floor(torch.log2(
                r.abs().clamp_min(1e-30))) - 7)
            assert bool(((g - r).abs() <= bound + 1e-5 * scale).all()), name
        else:
            tol = 1e-6 if name in ("rm", "rv") else 1e-4
            torch.testing.assert_close(g, r, rtol=0, atol=tol * scale,
                                       msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.parametrize("n, offset", [(20143, 0), (20143, 1), (629743, 0),
                                       (1001, 1), (5002, 0)])
def test_clip_adamw_kernel_tails(n, offset):
    """K12's wrappers on the card at n mod 4 = 3, 1 and 2, over buffers on
    16 bytes and one float off (the kernels' element route), clipped: two
    runs give the same bits; against `adamw_update_plain` on the CPU given
    the card's norm, the clipped g and both moments bit-equal (no powf in
    them), p within 1e-5 relative and 1e-6 of its largest value; the norm
    within 1e-5 relative of the plain one."""
    from gat_tpu_torch.train import optim
    from emulated_kernels import adamw_inputs
    dev = _card()
    st = adamw_inputs(n, seed=n, g_scale=10.0)

    def on_card():
        out = {}
        for k, v in st.items():
            base = torch.zeros(n + offset, device=dev)
            out[k] = base[offset:]
            out[k].copy_(v)
        return out
    lr = torch.tensor(1e-3, device=dev)
    bufs, counts, norms = [], [], []
    for _ in range(2):
        b = on_card()
        count = torch.zeros((), dtype=torch.int32, device=dev)
        norm = torch.zeros((), device=dev)
        part = torch.empty(optim.clip_adamw_grid(n, dev)[0], device=dev)
        optim.clip_norm(b["g"], norm, count, part)
        optim.adamw_update(b["p"], b["g"], b["mu"], b["nu"], norm, count, lr,
                           1.0, 0.9, 0.999,
                           *optim.complements(0.9, 0.999, True), 1e-8, 1e-4)
        torch.cuda.synchronize()
        bufs.append(b)
        counts.append(count)
        norms.append(norm)
    assert torch.equal(norms[0], norms[1]) and int(counts[0]) == 1
    for k in st:
        assert torch.equal(bufs[0][k], bufs[1][k]), k
    ref = {k: v.clone() for k, v in st.items()}
    ref_norm = torch.zeros(())
    optim.clip_norm_plain(ref["g"].clone(), ref_norm, torch.zeros(
        (), dtype=torch.int32))
    torch.testing.assert_close(norms[0].cpu(), ref_norm, rtol=1e-5, atol=0)
    optim.adamw_update_plain(ref["p"], ref["g"], ref["mu"], ref["nu"],
                             norms[0].cpu(), torch.ones((), dtype=torch.int32),
                             lr.cpu(), 1.0, 0.9, 0.999,
                             *optim.complements(0.9, 0.999, True), 1e-8,
                             1e-4)
    for k in ("g", "mu", "nu"):
        assert torch.equal(bufs[0][k].cpu(), ref[k]), k
    torch.testing.assert_close(bufs[0]["p"].cpu(), ref["p"], rtol=1e-5,
                               atol=1e-6 * float(ref["p"].abs().max()))


@pytest.mark.parametrize("kind", ["mlp", "cnn", "cnn_bf16"])
def test_train_step_card_vs_cpu(kind, clips):
    """One training step (`Trainer._step`, dropout 0) from the same weights
    on `test_one_step_card_vs_cpu`'s inputs (the mel images or MFCC
    features of 32 tones), on the card and on the CPU: on the card K11
    once, K12's two passes
    once each and, for the CNN, K13's four kernels once a layer (three
    layers); the loss within 1e-4 relative (5e-2 in bfloat16), each
    parameter's clipped gradient within 1e-3 of its largest value, and in
    bfloat16 within 2e-2 of its norm (`test_one_step_card_vs_cpu`'s
    bound: cuDNN's bf16 convolutions and the CPU's round at 8 bits and sum
    in other orders), leaving out the conv biases ahead of BatchNorm
    (their true gradient is 0, so both sides hold rounding noise), and the
    BatchNorm running statistics within 1e-4 of their largest value
    (1e-2)."""
    from gat_tpu_torch.models import CNN, MLP
    from gat_tpu_torch.ops import batchnorm, loss as loss_mod
    from gat_tpu_torch.train import ArrayDataLoader, Trainer, optim
    dev = _card()
    y = np.arange(32)
    if kind == "mlp":
        x = features.mfcc_feature_vectors(clips[:32], SR).cpu().numpy()
        x = (x - x.mean(0)) / x.std(0)
        make = lambda: MLP(65, 128, 2, 47, 0.0)  # noqa: E731
    else:
        x = features.melspec_features(clips[:32], SR).cpu().numpy()
        dtype = torch.bfloat16 if kind == "cnn_bf16" else torch.float32
        make = lambda: CNN(47, dropout=0.0, dtype=dtype)  # noqa: E731
    wrappers = (loss_mod.softmax_xent, optim.clip_norm, optim.adamw_update,
                batchnorm.bn_moments, batchnorm.bn_apply,
                batchnorm.bn_apply_grad, batchnorm.bn_moments_grad)
    out = []
    for device in ("cuda", "cpu"):
        t = Trainer(make(), ArrayDataLoader(x, y), seed=0, device=device)
        before = [f.launches for f in wrappers]
        loss = float(t._step(torch.from_numpy(x).to(t.device),
                             torch.from_numpy(y).to(t.device))[0])
        torch.cuda.synchronize()
        grads = {n: p.grad.detach().float().cpu()
                 for n, p in t.model.named_parameters()
                 if not (n.startswith("conv_") and n.endswith(".bias"))}
        stats = {k: v.detach().float().cpu()
                 for k, v in t.model.state_dict().items() if "running" in k}
        out.append((loss, grads, stats,
                    [f.launches - k for f, k in zip(wrappers, before)]))
    (l_card, g_card, s_card, n_card), (l_cpu, g_cpu, s_cpu, n_cpu) = out
    bn = 3 if kind != "mlp" else 0
    assert n_card == [1, 1, 1, bn, bn, bn, bn] and n_cpu == [0] * 7
    bf16 = kind == "cnn_bf16"
    assert abs(l_card - l_cpu) <= (5e-2 if bf16 else 1e-4) * abs(l_cpu)
    assert dev.type == "cuda"
    for k, r in g_cpu.items():
        if bf16:
            assert float((g_card[k] - r).norm() / r.norm()) <= 2e-2, k
        else:
            torch.testing.assert_close(g_card[k], r, rtol=0,
                                       atol=1e-3 * float(r.abs().max()),
                                       msg=lambda m, k=k: f"{k}: {m}")
    for k, r in s_cpu.items():
        torch.testing.assert_close(s_card[k], r, rtol=0,
                                   atol=(1e-2 if bf16 else 1e-4)
                                   * float(r.abs().max()),
                                   msg=lambda m, k=k: f"{k}: {m}")
