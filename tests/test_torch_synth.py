"""The port's synthesizers and dataset writers against gat_tpu's: the same
seeded recipe writes byte-identical WAV files, for every family, with the
noise, playing-style and channel stressors on; the eval-only modal writer
too, with its marker (CPU, numpy)."""
from pathlib import Path

import numpy as np
import pytest

from gat_tpu.data import channel as jchannel, modal as jmodal, synth as jsynth
from gat_tpu.ops import pitch as jpitch
from gat_tpu_torch.data import channel as tchannel, modal as tmodal
from gat_tpu_torch.data import synth as tsynth
from gat_tpu_torch.ops import pitch as tpitch

CLASSES = ["E2", "A#3", "G5"]


def _files(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _assert_same_tree(a: Path, b: Path, n_expected: int) -> None:
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    assert sum(k.endswith(".wav") for k in fa) == n_expected
    for k in fa:
        assert fa[k] == fb[k], k


@pytest.mark.parametrize("family", ["ks", "additive", "fm", "all3", "mixed"])
def test_dataset_bytes_identical(tmp_path, family):
    """Noise on half the variants, a stressor on half ('mix'), a channel
    stressor on half ('mix'): every WAV equal byte for byte."""
    kw = dict(class_names=CLASSES, variants_per_class=6, seed=5,
              duration=0.25, verbose=False, noise_snr_db=(8.0, 40.0),
              family=family, stressor="mix", stressor_prob=0.5,
              channel="mix", channel_prob=0.5)
    jsynth.synthesize_note_dataset(tmp_path / "jax", **kw)
    tsynth.synthesize_note_dataset(tmp_path / "torch", **kw)
    _assert_same_tree(tmp_path / "jax", tmp_path / "torch", 18)


@pytest.mark.parametrize("stressor,channel", [(None, None),
                                              ("palm_mute", "full_chain"),
                                              ("vibrato", "mix_chain"),
                                              ("bend", "room_ir")])
def test_dataset_bytes_identical_each_stressor(tmp_path, stressor, channel):
    kw = dict(class_names=CLASSES[:2], variants_per_class=3, seed=42,
              duration=0.2, sr=11025, verbose=False, family="all3",
              stressor=stressor, channel=channel)
    jsynth.synthesize_note_dataset(tmp_path / "jax", **kw)
    tsynth.synthesize_note_dataset(tmp_path / "torch", **kw)
    _assert_same_tree(tmp_path / "jax", tmp_path / "torch", 6)


def test_modal_dataset_bytes_identical_with_marker(tmp_path):
    kw = dict(class_names=CLASSES, variants_per_class=2, seed=1,
              duration=0.25, stressor="mix", channel="mix")
    jmodal.render_modal_dataset(tmp_path / "jax", **kw)
    tmodal.render_modal_dataset(tmp_path / "torch", **kw)
    _assert_same_tree(tmp_path / "jax", tmp_path / "torch", 6)
    assert (tmp_path / "torch" / tmodal.EVAL_ONLY_MARKER).is_file()
    assert tmodal.EVAL_ONLY_MARKER == jmodal.EVAL_ONLY_MARKER


@pytest.mark.parametrize("fn", ["karplus_strong", "additive_pluck",
                                "fm_pluck"])
def test_synthesizers_equal(fn):
    got = getattr(tsynth, fn)(196.0, 11025, 0.3, n_variants=3, seed=7)
    ref = getattr(jsynth, fn)(196.0, 11025, 0.3, n_variants=3, seed=7)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("which", ["room_ir", "pickup_eq", "bg_noise",
                                   "mix", "mix_chain", "full_chain"])
def test_channel_stressors_equal(which):
    sig = jsynth.additive_pluck(220.0, 22050, 0.3, seed=3)[0]
    got = tchannel.apply_channel(sig, 22050, which,
                                 np.random.default_rng(11))
    ref = jchannel.apply_channel(sig, 22050, which,
                                 np.random.default_rng(11))
    np.testing.assert_array_equal(got, ref)


def test_frozen_tables_and_seeds_equal():
    assert tsynth._MIX_KEYS == jsynth._MIX_KEYS
    assert tuple(tsynth._STRESSORS) == tuple(jsynth._STRESSORS)
    assert tsynth.DEFAULT_CLASS_NAMES == jsynth.DEFAULT_CLASS_NAMES
    for args in ((42, 3, 5, 48), (0, 46, 47, 48), (7, 1, 150, 200)):
        assert tsynth._variant_seed(*args) == jsynth._variant_seed(*args)
    midi = np.arange(21, 109)
    np.testing.assert_array_equal(tpitch.midi_to_hz(midi),
                                  jpitch.midi_to_hz(midi))


def test_writer_validates_before_writing(tmp_path):
    for kw in (dict(channel="bogus"), dict(stressor="bogus"),
               dict(family="bogus"), dict(stressor_prob=2.0)):
        with pytest.raises(ValueError):
            tsynth.synthesize_note_dataset(tmp_path / "x", class_names=CLASSES,
                                           variants_per_class=2,
                                           verbose=False, **kw)
    assert not (tmp_path / "x").exists()
