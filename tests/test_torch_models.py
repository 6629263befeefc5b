"""PyTorch port vs gat_tpu: checkpoint reader, weight transfer, the MLP
and CNN, scaler, mel filterbanks and pitch names (CPU, fp32)."""
import glob
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gat_tpu.models import MLP as JMLP, CNN as JCNN
from gat_tpu.models.cnn import _adaptive_pool_matrix
from gat_tpu.ops import mel as jmel, pitch as jpitch
from gat_tpu.train.checkpoint import load_checkpoint as jload
from gat_tpu.utils.scaler import FeatureScaler as JScaler
from gat_tpu_torch.infer.predictor import NotePredictor
from gat_tpu_torch.models import cnn as tcnn, mlp as tmlp
from gat_tpu_torch.ops import mel as tmel, pitch as tpitch
from gat_tpu_torch.train.checkpoint import load_checkpoint as tload
from gat_tpu_torch.utils.scaler import FeatureScaler

REPO = Path(__file__).resolve().parent.parent
CKPTS = sorted(glob.glob(str(REPO / "data/checkpoints/*/*.gtckpt.npz")))


def _assert_same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def test_config_mirrors_gat_tpu():
    """Every config field the port keeps equals the JAX package's."""
    import dataclasses
    from gat_tpu import config as jc
    from gat_tpu_torch import config as tc
    for name in ("MFCC_CONFIG", "MELSPEC_CONFIG", "MLP_CONFIG",
                 "CNN_CONFIG"):
        for f in dataclasses.fields(getattr(tc, name)):
            assert (getattr(getattr(tc, name), f.name)
                    == getattr(getattr(jc, name), f.name)), (name, f.name)
    assert (tc.TARGET_SR, tc.CLIP_DURATION) == (jc.TARGET_SR,
                                                jc.CLIP_DURATION)
    assert tc.CHECKPOINTS_ROOT == jc.CHECKPOINTS_ROOT
    assert tc.DATASETS_ROOT == jc.DATASETS_ROOT
    # the training fields, and the embedded form checkpoints carry
    for name, fields in (("MLP_CONFIG", ("SAVE_CHECKPOINT", "LR", "DECAY",
                                         "EPOCHS", "MAX_CLIP_NORM",
                                         "ES_WINDOW_LEN", "ES_SLOPE_LIMIT")),
                         ("CNN_CONFIG", ("SAVE_CHECKPOINT", "LR", "DECAY",
                                         "EPOCHS", "MAX_CLIP_NORM",
                                         "ES_WINDOW_LEN", "ES_SLOPE_LIMIT",
                                         "USE_AMP"))):
        for f in fields:
            assert (getattr(getattr(tc, name), f)
                    == getattr(getattr(jc, name), f)), (name, f)
    for name in ("MFCC_CONFIG", "MELSPEC_CONFIG", "MLP_CONFIG",
                 "CNN_CONFIG"):
        assert (tc.config_dict(getattr(tc, name))
                == jc.config_dict(getattr(jc, name))), name
    # the data and inference roots, and the mesh layout kept as data
    for name in ("PERSONAL_DATASETS_ROOT", "INFERENCE_ROOT",
                 "INFERENCE_CLIPS_ROOT", "INFERENCE_AUDIO_ROOT",
                 "INFERENCE_OUTPUT_ROOT"):
        assert getattr(tc, name) == getattr(jc, name), name
    assert (tc.config_dict(tc.PARALLEL_CONFIG)
            == jc.config_dict(jc.PARALLEL_CONFIG))
    assert tc.ParallelConfig() == tc.PARALLEL_CONFIG


def test_all_shipped_checkpoints_found():
    assert len(CKPTS) == 5


@pytest.mark.parametrize("path", CKPTS, ids=lambda p: Path(p).name)
def test_checkpoint_reader_matches(path):
    a, b = jload(path), tload(path)
    _assert_same_tree(a, b)
    assert all(isinstance(k, int) for k in b["reverse_map"])


@pytest.mark.parametrize("path", CKPTS, ids=lambda p: Path(p).name)
def test_logits_match_flax(path):
    """Logits after params_from_flax equal flax apply to atol 1e-4."""
    ck = tload(path)
    args = dict(ck["model_init_args"])
    rng = np.random.default_rng(7)
    if "num_features" in args:
        x = rng.normal(size=(16, args["num_features"])).astype(np.float32)
        ref = JMLP(**args).apply(jax.tree_util.tree_map(
            jnp.asarray, ck["variables"]), x)
        model = tmlp.MLP(**args)
        model.load_state_dict(tmlp.params_from_flax(ck["variables"]))
    else:
        args["adaptive_pool"] = tuple(args["adaptive_pool"])
        x = rng.normal(-40.0, 20.0, size=(8, 64, 22, 1)).astype(np.float32)
        ref = JCNN(**args).apply(jax.tree_util.tree_map(
            jnp.asarray, ck["variables"]), x)
        model = tcnn.CNN(**args)
        model.load_state_dict(tcnn.params_from_flax(ck["variables"]))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("n_in,n_out", [(8, 4), (2, 4), (5, 4), (3, 2),
                                        (11, 4), (22, 4)])
def test_adaptive_pool_bins_match(n_in, n_out):
    """F.adaptive_avg_pool2d uses the bins of _adaptive_pool_matrix,
    overlapping ones included (2 → 4 on the CNN's time axis)."""
    x = np.random.default_rng(n_in).normal(size=(3, 5, n_in, n_in)
                                           ).astype(np.float32)
    ph = _adaptive_pool_matrix(n_in, n_out)
    ref = np.einsum("nchw,hp,wq->ncpq", x, ph, ph)
    got = F.adaptive_avg_pool2d(torch.from_numpy(x), (n_out, n_out))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def test_cnn_input_is_nhwc_and_pool_floors():
    model = tcnn.CNN().eval()
    with torch.no_grad():
        out = model(torch.zeros(2, 64, 22, 1))
    assert out.shape == (2, 47)


@pytest.mark.parametrize("hidden,layers", [(128, 2), (128, 4), (16, 3),
                                           (8, 2)])
def test_mlp_dims(hidden, layers):
    from gat_tpu.models.mlp import mlp_dims
    assert tmlp.mlp_dims(hidden, layers) == mlp_dims(hidden, layers)


def test_scaler_matches():
    ck = tload(REPO / "data/checkpoints/mlp/mlp_synth_v1.0.0.gtckpt.npz")
    x = np.random.default_rng(3).normal(size=(10, 65)).astype(np.float32)
    ref = np.asarray(JScaler.from_dict(ck["scaler"]).transform(x))
    got = FeatureScaler.from_dict(ck["scaler"]).transform(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sr,n_fft,n_mels", [(11025, 2048, 64),
                                             (11025, 2048, 128),
                                             (22050, 2048, 128)])
def test_filterbanks_equal(sr, n_fft, n_mels):
    np.testing.assert_array_equal(
        tmel.mel_filterbank_librosa(sr, n_fft, n_mels),
        jmel.mel_filterbank_librosa(sr, n_fft, n_mels))
    np.testing.assert_array_equal(
        tmel.mel_filterbank_torchaudio(sr, n_fft, n_mels),
        jmel.mel_filterbank_torchaudio(sr, n_fft, n_mels))


def test_pitch_names_match():
    for m in range(21, 109):
        for uni in (True, False):
            name = tpitch.midi_to_note(m, unicode=uni)
            assert name == jpitch.midi_to_note(m, unicode=uni)
            assert tpitch.note_to_midi(name) == jpitch.note_to_midi(name)
    for name in ("Cb4", "B#3", "Eb2", "F♯3", "D♭5"):
        assert tpitch.note_to_midi(name) == jpitch.note_to_midi(name)


def test_reverse_map_disagreement_raises():
    mlp = tload(REPO / "data/checkpoints/mlp/mlp_synth_v1.0.0.gtckpt.npz")
    cnn = dict(tload(REPO / "data/checkpoints/cnn/cnn_v1.0.0.gtckpt.npz"))
    rm = cnn["reverse_map"]
    cnn["reverse_map"] = {i: rm[(i + 1) % len(rm)] for i in rm}
    with pytest.raises(ValueError, match="reverse_map"):
        NotePredictor(device="cpu").load_models(mlp, cnn)
