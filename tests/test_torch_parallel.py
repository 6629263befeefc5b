"""The port's multi-device layer (`gat_tpu_torch/parallel/`) against
gat_tpu's on its virtual 8-device CPU mesh, and against the port's own
single-device calls: worlds of 1, 2, 4 and 8 ranks on gloo, started by
`parallel.launch.spawn`. The ranks import only torch and the port: JAX
runs here, in the test's process, on inputs made from numpy seeds, and
the JAX weights are carried to the ranks as numpy. One world runs many
checks (`_world`) and the tests read its results.

Tolerances:
- mesh shapes and refusals exact; `mlp_tp_shardings` equal to JAX's
  specs, transposed to torch's (out, in) weights;
- YIN pitch rtol 2e-3 but the pinned near-tie of test_torch_yin;
- the data-parallel MLP step, dropout 0: loss rtol 1e-5, parameters atol
  1e-5; the CNN step, dropout 0: BatchNorm running statistics rtol 1e-5,
  parameters atol 1e-5 but the conv biases ahead of BatchNorm (true
  gradient 0, so Adam's first step is ±lr of either sign on each side,
  test_torch_train), atol 2.1e-3;
- the tensor-parallel MLP forward, logits atol 1e-5;
- the clip ensemble: labels equal, probs atol 1e-2, pitch as above
  (test_torch_slice); each rank computes B/d rows;
- the file body: kept counts equal to JAX's; `Transcriber(mesh=)`:
  labels, onsets, times and flags equal to the port's single-device call
  and confidences atol 1e-5, labels and onsets equal to JAX's;
- `Trainer(mesh=)` at world 8 with a trailing batch of 4 and dropout 0.1
  against the port's single-device Trainer: histories rtol 2e-5,
  accuracies equal, parameters atol 1e-5; `TrainingManager(
  mesh_devices=4)` the same against its single-device run, but parameters
  atol 1e-4 (two epochs of the shipped MLP recipe: Adam's normalized
  step turns summation-order noise on a near-zero gradient into up to
  4e-5);
- the pipeline's forward and gradients against JAX, atol 1e-5.
"""
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from gat_tpu_torch.parallel import launch
from gat_tpu_torch.parallel.mesh import pad_to_multiple

CLIP_SR = 11025
FILE_SR = 22050
CLASSES = ["E2", "A2", "D3", "G3"]
BUDGET = 5  # clip slots for a wave of four riffs of two kept clips each


# ---------------------------------------------------------------------------
# what the ranks run (torch and the port only)
# ---------------------------------------------------------------------------
def _meshes(world: int) -> dict:
    from gat_tpu_torch.parallel.mesh import make_mesh
    out = {"dp": make_mesh(world, device="cpu")}
    if world % 2 == 0:
        out["tp"] = make_mesh(world, model_parallel=2, device="cpu")
    out["pp"] = make_mesh(world, model_parallel=world, device="cpu")
    return out


def _task_mesh(m, inp):
    from gat_tpu_torch.parallel.mesh import make_mesh
    refused = []
    for kw in ({"model_parallel": 3}, {"n_devices": 3}):
        try:
            make_mesh(device="cpu", **kw)
        except ValueError:
            refused.append(True)
    return {"dp": tuple(m["dp"].shape), "tp": tuple(m["tp"].shape),
            "names": tuple(m["dp"].mesh_dim_names), "refused": refused}


def _task_pitch(m, inp):
    from gat_tpu_torch.parallel import sharded_batch_pitch
    return sharded_batch_pitch(m["dp"], CLIP_SR)(
        torch.from_numpy(inp["plucks"])).numpy()


def _mlp_from(flax_params, **kw):
    from gat_tpu_torch.models import MLP
    from gat_tpu_torch.models.mlp import params_from_flax
    model = MLP(**kw)
    model.load_state_dict(params_from_flax({"params": flax_params}))
    return model


def _state(module) -> dict:
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


def _task_mlp_step(m, inp):
    from gat_tpu_torch.parallel import make_sharded_train_step
    from gat_tpu_torch.parallel.sharded import adamw
    model = _mlp_from(inp["mlp_params"], num_features=12, hidden_dim=16,
                      num_hidden_layers=2, num_classes=4, dropout=0.0)
    step, prepare = make_sharded_train_step(model, adamw(1e-3), m["dp"])
    state = prepare()
    loss = float(step(state, inp["mlp_x"], inp["mlp_y"]))
    return {"loss": loss, "params": _state(state.module)}


def _task_cnn_step(m, inp):
    from gat_tpu_torch.models import CNN
    from gat_tpu_torch.models.cnn import params_from_flax
    from gat_tpu_torch.parallel import make_sharded_train_step
    from gat_tpu_torch.parallel.sharded import adamw
    model = CNN(num_classes=4, base_channels=4, num_blocks=2, hidden_dim=16,
                dropout=0.0)
    model.load_state_dict(params_from_flax(inp["cnn_vars"]))
    step, prepare = make_sharded_train_step(model, adamw(1e-3), m["dp"])
    state = prepare()
    loss = float(step(state, inp["cnn_x"], inp["cnn_y"]))
    return {"loss": loss, "params": _state(state.module)}


def _task_tp_forward(m, inp):
    from gat_tpu_torch.parallel.mesh import data_sharding
    from gat_tpu_torch.parallel.sharded import (TensorParallelMLP,
                                                mlp_tp_shardings)
    model = _mlp_from(inp["mlp_params"], num_features=12, hidden_dim=16,
                      num_hidden_layers=2, num_classes=4, dropout=0.0)
    tp = TensorParallelMLP(model, m["tp"]).eval()
    rows = data_sharding(m["tp"])
    x = inp["tp_x"]
    with torch.no_grad():
        logits = rows.gather(tp(rows.local(x)), len(x))
    return {"logits": logits.numpy(),
            "shard_shapes": {k: tuple(v.shape)
                             for k, v in tp.named_parameters()},
            "specs": mlp_tp_shardings(model, m["tp"])}


def _task_transcribe(m, inp):
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.parallel import make_sharded_transcribe
    t = Transcriber(device="cpu")
    args = (t.predictor, t.scaler, m["dp"], t.ckpt_sr, t.mfcc_params,
            t.melspec_params)
    clips = torch.from_numpy(inp["clips"])
    probs, pitch = make_sharded_transcribe(*args)(clips)
    local_probs, local_pitch = make_sharded_transcribe(*args,
                                                       gather=False)(clips)
    return {"probs": probs.numpy(), "pitch": pitch.numpy(),
            "local_rows": (len(local_probs), len(local_pitch))}


def _task_files(m, inp):
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.parallel import make_sharded_transcribe_files
    t = Transcriber(device="cpu")
    run = make_sharded_transcribe_files(t, m["dp"], FILE_SR, 0.5, 16)
    outs = run(torch.from_numpy(inp["files_y"]),
               torch.from_numpy(inp["files_nv"]))
    return {"probs": outs[0].numpy(), "kept": outs[4].numpy()}


def _results(results: list) -> list:
    return [{k: r[k] for k in ("labels", "onsets_s", "times", "confidences",
                               "onset_overflow")} for r in results]


def _task_transcriber(m, inp):
    from gat_tpu_torch.infer import Transcriber
    t = Transcriber(device="cpu", mesh=m["dp"])
    return {"all": _results(t.transcribe_files(inp["paths"])),
            "cap": _results(t.transcribe_files(inp["paths"][:2],
                                               max_onsets=2)),
            "budget": _results(t.transcribe_files(
                inp["paths"], wave_clip_budget=BUDGET,
                exact_fallback=False)),
            # one file padded to a wave of 4, a budget of its 2 kept
            # clips: ranks 1-3 have no slot picked
            "budget_lone": _results(t.transcribe_files(
                inp["paths"][4:], wave_clip_budget=2,
                exact_fallback=False)),
            # one file ignores the mesh: no collective, each rank alone
            "one": _results([t.transcribe(inp["paths"][0]),
                             t.transcribe(inp["paths"][0], fused=True)]),
            "data_par": t._data_par}


def _task_pipeline(m, inp):
    import torch.distributed as dist
    from gat_tpu_torch.parallel.mesh import MODEL, axis_group
    from gat_tpu_torch.parallel.pipeline import pipeline_apply
    w = torch.from_numpy(inp["pp_w"]).requires_grad_()
    b = torch.from_numpy(inp["pp_b"]).requires_grad_()
    xs, tgt = torch.from_numpy(inp["pp_x"]), torch.from_numpy(inp["pp_t"])
    out = pipeline_apply(w, b, xs, m["pp"])
    loss = torch.mean((out - tgt) ** 2)
    loss.backward()
    for g in (w.grad, b.grad):  # each rank holds its stage's rows
        dist.all_reduce(g, group=axis_group(m["pp"], MODEL))
    return {"out": out.detach().numpy(), "loss": loss.item(),
            "gw": w.grad.numpy(), "gb": b.grad.numpy()}


def _task_manager(m, inp):
    from gat_tpu_torch.train import TrainingManager
    mgr = TrainingManager(target_sr=11025, mesh_devices=len(m["dp"].mesh),
                          device="cpu")
    tr = mgr.train_mlp(dataset=inp["dataset"], epochs=2, save=False,
                       verbose=False)
    return _history(tr)


def _history(tr) -> dict:
    return {"train_loss": tr.train_loss_history,
            "val_loss": tr.val_loss_history,
            "train_acc": tr.train_accuracy_history,
            "val_acc": tr.val_accuracy_history,
            "params": _state(tr.model)}


def _small_trainer(mesh):
    """A tiny MLP Trainer, dropout 0.1: 100 training examples in batches
    of 16 leave a trailing batch of 4, smaller than a world of 8."""
    from gat_tpu_torch.models import MLP
    from gat_tpu_torch.train.data import ArrayDataLoader
    from gat_tpu_torch.train.trainer import Trainer
    rng = np.random.default_rng(7)
    X = rng.normal(size=(120, 12)).astype(np.float32)
    y = rng.integers(0, 4, 120).astype(np.int32)
    model = MLP(num_features=12, hidden_dim=16, num_hidden_layers=2,
                num_classes=4, dropout=0.1)
    return Trainer(model,
                   ArrayDataLoader(X[:100], y[:100], batch_size=16,
                                   shuffle=True, seed=5),
                   ArrayDataLoader(X[100:], y[100:], batch_size=16,
                                   shuffle=False),
                   reverse_map={i: f"c{i}" for i in range(4)}, seed=3,
                   model_type="mlp", device="cpu", mesh=mesh)


def _small_cnn_trainer(mesh):
    """A tiny CNN Trainer, dropout 0.1 after every block: 50 examples in
    batches of 16 leave a trailing batch of 2."""
    from gat_tpu_torch.models import CNN
    from gat_tpu_torch.train.data import ArrayDataLoader
    from gat_tpu_torch.train.trainer import Trainer
    rng = np.random.default_rng(8)
    X = rng.normal(-40.0, 20.0, (60, 16, 8, 1)).astype(np.float32)
    y = rng.integers(0, 4, 60).astype(np.int32)
    model = CNN(num_classes=4, base_channels=4, num_blocks=2, hidden_dim=16,
                dropout=0.1)
    return Trainer(model,
                   ArrayDataLoader(X[:50], y[:50], batch_size=16,
                                   shuffle=True, seed=5),
                   ArrayDataLoader(X[50:], y[50:], batch_size=16,
                                   shuffle=False),
                   reverse_map={i: f"c{i}" for i in range(4)}, seed=3,
                   model_type="cnn", device="cpu", mesh=mesh)


def _task_cnn_trainer(m, inp):
    tr = _small_cnn_trainer(m["dp"])
    tr.train(epochs=2, verbose=False)
    return _history(tr)


def _task_save(m, inp):
    """One epoch of the small MLP Trainer, then a checkpoint: rank 0
    writes it, every rank gets its path."""
    import torch.distributed as dist
    tr = _small_trainer(m["dp"])
    tr.train(epochs=1, verbose=False)
    root = Path(inp["ckpt_dir"])
    before = sorted(p.name for p in root.glob("*"))
    path = tr.save(filename="dp.gtckpt.npz", root=root)
    return {"path": str(path), "rank": dist.get_rank(),
            "before": before}


def _task_trainer(m, inp):
    tr = _small_trainer(m["dp"])
    tr.train(epochs=3, verbose=False)
    out = _history(tr)
    # the loop epoch (any iterable of batches) splits them alike
    tr2 = _small_trainer(m["dp"])
    tr2.train(epochs=1, verbose=False, scan_epoch=False)
    out["loop_train_loss"] = tr2.train_loss_history
    return out


TASKS = {"mesh": _task_mesh, "pitch": _task_pitch,
         "mlp_step": _task_mlp_step, "cnn_step": _task_cnn_step,
         "tp_forward": _task_tp_forward, "transcribe": _task_transcribe,
         "files": _task_files, "transcriber": _task_transcriber,
         "pipeline": _task_pipeline, "manager": _task_manager,
         "trainer": _task_trainer, "cnn_trainer": _task_cnn_trainer,
         "save": _task_save}


def _rank(world: int, tasks: list, inp: dict) -> dict:
    meshes = _meshes(world)
    return {name: TASKS[name](meshes, inp) for name in tasks}


def _world(world: int, tasks: list, inp: dict) -> list:
    """Each rank's {task: result} from one world on gloo."""
    return launch.spawn(_rank, world, world, tasks, inp, device="cpu",
                        timeout_s=400)


# ---------------------------------------------------------------------------
# inputs, made here from numpy seeds
# ---------------------------------------------------------------------------
def _pluck(freq: float, sr: int, seconds: float, seed: int) -> np.ndarray:
    from tests.conftest import make_pluck
    return make_pluck(freq, sr, seconds, seed=seed)


def _riff_paths(d: Path) -> list:
    """test_parallel's five 1.6 s riffs of three plucks at 22050 Hz."""
    from gat_tpu_torch.utils.wavio import write_wav
    paths = []
    for i in range(5):
        y = np.zeros(int(1.6 * FILE_SR), np.float32)
        for j, f in enumerate([110.0 * (1 + i % 2), 196.0, 246.94]):
            note = _pluck(f, FILE_SR, 0.4, seed=i * 7 + j)
            fade = int(0.3 * len(note))
            note[-fade:] *= np.linspace(1, 0, fade, dtype=np.float32)
            s = int((0.2 + 0.45 * j) * FILE_SR)
            y[s:s + len(note)] += note
        p = d / f"r{i}.wav"
        write_wav(p, y, FILE_SR)
        paths.append(str(p))
    return paths


def _file_batch() -> tuple[np.ndarray, np.ndarray]:
    """test_parallel's eight 3 s files of three plucks."""
    ys = []
    for i in range(8):
        y = np.zeros(3 * FILE_SR, np.float32)
        for j, f in enumerate([110.0 * (1 + i % 3), 196.0, 246.94]):
            note = _pluck(f, FILE_SR, 0.45, seed=i * 10 + j)
            fade = int(0.3 * len(note))
            note[-fade:] *= np.linspace(1, 0, fade, dtype=np.float32)
            s = int((0.4 + 0.8 * j) * FILE_SR)
            y[s:s + len(note)] += note
        ys.append(y)
    return np.stack(ys), np.full((8,), 3 * FILE_SR, np.int64)


@pytest.fixture(scope="module")
def jax_models():
    """JAX's small MLP and CNN with their initial variables."""
    import jax
    import jax.numpy as jnp
    from gat_tpu.models import CNN, MLP
    rng = np.random.default_rng(42)
    mlp = MLP(num_features=12, hidden_dim=16, num_classes=4, dropout=0.0)
    mlp_x = rng.normal(size=(32, 12)).astype(np.float32)
    mlp_y = rng.integers(0, 4, 32)
    mlp_vars = mlp.init(jax.random.PRNGKey(0), jnp.asarray(mlp_x[:1]))
    cnn = CNN(num_classes=4, base_channels=4, num_blocks=2, hidden_dim=16,
              dropout=0.0)
    cnn_x = rng.normal(size=(16, 16, 8, 1)).astype(np.float32)
    cnn_y = rng.integers(0, 4, 16)
    cnn_vars = cnn.init(jax.random.PRNGKey(0), jnp.asarray(cnn_x[:1]))
    tp_x = rng.normal(size=(8, 12)).astype(np.float32)
    to_np = (lambda tree: jax.tree_util.tree_map(np.asarray, tree))
    return dict(mlp=mlp, mlp_vars=mlp_vars, mlp_x=mlp_x, mlp_y=mlp_y,
                cnn=cnn, cnn_vars=cnn_vars, cnn_x=cnn_x, cnn_y=cnn_y,
                tp_x=tp_x, mlp_params=to_np(mlp_vars["params"]),
                cnn_np=to_np(cnn_vars))


def _pipeline_inputs(nd: int) -> dict:
    import jax
    from gat_tpu.parallel.pipeline import init_pipeline_params
    w, b = init_pipeline_params(jax.random.PRNGKey(0), nd, 16)
    rng = np.random.default_rng(nd)
    return {"pp_w": np.asarray(w), "pp_b": np.asarray(b),
            "pp_x": rng.normal(size=(6, 4, 16)).astype(np.float32),
            "pp_t": rng.normal(size=(6, 4, 16)).astype(np.float32)}


@pytest.fixture(scope="module")
def plucks():
    from tests.test_torch_spectral import pluck_clips
    return pluck_clips(0.0)


@pytest.fixture(scope="module")
def clip_batch():
    """test_parallel's 16 clips of 0.5 s at 11025 Hz."""
    return np.stack([_pluck(110 + 20 * i, CLIP_SR, 5512 / CLIP_SR, seed=i)
                     [:5512] for i in range(16)]).astype(np.float32)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from gat_tpu_torch.data.synth import synthesize_note_dataset
    ds = tmp_path_factory.mktemp("ds") / "ds"
    synthesize_note_dataset(ds, variants_per_class=6, seed=1,
                            class_names=CLASSES, verbose=False)
    return ds


@pytest.fixture(scope="module")
def riff_paths(tmp_path_factory):
    return _riff_paths(tmp_path_factory.mktemp("riffs"))


@pytest.fixture(scope="module")
def world4(jax_models, plucks, clip_batch, dataset, riff_paths):
    ys, nv = _file_batch()
    inp = dict(plucks=plucks, mlp_params=jax_models["mlp_params"],
               mlp_x=jax_models["mlp_x"], mlp_y=jax_models["mlp_y"],
               cnn_vars=jax_models["cnn_np"], cnn_x=jax_models["cnn_x"],
               cnn_y=jax_models["cnn_y"], tp_x=jax_models["tp_x"],
               clips=clip_batch, files_y=ys, files_nv=nv,
               paths=riff_paths,
               dataset=str(dataset), **_pipeline_inputs(4))
    return _world(4, ["mesh", "pitch", "mlp_step", "cnn_step", "tp_forward",
                      "transcribe", "files", "transcriber", "pipeline",
                      "manager"], inp)


@pytest.fixture(scope="module")
def jax_transcribe(clip_batch):
    """JAX's sharded clip program at 4 devices on the 16 clips."""
    import jax.numpy as jnp  # noqa: F401  (the virtual mesh is up)
    from gat_tpu.config import CNN_CONFIG, MLP_CONFIG
    from gat_tpu.infer.predictor import NotePredictor
    from gat_tpu.parallel import (make_mesh, make_sharded_transcribe,
                                  shard_batch)
    from gat_tpu.train.checkpoint import load_checkpoint
    from gat_tpu.utils.scaler import FeatureScaler
    mlp_ck = load_checkpoint(MLP_CONFIG.CHECKPOINTS_DIR
                             / MLP_CONFIG.DEFAULT_CKPT_NAME)
    cnn_ck = load_checkpoint(CNN_CONFIG.CHECKPOINTS_DIR
                             / CNN_CONFIG.DEFAULT_CKPT_NAME)
    pred = NotePredictor()
    pred.load_models(mlp_ck, cnn_ck)
    mesh = make_mesh(4)
    run = make_sharded_transcribe(pred, FeatureScaler.from_dict(
        mlp_ck["scaler"]), mesh, CLIP_SR,
        mlp_ck["config"]["features"]["params"],
        cnn_ck["config"]["features"]["params"])
    probs, pitch = run(shard_batch(clip_batch, mesh))
    return np.asarray(probs), np.asarray(pitch)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------
def test_mesh_shapes_and_refusals(world4):
    for r in world4:
        got = r["mesh"]
        assert got["dp"] == (4, 1) and got["tp"] == (2, 2)
        assert got["names"] == ("data", "model")
        assert got["refused"] == [True, True]  # model_parallel 3; 3 of 4


def test_pad_to_multiple():
    x = np.ones((13, 4))
    padded, n = pad_to_multiple(x, 8)
    assert padded.shape == (16, 4) and n == 13
    assert not padded[13:].any()
    same, n2 = pad_to_multiple(np.ones((16, 4)), 8)
    assert same.shape == (16, 4) and n2 == 16
    cols, n3 = pad_to_multiple(np.ones((2, 5)), 4, axis=1)
    assert cols.shape == (2, 8) and n3 == 5


def test_make_mesh_needs_a_world_and_a_device():
    from gat_tpu_torch.parallel.mesh import make_mesh
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        make_mesh(2, device="meta")


def test_sharded_pitch_matches_jax(world4, plucks):
    """47 clips over 4 ranks (blocks of 11, 12, 12, 12) against JAX's
    sharded YIN (its batch padded to 48)."""
    from gat_tpu.parallel import make_mesh, sharded_batch_pitch, shard_batch
    from tests.test_torch_yin import NEAR_TIE
    mesh = make_mesh(4)
    padded, n = pad_to_multiple(plucks, 4)
    ref = np.asarray(sharded_batch_pitch(mesh, CLIP_SR)(
        shard_batch(padded, mesh)))[:n]
    keep = np.ones(n, bool)
    keep[NEAR_TIE] = False
    for r in world4:
        assert r["pitch"].shape == (47,)
        np.testing.assert_allclose(r["pitch"][keep], ref[keep], rtol=2e-3)


def test_dp_mlp_step_matches_jax(world4, jax_models):
    import jax
    import optax
    from gat_tpu.parallel import (make_mesh, make_sharded_train_step,
                                  shard_batch)
    from gat_tpu_torch.models.mlp import params_from_flax
    jm = jax_models
    mesh = make_mesh(4)
    tx = optax.adamw(1e-3)
    step, prepare = make_sharded_train_step(jm["mlp"], tx, mesh)
    p, e, o = prepare(jm["mlp_vars"]["params"], {},
                      tx.init(jm["mlp_vars"]["params"]))
    p2, _, _, loss = step(p, e, o, shard_batch(jm["mlp_x"], mesh),
                          shard_batch(jm["mlp_y"], mesh),
                          jax.random.PRNGKey(1))
    ref = params_from_flax({"params": jax.tree_util.tree_map(np.asarray,
                                                             p2)})
    for r in world4:
        got = r["mlp_step"]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        for k, v in ref.items():
            np.testing.assert_allclose(got["params"][k], v.numpy(),
                                       atol=1e-5, err_msg=k)


def test_dp_cnn_step_matches_jax(world4, jax_models):
    """The global batch's BatchNorm statistics: 16 rows over 4 ranks."""
    import jax
    import optax
    from gat_tpu.parallel import (make_mesh, make_sharded_train_step,
                                  shard_batch)
    from gat_tpu_torch.models.cnn import params_from_flax
    jm = jax_models
    mesh = make_mesh(4)
    tx = optax.adamw(1e-3)
    variables = jm["cnn_vars"]
    step, prepare = make_sharded_train_step(jm["cnn"], tx, mesh)
    p, e, o = prepare(variables["params"],
                      {"batch_stats": variables["batch_stats"]},
                      tx.init(variables["params"]))
    p2, mut, _, loss = step(p, e, o, shard_batch(jm["cnn_x"], mesh),
                            shard_batch(jm["cnn_y"], mesh),
                            jax.random.PRNGKey(1))
    ref = params_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": p2, "batch_stats": mut["batch_stats"]}))
    for r in world4:
        got = r["cnn_step"]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        for k, v in ref.items():
            if k.endswith("num_batches_tracked"):
                continue
            if "running" in k:
                tol = dict(rtol=1e-5, atol=1e-7)
            elif k.startswith("conv_") and k.endswith(".bias"):
                tol = dict(rtol=0, atol=2.1e-3)
            else:
                tol = dict(rtol=0, atol=1e-5)
            np.testing.assert_allclose(got["params"][k], v.numpy(),
                                       err_msg=k, **tol)


def test_tp_mlp_forward_matches_jax(world4, jax_models):
    """(data 2, model 2): the hidden units split over `model`, the rows
    over `data`; logits against the unsharded flax forward, and the
    layout against JAX's `mlp_tp_shardings`."""
    import jax.numpy as jnp
    from gat_tpu.parallel import make_mesh, mlp_tp_shardings
    jm = jax_models
    ref = np.asarray(jm["mlp"].apply(jm["mlp_vars"], jnp.asarray(jm["tp_x"])))
    jspecs = mlp_tp_shardings(jm["mlp_vars"]["params"],
                              make_mesh(8, model_parallel=2))
    for r in world4:
        got = r["tp_forward"]
        np.testing.assert_allclose(got["logits"], ref, atol=1e-5)
        for layer, leaves in jspecs.items():
            for leaf, sharding in leaves.items():
                spec = tuple(sharding.spec) + (None,) * (
                    jm["mlp_vars"]["params"][layer][leaf].ndim
                    - len(sharding.spec))
                field = {"kernel": "weight", "scale": "weight"}.get(leaf,
                                                                    leaf)
                want = spec[::-1] if leaf == "kernel" else spec
                assert got["specs"][f"{layer}.{field}"] == want, layer
        assert got["shard_shapes"]["dense_0.weight"] == (8, 12)
        assert got["shard_shapes"]["dense_1.weight"] == (8, 8)
        assert got["shard_shapes"]["out.weight"] == (4, 4)
        assert got["shard_shapes"]["out.bias"] == (4,)


def _check_transcribe(results, world, jax_ref):
    probs_ref, pitch_ref = jax_ref
    for r in results:
        got = r["transcribe"]
        assert got["local_rows"] == (16 // world, 16 // world)
        np.testing.assert_array_equal(got["probs"].argmax(1),
                                      probs_ref.argmax(1))
        np.testing.assert_allclose(got["probs"], probs_ref, atol=1e-2)
        np.testing.assert_allclose(got["pitch"], pitch_ref, rtol=2e-3)


@pytest.mark.parametrize("world", [4])
def test_sharded_transcribe_partitions_and_matches_jax(world, request,
                                                       jax_transcribe):
    """Each rank computes B/d of the 16 clips; the gathered outputs equal
    JAX's sharded program's (labels; probs as test_torch_slice). Worlds 1
    and 2: test_torch_parallel_worlds."""
    _check_transcribe(request.getfixturevalue(f"world{world}"), world,
                      jax_transcribe)


@pytest.fixture(scope="module")
def jax_files():
    from gat_tpu.infer import Transcriber
    import jax.numpy as jnp
    ys, nv = _file_batch()
    t = Transcriber()
    outs = t._fused_files_fn(FILE_SR, 0.5, 16)[0](jnp.asarray(ys),
                                                  jnp.asarray(nv, jnp.int32))
    return np.asarray(outs[0]), np.asarray(outs[4])


@pytest.mark.parametrize("world", [4])
def test_sharded_files_match_jax(world, request, jax_files):
    """The file body over 8 files of 3 s split over the ranks: kept slots
    equal to JAX's single-device fused program's, labels and probs of the
    kept slots as test_torch_slice. World 2: test_torch_parallel_worlds."""
    probs_ref, kept_ref = jax_files
    assert kept_ref.sum() > 0
    for r in request.getfixturevalue(f"world{world}"):
        got = r["files"]
        np.testing.assert_array_equal(got["kept"], kept_ref)
        np.testing.assert_array_equal(got["kept"].sum(1), kept_ref.sum(1))
        kept = kept_ref.astype(bool)
        np.testing.assert_array_equal(got["probs"][kept].argmax(-1),
                                      probs_ref[kept].argmax(-1))
        np.testing.assert_allclose(got["probs"][kept], probs_ref[kept],
                                   atol=1e-2)


def test_mesh_transcriber_files_match_single_device_and_jax(world4,
                                                           riff_paths):
    """Transcriber(mesh=).transcribe_files at world 4 (max_batch 4, five
    files: a full wave and a lone file padded to B = 4), and the
    max_onsets=2 cap case, whose auto-scaling re-runs ride the sharded
    bodies: the port's single-device call exactly, JAX's labels and
    onsets."""
    from gat_tpu.infer import Transcriber as JTranscriber
    from gat_tpu_torch.infer import Transcriber
    t = Transcriber(device="cpu")
    jt = JTranscriber()
    single = _results(t.transcribe_files(riff_paths))
    cap = _results(t.transcribe_files(riff_paths[:2], max_onsets=2))
    jall = jt.transcribe_files(riff_paths)
    jcap = jt.transcribe_files(riff_paths[:2], max_onsets=2)
    assert any(r["labels"] for r in single)
    assert world4[0]["transcriber"]["data_par"] == 4
    for r in world4:
        for got, ref, jref in ((r["transcriber"]["all"], single, jall),
                               (r["transcriber"]["cap"], cap, jcap)):
            assert len(got) == len(ref) == len(jref)
            for g, s, j in zip(got, ref, jref):
                assert g["labels"] == s["labels"] == j["labels"]
                assert g["onsets_s"] == s["onsets_s"] == j["onsets_s"]
                assert g["times"] == s["times"]
                assert g["onset_overflow"] == s["onset_overflow"]
                np.testing.assert_allclose(g["confidences"],
                                           s["confidences"], atol=1e-5)
        assert not any(g["onset_overflow"] for g in r["transcriber"]["cap"])
        one = r["transcriber"]["one"]
        for g in one:
            assert g["labels"] == single[0]["labels"]
            assert g["onsets_s"] == single[0]["onsets_s"]


def test_mesh_transcriber_global_clip_budget(world4, riff_paths):
    """`wave_clip_budget` under a mesh is the whole wave's, as under JAX's
    sharded program: with exact_fallback=False and a budget of 5 slots
    for a wave of four riffs, the slot-major order over the wave keeps
    slot 0 of every file and slot 1 of the first, so the other three
    lose their second clip and are flagged. Each rank holds one file of
    the wave: a per-rank budget would flag none. Labels, onsets, times
    and flags equal the port's single-device call, confidences atol
    1e-5; labels, onsets and flags equal JAX's. A lone file padded to a wave of four
    with a budget of its two kept clips leaves three ranks no slot to
    compute; it too equals both."""
    from gat_tpu.infer import Transcriber as JTranscriber
    from gat_tpu_torch.infer import Transcriber
    kw = dict(wave_clip_budget=BUDGET, exact_fallback=False)
    t = Transcriber(device="cpu")
    single = _results(t.transcribe_files(riff_paths, **kw))
    jref = JTranscriber().transcribe_files(riff_paths, **kw)
    assert [s["onset_overflow"] for s in single] == [False] + [True] * 3 \
        + [False]
    assert [len(s["labels"]) for s in single] == [2, 1, 1, 1, 2]
    lone = dict(wave_clip_budget=2, exact_fallback=False)
    single_lone = _results(t.transcribe_files(riff_paths[4:], **lone))
    jref_lone = JTranscriber().transcribe_files(riff_paths[4:], **lone)
    assert len(single_lone[0]["labels"]) == 2
    for r, (key, ref, jr) in itertools.product(
            world4, (("budget", single, jref),
                     ("budget_lone", single_lone, jref_lone))):
        got = r["transcriber"][key]
        assert len(got) == len(ref) == len(jr)
        for g, s, j in zip(got, ref, jr):
            assert g["labels"] == s["labels"] == j["labels"]
            assert g["onsets_s"] == s["onsets_s"] == j["onsets_s"]
            assert g["times"] == s["times"]
            assert (g["onset_overflow"] == s["onset_overflow"]
                    == j["onset_overflow"])
            np.testing.assert_allclose(g["confidences"], s["confidences"],
                                       atol=1e-5)


@pytest.mark.parametrize("world", [4])
def test_pipeline_matches_jax(world, request):
    """Forward and gradients of the mean-square loss through the S-stage
    pipeline against JAX's pipeline_apply on its virtual mesh. World 2:
    test_torch_parallel_worlds."""
    import jax
    import jax.numpy as jnp
    from gat_tpu.parallel import make_mesh
    from gat_tpu.parallel.pipeline import pipeline_apply
    inp = _pipeline_inputs(world)
    mesh = make_mesh(world, model_parallel=world)
    xs, tgt = jnp.asarray(inp["pp_x"]), jnp.asarray(inp["pp_t"])

    def loss_pp(w, b):
        return jnp.mean((pipeline_apply(w, b, xs, mesh) - tgt) ** 2)
    out = np.asarray(pipeline_apply(jnp.asarray(inp["pp_w"]),
                                    jnp.asarray(inp["pp_b"]), xs, mesh))
    loss, (gw, gb) = jax.value_and_grad(loss_pp, argnums=(0, 1))(
        jnp.asarray(inp["pp_w"]), jnp.asarray(inp["pp_b"]))
    for r in request.getfixturevalue(f"world{world}"):
        got = r["pipeline"]
        np.testing.assert_allclose(got["out"], out, atol=1e-5)
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-6)
        np.testing.assert_allclose(got["gw"], np.asarray(gw), atol=1e-5)
        np.testing.assert_allclose(got["gb"], np.asarray(gb), atol=1e-5)


def test_training_manager_mesh_devices(world4, dataset):
    """TrainingManager(mesh_devices=4).train_mlp against its single-device
    run on the same synthesized dataset."""
    from gat_tpu_torch.train import TrainingManager
    tr = TrainingManager(target_sr=11025, device="cpu").train_mlp(
        dataset=dataset, epochs=2, save=False, verbose=False)
    want = _history(tr)
    for r in world4:
        got = r["manager"]
        assert np.isfinite(got["train_loss"]).all()
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=2e-5)
        assert got["train_acc"] == want["train_acc"]
        assert got["val_acc"] == want["val_acc"]
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, atol=1e-4,
                                       err_msg=k)


def _fails_on_rank_1():
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise ValueError("rank 1 gives up before the collective")
    x = torch.ones(1)
    dist.all_reduce(x)  # the other ranks wait here for rank 1
    return float(x)


def test_failing_rank_ends_the_world():
    """A rank that raises before a collective: spawn raises, naming it,
    long before the deadline, and no rank is left running."""
    import time
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank 1 of 4 failed"
                       r"(.|\n)*gives up before the collective"):
        launch.spawn(_fails_on_rank_1, 4, device="cpu", timeout_s=120)
    assert time.monotonic() - t0 < 60


def _sleeps():
    import time
    time.sleep(60)


def test_spawn_deadline_ends_a_hung_world():
    import time
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        launch.spawn(_sleeps, 2, device="cpu", timeout_s=3)
    assert time.monotonic() - t0 < 30


def test_spawn_returns_each_ranks_result():
    assert launch.spawn(_rank_id, 3, 10, device="cpu") == [10, 11, 12]


def _rank_id(base: int) -> int:
    import torch.distributed as dist
    return base + dist.get_rank()
