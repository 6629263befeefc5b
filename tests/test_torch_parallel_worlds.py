"""The port's multi-device layer at worlds 1, 2 and 8, its server under
`--mesh` and its dry run, on gloo ranks started by `parallel.launch.
spawn` (the ranks' tasks and the JAX references are test_torch_parallel's,
where world 4 runs; the tolerances are stated there).

- `make_sharded_transcribe` at worlds 1 and 2, the file body and the
  pipeline at world 2, against JAX;
- `Trainer(mesh=)` at world 8 (an MLP) and at world 2 (a CNN with
  dropout) against the port's single-device Trainer;
- one pass of `serve --mesh 2 --once --batch 4` against the single-device
  pass: the same result files, labels, onsets and YIN equal and
  confidences atol 1e-5 (each rank runs two of the wave's four files);
- `dryrun_multichip(4)`: a data-parallel CNN Trainer epoch, a TP x DP MLP
  step, a 4-stage pipeline step, file inference through
  `Transcriber(mesh=)` and time-sharded onsets equal to single-device.
"""
import json

import numpy as np
import pytest

from test_torch_parallel import (_check_transcribe, _file_batch, _history,
                                 _pipeline_inputs, _small_cnn_trainer,
                                 _small_trainer, _world)
from test_torch_parallel import (  # noqa: F401  (fixtures, found by name)
    clip_batch, jax_files, jax_transcribe)
from test_torch_parallel import (  # the world-4 tests' bodies
    test_pipeline_matches_jax as _pipeline_check,
    test_sharded_files_match_jax as _files_check)


@pytest.fixture(scope="module")
def world1(clip_batch):
    return _world(1, ["transcribe"], dict(clips=clip_batch))


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("ckpt")


@pytest.fixture(scope="module")
def world2(clip_batch, ckpt_dir):
    ys, nv = _file_batch()
    return _world(2, ["transcribe", "files", "pipeline", "cnn_trainer",
                      "save"],
                  dict(clips=clip_batch, files_y=ys, files_nv=nv,
                       ckpt_dir=str(ckpt_dir), **_pipeline_inputs(2)))


@pytest.mark.parametrize("world", [1, 2])
def test_sharded_transcribe_partitions_and_matches_jax(world, request,
                                                       jax_transcribe):
    """Each rank computes B/d of the 16 clips; the gathered outputs equal
    JAX's sharded program's."""
    _check_transcribe(request.getfixturevalue(f"world{world}"), world,
                      jax_transcribe)


@pytest.mark.parametrize("world", [2])
def test_sharded_files_match_jax(world, request, jax_files):
    _files_check(world, request, jax_files)


@pytest.mark.parametrize("world", [2])
def test_pipeline_matches_jax(world, request):
    _pipeline_check(world, request)


def test_trainer_mesh_matches_single_device():
    """Trainer(mesh=) at world 8, dropout 0.1, a trailing batch of 4 (four
    ranks hold no row of it): the port's single-device run."""
    ref = _small_trainer(None)
    ref.train(epochs=3, verbose=False)
    loop = _small_trainer(None)
    loop.train(epochs=1, verbose=False, scan_epoch=False)
    want = _history(ref)
    for r in _world(8, ["trainer"], {}):
        got = r["trainer"]
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=2e-5)
        assert got["train_acc"] == want["train_acc"]
        assert got["val_acc"] == want["val_acc"]
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, atol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(got["loop_train_loss"],
                                   loop.train_loss_history, rtol=2e-5)


def test_serve_mesh_once_matches_single_device(tmp_path):
    """One watch-folder pass of `python -m gat_tpu_torch.serve --mesh 2
    --batch 4 --once` (two ranks, each transcribing two of the wave's
    four files) writes the single-device pass's results."""
    from gat_tpu_torch.serve import main
    from gat_tpu_torch.utils.wavio import write_wav
    from emulated_kernels import RIFF_NOTES, pluck_riff
    src = tmp_path / "in"
    src.mkdir()
    for i in range(4):
        notes = [(0.4 + 0.7 * j, RIFF_NOTES[(i + j) % 5][1])
                 for j in range(3)]
        write_wav(src / f"riff{i}.wav", pluck_riff(22050, 2.6, notes),
                  22050)
    outs = {}
    for name, extra in (("single", []), ("mesh", ["--mesh", "2"])):
        outs[name] = tmp_path / name
        assert main(["--in_dir", str(src), "--out_dir", str(outs[name]),
                     "--once", "--batch", "4", "--device", "cpu"]
                    + extra) == 0
    names = sorted(p.name for p in outs["single"].glob("*.json"))
    assert names == [f"riff{i}.json" for i in range(4)]
    assert sorted(p.name for p in outs["mesh"].glob("*.json")) == names
    for n in names:
        a = json.loads((outs["single"] / n).read_text())
        b = json.loads((outs["mesh"] / n).read_text())
        assert len(a["labels"]) == 2  # the last pluck is dropped
        assert b["labels"] == a["labels"] and b["onsets_s"] == a["onsets_s"]
        assert b["yin"] == a["yin"]
        assert b["onset_overflow"] == a["onset_overflow"]
        np.testing.assert_allclose(b["confidences"], a["confidences"],
                                   atol=1e-5)


def _riff_folder(d, n: int):
    from gat_tpu_torch.utils.wavio import write_wav
    from emulated_kernels import RIFF_NOTES, pluck_riff
    d.mkdir()
    for i in range(n):
        notes = [(0.4 + 0.7 * j, RIFF_NOTES[(i + j) % 5][1])
                 for j in range(3)]
        write_wav(d / f"riff{i}.wav", pluck_riff(22050, 2.6, notes), 22050)
    return d


def _serve_with_fault(bad_rank: int, args, durs):
    """serve's rank body, with `transcribe_files` failing on one rank as
    a fault of that rank's card would, after the wave's broadcast."""
    import torch.distributed as dist
    from gat_tpu_torch import serve
    from gat_tpu_torch.infer import Transcriber
    if dist.get_rank() == bad_rank:
        def fail(self, paths, **kw):
            raise RuntimeError(f"card fault on rank {bad_rank}")
        Transcriber.transcribe_files = fail
    return serve._serve_rank(args, durs)


@pytest.mark.parametrize("bad_rank", [0, 1])
def test_serve_mesh_rank_fault_ends_the_world(tmp_path, monkeypatch,
                                              bad_rank):
    """`serve --mesh 2`, a rank whose wave fails while the other waits in
    the wave's collectives: the server ends well inside the deadline,
    naming that rank, and no rank is left running."""
    import time
    from gat_tpu_torch.parallel import launch
    from gat_tpu_torch.serve import main
    src = _riff_folder(tmp_path / "in", 2)
    real_spawn = launch.spawn

    def spawn(fn, world, *args, **kw):
        kw["timeout_s"] = 120
        return real_spawn(_serve_with_fault, world, bad_rank, *args, **kw)
    monkeypatch.setattr(launch, "spawn", spawn)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=rf"rank {bad_rank} of 2 failed"
                       rf"(.|\n)*card fault on rank {bad_rank}"):
        main(["--in_dir", str(src), "--out_dir", str(tmp_path / "out"),
              "--once", "--batch", "2", "--device", "cpu", "--mesh", "2"])
    assert time.monotonic() - t0 < 90


def test_serve_mesh_bad_file_falls_back_on_every_rank(tmp_path):
    """`serve --mesh 2 --once --batch 3` on a wave holding a file that
    does not decode: every rank raises for the wave before its first
    collective, rank 0 falls back to single files as the single-device
    server does, and the pass writes the single-device pass's results."""
    from gat_tpu_torch.serve import main
    src = _riff_folder(tmp_path / "in", 2)
    (src / "bad.wav").write_bytes(b"RIFF0000WAVEnot a wave file")
    outs = {}
    for name, extra in (("single", []), ("mesh", ["--mesh", "2"])):
        outs[name] = tmp_path / name
        assert main(["--in_dir", str(src), "--out_dir", str(outs[name]),
                     "--once", "--batch", "3", "--device", "cpu"]
                    + extra) == 0
    names = sorted(p.name for p in outs["single"].glob("*.json"))
    assert names == ["bad.json", "riff0.json", "riff1.json"]
    assert sorted(p.name for p in outs["mesh"].glob("*.json")) == names
    for n in names:
        a = json.loads((outs["single"] / n).read_text())
        b = json.loads((outs["mesh"] / n).read_text())
        assert sorted(a) == sorted(b)
        assert b.get("labels") == a.get("labels")
        assert b.get("error") == a.get("error")
    assert "error" in json.loads((outs["mesh"] / "bad.json").read_text())


def test_dryrun_multichip_world_4():
    from gat_tpu_torch.entry import dryrun_multichip
    line = dryrun_multichip(4, device="cpu")
    assert line.startswith("[dryrun_multichip] ok on 4 devices (cpu;")
    assert "model_parallel=2" in line and "== single-device" in line


def test_cnn_trainer_mesh_matches_single_device(world2):
    """Trainer(mesh=) of a CNN at world 2, dropout 0.1 after each block (the
    masks of channels-last activations), 8 steps: the global batch's
    BatchNorm statistics and dropout masks give the single-device run.
    Bounds: training losses rtol 2e-5, accuracies equal, weights atol
    1e-5; the conv biases ahead of BatchNorm (true gradient 0) take
    Adam's ±lr steps of either sign on each side (test_torch_train), so
    they are held to lr per step, 8e-3, the running means they move to
    1e-3, and the val losses, whose eval forward reads them, to rtol
    1e-3."""
    ref = _small_cnn_trainer(None)
    ref.train(epochs=2, verbose=False)
    want = _history(ref)
    for r in world2:
        got = r["cnn_trainer"]
        np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                                   rtol=2e-5)
        np.testing.assert_allclose(got["val_loss"], want["val_loss"],
                                   rtol=1e-3)
        assert got["train_acc"] == want["train_acc"]
        assert got["val_acc"] == want["val_acc"]
        for k, v in want["params"].items():
            if k.startswith("conv_") and k.endswith(".bias"):
                atol = 8e-3
            elif k.endswith("running_mean"):
                atol = 1e-3
            else:
                atol = 1e-5
            np.testing.assert_allclose(got["params"][k], v, atol=atol,
                                       rtol=1e-6, err_msg=k)


def test_mesh_checkpoint_is_the_single_device_one(world2, ckpt_dir, tmp_path):
    """Trainer(mesh=).save at world 2: rank 0 writes the one file, both
    ranks get its path, and it holds the single-device checkpoint's
    entries (weights within 1e-5 after an epoch); both packages load
    it."""
    from gat_tpu.train.checkpoint import load_checkpoint as jload
    from gat_tpu_torch.train.checkpoint import load_checkpoint
    from gat_tpu_torch.train.checkpoint import flatten_tree
    paths = {r["save"]["path"] for r in world2}
    assert paths == {str(ckpt_dir / "dp.gtckpt.npz")}
    assert sorted(p.name for p in ckpt_dir.iterdir()) == ["dp.gtckpt.npz"]
    ref = _small_trainer(None)
    ref.train(epochs=1, verbose=False)
    want = load_checkpoint(ref.save(filename="one.gtckpt.npz",
                                    root=tmp_path))
    got = load_checkpoint(paths.pop())
    assert sorted(got) == sorted(want)
    for key in ("variables", "opt_state"):
        a, b = flatten_tree(got[key]), flatten_tree(want[key])
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=1e-5,
                                       err_msg=k)
    for k in ("train_loss_history", "epoch", "reverse_map", "config"):
        if k == "train_loss_history":
            np.testing.assert_allclose(got[k], want[k], rtol=2e-5)
        else:
            assert got[k] == want[k]
    assert "variables" in jload(ckpt_dir / "dp.gtckpt.npz")
