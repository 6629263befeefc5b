"""Entry points of the port: the flagship clip-batch step at the shipped
checkpoints, the twin of `__graft_entry__.entry`, and the multi-device
dry run, the twin of `__graft_entry__.dryrun_multichip`.

`entry(batch, device)` returns (step, example_args): step(clips (N, L)) →
(ensemble probs (N, 47), YIN pitch (N,) Hz), where clips are 0.5 s at the
checkpoints' 11025 Hz. The YIN pitch of the raw clips feeds both the MLP's
pitch feature and the second output, so it is computed once.
"""
from __future__ import annotations

import numpy as np
import torch

from .infer.transcriber import Transcriber

__all__ = ["entry", "dryrun_multichip"]


def entry(batch: int = 32, device=None):
    """(step, (clips,)) on `device` (default the card)."""
    t = Transcriber(device=device)
    clip_len = int(t.ckpt_sr * t.clip_length)

    @torch.no_grad()
    def transcribe_step(clips: torch.Tensor):
        (probs, _, _), pitch = t.ensemble(clips, with_pitch=True)
        return probs, pitch

    rng = np.random.default_rng(0)
    clips = rng.normal(0, 0.1, (batch, clip_len)).astype(np.float32)
    return transcribe_step, (torch.from_numpy(clips).to(t.device),)


def _tone_files(b: int, sr: int) -> np.ndarray:
    """b files of 3 s: decaying tones at 110, 220 or 330 Hz, one a second."""
    tt = np.arange(3 * sr) / sr
    return np.stack([
        (0.4 * np.sin(2 * np.pi * (110.0 * (1 + i % 3)) * tt)
         * np.exp(-2.0 * ((tt - 0.5) % 1.0))).astype(np.float32)
        for i in range(b)])


def _dryrun_rank(n: int, device) -> str:
    """The dry run on one rank of a world of n; returns its summary."""
    import torch.distributed as dist

    from .infer import Transcriber
    from .models import CNN, MLP
    from .ops.onset import detect_onsets
    from .parallel import make_mesh, make_sharded_transcribe_files
    from .parallel.mesh import mesh_device
    from .parallel.pipeline import init_pipeline_params, pipeline_apply
    from .parallel.sharded import adamw, make_sharded_train_step
    from .parallel.timeshard import detect_onsets_timesharded
    from .train.data import ArrayDataLoader
    from .train.trainer import Trainer

    rng = np.random.default_rng(0)
    mesh = make_mesh(n, device=device)
    dev = mesh_device(mesh)

    # data-parallel CNN training through the Trainer
    cnn = CNN(num_classes=47, base_channels=8, num_blocks=2, hidden_dim=32)
    X = rng.normal(size=(4 * n, 16, 8, 1)).astype(np.float32)
    Y = rng.integers(0, 47, 4 * n).astype(np.int32)
    dl = ArrayDataLoader(X, Y, batch_size=2 * n, shuffle=False)
    trainer = Trainer(cnn, dl, reverse_map={i: f"c{i}" for i in range(47)},
                      model_type="cnn", mesh=mesh)
    trainer.train(epochs=1, verbose=False)
    loss = trainer.train_loss_history[-1]
    if not np.isfinite(loss):
        raise RuntimeError("CNN data-parallel Trainer epoch: loss not finite")
    p0 = next(cnn.parameters()).detach().reshape(-1)[:8]
    every = [torch.empty_like(p0) for _ in range(n)]
    dist.all_gather(every, p0.contiguous())
    if not all(torch.equal(e, p0) for e in every):
        raise RuntimeError("Trainer parameters differ between ranks")

    # tensor- and data-parallel MLP step
    mp = 2 if n % 2 == 0 and n >= 2 else 1
    mesh2 = make_mesh(n, model_parallel=mp, device=device)
    mlp = MLP(num_features=65, hidden_dim=32, num_hidden_layers=2,
              num_classes=47, dropout=0.0)
    xb2 = rng.normal(size=(2 * n, 65)).astype(np.float32)
    yb2 = rng.integers(0, 47, 2 * n)
    step, prepare = make_sharded_train_step(mlp, adamw(1e-3), mesh2,
                                            tp_mlp=mp > 1)
    state = prepare()
    loss2 = float(step(state, xb2, yb2))
    if not np.isfinite(loss2):
        raise RuntimeError("MLP tensor-parallel step: loss not finite")

    # pipeline stages over the model axis (every rank a stage)
    mesh3 = make_mesh(n, model_parallel=n, device=device)
    w, bias = (t.to(dev).requires_grad_() for t in
               init_pipeline_params(4, n, 16))
    xs = torch.from_numpy(rng.normal(size=(2 * n, 4, 16)).astype(
        np.float32)).to(dev)
    tgt = torch.from_numpy(rng.normal(size=xs.shape).astype(
        np.float32)).to(dev)
    pp_loss = torch.mean((pipeline_apply(w, bias, xs, mesh3) - tgt) ** 2)
    pp_loss.backward()
    pp_loss = pp_loss.detach()
    if not (torch.isfinite(pp_loss) and torch.isfinite(w.grad).all()
            and torch.isfinite(bias.grad).all()):
        raise RuntimeError("pipeline step not finite")

    # data-parallel file inference, through the sharded body and the
    # Transcriber the server builds
    sr = 22050
    t = Transcriber(require_cnn=False, mesh=mesh)
    b = n if n >= 4 else 2 * n
    ys = torch.from_numpy(_tone_files(b, sr)).to(dev)
    nv = torch.full((b,), 3 * sr, dtype=torch.int64, device=dev)
    outs = make_sharded_transcribe_files(t, mesh, sr, 0.5, 8)(ys, nv)
    probs_f, kept_f = outs[0], outs[4]
    if not bool(torch.isfinite(probs_f).all()):
        raise RuntimeError("data-parallel file inference: probs not finite")
    inf_clips = int(kept_f.sum())
    run_m, _ = t._files_fn(sr, 0.5, 8)
    if not torch.equal(run_m(ys, nv)[4], kept_f):
        raise RuntimeError("Transcriber(mesh=) differs from the sharded "
                           "file body")

    # time-sharded onsets against the single-device ones
    tt = np.arange(sr // 2) / sr
    ylong = np.zeros(12 * sr, np.float32)
    for i in range(10):
        s0 = int((0.4 + 1.1 * i) * sr)
        ylong[s0:s0 + sr // 2] += (0.5 * np.sin(2 * np.pi * 220.0 * tt)
                                   * np.exp(-4.0 * tt)).astype(np.float32)
    o_sp, v_sp, *_ = detect_onsets_timesharded(ylong, mesh, sr=sr)
    o_ref, v_ref, *_ = detect_onsets(torch.from_numpy(ylong)[None].to(dev),
                                     sr=sr, max_onsets=256)
    got, ref = o_sp[v_sp].cpu(), o_ref[0][v_ref[0]].cpu()
    if not torch.equal(got, ref):
        raise RuntimeError(f"time-sharded onsets {got.tolist()} differ from "
                           f"the single-device {ref.tolist()}")
    return (f"[dryrun_multichip] ok on {n} devices ({dev.type}; cnn dp "
            f"Trainer epoch loss {loss:.3f}, mlp tp x dp loss {loss2:.3f}, "
            f"model_parallel={mp}, pp {n}-stage loss {pp_loss.item():.3f}, "
            f"dp-inference clips {inf_clips} over {n} ranks, timeshard "
            f"onsets {len(got)} == single-device)")


def dryrun_multichip(n_devices: int, device=None) -> str:
    """The multi-device dry run over n_devices ranks on `device` (default
    the card, one rank per card; 'cpu' runs gloo ranks): a data-parallel
    CNN `Trainer` epoch, a tensor- and data-parallel MLP step, a pipeline
    step over n stages, data-parallel file inference through
    `Transcriber(mesh=)`, and time-sharded onsets equal to the
    single-device ones. Inside a world of n_devices ranks (torchrun,
    `parallel.launch.spawn`) every rank runs it; otherwise the ranks are
    started here. Prints and returns rank 0's summary line."""
    import torch.distributed as dist
    dev = "cuda" if device is None else str(device)
    if dist.is_initialized():
        line = _dryrun_rank(n_devices, dev)
        if dist.get_rank() == 0:
            print(line, flush=True)
        return line
    from .parallel.launch import spawn
    line = spawn(_dryrun_rank, n_devices, n_devices, dev, device=dev)[0]
    print(line, flush=True)
    return line
