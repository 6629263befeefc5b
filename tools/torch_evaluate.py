#!/usr/bin/env python
"""Note-accuracy evaluation harness of the PyTorch port, the twin of
`tools/evaluate.py`: the same suites, columns and reports, computed by
`gat_tpu_torch` on a CUDA card (`--device cuda`, the default) or on the
CPU (`--device cpu`, the plain PyTorch versions of the kernels).

Synthesizes held-out evaluation sets (a seed other than training's), runs
the shipped ensemble, each model alone and the YIN baseline over them,
and reports per-system accuracy, the witness columns (a second
Transcriber around the imported reference MLP), the disagreement
breakdown, the domain-shift z-scores under the witness's scaler, and the
confusion report over the first set.

Two suites:
  quick — one mixed-family set.
  full  — per-family sets (the FM family and the modal renderer were
          never trained on) plus playing-style and acquisition-chain
          stressor sets.

Usage: python tools/torch_evaluate.py [--variants 8] [--seed 777]
       [--suite quick|full] [--device cuda|cpu] [--out report.json]
       [--wav_dir DIR]
"""
import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

# evaluation sets for --suite full: name → synthesize_note_dataset kwargs
# ("renderer": "modal" routes to the eval-only modal engine,
# gat_tpu_torch/data/modal.py; "channel" keys are acquisition-chain
# stressors, gat_tpu_torch/data/channel.py). The shipped models train on
# family=all3 (KS+FM+additive), so `modal` is the held-out family.
FULL_SUITE = {
    "mixed": {},
    "ks_only": {"family": "ks"},
    "additive_only": {"family": "additive"},
    "fm_family": {"family": "fm"},
    "modal_unseen_family": {"renderer": "modal"},
    "vibrato": {"stressor": "vibrato"},
    "pitch_bend": {"stressor": "bend"},
    "detune_25c": {"stressor": "detune"},
    "tremolo": {"stressor": "tremolo"},
    "palm_mute": {"stressor": "palm_mute"},
    "fm_vibrato": {"family": "fm", "stressor": "vibrato"},
    "modal_vibrato": {"renderer": "modal", "stressor": "vibrato"},
    "room_ir": {"channel": "room_ir"},
    "pickup_eq": {"channel": "pickup_eq"},
    "bg_noise": {"channel": "bg_noise"},
    "modal_full_chain": {"renderer": "modal", "channel": "full_chain"},
}


def wilson_ci(correct: int, n: int, z: float = 1.96) -> list[float]:
    """95% Wilson score interval for a binomial proportion."""
    import math
    if n == 0:
        return [0.0, 1.0]
    p = correct / n
    denom = 1.0 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
    return [round(max(0.0, center - half), 4),
            round(min(1.0, center + half), 4)]


def evaluate_set(transcriber, root, variants: int, seed: int,
                 witness=None, timer=None, **synth_kwargs) -> dict:
    """Synthesize one eval set and score every system on it.

    `witness` (a second Transcriber around the imported reference MLP,
    mlp_v1.0.0.gtckpt.npz) adds the witness's accuracy on the set, how
    often the default and the witness agree clip by clip, the breakdown
    of their disagreements and the set's MFCC features as z-scores under
    the witness's real-recording scaler. `timer` (a
    `gat_tpu_torch.utils.profiling.StageTimer`) accumulates the stages:
    synthesis and loading on the host, then the card's work, each stage
    waited for."""
    import numpy as np
    import torch
    from gat_tpu_torch.data.loader import AudioDatasetLoader
    from gat_tpu_torch.data.modal import render_modal_dataset
    from gat_tpu_torch.data.synth import synthesize_note_dataset
    from gat_tpu_torch.infer.predictor import (apply_pitch_prior,
                                               class_midi_values)
    from gat_tpu_torch.ops.pitch import note_to_midi
    from gat_tpu_torch.ops.yin import estimate_note, yin_pitch
    from gat_tpu_torch.utils.profiling import StageTimer

    timer = timer or StageTimer()
    dev = transcriber.device
    renderer = synth_kwargs.pop("renderer", "synth")
    with timer.stage("synthesis"):
        if renderer == "modal":
            render_modal_dataset(root, variants_per_class=variants,
                                 seed=seed, **synth_kwargs)
        else:
            synthesize_note_dataset(root, variants_per_class=variants,
                                    seed=seed, verbose=False, **synth_kwargs)
    with timer.stage("load", block_on=lambda: clips):
        loader = AudioDatasetLoader([root], target_sr=transcriber.ckpt_sr,
                                    duration=transcriber.clip_length,
                                    device=dev)
        wavs, _, labels, _ = loader.load_audio_dataset(pad_to_max=True)
        clips = torch.from_numpy(np.stack(wavs)).to(dev)
    n = len(labels)

    with timer.stage("transcribe_clips"):
        result = transcriber.transcribe_clips(clips)
    rm = transcriber.predictor.reverse_map
    name_to_idx = {v: k for k, v in rm.items()}
    y_map = np.asarray([name_to_idx[l] for l in labels])

    correct: dict[str, int] = {}

    def acc(key, p):
        if p is None:
            correct[key] = None
            return None
        k = int((p.argmax(axis=1) == y_map).sum())
        correct[key] = k
        return round(k / n, 4)

    with timer.stage("yin", block_on=lambda: yin_dev):
        yin_dev = yin_pitch(clips, transcriber.ckpt_sr)
    yin_hz = yin_dev.cpu().numpy()
    yin_names = [estimate_note(h, unicode=False)[1] for h in yin_hz]
    correct["yin"] = int(sum(a == b for a, b in zip(yin_names, labels)))

    # three ensemble columns, computed explicitly so they stay distinct
    # whatever the shipped default is: `default` = what a bare
    # Transcriber returns; `blend` = the 0.2/0.8 softmax blend alone;
    # `prior` = blend + YIN pitch prior.
    mlp_p = result["per_model_probs"]["mlp"]
    cnn_p = result["per_model_probs"]["cnn"]
    w = transcriber.predictor.cnn_weight
    blend = ((1.0 - w) * mlp_p + w * cnn_p if cnn_p is not None
             else mlp_p)
    prior_probs = apply_pitch_prior(
        torch.from_numpy(np.asarray(blend, np.float32)),
        torch.from_numpy(yin_hz), class_midi_values(rm)).numpy()

    out = {
        "n_clips": n,
        "default_accuracy": acc("default", result["probs"]),
        "ensemble_accuracy": acc("ensemble", blend),
        "ensemble_prior_accuracy": acc("ensemble_prior", prior_probs),
        "mlp_accuracy": acc("mlp", mlp_p),
        "cnn_accuracy": acc("cnn", cnn_p),
        "yin_accuracy": round(correct["yin"] / n, 4),
        "_result": result,
        "_labels": labels,
    }

    if witness is not None:
        if witness.ckpt_sr != transcriber.ckpt_sr:
            raise ValueError("witness/transcriber sample-rate mismatch: "
                             f"{witness.ckpt_sr} vs {transcriber.ckpt_sr}")
        with timer.stage("witness"):
            wres = witness.transcribe_clips(clips)
        wrm = witness.predictor.reverse_map
        w_names = [wrm[int(i)] for i in wres["probs"].argmax(axis=1)]
        d_names = [rm[int(i)] for i in result["probs"].argmax(axis=1)]
        correct["witness"] = int(sum(a == b
                                     for a, b in zip(w_names, labels)))
        correct["agreement"] = int(sum(a == b
                                       for a, b in zip(w_names, d_names)))
        out["witness_accuracy"] = round(correct["witness"] / n, 4)
        out["witness_agreement"] = round(correct["agreement"] / n, 4)
        # every default-vs-witness split by interval class (octave slips,
        # exactly one semitone, anything else) and by who matched the label
        dis = {"octave": 0, "semitone": 0, "other": 0,
               "default_correct": 0, "witness_correct": 0, "neither": 0}
        for dn, wn, lab in zip(d_names, w_names, labels):
            if dn == wn:
                continue
            delta = abs(note_to_midi(dn) - note_to_midi(wn))
            dis["octave" if delta % 12 == 0
                else ("semitone" if delta == 1 else "other")] += 1
            dis["default_correct" if dn == lab
                else ("witness_correct" if wn == lab else "neither")] += 1
        out["_disagree"] = dis
        # the set's unscaled 65-dim features as z-scores under the scaler
        # the reference fitted on real recordings
        if witness.scaler is not None:
            mfcc_params = witness.model_configs["mlp"]["features"]["params"]
            with timer.stage("domain_z", block_on=lambda: mf):
                mf, _ = witness.feature_builder \
                    .extract_inference_features_from_clips(
                        clips, witness.ckpt_sr, mfcc_params, None,
                        scaler=None)
            z = witness.scaler.transform(mf).cpu().numpy()
            out["_domain_z"] = {"sum_abs": np.abs(z).sum(axis=0),
                                "n_gt3": (np.abs(z) > 3.0).sum(axis=0),
                                "n": z.shape[0]}

    out["_correct"] = correct
    return out


def evaluate_wav_dir(transcriber, wav_dir: Path) -> dict:
    """Transcribe every .wav under `wav_dir` and report, per clip, the
    ensemble label next to the YIN baseline note; no ground-truth labels
    needed. Files in SPN-label-named folders (the dataset layout) add
    folder-name accuracy."""
    paths = sorted(Path(wav_dir).rglob("*.wav"))
    if not paths:
        raise FileNotFoundError(f"no .wav files under {wav_dir}")
    known = set(transcriber.predictor.reverse_map.values()) \
        if transcriber.predictor.reverse_map else set()
    files, agree, total, correct, labeled = [], 0, 0, 0, 0
    for p in paths:
        try:
            res = transcriber.transcribe(str(p))
        except ValueError as e:  # no clips survived slicing
            files.append({"file": str(p), "error": str(e)})
            continue
        yin_notes = [info["note_name"] for _, info in res["dsp_info"]]
        rows = list(zip(res["labels"],
                        [round(float(c), 3) for c in res["confidences"]],
                        yin_notes, res.get("onsets_s", [])))
        folder = p.parent.name
        entry = {"file": str(p), "n_clips": len(rows),
                 "clips": [{"label": l, "confidence": c, "yin": y,
                            "onset_s": round(float(o), 3)}
                           for l, c, y, o in rows]}
        agree += sum(l == y for l, c, y, o in rows)
        total += len(rows)
        if folder in known:
            labeled += len(rows)
            correct += sum(l == folder for l, c, y, o in rows)
            entry["folder_label"] = folder
        files.append(entry)
        print(f"[evaluate --wav_dir] {p.name}: "
              + "  ".join(f"{l}({c:.2f})|yin:{y}" for l, c, y, _ in rows))
    report = {"wav_dir": str(wav_dir), "n_files": len(paths),
              "n_clips": total,
              "yin_agreement": round(agree / max(total, 1), 4),
              "files": files}
    if labeled:
        report["folder_label_accuracy"] = round(correct / labeled, 4)
        report["n_labeled_clips"] = labeled
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", type=int, default=8)
    ap.add_argument("--seed", type=int, default=777)  # != training seed
    ap.add_argument("--seeds", type=int, default=1,
                    help="evaluate each row over this many disjoint eval "
                         "seeds (seed, seed+1000, ...) and aggregate; "
                         "binomial 95%% CIs are reported either way "
                         "(>=3 recommended for the full suite)")
    ap.add_argument("--no_witness", action="store_true",
                    help="skip the witness columns (the imported "
                         "real-recording-trained reference MLP)")
    ap.add_argument("--witness_ckpt", default="mlp_v1.0.0.gtckpt.npz",
                    help="checkpoint for the witness Transcriber")
    ap.add_argument("--suite", default="quick", choices=["quick", "full"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the default) needs a card and raises "
                         "without one; cpu runs the plain PyTorch path")
    ap.add_argument("--out", type=Path, default=None,
                    help="optional JSON report path")
    ap.add_argument("--wav_dir", type=Path, default=None,
                    help="BYO recordings: transcribe every .wav under "
                         "this dir, report ensemble-vs-YIN agreement "
                         "(and accuracy when folders are SPN labels)")
    ap.add_argument("--mlp_ckpt", default=None)
    ap.add_argument("--cnn_ckpt", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import tempfile
    from gat_tpu_torch.infer import Transcriber
    from gat_tpu_torch.train.metrics import classification_report

    tmp = Path(tempfile.mkdtemp())
    t0 = time.time()
    t = Transcriber(mlp_ckpt=args.mlp_ckpt, cnn_ckpt=args.cnn_ckpt,
                    device=args.device)

    if args.wav_dir is not None:
        report = evaluate_wav_dir(t, args.wav_dir)
        report["wall_s"] = round(time.time() - t0, 1)
        print(json.dumps({k: v for k, v in report.items()
                          if k != "files"}, indent=2))
        if args.out:
            args.out.write_text(json.dumps(report, indent=2))
        return report

    witness = None
    if not args.no_witness:
        from gat_tpu_torch.config import MLP_CONFIG
        wpath = Path(args.witness_ckpt)
        if not wpath.is_file():
            wpath = MLP_CONFIG.CHECKPOINTS_DIR / args.witness_ckpt
        if wpath.is_file():
            witness = Transcriber(mlp_ckpt=str(wpath), use_cnn=False,
                                  device=args.device)
        else:
            print(f"[evaluate] witness checkpoint {args.witness_ckpt} not "
                  "found — skipping sim-to-real columns")

    sets = {"mixed": {}} if args.suite == "quick" else FULL_SUITE
    report = {"suite": args.suite, "eval_seed": args.seed,
              "n_seeds": args.seeds, "variants": args.variants,
              "witness": (str(args.witness_ckpt) if witness else None),
              "sets": {}}
    base = None
    for name, kwargs in sets.items():
        # per-seed sets are disjoint draws (seed, seed+1000, ...);
        # correct counts aggregate so each row's CI reflects the full N
        agg: dict[str, int] = {}
        n_total = 0
        seed_res = []
        dis_agg: dict[str, int] = {}
        z_agg: dict | None = None
        for s in range(args.seeds):
            res = evaluate_set(t, tmp / f"{name}_s{s}", args.variants,
                               args.seed + 1000 * s, witness=witness,
                               **dict(kwargs))
            seed_res.append(res)
            n_total += res["n_clips"]
            for k, v in res["_correct"].items():
                if v is not None:
                    agg[k] = agg.get(k, 0) + v
            for k, v in res.get("_disagree", {}).items():
                dis_agg[k] = dis_agg.get(k, 0) + v
            dz = res.get("_domain_z")
            if dz is not None:
                if z_agg is None:
                    z_agg = {k: dz[k].copy() if hasattr(dz[k], "copy")
                             else dz[k] for k in dz}
                else:
                    for k in dz:
                        z_agg[k] = z_agg[k] + dz[k]
        if base is None:
            # confusion-report basis: all seeds of the first set, the same
            # N as its headline row
            base = {"_labels": [l for r in seed_res
                                for l in r["_labels"]],
                    "probs": np.concatenate(
                        [r["_result"]["probs"] for r in seed_res])}
        row = {"n_clips": n_total}
        for k, v in agg.items():
            # "agreement" pairs with the witness: point estimate and CI
            # share one stem (witness_agreement / witness_agreement_ci95)
            stem = "witness_agreement" if k == "agreement" else k
            row[f"{stem}_accuracy" if k != "agreement"
                else stem] = round(v / n_total, 4)
            row[f"{stem}_ci95"] = wilson_ci(v, n_total)
        if dis_agg:
            dis_agg["n_disagreements"] = (dis_agg.get("octave", 0)
                                          + dis_agg.get("semitone", 0)
                                          + dis_agg.get("other", 0))
            row["witness_disagreement"] = dis_agg
        if z_agg is not None:
            # per-dim mean |z| under the real-data scaler; dim 64 is the
            # appended log10-pitch feature, 0..63 the MFCC means
            mean_abs = z_agg["sum_abs"] / max(z_agg["n"], 1)
            order = np.argsort(mean_abs)[::-1][:5]
            row["domain_shift"] = {
                "mean_abs_z": round(float(mean_abs.mean()), 3),
                "frac_gt3": round(float(z_agg["n_gt3"].sum())
                                  / max(z_agg["n"] * mean_abs.size, 1), 4),
                "top_dims": [[int(d), round(float(mean_abs[d]), 2)]
                             for d in order],
            }
        report["sets"][name] = row
        ci = row["default_ci95"]
        wcol = (f"wit={row['witness_accuracy']:.4f} "
                f"agree={row['witness_agreement']:.4f} "
                if "witness_accuracy" in row else "")
        print(f"[evaluate] {name:20s} def={row['default_accuracy']:.4f} "
              f"ci95=[{ci[0]:.4f},{ci[1]:.4f}] "
              f"ens={row['ensemble_accuracy']:.4f} "
              f"mlp={row['mlp_accuracy']:.4f} "
              f"cnn={row['cnn_accuracy']:.4f} "
              f"yin={row['yin_accuracy']:.4f} {wcol}(n={n_total})")
        if "witness_disagreement" in row and "domain_shift" in row:
            d, z = row["witness_disagreement"], row["domain_shift"]
            print(f"[evaluate] {'':20s} disagree: oct={d['octave']} "
                  f"semi={d['semitone']} other={d['other']} "
                  f"(def✓={d['default_correct']} wit✓={d['witness_correct']}"
                  f" neither={d['neither']})  |z|={z['mean_abs_z']:.2f} "
                  f"P(|z|>3)={z['frac_gt3']:.4f}")
    report["wall_s"] = round(time.time() - t0, 1)
    print(json.dumps(report, indent=2))

    # confusion detail for the base (mixed) set, over all eval seeds
    labels = base["_labels"]
    classes = sorted(set(labels))
    y_true = np.asarray([classes.index(l) for l in labels])
    rm = t.predictor.reverse_map
    preds = base["probs"].argmax(axis=1)
    pred_names = [rm[int(i)] for i in preds]
    y_pred = np.asarray([classes.index(n) if n in classes else -1
                         for n in pred_names])
    # out-of-set predictions are excluded, not remapped: scoring them as
    # class 0 would put confusion mass in the first class's row
    known = y_pred >= 0
    n_unknown = int((~known).sum())
    if n_unknown:
        print(f"[evaluate] {n_unknown} predictions outside the eval "
              f"set's classes (excluded from the confusion report)")
    print(classification_report(y_true[known], y_pred[known], classes))
    if args.out:
        args.out.write_text(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
