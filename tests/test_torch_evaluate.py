"""The port's note-accuracy harness, `tools/torch_evaluate.py`, against
`tools/evaluate.py` on the CPU: the same synthesized sets through both
packages' Transcribers and witnesses.

Tolerances: per-system correct counts, disagreement counts, report keys,
accuracies, Wilson intervals and the printed confusion report identical;
the domain-shift |z| sums within 1e-3 relative (MFCC features within
1e-3 of each other, divided by the witness scaler's scale); per-clip
confidences of the folder harness within 1e-2 (the probs' bound in
tests/test_torch_slice.py), everything else of its report identical.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gat_tpu.infer import Transcriber as JTranscriber
from gat_tpu_torch.config import MLP_CONFIG
from gat_tpu_torch.infer import Transcriber
from gat_tpu_torch.utils.wavio import write_wav
from emulated_kernels import pluck_riff

TOOLS = Path(__file__).resolve().parent.parent / "tools"
WITNESS = MLP_CONFIG.CHECKPOINTS_DIR / MLP_CONFIG.REFERENCE_CKPT_NAME


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jeval = _tool("evaluate")
teval = _tool("torch_evaluate")


@pytest.fixture(scope="module")
def pair():
    return ((JTranscriber(), JTranscriber(mlp_ckpt=str(WITNESS),
                                          use_cnn=False)),
            (Transcriber(device="cpu"),
             Transcriber(mlp_ckpt=str(WITNESS), use_cnn=False,
                         device="cpu")))


def test_suites_and_intervals_equal():
    assert teval.FULL_SUITE == jeval.FULL_SUITE
    for c, n in ((0, 0), (0, 10), (7, 10), (376, 376), (373, 376), (1, 3)):
        assert teval.wilson_ci(c, n) == jeval.wilson_ci(c, n)


@pytest.mark.parametrize("name,variants", [("mixed", 2), ("fm_family", 1),
                                           ("modal_unseen_family", 1),
                                           ("pickup_eq", 1)])
def test_evaluate_set_matches(pair, tmp_path, name, variants):
    (jt, jw), (tt, tw) = pair
    kwargs = jeval.FULL_SUITE[name]
    ref = jeval.evaluate_set(jt, tmp_path / "j", variants, 777, witness=jw,
                             **dict(kwargs))
    got = teval.evaluate_set(tt, tmp_path / "t", variants, 777, witness=tw,
                             **dict(kwargs))
    assert got.keys() == ref.keys()
    assert got["_correct"] == ref["_correct"]
    assert got["_disagree"] == ref["_disagree"]
    assert got["_labels"] == ref["_labels"]
    for k, v in ref.items():
        if not k.startswith("_"):
            assert got[k] == v, k
    assert got["_domain_z"]["n"] == ref["_domain_z"]["n"]
    np.testing.assert_allclose(got["_domain_z"]["sum_abs"],
                               ref["_domain_z"]["sum_abs"], rtol=1e-3)
    assert got["_result"]["labels"] == ref["_result"]["labels"]


def test_evaluate_set_stages(pair, tmp_path):
    """The optional StageTimer sees synthesis and loading apart from the
    card's work."""
    from gat_tpu_torch.utils.profiling import StageTimer
    (_, _), (tt, tw) = pair
    timer = StageTimer()
    teval.evaluate_set(tt, tmp_path / "t", 1, 5, witness=tw, timer=timer)
    assert set(timer.totals) == {"synthesis", "load", "transcribe_clips",
                                 "yin", "witness", "domain_z"}
    assert all(v == 1 for v in timer.counts.values())


def _wav_dir(root: Path) -> Path:
    """SPN-named folders of riffs of one note, one unlabeled riff and one
    silent file (which no clip survives)."""
    notes = {"A2": 110.0, "D3": 146.83, "G3": 196.0}
    for i, (label, f) in enumerate(notes.items()):
        (root / label).mkdir(parents=True)
        y = pluck_riff(44100 if i else 22050, 3.0,
                       ((0.4, f), (1.1, f), (1.8, f), (2.4, f)))
        write_wav(root / label / f"{label}.wav", y, 44100 if i else 22050)
    (root / "mixed").mkdir()
    write_wav(root / "mixed" / "riff.wav", pluck_riff(22050, 3.9), 22050)
    write_wav(root / "mixed" / "silent.wav", np.zeros(22050, np.float32),
              22050)
    return root


def test_evaluate_wav_dir_matches(pair, tmp_path):
    (jt, _), (tt, _) = pair
    d = _wav_dir(tmp_path / "wavs")
    ref = jeval.evaluate_wav_dir(jt, d)
    got = teval.evaluate_wav_dir(tt, d)
    assert got.keys() == ref.keys()
    for k in ref:
        if k != "files":
            assert got[k] == ref[k], k
    assert ref["n_labeled_clips"] == 9 and ref["folder_label_accuracy"] == 1
    for g, r in zip(got["files"], ref["files"], strict=True):
        assert g.keys() == r.keys()
        if "error" in r:
            assert g == r
            continue
        for gc, rc in zip(g["clips"], r["clips"], strict=True):
            assert abs(gc.pop("confidence") - rc.pop("confidence")) <= 1e-2
            assert gc == rc
        assert {k: v for k, v in g.items() if k != "clips"} == \
            {k: v for k, v in r.items() if k != "clips"}


def test_main_quick_matches(tmp_path, capsys, monkeypatch):
    """Both tools' `main` on the quick suite: the same report JSON (but
    the wall time) and the same printed confusion report."""
    monkeypatch.setattr("sys.argv", ["evaluate.py", "--variants", "1",
                                     "--platform", "cpu", "--out",
                                     str(tmp_path / "j.json")])
    jeval.main()
    ref_out = capsys.readouterr().out
    teval.main(["--variants", "1", "--device", "cpu", "--out",
                str(tmp_path / "t.json")])
    got_out = capsys.readouterr().out
    ref, got = (json.loads((tmp_path / f"{s}.json").read_text())
                for s in "jt")
    ref.pop("wall_s"), got.pop("wall_s")
    assert got == ref
    assert (got_out[got_out.index("precision"):]
            == ref_out[ref_out.index("precision"):])


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        teval.main(["--variants", "1"])
