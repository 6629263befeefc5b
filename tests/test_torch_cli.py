"""The port's CLI, `gat_tpu_torch/cli.py`, run in-process with
`--device cpu` against `gat_tpu.cli.main` on the same WAV files: the same
result files, indices and labels, confidences within 1e-2 (the ensemble's
float32 sums in another order), parsed from the `--save_results` files;
and its error paths."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gat_tpu import cli as jcli
from gat_tpu_torch import cli
from gat_tpu_torch.utils.wavio import write_wav
from emulated_kernels import RIFF_NOTES, pluck_riff

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """a: A2 D3 G3 B3 E4 over 3.9 s at 22050 Hz; b: three plucks over
    2.6 s at 44100 Hz; one/take and two/take: the same stem in two
    directories."""
    d = tmp_path_factory.mktemp("wavs")
    (d / "one").mkdir()
    (d / "two").mkdir()
    files = {"a": (d / "a.wav", pluck_riff(22050, 3.9), 22050),
             "b": (d / "b.wav", pluck_riff(44100, 2.6, RIFF_NOTES[:3]),
                   44100),
             "one": (d / "one" / "take.wav",
                     pluck_riff(22050, 2.6, RIFF_NOTES[1:4]), 22050),
             "two": (d / "two" / "take.wav",
                     pluck_riff(22050, 3.3, RIFF_NOTES[:4]), 22050)}
    for path, y, sr in files.values():
        write_wav(path, y, sr)
    return {k: str(v[0]) for k, v in files.items()}


def _run_both(tmp_path, args):
    """Both CLIs on `args`, each writing into its own directory."""
    out = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        out[name] = tmp_path / name
        assert main(args + ["--out", str(out[name])] + extra) == 0
    return out["jax"], out["port"]


def _results(path: Path) -> list[list[str]]:
    """The comma-separated rows of a results file, up to its blank line."""
    rows = []
    for line in path.read_text().splitlines():
        if not line:
            break
        rows.append(line.split(","))
    return rows


def _same_rows(got, ref, value_cols) -> None:
    """Rows equal but for the numeric columns `value_cols`, which agree
    within 1e-2."""
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        keep = [i for i in range(len(r)) if i not in value_cols]
        assert [g[i] for i in keep] == [r[i] for i in keep]
        for i in value_cols:
            assert abs(float(g[i]) - float(r[i])) <= 1e-2


CASES = {
    "one_wav": (["a"], []),
    "two_wavs": (["a", "b"], []),
    "same_stem": (["one", "two"], []),
    "stream": (["a"], ["--stream"]),
    "mlp": (["a"], ["--model", "mlp"]),
    "save_clips": (["a"], ["--save_clips"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax(wavs, tmp_path, case):
    names, flags = CASES[case]
    jax_dir, port_dir = _run_both(
        tmp_path, ["--audio", *[wavs[n] for n in names], "--save_results",
                   *flags])
    files = sorted(p.name for p in port_dir.glob("*.txt"))
    assert files == sorted(p.name for p in jax_dir.glob("*.txt"))
    assert len(files) == len(names)
    for name in files:
        # (index or onset, label, confidence) per note
        _same_rows(_results(port_dir / name), _results(jax_dir / name),
                   value_cols=[2])
    if case == "same_stem":
        assert files == ["take_1_transcription.txt", "take_transcription.txt"]
    if case == "stream":
        assert files == ["a_stream_transcription.txt"]
        assert [r[1] for r in _results(port_dir / files[0])] == [
            "A2", "D3", "G3", "B3", "E4"]
    if case == "save_clips":
        clips = sorted(p.name for p in port_dir.rglob("*.wav"))
        assert clips and clips == sorted(
            p.name for p in jax_dir.rglob("*.wav"))


def test_missing_audio_fails_before_checkpoints_load(tmp_path, monkeypatch):
    import gat_tpu_torch.infer as infer

    def never(*a, **kw):
        raise AssertionError("the checkpoints loaded before the path check")
    monkeypatch.setattr(infer, "Transcriber", never)
    with pytest.raises(FileNotFoundError, match="not found"):
        cli.main(["--audio", str(tmp_path / "missing.wav"), "--device",
                  "cpu"])


def test_not_a_wav_is_refused(tmp_path, monkeypatch):
    import gat_tpu_torch.infer as infer
    monkeypatch.setattr(infer, "Transcriber", None)
    path = tmp_path / "notes.txt"
    path.write_text("not audio")
    with pytest.raises(ValueError, match=r"\.wav"):
        cli.main(["--audio", str(path), "--device", "cpu"])


def test_live_with_stream_is_a_parser_error(capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--live", "--stream", "--device", "cpu"])
    assert exc.value.code == 2
    assert "mutually exclusive" in capsys.readouterr().err


def test_no_cpu_without_device_flag(wavs):
    """Without --device the Transcriber goes to the card; with no card it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--audio", wavs["a"]])


def test_module_entry_point():
    out = subprocess.run([sys.executable, "-m", "gat_tpu_torch.cli",
                          "--version"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "gat_tpu_torch 1.0.0"

