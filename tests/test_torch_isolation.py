"""The PyTorch port stands alone: it and its tools (`tools/torch_*.py`)
import nothing of JAX, of the JAX package or of sklearn (the H100
installation has none), matplotlib only inside a function, its entry
points never fall back to the CPU on their own, and its CUDA kernels are
built at first launch, never at import."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gat_tpu_torch import features, kernels
from gat_tpu_torch.ops import onset, yin

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gat_tpu", "sklearn")
PORT_FILES = sorted((REPO / "gat_tpu_torch").rglob("*.py")) + sorted(
    (REPO / "tools").glob("torch_*.py")) + [REPO / "chip_smoke.py"]
# (wrapper, its plain version, the arguments after the tensor)
WRAPPERS = [(features.melspec_features, features.melspec_features_plain,
             (11025,)),
            (onset.onset_mel_db, onset.onset_mel_db_plain, (22050,)),
            (features.mfcc_frontend, features.mfcc_frontend_plain, (11025,)),
            (yin.yin_pitch, yin.yin_pitch_plain, (11025,)),
            (onset.onset_strength, onset.onset_strength_plain, (22050,)),
            (onset.pick_onsets, onset.pick_onsets_plain,
             (22050, 512, 0.3, 64))]


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_gat_tpu_import(path):
    for name in _imported_modules(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {name}"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_matplotlib_only_inside_functions(path):
    """matplotlib (not in the H100 installation) is imported only where a
    plot is drawn, so every module imports without it."""
    tree = ast.parse(path.read_text(), str(path))
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    for node in top:
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""])
        assert all(n.split(".")[0] != "matplotlib" for n in names), path.name


def test_port_imports_with_jax_blocked():
    """Every port module imports with jax, flax, optax, sklearn and
    gat_tpu made unimportable, in a fresh interpreter."""
    mods = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in (REPO / "gat_tpu_torch").rglob("*.py"))
    code = ("import sys\n"
            f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _run_blocked(code: str) -> str:
    """`code` in a fresh interpreter with jax, flax, optax, sklearn and
    gat_tpu made unimportable; returns its standard output."""
    pre = f"import sys\nfor m in {FORBIDDEN!r}: sys.modules[m] = None\n"
    out = subprocess.run([sys.executable, "-c", pre + code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_lazy_top_level_names_resolve_without_jax():
    out = _run_blocked(
        "import gat_tpu_torch\n"
        "print(sorted(type(getattr(gat_tpu_torch, n)).__name__\n"
        "             for n in gat_tpu_torch._LAZY))\n")
    assert out == str(["type"] * 11)


def test_torch_tools_import_without_jax():
    names = tuple(p.stem for p in sorted((REPO / "tools").glob("torch_*.py")))
    assert len(names) == 12  # with torch_numpy_reference_pipeline
    out = _run_blocked(
        "import importlib.util\n"
        f"for name in {names!r}:\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        name, f'tools/{name}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print('ok')\n")
    assert out == "ok"


def test_reference_checkpoint_loads_without_sklearn(tmp_path):
    """A reference checkpoint holding a fitted sklearn StandardScaler,
    written here where sklearn is installed, loads where it is not."""
    from sklearn.preprocessing import StandardScaler
    x = np.random.default_rng(0).normal(size=(20, 3))
    torch.save({"scaler": StandardScaler().fit(x), "epoch": 3},
               tmp_path / "r.ckpt")
    out = _run_blocked(
        "from gat_tpu_torch.models.torch_import import load_reference_ckpt\n"
        f"ck = load_reference_ckpt({str(tmp_path / 'r.ckpt')!r})\n"
        "print(type(ck['scaler']).__name__, list(ck['scaler'].mean_.round(6)),"
        " 'sklearn' in sys.modules and sys.modules['sklearn'] is not None)\n")
    assert out == (f"ReferenceScaler {list(x.mean(0).round(6))} False")


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from gat_tpu_torch.entry import entry
    from gat_tpu_torch.infer import NotePredictor, Transcriber
    for make in (Transcriber, lambda: Transcriber(device="cuda"),
                 NotePredictor, entry):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    # the tools' twins: --device cuda is their default
    import importlib.util

    def tool(name):
        spec = importlib.util.spec_from_file_location(
            f"_refuse_{name}", REPO / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    d = str(REPO / "tools")  # any existing path: nothing is read
    calls = [("torch_dataset_creator", ["slice-all", "--raw", d,
                                        "--clips", d]),
             ("torch_eda", ["dataset", "--root", d]),
             ("torch_eda", ["slices", "--audio", d]),
             ("torch_eda", ["features", "--root", d]),
             ("torch_cross_family_eval", []),
             ("torch_train_wall", []),
             ("torch_profile_trace", ["--graph", "clip"]),
             ("torch_profile_trace", ["--graph", "files"]),
             ("torch_roofline_files", []),
             ("torch_evaluate", []),
             ("torch_serve", ["--in_dir", d, "--out_dir", d, "--once"]),
             ("torch_train_synthetic", ["--model", "mlp"]),
             ("torch_serve", ["--in_dir", d, "--out_dir", d, "--once",
                              "--mesh", "2"]),
             ("torch_train_synthetic", ["--model", "mlp", "--mesh", "2"])]
    for name, argv in calls:
        for extra in ([], ["--device", "cuda"]):
            with pytest.raises(RuntimeError, match="CUDA"):
                tool(name).main(argv + extra)


def test_multi_device_refuses_cuda_without_a_card():
    """The mesh, the launcher and the dry run ask for the card by default
    and raise without one, before any rank starts; `--mesh` of the
    server and the trainer likewise (above)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from gat_tpu_torch.entry import dryrun_multichip
    from gat_tpu_torch.parallel import launch, make_mesh
    from gat_tpu_torch.parallel.mesh import make_mesh as mesh_make_mesh
    assert make_mesh is mesh_make_mesh
    for call in (make_mesh, lambda: make_mesh(1, device="cuda"),
                 lambda: launch.spawn(print, 2),
                 lambda: launch.spawn(print, 1, device="cuda"),
                 lambda: dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_kernels_not_built_at_import():
    assert kernels._libs == {}
    assert kernels.KERNELS == ("melspec_frontend", "mfcc_frontend",
                               "yin_pitch", "onset_envelope", "onset_pick",
                               "mfcc_pitch_frontend", "noise_gate",
                               "slice_clips", "resample", "wave_compact",
                               "softmax_xent", "clip_adamw",
                               "batchnorm_train")
    for name in kernels.KERNELS:
        assert (kernels.CSRC / f"{name}.cu").is_file()


def test_build_needs_nvcc(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(kernels, "KERNEL_BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()
    assert list(tmp_path.iterdir()) == []


def test_library_name_follows_sources(monkeypatch, tmp_path):
    """An edited source gets a new library file, so it is rebuilt."""
    for src in kernels.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    before = {n: kernels._library_path(n) for n in kernels.KERNELS}
    (tmp_path / "dsp_common.cuh").write_text(
        (tmp_path / "dsp_common.cuh").read_text() + "\n// edit\n")
    after = {n: kernels._library_path(n) for n in kernels.KERNELS}
    assert all(before[n] != after[n] for n in kernels.KERNELS)
    assert len(set(after.values())) == len(kernels.KERNELS)


def test_check_input_refuses_what_the_kernels_do_not_take():
    x = torch.zeros(3, 5512)
    kernels.check_input(x, "k")
    for bad, what in ((x.double(), "float32"), (x[0], "float32"),
                      (x.t().contiguous().t(), "contiguous")):
        with pytest.raises(ValueError, match=what):
            kernels.check_input(bad, "k")


def test_check_raises_on_cuda_error():
    kernels.check(0, "x")
    with pytest.raises(RuntimeError, match="cudaError 1"):
        kernels.check(1, "x")


WRAPPER_PARAMS = [pytest.param(w, p, a, id=f"{w.__name__}-{p.__name__}")
                  for w, p, a in WRAPPERS]


@pytest.mark.parametrize("wrapper,plain,args", WRAPPER_PARAMS)
def test_cpu_tensor_runs_plain_version(wrapper, plain, args):
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 0.1, (3, 5512)).astype(np.float32))
    before = wrapper.launches
    got, ref = wrapper(x, *args), plain(x, *args)
    for g, r in zip(*((got, ref) if isinstance(got, tuple)
                      else ((got,), (ref,)))):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
    assert wrapper.launches == before


@pytest.mark.parametrize("wrapper,plain,args", WRAPPER_PARAMS)
def test_other_devices_raise(wrapper, plain, args):
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(torch.empty(2, 5512, device="meta"), *args)


def test_onset_flux_runs_plain_on_cpu_and_refuses_other_devices():
    db = torch.from_numpy(np.random.default_rng(1).normal(
        -40.0, 10.0, (2, 20, 128)).astype(np.float32))
    key = onset.order_key(db.amax(dim=(1, 2)))
    before = onset.onset_flux.launches
    np.testing.assert_array_equal(onset.onset_flux(db, key).numpy(),
                                  onset.onset_flux_plain(db, key).numpy())
    assert onset.onset_flux.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        onset.onset_flux(torch.empty(2, 20, 128, device="meta"), key)
