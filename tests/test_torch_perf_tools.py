"""The port's measuring tools on the CPU: `tools/torch_profile_trace.py`
(its trace parser on synthetic traces in torch's Chrome-trace format, as
tests/test_perf_tools.py holds the JAX parser, and one traced run) and
`tools/torch_roofline_files.py` (the stage attribution of a trace, the
report's schema, the stage counts against the wave's on both DFT
routes, K6's count and bound, K1-K5's counts against the formulas
`chip_smoke.py` used before they moved into
`gat_tpu_torch/utils/roofline.py`, and the record_function ranges of the
wave body), the kernels' names as the profiler reads them back, and
`tools/torch_onset_timing.py`'s slicer mode. Counts are integers and held
exactly; floors and shares within 1e-12 relative.
"""
import gzip
import importlib.util
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gat_tpu_torch import features
from gat_tpu_torch.ops import onset, spectral, yin
from gat_tpu_torch.utils import roofline

REPO = Path(__file__).resolve().parent.parent


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


prof = _tool("torch_profile_trace")
roof = _tool("torch_roofline_files")


def _write_trace(dirpath: Path, events, name="host.pt.trace.json.gz"):
    p = dirpath / name
    with gzip.open(p, "wt") as fh:
        json.dump({"traceEvents": events}, fh)
    return p


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


TRACE = [
    {"ph": "M", "name": "process_name", "pid": 7,
     "args": {"name": "python"}},
    # host lanes: ranges, ops and launches must not reach the table
    _x("user_annotation", "onset_detect", 0, 100),
    _x("user_annotation", "slicing", 100, 50),
    _x("cpu_op", "aten::mul", 110, 10),
    _x("cuda_runtime", "cudaLaunchKernel", 10, 2, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernel", 20, 2, correlation=2),
    _x("cuda_runtime", "cudaLaunchKernel", 112, 2, correlation=3),
    _x("cuda_runtime", "cudaMemcpyAsync", 130, 2, correlation=4),
    _x("cuda_runtime", "cudaLaunchKernel", 200, 2, correlation=5),
    # device lanes: one kernel name split over two events sums
    _x("kernel", "onset_mel_db_kernel(float const*, float*, int)", 30, 7.0,
       tid=13, correlation=1),
    _x("kernel", "onset_pick_kernel(float const*, int const*)", 40, 3.0,
       tid=13, correlation=2),
    _x("kernel", "void at::native::vectorized_elementwise_kernel<4>()",
       120, 5.0, tid=13, correlation=3),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 140, 4.0, tid=13,
       correlation=4),
    _x("kernel", "void at::native::vectorized_elementwise_kernel<4>()",
       210, 6.0, tid=13, correlation=5),
    _x("gpu_user_annotation", "onset_detect", 30, 13.0, tid=13),
]


def test_parse_trace_keeps_device_lanes_and_sums(tmp_path, capsys):
    _write_trace(tmp_path, TRACE)
    (f, rows, shares), = prof.parse_trace(str(tmp_path), top=10)
    assert dict(rows) == {
        "void at::native::vectorized_elementwise_kernel<4>()": 11.0,
        "onset_mel_db_kernel(float const*, float*, int)": 7.0,
        "Memcpy DtoH (Device -> Pinned)": 4.0,
        "onset_pick_kernel(float const*, int const*)": 3.0}
    assert shares == {"K1": 0, "K2": 0, "K3": 0, "K4": 7.0, "K5": 3.0,
                      "K6": 0, "K7": 0, "K8": 0,
                      "K9": 0, "K10": 0, "K11": 0,
                      "K12": 0, "K13": 0}
    out = capsys.readouterr().out
    assert "top 10 by total us (device lanes)" in out
    assert "cudaLaunchKernel" not in out and "aten::mul" not in out
    assert "by category (0.025 ms)" in out
    assert "84.0%  kernel" in out and "16.0%  gpu_memcpy" in out
    assert "kernel (4 events)" in out and "gpu_memcpy (1 events)" in out
    assert "28.0%  K4" in out and "12.0%  K5" in out


def test_parse_trace_names_k6(tmp_path, capsys):
    """The shared front-end's device function counts as K6, and K2 and K3
    keep their own shares beside it."""
    _write_trace(tmp_path, [
        _x("kernel", "mfcc_pitch_frontend_kernel(float const*, float*)",
           10, 9.0, tid=13),
        _x("kernel", "mfcc_frontend_kernel(float const*, float*)", 30, 2.0,
           tid=13),
        _x("kernel", "yin_pitch_kernel(float const*, float*)", 40, 1.0,
           tid=13)])
    (_, _, shares), = prof.parse_trace(str(tmp_path), top=10)
    assert shares == {"K1": 0, "K2": 2.0, "K3": 1.0, "K4": 0, "K5": 0,
                      "K6": 9.0, "K7": 0, "K8": 0,
                      "K9": 0, "K10": 0, "K11": 0,
                      "K12": 0, "K13": 0}
    assert "75.0%  K6" in capsys.readouterr().out


def test_parse_trace_names_k7_and_k8(tmp_path, capsys):
    """The gate's three device functions count as K7 and the slicer's as
    K8 (the profiler's names: the kernel's symbol, then its signature)."""
    _write_trace(tmp_path, [
        _x("kernel", "noise_gate_rms_kernel(float const*, int const*, "
           "float*, int, int, int, int, int, float)", 10, 4.0, tid=13),
        _x("kernel", "noise_gate_threshold_kernel(float const*, int "
           "const*, float*, unsigned char*, float*, int, int, int)", 20,
           1.0, tid=13),
        _x("kernel", "noise_gate_apply_kernel(float const*, float*)", 30,
           3.0, tid=13),
        _x("kernel", "slice_clips_kernel(float const*, int const*)", 40,
           2.0, tid=13)])
    (_, _, shares), = prof.parse_trace(str(tmp_path), top=10)
    assert shares == {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0,
                      "K6": 0, "K7": 8.0, "K8": 2.0,
                      "K9": 0, "K10": 0, "K11": 0,
                      "K12": 0, "K13": 0}
    out = capsys.readouterr().out
    assert "80.0%  K7" in out and "20.0%  K8" in out


def test_kernel_shares_read_names_by_device_function():
    """`kernel_shares` takes a kernel's events by `roofline.device_function`,
    the rule `chip_smoke.py` times by: a template's name counts, a function
    whose name only holds a kernel's symbol does not."""
    shares = prof.kernel_shares({
        "void melspec_frontend_kernel<true>(float const*, int)": 5.0,
        "slice_clips_kernel(float const*, int const*)": 2.0,
        "slice_clips_kernel_wide(float const*)": 7.0,
        "void at::native::noise_gate_apply_kernel_copy<4>()": 3.0})
    assert shares == {"K1": 5.0, "K2": 0, "K3": 0, "K4": 0, "K5": 0,
                      "K6": 0, "K7": 0, "K8": 2.0,
                      "K9": 0, "K10": 0, "K11": 0,
                      "K12": 0, "K13": 0}


def test_parse_trace_without_device_lanes_keeps_all(tmp_path, capsys):
    _write_trace(tmp_path, [_x("cpu_op", "opA", 0, 3.0),
                            _x("cpu_op", "opB", 5, 4.0, tid=2),
                            {"ph": "M", "name": "thread_name", "pid": 7}])
    (_, rows, shares), = prof.parse_trace(str(tmp_path), top=10)
    assert dict(rows) == {"opB": 4.0, "opA": 3.0}
    assert sum(shares.values()) == 0
    out = capsys.readouterr().out
    assert "all lanes (no device lane found)" in out
    assert "the port's kernels" not in out


def test_parse_trace_reads_every_file(tmp_path):
    _write_trace(tmp_path, TRACE[:1], "a.pt.trace.json.gz")
    (tmp_path / "sub").mkdir()
    _write_trace(tmp_path / "sub", TRACE, "b.pt.trace.json.gz")
    (tmp_path / "c.json").write_text("{}")
    assert [Path(f).name for f, _, _ in prof.parse_trace(str(tmp_path))] \
        == ["a.pt.trace.json.gz", "b.pt.trace.json.gz"]


def test_stage_attribution_innermost_range():
    """A kernel goes to the innermost stage range around its launch on
    the launching thread; the rest is 'other'."""
    events = TRACE + [
        # a nested range and a launch inside it
        _x("user_annotation", "mlp_forward", 300, 100),
        _x("user_annotation", "mfcc_yin_frontend", 320, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 325, 1, correlation=6),
        _x("kernel", "mfcc_frontend_kernel(float const*)", 330, 8.0,
           tid=13, correlation=6),
        # a range on another thread does not hold this thread's launch
        _x("user_annotation", "cnn_forward", 0, 1000, tid=2),
        # a range with another name is not a stage
        _x("user_annotation", "Optimizer.step", 500, 100),
        _x("cuda_runtime", "cudaLaunchKernel", 550, 1, correlation=7),
        _x("gpu_memset", "Memset (Device)", 560, 2.0, tid=13,
           correlation=7),
    ]
    us = roof.stage_device_us(events)
    assert us == {"onset_detect": 10.0, "slicing": 9.0, "other": 8.0,
                  "mfcc_yin_frontend": 8.0}


def test_stage_kernels_name_each_stage_s_kernels():
    """`stage_kernels` names the kernels each stage launched, attributed as
    the device time is (memsets left out): the report's `sort_kernels`
    reads them for a sort on the wave's path."""
    events = TRACE + [
        _x("user_annotation", "compaction", 300, 100),
        _x("cuda_runtime", "cudaLaunchKernel", 310, 1, correlation=6),
        _x("kernel", "wave_select_kernel(unsigned char const*, int)", 320,
           3.0, tid=13, correlation=6),
        _x("cuda_runtime", "cudaLaunchKernel", 330, 1, correlation=7),
        _x("gpu_memset", "Memset (Device)", 340, 2.0, tid=13,
           correlation=7),
    ]
    kernels = roof.stage_kernels(events)
    assert kernels["compaction"] == [
        "wave_select_kernel(unsigned char const*, int)"]
    assert set(kernels) == {"onset_detect", "slicing", "other",
                            "compaction"}
    assert roof.stage_device_us(events)["compaction"] == 5.0


def test_profile_trace_cpu_run(tmp_path, capsys):
    tables = prof.main(["--graph", "clip", "--batch", "4", "--iters", "2",
                        "--device", "cpu", "--trace_dir", str(tmp_path),
                        "--top", "5"])
    (f, rows, _), = tables
    assert f.endswith(".pt.trace.json.gz") and len(rows) == 5
    assert "all lanes (no device lane found)" in capsys.readouterr().out
    assert prof.main(["--parse_only", "--trace_dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------
def _former_k1_k3(n, length, sr):
    """chip_smoke.py's K1-K3 bounds as they were written there, but K3's
    ACF counted at the FFT cost (per frame three real FFTs of 2048 points
    and the cross spectrum), the function's least work, not at the
    kernel's direct sums."""
    def fft_flops(nnz, n_mels):
        return 2048 + 5 * 2048 * 11 // 2 + 3 * 1025 + 2 * nnz + n_mels
    dev = torch.device("cpu")
    t_mel = spectral.n_frames(length, 2048, 256)
    t_mfcc = spectral.n_frames(length, 2048, 512)
    tables64 = features._kernel_tables(sr, 64, True, dev)
    tables128 = features._kernel_tables(sr, 128, False, dev)
    *_, lo64, hi64 = tables64
    *_, lo128, hi128 = tables128
    nnz64 = int((hi64 - lo64).sum())
    nnz128 = int((hi128 - lo128).sum())
    _, max_p = yin.yin_periods(sr, 50.0, 1000.0, 2048, 1024)
    tb64 = sum(a.numel() * a.element_size() for a in tables64)
    tb128 = sum(a.numel() * a.element_size() for a in tables128) + 4 * 128 * 64
    return ((n * (t_mel * fft_flops(nnz64, 64) + 3 * length),
             n * length * 4 + n * 64 * t_mel * 4 + tb64),
            (n * (t_mfcc * (fft_flops(nnz128, 128) + 2 * 128)
                  + 2 * 128 * 64 + 3 * length),
             n * length * 4 + n * 64 * 4 + tb128),
            (n * t_mfcc * (3 * (5 * 2048 * 11 // 2) + 6 * 1025 + 9 * max_p),
             n * length * 4 + n * 4))


def _former_k4_k5(files, n, hop, max_onsets, sr=22050):
    def fft_flops(nnz, n_mels):
        return 2048 + 5 * 2048 * 11 // 2 + 3 * 1025 + 2 * nnz + n_mels
    t = 1 + n // hop
    hann, tw, _, lo, hi = features._kernel_tables(sr, 128, False,
                                                  torch.device("cpu"))
    nnz = int((hi - lo).sum())
    tables = 4 * (hann.numel() + tw.numel() + nnz + 2 * 128)
    pre_max, post_max, _, _, _ = onset.peak_pick_params(sr, hop)
    return ((files * t * (fft_flops(nnz, 128) + 4 * 128),
             4 * files * (n + t + 1) + tables),
            (files * t * (pre_max + post_max + 16),
             4 * files * (t + 1) + files * (max_onsets * 5 + 6)))


@pytest.mark.parametrize("n,length", [(1024, 5512), (384, 5512), (7, 1100)])
def test_k1_k3_counts_equal_the_former_formulas(n, length):
    k1, k2, k3 = _former_k1_k3(n, length, 11025)
    assert roofline.melspec_cost(n, length, 11025) == k1
    assert roofline.mfcc_cost(n, length, 11025) == k2
    assert roofline.yin_cost(n, length, 11025) == k3


@pytest.mark.parametrize("files,seconds,hop,max_onsets",
                         [(1, 4.0, 512, 64), (64, 8.0, 512, 64),
                          (4, 60.0, 512, 112), (256, 1.5, 1024, 8)])
def test_k4_k5_counts_equal_the_former_formulas(files, seconds, hop,
                                                max_onsets):
    n = int(seconds * 22050)
    k4, k5 = _former_k4_k5(files, n, hop, max_onsets)
    assert roofline.envelope_cost(files, n, 22050, hop=hop) == k4
    assert roofline.pick_cost(files, 1 + n // hop, 22050, hop,
                              max_onsets) == k5


@pytest.mark.parametrize("files, seconds, slots", [(4, 60.0, 448),
                                                   (1, 400.0, 64),
                                                   (2, 4.0, 32)])
def test_k7_k8_costs_are_the_stage_floors(files, seconds, slots):
    """K7's and K8's bounds are the serving wave's `segmentation_other` and
    `slicing` floors as the roofline tool counted them before the two
    kernels (8 bytes a sample and 8 a file; the windows read, the clips
    written), bytes-bound; at the wave (4 x 60 s, 448 slots of 11,025)
    0.01264 and 0.01180 ms."""
    n = int(seconds * 22050)
    length = 11025
    assert roofline.gate_cost(files, n) == (10 * files * n,
                                            8 * files * n + 8 * files)
    assert roofline.slice_cost(files, n, slots, length) == (
        2 * slots * length, 4 * min(files * n, slots * length) + 4 * slots
        + 4 * slots * length + 9 * slots)
    for cost in (roofline.gate_cost(files, n),
                 roofline.slice_cost(files, n, slots, length)):
        assert roofline.bound(*cost)[1] == "bytes"
    if (files, seconds) == (4, 60.0):
        assert round(roofline.bound(*roofline.gate_cost(files, n))[0],
                     5) == 0.01264
        assert round(roofline.bound(*roofline.slice_cost(
            files, n, slots, length))[0], 5) == 0.01180


def test_window_samples_count_the_open_windows():
    """The slicer's reads are the samples of the valid slots' windows
    inside each file: the nonzero samples of the plain slicer's clips of
    noise, over valid and refused slots, both gathers' onsets and a file
    cut short; K8's bound takes them in place of the most they could be."""
    from gat_tpu_torch.segment import slicing
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.normal(0, 0.1, (3, 50000)).astype(np.float32))
    ons = torch.tensor([[0, 5120, 10240, 40960], [512, 1024, 49152, 0],
                        [1024, 2048, 3072, 4096]], dtype=torch.int32)
    valid = torch.tensor([[1, 1, 1, 1], [1, 1, 1, 0], [0, 0, 0, 0]],
                         dtype=torch.bool)
    nv = torch.tensor([50000, 45000, 50000])
    for hop in (512, None):
        clips, _, times = slicing.slice_at_onsets_plain(
            y, ons, valid, 22050, n_valid=nv, onset_hop=hop)
        w = roofline.window_samples(times, valid, nv, 22050)
        assert w == int((clips != 0).sum()) > 0
    flops, nbytes = roofline.slice_cost(3, 50000, 12, 11025, w)
    full = roofline.slice_cost(3, 50000, 12, 11025)
    assert flops == full[0] and full[1] - nbytes == 4 * (12 * 11025 - w)


def test_bound_picks_the_larger_time():
    ms, by = roofline.bound(67e9, 1.0)
    assert (ms, by) == (pytest.approx(1.0, rel=1e-12), "operations")
    ms, by = roofline.bound(1.0, 3.35e9)
    assert (ms, by) == (pytest.approx(1.0, rel=1e-12), "bytes")


def test_module_cost_counts_matmuls():
    from gat_tpu_torch.models import MLP
    m = MLP(num_features=65, hidden_dim=128, num_hidden_layers=2,
            num_classes=47, dropout=0.0)
    flops, nbytes = roofline.module_cost(m, (10, 65))
    assert flops == 2 * 10 * (65 * 128 + 128 * 64 + 64 * 47)
    weights = sum(p.numel() * 4 for p in (*m.parameters(), *m.buffers()))
    assert nbytes == weights + 4 * 10 * 65 + 4 * 10 * 47
    assert next(m.parameters()).device.type == "cpu"


GLOBAL = re.compile(r"(template\s*<[^>]*>\s*)?__global__\s+void\s+"
                    r"(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


def test_kernel_symbols_name_the_kernels_device_functions():
    """Every name of `roofline.KERNEL_SYMBOLS` is a `__global__` function of
    `gat_tpu_torch/csrc/*.cu`, every such function is listed, and the name
    the profiler gives it (`name(args)`, or `void name<...>(args)` for a
    template) is read back to it by `device_function`, the match
    `chip_smoke.py` times each kernel by: a renamed kernel, or a template
    read by a prefix of the profiler's name, would time no launch
    without failing a test."""
    declared = {}
    for src in sorted((REPO / "gat_tpu_torch" / "csrc").glob("*.cu")):
        for m in GLOBAL.finditer(src.read_text()):
            declared[m[2]] = bool(m[1])
    listed = [n for syms in roofline.KERNEL_SYMBOLS.values() for n in syms]
    assert sorted(listed) == sorted(declared)
    for name, template in declared.items():
        shown = (f"void {name}<true>(float const*, int)" if template
                 else f"{name}(float const*, int)")
        assert roofline.device_function(shown) == name
    assert not declared["slice_clips_kernel"]
    assert declared["melspec_frontend_kernel"]
    assert roofline.device_function("noise_gate_rms_kernel") != "noise_gate"


def test_onset_timing_tool_times_the_slicer(monkeypatch):
    """`tools/torch_onset_timing.py TREE slice` runs chip_smoke's
    `time_slice` (the wave, the 400 s riff and 4.0 s clips) and, like
    every mode, exits 1 without a card (2 for a mode it does not know)."""
    timing = _tool("torch_onset_timing")
    assert timing.TIMINGS["slice"] == ("slice_clips", "time_slice")
    spec = importlib.util.spec_from_file_location("_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for _, fn in timing.TIMINGS.values():
        assert callable(getattr(smoke, fn))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert timing.main(["torch_onset_timing.py", str(REPO), "slice"]) == 1
    assert timing.main(["torch_onset_timing.py", str(REPO), "slices"]) == 2


def test_onset_timing_tool_times_the_resampler(monkeypatch):
    """`tools/torch_onset_timing.py TREE resample` runs chip_smoke's
    `time_resample` at its six shapes (the wave's budgeted clips, 60 s
    and 400 s at 48 kHz, 60 s at 16 kHz and at 44.1 kHz, one 0.5 s note,
    all to the file or checkpoint rate) and exits 1 without a card."""
    timing = _tool("torch_onset_timing")
    assert timing.TIMINGS["resample"] == ("resample", "time_resample")
    spec = importlib.util.spec_from_file_location("_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert [s[3:] for s in smoke.RESAMPLE_SHAPES] == [
        (22050, 11025), (48000, 22050), (48000, 22050), (16000, 22050),
        (44100, 22050), (22050, 11025)]
    assert smoke.KERNEL_ROWS[smoke.K9] == "resample"
    assert smoke.K9 in smoke.SEGMENTING
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert timing.main(["torch_onset_timing.py", str(REPO), "resample"]) == 1


def test_onset_timing_tool_times_the_compaction(monkeypatch):
    """`tools/torch_onset_timing.py TREE compact` runs chip_smoke's
    `time_compact` (the compaction stage in situ for any checkout, K10's
    cases where it has them) at the serving wave's budget, 384 of its 448
    slots as `[resample]` and the roofline tool take it, and a 64-file
    wave at 3/4 of its slots, and exits 1 without a card; the kernels
    line and every path count K10's two kernels."""
    timing = _tool("torch_onset_timing")
    assert timing.TIMINGS["compact"] == ("wave_compact", "time_compact")
    spec = importlib.util.spec_from_file_location("_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.COMPACT_BUDGET == smoke.RESAMPLE_BUDGET == 384
    assert smoke.COMPACT_FILES * smoke.COMPACT_SLOTS == 448
    files, k, budget = smoke.COMPACT_BIG
    assert files * k == 7168 and budget == (files * k * 3) // 4
    assert [smoke.KERNEL_ROWS[i] for i in smoke.COMPACTING] == [
        "wave_select", "wave_scatter"]
    assert smoke.BRANCH == len(smoke.KERNEL_ROWS) == 18
    assert roofline.KERNEL_SYMBOLS["K10"] == ("wave_select_kernel",
                                              "wave_scatter_kernel")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert timing.main(["torch_onset_timing.py", str(REPO), "compact"]) == 1


def test_k10_costs_count_each_byte_once():
    """K10's bounds: the selection reads the kept bits and flags once and
    writes sel, pos, kept, the flags and the count once; the scatter reads
    pos and the picked rows once and writes every output once."""
    assert roofline.select_cost(4, 112, 4, 384) == (
        2 * 448, 448 + 8 + 4 * 384 + 5 * 448 + 12 + 4)
    assert roofline.scatter_cost(448, 384, 142) == (
        0, 4 * 448 + 4 * 384 * 142 + 4 * 448 * 142)
    ms, by = roofline.bound(*roofline.scatter_cost(448, 384, 142))
    assert by == "bytes" and ms == pytest.approx(0.00014, rel=0.02)


def test_stage_tags_keep_the_jax_names():
    jroof = _tool("roofline_files")
    assert [n for n, _ in roof.STAGE_TAGS] == [n for n, _ in
                                                jroof.STAGE_TAGS]
    assert roof.STAGES[-1] == "other"


ARGS = ["--device", "cpu", "--files", "2", "--seconds", "4", "--onsets",
        "16", "--budget", "24", "--cand", "64", "--clip_batch", "8",
        "--measured_wave_ms", "5.0"]


@pytest.fixture
def stft_route():
    """The test may set the DFT route; it is back at "auto" afterwards."""
    yield
    spectral.set_stft_backend("auto")


@pytest.fixture(scope="module")
def report():
    return roof.report(roof.parse_args(ARGS))


def test_roofline_report_schema(report):
    assert set(report) == {"program", "card", "wave", "measured", "stages",
                           "clip_step"}
    prog = report["program"]
    assert (prog["files"], prog["seconds"], prog["max_onsets"],
            prog["wave_clip_budget"], prog["cand_budget"]) == (2, 4.0, 16,
                                                               24, 64)
    assert prog["bucket_samples"] == 4 * 22050
    assert report["card"] == {"name_power_limit": None,
                              "peak_fp32_flops": 67e12,
                              "peak_bytes_per_s": 3.35e12}
    assert list(report["stages"]) == list(roof.STAGES)
    for name, row in report["stages"].items():
        assert set(row) == {"flops", "bytes", "floor_ms", "bound_by",
                            "measured_ms", "share"}
        assert row["measured_ms"] is None and row["share"] is None
        assert row["flops"] > 0 and row["bytes"] > 0, name
    clip = report["clip_step"]
    assert clip["batch"] == 8 and clip["measured_ms"] is None
    assert clip["flops"] > 0 and clip["bound_by"] in ("bytes", "operations")


def test_stage_counts_sum_to_the_wave(report):
    wave, stages = report["wave"], report["stages"]
    assert wave["flops"] == sum(r["flops"] for r in stages.values())
    assert wave["bytes"] == sum(r["bytes"] for r in stages.values())
    ms, by = roofline.bound(wave["flops"], wave["bytes"])
    assert (wave["floor_ms"], wave["bound_by"]) == (ms, by)
    assert wave["t_flops_ms_floor"] == pytest.approx(
        wave["flops"] / 67e12 * 1e3, rel=1e-12)


def test_stage_counts_use_the_kernel_formulas(report):
    """The kernel stages are K1-K5's counts at the wave's shapes (K2 with
    the scaler's two operations per feature)."""
    stages = report["stages"]
    n = 4 * 22050
    k4, k5 = _former_k4_k5(2, n, 512, 16)
    assert (stages["onset_detect"]["flops"], stages["onset_detect"]["bytes"]) \
        == (k4[0] + k5[0], k4[1] + k5[1])
    k1, k2, k3 = _former_k1_k3(24, 5512, 11025)
    assert (stages["melspec_frontend"]["flops"],
            stages["melspec_frontend"]["bytes"]) == k1
    assert (stages["yin_baseline"]["flops"],
            stages["yin_baseline"]["bytes"]) == k3
    assert (stages["mfcc_yin_frontend"]["flops"],
            stages["mfcc_yin_frontend"]["bytes"]) == (k2[0] + 2 * 65 * 24,
                                                      k2[1] + 8 * 65 * 24)
    slots = 2 * 16
    assert stages["compaction"]["flops"] == slots * math.ceil(
        math.log2(slots))
    # K7's and K8's counts are the two stages' floors as they were
    # counted before the kernels took them
    length = 11025
    assert (stages["segmentation_other"]["flops"],
            stages["segmentation_other"]["bytes"]) == (
        roofline.gate_cost(2, n)) == (10 * 2 * n, 8 * 2 * n + 8 * 2)
    assert (stages["slicing"]["flops"], stages["slicing"]["bytes"]) == (
        roofline.slice_cost(2, n, slots, length)) == (
        2 * slots * length, 4 * min(2 * n, slots * length) + 4 * slots
        + 4 * slots * length + 9 * slots)


def test_clip_rerate_reads_the_budget_gather(report):
    """K9 reads the budget's clips where they lie (`resample_rows`): the
    clip_rerate stage counts the 24 picked clips of 11,025 samples, their
    int32 index and 5,512 outputs each (97 taps, the clip length cut at
    m = 5,513), and the compaction no gathered copy of the clips, only
    its selection and the scatter of 47 probs x 3 and the pitch."""
    stages = report["stages"]
    clips, slots, length, out_len = 24, 32, 11025, 5512
    assert (stages["clip_rerate"]["flops"],
            stages["clip_rerate"]["bytes"]) == (
        2 * 97 * clips * out_len, 4 * clips * (length + out_len) + 4 * clips)
    per_clip = 4 * (3 * 47 + 1)
    assert stages["compaction"]["bytes"] == (slots + clips * per_clip
                                             + slots * per_clip)
    assert roofline.resample_cost(clips, length, 22050, 11025) == (
        2 * 97 * clips * 5513, 4 * clips * (length + 5513))


def test_shared_route_counts_k6_and_no_yin_baseline():
    """On the matmul route the MFCC front-end stage is K6's count (K2's
    operations and K3's, one read of the clips) and the scaler's, and the
    YIN baseline stage counts nothing; every other stage as on the FFT
    route. The route is back at its default afterwards."""
    try:
        rep = roof.report(roof.parse_args(ARGS + ["--stft_backend",
                                                  "matmul"]))
    finally:
        spectral.set_stft_backend("auto")
    ref = roof.report(roof.parse_args(ARGS))
    stages = rep["stages"]
    assert rep["program"]["stft_backend"] == "matmul"
    assert ref["program"]["stft_backend"] == "fft"
    k6 = roofline.mfcc_pitch_cost(24, 5512, 11025)
    assert (stages["mfcc_yin_frontend"]["flops"],
            stages["mfcc_yin_frontend"]["bytes"]) == (k6[0] + 2 * 65 * 24,
                                                      k6[1] + 8 * 65 * 24)
    assert (stages["yin_baseline"]["flops"],
            stages["yin_baseline"]["bytes"]) == (0, 0)
    for name in roof.STAGES:
        if name not in ("mfcc_yin_frontend", "yin_baseline"):
            assert stages[name] == ref["stages"][name], name
    k2, k3 = roofline.mfcc_cost(24, 5512, 11025), roofline.yin_cost(
        24, 5512, 11025)
    shared = 24 * 11 * (5 * 2048 * 11 // 2 + 2048 - 8 * 1025)
    assert k6 == (k2[0] + k3[0] - shared, k2[1] + 8 * 24)


def test_k6_bound_at_the_clip_batch():
    """At 1024 clips of 0.5 s, K6's bound is K2's plus K3's less the FFT
    per frame the two branches share (and K2's window products, for the
    window applied in frequency), operations-bound; its bytes bound one
    read of the clips and the tables."""
    k6 = roofline.mfcc_pitch_cost(1024, 5512, 11025)
    ms, by = roofline.bound(*k6)
    k2 = roofline.bound(*roofline.mfcc_cost(1024, 5512, 11025))[0]
    k3 = roofline.bound(*roofline.yin_cost(1024, 5512, 11025))[0]
    shared = 1024 * 11 * (5 * 2048 * 11 // 2 + 2048 - 8 * 1025) / 67e9
    assert by == "operations"
    assert ms == pytest.approx(k2 + k3 - shared, rel=1e-12)
    assert k3 == pytest.approx(0.0298, abs=1e-4)
    assert ms == pytest.approx(0.0329, abs=1e-4)
    assert k6[1] / 3.35e12 * 1e3 == pytest.approx(0.0070, abs=1e-4)


def test_mfu_is_the_flops_floor_over_the_measured_wave(report):
    wave, m = report["wave"], report["measured"]
    assert m["wave_ms"] == 5.0
    assert m["mfu"] == pytest.approx(wave["t_flops_ms_floor"] / 5.0,
                                     rel=1e-12)
    assert m["bw_util"] == pytest.approx(wave["t_bytes_ms_floor"] / 5.0,
                                         rel=1e-12)
    assert m["roofline_share"] == pytest.approx(wave["floor_ms"] / 5.0,
                                                rel=1e-12)
    assert m["audio_s_per_s"] == pytest.approx(8.0 / 5e-3, rel=1e-12)
    assert m["device_busy_ms"] is None


def test_no_budget_means_no_compaction():
    args = roof.parse_args(ARGS[:8] + ["--budget", "64", "--clip_batch",
                                       "0"])
    rep = roof.report(args)
    assert (rep["stages"]["compaction"]["flops"],
            rep["stages"]["compaction"]["bytes"]) == (0, 0)
    assert "clip_step" not in rep and rep["measured"] is None


def test_a_stage_below_its_floor_raises():
    stages = {"slicing": {"measured_ms": 0.5, "floor_ms": 0.25},
              "other": {"measured_ms": None, "floor_ms": 1.0}}
    roof.check_floors(stages)
    stages["slicing"]["measured_ms"] = 0.125
    with pytest.raises(RuntimeError, match="slicing 0.12500 ms < 0.25000"):
        roof.check_floors(stages)


def test_wave_body_marks_every_stage():
    """One wave under torch.profiler on the CPU: each stage of STAGE_TAGS
    is a range of the trace."""
    from torch.profiler import ProfilerActivity, profile
    from gat_tpu_torch.infer import Transcriber
    t = Transcriber(device="cpu")
    run, _ = t._files_fn(22050, 0.5, 8, 6, 32)
    y = torch.from_numpy(np.random.default_rng(0).normal(
        0, 0.05, (2, 3 * 22050)).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU]) as p:
        run(y, torch.tensor([3 * 22050, 2 * 22050]))
    names = {e.key for e in p.key_averages()}
    assert {n for n, _ in roof.STAGE_TAGS} <= names


# the stage ranges one call enters, in order: the two-stage path's
# segmentation and ensemble (whose YIN baseline the ensemble runs), the
# fused body's, and the serving wave's (the fused body with the budget's
# gather and scatter)
_SEGMENT = ["segmentation_other", "onset_detect", "slicing"]
_ENSEMBLE = ["mfcc_yin_frontend", "melspec_frontend", "mlp_forward",
             "cnn_forward"]
RANGES_A_CALL = {
    "transcribe": [*_SEGMENT, "yin_baseline", *_ENSEMBLE],
    "transcribe_fused": ["segmentation_other", *_SEGMENT, "clip_rerate",
                         "yin_baseline", *_ENSEMBLE],
    "wave": ["segmentation_other", *_SEGMENT, "compaction", "clip_rerate",
             "yin_baseline", *_ENSEMBLE, "compaction"],
    # the shared route: the MFCC front-end gives the baseline's pitch
    "wave_shared": ["segmentation_other", *_SEGMENT, "compaction",
                    "clip_rerate", *_ENSEMBLE, "compaction"],
}


@pytest.mark.parametrize("call", ["transcribe", "transcribe_fused", "wave",
                                  "wave_shared"])
def test_ranges_a_call_enters_and_none_open_without_a_profiler(
        call, tmp_path, monkeypatch, stft_route):
    """The stage ranges one call enters (`annotate` in the three modules
    that open them), a fixed property of the code, and that with no
    profiler recording not one of them opens a record_function."""
    from gat_tpu_torch.infer import Transcriber, pipeline, predictor
    from gat_tpu_torch.segment import slicing
    from gat_tpu_torch.utils import profiling
    from gat_tpu_torch.utils.wavio import write_wav
    from tests.test_torch_segment import riff

    entered, opened = [], []
    for mod in (pipeline, predictor, slicing):
        monkeypatch.setattr(mod, "annotate", lambda name: (
            entered.append(name), profiling.annotate(name))[1])
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    t = Transcriber(device="cpu")
    path = tmp_path / "riff.wav"
    write_wav(path, riff(22050, dur=3.7), 22050)
    if call == "wave_shared":
        spectral.set_stft_backend("matmul")
    if call.startswith("wave"):
        run, _ = t._files_fn(22050, 0.5, 8, 6, 32)
        y = torch.from_numpy(np.random.default_rng(0).normal(
            0, 0.05, (2, 3 * 22050)).astype(np.float32))
        run(y, torch.tensor([3 * 22050, 2 * 22050]))
    else:
        t.transcribe(path, fused=call == "transcribe_fused")
    assert entered == RANGES_A_CALL[call]
    assert opened == []


def test_onset_timing_tool_times_training(monkeypatch):
    """`tools/torch_onset_timing.py TREE train` runs chip_smoke's
    `time_train` (the steady-state epoch of the shipped MLP and bf16 CNN
    at `[train]`'s sizes, any checkout) and exits 1 without a card; the
    kernels line and every path count K11's, K12's two and K13's four
    kernels after K10's, as the roofline names their device functions."""
    timing = _tool("torch_onset_timing")
    assert timing.TIMINGS["train"] == ("train_step", "time_train")
    spec = importlib.util.spec_from_file_location("_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert [smoke.KERNEL_ROWS[i] for i in smoke.TRAINING + smoke.BATCHNORM
            ] == ["softmax_xent", "clip_norm", "adamw_update", "bn_moments",
                  "bn_apply", "bn_apply_grad", "bn_moments_grad"]
    assert smoke.BN_KERNELS == tuple(smoke.KERNEL_ROWS[i]
                                     for i in smoke.BATCHNORM)
    assert [len(roofline.KERNEL_SYMBOLS[k]) for k in ("K11", "K12", "K13")
            ] == [1, 2, 4]
    assert smoke.BN_LAYERS[0] == (smoke.TRAIN_BATCH, 32, 64, 22)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert timing.main(["torch_onset_timing.py", str(REPO), "train"]) == 1


def test_onset_timing_tool_times_k12_and_k13(monkeypatch):
    """`tools/torch_onset_timing.py TREE batchnorm clip_adamw` runs
    chip_smoke's `time_bn` (K13 at the CNN's three layers) and
    `time_clip_adamw` (K12 at both models' parameter counts), so a parent
    tree is timed in turns with this one; both exit 1 without a card."""
    timing = _tool("torch_onset_timing")
    assert timing.TIMINGS["batchnorm"] == ("batchnorm_train", "time_bn")
    assert timing.TIMINGS["clip_adamw"] == ("clip_adamw", "time_clip_adamw")
    spec = importlib.util.spec_from_file_location("_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for _, fn in timing.TIMINGS.values():
        assert callable(getattr(smoke, fn))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("batchnorm", "clip_adamw"):
        assert timing.main(["torch_onset_timing.py", str(REPO), name]) == 1


def test_k11_to_k13_costs_count_each_byte_once():
    """K11-K13's bounds: K11 reads the logits and labels once and writes
    the loss, the count and (where asked) the gradient and argmaxes; K12's
    passes read g (pass 1) and p, g, mu, nu and write p, mu, nu and, where
    the step clips, g (pass 2); K13's kernels read and write each tensor
    once at its element size."""
    assert roofline.xent_cost(32, 47, True) == (10 * 32 * 47,
                                                8 * 32 * 47 + 8 * 32 + 12)
    assert roofline.xent_cost(8, 5, False, preds=True)[1] == (
        4 * 40 + 8 * 8 + 12 + 8 * 8)
    assert roofline.clip_norm_cost(100) == (200, 408)
    assert roofline.adamw_cost(100, False)[1] == 28 * 100 + 12
    assert roofline.adamw_cost(100, True)[1] == 32 * 100 + 12
    e = 2 * 3 * 20
    assert roofline.bn_cost("moments", 2, 3, 20, 2) == (3 * e, 2 * e + 24)
    assert roofline.bn_cost("apply", 2, 3, 20, 4)[1] == 2 * 4 * e + 96
    assert roofline.bn_cost("apply_grad", 2, 3, 20, 2)[1] == 2 * 2 * e + 96
    assert roofline.bn_cost("moments_grad", 2, 3, 20, 4)[1] == (
        3 * 4 * e + 36)
    ms, by = roofline.bound(*roofline.adamw_cost(629743, True))
    assert by == "bytes" and abs(ms - (32 * 629743 + 12) / 3.35e12 * 1e3) < 1e-12


def test_onset_timing_tool_times_k11(monkeypatch):
    """`tools/torch_onset_timing.py TREE xent` runs chip_smoke's
    `time_xent` (K11 at a training step's 32 x 47 and an eval chunk's
    65,536 x 47, the trainer's `_EVAL_CHUNK`), so a parent tree is timed
    in turns with this one, and exits 1 without a card; K11 is one device
    function, a template of two instances."""
    from gat_tpu_torch.train import trainer
    timing = _tool("torch_onset_timing")
    assert timing.TIMINGS["xent"] == ("softmax_xent", "time_xent")
    spec = importlib.util.spec_from_file_location("_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert (smoke.TRAIN_BATCH, smoke.TRAIN_CLASSES) == (32, 47)
    assert smoke.EVAL_CHUNK == trainer.Trainer._EVAL_CHUNK == 65536
    assert roofline.KERNEL_SYMBOLS["K11"] == ("softmax_xent_kernel",)
    assert roofline.device_function(
        "void softmax_xent_kernel<true>(float const*, long long const*, "
        "float*, long long*, float*, int*, int*, float*, long long*, int, "
        "int, int, int, float, float)") == "softmax_xent_kernel"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert timing.main(["torch_onset_timing.py", str(REPO), "xent"]) == 1
