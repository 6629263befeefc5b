"""The plain twins of K7 (`gate_waveform_plain`, `rms_gate_plain`) and K8
(`slice_at_onsets_plain`) against gat_tpu on the CPU, the wrappers on CPU
tensors, and the file body with a loud tail past n_valid.

Bounds, each with its reason: the gated samples, the clips, kept and
times are identical (the same float32 ops in the same order; order
statistics are exact), as `tests/test_torch_segment.py` holds them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_tpu.segment import gating as jg
from gat_tpu.segment import slicing as js
from gat_tpu_torch import kernels
from gat_tpu_torch.config import CLIP_DURATION
from gat_tpu_torch.ops import onset as to
from gat_tpu_torch.segment import gating as tg
from gat_tpu_torch.segment import slicing as ts
from emulated_kernels import (gate_counts, gate_rows,
                              pluck_riff)

SR = 22050
MIN_DB = -32.5


@pytest.mark.parametrize("hop", [512, 256])
@pytest.mark.parametrize("counted", [True, False])
@pytest.mark.parametrize("which", ["gate_waveform", "rms_gate"])
def test_gate_plain_matches_reference(which, counted, hop):
    n = 2 * SR
    y = gate_rows(n)
    nv = gate_counts(n) if counted else None
    if which == "gate_waveform":
        ref = jg.gate_waveform(jnp.asarray(y), MIN_DB, hop_length=hop,
                               n_valid_samples=None if nv is None
                               else jnp.asarray(nv))
        got = tg.gate_waveform_plain(torch.from_numpy(y), MIN_DB, hop,
                                     n_valid=None if nv is None
                                     else torch.from_numpy(nv))
    else:
        ref = jg.rms_gate(jnp.asarray(y), hop_length=hop,
                          n_valid_samples=None if nv is None
                          else jnp.asarray(nv))
        got = tg.rms_gate_plain(torch.from_numpy(y), hop,
                                n_valid=None if nv is None
                                else torch.from_numpy(nv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert bool(got.any())
    if counted:  # n_valid 0 gates every sample
        assert not bool(got[0].any())


@pytest.mark.parametrize("n, hop", [(1025, 512), (1500, 2048), (3000, 256),
                                    (44100, 512), (44100, 4096)])
def test_gate_without_counts_is_the_whole_row_count(n, hop):
    """K7 takes n_valid None as the count n: the plain gate without counts
    equals the plain gate with n, in every intermediate value, for every
    row length it takes (n > 1024, its reflect pad), so the kernel's
    single code path holds for both."""
    y = torch.from_numpy(gate_rows(n, seed=n)[:2])
    whole = torch.full((2,), n)
    for min_db in (MIN_DB, None):
        a = tg.gate_parts_plain(y, min_db, hop)
        b = tg.gate_parts_plain(y, min_db, hop, n_valid=whole)
        for key in a:
            assert torch.equal(a[key], b[key]), key


def slice_inputs(hop_aligned: bool):
    """Three rows of the riff and their onsets: aligned to 512 or not,
    one near a row's end, a valid pattern that is not a prefix in the
    last row; valid counts below the row length in two rows."""
    n = 3 * SR
    y = gate_rows(n)[:3]
    rng = np.random.default_rng(5)
    onsets = np.sort(rng.integers(0, n, (3, 8)), axis=1)
    onsets[:, 0] = 0
    onsets[1, -1] = n - 100
    if hop_aligned:
        onsets = onsets // 512 * 512
    valid = np.ones((3, 8), bool)
    valid[0, 6:] = False
    valid[2, [1, 4]] = False
    nv = np.array([n, n - 3000, 40000])
    return y, onsets.astype(np.int32), valid, nv


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("onset_hop", [None, 512])
def test_slice_plain_matches_reference(onset_hop, strict):
    y, onsets, valid, nv = slice_inputs(onset_hop is not None)
    got = ts.slice_at_onsets_plain(
        torch.from_numpy(y), torch.from_numpy(onsets),
        torch.from_numpy(valid), SR, strict_reference_compat=strict,
        n_valid=torch.from_numpy(nv), onset_hop=onset_hop)
    for i in range(len(y)):
        ref = js.slice_at_onsets(jnp.asarray(y[i]), jnp.asarray(onsets[i]),
                                 jnp.asarray(valid[i]), sr=SR,
                                 strict_reference_compat=strict,
                                 n_valid_samples=jnp.asarray(nv[i]),
                                 onset_hop=onset_hop)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(r))
    assert bool(got[1].any()) and not bool(got[1].all())


def test_wrappers_on_cpu_load_no_kernel(monkeypatch):
    """On CPU tensors the wrappers run the plain twins and never reach a
    kernel library (no nvcc is needed)."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel library was asked for on the CPU")
    monkeypatch.setattr(kernels, "function", refuse)
    monkeypatch.setattr(kernels, "build", refuse)
    n = 2 * SR
    y = torch.from_numpy(gate_rows(n)[:3])
    nv = torch.tensor([n, 30000, 0])
    before = (tg.noise_gate.launches, ts.slice_at_onsets.launches)
    assert torch.equal(tg.gate_waveform(y, MIN_DB, n_valid=nv),
                       tg.gate_waveform_plain(y, MIN_DB, n_valid=nv))
    assert torch.equal(tg.rms_gate(y[0]), tg.rms_gate_plain(y[0]))
    ys, onsets, valid, nvs = (torch.from_numpy(a)
                              for a in slice_inputs(True))
    for got, ref in zip(
            ts.slice_at_onsets(ys, onsets, valid, SR, n_valid=nvs,
                               onset_hop=512),
            ts.slice_at_onsets_plain(ys, onsets, valid, SR, n_valid=nvs,
                                     onset_hop=512)):
        assert torch.equal(got, ref)
    outs = ts.segment_waveform(y, sr=SR, n_valid=nv)
    assert outs[0].shape == (3, 64, int(SR * CLIP_DURATION))
    assert (tg.noise_gate.launches, ts.slice_at_onsets.launches) == before
    assert kernels._libs == {}


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a card is refused, and K7's launcher
    refuses CPU rows: there is no fallback."""
    y = torch.empty((2, 4096), device="meta")
    for call in (lambda: tg.gate_waveform(y, MIN_DB),
                 lambda: tg.rms_gate(y),
                 lambda: ts.slice_at_onsets(
                     y, torch.zeros((2, 4), dtype=torch.int32,
                                    device="meta"),
                     torch.zeros((2, 4), dtype=torch.bool, device="meta"),
                     SR),
                 lambda: tg.noise_gate(torch.zeros(2, 4096), MIN_DB)):
        with pytest.raises(ValueError, match="CUDA|device"):
            call()


@pytest.fixture(scope="module")
def cpu_transcriber():
    from gat_tpu_torch.infer import Transcriber
    return Transcriber(device="cpu")


def test_tail_noise_does_not_change_the_file_body(cpu_transcriber):
    """The file body has no length mask of its own since K7 folds it in:
    rows whose samples past n_valid are loud noise give the same outputs
    as rows zero there (two riffs and a padding row of n_valid 0)."""
    n = 4 * SR
    y = np.zeros((3, n), np.float32)
    nv = np.array([int(3.0 * SR), int(2.3 * SR) + 77, 0])
    y[0, :nv[0]] = pluck_riff(SR, 3.0)
    y[1, :nv[1]] = pluck_riff(SR, 3.0)[:nv[1]]
    loud = y.copy()
    rng = np.random.default_rng(3)
    for i, v in enumerate(nv):
        loud[i, v:] = rng.normal(0.0, 0.5, n - v)
    run, _ = cpu_transcriber._files_fn(SR, CLIP_DURATION, 16, None, None)
    counts = torch.from_numpy(nv)
    quiet_out = run(torch.from_numpy(y), counts)
    loud_out = run(torch.from_numpy(loud), counts)
    for a, b in zip(quiet_out, loud_out):
        assert (a is None and b is None) or torch.equal(a, b)
    kept = quiet_out[4]
    assert bool(kept[0].any()) and bool(kept[1].any())
    assert not bool(kept[2].any())


def test_detect_onsets_reads_the_gated_tail_as_zero():
    """K4 reads samples past n_valid near a file's end: the gate's output
    is zero there whatever the row held, so the onsets of a loud tail are
    those of a zero one."""
    n = 3 * SR
    y = torch.from_numpy(gate_rows(n)[:2])
    nv = torch.tensor([int(2.2 * SR), n])
    loud = y.clone()
    loud[0, nv[0]:] = 0.7
    quiet = y.clone()
    quiet[0, nv[0]:] = 0.0
    gq = tg.gate_waveform(quiet, MIN_DB, n_valid=nv)
    gl = tg.gate_waveform(loud, MIN_DB, n_valid=nv)
    assert torch.equal(gq, gl) and not bool(gl[0, nv[0]:].any())
    for a, b in zip(to.detect_onsets(gq, sr=SR, n_valid=nv),
                    to.detect_onsets(gl, sr=SR, n_valid=nv)):
        assert torch.equal(a, b)
