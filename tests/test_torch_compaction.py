"""PyTorch port vs gat_tpu: the wave's clip-budget compaction
(`gat_tpu_torch/ops/compaction.py`, K10's plain twins) against the budget
branch of `gat_tpu/infer/pipeline.py::build_files_fn`, and the file body
of both packages at budgets around a wave's kept count (CPU, the shipped
checkpoints).

Bounds: the selection (sel in value and order, kept, dropped, overflow,
fixable, the count) and the scattered outputs equal; the file body's
labels, kept masks, onsets, times and flags equal, its probs within atol
1e-2 and its pitch within rtol 2e-3, as test_torch_file_path holds it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_tpu.infer import Transcriber as JTranscriber
from gat_tpu_torch.infer import Transcriber
from gat_tpu_torch.infer.pipeline import build_files_fn
from gat_tpu_torch.ops import compaction
from tests.test_torch_segment import riff

SR = 22050


def reference(kept: np.ndarray, budget: int, overflow: np.ndarray,
              fixable: np.ndarray) -> dict:
    """The reference's lines (gat_tpu/infer/pipeline.py:176-196), in
    jax.numpy on the same bits."""
    b, k = kept.shape
    kept = jnp.asarray(kept)
    keptf = kept.reshape(b * k)
    keptt = kept.T.reshape(b * k)
    ordert = jnp.argsort(~keptt, stable=True)[:budget]
    sel = (ordert % b) * k + (ordert // b)
    computed = jnp.zeros((b * k,), bool).at[sel].set(True)
    dropped = jnp.any((keptf & ~computed).reshape(b, k), axis=-1)
    return dict(sel=np.asarray(sel), kept=np.asarray(
        kept & computed.reshape(b, k)), dropped=np.asarray(dropped),
        overflow=np.asarray(overflow | dropped),
        fixable=np.asarray(fixable | dropped))


def reference_scatter(sel: np.ndarray, x: np.ndarray, n: int) -> np.ndarray:
    out = jnp.zeros((n,) + x.shape[1:], x.dtype)
    return np.asarray(out.at[jnp.asarray(sel)].set(jnp.asarray(x)))


def kept_bits(b: int, k: int, n_kept: int, seed: int) -> np.ndarray:
    """(b, k) bits with exactly n_kept set, at places drawn from a seed."""
    rng = np.random.default_rng(seed)
    flat = np.zeros(b * k, bool)
    flat[rng.choice(b * k, n_kept, replace=False)] = True
    return flat.reshape(b, k)


def flags(b: int, seed: int) -> tuple:
    rng = np.random.default_rng(seed + 1)
    return rng.random(b) < 0.3, rng.random(b) < 0.3


def check_against_reference(kept: np.ndarray, budget: int, seed: int):
    ovf, fix = flags(kept.shape[0], seed)
    ref = reference(kept, budget, ovf, fix)
    got = compaction.wave_select_plain(torch.from_numpy(kept), budget,
                                       overflow=torch.from_numpy(ovf),
                                       fixable=torch.from_numpy(fix))
    assert got.sel.dtype == torch.int32
    np.testing.assert_array_equal(got.sel.numpy(), ref["sel"])
    assert got.n_sel == len(ref["sel"]) == min(budget, kept.size)
    for name in ("kept", "dropped", "overflow", "fixable"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), ref[name])
    pos = got.pos.numpy()
    assert (pos[ref["sel"]] == np.arange(len(ref["sel"]))).all()
    assert (pos >= 0).sum() == len(ref["sel"])
    return got, ref


# (files, K): one slot, a file of 31, the serving wave (4 x 112) and a
# wave of 9 files x 13
SHAPES = ((1, 1), (1, 31), (4, 112), (9, 13))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", ["budget_1", "kept_minus_1", "kept",
                                  "kept_plus_1", "all_kept", "none_kept"])
def test_wave_select_plain_matches_reference(shape, case):
    """Budget 1, budgets one below, at and one above the kept count, every
    slot kept and none kept: the same sel in the same order (non-kept
    slots pad it in slot-major order), kept, dropped and flags."""
    b, k = shape
    n = b * k
    n_kept = {"all_kept": n, "none_kept": 0}.get(case, (n * 2) // 3)
    kept = kept_bits(b, k, n_kept, seed=n)
    budget = {"budget_1": 1, "kept_minus_1": n_kept - 1, "kept": n_kept,
              "kept_plus_1": n_kept + 1, "all_kept": max(1, n - 1),
              "none_kept": max(1, n // 2)}[case]
    budget = max(1, budget)
    got, ref = check_against_reference(kept, budget, seed=n)
    if case == "kept_minus_1" and n_kept > 1:
        assert got.dropped.any()
    if case == "kept_plus_1" and n_kept < n:
        # one non-kept slot pads the budget and is computed, not kept
        assert not kept.reshape(-1)[got.sel[-1]]


@pytest.mark.parametrize("seed", range(6))
def test_wave_select_plain_random_budgets(seed):
    """Random densities and budgets on the serving wave's shape."""
    rng = np.random.default_rng(seed)
    kept = rng.random((4, 112)) < rng.random()
    check_against_reference(kept, int(rng.integers(1, 449)), seed)


@pytest.mark.parametrize("world", [2, 4, 8])
def test_wave_select_plain_mesh_ranks(world):
    """Each rank's selection is the whole wave's sel filtered to its files,
    in the same order, and its flags are its files' of the whole wave's."""
    b, k = 8, 13
    kept = kept_bits(b, k, 50, seed=world)
    ovf, fix = flags(b, world)
    for budget in (1, 30, 50, 70):
        ref = reference(kept, budget, ovf, fix)
        local = b // world
        for r in range(world):
            first = r * local
            got = compaction.wave_select_plain(
                torch.from_numpy(kept), budget, first, local,
                torch.from_numpy(ovf[first:first + local]),
                torch.from_numpy(fix[first:first + local]))
            want = ref["sel"][(ref["sel"] >= first * k)
                              & (ref["sel"] < (first + local) * k)]
            np.testing.assert_array_equal(got.sel.numpy(), want - first * k)
            assert got.n_sel == len(want)
            for name in ("kept", "dropped", "overflow", "fixable"):
                np.testing.assert_array_equal(
                    getattr(got, name).numpy(),
                    ref[name][first:first + local])


@pytest.mark.parametrize("c", [47, 1])
@pytest.mark.parametrize("cnn", [True, False])
def test_wave_scatter_plain_matches_reference(c, cnn):
    """The compact outputs back at their slots with `.at[sel].set`, zeros
    elsewhere; a CNN-less build's None stays None; a row past n_sel (the
    mesh's unread slot) is not read."""
    kept = kept_bits(4, 112, 300, seed=c)
    ovf, fix = flags(4, c)
    sel = reference(kept, 384, ovf, fix)["sel"]
    got = compaction.wave_select_plain(torch.from_numpy(kept), 384)
    rng = np.random.default_rng(c)
    parts = [rng.random((385, c), dtype=np.float32) for _ in range(3)]
    parts.append(rng.random(385, dtype=np.float32))
    if not cnn:
        parts[2] = None
    out = compaction.wave_scatter_plain(
        got.pos, [None if x is None else torch.from_numpy(x)
                  for x in parts])
    for x, o in zip(parts, out):
        if x is None:
            assert o is None
            continue
        np.testing.assert_array_equal(o.numpy(),
                                      reference_scatter(sel, x[:384], 448))


def test_wrappers_take_the_plain_route_on_the_cpu():
    """On CPU tensors the wrappers are the plain versions, launching
    nothing; another device type is refused."""
    kept = torch.from_numpy(kept_bits(4, 112, 200, seed=0))
    before = compaction.wave_select.launches, compaction.wave_scatter.launches
    s = compaction.wave_select(kept, 384)
    ref = compaction.wave_select_plain(kept, 384)
    for a, b in zip(s, ref):
        assert a == b if isinstance(a, int) else torch.equal(a, b)
    parts = (torch.ones(384, 47), None, None, torch.ones(384))
    for a, b in zip(compaction.wave_scatter(s.pos, parts),
                    compaction.wave_scatter_plain(s.pos, parts)):
        assert (a is None and b is None) or torch.equal(a, b)
    assert (compaction.wave_select.launches,
            compaction.wave_scatter.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        compaction.wave_select(kept.to("meta"), 384)
    with pytest.raises(ValueError, match="budget"):
        compaction.wave_select(kept, 0)
    with pytest.raises(ValueError, match="within the wave"):
        compaction.wave_select(kept, 10, first=3, n_local=2)


@pytest.fixture(scope="module")
def jax_t():
    return JTranscriber()


@pytest.fixture(scope="module")
def port_t():
    return Transcriber(device="cpu")


@pytest.fixture(scope="module")
def wave():
    """Three files at B = 3, one padded, 8 onset slots each; its kept count
    from the reference's exact body."""
    ys = np.stack([riff(dur=3.0), np.pad(riff(dur=2.0), (0, SR)),
                   riff(dur=3.0, notes=((0.3, 330.0), (1.2, 147.0)))])
    nv = np.array([3 * SR, 2 * SR, 3 * SR])
    return ys, nv


@pytest.mark.parametrize("offset", [-3, 0, 2])
def test_build_files_fn_budgets_around_the_kept_count(jax_t, port_t, wave,
                                                      offset):
    """The file body of both packages with a clip budget below, at and
    above the wave's kept count: the same labels, kept masks, onsets,
    times and flags, probs within 1e-2."""
    ys, nv = wave
    mfcc, mel = jax_t._feature_params()
    exact, _ = jax_t._fused_files_fn(SR, 0.5, 8)
    n_kept = int(np.asarray(exact(ys, nv.astype(np.int32))[4]).sum())
    budget = n_kept + offset
    assert 1 <= budget < ys.shape[0] * 8
    run, _ = jax_t._fused_files_fn(SR, 0.5, 8, wave_clip_budget=budget)
    ref = [None if x is None else np.asarray(x)
           for x in run(ys, nv.astype(np.int32))]
    fn = build_files_fn(port_t.predictor, port_t.scaler, port_t.ckpt_sr,
                        mfcc, mel, SR, 0.5, 8, wave_clip_budget=budget)
    got = [None if x is None else x.numpy()
           for x in fn(torch.from_numpy(ys), torch.from_numpy(nv))]
    for i in range(4, 10):  # kept, onsets, times, overflow, fixable, n_det
        np.testing.assert_array_equal(got[i], ref[i])
    kept = got[4]
    assert kept.sum() == min(budget, n_kept)
    assert bool(got[7].any()) == (offset < 0)
    np.testing.assert_array_equal(got[0].argmax(-1)[kept],
                                  ref[0].argmax(-1)[kept])
    for i in range(3):  # blended, mlp and cnn probs, also in empty slots
        np.testing.assert_allclose(got[i], ref[i], atol=1e-2)
    np.testing.assert_allclose(got[3][kept], ref[3][kept], rtol=2e-3)
