"""The emulated-kernel tests of K10, the wave's clip-budget compaction: the
kernels' own source compiled by g++ under
`emulated_kernels.EMULATION_HEADER`, against their plain PyTorch
versions."""
import ctypes
import re

import numpy as np
import pytest
import torch

from gat_tpu_torch import kernels
from gat_tpu_torch.ops import compaction

from emulated_kernels import (COMPACT_TILE, WAVE_SHAPES, WAVE_SHAPES_PAST, _fn,
                              check_selection, compact_grid_rule, emulated_sms,
                              scatter_parts, wave_flags, wave_kept,
                              wave_scatter_emulated, wave_select_emulated,
                              libs_fixture)

libs = libs_fixture(("wave_compact",))


@pytest.mark.parametrize("shape", WAVE_SHAPES + WAVE_SHAPES_PAST)
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_wave_select_emulated(libs, shape, density):
    """Random budgets (1, below, at and above the kept count, all slots)
    and densities: K10's selection equal to the plain one, field by
    field, sel in the reference's order."""
    n_files, k = shape
    kept = wave_kept(n_files, k, density, seed=n_files * k)
    n_kept = int(kept.sum())
    rng = np.random.default_rng(7)
    budgets = {1, max(1, n_kept - 1), max(1, n_kept), n_kept + 1,
               n_files * k, int(rng.integers(1, n_files * k + 1))}
    ovf, fix = wave_flags(n_files, n_files * k)
    for budget in sorted(budgets):
        check_selection(
            wave_select_emulated(libs, kept, budget, overflow=ovf,
                                 fixable=fix),
            compaction.wave_select_plain(kept, budget, overflow=ovf,
                                         fixable=fix))


@pytest.mark.parametrize("shape, world, density", [
    ((4, 112), 2, 0.2), ((4, 112), 4, 0.9), ((8, 112), 8, 0.5),
    ((64, 64), 4, 0.3), ((6, 7), 3, 0.6), ((90, 100), 3, 0.5),
    ((64, 112), 4, 0.6), ((64, 129), 2, 0.6), ((8200, 2), 2, 0.5)])
def test_wave_select_emulated_mesh(libs, shape, world, density):
    """Each rank's (first, n_local) of the whole wave's kept bits: its
    slots of the wave's selection, in the same order, equal to the plain
    code's sel[(sel >= first·K) & (sel < (first + b)·K)] - first·K; a rank
    none of whose slots is picked gets n_sel 0."""
    n_files, k = shape
    kept = wave_kept(n_files, k, density, seed=world)
    b = n_files // world
    for budget in (1, max(1, int(kept.sum()) // 2), n_files * k - 1):
        whole = compaction.wave_select_plain(kept, budget).sel.long()
        for rank in range(world):
            first = rank * b
            ref = compaction.wave_select_plain(kept, budget, first, b)
            want = whole[(whole >= first * k) & (whole < (first + b) * k)]
            assert torch.equal(ref.sel.long(), want - first * k)
            check_selection(wave_select_emulated(libs, kept, budget, first,
                                                 b), ref)
    # budget 1 with slot 0 of file 0 kept: only rank 0 picks a slot
    kept[0, 0] = True
    assert [wave_select_emulated(libs, kept, 1, r * b, b).n_sel
            for r in range(world)] == [1] + [0] * (world - 1)


@pytest.mark.parametrize("shape, c, density, budget", [
    ((1, 1), 47, 1.0, 1), ((4, 112), 47, 0.3, 384), ((4, 112), 47, 0.9, 1),
    ((41, 100), 1, 0.5, 3000), ((6, 7), 5, 0.4, 42), ((6, 7), 5, 0.0, 9),
    ((64, 112), 47, 0.6, 5376), ((64, 112), 33, 0.5, 100)])
def test_wave_scatter_emulated(libs, shape, c, density, budget):
    """The compact outputs back at their slots, zeros elsewhere: bit-equal
    to the plain scatter (a copy), with a dummy row past n_sel unread."""
    n_files, k = shape
    kept = wave_kept(n_files, k, density, seed=c)
    s = compaction.wave_select_plain(kept, budget)
    parts = scatter_parts(s.n_sel + 1, c, seed=budget)
    got = wave_scatter_emulated(libs, s.pos, parts)
    ref = compaction.wave_scatter_plain(s.pos, parts)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("cnn, mlp", [(False, True), (True, False),
                                      (False, False)])
def test_wave_scatter_emulated_missing_parts(libs, cnn, mlp):
    """A build without a CNN or an MLP passes None for its probs: no output
    for that part, the others as the plain scatter."""
    kept = wave_kept(6, 7, 0.4, seed=3)
    s = compaction.wave_select_plain(kept, 30)
    parts = scatter_parts(s.n_sel, 47, seed=3, cnn=cnn, mlp=mlp)
    got = wave_scatter_emulated(libs, s.pos, parts)
    ref = compaction.wave_scatter_plain(s.pos, parts)
    for g, r in zip(got, ref):
        assert (g is None and r is None) or torch.equal(g, r)


def test_wave_compact_grid(libs):
    """gat_wave_compact_grid follows the rule at the emulated SMs (one
    resident block an SM): the serving wave and 64 files one tile, past
    8,192 slots several; the scatter's grid the rows' warps up to the
    SMs'."""
    fn = _fn(libs["wave_compact"], "gat_wave_compact_grid",
             compaction._GRID_ARGS)
    out = (ctypes.c_int * 4)()
    for sms in (1, 4, 132):
        with emulated_sms(libs, sms, "wave_compact"):
            for shape in WAVE_SHAPES + WAVE_SHAPES_PAST:
                assert fn(*shape, ctypes.addressof(out)) == 0
                assert list(out) == compact_grid_rule(*shape, sms, 1), shape
    assert compact_grid_rule(4, 112, 132, 8)[::2] == [1, 56]
    assert compact_grid_rule(64, 112, 132, 8)[::2] == [1, 896]
    assert compact_grid_rule(83, 100, 132, 8)[0] == 2
    assert fn(0, 4, ctypes.addressof(out)) != 0


def test_wave_compact_refusals(libs):
    """The C entry points refuse what the wrappers' guards refuse."""
    sel_fn = _fn(libs["wave_compact"], "gat_wave_select",
                 compaction._SELECT_ARGS)
    for n_files, k, budget, first, n_local in ((0, 4, 1, 0, 0),
                                               (2, 4, 0, 0, 2),
                                               (2, 4, 1, 1, 2),
                                               (2, 4, 1, 0, 0)):
        assert sel_fn(*[None] * 10, n_files, k, budget, first, n_local,
                      None) != 0
        with pytest.raises(ValueError):
            compaction.check_select(torch.zeros(n_files, k, dtype=torch.bool),
                                    budget, first, n_local)
    scatter_fn = _fn(libs["wave_compact"], "gat_wave_scatter",
                     compaction._SCATTER_ARGS)
    assert scatter_fn(*[None] * 9, 0, 47, None) != 0
    assert scatter_fn(*[None] * 9, 4, 0, None) != 0


def test_wave_compact_constants_match_kernel():
    """`compaction.MAX_SLOTS` leaves the selection's last tile of kTile
    positions inside int32, as its C entry point refuses the rest; a tile
    is whole words of 32 positions."""
    src = (kernels.CSRC / "wave_compact.cu").read_text()
    tile = int(re.search(r"kTile = (\d+);", src)[1])
    assert tile == COMPACT_TILE and tile % 32 == 0
    assert compaction.MAX_SLOTS == 2 ** 31 - 1 - tile
    with pytest.raises(ValueError, match="at most"):
        compaction.check_select(torch.zeros(1, 1, dtype=torch.bool).expand(
            compaction.MAX_SLOTS + 1, 1), 1, 0, 1)
