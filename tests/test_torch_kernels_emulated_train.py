"""The emulated-kernel tests of K11, the label-smoothed loss, and K12, the
clip with AdamW: the kernels' own source compiled by g++ under
`emulated_kernels.EMULATION_HEADER`, against their plain PyTorch
versions."""
import ctypes

import pytest
import torch

from gat_tpu_torch.ops import loss as loss_mod

from emulated_kernels import (_fn, adamw_emulated, adamw_inputs,
                              adamw_plain_step, check_xent,
                              clip_adamw_grid_emulated, emulated_sms,
                              grid_rule, unaligned, xent_emulated,
                              xent_grid_emulated, xent_grid_rule, xent_inputs,
                              libs_fixture)

libs = libs_fixture(("softmax_xent", "clip_adamw"))


@pytest.mark.parametrize("b, c", [(8, 47), (19, 47), (32, 47), (5, 3),
                                  (32, 3), (3, 70), (32, 70), (64, 47),
                                  (500, 3), (16, 600)])
@pytest.mark.parametrize("scale", [1.0, 0.125])
def test_softmax_xent_kernel_emulated(libs, b, c, scale):
    """The one-block form: the training step's 32 x 47 (8 lanes a row, 6
    classes a lane), fewer classes than lanes, more than two rounds of
    them, two tiles of 32 rows (8 lanes a row), two tiles of 256 rows of 3
    classes (a lane a row) and 600 classes (32 lanes a row, 19 classes a
    lane); no partial slot, fence or ticket."""
    logits, labels = xent_inputs(b, c, seed=b * c)
    assert check_xent(libs, logits, labels, scale)[0] == 1


@pytest.mark.parametrize("b, c, grad", [(1500, 47, True), (2000, 47, False),
                                        (700, 70, True), (1100, 3, False)])
def test_softmax_xent_kernel_emulated_grid_form(libs, b, c, grad):
    """The grid form over 4 emulated SMs: several blocks, each a span of
    double-buffered tiles (1,500 rows: 47 tiles of 32, the last of 28;
    700 x 70: 16 lanes a row, 44 tiles of 16), with and without the
    gradient, the partials added by the last block."""
    logits, labels = xent_inputs(b, c, seed=b + c)
    with emulated_sms(libs, 4, "softmax_xent"):
        grid = check_xent(libs, logits, labels, 1.0 / b, grad)
    assert grid[0] == 4 and -(-b // grid[2]) > grid[0]


@pytest.mark.parametrize("b, sms", [(32, 4), (1500, 4), (1500, 1)])
def test_softmax_xent_kernel_emulated_unaligned(libs, b, sms):
    """Logits as a view one row in (188 bytes: off 16) take the element
    route of the same kernels; one SM gives the grid form one block, which
    writes the results itself."""
    logits, labels = xent_inputs(b + 1, 47, seed=b)
    view, labels = logits[1:], labels[1:]
    assert view.data_ptr() % 16 != 0
    view[0, [1, 46]] = view[0].max() + 1.0
    with emulated_sms(libs, sms, "softmax_xent"):
        grid = check_xent(libs, view, labels, 1.0 / b)
    assert grid[0] == (1 if b == 32 or sms == 1 else 4)


@pytest.mark.parametrize("b, sms", [(21, 4), (1500, 4)])
def test_softmax_xent_kernel_emulated_eval_form(libs, b, sms):
    """Without a gradient (the eval step) the launch writes none and gives
    the same loss, count and argmaxes, in both forms."""
    logits, labels = xent_inputs(b, 47, seed=5)
    with emulated_sms(libs, sms, "softmax_xent"):
        with_grad = xent_emulated(libs, logits, labels, 0.05, 1.0)
        without = xent_emulated(libs, logits, labels, 0.05, 1.0, grad=False)
    assert without[2] is None
    assert torch.equal(with_grad[0], without[0])
    assert torch.equal(with_grad[1], without[1])
    assert torch.equal(with_grad[3], without[3])


def test_softmax_xent_grid(libs):
    """gat_softmax_xent_grid follows the rule at the emulated SMs, and the
    rule gives the card's launches: the step one block of 32 rows at 8
    lanes, an eval chunk 2,048 tiles of 32 rows over 528 blocks at 4
    resident a SM; the C entry points refuse what the wrapper refuses."""
    for sms in (1, 4, 132):
        with emulated_sms(libs, sms, "softmax_xent"):
            for b, c in ((1, 47), (32, 47), (128, 47), (129, 47),
                         (65536, 47), (7, 300), (2000, 1000), (40, 1024)):
                got = xent_grid_emulated(libs, b, c)
                assert [got[0], got[2], got[3]] == xent_grid_rule(b, c, sms,
                                                                  1), (b, c)
    assert xent_grid_rule(32, 47, 132, 4) == [1, 32, 8]
    assert xent_grid_rule(65536, 47, 132, 4) == [528, 32, 8]
    grid_fn = _fn(libs["softmax_xent"], "gat_softmax_xent_grid",
                  loss_mod._GRID_ARGS)
    out = (ctypes.c_int * 5)()
    for b, c in ((0, 47), (4, 0), (4, loss_mod.MAX_CLASSES + 1)):
        assert grid_fn(b, c, ctypes.addressof(out)) != 0
    fn = _fn(libs["softmax_xent"], "gat_softmax_xent", loss_mod._ARGS)
    for blocks, rows, lanes in ((2, 32, 8), (1, 6, 8), (1, 256, 3),
                                (1, 256, 1)):
        assert fn(*[None] * 9, 600, 47, 0.05, 1.0, blocks, rows, lanes,
                  None) != 0  # no partials; rows not of 4; lanes not 2^k;
        # more than 32 classes a lane
    with pytest.raises(ValueError, match="at most"):
        loss_mod.check_kernel(torch.zeros(2, loss_mod.MAX_CLASSES + 1),
                              torch.zeros(2, dtype=torch.int64))
    loss_mod.check_kernel(torch.zeros(2, loss_mod.MAX_CLASSES),
                          torch.zeros(2, dtype=torch.int64))


@pytest.mark.parametrize("n", [300, 5000])
@pytest.mark.parametrize("g_scale, max_norm", [(0.1, 1.0), (10.0, 1.0),
                                               (10.0, None)])
def test_clip_adamw_kernel_emulated(libs, n, g_scale, max_norm):
    """Three steps, the learning rate changed after the first, below the
    clip threshold, above it, and without a clip; one block (300) and
    three (5000). The norm within 1e-6 relative (other summation orders),
    p, mu, nu and the clipped gradients within 2e-6 relative (powf against
    torch.pow, and the norm's last bit through the clip) and 2e-7 of each
    buffer's largest value (about an ulp of it, where (1 - b1)·g + b1·mu
    cancels); the count exact. A second run from the same buffers gives
    the same bits."""
    got = adamw_inputs(n, seed=n, g_scale=g_scale)
    again = {k: v.clone() for k, v in got.items()}
    ref = {k: v.clone() for k, v in got.items()}
    counts = [torch.zeros((), dtype=torch.int32) for _ in range(3)]
    lr = torch.tensor(1e-3)
    for step in range(3):
        if step == 1:
            lr.fill_(3e-4)
        if step:
            for st in (got, again, ref):  # a fresh gradient a step
                st["g"].copy_(adamw_inputs(n, seed=n + step,
                                           g_scale=g_scale)["g"])
        norm = adamw_emulated(libs, got, counts[0], lr, max_norm)
        assert torch.equal(adamw_emulated(libs, again, counts[2], lr,
                                          max_norm), norm)
        ref_norm = adamw_plain_step(ref, counts[1], lr, max_norm)
        torch.testing.assert_close(norm, ref_norm, rtol=1e-6, atol=0)
        assert int(counts[0]) == int(counts[1]) == step + 1
        for k in ("p", "g", "mu", "nu"):
            assert torch.equal(got[k], again[k]), k
            torch.testing.assert_close(
                got[k], ref[k], rtol=2e-6,
                atol=2e-7 * float(ref[k].abs().max()),
                msg=lambda m, k=k: f"{k}: {m}")
    clipped = max_norm is not None and float(ref_norm) >= max_norm
    assert clipped == (g_scale > 1.0 and max_norm is not None)


@pytest.mark.parametrize("n, offset", [(1001, 0), (5002, 0), (20143, 0),
                                       (20143, 1)])
@pytest.mark.parametrize("g_scale", [0.1, 10.0])
def test_clip_adamw_kernel_emulated_tails(libs, n, offset, g_scale):
    """K12 at n mod 4 = 1, 2 and 3 (20,143: the shipped MLP's count), the
    last n mod 4 parameters taken one by one after the float4 loads, and
    over views one float off a 16-byte boundary (the element route), below
    and above the clip threshold (max_norm 1). The first step's pass 2
    gives the bits of `adamw_update_plain` given the kernel's norm (at
    count 1 powf and torch.pow both give b exactly, and every other step
    rounds alike); two more steps, the learning rate changed, within
    `test_clip_adamw_kernel_emulated`'s tolerances. Two runs give the same
    bits."""
    base = adamw_inputs(n, seed=n + offset, g_scale=g_scale)
    runs = [unaligned(base) if offset else {k: v.clone()
                                             for k, v in base.items()}
            for _ in range(2)]
    ref = {k: v.clone() for k, v in base.items()}
    counts = [torch.zeros((), dtype=torch.int32) for _ in range(3)]
    lr = torch.tensor(1e-3)
    for step in range(3):
        if step == 1:
            lr.fill_(3e-4)
        if step:
            g = adamw_inputs(n, seed=n + offset + step, g_scale=g_scale)["g"]
            for st in (*runs, ref):
                st["g"].copy_(g)
        norms = [adamw_emulated(libs, st, k, lr, 1.0)
                 for st, k in zip(runs, counts)]
        assert torch.equal(norms[0], norms[1])
        if step == 0:  # the same norm and the same rounding: the same bits
            adamw_plain_step(ref, counts[2], lr, 1.0, norm=norms[0].clone())
            for k in ("p", "g", "mu", "nu"):
                assert torch.equal(runs[0][k], ref[k]), k
        else:
            ref_norm = adamw_plain_step(ref, counts[2], lr, 1.0)
            torch.testing.assert_close(norms[0], ref_norm, rtol=1e-6, atol=0)
            for k in ("p", "g", "mu", "nu"):
                torch.testing.assert_close(
                    runs[0][k], ref[k], rtol=2e-6,
                    atol=2e-7 * float(ref[k].abs().max()),
                    msg=lambda m, k=k: f"{k}: {m}")
        for k in ("p", "g", "mu", "nu"):
            assert torch.equal(runs[0][k], runs[1][k]), k
        assert int(counts[0]) == int(counts[1]) == int(counts[2]) == step + 1


def test_clip_adamw_grid(libs):
    """gat_clip_adamw_grid sizes both passes to the card by the rule, at
    the shipped CNN's and MLP's parameter counts and the emulated SMs: a
    card's worth of blocks for the CNN, one round of loads over as many
    blocks as there are 256 float4 of the MLP's (20 on 132 SMs)."""
    for sms in (4, 132):
        with emulated_sms(libs, sms, "clip_adamw"):
            for n in (629743, 20143, 1):
                items = -(-n // 4)
                assert clip_adamw_grid_emulated(libs, n) == [
                    grid_rule(items, 4, sms, 1), 1, grid_rule(items, 2, sms,
                                                              1), 1]
    # the card's rule: 132 SMs, 8 resident blocks of 256 threads
    assert grid_rule(-(-20143 // 4), 2, 132, 8) == 20
    assert grid_rule(-(-629743 // 4), 2, 132, 8) == 308
    assert grid_rule(-(-629743 // 4), 4, 132, 8) == 154
