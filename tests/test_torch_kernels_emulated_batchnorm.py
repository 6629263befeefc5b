"""The emulated-kernel tests of K13, the train-mode BatchNorm: the kernels'
own source compiled by g++ under `emulated_kernels.EMULATION_HEADER`,
against their plain PyTorch versions."""
import ctypes
import itertools

import pytest
import torch

from gat_tpu_torch.ops import batchnorm

from emulated_kernels import (BN_CNN_LAYERS, BN_LAYOUT_CASES, _fn, bn_inputs,
                              bn_layout_case, bn_splits_rule, check_bn_runs,
                              emulated_sms, libs_fixture)

libs = libs_fixture(("batchnorm_train",))


@pytest.mark.parametrize("shape, channels_last", [
    ((3, 4, 5, 6), False), ((3, 4, 5, 6), True), ((4, 2, 48, 48), False),
    ((4, 4, 48, 48), True), ((2, 3, 4, 5), True), ((2, 8, 1, 7), False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_kernels_emulated(libs, shape, channels_last, dtype):
    """K13's moments, apply, apply-backward and moments-backward against
    the plain version and its autograd (`check_bn_runs`): NCHW (the runs
    map; 16-byte loads along 2,304 positions, one element a load along 30
    and 7), channels-last (the rows map: 4 channels, fewer than a 16-byte
    load of bfloat16 holds), channels-last with 3 channels (which does not
    divide 256: the runs map over channels-last strides) and H = 1."""
    d = bn_inputs(shape, seed=sum(shape), dtype=dtype,
                  channels_last=channels_last)
    check_bn_runs(libs, d, dtype)


@pytest.mark.parametrize("shape", BN_CNN_LAYERS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_kernels_emulated_cnn_layers(libs, shape, dtype):
    """K13 at the shipped CNN's channel widths and image sizes, dense
    channels-last as cuDNN gives them (the rows map, 16-byte loads), on an
    emulated card of 8 SMs, so the sums span 8 blocks and several rounds
    of loads (`check_bn_runs`)."""
    d = bn_inputs(shape, seed=sum(shape), dtype=dtype, channels_last=True)
    with emulated_sms(libs, 8, "batchnorm_train"):
        check_bn_runs(libs, d, dtype)


@pytest.mark.parametrize("case", BN_LAYOUT_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batchnorm_kernels_emulated_other_layouts(libs, case, dtype):
    """K13 off the rows map's 16-byte route (`bn_layout_case`):
    contiguous NCHW (2, 8, 64, 22) (the runs map, 16-byte loads along
    1,408 positions); an incoming gradient expanded from one image (1, C,
    H, W), stride 0 along N, at the same shape: beside channels-last x
    the backward kernels take the runs map, one element a load, beside
    NCHW x the runs map's 16-byte loads; and channels-last tensors one
    element past a 16-byte boundary at the second layer (2, 64, 32, 11)
    (the rows map, one element a load, 64 channels over two warps'
    lanes). `check_bn_runs` on an emulated card of 2 SMs."""
    d = bn_layout_case(case, dtype)
    with emulated_sms(libs, 2, "batchnorm_train"):
        check_bn_runs(libs, d, dtype)


def test_batchnorm_layout_refusals():
    """The wrappers' guard refuses what the kernels cannot read in place:
    a 3-D tensor, positions not p·stride(W) apart, and for an output's
    layout a tensor neither contiguous nor channels-last; an incoming
    gradient may be expanded."""
    x = torch.zeros(2, 3, 4, 5)
    assert batchnorm.layout(x) == ((60, 20, 1), False)
    assert batchnorm.layout(x.contiguous(memory_format=torch.channels_last)
                            )[1] is False  # 3 channels: the NCHW map
    assert batchnorm.layout(torch.zeros(2, 4, 4, 5).contiguous(
        memory_format=torch.channels_last)) == ((80, 1, 4), True)
    with pytest.raises(ValueError):
        batchnorm.layout(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError):
        batchnorm.layout(torch.zeros(2, 3, 5, 4).transpose(2, 3))
    with pytest.raises(ValueError):
        batchnorm.layout(torch.zeros(3, 2, 4, 5).transpose(0, 1))
    expanded = torch.ones(()).expand(2, 3, 4, 5)
    assert batchnorm.layout(expanded, read_only=True) == ((0, 0, 0), False)


def test_batchnorm_splits(libs):
    """gat_bn_splits sizes the grid to the card (`bn_splits_rule`): the
    rows map's blocks, or the runs map's splits of each channel, follow the
    rule at 4 and 132 emulated SMs for the shipped CNN's three layers at a
    step of 32 clips, both dtypes, with and without the summing kernels'
    cap; on the card's 132 SMs and 8 resident blocks the bfloat16 layers
    take 176, 132 and 132 blocks in the elementwise kernels (every SM,
    where the first design took 176, 88 and 40) and 176, 128 and 64 in the
    two that sum; channels-last with C not dividing 256 is refused (-1)."""
    fn = _fn(libs["batchnorm_train"], "gat_bn_splits",
             [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 3)
    layers = ((32, 45056), (64, 11264), (128, 2560))
    for sms in (4, 132):
        with emulated_sms(libs, sms, "batchnorm_train"):
            for c, m in layers + ((3, 9000),):
                for last, bf16, sums in itertools.product((0, 1), repeat=3):
                    if last and c == 3:
                        continue
                    assert fn(c, m, last, bf16, sums) == bn_splits_rule(
                        c, m, last, bf16, sms, 1, sums)
            assert fn(3, 1000, 1, 0, 0) == -1 and fn(3, 1000, 0, 0, 1) >= 1
            assert fn(4, 0, 0, 0, 0) == -1
    assert [[bn_splits_rule(c, m, True, 1, 132, 8, sums) for c, m in layers]
            for sums in (False, True)] == [[176, 132, 132], [176, 128, 64]]
