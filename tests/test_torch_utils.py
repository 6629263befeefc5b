"""The port's host utilities, `gat_tpu_torch/utils/{profiling,logging}.py`:
StageTimer's `block_on` semantics (a tensor, a tuple of them, or a
callable evaluated at exit; no wait on the exception path), the trace
context, and the log line formats of `gat_tpu.utils.logging`."""
import logging

import pytest
import torch

from gat_tpu.utils import logging as jlogging
from gat_tpu_torch.utils import logging as tlogging
from gat_tpu_torch.utils import profiling


def test_stage_timer_callable_block_on_sees_tensors_made_inside():
    timer = profiling.StageTimer()
    seen = []

    def block_on():
        seen.append(out)
        return out

    with timer.stage("fwd", block_on=block_on):
        out = torch.ones(3) * 2
    assert seen and seen[0] is out
    with timer.stage("fwd", block_on=(out, [out + 1])):
        pass
    assert timer.counts == {"fwd": 2} and timer.totals["fwd"] >= 0.0
    assert "fwd" in timer.summary()


def test_stage_timer_keeps_the_blocks_exception():
    """A block that raises before making its tensors: the `lambda: out`
    is never evaluated, the caller's exception is the one raised, and the
    stage is still counted."""
    timer = profiling.StageTimer()
    with pytest.raises(KeyError, match="real failure"):
        with timer.stage("broken", block_on=lambda: out):  # noqa: F821
            raise KeyError("real failure")
    assert timer.counts == {"broken": 1}


def test_stage_timer_waits_only_for_cuda_tensors(monkeypatch):
    """CPU tensors never touch the CUDA stream."""
    def no_stream(*a, **kw):
        raise AssertionError("waited on a CUDA stream for CPU tensors")
    monkeypatch.setattr(torch.cuda, "current_stream", no_stream)
    timer = profiling.StageTimer()
    with timer.stage("cpu", block_on=lambda: (torch.zeros(2), None)):
        pass
    assert timer.counts == {"cpu": 1}


def test_device_trace_and_annotate(tmp_path):
    with profiling.device_trace(tmp_path / "trace") as d:
        with profiling.annotate("work"):
            torch.ones(8).sum()
    assert d == str(tmp_path / "trace")
    assert any((tmp_path / "trace").iterdir())


def test_log_lines_match_jax(capsys):
    """The same `[tag] message` and `step=... key=value` lines as the JAX
    package writes."""
    out = []
    for mod, name in ((tlogging, "port_test"), (jlogging, "jax_test")):
        logger = mod.get_logger(name, logging.INFO)
        mod.tag_print("detect_onsets", "3 onsets", 0.5, logger=logger)
        mod.log_metrics(3, logger=logger, loss=0.12345678, acc=1, tag="x")
        out.append(capsys.readouterr().out.splitlines())
    assert out[0] == out[1] == ["[detect_onsets] 3 onsets 0.5",
                                "step=3 loss=0.123457 acc=1 tag=x"]
    assert tlogging.get_logger().name == "gat_tpu_torch"
