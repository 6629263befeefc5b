"""Logging of the port with the reference's `[function]` tag convention,
the twin of `gat_tpu/utils/logging.py`: the reference's console format
(`[tag] message`) routed through the stdlib logging stack, so levels,
handlers and files work, and a metrics emitter that writes one flat
`key=value` line per step.
"""
from __future__ import annotations

import logging
import sys

__all__ = ["get_logger", "tag_print", "log_metrics"]

_FORMAT = "%(message)s"


def get_logger(name: str = "gat_tpu_torch", level: int = logging.INFO
               ) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = False
    return logger


def tag_print(tag: str, *parts, logger: logging.Logger | None = None):
    """`[tag] message` — the reference's console convention."""
    msg = f"[{tag}] " + " ".join(str(p) for p in parts)
    (logger or get_logger()).info(msg)


def log_metrics(step: int | str, logger: logging.Logger | None = None,
                **metrics):
    """One flat metrics line: `step=3 loss=0.1234 acc=0.9876`."""
    body = " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in metrics.items())
    (logger or get_logger()).info(f"step={step} {body}")
