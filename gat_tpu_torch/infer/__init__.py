"""Inference API of the port."""
from .predictor import NotePredictor  # noqa: F401
from .transcriber import Transcriber  # noqa: F401
