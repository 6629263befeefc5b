"""Streaming transcription of the port: the live ring-buffer engine and
the chunked offline engine."""
from .ring import RingBuffer  # noqa: F401
from .live import LiveTranscriber, ArraySource, MicSource  # noqa: F401
from .scan import ScanStreamer  # noqa: F401
