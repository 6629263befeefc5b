"""Audio ring buffer of live capture, the port's copy of
`gat_tpu/stream/ring.py` (numpy on the host; the port imports nothing of
the JAX package, so it keeps its own).

One preallocated float32 array with head and size indices, not the
reference's deque of Python floats. `clear_from(idx)` drops the first idx
samples (the consumed prefix), and `clear_until(abs_pos)` drops by
absolute position, so samples pushed after a consumer's snapshot survive.

Thread model: a producer thread only push()es; the consumer takes
snapshot() copies. A mutex guards the index updates, which numpy does not
make atomic. Samples overwritten before the consumer took them are
counted in `overwritten` and logged in `overwritten_ranges` (absolute
[lo, hi) spans, coalesced, at most 1024), so loss is never silent.
"""
from __future__ import annotations

import threading

import numpy as np

__all__ = ["RingBuffer"]


class RingBuffer:
    def __init__(self, maxlen: int):
        self.maxlen = int(maxlen)
        self._buf = np.zeros(self.maxlen, dtype=np.float32)
        self._start = 0      # index of oldest sample
        self._size = 0
        self._total = 0      # samples ever pushed (absolute position)
        self._lock = threading.Lock()
        # samples lost to producer overrun (overwritten before the
        # consumer took them) — the explicit "drop-oldest casualty"
        # counter: a live session can report exactly how much audio the
        # backpressure discarded instead of losing it silently.
        # `overwritten_ranges` records the absolute [lo, hi) spans, so a
        # consumer can attribute losses to specific stream positions
        # (coalesced; capped at _MAX_RANGES — the count stays exact).
        self.overwritten = 0
        self.overwritten_ranges: list[list[int]] = []

    _MAX_RANGES = 1024

    def _record_overwrite(self, lo: int, hi: int) -> None:
        """Under self._lock: count + range-log one overwrite event."""
        if hi <= lo:
            # a maxlen-sized block landing on a fully-consumed ring
            # overwrites nothing — don't log an empty [lo, lo) span
            return
        self.overwritten += hi - lo
        if self.overwritten_ranges and self.overwritten_ranges[-1][1] == lo:
            self.overwritten_ranges[-1][1] = hi
        else:
            self.overwritten_ranges.append([lo, hi])
            if len(self.overwritten_ranges) > self._MAX_RANGES:
                del self.overwritten_ranges[0]

    def push(self, data: np.ndarray) -> None:
        """Append samples; oldest samples fall off when full (counted in
        `overwritten` — loss is explicit, never silent)."""
        data = np.asarray(data, np.float32).ravel()
        n = len(data)
        if n == 0:
            return
        with self._lock:
            oldest_abs = self._total - self._size
            self._total += n
            if n >= self.maxlen:
                # everything unconsumed is overwritten, plus any prefix of
                # the incoming block that never fits — one contiguous span
                # (buffer end == old total)
                self._record_overwrite(oldest_abs,
                                       self._total - self.maxlen)
                self._buf[:] = data[-self.maxlen:]
                self._start = 0
                self._size = self.maxlen
                return
            end = (self._start + self._size) % self.maxlen
            first = min(n, self.maxlen - end)
            self._buf[end:end + first] = data[:first]
            if n > first:
                self._buf[:n - first] = data[first:]
            overflow = max(0, self._size + n - self.maxlen)
            if overflow:
                self._record_overwrite(oldest_abs, oldest_abs + overflow)
            self._start = (self._start + overflow) % self.maxlen
            self._size = min(self._size + n, self.maxlen)

    def pop(self) -> None:
        """Drop the newest sample (reference surface parity,
        ref transcribe_live.py:51-52). Un-pushes it from the absolute
        position count too, preserving the snapshot()/clear_until()
        invariant (oldest sample's abs position == _total - _size)."""
        with self._lock:
            if self._size:
                self._size -= 1
                self._total -= 1

    def get_buffer(self) -> np.ndarray:
        """Snapshot copy, oldest→newest."""
        return self.snapshot()[0]

    def snapshot(self) -> tuple[np.ndarray, int]:
        """(snapshot copy, absolute position of its first sample) — taken
        atomically, so a consumer can later clear_until() positions from
        THIS snapshot even if the producer pushed meanwhile (a
        snapshot-relative clear_from would drop unconsumed audio that
        slid in during processing)."""
        with self._lock:
            idx = (self._start + np.arange(self._size)) % self.maxlen
            return self._buf[idx].copy(), self._total - self._size

    def get_slice(self, i: int, j: int) -> np.ndarray:
        """Copy of [i, j) in logical (oldest-first) coordinates; empty when
        out of range (ref ring get_slice semantics)."""
        with self._lock:
            if i < 0 or j < i or i > self._size or j > self._size:
                return np.zeros((0,), dtype=np.float32)
            idx = (self._start + np.arange(i, j)) % self.maxlen
            return self._buf[idx].copy()

    def is_full(self) -> bool:
        return self._size == self.maxlen

    def size(self) -> int:
        return self._size

    def clear(self) -> None:
        with self._lock:
            self._start = 0
            self._size = 0

    def clear_from(self, idx: int) -> None:
        """Drop the first `idx` samples (the consumed prefix). NOTE: idx
        is relative to the ring's CURRENT contents — with a concurrent
        producer, prefer clear_until() with a position from snapshot()."""
        with self._lock:
            idx = max(0, min(int(idx), self._size))
            self._start = (self._start + idx) % self.maxlen
            self._size -= idx

    def clear_until(self, abs_pos: int) -> None:
        """Drop every sample whose absolute position (samples ever pushed,
        see snapshot()) is < abs_pos. Safe under concurrent push: samples
        that arrived after the consumer's snapshot are never dropped."""
        with self._lock:
            cur_start = self._total - self._size
            drop = max(0, min(int(abs_pos) - cur_start, self._size))
            self._start = (self._start + drop) % self.maxlen
            self._size -= drop
