"""Live streaming transcription, the twin of `gat_tpu/stream/live.py`.

A producer pushes mono float32 blocks into a 1.5 s ring buffer; the
consumer detects onsets over snapshots of the ring, slices notes between
consecutive onsets (a trailing single onset slices to the ring's end),
pads or trims each to the checkpoint's clip duration, and feeds a bounded
queue whose consumer runs single-clip inference (`transcribe_note`).

* The audio source is an abstraction: `MicSource` (sounddevice, imported
  only when a microphone is asked for), `ArraySource` (replays a waveform
  block by block, for tests and offline runs), or anything with
  `blocks()`.
* The queue drains before it would evict (both drivers run
  process_buffer and drain_queue on one thread); an eviction is counted
  in `queue_drops`, and overwritten ring audio in the ring's
  `overwritten`.

The device work of a poll is one upload of the snapshot, K4 and K5 at hop
1024 over it, and one transfer of the onsets back; each note then runs
the ensemble (K1-K3). All of it stays on the consumer thread: the mic's
callback thread only pushes into the ring.
"""
from __future__ import annotations

import queue
import time

import numpy as np
import torch

from ..config import CLIP_DURATION, TARGET_SR
from ..ops.onset import detect_onsets
from ..utils.device import to_host as _to_host
from .ring import RingBuffer

__all__ = ["ArraySource", "MicSource", "LiveTranscriber"]


class ArraySource:
    """Replays a waveform in fixed-size blocks (a deterministic stand-in
    for the microphone)."""

    def __init__(self, audio: np.ndarray, blocksize: int = 1024):
        self.audio = np.asarray(audio, np.float32)
        self.blocksize = blocksize

    def blocks(self):
        for i in range(0, len(self.audio), self.blocksize):
            yield self.audio[i:i + self.blocksize]


class MicSource:
    """sounddevice InputStream wrapper (ref transcribe_live.py:152-158).
    Raises a clear error when sounddevice is unavailable."""

    def __init__(self, sample_rate: int = TARGET_SR, channels: int = 1,
                 blocksize: int = 1024):
        try:
            import sounddevice  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "[MicSource] sounddevice is not installed; live microphone "
                "capture is unavailable. Use ArraySource for offline "
                "streaming.") from e
        self.sample_rate = sample_rate
        self.channels = channels
        self.blocksize = blocksize

    def stream(self, callback):
        import sounddevice as sd

        def cb(indata, frames, time_info, status):
            if status:
                print(status)
            callback(indata[:, 0].astype(np.float32))

        return sd.InputStream(samplerate=self.sample_rate,
                              channels=self.channels,
                              blocksize=self.blocksize, callback=cb,
                              dtype="float32")


class LiveTranscriber:
    def __init__(self, transcriber=None, buffer_duration: float = 1.5,
                 sample_rate: int = TARGET_SR, blocksize: int = 1024,
                 min_slice_t: float = 0.3, verbose: bool = True):
        if transcriber is None:
            from ..infer import Transcriber
            transcriber = Transcriber()  # on the card
        self.transcriber = transcriber
        self.sample_rate = sample_rate
        self.blocksize = blocksize
        self.buffer = RingBuffer(int(buffer_duration * sample_rate))
        self.note_q: queue.Queue = queue.Queue(maxsize=2)
        self.min_slice_len = int(min_slice_t * sample_rate)
        # clip length follows the CHECKPOINT (the stated source of
        # truth: ckpt clip_length beats config — same rule as
        # ScanStreamer and transcribe_note's fix_length): trimming to
        # the config value would discard the second half of every note
        # for a checkpoint trained on longer clips
        self.clip_duration = float(getattr(transcriber, "clip_length",
                                           CLIP_DURATION))
        # pre-onset audio kept in the ring when a pair-slice clears up to
        # the next onset: the onset detector (hop 1024, n_fft 2048) zeroes
        # its first lag + n_fft//(2·hop) = 2 envelope frames and averages
        # over a 2-frame pre-window — an attack inside that region of a
        # fresh snapshot can never re-trigger, so keep 4 hops of context.
        # Conversely a CONSUMED note's attack must never stay in the ring
        # past the pad horizon, or the next snapshot re-detects and
        # re-slices it (duplicate): clear at least attack_guard past the
        # consumed onset. Both constants are in DETECTOR HOP units
        # (detect_onsets pins hop=1024 and n_fft=2048 independent of the
        # sample rate), so they do not scale with sample_rate — but the
        # min-separation that must cover ctx + guard between two onsets
        # DOES: min_sep is lifted above 0.3 s when the rate is low enough
        # that 0.3 s would no longer fit both (≈ sr < 20.5 kHz), keeping
        # the exactly-once invariant by construction at any rate.
        self._onset_ctx = 4 * 1024
        self._attack_guard = 2 * 1024 + 1
        # ...and to min_slice_t: a pair of onsets closer than the minimum
        # slice length can only ever be discarded (the too-short branch
        # in process_buffer), so detecting both would grind the consumer
        # into re-detect/re-discard loops with ~1-sample forward progress
        # while the ring overruns — keep the detector from reporting
        # pairs the slicer cannot consume (one hop of margin so the
        # strict `len > min_slice_len` check passes at the boundary)
        self._min_sep_s = max(
            0.3, min_slice_t + 1024 / sample_rate,
            (self._onset_ctx + self._attack_guard + 1) / sample_rate)
        # detector RIGHT-EDGE latency: a peak at envelope frame n is only
        # confirmable once post_max/post_avg (≤ 3 frames at hop 1024) and
        # the centered STFT's n_fft/2 look-ahead exist — an attack inside
        # the last ~5 hops of a snapshot is undetectable THIS poll but
        # detectable on the next; 6 hops = one hop of slack on top.
        self._edge_latency = 6 * 1024
        self.verbose = verbose
        self.results: list[dict] = []
        # explicit drop-oldest casualty count: clips evicted from the
        # bounded note queue under backpressure (never silent — pair with
        # buffer.overwritten for the ring side: when the ring never
        # overran, transcribed notes + queue_drops account for every note)
        self.queue_drops = 0

    # ----- segmentation over buffer snapshots --------------------------
    def detect_onsets(self, y: np.ndarray) -> list[int]:
        """Onset samples of one snapshot: uploaded as a (1, n) tensor to
        the Transcriber's device, K4 and K5 at hop 1024, and the onsets
        and their valid mask read back in one transfer."""
        x = torch.from_numpy(np.ascontiguousarray(y, np.float32)).to(
            self.transcriber.device)[None]
        onsets, valid, *_ = detect_onsets(x, sr=self.sample_rate,
                                          hop_length=1024,
                                          min_sep=self._min_sep_s,
                                          max_onsets=64)
        onsets, valid = _to_host((onsets[0], valid[0]))
        return [int(s) for s in onsets[valid]]

    @staticmethod
    def pad_or_trim_audio(y: np.ndarray, target_dur: float,
                          sr: int) -> np.ndarray:
        n = int(target_dur * sr)
        if len(y) >= n:
            return y[:n]
        return np.pad(y, (0, n - len(y)))

    def _enqueue(self, clip: np.ndarray, drain_first: bool = False) -> None:
        """Bounded queue with drop-oldest backpressure; every eviction is
        counted in `queue_drops` (explicit casualty, never silent).

        `drain_first`: run inference on everything already queued before
        enqueueing when the queue is full. ALWAYS on in both drivers:
        process_buffer and drain_queue run on the same (consumer)
        thread — only the mic callback is a separate producer, and it
        feeds the RING, not this queue — so nothing else ever drains
        the queue mid-poll and an eviction here is pure note loss, not
        load-shedding (a poll slicing 3 notes into the maxsize-2 queue
        used to drop the first one even in the deterministic offline
        driver). Real-time overload sheds in the ring instead (oldest
        un-sliced audio is overwritten), which loses less: un-detected
        audio rather than an already-sliced note. The drop-oldest
        fallback below remains as a safety net for external callers
        that enqueue off-thread."""
        if drain_first and self.note_q.full():
            self.drain_queue()
        try:
            self.note_q.put_nowait(clip)
        except queue.Full:
            try:
                self.note_q.get_nowait()
                self.queue_drops += 1
            except queue.Empty:
                pass
            try:
                self.note_q.put_nowait(clip)
            except queue.Full:
                self.queue_drops += 1

    def process_buffer(self, force: bool = False) -> int:
        """One consumer step over a full buffer: slice notes between
        CONSECUTIVE onset pairs (a trailing single onset slices to the
        end), enqueue clips, drop the consumed prefix. Returns clips
        enqueued (ref transcribe_live.py:165-196).

        Deviation by design: the reference's pair loop consumes DISJOINT
        pairs (`del onsets[:2]`, ref transcribe_live.py:185-191) and
        clears through the second onset — so with onsets [a, b, c] it
        slices note a, then discards note b's attack unexamined; at a
        steady note rate every second note is silently lost (measured:
        the 1× real-time soak test transcribed 6/10 notes under the
        reference scheme). Here pair (o[i], o[i+1]) yields note i and the
        buffer is cleared only up to o[i+1] minus a detector-context
        margin (the onset envelope's left-pad latency of
        lag + n_fft//(2·hop) frames plus the moving-average pre-window:
        an onset whose attack lands in the padded first frames of the
        next snapshot is undetectable, so the margin keeps enough
        pre-attack audio for re-detection), so every note is sliced
        exactly once. The same class of latent bug as the ring's
        clear_from (SURVEY §5.2), avoided rather than copied.

        `force=True` (end-of-stream flush) processes a partially filled
        buffer too — otherwise audio shorter than the buffer duration
        would never be examined."""
        if not self.buffer.is_full():
            if not force or self.buffer.size() <= self.min_slice_len:
                return 0
        # atomic (snapshot, absolute start): the mic thread keeps pushing
        # while we detect onsets, so the consumed prefix must be cleared
        # by absolute position, not a snapshot-relative index
        buf, start_abs = self.buffer.snapshot()
        onsets = self.detect_onsets(buf)
        queued = 0
        clear_to = -1  # snapshot index to clear before (exclusive); -1 = none
        # (an onset at index 0 IS consumable: backtracking pins the first
        # frame as a minimum, so after a pairs-clear the next note's onset
        # routinely lands at 0 — a falsy-zero sentinel would never clear
        # it and re-enqueue the same note on every poll)
        # a trailing single onset slices to the buffer end in two cases,
        # decided at ENTRY: (a) it is the only onset (nothing to pair
        # with — the reference's single-onset rule), or (b) this is the
        # end-of-stream flush, where the pairs loop's leftover onset has
        # no next poll to wait for (>=2 onsets at a force flush used to
        # lose the stream's final note). A non-force snapshot with >=2
        # onsets instead leaves its last onset pending: the next poll
        # pairs it. ONE copy of the slice-to-end rule covers both.
        slice_tail = force or len(onsets) == 1
        while len(onsets) >= 2:
            s = buf[onsets[0]:onsets[1]]
            if len(s) > self.min_slice_len:
                self._enqueue(self.pad_or_trim_audio(
                    s, self.clip_duration, self.sample_rate),
                    drain_first=True)
                queued += 1
                # keep detector context BEFORE the next onset, but always
                # clear past the consumed note's attack (re-slice guard);
                # min_sep guarantees ctx + guard fit between two onsets,
                # so forward progress holds
                clear_to = max(onsets[1] - self._onset_ctx,
                               onsets[0] + self._attack_guard)
            else:
                # too-short pseudo-note (only reachable when backtrack
                # compressed a pair below min_slice_len — min_sep is
                # floored at min_slice_t above): discard it, advancing
                # past its attack when that cannot destroy the next
                # onset's detection context, else the minimum 1 sample
                clear_to = max(onsets[0] + 1,
                               min(onsets[0] + self._attack_guard,
                                   onsets[1] - self._onset_ctx))
            del onsets[:1]
        if slice_tail and len(onsets) == 1:
            s = buf[onsets[0]:]
            if len(s) > self.min_slice_len:
                self._enqueue(self.pad_or_trim_audio(
                    s, self.clip_duration, self.sample_rate),
                    drain_first=True)
                queued += 1
                # consume the SLICED region (capped at the clip length
                # actually transcribed): clearing only onset+1 — the
                # reference's h_idx scheme — leaves the attack in the
                # ring, and once it decays past the detector's pad
                # horizon the same note re-triggers on every later
                # snapshot (measured: the final soak note transcribed
                # 3×). The note's own decay can't re-trigger (no rising
                # flux), so exact-once holds. (This clear is always past
                # any pairs-loop clear: min_sep keeps pair clears below
                # the last onset, and this one reaches at least
                # min_slice_len beyond it.)
                clip_n = int(self.clip_duration * self.sample_rate)
                clear_to = min(onsets[0] + max(clip_n, self.min_slice_len),
                               len(buf))
                if not force:
                    # a FOLLOWING note whose attack sits inside the last
                    # edge_latency samples is undetectable this poll —
                    # clearing through it would destroy it (this clip
                    # runs to the buffer end, so its tail may contain
                    # exactly such an attack). Cap the clear so any
                    # not-yet-detectable attack keeps its pre-onset
                    # context for the next snapshot; the attack guard
                    # still wins below it (min_sep ≥ ctx + guard keeps
                    # the two compatible), so the consumed note can
                    # never re-trigger. force=True has no next snapshot.
                    clear_to = max(
                        min(clear_to,
                            len(buf) - self._edge_latency - self._onset_ctx),
                        onsets[0] + self._attack_guard)
        if clear_to >= 0:
            self.buffer.clear_until(start_abs + clear_to)
        return queued

    def inference(self, audio: np.ndarray, sr_in: int | None = None):
        """Single-clip inference + console print
        (ref transcribe_live.py:225-266)."""
        sr_in = sr_in or self.sample_rate
        if audio is None or len(audio) == 0:
            print("[inference] No audio provided.")
            return None
        if audio.size < int(self.clip_duration * sr_in):
            return None
        result = self.transcriber.transcribe_note(audio, sr_in=sr_in)
        self.results.append(result)
        if self.verbose:
            for i, (lab, conf) in enumerate(zip(result["labels"],
                                                result["confidences"])):
                print(f"{i:03d}  {lab:>4}  (conf={conf:.2f})")
        return result

    def drain_queue(self) -> int:
        done = 0
        while True:
            try:
                note = self.note_q.get_nowait()
            except queue.Empty:
                return done
            if note is not None and len(note):
                self.inference(np.asarray(note, np.float32))
                done += 1

    # ----- drivers ------------------------------------------------------
    def run_on_source(self, source) -> list[dict]:
        """Offline/streamed driver: feed blocks, process as the buffer
        fills, drain the queue. Deterministic (no threads) — used by tests
        and file streaming."""
        for block in source.blocks():
            self.buffer.push(block)
            self.process_buffer()
            self.drain_queue()
        # flush whatever remains, including a never-filled buffer
        self.process_buffer(force=True)
        self.drain_queue()
        return self.results

    def live(self, duration: float | None = None):
        """Microphone driver (ref transcribe_live.py:115-222): callback
        thread pushes into the ring; this loop polls, slices, infers."""
        mic = MicSource(self.sample_rate, blocksize=self.blocksize)
        t0 = time.time()
        with mic.stream(self.buffer.push):
            print("Listening to mic... Press Ctrl+C to stop.")
            try:
                while duration is None or time.time() - t0 < duration:
                    try:
                        self.process_buffer()
                        self.drain_queue()
                    except Exception:  # keep the mic loop alive
                        import traceback
                        traceback.print_exc()
                        self.buffer.clear()  # drop state that caused it
                    time.sleep(0.1)
            except KeyboardInterrupt:
                print("Stopping live mic...")
        # mic stopped: flush the partially-filled ring so the session's
        # trailing note(s) are transcribed, not lost — the same
        # end-of-stream rule run_on_source applies (a non-force poll
        # returns 0 whenever the ring is not full, so without this the
        # final note of every live session silently vanished)
        self.process_buffer(force=True)
        self.drain_queue()
        return self.results
