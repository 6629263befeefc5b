#!/usr/bin/env python
"""Transcription service of the port: watch a directory, or answer HTTP
requests, and emit JSON results.

New `.wav` files dropped into `--in_dir` are transcribed with the shipped
ensemble and a `<stem>.json` result (labels, confidences, onsets, YIN
baseline, onset_overflow) is written to `--out_dir`. Files are processed
in arrival waves; a file is picked up only once its size is stable
across two polls, so a WAV still being copied in is never transcribed as
a truncated prefix. `--batch N` sends waves of N files through
`Transcriber.transcribe_files`.

`--http PORT` serves the same transcription over HTTP (stdlib only):
`POST /transcribe` with a `.wav` body returns the result JSON,
`GET /healthz` reports liveness, `GET /metrics` counts requests and
dispatches.

The Transcriber runs on the CUDA card unless `--device cpu` is given.

Usage (`gat-torch-serve` once installed, or `python -m gat_tpu_torch.serve`
from a checkout):
    python -m gat_tpu_torch.serve --in_dir incoming/ --out_dir results/
    python -m gat_tpu_torch.serve --in_dir incoming/ --out_dir results/ --once
    python -m gat_tpu_torch.serve --http 8080 --http_batch 4 --warmup 4,60
    torchrun --nproc-per-node 4 -m gat_tpu_torch.serve --mesh 4 --batch 8 \
        --in_dir incoming/ --out_dir results/

`--mesh N` serves data-parallel over N ranks (`Transcriber(mesh=)`):
rank 0 owns the watch folder or the HTTP front and broadcasts each wave's
paths; every rank transcribes its share of the wave's files and all get
the gathered results, the single-device ones. Without torchrun, N ranks
are started here.
"""
from __future__ import annotations

import argparse
import json
import signal
import time
from pathlib import Path


def result_to_json(result: dict) -> dict:
    return {
        "labels": list(result["labels"]),
        "confidences": [float(c) for c in result["confidences"]],
        "onsets_s": [float(t) for t in result.get("onsets_s", [])],
        "yin": [{"pitch_hz": hz, **info}
                for hz, info in result.get("dsp_info", [])],
        # true when an onset budget truncated the detections (the
        # earliest kept): the label list is then not exhaustive
        "onset_overflow": bool(result.get("onset_overflow", False)),
    }


def _sync(device) -> None:
    """Wait for the card when the work ran on one."""
    import torch
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def warmup(t, durations_s, batch: int = 1, cand_budget: int | None = None,
           verbose: bool = True, warm_onset_caps: int = 0) -> None:
    """Run the serving shapes once before traffic arrives.

    On the card the kernels are built first (`kernels.build()`). Then, for
    each requested duration, `batch` pluck WAVs go through the calls the
    server makes: `transcribe_files` at every power-of-two wave size from
    2 up to `batch` (a partial wave pads B to the next power of two; a
    wave of one goes through `transcribe`), and the full wave when
    `batch` is not a power of two; the exact-fallback body at those B
    (up to `DEFAULT_MAX_BATCH`) and its chunks of K waves; with
    `warm_onset_caps`, the cap re-run bodies at max_onsets 128, 256, ...
    up to it; and `transcribe` with its exact re-segmentation. The
    exact and cap bodies are called directly, since single-pluck files
    never raise their flags. On the card this settles cuDNN's algorithm
    choice and the caching allocator at those shapes."""
    import tempfile

    import numpy as np
    import torch

    from .config import DEFAULT_MAX_BATCH, DEFAULT_MAX_ONSETS, TARGET_SR
    from .data.synth import karplus_strong
    from .infer.transcriber import bucket_seconds
    from .utils.wavio import write_wav

    device = getattr(t, "device", None)
    if device is not None and torch.device(device).type == "cuda":
        from . import kernels
        kernels.build()
    dev = device if device is not None else "cpu"
    sr = TARGET_SR
    with tempfile.TemporaryDirectory() as td:
        for dur in durations_s:
            y = np.zeros(int(float(dur) * sr), np.float32)
            p = np.asarray(karplus_strong(196.0, sr, min(0.5, float(dur)),
                                          seed=7), np.float32)[0]
            fade = max(1, int(0.3 * len(p)))
            p[-fade:] *= np.linspace(1, 0, fade, dtype=np.float32)
            y[: len(p)] += p
            paths = []
            for b in range(max(int(batch), 1)):
                wav = Path(td) / f"warm_{dur:g}_{b}.wav"
                write_wav(wav, y, sr)
                paths.append(wav)
            t0 = time.perf_counter()
            if batch > 1:
                warmed_bs = []
                b = 2
                while b <= batch:
                    t.transcribe_files(paths[:b], cand_budget=cand_budget)
                    warmed_bs.append(b)
                    b *= 2
                if batch & (batch - 1):
                    t.transcribe_files(paths, cand_budget=cand_budget)
                    warmed_bs.append(1 << (int(batch) - 1).bit_length())
                bsec = bucket_seconds(dur)
                yb = np.zeros(bsec * sr, np.float32)
                yb[: len(y)] = y
                mb = 1 << (DEFAULT_MAX_BATCH - 1).bit_length()
                # under a mesh every wave is a multiple of the data size
                # (transcribe_files rounds max_batch and pads B up to it)
                dp = max(1, int(getattr(t, "_data_par", 1)))
                mb = -(-mb // dp) * dp

                def wave(n_files: int, *lead: int):
                    ys = torch.from_numpy(np.stack([yb] * n_files)).to(dev)
                    nvs = torch.full((n_files,), len(y), dtype=torch.int64,
                                     device=dev)
                    return (ys.reshape(*lead, -1, len(yb)),
                            nvs.reshape(*lead, -1))
                exact_run, exact_scan = t._files_fn(
                    sr, t.clip_length, DEFAULT_MAX_ONSETS, None, 0)
                # transcribe_files caps each wave at max_batch: a larger B
                # never reaches the exact body outside a chunk of waves
                for b in sorted({-(-b // dp) * dp for b in warmed_bs}):
                    if b <= mb:
                        exact_run(*wave(b))
                k = 2
                while k * mb <= batch:
                    exact_scan(*wave(k * mb, k))
                    k *= 2
                m = 128
                while warm_onset_caps and m <= int(warm_onset_caps):
                    cap_run, _ = t._files_fn(sr, t.clip_length, m, None, 0)
                    # B = 2 (or the data size) is the floor a lone file
                    # rides
                    cap_run(*wave(-(-2 // dp) * dp))
                    m *= 2
                _sync(device)
            try:
                t.transcribe(paths[0])
                # the single-file exact re-segmentation's shape
                t.transcribe(paths[0], cand_budget=0)
            except ValueError:
                pass  # the shapes ran; a warm file's result does not matter
            _sync(device)
            if verbose:
                print(f"[serve] warmed {float(dur):g}s x{batch} "
                      f"({time.perf_counter() - t0:.1f}s)")


def serve(in_dir: Path, out_dir: Path, once: bool = False,
          poll_s: float = 0.5, transcriber=None, verbose: bool = True,
          batch: int = 1, cand_budget: int | None = None,
          archive_dir: Path | None = None, poll_hook=None):
    """Watch-folder loop; returns the count of files processed.

    `archive_dir` moves each processed input there, so `in_dir`, and the
    cost of each poll's scan, stays bounded by the arrival rate on a
    long-running deployment. Without it, processed files stay in `in_dir`
    and are skipped through a `done` set, pruned each poll to what the
    directory holds (deleting a processed file frees its entry; dropping
    the same name again processes it again). `poll_hook` is called after
    every poll with the running count; returning True stops the loop."""
    from .infer import Transcriber
    t = transcriber or Transcriber()
    in_dir.mkdir(parents=True, exist_ok=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    if archive_dir is not None:
        archive_dir.mkdir(parents=True, exist_ok=True)
        if archive_dir.resolve() == in_dir.resolve():
            # a move onto the same path does nothing, so the file would
            # be processed again on every poll
            raise ValueError("[serve] --archive_dir must differ from "
                             "--in_dir (moving a file onto itself is a "
                             "no-op and the file would be reprocessed "
                             "each poll)")
    done: set[str] = set()
    # copy-stability gate: the decoders read a truncated data chunk
    # without complaint, so a file still being copied in would give a
    # clean result for a prefix and be marked done. A file is eligible
    # once its size did not change since the previous poll (not under
    # `once`: one pass over a static directory has nothing to wait for).
    seen_size: dict[str, int] = {}
    stop = {"flag": False}

    def _stop(_sig, _frm):
        stop["flag"] = True

    if not once and poll_hook is None:
        # SIGINT and SIGTERM drain: the current poll's waves finish, then
        # the loop exits
        signal.signal(signal.SIGINT, _stop)
        signal.signal(signal.SIGTERM, _stop)
        if verbose:
            print(f"[serve] watching {in_dir} → {out_dir} "
                  "(Ctrl+C to stop)")

    def _write(p: Path, result: dict, t0: float, wave_n: int = 1):
        out_path = out_dir / f"{p.stem}.json"
        if result.get("labels"):
            out_path.write_text(json.dumps(result_to_json(result),
                                           indent=2))
            # labels are ints for a checkpoint with no label map
            status = ",".join(str(label) for label in result["labels"])
        else:
            err = result.get("error", "no clips survived slicing")
            out_path.write_text(json.dumps(
                {"labels": [], "error": err}, indent=2))
            status = ("(no notes)" if "clips survived" in err
                      else f"(error: {err.split(':')[0]})")
        if verbose:
            # t0 is taken once per wave: the wave's time over its files
            ms = (time.perf_counter() - t0) * 1000 / max(wave_n, 1)
            tag = f"{ms:.0f} ms" if wave_n == 1 else \
                f"{ms:.1f} ms/file, wave of {wave_n}"
            print(f"[serve] {p.name} → {status} ({tag})")

    def _one_file(p: Path) -> dict:
        try:
            # the waves' cand_budget applies to single files too; passed
            # only when set, for transcribers with narrower signatures
            if cand_budget is not None:
                return t.transcribe(p, cand_budget=cand_budget)
            return t.transcribe(p)
        except ValueError as e:  # e.g. silence: no clips survived
            return {"labels": [], "error": str(e)}
        except Exception as e:  # one file's fault must not stop the loop
            return {"labels": [], "error": f"{type(e).__name__}: {e}"}

    def _finish(p: Path):
        if archive_dir is not None:
            try:
                import shutil
                dst = archive_dir / p.name
                # never overwrite an archived input: dropping a processed
                # name again is how a file is reprocessed
                i = 1
                while dst.exists():
                    dst = archive_dir / f"{p.stem}.{i}{p.suffix}"
                    i += 1
                shutil.move(str(p), str(dst))
                return
            except OSError:
                pass  # fall back to the done set
        done.add(p.name)

    processed = 0
    while not stop["flag"]:
        sizes: dict[str, int] = {}
        pending: list[Path] = []
        current: set[str] = set()
        for p in sorted(in_dir.glob("*.wav")):
            current.add(p.name)
            if p.name in done:
                continue
            try:  # a file can vanish between glob and stat
                size = p.stat().st_size
            except OSError:
                continue
            sizes[p.name] = size
            if once or seen_size.get(p.name) == size:
                pending.append(p)
        seen_size = sizes
        done &= current
        singles: list[Path] = []
        if batch > 1 and len(pending) > 1:
            # similar lengths share waves: one long file would otherwise
            # set the bucket of a wave of short ones
            pending.sort(key=lambda p: sizes[p.name])
        while batch > 1 and len(pending) > 1:
            wave, pending = pending[:batch], pending[batch:]
            t0 = time.perf_counter()
            try:
                results = t.transcribe_files(wave, cand_budget=cand_budget)
            except Exception:
                # one bad file fails the wave's decode: only this wave
                # falls back to single files
                singles.extend(wave)
                continue
            for p, r in zip(wave, results):
                _write(p, r, t0, wave_n=len(wave))
                _finish(p)
                processed += 1
        for p in singles + pending:
            t0 = time.perf_counter()
            _write(p, _one_file(p), t0)
            _finish(p)
            processed += 1
        if once:
            break
        if poll_hook is not None and poll_hook(processed):
            break
        time.sleep(poll_s)
    if verbose:
        print(f"[serve] stopped after {processed} files")
    return processed


def serve_http(port: int = 8080, host: str = "127.0.0.1",
               transcriber=None, verbose: bool = True,
               server_holder: list | None = None, batch: int = 1,
               window_s: float = 0.025, max_body_mb: float = 256.0,
               max_queue: int = 64, dispatchers: int = 1,
               drain_timeout_s: float = 60.0):
    """HTTP transcription endpoint (stdlib `http.server`):

    - ``POST /transcribe``: the body is a whole ``.wav`` file; the answer
      is the JSON the watch folder writes. Silence (no clip survives
      slicing) is a 200 with empty labels and the error text; an
      undecodable body is a 400; no Content-Length is a 411; a body over
      ``max_body_mb`` is a 413 (read in bounded chunks and discarded, so
      the client receives the answer); a server fault is a 500.
    - ``GET /healthz``: ``{"ok": true}``.
    - ``GET /metrics``: Prometheus text: requests by status code, the
      request-time summary, successful dispatches and the files they
      carried (files / dispatches is the micro-batching ratio; failed
      attempts are not counted, so per-request retries cannot inflate
      it).

    ``port=0`` binds a free port. ``server_holder`` receives the server
    object before ``serve_forever``, so another thread can ``shutdown()``
    it.

    Every request goes through a bounded queue (``max_queue``): past it,
    a request gets an immediate 503 with ``Retry-After: 1``. ``batch=1``
    dispatches each request on its own through ``transcribe``;
    ``batch>1`` lets concurrent requests meet for up to ``window_s`` and
    go through one ``transcribe_files`` wave (dispatched as soon as it is
    full); a failed wave retries each request on its own, so one bad body
    fails alone. ``dispatchers`` threads each take their own waves, so
    one wave's host work (decode, upload) overlaps another's device work.
    SIGTERM (and Ctrl+C) stops accepting, lets admitted requests finish
    within ``drain_timeout_s``, and returns."""
    import http.server
    import queue as queue_mod
    import tempfile
    import threading
    from .infer import Transcriber

    t = transcriber or Transcriber()

    mlock = threading.Lock()
    metrics = {"codes": {}, "req_s_sum": 0.0, "req_count": 0,
               "dispatches": 0, "dispatch_files": 0}
    active = {"n": 0}  # POST handlers in flight, which the drain waits for

    def _count_dispatch(nfiles: int):
        with mlock:
            metrics["dispatches"] += 1
            metrics["dispatch_files"] += nfiles

    def _render_metrics() -> str:
        with mlock:
            lines = ["# TYPE gat_http_requests_total counter"]
            for code in sorted(metrics["codes"]):
                lines.append(f'gat_http_requests_total{{code="{code}"}} '
                             f'{metrics["codes"][code]}')
            lines += [
                "# TYPE gat_http_request_seconds summary",
                f"gat_http_request_seconds_sum {metrics['req_s_sum']:.6f}",
                f"gat_http_request_seconds_count {metrics['req_count']}",
                "# TYPE gat_device_dispatches_total counter",
                f"gat_device_dispatches_total {metrics['dispatches']}",
                "# TYPE gat_dispatch_files_sum counter",
                f"gat_dispatch_files_sum {metrics['dispatch_files']}",
            ]
        return "\n".join(lines) + "\n"

    class _MicroBatcher:
        """Handler threads submit paths; dispatcher threads group them
        into waves. The queue is bounded (`max_depth`): a submit past it
        returns {"overload": True} at once. `close()` drains: no new
        admissions, queued and running waves finish."""

        def __init__(self, t, batch: int, window_s: float,
                     max_depth: int = 64, n_dispatchers: int = 1):
            self.t, self.batch, self.window = t, batch, window_s
            self.max_depth = max(int(max_depth), 1)
            self.q: queue_mod.Queue = queue_mod.Queue()
            self.closing = False
            self._inflight = 0  # requests admitted, not yet finished
            self._state = threading.Lock()
            self._threads = [threading.Thread(target=self._run, daemon=True)
                             for _ in range(max(int(n_dispatchers), 1))]
            for th in self._threads:
                th.start()

        def submit(self, path) -> dict:
            done = threading.Event()
            slot: dict = {"done": done}
            with self._state:
                # closing, depth and the put under one lock: a drain
                # never races a late admission, and the depth never
                # overshoots; _inflight counts from admission, so the
                # drain cannot miss a request between get and dispatch
                if self.closing or self.q.qsize() >= self.max_depth:
                    return {"overload": True}
                self._inflight += 1
                self.q.put((path, slot))
            done.wait()
            return slot

        def close(self, timeout_s: float = 60.0) -> bool:
            """Refuse new admissions, wait (bounded) for the queued and
            running requests, then wake every dispatcher to exit; True on
            a clean drain. The drained state is checked at least once,
            and the exit sentinels are posted even on a timeout: queued
            behind what was admitted, they let a late dispatcher finish
            that and exit instead of living on."""
            with self._state:
                self.closing = True
            deadline = time.monotonic() + timeout_s
            clean = False
            while True:
                with self._state:
                    if self.q.qsize() == 0 and self._inflight == 0:
                        clean = True
                        break
                if time.monotonic() >= deadline:
                    break
                time.sleep(0.02)
            for _ in self._threads:
                self.q.put(None)
            return clean

        def _drain_wave(self) -> list | None:
            first = self.q.get()
            if first is None:
                return None  # close()'s sentinel
            wave = [first]
            deadline = time.monotonic() + self.window
            while len(wave) < self.batch:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    break
                try:
                    nxt = self.q.get(timeout=rem)
                except queue_mod.Empty:
                    break
                if nxt is None:
                    self.q.put(None)  # the sentinel is for _run
                    break
                wave.append(nxt)
            return wave

        def _run(self):
            while True:
                wave = self._drain_wave()
                if wave is None:
                    return
                try:
                    if len(wave) == 1:
                        results = [self.t.transcribe(wave[0][0])]
                    else:
                        results = self.t.transcribe_files(
                            [p for p, _ in wave])
                    _count_dispatch(len(wave))  # successes only
                    for (_, slot), r in zip(wave, results):
                        slot["result"] = r
                except Exception as e:
                    if len(wave) == 1:
                        wave[0][1]["exc"] = e
                    else:
                        # one bad body must not fail its neighbours: each
                        # request again on its own, with its own error
                        for p, slot in wave:
                            try:
                                slot["result"] = self.t.transcribe(p)
                                _count_dispatch(1)
                            except Exception as e2:
                                slot["exc"] = e2
                finally:
                    for _, slot in wave:
                        slot["done"].set()
                    with self._state:
                        self._inflight -= len(wave)

    batcher = _MicroBatcher(t, batch, window_s, max_depth=max_queue,
                            n_dispatchers=dispatchers)

    class Handler(http.server.BaseHTTPRequestHandler):
        timeout = 120  # bounds reads from stalled clients

        def log_message(self, fmt, *args):
            if verbose:
                print(f"[serve.http] {fmt % args}")

        def _json(self, code: int, payload: dict,
                  extra_headers: dict | None = None):
            with mlock:
                metrics["codes"][code] = metrics["codes"].get(code, 0) + 1
                if self.command == "POST" and not self._accounted:
                    # count and sum move together, before the answer is
                    # written: the client may scrape the moment it lands
                    self._accounted = True
                    metrics["req_count"] += 1
                    metrics["req_s_sum"] += time.perf_counter() - self._t0
            body = json.dumps(payload, indent=2).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/metrics":
                body = _render_metrics().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            self._t0 = time.perf_counter()
            self._accounted = False
            with mlock:
                active["n"] += 1
            try:
                self._do_post()
            finally:
                # a handler that failed before answering still counts
                with mlock:
                    active["n"] -= 1
                    if not self._accounted:
                        self._accounted = True
                        metrics["req_count"] += 1
                        metrics["req_s_sum"] += (time.perf_counter()
                                                 - self._t0)

        def _do_post(self):
            if self.path != "/transcribe":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            cl = self.headers.get("Content-Length")
            if cl is None:
                # the stdlib handler does not decode chunked bodies
                self._json(411, {"labels": [],
                                 "error": "Content-Length required "
                                          "(chunked bodies unsupported)"})
                return
            try:
                n = int(cl)
            except ValueError:
                self._json(400, {"labels": [],
                                 "error": f"bad Content-Length: {cl!r}"})
                return
            if n <= 0:
                self._json(400, {"labels": [], "error": "empty body"})
                return
            if n > max_body_mb * 1024 * 1024:
                # read and discard in bounded chunks: answering with the
                # body unread would reset the connection under a client
                # still sending, which would then never see the 413
                remaining = n
                try:
                    while remaining > 0:
                        chunk = self.rfile.read(min(1 << 20, remaining))
                        if not chunk:
                            break
                        remaining -= len(chunk)
                except OSError:
                    pass  # the client gave up; answer if we still can
                self._json(413, {"labels": [],
                                 "error": f"body {n} bytes exceeds the "
                                          f"{max_body_mb:g} MB limit"})
                return
            data = self.rfile.read(n)
            try:
                with tempfile.NamedTemporaryFile(suffix=".wav") as f:
                    f.write(data)
                    f.flush()
                    slot = batcher.submit(f.name)
                    if slot.get("overload"):
                        self._json(503, {
                            "labels": [],
                            "error": "server overloaded (micro-batch "
                                     "queue full) — retry later",
                        }, extra_headers={"Retry-After": "1"})
                        return
                    if "exc" in slot:
                        raise slot["exc"]
                    result = slot["result"]
                    if not result.get("labels"):
                        # transcribe_files gives silence an empty result
                        # where transcribe raises: one answer for both
                        self._json(200, {"labels": [],
                                         "error": "no clips survived "
                                                  "slicing"})
                        return
            except ValueError as e:
                # silence is content (200); any other ValueError is a bad
                # body, e.g. not a RIFF file (400)
                code = 200 if "clips survived" in str(e) else 400
                self._json(code, {"labels": [], "error": str(e)})
                return
            except Exception as e:
                self._json(500, {"labels": [],
                                 "error": f"{type(e).__name__}: {e}"})
                return
            self._json(200, result_to_json(result))

    class _Server(http.server.ThreadingHTTPServer):
        # the listener's backlog holds a burst while waves drain (the
        # default of 5 would reset the rest of a concurrent burst)
        request_queue_size = 128

    srv = _Server((host, port), Handler)
    if server_holder is not None:
        server_holder.append(srv)
    if verbose:
        print(f"[serve] http on {host}:{srv.server_address[1]} "
              "(POST /transcribe, GET /healthz; Ctrl+C to stop)")

    # SIGTERM stops accepting, then the drain below runs. shutdown() runs
    # on its own thread (it waits for serve_forever, which runs here).
    # Installed only from the main thread, where signal.signal works.
    def _sigterm(_sig, _frm):
        threading.Thread(target=srv.shutdown, daemon=True).start()

    prev_sig = None
    installed_sig = False
    if threading.current_thread() is threading.main_thread():
        prev_sig = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, _sigterm)
        installed_sig = True
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if installed_sig:
            # the host's own handler back, not SIG_DFL
            signal.signal(signal.SIGTERM,
                          prev_sig if prev_sig is not None
                          else signal.SIG_DFL)
        # the listener is closed; queued waves and handler threads may
        # still be running: wait for them, within drain_timeout_s
        deadline = time.monotonic() + drain_timeout_s
        clean = batcher.close(max(deadline - time.monotonic(), 0.0))
        while True:
            with mlock:
                if active["n"] == 0:
                    break
            if time.monotonic() >= deadline:
                clean = False
                break
            time.sleep(0.02)
        srv.server_close()
        if verbose:
            msg = "drained clean" if clean else \
                f"drain timed out after {drain_timeout_s:g}s"
            print(f"[serve] http stopped ({msg})")


def main(argv=None):
    from . import __version__
    ap = argparse.ArgumentParser(prog="gat-torch-serve")
    ap.add_argument("--version", action="version",
                    version=f"gat_tpu_torch {__version__}")
    ap.add_argument("--in_dir", type=Path)
    ap.add_argument("--out_dir", type=Path)
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve an HTTP endpoint instead of watching a "
                         "directory: POST /transcribe with a .wav body "
                         "returns the transcription JSON")
    ap.add_argument("--archive_dir", type=Path, default=None,
                    help="move processed inputs here, so --in_dir (and "
                         "each poll's scan) stays bounded by the arrival "
                         "rate")
    ap.add_argument("--once", action="store_true",
                    help="process current contents and exit")
    ap.add_argument("--poll_s", type=float, default=0.5)
    ap.add_argument("--pitch_prior", type=float, default=0.0,
                    help="YIN pitch-prior mixture weight (0 disables)")
    ap.add_argument("--batch", type=int, default=1,
                    help="files per wave (>1 sends arrival waves through "
                         "transcribe_files)")
    ap.add_argument("--cand_budget", type=int, default=None,
                    help="onset candidate-walk budget per file; a "
                         "truncation that could change a result runs "
                         "again through the exact walk, and a cap "
                         "truncation re-runs at a larger cap, so "
                         "onset_overflow survives only past 1024 onsets")
    ap.add_argument("--http_batch", type=int, default=1,
                    help="with --http: gather up to N concurrent requests "
                         "into one transcribe_files wave")
    ap.add_argument("--http_window_ms", type=float, default=25.0,
                    help="with --http_batch>1: how long the first request "
                         "of a wave waits for others (the added latency "
                         "bound)")
    ap.add_argument("--http_max_mb", type=float, default=256.0,
                    help="with --http: refuse bodies larger than this many "
                         "MB with a 413")
    ap.add_argument("--http_max_queue", type=int, default=64,
                    help="with --http: queued requests past which a POST "
                         "gets an immediate 503 with Retry-After")
    ap.add_argument("--http_dispatchers", type=int, default=1,
                    help="with --http: dispatcher threads taking waves (2 "
                         "lets one wave's host work overlap another's "
                         "device work)")
    ap.add_argument("--warmup", type=str, default=None, metavar="SECS",
                    help="comma-separated durations (s) to run once before "
                         "serving, e.g. --warmup 4,60")
    ap.add_argument("--warm_onset_caps", type=int, default=0,
                    help="with --warmup: also run the cap re-run bodies at "
                         "max_onsets 128.. up to this value (e.g. 1024)")
    ap.add_argument("--device", type=str, default=None,
                    help="the Transcriber's device: the CUDA card by "
                         "default, 'cpu' for the plain PyTorch path")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="run the batch serving path data-parallel over N "
                         "ranks, one per card (Transcriber(mesh=)): rank 0 "
                         "watches the folder or answers HTTP, and every "
                         "wave's files split over the ranks; under torchrun "
                         "it joins the world torchrun started, otherwise it "
                         "starts N ranks. Pair with --batch/--http_batch "
                         ">= N so waves fill every rank")
    args = ap.parse_args(argv)
    durs = None
    if args.warmup:
        try:
            durs = [float(x) for x in args.warmup.split(",") if x.strip()]
        except ValueError:
            ap.error(f"--warmup expects comma-separated seconds, got "
                     f"{args.warmup!r}")
    if args.http is not None:
        # watch-folder flags do nothing here: refuse them
        ignored = [n for n, bad in [
            ("--in_dir", args.in_dir is not None),
            ("--out_dir", args.out_dir is not None),
            ("--once", args.once),
            ("--archive_dir", args.archive_dir is not None),
            ("--poll_s", args.poll_s != 0.5),
            ("--batch", args.batch != 1),
            ("--cand_budget", args.cand_budget is not None),
        ] if bad]
        if ignored:
            ap.error(f"--http does not support {', '.join(ignored)} "
                     "(watch-folder flags)")
    else:
        if args.http_batch != 1 or args.http_window_ms != 25.0 \
                or args.http_max_mb != 256.0 or args.http_max_queue != 64 \
                or args.http_dispatchers != 1:
            ap.error("--http_batch/--http_window_ms/--http_max_mb/"
                     "--http_max_queue/--http_dispatchers require --http")
        if args.in_dir is None or args.out_dir is None:
            ap.error("--in_dir and --out_dir are required without --http")

    if args.mesh:
        from .parallel import launch
        device = args.device or "cuda"
        if launch.under_torchrun():
            launch.init_from_env(device)
            return _serve_rank(args, durs)
        return launch.spawn(_serve_rank, args.mesh, args, durs,
                            device=device, timeout_s=None)[0]
    return _serve_rank(args, durs)


class _MeshFront:
    """Rank 0's Transcriber under `--mesh`: each `transcribe_files` call
    first broadcasts its paths and arguments, so that every rank makes
    the same call (`_follow`); one call at a time, as the collectives of
    two calls must not interleave. `transcribe` of one file ignores the
    mesh and runs here alone."""

    def __init__(self, t):
        import threading
        self._t = t
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self._t, name)

    def _broadcast(self, msg) -> None:
        import torch.distributed as dist
        dist.broadcast_object_list([msg], src=0)

    def transcribe_files(self, paths, **kw):
        from .infer.transcriber import WaveReadError
        from .parallel.launch import abort_rank
        paths = [str(p) for p in paths]
        with self._lock:
            self._broadcast(("files", paths, kw))
            try:
                return self._t.transcribe_files(paths, **kw)
            except WaveReadError:
                raise  # every rank raised it: the caller's fallback runs
            except Exception:  # noqa: BLE001 - ends the world
                # the other ranks may wait in this call's collectives
                abort_rank()

    def close(self) -> None:
        with self._lock:
            self._broadcast(("stop",))


def _follow(t) -> None:
    """A rank above 0 under `--mesh`: the `transcribe_files` calls rank 0
    broadcasts, until it says stop. A wave whose files fail to decode
    fails alike on rank 0, which reports it; any other fault leaves this
    function and ends the rank, and with it the world, since rank 0 may
    wait in one of the call's collectives."""
    import torch.distributed as dist
    from .infer.transcriber import WaveReadError
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0)
        if box[0][0] == "stop":
            return
        _, paths, kw = box[0]
        try:
            t.transcribe_files(paths, **kw)
        except WaveReadError:
            pass


def _serve_rank(args, durs) -> int:
    """The server on one rank (on its own without `--mesh`)."""
    from .infer import Transcriber
    mesh = None
    rank = 0
    if args.mesh:
        import torch.distributed as dist
        from .parallel.mesh import make_mesh
        mesh = make_mesh(args.mesh, device=args.device)
        rank = dist.get_rank()
    t = Transcriber(pitch_prior_weight=args.pitch_prior, device=args.device,
                    mesh=mesh)
    batch = args.http_batch if args.http is not None else args.batch
    if durs:
        warmup(t, durs, batch=batch, cand_budget=args.cand_budget,
               warm_onset_caps=args.warm_onset_caps, verbose=rank == 0)
    if rank > 0:
        _follow(t)
        return 0
    if mesh is not None:
        t = _MeshFront(t)
    try:
        return _serve_front(args, t)
    finally:
        if mesh is not None:
            t.close()


def _serve_front(args, t) -> int:
    if args.http is not None:
        serve_http(args.http, transcriber=t, batch=args.http_batch,
                   window_s=args.http_window_ms / 1000.0,
                   max_body_mb=args.http_max_mb,
                   max_queue=args.http_max_queue,
                   dispatchers=args.http_dispatchers)
        return 0
    serve(args.in_dir, args.out_dir, once=args.once, poll_s=args.poll_s,
          transcriber=t, batch=args.batch, cand_budget=args.cand_budget,
          archive_dir=args.archive_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
