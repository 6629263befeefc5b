"""The port's server, `gat_tpu_torch/serve.py`, mirroring the JAX
package's serve tests (tests/test_cli_tools.py): the watch folder and the
HTTP endpoint with the port's CPU Transcriber, held to `gat_tpu.serve` on
the same directory (labels, onsets and YIN note names identical), and
their routing, lifecycle and error contracts with duck-typed fake
transcribers."""
import http.client
import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from gat_tpu import serve as jserve
from gat_tpu.infer import Transcriber as JTranscriber
from gat_tpu_torch import serve
from gat_tpu_torch.infer import Transcriber
from gat_tpu_torch.utils.wavio import write_wav
from emulated_kernels import RIFF_NOTES, pluck_riff

SR = 22050
A_LABELS = ["A2", "D3"]  # a.wav's three plucks but the dropped last
B_LABELS = ["A2", "D3", "G3"]


def _ok(*_a, **_kw):
    return {"labels": ["A2"], "confidences": [1.0]}


class Stub:
    """A transcriber that answers every file with one label."""
    clip_length = 0.5

    def transcribe(self, path, **kw):
        return _ok()

    def transcribe_files(self, paths, **kw):
        return [_ok() for _ in paths]


@pytest.fixture(scope="module")
def port_t():
    return Transcriber(device="cpu")


@pytest.fixture(scope="module")
def bodies(tmp_path_factory):
    """WAV files and their bytes: a (3 plucks, 2.6 s), b (4 plucks,
    3.3 s), silence (2.5 s)."""
    d = tmp_path_factory.mktemp("bodies")
    files = {"a": pluck_riff(SR, 2.6, RIFF_NOTES[:3]),
             "b": pluck_riff(SR, 3.3, RIFF_NOTES[:4]),
             "silence": np.zeros(int(2.5 * SR), np.float32)}
    out = {}
    for name, y in files.items():
        write_wav(d / f"{name}.wav", y, SR)
        out[name] = d / f"{name}.wav"
    return out


def _fill(d: Path, bodies, names) -> Path:
    d.mkdir(parents=True)
    for n in names:
        (d / f"{n}.wav").write_bytes(bodies[n].read_bytes())
    return d


def _start_http(kwargs):
    holder: list = []
    th = threading.Thread(
        target=serve.serve_http,
        kwargs=dict(port=0, verbose=False, server_holder=holder, **kwargs),
        daemon=True)
    th.start()
    for _ in range(200):
        if holder:
            break
        time.sleep(0.05)
    assert holder, "http server never bound"
    return holder, th, holder[0].server_address[1]


def _post(port, body: bytes, path="/transcribe", timeout=120):
    """(status, JSON, Retry-After) of one POST; HTTP errors included."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), None
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers.get("Retry-After")


def _concurrent(fn, n: int, timeout=120) -> list:
    out, lock = [], threading.Lock()

    def one():
        r = fn()
        with lock:
            out.append(r)
    threads = [threading.Thread(target=one) for _ in range(n)]
    for x in threads:
        x.start()
    for x in threads:
        x.join(timeout=timeout)
    assert not any(x.is_alive() for x in threads)
    return out


def _metrics(port) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    return dict(ln.rsplit(" ", 1) for ln in text.splitlines()
                if ln and not ln.startswith("#"))


def test_result_to_json_matches_gat_tpu():
    result = {"labels": ["A2", 17], "confidences": np.float32([0.9, 0.4]),
              "onsets_s": [0.4, 1.1],
              "dsp_info": [(110.2, {"midi": 45, "note_name": "A2",
                                    "midi_float": 45.03})],
              "onset_overflow": np.bool_(True)}
    got = serve.result_to_json(result)
    assert got == jserve.result_to_json(result)
    assert json.loads(json.dumps(got))["onset_overflow"] is True
    assert serve.result_to_json({"labels": [], "confidences": []}) == {
        "labels": [], "confidences": [], "onsets_s": [], "yin": [],
        "onset_overflow": False}


@pytest.mark.parametrize("batch", [1, 4])
def test_serve_once_matches_gat_tpu(port_t, bodies, tmp_path, batch):
    """One pass over a directory, per file and in one wave of three:
    the same JSON labels, onsets and YIN note names as gat_tpu.serve."""
    names = ("a", "b", "silence")
    outs = {}
    for tag, mod, t in (("port", serve, port_t),
                        ("jax", jserve, JTranscriber())):
        in_dir = _fill(tmp_path / tag / "in", bodies, names)
        n = mod.serve(in_dir, tmp_path / tag / "out", once=True,
                      verbose=False, transcriber=t, batch=batch)
        assert n == 3
        outs[tag] = {s: json.loads((tmp_path / tag / "out" / f"{s}.json")
                                   .read_text()) for s in names}
    got, ref = outs["port"], outs["jax"]
    assert got["a"]["labels"] == A_LABELS and got["b"]["labels"] == B_LABELS
    for s in ("a", "b"):
        assert got[s]["labels"] == ref[s]["labels"]
        assert got[s]["onsets_s"] == ref[s]["onsets_s"]
        assert ([y["note_name"] for y in got[s]["yin"]]
                == [y["note_name"] for y in ref[s]["yin"]])
        assert got[s]["onset_overflow"] is ref[s]["onset_overflow"] is False
    assert got["silence"]["labels"] == [] and "error" in got["silence"]
    assert ref["silence"]["labels"] == []


def test_serve_batched_bad_file_falls_back(port_t, bodies, tmp_path):
    """A file that is not a WAV fails its wave's decode: that wave's
    files go one by one, and the bad file gets an error entry."""
    in_dir = _fill(tmp_path / "in", bodies, ("a", "b", "silence"))
    (in_dir / "garbage.wav").write_bytes(b"not a wav" * 9)
    out = tmp_path / "out"
    assert serve.serve(in_dir, out, once=True, verbose=False,
                       transcriber=port_t, batch=4) == 4
    res = {s: json.loads((out / f"{s}.json").read_text())
           for s in ("a", "b", "silence", "garbage")}
    assert res["a"]["labels"] == A_LABELS and res["b"]["labels"] == B_LABELS
    assert res["silence"]["labels"] == [] and "error" in res["silence"]
    assert res["garbage"]["labels"] == [] and "error" in res["garbage"]


def test_serve_batch_routing(tmp_path):
    """Five files at batch 2: two waves of two through transcribe_files,
    the odd one through transcribe, with the cand_budget in both."""
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    for i in range(5):
        (in_dir / f"{i}.wav").write_bytes(b"RIFF" + b"x" * (10 + i))
    waves, singles = [], []

    class Spy(Stub):
        def transcribe(self, path, **kw):
            singles.append((Path(path).name, kw))
            return _ok()

        def transcribe_files(self, paths, **kw):
            waves.append(([Path(p).name for p in paths], kw))
            return [_ok() for _ in paths]
    n = serve.serve(in_dir, tmp_path / "out", once=True, verbose=False,
                    transcriber=Spy(), batch=2, cand_budget=7)
    assert n == 5
    assert waves == [(["0.wav", "1.wav"], {"cand_budget": 7}),
                     (["2.wav", "3.wav"], {"cand_budget": 7})]
    assert singles == [("4.wav", {"cand_budget": 7})]


def test_serve_copy_stability_gate(bodies, tmp_path):
    """A WAV still growing is not transcribed: a file becomes eligible
    once its size is the same across two polls."""
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    full = bodies["a"].read_bytes()
    target = in_dir / "grow.wav"
    target.write_bytes(full[: len(full) // 2])
    seen_sizes: list[int] = []

    class Sizes(Stub):
        def transcribe(self, path, **kw):
            seen_sizes.append(Path(path).stat().st_size)
            return _ok()
    polls = {"n": 0}

    def hook(processed):
        polls["n"] += 1
        if polls["n"] == 1:
            assert processed == 0 and not seen_sizes
            target.write_bytes(full)  # the copy completes
            return False
        if polls["n"] == 2:
            assert processed == 0 and not seen_sizes  # size changed
            return False
        assert processed == 1
        return True
    n = serve.serve(in_dir, tmp_path / "out", once=False, poll_s=0.0,
                    transcriber=Sizes(), verbose=False, poll_hook=hook)
    assert n == 1 and seen_sizes == [len(full)]


def test_serve_archive_moves_and_dedups(bodies, tmp_path):
    """Processed inputs move to the archive; a name dropped again is
    archived beside the first, never over it."""
    in_dir = _fill(tmp_path / "in", bodies, ("a",))
    arch, out = tmp_path / "arch", tmp_path / "out"
    assert serve.serve(in_dir, out, once=True, verbose=False,
                       transcriber=Stub(), archive_dir=arch) == 1
    assert not list(in_dir.glob("*.wav")) and (arch / "a.wav").exists()
    assert json.loads((out / "a.json").read_text())["labels"] == ["A2"]
    (arch / "a.wav").write_bytes(b"FIRST" + (arch / "a.wav").read_bytes())
    first = (arch / "a.wav").read_bytes()
    (in_dir / "a.wav").write_bytes(bodies["a"].read_bytes())
    serve.serve(in_dir, out, once=True, verbose=False, transcriber=Stub(),
                archive_dir=arch)
    assert (arch / "a.wav").read_bytes() == first
    assert (arch / "a.1.wav").exists()


def test_serve_refuses_archive_equal_to_in_dir(tmp_path):
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    with pytest.raises(ValueError, match="archive_dir"):
        serve.serve(in_dir, tmp_path / "out", once=True, verbose=False,
                    transcriber=Stub(), archive_dir=in_dir)


def test_serve_integer_labels(bodies, tmp_path, capsys):
    """A checkpoint with no label map gives int labels."""
    in_dir = _fill(tmp_path / "in", bodies, ("a",))

    class Ints(Stub):
        def transcribe(self, path, **kw):
            return {"labels": [17, 23],
                    "confidences": np.asarray([0.9, 0.8], np.float32)}
    assert serve.serve(in_dir, tmp_path / "out", once=True, verbose=True,
                       transcriber=Ints()) == 1
    r = json.loads((tmp_path / "out" / "a.json").read_text())
    assert r["labels"] == [17, 23]
    assert "17,23" in capsys.readouterr().out


def test_http_endpoint(port_t, bodies):
    """The port's CPU Transcriber over a socket: a riff gives its labels,
    silence a 200 with empty labels, a non-WAV a 400, an unknown path a
    404; /healthz answers."""
    holder, th, port = _start_http(dict(transcriber=port_t))
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True}
        status, rj, _ = _post(port, bodies["a"].read_bytes())
        assert status == 200 and rj["labels"] == A_LABELS
        assert rj["yin"][0]["note_name"] == "A2"
        assert rj["onset_overflow"] is False
        status, rj, _ = _post(port, bodies["silence"].read_bytes())
        assert status == 200 and rj["labels"] == [] and "error" in rj
        status, rj, _ = _post(port, b"not a wav" * 9)
        assert status == 400 and rj["labels"] == []
        assert _post(port, b"x", path="/nope")[0] == 404
    finally:
        holder[0].shutdown()
        th.join(timeout=10)


def test_http_error_codes():
    """No Content-Length is a 411, a bad one a 400, an oversized body a
    413 that never reaches the transcriber, and a server fault a 500."""

    class Boom:
        def transcribe(self, path):
            raise RuntimeError("device fell over")
    holder, th, port = _start_http(dict(transcriber=Boom(),
                                        max_body_mb=0.001))

    def raw_post(headers: dict, body: bytes = b""):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        try:
            conn.putrequest("POST", "/transcribe",
                            skip_accept_encoding=True)
            for k, v in headers.items():
                conn.putheader(k, v)
            conn.endheaders()
            if body:
                conn.send(body)
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()
    try:
        status, rj = raw_post({})
        assert status == 411 and rj["labels"] == []
        status, rj = raw_post({"Content-Length": "banana"})
        assert status == 400 and "Content-Length" in rj["error"]
        status, rj = raw_post({"Content-Length": "4"}, body=b"RIFF")
        assert status == 500 and "device fell over" in rj["error"]
        status, rj, _ = _post(port, b"x" * 4096)
        assert status == 413 and "exceeds" in rj["error"]
    finally:
        holder[0].shutdown()
        th.join(timeout=10)


def test_http_micro_batches_concurrent_requests(bodies):
    """Four concurrent POSTs meet in fewer dispatches than requests, each
    served once."""
    calls: list[int] = []

    class Spy(Stub):
        def transcribe(self, path, **kw):
            calls.append(1)
            return _ok()

        def transcribe_files(self, paths, **kw):
            calls.append(len(paths))
            return [_ok() for _ in paths]
    holder, th, port = _start_http(dict(transcriber=Spy(), batch=4,
                                        window_s=2.0))
    body = bodies["a"].read_bytes()
    try:
        out = _concurrent(lambda: _post(port, body), 4)
        assert all(s == 200 and r["labels"] == ["A2"] for s, r, _ in out)
        assert sum(calls) == 4 and len(calls) < 4 and max(calls) >= 2
    finally:
        holder[0].shutdown()
        th.join(timeout=10)


def test_http_micro_batch_end_to_end(port_t, bodies):
    """Two concurrent riffs ride one transcribe_files wave of the port's
    CPU Transcriber; a bad body beside a good one fails alone."""
    holder, th, port = _start_http(dict(transcriber=port_t, batch=2,
                                        window_s=1.0))
    good, bad = bodies["b"].read_bytes(), b"not a wav" * 9
    try:
        out = _concurrent(lambda: _post(port, good, timeout=300), 2)
        assert [s for s, _, _ in out] == [200, 200]
        assert all(r["labels"] == B_LABELS for _, r, _ in out)
        queue = [good, bad]
        lock = threading.Lock()

        def post_next():
            with lock:
                body = queue.pop()
            return _post(port, body, timeout=300)
        out = _concurrent(post_next, 2)
        assert sorted(s for s, _, _ in out) == [200, 400]
        assert next(r for s, r, _ in out if s == 200)["labels"] == B_LABELS
    finally:
        holder[0].shutdown()
        th.join(timeout=10)


def test_http_metrics(bodies):
    """/metrics: request codes, the request-time summary, dispatches and
    the files they carried (fewer dispatches than files)."""
    holder, th, port = _start_http(dict(transcriber=Stub(), batch=3,
                                        window_s=10.0))
    body = bodies["a"].read_bytes()
    try:
        _concurrent(lambda: _post(port, body), 3)
        lines = _metrics(port)
        assert lines['gat_http_requests_total{code="200"}'] == "3"
        assert lines["gat_http_request_seconds_count"] == "3"
        assert float(lines["gat_http_request_seconds_sum"]) > 0.0
        assert int(lines["gat_dispatch_files_sum"]) == 3
        assert int(lines["gat_device_dispatches_total"]) < 3
    finally:
        holder[0].shutdown()
        th.join(timeout=10)


def test_http_metrics_count_successful_dispatches_only(bodies):
    """A failed wave is not counted on top of its per-request retries."""

    class Fails(Stub):
        def transcribe_files(self, paths, **kw):
            raise RuntimeError("batched decode failed")
    holder, th, port = _start_http(dict(transcriber=Fails(), batch=4,
                                        window_s=2.0))
    body = bodies["a"].read_bytes()
    try:
        out = _concurrent(lambda: _post(port, body), 4)
        assert [s for s, _, _ in out] == [200] * 4
        lines = _metrics(port)
        assert int(lines["gat_device_dispatches_total"]) == 4
        assert int(lines["gat_dispatch_files_sum"]) == 4
    finally:
        holder[0].shutdown()
        th.join(timeout=10)


def test_http_many_waves_each_request_once(bodies):
    """24 concurrent POSTs through waves of at most 4: every request is
    answered once, none waits forever."""
    calls: list[int] = []

    class Spy(Stub):
        def transcribe(self, path, **kw):
            calls.append(1)
            return _ok()

        def transcribe_files(self, paths, **kw):
            calls.append(len(paths))
            return [_ok() for _ in paths]
    holder, th, port = _start_http(dict(transcriber=Spy(), batch=4,
                                        window_s=0.05))
    body = bodies["a"].read_bytes()
    try:
        out = _concurrent(lambda: _post(port, body), 24)
        assert len(out) == 24
        assert all(s == 200 and r["labels"] == ["A2"] for s, r, _ in out)
        assert sum(calls) == 24 and max(calls) <= 4
    finally:
        holder[0].shutdown()
        th.join(timeout=10)


@pytest.mark.parametrize("batch,max_queue,n", [(2, 3, 16), (1, 2, 12)])
def test_http_burst_sheds_load(batch, max_queue, n):
    """A burst past the bounded queue gets 503 with Retry-After 1; every
    admitted request is answered once with a 200 (at batch 1 too)."""
    served, slock = [], threading.Lock()

    class Slow(Stub):
        def transcribe(self, path, **kw):
            time.sleep(0.15)
            with slock:
                served.append(1)
            return _ok()

        def transcribe_files(self, paths, **kw):
            time.sleep(0.15)
            with slock:
                served.append(len(paths))
            return [_ok() for _ in paths]
    holder, th, port = _start_http(dict(transcriber=Slow(), batch=batch,
                                        window_s=0.01, max_queue=max_queue,
                                        drain_timeout_s=30.0))
    try:
        out = _concurrent(lambda: _post(port, b"RIFF" + b"x" * 64,
                                        timeout=60), n, timeout=60)
        assert len(out) == n
        codes = sorted(c for c, _, _ in out)
        assert set(codes) <= {200, 503}, codes
        n200 = codes.count(200)
        assert n200 >= 1 and codes.count(503) >= 1, codes
        assert sum(served) == n200
        assert all(r["labels"] == ["A2"] for c, r, _ in out if c == 200)
        assert all(ra == "1" for c, _, ra in out if c == 503)
    finally:
        holder[0].shutdown()
        th.join(timeout=30)
        assert not th.is_alive()


def test_http_dispatchers_exit_with_zero_drain_timeout():
    """An idle drain of 0 s is clean, and the dispatcher threads exit."""
    before = set(threading.enumerate())
    holder, th, port = _start_http(dict(transcriber=Stub(), batch=2,
                                        window_s=0.01, dispatchers=3,
                                        drain_timeout_s=0.0))
    spawned = set(threading.enumerate()) - before
    assert len(spawned) >= 4
    assert _post(port, b"RIFF" + b"x" * 64, timeout=60)[0] == 200
    holder[0].shutdown()
    th.join(timeout=30)
    assert not th.is_alive()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and any(x.is_alive() for x in spawned):
        time.sleep(0.05)
    assert not [x for x in spawned if x.is_alive()]


def test_http_graceful_drain_answers_inflight():
    """shutdown() while requests are queued: every admitted request gets
    its 200, the others a 503 or a refused connection, none hangs."""

    class Slow(Stub):
        def transcribe(self, path, **kw):
            time.sleep(0.3)
            return _ok()

        def transcribe_files(self, paths, **kw):
            time.sleep(0.3)
            return [_ok() for _ in paths]
    holder, th, port = _start_http(dict(transcriber=Slow(), batch=2,
                                        window_s=0.05, max_queue=16,
                                        drain_timeout_s=30.0))
    out, lock = [], threading.Lock()

    def post():
        try:
            r = _post(port, b"RIFF" + b"x" * 64, timeout=60)[:2]
        except (urllib.error.URLError, ConnectionError) as e:
            r = ("conn", repr(e))
        with lock:
            out.append(r)
    threads = [threading.Thread(target=post) for _ in range(6)]
    for x in threads:
        x.start()
    time.sleep(0.1)
    holder[0].shutdown()
    for x in threads:
        x.join(timeout=60)
    th.join(timeout=30)
    assert not th.is_alive() and len(out) == 6, out
    oks = [r for c, r in out if c == 200]
    assert all(r["labels"] == ["A2"] for r in oks) and len(oks) >= 2, out
    assert all(c in (200, 503, "conn") for c, _ in out), out


def test_http_concurrent_dispatchers_overlap():
    """Two dispatchers run two waves at once; each request still gets its
    own answer."""
    peak, plock = {"now": 0, "max": 0}, threading.Lock()

    class Overlap(Stub):
        def _hold(self):
            with plock:
                peak["now"] += 1
                peak["max"] = max(peak["max"], peak["now"])
            time.sleep(0.25)
            with plock:
                peak["now"] -= 1

        def transcribe(self, path, **kw):
            self._hold()
            return _ok()

        def transcribe_files(self, paths, **kw):
            self._hold()
            return [_ok() for _ in paths]
    holder, th, port = _start_http(dict(transcriber=Overlap(), batch=2,
                                        window_s=0.02, dispatchers=2,
                                        max_queue=16, drain_timeout_s=30.0))
    try:
        out = _concurrent(lambda: _post(port, b"RIFF" + b"x" * 64,
                                        timeout=60), 8, timeout=60)
        assert len(out) == 8
        assert all(c == 200 and r["labels"] == ["A2"] for c, r, _ in out)
        assert peak["max"] >= 2
    finally:
        holder[0].shutdown()
        th.join(timeout=30)


class WarmSpy(Stub):
    """Records warmup's wave sizes, single-file calls and the exact and
    cap bodies it runs through `_files_fn`."""

    def __init__(self):
        self.waves, self.singles, self.exact, self.scans = [], [], [], []
        self.caps = []

    def transcribe_files(self, paths, **kw):
        self.waves.append(len(paths))
        return [_ok() for _ in paths]

    def transcribe(self, path, **kw):
        self.singles.append(kw.get("cand_budget"))
        return _ok()

    def _files_fn(self, sr, clip_duration, max_onsets, budget, cand):
        assert budget is None and cand == 0  # the exact body

        def run(ys, nvs):
            assert tuple(nvs.shape) == tuple(ys.shape[:1])
            (self.caps if max_onsets > 64 else self.exact).append(
                (max_onsets, int(ys.shape[0]), int(ys.shape[1])))

        def run_scan(ys, nvs):
            assert tuple(nvs.shape) == tuple(ys.shape[:2])
            self.scans.append(tuple(int(v) for v in ys.shape))
        return run, run_scan


@pytest.mark.parametrize("batch,waves,exact,scans", [
    (4, [2, 4], [2, 4], []),
    (3, [2, 3], [2, 4], []),          # a full wave of 3 pads to B = 4
    (8, [2, 4, 8], [2, 4], [(2, 4, 2 * SR)]),  # B = 8 only as 2 waves of 4
])
def test_warmup_shapes(batch, waves, exact, scans):
    """warmup runs transcribe_files at every power-of-two wave from 2 up
    to the batch (and the full wave), the exact body at the B that
    transcribe_files dispatches, its chunks of K waves, and transcribe
    with its exact re-segmentation; bucket 2 s for a 1.5 s duration."""
    t = WarmSpy()
    serve.warmup(t, [1.5], batch=batch, verbose=False)
    assert t.waves == waves
    assert [b for _, b, _ in t.exact] == exact
    assert all(m == 64 and n == 2 * SR for m, _, n in t.exact)
    assert t.scans == scans
    assert t.singles == [None, 0] and t.caps == []


def test_warmup_onset_caps_and_single_batch():
    t = WarmSpy()
    serve.warmup(t, [1.0], batch=2, verbose=False, warm_onset_caps=256)
    assert t.caps == [(128, 2, SR), (256, 2, SR)]
    t = WarmSpy()
    serve.warmup(t, [1.0, 2.0], batch=1, verbose=False)
    assert t.waves == [] and t.exact == [] and t.singles == [None, 0] * 2


def test_warmup_pluck_equals_gat_tpu():
    """The port's copy of karplus_strong, which warmup plucks with, gives
    gat_tpu's samples."""
    from gat_tpu.data.synth import karplus_strong as jax_ks
    from gat_tpu_torch.data.synth import karplus_strong
    for args, kw in (((196.0, SR, 0.5), dict(seed=7)),
                     ((82.4, 11025, 0.3), dict(n_variants=3, seed=2))):
        np.testing.assert_array_equal(karplus_strong(*args, **kw),
                                      np.asarray(jax_ks(*args, **kw)))


def test_warmup_runs_on_the_cpu_transcriber(port_t, capsys):
    serve.warmup(port_t, [1.0], batch=2)
    assert "warmed 1s x2" in capsys.readouterr().out


@pytest.mark.parametrize("argv,message", [
    (["--http", "0", "--batch", "8"], "does not support --batch"),
    (["--http", "0", "--cand_budget", "64"], "does not support --cand"),
    (["--http", "0", "--once", "--in_dir", "i"], "--in_dir, --once"),
    (["--in_dir", "i", "--out_dir", "o", "--http_batch", "4"],
     "require --http"),
    (["--in_dir", "i"], "are required without --http"),
    (["--http", "0", "--warmup", "4,banana"], "comma-separated seconds"),
    (["--http", "0", "--mesh", "four"], "invalid int value"),
])
def test_main_refuses_flags(argv, message, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(argv)
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_main_defaults_to_the_card(tmp_path):
    """Without --device the server's Transcriber is the card's: with no
    card, main raises rather than run on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--in_dir", str(tmp_path / "in"), "--out_dir",
                    str(tmp_path / "out"), "--once"])


def test_main_once_on_the_cpu(bodies, tmp_path):
    in_dir = _fill(tmp_path / "in", bodies, ("a", "silence"))
    out = tmp_path / "out"
    assert serve.main(["--in_dir", str(in_dir), "--out_dir", str(out),
                       "--once", "--device", "cpu", "--batch", "2"]) == 0
    assert json.loads((out / "a.json").read_text())["labels"] == A_LABELS
    assert json.loads((out / "silence.json").read_text())["labels"] == []
