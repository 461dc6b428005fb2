"""The port's streaming modules (d3roma_tpu_torch/streaming/) against the JAX
package's cases and outputs, on the CPU with stand-in models:

- `MicroBatcher`: the cases of tests/test_batcher.py (order, padding,
  aggregation of concurrent submitters, per-batch errors, draining, the full
  queue, stop racing submit, a dead worker), each on both packages' class;
- `InferenceHTTPServer`: the cases of tests/test_http_server.py (the npz
  round trip, micro-batching without cross-talk, /healthz and /metrics,
  400 / 404 / 500 / 503 / 504), each on both packages' class; and, the
  port's addition, a warm-up that returns a non-finite depth is reported on
  /healthz;
- `D3RoMaProcessor`: the batched drain (tests/test_batcher.py) on both
  packages, and the published clouds equal to the JAX processor's;
- `FileReplaySource` on PNGs the port writes (both namings, 16-bit depth):
  the same frames as the JAX source (OpenCV) reads; `python -m
  d3roma_tpu_torch.camera_test --replay assets/examples` prints the root
  `camera_test.py`'s lines for the bundled capture (latencies apart);
- `select_streaming_mode` with `subprocess.run` replaced: the first
  candidate that runs wins, a failure or a timeout falls through, no winner
  keeps the caller's overrides; the record is appended."""

import io
import json
import queue
import subprocess
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from d3roma_tpu import streaming as jax_streaming
from d3roma_tpu.streaming import probe as jax_probe
from d3roma_tpu_torch import streaming
from d3roma_tpu_torch.streaming import probe
from d3roma_tpu_torch.utils import png

PACKAGES = {"port": streaming, "jax": jax_streaming}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


# ---------------------------------------------------------------- batcher
def test_batcher_orders_and_resolves(pkg):
    calls = []

    def infer(items):
        calls.append(list(items))
        return [x * 10 for x in items]

    mb = pkg.MicroBatcher(infer, max_batch=4, max_wait_ms=50, pad=False)
    futs = [mb.submit(i) for i in range(10)]
    assert [f.result(timeout=5) for f in futs] == [i * 10 for i in range(10)]
    mb.stop()
    assert sum(len(c) for c in calls) == 10 and mb.items == 10


def test_batcher_pads_to_fixed_batch(pkg):
    sizes = []

    def infer(items):
        sizes.append(len(items))
        return [x + 1 for x in items]

    mb = pkg.MicroBatcher(infer, max_batch=8, max_wait_ms=20, pad=True)
    futs = [mb.submit(i) for i in range(3)]
    assert [f.result(timeout=5) for f in futs] == [1, 2, 3]
    mb.stop()
    assert all(s == 8 for s in sizes) and mb.padded_rows >= 5


def test_batcher_aggregates_concurrent_submitters(pkg):
    sizes = []
    gate = threading.Barrier(9)

    def infer(items):
        sizes.append(len(items))
        return items

    mb = pkg.MicroBatcher(infer, max_batch=8, max_wait_ms=200, pad=False)
    results = {}

    def client(i):
        gate.wait()
        results[i] = mb.submit(i).result(timeout=10)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    gate.wait()
    for t in threads:
        t.join()
    mb.stop()
    assert results == {i: i for i in range(8)} and len(sizes) <= 3


def test_batcher_propagates_errors_per_batch(pkg):
    def infer(items):
        raise ValueError("boom")

    mb = pkg.MicroBatcher(infer, max_batch=2, max_wait_ms=10)
    with pytest.raises(ValueError, match="boom"):
        mb.submit(1).result(timeout=5)
    mb.stop()


def test_batcher_stop_drains(pkg):
    done = []

    def infer(items):
        time.sleep(0.05)
        done.extend(items)
        return items

    mb = pkg.MicroBatcher(infer, max_batch=2, max_wait_ms=5, pad=False)
    futs = [mb.submit(i) for i in range(6)]
    mb.stop(drain=True)
    for f in futs:
        f.result(timeout=5)
    assert sorted(done) == list(range(6))
    with pytest.raises(RuntimeError):
        mb.submit(99)


def test_batcher_full_queue_raises_immediately(pkg):
    hang, inside = threading.Event(), threading.Event()

    def stall(items):
        inside.set()
        hang.wait(10)
        return items

    b = pkg.MicroBatcher(stall, max_batch=1, max_wait_ms=1, queue_size=2)
    try:
        b.submit(1)
        assert inside.wait(10)  # the worker holds the first item
        b.submit(2)
        b.submit(3)
        with pytest.raises(queue.Full):
            b.submit(4)
    finally:
        hang.set()
        b.stop()


def test_batcher_stop_does_not_strand_racing_submit(pkg):
    done = []
    for trial in range(50):
        b = pkg.MicroBatcher(lambda items: items, max_batch=4, max_wait_ms=1)
        futs = []

        def spam():
            for i in range(20):
                try:
                    futs.append(b.submit(i))
                except RuntimeError:
                    return

        t = threading.Thread(target=spam)
        t.start()
        b.stop(drain=True)
        t.join()
        for f in futs:
            assert f.done() or f.cancelled(), trial
        done.append(len(futs))
    assert sum(done) > 0


def test_batcher_worker_death_fails_fast(pkg):
    def fatal(items):
        raise SystemExit("runtime aborted")

    b = pkg.MicroBatcher(fatal, max_batch=1, max_wait_ms=1)
    with pytest.raises(RuntimeError, match="worker died"):
        b.submit(1).result(timeout=5)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        try:
            b.submit(2)
            time.sleep(0.02)
        except RuntimeError:
            break
    else:
        raise AssertionError("submit never failed fast after worker death")


# ------------------------------------------------------------ HTTP server
def _stub(frames):
    """raw_depth + mean(rgb) / 255 per frame: routing through a batch shows."""
    return [raw + np.float32(rgb.mean() / 255.0) for rgb, raw in frames]


def _post_npz(port, rgb=None, raw_depth=None, path="/v1/infer_rgb_raw", data=None):
    if data is None:
        buf = io.BytesIO()
        np.savez_compressed(buf, **({} if rgb is None else {"rgb": rgb}),
                            **({} if raw_depth is None else {"raw_depth": raw_depth}))
        data = buf.getvalue()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, r.read()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, json.loads(r.read())


def _code(fn):
    with pytest.raises(urllib.error.HTTPError) as ei:
        fn()
    return ei.value.code, json.loads(ei.value.read())


@pytest.fixture
def server(pkg):
    s = pkg.InferenceHTTPServer(_stub, max_batch=4, max_wait_ms=20)
    port = s.start()
    yield s, port
    s.stop()


def test_server_infer_roundtrip(server):
    _, port = server
    raw = np.arange(96, dtype=np.float32).reshape(8, 12)
    status, body = _post_npz(port, np.full((8, 12, 3), 255, np.uint8), raw)
    assert status == 200
    np.testing.assert_allclose(np.load(io.BytesIO(body))["depth"], raw + 1.0, rtol=1e-6)


def test_server_concurrent_requests_micro_batch(server):
    s, port = server
    results = {}

    def call(i):
        _, body = _post_npz(port, np.zeros((4, 4, 3), np.uint8), np.full((4, 4), float(i),
                                                                          np.float32))
        results[i] = np.load(io.BytesIO(body))["depth"]

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(8):
        np.testing.assert_allclose(results[i], float(i))
    m = s.metrics
    assert m["frames_served"] == 8 and m["batches"] < 8


def test_server_healthz_and_metrics(server):
    _, port = server
    status, body = _get(port, "/healthz")
    assert status == 200 and body["status"] == "ok"
    _post_npz(port, np.zeros((4, 4, 3), np.uint8), np.ones((4, 4), np.float32))
    _, m = _get(port, "/metrics")
    assert m["requests"] == 1 and m["errors"] == 0 and m["latency_ms"]["p50"] >= 0
    assert set(m["latency_ms"]) == {"p50", "p90", "p99"}


def test_server_bad_payload_is_400(server):
    _, port = server
    assert _code(lambda: _post_npz(port, data=b"not an npz"))[0] == 400
    assert _code(lambda: _post_npz(port, np.zeros((2, 2, 3), np.uint8)))[0] == 400


def test_server_model_failure_is_500_and_counted(pkg):
    def boom(frames):
        raise RuntimeError("device fell over")

    s = pkg.InferenceHTTPServer(boom, max_batch=2, max_wait_ms=5)
    port = s.start()
    try:
        code, body = _code(lambda: _post_npz(port, np.zeros((2, 2, 3), np.uint8),
                                             np.ones((2, 2), np.float32)))
        assert code == 500 and body["error"].startswith("RuntimeError")
        assert s.metrics["errors"] == 1
    finally:
        s.stop()


def test_server_unknown_path_404(server):
    _, port = server
    assert _code(lambda: _get(port, "/nope"))[0] == 404
    assert _code(lambda: _post_npz(port, np.zeros((2, 2, 3), np.uint8),
                                   np.ones((2, 2), np.float32), path="/nope"))[0] == 404


def test_server_malformed_arrays_are_400_not_batched(server):
    s, port = server
    good = np.ones((4, 4), np.float32)
    for rgb, raw in ((np.zeros((3, 4, 4), np.uint8), good),
                     (np.zeros((4, 4, 3), np.float32), good),
                     (np.zeros((4, 4, 3), np.uint8), good.ravel()),
                     (np.zeros((4, 4, 3), np.uint8), np.ones((8, 8), np.float32)),
                     (np.zeros((4, 4, 3), np.uint8), np.ones((4, 4), np.int32))):
        code, body = _code(lambda: _post_npz(port, rgb, raw))
        assert code == 400, (rgb.shape, rgb.dtype, raw.shape)
    assert "uint8" in _code(lambda: _post_npz(port, np.random.rand(4, 4, 3).astype(np.float32),
                                              good))[1]["error"]
    assert s.metrics["batched_items"] == 0
    assert _post_npz(port, np.zeros((4, 4, 3), np.uint8), good)[0] == 200


def _until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.01)


def test_server_full_backlog_is_503(pkg):
    hang, inside = threading.Event(), threading.Event()

    def stall(frames):
        inside.set()
        hang.wait(30)
        return [raw for _, raw in frames]

    s = pkg.InferenceHTTPServer(stall, max_batch=1, max_wait_ms=1)
    s._batcher._q.maxsize = 1  # a backlog of one frame
    port = s.start()
    try:
        frame = (np.zeros((2, 2, 3), np.uint8), np.ones((2, 2), np.float32))
        first = threading.Thread(target=lambda: _post_npz(port, *frame))
        first.start()
        assert inside.wait(10)  # the worker holds the first frame
        second = threading.Thread(target=lambda: _post_npz(port, *frame))
        second.start()
        _until(lambda: s._batcher._q.full())  # the second fills the queue
        code, body = _code(lambda: _post_npz(port, *frame))
        assert code == 503 and "queue full" in body["error"]
    finally:
        hang.set()
        first.join()
        second.join()
        s.stop()


def test_server_stalled_model_times_out_504(pkg):
    hang = threading.Event()

    def stall(frames):
        hang.wait(30)
        return [raw for _, raw in frames]

    s = pkg.InferenceHTTPServer(stall, max_batch=2, max_wait_ms=5, request_timeout_s=0.3)
    port = s.start()
    try:
        assert _code(lambda: _post_npz(port, np.zeros((2, 2, 3), np.uint8),
                                       np.ones((2, 2), np.float32)))[0] == 504
        assert s.metrics["errors"] == 1
    finally:
        hang.set()
        s.stop()


def test_server_healthz_warming_until_warmup_done(pkg):
    release, done = threading.Event(), threading.Event()

    def slow_first(frames):
        release.wait(30)
        done.set()
        return [raw for _, raw in frames]

    warm = (np.zeros((2, 2, 3), np.uint8), np.ones((2, 2), np.float32))
    s = pkg.InferenceHTTPServer(slow_first, max_batch=2, max_wait_ms=5, warmup_input=warm)
    port = s.start()
    try:
        code, body = _code(lambda: _get(port, "/healthz"))
        assert code == 503 and body["status"] == "warming"
        release.set()
        assert done.wait(10)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                assert _get(port, "/healthz")[1]["status"] == "ok"
                break
            except urllib.error.HTTPError:
                time.sleep(0.02)
        else:
            raise AssertionError("healthz never became ready")
    finally:
        release.set()
        s.stop()


def test_port_server_reports_a_non_finite_warmup():
    def nan_model(frames):
        return [np.full(raw.shape, np.nan, np.float32) for _, raw in frames]

    warm = (np.zeros((2, 2, 3), np.uint8), np.ones((2, 2), np.float32))
    s = streaming.InferenceHTTPServer(nan_model, max_batch=1, max_wait_ms=1, warmup_input=warm)
    port = s.start()
    try:
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            try:
                status, body = _get(port, "/healthz")
                break
            except urllib.error.HTTPError:  # 503 while warming
                time.sleep(0.02)
        assert status == 200 and "non-finite" in body["warmup_error"]
    finally:
        s.stop()


# -------------------------------------------------------------- processor
class _StubDroma:
    def __init__(self):
        self.calls = []

    def infer_with_rgb_raw(self, rgb, depth):
        self.calls.append(1)
        return depth[::2, ::2] * 1.5

    def infer_with_rgb_raw_batch(self, frames):
        self.calls.append(len(frames))
        return [d[::2, ::2] * 1.5 for _, d in frames]


def _frames(n, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, 256, (24, 32, 3)).astype(np.uint8),
             rs.uniform(0.5, 1.5, (24, 32)).astype(np.float32)) for _ in range(n)]


def test_processor_batched_drain(pkg):
    K = np.eye(3) * 50.0
    K[2, 2] = 1
    stub, published = _StubDroma(), []
    proc = pkg.D3RoMaProcessor(stub, K, publish=lambda r, p, m: published.append(1), max_batch=4)
    frames = _frames(3)
    proc.process_frames(frames)
    assert stub.calls == [4] and len(published) == 3 and proc.frames_processed == 3
    proc.process_frame(*frames[0])  # a single frame rides the padded batch too
    assert stub.calls == [4, 4]


@pytest.mark.parametrize("max_batch", [1, 3])
def test_processor_clouds_match_jax(max_batch):
    K = np.array([[30.0, 0, 8.0], [0, 30.0, 6.0], [0, 0, 1]])
    T = np.eye(4)
    T[:3, 3] = (0.1, -0.2, 0.05)
    out = {}
    for name, mod in PACKAGES.items():
        got = []
        proc = mod.D3RoMaProcessor(_StubDroma(), K, publish=lambda r, p, m: got.append((r, p)),
                                   extrinsic=T, voxel_size=0.02, max_batch=max_batch)
        proc.process_frames(_frames(3, seed=1))
        out[name] = got
    assert len(out["port"]) == len(out["jax"]) == 3
    for (pr, pp), (jr, jp) in zip(out["port"], out["jax"]):
        for a, b in ((pr, jr), (pp, jp)):
            assert len(a[0]) > 0
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])


# ---------------------------------------------------------------- sources
@pytest.mark.parametrize("tag", ["_color.png", "_rgb.png"])
def test_file_replay_matches_jax(tmp_path, tag):
    rs = np.random.RandomState(2)
    for i in range(3):
        png.write_png(str(tmp_path / f"{i:04d}{tag}"),
                      rs.randint(0, 256, (20, 30, 3)).astype(np.uint8))
        png.write_png(str(tmp_path / f"{i:04d}_depth.png"),
                      rs.randint(0, 6000, (20, 30)).astype(np.uint16))
    ours = list(streaming.FileReplaySource(str(tmp_path)).frames())
    ref = list(jax_streaming.FileReplaySource(str(tmp_path)).frames())
    assert len(ours) == len(ref) == 3
    for (a_rgb, a_d), (b_rgb, b_d) in zip(ours, ref):
        assert a_rgb.dtype == b_rgb.dtype == np.uint8 and np.array_equal(a_rgb, b_rgb)
        assert a_d.dtype == b_d.dtype == np.float32 and np.array_equal(a_d, b_d)
    looped = streaming.FileReplaySource(str(tmp_path), loop=True).frames()
    assert len([next(looped) for _ in range(5)]) == 5


def test_camera_test_replay_matches_jax(capsys):
    """Both scripts on the bundled capture: two threads of three frames,
    the same shapes on every line (the latencies are wall times)."""
    import importlib.util
    import os
    import re

    from d3roma_tpu_torch import camera_test

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("jax_camera_test",
                                                  os.path.join(repo, "camera_test.py"))
    jax_camera_test = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_camera_test)
    argv = ["--replay", os.path.join(repo, "assets", "examples"), "--frames", "3"]
    outputs = []
    for main in (camera_test.main, jax_camera_test.main):
        main(argv)
        outputs.append(sorted(re.sub(r"[0-9.]+ ?ms", "MS", line)
                              for line in capsys.readouterr().out.splitlines()))
    assert outputs[0] == outputs[1]
    assert len(outputs[0]) == 7 and outputs[0][-1] == "mean latency: MS over 6 frames"
    assert "[t0] frame 2: (360, 640, 3) (360, 640) MS" in outputs[0]


def test_file_replay_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        streaming.FileReplaySource(str(tmp_path))
    png.write_png(str(tmp_path / "0000_rgb.png"), np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(FileNotFoundError, match="depth"):
        list(streaming.FileReplaySource(str(tmp_path)).frames())


# ------------------------------------------------------------------ probe
def _fake_run(outcomes, seen):
    """subprocess.run stand-in: the candidate's mode decides the outcome."""

    def run(cmd, timeout=None, capture_output=False, **kw):
        mode = cmd[-1].split("=")[-1]
        seen.append(cmd)
        result = outcomes[mode]
        if result == "timeout":
            raise subprocess.TimeoutExpired(cmd, timeout)
        return subprocess.CompletedProcess(cmd, result, b"", b"kernel build failed")

    return run


@pytest.mark.parametrize("mod", [probe, jax_probe], ids=["port", "jax"])
@pytest.mark.parametrize("outcomes,winner", [
    ({"latency": 0, "dense": 0, "throughput": 0}, "latency"),
    ({"latency": 1, "dense": "timeout", "throughput": 0}, "throughput"),
    ({"latency": 1, "dense": 1, "throughput": 1}, None),
])
def test_probe_selects_the_first_that_runs(tmp_path, monkeypatch, mod, outcomes, winner):
    seen = []
    monkeypatch.setattr(mod.subprocess, "run", _fake_run(outcomes, seen))
    rec = tmp_path / "results.jsonl"
    out = mod.select_streaming_mode(["task=eval_ldm_mixed_rgb+raw"], timeout_s=5,
                                    records_path=str(rec))
    assert out["mode"] == winner
    order = list(mod.STREAMING_CANDIDATES)
    assert order == ["latency", "dense", "throughput"]
    tried = order[:order.index(winner) + 1] if winner else order
    assert [p["mode"] for p in out["probe"]] == tried
    assert [p["ok"] for p in out["probe"]] == [m == winner for m in tried]
    assert all(("error" in p) != p["ok"] for p in out["probe"])
    assert out["overrides"] == ["task=eval_ldm_mixed_rgb+raw"] + (
        [f"task.fast_inference={winner}"] if winner else [])
    assert all(c[2] == ("d3roma_tpu_torch.streaming.probe" if mod is probe
                        else "d3roma_tpu.streaming.probe") for c in seen)
    line = json.loads(rec.read_text().splitlines()[-1])
    assert line["kind"] == "streaming_probe" and line["mode"] == winner


def test_port_probe_reports_the_failure(tmp_path, monkeypatch):
    monkeypatch.setattr(probe.subprocess, "run", _fake_run(
        {"latency": 3, "dense": 0, "throughput": 0}, []))
    out = probe.select_streaming_mode([], records_path=str(tmp_path / "r.jsonl"), device="cpu")
    first = out["probe"][0]
    assert out["mode"] == "dense" and not first["ok"]
    assert first["error"].startswith("exit 3:") and "kernel build failed" in first["error"]


def test_serve_exits_when_no_candidate_runs(tmp_path, monkeypatch, capsys):
    """--auto-mode with every candidate failing: the server reports each
    failure and exits 1; it builds no model and serves nothing."""
    from d3roma_tpu_torch import inference, serve

    monkeypatch.setattr(probe.subprocess, "run", _fake_run(
        {"latency": 1, "dense": "timeout", "throughput": 1}, []))
    monkeypatch.setattr(probe, "_ROOT", str(tmp_path))  # the records go there

    def no_model(*a, **kw):
        raise AssertionError("serve built a model with no candidate running")

    monkeypatch.setattr(inference, "D3RoMa", no_model)
    assert serve.main(["--auto-mode", "--device", "cpu", "--port", "0",
                       "task=eval_ldm_mixed_rgb+raw"]) == 1
    err = capsys.readouterr().err
    assert "no candidate ran; not serving" in err
    assert "latency: exit 1:" in err and "kernel build failed" in err
    assert "dense: probe timed out" in err
