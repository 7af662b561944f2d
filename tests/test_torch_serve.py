"""The port's serving daemon (vision_kit_tpu_torch/serve.py) on the CPU.

Its decode_request_bytes equals the JAX package's on the same bytes; its
InferenceServer answers the JAX server's detections for the same JPEGs
(same v5n weights, carried across); and tests/test_serve.py's cases that
have a counterpart (all but the mesh-sharded predictor and the vkio-against-
cv2 check) run against it. Every blocking call has a timeout and every
server stops in a fixture's finally, so a hang fails one test.
"""

import http.client
import json
import os
import socket
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vision_kit_tpu.models.architectures import YOLOV5 as JaxYOLOV5
from vision_kit_tpu.predictor import Predictor as JaxPredictor
from vision_kit_tpu.serve import InferenceServer as JaxServer
from vision_kit_tpu.serve import decode_request_bytes as jax_decode_request_bytes
from vision_kit_tpu_torch.ops.letterbox import scale_coords
from vision_kit_tpu_torch.predictor import Predictor
from vision_kit_tpu_torch.serve import InferenceServer, _Request, decode_request_bytes
from vision_kit_tpu_torch.utils.serve_bench import bench_load_curve
from test_torch_model import REPO, _numpy_tree, port_v5
from torch_samples import SAMPLES, with_exif

torch.set_num_threads(2)

IMG_SIZE = (64, 64)
TIMEOUT = 60


def _test_image(h=96, w=128, seed=0):
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 60, np.uint8)
    x, y = int(rng.integers(0, w - 40)), int(rng.integers(0, h - 40))
    img[y:y + 32, x:x + 40] = (220, 40, 40)
    return img


def _jpeg_bytes(img_rgb, quality=95):
    ok, enc = cv2.imencode(".jpg", cv2.cvtColor(img_rgb, cv2.COLOR_RGB2BGR),
                           [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return enc.tobytes()


def _post(url, data, timeout=TIMEOUT):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _get(url, timeout=TIMEOUT):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _rows(payload):
    return np.array([d["box"] + [d["score"], d["class"]]
                     for d in payload["detections"]], np.float32).reshape(-1, 6)


@pytest.fixture(scope="module")
def weights():
    """tests/test_serve.py's model (v5n, 2 classes, PRNGKey(3)) with its head
    biases zeroed and its head kernels scaled to unit logit spread on a
    probe frame: as initialised, no score passes conf 0.01 on these frames
    and the servers' answers would be empty."""
    jm = JaxYOLOV5(variant="n", num_classes=2)
    v = _numpy_tree(jm.init(jax.random.PRNGKey(3), jnp.zeros((1, *IMG_SIZE, 3)),
                            training=False))
    head = v["params"]["head"]
    for i in range(3):
        head[f"m_{i}"]["bias"] = np.zeros_like(head[f"m_{i}"]["bias"])
    probe = np.random.default_rng(4).integers(0, 255, (1, *IMG_SIZE, 3), np.uint8)
    _, raws = jm.apply(v, jnp.asarray(probe), training=False)
    for i, raw in enumerate(raws):
        head[f"m_{i}"]["kernel"] = (head[f"m_{i}"]["kernel"]
                                    / np.asarray(raw).std()).astype(np.float32)
    return jm, v


@pytest.fixture(scope="module")
def server(weights):
    _, v = weights
    pred = Predictor(port_v5("n", v, num_classes=2), img_size=IMG_SIZE,
                     conf_thres=0.01, iou_thres=0.45, device="cpu")
    srv = InferenceServer(pred, class_labels=["red", "green"], batch_size=4,
                          max_wait_ms=300.0, port=0)
    try:
        srv.start()
        yield srv
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def jax_server(weights):
    jm, v = weights
    pred = JaxPredictor(jm, v, img_size=IMG_SIZE, conf_thres=0.01, iou_thres=0.45)
    srv = JaxServer(pred, class_labels=["red", "green"], batch_size=4,
                    max_wait_ms=300.0, port=0)
    try:
        srv.start()
        yield srv
    finally:
        srv.stop()


# -- decode_request_bytes against JAX's -------------------------------------


def _payloads():
    """JPEGs and PNGs of several sizes, one with an EXIF rotation."""
    out = {
        "jpeg_96x128": _jpeg_bytes(_test_image(seed=1)),
        "jpeg_200x300": _jpeg_bytes(_test_image(200, 300, seed=4), 90),
        "jpeg_odd_57x91": _jpeg_bytes(_test_image(57, 91, seed=5), 80),
        "jpeg_64x64": _jpeg_bytes(_test_image(64, 64, seed=6)),
        "jpeg_exif6": with_exif(_jpeg_bytes(_test_image(80, 120, seed=7)), 6),
    }
    ok, enc = cv2.imencode(".png", cv2.cvtColor(_test_image(80, 100, seed=8),
                                                cv2.COLOR_RGB2BGR))
    out["png_80x100"] = enc.tobytes()
    with open(os.path.join(SAMPLES, "odd_333x517.jpg"), "rb") as f:
        out["sample_odd"] = f.read()
    return out


@pytest.mark.parametrize("name", sorted(_payloads()))
def test_decode_request_bytes_equals_jax(name, monkeypatch):
    data = _payloads()[name]
    got = decode_request_bytes(data, IMG_SIZE, "cpu")
    monkeypatch.setenv("VK_NO_NATIVE", "1")   # JAX's cv2 path: ratio in f64
    want = jax_decode_request_bytes(data, IMG_SIZE)
    assert got is not None and want is not None
    img, (ratio, pad), hw0 = got
    assert img.dtype == torch.uint8 and img.device.type == "cpu"
    np.testing.assert_array_equal(img.numpy(), want[0])
    assert (ratio, pad) == want[1]
    assert tuple(hw0) == tuple(want[2])


def test_decode_request_bytes_refusals_and_device_rule():
    assert decode_request_bytes(b"", IMG_SIZE, "cpu") is None
    assert decode_request_bytes(b"this is not an image", IMG_SIZE, "cpu") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            decode_request_bytes(_jpeg_bytes(_test_image()), IMG_SIZE)


# -- the server against JAX's server ----------------------------------------


def test_server_matches_jax_server(server, jax_server):
    """The same 6 JPEGs POSTed to both servers: the same detections, classes
    exact, scores within 1e-4 and boxes within 1e-2 px plus 1e-3: both
    servers round to 5 and 2 decimals, so two boxes a few f32 ulps apart
    can land one rounding step (0.01 px) apart, and the f32 CPU forwards
    agree to ~1e-3 px."""
    jpegs = [_jpeg_bytes(_test_image(h, w, seed=s), q) for h, w, s, q in (
        (96, 128, 11, 95), (200, 300, 12, 90), (64, 64, 13, 95),
        (57, 91, 14, 80), (480, 640, 15, 90), (120, 80, 16, 95))]
    n = 0
    for data in jpegs:
        _, ours = _post(f"http://127.0.0.1:{server.port}/predict", data)
        _, theirs = _post(f"http://127.0.0.1:{jax_server.port}/predict", data)
        assert (ours["width"], ours["height"]) == (theirs["width"], theirs["height"])
        got, want = _rows(ours), _rows(theirs)
        assert len(got) == len(want)
        order_g = np.lexsort((got[:, 0], -got[:, 4]))
        order_w = np.lexsort((want[:, 0], -want[:, 4]))
        got, want = got[order_g], want[order_w]
        np.testing.assert_array_equal(got[:, 5], want[:, 5])
        np.testing.assert_allclose(got[:, 4], want[:, 4], atol=1e-4, rtol=0)
        np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-2 + 1e-3, rtol=0)
        n += len(got)
    assert n > 0


# -- tests/test_serve.py's cases on the port --------------------------------


def test_healthz(server):
    status, payload = _get(f"http://127.0.0.1:{server.port}/healthz")
    assert status == 200
    assert payload == {"ok": True, "platform": "cpu", "img_size": list(IMG_SIZE),
                       "batch_size": 4}


def test_predict_single(server):
    status, payload = _post(f"http://127.0.0.1:{server.port}/predict",
                            _jpeg_bytes(_test_image(seed=1)))
    assert status == 200
    assert payload["width"] == 128 and payload["height"] == 96
    assert payload["batched"] >= 1
    for det in payload["detections"]:
        x1, y1, x2, y2 = det["box"]
        assert 0 <= x1 <= x2 <= 128 and 0 <= y1 <= y2 <= 96
        assert 0.0 <= det["score"] <= 1.0
        assert det["label"] in ("red", "green")


def test_predict_matches_direct_predictor(server):
    """The HTTP path is the documented computation: bytes -> letterbox ->
    padded fixed batch -> Predictor.run -> scale_coords."""
    data = _jpeg_bytes(_test_image(seed=2))
    status, payload = _post(f"http://127.0.0.1:{server.port}/predict", data)
    assert status == 200
    lb, (ratio, pad), hw0 = decode_request_bytes(data, IMG_SIZE, "cpu")
    imgs = torch.zeros((4, *IMG_SIZE, 3), dtype=torch.uint8)
    imgs[0] = lb
    dets, valid = server.predictor.run(imgs)
    want = scale_coords(IMG_SIZE, dets[0][valid[0]].numpy(), hw0,
                        ratio_pad=(ratio, pad))
    got = _rows(payload)
    assert len(got) == len(want) > 0
    # the response rounds boxes to 2 decimals and scores to 5
    np.testing.assert_allclose(got[:, :4], want[:, :4], atol=0.51)
    np.testing.assert_allclose(got[:, 4], want[:, 4], atol=1e-4)
    np.testing.assert_array_equal(got[:, 5], want[:, 5])


def test_conf_post_filter(server):
    data = _jpeg_bytes(_test_image(seed=3))
    url = f"http://127.0.0.1:{server.port}/predict"
    _, base = _post(url, data)
    _, strict = _post(url + "?conf=0.99", data)
    base_scores = {d["score"] for d in base["detections"]}
    for d in strict["detections"]:
        assert d["score"] >= 0.99
        assert d["score"] in base_scores
    assert len(strict["detections"]) <= len(base["detections"])


def test_dynamic_batching_coalesces(server):
    """Concurrent clients ride one dispatch (padded fixed batch)."""
    url = f"http://127.0.0.1:{server.port}/predict"
    n = 4
    barrier = threading.Barrier(n, timeout=TIMEOUT)
    results = [None] * n

    def worker(i):
        data = _jpeg_bytes(_test_image(seed=10 + i))
        barrier.wait()
        results[i] = _post(url, data)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    assert all(r is not None and r[0] == 200 for r in results)
    # with a 300 ms coalescing window and simultaneous posts, at least one
    # batch must have carried more than one request
    assert max(r[1]["batched"] for r in results) >= 2
    status, stats = _get(f"http://127.0.0.1:{server.port}/stats")
    assert status == 200
    assert stats["requests"] >= n
    assert stats["batches"] >= 1
    assert stats["p50_batch_ms"] is not None


def test_bad_body_is_400(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(f"http://127.0.0.1:{server.port}/predict", b"this is not an image")
    assert ei.value.code == 400


def test_unknown_path_is_404(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(f"http://127.0.0.1:{server.port}/nope")
    assert ei.value.code == 404


def test_truncated_body_is_400_and_server_survives(server):
    s = socket.create_connection(("127.0.0.1", server.port), timeout=TIMEOUT)
    try:
        s.sendall(b"POST /predict HTTP/1.1\r\nHost: x\r\nContent-Length: 1000\r\n"
                  b"\r\nonly-a-few-bytes")
        s.shutdown(socket.SHUT_WR)
        resp = s.recv(65536).decode(errors="replace")
    finally:
        s.close()
    assert " 400 " in resp.splitlines()[0]
    status, payload = _get(f"http://127.0.0.1:{server.port}/healthz")
    assert status == 200 and payload["ok"] is True


def test_oversized_body_is_413(server):
    s = socket.create_connection(("127.0.0.1", server.port), timeout=TIMEOUT)
    try:
        s.sendall(b"POST /predict HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Length: 9999999999\r\n\r\n")
        resp = s.recv(65536).decode(errors="replace")
    finally:
        s.close()
    assert " 413 " in resp.splitlines()[0]


def test_post_unknown_path_does_not_corrupt_keepalive(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=TIMEOUT)
    try:
        conn.request("POST", "/nope", body=b"\x08garbage-image-bytes" * 100)
        resp = conn.getresponse()
        assert resp.status == 404
        resp.read()
        assert resp.getheader("Connection") == "close" or resp.isclosed()
    finally:
        conn.close()
    status, _ = _get(f"http://127.0.0.1:{server.port}/healthz")
    assert status == 200


def test_completion_firewall_survives_bad_request_object(server):
    """A malformed request errors itself and does not kill the completion
    thread."""
    h, w = server.img_size
    bad = _Request(torch.zeros((h, w, 3), dtype=torch.uint8), 1.0, (0.0, 0.0),
                   (h, w), conf="not-a-float")
    server._queue.put(bad, timeout=TIMEOUT)
    assert bad.event.wait(TIMEOUT)
    assert bad.error is not None and "postprocess" in bad.error
    status, payload = _post(f"http://127.0.0.1:{server.port}/predict",
                            _jpeg_bytes(_test_image(seed=9)))
    assert status == 200 and "detections" in payload


def test_post_without_content_length_is_400_and_closes(server):
    s = socket.create_connection(("127.0.0.1", server.port), timeout=TIMEOUT)
    try:
        s.sendall(b"POST /predict HTTP/1.1\r\nHost: x\r\n"
                  b"Transfer-Encoding: chunked\r\n\r\n5\r\nhello\r\n0\r\n\r\n")
        resp = s.recv(65536).decode(errors="replace")
    finally:
        s.close()
    assert " 400 " in resp.splitlines()[0]
    assert "connection: close" in resp.lower()
    status, _ = _get(f"http://127.0.0.1:{server.port}/healthz")
    assert status == 200


def test_empty_bytes_decode_returns_none():
    assert decode_request_bytes(b"", (64, 64), "cpu") is None


def test_decode_request_bytes_png():
    img = _test_image(h=80, w=100, seed=5)
    ok, enc = cv2.imencode(".png", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    assert ok
    out = decode_request_bytes(enc.tobytes(), (64, 64), "cpu")
    assert out is not None
    assert out[2] == (80, 100)


def test_bench_load_curve_paces_and_measures(server):
    """utils/serve_bench.bench_load_curve: paced submission at a fraction
    of a given capacity completes every request, reports achieved
    throughput near the offered rate, and ordered p50 <= p99."""
    rows = bench_load_curve(server, capacity_ips=40.0, fracs=[0.5],
                            n_requests=24, warmup_batches=1)
    (frac, offered, achieved, p50, p99), = rows
    assert frac == 0.5 and offered == 20.0
    assert 0 < achieved < offered * 2
    assert 0 < p50 <= p99


# -- entry points -----------------------------------------------------------


def _sample(name):
    with open(os.path.join(SAMPLES, name), "rb") as f:
        return f.read()


def test_host_routes_decode_in_the_pool_as_before(server):
    """Every host route (WebP, PNG, BMP, CMYK, a progressive JPEG that ends
    early, a baseline one on the CPU) through the server's worker
    processes: decode_request_bytes gives the bytes it gives on this
    thread, and the served detections equal the predictor's on them."""
    from vision_kit_tpu_torch.serve import HOST_DECODE_PROCESSES

    pool = server._pool
    assert pool.size == HOST_DECODE_PROCESSES == len(set(pool.pids()))
    url = f"http://127.0.0.1:{server.port}/predict"
    for name in ("lossy_240x320.webp", "palette_120x160.png", "rle8_120x160.bmp",
                 "cmyk_120x160.jpg", "progressive_4of10_240x320.jpg", "s444_240x320.jpg"):
        data = _sample(name)
        img, (ratio, pad), hw0 = decode_request_bytes(data, IMG_SIZE, "cpu", pool.decode)
        want_img, want_meta, want_hw0 = decode_request_bytes(data, IMG_SIZE, "cpu")
        assert torch.equal(img, want_img) and ((ratio, pad), hw0) == (want_meta, want_hw0)
        status, payload = _post(url, data)
        assert status == 200, name
        dets, valid = server.predictor.run(torch.stack([img] * server.batch_size))
        want = scale_coords(IMG_SIZE, dets[0][valid[0]].numpy(), hw0, ratio_pad=(ratio, pad))
        got = _rows(payload)
        assert len(got) == len(want), name
        np.testing.assert_allclose(got[:, :5], want[:, :5], rtol=0, atol=5e-3)


def test_a_killed_decode_worker_fails_its_request_and_is_replaced(server):
    """A worker killed while it decodes a body (the 2048x2048 WebP, seconds
    of Python loops) answers that request with 500 naming it; the pool
    spawns a replacement, and the next host-route request is answered."""
    import signal
    import time

    pool = server._pool
    before, replaced = set(pool.pids()), pool.replaced
    url = f"http://127.0.0.1:{server.port}/predict"
    answer = {}

    def post_big():
        try:
            answer["ok"] = _post(url, _sample("large_2048x2048.webp"))
        except urllib.error.HTTPError as e:
            answer["code"], answer["body"] = e.code, json.loads(e.read())

    thread = threading.Thread(target=post_big)
    thread.start()
    deadline = time.monotonic() + TIMEOUT
    while not pool.busy_pids() and time.monotonic() < deadline:
        time.sleep(0.05)
    (victim,) = pool.busy_pids()
    os.kill(victim, signal.SIGKILL)
    thread.join(TIMEOUT)
    assert not thread.is_alive()
    assert answer.get("code") == 500 and "worker died" in answer["body"]["error"], answer
    assert pool.replaced == replaced + 1 and pool.size == len(before)
    assert victim not in pool.pids() and len(set(pool.pids()) - before) == 1
    status, payload = _post(url, _sample("lossy_240x320.webp"))
    assert status == 200 and (payload["height"], payload["width"]) == (240, 320)


def test_server_over_a_cuda_predictor_raises_without_cuda(weights):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA entry points run")
    _, v = weights
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceServer(Predictor(port_v5("n", v, num_classes=2), img_size=IMG_SIZE,
                                  device="cuda"), port=0)


def _cli(*args, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.Popen([sys.executable, "-m", "vision_kit_tpu_torch", *args],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, **kw)


def test_cli_serve_help():
    proc = _cli("serve", "--help")
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0
    for flag in ("--weights", "--config", "--num-classes", "--labels", "--conf",
                 "--iou", "--host", "--port", "--batch-size", "--max-wait-ms",
                 "--device"):
        assert flag in out


def test_cli_serve_starts_a_server(tmp_path):
    """python -m vision_kit_tpu_torch serve on the CPU: v5n at 64 from a
    config, answering /healthz and a POST."""
    import yaml

    with open(os.path.join(REPO, "configs", "yolov5.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["model"].update(version="n", num_classes=2, input_size=[64, 64])
    cfg["data"]["class_labels"] = ["red", "green"]
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    proc = _cli("serve", "-c", str(path), "--device", "cpu", "--port", "0",
                "--batch-size", "2", "--max-wait-ms", "1", "--conf", "0.01")
    try:
        port = None
        result = {}

        def read():
            for line in proc.stdout:
                if "serving" in line and "http://" in line:
                    result["port"] = int(line.split("http://")[1].split()[0].rsplit(":", 1)[1])
                    return

        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        reader.join(180)
        port = result.get("port")
        assert port, "the server did not report its port"
        status, payload = _get(f"http://127.0.0.1:{port}/healthz")
        assert status == 200 and payload["platform"] == "cpu"
        assert payload["img_size"] == [64, 64] and payload["batch_size"] == 2
        status, payload = _post(f"http://127.0.0.1:{port}/predict",
                                _jpeg_bytes(_test_image(seed=1)))
        assert status == 200 and payload["width"] == 128
        for det in payload["detections"]:
            assert det["label"] in ("red", "green")
    finally:
        proc.kill()
        proc.wait(30)
