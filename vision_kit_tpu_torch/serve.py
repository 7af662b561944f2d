"""Batched HTTP inference server: counterpart of vision_kit_tpu/serve.py.

Requests are coalesced by a dispatcher into fixed-shape batches (padded to
`batch_size`), run by `Predictor.run` on the card, and read back by a
completion thread, so that one batch's readback can overlap the next
one's dispatch (as far as `Predictor.run` lets it: it returns only once
its batch is done, since it builds its pad and bound tensors from Python
values with blocking copies). Each request's bytes decode and letterbox on the request's
device before it is queued (`decode_request_bytes`): on the card a JPEG
through nvJPEG, or on the host and uploaded by its header's route (a PNG,
a BMP, a WebP, a CMYK/RGB JPEG, a progressive one ending early, one whose
scans run out of bits; on the CPU every body), the host decodes in a pool
of spawned worker processes (HostDecodePool, HOST_DECODE_PROCESSES) so that
their Python loops never hold the handlers' interpreter lock, then
`letterbox_u8` (cv2's
letterbox, bit for bit) on the card; on the CPU the plain decoder. So the
model sees one (B, S, S, 3) uint8 shape whatever the clients' image sizes,
and detections rescale to each client's frame with `scale_coords`, as in
the JAX server.

On the card each handler thread decodes on a stream of its own; an event
recorded after its letterbox travels with the request, and the dispatcher's
stream waits on it before copying the frame into the batch. The dispatcher
queues each batch's results for an asynchronous copy into pinned host
memory right behind its forward, and records an event there: the
completion thread waits on that event alone, not on the batch dispatched
after it.

Over a data-parallel Predictor (Predictor(mesh=...), one process per
device under torchrun), every rank builds the server and calls start() or
serve_forever(); rank 0 alone binds HTTP, queues and batches. Before each
batch its dispatcher broadcasts a control word and the (batch_size, S, S,
3) uint8 batch; ranks 1..N-1 run a follow loop that receives them and
calls the same Predictor.run, which shards the batch and gathers the
detections on every rank. A stop word, sent when rank 0 stops, ends the
followers. Each rank makes its collectives from one thread (rank 0's
dispatcher, the others' follow loop, after the warmup in start()), so no
two ranks can order them differently.

HTTP API (stdlib http.server, threaded), the JAX server's:
  POST /predict            body = encoded image (JPEG/PNG/BMP/WebP, and
                           every other kind decode_image takes)
                           optional ?conf= post-filter (>= server conf)
                           -> {"detections": [{"box", "score", "class",
                               "label"}], "width", "height", "batched"}
  GET  /healthz            -> {"ok": true, "platform": "gpu" or "cpu", ...}
  GET  /stats              -> request/batch counters + latency percentiles
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from vision_kit_tpu_torch.data.decode import decode_image, decode_to
from vision_kit_tpu_torch.ops.letterbox import letterbox_u8, scale_coords
from vision_kit_tpu_torch.parallel import mesh as pmesh
from vision_kit_tpu_torch.utils.general import resolve_device


def decode_request_bytes(data: bytes, dst_hw: tuple[int, int],
                         device: str | torch.device = "cuda", host_decode=None):
    """Encoded image bytes -> (letterboxed (H, W, 3) uint8 RGB tensor on
    `device`, (ratio, (dw, dh)), (h0, w0)) or None, by the route
    data/decode.py:decode_to reads from the header: on a CUDA device a
    baseline or complete progressive JPEG through nvJPEG; a PNG, a BMP, a
    WebP, a Netpbm/PAM, PFM, Sun raster, HDR, GIF, TIFF or JPEG 2000
    image, an arithmetic-coded or lossless JPEG, a CMYK/YCCK/RGB JPEG, a
    progressive one that ends early and one whose scans run out of bits
    (or that lacks its EOI) on the host (`host_decode`, decode_image's
    contract; the server passes its worker processes; by default
    decode_image, JPEG 2000 by its host C++ decoder on the card), uploaded;
    on the CPU every kind on the host by the plain decoders. The letterbox
    is letterbox_u8 on `device`."""
    img = decode_to(data, resolve_device(device), host_decode)
    if img is None:
        return None
    out, (ratio, pad) = letterbox_u8(img, dst_hw)
    return out, (ratio, pad), tuple(img.shape[:2])


# Worker processes that the server's host-route decodes run in. The plain
# decoders (WebP, a progressive JPEG that ends early, CMYK, PNG, ...) are
# Python and numpy loops that hold the interpreter lock for up to seconds
# a body; in their own processes they leave the handler threads, the
# dispatcher and the completion thread free, as cv2's C decode does in the
# JAX server. Four: as many host decodes at once as leave the rest of an
# 8-core host to the server's own threads and nvJPEG's Huffman stage,
# while each worker holds an interpreter with torch imported (~0.3 GB).
HOST_DECODE_PROCESSES = 4


def _host_decode_worker(conn, native: bool = False) -> None:
    """A pool worker: "ready" once imported (and, with `native`, once the
    host C++ JPEG 2000 decoder is loaded: a worker that cannot load it
    dies before it), then decode_image(data, native) of each body it
    receives, answered with the (H, W, 3) uint8 array, None, or the
    exception it raised."""
    if native:
        from vision_kit_tpu_torch.data import jp2

        jp2.load_c()
    conn.send("ready")
    while True:
        try:
            data = conn.recv_bytes()
        except (EOFError, OSError):
            return
        try:
            answer = decode_image(data, native)
        except Exception as e:   # answered, not fatal: the next body goes on
            answer = e
        conn.send(answer)


class HostDecodePool:
    """decode_image in spawned worker processes (a forked child would
    inherit the parent's CUDA context), one body per worker at a time.

    `decode(data)` takes an idle worker, sends it the bytes and waits for
    its answer. A worker that dies (killed by the OOM killer, say) fails
    that body's decode with RuntimeError and is replaced by a new one; one
    that answers nothing within `timeout_s` is killed and replaced the same
    way, with TimeoutError. So no body waits on a dead worker. The pool
    is built once every worker has imported the decoder, so that no
    request's time holds a worker's start. `native` decodes JPEG 2000 by
    its host C++ decoder (the server's on a CUDA device): each worker loads
    the library before it is ready, and a pool whose workers cannot load
    it raises RuntimeError."""

    def __init__(self, timeout_s: float = 60.0, native: bool = False):
        import multiprocessing as mp

        self._ctx = mp.get_context("spawn")
        self.timeout_s = float(timeout_s)
        self.native = bool(native)
        self._idle: queue.Queue = queue.Queue()
        self._mu = threading.Lock()
        self._workers: list = []
        self._busy: set = set()
        self._fresh: set = set()   # replacements whose "ready" is unread
        self._closed = False
        self.replaced = 0
        workers = [self._spawn() for _ in range(HOST_DECODE_PROCESSES)]
        for worker in workers:
            if not self._started(worker, time.monotonic() + self.timeout_s):
                self.close()
                raise RuntimeError("a host decode worker did not start")
            self._idle.put(worker)

    @property
    def size(self) -> int:
        return len(self._workers)

    def pids(self) -> list[int]:
        """The workers' process ids."""
        with self._mu:
            return [p.pid for p, _ in self._workers]

    def busy_pids(self) -> list[int]:
        """The process ids of the workers decoding a body now."""
        with self._mu:
            return sorted(self._busy)

    def _spawn(self):
        parent, child = self._ctx.Pipe()
        proc = self._ctx.Process(target=_host_decode_worker, args=(child, self.native),
                                 daemon=True, name="vkt-host-decode")
        proc.start()
        child.close()
        worker = (proc, parent)
        with self._mu:
            self._workers.append(worker)
        return worker

    @staticmethod
    def _started(worker, deadline: float) -> bool:
        """Wait for a new worker's "ready" until `deadline`; False when it
        died or did not answer."""
        proc, conn = worker
        while not conn.poll(0.2):
            if not proc.is_alive() or time.monotonic() > deadline:
                return False
        try:
            return conn.recv() == "ready"
        except (EOFError, OSError):
            return False

    def _retire(self, worker) -> None:
        proc, conn = worker
        with self._mu:
            if worker in self._workers:
                self._workers.remove(worker)
        if proc.is_alive():
            proc.kill()
        proc.join(timeout=5)
        conn.close()

    def decode(self, data: bytes) -> np.ndarray | None:
        """decode_image(data, native) in a worker."""
        deadline = time.monotonic() + self.timeout_s
        while True:
            try:
                worker = self._idle.get(timeout=max(deadline - time.monotonic(), 0))
            except queue.Empty:
                raise TimeoutError("no host decode worker free") from None
            if worker[0].pid in self._fresh:   # a replacement: its "ready" first
                self._fresh.discard(worker[0].pid)
                if self._started(worker, deadline):
                    break
            elif worker[0].is_alive():
                break
            self._retire(worker)   # died while idle: no body was lost
            self._replace()
        proc, conn = worker
        with self._mu:
            self._busy.add(proc.pid)
        try:
            conn.send_bytes(data)
            while not conn.poll(0.2):
                if not proc.is_alive():
                    raise EOFError
                if time.monotonic() > deadline:
                    self._retire(worker)
                    self._replace()
                    raise TimeoutError(f"host decode took over {self.timeout_s:.0f} s")
            answer = conn.recv()
        except (EOFError, OSError):
            code = proc.exitcode
            self._retire(worker)
            self._replace()
            raise RuntimeError(f"host decode worker died (exit code {code})") from None
        finally:
            with self._mu:
                self._busy.discard(proc.pid)
        self._idle.put(worker)
        if isinstance(answer, Exception):
            raise RuntimeError(f"host decode failed: {answer!r}")
        return answer

    def _replace(self) -> None:
        """A new worker in the idle queue, its "ready" read when first taken."""
        if not self._closed:
            self.replaced += 1
            worker = self._spawn()
            self._fresh.add(worker[0].pid)
            self._idle.put(worker)

    def close(self) -> None:
        """End every worker, idle or busy."""
        self._closed = True
        with self._mu:
            workers = list(self._workers)
        for worker in workers:
            self._retire(worker)


class _Request:
    __slots__ = ("img", "ratio", "pad", "hw0", "conf", "event", "dets",
                 "batched", "error", "deadline", "ready")

    def __init__(self, img, ratio, pad, hw0, conf, deadline=None, ready=None):
        self.img = img
        self.ratio = ratio
        self.pad = pad
        self.hw0 = hw0
        self.conf = conf
        self.event = threading.Event()
        self.dets = None
        self.batched = 0
        self.error = None
        # monotonic time after which the waiter has already 504'd; the
        # dispatcher drops expired requests instead of spending batch
        # slots on results nobody reads (overload must drain, not amplify)
        self.deadline = deadline
        # CUDA event recorded after the frame's decode and letterbox on the
        # handler's stream (None on the CPU or for a frame already ready)
        self.ready = ready


_STOP = object()
# the control word rank 0 broadcasts before each batch (or to stop the
# followers) when the server runs over a mesh
_CTRL_BATCH, _CTRL_STOP = 1, 0


class InferenceServer:
    """Dynamic-batching HTTP server over a Predictor.

    One fixed (batch_size, S, S, 3) shape serves every request: the
    dispatcher drains the queue up to `batch_size` items (waiting at most
    `max_wait_ms` after the first), zero-pads the remainder, and runs the
    batch as one `Predictor.run`. Padded slots are discarded. Over a mesh
    Predictor only rank 0 serves HTTP (`port` is None on the others), and
    `batch_size` should divide by the mesh's n_data for the batch to shard.
    """

    def __init__(
        self,
        predictor,
        class_labels=None,
        batch_size: int = 8,
        max_wait_ms: float = 5.0,
        host: str = "127.0.0.1",
        port: int = 8000,
        queue_size: int = 256,
        request_timeout_s: float = 60.0,
        synthetic_ingest: int = 0,
    ):
        self.predictor = predictor
        self.device = resolve_device(predictor.device)
        self.mesh = getattr(predictor, "mesh", None)
        self.is_main = self.mesh is None or self.mesh.is_main
        self.labels = list(class_labels) if class_labels else None
        # BENCHMARK-ONLY ingest mode: with synthetic_ingest=K > 0, start()
        # pre-stages K random uint8 batches on the device and _submit_batch
        # rotates through them instead of assembling request pixels. This
        # measures the engine itself (queueing, batching, dispatch/readback
        # overlap, completion) without the per-batch frame copies. Request
        # results then correspond to the synthetic pixels, so this must
        # never be enabled on a production server.
        self.synthetic_ingest = int(synthetic_ingest)
        self._synth_batches = None
        self._synth_i = 0
        self.batch_size = int(batch_size)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.request_timeout_s = float(request_timeout_s)
        self.img_size = predictor.img_size
        self._queue: queue.Queue = queue.Queue(maxsize=queue_size)
        # dispatch/completion pipeline: the dispatcher submits batches to
        # the device (asynchronous on the card) and hands the in-flight
        # results to a completion thread that pays the device->host wait;
        # the next batch dispatches while the previous one's results are
        # still in flight. maxsize bounds the device queue depth.
        self._inflight: queue.Queue = queue.Queue(maxsize=2)
        self._fn = None  # Predictor.run, set in start() after the warmup
        self._streams = threading.local()  # each handler thread's decode stream
        self._stats_mu = threading.Lock()
        self._n_requests = 0
        self._n_errors = 0
        self._n_batches = 0
        self._n_batched_imgs = 0
        self._lat_ms: list[float] = []  # rolling window
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)
        self._completer = threading.Thread(target=self._completion_loop,
                                           daemon=True)
        self._httpd = None
        self._follower = None
        self._pool = None   # the host-decode workers, rank 0's, from start() on
        if self.is_main:
            self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
            self._httpd.daemon_threads = True
            self._serve_thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True
            )
        else:
            self._follower = threading.Thread(target=self._follow_loop, daemon=True)
        self._started = False

    # -- lifecycle ---------------------------------------------------------

    @property
    def port(self) -> int | None:
        """The bound port; None on a mesh's ranks 1..N-1, which bind none."""
        return self._httpd.server_address[1] if self._httpd is not None else None

    def start(self):
        """Warm the serving shape up (kernel builds, cuDNN's choices) and
        accept connections (rank 0), or follow rank 0's batches (the
        mesh's other ranks). On a CUDA device rank 0 builds and loads the
        host C++ JPEG 2000 decoder (csrc/j2k_decode.cu) before its decode
        workers start; a library that cannot be built or loaded raises
        here, and the server does not start."""
        self.predictor.warmup(self.img_size, self.batch_size)
        self._fn = self.predictor.run
        if not self.is_main:
            self._follower.start()
            self._started = True
            return self
        native = self.device.type == "cuda"
        if native:   # built and loaded here, before the workers load it
            from vision_kit_tpu_torch.data import jp2

            jp2.load_c()
        self._pool = HostDecodePool(timeout_s=self.request_timeout_s, native=native)
        if self.synthetic_ingest > 0:
            h, w = self.img_size
            rng = np.random.default_rng(0)
            self._synth_batches = [
                torch.from_numpy(rng.integers(
                    0, 256, (self.batch_size, h, w, 3), np.uint8)).to(self.device)
                for _ in range(self.synthetic_ingest)
            ]
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self._dispatcher.start()
        self._completer.start()
        self._serve_thread.start()
        self._started = True
        return self

    def stop(self):
        """Shut down. On rank 0 of a mesh this also sends the followers
        their stop word; on the others it waits for that word."""
        if not self.is_main:
            if self._started:
                self._follower.join()
            self._started = False
            return
        if self._started:
            self._queue.put(_STOP)
            self._httpd.shutdown()
            self._dispatcher.join(timeout=10)
            self._completer.join(timeout=10)
        self._httpd.server_close()
        if self._pool is not None:
            self._pool.close()
        self._started = False

    def wait(self):
        """Block until KeyboardInterrupt (a follower: until rank 0 stops),
        then shut down."""
        if not self.is_main:
            self.stop()
            return
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def serve_forever(self):
        """Blocking variant for the CLI."""
        self.start()
        self.wait()

    # -- batching core -----------------------------------------------------

    EXPIRED = "expired before dispatch"

    def _expired(self, req: _Request) -> bool:
        if req.deadline is not None and time.monotonic() >= req.deadline:
            req.error = self.EXPIRED
            req.event.set()  # waiter already timed out; unblock bookkeeping
            with self._stats_mu:
                self._n_errors += 1
            return True
        return False

    def _broadcast_ctrl(self, word: int) -> None:
        """Rank 0's control word to the followers (a mesh only)."""
        if self.mesh is not None:
            pmesh.broadcast_(self.mesh, [torch.tensor([word], device=self.device)])

    def _follow_loop(self):
        """Ranks 1..N-1: receive each control word and batch from rank 0 and
        run it (its collectives answering rank 0's), until the stop word."""
        h, w = self.img_size
        ctrl = torch.zeros(1, dtype=torch.int64, device=self.device)
        batch = torch.zeros((self.batch_size, h, w, 3), dtype=torch.uint8,
                            device=self.device)
        while True:
            pmesh.broadcast_(self.mesh, [ctrl])
            if int(ctrl) == _CTRL_STOP:
                return
            pmesh.broadcast_(self.mesh, [batch])
            self._fn(batch)
            with self._stats_mu:
                self._n_batches += 1

    def _dispatch_loop(self):
        while True:
            first = self._queue.get()
            if first is _STOP:
                self._broadcast_ctrl(_CTRL_STOP)
                self._inflight.put(_STOP)
                return
            if self._expired(first):
                continue
            reqs = [first]
            deadline = time.monotonic() + self.max_wait_s
            stop = False
            while len(reqs) < self.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is _STOP:
                    stop = True
                    break
                if not self._expired(item):
                    reqs.append(item)
            self._submit_batch(reqs)
            if stop:
                self._broadcast_ctrl(_CTRL_STOP)
                self._inflight.put(_STOP)
                return

    def _submit_batch(self, reqs: list[_Request]):
        """Dispatch one padded batch without waiting for it; readback
        happens in the completion thread so the next batch can dispatch
        immediately."""
        t0 = time.perf_counter()
        try:
            if self._synth_batches is not None:  # bench-only device ingest
                batch = self._synth_batches[
                    self._synth_i % len(self._synth_batches)]
                self._synth_i += 1
            else:
                h, w = self.img_size
                batch = torch.zeros((self.batch_size, h, w, 3),
                                    dtype=torch.uint8, device=self.device)
                cuda = self.device.type == "cuda"
                stream = torch.cuda.current_stream(self.device) if cuda else None
                for i, r in enumerate(reqs):
                    if r.ready is not None:
                        stream.wait_event(r.ready)
                    batch[i].copy_(r.img)
                    if cuda:
                        r.img.record_stream(stream)
            if self.mesh is not None:
                self._broadcast_ctrl(_CTRL_BATCH)
                pmesh.broadcast_(self.mesh, [batch])
            dets, valid = self._fn(batch)
            if self.device.type == "cuda":
                # queued right behind this batch's forward, ahead of the next
                dets = dets.to("cpu", non_blocking=True)
                valid = valid.to("cpu", non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
            else:
                done = None
        except Exception as e:  # shape or launch errors surface here
            for r in reqs:
                r.error = f"inference failed: {e}"
                r.event.set()
            with self._stats_mu:
                self._n_errors += len(reqs)
            return
        # blocks when 2 batches are already in flight (bounds device queue)
        self._inflight.put((reqs, (dets, valid, done), t0))

    def _completion_loop(self):
        while True:
            item = self._inflight.get()
            if item is _STOP:
                return
            reqs, (dets_dev, valid_dev, done), t0 = item
            try:
                if done is not None:
                    done.synchronize()  # pays the device->host wait
                dets = dets_dev.numpy()
                valid = valid_dev.numpy()
            except Exception as e:  # asynchronous device failure lands here
                for r in reqs:
                    r.error = f"inference failed: {e}"
                    r.event.set()
                with self._stats_mu:
                    self._n_errors += len(reqs)
                continue
            ms = (time.perf_counter() - t0) * 1000
            for i, r in enumerate(reqs):
                # per-request firewall: one bad rescale/filter must fail
                # that request, not kill this thread (a dead completer
                # wedges the bounded pipeline and 504s everything after)
                try:
                    boxes = scale_coords(
                        self.img_size, dets[i][valid[i]], r.hw0,
                        ratio_pad=(r.ratio, r.pad),
                    )
                    if r.conf is not None:
                        boxes = boxes[boxes[:, 4] >= r.conf]
                    r.dets = boxes
                    r.batched = len(reqs)
                except Exception as e:
                    r.error = f"postprocess failed: {e}"
                    with self._stats_mu:
                        self._n_errors += 1
                r.event.set()
            with self._stats_mu:
                self._n_batches += 1
                self._n_batched_imgs += len(reqs)
                self._lat_ms.append(ms)
                if len(self._lat_ms) > 512:
                    self._lat_ms = self._lat_ms[-512:]

    # -- request handling --------------------------------------------------

    def _decode(self, body: bytes):
        """decode_request_bytes on this thread's own stream on the card, and
        the event that marks its frame ready (None on the CPU). Host routes
        decode in the pool's worker processes; nvJPEG on this thread."""
        host = self._pool.decode
        if self.device.type != "cuda":
            return decode_request_bytes(body, self.img_size, self.device, host), None
        stream = getattr(self._streams, "stream", None)
        if stream is None:
            stream = self._streams.stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(stream):
            decoded = decode_request_bytes(body, self.img_size, self.device, host)
            ready = torch.cuda.Event()
            ready.record(stream)
        return decoded, ready

    def _predict(self, body: bytes, conf: float | None):
        decoded, ready = self._decode(body)
        if decoded is None:
            raise ValueError("could not decode image bytes")
        img, (ratio, pad), hw0 = decoded
        req = _Request(img, ratio, pad, hw0, conf,
                       deadline=time.monotonic() + self.request_timeout_s,
                       ready=ready)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            raise OverflowError("server overloaded (queue full)")
        if not req.event.wait(self.request_timeout_s):
            raise TimeoutError("inference timed out")
        if req.error == self.EXPIRED:
            # the dispatcher's clock crossed the deadline marginally before
            # this waiter's own wait() would have: same outcome, same code
            raise TimeoutError("inference timed out")
        if req.error is not None:
            raise RuntimeError(req.error)
        with self._stats_mu:
            self._n_requests += 1
        dets = req.dets
        out = []
        for row in dets:
            cls = int(row[5])
            out.append({
                "box": [round(float(v), 2) for v in row[:4]],
                "score": round(float(row[4]), 5),
                "class": cls,
                "label": (self.labels[cls]
                          if self.labels and 0 <= cls < len(self.labels)
                          else str(cls)),
            })
        return {
            "detections": out,
            "width": int(req.hw0[1]),
            "height": int(req.hw0[0]),
            "batched": req.batched,
        }

    def _stats(self):
        with self._stats_mu:
            lat = sorted(self._lat_ms)
            n = len(lat)
            pct = (lambda q: round(lat[min(n - 1, int(q * n))], 2)) if n else (
                lambda q: None)
            return {
                "requests": self._n_requests,
                "errors": self._n_errors,
                "batches": self._n_batches,
                "avg_batch": (round(self._n_batched_imgs / self._n_batches, 2)
                              if self._n_batches else 0.0),
                "batch_size": self.batch_size,
                "p50_batch_ms": pct(0.50),
                "p99_batch_ms": pct(0.99),
            }

    def _healthz(self):
        return {
            "ok": True,
            "platform": "gpu" if self.device.type == "cuda" else "cpu",
            "img_size": list(self.img_size),
            "batch_size": self.batch_size,
        }

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # silence per-request spam
                pass

            def _json(self, code: int, payload: dict):
                try:
                    body = json.dumps(payload).encode()
                    self.send_response(code)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    if self.close_connection:
                        # tell keep-alive clients the stream ends here
                        # (set on paths that left the request body unread)
                        self.send_header("Connection", "close")
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client went away; nothing to tell it

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/healthz":
                    self._json(200, server._healthz())
                elif path == "/stats":
                    self._json(200, server._stats())
                else:
                    self._json(404, {"error": f"unknown path {path}"})

            MAX_BODY = 32 * 1024 * 1024  # one encoded image; 413 beyond

            def do_POST(self):
                path, _, query = self.path.partition("?")
                if path != "/predict":
                    # body not consumed: the keep-alive stream is no longer
                    # framed correctly, so close after responding
                    self.close_connection = True
                    self._json(404, {"error": f"unknown path {path}"})
                    return
                length = int(self.headers.get("Content-Length") or 0)
                if length <= 0:
                    # absent Content-Length (e.g. a chunked body): frames
                    # are left unread on the stream, so close it
                    self.close_connection = True
                    self._json(400, {"error": "empty body (a body requires "
                                     "Content-Length; chunked unsupported)"})
                    return
                if length > self.MAX_BODY:
                    self.close_connection = True  # refuse to buffer/drain it
                    self._json(413, {"error": f"body over {self.MAX_BODY} B"})
                    return
                body = self.rfile.read(length)
                if len(body) != length:
                    # truncated upload; stream is desynced, close it
                    self.close_connection = True
                    self._json(400, {"error": "truncated body"})
                    return
                conf = None
                for kv in query.split("&"):
                    if kv.startswith("conf="):
                        try:
                            conf = float(kv[5:])
                        except ValueError:
                            self._json(400, {"error": "bad conf value"})
                            return
                try:
                    self._json(200, server._predict(body, conf))
                except ValueError as e:
                    self._json(400, {"error": str(e)})
                except OverflowError as e:
                    self._json(503, {"error": str(e)})
                except TimeoutError as e:
                    self._json(504, {"error": str(e)})
                except Exception as e:
                    self._json(500, {"error": str(e)})

        return Handler
