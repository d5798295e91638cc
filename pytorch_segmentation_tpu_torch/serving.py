"""Batched HTTP mask server (port of pytorch_segmentation_tpu/serving.py).

- One device batch shape: every batch is padded to a fixed `max_batch`, so
  the device sees one shape for the server's lifetime.
- Micro-batching: concurrent requests within a `batch_window_ms` window
  coalesce into one device batch. A single dispatcher thread owns the
  device; handler threads wait on a per-request event.
- The device path is inference.make_mask_fn: normalize -> forward ->
  fused upsample+argmax. int8=True (or quant_stats) takes the int8 twin,
  quant.make_quant_mask_fn; int8 with TTA serves make_infer_fn(int8=True)'s
  probabilities and takes their argmax on the host.
- Requests are decoded, resized to the model size, and masks resized back
  and encoded, on the host in numpy and torch, with the port's own codecs:
  a body is read by its signature as cv2.imdecode(..., IMREAD_COLOR) reads
  it (utils/imgcodecs.py: PNG, or JPEG through csrc/jpeg_codec.cpp with its
  EXIF orientation applied) and masks are written as PNG (utils/png.py):
  no OpenCV.

Endpoints:
  GET  /healthz            -> {"status": "ok", "model": ..., ...}
  POST /predict            -> body: PNG (8-bit gray/RGB/RGBA) or JPEG
                              (baseline or progressive, gray or colour)
                              image, any size; response: VOC-palette PNG
                              mask at the image's own (upright) resolution
  POST /predict?format=raw -> response: PNG with raw class ids (grayscale)
A body that is neither a readable PNG nor a readable JPEG gets a 400; a
failure on the device gets a 500.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .data.colormap import VOC_COLORMAP, colorize_mask
from .inference import make_infer_fn, make_mask_fn
from .ops.resize import resize_bilinear, resize_nearest
from .quant import make_quant_mask_fn
from .utils.imgcodecs import IMREAD_COLOR, imdecode
from .utils.png import encode_png

__all__ = ["MaskServer"]


class _Pending:
    __slots__ = ("image", "done", "mask", "error")

    def __init__(self, image):
        self.image = image  # [h, w, 3] u8 RGB at model input size
        self.done = threading.Event()
        self.mask = None
        self.error = None


def _resize_u8(img: np.ndarray, size_wh) -> np.ndarray:
    """Bilinear (half-pixel, align_corners=False) resize of an RGB u8 image
    to (W, H), rounded back to u8."""
    w, h = size_wh
    if img.shape[:2] == (h, w):
        return np.ascontiguousarray(img)
    x = torch.from_numpy(np.ascontiguousarray(img)).float()
    y = resize_bilinear(x, (h, w), align_corners=False)
    return y.round().clamp(0, 255).to(torch.uint8).numpy()


class MaskServer:
    """Owns the serving function and the micro-batching dispatcher.

    model: an eval-mode module on its device
    (engine.checkpoint.load_model_bundle); img_size: (W, H) model input size
    (requests are resized to it, masks resized back to each request's own
    resolution with nearest interpolation). int8=True serves the int8
    forward (quant.py) with dynamic activation scales, or calibrated ones
    when `quant_stats` (from quant.calibrate_from_u8) is passed.
    mesh=make_mesh() serves every batch over the local cards
    (`inference.make_mask_fn(mesh=)`); `max_batch` is rounded up to a
    multiple of the card count, so that the padded batch divides."""

    def __init__(self, model, img_size=(513, 513), max_batch: int = 8,
                 batch_window_ms: float = 5.0, legacy_preproc: bool = False,
                 int8: bool = False, quant_stats=None, tta_flip: bool = False,
                 tta_scales=(), colormap=None, mesh=None):
        self.img_size = (int(img_size[0]), int(img_size[1]))  # (W, H)
        self.max_batch = max(1, int(max_batch))
        quantized = int8 or quant_stats is not None
        if mesh is not None:
            n = len(mesh.devices)
            self.max_batch = -(-self.max_batch // n) * n
            if quantized and (tta_flip or tta_scales):
                raise ValueError("--dp composes with --int8 or TTA, not the "
                                 "int8+TTA probability path (host argmax; "
                                 "shard it yourself if needed)")
        self.batch_window_s = max(0.0, float(batch_window_ms)) / 1e3
        self.colormap = colormap if colormap is not None else VOC_COLORMAP
        hw = (self.img_size[1], self.img_size[0])
        self._probs_fn = None
        if quantized and (tta_flip or tta_scales):
            # the quantized forward composes with the TTA ensemble in
            # make_infer_fn, which takes no mesh; the argmax runs on the host
            self._probs_fn = make_infer_fn(
                model, legacy_preproc, int8=True, quant_stats=quant_stats,
                tta_flip=tta_flip, tta_scales=tta_scales)
            self._mask_fn = None
        elif quantized:
            self._mask_fn = make_quant_mask_fn(
                model, out_hw=hw, legacy_preproc=legacy_preproc,
                quant_stats=quant_stats, mesh=mesh)
        else:
            self._mask_fn = make_mask_fn(model, out_hw=hw,
                                         legacy_preproc=legacy_preproc,
                                         tta_flip=tta_flip,
                                         tta_scales=tta_scales, mesh=mesh)
        self.model_name = type(model).__name__
        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)
        self._httpd = None
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0}

    def _count(self, key: str):
        with self._stats_lock:
            self.stats[key] += 1

    # -- device side ------------------------------------------------------

    def warmup(self):
        """Run the padded-batch program once before serving traffic."""
        w, h = self.img_size
        self._run_batch(np.zeros((self.max_batch, h, w, 3), np.uint8))

    def _run_batch(self, images_u8):
        if self._mask_fn is not None:
            return self._mask_fn(images_u8).cpu().numpy()
        probs = self._probs_fn(images_u8).cpu().numpy()
        return probs.argmax(axis=-1).astype(np.int32)

    def _dispatch_loop(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            t_end = time.perf_counter() + self.batch_window_s
            while len(batch) < self.max_batch:
                remaining = t_end - time.perf_counter()
                if remaining <= 0:
                    # drain whatever is already queued, but stop waiting
                    try:
                        batch.append(self._queue.get_nowait())
                        continue
                    except queue.Empty:
                        break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            # pad to the static max_batch shape
            w, h = self.img_size
            images = np.zeros((self.max_batch, h, w, 3), np.uint8)
            for i, p in enumerate(batch):
                images[i] = p.image
            try:
                masks = self._run_batch(images)
                for i, p in enumerate(batch):
                    p.mask = masks[i]
            except Exception as e:  # surface device errors to the clients
                for p in batch:
                    p.error = e
            self._count("batches")
            for p in batch:
                p.done.set()

    # -- request side -----------------------------------------------------

    def predict_bytes(self, body: bytes, timeout: float = 60.0):
        """Decode a PNG or JPEG body, run the batched device path, return
        the int32 class-id mask at the image's ORIGINAL (upright)
        resolution. A body the codecs do not read raises ValueError."""
        img = np.ascontiguousarray(imdecode(body, IMREAD_COLOR)[:, :, ::-1])
        oh, ow = img.shape[:2]
        pending = _Pending(_resize_u8(img, self.img_size))
        self._queue.put(pending)
        self._count("requests")
        if not pending.done.wait(timeout):
            raise TimeoutError("serving dispatch timed out")
        if pending.error is not None:
            # a device failure is the server's (500), whatever its type
            raise RuntimeError(f"device batch failed: {pending.error!r}"
                               ) from pending.error
        mask = pending.mask
        if (oh, ow) != mask.shape:
            mask = resize_nearest(torch.from_numpy(mask), (oh, ow)).numpy()
        return mask

    # -- HTTP layer -------------------------------------------------------

    def _handler_class(server):  # noqa: N805 — closure over the server
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet by default
                pass

            def do_GET(self):
                if self.path.split("?")[0] != "/healthz":
                    self.send_error(404)
                    return
                body = json.dumps({
                    "status": "ok", "model": server.model_name,
                    "img_size": list(server.img_size),
                    "max_batch": server.max_batch,
                    **server.stats}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                path, _, q = self.path.partition("?")
                if path != "/predict":
                    self.send_error(404)
                    return
                raw = "format=raw" in q
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                try:
                    mask = server.predict_bytes(body)
                except ValueError as e:
                    self.send_error(400, str(e))
                    return
                except Exception as e:
                    self.send_error(500, f"{type(e).__name__}: {e}")
                    return
                if raw:
                    out = mask.astype(np.uint8)  # class ids (<=255)
                else:
                    # palette is BGR; PNG stores RGB
                    out = colorize_mask(mask, server.colormap)[:, :, ::-1]
                data = encode_png(out)
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
        return Handler

    def start(self, host: str = "127.0.0.1", port: int = 8500,
              warmup: bool = True):
        """Warm up, start the dispatcher and the HTTP listener. Returns the
        bound (host, port); port=0 picks a free port."""
        if warmup:
            self.warmup()
        self._dispatcher.start()
        self._httpd = ThreadingHTTPServer((host, port),
                                          self._handler_class())
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        return self._httpd.server_address

    def stop(self):
        self._stop.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._dispatcher.is_alive():
            self._dispatcher.join(timeout=5)

    def serve_forever(self):
        """Block the main thread (CLI use)."""
        try:
            self._stop.wait()
        except KeyboardInterrupt:
            self.stop()
