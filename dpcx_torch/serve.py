"""Serving path: fixed-batch inference behind a stdlib HTTP server (port of
``dpcx/serve.py``).

- Requests are padded to the fixed serving batch by repeating the last
  image, larger ones are chunked; pad rows are dropped on the way out.
- uint8 images are rescaled to [0, 1].
- Optional bf16 parameter cast.
- One lock serialises device work; ``warmup()`` runs one batch first.

Protocol (npz over HTTP):

    POST /predict   body = npz{"images": [B, H, W, 3] float32/uint8}
                    -> npz{"points": [B, N, 3], "scale": [B, 1]} (and
                       "pose": [B, 4], the student quaternion, with
                       predict_pose; "rgb", "gauss_scales", "gauss_rot",
                       "gauss_opacity" when the config predicts them)
    GET  /healthz   -> {"status": "ok", "requests": ..., "batch": ...}

Run it:

    python -m dpcx_torch.cli serve -f experiments/car_64_depth.yaml
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from dpcx_torch.config import Config
from dpcx_torch.models.model_pc import ModelPointCloud


class ServingModel:
    """Fixed-batch predictor with padding and chunking.

    ``params`` is the model's ``state_dict``; the model lives on the device
    its tensors are on.
    """

    def __init__(
        self,
        cfg: Config,
        params: dict[str, torch.Tensor],
        batch_size: int = 16,
        cast_bf16: bool = False,
    ):
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = next(iter(params.values())).device
        model = ModelPointCloud(cfg, device=self.device)
        model.load_state_dict(params)
        if cast_bf16:
            model = model.to(torch.bfloat16)
        self.model = model.eval()
        self.requests = 0

    def _outputs(self, preds: dict[str, torch.Tensor]) -> dict:
        """The served surface of the model's outputs, as dpcx's
        ``_serve_step``: the pose head's internals (candidates, their
        corrections) stay inside; the student quaternion is "pose"."""
        out = {"points": preds["points"]}
        if "scale" in preds:
            out["scale"] = preds["scale"]
        if self.cfg.predict_pose and "student_quat" in preds:
            out["pose"] = preds["student_quat"]
        for k in ("rgb", "gauss_scales", "gauss_rot", "gauss_opacity"):
            if k in preds:
                out[k] = preds[k]
        return out

    def warmup(self) -> float:
        """Run one serving batch; returns its seconds."""
        t0 = time.perf_counter()
        self(np.zeros(
            (self.batch_size, self.cfg.image_size, self.cfg.image_size, 3),
            np.float32,
        ))
        return time.perf_counter() - t0

    @torch.inference_mode()
    def __call__(self, images: np.ndarray) -> dict[str, np.ndarray]:
        """images [B, H, W, 3] (any B >= 1) -> prediction arrays [B, ...]."""
        images = np.asarray(images)
        if images.dtype == np.uint8:
            images = images.astype(np.float32) / 255.0
        images = images.astype(np.float32)
        B = images.shape[0]
        outs: list[dict] = []
        for s in range(0, B, self.batch_size):
            chunk = images[s : s + self.batch_size]
            n = chunk.shape[0]
            if n < self.batch_size:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], self.batch_size - n, 0)]
                )
            preds = self._outputs(
                self.model(torch.from_numpy(chunk).to(self.device)))
            # .cpu() waits for the device, so the batch is done here
            outs.append(
                {k: v[:n].float().cpu().numpy() for k, v in preds.items()}
            )
        self.requests += 1
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def _npz_bytes(arrays: dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def make_handler(model: ServingModel):
    lock = threading.Lock()  # one device; serialise device work

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(
                    200,
                    {
                        "status": "ok",
                        "requests": model.requests,
                        "batch": model.batch_size,
                    },
                )
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                with np.load(io.BytesIO(self.rfile.read(n))) as f:
                    images = f["images"]
                with lock:
                    preds = model(images)
                body = _npz_bytes(preds)
                self.send_response(200)
                self.send_header("Content-Type", "application/npz")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except Exception as e:  # noqa: BLE001 — serving must not die
                self._json(400, {"error": str(e)})

    return Handler


def serve(
    cfg: Config,
    params: dict[str, torch.Tensor],
    port: int = 8787,
    batch_size: int = 16,
    cast_bf16: bool = False,
) -> ThreadingHTTPServer:
    """Build + warm the model, return a ready (not yet serving) server.

    The caller runs ``srv.serve_forever()`` (blocking) or drives it from a
    thread."""
    model = ServingModel(cfg, params, batch_size, cast_bf16)
    secs = model.warmup()
    srv = ThreadingHTTPServer(("127.0.0.1", port), make_handler(model))
    srv.model = model  # for tests/introspection
    print(
        json.dumps(
            {"serving": srv.server_address[1], "batch": batch_size,
             "warmup_s": round(secs, 2)}
        ),
        flush=True,
    )
    return srv
