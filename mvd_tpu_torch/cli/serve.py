"""HTTP inference server of the port (standard library only).

Counterpart of ``mvd_tpu/cli/serve.py``, with the same requests, responses
and status codes:

    python -m mvd_tpu_torch.cli.serve --checkpoint last.ckpt --port 8000

POST /generate   {"prompt": str, "num_views": int, "num_steps": int,
                  "guidance_scale": float, "ref_scale": float,
                  "seed": int, "source_image_b64": png-or-jpeg-b64?,
                  "source_camera": [[...4x4]]?, "target_cameras": [[...]]?,
                  "sampler": "ddpm"|"ddim"|"dpmpp_2m"?, "encoder_reuse": int?}
    -> {"images_b64": [png...], "latency_s": float}
GET /healthz     -> {"ok": true, "backend": "cuda" | "cpu",
                     "compiled_signatures": N, "queue_depth": M}

Generations run one at a time behind a lock. ``queue_depth`` counts the
requests running or waiting for the device; one that waits longer than
``--request-timeout`` is answered 503. The port compiles nothing, so
``compiled_signatures`` counts the distinct call signatures served so far
(what the JAX server would have compiled). Images go in and out through
``utils/images.py``, without PIL: a BMP, GIF, PNG, JPEG, TIFF or WebP
source image in, PNGs out.
"""

from __future__ import annotations

import argparse
import base64
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..utils.images import decode_image, encode_png, resize


def _png_b64(img01: np.ndarray) -> str:
    return base64.b64encode(encode_png((np.clip(img01, 0, 1) * 255).astype(np.uint8))).decode()


def _b64_png(data: str, size: int) -> np.ndarray:
    """A base64 image ``decode_image`` reads -> (size, size, 3) float32 in [0, 1], alpha
    dropped (``convert("RGB")``), Lanczos-resized where it differs."""
    img = decode_image(base64.b64decode(data))
    if img.shape[:2] != (size, size):
        img = resize(img, size, size)
    return img.astype(np.float32) / 255.0


def make_handler(pipe, size: int, lock: threading.Lock, request_timeout: float = 300.0):
    from ..camera import orbit_cameras

    # requests running or waiting for the device lock (served by
    # ThreadingHTTPServer's per-connection threads)
    depth = {"n": 0}
    depth_lock = threading.Lock()
    signatures = set()  # added to under ``lock``

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, "backend": pipe.device.type,
                                 "compiled_signatures": len(signatures), "queue_depth": depth["n"]})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                num_views = int(req.get("num_views", 1))
                cams = req.get("target_cameras")
                tgt = (np.asarray(cams, np.float32) if cams
                       else orbit_cameras(max(num_views, 1))[:num_views])
                src_cam = np.asarray(req.get("source_camera") or tgt[0], np.float32)
                src_img = None
                if req.get("source_image_b64"):
                    src_img = _b64_png(req["source_image_b64"], size)[None]
                kwargs = dict(
                    num_inference_steps=int(req.get("num_steps", 20)),
                    guidance_scale=float(req.get("guidance_scale", 1.0)),
                    sampler=req.get("sampler"), encoder_reuse=int(req.get("encoder_reuse", 1)),
                )
                signature = (num_views, size, kwargs["num_inference_steps"],
                             kwargs["guidance_scale"] > 1.0, src_img is not None,
                             kwargs["sampler"] or pipe.config.scheduler.sampler,
                             kwargs["encoder_reuse"])
                t0 = time.perf_counter()
                with depth_lock:
                    depth["n"] += 1
                try:
                    # a bounded wait for the device: shed load with 503
                    # instead of queueing behind long generations
                    if not lock.acquire(timeout=request_timeout):
                        self._json(503, {
                            "error": f"timed out waiting for the accelerator ({request_timeout:g}s)",
                            "queue_depth": depth["n"],
                        })
                        return
                    try:
                        out = pipe(
                            [req.get("prompt", "")] * num_views,
                            negative_prompt=req.get("negative_prompt"),
                            height=size, width=size,
                            source_camera=np.tile(src_cam[None], (num_views, 1, 1)),
                            target_camera=tgt, source_images=src_img,
                            ref_scale=float(req.get("ref_scale", 1.0)),
                            seed=int(req.get("seed", 0)), **kwargs,
                        )
                        signatures.add(signature)
                    finally:
                        lock.release()
                finally:
                    with depth_lock:
                        depth["n"] -= 1
                images = np.asarray(out["images"])
                self._json(200, {
                    "images_b64": [_png_b64(im) for im in images],
                    "latency_s": round(time.perf_counter() - t0, 4),
                })
            except Exception as e:  # noqa: BLE001 -- the server answers every request
                self._json(500, {"error": str(e)})

    return Handler


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Multi-view inference server (PyTorch/CUDA)")
    p.add_argument("--checkpoint", default=None,
                   help="a reference Lightning .ckpt or a save_params directory (the port's, or "
                   "the JAX package's orbax one)")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--image-size", type=int, default=512)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--warmup", action="store_true", help="run a 1-view generation at boot")
    p.add_argument("--request-timeout", type=float, default=300.0,
                   help="max seconds a request may wait for the device before it is "
                        "answered 503")
    return p


def build_pipeline(args):
    """The server's pipeline and image size from its flags: random weights
    from seed 0, then ``--checkpoint`` where given."""
    import dataclasses

    from ..checkpoint import load_checkpoint
    from ..config import TINY_MODEL, ModelConfig
    from ..pipeline import MVDPipeline
    from ..pipeline.pipeline import resolve_device

    if args.tiny and resolve_device(args.device).type != "cpu":
        raise ValueError(
            "--tiny runs on the CPU only (f32, 16-wide heads; the GPU kernels take "
            "bf16 and 64-wide heads): add --device cpu"
        )
    cfg = TINY_MODEL if args.tiny else ModelConfig()
    size = cfg.unet.sample_size * 8 if args.tiny else args.image_size
    if not args.tiny:
        cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, sample_size=size // 8))
    pipe = MVDPipeline.create(cfg, seed=0, device=args.device)
    if args.checkpoint:
        load_checkpoint(pipe, args.checkpoint)
    return pipe, size


def main(argv=None):
    args = build_argparser().parse_args(argv)
    pipe, size = build_pipeline(args)
    if args.warmup:
        pipe("warmup", num_inference_steps=2, guidance_scale=1.0, height=size, width=size, seed=0)

    lock = threading.Lock()
    server = ThreadingHTTPServer(
        (args.host, args.port), make_handler(pipe, size, lock, request_timeout=args.request_timeout))
    print(f"serving on http://{args.host}:{args.port} (size={size}, device={pipe.device})")
    server.serve_forever()


if __name__ == "__main__":
    main()
