"""The port's image IO (a PNG codec on zlib and a Lanczos-3 resize, no PIL)
against PIL, its HTTP server (``mvd_tpu_torch/cli/serve.py``) through a
real round trip on the CPU, and both entry points in a process where PIL
cannot be imported.

Bars: PNG decode bitwise PIL's ``convert("RGB")`` for 8-bit gray,
gray+alpha, RGB, RGBA and palette images and for all five scanline
filters; PNG encode bitwise what PIL reads back; ``resize`` within one
level (of 255) of PIL's ``Image.LANCZOS`` at every pixel (measured: equal).
"""

import ast
import base64
import io
import json
import os
import pathlib
import struct
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import zlib
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
from PIL import Image

from mvd_tpu_torch.config import TINY_MODEL
from mvd_tpu_torch.pipeline import MVDPipeline
from mvd_tpu_torch.utils.images import decode_png, encode_png, load_image, resize

REPO = pathlib.Path(__file__).resolve().parents[1]
SIZE = TINY_MODEL.unet.sample_size * 8
RESIZE_TOL = 1  # levels of 255


def _photo(h, w, c, seed=0):
    """Smooth gradients plus noise, so that PIL's filter choice varies."""
    y, x = np.mgrid[:h, :w]
    noise = np.random.default_rng(seed).integers(0, 24, (h, w, c))
    base = np.stack([3 * x + 5 * y + 40 * k for k in range(c)], -1)
    return ((base + noise) % 256).astype(np.uint8)


def _pil_png(im: Image.Image, **options) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "PNG", **options)
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "P+tRNS"])
def test_png_decode_is_bitwise_pil(mode):
    a = _photo(37, 53, {"L": 1, "LA": 2, "RGBA": 4}.get(mode, 3))
    if mode.startswith("P"):
        im = Image.fromarray(a, "RGB").convert("P", palette=Image.ADAPTIVE, colors=50)
        if mode == "P+tRNS":
            im.info["transparency"] = 3
    else:
        im = Image.fromarray(a[..., 0] if mode == "L" else a, mode)
    for options in ({}, {"optimize": True}, {"compress_level": 0}):
        data = _pil_png(im, **options)
        np.testing.assert_array_equal(decode_png(data), np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


def _filtered(rows: np.ndarray, bpp: int) -> bytes:
    """PNG image data with row y under filter y % 5 (None, Sub, Up, Average,
    Paeth), filtered byte by byte as the PNG specification states it."""
    out, prev = bytearray(), [0] * rows.shape[1]
    for y, row in enumerate(rows.tolist()):
        kind = y % 5
        out.append(kind)
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b, c = prev[i], prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            paeth = a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(p - c) else b if abs(p - b) <= abs(p - c) else c
            out.append((x - (0, a, b, (a + b) // 2, paeth)[kind]) % 256)
        prev = row
    return bytes(out)


def _png(ihdr: bytes, data: bytes) -> bytes:
    chunk = lambda k, d: struct.pack(">I", len(d)) + k + d + struct.pack(">I", zlib.crc32(k + d))
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b"")


@pytest.mark.parametrize("colour,channels", [(2, 3), (6, 4), (0, 1)])
def test_png_decode_undoes_every_filter(colour, channels):
    a = _photo(11, 9, channels, seed=colour)
    data = _png(struct.pack(">IIBBBBB", 9, 11, 8, colour, 0, 0, 0), _filtered(a.reshape(11, -1), channels))
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(decode_png(data), want)
    np.testing.assert_array_equal(want[..., :1] if channels == 1 else want, a[..., :3] if channels > 1 else a)


def test_png_encode_is_what_pil_reads():
    a = _photo(31, 45, 3)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(encode_png(a)))), a)


def test_png_decode_rejects_what_it_does_not_read():
    """A 16-bit gray PNG and an interlaced one are read now (PIL's pixels:
    I;16 clipped to 255); a depth the colour type does not allow,
    interlaced data one byte short of its seven passes, a damaged IDAT
    (by zlib's Adler-32, as PIL refuses it) and a header chunk that fails
    its CRC are refused."""
    i16 = _pil_png(Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 999))
    np.testing.assert_array_equal(decode_png(i16), np.asarray(Image.open(io.BytesIO(i16)).convert("RGB")))
    with pytest.raises(ValueError, match="bit depth 16 is invalid for colour type 3"):
        decode_png(_png(struct.pack(">IIBBBBB", 2, 2, 16, 3, 0, 0, 0), bytes(10)))
    with pytest.raises(ValueError, match="truncated"):
        decode_png(_png(struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 0, 1), bytes(14)))
    np.testing.assert_array_equal(decode_png(_png(struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 0, 1), bytes(15))),
                                  np.zeros((2, 2, 3), np.uint8))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"\xff\xd8\xff\xe0 a JPEG")
    data = bytearray(encode_png(_photo(4, 4, 3)))
    data[-20] ^= 1  # inside the IDAT chunk: PIL checks no IDAT CRC but zlib's Adler-32 (Queue 3, fault 16)
    with pytest.raises(OSError, match="broken data stream"):
        Image.open(io.BytesIO(bytes(data))).load()
    with pytest.raises(ValueError, match="broken"):
        decode_png(bytes(data))
    data[20] ^= 1  # inside IHDR, whose CRC PIL checks
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(data))


@pytest.mark.parametrize("shape,out", [((64, 64), (32, 32)), ((100, 80), (64, 64)), ((30, 30), (64, 64)),
                                       ((77, 300), (128, 128)), ((512, 512), (384, 384)), ((5, 7), (3, 11))])
def test_resize_is_pil_lanczos(shape, out):
    a = _photo(*shape, 3, seed=shape[0])
    want = np.asarray(Image.fromarray(a).resize(out[::-1], Image.LANCZOS)).astype(int)
    got = resize(a, *out).astype(int)
    assert got.shape == want.shape and np.abs(got - want).max() <= RESIZE_TOL


def test_load_image_is_the_pil_version(tmp_path):
    a = _photo(50, 70, 4)
    Image.fromarray(a, "RGBA").save(tmp_path / "x.png")
    want = np.asarray(Image.open(tmp_path / "x.png").convert("RGB").resize((64, 64), Image.LANCZOS),
                      np.float32) / 255.0 * 2.0 - 1.0
    got = load_image(str(tmp_path / "x.png"), 64)
    assert got.dtype == np.float32 and np.abs(got - want).max() <= RESIZE_TOL * 2 / 255 + 1e-6


def test_port_imports_no_pil():
    files = sorted((REPO / "mvd_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not any(n.split(".")[0] == "PIL" for n in names), f"{path}: imports PIL"


def test_infer_cli_takes_every_flag(tmp_path, capsys):
    """--checkpoint (a Lightning .ckpt of another pipeline, zero-padded for
    the ray model), --use-ray-conditioning, --invert-init, --sampler and
    --encoder-reuse together, on the CPU."""
    import torch

    from mvd_tpu_torch.checkpoint import export_jax_params, export_lightning_state_dict
    from mvd_tpu_torch.cli import infer

    sd = export_lightning_state_dict(export_jax_params(MVDPipeline.create(TINY_MODEL, seed=3, device="cpu")
                                                       .model["mvd"]))
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}},
               tmp_path / "last.ckpt")
    Image.fromarray(_photo(40, 40, 3)).save(tmp_path / "src.png")
    out = tmp_path / "out"
    infer.main(["--tiny", "--device", "cpu", "--num-images", "1", "--num-steps", "3", "--output-dir", str(out),
                "--checkpoint", str(tmp_path / "last.ckpt"), "--use-ray-conditioning", "--invert-init",
                "--sampler", "ddim", "--encoder-reuse", "2", "--image-path", str(tmp_path / "src.png")])
    assert "translation_projection" in capsys.readouterr().out
    for name in ("source.png", "generated_00.png", "comparison_00.png"):
        assert np.asarray(Image.open(out / name)).shape[:2] in ((SIZE, SIZE), (SIZE, 2 * SIZE + 4))


def test_cli_checkpoint_takes_a_save_params_dir(tmp_path):
    """``--checkpoint`` of ``cli.infer`` and ``cli.serve`` takes a directory
    written by ``checkpoint.save_params`` (the JAX CLIs' second form), every
    component loaded bitwise; a directory without one (an orbax directory
    of the JAX package) raises, naming the forms the port takes."""
    import torch

    from mvd_tpu_torch.checkpoint import save_params
    from mvd_tpu_torch.cli import infer, serve

    src = MVDPipeline.create(TINY_MODEL, seed=7, device="cpu")
    path = str(tmp_path / "params")
    save_params(path, {net: m.state_dict() for net, m in src.model.items()})
    common = ["--tiny", "--device", "cpu", "--checkpoint", path]
    pipe = infer.main(common + ["--num-images", "1", "--num-steps", "1", "--output-dir", str(tmp_path / "out")])
    served, _ = serve.build_pipeline(serve.build_argparser().parse_args(common))
    want = src.model.state_dict()
    for got in (pipe.model.state_dict(), served.model.state_dict()):
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="Lightning .ckpt or a directory written by"):
        infer.main(["--tiny", "--device", "cpu", "--checkpoint", str(tmp_path / "orbax")])


# ---------------------------------------------------------------------------
# the HTTP server
# ---------------------------------------------------------------------------


def _start(pipe, lock, **kw):
    from mvd_tpu_torch.cli.serve import make_handler

    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(pipe, SIZE, lock, **kw))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server():
    pipe = MVDPipeline.create(TINY_MODEL, seed=0, device="cpu")
    lock = threading.Lock()
    srv, thread, url = _start(pipe, lock, request_timeout=0.5)
    yield url, lock
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=30)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def test_healthz_and_not_found(server):
    url, _ = server
    status, data = _get(url + "/healthz")
    assert status == 200 and data["ok"] is True and data["backend"] == "cpu" and data["queue_depth"] == 0
    for call in (lambda: _get(url + "/nope"), lambda: _post(url + "/nope", {})):
        with pytest.raises(urllib.error.HTTPError) as err:
            call()
        assert err.value.code == 404


def test_generate_with_a_png_source_image(server):
    url, _ = server
    src = base64.b64encode(encode_png(_photo(40, 48, 3))).decode()  # resized to SIZE by the server
    before = _get(url + "/healthz")[1]["compiled_signatures"]
    status, data = _post(url + "/generate", {"prompt": "a chair", "num_views": 2, "num_steps": 2, "seed": 1,
                                            "sampler": "dpmpp_2m", "source_image_b64": src})
    assert status == 200 and len(data["images_b64"]) == 2 and data["latency_s"] > 0
    for b64 in data["images_b64"]:
        img = np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))
        assert img.shape == (SIZE, SIZE, 3) and img.dtype == np.uint8
    assert _get(url + "/healthz")[1]["compiled_signatures"] == before + 1
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(url + "/generate", {"num_steps": 1, "sampler": "euler"})
    assert err.value.code == 500 and "unknown sampler" in json.loads(err.value.read())["error"]


def test_request_timeout_sheds_load(server):
    url, lock = server
    with lock:  # a long generation holds the device
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(url + "/generate", {"prompt": "x", "num_steps": 1})
    body = json.loads(err.value.read())
    assert err.value.code == 503 and "timed out" in body["error"] and body["queue_depth"] >= 1
    assert _post(url + "/generate", {"prompt": "x", "num_steps": 1})[0] == 200


CHILD = r"""
import os, sys
sys.modules["PIL"] = None  # any import of PIL now raises ImportError
import base64, json, threading, urllib.request
from http.server import ThreadingHTTPServer
import numpy as np
import mvd_tpu_torch.utils as utils
from mvd_tpu_torch.cli import infer, serve
from mvd_tpu_torch.config import TINY_MODEL
from mvd_tpu_torch.pipeline import MVDPipeline
from mvd_tpu_torch.utils.images import encode_png, to_uint8

out = sys.argv[1]
expected, saved = {}, utils.save_image
def save_image(img, path):
    expected[os.path.basename(path)] = to_uint8(img)
    saved(img, path)
utils.save_image = save_image
infer.main(["--tiny", "--device", "cpu", "--num-images", "1", "--num-steps", "2", "--output-dir", out])

sent, png_b64 = [], serve._png_b64
serve._png_b64 = lambda im: (sent.append((np.clip(im, 0, 1) * 255).astype(np.uint8)), png_b64(im))[1]
pipe = MVDPipeline.create(TINY_MODEL, seed=0, device="cpu")
srv = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(pipe, 64, threading.Lock()))
threading.Thread(target=srv.serve_forever, daemon=True).start()
src = np.random.default_rng(0).integers(0, 256, (48, 40, 3), dtype=np.uint8)
req = urllib.request.Request(
    f"http://127.0.0.1:{srv.server_address[1]}/generate",
    data=json.dumps({"num_views": 1, "num_steps": 1,
                     "source_image_b64": base64.b64encode(encode_png(src)).decode()}).encode())
with urllib.request.urlopen(req, timeout=300) as r:
    reply = json.loads(r.read())
srv.shutdown()
with open(os.path.join(out, "served.png"), "wb") as f:
    f.write(base64.b64decode(reply["images_b64"][0]))
expected["served.png"] = sent[0]
np.savez(os.path.join(out, "expected.npz"), **expected)
assert sys.modules["PIL"] is None
print("ok")
"""


def test_entry_points_run_without_pil(tmp_path):
    """The infer CLI and one request through the server, in a process where
    PIL cannot be imported: the PNGs they write are what PIL (here) decodes
    to the arrays they were given."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path)], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]
    expected = np.load(tmp_path / "expected.npz")
    assert sorted(expected.files) == ["comparison_00.png", "generated_00.png", "served.png", "source.png"]
    for name in expected.files:
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / name)), expected[name], err_msg=name)
