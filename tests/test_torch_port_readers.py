"""The port's image readers against PIL and the JAX package: the JPEG
decoder (``csrc/jpeg_decode.cpp``, ``utils/images.py:decode_jpeg``) on
every path that reads an image, and the native Objaverse reader
(``csrc/native_reader.cpp``, ``data/native_loader.py``) with its host build
(``kernels/_build.py:build_host``).

Bars: a JPEG decode bitwise PIL's ``convert("RGB")`` on every fixture
(``tests/fixtures/torch_port_jpeg``, written by ``make_fixtures.py`` there);
``load_image``, the server's upload decode, the infer CLI's source image and
CO3D's ``_read_view`` bitwise the JAX functions at the size of the image
and within one level of 255 where they resize (the port's Lanczos; the
count of values that differ is asserted and stated in each test); the
native reader bitwise its numpy plain version and bitwise the JAX reader's
C++ built with the same flags (so libpng's function), and within 5e-7 of
the JAX reader as the JAX package builds it (``-march=native``, FMA
contraction where the host has it; measured at most 3.6e-7 here).
"""

import base64
import ctypes
import hashlib
import io
import json
import os
import pathlib
import re
import struct
import subprocess
import sys
import threading
import zipfile
import zlib

import numpy as np
import pytest
from PIL import Image

from mvd_tpu.cli import serve as jserve
from mvd_tpu.data import co3d as jco3d
from mvd_tpu.data import native_loader as jnative
from mvd_tpu.data import objaverse as jobj
from mvd_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from mvd_tpu.utils import images as jimages
from mvd_tpu_torch.cli import serve as tserve
from mvd_tpu_torch.config import TINY_MODEL
from mvd_tpu_torch.data import co3d as tco3d
from mvd_tpu_torch.data import native_loader
from mvd_tpu_torch.data import objaverse as tobj
from mvd_tpu_torch.data.tokenizer import HashTokenizer
from mvd_tpu_torch.kernels import _build
from mvd_tpu_torch.utils.images import decode_image, decode_jpeg, decode_png, load_image, resize
from tests.test_co3d import make_co3d_tree

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "torch_port_jpeg"
DIGESTS = json.loads((FIXTURES / "pil_sha256.json").read_text())
SUPPORTED = sorted(n for n, d in DIGESTS.items() if "sha256" in d)
SIZE = TINY_MODEL.unet.sample_size * 8
LEVEL = 2 / 255 + 1e-6  # one level of 255 in [-1, 1]
NATIVE_TOL = 5e-7


def _fixture(name: str) -> bytes:
    return (FIXTURES / name).read_bytes()


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _jpeg(arr: np.ndarray, **options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", **options)
    return buf.getvalue()


def _photo(h: int, w: int, seed: int) -> np.ndarray:
    y, x = np.mgrid[:h, :w]
    noise = np.random.default_rng(seed).integers(0, 40, (h, w, 3))
    return ((np.stack([3 * x + 5 * y, 2 * x + 7 * y, x * y % 97], -1) + noise) % 256).astype(np.uint8)


def _within_one_level(got: np.ndarray, want: np.ndarray, level: float = LEVEL) -> int:
    """Assert |got - want| <= one level (of [-1, 1] floats, or ``level``);
    return how many values differ."""
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert diff.max() <= level, diff.max()
    return int((diff > 0).sum())


# ------------------------------------------------------------------ JPEG


@pytest.mark.parametrize("name", SUPPORTED)
def test_decode_jpeg_is_bitwise_pil(name):
    data = _fixture(name)
    got = decode_jpeg(data)
    np.testing.assert_array_equal(got, _pil_rgb(data))
    assert list(got.shape) == DIGESTS[name]["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == DIGESTS[name]["sha256"]


def _patched(name: str, find: bytes, offset: int, value: int) -> bytes:
    data = bytearray(_fixture(name))
    data[data.index(find) + offset] = value
    return bytes(data)


@pytest.mark.parametrize("data,match", [
    (lambda: _patched("s420.jpg", b"\xff\xc0", 1, 0xCB), "lossless arithmetic-coded JPEG \\(SOF11\\)"),
    (lambda: _patched("s420.jpg", b"\xff\xc0", 1, 0xC3), "invalid lossless parameters Ss=0 Se=63"),
    (lambda: _patched("s420.jpg", b"\xff\xc0", 1, 0xC5), "hierarchical JPEG \\(SOF5\\)"),
    (lambda: _patched("s420.jpg", b"\xff\xc0", 4, 12), "12-bit JPEG"),
    (lambda: _patched("s420.jpg", b"\xff\xc0", 6, 0), "DNL marker \\(height 0\\)"),
    (lambda: _fixture("s420.jpg")[:1500], "truncated"),
    (lambda: b"\xff\xd8\xff\xd9", "no frame header"),
], ids=["arithmetic", "lossless", "hierarchical", "12-bit", "dnl-height", "truncated",
        "empty"])
def test_unsupported_jpegs_raise(data, match):
    with pytest.raises(ValueError, match=match):
        decode_jpeg(data())


def _sof_size(name: str, height: int, width: int) -> bytes:
    """The fixture with its frame header claiming height x width."""
    data = bytearray(_fixture(name))
    at = data.index(b"\xff\xc0") + 5
    data[at:at + 4] = struct.pack(">HH", height, width)
    return bytes(data)


def _dc_symbol_16(name: str) -> bytes:
    """The fixture with a symbol of its first DC Huffman table set to 16."""
    data = bytearray(_fixture(name))
    at = data.index(b"\xff\xc4")
    assert data[at + 4] == 0x00  # class DC, table 0
    data[at + 4 + 17] = 16
    return bytes(data)


@pytest.mark.parametrize("data,match,pil_error", [
    (lambda: _sof_size("s420.jpg", 65535, 65535), "over the limit of 178956970 pixels",
     Image.DecompressionBombError),
    (lambda: _dc_symbol_16("s420.jpg"), "DC Huffman table holds a symbol above 15", OSError),
], ids=["pixel-limit", "dc-symbol-above-15"])
def test_hostile_jpegs_are_refused_where_pil_refuses(data, match, pil_error):
    """A header over PIL's decompression-bomb limit (2 x MAX_IMAGE_PIXELS)
    is refused before any allocation, as ``Image.open`` refuses it; a DC
    table whose symbols exceed 15 is refused as libjpeg refuses it."""
    data = data()
    with pytest.raises(ValueError, match=match):
        decode_jpeg(data)
    with pytest.raises(pil_error):
        Image.open(io.BytesIO(data)).convert("RGB")


def test_png_over_the_pixel_limit_or_inflating_past_its_rows_is_bounded():
    """``decode_png`` refuses a header over PIL's limit, as ``Image.open``
    does, and inflates no more than the header's rows: 64 MB of zeros
    behind a 4x4 RGB header decode as the 4x4 image."""
    rgb = _photo(4, 4, 5)
    png = _pil_png(Image.fromarray(rgb))
    at = png.index(b"IHDR")
    ihdr = struct.pack(">II", 65535, 65535) + png[at + 12:at + 17]
    huge = (png[:at + 4] + ihdr + struct.pack(">I", zlib.crc32(b"IHDR" + ihdr)) + png[at + 21:])
    with pytest.raises(ValueError, match="over the limit of 178956970 pixels"):
        decode_png(huge)
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(huge))
    rows = b"".join(b"\x00" + rgb[y].tobytes() for y in range(4)) + bytes(64 << 20)
    idat = zlib.compress(rows, 9)
    bomb = (png[:at + 21] + struct.pack(">I", len(idat)) + b"IDAT" + idat
            + struct.pack(">I", zlib.crc32(b"IDAT" + idat)) + b"\x00\x00\x00\x00IEND\xaeB`\x82")
    assert len(bomb) < 100_000
    np.testing.assert_array_equal(decode_png(bomb), rgb)
    np.testing.assert_array_equal(decode_png(bomb), _pil_rgb(bomb))


def test_truncated_jpeg_is_refused_in_the_row_its_data_ends():
    """A 1067x800 4:2:0 frame (50 MCU rows) whose header claims 8000 rows:
    refused at the end of the first row past its data, not after decoding
    the 450 rows of zeros that would follow."""
    with pytest.raises(ValueError, match=r"truncated \(in MCU row (\d+) of 500\)") as info:
        decode_jpeg(_sof_size("frame_a.jpg", 8000, 1067))
    row = int(re.search(r"row (\d+)", str(info.value)).group(1))
    assert 49 <= row <= 50, row


def test_decode_image_dispatches_on_the_signature():
    jpg = _fixture("s422.jpg")
    np.testing.assert_array_equal(decode_image(jpg), decode_jpeg(jpg))
    buf = io.BytesIO()
    Image.fromarray(_photo(9, 7, 0)).convert("RGBA").save(buf, "PNG")
    png = buf.getvalue()
    np.testing.assert_array_equal(decode_image(png), decode_png(png))
    np.testing.assert_array_equal(decode_image(png, composite_alpha=True),
                                  decode_png(png, composite_alpha=True))
    with pytest.raises(ValueError, match="GIF: the logical screen descriptor is cut"):
        decode_image(b"GIF89a\x01\x00\x01\x00")


def test_load_image_of_a_jpeg_is_the_jax_one(tmp_path):
    """Bitwise at the image's size; resized 37x53 -> 64² within one level
    (measured: 0 values differ)."""
    path = str(FIXTURES / "s420.jpg")
    np.testing.assert_array_equal(load_image(path), jimages.load_image(path))
    assert _within_one_level(load_image(path, SIZE), jimages.load_image(path, SIZE)) == 0


def test_server_decodes_a_jpeg_upload_as_the_jax_server():
    """``_b64_png`` on a JPEG: bitwise at the model's size; 37x53 -> 64²
    within one level (measured: 0 values differ)."""
    square = base64.b64encode(_jpeg(_photo(SIZE, SIZE, 1), quality=90)).decode()
    np.testing.assert_array_equal(tserve._b64_png(square, SIZE), jserve._b64_png(square, SIZE))
    odd = base64.b64encode(_fixture("s420.jpg")).decode()
    assert _within_one_level(tserve._b64_png(odd, SIZE) * 2 - 1, jserve._b64_png(odd, SIZE) * 2 - 1) == 0


def test_infer_cli_takes_a_jpeg_source(tmp_path):
    """``cli.infer --image-path x.jpg`` (``--tiny --device cpu``): the
    source it writes is bitwise the JAX ``load_image`` of the JPEG at the
    model's size."""
    from mvd_tpu_torch.cli import infer
    from mvd_tpu_torch.utils.images import to_uint8

    src = tmp_path / "src.jpg"
    src.write_bytes(_jpeg(_photo(SIZE, SIZE, 2), quality=85))
    out = tmp_path / "out"
    infer.main(["--tiny", "--device", "cpu", "--image-path", str(src), "--num-images", "1",
                "--num-steps", "1", "--output-dir", str(out)])
    want = to_uint8(jimages.load_image(str(src), SIZE))
    np.testing.assert_array_equal(np.asarray(Image.open(out / "source.png")), want)


@pytest.mark.parametrize("shape,out", [((800, 1067), (768, 768)), ((1067, 800), (512, 512))])
def test_resize_is_pil_lanczos_at_co3d_sizes(shape, out):
    """The port's Lanczos on CO3D's non-square frames against PIL's, within
    one level (measured: 0 values differ in both)."""
    a = _photo(*shape, seed=shape[0])
    want = np.asarray(Image.fromarray(a).resize(out[::-1], Image.LANCZOS))
    got = resize(a, *out)
    assert _within_one_level(got, want, level=1) == 0


# ------------------------------------------------------------------ CO3D


@pytest.fixture(scope="module")
def co3d_tree(tmp_path_factory):
    """The JAX package's CO3D test tree, as it writes it: 16² JPEG frames."""
    return make_co3d_tree(str(tmp_path_factory.mktemp("co3d")), n_seq=4, n_frames=4)


@pytest.mark.parametrize("image_size,differ", [(16, 0), (24, 0)])
def test_co3d_read_view_matches_jax(co3d_tree, image_size, differ):
    """Every frame's ``_read_view``: bitwise at 16² (no resize); 16² -> 24²
    within one level (measured: 0 values differ)."""
    kw = dict(image_size=image_size, val_split=0.25, test_split=0.25)
    j, t = jco3d.CO3DDataset(co3d_tree, "train", **kw), tco3d.CO3DDataset(co3d_tree, "train", **kw)
    assert t.sequences == j.sequences and len(t.sequences) > 0
    n = 0
    for seq in t.sequences:
        for view in sorted(t.frames[seq]):
            (gi, gc), (wi, wc) = t._read_view(seq, view), j._read_view(seq, view)
            np.testing.assert_array_equal(gc, wc)
            n += _within_one_level(gi, wi)
    assert n == differ


def test_co3d_loaders_match_jax(co3d_tree):
    kw = dict(image_size=16, val_split=0.25, test_split=0.25, max_views_per_object=3)
    j, t = jco3d.CO3DDataset(co3d_tree, "train", **kw), tco3d.CO3DDataset(co3d_tree, "train", **kw)
    jl = list(jobj.DataLoader(j, JHashTokenizer(), batch_size=2, num_workers=1, shuffle=False))
    tl = list(tobj.DataLoader(t, HashTokenizer(), batch_size=2, num_workers=1, shuffle=False))
    assert len(jl) == len(tl) > 0
    for w, g in zip(jl, tl):
        assert w.keys() == g.keys()
        for k in w:
            assert w[k].dtype == g[k].dtype and np.array_equal(w[k], g[k]), k


def test_train_cli_on_a_co3d_jpeg_corpus(tmp_path):
    from mvd_tpu_torch.cli import train

    root = make_co3d_tree(str(tmp_path / "co3d"), n_seq=6, n_frames=3)
    out = tmp_path / "out"
    tr = train.main(["--tiny", "--device", "cpu", "--dataset-path", root, "--dataset-format", "co3d",
                     "--batch-size", "2", "--max-steps", "2", "--output-dir", str(out)])
    assert tr.state.step == 2
    lines = [json.loads(x) for x in (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/noise_loss"] for r in lines if "train/noise_loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()
    with pytest.raises(ValueError, match="no native reader"):
        train.main(["--tiny", "--device", "cpu", "--dataset-path", root, "--dataset-format", "co3d",
                    "--native-loader", "--output-dir", str(tmp_path / "o2")])


# --------------------------------------------------------- native reader


_ADAM7 = ((0, 8, 0, 8), (4, 8, 0, 8), (0, 4, 4, 8), (2, 4, 0, 4), (0, 2, 2, 4), (1, 2, 0, 2),
          (0, 1, 1, 2))


def _paeth(a, b, c):
    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def _raw_png(samples: np.ndarray, depth: int, colour: int, interlace: int = 0, plte: bytes = b"",
             trns: bytes = b"") -> bytes:
    """A PNG of (h, w, channels) samples at ``depth``, every row filtered
    with the next of the five filter types in turn."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = _ADAM7 if interlace else ((0, 1, 0, 1),)
    raw, kind = bytearray(), 0
    for x0, dx, y0, dy in passes:
        sub = samples[y0::dy, x0::dx]
        prev = None
        for row in sub:
            flat = row.reshape(-1).astype(np.int64)
            if depth == 16:
                line = flat.astype(">u2").tobytes()
            elif depth == 8:
                line = flat.astype(np.uint8).tobytes()
            else:
                bits = ((flat[:, None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(-1)
                line = np.packbits(bits.astype(np.uint8)).tobytes()
            prev = prev or bytes(len(line))
            out = bytearray(len(line))
            for i, v in enumerate(line):
                a = line[i - bpp] if i >= bpp else 0
                c = prev[i - bpp] if i >= bpp else 0
                pred = (0, a, prev[i], (a + prev[i]) >> 1, _paeth(a, prev[i], c))[kind]
                out[i] = (v - pred) & 255
            raw += bytes([kind]) + out
            kind, prev = (kind + 1) % 5, line

    def chunk(k, body):
        return struct.pack(">I", len(body)) + k + body + struct.pack(">I", zlib.crc32(k + body))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
    body += chunk(b"PLTE", plte) if plte else b""
    body += chunk(b"tRNS", trns) if trns else b""
    return b"\x89PNG\r\n\x1a\n" + body + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b"")


def _pil_png(im: Image.Image, **options) -> bytes:
    buf = io.BytesIO()
    im.save(buf, "PNG", **options)
    return buf.getvalue()


def _with_bad_text_chunk(png: bytes) -> bytes:
    """The PNG with a tEXt chunk (ancillary) that fails its CRC after IHDR."""
    body = b"Comment\x00crc off by one"
    crc = struct.pack(">I", (zlib.crc32(b"tEXt" + body) + 1) & 0xFFFFFFFF)
    return png[:33] + struct.pack(">I", len(body)) + b"tEXt" + body + crc + png[33:]


def _native_pngs():
    """Every colour type, bit depth, tRNS form and interlacing libpng reads."""
    rng = np.random.default_rng(7)
    a = _photo(23, 19, 3)
    alpha = rng.integers(0, 256, (23, 19), dtype=np.uint8)
    pal = a.reshape(-1, 3)[:40].tobytes()
    idx = rng.integers(0, 40, (23, 19, 1))
    p = Image.fromarray(a).convert("P", palette=Image.ADAPTIVE, colors=40)
    gray16 = rng.integers(0, 65536, (23, 19, 1))
    rgb16 = rng.integers(0, 65536, (23, 19, 3))
    rgb16[::3, ::2] = (1000, 2000, 3000)
    gray2 = rng.integers(0, 4, (23, 19, 1))
    return {
        "rgba.png": _pil_png(Image.fromarray(np.dstack([a, alpha]), "RGBA")),
        "rgb.png": _pil_png(Image.fromarray(a)),
        "l.png": _pil_png(Image.fromarray(a[..., 0])),
        "la.png": _pil_png(Image.fromarray(np.dstack([a[..., 0], alpha]), "LA")),
        "p.png": _pil_png(p),
        "p_trns.png": _pil_png(p, transparency=3),
        "p4.png": _pil_png(Image.fromarray(a).convert("P", palette=Image.ADAPTIVE, colors=16), bits=4),
        "bit1.png": _pil_png(Image.fromarray(a[..., 0] > 100)),
        "l_trns.png": _pil_png(Image.fromarray(a[..., 0]), transparency=int(a[3, 4, 0])),
        "rgb_trns.png": _pil_png(Image.fromarray(a), transparency=tuple(int(x) for x in a[5, 6])),
        "gray16.png": _raw_png(gray16, 16, 0),
        "gray16_trns.png": _raw_png(gray16, 16, 0, trns=struct.pack(">H", int(gray16[2, 3, 0]))),
        "gray2_trns.png": _raw_png(gray2, 2, 0, trns=struct.pack(">H", 2)),
        "rgb16_trns.png": _raw_png(rgb16, 16, 2, trns=struct.pack(">3H", 1000, 2000, 3000)),
        "rgba16.png": _raw_png(rng.integers(0, 65536, (23, 19, 4)), 16, 6),
        "la16.png": _raw_png(rng.integers(0, 65536, (23, 19, 2)), 16, 4),
        "adam7_rgba.png": _raw_png(np.dstack([a, alpha]), 8, 6, interlace=1),
        "adam7_p2.png": _raw_png(idx % 4, 2, 3, interlace=1, plte=pal[:12], trns=bytes([0, 128])),
        "p_idx_past_plte.png": _raw_png(idx, 8, 3, plte=pal[:30 * 3]),
        "rgba_bad_text_crc.png": _with_bad_text_chunk(_pil_png(Image.fromarray(np.dstack([a, alpha]), "RGBA"))),
    }


@pytest.fixture(scope="module")
def native_zip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("native") / "views.zip")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        for name, data in _native_pngs().items():
            z.writestr(f"obj/{name}", data)
    return path


@pytest.fixture(scope="module")
def libpng_reader(tmp_path_factory):
    """The JAX package's C++ reader (``native/mvd_native.cpp``, zlib and
    libpng) built with the port's flags: no -march=native, no contraction."""
    lib = str(tmp_path_factory.mktemp("libpng") / "libmvd_native_nofma.so")
    subprocess.run(["c++", *_build.HOST_FLAGS, "-o", lib, str(REPO / "native" / "mvd_native.cpp"),
                    "-lz", "-lpng"], check=True, capture_output=True)
    lib = ctypes.CDLL(lib)
    lib.mvd_load_view.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p]
    lib.mvd_load_view.restype = ctypes.c_int

    def load(zip_path, entry, size):
        out = np.empty((size, size, 3), np.float32)
        assert lib.mvd_load_view(zip_path.encode(), entry.encode(), size, out.ctypes.data) == 0
        return out

    return load


@pytest.mark.parametrize("name", sorted(_native_pngs()))
def test_native_reader_is_the_jax_reader(native_zip, libpng_reader, name):
    """Each PNG form at 23x19 -> 16², 23², 40²: bitwise the plain version
    and the JAX C++ built with the port's flags; within 5e-7 of the JAX
    reader as the JAX package builds it (measured at most 3.6e-7)."""
    for size in (16, 23, 40):
        got = native_loader.load_view(native_zip, name, size)
        assert got.dtype == np.float32 and got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, native_loader.load_view_plain(native_zip, name, size))
        np.testing.assert_array_equal(got, libpng_reader(native_zip, name, size))
        assert np.abs(got - jnative.load_view(native_zip, name, size)).max() <= NATIVE_TOL
    batch = native_loader.load_views_batch(native_zip, [name, name], 16)
    np.testing.assert_array_equal(batch[1], native_loader.load_view(native_zip, name, 16))


def test_bad_ancillary_crc_raises_on_the_pil_path_only(native_zip):
    """One chunk walk (``png_chunks``), two CRC policies: the PIL path's
    ``decode_png`` raises on a tEXt chunk that fails its CRC, as PIL does;
    the native reader drops it, as libpng does, and reads the image as it
    reads the file without it."""
    with zipfile.ZipFile(native_zip) as z:
        bad = z.read("obj/rgba_bad_text_crc.png")
        good = z.read("obj/rgba.png")
    assert bad == _with_bad_text_chunk(good)
    with pytest.raises(ValueError, match=r"b'tEXt' fails its CRC"):
        decode_png(bad)
    with pytest.raises(Exception):
        Image.open(io.BytesIO(bad)).convert("RGB")
    np.testing.assert_array_equal(native_loader.load_view(native_zip, "rgba_bad_text_crc.png", 16),
                                  native_loader.load_view(native_zip, "rgba.png", 16))


def test_native_dataset_and_loader_match_jax_native(tmp_path):
    """``ObjaverseDataset(use_native=True)`` and ``ObjaverseDataModule``
    through ``DataLoader``: the JAX native dataset's batches within 5e-7,
    cameras bitwise; the default reads the PIL path's function."""
    from tests.test_data import make_zip

    root = tmp_path / "c"
    (root / "renders_final").mkdir(parents=True)
    rng = np.random.default_rng(3)
    for i in range(4):
        make_zip(root / "renders_final" / f"obj_{i}.zip", num_views=3, size=24, rng=rng)
    kw = dict(image_size=16, val_split=0.25, test_split=0.25)
    j = jobj.ObjaverseDataset(str(root), "train", cache_dir=str(tmp_path / "j"), use_native=True, **kw)
    t = tobj.ObjaverseDataset(str(root), "train", cache_dir=str(tmp_path / "t"), use_native=True, **kw)
    jl = list(jobj.DataLoader(j, JHashTokenizer(), batch_size=2, num_workers=1, shuffle=False))
    tl = list(tobj.DataLoader(t, HashTokenizer(), batch_size=2, num_workers=2, shuffle=False))
    assert len(jl) == len(tl) > 0
    for w, g in zip(jl, tl):
        for k in w:
            tol = NATIVE_TOL if k.endswith("_image") else 0
            assert w[k].dtype == g[k].dtype and np.abs(w[k] - g[k]).max() <= tol, k
    pil = tobj.ObjaverseDataset(str(root), "train", cache_dir=str(tmp_path / "t"), **kw)
    assert not pil.use_native
    np.testing.assert_array_equal(pil[0]["source_image"], jobj.ObjaverseDataset(
        str(root), "train", cache_dir=str(tmp_path / "j"), use_native=False, **kw)[0]["source_image"])
    dm = tobj.ObjaverseDataModule(str(root), HashTokenizer(), image_size=16, batch_size=2,
                                  use_native=True)
    dm.setup()
    assert all(d.use_native for d in dm.datasets.values())


def test_palette_trns_differs_between_the_two_jax_readers(tmp_path):
    """A palette PNG with tRNS: PIL's ``convert("RGB")`` drops the
    transparency, libpng's tRNS -> alpha composites it over white. Each
    port path is its JAX path's function."""
    a = _photo(20, 20, 4)
    p = Image.fromarray(a).convert("P", palette=Image.ADAPTIVE, colors=50)  # 8-bit indices
    data = _pil_png(p, transparency=int(np.asarray(p)[0, 0]))
    zp = str(tmp_path / "t.zip")
    with zipfile.ZipFile(zp, "w") as z:
        z.writestr("000.png", data)
    pil_path = tobj._load_image_from_bytes(data, 20)
    np.testing.assert_array_equal(pil_path, jobj._load_image_from_bytes(data, 20))
    native = native_loader.load_view(zp, "000.png", 20)
    assert np.abs(native - jnative.load_view(zp, "000.png", 20)).max() <= NATIVE_TOL
    assert (native[0, 0] == 1.0).all() and not (pil_path[0, 0] == 1.0).all()  # white vs the colour


def test_native_member_match_is_on_a_path_boundary(tmp_path):
    """``001.png`` names ``obj/001.png`` but not ``obj/1001.png`` for the
    native reader, as in the JAX C++; the PIL path's bare ``endswith``
    takes the first of the two, as in JAX."""
    first, second = _photo(8, 8, 5), _photo(8, 8, 6)
    zp = str(tmp_path / "b.zip")
    with zipfile.ZipFile(zp, "w") as z:
        z.writestr("obj/1001.png", _pil_png(Image.fromarray(first)))
        z.writestr("obj/001.png", _pil_png(Image.fromarray(second)))
        z.writestr("obj/001.npy", b"x")
    want = native_loader.composite_resize_normalize_plain(
        np.dstack([second, np.full((8, 8), 255, np.uint8)]), 8)
    np.testing.assert_array_equal(native_loader.load_view(zp, "001.png", 8), want)
    np.testing.assert_array_equal(jnative.load_view(zp, "001.png", 8), want)
    assert native_loader.read_entry(zp, "001.npy") == jnative.read_entry(zp, "001.npy") == b"x"
    ds = object.__new__(tobj.ObjaverseDataset)
    ds._zip_lock, ds._zip_handles = threading.Lock(), {}
    pil = tobj._load_image_from_bytes(ds._entry(zp, 1, ".png"), 8)
    np.testing.assert_array_equal(pil, first.astype(np.float32) / 255.0 * 2.0 - 1.0)


def test_a_failed_native_read_raises_where_jax_falls_back(tmp_path):
    """A view the native reader cannot find (``obj_001.png``: no path
    boundary before ``001.png``): the JAX dataset falls through to its PIL
    path, which finds it by ``endswith``; the port raises, naming the zip
    and the entry. A damaged PNG raises the same way."""
    view = _photo(16, 16, 8)
    zp = str(tmp_path / "obj.zip")
    with zipfile.ZipFile(zp, "w") as z:
        z.writestr("obj_000.png", _pil_png(Image.fromarray(view)))
        buf = io.BytesIO()
        np.save(buf, np.eye(4, dtype=np.float32))
        z.writestr("000.npy", buf.getvalue())
        z.writestr("001.png", _pil_png(Image.fromarray(view))[:60])
        z.writestr("001.npy", buf.getvalue())
    j = object.__new__(jobj.ObjaverseDataset)
    j.use_native, j.image_size, j._zip_lock, j._zip_handles = True, 16, threading.Lock(), {}
    img, _ = j._read_view(zp, 0)  # the JAX fallback: PIL's function
    np.testing.assert_array_equal(img, view.astype(np.float32) / 255.0 * 2.0 - 1.0)
    t = object.__new__(tobj.ObjaverseDataset)
    t.use_native, t.image_size, t._zip_lock, t._zip_handles = True, 16, threading.Lock(), {}
    with pytest.raises(RuntimeError, match=r"obj\.zip: 000\.png: .*no member"):
        t._read_view(zp, 0)
    with pytest.raises(RuntimeError, match=r"obj\.zip: 001\.png: .*truncated"):
        t._read_view(zp, 1)
    with open(tmp_path / "bad.zip", "wb") as f:
        f.write(b"not a zip")
    with pytest.raises(zipfile.BadZipFile, match="bad.zip"):
        native_loader.load_view(str(tmp_path / "bad.zip"), "000.png", 16)


# ------------------------------------------------------------ host build


def test_host_build_raises_without_a_compiler_or_on_a_failed_build(tmp_path, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(_build, "HOST_CXX", "no-such-c++")
        with pytest.raises(RuntimeError, match="no C\\+\\+ compiler: 'no-such-c\\+\\+'"):
            _build.build_host("jpeg_decode", str(tmp_path / "a"))
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "broken.cpp").write_text("int f() { return undeclared_name; }\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    with pytest.raises(RuntimeError, match="(?s)building broken.cpp failed.*undeclared_name"):
        _build.build_host("broken", str(tmp_path / "b"))
    assert not [p for p in os.listdir(tmp_path / "b") if p.endswith(".tmp")]
    # rebuilt when the source is newer than the library, not before
    (csrc / "ok.cpp").write_text('extern "C" int f() { return 1; }\n')
    lib = _build.build_host("ok", str(tmp_path / "b"))
    os.utime(lib, (100.0, 100.0))
    os.utime(csrc / "ok.cpp", (50.0, 50.0))
    assert _build.build_host("ok", str(tmp_path / "b")) == lib and os.path.getmtime(lib) == 100.0
    os.utime(csrc / "ok.cpp", (200.0, 200.0))
    _build.build_host("ok", str(tmp_path / "b"))
    assert os.path.getmtime(lib) > 200.0


def test_build_all_builds_the_host_sources_beside_the_kernels(tmp_path, monkeypatch):
    """``build_all(KERNEL_SOURCES, HOST_SOURCES)`` is the one build of the
    package: the host sources it is given are built (no ``nvcc`` runs when
    no CUDA source is stale), and a host build that fails raises out of it."""
    from mvd_tpu_torch.kernels import HOST_SOURCES

    assert all((REPO / "mvd_tpu_torch" / "csrc" / f"{n}.cpp").exists() for n in HOST_SOURCES)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "ok.cpp").write_text('extern "C" int f() { return 1; }\n')
    (csrc / "broken.cpp").write_text("int f() { return undeclared_name; }\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    _build.build_all([], ["ok"])
    assert ctypes.CDLL(str(tmp_path / "build" / "libok.so")).f() == 1
    with pytest.raises(RuntimeError, match="building broken.cpp failed"):
        _build.build_all([], ["ok", "broken"])


def test_two_processes_build_one_library_at_once(tmp_path):
    code = ("import sys; from mvd_tpu_torch.kernels._build import build_host; "
            "print(build_host('jpeg_decode', sys.argv[1]))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE) for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    paths = {o[0].strip() for o in outs}
    assert paths == {str(tmp_path / "libjpeg_decode.so")}
    assert sorted(os.listdir(tmp_path)) == ["libjpeg_decode.so", "libjpeg_decode.so.lock"]
    lib = ctypes.CDLL(paths.pop())
    assert hasattr(lib, "mvd_jpeg_decode") and hasattr(lib, "mvd_jpeg_info")


READERS_WITHOUT_PIL = """
import sys
sys.modules.update(PIL=None, jax=None, flax=None, mvd_tpu=None)
import numpy as np
from mvd_tpu_torch.data import native_loader
from mvd_tpu_torch.utils.images import decode_image
jpg, zp, entry = sys.argv[1:]
img = decode_image(open(jpg, "rb").read())
view = native_loader.load_view(zp, entry, 16)
np.save(sys.argv[1] + ".npy", img)
np.save(zp + ".npy", view)
print("ok")
"""


def test_readers_run_without_pil_and_link_only_the_standard_library(native_zip, tmp_path):
    """Both readers in a process where PIL, JAX and the JAX package cannot
    be imported give what they give here; the host C++ includes only
    standard headers (no libpng, libjpeg or zlib), and the port builds
    nothing under ``native/``."""
    std = {"algorithm", "cstdint", "cstdio", "cstdlib", "cstring", "stdexcept", "string", "vector"}
    csrc = REPO / "mvd_tpu_torch" / "csrc"
    for src in sorted(csrc.glob("*.cpp")):
        lines = [line for line in src.read_text().splitlines() if line.startswith("#include")]
        local = [line.split('"')[1] for line in lines if '"' in line]  # a header of csrc/, held below
        for header in local:
            assert header.endswith(".h") and (csrc / header).exists(), (src.name, header)
            lines += [line for line in (csrc / header).read_text().splitlines() if line.startswith("#include")]
        includes = {line.split("<")[1].split(">")[0] for line in lines if "<" in line}
        assert includes <= std, (src.name, includes - std)
    assert _build.CSRC == str(REPO / "mvd_tpu_torch" / "csrc")
    jpg = tmp_path / "s420.jpg"
    jpg.write_bytes(_fixture("s420.jpg"))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", READERS_WITHOUT_PIL, str(jpg), native_zip, "rgba.png"],
                          env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]
    np.testing.assert_array_equal(np.load(str(jpg) + ".npy"), _pil_rgb(_fixture("s420.jpg")))
    np.testing.assert_array_equal(np.load(native_zip + ".npy"), native_loader.load_view(native_zip, "rgba.png", 16))
