"""The port's GIF, BMP/DIB and TIFF readers (``utils/images.py``:
``decode_gif``, ``decode_bmp``, ``pil_rgb``; ``utils/tiff.py``:
``decode_tiff``; ``csrc/gif_decode.cpp``, ``bmp_decode.cpp``,
``tiff_decode.cpp``, ``pil_unpack.h``) against PIL 12.1.0, which reads GIF
and BMP with its own plugins and TIFF with its own raw decoder
(uncompressed) or libtiff 4.7.1 (compressed).

Bars: every fixture (``tests/fixtures/torch_port_images``, written by
``make_formats.py`` there) decodes through ``decode_image`` bitwise to
``np.asarray(Image.open(...).convert("RGB"))``, in PIL's mode, and to
the stored digests; ``composite_alpha`` composites exactly the files PIL
opens as RGBA; ``load_image``, the server's upload decode and the Objaverse
loader's decode are the JAX functions value for value, and a one-thread
loader batch from a corpus of GIF, BMP and TIFF views is the JAX loader's;
``decode_image`` dispatches in ``Image.open``'s order; PIL's quirks are
pinned (I;16 clipped, F truncated, a raw YCbCr TIFF opened as RGB, LA and
PA not composited, RGBa unpremultiplied); every unpacker the readers use is
PIL's on random bytes; seeded random files of each format decode as PIL
decodes them; what PIL refuses is refused, and what PIL reads and the port
does not names ROADMAP item 13c; the fixtures decode to PIL's digests in a
process that cannot import PIL, JAX or the JAX package; ``chip_smoke.py``'s
PIL-free sources decode in PIL to the pixels they were written from.
"""

import base64
import hashlib
import importlib.util
import io
import json
import os
import pathlib
import struct
import subprocess
import sys
import warnings
import zlib
import zipfile

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from mvd_tpu.cli import serve as jserve
from mvd_tpu.data import objaverse as jobj
from mvd_tpu.data.tokenizer import HashTokenizer as JHashTokenizer
from mvd_tpu.utils import images as jimages
from mvd_tpu_torch.cli import serve as tserve
from mvd_tpu_torch.config import TINY_MODEL
from mvd_tpu_torch.data import objaverse as tobj
from mvd_tpu_torch.data.tokenizer import HashTokenizer
from mvd_tpu_torch.utils import tiff as ttiff
from mvd_tpu_torch.utils.images import PilImage, decode_bmp, decode_gif, decode_image, is_dib, load_image

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "torch_port_images"
DIGESTS = json.loads((FIXTURES / "formats_sha256.json").read_text())
READ = sorted(n for n in DIGESTS if not n.startswith(("bad_", "notread_")))
BAD = sorted(n for n in DIGESTS if n.startswith("bad_"))
NOT_READ = sorted(n for n in DIGESTS if n.startswith("notread_"))
SIZE = TINY_MODEL.unet.sample_size * 8


def _make_formats():
    spec = importlib.util.spec_from_file_location("torch_port_formats_fixtures", FIXTURES / "make_formats.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FX = _make_formats()


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _fixture(name: str) -> bytes:
    return (FIXTURES / name).read_bytes()


def _pil_rgb(data: bytes):
    """PIL's image mode and ``convert("RGB")``."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        im = Image.open(io.BytesIO(data))
        return im.mode, np.asarray(im.convert("RGB"))


def _pil_composite(data: bytes) -> np.ndarray:
    """The JAX loader's white composite of an RGBA image, then RGB."""
    im = Image.open(io.BytesIO(data))
    bg = Image.new("RGBA", im.size, (255, 255, 255, 255))
    return np.asarray(Image.alpha_composite(bg, im).convert("RGB"))


def _decode(data: bytes) -> PilImage:
    if data.startswith(b"BM") or is_dib(data):
        return decode_bmp(data)
    if data.startswith((b"GIF87a", b"GIF89a")):
        return decode_gif(data)
    return ttiff.decode_tiff(data)


# -------------------------------------------------------------- fixtures


def test_fixtures_hold_every_form():
    """Every form the readers cover has a fixture: GIF written by PIL and
    by hand (a frame at an offset with and without transparency, a frame
    past the screen, local tables, interlace, a full table kept and
    cleared); BMP of each header size, depth, compression and bit-field
    layout, DIBs; TIFF of every compression read, predictors 2 and 3,
    strips and tiles, planes, II and MM, BigTIFF, FillOrder 2, old-style
    LZW; and one refused file a format at least."""
    need = ["gif_pil_p.gif", "gif_pil_l.gif", "gif_pil_trns.gif", "gif_offset.gif", "gif_offset_trns.gif",
            "gif_grow.gif", "gif_local_table.gif", "gif_local_gray_ramp.gif", "gif_interlace.gif",
            "gif_table_full_kept.gif", "gif_table_full_clear.gif", "gif87a.gif",
            "bmp_pil_1.bmp", "bmp_pil_l.bmp", "bmp_pil_p.bmp", "bmp_pil_rgb.bmp", "bmp_4bit.bmp",
            "bmp_os2_8bit.bmp", "bmp_os2v2_64_24bit.bmp", "bmp_v52_24bit.bmp", "bmp_v56_24bit.bmp",
            "bmp_v108_24bit.bmp", "bmp_v124_24bit.bmp", "bmp_rle8.bmp", "bmp_rle4.bmp", "bmp_rle8_delta.bmp",
            "bmp_bitfields_565.bmp", "bmp_bitfields_555.bmp", "bmp_bitfields_bgra.bmp", "bmp_8bit_topdown.bmp",
            "dib_24bit.dib", "dib_os2_4bit.dib", "dib_rle8.dib",
            "tif_pil_raw_rgb.tif", "tif_pil_packbits_rgb.tif", "tif_pil_lzw_rgb.tif", "tif_pil_deflate_rgb.tif",
            "tif_pil_zip_rgb.tif", "tif_pil_lzw_pred2_strips.tif", "tif_pil_deflate_pred2_tiled.tif",
            "tif_raw_tiles_edge.tif", "tif_raw_planar.tif", "tif_lzw_planar_rgba16.tif",
            "tif_deflate_planar_tiled.tif", "tif_lzw_old_style.tif", "tif_deflate_pred3_float.tif",
            "tif_bigtiff_lzw.tif", "tif_bigtiff_raw.tif", "tif_mm_deflate_tiled.tif", "tif_lzw_1bit_fill2.tif",
            "tif_deflate_rgb_fill2.tif", "tif_invalid_mark_mm_raw.tif", "tif_invalid_mark_ii_raw.tif",
            "tif_orientation6.tif", "tif_raw_rgba_assoc.tif"]
    assert set(need) <= set(READ)
    for prefix in ("bad_gif", "bad_bmp", "bad_tif"):
        assert any(n.startswith(prefix) for n in BAD)
    modes = {DIGESTS[n]["mode"] for n in READ}
    assert {"1", "L", "P", "LA", "PA", "I;16", "I;16B", "I", "F", "RGB", "RGBA", "CMYK"} <= modes


@pytest.mark.parametrize("name", READ)
def test_fixture_is_pil_in_its_mode(name):
    """``decode_image`` is PIL's ``convert("RGB")`` bitwise and matches the
    stored digest; the reader's mode is PIL's; with ``composite_alpha`` a
    file PIL opens as RGBA is composited over white as the JAX loader
    composites it, and any other mode (LA, PA, a transparent GIF) is not."""
    data = _fixture(name)
    want = DIGESTS[name]
    mode, rgb = _pil_rgb(data)
    got = decode_image(data)
    assert _decode(data).mode == mode == want["mode"]
    np.testing.assert_array_equal(got, rgb)
    assert list(got.shape) == want["shape"] and _sha(got) == want["sha256"]
    comp = decode_image(data, composite_alpha=True)
    if mode == "RGBA":
        np.testing.assert_array_equal(comp, _pil_composite(data))
        assert _sha(comp) == want["composite_sha256"]
    else:
        np.testing.assert_array_equal(comp, got)


@pytest.mark.parametrize("name", BAD)
def test_what_pil_refuses_is_refused(name):
    """Each malformed file: PIL raises at open or load, and the port raises
    ``ValueError`` naming what is wrong."""
    data = _fixture(name)
    assert "refused" in DIGESTS[name]
    with pytest.raises(Exception):
        _pil_rgb(data)
    with pytest.raises(ValueError, match=r"\S"):
        decode_image(data)


@pytest.mark.parametrize("name", NOT_READ)
def test_forms_not_read_name_roadmap_13c(name):
    """CCITT, old-style JPEG with its tables in tags 519-521, planar YCbCr
    and a JPEG strip shorter than its segment: PIL reads them, the port
    refuses them naming the form and ROADMAP item 13c."""
    data = _fixture(name)
    assert "refused" not in DIGESTS[name]
    _pil_rgb(data)
    with pytest.raises(ValueError, match="ROADMAP item 13c"):
        decode_image(data)


def test_refusal_names_the_other_formats():
    """A file no plugin takes (an ICO header without icons): PIL's words,
    "cannot identify image file", with each plugin's reason for passing it
    on (ICO's, then TGA's, which has no signature)."""
    with pytest.raises(ValueError, match=r"cannot identify image file.*ICO: .*TGA: not a TGA file"):
        decode_image(b"\x00\x00\x01\x00" + bytes(40))  # an ICO header


# ------------------------------------------------- the JAX package's paths


@pytest.mark.parametrize("name", READ)
def test_load_image_server_and_loader_are_the_jax_functions(tmp_path, name):
    """``load_image`` (``cli.infer``'s source read), the server's
    ``_b64_png`` and the Objaverse ``_load_image_from_bytes`` are the JAX
    functions value for value on the fixture's bytes, at its size and at
    the model's 64²."""
    data = _fixture(name)
    path = tmp_path / name
    path.write_bytes(data)
    h, w = DIGESTS[name]["shape"][:2]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        np.testing.assert_array_equal(load_image(str(path)), jimages.load_image(str(path)))
        np.testing.assert_array_equal(load_image(str(path), SIZE), jimages.load_image(str(path), SIZE))
        b64 = base64.b64encode(data).decode()
        np.testing.assert_array_equal(tserve._b64_png(b64, SIZE), jserve._b64_png(b64, SIZE))
        np.testing.assert_array_equal(tobj._load_image_from_bytes(data, SIZE),
                                      jobj._load_image_from_bytes(data, SIZE))
        if h == w:
            np.testing.assert_array_equal(tobj._load_image_from_bytes(data, h), jobj._load_image_from_bytes(data, h))


def test_loader_batch_from_gif_bmp_tiff_views_is_the_jax_loaders(tmp_path):
    """An Objaverse corpus whose views are GIF, BMP, DIB and TIFF files
    (under the loader's ``NNN.png`` names: both read by content): every
    batch of the port's one-thread loader is the JAX loader's."""
    root = tmp_path / "corpus"
    (root / "renders_final").mkdir(parents=True)
    names = [n for n in READ if DIGESTS[n]["shape"][0] >= 8 and DIGESTS[n]["shape"][1] >= 8]
    rng = np.random.default_rng(5)
    for i in range(4):
        with zipfile.ZipFile(root / "renders_final" / f"obj_{i}.zip", "w") as z:
            for v in range(3):
                z.writestr(f"{v:03d}.png", _fixture(names[(7 * i + 3 * v) % len(names)]))
                buf = io.BytesIO()
                cam = np.eye(4, dtype=np.float32)
                cam[:3, 3] = rng.standard_normal(3)
                np.save(buf, cam)
                z.writestr(f"{v:03d}.npy", buf.getvalue())
            z.writestr("prompt.txt", f"object {i}")
    kw = dict(image_size=16, val_split=0.0, test_split=0.0)
    j = jobj.ObjaverseDataset(str(root), "train", cache_dir=str(tmp_path / "jax"), use_native=False, **kw)
    t = tobj.ObjaverseDataset(str(root), "train", cache_dir=str(tmp_path / "port"), **kw)
    jl = jobj.DataLoader(j, JHashTokenizer(), batch_size=2, seed=3, num_workers=1)
    tl = tobj.DataLoader(t, HashTokenizer(), batch_size=2, seed=3, num_workers=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, got = list(jl), list(tl)
    assert len(want) == len(got) > 0
    for w, g in zip(want, got):
        assert w.keys() == g.keys()
        for k in w:
            assert w[k].dtype == g[k].dtype and np.array_equal(w[k], g[k]), k


# --------------------------------------------------------------- dispatch


def test_dispatch_follows_image_opens_order():
    """BMP's ``BM``, then a DIB's header size as the first int32, then GIF,
    then TIFF's six prefixes (the two invalid byte-order marks and
    BigTIFF's ``+`` among them), as ``Image.open`` tries its plugins."""
    dib = _fixture("dib_24bit.dib")
    assert is_dib(dib) and not is_dib(_fixture("bmp_pil_rgb.bmp"))
    for size in (12, 40, 52, 56, 64, 108, 124):
        assert is_dib(struct.pack("<I", size) + bytes(8))
    assert not is_dib(struct.pack("<I", 41) + bytes(8))
    assert Image.open(io.BytesIO(dib)).format == "DIB"
    for name, fmt in (("tif_invalid_mark_mm_raw.tif", "TIFF"), ("tif_invalid_mark_ii_raw.tif", "TIFF"),
                      ("tif_bigtiff_raw.tif", "TIFF"), ("gif87a.gif", "GIF"), ("bmp_pil_rgb.bmp", "BMP")):
        data = _fixture(name)
        assert Image.open(io.BytesIO(data)).format == fmt
        np.testing.assert_array_equal(decode_image(data), _pil_rgb(data)[1])
    # a DIB whose header size is also PNG's first int32 cannot exist: the
    # signatures do not meet, and a BM file never reads as a DIB
    assert not is_dib(b"\x89PNG\r\n\x1a\n") and not is_dib(b"BM" + bytes(12))


# ------------------------------------------------------------ PIL's quirks


def _tiny_tiff(samples, **kw) -> bytes:
    return FX.tiff_image(np.asarray(samples), **kw)


def test_i16_clips_at_255():
    """I;16 -> RGB clips: 256, 1000 and 65535 give 255."""
    data = _tiny_tiff(np.array([[1, 255, 256, 1000, 65535]]), photometric=1, bits=16)
    mode, rgb = _pil_rgb(data)
    assert mode == "I;16" and rgb[0, :, 0].tolist() == [1, 255, 255, 255, 255]
    np.testing.assert_array_equal(decode_image(data), rgb)


def test_f_truncates_toward_zero_then_clips():
    """F -> RGB truncates toward zero and clips: -1 -> 0, 0.4 -> 0, 100.6 ->
    100, 300 -> 255 (NaN -> 0, inf -> 255)."""
    vals = np.array([[-1, 0.4, 100.6, 300, np.nan, np.inf, -np.inf, 255.9]], np.float32)
    data = _tiny_tiff(vals, photometric=1, bits=32, sample_format=3)
    mode, rgb = _pil_rgb(data)
    assert mode == "F" and rgb[0, :, 0].tolist() == [0, 0, 100, 255, 0, 255, 0, 255]
    np.testing.assert_array_equal(decode_image(data), rgb)


def test_raw_ycbcr_tiff_opens_as_rgb():
    """PIL opens an uncompressed YCbCr TIFF it wrote in mode RGB (rawmode
    RGBX: four bytes a pixel of three-byte data) and then runs out of data;
    the port refuses it too."""
    data = _fixture("bad_tif_ycbcr_raw.tif")
    im = Image.open(io.BytesIO(data))
    assert im.mode == "RGB" and im.tile[0].args[0] == "RGBX"
    with pytest.raises(OSError, match="truncated"):
        im.load()
    with pytest.raises(ValueError, match="truncated"):
        decode_image(data)


@pytest.mark.parametrize("name", ["tif_pil_la.tif", "tif_pil_pa.tif", "gif_pil_trns.gif"])
def test_la_pa_and_transparent_gif_are_not_composited(name):
    """The JAX loader composites only mode RGBA: an LA or PA TIFF and a GIF
    with a transparency index come out of ``composite_alpha`` as
    ``convert("RGB")`` gives them."""
    data = _fixture(name)
    mode, rgb = _pil_rgb(data)
    assert mode in ("LA", "PA", "P")
    np.testing.assert_array_equal(decode_image(data, composite_alpha=True), rgb)
    np.testing.assert_array_equal(tobj._load_image_from_bytes(data, 8), jobj._load_image_from_bytes(data, 8))


def test_rgba_associated_alpha_is_unpremultiplied():
    """ExtraSamples 1 (associated alpha) is PIL's RGBa rawmode: each colour
    times 255 over alpha, clipped; alpha 0 gives 0."""
    rgba = np.array([[[100, 50, 10, 128], [200, 200, 200, 100], [5, 6, 7, 0], [1, 2, 3, 255]]])
    data = _tiny_tiff(rgba, photometric=2, bits=8, extra=(1,))
    img = ttiff.decode_tiff(data)
    pil = np.asarray(Image.open(io.BytesIO(data)))
    assert img.mode == "RGBA"
    np.testing.assert_array_equal(img.pixels, pil)
    assert pil[0, 0].tolist() == [199, 99, 19, 128] and pil[0, 1, :3].tolist() == [255, 255, 255]
    assert pil[0, 2].tolist() == [0, 0, 0, 0]


def test_rgba_bmp_from_pil_reopens_as_rgb():
    """PIL saves RGBA as a 32-bit BI_RGB BMP and reopens it as RGB, its
    alpha dropped; RGBA comes only from bit fields with an alpha mask."""
    assert DIGESTS["bmp_pil_rgba.bmp"]["mode"] == "RGB" and decode_bmp(_fixture("bmp_pil_rgba.bmp")).mode == "RGB"
    assert decode_bmp(_fixture("bmp_bitfields_bgra.bmp")).mode == "RGBA"


def test_gif_outside_the_frame_is_the_transparency_index():
    """A frame at (5, 3) of a 24x17 screen: outside it, index 0 without a
    transparency index and the index with one (PIL's fill)."""
    plain, trns = decode_gif(_fixture("gif_offset.gif")), decode_gif(_fixture("gif_offset_trns.gif"))
    assert plain.pixels.shape == (17, 24) and plain.mode == trns.mode == "P"
    np.testing.assert_array_equal(plain.pixels[3:14, 5:18], trns.pixels[3:14, 5:18])
    outside = np.ones((17, 24), bool)
    outside[3:14, 5:18] = False
    assert (plain.pixels[outside] == 0).all() and (trns.pixels[outside] == 9).all()


# ------------------------------------------------------------ unpackers


def _unpack_cases():
    raws = {(m, r) for m, r in ttiff.OPEN_INFO.values() if m != "LAB"}
    raws |= {(m, r[:-1] + "N") for m, r in raws if r.endswith((";16L", ";16B"))} | {("I;16", "I;16N"),
                                                                                    ("I;16B", "I;16N")}
    raws |= {("RGB", r) for r in ("BGR;15", "BGR;16", "BGR", "BGRX", "XBGR", "BGXR", "R", "G", "B")}
    raws |= {("RGBA", r) for r in ("BGRA", "ABGR", "BGAR", "R", "G", "B", "A", "R;16N", "G;16N", "B;16N",
                                   "A;16N")}
    raws |= {("CMYK", r) for r in "CMYK"} | {("1", "1"), ("L", "L"), ("P", "P"), ("I", "I"), ("F", "F")}
    # the small formats' own (utils/small_formats.py: SGI, PCX, TGA)
    raws |= {("L", "L;16B"), ("P", "P;2L"), ("P", "P;4L"), ("RGB", "RGB;L"), ("RGBA", "BGRA;15Z")}
    return sorted(raws)


def _as_pil_array(mode: str, out: np.ndarray, n: int) -> np.ndarray:
    """The port's row (PIL's storage bytes) as ``np.asarray`` gives PIL's."""
    if mode == "1":
        return out != 0
    if mode in ("L", "P"):
        return out
    if mode in ("I;16", "I;16B"):
        return out.view("<u2" if mode == "I;16" else ">u2").astype(np.uint16)
    if mode in ("I", "F"):
        return out.view("<u4")
    px = out.reshape(n, 4)
    return {"RGB": px[:, :3], "LA": px[:, [0, 3]], "PA": px[:, [0, 3]]}.get(mode, px)


# rawmodes OPEN_INFO names for which PIL has no unpacker
NO_UNPACKER = {("L", "L;IR"), ("P", "P;1R"), ("P", "P;2R"), ("P", "P;4R")}


@pytest.mark.parametrize("mode,rawmode", sorted(NO_UNPACKER))
def test_rawmodes_pil_cannot_unpack_are_refused(mode, rawmode):
    """PIL has no unpacker of these rawmodes, so an uncompressed file of
    that form is refused by both."""
    with pytest.raises(ValueError, match="unknown raw mode"):
        Image.frombytes(mode, (8, 1), bytes(8), "raw", rawmode)
    assert ttiff.unpacker_bits(mode, rawmode) is None
    key = next(k for k, v in ttiff.OPEN_INFO.items() if v == (mode, rawmode))
    bits = key[4][0]
    data = FX.tiff_image(np.zeros((3, 5)), photometric=key[1], bits=bits, fill_order=2,
                         colormap=np.zeros((1 << bits, 3)) if mode == "P" else None)
    with pytest.raises(Exception):
        _pil_rgb(data)
    with pytest.raises(ValueError, match="unknown raw mode"):
        decode_image(data)


@pytest.mark.parametrize("mode,rawmode", [c for c in _unpack_cases() if c not in NO_UNPACKER])
def test_unpacker_is_pils(mode, rawmode):
    """Each (mode, rawmode) the readers hand PIL's unpackers, on 37 pixels
    of random bytes: the port's C++ unpacker is PIL's, bit for bit (floats
    by their bits)."""
    rng = np.random.default_rng(zlib.crc32(f"{mode} {rawmode}".encode()))
    n = 37
    bits = ttiff.unpacker_bits(mode, rawmode)
    data = rng.integers(0, 256, (n * bits + 7) // 8 + 8).astype(np.uint8).tobytes()
    im = Image.frombytes(mode, (n, 1), data, "raw", rawmode)
    want = np.asarray(im)[0]
    got = _as_pil_array(mode, ttiff.unpack(mode, rawmode, data, n), n)
    if mode in ("I", "F"):
        want = want.view("<u4")
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- random files


def _random_indices(rng, h, w, n):
    kind = rng.integers(0, 3)
    if kind == 0:
        return rng.integers(0, n, (h, w)).astype(np.uint8)
    y, x = np.mgrid[:h, :w]
    runs = ((x // int(rng.integers(1, 6)) + y * int(rng.integers(0, 3))) % n).astype(np.uint8)
    return runs if kind == 1 else np.where(rng.random((h, w)) < 0.1, rng.integers(0, n, (h, w)), runs).astype(np.uint8)


def random_gif(rng) -> bytes:
    h, w = int(rng.integers(1, 40)), int(rng.integers(1, 40))
    n = int(rng.integers(2, 257))
    idx = _random_indices(rng, h, w, n)
    pal = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    off = (int(rng.integers(0, 6)), int(rng.integers(0, 6))) if rng.random() < 0.4 else (0, 0)
    screen = (w + off[0] + int(rng.integers(-3, 4)), h + off[1] + int(rng.integers(-3, 4)))
    screen = (max(screen[0], 1), max(screen[1], 1))
    trns = int(rng.integers(0, n)) if rng.random() < 0.4 else None
    local = rng.integers(0, 256, (n, 3)).astype(np.uint8) if rng.random() < 0.3 else None
    glob = None if (local is not None and rng.random() < 0.5) else pal
    min_size = max(int(idx.max()).bit_length(), int(rng.integers(2, 9)))
    rows = idx[FX.interlace_rows(h)] if (inter := bool(rng.random() < 0.4)) else idx
    lzw = FX.gif_lzw(rows, min_size, clear_when_full=bool(rng.random() < 0.5))
    return FX.gif_file(idx, glob, screen=screen, offset=off, local=local, transparency=trns, interlace=inter,
                       min_size=min_size, lzw=lzw)


def random_bmp(rng) -> bytes:
    h, w = int(rng.integers(1, 30)), int(rng.integers(1, 30))
    bits = int(rng.choice([1, 4, 8, 16, 24, 32]))
    header = int(rng.choice([12, 40, 52, 56, 64, 108, 124])) if bits != 16 else int(rng.choice([40, 56, 124]))
    dib, top = bool(rng.random() < 0.3), bool(rng.random() < 0.3) and header != 12
    if bits <= 8:
        n = int(rng.integers(2, (1 << bits) + 1))
        idx = _random_indices(rng, h, w, n)
        pal = rng.integers(0, 256, (n, 3)).astype(np.uint8)
        if rng.random() < 0.15:
            pal = np.repeat(np.arange(n, dtype=np.uint8)[:, None], 3, 1) if n > 2 else np.array([[0] * 3, [255] * 3])
        if bits in (4, 8) and header != 12 and rng.random() < 0.5:
            data = FX.rle_encode(idx, four=bits == 4, top_down=top, absolute=bool(rng.random() < 0.7))
            return FX.bmp_file(data, w, h, bits, header=header, palette=pal, compression=2 if bits == 4 else 1,
                               top_down=top, dib=dib)
        return FX.bmp_file(FX.bmp_rows(idx, bits, top), w, h, bits, header=header, palette=pal, top_down=top,
                           dib=dib)
    px = rng.integers(0, 256, (h, w, bits // 8))
    masks, comp = None, 0
    if header != 12 and rng.random() < 0.5:
        comp = 3
        masks = {16: [(0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)], 24: [(0xFF0000, 0xFF00, 0xFF)],
                 32: [(0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                      (0xFF0000, 0xFF00, 0xFF, 0xFF000000), (0xFF, 0xFF00, 0xFF0000, 0xFF000000)]}[bits]
        masks = masks[int(rng.integers(len(masks)))]
    return FX.bmp_file(FX.bmp_rows(px, bits, top), w, h, bits, header=header, compression=comp, masks=masks,
                       top_down=top, dib=dib)


def random_tiff(rng) -> bytes:
    keys = [k for k, (m, _) in ttiff.OPEN_INFO.items() if m != "LAB"]
    order_mark, photo, sf, fill, bps, extra = keys[int(rng.integers(len(keys)))]
    h, w = int(rng.integers(1, 30)), int(rng.integers(1, 30))
    spp, bits = len(bps), bps[0]
    if sf == (3,):
        samples = rng.normal(100, 150, (h, w, spp)).astype(np.float32)
    elif sf == (2,):
        samples = rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), (h, w, spp))
    else:
        samples = rng.integers(0, 1 << bits, (h, w, spp))
    comp = int(rng.choice([1, 5, 8, 32946, 32773, 34925, 50000]))
    if fill == 2 and comp != 1 and (order_mark, photo, sf, 1, bps, extra) not in ttiff.OPEN_INFO:
        comp = 1
    pred = 1
    if comp in (5, 8, 32946, 34925, 50000) and rng.random() < 0.5:
        pred = 3 if sf == (3,) else 2 if bits in (8, 16, 32) else 1
    tile = None
    rps = int(rng.integers(1, h + 2))
    if rng.random() < 0.35:
        tile = (16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))
    cmap = rng.integers(0, 65536, (1 << bits, 3)) if photo == 3 else None
    # planar palette files with an extra sample are left out: PIL unpacks
    # them with the two-byte PX rawmode from one plane's rows, reading past
    # its tile buffer, and the port refuses them (ROADMAP Queue 3, fault 14;
    # pinned in test_torch_port_tiff_codecs.py)
    planar = 1 if (photo == 3 and extra) else int(rng.choice([1, 1, 2]))
    return FX.tiff_image(samples, photometric=photo, bits=bits, sample_format=sf[0], compression=comp,
                         predictor=pred, rows_per_strip=rps, tile=tile, planar=planar,
                         order="<" if order_mark == b"II" else ">", big=bool(rng.random() < 0.2), fill_order=fill,
                         extra=extra, colormap=cmap, old_lzw=bool(rng.random() < 0.2),
                         orientation=int(rng.integers(1, 9)) if rng.random() < 0.2 else None)


RANDOM = {"gif": random_gif, "bmp": random_bmp, "tiff": random_tiff}


def _same_as_pil(data: bytes, damaged: bool) -> None:
    """PIL's pixels, or a refusal where PIL refuses; where PIL reads a
    ``damaged`` file, also a refusal naming ROADMAP item 13c (damage a
    library decoder reads on past). Every form of the random writers is
    read, so an undamaged file PIL reads must be read."""
    try:
        mode, want = _pil_rgb(data)
    except Exception:  # noqa: BLE001 - PIL refuses: so must the port
        with pytest.raises(ValueError):
            decode_image(data)
        return
    try:
        got = decode_image(data)
    except ValueError as exc:
        assert damaged and "ROADMAP item 13c" in str(exc), str(exc)
        return
    np.testing.assert_array_equal(got, want)


@settings(max_examples=40, deadline=None, derandomize=True, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**32 - 1))
@pytest.mark.parametrize("form", sorted(RANDOM))
def test_random_files_decode_as_pil(form, seed):
    """Files of random size, palette, depth, header, compression, layout and
    byte order from the fixture writers decode as PIL decodes them (or are
    refused where PIL refuses them)."""
    _same_as_pil(RANDOM[form](np.random.default_rng(seed)), damaged=False)


@settings(max_examples=60, deadline=None, derandomize=True, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**32 - 1))
def test_damaged_fixtures_decode_as_pil(seed):
    """A fixture with one to three bytes changed, one bit flipped or its
    tail cut: PIL's pixels where PIL reads it, a refusal where it
    refuses."""
    rng = np.random.default_rng(seed)
    data = bytearray(_fixture(READ[int(rng.integers(len(READ)))]))
    kind = int(rng.integers(0, 3))
    if kind == 0:
        for _ in range(int(rng.integers(1, 4))):
            data[int(rng.integers(len(data)))] = int(rng.integers(256))
    elif kind == 1:
        data[int(rng.integers(len(data)))] ^= 1 << int(rng.integers(8))
    else:
        data = data[:int(rng.integers(1, len(data)))]
    _same_as_pil(bytes(data), damaged=True)


# ------------------------------------------------- the card's host, no PIL


READ_WITHOUT_PIL = """
import hashlib, sys
sys.modules.update(PIL=None, jax=None, flax=None, mvd_tpu=None)
from mvd_tpu_torch.utils.images import decode_image
for name in sys.argv[2:]:
    data = open(sys.argv[1] + "/" + name, "rb").read()
    rgb = decode_image(data)
    comp = decode_image(data, composite_alpha=True)
    print(name, hashlib.sha256(rgb.tobytes()).hexdigest(), hashlib.sha256(comp.tobytes()).hexdigest())
"""


def test_formats_read_without_pil():
    """In a process where PIL, JAX and the JAX package cannot be imported
    (the card's host): every fixture decodes to PIL's digests."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", READ_WITHOUT_PIL, str(FIXTURES), *READ], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = {line.split(" ", 1)[0]: line.split()[1:] for line in proc.stdout.strip().splitlines()}
    for name in READ:
        want = DIGESTS[name]
        assert lines[name] == [want["sha256"], want.get("composite_sha256", want["sha256"])], name


def test_chip_sources_writer_is_held_to_pil():
    """``frame_formats`` (``chip_smoke.py`` phase 9d's PIL-free writer) on a
    small frame and render: PIL reads each file to the pixels it was written
    from, and the port's decode is PIL's bitwise."""
    rng = np.random.default_rng(7)
    frame = rng.integers(0, 256, (37, 45, 3)).astype(np.uint8)
    frame[:, :20] = frame[:, :1]
    render = np.dstack([frame[:32, :32], np.full((32, 32), 255, np.uint8)])
    forms = FX.frame_formats(frame, render)
    assert len(forms) == 6
    for form, (data, pixels) in forms.items():
        mode, want = _pil_rgb(data)
        np.testing.assert_array_equal(want, pixels, err_msg=form)
        np.testing.assert_array_equal(decode_image(data), want, err_msg=form)
