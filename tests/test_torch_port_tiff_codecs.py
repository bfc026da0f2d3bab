"""The TIFF forms PIL 12.1.0 reads through libtiff 4.7.1 with decoders the
port already has, APNG's first frame, and faults 13 and 14 of ROADMAP
Queue 3 (``utils/tiff.py``, ``utils/tiff_codecs.py``, ``utils/images.py``:
``pil_mapped``, ``decode_bmp``; ``csrc/jpeg_decode.cpp``,
``csrc/zstd_decode.cpp``).

Bars: a TIFF or BMP that ``Image.open(path)`` memory-maps reads through
the port's ``load_image(path)`` to the JAX ``load_image(path)`` value for
value, and through its bytes to PIL's ``BytesIO`` read, in every mapped
mode, orientation and layout (fault 13); over every image fixture, PIL's
path and bytes reads differ only in that class, and the port's path and
bytes decodes are PIL's; a planar tiled palette TIFF with an extra sample,
whose pixels PIL reads past its buffer, is refused naming fault 14; WebP
in TIFF is refused as PIL refuses it; JPEG (7), old-style JPEG (6), YCbCr
through libtiff's RGBA path, zstd, LZMA and files without byte counts
decode as PIL decodes them on seeded random files (or are refused where
PIL refuses, or named ROADMAP item 13c); libtiff's YCbCr tables are
PIL's on every (Cb, Cr) at eight luma values; an APNG decodes to PIL's
first frame in generation's and the loaders' modes, and the PIL-free APNG
and 9d writers are held to PIL. The fixtures themselves are held by
``tests/test_torch_port_formats.py`` (every file of
``formats_sha256.json``, this PR's included).
"""

import base64
import builtins
import hashlib
import importlib.util
import io
import json
import os
import pathlib
import warnings

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from mvd_tpu.cli import serve as jserve
from mvd_tpu.data import objaverse as jobj
from mvd_tpu.utils import images as jimages
from mvd_tpu_torch.cli import serve as tserve
from mvd_tpu_torch.data import objaverse as tobj
from mvd_tpu_torch.utils import lcms, tiff_codecs
from mvd_tpu_torch.utils import tiff as ttiff
from mvd_tpu_torch.utils.images import decode_image, load_image

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "torch_port_images"
CODECS = json.loads((FIXTURES / "codecs_sha256.json").read_text())


def _make_formats():
    spec = importlib.util.spec_from_file_location("torch_port_formats_fixtures", FIXTURES / "make_formats.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FX = _make_formats()


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _pil(src, mode: str = "RGB"):
    """PIL's ``convert(mode)`` of a path or bytes, or the exception's type."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            im = Image.open(src if isinstance(src, str) else io.BytesIO(src))
            return np.asarray(im.convert(mode))
    except Exception as exc:  # noqa: BLE001 - PIL's refusal is the result
        return type(exc).__name__


def _port(data: bytes, from_path: bool = False):
    try:
        return decode_image(data, from_path=from_path)
    except ValueError as exc:
        return f"ValueError: {exc}"


def _same(want, got) -> bool:
    """Both refused, or both the same pixels."""
    if isinstance(want, str) or isinstance(got, str):
        return isinstance(want, str) and isinstance(got, str)
    return want.shape == got.shape and np.array_equal(want, got)


# ---------------------------------------------------------------- fault 13

MAPPED = {  # mode -> (photometric, bits, samples, extra, byte order)
    "L": (1, 8, 1, (), "<"), "P": (3, 8, 1, (), "<"), "RGBA": (2, 8, 4, (2,), "<"), "CMYK": (5, 8, 4, (), "<"),
    "I;16": (1, 16, 1, (), "<")}
LAYOUTS = {"one strip": {}, "two strips": {"rows_per_strip": 3}, "one tile": {"tile": (16, 16)},
           "LZW": {"compression": 5}, "one strip, cut": {"ifd_first": True}}


def _mapped_tiff(mode: str, layout: str, orientation: int, rng) -> bytes:
    photo, bits, spp, extra, order = MAPPED[mode]
    samples = rng.integers(0, 1 << bits, (5, 7, spp))
    cmap = rng.integers(0, 65536, (256, 3)) if photo == 3 else None
    data = FX.tiff_image(samples, photometric=photo, bits=bits, extra=extra, order=order, colormap=cmap,
                         orientation=orientation, **LAYOUTS[layout])
    # the cut file ends 3 bytes into its strip's last row (its IFD first)
    return data[:-(7 * spp * bits // 8) + 3] if layout.endswith("cut") else data


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("mode", sorted(MAPPED))
def test_fault13_path_read_is_the_jax_load_image(tmp_path, mode, layout):
    """A 5x7 TIFF of each mode ``Image.open(path)`` can map, at each EXIF
    orientation 1-8, in one strip (mapped: at 5-8 PIL maps the strip at
    the turned size, then turns it), two strips, one tile, LZW (decoded and
    turned) and one strip cut short (refused by both): the port's
    ``load_image(path)`` is the JAX ``load_image(path)`` value for value,
    or both refuse; the port's bytes decode is PIL's ``BytesIO`` read."""
    rng = np.random.default_rng(sum(map(ord, mode + layout)))
    path = tmp_path / "image.tif"
    differ = 0
    for orientation in range(1, 9):
        data = _mapped_tiff(mode, layout, orientation, rng)
        path.write_bytes(data)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                want = jimages.load_image(str(path))
        except Exception:  # noqa: BLE001 - PIL refuses the path: so must the port
            with pytest.raises(ValueError):
                load_image(str(path))
        else:
            np.testing.assert_array_equal(load_image(str(path)), want, err_msg=f"orientation {orientation}")
        bytes_want = _pil(data)
        assert _same(bytes_want, _port(data)), orientation
        differ += not _same(_pil(str(path)), bytes_want)
    # the mapped class: a one-strip or one-tile raw file at orientations 5-8
    assert differ == (4 if layout in ("one strip", "one tile") else 0)


def _mapped_class(name: str, data: bytes) -> bool:
    """Whether PIL maps the file's pixels when it opens it by path and the
    map gives other pixels than its decoder (ROADMAP Queue 3, fault 13): a
    raw, not square TIFF of one strip or tile in a mode PIL maps, at
    orientation 5-8; or a BMP whose rows (of its mode, a gray ramp's L)
    are longer than its stride. One more class is no map: an 8-bit
    one-plane PCX shorter than its 769-byte palette, whose seek before the
    start PIL's ``BytesIO`` stops at 0 and a file opened by path refuses."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        im = Image.open(io.BytesIO(data))
    if name.endswith((".tif", ".tiff")):
        ifd = ttiff.Ifd(data)
        offsets = ifd.get(ttiff.STRIP_OFFSETS) or ifd.get(ttiff.TILE_OFFSETS) or ()
        return (ifd.get(ttiff.COMPRESSION, 1) == 1 and ifd.get(ttiff.ORIENTATION) in (5, 6, 7, 8)
                and len(offsets) == 1 and ifd.get(ttiff.WIDTH) != ifd.get(ttiff.LENGTH)
                and im.mode in ("L", "P", "RGBA", "CMYK", "I;16", "I;16B"))
    if name.endswith((".bmp", ".dib")):
        rawmode, stride = im.tile[0].args[:2]
        return im.tile[0].codec_name == "raw" and rawmode == im.mode == "L" and im.size[0] > stride
    if name.endswith(".pcx"):
        return data[1] == 5 and data[3] == 8 and data[65] == 1 and len(data) < 769
    return False


def test_path_and_bytes_differ_only_in_the_fault13_class(tmp_path):
    """Every image fixture (JPEG, PNG, WebP, GIF, BMP/DIB, TIFF) through
    PIL by path and by ``BytesIO``: the reads differ only on files of the
    fault-13 class, each of which the sweep finds; and the port's path
    decode is PIL's path read, its bytes decode PIL's bytes read, on every
    file."""
    names = sorted(n for n in os.listdir(FIXTURES) if not n.endswith((".py", ".json")))
    found = []
    for name in names:
        data = (FIXTURES / name).read_bytes()
        path = tmp_path / name
        path.write_bytes(data)
        by_path, by_bytes = _pil(str(path)), _pil(data)
        if name.startswith("notread_"):
            # PIL reads it (a JPEG strip shorter than its segment from memory
            # libtiff leaves unwritten: not the same twice); the port names
            # ROADMAP item 13c
            assert isinstance(by_path, np.ndarray) and "ROADMAP item 13c" in _port(data, from_path=True), name
            continue
        if not _same(by_path, by_bytes):
            assert _mapped_class(name, data), name
            found.append(name)
        assert _same(by_path, _port(data, from_path=True)), name
        assert _same(by_bytes, _port(data)), name
    assert {"bad_bmp_4bit_gray_ramp_wide.bmp", "tif_orientation6_raw_l.tif",
            "tif_orientation8_raw_rgba.tif"} <= set(found), found


def test_fault13_bmp_class_is_the_jax_load_image(tmp_path):
    """A 4-bit BMP whose palette is the gray ramp is mode L, read a byte a
    pixel at the 4-bit stride: by bytes PIL's decoder refuses the stride,
    by path PIL maps the rows (overlapping, the last reaching past the
    pixel data into the page's zeros); the port's ``load_image(path)`` is
    the JAX one's and its bytes decode is refused."""
    data = (FIXTURES / "bad_bmp_4bit_gray_ramp_wide.bmp").read_bytes()
    path = tmp_path / "ramp.bmp"
    path.write_bytes(data)
    np.testing.assert_array_equal(load_image(str(path)), jimages.load_image(str(path)))
    np.testing.assert_array_equal(load_image(str(path), 8), jimages.load_image(str(path), 8))
    with pytest.raises(ValueError):
        decode_image(data)


# ---------------------------------------------------------------- fault 14


@pytest.mark.parametrize("compression", [5, 8, 32773, 50000])
def test_fault14_pil_reads_past_its_buffer_the_port_refuses(compression):
    """A compressed, planar, tiled palette TIFF with an extra sample: PIL
    unpacks each tile with the two-byte PX rawmode from one plane's rows
    and reads past its tile buffer, so it returns pixels (here checked on
    three reads) where the port raises ``ValueError`` naming fault 14."""
    rng = np.random.default_rng(compression)
    samples = np.dstack([rng.integers(0, 256, (20, 20)), rng.integers(0, 256, (20, 20))])
    data = FX.tiff_image(samples, photometric=3, bits=8, extra=(0,), planar=2, compression=compression,
                         tile=(16, 16), colormap=rng.integers(0, 65536, (256, 3)))
    reads = [_pil(data) for _ in range(3)]
    assert all(isinstance(r, np.ndarray) and r.shape == (20, 20, 3) for r in reads)
    with pytest.raises(ValueError, match="fault 14"):
        decode_image(data)


# ------------------------------------------------------- refusals kept


def test_webp_in_tiff_is_refused_as_pil_refuses():
    """WebP in TIFF (50001): PIL's libtiff has no WebP codec and raises;
    the port refuses it saying so, not naming it a form PIL reads."""
    data = (FIXTURES / "bad_tif_webp.tif").read_bytes()
    assert isinstance(_pil(data), str)
    with pytest.raises(ValueError, match="PIL refuses it too") as exc:
        decode_image(data)
    assert "13c" not in str(exc.value)


@pytest.mark.parametrize("name,form", [("notread_tif_group4.tif", "compression 4"),
                                       ("notread_tif_ojpeg_tables_in_tags.tif", "tags 519-521"),
                                       ("notread_tif_ycbcr_planar.tif", "planar YCbCr"),
                                       ("notread_tif_jpeg_short_strip.tif", "JPEG in a")])
def test_forms_still_queued_name_the_form_and_13c(name, form):
    """What PIL reads and the port still does not (CCITT, old-style JPEG
    with its tables in tags 519-521, planar YCbCr, a JPEG strip shorter
    than its segment, whose rest libtiff leaves unwritten) raises
    ``ValueError`` naming the form and ROADMAP item 13c, through no other
    decoder."""
    data = (FIXTURES / name).read_bytes()
    assert isinstance(_pil(data), np.ndarray)
    with pytest.raises(ValueError, match=f"{form}.*ROADMAP item 13c"):
        decode_image(data)


def test_lzma_without_pythons_module_names_it(monkeypatch):
    """A Python built without liblzma: an LZMA TIFF raises ``ValueError``
    naming the missing module; nothing steps around it."""
    real = builtins.__import__

    def no_lzma(name, *args, **kwargs):
        if name == "lzma":
            raise ImportError("No module named '_lzma'")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_lzma)
    with pytest.raises(ValueError, match="lzma module.*_lzma"):
        decode_image((FIXTURES / "tif_pil_lzma_rgb.tif").read_bytes())


# ------------------------------------------------------------- YCbCr


@pytest.mark.parametrize("tags", ["defaults", "Rec. 709 coefficients, studio range"])
def test_ycbcr_tables_are_libtiffs(tags):
    """``TIFFYCbCrToRGBInit``'s tables against PIL's RGBA path: every (Cb,
    Cr) pair at eight luma values, 1 x 1 subsampling under LZW, with the
    default coefficients and references and with Rec. 709's and studio
    range's (RATIONAL tags)."""
    v = np.arange(256, dtype=np.uint8)
    cb, cr = np.meshgrid(v, v, indexing="ij")
    ycc = np.stack([np.broadcast_to(np.uint8(y), cb.shape) for y in (0, 16, 50, 100, 128, 180, 235, 255)])
    ycc = np.stack([ycc, np.broadcast_to(cb, ycc.shape), np.broadcast_to(cr, ycc.shape)], -1).reshape(-1, 256, 3)
    extra = {} if tags == "defaults" else {529: (5, [2126, 10000, 7152, 10000, 722, 10000]),
                                           532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])}
    data = FX.ycbcr_tiff(ycc, sub=(1, 1), compression=5, tags=extra, rows_per_strip=512)
    np.testing.assert_array_equal(decode_image(data), _pil(data))


@pytest.mark.parametrize("predictor", [1, 2])
@pytest.mark.parametrize("layout", ["strips", "tiles"])
@pytest.mark.parametrize("compression", [5, 8, 32773, 34925, 50000])
def test_ycbcr_short_segments_are_read_on_as_libtiff(compression, layout, predictor):
    """4:2:0 YCbCr whose second and fourth strips or tiles are coded from
    100 of their 384 bytes: libtiff's RGBA path reads on past each (the
    bytes decoded, zeros after them, the predictor not undone), PIL gives
    those pixels, and so does the port."""
    rng = np.random.default_rng(compression + predictor)
    full = [rng.integers(0, 256, 384, dtype=np.uint8).tobytes() for _ in range(4)]
    segments = [FX._compress(raw[:100] if i % 2 else raw, compression) for i, raw in enumerate(full)]
    tags = {256: (4, [32]), 257: (4, [32]), 258: (3, [8, 8, 8]), 259: (3, [compression]), 262: (3, [6]),
            277: (3, [3]), 284: (3, [1]), 317: (3, [predictor]), 530: (3, [2, 2])}
    tags.update({322: (3, [16]), 323: (3, [16])} if layout == "tiles" else {278: (4, [8])})
    data = FX.tiff_file(tags, segments, tiled=layout == "tiles")
    want = _pil(data)
    assert isinstance(want, np.ndarray), want
    np.testing.assert_array_equal(decode_image(data), want)


# -------------------------------------------------------------- LAB


@pytest.mark.parametrize("lightness", [0, 1, 37, 100, 128, 200, 254, 255])
def test_lab_to_rgb_is_pils_littlecms(lightness):
    """``utils/lcms.py``'s Lab -> sRGB (LittleCMS 2.17's resampled table and
    tetrahedral interpolation, as PIL's ``convert("RGB")`` runs it) on every
    (a, b) pair at eight lightnesses: PIL's pixels (all 2^24 inputs were
    measured equal in scratch)."""
    v = np.arange(256, dtype=np.uint8)
    a, b = np.meshgrid(v, v, indexing="ij")
    stored = np.stack([np.full_like(a, lightness), a, b], -1)
    im = Image.frombytes("LAB", (256, 256), (stored ^ np.array([0, 128, 128], np.uint8)).tobytes())
    np.testing.assert_array_equal(lcms.lab_to_rgb(stored), np.asarray(im.convert("RGB")))


@pytest.mark.parametrize("rawmode", ["LAB", "L", "A", "B"])
def test_lab_unpackers_are_pils(rawmode):
    """PIL's unpackers into LAB: the contiguous one offsets a and b by 128,
    a planar file's band copies do not; the port's hold the bytes PIL
    holds (``tobytes`` of LAB packs them back, so PIL's storage is read
    with the offset taken again)."""
    rng = np.random.default_rng(len(rawmode))
    n = 37
    data = rng.integers(0, 256, n * (3 if rawmode == "LAB" else 1)).astype(np.uint8).tobytes()
    stored = np.asarray(Image.frombytes("LAB", (n, 1), data, "raw", rawmode))[0] ^ np.array([0, 128, 128], np.uint8)
    got = ttiff.unpack("LAB", rawmode, data, n).reshape(n, 4)[:, :3]
    if rawmode != "LAB":  # a band copy leaves the other bands as they were: zero here and in PIL's new image
        band = "LAB".index(rawmode)
        np.testing.assert_array_equal(got[:, band], stored[:, band])
    else:
        np.testing.assert_array_equal(got, stored)


# ------------------------------------------------------------- APNG


@pytest.mark.parametrize("name", sorted(CODECS["apng"]))
def test_apng_is_pils_first_frame(tmp_path, name):
    """An APNG whose default image is its first frame, and one whose
    default image is outside the animation (no fcTL before IDAT): PIL opens
    several frames, and the port's decode is PIL's first frame with no seek
    (RGBA: ``convert("RGB")`` and the loaders' white composite), by the
    stored digests too; ``load_image``, the server's decode and the
    Objaverse loader's are the JAX functions."""
    data = (FIXTURES / name).read_bytes()
    want = CODECS["apng"][name]
    with Image.open(io.BytesIO(data)) as im:
        assert im.n_frames > 1 and im.mode == want["mode"] == "RGBA"
    got = decode_image(data)
    np.testing.assert_array_equal(got, _pil(data))
    assert _sha(got) == want["sha256"] and _sha(decode_image(data, composite_alpha=True)) == want["composite_sha256"]
    path = tmp_path / name
    path.write_bytes(data)
    np.testing.assert_array_equal(load_image(str(path), 8), jimages.load_image(str(path), 8))
    b64 = base64.b64encode(data).decode()
    np.testing.assert_array_equal(tserve._b64_png(b64, 8), jserve._b64_png(b64, 8))
    np.testing.assert_array_equal(tobj._load_image_from_bytes(data, 8), jobj._load_image_from_bytes(data, 8))


def test_apng_writer_is_held_to_pil():
    """``apng_file`` (phase 9d's PIL-free writer): PIL reads each file's
    default image as the frame written for it, in both layouts."""
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (6, 9, 4)).astype(np.uint8) for _ in range(2)]
    default = rng.integers(0, 256, (6, 9, 4)).astype(np.uint8)
    for data, first in ((FX.apng_file(frames), frames[0]),
                        (FX.apng_file(frames, default_in_animation=False, default=default), default)):
        np.testing.assert_array_equal(_pil(data, "RGBA"), first)
        np.testing.assert_array_equal(decode_image(data), first[..., :3])


# --------------------------------------------------------- random files


def _jpeg(pixels: np.ndarray, quality: int, **options) -> bytes:
    mode = "CMYK" if pixels.ndim == 3 and pixels.shape[2] == 4 else None
    buf = io.BytesIO()
    Image.fromarray(pixels.astype(np.uint8), mode).save(buf, "JPEG", quality=quality, **options)
    return buf.getvalue()


def random_codec_tiff(rng) -> bytes:
    """A random file of this slice's forms: JPEG (7) in YCbCr (1 x 1, 2 x
    1, 2 x 2; the tag present, absent or wrong), RGB, gray or CMYK, strips
    (a full last strip or not) or tiles, abbreviated streams or whole; an
    old-style JPEG; YCbCr through the RGBA path (each subsampling libtiff
    has a routine for, and one it has not; every codec; coefficients and
    references; predictor 2); zstd or LZMA; a file without byte counts."""
    h, w = int(rng.integers(1, 41)), int(rng.integers(1, 41))
    kind = int(rng.integers(0, 4))
    order = "<" if rng.random() < 0.8 else ">"
    quality = int(rng.integers(30, 96))
    if kind == 0:
        photo = int(rng.choice([6, 6, 2, 1, 5]))
        spp = {6: 3, 2: 3, 1: 1, 5: 4}[photo]
        pixels = rng.integers(0, 256, (h, w, spp) if spp > 1 else (h, w))
        ss = int(rng.integers(0, 3)) if spp == 3 else None
        tile = (16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3))) if rng.random() < 0.35 else None
        rps = int(rng.integers(1, h + 3))
        opts = {} if ss is None else {"subsampling": ss}
        parts = [_jpeg(p, quality, **opts) for p in FX.tiles_of(pixels, tile, rps, bool(rng.random() < 0.3))]
        tables = None
        if rng.random() < 0.5:
            tables, parts = FX.abbreviate(parts)
        sub = None
        if photo == 6 and rng.random() < 0.7:
            sub = [(1, 1), (2, 1), (2, 2)][ss] if rng.random() < 0.85 else (2, 2)
        return FX.jpeg_tiff(parts, w, h, photometric=photo, spp=spp, rows_per_strip=None if tile else rps, tile=tile,
                            tables=tables, subsampling=sub, order=order, counts=bool(rng.random() < 0.9))
    if kind == 1:
        pixels = rng.integers(0, 256, (h, w, 3))
        ref = {532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])} if rng.random() < 0.3 else None
        return FX.ojpeg_tiff(_jpeg(pixels, quality, subsampling=int(rng.integers(0, 3))), w, h,
                             strip_at_jif=bool(rng.random() < 0.3),
                             photometric=[6, 2, None][int(rng.integers(0, 3))], jif_length=bool(rng.random() < 0.8),
                             tags=ref)
    if kind == 2:
        subs = sorted(tiff_codecs.PUT_CASES) + [(2, 4)]
        sub = subs[int(rng.integers(len(subs)))]
        comp = int(rng.choice([5, 8, 32773, 32946, 34925, 50000]))
        lay = {}
        if rng.random() < 0.35:
            lay["tile"] = (16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))
        elif rng.random() < 0.5:
            lay["rows_per_strip"] = sub[1] * int(rng.integers(1, 5))
        tags = {}
        if rng.random() < 0.3:
            tags[529] = (5, [int(v) for v in rng.integers(1, 10000, 3) for v in (v, 10000)])
        if rng.random() < 0.3:
            lo, hi = int(rng.integers(0, 40)), int(rng.integers(200, 256))
            tags[532] = (5, [lo, 1, hi, 1, 128, 1, hi, 1, 128, 1, hi, 1])
        if rng.random() < 0.2 and comp in (5, 8, 32946, 34925, 50000):
            tags[317] = (3, [2])
        if rng.random() < 0.2:
            tags[274] = (3, [int(rng.integers(1, 9))])
        return FX.ycbcr_tiff(rng.integers(0, 256, (h, w, 3)), sub=sub, compression=comp, tags=tags, order=order,
                             **lay)
    comp = int(rng.choice([5, 8, 34925, 50000]))
    lay = {"tile": (16, 16)} if rng.random() < 0.3 else {"rows_per_strip": int(rng.integers(1, h + 3))}
    return FX.tiff_image(rng.integers(0, 256, (h, w, 3)), photometric=2, bits=8, compression=comp, order=order,
                         predictor=2 if rng.random() < 0.3 else 1, counts=bool(rng.random() < 0.5),
                         planar=int(rng.choice([1, 2])), ifd_first=bool(rng.random() < 0.5), **lay)


@settings(max_examples=300, deadline=None, derandomize=True, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**32 - 1))
def test_random_codec_files_decode_as_pil(seed):
    """Random files of this slice's forms (``random_codec_tiff``): PIL's
    pixels, or a refusal where PIL refuses. The files are undamaged and
    every form they take is read, so no refusal naming ROADMAP item 13c
    (damage libjpeg, libzstd or liblzma would read on past, or a queued
    form) is allowed where PIL reads the file."""
    data = random_codec_tiff(np.random.default_rng(seed))
    want, got = _pil(data), _port(data)
    if isinstance(want, str):
        assert isinstance(got, str), "PIL refuses the file and the port reads it"
    else:
        assert not isinstance(got, str), f"PIL reads the file and the port refuses it: {got}"
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------ the card's 9d sources


def test_chip_codec_sources_are_pil(tmp_path):
    """``frame_codec_forms`` (phase 9d's PIL-free writer of this slice's
    sources) on a small frame and render: the port's bytes decode of each
    is PIL's, its path decode of the fault-13 TIFF PIL's path read; the
    stored digests name every 9d form, and the committed zstd frame (the
    card's zstd source, in compressed blocks) decodes to its digest."""
    rng = np.random.default_rng(11)
    frame = rng.integers(0, 256, (37, 45, 3)).astype(np.uint8)
    frame[:, :20] = frame[:, :1]
    render = np.dstack([frame[:32, :32], rng.integers(0, 256, (32, 32))]).astype(np.uint8)
    forms = FX.frame_codec_forms(frame, render)
    assert set(forms) | {FX.ZSTD_FORM} == set(CODECS["frames"])
    for form, data in forms.items():
        want = _pil(data)
        assert isinstance(want, np.ndarray), form
        np.testing.assert_array_equal(decode_image(data), want, err_msg=form)
    # the card's zstd source: CO3D's frame in compressed blocks, PIL's digest
    zstd = (FIXTURES / FX.ZSTD_FRAME).read_bytes()
    assert _sha(decode_image(zstd)) == CODECS["frames"][FX.ZSTD_FORM]["sha256"]
    data = forms["fault-13 TIFF (raw RGBA, orientation 6)"]
    assert "path_sha256" in CODECS["frames"]["fault-13 TIFF (raw RGBA, orientation 6)"]
    path = tmp_path / "fault13.tif"
    path.write_bytes(data)
    np.testing.assert_array_equal(decode_image(data, from_path=True), _pil(str(path)))
