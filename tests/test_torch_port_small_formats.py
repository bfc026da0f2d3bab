"""The port's readers of PIL's small image formats (``utils/small_formats.py``,
``csrc/small_decode.cpp``, ``csrc/bcn_decode.cpp``) and its plugin order,
against PIL 12.1.0: PPM/PGM/PBM/PFM, TGA, ICO/CUR, QOI, PCX, SGI, PSD and
DDS with BC1-BC7.

Bars: every fixture (``tests/fixtures/torch_port_images``, written by
``make_small_formats.py`` there) decodes through ``decode_image`` bitwise to
``np.asarray(Image.open(...).convert("RGB"))``, in PIL's mode, and to the
stored digests; ``composite_alpha`` composites exactly the files PIL opens
as RGBA; what PIL refuses is refused, and the formats PIL reads and the port
does not name ROADMAP item 13c; seeded random files of each format, and
random BCn blocks of every BC6H and BC7 mode and partition, decode as PIL
decodes them; the plugin table is ``Image.ID``'s order, a TGA whose first
bytes are CUR's magic is read as TGA, and a plugin whose ``_open`` raises
another error than a give-way one ends the search; ``load_image`` (by
path), the server's upload decode and the Objaverse loader's decode are the
JAX functions value for value, and a one-thread loader batch of TGA, DDS
and PSD views is the JAX loader's; the fixtures decode to PIL's digests in
a process that cannot import PIL, JAX or the JAX package; ``chip_smoke.py``
phase 9d's PIL-free sources decode in PIL as in the port.
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
import zipfile
import zlib

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
from mvd_tpu_torch.utils import small_formats as sf
from mvd_tpu_torch.utils.images import PilImage, decode_image, load_image

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "torch_port_images"
ALL = json.loads((FIXTURES / "small_formats_sha256.json").read_text())
DIGESTS, FRAMES = ALL["files"], ALL["frames"]
READ = sorted(n for n in DIGESTS if not n.startswith(("bad_", "notread_")))
BAD = sorted(n for n in DIGESTS if n.startswith("bad_"))
NOT_READ = sorted(n for n in DIGESTS if n.startswith("notread_"))
SIZE = TINY_MODEL.unet.sample_size * 8


def _fixture_script():
    spec = importlib.util.spec_from_file_location("torch_port_small_formats", FIXTURES / "make_small_formats.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FX = _fixture_script()


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _fixture(name: str) -> bytes:
    return (FIXTURES / name).read_bytes()


def _pil_rgb(data: bytes):
    """PIL's format, mode and ``convert("RGB")``."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        im = Image.open(io.BytesIO(data))
        return im.format, im.mode, np.asarray(im.convert("RGB"))


def _pil_core_mode(data: bytes) -> str:
    """The mode of the image PIL holds after loading (a palette turns an L
    image's core into P while ``im.mode`` stays L)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        im = Image.open(io.BytesIO(data))
        im.load()
        return im.im.mode


def _pil_composite(data: bytes) -> np.ndarray:
    im = Image.open(io.BytesIO(data))
    bg = Image.new("RGBA", im.size, (255, 255, 255, 255))
    return np.asarray(Image.alpha_composite(bg, im).convert("RGB"))


def _port_mode(data: bytes) -> tuple:
    """The plugin the port opens ``data`` with and the mode of its image
    (None where it decodes to RGB directly: a PNG frame of an ICO)."""
    name, opened = sf.identify(data)
    img = opened.load(False)
    return name, img.mode if isinstance(img, PilImage) else None


# -------------------------------------------------------------- fixtures


def test_fixtures_hold_every_form():
    """A fixture of each form the readers cover, and refusals of each
    format."""
    need = ["ppm_p1_plain.pbm", "ppm_p2_plain.pgm", "ppm_p3_plain.ppm", "ppm_p4.pbm", "ppm_p5.pgm", "ppm_p6.ppm",
            "ppm_pil_f.pfm", "ppm_pf_big_endian.pfm", "ppm_p5_65535.pgm", "ppm_p5_maxval1000.pgm",
            "tga_pil_rgb.tga", "tga_pil_p_rle.tga", "tga_pil_l_rle.tga", "tga_rgba_rle_top_right.tga",
            "tga_l_rle_cross_rows.tga", "tga_p_cmap16_start.tga", "tga_rgb16_alpha_bit.tga",
            "ico_pil_png.ico", "ico_bmp_32bit_alpha.ico", "ico_bmp_4bit_mask.ico", "cur_32bit_bgra.cur",
            "cur_two_sizes.cur", "qoi_pil_rgba.qoi", "qoi_unset_index.qoi", "pcx_ega_4planes.pcx",
            "pcx_vga_palette.pcx", "pcx_pil_rgb.pcx", "sgi_rle_rgb16.sgi", "sgi_pil_rgba.sgi",
            "sgi_rle_row_ends_early.sgi", "psd_rgb_rle.psd", "psd_cmyk_raw.psd", "psd_lab_rle.psd", "psd_1_raw.psd",
            "psd_p_rle.psd", "dds_dx10_bc6h.dds", "dds_dx10_bc6hs.dds", "dds_dx10_bc7.dds", "dds_fourcc_bc5s.dds",
            "dds_rgb565.dds", "dds_palette.dds"]
    assert set(need) <= set(READ)
    for prefix in ("ppm", "tga", "ico", "cur", "qoi", "pcx", "sgi", "psd", "dds"):
        assert any(n.startswith(f"bad_{prefix}") for n in BAD), prefix
    assert len(NOT_READ) >= 5


@pytest.mark.parametrize("name", READ)
def test_fixture_is_pil_in_its_mode(name):
    """``decode_image`` is PIL's ``convert("RGB")`` bitwise and matches the
    stored digest; the plugin and the reader's mode are PIL's; with
    ``composite_alpha`` a file PIL opens as RGBA is composited as the JAX
    loader composites it, any other mode is not."""
    data = _fixture(name)
    want = DIGESTS[name]
    fmt, mode, rgb = _pil_rgb(data)
    plugin, got_mode = _port_mode(data)
    assert plugin == fmt and mode == want["mode"] and got_mode in (_pil_core_mode(data), None)
    got = decode_image(data)
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
def test_formats_not_read_name_roadmap_13c(name):
    """SUN, IM, SPIDER, MSP, XBM, BLP: PIL reads them, the port names the
    format PIL opens and ROADMAP item 13c (IM and SPIDER have no signature:
    their headers are read as PIL's ``_open`` reads them)."""
    data = _fixture(name)
    fmt, _, _ = _pil_rgb(data)
    with pytest.raises(ValueError, match=rf"^{fmt}: .*ROADMAP item 13c"):
        decode_image(data)


# --------------------------------------------------------------- dispatch

PIL_ORDER = """
from PIL import Image
Image.preinit()
first = list(Image.ID)
Image.init()
print(" ".join(first + [f for f in Image.ID if f not in first]))
"""


def test_plugin_table_is_image_opens_order():
    """``PLUGINS`` is the order ``Image.open`` tries in a fresh process: the
    plugins ``preinit`` imports, then the rest of ``Image.ID``; the
    signatures are PIL's ``_accept`` on each fixture's first 16 bytes."""
    proc = subprocess.run([sys.executable, "-c", PIL_ORDER], capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert [p.name for p in sf.PLUGINS] == proc.stdout.split()
    Image.init()
    for name in READ + BAD + NOT_READ:
        prefix = _fixture(name)[:16]
        for p in sf.PLUGINS:
            accept = Image.OPEN[p.name][1]
            if accept is None:
                assert p.accept is None
                continue
            assert bool(p.accept(prefix)) == (accept(prefix) is True), (name, p.name)


def test_cur_magic_tga_is_read_as_tga():
    """PIL's uncompressed TGA starts 00 00 02 00, CUR's magic: CUR's
    ``_open`` finds no cursor and gives way, and the file is read as TGA,
    by both."""
    data = _fixture("tga_pil_rgb.tga")
    assert data[:4] == b"\0\0\2\0" and sf.PLUGINS[[p.name for p in sf.PLUGINS].index("CUR")].accept(data[:16])
    assert Image.open(io.BytesIO(data)).format == "TGA" and _port_mode(data)[0] == "TGA"
    np.testing.assert_array_equal(decode_image(data), _pil_rgb(data)[2])


def test_an_open_that_raises_ends_the_search():
    """A DDS whose header size is not 124 raises OSError in PIL's
    ``_open``, which is no give-way: ``Image.open`` raises rather than try
    TGA, which would read the same bytes; the port raises too. A header
    that gives way (PCX of size 0) passes the file on to TGA."""
    tga = _fixture("tga_pil_l.tga")
    dds = b"DDS " + struct.pack("<I", 100) + tga[8:]
    with pytest.raises(OSError):
        Image.open(io.BytesIO(dds))
    with pytest.raises(ValueError, match="DDS: Unsupported header size"):
        decode_image(dds)
    with pytest.raises(ValueError, match="cannot identify image file.*PIL identifies none"):
        decode_image(b"\x0a\x05\x01\x08" + bytes(60))


def test_no_plugin_gives_pils_words():
    """A file every plugin passes on: PIL's "cannot identify image file",
    with each plugin's reason."""
    with pytest.raises(Image.UnidentifiedImageError):
        Image.open(io.BytesIO(b"\x00\x00\x01\x00" + bytes(40)))
    with pytest.raises(ValueError, match=r"cannot identify image file .*ICO: .*TGA: not a TGA file"):
        decode_image(b"\x00\x00\x01\x00" + bytes(40))


# ------------------------------------------------- the JAX package's paths


@pytest.mark.parametrize("name", READ)
def test_load_image_server_and_loader_are_the_jax_functions(tmp_path, name):
    """``load_image`` (``cli.infer``'s source read, by path: PIL memory-maps
    some raw tiles), the server's ``_b64_png`` and the Objaverse
    ``_load_image_from_bytes`` are the JAX functions value for value, at
    the fixture's size and at the model's 64²."""
    data = _fixture(name)
    path = tmp_path / name
    path.write_bytes(data)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            want = jimages.load_image(str(path))
        except OSError:  # PIL refuses the file by path (a short PCX): so does the port
            with pytest.raises(ValueError):
                load_image(str(path))
        else:
            np.testing.assert_array_equal(load_image(str(path)), want)
            np.testing.assert_array_equal(load_image(str(path), SIZE), jimages.load_image(str(path), SIZE))
        b64 = base64.b64encode(data).decode()
        np.testing.assert_array_equal(tserve._b64_png(b64, SIZE), jserve._b64_png(b64, SIZE))
        np.testing.assert_array_equal(tobj._load_image_from_bytes(data, SIZE),
                                      jobj._load_image_from_bytes(data, SIZE))


def test_path_reads_refuse_where_pils_do(tmp_path):
    """Opened by path, PIL maps a raw tile that needs the file's whole last
    row and seeks a PCX palette before a short file's start: where it
    raises, so does ``load_image``; the bytes of the same file read."""
    data = _fixture("pcx_no_palette.pcx")
    path = tmp_path / "short.pcx"
    path.write_bytes(data)
    with pytest.raises(OSError):
        jimages.load_image(str(path))
    with pytest.raises(ValueError, match="PCX: .*by path"):
        load_image(str(path))
    np.testing.assert_array_equal(decode_image(data), _pil_rgb(data)[2])


def test_loader_batch_from_tga_dds_psd_views_is_the_jax_loaders(tmp_path):
    """An Objaverse corpus whose views are TGA, DDS and PSD files (under the
    loader's ``NNN.png`` names: both read by content): every batch of the
    port's one-thread loader is the JAX loader's."""
    root = tmp_path / "corpus"
    (root / "renders_final").mkdir(parents=True)
    names = [n for n in READ if n.startswith(("tga_", "dds_", "psd_"))]
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


# ------------------------------------------------------------ PIL's quirks


def test_ppm_quirks_are_pils():
    """A 16-bit PGM opens as I and clips at 255; maxval 1000 is rescaled to
    I's 0-65535; a plain sample is rounded half to even; PFM's rows run
    bottom-up and ``convert`` truncates."""
    for name in ("ppm_p5_65535.pgm", "ppm_p5_maxval1000.pgm", "ppm_p2_plain_i.pgm"):
        assert _port_mode(_fixture(name))[1] == "I" == _pil_rgb(_fixture(name))[1]
    data = b"P2 4 1 10 1 3 5 7\n"  # 25.5, 76.5, 127.5, 178.5: half to even
    np.testing.assert_array_equal(decode_image(data)[0, :, 0], [26, 76, 128, 178])
    np.testing.assert_array_equal(decode_image(data), _pil_rgb(data)[2])
    pfm = FX.ppm_file(np.array([[1.9, 300.0], [-4.0, np.nan]], np.float32), b"Pf")
    np.testing.assert_array_equal(decode_image(pfm)[..., 0], [[1, 255], [0, 0]])
    np.testing.assert_array_equal(decode_image(pfm), _pil_rgb(pfm)[2])


def test_tga_runs_may_not_cross_rows_literals_may():
    """PIL's TGA RLE: a run past a row's end is a buffer overrun, a literal
    carries on into the next row."""
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, 11, 0, 0, 0, 0, 0, 3, 2, 8, 0x20)
    with pytest.raises(OSError):
        _pil_rgb(head + bytes([0x84, 7, 0x00, 9]))
    with pytest.raises(ValueError, match="crosses a row"):
        decode_image(head + bytes([0x84, 7, 0x00, 9]))
    literal = head + bytes([0x04, 1, 2, 3, 4, 5, 0x00, 9])
    np.testing.assert_array_equal(decode_image(literal)[..., 0], [[1, 2, 3], [4, 5, 9]])
    np.testing.assert_array_equal(decode_image(literal), _pil_rgb(literal)[2])


def test_tga_gray_with_a_colour_map_becomes_p():
    """A gray TGA (type 3) with a colour map: PIL's ``putpalette`` turns the
    L image into P, so ``convert`` looks the samples up."""
    data = _fixture("tga_l_with_cmap.tga")
    _, mode, rgb = _pil_rgb(data)
    assert mode == "L" and _pil_core_mode(data) == "P" == _port_mode(data)[1]
    np.testing.assert_array_equal(decode_image(data), rgb)


def test_ico_frame_is_the_largest():
    """ICO's first entry after PIL's sorts (colour depth, then area
    descending) is the frame ``Image.open`` loads."""
    data = _fixture("ico_largest_of_three.ico")
    assert decode_image(data).shape == (32, 32, 3)
    np.testing.assert_array_equal(decode_image(data), _pil_rgb(data)[2])


def _png(rows: bytes, w: int, h: int, extra: bytes = b"") -> bytes:
    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows)) + extra + chunk(b"IEND", b""))


def _png_cases() -> dict:
    rows = b"".join(b"\0" + bytes(range(10 * y, 10 * y + 5)) for y in range(4))
    png = _png(rows, 5, 4)
    idat = png.index(b"IDAT")
    crc = idat + 4 + struct.unpack(">I", png[idat - 4:idat])[0]
    flip = lambda data, at: data[:at] + bytes([data[at] ^ 1]) + data[at + 1:]  # noqa: E731
    text = struct.pack(">I", 3) + b"tEXt" + b"a\0b"
    return {
        "IDAT's CRC wrong": flip(png, crc), "IEND's CRC wrong": flip(png, len(png) - 1),
        "IEND cut": png[:-3], "Adler-32 cut": png[:crc - 2], "deflate data cut": png[:crc - 6],
        "a tEXt after the image with a wrong CRC": _png(rows, 5, 4, text + b"\0\0\0\0"),
        "a tEXt after the image cut": _png(rows, 5, 4)[:-12] + struct.pack(">I", 99) + b"tEXt" + b"abc",
        "the stream ends at a row": _png(rows[:12], 5, 4),
        "the stream ends inside a row": _png(rows[:9], 5, 4),
        "IHDR's CRC wrong": flip(png, 29),
    }


@pytest.mark.parametrize("case", sorted(_png_cases()))
def test_png_chunks_and_rows_are_read_as_pil_reads(case):
    """ROADMAP Queue 3, fault 16: PIL checks the CRCs of the chunks before
    the image data only, stops at a cut chunk header or IEND after it, and
    inflates rows while input is left, a stream that ends at a row leaving
    the rest zero; ``decode_png`` (an ICO's PNG frame too) reads and
    refuses exactly what PIL does."""
    data = _png_cases()[case]
    _same_as_pil(data, damaged=False)
    icon = FX.icon_file([(5, 4, 0, 32, data)])
    _same_as_pil(icon, damaged=False)


def _idat_png(w: int, h: int, bodies) -> bytes:
    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + b"".join(chunk(b"IDAT", b) for b in bodies) + chunk(b"IEND", b""))


def _png_piece_cases() -> dict:
    """Streams that end at a row before the last: split into two IDAT
    chunks at each of the last 8 bytes (the end in the row's piece or in
    the next), in one chunk a little over PIL's 64 KB block, the Adler-32
    past it, and followed by a whole or a cut IDAT; and a whole image
    followed by a chunk type PIL does not take for one and a cut chunk."""
    rng = np.random.default_rng(16)
    rows = rng.integers(0, 256, (6, 10)).astype(np.uint8)
    rows[:, 0] = 0
    cases = {}
    for level in (0, 6):
        stream = zlib.compress(rows[:3].tobytes(), level)
        for k in range(1, 9):
            cases[f"level {level}, split {k} bytes before the end"] = _idat_png(9, 6, [stream[:-k], stream[-k:]])
    for w, keep in ((401, 163), (406, 161), (808, 81)):
        big = rng.integers(0, 256, (keep, w + 1)).astype(np.uint8)
        big[:, 0] = 0
        stream = zlib.compress(big.tobytes(), 0)
        assert 65536 < len(stream) <= 65540
        cases[f"{len(stream)} bytes in one chunk, {w} wide"] = _idat_png(w, keep + 5, [stream])
    # PIL's load_end reads on from the chunk the rows ended in: a later IDAT
    # cut is its "Truncated File Read"; a type that is no chunk's stops it
    stream = zlib.compress(rows[:3].tobytes())
    later = _idat_png(9, 6, [stream, bytes(20)])
    cases["a later IDAT whole"] = later
    cases["a later IDAT cut"] = later[:-20]
    stop = struct.pack(">I", 0) + b"a b!" + bytes(4)
    cases["a chunk type PIL stops at, then a cut chunk"] = (_png(rows.tobytes(), 9, 6)[:-12] + stop
                                                            + struct.pack(">I", 99) + b"tEXt" + b"abc")
    return cases


@pytest.mark.parametrize("case", sorted(_png_piece_cases()))
def test_png_stream_pieces_are_read_as_pil_reads(case):
    """PIL's ``load`` feeds ZipDecode a chunk at a time, in blocks of at
    most 64 KB: a stream that ends at a row before the last leaves the rest
    zero only where zlib meets its end in the piece that completed the
    row; in a later piece it is truncated. ``pil_inflate`` reads and
    refuses as PIL does."""
    _same_as_pil(_png_piece_cases()[case], damaged=False)


def random_png_pieces(rng) -> bytes:
    """An 8-bit gray PNG whose stream holds some of its rows (or ends inside
    one), at a random zlib level, sometimes with bytes after it, split into
    up to five IDAT chunks (some empty); sometimes the file is cut."""
    w, h = int(rng.integers(1, 300)), int(rng.integers(1, 40))
    rows = rng.integers(0, 256, (h, w + 1)).astype(np.uint8) // int(rng.choice([1, 32]))
    rows[:, 0] = 0
    keep = int(rng.integers(0, h + 1))
    raw = rows[:keep].tobytes()
    if keep < h and rng.integers(3) == 0:
        raw += rows[keep, :int(rng.integers(1, w + 1))].tobytes()
    stream = zlib.compress(raw, int(rng.choice([0, 1, 6, 9])))
    if rng.integers(4) == 0:
        stream += bytes(rng.integers(0, 256, int(rng.integers(1, 20))).astype(np.uint8))
    cuts = sorted(int(c) for c in rng.integers(0, len(stream) + 1, int(rng.integers(0, 5))))
    data = _idat_png(w, h, [stream[a:b] for a, b in zip([0] + cuts, cuts + [len(stream)])])
    return data[:int(rng.integers(33, len(data)))] if rng.integers(5) == 0 else data


@settings(max_examples=60, deadline=None, derandomize=True, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**32 - 1))
def test_random_png_pieces_decode_as_pil(seed):
    """PNGs whose stream ends early, late or inside a row, in random IDAT
    chunks, some cut: PIL's pixels, or a refusal where PIL refuses."""
    _same_as_pil(random_png_pieces(np.random.default_rng(seed)), damaged=False)


@pytest.mark.parametrize("shape", [(1, 30000), (1500, 120)])
def test_png_inflate_hands_each_byte_to_zlib_once(monkeypatch, shape):
    """``pil_inflate`` gives zlib each piece once, whatever the rows (a
    row-by-row feed of the rest of the stream copied it once a row: a
    16-bit frame took 3.6 times as long)."""
    from mvd_tpu_torch.utils import images as timages

    w, h = shape
    rng = np.random.default_rng(w)
    rows = np.zeros((h, w + 1), np.uint8)
    rows[:, 1:] = rng.integers(0, 256, (h, w)) if w > 1 else rng.integers(0, 2, (h, 1))
    stream = zlib.compress(rows.tobytes(), 1)
    bodies = [stream[i:i + 70000] for i in range(0, len(stream), 70000)]
    fed, real = [], zlib.decompressobj

    class Counting:
        def __init__(self):
            self.d = real()

        def decompress(self, data, max_length=0):
            fed.append(len(data))
            return self.d.decompress(data, max_length)

        eof = property(lambda self: self.d.eof)

    monkeypatch.setattr(timages.zlib, "decompressobj", Counting)
    got = timages.decode_png(_idat_png(w, h, bodies))
    monkeypatch.undo()
    assert sum(fed) == len(stream) and max(fed) <= timages.PIL_BLOCK
    np.testing.assert_array_equal(got, np.repeat(rows[:, 1:, None], 3, axis=2))


# ------------------------------------------------------------ random files


def _image(rng, h: int, w: int, ch: int) -> np.ndarray:
    kind = rng.integers(0, 3)
    if kind == 0:
        return rng.integers(0, 256, (h, w, ch)).astype(np.uint8)
    if kind == 1:  # a few colours: runs and index hits
        pal = rng.integers(0, 256, (int(rng.integers(1, 6)), ch))
        return pal[rng.integers(0, len(pal), (h, w))].astype(np.uint8)
    return FX._photo(rng, h, w, ch)


def random_ppm(rng) -> bytes:
    magic = [b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"Pf", b"P0CMYK", b"PyP", b"PyRGBA",
             b"PyCMYK"][int(rng.integers(11))]
    h, w = (int(x) for x in rng.integers(1, 24, 2))
    maxval = int(rng.choice([1, 7, 15, 100, 255, 256, 1000, 4095, 65535]))
    seps = tuple(rng.choice([b" ", b"\n", b"\t", b"\r\n", b"  \x0b"], int(rng.integers(1, 4))).tolist())
    comments = bool(rng.integers(2))
    if magic in (b"P1", b"P4"):
        px = rng.integers(0, 2, (h, w))
    elif magic == b"Pf":
        px = rng.normal(100, 100, (h, w)).astype(np.float32)
        return FX.ppm_file(px, magic, scale=float(rng.choice([-1.0, 1.0, -3.5, 0.25])), comments=comments,
                           seps=seps)
    else:
        ch = {b"P2": 1, b"P5": 1, b"PyP": 1, b"P3": 3, b"P6": 3}.get(magic, 4)
        if magic in (b"P0CMYK", b"PyP", b"PyRGBA", b"PyCMYK"):
            maxval = 255
        px = rng.integers(0, maxval + 1, (h, w, ch) if ch > 1 else (h, w))
    return FX.ppm_file(px, magic, maxval, comments=comments, seps=seps)


def random_tga(rng) -> bytes:
    h, w = (int(x) for x in rng.integers(1, 20, 2))
    mode = ["1", "L", "LA", "P", "RGB", "RGBA", "RGB16"][int(rng.integers(7))]
    kw = dict(top=bool(rng.integers(2)), right=bool(rng.integers(2)),
              id_field=bytes(rng.integers(0, 256, int(rng.integers(0, 3)) * 5).astype(np.uint8)))
    rle = bool(rng.integers(2)) and mode != "1"
    if mode == "RGB16":
        rows = FX.bgr15(rng.integers(0, 32, (h, w, 3)) // int(rng.choice([1, 8])), rng.integers(0, 2, (h, w)))
        return FX.tga_file(rows.reshape(h, -1), w, h, 10 if rle else 2, 16, cross=rle and bool(rng.integers(2)),
                           **kw)
    if mode == "P":
        n, start = int(rng.integers(1, 80)), int(rng.integers(0, 4))
        depth = int(rng.choice([16, 24]))
        entries = FX.bgr15(rng.integers(0, 32, (n, 3)), rng.integers(0, 2, n)).tobytes() if depth == 16 else \
            rng.integers(0, 256, n * 3).astype(np.uint8).tobytes()
        idx = rng.integers(0, n + start, (h, w)).astype(np.uint8)
        return FX.tga_file(idx, w, h, 9 if rle else 1, 8, cmap=(start, depth, entries),
                           cross=rle and bool(rng.integers(2)), **kw)
    ch = {"1": 1, "L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    img = _image(rng, h, w, ch)
    img = img[..., 0] > 127 if mode == "1" else img[..., 0] if mode == "L" else img
    return FX.tga_image(img, mode, rle=rle, cross=rle and bool(rng.integers(2)), **kw)


def random_icon(rng) -> bytes:
    cur = bool(rng.integers(2))
    frames = []
    for _ in range(int(rng.integers(1, 4))):
        s = int(rng.choice([8, 16, 24, 32]))
        kind = int(rng.integers(6))
        mask = rng.integers(0, 2, (s, s)).astype(bool)
        if kind == 0:
            frames.append((s, s, 0, 32, FX.png_rgba(_image(rng, s, s, int(rng.choice([3, 4]))))))
            continue
        bits = [1, 4, 8, 24, 32][kind - 1]
        if bits <= 8:
            pal = rng.integers(0, 256, (1 << bits, 3)).astype(np.uint8)
            px = rng.integers(0, 1 << bits, (s, s)).astype(np.uint8)
            data = FX.icon_bmp(px, bits, palette=pal, mask=mask)
        else:
            data = FX.icon_bmp(_image(rng, s, s, bits // 8), bits, mask=mask)
        frames.append((s, s, 16 if bits == 4 else 0, bits if not cur else int(rng.integers(0, 9)), data))
    return FX.icon_file(frames, cur=cur)


def random_qoi(rng) -> bytes:
    h, w = (int(x) for x in rng.integers(1, 20, 2))
    if rng.integers(3) == 0:  # any op stream, long enough to fill the image
        ops = rng.integers(0, 256, 5 * h * w + 8).astype(np.uint8).tobytes()
        return b"qoif" + struct.pack(">IIBB", w, h, int(rng.choice([3, 4, 5])), 0) + ops
    ch = int(rng.choice([3, 4]))
    return FX.qoi_file(_image(rng, h, w, ch), int(rng.choice([ch, 3, 4])))


def random_pcx(rng) -> bytes:
    h, w = (int(x) for x in rng.integers(1, 20, 2))
    mode = ["1", "P;2", "P;4", "L", "P", "RGB"][int(rng.integers(6))]
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    if mode == "RGB":
        img = _image(rng, h, w, 3)
    elif mode == "1":
        img = rng.integers(0, 2, (h, w))
    else:
        img = rng.integers(0, {"P;2": 4, "P;4": 16}.get(mode, 256), (h, w)).astype(np.uint8)
    bits = 1 if mode in ("1", "P;2", "P;4") else 8
    natural = (w * bits + 7) // 8
    stride = natural + int(rng.integers(0, 3))
    header = [None, natural, natural + 1][int(rng.integers(3))]
    vga = pal if mode == "L" and rng.integers(2) else None
    return FX.pcx_image(img, mode, pal[:16] if mode.startswith("P;") else pal, stride=stride,
                        header_stride=header, **({"vga": vga} if mode == "L" else {}))


def random_sgi(rng) -> bytes:
    h, w = (int(x) for x in rng.integers(1, 20, 2))
    z, bpc = int(rng.choice([1, 3, 4])), int(rng.choice([1, 2]))
    img = _image(rng, h, w, z).astype(np.int64)
    if bpc == 2:
        img = (img << 8) | rng.integers(0, 256, img.shape)
    dim = 1 if z == 1 and h == 1 else None
    return FX.sgi_file(img, bpc=bpc, rle=bool(rng.integers(2)), dimension=dim)


def random_psd(rng) -> bytes:
    h, w = (int(x) for x in rng.integers(1, 18, 2))
    mode = ["1", "L", "P", "RGB", "CMYK", "LAB", "duotone", "multichannel"][int(rng.integers(8))]
    n = {"1": 1, "L": 1, "P": 1, "duotone": 1, "multichannel": 2, "RGB": 3, "CMYK": 4, "LAB": 3}[mode]
    n += int(rng.integers(0, 3))
    row = (w + 7) // 8 if mode == "1" else w
    chans = [_image(rng, h, row, 1)[..., 0] for _ in range(n)]
    pal = rng.integers(0, 256, (256, 3)) if mode == "P" and rng.integers(2) else None
    return FX.psd_file(chans, w, h, mode, rle=bool(rng.integers(2)), palette=pal,
                       resources=bool(rng.integers(2)), layers=bool(rng.integers(2)))


def _bcn_data(rng, name: str, nb: int) -> bytes:
    size = 8 if name.startswith(("BC1", "BC4", "DXT1", "ATI1")) else 16
    data = bytearray(rng.integers(0, 256, nb * size).astype(np.uint8).tobytes())
    for b in range(nb):
        if name.startswith("BC7"):
            m = int(rng.integers(9))
            data[size * b] = ((data[size * b] & (0xFF << (m + 1)) & 0xFF) | (1 << m)) if m < 8 else 0
        elif name.startswith("BC6H"):
            c = [0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19, 23, 27, 31][int(rng.integers(18))]
            data[size * b] = (data[size * b] & ~(3 if c & 3 < 2 else 31) & 0xFF) | c
    return bytes(data)


def random_dds(rng) -> bytes:
    h, w = (int(x) for x in rng.integers(1, 19, 2))
    nb = ((w + 3) // 4) * ((h + 3) // 4)
    kind = int(rng.integers(6))
    if kind == 0:
        name = list(FX.DXGI)[int(rng.integers(len(FX.DXGI)))]
        if name.startswith("RGBA"):
            return FX.dds_file(w, h, rng.integers(0, 256, w * h * 4).astype(np.uint8).tobytes(), dxgi=FX.DXGI[name])
        return FX.dds_file(w, h, _bcn_data(rng, name, nb), dxgi=FX.DXGI[name])
    if kind == 1:
        code = [b"DXT1", b"DXT3", b"DXT5", b"BC4U", b"ATI1", b"BC5U", b"ATI2", b"BC5S"][int(rng.integers(8))]
        return FX.dds_file(w, h, _bcn_data(rng, code.decode(), nb), fourcc=code)
    if kind == 2:  # masks of any bits, contiguous or not
        bitcount = int(rng.choice([8, 16, 24, 32]))
        alpha = bool(rng.integers(2))
        masks = tuple(int(m) for m in rng.integers(0, 1 << min(bitcount, 31), 4 if alpha else 3))
        n = w * h * bitcount // 8 - int(rng.integers(0, 2)) * int(rng.integers(0, 9))
        return FX.dds_file(w, h, rng.integers(0, 256, max(n, 0)).astype(np.uint8).tobytes(), rgb_masks=masks,
                           bitcount=bitcount, alpha=alpha)
    if kind == 3:
        la = bool(rng.integers(2))
        return FX.dds_file(w, h, rng.integers(0, 256, w * h * (2 if la else 1)).astype(np.uint8).tobytes(),
                           luminance=True, bitcount=16 if la else 8, alpha=la)
    if kind == 4:
        return FX.dds_file(w, h, rng.integers(0, 256, w * h).astype(np.uint8).tobytes(),
                           palette=rng.integers(0, 256, (256, 4)))
    return FX.dds_file(w, h, FX.bc7_blocks(_image(rng, h, w, 4)) if rng.integers(2) else
                       FX.bc1_blocks(_image(rng, h, w, 3)), **({"dxgi": 98} if rng.integers(2) else
                                                                {"fourcc": b"DXT1"}))


RANDOM = {"ppm": random_ppm, "tga": random_tga, "icon": random_icon, "qoi": random_qoi, "pcx": random_pcx,
          "sgi": random_sgi, "psd": random_psd, "dds": random_dds}


def _same_as_pil(data: bytes, damaged: bool) -> None:
    """PIL's pixels, or a refusal where PIL refuses; where PIL reads a
    ``damaged`` file, also a refusal naming ROADMAP item 13c (damage that
    turns it into a format the port does not read). An undamaged file PIL
    reads must be read."""
    try:
        _, _, want = _pil_rgb(data)
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
    """Files of random size, mode, depth, header, compression, orientation
    and palette from the fixture writers decode as PIL decodes them (or are
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


@pytest.mark.parametrize("name", ["BC1", "BC2", "BC3", "BC4", "BC5", "BC5S", "BC6H", "BC6HS", "BC7"])
def test_random_bcn_blocks_are_pils(name):
    """400 seeded random blocks of each BCn format in one 80x20 texture
    (every BC6H mode code, reserved ones included, and every BC7 mode and
    partition, with the mode-less block) decode as PIL's bcn decoder
    decodes them."""
    rng = np.random.default_rng(sum(map(ord, name)))
    w, h = 80, 20
    data = FX.dds_file(w, h, _bcn_data(rng, name, 100 * 4), dxgi=FX.DXGI[name])
    _same_as_pil(data, damaged=False)
    if name == "BC7":  # every partition of the 2- and 3-subset modes
        blocks = bytearray(_bcn_data(rng, "BC7", 400))
        for b in range(400):
            mode = [0, 1, 2, 3, 7][b % 5]
            part = (b // 5) % (16 if mode == 0 else 64)
            bits = int.from_bytes(blocks[16 * b:16 * b + 16], "little")
            pbits = 4 if mode == 0 else 6
            bits = (bits >> (mode + 1 + pbits) << (mode + 1 + pbits)) | part << (mode + 1) | 1 << mode
            blocks[16 * b:16 * b + 16] = bits.to_bytes(16, "little")
        _same_as_pil(FX.dds_file(w, h, bytes(blocks), dxgi=98), damaged=False)


# ------------------------------------------------- the card's host, no PIL

READ_WITHOUT_PIL = """
import hashlib, json, sys
sys.modules.update(PIL=None, jax=None, flax=None, mvd_tpu=None)
from mvd_tpu_torch.utils.images import decode_image
for name in sys.argv[2:]:
    data = open(sys.argv[1] + "/" + name, "rb").read()
    rgb = decode_image(data)
    comp = decode_image(data, composite_alpha=True)
    print(name, hashlib.sha256(rgb.tobytes()).hexdigest(), hashlib.sha256(comp.tobytes()).hexdigest())
"""


def test_small_formats_read_without_pil():
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
    """``frame_small_forms`` (``chip_smoke.py`` phase 9d's PIL-free writer)
    on a small frame: PIL reads each file, and the port's decode is PIL's
    bitwise; the lossless forms give the frame's pixels; the committed
    digests of the 1067x800 frame's forms are of the same forms."""
    rng = np.random.default_rng(7)
    frame = rng.integers(0, 256, (37, 45, 3)).astype(np.uint8)
    frame[:, :20] = frame[:, :1]
    forms = FX.frame_small_forms(frame)
    assert sorted(forms) == sorted(FRAMES)
    for form, data in forms.items():
        _, mode, want = _pil_rgb(data)
        np.testing.assert_array_equal(decode_image(data), want, err_msg=form)
        if not form.startswith(("DDS", "PFM")):
            np.testing.assert_array_equal(want, frame, err_msg=form)
