"""The port's WebP reader (``utils/images.py:decode_webp``,
``csrc/webp_decode.cpp``) against PIL 12.1.0, which reads WebP through
libwebp 1.6.0's ``WebPAnimDecoder``: lossless VP8L, lossy VP8 with and
without its ALPH chunk, the VP8X container and an animation's first frame.

Bars: every WebP fixture (``tests/fixtures/torch_port_images``, written by
``make_fixtures.py`` there) decodes bitwise to ``np.asarray`` of PIL's
image, in PIL's mode, and to PIL's stored digests (``convert("RGB")`` and
the loaders' white composite), lossless files with ``exact`` to their
source; ``load_image``, the server's upload decode and the Objaverse
loader's decode are the JAX functions value for value on WebP bytes;
seeded random files of each form (PIL's lossless, lossy and lossy-with-
alpha encoders, and libwebp's own encoder at random advanced settings)
decode as PIL decodes them; each malformed file PIL refuses is refused,
naming what is wrong; and the fixtures decode to PIL's digests in a
process that cannot import PIL, JAX or the JAX package.
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

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from mvd_tpu.cli import serve as jserve
from mvd_tpu.data import objaverse as jobj
from mvd_tpu.utils import images as jimages
from mvd_tpu_torch.cli import serve as tserve
from mvd_tpu_torch.config import TINY_MODEL
from mvd_tpu_torch.data import objaverse as tobj
from mvd_tpu_torch.utils.images import decode_image, decode_webp, is_webp, load_image, over_white

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "torch_port_images"
DIGESTS = json.loads((FIXTURES / "pil_sha256.json").read_text())
WEBP = sorted(n for n in DIGESTS if n.endswith(".webp"))
SIZE = TINY_MODEL.unet.sample_size * 8


def _make_fixtures():
    spec = importlib.util.spec_from_file_location("torch_port_images_fixtures", FIXTURES / "make_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FX = _make_fixtures()


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _pil(data: bytes):
    """``np.asarray(Image.open(...))`` and the image's mode."""
    im = Image.open(io.BytesIO(data))
    return np.asarray(im), im.mode


# -------------------------------------------------------------- fixtures


def test_fixtures_hold_every_form():
    """The fixture set has the forms the reader must cover, by PIL's mode
    and the file's chunks: lossless RGB and RGBA, lossy RGB, lossy with
    ALPH (raw and VP8L-coded, each filter), 2-8 token partitions, an
    animation, 1x1 and odd sizes."""
    chunks = {n: [k for k, _ in FX.riff_chunks((FIXTURES / n).read_bytes())] for n in WEBP}
    modes = {n: DIGESTS[n]["mode"] for n in WEBP}
    assert any(b"VP8L" in c and modes[n] == "RGB" for n, c in chunks.items())
    assert any(b"VP8L" in c and modes[n] == "RGBA" for n, c in chunks.items())
    assert any(c == [b"VP8 "] for c in chunks.values())
    alph = {(FX.riff_chunks((FIXTURES / n).read_bytes())[1][1][0] >> 2) & 3
            for n, c in chunks.items() if b"ALPH" in c}
    assert alph == {0, 1, 2, 3}
    assert any(b"ANMF" in c for c in chunks.values())
    assert {"webp_parts2.webp", "webp_parts4.webp", "webp_parts8.webp", "webp_ll_1x1.webp",
            "webp_lossy_3x5.webp", "webp_simple_filter.webp", "webp_alpha_raw.webp"} <= set(WEBP)


@pytest.mark.parametrize("name", WEBP)
def test_webp_fixture_is_pil_in_its_mode(name):
    """``decode_webp`` is ``np.asarray`` of PIL's image, in PIL's mode, and
    gives PIL's stored digests of ``convert("RGB")`` and of the loaders'
    white composite (``decode_image`` on every fixture:
    ``test_torch_port_images.py``)."""
    data = (FIXTURES / name).read_bytes()
    want = DIGESTS[name]
    got, mode = decode_webp(data)
    pixels, pil_mode = _pil(data)
    assert mode == pil_mode == want["mode"]
    np.testing.assert_array_equal(got, pixels)
    rgb = got[..., :3]
    assert list(rgb.shape) == want["shape"] and _sha(rgb) == want["sha256"]
    assert _sha(over_white(got) if mode == "RGBA" else rgb) == want.get("composite_sha256", want["sha256"])
    if "source_sha256" in want:  # lossless with exact: the encoder's own pixels
        assert _sha(got) == want["source_sha256"]


def test_animation_first_frame_sits_on_a_zero_canvas():
    """An animation's first frame at (6, 4) of a 40x30 canvas: zeros
    around it (alpha 0 too) and, inside, the frame's own pixels."""
    data = (FIXTURES / "webp_anim_offset_lossless.webp").read_bytes()
    got, mode = decode_webp(data)
    assert mode == "RGBA" and got.shape == (30, 40, 4)
    anmf = dict(FX.riff_chunks(data))[b"ANMF"]
    alone = FX.webp_file([(b"VP8L", dict(FX.riff_chunks(b"RIFF\0\0\0\0WEBP" + anmf[16:]))[b"VP8L"])])
    frame, _ = decode_webp(alone)
    np.testing.assert_array_equal(got[4:14, 6:26], frame)
    outside = got.copy()
    outside[4:14, 6:26] = 0
    assert not outside.any()


# ------------------------------------------------- the JAX package's paths


PATHS = ["webp_ll_photo_m4_q75.webp", "webp_ll_gradient_m6_q100.webp", "webp_lossy_q75.webp",
         "webp_alpha_aq40.webp", "webp_alph_gradient_m1.webp", "webp_anim_offset_alpha.webp",
         "webp_lossy_31x33.webp"]


@pytest.mark.parametrize("name", PATHS)
def test_load_image_server_and_loader_are_the_jax_functions(tmp_path, name):
    """``load_image`` (``cli.infer``'s source read), the server's
    ``_b64_png`` and the Objaverse ``_load_image_from_bytes`` on the same
    WebP bytes are the JAX functions value for value, at the image's size
    and resized to the model's 64² (the loader composites RGBA over white,
    the other two drop alpha)."""
    data = (FIXTURES / name).read_bytes()
    path = tmp_path / name
    path.write_bytes(data)
    h, w = DIGESTS[name]["shape"][:2]
    np.testing.assert_array_equal(load_image(str(path)), jimages.load_image(str(path)))
    np.testing.assert_array_equal(load_image(str(path), SIZE), jimages.load_image(str(path), SIZE))
    b64 = base64.b64encode(data).decode()
    np.testing.assert_array_equal(tserve._b64_png(b64, SIZE), jserve._b64_png(b64, SIZE))
    np.testing.assert_array_equal(tobj._load_image_from_bytes(data, SIZE), jobj._load_image_from_bytes(data, SIZE))
    if h == w:
        np.testing.assert_array_equal(tserve._b64_png(b64, h), jserve._b64_png(b64, h))
        np.testing.assert_array_equal(tobj._load_image_from_bytes(data, h), jobj._load_image_from_bytes(data, h))


def test_decode_image_takes_what_pil_identifies_as_webp():
    """``decode_image`` reads a file as WebP exactly where PIL's
    ``_accept`` does (RIFF, WEBP, a first chunk VP8, VP8L or VP8X): a
    RIFF/WEBP file opening with another chunk is refused by both."""
    data = (FIXTURES / "webp_alpha_raw.webp").read_bytes()
    assert is_webp(data) and data[12:16] == b"VP8X"
    odd = data[:12] + b"ALPH" + data[16:]
    assert not is_webp(odd)
    with pytest.raises(Image.UnidentifiedImageError):
        Image.open(io.BytesIO(odd))
    with pytest.raises(ValueError, match="cannot identify image file"):
        decode_image(odd)


# ------------------------------------------------------- random files


def _random_image(rng, mode: str) -> np.ndarray:
    h, w = int(rng.integers(1, 48)), int(rng.integers(1, 48))
    ch = 4 if mode == "RGBA" else 3
    kind = rng.integers(0, 3)
    if kind == 0:  # noise
        a = rng.integers(0, 256, (h, w, ch))
    elif kind == 1:  # gradients
        y, x = np.mgrid[:h, :w]
        a = np.stack([(3 * x + 5 * y) % 256, (x * y) % 256, (7 * x) % 256, (11 * y + 200) % 256][:ch], -1)
        a = a + rng.integers(0, 20, a.shape)
    else:  # a palette
        pal = rng.integers(0, 256, (int(rng.integers(1, 40)), ch))
        a = pal[rng.integers(0, len(pal), (h, w))]
    a = np.clip(a, 0, 255).astype(np.uint8)
    if ch == 4 and rng.random() < 0.5:
        a[..., 3] = np.where(rng.random((h, w)) < 0.3, 0, a[..., 3])
    return a


def _random_file(form: str, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    if form == "advanced":  # libwebp's encoder at settings PIL's save cannot reach
        img = _random_image(rng, "RGBA")
        cfg = dict(quality=float(rng.integers(0, 101)), method=int(rng.integers(0, 7)),
                   segments=int(rng.integers(1, 5)), sns_strength=int(rng.integers(0, 101)),
                   filter_strength=int(rng.integers(0, 101)), filter_sharpness=int(rng.integers(0, 8)),
                   filter_type=int(rng.integers(0, 2)), autofilter=int(rng.integers(0, 2)),
                   alpha_compression=int(rng.integers(0, 2)), alpha_filtering=int(rng.integers(0, 3)),
                   alpha_quality=int(rng.integers(0, 101)), partitions=int(rng.integers(0, 4)),
                   preprocessing=int(rng.integers(0, 3)))
        return FX.webp_encode(img, **cfg)
    buf = io.BytesIO()
    if form == "lossless":
        img = _random_image(rng, "RGBA" if rng.random() < 0.5 else "RGB")
        Image.fromarray(img).save(buf, "WEBP", lossless=True, quality=int(rng.integers(0, 101)),
                                  method=int(rng.integers(0, 7)), exact=bool(rng.random() < 0.5))
    elif form == "lossy":
        Image.fromarray(_random_image(rng, "RGB")).save(buf, "WEBP", quality=int(rng.integers(0, 101)),
                                                        method=int(rng.integers(0, 7)))
    else:
        Image.fromarray(_random_image(rng, "RGBA")).save(buf, "WEBP", quality=int(rng.integers(0, 101)),
                                                         method=int(rng.integers(0, 7)),
                                                         alpha_quality=int(rng.integers(0, 101)))
    return buf.getvalue()


@settings(max_examples=40, deadline=None, derandomize=True, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**32 - 1))
@pytest.mark.parametrize("form", ["lossless", "lossy", "alpha", "advanced"])
def test_random_files_decode_as_pil(form, seed):
    data = _random_file(form, seed)
    got, mode = decode_webp(data)
    pixels, pil_mode = _pil(data)
    assert mode == pil_mode
    np.testing.assert_array_equal(got, pixels)


@settings(max_examples=40, deadline=None, derandomize=True, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**32 - 1))
def test_random_vp8_streams_decode_as_pil(seed):
    """VP8 key frames whose every header field, mode and coefficient is
    drawn at random (the fixture script's ``encode_vp8_random``: segments
    absolute or relative, loop-filter deltas, quantizer deltas, 1-8
    partitions, probability updates, skip flags, every intra mode at every
    edge) decode as PIL decodes them."""
    rng = np.random.default_rng(seed)
    w, h = int(rng.integers(1, 49)), int(rng.integers(1, 49))
    data = FX.webp_file([(b"VP8 ", FX.encode_vp8_random(rng, w, h))])
    got, mode = decode_webp(data)
    pixels, pil_mode = _pil(data)
    assert mode == pil_mode == "RGB"
    np.testing.assert_array_equal(got, pixels)


# ------------------------------------------------------------- refusals


def _fixture(name: str) -> bytes:
    return (FIXTURES / name).read_bytes()


def _payload_at(data: bytes, kind: bytes) -> int:
    pos = 12
    while data[pos:pos + 4] != kind:
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        pos += 8 + size + (size & 1)
    return pos + 8


def _patched(name: str, kind: bytes, offset: int, fn) -> bytes:
    """A fixture with the byte ``offset`` into its ``kind`` chunk's
    payload replaced by ``fn(byte)``."""
    data = bytearray(_fixture(name))
    at = _payload_at(bytes(data), kind) + offset
    data[at] = fn(data[at])
    return bytes(data)


def _vp8l(w: int, h: int, fields) -> bytes:
    """A simple VP8L file: the header of a w x h image without alpha, then
    ``fields`` as (value, bits) written LSB first."""
    v, n = 0, 0
    for value, bits in [(0x2F, 8), (w - 1, 14), (h - 1, 14), (0, 1), (0, 3)] + list(fields):
        v |= value << n
        n += bits
    return FX.webp_file([(b"VP8L", v.to_bytes((n + 7) // 8, "little"))])


def _vp8(cut) -> bytes:
    """``webp_lossy_q75.webp``'s VP8 chunk cut to ``cut(partition 0
    length)`` bytes, in a valid container."""
    vp8 = dict(FX.riff_chunks(_fixture("webp_lossy_q75.webp")))[b"VP8 "]
    return FX.webp_file([(b"VP8 ", vp8[:cut(int.from_bytes(vp8[:3], "little") >> 5)])])


# the (1x1) VP8L image stream: no transform, no colour cache, no meta codes
_PLAIN = [(0, 1), (0, 1), (0, 1)]
_ONE_SYMBOL = [(1, 1), (0, 1), (0, 1), (0, 1)]  # a simple code of symbol 0

REFUSED = {
    "decompression-bomb": (lambda: _vp8l(16384, 11000, _PLAIN), r"over the limit of 178956970 pixels"),
    "vp8-not-a-key-frame": (lambda: _patched("webp_lossy_q75.webp", b"VP8 ", 0, lambda b: b | 1),
                            r"VP8: not a key frame"),
    "vp8-show-frame-0": (lambda: _patched("webp_lossy_q75.webp", b"VP8 ", 0, lambda b: b & ~0x10),
                         r"frame not displayable \(show_frame 0\)"),
    "vp8-start-code": (lambda: _patched("webp_lossy_q75.webp", b"VP8 ", 3, lambda b: 0x9C),
                       r"VP8: bad start code"),
    "vp8-profile": (lambda: _patched("webp_lossy_q75.webp", b"VP8 ", 0, lambda b: (b & ~0x0E) | 10),
                    r"profile > 3"),
    "vp8l-signature": (lambda: _patched("webp_ll_photo_m4_q75.webp", b"VP8L", 0, lambda b: 0x2E),
                       r"VP8L: bad signature \(not 0x2f\)"),
    "vp8l-version": (lambda: _patched("webp_ll_photo_m4_q75.webp", b"VP8L", 4, lambda b: b | 0x20),
                     r"VP8L: unknown version \(not 0\)"),
    "truncated-file": (lambda: _fixture("webp_lossy_q75.webp")[:-30], r"truncated file"),
    "chunk-past-riff": (lambda: _patched("webp_lossy_q75.webp", b"VP8 ", -1, lambda b: 0x10),
                        r"runs past the RIFF data"),
    "partition-0-past-data": (lambda: _vp8(lambda p0: 10 + p0 - 5), r"bad partition length"),
    "token-partition-cut": (lambda: _vp8(lambda p0: 10 + p0 + 3), r"premature end of a token partition"),
    "over-subscribed-code-length-code": (lambda: _vp8l(1, 1, _PLAIN + [(0, 1), (0, 4), (1, 3), (1, 3), (1, 3),
                                                                        (0, 3)]),
                                         r"VP8L: invalid code-length code"),
    "over-subscribed-prefix-code": (lambda: _vp8l(1, 1, _PLAIN + [(0, 1), (0, 4), (0, 3), (0, 3), (1, 3), (1, 3),
                                                                   (0, 1)] + [(1, 1)] * 280),
                                    r"VP8L: invalid prefix code"),
    "distance-code-past-its-alphabet": (lambda: _vp8l(1, 1, _PLAIN + _ONE_SYMBOL * 4 + [(1, 1), (0, 1), (1, 1),
                                                                                          (200, 8)]),
                                        r"VP8L: invalid prefix code"),
    "vp8x-reserved-flag": (lambda: FX.webp_file([FX.vp8x(53, 37, 0x01), (b"VP8 ", dict(FX.riff_chunks(
        _fixture("webp_lossy_q75.webp")))[b"VP8 "])]), r"reserved VP8X flags"),
    "vp8x-canvas-not-the-image": (lambda: FX.webp_file([FX.vp8x(54, 37, 0), (b"VP8 ", dict(FX.riff_chunks(
        _fixture("webp_lossy_q75.webp")))[b"VP8 "])]), r"not the VP8X canvas size"),
    "alph-reserved-bits": (lambda: _patched("webp_alph_none_m0.webp", b"ALPH", 0, lambda b: b | 0xC0),
                           r"ALPH: invalid header"),
    "alph-raw-too-short": (lambda: FX.webp_file([FX.vp8x(112, 96, 0x10), (b"ALPH", b"\0" * 100), (
        b"VP8 ", dict(FX.riff_chunks(_fixture("webp_alph_none_m0.webp")))[b"VP8 "])]),
                           r"uncompressed alpha shorter than the image"),
    "anmf-outside-the-canvas": (lambda: FX.animation((30, 30), [(20, 0, [(b"VP8L", dict(FX.riff_chunks(
        _fixture("webp_ll_3x5.webp")))[b"VP8L"])], (3, 5)), (28, 0, [(b"VP8L", dict(FX.riff_chunks(
            _fixture("webp_ll_3x5.webp")))[b"VP8L"])], (3, 5))]), r"a frame outside the canvas"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_what_pil_refuses_is_refused(case):
    """Each malformed file: PIL raises on these bytes (at open or at
    load), and the port's ``ValueError`` names what is wrong."""
    make, match = REFUSED[case]
    data = make()
    with pytest.raises((OSError, Image.DecompressionBombError)):
        Image.open(io.BytesIO(data)).load()
    with pytest.raises(ValueError, match=match):
        decode_webp(data)


READ_WITHOUT_PIL = """
import hashlib, sys
sys.modules.update(PIL=None, jax=None, flax=None, mvd_tpu=None)
from mvd_tpu_torch.utils.images import decode_image, decode_webp, over_white
for name in sys.argv[2:]:
    data = open(sys.argv[1] + "/" + name, "rb").read()
    pixels, mode = decode_webp(data)
    rgb = decode_image(data)
    comp = over_white(pixels) if mode == "RGBA" else rgb
    print(name, mode, hashlib.sha256(rgb.tobytes()).hexdigest(), hashlib.sha256(comp.tobytes()).hexdigest())
"""


def test_webp_reads_without_pil():
    """In a process where PIL, JAX and the JAX package cannot be imported
    (the card's host): every WebP fixture decodes to PIL's digests, in
    PIL's mode."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", READ_WITHOUT_PIL, str(FIXTURES), *WEBP], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = {line.split(" ", 1)[0]: line.split()[1:] for line in proc.stdout.strip().splitlines()}
    for name in WEBP:
        want = DIGESTS[name]
        assert lines[name] == [want["mode"], want["sha256"], want.get("composite_sha256", want["sha256"])], name
