"""The port's image readers on the forms the JAX package reads through PIL
beyond sequential JPEG and 8-bit PNG: progressive JPEG and 4-component
(CMYK, YCCK) JPEG (``csrc/jpeg_decode.cpp``), PNG at every bit depth of
every colour type, interlaced or not (``utils/images.py:decode_png``,
``csrc/png_decode.cpp``).

Bars: every decode bitwise PIL 12.1.0's (libjpeg-turbo 3.1.3)
``convert("RGB")``, and the data loaders' white composite bitwise PIL's
``alpha_composite`` where PIL opens the file as RGBA, on every fixture
(``tests/fixtures/torch_port_images``, written by ``make_fixtures.py``
there) both by PIL here and by the stored digest, and on hypothesis-drawn
files; ``load_image``, the server's upload decode and the Objaverse
loader's decode bitwise the JAX functions at the image's size and within
one level of 255 where they resize (the port's Lanczos; the count of
values that differ is asserted). A progressive file that libjpeg would
block-smooth is refused naming block smoothing, never decoded without it;
scan parameters libjpeg refuses are refused where PIL raises.
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
from mvd_tpu_torch.utils.images import decode_image, decode_jpeg, decode_png, load_image, png_mode

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "torch_port_images"
DIGESTS = json.loads((FIXTURES / "pil_sha256.json").read_text())
DECODED = sorted(n for n, d in DIGESTS.items() if "refused" not in d)
REFUSED = sorted(n for n, d in DIGESTS.items() if "refused" in d)
SIZE = TINY_MODEL.unet.sample_size * 8
LEVEL = 2 / 255 + 1e-6  # one level of 255 in [-1, 1]


def _make_fixtures():
    spec = importlib.util.spec_from_file_location("torch_port_images_fixtures", FIXTURES / "make_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FX = _make_fixtures()


def _pil(data: bytes, composite: bool = False) -> np.ndarray:
    """PIL's ``convert("RGB")``, or with ``composite`` the JAX loader's
    white composite first where PIL's mode is RGBA."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # a palette tRNS of bytes, dropped
        im = Image.open(io.BytesIO(data))
        if composite and im.mode == "RGBA":
            im = Image.alpha_composite(Image.new("RGBA", im.size, (255, 255, 255, 255)), im)
        return np.asarray(im.convert("RGB"))


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(a.tobytes()).hexdigest()


def _within_one_level(got: np.ndarray, want: np.ndarray) -> int:
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert diff.max() <= LEVEL, diff.max()
    return int((diff > 0).sum())


# -------------------------------------------------------------- fixtures


@pytest.mark.parametrize("name", DECODED)
def test_fixture_decodes_bitwise_pil(name):
    data = (FIXTURES / name).read_bytes()
    want = DIGESTS[name]
    got = decode_image(data)
    np.testing.assert_array_equal(got, _pil(data))
    assert list(got.shape) == want["shape"] and _sha(got) == want["sha256"]
    comp = decode_image(data, composite_alpha=True)
    np.testing.assert_array_equal(comp, _pil(data, composite=True))
    assert _sha(comp) == want.get("composite_sha256", want["sha256"])
    if name.endswith(".png"):
        depth, colour = data[24], data[25]
        assert png_mode(depth, colour) == want["mode"]


@pytest.mark.parametrize("name", REFUSED)
def test_block_smoothed_files_are_refused(name):
    """Scans that leave some of AC coefficients 1-9 unrefined (a DC-only
    file, AC at Al 1, AC 6-63 never sent, chroma never given AC): libjpeg
    decodes them with block smoothing, the port refuses them. PIL decodes
    each to the stored digest. (Without the refusal the port's decode
    differs from PIL's in 558 to 5764 values of three of the four files;
    in ``smooth_ac6_unsent.jpg``, whose unrefined coefficients are 6-9
    only, it is PIL's: a refusal libjpeg's smoothing would not need, kept
    because the rule is jdcoefct.c's smoothing_ok.)"""
    data = (FIXTURES / name).read_bytes()
    assert DIGESTS[name]["refused"] == "block smoothing"
    with pytest.raises(ValueError, match="block smoothing"):
        decode_jpeg(data)
    assert _sha(_pil(data)) == DIGESTS[name]["sha256"]


# ------------------------------------------------------------- hypothesis


@settings(max_examples=25, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 48), w=st.integers(1, 48), mode=st.sampled_from(["RGB", "L", "CMYK"]),
       quality=st.integers(1, 100), subsampling=st.sampled_from([0, 1, 2]), optimize=st.booleans(),
       restart=st.sampled_from([None, ("restart_marker_blocks", 1), ("restart_marker_blocks", 3),
                                ("restart_marker_rows", 1)]), seed=st.integers(0, 2**16))
def test_progressive_jpegs_pil_writes_decode_bitwise(h, w, mode, quality, subsampling, optimize, restart, seed):
    c = {"RGB": 3, "L": 1, "CMYK": 4}[mode]
    y, x = np.mgrid[:h, :w]
    rng = np.random.default_rng(seed)
    arr = ((np.stack([3 * x + 5 * y + 40 * k for k in range(c)], -1) + rng.integers(0, 80, (h, w, c)))
           % 256).astype(np.uint8)
    im = Image.frombytes(mode, (w, h), arr.tobytes())
    options = dict(quality=quality, progressive=True, optimize=optimize)
    if mode == "RGB":
        options["subsampling"] = subsampling
    if restart:
        options[restart[0]] = restart[1]
    buf = io.BytesIO()
    im.save(buf, "JPEG", **options)
    np.testing.assert_array_equal(decode_jpeg(buf.getvalue()), _pil(buf.getvalue()))


@settings(max_examples=25, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(fmt=st.sampled_from(FX.PNG_FORMATS), interlace=st.sampled_from([0, 1]), h=st.integers(1, 48),
       w=st.integers(1, 48), seed=st.integers(0, 2**16))
def test_pngs_of_every_depth_and_interlace_decode_bitwise(fmt, interlace, h, w, seed):
    colour, depth = fmt
    rng = np.random.default_rng(seed)
    plte = rng.integers(0, 256, 3 * min(256, 1 << depth), dtype=np.uint8).tobytes() if colour == 3 else b""
    data = FX.encode_png(FX._png_samples(rng, h, w, colour, depth), depth, colour, interlace, plte=plte,
                         filters=rng)
    np.testing.assert_array_equal(decode_png(data), _pil(data))
    np.testing.assert_array_equal(decode_png(data, composite_alpha=True), _pil(data, composite=True))


# ------------------------------------------------- the JAX package's paths


# one of each new form; the LA and 16-bit RGBA images go through the
# loader's composite (PIL opens 16-bit gray+alpha as RGBA, 8-bit as LA)
FORMS = ["prog_420.jpg", "prog_gray_script.jpg", "cmyk_prog.jpg", "ycck.jpg", "c0_d16.png",
         "c0_d1_adam7.png", "c3_d4_adam7.png", "c4_d8_adam7.png", "c4_d16.png", "c6_d16_adam7.png"]


@pytest.mark.parametrize("name", FORMS)
def test_load_image_server_and_loader_are_the_jax_functions(tmp_path, name):
    """``load_image`` bitwise the JAX one at the image's size; it, the
    server's ``_b64_png`` and the Objaverse ``_load_image_from_bytes``
    resized to the model's 64² within one level of the JAX functions
    (measured: 0 values differ)."""
    data = (FIXTURES / name).read_bytes()
    path = tmp_path / name
    path.write_bytes(data)
    np.testing.assert_array_equal(load_image(str(path)), jimages.load_image(str(path)))
    assert _within_one_level(load_image(str(path), SIZE), jimages.load_image(str(path), SIZE)) == 0
    b64 = base64.b64encode(data).decode()
    assert _within_one_level(tserve._b64_png(b64, SIZE) * 2 - 1, jserve._b64_png(b64, SIZE) * 2 - 1) == 0
    assert _within_one_level(tobj._load_image_from_bytes(data, SIZE), jobj._load_image_from_bytes(data, SIZE)) == 0


def _square_forms(n: int) -> dict:
    """name -> (n x n file, whether PIL opens it as RGBA)."""
    rng = np.random.default_rng(n)
    y, x = np.mgrid[:n, :n]
    rgb = ((np.stack([3 * x + 5 * y, 2 * x + 7 * y, x * y % 97], -1) + rng.integers(0, 40, (n, n, 3)))
           % 256).astype(np.uint8)
    cmyk = np.dstack([rgb, rgb[..., :1] // 2])

    def pil_jpeg(arr, mode):
        buf = io.BytesIO()
        Image.frombytes(mode, (n, n), arr.tobytes()).save(buf, "JPEG", quality=90, progressive=True)
        return buf.getvalue()

    def samples(colour, depth):
        return FX._png_samples(rng, n, n, colour, depth)

    return {
        "prog.jpg": (pil_jpeg(rgb, "RGB"), False),
        "cmyk_prog.jpg": (pil_jpeg(cmyk, "CMYK"), False),
        "rgba16_adam7.png": (FX.encode_png(samples(6, 16), 16, 6, 1, filters=rng), True),
        "la16.png": (FX.encode_png(samples(4, 16), 16, 4, filters=rng), True),
        "la8_adam7.png": (FX.encode_png(samples(4, 8), 8, 4, 1, filters=rng), False),
        "p4_trns.png": (FX.encode_png(samples(3, 4), 4, 3, plte=bytes(range(48)), trns=bytes([0, 9]),
                                      filters=rng), False),
        "rgb16_trns.png": (FX.encode_png(samples(2, 16), 16, 2, trns=struct.pack(">3H", 1, 2, 3),
                                         filters=rng), False),
        "gray16_adam7.png": (FX.encode_png(samples(0, 16), 16, 0, 1, filters=rng), False),
        "gray1_adam7.png": (FX.encode_png(samples(0, 1), 1, 0, 1, filters=rng), False),
    }


@pytest.mark.filterwarnings("ignore:Palette images with Transparency")
@pytest.mark.parametrize("name", sorted(_square_forms(12)))
def test_square_forms_are_the_jax_functions_at_their_size(name):
    """At the image's size (no resize) the server's ``_b64_png`` and the
    Objaverse ``_load_image_from_bytes`` are the JAX functions value for
    value; the loader composites over white exactly the files PIL opens as
    RGBA (8- and 16-bit RGBA, 16-bit gray+alpha), not 8-bit gray+alpha,
    palette + tRNS or RGB + tRNS."""
    data, rgba = _square_forms(12)[name]
    assert (Image.open(io.BytesIO(data)).mode == "RGBA") is rgba
    b64 = base64.b64encode(data).decode()
    np.testing.assert_array_equal(tserve._b64_png(b64, 12), jserve._b64_png(b64, 12))
    got = tobj._load_image_from_bytes(data, 12)
    np.testing.assert_array_equal(got, jobj._load_image_from_bytes(data, 12))
    plain = decode_image(data).astype(np.float32) / 255.0 * 2.0 - 1.0
    assert (not np.array_equal(got, plain)) is rgba


# ------------------------------------------------------------- refusals


def _prog_with_first_scan(Ss: int, Se: int, Ah: int, Al: int) -> bytes:
    """``prog_444.jpg`` with its first scan's Ss, Se and Ah/Al set."""
    data = bytearray((FIXTURES / "prog_444.jpg").read_bytes())
    at = data.index(b"\xff\xda")
    ns = data[at + 4]
    p = at + 5 + 2 * ns
    data[p:p + 3] = bytes([Ss, Se, (Ah << 4) | Al])
    return bytes(data)


@pytest.mark.parametrize("data,match", [
    (lambda: _prog_with_first_scan(0, 5, 0, 1), "invalid progressive parameters Ss=0 Se=5 Ah=0 Al=1"),
    (lambda: _prog_with_first_scan(0, 0, 0, 14), "invalid progressive parameters Ss=0 Se=0 Ah=0 Al=14"),
    (lambda: _prog_with_first_scan(0, 0, 3, 1), "invalid progressive parameters Ss=0 Se=0 Ah=3 Al=1"),
    (lambda: FX.encode_progressive([np.full((16, 16), 9, np.uint8)], [(1, 1)], [([0], 0, 0, 0, 0),
                                                                                 ([0], 9, 3, 0, 0)]),
     "invalid progressive parameters Ss=9 Se=3"),
    (lambda: FX.encode_progressive([np.full((16, 16), 9, np.uint8)] * 3, [(1, 1)] * 3,
                                   [([0, 1, 2], 0, 0, 0, 0), ([0, 1], 1, 63, 0, 0)]),
     "invalid progressive parameters Ss=1 Se=63"),
    (lambda: FX.encode_progressive([np.full((16, 16), 9, np.uint8)] * 3 + [np.full((8, 8), 9, np.uint8)],
                                   [(2, 2), (2, 2), (2, 2), (1, 1)], [([0, 1, 2, 3], 0, 0, 0, 0)]),
     "sampling factors are too large for an interleaved scan"),
], ids=["dc-band-past-0", "al-14", "ah-not-al-plus-1", "ss-past-se", "ac-of-two-components",
        "13-blocks-an-mcu"])
def test_what_libjpeg_refuses_is_refused(data, match):
    """Scan parameters libjpeg refuses (jdphuff.c's JERR_BAD_PROGRESSION,
    with its words) and an interleaved MCU of more than 10 blocks: the port
    raises and so does PIL."""
    data = data()
    with pytest.raises(ValueError, match=match):
        decode_jpeg(data)
    with pytest.raises(OSError):
        _pil(data)


READ_WITHOUT_PIL = """
import importlib.util, hashlib, sys
sys.modules.update(PIL=None, jax=None, flax=None, mvd_tpu=None)
import numpy as np
from mvd_tpu_torch.utils.images import decode_image
spec = importlib.util.spec_from_file_location("fx", sys.argv[1] + "/make_fixtures.py")
fx = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fx)
for name in sys.argv[2:]:
    print(name, hashlib.sha256(decode_image(open(sys.argv[1] + "/" + name, "rb").read()).tobytes()).hexdigest())
rng = np.random.default_rng(0)
s = rng.integers(0, 65536, (33, 17, 4))
png = fx.encode_png(s, 16, 6, 1, filters=rng)
print("encoded", hashlib.sha256(decode_image(png).tobytes()).hexdigest(),
      hashlib.sha256((s[..., :3] >> 8).astype(np.uint8).tobytes()).hexdigest())
"""


def test_new_forms_read_without_pil_and_the_png_writer_needs_none():
    """In a process where PIL, JAX and the JAX package cannot be imported
    (the card's host): the new forms decode to PIL's digests, and the
    fixture script's ``encode_png`` (which ``chip_smoke.py`` loads there)
    writes a 16-bit interlaced RGBA PNG that decodes to its high bytes."""
    names = ["prog_dc_single.jpg", "ycck_22.jpg", "c6_d16_adam7.png", "c0_d2_adam7.png", "pil_i16.png"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", READ_WITHOUT_PIL, str(FIXTURES), *names], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.strip().splitlines())
    for name in names:
        assert lines[name] == DIGESTS[name]["sha256"], name
    got, want = lines["encoded"].split()
    assert got == want
