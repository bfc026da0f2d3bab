"""The port's image readers on the forms the JAX package reads through PIL
beyond sequential JPEG and 8-bit PNG: progressive JPEG and 4-component
(CMYK, YCCK) JPEG, libjpeg's block smoothing of progressive files,
arithmetic-coded (SOF9, SOF10) and lossless (SOF3) JPEG
(``csrc/jpeg_decode.cpp``), PNG at every bit depth of every colour type,
interlaced or not (``utils/images.py:decode_png``, ``csrc/png_decode.cpp``).

Bars: every decode bitwise PIL 12.1.0's (libjpeg-turbo 3.1.3)
``convert("RGB")``, and the data loaders' white composite bitwise PIL's
``alpha_composite`` where PIL opens the file as RGBA, on every fixture
(``tests/fixtures/torch_port_images``, written by ``make_fixtures.py``
there) both by PIL here and by the stored digest, and on hypothesis-drawn
files; ``load_image``, the server's upload decode and the Objaverse
loader's decode bitwise the JAX functions at the image's size and within
one level of 255 where they resize (the port's Lanczos; the count of
values that differ is asserted). PIL's decode of each arithmetic fixture is
PIL's decode of its Huffman twin (the same coefficients and scan script),
which holds the fixture encoder without the port; each lossless fixture
decodes to its source samples. Seeded random files of the three new forms
decode as PIL decodes them, or are refused where PIL refuses them; every
form PIL refuses is refused, naming the form, where PIL raises. The IDCT is
libjpeg-turbo's SIMD one, which PIL runs: 28 Huffman files read as
arithmetic-coded (garbage coefficients at its 16-bit edges) and one-block
files at each of its 16-bit steps decode as PIL decodes them.
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
DECODED = sorted(DIGESTS)
SMOOTHED = sorted(n for n in DIGESTS if "smooth" in n)
ARITHMETIC = sorted(n for n, d in DIGESTS.items() if "huffman_twin" in d)
LOSSLESS = sorted(n for n in DIGESTS if n.startswith("lossless_"))
# the digests of PIL's decodes that were stored for these files before the
# port read them: the port reaches the same
SMOOTHED_BEFORE = {
    "smooth_ac6_unsent.jpg": "5dc3950dfa1b52a85cc038d67f30adb31314586c5dcddc0813a4cb1dd99a252b",
    "smooth_ac_al1.jpg": "7733716b3333a32aa6716a0ba5e31fe3b9bd155b79de75136aded42e29dff111",
    "smooth_chroma.jpg": "cfdace48a3fdf747cbe4125db9cf018a25b5b67b3708a465c83c12b13fa7c418",
    "smooth_dc_only.jpg": "d1bedb30544339a0ef059bf0a35b83b67863951ce1da8e12c3bbacb515e3f781"}
SEQUENTIAL_FIXTURES = REPO / "tests" / "fixtures" / "torch_port_jpeg"
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


def _frame_marker(data: bytes) -> int:
    """The second byte of a JPEG's frame header marker, by its segments."""
    pos = 2
    while data[pos + 1] in (0xC4, 0xCC, 0xDB, 0xDD, 0xFE) or 0xE0 <= data[pos + 1] <= 0xEF:
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
    return data[pos + 1]


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


@pytest.mark.parametrize("name", SMOOTHED)
def test_block_smoothed_files_are_refused(name):
    """Scans that leave some of AC coefficients 1-9 unrefined (a DC-only
    file, AC at Al 1 or 2, AC 6-63 never sent, chroma never given AC;
    components two blocks wide, 4:2:0 and 4:4:0 with a short last iMCU row,
    CMYK, a 1x1 image, arithmetic-coded; CO3D's 1067x800 frame): libjpeg
    decodes them with block smoothing, and the port's decode is PIL's,
    bitwise, by PIL here and by the stored digest; the four files whose
    digests were stored before the port read them keep those digests."""
    data = (FIXTURES / name).read_bytes()
    got = decode_jpeg(data)
    np.testing.assert_array_equal(got, _pil(data))
    assert _sha(got) == DIGESTS[name]["sha256"]
    if name in SMOOTHED_BEFORE:
        assert DIGESTS[name]["sha256"] == SMOOTHED_BEFORE[name]


@pytest.mark.parametrize("name", ARITHMETIC)
def test_arithmetic_fixtures_are_their_huffman_twins(name):
    """SOF9 (one interleaved scan, one scan a component, restarts, DAC
    conditioning of tables 0-5, RGB ids, CMYK) and SOF10 (full scripts,
    successive approximation, restarts, YCCK, block-smoothed scripts):
    PIL decodes the file to the pixels of its Huffman twin, and the port
    decodes it to PIL's digest."""
    data = (FIXTURES / name).read_bytes()
    twin = (FIXTURES / DIGESTS[name]["huffman_twin"]).read_bytes()
    np.testing.assert_array_equal(_pil(data), _pil(twin))
    assert _frame_marker(data) in (0xC9, 0xCA)
    assert _sha(decode_jpeg(data)) == DIGESTS[name]["sha256"]


def test_arithmetic_decoder_gives_up_as_libjpeg_does():
    """A sequential arithmetic file with a bad code (AC decisions that run
    past coefficient 63) in the first restart interval: libjpeg gives up on
    the rest of the interval and resumes at the next; the port's decode is
    PIL's, and not the decode of the same file without the bad code."""
    data = (FIXTURES / "arith_gives_up.jpg").read_bytes()
    got = decode_jpeg(data)
    np.testing.assert_array_equal(got, _pil(data))
    assert _sha(got) == DIGESTS["arith_gives_up.jpg"]["sha256"]
    planes, sampling = FX._420(FX.seq.photo(37, 53, 3, seed=51))
    assert not np.array_equal(got, decode_jpeg(FX.encode_arithmetic(planes, sampling, restart=3)))


@pytest.mark.parametrize("name", LOSSLESS)
def test_lossless_fixtures_decode_to_their_source(name):
    """SOF3: every predictor, point transforms 1, 2 and 7 (and one a scan),
    restarts, sampling factors interleaved and one scan a component (a
    restart every row), gray, RGB (by ids R, G, B, by ids 1, 2, 3 and by Adobe's
    transform 0), CMYK, a difference of category 16: the port's decode is
    PIL's and, but for CMYK, the source samples shifted by Pt (replicated
    where subsampled)."""
    data = (FIXTURES / name).read_bytes()
    assert _frame_marker(data) == 0xC3
    got = decode_jpeg(data)
    np.testing.assert_array_equal(got, _pil(data))
    want = DIGESTS[name]
    assert _sha(got) == want["sha256"] == want.get("source_sha256", want["sha256"])


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


SAMPLINGS = [[(1, 1)], [(2, 2)], [(1, 1)] * 3, [(2, 2), (1, 1), (1, 1)], [(2, 1), (1, 1), (1, 1)],
             [(1, 2), (1, 1), (1, 1)], [(2, 2), (1, 2), (2, 1)], [(4, 1), (1, 1), (1, 1)], [(1, 1)] * 4,
             [(2, 2), (1, 1), (1, 1), (2, 2)]]


def _random_planes(rng, sampling):
    """Gradients plus noise of a random strength, each component at its
    sampled size of a random image of 1-47 pixels a side."""
    h, w = (int(x) for x in rng.integers(1, 48, 2))
    hmax = max(a for a, _ in sampling)
    vmax = max(b for _, b in sampling)
    planes = []
    for k, (a, b) in enumerate(sampling):
        y, x = np.mgrid[:-(-h * b // vmax), :-(-w * a // hmax)]
        noise = rng.integers(0, rng.integers(1, 200), x.shape)
        planes.append(((rng.integers(1, 6) * x + rng.integers(1, 6) * y + 40 * k + noise) % 256).astype(np.uint8))
    return planes


def _random_script(rng, nc: int, complete: float):
    """A progressive script libjpeg accepts: DC interleaved or not, AC bands
    of random width and Al refined by one bit a scan; unless ``complete``
    (drawn), bands go unsent and refinements stop early."""
    full = rng.random() < complete
    dc_al = int(rng.integers(0, 3))
    every = list(range(nc))
    script = [(every, 0, 0, 0, dc_al)] if rng.random() < 0.6 else [([c], 0, 0, 0, dc_al) for c in every]
    for c in every:
        k = 1
        while k <= 63:
            se = min(63, k + int(rng.integers(0, 20)))
            if full or rng.random() > 0.25:
                al = int(rng.integers(0, 3))
                script.append(([c], k, se, 0, al))
                script += [([c], k, se, a, a - 1) for a in range(al, 0 if full else int(rng.integers(0, al + 1)), -1)]
            k = se + 1
    script += [(every, 0, 0, a, a - 1) for a in range(dc_al, 0 if full else int(rng.integers(0, dc_al + 1)), -1)]
    return script


def _random_file(form: str, seed: int) -> bytes:
    """A seeded random file of ``form``: a progressive script that leaves
    coefficients unrefined or unsent ("smoothing"; some with a zero
    quantizer among the first ten), an arithmetic-coded one (sequential,
    one scan a component, or progressive; random DAC conditioning), or a
    lossless one (any predictor, interleaved or one scan a component with
    a point transform each, differences of category 16 now and then);
    restarts throughout."""
    rng = np.random.default_rng(seed)
    sampling = SAMPLINGS[int(rng.integers(len(SAMPLINGS)))]
    nc = len(sampling)
    planes = _random_planes(rng, sampling)
    kw = dict(adobe=int(rng.choice([0, 2])), jfif=False) if nc == 4 else {}
    if form == "lossless":
        psv, interleaved = int(rng.integers(1, 8)), bool(rng.random() < 0.6)
        pt = [int(x) for x in rng.integers(0, 8, nc)] if not interleaved else [int(rng.integers(0, 8))] * nc
        samples = [p.astype(np.int64) >> t for p, t in zip(planes, pt)]
        if rng.random() < 0.2:
            c = int(rng.integers(nc))
            samples[c][tuple(int(rng.integers(n)) for n in samples[c].shape)] += 32768
        if nc == 3:
            kw["ids"] = [82, 71, 66] if rng.random() < 0.5 else [1, 2, 3]
        return FX.encode_lossless(samples, sampling, psv, pt, restart_rows=int(rng.integers(0, 4)),
                                  interleaved=interleaved, **kw)
    q = [rng.integers(1, 30, 64)] * nc
    if form == "smoothing" and rng.random() < 0.15:
        q[0] = q[0].copy()
        q[0][int(rng.choice([0, 1, 8, 16, 9, 2]))] = 0
    restart = int(rng.choice([0, 0, 1, 2, 5]))
    if form == "smoothing":
        return FX.encode_progressive(planes, sampling, _random_script(rng, nc, 0.3), q=q, restart=restart,
                                     seed=seed, **kw)
    dac = {}
    for t in range(2):
        low = int(rng.integers(0, 6))
        dac[(0, t)] = (int(rng.integers(low, 16)) << 4) | low
        dac[(1, t)] = int(rng.integers(0, 64))
    draw = rng.random()
    scans = None if draw < 0.2 else [([c], 0, 63, 0, 0) for c in range(nc)] if draw < 0.35 else \
        _random_script(rng, nc, 0.5)
    return FX.encode_arithmetic(planes, sampling, scans, q=q, restart=restart, dac=dac, **kw)


def _pil_or_refusal(data: bytes):
    try:
        return _pil(data)
    except OSError as e:
        return e


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2**32 - 1))
@pytest.mark.parametrize("form", ["smoothing", "arithmetic", "lossless"])
def test_random_files_of_the_new_forms_decode_as_pil(form, seed):
    """The port decodes each file bitwise as PIL does, or refuses it where
    PIL raises (a lossless file in YCCK)."""
    data = _random_file(form, seed)
    want = _pil_or_refusal(data)
    if isinstance(want, OSError):
        with pytest.raises(ValueError):
            decode_jpeg(data)
    else:
        np.testing.assert_array_equal(decode_jpeg(data), want)


# ---------------------------------------- the SIMD IDCT (fault 12)

# every Huffman fixture of torch_port_jpeg and eight of these, read as
# arithmetic-coded (frame marker set to SOF9, or SOF10 for a progressive
# file): PIL's libjpeg-turbo decodes the garbage coefficients this gives
# (or gives up on a bad code), which reach its 16-bit SIMD IDCT's edges
ARITH_READS = [("torch_port_jpeg", n) for n in sorted(os.listdir(SEQUENTIAL_FIXTURES)) if n.endswith(".jpg")] + [
    ("torch_port_images", n) for n in ("frame_a_prog.jpg", "frame_a_smooth.jpg", "prog_420_opt.jpg", "prog_gray.jpg",
                                       "prog_444.jpg", "cmyk_prog.jpg", "ycck_22.jpg", "smooth_chroma.jpg")]


def _read_as_arithmetic(folder: str, name: str) -> bytes:
    data = bytearray((REPO / "tests" / "fixtures" / folder / name).read_bytes())
    marker = _frame_marker(bytes(data))
    data[data.index(bytes([0xFF, marker])) + 1] = {0xC0: 0xC9, 0xC1: 0xC9, 0xC2: 0xCA}[marker]
    return bytes(data)


@pytest.mark.parametrize("folder,name", ARITH_READS, ids=[f"{f[11:]}-{n}" for f, n in ARITH_READS])
def test_huffman_files_read_as_arithmetic_are_pil(folder, name):
    """Fault 12: the 28 files decode bitwise as PIL decodes them (and the
    port refuses none that PIL reads)."""
    assert len(ARITH_READS) == 28
    data = _read_as_arithmetic(folder, name)
    np.testing.assert_array_equal(decode_jpeg(data), _pil(data))


def _one_block(zz, q, q16: bool = False) -> bytes:
    """A gray 8x8 progressive JPEG of one block: ``zz`` its 64 quantized
    coefficients in zigzag order, ``q`` the natural-order table; with
    ``q16`` the table is a 16-bit DQT (Pq=1)."""
    coefs = [np.asarray(zz, np.int64).reshape(1, 1, 64)]
    data = FX.encode_progressive([np.zeros((8, 8), np.uint8)], [(1, 1)], [([0], 0, 0, 0, 0), ([0], 1, 63, 0, 0)],
                                 q=[np.ones(64, np.int64) if q16 else np.asarray(q)], coefs=coefs)
    if q16:
        at = data.index(b"\xff\xdb")
        size = struct.unpack(">H", data[at + 2:at + 4])[0]
        dqt = b"\xff\xdb" + struct.pack(">HB", 2 + 1 + 128, 0x10) + b"".join(
            struct.pack(">H", int(v)) for v in np.asarray(q)[FX.ZIGZAG])
        data = data[:at] + dqt + data[at + 2 + size:]
    return data


def _zz(values: dict) -> list:
    return [values.get(i, 0) for i in range(64)]


def _q(values: dict, fill: int = 1) -> np.ndarray:
    q = np.full(64, fill, np.int64)
    for k, v in values.items():
        q[k] = v
    return q


@pytest.mark.parametrize("zz,q,q16,first_row", [
    (_zz({1: 40}), _q({1: 1000}), True, [255] * 4 + [0] * 4),  # 40000 wraps in 16 bits (pmullw)
    (_zz({0: 100}), _q({0: 90}), False, [0] * 8),  # DC-only block: 9000 << 2 wraps (psllw)
    (_zz({0: 100, 2: 1}), _q({0: 90}), False, [255] * 8),  # the same DC in a full pass 1 saturates
    (_zz({0: 48}), _q({0: 100}), False, [255] * 8),  # an output of 600 saturates, not wraps
    (_zz({0: -48}), _q({0: 100}), False, [0] * 8),  # and one of -600
    (_zz({0: 1000, 3: 1000, 9: 1000, 10: 1000}), _q({}, 30), False, None),  # in0+in4, in3+in7 wrap
], ids=["16-bit-dqt-product", "dc-only-shortcut", "dc-full-pass-saturates", "output-past-plus-128",
        "output-past-minus-128", "16-bit-sums"])
def test_idct_edges_are_libjpeg_turbo_simd(zz, q, q16, first_row):
    """One-block files at each 16-bit step of libjpeg-turbo's SIMD islow
    IDCT, which PIL runs: the port decodes each as PIL does."""
    data = _one_block(zz, q, q16)
    want = _pil(data)
    np.testing.assert_array_equal(decode_jpeg(data), want)
    if first_row is not None:
        assert want[0, :, 0].tolist() == first_row


# ------------------------------------------------- the JAX package's paths


# one of each new form; the LA and 16-bit RGBA images go through the
# loader's composite (PIL opens 16-bit gray+alpha as RGBA, 8-bit as LA)
FORMS = ["prog_420.jpg", "prog_gray_script.jpg", "cmyk_prog.jpg", "ycck.jpg", "c0_d16.png",
         "c0_d1_adam7.png", "c3_d4_adam7.png", "c4_d8_adam7.png", "c4_d16.png", "c6_d16_adam7.png",
         "smooth_chroma.jpg", "arith_prog_420.jpg", "arith_seq_420_rst.jpg", "lossless_rgb_sub_rst.jpg"]


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


def _marker_set(name: str, old: int, new: int, folder=FIXTURES) -> bytes:
    """A fixture with its frame header marker 0xFF<old> turned into <new>."""
    data = bytearray((folder / name).read_bytes())
    assert _frame_marker(bytes(data)) == old
    data[data.index(bytes([0xFF, old])) + 1] = new
    return bytes(data)


def _frame_bytes_set(name: str, values: dict, folder=FIXTURES) -> bytes:
    """A fixture with bytes of its frame header's body set: {offset: value}
    (0: the precision, 1-2: the height)."""
    data = bytearray((folder / name).read_bytes())
    at = data.index(bytes([0xFF, _frame_marker(bytes(data))])) + 4
    for offset, value in values.items():
        data[at + offset] = value
    return bytes(data)


def _across_pil_block(name: str) -> bytes:
    """An arithmetic fixture behind a comment segment that puts its scan
    across byte 65536, where PIL's first read of 65536 bytes ends."""
    data = (FIXTURES / name).read_bytes()
    at = data.index(b"\xff\xda")
    pad = 65536 - at - 20
    return data[:2] + struct.pack(">BBH", 0xFF, 0xFE, pad - 2) + bytes(pad - 4) + data[2:]


def _lossless(nc: int = 3, **kw) -> bytes:
    g = np.arange(12 * 10).reshape(12, 10) % 251
    return FX.encode_lossless([g, g // 2, 255 - g, g // 3][:nc], [(1, 1)] * nc, 1, **kw)


@pytest.mark.parametrize("data,match", [
    (lambda: _frame_bytes_set("s444.jpg", {0: 12}, SEQUENTIAL_FIXTURES), r"12-bit JPEG \(SOF0\)"),
    (lambda: _frame_bytes_set("s444.jpg", {1: 0, 2: 0}, SEQUENTIAL_FIXTURES), r"DNL marker \(height 0\)"),
    (lambda: _marker_set("s444.jpg", 0xC0, 0xC5, SEQUENTIAL_FIXTURES), r"hierarchical JPEG \(SOF5\)"),
    (lambda: _marker_set("prog_444.jpg", 0xC2, 0xC6), r"hierarchical JPEG \(SOF6\)"),
    (lambda: _marker_set("lossless_gray_p1.jpg", 0xC3, 0xC7), r"hierarchical JPEG \(SOF7\)"),
    (lambda: _marker_set("arith_seq_gray.jpg", 0xC9, 0xCD), r"hierarchical JPEG \(SOF13\)"),
    (lambda: _marker_set("arith_prog_420.jpg", 0xCA, 0xCE), r"hierarchical JPEG \(SOF14\)"),
    (lambda: _marker_set("lossless_gray_p1.jpg", 0xC3, 0xCF), r"hierarchical JPEG \(SOF15\)"),
    (lambda: _marker_set("lossless_gray_p1.jpg", 0xC3, 0xCB), r"lossless arithmetic-coded JPEG \(SOF11\)"),
    (lambda: _lossless(jfif=True), r"lossless JPEG in the YCbCr colour space"),
    (lambda: _lossless(adobe=1), r"lossless JPEG in the YCbCr colour space"),
    (lambda: _lossless(4, adobe=2), r"lossless JPEG in the YCCK colour space"),
    (lambda: _frame_bytes_set("lossless_gray_p1.jpg", {0: 12}), r"12-bit lossless JPEG \(SOF3\)"),
    (lambda: _frame_bytes_set("lossless_gray_p1.jpg", {0: 16}), r"16-bit lossless JPEG \(SOF3\)"),
    (lambda: _across_pil_block("arith_seq_420_rst.jpg"), r"arithmetic-coded JPEG whose scan reads byte"),
    (lambda: _across_pil_block("arith_prog_rst.jpg"), r"arithmetic-coded JPEG whose scan reads byte"),
], ids=["12-bit", "dnl-height-0", "sof5", "sof6", "sof7", "sof13", "sof14", "sof15", "sof11", "lossless-jfif-ycbcr",
        "lossless-adobe-ycbcr", "lossless-ycck", "lossless-12-bit", "lossless-16-bit",
        "arithmetic-across-pil-block", "arithmetic-progressive-across-pil-block"])
def test_what_pil_refuses_is_refused(data, match):
    """Each form PIL 12.1.0 (libjpeg-turbo 3.1.3) refuses: PIL raises on
    these bytes, and the port's ``ValueError`` names the form. The
    hierarchical and SOF11 files are fixtures of the non-differential
    process with their frame marker changed (libjpeg refuses the marker
    before reading a scan); an arithmetic scan that reads past the 65536
    bytes PIL has handed libjpeg is refused as PIL refuses it."""
    data = data()
    with pytest.raises(OSError):
        _pil(data)
    with pytest.raises(ValueError, match=match):
        decode_jpeg(data)


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
pixels = rng.integers(0, 256, (21, 35, 3)).astype(np.uint8)
forms = fx.frame_forms(pixels)
print("arithmetic", hashlib.sha256(decode_image(forms["arithmetic"]).tobytes()).hexdigest(),
      hashlib.sha256(decode_image(forms["huffman"]).tobytes()).hexdigest())
print("lossless", hashlib.sha256(decode_image(forms["lossless"]).tobytes()).hexdigest(),
      hashlib.sha256(pixels.tobytes()).hexdigest())
"""


def test_new_forms_read_without_pil_and_the_png_writer_needs_none():
    """In a process where PIL, JAX and the JAX package cannot be imported
    (the card's host): the new forms decode to PIL's digests, the fixture
    script's ``encode_png`` (which ``chip_smoke.py`` loads there) writes a
    16-bit interlaced RGBA PNG that decodes to its high bytes, and its
    ``frame_forms`` (phase 9d's) writes an arithmetic-coded JPEG that
    decodes to its Huffman twin's pixels and a lossless one that decodes to
    its source."""
    names = ["prog_dc_single.jpg", "ycck_22.jpg", "c6_d16_adam7.png", "c0_d2_adam7.png", "pil_i16.png",
             "smooth_440_rows.jpg", "arith_prog_rst.jpg", "lossless_420_scans_rst.jpg"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", READ_WITHOUT_PIL, str(FIXTURES), *names], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = dict(line.split(" ", 1) for line in proc.stdout.strip().splitlines())
    for name in names:
        assert lines[name] == DIGESTS[name]["sha256"], name
    for key in ("encoded", "arithmetic", "lossless"):
        got, want = lines[key].split()
        assert got == want, key
