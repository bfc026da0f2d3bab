"""The port's zstd decoder (``csrc/zstd_decode.cpp`` through
``mvd_tpu_torch/checkpoint/zstd.py``) held to the ``zstandard`` package,
and its CRC-32C to the standard's check value and a bitwise reference.

The decoder is host code with no plain version: every case compares its
bytes with what ``zstandard`` compressed (hypothesis-drawn bytes, f32
arrays at levels -5, 1, 3 and 19 with and without a checksum and a
content size, several frames, skippable frames, a window larger than a
block), and every frame of the JAX-written fixtures
(``tests/fixtures/torch_port_orbax``) decodes to what ``zstandard`` gives.
Malformed, truncated and dictionary frames raise ``ValueError`` naming the
fault, and never return a short buffer.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import pytest
import zstandard
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from mvd_tpu_torch.checkpoint.ocdbt import BTREE_MAGIC, MANIFEST_MAGIC
from mvd_tpu_torch.checkpoint.zstd import crc32c, decompress

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_port_orbax")


def _compress(data: bytes, **kw) -> bytes:
    return zstandard.ZstdCompressor(**kw).compress(data)


def _f32(n: int, seed: int) -> bytes:
    """An f32 array as model weights look: little repetition, so the
    literals are Huffman-coded and the sequences few."""
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32).tobytes()


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=st.binary(min_size=1, max_size=4096), level=st.sampled_from([-5, 1, 3, 19]),
       checksum=st.booleans())
def test_decoder_equals_zstandard_on_drawn_bytes(data, level, checksum):
    frame = _compress(data, level=level, write_checksum=checksum)
    assert decompress(frame) == data
    out = np.empty(len(data), np.uint8)
    assert decompress(frame, out).tobytes() == data


@pytest.mark.parametrize("level", [-5, 1, 3, 19])
@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("content_size", [False, True])
def test_decoder_equals_zstandard_on_f32_arrays(level, checksum, content_size):
    for n, seed in ((1, 0), (97, 1), (3000, 2), (70_000, 3)):
        data = _f32(n, seed) + bytes(64) + _f32(n // 3, seed + 9)  # a zero run: RLE and matches
        frame = _compress(data, level=level, write_checksum=checksum, write_content_size=content_size)
        assert decompress(frame) == data, n


def test_repetitive_data_uses_repeat_offsets_and_rle_blocks():
    rng = np.random.default_rng(4)
    words = [rng.bytes(int(rng.integers(3, 9))) for _ in range(40)]
    text = b"".join(words[int(i)] for i in rng.integers(0, 40, 20_000))
    for data in (text, bytes(300_000), b"ab" * 100_000, text[:5000] * 30):
        for level in (-5, 1, 19):
            assert decompress(_compress(data, level=level)) == data


def test_several_frames_skippable_frames_and_a_window_past_a_block():
    parts = [_f32(1000, 5), b"x" * 777, _f32(50_000, 6)]
    skip = struct.pack("<II", 0x184D2A53, 5) + b"12345"
    frames = skip + b"".join(_compress(p, level=3) + skip for p in parts)
    assert decompress(frames) == b"".join(parts)
    # 1 MiB with long-range repeats: matches reach back past one 128 KiB
    # block, inside the frame's window, and the stream has no content size
    big = _f32(60_000, 7)
    big = (big + big[:100_000]) * 4
    params = zstandard.ZstdCompressionParameters.from_level(19, window_log=21)
    cobj = zstandard.ZstdCompressor(compression_params=params).compressobj()
    frame = cobj.compress(big) + cobj.flush()
    header = frame[4]
    assert not header & 0xC0 and not header & 0x20  # no content size, not single segment
    assert decompress(frame) == big


def _fixture_frames():
    """Every zstd frame of the JAX-written fixtures: the bodies of each
    OCDBT manifest and node (found by their magic) and every zarr chunk."""
    from mvd_tpu_torch.checkpoint.ocdbt import OcdbtStore

    frames = []
    for d, _, names in os.walk(FIXTURES):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                blob = f.read()
            pos = 0
            while pos + 14 <= len(blob):
                magic = struct.unpack(">I", blob[pos:pos + 4])[0]
                if magic not in (MANIFEST_MAGIC, BTREE_MAGIC):
                    break
                length = struct.unpack("<Q", blob[pos + 4:pos + 12])[0]
                frames.append(blob[pos + 14:pos + length - 4])
                pos += length
            if n == "manifest.ocdbt" and os.path.basename(d) != "ocdbt.process_0":
                store = OcdbtStore(d)
                frames += [store.read(k) for k in store.list() if not k.endswith(b".zarray")]
    return frames


def test_every_frame_of_a_jax_written_dir_decodes():
    frames = _fixture_frames()
    assert len(frames) > 40
    for frame in frames:
        assert frame[:4] == b"\x28\xb5\x2f\xfd"
        assert decompress(frame) == zstandard.ZstdDecompressor().decompress(frame, max_output_size=1 << 24)


def test_malformed_truncated_and_dictionary_frames_raise():
    data = _f32(20_000, 8) + bytes(1000)
    frame = _compress(data, level=3, write_checksum=True)
    # every truncation raises; none returns a short buffer
    for cut in sorted({1, 3, 4, 5, 8, 13, 20, len(frame) // 2, len(frame) - 5, len(frame) - 1}):
        with pytest.raises(ValueError, match="zstd"):
            decompress(frame[:cut])
    with pytest.raises(ValueError, match="not a zstd frame"):
        decompress(b"\x00" + frame)
    with pytest.raises(ValueError, match="empty"):
        decompress(b"")
    reserved = bytearray(frame)
    reserved[4] |= 0x08
    with pytest.raises(ValueError, match="reserved bit"):
        decompress(bytes(reserved))
    with pytest.raises(ValueError, match="checksum"):
        decompress(frame[:-4] + bytes(a ^ 0xFF for a in frame[-4:]))
    # a damaged body raises (checksum, or a structure that does not parse)
    for i in range(20, len(frame) - 4, max(1, len(frame) // 40)):
        bad = bytearray(frame)
        bad[i] ^= 0x5A
        with pytest.raises(ValueError):
            decompress(bytes(bad))
    # a frame that needs a dictionary
    zdict = zstandard.train_dictionary(4096, [_f32(64, s) + b"common prefix of each sample" for s in range(200)])
    dframe = zstandard.ZstdCompressor(dict_data=zdict).compress(b"common prefix of each sample" * 3)
    with pytest.raises(ValueError, match="dictionary ID"):
        decompress(dframe)
    # the caller's size is exact: short and long buffers raise
    with pytest.raises(ValueError, match="expected"):
        decompress(frame, np.empty(len(data) + 1, np.uint8))
    with pytest.raises(ValueError, match="past the caller's buffer"):
        decompress(frame, np.empty(len(data) - 1, np.uint8))
    # a declared content size the blocks do not fill
    short = _compress(b"abcdef" * 50, level=1)
    grown = bytearray(short)
    assert grown[4] & 0x20  # single segment: the size is the byte after the descriptor
    grown[5] += 1
    with pytest.raises(ValueError, match="content|past|offset"):
        decompress(bytes(grown))


def _crc32c_bitwise(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c ^= b
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
    return c ^ 0xFFFFFFFF


def test_crc32c_matches_the_check_value_and_a_bitwise_reference():
    assert crc32c(b"123456789") == 0xE3069283
    rng = np.random.default_rng(9)
    for n in (0, 1, 7, 8, 9, 63, 1000):
        data = rng.bytes(n)
        assert crc32c(data) == _crc32c_bitwise(data), n
