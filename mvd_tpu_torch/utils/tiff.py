"""TIFF as PIL 12.1.0 reads it, without PIL (host: the standard library,
numpy, ``utils/tiff_codecs.py``, ``csrc/tiff_decode.cpp``,
``csrc/jpeg_decode.cpp`` and ``csrc/zstd_decode.cpp``).

``decode_tiff`` reads a classic or BigTIFF file's first IFD, byte order II
or MM, as ``TiffImagePlugin`` does (``ImageFileDirectory_v2.load``,
``TiffImageFile._setup``), takes PIL's mode and rawmode from ``OPEN_INFO``
(PIL's table, copied here) and decodes the image along one of PIL's paths:

* uncompressed: PIL's own tiles, one a strip or tile in file order, each
  read by PIL's raw decoder from its offset on (the byte counts unread; a
  tile's rows its full width apart; under planar configuration 2 one
  character of the rawmode a plane, as PIL takes it); a file opened by path
  whose one tile PIL memory-maps is read as the map reads it (``from_path``,
  ROADMAP Queue 3, fault 13);
* compressed: PIL hands the file to libtiff 4.7.1, which decodes whole
  strips or tiles by its own reading of the IFD (FillOrder 2, the
  predictors, the byte order; byte counts it lacks estimated as
  ``EstimateStripByteCounts`` estimates them) and PIL unpacks them with
  its rawmode (16-bit rawmodes in native order; planar files through PIL's
  band unpackers): PackBits, LZW (new and old-style codes), deflate (8 and
  32946, Python's zlib), LZMA (34925, Python's lzma), zstd (50000,
  ``csrc/zstd_decode.cpp``) and JPEG (7: YCbCr converted to RGB by
  libjpeg, every other photometric unconverted; ``tiff_codecs``);
* YCbCr but contiguous JPEG, and old-style JPEG (6) in its
  JPEGInterchangeFormat form: libtiff's RGBA path (``_decode_ycbcr``),
  its integer YCbCr tables and chroma replicated over each subsampling
  unit; a strip or tile whose data end early read on past as that path
  reads it (the bytes decoded, zeros after them).

LAB (photometric 8) is read into PIL's mode LAB and converted by
``utils/lcms.py`` as PIL's LittleCMS converts it. EXIF orientation 2-8 is
applied as ``TiffImageFile.load_end`` applies it. What PIL reads and this
reader does not is refused with ``ValueError`` naming the form and ROADMAP
item 13c: CCITT (2, 3, 4, 32771), ThunderScan, SGILog, old-style JPEG with
its tables in tags 519-521, in several strips or not YCbCr, planar YCbCr, a JPEG
strip shorter than its segment, and strips that libjpeg, liblzma or
libzstd read on past damage in. WebP (50001) is refused as PIL refuses it
(its libtiff has no WebP codec). A planar palette tile with an extra
sample, whose pixels PIL reads past its buffer, is refused naming Queue 3,
fault 14.
"""
from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from . import tiff_codecs
from .images import MAPMODES, MAX_PIXELS, PilImage, pil_mapped
from .tiff_codecs import not_read

II, MM = b"II", b"MM"

# TiffImagePlugin.OPEN_INFO: (byte order, photometric, sample format, fill
# order, bits per sample, extra samples) -> (mode, rawmode)
OPEN_INFO = {
    (II, 0, (1,), 1, (1,), ()): ("1", "1;I"),
    (MM, 0, (1,), 1, (1,), ()): ("1", "1;I"),
    (II, 0, (1,), 2, (1,), ()): ("1", "1;IR"),
    (MM, 0, (1,), 2, (1,), ()): ("1", "1;IR"),
    (II, 1, (1,), 1, (1,), ()): ("1", "1"),
    (MM, 1, (1,), 1, (1,), ()): ("1", "1"),
    (II, 1, (1,), 2, (1,), ()): ("1", "1;R"),
    (MM, 1, (1,), 2, (1,), ()): ("1", "1;R"),
    (II, 0, (1,), 1, (2,), ()): ("L", "L;2I"),
    (MM, 0, (1,), 1, (2,), ()): ("L", "L;2I"),
    (II, 0, (1,), 2, (2,), ()): ("L", "L;2IR"),
    (MM, 0, (1,), 2, (2,), ()): ("L", "L;2IR"),
    (II, 1, (1,), 1, (2,), ()): ("L", "L;2"),
    (MM, 1, (1,), 1, (2,), ()): ("L", "L;2"),
    (II, 1, (1,), 2, (2,), ()): ("L", "L;2R"),
    (MM, 1, (1,), 2, (2,), ()): ("L", "L;2R"),
    (II, 0, (1,), 1, (4,), ()): ("L", "L;4I"),
    (MM, 0, (1,), 1, (4,), ()): ("L", "L;4I"),
    (II, 0, (1,), 2, (4,), ()): ("L", "L;4IR"),
    (MM, 0, (1,), 2, (4,), ()): ("L", "L;4IR"),
    (II, 1, (1,), 1, (4,), ()): ("L", "L;4"),
    (MM, 1, (1,), 1, (4,), ()): ("L", "L;4"),
    (II, 1, (1,), 2, (4,), ()): ("L", "L;4R"),
    (MM, 1, (1,), 2, (4,), ()): ("L", "L;4R"),
    (II, 0, (1,), 1, (8,), ()): ("L", "L;I"),
    (MM, 0, (1,), 1, (8,), ()): ("L", "L;I"),
    (II, 0, (1,), 2, (8,), ()): ("L", "L;IR"),
    (MM, 0, (1,), 2, (8,), ()): ("L", "L;IR"),
    (II, 1, (1,), 1, (8,), ()): ("L", "L"),
    (MM, 1, (1,), 1, (8,), ()): ("L", "L"),
    (II, 1, (2,), 1, (8,), ()): ("L", "L"),
    (MM, 1, (2,), 1, (8,), ()): ("L", "L"),
    (II, 1, (1,), 2, (8,), ()): ("L", "L;R"),
    (MM, 1, (1,), 2, (8,), ()): ("L", "L;R"),
    (II, 1, (1,), 1, (12,), ()): ("I;16", "I;12"),
    (II, 0, (1,), 1, (16,), ()): ("I;16", "I;16"),
    (II, 1, (1,), 1, (16,), ()): ("I;16", "I;16"),
    (MM, 1, (1,), 1, (16,), ()): ("I;16B", "I;16B"),
    (II, 1, (1,), 2, (16,), ()): ("I;16", "I;16R"),
    (II, 1, (2,), 1, (16,), ()): ("I", "I;16S"),
    (MM, 1, (2,), 1, (16,), ()): ("I", "I;16BS"),
    (II, 0, (3,), 1, (32,), ()): ("F", "F;32F"),
    (MM, 0, (3,), 1, (32,), ()): ("F", "F;32BF"),
    (II, 1, (1,), 1, (32,), ()): ("I", "I;32N"),
    (II, 1, (2,), 1, (32,), ()): ("I", "I;32S"),
    (MM, 1, (2,), 1, (32,), ()): ("I", "I;32BS"),
    (II, 1, (3,), 1, (32,), ()): ("F", "F;32F"),
    (MM, 1, (3,), 1, (32,), ()): ("F", "F;32BF"),
    (II, 1, (1,), 1, (8, 8), (2,)): ("LA", "LA"),
    (MM, 1, (1,), 1, (8, 8), (2,)): ("LA", "LA"),
    (II, 2, (1,), 1, (8, 8, 8), ()): ("RGB", "RGB"),
    (MM, 2, (1,), 1, (8, 8, 8), ()): ("RGB", "RGB"),
    (II, 2, (1,), 2, (8, 8, 8), ()): ("RGB", "RGB;R"),
    (MM, 2, (1,), 2, (8, 8, 8), ()): ("RGB", "RGB;R"),
    (II, 2, (1,), 1, (8, 8, 8, 8), ()): ("RGBA", "RGBA"),
    (MM, 2, (1,), 1, (8, 8, 8, 8), ()): ("RGBA", "RGBA"),
    (II, 2, (1,), 1, (8, 8, 8, 8), (0,)): ("RGB", "RGBX"),
    (MM, 2, (1,), 1, (8, 8, 8, 8), (0,)): ("RGB", "RGBX"),
    (II, 2, (1,), 1, (8, 8, 8, 8, 8), (0, 0)): ("RGB", "RGBXX"),
    (MM, 2, (1,), 1, (8, 8, 8, 8, 8), (0, 0)): ("RGB", "RGBXX"),
    (II, 2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0)): ("RGB", "RGBXXX"),
    (MM, 2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0)): ("RGB", "RGBXXX"),
    (II, 2, (1,), 1, (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"),
    (MM, 2, (1,), 1, (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"),
    (II, 2, (1,), 1, (8, 8, 8, 8, 8), (1, 0)): ("RGBA", "RGBaX"),
    (MM, 2, (1,), 1, (8, 8, 8, 8, 8), (1, 0)): ("RGBA", "RGBaX"),
    (II, 2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0)): ("RGBA", "RGBaXX"),
    (MM, 2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0)): ("RGBA", "RGBaXX"),
    (II, 2, (1,), 1, (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"),
    (MM, 2, (1,), 1, (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"),
    (II, 2, (1,), 1, (8, 8, 8, 8, 8), (2, 0)): ("RGBA", "RGBAX"),
    (MM, 2, (1,), 1, (8, 8, 8, 8, 8), (2, 0)): ("RGBA", "RGBAX"),
    (II, 2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0)): ("RGBA", "RGBAXX"),
    (MM, 2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0)): ("RGBA", "RGBAXX"),
    (II, 2, (1,), 1, (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"),
    (MM, 2, (1,), 1, (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"),
    (II, 2, (1,), 1, (16, 16, 16), ()): ("RGB", "RGB;16L"),
    (MM, 2, (1,), 1, (16, 16, 16), ()): ("RGB", "RGB;16B"),
    (II, 2, (1,), 1, (16, 16, 16, 16), ()): ("RGBA", "RGBA;16L"),
    (MM, 2, (1,), 1, (16, 16, 16, 16), ()): ("RGBA", "RGBA;16B"),
    (II, 2, (1,), 1, (16, 16, 16, 16), (0,)): ("RGB", "RGBX;16L"),
    (MM, 2, (1,), 1, (16, 16, 16, 16), (0,)): ("RGB", "RGBX;16B"),
    (II, 2, (1,), 1, (16, 16, 16, 16), (1,)): ("RGBA", "RGBa;16L"),
    (MM, 2, (1,), 1, (16, 16, 16, 16), (1,)): ("RGBA", "RGBa;16B"),
    (II, 2, (1,), 1, (16, 16, 16, 16), (2,)): ("RGBA", "RGBA;16L"),
    (MM, 2, (1,), 1, (16, 16, 16, 16), (2,)): ("RGBA", "RGBA;16B"),
    (II, 3, (1,), 1, (1,), ()): ("P", "P;1"),
    (MM, 3, (1,), 1, (1,), ()): ("P", "P;1"),
    (II, 3, (1,), 2, (1,), ()): ("P", "P;1R"),
    (MM, 3, (1,), 2, (1,), ()): ("P", "P;1R"),
    (II, 3, (1,), 1, (2,), ()): ("P", "P;2"),
    (MM, 3, (1,), 1, (2,), ()): ("P", "P;2"),
    (II, 3, (1,), 2, (2,), ()): ("P", "P;2R"),
    (MM, 3, (1,), 2, (2,), ()): ("P", "P;2R"),
    (II, 3, (1,), 1, (4,), ()): ("P", "P;4"),
    (MM, 3, (1,), 1, (4,), ()): ("P", "P;4"),
    (II, 3, (1,), 2, (4,), ()): ("P", "P;4R"),
    (MM, 3, (1,), 2, (4,), ()): ("P", "P;4R"),
    (II, 3, (1,), 1, (8,), ()): ("P", "P"),
    (MM, 3, (1,), 1, (8,), ()): ("P", "P"),
    (II, 3, (1,), 1, (8, 8), (0,)): ("P", "PX"),
    (MM, 3, (1,), 1, (8, 8), (0,)): ("P", "PX"),
    (II, 3, (1,), 1, (8, 8), (2,)): ("PA", "PA"),
    (MM, 3, (1,), 1, (8, 8), (2,)): ("PA", "PA"),
    (II, 3, (1,), 2, (8,), ()): ("P", "P;R"),
    (MM, 3, (1,), 2, (8,), ()): ("P", "P;R"),
    (II, 5, (1,), 1, (8, 8, 8, 8), ()): ("CMYK", "CMYK"),
    (MM, 5, (1,), 1, (8, 8, 8, 8), ()): ("CMYK", "CMYK"),
    (II, 5, (1,), 1, (8, 8, 8, 8, 8), (0,)): ("CMYK", "CMYKX"),
    (MM, 5, (1,), 1, (8, 8, 8, 8, 8), (0,)): ("CMYK", "CMYKX"),
    (II, 5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0)): ("CMYK", "CMYKXX"),
    (MM, 5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0)): ("CMYK", "CMYKXX"),
    (II, 5, (1,), 1, (16, 16, 16, 16), ()): ("CMYK", "CMYK;16L"),
    (MM, 5, (1,), 1, (16, 16, 16, 16), ()): ("CMYK", "CMYK;16B"),
    (II, 6, (1,), 1, (8,), ()): ("L", "L"),
    (MM, 6, (1,), 1, (8,), ()): ("L", "L"),
    (II, 6, (1,), 1, (8, 8, 8), ()): ("RGB", "RGBX"),
    (MM, 6, (1,), 1, (8, 8, 8), ()): ("RGB", "RGBX"),
    (II, 8, (1,), 1, (8, 8, 8), ()): ("LAB", "LAB"),
    (MM, 8, (1,), 1, (8, 8, 8), ()): ("LAB", "LAB"),
}
MAX_SAMPLESPERPIXEL = max(len(k[4]) for k in OPEN_INFO)

# TiffImagePlugin.COMPRESSION_INFO; the codecs read here, and those PIL reads
# through libtiff that are not (ROADMAP item 13c)
COMPRESSION_INFO = {1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4", 5: "tiff_lzw", 6: "tiff_jpeg", 7: "jpeg",
                    8: "tiff_adobe_deflate", 32771: "tiff_raw_16", 32773: "packbits", 32809: "tiff_thunderscan",
                    32946: "tiff_deflate", 34676: "tiff_sgilog", 34677: "tiff_sgilog24", 34925: "lzma",
                    50000: "zstd", 50001: "webp"}
READ = {1, 5, 6, 7, 8, 32773, 32946, 34925, 50000}
# the codecs whose strips libtiff inflates whole (zlib, liblzma, libzstd)
INFLATED = {8, 32946, 34925, 50000}

# tags (TiffTags): those PIL keeps as one value (length 1) and those it keeps
# as a tuple
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILLORDER = 256, 257, 258, 259, 262, 266
STRIP_OFFSETS, ORIENTATION, SAMPLES, ROWS, STRIP_COUNTS, PLANAR = 273, 274, 277, 278, 279, 284
PREDICTOR, COLORMAP, TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_COUNTS = 317, 320, 322, 323, 324, 325
EXTRA, SAMPLE_FORMAT, JPEG_TABLES, YCBCR_COEFFICIENTS, YCBCR_SUBSAMPLING = 338, 339, 347, 529, 530
REFERENCE_BLACK_WHITE, JPEG_IF, JPEG_IF_LENGTH, WINDOWS_MEDIA_PHOTO = 532, 513, 514, 0xBC01
_SEGMENT_TAGS = {STRIP_OFFSETS, STRIP_COUNTS, TILE_OFFSETS, TILE_COUNTS}
_SINGLE = {WIDTH, LENGTH, COMPRESSION, PHOTOMETRIC, FILLORDER, ORIENTATION, SAMPLES, ROWS, PLANAR, PREDICTOR,
           TILE_WIDTH, TILE_LENGTH, JPEG_IF, JPEG_IF_LENGTH}
_USED = _SINGLE | {BITS, STRIP_OFFSETS, STRIP_COUNTS, COLORMAP, TILE_OFFSETS, TILE_COUNTS, EXTRA, SAMPLE_FORMAT}
# field type -> (bytes a value, struct code of an integer type or None);
# the types PIL's IFD reader knows (others it skips)
_TYPES = {1: (1, None), 2: (1, None), 3: (2, "H"), 4: (4, "L"), 5: (8, None), 6: (1, "b"), 7: (1, None),
          8: (2, "h"), 9: (4, "l"), 10: (8, None), 11: (4, None), 12: (8, None), 13: (4, "L"), 16: (8, "Q")}
# PIL's image bands by mode (libtiff's planar unpackers: one a band)
_BANDS = {"1": 1, "L": 1, "P": 1, "I;16": 1, "I;16B": 1, "I": 1, "F": 1, "LA": 2, "PA": 2, "RGB": 3, "LAB": 3,
          "RGBA": 4, "CMYK": 4}
_PIXELSIZE = {"1": 1, "L": 1, "P": 1, "I;16": 2, "I;16B": 2}
# the integer field types libtiff converts, and their struct codes
_LIB_CODES = {1: "B", 3: "H", 4: "L", 6: "b", 8: "h", 9: "l", 13: "L", 16: "Q", 17: "q", 18: "Q"}
_BITFLIP = bytes(int(f"{b:08b}"[::-1], 2) for b in range(256))


def _bind(lib: ctypes.CDLL) -> None:
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.mvd_tiff_unpacker.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(i)]
    lib.mvd_tiff_unpacker.restype = i
    lib.mvd_tiff_unpack.argtypes = [ctypes.c_char_p, ctypes.c_char_p, p, i64, i, p, i]
    lib.mvd_tiff_unpack.restype = i
    lib.mvd_tiff_raw.argtypes = [p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_char_p, i64, p, i, i, i, i, i,
                                 ctypes.c_char_p, i]
    lib.mvd_tiff_raw.restype = i
    lib.mvd_tiff_coded.argtypes = [p, ctypes.c_size_t, i, ctypes.POINTER(i), i, i64, i, i64, i, i, i,
                                   ctypes.c_char_p, ctypes.c_char_p, p, i, i, i, i, i, i, ctypes.c_char_p, i]
    lib.mvd_tiff_coded.restype = i


def _lib() -> ctypes.CDLL:
    from ..kernels._build import load_host

    return load_host("tiff_decode", _bind)


def unpacker_bits(mode: str, rawmode: str) -> Optional[int]:
    """Bits a pixel of PIL's unpacker of ``rawmode`` into ``mode``, or None
    where PIL has none."""
    bits = ctypes.c_int()
    return bits.value if _lib().mvd_tiff_unpacker(mode.encode(), rawmode.encode(), ctypes.byref(bits)) else None


def unpack(mode: str, rawmode: str, data, pixels: int, rows: int = 1) -> np.ndarray:
    """PIL's unpacker of ``rawmode`` into ``mode`` (``csrc/pil_unpack.h``)
    on ``rows`` rows of ``pixels`` samples, each an equal share of
    ``data`` (bytes or a uint8 array): the rows as PIL holds them (bytes),
    flat."""
    src = np.ascontiguousarray(data).view(np.uint8).reshape(-1) if isinstance(data, np.ndarray) else \
        np.frombuffer(bytes(data), np.uint8)
    out = np.zeros(rows * pixels * _PIXELSIZE.get(mode, 4), np.uint8)
    if _lib().mvd_tiff_unpack(mode.encode(), rawmode.encode(), src.ctypes.data, len(src) // max(rows, 1), rows,
                              out.ctypes.data, pixels):
        raise ValueError(f"no unpacker of rawmode {rawmode} into mode {mode}, or rows shorter than it reads")
    return out


class Ifd:
    """The first IFD twice: as PIL's ``ImageFileDirectory_v2`` holds it
    (``tags``: each tag PIL keeps, an int where TiffTags gives the tag one
    value, else a tuple; integer types only) and as libtiff reads it
    (``entries``), with the byte order, whether BigTIFF and the IFD's
    offset."""

    def __init__(self, data: bytes):
        self.data = data
        if len(data) < 8:
            raise ValueError("TIFF: the header is cut")
        self.prefix = data[:2]
        self.endian = ">" if self.prefix == MM else "<"
        self.big = data[2] == 43  # PIL's test: an MM BigTIFF reads as classic
        self.valid = data[:4] in (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x00\x2b", b"II\x2b\x00")
        if self.big:
            if len(data) < 16:
                raise ValueError("TIFF: the BigTIFF header is cut")
            self.offset = struct.unpack(self.endian + "Q", data[8:16])[0]
            self.big_header_ok = struct.unpack(self.endian + "HH", data[4:8]) == (8, 0)
        else:
            self.offset = struct.unpack(self.endian + "L", data[4:8])[0]
        if not self.offset:
            raise ValueError("TIFF: no more images in TIFF file (the first IFD offset is 0)")
        self.tags: Dict[int, object] = {}
        # tag -> (type, count, value bytes, or None where they lie past the
        # end of the file), a tag's first entry; entries_cut where libtiff
        # cannot read the entries at all
        self.entries: Dict[int, tuple] = {}
        self.entries_cut = False
        raw, count = self._raw_entries()
        self.raw_entries = raw
        self._load(raw)
        self.entries_cut = count is None or count > 4096 or len(raw) < count
        if not self.entries_cut:
            self._load_all(raw)

    def _raw_entries(self) -> Tuple[list, Optional[int]]:
        """The IFD's (tag, type, count, value field) entries up to the end
        of the file, and the entry count it states (None where cut)."""
        d, e, pos = self.data, self.endian, self.offset
        n_fmt, entry = ("Q", 20) if self.big else ("H", 12)
        head = d[pos:pos + struct.calcsize(n_fmt)]
        if len(head) < struct.calcsize(n_fmt):
            return [], None
        count = struct.unpack(e + n_fmt, head)[0]
        pos += len(head)
        out = []
        for _ in range(count):
            raw = d[pos:pos + entry]
            if len(raw) < entry:
                break
            pos += entry
            out.append(struct.unpack(e + ("HHQ8s" if self.big else "HHL4s"), raw))
        return out, count

    def _value(self, n: int, unit: int, field: bytes) -> Optional[bytes]:
        """A tag's value bytes: in the field, or at the offset it holds
        (None past the end of the file)."""
        size = n * unit
        if size <= len(field):
            return field[:size]
        at = struct.unpack(self.endian + ("Q" if self.big else "L"), field)[0]
        return self.data[at:at + size] if at + size <= len(self.data) else None

    def _load(self, raw: list) -> None:
        """``ImageFileDirectory_v2.load``: an unknown type or a count of 0
        skips its tag; a value past the end of the file ends the IFD (PIL
        warns and keeps the tags read)."""
        for tag, typ, n, field in raw:
            if typ not in _TYPES:
                continue
            unit, code = _TYPES[typ]
            value = self._value(n, unit, field)
            if value is None:
                return
            if not value:
                continue
            if tag not in _USED:
                self.tags[tag] = value
            elif code is None:
                self.tags[tag] = ("bad type", typ)
            else:
                vals = struct.unpack(self.endian + code * n, value)
                self.tags[tag] = vals[0] if tag in _SINGLE else vals

    def _load_all(self, raw: list) -> None:
        """The entries as libtiff's ``TIFFReadDirectory`` reads them: a
        tag's first entry, every type it knows (LONG8, SLONG8, IFD8 too);
        of a strip or tile array, the values that lie in the file (libtiff
        reads only as many as the image has strips or tiles)."""
        for tag, typ, n, field in raw:
            unit = {17: 8, 18: 8}.get(typ, _TYPES.get(typ, (0, None))[0])
            value = self._value(n, unit, field)
            if value is None and tag in _SEGMENT_TAGS and unit:
                at = struct.unpack(self.endian + ("Q" if self.big else "L"), field)[0]
                n = max(0, (len(self.data) - at) // unit)
                value = self.data[at:at + n * unit]
            self.entries.setdefault(tag, (typ, n, value))

    def libtiff_refuses(self) -> Optional[str]:
        """What libtiff's directory reader refuses in the tags it must read
        (an IFD cut short; a type it cannot convert, a count other than one
        for a one-valued tag, values past the end of the file, samples of
        different sizes or formats, a planar configuration other than 1 or
        2), or None. PIL's reader skips such tags; libtiff fails the
        compressed file's decode."""
        if self.entries_cut:
            return "the IFD runs past the end of the file"
        ints = {1, 3, 4, 6, 8, 9, 16, 17}
        for tag in (WIDTH, LENGTH, BITS, COMPRESSION, STRIP_OFFSETS, SAMPLES, ROWS, STRIP_COUNTS, PLANAR,
                    TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_COUNTS, EXTRA, SAMPLE_FORMAT):
            if tag not in self.entries:
                continue
            typ, n, value = self.entries[tag]
            if typ not in ints and not (tag in _SEGMENT_TAGS and typ in (13, 18)):
                return f"tag {tag} of field type {typ} (libtiff: Incompatible type)"
            if tag in _SINGLE and n != 1 and (tag != COMPRESSION or self.lib_get(tag) is None):
                return f"tag {tag} with {n} values (libtiff: Incorrect count)"
            if value is None:
                return f"tag {tag}'s values past the end of the file"
            if tag in _SEGMENT_TAGS and typ in (6, 8, 9, 17) and min(self.lib_get(tag)[:self.lib_segments()],
                                                                     default=0) < 0:
                return f"tag {tag} holds a negative offset or count (libtiff: TIFFReadDirEntryErrRange)"
            if tag in (BITS, SAMPLE_FORMAT):  # libtiff reads the first SamplesPerPixel values, which must agree
                vals, spp = self.lib_get(tag), self.lib_get(SAMPLES, 1)
                if len(vals) < spp or len(set(vals[:spp])) > 1:
                    return f"tag {tag} has not one value a sample (libtiff: Cannot handle different values per sample)"
        if self.lib_get(PLANAR, 1) not in (1, 2):
            return f"planar configuration {self.lib_get(PLANAR)} (libtiff: Bad value)"
        bits, formats = self.lib_get(BITS, (1,)), self.lib_get(SAMPLE_FORMAT, (1,))
        if not self.lib_get(SAMPLES, 1) or not any(bits) or not formats:
            return "0 samples a pixel, 0 bits a sample or no sample format (libtiff: Bad value)"
        tiled = TILE_WIDTH in self.entries
        if (TILE_COUNTS if tiled else STRIP_COUNTS) not in self.entries:
            n, planar = self.lib_segments(), self.lib_get(PLANAR, 1)
            if (planar == 1 and n > 1) or (planar == 2 and n != self.lib_get(SAMPLES, 1)):
                return f"no {'Tile' if tiled else 'Strip'}ByteCounts for {n} segments (libtiff: MissingRequired)"
        if self.lib_get(PHOTOMETRIC) == 3 and bits[0] < 8:
            # a colour map is read only after BitsPerSample, of 3 << bits values
            cmap = self.entries.get(COLORMAP)
            if BITS not in self.entries or cmap is None or cmap[1] != 3 << bits[0] or cmap[2] is None:
                return "a palette image without its colour map (libtiff: MissingRequired Colormap)"
        return None

    def lib_segments(self) -> int:
        """libtiff's count of strips (``TIFFNumberOfStrips``) or tiles
        (``TIFFNumberOfTiles``)."""
        width, height = self.lib_get(WIDTH, 0), self.lib_get(LENGTH, 0)
        planes = self.lib_get(SAMPLES, 1) if self.lib_get(PLANAR, 1) == 2 else 1
        if TILE_WIDTH in self.entries:
            tw, th = self.lib_get(TILE_WIDTH) or 1, self.lib_get(TILE_LENGTH) or 1
            return -(-width // tw) * -(-height // th) * planes
        rows = self.lib_get(ROWS, 2**32 - 1)
        return (1 if rows == 2**32 - 1 else -(-height // max(rows, 1))) * planes

    def estimated_counts(self, offsets: list) -> list:
        """``EstimateStripByteCounts`` of a compressed image: every segment
        the file's bytes past the header, the IFD and its values held
        outside it (over the samples of a planar image), the last one cut
        at the end of the file."""
        head, count_size, entry, inline = (16, 8, 20, 8) if self.big else (8, 2, 12, 4)
        space = head + count_size + len(self.raw_entries) * entry + inline  # the next IFD's offset: inline bytes
        for _, typ, n, _ in self.raw_entries:
            width = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4, 16: 8, 17: 8,
                     18: 8}.get(typ)
            if width is None:
                raise ValueError(f"TIFF: libtiff cannot size a tag of type {typ} to estimate the byte counts")
            space += width * n if width * n > inline else 0
        size = len(self.data)
        space = size - space if size >= space else size
        if self.lib_get(PLANAR, 1) == 2:
            space //= self.lib_get(SAMPLES, 1)
        counts = [space] * len(offsets)
        if offsets and offsets[-1] + space > size:
            counts[-1] = size - offsets[-1] if offsets[-1] < size else 0
        return counts

    def lib_get(self, tag: int, default=None):
        """A tag's value as libtiff reads it (``entries``): one number for a
        one-valued tag (its default where the entry has another count or a
        type libtiff cannot convert), else a tuple."""
        if tag not in self.entries:
            return default
        typ, n, value = self.entries[tag]
        code = _LIB_CODES.get(typ)
        if code is None or value is None:
            return default
        vals = struct.unpack(self.endian + code * n, value)
        if tag == COMPRESSION and n != 1:
            # libtiff reads a Compression of another count per sample: its
            # first SamplesPerPixel values, which must agree
            spp = self.lib_get(SAMPLES, 1)
            return vals[0] if n >= spp and len(set(vals[:spp])) == 1 else default
        if tag in _SINGLE:
            return vals[0] if n == 1 else default
        return vals

    def get(self, tag: int, default=None):
        value = self.tags.get(tag, default)
        if isinstance(value, tuple) and value[:1] == ("bad type",):
            raise not_read(f"tag {tag} of field type {value[1]}")
        return value


def _layout(ifd: Ifd, width: int, height: int) -> Tuple[str, int, int, list, list]:
    """libtiff's strips or tiles, from its reading of the IFD: (kind,
    segment width, segment height, offsets, byte counts)."""
    if TILE_WIDTH in ifd.entries:
        tw, th = ifd.lib_get(TILE_WIDTH), ifd.lib_get(TILE_LENGTH)
        offsets, counts = ifd.lib_get(TILE_OFFSETS), ifd.lib_get(TILE_COUNTS)
        if not isinstance(tw, int) or not isinstance(th, int) or not tw or not th or offsets is None:
            raise ValueError("TIFF: a tiled image without tile sizes or offsets (libtiff refuses it)")
        kind = "tile"
    else:
        tw, th = width, ifd.lib_get(ROWS, height)
        offsets, counts = ifd.lib_get(STRIP_OFFSETS), ifd.lib_get(STRIP_COUNTS)
        if offsets is None and ifd.lib_get(COMPRESSION) == 6 and ifd.lib_segments() == 1:
            offsets = (0,)  # tif_dirread.c's old-style JPEG hack: the stream holds the data
        if offsets is None:
            raise ValueError("TIFF: no StripOffsets (libtiff refuses it)")
        if not th:
            raise ValueError("TIFF: RowsPerStrip 0 (libtiff refuses it)")
        if th >= 2**32 - 1:
            th = height
        kind = "strip"
    # TIFFFetchStripThing: the first segments' values, zeros past an array
    # that holds fewer; no counts, or one strip's 0 (ByteCountLooksBad):
    # EstimateStripByteCounts
    n = ifd.lib_segments()
    offsets = (list(offsets) + [0] * n)[:n]
    if counts is not None:
        counts = (list(counts) + [0] * n)[:n]
    if counts is None or (n == 1 and kind == "strip" and offsets[0] and not counts[0]):
        counts = ifd.estimated_counts(offsets)
    return kind, tw, th, offsets, counts


def _inflate(compression: int, seg: bytes, occ: int, whole: bool = True) -> bytes:
    """The first ``occ`` bytes a deflate, LZMA (.xz) or zstd strip holds,
    as libtiff's ZIPDecode, LZMADecode and ZSTDDecode take them: the stream
    decoded until the strip is full, nothing past that read; a strip it
    leaves short is refused, or, not ``whole``, returned short."""
    name = {34925: "LZMA", 50000: "zstd"}.get(compression, "deflate")
    lzma = _lzma() if compression == 34925 else None
    errors = (zlib.error, EOFError, ValueError) + ((lzma.LZMAError,) if lzma else ())
    try:
        if compression == 50000:
            from ..checkpoint.zstd import decompress

            seg = decompress(seg, limit=occ)[:occ]  # raises ValueError on a damaged frame
        elif lzma is not None:
            seg = lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(seg, occ)
        else:
            seg = zlib.decompressobj().decompress(seg, occ)
    except errors as exc:
        if compression in (34925, 50000):
            # liblzma stops once the strip is full, and libzstd's fast Huffman
            # decoder does not check that a literal stream ends where it
            # should: each reads some damaged strips that this decoder refuses
            raise not_read(f"a damaged {name} strip ({exc}), which libtiff's {name} decoder may read on past")
        raise ValueError(f"TIFF: {name}: {exc} (libtiff: Decoding error)") from None
    if whole and len(seg) < occ:
        raise ValueError(f"TIFF: {name}: not enough data for the strip (libtiff: Not enough data)")
    return seg


def _lzma():
    """Python's ``lzma`` (liblzma's binding), or a ``ValueError`` naming
    the module where this Python was built without it."""
    try:
        import lzma
    except ImportError as exc:
        raise ValueError(f"TIFF: LZMA needs Python's lzma module, which this Python lacks ({exc})") from None
    return lzma


def unread_compression(compression: int) -> ValueError:
    """The refusal of a compression this reader does not decode: WebP
    (50001), which PIL's libtiff cannot decode either, or one PIL reads
    (ROADMAP item 13c), or one neither knows."""
    if compression == 50001:
        return ValueError("TIFF: compression 50001 (WebP) is not read: PIL's libtiff has no WebP codec, and PIL "
                          "refuses it too")
    if compression in COMPRESSION_INFO:
        return not_read(f"compression {compression} ({COMPRESSION_INFO[compression]})")
    return ValueError(f"TIFF: libtiff knows no compression {compression}")


def _libtiff_checks(ifd: Ifd) -> None:
    """What libtiff refuses before it decodes a strip: the header, the IFD
    (``Ifd.libtiff_refuses``)."""
    if not ifd.valid:
        raise ValueError("TIFF: libtiff refuses the header's byte-order mark (Not a TIFF file, bad version)")
    if ifd.big and not ifd.big_header_ok:
        raise ValueError("TIFF: libtiff refuses the BigTIFF header (bad offset size)")
    refused = ifd.libtiff_refuses()
    if refused:
        raise ValueError(f"TIFF: libtiff refuses the IFD: {refused}")


def _jpeg_setup(data: bytes, ifd: Ifd, bps: int, offsets: list, counts: list) -> tuple:
    """What tif_jpeg.c's ``JPEGSetupDecode`` fixes for every strip: the
    ``JPEGTables`` stream's tables (or None), the output space (YCbCr
    converted to RGB as PIL asks, ``JPEGCOLORMODE_RGB``, for a contiguous
    YCbCr image; every other image unconverted) and the first component's
    sampling factors it expects (``YCbCrSubsampling``; where the tag is
    absent, the first strip's, else 2 x 2; 1 x 1 but for YCbCr)."""
    if bps != 8:
        raise not_read(f"{bps}-bit JPEG")
    tables = ifd.entries.get(JPEG_TABLES)
    if tables is not None:
        tables = tiff_codecs.tables_body(tables[2] or b"")
    if ifd.lib_get(PHOTOMETRIC) != 6:
        return tables, tiff_codecs.NONE, (1, 1)
    sampling = ifd.lib_get(YCBCR_SUBSAMPLING)
    if not (isinstance(sampling, tuple) and len(sampling) == 2):
        first = data[offsets[0]:offsets[0] + counts[0]] if offsets and counts else b""
        sampling = tiff_codecs.sof_sampling(first) or (2, 2)
    return tables, tiff_codecs.YCC, tuple(sampling)


def _decode_coded(data: bytes, ifd: Ifd, mode: str, rawmode: str, width: int, height: int,
                  image: np.ndarray) -> None:
    """PIL's ``_load_libtiff``: libtiff's decode of every strip or tile (by
    its own reading of the IFD, the codec too), PIL's unpackers after
    it."""
    _libtiff_checks(ifd)
    lib = _lib()
    compression = ifd.lib_get(COMPRESSION, 1)
    if compression not in READ:
        raise unread_compression(compression)
    if compression == 6:  # YCbCr takes the RGBA path; libtiff's OJPEG scanline reads are not copied
        raise not_read(f"old-style JPEG of photometric {ifd.lib_get(PHOTOMETRIC)}")
    spp = ifd.lib_get(SAMPLES, 1)
    bps = ifd.lib_get(BITS, (1,))[0]
    planar = ifd.lib_get(PLANAR, 1)
    predictor = ifd.lib_get(PREDICTOR, 1)
    fill = ifd.lib_get(FILLORDER, 1)
    sample_format = ifd.lib_get(SAMPLE_FORMAT, (1,))[0]
    if predictor == 2 and bps not in (8, 16, 32, 64):
        raise ValueError(f"TIFF: libtiff refuses the horizontal predictor at {bps}-bit samples")
    if predictor == 3 and (sample_format != 3 or bps not in (16, 24, 32, 64)):
        raise ValueError("TIFF: libtiff refuses the floating-point predictor here")
    if predictor not in (1, 2, 3) and compression in {5} | INFLATED:
        raise ValueError(f"TIFF: libtiff refuses predictor {predictor}")
    if compression in (1, 32773):
        predictor = 1  # no predictor without LZW or deflate
    separate = planar == 2
    bands = _BANDS[mode]
    planes = bands if separate and bands > 1 else 1
    if planes > 1 and bps not in (8, 16):
        raise ValueError(f"TIFF: PIL's planar libtiff path takes 8 or 16 bits a sample, not {bps}")
    # PIL's _pickUnpackers: a planar file's planes into bands 0-3 of the
    # four-byte pixel, whatever the mode; else the rawmode's unpacker
    if planes > 1:
        unpackers = [("RGBA", "RGBA"[k] + (";16N" if bps == 16 else "")) for k in range(planes)]
    else:
        unpackers = [(mode, rawmode)]
    bits = unpacker_bits(mode, rawmode)
    if bits is None:
        raise ValueError(f"TIFF: no unpacker of rawmode {rawmode} into mode {mode} (PIL: unknown raw mode)")
    kind, tw, th, offsets, counts = _layout(ifd, width, height)
    plane_spp = 1 if separate else spp
    row_size = (tw * plane_spp * bps + 7) // 8  # libtiff's scanline (or tile row) bytes
    # PIL's _decodeStrip refuses a strip larger than the rawmode's rows (the
    # rawmode's bits over the planes) and rows its unpacker would read past,
    # and a strip whose rows overflow an int; _decodeTile has no such checks
    unpack_row = (tw * bits // planes + 7) // 8
    if kind == "strip" and (min(th, height) * row_size > unpack_row * th or unpack_row > row_size):
        raise ValueError(f"TIFF: rawmode {rawmode}'s rows of {unpack_row} bytes do not match libtiff's "
                         f"{row_size}-byte rows (PIL's decoder error -2)")
    if kind == "strip" and th > 2**31 - 1:
        raise ValueError(f"TIFF: {th} rows a strip overflow PIL's int (PIL's decoder error -9)")
    # _decodeTile's check of libtiff's tile size against the rawmode's
    if kind == "tile" and th * row_size > ((th * bits // planes + 7) // 8) * tw:
        raise ValueError(f"TIFF: a {tw}x{th} tile of {th * row_size} bytes is more than rawmode {rawmode} "
                         "holds (PIL's decoder error)")
    swab = bps // 8 if ifd.prefix == MM and bps in (16, 24, 32, 64) else 0
    if compression == 7:
        tables, space, sampling = _jpeg_setup(data, ifd, bps, offsets, counts)
        predictor, swab = 1, 0  # libjpeg's samples: no predictor, no byte swapping
    style = ctypes.c_int(0)
    err = ctypes.create_string_buffer(256)
    across = (width + tw - 1) // tw
    down = (height + th - 1) // th
    per_plane = across * down
    order = [(y, p, x) for y in range(0, height, th) for p in range(planes) for x in range(0, width, tw)]
    image_w = image.shape[1]
    for y, p, x in order:
        index = (y // th) * across + x // tw + p * per_plane
        if index >= len(offsets) or index >= len(counts):
            raise ValueError(f"TIFF: {kind} {index} is missing (libtiff: Read error)")
        off, count = offsets[index], counts[index]
        if count <= 0 or off + count > len(data):
            raise ValueError(f"TIFF: {kind} {index} runs past the end of the file or is empty (libtiff: Read error)")
        rows_here = min(th, height - y) if kind == "strip" else th
        occ = rows_here * row_size
        seg = data[off:off + count]
        codec = compression
        if compression == 7:
            seg_h = min(th, height - y) if kind == "strip" else th
            seg = tiff_codecs.jpeg_segment(seg, tables, space, plane_spp, sampling, tw, seg_h, rows_here, row_size,
                                           kind == "strip" and y + th >= height, f"{kind} {index}")
            codec = 8
        elif compression in INFLATED:
            if fill == 2:
                seg = seg.translate(_BITFLIP)
            seg = _inflate(compression, seg, occ)
            codec = 8
        buf = np.frombuffer(seg, np.uint8)
        umode, uraw = unpackers[p]
        rows = min(th, height - y)
        cols = min(tw, width - x)
        ubytes = (cols * unpacker_bits(umode, uraw) + 7) // 8
        if kind == "tile" and (rows - 1) * row_size + ubytes > occ:
            # _decodeTile has no check of the rawmode's rows against the
            # tile's: PIL's unpacker reads past its tile buffer (a planar
            # palette tile with an extra sample, rawmode PX, is one such)
            raise ValueError(f"TIFF: rawmode {uraw}'s rows of {ubytes} bytes read past "
                             f"{kind} {index}'s {occ} bytes: PIL's pixels there are not a function of the file, and "
                             "the port does not copy them (ROADMAP Queue 3, fault 14)")
        if lib.mvd_tiff_coded(buf.ctypes.data, len(seg), codec, ctypes.byref(style), int(fill == 2), occ, predictor,
                              row_size, plane_spp, bps, swab, umode.encode(), uraw.encode(), image.ctypes.data,
                              image_w, x, y, cols, rows, 0, err, len(err)):
            raise ValueError(err.value.decode())
    extra = ifd.lib_get(EXTRA, ())
    if planes > 1 and mode == "RGBA" and (extra[0] if extra else 0) in (0, 1):
        # PIL unpremultiplies a planar RGBA image whose extra sample libtiff
        # calls associated or unspecified (no ExtraSamples tag: libtiff
        # fills one in unspecified; Corel's 999 it reads as unassociated)
        # once its planes are in, with RGBa's arithmetic (measured)
        flat = image.reshape(-1)
        image[...] = unpack("RGBA", "RGBa", flat.tobytes(), flat.size // 4).reshape(image.shape)


def _decode_ycbcr(data: bytes, ifd: Ifd, mode: str, rawmode: str, width: int, height: int,
                  image: np.ndarray) -> None:
    """PIL's ``_decodeAsRGBA`` of a YCbCr image (but contiguous JPEG):
    tif_getimage.c's RGBA path, a block of strips' or tiles' rows at a
    time. Each strip or tile decoded as its codec decodes it (the bytes
    ``gtStripContig`` asks for: of a strip whose rows of data units its
    scanlines do not divide, fewer than the units hold, the rest of the
    zeroed buffer read as zeros; an old-style JPEG strip by
    ``tiff_codecs.ojpeg_units``), its data units converted by
    ``tiff_codecs.ycbcr_to_rgb``, unflipped whatever the Orientation tag
    (PIL applies the orientation after, measured); each row of the RGBA
    raster (R, G, B, 255) unpacked into ``image`` by PIL's unpacker of
    ``rawmode`` (RGBX into RGB; L, where PIL's own reading of the IFD
    gives one sample, takes a row's first bytes)."""
    _libtiff_checks(ifd)
    compression = ifd.lib_get(COMPRESSION, 1)
    ojpeg = compression == 6
    if compression not in READ:
        raise unread_compression(compression)
    if compression == 7:
        raise not_read("planar YCbCr JPEG (libtiff's RGBA path)")
    # tif_dirread.c's old-style JPEG defaults: three samples of 8 bits
    if ifd.lib_get(SAMPLES, 3 if ojpeg else 1) != 3 or ifd.lib_get(BITS, (8 if ojpeg else 1,))[0] != 8:
        raise ValueError("TIFF: libtiff's RGBA path takes YCbCr of three 8-bit samples (Can not handle format)")
    if ifd.lib_get(PLANAR, 1) == 2:
        raise not_read("planar YCbCr (libtiff's RGBA path)")
    kind, tw, th, offsets, counts = _layout(ifd, width, height)
    if ojpeg:
        if kind == "tile" or th < height or len(offsets) != 1:
            raise not_read("old-style JPEG in several strips or in tiles")
        jif = ifd.lib_get(JPEG_IF)
        if not jif:
            raise not_read("old-style JPEG with its tables in tags 519-521 (no JPEGInterchangeFormat)")
        # OJPEGReadBufferFill: a strip at offset 0 or past the file holds
        # nothing, a count of 0 or past the file runs to its end
        off = offsets[0] if 0 < offsets[0] < len(data) else 0
        strip = data[off:off + (counts[0] or len(data))] if off else b""
        units, sub = tiff_codecs.ojpeg_units(data, jif, ifd.lib_get(JPEG_IF_LENGTH, 0), strip, width, height)
    else:
        sub = ifd.lib_get(YCBCR_SUBSAMPLING)
        sub = tuple(sub) if isinstance(sub, tuple) and len(sub) == 2 else (2, 2)
    if sub not in tiff_codecs.PUT_CASES:
        raise ValueError(f"TIFF: libtiff's RGBA path has no routine for YCbCr subsampling {sub} (Can not handle "
                         "format)")
    tables = tiff_codecs.ycbcr_tables(
        tiff_codecs.rational(ifd.entries.get(YCBCR_COEFFICIENTS), ifd.endian, tiff_codecs.DEFAULT_LUMA),
        tiff_codecs.rational(ifd.entries.get(REFERENCE_BLACK_WHITE), ifd.endian,
                             tiff_codecs.DEFAULT_REF_BLACK_WHITE))
    predictor = ifd.lib_get(PREDICTOR, 1) if compression in {5} | INFLATED else 1
    if predictor not in (1, 2):
        raise ValueError(f"TIFF: libtiff refuses predictor {predictor} here")
    # _decodeAsRGBA: a block of RowsPerStrip (or TileLength) rows of
    # four-byte pixels must fit PIL's int (IMAGING_CODEC_MEMORY)
    rows_tag = ifd.lib_get(ROWS, 2**32 - 1)
    block_rows = th if kind == "tile" else rows_tag if rows_tag != 2**32 - 1 else height
    if block_rows * width * 4 > 2**31 - 1:
        raise ValueError(f"TIFF: a block of {block_rows} rows of {width} four-byte pixels overflows PIL's int "
                         "(PIL's decoder error -9)")
    sh, sv = sub
    unit_row = -(-tw // sh) * (sh * sv + 2)  # the bytes of a row of data units
    scanline = unit_row // sv  # TIFFScanlineSize of subsampled YCbCr
    style = ctypes.c_int(0)
    raster = np.full((height, width, 4), 255, np.uint8)
    for y in range(0, height, th):
        rows = min(th, height - y)
        if kind == "strip":
            segments = [((y // th), rows, min(-(-rows // sv) * unit_row, -(-rows // sv) * sv * scanline), width)]
        else:
            segments = [((y // th) * -(-width // tw) + x // tw, th, -(-th // sv) * unit_row, min(tw, width - x))
                        for x in range(0, width, tw)]
        block, full = [], None
        for index, seg_rows, occ, cols in segments:
            if ojpeg:
                if occ % unit_row:  # OJPEGDecodeRaw: "Fractional scanline not read"
                    raise not_read("an old-style JPEG strip whose scanlines do not divide its rows of data units")
                full = np.zeros(-(-seg_rows // sv) * unit_row, np.uint8)
                full[:occ] = units[:occ]
            else:
                try:
                    seg = _segment(data, kind, index, offsets, counts)
                except ValueError:
                    # gtTileContig reads on past a tile it cannot read, which
                    # TIFFReadEncodedTile zeroes in its buffer; the first
                    # segment of a block has no buffer yet, and PIL raises
                    if full is None:
                        raise
                    full = np.zeros_like(full)
                    block.append(tiff_codecs.ycbcr_to_rgb(full, cols, rows, sub, tables,
                                                          tiff_codecs.unit_row_bytes(tw, cols, sub)))
                    continue
                full = np.zeros(-(-seg_rows // sv) * unit_row, np.uint8)
                # the predictor's rows: TIFFTileRowSize of a tile (its
                # samples, subsampling aside), TIFFScanlineSize of a strip
                full[:occ] = _decoded(seg, compression, style, occ, predictor, tw * 3 if kind == "tile" else scanline,
                                      f"{kind} {index}")
            block.append(tiff_codecs.ycbcr_to_rgb(full, cols, rows, sub, tables,
                                                  tiff_codecs.unit_row_bytes(tw, cols, sub)))
        raster[y:y + rows, :, :3] = np.concatenate(block, 1)
    flat = image.reshape(height, -1)
    for y in range(height):
        flat[y] = unpack(mode, rawmode, raster[y].tobytes(), width)


def _segment(data: bytes, kind: str, index: int, offsets: list, counts: list) -> bytes:
    """Strip or tile ``index``'s bytes, as libtiff reads them."""
    if index >= len(offsets) or index >= len(counts):
        raise ValueError(f"TIFF: {kind} {index} is missing (libtiff: Read error)")
    off, count = offsets[index], counts[index]
    if count <= 0 or off + count > len(data):
        raise ValueError(f"TIFF: {kind} {index} runs past the end of the file or is empty (libtiff: Read error)")
    return data[off:off + count]


def _decoded(seg: bytes, compression: int, style: ctypes.c_int, occ: int, predictor: int, row_size: int,
             where: str) -> np.ndarray:
    """A strip or tile's ``occ`` bytes as libtiff's codec decodes them (the
    horizontal predictor undone on rows of ``row_size`` bytes, three
    samples a pixel), for the RGBA path, which reads past a strip that
    fails to decode (PIL then gives pixels of what the buffer held): where
    the predictor fails (``horAcc8``'s "(cc%stride)!=0", or rows that do
    not divide the strip) the codec's bytes as they are, which the buffer
    holds; where the data end before the strip does, the bytes decoded,
    zeros after them (libtiff's PackBits and LZW zero the rest; the
    others find it zeroed in the buffer ``gtStripContig`` allocates for
    PIL's block), the predictor not undone (``PredictorDecodeRow`` skips
    a failed row); a strip whose codec fails otherwise is refused naming
    ROADMAP item 13c."""
    if predictor == 2 and (row_size % 3 or occ % row_size):
        predictor = 1
    codec = compression
    if compression in INFLATED:
        try:
            seg = _inflate(compression, seg, occ, whole=False)
        except ValueError as exc:
            raise not_read(f"a damaged YCbCr {where}, which libtiff's RGBA path reads on past ({exc})") from None
        codec = 8
    out = np.zeros((occ // row_size, row_size) if predictor == 2 else (1, occ), np.uint8)
    buf = np.frombuffer(seg, np.uint8)
    err = ctypes.create_string_buffer(256)
    if _lib().mvd_tiff_coded(buf.ctypes.data, len(seg), codec, ctypes.byref(style), 0, occ, predictor,
                             row_size if predictor == 2 else occ, 3, 8, 0, b"L", b"L", out.ctypes.data,
                             out.shape[1], 0, 0, out.shape[1], out.shape[0], 1, err, len(err)):
        raise not_read(f"a damaged YCbCr {where}, which libtiff's RGBA path reads on past ({err.value.decode()})")
    return out.reshape(-1)


def _decode_raw(data: bytes, ifd: Ifd, mode: str, rawmode: str, width: int, height: int, bps_tuple: tuple,
                bps_count: int, image: np.ndarray, from_path: bool) -> Optional[np.ndarray]:
    """PIL's tiles of an uncompressed image (``_setup``), sorted by offset,
    runs of equal tiles kept once (the last), each through PIL's raw
    decoder; or, ``from_path`` and one tile whose rawmode is a mode PIL
    maps, the image ``ImageFile.load`` maps from the file, returned (its
    size turned where the orientation is 5-8, as ``_setup`` turns
    ``size``; ROADMAP Queue 3, fault 13)."""
    planar = ifd.get(PLANAR, 1)
    if STRIP_OFFSETS in ifd.tags:
        offsets = ifd.get(STRIP_OFFSETS)
        h, w = ifd.get(ROWS, height), width
    elif TILE_OFFSETS in ifd.tags:
        offsets = ifd.get(TILE_OFFSETS)
        w, h = ifd.get(TILE_WIDTH), ifd.get(TILE_LENGTH)
        if not isinstance(w, int) or not isinstance(h, int):
            raise ValueError("TIFF: Invalid tile dimensions")
    else:
        raise ValueError("TIFF: unknown data organization (no strip or tile offsets)")
    if not w or not h:
        raise ValueError("TIFF: a strip or tile of zero rows or columns")
    if w == width and h == height and planar != 2:
        offsets = offsets[-1:]
    tiles, x, y, layer = [], 0, 0, 0
    for offset in offsets:
        stride = w * sum(bps_tuple) / 8 if x + w > width else 0
        tile_raw = rawmode
        if planar == 2:
            if layer >= len(rawmode):
                raise ValueError("TIFF: more planes than the rawmode has bands (PIL: IndexError)")
            tile_raw = rawmode[layer]
            stride /= bps_count
        tiles.append((offset, (x, y, min(x + w, width), min(y + h, height)), (tile_raw, int(stride))))
        x += w
        if x >= width:
            x, y = 0, y + h
            if y >= height:
                y, layer = 0, layer + 1
    if from_path and len(tiles) == 1 and tiles[0][2][0] == mode and mode in MAPMODES:
        offset, _, (_, stride) = tiles[0]
        size = (height, width) if ifd.get(ORIENTATION) in (5, 6, 7, 8) else (width, height)
        mapped = pil_mapped(data, offset, size, mode, stride, 1)
        if mapped is not None:
            return mapped
    tiles.sort(key=lambda t: t[0])
    kept = [t for i, t in enumerate(tiles) if i + 1 == len(tiles) or tiles[i + 1][1:] != t[1:]]
    lib = _lib()
    err = ctypes.create_string_buffer(256)
    buf = np.frombuffer(data, np.uint8)
    for offset, (x0, y0, x1, y1), (tile_raw, stride) in kept:
        if offset < 0:
            raise ValueError("TIFF: a negative tile offset")
        avail = max(len(data) - offset, 0)
        if lib.mvd_tiff_raw(buf.ctypes.data + min(offset, len(data)), avail, mode.encode(), tile_raw.encode(),
                            stride, image.ctypes.data, image.shape[1], x0, y0, x1 - x0, y1 - y0, err, len(err)):
            raise ValueError(err.value.decode())
    return None


_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: a.swapaxes(0, 1), 6: lambda a: np.rot90(a, -1), 7: lambda a: a.swapaxes(0, 1)[::-1, ::-1],
           8: lambda a: np.rot90(a, 1)}


def decode_tiff(data: bytes, from_path: bool = False) -> PilImage:
    """TIFF bytes -> the first image as PIL 12.1.0 holds it, in PIL's mode
    (``OPEN_INFO``): 1, L, P (the colour map's high bytes), LA, PA, I;16,
    I;16B, I, F, RGB, RGBA (RGBa unpremultiplied), CMYK or LAB; strips or
    tiles, planar configuration 1 or 2; uncompressed, PackBits, LZW (new or
    old-style), deflate (8, 32946), LZMA or zstd with predictor 2 or 3 and
    FillOrder 2, JPEG (7), old-style JPEG (6, JPEGInterchangeFormat), YCbCr
    through libtiff's RGBA path; EXIF orientation applied; ``from_path``:
    as ``Image.open(path)`` reads the file (a mapped tile). Raises
    ``ValueError`` where PIL or libtiff raises, and naming ROADMAP item 13c
    for what PIL reads and this does not; ``RuntimeError`` when a decoder
    cannot be built."""
    data = bytes(data)
    ifd = Ifd(data)
    if WINDOWS_MEDIA_PHOTO in ifd.tags:
        raise ValueError("TIFF: Windows Media Photo files not yet supported (PIL refuses them too)")
    compression = ifd.get(COMPRESSION, 1)
    if compression not in COMPRESSION_INFO:
        raise ValueError(f"TIFF: compression {compression} is unknown (PIL: KeyError)")
    if compression not in READ:
        raise unread_compression(compression)
    planar = ifd.get(PLANAR, 1)
    photo = ifd.get(PHOTOMETRIC, 0)
    if compression == 6:
        photo = 6  # PIL: "old style jpeg compression images most certainly are YCbCr"
    fill = ifd.get(FILLORDER, 1)
    width, height = ifd.get(WIDTH), ifd.get(LENGTH)
    if width is None or height is None:
        raise ValueError("TIFF: Missing dimensions")
    if not isinstance(width, int) or not isinstance(height, int):
        raise ValueError("TIFF: Invalid dimensions")
    sample_format = ifd.get(SAMPLE_FORMAT, (1,))
    if len(sample_format) > 1 and max(sample_format) == min(sample_format) == 1:
        sample_format = (1,)
    bps_tuple = ifd.get(BITS, (1,))
    extra = ifd.get(EXTRA, ())
    bps_count = (3 if photo in (2, 6, 8) else 4 if photo == 5 else 1) + len(extra)
    spp = ifd.get(SAMPLES, 3 if compression == 6 and photo in (2, 6) else 1)
    if spp > MAX_SAMPLESPERPIXEL:
        raise ValueError("TIFF: Invalid value for samples per pixel")
    if spp < len(bps_tuple):
        bps_tuple = bps_tuple[:spp]
    elif spp > len(bps_tuple) and len(bps_tuple) == 1:
        bps_tuple = bps_tuple * spp
    if len(bps_tuple) != spp:
        raise ValueError("TIFF: unknown data organization (bits per sample against samples per pixel)")
    key = (ifd.prefix, photo, tuple(sample_format), fill, tuple(bps_tuple), tuple(extra))
    if key not in OPEN_INFO:
        raise ValueError(f"TIFF: unknown pixel mode {key[1:]} (PIL refuses it too)")
    mode, rawmode = OPEN_INFO[key]
    coded = compression != 1
    if coded:
        if fill == 2:
            mode, rawmode = OPEN_INFO[key[:3] + (1,) + key[4:]]
        if photo == 6 and compression == 7 and planar == 1:
            rawmode = "RGB"  # libjpeg converts the YCbCr to RGB
        elif rawmode == "I;16":
            rawmode = "I;16N"
        elif rawmode.endswith((";16B", ";16L")):
            rawmode = rawmode[:-1] + "N"
    if width <= 0 or height <= 0:
        raise ValueError("TIFF: an image of zero width or height")
    if width * height > MAX_PIXELS:
        raise ValueError(f"TIFF of {width}x{height} pixels is over the limit of {MAX_PIXELS} pixels (PIL's "
                         "decompression-bomb limit)")
    palette = None
    if mode in ("P", "PA"):
        cmap = ifd.get(COLORMAP)
        if cmap is None:
            raise ValueError("TIFF: a palette image without a ColorMap (PIL: KeyError)")
        raw = bytes(v // 256 & 255 for v in cmap)
        n = len(raw) // 3
        if n > 256:
            raise ValueError("TIFF: a colour map of over 256 entries (PIL: invalid palette size)")
        palette = np.stack([np.frombuffer(raw[k * n:(k + 1) * n], np.uint8) for k in range(3)], -1)
    pixelsize = _PIXELSIZE.get(mode, 4)
    image = np.zeros((height, width, pixelsize), np.uint8)
    lib_photo = ifd.lib_get(PHOTOMETRIC)
    if compression == 6 and lib_photo in (None, 2):
        lib_photo = 6  # tif_dirread.c's old-style JPEG hack: YCbCr, not RGB
    if coded and lib_photo == 6 and not (compression == 7 and ifd.lib_get(PLANAR, 1) == 1):
        _decode_ycbcr(data, ifd, mode, rawmode, width, height, image)
    elif coded:
        _decode_coded(data, ifd, mode, rawmode, width, height, image)
    else:
        mapped = _decode_raw(data, ifd, mode, rawmode, width, height, tuple(bps_tuple), bps_count, image, from_path)
        if mapped is not None:
            image = mapped
    if pixelsize == 1:
        pixels = image[..., 0]
    elif pixelsize == 2:
        pixels = image.view(">u2" if mode == "I;16B" else "<u2")[..., 0].astype(np.uint16)
    elif mode == "I":
        pixels = image.view("<i4")[..., 0]
    elif mode == "F":
        pixels = image.view("<f4")[..., 0]
    else:
        pixels = image
    orientation = ifd.get(ORIENTATION)
    if orientation in _ORIENT:
        pixels = np.ascontiguousarray(_ORIENT[orientation](pixels))
    return PilImage(pixels, mode, palette)
