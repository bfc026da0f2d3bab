"""TIFF as PIL 12.1.0 reads it, without PIL (host: the standard library,
numpy and ``csrc/tiff_decode.cpp``).

``decode_tiff`` reads a classic or BigTIFF file's first IFD, byte order II
or MM, as ``TiffImagePlugin`` does (``ImageFileDirectory_v2.load``,
``TiffImageFile._setup``), takes PIL's mode and rawmode from ``OPEN_INFO``
(PIL's table, copied here) and decodes the image along one of PIL's two
paths:

* uncompressed: PIL's own tiles, one a strip or tile in file order, each
  read by PIL's raw decoder from its offset on (the byte counts unread; a
  tile's rows its full width apart; under planar configuration 2 one
  character of the rawmode a plane, as PIL takes it);
* PackBits, LZW (new and old-style codes) and deflate (8 and 32946): PIL
  hands the file to libtiff 4.7.1, which decodes whole strips or tiles
  (FillOrder 2, the predictors, the byte order), and unpacks them with the
  rawmode PIL passes it (16-bit rawmodes in native order; planar files
  through PIL's band unpackers).

EXIF orientation 2-8 is applied as ``TiffImageFile.load_end`` applies it.
What PIL reads and this reader does not is refused with ``ValueError``
naming the form and ROADMAP item 13c: JPEG (6, 7), CCITT (2, 3, 4) and the
other libtiff codecs, YCbCr through libtiff's RGBA path, LAB.
"""
from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from .images import MAX_PIXELS, PilImage

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
READ = {1, 5, 8, 32773, 32946}

# tags (TiffTags): those PIL keeps as one value (length 1) and those it keeps
# as a tuple
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILLORDER = 256, 257, 258, 259, 262, 266
STRIP_OFFSETS, ORIENTATION, SAMPLES, ROWS, STRIP_COUNTS, PLANAR = 273, 274, 277, 278, 279, 284
PREDICTOR, COLORMAP, TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_COUNTS = 317, 320, 322, 323, 324, 325
EXTRA, SAMPLE_FORMAT, WINDOWS_MEDIA_PHOTO = 338, 339, 0xBC01
_SEGMENT_TAGS = {STRIP_OFFSETS, STRIP_COUNTS, TILE_OFFSETS, TILE_COUNTS}
_SINGLE = {WIDTH, LENGTH, COMPRESSION, PHOTOMETRIC, FILLORDER, ORIENTATION, SAMPLES, ROWS, PLANAR, PREDICTOR,
           TILE_WIDTH, TILE_LENGTH}
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


def not_read(form: str) -> ValueError:
    return ValueError(f"TIFF: {form} is not read by this port (PIL reads it through libtiff; ROADMAP item 13c)")


def _bind(lib: ctypes.CDLL) -> None:
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.mvd_tiff_unpacker.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(i)]
    lib.mvd_tiff_unpacker.restype = i
    lib.mvd_tiff_unpack.argtypes = [ctypes.c_char_p, ctypes.c_char_p, p, p, i]
    lib.mvd_tiff_unpack.restype = i
    lib.mvd_tiff_raw.argtypes = [p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_char_p, i64, p, i, i, i, i, i,
                                 ctypes.c_char_p, i]
    lib.mvd_tiff_raw.restype = i
    lib.mvd_tiff_coded.argtypes = [p, ctypes.c_size_t, i, ctypes.POINTER(i), i, i64, i, i64, i, i, i,
                                   ctypes.c_char_p, ctypes.c_char_p, p, i, i, i, i, i, ctypes.c_char_p, i]
    lib.mvd_tiff_coded.restype = i


def _lib() -> ctypes.CDLL:
    from ..kernels._build import load_host

    return load_host("tiff_decode", _bind)


def unpacker_bits(mode: str, rawmode: str) -> Optional[int]:
    """Bits a pixel of PIL's unpacker of ``rawmode`` into ``mode``, or None
    where PIL has none."""
    bits = ctypes.c_int()
    return bits.value if _lib().mvd_tiff_unpacker(mode.encode(), rawmode.encode(), ctypes.byref(bits)) else None


def unpack(mode: str, rawmode: str, data: bytes, pixels: int) -> np.ndarray:
    """PIL's unpacker of ``rawmode`` into ``mode`` on ``pixels`` samples:
    the row as PIL holds it (bytes)."""
    out = np.zeros(pixels * _PIXELSIZE.get(mode, 4), np.uint8)
    src = np.frombuffer(bytes(data), np.uint8)
    if _lib().mvd_tiff_unpack(mode.encode(), rawmode.encode(), src.ctypes.data, out.ctypes.data, pixels):
        raise ValueError(f"no unpacker of rawmode {rawmode} into mode {mode}")
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
            if tag in (BITS, SAMPLE_FORMAT):  # libtiff reads the first SamplesPerPixel values, which must agree
                vals, spp = self.lib_get(tag), self.lib_get(SAMPLES, 1)
                if len(vals) < spp or len(set(vals[:spp])) > 1:
                    return f"tag {tag} has not one value a sample (libtiff: Cannot handle different values per sample)"
        if self.lib_get(PLANAR, 1) not in (1, 2):
            return f"planar configuration {self.lib_get(PLANAR)} (libtiff: Bad value)"
        bits, formats = self.lib_get(BITS, (1,)), self.lib_get(SAMPLE_FORMAT, (1,))
        if not self.lib_get(SAMPLES, 1) or not any(bits) or not formats:
            return "0 samples a pixel, 0 bits a sample or no sample format (libtiff: Bad value)"
        if self.lib_get(PHOTOMETRIC) == 3 and bits[0] < 8:
            # a colour map is read only after BitsPerSample, of 3 << bits values
            cmap = self.entries.get(COLORMAP)
            if BITS not in self.entries or cmap is None or cmap[1] != 3 << bits[0] or cmap[2] is None:
                return "a palette image without its colour map (libtiff: MissingRequired Colormap)"
        return None

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
        if offsets is None:
            raise ValueError("TIFF: no StripOffsets (libtiff refuses it)")
        if not th:
            raise ValueError("TIFF: RowsPerStrip 0 (libtiff refuses it)")
        if th >= 2**32 - 1:
            th = height
        kind = "strip"
    if not counts:  # libtiff estimates them from the file's size
        raise not_read(f"a compressed image without {kind} byte counts")
    return kind, tw, th, list(offsets), list(counts)


def _decode_coded(data: bytes, ifd: Ifd, mode: str, rawmode: str, width: int, height: int,
                  image: np.ndarray) -> None:
    """PIL's ``_load_libtiff``: libtiff's decode of every strip or tile (by
    its own reading of the IFD, the codec too), PIL's unpackers after
    it."""
    if not ifd.valid:
        raise ValueError("TIFF: libtiff refuses the header's byte-order mark (Not a TIFF file, bad version)")
    if ifd.big and not ifd.big_header_ok:
        raise ValueError("TIFF: libtiff refuses the BigTIFF header (bad offset size)")
    refused = ifd.libtiff_refuses()
    if refused:
        raise ValueError(f"TIFF: libtiff refuses the IFD: {refused}")
    lib = _lib()
    compression = ifd.lib_get(COMPRESSION, 1)
    if compression not in READ:
        if compression in COMPRESSION_INFO:
            raise not_read(f"compression {compression} ({COMPRESSION_INFO[compression]})")
        raise ValueError(f"TIFF: libtiff knows no compression {compression}")
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
    if predictor not in (1, 2, 3) and compression in (5, 8, 32946):
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
        if compression in (8, 32946):
            if fill == 2:
                seg = seg.translate(_BITFLIP)
            try:
                seg = zlib.decompressobj().decompress(seg, occ)
            except zlib.error as exc:
                raise ValueError(f"TIFF: deflate: {exc} (libtiff: Decoding error)") from None
            if len(seg) < occ:
                raise ValueError("TIFF: deflate: not enough data for the strip (libtiff: Not enough data)")
            codec = 8
        buf = np.frombuffer(seg, np.uint8)
        umode, uraw = unpackers[p]
        rows = min(th, height - y)
        cols = min(tw, width - x)
        if lib.mvd_tiff_coded(buf.ctypes.data, len(seg), codec, ctypes.byref(style), int(fill == 2), occ, predictor,
                              row_size, plane_spp, bps, swab, umode.encode(), uraw.encode(), image.ctypes.data,
                              image_w, x, y, cols, rows, err, len(err)):
            raise ValueError(err.value.decode())
    extra = ifd.lib_get(EXTRA, ())
    if planes > 1 and mode == "RGBA" and (extra[0] if extra else 0) in (0, 1):
        # PIL unpremultiplies a planar RGBA image whose extra sample libtiff
        # calls associated or unspecified (no ExtraSamples tag: libtiff
        # fills one in unspecified; Corel's 999 it reads as unassociated)
        # once its planes are in, with RGBa's arithmetic (measured)
        flat = image.reshape(-1)
        image[...] = unpack("RGBA", "RGBa", flat.tobytes(), flat.size // 4).reshape(image.shape)


def _decode_raw(data: bytes, ifd: Ifd, mode: str, rawmode: str, width: int, height: int, bps_tuple: tuple,
                bps_count: int, image: np.ndarray) -> None:
    """PIL's tiles of an uncompressed image (``_setup``), sorted by offset,
    runs of equal tiles kept once (the last), each through PIL's raw
    decoder."""
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


_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: a.swapaxes(0, 1), 6: lambda a: np.rot90(a, -1), 7: lambda a: a.swapaxes(0, 1)[::-1, ::-1],
           8: lambda a: np.rot90(a, 1)}


def decode_tiff(data: bytes) -> PilImage:
    """TIFF bytes -> the first image as PIL 12.1.0 holds it, in PIL's mode
    (``OPEN_INFO``): 1, L, P (the colour map's high bytes), LA, PA, I;16,
    I;16B, I, F, RGB, RGBA (RGBa unpremultiplied) or CMYK; strips or tiles,
    planar configuration 1 or 2; uncompressed, PackBits, LZW (new or
    old-style) or deflate (8, 32946) with predictor 2 or 3 and FillOrder 2;
    EXIF orientation applied. Raises ``ValueError`` where PIL or libtiff
    raises, and naming ROADMAP item 13c for what PIL reads and this does
    not; ``RuntimeError`` when the decoder cannot be built."""
    data = bytes(data)
    ifd = Ifd(data)
    if WINDOWS_MEDIA_PHOTO in ifd.tags:
        raise ValueError("TIFF: Windows Media Photo files not yet supported (PIL refuses them too)")
    compression = ifd.get(COMPRESSION, 1)
    if compression not in COMPRESSION_INFO:
        raise ValueError(f"TIFF: compression {compression} is unknown (PIL: KeyError)")
    if compression not in READ:
        raise not_read(f"compression {compression} ({COMPRESSION_INFO[compression]})")
    planar = ifd.get(PLANAR, 1)
    photo = ifd.get(PHOTOMETRIC, 0)
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
    spp = ifd.get(SAMPLES, 1)
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
        if photo == 6:
            raise not_read("YCbCr through libtiff's RGBA path")
        if rawmode == "I;16":
            rawmode = "I;16N"
        elif rawmode.endswith((";16B", ";16L")):
            rawmode = rawmode[:-1] + "N"
    if mode == "LAB":
        raise not_read("LAB")
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
    if coded:
        _decode_coded(data, ifd, mode, rawmode, width, height, image)
    else:
        _decode_raw(data, ifd, mode, rawmode, width, height, tuple(bps_tuple), bps_count, image)
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
