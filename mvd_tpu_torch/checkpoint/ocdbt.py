"""A read-only OCDBT key-value store: the on-disk layout that orbax writes
the JAX package's checkpoints in (through tensorstore's ``ocdbt`` driver),
read with ``os.pread`` and the port's own zstd decoder.

The layout, structure by structure (integers are LEB128 varints unless
named otherwise; every list is stored column by column):

* every manifest and node is a container: a u32 big-endian magic
  (manifest ``0x0cdb3a2a``, B+tree node ``0x0cdb20de``, version-tree node
  ``0x0cdb1234``), a u64 little-endian total length, the format version
  (0), the compression (0 none, 1 zstd), the body (a zstd frame when
  compressed), and a u32 little-endian CRC-32C of everything before it;
* a data-file table opens every body that points at other files: the
  count, the shared-prefix lengths of paths 2..n with the path before, the
  suffix lengths, the base-path lengths, then the suffixes. A file's path is
  its base path plus its relative path under the store's root, so the
  ``ocdbt.process_<i>/d/...`` files of a multi-process save resolve;
* the manifest: the config (a 16-byte uuid, the manifest kind, the largest
  inline value, the largest decoded node, the version tree's arity log2 as
  a byte, the compression method and, for zstd, its level as an i32), the
  data-file table, the newest versions (generation, root height as a byte,
  root location as data file, offset, length, the root's key count, tree
  bytes and indirect value bytes, commit time as a u64), then references to
  version-tree nodes for older generations (generation, location, count of
  generations, commit time, height as a byte);
* a B+tree node: its height as a byte, the data-file table and its
  entries. Keys are prefix-compressed (the prefix each key shares with the
  one before, the suffix lengths, then the suffixes) and relative to the
  prefix its parent entries carried down. A leaf then holds each value's
  length and kind (0 inline, 1 indirect), the data file and offset of the
  indirect ones, and the inline values end to end. An interior node holds,
  after the suffix lengths, each entry's subtree-common-prefix length, then
  the child locations and statistics.

Every container's CRC-32C and the manifest's ``max_decoded_node_bytes`` are
checked; a structure that does not parse raises ``ValueError`` naming the
file and the fault. Nothing else (no orbax, tensorstore or zstd library)
is tried.
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Dict, List, NamedTuple, Optional

from .zstd import crc32c, decompress

MANIFEST_MAGIC, BTREE_MAGIC, VERSION_MAGIC = 0x0CDB3A2A, 0x0CDB20DE, 0x0CDB1234
MANIFEST_FILE = "manifest.ocdbt"


class Location(NamedTuple):
    path: str  # base path + relative path under the store's root
    offset: int
    length: int


class Value(NamedTuple):
    """A leaf's value: ``inline`` bytes, or the ``location`` of indirect
    bytes in a data file."""
    inline: Optional[bytes]
    location: Optional[Location]


class _Body:
    """A cursor over a decoded body."""

    def __init__(self, data: bytes, what: str):
        self.d, self.p, self.what = data, 0, what

    def fail(self, msg: str):
        raise ValueError(f"OCDBT {self.what}: {msg}")

    def u8(self) -> int:
        if self.p >= len(self.d):
            self.fail("truncated")
        self.p += 1
        return self.d[self.p - 1]

    def varint(self) -> int:
        v = shift = 0
        while True:
            b = self.u8()
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.p + n > len(self.d):
            self.fail("truncated")
        self.p += n
        return self.d[self.p - n:self.p]

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f"<{n}Q", self.raw(8 * n))) if n else []

    def end(self) -> None:
        if self.p != len(self.d):
            self.fail(f"{len(self.d) - self.p} bytes after the last field")

    def data_files(self) -> List[str]:
        n = self.varint()
        prefix = [0] + self.varints(max(n - 1, 0))
        suffix = self.varints(n)
        base = self.varints(n)
        paths, prev = [], b""
        for i in range(n):
            if prefix[i] > len(prev):
                self.fail(f"data file {i} shares {prefix[i]} bytes with a path of {len(prev)}")
            path = prev[:prefix[i]] + self.raw(suffix[i])
            if base[i] > len(path):
                self.fail(f"data file {i}'s base path is longer than its path")
            paths.append(path.decode())
            prev = path
        return paths

    def locations(self, files: List[str], n: int) -> List[Location]:
        ids, offsets, lengths = self.varints(n), self.varints(n), self.varints(n)
        for i in ids:
            if i >= len(files):
                self.fail(f"data file id {i} past the table of {len(files)}")
        return [Location(files[i], o, ln) for i, o, ln in zip(ids, offsets, lengths)]


def decode_container(blob: bytes, magic: int, what: str, max_decoded: Optional[int] = None) -> bytes:
    """The body of a manifest or node, its header, length and CRC-32C
    checked and its zstd frame decoded."""
    if len(blob) < 18:
        raise ValueError(f"OCDBT {what}: {len(blob)} bytes is shorter than a header and footer")
    got_magic, length = struct.unpack(">I", blob[:4])[0], struct.unpack("<Q", blob[4:12])[0]
    if got_magic != magic:
        raise ValueError(f"OCDBT {what}: magic 0x{got_magic:08x}, expected 0x{magic:08x}")
    if length != len(blob):
        raise ValueError(f"OCDBT {what}: header says {length} bytes, found {len(blob)}")
    want_crc = struct.unpack("<I", blob[-4:])[0]
    if crc32c(blob[:-4]) != want_crc:
        raise ValueError(f"OCDBT {what}: CRC-32C mismatch")
    head = _Body(blob[12:-4], what)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"OCDBT {what}: format version {version} (only 0 is read)")
    body = blob[12 + head.p:-4]
    if compression == 1:
        body = decompress(body)
    elif compression != 0:
        raise ValueError(f"OCDBT {what}: compression format {compression} (0 none and 1 zstd are read)")
    if max_decoded is not None and len(body) > max_decoded:
        raise ValueError(f"OCDBT {what}: decodes to {len(body)} bytes, above max_decoded_node_bytes "
                         f"{max_decoded}")
    return body


def _versions(b: _Body, files: List[str]) -> List[dict]:
    n = b.varint()
    gens = b.varints(n)
    heights = [b.u8() for _ in range(n)]
    locs = b.locations(files, n)
    keys, tree_bytes, indirect = b.varints(n), b.varints(n), b.varints(n)
    times = b.u64s(n)
    return [dict(generation_number=gens[i], root_height=heights[i], root=locs[i],
                 num_keys=keys[i], num_tree_bytes=tree_bytes[i], num_indirect_value_bytes=indirect[i],
                 commit_time=times[i]) for i in range(n)]


def _version_refs(b: _Body, files: List[str], n: int, with_height: bool) -> List[dict]:
    gens = b.varints(n)
    locs = b.locations(files, n)
    counts = b.varints(n)
    times = b.u64s(n)
    heights = [b.u8() for _ in range(n)] if with_height else [None] * n
    return [dict(generation_number=gens[i], location=locs[i], num_generations=counts[i],
                 commit_time=times[i], height=heights[i]) for i in range(n)]


class OcdbtStore:
    """The newest version of the OCDBT store rooted at ``root`` (the
    directory holding ``manifest.ocdbt``): ``list()`` its keys, ``read(key)``
    a value, ``location(key)`` where an indirect value lies. Data files are
    opened once and read with ``os.pread``; ``close()`` closes them."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._fds: Dict[str, int] = {}
        self._lock = threading.Lock()
        path = os.path.join(self.root, MANIFEST_FILE)
        if not os.path.isfile(path):
            raise ValueError(f"{self.root}: no {MANIFEST_FILE}, not an OCDBT store")
        with open(path, "rb") as f:
            self.manifest = self._parse_manifest(f.read())
        self._index: Optional[Dict[bytes, Value]] = None

    # ------------------------------------------------------------ files
    def _fd(self, path: str) -> int:
        with self._lock:
            fd = self._fds.get(path)
            if fd is None:
                full = os.path.join(self.root, path)
                try:
                    fd = os.open(full, os.O_RDONLY)
                except OSError as e:
                    raise ValueError(f"OCDBT data file {full} cannot be opened: {e}") from e
                self._fds[path] = fd
            return fd

    def read_location(self, loc: Location) -> bytes:
        """The bytes at ``loc``; a short read raises."""
        data = os.pread(self._fd(loc.path), loc.length, loc.offset)
        if len(data) != loc.length:
            raise ValueError(f"OCDBT data file {os.path.join(self.root, loc.path)}: {loc.length} bytes "
                             f"at offset {loc.offset} asked, {len(data)} there")
        return data

    def close(self) -> None:
        with self._lock:
            for fd in self._fds.values():
                os.close(fd)
            self._fds.clear()

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ manifest
    def _parse_manifest(self, blob: bytes) -> dict:
        what = f"manifest {os.path.join(self.root, MANIFEST_FILE)}"
        b = _Body(decode_container(blob, MANIFEST_MAGIC, what), what)
        config = dict(uuid=b.raw(16).hex())
        kind = b.varint()
        if kind != 0:
            b.fail(f"manifest kind {kind} (numbered manifests are not read; only a single manifest file)")
        config["max_inline_value_bytes"] = b.varint()
        config["max_decoded_node_bytes"] = b.varint()
        config["version_tree_arity_log2"] = b.u8()
        method = b.varint()
        if method == 0:
            config["compression"] = None
        elif method == 1:
            config["compression"] = {"id": "zstd", "level": struct.unpack("<i", b.raw(4))[0]}
        else:
            b.fail(f"compression method {method}")
        files = b.data_files()
        versions = _versions(b, files)
        refs = _version_refs(b, files, b.varint(), with_height=True)
        b.end()
        if not versions:
            b.fail("no version")
        return dict(config=config, versions=versions, version_tree_nodes=refs)

    @property
    def max_decoded(self) -> int:
        return self.manifest["config"]["max_decoded_node_bytes"]

    def version_node(self, loc: Location) -> dict:
        """A version-tree node: its height, arity log2 and entries
        (versions at height 0, references to child nodes above)."""
        what = f"version-tree node {loc.path}:{loc.offset}:{loc.length}"
        b = _Body(decode_container(self.read_location(loc), VERSION_MAGIC, what, self.max_decoded), what)
        arity, height = b.u8(), b.u8()
        files = b.data_files()
        if height == 0:
            entries = _versions(b, files)
        else:
            entries = _version_refs(b, files, b.varint(), with_height=False)
        b.end()
        return dict(version_tree_arity_log2=arity, height=height, entries=entries)

    def versions(self) -> List[dict]:
        """Every version the manifest reaches, oldest first: the ones in
        version-tree nodes, then the manifest's own."""
        out = []

        def walk(loc: Location):
            node = self.version_node(loc)
            for e in node["entries"]:
                if node["height"] == 0:
                    out.append(e)
                else:
                    walk(e["location"])

        for ref in self.manifest["version_tree_nodes"]:
            walk(ref["location"])
        return out + self.manifest["versions"]

    # ------------------------------------------------------------ B+tree
    def btree_node(self, loc: Location) -> dict:
        """A B+tree node: its height and entries, keys relative to the
        prefix its parent carried down. A leaf entry is (key, Value); an
        interior one (key, subtree_common_prefix, child Location,
        statistics)."""
        what = f"B+tree node {loc.path}:{loc.offset}:{loc.length}"
        b = _Body(decode_container(self.read_location(loc), BTREE_MAGIC, what, self.max_decoded), what)
        height = b.u8()
        files = b.data_files()
        n = b.varint()
        if n == 0:
            b.fail("no entries")
        prefix = [0] + b.varints(n - 1)
        suffix = b.varints(n)
        common = b.varints(n) if height > 0 else None
        keys, prev = [], b""
        for i in range(n):
            if prefix[i] > len(prev):
                b.fail(f"key {i} shares {prefix[i]} bytes with a key of {len(prev)}")
            key = prev[:prefix[i]] + b.raw(suffix[i])
            if i and key <= prev:
                b.fail(f"keys out of order at entry {i}")
            keys.append(key)
            prev = key
        entries = []
        if height == 0:
            lengths = b.varints(n)
            kinds = b.varints(n)
            if any(k > 1 for k in kinds):
                b.fail(f"value kind {max(kinds)} (0 inline and 1 indirect are read)")
            indirect = [i for i in range(n) if kinds[i] == 1]
            m = len(indirect)
            ids, offsets = b.varints(m), b.varints(m)
            where = {}
            for j, i in enumerate(indirect):
                if ids[j] >= len(files):
                    b.fail(f"data file id {ids[j]} past the table of {len(files)}")
                where[i] = Location(files[ids[j]], offsets[j], lengths[i])
            for i in range(n):
                if kinds[i] == 0:
                    entries.append((keys[i], Value(b.raw(lengths[i]), None)))
                else:
                    entries.append((keys[i], Value(None, where[i])))
        else:
            for i in range(n):
                if common[i] > len(keys[i]):
                    b.fail(f"entry {i}'s common prefix is longer than its key")
            locs = b.locations(files, n)
            stats = list(zip(b.varints(n), b.varints(n), b.varints(n)))
            for i in range(n):
                entries.append((keys[i], keys[i][:common[i]], locs[i],
                                dict(num_keys=stats[i][0], num_tree_bytes=stats[i][1],
                                     num_indirect_value_bytes=stats[i][2])))
        b.end()
        return dict(height=height, entries=entries)

    def _walk(self, loc: Location, height: int, prefix: bytes, out: Dict[bytes, Value]) -> None:
        node = self.btree_node(loc)
        if node["height"] != height:
            raise ValueError(f"OCDBT B+tree node {loc}: height {node['height']}, its parent says {height}")
        if height == 0:
            for key, value in node["entries"]:
                out[prefix + key] = value
        else:
            for _, common, child, _ in node["entries"]:
                self._walk(child, height - 1, prefix + common, out)

    def index(self) -> Dict[bytes, Value]:
        """Every key of the newest version and its value, in key order."""
        if self._index is None:
            v = self.manifest["versions"][-1]
            out: Dict[bytes, Value] = {}
            if v["num_keys"]:
                self._walk(v["root"], v["root_height"], b"", out)
            if len(out) != v["num_keys"]:
                raise ValueError(f"OCDBT {self.root}: {len(out)} keys found, the manifest says {v['num_keys']}")
            self._index = out
        return self._index

    def list(self) -> List[bytes]:
        return list(self.index())

    def value(self, key) -> Value:
        key = key.encode() if isinstance(key, str) else bytes(key)
        try:
            return self.index()[key]
        except KeyError:
            raise KeyError(f"OCDBT {self.root}: no key {key!r}") from None

    def read(self, key) -> bytes:
        v = self.value(key)
        return v.inline if v.location is None else self.read_location(v.location)

    def has(self, key) -> bool:
        key = key.encode() if isinstance(key, str) else bytes(key)
        return key in self.index()


__all__ = ["OcdbtStore", "Location", "Value", "decode_container"]
