"""A reader of OCDBT key-value stores, the on-disk format in which Orbax
(through tensorstore) writes the JAX package's checkpoints.

It follows tensorstore's documented format (``kvstore/ocdbt``), in Python
and numpy, with the repository's own zstd decoder (``native/zstd.py``):

- every manifest and b-tree node is an envelope: a big-endian magic, the
  little-endian total length, a version varint (0), a compression varint
  (0 none, 1 zstd) and the body, then the CRC-32C of all that;
- the manifest (``manifest.ocdbt``, ``manifest_kind`` "single" as Orbax
  writes it) holds the config, a data-file table and the version tree's
  newest entries, each with the location of its b-tree root;
- b-tree nodes hold their own data-file table and, column by column, keys
  with prefix compression; interior nodes name their children, whose keys
  are relative to the entry's subtree common prefix; leaf values are inline
  or references into data files;
- a data file is named by a base path and a relative path, both relative to
  the store's directory, so the ``ocdbt.process_N/`` files that a root
  manifest names read like its own ``d/`` files.

``read_ocdbt(path)`` returns ``{key: bytes}`` of the newest version.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

import numpy as np

from ..native import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_NODE_MAGIC = 0x0CDB20DE
_NO_ROOT = (1 << 64) - 1


def _crc32c_table() -> np.ndarray:
    table = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        table = np.where(table & 1, (table >> 1) ^ np.uint32(0x82F63B78),
                         table >> 1).astype(np.uint32)
    return table


_CRC_TABLE = [int(v) for v in _crc32c_table()]


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as the envelopes' footers hold it."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise ValueError(f"OCDBT {self.what}: truncated")

    def varint(self) -> int:
        value = shift = 0
        while True:
            self._need(1)
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"OCDBT {self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def byte(self) -> int:
        self._need(1)
        self.pos += 1
        return self.data[self.pos - 1]

    def take(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def done(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"OCDBT {self.what}: {len(self.data) - self.pos} "
                             "bytes left over")


def _envelope(data: bytes, magic: int, what: str) -> _Reader:
    """Checks an envelope's magic, length and CRC-32C; returns its body."""
    if len(data) < 18:
        raise ValueError(f"OCDBT {what}: truncated")
    got_magic, length = struct.unpack_from(">I", data)[0], \
        struct.unpack_from("<Q", data, 4)[0]
    if got_magic != magic:
        raise ValueError(f"OCDBT {what}: bad magic {got_magic:#010x}")
    if length != len(data):
        raise ValueError(f"OCDBT {what}: length {length} != {len(data)} "
                         "bytes read")
    if crc32c(data[:-4]) != struct.unpack_from("<I", data, len(data) - 4)[0]:
        raise ValueError(f"OCDBT {what}: CRC-32C mismatch")
    r = _Reader(data[:-4], what)
    r.pos = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise ValueError(f"OCDBT {what}: format version {version}")
    body = data[r.pos:-4]
    if compression == 1:
        body = zstd.decompress(body)
    elif compression != 0:
        raise ValueError(f"OCDBT {what}: compression format {compression}")
    return _Reader(body, what)


def _data_file_table(r: _Reader) -> List[str]:
    """The data-file table: paths with prefix compression, each a base path
    and a relative path joined (both relative to the store's directory)."""
    n = r.varint()
    if n == 0:
        return []
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    base = r.varints(n)
    paths: List[bytes] = []
    for i in range(n):
        prev = paths[-1] if paths else b""
        if prefix[i] > len(prev):
            raise ValueError(f"OCDBT {r.what}: bad data-file path prefix")
        paths.append(prev[:prefix[i]] + r.take(suffix[i]))
        if base[i] > len(paths[-1]):
            raise ValueError(f"OCDBT {r.what}: bad data-file base path")
    return [p.decode() for p in paths]


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys: List[bytes] = []
    for i in range(n):
        prev = keys[-1] if keys else b""
        if prefix[i] > len(prev):
            raise ValueError(f"OCDBT {r.what}: bad key prefix")
        keys.append(prev[:prefix[i]] + r.take(suffix[i]))
    return keys, common


class _Store:
    def __init__(self, root: str):
        self.root = root

    def read(self, relpath: str, offset: int, length: int) -> bytes:
        path = os.path.join(self.root, relpath)
        if not os.path.isfile(path):
            raise ValueError(f"OCDBT: missing data file {path}")
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"OCDBT: {path} ends before byte "
                             f"{offset + length}")
        return data

    def manifest(self) -> Tuple[List[str], List[dict]]:
        path = os.path.join(self.root, "manifest.ocdbt")
        if not os.path.isfile(path):
            raise ValueError(f"OCDBT: no manifest.ocdbt in {self.root}")
        with open(path, "rb") as f:
            r = _envelope(f.read(), MANIFEST_MAGIC, "manifest")
        r.take(16)  # the config: uuid
        kind = r.varint()
        r.varints(2)  # max_inline_value_bytes, max_decoded_node_bytes
        r.byte()  # version_tree_arity_log2
        if r.varint() == 1:
            r.take(4)  # zstd level
        if kind != 0:  # Orbax writes "single"
            raise ValueError(f"OCDBT: manifest kind {kind} (only 'single' "
                             "is supported)")
        files = _data_file_table(r)
        n = r.varint()
        gen = r.varints(n)
        height = [r.byte() for _ in range(n)]
        cols = [r.varints(n) for _ in range(6)]
        r.take(8 * n)  # commit times
        versions = [dict(generation=gen[i], height=height[i],
                         file=cols[0][i], offset=cols[1][i],
                         length=cols[2][i], num_keys=cols[3][i])
                    for i in range(n)]
        # older versions live in version-tree nodes; the newest is inline
        return files, versions

    def node(self, relpath: str, offset: int, length: int, height: int,
             prefix: bytes, out: Dict[str, bytes]) -> None:
        what = f"b-tree node {relpath}@{offset}"
        r = _envelope(self.read(relpath, offset, length), BTREE_NODE_MAGIC,
                      what)
        if r.byte() != height:
            raise ValueError(f"OCDBT {what}: height differs from its parent's")
        files = _data_file_table(r)
        n = r.varint()
        if n == 0:
            r.done()
            return
        keys, common = _keys(r, n, height > 0)

        def file_of(i: int) -> str:
            if i >= len(files):
                raise ValueError(f"OCDBT {what}: data file {i} out of range")
            return files[i]

        if height > 0:
            fid, off, ln = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)  # num_keys, num_tree_bytes, indirect bytes
            r.done()
            for i in range(n):
                if common[i] > len(keys[i]):
                    raise ValueError(f"OCDBT {what}: bad subtree prefix")
                self.node(file_of(fid[i]), off[i], ln[i], height - 1,
                          prefix + keys[i][:common[i]], out)
            return
        lengths = r.varints(n)
        kinds = [r.byte() for _ in range(n)]
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k not in (0, 1) for k in kinds):
            raise ValueError(f"OCDBT {what}: unknown value kind")
        fid, off = r.varints(len(indirect)), r.varints(len(indirect))
        refs = dict(zip(indirect, zip(fid, off)))
        for i in range(n):
            key = (prefix + keys[i]).decode()
            if i in refs:
                f, o = refs[i]
                out[key] = self.read(file_of(f), o, lengths[i])
            else:
                out[key] = r.take(lengths[i])
        r.done()


def read_ocdbt(path: str) -> Dict[str, bytes]:
    """The newest version of the OCDBT store in directory ``path`` as
    ``{key: value}``."""
    store = _Store(os.path.abspath(path))
    files, versions = store.manifest()
    if not versions:
        return {}
    v = max(versions, key=lambda v: v["generation"])
    out: Dict[str, bytes] = {}
    if v["offset"] == _NO_ROOT or v["num_keys"] == 0:
        return out
    if v["file"] >= len(files):
        raise ValueError("OCDBT manifest: data file out of range")
    store.node(files[v["file"]], v["offset"], v["length"], v["height"], b"",
               out)
    if len(out) != v["num_keys"]:
        raise ValueError(f"OCDBT: read {len(out)} keys, the manifest says "
                         f"{v['num_keys']}")
    return out
