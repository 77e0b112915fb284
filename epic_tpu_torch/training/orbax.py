"""Reads the Orbax checkpoints that the JAX package's training writes
(``ocp.StandardCheckpointer().save``), without JAX, Orbax or tensorstore.

An Orbax checkpoint directory holds ``_METADATA`` (JSON: the tree's leaves
by key path, ``use_ocdbt``, ``use_zarr3``) and one zarr v2 array per leaf,
named by its key path joined with dots (``g_a.layers_0.kernel``):

- with ``use_ocdbt`` (Orbax's default) the arrays live in one OCDBT
  key-value store (``training/ocdbt.py``) under keys such as
  ``g_a.layers_0.kernel/.zarray`` and ``g_a.layers_0.kernel/0.0.0.0``;
- without it, each array is a directory with a ``.zarray`` file and one
  file per chunk.

Each chunk is raw or one zstd frame (``native/zstd.py``), in C order, full
size at the array's edges. ``read_orbax`` is the counterpart of
``ocp.StandardCheckpointer().restore(path)`` for the JAX package's trees
(nested dicts of arrays): ``<f4``, ``<f2``, ``<i4``, ``<i8`` and ``bfloat16``
(returned as numpy's opaque ``|V2``, as ``np.load`` surfaces it from npz;
``convert`` widens it exactly). zarr3 arrays, filters, Fortran order and
missing chunks (Orbax writes every chunk; its fill_value is null) are
refused with a message naming the feature. Writing stays npz (``training/checkpoint.py``), which both
packages read.
"""

from __future__ import annotations

import ast
import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from ..native import zstd
from .ocdbt import read_ocdbt

_THREADS = 8
_DTYPES = {"<f4": np.dtype("<f4"), "<f2": np.dtype("<f2"),
           "<i4": np.dtype("<i4"), "<i8": np.dtype("<i8"),
           "bfloat16": np.dtype("V2")}


def _leaf_paths(meta: Dict[str, Any], where: str) -> Dict[str, Tuple]:
    """``{zarr array name: key path}`` of the tree's leaves."""
    out = {}
    for name, leaf in meta["tree_metadata"].items():
        keys = leaf.get("key_metadata")
        path = (tuple(k["key"] for k in keys) if keys is not None
                else tuple(ast.literal_eval(name)))
        out[".".join(str(k) for k in path)] = path
    if not out:
        raise ValueError(f"{where}: Orbax checkpoint with no arrays")
    return out


def _decode_array(name: str, get: Callable[[str], Optional[bytes]],
                  where: str) -> np.ndarray:
    raw = get(f"{name}/.zarray")
    if raw is None:
        raise ValueError(f"{where}: no zarr array {name!r} (zarr v2 "
                         ".zarray missing)")
    spec = json.loads(raw)
    if spec.get("zarr_format") != 2:
        raise ValueError(f"{where}: {name}: zarr format "
                         f"{spec.get('zarr_format')} is not supported")
    dtype = _DTYPES.get(spec["dtype"])
    if dtype is None:
        raise ValueError(f"{where}: {name}: dtype {spec['dtype']!r} is not "
                         "supported")
    if spec.get("filters"):
        raise ValueError(f"{where}: {name}: zarr filters are not supported")
    if spec.get("order", "C") != "C":
        raise ValueError(f"{where}: {name}: zarr order "
                         f"{spec['order']!r} is not supported")
    comp = spec.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{where}: {name}: compressor {comp.get('id')!r} "
                         "is not supported")
    shape, chunks = tuple(spec["shape"]), tuple(spec["chunks"])
    sep = spec.get("dimension_separator", ".")
    out = np.empty(shape, dtype)
    grid = [math.ceil(s / c) if c else 0 for s, c in zip(shape, chunks)]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    for idx in np.ndindex(*grid):
        key = sep.join(str(i) for i in idx) if idx else "0"
        data = get(f"{name}/{key}")
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        if data is None:  # Orbax stores every chunk
            raise ValueError(f"{where}: {name}: chunk {key} is missing "
                             f"(fill_value {spec.get('fill_value')!r}; "
                             "missing chunks are not supported)")
        buf = np.empty(chunk_bytes, np.uint8)
        if comp is None:
            if len(data) != chunk_bytes:
                raise ValueError(f"{where}: {name}: chunk {key} holds "
                                 f"{len(data)} bytes, expected {chunk_bytes}")
            buf[:] = np.frombuffer(data, np.uint8)
        else:
            try:
                zstd.decompress_into(data, buf)
            except ValueError as e:
                raise ValueError(f"{where}: {name}: chunk {key}: {e}") from None
        block = buf.view(dtype).reshape(chunks)
        out[region] = block[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    return out


def _nest(flat: Dict[Tuple, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return tree


def read_orbax(path: str) -> Dict[str, Any]:
    """An Orbax checkpoint directory -> nested dict of numpy arrays, as
    ``ocp.StandardCheckpointer().restore(path)`` gives it. The arrays are
    decoded by ``_THREADS`` threads (the zstd decoder releases the GIL)."""
    path = os.path.abspath(path)
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_path):
        raise ValueError(f"{path}: not an Orbax checkpoint (no _METADATA)")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: zarr3 arrays (use_zarr3) are not supported")
    leaves = _leaf_paths(meta, path)
    if meta.get("use_ocdbt", False):
        kv = read_ocdbt(path)
        get = kv.get
    else:
        def get(key: str) -> Optional[bytes]:
            file = os.path.join(path, *key.split("/"))
            if not os.path.isfile(file):
                return None
            with open(file, "rb") as f:
                return f.read()
    with ThreadPoolExecutor(_THREADS) as pool:
        arrays = dict(zip(leaves, pool.map(
            lambda name: _decode_array(name, get, path), leaves)))
    return _nest({leaves[name]: a for name, a in arrays.items()})
