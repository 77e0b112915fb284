"""Versioned binary bitstream container, the same format as the JAX
package's (``epic_tpu/codec/container.py``): a container written by
either package loads in the other, and the same bitstreams give the same
bytes.

Layout: the magic ``EPICTPU1``, the header's length (uint32, little
endian), a JSON header (shapes, quality ladder, per-message byte counts,
the per-level prefix table) and then the concatenated rANS blobs.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict

import numpy as np

_MAGIC = b"EPICTPU1"


def _collect(tree):
    """Flatten nested containers of bytes -> (spec, blobs). Lists/tuples,
    dicts and JSON scalars are supported so aux payloads (e.g. embedded
    REM check-level streams from ``PICCodec.compress``) serialize
    wholesale."""
    if isinstance(tree, (bytes, bytearray)):
        return {"t": "b", "n": len(tree)}, [bytes(tree)]
    if isinstance(tree, (list, tuple)):
        specs, blobs = [], []
        for item in tree:
            s, b = _collect(item)
            specs.append(s)
            blobs.extend(b)
        return {"t": "l", "items": specs}, blobs
    if isinstance(tree, dict):
        keys = list(tree.keys())
        bad = [k for k in keys if not isinstance(k, str)]
        if bad:
            # json.dumps would silently stringify these (1 -> '1') and the
            # rebuilt dict would differ from what was serialized
            raise TypeError(f"bitstream dict keys must be str, got {bad!r}")
        specs, blobs = [], []
        for k in keys:
            s, b = _collect(tree[k])
            specs.append(s)
            blobs.extend(b)
        return {"t": "d", "keys": keys, "items": specs}, blobs
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"t": "j", "v": tree}, []
    raise TypeError(f"unsupported bitstream leaf {type(tree)}")


def _rebuild(spec, blobs, pos):
    if spec["t"] == "b":
        blob = blobs[pos[0]]
        pos[0] += 1
        return blob
    if spec["t"] == "j":
        return spec["v"]
    if spec["t"] == "d":
        return {k: _rebuild(s, blobs, pos)
                for k, s in zip(spec["keys"], spec["items"])}
    return [_rebuild(s, blobs, pos) for s in spec["items"]]


def dump_bitstreams(bs: Dict[str, Any]) -> bytes:
    """Serialize a progressive bitstream dict:

    - "stream" (``progressive_encode``): {"q_list", "shape", "z": [bytes],
      "y": [bytes], "prefix": [B, nq+1] per-level decode-prefix byte
      counts}; the prefix table rides in the header (it is what a
      streaming server needs to truncate each y blob);
    - "messages" (the JAX package's per-(shell, image) layout): {"q_list",
      "shape", "z", "base": [[bytes]], "progressive": [[bytes]]}.

    Optional "ckpt_streams" (e.g. the check levels' ``compress`` outputs,
    so a receiver rebuilds the REM checkpoint latents) and "meta" (JSON)
    ride along. "io_chain" names the JAX package's base-chain program
    family; the port's streams have none (False)."""
    layout = bs.get("layout",
                    "stream" if "y" in bs else "messages")
    header: Dict[str, Any] = {"q_list": list(bs["q_list"]),
                              "shape": list(bs["shape"]),
                              "layout": layout,
                              # the JAX package's base-chain program
                              # family (its fused io-callback chain or
                              # not); kept so both write the same bytes
                              "io_chain": bool(bs.get("io_chain"))}
    keys = ("z", "y") if layout == "stream" else ("z", "base",
                                                  "progressive")
    if layout == "stream":
        header["prefix"] = np.asarray(bs["prefix"]).tolist()
    blobs: list[bytes] = []
    for key in keys:
        spec, bl = _collect(bs[key])
        header[key] = spec
        header[key + "_count"] = len(bl)
        blobs.extend(bl)
    # optional aux payloads: embedded check-level streams for a
    # standalone REM decode + JSON metadata
    if bs.get("ckpt_streams"):
        spec, bl = _collect(bs["ckpt_streams"])
        header["ckpt_streams"] = spec
        blobs.extend(bl)
    if bs.get("meta") is not None:
        header["meta"] = bs["meta"]
    hdr = json.dumps(header).encode()
    payload = b"".join(blobs)
    return _MAGIC + struct.pack("<I", len(hdr)) + hdr + payload


def load_bitstreams(data: bytes) -> Dict[str, Any]:
    """Parse a container written by ``dump_bitstreams`` (of either
    package) back into the bitstream dict."""
    if data[:8] != _MAGIC:
        raise ValueError("not an epic_tpu bitstream")
    (hlen,) = struct.unpack("<I", data[8:12])
    header = json.loads(data[12:12 + hlen])
    body = data[12 + hlen:]
    layout = header.get("layout", "messages")
    keys = ("z", "y") if layout == "stream" else ("z", "base",
                                                  "progressive")

    def sizes(spec):
        if spec["t"] == "b":
            return [spec["n"]]
        if spec["t"] == "j":
            return []
        out = []
        for s in spec["items"]:
            out.extend(sizes(s))
        return out

    aux_keys = [k for k in ("ckpt_streams",) if k in header]
    all_sizes = []
    for key in list(keys) + aux_keys:
        all_sizes.extend(sizes(header[key]))
    blobs, off = [], 0
    for n in all_sizes:
        blobs.append(body[off:off + n])
        off += n
    out: Dict[str, Any] = {"q_list": header["q_list"],
                           "shape": tuple(header["shape"]),
                           "layout": layout,
                           "io_chain": bool(header.get("io_chain"))}
    if layout == "stream":
        out["prefix"] = np.asarray(header["prefix"], dtype=np.int64)
    pos = [0]
    for key in list(keys) + aux_keys:
        out[key] = _rebuild(header[key], blobs, pos)
    if "meta" in header:
        out["meta"] = header["meta"]
    return out
