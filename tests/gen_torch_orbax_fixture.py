"""Write ``tests/fixtures/orbax/flagship_tiled/`` and
``tests/fixtures/orbax/flagship_tiled.json``: an Orbax checkpoint written by
the JAX package's own ``save_checkpoint`` at the flagship ``rem`` model's
full width, and the SHA-256 of each of its arrays as the JAX package's own
``load_checkpoint`` restores them.

The tree has the shapes of ``artifacts/ckpt_r5_flagship`` (609 arrays,
623.3 MiB of float32). Each array holds its own first 1,021 values (the
artifact's bf16 widened to float32), tiled across its shape, so that zstd
shrinks the checkpoint to about 1.5 MB while every array still has real
weights at its start. ``tests/test_torch_orbax.py`` and ``chip_smoke.py``
phase 19 read the directory with the port's reader and hold every array to
the SHA-256 here.

It also writes ``tests/fixtures/orbax/normals_f32.zst``: one zstd frame (level
1, as Orbax's zarr chunks are written) of 4 MiB of seeded float32 normals,
data on which zstd finds few matches, as on trained weights; its decoded
SHA-256 is the JSON's ``zstd_normals``. Phase 19 times the port's decoder on
it beside the tiled checkpoint, whose chunks are mostly match copies.

Not collected by pytest. Regenerate with:

    JAX_PLATFORMS=cpu python tests/gen_torch_orbax_fixture.py
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SOURCE = os.path.join(ROOT, "artifacts", "ckpt_r5_flagship")
FIXTURE_DIR = os.path.join(HERE, "fixtures", "orbax", "flagship_tiled")
FIXTURE_JSON = os.path.join(HERE, "fixtures", "orbax", "flagship_tiled.json")
NORMALS_ZST = os.path.join(HERE, "fixtures", "orbax", "normals_f32.zst")
TILE = 1021
NORMALS = 1 << 20  # float32 values


def normals_frame():
    """(the frame, the record of its decoded bytes) of ``NORMALS_ZST``."""
    import zstandard

    raw = np.random.default_rng(0).standard_normal(NORMALS).astype(
        np.float32).tobytes()
    frame = zstandard.ZstdCompressor(level=1).compress(raw)
    return frame, {"file": os.path.relpath(NORMALS_ZST, ROOT),
                   "bytes": len(raw), "frame_bytes": len(frame),
                   "sha256": hashlib.sha256(raw).hexdigest()}


def widen(a: np.ndarray) -> np.ndarray:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return np.asarray(a, np.float32)


def tiled_tree():
    """``{"a/b/c": float32 array}`` of the flagship shapes, tiled."""
    out = {}
    with np.load(os.path.join(SOURCE, "last.npz")) as z:
        for k in z.files:
            a = widen(z[k])
            out[k] = np.resize(a.reshape(-1)[:TILE], a.shape).astype(
                np.float32)
    return out


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def digest(flat):
    return {k: {"shape": list(np.shape(v)), "dtype": str(np.asarray(v).dtype),
                "sha256": hashlib.sha256(
                    np.ascontiguousarray(np.asarray(v)).tobytes()).hexdigest()}
            for k, v in sorted(flat.items())}


def main() -> None:
    sys.path.insert(0, ROOT)
    from epic_tpu.training.checkpoint import load_checkpoint, save_checkpoint

    with open(os.path.join(SOURCE, "config.json")) as f:
        meta = json.load(f)
    flat = tiled_tree()
    tree = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    if os.path.isdir(FIXTURE_DIR):
        shutil.rmtree(FIXTURE_DIR)
    save_checkpoint(FIXTURE_DIR, tree, meta["config"], step=meta["step"])
    _, params, _, _ = load_checkpoint(FIXTURE_DIR)
    arrays = digest(flatten(params))
    assert arrays == digest(flat), "the JAX package did not read back its save"
    frame, normals = normals_frame()
    with open(NORMALS_ZST, "wb") as f:
        f.write(frame)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(FIXTURE_DIR) for f in fs)
    with open(FIXTURE_JSON, "w") as f:
        json.dump({"source": "artifacts/ckpt_r5_flagship shapes, first "
                             f"{TILE} values of each array tiled",
                   "n_arrays": len(arrays),
                   "float32_bytes": int(sum(v.nbytes for v in flat.values())),
                   "directory_bytes": size, "zstd_normals": normals,
                   "arrays": arrays}, f, indent=1)
        f.write("\n")
    print(f"{len(arrays)} arrays, {size} bytes on disk -> {FIXTURE_DIR}")


if __name__ == "__main__":
    main()
