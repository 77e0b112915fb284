"""The port reads the Orbax checkpoints that the JAX package writes: its zstd
decoder (``native/epic_zstd.cpp``) against ``zstandard``, its OCDBT reader
against tensorstore, and ``load_checkpoint`` of directories written by the
JAX package's ``save_checkpoint`` against the same arrays from npz and
against the JAX package's own ``load_checkpoint``."""

import functools
import hashlib
import json
import os
import shutil
import sys

import numpy as np
import pytest
import zstandard

import epic_tpu_torch
from epic_tpu_torch import get_model
from epic_tpu_torch.convert import checkpoint_source, to_jax_params
from epic_tpu_torch.native import zstd
from epic_tpu_torch.tools.eval_checkpoint import pick_which
from epic_tpu_torch.training.ocdbt import _Store, read_ocdbt
from epic_tpu_torch.training.orbax import read_orbax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from gen_torch_orbax_fixture import FIXTURE_DIR, FIXTURE_JSON, digest  # noqa
from gen_torch_orbax_fixture import flatten, normals_frame, widen  # noqa
from gen_torch_tools_fixture import CONFIGS  # noqa: E402
from test_torch_train_step import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CNN = os.path.join(ROOT, "artifacts", "ckpt_r5_cnn")


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):  # noqa: F811
    yield


# ---- zstd -----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _content(kind: str, size: int) -> bytes:
    rng = np.random.default_rng(size)
    if kind == "zeros":
        return bytes(size)
    if kind == "random":
        return rng.bytes(size)
    if kind == "weights":
        with np.load(os.path.join(CNN, "last.npz")) as z:
            parts, n = [], 0
            for k in sorted(z.files):
                if n >= size:
                    break
                parts.append(widen(z[k]).tobytes())
                n += len(parts[-1])
        return b"".join(parts)[:size]
    with open(os.path.join(ROOT, "README.md"), "rb") as f:
        text = f.read()
    return (text * (size // len(text) + 1))[:size]


@pytest.mark.parametrize("kind", ["zeros", "random", "weights", "text"])
@pytest.mark.parametrize("size", [0, 1, 131_071, 131_073, 4_000_000])
@pytest.mark.parametrize("level", [-5, 1, 3, 9, 19])
def test_zstd_equals_zstandard(level, size, kind):
    data = _content(kind, size)
    # half the cases with the checksum and the content size, half without
    flags = (level + size + len(kind)) % 2 == 0
    frame = zstandard.ZstdCompressor(
        level=level, write_checksum=flags,
        write_content_size=flags).compress(data)
    want = zstandard.ZstdDecompressor().decompressobj().decompress(frame)
    assert want == data
    assert zstd.decompress(frame) == want
    out = np.empty(len(data), np.uint8)
    zstd.decompress_into(frame, out)
    assert out.tobytes() == want


def test_zstd_frames_streams_and_skippable():
    text = _content("text", 300_000)
    rnd = _content("random", 5_000)
    a = zstandard.ZstdCompressor(level=3).compress(text)
    b = zstandard.ZstdCompressor(level=1, write_checksum=True,
                                 write_content_size=False).compress(rnd)
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little")
    joined = a + skip + b"hello" + b + a
    want = zstandard.ZstdDecompressor().decompressobj(
        read_across_frames=True).decompress(joined)
    assert zstd.decompress(joined) == want == text + rnd + text
    # a streamed frame: no content size, flushed blocks, a checksum
    co = zstandard.ZstdCompressor(level=5, write_checksum=True).compressobj()
    stream = (co.compress(text[:100_000])
              + co.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
              + co.compress(text[100_000:]) + co.flush())
    assert zstd.decompress(stream) == text
    # a match farther back than the default window, long-distance matching
    far = _content("random", 3_000_000) * 2
    params = zstandard.ZstdCompressionParameters.from_level(
        3, window_log=23, enable_ldm=True)
    assert zstd.decompress(zstandard.ZstdCompressor(
        compression_params=params).compress(far)) == far
    # a wrong content checksum (the frame's last 4 bytes) is refused
    checked = bytearray(zstandard.ZstdCompressor(
        write_checksum=True).compress(text))
    checked[-1] ^= 1
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bytes(checked))


def test_zstd_refuses_corrupt_input_and_dictionaries():
    rng = np.random.default_rng(5)
    srcs = [_content("text", 40_000), _content("weights", 60_000),
            _content("random", 3_000), bytes(200_000)]
    refused = 0
    for level in (1, 19):
        for src in srcs:
            frame = zstandard.ZstdCompressor(
                level=level, write_checksum=True).compress(src)
            for cut in (0, 3, 4, 5, len(frame) // 2, len(frame) - 1):
                with pytest.raises(ValueError):
                    zstd.decompress(frame[:cut])
                refused += 1
            for _ in range(60):
                bad = bytearray(frame)
                for _ in range(int(rng.integers(1, 4))):
                    i = int(rng.integers(0, len(bad)))
                    bad[i] ^= 1 << int(rng.integers(0, 8))
                try:
                    out = zstd.decompress(bytes(bad))
                except ValueError:
                    refused += 1
                    continue
                # a flip in a bit the decoder never reads changes nothing
                assert out == src
    assert refused > 400
    with pytest.raises(ValueError, match="bad magic"):
        zstd.decompress(b"\x00" * 16)
    with pytest.raises(ValueError, match="larger than the buffer"):
        zstd.decompress_into(zstandard.ZstdCompressor().compress(b"x" * 100),
                             np.empty(99, np.uint8))
    samples = [srcs[0][i:i + 400] for i in range(0, 40_000, 400)]
    dictionary = zstandard.train_dictionary(2_000, samples)
    frame = zstandard.ZstdCompressor(dict_data=dictionary).compress(
        srcs[0][:3_000])
    with pytest.raises(ValueError, match="dictionary frames"):
        zstd.decompress(frame)


# ---- OCDBT ----------------------------------------------------------------

def test_ocdbt_interior_nodes_equal_tensorstore(tmp_path):
    import tensorstore as ts

    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}",
            "config": {"max_decoded_node_bytes": 200,
                       "max_inline_value_bytes": 20}}
    kv = ts.KvStore.open(spec).result()
    rng = np.random.default_rng(1)
    want = {}
    with ts.Transaction() as txn:
        for i in range(80):
            key = f"key{i:03d}/sub{(i * 7) % 13}"
            want[key] = rng.bytes(int(rng.integers(0, 60)))
            kv.with_transaction(txn)[key] = want[key]
    kv["key010/sub5"] = want["key010/sub5"] = b"rewritten"  # a 2nd version
    files, versions = _Store(str(tmp_path)).manifest()
    newest = max(versions, key=lambda v: v["generation"])
    assert newest["height"] >= 1
    got = read_ocdbt(str(tmp_path))
    listed = {k.decode(): bytes(kv[k]) for k in kv.list().result()}
    assert got == listed == want
    # a flipped byte of the root b-tree node fails its CRC-32C
    data = tmp_path / files[newest["file"]]
    raw = bytearray(data.read_bytes())
    raw[newest["offset"] + 20] ^= 0x10
    data.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="OCDBT"):
        read_ocdbt(str(tmp_path))


# ---- Orbax checkpoints ----------------------------------------------------

def _state_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and sa[k].shape == sb[k].shape, k
        assert sa[k].numpy().tobytes() == sb[k].numpy().tobytes(), k


def _tree_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.shape == y.shape and x.tobytes() == y.tobytes(), k


def _drawn_tree(name: str, seed: int):
    """The tiny model's parameter tree, every array drawn with numpy."""
    rng = np.random.default_rng(seed)

    def draw(t):
        if isinstance(t, dict):
            return {k: draw(v) for k, v in t.items()}
        return (0.1 * rng.standard_normal(np.shape(t))).astype(np.float32)

    return draw(to_jax_params(get_model(name, **CONFIGS[name])))


def _config(name):
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in dict(CONFIGS[name], model=name).items()}


def _write_npz(directory, tree, config, step, which="last"):
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump({"config": config, "step": step}, f)
    np.savez(os.path.join(directory, which + ".npz"), **flatten(tree))


@pytest.mark.parametrize("name,seed", [("rem", 11), ("cnn", 12)])
def test_tiny_jax_checkpoints_load(tmp_path, name, seed):
    from epic_tpu.training.checkpoint import load_checkpoint as j_load
    from epic_tpu.training.checkpoint import save_checkpoint as j_save

    tree, config = _drawn_tree(name, seed), _config(name)
    j_save(str(tmp_path / "orbax"), tree, config, step=7, is_best=True)
    _write_npz(str(tmp_path / "npz"), tree, config, 7)
    ref, _, step0 = epic_tpu_torch.load_checkpoint(str(tmp_path / "npz"))
    # the tools pick the Orbax best/ by default, as the JAX tools do
    assert pick_which(str(tmp_path / "orbax"), None) == "best"
    assert pick_which(str(tmp_path / "npz"), None) == "last"
    for which in ("last", "best"):
        _tree_equal(read_orbax(str(tmp_path / "orbax" / which)), tree)
        _, params, _, _ = j_load(str(tmp_path / "orbax"), which=which)
        _tree_equal(params, tree)
        model, cfg, step = epic_tpu_torch.load_checkpoint(
            str(tmp_path / "orbax"), which=which)
        assert (type(model), cfg, step) == (type(ref), config, step0)
        _state_equal(model, ref)


def test_trained_cnn_checkpoint_through_orbax(tmp_path):
    from epic_tpu.training.checkpoint import save_checkpoint as j_save

    with open(os.path.join(CNN, "config.json")) as f:
        meta = json.load(f)
    config, step = meta["config"], meta["step"]
    with np.load(os.path.join(CNN, "last.npz")) as z:
        tree = {k: widen(z[k]) for k in z.files}  # as the JAX loader widens
    nested = {}
    for k, v in tree.items():
        node = nested
        for p in k.split("/")[:-1]:
            node = node.setdefault(p, {})
        node[k.split("/")[-1]] = v
    j_save(str(tmp_path), nested, config, step=step)
    _tree_equal(read_orbax(str(tmp_path / "last")), nested)
    ref, _, _ = epic_tpu_torch.load_checkpoint(CNN)
    model, _, got_step = epic_tpu_torch.load_checkpoint(str(tmp_path))
    assert got_step == step
    _state_equal(model, ref)


def test_committed_flagship_fixture_equals_jax_load():
    from epic_tpu.training.checkpoint import load_checkpoint as j_load

    with open(FIXTURE_JSON) as f:
        want = json.load(f)
    got = flatten(read_orbax(os.path.join(FIXTURE_DIR, "last")))
    assert len(got) == want["n_arrays"] == 609
    assert digest(got) == want["arrays"]
    _, params, _, _ = j_load(FIXTURE_DIR)
    jax_flat = flatten(params)
    assert got.keys() == jax_flat.keys()
    for k in got:
        assert hashlib.sha256(np.asarray(jax_flat[k]).tobytes()).hexdigest() \
            == want["arrays"][k]["sha256"], k
    model, config, step = epic_tpu_torch.load_checkpoint(FIXTURE_DIR)
    assert type(model).__name__ == "VarianceMaskingPICREM"
    assert (config["n"], config["m"], step) == (192, 640, 8000)


def test_committed_normals_frame():
    """The frame that chip_smoke.py phase 19 times: the seeded normals,
    regenerated here byte for byte, and the port's decode of them."""
    with open(FIXTURE_JSON) as f:
        want = json.load(f)["zstd_normals"]
    frame, rec = normals_frame()
    with open(os.path.join(ROOT, want["file"]), "rb") as f:
        committed = f.read()
    assert rec == want and committed == frame
    out = zstd.decompress(committed)
    assert out == zstandard.ZstdDecompressor().decompress(committed)
    assert hashlib.sha256(out).hexdigest() == want["sha256"]


def test_bf16_no_ocdbt_precedence_and_refusals(tmp_path):
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    rng = np.random.default_rng(3)
    bf = jnp.asarray(rng.standard_normal((3, 70)), jnp.bfloat16)
    tree = {"w": {"bf": bf, "f16": rng.standard_normal(9).astype(np.float16),
                  "i32": np.arange(-4, 7, dtype=np.int32),
                  "i64": np.arange(5, dtype=np.int64) << 40}}
    # StandardCheckpointer saves in the background: wait for its _METADATA
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(tmp_path / "ocdbt"), tree)
    ckptr.wait_until_finished()
    ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=False)).save(
        str(tmp_path / "plain"), tree)
    for sub in ("ocdbt", "plain"):
        got = read_orbax(str(tmp_path / sub))["w"]
        assert got["bf"].dtype == np.dtype("V2")
        assert got["bf"].view(np.uint16).tobytes() == \
            np.asarray(bf).view(np.uint16).tobytes()
        for k in ("f16", "i32", "i64"):
            assert got[k].dtype == tree["w"][k].dtype
            assert got[k].tobytes() == tree["w"][k].tobytes()
    # a missing chunk of an array without a fill value is refused
    shutil.copytree(tmp_path / "plain", tmp_path / "holed")
    os.remove(tmp_path / "holed" / "w.i32" / "0")
    with pytest.raises(ValueError, match="chunk 0 is missing"):
        read_orbax(str(tmp_path / "holed"))
    # zarr3 is refused by name
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True)).save(
        str(tmp_path / "zarr3"), tree)
    with pytest.raises(ValueError, match="zarr3"):
        read_orbax(str(tmp_path / "zarr3"))

    # the non-OCDBT layout through load_checkpoint; npz before Orbax
    from epic_tpu.training.checkpoint import load_checkpoint as j_load

    t1, t2, config = _drawn_tree("cnn", 1), _drawn_tree("cnn", 2), \
        _config("cnn")
    both = str(tmp_path / "both")
    _write_npz(both, t1, config, 3)
    ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=False)).save(
        os.path.join(both, "last"), t2)
    ref1, _, _ = epic_tpu_torch.load_checkpoint(both)
    _, jparams, _, _ = j_load(both)
    _tree_equal(jparams, t1)
    assert checkpoint_source(both, "last") == (
        "npz", os.path.join(both, "last.npz"))
    os.remove(os.path.join(both, "last.npz"))
    assert checkpoint_source(both, "last") == (
        "orbax", os.path.join(both, "last"))
    assert checkpoint_source(both, "best") == (None, None)
    ref2, _, _ = epic_tpu_torch.load_checkpoint(both)
    _write_npz(str(tmp_path / "npz1"), t1, config, 3)
    _write_npz(str(tmp_path / "npz2"), t2, config, 3)
    _state_equal(ref1, epic_tpu_torch.load_checkpoint(
        str(tmp_path / "npz1"))[0])
    _state_equal(ref2, epic_tpu_torch.load_checkpoint(
        str(tmp_path / "npz2"))[0])
    with pytest.raises(FileNotFoundError, match="best.npz.*best"):
        epic_tpu_torch.load_checkpoint(both, which="best")
