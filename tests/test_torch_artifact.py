"""The compact checkpoint artifact (``training.checkpoint.save_artifact``)
and its tool against the JAX package's, on the CPU: no JAX program is
compiled (the JAX writer and loader are numpy code).

- On the tiny ``pic``, ``rem`` and ``cnn`` models with seeded numpy
  weights, the port's ``save_artifact`` arrays (keys, dtype, bytes, the
  zeroed dead rows of the stacked heads) equal the JAX package's
  ``save_artifact`` of the same tree, array for array (the files are not
  compared: zip timestamps differ), and so do the configs; WACNN's dead
  rows are zeroed too, as the JAX package's writer does.
- Each package's ``load_checkpoint`` reads the other's artifact to the
  same float32 values: the bf16 rounding of the zeroed tree.
- ``dtype="float16"``: the JAX package's numpy cast, in ``best.npz``.
- ``bfloat16_bits`` equals ``ml_dtypes``' cast at constructed halfway
  values, their neighbours, infinities, NaNs and subnormals.
- ``remap_single_to_multi`` equals the JAX package's on a numpy tree.
- ``tools.make_artifact`` on a port checkpoint directory.
"""

import json
import os

import ml_dtypes
import numpy as np
import pytest

from epic_tpu.training import checkpoint as jck
from epic_tpu_torch import get_model, load_checkpoint
from epic_tpu_torch.convert import _flatten, from_jax_params, to_jax_params
from epic_tpu_torch.tools import make_artifact
from epic_tpu_torch.training.checkpoint import (bfloat16_bits,
                                                remap_single_to_multi,
                                                save_artifact,
                                                save_checkpoint,
                                                zero_dead_rows)
from test_torch_train_step import one_torch_thread  # noqa: F401

TINY = dict(n=32, m=32, division=[16, 32], dim_chunk=8,
            param_net_widths=[24, 16])
CONFIGS = {"pic": TINY,
           "rem": dict(TINY, check_levels=[0.25, 0.75],
                       rem_dimension="middle"),
           "cnn": dict(n=32, m=32, dim_chunk=8, param_net_widths=[24, 16])}


def _seeded(name, seed=0, density=1.0):
    """(port model, its JAX-layout tree, config): N(0, 0.5) float32
    weights from ``seed``, drawn into the tree in key order, each nonzero
    with probability ``density``."""
    cfg = CONFIGS[name]
    model = get_model(name, **{k: tuple(v) if isinstance(v, list) else v
                               for k, v in cfg.items()})
    rng = np.random.default_rng(seed)

    def draw(shape):
        a = rng.normal(0, 0.5, shape).astype(np.float32)
        if density < 1:
            a[rng.random(shape) >= density] = 0
        return a

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else draw(v.shape)
                for k, v in sorted(tree.items())}

    tree = fill(to_jax_params(model))
    model.load_state_dict(from_jax_params(tree, model))
    return model, tree, dict(cfg, model=name)


def _as_f32(a):
    return (np.asarray(a).view(np.uint16).astype(np.uint32) << 16).view(
        np.float32)


@pytest.fixture(scope="module", params=["pic", "rem", "cnn"])
def artifacts(request, tmp_path_factory):
    name = request.param
    model, tree, cfg = _seeded(name)
    root = tmp_path_factory.mktemp(f"artifact_{name}")
    # both writers store without zlib here: the arrays are what is
    # compared, and compressing ~20M random weights (the hyper-synthesis
    # widths are fixed) takes seconds; test_make_artifact_tool compresses
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(np, "savez_compressed", np.savez)
        port = save_artifact(str(root / "port"), model, cfg, step=7)
        ref = jck.save_artifact(str(root / "jax"), tree, cfg, step=7)
    return dict(name=name, model=model, tree=tree, cfg=cfg, port=port,
                ref=ref, root=root)


def test_arrays_equal_jax(artifacts):
    a = artifacts
    with np.load(a["port"]) as p, np.load(a["ref"]) as j:
        assert sorted(p.files) == sorted(j.files)
        assert len(p.files) == len(a["model"].state_dict())
        for k in p.files:
            assert p[k].dtype == j[k].dtype == np.dtype("V2"), k
            assert p[k].shape == j[k].shape and \
                p[k].tobytes() == j[k].tobytes(), k
        # the dead rows of the stacked heads are zero, as in the JAX
        # package's artifact
        dead = 0
        for name in ("cc_mean", "cc_scale", "lrp", "cc_mean_prog"):
            key = f"{name}/Conv_0_kernel"
            if key in p.files:
                kept = p[key].view(np.uint16) != 0
                orig = a["tree"][name]["Conv_0_kernel"] != 0
                dead += int((orig & ~kept).sum())
        assert dead > 0
    metas = []
    for path in (a["port"], a["ref"]):
        with open(os.path.join(os.path.dirname(path), "config.json")) as f:
            metas.append(json.load(f))
    assert metas[0] == metas[1]
    assert metas[0]["dtype"] == "bfloat16" and metas[0]["step"] == 7


def test_each_package_reads_the_others(artifacts):
    a = artifacts
    want = {"/".join(p): _as_f32(bfloat16_bits(v)) for p, v in _flatten(
        zero_dead_rows(a["tree"], a["model"]))}
    _, jparams, jcfg, jstep = jck.load_checkpoint(os.path.dirname(a["port"]))
    assert jcfg["model"] == a["name"] and jstep == 7
    got = {"/".join(p): np.asarray(v) for p, v in _flatten(jparams)}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    model, cfg, step = load_checkpoint(os.path.dirname(a["ref"]))
    assert type(model) is type(a["model"]) and step == 7
    assert cfg["model"] == a["name"]
    for p, v in _flatten(to_jax_params(model)):
        np.testing.assert_array_equal(v, want["/".join(p)])


def test_other_dtype_matches_jax(tmp_path):
    """``dtype`` other than bfloat16: a plain numpy cast, as the JAX
    package's."""
    model, tree, cfg = _seeded("pic", seed=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(np, "savez_compressed", np.savez)
        port = save_artifact(str(tmp_path / "p"), model, cfg, 1,
                             which="best", dtype="float16")
        ref = jck.save_artifact(str(tmp_path / "j"), tree, cfg, 1,
                                which="best", dtype="float16")
    assert os.path.basename(port) == "best.npz"
    with np.load(port) as p, np.load(ref) as j:
        assert sorted(p.files) == sorted(j.files)
        for k in p.files:
            assert p[k].dtype == j[k].dtype == np.float16
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)


def test_bfloat16_rounding_matches_ml_dtypes():
    rng = np.random.default_rng(3)
    hi = rng.integers(0, 1 << 16, 4096).astype(np.uint32) << 16
    lows = np.array([0, 1, 0x7FFF, 0x8000, 0x8001, 0xFFFF], np.uint32)
    bits = (hi[:, None] | lows[None]).ravel()
    special = np.array([0x7F7FFFFF, 0xFF7FFFFF, 0x7F800000, 0xFF800000,
                        0x7FC00000, 0xFFC00001, 0x7F800001, 0x00000001,
                        0x80008000, 0x00018000, 0x007FFFFF, 0x3F808000,
                        0x3F818000, 0], np.uint32)
    a = np.concatenate([bits, special]).view(np.float32)
    got = bfloat16_bits(a).view(np.uint16)
    with np.errstate(invalid="ignore"):  # ml_dtypes warns on NaN
        want = a.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(got, want)
    assert bfloat16_bits(a).dtype == np.dtype("V2")


@pytest.mark.parametrize("enhanced", [False, True])
def test_remap_single_to_multi_matches_jax(enhanced):
    rng = np.random.default_rng(4)
    tree = {k: {"Conv_0": {"kernel": rng.normal(size=(3, 3, 2, 2))}}
            for k in ("g_a", "g_s", "h_a", "h_mean_s", "h_scale_s",
                      "cc_mean", "lrp", "entropy_bottleneck")}
    extra = {"g_s": {"Conv_0": {"kernel": rng.normal(size=(3, 3, 2, 2))}},
             "g_a": {}} if enhanced else None
    got = remap_single_to_multi(tree, extra)
    want = jck.remap_single_to_multi(tree, extra)
    assert list(got) == list(want)
    assert all(got[k] is want[k] for k in want)
    assert ("g_s_1" in got) == enhanced and "h_a" not in got


def test_make_artifact_tool(tmp_path, capsys):
    # one weight in 32 nonzero: zlib takes a second on the tree, not the
    # ten it takes on dense random weights
    model, tree, cfg = _seeded("rem", seed=1, density=1 / 32)
    src, dst = str(tmp_path / "ckpt"), str(tmp_path / "artifact")
    save_checkpoint(src, model, cfg, step=5, is_best=True)
    rec = make_artifact.main([src, dst])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert rec["src"] == f"{src}/best" and rec["step"] == 5
    assert rec["out"] == os.path.join(dst, "last.npz")
    assert os.path.getsize(rec["out"]) < os.path.getsize(
        os.path.join(src, "last.npz"))
    loaded, _, step = load_checkpoint(dst)
    assert step == 5
    want = dict(_flatten(zero_dead_rows(tree, model)))
    for p, v in _flatten(to_jax_params(loaded)):
        np.testing.assert_array_equal(v, _as_f32(bfloat16_bits(want[p])))
