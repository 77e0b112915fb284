"""The port's repository tools (``epic_tpu_torch/tools/``) against the JAX
package's (``tools/``).

- ``eval_checkpoint`` on the tiny ``rem`` model (float32) and ``eval_cnn``
  on the tiny WACNN (bfloat16, as both tools run it, and float32), on the
  checkpoints and the two 256x256 crops of ``gen_torch_tools_fixture.py``,
  rebuilt here from their seeds (the crops as PNG files under
  ``--images``), against the JAX tools' output in
  ``tests/fixtures/tools_jax.json``: the same JSON keys, real bpp equal
  (the streams are the JAX package's bytes), estimated bpp within 1e-3
  relative, PSNR within 0.05 dB, MS-SSIM within 0.1 dB, the shell table's
  counts equal, and the per-quality REM rows' rates equal. The bf16 WACNN
  is held to the JAX tool as XLA compiles it by default, both rates within
  0.25% (the measured gap is 0.20%), and within 0.5% of the same tool
  compiled without excess precision (see ``test_eval_cnn_matches_jax``).
  No JAX program is compiled here.
- ``extend_rem_banks`` of both packages, live, on the tiny ``rem``
  checkpoint, re-indexing its banks: the banks, the config and
  ``progress.json`` equal; then the port's tool grows it to three check
  levels with one fresh bank of the trained banks' shapes. The JAX package
  loads the port's output (npz); the JAX tool writes Orbax, which both
  packages read (the port through ``training/orbax.py``).
- ``bench_rans``: ``gaussian_tables`` equal to the JAX tool's, and a round
  trip at 20,000 symbols.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from epic_tpu_torch import convert
from epic_tpu_torch.data.png import write_png
from epic_tpu_torch.tools import bench_rans, eval_checkpoint, eval_cnn
from epic_tpu_torch.tools import extend_rem_banks
from gen_torch_tools_fixture import FIXTURE, ROOT, tiles, tiny_checkpoints
from test_torch_train_step import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_torch_thread):  # noqa: F811
    """The fixture's JAX results, the checkpoints, and the port's tools
    run once on the same checkpoints and crops."""
    root = tmp_path_factory.mktemp("tools")
    ck = tiny_checkpoints(str(root))
    images = root / "crops"
    images.mkdir()
    for i, t in enumerate(tiles()):
        write_png(str(images / f"crop{i}.png"), t)
    with open(FIXTURE) as f:
        want = json.load(f)
    got = {
        "eval_checkpoint": eval_checkpoint.main(
            [ck["rem"], "--compute_dtype", "float32", "--images",
             str(images), "--device", "cpu"]),
        "eval_cnn": eval_cnn.main(
            [ck["cnn"], "--regions", "val", "--images", str(images),
             "--device", "cpu"]),
    }
    # the WACNN tool again in float32, its loader made to override the
    # dtype, as the generator ran the JAX tool
    load = convert.load_checkpoint

    def load_float32(*a, config_overrides=None, **kw):
        return load(*a, config_overrides=dict(
            config_overrides or {}, compute_dtype="float32"), **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(convert, "load_checkpoint", load_float32)
        got["eval_cnn_float32"] = eval_cnn.main(
            [ck["cnn"], "--regions", "val", "--images", str(images),
             "--device", "cpu"])
    return want, got, ck, root


def _keys(tree):
    """The nested key structure of a JSON tree (lists by their first
    element)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and isinstance(tree[0], dict):
        return [_keys(tree[0])]
    return None


def _close_group(got, want, name):
    assert got["n_crops"] == want["n_crops"] == 2
    assert got["real_bpp"] == want["real_bpp"], name
    np.testing.assert_allclose(got["est_bpp"], want["est_bpp"], rtol=1e-3,
                               atol=1e-4, err_msg=name)
    np.testing.assert_allclose(got["psnr"], want["psnr"], atol=0.05,
                               err_msg=name)
    np.testing.assert_allclose(got["msssim_db"], want["msssim_db"],
                               atol=0.1, err_msg=name)
    assert got["flush_overhead_bpp"] == want["flush_overhead_bpp"]
    assert got["monotone_bpp"] == want["monotone_bpp"]


def test_eval_checkpoint_matches_jax(runs):
    want, got, _, _ = runs
    w, g = want["eval_checkpoint"], got["eval_checkpoint"]
    assert _keys(g) == _keys(w)
    assert g["levels"] == w["levels"] and g["model"] == w["model"]
    assert set(g["groups"]) == {"val", "val_rem"}
    for name in ("val", "val_rem"):
        _close_group(g["groups"][name], w["groups"][name], name)
        assert len(g["groups"][name]["real_bpp"]) == 16
    shells_g, shells_w = g["groups"]["val"]["shells"], w["groups"]["val"][
        "shells"]
    assert [r["elems"] for r in shells_g["per_shell"]] == [
        r["elems"] for r in shells_w["per_shell"]]
    assert shells_g["never_coded_elems"] == shells_w["never_coded_elems"]
    assert shells_g["total_elems"] == shells_w["total_elems"]
    for a, b in zip(shells_g["per_shell"], shells_w["per_shell"]):
        assert a["d_bpp"] == b["d_bpp"]
        for k, tol in (("nonzero_frac", 0), ("mean_abs_sym", 0),
                       ("mean_sigma", 1e-4)):
            assert abs(a[k] - b[k]) <= tol, (a["q"], k)
    rows_g = g["groups"]["val"]["rem_per_quality"]
    rows_w = w["groups"]["val"]["rem_per_quality"]
    assert [r["q"] for r in rows_g] == [r["q"] for r in rows_w] == [
        1.0, 2.0, 4.0, 10.0]
    for a, b in zip(rows_g, rows_w):
        assert (a["bpp"], a["bpp_rem"]) == (b["bpp"], b["bpp_rem"])
        assert abs(a["psnr"] - b["psnr"]) <= 0.05
        assert abs(a["psnr_rem"] - b["psnr_rem"]) <= 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_cnn_matches_jax(runs, dtype):
    want, got, _, _ = runs
    key = "eval_cnn" + ("_float32" if dtype == "float32" else "")
    w, g = want[key], got[key]
    assert _keys(g) == _keys(w)
    a, b = g["groups"]["val"], w["groups"]["val"]
    assert a["n_crops"] == b["n_crops"] == 2
    assert a["streams_per_image"] == b["streams_per_image"] == 1
    assert abs(a["psnr"] - b["psnr"]) <= 0.05
    assert abs(a["msssim_db"] - b["msssim_db"]) <= 0.1
    if dtype == "float32":
        assert a["bpp"] == b["bpp"]
        assert abs(a["est_bpp"] - b["est_bpp"]) <= 1e-3 * b["est_bpp"]
        return
    # bf16 (ROADMAP C-9): the reference is the JAX program as XLA compiles
    # it by default ("eval_cnn_xla_default", 0.9629 bpp, est 1.131), which
    # evaluates jax.nn.gelu in float32 with its constants rounded to bf16
    # and rounds once; the port's F.gelu rounds once too but with float32
    # constants: 0.9648 bpp, est 1.1333, gaps of 0.197% and 0.203%. The
    # program without excess precision ("eval_cnn", 0.9617) rounds every
    # operation; the port keeps within the old 0.5% of it as well
    d = want["eval_cnn_xla_default"]["groups"]["val"]
    assert abs(a["bpp"] - d["bpp"]) <= 2.5e-3 * d["bpp"]
    assert abs(a["est_bpp"] - d["est_bpp"]) <= 2.5e-3 * d["est_bpp"]
    assert abs(a["bpp"] - b["bpp"]) <= 5e-3 * b["bpp"]
    assert abs(a["est_bpp"] - b["est_bpp"]) <= 5e-3 * b["est_bpp"]


def _tree_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tree_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_extend_rem_banks_matches_jax(runs, tmp_path, monkeypatch):
    """Both tools re-index the trained banks to check levels [0.75] (bank
    1 becomes bank 0): equal outputs. The port's tool then grows the
    checkpoint to [0.25, 0.75, 2.0], one fresh bank, which the JAX package
    loads. (The JAX tool's fresh bank is a flax init that costs 16 s of
    op-by-op compiles on this CPU; its own check holds a fresh bank's
    shapes to the trained ones, as the port's does.)"""
    _, _, ck, _ = runs
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import extend_rem_banks as j_extend
    from epic_tpu.training.checkpoint import load_checkpoint as j_load
    from epic_tpu_torch.convert import load_checkpoint, to_jax_params

    trained = _tree_shapes(to_jax_params(load_checkpoint(ck["rem"])[0]))
    mine, theirs = tmp_path / "mine" / "rems", tmp_path / "theirs" / "rems"
    extend_rem_banks.main([ck["rem"], str(mine), "--check_levels", "0.75"])
    monkeypatch.setattr(sys, "argv", ["extend_rem_banks.py", ck["rem"],
                                      str(theirs), "--check_levels", "0.75"])
    j_extend.main()
    for d in (mine, theirs):
        with open(d.parent / "progress.json") as f:
            assert json.load(f) == {"stage": "rems", "next_step": 1,
                                    "lr": None, "best_loss": None,
                                    "plateau": 0}
    with open(mine / "config.json") as f:
        cfg_m = json.load(f)
    with open(theirs / "config.json") as f:
        cfg_t = json.load(f)
    assert cfg_m["config"] == cfg_t["config"] and cfg_m["step"] == 0
    assert cfg_m["config"]["check_levels"] == [0.75]
    a = _tree_shapes(j_load(str(mine))[1])
    b = _tree_shapes(j_load(str(theirs))[1])
    model, _, step = load_checkpoint(str(mine))
    assert step == 0
    ported = _tree_shapes(to_jax_params(model))
    # the JAX tool's Orbax output, read by the port
    model_t, _, step_t = load_checkpoint(str(theirs))
    assert step_t == 0
    ported_t = _tree_shapes(to_jax_params(model_t))
    assert a.keys() == b.keys() == ported.keys() == ported_t.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(ported[k], a[k], err_msg=k)
        np.testing.assert_array_equal(ported_t[k], b[k], err_msg=k)
        src = k.replace("post_latent_0/", "post_latent_1/")
        np.testing.assert_array_equal(a[k], trained[src], err_msg=k)

    grown = tmp_path / "grown" / "rems"
    extend_rem_banks.main([ck["rem"], str(grown), "--check_levels", "0.25",
                           "0.75", "2.0"])
    g = _tree_shapes(j_load(str(grown))[1])
    for j in range(3):
        bank = {k.split("/", 1)[1]: v for k, v in g.items()
                if k.startswith(f"post_latent_{j}/")}
        assert {k: v.shape for k, v in bank.items()} == {
            k.split("/", 1)[1]: v.shape for k, v in trained.items()
            if k.startswith("post_latent_0/")}
        for k, v in bank.items():
            if j < 2:  # kept: the trained bank of the same lower edge
                np.testing.assert_array_equal(
                    v, trained[f"post_latent_{j}/{k}"])
    assert any(np.abs(v).max() > 0 for k, v in g.items()
               if k.startswith("post_latent_2/") and k.endswith("kernel"))


def test_bench_rans_tables_and_round_trip():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import bench_rans as j_bench

    got, want = bench_rans.gaussian_tables(), j_bench.gaussian_tables()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    r = bench_rans.run(20_000)
    assert r["n"] == 20_000 and r["enc_msym_s"] > 0 and r["dec_msym_s"] > 0
    assert 0 < r["bits_per_sym"] < 8
    assert torch.get_num_threads() >= 1
