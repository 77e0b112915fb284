"""The port's host-loader trainer (``cli.train.main``) on the CPU with the
tiny flags of the JAX package's ``tests/test_cli_train.py::TestTrainCLI``
(``--device cpu``, torch on one thread), through the JAX CLI's stage
transitions, each stage a launch of its own:

- first_train from scratch, 3 epochs of 4 steps: the mean train loss falls;
- refine_gs from ``--checkpoint`` with ``--eval_every 1``: the subtrees the
  stage freezes are bitwise the parent's; the real codec
  (``compress_with_ac``), ``test_epoch`` and the RD plot run;
- rems with ``--model rem`` from the refine_gs checkpoint (a ``pic``
  checkpoint: the loader's C-8 path prints "initialized REM banks fresh"),
  2 epochs of 1 step with ``--patience 0``: the parent's weights bitwise,
  the banks trained; its validation does not see the banks (no checkpoint
  latent), and with ``--aux_learning_rate 0`` its loss repeats, so the
  plateau drops the learning rate after the second epoch, the Adam moments
  kept;
- each stage's checkpoint read by the JAX package's ``load_checkpoint`` to
  the arrays the port reads;
- the non-default PIC options through the CLI's flags (``--no_all_scalable
  --no_delta_encode --no_total_mu_rep --mask_policy two-levels``): a
  first_train launch with its validation and real-codec evaluation (the
  interleaved codec), then ``--model rem`` from its checkpoint; both
  checkpoints load with the options.

No JAX program is compiled: the JAX loader is numpy code. Without
``--device`` and without a GPU, ``main`` raises.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from epic_tpu.training.checkpoint import load_checkpoint as j_load
from epic_tpu_torch import VarianceMaskingPICREM, load_checkpoint
from epic_tpu_torch.cli.train import main as train_main
from epic_tpu_torch.convert import _flatten, to_jax_params
from epic_tpu_torch.training import state as train_state
from test_torch_train_step import one_torch_thread  # noqa: F401

TINY_FLAGS = [
    "--N", "16", "--M", "32", "--division_dimension", "16", "32",
    "--dim_chunk", "8", "--param_net_widths", "24", "16",
    "--patch_size", "64", "--batch_size", "2", "--valid_batch_size", "1",
    "--eval_every", "1000", "--device", "cpu",
]
STAGES = ("first_train", "refine_gs", "rems")


def _data_dirs(root):
    """trainset/{train,test}/data (6 and 2 images of 96x96) and a flat
    kodak directory of 2 images of 64x64, as the JAX CLI's test writes
    them."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:96, 0:96].astype(np.float32)
    for split, n in (("train", 6), ("test", 2)):
        d = root / "trainset" / split / "data"
        d.mkdir(parents=True)
        for i in range(n):
            img = np.stack([
                0.5 + 0.4 * np.sin(xx / (9 + i) + yy / 13),
                0.5 + 0.4 * np.cos(xx / 11 - yy / (7 + i)),
                (xx + yy) / 192.0,
            ], -1) + rng.normal(0, 0.03, (96, 96, 3))
            Image.fromarray(
                (np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
                d / f"im{i}.png")
    k = root / "kodak"
    k.mkdir()
    for i in range(2):
        img = rng.uniform(0, 1, (64, 64, 3))
        Image.fromarray((img * 255).astype(np.uint8)).save(
            k / f"test{i}.png")
    return str(root / "trainset"), str(k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three launches; per stage its report, stdout and directory, and
    the state around the plateau's learning-rate drop."""
    root = tmp_path_factory.mktemp("host_train")
    train_root, kodak = _data_dirs(root)
    save = str(root / "ckpt")
    common = TINY_FLAGS + ["--training_dataset", train_root,
                           "--test_dataset", kodak, "--save_path", save]
    argv = {
        "first_train": ["--epochs", "3", "--steps_per_epoch", "4",
                        "--learning_rate", "1e-3"],
        "refine_gs": ["--epochs", "1", "--steps_per_epoch", "2",
                      "--checkpoint", os.path.join(save, "first_train"),
                      "--eval_every", "1"],
        "rems": ["--model", "rem", "--epochs", "2", "--steps_per_epoch",
                 "1", "--checkpoint", os.path.join(save, "refine_gs"),
                 "--check_levels", "0.75", "--dimension", "middle",
                 "--patience", "0", "--aux_learning_rate", "0"],
    }
    drops = []
    set_lr = train_state.set_learning_rate

    def recording_set_lr(state, lr):
        before = (state.main.lr, state.main.count,
                  [t.clone() for t in state.main.mu + state.main.nu])
        out = set_lr(state, lr)
        drops.append((before, (out.main.lr, out.main.count,
                               out.main.mu + out.main.nu)))
        return out

    out = {"drops": drops, "save": save}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_state, "set_learning_rate", recording_set_lr)
        for stage in STAGES:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                report = train_main(common + ["--training_type", stage]
                                    + argv[stage])
            out[stage] = dict(report=report, stdout=buf.getvalue(),
                              dir=os.path.join(save, stage))
    return out


def _flat(model):
    return {"/".join(p): v for p, v in _flatten(to_jax_params(model))}


def test_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(["--training_dataset", "/nonexistent"])


def test_first_train_loss_falls(runs):
    r = runs["first_train"]
    losses = [float(line.split("train loss ")[1].split(" ")[0])
              for line in r["stdout"].splitlines() if "train loss" in line]
    assert len(losses) == 3 and all(map(np.isfinite, losses))
    assert losses[-1] < losses[0], f"loss did not decrease: {losses}"
    assert r["stdout"].rstrip().endswith("training done")
    rep = r["report"]
    assert rep["steps"] == 12 and rep["timers"]["load"]["count"] == 15
    assert {"load", "step", "valid", "save", "eval"} <= set(rep["timers"])
    model, cfg, step = load_checkpoint(r["dir"])
    assert cfg["model"] == "pic" and step == 3
    assert os.path.exists(os.path.join(r["dir"], "best.npz"))


def test_refine_gs_freezes_and_evaluates(runs):
    parent = _flat(load_checkpoint(runs["first_train"]["dir"])[0])
    r = runs["refine_gs"]
    model, cfg, step = load_checkpoint(r["dir"])
    assert cfg["model"] == "pic" and step == 4
    child = _flat(model)
    changed = {k.split("/")[0] for k in child
               if not np.array_equal(child[k], parent[k])}
    # refine_gs trains the enhancement decoder (and the aux optimizer the
    # quantiles); everything else is bitwise the parent's
    assert changed == {"g_s_1", "entropy_bottleneck"}
    assert "real-codec bpp" in r["stdout"]
    real = r["report"]["real"]
    assert real["pr_list"] == [0, 0.5, 1, 2, 5, 10]
    assert all(map(np.isfinite, real["bpp"] + real["psnr"]))
    plot = r["report"]["plot"]
    assert plot == os.path.join(r["dir"], "rd_epoch0.png")
    assert os.path.getsize(plot) > 0


def test_rems_from_a_pic_checkpoint(runs):
    parent = _flat(load_checkpoint(runs["refine_gs"]["dir"])[0])
    r = runs["rems"]
    assert "initialized REM banks fresh; merged parent weights" in \
        r["stdout"]
    model, cfg, step = load_checkpoint(r["dir"])
    assert isinstance(model, VarianceMaskingPICREM) and cfg["model"] == "rem"
    assert step == 4 + 2
    with open(os.path.join(r["dir"], "config.json")) as f:
        assert json.load(f)["config"]["check_levels"] == [0.75]
    child = _flat(model)
    banks = {k for k in child if k.startswith("post_latent")}
    assert banks and set(child) - banks == set(parent)
    for k in parent:
        np.testing.assert_array_equal(child[k], parent[k], err_msg=k)
    # the banks trained: they left the fresh init of the seed (42)
    fresh = _flat(type(model)(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in cfg.items() if k != "model"}).init_weights(42))
    assert any(not np.array_equal(child[k], fresh[k]) for k in banks)


def test_plateau_drops_lr_and_keeps_moments(runs):
    assert "lr -> 3.00e-05" in runs["rems"]["stdout"]
    assert "lr ->" not in runs["refine_gs"]["stdout"]
    assert runs["rems"]["report"]["lr"] == pytest.approx(3e-5)
    assert len(runs["drops"]) == 1
    (lr0, count0, moments0), (lr1, count1, moments1) = runs["drops"][0]
    assert lr0 == pytest.approx(1e-4) and lr1 == pytest.approx(3e-5)
    assert count0 == count1 == 2
    assert len(moments0) == len(moments1) > 0
    assert all(torch.equal(a, b) for a, b in zip(moments0, moments1))
    assert any(bool(a.abs().sum() > 0) for a in moments0)


@pytest.mark.parametrize("stage", STAGES)
def test_checkpoint_read_by_jax(runs, stage):
    d = runs[stage]["dir"]
    model, cfg, step = load_checkpoint(d)
    _, jparams, jcfg, jstep = j_load(d)
    assert (jcfg["model"], jstep) == (cfg["model"], step)
    port = _flat(model)
    ref = {"/".join(p): np.asarray(v) for p, v in _flatten(jparams)}
    assert sorted(port) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(port[k], v, err_msg=k)


def test_cli_train_without_all_scalable(tmp_path):
    """``cli.train --no_all_scalable --no_delta_encode --no_total_mu_rep
    --mask_policy two-levels`` (first_train, 1 epoch of 2 steps, with its
    validation and real-codec evaluation), then ``--model rem`` from that
    checkpoint through the interleaved codec's checkpoint latents: both
    stages train to finite losses and their checkpoints load with the
    options."""
    train_root, kodak = _data_dirs(tmp_path)
    save = str(tmp_path / "ckpt")
    common = TINY_FLAGS + ["--training_dataset", train_root,
                           "--test_dataset", kodak, "--save_path", save,
                           "--epochs", "1", "--eval_every", "1"]
    argv = {"first_train": ["--steps_per_epoch", "2", "--no_all_scalable",
                            "--no_delta_encode", "--no_total_mu_rep",
                            "--mask_policy", "two-levels"],
            "rems": ["--steps_per_epoch", "1", "--model", "rem",
                     "--checkpoint", os.path.join(save, "first_train"),
                     "--check_levels", "0.25", "0.75", "--check_levels_np",
                     "4", "4", "--dimension", "middle"]}
    for stage, extra in argv.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rep = train_main(common + ["--training_type", stage] + extra)
        assert rep["steps"] == int(extra[1])
        assert np.isfinite(rep["train_loss"]) and np.isfinite(
            rep["val"]["loss"])
        assert np.all(np.isfinite(rep["real"]["bpp"]))
        model, cfg, _ = load_checkpoint(os.path.join(save, stage))
        assert (model.all_scalable, model.delta_encode, model.total_mu_rep,
                model.mask_policy) == (False, False, False, "two-levels")
        assert type(model).__name__ == ("VarianceMaskingPICREM"
                                        if stage == "rems"
                                        else "VarianceMaskingPIC")
