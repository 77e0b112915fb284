"""The port's trainer on the CPU: the data sampler and
``train_device.run``.

- The sampler: shapes, values in [0, 1] on the 1/255 grid, the same batch
  from the same generator seed, validation crops only from the
  validation strip, training crops never from it.
- ``run`` on the CPU: two steps of each stage of a tiny configuration,
  finite losses, checkpoints and progress.json; then a resume from
  progress.json that runs only what is left, from the stage's last
  checkpoint. Without a GPU and without ``device="cpu"`` it raises. A
  loss that stays non-finite rewinds: exit code 4, a halved learning rate
  journaled, and the next run resumes from the last checkpoint.
"""

import json

import numpy as np
import pytest
import torch

from epic_tpu.training import load_checkpoint as j_load_checkpoint
from epic_tpu_torch import load_checkpoint
from epic_tpu_torch.cli import train_device as td
from epic_tpu_torch.data.device_bank import (build_crop_bank,
                                             fixed_val_batches,
                                             make_device_sampler)
from epic_tpu_torch.utils.synthetic import synth_images
from test_torch_train_step import one_torch_thread  # noqa: F401


def _bank(patch=64):
    """Two images: the first with a validation strip whose pixels are 255
    (elsewhere 0), the second all 100."""
    a = np.zeros((80, 200, 3), np.uint8)
    cb = build_crop_bank([a, np.full((70, 90, 3), 100, np.uint8)],
                         [True, False], patch)
    a[:, cb.val_x0[0]:] = 255
    return build_crop_bank([a, np.full((70, 90, 3), 100, np.uint8)],
                           [True, False], patch)


def test_sampler_shapes_range_and_determinism():
    cb = _bank()
    sample = make_device_sampler(cb, 64, 16, "cpu")
    a = sample(torch.Generator().manual_seed(1))
    b = sample(torch.Generator().manual_seed(1))
    c = sample(torch.Generator().manual_seed(2))
    assert a.shape == (16, 64, 64, 3) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0 and float(a.max()) <= 1
    assert torch.equal(torch.round(a * 255) / 255, a)
    # training crops never reach the validation strip: every crop is all
    # 0 (image 0) or all 100/255 (image 1)
    per = a.reshape(16, -1)
    assert torch.all(per.max(dim=1).values == per.min(dim=1).values)
    assert set(torch.round(per[:, 0] * 255).tolist()) <= {0.0, 100.0}
    val = fixed_val_batches(cb, 64, 4, "cpu", 2)
    assert len(val) == 2 and all(v.shape == (4, 64, 64, 3) for v in val)
    assert all(torch.all(v == 1.0) for v in val)
    assert all(torch.equal(u, v) for u, v in
               zip(val, fixed_val_batches(cb, 64, 4, "cpu", 2)))
    # the three flips: an asymmetric image comes out in more than one
    # orientation
    img = np.arange(64 * 64 * 3, dtype=np.int64).reshape(64, 64, 3) % 251
    s1 = make_device_sampler(build_crop_bank([img.astype(np.uint8)], None,
                                             64), 64, 32, "cpu")
    crops = s1(torch.Generator().manual_seed(0))
    assert len({tuple(c[0, :3, 0].tolist()) for c in crops}) > 1


def _args(path, steps):
    return td.parse_args([
        "--save_path", str(path), "--N", "32", "--M", "32",
        "--division_dimension", "16", "32", "--dim_chunk", "8",
        "--param_net_widths", "24", "16", "--compute_dtype", "float32",
        "--batch_size", "2", "--patch_size", "64",
        "--check_levels", "0.25", "0.75", "--check_levels_np", "4", "4",
        "--steps", steps, "--log_every", "1", "--val_every", "2",
        "--device", "cpu"])


def test_train_device_run_and_resume(tmp_path):
    imgs = [u8[:128, :192] for u8 in synth_images(2,
                                                   np.random.default_rng(0))]
    steps = "first_train=2,refine_gs=2,refine_gs_ga=2,rems=2"
    args = _args(tmp_path, steps)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            td.run(args, imgs, [True, False], device="cuda")
    res = td.run(args, imgs, [True, False])
    assert list(res["stages"]) == list(td.STAGE_ORDER)
    for stage, r in res["stages"].items():
        assert r["steps"] == 2 and np.isfinite(r["metrics"]["loss"])
        assert np.isfinite(r["val"]["loss"])
        assert (tmp_path / stage / "last.npz").exists()
    progress = json.loads((tmp_path / "progress.json").read_text())
    assert progress["stage"] == "rems" and progress["next_step"] == 2
    log = [json.loads(line) for line in
           (tmp_path / "train_log.jsonl").read_text().splitlines()]
    assert sum("loss" in r for r in log) == 8
    rem_model = res["model"]
    assert type(rem_model).__name__ == "VarianceMaskingPICREM"
    # the trained rems weights, from the checkpoint, in both packages
    back, _, step = load_checkpoint(str(tmp_path / "rems"))
    assert step == 2
    for k, v in rem_model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    j_load_checkpoint(str(tmp_path / "rems"))
    # resume mid-stage: only rems' second step runs, from rems/last
    progress.update(stage="rems", next_step=1, lr=1e-4, best_loss=None,
                    plateau=0)
    (tmp_path / "progress.json").write_text(json.dumps(progress))
    res2 = td.run(args, imgs, [True, False])
    assert list(res2["stages"]) == ["rems"]
    assert res2["stages"]["rems"]["steps"] == 1
    assert json.loads((tmp_path / "progress.json").read_text())[
        "next_step"] == 2


def test_train_device_nan_rewind(tmp_path, monkeypatch):
    """A loss that stays non-finite for three log points: exit code 4, with
    a halved learning rate and the rewind journaled in progress.json; the
    next run resumes the stage from its last checkpoint at that rate."""
    import epic_tpu_torch.training.step as step_mod

    imgs = [u8[:128, :192] for u8 in synth_images(1,
                                                   np.random.default_rng(1))]
    args = _args(tmp_path, "first_train=4")
    real = step_mod.make_train_step

    def nan_step(model, plan, training=True):
        def step(state, batch, *rest):
            return {"loss": torch.tensor(float("nan")),
                    "bpp_loss": torch.tensor(float("nan"))}
        return step

    monkeypatch.setattr(step_mod, "make_train_step", nan_step)
    with pytest.raises(SystemExit) as exc:
        td.run(args, imgs, [True])
    assert exc.value.code == 4
    progress = json.loads((tmp_path / "progress.json").read_text())
    assert progress["nan_rewinds"] == 1 and progress["lr"] == 5e-5
    assert progress["stage"] == "first_train"
    monkeypatch.setattr(step_mod, "make_train_step", real)
    res = td.run(args, imgs, [True])
    # from the checkpoint the validation at step 2 wrote
    assert progress["next_step"] == 2
    assert res["stages"]["first_train"]["steps"] == 2
    assert np.isfinite(res["stages"]["first_train"]["metrics"]["loss"])
