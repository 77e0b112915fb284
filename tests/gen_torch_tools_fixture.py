"""Write ``tests/fixtures/tools_jax.json``: the JAX package's
``tools/eval_checkpoint.py`` (tiny ``rem``, float32) and
``tools/eval_cnn.py`` (tiny WACNN in bfloat16, as that tool runs it, and
once more in float32, its checkpoint loader made to override the dtype) on
two seeded synthetic 256x256 crops, run once on the CPU.

The checkpoints are the port's: ``init_weights(seed)`` written with
``save_checkpoint`` (``tiny_checkpoints``), so ``tests/test_torch_tools.py``
rebuilds the same files from the seeds and runs the port's tools on the
same crops (``tiles``) without compiling any JAX program. The crops reach
the JAX tools through their ``heldout_crops`` / ``region_crops``, replaced
in the imported tool modules; nothing under ``tools/`` is edited. XLA runs
without excess precision, so that the bf16 layers of the JAX WACNN round as
their dtype says, as the port's do. The bf16 WACNN tool runs once more in
a process of its own with XLA's default flags (excess precision allowed),
the program the JAX package runs unless told otherwise, under the key
``eval_cnn_xla_default``.

Not collected by pytest. Regenerate with:

    JAX_PLATFORMS=cpu python tests/gen_torch_tools_fixture.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIXTURE = os.path.join(HERE, "fixtures", "tools_jax.json")

TINY = dict(n=32, m=32, division=(16, 32), dim_chunk=8,
            param_net_widths=(24, 16))
CONFIGS = {"rem": dict(TINY, check_levels=(0.25, 0.75),
                       rem_dimension="middle"),
           "cnn": dict(TINY, division=(32, 32))}
SEEDS = {"rem": 3, "cnn": 4}
TILE_SEED = 0


def tiles(seed: int = TILE_SEED):
    """Two uint8 [256, 256, 3] photographic-looking tiles: smooth colour
    waves and edges plus noise, from ``seed``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float64)
    out = []
    for k in range(2):
        f = rng.uniform(4, 24, (3, 2))
        ph = rng.uniform(0, 2 * np.pi, 3)
        base = np.stack([0.5 + 0.35 * np.sin(xx / f[c, 0] + ph[c])
                         * np.cos(yy / f[c, 1]) for c in range(3)], -1)
        base += 0.2 * ((xx + 2 * yy) % (64 + 32 * k) < 20)[..., None]
        base += 0.04 * rng.standard_normal(base.shape)
        out.append(np.clip(np.round(base * 255), 0, 255).astype(np.uint8))
    return out


def tiny_checkpoints(root: str):
    """{name: checkpoint dir} of the tiny ``rem`` and ``cnn`` models, the
    port's ``init_weights(SEEDS[name])`` written by ``save_checkpoint``."""
    from epic_tpu_torch import get_model
    from epic_tpu_torch.training.checkpoint import save_checkpoint

    out = {}
    for name, cfg in CONFIGS.items():
        out[name] = os.path.join(root, name)
        model = get_model(name, **cfg).init_weights(SEEDS[name])
        save_checkpoint(out[name], model,
                        {k: list(v) if isinstance(v, tuple) else v
                         for k, v in dict(cfg, model=name).items()}, step=1)
    return out


def main():
    default_flags = "--xla-default-flags" in sys.argv
    if not default_flags:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_allow_excess_precision=false")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import eval_checkpoint as j_eval
    import eval_cnn as j_cnn
    import epic_tpu.training as j_training

    j_load = j_training.load_checkpoint

    def load_float32(*a, config_overrides=None, **kw):
        return j_load(*a, config_overrides=dict(
            config_overrides or {}, compute_dtype="float32"), **kw)

    crops = [t.astype(np.float32) / 255.0 for t in tiles()]
    j_eval.heldout_crops = lambda patch=256: list(crops)
    j_eval.region_crops = lambda region, patch=256: list(crops)
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["HOME"] = tmp  # the JAX tools' compile cache
        ck = tiny_checkpoints(tmp)
        res = {}
        runs = (("eval_checkpoint", j_eval,
                 [ck["rem"], "--compute_dtype", "float32"]),
                ("eval_cnn", j_cnn, [ck["cnn"], "--regions", "val"]),
                ("eval_cnn_float32", j_cnn, [ck["cnn"], "--regions", "val"]))
        if default_flags:
            runs = (("eval_cnn_xla_default", j_cnn,
                     [ck["cnn"], "--regions", "val"]),)
        for name, tool, argv in runs:
            out = os.path.join(tmp, name + ".json")
            j_training.load_checkpoint = (load_float32 if "float32" in name
                                          else j_load)
            tool.main(argv + ["--out", out])
            with open(out) as f:
                res[name] = json.load(f)
            res[name]["checkpoint"] = os.path.basename(
                res[name]["checkpoint"].split("/last")[0]) + "/last@1"
    if default_flags:
        print(json.dumps(res))
        return
    env = dict(os.environ)
    env["XLA_FLAGS"] = env["XLA_FLAGS"].replace(
        "--xla_allow_excess_precision=false", "").strip()
    if not env["XLA_FLAGS"]:
        del env["XLA_FLAGS"]
    with tempfile.TemporaryDirectory() as home:
        env["HOME"] = home
        proc = subprocess.run(
            [sys.executable, __file__, "--xla-default-flags"], env=env,
            capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    res.update(json.loads(proc.stdout.strip().splitlines()[-1]))
    res["meta"] = {"configs": {k: {kk: list(vv) if isinstance(vv, tuple)
                                   else vv for kk, vv in v.items()}
                               for k, v in CONFIGS.items()},
                   "seeds": SEEDS, "tile_seed": TILE_SEED}
    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    with open(FIXTURE, "w") as f:
        json.dump(res, f, indent=1)
    print(f"wrote {FIXTURE}")


if __name__ == "__main__":
    main()
