"""Package-level properties of the PyTorch port: it stands without JAX, flax,
Pillow and the JAX package, and its small utilities match the JAX
package's."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from epic_tpu.utils.metrics import compute_psnr as j_psnr
from epic_tpu.utils.padding import pad_image as j_pad
from epic_tpu.utils.padding import unpad_image as j_unpad
from epic_tpu_torch.utils.metrics import compute_psnr
from epic_tpu_torch.utils.padding import pad_image, unpad_image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "PIL", "epic_tpu",
            "tensorstore", "zstandard")


def test_imports_without_jax_flax_pil():
    code = ("import sys\n"
            f"for name in {_BLOCKED!r}:\n"
            "    sys.modules[name] = None\n"
            "import epic_tpu_torch, chip_smoke\n"
            "import epic_tpu_torch.codec, epic_tpu_torch.ops.gdn_kernel\n"
            "import epic_tpu_torch.ops.rem, epic_tpu_torch.models.rem\n"
            "import epic_tpu_torch.tools.workload\n"
            "import epic_tpu_torch.tools.fold_diff\n"
            "import epic_tpu_torch.tools.profile_sweep\n"
            "import epic_tpu_torch.tools.profile_train\n"
            "import epic_tpu_torch.tools.train_witness\n"
            "import epic_tpu_torch.training.step\n"
            "import epic_tpu_torch.training.checkpoint\n"
            "import epic_tpu_torch.data.device_bank as db\n"
            "import epic_tpu_torch.cli.train_device\n"
            "import epic_tpu_torch.cli.codec, epic_tpu_torch.cli.demo\n"
            "import epic_tpu_torch.training.evaluate\n"
            "import epic_tpu_torch.utils.parser, epic_tpu_torch.data.png\n"
            "import epic_tpu_torch.native.zstd\n"
            "import epic_tpu_torch.training.ocdbt\n"
            "import epic_tpu_torch.training.orbax\n"
            "model, _, _ = epic_tpu_torch.load_checkpoint("
            "'tests/fixtures/orbax/flagship_tiled')\n"
            "assert type(model).__name__ == 'VarianceMaskingPICREM'\n"
            "try:\n"
            "    db.load_teaser_images('no/such/teaser.png')\n"
            "except FileNotFoundError as e:\n"
            "    assert 'teaser image not found' in str(e)\n"
            "else:\n"
            "    raise AssertionError('no error without the teaser')\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            f"{_BLOCKED!r} and sys.modules[m] is not None]\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_import_of_the_jax_package_in_the_port():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|tensorstore"
                     r"|zstandard|PIL|epic_tpu)\b"
                     r"(?!_torch)")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "epic_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(open(f), 1) if pat.match(line)]
    assert not hits


@pytest.mark.parametrize("hw", [(64, 64), (50, 70), (65, 129)])
def test_padding_matches(hw):
    x = np.random.default_rng(0).random((1,) + hw + (3,), dtype=np.float32)
    got, unpad = pad_image(torch.from_numpy(x))
    want, j_spec = j_pad(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert unpad == j_spec
    np.testing.assert_array_equal(unpad_image(got, unpad).numpy(), x)
    np.testing.assert_array_equal(np.asarray(j_unpad(want, j_spec)), x)


def test_psnr_matches():
    rng = np.random.default_rng(1)
    a = rng.random((1, 8, 8, 3), dtype=np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    assert abs(compute_psnr(a, b) - j_psnr(a, b)) < 1e-3
    assert compute_psnr(a, a) == float("inf")
