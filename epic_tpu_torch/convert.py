"""Weights carried across from the JAX package.

``load_checkpoint(directory)`` reads a committed checkpoint (``config.json``
and ``last.npz`` or ``best.npz``, as the JAX package's ``save_artifact``
writes them, in the stacked or the older per-slice layout) with numpy alone
and returns the port's model with its weights.

``from_jax_params(params, model)`` takes the JAX package's parameter tree
(nested dicts of numpy arrays, as ``jax.device_get`` or a ``last.npz``
gives them) and returns the port model's ``state_dict``. The port's module
and parameter names follow the flax tree, so each leaf maps by its path:

- conv kernels HWIO -> OIHW;
- transposed-conv kernels HWIO -> spatially flipped [in, out, kh, kw]
  (see ``ops.conv.ConvTranspose``);
- dense kernels [in, out] -> [out, in];
- stacked per-slice heads [S, 3, 3, in, out] -> [S, out, in, 3, 3];
- stacked REM bank kernels [S, kh, kw, in, out] -> [S, out, in, kh, kw];
- everything else (GDN's reparametrised beta/gamma, relative-bias tables,
  the entropy bottleneck's matrices, biases, factors and quantiles) as is.

bfloat16 arrays that numpy surfaces as opaque ``|V2`` go through uint16.
Any array left over or missing, or of the wrong shape, raises.

``to_jax_params(model)`` is the inverse: the port's parameters as the JAX
package's tree of float32 numpy arrays, so that checkpoints the port writes
load in either package.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn


def _as_f32(a) -> np.ndarray:
    """An array as float32; bfloat16 (numpy's opaque ``|V2``) exactly, as
    the top half of a float32."""
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and a.dtype.kind == "V":
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def _to_tensor(a) -> torch.Tensor:
    return torch.from_numpy(_as_f32(a))


def _flatten(tree: Dict[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _convert_leaf(path, t: torch.Tensor):
    name, parent = path[-1], (path[-2] if len(path) > 1 else "")
    key = ".".join(path[:-1])
    if name == "kernel" and t.ndim == 4:
        if parent.startswith("ConvTranspose"):
            t = torch.flip(t, (0, 1)).permute(2, 3, 0, 1)
        else:
            t = t.permute(3, 2, 0, 1)
        name = "weight"
    elif name == "kernel" and t.ndim == 5:
        t, name = t.permute(0, 4, 3, 1, 2), "weight"
    elif name == "kernel" and t.ndim == 2:
        t, name = t.t(), "weight"
    elif name.startswith("Conv_") and name.endswith("_kernel"):
        t = t.permute(0, 4, 3, 1, 2)
    return (f"{key}.{name}" if key else name), t.contiguous()


def from_jax_params(params: Dict[str, Any], model: nn.Module
                    ) -> Dict[str, torch.Tensor]:
    """The JAX parameter tree of ``model``'s configuration -> its state_dict
    (float32). Raises ValueError on leftover, missing or misshapen arrays."""
    if set(params) == {"params"}:
        params = params["params"]
    want = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    leftover = []
    for path, a in _flatten(params):
        key, t = _convert_leaf(path, _to_tensor(a))
        if key not in want:
            leftover.append("/".join(path))
            continue
        if t.shape != want[key].shape:
            raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)} "
                             f"does not fit {key} {tuple(want[key].shape)}")
        out[key] = t
    missing = sorted(set(want) - set(out))
    if leftover or missing:
        raise ValueError(f"arrays left over: {leftover}; "
                         f"parameters missing: {missing}")
    return out


def _jax_leaf(key: str, t: torch.Tensor):
    """The inverse of ``_convert_leaf``: a state_dict entry -> (flax path,
    array)."""
    path = key.split(".")
    name, parent = path[-1], (path[-2] if len(path) > 1 else "")
    if name == "weight" and t.ndim == 4:
        if parent.startswith("ConvTranspose"):
            t = torch.flip(t.permute(2, 3, 0, 1), (0, 1))
        else:
            t = t.permute(2, 3, 1, 0)
        name = "kernel"
    elif name == "weight" and t.ndim == 5:
        t, name = t.permute(0, 3, 4, 2, 1), "kernel"
    elif name == "weight" and t.ndim == 2:
        t, name = t.t(), "kernel"
    elif name.startswith("Conv_") and name.endswith("_kernel"):
        t = t.permute(0, 3, 4, 2, 1)
    return tuple(path[:-1]) + (name,), t


def to_jax_params(model: nn.Module) -> Dict[str, Any]:
    """A model -> the JAX package's parameter tree of float32 numpy arrays.
    ``from_jax_params`` of the result gives the state_dict back bitwise."""
    tree: Dict[str, Any] = {}
    for key, t in model.state_dict().items():
        path, t = _jax_leaf(key, t.detach().float().cpu())
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(t.numpy())
    return tree


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{"a/b/c": leaf} -> {"a": {"b": {"c": leaf}}}."""
    root: Dict[str, Any] = {}
    for key, v in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _stacked_dead_blocks(model):
    """Per stacked head: (name, slices, slot_fn) with ``slot_fn(i) -> (pos,
    pad)``: slice i's first-layer kernel input rows [pos, pos + pad) meet
    support channels that the fixed-width layout keeps zero for that slice
    (the padding that makes the reference's ragged per-slice heads
    stackable), as the JAX package's ``training.checkpoint.
    _stacked_dead_blocks``:

    - base heads: [d0 | support(k) | zeros]; base lrp: the same, then y_hat;
    - progressive heads: [dp | base_i | zeros | mu_total(k)]; progressive
      lrp: the same, then y_hat."""
    c, d0 = model.dim_chunk, model.division[0]
    dp = model.division[1] - d0
    nprog = model.ns1 - model.ns0
    nb, npg = model.n_slots_base, model.n_slots_prog

    def slots_base(i):
        k = i if model.max_support_slices < 0 else \
            min(model.max_support_slices, i)
        return d0 + k * c, (nb - k) * c

    def slots_prog(i):
        k = (min(model.support_progressive_slices, i)
             if model.support_progressive_slices > 0 else 0)
        return dp + c, (npg - k) * c

    return [("cc_mean", model.ns0, slots_base),
            ("cc_scale", model.ns0, slots_base),
            ("lrp", model.ns0, slots_base),
            ("cc_mean_prog", nprog, slots_prog),
            ("cc_scale_prog", nprog, slots_prog),
            ("lrp_prog", model.ns0, slots_prog)]


def stack_legacy_param_nets(params: Dict[str, Any], model) -> Dict[str, Any]:
    """The per-slice layout (``cc_mean_0`` ... with ``Conv_{l}/kernel``
    [3, 3, in_i, out], ``post_latent_{r}_{i}``) -> the stacked one
    (``cc_mean/Conv_{l}_kernel`` [S, 3, 3, in, out], ``post_latent_{r}``
    with a leading slice axis on every leaf), as the JAX package's
    ``training.checkpoint.stack_legacy_param_nets``. Each slice's ragged
    first-layer input rows are zero-padded at the slots that slice does not
    fill (``_stacked_dead_blocks``). Zero rows meet zero inputs, so the
    converted weights compute what the per-slice heads did."""
    p = dict(params)
    for name, count, slots in _stacked_dead_blocks(model):
        if f"{name}_0" not in p:
            continue
        subs = [p.pop(f"{name}_{i}") for i in range(count)]
        stacked = {}
        for layer in range(len(subs[0])):
            kernels = []
            for i, sub in enumerate(subs):
                kern = _as_f32(sub[f"Conv_{layer}"]["kernel"])
                pos, pad = slots(i) if layer == 0 else (0, 0)
                if pad:
                    kern = np.concatenate(
                        [kern[:, :, :pos],
                         np.zeros(kern.shape[:2] + (pad,) + kern.shape[3:],
                                  np.float32), kern[:, :, pos:]], axis=2)
                kernels.append(kern)
            stacked[f"Conv_{layer}_kernel"] = np.stack(kernels)
            stacked[f"Conv_{layer}_bias"] = np.stack(
                [_as_f32(sub[f"Conv_{layer}"]["bias"]) for sub in subs])
        p[name] = stacked

    def stack_trees(trees):
        if isinstance(trees[0], dict):
            return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
        return np.stack([_as_f32(t) for t in trees])

    r = 0
    while f"post_latent_{r}_0" in p:
        p[f"post_latent_{r}"] = stack_trees(
            [p.pop(f"post_latent_{r}_{i}") for i in range(model.ns0)])
        r += 1
    return p


def _model_from_config(config: Dict[str, Any]):
    from .models import get_model

    cfg = {k: tuple(v) if isinstance(v, list) else v
           for k, v in config.items() if k != "model"}
    return get_model(config.get("model", "pic"), **cfg)


def checkpoint_source(directory: str, which: str):
    """Where checkpoint ``which`` of ``directory`` lives, in the JAX
    package's precedence: ``("npz", {which}.npz)``, else ``("orbax",
    {which}/)`` for the Orbax directory the JAX trainer writes (it holds
    ``_METADATA``), else ``(None, None)``."""
    npz = os.path.join(directory, which + ".npz")
    if os.path.isfile(npz):
        return "npz", npz
    orbax_dir = os.path.join(directory, which)
    if os.path.isfile(os.path.join(orbax_dir, "_METADATA")):
        return "orbax", orbax_dir
    return None, None


def load_checkpoint(directory: str, which: str = "last",
                    config_overrides: Optional[Dict[str, Any]] = None,
                    disable_rems_if_missing: bool = True, seed: int = 0):
    """A checkpoint directory -> (model, config, step): the model named by
    ``config.json`` (with ``config_overrides`` applied, e.g.
    ``{"compute_dtype": "float32"}``) on the CPU, with every array of
    ``{which}.npz`` ("last" or "best") loaded, as the JAX package's
    ``load_checkpoint`` reads it. Without that file, the Orbax directory
    ``{which}/`` that the JAX trainer writes is read
    (``training.orbax.read_orbax``; see ``checkpoint_source``). The
    per-slice layout of older checkpoints is stacked first
    (``stack_legacy_param_nets``).

    A ``rem`` config whose checkpoint has no REM banks (a ``pic``
    checkpoint loaded with the REM overrides) loads as the plain ``pic``
    model with the REM fields dropped, as in the JAX package. With
    ``disable_rems_if_missing=False`` (the REM training stage) it loads as
    the ``rem`` model instead, ``config`` as given: the checkpoint's arrays
    merged (``training.checkpoint.merge_params``) over the model's
    ``init_weights(seed)``, so its banks are fresh, which it prints as the
    JAX trainer does ("initialized REM banks fresh; merged parent
    weights")."""
    with open(os.path.join(directory, "config.json")) as f:
        meta = json.load(f)
    config = dict(meta["config"])
    config.update(config_overrides or {})
    config.setdefault("model", "pic")
    kind, path = checkpoint_source(directory, which)
    if kind == "npz":
        with np.load(path) as z:
            params = _unflatten({k: z[k] for k in z.files})
    elif kind == "orbax":
        from .training.orbax import read_orbax

        params = read_orbax(path)
    else:
        raise FileNotFoundError(
            f"no checkpoint {which!r} in {directory}: neither "
            f"{os.path.join(directory, which + '.npz')} nor an Orbax "
            f"directory {os.path.join(directory, which, '_METADATA')}")
    model = _model_from_config(config)
    if "cc_mean_0" in params or "post_latent_0_0" in params:
        params = stack_legacy_param_nets(params, model)
    step = meta.get("step", 0)
    if config["model"] == "rem" and "post_latent_0" not in params:
        parent_config = {k: v for k, v in config.items()
                         if k not in ("check_levels", "mu_std",
                                      "rem_dimension")}
        parent_config["model"] = "pic"
        parent = _model_from_config(parent_config)
        if disable_rems_if_missing:
            model, config = parent, parent_config
        else:
            from .training.checkpoint import merge_params

            model.init_weights(seed)
            model.load_state_dict(merge_params(
                model.state_dict(), from_jax_params(params, parent)))
            print("initialized REM banks fresh; merged parent weights",
                  flush=True)
            return model, config, step
    model.load_state_dict(from_jax_params(params, model))
    return model, config, step
