"""Progressive single-bitstream codec: encode once, decode any level, or
decode every level at once (``progressive_decode_all``).

One image is coded as one rANS stream per batch item: the base slices in
grid order, then every residual symbol stably sorted by its shell id, the
index of the first quality of ``q_list`` whose variance mask admits it.
``prefix[b][k]`` is the number of bytes of item b's stream that decode
levels 0..k. The decoder re-derives the shell ids from its own decoded
base latent (they are never transmitted) and caches the hyperprior, the
base latent and the progressive entropy parameters across levels.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..ops.masking import shell_ids
from .pic_codec import PICCodec, add_time

DEFAULT_Q_LIST = [0.01, 0.05, 0.1, 0.25, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0,
                  2.0, 3.0, 4.0, 4.5, 10.0]


def _flat(t: torch.Tensor) -> np.ndarray:
    """[S, B, h, w, c] device tensor -> host [B, S*h*w*c]."""
    return _flat_dev(t).cpu().numpy()


def _flat_dev(t: torch.Tensor) -> torch.Tensor:
    """[S, B, h, w, c] -> contiguous [B, S*h*w*c] on t's device."""
    return t.transpose(0, 1).reshape(t.shape[1], -1)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """Start t's copy to the host: into pinned memory without waiting for
    it on a CUDA device (the caller waits on an event recorded after it);
    on the CPU, t itself."""
    if t.device.type != "cuda":
        return t
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return buf.copy_(t, non_blocking=True)


# the encoder's device tensors that ``progressive_encode(state=...)`` hands
# back (the decode checks read them)
STATE_KEYS = ("lm", "ls", "base_slices", "base_mu", "base_scale", "base_sym",
              "mu_s", "scale_s", "msups", "psym", "sid", "auto_ckpts")


@torch.no_grad()
def progressive_encode_start(codec: PICCodec, x,
                             q_list: Optional[Sequence[float]] = None,
                             rems: bool = False, y_checkpoints=None,
                             timing: Optional[Dict[str, float]] = None
                             ) -> Dict[str, Any]:
    """The encoder's device half: queues every device stage (front, hyper,
    base chain, checkpoint latents, progressive params, symbols, shell
    ids) on the current stream and starts the copies of the six host
    arrays (z symbols; base symbols and CDF indexes; progressive symbols,
    CDF indexes and shell ids) into pinned host buffers, then records an
    event. Nothing waits for the device: between this call and
    ``progressive_encode_finish`` the device runs on. ``timing`` gets the
    dispatch seconds under "device_s".

    With ``rems`` (a ``rem`` model), the progressive params are the
    REM-chained ones, conditioned on ``y_checkpoints``; when none are given,
    the chained check-level latents are extracted from this encode's own
    front, hyper and base work (bitwise ``codec.extract_checkpoint`` at
    each level, the previous one as ``checkpoint_rep``) and returned under
    "auto_ckpts". The decoder needs the same latents.

    Returns the state that ``progressive_encode_finish`` consumes: "x" (the
    input on the device), "q_list", "auto_ckpts", "event" (None on the
    CPU), "host" (the six host buffers) and the encoder's device tensors
    (``STATE_KEYS``). An ``all_scalable=False`` model raises ValueError, as
    in the JAX package: its params change with the quality."""
    if not codec.model.progressive:
        raise ValueError("this model has no progressive stage (WACNN, "
                         "'cnn'): code it with codec.compress(x, 0, "
                         "buffered=True)")
    if not codec.model.all_scalable:
        # one symbol grid for every shell needs quality-independent params;
        # code such a model per quality with codec.compress
        raise ValueError("progressive coding requires all_scalable=True")
    q_list = list(q_list if q_list is not None else DEFAULT_Q_LIST)
    t = time.perf_counter()
    x = codec.as_input(x)
    enc = codec.encode_base(x)
    auto_ckpts = None
    if rems and y_checkpoints is None and getattr(codec.model,
                                                  "check_levels", None):
        y_checkpoints, prev = [], None
        for cl in codec.model.check_levels:
            prev = codec.checkpoint_latent(enc, cl, prev)
            y_checkpoints.append(prev)
        auto_ckpts = y_checkpoints
    ckpts = _checkpoints(codec, y_checkpoints) if rems else None
    mu_s, scale_s, msups, idx_full = codec.prog_params(
        enc["base_slices"], enc["lm"], enc["ls"], ckpts, enc["base_mu"],
        enc["base_scale"])
    psym = codec.prog_sym(enc["y"], mu_s)
    sid = shell_ids(scale_s, q_list)
    host = [_to_host(a) for a in (
        enc["z_sym"], _flat_dev(torch.stack(enc["base_sym"])),
        _flat_dev(torch.stack(enc["base_idx"])), _flat_dev(psym),
        _flat_dev(idx_full), _flat_dev(sid))]
    event = None
    if x.device.type == "cuda":
        event = torch.cuda.Event()
        event.record()
    add_time(timing, "device_s", t)
    st = {k: enc[k] for k in STATE_KEYS if k in enc}
    st.update(mu_s=mu_s, scale_s=scale_s, msups=msups, psym=psym, sid=sid,
              auto_ckpts=auto_ckpts, x=x, q_list=q_list, event=event,
              host=host)
    return st


def progressive_encode_finish(codec: PICCodec, st: Dict[str, Any],
                              timing: Optional[Dict[str, float]] = None):
    """The encoder's host half: waits for ``st["event"]`` alone (not for
    the device or a stream), then rANS-codes z and the one shell-sorted
    stream per image. ``timing`` gets the wait under "device_s" and the
    coding under "rans_s". Returns (bitstreams, [bits_z, bits_base,
    [bits per shell]])."""
    t = time.perf_counter()
    if st["event"] is not None:
        st["event"].synchronize()
    z_np, bsym, bidx, p_np, pidx, sid_np = (a.numpy() for a in st["host"])
    t = add_time(timing, "device_s", t)
    nq = len(st["q_list"])
    z_strings = codec.encode_z(z_np)
    blobs, prefix = codec.y_coder.encode_shell_batch(bsym, bidx, p_np, pidx,
                                                     sid_np, nq)
    add_time(timing, "rans_s", t)
    bitstreams = {"layout": "stream", "q_list": st["q_list"],
                  "shape": tuple(int(s) for s in z_np.shape[1:3]),
                  "z": z_strings, "y": blobs, "prefix": prefix}
    bits_z = sum(len(s) for s in z_strings) * 8.0
    bits_base = float(prefix[:, 0].sum()) * 8.0
    bits_prog = [float((prefix[:, j + 1] - prefix[:, j]).sum()) * 8.0
                 for j in range(nq)]
    return bitstreams, [bits_z, bits_base, bits_prog]


def progressive_encode(codec: PICCodec, x,
                       q_list: Optional[Sequence[float]] = None,
                       rems: bool = False, y_checkpoints=None,
                       timing: Optional[Dict[str, float]] = None,
                       state: Optional[Dict[str, Any]] = None):
    """Encode x [B,H,W,3] in [0,1] (H, W multiples of 64):
    ``progressive_encode_start`` then ``progressive_encode_finish``.
    Returns (bitstreams, [bits_z, bits_base, [bits per shell]]).

    ``timing`` accumulates seconds under "device_s" (device work and its
    copies) and "rans_s" (host entropy coding). ``state``, if given, is
    filled with the encoder's device tensors (``STATE_KEYS``: hyperprior,
    base slices and params, progressive params, symbols, shell ids,
    checkpoint latents) so a caller can check a decode against them."""
    st = progressive_encode_start(codec, x, q_list, rems, y_checkpoints,
                                  timing)
    out = progressive_encode_finish(codec, st, timing)
    if state is not None:
        state.update({k: st[k] for k in STATE_KEYS})
    return out


def _checkpoints(codec: PICCodec, y_checkpoints):
    """Checkpoint latents as float32 tensors on the codec's device."""
    return [codec.as_input(ck) for ck in y_checkpoints or ()]


@torch.no_grad()
def progressive_decode(codec: PICCodec, bitstreams: Dict[str, Any],
                       q_ind: int = 0, cache: Optional[Dict[str, Any]] = None,
                       rems: bool = False, y_checkpoints=None,
                       timing: Optional[Dict[str, float]] = None
                       ) -> Dict[str, Any]:
    """Decode levels 0..q_ind (0 = base only). ``cache`` carries the
    hyperprior, the base latent and params, the progressive entropy
    parameters, the stream decoders and the symbol canvas from one call to
    the next, so a walk up the levels decodes each shell once. A stream
    encoded with ``rems`` decodes with ``rems`` and the encoder's checkpoint
    latents. ``timing`` accumulates seconds under "device_s" and "rans_s".
    Returns {"x_hat", "y_hat", "cache"}."""
    cache = cache if cache is not None else {}
    t = _decode_symbols(codec, bitstreams, q_ind, cache, rems, y_checkpoints,
                        timing)
    if q_ind == 0:
        x_hat, y_hat = codec.synth_base(cache["base"])
    else:
        mu_s, msups, _, _, _ = cache["entropy"]
        x_hat, y_hat = codec.prog_reconstruct(
            _canvas_to_device(codec, cache), mu_s, msups, cache["base"])
    codec.synchronize()
    add_time(timing, "device_s", t)
    return {"x_hat": x_hat, "y_hat": y_hat, "cache": cache}


@torch.no_grad()
def progressive_decode_all(codec: PICCodec, bitstreams: Dict[str, Any],
                           rems: bool = False, y_checkpoints=None,
                           timing: Optional[Dict[str, float]] = None
                           ) -> Dict[str, Any]:
    """Decode the whole quality ladder at once: every shell through the
    incremental decoder up to the top level, then one reconstruction of
    all levels with the levels folded into the batch axis. Returns
    {"x_hat": [1+Q, B, H, W, 3] (base first), "y_prog_top"}."""
    nq = len(bitstreams["q_list"])
    cache: Dict[str, Any] = {}
    top = progressive_decode(codec, bitstreams, nq, cache, rems,
                             y_checkpoints, timing)
    t = time.perf_counter()
    x_base, _ = codec.synth_base(cache["base"])
    mu_s, msups, sid, _, _ = cache["entropy"]
    x_prog, _ = codec.prog_reconstruct_all(_canvas_to_device(codec, cache),
                                           sid, mu_s, msups, cache["base"],
                                           nq)
    x_hat = torch.cat([x_base[None], x_prog])
    codec.synchronize()
    add_time(timing, "device_s", t)
    return {"x_hat": x_hat, "y_prog_top": top["y_hat"]}


def _decode_symbols(codec: PICCodec, bitstreams: Dict[str, Any], q_ind: int,
                    cache: Dict[str, Any], rems: bool, y_checkpoints,
                    timing: Optional[Dict[str, float]]) -> float:
    """Fill ``cache`` up to level q_ind: z and the hyperprior, the base
    chain (interleaved with the stream decoders), then the progressive
    entropy parameters and the shells [decoded_upto, q_ind) on the host
    canvas. Returns the clock reading of the last phase change."""
    q_list = bitstreams["q_list"]
    nq = len(q_list)
    if not 0 <= q_ind <= nq:
        raise ValueError(f"q_ind {q_ind} outside [0, {nq}]")
    t = time.perf_counter()
    if "hyper" not in cache:
        z_sym = codec.decode_z(bitstreams["z"], bitstreams["shape"])
        t = add_time(timing, "rans_s", t)
        cache["hyper"] = codec.zhat_hyper(
            torch.as_tensor(z_sym, device=codec.device))
        cache["streams"] = [codec.y_coder.stream_decoder(s)
                            for s in bitstreams["y"]]
    lm, ls = cache["hyper"]

    if "base" not in cache:
        streams = cache["streams"]

        def symbols(i, mu, idx):
            nonlocal t
            idx_np = idx.cpu().numpy()
            t = add_time(timing, "device_s", t)
            sym = codec.y_coder.decode_streams(
                streams, idx_np, [idx_np[0].size] * idx_np.shape[0])
            t = add_time(timing, "rans_s", t)
            return torch.as_tensor(sym.reshape(idx_np.shape),
                                   device=codec.device)

        base, mus, scales, _, _ = codec.base_chain(lm, ls, symbols)
        cache["base"], cache["base_params"] = base, (mus, scales)

    if q_ind > 0 and "entropy" not in cache:
        ckpts = _checkpoints(codec, y_checkpoints) if rems else None
        mu_s, scale_s, msups, idx_full = codec.prog_params(
            cache["base"], lm, ls, ckpts, *cache["base_params"])
        sid = shell_ids(scale_s, q_list)
        cache["entropy"] = (mu_s, msups, sid, _flat(idx_full), _flat(sid))
        cache["canvas"] = np.zeros(cache["entropy"][4].shape, np.int16)
        cache["overflow"] = []
        cache["decoded_upto"] = 0
    if q_ind > 0 and q_ind > cache["decoded_upto"]:
        _, _, _, idx_np, sid_np = cache["entropy"]
        t = add_time(timing, "device_s", t)
        ovf = codec.y_coder.decode_shell_streams(
            cache["streams"], idx_np, sid_np, cache["decoded_upto"], q_ind,
            nq, cache["canvas"])
        t = add_time(timing, "rans_s", t)
        if ovf is not None:
            cache["overflow"].append(ovf)
        cache["decoded_upto"] = q_ind
    return t


def decoded_symbols(cache: Dict[str, Any]) -> np.ndarray:
    """The symbols decoded so far, host int32 [B, S*h*w*c] (undecoded = 0):
    the int16 canvas with the out-of-int16 symbols put back."""
    flat = cache["canvas"].astype(np.int32)
    for pos, val in cache["overflow"]:
        flat.reshape(-1)[pos] = val
    return flat


def _canvas_to_device(codec: PICCodec, cache: Dict[str, Any]) -> torch.Tensor:
    """decoded_symbols as int32 device symbols [S, B, h, w, c]."""
    shape = cache["entropy"][2].shape
    sym = torch.as_tensor(decoded_symbols(cache), device=codec.device)
    return sym.reshape((shape[1], shape[0]) + tuple(shape[2:])).transpose(
        0, 1).contiguous()

