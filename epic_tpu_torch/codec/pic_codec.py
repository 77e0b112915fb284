"""Device stages of the PIC codec, shared by the encoder and the decoder.

The encoder simulates the decoder: every entropy parameter, CDF index and
mask is computed by the same method on both sides, on tensors of the same
shape and dtype, so the decoder re-derives the encoder's values bit for bit
(the variance mask is never transmitted). The base chain is interleaved
with the host coder: slice i+1's parameters need slice i's decoded content.
With ``all_scalable`` (the default) the progressive stage is
quality-independent given the base latent (and, for a ``rem`` model, the
checkpoint latents that its REMs are conditioned on), so its parameters are
computed once. Without it the progressive slices are interleaved as the
base ones are, at the coded quality: the decoder makes one device-to-host
round trip per progressive slice, the encoder none until its one symbol
fetch. A checkpoint latent is the progressive latent at one quality,
computed from the encoder's symbols alone (the rANS round trip is
lossless).

Symbols and CDF indexes cross to the host as packed integer arrays, one
copy per stage; the host rANS coder runs batched calls over threads.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..entropy.coder import RansCoder
from ..entropy.gaussian import build_indexes, gaussian_coder, get_scale_table
from ..models.pic import VarianceMaskingPIC
from ..ops.masking import prog_mask, variance_mask


class PICCodec:
    """Binds a model to its entropy-coding state on one device (``cuda``
    unless ``device="cpu"`` is passed)."""

    def __init__(self, model: VarianceMaskingPIC, device=None,
                 nthreads: Optional[int] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.scale_table = get_scale_table()
        self._scale_table_dev = torch.as_tensor(self.scale_table,
                                                device=self.device)
        self.y_coder = gaussian_coder(self.scale_table, nthreads)
        self.nthreads = nthreads
        self.update()

    def update(self) -> None:
        """Rebuild the z coder's tables from the current weights."""
        tables, medians = self.model.entropy_bottleneck.cdf_tables()
        self.z_coder = RansCoder(tables.quantized_cdf, tables.cdf_length,
                                 tables.offset, nthreads=self.nthreads)
        self.z_medians = torch.as_tensor(medians, device=self.device)

    def synchronize(self) -> None:
        """Wait for the work queued on the calling thread's current stream
        (so that host clocks read finished work), not for the whole
        device: concurrent sweeps run on streams of their own."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def as_input(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=torch.float32, device=self.device)

    # ---- front and hyperprior ----
    def front(self, x: torch.Tensor):
        """g_a -> h_a; z symbols rounded around the medians. -> (y, z_sym)"""
        y = self.model.latent(x)
        z = self.model.hyper_analysis(y)
        return y, torch.round(z - self.z_medians).to(torch.int32)

    def zhat_hyper(self, z_sym: torch.Tensor, base_only: bool = False):
        """-> (latent_means, latent_scales) from decoded z symbols; with
        ``base_only`` the base branch's alone (a base-only decode)."""
        z_hat = z_sym.to(torch.float32) + self.z_medians
        if base_only:
            return self.model.hyper_synthesis_base(z_hat)
        return self.model.hyper_synthesis(z_hat)

    def indexes(self, scale: torch.Tensor) -> torch.Tensor:
        """CDF-table bucket of each scale, uint8."""
        return build_indexes(scale, self._scale_table_dev,
                             self.model.scale_bound).to(torch.uint8)

    # ---- base chain ----
    def base_chain(self, lm, ls,
                   symbols: Callable[[int, torch.Tensor, torch.Tensor],
                                     torch.Tensor]):
        """The interleaved base chain, one slice at a time. ``symbols(i, mu,
        idx)`` returns slice i's int32 symbols: the encoder rounds y - mu,
        the decoder rANS-decodes with idx. Returns (y_hat slices, mus,
        scales, idxs, syms) as lists."""
        m = self.model
        lm_b, ls_b = lm[..., :m.division[0]], ls[..., :m.division[0]]
        buf = m.base_buffer(lm_b)
        out = ([], [], [], [], [])
        for i in range(m.ns0):
            mu, scale, msup = m.base_slice_params(lm_b, ls_b, buf, i)
            idx = self.indexes(scale)
            sym = symbols(i, mu, idx)
            y_hat, buf = m.finish_base_slice(sym.to(torch.float32) + mu, msup,
                                             buf, i)
            for acc, t in zip(out, (y_hat, mu, scale, idx, sym)):
                acc.append(t)
        return out

    def encode_base(self, x: torch.Tensor) -> Dict[str, Any]:
        """The encoder's front, hyperprior and base chain (it knows every
        symbol): y, z_sym, lm, ls, and the base chain's y_hat slices,
        mus, scales, CDF indexes and symbols."""
        y, z_sym = self.front(x)
        lm, ls = self.zhat_hyper(z_sym)
        c = self.model.dim_chunk
        y_base = y[..., :self.model.division[0]]

        def symbols(i, mu, idx):
            return torch.round(y_base[..., i * c:(i + 1) * c] - mu).to(
                torch.int32)

        base = self.base_chain(lm, ls, symbols)
        return dict(zip(("base_slices", "base_mu", "base_scale", "base_idx",
                         "base_sym"), base), y=y, z_sym=z_sym, lm=lm, ls=ls)

    def synth_base(self, base_slices: List[torch.Tensor]):
        y = torch.cat(list(base_slices), dim=-1)
        return torch.clamp(self.model.synthesize_base(y), 0.0, 1.0), y

    # ---- progressive stage ----
    def prog_params(self, base_slices, lm, ls, rem_ckpts=None, mus_b=None,
                    scales_b=None):
        """Quality-independent progressive (mu, scale, mean_support) of every
        slice, stacked [S, ...], and the unmasked CDF indexes (uint8). With
        checkpoint latents ``rem_ckpts`` (a ``rem`` model, which also needs
        the base chain's mus and scales), the REM-chained params."""
        d0 = self.model.division[0]
        lm_e, ls_e = lm[..., d0:], ls[..., d0:]
        if rem_ckpts:
            mu_s, scale_s, msups = self.model.rem_chain_params(
                base_slices, lm_e, ls_e, rem_ckpts, mus_b, scales_b)
        else:
            mu_s, scale_s, msups = self.model.prog_param_chain(
                base_slices, lm_e, ls_e)
        return mu_s, scale_s, msups, self.indexes(scale_s)

    def prog_params_at(self, quality: float, base_slices, lm, ls, ckpt=None,
                       mus_b=None, scales_b=None):
        """Progressive params at one quality: the plain chain, REM-refined
        at ``quality`` when a checkpoint latent is given (the support chain
        stays unrefined), the variance mask of the refined scales and the
        masked CDF indexes. Returns (mu_s, scale_s, mask, idx, msups)."""
        d0 = self.model.division[0]
        mu_s, scale_s, msups = self.model.prog_param_chain(
            base_slices, lm[..., d0:], ls[..., d0:])
        if ckpt is not None:
            mu_s, scale_s = self.model.refine_prog_params_all(
                quality, mu_s, scale_s, ckpt, torch.stack(list(mus_b)),
                torch.stack(list(scales_b)))
        mask = prog_mask(scale_s, quality, self.model.mask_policy)
        return mu_s, scale_s, mask, self.indexes(scale_s * mask), msups

    def prog_sym(self, y: torch.Tensor, mu_s: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Residual symbols [S, B, h, w, c] int32: round((r - mu) * mask)
        per slice, r the model's residual (y_prog - y_base with
        ``delta_encode``, else y_prog; no mask: every element)."""
        r = self.model.residuals(y) - mu_s
        if mask is not None:
            r = r * mask
        return torch.round(r).to(torch.int32)

    # ---- progressive stage without all_scalable: one slice at a time ----
    def ns_prog_chain(self, quality: float, base, lm, ls, symbols,
                      ckpt=None, mus_b=None, scales_b=None):
        """The interleaved progressive chain at one quality: slice i's
        params are supported on the decoded progressive slices 0..i-1 and,
        with a checkpoint latent, REM-refined (which needs the base chain's
        ``mus_b`` / ``scales_b``); then its variance mask and masked CDF
        indexes. ``symbols(i, mu, mask, idx)`` returns slice i's int32
        symbols: the encoder rounds (r_i - mu) * mask, the decoder
        rANS-decodes with idx. Returns (decoded slices, idxs, syms) as
        lists."""
        m = self.model
        d0 = m.division[0]
        out = ([], [], [])
        for i in range(m.ns1 - m.ns0):
            mu, _, scale, msup = m.prog_slice_params(
                lm[..., d0:], ls[..., d0:], base[i], out[0], out[0], i)
            if ckpt is not None:
                mu, scale = m.refine_prog_params(i, quality, mu, scale, ckpt,
                                                 mus_b[i], scales_b[i])
            mask = variance_mask(scale, quality, m.mask_policy)
            idx = self.indexes(scale * mask)
            sym = symbols(i, mu, mask, idx)
            y_hat = m.finish_prog_slice(sym.to(torch.float32) + mu, msup,
                                        base[i], i)
            for acc, t in zip(out, (y_hat, idx, sym)):
                acc.append(t)
        return out

    def ns_encode(self, enc: Dict[str, Any], quality: float, ckpt=None):
        """The encoder's interleaved progressive chain from its
        ``encode_base`` output: (decoded slices, idxs, syms), all on the
        device."""
        r_s = self.model.residuals(enc["y"])

        def symbols(i, mu, mask, idx):
            return torch.round((r_s[i] - mu) * mask).to(torch.int32)

        return self.ns_prog_chain(quality, enc["base_slices"], enc["lm"],
                                  enc["ls"], symbols, ckpt, enc["base_mu"],
                                  enc["base_scale"])

    def prog_latent(self, sym_s, mu_s, msups, base_slices) -> torch.Tensor:
        """Symbols [S,B,h,w,c] (untransmitted = 0) -> y_prog: dequantize +
        LRP + merge of every slice."""
        return torch.cat([
            self.model.finish_prog_slice(sym_s[i].to(torch.float32) + mu_s[i],
                                         msups[i], base_slices[i], i)
            for i in range(sym_s.shape[0])], dim=-1)

    def prog_reconstruct(self, sym_s, mu_s, msups, base_slices):
        """One level: symbols -> (x_hat, y_prog) through g_s."""
        y_prog = self.prog_latent(sym_s, mu_s, msups, base_slices)
        x = self.model.synthesize_prog(y_prog)
        return torch.clamp(x, 0.0, 1.0), y_prog

    def prog_reconstruct_all(self, sym_s, sid, mu_s, msups, base_slices,
                             n_levels: int):
        """Levels 1..n_levels at once: level l keeps the symbols whose shell
        id is below l. The levels fold into the batch axis (level-major)
        through LRP and g_s. Returns (x_hat, y_prog), each [L, B, ...]."""
        lvl = torch.arange(1, n_levels + 1, dtype=torch.int32,
                           device=sid.device).reshape(-1, 1, 1, 1, 1, 1)
        sym_l = sym_s[None] * (sid[None].to(torch.int32) < lvl)
        b = sym_s.shape[1]

        def fold(t):
            return t.repeat((n_levels,) + (1,) * (t.dim() - 1))

        slices = []
        for i in range(sym_s.shape[0]):
            y_hat = (sym_l[:, i].to(torch.float32) + mu_s[i][None]).reshape(
                (n_levels * b,) + tuple(mu_s.shape[2:]))
            slices.append(self.model.finish_prog_slice(
                y_hat, fold(msups[i]), fold(base_slices[i]), i))
        y_prog = torch.cat(slices, dim=-1)
        x = torch.clamp(self.model.synthesize_prog(y_prog), 0.0, 1.0)
        return (x.reshape((n_levels, b) + tuple(x.shape[1:])),
                y_prog.reshape((n_levels, b) + tuple(y_prog.shape[1:])))

    # ---- checkpoint latents (REM conditioning) ----
    def checkpoint_latent(self, enc: Dict[str, Any], quality: float,
                          checkpoint_rep=None) -> torch.Tensor:
        """The decoded latent at a checkpoint quality from the encoder's
        ``encode_base`` output: the base latent for quality <= 0, else
        y_prog at that quality (REM-refined by ``checkpoint_rep``, the
        previous checkpoint, when given). It skips g_s: only the latent
        conditions the REMs."""
        base = enc["base_slices"]
        if quality <= 0:
            return torch.cat(base, dim=-1)
        if not self.model.all_scalable:
            return torch.cat(self.ns_encode(enc, float(quality),
                                            checkpoint_rep)[0], dim=-1)
        mu_s, _, mask, _, msups = self.prog_params_at(
            float(quality), base, enc["lm"], enc["ls"], checkpoint_rep,
            enc["base_mu"], enc["base_scale"])
        sym = self.prog_sym(enc["y"], mu_s, mask)
        return self.prog_latent(sym, mu_s, msups, base)

    @torch.no_grad()
    def extract_checkpoint(self, x, quality: float,
                           checkpoint_rep=None) -> torch.Tensor:
        """The decoded latent of image x at a checkpoint quality, for REM
        conditioning; chained checkpoints pass the previous one as
        ``checkpoint_rep``. Device work only: the rANS round trip is
        lossless, so the encoder's symbols determine the latent."""
        ckpt = None if checkpoint_rep is None else self.as_input(
            checkpoint_rep)
        return self.checkpoint_latent(self.encode_base(self.as_input(x)),
                                      quality, ckpt)

    # ---- random access: one quality, per-slice messages ----
    @torch.no_grad()
    def compress(self, x, quality: float = 0.0, return_latents: bool = False,
                 checkpoint_rep=None, buffered: bool = False
                 ) -> Dict[str, Any]:
        """Code x [B,H,W,3] in [0,1] (H, W multiples of 64) at one quality:
        z, the base slices and, for quality > 0, every progressive slice
        with its variance mask at that quality (REM-refined by the
        checkpoint latent ``checkpoint_rep`` when given). Returns
        {"strings": [y_strings, z_strings] (y_strings: one list of B
        messages per base slice, then per progressive slice), "shape",
        "quality", "buffered", "io_chain": False}, the JAX package's
        layout. With ``buffered`` at quality <= 0 (WACNN's coding), y_strings
        is one list of B messages, each image's every base slice in one
        stream. With ``return_latents``: the decoder's latent, "y_hat_base"
        at quality <= 0, else "y_hat" (bitwise ``extract_checkpoint``).
        Without ``all_scalable`` the progressive slices are coded by the
        interleaved chain at ``quality`` (``ns_encode``)."""
        enc = self.encode_base(self.as_input(x))
        z_np = enc["z_sym"].cpu().numpy()
        sym, idx = torch.stack(enc["base_sym"]), torch.stack(enc["base_idx"])
        buffered = bool(buffered and quality <= 0)
        y_strings = ([self._encode_images(sym, idx)] if buffered
                     else self._encode_slices(sym, idx))
        out: Dict[str, Any] = {
            "strings": [y_strings, self.encode_z(z_np)],
            "shape": tuple(int(s) for s in z_np.shape[1:3]),
            "quality": float(quality), "buffered": buffered,
            "io_chain": False}
        if quality <= 0:
            if return_latents:
                out["y_hat_base"] = torch.cat(enc["base_slices"], dim=-1)
            return out
        ckpt = None if checkpoint_rep is None else self.as_input(
            checkpoint_rep)
        if not self.model.all_scalable:
            prog, idxs, syms = self.ns_encode(enc, float(quality), ckpt)
            y_strings.extend(self._encode_slices(torch.stack(syms),
                                                 torch.stack(idxs)))
            if return_latents:
                out["y_hat"] = torch.cat(prog, dim=-1)
            return out
        mu_s, _, mask, idx, msups = self.prog_params_at(
            float(quality), enc["base_slices"], enc["lm"], enc["ls"], ckpt,
            enc["base_mu"], enc["base_scale"])
        sym = self.prog_sym(enc["y"], mu_s, mask)
        y_strings.extend(self._encode_slices(sym, idx))
        if return_latents:
            out["y_hat"] = self.prog_latent(sym, mu_s, msups,
                                            enc["base_slices"])
        return out

    @torch.no_grad()
    def decompress(self, bitstream: Dict[str, Any],
                   quality: Optional[float] = None,
                   checkpoint_rep=None,
                   timing: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
        """The mirror of ``compress`` (at the stream's quality unless
        ``quality`` is given, with the same ``checkpoint_rep``): returns
        {"x_hat", "y_hat"}, y_hat the base latent at quality <= 0, else the
        progressive one. A quality-0 decode runs the base hyper branch
        only. A buffered stream decodes slice by slice from one stream
        decoder per image. Without ``all_scalable`` each progressive slice
        is one round trip (its CDF indexes to the host, its symbols back);
        ``timing`` then gets each round trip's seconds, the wait for the
        indexes included, under "slice_round_trip_s"."""
        quality = float(bitstream["quality"] if quality is None
                        else quality)
        y_strings, z_strings = bitstream["strings"]
        z_sym = self.decode_z(z_strings, tuple(bitstream["shape"]))
        lm, ls = self.zhat_hyper(torch.as_tensor(z_sym, device=self.device),
                                 base_only=quality <= 0)
        streams = ([self.y_coder.stream_decoder(s) for s in y_strings[0]]
                   if bitstream.get("buffered") else None)

        def symbols(i, mu, idx):
            idx = idx.cpu().numpy()
            if streams is None:
                return self._decode_slice(y_strings[i], idx)
            sym = self.y_coder.decode_streams(streams, idx.reshape(-1),
                                              [idx[0].size] * idx.shape[0])
            return torch.as_tensor(sym.reshape(idx.shape), device=self.device)

        try:
            base, mus, scales, _, _ = self.base_chain(lm, ls, symbols)
        finally:
            for st in streams or ():
                st.close()
        if quality <= 0:
            x_hat, y_hat = self.synth_base(base)
            return {"x_hat": x_hat, "y_hat": y_hat}
        ckpt = None if checkpoint_rep is None else self.as_input(
            checkpoint_rep)
        ns0 = self.model.ns0
        if not self.model.all_scalable:
            trips = [] if timing is None else timing.setdefault(
                "slice_round_trip_s", [])

            def prog_symbols(i, mu, mask, idx):
                t = time.perf_counter()
                sym = self._decode_slice(y_strings[ns0 + i],
                                         idx.cpu().numpy())
                trips.append(time.perf_counter() - t)
                return sym

            prog, _, _ = self.ns_prog_chain(quality, base, lm, ls,
                                            prog_symbols, ckpt, mus, scales)
            y_hat = torch.cat(prog, dim=-1)
            x_hat = torch.clamp(self.model.synthesize_prog(y_hat), 0.0, 1.0)
            return {"x_hat": x_hat, "y_hat": y_hat}
        mu_s, _, _, idx, msups = self.prog_params_at(
            quality, base, lm, ls, ckpt, mus, scales)
        sym = torch.stack([self._decode_slice(y_strings[ns0 + i], idx_i)
                           for i, idx_i in enumerate(idx.cpu().numpy())])
        x_hat, y_hat = self.prog_reconstruct(sym, mu_s, msups, base)
        return {"x_hat": x_hat, "y_hat": y_hat}

    def _encode_slices(self, sym: torch.Tensor,
                       idx: torch.Tensor) -> List[List[bytes]]:
        """Symbols and CDF indexes [S, B, h, w, c] -> per slice, B
        messages."""
        sym_np, idx_np = sym.cpu().numpy(), idx.cpu().numpy()
        per = sym_np[0, 0].size
        return [self.y_coder.encode_batch(s.reshape(-1), i.reshape(-1),
                                          [per] * s.shape[0])
                for s, i in zip(sym_np, idx_np)]

    def _encode_images(self, sym: torch.Tensor,
                       idx: torch.Tensor) -> List[bytes]:
        """Symbols and CDF indexes [S, B, h, w, c] -> B messages, each
        image's slices one after another."""
        b = sym.shape[1]
        sym_np = sym.transpose(0, 1).reshape(b, -1).cpu().numpy()
        idx_np = idx.transpose(0, 1).reshape(b, -1).cpu().numpy()
        return self.y_coder.encode_batch(sym_np.reshape(-1),
                                         idx_np.reshape(-1),
                                         [sym_np.shape[1]] * b)

    def _decode_slice(self, strings, idx: np.ndarray) -> torch.Tensor:
        """One slice's B messages with host CDF indexes [B, h, w, c] ->
        int32 device symbols of that shape."""
        sym = self.y_coder.decode_batch(strings, idx.reshape(-1),
                                        [idx[0].size] * idx.shape[0])
        return torch.as_tensor(sym.reshape(idx.shape), device=self.device)

    # ---- z coding ----
    def encode_z(self, z_sym: np.ndarray) -> List[bytes]:
        b = z_sym.shape[0]
        idx = np.broadcast_to(np.arange(z_sym.shape[-1], dtype=np.int32),
                              z_sym.shape)
        return self.z_coder.encode_batch(z_sym.reshape(-1),
                                         idx.reshape(-1),
                                         [z_sym[0].size] * b)

    def decode_z(self, strings, spatial) -> np.ndarray:
        b, (h, w), n = len(strings), spatial, self.model.n
        idx = np.broadcast_to(np.arange(n, dtype=np.int32), (b, h, w, n))
        sym = self.z_coder.decode_batch(strings, idx.reshape(-1),
                                        [h * w * n] * b)
        return sym.reshape(b, h, w, n)


def add_time(timing: Optional[Dict[str, float]], key: str, t0: float) -> float:
    """Accumulate the seconds since t0 under key; returns the new t0."""
    t1 = time.perf_counter()
    if timing is not None:
        timing[key] = timing.get(key, 0.0) + (t1 - t0)
    return t1
