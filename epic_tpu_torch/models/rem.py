"""VarianceMaskingPICREM: PIC + Rate Enhancement Modules.

REMs refine the progressive entropy parameters (mu, sigma) of each slice
from an already-decoded checkpoint-quality latent, one REM bank per
quality bracket between the ``check_levels``. Each bank holds the
per-slice modules stacked over the slice axis, as the JAX package's
checkpoints store ``post_latent_{r}``.

Three refinements, each as the JAX package computes it:

- ``refine_prog_params_all`` (one quality, every slice): the support chain
  stays unrefined; only the masking and coding at that quality use the
  refined params. Checkpoint extraction uses it.
- ``refine_prog_params`` (one quality, one slice): the same refinement
  inside the interleaved chain of ``all_scalable=False``, whose support is
  the decoded progressive slices.
- ``rem_chain_params`` (the single-bitstream codec): inside the slice
  chain, checkpoint j refines (mu, scale) with the bank of
  ``check_levels[j]`` conditioned on checkpoint j's latent. j = 0 is a
  no-op (the JAX package returns early at quality <= check_levels[0]), so
  one checkpoint gives the plain chain. The support chains off the
  unrefined mu_total and the refined scale.

Its training forward is single-quality (``forward`` is
``forward_single_quality``, whose REM hook is ``refine_prog_params_all``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..ops.masking import prog_mask, variance_mask
from ..ops.rem import LatentRateReduction, StackedConv
from .pic import VarianceMaskingPIC


class VarianceMaskingPICREM(VarianceMaskingPIC):
    def __init__(self, check_levels: Sequence[float] = (0.01, 0.25, 1.75),
                 mu_std: bool = True, rem_dimension: str = "big", **kwargs):
        super().__init__(**kwargs)
        self.check_levels = tuple(float(c) for c in check_levels)
        self.mu_std = mu_std
        self.rem_dimension = rem_dimension
        for r in range(self.num_rems):
            setattr(self, f"post_latent_{r}", LatentRateReduction(
                self.ns0, self.dim_chunk, mu_std, rem_dimension))

    def forward(self, x: torch.Tensor, quality: float = 0.0,
                training: bool = True, checkpoint_ref=None,
                generator: torch.Generator = None):
        """The single-quality forward (REM training)."""
        return self.forward_single_quality(x, quality, training,
                                           checkpoint_ref, generator)

    @property
    def num_rems(self) -> int:
        return len(self.check_levels)

    def bank(self, r: int) -> LatentRateReduction:
        return getattr(self, f"post_latent_{r}")

    def find_check_quality(self, quality: float) -> Tuple[float, float, int]:
        """Bracket a quality between checkpoint levels: (quality_ref,
        quality_post, rem_index)."""
        c = self.check_levels
        if quality <= c[0]:
            return 0.0, 0.0, -1
        for j in range(len(c) - 1):
            if c[j] < quality <= c[j + 1]:
                return c[j], c[j + 1], j
        return c[-1], 10.0, len(c) - 1

    def rem_bank_index(self, quality: float) -> int:
        """The bank that refines at this quality: j for c_j < q <= c_{j+1},
        the last bank above the last level."""
        c = self.check_levels
        for j in range(len(c) - 1):
            if c[j] < quality <= c[j + 1]:
                return j
        return len(c) - 1

    def _blocked(self, y: torch.Tensor, n: int) -> torch.Tensor:
        """Channel slices [0, n) of y as a stacked [n, B, h, w, c]."""
        c = self.dim_chunk
        b, h, w = y.shape[:3]
        return y[..., :n * c].reshape(b, h, w, n, c).permute(3, 0, 1, 2, 4)

    def _split(self, out: torch.Tensor, mu: torch.Tensor):
        if self.mu_std:
            return torch.chunk(out, 2, dim=-1)
        return mu, out

    def refine_prog_params_all(self, quality: float, mus: torch.Tensor,
                               scales: torch.Tensor, checkpoint_ref,
                               mus_b: torch.Tensor, scales_b: torch.Tensor):
        """Refine every progressive slice at one quality. mus / scales:
        stacked [S, B, h, w, c] unrefined chain outputs; mus_b / scales_b:
        stacked base-slice params. Returns (mus, scales)."""
        if checkpoint_ref is None or quality <= self.check_levels[0]:
            return mus, scales
        nprog = self.ns1 - self.ns0
        ckpt_s = self._blocked(checkpoint_ref, nprog)
        params_base = torch.cat([mus_b[:nprog], scales_b[:nprog]], dim=-1)
        params_prog = (torch.cat([mus, scales], dim=-1) if self.mu_std
                       else scales)
        att = prog_mask(scales, quality, self.mask_policy)
        if self.mu_std:
            att = torch.cat([att, att], dim=-1)
        out = self.bank(self.rem_bank_index(quality)).apply_all(
            ckpt_s, params_base, params_prog, att)
        return self._split(out, mus)

    def refine_prog_params(self, i: int, quality: float, mu: torch.Tensor,
                           scale: torch.Tensor, checkpoint_ref,
                           mu_base_i: torch.Tensor, std_base_i: torch.Tensor):
        """Refine progressive slice i at one quality from its checkpoint
        slice (bank ``rem_bank_index(quality)``, attention mask the variance
        mask of the unrefined scale). No refinement at or below the first
        check level. Returns (mu, scale)."""
        if checkpoint_ref is None or quality <= self.check_levels[0]:
            return mu, scale
        c = self.dim_chunk
        params_base = torch.cat([mu_base_i, std_base_i], dim=-1)
        params_prog = (torch.cat([mu, scale], dim=-1) if self.mu_std
                       else scale)
        att = variance_mask(scale, quality, self.mask_policy)
        if self.mu_std:
            att = torch.cat([att, att], dim=-1)
        out = self.bank(self.rem_bank_index(quality)).apply_slice(
            i, checkpoint_ref[..., i * c:(i + 1) * c], params_base,
            params_prog, att)
        return self._split(out, mu)

    def rem_chain_params(self, base_slices: Sequence[torch.Tensor],
                         lm_e: torch.Tensor, ls_e: torch.Tensor,
                         ckpts: Sequence[torch.Tensor],
                         mus_b: Sequence[torch.Tensor],
                         scales_b: Sequence[torch.Tensor]):
        """Progressive params with the chained REM refinement of the
        single-bitstream codec. Returns stacked (mus, scales,
        mean_supports), each [S, ...]."""
        if len(ckpts) <= 1:
            return self.prog_param_chain(base_slices, lm_e, ls_e)
        nprog = self.ns1 - self.ns0
        ckpt_s = [self._blocked(ck, nprog) for ck in ckpts]
        mus, muts, scales, msups = [], [], [], []
        for i in range(nprog):
            mu, mut, scale, mean_support = self.prog_slice_params(
                lm_e, ls_e, base_slices[i], muts, scales, i)
            params_base = torch.cat([mus_b[i], scales_b[i]], dim=-1)
            for j in range(1, len(ckpts)):  # j = 0: no-op
                q_j = self.check_levels[j]
                att = variance_mask(scale, q_j, self.mask_policy)
                if self.mu_std:
                    att = torch.cat([att, att], dim=-1)
                params_prog = (torch.cat([mu, scale], dim=-1) if self.mu_std
                               else scale)
                out = self.bank(self.rem_bank_index(q_j)).apply_slice(
                    i, ckpt_s[j][i], params_base, params_prog, att)
                mu, scale = self._split(out, mu)
            for acc, t in zip((mus, muts, scales, msups),
                              (mu, mut, scale, mean_support)):
                acc.append(t)
        return torch.stack(mus), torch.stack(scales), torch.stack(msups)

    @torch.no_grad()
    def init_weights(self, seed: int) -> "VarianceMaskingPICREM":
        """The PIC weights from ``seed`` (as ``VarianceMaskingPIC``), then
        the REM banks' from ``seed + 1``: gain-1 fan-in normal convs per
        slice, zero biases."""
        super().init_weights(seed)
        gen = torch.Generator().manual_seed(seed + 1)
        for mod in self.modules():
            if isinstance(mod, StackedConv):
                mod.init_(gen)
        return self
