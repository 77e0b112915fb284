"""Command-line arguments of the host-loader trainer (``cli.train``) and the
demo (``cli.demo``), flag for flag as the JAX package's ``utils.parser``,
plus ``--device`` (cuda by default, or cpu). ``--num_devices`` and
``--test_before`` are parsed and unused, as in the JAX package."""

from __future__ import annotations

import argparse
from typing import Any, Dict


def parse_train_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("epic_tpu_torch train")
    # architecture (the flagship width)
    p.add_argument("--model", default="pic", choices=["pic", "rem", "cnn"])
    p.add_argument("--N", type=int, default=192)
    p.add_argument("--M", type=int, default=640)
    p.add_argument("--division_dimension", type=int, nargs=2,
                   default=[320, 640])
    p.add_argument("--dim_chunk", type=int, default=32)
    p.add_argument("--multiple_encoder", action="store_true", default=True)
    p.add_argument("--no_multiple_encoder", dest="multiple_encoder",
                   action="store_false")
    p.add_argument("--multiple_decoder", action="store_true", default=True)
    p.add_argument("--no_multiple_decoder", dest="multiple_decoder",
                   action="store_false")
    p.add_argument("--multiple_hyperprior", action="store_true",
                   default=True)
    p.add_argument("--no_multiple_hyperprior", dest="multiple_hyperprior",
                   action="store_false")
    p.add_argument("--support_progressive_slices", type=int, default=5)
    p.add_argument("--delta_encode", action="store_true", default=True)
    p.add_argument("--no_delta_encode", dest="delta_encode",
                   action="store_false")
    p.add_argument("--all_scalable", action="store_true", default=True)
    p.add_argument("--no_all_scalable", dest="all_scalable",
                   action="store_false")
    p.add_argument("--total_mu_rep", action="store_true", default=True)
    p.add_argument("--no_total_mu_rep", dest="total_mu_rep",
                   action="store_false")
    p.add_argument("--mask_policy", default="point-based-std")
    # REM
    p.add_argument("--check_levels", type=float, nargs="+", default=[0.75])
    p.add_argument("--check_levels_np", type=int, nargs="+", default=[24])
    p.add_argument("--mu_std", action="store_true", default=True)
    p.add_argument("--no_mu_std", dest="mu_std", action="store_false")
    p.add_argument("--dimension", default="big", choices=["middle", "big"])
    # training
    p.add_argument("--training_type", default="first_train",
                   choices=["first_train", "refine_gs", "refine_gs_ga",
                            "rems"])
    p.add_argument("--lmbda_list", type=float, nargs="+",
                   default=[0.0055, 0.04])
    p.add_argument("--epochs", type=int, default=600)
    p.add_argument("--steps_per_epoch", type=int, default=1000)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--aux_learning_rate", type=float, default=1e-3)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--valid_batch_size", type=int, default=16)
    p.add_argument("--patch_size", type=int, default=256)
    p.add_argument("--clip_max_norm", type=float, default=1.0)
    p.add_argument("--patience", type=int, default=8)
    p.add_argument("--lr_factor", type=float, default=0.3)
    p.add_argument("--lrp", action="store_true", default=False)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--param_net_widths", type=int, nargs="+",
                   default=[224, 176, 128, 64])
    # data / paths
    p.add_argument("--training_dataset", default="/data/openimages")
    p.add_argument("--test_dataset", default="/data/kodak")
    p.add_argument("--num_images", type=int, default=300000)
    p.add_argument("--num_images_val", type=int, default=816)
    p.add_argument("--save_path", default="./ckpt")
    p.add_argument("--checkpoint", default="none")
    p.add_argument("--checkpoint_base", default="none")
    p.add_argument("--test_before", action="store_true", default=False)
    p.add_argument("--eval_every", type=int, default=2)
    # multi-device: parsed and unused, as in the JAX package (the
    # data-parallel step is parallel.mesh's, driven by its own callers)
    p.add_argument("--num_devices", type=int, default=0,
                   help="0 = all visible devices")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def parse_demo_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("epic_tpu_torch demo")
    p.add_argument("--checkpoint", default="none")
    p.add_argument("--model", default="pic", choices=["pic", "rem", "cnn"])
    p.add_argument("--rems", action="store_true", default=False)
    p.add_argument("--fast_encdec", action="store_true", default=False)
    p.add_argument("--path_image", required=True)
    p.add_argument("--q_levs", type=float, nargs="+",
                   default=[0.01, 0.05, 0.1, 0.25, 0.5, 0.6, 0.7, 0.8, 0.9,
                            1, 2, 3, 4, 4.5, 10])
    p.add_argument("--requested_levels", type=int, nargs="+", default=None)
    p.add_argument("--save_path", default="./demo_out")
    p.add_argument("--save_recon", action="store_true", default=False,
                   help="write per-level reconstruction PNGs to save_path")
    # tiny-model knob for running without a trained checkpoint
    p.add_argument("--tiny", action="store_true", default=False)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def model_config_from_args(args) -> Dict[str, Any]:
    """The model's constructor arguments, as the JAX package's: ``get_model
    (args.model, **cfg)`` builds it."""
    cfg: Dict[str, Any] = dict(
        n=args.N, m=args.M,
        division=tuple(args.division_dimension),
        dim_chunk=args.dim_chunk,
        multiple_encoder=args.multiple_encoder,
        multiple_decoder=args.multiple_decoder,
        multiple_hyperprior=args.multiple_hyperprior,
        support_progressive_slices=args.support_progressive_slices,
        delta_encode=args.delta_encode,
        total_mu_rep=args.total_mu_rep,
        all_scalable=args.all_scalable,
        mask_policy=args.mask_policy,
        param_net_widths=tuple(args.param_net_widths),
    )
    if args.model == "rem":
        cfg.update(check_levels=tuple(args.check_levels),
                   mu_std=args.mu_std, rem_dimension=args.dimension)
    if args.model == "cnn":
        cfg = dict(n=args.N, m=320, dim_chunk=args.dim_chunk,
                   param_net_widths=tuple(args.param_net_widths))
    return cfg
