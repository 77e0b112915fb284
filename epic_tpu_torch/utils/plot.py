"""Rate-distortion curves with the published anchors (matplotlib)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence


def plot_rate_distortion(results: Dict[str, Dict[str, Sequence[float]]],
                         out_path: str,
                         title: str = "Kodak rate-distortion",
                         include_anchors: bool = True) -> Optional[str]:
    """results: {label: {"bpp": [...], "psnr": [...]}}. Writes a PNG and
    returns its path, or returns None when matplotlib is not installed (as
    on a machine with no plotting packages)."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    if include_anchors:
        from .comparison import load_anchors

        for name, a in load_anchors().items():
            if name == "train_fallback_base":
                continue
            ax.plot(a["bpp"], a["psnr"], "--", alpha=0.6, label=name)
    for label, r in results.items():
        ax.plot(r["bpp"], r["psnr"], "-o", markersize=4, label=label)
    ax.set_xlabel("bpp")
    ax.set_ylabel("PSNR (dB)")
    ax.set_title(title)
    ax.grid(alpha=0.3)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    plt.close(fig)
    return out_path
