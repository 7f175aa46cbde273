"""Training-stats plots.

The twin of the JAX package's ``utils/plots.py`` (reference:
acai_omr/utils/utils.py:231-305, 372-384): loss / LR / tf-prob / tau curves
from the stats CSVs that :class:`.metrics.MetricsWriter` writes, and an LR
schedule preview. matplotlib and pandas are imported inside the functions
and are needed only here (the GPU machine carries neither: there a call
raises ImportError naming the package).
"""

from __future__ import annotations

from pathlib import Path

from .visualize import pyplot


def _pd():
    try:
        import pandas as pd
    except ImportError as e:
        raise ImportError("the plots read their CSV with pandas, which is "
                          "not installed") from e
    return pd


def _fig(title, ylabel):
    fig, ax = pyplot().subplots(figsize=(12, 8))
    ax.set_title(title)
    ax.set_xlabel("Step")
    ax.set_ylabel(ylabel)
    ax.grid(True)
    return fig, ax


def plot_stats_csv(csv_path, out_dir, tags=None) -> list:
    """One PNG per scalar tag of a MetricsWriter CSV (any logged tag becomes
    a curve: graph_losses / graph_lrs / graph_tf_probs / graph_taus,
    utils.py:242-305). Returns the files written."""
    pd = _pd()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    df = pd.read_csv(csv_path)
    written = []
    for tag in sorted(df["tag"].unique()):
        if tags and tag not in tags:
            continue
        sub = df[df["tag"] == tag].sort_values("step")
        fig, ax = _fig(tag, tag.rsplit("/", 1)[-1])
        ax.plot(sub["step"], sub["value"])
        name = tag.replace("/", "_") + ".png"
        fig.savefig(out_dir / name)
        pyplot().close(fig)
        written.append(out_dir / name)
    return written


def plot_losses(csv_path, out_path, train_tag="epoch/train_loss",
                val_tag="epoch/val_loss"):
    """Train and validation curves on one figure (graph_losses)."""
    df = _pd().read_csv(csv_path)
    fig, ax = _fig("Training stats", "Average loss")
    for tag, label, color in ((train_tag, "Train loss", "blue"),
                              (val_tag, "Validation loss", "red")):
        sub = df[df["tag"] == tag].sort_values("step")
        if len(sub):
            ax.plot(sub["step"], sub["value"], label=label, color=color)
    ax.legend()
    fig.savefig(out_path)
    pyplot().close(fig)
    return out_path


def plot_lr_schedule(schedule, num_steps, out_path):
    """Preview a step -> lr schedule function (plot_lr_schedule,
    utils.py:372-384)."""
    import numpy as np

    steps = np.arange(num_steps)
    lrs = [float(schedule(s)) for s in steps]
    fig, ax = _fig("Learning rate over time using scheduler", "Learning rate")
    ax.plot(steps, lrs)
    fig.savefig(out_path)
    pyplot().close(fig)
    return out_path
