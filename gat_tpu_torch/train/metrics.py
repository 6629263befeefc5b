"""Training metrics, the twin of `gat_tpu/train/metrics.py` in numpy:
confusion matrix, a classification report with sklearn's text, ASCII
gradient-norm gauges, and training-curve plots (matplotlib is optional:
without it the plots return None)."""
from __future__ import annotations

import math

import numpy as np

__all__ = ["confusion_matrix", "classification_report", "grad_norm_bar",
           "grad_norm_label", "plot_curves"]


def confusion_matrix(y_true, y_pred, num_classes: int | None = None,
                     normalize: bool = False, plot: bool = False,
                     classes=None, out_path=None) -> np.ndarray:
    """Row-normalizable confusion matrix, optionally rendered as a
    heatmap with per-cell annotations."""
    y_true = np.asarray(y_true, int).ravel()
    y_pred = np.asarray(y_pred, int).ravel()
    n = num_classes or int(max(y_true.max(), y_pred.max())) + 1
    cm = np.zeros((n, n), dtype=np.int64)
    np.add.at(cm, (y_true, y_pred), 1)
    if normalize:
        with np.errstate(all="ignore"):
            cm = cm.astype(float) / cm.sum(axis=1, keepdims=True)
            cm = np.nan_to_num(cm)
    if plot:
        _plot_confusion(cm, classes, normalize, out_path)
    return cm


def _get_plt():
    """Headless matplotlib, or None when it is not installed."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError:
        return None


def _plot_confusion(cm, classes, normalize, out_path):
    plt = _get_plt()
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(8, 6))
    im = ax.imshow(cm, cmap="Blues")
    fig.colorbar(im)
    if classes is not None:
        ax.set_xticks(range(len(classes)), classes, rotation=45)
        ax.set_yticks(range(len(classes)), classes)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    ax.set_title("Confusion Matrix")
    if cm.shape[0] <= 20:  # annotate only when readable
        thresh = cm.max() / 2
        for i in range(cm.shape[0]):
            for j in range(cm.shape[1]):
                val = f"{cm[i, j]:.2f}" if normalize else str(int(cm[i, j]))
                ax.text(j, i, val, ha="center", va="center",
                        color="white" if cm[i, j] > thresh else "black")
    fig.tight_layout()
    if out_path is not None:
        fig.savefig(out_path, dpi=100)
    plt.close(fig)


def _divide(num, den) -> np.ndarray:
    """num / den in float64, 0 where den is 0 (zero_division=0)."""
    num = np.asarray(num, np.float64)
    den = np.asarray(den, np.float64).copy()
    mask = den == 0
    den[mask] = 1.0
    out = num / den
    out[mask] = 0.0
    return out


def _prf(tp, pred, true):
    """Precision, recall and F1 as sklearn forms them: F1 from the
    counts, 2·tp / (true + pred)."""
    return (_divide(tp, pred), _divide(tp, true),
            _divide(2.0 * np.asarray(tp, np.float64),
                    np.asarray(true, np.float64) + pred))


def classification_report(y_true, y_pred, target_names=None,
                          digits: int = 4) -> str:
    """Per-class precision/recall/F1 summary over the labels present in
    either array, with the text of sklearn's `classification_report(...,
    labels=present, digits=digits, zero_division=0)`: the class rows,
    then accuracy, macro avg and weighted avg. Empty or short
    `target_names` fall back to the label indices."""
    y_true = np.asarray(y_true, int).ravel()
    y_pred = np.asarray(y_pred, int).ravel()
    present = sorted(set(y_true) | set(y_pred))
    usable = (target_names and present
              and max(present) < len(target_names))
    names = ([str(target_names[i]) for i in present] if usable
             else [str(i) for i in present])
    labels = np.asarray(present, int)
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in labels])
    pred = np.array([np.sum(y_pred == c) for c in labels])
    true = np.array([np.sum(y_true == c) for c in labels])
    p, r, f1 = _prf(tp, pred, true)

    headers = ["precision", "recall", "f1-score", "support"]
    width = max(max(len(n) for n in names), len("weighted avg"), digits)
    report = ("{:>{width}s} " + " {:>9}" * len(headers)).format(
        "", *headers, width=width) + "\n\n"
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    for row in zip(names, p, r, f1, true):
        report += row_fmt.format(*row, width=width, digits=digits)
    report += "\n"
    support = int(np.sum(true))
    acc = _prf(tp.sum(keepdims=True), pred.sum(keepdims=True),
               true.sum(keepdims=True))[2]
    report += ("{:>{width}s} " + " {:>9.{digits}}" * 2
               + " {:>9.{digits}f}" + " {:>9}\n").format(
        "accuracy", "", "", float(acc[0]), support, width=width,
        digits=digits)
    report += row_fmt.format("macro avg", float(np.mean(p)),
                             float(np.mean(r)), float(np.mean(f1)), support,
                             width=width, digits=digits)
    w = true if true.sum() else None
    report += row_fmt.format(
        "weighted avg", *(float(np.average(v, weights=w))
                          for v in (p, r, f1)), support,
        width=width, digits=digits)
    return report


def grad_norm_label(norm: float) -> str:
    """Qualitative gradient-norm gauge."""
    if norm > 20:
        return "██████  exploding"
    if norm > 1:
        return "▅▅▅▅▁  high"
    if norm > 0.1:
        return "▃▃▂▁▁  healthy"
    if norm > 0.001:
        return "▁▁▁▁▁  low"
    return ".....  vanishing"


def grad_norm_bar(norm: float) -> str:
    """Log-scaled 0-5 bar."""
    level = int(min(5, max(0, math.log10(norm + 1e-6) + 3)))
    return "█" * level + " " * (5 - level)


def plot_curves(histories: dict[str, list[float]], title: str = "Curves",
                out_path=None, show: bool = False):
    """Training/validation curve plot. Writes to out_path when given;
    returns the figure, or None without matplotlib."""
    plt = _get_plt()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(8, 4))
    for label, ys in histories.items():
        ax.plot(np.arange(len(ys)), ys, label=label)
    ax.set_title(title)
    ax.legend()
    ax.grid(alpha=0.3)
    if out_path is not None:
        fig.savefig(out_path, dpi=100, bbox_inches="tight")
    if show:
        plt.show()
    plt.close(fig)
    return fig
