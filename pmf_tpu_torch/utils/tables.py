"""Plain-text metric tables of the eval report (counterpart of
`pmf_tpu/utils/tables.py`)."""
from __future__ import annotations

import numpy as np


def format_table(headers, rows) -> str:
    cols = [len(str(h)) for h in headers]
    srows = [[str(c) for c in r] for r in rows]
    for r in srows:
        for i, c in enumerate(r):
            cols[i] = max(cols[i], len(c))
    sep = "+" + "+".join("-" * (w + 2) for w in cols) + "+"
    out = [sep,
           "|" + "|".join(f" {str(h):<{w}} " for h, w in zip(headers, cols)) + "|",
           sep]
    for r in srows:
        out.append("|" + "|".join(f" {c:<{w}} " for c, w in zip(r, cols)) + "|")
    out.append(sep)
    return "\n".join(out)


def per_class_report(class_names: dict, iou, acc, recall, include) -> str:
    rows = []
    for i in sorted(class_names):
        flag = "" if i in include else " (ignored)"
        rows.append([i, f"{class_names[i]}{flag}", f"{iou[i] * 100:.2f}",
                     f"{acc[i] * 100:.2f}", f"{recall[i] * 100:.2f}"])
    return format_table(["id", "class", "IoU%", "Acc%", "Recall%"], rows)


def latex_row(iou, include) -> str:
    """mIoU + per-class IoU as a LaTeX table row."""
    vals = [iou[i] * 100 for i in include]
    mean = sum(vals) / max(len(vals), 1)
    return " & ".join([f"{mean:.1f}"] + [f"{v:.1f}" for v in vals]) + r" \\"


def matrix_report(conf, class_names: dict, normalize: str | None = None) -> str:
    """The confusion matrix (rows = pred, cols = gt), optionally
    row-normalized ('acc') or column-normalized ('recall')."""
    conf = np.asarray(conf, dtype=np.float64)
    if normalize == "acc":
        conf = conf / np.maximum(conf.sum(axis=1, keepdims=True), 1e-15)
    elif normalize == "recall":
        conf = conf / np.maximum(conf.sum(axis=0, keepdims=True), 1e-15)
    fmt = (lambda v: f"{v:.2f}") if normalize else (lambda v: f"{int(v)}")
    rows = []
    for i in range(conf.shape[0]):
        name = class_names.get(i, str(i))
        rows.append([f"{i}:{name[:12]}"] + [fmt(v) for v in conf[i]])
    return format_table(["pred\\gt"] + [str(i) for i in range(conf.shape[0])], rows)
