"""Evaluation: segmentation metrics and report artifacts.

Port of ``pylc_tpu/evaluate.py`` (plain numpy and sklearn on the host; no
tensor work).  Metric parity with reference utils/metrics.py:24-87 and
utils/evaluate.py:25-284: weighted F1, weighted Jaccard (IoU), MCC,
row-normalized confusion matrix, per-class classification report; saved
artifacts keep the reference's names and formats (colour mask PNG via
RGB->BGR, ``<fid>_eval.json``, ``<fid>_cmap.pdf`` + ``.npy``, optional
LaTeX table, optional raw logits).  sklearn, matplotlib and cv2 are
imported inside the functions that use them.

As in the JAX package, class coverage is handled by passing the full
label set to sklearn; ``seed_class_pixels=True`` reproduces the
reference, which force-writes each class index into the first n_classes
pixels of y_true/y_pred (utils/evaluate.py:171-174).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from pylc_tpu_torch import native
from pylc_tpu_torch.config import Config
from pylc_tpu_torch.utils.imageio import get_image


class Metrics:
    """sklearn metric bundle for class-map pairs."""

    def __init__(self):
        self.results: Dict = {}
        self.cmatrix: Optional[np.ndarray] = None

    def compute(self, y_true: np.ndarray, y_pred: np.ndarray,
                labels: List[str]) -> Dict:
        from sklearn.metrics import (classification_report,
                                     confusion_matrix, f1_score,
                                     jaccard_score, matthews_corrcoef)
        label_ids = list(range(len(labels)))
        self.results["f1"] = float(f1_score(
            y_true, y_pred, average="weighted", zero_division=0))
        self.results["iou"] = float(jaccard_score(
            y_true, y_pred, labels=label_ids, average="weighted",
            zero_division=0))
        self.results["mcc"] = float(matthews_corrcoef(y_true, y_pred))
        self.cmatrix = confusion_matrix(
            y_true, y_pred, labels=label_ids, normalize="true")
        self.results["report"] = classification_report(
            y_true, y_pred, labels=label_ids, target_names=labels,
            output_dict=True, zero_division=0)
        return self.results


class Evaluator:
    """Per-image and aggregate evaluation with artifact output."""

    def __init__(self, cfg: Config, output_dir: Optional[str] = None,
                 keep_aggregate: bool = True):
        """keep_aggregate: buffer every image's encoded class maps for
        aggregate metrics.  Callers that never aggregate should pass
        False — the buffers are ~30-40 MB per 15-20 MP photo and a
        100-photo run would otherwise hold gigabytes for no output."""
        self.cfg = cfg
        self.keep_aggregate = keep_aggregate
        self.metrics = Metrics()
        base = output_dir or os.path.join(cfg.output_dir, cfg.id or "model")
        self.masks_dir = os.path.join(base, "masks")
        self.logits_dir = os.path.join(base, "logits")
        self.metrics_dir = os.path.join(base, "metrics")
        for d in (self.masks_dir, self.logits_dir, self.metrics_dir):
            os.makedirs(d, exist_ok=True)
        self.fid: Optional[str] = None
        self.mask_pred: Optional[np.ndarray] = None
        self.y_true: Optional[np.ndarray] = None
        self.y_pred: Optional[np.ndarray] = None
        self.y_true_aggregate: List[np.ndarray] = []
        self.y_pred_aggregate: List[np.ndarray] = []

    # ------------------------------------------------------------------ #

    def load(self, mask_pred_rgb: np.ndarray, fid: str,
             mask_true_path: Optional[str] = None,
             scale: Optional[float] = None):
        """Load a predicted RGB mask (+ optional ground truth path)."""
        import cv2

        self.fid = fid
        self.mask_pred = mask_pred_rgb
        if mask_true_path:
            mask_true, _, _, _, _ = get_image(
                mask_true_path, ch=3, scale=scale,
                tile_size=self.cfg.tile_size,
                interpolate=cv2.INTER_NEAREST)
            if mask_true.shape[:2] != mask_pred_rgb.shape[:2]:
                raise ValueError(
                    f"Ground truth dims {mask_true.shape[:2]} do not match "
                    f"predicted dims {mask_pred_rgb.shape[:2]}.")
            # encoded on the host (csrc/host_lut.cpp): these are full
            # 10-20 MP masks and the device is busy with inference
            pal = np.asarray(self.cfg.palette_rgb, np.uint8)
            self.y_pred = native.class_encode(mask_pred_rgb, pal).ravel()
            self.y_true = native.class_encode(mask_true, pal).ravel()
            if self.keep_aggregate:
                self.y_true_aggregate.append(self.y_true)
                self.y_pred_aggregate.append(self.y_pred)
        return self

    def evaluate(self, aggregate: bool = False,
                 seed_class_pixels: bool = False):
        if aggregate:
            self.fid = "aggregate_metrics"
            if not self.y_true_aggregate:
                raise ValueError("Aggregate evaluation failed. Data buffer "
                                 "is empty.")
            self.y_true = np.concatenate(self.y_true_aggregate)
            self.y_pred = np.concatenate(self.y_pred_aggregate)
        if seed_class_pixels:  # reference quirk (utils/evaluate.py:171-174)
            # Seed copies: self.y_true/y_pred are the same ndarray objects
            # appended to y_*_aggregate in load(), so in-place seeding would
            # leak the forced pixels into a later evaluate(aggregate=True).
            self.y_true = self.y_true.copy()
            self.y_pred = self.y_pred.copy()
            for idx in range(len(self.cfg.class_codes)):
                self.y_true[idx] = idx
                self.y_pred[idx] = idx
        self.metrics.compute(self.y_true, self.y_pred,
                             list(self.cfg.class_codes))
        return self

    def reset(self):
        self.fid = None
        self.mask_pred = None
        self.y_true = None
        self.y_pred = None
        return self

    # ---------------- artifacts --------------------------------------- #

    def save_image(self) -> str:
        import cv2
        path = os.path.join(self.masks_dir, self.fid + ".png")
        cv2.imwrite(path, cv2.cvtColor(self.mask_pred, cv2.COLOR_RGB2BGR))
        return path

    def save_metrics(self):
        mpath = os.path.join(self.metrics_dir, self.fid + "_eval.json")
        with open(mpath, "w") as f:
            json.dump(self.metrics.results, f, indent=4)
        cpath = os.path.join(self.metrics_dir, self.fid + "_cmap.npy")
        np.save(cpath, self.metrics.cmatrix)
        pdf = self._save_cmap_pdf()
        return mpath, pdf, cpath

    def _save_cmap_pdf(self) -> Optional[str]:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots(figsize=(8, 7))
            im = ax.imshow(self.metrics.cmatrix, vmin=0.0, vmax=1.0,
                           cmap="viridis")
            labels = list(self.cfg.class_codes)
            ax.set_xticks(range(len(labels)), labels, rotation=45)
            ax.set_yticks(range(len(labels)), labels)
            for i in range(len(labels)):
                for j in range(len(labels)):
                    v = self.metrics.cmatrix[i, j]
                    if v >= 0.01:
                        ax.text(j, i, f"{v:.1g}", ha="center", va="center",
                                color="w" if v < 0.6 else "k", fontsize=7)
            ax.set_ylabel("Ground-truth")
            ax.set_xlabel("Predicted")
            fig.colorbar(im)
            path = os.path.join(self.metrics_dir, self.fid + "_cmap.pdf")
            fig.savefig(path, format="pdf", dpi=400, bbox_inches="tight")
            plt.close(fig)
            return path
        except Exception:
            return None

    def save_logits(self, logits: np.ndarray) -> str:
        path = os.path.join(self.logits_dir, self.fid + "_output.npz")
        np.savez_compressed(path, logits=np.asarray(logits))
        return path

    def save_tex(self) -> str:
        path = os.path.join(self.metrics_dir, self.fid + "_metrics.tex")
        with open(path, "w") as f:
            f.write(report_to_tex(self.metrics.results.get("report", {}),
                                  title=self.fid,
                                  model_id=self.cfg.id or "",
                                  summary=self.metrics.results))
        return path


def report_to_tex(report: Dict, title: str = "", model_id: str = "",
                  summary: Optional[Dict] = None) -> str:
    """Classification-report dict -> LaTeX table.

    Full reference utils/tex.py:20-100 capability: per-class
    precision/recall/F1/support rows, macro and weighted averages
    separated below a rule, support shown as a fraction of total
    pixels, and a footer carrying pixel accuracy plus the aggregate
    F1 / wIoU / MCC scores and total pixel count (``summary`` is the
    Metrics results dict).  Layout is booktabs instead of \\hline
    stacks; information content matches."""
    summary = summary or {}
    total = report.get("macro avg", {}).get("support") or sum(
        int(v.get("support", 0)) for k, v in report.items()
        if isinstance(v, dict) and not k.endswith("avg")) or 1
    avg_names = {"macro avg": "cAvg", "weighted avg": "wAvg"}

    def row(name, vals):
        frac = float(vals.get("support", 0)) / float(total)
        return (f"  {name} & {vals.get('precision', 0):.3f} & "
                f"{vals.get('recall', 0):.3f} & "
                f"{vals.get('f1-score', 0):.3f} & {frac:.3f} \\\\")

    classes = [row(k, v) for k, v in report.items()
               if isinstance(v, dict) and k not in avg_names]
    avgs = [row(short, report[k]) for k, short in avg_names.items()
            if isinstance(report.get(k), dict)]
    footer = []
    acc = report.get("accuracy")
    if acc is not None:
        footer.append("  \\multicolumn{2}{l}{\\textbf{Pixel Accuracy:}} & "
                      f"{float(acc):.3f} & & \\\\")
    for key, label in (("f1", "F1 Score"), ("iou", "wIoU"), ("mcc", "MCC")):
        if key in summary:
            footer.append(f"  \\multicolumn{{2}}{{l}}{{\\textbf{{{label}:}}"
                          f"}} & {float(summary[key]):.3f} & & \\\\")
    footer.append("  \\multicolumn{2}{l}{\\textbf{Total Pixels:}} & "
                  f"{int(total)} & & \\\\")
    caption = title + (f" (Model: {model_id})" if model_id else "")
    parts = [
        "\\begin{table}[ht]\n\\centering",
        f"\\caption{{{caption}}}",
        f"\\label{{tab:class_report_{title}}}",
        "\\small\n\\begin{tabular}{lrrrr}\n\\toprule",
        "Class & Precision & Recall & F1 & Support \\\\\n\\midrule",
        "\n".join(classes),
    ]
    if avgs:
        parts += ["\\midrule", "\n".join(avgs)]
    parts += ["\\bottomrule", "\n".join(footer),
              "\\end{tabular}\n\\end{table}\n"]
    return "\n".join(parts)
