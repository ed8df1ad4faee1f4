"""Detection evaluation: VOC-2007 11-point AP + AIoU + diagnostics.

Counterpart of detection_3d_tpu/evaluation/detection_eval.py (reference
data3d/evaluation/suncg/suncg_eval.py):
  * per (example, class): IoU3D with eval thickness augmentation,
    criterion=-1 (suncg_eval.py:806-812); per-pred best gt (argmax over
    gt), below-threshold -> unmatched; preds sorted by score, first match
    per gt = TP, rest FP (suncg_eval.py:834-845);
  * AP = VOC-07 11-point (use_07_metric=True, suncg_eval.py:919-946);
    class 0 slot reports the foreground mean;
  * AIoU per class = mean IoU of "successful" detections: for each gt
    with matches, its highest-score pred, kept when score >= 0.5 and
    iou > thresh (parse_pred_for_each_gt, suncg_eval.py:383-500);
  * missed / multi-pred gt diagnostics.

Each (example, class) IoU matrix is one ``ops/rotated_iou.boxes_iou_3d``
call on ``device``: kernel C on the card, its plain version on the CPU.
The matching, the curves, AP and AIoU are numpy float64 on the host.
"""

from __future__ import annotations

import dataclasses
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from detection_3d_tpu_torch.ops.rotated_iou import boxes_iou_3d
from detection_3d_tpu_torch.utils.device import resolve_device


def voc_ap_07(prec, rec):
    """VOC-2007 11-point AP."""
    ap = 0.0
    for t in np.arange(0.0, 1.1, 0.1):
        mask = rec >= t
        p = np.max(np.nan_to_num(prec)[mask]) if mask.sum() else 0.0
        ap += p / 11
    return ap


def match_predictions_to_gt(iou: np.ndarray, iou_thresh: float):
    """Greedy matching for ONE (example, class) — suncg_eval.py:815-845.

    Args:
      iou: (n_gt, n_pred) with predictions in score-DESCENDING order.
    Returns:
      match: (n_pred,) int8 — 1 TP (first pred per gt in score order),
        0 FP;
      best_iou: (n_pred,) max IoU per pred over all gts (recorded even
        for unmatched preds — feeds the curve's iou column);
      gt_index: (n_pred,) matched gt or -1.
    """
    gt_index = iou.argmax(axis=0)
    best_iou = iou.max(axis=0)
    gt_index = np.where(best_iou < iou_thresh, -1, gt_index)
    selec = np.zeros(iou.shape[0], bool)
    match = np.zeros(iou.shape[1], np.int8)
    for pi in range(len(gt_index)):
        gi = gt_index[pi]
        if gi >= 0:
            match[pi] = 0 if selec[gi] else 1
            selec[gi] = True
    return match, best_iou, gt_index


def accumulate_prec_rec(scores, match, ious, n_pos: int):
    """Pool per-example matches of one class into global curves
    (suncg_eval.py:854-885): sort by score desc, cumulative TP/FP.

    Returns (prec, rec, scores_sorted, ious_sorted)."""
    scores = np.asarray(scores, np.float64)
    match = np.asarray(match)
    ious = np.asarray(ious, np.float64)
    order = np.argsort(-scores, kind="stable")
    scores_s = scores[order]
    match_s = match[order]
    ious_s = ious[order]
    tp = np.cumsum(match_s == 1)
    fp = np.cumsum(match_s == 0)
    prec = tp / (tp + fp)
    rec = tp / n_pos if n_pos > 0 else tp * np.nan
    return prec, rec, scores_s, ious_s


@dataclasses.dataclass
class DetectionEvalResult:
    ap: np.ndarray            # (num_classes,) — slot 0 = mean over fg
    aiou: np.ndarray          # (num_classes,) — slot 0 = mean over fg
    n_gt: np.ndarray          # (num_classes,) gt counts
    missed_rate: np.ndarray   # per-class missed-gt fraction
    multi_rate: np.ndarray    # per-class multi-pred-gt fraction
    class_names: Sequence[str]
    # per-class pooled curves, sorted by score desc: dict label ->
    # {"prec", "rec", "score", "iou", "match"}
    curves: Optional[Dict[int, Dict[str, np.ndarray]]] = None

    def summary(self) -> str:
        lines = ["class      AP      AIoU    #gt   missed  multi"]
        for i, n in enumerate(self.class_names):
            name = "mean" if i == 0 else n
            lines.append(
                f"{name:<10s} {self.ap[i]:.4f}  {self.aiou[i]:.4f}  "
                f"{int(self.n_gt[i]):>4d}  {self.missed_rate[i]:.3f}  "
                f"{self.multi_rate[i]:.3f}")
        return "\n".join(lines)

    # -- performance_str-style detail table (suncg_eval.py:213-332) --------
    def _at_score(self, c, thr):
        """(prec, rec) of the operating point score >= thr."""
        m = c["score"] >= thr
        if not m.any():
            return np.nan, 0.0
        i = int(m.sum()) - 1               # last index with score >= thr
        return float(c["prec"][i]), float(c["rec"][i])

    def _at_recall(self, c, r):
        """(prec, score) at the first point reaching recall >= r."""
        m = c["rec"] >= r
        if not m.any():
            return 0.0, np.nan
        i = int(np.argmax(m))
        return float(c["prec"][i]), float(c["score"][i])

    def detail_table(self) -> str:
        """Per-class operating-point table (the reference's
        performance_str, suncg_eval.py:213-332): precision / recall at
        score thresholds 0.5 / 0.7, precision + score at recall 0.7 /
        0.9, matched-IoU and score statistics, multi-pred and gt-count
        diagnostics. Column 0 aggregates foreground."""
        n = len(self.class_names)
        rows: Dict[str, list] = {k: [] for k in (
            "AP", "AIoU", "st5 prec", "st5 rec", "st7 prec", "st7 rec",
            "r7p", "r9p", "r7s", "r9s", "iou mean", "iou std", "iou min",
            "score mean", "score std", "score min", "missed gt",
            "multi gt", "gt num")}
        for i in range(1, n):
            c = (self.curves or {}).get(i)
            if c is None or c["score"].size == 0:
                for k in rows:
                    rows[k].append(np.nan)
                rows["gt num"][-1] = float(self.n_gt[i])
                rows["AP"][-1] = self.ap[i]
                rows["AIoU"][-1] = self.aiou[i]
                continue
            p5, r5 = self._at_score(c, 0.5)
            p7, r7 = self._at_score(c, 0.7)
            rp7, rs7 = self._at_recall(c, 0.7)
            rp9, rs9 = self._at_recall(c, 0.9)
            tp_iou = c["iou"][c["match"] == 1]
            rows["AP"].append(self.ap[i])
            rows["AIoU"].append(self.aiou[i])
            rows["st5 prec"].append(p5)
            rows["st5 rec"].append(r5)
            rows["st7 prec"].append(p7)
            rows["st7 rec"].append(r7)
            rows["r7p"].append(rp7)
            rows["r9p"].append(rp9)
            rows["r7s"].append(rs7)
            rows["r9s"].append(rs9)
            rows["iou mean"].append(tp_iou.mean() if tp_iou.size else np.nan)
            rows["iou std"].append(tp_iou.std() if tp_iou.size else np.nan)
            rows["iou min"].append(tp_iou.min() if tp_iou.size else np.nan)
            rows["score mean"].append(c["score"].mean())
            rows["score std"].append(c["score"].std())
            rows["score min"].append(c["score"].min())
            rows["missed gt"].append(self.missed_rate[i])
            rows["multi gt"].append(self.multi_rate[i])
            rows["gt num"].append(float(self.n_gt[i]))
        names = ["mean"] + [str(x) for x in self.class_names[1:]]
        out = [f"{'class':<12}" + "  ".join(f"{c:<9}" for c in names)]
        with np.errstate(invalid="ignore"):
            for k, vals in rows.items():
                vals = np.asarray(vals, np.float64)
                lead = np.nanmean(vals) if np.isfinite(vals).any() \
                    else np.nan
                allv = [lead] + list(vals)
                if k == "gt num":
                    cells = "  ".join(f"{(0 if np.isnan(v) else int(v)):<9d}"
                                      for v in allv)
                else:
                    cells = "  ".join(f"{v * 100:<9.2f}" for v in allv)
                out.append(f"{k:<12}" + cells)
        return "\n".join(out)

    def plot_pr_curves(self, path: str):
        """PR-curve figure, one line per class (the reference draws PR
        PNGs in suncg_eval.py:579-688). Returns path, or None when
        matplotlib is unavailable."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return None
        fig, ax = plt.subplots(figsize=(6, 5))
        for i in range(1, len(self.class_names)):
            c = (self.curves or {}).get(i)
            if c is None or c["rec"].size == 0:
                continue
            ax.plot(c["rec"], c["prec"],
                    label=f"{self.class_names[i]} (AP {self.ap[i]:.2f})")
        ax.set_xlabel("recall")
        ax.set_ylabel("precision")
        ax.set_xlim(0, 1.0)
        ax.set_ylim(0, 1.05)
        ax.grid(True, alpha=0.3)
        ax.legend(loc="lower left", fontsize=8)
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path


def eval_aug_thickness(cfg) -> Dict[str, float]:
    """The evaluation's minimum box sizes from ``cfg.test``."""
    return {"target_Y": cfg.test.eval_aug_thickness_y_tar_anc[0],
            "anchor_Y": cfg.test.eval_aug_thickness_y_tar_anc[1],
            "target_Z": cfg.test.eval_aug_thickness_z_tar_anc[0],
            "anchor_Z": cfg.test.eval_aug_thickness_z_tar_anc[1]}


def evaluate_detections(predictions: List[Dict], groundtruths: List[Dict],
                        num_classes: int, iou_thresh: float,
                        eval_aug_thickness: Optional[Dict] = None,
                        class_names: Optional[Sequence[str]] = None,
                        score_thres: float = 0.5,
                        device="cuda") -> DetectionEvalResult:
    """Args:
      predictions: per example {boxes (N,7) yx_zb, scores (N,), labels (N,)}
        (numpy, already masked to valid rows);
      groundtruths: per example {boxes (M,7), labels (M,)};
      num_classes: including background;
      iou_thresh: TP threshold;
      eval_aug_thickness: dict target_Y/target_Z/anchor_Y/anchor_Z (None:
        sizes clamped at 0, as the JAX evaluator does);
      device: where the IoU matrices are computed (the card unless the
        caller asks for the CPU).
    """
    dev = resolve_device(device)
    aug = eval_aug_thickness or {"target_Y": 0.0, "target_Z": 0.0,
                                 "anchor_Y": 0.0, "anchor_Z": 0.0}
    n_pos = np.zeros(num_classes, np.int64)
    score_acc = defaultdict(list)
    match_acc = defaultdict(list)
    iou_acc = defaultdict(list)       # best IoU per pred (curve column)
    good_ious = defaultdict(list)     # AIoU source
    missed = np.zeros(num_classes, np.int64)
    multi = np.zeros(num_classes, np.int64)

    for pred, gt in zip(predictions, groundtruths):
        pb, ps, pl = (np.asarray(pred["boxes"]), np.asarray(pred["scores"]),
                      np.asarray(pred["labels"]))
        gb, gl = np.asarray(gt["boxes"]), np.asarray(gt["labels"])
        for l in range(1, num_classes):
            pm = pl == l
            gm = gl == l
            n_pos[l] += gm.sum()
            if pm.sum() == 0:
                missed[l] += gm.sum()
                continue
            order = np.argsort(-ps[pm], kind="stable")
            boxes_l = pb[pm][order]
            scores_l = ps[pm][order]
            score_acc[l].extend(scores_l)
            if gm.sum() == 0:
                match_acc[l].extend([0] * len(scores_l))
                iou_acc[l].extend([0.0] * len(scores_l))
                continue
            iou = boxes_iou_3d(
                torch.from_numpy(gb[gm].astype(np.float32)).to(dev),
                torch.from_numpy(boxes_l.astype(np.float32)).to(dev),
                aug_thickness=aug, criterion=-1).cpu().numpy()
            match, best_iou, gt_index = match_predictions_to_gt(
                iou, iou_thresh)
            match_acc[l].extend(match)
            iou_acc[l].extend(best_iou)

            # AIoU bookkeeping: per gt, the highest-score matched pred
            pred_count = np.zeros(gm.sum(), np.int64)
            for gi in range(gm.sum()):
                pis = np.where(gt_index == gi)[0]
                pred_count[gi] = len(pis)
                if len(pis) == 0:
                    continue
                best = pis[0]  # preds sorted by score desc
                if scores_l[best] >= score_thres and \
                        best_iou[best] > iou_thresh:
                    good_ious[l].append(best_iou[best])
            missed[l] += int((pred_count == 0).sum())
            multi[l] += int((pred_count > 1).sum())

    ap = np.full(num_classes, np.nan)
    aiou = np.full(num_classes, np.nan)
    curves: Dict[int, Dict[str, np.ndarray]] = {}
    for l in range(1, num_classes):
        if len(score_acc[l]) == 0 or n_pos[l] == 0:
            continue
        prec, rec, scores_s, ious_s = accumulate_prec_rec(
            score_acc[l], match_acc[l], iou_acc[l], int(n_pos[l]))
        order = np.argsort(-np.asarray(score_acc[l], np.float64),
                           kind="stable")
        curves[l] = {"prec": prec, "rec": rec, "score": scores_s,
                     "iou": ious_s,
                     "match": np.asarray(match_acc[l])[order]}
        ap[l] = voc_ap_07(prec, rec)
        if good_ious[l]:
            aiou[l] = float(np.mean(good_ious[l]))

    ap[0] = np.nanmean(ap[1:]) if np.isfinite(ap[1:]).any() else np.nan
    aiou[0] = np.nanmean(aiou[1:]) if np.isfinite(aiou[1:]).any() else np.nan
    with np.errstate(divide="ignore", invalid="ignore"):
        missed_rate = missed / np.maximum(n_pos, 1)
        multi_rate = multi / np.maximum(n_pos, 1)
    names = class_names or [str(i) for i in range(num_classes)]
    return DetectionEvalResult(ap=ap, aiou=aiou, n_gt=n_pos,
                               missed_rate=missed_rate, multi_rate=multi_rate,
                               class_names=names, curves=curves)


def save_results(result: DetectionEvalResult, output_folder: str,
                 num_examples: int, iou_thresh: float, epoch=None):
    """Write the run's result files: an append-log ``result_{N}.txt``, a
    ``performance_res.npz`` and, with matplotlib, ``pr_curves.png`` (the
    reference writes result_N.txt + performance_res.pth,
    suncg_eval.py:98-126 + save_perform_res)."""
    os.makedirs(output_folder, exist_ok=True)
    path = os.path.join(output_folder, f"result_{num_examples}.txt")
    with open(path, "a") as f:
        f.write(f"\n\niou_thresh: {iou_thresh}\n")
        if epoch is not None:
            f.write(f"epoch: {epoch}\ndata number: {num_examples}\n")
        f.write(result.summary() + "\n\n")
        f.write(result.detail_table() + "\n")
    extra = {}
    for l, c in (result.curves or {}).items():
        for k, v in c.items():
            extra[f"curve_{l}_{k}"] = v
    np.savez(os.path.join(output_folder, "performance_res.npz"),
             ap=result.ap, aiou=result.aiou, n_gt=result.n_gt,
             missed_rate=result.missed_rate, multi_rate=result.multi_rate,
             class_names=np.array(result.class_names), **extra)
    result.plot_pr_curves(os.path.join(output_folder, "pr_curves.png"))
    return path
