"""Scene / box visualization toolbox (matplotlib, headless PNGs).

The open3d-free analogue of the reference's debug-visualization layer:
``Bbox3D.draw_points_bboxes`` and friends (utils3d/bbox3d_ops.py:
1170-1388) plus the eval-side ``SHOW_PRED`` harness (suncg_eval.py:
16-23) and the RPN/loss ``SHOW_*`` flags (rpn_sparse3d.py:14-17,
loss_3d.py:20-28). open3d interactive windows don't fit a headless
host, so every helper here renders to a PNG instead: bird's-eye-view
(BEV) scatter + rotated box outlines, 3D wireframes, and GT-vs-pred
match panels.

All inputs are 7-DoF boxes in STANDARD format [cx,cy,cz,sx,sy,sz,yaw]
(convert yx_zb first via ops/geometry.yx_zb_to_standard); labels index
the config's class tuple. Pure numpy/matplotlib — offline host-side.

The port's copy of detection_3d_tpu/utils/viz.py. matplotlib is imported
on first draw, never at import, so the package imports where it is
missing.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# per-class colors, canonical order background/wall/window/door/floor/
# ceiling/room (suncg_metas.py:2-43); extras cycle
_CLASS_COLORS = ("0.6", "tab:blue", "tab:orange", "tab:green",
                 "tab:red", "tab:purple", "tab:brown", "tab:pink",
                 "tab:olive", "tab:cyan")


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _corners2d(boxes: np.ndarray) -> np.ndarray:
    """(N,7) standard boxes -> (N,4,2) BEV corner loops. CLOCKWISE
    rotation sense [[c, s], [-s, c]] — the convention of the whole stack
    (rbbox_to_corners, nms_gpu.py:355-378; ops/geometry.rbbox_corners_2d)
    and of the synthetic samplers."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
    sx, sy = boxes[:, 3] / 2, boxes[:, 4] / 2
    local = np.stack([np.stack([-sx, -sy], 1), np.stack([-sx, sy], 1),
                      np.stack([sx, sy], 1), np.stack([sx, -sy], 1)], 1)
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    x = local[..., 0] * c[:, None] + local[..., 1] * s[:, None]
    y = -local[..., 0] * s[:, None] + local[..., 1] * c[:, None]
    return np.stack([x + boxes[:, None, 0], y + boxes[:, None, 1]], -1)


def _corners3d(boxes: np.ndarray) -> np.ndarray:
    """(N,7) -> (N,8,3): bottom loop then top loop."""
    bev = _corners2d(boxes)
    boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
    z0 = boxes[:, 2] - boxes[:, 5] / 2
    z1 = boxes[:, 2] + boxes[:, 5] / 2
    bot = np.concatenate([bev, np.broadcast_to(z0[:, None, None],
                                               bev.shape[:2] + (1,))], -1)
    top = np.concatenate([bev, np.broadcast_to(z1[:, None, None],
                                               bev.shape[:2] + (1,))], -1)
    return np.concatenate([bot, top], 1)


def _draw_boxes_bev(ax, boxes, labels=None, color=None, ls="-", lw=1.2,
                    scores=None, class_names: Optional[Sequence] = None):
    boxes = np.asarray(boxes).reshape(-1, 7)
    labels = (np.full(len(boxes), 1, int) if labels is None
              else np.asarray(labels, int).reshape(-1))
    for i, loop in enumerate(_corners2d(boxes)):
        cc = color or _CLASS_COLORS[labels[i] % len(_CLASS_COLORS)]
        pts = np.concatenate([loop, loop[:1]], 0)
        ax.plot(pts[:, 0], pts[:, 1], ls, color=cc, lw=lw)
        # heading tick from center to mid-front edge (+x face)
        mid = (loop[2] + loop[3]) / 2
        ax.plot([boxes[i, 0], mid[0]], [boxes[i, 1], mid[1]],
                ls, color=cc, lw=lw * 0.8)
        if scores is not None:
            ax.annotate(f"{scores[i]:.2f}", loop[0], fontsize=5,
                        color=cc)


def draw_points_bboxes(points: Optional[np.ndarray], boxes: np.ndarray,
                       labels=None, scores=None, path: str = "scene.png",
                       class_names: Optional[Sequence[str]] = None,
                       gt_boxes=None, gt_labels=None,
                       title: str = "") -> str:
    """BEV panel: point density + rotated box outlines (the
    draw_points_bboxes twin, utils3d/bbox3d_ops.py:1170-1230). Optional
    ``gt_boxes`` drawn dashed grey underneath (SHOW_PRED style,
    suncg_eval.py:16-23). Returns ``path``."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(9, 9))
    if points is not None and len(points):
        p = np.asarray(points)
        ax.hexbin(p[:, 0], p[:, 1], gridsize=160, cmap="Greys",
                  bins="log", mincnt=1)
    if gt_boxes is not None and len(gt_boxes):
        _draw_boxes_bev(ax, gt_boxes, gt_labels, color="0.45", ls="--",
                        lw=1.0)
    if len(boxes):
        _draw_boxes_bev(ax, boxes, labels, scores=scores)
    if class_names:
        import matplotlib.lines as mlines
        handles = [mlines.Line2D([], [], color=_CLASS_COLORS[
            l % len(_CLASS_COLORS)], label=class_names[l])
            for l in sorted(set(np.asarray(
                labels if labels is not None else [1], int).tolist()))]
        if gt_boxes is not None:
            handles.append(mlines.Line2D([], [], color="0.45", ls="--",
                                         label="gt"))
        ax.legend(handles=handles, fontsize=8, loc="upper right")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=140)
    plt.close(fig)
    return path


_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7),
          (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)]


def draw_scene_3d(points: Optional[np.ndarray], boxes: np.ndarray,
                  labels=None, path: str = "scene3d.png",
                  max_points: int = 20_000, elev: float = 28.0,
                  azim: float = -60.0) -> str:
    """3D wireframe panel (the open3d draw_bboxes 3D view,
    bbox3d_ops.py:1258-1320): subsampled point scatter + 12-edge box
    frames, color by label. Returns ``path``."""
    plt = _plt()
    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(projection="3d")
    if points is not None and len(points):
        p = np.asarray(points)
        if p.shape[0] > max_points:
            p = p[np.random.RandomState(0).choice(p.shape[0], max_points,
                                                  False)]
        ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=0.3, c="0.6", alpha=0.4)
    boxes = np.asarray(boxes).reshape(-1, 7)
    labels = (np.full(len(boxes), 1, int) if labels is None
              else np.asarray(labels, int).reshape(-1))
    for i, cs in enumerate(_corners3d(boxes)):
        cc = _CLASS_COLORS[labels[i] % len(_CLASS_COLORS)]
        for a, b in _EDGES:
            ax.plot(*zip(cs[a], cs[b]), color=cc, lw=1.0)
    ax.view_init(elev=elev, azim=azim)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def draw_eval_matches(gt_boxes, gt_labels, det_boxes, det_labels,
                      det_scores, matched: Optional[np.ndarray] = None,
                      points=None, path: str = "matches.png",
                      class_names: Optional[Sequence[str]] = None) -> str:
    """GT-vs-detections diagnostic (the missed/multi panels the
    reference shows under SHOW_PRED, suncg_eval.py:16-23,834-845):
    GT dashed grey, matched detections solid, unmatched detections
    dotted red. ``matched`` is a bool mask over detections."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(9, 9))
    if points is not None and len(points):
        p = np.asarray(points)
        ax.hexbin(p[:, 0], p[:, 1], gridsize=160, cmap="Greys",
                  bins="log", mincnt=1)
    if len(gt_boxes):
        _draw_boxes_bev(ax, gt_boxes, gt_labels, color="0.45", ls="--")
    det_boxes = np.asarray(det_boxes).reshape(-1, 7)
    if matched is None:
        matched = np.ones(len(det_boxes), bool)
    matched = np.asarray(matched, bool).reshape(-1)
    if matched.any():
        _draw_boxes_bev(ax, det_boxes[matched],
                        np.asarray(det_labels)[matched],
                        scores=np.asarray(det_scores)[matched])
    if (~matched).any():
        _draw_boxes_bev(ax, det_boxes[~matched],
                        np.asarray(det_labels)[~matched], color="red",
                        ls=":", scores=np.asarray(det_scores)[~matched])
    ax.set_aspect("equal")
    ax.set_title(f"{int(matched.sum())}/{len(det_boxes)} dets matched, "
                 f"{len(gt_boxes)} gt")
    fig.tight_layout()
    fig.savefig(path, dpi=140)
    plt.close(fig)
    return path
