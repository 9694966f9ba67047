"""COCO-style mean-average-precision with point-IoU and rotated-box support.

Port of `radargnn_tpu/postprocess/mean_ap.py`: the numpy engine that
re-implements the reference's vendored torchmetrics fork
(`postprocessor/torchmetrics_mean_ap.py`), with its decisive semantics:

  * greedy per-image matching in descending-score order; each detection takes
    the not-yet-matched, not-ignored GT with the highest IoU if that IoU is
    strictly greater than the threshold (`_find_best_gt_match:721-747` —
    note the fork never matches ignored GT, unlike pycocotools),
  * per-image max-detection truncation, mergesort (stable) global score
    ordering,
  * precision/recall curve with right-to-left precision envelope ("zigzag
    removal", `:956-962`), sampled at 101 recall thresholds via searchsorted,
    zeros beyond the achieved recall,
  * classes = union of GT and detection labels; classes without GT stay at
    sentinel -1 and are excluded from the overall map; per-class AP for them
    is NaN (`_summarize`, `compute`),
  * point-IoU mode: IoU between boxes = discrete IoU of the member points of
    the frame's cloud (`compute_iou:84-128` + `utils/math.py:176-211`),
  * area ranges (`:389-394,561-575,661-718`): GT outside the range are
    ignored (sorted last, excluded from npig, never matched); detections
    left unmatched whose own area falls outside the range are ignored
    (neither TP nor FP). Rotated [cx,cy,l,w,θ] area = l·w
    (`compute_area:43-81`), aligned xyxy area = (x2−x1)·(y2−y1),
  * max-detection thresholds (`:357-381,803,930-940`): matching runs at the
    largest threshold; smaller ones slice the per-image score-ordered
    prefix. `mar_<k>` summaries per threshold.

The box IoU (box-IoU mode) runs on the engine's device (`device`, the card
by default) in float32, all frames in one batched call; the point IoU is
host numpy.

Defaults match the radar pipeline (area "all", max 100 detections — the
only summary the reference pipeline consumes); pass
`max_detection_thresholds=[1, 10, 100]` and `area_ranges="coco"` for the
fork's full COCO summary surface.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np

import torch

from radargnn_tpu_torch.device import DeviceLike, resolve_device
from radargnn_tpu_torch.postprocess.nms import batched_iou_matrices
from radargnn_tpu_torch.utils.geometry import point_iou as geometry_point_iou

MAX_DET = 100
REC_THRESHOLDS = np.linspace(0.0, 1.0, 101)
# `torchmetrics_mean_ap.py:389-394`
COCO_AREA_RANGES = {
    "all": (0.0 ** 2, float(1e5) ** 2),
    "small": (0.0 ** 2, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, float(1e5) ** 2),
}


def _box_areas(boxes: np.ndarray) -> np.ndarray:
    """`compute_area` parity: xyxy → width·height; [cx,cy,l,w,θ] → l·w."""
    if boxes.shape[0] == 0:
        return np.zeros((0,))
    if boxes.ndim == 2 and boxes.shape[1] == 5:
        return np.abs(boxes[:, 2] * boxes[:, 3])
    return np.maximum(boxes[:, 2] - boxes[:, 0], 0) \
        * np.maximum(boxes[:, 3] - boxes[:, 1], 0)


class MeanAveragePrecision:
    """Accumulates per-image detections/GT; `compute()` returns the metric
    dict with `map`, `map_per_class`, `map_50`, `map_75`, `mar_<k>` (one per
    max-detection threshold) and, when COCO area ranges are enabled,
    `map_small/medium/large` + `mar_small/medium/large`."""

    def __init__(self, iou_thresholds: Optional[List[float]] = None,
                 class_metrics: bool = True,
                 max_detection_thresholds: Optional[List[int]] = None,
                 area_ranges: Union[None, str, Dict] = None,
                 device: DeviceLike = None):
        # the box IoU's device (None: the card); the point IoU is host numpy
        self.device = device
        self.iou_thresholds = list(iou_thresholds or
                                   np.arange(0.5, 1.0, 0.05).round(2).tolist())
        self.class_metrics = class_metrics
        self.max_detection_thresholds = sorted(
            max_detection_thresholds or [MAX_DET])
        if area_ranges is None:
            area_ranges = {"all": COCO_AREA_RANGES["all"]}
        elif area_ranges == "coco":
            area_ranges = dict(COCO_AREA_RANGES)
        self.area_ranges = dict(area_ranges)
        self.detections: List[np.ndarray] = []
        self.detection_scores: List[np.ndarray] = []
        self.detection_labels: List[np.ndarray] = []
        self.groundtruths: List[np.ndarray] = []
        self.groundtruth_labels: List[np.ndarray] = []
        self.point_clouds: List[Optional[np.ndarray]] = []
        self.use_point_iou = False
        self.is_aligned = True

    def update(self, preds: List[Dict], target: List[Dict],
               use_point_iou: bool = False,
               point_clouds: Optional[List[np.ndarray]] = None,
               is_aligned: bool = True) -> None:
        for item in preds:
            self.detections.append(np.asarray(item["boxes"], np.float64))
            self.detection_scores.append(np.asarray(item["scores"], np.float64))
            self.detection_labels.append(
                np.asarray(item["labels"]).astype(np.int64).reshape(-1))
        for item in target:
            self.groundtruths.append(np.asarray(item["boxes"], np.float64))
            self.groundtruth_labels.append(
                np.asarray(item["labels"]).astype(np.int64).reshape(-1))
        self.use_point_iou = use_point_iou
        self.is_aligned = is_aligned
        if use_point_iou and point_clouds is not None:
            self.point_clouds.extend(point_clouds)

    # ------------------------------------------------------------------

    def _classes(self) -> List[int]:
        labels = self.detection_labels + self.groundtruth_labels
        if not labels:
            return []
        return sorted(np.unique(np.concatenate(labels)).tolist())

    def _iou_image(self, idx: int, iou_cache: dict) -> np.ndarray:
        """Full detections×GT IoU matrix of one image, ALL classes at once.

        IoU depends only on geometry, so one matrix per image serves every
        (class, area-range, threshold) evaluation; per-class evaluations
        slice it by row/column index.
        """
        if idx in iou_cache:
            return iou_cache[idx]
        det = self.detections[idx]
        gt = self.groundtruths[idx]
        if det.shape[0] == 0 or gt.shape[0] == 0:
            out = np.zeros((det.shape[0], gt.shape[0]), np.float32)
        elif self.use_point_iou:
            out = np.asarray(geometry_point_iou(
                det, gt, self.point_clouds[idx], self.is_aligned))
        else:
            self._precompute_geometric_ious(iou_cache)
            return iou_cache[idx]
        # float32 bounds the run-long cache: Σ_i dets_i·gts_i · 4 B for the
        # whole split (e.g. 20k frames × 200×100 ≈ 160 MB); the cache dict
        # is local to compute() and freed when it returns
        out = np.asarray(out, np.float32)
        iou_cache[idx] = out
        return out

    def _precompute_geometric_ious(self, iou_cache: dict,
                                   chunk: int = 256) -> None:
        """Fills `iou_cache` for every frame with one batched IoU on the
        engine's device per `chunk` frames, as the JAX package dispatches
        them: the frames' det×GT boxes pad into [F, Dmax, Gmax] (zero rows:
        IoU 0) and `batched_iou_matrices` computes every matrix at once, in
        float32. Point-IoU mode stays host-side numpy."""
        if self.use_point_iou:
            return
        sizes = [(d.shape[0], g.shape[0])
                 for d, g in zip(self.detections, self.groundtruths)]
        todo = [i for i, (nd, ng) in enumerate(sizes)
                if nd and ng and i not in iou_cache]
        width = 4 if self.is_aligned else 5
        dev = resolve_device(self.device) if todo else None
        for lo in range(0, len(todo), chunk):
            grp = todo[lo:lo + chunk]
            dmax = max(sizes[i][0] for i in grp)
            gmax = max(sizes[i][1] for i in grp)
            det = np.zeros((len(grp), dmax, width), np.float32)
            gt = np.zeros((len(grp), gmax, width), np.float32)
            for row, i in enumerate(grp):
                det[row, :sizes[i][0]] = self.detections[i]
                gt[row, :sizes[i][1]] = self.groundtruths[i]
            ious = batched_iou_matrices(
                torch.from_numpy(det).to(dev), torch.from_numpy(gt).to(dev),
                rotated=not self.is_aligned).cpu().numpy()
            for row, i in enumerate(grp):
                iou_cache[i] = ious[row, :sizes[i][0], :sizes[i][1]]

    def _evaluate_image(self, idx: int, class_id: int, area_range,
                        iou_cache: dict):
        """One (image, class, area-range) evaluation at the largest
        max-detection threshold; smaller thresholds slice the result."""
        det_mask = self.detection_labels[idx] == class_id
        gt_mask = self.groundtruth_labels[idx] == class_id
        nb_det, nb_gt = int(det_mask.sum()), int(gt_mask.sum())
        if nb_det == 0 and nb_gt == 0:
            return None
        max_det = self.max_detection_thresholds[-1]

        scores = self.detection_scores[idx][det_mask]
        order = np.argsort(-scores, kind="stable")[:max_det]
        scores_sorted = scores[order]
        det_idx = np.flatnonzero(det_mask)[order]
        gt_idx = np.flatnonzero(gt_mask)
        det = self.detections[idx][det_idx] if nb_det else \
            np.zeros((0, self.detections[idx].shape[1] if
                      self.detections[idx].ndim == 2 else 4))
        gt = self.groundtruths[idx][gt_idx] if nb_gt else np.zeros((0, 4))

        # GT ignore flags: area outside range, ignored sorted LAST
        # (`_evaluate_image:661-668`)
        gt_areas = _box_areas(gt)
        gt_ignore_flag = (gt_areas < area_range[0]) | \
            (gt_areas > area_range[1])
        gtind = np.argsort(gt_ignore_flag, kind="stable")
        gt_ignore = gt_ignore_flag[gtind]

        T = len(self.iou_thresholds)
        nd = det.shape[0]
        det_matches = np.zeros((T, nd), bool)
        gt_matches = np.zeros((T, nb_gt), bool)

        if nd and nb_gt:
            full = self._iou_image(idx, iou_cache)
            ious = full[np.ix_(det_idx, gt_idx)][:, gtind]
            alive_base = ~gt_ignore[None, :]
            thr = np.asarray(self.iou_thresholds)[:, None]
            t_idx = np.arange(T)
            # greedy matching, vectorized over ALL thresholds at once: a
            # detection's candidate set depends only on the per-threshold
            # matched-GT state, so one pass over detections updates every
            # threshold row together
            for di in range(nd):
                # ignored GT are removed outright, matching the fork's
                # `_find_best_gt_match:740-747` (NOT pycocotools, which
                # lets ignored GT absorb leftover detections)
                cand = ious[di][None, :] * (~gt_matches & alive_base)
                gi = np.argmax(cand, axis=1)                  # [T]
                ok = cand[t_idx, gi] > thr[:, 0]
                det_matches[:, di] = ok
                gt_matches[t_idx[ok], gi[ok]] = True

        # unmatched detections outside the area range are ignored
        # (`_evaluate_image:703-710`)
        det_areas = _box_areas(det)
        det_outside = (det_areas < area_range[0]) | \
            (det_areas > area_range[1])
        det_ignore = (~det_matches) & det_outside[None, :]

        return {"dtMatches": det_matches, "dtIgnore": det_ignore,
                "dtScores": scores_sorted,
                "npig": int((~gt_ignore).sum())}

    def _calculate_class(self, class_id: int, iou_cache: dict):
        """Returns (precision[T,R,A,M], recall[T,A,M]) with -1 sentinels."""
        T = len(self.iou_thresholds)
        nb_rec = len(REC_THRESHOLDS)
        A = len(self.area_ranges)
        M = len(self.max_detection_thresholds)
        precision = np.full((T, nb_rec, A, M), -1.0)
        recall = np.full((T, A, M), -1.0)

        for ai, area_range in enumerate(self.area_ranges.values()):
            evals = [self._evaluate_image(i, class_id, area_range, iou_cache)
                     for i in range(len(self.detections))]
            evals = [e for e in evals if e is not None]
            if not evals:
                continue
            npig = sum(e["npig"] for e in evals)
            if npig == 0:
                continue
            for mi, max_det in enumerate(self.max_detection_thresholds):
                det_scores = np.concatenate(
                    [e["dtScores"][:max_det] for e in evals])
                inds = np.argsort(-det_scores, kind="stable")
                det_matches = np.concatenate(
                    [e["dtMatches"][:, :max_det] for e in evals],
                    axis=1)[:, inds]
                det_ignore = np.concatenate(
                    [e["dtIgnore"][:, :max_det] for e in evals],
                    axis=1)[:, inds]

                for ti in range(T):
                    keep = ~det_ignore[ti]
                    tp = np.cumsum(det_matches[ti] & keep).astype(np.float64)
                    fp = np.cumsum(~det_matches[ti] & keep).astype(np.float64)
                    nd = tp.shape[0]
                    if nd == 0:
                        recall[ti, ai, mi] = 0.0
                        precision[ti, :, ai, mi] = 0.0
                        continue
                    rc = tp / npig
                    pr = tp / (tp + fp + np.finfo(np.float64).eps)
                    recall[ti, ai, mi] = rc[-1]

                    # precision envelope (zigzag removal): running max from
                    # the right
                    pr = np.maximum.accumulate(pr[::-1])[::-1]

                    inds_r = np.searchsorted(rc, REC_THRESHOLDS, side="left")
                    prec = np.zeros((nb_rec,))
                    valid = inds_r < nd
                    prec[valid] = pr[inds_r[valid]]
                    precision[ti, :, ai, mi] = prec
        return precision, recall

    def compute(self) -> Dict[str, object]:
        classes = self._classes()
        T = len(self.iou_thresholds)
        nb_rec = len(REC_THRESHOLDS)
        A = len(self.area_ranges)
        M = len(self.max_detection_thresholds)
        precisions = np.full((T, nb_rec, len(classes), A, M), -1.0)
        recalls = np.full((T, len(classes), A, M), -1.0)

        iou_cache: dict = {}        # per-IMAGE full matrices, all classes
        for ci, c in enumerate(classes):
            prec, rec = self._calculate_class(c, iou_cache)
            precisions[:, :, ci] = prec
            recalls[:, ci] = rec

        def _mean_valid(a):
            v = a[a > -1]
            return float(v.mean()) if v.size else -1.0

        area_keys = list(self.area_ranges.keys())
        ai_all = area_keys.index("all") if "all" in area_keys else 0
        mi_last = M - 1

        result = {
            "map": _mean_valid(precisions[:, :, :, ai_all, mi_last]),
            "classes": classes,
        }
        for thr_name, thr in (("map_50", 0.5), ("map_75", 0.75)):
            if thr in self.iou_thresholds:
                ti = self.iou_thresholds.index(thr)
                result[thr_name] = _mean_valid(
                    precisions[ti, :, :, ai_all, mi_last])
            else:
                result[thr_name] = -1.0

        # mar_<k> per max-detection threshold (`_summarize_results:900-903`)
        for mi, max_det in enumerate(self.max_detection_thresholds):
            result[f"mar_{max_det}"] = _mean_valid(
                recalls[:, :, ai_all, mi])

        # per-area summaries at the last max-det threshold (`:893-911`)
        for ai, name in enumerate(area_keys):
            if name == "all":
                continue
            result[f"map_{name}"] = _mean_valid(
                precisions[:, :, :, ai, mi_last])
            result[f"mar_{name}"] = _mean_valid(
                recalls[:, :, ai, mi_last])

        if self.class_metrics:
            per_class = []
            for ci in range(len(classes)):
                p = precisions[:, :, ci, ai_all, mi_last]
                v = p[p > -1]
                per_class.append(float(v.mean()) if v.size else float("nan"))
            result["map_per_class"] = np.asarray(per_class)
        else:
            result["map_per_class"] = np.asarray([-1.0])
        return result
