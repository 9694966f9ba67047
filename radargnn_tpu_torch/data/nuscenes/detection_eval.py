"""Native nuScenes detection evaluation (mAP / TP metrics / NDS), in place
of the devkit's `nuscenes.eval.detection.evaluate.DetectionEval`.

Port of `radargnn_tpu/data/nuscenes/detection_eval.py` (host numpy), the
`detection_cvpr_2019` protocol:

  * matching by 2D ground-plane center distance at thresholds 0.5/1/2/4 m,
    greedy in descending-score order against not-yet-matched GT of the class,
  * GT and predictions filtered to the class detection range from the ego
    position; ≤ 500 boxes per sample,
  * AP = 101-point interpolated precision with the (0.1, 0.1) min
    recall/precision cut: mean over recall > 0.1 of max(p − 0.1, 0) / 0.9,
  * TP errors (ATE/ASE/AOE/AVE/AAE) exactly per the devkit: the cumulative
    mean over TP matches is interpolated onto the 101-point recall grid by
    confidence, then averaged from recall bin 11 up to the max achieved
    recall (classes below min recall score 1.0); traffic_cone orient/vel/attr
    and barrier vel/attr are NaN and excluded via nanmean,
  * classes absent from the GT score AP 0 / TP errors 1.0 and ARE included
    in the means over all ten classes (devkit `DetectionMetrics.mean_ap`),
  * GT box velocities by finite difference over the instance's neighboring
    annotations (devkit `NuScenes.box_velocity`, incl. the max-time-gap
    rule; NaN velocities yield NaN vel_err, skipped by the NaN-aware
    cumulative mean exactly as the devkit's `cummean` does),
  * NDS = (5·mAP + Σ max(1 − mTP, 0)) / 10 over the five TP scores.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from radargnn_tpu_torch.data.nuscenes.quaternion import Quaternion

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_DIST_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
MAX_BOXES_PER_SAMPLE = 500

CLASS_RANGE = {
    "car": 50, "truck": 50, "bus": 50, "trailer": 50,
    "construction_vehicle": 50, "pedestrian": 40, "motorcycle": 40,
    "bicycle": 40, "traffic_cone": 30, "barrier": 30,
}

ATTRIBUTES = (
    "cycle.with_rider", "cycle.without_rider", "pedestrian.moving",
    "pedestrian.standing", "pedestrian.sitting_lying_down", "vehicle.moving",
    "vehicle.parked", "vehicle.stopped", "",
)


def _yaw_from_rotation(rotation) -> float:
    return Quaternion(rotation).yaw_pitch_roll[0]


def _angle_diff(a: float, b: float, period: float) -> float:
    d = (a - b) % period
    return min(d, period - d)


def _scale_iou(size_a, size_b) -> float:
    """3D IoU of axis-aligned, co-centered boxes (devkit scale_iou)."""
    inter = np.prod(np.minimum(size_a, size_b))
    union = np.prod(size_a) + np.prod(size_b) - inter
    return float(inter / union) if union > 0 else 0.0


def _calc_ap(prec_interp: np.ndarray) -> float:
    prec = prec_interp[round(100 * MIN_RECALL) + 1:]
    prec = np.clip(prec - MIN_PRECISION, 0, None)
    return float(np.mean(prec)) / (1.0 - MIN_PRECISION)


def _cummean(x: np.ndarray) -> np.ndarray:
    """Cumulative mean ignoring NaNs (devkit `utils.cummean`)."""
    if np.isnan(x).sum() == len(x):
        return np.ones(len(x))
    sums = np.nancumsum(x.astype(float))
    counts = np.cumsum(~np.isnan(x))
    return np.divide(sums, counts, out=np.zeros_like(sums), where=counts > 0)


TP_NAMES = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")


class _MetricData:
    """Per-(class, threshold) curves on the 101-point recall grid
    (devkit `DetectionMetricData`)."""

    def __init__(self, precision, conf, tp_curves):
        self.precision = precision          # [101]
        self.conf = conf                    # [101] interpolated confidence
        self.tp_curves = tp_curves          # name -> [101] cumulative means

    @classmethod
    def no_predictions(cls):
        z = np.zeros(101)
        return cls(z, z, {k: np.ones(101) for k in TP_NAMES})

    @property
    def max_recall_ind(self) -> int:
        nz = np.nonzero(self.conf)[0]
        return int(nz[-1]) if len(nz) else 0


def _calc_tp(md: _MetricData, name: str) -> float:
    """Mean of the cumulative-mean curve over the achieved recall range
    (devkit `calc_tp`): bins 11 .. max_recall_ind inclusive; 1.0 when the
    max achieved recall is below min recall."""
    first = round(100 * MIN_RECALL) + 1
    last = md.max_recall_ind
    if last < first:
        return 1.0
    return float(np.mean(md.tp_curves[name][first:last + 1]))


class NuScenesDetectionEval:
    """Evaluates a submission dict against ground-truth boxes.

    ground_truth: {sample_token: [ {translation, size, rotation,
                   detection_name, attribute_name, velocity, ego_translation?} ]}
    submission:   the dict produced by `get_submission`.
    ego_positions: {sample_token: (x, y)} global ego position per sample.
    """

    def __init__(self, submission: Dict, ground_truth: Dict[str, List[dict]],
                 ego_positions: Dict[str, tuple]):
        self.results = submission["results"]
        self.gt = ground_truth
        self.ego = ego_positions

    def _filter(self, boxes: List[dict], token: str) -> List[dict]:
        ego = np.asarray(self.ego[token], dtype=float)
        kept = []
        for b in boxes:
            name = b["detection_name"]
            if name not in CLASS_RANGE:
                continue
            center = np.asarray(b["translation"][:2], dtype=float)
            if np.linalg.norm(center - ego[:2]) <= CLASS_RANGE[name]:
                kept.append(b)
        return kept

    def evaluate(self) -> Dict:
        tokens = sorted(self.gt.keys())
        gt_f = {t: self._filter(self.gt[t], t) for t in tokens}
        pred_f = {}
        for t in tokens:
            preds = self.results.get(t, [])
            preds = sorted(preds, key=lambda b: -b["detection_score"])
            pred_f[t] = self._filter(preds[:MAX_BOXES_PER_SAMPLE], t)

        classes = sorted(CLASS_RANGE.keys())
        ap = {}
        tp_errors = {}
        for cls in classes:
            aps = []
            for th in DIST_THRESHOLDS:
                md = self._accumulate(cls, th, gt_f, pred_f, tokens)
                aps.append(_calc_ap(md.precision))
                if th == TP_DIST_THRESHOLD:
                    # devkit class/metric exclusions → NaN (evaluate.py)
                    errs = {}
                    for name in TP_NAMES:
                        if cls == "traffic_cone" and name in (
                                "attr_err", "vel_err", "orient_err"):
                            errs[name] = np.nan
                        elif cls == "barrier" and name in (
                                "attr_err", "vel_err"):
                            errs[name] = np.nan
                        else:
                            errs[name] = _calc_tp(md, name)
                    tp_errors[cls] = errs
            ap[cls] = float(np.mean(aps))

        # devkit DetectionMetrics: plain mean over ALL classes (absent
        # classes contribute AP 0 / TP 1.0); nanmean skips only the
        # class/metric exclusions above
        mean_ap = float(np.mean([ap[c] for c in classes]))
        mean_tp = {
            name: float(np.nanmean([tp_errors[c][name] for c in classes]))
            for name in TP_NAMES}

        tp_scores = [max(1.0 - mean_tp[n], 0.0) for n in TP_NAMES]
        nds = (5.0 * mean_ap + sum(tp_scores)) / 10.0

        return {
            "mean_ap": mean_ap, "nd_score": nds,
            "label_aps": ap, "tp_errors": mean_tp,
            "mean_dist_aps": ap,
        }

    def _accumulate(self, cls: str, dist_th: float, gt_f, pred_f,
                    tokens) -> _MetricData:
        """Devkit `algo.accumulate`: greedy match in descending-score order,
        precision/confidence and cumulative-mean TP-error curves on the
        101-point recall grid."""
        # gather all predictions of the class across samples
        preds = []
        for t in tokens:
            for b in pred_f[t]:
                if b["detection_name"] == cls:
                    preds.append((t, b))
        npos = sum(1 for t in tokens for b in gt_f[t]
                   if b["detection_name"] == cls)
        if npos == 0 or not preds:
            return _MetricData.no_predictions()

        preds.sort(key=lambda tb: -tb[1]["detection_score"])
        matched = {t: np.zeros(len(gt_f[t]), bool) for t in tokens}
        # vectorized per-sample GT geometry: centers and
        # class mask as arrays so the greedy loop's inner distance scan is
        # one numpy expression instead of a per-GT Python loop
        gt_centers = {
            t: (np.asarray([b["translation"][:2] for b in gt_f[t]],
                           float).reshape(len(gt_f[t]), 2))
            for t in tokens}
        gt_is_cls = {
            t: np.asarray([b["detection_name"] == cls for b in gt_f[t]],
                          bool)
            for t in tokens}

        tp_flags = []
        all_conf = []                       # every prediction's score
        match_errs = {k: [] for k in TP_NAMES}
        match_conf = []                     # score at each TP match
        for t, pred in preds:
            center = np.asarray(pred["translation"][:2], float)
            cand = gt_is_cls[t] & ~matched[t]
            if cand.any():
                d_all = np.linalg.norm(gt_centers[t] - center, axis=1)
                d_all = np.where(cand, d_all, np.inf)
                best = int(np.argmin(d_all))
                best_d = float(d_all[best])
            else:
                best, best_d = -1, np.inf
            all_conf.append(pred["detection_score"])
            if best >= 0 and best_d <= dist_th:
                matched[t][best] = True
                tp_flags.append(True)
                gt = gt_f[t][best]
                match_conf.append(pred["detection_score"])
                # devkit appends EVERY metric on every TP (NaN where
                # undefined); class exclusions apply at the metrics level
                match_errs["trans_err"].append(best_d)
                match_errs["scale_err"].append(
                    1.0 - _scale_iou(np.asarray(pred["size"]),
                                     np.asarray(gt["size"])))
                period = np.pi if cls == "barrier" else 2 * np.pi
                match_errs["orient_err"].append(_angle_diff(
                    _yaw_from_rotation(pred["rotation"]),
                    _yaw_from_rotation(gt["rotation"]), period))
                pv = np.asarray(pred.get("velocity", (0, 0))[:2], float)
                gv = np.asarray(gt.get("velocity", (np.nan, np.nan))[:2],
                                float)
                match_errs["vel_err"].append(
                    float(np.linalg.norm(pv - gv)))
                gt_attr = gt.get("attribute_name", "")
                match_errs["attr_err"].append(
                    np.nan if gt_attr == "" else
                    (0.0 if pred.get("attribute_name") == gt_attr else 1.0))
            else:
                tp_flags.append(False)

        tp = np.cumsum(tp_flags).astype(float)
        fp = np.cumsum(~np.asarray(tp_flags)).astype(float)
        rec = tp / npos
        prec = tp / np.maximum(tp + fp, 1e-12)

        rec_interp = np.linspace(0, 1, 101)
        prec_interp = np.interp(rec_interp, rec, prec, right=0)
        conf_interp = np.interp(rec_interp, rec, all_conf, right=0)

        tp_curves = {}
        mc = np.asarray(match_conf, float)
        for k, vals in match_errs.items():
            if len(mc) == 0:
                tp_curves[k] = np.ones(101)
                continue
            # cumulative mean over TP matches, sampled at the interpolated
            # confidences (reversed: np.interp needs increasing x)
            cm = _cummean(np.asarray(vals, float))
            tp_curves[k] = np.interp(conf_interp[::-1], mc[::-1],
                                     cm[::-1])[::-1]
        return _MetricData(prec_interp, conf_interp, tp_curves)


def ground_truth_from_db(nusc, sample_tokens: List[str]):
    """Builds the eval ground-truth + ego positions from a NuScenes DB."""
    from radargnn_tpu_torch.data.nuscenes.dataset_creation import CLASS_NAME_TO_ID
    from radargnn_tpu_torch.data.nuscenes.submission import DETECTION_NAMES

    gt = {}
    ego = {}
    for token in sample_tokens:
        sample = nusc.get("sample", token)
        sd = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
        pose = nusc.get("ego_pose", sd["ego_pose_token"])
        ego[token] = tuple(pose["translation"][:2])
        boxes = []
        for ann_token in sample["anns"]:
            ann = nusc.get("sample_annotation", ann_token)
            if ann["num_lidar_pts"] + ann["num_radar_pts"] == 0:
                continue
            box = nusc.box_from_annotation(ann)
            label = CLASS_NAME_TO_ID.get(box.name, 0)
            if label == 0:
                continue
            attr = ""
            if ann.get("attribute_tokens"):
                attr = nusc.get("attribute",
                                ann["attribute_tokens"][0])["name"]
            # devkit load_gt: GT velocity by finite difference over the
            # instance's neighboring annotations (NaN when undefined; the
            # NaN vel_err is then skipped by _cummean, as the devkit does)
            vel = nusc.box_velocity(ann["token"])[:2]
            boxes.append({
                "translation": tuple(box.center),
                "size": tuple(box.wlh),
                "rotation": tuple(box.orientation.elements),
                "detection_name": DETECTION_NAMES[label],
                "attribute_name": attr,
                "velocity": (float(vel[0]), float(vel[1])),
            })
        gt[token] = boxes
    return gt, ego
