"""Self-contained COCO detection mAP (pycocotools-compatible, numpy only;
the port's own copy of `vlm_fo1_tpu/evaluation/coco_map.py`).

The reference emits COCO-format prediction JSON and leaves scoring to the
external COCO toolkit (its `evaluation/eval_coco.py`). This module scores
in-repo: it reproduces ``COCOeval`` bbox semantics (greedy
score-descending matching per (category, image), crowd/ignore handling,
area-range splits, 101-point interpolated precision), so the evaluation
runner reports the headline ``AP@[.5:.95]`` without pycocotools.

Semantics mirrored from pycocotools ``cocoeval.py`` (public BSD reference):
- IoU on xywh boxes; against a crowd GT the union is the detection's area.
- Per (cat, img): GTs sorted ignore-last, detections score-descending capped
  at maxDets; each detection greedily takes the best-IoU available GT above
  the threshold, preferring any non-ignore GT over ignore GTs.
- A detection matched to an ignore GT, or unmatched with area outside the
  range, is ignored (neither TP nor FP).
- accumulate(): cumulative TP/FP over the score-sorted pool per category,
  precision envelope (running max from the right), sampled at 101 recall
  thresholds; AP averages over categories with ≥1 non-ignored GT.
"""

from __future__ import annotations

import json

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def iou_xywh(det: np.ndarray, gt: np.ndarray,
             iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU of [Nd,4] x [Ng,4] xywh boxes ([Nd, Ng]).

    For crowd GTs the denominator is the detection area alone (a detection
    fully inside a crowd region scores 1) — pycocotools ``maskUtils.iou``
    iscrowd semantics."""
    det = np.asarray(det, np.float64).reshape(-1, 4)
    gt = np.asarray(gt, np.float64).reshape(-1, 4)
    if det.size == 0 or gt.size == 0:
        return np.zeros((det.shape[0], gt.shape[0]))
    dx1, dy1 = det[:, 0], det[:, 1]
    dx2, dy2 = det[:, 0] + det[:, 2], det[:, 1] + det[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.clip(np.minimum(dx2[:, None], gx2[None]) -
                 np.maximum(dx1[:, None], gx1[None]), 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2[None]) -
                 np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = iw * ih
    darea = (det[:, 2] * det[:, 3])[:, None]
    garea = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(np.asarray(iscrowd, bool)[None], darea,
                     darea + garea - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _match_one(dt_boxes, dt_scores, gt_boxes, gt_ignore, gt_crowd,
               dt_areas, area_rng, max_det):
    """Greedy matching for one (category, image) cell.

    Returns (dt_matched [T, Nd] bool, dt_ignored [T, Nd] bool,
    dt_scores [Nd], n_gt_counted) with detections score-sorted and capped.
    """
    order = np.argsort(-dt_scores, kind="mergesort")[:max_det]
    dt_boxes, dt_scores = dt_boxes[order], dt_scores[order]
    dt_areas = dt_areas[order]

    # GT ignore: flagged (crowd / external) or area outside the range
    g_area = gt_boxes[:, 2] * gt_boxes[:, 3]
    gt_ig = gt_ignore | (g_area < area_rng[0]) | (g_area > area_rng[1])
    gorder = np.argsort(gt_ig, kind="mergesort")  # ignores last
    gt_boxes, gt_ig, gt_crowd = (gt_boxes[gorder], gt_ig[gorder],
                                 gt_crowd[gorder])

    ious = iou_xywh(dt_boxes, gt_boxes, gt_crowd)
    nt, nd, ng = len(IOU_THRS), len(dt_boxes), len(gt_boxes)
    dtm = np.zeros((nt, nd), np.int64) - 1   # matched gt index or -1
    gtm = np.zeros((nt, ng), bool)
    for ti, thr in enumerate(IOU_THRS):
        for di in range(nd):
            best, bi = min(thr, 1 - 1e-10), -1
            for gi in range(ng):
                if gtm[ti, gi] and not gt_crowd[gi]:
                    continue  # taken (crowd GTs can absorb many dets)
                if bi > -1 and not gt_ig[bi] and gt_ig[gi]:
                    break     # have a real match; rest are ignores
                if ious[di, gi] < best:
                    continue
                best, bi = ious[di, gi], gi
            if bi > -1:
                dtm[ti, di] = bi
                gtm[ti, bi] = True
    matched = dtm >= 0
    matched_ig = np.zeros_like(matched)
    if ng:
        matched_ig = np.where(matched, gt_ig[np.maximum(dtm, 0)], False)
    out_of_rng = (dt_areas < area_rng[0]) | (dt_areas > area_rng[1])
    dt_ignored = matched_ig | (~matched & out_of_rng[None])
    return matched, dt_ignored, dt_scores, int((~gt_ig).sum())


def evaluate_detections(gt: dict, detections: list[dict],
                        max_items: int | None = None) -> dict:
    """COCO bbox evaluation. ``gt`` is an instances_val2017-style dict
    (images/annotations/categories); ``detections`` is the prediction list
    ({image_id, category_id, bbox xywh, score}). Returns the 12 standard
    metrics keyed AP, AP50, AP75, APsmall/medium/large, AR1/10/100,
    ARsmall/medium/large."""
    img_ids = [im["id"] for im in gt["images"]]
    if max_items:
        img_ids = img_ids[:max_items]
    img_set = set(img_ids)
    cat_ids = sorted(c["id"] for c in gt["categories"])

    gts: dict[tuple, list] = {}
    for a in gt["annotations"]:
        if a["image_id"] in img_set:
            gts.setdefault((a["category_id"], a["image_id"]), []).append(a)
    dts: dict[tuple, list] = {}
    for d in detections:
        if d["image_id"] in img_set:
            dts.setdefault((d["category_id"], d["image_id"]), []).append(d)

    n_area, n_md = len(AREA_RANGES), len(MAX_DETS)
    nt, nr = len(IOU_THRS), len(REC_THRS)
    precision = -np.ones((nt, nr, len(cat_ids), n_area, n_md))
    recall = -np.ones((nt, len(cat_ids), n_area, n_md))

    for ci, cat in enumerate(cat_ids):
        # per-image matches computed once per (area, maxdet) combo
        for ai, (aname, arng) in enumerate(AREA_RANGES.items()):
            for mi, md in enumerate(MAX_DETS):
                all_m, all_ig, all_sc, npig = [], [], [], 0
                for img in img_ids:
                    g = gts.get((cat, img), [])
                    d = dts.get((cat, img), [])
                    if not g and not d:
                        continue
                    gb = np.array([x["bbox"] for x in g],
                                  np.float64).reshape(-1, 4)
                    gig = np.array([bool(x.get("iscrowd", 0)) or
                                    bool(x.get("ignore", 0)) for x in g],
                                   bool)
                    gcr = np.array([bool(x.get("iscrowd", 0)) for x in g],
                                   bool)
                    db = np.array([x["bbox"] for x in d],
                                  np.float64).reshape(-1, 4)
                    ds = np.array([x["score"] for x in d], np.float64)
                    da = db[:, 2] * db[:, 3]
                    m, ig, sc, np_g = _match_one(db, ds, gb, gig, gcr, da,
                                                 arng, md)
                    all_m.append(m)
                    all_ig.append(ig)
                    all_sc.append(sc)
                    npig += np_g
                if npig == 0:
                    continue
                if all_sc and sum(len(s) for s in all_sc):
                    m = np.concatenate(all_m, 1)
                    ig = np.concatenate(all_ig, 1)
                    sc = np.concatenate(all_sc)
                    order = np.argsort(-sc, kind="mergesort")
                    m, ig = m[:, order], ig[:, order]
                    tps = np.cumsum(m & ~ig, 1).astype(np.float64)
                    fps = np.cumsum(~m & ~ig, 1).astype(np.float64)
                    rc = tps / npig
                    pr = tps / np.maximum(tps + fps, 1e-12)
                    recall[:, ci, ai, mi] = rc[:, -1] if rc.size else 0.0
                    for ti in range(nt):
                        p = pr[ti].copy()
                        # precision envelope: running max from the right
                        for k in range(len(p) - 1, 0, -1):
                            p[k - 1] = max(p[k - 1], p[k])
                        inds = np.searchsorted(rc[ti], REC_THRS, side="left")
                        q = np.zeros(nr)
                        valid = inds < len(p)
                        q[valid] = p[inds[valid]]
                        precision[ti, :, ci, ai, mi] = q
                else:
                    recall[:, ci, ai, mi] = 0.0
                    precision[:, :, ci, ai, mi] = 0.0

    def _ap(t=None, area="all", md=100):
        ai = list(AREA_RANGES).index(area)
        mi = MAX_DETS.index(md)
        s = precision[:, :, :, ai, mi]
        if t is not None:
            s = s[[int(np.argwhere(np.isclose(IOU_THRS, t))[0][0])]]
        s = s[s > -1]
        return float(s.mean()) if s.size else -1.0

    def _ar(area="all", md=100):
        ai = list(AREA_RANGES).index(area)
        mi = MAX_DETS.index(md)
        s = recall[:, :, ai, mi]
        s = s[s > -1]
        return float(s.mean()) if s.size else -1.0

    return {
        "AP": _ap(), "AP50": _ap(t=0.5), "AP75": _ap(t=0.75),
        "APsmall": _ap(area="small"), "APmedium": _ap(area="medium"),
        "APlarge": _ap(area="large"),
        "AR1": _ar(md=1), "AR10": _ar(md=10), "AR100": _ar(md=100),
        "ARsmall": _ar(area="small"), "ARmedium": _ar(area="medium"),
        "ARlarge": _ar(area="large"),
    }


def score_coco_files(pred_json_path: str, ann_json_path: str,
                     max_items: int | None = None) -> dict:
    """Score a prediction JSON (as written by runners.eval_coco) against an
    instances_val2017.json-style annotation file."""
    with open(ann_json_path) as f:
        gt = json.load(f)
    with open(pred_json_path) as f:
        detections = json.load(f)
    return evaluate_detections(gt, detections, max_items=max_items)


def format_metrics(m: dict) -> str:
    rows = [
        ("Average Precision  (AP) @[ IoU=0.50:0.95 | area=   all ]", "AP"),
        ("Average Precision  (AP) @[ IoU=0.50      | area=   all ]", "AP50"),
        ("Average Precision  (AP) @[ IoU=0.75      | area=   all ]", "AP75"),
        ("Average Precision  (AP) @[ IoU=0.50:0.95 | area= small ]",
         "APsmall"),
        ("Average Precision  (AP) @[ IoU=0.50:0.95 | area=medium ]",
         "APmedium"),
        ("Average Precision  (AP) @[ IoU=0.50:0.95 | area= large ]",
         "APlarge"),
        ("Average Recall     (AR) @[ maxDets=  1   | area=   all ]", "AR1"),
        ("Average Recall     (AR) @[ maxDets= 10   | area=   all ]", "AR10"),
        ("Average Recall     (AR) @[ maxDets=100   | area=   all ]", "AR100"),
        ("Average Recall     (AR) @[ IoU=0.50:0.95 | area= small ]",
         "ARsmall"),
        ("Average Recall     (AR) @[ IoU=0.50:0.95 | area=medium ]",
         "ARmedium"),
        ("Average Recall     (AR) @[ IoU=0.50:0.95 | area= large ]",
         "ARlarge"),
    ]
    return "\n".join(f"{label} = {m[key]:.3f}" for label, key in rows)
