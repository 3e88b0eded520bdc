"""Non-maximum suppression on the host, the port's copy of
`nms_numpy` in `vlm_fo1_tpu/ops/nms.py` (torchvision.ops.nms semantics:
keep the highest-scoring box, drop boxes whose IoU with it is strictly
greater than the threshold). Used by `upn.wrapper.UPNWrapper.filter`."""

from __future__ import annotations

import numpy as np


def nms_numpy(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float
              ) -> np.ndarray:
    """boxes [N, 4] xyxy, scores [N] -> kept indices (score-descending)."""
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    order = np.argsort(-scores, kind="stable")
    x1, y1, x2, y2 = boxes.T
    areas = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        iou = inter / np.maximum(areas[i] + areas[rest] - inter, 1e-9)
        order = rest[iou <= iou_threshold]
    return np.asarray(keep, np.int64)
