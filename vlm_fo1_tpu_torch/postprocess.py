"""Output parsing and visualization (reference mm_utils.py:230-369)."""

from __future__ import annotations

import re
from typing import List, Tuple

from PIL import Image, ImageDraw

_GROUND_PATTERN = re.compile(r"<ground>(.*?)<\/ground><objects>(.*?)<\/objects>")
_REGION_PATTERN = re.compile(r"<region(\d+)>")


def extract_predictions_to_indexes(prediction: str) -> dict[str, set[int]]:
    """Parse `<ground>label</ground><objects><region3>...</objects>` markup
    into {label: set of region indexes}."""
    label_to_indexes: dict[str, set[int]] = {}
    for label_text, indexes in _GROUND_PATTERN.findall(prediction):
        label_text = label_text.strip()
        found = {int(m) for m in _REGION_PATTERN.findall(indexes)}
        label_to_indexes.setdefault(label_text, set()).update(found)
    return label_to_indexes


def extract_predictions_to_bboxes(prediction: str, bbox_list) -> dict[str, list]:
    """Map parsed region indexes back to their bounding boxes."""
    out = {}
    for label, indexes in extract_predictions_to_indexes(prediction).items():
        out[label] = [bbox_list[i] for i in indexes if 0 <= i < len(bbox_list)]
    return out


def strip_region_tokens(text: str) -> str:
    """Remove `<regionN>` tags (used by the counting evaluator,
    reference eval_countbench.py:48-53)."""
    return _REGION_PATTERN.sub("", text)


def first_integer(text: str):
    """First integer in a string, or None (counting answer extraction)."""
    m = re.search(r"-?\d+", text)
    return int(m.group()) if m else None


def draw_bboxes_and_save(
    image: Image.Image,
    fo1_bboxes: dict | None = None,
    detection_bboxes: List[Tuple[int, int, int, int]] | None = None,
    output_path: str = "output.jpg",
    color: str = "red",
    total_color: str = "green",
    width: int = 2,
) -> None:
    """Draw labelled model boxes (red) and proposal boxes (green), save JPEG."""
    draw = ImageDraw.Draw(image)
    for bbox in detection_bboxes or []:
        if len(bbox) != 4:
            continue
        draw.rectangle([(bbox[0], bbox[1]), (bbox[2], bbox[3])],
                       outline=total_color, width=width)
    for label, bbox_list in (fo1_bboxes or {}).items():
        for bbox in bbox_list:
            if len(bbox) != 4:
                continue
            draw.rectangle([(bbox[0], bbox[1]), (bbox[2], bbox[3])],
                           outline=color, width=width)
            draw.text((bbox[0], bbox[1]), label, fill=color)
    try:
        image.save(output_path)
    except IOError as e:
        print(f"failed to save image to {output_path}: {e}")
