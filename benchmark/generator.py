"""The general request generator. A traffic mix is a JSON file
`benchmark/traffic/<mix>.json` of parameters that this module reads; the
mix's `driver` names the entry of the program the window drives
(`benchmark/drivers/<driver>.py`), and its `why` says what it stands for.

Requests are grounding prompts on seeded synthetic images. Everything is a
function of (seed, request index), so the same seed gives the same stream:

- images: a pool of `image_pool` distinct uniform-noise RGB images of the
  mix's size, request i taking image i mod pool;
- box counts: the integers of `boxes` [lo, hi], each block of hi - lo + 1
  requests holding every count once in a seeded order (every seed does the
  same work, in another order);
- boxes: seeded corners inside the image, sides 5-40% of the image's;
- budgets: `max_new_tokens` fixed, or `loguniform` [lo, hi] as the
  (k + 0.5) / block quantiles, one block of `block` requests holding each
  once in a seeded order.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
from PIL import Image

_HERE = os.path.dirname(os.path.abspath(__file__))


def load_mix(name: str, root: str | None = None) -> dict:
    path = os.path.join(root or os.path.dirname(_HERE), "benchmark",
                        "traffic", f"{name}.json")
    with open(path) as f:
        return json.load(f)


def budget_block(spec: dict) -> list[int]:
    """The budgets of one block, in quantile order."""
    if spec["dist"] == "fixed":
        return [int(spec["value"])]
    lo, hi, n = math.log(spec["min"]), math.log(spec["max"]), spec["block"]
    return [int(round(math.exp(lo + (k + 0.5) / n * (hi - lo))))
            for k in range(n)]


class Requests:
    """The request stream of one mix and seed; `stream` separates the
    warm-up's requests from the window's."""

    def __init__(self, mix: dict, seed: int, stream: int = 0):
        self.mix, self.seed, self.stream = mix, int(seed), int(stream)
        w, h = mix["image"]["width"], mix["image"]["height"]
        self.size = (w, h)
        self._images = [None] * int(mix["image_pool"])
        lo, hi = mix["boxes"]
        self._box_values = np.arange(lo, hi + 1)
        self._budgets = np.asarray(budget_block(mix["max_new_tokens"]))

    def _rng(self, *tags):
        return np.random.default_rng([self.seed, self.stream, *tags])

    def image(self, i: int) -> Image.Image:
        k = i % len(self._images)
        if self._images[k] is None:
            w, h = self.size
            self._images[k] = Image.fromarray(
                self._rng(1, k).integers(0, 256, (h, w, 3), np.uint8))
        return self._images[k]

    def fill(self) -> None:
        """Make every image of the pool now (set-up, not the window)."""
        for k in range(len(self._images)):
            self.image(k)

    def box_count(self, i: int) -> int:
        n = len(self._box_values)
        return int(self._rng(2, i // n).permutation(self._box_values)[i % n])

    def budget(self, i: int) -> int:
        n = len(self._budgets)
        return int(self._rng(3, i // n).permutation(self._budgets)[i % n])

    def boxes(self, i: int, n: int) -> list[list[float]]:
        w, h = self.size
        rng = self._rng(4, i)
        side = rng.uniform(0.05, 0.4, (n, 2)) * [w, h]
        x1 = rng.uniform(0, 1, n) * (w - side[:, 0])
        y1 = rng.uniform(0, 1, n) * (h - side[:, 1])
        out = np.stack([x1, y1, x1 + side[:, 0], y1 + side[:, 1]], 1)
        return np.round(out, 1).tolist()

    def request(self, i: int, n_boxes: int | None = None) -> dict:
        """Request i: {"id", "image", "boxes", "question",
        "max_new_tokens"}; n_boxes overrides the drawn count (warm-up)."""
        n = self.box_count(i) if n_boxes is None else n_boxes
        return {"id": i, "image": self.image(i), "boxes": self.boxes(i, n),
                "question": self.mix["question"],
                "max_new_tokens": self.budget(i)}


def messages(req: dict) -> list[dict]:
    """The request as the chat message the program takes."""
    return [{"role": "user",
             "content": [{"type": "image_url",
                          "image_url": {"url": req["image"]}},
                         {"type": "text", "text": req["question"]}],
             "bbox_list": req["boxes"]}]
