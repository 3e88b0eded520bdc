"""Evaluation runners (counterpart of `vlm_fo1_tpu/evaluation/runners.py`):
CountBench / Pixmo-Count accuracy and COCO detection predictions over the
port's `FO1Model` and `runtime/serving.py`.

Both consume the frozen `*_with_upn_score_0.3_0.8` files (precomputed UPN
proposals and scores), so FO1's quality is measured apart from the proposal
stage. The COCO runner writes COCO-format prediction JSON with the UPN
proposal score as the detection confidence; `coco_map` scores it.

    python -m vlm_fo1_tpu_torch.evaluation.runners countbench --model-path DIR \
        --data-path FILE --image-path DIR [--device cpu]
    python -m vlm_fo1_tpu_torch.evaluation.runners coco --model-path DIR \
        --eval-data-path FILE --original-data-path FILE --img-folder DIR \
        --out-path FILE [--score] [--device cpu]
    python -m vlm_fo1_tpu_torch.evaluation.runners score --pred-path FILE \
        --ann-path FILE

The model runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import json
import os
import re
import time

from vlm_fo1_tpu_torch.postprocess import extract_predictions_to_indexes


def _build_messages(image_path, question, bbox_list):
    return [{
        "role": "user",
        "content": [
            {"type": "image_url", "image_url": {"url": image_path}},
            {"type": "text", "text": question},
        ],
        "bbox_list": bbox_list,
    }]


def extract_count(outputs: str) -> int:
    """First integer after stripping <regionN> tags; 0 if none
    (reference eval_countbench.py:48-53)."""
    ans = re.sub(r"<region\d+>", "", outputs)
    numbers = re.findall(r"(?<!region)\d+", ans)
    return int(numbers[0]) if numbers else 0


def eval_countbench(model, data_path: str, image_path: str,
                    max_items: int | None = None, max_new_tokens: int = 4096,
                    verbose: bool = True, batch_size: int = 1,
                    pipelined: bool = False) -> dict:
    """Exact-match counting accuracy. Returns summary dict with per-item
    predictions.

    batch_size > 1 runs generate_batch over chunks (ragged prompts share a
    prefill bucket; same-geometry images share one encode), where the
    reference loops one item at a time. pipelined=True also overlaps host
    preparation with device work through runtime.serving.ServingPipeline."""
    with open(data_path) as f:
        data = json.load(f)
    if max_items:
        data = data[:max_items]

    msgs_of = lambda item: _build_messages(  # noqa: E731
        os.path.join(image_path, item["image"]), item["question"],
        item["bboxes"])

    preds, gts, latencies = [], [], []
    if pipelined and batch_size > 1:
        from vlm_fo1_tpu_torch.runtime.serving import (
            ServingOptions,
            ServingPipeline,
        )

        pipe = ServingPipeline(model, ServingOptions(
            batch_size=batch_size, max_new_tokens=max_new_tokens,
            temperature=0.0, top_p=0.05,
            prepare_workers=8, max_in_flight=3))
        t0 = time.time()
        results = pipe.run([msgs_of(item) for item in data])
        latencies = [(time.time() - t0) / max(len(data), 1)] * len(data)
        pairs = zip(data, results)
    else:
        pairs = []
        for start in range(0, len(data), batch_size):
            chunk = data[start:start + batch_size]
            msgs_list = [msgs_of(item) for item in chunk]
            t0 = time.time()
            if batch_size == 1:
                results = [model.generate(msgs_list[0],
                                          max_new_tokens=max_new_tokens,
                                          top_p=0.05, temperature=0.0)]
            else:
                results = model.generate_batch(msgs_list,
                                               max_new_tokens=max_new_tokens,
                                               top_p=0.05, temperature=0.0)
            latencies.extend([(time.time() - t0) / len(chunk)] * len(chunk))
            pairs.extend(zip(chunk, results))
    for item, result in pairs:
        pred = extract_count(result.text)
        preds.append(pred)
        gts.append(item["answer"])
        if verbose and pred != item["answer"]:
            print(f"gt={item['answer']} pred_text={result.text[:120]!r}")

    correct = sum(1 for p, g in zip(preds, gts) if p == g)
    acc = correct / len(preds) if preds else 0.0
    return {"accuracy": acc, "correct": correct, "total": len(preds),
            "predictions": preds, "ground_truth": gts,
            "mean_latency_s": sum(latencies) / max(len(latencies), 1)}


def eval_coco(model, eval_data_path: str, original_data_path: str,
              img_folder: str, out_path: str,
              max_items: int | None = None,
              max_new_tokens: int = 4096, batch_size: int = 1,
              pipelined: bool = False) -> list[dict]:
    """Per-image generation with precomputed UPN proposals -> COCO-format
    detection records (confidence = the proposal score). batch_size > 1
    uses generate_batch per chunk; pipelined=True overlaps host preparation
    with device work."""
    data_list = []
    with open(eval_data_path) as f:
        for line in f:
            data_list.append(json.loads(line))
    if max_items:
        data_list = data_list[:max_items]

    with open(original_data_path) as f:
        original = json.load(f)
    cat_to_id = {c["name"]: c["id"] for c in original["categories"]}

    res_list = []
    if pipelined and batch_size > 1:
        from vlm_fo1_tpu_torch.runtime.serving import (
            ServingOptions,
            ServingPipeline,
        )

        pipe = ServingPipeline(model, ServingOptions(
            batch_size=batch_size, max_new_tokens=max_new_tokens,
            temperature=0.0, top_p=0.05,
            prepare_workers=8, max_in_flight=3))
        msgs_list = [
            _build_messages(os.path.join(img_folder, d["image"]),
                            d["conversations"][0]["value"], d["bbox_list"])
            for d in data_list]
        try:
            for i, result in pipe.run_stream(msgs_list):
                _collect_coco_records(data_list[i], result, cat_to_id,
                                      res_list)
        except Exception as e:  # keep partial results, as the reference
            print(f"pipelined sweep aborted: {e}")
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(res_list, f)
        return res_list
    for start in range(0, len(data_list), batch_size):
        chunk = data_list[start:start + batch_size]
        try:
            msgs_list = [
                _build_messages(os.path.join(img_folder, d["image"]),
                                d["conversations"][0]["value"],
                                d["bbox_list"])
                for d in chunk]
            if batch_size == 1:
                results = [model.generate(msgs_list[0],
                                          max_new_tokens=max_new_tokens,
                                          top_p=0.05, temperature=0.0)]
            else:
                results = model.generate_batch(
                    msgs_list, max_new_tokens=max_new_tokens,
                    top_p=0.05, temperature=0.0)
        except Exception as e:  # keep the sweep alive, as the reference
            print(f"error on batch at {start}: {e}")
            continue
        for data, result in zip(chunk, results):
            _collect_coco_records(data, result, cat_to_id, res_list)

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(res_list, f)
    return res_list


def _collect_coco_records(data, result, cat_to_id, res_list):
    image_id = data["id"]
    bbox_list = data["bbox_list"]
    score_list = data["score_list"]
    for label, idxs in extract_predictions_to_indexes(result.text).items():
        if label not in cat_to_id:
            continue
        for i in idxs:
            if not 0 <= i < len(bbox_list):
                continue
            x1, y1, x2, y2 = bbox_list[i]
            res_list.append({
                "image_id": image_id,
                "category_id": cat_to_id[label],
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "score": score_list[i],
            })


def _cli():
    """The reference evaluation scripts' command lines, with `--device`
    (the card unless `cpu` is asked for)."""
    import argparse

    ap = argparse.ArgumentParser(description="FO1 evaluation runners")
    sub = ap.add_subparsers(dest="task", required=True)

    cb = sub.add_parser("countbench")
    cb.add_argument("--model-path", required=True)
    cb.add_argument("--data-path", required=True)
    cb.add_argument("--image-path", required=True)
    cb.add_argument("--max-items", type=int, default=None)
    cb.add_argument("--batch-size", type=int, default=1)
    cb.add_argument("--pipelined", action="store_true")
    cb.add_argument("--device", default="cuda")

    cc = sub.add_parser("coco")
    cc.add_argument("--model-path", required=True)
    cc.add_argument("--eval-data-path", required=True)
    cc.add_argument("--original-data-path", required=True)
    cc.add_argument("--img-folder", required=True)
    cc.add_argument("--out-path", required=True)
    cc.add_argument("--max-items", type=int, default=None)
    cc.add_argument("--batch-size", type=int, default=1)
    cc.add_argument("--pipelined", action="store_true")
    cc.add_argument("--device", default="cuda")
    cc.add_argument("--score", action="store_true",
                    help="score the written predictions against "
                         "--original-data-path with the built-in mAP "
                         "evaluator (no pycocotools needed)")

    sc = sub.add_parser("score", help="score an existing COCO prediction "
                                      "JSON (no model load)")
    sc.add_argument("--pred-path", required=True)
    sc.add_argument("--ann-path", required=True)
    sc.add_argument("--max-items", type=int, default=None)

    args = ap.parse_args()
    if args.task == "score":
        from vlm_fo1_tpu_torch.evaluation.coco_map import (
            format_metrics,
            score_coco_files,
        )

        print(format_metrics(score_coco_files(
            args.pred_path, args.ann_path, max_items=args.max_items)))
        return
    import torch

    from vlm_fo1_tpu_torch.models.fo1 import FO1Model

    dtype = torch.float32 if args.device == "cpu" else torch.bfloat16
    model = FO1Model.from_pretrained(args.model_path, dtype=dtype,
                                     device=args.device)
    if args.task == "countbench":
        out = eval_countbench(model, args.data_path, args.image_path,
                              max_items=args.max_items,
                              batch_size=args.batch_size,
                              pipelined=args.pipelined)
        print(f"accuracy: {out['accuracy']:.4f} "
              f"({out['correct']}/{out['total']})")
    else:
        res = eval_coco(model, args.eval_data_path, args.original_data_path,
                        args.img_folder, args.out_path,
                        max_items=args.max_items, batch_size=args.batch_size,
                        pipelined=args.pipelined)
        print(f"wrote {len(res)} detection records to {args.out_path}")
        if args.score:
            from vlm_fo1_tpu_torch.evaluation.coco_map import (
                format_metrics,
                score_coco_files,
            )

            print(format_metrics(score_coco_files(
                args.out_path, args.original_data_path,
                max_items=args.max_items)))


if __name__ == "__main__":
    _cli()
