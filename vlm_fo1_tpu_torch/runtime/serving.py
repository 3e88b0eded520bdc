"""Pipelined serving (counterpart of `vlm_fo1_tpu/runtime/serving.py`):
host preparation overlaps device work.

  stage H (host, thread pool): `FO1Model.prepare`: image decode, resizes,
          patchify, tokens, window plans, M-RoPE ids; numpy only.
  stage D (device): `launch_batch`: batched encode, splice, prefill and the
          first decode graph, enqueued without a host wait.
  stage F (host): `finish_batch`: the remaining decode graphs, the tokens,
          the text.

While the card runs batch i, the pool prepares batch i+1 and the main thread
enqueues it. `max_in_flight` bounds the launched but unfinished batches (each
holds a decode program and its KV cache).

`ServingPipeline` serves FIFO or grouped by image geometry;
`UPNFO1Pipeline` puts UPN proposals in front of FO1; `ContinuousServingPipeline`
refills finished rows of a decode session between chunks.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterable

import numpy as np
import torch


@dataclass
class ServingOptions:
    batch_size: int = 8
    max_new_tokens: int = 512
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0
    max_pixels: int | None = None
    eos_token_id: int | None = None
    prepare_workers: int = 4
    max_in_flight: int = 2  # launched-but-unfinished batches
    # ship one smart-resized uint8 image per request; patchify, window pad
    # and the aux squash run on the device (`FO1Model.prepare`)
    device_preproc: bool = True
    # group prepared requests by image grid so same-geometry batches stack;
    # run() restores input order
    geometry_group: bool = True
    # coarser smart-resize rounding (px, a multiple of 28; None = 28)
    geometry_factor: int | None = None
    # with geometry_group: launch the largest partial group once this many
    # batches' worth of requests are buffered
    max_buffered_batches: int = 4
    # a launch or finish that fails for lack of device memory (a shared
    # card) is retried after a backoff, up to this many times; each retry is
    # counted in stats["retries"]
    max_retries: int = 2
    retry_backoff_s: float = 30.0


@dataclass
class _Launched:
    handle: dict
    indices: list[int]
    preps: list | None = None  # kept for a relaunch after a failed finish


def _transient(err: Exception) -> bool:
    """The failure a retry can cure: the card ran out of memory."""
    return isinstance(err, torch.cuda.OutOfMemoryError)


class ServingPipeline:
    """Throughput front end for FO1Model: run(messages_list) returns
    results in input order, equal to `FO1Model.generate_batch` over the same
    batches (the same device programs, other host scheduling)."""

    def __init__(self, model, options: ServingOptions | None = None):
        self.model = model
        self.opts = options or ServingOptions()
        # per run: requests / batches / fused_batches / partial_batches /
        # retries / grids, so traffic that misses the stacked path shows
        self.stats: dict = {}

    def run(self, messages_list: list[list[dict]]) -> list:
        results: list = [None] * len(messages_list)
        for i, r in self.run_stream(messages_list):
            results[i] = r
        return results

    def run_stream(self, messages_iter: Iterable[list[dict]]):
        """Yields (index, GenerationResult) while later requests are still
        being prepared or run. FIFO mode yields in submission order; grouped
        mode may reorder across grids."""
        self.stats = {"requests": 0, "batches": 0, "fused_batches": 0,
                      "partial_batches": 0, "retries": 0, "grids": {}}
        if self.opts.geometry_group:
            yield from self._run_stream_grouped(messages_iter)
        else:
            yield from self._run_stream_fifo(messages_iter)

    def _launch_with_retry(self, preps):
        for attempt in range(self.opts.max_retries + 1):
            try:
                return self.model.launch_batch(
                    preps, max_new_tokens=self.opts.max_new_tokens,
                    temperature=self.opts.temperature, top_p=self.opts.top_p,
                    seed=self.opts.seed,
                    eos_token_id=self.opts.eos_token_id)
            except Exception as e:
                if not _transient(e) or attempt == self.opts.max_retries:
                    raise
                self.stats["retries"] += 1
                time.sleep(self.opts.retry_backoff_s)
        raise AssertionError("unreachable")

    def _finish_with_retry(self, launched: _Launched):
        """finish_batch with the same policy: a failure at the finish needs
        the batch launched again, from its preps."""
        for attempt in range(self.opts.max_retries + 1):
            try:
                return self.model.finish_batch(launched.handle)
            except Exception as e:
                if (not _transient(e) or attempt == self.opts.max_retries
                        or launched.preps is None):
                    raise
                self.stats["retries"] += 1
                time.sleep(self.opts.retry_backoff_s)
                launched.handle = self._launch_with_retry(launched.preps)
        raise AssertionError("unreachable")

    def _prepare(self, pool, msgs):
        opts = self.opts
        return pool.submit(self.model.prepare, msgs,
                           max_pixels=opts.max_pixels,
                           device_preproc=opts.device_preproc,
                           geometry_factor=opts.geometry_factor)

    def _record_launch(self, preps) -> None:
        st = self.stats
        st["batches"] += 1
        st["requests"] += len(preps)
        if self.model._fusable(preps):
            st["fused_batches"] += 1
        if len(preps) < self.opts.batch_size:
            st["partial_batches"] += 1
        for p in preps:
            key = "x".join(str(int(g)) for g in p["grid"])
            st["grids"][key] = st["grids"].get(key, 0) + 1

    def _run_stream_fifo(self, messages_iter: Iterable[list[dict]]):
        opts = self.opts
        it = enumerate(messages_iter)
        # prepare batches ahead of need, so the main thread does not stall
        # on host preparation between device batches
        prefetch_depth = opts.max_in_flight + 2

        with ThreadPoolExecutor(max_workers=opts.prepare_workers) as pool:
            pending: deque = deque()    # (indices, prepare futures)
            in_flight: deque = deque()  # launched batches
            done = False

            def submit_prepare():
                nonlocal done
                idxs, futs = [], []
                for _ in range(opts.batch_size):
                    try:
                        i, msgs = next(it)
                    except StopIteration:
                        done = True
                        break
                    idxs.append(i)
                    futs.append(self._prepare(pool, msgs))
                if idxs:
                    pending.append((idxs, futs))

            while not done and len(pending) < prefetch_depth:
                submit_prepare()
            while pending or in_flight:
                while pending and len(in_flight) <= opts.max_in_flight:
                    idxs, futs = pending.popleft()
                    preps = [f.result() for f in futs]
                    self._record_launch(preps)
                    handle = self._launch_with_retry(preps)
                    in_flight.append(_Launched(handle, idxs, preps))
                    if not done:
                        submit_prepare()
                launched = in_flight.popleft()
                for i, r in zip(launched.indices,
                                self._finish_with_retry(launched)):
                    yield i, r

    def _run_stream_grouped(self, messages_iter: Iterable[list[dict]]):
        """Prepared requests bucket by image grid; a bucket launches when it
        fills to batch_size. With max_buffered_batches * batch_size
        requests buffered and no full bucket, the largest launches partial;
        every launch is recorded in self.stats."""
        opts = self.opts
        it = enumerate(messages_iter)
        target = opts.batch_size * (opts.max_in_flight + 2)
        max_buffered = opts.batch_size * opts.max_buffered_batches

        with ThreadPoolExecutor(max_workers=opts.prepare_workers) as pool:
            futs: deque = deque()       # (index, future) in submit order
            buckets: dict = {}          # grid key -> list[(index, prep)]
            in_flight: deque = deque()
            done = False

            def pump():
                nonlocal done
                while not done and len(futs) < target:
                    try:
                        i, msgs = next(it)
                    except StopIteration:
                        done = True
                        return
                    futs.append((i, self._prepare(pool, msgs)))

            def drain(block: bool) -> bool:
                """Move resolved futures into buckets; with block=True wait
                for the head one. Returns True if any moved."""
                moved = False
                while futs and (futs[0][1].done() or (block and not moved)):
                    i, f = futs.popleft()
                    prep = f.result()
                    key = tuple(int(g) for g in prep["grid"])
                    buckets.setdefault(key, []).append((i, prep))
                    moved = True
                return moved

            def ready_key():
                full = [k for k, v in buckets.items()
                        if len(v) >= opts.batch_size]
                if full:
                    return full[0]
                buffered = sum(len(v) for v in buckets.values())
                drained = done and not futs and buckets
                if buffered >= max_buffered or drained:
                    return max(buckets, key=lambda k: len(buckets[k]))
                return None

            def launch(key):
                items = buckets[key][:opts.batch_size]
                buckets[key] = buckets[key][opts.batch_size:]
                if not buckets[key]:
                    del buckets[key]
                preps = [p for _, p in items]
                self._record_launch(preps)
                handle = self._launch_with_retry(preps)
                in_flight.append(_Launched(handle, [i for i, _ in items],
                                           preps))

            pump()
            while futs or buckets or in_flight:
                pump()
                drain(block=False)
                while len(in_flight) <= opts.max_in_flight:
                    key = ready_key()
                    if key is None:
                        break
                    launch(key)
                    pump()
                    drain(block=False)
                if in_flight:
                    launched = in_flight.popleft()
                    for i, r in zip(launched.indices,
                                    self._finish_with_retry(launched)):
                        yield i, r
                elif futs:
                    drain(block=True)


@dataclass
class UPNFO1Options:
    """Options of the UPN proposals -> FO1 pipeline."""
    batch_size: int = 4
    device_preproc: bool = True
    min_score: float = 0.3
    nms_value: float = 0.8
    max_boxes: int = 100           # the reference keeps 100 proposals
    max_new_tokens: int = 64
    max_pixels: int | None = None
    eos_token_id: int | None = None
    temperature: float = 0.0
    top_p: float = 1.0
    prepare_workers: int = 4


class UPNFO1Pipeline:
    """Proposals, then grounding, both batched: the FO1 batch of requests i
    is launched before the UPN forward of requests i+1 is enqueued, and
    finished after it, so the card stays busy while the host filters
    proposals, assembles prompts and parses answers.

    run(requests) -> list of {text, fo1_bboxes, proposals, scores} in input
    order; each request is {"image": path or PIL image, "text": question}.
    """

    def __init__(self, upn, fo1, options: UPNFO1Options | None = None):
        self.upn = upn
        self.fo1 = fo1
        self.opts = options or UPNFO1Options()

    def _stage_upn(self, reqs):
        opts = self.opts
        raw = self.upn.inference([r["image"] for r in reqs],
                                 batch_size=opts.batch_size)
        det = self.upn.filter(raw, min_score=opts.min_score,
                              nms_value=opts.nms_value)
        bbox_lists = [
            [[float(v) for v in b] for b in boxes[:opts.max_boxes]]
            for boxes in det["original_xyxy_boxes"]]
        scores = [s[:opts.max_boxes] for s in det["scores"]]
        msgs = [[{
            "role": "user",
            "content": [
                {"type": "image_url", "image_url": {"url": r["image"]}},
                {"type": "text", "text": r["text"]},
            ],
            "bbox_list": bl,
        }] for r, bl in zip(reqs, bbox_lists)]
        return msgs, bbox_lists, scores

    def run(self, requests: list[dict]) -> list[dict]:
        from vlm_fo1_tpu_torch.postprocess import (
            extract_predictions_to_bboxes,
        )

        opts = self.opts
        out: list[dict] = []
        with ThreadPoolExecutor(max_workers=opts.prepare_workers) as pool:
            chunks = [requests[i:i + opts.batch_size]
                      for i in range(0, len(requests), opts.batch_size)]
            prev = None  # (fo1 handle, bbox_lists, scores)
            for chunk in chunks + [None]:
                nxt = None
                if chunk is not None:
                    msgs, bls, scs = self._stage_upn(chunk)
                    futs = [pool.submit(self.fo1.prepare, m,
                                        max_pixels=opts.max_pixels,
                                        device_preproc=opts.device_preproc)
                            for m in msgs]
                    preps = [f.result() for f in futs]
                    handle = self.fo1.launch_batch(
                        preps, max_new_tokens=opts.max_new_tokens,
                        temperature=opts.temperature, top_p=opts.top_p,
                        eos_token_id=opts.eos_token_id)
                    nxt = (handle, bls, scs)
                if prev is not None:
                    handle, bls, scs = prev
                    for res, bl, sc in zip(self.fo1.finish_batch(handle),
                                           bls, scs):
                        out.append({
                            "text": res.text,
                            "fo1_bboxes": extract_predictions_to_bboxes(
                                res.text, bl),
                            "proposals": bl,
                            "scores": sc,
                        })
                prev = nxt
        return out


@dataclass
class ContinuousOptions:
    """Options of continuous-batching serving (slot refill)."""
    batch_size: int = 8
    chunk: int = 32               # decode steps between refill points
    refill_size: int = 0          # 0 -> batch_size // 4 (at least 1);
    # refills are padded to this size, so one program shape serves them
    max_new_tokens: int = 512     # cache budget; per-request budgets <= this
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0
    max_pixels: int | None = None
    eos_token_id: int | None = None
    prepare_workers: int = 4
    device_preproc: bool = True
    geometry_factor: int | None = None


class ContinuousServingPipeline:
    """Serving with slot refill: the batch-synchronous path holds all B rows
    until every row is done; here decode runs in `chunk`-step graphs and
    finished rows take the next prepared request between chunks
    (`FO1Model.start_session` / `decode_session_chunk` /
    `refill_session`). Per-request `max_new_tokens` budgets are exact.

    run(requests) -> results in input order; a request is a messages list
    or {"messages": ..., "max_new_tokens": int}.

    stats: requests / chunks / refills / device_steps (decode steps that
    ran while some row was live, the work a batch-synchronous run of the
    same traffic pays sum(max(lens per batch)) for) / dummy_rows.
    """

    def __init__(self, model, options: ContinuousOptions | None = None):
        self.model = model
        self.opts = options or ContinuousOptions()
        self.stats: dict = {}

    @staticmethod
    def _split(req):
        if isinstance(req, dict) and "messages" in req:
            return req["messages"], req.get("max_new_tokens")
        return req, None

    def run(self, requests: list) -> list:
        from vlm_fo1_tpu_torch.models.fo1 import GenerationResult
        from vlm_fo1_tpu_torch.runtime.generate import decode_to_text

        opts = self.opts
        model = self.model
        refill = opts.refill_size or max(1, opts.batch_size // 4)
        self.stats = {"requests": len(requests), "chunks": 0, "refills": 0,
                      "device_steps": 0, "dummy_rows": 0}

        with ThreadPoolExecutor(max_workers=opts.prepare_workers) as pool:
            futs = [
                pool.submit(model.prepare, self._split(r)[0],
                            max_pixels=opts.max_pixels,
                            device_preproc=opts.device_preproc,
                            geometry_factor=opts.geometry_factor)
                for r in requests]
            maxes = [self._split(r)[1] or opts.max_new_tokens
                     for r in requests]
            results: list = [None] * len(requests)
            tokens_acc: dict[int, list] = {}   # request index -> token ids
            nxt = 0

            def take(n):
                nonlocal nxt
                idxs = list(range(nxt, min(nxt + n, len(requests))))
                nxt += len(idxs)
                return idxs, [futs[i].result() for i in idxs]

            b = min(opts.batch_size, len(requests))
            idxs, preps = take(b)
            sess = model.start_session(
                preps, max_new_tokens=opts.max_new_tokens,
                row_max=[maxes[i] for i in idxs],
                temperature=opts.temperature, top_p=opts.top_p,
                seed=opts.seed, eos_token_id=opts.eos_token_id,
                chunk=opts.chunk)
            try:
                slot_req = list(idxs)          # slot -> request (or -1)
                tok0_h = sess["tok0"].cpu().numpy()
                for s, i in enumerate(slot_req):
                    tokens_acc[i] = [int(tok0_h[s])]
                # rows whose very first token finished them
                done_h = sess["done"].cpu().numpy().copy()

                def finalize(slot):
                    i = slot_req[slot]
                    if i < 0:
                        return
                    toks = np.asarray(tokens_acc[i], np.int64)
                    out = toks
                    eos = sess["eos"]
                    if eos in out.tolist():
                        out = out[:out.tolist().index(eos)]
                    out = model._trim_stop_tail(out, sess["stop_sequences"])
                    text = ""
                    if model.tokenizer is not None:
                        text = decode_to_text(model.tokenizer, toks, eos)
                    results[i] = GenerationResult(
                        text=text, token_ids=out,
                        prompt_len=int(sess["seq_lens"][slot]),
                        num_steps=len(toks), prefill_logits=None)
                    slot_req[slot] = -1

                while True:
                    live = [s for s, i in enumerate(slot_req) if i >= 0]
                    if not live:
                        break
                    if not done_h.all():
                        toks_d, prev_d, steps_d = model.decode_session_chunk(
                            sess)
                        self.stats["chunks"] += 1
                        toks = toks_d.cpu().numpy()
                        prev = prev_d.cpu().numpy()
                        new = sess["row_steps"].cpu().numpy()
                        done_h = sess["done"].cpu().numpy().copy()
                        self.stats["device_steps"] += int(steps_d)
                        for s in live:
                            cnt = int(new[s] - prev[s])
                            if cnt > 0:
                                tokens_acc[slot_req[s]].extend(
                                    int(t) for t in toks[s, :cnt])
                    for s in live:   # retire finished rows
                        if done_h[s]:
                            finalize(s)
                    free = [s for s, i in enumerate(slot_req) if i < 0]
                    # refill in fixed-size groups (one program shape)
                    while len(free) >= refill and nxt < len(requests):
                        idxs, preps = take(refill)
                        g = len(idxs)
                        slots = free[:refill]
                        free = free[refill:]
                        if g < refill:   # pad the last group with dummies
                            preps = preps + [preps[-1]] * (refill - g)
                            self.stats["dummy_rows"] += refill - g
                        row_max = [maxes[i] for i in idxs] + [1] * (refill
                                                                   - g)
                        tok0 = model.refill_session(sess, preps, slots,
                                                    row_max=row_max)
                        self.stats["refills"] += 1
                        tok0_h = tok0.cpu().numpy()
                        done_h = sess["done"].cpu().numpy().copy()
                        for j, s in enumerate(slots):
                            if j < g:
                                slot_req[s] = idxs[j]
                                tokens_acc[idxs[j]] = [int(tok0_h[j])]
                            else:
                                slot_req[s] = -1   # dummy row: let it die
                    # rows that arrived done (tok0 == eos or row_max 1)
                    for s in range(len(slot_req)):
                        if slot_req[s] >= 0 and done_h[s]:
                            finalize(s)
            finally:
                model.close_session(sess)
        return results
