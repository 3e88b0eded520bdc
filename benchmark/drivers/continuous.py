"""`ContinuousServingPipeline.run` over groups of `group` requests, handed
over in generated order one after another, `work(...)` requests in all.

A group opens its session at the prompt bucket of its first `batch_size`
requests, and the program refuses a refill whose prompt is longer than
that bucket. A mix whose every group holds each box count (a group a
multiple of the box-count block) can therefore finish a group only in a
session at the top bucket its counts reach, so the warm-up captures that
session's programs (its decode chunk and refill shapes) and no other.
"""

from __future__ import annotations

import time

from benchmark.drivers import prompt_buckets, work
from benchmark.generator import messages


class Driver:
    def __init__(self, model, mix: dict):
        from vlm_fo1_tpu_torch.runtime.serving import ContinuousOptions

        self.model, self.mix = model, mix
        c = mix["continuous"]
        self.opts = ContinuousOptions(
            batch_size=c["batch_size"], chunk=c["chunk"],
            refill_size=c["refill_size"],
            max_new_tokens=mix["max_new_tokens"]["max"], temperature=0.0,
            prepare_workers=c["prepare_workers"],
            device_preproc=c["device_preproc"])
        self.group = c["group"]

    def _run(self, pipe, group):
        return pipe.run([{"messages": messages(r),
                          "max_new_tokens": r["max_new_tokens"]}
                         for r in group])

    def warmup(self, warm) -> None:
        from vlm_fo1_tpu_torch.runtime.serving import ContinuousServingPipeline

        o = self.opts
        pipe = ContinuousServingPipeline(self.model, o)
        buckets = prompt_buckets(self.model, self.mix, warm)
        n = buckets[max(buckets)]
        group = [dict(warm.request(i, n), max_new_tokens=3)
                 for i in range(o.batch_size + 2 * o.refill_size)]
        self._run(pipe, group)

    def spans(self, tracer, cfg) -> None:
        m = self.model
        tracer.wrap(m, "prepare", "prepare")
        tracer.wrap(m, "start_session", "start", post=lambda s, out: s[
            "info"].update(rows=out["batch"], pad=out["prompt_pad"]))
        tracer.wrap(m, "decode_session_chunk", "chunk",
                    info=lambda a, k: {"rows": a[0]["batch"]},
                    post=lambda s, out: s["info"].update(steps=out[2]))
        tracer.wrap(m, "refill_session", "refill", info=lambda a, k: {
            "rows": len(a[1]), "pad": a[0]["prompt_pad"]})

    def window(self, reqs, seconds: float, clock=time.perf_counter):
        from vlm_fo1_tpu_torch.runtime.serving import ContinuousServingPipeline

        pipe = ContinuousServingPipeline(self.model, self.opts)
        records, stats = [], {"groups": 0}
        total = work(seconds, self.mix["continuous"]["offered_per_s"],
                     self.group)
        for i in range(0, total, self.group):
            group = [reqs.request(j) for j in range(i, i + self.group)]
            t0 = clock()
            results = self._run(pipe, group)
            t1 = clock()
            records += [{"req": r, "t_sent": t0, "t_done": t1, "result": x}
                        for r, x in zip(group, results)]
            stats["groups"] += 1
            for k, v in pipe.stats.items():
                stats[k] = stats.get(k, 0) + v
        return records, dict(stats, batch_size=self.opts.batch_size)
