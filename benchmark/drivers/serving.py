"""`ServingPipeline.run_stream` over a request iterator of
`work(seconds, offered_per_s, batch)` requests. The warm-up captures
`max_in_flight + 1` decode programs for every prompt bucket the mix's box
counts reach."""

from __future__ import annotations

import time

from benchmark.drivers import prompt_buckets, work
from benchmark.generator import messages


class Driver:
    def __init__(self, model, mix: dict):
        from vlm_fo1_tpu_torch.runtime.serving import ServingOptions

        self.model, self.mix = model, mix
        s = mix["serving"]
        self.opts = ServingOptions(
            batch_size=s["batch_size"],
            max_new_tokens=mix["max_new_tokens"]["value"],
            temperature=0.0, prepare_workers=s["prepare_workers"],
            max_in_flight=s["max_in_flight"],
            device_preproc=s["device_preproc"],
            geometry_group=s["geometry_group"])

    def warmup(self, warm) -> None:
        model, o = self.model, self.opts
        for n in prompt_buckets(model, self.mix, warm).values():
            preps = [model.prepare(messages(warm.request(i, n)),
                                   device_preproc=o.device_preproc)
                     for i in range(o.batch_size)]
            handles = [model.launch_batch(preps,
                                          max_new_tokens=o.max_new_tokens)
                       for _ in range(o.max_in_flight + 1)]
            for h in handles:
                model.finish_batch(h)

    def spans(self, tracer, cfg) -> None:
        m = self.model
        tracer.wrap(m, "prepare", "prepare")
        tracer.wrap(m, "launch_batch", "launch", info=lambda a, k: {
            "lengths": [p["splice"].seq_len for p in a[0]],
            "grid": tuple(int(g) for g in a[0][0]["grid"])})
        tracer.wrap(m, "finish_batch", "finish")

    def window(self, reqs, seconds: float, clock=time.perf_counter):
        from vlm_fo1_tpu_torch.runtime.serving import ServingPipeline

        b = self.opts.batch_size
        pipe = ServingPipeline(self.model, self.opts)
        records = []
        total = work(seconds, self.mix["serving"]["offered_per_s"], b)

        def stream():
            i = 0
            while i < total:
                rec = {"req": reqs.request(i), "t_sent": clock(),
                       "t_done": None, "result": None}
                records.append(rec)
                yield messages(rec["req"])
                i += 1

        for i, res in pipe.run_stream(stream()):
            records[i]["result"] = res
            records[i]["t_done"] = clock()
        return records, dict(pipe.stats, batch_size=b)
