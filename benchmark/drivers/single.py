"""`FO1Model.generate`: one client, the next request sent when the
previous one returns. The warm-up runs two requests in every prompt bucket
the mix's box counts reach (one decode program each)."""

from __future__ import annotations

import time

from benchmark.drivers import prompt_buckets
from benchmark.generator import messages


class Driver:
    def __init__(self, model, mix: dict):
        self.model, self.mix = model, mix
        self.max_new = mix["max_new_tokens"]["value"]

    def warmup(self, warm) -> None:
        for n in prompt_buckets(self.model, self.mix, warm).values():
            for i in range(2):
                self.model.generate(messages(warm.request(i, n)),
                                    max_new_tokens=self.max_new)

    def spans(self, tracer, cfg) -> None:
        m = self.model
        tracer.wrap(m, "prepare", "prepare")
        tracer.wrap(m, "_launch_fused", "launch", info=lambda a, k: {
            "lengths": [p["splice"].seq_len for p in a[0]],
            "grid": tuple(int(g) for g in a[0][0]["grid"])})
        tracer.wrap(m, "finish_batch", "finish")
        tracer.wrap(m, "generate", "generate")

    def window(self, reqs, seconds: float, clock=time.perf_counter):
        records = []
        t_end = clock() + seconds
        i = 0
        while clock() < t_end:
            req = reqs.request(i)
            t0 = clock()
            res = self.model.generate(messages(req),
                                      max_new_tokens=self.max_new)
            records.append({"req": req, "t_sent": t0, "t_done": clock(),
                            "result": res})
            i += 1
        return records, {"batch_size": 1}
