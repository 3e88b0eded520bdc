"""The port's span and counter recorder (`runtime/trace.py`) on the CPU
with the tiny model: spans nest and carry their parent's id; one
`generate`, one `ServingPipeline.run` and one `ContinuousServingPipeline.run`
leave prepare, launch / session and finish / chunk spans that share each
request's id; the children of `launch` lie inside it; a disabled recorder
keeps nothing, and nothing opens during a graph capture; the ring
keeps its bound; `program_builds` counts program
cache misses; `serve.wait` appears only when a prepare is late; and under
`torch.profiler` each span lies inside its own `fo1.<name>#<id>` range (the
shared clock) and every span a profiler touched is marked `profiled`."""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch
from PIL import Image

from conftest import StubTokenizer
from vlm_fo1_tpu_torch.config import FO1Config
from vlm_fo1_tpu_torch.models.fo1 import FO1Model
from vlm_fo1_tpu_torch.runtime import serving, trace
from vlm_fo1_tpu_torch.runtime.generate import (
    GenerationConfig,
    acquire_program,
    release_program,
)

MAX_NEW = 4
LAUNCH_CHILDREN = {"upload", "vit", "davit", "region", "splice", "prefill",
                   "decode.first"}


@pytest.fixture(scope="module")
def model():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield FO1Model.random_init(FO1Config.tiny(), seed=3, device="cpu",
                               tokenizer=StubTokenizer())
    torch.set_num_threads(n)


def _messages(seed, n_boxes=2):
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 255, (64, 80, 3), np.uint8))
    return [{"role": "user",
             "content": [{"type": "image_url", "image_url": {"url": img}},
                         {"type": "text", "text": "Find the cup."}],
             "bbox_list": [[2.0 * i, 1.0 * i, 70.0 - i, 50.0 - i]
                           for i in range(n_boxes)]}]


def _since(t0_ns):
    return [s for s in trace.spans() if s.t0 >= t0_ns]


def test_spans_nest_and_carry_the_parent_id():
    rec = trace.Recorder()
    with rec.span("outer", reqs=(7,)) as outer:
        with rec.span("inner") as inner:
            with rec.span("leaf", reqs=(8,)) as leaf:
                pass
        with rec.span("sibling") as sibling:
            pass
    got = {s.name: s for s in rec.spans()}
    assert set(got) == {"outer", "inner", "leaf", "sibling"}
    assert outer.parent is None
    assert inner.parent == outer.id and sibling.parent == outer.id
    assert leaf.parent == inner.id
    assert inner.reqs == (7,) and leaf.reqs == (8,)
    for s in (inner, leaf, sibling):
        assert s.t0 >= outer.t0 and s.t1 <= outer.t1
    # another thread has its own stack: no parent there
    out = []
    with rec.span("main"):
        t = threading.Thread(target=lambda: out.append(
            rec.span("worker").__enter__()))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and out[0].parent is None


def _entry_spans(model, which):
    """The spans one entry point leaves, and the request ids it served."""
    t0 = time.time_ns()
    if which == "generate":
        model.generate(_messages(1), max_new_tokens=MAX_NEW)
    elif which == "serving":
        pipe = serving.ServingPipeline(model, serving.ServingOptions(
            batch_size=2, max_new_tokens=MAX_NEW, prepare_workers=2))
        pipe.run([_messages(i, 1 + i % 3) for i in range(4)])
    else:
        pipe = serving.ContinuousServingPipeline(
            model, serving.ContinuousOptions(
                batch_size=2, chunk=2, refill_size=1, max_new_tokens=6,
                prepare_workers=2))
        pipe.run([{"messages": _messages(10 + i), "max_new_tokens": mx}
                  for i, mx in enumerate([2, 6, 3, 5])])
    spans = _since(t0)
    rids = {s.reqs[0] for s in spans if s.name == "prepare"}
    return spans, rids


@pytest.mark.parametrize("which", ["generate", "serving", "continuous"])
def test_spans_of_one_request_share_its_id(model, which):
    spans, rids = _entry_spans(model, which)
    assert len(rids) == {"generate": 1}.get(which, 4)
    launch = {"launch", "start_session", "refill_session"}
    finish = {"finish", "cont.chunk"}
    for rid in rids:
        names = {s.name for s in spans if rid in s.reqs}
        assert {"prepare", "prepare.tokens", "prepare.pixels",
                "prepare.plan", "prepare.rope"} <= names, names
        assert names & launch and names & finish, names
        # the encode under a launch or a session start serves the request
        assert {"vit", "davit", "region", "prefill"} <= names, names
    threads = {s.thread for s in spans if s.name == "prepare"}
    if which != "generate":
        # prepared in the pool, launched on the calling thread
        assert threading.get_ident() not in threads
    if which == "continuous":
        chunks = [s for s in spans if s.name == "cont.chunk"]
        turns = [s for s in spans if s.name == "cont.turn"]
        # a turn is kept only where another chunk follows it
        assert len(chunks) >= 2 and len(turns) == len(chunks) - 1
        for turn in turns:
            assert any(c.t0 >= turn.t1 for c in chunks)
        assert [s for s in spans if s.name == "cont.readback"]
        refills = [s for s in spans if s.name == "cont.refill"]
        assert refills and all(s.device_ms is None for s in refills)


def test_children_of_launch_lie_inside_it(model):
    t0 = time.time_ns()
    model.generate(_messages(2), max_new_tokens=MAX_NEW)
    spans = _since(t0)
    (launch,) = [s for s in spans if s.name == "launch"]
    children = [s for s in spans if s.parent == launch.id]
    assert {s.name for s in children} == LAUNCH_CHILDREN
    for s in children:
        assert launch.t0 <= s.t0 <= s.t1 <= launch.t1, s
    (finish,) = [s for s in spans if s.name == "finish"]
    assert finish.t0 >= launch.t1 and finish.reqs == launch.reqs
    # no CUDA events on the CPU
    assert all(s.device_ms is None for s in spans)


def test_disabled_recorder_keeps_nothing(model):
    t0 = time.time_ns()
    trace.set_enabled(False)
    try:
        with trace.span("off") as s:
            pass
        model.prepare(_messages(3))
    finally:
        trace.set_enabled(True)
    assert _since(t0) == []
    assert s.t1 >= s.t0 and s.id is None   # still stamped for stage_ms
    with trace.span("on"):
        pass
    assert [x.name for x in _since(t0)] == ["on"]


def test_no_span_opens_during_a_capture():
    rec = trace.Recorder()
    seen = []
    with rec.capture():
        with rec.span("captured") as s:
            pass
        t = threading.Thread(target=lambda: seen.append(
            rec.span("worker").__enter__()))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen[0].id is None
    assert rec.spans() == [] and s.t1 >= s.t0
    with rec.span("after"):
        pass
    assert [x.name for x in rec.spans()] == ["after"]


def test_ring_keeps_its_bound():
    rec = trace.Recorder(capacity=5)
    for i in range(12):
        with rec.span(f"s{i}"):
            pass
    spans = rec.spans()
    assert [s.name for s in spans] == [f"s{i}" for i in range(7, 12)]


def test_program_builds_count_cache_misses(model):
    text, cfg = model.text, model.cfg.text
    gen = GenerationConfig(max_new_tokens=3, eos_token_id=cfg.vocab_size - 1,
                           pad_token_id=0)
    kw = dict(mode="loop", batch=1, prompt_pad=None, steps=2)
    before = trace.counters().get("program_builds", 0)
    prog = acquire_program(text, cfg, gen, cache_len=64, **kw)
    release_program(text, prog)
    again = acquire_program(text, cfg, gen, cache_len=64, **kw)
    assert again is prog                      # a hit: nothing built
    assert trace.counters()["program_builds"] == before + 1
    other = acquire_program(text, cfg, gen, cache_len=128, **kw)
    assert trace.counters()["program_builds"] == before + 2
    release_program(text, again)
    release_program(text, other)


def test_serve_wait_only_when_prepare_is_late():
    t0 = time.time_ns()
    ready = Future()
    ready.set_result({"request_id": 41})
    assert serving._prepared([ready]) == [{"request_id": 41}]
    assert [s for s in _since(t0) if s.name == "serve.wait"] == []
    late = Future()
    timer = threading.Timer(0.05, late.set_result, [{"request_id": 42}])
    timer.start()
    assert serving._prepared([ready, late])[1] == {"request_id": 42}
    timer.join(timeout=10)
    (wait,) = [s for s in _since(t0) if s.name == "serve.wait"]
    assert wait.reqs == (41, 42) and wait.host_ms >= 40


def test_spans_lie_inside_their_profiler_ranges(model):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        model.generate(_messages(4), max_new_tokens=MAX_NEW)
    spans = _since(t0)
    ranges = {ev.name(): ev for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith("fo1.")}
    assert {"prepare", "launch", "vit", "finish"} <= {s.name for s in spans}
    slack = 1_000_000   # ns
    for s in spans:
        ev = ranges[f"fo1.{s.name}#{s.id}"]
        assert ev.start_ns() - slack <= s.t0, s
        assert s.t1 <= ev.start_ns() + ev.duration_ns() + slack, s
        assert s.profiled


def test_spans_a_profiler_touched_are_marked():
    from torch.profiler import ProfilerActivity, profile

    rec = trace.Recorder()
    with rec.span("before"):
        pass
    outer = rec.open_span("started_inside")
    with profile(activities=[ProfilerActivity.CPU]):
        outer.close()
        inner = rec.open_span("stopped_inside")
    inner.close()
    with rec.span("after"):
        pass
    assert {s.name: s.profiled for s in rec.spans()} == {
        "before": False, "started_inside": True, "stopped_inside": True,
        "after": False}
