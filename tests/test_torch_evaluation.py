"""The port's evaluation harness, FLOP counts and profiler vs the JAX
package: `extract_count` and the COCO mAP evaluator on randomized inputs;
`eval_countbench` (batch 1, batched, pipelined) and `eval_coco` with the
port's tiny model against the JAX runners with the same weights
(`torch_parity.jax_fo1_params`) on fabricated records, equal predictions
and records; the runners' `score` command line against the JAX scorer;
every count of `runtime/flops.py` equal to JAX's; and a smoke run of
`runtime/profiler.py` on the CPU."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from conftest import StubTokenizer
from torch_parity import jax_fo1_params, one_torch_thread, port_config  # noqa: F401
from vlm_fo1_tpu.config import FO1Config
from vlm_fo1_tpu.evaluation import coco_map as jcm
from vlm_fo1_tpu.evaluation import runners as jr
from vlm_fo1_tpu.models.fo1 import FO1Model as JaxFO1Model
from vlm_fo1_tpu.runtime import flops as jf
from vlm_fo1_tpu.upn.model import UPNConfig as JaxUPNConfig
from vlm_fo1_tpu.upn.swin import SwinConfig as JaxSwinConfig
from vlm_fo1_tpu_torch.evaluation import coco_map as tcm
from vlm_fo1_tpu_torch.evaluation import runners as tr
from vlm_fo1_tpu_torch.models.fo1 import FO1Model
from vlm_fo1_tpu_torch.runtime import flops as tf
from vlm_fo1_tpu_torch.runtime import profiler

JCFG = dataclasses.replace(
    FO1Config.tiny(),
    text=dataclasses.replace(FO1Config.tiny().text, tie_word_embeddings=False))
CFG = port_config(JCFG)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_NEW = 6


def test_extract_count_matches():
    rng = np.random.default_rng(0)
    parts = ["<region3>", "<region12>", " there are ", "7", "12", "x",
             "region5", " 0 ", "no", "<region1><region2>", "45 apples"]
    texts = ["".join(rng.choice(parts, size=int(rng.integers(0, 7))))
             for _ in range(200)]
    texts += ["There are <region1><region2> 4 oranges", "<region12><region3>"]
    assert [tr.extract_count(t) for t in texts] == \
        [jr.extract_count(t) for t in texts]


def _random_coco(rng, n_img=6, n_cat=3):
    images = [{"id": i} for i in range(n_img)]
    cats = [{"id": 10 + c, "name": f"c{c}"} for c in range(n_cat)]
    anns, dets = [], []
    for img in range(n_img):
        for _ in range(int(rng.integers(0, 6))):
            x, y = rng.uniform(0, 200, 2)
            w, h = rng.uniform(4, 150, 2)
            cat = 10 + int(rng.integers(n_cat))
            anns.append({"image_id": img, "category_id": cat,
                         "bbox": [x, y, w, h],
                         "iscrowd": int(rng.random() < 0.1)})
            for _ in range(int(rng.integers(0, 3))):  # near-hits
                j = rng.normal(0, 8, 4)
                dets.append({"image_id": img, "category_id": cat,
                             "bbox": [x + j[0], y + j[1],
                                      max(w + j[2], 1.0), max(h + j[3], 1.0)],
                             "score": float(rng.random())})
        for _ in range(int(rng.integers(0, 4))):        # false positives
            dets.append({"image_id": img,
                         "category_id": 10 + int(rng.integers(n_cat)),
                         "bbox": list(rng.uniform(1, 120, 4)),
                         "score": float(rng.random())})
    return {"images": images, "annotations": anns, "categories": cats}, dets


@pytest.mark.parametrize("seed", range(4))
def test_coco_map_matches(seed):
    rng = np.random.default_rng(seed)
    gt, dets = _random_coco(rng)
    for max_items in (None, 4):
        got = tcm.evaluate_detections(gt, dets, max_items=max_items)
        want = jcm.evaluate_detections(gt, dets, max_items=max_items)
        assert got == want
        assert tcm.format_metrics(got) == jcm.format_metrics(want)
    d, g = np.asarray([x["bbox"] for x in dets[:5]]), \
        np.asarray([a["bbox"] for a in gt["annotations"][:4]])
    crowd = np.arange(len(g)) % 2 == 0
    np.testing.assert_array_equal(tcm.iou_xywh(d, g, crowd),
                                  jcm.iou_xywh(d, g, crowd))


# ------------------------------------------------------------ the runners

@pytest.fixture(scope="module")
def models():
    tm = FO1Model.random_init(CFG, seed=9, device="cpu",
                              tokenizer=StubTokenizer())
    jm = JaxFO1Model(JCFG, jax_fo1_params(tm.state_dict(), JCFG),
                     tokenizer=StubTokenizer())
    return jm, tm


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """CountBench items with 1-5 boxes and COCO rows with proposals and
    scores, written from a seed; two image sizes."""
    d = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(3)
    names = [f"im{i}.jpg" for i in range(4)]
    for i, n in enumerate(names):
        size = (64, 80) if i % 2 else (80, 96)
        Image.fromarray(rng.integers(0, 255, (*size, 3), np.uint8)).save(
            d / n)

    def boxes(k):
        xy = rng.uniform(0, 40, (k, 2))
        wh = rng.uniform(8, 30, (k, 2))
        return np.concatenate([xy, xy + wh], 1).round(1).tolist()

    count = [{"question": f"How many things {i}?", "answer": int(a),
              "image": names[i % 4], "bboxes": boxes(int(a)),
              "scores": rng.uniform(0.3, 0.9, int(a)).round(3).tolist()}
             for i, a in enumerate(rng.integers(1, 6, 5))]
    (d / "count.json").write_text(json.dumps(count))
    rows = []
    for i in range(3):
        k = int(rng.integers(2, 5))
        rows.append({"id": 100 + i, "image": names[i],
                     "bbox_list": boxes(k),
                     "score_list": rng.uniform(0.3, 0.9, k).round(3).tolist(),
                     "conversations": [{"value": "Please detect cat."}]})
    (d / "eval.jsonl").write_text("".join(json.dumps(r) + "\n"
                                          for r in rows))
    (d / "instances.json").write_text(json.dumps({
        "images": [{"id": r["id"]} for r in rows],
        "annotations": [{"image_id": r["id"], "category_id": 7,
                         "bbox": [b[0], b[1], b[2] - b[0], b[3] - b[1]],
                         "iscrowd": 0} for r in rows
                        for b in r["bbox_list"][:2]],
        "categories": [{"name": "cat", "id": 7}]}))
    return d


@pytest.mark.parametrize("batch_size,pipelined", [(1, False), (2, False),
                                                  (2, True)])
def test_eval_countbench_matches(models, records, batch_size, pipelined):
    jm, tm = models
    kw = dict(max_new_tokens=MAX_NEW, verbose=False, batch_size=batch_size,
              pipelined=pipelined)
    args = (str(records / "count.json"), str(records))
    got = tr.eval_countbench(tm, *args, **kw)
    want = jr.eval_countbench(jm, *args, **kw)
    assert got["total"] == want["total"] == 5
    for key in ("predictions", "ground_truth", "correct", "accuracy"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("batch_size,pipelined", [(1, False), (2, True)])
def test_eval_coco_matches(models, records, tmp_path, batch_size, pipelined):
    jm, tm = models
    paths = [str(records / "eval.jsonl"), str(records / "instances.json"),
             str(records)]
    kw = dict(max_new_tokens=MAX_NEW, batch_size=batch_size,
              pipelined=pipelined)
    got = tr.eval_coco(tm, *paths, str(tmp_path / "t.json"), **kw)
    want = jr.eval_coco(jm, *paths, str(tmp_path / "j.json"), **kw)
    assert got == want
    assert json.loads((tmp_path / "t.json").read_text()) == want


def test_coco_records_and_score_cli(models, records, tmp_path, monkeypatch):
    """Grounded answers (random weights emit no markup, so `generate`
    answers with markup here) become the same COCO records in both
    runners, and the `score` command line prints JAX's metrics."""
    jm, tm = models

    class R:
        text = ("<ground>cat</ground><objects><region0><region2><region9>"
                "</objects><ground>dog</ground><objects><region1></objects>")

    for m in (jm, tm):
        monkeypatch.setattr(m, "generate", lambda *a, **k: R())
    paths = [str(records / "eval.jsonl"), str(records / "instances.json"),
             str(records)]
    pred = str(tmp_path / "pred.json")
    got = tr.eval_coco(tm, *paths, pred)
    assert got == jr.eval_coco(jm, *paths, str(tmp_path / "j.json"))
    assert got and {r["category_id"] for r in got} == {7}
    out = subprocess.run(
        [sys.executable, "-m", "vlm_fo1_tpu_torch.evaluation.runners",
         "score", "--pred-path", pred, "--ann-path", paths[1]],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    want = jcm.format_metrics(jcm.score_coco_files(pred, paths[1]))
    assert out.stdout.strip() == want


# ------------------------------------------------------------ flops

def test_flops_match():
    j3, t3 = FO1Config(), port_config(FO1Config())
    jt, tt = JCFG, CFG
    for jc, tc in ((j3, t3), (jt, tt)):
        for gh, gw, nb in ((68, 92, 7), (8, 10, 1), (62, 84, 100)):
            assert tf.vit_encode_flops(tc.vision, gh, gw) == \
                jf.vit_encode_flops(jc.vision, gh, gw)
            assert tf.projector_flops(tc, gh * gw) == \
                jf.projector_flops(jc, gh * gw)
            assert tf.hfre_flops(tc, nb, gh, gw) == \
                jf.hfre_flops(jc, nb, gh, gw)
            assert tf.encode_flops(tc, gh, gw, nb) == \
                jf.encode_flops(jc, gh, gw, nb)
        assert tf.davit_flops(tc.davit, tc.aux_image_size) == \
            jf.davit_flops(jc.davit, jc.aux_image_size)
        for s in (1, 130, 1771):
            assert tf.prefill_flops(tc.text, s) == \
                jf.prefill_flops(jc.text, s)
            assert tf.decode_flops(tc.text, 32, s) == \
                jf.decode_flops(jc.text, 32, s)
    ju, js = JaxUPNConfig(), JaxSwinConfig()
    tu, ts = port_config(ju), port_config(js)
    for h, w in ((992, 1312), (224, 320)):
        assert tf.swin_flops(ts, h, w) == jf.swin_flops(js, h, w)
        assert tf.upn_flops(tu, ts, h, w) == jf.upn_flops(ju, js, h, w)
        assert tf._level_tokens(h, w, 5) == jf._level_tokens(h, w, 5)
    assert tf.msda_flops(256, 8, 5, 4, 900, 85932) == \
        jf.msda_flops(256, 8, 5, 4, 900, 85932)
    stages = {"encode": (3.1e12, 0.1), "prefill": (1.3e13, 0.032),
              "idle": (0.0, 0.0)}
    assert tf.mfu_report(stages, peak=197e12) == \
        jf.mfu_report(stages, peak=197e12)
    rep = tf.mfu_report(stages)
    assert rep["peak_tflop_s"] == 989.0 == tf.H100_BF16_PEAK / 1e12
    assert tf.StageMFU(1e12, 0.5).tflop_s == jf.StageMFU(1e12, 0.5).tflop_s


# ------------------------------------------------------------ profiler

def test_profiler_smoke(tmp_path, capsys):
    res = {}
    with profiler.timed("a", res, device="cpu"):
        torch.ones(4).sum()
    with profiler.timed("a", res):
        pass
    assert set(res) == {"a"} and res["a"] >= 0.0
    with profiler.timed("printed"):
        pass
    assert "[timed] printed:" in capsys.readouterr().out
    st = profiler.StageTimer("cpu")
    for _ in range(2):
        with st.stage("x"):
            torch.randn(8, 8) @ torch.randn(8, 8)
    assert st.counts["x"] == 2 and set(st.report()) == {"x"}
    path = str(tmp_path / "trace.json")
    with profiler.trace(path) as prof:
        torch.randn(16, 16) @ torch.randn(16, 16)
    assert "traceEvents" in json.loads(open(path).read())
    assert len(prof.key_averages()) > 0

    net = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.ReLU(),
                              torch.nn.Linear(4, 2))
    profiler.enable_debug(net)
    net(torch.ones(1, 4))                      # finite: runs
    with torch.no_grad():
        net[0].weight[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="'0'"):
        net(torch.ones(1, 4))                  # the first module raises
    profiler.disable_debug(net)
    assert torch.isnan(net(torch.ones(1, 4))).any()
