"""The port's FO1 slice vs the JAX `FO1Model` on `FO1Config.tiny()`, f32 on
the CPU, weights bridged by `convert.state_dict_from_jax_params`:
`prepare` exactly equal, vision / region tokens to 2e-4, prefill logits to
1e-4, greedy tokens and parsed boxes equal; and the port runs with JAX never
imported.

The trunk's head is untied here: with random weights a tied head echoes
the last prompt token forever, and equal greedy tokens would prove nothing.
The tied head is covered by test_torch_llm.py."""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from conftest import StubTokenizer
from torch_parity import one_torch_thread, port_config, to_numpy  # noqa: F401
from vlm_fo1_tpu.config import FO1Config
from vlm_fo1_tpu.models.fo1 import FO1Model as JaxFO1Model, _splice_embeds
from vlm_fo1_tpu.postprocess import extract_predictions_to_bboxes
from vlm_fo1_tpu.runtime.generate import pad_to_bucket, prefill
from vlm_fo1_tpu.task_templates import OD_template
from vlm_fo1_tpu_torch.convert import state_dict_from_jax_params
from vlm_fo1_tpu_torch.models.fo1 import FO1Model

JCFG = dataclasses.replace(
    FO1Config.tiny(),
    text=dataclasses.replace(FO1Config.tiny().text, tie_word_embeddings=False))
CFG = port_config(JCFG)
MAX_PIXELS = 128 * 128
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def models():
    jm = JaxFO1Model.random_init(JCFG, seed=5, tokenizer=StubTokenizer())
    tm = FO1Model(CFG, device="cpu", tokenizer=StubTokenizer())
    tm.load_state_dict(state_dict_from_jax_params(to_numpy(jm.params), CFG),
                       strict=True)
    return jm, tm


def _messages(seed, boxes, target):
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 255, (120, 160, 3), np.uint8))
    return [{
        "role": "user",
        "content": [{"type": "image_url", "image_url": {"url": img}},
                    {"type": "text", "text": OD_template.format(target)}],
        "bbox_list": boxes,
    }]


MESSAGES = [
    _messages(0, [[10.0 * i, 5.0 * i, 30.0 + 10.0 * i, 40.0 + 5.0 * i]
                  for i in range(3)], "orange"),
    _messages(1, [[0.0, 0.0, 150.0, 110.0], [5.0, 5.0, 20.0, 20.0]], "cup"),
]


def test_prepare_is_identical(models):
    jm, tm = models
    pj = jm.prepare(MESSAGES[0], max_pixels=MAX_PIXELS)
    pt = tm.prepare(MESSAGES[0], max_pixels=MAX_PIXELS)
    assert pt["prompt"] == pj["prompt"] and pt["grid"] == pj["grid"]
    for key in ("pixel_values", "aux", "aux_boxes", "vt_boxes",
                "position_ids", "rope_deltas"):
        np.testing.assert_array_equal(pt[key], pj[key], err_msg=key)
    for key in ("input_ids", "image_positions", "region_positions"):
        np.testing.assert_array_equal(getattr(pt["splice"], key),
                                      getattr(pj["splice"], key))


def test_encode_and_prefill_logits(models):
    jm, tm = models
    pj = jm.prepare(MESSAGES[0], max_pixels=MAX_PIXELS)
    pt = tm.prepare(MESSAGES[0], max_pixels=MAX_PIXELS)
    vj, rj, nb, rpad = jm.encode(pj)
    vt, rt = tm.encode(pt)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=2e-4)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=2e-4)

    info = pj["splice"]
    s = info.seq_len
    pad_len = pad_to_bucket(s, 128)
    reg_pos = np.full(nb, s, np.int32)
    reg_pos[:len(info.region_positions)] = info.region_positions
    embeds = _splice_embeds(jm.params["text"], jnp.asarray(info.input_ids),
                            vj, jnp.asarray(info.image_positions), rpad,
                            jnp.asarray(reg_pos), pad_len=pad_len)
    pos = np.zeros((3, 1, pad_len), np.int32)
    pos[:, :, :s] = pj["position_ids"]
    _, lj = prefill(jm.params["text"], JCFG.text, embeds, jnp.asarray(pos),
                    jnp.asarray([s]), cache_len=pad_len + 4)
    _, lt = tm.prefill(pt, tm.splice(pt, vt, rt), s + 4)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)


@pytest.mark.parametrize("which", [0, 1])
def test_greedy_tokens_and_parsed_boxes(models, which):
    jm, tm = models
    msgs = MESSAGES[which]
    rj = jm.generate(msgs, max_new_tokens=8, max_pixels=MAX_PIXELS)
    rt = tm.generate(msgs, max_new_tokens=8, max_pixels=MAX_PIXELS)
    np.testing.assert_array_equal(rt.token_ids, rj.token_ids)
    assert len(set(rj.token_ids.tolist())) > 2  # a sequence worth comparing
    assert (rt.num_steps, rt.prompt_len, rt.text) == \
        (rj.num_steps, rj.prompt_len, rj.text)
    boxes = msgs[0]["bbox_list"]
    assert extract_predictions_to_bboxes(rt.text, boxes) == \
        extract_predictions_to_bboxes(rj.text, boxes)


@pytest.mark.parametrize("boxes", [[], None], ids=["empty", "none"])
def test_prompt_without_boxes_matches(models, boxes):
    """One image and no boxes: JAX pads dummy boxes and slices them off
    again; the port takes zero region rows. Greedy tokens agree."""
    jm, tm = models
    msgs = _messages(2, boxes, "cup")
    rj = jm.generate(msgs, max_new_tokens=8, max_pixels=MAX_PIXELS)
    rt = tm.generate(msgs, max_new_tokens=8, max_pixels=MAX_PIXELS)
    np.testing.assert_array_equal(rt.token_ids, rj.token_ids)
    assert (rt.num_steps, rt.prompt_len, rt.text) == \
        (rj.num_steps, rj.prompt_len, rj.text)


def test_stop_sequence_matches(models):
    """A stop given as an id n-gram (tokens 1..2 of the greedy answer) ends
    both loops at the same step and is trimmed from both answers."""
    jm, tm = models
    msgs = MESSAGES[0]
    full = jm.generate(msgs, max_new_tokens=8, max_pixels=MAX_PIXELS)
    stop = [tuple(int(t) for t in full.token_ids[1:3])]
    rj = jm.generate(msgs, max_new_tokens=8, max_pixels=MAX_PIXELS,
                     stop_strings=stop)
    rt = tm.generate(msgs, max_new_tokens=8, max_pixels=MAX_PIXELS,
                     stop_strings=stop)
    assert rt.num_steps == rj.num_steps < full.num_steps
    np.testing.assert_array_equal(rt.token_ids, rj.token_ids)
    assert rt.text == rj.text


def test_port_and_example_never_import_jax(tmp_path):
    """Importing every module of the port (the training modules, the MSDA
    microbenchmarks, the serving pipelines, the checkpoint loader, the API,
    the tower builders, the HFRE variants, SimpleFPN, the projectors, the
    evaluation runners and COCO scorer, the FLOP counts, the profiler, the
    parallel layer and the native preprocessing helper named explicitly),
    running the port's examples on the CPU (the FO1 one
    also in the int4 mode, one training step with a checkpoint, and a batch
    of three through serve_torch.py) and the evaluation runners' `score`
    command loads neither JAX nor the JAX package."""
    runs = [
        ("inference_torch.py", ["--max-new-tokens", "2", "--output",
                                str(tmp_path / "fo1.jpg")]),
        ("inference_torch.py", ["--max-new-tokens", "2", "--quant", "int4"]),
        ("run_upn_torch.py", ["--output", str(tmp_path / "upn.jpg")]),
        ("inference_with_upn_torch.py", ["--max-new-tokens", "2",
                                         "--output",
                                         str(tmp_path / "upn_fo1.jpg")]),
        ("train_torch.py", ["--steps", "1", "--ckpt-dir",
                            str(tmp_path / "ckpt")]),
        ("serve_torch.py", ["--requests", "3", "--max-new-tokens", "2"]),
    ]
    pred, ann = str(tmp_path / "pred.json"), str(tmp_path / "ann.json")
    with open(ann, "w") as f:
        json.dump({"images": [{"id": 1}], "categories": [{"id": 7}],
                   "annotations": [{"image_id": 1, "category_id": 7,
                                    "bbox": [0, 0, 10, 10]}]}, f)
    with open(pred, "w") as f:
        json.dump([{"image_id": 1, "category_id": 7, "bbox": [0, 0, 10, 10],
                    "score": 0.9}], f)
    code = (
        "import importlib, pkgutil, runpy, sys\n"
        "import vlm_fo1_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from vlm_fo1_tpu_torch.training import checkpointing, train_step\n"
        "from vlm_fo1_tpu_torch.ops import matmul_floor, msda_dma, "
        "msda_micro\n"
        "from vlm_fo1_tpu_torch import api, checkpoint\n"
        "from vlm_fo1_tpu_torch.models import builder\n"
        "from vlm_fo1_tpu_torch.runtime import flops, graphs, profiler, "
        "serving\n"
        "from vlm_fo1_tpu_torch.models import hfre, projector, simple_fpn\n"
        "from vlm_fo1_tpu_torch.evaluation import coco_map, runners\n"
        "from vlm_fo1_tpu_torch.parallel import dryrun, multihost, "
        "ring_attention, sharding\n"
        "from vlm_fo1_tpu_torch import native\n"
        f"for script, extra in {runs!r}:\n"
        "    sys.argv = [script, '--random-init', 'tiny', '--device', 'cpu']"
        " + extra\n"
        "    runpy.run_path('examples/' + script, run_name='__main__')\n"
        f"sys.argv = ['runners', 'score', '--pred-path', {pred!r}, "
        f"'--ann-path', {ann!r}]\n"
        "runpy.run_module('vlm_fo1_tpu_torch.evaluation.runners', "
        "run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'vlm_fo1_tpu'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "NO_JAX" in out.stdout
    assert out.stdout.count("parsed boxes") == 3
    assert "proposals above" in out.stdout
    assert "step_1" in out.stdout and (tmp_path / "ckpt" / "step_1").is_dir()
    assert "batch: 3 requests" in out.stdout
    assert "(AP) @[ IoU=0.50:0.95 | area=   all ] = 1.000" in out.stdout
