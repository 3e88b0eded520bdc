"""The port's native host preprocessing (`vlm_fo1_tpu_torch/native`) vs the
JAX package's (`vlm_fo1_tpu/native`) and vs the port's numpy path:

- the same source built with the same flags gives the same bytes as the
  JAX build, bit for bit, for all three functions;
- the numpy path agrees to 1e-6 (the C++ multiplies by 1/std where numpy
  divides by std; JAX's tests/test_native.py holds the same bound);
- `qwen_image_preprocess`, `aux_image_preprocess`, `qwen_image_patchify_u8`
  and `FO1Model.prepare` take the native path and count it; videos stay on
  numpy;
- the library is built under build/, rebuilt when the source is newer, a
  failed compile raises with the compiler's output, and only a missing g++
  leaves the numpy path in use."""

import os
import shutil

import numpy as np
import pytest
from PIL import Image

import vlm_fo1_tpu.native as jax_native
from vlm_fo1_tpu_torch import native
from vlm_fo1_tpu_torch.preprocess import image as pim

QWEN = (pim.QWEN_IMAGE_MEAN, pim.QWEN_IMAGE_STD)
AUX = (pim.AUX_IMAGE_MEAN, pim.AUX_IMAGE_STD)


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the numpy path is the only one here")
    lib = native.get_lib()
    assert lib is not None and jax_native.get_lib() is not None
    return lib


@pytest.fixture
def raw():
    return np.random.default_rng(0).integers(0, 256, (56, 84, 3), np.uint8)


def test_library_is_built_under_build(lib):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert native.library() == os.path.join(root, "build",
                                            "libfo1_preproc.so")
    assert os.path.exists(native.library())


@pytest.mark.parametrize("which", ["patchify", "normalize_chw",
                                   "patchify_raw"])
def test_bit_equal_to_the_jax_native_build(lib, raw, which):
    if which == "patchify":
        got = native.qwen_patchify_native(lib, raw, 14, 2, 2, *QWEN)
        want = jax_native.qwen_patchify_native(raw, 14, 2, 2, *QWEN)
    elif which == "normalize_chw":
        got = native.normalize_chw_native(lib, raw, *AUX)
        want = jax_native.normalize_chw_native(raw, *AUX)
    else:
        got = native.qwen_patchify_raw_native(lib, raw, 14, 2, 2)
        want = jax_native.qwen_patchify_raw_native(raw, 14, 2, 2)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", ["qwen_image_preprocess",
                                   "aux_image_preprocess",
                                   "qwen_image_patchify_u8"])
def test_native_within_1e6_of_numpy_and_counted(lib, which):
    img = Image.fromarray(np.random.default_rng(1).integers(
        0, 256, (100, 130, 3), np.uint8))
    fn = getattr(pim, which)
    before = dict(native.calls)
    got = fn(img)
    assert native.calls["native"] == before["native"] + 1
    native.enabled = False
    try:
        want = fn(img)
    finally:
        native.enabled = True
    assert native.calls["numpy"] == before["numpy"] + 1
    if isinstance(got, tuple):
        assert got[1] == want[1]
        got, want = got[0], want[0]
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_native_refuses_an_image_off_the_patch_grid(lib, raw):
    with pytest.raises(ValueError, match="multiples of 28"):
        native.qwen_patchify_raw_native(lib, raw[:50], 14, 2, 2)


def test_prepare_takes_the_native_path(lib):
    from vlm_fo1_tpu_torch.config import FO1Config
    from vlm_fo1_tpu_torch.models.fo1 import FO1Model
    from vlm_fo1_tpu_torch.runtime.fallback_tokenizer import (
        FallbackTokenizer,
    )
    from vlm_fo1_tpu_torch.task_templates import OD_template

    model = FO1Model(FO1Config.tiny(), device="cpu",
                     tokenizer=FallbackTokenizer())
    img = Image.fromarray(np.random.default_rng(2).integers(
        0, 256, (120, 160, 3), np.uint8))
    msgs = [{"role": "user",
             "content": [{"type": "image_url", "image_url": {"url": img}},
                         {"type": "text", "text": OD_template.format("x")}],
             "bbox_list": [[10.0, 10.0, 60.0, 80.0]]}]
    before = dict(native.calls)
    prep = model.prepare(msgs)
    assert native.calls["native"] > before["native"]
    assert native.calls["numpy"] == before["numpy"]
    native.enabled = False
    try:
        ref = model.prepare(msgs)
    finally:
        native.enabled = True
    np.testing.assert_array_equal(prep["pixel_values"], ref["pixel_values"])


def test_videos_stay_on_numpy(lib):
    frames = [Image.fromarray(np.random.default_rng(i).integers(
        0, 256, (56, 56, 3), np.uint8)) for i in range(2)]
    before = dict(native.calls)
    pim.qwen_video_preprocess(frames)
    assert native.calls == before


@pytest.fixture
def scratch_build(tmp_path, monkeypatch):
    """The module pointed at a copy of the source and a library path under
    tmp_path, its loaded library forgotten."""
    src = tmp_path / "preproc.cpp"
    shutil.copy(native._SRC, src)
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_SO", str(tmp_path / "build" / "lib.so"))
    monkeypatch.setattr(native, "_lib", None)
    return src


def test_rebuilds_when_the_source_is_newer(lib, scratch_build):
    assert native.build()
    so = native._SO
    old = os.path.getmtime(so) - 100
    os.utime(so, (old, old))
    assert native.build()
    assert os.path.getmtime(so) > old + 50


def test_failed_compile_raises_with_the_compilers_output(lib, scratch_build):
    scratch_build.write_text("extern \"C\" void f( { }\n")
    with pytest.raises(RuntimeError, match="error"):
        native.get_lib()


def test_missing_gxx_leaves_the_numpy_path(scratch_build, monkeypatch):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert native.get_lib() is None
    img = Image.fromarray(np.random.default_rng(3).integers(
        0, 256, (60, 60, 3), np.uint8))
    before = dict(native.calls)
    pim.aux_image_preprocess(img, 56)
    assert native.calls["numpy"] == before["numpy"] + 1
    assert native.calls["native"] == before["native"]
