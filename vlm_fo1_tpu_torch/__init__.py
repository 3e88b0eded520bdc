"""vlm_fo1_tpu_torch -- the PyTorch / CUDA port of vlm_fo1_tpu for NVIDIA
Hopper GPUs.

Same module layout as the JAX package (`nn`, `ops`, `models`, `upn`,
`runtime`, `preprocess`), PyTorch idiom inside. The package imports nothing
of `vlm_fo1_tpu` and never imports JAX: configuration, templates, host-side
preprocessing and output parsing are its own copies of the JAX package's
modules of the same names (`config`, `constants`, `task_templates`,
`postprocess`, `preprocess/*`, `runtime/fallback_tokenizer`). The kernels,
flash attention and multi-scale deformable attention, are hand-written CUDA
in `csrc/`.
"""
