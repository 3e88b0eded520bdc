"""Training: the FO1 multimodal train step with AdamW and remat, and its
checkpoints (counterparts of `vlm_fo1_tpu/training/`)."""
