"""The benchmark of `vlm_fo1_tpu_torch` on one NVIDIA H100: see
`BENCHMARK.json` at the repository root and `run.py`."""
