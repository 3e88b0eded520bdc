"""Host-side M-RoPE 3D position-id computation.

Behavioural re-derivation of Qwen2.5-VL `get_rope_index`
(reference modeling_qwen2_5_vl.py:1546-1721): text tokens advance all three
(t, h, w) position channels together; each vision span gets 3D grid positions
starting at the current offset; the following text resumes at
max(vision positions) + 1. This is branchy host logic — it stays in numpy and
its outputs are fed to the jitted model as plain arrays.
"""

from __future__ import annotations

import numpy as np


def get_rope_index(
    input_ids: np.ndarray,
    image_grid_thw: list[tuple[int, int, int]] | None,
    *,
    spatial_merge_size: int = 2,
    image_token_id: int = 151655,
    video_token_id: int = 151656,
    vision_start_token_id: int = 151652,
    attention_mask: np.ndarray | None = None,
    tokens_per_second: int = 2,
    second_per_grid_ts: list[float] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Compute 3D rope position ids.

    Args:
        input_ids: [B, S] int array, vision spans already expanded to one
            `image_token_id` per merged vision token.
        image_grid_thw: per-image (t, grid_h, grid_w) in *patch* units.

    Returns:
        position_ids: [3, B, S] int32
        rope_deltas: [B, 1] int32 (max position + 1 - seq_len per row)
    """
    input_ids = np.asarray(input_ids)
    bsz, seq_len = input_ids.shape
    if attention_mask is None:
        attention_mask = np.ones_like(input_ids)

    has_vision = image_grid_thw is not None and len(image_grid_thw) > 0
    if not has_vision:
        pos = (np.cumsum(attention_mask, axis=-1) - 1) * (attention_mask != 0)
        position_ids = np.broadcast_to(pos[None], (3, bsz, seq_len))
        deltas = pos.max(axis=-1, keepdims=True) + 1 - seq_len
        return position_ids.astype(np.int32), deltas.astype(np.int32)

    position_ids = np.ones((3, bsz, seq_len), dtype=np.int64)
    rope_deltas = np.zeros((bsz, 1), dtype=np.int64)
    grid_iter = iter(image_grid_thw)
    spg_iter = iter(second_per_grid_ts or [])

    for b in range(bsz):
        row_mask = attention_mask[b] == 1
        ids = input_ids[b][row_mask]
        chunks = []
        i = 0
        n = len(ids)
        cur = 0  # next position id
        while i < n:
            if ids[i] == image_token_id or ids[i] == video_token_id:
                is_video = ids[i] == video_token_id
                t, gh, gw = next(grid_iter)
                lh, lw = gh // spatial_merge_size, gw // spatial_merge_size
                span = t * lh * lw
                if is_video:
                    spg = next(spg_iter, 1.0)
                    t_step = int(spg * tokens_per_second)
                else:
                    t_step = 0
                t_idx = (np.arange(t).repeat(lh * lw) * max(t_step, 0)) + cur
                if not is_video:
                    t_idx = np.full(span, cur, dtype=np.int64)
                h_idx = np.tile(np.arange(lh).repeat(lw), t) + cur
                w_idx = np.tile(np.tile(np.arange(lw), lh), t) + cur
                chunks.append(np.stack([t_idx, h_idx, w_idx]))
                cur = int(chunks[-1].max()) + 1
                i += span
            else:
                j = i
                while j < n and ids[j] != image_token_id and ids[j] != video_token_id:
                    j += 1
                span = j - i
                r = np.arange(span, dtype=np.int64) + cur
                chunks.append(np.broadcast_to(r, (3, span)).copy())
                cur += span
                i = j
        llm_positions = np.concatenate(chunks, axis=1) if chunks else \
            np.zeros((3, 0), dtype=np.int64)
        position_ids[:, b, row_mask] = llm_positions
        rope_deltas[b, 0] = llm_positions.max() + 1 - seq_len if llm_positions.size else -seq_len

    return position_ids.astype(np.int32), rope_deltas.astype(np.int32)
