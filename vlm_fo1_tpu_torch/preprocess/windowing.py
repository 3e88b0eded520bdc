"""Static windowing plan for the Qwen2.5-VL vision transformer.

TPU-first redesign of the reference's varlen window attention
(modeling_qwen2_5_vl.py:465-504 `get_window_index` + cu_seqlens switching):
instead of packing variable-length windows and running varlen flash
attention, we pad every window to a fixed 8x8-patch tile and lay the
sequence out as [num_windows, window_tokens]. Window attention becomes a
dense batched attention over static shapes (MXU-friendly, no dynamic
shapes under jit); full-attention blocks run over the padded sequence with
a validity mask. All permutations are precomputed here on the host with
numpy — they depend only on grid_thw.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from vlm_fo1_tpu_torch.config import ViTConfig


@dataclass(frozen=True)
class ViTPlan:
    """Everything the device needs to run the ViT on one image geometry.

    Shapes below use: S = t*gh*gw real patch tokens, U = S/4 merge units,
    P = num_windows * window_tokens padded tokens.
    """

    grid_thw: tuple[int, int, int]
    num_windows: int          # static
    window_tokens: int        # static (64 for 112px windows, 14px patches)
    seq: int                  # S
    seq_pad: int              # P
    gather_idx: np.ndarray    # [P] int32: source patch-token for each padded slot
    valid: np.ndarray         # [P] bool: slot holds a real token
    inv_token_idx: np.ndarray  # [S] int32: padded slot of each original token
    inv_unit_idx: np.ndarray  # [U] int32: padded unit slot of each merge unit
    rot_cos: np.ndarray       # [P, head_dim] float32 vision rotary
    rot_sin: np.ndarray       # [P, head_dim] float32

    @property
    def num_units(self) -> int:
        return self.seq // 4


def build_vit_plan(grid_thw: tuple[int, int, int], cfg: ViTConfig) -> ViTPlan:
    t, gh, gw = (int(x) for x in grid_thw)
    m = cfg.spatial_merge_size
    mu = m * m
    llm_h, llm_w = gh // m, gw // m
    wm = cfg.window_size // cfg.patch_size // m  # merged cells per window side
    nwh, nww = -(-llm_h // wm), -(-llm_w // wm)
    window_units = wm * wm
    window_tokens = window_units * mu

    # --- window permutation over merge units (one frame) -------------------
    unit_grid = np.arange(llm_h * llm_w, dtype=np.int64).reshape(llm_h, llm_w)
    padded = np.full((nwh * wm, nww * wm), -1, dtype=np.int64)
    padded[:llm_h, :llm_w] = unit_grid
    padded = (
        padded.reshape(nwh, wm, nww, wm)
        .transpose(0, 2, 1, 3)
        .reshape(-1)
    )  # [num_windows_per_frame * window_units]

    frames = []
    units_per_frame = llm_h * llm_w
    for f in range(t):
        pf = np.where(padded >= 0, padded + f * units_per_frame, -1)
        frames.append(pf)
    padded_units = np.concatenate(frames)  # [num_windows * window_units]
    num_windows = t * nwh * nww

    valid_unit = padded_units >= 0
    gather_unit = np.where(valid_unit, padded_units, 0)

    offs = np.arange(mu, dtype=np.int64)
    gather_idx = (gather_unit[:, None] * mu + offs).reshape(-1)
    valid = np.repeat(valid_unit, mu)

    inv_unit_idx = np.zeros(t * units_per_frame, dtype=np.int64)
    pos = np.nonzero(valid_unit)[0]
    inv_unit_idx[padded_units[pos]] = pos
    inv_token_idx = (inv_unit_idx[:, None] * mu + offs).reshape(-1)

    # --- vision rotary embedding (reference modeling:436-463) --------------
    # original token order is (h_block, w_block, merge_h, merge_w)
    hb = np.arange(llm_h).repeat(llm_w)           # per unit
    wb = np.tile(np.arange(llm_w), llm_h)
    mh = np.array([0, 0, 1, 1])
    mw = np.array([0, 1, 0, 1])
    h_pos = (hb[:, None] * m + mh).reshape(-1)     # [units*4] per frame
    w_pos = (wb[:, None] * m + mw).reshape(-1)
    h_pos = np.tile(h_pos, t)
    w_pos = np.tile(w_pos, t)

    head_dim = cfg.head_dim
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, head_dim // 2, 2, dtype=np.float64)
                                  / (head_dim // 2)))
    fh = h_pos[:, None] * inv_freq[None, :]
    fw = w_pos[:, None] * inv_freq[None, :]
    freqs = np.concatenate([fh, fw], axis=-1)      # [S, head_dim/2]
    emb = np.concatenate([freqs, freqs], axis=-1)  # [S, head_dim]
    # permute to the padded window layout; pad slots reuse token 0 (masked out)
    emb_padded = emb[gather_idx]
    rot_cos = np.cos(emb_padded).astype(np.float32)
    rot_sin = np.sin(emb_padded).astype(np.float32)

    return ViTPlan(
        grid_thw=(t, gh, gw),
        num_windows=num_windows,
        window_tokens=window_tokens,
        seq=t * gh * gw,
        seq_pad=num_windows * window_tokens,
        gather_idx=gather_idx.astype(np.int32),
        valid=valid,
        inv_token_idx=inv_token_idx.astype(np.int32),
        inv_unit_idx=inv_unit_idx.astype(np.int32),
        rot_cos=rot_cos,
        rot_sin=rot_sin,
    )


def pad_pixel_values(pixel_values: np.ndarray, plan: ViTPlan) -> np.ndarray:
    """Rearrange [S, patch_dim] pixel values into the padded window layout
    [P, patch_dim] (host gather; pads replicate token 0 and are masked)."""
    return pixel_values[plan.gather_idx]
