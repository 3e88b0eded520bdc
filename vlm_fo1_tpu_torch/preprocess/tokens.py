"""Chat assembly and multimodal token splice (host side).

Implements the VLM-FO1 prompt protocol (reference mm_utils.py:28-135,
464-655): ChatML framing, `<|vision_start|><image><|vision_end|>` insertion,
per-region `<region{i}><regionfeat>` markers, and the sentinel splice that
maps `<image>` -> IMAGE_TOKEN_INDEX (-200) and `<regionfeat>` ->
REGION_TOKEN_INDEX (-300). The final expansion step replaces each -200 with
the image's merged-token span so the device-side scatter has static,
host-known positions.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from vlm_fo1_tpu_torch.constants import (
    DEFAULT_REGION_FEATURE_TOKEN,
    DEFAULT_REGION_TOKEN,
    IM_END,
    IM_END_TOKEN_ID,
    IM_START,
    IM_START_TOKEN_ID,
    IMAGE_TOKEN_INDEX,
    QWEN2_5_VL_IMAGE_TOKEN_INDEX,
    REGION_TOKEN_INDEX,
    VISION_END_TOKEN,
    VISION_START_TOKEN,
)


def _encode(tokenizer, text: str) -> list[int]:
    """Tokenize plain text with either an HF tokenizer or anything exposing
    .encode(text) -> list[int]."""
    if text == "":
        return []
    try:
        out = tokenizer(text)
        ids = getattr(out, "input_ids", None)
        if ids is None and isinstance(out, dict):
            ids = out.get("input_ids")
        if ids is not None:
            return list(ids)
    except TypeError:
        pass
    return list(tokenizer.encode(text))


def tokenizer_image_token(prompt: str, tokenizer,
                          image_token_index: int = IMAGE_TOKEN_INDEX) -> list[int]:
    """Tokenize a prompt, replacing each `<image>` with the sentinel id."""
    chunks = [_encode(tokenizer, c) for c in prompt.split("<image>")]
    ids: list[int] = []
    for i, chunk in enumerate(chunks):
        ids.extend(chunk)
        if i < len(chunks) - 1:
            ids.append(image_token_index)
    return ids


def tokenizer_image_region_token(
    prompt: str, tokenizer,
    image_token_index: int = IMAGE_TOKEN_INDEX,
    region_token_index: int = REGION_TOKEN_INDEX,
) -> list[int]:
    """Tokenize with both `<image>` and `<regionfeat>` sentinels."""
    ids: list[int] = []
    image_chunks = prompt.split("<image>")
    for i, chunk in enumerate(image_chunks):
        parts = chunk.split(DEFAULT_REGION_FEATURE_TOKEN)
        for j, part in enumerate(parts):
            if j > 0:
                ids.append(region_token_index)
            ids.extend(_encode(tokenizer, part))
        if i < len(image_chunks) - 1:
            ids.append(image_token_index)
    return ids


def make_message_context(tokenizer, message: dict):
    """Render one chat message to (text, tokens, image_urls, bbox_list).

    Mirrors reference mm_utils.py:464-528 with the Qwen2.5-VL vision markers.
    """
    image_urls: list = []
    role = message["role"]
    content = message["content"]
    bbox_list = message.get("bbox_list", None)
    nl = _encode(tokenizer, "\n")

    if role == "system" or (role == "user" and isinstance(content, str)):
        text = f"{IM_START}{role}\n{content}{IM_END}\n"
        tokens = ([IM_START_TOKEN_ID] + _encode(tokenizer, role) + nl
                  + _encode(tokenizer, content) + [IM_END_TOKEN_ID])
        return text, tokens, image_urls, bbox_list

    if role == "user" and isinstance(content, list):
        text = f"{IM_START}{role}\n"
        for part in content:
            if part["type"] == "text":
                text += part["text"]
            elif part["type"] in ("image_url", "video_url"):
                text += VISION_START_TOKEN + "<image>" + VISION_END_TOKEN + "\n"
                if bbox_list and part["type"] == "image_url":
                    for idx in range(len(bbox_list)):
                        text += (DEFAULT_REGION_TOKEN.replace("<i>", str(idx))
                                 + DEFAULT_REGION_FEATURE_TOKEN)
                    text += "\n"
                if part["type"] == "video_url":
                    image_urls.append({"video": part["video_url"]["url"]})
                else:
                    image_urls.append(part["image_url"]["url"])
        text += f"{IM_END}\n"
        if bbox_list:
            tokens = tokenizer_image_region_token(text, tokenizer)
        else:
            tokens = tokenizer_image_token(text, tokenizer)
        return text, tokens, image_urls, bbox_list

    raise ValueError(f"unsupported message: role={role!r}")


def build_chat_tokens(tokenizer, messages: list[dict]):
    """Assemble a full conversation: system-prompt injection + assistant turn
    (reference mm_utils.py:557-580)."""
    prompt = ""
    tokens: list[int] = []
    image_urls: list = []
    bbox_list = None
    for message in messages:
        text, t, urls, boxes = make_message_context(tokenizer, message)
        prompt += text
        tokens.extend(t)
        image_urls.extend(urls)
        if boxes is not None:
            bbox_list = boxes

    if "system" not in prompt:
        sys_content = "system\nYou are a helpful assistant."
        prompt = IM_START + sys_content + IM_END + "\n" + prompt
        tokens = ([IM_START_TOKEN_ID] + _encode(tokenizer, sys_content)
                  + [IM_END_TOKEN_ID] + _encode(tokenizer, "\n") + tokens)

    if not prompt.endswith(f"{IM_START}assistant"):
        prompt += IM_START + "assistant" + "\n"
        tokens = tokens + [IM_START_TOKEN_ID] + _encode(tokenizer, "assistant\n")

    return prompt, tokens, image_urls, bbox_list


@dataclass
class SpliceInfo:
    """Expanded token ids + scatter positions for multimodal embedding."""

    input_ids: np.ndarray           # [S] int32, sentinels expanded
    image_positions: np.ndarray     # [n_image_tokens] int32
    region_positions: np.ndarray    # [n_regions] int32
    seq_len: int = 0
    num_images: int = 0

    def __post_init__(self):
        self.seq_len = int(len(self.input_ids))


def expand_multimodal_tokens(
    tokens: list[int],
    units_per_image: list[int],
    image_token_id: int | list[int] = QWEN2_5_VL_IMAGE_TOKEN_INDEX,
) -> SpliceInfo:
    """Expand -200 sentinels into `units_per_image[i]` copies of the image
    token id and record scatter positions for image / region features.

    image_token_id may be a per-slot list (video slots use the video pad id
    so get_rope_index applies temporal positions).

    The resulting id sequence equals the reference's `new_input_ids`
    (omchat_qwen2_5_vl.py:282,357): real vocab ids everywhere except region
    slots, which keep REGION_TOKEN_INDEX until the embedding scatter.
    """
    if isinstance(image_token_id, int):
        image_token_id = [image_token_id] * len(units_per_image)
    out: list[int] = []
    image_positions: list[int] = []
    region_positions: list[int] = []
    img = 0
    for tok in tokens:
        if tok == IMAGE_TOKEN_INDEX:
            n = units_per_image[img]
            tid = image_token_id[img]
            img += 1
            image_positions.extend(range(len(out), len(out) + n))
            out.extend([tid] * n)
        elif tok == REGION_TOKEN_INDEX:
            region_positions.append(len(out))
            out.append(REGION_TOKEN_INDEX)
        else:
            out.append(tok)
    if img != len(units_per_image):
        raise ValueError(
            f"prompt has {img} image slots but {len(units_per_image)} images")
    return SpliceInfo(
        input_ids=np.asarray(out, np.int32),
        image_positions=np.asarray(image_positions, np.int32),
        region_positions=np.asarray(region_positions, np.int32),
        num_images=img,
    )
