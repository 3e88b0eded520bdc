"""Character-level fallback tokenizer with real ChatML special-token ids.

The released Qwen tokenizer files may be unavailable (offline machines,
random-init demos); this keeps every pipeline stage drivable — prompt
assembly, sentinel splice, generation, decode — with the exact special-token
protocol (reference constants.py:5-29). Token ids for plain text are
character ordinals, so they never collide with the -200/-300 sentinels.
"""

from __future__ import annotations

import re

SPECIALS = {
    "<|im_start|>": 151644,
    "<|im_end|>": 151645,
    "<|vision_start|>": 151652,
    "<|vision_end|>": 151653,
    "<|image_pad|>": 151655,
    "<|video_pad|>": 151656,
}
_ID_TO_SPECIAL = {v: k for k, v in SPECIALS.items()}
_PATTERN = "(" + "|".join(re.escape(s) for s in SPECIALS) + ")"


class FallbackTokenizer:
    bos_token_id = None
    pad_token_id = 151643
    eos_token_id = 151645

    def encode(self, text: str):
        ids = []
        for part in re.split(_PATTERN, text):
            if part in SPECIALS:
                ids.append(SPECIALS[part])
            else:
                ids.extend(min(ord(c), 150000) for c in part)
        return ids

    def __call__(self, text: str):
        class _Out:
            def __init__(self, i):
                self.input_ids = i

        return _Out(self.encode(text))

    def decode(self, ids, **kw):
        out = []
        for i in ids:
            i = int(i)
            if i in _ID_TO_SPECIAL:
                out.append(_ID_TO_SPECIAL[i])
            elif 0 <= i < 0x110000:
                out.append(chr(i))
        return "".join(out)
