"""The tokenizer the benchmark hands to the program and to the reference.

The released Qwen tokenizer files are not in the repository and there is no
network, so requests are tokenized one character per token, with the real
ChatML and vision special-token ids of the Qwen2.5-VL vocabulary. Plain
characters map to their code points (capped below the special ids), so
prompts are longer than the released tokenizer makes them: the demo request
(7 boxes) is 1,771 tokens, of which 1,564 are image tokens.
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


class CharTokenizer:
    bos_token_id = None
    pad_token_id = 151643
    eos_token_id = 151645

    def encode(self, text: str) -> list[int]:
        ids = []
        for part in re.split(_PATTERN, text):
            if part in SPECIALS:
                ids.append(SPECIALS[part])
            else:
                ids.extend(min(ord(c), 150000) for c in part)
        return ids

    def __call__(self, text: str):
        class _Out:
            def __init__(self, ids):
                self.input_ids = ids

        return _Out(self.encode(text))

    def decode(self, ids, **kw) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i in _ID_TO_SPECIAL:
                out.append(_ID_TO_SPECIAL[i])
            elif 0 <= i < 0x110000:
                out.append(chr(i))
        return "".join(out)
