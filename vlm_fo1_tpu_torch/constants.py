"""Token protocol constants shared with the VLM-FO1 checkpoint format.

These values define the *wire format* between prompt assembly, the tokenizer
splice and the multimodal embedding scatter; they must match the reference
(vlm_fo1/constants.py:5-29) exactly for checkpoint compatibility.
"""

IGNORE_INDEX = -100

# Sentinel ids inserted by the tokenizer splice; never reach the embedding
# table (they are replaced by image / region features on-device).
IMAGE_TOKEN_INDEX = -200
REGION_TOKEN_INDEX = -300
DEFAULT_REGION_INDEX = REGION_TOKEN_INDEX  # reference-compatible alias

DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"

# Qwen2.5-VL vision markup (real vocabulary entries).
QWEN2_5_VL_IMAGE_TOKEN = "<|image_pad|>"
QWEN2_5_VL_IMAGE_TOKEN_INDEX = 151655
VISION_START_TOKEN = "<|vision_start|>"
VISION_END_TOKEN = "<|vision_end|>"
VISION_START_TOKEN_ID = 151652
VISION_END_TOKEN_ID = 151653
VIDEO_TOKEN_ID = 151656

# ChatML framing.
IM_START = "<|im_start|>"
IM_END = "<|im_end|>"
IM_START_TOKEN_ID = 151644
IM_END_TOKEN_ID = 151645

# Region markup.
DEFAULT_REGION_TOKEN = "<region<i>>"
DEFAULT_REGION_FEATURE_TOKEN = "<regionfeat>"

# Grounded-output markup emitted by the model and parsed by
# vlm_fo1_tpu_torch.postprocess (reference: constants.py:21-25).
GROUNDING_START = "<ground>"
GROUNDING_END = "</ground>"
OBJECTS_START = "<objects>"
OBJECTS_END = "</objects>"

THINK_START = "<think>"
THINK_END = "</think>"
