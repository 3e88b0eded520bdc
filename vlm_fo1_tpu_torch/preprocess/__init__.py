from vlm_fo1_tpu_torch.preprocess.image import (  # noqa: F401
    load_image,
    image_to_base64,
    smart_resize,
    resize_shortest_edge_images_and_bboxes,
    adjust_bbox,
    qwen_image_preprocess,
    qwen_image_patchify_u8,
    qwen_image_raw_u8,
    patchify_raw_np,
    qwen_patch_norm_vectors,
    qwen_video_preprocess,
    aux_image_preprocess,
    aux_image_u8,
)
from vlm_fo1_tpu_torch.preprocess.windowing import ViTPlan, build_vit_plan  # noqa: F401
from vlm_fo1_tpu_torch.preprocess.mrope import get_rope_index  # noqa: F401
