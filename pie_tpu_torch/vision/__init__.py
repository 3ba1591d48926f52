"""Image loading and preprocessing utilities."""

from pie_tpu_torch.vision.utils import (
    BaseImageProcessor,
    Qwen2VLImageProcessor,
    SiglipImageProcessor,
    load_image,
    make_image_processor,
    process_image,
    qwen2vl_patchify,
    resize_image,
)
