from .dataset import RLHFDataset, collate_fn
from .image import process_image, smart_resize_dims
from .packing import pack_vision_batch
from .template import build_chat_text

__all__ = ["RLHFDataset", "collate_fn", "process_image", "smart_resize_dims",
           "pack_vision_batch", "build_chat_text"]
