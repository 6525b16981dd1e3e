from .dataset import DataLoader, RLHFDataset, collate_fn, load_rows
from .image import process_image, smart_resize_dims
from .packing import pack_vision_batch
from .template import build_chat_text

__all__ = ["DataLoader", "RLHFDataset", "collate_fn", "load_rows", "process_image", "smart_resize_dims",
           "pack_vision_batch", "build_chat_text"]
