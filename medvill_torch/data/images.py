"""Host-side image decode (a copy of the part of medvill_tpu/data/images.py
the server and the pretraining loader use).

``load_image`` returns [size, size, 3] uint8 NHWC -- the raw-pixel wire
format; ``models/resnet.py::device_normalize`` applies to_float + ImageNet
normalize on the device.
"""
from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def load_image(path, size: int, channels: int = 3,
               grayscale_to_rgb: bool = False,
               do_resize: bool = True) -> np.ndarray:
    """Decode (a path or a file object) -> optional grayscale->3ch ->
    bilinear resize to ``size`` -> uint8 [H, W, 3].  ``channels`` names the
    source's channel count (``--img_channel``); the output is 3-channel
    either way, as in the JAX package."""
    del channels
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    img = Image.open(path)
    if grayscale_to_rgb:
        img = img.convert("L").convert("RGB")
    else:
        img = img.convert("RGB")
    if do_resize:
        img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img)


def as_wire_image(img: np.ndarray) -> np.ndarray:
    """A loader output in the device wire format: uint8 passes through raw
    (normalized on the device), anything else becomes float32 (taken as
    already normalized)."""
    img = np.asarray(img)
    return img if img.dtype == np.uint8 else img.astype(np.float32)
