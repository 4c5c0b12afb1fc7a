"""Host-side image decode (a copy of the part of medvill_tpu/data/images.py
the server uses).

``load_image`` returns [size, size, 3] uint8 NHWC -- the raw-pixel wire
format; ``models/resnet.py::device_normalize`` applies to_float + ImageNet
normalize on the device.
"""
from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def load_image(path, size: int, grayscale_to_rgb: bool = False,
               do_resize: bool = True) -> np.ndarray:
    """Decode (a path or a file object) -> optional grayscale->3ch ->
    bilinear resize to ``size`` -> uint8 [H, W, 3]."""
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
