"""Layers and the kernels of the port."""

from news_image_caption_tpu_torch.ops.conv import DynamicConv

__all__ = ["DynamicConv"]
