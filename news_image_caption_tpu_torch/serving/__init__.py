"""Serving entry points of the port: the server, its client and its
worker process (counterpart of `news_image_caption_tpu.serving`)."""

from news_image_caption_tpu_torch.serving.base import CaptionServer, ServerCmd
from news_image_caption_tpu_torch.serving.client import CaptioningClient
from news_image_caption_tpu_torch.serving.worker import CaptioningWorker

__all__ = ["CaptionServer", "ServerCmd", "CaptioningClient",
           "CaptioningWorker"]
