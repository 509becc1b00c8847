"""PyTorch + CUDA port of the flagship news-image captioner.

The JAX package `news_image_caption_tpu` is the reference this port is
held against; the port imports `torch` and numpy, never `jax`. Its
decode kernels are CUDA C++ for Hopper (`csrc/`), built on first use;
each kernel module keeps a plain PyTorch version that CPU tensors take.
`Registry` (`utils/registry.py`) is exported as the reference exports
it: a model, decoder or dataset registered under a name builds from a
YAML whose `type` names it.
"""

from news_image_caption_tpu_torch.utils.registry import Registry  # noqa: F401
