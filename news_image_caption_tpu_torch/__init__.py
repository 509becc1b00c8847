"""PyTorch + CUDA port of the flagship news-image captioner.

The JAX package `news_image_caption_tpu` is the reference this port is
held against; the port imports `torch` and numpy, never `jax`. Its
decode kernels are CUDA C++ for Hopper (`csrc/`), built on first use;
each kernel module keeps a plain PyTorch version that CPU tensors take.
"""
