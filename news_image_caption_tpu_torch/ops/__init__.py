"""Layers and the decode kernels of the port."""
