"""Utilities of the port: logging, TensorBoard scalars, profiling and
the registries."""
