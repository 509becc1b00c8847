"""Utilities of the port: logging and TensorBoard scalars."""
