"""Serving entry points of the port."""
