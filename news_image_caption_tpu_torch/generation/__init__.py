"""Decode loops of the port."""
