"""Decoder and captioner models of the port."""
