"""Data for the port: synthetic flagship batches (numpy)."""
