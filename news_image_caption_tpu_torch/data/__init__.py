"""Data for the port (numpy): synthetic news-caption datasets and
collation."""
