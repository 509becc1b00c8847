"""Data for the port (numpy): synthetic news-caption datasets, collation,
the byte-BPE and its indexer, the readers, the NICS shards with their C++
reader and the offline materialization pass."""
