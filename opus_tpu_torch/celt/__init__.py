"""CELT mode tables for the port: copies of ``opus_tpu/celt/{cwrs,modes,
tables}.py`` (numpy and the standard library only)."""
