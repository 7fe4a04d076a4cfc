"""SILK tables for the port: copies of ``opus_tpu/silk/{tables,
tables_data}.py`` (the standard library only)."""
