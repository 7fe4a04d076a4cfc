"""Host-side bitstream readers for the port: copies of the parts of
``opus_tpu/bitstream/{range_coder,laplace,packet,extensions}.py`` that the
DRED payload parse reaches (the standard library only)."""
