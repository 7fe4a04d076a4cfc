"""The neural stacks of the port: the layer runtime (``nnet``), weight
blobs (``weights``), the DRED RDOVAE networks (``rdovae``), the FARGAN
vocoder (``fargan``) and the host-side DRED payload decode (``dred``,
``dred_dec``), ports of ``opus_tpu/dnn``'s modules of the same names."""
