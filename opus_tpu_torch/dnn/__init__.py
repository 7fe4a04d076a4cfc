"""The neural stacks of the port: the layer runtime (``nnet``), weight
blobs (``weights``), the DRED RDOVAE networks (``rdovae``), the FARGAN
vocoder (``fargan``), the host-side DRED payload decode and the DRED
decoder objects (``dred``, ``dred_dec``), the LPCNet feature analysis
(``features``), the neural pitch estimator (``pitchdnn``), deep PLC
(``plc``) and OSCE speech enhancement (the adaptive filters ``nndsp``, the
features ``osce_features``, LACE and NoLACE ``osce``), ports of
``opus_tpu/dnn``'s modules of the same names."""
