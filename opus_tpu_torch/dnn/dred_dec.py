"""Finding a packet's DRED payload: the port's copy of
``dred_find_payload`` from ``opus_tpu/dnn/dred_dec.py`` (reference:
dred_find_payload src/opus_decoder.c:1468), numpy-free host code."""

from __future__ import annotations

from ..bitstream import packet as pkt
from ..bitstream.extensions import ExtensionData, ExtensionIterator
from . import dred

DRED_EXPERIMENTAL_BYTES = 2     # (dred_config.h:36)


def dred_find_payload(data: bytes):
    """Returns (payload bytes, dred_frame_offset) or None (reference:
    dred_find_payload src/opus_decoder.c:1468)."""
    parsed = pkt.packet_parse(data)
    if isinstance(parsed, int):
        return None
    frame_size = pkt.packet_get_samples_per_frame(data, 48000)
    it = ExtensionIterator(parsed.padding, parsed.count)
    while True:
        ext = it.find(dred.DRED_EXTENSION_ID)
        if not isinstance(ext, ExtensionData):
            return None
        frame_offset = ext.frame * frame_size // 120
        if len(ext.data) > DRED_EXPERIMENTAL_BYTES \
                and ext.data[0] == ord('D') \
                and ext.data[1] == dred.DRED_EXPERIMENTAL_VERSION:
            return bytes(ext.data[2:]), frame_offset
