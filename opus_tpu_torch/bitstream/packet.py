"""Copy of the packet parser of ``opus_tpu/bitstream/packet.py``
(``packet_parse``, the frame count and size coding it and the repacketizer
need, and the TOC helpers ``Mode``, ``Bandwidth``, ``packet_get_mode``,
``packet_get_bandwidth``, ``packet_get_nb_channels`` and
``packet_get_nb_samples`` the top-level decoder needs) for the PyTorch port, which imports nothing of the JAX package: it
finds a packet's padding, where DRED rides (reference: src/opus.c
opus_packet_parse_impl).  Errors are the reference's negative codes.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

OPUS_OK = 0
OPUS_BAD_ARG = -1
OPUS_BUFFER_TOO_SMALL = -2
OPUS_INTERNAL_ERROR = -3
OPUS_INVALID_PACKET = -4
OPUS_UNIMPLEMENTED = -5
OPUS_INVALID_STATE = -6
OPUS_ALLOC_FAIL = -7


class Mode(IntEnum):
    SILK_ONLY = 1000
    HYBRID = 1001
    CELT_ONLY = 1002


class Bandwidth(IntEnum):
    NARROWBAND = 1101      # 4 kHz
    MEDIUMBAND = 1102      # 6 kHz
    WIDEBAND = 1103        # 8 kHz
    SUPERWIDEBAND = 1104   # 12 kHz
    FULLBAND = 1105        # 20 kHz


def packet_get_samples_per_frame(data: bytes, fs: int) -> int:
    toc = data[0]
    if toc & 0x80:
        audiosize = (toc >> 3) & 0x3
        return (fs << audiosize) // 400
    if (toc & 0x60) == 0x60:
        return fs // 50 if (toc & 0x08) else fs // 100
    audiosize = (toc >> 3) & 0x3
    if audiosize == 3:
        return fs * 60 // 1000
    return (fs << audiosize) // 100


def packet_get_mode(data: bytes) -> Mode:
    toc = data[0]
    if toc & 0x80:
        return Mode.CELT_ONLY
    if (toc & 0x60) == 0x60:
        return Mode.HYBRID
    return Mode.SILK_ONLY


def packet_get_bandwidth(data: bytes) -> Bandwidth:
    toc = data[0]
    if toc & 0x80:
        bw = Bandwidth.MEDIUMBAND + ((toc >> 5) & 0x3)
        if bw == Bandwidth.MEDIUMBAND:
            bw = Bandwidth.NARROWBAND
    elif (toc & 0x60) == 0x60:
        bw = Bandwidth.FULLBAND if (toc & 0x10) else Bandwidth.SUPERWIDEBAND
    else:
        bw = Bandwidth.NARROWBAND + ((toc >> 5) & 0x3)
    return Bandwidth(bw)


def packet_get_nb_channels(data: bytes) -> int:
    return 2 if (data[0] & 0x4) else 1


def packet_get_nb_frames(data: bytes) -> int:
    if len(data) < 1:
        return OPUS_BAD_ARG
    count = data[0] & 0x3
    if count == 0:
        return 1
    if count != 3:
        return 2
    if len(data) < 2:
        return OPUS_INVALID_PACKET
    return data[1] & 0x3F


def packet_get_nb_samples(data: bytes, fs: int) -> int:
    count = packet_get_nb_frames(data)
    if count < 0:
        return count
    samples = count * packet_get_samples_per_frame(data, fs)
    if samples * 25 > fs * 3:
        return OPUS_INVALID_PACKET
    return samples


def encode_size(size: int) -> bytes:
    """1- or 2-byte frame length encoding."""
    if size < 252:
        return bytes([size])
    b0 = 252 + (size & 0x3)
    return bytes([b0, (size - b0) >> 2])


def parse_size(data: bytes, length: int) -> tuple[int, int]:
    """Returns (bytes_consumed, size); size=-1 on error."""
    if length < 1:
        return -1, -1
    if data[0] < 252:
        return 1, data[0]
    if length < 2:
        return -1, -1
    return 2, 4 * data[1] + data[0]


@dataclass
class ParsedPacket:
    toc: int
    frames: list[bytes]          # frame payloads
    frame_offsets: list[int]     # offsets of each frame within the packet
    payload_offset: int
    packet_offset: int           # end of this packet (for self-delimited chains)
    padding: bytes               # padding payload (extensions live here)

    @property
    def count(self) -> int:
        return len(self.frames)


def packet_parse(data: bytes, length: int | None = None,
                 self_delimited: bool = False) -> ParsedPacket | int:
    """Parse code 0-3 framing.  Returns ParsedPacket or a negative error."""
    if length is None:
        length = len(data)
    if length < 0:
        return OPUS_BAD_ARG
    if length == 0:
        return OPUS_INVALID_PACKET

    framesize = packet_get_samples_per_frame(data, 48000)
    pos = 0
    cbr = False
    toc = data[pos]
    pos += 1
    length -= 1
    last_size = length
    pad = 0
    sizes: list[int] = []

    code = toc & 0x3
    if code == 0:
        count = 1
    elif code == 1:
        count = 2
        cbr = True
        if not self_delimited:
            if length & 0x1:
                return OPUS_INVALID_PACKET
            last_size = length // 2
            sizes.append(last_size)
    elif code == 2:
        count = 2
        nb, sz = parse_size(data[pos:], length)
        if sz < 0 or sz > length - nb:
            return OPUS_INVALID_PACKET
        length -= nb
        pos += nb
        sizes.append(sz)
        last_size = length - sz
    else:
        if length < 1:
            return OPUS_INVALID_PACKET
        ch = data[pos]
        pos += 1
        count = ch & 0x3F
        if count <= 0 or framesize * count > 5760:
            return OPUS_INVALID_PACKET
        length -= 1
        if ch & 0x40:  # padding flag
            while True:
                if length <= 0:
                    return OPUS_INVALID_PACKET
                p = data[pos]
                pos += 1
                length -= 1
                tmp = 254 if p == 255 else p
                length -= tmp
                pad += tmp
                if p != 255:
                    break
        if length < 0:
            return OPUS_INVALID_PACKET
        cbr = not (ch & 0x80)
        if not cbr:
            last_size = length
            for _ in range(count - 1):
                nb, sz = parse_size(data[pos:], length)
                if sz < 0 or sz > length - nb:
                    return OPUS_INVALID_PACKET
                length -= nb
                pos += nb
                sizes.append(sz)
                last_size -= nb + sz
            if last_size < 0:
                return OPUS_INVALID_PACKET
        elif not self_delimited:
            last_size = length // count
            if last_size * count != length:
                return OPUS_INVALID_PACKET
            sizes.extend([last_size] * (count - 1))

    if self_delimited:
        nb, sz_last = parse_size(data[pos:], length)
        if sz_last < 0 or sz_last > length - nb:
            return OPUS_INVALID_PACKET
        length -= nb
        pos += nb
        if cbr:
            if sz_last * count > length:
                return OPUS_INVALID_PACKET
            sizes = [sz_last] * (count - 1)
        elif nb + sz_last > last_size:
            return OPUS_INVALID_PACKET
        sizes.append(sz_last)
    else:
        if last_size > 1275:
            return OPUS_INVALID_PACKET
        sizes.append(last_size)

    payload_offset = pos
    frames = []
    offsets = []
    for sz in sizes[:count]:
        frames.append(bytes(data[pos:pos + sz]))
        offsets.append(pos)
        pos += sz

    padding = bytes(data[pos:pos + pad])
    packet_offset = pad + pos
    return ParsedPacket(toc=toc, frames=frames, frame_offsets=offsets,
                        payload_offset=payload_offset,
                        packet_offset=packet_offset, padding=padding)
