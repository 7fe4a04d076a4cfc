"""Copy of the Opus repacketizer of ``opus_tpu/bitstream/repacketizer.py``
(``Repacketizer.cat`` / ``out_range``: merge frames into one packet,
carrying padding extensions) for the PyTorch port, which imports nothing
of the JAX package; the DRED encoder attaches its extension-126 payload
with it (reference: src/repacketizer.c)."""

from __future__ import annotations

from . import packet as pkt
from .extensions import (ExtensionData, extensions_generate,
                         extensions_parse)


class Repacketizer:
    """(reference: opus_repacketizer_init repacketizer.c:43)"""

    def __init__(self):
        self.reset()

    def reset(self):
        self.toc = 0
        self.framesize = 0
        self.frames: list[bytes] = []
        self.paddings: list[bytes] = []
        self.padding_nb_frames: list[int] = []

    @property
    def nb_frames(self) -> int:
        return len(self.frames)

    def cat(self, data: bytes, self_delimited: bool = False) -> int:
        """Append a packet's frames (reference:
        opus_repacketizer_cat_impl repacketizer.c:62)."""
        if len(data) < 1:
            return pkt.OPUS_INVALID_PACKET
        if self.nb_frames == 0:
            self.toc = data[0]
            self.framesize = pkt.packet_get_samples_per_frame(data, 8000)
        elif (self.toc & 0xFC) != (data[0] & 0xFC):
            return pkt.OPUS_INVALID_PACKET
        curr = pkt.packet_get_nb_frames(data)
        if curr < 1:
            return pkt.OPUS_INVALID_PACKET
        if (curr + self.nb_frames) * self.framesize > 960:
            return pkt.OPUS_INVALID_PACKET
        parsed = pkt.packet_parse(data, self_delimited=self_delimited)
        if isinstance(parsed, int):
            return parsed
        self.frames.append(parsed.frames[0])
        self.paddings.append(parsed.padding)
        self.padding_nb_frames.append(parsed.count)
        for f in parsed.frames[1:]:
            self.frames.append(f)
            self.paddings.append(b"")
            self.padding_nb_frames.append(0)
        return pkt.OPUS_OK

    # ------------------------------------------------------------------
    def out_range(self, begin: int, end: int, maxlen: int = 1277 * 48,
                  self_delimited: bool = False, pad: bool = False,
                  extensions: list[ExtensionData] | None = None):
        """Assemble frames [begin, end) into one packet (reference:
        opus_repacketizer_out_range_impl repacketizer.c:114).
        Returns bytes or a negative error."""
        if begin < 0 or begin >= end or end > self.nb_frames:
            return pkt.OPUS_BAD_ARG
        count = end - begin
        lens = [len(f) for f in self.frames[begin:end]]
        frames = self.frames[begin:end]

        # gather extensions: explicit + those carried in source padding
        all_ext: list[ExtensionData] = list(extensions or [])
        for i in range(begin, end):
            if self.paddings[i]:
                parsed = extensions_parse(self.paddings[i],
                                          self.padding_nb_frames[i])
                if isinstance(parsed, int):
                    return pkt.OPUS_INVALID_PACKET
                for e in parsed:
                    all_ext.append(ExtensionData(e.id, e.frame + i - begin,
                                                 e.data))

        out = bytearray()
        sd_tail = (pkt.encode_size(lens[-1]) if self_delimited else b"")

        if count == 1 and not pad and not all_ext:
            out.append(self.toc & 0xFC)
            out += sd_tail
            out += frames[0]
            return self._check(out, maxlen)
        if count == 2 and not pad and not all_ext:
            if lens[0] == lens[1]:
                out.append((self.toc & 0xFC) | 0x1)
                out += sd_tail
                out += frames[0] + frames[1]
            else:
                out.append((self.toc & 0xFC) | 0x2)
                out += pkt.encode_size(lens[0])
                out += sd_tail
                out += frames[0] + frames[1]
            return self._check(out, maxlen)

        # code 3
        vbr = any(l != lens[0] for l in lens[1:])
        out.append((self.toc & 0xFC) | 0x3)
        out.append(count | (0x80 if vbr else 0))
        sizes = b"".join(pkt.encode_size(l) for l in lens[:-1]) if vbr \
            else b""
        base = len(out) + len(sizes) + len(sd_tail) + sum(lens)

        ext_bytes = b""
        if all_ext:
            n = extensions_generate(all_ext, count, maxlen, pad=False)
            if isinstance(n, int) and n < 0:
                return n
            buf = bytearray(n)
            extensions_generate(all_ext, count, n, pad=False, out=buf)
            ext_bytes = bytes(buf)

        pad_amount = 0
        if pad:
            pad_amount = maxlen - base
        elif ext_bytes:
            n = len(ext_bytes)
            pad_amount = n + ((n + 253) // 254 if n else 1)
        if pad_amount > 0:
            out[1] |= 0x40
            nb_255s = (pad_amount - 1) // 255
            chain = bytes([255] * nb_255s
                          + [pad_amount - 255 * nb_255s - 1])
            filler = pad_amount - len(chain) - len(ext_bytes)
            if filler < 0:
                return pkt.OPUS_BUFFER_TOO_SMALL
            out += chain
            # 0x01 separators before extension data; plain zeros otherwise
            fill_byte = 0x01 if ext_bytes else 0x00
            padding_block = bytes([fill_byte] * filler) + ext_bytes
        else:
            padding_block = b""
        out += sizes
        out += sd_tail
        for f in frames:
            out += f
        out += padding_block
        return self._check(out, maxlen)

    @staticmethod
    def _check(out, maxlen):
        if len(out) > maxlen:
            return pkt.OPUS_BUFFER_TOO_SMALL
        return bytes(out)
