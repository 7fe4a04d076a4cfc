"""The multistream Opus decoder over B lanes: a port of
``opus_tpu/models/multistream.py`` ``OpusMSDecoder`` (:300-370;
reference: src/opus_multistream_decoder.c) and its surround layouts
(``VORBIS_MAPPINGS``, ``default_surround_layout``, :33-44).

A multistream packet holds ``streams`` elementary Opus packets back to
back, every one but the last self-delimited; the first
``coupled_streams`` are stereo, the rest mono; ``mapping`` gives each
output channel its decoded channel (stereo stream s's left and right are
2s and 2s + 1, mono stream s is coupled_streams + s) or 255 (silence).

How a call runs.  Each lane's packet is split on the host
(``split``): the self-delimited parse of every stream but the last, and
each elementary packet rebuilt byte for byte as the JAX package rebuilds
it (the TOC with code 0 for one frame, else code 3 with the VBR flag).
Then one ``BatchedOpusDecoder(channels=2)`` decodes the B x coupled lanes
and one ``BatchedOpusDecoder(channels=1)`` the B x uncoupled lanes (lane
i's stream s on row i * coupled + s, or i * uncoupled + s - coupled), all
at ``fs``; the mapping is one gather over their outputs.  Kernels: those
of ``BatchedOpusDecoder`` (K1, K2, K4).

Every lane carries a packet at every call, as in the JAX package, whose
``decode`` has no path for a lost multistream packet.  A lane whose
packet does not parse gets ``status`` OPUS_INVALID_PACKET, no output and
an untouched state.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bitstream import packet as pkt
from .opus_decoder import BatchedOpusDecoder, to_int24

# (reference: vorbis_mappings src/opus_multistream_encoder.c:52):
# (streams, coupled streams, mapping) for 1-8 channels
VORBIS_MAPPINGS = (
    (1, 0, (0,)),
    (1, 1, (0, 1)),
    (2, 1, (0, 2, 1)),
    (2, 2, (0, 1, 2, 3)),
    (3, 2, (0, 4, 1, 2, 3)),
    (4, 2, (0, 4, 1, 2, 3, 5)),
    (4, 3, (0, 4, 1, 2, 3, 5, 6)),
    (5, 3, (0, 6, 1, 2, 3, 4, 5, 7)),
)

# an elementary packet that never parses (code 3, no frames): a lane whose
# multistream packet is invalid gets it, so its decoders change nothing
_INVALID = bytes([0x03, 0x00])


def default_surround_layout(channels: int):
    """(reference: opus_multistream_surround_encoder_init, family 1)"""
    if not 1 <= channels <= 8:
        raise ValueError("surround layout supports 1-8 channels")
    streams, coupled, mapping = VORBIS_MAPPINGS[channels - 1]
    return streams, coupled, list(mapping)


def split(data: bytes, streams: int):
    """A multistream packet -> its ``streams`` elementary packets, rebuilt
    as multistream.py:330-345 rebuilds them, or a negative error code."""
    out = []
    pos = 0
    for s in range(streams):
        parsed = pkt.packet_parse(data[pos:],
                                  self_delimited=s != streams - 1)
        if isinstance(parsed, int):
            return parsed
        if parsed.count == 1:
            out.append(bytes([parsed.toc & 0xFC]) + parsed.frames[0])
        else:
            body = bytearray([parsed.toc | 0x03, 0x80 | parsed.count])
            for f in parsed.frames[:-1]:
                body += pkt.encode_size(len(f))
            for f in parsed.frames:
                body += f
            out.append(bytes(body))
        pos += parsed.packet_offset
    return out


class BatchedOpusMSDecoder:
    """B multistream Opus streams of one layout decoded to float PCM at
    ``fs`` with ``channels`` output channels, on the card (the default
    device) or with ``device="cpu"`` on the plain versions.

    ``decode(packets)``: one multistream packet (bytes) a lane -> (pcm
    float32 [B, W, channels], n [B] numpy samples per channel);
    ``decode_int16`` (FLOAT2INT16 with no soft clip, as the JAX package's)
    and ``decode24``.  ``status`` [B] (numpy): 0, or OPUS_INVALID_PACKET
    on a lane whose packet or one of whose elementary packets did not
    parse, or whose streams' durations differ, or an elementary decoder's
    status (OPUS_UNIMPLEMENTED for a QEXT packet).  ``final_range`` [B,
    streams]: each elementary decoder's."""

    def __init__(self, batch: int, fs: int, channels: int, streams: int,
                 coupled_streams: int, mapping, device="cuda",
                 max_payload: int = 1275):
        mapping = [int(m) for m in mapping]
        if streams < 1 or not 0 <= coupled_streams <= streams \
                or len(mapping) != channels or streams + coupled_streams > 255 \
                or any(m != 255 and m >= streams + coupled_streams
                       for m in mapping):
            raise ValueError("BatchedOpusMSDecoder: bad layout")
        self.batch, self.fs, self.channels = batch, fs, channels
        self.streams, self.coupled_streams = streams, coupled_streams
        self.mapping = mapping
        self.device = torch.device(device)
        cp, mn = coupled_streams, streams - coupled_streams
        kw = dict(fs=fs, device=device, max_payload=max_payload)
        self.coupled = BatchedOpusDecoder(batch * cp, channels=2, **kw) \
            if cp else None
        self.mono = BatchedOpusDecoder(batch * mn, channels=1, **kw) \
            if mn else None
        # the gather: decoded channel -> column of [coupled L/R..., mono...,
        # silence]
        self.columns = torch.as_tensor(
            [2 * cp + mn if m == 255 else m for m in mapping],
            device=self.device)
        self.status = np.zeros(batch, np.int64)

    def set_state(self, st: dict) -> None:
        """Takes a ``convert.opus_ms_decoder_state`` dict (``coupled``,
        ``mono``: the inner decoders' ``set_state`` dicts)."""
        for name in ("coupled", "mono"):
            if getattr(self, name) is not None:
                getattr(self, name).set_state(st[name])

    @property
    def final_range(self):
        rows = []
        for dec, k in ((self.coupled, self.coupled_streams),
                       (self.mono, self.streams - self.coupled_streams)):
            if dec is not None:
                rows.append(dec.final_range.reshape(self.batch, k))
        return torch.cat(rows, dim=1)

    def _split_lanes(self, packets):
        """Every lane's elementary packets ([B][streams] bytes) and the
        lanes whose packet did not split ([B] bool)."""
        subs, bad = [], np.zeros(self.batch, bool)
        for i, data in enumerate(packets):
            if data is None:
                raise ValueError("BatchedOpusMSDecoder: every lane needs a "
                                 "packet (no concealment at this level)")
            got = split(bytes(data), self.streams)
            if isinstance(got, int):
                bad[i] = True
                got = [_INVALID] * self.streams
            subs.append(got)
        return subs, bad

    def decode(self, packets):
        b, cp = self.batch, self.coupled_streams
        mn = self.streams - cp
        if len(packets) != b:
            raise ValueError(f"decode: {len(packets)} packets for {b} lanes")
        subs, bad = self._split_lanes(packets)
        outs, ns, status = [], [], [bad * pkt.OPUS_INVALID_PACKET]
        for dec, first, k in ((self.coupled, 0, cp), (self.mono, cp, mn)):
            if dec is None:
                continue
            pcm, n = dec.decode([subs[i][first + s] for i in range(b)
                                 for s in range(k)])
            # [B * k, W(, 2)] -> [B, W, k * C]: stream s's channels at
            # columns s * C + lr
            c = 2 if pcm.dim() == 3 else 1
            outs.append(pcm.reshape(b, k, -1, c).permute(0, 2, 1, 3)
                        .reshape(b, pcm.shape[1], k * c))
            ns.append(n.reshape(b, k))
            status.append(dec.status.reshape(b, k).min(axis=1))
        n_all = np.concatenate(ns, axis=1)
        n = n_all[:, 0]
        uneven = (n_all != n[:, None]).any(axis=1)
        st = np.minimum.reduce(status)
        self.status = np.where((st == 0) & uneven, pkt.OPUS_INVALID_PACKET,
                               st)
        w = max(o.shape[1] for o in outs)
        cols = [torch.nn.functional.pad(o, (0, 0, 0, w - o.shape[1]))
                for o in outs]
        cols.append(torch.zeros((b, w, 1), dtype=torch.float32,
                                device=self.device))
        pcm = torch.cat(cols, dim=2).index_select(2, self.columns)
        return pcm, np.where(self.status == 0, n, 0)

    def decode_int16(self, packets):
        """``decode``, then FLOAT2INT16 with no soft clip (multistream.py:
        361)."""
        from ..utils.soft_clip import float2int16_lanes
        pcm, n = self.decode(packets)
        return float2int16_lanes(pcm), n

    def decode24(self, packets):
        pcm, n = self.decode(packets)
        return to_int24(pcm), n
