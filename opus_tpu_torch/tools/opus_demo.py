"""opus_demo's decode over N streams at once, on the port's top-level
decoder (``BatchedOpusDecoder``): the counterpart of
``opus_tpu/tools/opus_demo.py`` ``decode`` (reference: src/opus_demo.c's
decode loop) at 8, 12, 16, 24 or 48 kHz with one or two output channels
(``opus_demo -d <rate> 1|2``), without the simulated-loss and DRED
options (those are ``tools/sim_loss.py``'s).

Each input is a .bit file in opus_demo's format: per packet a 4-byte
big-endian length, the encoder's 4-byte final range, then the packet.
The N files are decoded as N lanes, one packet a lane per call; a
packet of length 0 is a lost one (concealed for the last packet's
duration).  Each packet's final range is checked against the one
stored with it (where that is not 0), and each stream is written as raw
16-bit little-endian PCM (interleaved with two channels), ``floor(x *
32768 + 0.5)`` clipped, as opus_demo writes it.  Runs on the card unless
``--device cpu``:

    python -m opus_tpu_torch.tools.opus_demo decode [--device cpu] \\
        [--rate 16000] [--channels 2] in0.bit out0.pcm [in1.bit out1.pcm ...]

Exit code 1 if a final range differs or a packet is invalid.
"""

from __future__ import annotations

import argparse
import struct
import sys

import numpy as np


def read_packets(bit_path: str):
    """[(packet bytes, encoder final range)] of an opus_demo .bit file."""
    data = open(bit_path, "rb").read()
    pos = 0
    packets = []
    while pos + 8 <= len(data):
        length, enc_range = struct.unpack(">iI", data[pos:pos + 8])
        pos += 8
        packets.append((data[pos:pos + length], enc_range))
        pos += length
    return packets


def decode(bit_paths, pcm_paths, device="cuda", channels: int = 1,
           fs: int = 48000) -> int:
    """Decodes the streams of ``bit_paths`` as lanes of one decoder at
    ``fs`` with ``channels`` output channels and writes ``pcm_paths``;
    returns opus_demo's exit code."""
    import torch

    from ..models.opus_decoder import BatchedOpusDecoder

    streams = [read_packets(p) for p in bit_paths]
    b = len(streams)
    dec = BatchedOpusDecoder(b, fs=fs, channels=channels, device=device)
    outs = [[] for _ in range(b)]
    mismatches = np.zeros(b, np.int64)
    invalid = np.zeros(b, np.int64)
    for t in range(max((len(s) for s in streams), default=0)):
        live = np.array([t < len(s) for s in streams])
        pk = [(s[t][0] or None) if t < len(s) else None for s in streams]
        pcm, n = dec.decode(pk)
        pcm16 = torch.clamp(torch.floor(pcm.to(torch.float64) * 32768 + 0.5),
                            -32768, 32767).to(torch.int16).cpu().numpy()
        rng = dec.final_range.cpu().numpy()
        for i in np.nonzero(live)[0]:
            outs[i].append(pcm16[i, :n[i]].reshape(-1))
            if dec.status[i]:
                invalid[i] += 1
            enc_range = streams[i][t][1]
            if pk[i] is not None and enc_range and rng[i] != enc_range:
                mismatches[i] += 1
    for i, path in enumerate(pcm_paths):
        pcm = np.concatenate(outs[i]) if outs[i] else np.zeros(0, np.int16)
        pcm.astype("<i2").tofile(path)
        print(f"{bit_paths[i]}: {len(streams[i])} packets -> "
              f"{len(pcm) // channels} samples" + (f", {mismatches[i]} final_range mismatches"
                            if mismatches[i] else "")
              + (f", {invalid[i]} invalid packets" if invalid[i] else ""),
              file=sys.stderr)
    if dec.flagged.any():
        print(f"flagged lanes: {np.nonzero(dec.flagged)[0].tolist()}",
              file=sys.stderr)
    return 1 if mismatches.any() or invalid.any() else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m opus_tpu_torch.tools."
                                "opus_demo")
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("decode", help="decode N .bit files as N lanes")
    d.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain versions)")
    d.add_argument("--rate", type=int, default=48000,
                   choices=(8000, 12000, 16000, 24000, 48000),
                   help="output rate (opus_demo -d <rate> ...)")
    d.add_argument("--channels", type=int, default=1, choices=(1, 2),
                   help="output channels (opus_demo -d <rate> 1|2)")
    d.add_argument("files", nargs="+",
                   help="in0.bit out0.pcm [in1.bit out1.pcm ...]")
    args = p.parse_args(argv)
    if len(args.files) % 2:
        p.error("files come in pairs: in.bit out.pcm")
    return decode(args.files[0::2], args.files[1::2], args.device,
                  args.channels, args.rate)


if __name__ == "__main__":
    sys.exit(main())
