"""Copy of ``opus_tpu/bitstream/extensions.py`` (the reader
``ExtensionIterator`` / ``extensions_parse`` and the writer
``extensions_generate``) for the PyTorch port, which imports nothing of
the JAX package (reference: src/extensions.c:120-311, :471).

Extensions are (id, frame, payload) triples carried inside Opus padding;
DRED uses id 126.  The format has short (id < 32, 0/1-byte payload) and
long extensions, frame separators (id 1) and repeats (id 2).
"""

from __future__ import annotations

from dataclasses import dataclass

from .packet import OPUS_BAD_ARG, OPUS_BUFFER_TOO_SMALL, OPUS_INVALID_PACKET


@dataclass
class ExtensionData:
    id: int
    frame: int
    data: bytes

    @property
    def len(self) -> int:
        return len(self.data)


def _skip_extension_payload(data: bytes, pos: int, length: int, id_byte: int,
                            trailing_short_len: int):
    """Advance past one extension payload.
    Returns (pos, remaining_len, header_size) with remaining_len<0 on error."""
    header_size = 0
    ext_id = id_byte >> 1
    L = id_byte & 1
    if (ext_id == 0 and L == 1) or ext_id == 2:
        pass
    elif 0 < ext_id < 32:
        if length < L:
            return pos, -1, header_size
        pos += L
        length -= L
    else:
        if L == 0:
            if length < trailing_short_len:
                return pos, -1, header_size
            pos += length - trailing_short_len
            length = trailing_short_len
        else:
            nbytes = 0
            while True:
                if length < 1:
                    return pos, -1, header_size
                lacing = data[pos]
                pos += 1
                nbytes += lacing
                header_size += 1
                length -= lacing + 1
                if lacing != 255:
                    break
            if length < 0:
                return pos, -1, header_size
            pos += nbytes
    return pos, length, header_size


def _skip_extension(data: bytes, pos: int, length: int):
    """Advance past one whole extension (id byte + payload).
    Returns (pos, remaining_len, header_size)."""
    if length == 0:
        return pos, 0, 0
    if length < 1:
        return pos, -1, 0
    id_byte = data[pos]
    pos += 1
    length -= 1
    pos, length, header_size = _skip_extension_payload(data, pos, length,
                                                       id_byte, 0)
    if length >= 0:
        header_size += 1
    return pos, length, header_size


class ExtensionIterator:
    """Iterates (id, frame, payload) extensions in bitstream order
    (reference: opus_extension_iterator_* in src/extensions.c:120-311)."""

    def __init__(self, data: bytes, nb_frames: int):
        assert 0 <= nb_frames <= 48
        self.data = data
        self.len = len(data)
        self.curr_pos = 0
        self.curr_len = self.len
        self.repeat_pos = 0
        self.repeat_len = 0
        self.src_pos = 0
        self.src_len = 0
        self.last_long = -1          # position marker, -1 = none
        self.trailing_short_len = 0
        self.nb_frames = nb_frames
        self.frame_max = nb_frames
        self.curr_frame = 0
        self.repeat_frame = 0
        self.repeat_l = 0

    def reset(self):
        self.repeat_pos = self.curr_pos = 0
        self.last_long = -1
        self.curr_len = self.len
        self.repeat_frame = self.curr_frame = 0
        self.trailing_short_len = 0

    def set_frame_max(self, frame_max: int):
        self.frame_max = frame_max

    def _next_repeat(self):
        assert self.repeat_frame > 0
        d = self.data
        while self.repeat_frame < self.nb_frames:
            while self.src_len > 0:
                repeat_id_byte = d[self.src_pos]
                self.src_pos, self.src_len, _ = _skip_extension(
                    d, self.src_pos, self.src_len)
                assert self.src_len >= 0
                if repeat_id_byte <= 3:
                    continue
                if (self.repeat_l == 0
                        and self.repeat_frame + 1 >= self.nb_frames
                        and self.src_pos == self.last_long):
                    repeat_id_byte &= ~1
                curr_pos0 = self.curr_pos
                self.curr_pos, self.curr_len, header_size = \
                    _skip_extension_payload(d, self.curr_pos, self.curr_len,
                                            repeat_id_byte,
                                            self.trailing_short_len)
                if self.curr_len < 0:
                    return OPUS_INVALID_PACKET
                if self.repeat_frame >= self.frame_max:
                    continue
                return ExtensionData(
                    id=repeat_id_byte >> 1,
                    frame=self.repeat_frame,
                    data=bytes(d[curr_pos0 + header_size:self.curr_pos]))
            self.src_pos = self.repeat_pos
            self.src_len = self.repeat_len
            self.repeat_frame += 1
        self.repeat_pos = self.curr_pos
        self.last_long = -1
        if self.repeat_l == 0:
            self.curr_frame += 1
            if self.curr_frame >= self.nb_frames:
                self.curr_len = 0
        self.repeat_frame = 0
        return 0

    def next(self):
        """Returns ExtensionData, 0 when exhausted, or negative error code."""
        d = self.data
        if self.curr_len < 0:
            return OPUS_INVALID_PACKET
        if self.repeat_frame > 0:
            ret = self._next_repeat()
            if ret != 0:
                return ret
        if self.curr_frame >= self.frame_max:
            return 0
        while self.curr_len > 0:
            curr_pos0 = self.curr_pos
            id_byte = d[curr_pos0]
            ext_id = id_byte >> 1
            L = id_byte & 1
            self.curr_pos, self.curr_len, header_size = _skip_extension(
                d, self.curr_pos, self.curr_len)
            if self.curr_len < 0:
                return OPUS_INVALID_PACKET
            if ext_id == 1:
                if L == 0:
                    self.curr_frame += 1
                else:
                    if not d[curr_pos0 + 1]:
                        continue
                    self.curr_frame += d[curr_pos0 + 1]
                if self.curr_frame >= self.nb_frames:
                    self.curr_len = -1
                    return OPUS_INVALID_PACKET
                if self.curr_frame >= self.frame_max:
                    self.curr_len = 0
                self.repeat_pos = self.curr_pos
                self.last_long = -1
                self.trailing_short_len = 0
            elif ext_id == 2:
                self.repeat_l = L
                self.repeat_frame = self.curr_frame + 1
                self.repeat_len = curr_pos0 - self.repeat_pos
                self.src_pos = self.repeat_pos
                self.src_len = self.repeat_len
                ret = self._next_repeat()
                if ret != 0:
                    return ret
            elif ext_id > 2:
                if ext_id >= 32:
                    self.last_long = self.curr_pos
                    self.trailing_short_len = 0
                else:
                    self.trailing_short_len += L
                return ExtensionData(
                    id=ext_id, frame=self.curr_frame,
                    data=bytes(d[curr_pos0 + header_size:self.curr_pos]))
        return 0

    def find(self, ext_id: int):
        while True:
            ret = self.next()
            if not isinstance(ret, ExtensionData):
                return ret
            if ret.id == ext_id:
                return ret


def extensions_parse(data: bytes, nb_frames: int):
    """Returns list of ExtensionData or a negative error code."""
    it = ExtensionIterator(data, nb_frames)
    out = []
    while True:
        ret = it.next()
        if ret == 0:
            return out
        if not isinstance(ret, ExtensionData):
            return ret
        out.append(ret)


def _write_extension_payload(out: bytearray | None, cap: int, pos: int,
                             ext: ExtensionData, last: bool) -> int:
    assert 3 <= ext.id <= 127
    if ext.id < 32:
        if ext.len > 1:
            return OPUS_BAD_ARG
        if ext.len > 0:
            if cap - pos < ext.len:
                return OPUS_BUFFER_TOO_SMALL
            if out is not None:
                out[pos] = ext.data[0]
            pos += 1
    else:
        length_bytes = 0 if last else 1 + ext.len // 255
        if cap - pos < length_bytes + ext.len:
            return OPUS_BUFFER_TOO_SMALL
        if not last:
            for _ in range(ext.len // 255):
                if out is not None:
                    out[pos] = 255
                pos += 1
            if out is not None:
                out[pos] = ext.len % 255
            pos += 1
        if out is not None:
            out[pos:pos + ext.len] = ext.data
        pos += ext.len
    return pos


def _write_extension(out: bytearray | None, cap: int, pos: int,
                     ext: ExtensionData, last: bool) -> int:
    if cap - pos < 1:
        return OPUS_BUFFER_TOO_SMALL
    assert 3 <= ext.id <= 127
    if out is not None:
        out[pos] = (ext.id << 1) + (ext.len if ext.id < 32
                                    else (0 if last else 1))
    pos += 1
    return _write_extension_payload(out, cap, pos, ext, last)


def extensions_generate(extensions: list[ExtensionData], nb_frames: int,
                        cap: int, pad: bool = False,
                        out: bytearray | None = None):
    """Serialize extensions into padding bytes.  Returns the byte length, the
    filled `out` (if provided), or a negative error (reference:
    opus_packet_extensions_generate src/extensions.c:471)."""
    if nb_frames > 48:
        return OPUS_BAD_ARG
    nb_ext = len(extensions)
    frame_min_idx = [nb_ext] * nb_frames
    frame_max_idx = [0] * nb_frames
    for i, e in enumerate(extensions):
        f = e.frame
        if f < 0 or f >= nb_frames:
            return OPUS_BAD_ARG
        if e.id < 3 or e.id > 127:
            return OPUS_BAD_ARG
        frame_min_idx[f] = min(frame_min_idx[f], i)
        frame_max_idx[f] = max(frame_max_idx[f], i + 1)
    frame_repeat_idx = list(frame_min_idx)
    curr_frame = 0
    pos = 0
    written = 0
    for f in range(nb_frames):
        last_long_idx = -1
        repeat_count = 0
        if f + 1 < nb_frames:
            for i in range(frame_min_idx[f], frame_max_idx[f]):
                if extensions[i].frame != f:
                    continue
                ok = True
                for g in range(f + 1, nb_frames):
                    j = frame_repeat_idx[g]
                    if j >= frame_max_idx[g]:
                        ok = False
                        break
                    if extensions[j].id != extensions[i].id:
                        ok = False
                        break
                    if extensions[j].id < 32 \
                            and extensions[j].len != extensions[i].len:
                        ok = False
                        break
                if not ok:
                    break
                if extensions[i].id >= 32:
                    last_long_idx = frame_repeat_idx[nb_frames - 1]
                for g in range(f + 1, nb_frames):
                    j = frame_repeat_idx[g] + 1
                    while j < frame_max_idx[g] and extensions[j].frame != g:
                        j += 1
                    frame_repeat_idx[g] = j
                repeat_count += 1
                frame_repeat_idx[f] = i
        for i in range(frame_min_idx[f], frame_max_idx[f]):
            if extensions[i].frame != f:
                continue
            if f != curr_frame:
                diff = f - curr_frame
                if cap - pos < 2:
                    return OPUS_BUFFER_TOO_SMALL
                if diff == 1:
                    if out is not None:
                        out[pos] = 0x02
                    pos += 1
                else:
                    if out is not None:
                        out[pos] = 0x03
                        out[pos + 1] = diff
                    pos += 2
                curr_frame = f
            pos = _write_extension(out, cap, pos, extensions[i],
                                   written == nb_ext - 1)
            if pos < 0:
                return pos
            written += 1
            if repeat_count > 0 and frame_repeat_idx[f] == i:
                nb_repeated = repeat_count * (nb_frames - (f + 1))
                last = (written + nb_repeated == nb_ext
                        or (last_long_idx < 0 and i + 1 >= frame_max_idx[f]))
                if cap - pos < 1:
                    return OPUS_BUFFER_TOO_SMALL
                if out is not None:
                    out[pos] = 0x04 + (0 if last else 1)
                pos += 1
                for g in range(f + 1, nb_frames):
                    j = frame_min_idx[g]
                    while j < frame_repeat_idx[g]:
                        if extensions[j].frame == g:
                            pos = _write_extension_payload(
                                out, cap, pos, extensions[j],
                                last and j == last_long_idx)
                            if pos < 0:
                                return pos
                            written += 1
                        j += 1
                    frame_min_idx[g] = j
                if last:
                    curr_frame += 1
    assert written == nb_ext
    if pad and pos < cap:
        padding = cap - pos
        if out is not None:
            out[padding:padding + pos] = out[0:pos]
            for i in range(padding):
                out[i] = 0x01
        pos += padding
    return pos
