"""Copy of the range coder of ``opus_tpu/bitstream/range_coder.py``
(``RangeEncoder``, ``RangeDecoder`` and what they need) for the PyTorch
port, which imports nothing of the JAX package: the host-side DRED payload
parse reads with the decoder, the DRED payload coder writes with the
encoder.

RFC 6716 section 4.1 range coder, exact integer arithmetic on Python ints
masked to 32 bits (reference: celt/entenc.c, celt/entdec.c,
celt/entcode.c).
"""

from __future__ import annotations

M32 = 0xFFFFFFFF
SYM_BITS = 8
CODE_BITS = 32
SYM_MAX = (1 << SYM_BITS) - 1
CODE_SHIFT = CODE_BITS - SYM_BITS - 1  # 23
CODE_TOP = 1 << (CODE_BITS - 1)
CODE_BOT = CODE_TOP >> SYM_BITS
CODE_EXTRA = (CODE_BITS - 2) % SYM_BITS + 1  # 7
UINT_BITS = 8
WINDOW_SIZE = 32
BITRES = 3

_TELL_CORRECTION = (35733, 38967, 42495, 46340, 50535, 55109, 60097, 65535)


def ilog(v: int) -> int:
    """Number of bits needed to represent v (0 -> 0). EC_ILOG equivalent."""
    return v.bit_length()


def ec_tell(coder) -> int:
    """Whole bits used so far (conservative; same in encoder and decoder)."""
    return coder.nbits_total - ilog(coder.rng)


def ec_tell_frac(coder) -> int:
    """Bits used so far in 1/8-bit units (BITRES=3)."""
    nbits = coder.nbits_total << BITRES
    l = ilog(coder.rng)
    r = coder.rng >> (l - 16)
    b = (r >> 12) - 8
    b += 1 if r > _TELL_CORRECTION[b] else 0
    l = (l << 3) + b
    return nbits - l


class RangeEncoder:
    """Range encoder writing range-coded bytes forward and raw bits backward
    into one buffer (reference: celt/entenc.c)."""

    __slots__ = ("buf", "storage", "end_offs", "end_window", "nend_bits",
                 "nbits_total", "offs", "rng", "val", "ext", "rem", "error")

    def __init__(self, size: int, buf: bytearray | None = None):
        self.buf = buf if buf is not None else bytearray(size)
        assert len(self.buf) >= size
        self.storage = size
        self.end_offs = 0
        self.end_window = 0
        self.nend_bits = 0
        self.nbits_total = CODE_BITS + 1
        self.offs = 0
        self.rng = CODE_TOP
        self.rem = -1
        self.val = 0
        self.ext = 0
        self.error = 0

    # -- low-level output ------------------------------------------------
    def _write_byte(self, value: int) -> int:
        if self.offs + self.end_offs >= self.storage:
            return -1
        self.buf[self.offs] = value & 0xFF
        self.offs += 1
        return 0

    def _write_byte_at_end(self, value: int) -> int:
        if self.offs + self.end_offs >= self.storage:
            return -1
        self.end_offs += 1
        self.buf[self.storage - self.end_offs] = value & 0xFF
        return 0

    def _carry_out(self, c: int) -> None:
        if c != SYM_MAX:
            carry = c >> SYM_BITS
            if self.rem >= 0:
                self.error |= self._write_byte(self.rem + carry)
            if self.ext > 0:
                sym = (SYM_MAX + carry) & SYM_MAX
                while self.ext > 0:
                    self.error |= self._write_byte(sym)
                    self.ext -= 1
            self.rem = c & SYM_MAX
        else:
            self.ext += 1

    def _normalize(self) -> None:
        while self.rng <= CODE_BOT:
            self._carry_out(self.val >> CODE_SHIFT)
            self.val = (self.val << SYM_BITS) & (CODE_TOP - 1)
            self.rng = (self.rng << SYM_BITS) & M32
            self.nbits_total += SYM_BITS

    # -- symbol coding ----------------------------------------------------
    def encode(self, fl: int, fh: int, ft: int) -> None:
        r = self.rng // ft
        if fl > 0:
            self.val = (self.val + self.rng - r * (ft - fl)) & M32
            self.rng = r * (fh - fl)
        else:
            self.rng -= r * (ft - fh)
        self._normalize()

    def encode_bin(self, fl: int, fh: int, bits: int) -> None:
        r = self.rng >> bits
        total = 1 << bits
        if fl > 0:
            self.val = (self.val + self.rng - r * (total - fl)) & M32
            self.rng = r * (fh - fl)
        else:
            self.rng -= r * (total - fh)
        self._normalize()

    def enc_bit_logp(self, val: int, logp: int) -> None:
        r = self.rng
        s = r >> logp
        r -= s
        if val:
            self.val = (self.val + r) & M32
        self.rng = s if val else r
        self._normalize()

    def enc_icdf(self, s: int, icdf, ftb: int) -> None:
        """icdf is a sequence of *inverse* cumulative counts (descending)."""
        r = self.rng >> ftb
        if s > 0:
            self.val = (self.val + self.rng - r * icdf[s - 1]) & M32
            self.rng = r * (icdf[s - 1] - icdf[s])
        else:
            self.rng -= r * icdf[s]
        self._normalize()

    # 16-bit icdf tables use identical arithmetic
    enc_icdf16 = enc_icdf

    def enc_uint(self, fl: int, ft: int) -> None:
        assert ft > 1
        ft -= 1
        ftb = ilog(ft)
        if ftb > UINT_BITS:
            ftb -= UINT_BITS
            ftrunc = (ft >> ftb) + 1
            fltrunc = fl >> ftb
            self.encode(fltrunc, fltrunc + 1, ftrunc)
            self.enc_bits(fl & ((1 << ftb) - 1), ftb)
        else:
            self.encode(fl, fl + 1, ft + 1)

    def enc_bits(self, fl: int, bits: int) -> None:
        """Raw bits, written backward from the end of the buffer."""
        assert bits > 0
        window = self.end_window
        used = self.nend_bits
        if used + bits > WINDOW_SIZE:
            while used >= SYM_BITS:
                self.error |= self._write_byte_at_end(window & SYM_MAX)
                window >>= SYM_BITS
                used -= SYM_BITS
        window |= fl << used
        used += bits
        self.end_window = window
        self.nend_bits = used
        self.nbits_total += bits

    def patch_initial_bits(self, val: int, nbits: int) -> None:
        assert nbits <= SYM_BITS
        shift = SYM_BITS - nbits
        mask = ((1 << nbits) - 1) << shift
        if self.offs > 0:
            self.buf[0] = (self.buf[0] & ~mask) | (val << shift)
        elif self.rem >= 0:
            self.rem = (self.rem & ~mask) | (val << shift)
        elif self.rng <= (CODE_TOP >> nbits):
            self.val = ((self.val & ~((mask << CODE_SHIFT) & M32)) |
                        (val << (CODE_SHIFT + shift))) & M32
        else:
            self.error = -1

    def shrink(self, size: int) -> None:
        assert self.offs + self.end_offs <= size
        # move the raw-bit tail so it abuts the new, smaller storage end
        tail = bytes(self.buf[self.storage - self.end_offs:self.storage])
        self.buf[size - self.end_offs:size] = tail
        self.storage = size

    def done(self) -> None:
        l = CODE_BITS - ilog(self.rng)
        msk = (CODE_TOP - 1) >> l
        end = (self.val + msk) & ~msk & M32
        if (end | msk) >= self.val + self.rng:
            l += 1
            msk >>= 1
            end = (self.val + msk) & ~msk & M32
        while l > 0:
            self._carry_out(end >> CODE_SHIFT)
            end = (end << SYM_BITS) & (CODE_TOP - 1)
            l -= SYM_BITS
        if self.rem >= 0 or self.ext > 0:
            self._carry_out(0)
        window = self.end_window
        used = self.nend_bits
        while used >= SYM_BITS:
            self.error |= self._write_byte_at_end(window & SYM_MAX)
            window >>= SYM_BITS
            used -= SYM_BITS
        if not self.error:
            for i in range(self.offs, self.storage - self.end_offs):
                self.buf[i] = 0
            if used > 0:
                if self.end_offs >= self.storage:
                    self.error = -1
                else:
                    l = -l
                    if self.offs + self.end_offs >= self.storage and l < used:
                        window &= (1 << l) - 1
                        self.error = -1
                    self.buf[self.storage - self.end_offs - 1] |= window & 0xFF

    # -- state snapshots (for two-pass encoding decisions) -----------------
    def save_state(self):
        return (self.storage, self.end_offs, self.end_window, self.nend_bits,
                self.nbits_total, self.offs, self.rng, self.val, self.ext,
                self.rem, self.error, bytes(self.buf[:self.offs]),
                bytes(self.buf[self.storage - self.end_offs:self.storage]))

    def restore_state(self, state):
        (self.storage, self.end_offs, self.end_window, self.nend_bits,
         self.nbits_total, self.offs, self.rng, self.val, self.ext,
         self.rem, self.error, head, tail) = state
        self.buf[:len(head)] = head
        if self.end_offs:
            self.buf[self.storage - self.end_offs:self.storage] = tail

    # -- introspection -----------------------------------------------------
    def range_bytes(self) -> int:
        return self.offs

    def tell(self) -> int:
        return ec_tell(self)

    def tell_frac(self) -> int:
        return ec_tell_frac(self)

    def data(self) -> bytes:
        return bytes(self.buf[:self.storage])


class RangeDecoder:
    """Range decoder (reference: celt/entdec.c)."""

    __slots__ = ("buf", "storage", "end_offs", "end_window", "nend_bits",
                 "nbits_total", "offs", "rng", "val", "ext", "rem", "error")

    def __init__(self, data: bytes | bytearray | memoryview, storage: int | None = None):
        self.buf = data
        self.storage = len(data) if storage is None else storage
        self.end_offs = 0
        self.end_window = 0
        self.nend_bits = 0
        self.nbits_total = (CODE_BITS + 1 -
                            ((CODE_BITS - CODE_EXTRA) // SYM_BITS) * SYM_BITS)
        self.offs = 0
        self.rng = 1 << CODE_EXTRA
        self.rem = self._read_byte()
        self.val = self.rng - 1 - (self.rem >> (SYM_BITS - CODE_EXTRA))
        self.error = 0
        self.ext = 0
        self._normalize()

    def _read_byte(self) -> int:
        if self.offs < self.storage:
            b = self.buf[self.offs]
            self.offs += 1
            return b
        return 0

    def _read_byte_from_end(self) -> int:
        if self.end_offs < self.storage:
            self.end_offs += 1
            return self.buf[self.storage - self.end_offs]
        return 0

    def _normalize(self) -> None:
        while self.rng <= CODE_BOT:
            self.nbits_total += SYM_BITS
            self.rng = (self.rng << SYM_BITS) & M32
            sym = self.rem
            self.rem = self._read_byte()
            sym = ((sym << SYM_BITS) | self.rem) >> (SYM_BITS - CODE_EXTRA)
            self.val = ((self.val << SYM_BITS) + (SYM_MAX & ~sym)) & (CODE_TOP - 1)

    # -- symbol decoding ---------------------------------------------------
    def decode(self, ft: int) -> int:
        self.ext = self.rng // ft
        s = self.val // self.ext
        return ft - min(s + 1, ft)

    def decode_bin(self, bits: int) -> int:
        self.ext = self.rng >> bits
        s = self.val // self.ext
        total = 1 << bits
        return total - min(s + 1, total)

    def update(self, fl: int, fh: int, ft: int) -> None:
        s = self.ext * (ft - fh)
        self.val -= s
        self.rng = self.ext * (fh - fl) if fl > 0 else self.rng - s
        self._normalize()

    def dec_bit_logp(self, logp: int) -> int:
        r = self.rng
        d = self.val
        s = r >> logp
        ret = 1 if d < s else 0
        if not ret:
            self.val = d - s
        self.rng = s if ret else r - s
        self._normalize()
        return ret

    def dec_icdf(self, icdf, ftb: int) -> int:
        s = self.rng
        d = self.val
        r = s >> ftb
        ret = -1
        while True:
            ret += 1
            t = s
            s = r * icdf[ret]
            if d >= s:
                break
        self.val = d - s
        self.rng = t - s
        self._normalize()
        return ret

    dec_icdf16 = dec_icdf

    def dec_uint(self, ft: int) -> int:
        assert ft > 1
        ft -= 1
        ftb = ilog(ft)
        if ftb > UINT_BITS:
            ftb -= UINT_BITS
            ftrunc = (ft >> ftb) + 1
            s = self.decode(ftrunc)
            self.update(s, s + 1, ftrunc)
            t = (s << ftb) | self.dec_bits(ftb)
            if t <= ft:
                return t
            self.error = 1
            return ft
        else:
            ft += 1
            s = self.decode(ft)
            self.update(s, s + 1, ft)
            return s

    def dec_bits(self, bits: int) -> int:
        window = self.end_window
        available = self.nend_bits
        if available < bits:
            while True:
                window |= self._read_byte_from_end() << available
                available += SYM_BITS
                if available > WINDOW_SIZE - SYM_BITS:
                    break
        ret = window & ((1 << bits) - 1)
        window >>= bits
        available -= bits
        self.end_window = window
        self.nend_bits = available
        self.nbits_total += bits
        return ret

    # -- introspection -----------------------------------------------------
    def tell(self) -> int:
        return ec_tell(self)

    def tell_frac(self) -> int:
        return ec_tell_frac(self)
