"""Copy of the range decoder of ``opus_tpu/bitstream/range_coder.py``
(``RangeDecoder`` and what it needs) for the PyTorch port, which imports
nothing of the JAX package: the host-side DRED payload parse reads with it.

RFC 6716 section 4.1 range decoder, exact integer arithmetic on Python
ints masked to 32 bits (reference: celt/entdec.c, celt/entcode.c).
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
