"""[B]-lane RFC 6716 §4.1 range ENCODER in plain torch: the encode twin of
``ops/rc_kernel.py``.

Port of ``opus_tpu/ops/rc_enc_kernel.py``: B independent streams, every
state field a [B] int64 tensor, uint32 arithmetic emulated with
``& 0xFFFFFFFF``.  Bytes come out through the deferred-carry design of the
JAX module: the coder appends raw 9-bit ``carry_out`` digits and end-window
raw-bit bytes to two page buffers, and ``finalize`` resolves the carries
(a backwards loop over the digits) and assembles the packet.  A page
buffer is a [B, D] tensor with per-lane appends; an append past its last
page is dropped, and ``finalize`` flags the lane (``ndigits + nend >
nbytes``).

``dry=True`` is the exact tell tracker for decision trials: rng and
nbits_total evolve, nothing is written (the rng walk never depends on the
value or carry state).

Bit-exact with ``opus_tpu/bitstream/range_coder.py``'s encoder (reference:
celt/entenc.c ec_encode :43, ec_enc_bit_logp :151, ec_enc_icdf :164,
ec_enc_uint :186, ec_enc_bits :204, ec_enc_done :219).
"""

from __future__ import annotations

import torch

from .rc_kernel import (BITRES, CODE_BITS, CODE_BOT, CODE_TOP, M32,
                        SYM_BITS, SYM_MAX, UINT_BITS, WINDOW_SIZE,
                        _TELL_CORRECTION, ilog)

CODE_SHIFT = CODE_BITS - SYM_BITS - 1        # 23

i64 = torch.int64


class PageBuf:
    """[B, D] int64 page buffer with masked per-lane appends."""

    def __init__(self, buf):
        self.buf = buf
        self.npages = buf.shape[1]

    def append(self, idx, val, mask):
        """Writes ``val`` at page ``idx`` on the lanes where ``mask`` (and
        ``idx`` is inside the buffer)."""
        ok = mask & (idx < self.npages)
        if not bool(ok.any()):
            return
        col = idx.clamp(0, self.npages - 1)[:, None]
        cur = self.buf.gather(1, col)[:, 0]
        self.buf.scatter_(1, col, torch.where(ok, val, cur)[:, None])


def page_bufs(batch: int, nbytes: int, device) -> tuple:
    """The digit and end buffers of a frame of ``nbytes``: [B, nbytes+4]
    and [B, nbytes+1] (the JAX module's page counts)."""
    return (PageBuf(torch.zeros((batch, nbytes + 4), dtype=i64,
                                device=device)),
            PageBuf(torch.zeros((batch, nbytes + 1), dtype=i64,
                                device=device)))


def re_init(batch: int, device) -> dict:
    """Encoder lane state; pair with ``page_bufs``."""
    z = torch.zeros(batch, dtype=i64, device=device)
    return dict(ndigits=z, nend=z, end_window=z, nend_bits=z,
                nbits_total=torch.full_like(z, CODE_BITS + 1),
                rng=torch.full_like(z, CODE_TOP), val=z, error=z)


def _lanes(v, like):
    if torch.is_tensor(v):
        return v.to(i64).expand_as(like)
    return torch.full_like(like, int(v))


def _masked(new: dict, old: dict, active):
    return {k: torch.where(active, new[k], old[k]) for k in new}


def _normalize(e: dict, dig: PageBuf, active, dry: bool) -> dict:
    """ec_enc_normalize (entenc.c:78): up to 3 digits out."""
    e = dict(e)
    for _ in range(3):
        need = active & (e["rng"] <= CODE_BOT)
        if not dry:
            dig.append(e["ndigits"], e["val"] >> CODE_SHIFT, need)
            e["ndigits"] = torch.where(need, e["ndigits"] + 1, e["ndigits"])
            e["val"] = torch.where(
                need, (e["val"] << SYM_BITS) & (CODE_TOP - 1), e["val"])
        e["rng"] = torch.where(need, (e["rng"] << SYM_BITS) & M32, e["rng"])
        e["nbits_total"] = torch.where(need, e["nbits_total"] + SYM_BITS,
                                       e["nbits_total"])
    return e


def _update(e, dig, active, dry, big, val_big, rng_new):
    if active is None:
        active = torch.ones_like(e["rng"], dtype=torch.bool)
    new = dict(e)
    if not dry:
        new["val"] = torch.where(big, val_big & M32, e["val"])
    new["rng"] = rng_new & M32
    new = _normalize(new, dig, active, dry)
    return _masked(new, e, active)


def re_encode(e: dict, dig: PageBuf, fl, fh, ft, active=None, dry=False):
    """ec_encode."""
    rng = e["rng"]
    flu = _lanes(fl, rng) & M32
    fhu = _lanes(fh, rng) & M32
    ftu = (_lanes(ft, rng) & M32).clamp_min(1)
    r = rng // ftu
    big = flu > 0
    return _update(e, dig, active, dry, big, e["val"] + rng - r * (ftu - flu),
                   torch.where(big, r * (fhu - flu), rng - r * (ftu - fhu)))


def re_encode_bin(e: dict, dig: PageBuf, fl, fh, bits: int, active=None,
                  dry=False):
    """ec_encode_bin: ft = 1 << bits (static)."""
    rng = e["rng"]
    flu = _lanes(fl, rng) & M32
    fhu = _lanes(fh, rng) & M32
    r = rng >> bits
    total = 1 << bits
    big = flu > 0
    return _update(e, dig, active, dry, big,
                   e["val"] + rng - r * (total - flu),
                   torch.where(big, r * (fhu - flu), rng - r * (total - fhu)))


def re_enc_bit_logp(e: dict, dig: PageBuf, bit, logp, active=None,
                    dry=False):
    """logp: python int or per-lane tensor."""
    r = e["rng"]
    s = r >> logp
    b = _lanes(bit, r) != 0
    return _update(e, dig, active, dry, b, e["val"] + (r - s),
                   torch.where(b, s, r - s))


def re_enc_icdf(e: dict, dig: PageBuf, s, icdf, ftb: int, active=None,
                dry=False):
    """icdf: python tuple (descending)."""
    icdf = tuple(int(v) for v in icdf)
    rng = e["rng"]
    si = _lanes(s, rng).clamp(0, len(icdf) - 1)
    tab = torch.as_tensor(icdf, dtype=i64, device=rng.device)
    cur = tab[si]
    prev = torch.where(si > 0, tab[(si - 1).clamp_min(0)], 1 << ftb)
    r = rng >> ftb
    pos = si > 0
    return _update(e, dig, active, dry, pos, e["val"] + rng - r * prev,
                   torch.where(pos, r * (prev - cur), rng - r * cur))


def re_enc_bits(e: dict, end: PageBuf, fl, bits, active=None, dry=False):
    """Raw bits into the end window (entenc.c:204); bits per lane (0 =
    no-op).  Raw bits never touch rng: dry mode only advances
    nbits_total."""
    rng = e["rng"]
    bits = _lanes(bits, rng)
    act = bits > 0
    if active is not None:
        act = act & active
    if dry:
        new = dict(e, nbits_total=e["nbits_total"] + bits)
        return _masked(new, e, act)
    window = e["end_window"]
    used = e["nend_bits"]
    nend = e["nend"]
    flush = act & (used + bits > WINDOW_SIZE)
    for _ in range(4):
        need = flush & (used >= SYM_BITS)
        end.append(nend, window & SYM_MAX, need)
        nend = torch.where(need, nend + 1, nend)
        window = torch.where(need, window >> SYM_BITS, window)
        used = torch.where(need, used - SYM_BITS, used)
    window = (window | (_lanes(fl, rng) << used.clamp_min(0))) & M32
    new = dict(e, end_window=window, nend_bits=used + bits, nend=nend,
               nbits_total=e["nbits_total"] + bits)
    return _masked(new, e, act)


def re_enc_uint(e: dict, dig: PageBuf, end: PageBuf, fl, ft, active=None,
                dry=False):
    """ec_enc_uint with the > 8-bit raw-bit split, one path per lane."""
    rng = e["rng"]
    if active is None:
        active = torch.ones_like(rng, dtype=torch.bool)
    ftm = (_lanes(ft, rng) & M32).clamp_min(2) - 1
    ftb = ilog(ftm)
    big = ftb > UINT_BITS
    sh = (ftb - UINT_BITS).clamp_min(0)
    flu = _lanes(fl, rng) & M32
    hi = flu >> sh
    e = re_encode(e, dig, hi, hi + 1, (ftm >> sh) + 1, active, dry=dry)
    return re_enc_bits(e, end, flu & ((torch.ones_like(sh) << sh) - 1),
                       torch.where(active & big, sh, 0), active & big,
                       dry=dry)


def re_tell(e: dict):
    return e["nbits_total"] - ilog(e["rng"])


def re_tell_frac(e: dict):
    rng = e["rng"]
    nbits = e["nbits_total"] << BITRES
    lg = ilog(rng)
    r = rng >> (lg - 16).clamp_min(0)
    b = (r >> 12) - 8
    corr = torch.as_tensor(_TELL_CORRECTION, dtype=i64,
                           device=rng.device)[b.clamp(0, 7)]
    b = b + (r > corr).to(i64)
    return nbits - ((lg << 3) + b)


def re_done(e: dict, dig: PageBuf, active=None):
    """ec_enc_done's value flush (entenc.c:219): appends the final digits;
    the bytes are assembled by ``finalize``."""
    rng, val = e["rng"], e["val"]
    if active is None:
        active = torch.ones_like(rng, dtype=torch.bool)
    l = CODE_BITS - ilog(rng)
    msk = (CODE_TOP - 1) >> l
    end = ((val + msk) & M32) & ~msk
    over = (end | msk) >= ((val + rng) & M32)
    l = torch.where(over, l + 1, l)
    msk = torch.where(over, msk >> 1, msk)
    end = torch.where(over, ((val + msk) & M32) & ~msk, end)
    e = dict(e)
    for _ in range(2):
        need = active & (l > 0)
        dig.append(e["ndigits"], end >> CODE_SHIFT, need)
        e["ndigits"] = torch.where(need, e["ndigits"] + 1, e["ndigits"])
        end = torch.where(need, (end << SYM_BITS) & (CODE_TOP - 1), end)
        l = l - SYM_BITS
    return e


def finalize(e: dict, dig: PageBuf, end: PageBuf, nbytes: int):
    """Carry resolution + byte assembly.  Returns (bytes uint8 [B,
    nbytes], error [B] int64, rng [B] int64)."""
    digits = dig.buf
    ebuf = end.buf.clone()
    bsz, dcap = digits.shape
    ecap = ebuf.shape[1]
    window, used, nend = e["end_window"], e["nend_bits"], e["nend"]
    rows = torch.arange(bsz, device=digits.device)
    for _ in range(4):                      # whole bytes left in the window
        need = used >= SYM_BITS
        col = nend.clamp(0, ecap - 1)
        ok = need & (nend < ecap)
        ebuf[rows, col] = torch.where(ok, window & SYM_MAX, ebuf[rows, col])
        nend = torch.where(need, nend + 1, nend)
        window = torch.where(need, window >> SYM_BITS, window)
        used = torch.where(need, used - SYM_BITS, used)
    # carries, last digit to first: byte = (d + c) & 255, c' = its bit 8
    resolved = torch.empty_like(digits)
    carry = torch.zeros(bsz, dtype=i64, device=digits.device)
    for j in range(dcap - 1, -1, -1):
        v = digits[:, j] + carry
        resolved[:, j] = v & 0xFF
        carry = (v >> 8) & 1
    pos = torch.arange(nbytes, device=digits.device)[None, :]
    if dcap < nbytes:
        resolved = torch.nn.functional.pad(resolved, (0, nbytes - dcap))
    out = torch.where(pos < e["ndigits"][:, None], resolved[:, :nbytes], 0)
    tail_idx = nbytes - 1 - pos
    tail = torch.nn.functional.pad(ebuf, (0, 1)).gather(
        1, tail_idx.clamp(0, ecap).expand(bsz, nbytes))
    out = out | torch.where((tail_idx >= 0) & (tail_idx < nend[:, None]),
                            tail, 0)
    lpos = nbytes - nend - 1
    out = out | torch.where((used > 0)[:, None] & (pos == lpos[:, None]),
                            (window & 0xFF)[:, None], 0)
    error = e["error"] | ((e["ndigits"] + nend) > nbytes).to(i64)
    return out.to(torch.uint8), error, e["rng"]


class VK:
    """The coder handed to the encoder's plan functions: the functions above
    bound to one pair of page buffers.  ``dry=True`` gives the exact tell
    tracker (nothing written) for decision trials."""

    def __init__(self, dig: PageBuf, end: PageBuf, dry: bool = False):
        self.dig = dig
        self.end = end
        self.dry = dry

    def re_encode(self, e, fl, fh, ft, active=None):
        return re_encode(e, self.dig, fl, fh, ft, active, dry=self.dry)

    def re_encode_bin(self, e, fl, fh, bits, active=None):
        return re_encode_bin(e, self.dig, fl, fh, bits, active, dry=self.dry)

    def re_enc_bit_logp(self, e, bit, logp, active=None):
        return re_enc_bit_logp(e, self.dig, bit, logp, active, dry=self.dry)

    def re_enc_icdf(self, e, s, icdf, ftb, active=None):
        return re_enc_icdf(e, self.dig, s, icdf, ftb, active, dry=self.dry)

    def re_enc_bits(self, e, fl, bits, active=None):
        return re_enc_bits(e, self.end, fl, bits, active, dry=self.dry)

    def re_enc_uint(self, e, fl, ft, active=None):
        return re_enc_uint(e, self.dig, self.end, fl, ft, active,
                           dry=self.dry)

    re_tell = staticmethod(re_tell)
    re_tell_frac = staticmethod(re_tell_frac)
