"""[B]-lane RFC 6716 §4.1 range decoder in plain torch.

Port of ``opus_tpu/ops/rc_kernel.py`` (``rk_init`` … ``rk_tell_frac``):
B independent streams, one lane each, every state field a [B] int64
tensor.  uint32 arithmetic is emulated in int64 with ``& 0xFFFFFFFF``
(torch's uint32 support is partial).  The TPU layout choices of the JAX
module are dropped: packet bytes are read straight from ``buf [B, P]``
with a per-lane gather instead of the word-page mask sweep.

Out-of-range reads return 0 under ``storage`` (the per-lane byte length)
and never fault.  Bit-exact with ``opus_tpu/bitstream/range_coder.py``
(reference: celt/entdec.c).
"""

from __future__ import annotations

import numpy as np
import torch

from .device_cache import const

SYM_BITS = 8
CODE_BITS = 32
SYM_MAX = (1 << SYM_BITS) - 1
CODE_TOP = 1 << (CODE_BITS - 1)
CODE_BOT = CODE_TOP >> SYM_BITS              # 1 << 23
CODE_EXTRA = (CODE_BITS - 2) % SYM_BITS + 1  # 7
UINT_BITS = 8
WINDOW_SIZE = 32
BITRES = 3
M32 = 0xFFFFFFFF

_TELL_CORRECTION = (35733, 38967, 42495, 46340, 50535, 55109, 60097, 65535)

def ilog(v):
    """EC_ILOG: bit length of v (0 -> 0) for 0 <= v < 2**32."""
    return torch.frexp(v.to(torch.float64)).exponent.to(torch.int64)


def pack_payloads(payloads, batch: int, max_payload: int, device):
    """list of at most ``batch`` byte strings -> (buf [batch, max_payload]
    uint8, lens [batch] int64) on ``device``, missing lanes empty.  A
    payload longer than ``max_payload`` raises ValueError naming its lane
    and length, as the reference's pack does (numpy refuses to broadcast
    it into the row): a cut packet would decode wrongly and mostly
    unflagged."""
    buf = np.zeros((batch, max_payload), np.uint8)
    lens = np.zeros(batch, np.int64)
    for i, p in enumerate(payloads):
        a = np.frombuffer(p, np.uint8)
        if len(a) > max_payload:
            raise ValueError(f"lane {i}: payload of {len(a)} bytes exceeds "
                             f"max_payload={max_payload}")
        buf[i, :len(a)] = a
        lens[i] = len(a)
    return torch.from_numpy(buf).to(device), torch.from_numpy(lens).to(device)



def pack_words(buf_bytes: np.ndarray, nbytes_cap: int) -> np.ndarray:
    """[B, S] uint8 -> [W, B] int32 little-endian words (W = ceil(cap/4)):
    the JAX package's packet layout, kept for handing packets across."""
    b, s = buf_bytes.shape
    w = (nbytes_cap + 3) // 4
    padded = np.zeros((b, w * 4), np.uint32)
    padded[:, :min(s, w * 4)] = buf_bytes[:, :w * 4]
    words = (padded[:, 0::4] | (padded[:, 1::4] << 8)
             | (padded[:, 2::4] << 16) | (padded[:, 3::4] << 24))
    return words.astype(np.int32).T.copy()


def read_byte_at(buf, pos):
    """Byte at per-lane offset pos (clipped into the buffer); the caller
    masks validity."""
    idx = pos.clamp(0, buf.shape[1] - 1)
    return buf.gather(1, idx[:, None])[:, 0].to(torch.int64)


def _read_byte(buf, storage, offs):
    ok = offs < storage
    b = read_byte_at(buf, offs)
    return torch.where(ok, b, 0), torch.where(ok, offs + 1, offs)


def _read_byte_from_end(buf, storage, end_offs):
    ok = end_offs < storage
    b = read_byte_at(buf, storage - end_offs - 1)
    return torch.where(ok, b, 0), torch.where(ok, end_offs + 1, end_offs)


def _normalize(d: dict, buf, storage) -> dict:
    """ec_dec_normalize (entdec.c): read bytes while rng <= CODE_BOT.  A
    symbol leaves rng >= 1, so at most 3; the count n and the new state
    are computed at once.  Each byte b shifts val left 8 and adds
    255 - (((prev & 1) << 7) | (b >> 1)) (prev the byte before it), all
    masked to 31 bits; reads at or past ``storage`` give 0."""
    d = dict(d)
    rng, offs = d["rng"], d["offs"]
    dev = rng.device
    n = 3 - torch.bucketize(rng, const("rk_norm_bounds", lambda: np.asarray(
        [CODE_BOT >> 16, CODE_BOT >> 8, CODE_BOT], np.int64), dev))
    pos = offs[:, None] + const("rk_ar3", lambda: np.arange(3), dev)
    b3 = buf.gather(1, pos.clamp(0, buf.shape[1] - 1)).to(torch.int64)
    b3 = torch.where(pos < storage[:, None], b3, 0)
    prev = torch.cat([d["rem"][:, None], b3[:, :2]], dim=1)
    c = SYM_MAX - (((prev & 1) << 7) | (b3 >> 1))
    c3 = (c * const("rk_w3", lambda: np.asarray([1 << 16, 1 << 8, 1]),
                    dev)).sum(dim=1)
    sh = n << 3
    d.update(
        offs=offs + (storage - offs).clamp_min(0).minimum(n),
        nbits_total=d["nbits_total"] + sh,
        rng=(rng << sh) & M32,
        val=((d["val"] << sh) | (c3 >> (24 - sh))) & (CODE_TOP - 1),
        rem=torch.where(n > 0, b3.gather(1, (n - 1).clamp_min(0)[:, None])
                        [:, 0], d["rem"]))
    return d


def _masked(d_new: dict, d_old: dict, active):
    if active is None:
        return d_new
    # fields the op left untouched are kept as they are (no select)
    return {k: v if v is d_old[k] else torch.where(active, v, d_old[k])
            for k, v in d_new.items()}


def _lanes(v, like):
    if torch.is_tensor(v):
        return v.to(torch.int64).expand_as(like)
    return torch.full_like(like, int(v))


def rk_init(buf, storage) -> dict:
    """buf: [B, P] packet bytes; storage: [B] byte lengths (<= P)."""
    storage = storage.to(torch.int64)
    z = torch.zeros_like(storage)
    d = dict(offs=z, end_offs=z, end_window=z, nend_bits=z,
             nbits_total=torch.full_like(
                 storage, CODE_BITS + 1
                 - ((CODE_BITS - CODE_EXTRA) // SYM_BITS) * SYM_BITS),
             rng=torch.full_like(storage, 1 << CODE_EXTRA),
             val=z, ext=z, rem=z, error=z)
    byte, offs = _read_byte(buf, storage, d["offs"])
    d["rem"] = byte
    d["offs"] = offs
    d["val"] = d["rng"] - 1 - (byte >> (SYM_BITS - CODE_EXTRA))
    return _normalize(d, buf, storage)


def rk_decode(d: dict, ft, active=None):
    """ec_decode: returns (fs, state with saved divisor)."""
    ftu = (_lanes(ft, d["rng"]) & M32).clamp_min(1)
    ext = d["rng"] // ftu
    s = d["val"] // ext
    fs = ftu - torch.minimum(s + 1, ftu)
    new = dict(d)
    new["ext"] = ext
    new = _masked(new, d, active)
    if active is not None:
        fs = torch.where(active, fs, 0)
    return fs, new


def rk_decode_bin(d: dict, bits: int, active=None):
    """ec_decode_bin: ft = 1 << bits (static); saves the shift divisor."""
    ext = d["rng"] >> bits
    s = d["val"] // ext
    total = 1 << bits
    fs = total - torch.clamp(s + 1, max=total)
    new = dict(d)
    new["ext"] = ext
    new = _masked(new, d, active)
    if active is not None:
        fs = torch.where(active, fs, 0)
    return fs, new


def rk_update(d: dict, buf, storage, fl, fh, ft, active=None):
    fl = _lanes(fl, d["rng"]) & M32
    fh = _lanes(fh, d["rng"]) & M32
    ft = _lanes(ft, d["rng"]) & M32
    s = (d["ext"] * ((ft - fh) & M32)) & M32
    new = dict(d)
    new["val"] = (d["val"] - s) & M32
    new["rng"] = torch.where(fl > 0, (d["ext"] * ((fh - fl) & M32)) & M32,
                             (d["rng"] - s) & M32)
    new = _normalize(new, buf, storage)
    return _masked(new, d, active)


def rk_dec_bit_logp(d: dict, buf, storage, logp, active=None):
    """logp: python int or per-lane int tensor."""
    r = d["rng"]
    s = r >> logp
    ret = d["val"] < s
    new = dict(d)
    new["val"] = torch.where(ret, d["val"], d["val"] - s)
    new["rng"] = torch.where(ret, s, r - s)
    new = _normalize(new, buf, storage)
    new = _masked(new, d, active)
    if active is not None:
        ret = ret & active
    return ret.to(torch.int64), new


def rk_dec_icdf(d: dict, buf, storage, icdf, ftb: int, active=None):
    """icdf: python tuple of ints (descending), or an int64 tensor table,
    [T] shared or [B, T] one row per lane (rows zero-padded at the end).
    Returns (symbol, state)."""
    if torch.is_tensor(icdf):
        return _dec_icdf_table(d, buf, storage, icdf, ftb, active)
    icdf = tuple(int(v) for v in icdf)
    r = d["rng"] >> ftb
    dv = d["val"]
    # symbol = number of thresholds r*icdf[t] above val (r*icdf is
    # descending in t, so this is where the scalar scan stops)
    ret = torch.zeros_like(dv)
    for t in icdf:
        ret = ret + (dv < r * t).to(torch.int64)
    s = torch.zeros_like(dv)
    t = d["rng"]
    for idx, tv in enumerate(icdf):
        s = torch.where(ret == idx, r * tv, s)
        if idx > 0:
            t = torch.where(ret == idx, r * icdf[idx - 1], t)
    new = dict(d)
    new["val"] = (dv - s) & M32
    new["rng"] = (t - s) & M32
    new = _normalize(new, buf, storage)
    new = _masked(new, d, active)
    if active is not None:
        ret = torch.where(active, ret, 0)
    return ret, new


def _dec_icdf_table(d: dict, buf, storage, tab, ftb: int, active):
    """rk_dec_icdf for a tensor table: the threshold count and gather of
    ``opus_tpu/ops/range_vec.py:rd_dec_icdf``."""
    tab = tab if tab.dim() == 2 else tab[None, :]
    last = tab.shape[1] - 1
    rng, dv = d["rng"], d["val"]
    s_all = (rng >> ftb)[:, None] * tab                    # [B, T]
    ret = (dv[:, None] < s_all).sum(dim=1)
    s = s_all.gather(1, ret.clamp_max(last)[:, None])[:, 0]
    t = torch.where(ret > 0, s_all.gather(
        1, (ret - 1).clamp(0, last)[:, None])[:, 0], rng)
    new = dict(d)
    new["val"] = (dv - s) & M32
    new["rng"] = (t - s) & M32
    new = _normalize(new, buf, storage)
    new = _masked(new, d, active)
    if active is not None:
        ret = torch.where(active, ret, 0)
    return ret, new


def rk_dec_bits(d: dict, buf, storage, bits, active=None):
    """Raw bits from the end window; bits: per-lane count (0 = no-op)."""
    bits = _lanes(bits, d["rng"])
    window = d["end_window"]
    avail = d["nend_bits"]
    end_offs = d["end_offs"]
    need0 = avail < bits
    for _ in range(4):
        need = need0 & (avail <= WINDOW_SIZE - SYM_BITS)
        byte, eo = _read_byte_from_end(buf, storage, end_offs)
        window = torch.where(need, (window | (byte << avail.clamp(0, 31)))
                             & M32, window)
        avail = torch.where(need, avail + SYM_BITS, avail)
        end_offs = torch.where(need, eo, end_offs)
    bitsc = bits.clamp(0, 32)
    ret = window & ((1 << bitsc) - 1)
    window = torch.where(bits >= 32, 0, window >> bitsc)
    new = dict(d)
    new["end_window"] = window
    new["nend_bits"] = avail - bits
    new["end_offs"] = end_offs
    new["nbits_total"] = d["nbits_total"] + bits
    new = _masked(new, d, active)
    if active is not None:
        ret = torch.where(active, ret, 0)
    return ret, new


def rk_dec_uint(d: dict, buf, storage, ft, active=None):
    """ft: per-lane (> 1).  Handles the > 8-bit split per lane; the small
    path is the big path with a 0-bit raw read."""
    if active is None:
        active = torch.ones_like(d["rng"], dtype=torch.bool)
    ftm = (_lanes(ft, d["rng"]) & M32).clamp_min(2) - 1
    ftb = ilog(ftm)
    big = ftb > UINT_BITS
    sh = (ftb - UINT_BITS).clamp_min(0)
    ftrunc = (ftm >> sh) + 1
    fs, d1 = rk_decode(d, ftrunc, active)
    d1 = rk_update(d1, buf, storage, fs, fs + 1, ftrunc, active)
    lo, d2 = rk_dec_bits(d1, buf, storage,
                         torch.where(active & big, sh, 0), active & big)
    t = ((fs << sh) | lo) & M32
    err = active & big & (t > ftm)
    t = torch.minimum(t, ftm)
    ret = torch.where(big, t, fs)
    d2 = dict(d2)
    d2["error"] = d2["error"] | err.to(torch.int64)
    return torch.where(active, ret, 0), d2


# the decoder state's fields, in the column order of ``pack_state``
# (read in this order by kernel K1, csrc/celt_dec_frame.cu rd_load)
KEYS = ("offs", "end_offs", "end_window", "nend_bits", "nbits_total", "rng",
        "val", "ext", "rem", "error")


def pack_state(d: dict):
    """The state dict -> [B, 10] int64, one column per field of KEYS
    (uint32 fields as their values; the caller narrows to int32 bits)."""
    return torch.stack([d[k] for k in KEYS], dim=1)


def rk_tell(d: dict):
    return d["nbits_total"] - ilog(d["rng"])


def rk_tell_frac(d: dict):
    nbits = d["nbits_total"] << BITRES
    lg = ilog(d["rng"])
    r = d["rng"] >> (lg - 16).clamp_min(0)
    b = (r >> 12) - 8
    corr = torch.as_tensor(_TELL_CORRECTION, dtype=torch.int64,
                           device=r.device)[b.clamp(0, 7)]
    b = b + (r > corr).to(torch.int64)
    return nbits - ((lg << 3) + b)
