"""Pitch search for the CELT packet-loss concealment over a batch of
lanes: the port's copy of ``opus_tpu/celt/pitch.py`` (``_celt_autocorr``,
``_celt_lpc``, ``_fir5``, ``pitch_downsample``, ``_find_best_pitch``,
``pitch_search``; reference: celt/pitch.c, celt/celt_lpc.c), every
function on [B, ...] float64 tensors, computing per lane what the numpy
function computes for one stream.

The correlations are batched products (one per lag set, not a loop over
lags), so their float64 sums round in another order than ``np.dot``'s.
``_find_best_pitch`` keeps the scalar scan: its running energy and its
comparisons of correlation products run in the same order, one lag at a
time, over every lane.  Levinson's early break runs under a per-lane mask.
``remove_doubling`` is the encoder's and is not here.
"""

from __future__ import annotations

import torch

f64 = torch.float64


def celt_autocorr(x, lag: int):
    """[B, n] -> [B, lag + 1]: sum_i x[i] x[i + k] for k = 0..lag."""
    n = x.shape[1]
    return torch.stack([(x[:, :n - k] * x[:, k:]).sum(1)
                        for k in range(lag + 1)], dim=1)


def celt_lpc(ac, p: int):
    """Levinson-Durbin over lanes (reference: celt/celt_lpc.c:37): ac [B,
    p + 1] -> lpc [B, p]; a lane stops where its error falls to 0.001
    ac[0], and is all zeros where ac[0] <= 1e-10."""
    b = ac.shape[0]
    lpc = torch.zeros((b, p), dtype=f64, device=ac.device)
    error = ac[:, 0]
    live = ac[:, 0] > 1e-10
    for i in range(p):
        rr = ac[:, i + 1]
        if i:
            rr = (lpc[:, :i] * ac[:, 1:i + 1].flip(1)).sum(1) + rr
        r = -rr / torch.where(live, error, 1.0)
        new = lpc.clone()
        new[:, i] = r
        if i:
            new[:, :i] = lpc[:, :i] + r[:, None] * lpc[:, :i].flip(1)
        lpc = torch.where(live[:, None], new, lpc)
        error = torch.where(live, error - r * r * error, error)
        live = live & ~(error <= 0.001 * ac[:, 0])
    return lpc


def fir5(x, num):
    """y[i] = x[i] + sum_k num[k] x[i - 1 - k] (zeros before x[0]),
    summed in the scalar's order; x [B, n], num [B, 5]."""
    z = torch.nn.functional.pad(x, (5, 0))
    n = x.shape[1]
    y = x
    for k in range(5):
        y = y + num[:, k:k + 1] * z[:, 4 - k:4 - k + n]
    return y


def pitch_downsample(x, length: int, x2=None):
    """2x downsample + LPC flattening (reference: pitch.c:140, factor
    2) of one channel x [B, >= 2 length] (or of x and x2 summed, the
    second channel's terms added after the first's) -> [B, length]."""
    lp = torch.empty((x.shape[0], length), dtype=f64, device=x.device)
    i = torch.arange(1, length, device=x.device)
    lp[:, 1:] = .25 * x[:, 2 * i - 1] + .25 * x[:, 2 * i + 1] \
        + .5 * x[:, 2 * i]
    lp[:, 0] = .25 * x[:, 1] + .5 * x[:, 0]
    if x2 is not None:
        lp[:, 1:] += .25 * x2[:, 2 * i - 1] + .25 * x2[:, 2 * i + 1] \
            + .5 * x2[:, 2 * i]
        lp[:, 0] += .25 * x2[:, 1] + .5 * x2[:, 0]
    ac = celt_autocorr(lp, 4)
    # ac[0] *= 1.0001; ac[k] -= ac[k] * (.008 k) * (.008 k), left to right
    ac = torch.stack([ac[:, 0] * 1.0001] + [
        ac[:, k] - ac[:, k] * (.008 * k) * (.008 * k) for k in range(1, 5)],
        dim=1)
    lpc = celt_lpc(ac, 4)
    tmp, g = 1.0, []
    for _ in range(4):
        tmp = .9 * tmp
        g.append(tmp)
    lpc = lpc * torch.tensor(g, dtype=f64, device=x.device)
    c1 = .8
    lpc2 = torch.stack([lpc[:, 0] + .8, lpc[:, 1] + c1 * lpc[:, 0],
                        lpc[:, 2] + c1 * lpc[:, 1],
                        lpc[:, 3] + c1 * lpc[:, 2], c1 * lpc[:, 3]], dim=1)
    return fir5(lp, lpc2)


def _syy(y, length: int, n: int):
    """The running energy _find_best_pitch compares at each of n lags:
    [B, n], syy[i] = max(1, syy[i - 1] + y[i - 1 + length]^2 - y[i - 1]^2)
    from 1 + |y[:length]|^2, one lag at a time as the scalar adds it."""
    yy = y * y
    d = yy[:, length:length + n] - yy[:, :n]
    s = 1.0 + yy[:, :length].sum(1)
    out = [s]
    for i in range(n - 1):
        s = torch.clamp(s + d[:, i], min=1.0)
        out.append(s)
    return torch.stack(out, dim=1)


def find_best_pitch(xcorr, syy, lags=None):
    """The scalar's top-two scan (pitch.c find_best_pitch) over the lags
    of xcorr [B, n] with their energies syy [B, n]; lags [B, n]: each
    column's lag (default the column index; columns must run in
    increasing lag).  Returns [B, 2] int64."""
    b, n = xcorr.shape
    dev = xcorr.device
    if lags is None:
        lags = torch.arange(n, device=dev).expand(b, n)
    num0 = torch.full((b,), -1.0, dtype=f64, device=dev)
    num1 = num0.clone()
    den0 = torch.zeros(b, dtype=f64, device=dev)
    den1 = den0.clone()
    p0 = torch.zeros(b, dtype=torch.int64, device=dev)
    p1 = torch.ones(b, dtype=torch.int64, device=dev)
    for i in range(n):
        xc, sy, lag = xcorr[:, i], syy[:, i], lags[:, i]
        x16 = xc * 1e-12
        num = x16 * x16
        beat1 = (xc > 0) & (num * den1 > num1 * sy)
        beat0 = beat1 & (num * den0 > num0 * sy)
        only1 = beat1 & ~beat0
        num1 = torch.where(beat0, num0, torch.where(only1, num, num1))
        den1 = torch.where(beat0, den0, torch.where(only1, sy, den1))
        p1 = torch.where(beat0, p0, torch.where(only1, lag, p1))
        num0 = torch.where(beat0, num, num0)
        den0 = torch.where(beat0, sy, den0)
        p0 = torch.where(beat0, lag, p0)
    return torch.stack([p0, p1], dim=1)


def _xcorr(x, y, n: int, lags: int):
    """[B, lags]: sum_k x[k] y[i + k] over k < n, for i < lags, as one
    batched product."""
    win = y.unfold(1, n, 1)[:, :lags]              # [B, lags, n]
    return torch.matmul(win, x[:, :n, None])[..., 0]


def _gap(a, b):
    """Relative distance of two non-negative scores (1 where both are 0)."""
    return torch.where((a == b) & (a == 0), 1.0,
                       (a - b).abs() / (a.abs() + b.abs()))


def _ratio_gap(xc, sy, won, lost):
    """The relative gap between the best correlation ratio xc^2 / syy
    among the columns ``won`` and the best among ``lost`` ([B, n] bool):
    how far the scan's choice is from a tie."""
    r = torch.where(xc > 0, (xc * 1e-12) ** 2 / sy, 0.0)
    return _gap(torch.where(won, r, 0.0).amax(1),
                torch.where(lost, r, 0.0).amax(1))


def pitch_search(x_lp, y, length: int, max_pitch: int, margin=None):
    """(reference: pitch.c:310): x_lp [B, length / 2] (the last length / 2
    downsampled samples), y [B, (length + max_pitch) / 2] -> [B] int64.
    ``margin`` (a dict): receives ``"pitch"`` [B], the smallest relative
    distance from a tie of the decisions behind the result (the coarse
    pair against the third lag, the fine winner against the other
    candidates, the half-lag offset's two comparisons): a lane whose
    inputs move by less than it in relative terms keeps its pitch."""
    dev = y.device
    lag = length + max_pitch
    x4 = x_lp[:, :length >> 1:2]
    y4 = y[:, :lag >> 1:2]
    n4, mp4 = length >> 2, max_pitch >> 2
    xc4 = _xcorr(x4, y4, n4, mp4)
    syy4 = _syy(y4, n4, mp4)
    best4 = best = find_best_pitch(xc4, syy4)

    # the finer search: only the lags within 2 of twice a coarse pick
    n2, mp2 = length >> 1, max_pitch >> 1
    full = torch.clamp(_xcorr(x_lp, y, n2, mp2), min=-1.0)
    i = torch.arange(mp2, device=dev)
    near = ((i[None, :] - 2 * best[:, :1]).abs() <= 2) \
        | ((i[None, :] - 2 * best[:, 1:]).abs() <= 2)
    xcorr = torch.where(near, full, 0.0)
    # a lag off both windows has xcorr 0 and can win nothing: scan the
    # (at most 10) candidates per lane, in increasing lag
    cand = torch.sort(torch.where(near, i, mp2), dim=1).values[:, :10]
    ok = cand < mp2
    cidx = cand.clamp(max=mp2 - 1)
    syy = _syy(y, n2, mp2)
    best = find_best_pitch(
        torch.where(ok, xcorr.gather(1, cidx), 0.0), syy.gather(1, cidx),
        cidx)
    b0 = best[:, 0]
    inner = (b0 > 0) & (b0 < mp2 - 1)
    nb = torch.stack([b0 - 1, b0, b0 + 1], 1).clamp(0, mp2 - 1)
    a, bb, c = xcorr.gather(1, nb).unbind(1)
    offset = torch.where((c - a) > .7 * (bb - a), 1,
                         torch.where((a - c) > .7 * (bb - c), -1, 0))
    offset = torch.where(inner, offset, 0)
    if margin is not None:
        # the weaker of the coarse pair against the best lag outside it,
        # the fine winner against the other candidates, the offset's tests
        lag4 = torch.arange(mp4, device=dev)[None, :]
        pair = (lag4 == best4[:, :1]) | (lag4 == best4[:, 1:])
        r4 = torch.where(xc4 > 0, (xc4 * 1e-12) ** 2 / syy4, 0.0)
        m_c = _gap(torch.where(pair, r4, float("inf")).amin(1),
                   torch.where(pair, 0.0, r4).amax(1))
        won = cidx == b0[:, None]
        m_f = _ratio_gap(torch.where(ok, xcorr.gather(1, cidx), 0.0),
                         syy.gather(1, cidx), won & ok, ~won & ok)
        m_o = torch.where(inner, torch.minimum(
            _gap(c - a, .7 * (bb - a)), _gap(a - c, .7 * (bb - c))), 1.0)
        margin["pitch"] = torch.minimum(torch.minimum(m_c, m_f), m_o)
    return 2 * b0 - offset
