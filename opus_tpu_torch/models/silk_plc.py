"""The SILK classic packet-loss concealment, comfort noise and loss glue
over a batch of lanes, int32 wrap-exact.

Port of the scalar decoder's ``plc_update``, ``_plc_reset``,
``plc_conceal``, ``plc_glue_frames`` and ``cng`` (``opus_tpu/silk/
decoder.py:759-1039``; reference: silk/PLC.c silk_PLC_update :170,
silk_PLC_conceal :216, silk_PLC_glue_frames :434, silk/CNG.c).  Every
value is an int64 tensor holding an int32 value
(``opus_tpu_torch/ops/silk_fixed.py``); each lane carries its own loss
state (``loss_init_state``).  Where the scalar leaves a loop early, a
per-lane mask does it: ``plc_update``'s subframe loop stops once the
subframe offset passes the last pitch lag, the glue's fade once its gain
passes unity.

A lost frame (``plc_conceal``) rewhitens the last 20 ms of output through
the bandwidth-expanded LPC, extrapolates it with the decaying LTP taps and
a pitch lag that drifts up each subframe, adds noise drawn from the last
good frame's excitation at indices of SILK's LCG (its n states in closed
form: ``silk_fixed.silk_rand_seq``), and runs the LPC synthesis through
kernel K4 (``ops/lpc.lpc_subframe``) one subframe at a time.  The comfort
noise (``cng_add``) does the same with the smoothed NLSFs' LPC over an
excitation drawn from its own buffer.
"""

from __future__ import annotations

import torch

from ..ops import silk_fixed as F
from ..ops.lpc import lpc_subframe
from ..ops.silk_fixed import w32
from .batched_silk import _analysis_fir

LTP_ORDER = 5
MAX_LPC_ORDER = 16
TYPE_NO_VOICE_ACTIVITY = 0
TYPE_VOICED = 2
HARM_ATT_Q15 = (32440, 31130)
RAND_ATT_V_Q15 = (31130, 26214)
RAND_ATT_UV_Q15 = (32440, 29491)
RAND_BUF_SIZE = 128
BWE_COEF_Q16 = int(0.99 * 65536 + 0.5)          # SILK_FIX_CONST(0.99, 16)
BWE_AFTER_LOSS_Q16 = 63570
V_PITCH_GAIN_START_MIN_Q14 = 11469
V_PITCH_GAIN_START_MAX_Q14 = 15565
CNG_GAIN_SMTH_Q16 = 4634
CNG_GAIN_SMTH_THRESHOLD_Q16 = 46396
CNG_NLSF_SMTH_Q16 = 16348
CNG_SEED = 3176576
LTP_CHUNK = 10      # the LTP feedback distance is lag - 2 >= 30 samples


def loss_init_state(batch: int, fs_khz: int, nb_subfr: int,
                    device) -> dict:
    """The loss fields of a fresh lane, as the scalar ``ChannelState``
    holds them once its first frame has run ``_plc_reset`` and the CNG
    reset (silk/decoder.py:338-388, :805, :966-975): the excitation
    ``exc_q14`` [B, L], ``lag_prev``, ``loss_cnt``, ``prev_signal_type``,
    the ``plc_*`` and ``cng_*`` fields, and ``decoded_any`` (the Opus
    decoder has decoded a packet on the lane: its ``prev_mode != 0``)."""
    L = 5 * fs_khz * nb_subfr
    order = 16 if fs_khz >= 16 else 10
    step = 32767 // (order + 1)

    def full(shape, v, dtype=torch.int64):
        return torch.full(shape, v, dtype=dtype, device=device)
    smth = [(i + 1) * step for i in range(order)] \
        + [0] * (MAX_LPC_ORDER - order)
    return dict(
        exc_q14=full((batch, L), 0), lag_prev=full((batch,), 100),
        loss_cnt=full((batch,), 0), prev_signal_type=full((batch,), 0),
        plc_pitch_l_q8=full((batch,), L << 7),
        plc_ltp_coef_q14=full((batch, LTP_ORDER), 0),
        plc_prev_lpc_q12=full((batch, MAX_LPC_ORDER), 0),
        plc_prev_ltp_scale_q14=full((batch,), 0),
        plc_prev_gain_q16=full((batch, 2), 1 << 16),
        plc_rand_scale_q14=full((batch,), 0),
        plc_rand_seed=full((batch,), 0),
        plc_conc_energy=full((batch,), 0),
        plc_conc_energy_shift=full((batch,), 0),
        plc_last_frame_lost=full((batch,), 0),
        plc_nb_subfr=full((batch,), 2), plc_subfr_length=full((batch,), 20),
        cng_smth_nlsf_q15=torch.tensor(smth, dtype=torch.int64,
                                       device=device).repeat(batch, 1),
        cng_smth_gain_q16=full((batch,), 0),
        cng_exc_buf_q14=full((batch, L), 0),
        cng_synth_state=full((batch, MAX_LPC_ORDER), 0),
        cng_rand_seed=full((batch,), CNG_SEED),
        decoded_any=full((batch,), False, torch.bool))


def bwe_after_loss(a_q12, loss_cnt, order: int):
    """decode_parameters' bandwidth expansion of both coefficient sets on
    the first good frame after a loss (silk/decoder.py:548-552): a_q12
    [B, 2, 16] -> the same with lanes whose ``loss_cnt`` > 0 expanded."""
    b = a_q12.shape[0]
    flat = a_q12[:, :, :order].reshape(2 * b, order)
    exp = F.bwexpander(flat, BWE_AFTER_LOSS_Q16).reshape(b, 2, order)
    exp = torch.cat([exp, a_q12[:, :, order:]], dim=2)
    return torch.where((loss_cnt > 0)[:, None, None], exp, a_q12)


def ltp_after_loss(state: dict, voiced, b_q14, pitch_l):
    """decode_core's override after a loss (silk/decoder.py:622-630): the
    first frame after a loss that is not voiced, where the last good frame
    was, runs subframes 0-1 as voiced with a 0.25 centre tap at
    ``lag_prev``.  Returns (voiced [B, nb_subfr], b_q14, pitch_l)."""
    nb = pitch_l.shape[1]
    ov = (state["loss_cnt"] > 0) & (state["prev_signal_type"] == TYPE_VOICED) \
        & ~voiced
    sub = ov[:, None] & (torch.arange(nb, device=voiced.device) < nb // 2)
    centre = torch.zeros(LTP_ORDER, dtype=torch.int64, device=voiced.device)
    centre[LTP_ORDER // 2] = 1 << 12                 # 0.25 in Q14
    b_q14 = torch.where(sub[:, :, None], centre, b_q14)
    pitch_l = torch.where(sub, state["lag_prev"][:, None], pitch_l)
    return voiced[:, None] | sub, b_q14, pitch_l


def plc_update(state: dict, signal_type, pitch_l, b_q14, a_q12_1,
               ltp_scale_q14, gains_q16, *, fs_khz: int, nb_subfr: int):
    """silk_PLC_update on a good frame (silk/decoder.py:759-803): the
    frame's pitch_l [B, nb], b_q14 [B, nb, 5], a_q12_1 [B, 16] (the second
    coefficient set), ltp_scale_q14 [B], gains_q16 [B, nb] -> the new
    ``plc_*`` fields.  The voiced subframe loop runs from the last subframe
    back while its offset is below the last pitch lag (a per-lane mask)
    and keeps the largest summed LTP gain; only its centre tap and its
    lag survive, the gain clamped into [MIN, MAX] by a rescale."""
    sf = 5 * fs_khz
    voiced = signal_type == TYPE_VOICED
    gain = torch.zeros_like(signal_type)
    pitch_q8 = state["plc_pitch_l_q8"]
    last = pitch_l[:, nb_subfr - 1]
    for j in range(nb_subfr):
        k = nb_subfr - 1 - j
        temp = b_q14[:, k].sum(1)
        better = voiced & (j * sf < last) & (temp > gain)
        gain = torch.where(better, temp, gain)
        pitch_q8 = torch.where(better, pitch_l[:, k] << 8, pitch_q8)
    lo = gain < V_PITCH_GAIN_START_MIN_Q14
    hi = gain > V_PITCH_GAIN_START_MAX_Q14
    g1 = gain.clamp_min(1)
    scale_lo = F.div32(torch.full_like(g1, V_PITCH_GAIN_START_MIN_Q14 << 10),
                       g1)
    scale_hi = F.div32(torch.full_like(g1, V_PITCH_GAIN_START_MAX_Q14 << 14),
                       g1)
    centre = torch.where(lo, F.smulbb(gain, scale_lo) >> 10, torch.where(
        hi, F.smulbb(gain, scale_hi) >> 14, gain))
    coef = torch.zeros((gain.shape[0], LTP_ORDER), dtype=torch.int64,
                       device=gain.device)
    coef[:, LTP_ORDER // 2] = torch.where(voiced, centre, 0)
    pitch_q8 = torch.where(voiced, pitch_q8, (fs_khz * 18) << 8)
    b = gain.shape[0]
    return dict(plc_pitch_l_q8=pitch_q8, plc_ltp_coef_q14=coef,
                plc_prev_lpc_q12=a_q12_1,
                plc_prev_ltp_scale_q14=ltp_scale_q14,
                plc_prev_gain_q16=gains_q16[:, nb_subfr - 2:nb_subfr],
                plc_subfr_length=torch.full((b,), sf, dtype=torch.int64,
                                            device=gain.device),
                plc_nb_subfr=torch.full((b,), nb_subfr, dtype=torch.int64,
                                        device=gain.device))


def _lpc_synth(slpc, res, a_q12, order: int, sf: int):
    """The order-16 LPC synthesis of res [B, L] with constant a_q12 [B,
    16] from the taps slpc [B, 16], one K4 call a subframe of sf samples.
    Returns (v [B, L], new taps)."""
    a_rev = a_q12.flip(1)
    vs = []
    for k in range(res.shape[1] // sf):
        v, slpc = lpc_subframe(slpc, res[:, k * sf:(k + 1) * sf], a_rev,
                               order >> 1)
        vs.append(v.to(torch.int64))
        slpc = slpc.to(torch.int64)
    return torch.cat(vs, dim=1), slpc


def plc_conceal(state: dict, *, fs_khz: int, nb_subfr: int):
    """silk_PLC_conceal on every lane (silk/decoder.py:811-929): the SILK
    state dict (``fused_silk_dec.fused_init_state``) -> (xq [B, L]
    int16-valued, the concealed frame before comfort noise, and the
    updated fields: ``synth`` (slpc, and out_buf with the frame appended),
    ``lag_prev``, ``loss_cnt`` + 1 and the ``plc_*`` fields the
    concealment moves)."""
    sf = 5 * fs_khz
    L = sf * nb_subfr
    ltp_mem = 20 * fs_khz
    order = 16 if fs_khz >= 16 else 10
    dev = state["exc_q14"].device
    exc = state["exc_q14"]
    loss_cnt = state["loss_cnt"]
    prev_gain = state["plc_prev_gain_q16"]
    pg_q10 = prev_gain >> 6

    # the noise source: the lower-energy of the last two subframes'
    # excitation, scaled by their gains (silk_PLC_energy)
    en = []
    for k in range(2):
        s = (k + nb_subfr - 2) * sf
        x = F.sat16(F.smulww(exc[:, s:s + sf], pg_q10[:, k:k + 1]) >> 8)
        en.append(F.sum_sqr_shift(x))
    (e1, s1), (e2, s2) = en
    plc_len = state["plc_nb_subfr"] * state["plc_subfr_length"]
    rand_base = torch.where((e1 >> s2) < (e2 >> s1),
                            plc_len - state["plc_subfr_length"],
                            plc_len) - RAND_BUF_SIZE
    rand_base = rand_base.clamp_min(0)

    att = loss_cnt > 0
    voiced_prev = state["prev_signal_type"] == TYPE_VOICED
    harm_gain = torch.where(att, HARM_ATT_Q15[1], HARM_ATT_Q15[0])
    rand_gain = torch.where(
        voiced_prev, torch.where(att, RAND_ATT_V_Q15[1], RAND_ATT_V_Q15[0]),
        torch.where(att, RAND_ATT_UV_Q15[1], RAND_ATT_UV_Q15[0]))
    prev_lpc = torch.where(state["first_frame"][:, None], 0,
                           state["plc_prev_lpc_q12"])
    a = F.bwexpander(prev_lpc[:, :order], BWE_COEF_Q16)
    a16 = torch.cat([a, prev_lpc[:, order:]], dim=1)
    b_q14 = state["plc_ltp_coef_q14"]

    # the random scale on the first lost frame (silk/decoder.py:868-879)
    rs_v = (16384 - b_q14.sum(1)).clamp_min(3277)
    rs_v = F.smulbb(rs_v, state["plc_prev_ltp_scale_q14"]) >> 14
    rand_scale = torch.where(att, state["plc_rand_scale_q14"],
                             torch.where(voiced_prev, rs_v, 1 << 14))
    if bool((~att & ~voiced_prev).any()):
        from .fused_silk_dec import lpc_inverse_pred_gain_q30
        inv = lpc_inverse_pred_gain_q30(a16, order)
        down = inv.clamp(1 << 22, 1 << 27) << 3
        rand_gain = torch.where(~att & ~voiced_prev,
                                F.smulwb(down, rand_gain) >> 14, rand_gain)

    # rewhiten the last output through the expanded LPC into the LTP
    # buffer, scaled by the inverse of the last gain
    pitch_q8 = state["plc_pitch_l_q8"]
    lag = F.rshift_round(pitch_q8, 8)
    first = ltp_mem - lag - 2                       # idx + order
    fir = _analysis_fir(state["synth"]["out_buf"], a16, order)
    inv_gain = F.inverse32_varq(prev_gain[:, 1], 46).clamp_max(
        0x7FFFFFFF >> 1)
    pos = torch.arange(ltp_mem, device=dev)[None, :]
    sltp = torch.where(pos >= first[:, None],
                       F.smulwb(inv_gain[:, None], fir), 0)
    sltp = torch.cat([sltp, sltp.new_zeros((sltp.shape[0], L))], dim=1)

    # noise: the LCG's L states in closed form, each picking one of the
    # RAND_BUF_SIZE excitation samples from rand_base
    seeds = F.silk_rand_seq(state["plc_rand_seed"], L)
    ridx = ((seeds & F.M32) >> 25) & (RAND_BUF_SIZE - 1)
    noise = exc.gather(1, rand_base[:, None] + ridx)

    # the LTP synthesis, CHUNK samples at a time (their feedback distance
    # is lag - 2 >= 30), gains decaying and the lag drifting per subframe
    ar = torch.arange(LTP_CHUNK + 4, device=dev)[None, :]
    t = sltp.shape[1]
    max_q8 = (18 * fs_khz) << 8
    for k in range(nb_subfr):
        for c in range(sf // LTP_CHUNK):
            at = ltp_mem + k * sf + c * LTP_CHUNK
            p0 = (at - lag - 2).clamp(0, t - LTP_CHUNK - 4)
            seg = sltp.gather(1, p0[:, None] + ar)
            pred = 2
            for j in range(LTP_ORDER):
                pred = pred + F.smulwb(seg[:, 4 - j:4 - j + LTP_CHUNK],
                                       b_q14[:, j:j + 1])
            n0 = k * sf + c * LTP_CHUNK
            nz = F.smulwb(noise[:, n0:n0 + LTP_CHUNK], rand_scale[:, None])
            sltp[:, at:at + LTP_CHUNK] = w32((pred + nz) << 2)
        b_q14 = F.smulbb(harm_gain[:, None], b_q14) >> 15
        rand_scale = F.smulbb(rand_scale, rand_gain) >> 15
        pitch_q8 = (pitch_q8 + ((pitch_q8 * 655) >> 16)).clamp_max(max_q8)
        lag = F.rshift_round(pitch_q8, 8)

    # the LPC synthesis through K4, then the last gain
    v, slpc = _lpc_synth(state["synth"]["slpc"], sltp[:, ltp_mem:], a16,
                         order, sf)
    xq = F.sat16(F.rshift_round(F.smulww(v, pg_q10[:, 1:2]), 8))
    out_buf = torch.cat([state["synth"]["out_buf"], xq], dim=1)[:, -ltp_mem:]
    return xq, dict(
        synth=dict(slpc=slpc, out_buf=out_buf), lag_prev=lag,
        loss_cnt=loss_cnt + 1, plc_prev_lpc_q12=a16, plc_ltp_coef_q14=b_q14,
        plc_rand_scale_q14=rand_scale, plc_rand_seed=seeds[:, -1],
        plc_pitch_l_q8=pitch_q8)


def cng_update(state: dict, exc, gains_q16, *, sf: int, order: int):
    """The CNG update of a good frame whose signal type (already in
    ``prev_signal_type``) is no voice activity (silk/CNG.c:90-128, the
    scalar's :976-999): the smoothed NLSFs toward ``prev_nlsf``, the
    excitation buffer shifted with the subframe of the largest gain in
    front, the smoothed gain.  Returns the new ``cng_*`` fields on every
    lane (the caller selects)."""
    nb = gains_q16.shape[1]
    smth = state["cng_smth_nlsf_q15"]
    prev = state["prev_nlsf"]
    new_nlsf = smth + F.smulwb(prev - smth, CNG_NLSF_SMTH_Q16)
    new_nlsf = torch.cat([new_nlsf[:, :order], smth[:, order:]], dim=1)
    subfr = gains_q16.argmax(dim=1)                  # the first maximum
    idx = subfr[:, None] * sf + torch.arange(sf, device=exc.device)[None, :]
    buf = state["cng_exc_buf_q14"]
    new_buf = torch.cat([exc.gather(1, idx), buf[:, :(nb - 1) * sf],
                         buf[:, nb * sf:]], dim=1)
    g = state["cng_smth_gain_q16"]
    for i in range(nb):
        gi = gains_q16[:, i]
        g = w32(g + F.smulwb(gi - g, CNG_GAIN_SMTH_Q16))
        g = torch.where(F.smulww(g, CNG_GAIN_SMTH_THRESHOLD_Q16) > gi, gi, g)
    return dict(cng_smth_nlsf_q15=new_nlsf, cng_exc_buf_q14=new_buf,
                cng_smth_gain_q16=g)


def cng_add(state: dict, xq, tabs, *, sf: int, order: int):
    """The comfort noise of a lost frame (silk/CNG.c:131-178, the scalar's
    :1000-1036), after the concealment has updated ``plc_rand_scale_q14``:
    its gain from the concealment's and the smoothed gain, an excitation
    of the buffer's samples at LCG indices (closed form), the LPC of the
    smoothed NLSFs (``_nlsf2a``) through K4 from ``cng_synth_state``, added
    to xq [B, L] with saturation.  Returns (xq, the new cng_synth_state
    and cng_rand_seed)."""
    from .fused_silk_dec import _nlsf2a
    L = xq.shape[1]
    g = F.smulww(state["plc_rand_scale_q14"],
                 state["plc_prev_gain_q16"][:, 1])
    smth = state["cng_smth_gain_q16"]
    big = (g >= 1 << 21) | (smth > 1 << 23)
    ga = (g >> 16) * (g >> 16)
    ga = w32((smth >> 16) * (smth >> 16) - (ga << 5))
    ga = w32(F.sqrt_approx(ga) << 16)
    gb = F.smulww(g, g)
    gb = w32(F.smulww(smth, smth) - (gb << 5))
    gb = w32(F.sqrt_approx(gb) << 8)
    gain_q10 = torch.where(big, ga, gb) >> 6

    mask = 255
    while mask > L:
        mask >>= 1
    seeds = F.silk_rand_seq(state["cng_rand_seed"], L)
    ridx = ((seeds & F.M32) >> 24) & mask
    exc = state["cng_exc_buf_q14"].gather(1, ridx)
    a_q12, _unstable = _nlsf2a(tabs, state["cng_smth_nlsf_q15"][:, :order])
    v, synth = _lpc_synth(state["cng_synth_state"], exc, a_q12, order, sf)
    xq = F.sat16(xq + F.sat16(F.rshift_round(
        F.smulww(v, gain_q10[:, None]), 8)))
    return xq, dict(cng_synth_state=synth, cng_rand_seed=seeds[:, -1])


def glue_lost(xq):
    """silk_PLC_glue_frames on a lost frame: its energy."""
    e, s = F.sum_sqr_shift(xq)
    return dict(plc_conc_energy=e, plc_conc_energy_shift=s,
                plc_last_frame_lost=torch.ones_like(e))


def glue_good(state: dict, xq):
    """silk_PLC_glue_frames on a good frame (silk/decoder.py:940-961): on
    lanes whose last frame was lost and whose energy rose, a fade-in from
    the concealed energy's square-root ratio that stops once its gain
    passes unity (a cumulative per-lane mask), multiplied with SMULWB as
    the reference does.  Returns (xq, the new glue fields)."""
    L = xq.shape[1]
    was_lost = state["plc_last_frame_lost"] != 0
    ce, cs = state["plc_conc_energy"], state["plc_conc_energy_shift"]
    e, es = F.sum_sqr_shift(xq)
    ce = torch.where(was_lost & (es > cs), ce >> (es - cs).clamp_min(0), ce)
    e = torch.where(es < cs, e >> (cs - es).clamp_min(0), e)
    fade = was_lost & (e > ce)
    new = dict(plc_conc_energy=ce,
               plc_last_frame_lost=torch.zeros_like(ce))
    if not bool(fade.any()):
        return xq, new
    lz = F.clz32(ce) - 1
    conc = F.shl32(ce, lz)
    e = e >> (24 - lz).clamp_min(0)
    frac = F.div32(conc, e.clamp_min(1))
    gain = F.sqrt_approx(frac) << 4
    slope = F.div32(65536 - gain, torch.full_like(gain, L)) << 2
    k = torch.arange(L, device=xq.device)[None, :]
    g_k = gain[:, None] + k * slope[:, None]
    # sample k runs while every gain after samples 0..k-1 is <= 1.0
    ok = torch.cat([torch.ones_like(g_k[:, :1], dtype=torch.bool),
                    g_k[:, 1:] <= 65536], dim=1)
    run = torch.cummin(ok.to(torch.int64), dim=1).values != 0
    faded = F.smulwb(g_k, xq)
    return torch.where(fade[:, None] & run, faded, xq), new
