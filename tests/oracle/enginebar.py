"""Scalar Python oracle of the FULL engine over wicked OHLC bars.

``tests/oracle/engine.py::EngineOracle`` walks the live tick loop (flat-wick
tapes: one price per minute, ties impossible).  This oracle mirrors the
*scaled MC surface* instead — ``sim/enginepath.engine_path_replay`` with its
B→C→D bar order on bars that have real highs/lows:

  B. position management on the bar's extremes, same-bar stop∧target ties
     resolved by the distance-weighted coin with a supplied per-bar uniform
     (qmmx_monolithic.py:3467-3480), exits priced at the barrier
     (:3481-3486), target escalation (:1950-2012) evaluated at the close
     within CONTACT_PROX of the target;
  C. the 12-gate entry ladder at the close against state from bars <= t-1;
  D. the minute-close pipeline for bar t (:1813-1855).

It is deliberately scalar and loopy, built on the semantics oracles
(GuardOracle / TouchMemoryOracle / soft_veto / volume_trend helpers) that the
vectorized ops are unit-tested against, with float32 mirrored at the decision
boundaries the repo convention requires (distances, confidence, the tie coin).
Escalation interacting with intrabar extremes and the tie coin is exactly the
surface no other oracle covers — this oracle closes it.
"""

from __future__ import annotations

import numpy as np

from . import semantics as S
from .semantics import GuardOracle, TouchMemoryOracle

f32 = np.float32

KIND_SOLID = 1
PROXIMITY_WINDOW = 0.35   # ExitStrategy (:704-718)


def _confidence(dist, solid, touch_count, prox):
    """compute_confidence (:1415-1427) in f32; direction always known at the
    gate (gate 5 passed)."""
    base = f32(max(f32(0.0), f32(1.0) - f32(dist / f32(max(1e-4, prox)))))
    base = f32(base + (f32(0.08) if solid else f32(0.02)))
    if touch_count <= 1:
        base = f32(base + f32(0.10))
    elif touch_count == 2:
        base = f32(base - f32(0.08))
    else:
        base = f32(base - f32(0.16))
    base = f32(base + f32(0.03))
    return f32(min(f32(1.0), max(f32(0.0), base)))


def _should_escalate(levels, side_long, entry, c, closes, vols):
    """should_escalate_on_target (:897-960) against bars <= t-1.

    ``closes``/``vols`` are the oldest→newest histories of FINISHED bars (the
    scan's rings before bar t is pushed).  Returns None or (next_target,
    trail_stop)."""
    if not levels:
        return None
    # nearest level to the current price (f32 distances, first-min tie-break)
    best_d, best_p = None, None
    for lp, _k in levels:
        d = f32(abs(f32(c) - f32(lp)))
        if best_d is None or d < best_d:
            best_d, best_p = d, lp
    near = best_d <= f32(PROXIMITY_WINDOW)
    # approach from the last two closes (:554-565); fallback price-vs-level
    appr = S.infer_approach(closes, best_p)
    if appr is None:
        appr = "from_above" if c > best_p else "from_below"
    trend = S.volume_trend_toward_level(closes, vols, best_p)
    if not near or trend is None:
        return None     # can_decide fails → hold, no escalation
    reversal = trend < 0
    appr_below = appr == "from_below"
    rev_down = appr_below
    cont_down = not appr_below
    if reversal:
        against = rev_down if side_long else not rev_down
    else:
        against = cont_down if side_long else not cont_down
    if against or reversal:
        return None
    # next level strictly beyond the anchor in the trade direction (:1038-1049)
    anchor = best_p
    if side_long:
        higher = [lp for lp, _ in levels if lp > anchor + 1e-9]
        if not higher:
            return None
        nxt = min(higher)
    else:
        lower = [lp for lp, _ in levels if lp < anchor - 1e-9]
        if not lower:
            return None
        nxt = max(lower)
    trail = max(entry, anchor - PROXIMITY_WINDOW) if side_long \
        else min(entry, anchor + PROXIMITY_WINDOW)
    trail = float(f32(np.round(f32(trail) * f32(100.0)) / f32(100.0)))  # (:952)
    return nxt, trail


def engine_bar_path(
    o, h, l, c, v, tie, levels, *,
    contact_prox=0.05, stop_padding=0.35, tp_padding=0.25, q_min_prob=0.60,
    cooldown_s=8.0, enable_veto=True, veto_vol_strong=0.25, veto_prox=0.06,
    confluence_within=0.15, overtouch_limit=4, use_blend=False,
    w_rules=0.7, w_ml=0.3, escalation=True,
):
    """One path of wicked OHLC bars through the full engine ladder.

    ``levels``: list of (price, kind) with kind 1=solid, 0=dashed; ``tie``:
    per-bar U(0,1) for the same-bar coin.  ML and policy gates run in their
    reference default posture (no model → ML passes with mlp=conf; policy
    gate disabled).  Returns dict of lifecycle totals plus per-bar events.
    """
    w_bars = len(c)
    cooldown_ms = int(cooldown_s * 1000)
    side = 0          # 0 flat, +1 long, -1 short
    entry = stop = target = risk0 = 0.0
    cooldown_until = -(1 << 30)
    last_dir = 0      # 0 unknown, +1 up, -1 down
    prev_c = f32(o[0])
    counts = [0] * len(levels)
    latch = [False] * len(levels)
    guard = GuardOracle()
    touchmem = TouchMemoryOracle()
    closes: list[float] = []
    vols: list[float] = []
    equity = peak = dd = f32(0.0)
    trades = wins = losses = escal = 0
    ties_seen = 0
    skips: dict[str, int] = {}
    events = []

    for t in range(w_bars):
        hh, ll, cc, vv = f32(h[t]), f32(l[t]), f32(c[t]), float(v[t])
        now_ms = t * 60_000
        ev = dict(opened=False, closed=False, escalated=False, tie=False)

        # ---- B) position management on the bar extremes ----
        is_open = side != 0
        was_flat = not is_open
        if is_open:
            is_long = side > 0
            stop_hit = (ll <= stop) if is_long else (hh >= stop)
            tgt_hit = (hh >= target) if is_long else (ll <= target)
            if stop_hit and tgt_hit:
                up = f32(max(f32(0.0), f32(hh - f32(entry))))
                dn = f32(max(f32(0.0), f32(f32(entry) - ll)))
                p_tp = f32(up / f32(up + dn + f32(1e-9)))
                target_first = f32(tie[t]) < p_tp
                ties_seen += 1
                ev["tie"] = True
            else:
                target_first = tgt_hit
            hit = stop_hit or tgt_hit
            do_escalate = False
            if hit and target_first and escalation:
                near_tgt = f32(abs(f32(cc) - f32(target))) <= f32(contact_prox)
                if near_tgt:
                    esc = _should_escalate(levels, side > 0, entry, cc,
                                           closes, vols)
                    if esc is not None:
                        target, stop = esc[0], esc[1]
                        escal += 1
                        do_escalate = True
                        ev["escalated"] = True
            if hit and not do_escalate:
                exit_px = f32(target) if target_first else f32(stop)
                pnl = f32(exit_px - f32(entry)) if side > 0 \
                    else f32(f32(entry) - exit_px)
                r = f32(pnl / f32(max(risk0, 1e-9)))
                equity = f32(equity + r)
                peak = f32(max(peak, equity))
                dd = f32(max(dd, f32(peak - equity)))
                if pnl > 0:
                    wins += 1
                else:
                    losses += 1
                side = 0
                cooldown_until = now_ms + cooldown_ms
                ev["closed"] = True

        # ---- C) the entry ladder at the close ----
        reason = None

        def fail(code):
            nonlocal reason
            if reason is None:
                reason = code

        if not was_flat:
            fail("IN_POSITION")
        if reason is None and now_ms < cooldown_until:
            fail("COOLDOWN")
        if reason is None and not levels:
            fail("NOLEVELS")
        direction = 0
        if t > 0:
            if cc > prev_c + f32(1e-9):
                direction = 1
            elif cc < prev_c - f32(1e-9):
                direction = -1
            else:
                direction = last_dir
        if reason is None and direction == 0:
            fail("DIR_UNKNOWN")
        best_d, best_i = None, None
        for i, (lp, _k) in enumerate(levels):
            d = f32(abs(f32(cc) - f32(lp)))
            if best_d is None or d < best_d:
                best_d, best_i = d, i
        if reason is None and (best_i is None or best_d > f32(contact_prox)):
            fail("TOO_FAR")

        tc = counts[best_i] if best_i is not None else 0
        if reason is None:
            # contact latch mutates exactly when gates 2-6 passed (:1557-1587)
            for i, (lp, _k) in enumerate(levels):
                d_i = f32(abs(f32(lp) - f32(cc)))
                inside = d_i <= f32(contact_prox)
                if i == best_i:
                    if inside and not latch[i]:
                        counts[i] += 1
                    latch[i] = inside
                else:
                    latch[i] = latch[i] and inside
            tc = counts[best_i]
            if tc >= overtouch_limit:
                fail("LEVEL_OVERTOUCHED")

        decay_mult = f32(1.0)
        if reason is None and guard.regime == "accumulation":
            edge_for_this = "top" if direction == -1 else "bot"
            if touchmem.edge_fatigued(now_ms) == edge_for_this:
                fail("EDGE_FATIGUE")
            if reason is None:
                side_tm = "SHORT" if direction == -1 else "LONG"
                ok, why, mult = touchmem.allow(best_i, side_tm, now_ms)
                if not ok:
                    fail("TOUCH_BUDGET" if why == "budget" else "TOUCH_COOLDOWN")
                else:
                    decay_mult = f32(mult)

        if reason is None:
            lp, lk = levels[best_i]
            conf = f32(_confidence(best_d, lk == KIND_SOLID, tc, contact_prox)
                       * decay_mult)
            if conf < f32(q_min_prob):
                fail("CONF_LOW")

        go_long = direction == 1
        if reason is None:
            if (guard.regime == "breakout_up" and not go_long) or \
                    (guard.regime == "breakout_down" and go_long):
                fail("ACC_BREAKOUT_GATE")

        if reason is None and enable_veto:
            slope = S.volume_slope(vols, 6)
            lp = levels[best_i][0]
            confl = sum(1 for q, _ in levels
                        if abs(q - lp) <= confluence_within) >= 2
            ok, code = S.soft_veto(
                "long" if go_long else "short", slope,
                "from_below" if direction == 1 else "from_above", confl,
                best_d, contact_prox, veto_vol_strong, veto_prox)
            if not ok:
                fail(code)

        if reason is None and use_blend:
            # no ML model → mlp = conf; blended = conf; same threshold
            lp, lk = levels[best_i]
            conf = f32(_confidence(best_d, lk == KIND_SOLID, tc, contact_prox)
                       * decay_mult)
            s_w = w_rules + w_ml
            blended = f32(f32(w_rules / s_w) * conf + f32(w_ml / s_w) * conf)
            if blended < f32(q_min_prob):
                fail("COMBINED_LOW")

        if reason is None:
            # open at the close (policy gate disabled; noise off)
            lp, _lk = levels[best_i]
            side = 1 if go_long else -1
            entry = float(cc)
            stop = float(f32(f32(lp) - f32(stop_padding)) if go_long
                         else f32(f32(lp) + f32(stop_padding)))
            target = float(f32(f32(lp) + f32(tp_padding)) if go_long
                           else f32(f32(lp) - f32(tp_padding)))
            risk0 = float(f32(abs(f32(entry) - f32(stop))))
            trades += 1
            ev["opened"] = True
        else:
            skips[reason] = skips.get(reason, 0) + 1

        if t > 0 and cc != prev_c:
            last_dir = 1 if cc > prev_c else -1

        # ---- D) minute close of bar t (:1813-1855) ----
        closes.append(float(cc))
        vols.append(vv)
        ma_s = sum(vols[-5:]) / max(1, min(5, len(vols)))
        ma_l = sum(vols[-20:]) / max(1, min(20, len(vols)))
        guard.push(now_ms, float(o[t]), float(hh), float(ll), float(cc), vv)
        if guard.regime == "accumulation":
            touchmem.register(
                now_ms, float(o[t]), float(hh), float(ll), float(cc), vv,
                [lp for lp, _ in levels],
                guard.box_low, guard.box_high, ma_s, ma_l)
        if guard.regime in ("breakout_up", "breakout_down"):
            touchmem = TouchMemoryOracle()
        prev_c = cc
        events.append(ev)

    return dict(
        equity=float(equity), trades=trades, wins=wins, losses=losses,
        open_at_end=side != 0, max_dd=float(dd), escalations=escal,
        ties_seen=ties_seen, skips=skips, events=events,
    )
