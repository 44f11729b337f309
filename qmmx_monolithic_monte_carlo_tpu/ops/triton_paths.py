"""Fused first-contact Monte Carlo kernel for NVIDIA GPUs (Pallas, Triton route).

The XLA pipeline (``sim/pathsim.mc_paths``) writes each block's OHLC bars to
device memory between the sampler and the replay, then reads them back.  This
kernel keeps a path in registers from its first random number to its outcome:
one GPU thread walks one path over the bars, so the only memory traffic is a
few statistics per program.

Per path (GBM sampler, ``sim/pathsim.path_replay`` semantics):

1. random numbers come from a counter-based generator, threefry-2x32 keyed by
   the seed, with the counter ``(global path index, draw index)``.  The stream
   of a path is therefore the same whatever the block and grid shape;
2. each pair of bars takes one Box-Muller pair (both branches are used) for
   its close-to-close shocks, and one uniform per bar and side for the
   Brownian-bridge high and low;
3. the first bar whose close lies within ``contact_prox`` of the nearest valid
   level (up to 8, first minimum wins) opens the trade: long if the close is
   above the previous close, stop and target at the level -/+ the paddings;
4. the first later bar that touches the stop or the target closes it; a bar
   that touches both is resolved by the distance-weighted coin of the
   reference (qmmx_monolithic.py:3467-3480).

Each program reduces its paths into integer counts, float sums, the R extremes
and a 128-bin R histogram; one XLA reduction over programs merges them into the
``PathStats`` that ``mc_paths`` returns.  Nothing is carried from one program to
the next, so programs run in any order.

Uniform draw ``r`` of a path is word ``r % 2`` of threefry block ``r // 2``.
Rows ``6j .. 6j+5`` feed bars ``2j`` and ``2j+1`` (Box-Muller ``u1, u2``, then
``hi, lo`` of each bar); row ``3W`` is the tie coin; rows ``3W+1 .. 3W+4`` are
two more Box-Muller pairs for the execution noise (level jitter, entry slip,
stop slip, target slip).  With ``external_uniforms`` the kernel reads those
rows from an ``f32[rows, num_paths]`` array instead, which is how the CPU tests
pin it against a NumPy oracle in interpret mode.  With ``antithetic`` the odd
path of each pair draws its partner's Box-Muller uniforms and negates the
normals (in the external mode the caller supplies the shared uniforms).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..sim.pathsim import HIST_BINS, HIST_HI, HIST_LO, PathStats
from ..types import OUTCOME_OPEN, OUTCOME_STOP, OUTCOME_TP

MAX_LEVELS = 8        # level slots the kernel scans (padded with invalid slots)
TILE = 256            # paths walked together by one program (power of two)
TILES_PER_PROGRAM = 16
NUM_WARPS = 4
_HIST_GROUP = 32      # histogram bins reduced at a time (bounds registers)
_BIG = 3.4e38
_TWO_PI = 6.283185307179586
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# knob slots of the f32[16] scalar input
_K_PROX, _K_STOP, _K_TP, _K_JIT, _K_ENTRY, _K_SSLIP, _K_TSLIP = range(7)
_K_DRIFT, _K_SIGDT, _K_LOGS0 = 7, 8, 9
N_KNOBS = 16


def num_rows(num_bars: int, use_noise: bool) -> int:
    """Uniform rows one path consumes (see the module docstring)."""
    return 3 * num_bars + 1 + (4 if use_noise else 0)


def _rotl(x, r: int):
    return (x << jnp.uint32(r)) | (x >> jnp.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds, the block function of ``jax.random``."""
    k2 = k0 ^ k1 ^ jnp.uint32(0x1BD11BDA)
    ks = (k0, k1, k2)
    x0 = x0 + k0
    x1 = x1 + k1
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + jnp.uint32(i + 1)
    return x0, x1


def bits_to_uniform(bits):
    """23 random bits to a float32 in (0, 1), never 0 (``log`` stays finite)."""
    return ((bits >> jnp.uint32(9)).astype(jnp.float32) + jnp.float32(0.5)) \
        * jnp.float32(1.0 / (1 << 23))


def _box_muller(u1, u2):
    r = jnp.sqrt(jnp.float32(-2.0) * jnp.log(u1))
    a = jnp.float32(_TWO_PI) * u2
    return r * jnp.cos(a), r * jnp.sin(a)


def _threefry_draw2(k0, k1, path):
    """``draw2`` over the kernel's own stream: uniform rows ``row`` and
    ``row + 1`` (``row`` even) of paths ``who`` are the two words of
    threefry block ``row // 2``."""
    def draw2(row, who=path):
        ctr = jnp.uint32(row // 2) if isinstance(row, int) \
            else (row // 2).astype(jnp.uint32)
        b0, b1 = threefry2x32(k0, k1, who, jnp.full(who.shape, ctr, jnp.uint32))
        return bits_to_uniform(b0), bits_to_uniform(b1)
    return draw2


def _walk(path, draw2, knob, levels, *, num_bars, use_noise, antithetic):
    """Walk the paths ``path`` (uint32[n]) over the bars: GBM bars, first
    contact, stop/target.  ``knob`` holds the scalar knobs (slots ``_K_*``),
    ``levels`` the (price, valid) scalar pairs.  Returns per path
    (entered, closed, is_tp, r).  The kernel and ``mc_paths_reference`` both
    run this."""
    n = path.shape[0]
    prox, stop_pad, tp_pad = knob[_K_PROX], knob[_K_STOP], knob[_K_TP]
    drift, sig_dt, log_s0 = knob[_K_DRIFT], knob[_K_SIGDT], knob[_K_LOGS0]
    sig2dt = sig_dt * sig_dt
    big = jnp.float32(_BIG)
    zero = jnp.zeros((n,), jnp.float32)
    false = jnp.zeros((n,), jnp.bool_)
    z_path = path & jnp.uint32(0xFFFFFFFE) if antithetic else path

    w3 = 3 * num_bars
    tie_u, nu1 = draw2(w3)
    if use_noise:
        na1, nu2 = draw2(w3 + 2)
        na2, _ = draw2(w3 + 4)
        jit_n, entry_n = _box_muller(nu1, na1)
        sslip_n, tslip_n = _box_muller(nu2, na2)
        jit_n = jit_n * knob[_K_JIT]
        entry_n = entry_n * knob[_K_ENTRY]
        sslip_n = sslip_n * knob[_K_SSLIP]
        tslip_n = tslip_n * knob[_K_TSLIP]

    def bar(state, z, u_hi, u_lo):
        (rel, log_prev, prev_close, entered, done, is_tp, is_long, entry,
         stop, target) = state
        incr = drift + sig_dt * z
        rel = rel + incr
        log_c = log_s0 + rel
        close = jnp.exp(log_c)
        d2 = (log_c - log_prev) ** 2
        mid = log_prev + log_c
        high = jnp.exp(0.5 * (mid + jnp.sqrt(d2 - 2.0 * sig2dt * jnp.log(u_hi))))
        low = jnp.exp(0.5 * (mid - jnp.sqrt(d2 - 2.0 * sig2dt * jnp.log(u_lo))))

        # exits first: a trade opened on this bar is checked from the next
        live = entered & ~done
        stop_hit = jnp.where(is_long, low <= stop, high >= stop)
        tgt_hit = jnp.where(is_long, high >= target, low <= target)
        up = jnp.maximum(0.0, high - entry)
        dn = jnp.maximum(0.0, entry - low)
        coin_tp = tie_u < up / (up + dn + jnp.float32(1e-9))
        tp_first = jnp.where(stop_hit & tgt_hit, coin_tp, tgt_hit)
        hit = live & (stop_hit | tgt_hit)
        is_tp = jnp.where(hit, tp_first, is_tp)
        done = done | hit

        # first contact with the nearest valid level
        best_d = jnp.full((n,), big)
        best_p = zero
        for lp, lv in levels:
            d = jnp.where(lv, jnp.abs(close - lp), big)
            take = d < best_d
            best_p = jnp.where(take, lp, best_p)
            best_d = jnp.where(take, d, best_d)
        opens = ~entered & (best_d <= prox)
        lvl = best_p
        fill = close
        if use_noise:
            lvl = lvl + jit_n
            fill = fill + entry_n
        up_move = close > prev_close
        new_stop = jnp.where(up_move, lvl - stop_pad, lvl + stop_pad)
        new_tgt = jnp.where(up_move, lvl + tp_pad, lvl - tp_pad)
        if use_noise:
            new_stop = new_stop + sslip_n
            new_tgt = new_tgt + tslip_n
        entered = entered | opens
        is_long = jnp.where(opens, up_move, is_long)
        entry = jnp.where(opens, fill, entry)
        stop = jnp.where(opens, new_stop, stop)
        target = jnp.where(opens, new_tgt, target)
        return (rel, log_c, close, entered, done, is_tp, is_long, entry,
                stop, target)

    def pair_body(j, state):
        u1, u2 = draw2(6 * j, z_path)
        za, zb = _box_muller(u1, u2)
        if antithetic:
            sign = jnp.where((path & jnp.uint32(1)) == 1, -1.0, 1.0)
            za, zb = sign * za, sign * zb
        ha, la = draw2(6 * j + 2)
        hb, lb = draw2(6 * j + 4)
        state = bar(state, za, ha, la)
        return bar(state, zb, hb, lb)

    log_s0_v = jnp.full((n,), log_s0)
    init = (zero, log_s0_v, jnp.exp(log_s0_v), false, false, false, false,
            zero, zero, zero)
    (_, _, _, entered, done, is_tp, _, entry, stop,
     target) = jax.lax.fori_loop(0, num_bars // 2, pair_body, init)

    risk = jnp.maximum(jnp.abs(entry - stop), jnp.float32(1e-9))
    reward = jnp.abs(target - entry)
    closed = entered & done
    r = jnp.where(closed, jnp.where(is_tp, reward / risk, -1.0), 0.0)
    return entered, closed, is_tp, r


def _kernel(key_ref, knobs_ref, lp_ref, lv_ref, *refs, num_bars, tile,
            tiles, use_noise, antithetic, external):
    if external:
        u_ref, cnt_ref, sum_ref, hist_ref = refs
    else:
        cnt_ref, sum_ref, hist_ref = refs
    k0 = key_ref[0]
    k1 = key_ref[1]
    knob = [knobs_ref[i] for i in range(N_KNOBS)]
    levels = [(lp_ref[i], lv_ref[i] > 0.0) for i in range(MAX_LEVELS)]
    lane = jax.lax.broadcasted_iota(jnp.int32, (tile,), 0)
    big = jnp.float32(_BIG)
    first_tile = pl.program_id(0) * tiles

    def tile_body(t, acc):
        base = (first_tile + t) * tile
        path = (base + lane).astype(jnp.uint32)
        if external:
            def draw2(row, who=None):
                return (u_ref[row, pl.ds(base, tile)],
                        u_ref[row + 1, pl.ds(base, tile)])
        else:
            draw2 = _threefry_draw2(k0, k1, path)
        entered, closed, is_tp, r = _walk(
            path, draw2, knob, levels, num_bars=num_bars, use_noise=use_noise,
            antithetic=antithetic)
        (n_ent, n_tp, n_stop, n_open, s_r, s_r2, mn, mx, hist) = acc
        i32 = jnp.int32
        n_ent = n_ent + jnp.sum(entered.astype(i32))
        n_tp = n_tp + jnp.sum((closed & is_tp).astype(i32))
        n_stop = n_stop + jnp.sum((closed & ~is_tp).astype(i32))
        n_open = n_open + jnp.sum((entered & ~closed).astype(i32))
        s_r = s_r + jnp.sum(r)
        s_r2 = s_r2 + jnp.sum(r * r)
        mn = jnp.minimum(mn, jnp.min(jnp.where(entered, r, big)))
        mx = jnp.maximum(mx, jnp.max(jnp.where(entered, r, jnp.float32(-_BIG))))
        scale = jnp.float32(HIST_BINS / (HIST_HI - HIST_LO))
        b = jnp.clip(((r - jnp.float32(HIST_LO)) * scale).astype(i32), 0,
                     HIST_BINS - 1)
        b = jnp.where(entered, b, -1)
        col = jax.lax.broadcasted_iota(i32, (tile, _HIST_GROUP), 1)
        hist = tuple(
            h + jnp.sum((b[:, None] == col + g * _HIST_GROUP).astype(i32), axis=0)
            for g, h in enumerate(hist))
        return (n_ent, n_tp, n_stop, n_open, s_r, s_r2, mn, mx, hist)

    z32 = jnp.int32(0)
    acc0 = (z32, z32, z32, z32, jnp.float32(0.0), jnp.float32(0.0), big,
            jnp.float32(-_BIG),
            tuple(jnp.zeros((_HIST_GROUP,), jnp.int32)
                  for _ in range(HIST_BINS // _HIST_GROUP)))
    (n_ent, n_tp, n_stop, n_open, s_r, s_r2, mn, mx,
     hist) = jax.lax.fori_loop(0, tiles, tile_body, acc0)

    slot = jax.lax.broadcasted_iota(jnp.int32, (8,), 0)
    cnt = jnp.zeros((8,), jnp.int32)
    for k, v in enumerate((n_ent, n_tp, n_stop, n_open)):
        cnt = jnp.where(slot == k, v, cnt)
    sums = jnp.zeros((8,), jnp.float32)
    for k, v in enumerate((s_r, s_r2, mn, mx)):
        sums = jnp.where(slot == k, v, sums)
    cnt_ref[...] = cnt
    sum_ref[...] = sums
    for g, h in enumerate(hist):
        hist_ref[g * _HIST_GROUP:(g + 1) * _HIST_GROUP] = h


def _tiles_per_program(num_paths: int, tile: int) -> int:
    tiles = TILES_PER_PROGRAM
    while (num_paths // tile) % tiles:
        tiles //= 2
    return tiles


def check_args(levels, *, num_paths: int, num_bars: int, tile: int = TILE,
               sampler: str = "gbm") -> None:
    """Host-side validation of what the kernel can run (raises ValueError)."""
    if sampler != "gbm":
        raise ValueError(f"the triton kernel runs the gbm sampler only, not "
                         f"{sampler!r}; use --backend xla")
    if num_paths <= 0 or num_paths % tile:
        raise ValueError(f"num_paths must be a positive multiple of {tile}")
    if num_paths >= 1 << 31:
        raise ValueError("num_paths must be below 2**31 (int32 counts)")
    if num_bars <= 0 or num_bars % 2:
        raise ValueError("num_bars must be even (paired Box-Muller draws)")
    if int(np.asarray(levels.valid).sum()) > MAX_LEVELS:
        raise ValueError(f"the triton kernel scans at most {MAX_LEVELS} "
                         "valid levels; use --backend xla")


def _compact_levels(levels):
    """The valid level slots, packed into ``MAX_LEVELS`` (price, valid) rows."""
    price = np.asarray(levels.price, np.float32)
    valid = np.asarray(levels.valid, bool)
    lp = np.zeros(MAX_LEVELS, np.float32)
    lv = np.zeros(MAX_LEVELS, np.float32)
    kept = price[valid]
    lp[:kept.size] = kept
    lv[:kept.size] = 1.0
    return lp, lv


@functools.partial(
    jax.jit,
    static_argnames=("num_paths", "num_bars", "tile", "antithetic",
                     "use_noise", "interpret"))
def _run(key, knobs, lp, lv, external_uniforms, *, num_paths, num_bars, tile,
         antithetic, use_noise, interpret):
    external = external_uniforms is not None
    tiles = _tiles_per_program(num_paths, tile)
    n_prog = num_paths // (tile * tiles)
    kernel = functools.partial(
        _kernel, num_bars=num_bars, tile=tile, tiles=tiles,
        use_noise=use_noise, antithetic=antithetic, external=external)
    whole = lambda n: pl.BlockSpec((n,), lambda i: (0,))  # noqa: E731
    in_specs = [whole(2), whole(N_KNOBS), whole(MAX_LEVELS), whole(MAX_LEVELS)]
    args = [key, knobs, lp, lv]
    if external:
        rows = num_rows(num_bars, use_noise)
        in_specs.append(pl.BlockSpec((rows, num_paths), lambda i: (0, 0)))
        args.append(external_uniforms)
    cnt, sums, hist = pl.pallas_call(
        kernel,
        grid=(n_prog,),
        in_specs=in_specs,
        out_specs=[pl.BlockSpec((8,), lambda i: (i,)),
                   pl.BlockSpec((8,), lambda i: (i,)),
                   pl.BlockSpec((HIST_BINS,), lambda i: (i,))],
        out_shape=[jax.ShapeDtypeStruct((n_prog * 8,), jnp.int32),
                   jax.ShapeDtypeStruct((n_prog * 8,), jnp.float32),
                   jax.ShapeDtypeStruct((n_prog * HIST_BINS,), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="first_contact_paths",
    )(*args)
    cnt = jnp.sum(cnt.reshape(n_prog, 8), axis=0)
    sums = sums.reshape(n_prog, 8)
    entered = cnt[0].astype(jnp.float32)
    has = cnt[0] > 0
    mn = jnp.where(has, jnp.min(sums[:, 2]), jnp.inf)
    f32 = lambda x: x.astype(jnp.float32)  # noqa: E731
    return PathStats(
        n=jnp.float32(num_paths), n_entered=entered, n_tp=f32(cnt[1]),
        n_stop=f32(cnt[2]), n_open=f32(cnt[3]),
        sum_r=jnp.sum(sums[:, 0]), sum_r2=jnp.sum(sums[:, 1]),
        min_r=mn, max_r=jnp.where(has, jnp.max(sums[:, 3]), -jnp.inf),
        sum_trades=entered, sum_dd=f32(cnt[2]),
        max_dd=jnp.where(has, jnp.maximum(0.0, -mn), 0.0),
        hist=f32(jnp.sum(hist.reshape(n_prog, HIST_BINS), axis=0)),
    )


def gbm_consts(s0, mu, sigma, dt):
    """(drift, sigma*sqrt(dt), log s0) per bar, in float32."""
    f32 = jnp.float32
    sigma = jnp.asarray(sigma, f32)
    dt = jnp.asarray(dt, f32)
    return ((jnp.asarray(mu, f32) - 0.5 * sigma * sigma) * dt,
            sigma * jnp.sqrt(dt), jnp.log(jnp.asarray(s0, f32)))


def seed_key(seed) -> jnp.ndarray:
    """The threefry key words of an integer seed."""
    s = int(seed) & ((1 << 64) - 1)
    return jnp.asarray([s & 0xFFFFFFFF, s >> 32], jnp.uint32)


def make_knobs(params, noise=None, *, s0=100.0, mu=0.0, sigma=0.15,
               dt=1.0 / (390.0 * 252.0)) -> jnp.ndarray:
    """The kernel's f32[N_KNOBS] scalar input (slots ``_K_*``)."""
    f32 = jnp.float32
    knob = [params.contact_prox, params.stop_padding, params.tp_padding]
    if noise is not None:
        knob += [noise.level_jitter_std, noise.entry_slip_std,
                 noise.stop_slip_std, noise.target_slip_std]
    else:
        knob += [0.0] * 4
    knob += list(gbm_consts(s0, mu, sigma, dt))
    knobs = jnp.stack([jnp.asarray(k, f32).reshape(()) for k in knob])
    return jnp.pad(knobs, (0, N_KNOBS - knobs.shape[0]))


def mc_paths_triton(seed, levels, params, *, num_paths: int, num_bars: int = 40,
                    s0=100.0, mu=0.0, sigma=0.15, dt=1.0 / (390.0 * 252.0),
                    noise=None, antithetic: bool = False, sampler: str = "gbm",
                    tile: int = TILE, interpret: bool = False,
                    external_uniforms=None) -> PathStats:
    """First-contact MC in one fused kernel; same ``PathStats`` contract as
    ``sim.pathsim.mc_paths`` (single-trade fields: ``sum_trades == n_entered``,
    ``sum_dd == n_stop``).  ``noise`` (``montecarlo.McNoise``) adds the
    reference's execution noise per path.  The random stream is the kernel's
    own (threefry keyed by ``seed``), so results agree with the XLA pipeline
    in distribution, not path by path; ``mc_paths_reference`` walks the same
    stream in plain JAX.  ``interpret=True`` runs the kernel on the CPU, for
    tests only."""
    check_args(levels, num_paths=num_paths, num_bars=num_bars, tile=tile,
               sampler=sampler)
    if antithetic and tile % 2:
        raise ValueError("antithetic pairs need an even tile")
    knobs = make_knobs(params, noise, s0=s0, mu=mu, sigma=sigma, dt=dt)
    lp, lv = _compact_levels(levels)
    u = None
    if external_uniforms is not None:
        u = jnp.asarray(external_uniforms, jnp.float32)
        want = (num_rows(num_bars, noise is not None), num_paths)
        if u.shape != want:
            raise ValueError(f"external_uniforms must be f32{list(want)}")
    return _run(seed_key(seed), knobs, jnp.asarray(lp), jnp.asarray(lv), u,
                num_paths=num_paths, num_bars=num_bars, tile=tile,
                antithetic=bool(antithetic), use_noise=noise is not None,
                interpret=bool(interpret))


@functools.partial(
    jax.jit,
    static_argnames=("num_paths", "num_bars", "block_paths", "antithetic",
                     "use_noise"))
def _reference(key, knobs, lp, lv, *, num_paths, num_bars, block_paths,
               antithetic, use_noise):
    knob = [knobs[i] for i in range(N_KNOBS)]
    levels = [(lp[i], lv[i] > 0.0) for i in range(MAX_LEVELS)]
    lane = jnp.arange(block_paths, dtype=jnp.uint32)

    def body(stats, b):
        path = b * jnp.uint32(block_paths) + lane
        entered, closed, is_tp, r = _walk(
            path, _threefry_draw2(key[0], key[1], path), knob, levels,
            num_bars=num_bars, use_noise=use_noise, antithetic=antithetic)
        outcome = jnp.where(closed, jnp.where(is_tp, OUTCOME_TP, OUTCOME_STOP),
                            OUTCOME_OPEN)
        return stats.merge(PathStats.from_outcomes(r, outcome, entered)), None

    out, _ = jax.lax.scan(body, PathStats.zero(),
                          jnp.arange(num_paths // block_paths, dtype=jnp.uint32))
    return out


def mc_paths_reference(seed, levels, params, *, num_paths: int,
                       num_bars: int = 40, s0=100.0, mu=0.0, sigma=0.15,
                       dt=1.0 / (390.0 * 252.0), noise=None,
                       antithetic: bool = False,
                       block_paths: int = 1 << 20) -> PathStats:
    """The kernel's walk in plain JAX, over the same threefry stream: the
    reference the kernel is compared with on the card.  Paths stream in
    blocks of ``block_paths``."""
    check_args(levels, num_paths=num_paths, num_bars=num_bars)
    block_paths = min(block_paths, num_paths)
    if num_paths % block_paths:
        raise ValueError("num_paths must be a multiple of block_paths")
    lp, lv = _compact_levels(levels)
    knobs = make_knobs(params, noise, s0=s0, mu=mu, sigma=sigma, dt=dt)
    return _reference(seed_key(seed), knobs, jnp.asarray(lp), jnp.asarray(lv),
                      num_paths=num_paths, num_bars=num_bars,
                      block_paths=block_paths, antithetic=bool(antithetic),
                      use_noise=noise is not None)
