"""Command-line interface — the GUI-less analog of the reference's Tk app.

Maps the reference's tabs/buttons (qmmx_monolithic.py:2335-2842) onto
subcommands:

  settings get/set/list   — the Settings tab (:2756-2842)
  levels list/set/clear   — the Levels tab (:2712-2754)
  sim                     — the "Sim last bars" button (:2650 → simulate_last_bars)
  mc                      — the "Monte Carlo" button (:2659 → simulate_monte_carlo)
  paths                   — generated-path MC at scale (north-star workload)
  sweep                   — stop/target hyperparameter grid sweep
  retrain                 — "Retrain Now" (:2791 → batch LR) + incremental policy pass
  tune                    — the auto conf-threshold nudger (dead upstream, live here)
  analyze                 — log_analyzer.py as a subcommand
  chart                   — render the candlestick/levels/trades PNG (:2391-2624)
  trades / export         — the Trades tab + CSV export (:2167-2333)
  portfolio               — the portfolio box (:3246-3303)
  live                    — the engine loop (Polygon key required, or --synthetic)
  wal                     — recover rows from a raw qmmx.db-wal (no main db
                            needed) and optionally import them into --db

Bars for sim/mc/chart come from --bars-csv (t,o,h,l,c[,v]) or --synthetic.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _connect(args):
    from ..io import db as _db

    conn = _db.db_connect(args.db)
    _db.db_init(conn)
    return conn


def _load_bars(args):
    import numpy as np

    from ..types import Bars

    if getattr(args, "bars_csv", None):
        from ..io import native

        cols = native.parse_bars_csv(args.bars_csv)  # C++ fast path w/ fallback
        n = len(cols["t"])
        dict_rows = [
            {"t": int(cols["t"][i]), "o": float(cols["o"][i]),
             "h": float(cols["h"][i]), "l": float(cols["l"][i]),
             "c": float(cols["c"][i]), "v": float(cols["v"][i])}
            for i in range(n)
        ]
        bars = Bars.from_rows(dict_rows, epoch_ms=int(cols["t"][0]) if n else 0)
        return dict_rows, bars
    # synthetic fixture
    rng = np.random.default_rng(getattr(args, "seed", 0))
    n = getattr(args, "num_bars", 240)
    s0 = getattr(args, "s0", 100.0)
    c = np.round(s0 + np.cumsum(rng.normal(0, 0.04, n)), 2)
    h = np.round(c + np.abs(rng.normal(0, 0.05, n)), 2)
    l = np.round(c - np.abs(rng.normal(0, 0.05, n)), 2)
    o = np.concatenate([[c[0]], c[:-1]])
    dict_rows = [{"t": i * 60_000, "o": float(o[i]), "h": float(h[i]),
                  "l": float(l[i]), "c": float(c[i]), "v": 0.0} for i in range(n)]
    bars = Bars.from_rows(dict_rows)
    return dict_rows, bars


def _levels_and_params(conn, args):
    from ..config import EngineParams
    from ..io import db as _db
    from ..types import Levels

    rows = _db.load_levels(conn)
    if not rows and getattr(args, "default_levels", True):
        # convenience: seed levels around the synthetic s0 when the DB is empty
        s0 = getattr(args, "s0", 100.0)
        rows = [
            {"color": "blue", "type": "solid", "index": 0, "price": s0},
            {"color": "orange", "type": "dashed", "index": 0, "price": s0 + 0.4},
            {"color": "teal", "type": "solid", "index": 0, "price": s0 - 0.3},
        ]
    levels = Levels.from_rows(rows, max_levels=64)
    params = EngineParams.from_settings(lambda k, d=None: _db.settings_get(conn, k, d))
    if getattr(args, "qmin", None) is not None:
        params = params.replace(q_min_prob=np.float32(args.qmin))
    return rows, levels, params


def cmd_settings(args):
    from ..config import SETTINGS_DEFAULTS
    from ..io import db as _db

    conn = _connect(args)
    if args.action == "list":
        for k, default in SETTINGS_DEFAULTS.items():
            print(f"{k} = {_db.settings_get(conn, k, default)}")
    elif args.action == "get":
        print(_db.settings_get(conn, args.key, SETTINGS_DEFAULTS.get(args.key)))
    elif args.action == "set":
        _db.settings_set(conn, args.key, args.value)
        print(f"{args.key} = {args.value}")
    return 0


def cmd_levels(args):
    from ..io import db as _db

    conn = _connect(args)
    if args.action == "list":
        for lv in _db.load_levels(conn):
            print(f"{lv['color']}/{lv['type']}[{lv['index']}] @ {lv['price']:.2f}")
    elif args.action == "set":
        levels = []
        for spec in args.spec:
            color, kind, idx, price = spec.split(":")
            levels.append({"color": color, "type": kind, "index": int(idx),
                           "price": float(price)})
        _db.replace_levels(conn, levels)
        print(f"replaced {len(levels)} levels")
    elif args.action == "clear":
        _db.replace_levels(conn, [])
        print("cleared")
    return 0


def cmd_sim(args):
    from ..config import EngineParams  # noqa
    from ..io import db as _db
    from ..sim import replay as RP
    from ..sim.summary import format_replay_summary

    import jax

    conn = _connect(args)
    dict_rows, bars = _load_bars(args)
    rows, levels, params = _levels_and_params(conn, args)
    sim = jax.jit(
        lambda b, lv, p: RP.simulate_last_bars(
            b, lv, p, touch_limit=args.touch_limit, with_gates=args.gates
        )
    )
    res = sim(bars, levels, params)
    s = res.summary
    msg = format_replay_summary(
        s, n=bars.num_bars,
        prox=round(float(np.asarray(params.contact_prox)), 4),
        sp=round(float(np.asarray(params.stop_padding)), 4),
        tp=round(float(np.asarray(params.tp_padding)), 4),
    )
    _db.audit(conn, "SIM", "SUMMARY", msg)
    print(msg)
    # gate-skip breadcrumbs with the reference's message text (:3595-3597 —
    # format verified against SIM/GATE_SKIP rows recovered from the WAL)
    # breadcrumbs batch into ONE transaction (the reference commits per row,
    # :157 — hundreds of fsyncs for a 200-bar sim; io/native.audit_batch cuts
    # that to one, through the C++ sqlite writer when built)
    crumbs: list[tuple] = []
    if args.gates:
        from ..io.audit import reason_message
        from ..reasons import Reason, returned_code

        reasons = np.asarray(res.candidates.gate_reason)
        confs = np.asarray(res.candidates.gate_conf)
        dists = np.asarray(res.candidates.gate_dist)
        touches = np.asarray(res.candidates.touch_no)
        qmin = float(np.asarray(params.q_min_prob))
        for i in np.where(reasons != 0)[0]:
            rsn = Reason(int(reasons[i]))
            code = returned_code(rsn)
            text = reason_message(rsn, conf=float(confs[i]), qmin=qmin,
                                  touch_count=int(touches[i]),
                                  dist=float(dists[i]))
            crumbs.append((_db.utcnow(), "SIM", f"GATE_SKIP:{code}",
                           f"{text} prox={float(dists[i]):.03f}", "{}"))
    # per-trade breadcrumbs (:3676-3681; format matches the recorded WAL rows)
    mask = np.asarray(res.candidates.is_cand)
    outs = {0: "OPEN", 1: "TP", 2: "STOP"}
    for i in np.where(mask)[0]:
        side = "long" if int(np.asarray(res.candidates.side)[i]) > 0 else "short"
        entry = float(np.asarray(res.candidates.entry)[i])
        exit_px = float(np.asarray(res.exit_price)[i])
        pnl = (exit_px - entry) * (1.0 if side == "long" else -1.0)
        line = (f"{outs[int(np.asarray(res.outcome)[i])]:5s} | {side:5s} "
                f"@ {entry:.2f} → {exit_px:.2f} "
                f"| lvl {float(np.asarray(res.candidates.level_price)[i]):.2f} "
                f"| R={float(np.asarray(res.r)[i]):+.2f} | ${pnl:+.2f} "
                f"| prox={float(np.asarray(res.candidates.gate_dist)[i]):.03f} "
                f"touch#{int(np.asarray(res.candidates.touch_no)[i])}")
        crumbs.append((_db.utcnow(), "SIM", "TRADE", line, "{}"))
        if args.verbose:
            print(line)
    if crumbs:
        from ..io import native

        native.audit_batch(args.db, crumbs)
    return 0


def cmd_mc(args):
    import jax

    from ..io import db as _db
    from ..sim import montecarlo as MC
    from ..sim.summary import format_mc_summary

    conn = _connect(args)
    dict_rows, bars = _load_bars(args)
    rows, levels, params = _levels_and_params(conn, args)
    noise = MC.McNoise.make(args.entry_slip_std, args.level_jitter_std,
                            args.stop_slip_std, args.target_slip_std)
    mc = jax.jit(
        lambda k, b, lv, p, nz: MC.simulate_monte_carlo(
            k, b, lv, p, touch_limit=args.touch_limit, trials=args.trials,
            with_gates=args.gates, noise=nz,
        )
    )
    res = mc(jax.random.key(args.seed), bars, levels, params, noise)
    msg = format_mc_summary(res.summary)
    _db.audit(conn, "MC", "SUMMARY", msg)
    print(msg)
    return 0


def _hist_paths_bars(args):
    """Recorded o/h/l/c/v history (1-D ops.pathgen.PathBars) for bootstrap
    samplers: ``--bars-csv`` if given, else the synthetic 390-bar fixture
    (the ``paths`` horizon ``--num-bars`` is NOT the history length)."""
    import types as _types

    import numpy as np

    from ..ops.pathgen import PathBars

    a = _types.SimpleNamespace(**vars(args))
    if not getattr(args, "bars_csv", None):
        a.num_bars = max(390, getattr(args, "num_bars", 0))
    dict_rows, _bars = _load_bars(a)

    def col(k):
        return np.asarray([r[k] for r in dict_rows], np.float32)

    return PathBars(open=col("o"), high=col("h"), low=col("l"),
                    close=col("c"), volume=col("v"))


def _heston_dict(args):
    return {k: float(getattr(args, f"heston_{k}"))
            for k in ("v0", "kappa", "theta", "xi", "rho")
            if hasattr(args, f"heston_{k}")}


def _kernel_reason(args, levels, sampler) -> str | None:
    """Why the fused first-contact kernel cannot run this ``paths`` call, or
    None when it can."""
    if getattr(args, "engine", False) or getattr(args, "gated", False):
        return "the fused kernel runs first-contact replay only"
    if getattr(args, "exact_tail", False):
        return "--exact-tail selects over the XLA pipeline's population"
    if getattr(args, "ckpt_dir", None):
        return "--ckpt-dir runs the resumable XLA pipeline"
    from .. import backend as B

    return B.kernel_reason(levels, num_paths=args.num_paths,
                           num_bars=args.num_bars, sampler=sampler)


def cmd_paths(args):
    import jax

    from .. import backend as B

    conn = _connect(args)
    rows, levels, params = _levels_and_params(conn, args)
    sampler = getattr(args, "sampler", "gbm")
    try:
        backend = B.resolve(args.backend,
                            kernel_reason=_kernel_reason(args, levels, sampler))
    except B.BackendError as e:
        raise SystemExit(str(e))
    if getattr(args, "exact_tail", False) and getattr(args, "ckpt_dir", None):
        raise SystemExit("--exact-tail does not run under --ckpt-dir")
    hist = (_hist_paths_bars(args)
            if sampler in ("bootstrap", "block_bootstrap") else None)
    block_len = int(getattr(args, "block_len", 10))
    heston = _heston_dict(args) if sampler == "heston" else None

    noise = None
    stds = (getattr(args, "entry_slip_std", 0.0),
            getattr(args, "level_jitter_std", 0.0),
            getattr(args, "stop_slip_std", 0.0),
            getattr(args, "target_slip_std", 0.0))
    if any(s != 0.0 for s in stds):
        from ..sim.montecarlo import McNoise

        noise = McNoise.make(*stds)
        if getattr(args, "ckpt_dir", None):
            raise SystemExit("execution noise does not run under --ckpt-dir")
    if getattr(args, "ckpt_dir", None) and not getattr(args, "engine", False):
        # fault-tolerant long run: chunked with an exactly-once block
        # watermark; re-running the same command resumes bitwise-identically
        from ..sim import resumable

        gate = None
        if getattr(args, "gated", False):
            from ..sim import gatedpath

            gate = gatedpath.GateConfig.from_params(
                params, touch_limit=args.touch_limit,
                cooldown_bars=args.cooldown_bars,
            )
        stats = resumable.run_resumable(
            jax.random.key(args.seed), levels, params,
            num_paths=args.num_paths, ckpt_dir=args.ckpt_dir,
            num_bars=args.num_bars, s0=args.s0, sigma=args.sigma,
            block_paths=min(args.num_paths, 1 << 17), gate=gate,
            sampler=sampler, hist_bars=hist, block_len=block_len,
            heston=heston,
        )
    elif getattr(args, "engine", False):
        # the FULL 12-gate engine over generated paths (sim/enginepath.py)
        from ..sim import enginepath as EPATH

        if getattr(args, "ckpt_dir", None):
            from ..sim import resumable

            stats, skips, escal = resumable.run_resumable(
                jax.random.key(args.seed), levels, params,
                num_paths=args.num_paths, ckpt_dir=args.ckpt_dir,
                num_bars=args.num_bars, s0=args.s0, sigma=args.sigma,
                block_paths=min(args.num_paths, 1 << 13), engine=True,
                sampler=sampler, hist_bars=hist, block_len=block_len,
                heston=heston,
            )
        else:
            stats, skips, escal = EPATH.mc_paths_engine(
                jax.random.key(args.seed), levels, params,
                num_paths=args.num_paths, num_bars=args.num_bars, s0=args.s0,
                sigma=args.sigma, block_paths=min(args.num_paths, 1 << 13),
                noise=noise, sampler=sampler, hist_bars=hist,
                block_len=block_len, heston=heston,
                antithetic=args.antithetic,
            )
        out = {
            "backend": backend,
            "paths": float(stats.n), "entered": float(stats.n_entered),
            "hit_rate": float(stats.hit_rate), "mean_r": float(stats.mean_r),
            "std_r": float(stats.std_r), "var_05": float(stats.quantile(0.05)),
            "cvar_05": float(stats.cvar(0.05)),
            "best_r": float(stats.max_r), "worst_r": float(stats.min_r),
            "trades": float(stats.sum_trades),
            "mean_trades": float(stats.mean_trades),
            "mean_dd": float(stats.mean_dd), "max_dd": float(stats.max_dd),
            "escalations": int(escal),
            "skips": {r.name: int(sv) for r, sv in
                      zip(EPATH.SKIP_REASONS, np.asarray(skips)) if sv},
        }
        if getattr(args, "exact_tail", False):
            from ..sim import tailexact

            tail = tailexact.exact_tail_engine(
                jax.random.key(args.seed), levels, params,
                num_paths=args.num_paths, num_bars=args.num_bars, s0=args.s0,
                sigma=args.sigma, block_paths=min(args.num_paths, 1 << 13),
                noise=noise, sampler=sampler, hist_bars=hist,
                block_len=block_len, heston=heston,
                antithetic=args.antithetic)
            out.update(_tail_fields(tail))
        print(json.dumps(out))
        return 0
    elif getattr(args, "gated", False):
        # engine-gated multi-trade lifecycle (sim/gatedpath.py)
        from ..sim import gatedpath

        gate = gatedpath.GateConfig.from_params(
            params, touch_limit=args.touch_limit,
            cooldown_bars=args.cooldown_bars,
        )
        stats = gatedpath.mc_paths_gated(
            jax.random.key(args.seed), levels, params, gate,
            num_paths=args.num_paths, num_bars=args.num_bars, s0=args.s0,
            sigma=args.sigma, block_paths=min(args.num_paths, 1 << 17),
            antithetic=args.antithetic, noise=noise,
            sampler=sampler, hist_bars=hist, block_len=block_len,
            heston=heston,
        )
    else:
        stats = B.first_contact_paths(
            backend, args.seed, levels, params,
            num_paths=args.num_paths, num_bars=args.num_bars, s0=args.s0,
            sigma=args.sigma, block_paths=1 << 17,
            antithetic=args.antithetic, noise=noise,
            sampler=sampler, hist_bars=hist, block_len=block_len,
            heston=heston,
        )
    out = {
        "backend": backend,
        "paths": float(stats.n), "entered": float(stats.n_entered),
        "hit_rate": float(stats.hit_rate), "mean_r": float(stats.mean_r),
        "std_r": float(stats.std_r), "var_05": float(stats.quantile(0.05)),
        "cvar_05": float(stats.cvar(0.05)),
        "best_r": float(stats.max_r), "worst_r": float(stats.min_r),
    }
    if getattr(args, "gated", False):
        out.update({
            "trades": float(stats.sum_trades),
            "mean_trades": float(stats.mean_trades),
            "mean_dd": float(stats.mean_dd), "max_dd": float(stats.max_dd),
        })
    if getattr(args, "exact_tail", False):
        from ..sim import tailexact

        common = dict(num_paths=args.num_paths, num_bars=args.num_bars,
                      s0=args.s0, sigma=args.sigma,
                      block_paths=min(args.num_paths, 1 << 17), noise=noise,
                      sampler=sampler, hist_bars=hist, block_len=block_len,
                      heston=heston, antithetic=args.antithetic)
        if getattr(args, "gated", False):
            tail = tailexact.exact_tail_gated(
                jax.random.key(args.seed), levels, params, gate, **common)
        else:
            tail = tailexact.exact_tail_paths(
                jax.random.key(args.seed), levels, params, **common)
        out.update(_tail_fields(tail))
    print(json.dumps(out))
    return 0


def _tail_fields(tail) -> dict:
    """EXACT tail quantiles (sim/tailexact.py) replace the histogram
    estimates in the printed row; the selection certificate rides along."""
    return {
        "var_05": tail.var, "cvar_05": tail.cvar, "tail_exact": True,
        "tail_rank": tail.k, "tail_entered": tail.n_entered,
        "tail_certificate": {"count_lt": tail.count_lt,
                             "count_le": tail.count_le,
                             "certified": tail.certified,
                             "passes": tail.passes},
    }


def cmd_wal(args):
    """Recover rows from a raw WAL file; with --import, load them into --db
    (levels replace the table; audit/policy rows append with original ts)."""
    from ..io import db as _db
    from ..io import walrecover

    rec = walrecover.recover(args.wal)
    if args.do_import:
        conn = _connect(args)
        if rec["price_levels"]:
            _db.replace_levels(conn, rec["price_levels"])
        for k, v in rec["settings"].items():
            _db.settings_set(conn, k, v)
        for row in rec["audit_log"]:
            conn.execute(
                "INSERT INTO audit_log(ts, phase, code, message, extras_json)"
                " VALUES(?,?,?,?,?)",
                (row["ts"], row["phase"], row["code"], row["message"],
                 row["extras_json"]),
            )
        for row in rec["policy_events"]:
            conn.execute(
                "INSERT INTO policy_events(ts, phase, action, features_json,"
                " label, trade_id, notes) VALUES(?,?,?,?,?,?,?)",
                (row["ts"], row["phase"], row["action"], row["features_json"],
                 row["label"], row["trade_id"], row["notes"]),
            )
        conn.commit()
    print(json.dumps({
        "pages": rec["n_pages"], "db_size_pages": rec["db_size_pages"],
        "tables": sorted(rec["schema"]),
        "price_levels": len(rec["price_levels"]),
        "audit_log": len(rec["audit_log"]),
        "policy_events": len(rec["policy_events"]),
        "settings": len(rec["settings"]),
        "imported": bool(args.do_import),
    }))
    return 0


def _sweep_engine(args, rows, levels, params):
    """(stop, tp[, level-jitter std]) grid over the FULL 12-gate engine
    lifecycle with common random numbers: per-config XLA runs sharing the
    SAME key (identical paths, exact CRN).  With ``--jitter-stds``, every row
    replays the SAME per-entry noise normals scaled by its row's level-jitter
    std — a slippage-robustness surface."""
    import itertools

    import jax
    import jax.numpy as jnp

    from ..sim import enginepath as EPATH

    jitters = getattr(args, "jitter_stds", None)
    combos = list(itertools.product(args.stops, args.tps, jitters or [None]))
    sampler = getattr(args, "sampler", "gbm")
    hist = _hist_paths_bars(args) if sampler != "gbm" else None
    block_len = int(getattr(args, "block_len", 10))
    heston = _heston_dict(args) if sampler == "heston" else None

    def mk_noise(jit_std):
        from ..sim.montecarlo import McNoise

        return McNoise(
            level_jitter_std=jnp.float32(jit_std),
            entry_slip_std=jnp.float32(args.entry_slip_std),
            stop_slip_std=jnp.float32(args.stop_slip_std),
            target_slip_std=jnp.float32(args.target_slip_std),
        )

    key = jax.random.key(args.seed)   # shared key == shared paths (CRN)
    per = [EPATH.mc_paths_engine(
        key, levels, params.replace(
            stop_padding=jnp.float32(sp), tp_padding=jnp.float32(tp)),
        num_paths=args.num_paths, num_bars=args.num_bars, s0=args.s0,
        sigma=args.sigma, block_paths=min(args.num_paths, 1 << 13),
        sampler=sampler, hist_bars=hist, block_len=block_len,
        heston=heston,
        noise=mk_noise(jit) if jit is not None else None,
    ) for sp, tp, jit in combos]
    stats = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[p[0] for p in per])
    escal = np.asarray([float(p[2]) for p in per])
    for g, (sp, tp, jit) in enumerate(combos):
        row = {
            "stop_padding": sp, "tp_padding": tp,
            "hit_rate": float(stats.hit_rate[g]),
            "mean_r": float(stats.mean_r[g]),
            "mean_trades": float(stats.mean_trades[g]),
            "mean_dd": float(stats.mean_dd[g]),
            "escalations": int(escal[g]),
            "backend": "xla",
        }
        if jit is not None:
            row["level_jitter_std"] = jit
        print(json.dumps(row))
    return 0


def cmd_sweep(args):
    import jax

    from ..parallel import sweep as PS

    conn = _connect(args)
    rows, levels, params = _levels_and_params(conn, args)
    block = min(args.num_paths, 1 << 14)
    gated = getattr(args, "gated", False)
    engine = getattr(args, "engine", False)
    touch_grid = getattr(args, "touch_limits", None)
    qmin_grid = getattr(args, "qmins", None)
    if not gated and (touch_grid or qmin_grid):
        raise SystemExit("--touch-limits/--qmins require --gated")
    if engine:
        return _sweep_engine(args, rows, levels, params)
    sampler = getattr(args, "sampler", "gbm")
    hist = (_hist_paths_bars(args)
            if sampler in ("bootstrap", "block_bootstrap") else None)
    samp_kw = dict(sampler=sampler, hist_bars=hist,
                   block_len=int(getattr(args, "block_len", 10)),
                   heston=_heston_dict(args) if sampler == "heston" else None)
    if gated:
        from ..sim.gatedpath import GateConfig

        # honor --qmin: derive the base gate from the pre-grid scalar params,
        # mirroring cmd_paths (GateConfig.default() would hardcode 0.60);
        # --touch-limits/--qmins put gate knobs on the grid axis (CRN)
        base_gate = GateConfig.from_params(params)
        grid, gate_g = PS.grid_params_gated(
            params, base_gate, stop_paddings=args.stops, tp_paddings=args.tps,
            touch_limits=touch_grid, q_min_probs=qmin_grid,
        )
        stats = PS.sweep_paths_gated(
            jax.random.key(args.seed), levels, grid, gate=gate_g,
            num_paths=args.num_paths, num_bars=args.num_bars, s0=args.s0,
            sigma=args.sigma, block_paths=block, **samp_kw,
        )
    else:
        grid = PS.grid_params(
            params, stop_paddings=args.stops, tp_paddings=args.tps)
        stats = PS.sweep_paths(
            jax.random.key(args.seed), levels, grid,
            num_paths=args.num_paths, num_bars=args.num_bars, s0=args.s0,
            sigma=args.sigma, block_paths=block, **samp_kw,
        )
    import itertools

    gate_axes = ((touch_grid or [None]), (qmin_grid or [None])) if gated \
        else ([None], [None])
    g = 0
    for sp, tp, tl, qm in itertools.product(args.stops, args.tps, *gate_axes):
        row = {
            "stop_padding": sp, "tp_padding": tp,
            "hit_rate": float(stats.hit_rate[g]),
            "mean_r": float(stats.mean_r[g]),
            "backend": "xla",
        }
        if tl is not None:
            row["touch_limit"] = tl
        if qm is not None:
            row["q_min_prob"] = qm
        if gated:
            row.update({
                "mean_trades": float(stats.mean_trades[g]),
                "mean_dd": float(stats.mean_dd[g]),
            })
        print(json.dumps(row))
        g += 1
    return 0


def cmd_book(args):
    """Correlated-universe MC with BOOK-level risk (beyond the reference,
    which holds one ticker): one-factor co-movement (beta loadings on a
    shared market factor) over the gated lifecycle, per-path portfolio
    VaR/CVaR and time-tracked portfolio drawdown.  One JSON row per symbol
    plus a final portfolio row."""
    import jax

    from ..parallel import universe as U

    def _veclist(txt, n, default):
        if txt is None:
            return np.full(n, default, np.float32)
        vals = np.asarray([float(x) for x in txt.split(",")], np.float32)
        if vals.size == 1:
            return np.full(n, float(vals[0]), np.float32)
        if vals.size != n:
            raise SystemExit(f"expected {n} comma-separated values, "
                             f"got {vals.size}")
        return vals

    conn = _connect(args)
    _rows, _lv, params = _levels_and_params(conn, args)
    n = args.num_symbols
    s0 = _veclist(args.s0s, n, args.s0)
    sigma = _veclist(args.sigmas, n, args.sigma)
    beta = _veclist(args.betas, n, args.beta)
    w = _veclist(args.weights, n, 1.0 / n)
    # synthetic per-symbol level scaffolds around each spot (the DB holds one
    # symbol's levels; a book run wants one set per symbol)
    rows = [[{"color": "blue", "type": "solid", "index": 0,
              "price": float(s0[s])},
             {"color": "orange", "type": "dashed", "index": 0,
              "price": float(s0[s]) + 0.4}] for s in range(n)]
    lv = U.stack_levels(rows, max_levels=4)
    engine = getattr(args, "engine", False)
    harvest = getattr(args, "harvest", False)
    if harvest and not engine:
        raise SystemExit("--harvest needs --engine (the label harvest rides "
                         "the full-engine ladder)")
    sampler = getattr(args, "sampler", "gbm")
    hist = None
    if sampler in ("bootstrap", "block_bootstrap"):
        import jax.numpy as jnp

        from ..ops.pathgen import PathBars

        # one joint recorded history, shared by every book member (the
        # tables are RELATIVE geometry rebased onto each symbol's own s0;
        # per-symbol CSVs would slot in as [S, H] rows here)
        h1 = _hist_paths_bars(args)
        hist = PathBars(*[jnp.broadcast_to(jnp.asarray(x, jnp.float32),
                                           (n,) + x.shape)
                          for x in h1])
    samp_kw = dict(
        sampler=sampler, hist_bars=hist,
        block_len=getattr(args, "block_len", 10),
        heston=_heston_dict(args) if sampler == "heston" else None,
        antithetic=getattr(args, "antithetic", False))
    skips = escal = hv = None
    if engine:
        from ..parallel.portfolio import portfolio_mc_engine

        out = portfolio_mc_engine(
            jax.random.key(args.seed), lv, params, s0, sigma, beta, w,
            num_paths=args.num_paths, num_bars=args.num_bars,
            block_paths=min(args.num_paths, 1 << 12), harvest=harvest,
            **samp_kw)
        sym, port, skips, escal = out[:4]
        if harvest:
            hv = out[4]
    else:
        from ..parallel.portfolio import portfolio_mc

        sym, port = portfolio_mc(
            jax.random.key(args.seed), lv, params, s0, sigma, beta, w,
            num_paths=args.num_paths, num_bars=args.num_bars,
            block_paths=min(args.num_paths, 1 << 13), **samp_kw)
    ml_refreshed = None
    if hv is not None:
        # the book-level flywheel: per-symbol LR refresh on labels harvested
        # from the CORRELATED run (ref :3833-3853 per book member)
        from ..models import harvest as HVM
        from ..parallel.universe import universe_policy_refresh

        xs, ys, ws = HVM.ml_batch_from_harvest(
            hv, stop_padding=params.stop_padding)
        ml_refreshed = universe_policy_refresh(None, xs, ys, ws)
    for s in range(n):
        row = {
            "backend": "xla",
            "symbol": s, "beta": round(float(beta[s]), 4),
            "weight": round(float(w[s]), 4),
            "hit_rate": float(sym.hit_rate[s]),
            "mean_r": float(sym.mean_r[s]),
            "mean_trades": float(sym.mean_trades[s]),
            "max_dd": float(sym.max_dd[s]),
        }
        if escal is not None:
            row["escalations"] = int(escal[s])
        if hv is not None:
            row["labeled"] = float(hv.n_labeled[s])
            row["ml_coef"] = [round(float(c), 6)
                              for c in np.asarray(ml_refreshed.coef[s])]
        print(json.dumps(row))
    prow = {
        "backend": "xla",
        "portfolio": True, "mean_r": float(port.mean_r),
        "std_r": float(port.std_r),
        "var_05": float(port.quantile(0.05)),
        "cvar_05": float(port.cvar(0.05)),
        "max_dd": float(port.max_dd), "mean_dd": float(port.mean_dd),
    }
    if getattr(args, "exact_tail", False):
        # certified selection over the XLA book pipeline's own population
        # (parallel/portfolio.exact_tail_book; ~6 extra generation passes)
        if not engine:
            raise SystemExit("book --exact-tail needs --engine (it selects "
                             "over the book engine's exact path population)")
        from ..parallel.portfolio import exact_tail_book

        tail = exact_tail_book(
            jax.random.key(args.seed), lv, params, s0, sigma, beta, w,
            num_paths=args.num_paths, num_bars=args.num_bars,
            block_paths=min(args.num_paths, 1 << 12), **samp_kw)
        prow.update(var_05=tail.var, cvar_05=tail.cvar,
                    tail_exact=tail.certified, tail_rank=tail.k,
                    tail_entered=tail.n_entered)
    print(json.dumps(prow))
    return 0


def cmd_flywheel(args):
    """simulate → label → retrain → re-simulate at path scale: each round
    runs the FULL-engine MC with the label harvest on, refreshes the
    ML gate (weighted IRLS on harvested bucket counts, ref :3833-3853) and
    the OnlinePolicy entry heads (ref :3753-3803), then re-simulates with
    the refreshed models armed.  Prints one JSON row per round."""
    import json as _json

    from ..sim import enginepath as EPATH
    from ..sim import flywheel as FW

    conn = _connect(args)
    rows, levels, params = _levels_and_params(conn, args)
    rounds = FW.policy_iteration(
        args.seed, levels, params, rounds=args.rounds,
        num_paths=args.num_paths, num_bars=args.num_bars, s0=args.s0,
        sigma=args.sigma,
        min_samples=args.min_samples,
        arm_policy_gate=args.arm_policy_gate,
        block_paths=min(args.num_paths, 1 << 13),
        explore_paths=args.explore_paths,
    )
    names = [r.name for r in EPATH.SKIP_REASONS]
    for i, rd in enumerate(rounds):
        st = rd.stats
        print(_json.dumps({
            "backend": "xla",
            "round": i,
            "labeled": rd.labeled,
            "explored": rd.explored,
            "hit_rate": round(float(st.hit_rate), 5),
            "mean_r": round(float(st.mean_r), 5),
            "trades": float(st.sum_trades),
            "escalations": rd.escalations,
            "ml_present": bool(rd.ml_model.present),
            "skips": {n: float(s) for n, s in zip(names, rd.skips)
                      if float(s) > 0},
        }))


def cmd_retrain(args):
    from ..io import checkpoint as ckpt
    from ..io import db as _db
    from ..io import trainstore
    from ..models import online_policy as OP

    conn = _connect(args)
    # incremental online-policy pass (watermarked)
    policy = OP.PolicyParams.init()
    import os

    if os.path.exists(args.policy_path):
        policy = ckpt.load_policy_npz(args.policy_path)
    policy, n, wm = trainstore.retrain_from_labeled_events(conn, policy)
    os.makedirs(os.path.dirname(args.policy_path) or ".", exist_ok=True)
    ckpt.save_policy_npz(args.policy_path, policy)
    print(f"incremental: {n} events, watermark → {wm}")

    # batch LR (the "Retrain Now" path)
    model, n_samples = trainstore.do_retrain(
        conn, min_samples=args.min_samples,
        reference_features=args.reference_features,
    )
    if model is None:
        print(f"batch LR: insufficient data ({n_samples} < {args.min_samples})")
        _db.audit(conn, "RETRAIN", "INSUFFICIENT_DATA",
                  f"Found {n_samples} samples; need at least {args.min_samples}.")
    else:
        ckpt.save_lr_model_npz(
            args.lr_model_path, np.asarray(model.coef),
            float(model.intercept),
            n_features=(3 if args.reference_features else 4),
        )
        print(f"batch LR: fit on {n_samples} samples → {args.lr_model_path}")
        _db.audit(conn, "RETRAIN", "OK", f"Retrained on {n_samples} samples.")
    return 0


def cmd_tune(args):
    from ..io import trainstore

    conn = _connect(args)
    new = trainstore.auto_tune_conf_threshold(conn)
    print(f"Q_MIN_PROB → {new}" if new is not None else "not enough labels")
    return 0


def cmd_analyze(args):
    from ..io import analyzer

    conn = _connect(args)
    print(analyzer.render_report(analyzer.analyze_policy_events(conn)))
    return 0


def cmd_chart(args):
    from ..io import chart as chart_io
    from ..io import db as _db

    conn = _connect(args)
    dict_rows, _bars = _load_bars(args)
    rows = _db.load_levels(conn)
    out = chart_io.render_chart(dict_rows, rows, path=args.out,
                                title=args.title or "")
    print(out)
    return 0


def cmd_trades(args):
    from ..io import portfolio as port

    conn = _connect(args)
    for t in port.trades_table(conn, symbol=args.symbol or "",
                               side=args.side or ""):
        r = f"{t['r']:+.2f}" if t["r"] is not None else "—"
        print(f"#{t['id']} {t['ts_open']} {t['symbol']} {t['side']} "
              f"entry={t['entry']} exit={t['exit']} pnl={t['pnl']} R={r}")
    return 0


def cmd_export(args):
    from ..io import portfolio as port

    conn = _connect(args)
    n = port.export_trades_csv(conn, args.out)
    print(f"exported {n} trades → {args.out}")
    return 0


def cmd_portfolio(args):
    from ..io import db as _db
    from ..io import portfolio as port

    conn = _connect(args)
    start = float(_db.settings_get(conn, "portfolio_start", "10000") or 10000)
    print(json.dumps(port.snapshot(conn, start)))
    return 0


def cmd_live(args):
    from ..io import feed as feed_io
    from .app import EngineHost

    if args.synthetic:
        feed = feed_io.SyntheticFeed("SYN", s0=args.s0, seed=args.seed)
    else:
        feed = feed_io.PolygonFeed(args.symbol or "SPY")
    host = EngineHost(db_path=args.db, feed=feed, symbol=args.symbol,
                      tick_sleep=0.0 if args.synthetic else 0.7)

    if args.dashboard:
        from . import dashboard

        n = dashboard.run_dashboard(
            host, max_ticks=args.max_ticks, synthetic=args.synthetic,
            refresh_every=1 if not args.synthetic else 10,
        )
        print(f"processed {n} ticks")
        print(json.dumps(host.portfolio()))
        return 0

    def on_tick(i, out):
        if not args.watch:
            return
        flags = "".join(
            c for c, v in (("O", out["opened"]), ("X", out["closed"]),
                           ("E", out["escalated"])) if v
        ) or "-"
        snap = host.portfolio(out["price"])
        print(f"[{i:5d}] px={out['price']:.2f} {out['reason']:<16s} {flags} "
              f"eq={snap['equity']:.2f} w/l={snap['wins']}/{snap['losses']}")

    n = host.run(max_ticks=args.max_ticks,
                 sleep=(lambda s: None) if args.synthetic else __import__("time").sleep,
                 on_tick=on_tick)
    print(f"processed {n} ticks")
    print(json.dumps(host.portfolio()))
    return 0


def cmd_qvoice(args):
    from ..io.qvoice import QVoice

    q = QVoice(args.db)
    if args.action == "recent":
        for rid, ts, code, text, _pj in reversed(q.fetch_recent(args.limit)):
            print(f"{rid:06d} | {ts} | {text}")
    elif args.action == "backfill":
        print(f"backfilled {q.backfill_from_audit(args.limit)} rows")
    elif args.action == "clear":
        q.clear()
        print("cleared")
    return 0


def cmd_keepalive(args):
    from . import keepalive

    n = keepalive.run(args.db, interval_s=args.interval, max_beats=args.max_beats)
    print(f"{n} heartbeats")
    return 0


def build_parser() -> argparse.ArgumentParser:
    from .. import backend as B

    p = argparse.ArgumentParser(
        prog="qmmx",
        description="QMMX Monte Carlo backtesting framework (JAX)",
    )
    p.add_argument("--db", default="qmmx.db", help="SQLite store path")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("settings")
    sp.add_argument("action", choices=["list", "get", "set"])
    sp.add_argument("key", nargs="?")
    sp.add_argument("value", nargs="?")
    sp.set_defaults(fn=cmd_settings)

    lp = sub.add_parser("levels")
    lp.add_argument("action", choices=["list", "set", "clear"])
    lp.add_argument("spec", nargs="*", help="color:type:index:price")
    lp.set_defaults(fn=cmd_levels)

    def add_bars_args(q):
        q.add_argument("--bars-csv")
        q.add_argument("--num-bars", type=int, default=240)
        q.add_argument("--s0", type=float, default=100.0)
        q.add_argument("--seed", type=int, default=0)
        q.add_argument("--qmin", type=float, default=None)

    sim = sub.add_parser("sim")
    add_bars_args(sim)
    sim.add_argument("--touch-limit", type=int, default=1)
    sim.add_argument("--gates", action="store_true")
    sim.add_argument("--verbose", action="store_true")
    sim.set_defaults(fn=cmd_sim)

    mc = sub.add_parser("mc")
    add_bars_args(mc)
    mc.add_argument("--touch-limit", type=int, default=1)
    mc.add_argument("--trials", type=int, default=500)
    mc.add_argument("--gates", action="store_true")
    mc.add_argument("--entry-slip-std", type=float, default=0.01)
    mc.add_argument("--level-jitter-std", type=float, default=0.02)
    mc.add_argument("--stop-slip-std", type=float, default=0.0)
    mc.add_argument("--target-slip-std", type=float, default=0.0)
    mc.set_defaults(fn=cmd_mc)

    pa = sub.add_parser("paths")
    pa.add_argument("--num-paths", type=int, default=1 << 20)
    pa.add_argument("--num-bars", type=int, default=40)
    pa.add_argument("--s0", type=float, default=100.0)
    pa.add_argument("--sigma", type=float, default=0.3)
    pa.add_argument("--seed", type=int, default=0)
    pa.add_argument("--antithetic", action="store_true")
    pa.add_argument("--qmin", type=float, default=None)
    pa.add_argument("--sampler",
                    choices=["gbm", "bootstrap", "block_bootstrap",
                             "heston"],
                    default="gbm",
                    help="path sampler: gbm generates; bootstrap/"
                         "block_bootstrap resample RECORDED bars "
                         "(--bars-csv, real volumes — the reference MC "
                         "walks recorded bars; block_ preserves contiguous "
                         "runs); heston adds stochastic volatility")
    pa.add_argument("--block-len", type=int, default=10,
                    help="block_bootstrap: contiguous run length")
    for k, dv in (("v0", 0.04), ("kappa", 3.0), ("theta", 0.04),
                  ("xi", 0.6), ("rho", -0.7)):
        pa.add_argument(f"--heston-{k}", type=float, default=dv,
                        help=f"heston sampler: {k} (default {dv})")
    pa.add_argument("--bars-csv", default=None,
                    help="recorded o/h/l/c/v history for bootstrap samplers "
                         "(default: synthetic 390-bar fixture)")
    pa.add_argument("--backend", choices=list(B.CHOICES), default="auto",
                    help="triton = the fused first-contact kernel on a GPU "
                         "(gbm sampler, <=8 levels, even --num-bars, "
                         "--num-paths a multiple of 256); xla = the JAX "
                         "pipelines, any platform; auto = triton where the "
                         "kernel covers the run on a GPU, else xla")
    pa.add_argument("--gated", action="store_true",
                    help="run the engine-gated multi-trade lifecycle per path "
                         "(cooldown/touch-budget/confidence gates, per-path "
                         "equity+drawdown)")
    pa.add_argument("--engine", action="store_true",
                    help="FULL 12-gate engine lifecycle (guard/veto/ML/policy"
                         "/escalation over generated paths, volume-aware)")
    pa.add_argument("--touch-limit", type=int, default=4)
    pa.add_argument("--cooldown-bars", type=int, default=0)
    # execution-noise knobs (reference MC :3453-3461), default off
    pa.add_argument("--entry-slip-std", type=float, default=0.0)
    pa.add_argument("--level-jitter-std", type=float, default=0.0)
    pa.add_argument("--stop-slip-std", type=float, default=0.0)
    pa.add_argument("--target-slip-std", type=float, default=0.0)
    pa.add_argument("--exact-tail", action="store_true",
                    help="EXACT VaR/CVaR(5%%) by distributed selection over "
                         "the path population (sim/tailexact.py): bitwise the "
                         "reference index formula, with a count certificate. "
                         "Costs ~6 extra streaming passes; XLA backend only")
    pa.add_argument("--ckpt-dir", default=None,
                    help="checkpoint dir for fault-tolerant runs: chunked "
                         "with a block watermark; re-run to resume "
                         "bitwise-identically (XLA pipeline)")
    pa.set_defaults(fn=cmd_paths)

    wal = sub.add_parser("wal")
    wal.add_argument("wal", help="path to a qmmx.db-wal file")
    wal.add_argument("--import", dest="do_import", action="store_true",
                     help="import recovered rows into --db")
    wal.set_defaults(fn=cmd_wal)

    sw = sub.add_parser("sweep")
    sw.add_argument("--num-paths", type=int, default=1 << 18)
    sw.add_argument("--num-bars", type=int, default=40)
    sw.add_argument("--s0", type=float, default=100.0)
    sw.add_argument("--sigma", type=float, default=0.3)
    sw.add_argument("--seed", type=int, default=0)
    sw.add_argument("--stops", type=float, nargs="+", default=[0.25, 0.35, 0.45])
    sw.add_argument("--tps", type=float, nargs="+", default=[0.15, 0.25, 0.35])
    sw.add_argument("--qmin", type=float, default=None)
    sw.add_argument("--gated", action="store_true",
                    help="sweep the engine-gated multi-trade lifecycle "
                         "(CRN: every config replays the same paths)")
    sw.add_argument("--touch-limits", type=int, nargs="+", default=None,
                    help="gated only: put LEVEL_OVERTOUCHED budgets on the "
                         "grid axis (cartesian with stops/tps/qmins)")
    sw.add_argument("--qmins", type=float, nargs="+", default=None,
                    help="gated only: put Q_MIN_PROB values on the grid axis")
    sw.add_argument("--engine", action="store_true",
                    help="sweep the FULL 12-gate engine lifecycle (CRN: "
                         "per-config runs over the same paths)")
    sw.add_argument("--sampler",
                    choices=["gbm", "bootstrap", "block_bootstrap"],
                    default="gbm",
                    help="bootstrap family sweeps the knob grid over "
                         "RECORDED bars (--bars-csv) with CRN — identical "
                         "resample indices/paths per row")
    sw.add_argument("--bars-csv", default=None,
                    help="recorded o/h/l/c/v history for --sampler bootstrap")
    sw.add_argument("--block-len", type=int, default=10,
                    help="block_bootstrap: contiguous run length")
    sw.add_argument("--jitter-stds", type=float, nargs="+", default=None,
                    help="engine only: put level-jitter stds on the grid axis "
                         "(cartesian with stops/tps) — every row replays the "
                         "same noise normals scaled by its std (slippage-"
                         "robustness surface)")
    sw.add_argument("--entry-slip-std", type=float, default=0.0)
    sw.add_argument("--stop-slip-std", type=float, default=0.0)
    sw.add_argument("--target-slip-std", type=float, default=0.0)
    sw.set_defaults(fn=cmd_sweep)

    bk = sub.add_parser("book", help="correlated-universe MC with "
                        "book-level VaR/CVaR/drawdown (one-factor beta "
                        "co-movement over the gated lifecycle)")
    bk.add_argument("--num-symbols", type=int, default=8)
    bk.add_argument("--num-paths", type=int, default=1 << 16,
                    help="paths per symbol")
    bk.add_argument("--num-bars", type=int, default=40)
    bk.add_argument("--s0", type=float, default=100.0)
    bk.add_argument("--sigma", type=float, default=0.3)
    bk.add_argument("--beta", type=float, default=0.6,
                    help="shared market loading (or --betas per symbol)")
    bk.add_argument("--s0s", type=str, default=None,
                    help="comma-separated per-symbol spots")
    bk.add_argument("--sigmas", type=str, default=None)
    bk.add_argument("--betas", type=str, default=None)
    bk.add_argument("--weights", type=str, default=None,
                    help="comma-separated book weights (default equal)")
    bk.add_argument("--seed", type=int, default=0)
    bk.add_argument("--qmin", type=float, default=None)
    bk.add_argument("--engine", action="store_true",
                    help="run the FULL 12-gate engine ladder per symbol "
                    "(guard/touch/fatigue/breakout/veto/ML/policy/"
                    "escalation) instead of the gated subset")
    bk.add_argument("--exact-tail", action="store_true",
                    help="with --engine: EXACT certified "
                         "portfolio VaR/CVaR by distributed selection over "
                         "the book pipeline's per-path totals "
                         "(parallel/portfolio.exact_tail_book)")
    bk.add_argument("--harvest", action="store_true",
                    help="with --engine: harvest per-symbol trade labels "
                    "from the correlated run and refresh each symbol's ML "
                    "gate (the learning flywheel at book level; adds "
                    "labeled/ml_coef to each symbol row)")
    bk.add_argument("--sampler",
                    choices=["gbm", "bootstrap", "block_bootstrap",
                             "heston"],
                    default="gbm",
                    help="bootstrap family replays JOINT recorded days "
                         "(shared resample indices — the book co-moves "
                         "exactly as the joint history did; --bars-csv, "
                         "real volumes); heston correlates price AND vol "
                         "shocks through beta (gated and --engine ladders)")
    bk.add_argument("--bars-csv", default=None,
                    help="recorded o/h/l/c/v history for bootstrap samplers "
                         "(shared geometry, rebased per symbol)")
    bk.add_argument("--block-len", type=int, default=10,
                    help="block_bootstrap: contiguous run length")
    bk.add_argument("--antithetic", action="store_true",
                    help="antithetic book pairs: market AND idio shocks "
                         "sign-flipped per pair (gbm only)")
    for k, dv in (("v0", 0.04), ("kappa", 3.0), ("theta", 0.04),
                  ("xi", 0.6), ("rho", -0.7)):
        bk.add_argument(f"--heston-{k}", type=float, default=dv,
                        help=f"heston sampler: {k} (default {dv})")
    bk.set_defaults(fn=cmd_book)

    fw = sub.add_parser("flywheel", help="simulate->label->retrain->"
                        "re-simulate policy iteration at path scale")
    fw.add_argument("--rounds", type=int, default=2)
    fw.add_argument("--num-paths", type=int, default=1 << 16)
    fw.add_argument("--num-bars", type=int, default=40)
    fw.add_argument("--s0", type=float, default=100.0)
    fw.add_argument("--sigma", type=float, default=0.3)
    fw.add_argument("--seed", type=int, default=0)
    fw.add_argument("--qmin", type=float, default=None)
    fw.add_argument("--min-samples", type=int, default=50,
                    help="retrain gate (>=50 labeled trades, ref :3838)")
    fw.add_argument("--explore-paths", type=int, default=0,
                    help="per armed round, ALSO harvest this many gates-off "
                         "exploration paths and merge them before the model "
                         "refresh (fixes pure on-policy retraining's "
                         "survivorship collapse)")
    fw.add_argument("--arm-policy-gate", action="store_true",
                    help="also arm the refreshed OnlinePolicy two-head gate "
                         "(chosen >= 0.60 vetoes everything when the win "
                         "rate is below 60%% -- the reference's "
                         "DISABLE_POLICY_GATE posture is the default)")
    fw.set_defaults(fn=cmd_flywheel)

    rt = sub.add_parser("retrain")
    rt.add_argument("--policy-path", default="models/online_policy.npz")
    rt.add_argument("--lr-model-path", default="models/qmmx_lr.npz")
    rt.add_argument("--min-samples", type=int, default=50)
    rt.add_argument("--reference-features", action="store_true",
                    help="reproduce the reference's skewed 3-feature LR (quirk Q5)")
    rt.set_defaults(fn=cmd_retrain)

    tn = sub.add_parser("tune")
    tn.set_defaults(fn=cmd_tune)

    an = sub.add_parser("analyze")
    an.set_defaults(fn=cmd_analyze)

    ch = sub.add_parser("chart")
    add_bars_args(ch)
    ch.add_argument("--out", default="chart.png")
    ch.add_argument("--title", default="")
    ch.set_defaults(fn=cmd_chart)

    tr = sub.add_parser("trades")
    tr.add_argument("--symbol", default="")
    tr.add_argument("--side", default="")
    tr.set_defaults(fn=cmd_trades)

    ex = sub.add_parser("export")
    ex.add_argument("--out", default="trades.csv")
    ex.set_defaults(fn=cmd_export)

    po = sub.add_parser("portfolio")
    po.set_defaults(fn=cmd_portfolio)

    lv = sub.add_parser("live")
    lv.add_argument("--symbol", default=None)
    lv.add_argument("--synthetic", action="store_true")
    lv.add_argument("--s0", type=float, default=100.0)
    lv.add_argument("--seed", type=int, default=0)
    lv.add_argument("--max-ticks", type=int, default=None)
    lv.add_argument("--watch", action="store_true",
                    help="print a per-tick status line (price, reason, equity)")
    lv.add_argument("--dashboard", action="store_true",
                    help="live rich TUI: chart + levels + position + portfolio "
                         "+ QVoice stream (the Tk app's window, in a terminal)")
    lv.set_defaults(fn=cmd_live)

    qv = sub.add_parser("qvoice")
    qv.add_argument("action", choices=["recent", "backfill", "clear"])
    qv.add_argument("--limit", type=int, default=200)
    qv.set_defaults(fn=cmd_qvoice)

    ka = sub.add_parser("keepalive")
    ka.add_argument("--interval", type=float, default=300.0)
    ka.add_argument("--max-beats", type=int, default=None)
    ka.set_defaults(fn=cmd_keepalive)

    return p


def main(argv=None) -> int:
    from ..backend import setup_compile_cache

    setup_compile_cache()
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
