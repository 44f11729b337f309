#!/usr/bin/env python3
"""Smoke test of the backtesting engine on an NVIDIA GPU.

Drives the main path once through the CLI's own entry point (``host/cli.main``)
at the sizes of the README's quick start, and checks each phase against the
same jitted library function run on the CPU of the same process:

1. reference Monte Carlo: ``mc --gates --trials 500`` over 120 one-minute bars;
2. first-contact paths: ``paths --num-paths 16777216`` (the fused Triton
   kernel); the compiled kernel against its walk in plain JAX over the same
   random stream (``triton_paths.mc_paths_reference``, 2^23 paths on the card
   and 2^13 on the CPU), and against the XLA pipeline at 2^28 paths;
3. the full 12-gate engine: ``paths --engine`` with the gbm and the bootstrap
   sampler, then ``--exact-tail``;
4. the book engine with label harvest: ``book --engine --harvest``;
5. the flywheel: ``flywheel --rounds 2`` (IRLS refresh on the card);
6. precision: ML-gate and policy decisions within 1e-4 of their thresholds,
   and the IRLS fit, against float64 NumPy.

How results are compared (the tolerances and why):

* the same inputs through the same decision code (bars made once, copied to
  both devices): every count, skip table, escalation and harvested label
  count must be equal, in every phase that runs the engine;
* whole pipelines, which also generate their paths: the card's exp/log/sin
  differ from the CPU's in the last bit, which moves a close across a level
  or a barrier for about 1 path in 10^3 to 10^4.  Counts may differ by the
  phase's ``BUDGET`` of decisions, float sums by that many times the largest
  |R| plus 1e-5 per path (summation order);
* counts are compared only below 2^24, where float32 sums of them are exact.

``--cards 4`` runs only the multi-card path instead: ``sharded_mc_paths``
(first contact and ``engine=True``) and ``sharded_universe`` on a flat 1-D
mesh of four GPUs against the same key and path count on a one-GPU mesh
(counts equal, ``sum_r`` within rtol 1e-5), and against the plain one-device
pipeline (within ``BUDGET["mesh"]``).

Everything runs in one process.  It exits non-zero, and prints no result,
when JAX finds no GPU or a phase fails.  Its last line is one JSON object:
``{"ok": true, "device": {"platform", "kind", "count"}}``.

    python chip_smoke.py [--cards 1|4] [--seed N]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
README_PATHS = 1 << 24       # the quick start's --num-paths (16777216)
KERNEL_VS_XLA_PATHS = 1 << 28
REFERENCE_PATHS = 1 << 23    # kernel vs its plain-JAX walk on the card
CPU_PATHS = 1 << 13          # sub-population re-run on the CPU
MESH_PATHS = 1 << 23         # --cards 4: total paths of the first-contact run
R_SCALE = 8.0                # bound on |R| per path in the lifecycle histograms


class SmokeFailure(AssertionError):
    """A phase's result is wrong."""


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of each card, or why not."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return "; ".join(line.strip() for line in out.stdout.splitlines()) or \
        f"nvidia-smi failed: {out.stderr.strip()}"


# Decisions a whole-pipeline comparison may differ by: about four times the
# largest difference seen on an H100 at seed 0, and at least 4 (the reference
# MC, 500 trials, saw none and is held to 2).
BUDGET = {"mc": 2, "kernel": 8, "first contact": 16, "engine": 40, "tail": 4,
          "book": 4, "flywheel": 8, "mesh": 4}
LIFECYCLE_COUNTS = ("trades", "wins", "losses", "escalations", "open_at_end",
                    "skip_counts")


def count_diffs(got, want) -> float:
    """Largest absolute difference over the integer-valued leaves of two
    results (counts, histograms, skip tables); equal infinities count as 0."""
    import jax

    worst = 0.0
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        g = np.asarray(g, np.float64)
        w = np.asarray(w, np.float64)
        if g.shape != w.shape:
            raise SmokeFailure(f"shape {g.shape} != {w.shape}")
        if np.all(g == np.round(g)) and np.all(w == np.round(w)):
            with np.errstate(invalid="ignore"):
                d = np.where(g == w, 0.0, np.abs(g - w))
            worst = max(worst, float(np.max(d, initial=0.0)))
    return worst


def check(label: str, ok: bool, detail: str) -> None:
    print(f"  {'ok  ' if ok else 'FAIL'} {label}: {detail}", flush=True)
    if not ok:
        raise SmokeFailure(f"{label}: {detail}")


def compare_stats(label, got, want, *, n_paths, budget, r_scale=R_SCALE):
    """PathStats results (or tuples led by one): counts within ``budget``
    decisions, float sums within ``budget * r_scale`` plus 1e-5 per path."""
    if n_paths >= 1 << 24:
        raise ValueError("counts are compared exactly only below 2^24 paths")
    diff = count_diffs(got, want)
    check(f"{label} counts", diff <= budget,
          f"largest count difference {diff:g} (allowed {budget})")
    if isinstance(got, tuple):            # (stats, skips, escalations, ...)
        got, want = got[0], want[0]
    for fld in ("sum_r", "sum_r2"):
        g = np.asarray(getattr(got, fld), np.float64)
        w = np.asarray(getattr(want, fld), np.float64)
        tol = budget * r_scale * (r_scale if fld == "sum_r2" else 1.0) \
            + 1e-5 * n_paths * (r_scale if fld == "sum_r2" else 1.0)
        err = float(np.max(np.abs(g - w)))
        check(f"{label} {fld}", err <= tol, f"|diff| {err:.6g} (allowed {tol:.6g})")


def on(device, fn):
    """Run ``fn()`` with ``device`` as the default device; results on host."""
    import jax

    with jax.default_device(device):
        return jax.device_get(fn())


def replay_on_both(label, ctx, fn, *args):
    """``fn(*args)``, an engine replay over inputs made once, on the card and
    on the CPU: every count, skip table, escalation and harvested label count
    must be equal.  Returns the card's result."""
    import jax

    rep = jax.jit(fn)
    g = on(ctx.gpu, lambda: rep(*args))
    c = on(ctx.cpu, lambda: rep(*args))
    pairs = [(f, getattr(g, f), getattr(c, f)) for f in LIFECYCLE_COUNTS]
    if g.harvest is not None:
        pairs += [(f"harvest {f}", getattr(g.harvest, f), getattr(c.harvest, f))
                  for f in ("ml_counts", "pol_counts")]
    differ = {f: int(np.sum(np.asarray(a) != np.asarray(b))) for f, a, b in pairs}
    check(label, not any(differ.values()), f"differing entries {differ}")
    return g


def memory(jitted, *args, **kw) -> str:
    """``compiled.memory_analysis()`` of a jitted step, in MiB."""
    m = jitted.lower(*args, **kw).compile().memory_analysis()
    if m is None:
        return "memory analysis unavailable"
    mib = 1 << 20
    return (f"arguments {m.argument_size_in_bytes / mib:.1f} MiB, outputs "
            f"{m.output_size_in_bytes / mib:.1f} MiB, temporaries "
            f"{m.temp_size_in_bytes / mib:.1f} MiB, code "
            f"{m.generated_code_size_in_bytes / mib:.2f} MiB")


def run_cli(argv):
    """``host/cli.main(argv)``; returns (seconds, printed JSON rows or text)."""
    from qmmx_monolithic_monte_carlo_tpu.host import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    dt = time.perf_counter() - t0
    if rc not in (0, None):
        raise SmokeFailure(f"cli {' '.join(argv)} returned {rc}")
    rows = []
    for line in buf.getvalue().splitlines():
        try:
            rows.append(json.loads(line))
        except json.JSONDecodeError:
            rows.append(line)
    return dt, rows


def report(phase, argv, seconds, paths, mem):
    rate = f", {paths / seconds:.6g} paths/s" if paths else ""
    print(f"[{phase}] {' '.join(argv)}: {seconds:.3f} s wall (compile "
          f"included){rate}; main step: {mem}", flush=True)


def finite_row(label, row, keys):
    bad = [k for k in keys if not math.isfinite(float(row[k]))]
    check(f"{label} output", not bad, f"finite {keys}" if not bad else f"not finite: {bad}")


class Context:
    def __init__(self, seed, db):
        import jax

        from qmmx_monolithic_monte_carlo_tpu.config import EngineParams
        from qmmx_monolithic_monte_carlo_tpu.types import Levels

        self.seed = seed
        self.db = db
        self.gpu = jax.devices()[0]
        self.cpu = jax.devices("cpu")[0]
        self.params = EngineParams.default()
        # the CLI's default scaffold for an empty level table
        self.rows = [
            {"color": "blue", "type": "solid", "index": 0, "price": 100.0},
            {"color": "orange", "type": "dashed", "index": 0, "price": 100.4},
            {"color": "teal", "type": "solid", "index": 0, "price": 99.7},
        ]
        self.levels = Levels.from_rows(self.rows, max_levels=64)

    def cli(self, *argv):
        return ["--db", self.db] + [str(a) for a in argv]


# ---------------------------------------------------------------- phases


def phase_mc(ctx):
    import jax

    from qmmx_monolithic_monte_carlo_tpu.host import cli
    from qmmx_monolithic_monte_carlo_tpu.sim import montecarlo as MC

    argv = ctx.cli("mc", "--gates", "--trials", 500, "--num-bars", 120,
                   "--seed", ctx.seed)
    dt, rows = run_cli(argv)
    args = cli.build_parser().parse_args(argv)
    _, bars = cli._load_bars(args)
    _, levels, params = cli._levels_and_params(cli._connect(args), args)
    noise = MC.McNoise.make(args.entry_slip_std, args.level_jitter_std,
                            args.stop_slip_std, args.target_slip_std)
    fn = jax.jit(lambda k, b, lv, p, nz: MC.simulate_monte_carlo(
        k, b, lv, p, touch_limit=1, trials=500, with_gates=True, noise=nz))
    report("mc", argv[2:], dt, 0, memory(fn, jax.random.key(ctx.seed), bars,
                                         levels, params, noise))
    print(f"  summary: {' | '.join(str(r) for r in rows)}")
    run = lambda: fn(jax.random.key(ctx.seed), bars, levels, params, noise)  # noqa: E731
    g, c = on(ctx.gpu, run), on(ctx.cpu, run)
    n_trades = int(np.sum(g.wins) + np.sum(g.losses))
    check("mc trades", n_trades > 0, f"{n_trades} closed trades over 500 trials")
    for fld in ("wins", "losses", "opens"):
        differ = int(np.sum(np.asarray(getattr(g, fld)) != np.asarray(getattr(c, fld))))
        check(f"mc {fld} per trial vs cpu", differ <= BUDGET["mc"],
              f"{differ} of 500 trials differ (allowed {BUDGET['mc']})")
    err = float(np.max(np.abs(np.asarray(g.totals) - np.asarray(c.totals))))
    check("mc totals vs cpu", err <= 1e-3 + BUDGET["mc"] * R_SCALE,
          f"max |diff| {err:.3g} R")


def _replay_inputs(ctx, sampler, n, w, hist=None):
    """Bars, tie coins made once on the card and copied to the host."""
    import jax

    from qmmx_monolithic_monte_carlo_tpu.sim import pathsim

    def make():
        key = jax.random.key(ctx.seed + 17)
        bars = pathsim.sample_block(
            key, block_paths=n, num_bars=w, s0=100.0, mu=0.0, sigma=0.3,
            dt=1.0 / (390.0 * 252.0), sampler=sampler, hist_bars=hist,
            antithetic=False)
        tie = jax.random.uniform(jax.random.key(ctx.seed + 18), (n, w))
        return bars, tie

    return on(ctx.gpu, jax.jit(make))


def phase_paths(ctx):
    import jax

    from qmmx_monolithic_monte_carlo_tpu import backend as B
    from qmmx_monolithic_monte_carlo_tpu.ops import triton_paths as TP
    from qmmx_monolithic_monte_carlo_tpu.sim import montecarlo as MC
    from qmmx_monolithic_monte_carlo_tpu.sim import pathsim
    from qmmx_monolithic_monte_carlo_tpu.types import Levels

    argv = ctx.cli("paths", "--num-paths", README_PATHS, "--seed", ctx.seed)
    dt, rows = run_cli(argv)
    row = rows[-1]
    lp, lv = TP._compact_levels(ctx.levels)
    mem = memory(TP._run, TP.seed_key(ctx.seed), TP.make_knobs(ctx.params, sigma=0.3),
                 lp, lv, None, num_paths=README_PATHS, num_bars=40, tile=TP.TILE,
                 antithetic=False, use_noise=False, interpret=False)
    report("paths", argv[2:], dt, README_PATHS, mem)
    print(f"  {json.dumps(row)}")
    check("paths backend", row["backend"] == "triton", f"auto picked {row['backend']}")
    finite_row("paths", row, ["hit_rate", "mean_r", "std_r", "var_05", "cvar_05"])
    check("paths count", row["paths"] == README_PATHS, f"{row['paths']} paths")

    # the compiled kernel vs its walk in plain JAX over the same threefry
    # stream: on the card at a real width, and on the CPU for a sub-population
    noise = MC.McNoise.make(0.01, 0.02, 0.005, 0.005)
    for n, ref_dev in ((REFERENCE_PATHS, ctx.gpu), (CPU_PATHS, ctx.cpu)):
        for nz in (None, noise):
            kw = dict(num_paths=n, num_bars=40, sigma=0.3, noise=nz)
            g = on(ctx.gpu, lambda: TP.mc_paths_triton(ctx.seed, ctx.levels,  # noqa: B023
                                                       ctx.params, **kw))
            r = on(ref_dev, lambda: TP.mc_paths_reference(ctx.seed, ctx.levels,  # noqa: B023
                                                          ctx.params, **kw))
            compare_stats(f"triton kernel vs plain reference on {ref_dev.platform}, "
                          f"{n} paths{', noise' if nz else ''}", g, r, n_paths=n,
                          budget=BUDGET["kernel"], r_scale=2.5)
    # the XLA pipeline, card vs CPU
    kx = dict(num_paths=CPU_PATHS, num_bars=40, sigma=0.3, block_paths=min(CPU_PATHS, 1 << 12))
    run = lambda: pathsim.mc_paths(jax.random.key(ctx.seed), ctx.levels, ctx.params, **kx)  # noqa: E731
    compare_stats("xla mc_paths vs cpu", on(ctx.gpu, run), on(ctx.cpu, run),
                  n_paths=CPU_PATHS, budget=BUDGET["first contact"], r_scale=2.5)
    # the replay decisions on identical bars
    bars, tie = _replay_inputs(ctx, "gbm", CPU_PATHS, 40)
    rep = jax.jit(lambda b, t: pathsim.path_replay(b, ctx.levels, ctx.params, t[:, 0]))
    g = on(ctx.gpu, lambda: rep(bars, tie))
    c = on(ctx.cpu, lambda: rep(bars, tie))
    differ = int(np.sum(g[1] != c[1]) + np.sum(g[2] != c[2]))
    check("path_replay on identical bars", differ == 0,
          f"{differ} of {CPU_PATHS} outcomes differ")

    # the kernel against the XLA pipeline at 2^28 x 40 bars, on bench.py's
    # two levels (the CLI's 64 level slots cost the XLA pipeline more)
    n = KERNEL_VS_XLA_PATHS
    two = Levels.from_rows(ctx.rows[:2], max_levels=8)
    times = {}
    res = {}
    for name in ("xla", "triton", "triton", "xla"):
        fn = lambda s: B.first_contact_paths(  # noqa: E731
            name, s, two, ctx.params, num_paths=n, num_bars=40, s0=100.0,  # noqa: B023
            sigma=0.3, block_paths=1 << 20)
        float(fn(0).sum_r)
        t0 = time.perf_counter()
        st = fn(ctx.seed + 1)
        float(st.sum_r)
        times.setdefault(name, []).append(time.perf_counter() - t0)
        res[name] = st
    for name, ts in times.items():
        print(f"  2^28 x 40 bars, {name}: {min(ts):.4f} s "
              f"({n / min(ts):.6g} paths/s); runs {[round(t, 4) for t in ts]}")
    a, b = res["triton"], res["xla"]
    for fld in ("n_entered", "hit_rate", "mean_r"):
        va, vb = float(np.asarray(getattr(a, fld))), float(np.asarray(getattr(b, fld)))
        print(f"  {fld}: triton {va:.8g} xla {vb:.8g}")
    p_ent = float(b.n_entered) / n
    se = math.sqrt(p_ent * (1 - p_ent) / n)
    check("kernel vs xla entered share",
          abs(float(a.n_entered) - float(b.n_entered)) / n <= 6 * se + 1e-7,
          f"{float(a.n_entered) / n:.7f} vs {p_ent:.7f} (6 SE = {6 * se:.2g})")
    se_r = float(b.std_r) / math.sqrt(float(b.n_entered))
    check("kernel vs xla mean R",
          abs(float(a.mean_r) - float(b.mean_r)) <= 6 * se_r,
          f"{float(a.mean_r):.6f} vs {float(b.mean_r):.6f} (6 SE = {6 * se_r:.2g})")


def _hist_for(ctx):
    from qmmx_monolithic_monte_carlo_tpu.host import cli

    args = cli.build_parser().parse_args(ctx.cli("paths", "--sampler", "bootstrap"))
    return cli._hist_paths_bars(args)


def phase_engine(ctx):
    import jax

    from qmmx_monolithic_monte_carlo_tpu.sim import enginepath as EP
    from qmmx_monolithic_monte_carlo_tpu.sim.pathsim import PathStats

    hist = _hist_for(ctx)
    for sampler in ("gbm", "bootstrap"):
        argv = ctx.cli("paths", "--engine", "--num-paths", README_PATHS,
                       "--sampler", sampler, "--seed", ctx.seed)
        dt, rows = run_cli(argv)
        row = rows[-1]
        h = hist if sampler == "bootstrap" else None
        mem = memory(EP._mc_paths_engine_jit, jax.random.key(ctx.seed), ctx.levels,
                     ctx.params, num_paths=README_PATHS, num_bars=40, s0=100.0,
                     sigma=0.3, block_paths=1 << 13, sampler=sampler, hist_bars=h)
        report(f"engine {sampler}", argv[2:], dt, README_PATHS, mem)
        print(f"  {json.dumps(row)}")
        finite_row(f"engine {sampler}", row, ["hit_rate", "mean_r", "var_05", "cvar_05"])
        check(f"engine {sampler} trades", row["trades"] > 0, f"{row['trades']} trades")

        kw = dict(num_paths=CPU_PATHS, num_bars=40, sigma=0.3,
                  block_paths=min(CPU_PATHS, 1 << 12), sampler=sampler,
                  hist_bars=h)
        run = lambda: EP.mc_paths_engine(jax.random.key(ctx.seed), ctx.levels,  # noqa: E731
                                         ctx.params, **kw)
        g, c = on(ctx.gpu, run), on(ctx.cpu, run)
        compare_stats(f"engine {sampler} vs cpu", g, c, n_paths=CPU_PATHS,
                      budget=BUDGET["engine"])

        bars, tie = _replay_inputs(ctx, sampler, CPU_PATHS // 2, 40, h)
        g = replay_on_both(
            f"engine_path_replay ({sampler}) on identical bars", ctx,
            lambda b, t: EP.engine_path_replay(b, ctx.levels, ctx.params, t),
            bars, tie)
        gs = PathStats.from_lifecycle(equity=g.equity, trades=g.trades, wins=g.wins,
                                      losses=g.losses, open_at_end=g.open_at_end,
                                      max_dd=g.max_dd)
        check(f"engine {sampler} replay trades", float(gs.sum_trades) > 0,
              f"{float(gs.sum_trades):.0f} trades over {CPU_PATHS // 2} paths")

    argv = ctx.cli("paths", "--engine", "--exact-tail", "--num-paths", README_PATHS,
                   "--seed", ctx.seed)
    dt, rows = run_cli(argv)
    row = rows[-1]
    report("engine exact tail", argv[2:], dt, README_PATHS, "as engine gbm, plus "
           "the selection passes")
    print(f"  {json.dumps(row)}")
    check("exact tail certificate", row["tail_certificate"]["certified"],
          json.dumps(row["tail_certificate"]))
    from qmmx_monolithic_monte_carlo_tpu.sim import tailexact

    kw = dict(num_paths=CPU_PATHS, num_bars=40, sigma=0.3, block_paths=min(CPU_PATHS, 1 << 12))
    run = lambda: tailexact.exact_tail_engine(jax.random.key(ctx.seed),  # noqa: E731
                                              ctx.levels, ctx.params, **kw)
    g, c = on(ctx.gpu, run), on(ctx.cpu, run)
    check("exact tail vs cpu certified", g.certified and c.certified,
          f"gpu k={g.k} cpu k={c.k}")
    b = BUDGET["tail"]
    check("exact tail vs cpu entered", abs(g.n_entered - c.n_entered) <= b,
          f"{g.n_entered} vs {c.n_entered}")
    # a flipped path moves the k-th order statistic at most to a neighbour
    check("exact tail vs cpu VaR", abs(g.var - c.var) <= 0.05,
          f"VaR {g.var:.6f} vs {c.var:.6f}, CVaR {g.cvar:.6f} vs {c.cvar:.6f}")


def phase_book(ctx):
    import jax

    from qmmx_monolithic_monte_carlo_tpu.host import cli
    from qmmx_monolithic_monte_carlo_tpu.parallel import portfolio as PF
    from qmmx_monolithic_monte_carlo_tpu.parallel import universe as U
    from qmmx_monolithic_monte_carlo_tpu.sim import enginepath as EP

    argv = ctx.cli("book", "--engine", "--harvest", "--seed", ctx.seed)
    dt, rows = run_cli(argv)
    args = cli.build_parser().parse_args(argv)
    n_sym = args.num_symbols
    s0 = np.full(n_sym, args.s0, np.float32)
    sig = np.full(n_sym, args.sigma, np.float32)
    beta = np.full(n_sym, args.beta, np.float32)
    wts = np.full(n_sym, 1.0 / n_sym, np.float32)
    lv = U.stack_levels([[{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
                          {"color": "orange", "type": "dashed", "index": 0,
                           "price": 100.4}]] * n_sym, max_levels=4)
    mem = memory(PF._portfolio_mc_engine_impl, jax.random.key(ctx.seed), lv,
                 ctx.params, s0, sig, beta, wts, None, PF._heston_vec(None),
                 num_paths=args.num_paths, num_bars=args.num_bars,
                 dt=1.0 / (390.0 * 252.0), mu=0.0,
                 block_paths=min(args.num_paths, 1 << 12), policy=None,
                 ml_model=None, touch_params=None, guard_params=None,
                 policy_gate_disabled=None, escalation=True, bar0_minute=0,
                 volume_model=None, harvest=True, sampler="gbm", block_len=0)
    report("book", argv[2:], dt, n_sym * args.num_paths, mem)
    for r in rows:
        print(f"  {json.dumps(r)}")
    port = rows[-1]
    finite_row("book portfolio", port, ["mean_r", "std_r", "var_05", "cvar_05", "max_dd"])
    check("book harvest", all(r.get("labeled", 0) > 0 for r in rows[:-1]),
          "every symbol harvested labels")

    n = CPU_PATHS // 4
    run = lambda: PF.portfolio_mc_engine(  # noqa: E731
        jax.random.key(ctx.seed), lv, ctx.params, s0, sig, beta, wts,
        num_paths=n, num_bars=40, block_paths=n, harvest=True)
    g, c = on(ctx.gpu, run), on(ctx.cpu, run)
    budget = BUDGET["book"]
    for i, name in enumerate(("symbols", "portfolio")):
        compare_stats(f"book {name} vs cpu", g[i], c[i], n_paths=n * n_sym,
                      budget=budget)
    diff = count_diffs(g[2:], c[2:])
    check("book skips, escalations, harvest vs cpu", diff <= budget,
          f"largest difference {diff:g} (allowed {budget})")

    # each symbol's engine with harvest on bars made once
    bars, tie = _replay_inputs(ctx, "gbm", n * n_sym, 40)
    bars, tie = jax.tree_util.tree_map(
        lambda x: x.reshape((n_sym, n) + x.shape[1:]), (bars, tie))
    g = replay_on_both(
        "book engine with harvest on identical bars, per symbol", ctx,
        jax.vmap(lambda b, t, lvs: EP.engine_path_replay(
            b, lvs, ctx.params, t, harvest=True)),
        bars, tie, jax.device_get(lv))
    labels = np.asarray(g.harvest.ml_counts).sum(axis=(1, 2))
    check("book replay harvest", bool(np.all(labels > 0)),
          f"labels per symbol {labels.tolist()}")


def phase_flywheel(ctx):
    import jax

    from qmmx_monolithic_monte_carlo_tpu.models import harvest as HV
    from qmmx_monolithic_monte_carlo_tpu.sim import enginepath as EP
    from qmmx_monolithic_monte_carlo_tpu.sim import flywheel as FW

    argv = ctx.cli("flywheel", "--rounds", 2, "--seed", ctx.seed)
    dt, rows = run_cli(argv)
    report("flywheel", argv[2:], dt, 2 * (1 << 16), "two engine rounds with "
           "harvest, see the engine phase")
    for r in rows:
        print(f"  {json.dumps(r)}")
    check("flywheel rounds", len(rows) == 2 and rows[0]["labeled"] > 0,
          f"{len(rows)} rounds, {rows[0]['labeled']} labels in round 0")
    check("flywheel refresh armed the ML gate", rows[1]["ml_present"], "round 1 ran armed")

    kw = dict(rounds=2, num_paths=CPU_PATHS, num_bars=40, sigma=0.3,
              block_paths=min(CPU_PATHS, 1 << 12))
    run = lambda: [(r.labeled, np.asarray(r.ml_model.coef), r.escalations)  # noqa: E731
                   for r in FW.policy_iteration(ctx.seed, ctx.levels, ctx.params, **kw)]
    g, c = on(ctx.gpu, run), on(ctx.cpu, run)
    b = BUDGET["flywheel"]
    for i, ((gl, gc, ge), (cl, cc, ce)) in enumerate(zip(g, c)):
        check(f"flywheel round {i} labels and escalations vs cpu",
              abs(gl - cl) <= b and abs(ge - ce) <= b,
              f"labels {gl:.0f} vs {cl:.0f}; escalations {ge:.0f} vs {ce:.0f}")
        err = float(np.max(np.abs(gc - cc)))
        check(f"flywheel round {i} ML coefficients vs cpu", err <= 0.01,
              f"max |diff| {err:.3g} ({gc.round(4).tolist()})")

    # the loop on bars made once: round 0 harvests with the gates off, the
    # refresh fits the ML gate on the card and on the CPU from that harvest,
    # round 1 replays the same bars with the card's model armed
    bars, tie = _replay_inputs(ctx, "gbm", CPU_PATHS // 2, 40)
    replay = lambda b, t, m: EP.engine_path_replay(  # noqa: E731
        b, ctx.levels, ctx.params, t, ml_model=m, harvest=True)
    g0 = replay_on_both("flywheel round 0 on identical bars", ctx, replay,
                        bars, tie, None)
    refresh = jax.jit(lambda hv: HV.ml_model_from_harvest(
        hv, stop_padding=ctx.params.stop_padding, min_samples=50))
    mg = on(ctx.gpu, lambda: refresh(g0.harvest))
    mc = on(ctx.cpu, lambda: refresh(g0.harvest))
    err = float(np.max(np.abs(np.append(mg.coef, mg.intercept)
                              - np.append(mc.coef, mc.intercept))))
    check("flywheel refresh on one harvest, card vs cpu",
          bool(mg.present) and bool(mc.present) and err <= 1e-4,
          f"max |coef diff| {err:.3g}")
    g1 = replay_on_both("flywheel round 1 (ML gate armed) on identical bars",
                        ctx, replay, bars, tie, mg)
    vetoes = float(np.asarray(g1.skip_counts)[
        [r.name for r in EP.SKIP_REASONS].index("ML_CONF_LOW")])
    check("flywheel round 1 ML gate vetoes", vetoes > 0, f"{vetoes:.0f} vetoes")


def irls_f64(x, y, w=None, *, c=1.0, iters=50):
    """Reference float64 Newton/IRLS of sklearn's L2 logistic objective
    (intercept unpenalised), as ``models/logistic.fit`` solves it."""
    x = np.asarray(x, np.float64)
    y_pm = np.where(np.asarray(y) > 0, 1.0, -1.0)
    w = np.ones(len(y_pm)) if w is None else np.asarray(w, np.float64)
    n, d = x.shape
    xa = np.concatenate([x, np.ones((n, 1))], axis=1)
    reg = np.concatenate([np.ones(d), np.zeros(1)])
    beta = np.zeros(d + 1)
    for _ in range(iters):
        p = 1.0 / (1.0 + np.exp(-y_pm * (xa @ beta)))
        g = c * xa.T @ (w * (p - 1.0) * y_pm) + reg * beta
        h = c * (xa.T * (w * p * (1.0 - p))) @ xa + np.diag(reg)
        beta = beta - np.linalg.solve(h + 1e-12 * np.eye(d + 1), g)
    return beta[:d], beta[d]


def near_threshold_ml(n, q, seed, level_price=100.0):
    """ML-gate inputs whose float64 probability lies 1e-5..1e-4 from ``q``.
    Returns (coef, intercept, stop prices, features f32[4, n], reference
    decisions); the distance feature is |level_price - stop| as float32
    computes it."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    coef = rng.normal(0.0, 0.3, 4).astype(f32)
    coef[1] = f32(10.0)                 # the distance feature carries the score
    # intercept that puts the threshold near a 0.35 stop distance
    b = f32(math.log(q / (1 - q)) - coef[1] * 0.35
            - coef[[0, 2, 3]].astype(np.float64) @ [0.5, 2.5, 0.5])
    solid = rng.integers(0, 2, n).astype(f32)
    touch = rng.integers(1, 5, n).astype(f32)
    up = rng.integers(0, 2, n).astype(f32)
    margin = rng.uniform(1e-5, 1e-4, n) * rng.choice([-1.0, 1.0], n)
    z_target = np.log((q + margin) / (1.0 - q - margin))
    rest = coef[[0, 2, 3]].astype(np.float64) @ np.stack([solid, touch, up]) + b
    stop = (f32(level_price) - ((z_target - rest) / coef[1]).astype(f32)).astype(f32)
    dist = np.abs(f32(level_price) - stop).astype(f32)
    x = np.stack([solid, dist, touch, up])
    p64 = 1.0 / (1.0 + np.exp(-(coef.astype(np.float64) @ x.astype(np.float64)
                                 + np.float64(b))))
    keep = (np.abs(p64 - q) >= 1e-5) & (np.abs(p64 - q) <= 1e-4) & \
        (stop < f32(level_price))
    return coef, b, stop[keep], x[:, keep], p64[keep] >= q


def near_threshold_policy(n, q, seed):
    """Policy-head inputs whose float64 score lies 1e-5..1e-4 from ``q`` on
    head 0 and farther than 1e-5 on the others.  Returns (w, x, reference)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0.0, 1.0, (3, 7)).astype(np.float32)
    x = rng.normal(0.0, 1.0, (n, 7)).astype(np.float32)
    margin = rng.uniform(1e-5, 1e-4, n) * rng.choice([-1.0, 1.0], n)
    z_target = np.log((q + margin) / (1.0 - q - margin))
    rest = x[:, 1:].astype(np.float64) @ w[0, 1:].astype(np.float64)
    x[:, 0] = ((z_target - rest) / w[0, 0]).astype(np.float32)
    p64 = 1.0 / (1.0 + np.exp(-(x.astype(np.float64) @ w.T.astype(np.float64))))
    keep = np.all(np.abs(p64 - q) >= 1e-5, axis=1) & (np.abs(p64[:, 0] - q) <= 1e-4)
    return w, x[keep], p64[keep] >= q


def phase_precision(ctx):
    """The decision products at the program's own precision against float64.
    The policy heads ask for ``Precision.HIGHEST``: without it the card runs
    them in TF32 and this check fails (425,051 of 3,145,371 decisions flip on
    an H100).  The ML gate's four-term product and the IRLS fit are exact at
    the default precision, so they ask for none."""
    import jax
    import jax.numpy as jnp

    from qmmx_monolithic_monte_carlo_tpu.engine import gates as GT
    from qmmx_monolithic_monte_carlo_tpu.engine.state import MlModel
    from qmmx_monolithic_monte_carlo_tpu.models import logistic as L
    from qmmx_monolithic_monte_carlo_tpu.models import online_policy as OP
    from qmmx_monolithic_monte_carlo_tpu.types import DIR_UP

    q = float(np.asarray(ctx.params.q_min_prob))
    lp = np.float32(100.0)
    coef, b, stop, x, want = near_threshold_ml(1 << 20, q, ctx.seed, lp)
    model = MlModel.from_weights(coef, b)

    def ml(stop, xx):
        ok, _, _ = GT._ml_allowed(
            model, ctx.params, level_solid=xx[0] > 0.5, level_price=lp,
            stop=stop, touch_count=xx[2].astype(jnp.int32),
            direction=jnp.where(xx[3] > 0.5, DIR_UP, DIR_UP + 1))
        return ok

    got = np.asarray(jax.jit(ml)(jnp.asarray(stop), jnp.asarray(x)))
    differ = int(np.sum(got != want))
    check("ML gate at the threshold vs float64", differ == 0 and want.size > 1000,
          f"{differ} of {want.size} decisions within 1e-4 of {q:.7g} differ")

    w, xp, want_p = near_threshold_policy(1 << 20, 0.60, ctx.seed + 1)
    pol = OP.PolicyParams.init().replace(w_entry=jnp.asarray(w))
    got_p = np.asarray(jax.jit(lambda xx: OP.score_entry(pol, xx) >= 0.60)(jnp.asarray(xp)))
    differ = int(np.sum(got_p != want_p))
    check("policy heads at the threshold vs float64", differ == 0 and want_p.size > 1000,
          f"{differ} of {want_p.size} decisions within 1e-4 of 0.60 differ")

    rng = np.random.default_rng(ctx.seed + 2)
    xs = rng.normal(0, 1, (4096, 4)).astype(np.float32)
    ys = (rng.uniform(size=4096) < 1 / (1 + np.exp(-(xs @ [1.0, -0.5, 0.3, 0.8] + 0.2))))
    ref_c, ref_b = irls_f64(xs, ys)
    m = L.fit(jnp.asarray(xs), jnp.asarray(ys.astype(np.int32)))
    err = float(np.max(np.abs(np.append(np.asarray(m.coef), m.intercept)
                              - np.append(ref_c, ref_b))))
    check("IRLS fit on the card vs float64 NumPy", err <= 1e-4,
          f"max |coef diff| {err:.3g}")


def phase_mesh(ctx):
    """The paths and symbols meshes on four cards against the same program on
    a one-card mesh (counts equal: each block's stream is keyed by its global
    index, so the mesh shape cannot matter), and against the plain one-device
    pipeline, which XLA compiles into other fusions (within ``BUDGET["mesh"]``:
    the card's float32 rounding then differs in the last bit, which moved
    one engine stop count in 2^21 paths)."""
    import jax

    from qmmx_monolithic_monte_carlo_tpu.parallel import mesh as PM
    from qmmx_monolithic_monte_carlo_tpu.parallel import universe as U
    from qmmx_monolithic_monte_carlo_tpu.sim import enginepath as EP
    from qmmx_monolithic_monte_carlo_tpu.sim import pathsim

    n_dev = 4
    if len(jax.devices()) < n_dev:
        raise SmokeFailure(f"--cards 4 needs 4 GPUs, found {len(jax.devices())}")
    key = jax.random.key(ctx.seed)
    # counts stay below 2^24, where their float32 sums are exact
    cases = [("first contact", dict(num_paths=MESH_PATHS,
                                    block_paths=min(MESH_PATHS // 4, 1 << 18)),
              pathsim.mc_paths),
             ("engine", dict(num_paths=MESH_PATHS // 4,
                             block_paths=min(MESH_PATHS // 16, 1 << 13)),
              lambda *a, **k: EP.mc_paths_engine(*a, **k)[0])]
    for name, kw, plain_fn in cases:
        kw = dict(kw, num_bars=40, sigma=0.3)
        runs = {}
        for label, fn in (
                ("4 cards", lambda: PM.sharded_mc_paths(
                    PM.make_mesh(n_dev), key, ctx.levels, ctx.params,
                    engine=name == "engine", **kw)),
                ("1-card mesh", lambda: PM.sharded_mc_paths(
                    PM.make_mesh(1), key, ctx.levels, ctx.params,
                    engine=name == "engine", **kw)),
                ("plain pipeline", lambda: plain_fn(key, ctx.levels, ctx.params, **kw))):
            t0 = time.perf_counter()
            runs[label] = jax.device_get(fn())
            runs[label + " s"] = time.perf_counter() - t0
        print(f"[mesh {name}] {kw['num_paths']} paths, compile included: 4 cards "
              f"{runs['4 cards s']:.3f} s, 1-card mesh {runs['1-card mesh s']:.3f} s, "
              f"plain pipeline {runs['plain pipeline s']:.3f} s", flush=True)
        _mesh_equal(f"sharded_mc_paths {name}", runs["4 cards"], runs["1-card mesh"])
        compare_stats(f"sharded_mc_paths {name} vs plain pipeline", runs["4 cards"],
                      runs["plain pipeline"], n_paths=kw["num_paths"],
                      budget=BUDGET["mesh"])

    n_sym = 16
    rows = [[{"color": "blue", "type": "solid", "index": 0, "price": 100.0 + i}]
            for i in range(n_sym)]
    lv = U.stack_levels(rows, max_levels=4)
    s0 = np.array([100.0 + i for i in range(n_sym)], np.float32)
    sig = np.full(n_sym, 0.25, np.float32)
    kw = dict(paths_per_symbol=MESH_PATHS // n_sym, num_bars=40,
              block_paths=min(MESH_PATHS // n_sym, 1 << 15))
    t0 = time.perf_counter()
    sh = jax.device_get(U.sharded_universe(PM.make_mesh(n_dev, axis="symbols"),
                                           key, lv, ctx.params, s0, sig, **kw))
    t_sh = time.perf_counter() - t0
    one = jax.device_get(U.sharded_universe(PM.make_mesh(1, axis="symbols"),
                                            key, lv, ctx.params, s0, sig, **kw))
    plain = jax.device_get(U.universe_mc(key, lv, ctx.params, s0, sig, **kw))
    print(f"[mesh universe] {n_sym} symbols x {kw['paths_per_symbol']} paths: "
          f"4 cards {t_sh:.3f} s (compile included)", flush=True)
    _mesh_equal("sharded_universe", sh, one)
    compare_stats("sharded_universe vs plain pipeline", sh, plain,
                  n_paths=kw["paths_per_symbol"],
                  budget=BUDGET["mesh"])


def _mesh_equal(label, sh, single):
    """Counts exact, ``sum_r`` within rtol 1e-5 (tests/test_pathsim.py)."""
    for fld in ("n", "n_entered", "n_tp", "n_stop", "n_open", "sum_trades", "hist"):
        a, b = np.asarray(getattr(sh, fld)), np.asarray(getattr(single, fld))
        check(f"{label} {fld}", np.array_equal(a, b),
              f"{a.ravel()[:4].tolist()} vs {b.ravel()[:4].tolist()}")
    a, b = np.asarray(sh.sum_r, np.float64), np.asarray(single.sum_r, np.float64)
    rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
    check(f"{label} sum_r", rel <= 1e-5, f"relative diff {rel:.3g}")


PHASES = (phase_mc, phase_paths, phase_engine, phase_book, phase_flywheel,
          phase_precision)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card mesh phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    try:
        from qmmx_monolithic_monte_carlo_tpu import backend
    except ImportError as e:
        print(f"chip_smoke.py runs from a checkout of the repository: {e}",
              file=sys.stderr)
        return 2
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs an NVIDIA GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 3
    cache = backend.setup_compile_cache()
    print(f"card: {card_line()} | jax {jax.__version__} | compile cache {cache}",
          flush=True)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = Context(args.seed, os.path.join(tmp, "smoke.db"))
        for phase in (phase_mesh,) if args.cards == 4 else PHASES:
            phase(ctx)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s; card: {card_line()}")
    print(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                              "kind": dev.device_kind,
                                              "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
