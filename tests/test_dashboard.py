"""TUI dashboard smoke tests: frames render headlessly against a replayed
session (the CI analog of 'the window opens and shows the chart')."""

import numpy as np

from qmmx_monolithic_monte_carlo_tpu.host import dashboard
from qmmx_monolithic_monte_carlo_tpu.host.app import EngineHost
from qmmx_monolithic_monte_carlo_tpu.io import db as _db
from qmmx_monolithic_monte_carlo_tpu.io import feed as feed_io


def _host(tmp_path, **kw):
    db = str(tmp_path / "q.db")
    c = _db.db_connect(db)
    _db.db_init(c)
    _db.replace_levels(c, [
        {"color": "blue", "type": "solid", "index": 0, "price": 100.0},
        {"color": "orange", "type": "dashed", "index": 0, "price": 100.4},
    ])
    _db.settings_set(c, "DISABLE_POLICY_GATE", "1")
    feed = feed_io.SyntheticFeed("SYN", s0=100.0, sigma=2.0, seed=3)
    return EngineHost(db_path=db, feed=feed, symbol="SYN", tick_sleep=0.0,
                      policy_path=str(tmp_path / "p.npz"),
                      lr_model_path=str(tmp_path / "l.npz"),
                      retrain_interval_s=1e9, **kw)


def test_dashboard_renders_one_frame(tmp_path):
    host = _host(tmp_path)
    last = {}

    def on_tick(i, out):
        last.update(out)

    host.run(max_ticks=400, sleep=lambda s: None, on_tick=on_tick)
    text = dashboard.render_frame_text(host, last, 400)
    assert "SYN" in text
    assert "chart" in text and "position" in text and "portfolio" in text
    assert "q voice" in text
    # the level guides and at least one close marker made it into the chart
    assert "─" in text or "╌" in text
    assert "●" in text


def test_chart_text_levels_and_guides():
    from qmmx_monolithic_monte_carlo_tpu.engine.state import Position

    closes = np.linspace(99.8, 100.3, 30)
    rows = [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
            {"color": "teal", "type": "dashed", "index": 0, "price": 100.2}]
    txt = dashboard.chart_text(closes, rows, width=40, height=10)
    s = txt.plain
    assert "─" in s and "╌" in s and "●" in s
    assert "100.0" in s or "100.00" in s  # axis labels present

    import jax.numpy as jnp

    pos = Position(side=jnp.int32(1), entry=jnp.float32(100.0),
                   stop=jnp.float32(99.9), target=jnp.float32(100.25),
                   open_ts_ms=jnp.int32(0))
    txt2 = dashboard.chart_text(closes, rows, width=40, height=12, position=pos)
    assert "┄" in txt2.plain  # stop/target guides drawn


def test_cli_live_dashboard_smoke(tmp_path, capsys, monkeypatch):
    """`qmmx live --synthetic --dashboard` runs under a non-tty console."""
    from qmmx_monolithic_monte_carlo_tpu.host import cli

    rc = cli.main(["--db", str(tmp_path / "q.db"), "live", "--synthetic",
                   "--dashboard", "--max-ticks", "60", "--symbol", "SYN"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "processed 60 ticks" in out
