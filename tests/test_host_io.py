"""Host/IO layer: schema parity, audit payloads, QVoice, analyzer, training
store, portfolio, chart, live loop, CLI."""

import json
import os
import sqlite3

import numpy as np
import pytest

from qmmx_monolithic_monte_carlo_tpu.io import analyzer
from qmmx_monolithic_monte_carlo_tpu.io import db as _db
from qmmx_monolithic_monte_carlo_tpu.io import portfolio as port
from qmmx_monolithic_monte_carlo_tpu.io import trainstore
from qmmx_monolithic_monte_carlo_tpu.io.qvoice import QVoice


@pytest.fixture
def conn(tmp_path):
    c = _db.db_connect(str(tmp_path / "q.db"))
    _db.db_init(c)
    return c


def test_schema_matches_reference_tables(conn):
    tables = {r[0] for r in conn.execute(
        "SELECT name FROM sqlite_master WHERE type='table'").fetchall()}
    assert {"settings", "price_levels", "audit_log", "trades",
            "contact_events", "policy_events", "q_explanations"} <= tables
    cols = [r[1] for r in conn.execute("PRAGMA table_info(trades)")]
    assert cols == ["id", "ts_open", "ts_close", "symbol", "side", "entry",
                    "exit", "stop", "target", "reason_open", "reason_close", "pnl"]
    cols = [r[1] for r in conn.execute("PRAGMA table_info(policy_events)")]
    assert cols == ["id", "ts", "phase", "action", "features_json", "label",
                    "trade_id", "notes"]


def test_settings_levels_roundtrip(conn):
    _db.settings_set(conn, "Q_MIN_PROB", "0.55")
    assert _db.settings_get(conn, "Q_MIN_PROB") == "0.55"
    levels = [{"color": "blue", "type": "solid", "index": 0, "price": 100.0},
              {"color": "teal", "type": "dashed", "index": 1, "price": 99.5}]
    _db.replace_levels(conn, levels)
    got = _db.load_levels(conn)
    assert len(got) == 2 and got[0]["color"] == "blue"


def test_trade_lifecycle_labels_policy_event(conn):
    _db.insert_policy_event(conn, "entry", "go_long",
                            {"proximity_abs": 0.01, "approach": "from_below",
                             "touch_count": 1, "conf": 0.8, "ml_prob": 0.8},
                            notes="PRE_OPEN")
    tid = _db.open_trade(conn, "SPY", "long", 100.0, 99.65, 100.25, "test")
    row = conn.execute(
        "SELECT trade_id FROM policy_events ORDER BY id DESC LIMIT 1").fetchone()
    assert row[0] == tid
    pnl = _db.close_trade(conn, tid, 100.25, "TARGET")
    assert pnl == pytest.approx(0.25)
    label = conn.execute(
        "SELECT label FROM policy_events WHERE trade_id=?", (tid,)).fetchone()[0]
    assert label == 1


def test_qvoice_codebook_and_persistence(tmp_path):
    q = QVoice(str(tmp_path / "q.db"))
    text = q.narrate_entry_evaluation(
        symbol="SPY", code="CONF_LOW", level_type="solid", direction="from_below",
        proximity=0.0123, confidence=0.41, min_conf=0.60,
    )
    assert "confidence was below" in text
    assert "[SPY]" in text and "proximity: 0.0123" in text and "conf 0.41/0.60" in text
    rows = q.fetch_recent(10)
    assert len(rows) == 1 and rows[0][2] == "CONF_LOW"
    # all 17 reference codes present
    from qmmx_monolithic_monte_carlo_tpu.io.qvoice import CODEBOOK
    assert len(CODEBOOK) == 17


def test_analyzer_aggregates_reasons(conn):
    _db.insert_policy_event(conn, "entry", "skip", {"reason": "TOO_FAR",
                            "level_price": 100.0, "proximity_abs": 0.2,
                            "CONTACT_PROX": 0.05})
    _db.insert_policy_event(conn, "entry", "skip", {"reason": "CONF_LOW",
                            "conf": 0.4, "Q_MIN_PROB": 0.6,
                            "level_price": 100.0, "proximity_abs": 0.01})
    _db.insert_policy_event(conn, "entry", "skip", {"reason": "CONF_LOW",
                            "conf": 0.5, "Q_MIN_PROB": 0.6,
                            "level_price": 100.0, "proximity_abs": 0.02})
    res = analyzer.analyze_policy_events(conn)
    assert res["counts"] == {"TOO_FAR": 1, "CONF_LOW": 2}
    report = analyzer.render_report(res)
    assert "Reason: CONF_LOW (Count: 2)" in report


def test_watermark_incremental_training(conn):
    from qmmx_monolithic_monte_carlo_tpu.models import online_policy as OP

    for i in range(5):
        _db.insert_policy_event(
            conn, "entry", "go_long",
            {"proximity_abs": 0.01 * i, "approach": "from_below",
             "confluence": False, "minutes_since_open": 30},
            label=i % 2,
        )
    policy = OP.PolicyParams.init()
    policy, n, wm = trainstore.retrain_from_labeled_events(conn, policy)
    assert n == 5
    assert int(_db.settings_get(conn, trainstore.WATERMARK_KEY)) == wm
    # second pass: nothing new (exactly-once)
    policy2, n2, wm2 = trainstore.retrain_from_labeled_events(conn, policy)
    assert n2 == 0 and wm2 == wm
    assert not np.allclose(np.asarray(policy.w_entry), 0.0)


def test_batch_training_join_and_fit(conn):
    # seed 60 contact→trade pairs within 120 s
    from datetime import datetime, timedelta, timezone

    rng = np.random.default_rng(0)
    t0 = datetime(2025, 9, 1, 14, 30, tzinfo=timezone.utc)
    for i in range(60):
        t_contact = t0 + timedelta(minutes=5 * i)
        solid = int(rng.integers(2))
        pnl = float(rng.normal(0.05 if solid else -0.05, 0.1))
        conn.execute(
            "INSERT INTO contact_events(ts, symbol, level_color, level_type, "
            "level_index, level_price, approach, reaction, distance) "
            "VALUES(?,?,?,?,?,?,?,?,?)",
            (t_contact.isoformat(), "SPY", "blue",
             "solid" if solid else "dashed", 0, 100.0,
             "up" if rng.integers(2) else "down", "bounce",
             float(rng.uniform(0, 0.05))),
        )
        conn.execute(
            "INSERT INTO trades(ts_open, ts_close, symbol, side, entry, exit, "
            "stop, target, pnl) VALUES(?,?,?,?,?,?,?,?,?)",
            ((t_contact + timedelta(seconds=30)).isoformat(),
             (t_contact + timedelta(seconds=90)).isoformat(),
             "SPY", "long", 100.0, 100.0 + pnl, 99.65, 100.25, pnl),
        )
    conn.commit()
    x, y = trainstore.build_training_data(conn)
    assert x.shape == (60, 4)
    model, n = trainstore.do_retrain(conn)
    assert model is not None and n == 60
    x3, _ = trainstore.build_training_data(conn, reference_features=True)
    assert x3.shape == (60, 3)


def test_retrain_insufficient_data(conn):
    model, n = trainstore.do_retrain(conn)
    assert model is None and n == 0


def test_auto_tune(conn):
    for i in range(40):
        _db.insert_policy_event(conn, "entry", "go_long", {}, label=1 if i < 30 else 0)
    new = trainstore.auto_tune_conf_threshold(conn)
    # winrate 0.75 → target clamps to 0.70 → 0.8*0.6 + 0.2*0.70 = 0.62
    assert new == pytest.approx(0.62, abs=1e-6)


def test_portfolio_snapshot_and_export(conn, tmp_path):
    tid = _db.open_trade(conn, "SPY", "long", 100.0, 99.65, 100.25, "t")
    _db.close_trade(conn, tid, 100.25, "TARGET")
    tid2 = _db.open_trade(conn, "SPY", "short", 100.0, 100.35, 99.75, "t")
    snap = port.snapshot(conn, 10000.0, tid2, last_price=99.9)
    assert snap["realized"] == pytest.approx(0.25)
    assert snap["unrealized"] == pytest.approx(0.1)
    assert snap["equity"] == pytest.approx(10000.35)
    rows = port.trades_table(conn)
    assert len(rows) == 2 and rows[0]["r"] == pytest.approx(0.25 / 0.35, rel=1e-3)
    out = tmp_path / "t.csv"
    assert port.export_trades_csv(conn, str(out)) == 2
    assert out.exists()


def test_chart_renders_png(tmp_path):
    from qmmx_monolithic_monte_carlo_tpu.io import chart   # needs matplotlib

    rng = np.random.default_rng(0)
    c = 100 + np.cumsum(rng.normal(0, 0.1, 50))
    bars = [{"t": i, "o": float(c[max(0, i - 1)]), "h": float(c[i] + 0.1),
             "l": float(c[i] - 0.1), "c": float(c[i])} for i in range(50)]
    out = chart.render_chart(
        bars,
        [{"color": "blue", "type": "solid", "index": 0, "price": 100.0}],
        [{"i_open": 10, "i_close": 20, "side": "long", "entry": 100.0,
          "exit": 100.3, "stop": 99.7, "target": 100.3}],
        path=str(tmp_path / "c.png"),
    )
    assert os.path.getsize(out) > 10_000


def test_live_host_opens_and_closes(tmp_path):
    from qmmx_monolithic_monte_carlo_tpu.host.app import EngineHost
    from qmmx_monolithic_monte_carlo_tpu.io import feed as feed_io

    db = str(tmp_path / "q.db")
    c = _db.db_connect(db)
    _db.db_init(c)
    _db.replace_levels(c, [
        {"color": "blue", "type": "solid", "index": 0, "price": 100.0},
        {"color": "teal", "type": "solid", "index": 0, "price": 99.5},
    ])
    _db.settings_set(c, "Q_MIN_PROB", "0.45")
    _db.settings_set(c, "DISABLE_POLICY_GATE", "1")
    feed = feed_io.SyntheticFeed("SYN", s0=100.0, sigma=3.0, seed=1)
    host = EngineHost(db_path=db, feed=feed, tick_sleep=0.0,
                      policy_path=str(tmp_path / "pol.npz"),
                      lr_model_path=str(tmp_path / "lr.npz"),
                      retrain_interval_s=0.0)
    host.run(max_ticks=600, sleep=lambda s: None)
    n_trades = c.execute("SELECT COUNT(*) FROM trades").fetchone()[0]
    n_closed = c.execute(
        "SELECT COUNT(*) FROM trades WHERE ts_close IS NOT NULL").fetchone()[0]
    assert n_trades >= 1
    assert n_closed >= 1
    # closed trades labeled their policy events
    lbl = c.execute("SELECT COUNT(*) FROM policy_events WHERE label IS NOT NULL"
                    ).fetchone()[0]
    assert lbl >= 1
    # audit rows mirrored
    assert c.execute("SELECT COUNT(*) FROM audit_log").fetchone()[0] > 0
    # portfolio reflects closed pnl
    snap = host.portfolio()
    assert snap["wins"] + snap["losses"] == n_closed


def test_cli_end_to_end(tmp_path, capsys):
    from qmmx_monolithic_monte_carlo_tpu.host import cli

    db = str(tmp_path / "q.db")
    assert cli.main(["--db", db, "levels", "set", "blue:solid:0:100.0",
                     "teal:solid:0:99.7"]) == 0
    assert cli.main(["--db", db, "settings", "set", "Q_MIN_PROB", "0.5"]) == 0
    assert cli.main(["--db", db, "sim", "--gates", "--num-bars", "120"]) == 0
    out = capsys.readouterr().out
    assert "trades=" in out
    assert cli.main(["--db", db, "mc", "--trials", "50", "--num-bars", "120"]) == 0
    out = capsys.readouterr().out
    assert "VaR(5%)" in out
    assert cli.main(["--db", db, "paths", "--num-paths", "4096",
                     "--num-bars", "16"]) == 0
    out = capsys.readouterr().out
    assert json.loads(out.strip())["paths"] == 4096.0
    assert cli.main(["--db", db, "analyze"]) == 0
    assert cli.main(["--db", db, "chart", "--out", str(tmp_path / "c.png")]) == 0
    assert (tmp_path / "c.png").exists()


def test_contact_events_recorded_and_retrain_pipeline(tmp_path):
    """Q9 fix: fresh touches record contact_events; with enough closed trades,
    the batch LR retrain has real data to fit."""
    from qmmx_monolithic_monte_carlo_tpu.host.app import EngineHost
    from qmmx_monolithic_monte_carlo_tpu.io import feed as feed_io

    db = str(tmp_path / "q.db")
    c = _db.db_connect(db)
    _db.db_init(c)
    _db.replace_levels(c, [
        {"color": "blue", "type": "solid", "index": 0, "price": 100.0},
        {"color": "teal", "type": "dashed", "index": 0, "price": 99.5},
    ])
    _db.settings_set(c, "Q_MIN_PROB", "0.45")
    _db.settings_set(c, "DISABLE_POLICY_GATE", "1")
    feed = feed_io.SyntheticFeed("SYN", s0=100.0, sigma=3.0, seed=2)
    host = EngineHost(db_path=db, feed=feed, symbol="SYN", tick_sleep=0.0,
                      policy_path=str(tmp_path / "p.npz"),
                      lr_model_path=str(tmp_path / "l.npz"),
                      retrain_interval_s=1e9)
    host.run(max_ticks=800, sleep=lambda s: None)
    n_contacts = c.execute("SELECT COUNT(*) FROM contact_events").fetchone()[0]
    assert n_contacts >= 1
    row = c.execute(
        "SELECT symbol, level_color, level_type, approach, distance "
        "FROM contact_events LIMIT 1").fetchone()
    assert row[0] == "SYN" and row[1] in ("blue", "teal")
    assert row[3] in ("up", "down") and row[4] is not None
    # the training join finds samples when trades closed near contacts
    x, y = trainstore.build_training_data(c)
    n_closed = c.execute(
        "SELECT COUNT(*) FROM trades WHERE ts_close IS NOT NULL").fetchone()[0]
    if n_closed:
        assert len(y) >= 1
        model, n = trainstore.do_retrain(c, min_samples=1)
        assert model is not None


def test_strict_quirks_disable_contact_recording(tmp_path):
    from qmmx_monolithic_monte_carlo_tpu.config import CompatFlags
    from qmmx_monolithic_monte_carlo_tpu.host.app import EngineHost
    from qmmx_monolithic_monte_carlo_tpu.io import feed as feed_io

    db = str(tmp_path / "q.db")
    c = _db.db_connect(db)
    _db.db_init(c)
    _db.replace_levels(c, [
        {"color": "blue", "type": "solid", "index": 0, "price": 100.0}])
    _db.settings_set(c, "Q_MIN_PROB", "0.45")
    feed = feed_io.SyntheticFeed("SYN", s0=100.0, sigma=3.0, seed=3)
    host = EngineHost(db_path=db, feed=feed, tick_sleep=0.0,
                      compat=CompatFlags.strict_reference_quirks(),
                      policy_path=str(tmp_path / "p.npz"),
                      lr_model_path=str(tmp_path / "l.npz"),
                      retrain_interval_s=1e9)
    host.run(max_ticks=200, sleep=lambda s: None)
    assert c.execute("SELECT COUNT(*) FROM contact_events").fetchone()[0] == 0


def test_exit_events_recorded_and_labeled_ex_post(tmp_path):
    """Each close records an exit policy_event; a deferred labeler scores it
    K minute-closes later (exiting beat holding?), feeding the exit head."""
    from qmmx_monolithic_monte_carlo_tpu.host.app import EngineHost
    from qmmx_monolithic_monte_carlo_tpu.io import feed as feed_io
    from qmmx_monolithic_monte_carlo_tpu.models import online_policy as OP

    db = str(tmp_path / "q.db")
    c = _db.db_connect(db)
    _db.db_init(c)
    _db.replace_levels(c, [
        {"color": "blue", "type": "solid", "index": 0, "price": 100.0},
        {"color": "teal", "type": "solid", "index": 0, "price": 99.5},
    ])
    _db.settings_set(c, "Q_MIN_PROB", "0.45")
    _db.settings_set(c, "DISABLE_POLICY_GATE", "1")
    feed = feed_io.SyntheticFeed("SYN", s0=100.0, sigma=3.0, seed=5)
    host = EngineHost(db_path=db, feed=feed, symbol="SYN", tick_sleep=0.0,
                      policy_path=str(tmp_path / "p.npz"),
                      lr_model_path=str(tmp_path / "l.npz"),
                      retrain_interval_s=1e9)
    host.run(max_ticks=1500, sleep=lambda s: None)
    n_exit = c.execute(
        "SELECT COUNT(*) FROM policy_events WHERE phase='exit'").fetchone()[0]
    n_closed = c.execute(
        "SELECT COUNT(*) FROM trades WHERE ts_close IS NOT NULL").fetchone()[0]
    assert n_exit == n_closed
    # exit events carry REAL features (round 2): the session clock, and a
    # volume trend computed from the bar ring (0.0 here only because live
    # tick volume is 0 — reference quirk Q6 — never a hardcoded placeholder)
    import time as _time

    from qmmx_monolithic_monte_carlo_tpu.host.app import minutes_since_open

    expect_mins = minutes_since_open(_time.time())
    for (fjson,) in c.execute(
            "SELECT features_json FROM policy_events WHERE phase='exit'"):
        feats = json.loads(fjson)
        assert abs(int(feats["minutes_since_open"]) - expect_mins) <= 2
        assert isinstance(feats["volume_trend"], float)
    if n_closed:
        labeled = c.execute(
            "SELECT COUNT(*) FROM policy_events WHERE phase='exit' "
            "AND label IS NOT NULL").fetchone()[0]
        # closes early in the run have had their K bars elapse
        assert labeled >= 1
        # and the incremental trainer consumes them into the exit head
        policy, n, _ = trainstore.retrain_from_labeled_events(
            c, OP.PolicyParams.init())
        assert n >= 1
        assert not np.allclose(np.asarray(policy.w_exit), 0.0)


def test_cli_sweep_trades_export_tune_qvoice(tmp_path, capsys):
    from qmmx_monolithic_monte_carlo_tpu.host import cli

    db = str(tmp_path / "q.db")
    assert cli.main(["--db", db, "levels", "set", "blue:solid:0:100.0"]) == 0
    assert cli.main(["--db", db, "sweep", "--num-paths", "4096",
                     "--num-bars", "16", "--stops", "0.25", "0.35",
                     "--tps", "0.15"]) == 0
    out = capsys.readouterr().out
    lines = [json.loads(l) for l in out.strip().splitlines() if l.startswith("{")]
    assert len(lines) == 2 and {"stop_padding", "hit_rate"} <= set(lines[0])
    # trades/export/portfolio on a seeded trade
    c = _db.db_connect(db)
    tid = _db.open_trade(c, "SPY", "long", 100.0, 99.65, 100.25, "t")
    _db.close_trade(c, tid, 100.25, "TARGET")
    assert cli.main(["--db", db, "trades"]) == 0
    assert "pnl=0.25" in capsys.readouterr().out
    assert cli.main(["--db", db, "export", "--out", str(tmp_path / "t.csv")]) == 0
    capsys.readouterr()
    assert cli.main(["--db", db, "portfolio"]) == 0
    snap = json.loads(capsys.readouterr().out)
    assert snap["realized"] == pytest.approx(0.25)
    # tune (not enough labels) and qvoice subcommands
    assert cli.main(["--db", db, "tune"]) == 0
    assert "not enough labels" in capsys.readouterr().out
    assert cli.main(["--db", db, "qvoice", "backfill"]) == 0
    assert cli.main(["--db", db, "qvoice", "recent"]) == 0
    capsys.readouterr()
    assert cli.main(["--db", db, "settings", "list"]) == 0
    assert "CONTACT_PROX" in capsys.readouterr().out


def test_cli_live_synthetic(tmp_path, capsys):
    from qmmx_monolithic_monte_carlo_tpu.host import cli

    db = str(tmp_path / "q.db")
    cli.main(["--db", db, "levels", "set", "blue:solid:0:100.0"])
    cli.main(["--db", db, "settings", "set", "Q_MIN_PROB", "0.45"])
    cli.main(["--db", db, "settings", "set", "DISABLE_POLICY_GATE", "1"])
    capsys.readouterr()
    assert cli.main(["--db", db, "live", "--synthetic", "--max-ticks", "100"]) == 0
    out = capsys.readouterr().out
    assert "processed" in out and "equity" in out
