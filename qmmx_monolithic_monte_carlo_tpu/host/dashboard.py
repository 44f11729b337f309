"""Live terminal dashboard — the interactive analog of the reference Tk app.

The reference's always-on window (qmmx_monolithic.py:2018-3351) shows a live
candlestick chart with level overlays (:2391-2624), the open position and
portfolio box (:3246-3303), the scrolling log (:3305-3345), and the QVoice
narration panel (q_voice.py).  This module renders the same surfaces as a
`rich` layout driven by the engine host's tick loop (`qmmx live
--dashboard`):

┌ header: symbol · price · tick # · last reason ───────────────────┐
│ chart (close line over the bar ring, level overlays,             │ position │
│ entry/stop/target guides while a trade is open)                  │ portfolio│
├──────────────────────────────────────────────────────────────────┴──────────┤
│ QVoice narration tail (q_explanations)                                      │
└──────────────────────────────────────────────────────────────────────────────┘

Everything renders through pure functions of (host, last-tick outcome) so the
frame can be exported to text in CI (smoke test renders one frame without a
terminal).
"""

from __future__ import annotations

import numpy as np
from rich.console import Console, Group
from rich.layout import Layout
from rich.panel import Panel
from rich.table import Table
from rich.text import Text

from ..types import SIDE_LONG

CHART_HEIGHT = 14


def _ring_closes(host) -> np.ndarray:
    closes, _vols, valid = host.carry.bars.ordered()
    closes = np.asarray(closes)
    valid = np.asarray(valid)
    return closes[valid]


def chart_text(closes: np.ndarray, level_rows: list[dict], *,
               width: int = 64, height: int = CHART_HEIGHT,
               position=None, last_price: float | None = None) -> Text:
    """Render a close-price line chart with level overlays as rich Text.

    Levels draw as colored horizontal guides (solid '─' / dashed '╌', colored
    by the reference's Blue/Orange/Black/Teal palette); while a position is
    open its stop/target render as red/green guides.  The newest bar is the
    rightmost column.
    """
    closes = np.asarray(closes, np.float64)
    if last_price is not None:
        closes = np.concatenate([closes, [last_price]])
    closes = closes[-width:]
    if closes.size == 0:
        return Text("(no bars yet)", style="dim")

    level_prices = [float(r["price"]) for r in level_rows]
    candidates = list(closes)
    lo, hi = min(candidates), max(candidates)
    # include only levels near the price action so far-away levels don't
    # squash the chart (the Tk chart auto-scales to the candles, :2477-2495)
    span = max(hi - lo, 1e-6)
    near_levels = [
        (p, r) for p, r in zip(level_prices, level_rows)
        if lo - span <= p <= hi + span
    ]
    for p, _ in near_levels:
        lo, hi = min(lo, p), max(hi, p)
    pad = max((hi - lo) * 0.05, 1e-6)
    lo, hi = lo - pad, hi + pad

    def row_of(price: float) -> int:
        frac = (price - lo) / (hi - lo)
        return int(round((1.0 - frac) * (height - 1)))

    grid = [[(" ", None) for _ in range(width)] for _ in range(height)]
    palette = {"blue": "bright_blue", "orange": "dark_orange",
               "black": "grey62", "teal": "cyan"}
    for p, r in near_levels:
        y = row_of(p)
        ch = "─" if r["type"] == "solid" else "╌"
        style = palette.get(r["color"], "white")
        for x in range(width):
            grid[y][x] = (ch, style)
    if position is not None and bool(np.asarray(position.is_open)):
        for price, style in ((float(position.stop), "red"),
                             (float(position.target), "green")):
            if lo <= price <= hi:
                y = row_of(price)
                for x in range(width):
                    grid[y][x] = ("┄", style)

    x0 = width - closes.size
    prev_y = None
    for i, c in enumerate(closes):
        y = row_of(float(c))
        x = x0 + i
        grid[y][x] = ("●" if i == closes.size - 1 else "•", "bold white")
        if prev_y is not None:
            step = 1 if y > prev_y else -1
            for yy in range(prev_y + step, y, step):
                if grid[yy][x][0] == " ":
                    grid[yy][x] = ("│", "white")
        prev_y = y

    text = Text()
    for y, row in enumerate(grid):
        price_at = hi - (hi - lo) * y / (height - 1)
        for ch, style in row:
            text.append(ch, style=style)
        text.append(f" {price_at:8.2f}", style="dim")
        if y < height - 1:
            text.append("\n")
    return text


def position_panel(host, price: float) -> Panel:
    pos = host.carry.position
    if not bool(np.asarray(pos.is_open)):
        body = Text("flat", style="dim")
    else:
        long_ = int(np.asarray(pos.side)) == SIDE_LONG
        entry = float(np.asarray(pos.entry))
        stop = float(np.asarray(pos.stop))
        target = float(np.asarray(pos.target))
        unreal = (price - entry) if long_ else (entry - price)
        risk = max(abs(entry - stop), 1e-9)
        t = Table.grid(padding=(0, 1))
        t.add_row("side", Text("LONG" if long_ else "SHORT",
                               style="green" if long_ else "red"))
        t.add_row("entry", f"{entry:.2f}")
        t.add_row("stop", Text(f"{stop:.2f}", style="red"))
        t.add_row("target", Text(f"{target:.2f}", style="green"))
        t.add_row("uPnL", Text(f"{unreal:+.2f} ({unreal / risk:+.2f}R)",
                               style="green" if unreal >= 0 else "red"))
        body = t
    return Panel(body, title="position", border_style="magenta")


def portfolio_panel(host, price: float) -> Panel:
    snap = host.portfolio(price)
    t = Table.grid(padding=(0, 1))
    t.add_row("equity", f"{snap['equity']:.2f}")
    t.add_row("realized", f"{snap['realized']:+.2f}")
    t.add_row("unreal", f"{snap['unrealized']:+.2f}")
    t.add_row("w/l", f"{snap['wins']}/{snap['losses']}")
    t.add_row("R", f"{float(np.asarray(host.carry.equity_r)):+.2f}")
    return Panel(t, title="portfolio", border_style="yellow")


def qvoice_panel(host, limit: int = 6) -> Panel:
    try:
        rows = host.qvoice.fetch_recent(limit)
    except Exception:
        rows = []
    lines = Text()
    for _rid, ts, _code, msg, _pj in rows:
        lines.append(f"{ts[11:19]} ", style="dim")
        lines.append(msg[:110] + "\n")
    if not rows:
        lines.append("(no narration yet)", style="dim")
    return Panel(lines, title="q voice", border_style="cyan")


def build_frame(host, out: dict, tick_no: int) -> Layout:
    """One dashboard frame from the last tick's outcome dict."""
    price = float(out.get("price", 0.0))
    header = Text.assemble(
        (f" {host.symbol} ", "bold reverse"),
        (f"  {price:.2f}", "bold"),
        (f"   tick #{tick_no}", "dim"),
        ("   last: ", "dim"),
        (str(out.get("reason", "")),
         "green" if out.get("opened") else
         "red" if out.get("closed") else "white"),
        ("  [OPEN]" if out.get("opened") else
         "  [CLOSE]" if out.get("closed") else
         "  [ESCALATE]" if out.get("escalated") else "",
         "bold yellow"),
    )
    chart = Panel(
        chart_text(_ring_closes(host), host.level_rows,
                   position=host.carry.position, last_price=price),
        title="chart", border_style="white",
    )
    layout = Layout()
    layout.split_column(
        Layout(Panel(header), name="header", size=3),
        Layout(name="main", size=CHART_HEIGHT + 2),
        Layout(qvoice_panel(host), name="voice"),
    )
    layout["main"].split_row(
        Layout(chart, name="chart", ratio=3),
        Layout(name="side", ratio=1),
    )
    layout["main"]["side"].split_column(
        Layout(position_panel(host, price)),
        Layout(portfolio_panel(host, price)),
    )
    return layout


def render_frame_text(host, out: dict, tick_no: int, *, width: int = 110) -> str:
    """Export one frame as plain text (CI smoke surface — no terminal needed)."""
    console = Console(record=True, width=width,
                      height=CHART_HEIGHT + 13, file=open("/dev/null", "w"))
    console.print(build_frame(host, out, tick_no))
    return console.export_text()


def run_dashboard(host, *, max_ticks=None, synthetic=True,
                  refresh_every: int = 1) -> int:
    """Drive host.run under a rich Live display; returns ticks processed."""
    import time

    from rich.live import Live

    console = Console()
    with Live(console=console, screen=False, auto_refresh=False) as live:
        def on_tick(i, out):
            if i % refresh_every == 0:
                live.update(build_frame(host, out, i), refresh=True)

        return host.run(
            max_ticks=max_ticks,
            sleep=(lambda s: None) if synthetic else time.sleep,
            on_tick=on_tick,
        )
