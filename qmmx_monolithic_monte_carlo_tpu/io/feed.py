"""Market-data feeds: Polygon.io REST adapter + offline synthetic/replay feeds.

``PolygonFeed`` re-expresses the reference ``PriceFeed`` (qmmx_monolithic.py:
171-240): market status, previous close, last trade (ns→ms), and 1-minute
aggregates over the last 24 h trimmed to the latest N.  Network access is
optional — environments without egress use ``SyntheticFeed`` (keyed GBM ticks,
deterministic) or ``ReplayFeed`` (recorded bar fixtures), both satisfying the
same interface, which is also how the host loop is tested.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional

try:
    import requests

    _REQUESTS_OK = True
except Exception:  # pragma: no cover
    _REQUESTS_OK = False


def _http_err(r) -> str:
    """Non-200 diagnostic for the status line / audit breadcrumb (original
    phrasing — the reference's error strings never feed the reason-code
    contract, so nothing here needs string parity)."""
    return f"polygon returned {r.status_code}; body head: {r.text[:120]!r}"


@dataclass
class MarketStatus:
    is_open: bool
    session: str  # "open" | "closed" | "extended-hours" | "unknown"


class PolygonFeed:
    """Live REST adapter (:171-240)."""

    BASE = "https://api.polygon.io"

    def __init__(self, symbol: str):
        if not _REQUESTS_OK:
            raise RuntimeError("requests not available; use SyntheticFeed/ReplayFeed")
        self.symbol = symbol
        self.session = requests.Session()

    def get_market_status(self, api_key: str) -> MarketStatus:
        try:
            r = self.session.get(f"{self.BASE}/v1/marketstatus/now",
                                 params={"apiKey": api_key}, timeout=6)
            if r.status_code != 200:
                return MarketStatus(False, "unknown")
            market = r.json().get("market", "closed")
            return MarketStatus(market == "open", market)
        except Exception:
            return MarketStatus(False, "unknown")

    def get_prev_close(self, api_key: str):
        url = f"{self.BASE}/v2/aggs/ticker/{self.symbol.upper()}/prev"
        try:
            r = self.session.get(url, params={"apiKey": api_key, "adjusted": "true"},
                                 timeout=6)
            if r.status_code != 200:
                return None, _http_err(r)
            results = r.json().get("results") or []
            if not results:
                return None, "prev-close response had no results"
            c = results[0].get("c")
            return (float(c) if c is not None else None), None
        except Exception as e:
            return None, str(e)

    def get_last_trade(self, api_key: str):
        url = f"{self.BASE}/v2/last/trade/{self.symbol.upper()}"
        try:
            r = self.session.get(url, params={"apiKey": api_key}, timeout=6)
            if r.status_code != 200:
                return None, None, _http_err(r)
            res = r.json().get("results") or {}
            price, t_ns = res.get("p"), res.get("t")
            if price is None or t_ns is None:
                return None, None, "last-trade payload missing p/t fields"
            return float(price), int(t_ns // 1_000_000), None
        except Exception as e:
            return None, None, str(e)

    def get_minute_bars(self, api_key: str, minutes: int = 60):
        end = int(time.time()) * 1000
        start = end - 24 * 60 * 60 * 1000
        url = (f"{self.BASE}/v2/aggs/ticker/{self.symbol.upper()}"
               f"/range/1/minute/{start}/{end}")
        try:
            r = self.session.get(
                url,
                params={"apiKey": api_key, "adjusted": "true", "sort": "asc",
                        "limit": 5000},
                timeout=10,
            )
            if r.status_code != 200:
                return [], _http_err(r)
            results = r.json().get("results") or []
            bars = [
                {"t": b["t"], "o": b["o"], "h": b["h"], "l": b["l"], "c": b["c"],
                 "v": b.get("v", 0.0)}
                for b in results
                if all(k in b for k in ("t", "o", "h", "l", "c"))
            ]
            return bars[-minutes:], (None if bars else "No minute bars returned")
        except Exception as e:
            return [], str(e)


class SyntheticFeed:
    """Deterministic GBM tick source for offline runs and tests (same interface)."""

    def __init__(self, symbol: str, *, s0: float = 100.0, sigma: float = 0.2,
                 seed: int = 0, tick_ms: int = 700, start_ms: Optional[int] = None):
        self.symbol = symbol
        self.s0 = s0
        self.sigma = sigma
        self.tick_ms = tick_ms
        self._i = 0
        self._price = s0
        self._t = int(time.time() * 1000) if start_ms is None else start_ms
        self._state = seed & 0xFFFFFFFF

    def _next_u(self) -> float:
        # xorshift32 — deterministic, stdlib-free
        x = self._state or 1
        x ^= (x << 13) & 0xFFFFFFFF
        x ^= x >> 17
        x ^= (x << 5) & 0xFFFFFFFF
        self._state = x
        return x / 0xFFFFFFFF

    def get_market_status(self, api_key: str = "") -> MarketStatus:
        return MarketStatus(True, "open")

    def get_prev_close(self, api_key: str = ""):
        return self.s0, None

    def get_last_trade(self, api_key: str = ""):
        u1 = max(self._next_u(), 1e-12)
        u2 = self._next_u()
        z = math.sqrt(-2.0 * math.log(u1)) * math.cos(2 * math.pi * u2)
        dt = 1.0 / (390.0 * 252.0) * (self.tick_ms / 60_000.0)
        self._price *= math.exp(self.sigma * math.sqrt(dt) * z)
        self._t += self.tick_ms
        self._i += 1
        return round(self._price, 2), self._t, None

    def get_minute_bars(self, api_key: str = "", minutes: int = 60):
        return [], "synthetic feed has no history"


class ReplayFeed:
    """Serve recorded (ts_ms, price) prints — the audit-replay fixture feed."""

    def __init__(self, symbol: str, prints: list[tuple[int, float]]):
        self.symbol = symbol
        self.prints = prints
        self._i = 0

    def get_market_status(self, api_key: str = "") -> MarketStatus:
        return MarketStatus(self._i < len(self.prints), "open")

    def get_prev_close(self, api_key: str = ""):
        return (self.prints[0][1], None) if self.prints else (None, "empty")

    def get_last_trade(self, api_key: str = ""):
        if self._i >= len(self.prints):
            return None, None, "exhausted"
        ts, px = self.prints[self._i]
        self._i += 1
        return px, ts, None

    def get_minute_bars(self, api_key: str = "", minutes: int = 60):
        return [], "replay feed serves prints only"
