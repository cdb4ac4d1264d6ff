"""The few helpers the supervised runtime needs: env knobs read per call
and the counters of the engines' stats dicts (the port's copies of the JAX
package's ``util.env_int``, ``env_float``, ``stat_bump``, ``stat_time``
and ``round_stats``)."""

from __future__ import annotations

import os


def env_int(name: str, default: int) -> int:
    """Integer env knob with a default (empty or unset gives the
    default). Read at each call, so ``monkeypatch.setenv`` and
    ``env VAR=...`` always take effect."""
    v = os.environ.get(name, "")
    return int(v) if v else default


def env_float(name: str, default: float) -> float:
    """Float twin of :func:`env_int`."""
    v = os.environ.get(name, "")
    return float(v) if v else default


def stat_bump(stats: dict, key: str, n: int = 1) -> None:
    """Add ``n`` to an integer counter of a stats dict; a missing key
    starts at 0."""
    stats[key] = stats.get(key, 0) + n


def stat_time(stats: dict, key: str, bucket, seconds: float) -> None:
    """Add wall seconds to ``stats[key][bucket]`` (a per-bucket timing
    histogram, e.g. per capacity). Raw floats: round when reporting
    (:func:`round_stats`)."""
    d = stats.setdefault(key, {})
    d[bucket] = d.get(bucket, 0.0) + seconds


def round_stats(stats: dict, ndigits: int = 2) -> dict:
    """A copy of a stats dict with its floats rounded at any depth of
    nested dicts and lists; other values as they are (tuples come back as
    lists)."""

    def rec(v):
        if isinstance(v, dict):
            return {k: rec(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [rec(x) for x in v]
        if isinstance(v, float):
            return round(v, ndigits)
        return v

    return {k: rec(v) for k, v in stats.items()}
