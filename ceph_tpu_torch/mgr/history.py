"""Metrics history: bounded time-bucketed sample rings per
(daemon, metric) inside the mgr's DaemonStateIndex.

Every instrument so far reports an instantaneous gauge or a whole-run
aggregate; the questions the next roadmap items are graded on ("client
p99 DURING the rebalance", time-to-recover after a storm) are about
shape over time. This store samples the already-merged MMgrReport
counter state at a fixed cadence — no new wire traffic, no daemon-side
cost — into one deque per (daemon, metric), and answers windowed
queries: rates from cumulative counters, last/min/max for gauges, and
p50/p99-over-window recomputed from the merge-compatible power-of-two
histogram buckets (bucket counts are cumulative, so the window's
distribution is simply newest-minus-oldest, bucket-wise).

Memory is bounded three ways: samples per series (mgr_history_slots),
total distinct series (mgr_history_max_series; overflow series are
counted, not stored), and histogram samples store only the bucket
dict. A daemon-side `perf reset` shows up here as a cumulative counter
moving BACKWARDS — the store drops that daemon's history rather than
reporting negative rates (the reset-scrape contract).
"""
from __future__ import annotations

import time


def bucket_quantile_ms(buckets: dict[int, int], q: float) -> float:
    """Quantile upper bound (ms) from power-of-two µs buckets: the
    smallest bucket bound below which >= q of the samples fall. Bucket
    exp i counts latencies in [2^i, 2^(i+1)) µs, so the bound quoted
    is 2^(i+1) µs — the same `le` edge the exporter's cumulative
    histograms use."""
    total = sum(buckets.values())
    if not total:
        return 0.0
    want = q * total
    cum = 0
    for exp in sorted(buckets):
        cum += buckets[exp]
        if cum >= want:
            return round(2 ** (exp + 1) / 1e3, 3)
    return round(2 ** (max(buckets) + 1) / 1e3, 3)


def _bucket_counts(value: dict) -> dict[int, int]:
    """Normalize a histogram counter's bucket dict (perf_counters dumps
    {"2^12": n}; client tables carry bare {12: n}) to {exp: count}."""
    out: dict[int, int] = {}
    for b, n in (value.get("buckets") or {}).items():
        try:
            exp = int(b[2:]) if isinstance(b, str) and \
                b.startswith("2^") else int(b)
            out[exp] = out.get(exp, 0) + int(n)
        except (TypeError, ValueError):
            continue
    return out


class MetricsHistory:
    """The ring store. One instance per DaemonStateIndex."""

    DEFAULT_SLOTS = 120
    DEFAULT_INTERVAL_S = 1.0
    DEFAULT_MAX_SERIES = 4096

    def __init__(self, slots: int = DEFAULT_SLOTS,
                 interval_s: float = DEFAULT_INTERVAL_S,
                 max_series: int = DEFAULT_MAX_SERIES):
        self.slots = max(2, int(slots))
        self.interval_s = max(0.05, float(interval_s))
        self.max_series = max(1, int(max_series))
        # {daemon: {metric: [(mono, value), ...]}} — value is a number
        # or, for histograms, {"count", "sum", "buckets":{exp:n}}
        self._series: dict[str, dict[str, list]] = {}
        self._last_sample: dict[str, float] = {}
        self.samples_taken = 0
        self.series_dropped = 0     # overflow past max_series
        self.resets_detected = 0

    # -- write side ----------------------------------------------------------

    def configure(self, slots: int | None = None,
                  interval_s: float | None = None,
                  max_series: int | None = None) -> None:
        if slots is not None:
            self.slots = max(2, int(slots))
            for metrics in self._series.values():
                for samples in metrics.values():
                    del samples[:-self.slots]
        if interval_s is not None:
            self.interval_s = max(0.05, float(interval_s))
        if max_series is not None:
            self.max_series = max(1, int(max_series))

    def _total_series(self) -> int:
        return sum(len(m) for m in self._series.values())

    def maybe_sample(self, daemon: str, counters: dict, schema: dict,
                     now: float | None = None) -> bool:
        """Sample `daemon`'s merged counter state if its cadence is
        due. Called from DaemonStateIndex.report() — i.e. at most once
        per received report, whatever the interval."""
        now = time.monotonic() if now is None else now
        last = self._last_sample.get(daemon)
        if last is not None and now - last < self.interval_s:
            return False
        self._last_sample[daemon] = now
        metrics = self._series.setdefault(daemon, {})
        for key, value in counters.items():
            ctype = (schema.get(key) or {}).get("type") if schema \
                else None
            if isinstance(value, dict):
                if "buckets" in value or ctype == "histogram":
                    sample = {"count": value.get("count", 0),
                              "sum": value.get("sum", 0.0),
                              "buckets": _bucket_counts(value)}
                elif "avgcount" in value or ctype == "avg":
                    # an avg counter is two cumulative counters; store
                    # both so the window math can rate them
                    sample = {"count": value.get("avgcount", 0),
                              "sum": value.get("sum", 0.0)}
                else:
                    continue
            elif isinstance(value, bool) or \
                    not isinstance(value, (int, float)):
                continue
            else:
                sample = value
            samples = metrics.get(key)
            if samples is None:
                if self._total_series() >= self.max_series:
                    self.series_dropped += 1
                    continue
                samples = metrics[key] = []
            if samples and self._went_backwards(samples[-1][1], sample,
                                                ctype):
                # daemon-side perf reset: cumulative state restarted —
                # this daemon's whole history is pre-reset and must go
                # (negative rates and bucket deltas are worse than a
                # gap). Keep sampling from the fresh state.
                self.resets_detected += 1
                self.drop(daemon)
                metrics = self._series.setdefault(daemon, {})
                samples = metrics.setdefault(key, [])
            samples.append((now, sample))
            del samples[:-self.slots]
        self.samples_taken += 1
        return True

    @staticmethod
    def _went_backwards(prev, cur, ctype: str | None) -> bool:
        if ctype == "gauge":
            return False
        if isinstance(cur, dict) and isinstance(prev, dict):
            return cur.get("count", 0) < prev.get("count", 0)
        if isinstance(cur, (int, float)) and \
                isinstance(prev, (int, float)):
            return cur < prev
        return False

    def drop(self, daemon: str) -> int:
        """Forget one daemon's history (culled daemon, or its perf
        counters were reset)."""
        dropped = len(self._series.pop(daemon, {}) or {})
        self._last_sample.pop(daemon, None)
        return dropped

    def reset(self) -> int:
        n = self._total_series()
        self._series.clear()
        self._last_sample.clear()
        return n

    # -- read side -----------------------------------------------------------

    def daemons(self) -> list[str]:
        return sorted(self._series)

    def metrics(self, daemon: str | None = None) -> list[str]:
        if daemon is not None:
            return sorted(self._series.get(daemon, {}))
        names: set[str] = set()
        for metrics in self._series.values():
            names.update(metrics)
        return sorted(names)

    def series(self, metric: str, daemon: str | None = None,
               window_s: float | None = None,
               now: float | None = None) -> dict[str, list]:
        """Raw samples {daemon: [(mono, value), ...]} for one metric,
        optionally clipped to the trailing window."""
        now = time.monotonic() if now is None else now
        out: dict[str, list] = {}
        for name, metrics in sorted(self._series.items()):
            if daemon is not None and name != daemon:
                continue
            samples = metrics.get(metric)
            if not samples:
                continue
            if window_s is not None:
                samples = [s for s in samples if s[0] >= now - window_s]
            if samples:
                out[name] = list(samples)
        return out

    def query(self, metric: str, daemon: str | None = None,
              window_s: float = 60.0,
              now: float | None = None) -> dict:
        """Windowed math per daemon over one metric's ring:

        * cumulative counters -> rate/s over the window (newest minus
          oldest sample, divided by their time span);
        * histograms -> the window's own p50/p99 (bucket-wise delta of
          the cumulative bucket counts) + event count and rate;
        * avg counters -> value-per-event and event rate over the
          window;
        * gauges (anything non-cumulative) -> last/min/max/mean of the
          sampled values.
        """
        now = time.monotonic() if now is None else now
        out: dict = {"metric": metric, "window_s": window_s,
                     "daemons": {}}
        for name, samples in self.series(metric, daemon=daemon,
                                         window_s=window_s,
                                         now=now).items():
            t0, first = samples[0]
            t1, last = samples[-1]
            span = t1 - t0
            entry: dict = {"samples": len(samples),
                           "span_s": round(span, 3)}
            if isinstance(last, dict) and "buckets" in last:
                delta = dict(last["buckets"])
                for exp, n in (first.get("buckets") or {}).items():
                    delta[exp] = delta.get(exp, 0) - n
                delta = {e: n for e, n in delta.items() if n > 0}
                dn = last.get("count", 0) - first.get("count", 0)
                entry.update({
                    "count": dn,
                    "rate_per_s": round(dn / span, 3) if span else 0.0,
                    "p50_ms": bucket_quantile_ms(delta, 0.50),
                    "p99_ms": bucket_quantile_ms(delta, 0.99)})
            elif isinstance(last, dict):
                dn = last.get("count", 0) - first.get("count", 0)
                ds = last.get("sum", 0.0) - first.get("sum", 0.0)
                entry.update({
                    "count": dn,
                    "rate_per_s": round(dn / span, 3) if span else 0.0,
                    "avg": round(ds / dn, 6) if dn else 0.0})
            else:
                values = [v for _t, v in samples]
                entry.update({"last": last, "min": min(values),
                              "max": max(values),
                              "mean": round(sum(values)
                                            / len(values), 6)})
                # a monotonically non-decreasing numeric series is (by
                # the sampling contract) a cumulative counter: give the
                # windowed rate too
                if span and all(b >= a for a, b in
                                zip(values, values[1:])):
                    entry["rate_per_s"] = round(
                        (last - first) / span, 3)
            out["daemons"][name] = entry
        return out

    def sparkline_data(self, limit: int = 12,
                       window_s: float = 120.0) -> list[dict]:
        """Dashboard feed: the most recently moving series, each as a
        short list of plottable points — windowed p99 for histograms,
        per-interval rate for cumulative counters, raw values for
        gauges."""
        now = time.monotonic()
        rows: list[tuple[float, dict]] = []
        for daemon, metrics in self._series.items():
            for metric, samples in metrics.items():
                clipped = [s for s in samples if s[0] >= now - window_s]
                if len(clipped) < 2:
                    continue
                points = self._points(clipped)
                if points is None or len(points) < 2:
                    continue
                rows.append((clipped[-1][0],
                             {"daemon": daemon, "metric": metric,
                              "points": points,
                              "last": points[-1]}))
        rows.sort(key=lambda r: (-r[0], r[1]["daemon"],
                                 r[1]["metric"]))
        return [row for _t, row in rows[:max(0, int(limit))]]

    @staticmethod
    def _points(samples: list) -> list[float] | None:
        last = samples[-1][1]
        if isinstance(last, dict) and "buckets" in last:
            pts = []
            for (ta, a), (tb, b) in zip(samples, samples[1:]):
                delta = dict(b.get("buckets") or {})
                for exp, n in (a.get("buckets") or {}).items():
                    delta[exp] = delta.get(exp, 0) - n
                pts.append(bucket_quantile_ms(
                    {e: n for e, n in delta.items() if n > 0}, 0.99))
            return pts
        if isinstance(last, dict):
            return None
        values = [v for _t, v in samples]
        if all(b >= a for a, b in zip(values, values[1:])) \
                and values[-1] > values[0]:
            return [round((b - a) / max(tb - ta, 1e-9), 3)
                    for (ta, a), (tb, b) in zip(samples, samples[1:])]
        return [float(v) for v in values]

    def status(self) -> dict:
        return {"slots": self.slots, "interval_s": self.interval_s,
                "max_series": self.max_series,
                "series": self._total_series(),
                "daemons": len(self._series),
                "samples_taken": self.samples_taken,
                "series_dropped": self.series_dropped,
                "resets_detected": self.resets_detected}
