"""MetricsRegistry — typed counters / gauges / histograms in one place.

Replaces the stat dicts that used to be scattered across the serving stack
(``gateway._token_latency_ms`` / ``_per_tenant`` / ``_occupancy_sum``,
``scheduler.swap_stats`` / ``prefill_stats``, ``pool.stats``) with one
registry the gateway snapshots:

  * ``Counter``   — monotone within a measurement window (``inc``);
  * ``Gauge``     — last-written value (``set`` / ``set_max``);
  * ``Histogram`` — observation list with count / sum / mean and
    **nearest-rank** percentiles (the previous ad-hoc
    ``lat[int(p * len(lat))]`` indexing biased small windows low — e.g. it
    returned the 3rd-smallest of 4 values as the p50);
  * label sets — ``registry.counter("tokens_total", tenant="a")`` is an
    independent child per label set, flattened in snapshots as
    ``tokens_total{tenant="a"}``.

Windowing: ``registry.reset()`` starts a fresh measurement window by
resetting every metric registered with ``windowed=True`` (the default) and
leaving lifetime metrics (allocator totals, peak gauges) alone — so the
owning objects no longer need hand-written reset code that must mirror
their init literals.

``to_prometheus()`` renders the whole registry in the Prometheus text
exposition format (histograms as summaries: ``{quantile=...}`` series plus
``_sum`` / ``_count``).
"""
from __future__ import annotations

import math
from collections.abc import MutableMapping


class MetricError(ValueError):
    pass


def escape_label_value(v) -> str:
    """Prometheus exposition escaping for label values: backslash, double
    quote and newline must be escaped or the sample line is unparseable."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """HELP text escaping per the exposition format (backslash, newline)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _label_string(pairs) -> str:
    return ",".join(f'{k}="{escape_label_value(v)}"' for k, v in pairs)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "", windowed: bool = True,
                 labels: tuple = ()):
        self.name = name
        self.help = help
        self.windowed = windowed
        self.labels = labels            # tuple of (key, value) pairs

    def label_suffix(self) -> str:
        if not self.labels:
            return ""
        return "{" + _label_string(self.labels) + "}"

    def reset(self) -> None:            # pragma: no cover - overridden
        raise NotImplementedError


class Counter(_Metric):
    kind = "counter"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise MetricError(f"counter {self.name}: negative inc {n}")
        self.value += n

    def set(self, v) -> None:
        """Direct write — the dict-view compatibility path only."""
        self.value = v

    def reset(self) -> None:
        self.value = 0


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def set_max(self, v) -> None:
        self.value = max(self.value, v)

    def reset(self) -> None:
        self.value = 0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._values: list[float] = []
        self._sorted = True

    def observe(self, v: float) -> None:
        if self._values and v < self._values[-1]:
            self._sorted = False
        self._values.append(float(v))

    @property
    def count(self) -> int:
        return len(self._values)

    @property
    def sum(self) -> float:
        return float(sum(self._values))

    @property
    def mean(self) -> float:
        return self.sum / self.count if self._values else 0.0

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile, p in (0, 1].

        rank = ceil(p * n) (1-based) — the smallest value such that at
        least p of the observations are <= it.  Exact for every window
        size: the p50 of one observation is that observation, the p50 of
        [1, 2, 3, 4] is 2, the p100 is the maximum.
        """
        if not self._values:
            return 0.0
        if not self._sorted:
            self._values.sort()
            self._sorted = True
        n = len(self._values)
        rank = max(1, min(n, math.ceil(p * n)))
        return self._values[rank - 1]

    @property
    def value(self):
        """Snapshot value of a histogram is its observation count."""
        return self.count

    def reset(self) -> None:
        self._values.clear()
        self._sorted = True


class MetricsRegistry:
    """Name -> metric map with get-or-create typed accessors."""

    QUANTILES = (0.5, 0.95, 0.99)

    def __init__(self):
        self._metrics: dict[tuple, _Metric] = {}

    # -- typed get-or-create --------------------------------------------
    def _get(self, cls, name: str, help: str, windowed: bool,
             labels: dict) -> _Metric:
        label_items = tuple(sorted(labels.items()))
        key = (name, label_items)
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, help=help, windowed=windowed, labels=label_items)
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise MetricError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "", windowed: bool = True,
                **labels) -> Counter:
        return self._get(Counter, name, help, windowed, labels)

    def gauge(self, name: str, help: str = "", windowed: bool = True,
              **labels) -> Gauge:
        return self._get(Gauge, name, help, windowed, labels)

    def histogram(self, name: str, help: str = "", windowed: bool = True,
                  **labels) -> Histogram:
        return self._get(Histogram, name, help, windowed, labels)

    # -- introspection ---------------------------------------------------
    def metrics(self) -> list[_Metric]:
        return list(self._metrics.values())

    def family(self, name: str) -> dict[tuple, _Metric]:
        """Every label set registered under ``name``."""
        return {labels: m for (n, labels), m in self._metrics.items()
                if n == name}

    def snapshot(self) -> dict:
        """Flat {name or name{labels}: value} view of every metric."""
        return {m.name + m.label_suffix(): m.value
                for m in self._metrics.values()}

    # -- windowing -------------------------------------------------------
    def reset(self) -> None:
        """Start a fresh measurement window: reset every windowed metric."""
        for m in self._metrics.values():
            if m.windowed:
                m.reset()

    # -- exposition ------------------------------------------------------
    def to_prometheus(self) -> str:
        """Prometheus text exposition of the whole registry."""
        by_name: dict[str, list[_Metric]] = {}
        for m in self._metrics.values():
            by_name.setdefault(m.name, []).append(m)
        lines = []
        for name in sorted(by_name):
            group = by_name[name]
            kind = group[0].kind
            # HELP/TYPE are per *family*: emitted once even when many label
            # sets exist, taking the first non-empty help text registered
            # (children created via labels=... often omit it)
            help_text = next((m.help for m in group if m.help), "")
            if help_text:
                lines.append(f"# HELP {name} {_escape_help(help_text)}")
            lines.append(f"# TYPE {name} "
                         f"{'summary' if kind == 'histogram' else kind}")
            for m in group:
                if isinstance(m, Histogram):
                    for q in self.QUANTILES:
                        ql = list(m.labels) + [("quantile", q)]
                        lines.append(f"{name}{{{_label_string(ql)}}} "
                                     f"{m.percentile(q)}")
                    lines.append(f"{name}_sum{m.label_suffix()} {m.sum}")
                    lines.append(f"{name}_count{m.label_suffix()} {m.count}")
                else:
                    lines.append(f"{name}{m.label_suffix()} {m.value}")
        return "\n".join(lines) + "\n"


class StatsView(MutableMapping):
    """Dict-style view over a fixed set of registry metrics.

    Keeps the historical ``pool.stats["allocs"]`` / ``scheduler.swap_stats``
    read (and write) surface working while the values live in the registry.
    ``mapping`` is {legacy key: metric name}; all metrics must already be
    registered (label-less).
    """

    def __init__(self, registry: MetricsRegistry, mapping: dict[str, str]):
        self._registry = registry
        self._mapping = dict(mapping)

    def _metric(self, key: str) -> _Metric:
        try:
            return self._registry._metrics[(self._mapping[key], ())]
        except KeyError:
            raise KeyError(key) from None

    def __getitem__(self, key: str):
        return self._metric(key).value

    def __setitem__(self, key: str, value) -> None:
        self._metric(key).set(value)

    def __delitem__(self, key: str) -> None:
        raise MetricError("stats keys are fixed; cannot delete")

    def __iter__(self):
        return iter(self._mapping)

    def __len__(self) -> int:
        return len(self._mapping)

    def __repr__(self) -> str:
        return f"StatsView({dict(self)})"
