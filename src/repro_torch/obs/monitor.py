"""Streaming Monitor — SLOs and security posture, evaluated per step.

One ``Monitor`` per gateway.  Each ``gateway.step()`` ends with
``monitor.observe(sample)`` where the sample carries the three signal
sources the rules read:

  * ``slo``      — instantaneous windowed-metric values (TTFT p95, token
    p95, tok/s, pool occupancy %) plus per-metric observation counts;
  * the audit chain — the Monitor holds the gateway's ``AuditLog`` and
    folds *new* records in incrementally (a cursor, never a rescan), so
    tamper storms and launch_reject spikes are detected online at O(new
    records) per step;
  * ``headroom`` — trusted-side budget reports (per-page nonce spans,
    reseal lanes, store capacity) from ``PagedKVPool.headroom()`` and
    friends.

Fired alerts are recorded (``alerts``), counted into the shared
``MetricsRegistry`` (``monitor_alerts_total{rule=,severity=}``) and
dispatched on the **action bus**: ``monitor.on("quarantine", handler)``
registers a handler for alerts tagged with that action.  The gateway wires
quarantine (drain + refuse admission), spill (proactive preemption) and
renonce (early page close/re-seal) — see serve/gateway.py.

A (rule, tenant) pair is rate-limited to one firing per
``config.cooldown_steps`` so a persisting condition (occupancy pinned
above the watermark) nags instead of screaming every step.

Per-tenant *posture* is derived from the audit stream itself — tamper and
launch_reject counts, quarantine state — so an offline reader of the
exported chain reconstructs exactly what the live Monitor saw.
"""
from __future__ import annotations

import dataclasses
from collections import deque

from . import rules as rules_lib
from .rules import Alert, MonitorConfig, default_rules

# audit kinds folded into per-tenant posture counters
_POSTURE_KINDS = ("tamper", "launch_reject", "quarantine_reject")


@dataclasses.dataclass
class Sample:
    """One step's worth of monitor input (audit records come via the
    Monitor's own cursor, not the sample)."""
    step: int
    slo: dict = dataclasses.field(default_factory=dict)
    counts: dict = dataclasses.field(default_factory=dict)
    headroom: list = dataclasses.field(default_factory=list)


class Monitor:
    def __init__(self, config: MonitorConfig | None = None, rules=None,
                 registry=None, audit=None):
        self.config = config or MonitorConfig()
        self.rules = list(rules) if rules is not None \
            else default_rules(self.config)
        self.registry = registry
        self.audit = audit
        self.alerts: list[Alert] = []
        self.step = 0
        self._handlers: dict[str, list] = {}
        self._audit_cursor = 0
        # sliding event window for storm rules: (step, kind, tenant)
        self._events: deque = deque()
        self._event_horizon = max(
            [r.window_steps for r in self.rules
             if isinstance(r, rules_lib.StormRule)] or [1])
        # per-metric burn-rate windows for windowed SloRules
        self._windows: dict[str, deque] = {}
        self._last_fired: dict[tuple, int] = {}
        self._last_chain_check = 0
        self._chain_report = None
        self._posture: dict[str, dict] = {}

    # -- action bus ------------------------------------------------------
    def on(self, action: str, handler) -> None:
        """Register ``handler(alert)`` for alerts tagged ``action``."""
        self._handlers.setdefault(action, []).append(handler)

    # -- rule context helpers (called by Rule.evaluate) ------------------
    def window_value(self, metric: str, window: int) -> float | None:
        buf = self._windows.get(metric)
        if not buf:
            return None
        tail = list(buf)[-window:]
        return sum(tail) / len(tail)

    def event_counts(self, kind: str, window_steps: int,
                     per_tenant: bool = True) -> dict:
        floor = self.step - window_steps
        counts: dict = {}
        for step, k, tenant in self._events:
            if k != kind or step <= floor:
                continue
            key = tenant if per_tenant else None
            counts[key] = counts.get(key, 0) + 1
        return counts

    def chain_check(self, every: int) -> dict | None:
        """Periodic verify_chain; returns the last report when due."""
        if self.audit is None:
            return None
        if (self.step - self._last_chain_check < every
                and self._chain_report is not None):
            return self._chain_report
        self._last_chain_check = self.step
        self._chain_report = self.audit.verify_chain()
        return self._chain_report

    # -- audit folding ---------------------------------------------------
    def _fold_audit(self) -> None:
        if self.audit is None:
            return
        new = self.audit.records[self._audit_cursor:]
        self._audit_cursor += len(new)
        for rec in new:
            kind, tenant = rec["kind"], rec.get("tenant")
            self._events.append((self.step, kind, tenant))
            if tenant is not None:
                post = self._posture.setdefault(
                    tenant, {k: 0 for k in _POSTURE_KINDS}
                    | {"alerts": 0, "quarantined": False})
                if kind in _POSTURE_KINDS:
                    post[kind] += 1
                elif kind == "quarantine":
                    post["quarantined"] = True
                    self._set_quarantine_gauge(tenant, 1)
                elif kind == "quarantine_release":
                    post["quarantined"] = False
                    self._set_quarantine_gauge(tenant, 0)
        horizon = self.step - self._event_horizon
        while self._events and self._events[0][0] <= horizon:
            self._events.popleft()

    def _set_quarantine_gauge(self, tenant: str, v: int) -> None:
        if self.registry is not None:
            self.registry.gauge("tenant_quarantined",
                                "1 while the tenant is quarantined",
                                windowed=False, tenant=tenant).set(v)

    # -- the step --------------------------------------------------------
    def observe(self, step: int, slo: dict | None = None,
                counts: dict | None = None,
                headroom: list | None = None) -> list[Alert]:
        """Evaluate every rule against this step's sample; returns the
        alerts that fired (after cooldown), having already dispatched
        their actions."""
        self.step = step
        self._fold_audit()
        sample = Sample(step=step, slo=slo or {}, counts=counts or {},
                        headroom=headroom or [])
        for metric, value in sample.slo.items():
            if value is None:
                continue
            buf = self._windows.setdefault(metric, deque(maxlen=256))
            buf.append(float(value))
        fired: list[Alert] = []
        for rule in self.rules:
            for alert in rule.evaluate(sample, self):
                key = (alert.rule, alert.tenant,
                       alert.detail.get("id"))
                last = self._last_fired.get(key)
                if last is not None and \
                        step - last < self.config.cooldown_steps:
                    continue
                self._last_fired[key] = step
                fired.append(alert)
        for alert in fired:
            self._record(alert)
        # dispatch after recording: a handler that appends audit records
        # (quarantine) must see its own alert already in the history
        for alert in fired:
            for handler in self._handlers.get(alert.action or "", []):
                handler(alert)
        return fired

    def _record(self, alert: Alert) -> None:
        self.alerts.append(alert)
        if alert.tenant is not None:
            post = self._posture.setdefault(
                alert.tenant, {k: 0 for k in _POSTURE_KINDS}
                | {"alerts": 0, "quarantined": False})
            post["alerts"] += 1
        if self.registry is not None:
            self.registry.counter(
                "monitor_alerts_total", "alerts fired by the monitor",
                rule=alert.rule, severity=alert.severity).inc()
        if self.audit is not None and \
                alert.severity in (rules_lib.WARNING, rules_lib.CRITICAL):
            self.audit.append("alert", tenant=alert.tenant,
                              rule=alert.rule, severity=alert.severity,
                              step=alert.step, value=alert.value,
                              threshold=alert.threshold,
                              message=alert.message)

    # -- read surface ----------------------------------------------------
    def alerts_of(self, rule: str, tenant: str | None = None) -> list[Alert]:
        return [a for a in self.alerts
                if a.rule == rule
                and (tenant is None or a.tenant == tenant)]

    def posture(self) -> dict:
        """{tenant: {"tamper", "launch_reject", "quarantine_reject",
        "alerts", "quarantined"}} — derived purely from the audit stream
        plus fired alerts, so offline replay of the chain reconstructs it."""
        self._fold_audit()
        return {t: dict(p) for t, p in sorted(self._posture.items())}

    def quarantined(self) -> set:
        return {t for t, p in self._posture.items() if p["quarantined"]}
