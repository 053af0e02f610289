"""Declarative monitor rules — SLOs, audit storms, trusted-side headroom.

The streaming ``Monitor`` (obs/monitor.py) evaluates a list of *rules*
against one ``Sample`` per gateway step and emits typed ``Alert``s.  Rules
are declarative dataclasses: they hold thresholds and identity, never
state — windows, cooldowns and the audit cursor live in the Monitor, so a
rule list can be rebuilt from a ``MonitorConfig`` at any time (e.g. from
``--slo`` CLI overrides) without losing history.

Three rule families, one per signal source:

  * ``SloRule``       — a windowed-metric service-level objective
    (TTFT p95, token p95, tok/s floor, pool-occupancy burn rate);
  * ``StormRule``     — audit-chain event storms within a sliding step
    window (tamper records, launch_reject spikes), attributed to the
    tenant whose records they are;
  * ``HeadroomRule``  — trusted-side budget exhaustion *before* a guard
    fails closed (per-page ``NonceSpanGuard`` spend, ``ResealCounter``
    lanes, store capacity);
  * ``ChainRule``     — periodic in-process ``verify_chain()`` sweep of
    the audit log itself.

Severities order INFO < WARNING < CRITICAL.  An alert may carry an
``action`` tag; the Monitor's action bus dispatches it to whatever handler
the gateway registered (quarantine / spill / renonce).
"""
from __future__ import annotations

import dataclasses

INFO = "info"
WARNING = "warning"
CRITICAL = "critical"
SEVERITIES = (INFO, WARNING, CRITICAL)

# action-bus tags the serving stack wires handlers for
ACT_QUARANTINE = "quarantine"   # drain + refuse admission for a tenant
ACT_SPILL = "spill"             # proactive swap-out via the preemption path
ACT_RENONCE = "renonce"         # early close/re-seal before a guard trips


def severity_rank(severity: str) -> int:
    return SEVERITIES.index(severity)


@dataclasses.dataclass(frozen=True)
class Alert:
    """One rule firing at one step.  ``tenant`` is the attributed tenant
    (None for gateway-wide conditions); ``action`` names the action-bus
    handler the Monitor dispatches; ``detail`` carries rule-specific
    context (e.g. the page id for a nonce-headroom alert)."""
    rule: str
    severity: str
    message: str
    step: int
    tenant: str | None = None
    value: float | None = None
    threshold: float | None = None
    action: str | None = None
    detail: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class SloRule:
    """value of ``metric`` must stay on the right side of ``bound``.

    ``direction``: "upper" fires when value > bound (latency SLOs),
    "lower" fires when value < bound (throughput floors).  ``window`` > 0
    evaluates the mean of the last ``window`` per-step samples (burn rate)
    instead of the instantaneous value; ``min_count`` gates on the number
    of underlying observations so a single warm-up token can't page anyone.
    """
    name: str
    metric: str
    bound: float
    direction: str = "upper"
    window: int = 0
    min_count: int = 1
    severity: str = WARNING
    action: str | None = None

    def evaluate(self, sample, mon) -> list[Alert]:
        if sample.counts.get(self.metric, 0) < self.min_count:
            return []
        value = (mon.window_value(self.metric, self.window) if self.window
                 else sample.slo.get(self.metric))
        if value is None:
            return []
        breached = (value > self.bound if self.direction == "upper"
                    else value < self.bound)
        if not breached:
            return []
        rel = "above" if self.direction == "upper" else "below"
        return [Alert(rule=self.name, severity=self.severity,
                      message=(f"{self.metric}={value:.3f} {rel} SLO bound "
                               f"{self.bound:.3f}"),
                      step=sample.step, value=float(value),
                      threshold=float(self.bound), action=self.action,
                      detail={"metric": self.metric, "window": self.window})]


@dataclasses.dataclass(frozen=True)
class StormRule:
    """>= ``threshold`` audit records of ``kind`` within the last
    ``window_steps`` gateway steps.  ``per_tenant`` counts (and attributes)
    per tenant; otherwise the storm is gateway-wide."""
    name: str
    kind: str
    threshold: int
    window_steps: int
    per_tenant: bool = True
    severity: str = CRITICAL
    action: str | None = None

    def evaluate(self, sample, mon) -> list[Alert]:
        counts = mon.event_counts(self.kind, self.window_steps,
                                  per_tenant=self.per_tenant)
        out = []
        for tenant, n in counts.items():
            if n < self.threshold:
                continue
            who = f"tenant {tenant!r}" if tenant else "gateway"
            out.append(Alert(
                rule=self.name, severity=self.severity,
                message=(f"{n} {self.kind!r} audit records from {who} in "
                         f"{self.window_steps} steps "
                         f"(threshold {self.threshold})"),
                step=sample.step, tenant=tenant, value=float(n),
                threshold=float(self.threshold), action=self.action,
                detail={"kind": self.kind,
                        "window_steps": self.window_steps}))
        return out


@dataclasses.dataclass(frozen=True)
class HeadroomRule:
    """A trusted-side budget's ``remaining`` dropped to ``min_remaining``
    or below.  ``source`` selects which headroom reports this rule reads
    ("page_nonce", "reseal_lanes", "store_capacity" — see
    ``PagedKVPool.headroom`` / ``NonceSpanGuard.headroom``)."""
    name: str
    source: str
    min_remaining: float
    severity: str = WARNING
    action: str | None = None

    def evaluate(self, sample, mon) -> list[Alert]:
        out = []
        for h in sample.headroom:
            if h.get("source") != self.source:
                continue
            # a nonce span only spends on close/reopen of a live OPEN tail:
            # closed mid-table pages never bump again, so don't page on them
            if self.source == "page_nonce" and not h.get("open", True):
                continue
            remaining = h.get("remaining")
            if remaining is None or remaining > self.min_remaining:
                continue
            out.append(Alert(
                rule=self.name, severity=self.severity,
                message=(f"{self.source} {h.get('id')}: {remaining} of "
                         f"budget left (floor {self.min_remaining})"),
                step=sample.step, tenant=h.get("tenant"),
                value=float(remaining),
                threshold=float(self.min_remaining), action=self.action,
                detail={k: v for k, v in h.items() if k != "tenant"}))
        return out


@dataclasses.dataclass(frozen=True)
class ChainRule:
    """Re-verify the audit chain in-process every ``every`` steps — an
    in-memory chain that stops verifying means the process itself is
    corrupting its evidence (or the clock of trust was tampered)."""
    name: str = "audit_chain"
    every: int = 256
    severity: str = CRITICAL
    action: str | None = None

    def evaluate(self, sample, mon) -> list[Alert]:
        report = mon.chain_check(self.every)
        if report is None or report["ok"]:
            return []
        return [Alert(rule=self.name, severity=self.severity,
                      message=f"audit chain verify failed: "
                              f"{report.get('reason')}",
                      step=sample.step, action=self.action,
                      detail={"first_bad": report.get("first_bad"),
                              "records": report.get("records")})]


@dataclasses.dataclass
class MonitorConfig:
    """Thresholds the default rule set is built from.

    Latency/throughput SLO bounds default to *disabled* (0) — what counts
    as slow is a deployment decision (``--slo ttft_p95_ms=...`` on
    ``repro_torch.launch.serve``).  The security-posture and headroom rules
    default *on*: they encode invariants of the trust model, not taste.
    """
    # windowed-metric SLOs (0 disables)
    ttft_p95_ms: float = 0.0
    token_p95_ms: float = 0.0
    tok_per_s_min: float = 0.0
    slo_min_count: int = 4
    # pool-occupancy burn rate -> proactive spill
    occupancy_high_pct: float = 95.0
    occupancy_window: int = 8
    # audit-chain storms
    tamper_storm_count: int = 3
    tamper_storm_window: int = 64
    launch_reject_count: int = 3
    launch_reject_window: int = 64
    # trusted-side headroom floors
    nonce_headroom_min: int = 1
    reseal_headroom_min: int = 4
    store_free_pct_min: float = 10.0
    # periodic in-process chain verify (0 disables)
    chain_verify_every: int = 256
    # a (rule, tenant) pair refires at most once per cooldown window
    cooldown_steps: int = 16

    def overridden(self, **kv) -> "MonitorConfig":
        """Copy with field overrides; unknown names raise."""
        for k in kv:
            if not any(f.name == k for f in dataclasses.fields(self)):
                raise ValueError(f"unknown MonitorConfig field {k!r}")
        return dataclasses.replace(self, **kv)


def parse_slo_overrides(pairs: list[str]) -> dict:
    """Parse ``--slo name=value`` CLI overrides into MonitorConfig kwargs."""
    out = {}
    fields = {f.name: f for f in dataclasses.fields(MonitorConfig)}
    for pair in pairs or []:
        name, sep, raw = pair.partition("=")
        name = name.strip()
        if not sep or name not in fields:
            known = ", ".join(sorted(fields))
            raise ValueError(f"bad --slo override {pair!r} "
                             f"(want name=value with name in: {known})")
        out[name] = type(fields[name].default)(raw)
    return out


def default_rules(cfg: MonitorConfig) -> list:
    """The standard rule set for a serving gateway."""
    rules: list = []
    if cfg.ttft_p95_ms > 0:
        rules.append(SloRule("slo_ttft_p95", "ttft_p95_ms", cfg.ttft_p95_ms,
                             min_count=cfg.slo_min_count))
    if cfg.token_p95_ms > 0:
        rules.append(SloRule("slo_token_p95", "token_p95_ms",
                             cfg.token_p95_ms, min_count=cfg.slo_min_count))
    if cfg.tok_per_s_min > 0:
        rules.append(SloRule("slo_tok_per_s", "tok_per_s",
                             cfg.tok_per_s_min, direction="lower",
                             min_count=cfg.slo_min_count))
    if cfg.occupancy_high_pct > 0:
        rules.append(SloRule("occupancy_watermark", "occupancy_pct",
                             cfg.occupancy_high_pct,
                             window=cfg.occupancy_window,
                             severity=WARNING, action=ACT_SPILL))
    if cfg.tamper_storm_count > 0:
        rules.append(StormRule("tamper_storm", "tamper",
                               cfg.tamper_storm_count,
                               cfg.tamper_storm_window,
                               severity=CRITICAL, action=ACT_QUARANTINE))
    if cfg.launch_reject_count > 0:
        rules.append(StormRule("launch_reject_spike", "launch_reject",
                               cfg.launch_reject_count,
                               cfg.launch_reject_window,
                               severity=CRITICAL))
    rules.append(HeadroomRule("nonce_headroom", "page_nonce",
                              cfg.nonce_headroom_min,
                              severity=WARNING, action=ACT_RENONCE))
    rules.append(HeadroomRule("reseal_headroom", "reseal_lanes",
                              cfg.reseal_headroom_min, severity=WARNING))
    if cfg.store_free_pct_min > 0:
        rules.append(HeadroomRule("store_capacity", "store_capacity",
                                  cfg.store_free_pct_min, severity=WARNING))
    if cfg.chain_verify_every > 0:
        rules.append(ChainRule(every=cfg.chain_verify_every))
    return rules
