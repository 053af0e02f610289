"""Terminal posture dashboard — SLOs, alerts, per-tenant posture, audit tail.

Two entry paths share this renderer:

  * in-process: ``render_gateway(gw)`` reads the live gateway (its
    registry, Monitor and AuditLog) — ``repro_torch.launch.serve --watch N``
    prints it to stderr every N steps;
  * offline: ``tools/obs_dash.py METRICS.prom AUDIT.jsonl`` parses a saved
    Prometheus exposition (``gateway.metrics_text()``) plus an exported
    audit log and renders the same snapshot from files alone.

``parse_prometheus`` is the inverse of ``MetricsRegistry.to_prometheus()``
including label-value escape sequences (``\\``, ``\"``, ``\n``) — it
exists here (not in tools/) so the escaping round-trip is testable against
the registry in one process.
"""
from __future__ import annotations

import json

_SEVERITY_MARK = {"info": "·", "warning": "!", "critical": "!!"}


def _unescape_label(v: str) -> str:
    out, i = [], 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt, c + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_labels(inner: str) -> dict:
    """Parse `k="v",k2="v2"` respecting escaped quotes inside values."""
    labels: dict = {}
    i = 0
    while i < len(inner):
        eq = inner.index("=", i)
        key = inner[i:eq].strip().lstrip(",").strip()
        assert inner[eq + 1] == '"', f"malformed label value at {inner[eq:]}"
        j = eq + 2
        raw = []
        while inner[j] != '"':
            if inner[j] == "\\":
                raw.append(inner[j:j + 2])
                j += 2
            else:
                raw.append(inner[j])
                j += 1
        labels[key] = _unescape_label("".join(raw))
        i = j + 1
    return labels


def parse_prometheus(text: str) -> dict:
    """Exposition text -> {name: [(labels dict, value), ...]} (samples
    only; HELP/TYPE comment lines are skipped)."""
    families: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, value_part = line.rpartition(" ")
        if "{" in name_part:
            name, _, rest = name_part.partition("{")
            labels = _parse_labels(rest.rstrip("}"))
        else:
            name, labels = name_part, {}
        try:
            value = float(value_part)
        except ValueError:
            continue
        families.setdefault(name, []).append((labels, value))
    return families


def load_audit_jsonl(path: str) -> list[dict]:
    """Records (trailer excluded) of an exported audit log; malformed
    lines are skipped — the dash is a viewer, not a verifier."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and rec.get("kind") != "_trailer":
                records.append(rec)
    return records


def _fam_value(families: dict, name: str, **labels) -> float | None:
    for lbl, v in families.get(name, []):
        if all(lbl.get(k) == str(w) for k, w in labels.items()):
            return v
    return None


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float) and not v.is_integer():
        return f"{v:.2f}"
    return str(int(v))


def render(families: dict, audit_records: list[dict],
           alerts: list | None = None, posture: dict | None = None,
           slo_bounds: dict | None = None, tail: int = 8,
           step: int | None = None) -> str:
    """One terminal snapshot.  ``families`` from ``parse_prometheus``;
    ``alerts``/``posture`` come from a live Monitor when available and are
    otherwise reconstructed from the audit records."""
    lines = []
    head = "== secure-gateway posture"
    if step is not None:
        head += f" @ step {step}"
    lines.append(head + " ==")

    # -- SLOs ------------------------------------------------------------
    slo_bounds = slo_bounds or {}
    slo_rows = [
        ("ttft_p95_ms", _fam_value(families, "request_ttft_ms",
                                   quantile=0.95)),
        ("token_p95_ms", _fam_value(families, "token_latency_ms",
                                    quantile=0.95)),
        ("occupancy_pct", (lambda v: None if v is None else 100.0 * v)(
            _fam_value(families, "pool_occupancy_ratio", quantile=0.5))),
        ("steps", _fam_value(families, "gateway_steps_total")),
    ]
    lines.append("slo:")
    for name, value in slo_rows:
        bound = slo_bounds.get(name)
        verdict = ""
        if bound is not None and value is not None:
            verdict = "  BREACH" if value > bound else "  ok"
            verdict += f" (bound {_fmt(bound)})"
        lines.append(f"  {name:<16} {_fmt(value):>10}{verdict}")

    # -- sealed prefix cache ---------------------------------------------
    hits = _fam_value(families, "prefix_hits_total")
    misses = _fam_value(families, "prefix_misses_total")
    if hits is not None or misses is not None:
        hits, misses = hits or 0, misses or 0
        rate = 100.0 * hits / (hits + misses) if (hits + misses) else 0.0
        lines.append(
            "prefix cache: "
            f"published={_fmt(_fam_value(families, 'prefix_published_total'))}"
            f" hits={_fmt(hits)} misses={_fmt(misses)}"
            f" hit_rate={rate:.1f}%"
            f" pages_saved={_fmt(_fam_value(families, 'prefix_pages_saved_total'))}"
            f" cow_breaks={_fmt(_fam_value(families, 'kv_pool_cow_breaks_total'))}")

    # -- per-phase cost attribution (profiler + CostLedger) ---------------
    calls_fam = families.get("profiler_phase_calls_total", [])
    if calls_fam:
        lines.append("cost:")
        dps = _fam_value(families, "profiler_dispatches_per_step")
        if dps is not None:
            lines.append(f"  dispatches/step @ max occupancy: {dps:.2f}")
        lines.append(f"  {'phase':<16}{'calls':>7}{'disp':>7}"
                     f"{'wall_ms':>9}{'sealed_B':>10}")
        phases = sorted(lbl.get("phase", "?") for lbl, _ in calls_fam)
        for ph in phases:
            calls = _fam_value(families, "profiler_phase_calls_total",
                               phase=ph) or 0
            disp = _fam_value(families, "profiler_phase_dispatches_total",
                              phase=ph) or 0
            wall = _fam_value(families, "profiler_phase_wall_us_total",
                              phase=ph) or 0.0
            sealed = sum(v for lbl, v
                         in families.get("cost_sealed_bytes_total", [])
                         if lbl.get("phase") == ph)
            lines.append(f"  {ph:<16}{_fmt(calls):>7}{_fmt(disp):>7}"
                         f"{wall / 1e3:>9.2f}{_fmt(sealed):>10}")

    # -- per-tenant posture ---------------------------------------------
    if posture is None:
        posture = {}
        for rec in audit_records:
            t = rec.get("tenant")
            if t is None:
                continue
            p = posture.setdefault(t, {"tamper": 0, "launch_reject": 0,
                                       "quarantine_reject": 0, "alerts": 0,
                                       "quarantined": False})
            kind = rec.get("kind")
            if kind in ("tamper", "launch_reject", "quarantine_reject"):
                p[kind] += 1
            elif kind == "alert":
                p["alerts"] += 1
            elif kind == "quarantine":
                p["quarantined"] = True
            elif kind == "quarantine_release":
                p["quarantined"] = False
    lines.append("tenants:")
    lines.append(f"  {'tenant':<14}{'tokens':>8}{'tamper':>8}"
                 f"{'rejects':>9}{'alerts':>8}  status")
    tokens = {lbl.get("tenant"): v
              for lbl, v in families.get("tokens_total", [])}
    for t in sorted(set(posture) | set(k for k in tokens if k)):
        p = posture.get(t, {})
        status = "QUARANTINED" if p.get("quarantined") else "ok"
        rejects = (p.get("launch_reject", 0)
                   + p.get("quarantine_reject", 0))
        lines.append(f"  {t:<14}{_fmt(tokens.get(t)):>8}"
                     f"{_fmt(p.get('tamper', 0)):>8}{_fmt(rejects):>9}"
                     f"{_fmt(p.get('alerts', 0)):>8}  {status}")
    if not posture and not tokens:
        lines.append("  (none)")

    # -- alerts ----------------------------------------------------------
    if alerts is None:
        alerts = [r for r in audit_records if r.get("kind") == "alert"]
        rows = [(r["detail"].get("severity", "?"), r["detail"].get("rule"),
                 r.get("tenant"), r["detail"].get("message", ""))
                for r in alerts]
    else:
        rows = [(a.severity, a.rule, a.tenant, a.message) for a in alerts]
    lines.append(f"alerts ({len(rows)} total):")
    for sev, rule, tenant, msg in rows[-tail:]:
        mark = _SEVERITY_MARK.get(sev, "?")
        who = f" [{tenant}]" if tenant else ""
        lines.append(f"  {mark:>2} {sev:<8} {rule}{who}: {msg}")
    if not rows:
        lines.append("  (none)")

    # -- audit tail ------------------------------------------------------
    lines.append(f"audit tail (of {len(audit_records)} records):")
    for rec in audit_records[-tail:]:
        t = rec.get("tenant") or "-"
        lines.append(f"  #{rec.get('seq', '?'):>4} {rec.get('kind'):<18} {t}")
    if not audit_records:
        lines.append("  (empty)")
    return "\n".join(lines)


def render_gateway(gw, tail: int = 8) -> str:
    """Snapshot of a live gateway (registry + Monitor + AuditLog)."""
    families = parse_prometheus(gw.metrics_text())
    mon = getattr(gw, "monitor", None)
    alerts = mon.alerts if mon is not None else None
    posture = mon.posture() if mon is not None else None
    bounds = {}
    if mon is not None:
        cfg = mon.config
        if cfg.ttft_p95_ms > 0:
            bounds["ttft_p95_ms"] = cfg.ttft_p95_ms
        if cfg.token_p95_ms > 0:
            bounds["token_p95_ms"] = cfg.token_p95_ms
        bounds["occupancy_pct"] = cfg.occupancy_high_pct
    return render(families, gw.audit.records, alerts=alerts,
                  posture=posture, slo_bounds=bounds, tail=tail,
                  step=mon.step if mon is not None else None)
