"""AuditLog — append-only, tamper-evident record of security events.

TEE deployments argue operators need *auditable* operation (GuardNN,
arXiv 2008.11632; Graphcore's confidential IPUs, arXiv 2205.09005): not just
that tampering poisons outputs, but a record — itself tamper-evident — of
every trust-relevant event.  This module is that record for the serving
stack.  Emitters and their record kinds:

    sessions.py          attest, rotate, epoch_advance
    core/channel.py      launch, launch_reject
    serve/scheduler.py   swap_out, swap_in, tamper, quarantine,
                         quarantine_reject, quarantine_release,
                         proactive_spill, prefix_map, cow_break
    serve/prefix_cache.py  prefix_publish
    serve/kv_pager.py    page_close, page_reopen, nonce_spend,
                         nonce_refresh, page_renonce
    obs/monitor.py       alert
    store/sealed_store.py  store_verify_fail, store_freshness_reject,
                           store_fsck

Tamper evidence is a running HMAC chain under a key derived from the
*provider* session key (the same root of trust that MACs launch
descriptors, Rule 3):

    digest_i = SHA256(canonical(record_i))              # content binding
    chain_i  = HMAC(K_audit, chain_{i-1} || digest_i)   # order binding
    K_audit  = HMAC(K_provider, "audit-log-v1")

Editing a record in place breaks its digest; reordering, inserting or
deleting records breaks the chain from that point on; truncating the tail
leaves a head that no longer matches the trusted-side ``head`` (in memory)
or the signed trailer (in an export).  An attacker without ``K_audit``
cannot recompute any of it.  ``K_audit`` is a *derived* verification key:
handing it to an auditor (``export_key``) grants audit-verification
capability without revealing the provider session key.

``to_jsonl`` writes one record per line plus a signed trailer line binding
(head, count), so an exported log is verifiable offline by
``tools/verify_audit.py`` — including against tail truncation, which a
bare hash chain cannot see.
"""
from __future__ import annotations

import hashlib
import hmac as hmac_lib
import json
import time

_KEY_DOMAIN = b"audit-log-v1"
GENESIS = b"\x00" * 32


class AuditError(RuntimeError):
    pass


def derive_audit_key(key_bytes: bytes) -> bytes:
    """K_audit: the delegable verification key (never the session key)."""
    return hmac_lib.new(key_bytes, _KEY_DOMAIN, hashlib.sha256).digest()


def _canonical(record: dict) -> bytes:
    core = {k: v for k, v in record.items() if k != "chain"}
    return json.dumps(core, sort_keys=True, separators=(",", ":"),
                      default=str).encode()


def record_digest(record: dict) -> bytes:
    return hashlib.sha256(_canonical(record)).digest()


def chain_step(audit_key: bytes, prev_chain: bytes, record: dict) -> bytes:
    return hmac_lib.new(audit_key, prev_chain + record_digest(record),
                        hashlib.sha256).digest()


class AuditLog:
    """Append-only in-process audit log with an HMAC record chain."""

    def __init__(self, key_bytes: bytes, clock=time.time):
        self._audit_key = derive_audit_key(key_bytes)
        self._clock = clock
        self.records: list[dict] = []
        self._head = GENESIS

    # -- write path ------------------------------------------------------
    def append(self, kind: str, tenant: str | None = None,
               **detail) -> dict:
        """Append one record; returns it (with its chain value)."""
        rec = {"seq": len(self.records), "ts": round(self._clock(), 6),
               "kind": kind, "tenant": tenant, "detail": detail}
        chain = chain_step(self._audit_key, self._head, rec)
        rec["chain"] = chain.hex()
        self._head = chain
        self.records.append(rec)
        return rec

    @property
    def head(self) -> str:
        return self._head.hex()

    def __len__(self) -> int:
        return len(self.records)

    def kinds(self) -> dict[str, int]:
        """{kind: count} — the audit log's table of contents."""
        out: dict[str, int] = {}
        for r in self.records:
            out[r["kind"]] = out.get(r["kind"], 0) + 1
        return out

    def records_of(self, kind: str, tenant: str | None = None) -> list[dict]:
        return [r for r in self.records
                if r["kind"] == kind
                and (tenant is None or r["tenant"] == tenant)]

    # -- verification ----------------------------------------------------
    def verify_chain(self) -> dict:
        """Full sweep: recompute the chain from genesis over the in-memory
        records and check it against both the per-record chain values and
        the trusted-side head.  Returns {"ok", "records", "first_bad"};
        a truncated tail surfaces as ok=False with first_bad=None (every
        surviving record verifies, but the head doesn't land where the
        trusted side says it must).
        """
        report = verify_records(self.records, self._audit_key)
        if report["ok"] and self._head.hex() != (
                self.records[-1]["chain"] if self.records
                else GENESIS.hex()):
            report = {"ok": False, "records": len(self.records),
                      "first_bad": None, "reason": "head mismatch "
                      "(records truncated or appended out of band)"}
        return report

    # -- export ----------------------------------------------------------
    def trailer(self) -> dict:
        """Signed (head, count) binding for exported logs."""
        core = {"kind": "_trailer", "count": len(self.records),
                "head": self.head}
        mac = hmac_lib.new(self._audit_key, _canonical(core),
                           hashlib.sha256).hexdigest()
        return {**core, "hmac": mac}

    def to_jsonl(self, path: str) -> int:
        """One record per line + the signed trailer line.  -> record count"""
        with open(path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec, sort_keys=True, default=str) + "\n")
            f.write(json.dumps(self.trailer(), sort_keys=True) + "\n")
        return len(self.records)

    def export_key(self, path: str | None = None) -> str:
        """The hex verification key (K_audit) for offline auditors."""
        key_hex = self._audit_key.hex()
        if path is not None:
            with open(path, "w") as f:
                f.write(key_hex + "\n")
        return key_hex


def verify_records(records: list[dict], audit_key: bytes,
                   expect_head: str | None = None,
                   expect_count: int | None = None) -> dict:
    """Recompute the chain over ``records``; first break wins.

    Returns {"ok": bool, "records": n, "first_bad": index | None,
    "reason": str | None}.  ``expect_head`` / ``expect_count`` (from a
    signed trailer or a trusted side-channel) additionally catch tail
    truncation, which chain recomputation alone cannot.
    """
    prev = GENESIS
    for i, rec in enumerate(records):
        want = chain_step(audit_key, prev, rec).hex()
        if not hmac_lib.compare_digest(want, rec.get("chain", "")):
            return {"ok": False, "records": len(records), "first_bad": i,
                    "reason": "chain break (edited, reordered or forged)"}
        prev = bytes.fromhex(rec["chain"])
    if expect_count is not None and len(records) != expect_count:
        return {"ok": False, "records": len(records), "first_bad": None,
                "reason": f"count mismatch: {len(records)} records, "
                          f"trailer says {expect_count} (truncated?)"}
    if expect_head is not None and prev.hex() != expect_head:
        return {"ok": False, "records": len(records), "first_bad": None,
                "reason": "head mismatch (tail truncated or replaced)"}
    return {"ok": True, "records": len(records), "first_bad": None,
            "reason": None}


def verify_jsonl(path: str, audit_key: bytes) -> dict:
    """Offline verification of a ``to_jsonl`` export (trailer required).

    The trailer's own HMAC is checked first — a file whose trailer was
    stripped or rewritten fails before any chain work.
    """
    records: list[dict] = []
    trailer = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                rec = None
            if not isinstance(rec, dict):
                # a scribbled-over line is an edited record: report it as
                # the first bad index instead of blowing up the verifier
                return {"ok": False, "records": len(records),
                        "first_bad": len(records),
                        "reason": "unparseable record line (edited or "
                                  "corrupted export)"}
            if rec.get("kind") == "_trailer":
                trailer = rec
            else:
                records.append(rec)
    if trailer is None:
        return {"ok": False, "records": len(records), "first_bad": None,
                "reason": "no signed trailer line (stripped or never "
                          "exported with one)"}
    core = {"kind": "_trailer", "count": trailer.get("count"),
            "head": trailer.get("head")}
    want = hmac_lib.new(audit_key, _canonical(core),
                        hashlib.sha256).hexdigest()
    if not hmac_lib.compare_digest(want, trailer.get("hmac", "")):
        return {"ok": False, "records": len(records), "first_bad": None,
                "reason": "trailer HMAC mismatch (forged trailer)"}
    return verify_records(records, audit_key,
                          expect_head=trailer["head"],
                          expect_count=trailer["count"])
