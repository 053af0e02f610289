#!/usr/bin/env python
"""Offline verifier for an exported hash-chained audit log.

Checks a ``gateway.export_audit`` JSONL file — per-record HMAC chain,
signed trailer, head and count — with the *derived* verification key
(``BENCH_audit.key``; it grants audit verification without revealing the
provider session key):

    python tools/verify_audit_torch.py BENCH_audit.jsonl BENCH_audit.key

Exit status (machine-readable for CI gates and alert pipelines):

    0   chain + trailer verify
    1   chain broken (a record was edited, reordered, inserted or forged)
    2   trailer-level failure (missing/forged trailer, count or head
        mismatch — i.e. truncation or out-of-band tail rewrites)
    3   could not even try: unreadable file or malformed key

``--quiet`` suppresses the report line (the exit code is the answer).
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.obs import verify_jsonl  # noqa: E402

EXIT_OK = 0
EXIT_CHAIN = 1
EXIT_TRAILER = 2
EXIT_IO = 3


def classify(report: dict) -> int:
    """Map a verify_jsonl report to an exit code."""
    if report["ok"]:
        return EXIT_OK
    # an identified bad record index means the chain itself broke; every
    # trailer-level failure (stripped/forged trailer, count/head mismatch)
    # verifies all surviving records but cannot place a first_bad
    return EXIT_CHAIN if report["first_bad"] is not None else EXIT_TRAILER


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="verify an exported audit chain (see module docstring "
                    "for the exit-code contract)")
    ap.add_argument("log", help="JSONL export (gateway.export_audit)")
    ap.add_argument("key", help="hex verification key file (K_audit)")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="no report line; exit code only")
    args = ap.parse_args(argv)

    def say(msg: str) -> None:
        if not args.quiet:
            print(msg)

    try:
        with open(args.key) as f:
            audit_key = bytes.fromhex(f.read().strip())
        if not audit_key:
            raise ValueError("empty key file")
        report = verify_jsonl(args.log, audit_key)
    except (OSError, ValueError) as e:
        say(f"{args.log}: ERROR — {e}")
        return EXIT_IO
    rc = classify(report)
    if rc == EXIT_OK:
        say(f"{args.log}: OK — {report['records']} records, "
            "chain + trailer verify")
        return rc
    where = (f" at record {report['first_bad']}"
             if report["first_bad"] is not None else "")
    say(f"{args.log}: FAILED{where} — {report['reason']}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
