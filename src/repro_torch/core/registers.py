"""Rule 3 — integrity + freshness of programmer-visible launch state.

In the paper, the host program (user-mode runtime in the enclave) maintains the
accelerator's register state and, on every register write through the
*untrusted* kernel-mode software, also writes MAC(K, register_state || nonce)
to a dedicated register so the accelerator can detect tampering and replays.

There are no MMIO registers here; the programmer-visible state of a dispatch
is its *launch descriptor*: which step function, argument shapes/dtypes, the
step counter.  We MAC the canonical serialization of that descriptor with
a monotonically increasing nonce.  The device side (`DeviceRegisterFile`)
verifies the MAC and rejects non-monotonic nonces (replay).
"""
from __future__ import annotations

import dataclasses
import hashlib
import hmac
import json
from typing import Any


def canonical_descriptor(**fields: Any) -> bytes:
    """Deterministic serialization of a launch descriptor."""
    def norm(v):
        if isinstance(v, (list, tuple)):
            return [norm(x) for x in v]
        if isinstance(v, dict):
            return {k: norm(v[k]) for k in sorted(v)}
        return str(v)
    return json.dumps(norm(fields), sort_keys=True, separators=(",", ":")).encode()


def descriptor_mac(key: bytes, descriptor: bytes, nonce: int) -> bytes:
    return hmac.new(key, nonce.to_bytes(8, "big") + descriptor, hashlib.sha256).digest()


@dataclasses.dataclass
class HostRegisterFile:
    """Enclave-side mirror of the device register state (the 'runtime')."""
    key: bytes
    nonce: int = 0
    state: dict = dataclasses.field(default_factory=dict)

    def write(self, **regs: Any) -> tuple[dict, int, bytes]:
        """Update registers; return (state, nonce, mac) for the untrusted
        launch path to carry."""
        self.state.update(regs)
        self.nonce += 1
        d = canonical_descriptor(**self.state)
        return dict(self.state), self.nonce, descriptor_mac(self.key, d, self.nonce)


class ReplayError(RuntimeError):
    pass


class TamperError(RuntimeError):
    pass


@dataclasses.dataclass
class DeviceRegisterFile:
    """Accelerator-side verifier: checks MAC, enforces nonce monotonicity."""
    key: bytes
    last_nonce: int = 0

    def commit(self, state: dict, nonce: int, mac_tag: bytes) -> dict:
        if nonce <= self.last_nonce:
            raise ReplayError(f"stale nonce {nonce} (last {self.last_nonce})")
        d = canonical_descriptor(**state)
        expect = descriptor_mac(self.key, d, nonce)
        if not hmac.compare_digest(expect, mac_tag):
            raise TamperError("register-state MAC mismatch")
        self.last_nonce = nonce
        return state
