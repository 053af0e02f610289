"""Per-tenant session management for the multi-tenant serving gateway
(torch port of ``repro.serve.sessions``; the channels' data-plane keys live
on the manager's ``device``).

One trusted accelerator (one CA enrollment, one endorsement key) serves many
mutually-distrusting tenants.  Each tenant runs the full paper §3.2 handshake
— attestation against the manufacturer CA, then signed ephemeral DH — and
gets its *own* SecureChannel: an independent session key, a process-unique
session id (so nonce lanes never overlap; see core/channel.py) and its own
Rule-3 register files.

Key rotation: after ``rotate_every`` protected launches attributed to a
tenant, the next time that tenant is idle (no sealed pages in flight, no
swapped-out KV) the manager re-runs the DH exchange with the accelerator and
installs the new key via ``SecureChannel.rekey`` — the epoch bump makes
old-key nonces dead.

Warm state: when a SealedStore is attached, per-tenant bookkeeping (launch
counter, rotation count, last nonce epoch, last verified Rule-3 register
nonce) persists as small store objects.  A re-registered tenant restores its
counters and — critically — advances its channel's nonce epoch past the
recorded one, so a gateway restart can never re-walk nonce lanes the
previous incarnation already spent; the Rule-3 register file likewise
resumes at the last verified launch nonce instead of restarting at 0, so a
replayed pre-restart launch stream stays stale on the device side.  The
warm state holds no secrets (keys come from a fresh handshake every time).
"""
from __future__ import annotations

import dataclasses
import time

from ..core import trust
from ..core.channel import SecureChannel, resolve_device
from ..core.policy import SecurityConfig
from ..core.registers import DeviceRegisterFile, HostRegisterFile
from ..store import SealedStore, StoreError

WARM_KIND = "session_warm"
_WARM_PERSIST_EVERY = 32        # persist counters every N launches


def warm_object_id(tenant_id: str) -> str:
    return f"session/{tenant_id}"


@dataclasses.dataclass
class TenantSession:
    tenant_id: str
    channel: SecureChannel
    created_at: float
    launches: int = 0        # protected launches since the last rotation
    rotations: int = 0


class SessionManager:
    """Attestation cache + rotation policy over one shared accelerator."""

    def __init__(self, device_id: str = "gpu-0",
                 config: SecurityConfig | None = None,
                 rotate_every: int = 0,
                 store: SealedStore | None = None, device="cuda"):
        """rotate_every: rotate a tenant's key after this many launches
        (0 disables rotation).  store: optional warm-state backing tier.
        device: where every channel's data-plane key lives."""
        self.config = config or SecurityConfig()
        self.device = resolve_device(device)
        self.rotate_every = rotate_every
        self.store = store
        self.device_id = device_id
        self._ca = trust.ManufacturerCA()
        self._accel = trust.TrustedAccelerator(device_id, self._ca)
        self._sessions: dict[str, TenantSession] = {}
        self._warm_seq = 0      # monotone freshness for warm-state puts
        self._quarantined: dict[str, str] = {}   # tenant -> reason
        self.audit = None       # obs.AuditLog (attached by the gateway)

    def attach_audit(self, audit) -> None:
        """Attach the gateway's audit log; sessions registered *before* the
        log existed (the provider — its key derives the audit key) get their
        attest records emitted retroactively, in registration order."""
        self.audit = audit
        for sess in self._sessions.values():
            self._audit_attest(sess)

    def _audit_attest(self, sess: TenantSession) -> None:
        if self.audit is None:
            return
        ch = sess.channel
        ch.audit = self.audit
        ch.audit_tenant = sess.tenant_id
        self.audit.append("attest", tenant=sess.tenant_id,
                          device=self.device_id, session_id=ch.session_id,
                          epoch=ch.epoch, rotations=sess.rotations)

    # -- handshake -------------------------------------------------------
    def _handshake(self) -> tuple:
        """Run attestation + signed DH against the shared accelerator."""
        host = trust.HostProgram(self._ca)
        kbytes = host.establish(self._accel)
        return trust.session_key_to_words(kbytes), kbytes

    def register(self, tenant_id: str) -> TenantSession:
        """Idempotent: first call runs the handshake, later calls hit the
        session cache.  With a store attached, a returning tenant restores
        its warm state (counters + a nonce-epoch floor)."""
        if tenant_id in self._sessions:
            return self._sessions[tenant_id]
        key_words, key_bytes = self._handshake()
        channel = SecureChannel(
            key_words=key_words, key_bytes=key_bytes, config=self.config,
            host_regs=HostRegisterFile(key=key_bytes),
            device_regs=DeviceRegisterFile(key=key_bytes), device=self.device)
        sess = TenantSession(tenant_id=tenant_id, channel=channel,
                             created_at=time.monotonic())
        self._restore_warm_state(sess)
        self._sessions[tenant_id] = sess
        self._audit_attest(sess)
        return sess

    def get(self, tenant_id: str) -> TenantSession:
        if tenant_id not in self._sessions:
            raise KeyError(f"tenant {tenant_id!r} has no session "
                           "(call register first)")
        return self._sessions[tenant_id]

    def channel(self, tenant_id: str) -> SecureChannel:
        return self.get(tenant_id).channel

    @property
    def tenants(self) -> list[str]:
        return list(self._sessions)

    # -- quarantine ------------------------------------------------------
    def quarantine(self, tenant_id: str, reason: str = "") -> None:
        """Flag a tenant: existing session state stays (the channel still
        decrypts its own evidence), but admission is refused until
        ``release``.  Idempotent; the scheduler drains in-flight work."""
        self._quarantined[tenant_id] = reason

    def release(self, tenant_id: str) -> bool:
        """Lift a quarantine; returns whether one was in force."""
        return self._quarantined.pop(tenant_id, None) is not None

    def is_quarantined(self, tenant_id: str) -> bool:
        return tenant_id in self._quarantined

    def quarantine_reason(self, tenant_id: str) -> str | None:
        return self._quarantined.get(tenant_id)

    @property
    def quarantined(self) -> list[str]:
        return sorted(self._quarantined)

    # -- warm state (store-backed) ---------------------------------------
    def _restore_warm_state(self, sess: TenantSession) -> None:
        """Best-effort: the warm tier is untrusted bookkeeping (a fresh
        handshake cannot verify a pre-restart HMAC), so anything malformed —
        corrupt chunks, non-numeric counters, an epoch forged past the nonce
        space — makes the session start cold instead of crashing register().
        A forged-but-valid epoch only wastes epoch space, never reuses it."""
        if self.store is None or not self.store.exists(
                warm_object_id(sess.tenant_id)):
            return
        try:
            _, manifest = self.store.get(warm_object_id(sess.tenant_id))
            warm = manifest["meta"]
            launches = int(warm.get("launches", 0))
            rotations = int(warm.get("rotations", 0))
            reg_nonce = int(warm.get("reg_nonce", 0))
            # never re-walk the previous incarnation's nonce lanes
            floor = int(warm.get("epoch", 0)) + 1
            sess.channel.advance_epoch(floor)
        except (StoreError, trust.SecurityError, KeyError, TypeError,
                ValueError):
            return
        if self.audit is not None:
            self.audit.append("epoch_advance", tenant=sess.tenant_id,
                              floor=floor, epoch=sess.channel.epoch,
                              reg_nonce=reg_nonce)
        sess.launches = max(0, launches)
        sess.rotations = max(0, rotations)
        # Rule-3 warm restart: resume the register nonce lane at the last
        # verified launch, so the device side never restarts at 0 accepting
        # an arbitrary forward (replayable) nonce stream.
        sess.channel.restore_register_floor(reg_nonce)

    def _persist_warm_state(self, sess: TenantSession) -> None:
        if self.store is None:
            return
        base = self.store.manifest(warm_object_id(sess.tenant_id))
        self._warm_seq = max(self._warm_seq + 1,
                             (base["freshness"] + 1) if base else 0)
        regs = sess.channel.device_regs
        self.store.put(
            warm_object_id(sess.tenant_id), sess.tenant_id, {},
            kind=WARM_KIND, freshness=self._warm_seq,
            nonce_epoch=sess.channel.epoch,
            meta={"launches": sess.launches, "rotations": sess.rotations,
                  "epoch": sess.channel.epoch,
                  "reg_nonce": regs.last_nonce if regs else 0})

    # -- launch accounting + rotation -----------------------------------
    def note_launch(self, tenant_id: str, n: int = 1) -> None:
        sess = self.get(tenant_id)
        before = sess.launches
        sess.launches += n
        # persist when the counter crosses a threshold boundary (exact
        # multiples would never fire for callers batching n > 1)
        if sess.launches // _WARM_PERSIST_EVERY > before // _WARM_PERSIST_EVERY:
            self._persist_warm_state(sess)

    def rotation_due(self, tenant_id: str) -> bool:
        if not self.rotate_every:
            return False
        return self.get(tenant_id).launches >= self.rotate_every

    def rotate(self, tenant_id: str) -> SecureChannel:
        """Fresh handshake -> rekey the tenant's channel in place.

        Callers must ensure the tenant has no sealed state under the old key
        (the gateway rotates only quiescent tenants: zero live pages and
        zero swapped-out KV objects).
        """
        sess = self.get(tenant_id)
        key_words, key_bytes = self._handshake()
        sess.channel.rekey(key_words, key_bytes)
        sess.launches = 0
        sess.rotations += 1
        self._persist_warm_state(sess)
        if self.audit is not None:
            self.audit.append("rotate", tenant=tenant_id,
                              rotations=sess.rotations,
                              epoch=sess.channel.epoch)
        return sess.channel
