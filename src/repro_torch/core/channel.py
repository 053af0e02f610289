"""SecureChannel — the end-to-end secure offload path (torch port).

Same protocol as ``repro.core.channel``: ``trust`` gives the session key,
``sealed`` keeps code and data sealed in untrusted device memory (Rules 1
and 2), and ``registers`` MACs every launch descriptor (Rule 3).  The
data-plane key lives on the channel's ``device`` as an int32 [2] tensor;
``establish`` and ``insecure`` put it on the card unless the caller asks
for ``device="cpu"``.

Nonces are 32-bit (session-id, epoch, counter) words, so two channels never
share a (key, nonce) pair even under one key.  The session id is a
process-wide counter; tests that compare with the reference pass an
explicit ``session_id``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable

import numpy as np
import torch

from . import sealed as sealed_lib
from . import trust
from .policy import SealedSpec, SecurityConfig
from .registers import DeviceRegisterFile, HostRegisterFile

_COUNTER_BITS = 16
_EPOCH_BITS = 8
_SESSION_BITS = 8
_COUNTER_SPACE = 1 << _COUNTER_BITS
_EPOCH_SPACE = 1 << _EPOCH_BITS
_session_ids = itertools.count(1)

TREE_LEAF_STRIDE = sealed_lib.TREE_LEAF_STRIDE


def resolve_device(device) -> torch.device:
    """torch.device for an entry point; a CUDA device must exist."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain versions")
    return device


def poison_unless(ok: torch.Tensor, tree):
    """Gate a tree of outputs on a verification predicate.

    ok=False => every float leaf becomes NaN, every int leaf the minimum of
    its dtype; other leaves pass through.
    """
    def gate(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.dtype.is_floating_point:
            return torch.where(ok, x, torch.full_like(x, float("nan")))
        if x.dtype != torch.bool:
            return torch.where(ok, x,
                               torch.full_like(x, torch.iinfo(x.dtype).min))
        return x
    leaves = [gate(x) for x in sealed_lib.tree_leaves(tree)]
    return sealed_lib.tree_unflatten(tree, leaves)


@dataclasses.dataclass
class SecureChannel:
    """Host <-> accelerator channel over untrusted memory and launch path."""
    key_words: np.ndarray           # uint32[2] data-plane cipher key
    key_bytes: bytes                # control-plane HMAC key (Rule 3)
    config: SecurityConfig
    host_regs: HostRegisterFile = None
    device_regs: DeviceRegisterFile = None
    session_id: int = 0             # 0 => auto-assign a process-unique id
    epoch: int = 0                  # key epoch (bumped on counter wrap)
    _nonce_counter: int = 0
    audit: Any = None               # AuditLog-like sink for launch verdicts
    audit_tenant: str | None = None
    device: Any = "cuda"            # where the data-plane key lives

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if not self.session_id:
            self.session_id = next(_session_ids)
        if self.session_id >= (1 << _SESSION_BITS):
            raise trust.SecurityError(
                "session-id space exhausted (max "
                f"{(1 << _SESSION_BITS) - 1} channels per process)")

    @classmethod
    def establish(cls, config: SecurityConfig | None = None,
                  device_id: str = "gpu-0", device="cuda"):
        """Run the full paper §3.2 handshake and open a channel."""
        config = config or SecurityConfig()
        host, _accel, key_words = trust.establish_session(device_id)
        kb = host.session_key
        return cls(key_words=key_words, key_bytes=kb, config=config,
                   host_regs=HostRegisterFile(key=kb),
                   device_regs=DeviceRegisterFile(key=kb), device=device)

    @classmethod
    def insecure(cls, config: SecurityConfig | None = None, device="cuda"):
        """Protection.NONE channel for baselines (the paper's plain-VTA row)."""
        config = config or SecurityConfig.off()
        kb = b"\x00" * 32
        return cls(key_words=np.zeros((2,), np.uint32), key_bytes=kb,
                   config=config, host_regs=HostRegisterFile(key=kb),
                   device_regs=DeviceRegisterFile(key=kb), device=device)

    # -- data plane -----------------------------------------------------
    @property
    def jkey(self) -> torch.Tensor:
        """The data-plane key as an int32 [2] tensor on the channel's device."""
        words = np.asarray(self.key_words, np.uint32).view(np.int32)
        return torch.tensor(words, dtype=torch.int32, device=self.device)

    def subkey(self, domain: int) -> torch.Tensor:
        """Domain-separated data-plane subkey."""
        from . import cipher
        return cipher.derive_key(self.jkey, domain)

    def bump_epoch(self) -> None:
        self.epoch += 1
        self._nonce_counter = 0
        if self.epoch >= _EPOCH_SPACE:
            raise trust.SecurityError(
                "nonce epoch space exhausted — rotate the session key")

    def fresh_nonce(self, span: int = 1) -> int:
        """Reserve ``span`` consecutive counter slots; return the first nonce."""
        span = max(1, int(span))
        if span > _COUNTER_SPACE:
            raise trust.SecurityError(
                f"nonce span {span} exceeds the per-epoch counter space; "
                "seal in smaller trees or rotate more often")
        if self._nonce_counter + span > _COUNTER_SPACE:
            self.bump_epoch()
        base = self._nonce_counter
        self._nonce_counter += span
        return ((self.session_id & ((1 << _SESSION_BITS) - 1)) << 24
                | (self.epoch & (_EPOCH_SPACE - 1)) << 16
                | base)

    def upload(self, x: torch.Tensor, spec: SealedSpec | None = None):
        """Host -> untrusted device memory: seal a tensor (Rule 1)."""
        spec = spec or self.config.weights
        return sealed_lib.seal(x, self.jkey,
                               self.fresh_nonce(span=TREE_LEAF_STRIDE), spec)

    def upload_tree(self, tree, spec: SealedSpec | None = None):
        spec = spec or self.config.weights
        n_leaves = len(sealed_lib.tree_leaves(tree))
        span = TREE_LEAF_STRIDE * (n_leaves + 1)
        return sealed_lib.seal_tree(tree, self.jkey, spec,
                                    self.fresh_nonce(span=span))

    def download(self, st) -> torch.Tensor:
        """Untrusted device memory -> host enclave: unseal + verify (strict)."""
        x, ok = sealed_lib.unseal(st, self.jkey)
        if not bool(ok):
            raise trust.SecurityError("download integrity check failed")
        return x

    # -- launch path (Rule 3) --------------------------------------------
    def launch(self, step_fn: Callable, descriptor: dict[str, Any], *args,
               **kwargs):
        """Protected dispatch: MAC the descriptor, verify on 'device', run."""
        if self.config.protect_launch:
            state, nonce, tag = self.host_regs.write(**descriptor)
            try:
                self.device_regs.commit(state, nonce, tag)
            except Exception as e:
                if self.audit is not None:
                    self.audit.append("launch_reject",
                                      tenant=self.audit_tenant,
                                      op=str(descriptor.get("op")),
                                      nonce=int(nonce),
                                      error=type(e).__name__)
                raise
            if self.audit is not None:
                self.audit.append("launch", tenant=self.audit_tenant,
                                  op=str(descriptor.get("op")),
                                  nonce=int(nonce))
        return step_fn(*args, **kwargs)
