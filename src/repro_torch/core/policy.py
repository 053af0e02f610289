"""Protection policies — the paper's three evaluated configurations, generalized.

The paper evaluates: VTA (no protection), VTA-ctr (confidentiality only) and
VTA-trusted (confidentiality + integrity + freshness).  We expose the same three
levels per *tensor class* so a deployment can, e.g., seal weights + KV cache but
leave public calibration data plain.
"""
from __future__ import annotations

import dataclasses
import enum


class Protection(enum.Enum):
    NONE = "none"          # paper's "VTA" row
    CTR = "ctr"            # paper's "VTA-ctr": counter-mode confidentiality only
    TRUSTED = "trusted"    # paper's "VTA-trusted": CTR + chunked MAC + freshness

    @property
    def encrypts(self) -> bool:
        return self is not Protection.NONE

    @property
    def authenticates(self) -> bool:
        return self is Protection.TRUSTED


# Default chunk size s (paper §3.3.2): trade-off between MAC latency (small s)
# and metadata/DRAM overhead (large m).  512 words = 2 KiB, matching the 2 KB
# staging buffer of the paper's security interface.
DEFAULT_CHUNK_WORDS = 512


@dataclasses.dataclass(frozen=True)
class SealedSpec:
    """Per-tensor-class sealing parameters."""
    protection: Protection = Protection.TRUSTED
    chunk_words: int = DEFAULT_CHUNK_WORDS
    mac_domain: int = 0xA11CE


@dataclasses.dataclass(frozen=True)
class SecurityConfig:
    """Framework-wide security configuration (a first-class config object).

    Tensor classes mirror where bytes live in an LM system: weights, optimizer
    state, activations crossing HBM, the KV cache, collective payloads that
    leave the pod trust boundary, and checkpoints at rest.
    """
    enabled: bool = True
    weights: SealedSpec = SealedSpec()
    grads: SealedSpec = SealedSpec()
    activations: SealedSpec = SealedSpec(protection=Protection.CTR)
    kv_cache: SealedSpec = SealedSpec()
    cross_pod: SealedSpec = SealedSpec()
    checkpoint: SealedSpec = SealedSpec(chunk_words=4096)
    # Rule 3: launch-descriptor (register state) protection
    protect_launch: bool = True

    @classmethod
    def off(cls) -> "SecurityConfig":
        none = SealedSpec(protection=Protection.NONE)
        return cls(enabled=False, weights=none, grads=none, activations=none,
                   kv_cache=none, cross_pod=none, checkpoint=none,
                   protect_launch=False)

    @classmethod
    def ctr_only(cls) -> "SecurityConfig":
        ctr = SealedSpec(protection=Protection.CTR)
        return cls(weights=ctr, grads=ctr, activations=ctr, kv_cache=ctr,
                   cross_pod=ctr, checkpoint=ctr)
