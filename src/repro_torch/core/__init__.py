"""repro_torch.core — sealed offload to a trusted accelerator (torch port).

  trust      attestation + signed ephemeral DH -> session key K   (copy)
  cipher     counter-mode Threefry keystream, seal/unseal = XOR
  mac        chunked multilinear Mersenne-31 MAC over ciphertext
  sealed     SealedTensor: ciphertext + tag sidecar + nonce
  registers  launch-descriptor MAC + nonce (Rule 3)              (copy)
  channel    SecureChannel: upload/download/launch end-to-end
  policy     NONE / CTR / TRUSTED per tensor class                (copy)
  overhead   the paper's analytic overhead model; the H100's model  (copy)
"""
from . import cipher, mac, policy, registers, sealed, trust
from .channel import SecureChannel, poison_unless
from .policy import Protection, SealedSpec, SecurityConfig
from .sealed import SealedTensor, seal, seal_tree, unseal, unseal_tree

__all__ = [
    "cipher", "mac", "policy", "registers", "sealed", "trust",
    "SecureChannel", "poison_unless", "Protection", "SealedSpec",
    "SecurityConfig", "SealedTensor", "seal", "seal_tree", "unseal",
    "unseal_tree",
]
