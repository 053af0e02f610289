"""Sealed cross-pod collectives (torch port of
``repro.parallel.collectives``) on ``torch.distributed``.

Trust boundary: inside a pod the links are trusted; the cross-pod link is
the analogue of the paper's snoopable system bus, and payloads crossing it
must be sealed (Rule 1).  A stream cipher is not additively homomorphic,
so a sealed all-reduce cannot sum ciphertexts in flight: each pod seals
its contribution under a (step, leaf, pod)-unique nonce, the pods
all-gather the ciphertext, and each pod unseals every part and sums them
in pod order inside its own trust boundary.  For P pods that is P x the
payload on the link (against 2x for a ring all-reduce); int8 compression
(``compress.py``) takes back 4x.

A pod is a rank of ``group`` (the default group when None); every rank
calls the functions in the same order.  The ciphertext goes through
``cipher.seal_bits``: the CTR kernel for tensors on the card.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core import cipher
from ..core.sealed import tree_leaves, tree_unflatten
from ..kernels import common
from . import compress as C


def _all_gather(ct: torch.Tensor, n_pods: int, group) -> torch.Tensor:
    """[n_pods, *ct.shape]: every pod's ``ct``, gathered as bytes (a flat
    output, which every backend takes)."""
    flat = ct.contiguous().reshape(-1).view(torch.uint8)
    out = torch.empty(n_pods * flat.numel(), dtype=torch.uint8,
                      device=ct.device)
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.view(ct.dtype).reshape(n_pods, *ct.shape)


def _pod_nonces(nonce_base: int, n_pods: int) -> list[int]:
    """The payload nonce of each pod: nonce_base * n_pods + pod, mod 2^32."""
    return [(int(nonce_base) * n_pods + p) & common.M32
            for p in range(n_pods)]


def seal_payload(x: torch.Tensor, key: torch.Tensor, nonce: int,
                 quantize: bool = False):
    """One pod's sealed contribution: the f32 ciphertext of ``x`` under
    ``nonce``, or (int8 values under 2 nonce, f32 block scales under
    2 nonce + 1) when quantizing."""
    if quantize:
        q, scale = C.quantize_int8(x)
        return (cipher.seal_bits(q, key, (2 * nonce) & common.M32),
                cipher.seal_bits(scale, key, (2 * nonce + 1) & common.M32))
    return cipher.seal_bits(x.float(), key, nonce)


def sealed_allreduce_pod(x: torch.Tensor, key: torch.Tensor, nonce_base,
                         n_pods: int, mean: bool = True,
                         quantize: bool = False, group=None) -> torch.Tensor:
    """All-reduce ``x`` across the pods with sealed payloads.

    nonce_base must be unique per (step, tensor) — counter reuse is a
    CTR-mode violation.  Returns the sum (the mean with ``mean``) in x's
    dtype."""
    pid = dist.get_rank(group)
    nonces = _pod_nonces(nonce_base, n_pods)
    if quantize:
        ct_q, ct_s = seal_payload(x, key, nonces[pid], quantize=True)
        g_q = _all_gather(ct_q, n_pods, group)
        g_s = _all_gather(ct_s, n_pods, group)
        parts = [C.dequantize_int8(
            cipher.unseal_bits(g_q[p], key, (2 * n) & common.M32,
                               torch.int8),
            cipher.unseal_bits(g_s[p], key, (2 * n + 1) & common.M32,
                               torch.float32))
            for p, n in enumerate(nonces)]
    else:
        g = _all_gather(seal_payload(x, key, nonces[pid]), n_pods, group)
        parts = [cipher.unseal_bits(g[p], key, n, torch.float32)
                 for p, n in enumerate(nonces)]
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    if mean:
        out = out / n_pods
    return out.reshape(x.shape).to(x.dtype)


def plain_allreduce_pod(x: torch.Tensor, n_pods: int, mean: bool = True,
                        group=None) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, group=group)
    return (out / n_pods).to(x.dtype) if mean else out


def make_crosspod_grad_hook(key: torch.Tensor, n_pods: int, *,
                            sealed: bool = True, quantize: bool = True,
                            group=None):
    """Gradient hook for the trainer (``make_train_step(grad_hook=...)``):
    the per-pod gradient, already averaged over the pod's batch, combined
    across pods — leaf i of step s sealed under nonce base
    s * 65536 + i.  Returns fn(grads, step)."""
    def hook(grads, step):
        s = int(step)
        out = []
        for i, g in enumerate(tree_leaves(grads)):
            if sealed:
                nonce_base = (s * 65536 + i) & common.M32
                out.append(sealed_allreduce_pod(g, key, nonce_base, n_pods,
                                                mean=True, quantize=quantize,
                                                group=group))
            else:
                out.append(plain_allreduce_pod(g, n_pods, mean=True,
                                               group=group))
        return tree_unflatten(grads, out)
    return hook
