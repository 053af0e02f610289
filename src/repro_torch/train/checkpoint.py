"""Sealed checkpointing over the SealedStore host tier (torch port of
``repro.train.checkpoint``).

A checkpoint is one store object per step (`ckpt_<step>`), committed
atomically; its chunks are the state's leaf arrays in the reference's leaf
order (SealedTensor leaves stay ciphertext: sealing the state *is*
checkpoint encryption) and its manifest carries per-chunk SHA-256, a Merkle
root and an HMAC under the session key — the store-level integrity layer
(store/sealed_store.py), verified strictly on restore.

The manifest schema, the leaf order and ``meta.keys`` (the reference's
``jax.tree_util.keystr`` paths) are the reference's, and leaves are stored
with its dtypes (ciphertext and tags as uint16/uint32), so a checkpoint
saved by either package restores in the other.  One exception: a plain
bf16 leaf (an unsealed state) is stored as its uint16 bits.

Restore verifies everything, then (optionally) re-shards each leaf onto a
device mesh — the elastic-restart path: every rank reads the checkpoint
and keeps its own block of each leaf as a DTensor
(``parallel.sharding.distribute``), so a checkpoint written by one
process restores onto any mesh whose axes divide the dimensions.

    ckpt_000042/
      manifest.json     chunk index + merkle_root + hmac + meta
      000000.npy ...    raw leaf arrays
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.sealed import SealedTensor
from ..optim import TrainState
from ..parallel import sharding as shd
from ..store import SealedStore, StoreError

TENANT = "_trainer"

_UNSIGNED = {2: np.uint16, 4: np.uint32}
_SIGNED = {2: np.int16, 4: np.int32}


class CheckpointError(RuntimeError):
    pass


def _object_id(step: int) -> str:
    return f"ckpt_{step:06d}"


def _children(node):
    """(key strings, children) of a tree node, or None for a leaf, in the
    reference's order and ``keystr`` spelling."""
    if isinstance(node, TrainState):
        kids = (node.step, node.params, node.mu, node.nu)
    elif isinstance(node, SealedTensor):
        kids = (node.ct, node.tags, node.nonce)
    elif isinstance(node, dict):
        return [f"[{k!r}]" for k in sorted(node)], [node[k]
                                                    for k in sorted(node)]
    elif isinstance(node, (list, tuple)):
        return [f"[{i}]" for i in range(len(node))], list(node)
    else:
        return None
    return [f"[<flat index {i}>]" for i in range(len(kids))], list(kids)


def _flatten(node, path="", sealed=False):
    """[(keystr path, leaf, stored as unsigned words?)] in leaf order: a
    SealedTensor's ciphertext and tags are stored unsigned."""
    kids = _children(node)
    if kids is None:
        return [(path, node, sealed)]
    inner = isinstance(node, SealedTensor)
    return [x for k, c in zip(*kids) for x in _flatten(c, path + k, inner)]


def _to_numpy(leaf, unsigned: bool) -> np.ndarray:
    if isinstance(leaf, int):             # a SealedTensor's uint32 nonce
        return np.asarray(leaf, np.uint32)
    a = leaf.detach().cpu()
    if a.dtype == torch.bfloat16:         # numpy has no bf16: its bits
        a, unsigned = a.view(torch.int16), True
    a = a.numpy()
    return a.view(_UNSIGNED[a.itemsize]) if unsigned else a


def save(base_dir: str, step: int, state, key_bytes: bytes) -> str:
    """Atomically write a (possibly sealed) state checkpoint."""
    store = SealedStore(base_dir)
    leaves_kp = _flatten(state)
    chunks = {f"{i:06d}": _to_numpy(leaf, unsigned)
              for i, (_, leaf, unsigned) in enumerate(leaves_kp)}
    store.put(_object_id(step), TENANT, chunks, key_bytes=key_bytes,
              kind="checkpoint", freshness=step,
              meta={"step": step, "keys": [kp for kp, _, _ in leaves_kp]})
    return os.path.join(base_dir, _object_id(step))


def _to_tensor(arr: np.ndarray, like, sharding=None) -> torch.Tensor | int:
    if isinstance(like, int):
        return int(arr) & 0xFFFFFFFF
    arr = np.asarray(arr)
    if arr.dtype.kind == "u" or arr.dtype.kind == "V":
        arr = arr.view(_SIGNED[arr.dtype.itemsize])
    t = torch.from_numpy(arr.copy())
    if t.dtype != like.dtype and t.element_size() == like.element_size():
        t = t.view(like.dtype)
    t = t.reshape(like.shape)
    if sharding is None:
        return t.to(like.device)
    return shd.distribute(t, sharding)


def _rebuild(like, it, sh=None):
    """``like``'s structure from the leaf iterator; ``sh``: the matching
    tree of shardings, or None."""
    def kids(*names):
        return [(getattr(like, n), None if sh is None else getattr(sh, n))
                for n in names]
    if isinstance(like, TrainState):
        return TrainState(*(_rebuild(c, it, s) for c, s in
                            kids("step", "params", "mu", "nu")))
    if isinstance(like, SealedTensor):
        ct, tags, nonce = (_rebuild(c, it, s) for c, s in
                           kids("ct", "tags", "nonce"))
        return SealedTensor(ct, tags, nonce, like.dtype, like.spec)
    if isinstance(like, dict):
        return {k: _rebuild(like[k], it, None if sh is None else sh[k])
                for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        subs = [None] * len(like) if sh is None else sh
        return type(like)(_rebuild(c, it, s) for c, s in zip(like, subs))
    return _to_tensor(next(it), like, sh)


def restore(path: str, like_state, key_bytes: bytes, shardings=None):
    """Verify + load into the structure and dtypes of ``like_state``
    (which may be an abstract state of meta tensors when ``shardings`` is
    given).  Returns (state, step).

    shardings: an optional tree of ``parallel.sharding.Sharding`` matching
    the state (``parallel.sharding.tree_named_shardings`` with ``like``):
    each tensor leaf becomes a DTensor holding this rank's block, on the
    mesh's device.  Without it each leaf goes to ``like_state``'s
    device."""
    base_dir, object_id = os.path.split(os.path.normpath(path))
    store = SealedStore(base_dir or ".")
    try:
        chunks, manifest = store.get(object_id, key_bytes=key_bytes,
                                     verify=True)
    except StoreError as e:
        raise CheckpointError(str(e)) from e
    except KeyError as e:
        raise CheckpointError(
            f"checkpoint {object_id!r} has a foreign/old manifest schema "
            f"(missing {e})") from e
    arrays = [chunks[name] for name in sorted(chunks)]
    if len(arrays) != len(_flatten(like_state)):
        raise CheckpointError(f"checkpoint {object_id!r} holds "
                              f"{len(arrays)} leaves, the state "
                              f"{len(_flatten(like_state))}")
    return (_rebuild(like_state, iter(arrays), shardings),
            manifest["meta"]["step"])


def latest(base_dir: str):
    if not os.path.isdir(base_dir):
        return None
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(base_dir)
                   if d.startswith("ckpt_"))
    if not steps:
        return None
    return os.path.join(base_dir, f"ckpt_{steps[-1]:06d}"), steps[-1]


def fsck(base_dir: str, key_bytes: bytes | None = None) -> dict:
    """Store-level integrity sweep over every checkpoint in ``base_dir``."""
    store = SealedStore(base_dir)
    keys = ({TENANT: key_bytes} if key_bytes is not None else None)
    return store.fsck(keys)
