"""SealedStore — an untrusted host-tier blob store for sealed objects.

The paper's trust model (Rules 1 & 2) makes this tier essentially free:
anything that leaves the accelerator already exists only as CTR ciphertext
plus nonce-bound MAC tags, so sealed bytes can move to host DRAM or disk
*verbatim* — no re-encryption, only freshness bookkeeping (the observation
GuardNN applies to off-chip memory and Graphcore's confidential-IPU design
applies to host-staged state).

An *object* is a named set of chunks (numpy arrays — typically ciphertext
words and tag sidecars) plus a manifest:

    object_id, tenant_id, kind          identity / routing
    nonce_epoch, freshness              bookkeeping for the owner's replay
                                        window (advisory — see below)
    chunks: [{name, shape, dtype, sha256}], merkle_root
    hmac                                owner-keyed manifest signature

Two integrity layers, deliberately distinct:

  * store-level (this module): per-chunk SHA-256, a Merkle root over the
    chunk hashes and an HMAC over the manifest core.  This catches rot and
    tampering *early*, host-side, for consumers that trust their own key
    (checkpoint restore).  It is advisory for the serving path.
  * trust-level (the pool MACs): for swapped KV pages the real verdict is
    the accelerator's in-graph MAC check against *enclave-retained* nonces —
    a store compromised enough to forge manifests still cannot forge page
    tags, and a stale (replayed) object fails against the retained freshness
    nonce and NaN-poisons only the owning request.

Freshness is monotone per object id: a ``put`` that would lower an object's
freshness counter is refused (host-side replay hygiene; the cryptographic
replay check is the nonce-bound MAC above).

Backends: in-memory (default) and a directory on disk (atomic per-object
commit via rename — the checkpoint tier).  An optional byte capacity evicts
unpinned objects through a pluggable policy (store/eviction.py).
"""
from __future__ import annotations

import dataclasses
import hashlib
import hmac as hmac_lib
import json
import os
import shutil
import tempfile

import numpy as np

from .eviction import EvictionPolicy, LRUEviction


class StoreError(RuntimeError):
    pass


class StoreFull(StoreError):
    pass


def _sha256(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _merkle_root(hashes: list[str]) -> str:
    """Merkle root over sorted chunk hashes (order-independent set digest)."""
    level = [bytes.fromhex(h) for h in sorted(hashes)]
    if not level:
        return _sha256(b"")
    while len(level) > 1:
        if len(level) % 2:
            level.append(level[-1])
        level = [hashlib.sha256(level[i] + level[i + 1]).digest()
                 for i in range(0, len(level), 2)]
    return level[0].hex()


def _sign(core: dict, key_bytes: bytes | None) -> str:
    if key_bytes is None:
        return ""
    blob = json.dumps(core, sort_keys=True).encode()
    return hmac_lib.new(key_bytes, blob, hashlib.sha256).hexdigest()


@dataclasses.dataclass
class StoredObject:
    manifest: dict
    chunks: dict            # name -> np.ndarray (in-memory backend only)
    last_access: int = 0


class SealedStore:
    """Host-tier blob store for sealed state (KV swap, checkpoints, sessions).

    root=None        in-memory (the swap tier)
    root=<dir>       one subdirectory per object, manifest.json + <name>.npy
                     chunks, committed atomically via rename (the ckpt tier)
    capacity_bytes   if set, ``put`` evicts unpinned objects via ``policy``
                     until the new object fits (or raises StoreFull)
    """

    def __init__(self, root: str | None = None,
                 capacity_bytes: int | None = None,
                 policy: EvictionPolicy | None = None):
        self.root = root
        self.capacity_bytes = capacity_bytes
        self.policy = policy or LRUEviction()
        self._mem: dict[str, StoredObject] = {}
        self._clock = 0
        self.stats = {"puts": 0, "gets": 0, "deletes": 0, "evictions": 0,
                      "bytes_in": 0, "bytes_out": 0, "verify_failures": 0,
                      "freshness_rejects": 0}
        self.audit = None       # obs.AuditLog (attached by the gateway)
        if root:
            os.makedirs(root, exist_ok=True)

    def _audit(self, kind: str, tenant: str | None, **detail) -> None:
        if self.audit is not None:
            self.audit.append(kind, tenant=tenant, **detail)

    # -- paths -----------------------------------------------------------
    def _obj_dir(self, object_id: str) -> str:
        return os.path.join(self.root, object_id.replace("/", "__"))

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # -- write path ------------------------------------------------------
    def put(self, object_id: str, tenant_id: str, chunks: dict,
            *, key_bytes: bytes | None = None, kind: str = "blob",
            freshness: int = 0, nonce_epoch: int = 0, pinned: bool = False,
            meta: dict | None = None) -> dict:
        """Store an object; returns its manifest.

        Chunks move verbatim (sealed bytes stay sealed).  Refuses to lower an
        existing object's freshness counter; equal freshness overwrites (the
        restart-and-resave path).
        """
        prev = self.manifest(object_id)
        if prev is not None and freshness < prev["freshness"]:
            self.stats["freshness_rejects"] += 1
            self._audit("store_freshness_reject", tenant_id,
                        object_id=object_id, freshness=int(freshness),
                        stored=int(prev["freshness"]))
            raise StoreError(
                f"object {object_id!r}: freshness {freshness} < stored "
                f"{prev['freshness']} (stale write refused)")
        arrays = {n: np.asarray(c) for n, c in chunks.items()}
        entries, hashes = [], []
        nbytes = 0
        for name in sorted(arrays):
            arr = arrays[name]
            raw = arr.tobytes()
            h = _sha256(raw)
            hashes.append(h)
            nbytes += arr.nbytes
            entries.append({"name": name, "shape": list(arr.shape),
                            "dtype": str(arr.dtype), "sha256": h})
        core = {"object_id": object_id, "tenant_id": tenant_id, "kind": kind,
                "freshness": int(freshness), "nonce_epoch": int(nonce_epoch),
                "pinned": bool(pinned), "nbytes": nbytes,
                "chunks": entries, "merkle_root": _merkle_root(hashes),
                "meta": meta or {}}
        manifest = dict(core)
        manifest["hmac"] = _sign(core, key_bytes)
        self._make_room(object_id, nbytes)
        if self.root is None:
            self._mem[object_id] = StoredObject(
                manifest, {n: a.copy() for n, a in arrays.items()},
                self._tick())
        else:
            d = self._obj_dir(object_id)
            tmp = tempfile.mkdtemp(prefix=".tmp_obj_", dir=self.root)
            for name, arr in arrays.items():
                np.save(os.path.join(tmp, f"{name}.npy"), arr)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
            if os.path.exists(d):
                shutil.rmtree(d)
            os.rename(tmp, d)
        self.stats["puts"] += 1
        self.stats["bytes_in"] += nbytes
        return manifest

    def _make_room(self, incoming_id: str, nbytes: int) -> None:
        if self.capacity_bytes is None:
            return
        manifests = self._manifests()       # one snapshot, not per-iteration
        manifests.pop(incoming_id, None)
        used = sum(m["nbytes"] for m in manifests.values())
        while used + nbytes > self.capacity_bytes:
            candidates = {oid: (m, self._last_access(oid))
                          for oid, m in manifests.items()
                          if not m["pinned"]}
            victim = self.policy.pick(candidates)
            if victim is None:
                raise StoreFull(
                    f"store over capacity ({used + nbytes} > "
                    f"{self.capacity_bytes} bytes) and nothing evictable")
            used -= manifests.pop(victim)["nbytes"]
            self.delete(victim)
            self.stats["evictions"] += 1
            self.stats["deletes"] -= 1  # eviction, not a caller delete

    # -- read path -------------------------------------------------------
    def manifest(self, object_id: str) -> dict | None:
        if self.root is None:
            obj = self._mem.get(object_id)
            return obj.manifest if obj else None
        path = os.path.join(self._obj_dir(object_id), "manifest.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def exists(self, object_id: str) -> bool:
        return self.manifest(object_id) is not None

    def get(self, object_id: str, *, key_bytes: bytes | None = None,
            verify: bool = True) -> tuple[dict, dict]:
        """Fetch (chunks, manifest).

        verify=True runs the store-level checks (chunk hashes, merkle root,
        manifest HMAC when ``key_bytes`` is given) and raises StoreError on
        mismatch — the checkpoint-restore path.  verify=False hands back the
        bytes as-is — the swap-in path, where the store is *untrusted* and
        the binding check is the accelerator's nonce-bound page MAC.
        """
        manifest = self.manifest(object_id)
        if manifest is None:
            raise StoreError(f"object {object_id!r} not found")
        chunks = {}
        hashes = []
        for e in manifest["chunks"]:
            arr = self._read_chunk(object_id, e)
            if verify:
                h = _sha256(arr.tobytes())
                if h != e["sha256"]:
                    self.stats["verify_failures"] += 1
                    self._audit("store_verify_fail", manifest["tenant_id"],
                                object_id=object_id, chunk=e["name"],
                                what="chunk_hash")
                    raise StoreError(
                        f"object {object_id!r} chunk {e['name']!r} hash "
                        "mismatch (tampered or rotted)")
                hashes.append(h)
            chunks[e["name"]] = arr
            self.stats["bytes_out"] += arr.nbytes
        if verify:
            if _merkle_root(hashes) != manifest["merkle_root"]:
                self.stats["verify_failures"] += 1
                self._audit("store_verify_fail", manifest["tenant_id"],
                            object_id=object_id, what="merkle_root")
                raise StoreError(f"object {object_id!r} merkle root mismatch")
            if key_bytes is not None:
                core = {k: v for k, v in manifest.items() if k != "hmac"}
                want = _sign(core, key_bytes)
                if not hmac_lib.compare_digest(want, manifest["hmac"]):
                    self.stats["verify_failures"] += 1
                    self._audit("store_verify_fail", manifest["tenant_id"],
                                object_id=object_id, what="manifest_hmac")
                    raise StoreError(
                        f"object {object_id!r} manifest HMAC mismatch")
        if self.root is None:
            self._mem[object_id].last_access = self._tick()
        self.stats["gets"] += 1
        return chunks, manifest

    def _read_chunk(self, object_id: str, entry: dict) -> np.ndarray:
        if self.root is None:
            return self._mem[object_id].chunks[entry["name"]]
        return np.load(os.path.join(self._obj_dir(object_id),
                                    f"{entry['name']}.npy"))

    # -- management ------------------------------------------------------
    def delete(self, object_id: str) -> None:
        if self.root is None:
            self._mem.pop(object_id, None)
        else:
            d = self._obj_dir(object_id)
            if os.path.isdir(d):
                shutil.rmtree(d)
        self.stats["deletes"] += 1

    def objects(self, tenant_id: str | None = None,
                kind: str | None = None) -> list[str]:
        out = []
        for oid, m in self._manifests().items():
            if tenant_id is not None and m["tenant_id"] != tenant_id:
                continue
            if kind is not None and m["kind"] != kind:
                continue
            out.append(oid)
        return sorted(out)

    def _manifests(self) -> dict[str, dict]:
        if self.root is None:
            return {oid: o.manifest for oid, o in self._mem.items()}
        out = {}
        for d in os.listdir(self.root):
            path = os.path.join(self.root, d, "manifest.json")
            if os.path.exists(path):
                with open(path) as f:
                    m = json.load(f)
                if "object_id" in m:    # skip foreign/old-schema manifests
                    out[m["object_id"]] = m
        return out

    def _last_access(self, object_id: str) -> int:
        if self.root is None:
            return self._mem[object_id].last_access
        return 0  # disk tier: policy falls back to manifest order

    @property
    def nbytes(self) -> int:
        return sum(m["nbytes"] for m in self._manifests().values())

    def verify_object(self, object_id: str,
                      key_bytes: bytes | None = None) -> bool:
        try:
            self.get(object_id, key_bytes=key_bytes, verify=True)
            return True
        except StoreError:
            return False

    def fsck(self, keys_by_tenant: dict[str, bytes] | None = None) -> dict:
        """Store-level integrity sweep: re-hash every chunk of every object,
        check merkle roots, and check manifest HMACs where a tenant key is
        provided *and* the object was put with one (unsigned objects — e.g.
        session warm state — are hash-checked only; a consumer that demands
        a signature, like checkpoint restore, still fails them strictly).
        Returns {"ok": [...], "corrupt": [...]}."""
        keys_by_tenant = keys_by_tenant or {}
        report = {"ok": [], "corrupt": []}
        for oid, m in sorted(self._manifests().items()):
            kb = keys_by_tenant.get(m["tenant_id"]) if m.get("hmac") else None
            (report["ok"] if self.verify_object(oid, kb)
             else report["corrupt"]).append(oid)
        self._audit("store_fsck", None, ok=len(report["ok"]),
                    corrupt=len(report["corrupt"]),
                    corrupt_ids=report["corrupt"])
        return report
