"""Eviction policies — who leaves when space runs out.

Two consumers share this module:

  * SealedStore capacity eviction: which *stored object* to drop when the
    host tier is over its byte budget (``EvictionPolicy.pick``).  Policies
    see (manifest, last_access) pairs for every unpinned object.
  * Preemptive scheduling: which *running request* to swap out of the KV
    pool when admission stalls (``choose_victim``).  The scheduler swaps the
    lowest-priority, longest-idle request — and only one whose priority is
    strictly below the waiter's, so equal-priority traffic can never thrash.
"""
from __future__ import annotations


class EvictionPolicy:
    """Store-capacity policy: pick one object id to evict, or None."""

    def pick(self, candidates: dict) -> str | None:
        """candidates: object_id -> (manifest, last_access)."""
        raise NotImplementedError


class LRUEviction(EvictionPolicy):
    """Evict the least-recently-accessed object (ties: smaller freshness,
    then lexicographic id, so eviction order is deterministic)."""

    def pick(self, candidates: dict) -> str | None:
        if not candidates:
            return None
        return min(candidates,
                   key=lambda oid: (candidates[oid][1],
                                    candidates[oid][0]["freshness"], oid))


class LargestFirstEviction(EvictionPolicy):
    """Evict the largest object — frees the most room per eviction."""

    def pick(self, candidates: dict) -> str | None:
        if not candidates:
            return None
        return max(candidates,
                   key=lambda oid: (candidates[oid][0]["nbytes"], oid))


def choose_victim(running: list, waiter_priority: int):
    """Pick the running request to preempt for a waiter, or None.

    Eligible victims have priority *strictly below* the waiter's (preempting
    an equal-priority request would let two requests swap each other forever).
    Among eligible victims: lowest priority first, then longest idle (oldest
    last-progress timestamp), then lowest rid for determinism.
    """
    eligible = [r for r in running if r.priority < waiter_priority]
    if not eligible:
        return None
    return min(eligible, key=lambda r: (r.priority, r.t_last, r.rid))
