"""The port's SecureGateway against the JAX SecureGateway on one script.

Both gateways serve the granite-3-2b smoke config (float32, TF32 off) with
weights from the reference's ``init``, through their full host side:
sessions, scheduler, sealed prefix cache, sealed host-tier store, audit log
and monitor.  The script (two tenants, max 3 slots):

  1. publish a 20-token prefix (2 shared pages + a partial tail);
  2. alice and bob submit prompts that extend the prefix (prefix hits),
     alice a fresh prompt (a miss); two steps;
  3. one ciphertext bit of alice's fresh request's page is flipped, and a
     priority-5 request of bob arrives: it preempts one running request,
     whose sealed pages swap out to the store;
  4. one bit of that swap object is flipped in the store, and alice submits
     exactly the prefix (a copy-on-write break of the shared tail);
  5. drain, and retire the prefix.

Session keys come from each side's own handshakes, so no ciphertext is
compared here; everything the host side decides is: per-request tokens and
statuses, swap out/in counts, prefix hit/miss counts, pages per request,
the sealed-byte counters, the sequence of audit record kinds, and which
requests the two tampers poison.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import registry  # noqa: E402
from repro.obs import MonitorConfig as JMonitorConfig  # noqa: E402
from repro.serve import SecureGateway as JGateway  # noqa: E402
from repro.serve import swap_object_id  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.obs import MonitorConfig as TMonitorConfig  # noqa: E402
from repro_torch.serve import SecureGateway as TGateway  # noqa: E402
from repro_torch.serve import TOKEN_POISON  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PAGE, N_PAGES, MAX_PAGES, SLOTS, MAX_NEW = 8, 32, 5, 3, 8


def build(side: str, np_params):
    kw = dict(security="trusted", max_slots=SLOTS, page_size=PAGE,
              n_pages=N_PAGES, max_pages_per_seq=MAX_PAGES)
    if side == "jax":
        cfg = jconfigs.get_config("granite-3-2b", smoke=True)
        params = jax.tree_util.tree_map(jax.numpy.asarray, np_params)
        # the script tampers on purpose: no auto-quarantine
        return JGateway(cfg, params, monitor_config=JMonitorConfig(
            tamper_storm_count=0), **kw)
    cfg = tconfigs.get_config("granite-3-2b", smoke=True)
    params = ttransformer.params_from_numpy(np_params, "cpu")
    return TGateway(cfg, params, monitor_config=TMonitorConfig(
        tamper_storm_count=0), device="cpu", **kw)


def flip_page_bit(gw, page: int) -> None:
    if isinstance(gw, TGateway):
        gw.pool.k_ct[page, 0, 0, 0, 0] ^= 1
    else:
        gw.pool.k_ct = gw.pool.k_ct.at[page, 0, 0, 0, 0].set(
            gw.pool.k_ct[page, 0, 0, 0, 0] ^ 1)


def run_script(gw, prompts) -> dict:
    prefix = prompts["prefix"]
    entry = gw.register_prefix(prefix)
    rids = {"a_hit": gw.submit("alice", np.concatenate([prefix,
                                                        prompts["a_sfx"]]),
                               MAX_NEW),
            "b_hit": gw.submit("bob", np.concatenate([prefix,
                                                      prompts["b_sfx"]]),
                               MAX_NEW),
            "a_miss": gw.submit("alice", prompts["a_miss"], MAX_NEW)}
    gw.step()
    gw.step()
    sched = gw.scheduler
    flip_page_bit(gw, sched.requests[rids["a_miss"]].pages[0])
    rids["b_prio"] = gw.submit("bob", prompts["b_prio"], 6, priority=5)
    events = gw.step()
    victims = list(events["preempted"])
    for victim in victims:
        obj = gw.store._mem[swap_object_id(victim)]
        obj.chunks["k_ct"].reshape(-1)[0] ^= 1
    rids["a_exact"] = gw.submit("alice", prefix, 4)
    gw.drain()
    assert gw.evict_prefix(entry.prefix_id)
    reqs = {name: sched.requests[rid] for name, rid in rids.items()}
    m = gw.metrics()
    return {
        "prefix": (entry.n_full, entry.tail_fill, entry.first_token,
                   entry.first_ok),
        "victims": [name for name, rid in rids.items() if rid in victims],
        "tokens": {n: [int(t) for t in r.tokens_out] for n, r in reqs.items()},
        "status": {n: r.status for n, r in reqs.items()},
        "pages": {n: (sched.total_pages(r), r.n_shared)
                  for n, r in reqs.items()},
        "swaps": (m["swap_outs"], m["swap_ins"], m["swapped_bytes"]),
        "prefix_counts": (m["prefix_hits"], m["prefix_misses"],
                          m["prefix_pages_saved"], m["prefix_cow_breaks"]),
        "sealed": {k: m[k] for k in ("sealed_bytes_prefill",
                                     "sealed_bytes_decode",
                                     "sealed_bytes_swap", "decode_tokens",
                                     "page_closes", "page_reopens")},
        "peak_pages": m["kv_pages_peak"],
        "live_pages": gw.pool.live_pages,
        "audit_kinds": [r["kind"] for r in gw.audit.records],
        "audit_ok": gw.verify_audit()["ok"],
        "launches": m["launches_verified"],
    }


@pytest.fixture(scope="module")
def runs():
    cfg = jconfigs.get_config("granite-3-2b", smoke=True)
    np_params = jax.tree_util.tree_map(
        np.asarray, registry.get_model(cfg).init(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(11)
    prompts = {"prefix": rng.randint(0, cfg.vocab, 20),
               "a_sfx": rng.randint(0, cfg.vocab, 4),
               "b_sfx": rng.randint(0, cfg.vocab, 6),
               "a_miss": rng.randint(0, cfg.vocab, 10),
               "b_prio": rng.randint(0, cfg.vocab, 12)}
    prompts = {k: v.astype(np.int32) for k, v in prompts.items()}
    return {side: run_script(build(side, np_params), prompts)
            for side in ("jax", "torch")}


def test_script_exercises_the_host_side(runs):
    t = runs["torch"]
    assert t["victims"] == ["a_hit"]
    assert t["status"] == {"a_hit": "poisoned", "b_hit": "done",
                           "a_miss": "poisoned", "b_prio": "done",
                           "a_exact": "done"}
    assert t["swaps"][:2] == (1, 1)
    assert t["prefix_counts"] == (3, 2, 6, 1)
    assert t["live_pages"] == 0 and t["audit_ok"]
    assert {"prefix_publish", "prefix_map", "cow_break", "swap_out",
            "swap_in", "tamper"} <= set(t["audit_kinds"])


def test_tokens_and_statuses_equal_reference(runs):
    assert runs["torch"]["prefix"] == runs["jax"]["prefix"]
    assert runs["torch"]["tokens"] == runs["jax"]["tokens"]
    assert runs["torch"]["status"] == runs["jax"]["status"]
    for name, toks in runs["torch"]["tokens"].items():
        if runs["torch"]["status"][name] == "poisoned":
            assert toks[-1] == TOKEN_POISON


def test_swap_and_prefix_counts_equal_reference(runs):
    for key in ("victims", "swaps", "prefix_counts", "pages", "peak_pages"):
        assert runs["torch"][key] == runs["jax"][key], key


def test_sealed_byte_counters_equal_reference(runs):
    assert runs["torch"]["sealed"] == runs["jax"]["sealed"]
    assert runs["torch"]["sealed"]["page_reopens"] >= 1


def test_audit_kinds_equal_reference(runs):
    assert runs["torch"]["audit_kinds"] == runs["jax"]["audit_kinds"]
    assert runs["torch"]["launches"] == runs["jax"]["launches"]
    assert runs["jax"]["audit_ok"] and runs["torch"]["audit_ok"]
