"""The port's PagedEngine against the JAX PagedEngine, end to end.

Both engines serve the same script through ``repro_torch.serve.runner``
(two tenants, mixed prompt lengths, a prompt longer than one prefill chunk,
decode past page closes) with weights from the reference's ``init``, sealed
by each package's provider channel built from the same key material.  The
smoke config runs in float32 on the CPU: XLA's CPU matmuls are full float32
and the port turns TF32 off, so the greedy token streams must be equal and
K/V agree to rtol = atol = 1e-4 (the matmuls sum in a different order, so
the K/V bits — and hence the KV ciphertext — may differ).  Crypto
accounting (sealed bytes, closes, tokens) must be equal.

This file runs open-page sealing; ``test_torch_engine_legacy.py`` runs the
whole-page reseal path through the same harness.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import channel as jchannel  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.core import registers as jregs  # noqa: E402
from repro.models import registry  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import kv_pager as jkv  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import channel as tchannel  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.core import registers as tregs  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve import kv_pager as tkv  # noqa: E402
from repro_torch.serve.runner import Runner, Request  # noqa: E402

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PAGE, MAX_PAGES, CHUNK, N_PAGES, SLOTS = 8, 5, 16, 32, 4
PROMPT_LENS = (5, 13, 20, 9)      # 20 > CHUNK: two prefill chunks
MAX_NEW = 12                      # decode crosses page boundaries
KEYS = {"alice": (0x11111111, 0x22222222), "bob": (0x33333333, 0x44444444),
        "provider": (0x55555555, 0x66666666)}
SIDES = {"jax": (jchannel, jpolicy, jregs, jkv, jengine),
         "torch": (tchannel, tpolicy, tregs, tkv, tengine)}


def to_np(t) -> np.ndarray:
    """uint32 words of either side (the port keeps them as int32 bits)."""
    if isinstance(t, torch.Tensor):
        return t.numpy().view(np.uint32)
    return np.asarray(t)


def channels(side: str) -> dict:
    ch_mod, pol, regs, _, _ = SIDES[side]
    extra = {"device": "cpu"} if side == "torch" else {}
    out = {}
    for i, (name, words) in enumerate(KEYS.items()):
        kb = bytes([i + 1]) * 32
        out[name] = ch_mod.SecureChannel(
            key_words=np.array(words, np.uint32), key_bytes=kb,
            config=pol.SecurityConfig(),
            host_regs=regs.HostRegisterFile(key=kb),
            device_regs=regs.DeviceRegisterFile(key=kb),
            session_id=30 + i, **extra)
    return out


def build(side: str, open_pages: bool, np_params):
    ch = channels(side)
    _, _, _, kv, eng_mod = SIDES[side]
    if side == "jax":
        cfg = jconfigs.get_config("granite-3-2b", smoke=True)
        params = jax.tree_util.tree_map(jnp.asarray, np_params)
        dt, extra = jnp.float32, {}
    else:
        cfg = tconfigs.get_config("granite-3-2b", smoke=True)
        params = ttransformer.params_from_numpy(np_params, "cpu")
        dt, extra = torch.float32, {"device": "cpu"}
    pool = kv.PagedKVPool(n_pages=N_PAGES, page_size=PAGE,
                          n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                          hd=cfg.hd, dtype=dt, chunk_words=128,
                          open_pages=open_pages, **extra)
    eng = eng_mod.PagedEngine(cfg=cfg, params=ch["provider"].upload_tree(params),
                              channel=ch["provider"], pool=pool,
                              max_slots=SLOTS, max_pages=MAX_PAGES,
                              prefill_chunk=CHUNK)
    return eng, ch


def requests(ch, lens, max_new, seed):
    rng = np.random.RandomState(seed)
    return [Request(i, ("alice", "bob")[i % 2],
                    rng.randint(0, 512, n).astype(np.int32), max_new,
                    ch[("alice", "bob")[i % 2]])
            for i, n in enumerate(lens)]


def snapshot(pool) -> dict:
    return {name: (v.clone() if isinstance(v, torch.Tensor) else v)
            for name, v in zip(("k_ct", "v_ct", "k_tags", "v_tags", "k_stags",
                                "v_stags", "nonces", "keys", "open_flags",
                                "fill"), pool.arrays())}


def run_pair(open_pages: bool) -> dict:
    """Serve the script on both engines; keep what the tests compare."""
    cfg = jconfigs.get_config("granite-3-2b", smoke=True)
    np_params = jax.tree_util.tree_map(
        np.asarray, registry.get_model(cfg).init(jax.random.PRNGKey(0), cfg))
    out = {}
    for side in SIDES:
        eng, ch = build(side, open_pages, np_params)
        runner = Runner(eng, provider=ch["provider"])
        reqs = requests(ch, PROMPT_LENS, MAX_NEW, seed=0)
        for r in reqs:
            runner.admit(r)
        pages = {r.rid: list(r.pages) for r in reqs}
        runner.prefill_step({"emitted": [], "finished": [], "poisoned": []})
        after_prefill = snapshot(eng.pool)
        while runner.live:
            runner.step()
        out[side] = {"engine": eng, "channels": ch, "runner": runner,
                     "tokens": {r.rid: r.tokens_out for r in reqs},
                     "pages": pages, "after_prefill": after_prefill,
                     "stats": {k: eng.pool.stats[k]
                               for k in eng.pool.stats}}
    return out


@pytest.fixture(scope="module")
def runs():
    return run_pair(open_pages=True)


def test_token_streams_equal_reference(runs):
    assert runs["jax"]["tokens"] == runs["torch"]["tokens"]
    assert all(len(t) == MAX_NEW for t in runs["torch"]["tokens"].values())


def test_sealed_byte_accounting_equals_reference(runs):
    js, ts = runs["jax"]["stats"], runs["torch"]["stats"]
    assert js == ts
    assert ts["page_closes"] > 0
    per_tok = {s: sum(runs[s]["stats"][f"sealed_bytes_{b}"]
                      for b in ("prefill", "decode", "swap"))
               / runs[s]["stats"]["decode_tokens"] for s in SIDES}
    assert per_tok["jax"] == per_tok["torch"]


def test_prefilled_pages_unseal_to_the_same_kv(runs):
    """Each pool's pages, opened by its own unseal_page, verify and hold
    K/V that agree to 1e-4 over every prefilled slot."""
    assert runs["jax"]["pages"] == runs["torch"]["pages"]
    js, ts = runs["jax"]["after_prefill"], runs["torch"]["after_prefill"]
    checked = 0
    for rid, pages in runs["torch"]["pages"].items():
        n_pref = min(PROMPT_LENS[rid], CHUNK)   # first chunk only so far
        for j, p in enumerate(pages):
            slots = min(PAGE, n_pref - j * PAGE)
            if slots <= 0:
                continue
            jk, jv, jok = jkv.unseal_page(
                js["k_ct"][p], js["v_ct"][p], js["k_tags"][p],
                js["v_tags"][p], js["keys"][p], js["nonces"][p],
                jnp.float32, 128)
            tk, tv, tok = tkv.unseal_page(
                ts["k_ct"][p], ts["v_ct"][p], ts["k_tags"][p],
                ts["v_tags"][p], ts["keys"][p], ts["nonces"][p],
                torch.float32, 128)
            assert bool(jok) and bool(tok)
            np.testing.assert_allclose(np.asarray(jk)[:, :slots],
                                       tk[:, :slots].numpy(),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(np.asarray(jv)[:, :slots],
                                       tv[:, :slots].numpy(),
                                       rtol=1e-4, atol=1e-4)
            if bool(ts["open_flags"][p]):
                assert int(ts["fill"][p]) == int(js["fill"][p]) == slots
                assert bool(tkv.verify_open_page(
                    ts["k_ct"][p], ts["v_ct"][p], ts["k_stags"][p],
                    ts["v_stags"][p], ts["keys"][p], ts["nonces"][p],
                    ts["fill"][p], 128))
            np.testing.assert_array_equal(to_np(js["nonces"][p]),
                                          to_np(ts["nonces"][p]))
            checked += 1
    assert checked >= len(PROMPT_LENS)


def test_tampered_page_and_weight_poison_the_same_lanes(runs):
    poisoned = {}
    for side in SIDES:
        eng, ch = runs[side]["engine"], runs[side]["channels"]
        runner = Runner(eng, provider=ch["provider"])
        reqs = requests(ch, (6, 10, 7, 11), 6, seed=1)
        for r in reqs:
            runner.admit(r)
        ev = {"emitted": [], "finished": [], "poisoned": []}
        runner.prefill_step(ev)
        runner.decode_step(ev)
        assert not ev["poisoned"]
        page = reqs[0].pages[0]            # alice's first request
        if side == "jax":
            eng.pool.k_ct = eng.pool.k_ct.at[page, 0, 0, 0, 0].set(
                eng.pool.k_ct[page, 0, 0, 0, 0] ^ 1)
        else:
            eng.pool.k_ct[page, 0, 0, 0, 0] ^= 1
        ev = {"emitted": [], "finished": [], "poisoned": []}
        runner.decode_step(ev)
        page_poisoned = sorted(ev["poisoned"])
        leaf = eng.params["embed"]
        if side == "jax":
            leaf.ct = leaf.ct.at[3, 1].set(leaf.ct[3, 1] ^ 4)
        else:
            leaf.ct[3, 1] ^= 4
        ev = {"emitted": [], "finished": [], "poisoned": []}
        runner.decode_step(ev)
        poisoned[side] = (page_poisoned, sorted(ev["poisoned"]),
                          [r.status for r in reqs])
    assert poisoned["jax"] == poisoned["torch"]
    assert poisoned["torch"][0] == [0]
    assert poisoned["torch"][1] == [1, 2, 3]
    assert poisoned["torch"][2] == ["poisoned"] * 4
