"""The port's KV page functions and pool against ``repro.serve.kv_pager``.

Every page function gets the same plaintext / ciphertext, keys and nonces
in both packages and must give byte-identical ciphertext, tags and
verdicts.  The pool is driven through the same allocator script in both.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.serve import kv_pager as jkv  # noqa: E402
from repro_torch.serve import kv_pager as tkv  # noqa: E402

torch.set_num_threads(1)

SHAPE = (2, 4, 2, 16)        # [L, page_size, K, hd]
CW = 16
BASE = np.array([0x31415926, 0x27182818], np.uint32)
NONCE = 0x0D050100
_SIGNED = {np.dtype(np.uint32): np.int32, np.dtype(np.uint16): np.int16}


def to_t(a) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype in _SIGNED:
        a = a.view(_SIGNED[a.dtype])
    return torch.from_numpy(a.copy())


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view({torch.int32: np.uint32,
                           torch.int16: np.uint16}[t.dtype])


def same(j, t):
    np.testing.assert_array_equal(np.asarray(j), to_np(t))


def pages(dtype, seed=0):
    rng = np.random.RandomState(seed)
    k, v = rng.randn(*SHAPE).astype(np.float32), rng.randn(*SHAPE).astype(
        np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    return ((jnp.asarray(k).astype(jdt), jnp.asarray(v).astype(jdt)),
            (torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)))


def sealed_pair(dtype):
    (jk, jv), (tk, tv) = pages(dtype)
    j = jkv.seal_page(jk, jv, jnp.asarray(BASE), np.uint32(NONCE), CW)
    t = tkv.seal_page(tk, tv, to_t(BASE), NONCE, CW)
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seal_and_unseal_page_match_reference(dtype):
    j, t = sealed_pair(dtype)
    for a, b in zip(j, t):
        same(a, b)
    (_, _), (tk, tv) = pages(dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jout = jkv.unseal_page(*j, jnp.asarray(BASE), np.uint32(NONCE), jdt, CW)
    k, v, ok = tkv.unseal_page(*t, to_t(BASE), NONCE, tk.dtype, CW)
    assert bool(jout[2]) and bool(ok)
    assert torch.equal(k, tk) and torch.equal(v, tv)
    bad = t[1].clone()
    bad[1, 2, 1, 3] ^= 1
    assert not bool(tkv.unseal_page(t[0], bad, t[2], t[3], to_t(BASE), NONCE,
                                    tk.dtype, CW)[2])


def test_bitcast_page_matches_reference():
    (jk, jv), (tk, tv) = pages("bfloat16")
    for a, b in zip(jkv.bitcast_page(jk, jv), tkv.bitcast_page(tk, tv)):
        same(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seal_slot_matches_reference_and_page_slice(dtype):
    (jk, jv), (tk, tv) = pages(dtype, 1)
    _, t = sealed_pair(dtype)
    (jk0, jv0), (tk0, tv0) = pages(dtype)
    for slot in range(SHAPE[1]):
        jo = jkv.seal_slot(jk0[:, slot], jv0[:, slot], jnp.asarray(BASE),
                           np.uint32(NONCE), slot, SHAPE[1], CW)
        to = tkv.seal_slot(tk0[:, slot], tv0[:, slot], to_t(BASE), NONCE,
                           slot, SHAPE[1], CW)
        for a, b in zip(jo, to):
            same(a, b)
        # positional keystream: the slot's ciphertext IS the page's slice
        assert torch.equal(to[0], t[0][:, slot])
        assert torch.equal(to[1], t[1][:, slot])


def test_page_slot_tags_and_verify_open_page_match_reference():
    j, t = sealed_pair("bfloat16")
    jt = jkv.page_slot_tags(j[0], j[1], jnp.asarray(BASE), np.uint32(NONCE),
                            CW)
    tt = tkv.page_slot_tags(t[0], t[1], to_t(BASE), NONCE, CW)
    same(jt[0], tt[0])
    same(jt[1], tt[1])
    kst, vst = tt[0].clone(), tt[1].clone()
    kst[3] ^= 5                      # a wrong tag on slot 3
    for fill in range(SHAPE[1] + 1):
        want = bool(jkv.verify_open_page(
            j[0], j[1], jnp.asarray(to_np(kst)), jnp.asarray(to_np(vst)),
            jnp.asarray(BASE), np.uint32(NONCE), fill, CW))
        got = bool(tkv.verify_open_page(t[0], t[1], kst, vst, to_t(BASE),
                                        NONCE, torch.tensor(fill), CW))
        assert want == got == (fill <= 3)


@pytest.mark.parametrize("tamper", [False, True])
def test_close_reopen_and_cow_match_reference(tamper):
    j, t = sealed_pair("bfloat16")
    kst, vst = tkv.page_slot_tags(t[0], t[1], to_t(BASE), NONCE, CW)
    kct = t[0].clone()
    if tamper:
        kct[0, 1, 0, 2] ^= 1 << 3     # inside written slot 1
    jkct = jnp.asarray(to_np(kct))
    jst = (jnp.asarray(to_np(kst)), jnp.asarray(to_np(vst)))
    jo = jkv.close_page(jkct, j[1], *jst, jnp.asarray(BASE), np.uint32(NONCE),
                        3, jnp.bfloat16, CW)
    to = tkv.close_page(kct, t[1], kst, vst, to_t(BASE), NONCE,
                        torch.tensor(3), torch.bfloat16, CW)
    for a, b in zip(jo[:4], to[:4]):
        same(a, b)
    assert bool(jo[4]) == bool(to[4]) == (not tamper)
    n2 = NONCE + 1
    jr = jkv.reopen_page(*jo[:4], jnp.asarray(BASE), np.uint32(n2),
                         jnp.bfloat16, CW)
    tr = tkv.reopen_page(*to[:4], to_t(BASE), n2, torch.bfloat16, CW)
    for a, b in zip(jr[:4], tr[:4]):
        same(a, b)
    assert bool(jr[4]) == bool(tr[4]) == (not tamper)
    dst = np.array([0x1, 0x2], np.uint32)
    jc = jkv.cow_page(*jo[:4], jnp.asarray(BASE), np.uint32(n2),
                      jnp.asarray(dst), np.uint32(77), jnp.bfloat16, CW)
    tc = tkv.cow_page(*to[:4], to_t(BASE), n2, to_t(dst), 77, torch.bfloat16,
                      CW)
    for a, b in zip(jc[:4], tc[:4]):
        same(a, b)
    assert bool(jc[4]) == bool(tc[4]) == (not tamper)


def test_batched_page_functions_equal_one_page_at_a_time():
    rng = np.random.RandomState(4)
    k = torch.from_numpy(rng.randn(3, *SHAPE).astype(np.float32)).bfloat16()
    v = torch.from_numpy(rng.randn(3, *SHAPE).astype(np.float32)).bfloat16()
    keys = to_t(rng.randint(0, 2**32, (3, 2), dtype=np.uint64)
                .astype(np.uint32))
    nonces = torch.tensor([5, 6, -7], dtype=torch.int32)
    batch = tkv.seal_page(k, v, keys, nonces, CW)
    stags = tkv.page_slot_tags(batch[0], batch[1], keys, nonces, CW)
    okb = tkv.unseal_page(*batch, keys, nonces, torch.bfloat16, CW)[2]
    assert okb.shape == (3,) and bool(okb.all())
    for i in range(3):
        one = tkv.seal_page(k[i], v[i], keys[i], int(nonces[i]), CW)
        for a, b in zip(batch, one):
            assert torch.equal(a[i], b)
        one_st = tkv.page_slot_tags(one[0], one[1], keys[i], nonces[i], CW)
        assert torch.equal(stags[0][i], one_st[0])
        assert torch.equal(stags[1][i], one_st[1])
    slots = torch.tensor([0, 2, 3])
    s = tkv.seal_slot(k[:, :, 0], v[:, :, 0], keys, nonces, slots, SHAPE[1],
                      CW)
    for i in range(3):
        one = tkv.seal_slot(k[i, :, 0], v[i, :, 0], keys[i], nonces[i],
                            int(slots[i]), SHAPE[1], CW)
        for a, b in zip(s, one):
            assert torch.equal(a[i], b)


def test_pool_allocator_guards_and_accounting_match_reference():
    kw = dict(n_pages=9, page_size=4, n_layers=2, n_kv_heads=2, hd=16,
              chunk_words=CW)
    jp = jkv.PagedKVPool(dtype=jnp.bfloat16, **kw)
    tp = tkv.PagedKVPool(dtype=torch.bfloat16, device="cpu", **kw)
    assert jp.n_tags == tp.n_tags and jp.page_bytes == tp.page_bytes
    script = []
    for pool in (jp, tp):
        a = pool.alloc(3, "alice", BASE, [NONCE, NONCE + 6, NONCE + 12],
                       span=6)
        b = pool.alloc(2, "bob", BASE[::-1], [9, 15])
        exhausted = jkv.PoolExhausted if pool is jp else tkv.PoolExhausted
        with pytest.raises(exhausted):
            pool.alloc(9, "carol", BASE, [0] * 9)
        for _ in range(5):
            pool.spend_nonce(a[0])
        with pytest.raises(Exception, match="reserved span"):
            pool.spend_nonce(a[0])
        pool.make_shared([b[0]])
        pool.map_shared([b[0]])
        pool.map_shared([b[0]])
        with pytest.raises(ValueError):
            pool.free([b[0]])
        pool.release_shared([b[0]])
        pool.unmap_shared([b[0]])
        still = pool.is_shared(b[0])
        pool.unmap_shared([b[0]])
        pool.note_prefill(3, lanes=[("alice", 2), ("bob", 1)])
        pool.note_decode(2, owners=["alice", "bob"])
        pool.note_close(a[2], "decode", True)
        pool.note_reopen(a[1], True)
        pool.note_cow(b[1], a[0], True)
        pool.free([a[1]])
        script.append((a, b, still, pool.free_pages, pool.live_pages,
                       pool.nonce_spent(a[0]), pool.pages_of("alice"),
                       pool.owner_of(b[1]), dict(pool.stats.items()),
                       sorted(h["id"] for h in pool.headroom())))
        pool.mark_open([a[2]], 2)
    assert script[0] == script[1]
    same(jp.nonces, tp.nonces)
    same(jp.keys, tp.keys)
    np.testing.assert_array_equal(np.asarray(jp.open_flags),
                                  tp.open_flags.numpy())
    np.testing.assert_array_equal(np.asarray(jp.fill), tp.fill.numpy())
    tp.reset_window()
    assert tp.stats["sealed_bytes_prefill"] == 0 and tp.stats["allocs"] == 5
