"""The traffic generator: a seed repeats, sizes stay within the cell's
parameters, and every seed gets the same sizes in another order."""
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from benchlib import traffic

BENCH = Path(__file__).resolve().parents[1]


def _traffic(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def _requests(t, seed, n):
    loop = traffic.ClosedLoop(t, seed, vocab=49155)
    return [loop.next(i % loop.clients) for i in range(n)]


@pytest.mark.parametrize("seed", [0, 2**31 + 12345, 98765432109876])
def test_closed_loop_repeats_for_a_seed(seed):
    t = _traffic("code")
    a, b = _requests(t, seed, 70), _requests(t, seed, 70)
    for x, y in zip(a, b):
        assert (x.max_new, x.tenant, x.client) == (y.max_new, y.tenant,
                                                   y.client)
        np.testing.assert_array_equal(x.prompt, y.prompt)


def test_closed_loop_sizes_within_parameters():
    t = _traffic("code")
    for r in _requests(t, 7, 200):
        assert t["prompt"]["min"] <= len(r.prompt) <= t["prompt"]["cap"]
        assert t["new"]["min"] <= r.max_new <= t["new"]["max"]
        assert r.prompt.dtype == np.int32
        assert 0 <= r.prompt.min() and r.prompt.max() < 49155
        assert r.tenant == r.client // t["clients_per_tenant"]


def test_every_seed_gets_the_same_sizes_in_each_block():
    t = _traffic("code")
    n = t["block"]

    def blocks(seed):
        rs = _requests(t, seed, 3 * n)
        return [Counter((len(r.prompt), r.max_new) for r in
                        rs[i * n:(i + 1) * n]) for i in range(3)], \
            [len(r.prompt) for r in rs]

    (b1, o1), (b2, o2) = blocks(1), blocks(2)
    prompts = [Counter(k[0] for k in b.elements()) for b in b1 + b2]
    news = [Counter(k[1] for k in b.elements()) for b in b1 + b2]
    assert all(p == prompts[0] for p in prompts)
    assert all(m == news[0] for m in news)
    assert o1 != o2


def test_code_lengths_keep_the_trace_medians_and_fit_a_sequence():
    t = _traffic("code")
    rs = _requests(t, 3, t["block"])
    assert np.median([len(r.prompt) for r in rs]) == pytest.approx(1500,
                                                                   abs=1)
    assert np.median([r.max_new for r in rs]) == 13
    e = t["engine"]
    room = e["max_pages_per_seq"] * e["page_size"]
    assert max(len(r.prompt) + r.max_new for r in rs) <= room


def test_prompt_lengths_are_log_uniform_quantiles():
    q = traffic.quantiles("log_uniform", 256, 1792, 32)
    assert q[0] > 256 and q[-1] < 1792
    np.testing.assert_allclose(np.diff(np.log(q)), np.log(7) / 32, rtol=1e-9)


def test_train_batches_repeat_and_differ_by_step():
    t = _traffic("train-8k")
    a = traffic.train_batch(t, 5, 0, vocab=32000)
    b = traffic.train_batch(t, 5, 0, vocab=32000)
    c = traffic.train_batch(t, 5, 1, vocab=32000)
    shape = (t["microbatches"], t["batch"], t["seq_len"])
    assert a["tokens"].shape == a["labels"].shape == shape
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    np.testing.assert_array_equal(a["tokens"][..., 1:], a["labels"][..., :-1])
    rows = a["tokens"].reshape(-1, t["seq_len"])
    assert len({r.tobytes() for r in rows}) == len(rows)
