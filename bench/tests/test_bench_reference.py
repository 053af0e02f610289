"""The plain reference against the port's CPU path at the configurations'
small sizes, in float32: the same weights give the same loss, gradients
and logits."""
import json
from pathlib import Path

import pytest
import torch

from benchlib import reference, weights
from benchlib.cell import port_config
from benchlib.sizes import sizes_of

BENCH = Path(__file__).resolve().parents[1]
CONFIGS = sorted(p.stem for p in (BENCH / "configs").glob("*.json"))


def _pair(name):
    entry = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    entry["smoke"] = {**entry["smoke"], "torch_dtype": "float32"}
    return sizes_of(entry, smoke=True), port_config(entry, smoke=True)


def _tokens(sz, B, S, seed):
    g = torch.Generator().manual_seed(seed)
    seq = torch.randint(0, sz.vocab, (B, S + 1), generator=g)
    return seq[:, :-1], seq[:, 1:]


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_gradients_match_the_port(name):
    from repro_torch.models import registry

    sz, cfg = _pair(name)
    tokens, labels = _tokens(sz, 2, 40, 1)
    mine = weights.make_tree(sz, 3, "cpu")
    theirs = weights.make_tree(sz, 3, "cpu")
    leaves = [x.requires_grad_(True) for x in _leaves(mine)]
    tleaves = [x.requires_grad_(True) for x in _leaves(theirs)]
    with reference.exact_float32():
        loss = reference.Ref(sz, mine).loss(tokens, labels)
    loss.backward()
    tloss = registry.get_model(cfg).loss(theirs, cfg,
                                         {"tokens": tokens, "labels": labels})
    tloss.backward()
    assert float(loss.detach()) == pytest.approx(float(tloss.detach()),
                                                rel=1e-5)
    for a, b in zip(leaves, tleaves):
        err = float((a.grad - b.grad).norm() / b.grad.norm().clamp(min=1e-30))
        assert err < 1e-4


@pytest.mark.parametrize("name", CONFIGS)
def test_the_float8_control_reads_apart(name):
    sz, _ = _pair(name)
    tokens, labels = _tokens(sz, 2, 40, 2)
    p = weights.make_tree(sz, 5, "cpu")
    with torch.no_grad():
        a = reference.Ref(sz, p).loss(tokens, labels)
        b = reference.Ref(sz, p, "fp8").loss(tokens, labels)
    assert 1e-5 < abs(float(a) - float(b)) / float(a) < 0.2


def test_adamw_follows_the_port_optimizer():
    from repro_torch.optim import AdamW

    g = torch.Generator().manual_seed(4)
    ps = [torch.randn(6, 5, generator=g).to(torch.bfloat16),
          torch.randn(7, generator=g)]
    gs = [torch.randn(6, 5, generator=g) for _ in range(1)] + \
        [torch.randn(7, generator=g) * 10]
    port = AdamW(lr=1e-2)
    st = port.init(list(ps))
    new, _ = port.apply(st, [x.to(p.dtype) for x, p in zip(gs, ps)])
    mine = [p.float().clone() for p in ps]
    mu = [torch.zeros_like(p) for p in mine]
    nu = [torch.zeros_like(p) for p in mine]
    reference.AdamW(lr=1e-2).step(1, mine, gs, mu, nu,
                                  [p.dtype for p in ps])
    for a, b in zip(mine, new.params):
        torch.testing.assert_close(a, b.float(), rtol=1e-6, atol=1e-9)
    for a, b in zip(mu, new.mu):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_a_configuration_runs_its_departures_over_the_published_values():
    entry = json.loads((BENCH / "configs" / "granite-3-2b.json").read_text())
    sz = sizes_of(entry)
    assert entry["tie_word_embeddings"] and not sz.tie_embeddings
    assert entry["rms_norm_eps"] == 1e-5 and sz.norm_eps == 1e-6
    assert sz.values["embedding_multiplier"] == 1.0
    assert sz.fam.PORT_FAMILY == port_config(entry).family == "dense"
    # the published multipliers are not what the port's dense block runs
    published = {k: v for k, v in entry.items() if k != "departures"}
    with pytest.raises(ValueError):
        port_config(published)
