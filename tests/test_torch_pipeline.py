"""The port's sealed pipeline (``parallel/pipeline.py``) against the
unpipelined model and the reference's pipeline.

Two gloo processes on the CPU are the two stages of ``test_pipeline.py``'s
config (4 layers, d_model 64, float32; M 3 microbatches of 2 x 16
tokens); weights come from the reference's ``init``.  Limits: the loss
within 1e-4 of the unpipelined mean and of the reference's pipelined loss
(run in a subprocess on a (2, 2, 2) mesh of host devices), sealed and
plain; every gradient within atol 2e-3 of the unpipelined gradients (the
reference test's limits).  Bit for bit: the ciphertext of every hop,
forward and backward, equals the reference's ``cipher.seal_bits`` of the
same activations under the same nonce.  A control that unseals the
backward hop with the forward domain (0 for 8) must fail the gradient
limit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import torch_dist  # noqa: E402
from repro.core import cipher as jcipher  # noqa: E402
from repro_torch.models import registry as tregistry  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.parallel import pipeline  # noqa: E402

torch.set_num_threads(1)

CFG = dict(arch_id="pp", family="dense", n_layers=4, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab=97, q_block=8, dtype="float32",
           param_dtype="float32", remat="none")
M, BM, S = 3, 2, 16
KEY = np.array([5, 6], np.uint32)
LOSS_TOL, GRAD_ATOL = 1e-4, 2e-3

REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
from repro.models.config import ModelConfig
from repro.models import registry
from repro.parallel.pipeline import make_pipelined_loss, stack_params_by_stage
cfg = ModelConfig(**%r)
m = registry.get_model(cfg)
params = m.init(jax.random.PRNGKey(0), cfg)
tok = jax.random.randint(jax.random.PRNGKey(1), (%d, %d, %d), 0, cfg.vocab)
batch = {"tokens": tok, "labels": tok}
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
out = {"tok": tok}
staged = stack_params_by_stage(params, 2)
for name, key in (("plain", None), ("sealed", jnp.array(%r, jnp.uint32))):
    fn = make_pipelined_loss(cfg, mesh, n_stages=2, n_micro=%d, seal_key=key)
    out["loss_" + name] = jax.jit(fn)(staged, batch)
def walk(t, pre):
    for k, v in t.items():
        if isinstance(v, dict):
            walk(v, pre + k + "/")
        else:
            out[pre + k] = v
walk(params, "p/")
np.savez(%r, **{k: np.asarray(v) for k, v in out.items()})
"""


def load(path):
    ref = dict(np.load(path))
    params = tregistry.params_from_numpy(torch_dist.nest(
        {k[2:]: v for k, v in ref.items() if k.startswith("p/")}), "cpu")
    tok = torch.from_numpy(ref["tok"].astype(np.int64))
    return params, {"tokens": tok, "labels": tok}, ref


def _stage(rank, port, out_dir):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_mesh

    torch_dist.init_gloo(rank, port, 2)
    try:
        mesh = make_smoke_mesh(2, pods=2, device_type="cpu")   # (2, 1, 1)
        params, batch, _ = load(f"{out_dir}/ref.npz")
        cfg = ModelConfig(**CFG)
        staged = pipeline.stack_params_by_stage(params, 2)
        key = torch.from_numpy(KEY.view(np.int32).copy())
        res = {}
        for name, k in (("plain", None), ("sealed", key)):
            fn = pipeline.make_pipelined_loss(cfg, mesh, 2, M, seal_key=k)
            res["loss_" + name] = fn(staged, batch).numpy()
        hops = []
        seal = pipeline._seal_hop

        def recorded(x, key, tick, sender, domain):
            ct = seal(x, key, tick, sender, domain)
            hops.append((x.detach().clone(), tick, sender, domain, ct))
            return ct

        pipeline._seal_hop = recorded
        fn = pipeline.make_pipelined_loss(cfg, mesh, 2, M, seal_key=key)
        res["vg_loss"], grads = fn.value_and_grad(staged, batch)
        pipeline._seal_hop = seal
        for i, (x, tick, sender, domain, ct) in enumerate(hops):
            res[f"hop{i}/x"], res[f"hop{i}/ct"] = x.numpy(), ct.numpy()
            res[f"hop{i}/nonce"] = pipeline.hop_nonce(tick, sender, domain)
        res.update({"g/" + p: g.numpy()
                    for p, g in torch_dist.flat(grads).items()})
        unseal = pipeline._unseal_hop
        pipeline._unseal_hop = (lambda ct, key, tick, sender, domain, dt:
                                unseal(ct, key, tick, sender, 0, dt))
        _, ctl = fn.value_and_grad(staged, batch)
        res.update({"ctl/" + p: g.numpy()
                    for p, g in torch_dist.flat(ctl).items()})
        np.savez(f"{out_dir}/stage{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline")
    torch_dist.reference(REFERENCE % (CFG, M, BM, S, KEY.tolist(), M,
                                      str(out / "ref.npz")), n_devices=8)
    torch_dist.spawn(_stage, 2, out, timeout=150)
    return out, [dict(np.load(out / f"stage{r}.npz")) for r in range(2)]


def unpipelined(params, batch):
    """The mean over microbatches of the model's loss, and its gradients
    with the layer leaves stacked by stage."""
    cfg = ModelConfig(**CFG)
    params = torch_dist.nest({p: t.clone().requires_grad_(True)
                              for p, t in torch_dist.flat(params).items()})
    loss = torch.stack([ttransformer.loss(
        params, cfg, {"tokens": batch["tokens"][i],
                      "labels": batch["labels"][i]}) for i in range(M)]
    ).mean()
    loss.backward()
    grads = pipeline.stack_params_by_stage(
        torch_dist.nest({p: t.grad for p, t in
                         torch_dist.flat(params).items()}), 2)
    return loss.item(), grads


def grad_errors(stages, want, prefix):
    errs = {}
    for path, g in torch_dist.flat(want).items():
        for s, st in enumerate(stages):
            got = st[prefix + path]
            ref = g[s] if path.startswith("layers/") else g
            err = np.abs(got - ref.numpy())
            errs[f"{path}@{s}"] = (float(err.max()) if np.isfinite(err).all()
                                   else np.inf)
    return errs


def test_pipelined_loss_matches_unpipelined_and_reference(runs):
    out, stages = runs
    params, batch, ref = load(out / "ref.npz")
    loss, _ = unpipelined(params, batch)
    for st in stages:
        for name in ("plain", "sealed"):
            got = float(st["loss_" + name])
            print(f"{name}: pipelined {got} unpipelined {loss} reference "
                  f"{float(ref['loss_' + name])}")
            assert abs(got - loss) <= LOSS_TOL
            assert abs(got - float(ref["loss_" + name])) <= LOSS_TOL
        assert abs(float(st["vg_loss"]) - loss) <= LOSS_TOL


def test_pipelined_grads_match_unpipelined(runs):
    out, stages = runs
    params, batch, _ = load(out / "ref.npz")
    _, want = unpipelined(params, batch)
    errs = grad_errors(stages, want, "g/")
    print(f"max grad err {max(errs.values()):.3g}")
    assert max(errs.values()) <= GRAD_ATOL, errs
    ctl = grad_errors(stages, want, "ctl/")
    print(f"control (backward hop unsealed in domain 0): max grad err "
          f"{max(ctl.values()):.3g}")
    assert max(ctl.values()) > GRAD_ATOL


def test_hop_ciphertext_matches_reference_seal_bits(runs):
    _, stages = runs
    n = 0
    for st in stages:
        for i in range(len([k for k in st if k.endswith("/ct")])):
            x, ct = st[f"hop{i}/x"], st[f"hop{i}/ct"]
            want = jcipher.seal_bits(jnp.asarray(x), jnp.asarray(KEY),
                                     jnp.uint32(int(st[f"hop{i}/nonce"])))
            np.testing.assert_array_equal(ct.view(np.uint32),
                                          np.asarray(want))
            n += 1
    # stage 0 seals M forward hops, stage 1 seals M backward hops
    assert n == 2 * M
