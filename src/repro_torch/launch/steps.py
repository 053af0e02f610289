"""Step builders shared by the training launcher and chip_smoke.py (torch
port of ``repro.launch.steps``): the cell of one (arch x shape x security)
choice, its abstract states and their shardings over a device mesh, and
the step callables of every family.

The abstract states are built on ``torch.device("meta")`` (the reference's
``jax.eval_shape``): shapes and dtypes, no memory.  A sharding is a
``parallel.sharding.Sharding`` (mesh, one DTensor placement per mesh dim).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor

from .. import configs
from ..core import sealed as sealed_lib
from ..core.channel import resolve_device
from ..core.policy import SecurityConfig
from ..models import registry
from ..models.config import SHAPES_BY_NAME, ShapeConfig
from ..optim import AdamW, TrainState
from ..parallel import sharding as shd
from ..train import trainer as trainer_lib

# the reference's cell key (uint32 words, kept as int32 with the same bits)
CELL_KEY = (0x5EC0DE, 0xFACADE)


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape: ShapeConfig
    cfg: Any
    model: Any
    sec: SecurityConfig
    key: torch.Tensor
    opt: Optional[AdamW] = None

    @property
    def sealed(self) -> bool:
        return self.sec.enabled


def make_cell(arch_id: str, shape_name: str, *, smoke: bool = False,
              security: str = "trusted", overrides: dict | None = None,
              device="cuda") -> Cell:
    """The config (remat "full" at full size), security, cell key on
    ``device`` and AdamW with the config's moment dtype."""
    cfg = configs.get_config(arch_id, smoke=smoke)
    if not smoke:
        cfg = cfg.with_(remat="full")
    if overrides:
        cfg = cfg.with_(**overrides)
    if security == "off":
        sec = SecurityConfig.off()
    elif security == "ctr":
        sec = SecurityConfig.ctr_only()
    else:
        sec = SecurityConfig()
    key = torch.tensor(CELL_KEY, dtype=torch.int32,
                       device=resolve_device(device))
    opt = AdamW(lr=3e-4, state_dtype=configs.opt_state_dtype(arch_id))
    return Cell(arch_id=arch_id, shape=SHAPES_BY_NAME[shape_name], cfg=cfg,
                model=registry.get_model(cfg), sec=sec, key=key, opt=opt)


def batch_extra(cfg, seq_len: int) -> dict:
    """The frontend inputs a training batch carries, by name, with their
    per-sequence shapes: the VLM's patch embeddings, the encoder-decoder's
    frame embeddings (as many as the tokens)."""
    if cfg.frontend == "patch":
        return {"patch_embeds": (cfg.n_frontend_tokens, cfg.d_model)}
    if cfg.frontend == "frame":
        return {"frame_embeds": (seq_len, cfg.d_model)}
    return {}


# ---------------------------------------------------------------------------
# logical specs for (possibly sealed) trees
# ---------------------------------------------------------------------------

def state_logical_specs(cfg, model):
    """Plaintext-structure logical specs for a TrainState."""
    p = model.param_specs(cfg)
    return TrainState(step="r", params=p, mu=p, nu=p)


# ---------------------------------------------------------------------------
# abstract states (meta tensors) + shardings
# ---------------------------------------------------------------------------

def _meta_params(cell: Cell):
    return cell.model.init(torch.Generator(), cell.cfg, "meta")


def abstract_train_state(cell: Cell):
    state = cell.opt.init(_meta_params(cell))
    return trainer_lib.seal_state(state, cell.key, cell.sec)


def abstract_params(cell: Cell):
    params = _meta_params(cell)
    if cell.sealed:
        params = sealed_lib.seal_tree(params, cell.key, cell.sec.weights,
                                      1 << 8)
    return params


def abstract_decode_state(cell: Cell):
    cfg, shape = cell.cfg, cell.shape
    src_len = shape.seq_len if cfg.family == "encdec" else 0
    return registry.make_decode_state(cfg, shape.global_batch, shape.seq_len,
                                      src_len, sealed=cell.sealed,
                                      device="meta")


def train_state_shardings(cell: Cell, mesh, abstract=None):
    specs = state_logical_specs(cell.cfg, cell.model)
    abstract = abstract if abstract is not None else abstract_train_state(cell)
    return shd.tree_named_shardings(specs, mesh, abstract)


def params_shardings(cell: Cell, mesh, abstract=None):
    p = cell.model.param_specs(cell.cfg)
    abstract = abstract if abstract is not None else abstract_params(cell)
    return shd.tree_named_shardings(p, mesh, abstract)


def decode_state_shardings(cell: Cell, mesh, abstract=None):
    specs = registry.decode_state_specs(cell.cfg, sealed=cell.sealed)
    abstract = (abstract if abstract is not None
                else abstract_decode_state(cell))
    return shd.tree_named_shardings(specs, mesh, abstract)


def batch_shardings(cell: Cell, mesh, batch_specs: dict, stacked: bool):
    """tokens/labels/frontends ({name: (shape, dtype)}): the batch over the
    data axes, the accumulation dim unsharded."""
    ctx = shd.make_ctx(mesh)
    out = {}
    for k, (shape, _) in batch_specs.items():
        lead = (None,) if stacked else ()
        rest = (None,) * (len(shape) - len(lead) - 1)
        out[k] = ctx.named(*lead, "data", *rest, shape=shape)
    return out


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def make_train_step_fn(cell: Cell, grad_hook=None, in_place: bool = False):
    """The sealed train step, accumulating in the config's ``ACC_DTYPE``;
    ``in_place`` reseals into the state's own ciphertext (see
    ``train/trainer.py``)."""
    acc = (configs.acc_dtype(cell.arch_id)
           if cell.arch_id in configs.ARCH_IDS else "float32")
    return trainer_lib.make_train_step(cell.model, cell.cfg, cell.opt,
                                       cell.sec, cell.key,
                                       grad_hook=grad_hook, acc_dtype=acc,
                                       in_place=in_place)


def _mesh_of(*trees):
    """The mesh of the first DTensor among the trees' tensors (a sealed
    leaf's ciphertext included), or None: the step is then one
    process's."""
    for leaf in sealed_lib.tree_leaves(list(trees)):
        x = leaf.ct if sealed_lib.is_sealed(leaf) else leaf
        if isinstance(x, DTensor):
            return x.device_mesh
    return None


def _whole_tree(tree):
    return sealed_lib.tree_unflatten(
        tree, [sealed_lib.whole(x) for x in sealed_lib.tree_leaves(tree)])


def _open_params(cell: Cell, params, mesh):
    """(the parameters whole on every rank, the verdict on them): each
    rank verifies and decrypts its own blocks, the plaintext is gathered
    FSDP-style, and the verdict is the AND over the ranks."""
    ok = True
    if cell.sealed:
        params, ok = sealed_lib.unseal_tree(params, cell.key)
        if mesh is not None:
            ok = sealed_lib.all_ranks_ok(ok)
    return (params if mesh is None else _whole_tree(params)), ok


def _gate(ok, logits):
    return torch.where(torch.as_tensor(ok, device=logits.device), logits,
                       torch.nan)


def _state_regions(cell: Cell, mesh, batch: dict, max_len: int) -> dict:
    """{field: (Region, Sharding)} of this rank's blocks of the decode
    state a prefill of ``batch`` (whole) gives, in
    ``decode_state_shardings``."""
    cfg = cell.cfg
    src = batch["frame_embeds"].shape[1] if "frame_embeds" in batch else 0
    like = registry.make_decode_state(cfg, batch["tokens"].shape[0], max_len,
                                      src, sealed=cell.sealed, device="meta")
    sh = shd.tree_named_shardings(
        registry.decode_state_specs(cfg, sealed=cell.sealed), mesh, like)
    coord = mesh.get_coordinate()
    out = {}
    for f, x in like.items():
        if isinstance(x, torch.Tensor):
            offs, sizes = sealed_lib.block_of(tuple(x.shape), mesh,
                                              sh[f].placements, coord)
            out[f] = (sealed_lib.Region(tuple(x.shape), tuple(offs),
                                        tuple(sizes)), sh[f])
    return out


def make_prefill_fn(cell: Cell):
    """The prefill step: (params, batch) -> (last-token logits, decode
    state).  On a sharded state (DTensor leaves, ``params_shardings``;
    the batch's leaves may be DTensors of ``batch_shardings``) every rank
    runs the model on the whole parameters and the whole batch (the MoE's
    capacity is then the global batch's, as in one process), and seals
    only its own block of the decode state, against the whole state's
    counters, as a DTensor of ``decode_state_shardings``: its
    ciphertext is that block of one process's, bit for bit."""
    max_len = cell.shape.seq_len

    def prefill(params, batch):
        mesh = _mesh_of(params, batch)
        params, ok = _open_params(cell, params, mesh)
        ctx = (cell.key, 1) if cell.sealed else None
        if mesh is None:
            logits, cache = cell.model.prefill(params, cell.cfg, batch,
                                               max_len, seal_ctx=ctx)
            return _gate(ok, logits), cache
        batch = {k: sealed_lib.whole(v) for k, v in batch.items()}
        regions = _state_regions(cell, mesh, batch, max_len)
        logits, cache = cell.model.prefill(
            params, cell.cfg, batch, max_len, seal_ctx=ctx,
            blocks={f: r for f, (r, _) in regions.items()})
        for f, (r, sh) in regions.items():
            cache[f] = sealed_lib.wrap(cache[f], mesh, sh.placements,
                                       r.shape)
        return _gate(ok, logits), cache

    return prefill


def make_decode_fn(cell: Cell):
    """One decode step: (params, decode state, tokens [B]) -> (logits,
    decode state).  On a sharded state every rank gathers the state's
    ciphertext whole (never its plaintext), runs the one-process step
    and keeps its own block of the new state: the new slot survives only
    in the block of the rank that holds ``pos``.  ``pos`` and ``nonce``
    are replicated ints."""
    def decode(params, cache, tokens):
        mesh = _mesh_of(params, cache, tokens)
        params, ok = _open_params(cell, params, mesh)
        ctx = (cell.key, cache.get("nonce")) if cell.sealed else None
        if mesh is None:
            logits, cache = cell.model.decode_step(params, cell.cfg, cache,
                                                   tokens, seal_ctx=ctx)
            return _gate(ok, logits), cache
        full = {k: sealed_lib.whole(v) for k, v in cache.items()}
        logits, new = cell.model.decode_step(params, cell.cfg, full,
                                             sealed_lib.whole(tokens),
                                             seal_ctx=ctx)
        for k, like in cache.items():
            if isinstance(like, DTensor):
                mine = sealed_lib.take_block(new[k], like)
                new[k] = sealed_lib.wrap(
                    mine.clone(memory_format=torch.contiguous_format),
                    mesh, like.placements, like.shape)
        return _gate(ok, logits), new

    return decode


def stacked_batch_specs(cell: Cell, n_accum: int, microbatch: int = 0):
    """Train inputs with the grad-accumulation leading dim:
    {name: (shape, dtype)}."""
    mb = microbatch or configs.train_microbatch(cell.arch_id)
    base = configs.input_specs(cell.cfg, cell.shape, microbatch=mb)
    assert cell.shape.global_batch % mb == 0
    n = n_accum or cell.shape.global_batch // mb
    return {k: ((n, *shape), dt) for k, (shape, dt) in base.items()}
