"""The dense decoder family: a stack of pre-norm blocks, each RMSNorm,
grouped-query causal attention with RoPE on split halves, RMSNorm and a
SwiGLU MLP, between an embedding table and an untied unembedding.  These
are the equations of the port's ``family == "dense"`` models, which have
no score, embedding, residual or logit multipliers: attention scores are
scaled by head_dim ** -0.5.

What this file gives the benchmark: the parameter leaves in the port's
layout (``leaf_specs``), the forward pass for the plain reference
(``layers``), the model FLOP counts (``matmul_params``,
``attention_layers``) and the port's config fields (``port_fields``).
"""
from __future__ import annotations

from benchlib.reference import per_layer
from benchlib.weights import LeafSpec

PORT_FAMILY = "dense"

# the values of Granite-style multipliers that the port's dense block runs
IMPLIED = {"embedding_multiplier": 1.0, "residual_multiplier": 1.0,
           "logits_scaling": 1.0}


def block_leaves(sz, prefix: tuple, lead: tuple) -> list:
    """One transformer block's leaves under ``prefix``, each with the
    leading dimensions ``lead`` (a stack of layers, or none)."""
    D, hd, H, K, F = sz.d_model, sz.hd, sz.n_heads, sz.n_kv_heads, sz.d_ff
    pdt = sz.p_dtype
    return [
        LeafSpec(prefix + ("ln1",), lead + (D,), pdt, "norm"),
        LeafSpec(prefix + ("attn", "wq"), lead + (D, H * hd), pdt, "normal",
                 D ** -0.5),
        LeafSpec(prefix + ("attn", "wk"), lead + (D, K * hd), pdt, "normal",
                 D ** -0.5),
        LeafSpec(prefix + ("attn", "wv"), lead + (D, K * hd), pdt, "normal",
                 D ** -0.5),
        LeafSpec(prefix + ("attn", "wo"), lead + (H * hd, D), pdt, "normal",
                 (H * hd) ** -0.5),
        LeafSpec(prefix + ("ln2",), lead + (D,), pdt, "norm"),
        LeafSpec(prefix + ("mlp", "w_gate"), lead + (D, F), pdt, "normal",
                 D ** -0.5),
        LeafSpec(prefix + ("mlp", "w_up"), lead + (D, F), pdt, "normal",
                 D ** -0.5),
        LeafSpec(prefix + ("mlp", "w_down"), lead + (F, D), pdt, "normal",
                 F ** -0.5),
    ]


def leaf_specs(sz) -> list:
    """Every leaf: the embedding, the stacked [n_layers, ...] blocks under
    ``layers``, the final norm and the unembedding."""
    D, V, pdt = sz.d_model, sz.vocab, sz.p_dtype
    return ([LeafSpec(("embed",), (V, D), pdt, "embed", 0.02)]
            + block_leaves(sz, ("layers",), (sz.n_layers,))
            + [LeafSpec(("final_norm",), (D,), pdt, "norm"),
               LeafSpec(("unembed",), (D, V), pdt, "normal", D ** -0.5)])


def layers(ref, x, pos, ck):
    """The block stack of the reference ``ref`` over embedded ``x``;
    ``ck(fn, x)`` runs one block (checkpointed or not)."""
    for lp in per_layer(ref.p["layers"]):
        x = ck(lambda xx, lp=lp: ref.attn_mlp(lp, xx, pos), x)
    return x


def attention_layers(sz) -> int:
    """Full-attention layers a token passes through."""
    return sz.n_layers


def matmul_params(sz) -> int:
    """Parameters that multiply each token once in a forward pass: every
    weight matrix but the embedding table (a gather)."""
    D, hd, H, K, F = sz.d_model, sz.hd, sz.n_heads, sz.n_kv_heads, sz.d_ff
    attn = D * H * hd + 2 * D * K * hd + H * hd * D
    return sz.n_layers * (attn + 3 * D * F) + D * sz.vocab


def port_fields(sz, base) -> dict:
    """The port's config fields beyond the shared sizes (none); raises
    where the values run are not what the port's dense block computes."""
    e = sz.values
    for key, value in IMPLIED.items():
        if e.get(key, value) != value:
            raise ValueError(f"{key}={e[key]}: the port's model has {value}")
    if abs(e.get("attention_multiplier", sz.hd ** -0.5) - sz.hd ** -0.5) \
            > 1e-12:
        raise ValueError("the port scales attention scores by "
                         "head_dim ** -0.5")
    return {}
