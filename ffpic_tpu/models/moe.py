"""Mixture-of-experts transformer block with expert- and
sequence-parallel shardings — the ep/sp axes of the multi-chip story
(SURVEY.md §2.6; the reference is single-process, so every axis here
is beyond-reference multi-device surface).

Mesh axes used: ``data`` (batch), ``seq`` (sequence parallelism:
activations between blocks live sharded over tokens — XLA inserts the
all-gather only where attention needs the full sequence), ``expert``
(expert weights and the dense-dispatch einsum shard over experts —
the gated combine is the expert-axis reduction), ``model`` (Megatron
tensor parallelism inside each expert's FFN, reduced with a psum).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P


@dataclass(frozen=True)
class MoECfg:
    d_model: int = 32
    n_heads: int = 4
    n_experts: int = 4
    d_ff: int = 64
    seq_len: int = 16
    n_classes: int = 8


MOE_TINY = MoECfg()


def init_params(cfg: MoECfg, key):
    ks = jax.random.split(key, 8)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = 0.02
    return {
        "qkv": jax.random.normal(ks[0], (d, 3 * d)) * s,
        "proj": jax.random.normal(ks[1], (d, d)) * s,
        "router": jax.random.normal(ks[2], (d, e)) * s,
        "w1": jax.random.normal(ks[3], (e, d, f)) * s,
        "w2": jax.random.normal(ks[4], (e, f, d)) * s,
        "ln1": jnp.ones((d,)),
        "ln2": jnp.ones((d,)),
        "head": jax.random.normal(ks[5], (d, cfg.n_classes)) * s,
    }


def param_shardings(cfg: MoECfg, mesh):
    def ns(*spec):
        return NamedSharding(mesh, P(*spec))
    return {
        "qkv": ns(None, "model"),          # column-parallel attention
        "proj": ns("model", None),         # row-parallel back
        "router": ns(None, None),
        "w1": ns("expert", None, "model"),  # ep x tp expert FFN
        "w2": ns("expert", "model", None),
        "ln1": ns(None),
        "ln2": ns(None),
        "head": ns(None, None),
    }


def _ln(x, g):
    m = x.mean(-1, keepdims=True)
    v = ((x - m) ** 2).mean(-1, keepdims=True)
    return (x - m) * jax.lax.rsqrt(v + 1e-6) * g


def forward(cfg: MoECfg, params, x):
    """x: (B, T, D) activations, sequence-sharded between blocks."""
    sp = P("data", "seq", None)
    x = jax.lax.with_sharding_constraint(x, sp)

    # attention (needs the full sequence -> XLA all-gathers over seq)
    h = _ln(x, params["ln1"])
    qkv = h @ params["qkv"]
    q, k, v = jnp.split(qkv, 3, axis=-1)
    B, T, D = q.shape
    hd = D // cfg.n_heads

    def heads(t):
        return t.reshape(B, T, cfg.n_heads, hd).transpose(0, 2, 1, 3)
    q, k, v = heads(q), heads(k), heads(v)
    att = jax.nn.softmax(q @ k.transpose(0, 1, 3, 2)
                         / np.sqrt(hd), axis=-1)
    o = (att @ v).transpose(0, 2, 1, 3).reshape(B, T, D)
    x = x + jax.lax.with_sharding_constraint(o @ params["proj"], sp)

    # MoE FFN: dense dispatch over the expert axis; the gated combine
    # is the expert-axis reduction XLA turns into a psum
    h = _ln(x, params["ln2"])
    gates = jax.nn.softmax(h @ params["router"], axis=-1)  # (B,T,E)
    hidden = jnp.einsum("btd,edf->ebtf", h, params["w1"])
    hidden = jax.nn.relu(hidden)
    out = jnp.einsum("ebtf,efd->ebtd", hidden, params["w2"])
    y = jnp.einsum("bte,ebtd->btd", gates, out)
    x = x + jax.lax.with_sharding_constraint(y, sp)
    return x


def make_train_step(cfg: MoECfg, lr: float = 1e-2):
    def loss_fn(params, x, labels):
        h = forward(cfg, params, x)
        logits = h.mean(axis=1) @ params["head"]
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(
            logp, labels[:, None], axis=1).mean()

    def step(params, x, labels):
        loss, grads = jax.value_and_grad(loss_fn)(params, x, labels)
        params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
        return params, loss

    return step
