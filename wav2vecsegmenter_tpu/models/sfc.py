"""Segmentation frame classifier (SFC) head.

Equivalent of reference ``SegmentationFrameClassifier``
(lib/models.py:279-319): dropout -> N pre-LN transformer encoder layers
(torch ``TransformerEncoderLayer`` with norm_first=True, GELU, 8 heads,
dim_feedforward 2048 = torch default) -> LayerNorm -> Linear(H -> vocab) ->
squeeze.  Padding enters as a key mask (True = valid frame), matching the
inverted ``src_key_padding_mask`` semantics at lib/models.py:310.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..ops.attention import attention, prefix_lengths
from ..ops.layernorm import layer_norm
from .wav2vec2 import _dropout

_EPS = 1e-5


def _linear(rng, d_in, d_out):
    # torch nn.Linear default init: kaiming_uniform(a=sqrt(5)) ~ U(-1/sqrt(in), 1/sqrt(in))
    scale = 1.0 / math.sqrt(d_in)
    kw, kb = jax.random.split(rng)
    return {
        "w": jax.random.uniform(kw, (d_in, d_out), jnp.float32, -scale, scale),
        "b": jax.random.uniform(kb, (d_out,), jnp.float32, -scale, scale),
    }


def _ln(d):
    return {"scale": jnp.ones((d,), jnp.float32),
            "bias": jnp.zeros((d,), jnp.float32)}


def init_sfc_params(
    rng: jax.Array,
    d_model: int = 1024,
    n_layers: int = 1,
    ffn_dim: int = 2048,
    vocab_size: int = 1,
) -> dict:
    keys = jax.random.split(rng, 4)

    def one_layer(i):
        ks = jax.random.split(jax.random.fold_in(keys[0], i), 6)
        return {
            "ln1": _ln(d_model),
            "attn": {
                "q": _linear(ks[0], d_model, d_model),
                "k": _linear(ks[1], d_model, d_model),
                "v": _linear(ks[2], d_model, d_model),
                "o": _linear(ks[3], d_model, d_model),
            },
            "ln2": _ln(d_model),
            "ffn": {
                "w1": _linear(ks[4], d_model, ffn_dim),
                "w2": _linear(ks[5], ffn_dim, d_model),
            },
        }

    params: dict = {}
    if n_layers:
        layers = [one_layer(i) for i in range(n_layers)]
        params["layers"] = jax.tree.map(lambda *xs: jnp.stack(xs), *layers)
    params["final_ln"] = _ln(d_model)
    params["out"] = _linear(keys[1], d_model, vocab_size)
    return params


def sfc_forward(
    params: dict,
    x: jax.Array,            # [B, T, H] hidden states
    out_mask: jax.Array,     # [B, T] bool, True = valid frame
    n_heads: int = 8,
    *,
    dropout: float = 0.1,
    deterministic: bool = True,
    rng: jax.Array | None = None,
    compute_dtype=jnp.float32,
) -> jax.Array:
    """Returns logits [B, T] (vocab_size==1 squeezed) or [B, T, V]."""
    h = x.astype(compute_dtype)
    if rng is not None:
        rng, sub = jax.random.split(rng)
        h = _dropout(h, dropout, deterministic, sub)

    if "layers" in params:
        kv_lengths = prefix_lengths(out_mask)

        def layer_body(carry, layer):
            hh, i = carry
            lrng = None if rng is None else jax.random.fold_in(rng, i)
            rngs = jax.random.split(lrng, 3) if lrng is not None else [None] * 3

            hn = layer_norm(hh, layer["ln1"]["scale"], layer["ln1"]["bias"], _EPS)
            b, t, d_model = hn.shape
            dh = d_model // n_heads

            # fused QKV GEMM + packed [B, T, H, D] attention (no transposes)
            wqkv = jnp.concatenate(
                [layer["attn"][n]["w"] for n in ("q", "k", "v")], axis=1
            ).astype(compute_dtype)
            bqkv = jnp.concatenate(
                [layer["attn"][n]["b"] for n in ("q", "k", "v")]
            ).astype(compute_dtype)
            qkv = (hn @ wqkv + bqkv).reshape(b, t, 3, n_heads, dh)
            a = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                          kv_lengths, scale=dh ** -0.5)
            a = a.reshape(b, t, d_model)
            a = a @ layer["attn"]["o"]["w"].astype(compute_dtype) + \
                layer["attn"]["o"]["b"].astype(compute_dtype)
            a = _dropout(a, dropout, deterministic, rngs[0])
            hh = hh + a

            hn = layer_norm(hh, layer["ln2"]["scale"], layer["ln2"]["bias"], _EPS)
            f = hn @ layer["ffn"]["w1"]["w"].astype(compute_dtype) + \
                layer["ffn"]["w1"]["b"].astype(compute_dtype)
            f = jax.nn.gelu(f, approximate=False)
            f = _dropout(f, dropout, deterministic, rngs[1])
            f = f @ layer["ffn"]["w2"]["w"].astype(compute_dtype) + \
                layer["ffn"]["w2"]["b"].astype(compute_dtype)
            f = _dropout(f, dropout, deterministic, rngs[2])
            hh = hh + f
            return (hh, i + 1), None

        (h, _), _ = jax.lax.scan(layer_body, (h, 0), params["layers"])

    h = layer_norm(h, params["final_ln"]["scale"], params["final_ln"]["bias"],
                   _EPS)
    logits = h @ params["out"]["w"].astype(compute_dtype) + \
        params["out"]["b"].astype(compute_dtype)
    logits = logits.astype(jnp.float32)
    if logits.shape[-1] == 1:
        logits = logits[..., 0]
    return logits
