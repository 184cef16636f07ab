"""LayerNorm and the conv layers' bias -> LayerNorm -> GELU epilogue.

Plain XLA: on the GPU each becomes one fusion (a row reduction plus its
elementwise tail: one read and one write of the activations), which is all
a hand-written kernel could do.  Matches torch.nn.LayerNorm semantics
(biased variance, eps inside the sqrt), which both the wav2vec2 encoder and
the SFC head rely on (reference lib/models.py:303, HF modeling_wav2vec2).
Statistics are taken in float32 whatever the activation dtype.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-5


def layer_norm(x: jax.Array, scale: jax.Array, bias: jax.Array,
               eps: float = _EPS) -> jax.Array:
    orig_dtype = x.dtype
    x32 = x.astype(jnp.float32)
    mean = jnp.mean(x32, axis=-1, keepdims=True)
    var = jnp.mean(jnp.square(x32 - mean), axis=-1, keepdims=True)
    y = (x32 - mean) * jax.lax.rsqrt(var + eps)
    return (y * scale + bias).astype(orig_dtype)


def bias_layer_norm_gelu(x: jax.Array, conv_bias: jax.Array,
                         scale: jax.Array, bias: jax.Array,
                         eps: float = _EPS) -> jax.Array:
    """(x + conv_bias) -> LayerNorm(scale, bias) -> exact GELU."""
    y = layer_norm(x + conv_bias.astype(x.dtype), scale, bias, eps)
    return jax.nn.gelu(y, approximate=False)
