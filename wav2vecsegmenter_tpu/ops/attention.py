"""Multi-head attention over padded windows, differentiable.

Layout is [B, T, N, D] throughout: the fused QKV GEMM's output reshapes
into it with no head transpose, and both implementations take it directly.

* ``cudnn`` — ``jax.nn.dot_product_attention(implementation="cudnn")``,
  cuDNN's fused flash attention (forward and backward) in bf16 on the GPU:
  one pass per (batch, head) block with no [B, N, T, T] scores in memory.
* ``xla`` — the plain einsum reference in float32 (scores, masked softmax,
  PV product), used on the CPU and for float32 compute.

``core.platform.attention_impl`` picks one from the platform and dtype.

Padding enters as key lengths: keys at positions >= ``kv_lengths[b]`` get
no weight, which is torch's ``src_key_padding_mask`` / HF
``attention_mask`` semantics when that mask is a prefix mask.  Every caller
builds its key mask as a prefix of valid frames, so :func:`prefix_lengths`
turns it into lengths (tests/test_ops.py checks the prefix property for
each caller).  Padded *query* rows produce finite garbage that callers zero
out via the output mask (reference lib/evaluate.py:90-91 relies on this).
A row with no valid key attends to its first key, so it too stays finite.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import platform

NEG_INF = -1e30
_SEQ_ALIGN = 8


def prefix_lengths(mask: jax.Array) -> jax.Array:
    """[B, T] bool prefix mask (True = valid) -> [B] int32 valid lengths."""
    return jnp.sum(mask, axis=-1, dtype=jnp.int32)


def attention_reference(q: jax.Array, k: jax.Array, v: jax.Array,
                        kv_lengths: jax.Array | None,
                        scale: float) -> jax.Array:
    """Plain float32 attention, [B, Tq, N, D] x [B, Tk, N, D] -> [B, Tq, N, D]."""
    s = jnp.einsum("bqnd,bknd->bnqk", q.astype(jnp.float32),
                   k.astype(jnp.float32)) * scale
    if kv_lengths is not None:
        valid = jnp.arange(k.shape[1])[None, :] < jnp.maximum(kv_lengths, 1)[:, None]
        s = jnp.where(valid[:, None, None, :], s, NEG_INF)
    p = jax.nn.softmax(s, axis=-1)
    out = jnp.einsum("bnqk,bknd->bqnd", p, v.astype(jnp.float32))
    return out.astype(q.dtype)


def attention(q: jax.Array, k: jax.Array, v: jax.Array,
              kv_lengths: jax.Array | None = None,
              scale: float | None = None,
              impl: str | None = None) -> jax.Array:
    """Attention over [B, T, N, D] operands; ``kv_lengths`` [B] int32 valid
    keys per row (None = all valid).  Tq may differ from Tk
    (cross-attention).  ``impl`` defaults to the platform's choice."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl is None:
        impl = platform.attention_impl(q.dtype)
    if impl == "xla":
        return attention_reference(q, k, v, kv_lengths, scale)
    if impl != "cudnn":
        raise ValueError(f"unknown attention implementation '{impl}'")
    # cuDNN's flash attention refuses odd sequence lengths (T=999 at 20 s
    # windows): pad queries and keys to a multiple of 8.  Padded keys are
    # masked by the lengths; padded query rows are sliced off.
    tq, tk = q.shape[1], k.shape[1]
    pq, pk = -(-tq // _SEQ_ALIGN) * _SEQ_ALIGN, -(-tk // _SEQ_ALIGN) * _SEQ_ALIGN
    if kv_lengths is None and pk != tk:
        kv_lengths = jnp.full((q.shape[0],), tk, jnp.int32)
    if kv_lengths is not None:
        kv_lengths = jnp.maximum(kv_lengths, 1).astype(jnp.int32)

    def pad(a, t, tp):
        return jnp.pad(a, ((0, 0), (0, tp - t), (0, 0), (0, 0))) if tp != t else a

    out = jax.nn.dot_product_attention(
        pad(q, tq, pq), pad(k, tk, pk), pad(v, tk, pk),
        key_value_seq_lengths=kv_lengths, scale=float(scale),
        implementation="cudnn")
    return out[:, :tq] if pq != tq else out
