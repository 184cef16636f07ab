"""Int8 (w8a8) quantized inference for the encoder GEMMs — opt-in.

Int8 x int8 -> int32 products run on the H100's tensor cores at twice the
bf16 rate (NVIDIA's data sheet: 1,979 dense TOP/s against 989 TFLOP/s);
whether that rate shows end to end on this model is not measured yet
(ROADMAP, deferred items).  This module implements the standard
weight-per-output-channel / activation-per-row dynamic symmetric scheme:

* weights: quantized ONCE at engine build (``quantize_params``) to int8
  with one float32 scale per output channel (max-abs over the input dim);
* activations: quantized inside the jitted forward per row (max-abs over
  the hidden dim — a reduction that fuses with the surrounding
  elementwise work), so no calibration data is needed;
* the GEMM runs int8 x int8 -> int32
  (``lax.dot_general(..., preferred_element_type=int32)``), then the two
  scales multiply back in float32.

Quantized are the transformer-layer GEMMs of the wav2vec backbone (fused
QKV, attention output, FFN w1/w2) — 24h^2 of the model's ~24h^2+alpha
per-frame FLOPs.  LayerNorms, the attention core (bf16), the conv
feature extractor, the positional conv, adapters, and the SFC head stay in
``compute_dtype``: they are a small fraction of the time and the cheapest
places to keep full precision.

This is an OPT-IN serving mode (``runtime.quantize: int8``): outputs
deviate from the reference float path by the quantization error (bounded
in tests/test_quant.py; PARITY.md "Int8 quantized serving").  It is
inference-only — training never sees quantized trees — and composes with
data-parallel meshes (int8 leaves replicate like any other); it is
rejected under tensor parallelism (the per-channel scales would need the
same column partitioning as the weights — not wired up).

No reference counterpart (torch CPU dynamic quantization exists upstream
in principle but the reference never uses it).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# int8 symmetric range; +-127 keeps the grid symmetric (no -128)
_QMAX = 127.0


def quantize_linear(lin: dict) -> dict:
    """{"w" [..., d_in, d_out], "b"} -> {"qw" int8, "qs" f32 [..., d_out], "b"}.

    Symmetric per-output-channel: one scale per column of W (leading axes,
    e.g. the stacked-layer axis, are preserved).  The bias stays float.
    """
    w = jnp.asarray(lin["w"], jnp.float32)
    s = jnp.max(jnp.abs(w), axis=-2, keepdims=True) / _QMAX
    s = jnp.maximum(s, 1e-12)
    qw = jnp.clip(jnp.round(w / s), -_QMAX, _QMAX).astype(jnp.int8)
    return {"qw": qw, "qs": jnp.squeeze(s, -2), "b": lin["b"]}


def dequantize_linear(qlin: dict) -> dict:
    """Inverse of quantize_linear (up to rounding) — used by tests."""
    w = qlin["qw"].astype(jnp.float32) * qlin["qs"][..., None, :]
    return {"w": w, "b": qlin["b"]}


def int8_matmul(x: jax.Array, qw: jax.Array, qs: jax.Array) -> jax.Array:
    """x [..., d_in] (any float dtype) @ int8 weights -> float32 [..., d_out].

    Activations quantize dynamically per row (max-abs over d_in) in f32,
    the contraction runs int8 x int8 -> int32, and the row and
    column scales multiply back in f32.  Rows that are entirely zero
    (padded windows) stay exactly zero.
    """
    xf = x.astype(jnp.float32)
    sx = jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / _QMAX
    sx = jnp.maximum(sx, 1e-30)
    xq = jnp.clip(jnp.round(xf / sx), -_QMAX, _QMAX).astype(jnp.int8)
    y = jax.lax.dot_general(
        xq, qw,
        dimension_numbers=(((xq.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return y.astype(jnp.float32) * sx * qs


def _quantize_layer_stack(layers: dict) -> dict:
    """Quantize the GEMMs of a stacked transformer-layer tree in place
    (attn q/k/v/o + ffn w1/w2; LNs and adapters untouched)."""
    out = dict(layers)
    out["attn"] = {n: (quantize_linear(v) if n in ("q", "k", "v", "o") else v)
                   for n, v in layers["attn"].items()}
    out["ffn"] = {n: (quantize_linear(v) if n in ("w1", "w2") else v)
                  for n, v in layers["ffn"].items()}
    return out


def quantize_params(params: dict) -> dict:
    """Return a copy of a model param tree with the wav2vec transformer
    layers' GEMM weights int8-quantized (see module docstring for scope).

    Works on every model variant that keeps its backbone under a
    "wav2vec" key with stacked "layers" (SHAS / SFC-only / SSL / AutoReg).
    Trees without one pass through unchanged.
    """
    if "wav2vec" not in params or "layers" not in params["wav2vec"]:
        return params
    out = dict(params)
    w2v = dict(params["wav2vec"])
    w2v["layers"] = _quantize_layer_stack(w2v["layers"])
    out["wav2vec"] = w2v
    return out


def is_quantized(params: dict) -> bool:
    try:
        return "qw" in params["wav2vec"]["layers"]["attn"]["q"]
    except (KeyError, TypeError):
        return False
