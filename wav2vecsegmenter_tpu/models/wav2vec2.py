"""wav2vec 2.0 encoder in JAX.

Re-implements the architecture consumed by the reference through HF
``Wav2Vec2Model`` (reference lib/models.py:322-368): 7-layer strided 1D-conv
feature extractor (320x downsample), feature projection, grouped
weight-normalized positional conv embedding, and a pre-LN ("stable layer
norm") transformer stack truncated to ``keep_layers`` with the final encoder
LayerNorm removed (lib/models.py:340-349) — the classifier re-normalizes.

Design notes:
  * params are plain pytrees; transformer layers are *stacked* along a
    leading axis and executed with ``lax.scan`` — one compiled layer body
    regardless of depth;
  * attention runs as cuDNN fused attention on the GPU and as the plain
    einsum reference on the CPU (ops/attention.py); LayerNorm, GELU and the
    FFN are plain XLA;
  * everything is static-shape: windows arrive padded to a fixed sample
    count, masking carries the true lengths (HF attention-mask semantics);
  * FFN adapters (reference lib/models.py:371-428) are represented uniformly
    in the stacked params with a per-layer on/off flag, so the same scan body
    serves the adapter and plain variants.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from ..ops.attention import NEG_INF, attention, prefix_lengths
from ..ops.layernorm import bias_layer_norm_gelu, layer_norm


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    hidden_size: int = 1024
    num_layers: int = 24            # transformer layers kept (post-truncation)
    num_heads: int = 16
    ffn_dim: int = 4096
    conv_dim: tuple = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"    # 'layer' (large/xls-r) | 'group' (base)
    do_stable_layer_norm: bool = True
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    # Fused attention omits attention-prob dropout (PARITY.md);
    # this flag enables it on an explicit-softmax XLA path, used to measure
    # the omission's effect on fine-tuning (scripts/measure_attn_dropout.py).
    apply_attention_prob_dropout: bool = False
    activation_dropout: float = 0.0
    feat_proj_dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    # FFN parallel adapters (reference ScaledParallelAdapter, bottleneck 512,
    # scale 4 — lib/models.py:400-402)
    ffn_adapter: bool = False
    adapter_dim: int = 512
    adapter_scale: float = 4.0
    # SpecAugment time masking (HF applies it whenever the backbone runs in
    # train mode, so the reference's fine-tuning runs had it active with the
    # checkpoint's defaults; exact HF RNG is not reproducible, the masking
    # statistics are)
    apply_spec_augment: bool = True
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    mask_time_min_masks: int = 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


# architecture presets for the checkpoints the reference uses
# (full_num_layers is the pre-truncation depth, for checkpoint conversion)
PRESETS: dict[str, dict] = {
    "facebook/wav2vec2-xls-r-300m": dict(
        hidden_size=1024, num_layers=24, num_heads=16, ffn_dim=4096,
        feat_extract_norm="layer", do_stable_layer_norm=True, conv_bias=True,
        feat_proj_dropout=0.1, activation_dropout=0.0,
    ),
    "facebook/wav2vec2-large-960h-lv60-self": dict(
        hidden_size=1024, num_layers=24, num_heads=16, ffn_dim=4096,
        feat_extract_norm="layer", do_stable_layer_norm=True, conv_bias=True,
        feat_proj_dropout=0.1, activation_dropout=0.1,
    ),
    "facebook/wav2vec2-base-960h": dict(
        hidden_size=768, num_layers=12, num_heads=12, ffn_dim=3072,
        feat_extract_norm="group", do_stable_layer_norm=False, conv_bias=False,
        feat_proj_dropout=0.1, activation_dropout=0.1,
    ),
    "facebook/wav2vec2-base": dict(
        hidden_size=768, num_layers=12, num_heads=12, ffn_dim=3072,
        feat_extract_norm="group", do_stable_layer_norm=False, conv_bias=False,
        feat_proj_dropout=0.1, activation_dropout=0.1,
    ),
}


def _preset_from_local_config(model_name: str) -> dict | None:
    """Derive the architecture from a local HF model dir's config.json
    (model_name may be a downloaded snapshot path instead of a hub id)."""
    import json
    import os

    path = os.path.join(model_name, "config.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        c = json.load(f)
    return dict(
        hidden_size=int(c["hidden_size"]),
        num_layers=int(c["num_hidden_layers"]),
        num_heads=int(c["num_attention_heads"]),
        ffn_dim=int(c["intermediate_size"]),
        feat_extract_norm=c.get("feat_extract_norm", "layer"),
        do_stable_layer_norm=bool(c.get("do_stable_layer_norm", True)),
        conv_bias=bool(c.get("conv_bias", True)),
        feat_proj_dropout=float(c.get("feat_proj_dropout", 0.1)),
        activation_dropout=float(c.get("activation_dropout", 0.0)),
    )


def config_for(model_name: str, keep_layers: int | None = None,
               ffn_adapter: bool = False) -> Wav2Vec2Config:
    preset = PRESETS.get(model_name) or _preset_from_local_config(model_name)
    if preset is None:
        # a silent xls-r fallback would train/convert a wrong-geometry model
        # with the error surfacing far from the misconfigured name
        raise ValueError(
            f"Unknown wav2vec2 model '{model_name}'. Known presets: "
            f"{sorted(PRESETS)}; or pass a local HF model directory "
            f"containing config.json.")
    kwargs = dict(preset)
    if keep_layers is not None:
        kwargs["num_layers"] = min(keep_layers, kwargs["num_layers"])
    kwargs["ffn_adapter"] = ffn_adapter
    return Wav2Vec2Config(**kwargs)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _linear(rng, d_in, d_out, scale=None):
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    kw, kb = jax.random.split(rng)
    return {
        "w": jax.random.uniform(kw, (d_in, d_out), jnp.float32, -scale, scale),
        "b": jax.random.uniform(kb, (d_out,), jnp.float32, -scale, scale),
    }


def _ln(d):
    return {"scale": jnp.ones((d,), jnp.float32),
            "bias": jnp.zeros((d,), jnp.float32)}


def init_wav2vec2_params(rng: jax.Array, cfg: Wav2Vec2Config) -> dict:
    keys = jax.random.split(rng, 16)
    params: dict = {}

    # feature extractor
    convs = []
    in_dim = 1
    for i, (out_dim, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        kk = jax.random.fold_in(keys[0], i)
        scale = 1.0 / math.sqrt(in_dim * k)
        layer = {
            "w": jax.random.uniform(kk, (k, in_dim, out_dim), jnp.float32,
                                    -scale, scale),
        }
        if cfg.conv_bias:
            layer["b"] = jnp.zeros((out_dim,), jnp.float32)
        if cfg.feat_extract_norm == "layer":
            layer["ln"] = _ln(out_dim)
        elif i == 0:  # group-norm variant: GroupNorm on layer 0 only
            layer["gn"] = _ln(out_dim)
        convs.append(layer)
        in_dim = out_dim
    params["feature_extractor"] = {"convs": convs}

    # feature projection
    params["feature_projection"] = {
        "ln": _ln(cfg.conv_dim[-1]),
        "proj": _linear(keys[1], cfg.conv_dim[-1], cfg.hidden_size),
    }

    # positional conv (weight-normalized grouped conv, torch layout
    # w_v [out, in/groups, k], w_g [1, 1, k])
    h = cfg.hidden_size
    kpe = cfg.num_conv_pos_embeddings
    in_pg = h // cfg.num_conv_pos_embedding_groups
    wv = jax.random.normal(keys[2], (h, in_pg, kpe), jnp.float32) * 0.02
    params["pos_conv"] = {
        "w_v": wv,
        "w_g": jnp.linalg.norm(wv.reshape(-1, kpe), axis=0).reshape(1, 1, kpe),
        "b": jnp.zeros((h,), jnp.float32),
    }
    if not cfg.do_stable_layer_norm:
        params["encoder_pre_ln"] = _ln(h)

    # transformer layers, stacked [L, ...]
    def one_layer(i):
        kl = jax.random.fold_in(keys[3], i)
        ks = jax.random.split(kl, 8)
        layer = {
            "ln1": _ln(h),
            "attn": {
                "q": _linear(ks[0], h, h),
                "k": _linear(ks[1], h, h),
                "v": _linear(ks[2], h, h),
                "o": _linear(ks[3], h, h),
            },
            "ln2": _ln(h),
            "ffn": {
                "w1": _linear(ks[4], h, cfg.ffn_dim),
                "w2": _linear(ks[5], cfg.ffn_dim, h),
            },
        }
        if cfg.ffn_adapter:
            layer["adapter"] = {
                "down": _linear(ks[6], h, cfg.adapter_dim),
                "up": _linear(ks[7], cfg.adapter_dim, h),
                "flag": jnp.zeros((), jnp.float32),
            }
        return layer

    layers = [one_layer(i) for i in range(cfg.num_layers)]
    params["layers"] = jax.tree.map(lambda *xs: jnp.stack(xs), *layers)

    if cfg.apply_spec_augment:
        params["masked_spec_embed"] = jax.random.uniform(
            keys[4], (cfg.hidden_size,), jnp.float32)

    return params


def sample_time_mask(rng: jax.Array, b: int, t: int, prob: float,
                     length: int, frame_lengths: jax.Array | None = None,
                     min_masks: int = 2) -> jax.Array:
    """SpecAugment time-mask sampling, HF ``_compute_mask_indices``-exact
    (transformers modeling_wav2vec2): per call a single probabilistic-
    rounding epsilon; per row ``num = max(int(prob*len/length + eps),
    min_masks)`` clamped to ``t // length`` and to the candidate-start count
    ``len - length + 1``; starts drawn uniformly WITHOUT replacement from
    the valid range so spans lie strictly inside the row's true length.

    The without-replacement draw uses random-key ranking (argsort of i.i.d.
    uniforms = uniform permutation), the standard XLA-friendly construction
    — identical in distribution to np.random.choice(replace=False).
    Statistics verified against HF on 1k draws (tests/test_ops.py)."""
    k_eps, k_draw = jax.random.split(rng)
    eps = jax.random.uniform(k_eps, ())
    valid = (frame_lengths.astype(jnp.int32) if frame_lengths is not None
             else jnp.full((b,), t, jnp.int32))
    n_starts = jnp.maximum(valid - (length - 1), 0)
    num = jnp.floor(
        prob * valid.astype(jnp.float32) / length + eps).astype(jnp.int32)
    num = jnp.maximum(num, min_masks)
    num = jnp.where(num * length > t, t // length, num)
    num = jnp.minimum(num, n_starts)
    k_max = max(1, t // length)  # static span-count bound after the clamp
    keys = jax.random.uniform(k_draw, (b, t))
    keys = jnp.where(jnp.arange(t)[None, :] < n_starts[:, None], keys, jnp.inf)
    starts = jnp.argsort(keys, axis=-1)[:, :k_max]          # [b, k_max]
    active = jnp.arange(k_max)[None, :] < num[:, None]
    tt = jnp.arange(t)[None, None, :]
    s = starts[:, :, None]
    cover = (tt >= s) & (tt < s + length) & active[:, :, None]
    return cover.any(axis=1)  # [b, t] bool


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _gelu(x):
    return jax.nn.gelu(x, approximate=False)


def _dropout(x, rate, deterministic, rng):
    if deterministic or rate == 0.0 or rng is None:
        return x
    keep = jax.random.bernoulli(rng, 1.0 - rate, x.shape)
    return jnp.where(keep, x / (1.0 - rate), 0)


def _strided_conv1d_as_matmul(x: jax.Array, w: jax.Array, stride: int,
                              compute_dtype,
                              t_out_pad: int | None = None) -> jax.Array:
    """VALID 1-D strided conv as stride-folding + matmuls.

    im2col via k strided slices re-reads the whole activation k times
    through a strided gather.  Instead, fold the stride into channels:
    ``y[b, i, j*C+c] = x[b, i*s + j, c]`` is a free reshape, after which the
    conv is ``ceil(k/s)`` plain GEMMs over stride-1 time-shifted views of
    ``y`` — no patch materialization, K-dims of s*C (1024 for the 512-ch
    layers), accumulated in f32.  Taps past k multiply zero weight rows
    (exact).  x [B, T, C], w [k, C, O] -> [B, T', O], T' = (T - k)//s + 1.

    ``t_out_pad`` (>= the real T') computes that many output rows instead,
    reading zero-padded input for the extras; the real rows are unchanged
    and the caller slices the garbage tail off.  Whether this stride-folded
    form beats cuDNN's native conv on the GPU is open (ROADMAP S8).
    """
    b, t, c = x.shape
    k, _, o = w.shape
    t_out = (t - k) // stride + 1
    if t_out_pad is not None:
        # may be below the natural t_out when the input itself was padded:
        # the fold below then trims the input view instead of padding it
        t_out = t_out_pad
    n_taps = -(-k // stride)  # ceil(k / stride)
    # pad x so every tap's view has t_out full rows after folding
    t_need = (n_taps + t_out - 1) * stride
    if t_need > t:
        x = jnp.pad(x, ((0, 0), (0, t_need - t), (0, 0)))
    elif t_need < t:
        x = x[:, :t_need]
    y = x.reshape(b, n_taps + t_out - 1, stride * c).astype(compute_dtype)
    w = w.astype(compute_dtype)

    if stride * c <= 64:
        # tiny-channel path (the raw-audio layer: s*c == 5): n_taps GEMMs
        # of tiny K would each re-read and re-write the [B*T', O] output;
        # the concat that merges them into ONE GEMM of K = n_taps*s*c is
        # only a [B, T', n_taps*s*c] materialization, small next to it
        z = jnp.concatenate(
            [jax.lax.slice_in_dim(y, p, p + t_out, 1, axis=1)
             for p in range(n_taps)], axis=-1)
        w_full = w.reshape(k * c, o)
        if n_taps * stride > k:
            w_full = jnp.pad(w_full, ((0, (n_taps * stride - k) * c), (0, 0)))
        out = jax.lax.dot_general(
            z, w_full, (((2,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return out.astype(compute_dtype)

    # wide-channel path: K = s*C per tap is already deep (1024 for the
    # 512-ch layers) and a concat would materialize a doubled activation
    # (GBs); accumulate n_taps GEMMs over shifted views instead.
    # tap p covers original kernel positions j' in [p*s, p*s + s) (zero rows
    # where j' >= k): w_tap[p][j*C + c, o] = w[p*s + j, c, o]
    acc = None
    for p in range(n_taps):
        j_hi = min(stride, k - p * stride)
        w_tap = w[p * stride : p * stride + j_hi].reshape(j_hi * c, o)
        if j_hi < stride:
            w_tap = jnp.pad(w_tap, ((0, (stride - j_hi) * c), (0, 0)))
        yp = jax.lax.slice_in_dim(y, p, p + t_out, 1, axis=1)
        term = jax.lax.dot_general(
            yp, w_tap, (((2,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        acc = term if acc is None else acc + term
    return acc.astype(compute_dtype)


def feature_extractor(params: dict, audio: jax.Array,
                      cfg: Wav2Vec2Config,
                      compute_dtype=jnp.float32) -> jax.Array:
    """audio [B, L] -> features [B, T, conv_dim[-1]] (HF conv stack).

    In layer-norm mode every layer's T' is padded up to a multiple of 8
    (see _strided_conv1d_as_matmul) and the garbage tail is sliced off at
    the end — valid because LN/bias/GELU are per-position and a real output
    row never reads a padded input row (s*t' + k - 1 < t_real for real t').
    GroupNorm normalizes over TIME, so group mode runs unpadded.

    The pads are chained BACKWARD: each layer's t_out_pad is raised (in
    8-steps) until the next layer's stride-fold view fits inside it, so no
    ``jnp.pad`` copy runs between layers over GB-scale activations; the
    only pad lands on the [B, L, 1] raw audio (KBs).  The 8-row alignment
    came from a tiled-memory layout; whether it pays on the GPU is open
    (ROADMAP D4).
    """
    align = 8 if cfg.feat_extract_norm == "layer" else 1
    t_real = audio.shape[1]
    convs = params["feature_extractor"]["convs"]
    t_pads: list[int | None] = [None] * len(convs)
    if align > 1:
        reals = []
        t = t_real
        for i in range(len(convs)):
            t = (t - cfg.conv_kernel[i]) // cfg.conv_stride[i] + 1
            reals.append(t)
        need = 0  # rows the NEXT layer's fold view demands of this output
        for i in reversed(range(len(convs))):
            p = -(-max(reals[i], need) // align) * align
            t_pads[i] = p
            n_taps = -(-cfg.conv_kernel[i] // cfg.conv_stride[i])
            need = (n_taps + p - 1) * cfg.conv_stride[i]
        if need > audio.shape[1]:
            audio = jnp.pad(audio, ((0, 0), (0, need - audio.shape[1])))
    x = audio[:, :, None].astype(compute_dtype)  # [B, L, 1]
    for i, layer in enumerate(convs):
        w = layer["w"].astype(compute_dtype)
        k, s = cfg.conv_kernel[i], cfg.conv_stride[i]
        t_real = (t_real - k) // s + 1
        ln_mode = "ln" in layer and "b" in layer
        x = _strided_conv1d_as_matmul(x, w, s, compute_dtype,
                                      t_out_pad=t_pads[i])
        if ln_mode:
            # bias + LN + GELU: one XLA fusion over the GEMM output
            x = bias_layer_norm_gelu(
                x, layer["b"], layer["ln"]["scale"], layer["ln"]["bias"],
                cfg.layer_norm_eps)
            continue
        if "b" in layer:
            x = x + layer["b"].astype(compute_dtype)
        if "ln" in layer:
            x = layer_norm(x, layer["ln"]["scale"], layer["ln"]["bias"],
                           cfg.layer_norm_eps)
        elif "gn" in layer:
            # GroupNorm with groups == channels: normalize each channel over
            # time (biased variance), per HF Wav2Vec2GroupNormConvLayer
            x32 = x.astype(jnp.float32)
            mean = jnp.mean(x32, axis=1, keepdims=True)
            var = jnp.mean(jnp.square(x32 - mean), axis=1, keepdims=True)
            x = ((x32 - mean) * jax.lax.rsqrt(var + cfg.layer_norm_eps)
                 * layer["gn"]["scale"] + layer["gn"]["bias"]).astype(x.dtype)
        x = _gelu(x)
    if x.shape[1] != t_real:  # drop the alignment-padding garbage tail
        x = x[:, :t_real]
    return x


def _pos_conv_weight(params: dict) -> jax.Array:
    """Weight-norm reconstruction: w = g * v / ||v|| with the norm over
    (out, in/groups) per kernel position (torch weight_norm dim=2)."""
    wv = params["w_v"]
    wg = params["w_g"]
    norm = jnp.sqrt(jnp.sum(jnp.square(wv), axis=(0, 1), keepdims=True))
    return wg * wv / norm


def positional_conv(params: dict, x: jax.Array, cfg: Wav2Vec2Config,
                    compute_dtype=jnp.float32) -> jax.Array:
    """Grouped conv positional embedding [B, T, H] -> [B, T, H]."""
    w = _pos_conv_weight(params["pos_conv"])  # [out, in/groups, k] torch layout
    w = jnp.transpose(w, (2, 1, 0)).astype(compute_dtype)  # [k, in/groups, out]
    pad = cfg.num_conv_pos_embeddings // 2
    # no preferred_element_type: its VJP produces an f32 cotangent against
    # bf16 operands and conv_general_dilated rejects the mix; the device still
    # accumulates in f32 internally for bf16 inputs
    y = jax.lax.conv_general_dilated(
        x.astype(compute_dtype), w,
        window_strides=(1,),
        padding=[(pad, pad)],
        dimension_numbers=("NHC", "HIO", "NHC"),
        feature_group_count=cfg.num_conv_pos_embedding_groups,
    ).astype(compute_dtype)
    y = y + params["pos_conv"]["b"].astype(compute_dtype)
    if cfg.num_conv_pos_embeddings % 2 == 0:  # even kernel: drop last step
        y = y[:, :-1, :]
    return _gelu(y)


def _lin(lin: dict, x: jax.Array, compute_dtype) -> jax.Array:
    """x @ W + b, routed through the int8 GEMM path when ``lin`` holds
    quantized weights (ops/quant.quantize_params)."""
    if "qw" in lin:
        from ..ops.quant import int8_matmul

        y = int8_matmul(x, lin["qw"], lin["qs"]).astype(compute_dtype)
    else:
        y = x @ lin["w"].astype(compute_dtype)
    return y + lin["b"].astype(compute_dtype)


def _ffn_block(ffn_params: dict, x: jax.Array, deterministic: bool,
               rng_act, rng_hid, cfg: Wav2Vec2Config,
               compute_dtype) -> jax.Array:
    """FFN sub-block: w1 -> GELU -> (activation dropout) -> w2 -> (hidden
    dropout), as plain GEMMs left to XLA (cuBLAS on the GPU)."""
    act_noop = (deterministic or cfg.activation_dropout == 0.0
                or rng_act is None)

    def chain(xx):
        f = _lin(ffn_params["w1"], xx, compute_dtype)
        f = _gelu(f)
        # materialize the GELU output instead of letting XLA fuse it into
        # the w2 GEMM's operand (whether that pays on the GPU: ROADMAP S9)
        f = jax.lax.optimization_barrier(f)
        f = _dropout(f, cfg.activation_dropout, deterministic, rng_act)
        return _lin(ffn_params["w2"], f, compute_dtype)

    if not deterministic and act_noop:
        # training: rematerialize the chain in the backward instead of
        # stashing the [B, T, 4F] GELU buffers of every scan layer (at the
        # reference's batch_size=14 recipe, 2 x 2.56 GB); recomputing two
        # GEMMs in the backward costs about what reloading the stash would
        f = jax.checkpoint(chain)(x)
    else:
        f = chain(x)
    return _dropout(f, cfg.hidden_dropout, deterministic, rng_hid)


def _mha(layer_attn: dict, x: jax.Array, kv_lengths: jax.Array | None,
         num_heads: int, deterministic: bool, rng, attn_dropout: float,
         compute_dtype, apply_prob_dropout: bool = False) -> jax.Array:
    b, t, h = x.shape
    d = h // num_heads
    xc = x.astype(compute_dtype)

    # single fused QKV GEMM: one [h, 3h] matmul instead of three [h, h]
    # (wider N, one launch); the runtime concat of the per-head weights is
    # a 6 MB copy, small next to the GEMM
    bqkv = jnp.concatenate(
        [layer_attn[n]["b"] for n in ("q", "k", "v")]
    ).astype(compute_dtype)
    if "qw" in layer_attn["q"]:
        # int8 serving path: the fused [h, 3h] GEMM runs int8 x int8 ->
        # int32; per-column scales concatenate alongside the weights
        from ..ops.quant import int8_matmul

        wqkv_q = jnp.concatenate(
            [layer_attn[n]["qw"] for n in ("q", "k", "v")], axis=1)
        sqkv = jnp.concatenate(
            [layer_attn[n]["qs"] for n in ("q", "k", "v")])
        proj = int8_matmul(xc, wqkv_q, sqkv).astype(compute_dtype) + bqkv
    else:
        wqkv = jnp.concatenate(
            [layer_attn[n]["w"] for n in ("q", "k", "v")], axis=1
        ).astype(compute_dtype)
        proj = xc @ wqkv + bqkv
    # [B, T, 3, N, D]: q/k/v slice out in the [B, T, N, D] layout the
    # attention takes, with no head transpose
    qkv = proj.reshape(b, t, 3, num_heads, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if (apply_prob_dropout and not deterministic and attn_dropout > 0.0
            and rng is not None):
        # explicit-softmax path with attention-prob dropout (HF semantics);
        # measurement-only — fused attention omits prob dropout, and
        # scripts/measure_attn_dropout.py quantifies the difference
        scores = jnp.einsum("bqnd,bknd->bnqk", q.astype(jnp.float32) * d**-0.5,
                            k.astype(jnp.float32))
        if kv_lengths is not None:
            valid = jnp.arange(t)[None, :] < kv_lengths[:, None]
            scores += jnp.where(valid[:, None, None, :], 0.0, NEG_INF)
        probs = jax.nn.softmax(scores, axis=-1)
        keep = jax.random.bernoulli(rng, 1.0 - attn_dropout, probs.shape)
        probs = jnp.where(keep, probs / (1.0 - attn_dropout), 0.0)
        out = jnp.einsum("bnqk,bknd->bqnd", probs.astype(v.dtype), v)
    else:
        # (attention-prob dropout omitted under fused attention — PARITY.md)
        out = attention(q, k, v, kv_lengths, d ** -0.5)
    return _lin(layer_attn["o"], out.reshape(b, t, h), compute_dtype)


def encoder(params: dict, x: jax.Array, frame_mask: jax.Array,
            cfg: Wav2Vec2Config, *, deterministic=True, rng=None,
            compute_dtype=jnp.float32, n_frozen_layers: int = 0,
            freeze_ffn: bool = False, residual_dtype=None,
            f32_last_k: int = 0) -> jax.Array:
    """Transformer encoder over extracted features.

    x [B, T, H], frame_mask [B, T] bool.  Final encoder LayerNorm is NOT
    applied (truncation semantics of reference lib/models.py:347-349).

    ``n_frozen_layers`` / ``freeze_ffn`` wrap the corresponding stacked
    params in stop_gradient — the requires_grad=False equivalent of the
    reference's LNA freezing (lib/models.py:358-365).  Activations still
    backprop through frozen layers (pos_conv below them stays trainable),
    but their weight-gradient matmuls are never emitted.

    Mixed-precision ladder knobs (PARITY.md "precision ladder"):
    ``residual_dtype`` keeps the residual stream + LayerNorms at a higher
    dtype than the GEMM/attention compute; ``f32_last_k`` runs the last k
    layers entirely in f32 (inference only — rejects freeze splits).
    """
    eps = cfg.layer_norm_eps
    x = jnp.where(frame_mask[:, :, None], x, 0)
    kv_lengths = prefix_lengths(frame_mask)
    x = x + positional_conv(params, x, cfg, compute_dtype)
    # Truncation contract (reference lib/models.py:340-349): encoder.layer_norm
    # is replaced by Identity for EVERY variant.  For the stable-LN models
    # that's the post-layers final LN (not applied below); for the base
    # (group-norm) models it is this PRE-layers LN — also not applied.  The
    # weights stay in the param tree so reference .pt checkpoints round-trip.
    if not deterministic and rng is not None:
        rng, sub = jax.random.split(rng)
        x = _dropout(x, cfg.hidden_dropout, deterministic, sub)

    res_dt = residual_dtype or compute_dtype

    def make_body(dt):
        """Layer body at compute dtype ``dt``; the carry (residual stream)
        stays ``res_dt`` — when they differ (mixed-precision ladder), the
        sub-block inputs cast down to ``dt`` after each LN and the residual
        adds accumulate in ``res_dt``.  All casts are identity when
        res_dt == dt, so the default path's program is unchanged."""

        def layer_body(carry, scanned):
            h, i = carry
            layer, = scanned,
            lrng = None if rng is None else jax.random.fold_in(rng, i)
            rngs = (jax.random.split(lrng, 4) if lrng is not None
                    else [None] * 4)

            if cfg.do_stable_layer_norm:
                # pre-LN: h += attn(LN1(h)); h += ffn(LN2(h))
                hn = layer_norm(h, layer["ln1"]["scale"],
                                layer["ln1"]["bias"], eps).astype(dt)
                a = _mha(layer["attn"], hn, kv_lengths, cfg.num_heads,
                         deterministic, rngs[0], cfg.attention_dropout,
                         dt, cfg.apply_attention_prob_dropout)
                a = _dropout(a, cfg.hidden_dropout, deterministic, rngs[1])
                h = h + a.astype(res_dt)
                hn = layer_norm(h, layer["ln2"]["scale"],
                                layer["ln2"]["bias"], eps).astype(dt)
                f = _ffn_block(layer["ffn"], hn, deterministic, rngs[2],
                               rngs[3], cfg, dt)
                if "adapter" in layer:
                    ad = layer["adapter"]
                    a_out = jax.nn.relu(
                        hn @ ad["down"]["w"].astype(dt)
                        + ad["down"]["b"].astype(dt))
                    a_out = (a_out @ ad["up"]["w"].astype(dt)
                             + ad["up"]["b"].astype(dt))
                    gate = (ad["flag"].astype(dt)
                            * jnp.asarray(cfg.adapter_scale, dt))
                    f = f + gate * a_out
                h = h + f.astype(res_dt)
            else:
                # post-LN: h = LN1(h + attn(h)); h = LN2(h + ffn(h))
                a = _mha(layer["attn"], h.astype(dt), kv_lengths,
                         cfg.num_heads, deterministic, rngs[0],
                         cfg.attention_dropout, dt,
                         cfg.apply_attention_prob_dropout)
                a = _dropout(a, cfg.hidden_dropout, deterministic, rngs[1])
                h = layer_norm(h + a.astype(res_dt), layer["ln1"]["scale"],
                               layer["ln1"]["bias"], eps)
                f = _ffn_block(layer["ffn"], h.astype(dt), deterministic,
                               rngs[2], rngs[3], cfg, dt)
                h = layer_norm(h + f.astype(res_dt), layer["ln2"]["scale"],
                               layer["ln2"]["bias"], eps)
            return (h, i + 1), None

        return layer_body

    # cast the stacked layer params ONCE, outside the scan: otherwise XLA
    # emits per-layer f32->bf16 converts as operand fusions on the GEMMs;
    # a single hoisted convert is one clean pass.
    # int8 weights (non-floating) and their per-channel scales ("qs") are
    # exempt — scales must stay f32 (a bf16 scale adds ~0.2% per-channel
    # gain error on top of the int8 grid).
    from jax.tree_util import DictKey, tree_map_with_path

    def cast_tree(tree, dt):
        def _cast(path, a):
            if not jnp.issubdtype(a.dtype, jnp.floating):
                return a
            if (path and isinstance(path[-1], DictKey)
                    and path[-1].key == "qs"):
                return a
            return a.astype(dt)

        return tree_map_with_path(_cast, tree)

    raw_layers = params["layers"]
    n_total = jax.tree.leaves(raw_layers)[0].shape[0]
    n_frozen = max(0, min(n_frozen_layers, n_total))
    n_f32 = max(0, min(f32_last_k, n_total))
    if n_f32 and (n_frozen or freeze_ffn):
        raise ValueError("f32_last_k is an inference-precision knob; it "
                         "does not compose with LNA freeze splits")

    def freeze_tree(tree, ffn_only: bool):
        if not ffn_only:
            return jax.tree.map(jax.lax.stop_gradient, tree)
        out = dict(tree)
        if freeze_ffn and "ffn" in out:
            out["ffn"] = jax.tree.map(jax.lax.stop_gradient, tree["ffn"])
        return out

    carry = (x.astype(res_dt), 0)
    body = make_body(compute_dtype)
    if n_f32:
        # mixed-precision ladder: the last k layers run at f32 — their own
        # scan with f32-cast weights (two compiled bodies, same structure)
        low = jax.tree.map(lambda a: a[: n_total - n_f32], raw_layers)
        high = jax.tree.map(lambda a: a[n_total - n_f32:], raw_layers)
        if n_total - n_f32:
            carry, _ = jax.lax.scan(body, carry,
                                    cast_tree(low, compute_dtype))
        carry, _ = jax.lax.scan(make_body(jnp.float32), carry,
                                cast_tree(high, jnp.float32))
    else:
        layers = cast_tree(raw_layers, compute_dtype)
        if n_frozen:
            frozen = jax.tree.map(lambda a: a[:n_frozen], layers)
            carry, _ = jax.lax.scan(body, carry, freeze_tree(frozen, False))
        if n_frozen < n_total:
            rest = jax.tree.map(lambda a: a[n_frozen:], layers)
            carry, _ = jax.lax.scan(body, carry, freeze_tree(rest, True))
    x, _ = carry
    return x


def wav2vec2_forward(
    params: dict,
    audio: jax.Array,        # [B, L] float32, normalized
    in_lengths: jax.Array,   # [B] int32, valid samples per row
    cfg: Wav2Vec2Config,
    *,
    deterministic: bool = True,
    rng: jax.Array | None = None,
    compute_dtype=jnp.float32,
    freeze_feature_encoder: bool = False,
    n_frozen_layers: int = 0,
    freeze_ffn: bool = False,
    residual_dtype=None,
    f32_last_k: int = 0,
) -> tuple[jax.Array, jax.Array]:
    """Full encoder: returns (hidden [B, T, H] float32, frame_mask [B, T]).

    ``freeze_feature_encoder`` inserts a stop_gradient after the feature
    projection — the functional equivalent of the reference's
    requires_grad=False on the conv stack + projection
    (lib/models.py:352-357).  Besides parity, this skips the conv-stack
    backward entirely (its im2col transpose is the most expensive backward
    in the model and is dead weight when those params are frozen)."""
    feats = feature_extractor(params, audio, cfg, compute_dtype)
    t = feats.shape[1]

    # frame lengths via the exact conv arithmetic (HF
    # _get_feat_extract_output_lengths)
    fl = in_lengths
    for kk, ss in zip(cfg.conv_kernel, cfg.conv_stride):
        fl = (fl - kk) // ss + 1
    frame_mask = jnp.arange(t)[None, :] < fl[:, None]

    fp = params["feature_projection"]
    feats = layer_norm(feats, fp["ln"]["scale"], fp["ln"]["bias"],
                       cfg.layer_norm_eps)
    x = feats @ fp["proj"]["w"].astype(compute_dtype) + \
        fp["proj"]["b"].astype(compute_dtype)
    if freeze_feature_encoder:
        x = jax.lax.stop_gradient(x)
    if not deterministic and rng is not None:
        rng, sub = jax.random.split(rng)
        x = _dropout(x, cfg.feat_proj_dropout, deterministic, sub)

    # SpecAugment time masking (train mode only, HF semantics: masked frames
    # replaced by the learned masked_spec_embed)
    if (not deterministic and rng is not None and cfg.apply_spec_augment
            and cfg.mask_time_prob > 0 and "masked_spec_embed" in params):
        rng, sub = jax.random.split(rng)
        tmask = sample_time_mask(sub, x.shape[0], t, cfg.mask_time_prob,
                                 cfg.mask_time_length, frame_lengths=fl,
                                 min_masks=cfg.mask_time_min_masks)
        tmask = tmask & frame_mask
        x = jnp.where(tmask[:, :, None],
                      params["masked_spec_embed"].astype(x.dtype), x)

    h = encoder(params, x, frame_mask, cfg, deterministic=deterministic,
                rng=rng, compute_dtype=compute_dtype,
                n_frozen_layers=n_frozen_layers, freeze_ffn=freeze_ffn,
                residual_dtype=residual_dtype, f32_last_k=f32_last_k)
    return h.astype(jnp.float32), frame_mask
