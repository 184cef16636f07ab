"""Ops against plain references on the CPU: the attention wrapper (and the
arguments it hands to cuDNN on the GPU), LayerNorm and the conv epilogue,
the platform seam's choices, and the stride-folded conv."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from wav2vecsegmenter_tpu.core import platform
from wav2vecsegmenter_tpu.ops.attention import (
    attention, attention_reference, prefix_lengths)
from wav2vecsegmenter_tpu.ops.layernorm import bias_layer_norm_gelu, layer_norm


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attention_f64(q, k, v, lengths, scale):
    """float64 numpy attention with a key-padding mask built from lengths."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    s = np.einsum("bqnd,bknd->bnqk", q, k) * scale
    if lengths is not None:
        valid = np.arange(k.shape[1])[None, :] < np.maximum(lengths, 1)[:, None]
        s = np.where(valid[:, None, None, :], s, -np.inf)
    s = s - s.max(-1, keepdims=True)
    p = np.exp(s)
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bnqk,bknd->bqnd", p, v)


ATTN_CASES = {
    # name: (b, tq, tk, n, d, lengths or None)
    "no_mask": (2, 13, 13, 4, 16, None),
    "ragged": (3, 17, 17, 4, 16, [17, 9, 1]),
    "zero_length_row": (2, 11, 11, 2, 32, [11, 0]),
    "cross_tq_ne_tk": (2, 7, 19, 4, 16, [19, 12]),
    "sfc_head_shape": (2, 9, 9, 2, 64, [9, 5]),
    "odd_len_d128": (1, 15, 15, 1, 128, [15]),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_matches_float64_reference(rng, case):
    b, tq, tk, n, d, lengths = ATTN_CASES[case]
    q = rng.randn(b, tq, n, d).astype(np.float32)
    k = rng.randn(b, tk, n, d).astype(np.float32)
    v = rng.randn(b, tk, n, d).astype(np.float32)
    lens = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    got = np.asarray(attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), lens))
    want = _attention_f64(q, k, v, lengths, d ** -0.5)
    assert got.shape == (b, tq, n, d)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("case", ["ragged", "cross_tq_ne_tk", "sfc_head_shape"])
def test_attention_gradients_match_float64(rng, case):
    """Gradients of the float32 wrapper against the same maths in float64
    (an independent einsum + masked softmax under x64)."""
    b, tq, tk, n, d, lengths = ATTN_CASES[case]
    q = rng.randn(b, tq, n, d)
    k = rng.randn(b, tk, n, d)
    v = rng.randn(b, tk, n, d)
    cot = rng.randn(b, tq, n, d)
    lens = jnp.asarray(lengths, jnp.int32)

    def loss32(q, k, v):
        return jnp.sum(attention(q, k, v, lens) * cot.astype(np.float32))

    got = jax.grad(loss32, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jnp.float32) for a in (q, k, v)))

    with jax.enable_x64(True):
        valid = jnp.arange(tk)[None, :] < jnp.asarray(lengths)[:, None]

        def loss64(q, k, v):
            s = jnp.einsum("bqnd,bknd->bnqk", q, k) * d ** -0.5
            s = jnp.where(valid[:, None, None, :], s, -jnp.inf)
            p = jax.nn.softmax(s, axis=-1)
            return jnp.sum(jnp.einsum("bnqk,bknd->bqnd", p, v) * cot)

        want = jax.grad(loss64, argnums=(0, 1, 2))(
            *(jnp.asarray(a, jnp.float64) for a in (q, k, v)))
        want = [np.asarray(w) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), w, atol=2e-4, rtol=1e-3)


def _caller_masks():
    """The key masks each attention caller builds, from its own code."""
    from tests.helpers import tiny_shas
    from wav2vecsegmenter_tpu.data.collate import collate
    from wav2vecsegmenter_tpu.models.wav2vec2 import wav2vec2_forward

    model = tiny_shas()
    params = model.init(jax.random.PRNGKey(0))
    lens = jnp.asarray([16000, 9000, 400], jnp.int32)
    audio = jnp.zeros((3, 16000), jnp.float32)
    # encoder self-attention (and the autoreg decoder's memory mask, which
    # is the same frame mask through AutoRegSegmenterImpl._encode)
    _, frame_mask = wav2vec2_forward(params["wav2vec"], audio, lens,
                                     model.w2v_cfg)
    # SFC head: the collated window out_mask, incl. the reference's crop
    examples = [(np.random.RandomState(n).randn(n).astype(np.float32), None,
                 0, n // 320)
                for n in (16000, 7000, 320)]
    out_mask = collate(examples, 4, 16000, 50).out_mask
    # autoreg greedy decode: the KV-cache validity mask at step i
    t_out, i = 12, 4
    cache_mask = np.broadcast_to(np.arange(t_out)[None, :] <= i, (2, t_out))
    return {"encoder_frame_mask": np.asarray(frame_mask),
            "sfc_out_mask": out_mask,
            "autoreg_memory_mask": np.asarray(frame_mask),
            "autoreg_cache_mask": cache_mask}


@pytest.mark.parametrize("caller", ["encoder_frame_mask", "sfc_out_mask",
                                    "autoreg_memory_mask",
                                    "autoreg_cache_mask"])
def test_key_masks_are_prefix_masks(caller):
    """Lengths stand in for the key mask only because every caller's mask
    is a prefix of valid frames: rebuilding it from the lengths is exact."""
    mask = _caller_masks()[caller]
    lengths = np.asarray(prefix_lengths(jnp.asarray(mask)))
    rebuilt = np.arange(mask.shape[1])[None, :] < lengths[:, None]
    np.testing.assert_array_equal(rebuilt, mask)
    assert 0 < lengths.max() <= mask.shape[1]


@pytest.mark.parametrize("tq,tk,lengths", [
    (999, 999, [999, 500]),     # 20 s windows: odd T is padded to 1000
    (1000, 1000, None),         # aligned T: passed through unpadded
    (250, 999, None),           # cross-attention, no mask: lengths = tk
    (8, 8, [8, 0]),             # empty row: lengths clamped to 1
])
def test_cudnn_arguments(monkeypatch, tq, tk, lengths):
    """What the wrapper hands jax.nn.dot_product_attention on the GPU:
    [B, T, N, D] operands padded to a multiple of 8, int32 key lengths
    (>= 1) whenever anything is padded or masked, the cuDNN
    implementation, and the output sliced back to tq."""
    seen = {}

    def fake(q, k, v, **kw):
        seen.update(q=q.shape, k=k.shape, v=v.shape, **kw)
        return jnp.zeros(q.shape, q.dtype)

    monkeypatch.setattr(jax.nn, "dot_product_attention", fake)
    b, n, d = 2, 4, 64
    q = jnp.zeros((b, tq, n, d), jnp.bfloat16)
    kv = jnp.zeros((b, tk, n, d), jnp.bfloat16)
    lens = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    out = attention(q, kv, kv, lens, scale=0.125, impl="cudnn")

    pq, pk = -(-tq // 8) * 8, -(-tk // 8) * 8
    assert out.shape == (b, tq, n, d)
    assert seen["q"] == (b, pq, n, d)
    assert seen["k"] == seen["v"] == (b, pk, n, d)
    assert seen["implementation"] == "cudnn"
    assert seen["scale"] == 0.125
    got_lens = seen["key_value_seq_lengths"]
    if lengths is None and pk == tk:
        assert got_lens is None
    else:
        want = [tk] * b if lengths is None else [max(x, 1) for x in lengths]
        assert got_lens.dtype == jnp.int32
        np.testing.assert_array_equal(np.asarray(got_lens), want)


def test_attention_rejects_unknown_impl():
    x = jnp.zeros((1, 4, 1, 8))
    with pytest.raises(ValueError, match="unknown attention"):
        attention(x, x, x, impl="flash")


def test_reference_padded_keys_get_no_weight(rng):
    """Values past a row's length must not reach its output at all."""
    q = jnp.asarray(rng.randn(1, 6, 2, 8).astype(np.float32))
    k = jnp.asarray(rng.randn(1, 10, 2, 8).astype(np.float32))
    v = rng.randn(1, 10, 2, 8).astype(np.float32)
    lens = jnp.asarray([7], jnp.int32)
    a = attention_reference(q, k, jnp.asarray(v), lens, 0.3)
    v[:, 7:] = 1e6
    b = attention_reference(q, k, jnp.asarray(v), lens, 0.3)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# LayerNorm and the conv epilogue
# ---------------------------------------------------------------------------

def _ln_f64(x, scale, bias, eps=1e-5):
    x = np.asarray(x, np.float64)
    mean = x.mean(-1, keepdims=True)
    var = ((x - mean) ** 2).mean(-1, keepdims=True)
    return (x - mean) / np.sqrt(var + eps) * scale + bias


_gelu_f64 = np.vectorize(lambda y: 0.5 * y * (1.0 + math.erf(y / math.sqrt(2))))


@pytest.mark.parametrize("shape,dtype,tol", [
    ((3, 137, 256), jnp.float32, 2e-5),
    ((2, 5, 1024), jnp.float32, 2e-5),
    ((4, 33, 64), jnp.bfloat16, 3e-2),
])
def test_layer_norm_matches_float64(rng, shape, dtype, tol):
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    scale = rng.randn(shape[-1]).astype(np.float32)
    bias = rng.randn(shape[-1]).astype(np.float32)
    xin = jnp.asarray(x).astype(dtype)
    got = layer_norm(xin, jnp.asarray(scale), jnp.asarray(bias))
    assert got.dtype == dtype
    want = _ln_f64(np.asarray(xin.astype(jnp.float32)), scale, bias)
    np.testing.assert_allclose(np.asarray(got.astype(jnp.float32)), want,
                               atol=tol * np.abs(want).max(), rtol=tol)


@pytest.mark.parametrize("shape", [(2, 61, 32), (1, 7, 512)])
def test_bias_layer_norm_gelu_matches_float64(rng, shape):
    x = rng.randn(*shape).astype(np.float32)
    cb = rng.randn(shape[-1]).astype(np.float32)
    scale = rng.randn(shape[-1]).astype(np.float32)
    bias = rng.randn(shape[-1]).astype(np.float32)
    got = bias_layer_norm_gelu(*(jnp.asarray(a) for a in (x, cb, scale, bias)))
    want = _gelu_f64(_ln_f64(x.astype(np.float64) + cb, scale, bias))
    np.testing.assert_allclose(np.asarray(got), want, atol=3e-5, rtol=1e-4)


def test_layer_norm_gradients_match_float64(rng):
    x = rng.randn(3, 9, 48)
    s = rng.randn(48)
    b = rng.randn(48)
    cot = rng.randn(3, 9, 48)
    got = jax.grad(lambda *a: jnp.sum(layer_norm(*a) * cot.astype(np.float32)),
                   argnums=(0, 1, 2))(
        *(jnp.asarray(a, jnp.float32) for a in (x, s, b)))
    with jax.enable_x64(True):
        def ln64(x, s, b):
            m = jnp.mean(x, -1, keepdims=True)
            var = jnp.mean((x - m) ** 2, -1, keepdims=True)
            return jnp.sum(((x - m) / jnp.sqrt(var + 1e-5) * s + b) * cot)

        want = jax.grad(ln64, argnums=(0, 1, 2))(
            *(jnp.asarray(a, jnp.float64) for a in (x, s, b)))
        want = [np.asarray(w) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("k,s,c,o,t", [
    (10, 5, 1, 16, 1601),   # raw-audio layer (tap-concat GEMM)
    (3, 2, 32, 16, 321),    # mid layers, wide-channel accumulate path
    (2, 2, 64, 32, 80),     # last layers
])
def test_conv_layer_with_epilogue_matches_lax_conv(rng, k, s, c, o, t):
    """One layer-norm conv layer as the feature extractor runs it (stride-
    folded GEMMs, then bias + LN + GELU) against lax.conv_general_dilated
    and a float64 epilogue."""
    from wav2vecsegmenter_tpu.models.wav2vec2 import _strided_conv1d_as_matmul

    x = rng.randn(2, t, c).astype(np.float32)
    w = (rng.randn(k, c, o) / math.sqrt(k * c)).astype(np.float32)
    cb, scale, bias = (rng.randn(o).astype(np.float32) for _ in range(3))
    y = _strided_conv1d_as_matmul(jnp.asarray(x), jnp.asarray(w), s,
                                  jnp.float32)
    got = np.asarray(bias_layer_norm_gelu(
        y, jnp.asarray(cb), jnp.asarray(scale), jnp.asarray(bias)))
    with jax.default_matmul_precision("highest"):
        conv = np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w), window_strides=(s,),
            padding="VALID", dimension_numbers=("NHC", "HIO", "NHC")))
    want = _gelu_f64(_ln_f64(conv.astype(np.float64) + cb, scale, bias))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# the platform seam
# ---------------------------------------------------------------------------

@pytest.fixture
def on_gpu(monkeypatch):
    monkeypatch.setattr(platform, "backend", lambda: "gpu")


@pytest.mark.parametrize("requested", ["bfloat16", "float32"])
def test_platform_cpu_runs_float32(requested):
    assert platform.backend() == "cpu"
    assert platform.compute_dtype(requested) == jnp.float32
    assert platform.attention_impl(jnp.bfloat16) == "xla"
    assert platform.device_normalize_default() is False


@pytest.mark.parametrize("requested,dtype", [("bfloat16", jnp.bfloat16),
                                             ("float32", jnp.float32)])
def test_platform_gpu_choices(on_gpu, requested, dtype):
    assert platform.compute_dtype(requested) == dtype
    assert platform.attention_impl(dtype) == (
        "cudnn" if dtype == jnp.bfloat16 else "xla")
    assert platform.device_normalize_default() is True


def test_platform_rejects_unknown_dtype():
    with pytest.raises(ValueError, match="unknown compute dtype"):
        platform.compute_dtype("float16")


def test_require_gpu_fails_without_a_gpu():
    with pytest.raises(RuntimeError, match="no GPU found"):
        platform.require_gpu()


@pytest.mark.parametrize("env_set,gpu,want", [
    (True, True, "env"),      # JAX reads the variable; no dir set in code
    (False, True, "repo"),    # <repo>/.jax_cache
    (False, False, None),     # CPU: no persistent cache
])
def test_compilation_cache_dir(monkeypatch, tmp_path, env_set, gpu, want):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, val: calls.__setitem__(name, val))
    monkeypatch.setattr(platform, "backend", lambda: "gpu" if gpu else "cpu")
    monkeypatch.setattr(platform, "CACHE_DIR", tmp_path / ".jax_cache")
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    platform.setup_compilation_cache()
    if want is None:
        assert calls == {}
        return
    if want == "env":
        assert "jax_compilation_cache_dir" not in calls
    else:
        assert calls["jax_compilation_cache_dir"] == str(tmp_path / ".jax_cache")
        assert (tmp_path / ".jax_cache").is_dir()
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 1.0


def test_cache_dir_is_inside_the_checkout():
    assert platform.CACHE_DIR.parent == platform.REPO_ROOT
    assert (platform.REPO_ROOT / "wav2vecsegmenter_tpu").is_dir()


# ---------------------------------------------------------------------------
# stride-folded conv
# ---------------------------------------------------------------------------

def test_strided_conv1d_as_matmul_matches_conv():
    """Stride-folded GEMM conv vs lax.conv_general_dilated, all wav2vec2
    layer geometries + odd lengths/strides (incl. stride 1 and k % s != 0)."""
    import jax
    import jax.numpy as jnp

    from wav2vecsegmenter_tpu.models.wav2vec2 import _strided_conv1d_as_matmul

    rng = np.random.RandomState(0)
    cases = [
        (10, 5, 1, 8, 1601),   # layer 0 geometry (tiny channels)
        (3, 2, 8, 8, 321),     # layers 1-4
        (2, 2, 8, 16, 80),     # layers 5-6
        (3, 1, 4, 4, 50),      # stride 1
        (5, 2, 4, 4, 53),      # k % s != 0, odd T
        (4, 3, 4, 4, 52),      # k > s, n_taps=2, odd tail
        (3, 2, 64, 8, 321),    # s*c=128 > 64: wide-channel accumulate path
        (5, 2, 48, 8, 95),     # wide path with zero-padded trailing tap
    ]
    for (k, s, c, o, t) in cases:
        x = rng.randn(2, t, c).astype(np.float32)
        w = (rng.randn(k, c, o) * 0.1).astype(np.float32)
        got = np.asarray(_strided_conv1d_as_matmul(
            jnp.asarray(x), jnp.asarray(w), s, jnp.float32))
        ref = np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(w),
            window_strides=(s,), padding="VALID",
            dimension_numbers=("NHC", "HIO", "NHC")))
        assert got.shape == ref.shape, (k, s, t)
        np.testing.assert_allclose(got, ref, atol=1e-4, err_msg=str((k, s, t)))


def test_strided_conv_t_out_pad_prefix_exact():
    """t_out_pad computes extra garbage rows but the real prefix must be
    exactly the unpadded result (the alignment fast path relies on it);
    also when t_out_pad is BELOW the natural t_out of a pre-padded input."""
    import jax.numpy as jnp

    from wav2vecsegmenter_tpu.models.wav2vec2 import _strided_conv1d_as_matmul

    rng = np.random.RandomState(3)
    for (k, s, c, o, t) in [(10, 5, 1, 8, 1601), (3, 2, 8, 8, 321),
                            (2, 2, 8, 16, 80), (5, 2, 48, 8, 95)]:
        x = rng.randn(2, t, c).astype(np.float32)
        w = (rng.randn(k, c, o) * 0.1).astype(np.float32)
        base = np.asarray(_strided_conv1d_as_matmul(
            jnp.asarray(x), jnp.asarray(w), s, jnp.float32))
        t_out = base.shape[1]
        for pad_to in (t_out, -(-t_out // 8) * 8, t_out + 11):
            got = np.asarray(_strided_conv1d_as_matmul(
                jnp.asarray(x), jnp.asarray(w), s, jnp.float32,
                t_out_pad=pad_to))
            assert got.shape[1] == pad_to
            np.testing.assert_array_equal(got[:, :t_out], base,
                                          err_msg=str((k, s, t, pad_to)))
        # pre-padded input + t_out_pad below its natural t_out: the fold
        # trims the view; real rows still exact
        xp = np.pad(x, ((0, 0), (0, 7), (0, 0)))
        got = np.asarray(_strided_conv1d_as_matmul(
            jnp.asarray(xp), jnp.asarray(w), s, jnp.float32,
            t_out_pad=t_out))
        np.testing.assert_array_equal(got[:, :t_out], base)


def test_feature_extractor_alignment_padding_exact():
    """Layer-norm-mode feature_extractor output with the 8-aligned padded
    path must equal a run over an input length whose conv outputs are
    naturally aligned-free (the same real frames either way)."""
    import jax.numpy as jnp

    from wav2vecsegmenter_tpu.models.wav2vec2 import (
        Wav2Vec2Config, feature_extractor, init_wav2vec2_params)

    cfg = Wav2Vec2Config(
        hidden_size=64, num_layers=2, num_heads=4, ffn_dim=128,
        conv_dim=(16,) * 7, conv_kernel=(10, 3, 3, 3, 3, 2, 2),
        conv_stride=(5, 2, 2, 2, 2, 2, 2),
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    import jax

    params = init_wav2vec2_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.RandomState(4)
    audio = rng.randn(2, 8000).astype(np.float32) * 0.1
    out = np.asarray(feature_extractor(params, jnp.asarray(audio), cfg,
                                       jnp.float32))
    # longer audio shares the real prefix frames: every real frame of the
    # short input reads only real samples, so prefix outputs must agree
    audio2 = np.concatenate([audio, rng.randn(2, 640).astype(np.float32)],
                            axis=1)
    out2 = np.asarray(feature_extractor(params, jnp.asarray(audio2), cfg,
                                        jnp.float32))
    n = out.shape[1]
    np.testing.assert_allclose(out2[:, :n], out, atol=2e-5)
    assert not np.isnan(out).any()
