"""Int8 (w8a8) quantized serving path (ops/quant.py, opt-in
runtime.quantize=int8).

The scheme is weight-per-output-channel + activation-per-row dynamic
symmetric quantization; these tests bound the numerical deviation of each
piece and of the end-to-end engine against the float path.  Its speed is
a device measurement, not a test.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from .helpers import tiny_shas


def test_quantize_linear_round_trip():
    from wav2vecsegmenter_tpu.ops.quant import dequantize_linear, quantize_linear

    rng = np.random.RandomState(0)
    # per-channel scales: give columns wildly different magnitudes
    w = rng.randn(64, 32).astype(np.float32) * (10.0 ** rng.uniform(-3, 1, 32))
    lin = {"w": jnp.asarray(w), "b": jnp.zeros(32)}
    q = quantize_linear(lin)
    assert q["qw"].dtype == jnp.int8
    assert q["qs"].shape == (32,) and q["qs"].dtype == jnp.float32
    back = np.asarray(dequantize_linear(q)["w"])
    # max error per channel <= scale/2 = max|col| / 254
    col_max = np.abs(w).max(axis=0)
    assert (np.abs(back - w) <= col_max / 254 + 1e-9).all()


def test_quantize_linear_stacked_axis():
    """Stacked [L, d_in, d_out] weights quantize per (layer, column)."""
    from wav2vecsegmenter_tpu.ops.quant import dequantize_linear, quantize_linear

    rng = np.random.RandomState(1)
    w = rng.randn(3, 16, 8).astype(np.float32)
    w[1] *= 100.0  # one layer much larger: scales must not couple layers
    q = quantize_linear({"w": jnp.asarray(w), "b": jnp.zeros((3, 8))})
    assert q["qw"].shape == (3, 16, 8) and q["qs"].shape == (3, 8)
    back = np.asarray(dequantize_linear(q)["w"])
    col_max = np.abs(w).max(axis=1, keepdims=True)
    assert (np.abs(back - w) <= col_max / 254 + 1e-9).all()


def test_int8_matmul_close_to_float():
    from wav2vecsegmenter_tpu.ops.quant import int8_matmul, quantize_linear

    rng = np.random.RandomState(2)
    x = rng.randn(4, 37, 64).astype(np.float32)
    w = rng.randn(64, 48).astype(np.float32) / 8.0
    q = quantize_linear({"w": jnp.asarray(w), "b": np.zeros(48)})
    got = np.asarray(int8_matmul(jnp.asarray(x), q["qw"], q["qs"]))
    want = x @ w
    # int8 grid: ~1e-2 relative error at d_in=64 (errors add in quadrature;
    # the coefficient is empirical headroom over the sqrt(d_in) estimate)
    scale = np.abs(x).max(axis=-1, keepdims=True) * np.abs(w).max(axis=0)
    assert np.abs(got - want).max() <= 0.05 * scale.max()
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    assert corr > 0.9999


def test_int8_matmul_zero_rows_stay_zero():
    from wav2vecsegmenter_tpu.ops.quant import int8_matmul, quantize_linear

    w = np.random.RandomState(3).randn(32, 16).astype(np.float32)
    q = quantize_linear({"w": jnp.asarray(w), "b": np.zeros(16)})
    x = np.zeros((2, 5, 32), np.float32)
    out = np.asarray(int8_matmul(jnp.asarray(x), q["qw"], q["qs"]))
    np.testing.assert_array_equal(out, 0.0)


def test_quantize_params_scope():
    """Only the wav2vec transformer GEMMs quantize; conv stack, pos conv,
    LNs, and the SFC head stay float."""
    from wav2vecsegmenter_tpu.ops.quant import is_quantized, quantize_params

    model = tiny_shas()
    params = model.init(jax.random.PRNGKey(0))
    qp = quantize_params(params)
    assert is_quantized(qp) and not is_quantized(params)
    for n in ("q", "k", "v", "o"):
        assert qp["wav2vec"]["layers"]["attn"][n]["qw"].dtype == jnp.int8
    for n in ("w1", "w2"):
        assert qp["wav2vec"]["layers"]["ffn"][n]["qw"].dtype == jnp.int8
    # untouched subtrees are the same objects
    assert qp["seg"] is params["seg"]
    assert (qp["wav2vec"]["feature_extractor"]
            is params["wav2vec"]["feature_extractor"])
    assert "w" in qp["wav2vec"]["feature_projection"]["proj"]
    # the original tree is not mutated
    assert "w" in params["wav2vec"]["layers"]["attn"]["q"]


def _probs(engine, examples, batch_size=4):
    from wav2vecsegmenter_tpu.data.collate import collate
    from wav2vecsegmenter_tpu.infer.pipeline import infer_talk

    batch = collate(examples, batch_size, 16000, 50)
    probs, _, _ = infer_talk(engine, [batch], 50 * len(examples))
    return probs


def test_engine_int8_close_to_float():
    """End-to-end WindowInference with quantize='int8' tracks the float
    engine's frame probabilities."""
    from wav2vecsegmenter_tpu.infer.pipeline import WindowInference
    from wav2vecsegmenter_tpu.ops.quant import is_quantized

    model = tiny_shas()
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(4)
    examples = [(rng.randn(16000).astype(np.float32) * 0.1, None,
                 i * 50, (i + 1) * 50) for i in range(3)]

    pf = _probs(WindowInference(model, params), examples)
    engine_q = WindowInference(model, params, quantize="int8")
    assert is_quantized(engine_q.params)
    pq = _probs(engine_q, examples)

    assert not np.isnan(pq).any()
    # random-init logits sit near 0, where sigmoid is steepest — the prob
    # deviation bound here is looser than trained-weight behavior
    assert np.abs(pq - pf).max() < 0.05
    assert np.corrcoef(pq, pf)[0, 1] > 0.99


def test_engine_int8_rejects_tensor_parallel_and_unknown_mode():
    from wav2vecsegmenter_tpu.infer.pipeline import WindowInference

    from wav2vecsegmenter_tpu.parallel.mesh import make_mesh

    model = tiny_shas()
    params = model.init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="tensor"):
        WindowInference(model, params, mesh=make_mesh(2, 2), quantize="int8")
    with pytest.raises(ValueError, match="unknown quantize"):
        WindowInference(model, params, quantize="fp8")


def test_autoreg_greedy_decode_with_quantized_backbone():
    """quantize_params covers the AutoReg variant's wav2vec subtree; the
    KV-cached greedy decode runs through the int8 encoder and tracks the
    float decode's probabilities."""
    from tests.test_autoreg import tiny_autoreg

    from wav2vecsegmenter_tpu.ops.quant import quantize_params

    model = tiny_autoreg()
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(6)
    b, L, t_out = 2, 16000, 30
    audio = jnp.asarray(rng.randn(b, L).astype(np.float32))
    in_lengths = jnp.asarray(np.array([L, L - 4000], np.int32))

    pf, _, _ = model.greedy_decode(params, audio, in_lengths, t_out)
    pq, _, _ = model.greedy_decode(quantize_params(params), audio,
                                   in_lengths, t_out)
    pf, pq = np.asarray(pf), np.asarray(pq)
    assert not np.isnan(pq).any()
    assert ((pq >= 0) & (pq <= 1)).all()
    # greedy decode feeds back its own argmax: a flipped early token can
    # shift later probabilities, so bound loosely and require agreement
    assert np.abs(pq - pf).mean() < 0.05


@pytest.mark.slow
def test_int8_error_does_not_compound_at_full_geometry():
    """The real risk of w8a8 is error compounding over depth: 24 residual
    layers at h=1024, not the 2-layer toy.  Random-init full-geometry SHAS,
    999-frame window, f32 vs int8 frame probabilities."""
    from wav2vecsegmenter_tpu.models.shas import SHAS

    model = SHAS(
        wav2vec_model_name="facebook/wav2vec2-xls-r-300m",
        wav2vec_keep_layers=24,
        n_transformer_enc_layers=1,
        n_transformer_enc_heads=8,
        init_dropout=0.0,
    )
    assert model.w2v_cfg.hidden_size == 1024
    params = model.init(jax.random.PRNGKey(0))

    from wav2vecsegmenter_tpu.infer.pipeline import WindowInference
    from wav2vecsegmenter_tpu.data.collate import collate
    from wav2vecsegmenter_tpu.infer.pipeline import infer_talk

    rng = np.random.RandomState(7)
    wav = rng.randn(320_000).astype(np.float32) * 0.1
    examples = [(wav, None, 0, 999)]
    batch = collate(examples, 1, 320_000, 999)

    pf, _, _ = infer_talk(WindowInference(model, params), [batch], 999)
    pq, _, _ = infer_talk(WindowInference(model, params, quantize="int8"),
                          [batch], 999)

    err = np.abs(pq - pf)
    corr = np.corrcoef(pq, pf)[0, 1]
    print(f"full-geom int8: max|dprob|={err.max():.4f} "
          f"mean={err.mean():.5f} corr={corr:.6f}")
    assert not np.isnan(pq).any()
    assert corr > 0.99
    assert err.max() < 0.15  # random-init sits at sigmoid's steepest point


def test_engine_int8_on_data_parallel_mesh():
    """int8 params replicate over a data-parallel mesh like any others."""
    from wav2vecsegmenter_tpu.infer.pipeline import WindowInference

    from wav2vecsegmenter_tpu.parallel.mesh import make_mesh

    model = tiny_shas()
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(5)
    examples = [(rng.randn(16000).astype(np.float32) * 0.1, None,
                 i * 50, (i + 1) * 50) for i in range(3)]
    p1 = _probs(WindowInference(model, params, quantize="int8"), examples)
    p8 = _probs(WindowInference(model, params, quantize="int8",
                                mesh=make_mesh(4)), examples)
    np.testing.assert_allclose(p1, p8, atol=1e-5)
