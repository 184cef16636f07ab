"""Inference pipeline: stitching semantics, NaN fill, multi-device mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from wav2vecsegmenter_tpu.data.collate import Batch, collate
from wav2vecsegmenter_tpu.infer.pipeline import (
    WindowInference,
    infer_talk,
    nan_fill,
)
from wav2vecsegmenter_tpu.parallel.mesh import make_mesh

from .helpers import tiny_shas


def test_nan_fill_local_mean():
    arr = np.array([0.1, np.nan, 0.3, 0.5, np.nan])
    nan_fill(arr, 5)
    # reference semantics: mean over [j-2, j+3) ignoring NaNs
    assert arr[1] == pytest.approx(np.nanmean([0.1, np.nan, 0.3, 0.5][:4]))
    assert not np.isnan(arr).any()


def _run_inference(mesh=None, batch_size=4):
    model = tiny_shas()
    params = model.init(jax.random.PRNGKey(0))
    engine = WindowInference(model, params, mesh=mesh)

    rng = np.random.RandomState(0)
    # 3 windows of 1 s each, talk = 150 out frames
    examples = []
    for i in range(3):
        wav = rng.randn(16000).astype(np.float32) * 0.1
        examples.append((wav, None, i * 50, (i + 1) * 50))
    batch = collate(examples, batch_size, 16000, 50)
    probs, logits, _ = infer_talk(engine, [batch], 150)
    assert probs.shape == (150,)
    assert not np.isnan(probs).any()
    assert (probs >= 0).all() and (probs <= 1).all()
    return probs


def test_infer_talk_single_device():
    _run_inference()


def test_infer_talk_mesh_matches_single():
    mesh = make_mesh(4)
    p1 = _run_inference(mesh=None, batch_size=4)
    p8 = _run_inference(mesh=mesh, batch_size=4)
    np.testing.assert_allclose(p1, p8, atol=1e-5)


def test_infer_talk_tensor_parallel_matches_single():
    """Inference on a (data=2, model=2) mesh with tensor-parallel params
    (WindowInference places them via param_shardings) matches
    single-device."""
    mesh = make_mesh(2, 2)
    p1 = _run_inference(mesh=None, batch_size=4)
    ptp = _run_inference(mesh=mesh, batch_size=4)
    np.testing.assert_allclose(p1, ptp, atol=1e-5)


def test_empty_window_probs_zero():
    model = tiny_shas()
    params = model.init(jax.random.PRNGKey(0))
    engine = WindowInference(model, params)
    rng = np.random.RandomState(0)
    examples = [
        (rng.randn(16000).astype(np.float32) * 0.1, None, 0, 50),
        (np.zeros(16000, np.float32), None, 50, 100),  # silent -> excluded
    ]
    batch = collate(examples, 2, 16000, 50)
    assert not batch.included[1]
    probs, _, _ = infer_talk(engine, [batch], 100)
    np.testing.assert_array_equal(probs[50:100], 0.0)


def test_device_normalize_matches_host_normalize(rng):
    """int16 upload + on-device normalization == host float path."""
    model = tiny_shas()
    params = model.init(jax.random.PRNGKey(0))
    engine = WindowInference(model, params)

    examples = []
    for i in range(3):
        # int16-representable samples (as real decoders produce)
        wav = (rng.randint(-3000, 3000, 16000).astype(np.float32) / 32768.0)
        examples.append((wav, None, i * 50, (i + 1) * 50))
    # shorter final window exercises norm_length vs true length
    short = (rng.randint(-3000, 3000, 9000).astype(np.float32) / 32768.0)
    examples.append((short, None, 150, 178))

    host_batch = collate(examples, 4, 16000, 50, device_normalize=False)
    dev_batch = collate(examples, 4, 16000, 50, device_normalize=True)
    assert dev_batch.audio.dtype == np.int16

    p_host, _, _ = infer_talk(engine, [host_batch], 178)
    p_dev, _, _ = infer_talk(engine, [dev_batch], 178)
    np.testing.assert_allclose(p_dev, p_host, atol=2e-5)


def test_half_outframe_talk_length_clamps(tmp_path):
    """A talk whose length lands exactly on a .5 output frame (30.00s ->
    1498.5): duration_outframes rounds down (banker's) but the last window
    end's +1e-6 tiebreak rounds up — the stitch must clamp instead of
    writing past the talk array (the reference crashes here,
    lib/evaluate.py:104; see PARITY.md)."""
    from wav2vecsegmenter_tpu.data.audio import write_wav
    from wav2vecsegmenter_tpu.data.datasets import (
        FixedSegmentationDatasetNoTarget,
    )
    from wav2vecsegmenter_tpu.data.loader import BatchIterator

    wav = tmp_path / "halfframe.wav"
    rng = np.random.RandomState(0)
    write_wav(wav, rng.randn(30 * 16000).astype(np.float32) * 0.1)

    dataset = FixedSegmentationDatasetNoTarget(wav, 20, 1)
    assert dataset.duration_outframes == 1498  # banker's round of 1498.5
    dataset.fixed_length_segmentation(0)
    batches = BatchIterator(dataset, 4, 20.0, shuffle=False)

    model = tiny_shas()
    params = model.init(jax.random.PRNGKey(0))
    engine = WindowInference(model, params)
    probs, logits, _ = infer_talk(engine, batches, dataset.duration_outframes)
    assert probs.shape == (1498,)
    assert not np.isnan(probs).any()


def test_remainder_ladder_slots():
    from wav2vecsegmenter_tpu.data.loader import BatchIterator

    def slots(n, batch_size, ladder=True, m=1):
        it = BatchIterator.__new__(BatchIterator)
        it.batch_size = batch_size
        it.remainder_ladder = ladder
        it.min_multiple = m
        return it._slots_for(n)

    # ladder off: always the static batch size
    assert slots(1, 10, ladder=False) == 10
    # power-of-two ladder, capped at batch_size
    assert [slots(n, 10) for n in range(1, 11)] == [1, 2, 4, 4, 8, 8, 8, 8,
                                                    10, 10]
    assert slots(3, 16) == 4
    assert slots(16, 16) == 16
    # mesh divisibility: slots rounded up to the device multiple
    assert slots(1, 16, m=8) == 8
    assert slots(9, 16, m=8) == 16
    assert slots(5, 10, m=4) == 8


def test_batch_loss_means_over_real_rows():
    """The per-batch eval loss means over the batch's REAL rows — the
    reference's final partial DataLoader batch has exactly r rows
    (lib/evaluate.py:81), so averaging over static padding slots (loss 0)
    would deflate it.  The value must also be invariant to the slot count
    the same examples are padded to (remainder ladder)."""
    from wav2vecsegmenter_tpu.train.loss import build_loss

    model = tiny_shas()
    params = model.init(jax.random.PRNGKey(0))
    loss_fn, _, _ = build_loss({"tag": "bce", "pos_weight": None})
    engine = WindowInference(model, params, loss_fn=loss_fn)

    rng = np.random.RandomState(1)
    examples = []
    for i in range(3):
        wav = rng.randn(16000).astype(np.float32) * 0.1
        tgt = (rng.rand(50) > 0.5).astype(np.float32)
        examples.append((wav, tgt, i * 50, (i + 1) * 50))

    losses = {}
    for slots in (3, 4, 8):
        batch = collate(examples, slots, 16000, 50)
        _, logits = engine.run_batch(batch)
        losses[slots] = engine.batch_loss(batch, np.asarray(logits))
    assert np.isfinite(losses[3])
    # exact-fit batch defines the reference value; padded slot counts match
    assert losses[4] == pytest.approx(losses[3], rel=1e-5)
    assert losses[8] == pytest.approx(losses[3], rel=1e-5)


def test_precision_ladder_arms_match_f32_baseline():
    """runtime.precision arms (PARITY.md ladder): at f32 compute every arm's
    extra casts are identities and the f32last split only reshapes the scan,
    so ALL arms must reproduce the bf16-arm (here f32) numbers exactly —
    this pins the ladder plumbing (head_dtype / residual_dtype / f32_last_k
    through SHAS.apply and the encoder scan split) without a GPU."""
    from wav2vecsegmenter_tpu.infer.pipeline import resolve_precision

    model = tiny_shas()
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    examples = [(rng.randn(16000).astype(np.float32) * 0.1, None, 0, 50)]
    batch = collate(examples, 2, 16000, 50)

    base = None
    for arm in ("bf16", "f32head", "f32res", "f32last1", "f32"):
        engine = WindowInference(model, params, precision=arm)
        probs, _ = engine.run_batch(batch)
        probs = np.asarray(probs)
        if base is None:
            base = probs
        else:
            np.testing.assert_allclose(probs, base, atol=1e-6, err_msg=arm)

    # resolver contract
    import jax.numpy as jnp
    dt, kw = resolve_precision("f32last4", jnp.bfloat16)
    assert dt == jnp.bfloat16 and kw == {
        "head_dtype": jnp.float32, "residual_dtype": jnp.float32,
        "f32_last_k": 4}
    assert resolve_precision("f32", jnp.bfloat16) == (jnp.float32, {})
    assert resolve_precision(None, jnp.bfloat16) == (jnp.bfloat16, {})
    with pytest.raises(ValueError):
        resolve_precision("f16", jnp.bfloat16)
