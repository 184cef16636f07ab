"""pos_weight must track each epoch's regenerated dataset (reference
train.py:352-374), not freeze at the epoch-0 value inside the jitted step
(VERDICT r2 weak #1).

Two layers of coverage:
  * step-level: the jitted train step takes pos_weight as an operand and the
    loss it computes matches a fresh un-jitted computation for each value;
  * loop-level: across 2 epochs with differing pos_weights, the value that
    reaches the jitted step each epoch is that epoch's value.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import yaml

from wav2vecsegmenter_tpu.config import compose
from wav2vecsegmenter_tpu.data.prep import prepare_dataset_for_segmentation
from wav2vecsegmenter_tpu.train.loss import BCEWithLogitsLoss
from wav2vecsegmenter_tpu.train.step import (
    compute_bce_loss,
    init_train_state,
    make_optimizer,
    make_train_step,
)

from .helpers import make_speechlike_wav, tiny_shas

CONF = Path(__file__).resolve().parents[1] / "conf"


def _batch(b=2, L=16000, t_out=50, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "audio": rng.randn(b, L).astype(np.float32),
        "in_lengths": np.full(b, L, np.int32),
        "target": (rng.rand(b, t_out) > 0.7).astype(np.float32),
        "out_mask": np.ones((b, t_out), bool),
    }


def test_step_pos_weight_is_an_operand():
    """Same compiled step, two pos_weight values -> two different losses,
    each matching the reference formula with THAT value."""
    model = tiny_shas()
    params = model.init(jax.random.PRNGKey(0))
    # the jitted step donates its state; keep host copies to rebuild per call
    params_host = jax.tree.map(np.asarray, params)
    mask = model.trainable_mask(params)
    opt = make_optimizer(1e-4, 100, update_freq=1, mask_tree=mask)
    step = make_train_step(
        model, BCEWithLogitsLoss(None), "bce", ma_window_steps=0,
        optimizer=opt, dynamic_pos_weight=True,
    )
    batch = _batch()
    losses = {}
    for pw in (0.9, 0.3):
        params = jax.tree.map(jax.numpy.asarray, params_host)
        state = init_train_state(model, opt, jax.random.PRNGKey(1), params)
        b = dict(batch, pos_weight=np.asarray(pw, np.float32))
        # expected loss BEFORE the step call (the step donates the params)
        logits = model.apply(
            params, batch["audio"], batch["in_lengths"], batch["out_mask"],
            deterministic=False, rng=jax.random.PRNGKey(2),
        )
        expected = float(compute_bce_loss(
            logits, batch["target"], batch["out_mask"],
            BCEWithLogitsLoss(pw), 0,
        ))
        _, metrics = step(state, b, jax.random.PRNGKey(2))
        losses[pw] = float(metrics["loss"])
        assert losses[pw] == pytest.approx(expected, rel=1e-5), pw
    assert losses[0.9] != pytest.approx(losses[0.3], rel=1e-3)


def test_loop_pos_weight_tracks_epochs(tmp_path, monkeypatch):
    """2-epoch run: the pos_weight operand seen by the jitted step in epoch
    2 is epoch 2's value, not a frozen epoch-0 closure."""
    ws = tmp_path / "corpus"
    wav_dir = ws / "wav"
    wav_dir.mkdir(parents=True)
    make_speechlike_wav(wav_dir / "talkA.wav", duration_secs=25, seed=0)
    rows = []
    t = 0.2
    while t + 3.0 < 25:
        rows.append({"duration": 2.8, "offset": round(t, 2),
                     "speaker_id": "NA", "wav": "talkA.wav"})
        t += 3.5
    with open(ws / "train.yaml", "w") as f:
        yaml.dump(rows, f)
    talks_tsv, segments_tsv = prepare_dataset_for_segmentation(
        ws / "train.yaml", wav_dir, ws, split="train")
    monkeypatch.chdir(tmp_path)

    from wav2vecsegmenter_tpu.config import registry

    import tests.helpers as helpers
    import wav2vecsegmenter_tpu.train.loop as loop_mod

    helpers._tiny_builder_pw = lambda **kw: tiny_shas()
    orig = registry._ALIASES["lib.models.SHAS"]
    registry.register("lib.models.SHAS", "tests.helpers:_tiny_builder_pw")

    # force differing pos_weights per epoch and record what the step sees
    epoch_pws = [0.9, 0.3]
    built, seen = [], []
    real_build_loss = loop_mod.build_loss

    def fake_build_loss(conf, pos_pct, vocab):
        _, tag, ma = real_build_loss(conf, pos_pct, vocab)
        pw = epoch_pws[min(len(built), len(epoch_pws) - 1)]
        built.append(pw)
        return BCEWithLogitsLoss(pw), tag, ma

    real_make_step = loop_mod.make_train_step

    def spy_make_step(*args, **kwargs):
        step = real_make_step(*args, **kwargs)

        def wrapped(state, batch, rng):
            seen.append(float(np.asarray(batch["pos_weight"])))
            return step(state, batch, rng)

        return wrapped

    monkeypatch.setattr(loop_mod, "build_loss", fake_build_loss)
    monkeypatch.setattr(loop_mod, "make_train_step", spy_make_step)

    try:
        cfg = compose(CONF, "train", overrides=[
            "exp_name=pwtrack",
            "batch_size=2",
            "segment_length=4",
            "max_epochs=2",
            "update_freq=1",
            "print_every_steps=100",
            "save_every_steps=999999",
            "save_ckpts=false",
            "learning_rate=1e-4",
            f"data.train.talk_list={talks_tsv}",
            f"data.train.segments_list={segments_tsv}",
            f"data.eval.talk_list={talks_tsv}",
            f"data.eval.segments_list={segments_tsv}",
            "runtime.compute_dtype=float32",
        ])
        loop_mod.train(cfg, work_dir=tmp_path)
    finally:
        registry._ALIASES["lib.models.SHAS"] = orig

    assert len(built) >= 2, "build_loss should run once per epoch"
    assert seen, "no train steps ran"
    # the step must have seen BOTH values, in epoch order
    uniq = sorted(set(round(v, 4) for v in seen))
    assert uniq == [0.3, 0.9], seen
    assert seen[0] == pytest.approx(0.9) and seen[-1] == pytest.approx(0.3)
