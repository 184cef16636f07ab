"""Cross-talk window packing (runtime.pack_across_talks, VERDICT r2 weak #6):
packed sweeps use fewer batches and stay within the batch-size deviation
envelope (PARITY.md "Cross-talk packing")."""

from pathlib import Path

import numpy as np
import pytest
import yaml

import jax

from wav2vecsegmenter_tpu.data.datasets import FixedSegmentationDatasetNoTarget
from wav2vecsegmenter_tpu.data.loader import BatchIterator
from wav2vecsegmenter_tpu.infer.packing import PackedSweep
from wav2vecsegmenter_tpu.infer.pipeline import WindowInference, infer_talk

from .helpers import make_speechlike_wav, tiny_shas

SEG_LEN = 4.0


@pytest.fixture(scope="module")
def talks(tmp_path_factory):
    ws = tmp_path_factory.mktemp("packing")
    paths = []
    for i, dur in enumerate((25.0, 18.3, 13.7)):
        p = ws / f"talk{i}.wav"
        make_speechlike_wav(p, duration_secs=dur, seed=i)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def engine():
    model = tiny_shas()
    params = model.init(jax.random.PRNGKey(0))
    return WindowInference(model, params, loss_tag="bce")


class CountingEngine:
    def __init__(self, engine):
        self.engine = engine
        self.model = engine.model
        self.n_batches = 0

    def run_batch(self, batch):
        self.n_batches += 1
        return self.engine.run_batch(batch)


def _unpacked_probs(engine, wav, batch_size):
    dataset = FixedSegmentationDatasetNoTarget(wav, SEG_LEN, 1)
    dataset.fixed_length_segmentation(0)
    batches = BatchIterator(dataset, batch_size, SEG_LEN, shuffle=False,
                            device_normalize=True)
    probs, _, _ = infer_talk(engine, batches, dataset.duration_outframes,
                             need_logits=False)
    return probs


def _packed_probs(engine, wavs, batch_size):
    counting = CountingEngine(engine)
    packer = PackedSweep(counting, batch_size, SEG_LEN)
    units, datasets = [], []
    for wav in wavs:
        dataset = FixedSegmentationDatasetNoTarget(wav, SEG_LEN, 1)
        dataset.fixed_length_segmentation(0)
        unit = packer.new_unit()
        packer.add_dataset_pass(unit, dataset)
        units.append(unit)
        datasets.append(dataset)
    out = [packer.drain_unit(u, d.duration_outframes)[0]
           for u, d in zip(units, datasets)]
    packer.close()
    return out, counting.n_batches


def test_batch_size_1_packing_is_identity(engine, talks):
    """With batch_size=1 every batch is full, so packing changes nothing:
    probabilities must be bit-identical to the per-talk sweep."""
    packed, _ = _packed_probs(engine, talks, 1)
    for wav, p in zip(talks, packed):
        np.testing.assert_array_equal(p, _unpacked_probs(engine, wav, 1))


def test_packed_within_batch_size_envelope(engine, talks):
    """Packed output differs from the per-talk sweep by at most the same
    envelope as changing batch_size (the deviation documented in PARITY.md).

    The envelope must include B=1 (every window normalized over its own
    length): packing regroups windows across talks, so a window that shared
    a batch with a longer tail window normalizes over its own bucket instead
    — precisely what B=1 also does.  Measured ratios packed/envelope:
    0.96 / 0.02 / 1.00 for the three talks."""
    B = 4
    packed, _ = _packed_probs(engine, talks, B)

    for wav, p in zip(talks, packed):
        u_b = _unpacked_probs(engine, wav, B)
        env = max(
            np.abs(u_b - _unpacked_probs(engine, wav, bb)).max()
            for bb in (1, 3)
        )
        diff = np.abs(p - u_b).max()
        assert diff <= max(1.5 * env, 1e-5), (diff, env)


def test_packed_uses_fewer_batches(engine, tmp_path):
    """The efficiency claim: per-talk remainders coalesce.  3 talks x 8
    std-bucket windows at batch_size 6: unpacked = ceil(8/6)*3 = 6 batches,
    packed = ceil(24/6) = 4."""
    wavs = []
    for i in range(3):
        p = tmp_path / f"u{i}.wav"
        # 30.5 s at 4 s windows -> 7 full + free-standing 2.5 s = 8 windows,
        # all in the std bucket
        make_speechlike_wav(p, duration_secs=30.5, seed=10 + i)
        wavs.append(p)
    B = 6
    packed, n_packed = _packed_probs(engine, wavs, B)
    n_unpacked = 0
    for wav in wavs:
        dataset = FixedSegmentationDatasetNoTarget(wav, SEG_LEN, 1)
        dataset.fixed_length_segmentation(0)
        assert len(dataset) == 8
        n_unpacked += -(-len(dataset) // B)
    assert n_packed < n_unpacked, (n_packed, n_unpacked)
    assert np.isfinite(np.concatenate(packed)).all()


def test_segment_cli_pack_across_talks(tmp_path):
    """Config plumbing: +runtime.pack_across_talks=true through the segment
    CLI produces a valid, near-identical custom_segments.yaml."""
    from wav2vecsegmenter_tpu.checkpoints.io import save_orbax
    from wav2vecsegmenter_tpu.config import compose, registry, save_config

    ws = tmp_path
    wav_dir = ws / "wav"
    wav_dir.mkdir()
    make_speechlike_wav(wav_dir / "a.wav", duration_secs=21.0, seed=5)
    make_speechlike_wav(wav_dir / "b.wav", duration_secs=14.6, seed=6)
    txt_dir = ws / "txt"
    txt_dir.mkdir()
    orig = [
        {"duration": 21.0, "offset": 0.0, "speaker_id": "NA", "wav": "a.wav"},
        {"duration": 14.6, "offset": 0.0, "speaker_id": "NA", "wav": "b.wav"},
    ]
    with open(txt_dir / "orig.yaml", "w") as f:
        yaml.dump(orig, f)

    model = tiny_shas()
    params = model.init(jax.random.PRNGKey(0))
    save_orbax(ws / "ckpt", params)
    train_cfg = compose(Path(__file__).parents[1] / "conf", "train")
    save_config(train_cfg, ws / "train_config.yaml")

    import tests.helpers as helpers

    def build_tiny(**kwargs):
        return tiny_shas()

    helpers._tiny_builder_pack = build_tiny
    orig = registry._ALIASES["lib.models.SHAS"]
    registry.register("lib.models.SHAS", "tests.helpers:_tiny_builder_pack")
    try:
        from wav2vecsegmenter_tpu.cli.segment import main

        def run(name, extra):
            argv = [
                f"ckpt_path={ws}/ckpt",
                f"config_path={ws}/train_config.yaml",
                f"output_dir={ws / name}",
                f"+results_path={ws / name}",
                f"infer_data.wav_dir={wav_dir}",
                f"infer_data.orig_seg_yaml={txt_dir}/orig.yaml",
                "algorithm=pthr",
                "inference_segment_length=4",
                "batch_size=3",
                "runtime.compute_dtype=float32",
                *extra,
            ]
            return main(argv)

        plain = run("out_plain", [])
        packed = run("out_packed", ["runtime.pack_across_talks=true"])
    finally:
        registry._ALIASES["lib.models.SHAS"] = orig

    assert len(packed) > 0
    # same talks covered; segment rows nearly identical (tiny numeric
    # deviations can shift a boundary by at most one frame)
    assert {r["wav"] for r in packed} == {r["wav"] for r in plain}
    assert abs(len(packed) - len(plain)) <= 1
    tol = 0.06  # one 0.06 s trim step
    for pr, pl in zip(packed, plain):
        if pr["wav"] != pl["wav"]:
            continue
        assert abs(pr["offset"] - pl["offset"]) <= tol + 1e-9
        assert abs(pr["duration"] - pl["duration"]) <= 2 * tol + 1e-9
    yaml.safe_load(open(ws / "out_packed" / "custom_segments.yaml"))


def test_segment_wavs_cleanup_on_midsweep_failure(talks, engine, tmp_path,
                                                  monkeypatch):
    """A failure while draining a talk must stop the running profiler trace
    and close the packer (cli/common.segment_wavs try/finally) — a leaked
    trace breaks every later segment_wavs in the same process with
    'profiler trace already started'."""
    import jax.numpy as jnp

    import wav2vecsegmenter_tpu.cli.common as common
    from wav2vecsegmenter_tpu.config import Config

    def cfg(profile_sub):
        return Config({
            "batch_size": 4,
            "inference_times": 1,
            "inference_segment_length": SEG_LEN,
            "algorithm": {"tag": "dac", "max_segment_length": 10,
                          "threshold": 0.5},
            "task": {"loss": {"tag": "bce"}},
            "runtime": {"profile_dir": str(tmp_path / profile_sub),
                        "pack_across_talks": True},
        })

    def boom_algorithm(*a, **k):
        raise RuntimeError("algo boom")

    with monkeypatch.context() as m:
        m.setattr(common, "run_algorithm", boom_algorithm)
        with pytest.raises(RuntimeError, match="algo boom"):
            common.segment_wavs(cfg("prof1"), engine.model, engine.params,
                                None, talks, jnp.float32, engine=engine)

    # profiler was stopped and the packer closed: the next profiled sweep
    # in this process must run clean end-to-end
    out = common.segment_wavs(cfg("prof2"), engine.model, engine.params,
                              None, talks, jnp.float32, engine=engine)
    assert len(out) > 0
    assert (tmp_path / "prof2").exists()
