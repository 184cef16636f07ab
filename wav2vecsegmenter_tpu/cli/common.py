"""Shared CLI plumbing: override parsing, logging init, model building, and
the wav-dir -> custom_segments.yaml generation loop shared by segment.py /
inference.py / inference_st_pipe.py (reference segment.py:26-131,
inference.py:26-131, train.py:36-212)."""

from __future__ import annotations

import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import yaml

from ..algorithms import (
    pdac,
    pdac_with_logits,
    pthr,
    strm,
    update_yaml_content,
)
from ..checkpoints.io import load_model_checkpoint
from ..config import Config, instantiate, to_plain, to_yaml
from ..data.datasets import FixedSegmentationDatasetNoTarget
from ..data.loader import BatchIterator
from ..infer.pipeline import WindowInference

logger = logging.getLogger("wav2vecsegmenter_tpu")


CONF_DIR = Path(__file__).resolve().parents[2] / "conf"


def parse_overrides(argv: list[str] | None = None) -> list[str]:
    argv = sys.argv[1:] if argv is None else argv
    return [a for a in argv if "=" in a and not a.startswith("--")]


def parse_cli(argv: list[str] | None = None) -> tuple[bool, list[str]]:
    """(multirun, overrides): hydra CLI surface — ``-m``/``--multirun``
    turns comma-separated override values into a sweep (reference README
    "Parameter search", inference_st_pipe.py with Hydra's basic sweeper)."""
    argv = sys.argv[1:] if argv is None else argv
    multirun = any(a in ("-m", "--multirun") for a in argv)
    overrides = parse_overrides(argv)
    if not multirun:
        # hydra parity: a choice sweep ('a=1,2') in single-run mode is an
        # up-front error, not a literal string that crashes deep in the run
        for ov in overrides:
            key, _, raw = ov.partition("=")
            if len(_split_sweep(raw)) > 1:
                raise ValueError(
                    f"Ambiguous value for argument '{ov}': comma-separated "
                    "choice sweeps need -m / --multirun")
    return multirun, overrides


def _split_sweep(value: str) -> list[str]:
    """Split a CLI override value on top-level commas (commas inside
    [...]/{...} belong to yaml lists, not sweeps)."""
    parts, depth, cur = [], 0, []
    for ch in value:
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts


def expand_sweeps(overrides: list[str]) -> list[list[str]]:
    """Hydra basic-sweeper semantics: every override with top-level commas
    is a choice dimension; jobs are the cartesian product (last dimension
    varies fastest, like hydra's job numbering)."""
    import itertools

    dims = []
    for ov in overrides:
        key, _, raw = ov.partition("=")
        dims.append([f"{key}={v}" for v in _split_sweep(raw)])
    return [list(combo) for combo in itertools.product(*dims)]


def hydra_override_dirname(overrides: list[str],
                           exclude_keys=()) -> str:
    """Hydra's ``${hydra.job.override_dirname}``: the CLI overrides as
    ``key=value`` sorted by key and joined with ','.  ``exclude_keys``
    entries drop both the exact key and (extension for this framework's
    ``runtime`` block) any dotted subkey of an excluded prefix."""
    exclude = set(exclude_keys or ())
    items = []
    for ov in overrides:
        key, _, val = ov.partition("=")
        k = key.lstrip("+~")
        if k in exclude or any(k.startswith(e + ".") for e in exclude):
            continue
        items.append((k, f"{k}={val}"))
    return ",".join(s for _, s in sorted(items))


def compose_app(config_name: str, overrides: list[str],
                multirun: bool = False):
    """Compose an app config and resolve its hydra-style run directory.

    Mirrors the reference's hydra blocks (conf/segment.yaml:16-29,
    conf/inference.yaml:30-43): ``hydra.run.dir`` for single runs,
    ``hydra.sweep.dir``/``subdir`` for multirun jobs, both interpolating
    ``${hydra.job.override_dirname}``.  Returns (config, run_dir or None).
    """
    from ..config import compose, resolve

    cfg = compose(CONF_DIR, config_name, overrides, resolve_interp=False)
    hnode = cfg.get("hydra") or {}
    exclude = (
        cfg.select("hydra.job.config.override_dirname.exclude_keys") or []
    )
    dirname = hydra_override_dirname(overrides, exclude)
    if hnode:
        cfg.update_path("hydra.job.override_dirname", dirname)
    cfg = resolve(cfg)
    run_dir = None
    h = cfg.get("hydra") or {}
    if multirun:
        sweep = h.get("sweep") if isinstance(h, dict) else None
        if sweep and sweep.get("dir") is not None:
            run_dir = Path(str(sweep["dir"])) / str(
                sweep.get("subdir", dirname))
    else:
        run = h.get("run") if isinstance(h, dict) else None
        if run and run.get("dir") is not None:
            run_dir = Path(str(run["dir"]))
    return cfg, run_dir


def init_logging(config: Config, logfile: str = "log") -> None:
    """Run-dir logging + config/git dump (reference init, segment.py:134-156)."""
    handlers = [logging.StreamHandler()]
    try:
        handlers.append(logging.FileHandler(logfile))
    except OSError:
        pass
    logging.basicConfig(
        level=logging.INFO,
        format="[%(levelname)s %(asctime)s] %(message)s",
        handlers=handlers,
        force=True,
    )
    logger.info("Host: [%s]", os.uname()[1])
    logger.info("JAX_PLATFORMS = %s", os.environ.get("JAX_PLATFORMS", ""))
    git = subprocess.run(
        ["git", "rev-parse", "--is-inside-work-tree"],
        capture_output=True, text=True, check=False,
    )
    if git.returncode == 0:
        # reference init dumps the last commit AND the working-tree diff so
        # every run log records exactly what code produced it
        # (reference train.py:757-767)
        git_log = subprocess.run(
            ["git", "log", "-n1"], capture_output=True, text=True, check=False
        ).stdout
        git_diff = subprocess.run(
            ["git", "diff"], capture_output=True, text=True, check=False
        ).stdout
        logger.info(
            "Git repository is found. Dumping logs & diffs...\n%s\n%s",
            git_log, git_diff,
        )
    else:
        logger.info("Git repository is not found.")
    logger.info("Command: %s", " ".join(sys.argv))
    logger.info("Command is executed at: [%s]", os.getcwd())
    logger.info("Config:\n%s", to_yaml(config))


def apply_runtime(config: Config):
    """Apply the runtime block; returns the compute dtype."""
    from ..core import platform
    from ..core.runtime import maybe_init_distributed

    maybe_init_distributed()  # before the first backend query
    platform.setup_compilation_cache()
    rt = config.get("runtime") or {}
    return platform.compute_dtype(rt.get("compute_dtype", "bfloat16"))


def build_model(config: Config):
    """instantiate(config.task.model) with vocab_size wiring
    (reference train.py:257-261, segment.py:33-43)."""
    vocab = instantiate(config.task.vocab) if config.task.get("vocab") else None
    model_node = dict(config.task.model)
    if vocab is not None:
        model_node["vocab_size"] = vocab.vocab_size
    model = instantiate(Config(model_node))
    return model, vocab


def load_params(config: Config, model, ckpt_path: str):
    allow_random = bool(config.get("allow_random_wav2vec", False))
    return load_model_checkpoint(model, ckpt_path,
                                 allow_random_wav2vec=allow_random)


def hop_conf(config) -> dict:
    """Online low-latency knob (hop_secs / lookahead_secs) from config.

    Returns kwargs for OnlineSegmenter/MultiStreamSegmenter: hop mode
    re-runs the encoder every hop_secs over the trailing window and commits
    frames older than lookahead_secs — lag <= hop+lookahead (+ the
    algorithm's own horizon) instead of <= segment_length, at
    ~segment_length/hop_secs x the encoder compute (infer/online.py)."""
    out = {}
    if config.get("hop_secs") is not None:
        out["hop_secs"] = float(config["hop_secs"])
        if config.get("lookahead_secs") is not None:
            out["lookahead_secs"] = float(config["lookahead_secs"])
    return out


def run_algorithm(tag: str, algo_conf: dict, probs: np.ndarray,
                  logits: np.ndarray, vocab):
    """Algorithm dispatch (reference segment.py:107-119)."""
    conf = dict(algo_conf)
    conf.pop("tag", None)
    if tag == "dac":
        return pdac(probs, **conf)
    if tag == "dac_logits":
        return pdac_with_logits(probs, logits, vocab, **conf)
    if tag == "strm":
        return strm(probs, **conf)
    if tag == "pthr":
        return pthr(probs, **conf)
    raise NotImplementedError(f"Unknown algorithm tag '{tag}'")


def segment_wavs(
    config: Config,
    model,
    params,
    vocab,
    wav_paths: list[Path],
    compute_dtype,
    engine: WindowInference | None = None,
) -> list[dict]:
    """The product loop: per wav, multi-pass sliding-window inference,
    probability averaging, algorithm dispatch, yaml rows.

    Honors ``runtime.mesh`` (multi-chip inference): windows are sharded over
    the 'data' mesh axis with params replicated, and the batch size is
    rounded up to a device multiple (loaders pad every batch to the static
    batch size, so sharding divisibility always holds)."""
    import jax

    from ..parallel.mesh import pad_batch_to_devices, resolve_mesh

    rt = config.get("runtime") or {}
    mesh, n_data, n_model = resolve_mesh(rt.get("mesh"))
    n_devices = n_data  # windows shard over the data axis only
    batch_size = int(config.batch_size)
    if mesh is not None:
        padded = pad_batch_to_devices(batch_size, n_devices)
        if padded != batch_size:
            logger.info("batch_size %d -> %d (multiple of %d devices)",
                        batch_size, padded, n_devices)
            batch_size = padded

    if engine is None:
        engine = WindowInference(
            model, params, loss_tag=config.task.loss.tag,
            compute_dtype=compute_dtype, vocab=vocab, mesh=mesh,
            quantize=rt.get("quantize"), precision=rt.get("precision"),
        )
    algo_conf = to_plain(config.algorithm)
    tag = algo_conf.pop("tag")
    inference_times = int(config.inference_times)

    import time

    # optional jax.profiler capture of the first talk
    # (runtime.profile_dir, SURVEY §5.1 observability)
    profile_dir = rt.get("profile_dir")
    profiling = False
    if profile_dir:
        jax.profiler.start_trace(str(profile_dir))
        profiling = True

    from ..infer.pipeline import collect_talk, dispatch_talk

    need_logits = tag == "dac_logits"

    # opt-in cross-talk window packing: fill each talk's partial batches
    # with the next talk's windows instead of padding (~10% of sweep compute
    # otherwise runs on dead rows).  Changes batch composition, so the
    # batch-max normalization window can differ for tail windows — same
    # deviation class as changing batch_size; documented in PARITY.md and
    # therefore opt-in (infer/packing.py).
    packer = None
    if rt.get("pack_across_talks"):
        from ..infer.packing import PackedSweep

        packer = PackedSweep(engine, batch_size,
                             float(config.inference_segment_length),
                             need_logits=need_logits)
        logger.info("pack_across_talks enabled")

    def dispatch_one(wav_path):
        """Decode + upload + launch ALL passes of one talk (no waiting)."""
        dataset = FixedSegmentationDatasetNoTarget(
            wav_path, config.inference_segment_length, inference_times
        )
        passes = []
        for it in range(inference_times):
            dataset.fixed_length_segmentation(it)
            if packer is not None:
                unit = packer.new_unit()
                packer.add_dataset_pass(unit, dataset)
                passes.append(unit)
                continue
            batches = BatchIterator(
                dataset, batch_size,
                float(config.inference_segment_length),
                shuffle=False,
                device_normalize=True,
                # right-size the final partial batch of each (talk, pass)
                # instead of padding to batch_size (data/loader._slots_for);
                # runtime.infer_remainder_ladder=false restores single-shape
                # compilation if the extra per-slot-count compiles hurt
                remainder_ladder=bool(rt.get("infer_remainder_ladder", True)),
                min_multiple=n_devices if mesh is not None else 1,
            )
            passes.append(dispatch_talk(engine, batches))
        return {"wav": wav_path, "dataset": dataset, "passes": passes,
                "t0": time.perf_counter()}

    yaml_content: list[dict] = []
    total_audio_secs = 0.0
    t_all = time.perf_counter()

    def drain_one(h):
        nonlocal yaml_content, total_audio_secs
        dataset = h["dataset"]
        sgm_frame_probs = None
        sgm_frame_logits = None
        for pending in h["passes"]:
            if packer is not None:
                probs, logits = packer.drain_unit(
                    pending, dataset.duration_outframes)
            else:
                probs, logits, _ = collect_talk(
                    engine, pending, dataset.duration_outframes,
                    need_logits=need_logits,
                )
            if sgm_frame_probs is None:
                sgm_frame_probs, sgm_frame_logits = probs, logits
            else:
                sgm_frame_probs += probs
                sgm_frame_logits += logits
        sgm_frame_probs /= inference_times

        segments = run_algorithm(tag, algo_conf, sgm_frame_probs,
                                 sgm_frame_logits, vocab)
        yaml_content = update_yaml_content(
            yaml_content, segments, Path(h["wav"]).name
        )
        talk_secs = dataset.duration_inframes / 16000
        total_audio_secs += talk_secs
        dt = time.perf_counter() - h["t0"]
        logger.info("%s: %.1fs audio in %.2fs (%.0fx RT, pipelined)",
                    Path(h["wav"]).name, talk_secs, dt, talk_secs / dt)

    def drain_and_maybe_stop_profile(h):
        nonlocal profiling
        drain_one(h)
        if profiling:
            jax.profiler.stop_trace()
            profiling = False
            logger.info("profiler trace of first talk written to %s",
                        profile_dir)

    # talk lookahead: the next talks' decode + uploads + forwards are in
    # flight while talk N's probabilities stream back and its segmentation
    # algorithm runs on host — the device never idles between talks.
    # Dispatch stays on the MAIN thread: a 1-worker dispatcher thread lost
    # on a 1-core host, where a third CPU-bound thread only adds GIL
    # contention with the BatchIterator producer (ROADMAP S10).  Packed
    # sweeps need DEPTH 2: a talk's last batch only flushes once the NEXT
    # talk's windows top the buffer up, so with depth 1 every drain would
    # block on a just-launched batch.
    from collections import deque

    lookahead = 2 if packer is not None else 1
    in_flight: deque = deque()
    try:
        for wav_path in wav_paths:
            in_flight.append(dispatch_one(wav_path))
            if len(in_flight) > lookahead:
                drain_and_maybe_stop_profile(in_flight.popleft())
        while in_flight:
            drain_and_maybe_stop_profile(in_flight.popleft())
    finally:
        # a mid-sweep failure must not leak a running profiler trace (the
        # next segment_wavs in this process would hit "trace already
        # started") or the packer's dispatch threads; stop_trace itself
        # failing (unwritable dir at flush) must still close the packer
        # and not mask the original exception
        try:
            if profiling:
                jax.profiler.stop_trace()
                profiling = False
        except Exception:
            logger.exception("profiler stop failed during sweep cleanup")
        finally:
            if packer is not None:
                packer.close()
    wall = time.perf_counter() - t_all
    if wall > 0 and total_audio_secs:
        logger.info("segmented %.1fs of audio in %.1fs (%.0fx RT overall)",
                    total_audio_secs, wall, total_audio_secs / wall)
    return yaml_content


def wavs_from_yaml(config: Config) -> list[Path]:
    """wav list grouped from the original segmentation yaml
    (reference segment.py:67-72)."""
    import itertools

    wav_dir = Path(config.infer_data.wav_dir)
    with open(config.infer_data.orig_seg_yaml) as f:
        seg_yaml = yaml.safe_load(f)
    return [
        wav_dir / wav
        for wav, _ in itertools.groupby(seg_yaml, key=lambda x: x["wav"])
    ]


def wavs_from_dir(config: Config) -> list[Path]:
    """Sorted wav glob (reference train.py:62-63, inference_st_pipe)."""
    return sorted(Path(config.infer_data.wav_dir).glob("*.wav"))
