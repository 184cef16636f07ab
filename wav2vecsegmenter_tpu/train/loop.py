"""Training orchestration: epochs, metrics, eval, checkpoint rotation.

Control flow mirrors reference train.py:215-747 — per-epoch random
resegmentation, pos_weight auto-derivation, update_freq gradient
accumulation, periodic evaluate(), checkpoint rotation + best-by-eval_f1 —
executed through the jitted data-parallel train step (train/step.py).

Improvements over the reference (SURVEY §5.3/§5.4): a ``resume`` path that
restores params+optimizer+step (the reference loses the epoch on a crash),
and optional jax.profiler trace capture of the first N steps.
"""

from __future__ import annotations

import logging
import shutil
import time
from pathlib import Path

import jax
import numpy as np

from ..checkpoints.io import restore_orbax, save_orbax
from ..config import Config, instantiate, merge, to_plain
from ..eval.metrics import evaluate, train_step_metrics
from ..infer.pipeline import WindowInference
from ..parallel.mesh import resolve_mesh
from .loss import build_loss
from .step import init_train_state, make_optimizer, make_train_step

logger = logging.getLogger("wav2vecsegmenter_tpu")

# default train steps per jit call: K=1 against K=8, timed on an H100 in
# the train phase of chip_smoke.py (PERF.md, Findings), came out within
# 3% of each other, either one ahead — a 24-layer fine-tune step is tens
# of ms of device work and dispatch is far below that, so grouping buys
# nothing measurable
STEPS_PER_CALL = 1


def _batch_arrays(b) -> dict:
    """Host-array dict for one collated batch — the single source for both
    the single-step and K-step device transfers (a field added in only one
    of them would silently diverge the two train paths)."""
    from ..data.collate import AutoRegBatch

    if isinstance(b, AutoRegBatch):
        return {
            "audio": b.audio, "in_lengths": b.in_lengths,
            "in_target": b.in_target, "out_target": b.out_target,
            "src_mask": b.src_mask, "tgt_mask": b.tgt_mask,
        }
    out = {
        "audio": b.audio, "in_lengths": b.in_lengths,
        "target": b.target if b.target is not None else
        np.zeros_like(b.out_mask, np.float32),
        "out_mask": b.out_mask,
    }
    if b.device_normalize:
        out["included"] = b.included
        out["norm_length"] = np.asarray(b.norm_length, np.int32)
    if b.tokens is not None:  # CTC task: encoded window transcripts
        out["tokens"] = b.tokens
        out["included"] = b.included
    return out


def _stack_batches_to_device(group, mesh):
    """Stack K same-shape host batches into [K, ...] arrays with ONE device
    transfer (stacking on device would cost K eager dispatches)."""
    from ..parallel.mesh import replicated

    dicts = [_batch_arrays(b) for b in group]
    stacked = {k: np.stack([d[k] for d in dicts]) for k in dicts[0]}
    # one device_put for the whole dict: one transfer call per group
    if mesh is None:
        return jax.device_put(stacked)
    from jax.sharding import NamedSharding, PartitionSpec as P

    def sh_for(k, v):
        if v.ndim >= 2 and k != "norm_length":
            return NamedSharding(mesh, P(None, "data"))
        return replicated(mesh)

    return jax.device_put(
        stacked, {k: sh_for(k, v) for k, v in stacked.items()})


def _batch_to_device(batch, mesh):
    from ..parallel.mesh import batch_sharding, replicated

    arrays = _batch_arrays(batch)
    if mesh is None:
        return jax.device_put(arrays)  # one transfer for the whole dict
    sh = batch_sharding(mesh)
    rep = replicated(mesh)
    return jax.device_put(
        arrays, {k: rep if k == "norm_length" else sh for k in arrays})


def _run_st_eval(config, model, params, vocab, compute_dtype, results_path,
                 checkpoint_name) -> dict:
    """In-training ST evaluation over st_eval / st_eval_online configs
    (reference train.py:36-212): segment the eval wav dir with the current
    params, then translate+align+score."""
    from ..cli.common import segment_wavs, wavs_from_dir
    from ..stpipe.eval_st import eval_st

    all_results: dict = {}
    for key in ("st_eval", "st_eval_online"):
        st_cfg = config.get(key)
        if not st_cfg:
            continue
        # the segmentation loop reads task.loss.tag from its config
        seg_cfg = merge(Config({"task": config.task}), st_cfg)
        algorithm = st_cfg.algorithm.tag
        try:
            yaml_content = segment_wavs(
                seg_cfg, model, params, vocab,
                wavs_from_dir(st_cfg), compute_dtype,
            )
        except FileNotFoundError as e:
            logger.warning("%s skipped: %s", key, e)
            continue
        out = (Path(results_path) / "eval_st" / checkpoint_name / algorithm)
        all_results.update(eval_st(st_cfg, yaml_content, out, algorithm))
    return all_results


def _init_wandb(config, results_path):
    """Optional wandb run (reference train.py:224-232); silently disabled
    when wandb is not installed."""
    from ..core.wandblog import init_wandb

    return init_wandb(config, results_path)


def train(config: Config, work_dir: str | Path | None = None) -> dict:
    """Run training; returns final eval results."""
    from ..core import platform
    from ..core.runtime import maybe_init_distributed

    # multi-host SPMD (W2VSEG_COORDINATOR / W2VSEG_DISTRIBUTED=auto env):
    # after this, jax.devices() is the global device list and the mesh +
    # jitted steps below scale across hosts unchanged — every process
    # computes the same seed-deterministic global batches and device_put
    # transfers only its addressable shards (tests/test_multihost.py)
    multiprocess = maybe_init_distributed()
    proc0 = jax.process_index() == 0
    results_path = Path(work_dir or ".") / config.exp_name
    checkpoints_path = results_path / "ckpts"
    checkpoints_path.mkdir(parents=True, exist_ok=True)
    wandb_run = _init_wandb(config, results_path) if proc0 else None

    rt = config.get("runtime") or {}
    compute_dtype = platform.compute_dtype(rt.get("compute_dtype", "bfloat16"))
    seed = int(rt.get("seed", 0))

    # raw int16 upload + on-device normalization for train batches (halves
    # host->device bytes); parity-sensitive runs can disable it
    device_normalize = bool(rt.get(
        "device_normalize", platform.device_normalize_default()))
    # K train steps per jit call (lax.scan) amortize dispatch; 1 disables
    # grouping
    steps_per_call = int(rt.get("steps_per_call", STEPS_PER_CALL))
    mesh, n_data, n_model = resolve_mesh(rt.get("mesh"))
    n_devices = n_data  # batch replication factor = data axis only

    # effective batch = batch_size * n_devices (reference train.py:245)
    effective_batch_size = int(config.batch_size) * max(1, n_devices)
    device_conf = Config({
        "batch_size": effective_batch_size,
        "num_workers": 4,
    })

    vocab = instantiate(config.task.vocab) if config.task.get("vocab") else None
    autoregression = bool(config.task.autoregression)
    # the CTC task needs encoded transcripts in its batches (tokens field);
    # the generators pull them from segments.tsv's tgt_text column
    is_ctc = config.task.loss.get("tag") == "ctc"

    train_gen_conf = merge(
        merge(config.task.train_generator, config.data.train), device_conf)
    if multiprocess and train_gen_conf.get("seed") is None:
        # SPMD contract: every process must assemble the SAME global batch
        # (jax.device_put verifies cross-process consistency); an unseeded
        # generator would diverge per rank
        train_gen_conf = merge(train_gen_conf, Config({"seed": seed}))
    train_gen = instantiate(
        train_gen_conf,
        autoregression=autoregression, vocab=vocab,
        device_normalize=device_normalize, ctc=is_ctc,
    )
    eval_gen = instantiate(
        merge(merge(config.task.eval_generator, config.data.eval), device_conf),
        autoregression=autoregression, vocab=vocab, ctc=is_ctc,
    )
    # right-size eval talks' final partial batches (data/loader._slots_for);
    # off by default in training: each new slot count compiles another eval
    # forward, a surprise stall mid-run on cold compile caches
    if hasattr(eval_gen, "remainder_ladder"):
        eval_gen.remainder_ladder = bool(rt.get("infer_remainder_ladder",
                                                False))
        if multiprocess and mesh is not None:
            # the multi-host eval engine shards batches over the data axis:
            # every ladder slot count must stay divisible by it
            eval_gen.min_multiple = n_data

    from ..cli.common import build_model

    model, vocab = build_model(config)
    if is_ctc and not getattr(model, "finetune_wav2vec", True):
        # the CTC loss depends only on the backbone+lm_head path: with a
        # frozen backbone, stop_gradient + the trainable mask zero every
        # gradient the loss produces and the run silently trains NOTHING
        raise ValueError(
            "CTC task with finetune_wav2vec=false optimizes nothing "
            "(the loss never touches a trainable parameter); set "
            "task.model.finetune_wav2vec=true")

    rng = jax.random.PRNGKey(seed)
    params = model.init(rng)

    # warm start (reference train.py:290-296)
    if config.get("finetune_from_model"):
        from ..checkpoints.io import load_model_checkpoint

        loaded = load_model_checkpoint(
            model, config.finetune_from_model,
            allow_random_wav2vec=bool(config.get("allow_random_wav2vec")),
        )
        if "wav2vec" in loaded:
            params = loaded
        else:
            params = {**params, "seg": loaded["seg"]}

    n_params = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(params))
    logger.info("Model parameters: %.1fM", n_params / 1e6)
    try:
        from ..models.summary import summarize

        logger.info("Model summary:\n%s",
                    summarize(params, model.trainable_mask(params)))
    except Exception as e:  # summary is informational only
        logger.debug("summary failed: %s", e)

    # first loader to approximate total steps (reference train.py:321-332)
    if hasattr(train_gen, "get_talk_ids"):
        train_loader = train_gen.generate("", 0)
    else:
        train_loader = train_gen.generate()
    update_freq = int(config.update_freq)
    total_steps_approx = int(
        int(config.max_epochs) * len(train_loader) / update_freq * 1.01
    )

    mask_tree = model.trainable_mask(params)
    optimizer = make_optimizer(
        float(config.learning_rate), total_steps_approx, update_freq, mask_tree
    )
    state = init_train_state(model, optimizer, rng, params)

    # resume support (beyond the reference): restores params+opt+step AND
    # the checkpoint bookkeeping (rotation list, best score/dir, global
    # step) so rotation and best-ckpt selection continue where they left
    # off — without this, pre-crash ckpts never rotate out and a worse
    # post-resume eval creates a second stale *_best dir
    resume_dir = results_path / "last_state"
    start_epoch = 0
    resume_global_step = 0
    best_metric = config.get("best_ckpt_metric", "eval_f1")
    ckpt_list: list[Path] = []
    best_score = 0.0
    best_checkpoint: Path | None = None
    if config.get("resume") and resume_dir.exists():
        template = jax.eval_shape(lambda: state)
        state = restore_orbax(resume_dir, template=template)
        meta = to_plain(
            __import__("yaml").safe_load(open(resume_dir / "meta.yaml"))
        ) if (resume_dir / "meta.yaml").exists() else {}
        start_epoch = int(meta.get("epoch", 0))
        resume_global_step = int(meta.get("global_step", 0))
        ckpt_list = [
            checkpoints_path / name
            for name in meta.get("ckpt_list", [])
            if (checkpoints_path / name).exists()
        ]
        best_score = float(meta.get("best_score", 0.0))
        if meta.get("best_checkpoint"):
            cand = checkpoints_path / meta["best_checkpoint"]
            best_checkpoint = cand if cand.exists() else None
        if start_epoch > 0 and hasattr(train_gen, "skip_epoch_seeds"):
            # continue the per-epoch random-segmentation seed stream where
            # the crashed run left off: the pre-loop generate() consumed
            # seed #1, epoch start_epoch must regenerate with seed
            # #(start_epoch+1) — not replay the epochs already trained on
            train_gen.skip_epoch_seeds(start_epoch - 1)
        logger.info(
            "Resumed from %s at epoch %d (global_step=%d, %d rotating "
            "ckpts, best_%s=%.4f)",
            resume_dir, start_epoch, resume_global_step, len(ckpt_list),
            best_metric, best_score,
        )

    # tensor parallelism and/or FSDP (runtime.mesh.fsdp): place params +
    # optimizer moments sharded before the first jitted call
    # (parallel/mesh.py); FSDP shards every large leaf over 'data'
    # (ZeRO-3 — XLA all-gathers at use, reduce-scatters the grads)
    fsdp = bool((rt.get("mesh") or {}).get("fsdp"))
    state_sh = None
    if mesh is not None and (n_model > 1 or fsdp):
        from ..parallel.mesh import state_shardings

        state_sh = state_shardings(mesh, state, fsdp=fsdp)
        state = jax.device_put(state, state_sh)

    def save_ckpt(name: str, results: dict | None):
        nonlocal best_score, best_checkpoint
        if not config.get("save_ckpts", True):
            return
        # layout parity: seg-only unless finetuning the backbone
        # (reference train.py:596-613)
        tree = state.params if model.save_full_state else {
            "seg": state.params["seg"]
        }
        path = checkpoints_path / name
        save_orbax(path, tree)
        ckpt_list.append(path)
        # process 0 writes the checkpoints (save_orbax), so it alone
        # deletes them
        if len(ckpt_list) > int(config.get("keep_last_ckpts", 8)):
            stale = ckpt_list.pop(0)
            if proc0:
                shutil.rmtree(stale, ignore_errors=True)
        if config.get("keep_best_ckpt", True) and results:
            score = results.get(best_metric, 0.0)
            if score > best_score:
                if best_checkpoint is not None and proc0:
                    shutil.rmtree(best_checkpoint, ignore_errors=True)
                best_checkpoint = checkpoints_path / f"{name}_best_{best_metric}"
                best_score = score
                save_orbax(best_checkpoint, tree)

    train_step = None
    from .step import make_accum_flush

    # reference train.py:477: the optimizer steps at epoch end even on a
    # partial accumulation; None when update_freq == 1
    accum_flush = make_accum_flush(optimizer, mesh=mesh,
                                   state_shardings=state_sh)
    engine = WindowInference(
        model, state.params, loss_tag=config.task.loss.tag,
        compute_dtype=compute_dtype, vocab=vocab,
        # multi-host: in-training eval must run the same global-mesh SPMD
        # program on every process (params live on the global mesh; an
        # unannotated jit would guess shardings per process).  Tensor
        # parallelism also needs the mesh: params are model-sharded; plain
        # single-host data parallel evals unsharded on device 0.  TP/FSDP eval reuses the train
        # state's param shardings — the engine's default (replicated)
        # in_shardings would reject the committed sharded state.params.
        mesh=mesh if (multiprocess or n_model > 1 or fsdp) else None,
        param_shardings=(state_sh.params if state_sh is not None else None),
    )

    global_step = resume_global_step
    results: dict = {}
    profile_steps = int(rt.get("profile_steps", 0) or 0)
    # Profile the first profile_steps steps taken by THIS process (works on
    # resumed runs too, where global_step starts non-zero); the paired flag
    # guarantees stop_trace is only called after our own start_trace.
    trace_stop_at = resume_global_step + profile_steps
    trace_started = False

    for epoch in range(start_epoch, int(config.max_epochs)):
        logger.info("Starting epoch %d ...", epoch)
        if epoch != start_epoch or start_epoch > 0:
            if hasattr(train_gen, "get_talk_ids"):
                train_loader = train_gen.generate("", 0)
            else:
                train_loader = train_gen.generate()

        pos_pct = getattr(train_gen.dataset, "pos_class_percentage", None)
        loss_fn, loss_tag, ma_window = build_loss(
            to_plain(config.task.loss), pos_pct, vocab
        )
        from ..constants import WAV2VEC_FRAME_LEN

        ma_window_steps = int(ma_window / (WAV2VEC_FRAME_LEN / 1000)) \
            if ma_window else 0
        if loss_tag == "bce" and pos_pct is not None:
            logger.info("pos_class_percentage = %s", pos_pct)

        # pos_weight changes with each epoch's regenerated dataset
        # (reference train.py:352-374); the jitted step is built ONCE, so it
        # takes pos_weight as a scalar operand rather than a closure value
        dynamic_pos_weight = loss_tag == "bce"
        pos_weight_arr = np.asarray(
            getattr(loss_fn, "pos_weight", None)
            if getattr(loss_fn, "pos_weight", None) is not None else 1.0,
            np.float32,
        ) if dynamic_pos_weight else None
        if loss_tag == "bce":
            engine.loss_fn = loss_fn
        if train_step is None:
            train_step = make_train_step(
                model, loss_fn, loss_tag, ma_window_steps, optimizer,
                compute_dtype=compute_dtype, vocab=vocab, mesh=mesh,
                autoregression=autoregression,
                device_normalize=device_normalize,
                dynamic_pos_weight=dynamic_pos_weight,
                state_shardings=state_sh,
            )
            multi_step = None
            if steps_per_call > 1:
                from .step import make_train_multistep

                multi_step = make_train_multistep(
                    model, loss_fn, loss_tag, ma_window_steps, optimizer,
                    steps_per_call, compute_dtype=compute_dtype, vocab=vocab,
                    mesh=mesh, autoregression=autoregression,
                    device_normalize=device_normalize,
                    dynamic_pos_weight=dynamic_pos_weight,
                    state_shardings=state_sh,
                )

        steps_in_epoch = len(train_loader)
        all_losses, all_preds, all_targets = [], [], []
        all_gnorms: list[float] = []
        t_start = time.time()
        step = 0

        def accumulate_metrics(batch, loss_val, logits):
            all_losses.append(float(loss_val))
            if logits is None:
                return
            if loss_tag == "bce":
                lg = np.asarray(logits)
                t = min(lg.shape[1], batch.out_mask.shape[1])
                m = batch.out_mask[:, :t]
                all_preds.extend(
                    ((1 / (1 + np.exp(-lg[:, :t]))) >= 0.5)[m].tolist())
                tgt = batch.target[:, :t]
                all_targets.extend((tgt >= 0.5)[m].tolist())
            elif loss_tag in ("ce", "ssl", "ctc") and vocab is not None:
                # boundary/non-boundary micro metrics over special-token
                # positions (reference train.py:495-504)
                lg = np.asarray(logits)
                tgt = batch.out_target if hasattr(batch, "out_target") else \
                    batch.target
                spe = (tgt == vocab.boundary_token_id) | (
                    tgt == vocab.nonboundary_token_id)
                pred = (np.argmax(lg, axis=-1) != vocab.boundary_token_id)
                all_preds.extend(pred[spe].astype(float).tolist())
                all_targets.extend(tgt[spe].astype(float).tolist())

        def after_steps():
            nonlocal all_losses, all_preds, all_targets, all_gnorms, results
            if (step % int(config.print_every_steps) < pending_flushed) or (
                step == steps_in_epoch
            ):
                m = train_step_metrics(all_targets, all_preds, all_losses)
                # gradient-norm telemetry: the wandb.watch(model, log="all")
                # equivalent (reference train.py:317-318)
                if all_gnorms:
                    m["grad_norm"] = float(np.mean(all_gnorms))
                sps = step / (time.time() - t_start)
                logger.info(
                    "Step %d/%d loss=%.4f acc=%.4f f1=%.4f p=%.4f r=%.4f "
                    "(%.2f steps/s)",
                    step, steps_in_epoch, m["loss"], m["accuracy"], m["f1"],
                    m["precision"], m["recall"], sps,
                )
                if wandb_run is not None:
                    wandb_run.log({"epoch": epoch, **m}, step=global_step)
                all_losses, all_preds, all_targets = [], [], []
                all_gnorms = []
            if int(config.save_every_steps) and (
                global_step % int(config.save_every_steps) < pending_flushed
            ):
                engine.params = state.params
                results = evaluate(eval_gen, engine, loss_tag, vocab)
                logger.info("eval @ step %d: %s", global_step, results)
                if config.get("perform_st_evaluation"):
                    results.update(_run_st_eval(
                        config, model, state.params, vocab, compute_dtype,
                        results_path, f"epoch-{epoch}_step-{global_step}",
                    ))
                save_ckpt(f"epoch-{epoch}_step-{global_step}", results)

        def run_single(batch):
            nonlocal state, rng, step, global_step
            step += 1
            global_step += 1
            dev_batch = _batch_to_device(batch, mesh)
            if pos_weight_arr is not None:
                dev_batch["pos_weight"] = pos_weight_arr
            rng_l, sub = jax.random.split(rng)
            rng = rng_l
            new_state, metrics = train_step(state, dev_batch, sub)
            state = new_state
            all_gnorms.append(float(metrics["grad_norm"]))
            lg = metrics["logits"]
            accumulate_metrics(batch, metrics["loss"],
                               lg if lg.is_fully_addressable else None)

        def run_multi(group):
            nonlocal state, rng, step, global_step
            step += len(group)
            global_step += len(group)
            stacked = _stack_batches_to_device(group, mesh)
            if pos_weight_arr is not None:
                stacked["pos_weight"] = pos_weight_arr
            rng_l, sub = jax.random.split(rng)
            rng = rng_l
            new_state, metrics = multi_step(state, stacked, sub)
            state = new_state
            all_gnorms.extend(np.asarray(metrics["grad_norm"]).tolist())
            losses = np.asarray(metrics["loss"])
            # logits stay data-sharded; in multi-host runs they span
            # non-addressable devices, so per-step frame metrics are
            # loss/grad_norm only (eval reports the full F1)
            logits = (np.asarray(metrics["logits"])
                      if metrics["logits"].is_fully_addressable else None)
            for i, b in enumerate(group):
                accumulate_metrics(b, losses[i],
                                   None if logits is None else logits[i])

        def batch_shape_key(b):
            return (b.audio.shape, type(b).__name__)

        # Per-bucket queues: the loader emits two static audio shapes
        # (std/tail); a single FIFO would flush a group as 1-step calls on
        # every bucket alternation.
        # Queuing per shape keeps every full group on the K-step path;
        # only epoch-tail remainders run single.  Cross-bucket reordering
        # is harmless: the random dataset is already a shuffled stream.
        queues: dict = {}
        n_multi = n_single = 0
        for batch in train_loader:
            if profile_steps and not trace_started:
                jax.profiler.start_trace(str(results_path / "profile"))
                trace_started = True
            if multi_step is None:
                pending_flushed = 1
                run_single(batch)
                n_single += 1
                after_steps()
            else:
                q = queues.setdefault(batch_shape_key(batch), [])
                q.append(batch)
                if len(q) == steps_per_call:
                    pending_flushed = steps_per_call
                    run_multi(q)
                    n_multi += steps_per_call
                    after_steps()
                    q.clear()
            if trace_started and global_step >= trace_stop_at:
                jax.block_until_ready(state.params["seg"]["out"]["b"])
                jax.profiler.stop_trace()
                profile_steps = 0
                trace_started = False
        for q in queues.values():
            if q:
                pending_flushed = len(q)
                for b in q:
                    run_single(b)
                n_single += len(q)
                after_steps()
        if accum_flush is not None:
            # apply any partial gradient accumulation before eval/ckpt
            # (reference steps the optimizer at step == steps_in_epoch)
            state = accum_flush(state)
        if trace_started and global_step >= trace_stop_at:
            # the trace target fell inside the epoch-tail drain, where the
            # in-loop stop check never runs: flush before eval
            jax.block_until_ready(state.params["seg"]["out"]["b"])
            jax.profiler.stop_trace()
            profile_steps = 0
            trace_started = False
        if multi_step is not None and (n_multi or n_single):
            total = n_multi + n_single
            logger.info(
                "steps_per_call=%d: %d/%d steps in K-step calls "
                "(%.1f%% ran single)",
                steps_per_call, n_multi, total, 100.0 * n_single / total,
            )

        # end-of-epoch eval + ckpt (reference train.py:654-744)
        engine.params = state.params
        results = evaluate(eval_gen, engine, loss_tag, vocab)
        logger.info("eval @ epoch %d: %s", epoch, results)
        if wandb_run is not None:
            wandb_run.log(results)

        # optional in-training ST evaluation (reference train.py:667-691)
        if config.get("perform_st_evaluation"):
            results.update(_run_st_eval(
                config, model, state.params, vocab, compute_dtype,
                results_path, f"epoch-{epoch}",
            ))

        save_ckpt(f"epoch-{epoch}", results)

        # resume state (params + opt + step) with its bookkeeping, in one
        # atomic save written by process 0
        if config.get("save_ckpts", True):
            import yaml as _yaml

            save_orbax(resume_dir, state, files={"meta.yaml": _yaml.safe_dump({
                "epoch": epoch + 1,
                "global_step": global_step,
                "ckpt_list": [p.name for p in ckpt_list],
                "best_score": float(best_score),
                "best_checkpoint": (
                    best_checkpoint.name if best_checkpoint else None
                ),
            })})

    if trace_started:
        # profile_steps exceeded the run's total steps: flush rather than
        # leak an open trace into the next train()/segment in this process
        jax.profiler.stop_trace()
    if wandb_run is not None:
        wandb_run.finish()
    return results
