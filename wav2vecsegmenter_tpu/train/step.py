"""Jitted training step: loss, grads, masked AdamW update, data-parallel.

Replaces the reference's eager loop body (train.py:381-480):
  * forward+backward+update fuse into one XLA program;
  * gradient accumulation (update_freq) via optax.MultiSteps;
  * LNA partial fine-tuning via 0/1 gradient/update masks from
    ``model.trainable_mask`` — the functional replacement for
    requires_grad=False (reference lib/models.py:335-365);
  * data parallelism: params replicated, batch sharded over the 'data' mesh
    axis; XLA inserts the gradient all-reduce (NCCL on the GPU).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from ..parallel.mesh import batch_sharding, replicated
from .loss import moving_average_jax


class TrainState(NamedTuple):
    params: dict
    opt_state: tuple
    step: jnp.ndarray


def make_optimizer(learning_rate: float, total_steps: int, update_freq: int,
                   mask_tree, weight_decay: float = 0.01):
    """AdamW + cosine annealing to 0 over total_steps optimizer steps
    (reference train.py:326-332; torch AdamW default weight_decay=0.01),
    wrapped in MultiSteps for gradient accumulation (update_freq,
    train.py:474-480) with updates masked by the trainable tree.

    Fully-frozen leaves are excluded from AdamW entirely via optax.masked —
    no moments allocated, no update traffic (torch skips grad=None params
    the same way); partially-frozen stacked layers keep moments and are
    zeroed by the broadcastable mask."""
    import numpy as np

    schedule = optax.cosine_decay_schedule(learning_rate, max(1, total_steps))
    # per-leaf bool: does any element train? (host-computable, static)
    bool_tree = jax.tree.map(
        lambda m: bool(np.asarray(m).max() > 0), mask_tree)
    tx = optax.chain(
        optax.masked(
            optax.adamw(schedule, b1=0.9, b2=0.999, eps=1e-8,
                        weight_decay=weight_decay),
            bool_tree,
        ),
        _mask_updates(mask_tree),
    )
    if update_freq > 1:
        inner = tx
        tx = optax.MultiSteps(tx, every_k_schedule=update_freq)
        # stashed for make_accum_flush (the reference applies the partial
        # accumulation at epoch end, train.py:477)
        tx._w2vseg_inner = inner
        tx._w2vseg_every_k = update_freq
    return tx


def make_accum_flush(optimizer, mesh=None, state_shardings=None):
    """Epoch-end partial-accumulation flush, or None when the optimizer
    does not accumulate.

    The reference steps the optimizer at ``step == steps_in_epoch`` even
    mid-accumulation and zeroes the grads (train.py:474-480), restarting
    accumulation each epoch; optax.MultiSteps alone would carry the
    remainder across the epoch boundary and never apply the run's final
    partial accumulation.  Scaling matches the reference exactly: it
    backprops ``loss/update_freq`` per micro-batch, so a partial flush of
    r < k micro-batches applies sum(grads)/k — MultiSteps stores the
    running MEAN over r, hence the r/k rescale."""
    inner = getattr(optimizer, "_w2vseg_inner", None)
    if inner is None:
        return None
    k = optimizer._w2vseg_every_k

    def flush(state: TrainState) -> TrainState:
        ms = state.opt_state

        def do_flush(operand):
            params, ms = operand
            r = ms.mini_step.astype(jnp.float32)
            grads = jax.tree.map(lambda g: g * (r / k), ms.acc_grads)
            updates, new_inner = inner.update(grads, ms.inner_opt_state,
                                              params)
            new_params = optax.apply_updates(params, updates)
            new_ms = ms._replace(
                mini_step=jnp.zeros_like(ms.mini_step),
                gradient_step=ms.gradient_step + 1,
                inner_opt_state=new_inner,
                acc_grads=jax.tree.map(jnp.zeros_like, ms.acc_grads),
            )
            return new_params, new_ms

        def no_op(operand):
            return operand

        new_params, new_ms = jax.lax.cond(
            ms.mini_step > 0, do_flush, no_op, (state.params, ms))
        return TrainState(new_params, new_ms, state.step)

    if mesh is not None:
        rep = replicated(mesh)
        state_sh = (TrainState(rep, rep, rep) if state_shardings is None
                    else state_shardings)
        return jax.jit(flush, in_shardings=(state_sh,),
                       out_shardings=state_sh, donate_argnums=(0,))
    return jax.jit(flush, donate_argnums=(0,))


def _mask_updates(mask_tree):
    """Zero updates for frozen leaves (mask value 0)."""

    def init_fn(params):
        return optax.EmptyState()

    def update_fn(updates, state, params=None):
        masked = jax.tree.map(lambda u, m: u * m, updates, mask_tree)
        return masked, state

    return optax.GradientTransformation(init_fn, update_fn)


def compute_bce_loss(logits, target, out_mask, loss_fn, ma_window_steps: int):
    """Masked BCE with optional moving-average boundary down-weighting
    (reference train.py:408-454)."""
    t = min(logits.shape[1], target.shape[1])
    logits = logits[:, :t]
    target = target[:, :t]
    out_mask = out_mask[:, :t]
    loss_per_point = loss_fn(logits, target)
    loss_per_point = jnp.where(out_mask, loss_per_point, 0.0)
    if ma_window_steps:
        target_ma = moving_average_jax(target, ma_window_steps)
        ma_weight = 1.0 - jnp.abs(target - target_ma)
        loss_per_point = loss_per_point * ma_weight
    return loss_per_point.sum(axis=1).mean()


def make_train_step(model, loss_fn, loss_tag: str, ma_window_steps: int,
                    optimizer, compute_dtype=jnp.float32, vocab=None,
                    mesh=None, autoregression: bool = False,
                    device_normalize: bool = False,
                    dynamic_pos_weight: bool = False,
                    state_shardings=None):
    """Returns jitted (state, batch_dict, rng) -> (state, metrics).

    With ``dynamic_pos_weight`` the batch dict carries a ``pos_weight``
    scalar operand and the BCE loss is rebuilt per call from it — the
    reference re-derives pos_weight from each epoch's regenerated random
    dataset (train.py:352-374); baking it into the jit closure would freeze
    the epoch-0 value for the whole run.

    ``state_shardings`` (a TrainState-shaped sharding tree from
    parallel.mesh.state_shardings) overrides the default replicated-params
    placement — used for tensor parallelism over the mesh's 'model' axis."""

    def normalize_audio(batch):
        # raw int16 upload + reference-exact normalization on device
        # (see infer/pipeline.py; halves host->device bytes per step)
        x = batch["audio"].astype(jnp.float32) / 32768.0
        L = x.shape[1]
        in_norm = jnp.arange(L)[None, :] < batch["norm_length"]
        count = batch["norm_length"].astype(jnp.float32)
        mean = jnp.sum(jnp.where(in_norm, x, 0.0), axis=1,
                       keepdims=True) / count
        dev = jnp.where(in_norm, x - mean, 0.0)
        var = jnp.sum(dev * dev, axis=1, keepdims=True) / (count - 1)
        std = jnp.sqrt(var)
        xn = jnp.where(std > 0, dev / jnp.maximum(std, 1e-12), 0.0)
        return jnp.where(batch["included"][:, None], xn, 0.0)

    def loss_and_logits(params, batch, rng):
        if device_normalize and not autoregression:
            batch = {**batch, "audio": normalize_audio(batch)}
        if autoregression:
            # teacher-forced decoder CE, summed (reference train.py:455-459)
            logits = model.apply(
                params, batch["audio"], batch["in_lengths"],
                batch["in_target"], batch["src_mask"], batch["tgt_mask"],
                deterministic=False, rng=rng, compute_dtype=compute_dtype,
            )
            lp = loss_fn(
                logits.reshape(-1, logits.shape[-1]),
                batch["out_target"].reshape(-1),
            )
            return lp.sum(), logits
        logits = model.apply(
            params, batch["audio"], batch["in_lengths"], batch["out_mask"],
            deterministic=False, rng=rng, compute_dtype=compute_dtype,
        )
        if loss_tag == "bce":
            lf = loss_fn.with_pos_weight(batch["pos_weight"]) \
                if dynamic_pos_weight else loss_fn
            loss = compute_bce_loss(
                logits, batch["target"], batch["out_mask"], lf,
                ma_window_steps,
            )
        elif loss_tag == "ssl":
            ctc_logits, frame_logits = logits
            target_ctc = jnp.argmax(ctc_logits, axis=-1) + vocab.n_special_tokens
            target = batch["target"].astype(jnp.int32)
            nb_mask = target != vocab.nonboundary_token_id
            target_ssl = jnp.where(nb_mask, target, target_ctc)
            lp = loss_fn(
                frame_logits.reshape(-1, frame_logits.shape[-1]),
                target_ssl.reshape(-1),
            )
            loss = lp.sum(axis=0).mean()
            logits = frame_logits
        elif loss_tag == "ce":
            lp = loss_fn(
                logits.reshape(-1, logits.shape[-1]),
                batch["target"].reshape(-1),
            )
            loss = lp.sum(axis=0).mean()
        elif loss_tag == "ctc":
            # transcript CTC on the lm_head logits (the task the reference's
            # conf/task/shas_ctc.yaml declares but cannot run — its data
            # layer never loads transcripts, lib/dataset.py:45).  Labels are
            # vocab-offset char ids from collate; the lm_head indexes the
            # RAW wav2vec2 char vocabulary (blank/<pad>=0), so the special-
            # token offset is removed here.
            from ..core.frames import CONV_KERNEL_SIZES, CONV_STRIDES

            ctc_logits, frame_logits = logits
            tokens = batch["tokens"]
            pad = vocab.pad_token_id
            label_paddings = (tokens == pad).astype(jnp.float32)
            labels = jnp.where(tokens == pad, 0,
                               tokens - vocab.n_special_tokens)
            # per-row true encoder frame count (exact conv arithmetic —
            # ctc_logits cover conv_output_length(bucket) frames, not the
            # 49.95 Hz out_mask estimate)
            flen = batch["in_lengths"]
            for k_, s_ in zip(CONV_KERNEL_SIZES, CONV_STRIDES):
                flen = (flen - k_) // s_ + 1
            t_enc = ctc_logits.shape[1]
            logit_paddings = (jnp.arange(t_enc)[None, :]
                              >= flen[:, None]).astype(jnp.float32)
            loss = loss_fn(ctc_logits, labels, logit_paddings,
                           label_paddings, example_mask=batch["included"])
            logits = frame_logits
        else:
            raise NotImplementedError(loss_tag)
        return loss, logits

    def step_fn(state: TrainState, batch: dict, rng) -> tuple:
        (loss, logits), grads = jax.value_and_grad(
            loss_and_logits, has_aux=True
        )(state.params, batch, rng)
        updates, opt_state = optimizer.update(
            grads, state.opt_state, state.params
        )
        params = optax.apply_updates(state.params, updates)
        new_state = TrainState(params, opt_state, state.step + 1)
        # global gradient norm: the observability the reference gets from
        # wandb.watch(model, log="all") (train.py:317-318)
        metrics = {"loss": loss, "logits": logits,
                   "grad_norm": optax.global_norm(grads)}
        return new_state, metrics

    if mesh is not None:
        data_sh = batch_sharding(mesh)
        rep = replicated(mesh)
        state_sh = (TrainState(rep, rep, rep) if state_shardings is None
                    else state_shardings)
        batch_shardings = {
            "audio": data_sh, "in_lengths": data_sh, "target": data_sh,
            "out_mask": data_sh,
        }
        if autoregression:
            batch_shardings = {
                "audio": data_sh, "in_lengths": data_sh, "in_target": data_sh,
                "out_target": data_sh, "src_mask": data_sh,
                "tgt_mask": data_sh,
            }
        if device_normalize and not autoregression:
            batch_shardings.update({"norm_length": rep, "included": data_sh})
        if loss_tag == "ctc":
            batch_shardings.update({"tokens": data_sh, "included": data_sh})
        # after the autoregression overwrite: an autoreg task overridden to a
        # bce-tag loss still gets pos_weight injected by the train loop
        if dynamic_pos_weight:
            batch_shardings["pos_weight"] = rep
        return jax.jit(
            step_fn,
            in_shardings=(state_sh, batch_shardings, rep),
            out_shardings=(state_sh, {"loss": rep, "logits": data_sh,
                                      "grad_norm": rep}),
            donate_argnums=(0,),
        )
    return jax.jit(step_fn, donate_argnums=(0,))


def make_train_multistep(model, loss_fn, loss_tag: str, ma_window_steps: int,
                         optimizer, n_steps: int, compute_dtype=jnp.float32,
                         vocab=None, mesh=None, autoregression: bool = False,
                         device_normalize: bool = False,
                         dynamic_pos_weight: bool = False,
                         state_shardings=None):
    """K train steps inside one jit via lax.scan.

    Amortizes per-call dispatch overhead across ``n_steps`` micro-steps: the call takes stacked batches (leading [K] axis) and
    returns the state once.  Losses and last-step logits come back for the
    training metrics."""
    single = make_train_step(
        model, loss_fn, loss_tag, ma_window_steps, optimizer,
        compute_dtype=compute_dtype, vocab=vocab, mesh=None,
        autoregression=autoregression, device_normalize=device_normalize,
        dynamic_pos_weight=dynamic_pos_weight,
    )
    # reuse the un-jitted step body by rebuilding it here (make_train_step
    # returns a jit; jit-of-scan-of-jit is fine — inner jit inlines)

    def multi_fn(state: TrainState, batches: dict, rng) -> tuple:
        keys = jax.random.split(rng, n_steps)
        # pos_weight is a per-epoch scalar, shared by all K micro-steps —
        # keep it out of the scanned xs (whose leaves need a leading K axis)
        pos_weight = batches.get("pos_weight")
        scanned = {k: v for k, v in batches.items() if k != "pos_weight"}

        def body(carry, xs):
            batch, key = xs
            if pos_weight is not None:
                batch = {**batch, "pos_weight": pos_weight}
            new_state, metrics = single(carry, batch, key)
            return new_state, (metrics["loss"], metrics["logits"],
                               metrics["grad_norm"])

        state, (losses, logits, gnorms) = jax.lax.scan(
            body, state, (scanned, keys))
        return state, {"loss": losses, "logits": logits, "grad_norm": gnorms}

    if mesh is not None:
        # batches are [K, B, ...]: shard the batch dim, replicate K; leave
        # the batch pytree's sharding to the caller's device_put (axis 1)
        from jax.sharding import NamedSharding, PartitionSpec as P

        rep = replicated(mesh)
        state_sh = (TrainState(rep, rep, rep) if state_shardings is None
                    else state_shardings)
        # metrics: losses are [K] (replicated); logits stack to [K, B, ...]
        # with the batch on axis 1 — shard that axis like the inputs
        logits_sh = NamedSharding(mesh, P(None, "data"))
        return jax.jit(
            multi_fn,
            in_shardings=(state_sh, None, rep),
            out_shardings=(state_sh, {"loss": rep, "logits": logits_sh,
                                      "grad_norm": rep}),
            donate_argnums=(0,),
        )
    return jax.jit(multi_fn, donate_argnums=(0,))


def init_train_state(model, optimizer, rng, params=None) -> TrainState:
    if params is None:
        params = model.init(rng)
    opt_state = optimizer.init(params)
    return TrainState(params, opt_state, jnp.zeros((), jnp.int32))
