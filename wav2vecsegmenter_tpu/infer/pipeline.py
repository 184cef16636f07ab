"""Batched sliding-window inference: wav -> stitched full-talk frame probs.

Execution model: every batch arrives at one of two static shapes
(standard / tail audio bucket, data/loader.py), so the encoder compiles
exactly twice per model; batches stream through the jitted forward while the
host thread pool decodes and normalizes the next windows (JAX async dispatch
gives the double buffering).  Per talk there is a single device->host
transfer of [B, T] probabilities per batch, stitched into the talk array on
host.

Stitching/NaN-fill semantics replicate reference lib/evaluate.py:9-127.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..data.collate import Batch

# runtime.precision ladder: CUMULATIVE arms between bf16 and f32, trading
# xRT for near-threshold probability fidelity (the bf16 production path
# deviates from the f32 oracle per frame and can flip individual pDAC
# splits — PARITY.md has the deviation measured on the GPU).
#   bf16      — everything in bf16 (default on the GPU)
#   f32head   — + SFC classifier head in f32
#   f32res    — + encoder residual stream & LayerNorms in f32
#   f32lastK  — + last K encoder layers entirely f32 (e.g. f32last4)
#   f32       — everything f32 (the oracle, ~full-model cost)
PRECISION_ARMS = ("bf16", "f32head", "f32res", "f32last4", "f32")


def resolve_precision(precision: str | None, compute_dtype):
    """(compute_dtype, model.apply kwargs) for a runtime.precision value."""
    if not precision or precision == "bf16":
        return compute_dtype, {}
    if precision == "f32":
        return jnp.float32, {}
    kwargs: dict = {"head_dtype": jnp.float32}
    if precision == "f32head":
        return compute_dtype, kwargs
    kwargs["residual_dtype"] = jnp.float32
    if precision == "f32res":
        return compute_dtype, kwargs
    if precision.startswith("f32last"):
        kwargs["f32_last_k"] = int(precision[len("f32last"):])
        return compute_dtype, kwargs
    raise ValueError(
        f"unknown runtime.precision '{precision}' "
        f"(expected one of {PRECISION_ARMS}, f32last<k> for any k)")


class WindowInference:
    """Holds jitted forward functions keyed by batch shape.

    With a ``mesh``, windows are sharded over the 'data' axis — the
    multi-chip inference path; the batch size must be a multiple of the
    data-axis size (loaders pad every batch to the static batch size, so
    this is a config choice, not a data property).  Params are replicated,
    or tensor-parallel over a 'model' axis when the mesh has one
    (parallel/mesh.param_shardings)."""

    def __init__(self, model, params, loss_tag: str = "bce",
                 compute_dtype=jnp.float32, vocab=None,
                 donate: bool = False, mesh=None, loss_fn=None,
                 quantize: str | None = None, param_shardings=None,
                 precision: str | None = None):
        self.model = model
        self.params = params
        self.loss_tag = loss_tag
        self.compute_dtype = compute_dtype
        # mixed-precision ladder (runtime.precision, PARITY.md): cumulative
        # arms trading xRT for near-threshold probability fidelity
        self.compute_dtype, self.precision_kwargs = resolve_precision(
            precision, compute_dtype)
        self.vocab = vocab
        self.mesh = mesh
        self.loss_fn = loss_fn  # optional: per-batch eval loss (bce only)
        self._jitted: dict = {}
        # caller-provided param shardings (e.g. the train loop's in-training
        # eval over FSDP/TP-sharded state.params — the default replicated
        # in_shardings would reject the committed sharded arrays)
        self._param_sh = param_shardings
        if quantize:
            if quantize != "int8":
                raise ValueError(f"unknown quantize mode '{quantize}' "
                                 "(supported: int8)")
            if mesh is not None and mesh.shape.get("model", 1) > 1:
                raise ValueError(
                    "runtime.quantize=int8 does not compose with tensor "
                    "parallelism (per-channel scales are not partitioned)")
            from ..ops.quant import quantize_params

            # one-time weight quantization; activations quantize dynamically
            # inside the jitted forward (ops/quant.py)
            self.params = quantize_params(params)
        if (mesh is not None and mesh.shape.get("model", 1) > 1
                and self._param_sh is None):
            import jax

            from ..parallel.mesh import param_shardings as _derive_param_sh

            self._param_sh = _derive_param_sh(mesh, params)
            self.params = jax.device_put(params, self._param_sh)

    def _make_forward(self, device_normalize: bool = False):
        model = self.model
        loss_tag = self.loss_tag
        compute_dtype = self.compute_dtype

        def forward(params, audio, in_lengths, out_mask, norm_length=None,
                    included=None):
            if device_normalize:
                # raw int16 upload (half the host->device bytes); reference-
                # exact normalization over [0, norm_length) on the device
                # (lib/datautils.py:120-125 semantics, ddof=1)
                x = audio.astype(jnp.float32) / 32768.0
                L = x.shape[1]
                in_norm = (jnp.arange(L)[None, :] < norm_length)
                count = norm_length.astype(jnp.float32)
                mean = jnp.sum(jnp.where(in_norm, x, 0.0), axis=1,
                               keepdims=True) / count
                dev = jnp.where(in_norm, x - mean, 0.0)
                var = jnp.sum(dev * dev, axis=1, keepdims=True) / (count - 1)
                std = jnp.sqrt(var)
                xn = jnp.where(std > 0, dev / jnp.maximum(std, 1e-12), 0.0)
                audio = jnp.where(included[:, None], xn, 0.0)
            if hasattr(model, "greedy_decode"):
                # autoregressive segmenter: KV-cached greedy decode (the
                # reference's inference path is NotImplementedError,
                # lib/evaluate.py:50); probs already p(in-segment)
                probs, logits, _ = model.greedy_decode(
                    params, audio, in_lengths, out_mask.shape[1],
                    compute_dtype=compute_dtype,
                )
                probs = jnp.where(out_mask, probs, 0.0)
                logits_out = jnp.where(out_mask[..., None], logits, 0.0)
                return probs, logits_out
            logits = model.apply(
                params, audio, in_lengths, out_mask,
                deterministic=True, compute_dtype=compute_dtype,
                **self.precision_kwargs,
            )
            if isinstance(logits, tuple):  # SSL variant: (ctc, frame)
                logits = logits[1]
            if loss_tag == "bce":
                probs = jax.nn.sigmoid(logits)
            else:  # 'ce' / 'ssl': p(boundary token id 0)
                probs = jax.nn.softmax(logits, axis=-1)[..., 0]
            if logits.ndim == 2:
                probs = jnp.where(out_mask, probs, 0.0)
                logits_out = jnp.where(out_mask, logits, 0.0)
            else:
                probs = jnp.where(out_mask, probs, 0.0)
                logits_out = jnp.where(out_mask[..., None], logits, 0.0)
            return probs, logits_out

        if self.mesh is not None:
            from ..parallel.mesh import batch_sharding, replicated

            data_sh = batch_sharding(self.mesh)
            rep = replicated(self.mesh)
            p_sh = self._param_sh if self._param_sh is not None else rep
            # multi-host: replicate the (small) outputs so every process
            # can device_get them for stitching; single-host keeps them
            # sharded (no gather needed to read local shards)
            out_sh = data_sh if jax.process_count() == 1 else rep
            if device_normalize:
                return jax.jit(
                    forward,
                    in_shardings=(p_sh, data_sh, data_sh, data_sh, rep, data_sh),
                    out_shardings=(out_sh, out_sh),
                )
            return jax.jit(
                forward,
                in_shardings=(p_sh, data_sh, data_sh, data_sh),
                out_shardings=(out_sh, out_sh),
            )
        return jax.jit(forward)

    def batch_loss(self, batch: Batch, logits) -> float:
        """Masked BCE eval loss of one batch (reference lib/evaluate.py:74-81:
        per-point loss, zeroed at ~out_mask, summed per row, batch mean).
        The mean runs over the batch's REAL rows only — the reference's
        final partial batch has exactly that many rows, so averaging over
        static padding rows (whose loss is zero) would deflate it."""
        import numpy as np

        if self.loss_fn is None or batch.target is None:
            return float("nan")
        lg = np.asarray(logits)
        t = min(lg.shape[1], batch.target.shape[1])
        lpp = np.asarray(self.loss_fn(jnp.asarray(lg[:, :t]),
                                      jnp.asarray(batch.target[:, :t])))
        lpp = np.where(batch.out_mask[:, :t], lpp, 0.0)
        n = batch.n_real or len(lpp)
        return float(lpp.sum(axis=1)[:n].mean())

    def run_batch(self, batch: Batch):
        key = "fwd_norm" if batch.device_normalize else "fwd"
        if key not in self._jitted:
            self._jitted[key] = self._make_forward(batch.device_normalize)
        # ship every array of the batch in ONE device_put call: one transfer
        # call per batch instead of one per array
        arrays = [batch.audio, batch.in_lengths, batch.out_mask]
        if batch.device_normalize:
            arrays += [np.asarray(batch.norm_length, np.int32), batch.included]
        if self.mesh is not None:
            from ..parallel.mesh import batch_sharding, replicated

            sh = batch_sharding(self.mesh)
            shardings = [sh, sh, sh]
            if batch.device_normalize:
                shardings += [replicated(self.mesh), sh]
            arrays = jax.device_put(arrays, shardings)
        else:
            arrays = jax.device_put(arrays)
        return self._jitted[key](self.params, *arrays)


def nan_fill(arr: np.ndarray, duration: int) -> None:
    """Fill frames that never received a prediction with the mean of their
    neighborhood (reference lib/evaluate.py:118-125); in-place.

    For 2-D logits the reference's ``np.nanmean(talk_logits[lo:hi])`` has
    NO axis — a single scalar over the whole [5, vocab] neighborhood, so
    the gap row becomes a constant vector. Replicated exactly (a per-column
    mean would change dac_logits/ce argmax on gap frames)."""
    nan_idx = np.where(np.isnan(arr if arr.ndim == 1 else arr[:, 0]))[0]
    for j in nan_idx:
        lo, hi = max(0, j - 2), min(duration, j + 3)
        arr[j] = np.nanmean(arr[lo:hi])


def dispatch_talk(engine: WindowInference, batches) -> list:
    """Upload + launch every window batch of one talk WITHOUT waiting.

    Returns the list of (device_probs, device_logits, batch) handles for
    :func:`collect_talk`.  Splitting dispatch from collection lets callers
    pipeline across talks: while talk N's results stream back, talk N+1's
    windows are already uploading and computing (cli/common.segment_wavs
    keeps one talk in flight ahead of the one being drained)."""
    pending = []
    for batch in batches:
        probs_d, logits_d = engine.run_batch(batch)
        pending.append((probs_d, logits_d, batch))
    return pending


def infer_talk(
    engine: WindowInference,
    batches,
    duration_outframes: int,
    collect_targets: bool = False,
    return_loss: bool = False,
    need_logits: bool = True,
):
    """Run all window batches of one talk and stitch.

    Returns (talk_probs, talk_logits, talk_targets[, avg_loss]) as numpy
    arrays of length duration_outframes.  With ``need_logits=False`` (the
    pdac/pthr/strm algorithms consume probabilities only) the logits are
    neither downloaded nor stitched — talk_logits comes back zero-filled —
    halving the device->host bytes and round-trips per batch.
    """
    pending = dispatch_talk(engine, batches)
    return collect_talk(engine, pending, duration_outframes,
                        collect_targets=collect_targets,
                        return_loss=return_loss, need_logits=need_logits)


def alloc_talk_arrays(vocab_size, duration_outframes: int):
    """NaN-initialized stitch targets for one talk (probs, logits)."""
    talk_probs = np.full(duration_outframes, np.nan)
    if vocab_size and vocab_size > 1:
        talk_logits = np.full((duration_outframes, vocab_size), np.nan)
    else:
        talk_logits = np.full(duration_outframes, np.nan)
    return talk_probs, talk_logits


def stitch_row(talk_probs, talk_logits, batch, i, probs, logits,
               duration_outframes: int, talk_targets=None) -> None:
    """Scatter one window row into the talk arrays.

    Shared by the per-talk path (collect_talk) and the cross-talk packer
    (packing.PackedSweep.drain_unit) so the parity-sensitive semantics —
    the .5-outframe end clamp and excluded-row zero fill — live in one
    place (reference lib/evaluate.py:100-125, PARITY.md)."""
    start, end = int(batch.starts[i]), int(batch.ends[i])
    # Guard: when the talk length lands exactly on a .5 output frame
    # (e.g. 30.00s -> 1498.5), duration_outframes rounds down (banker's)
    # but the window-end +1e-6 tiebreak rounds up, putting the last grid
    # end 1 past the talk array.  The reference crashes on this input
    # (lib/evaluate.py:104 writes past talk_probs); we clamp (PARITY.md).
    end = min(end, duration_outframes)
    if batch.included[i] and end > start:
        duration = end - start
        talk_probs[start:end] = probs[i, :duration]
        if logits is not None:
            talk_logits[start:end] = logits[i, :duration]
        if talk_targets is not None and batch.target is not None:
            talk_targets[start:end] = batch.target[i, :duration]
    elif not batch.included[i] and end > start:
        talk_probs[start:end] = 0
        talk_logits[start:end] = 0


def finalize_talk_arrays(talk_probs, talk_logits, duration_outframes: int,
                         need_logits: bool):
    """NaN-gap fill; zero the logits when they were never stitched."""
    nan_fill(talk_probs, duration_outframes)
    if need_logits:
        nan_fill(talk_logits, duration_outframes)
    else:
        talk_logits = np.zeros_like(talk_logits)
    return talk_probs, talk_logits


def download_batches(probs_handles: list, logits_handles: list,
                     need_logits: bool):
    """ONE device_get for many batches' outputs: jax.device_get issues
    copy_to_host_async on every leaf before blocking, so all transfers
    overlap instead of waiting once per batch.  Shared by the per-talk
    drain (collect_talk) and the cross-talk packer."""
    if not probs_handles:
        return [], []
    if need_logits:
        return jax.device_get((probs_handles, logits_handles))
    return jax.device_get(probs_handles), [None] * len(probs_handles)


def collect_talk(
    engine: WindowInference,
    pending: list,
    duration_outframes: int,
    collect_targets: bool = False,
    return_loss: bool = False,
    need_logits: bool = True,
):
    """Download + stitch the handles produced by :func:`dispatch_talk`."""
    vocab_size = getattr(engine.model, "vocab_size", 1)
    need_logits = need_logits or (return_loss and engine.loss_fn is not None)
    talk_probs, talk_logits = alloc_talk_arrays(vocab_size, duration_outframes)
    talk_targets = np.zeros(duration_outframes)

    all_losses = []

    all_probs, all_logits = download_batches(
        [p for p, _, _ in pending], [l for _, l, _ in pending], need_logits)

    for (_, _, batch), probs, logits in zip(pending, all_probs, all_logits):
        if return_loss and engine.loss_fn is not None:
            all_losses.append(engine.batch_loss(batch, logits))
        for i in range(len(probs)):
            stitch_row(talk_probs, talk_logits, batch, i, probs,
                       logits if need_logits else None, duration_outframes,
                       talk_targets if collect_targets else None)

    talk_probs, talk_logits = finalize_talk_arrays(
        talk_probs, talk_logits, duration_outframes, need_logits)

    if return_loss:
        avg = float(np.mean(all_losses)) if all_losses else None
        return talk_probs, talk_logits, talk_targets, avg
    return talk_probs, talk_logits, talk_targets
