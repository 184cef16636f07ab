"""Frame-level evaluation: dev-set micro/binary F1, precision, recall.

Replicates reference lib/evaluate.py:130-214 — per talk, average probs over
``inference_times`` shifted window grids, threshold, accumulate preds/targets
over all talks, then binary metrics (sklearn semantics, in numpy) rounded
to 4 decimals.  ``eval_f1`` is
the best-checkpoint selection metric (reference conf/train.yaml:16-17).
"""

from __future__ import annotations

import numpy as np

from ..infer.pipeline import WindowInference, collect_talk, dispatch_talk


def binary_metrics(targets, preds) -> dict[str, float]:
    """Accuracy (= sklearn's micro F1 for binary labels), binary F1,
    precision and recall of bool arrays; a ratio whose denominator is zero
    is 0.0, as sklearn's zero_division default reports it."""
    t = np.asarray(targets, bool)
    p = np.asarray(preds, bool)
    tp = int(np.sum(t & p))
    fp = int(np.sum(~t & p))
    fn = int(np.sum(t & ~p))

    def ratio(num, den):
        return num / den if den else 0.0

    return {
        "accuracy": ratio(int(np.sum(t == p)), t.size),
        "f1": ratio(2 * tp, 2 * tp + fp + fn),
        "precision": ratio(tp, tp + fp),
        "recall": ratio(tp, tp + fn),
    }


def evaluate(
    dataloader_generator,
    engine: WindowInference,
    loss_tag: str = "bce",
    vocab=None,
) -> dict[str, float]:
    all_preds = np.array([], dtype=bool)
    all_targets = np.array([])
    all_losses: list[float] = []

    talk_ids = dataloader_generator.get_talk_ids()
    inference_times = dataloader_generator.dataset.inference_times

    def dispatch_one(talk_id):
        """Upload + launch all passes of one talk; duration_outframes is
        captured NOW (the generator mutates its dataset per talk)."""
        passes = []
        for iteration in range(inference_times):
            batches = dataloader_generator.generate(talk_id, iteration)
            passes.append(dispatch_talk(engine, batches))
        return passes, dataloader_generator.dataset.duration_outframes

    # one-talk lookahead: talk N+1's windows upload + forward while talk
    # N's probabilities stream back (same pattern as cli/common.segment_wavs)
    handles = []
    talk_iter = iter(talk_ids)
    nxt = next(talk_iter, None)
    if nxt is not None:
        handles.append(dispatch_one(nxt))
    while handles:
        nxt = next(talk_iter, None)
        if nxt is not None:
            handles.append(dispatch_one(nxt))
        passes, duration_outframes = handles.pop(0)
        probs = logits = targets = None
        for pending in passes:
            p, l, t, loss = collect_talk(
                engine, pending, duration_outframes,
                collect_targets=True,
                return_loss=True,
            )
            if loss is not None:
                all_losses.append(loss)
            if probs is None:
                probs, logits, targets = p, l, t
            else:
                probs += p
                logits += l
        probs /= inference_times

        if loss_tag == "bce":
            # NOTE: the reference divides by inference_times a second time
            # here (lib/evaluate.py:185) — with the default inference_times=1
            # this is a no-op; replicated for metric parity.
            preds = probs / inference_times > 0.5
        elif loss_tag in ("ce", "ssl", "ctc"):
            # ctc reuses the ssl frame metrics: the SFC head emits the same
            # multi-class frame logits; under a pure-CTC loss it is untrained
            # (the metric then tracks the backbone adaptation only)
            preds = np.argmax(logits, axis=-1) == vocab.boundary_token_id
            spe_mask = targets != vocab.pad_token_id
            targets = targets * spe_mask
        else:
            raise NotImplementedError(loss_tag)

        all_preds = np.append(all_preds, preds)
        all_targets = np.append(all_targets, targets)

    if hasattr(dataloader_generator.dataset, "release_cache"):
        # the eval dataset outlives this call (train loop reuses it every
        # eval); don't pin the last talks' decoded audio until the next one
        dataloader_generator.dataset.release_cache()

    all_targets = all_targets.astype(bool)
    all_preds = all_preds.astype(bool)
    results_loss = (
        {"eval_loss": float(np.mean(all_losses))} if all_losses else {}
    )
    m = binary_metrics(all_targets, all_preds)
    return {
        **results_loss,
        **{f"eval_{k}": round(v, 4) for k, v in m.items()},
    }


def train_step_metrics(all_targets, all_preds, all_losses) -> dict:
    """Running train metrics printed every print_every_steps
    (reference train.py:508-527).  With no accumulated predictions (multi-
    host runs keep logits device-sharded and skip frame accumulation) the
    frame metrics report nan."""
    loss = float(np.mean(all_losses)) if all_losses else float("nan")
    if len(all_preds) == 0:
        nan = float("nan")
        return {"loss": loss, "accuracy": nan, "f1": nan,
                "precision": nan, "recall": nan}
    return {"loss": loss, **binary_metrics(all_targets, all_preds)}
