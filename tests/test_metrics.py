"""Frame metrics in numpy (eval/metrics.binary_metrics) against values
sklearn.metrics gives for the same labels: micro F1 (= accuracy for
binary labels), binary F1, precision and recall, 0.0 where a denominator
is zero."""

import numpy as np
import pytest

from wav2vecsegmenter_tpu.eval.metrics import binary_metrics, train_step_metrics


@pytest.mark.parametrize("targets,preds,want", [
    # (accuracy, f1, precision, recall) from sklearn 1.9
    ([0, 0], [0, 0], (1.0, 0.0, 0.0, 0.0)),
    ([1, 1], [0, 0], (0.0, 0.0, 0.0, 0.0)),
    ([0, 0], [1, 0], (0.5, 0.0, 0.0, 0.0)),
    ([1, 0, 1], [1, 1, 0], (1 / 3, 0.5, 0.5, 0.5)),
    ([1, 1, 0, 1, 0, 0, 1], [1, 0, 0, 1, 1, 0, 1], (5 / 7, 0.75, 0.75, 0.75)),
])
def test_binary_metrics_match_sklearn(targets, preds, want):
    got = binary_metrics(np.asarray(targets, bool), np.asarray(preds, bool))
    np.testing.assert_allclose(
        [got["accuracy"], got["f1"], got["precision"], got["recall"]], want)


def test_train_step_metrics_nan_without_predictions():
    m = train_step_metrics([], [], [1.0, 3.0])
    assert m["loss"] == 2.0 and np.isnan(m["f1"])
