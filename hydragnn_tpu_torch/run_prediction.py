"""``run_prediction`` — the batch evaluator.

Counterpart of ``hydragnn_tpu/run_prediction.py`` for one process and
in-memory samples: the same data prologue, one pass of the shared
:class:`~hydragnn_tpu_torch.serve.predictor.Predictor` over the test split,
and ``(error, per-task losses, true values, predictions)`` with optional
min-max denormalisation.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .config import load_config, update_config
from .preprocess.load_data import dataset_loading_and_splitting
from .serve.predictor import Predictor
from .utils import resolve_device


def run_prediction(config_source, model, samples: Sequence | None = None, device="cuda"):
    """Evaluate ``model`` (a ``HydraModel`` holding its weights, or the
    ``TrainState`` that ``run_training`` returns) on the test split of
    ``samples``. Runs on ``device`` (the card by default)."""
    device = resolve_device(device)
    model = getattr(model, "model", model)
    config = load_config(config_source)
    train_loader, val_loader, test_loader = dataset_loading_and_splitting(
        config, samples=samples
    )
    config = update_config(config, train_loader.samples, val_loader.samples,
                           test_loader.samples)
    predictor = Predictor(model, config, device=device)

    trues = [[] for _ in predictor.cols]
    preds = [[] for _ in predictor.cols]
    for batch in test_loader:
        bt, bp = predictor.gather(batch)
        for ihead in range(len(predictor.cols)):
            trues[ihead].append(bt[ihead])
            preds[ihead].append(bp[ihead])
    true_values = [np.concatenate(t) for t in trues]
    predicted_values = [np.concatenate(p) for p in preds]

    tasks_loss = [float(np.mean((t - p) ** 2)) for t, p in zip(true_values, predicted_values)]
    error = float(sum(w * l for w, l in zip(model.spec.task_weights, tasks_loss)))
    true_values, predicted_values = predictor.denormalize(true_values, predicted_values)
    return error, tasks_loss, true_values, predicted_values


__all__ = ["run_prediction"]
