"""Shared prediction core: predict step, per-head gather, denormalise.

Counterpart of ``hydragnn_tpu/serve/predictor.py``: the one implementation
of "turn a model and a padded batch into per-head predictions", run by both
the batch evaluator (``run_prediction``) and the server, so a served answer
is bit-identical to what the evaluator reports for the same padded batch.
"""

from __future__ import annotations

import numpy as np
import torch

from ..capture import Dispatch
from ..models.base import head_columns
from ..train.step import head_means, make_predict_step, resolve_precision
from ..utils import resolve_device


class Predictor:
    """A model (on ``device``) bound to its augmented config.

    - :meth:`outputs` — run the eager predict step (or a given one, such
      as the int8 step of ``serve.quant``) on one padded batch: the
      comparator of the captured answers;
    - :meth:`answer` — the same answer as the server and ``run_prediction``
      give it: on the card a replay of the step's CUDA graph for the
      batch's bucket (``capture.py``; :attr:`dispatches` per step), on the
      CPU :meth:`outputs`;
    - :meth:`gather` — per-head (true, pred) numpy arrays of the real rows;
    - :meth:`split_graphs` — per-graph views of a batch's outputs;
    - :meth:`denormalize` / :meth:`denormalize_preds` — min-max
      denormalisation when the config asks for it.

    An interatomic potential (``enable_interatomic_potential``) is served
    as the JAX ``Predictor`` serves it: its head outputs from the eval-mode
    forward under ``torch.inference_mode``, no forces (the position
    gradient is the train and MD steps' business, ``models.mlip``).
    """

    def __init__(self, model: torch.nn.Module, config: dict, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.spec = model.spec
        self.voi = config["NeuralNetwork"]["Variables_of_interest"]
        self.compute_dtype = resolve_precision(
            config["NeuralNetwork"]["Training"].get("precision", "fp32"), self.device
        )
        self.predict_step = make_predict_step(self.model, self.compute_dtype)
        self.cols = head_columns(self.spec)
        self._scales = None
        # step -> its Dispatch (the fp32 step, one int8 step per bucket)
        self.dispatches: dict = {}
        self.ledger_model = "predict"  # the cost ledger's model key (the endpoint's name)

    def outputs(self, batch, step=None) -> list[torch.Tensor]:
        """Per-head fp32 predictions for one padded batch (still padded;
        callers mask), on the model's device; a ``var_output`` model's
        variances are dropped. ``step`` replaces the fp32 predict step (the
        serving tier passes its int8 step here)."""
        if batch.device != self.device:
            batch = batch.to(self.device)
        return head_means(self.model, (step or self.predict_step)(batch))

    def dispatch(self, step=None):
        """The :class:`~hydragnn_tpu_torch.capture.Dispatch` of ``step``
        (default: the fp32 predict step), made at first use."""
        step = step or self.predict_step
        d = self.dispatches.get(step)
        if d is None:
            fp32 = step is self.predict_step
            name = "predict" if fp32 else "predict int8"
            ledger = {"model": self.ledger_model, "kind": "predict" if fp32 else "quant_predict",
                      "precision": str(self.compute_dtype) if fp32 else "int8"}
            d = self.dispatches[step] = Dispatch(
                lambda _state, batch: head_means(self.model, step(batch)), name,
                device=self.device, ledger=ledger)
        return d

    def answer(self, batch, step=None) -> list[torch.Tensor]:
        """:meth:`outputs` as served: on the card a replay of the step's
        graph for the batch's bucket (a host batch is copied straight into
        the graph's inputs), captured at the bucket's first batch; on the
        CPU the eager step."""
        if self.device.type != "cuda":
            return self.outputs(batch, step)
        return self.dispatch(step)(None, batch)

    def captures(self) -> int:
        """Graphs this predictor captured, over all its steps."""
        return sum(d.graphs.captures for d in list(self.dispatches.values()))

    def gather(self, batch, out=None):
        """(trues, preds): per-head numpy arrays of the REAL rows of
        ``batch`` — graph heads masked by ``graph_mask``, node heads by
        ``node_mask``; ``out`` defaults to :meth:`answer`."""
        if out is None:
            out = self.answer(batch)
        trues, preds = [], []
        graph_mask = batch.graph_mask.cpu().numpy() > 0
        node_mask = batch.node_mask.cpu().numpy() > 0
        for ihead, (kind, col, dim) in enumerate(self.cols):
            if kind == "graph":
                mask, target = graph_mask, batch.graph_y
            else:
                mask, target = node_mask, batch.node_y
            trues.append(target[:, col : col + dim].cpu().numpy()[mask])
            preds.append(out[ihead].cpu().numpy()[mask])
        return trues, preds

    def split_graphs(self, out, node_counts):
        """Per-graph results, in collate order: graph heads give the
        ``[dim]`` row of the graph, node heads the ``[n_i, dim]`` rows of its
        nodes (numpy)."""
        results = [[] for _ in node_counts]
        offsets = np.concatenate([[0], np.cumsum(node_counts)]).astype(np.int64)
        for ihead, (kind, _col, _dim) in enumerate(self.cols):
            arr = out[ihead].cpu().numpy()
            for g in range(len(node_counts)):
                if kind == "graph":
                    results[g].append(arr[g])
                else:
                    results[g].append(arr[offsets[g] : offsets[g + 1]])
        return results

    def denormalize(self, trues, preds):
        if not self.voi.get("denormalize_output"):
            return trues, preds
        from ..postprocess.postprocess import output_denormalize

        return output_denormalize(self.voi, trues, preds, self.spec)

    def denormalize_preds(self, preds):
        """Preds-only denormalisation for the serving path (scales cached)."""
        if not self.voi.get("denormalize_output"):
            return preds
        if self._scales is None:
            from ..postprocess.postprocess import head_scales

            self._scales = head_scales(self.voi, self.spec)
        return [p * rng + lo for p, (lo, rng) in zip(preds, self._scales)]


__all__ = ["Predictor"]
