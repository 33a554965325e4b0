"""The serving hand-off of the port against the JAX package on the CPU:
interatomic potentials (MLIPs) behind ``Predictor``, ``PredictionServer``
and ``run_prediction``, and ``PredictionServer.add_model_from_checkpoint``.

The MLIPs: the EGNN of ``tests/test_torch_mlip.py`` (graph and node head)
and the PAINN and MACE of ``tests/test_torch_geometric_mlip.py`` (node
head), 3 conv layers at hidden 16, their JAX parameters (jittered) loaded
with ``convert.load_jax_variables``, on four 8-atom Lennard-Jones cells.
The JAX ``Predictor`` serves an MLIP's head outputs, no forces
(``hydragnn_tpu/serve/predictor.py``); so does the port's.

Tolerances: the port's head outputs within 1e-5 of each head's largest
|output| of the JAX package's (fp32; XLA and PyTorch sum in other orders
through three layers, measured at most 1e-6 of it); a served answer equals
``Predictor.outputs`` of the same padded batch bit for bit; a model
registered from its checkpoint answers bit-equal to the live registration.
"""

import copy
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_mlip as egnn_mlip
import torch_port_util as tpu
from hydragnn_tpu.config import update_config as jax_update_config
from hydragnn_tpu.datasets import deterministic_graph_data
from hydragnn_tpu.datasets.lennard_jones import lennard_jones_data
from hydragnn_tpu.graphs.batching import collate as jax_collate
from hydragnn_tpu.graphs.batching import compute_pad_spec as jax_pad_spec
from hydragnn_tpu.models import create_model_config as jax_create_model_config
from hydragnn_tpu.models import init_model
from hydragnn_tpu.preprocess import apply_variables_of_interest
from hydragnn_tpu.run_prediction import run_prediction as jax_run_prediction
from hydragnn_tpu.serve.predictor import Predictor as JaxPredictor
from hydragnn_tpu.train.step import TrainState as JaxTrainState
from hydragnn_tpu_torch import run_prediction, run_training
from hydragnn_tpu_torch.config.schema import get_log_name_config, save_config
from hydragnn_tpu_torch.convert import batch_from_numpy
from hydragnn_tpu_torch.serve import PredictionServer, Predictor, ServingConfig
from hydragnn_tpu_torch.serve.batcher import serving_collate
from hydragnn_tpu_torch.train import create_train_state
from hydragnn_tpu_torch.train.checkpoint import checkpoint_dir, save_checkpoint
from test_config import CI_CONFIG

REL = 1e-5  # of the head's largest |output|
ARCHS = {"EGNN": {}, "PAINN": {"num_radial": 6},
         "MACE": {"num_radial": 6, "max_ell": 2, "node_max_ell": 1, "correlation": 2}}
CASES = [("EGNN", "graph"), ("EGNN", "node"), ("PAINN", "node"), ("MACE", "node")]


class MlipSetup:
    """Both packages' MLIP of ``arch`` (3 layers) from one jittered JAX
    init, the LJ samples of both, and a padded batch of four cells."""

    def __init__(self, arch: str, head: str):
        from hydragnn_tpu_torch.config import update_config

        cfg = egnn_mlip._config(head)
        cfg["NeuralNetwork"]["Architecture"].update(mpnn_type=arch, **ARCHS[arch])
        self.cfg = cfg
        self.jsamples = apply_variables_of_interest(
            lennard_jones_data(number_configurations=8, cells_per_dim=2, seed=3), cfg)
        self.samples = tpu.port_samples(self.jsamples)
        self.jaug = jax_update_config(copy.deepcopy(cfg), self.jsamples)
        self.aug = update_config(copy.deepcopy(cfg), tpu.port_samples(self.jsamples))
        self.jmodel = jax_create_model_config(self.jaug)
        self.nb = jax_collate(self.jsamples[:4], jax_pad_spec(self.jsamples, 4))
        self.variables = tpu.jitter_params(init_model(self.jmodel, self.nb), seed=1, scale=0.2)
        self.jstate = JaxTrainState(params=self.variables["params"],
                                    batch_stats=self.variables.get("batch_stats", {}),
                                    opt_state=None, step=jnp.zeros((), jnp.int32))
        self.model = tpu.port_model_from_jax(self.aug, self.variables)
        assert self.model.spec.enable_interatomic_potential


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def mlip(request):
    return MlipSetup(*request.param)


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= REL * scale, f"{what}: max|diff| {err:.3e} > {REL} x {scale:.3e}"


def test_mlip_head_outputs_match_jax_predictor(mlip):
    """``Predictor.outputs`` of the port against the JAX ``Predictor``'s on
    the same padded batch: every head (padded rows included), fp32."""
    want = JaxPredictor(mlip.jmodel, mlip.jstate, mlip.jaug).outputs(
        jax.tree.map(jnp.asarray, mlip.nb))
    pred = Predictor(mlip.model, mlip.aug, device="cpu")
    got = pred.outputs(batch_from_numpy(mlip.nb))
    assert len(got) == len(want) == 1
    for ihead, (g, w) in enumerate(zip(got, want)):
        assert g.shape == tuple(w.shape) and g.dtype == torch.float32
        assert torch.isfinite(g).all()
        _close(g.numpy(), w, f"head {ihead}")


def test_mlip_predict_step_takes_no_position_gradient(mlip):
    """The served forward runs under ``torch.inference_mode``: nothing in it
    requires a gradient, and the batch's positions stay a plain tensor."""
    pred = Predictor(mlip.model, mlip.aug, device="cpu")
    batch = batch_from_numpy(mlip.nb)
    out = pred.outputs(batch)
    assert all(t.is_inference() and not t.requires_grad for t in out)
    assert not batch.pos.requires_grad


def test_mlip_endpoint_serves_its_predict_step(mlip):
    """An MLIP endpoint behind ``PredictionServer`` answers each request
    with ``Predictor.outputs`` of its served padded batch, bit for bit, and
    within ``REL`` of the JAX ``Predictor`` on that batch."""
    server = PredictionServer(ServingConfig(flush_ms=50.0), device="cpu")
    ep = server.add_model("mlip", mlip.model, mlip.aug, samples=mlip.samples, batch_size=4)
    server.warmup()
    server.start()
    try:
        results = [f.result(timeout=60) for f in
                   [server.submit("mlip", s) for s in mlip.samples]]
    finally:
        server.stop()
    jpred = JaxPredictor(mlip.jmodel, mlip.jstate, mlip.jaug)
    by_batch = {}
    for i, r in enumerate(results):
        by_batch.setdefault(r["batch"], []).append((r["slot"], i, r))
    for members in by_batch.values():
        members.sort(key=lambda m: m[0])
        pad = next(b for b in ep.buckets if b.as_tuple() == tuple(members[0][2]["bucket"]))
        idx = [i for _, i, _ in members]
        batch = serving_collate([mlip.samples[i] for i in idx], pad)
        want = ep.predictor.split_graphs(ep.predictor.outputs(batch),
                                         [mlip.samples[i].num_nodes for i in idx])
        jout = jpred.outputs(jax.tree.map(jnp.asarray, jax_collate(
            [mlip.jsamples[i] for i in idx], pad)))
        jwant = ep.predictor.split_graphs([torch.from_numpy(np.array(o)) for o in jout],
                                          [mlip.samples[i].num_nodes for i in idx])
        for (_, _, r), heads, jheads in zip(members, want, jwant):
            for a, b, c in zip(r["heads"], heads, jheads):
                assert np.array_equal(a, b)
                _close(a, c, "served vs the JAX Predictor")


def test_mlip_run_prediction_matches_jax(mlip):
    """``run_prediction`` on an MLIP config: the same test split, per-head
    predictions within ``REL`` of the JAX package's, the same targets."""
    err, tasks, trues, preds = run_prediction(copy.deepcopy(mlip.cfg), mlip.model,
                                              samples=tpu.port_samples(mlip.jsamples),
                                              device="cpu")
    jerr, jtasks, jtrues, jpreds = jax_run_prediction(
        copy.deepcopy(mlip.cfg), mlip.jstate, model=mlip.jmodel,
        samples=tpu.jax_samples_copy(mlip.jsamples))
    assert np.isfinite(err) and len(preds) == len(jpreds) == 1
    for t, jt, p, jp in zip(trues, jtrues, preds, jpreds):
        np.testing.assert_array_equal(t, np.asarray(jt))
        _close(p, jp, "run_prediction")


# -- registration from a checkpoint -------------------------------------------------


def _served(server, name, samples):
    return [[np.asarray(h) for h in f.result(timeout=60)["heads"]]
            for f in [server.submit(name, s) for s in samples]]


@pytest.fixture(scope="module")
def trained_gin(tmp_path_factory):
    """The CI GIN trained 2 epochs on the CPU by ``run_training`` (which
    writes ``config.json`` and a checkpoint per saved epoch)."""
    path = str(tmp_path_factory.mktemp("logs"))
    cfg = copy.deepcopy(CI_CONFIG)
    cfg["NeuralNetwork"]["Training"]["num_epoch"] = 2
    samples = tpu.port_samples(deterministic_graph_data(number_configurations=40, seed=7))
    state, model, aug = run_training(copy.deepcopy(cfg), samples=samples, device="cpu",
                                     path=path)
    return {"path": path, "log_name": get_log_name_config(aug), "model": model, "aug": aug,
            "samples": samples}


def test_checkpoint_registration_answers_bit_equal_to_live(trained_gin):
    """``add_model_from_checkpoint`` (the ``config.json`` and newest
    checkpoint ``run_training`` wrote) beside ``add_model`` of the live
    trained model in one server: the same buckets and bit-equal answers."""
    t = trained_gin
    server = PredictionServer(ServingConfig(flush_ms=2.0), device="cpu")
    live = server.add_model("live", t["model"], t["aug"], samples=t["samples"], batch_size=8)
    ckpt = server.add_model_from_checkpoint("ckpt", t["log_name"], path=t["path"],
                                            samples=t["samples"], batch_size=8)
    assert [b.as_tuple() for b in live.buckets] == [b.as_tuple() for b in ckpt.buckets]
    assert ckpt.predictor.device == server.device
    for (k, a), (_, b) in zip(t["model"].state_dict().items(),
                              ckpt.predictor.model.state_dict().items()):
        assert torch.equal(a, b), k
    server.warmup()
    server.start()
    try:
        probe = t["samples"][:12]
        for a, b in zip(_served(server, "live", probe), _served(server, "ckpt", probe)):
            for x, y in zip(a, b):
                assert np.array_equal(x, y)
    finally:
        server.stop()


def test_checkpoint_registration_epochs_and_fallback(trained_gin, tmp_path):
    """A pinned ``epoch`` reads exactly that checkpoint; without one a
    corrupt newest checkpoint falls back to an older one with a warning;
    an empty run directory raises ``FileNotFoundError`` naming it; no
    samples is a ``ValueError``."""
    import shutil

    t = trained_gin
    run = tmp_path / "logs"
    shutil.copytree(t["path"], run)
    base = checkpoint_dir(t["log_name"], str(run))
    server = PredictionServer(ServingConfig(), device="cpu")
    # epoch 0: the pre-training weights, unlike the final ones
    model0 = copy.deepcopy(t["model"])
    with torch.no_grad():
        for p in model0.parameters():
            p.add_(1.0)
    save_checkpoint(create_train_state(model0, t["aug"]["NeuralNetwork"]["Training"]
                                       ["Optimizer"]), t["log_name"], epoch=0, path=str(run))
    ep0 = server.add_model_from_checkpoint("e0", t["log_name"], path=str(run),
                                           samples=t["samples"], epoch=0)
    for a, b in zip(model0.parameters(), ep0.predictor.model.parameters()):
        assert torch.equal(a, b)
    newest = os.path.realpath(os.path.join(base, "latest"))
    with open(newest, "r+b") as f:
        f.seek(200)
        f.write(b"\x00" * 64)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fb = server.add_model_from_checkpoint("fb", t["log_name"], path=str(run),
                                              samples=t["samples"])
    assert any("fallback" in str(w.message) for w in rec)
    older = max(int(n[len("epoch_"):-len(".pt")]) for n in os.listdir(base)
                if n.startswith("epoch_") and n.endswith(".pt")
                and os.path.join(base, n) != newest)
    pinned = server.add_model_from_checkpoint("older", t["log_name"], path=str(run),
                                              samples=t["samples"], epoch=older)
    for a, b in zip(pinned.predictor.model.parameters(), fb.predictor.model.parameters()):
        assert torch.equal(a, b)
    empty = tmp_path / "empty"
    save_config(t["aug"], t["log_name"], path=str(empty))
    with pytest.raises(FileNotFoundError, match="no loadable checkpoint"):
        server.add_model_from_checkpoint("none", t["log_name"], path=str(empty),
                                         samples=t["samples"])
    with pytest.raises(ValueError, match="samples"):
        server.add_model_from_checkpoint("x", t["log_name"], path=str(run), samples=[])


def test_mlip_checkpoint_registration_answers_bit_equal_to_live(tmp_path):
    """An MLIP (the EGNN, node head) saved as a training run saves it and
    registered from its checkpoint answers bit-equal to the live model."""
    m = MlipSetup("EGNN", "node")
    log_name = "mlip_ckpt"
    path = str(tmp_path)
    save_config(m.aug, log_name, path=path)
    save_checkpoint(create_train_state(copy.deepcopy(m.model), m.aug["NeuralNetwork"]
                                       ["Training"]["Optimizer"]), log_name, epoch=3, path=path)
    server = PredictionServer(ServingConfig(flush_ms=2.0), device="cpu")
    server.add_model("live", m.model, m.aug, samples=m.samples, batch_size=4)
    server.add_model_from_checkpoint("ckpt", log_name, path=path, samples=m.samples,
                                     batch_size=4)
    server.warmup()
    server.start()
    try:
        for a, b in zip(_served(server, "live", m.samples), _served(server, "ckpt", m.samples)):
            for x, y in zip(a, b):
                assert np.array_equal(x, y)
    finally:
        server.stop()
