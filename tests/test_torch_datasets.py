"""The port's raw readers, packed store and loaders against the JAX
package's, on the CPU, on files both packages read: the committed
fixtures (``tests/fixtures/qm9_sample.xyz``, ``s2ef_sample.extxyz``) and
files the tests write from a numpy seed. Readers and the packed format are
numpy on both sides, so every sample must be equal field by field (dtype
included) and every packed file byte for byte; loaders must give the same
batches; training from files tracks the JAX package's losses at the
tolerances of ``tests/test_torch_train_loop.py``.
"""

import copy
import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
import hydragnn_tpu.datasets as jd
import hydragnn_tpu_torch.datasets as pd
import torch_port_util as tpu
from hydragnn_tpu.datasets import packed as jpk
from hydragnn_tpu.graphs import batching as jb
from hydragnn_tpu.graphs.graph import GraphSample as JaxSample
from hydragnn_tpu.graphs.radius import build_radius_graph as jax_build_radius_graph
from hydragnn_tpu.preprocess.load_data import dataset_loading_and_splitting as jax_loading
from hydragnn_tpu_torch.datasets import packed as ppk
from hydragnn_tpu_torch.graphs import batching as pb
from hydragnn_tpu_torch.graphs.graph import FIELDS
from hydragnn_tpu_torch.graphs.graph import GraphSample as PortSample
from hydragnn_tpu_torch.graphs.radius import build_radius_graph as port_build_radius_graph
from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting as port_loading
from test_config import CI_CONFIG

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
# the 3-epoch trajectory's tolerances (tests/test_torch_train_loop.py)
TRAIN_RTOL, EVAL_RTOL = 1e-4, 6e-2

MULTI_FRAME_XYZ = (
    "3\n"
    'energy=-1.5 Lattice="10 0 0 0 10 0 0 0 10"\n'
    "O 0.0 0.0 0.0 0.1 0.0 0.0\n"
    "H 0.96 0.0 0.0 -0.05 0.0 0.0\n"
    "H -0.24 0.93 0.0 -0.05 0.0 0.0\n"
    "2\n"
    "energy=0.5\n"
    "C 0.0 0.0 0.0\n"
    "O 1.2 0.0 0.0\n"
    "2\n"
    'Properties=species:S:1:pos:R:3:charge:R:1:forces:R:3 energy=1.0\n'
    "H 0 0 0 0.3 1 2 3\n"
    "H 1 0 0 0.4 4 5 6\n"
    "2\n"
    "energy=1.0\n"
    "H 0 0 0 9 9 9\n"
    "H 1 0 0\n"
)
CFG_FILE = (
    "Number of particles = 3\n"
    "A = 2.0 Angstrom (basic length-scale)\n"
    "H0(1,1) = 3.0 A\nH0(1,2) = 0.1 A\nH0(1,3) = 0.0 A\n"
    "H0(2,1) = 0.0 A\nH0(2,2) = 3.0 A\nH0(2,3) = 0.0 A\n"
    "H0(3,1) = 0.0 A\nH0(3,2) = 0.0 A\nH0(3,3) = 3.5 A\n"
    ".NO_VELOCITY.\n"
    "entry_count = 3\n"
    "55.845\nFe\n0.0 0.0 0.0\n0.5 0.5 0.5\n"
    "195.08\nPt\n0.25 0.75 0.5\n"
)
LEGACY_CFG_FILE = (
    "Number of particles = 2\n"
    "A = 1.0 Angstrom\n"
    "H0(1,1) = 4.0 A\nH0(2,2) = 4.0 A\nH0(3,3) = 4.0 A\n"
    "63.546 Cu 0.1 0.2 0.3\n"
    "63.546 Cu 0.6 0.7 0.8\n"
)


def _write_lsms_dir(directory, samples):
    os.makedirs(directory, exist_ok=True)
    for i, s in enumerate(samples):
        pd.write_lsms_file(os.path.join(directory, f"output{i:03d}.txt"),
                           s.extras["graph_table"], s.extras["node_table"], s.pos)
    return str(directory)


def _ani1x_fixture(path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(3)
    with h5py.File(path, "w") as f:
        for name, z in (("CH4", [6, 1, 1, 1, 1]), ("H2O", [8, 1, 1])):
            g = f.create_group(name)
            nc, na = 4, len(z)
            g["atomic_numbers"] = np.asarray(z)
            g["coordinates"] = rng.normal(size=(nc, na, 3))
            e = rng.normal(size=nc)
            e[1] = np.nan  # dropped, as the reference drops it
            g["wb97x_dz.energy"] = e
            g["wb97x_dz.forces"] = rng.normal(size=(nc, na, 3))


def _qm7x_fixture(path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(4)
    with h5py.File(path, "w") as f:
        for m in ("1", "2"):
            mol = f.create_group(m)
            for c in ("a", "b", "c"):
                conf = mol.create_group(f"{m}-{c}")
                conf["atNUM"] = np.array([6, 1, 1, 8])
                conf["atXYZ"] = rng.normal(size=(4, 3))
                conf["ePBE0+MBD"] = np.array([rng.normal()])
                conf["totFOR"] = rng.normal(size=(4, 3))


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


# each case: (port reader call, JAX reader call) on the files it writes
def _reader_case(name, tmp):
    bcc = pd.deterministic_graph_data(number_configurations=6, seed=31)
    if name == "lsms":
        d = _write_lsms_dir(tmp / "lsms", bcc)
        return (lambda: pd.load_lsms_dir(d)), (lambda: jd.load_lsms_dir(d))
    if name == "lsms_charge_density":
        d = _write_lsms_dir(tmp / "lsms", bcc)
        return ((lambda: pd.load_lsms_dir(d, charge_density_update=True)),
                (lambda: jd.load_lsms_dir(d, charge_density_update=True)))
    if name in ("qm9_fixture", "s2ef_fixture"):
        path = os.path.join(FIXTURES, {"qm9_fixture": "qm9_sample.xyz",
                                       "s2ef_fixture": "s2ef_sample.extxyz"}[name])
        return (lambda: pd.read_xyz_file(path)), (lambda: jd.read_xyz_file(path))
    if name == "qm9_dir":
        d = tmp / "qm9"
        cs.write_qm9_xyz_dir(d, 6, seed=5)
        return (lambda: pd.load_xyz_dir(str(d), limit=5)), (lambda: jd.load_xyz_dir(str(d),
                                                                                    limit=5))
    if name == "xyz_frames":
        path = _write(tmp / "frames.xyz", MULTI_FRAME_XYZ)
        return (lambda: pd.read_xyz_file(path)), (lambda: jd.read_xyz_file(path))
    if name == "cfg":
        d = tmp / "cfg"
        d.mkdir()
        _write(d / "a.cfg", CFG_FILE)
        _write(d / "a.bulk", "170.5\n")
        _write(d / "b.cfg", LEGACY_CFG_FILE)
        return (lambda: pd.load_cfg_dir(str(d))), (lambda: jd.load_cfg_dir(str(d)))
    if name in ("hdf5_ani1x", "hdf5_qm7x"):
        path = str(tmp / "corpus.h5")
        (_ani1x_fixture if name == "hdf5_ani1x" else _qm7x_fixture)(path)
        from hydragnn_tpu.datasets.hdf5 import read_hdf5 as jax_read
        from hydragnn_tpu_torch.datasets.hdf5 import read_hdf5 as port_read

        return (lambda: port_read(path)), (lambda: jax_read(path))
    raise KeyError(name)


READER_CASES = ("lsms", "lsms_charge_density", "qm9_fixture", "s2ef_fixture", "qm9_dir",
                "xyz_frames", "cfg", "hdf5_ani1x", "hdf5_qm7x")


@pytest.mark.parametrize("name", READER_CASES)
def test_reader_matches_jax(name, tmp_path):
    """Each reader gives the JAX reader's samples on the same files, field
    by field and in the extras tables."""
    port_read, jax_read = _reader_case(name, tmp_path)
    got, want = port_read(), jax_read()
    assert len(got) > 0
    assert all(isinstance(s, PortSample) for s in got)
    tpu.assert_samples_equal(got, want, name)


def test_qm9_written_files_read_back_at_the_printed_precision(tmp_path):
    """``chip_smoke.write_qm9_xyz_dir``'s molecules read back as written: the
    atomic numbers, the positions (float32 of the printed values) and all 15
    properties (float64, ``*^`` exponents included); ``energy_y`` is U0."""
    from hydragnn_tpu_torch.datasets.xyz import _QM9_PROPS

    written = cs.write_qm9_xyz_dir(tmp_path, 8, seed=2)
    text = (tmp_path / "dsgdb9nsd_000001.xyz").read_text()
    assert "*^" in text and text.splitlines()[1].startswith("gdb 1\t")
    got = pd.load_xyz_dir(str(tmp_path))
    u0 = _QM9_PROPS.index("U0")
    for s, w in zip(got, written, strict=True):
        np.testing.assert_array_equal(s.x[:, 0], w["z"])
        np.testing.assert_array_equal(s.pos, w["pos"].astype(np.float32))
        np.testing.assert_array_equal(s.extras["graph_table"], w["props"])
        assert s.energy_y[0] == np.float32(w["props"][u0])
        assert not np.any(s.forces_y)  # the Mulliken column is not forces


def test_lsms_writer_bytes_equal_jax(tmp_path):
    s = pd.deterministic_graph_data(number_configurations=2, seed=3)[1]
    args = (s.extras["graph_table"], s.extras["node_table"], s.pos)
    pd.write_lsms_file(str(tmp_path / "p.txt"), *args)
    jd.write_lsms_file(str(tmp_path / "j.txt"), *args)
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


def test_pickle_dataset_round_trip_matches_jax(tmp_path):
    """Each package's pickle dataset (its own ``GraphSample`` class in the
    files) reads back the samples it wrote; the two read the same values."""
    raw = jd.deterministic_graph_data(number_configurations=5, seed=9)
    pd.SimplePickleWriter(tpu.port_samples(raw), str(tmp_path / "p"), "total",
                          use_subdir=True, attrs={"minmax": [0, 1]})
    jd.SimplePickleWriter(raw, str(tmp_path / "j"), "total", use_subdir=True,
                          attrs={"minmax": [0, 1]})
    got = pd.SimplePickleDataset(str(tmp_path / "p"), "total")
    want = jd.SimplePickleDataset(str(tmp_path / "j"), "total")
    assert len(got) == len(want) == 5 and got.attrs == want.attrs == {"minmax": [0, 1]}
    assert all(isinstance(s, PortSample) for s in got.load_all())
    tpu.assert_samples_equal(got.load_all(), want.load_all(), "pickle")


def _rich_arrays(n: int, seed: int) -> list[dict]:
    """Sample fields exercising every packed key: edge features, graph
    attributes, node and graph targets, forces, dataset ids, both tables."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        na = int(rng.integers(3, 9))
        ne = int(rng.integers(1, 3 * na))
        out.append(dict(
            x=rng.normal(size=(na, 2)), pos=rng.uniform(0, 4, size=(na, 3)),
            senders=rng.integers(0, na, ne), receivers=rng.integers(0, na, ne),
            edge_attr=rng.normal(size=(ne, 2)), edge_shifts=rng.normal(size=(ne, 3)),
            graph_attr=rng.normal(size=2), graph_y=rng.normal(size=3),
            node_y=rng.normal(size=(na, 2)), energy_y=rng.normal(size=1),
            forces_y=rng.normal(size=(na, 3)), dataset_id=i % 3,
            extras={"node_table": rng.normal(size=(na, 3)),
                    "graph_table": rng.normal(size=4)}))
    return out


def _packed_case(name):
    """(port samples, JAX samples) of one packed-file case, built from the
    same arrays in each package."""
    if name == "bcc":
        return (pd.deterministic_graph_data(number_configurations=10, seed=2),
                jd.deterministic_graph_data(number_configurations=10, seed=2))
    if name == "rich":
        arrays = _rich_arrays(7, seed=4)
        return ([PortSample(**copy.deepcopy(a)) for a in arrays],
                [JaxSample(**copy.deepcopy(a)) for a in arrays])
    path = os.path.join(FIXTURES, {"s2ef": "s2ef_sample.extxyz", "qm9": "qm9_sample.xyz"}[name])
    port, jax = pd.read_xyz_file(path), jd.read_xyz_file(path)
    for s in port:
        port_build_radius_graph(s, 3.0, max_neighbours=20)
    for s in jax:
        jax_build_radius_graph(s, 3.0, max_neighbours=20)
    return port, jax


@pytest.mark.parametrize("name", ["bcc", "rich", "s2ef", "qm9"])
def test_packed_files_are_byte_identical_and_cross_read(name, tmp_path):
    """The port's ``PackedWriter`` writes the JAX writer's bytes for the same
    samples (header JSON, dtypes, zero-width keys); each package reads the
    other's file to the same samples."""
    port, jax = _packed_case(name)
    attrs = {"dataset_name": name, "pna_deg": [0, 1, 2]}
    ppk.PackedWriter(port, str(tmp_path / "p.gpk"), attrs=dict(attrs))
    jpk.PackedWriter(jax, str(tmp_path / "j.gpk"), attrs=dict(attrs))
    assert (tmp_path / "p.gpk").read_bytes() == (tmp_path / "j.gpk").read_bytes()
    port_of_jax = ppk.PackedDataset(str(tmp_path / "j.gpk"))
    jax_of_port = jpk.PackedDataset(str(tmp_path / "p.gpk"))
    assert port_of_jax.attrs == jax_of_port.attrs
    tpu.assert_samples_equal(port_of_jax.load_all(), jax_of_port.load_all(), name)
    assert all(isinstance(s, PortSample) for s in port_of_jax.load_all())
    # what a file keeps: the fields as float32 / int32
    tpu.assert_samples_equal(port_of_jax.load_all(),
                             jpk.PackedDataset(str(tmp_path / "j.gpk")).load_all(), name)


def test_packed_store_contracts(tmp_path):
    """Count-index sizes, shard windows, read-only memmap samples, the
    writer's refusals, zero-width keys, and the pad spec from the writer's
    stats (the JAX package's)."""
    samples = pd.deterministic_graph_data(number_configurations=12, seed=5)
    path = str(tmp_path / "s.gpk")
    ppk.PackedWriter(samples, path)
    ds = ppk.PackedDataset(path)
    sizes = ds.sample_sizes(range(12))
    np.testing.assert_array_equal(sizes, [(s.num_nodes, s.num_edges) for s in samples])
    s = ds[3]
    assert not s.x.flags.writeable and not s.pos.flags.writeable
    with pytest.raises(ValueError, match="read-only"):
        s.x[0, 0] = 1.0
    ds.setsubset(4, 8)
    assert len(ds) == 4
    np.testing.assert_array_equal(ds[0].pos, samples[4].pos)
    np.testing.assert_array_equal(ds.sample_sizes([0, 3]), sizes[[4, 7]])
    for bs in (1, 4, 7):
        assert (ppk.pad_spec_from_stats(ds.attrs, bs).as_tuple()
                == jpk.pad_spec_from_stats(ds.attrs, bs).as_tuple())
    with pytest.raises(ValueError, match="size stats"):
        ppk.pad_spec_from_stats({}, 4)

    zero = PortSample(x=np.ones((3, 1)), senders=[0, 1], receivers=[1, 2])
    ppk.PackedWriter([zero], str(tmp_path / "z.gpk"))
    back = ppk.PackedDataset(str(tmp_path / "z.gpk"))[0]
    assert back.edge_attr.shape == (2, 0) and back.graph_attr.shape == (0,)
    mixed = [PortSample(x=np.ones((2, 1)), senders=[0], receivers=[1],
                        edge_attr=np.ones((1, w))) for w in (1, 3)]
    with pytest.raises(ValueError, match="inconsistent column widths"):
        ppk.PackedWriter(mixed, str(tmp_path / "bad.gpk"))
    ragged = [PortSample(x=np.ones((2, 1)), graph_y=np.ones(k)) for k in (1, 2)]
    with pytest.raises(ValueError, match="graph_y length differs"):
        ppk.PackedWriter(ragged, str(tmp_path / "bad2.gpk"))
    with pytest.raises(ValueError, match="not a packed dataset"):
        ppk.PackedDataset(_write(tmp_path / "x.gpk", "notpacked" * 4))


def _raw_config(fmt: str, path, **extra) -> dict:
    cfg = copy.deepcopy(CI_CONFIG)
    cfg["Dataset"].update(format=fmt, path={"total": str(path)}, **extra)
    return cfg


@pytest.mark.parametrize("fmt", ["LSMS", "xyz", "xyz_file", "cfg", "pickle", "packed",
                                 "hdf5"])
def test_load_raw_dataset_matches_jax(fmt, tmp_path):
    """``load_raw_dataset`` dispatches on ``Dataset.format`` (case-blind) to
    the same samples as the JAX package's."""
    bcc = jd.deterministic_graph_data(number_configurations=4, seed=8)
    if fmt == "LSMS":
        cfg = _raw_config(fmt, _write_lsms_dir(tmp_path / "d", bcc), charge_density=True)
    elif fmt == "xyz":
        cs.write_qm9_xyz_dir(tmp_path / "d", 3, seed=1)
        cfg = _raw_config(fmt, tmp_path / "d")
    elif fmt == "xyz_file":
        cfg = _raw_config("xyz", os.path.join(FIXTURES, "s2ef_sample.extxyz"))
    elif fmt == "cfg":
        (tmp_path / "d").mkdir()
        _write(tmp_path / "d" / "a.cfg", CFG_FILE)
        cfg = _raw_config(fmt, tmp_path / "d")
    elif fmt == "pickle":
        jd.SimplePickleWriter(bcc, str(tmp_path / "j"), "trainset")
        pd.SimplePickleWriter(tpu.port_samples(bcc), str(tmp_path / "p"), "trainset")
        cfg = _raw_config(fmt, tmp_path / "p", label="trainset")
        jcfg = _raw_config(fmt, tmp_path / "j", label="trainset")
        tpu.assert_samples_equal(pd.load_raw_dataset(cfg), jd.load_raw_dataset(jcfg), fmt)
        return
    elif fmt == "packed":
        jpk.PackedWriter(bcc, str(tmp_path / "s.gpk"))
        cfg = _raw_config(fmt, tmp_path / "s.gpk")
    else:
        _qm7x_fixture(str(tmp_path / "c.h5"))
        cfg = _raw_config(fmt, tmp_path / "c.h5", hdf5_flavor="qm7x")
    tpu.assert_samples_equal(pd.load_raw_dataset(cfg), jd.load_raw_dataset(cfg), fmt)


def test_load_raw_dataset_refuses_an_unknown_format(tmp_path):
    cfg = _raw_config("netcdf", tmp_path)
    with pytest.raises(ValueError) as port_err:
        pd.load_raw_dataset(cfg)
    with pytest.raises(ValueError) as jax_err:
        jd.load_raw_dataset(cfg)
    assert str(port_err.value) == str(jax_err.value)


def _assert_batches_equal(jax_batch, port_batch, what=""):
    for f in FIELDS:
        a = np.asarray(getattr(jax_batch, f))
        b = getattr(port_batch, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f"{what}: field {f} differs"


def _lsms_files_config(tmp_path, n=40):
    d = _write_lsms_dir(tmp_path / "lsms",
                        pd.deterministic_graph_data(number_configurations=n, seed=33))
    return _raw_config("LSMS", d)


def _qm9_files_config(tmp_path, n=40):
    """qm9.json's dataset block pointed at QM9-format files (written ones and
    the committed fixture's three molecules), U0 selected, as
    ``examples/qm9/qm9.py`` selects a target; the canary GIN's widths."""
    from hydragnn_tpu_torch.datasets.xyz import _QM9_PROPS

    d = tmp_path / "qm9"
    cs.write_qm9_xyz_dir(d, n, seed=12)
    (d / "zz_fixture.xyz").write_text(open(os.path.join(FIXTURES, "qm9_sample.xyz")).read())
    cfg = copy.deepcopy(CI_CONFIG)
    cfg["Dataset"] = {
        "name": "qm9_files", "format": "xyz", "path": {"total": str(d)},
        "node_features": {"name": ["Z"], "dim": [1], "column_index": [0]},
        "graph_features": {"name": list(_QM9_PROPS), "dim": [1] * len(_QM9_PROPS),
                           "column_index": list(range(len(_QM9_PROPS)))},
    }
    cfg["NeuralNetwork"]["Architecture"].update(radius=3.0, max_neighbours=20)
    cfg["NeuralNetwork"]["Variables_of_interest"].update(
        output_names=["U0"], output_index=[_QM9_PROPS.index("U0")])
    return cfg


FILE_CONFIGS = {"lsms": _lsms_files_config, "qm9": _qm9_files_config}


@pytest.mark.parametrize("name", sorted(FILE_CONFIGS))
def test_loading_from_dataset_path_matches_jax(name, tmp_path):
    """``dataset_loading_and_splitting`` without samples reads
    ``Dataset.path`` and gives the JAX package's batches, split by split,
    and the same min-max tables."""
    cfg = FILE_CONFIGS[name](tmp_path)
    pcfg, jcfg = copy.deepcopy(cfg), copy.deepcopy(cfg)
    port, jax = port_loading(pcfg), jax_loading(jcfg)
    voi = "Variables_of_interest"
    for key in ("minmax_node_feature", "minmax_graph_feature"):
        assert pcfg["NeuralNetwork"][voi][key] == jcfg["NeuralNetwork"][voi][key]
    for split, (pl, jl) in enumerate(zip(port, jax)):
        assert len(pl) == len(jl) > 0 and pl.pad.as_tuple() == jl.pad.as_tuple()
        pl.set_epoch(1)
        jl.set_epoch(1)
        for i, (bp, bj) in enumerate(zip(pl, jl, strict=True)):
            _assert_batches_equal(bj, bp, f"{name} split {split} batch {i}")


@pytest.mark.parametrize("name", sorted(FILE_CONFIGS))
def test_training_from_files_tracks_jax(name, tmp_path):
    """From files: the JAX package's three epochs and the port's from the
    same (converted) parameters over loaders both read from ``Dataset.path``
    (train losses within rtol 1e-4, validation and test within 6e-2 under
    AdamW, as ``tests/test_torch_train_loop.py``); then the port's
    ``run_training`` and ``run_prediction`` without samples."""
    from hydragnn_tpu.config import update_config as jax_update_config
    from hydragnn_tpu.models import create_model_config as jax_create_model_config
    from hydragnn_tpu.train.loop import evaluate as jax_evaluate
    from hydragnn_tpu.train.loop import train_epoch as jax_train_epoch
    from hydragnn_tpu.train.optimizer import select_optimizer as jax_select_optimizer
    from hydragnn_tpu.train.step import create_train_state as jax_create_train_state
    from hydragnn_tpu.train.step import make_eval_step as jax_make_eval_step
    from hydragnn_tpu.train.step import make_train_step as jax_make_train_step
    from hydragnn_tpu_torch import run_prediction, run_training
    from hydragnn_tpu_torch.train.loop import train_validate_test
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.step import TrainState

    cfg = FILE_CONFIGS[name](tmp_path)
    cfg["NeuralNetwork"]["Training"]["num_epoch"] = 3
    jl = jax_loading(copy.deepcopy(cfg))
    pl = port_loading(copy.deepcopy(cfg))
    jaug = jax_update_config(copy.deepcopy(cfg), *(ld.samples for ld in jl))
    jmodel = jax_create_model_config(jaug)
    opt_cfg = jaug["NeuralNetwork"]["Training"]["Optimizer"]
    jstate = jax_create_train_state(jmodel, jax_select_optimizer(opt_cfg), next(iter(jl[0])))
    port = tpu.port_model_from_jax(jaug, {"params": jstate.params,
                                          "batch_stats": jstate.batch_stats})
    jstep, jeval = jax_make_train_step(jmodel, jax_select_optimizer(opt_cfg)), \
        jax_make_eval_step(jmodel)
    want = []
    for epoch in range(3):
        jl[0].set_epoch(epoch)
        jstate, train_loss, _ = jax_train_epoch(jstep, jstate, jl[0])
        want.append((train_loss, jax_evaluate(jeval, jstate, jl[1])[0],
                     jax_evaluate(jeval, jstate, jl[2])[0]))
    state = TrainState(port, select_optimizer(opt_cfg, port.parameters()))
    history = []
    train_validate_test(state, *pl, jaug["NeuralNetwork"], name, history=history)
    got = np.array([(h["train_loss"], h["val_loss"], h["test_loss"]) for h in history])
    np.testing.assert_allclose(got[:, 0], np.array(want)[:, 0], rtol=TRAIN_RTOL)
    np.testing.assert_allclose(got[:, 1:], np.array(want)[:, 1:], rtol=EVAL_RTOL)

    cfg["NeuralNetwork"]["Training"]["num_epoch"] = 2
    history = []
    state, model, aug = run_training(copy.deepcopy(cfg), device="cpu", path=str(tmp_path),
                                     history=history)
    assert state.step == 2 * len(pl[0]) and all(np.isfinite(h["train_loss"]) for h in history)
    error, _, trues, preds = run_prediction(copy.deepcopy(cfg), state, device="cpu")
    assert np.isfinite(error) and trues[0].shape == preds[0].shape == (len(pl[2].samples), 1)


def _store_setup(tmp_path, n=26):
    samples = pd.deterministic_graph_data(number_configurations=n, seed=2)
    path = str(tmp_path / "store.gpk")
    ppk.PackedWriter(samples, path)
    buckets = pb.compute_pad_buckets(samples, 4, max_buckets=3)
    return samples, path, buckets


@pytest.mark.parametrize("bucketed", [False, True])
def test_global_shuffle_store_streams_match_jax(bucketed, tmp_path):
    """``GlobalShuffleStore.loader`` at ``rank``/``world`` 2: the same plan
    (indices and buckets, chosen from the count index) and the same batches
    as the JAX package's, each rank a stride of one permutation, the two
    ranks together the whole store; lazy (the loader keeps the store)."""
    _, path, buckets = _store_setup(tmp_path)
    port_store, jax_store = ppk.GlobalShuffleStore(path), jpk.GlobalShuffleStore(path)
    kw = {}
    if bucketed:
        kw_j = {"buckets": [jb.PadSpec(*b.as_tuple()) for b in buckets]}
        kw = {"buckets": buckets}
    else:
        kw_j = {}
    for epoch in (0, 1):
        seen = []
        for rank in (0, 1):
            pl = port_store.loader(4, rank=rank, world=2, seed=3, **kw)
            jl = jax_store.loader(4, rank=rank, world=2, seed=3, **kw_j)
            assert pl.samples is port_store
            pl.set_epoch(epoch)
            jl.set_epoch(epoch)
            plan_p, plan_j = pl.batch_plan(), jl.batch_plan()
            assert [(c.tolist(), p.as_tuple()) for c, p in plan_p] == \
                [(c.tolist(), p.as_tuple()) for c, p in plan_j]
            for i, (bp, bj) in enumerate(zip(pl, jl, strict=True)):
                _assert_batches_equal(bj, bp, f"epoch {epoch} rank {rank} batch {i}")
            seen += list(pl._epoch_indices())
        assert set(seen) == set(range(len(port_store)))


def test_a_store_of_normalised_samples_collates_z_from_the_normalised_column(tmp_path):
    """Pinned as the JAX package has it, an open difference between a store
    and memory (ROADMAP queue C): a packed store keeps no
    ``atomic_numbers`` extra, so a store written after the min-max
    normalisation collates ``z`` from the normalised first input column,
    where the same samples in memory collate their atomic numbers. Both
    packages' stores give the same batches."""
    samples = jd.deterministic_graph_data(number_configurations=16, seed=4)
    port_train = port_loading(copy.deepcopy(CI_CONFIG), samples=tpu.port_samples(samples))[0]
    jax_train = jax_loading(copy.deepcopy(CI_CONFIG), samples=samples)[0]
    port_path, jax_path = str(tmp_path / "port.gpk"), str(tmp_path / "jax.gpk")
    ppk.PackedWriter(port_train.samples, port_path)
    jpk.PackedWriter(jax_train.samples, jax_path)
    port_ld = ppk.GlobalShuffleStore(port_path).loader(4, seed=3)
    jax_ld = jpk.GlobalShuffleStore(jax_path).loader(4, seed=3)
    memory = pb.GraphLoader(port_train.samples, 4, pad=port_ld.pad, shuffle=True, seed=3)
    moved = 0
    for i, (bp, bj, bm) in enumerate(zip(port_ld, jax_ld, memory, strict=True)):
        _assert_batches_equal(bj, bp, f"batch {i}")
        real = bp.node_mask.bool()
        assert torch.equal(bp.z[real], torch.round(bp.x[real, 0]).to(torch.int32)), i
        assert torch.equal(bp.x, bm.x), i
        moved += int((bp.z != bm.z).sum())
    assert moved > 0


def test_lazy_bucket_choice_reads_no_sample_content(tmp_path):
    """With a bucket table over a store, the plan comes from
    ``sample_sizes`` alone; with one bucket, from nothing."""
    _, path, buckets = _store_setup(tmp_path)

    class Counting(ppk.GlobalShuffleStore):
        reads = 0

        def __getitem__(self, i):
            Counting.reads += 1
            return super().__getitem__(i)

    store = Counting(path)
    store.loader(4, buckets=buckets).batch_plan()
    store.loader(4).batch_plan()
    assert Counting.reads == 0


@pytest.mark.parametrize("source", ["list", "store"])
def test_prefetch_workers_keep_the_single_worker_sequence(source, tmp_path):
    """``PrefetchLoader(workers=3)`` yields the batches of ``workers=1``, in
    order, across epochs and under ``set_superstep``'s bucket-major plan; an
    abandoned iteration stops."""
    samples, path, buckets = _store_setup(tmp_path)
    data = samples if source == "list" else ppk.GlobalShuffleStore(path)

    def sequence(workers, k):
        ld = pb.PrefetchLoader(pb.GraphLoader(data, 4, shuffle=True, seed=5, buckets=buckets),
                               depth=2, workers=workers)
        ld.set_superstep(k)
        out = []
        for epoch in (0, 1):
            ld.set_epoch(epoch)
            out += list(ld)
        return out

    for k in (1, 2):
        one, three = sequence(1, k), sequence(3, k)
        assert len(one) == len(three) > 0
        for i, (a, b) in enumerate(zip(one, three)):
            for f in FIELDS:
                assert torch.equal(getattr(a, f), getattr(b, f)), (k, i, f)
    it = iter(pb.PrefetchLoader(pb.GraphLoader(data, 4, buckets=buckets), workers=2))
    next(it)
    it.close()


def test_run_training_num_workers_two_trains_as_one(tmp_path):
    """``Training.num_workers`` 2 is accepted: the three loaders collate in
    two threads, in order, so the trained state is the one-worker state,
    bit for bit."""
    from hydragnn_tpu_torch import run_training

    cfg = _lsms_files_config(tmp_path, n=24)
    cfg["NeuralNetwork"]["Training"].update(num_epoch=2, prefetch=2)
    states = []
    for workers in (1, 2):
        cfg["NeuralNetwork"]["Training"]["num_workers"] = workers
        state, _, _ = run_training(copy.deepcopy(cfg), device="cpu",
                                   path=str(tmp_path / str(workers)))
        states.append(state.model.state_dict())
    for (name, a), b in zip(states[0].items(), states[1].values()):
        assert torch.equal(a, b), name


def test_run_training_on_a_store_materializes_it(tmp_path):
    """``run_training(config, samples=store)`` reads the store whole through
    the selection step, as the JAX package does: the same trained state as
    from the store's ``load_all()``."""
    from hydragnn_tpu_torch import run_training

    _, path, _ = _store_setup(tmp_path, n=20)
    cfg = copy.deepcopy(CI_CONFIG)
    cfg["NeuralNetwork"]["Training"]["num_epoch"] = 1
    a, _, _ = run_training(copy.deepcopy(cfg), samples=ppk.GlobalShuffleStore(path),
                           device="cpu", path=str(tmp_path / "a"))
    b, _, _ = run_training(copy.deepcopy(cfg), samples=ppk.PackedDataset(path).load_all(),
                           device="cpu", path=str(tmp_path / "b"))
    for (name, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), name


def test_update_config_fills_the_store_block_as_jax(tmp_path):
    from hydragnn_tpu.config import update_config as jax_update_config
    from hydragnn_tpu_torch.config import update_config as port_update_config

    samples = jd.deterministic_graph_data(number_configurations=6, seed=1)
    cfg = copy.deepcopy(CI_CONFIG)
    cfg["Dataset"]["store"] = {"peer_timeout": 5.0}
    got = port_update_config(copy.deepcopy(cfg), tpu.port_samples(samples))
    want = jax_update_config(copy.deepcopy(cfg), samples)
    assert got["Dataset"]["store"] == want["Dataset"]["store"]
    cfg["Dataset"]["store"] = [1]
    with pytest.raises(ValueError, match="Dataset.store must be a dict"):
        port_update_config(cfg, tpu.port_samples(samples))


@pytest.mark.parametrize("arch", [{"mpnn_type": "GIN"}, {"mpnn_type": "DimeNet"},
                                  {"mpnn_type": "GIN", "global_attn_engine": "GPS",
                                   "pe_dim": 2}])
def test_preprocessing_takes_read_only_store_samples(arch, tmp_path):
    """Samples read from a packed file hold read-only memmap views; every
    preprocessing step (rotation, edge lengths and descriptors, the
    variables of interest, DimeNet's triplets, GPS's encodings, the
    normalisation) assigns new arrays, so the loaders come out as from
    writable copies of the same samples."""
    samples = cs.qm9_like_samples(24, 3, 3.0, 20)
    path = str(tmp_path / "s.gpk")
    ppk.PackedWriter(samples, path)
    cfg = copy.deepcopy(CI_CONFIG)
    cfg["Dataset"].update(rotational_invariance=True, compute_edge_lengths=True,
                          Descriptors={"spherical_coordinates": True,
                                       "point_pair_features": True})
    cfg["NeuralNetwork"]["Architecture"].update(arch)
    stored = ppk.PackedDataset(path).load_all()
    assert not stored[0].pos.flags.writeable
    copies = [tpu.port_samples([s])[0] for s in ppk.PackedDataset(path).load_all()]
    got = port_loading(copy.deepcopy(cfg), samples=stored)
    want = port_loading(copy.deepcopy(cfg), samples=copies)
    for split, (g, w) in enumerate(zip(got, want)):
        for i, (a, b) in enumerate(zip(g, w, strict=True)):
            for f in FIELDS:
                assert torch.equal(getattr(a, f), getattr(b, f)), (split, i, f)
