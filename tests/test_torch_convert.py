"""The port's ingestion front door (``hydragnn_tpu_torch.datasets.convert``)
against the JAX package's, on the CPU: the CLI writes the JAX CLI's bytes
on both committed fixtures; ``read_structures`` routes every extension as
the JAX package does; the ASE, OC20-LMDB and ADIOS ``.bp`` readers run
against import-mocked stand-ins of those libraries (the mocks of
``tests/test_convert.py``) and give the JAX readers' samples; without the
libraries they raise ``ImportError``.
"""

import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest

import hydragnn_tpu.datasets.convert as jc
import hydragnn_tpu_torch.datasets.convert as pc
import torch_port_util as tpu
from hydragnn_tpu.datasets import deterministic_graph_data
from test_convert import FakeAtoms, FakeOC20Record, _mock_adios2, _write_fake_bp

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_convert_cli_writes_the_jax_bytes_on_the_qm9_fixture(tmp_path):
    """``python -m hydragnn_tpu_torch.datasets.convert`` as a user runs it,
    against the JAX CLI's ``main`` on the same input and flags."""
    src = os.path.join(FIXTURES, "qm9_sample.xyz")
    flags = ["--radius", "4.0", "--max-neighbours", "12", "--name", "qm9-fixture"]
    out = tmp_path / "port.gpk"
    proc = subprocess.run([sys.executable, "-m", "hydragnn_tpu_torch.datasets.convert", src,
                           str(out), *flags], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f"wrote 3 structures -> {out}" in proc.stdout
    jc.main([src, str(tmp_path / "jax.gpk"), *flags])
    assert out.read_bytes() == (tmp_path / "jax.gpk").read_bytes()


@pytest.mark.parametrize("limit", [None, 2])
def test_convert_main_writes_the_jax_bytes_on_the_s2ef_fixture(limit, tmp_path, capsys):
    src = os.path.join(FIXTURES, "s2ef_sample.extxyz")
    flags = [] if limit is None else ["--limit", str(limit)]
    pc.main([src, str(tmp_path / "p.gpk"), *flags])
    jc.main([src, str(tmp_path / "j.gpk"), *flags])
    assert (tmp_path / "p.gpk").read_bytes() == (tmp_path / "j.gpk").read_bytes()
    assert "structures ->" in capsys.readouterr().out


def test_convert_lsms_directory_and_empty_input(tmp_path):
    from hydragnn_tpu_torch.datasets import write_lsms_file

    d = tmp_path / "lsms"
    d.mkdir()
    for i, s in enumerate(deterministic_graph_data(number_configurations=5, seed=3)):
        write_lsms_file(str(d / f"o{i}.txt"), s.extras["graph_table"], s.extras["node_table"],
                        s.pos)
    n_port = pc.convert_to_packed(str(d), str(tmp_path / "p.gpk"), radius=2.0, fmt="lsms",
                                  limit=4)
    n_jax = jc.convert_to_packed(str(d), str(tmp_path / "j.gpk"), radius=2.0, fmt="lsms",
                                 limit=4)
    assert n_port == n_jax == 4
    assert (tmp_path / "p.gpk").read_bytes() == (tmp_path / "j.gpk").read_bytes()
    empty = tmp_path / "empty.xyz"
    empty.write_text("\n")
    with pytest.raises(ValueError, match="no structures found"):
        pc.convert_to_packed(str(empty), str(tmp_path / "e.gpk"))


def test_read_structures_routes_as_jax(tmp_path):
    d = tmp_path / "xyzdir"
    d.mkdir()
    for name in ("qm9_sample.xyz", "s2ef_sample.extxyz"):
        (d / (name.split(".")[0] + ".xyz")).write_text(open(os.path.join(FIXTURES, name)).read())
    tpu.assert_samples_equal(pc.read_structures(str(d), limit=5),
                             jc.read_structures(str(d), limit=5), "dir")
    with pytest.raises(ValueError) as port_err:
        pc.read_structures(str(tmp_path / "a.parquet"))
    with pytest.raises(ValueError) as jax_err:
        jc.read_structures(str(tmp_path / "a.parquet"))
    assert str(port_err.value) == str(jax_err.value)


def test_sample_from_ase_atoms_and_fairchem_match_jax():
    atoms = [FakeAtoms(z=[1, 8], pos=[[0.0, 0, 0], [1.0, 0, 0]], energy=-3.25,
                       forces=[[0.1, 0, 0], [-0.1, 0, 0]], cell=np.eye(3) * 10.0, pbc=True),
             FakeAtoms(z=[6], pos=[[0.0, 0, 0]])]
    tpu.assert_samples_equal([pc.sample_from_ase_atoms(a) for a in atoms],
                             [jc.sample_from_ase_atoms(a) for a in atoms], "ase")
    recs = [FakeOC20Record(z=np.array([26.0, 8.0]), pos=np.ones((2, 3)), y=-1.5,
                           force=np.ones((2, 3)) * 0.2, cell=np.eye(3)[None] * 8.0),
            FakeOC20Record(z=np.array([29.0]), pos=np.zeros((1, 3)))]
    tpu.assert_samples_equal([pc.sample_from_fairchem(r) for r in recs],
                             [jc.sample_from_fairchem(r) for r in recs], "fairchem")
    for raw in (pickle.dumps(7), b"12", None, b"\xff\xfe"):
        assert pc._decode_length(raw) == jc._decode_length(raw)


def test_read_ase_via_mocked_module(monkeypatch):
    frames = [FakeAtoms(z=[1, 1], pos=[[0.0, 0, 0], [0.8, 0, 0]], energy=-1.0,
                        forces=[[0.0, 0, 0], [0.0, 0, 0]]),
              FakeAtoms(z=[8], pos=[[0.0, 0, 0]], energy=-2.0, forces=[[0.0, 0, 0]]),
              FakeAtoms(z=[6, 6], pos=[[0.0, 0, 0], [1.4, 0, 0]], energy=-3.0)]
    ase, ase_io = types.ModuleType("ase"), types.ModuleType("ase.io")
    ase_io.iread = lambda path: iter(frames)
    ase.io = ase_io
    monkeypatch.setitem(sys.modules, "ase", ase)
    monkeypatch.setitem(sys.modules, "ase.io", ase_io)
    got = pc.read_structures("fake.traj", limit=2)
    assert len(got) == 2
    tpu.assert_samples_equal(got, jc.read_structures("fake.traj", limit=2), "ase")


def test_read_oc20_lmdb_via_mocked_module(monkeypatch):
    recs = {
        b"0": pickle.dumps(FakeOC20Record(z=np.array([26.0, 8.0]), pos=np.zeros((2, 3)), y=-1.5,
                                          force=np.ones((2, 3)) * 0.2,
                                          cell=np.eye(3)[None] * 8.0)),
        b"1": pickle.dumps(FakeOC20Record(z=np.array([29.0]), pos=np.zeros((1, 3)), y=-0.5)),
        b"length": pickle.dumps(2),
    }

    class FakeTxn:
        def get(self, k):
            return recs.get(k)

        def cursor(self):
            return iter(sorted(recs.items()))

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    class FakeEnv:
        def begin(self):
            return FakeTxn()

    lmdb = types.ModuleType("lmdb")
    lmdb.open = lambda path, **kw: FakeEnv()
    monkeypatch.setitem(sys.modules, "lmdb", lmdb)
    got = pc.read_structures("fake.lmdb")
    assert len(got) == 2 and got[0].pbc.all()
    tpu.assert_samples_equal(got, jc.read_structures("fake.lmdb"), "lmdb")


@pytest.mark.parametrize("api", ["FileReader", "legacy"])
def test_read_bp_dataset_via_mocked_adios2(api, tmp_path, monkeypatch):
    """A reference-written ADIOS store, through a mocked ``FileReader`` and
    through the legacy ``adios2.open`` stream API, read to the JAX reader's
    samples; a missing label fails with the available ones; the
    ``Dataset.format`` "adios" route reads it too."""
    from hydragnn_tpu_torch.datasets import load_raw_dataset

    attrs, data = _write_fake_bp(deterministic_graph_data(number_configurations=6, seed=19))
    if api == "FileReader":
        _mock_adios2(monkeypatch, attrs, data)
    else:
        def fmt_attr(v):
            if isinstance(v, list):
                return {"Type": "string", "Value": "{" + ", ".join(v) + "}"}
            return {"Type": "int64_t",
                    "Value": "{" + ", ".join(str(x) for x in np.asarray(v).ravel()) + "}"}

        class Legacy:
            def available_attributes(self):
                return {k: fmt_attr(v) for k, v in attrs.items()}

            def read(self, name):
                return data[name]

            def close(self):
                pass

        fake = types.ModuleType("adios2")
        fake.open = lambda path, mode: Legacy()
        monkeypatch.setitem(sys.modules, "adios2", fake)
    path = str(tmp_path / "corpus.bp")
    got = pc.read_bp_dataset(path)
    assert len(got) == 6
    tpu.assert_samples_equal(got, jc.read_bp_dataset(path), "bp")
    tpu.assert_samples_equal(pc.read_structures(path, limit=3), jc.read_structures(path, limit=3),
                             "bp routed")
    cfg = {"Dataset": {"format": "adios", "path": path}}
    tpu.assert_samples_equal(load_raw_dataset(cfg), got, "adios format")
    with pytest.raises(ValueError, match="trainset"):
        pc.read_bp_dataset(path, label="valset")


@pytest.mark.parametrize("module,path", [("ase", "x.db"), ("lmdb", "x.lmdb"),
                                         ("adios2", "x.bp")])
def test_optional_libraries_absent_raise_import_error(module, path, monkeypatch):
    """Without the library the reader raises ``ImportError`` naming it (the
    JAX package's text; the ``.bp`` hint names the port's converter)."""
    monkeypatch.setitem(sys.modules, module, None)
    if module == "ase":
        monkeypatch.setitem(sys.modules, "ase.io", None)
    with pytest.raises(ImportError) as port_err:
        pc.read_structures(path)
    with pytest.raises(ImportError) as jax_err:
        jc.read_structures(path)
    assert module in str(port_err.value)
    assert str(port_err.value) == str(jax_err.value).replace("hydragnn_tpu.", "hydragnn_tpu_torch.")


def test_hdf5_reader_without_h5py_raises(monkeypatch):
    from hydragnn_tpu_torch.datasets import hdf5

    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        hdf5.read_hdf5("x.h5")


def test_convert_hdf5_corpus_matches_jax(tmp_path):
    """An ANI1x-layout corpus through ``convert_to_packed`` (h5py present on
    this side): the JAX converter's bytes."""
    from test_torch_datasets import _ani1x_fixture

    h5 = str(tmp_path / "ani.h5")
    _ani1x_fixture(h5)
    assert pc.convert_to_packed(h5, str(tmp_path / "p.gpk"), radius=3.0) == \
        jc.convert_to_packed(h5, str(tmp_path / "j.gpk"), radius=3.0)
    # the files record their source path: the same input, the same bytes
    assert (tmp_path / "p.gpk").read_bytes() == (tmp_path / "j.gpk").read_bytes()
