"""The port's pre- and post-processing helpers against the JAX package's on
the CPU, all numpy on both sides and so equal, not close: the energy
linear regression (fit, apply, the packed-file driver), the per-node
unscaling of ``postprocess.py``, the LSMS formation-Gibbs conversion and
compositional histogram cutoff (files byte for byte), and the molecular
graph perception and descriptors on ``tests/test_molgraph.py``'s molecules.
"""

import os

import numpy as np
import pytest

import hydragnn_tpu.postprocess.lsms as jl
import hydragnn_tpu.postprocess.postprocess as jpp
import hydragnn_tpu.preprocess.descriptors as jdesc
import hydragnn_tpu.preprocess.energy_linear_regression as jelr
import hydragnn_tpu.preprocess.molgraph as jmg
import hydragnn_tpu_torch.postprocess.lsms as pl
import hydragnn_tpu_torch.postprocess.postprocess as ppp
import hydragnn_tpu_torch.preprocess.descriptors as pdesc
import hydragnn_tpu_torch.preprocess.energy_linear_regression as pelr
import hydragnn_tpu_torch.preprocess.molgraph as pmg
import torch_port_util as tpu
from hydragnn_tpu.graphs.graph import GraphSample as JaxSample
from hydragnn_tpu_torch.datasets.packed import PackedWriter
from hydragnn_tpu_torch.graphs.graph import GraphSample as PortSample
from test_small_gaps import _write_lsms_dir


def _energy_samples(cls, n=30, seed=0):
    rng = np.random.default_rng(seed)
    ref = {1: -0.5, 6: -37.8, 8: -75.0}
    out = []
    for _ in range(n):
        zs = rng.choice(list(ref), size=int(rng.integers(3, 9)))
        e = sum(ref[int(z)] for z in zs) + 0.01 * rng.normal()
        na = len(zs)
        out.append(cls(x=zs.reshape(-1, 1).astype(np.float32), pos=rng.uniform(0, 3, (na, 3)),
                       graph_y=np.array([e, 1.0]), node_y=np.zeros((na, 1)),
                       energy_y=np.array([e]) if rng.random() < 0.8 else None))
    return out


def test_energy_linear_regression_equals_jax(tmp_path):
    port, jax = _energy_samples(PortSample), _energy_samples(JaxSample)
    coeff = pelr.fit_energy_linear_regression(port)
    np.testing.assert_array_equal(coeff, jelr.fit_energy_linear_regression(jax))
    assert abs(coeff[5] + 37.8) < 0.05  # Z = 6 in bin 5
    pelr.apply_energy_linear_regression(port, coeff)
    jelr.apply_energy_linear_regression(jax, coeff)
    tpu.assert_samples_equal(port, jax, "baseline removed")
    np.testing.assert_array_equal(pelr.composition_histogram(np.array([1, 1, 6, 118])),
                                  jelr.composition_histogram(np.array([1, 1, 6, 118])))

    src = str(tmp_path / "in.gpk")
    PackedWriter(_energy_samples(PortSample, seed=1), src)
    got = pelr.energy_linear_regression_packed(src, str(tmp_path / "p.gpk"))
    want = jelr.energy_linear_regression_packed(src, str(tmp_path / "j.gpk"))
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "p.gpk").read_bytes() == (tmp_path / "j.gpk").read_bytes()


def test_unscale_features_by_num_nodes_equals_jax():
    nodes = [2, 4, 3]

    def data():
        r = np.random.default_rng(1)
        return [[r.normal(size=(n, 2)) for n in nodes] for _ in range(2)]

    got = ppp.unscale_features_by_num_nodes([data(), data()], [1], nodes)
    want = jpp.unscale_features_by_num_nodes([data(), data()], [1], nodes)
    for a, b in zip(got, want):
        for ha, hb in zip(a, b):
            for x, y in zip(ha, hb):
                np.testing.assert_array_equal(x, y)
    cfg = {"NeuralNetwork": {"Variables_of_interest": {
        "output_names": ["e", "energy_scaled_num_nodes"], "denormalize_output": True}}}
    got = ppp.unscale_features_by_num_nodes_config(cfg, [data()], nodes)
    want = jpp.unscale_features_by_num_nodes_config(cfg, [data()], nodes)
    for x, y in zip(got[0][1], want[0][1]):
        np.testing.assert_array_equal(x, y)
    cfg["NeuralNetwork"]["Variables_of_interest"]["denormalize_output"] = False
    with pytest.raises(AssertionError, match="denormalize_output"):
        ppp.unscale_features_by_num_nodes_config(cfg, [data()], nodes)


def _lsms_dir(path, cells):
    path.mkdir()
    return _write_lsms_dir(path, cells)


def _lsms_cells(rng):
    cells = [(-4.0, [26] * 4), (-8.0, [78] * 4)]
    for _ in range(10):
        k = int(rng.integers(1, 8))
        cells.append((float(rng.uniform(-9, -4)), [26] * k + [78] * (8 - k)))
    return cells


@pytest.mark.parametrize("temperature", [0.0, 300.0])
def test_formation_gibbs_files_equal_jax(temperature, tmp_path):
    cells = _lsms_cells(np.random.default_rng(3))
    d_port = _lsms_dir(tmp_path / "port", cells)
    d_jax = _lsms_dir(tmp_path / "jax", cells)
    out_port = pl.convert_total_energy_to_formation_gibbs(d_port, [26, 78], temperature)
    out_jax = jl.convert_total_energy_to_formation_gibbs(d_jax, [26, 78], temperature)
    names = sorted(os.listdir(out_port))
    assert names == sorted(os.listdir(out_jax)) and len(names) == len(cells)
    for name in names:
        with open(os.path.join(out_port, name), "rb") as a, \
                open(os.path.join(out_jax, name), "rb") as b:
            assert a.read() == b.read(), name
    args = (np.array([26, 26, 78, 78, 78]), -6.5, [26, 78], {26: -1.0, 78: -2.0})
    assert pl.compute_formation_enthalpy(*args) == jl.compute_formation_enthalpy(*args)
    with pytest.raises(ValueError, match="outside"):
        pl.compute_formation_enthalpy(np.array([29]), -1.0, [26, 78], {26: -1.0, 78: -2.0})


def test_histogram_cutoff_keeps_the_jax_selection(tmp_path):
    cells = [(-1.0, [26] * 5 + [78] * 3) for _ in range(6)] + _lsms_cells(
        np.random.default_rng(4))
    d_port = _lsms_dir(tmp_path / "port", cells)
    d_jax = _lsms_dir(tmp_path / "jax", cells)
    got = pl.compositional_histogram_cutoff(d_port, [26, 78], histogram_cutoff=3, num_bins=5)
    want = jl.compositional_histogram_cutoff(d_jax, [26, 78], histogram_cutoff=3, num_bins=5)
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    assert 0 < len(os.listdir(got)) < len(cells)
    for nb in (3, 5, 10):
        for comp in (0.0, 0.1, 0.5, 0.625, 1.0):
            assert pl.find_bin(comp, nb) == jl.find_bin(comp, nb)


MOLECULES = [
    (["O", "H", "H"], [[0, 0, 0], [0.96, 0, 0], [-0.24, 0.93, 0]]),
    (["O", "C", "O"], [[-1.16, 0, 0], [0, 0, 0], [1.16, 0, 0]]),
    (["N", "N"], [[0, 0, 0], [1.10, 0, 0]]),
    (["S", "H", "H"], [[0, 0, 0], [1.34, 0, 0], [-0.3, 1.3, 0]]),
    (["C", "O"], [[0, 0, 0], [1.13, 0, 0]]),
    (["C", "C", "H", "H", "H", "H"], [[0, 0, 0], [1.33, 0, 0], [-0.55, 0.92, 0],
                                      [-0.55, -0.92, 0], [1.88, 0.92, 0], [1.88, -0.92, 0]]),
]
SMILES = ["C", "CC", "CCO", "CC(=O)O", "c1ccccc1", "c1ccncc1", "c1cc[nH]c1",
          "c1ccc2ccccc2c1", "Cc1ccccc1", "[NH4+]", "[O-]C=O", "CC(C)C", "CCS"]


def _mol_fields(m):
    return (m.atomic_numbers.tolist(), list(m.bonds), m.formal_charges.tolist(),
            np.asarray(m.n_hydrogens).tolist(), np.asarray(m.aromatic).tolist())


@pytest.mark.parametrize("i", range(len(MOLECULES)))
def test_xyz2mol_equals_jax(i):
    atoms, pos = MOLECULES[i]
    np.testing.assert_array_equal(pmg.perceive_connectivity(atoms, pos),
                                  jmg.perceive_connectivity(atoms, pos))
    got, want = pmg.xyz2mol(atoms, pos), jmg.xyz2mol(atoms, pos)
    assert _mol_fields(got) == _mol_fields(want)
    assert _mol_fields(pdesc.xyz2mol(atoms, pos)) == _mol_fields(want)
    tpu.assert_samples_equal([pmg.mol_to_graphsample(got)], [jmg.mol_to_graphsample(want)],
                             f"molecule {i}")


def test_smiles_graphs_and_descriptors_equal_jax():
    for s in SMILES:
        assert _mol_fields(pmg.parse_smiles(s)) == _mol_fields(jmg.parse_smiles(s)), s
        tpu.assert_samples_equal([pdesc.smiles_to_graph(s)], [jdesc.smiles_to_graph(s)], s)
    for bad, match in (("c1ccccc", "unclosed ring"), ("C$C", "unsupported")):
        with pytest.raises(ValueError, match=match):
            pmg.parse_smiles(bad)
    for one_hot in (False, True):
        got = pdesc.AtomicDescriptors(one_hot=one_hot)
        want = jdesc.AtomicDescriptors(one_hot=one_hot)
        assert got.atom_embeddings == want.atom_embeddings
        port = pdesc.attach_atomic_descriptors(pmg.smiles_to_graphsample("CCO"), got)
        jax = jdesc.attach_atomic_descriptors(jmg.smiles_to_graphsample("CCO"), want)
        np.testing.assert_array_equal(port.x, jax.x)
