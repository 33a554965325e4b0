"""Data pipeline: raw datasets, feature/target selection, normalisation,
splits, loaders.

Counterpart of ``hydragnn_tpu/preprocess/load_data.py``:
``dataset_loading_and_splitting(config, samples=None)`` reads
``Dataset.path`` by ``Dataset.format`` (``datasets.load_raw_dataset``) when
no samples are given, or takes the samples in memory (a list, or a store,
which is read whole by the selection step, as in the JAX package); radius
graphs are attached where missing, inputs and columnar targets selected per
``Variables_of_interest``, min-max normalised, split and wrapped in loaders
over one shared pad-bucket table; GPS configurations get Laplacian positional
encodings and, where the user capped GPS's dense-attention width, loaders
that certify batches at that cap; DimeNet configurations get their triplet
indices (``graphs/triplets.py``). The geometric transforms of
``transforms.py`` run in the JAX package's order: rotation before the
radius graph; edge lengths (globally normalised), spherical and point-pair
features; then the variables of interest and the stratified subsample.
Samples read from a packed store hold read-only arrays: every step here
assigns new arrays, none writes into a sample's.
"""

from __future__ import annotations

import numpy as np

from ..graphs.batching import GraphLoader, PadSpec, compute_pad_buckets, compute_pad_spec
from ..graphs.graph import GraphSample


def apply_variables_of_interest(samples, config: dict) -> list[GraphSample]:
    """Select model inputs (``input_node_features``) and build columnar
    targets from each sample's ``extras['node_table']`` / ``['graph_table']``;
    samples without tables pass through untouched."""
    voi = config["NeuralNetwork"]["Variables_of_interest"]
    ds = config.get("Dataset", {})
    input_cols = list(voi.get("input_node_features", []))
    output_type = list(voi.get("type", []))
    output_index = list(voi.get("output_index", []))

    node_dims = ds.get("node_features", {}).get("dim", [])
    node_cols = ds.get("node_features", {}).get("column_index", [])
    graph_dims = ds.get("graph_features", {}).get("dim", [])
    graph_cols = ds.get("graph_features", {}).get("column_index", [])

    out = []
    for s in samples:
        node_table = s.extras.get("node_table")
        graph_table = s.extras.get("graph_table")
        if node_table is None:
            out.append(s)
            continue
        node_table = np.asarray(node_table, np.float64)
        graph_table = np.asarray(graph_table, np.float64).reshape(-1)

        s.x = node_table[:, input_cols].astype(np.float32)
        if input_cols:
            s.extras.setdefault("atomic_numbers", node_table[:, input_cols[0]].copy())

        graph_targets = []
        node_targets = []
        for otype, oidx in zip(output_type, output_index):
            if otype == "graph":
                col = graph_cols[oidx] if graph_cols else oidx
                dim = graph_dims[oidx] if graph_dims else 1
                graph_targets.append(graph_table[col : col + dim])
            elif otype == "node":
                col = node_cols[oidx] if node_cols else oidx
                dim = node_dims[oidx] if node_dims else 1
                node_targets.append(node_table[:, col : col + dim])
            else:
                raise ValueError(f"Unknown output type '{otype}'")
        s.graph_y = (
            np.concatenate(graph_targets).astype(np.float32)
            if graph_targets else np.zeros((0,), np.float32)
        )
        s.node_y = (
            np.concatenate(node_targets, axis=1).astype(np.float32)
            if node_targets else np.zeros((s.num_nodes, 0), np.float32)
        )
        out.append(s)
    return out


def normalize_features(samples) -> tuple[np.ndarray, np.ndarray]:
    """Min-max normalise x / graph_y / node_y in place over the dataset.
    Returns (node_minmax, graph_minmax) for later denormalisation."""

    def _minmax(arrs):
        lo = np.min([a.min(axis=0) for a in arrs if a.size], axis=0)
        hi = np.max([a.max(axis=0) for a in arrs if a.size], axis=0)
        rng = np.where(hi - lo < 1e-12, 1.0, hi - lo)
        return lo, rng

    lo_x, rng_x = _minmax([s.x for s in samples])
    for s in samples:
        s.x = ((s.x - lo_x) / rng_x).astype(np.float32)

    if samples and samples[0].node_y.shape[1]:
        lo_ny, rng_ny = _minmax([s.node_y for s in samples])
        for s in samples:
            s.node_y = ((s.node_y - lo_ny) / rng_ny).astype(np.float32)
    else:
        lo_ny = rng_ny = np.zeros((0,))
    if samples and samples[0].graph_y.shape[0]:
        gys = np.stack([s.graph_y for s in samples])
        lo_gy = gys.min(axis=0)
        rng_gy = np.where(gys.max(axis=0) - lo_gy < 1e-12, 1.0, gys.max(axis=0) - lo_gy)
        for s in samples:
            s.graph_y = ((s.graph_y - lo_gy) / rng_gy).astype(np.float32)
    else:
        lo_gy = rng_gy = np.zeros((0,))
    node_minmax = (
        np.stack([np.concatenate([lo_x, lo_ny]), np.concatenate([lo_x + rng_x, lo_ny + rng_ny])])
        if lo_ny.size or lo_x.size else np.zeros((2, 0))
    )
    graph_minmax = np.stack([lo_gy, lo_gy + rng_gy]) if lo_gy.size else np.zeros((2, 0))
    return node_minmax, graph_minmax


def _composition_key(sample: GraphSample) -> tuple:
    if sample.x.size == 0:
        return ()
    types, counts = np.unique(sample.x[:, 0].round(6), return_counts=True)
    return tuple(zip(types.tolist(), counts.tolist()))


def split_dataset(samples, perc_train: float, stratify_splitting: bool = False, seed: int = 0):
    """Train/val/test split: val and test each get (1 - perc_train) / 2;
    with ``stratify_splitting`` each atomic composition splits
    proportionally."""
    rng = np.random.default_rng(seed)
    if stratify_splitting:
        groups: dict[tuple, list[int]] = {}
        for i, s in enumerate(samples):
            groups.setdefault(_composition_key(s), []).append(i)
        train_idx, val_idx, test_idx = [], [], []
        for key in sorted(groups):
            idx = np.asarray(groups[key])
            idx = idx[rng.permutation(len(idx))]
            n = len(idx)
            n_train = int(n * perc_train)
            n_val = int(n * (1.0 - perc_train) / 2.0)
            train_idx.extend(idx[:n_train].tolist())
            val_idx.extend(idx[n_train : n_train + n_val].tolist())
            test_idx.extend(idx[n_train + n_val :].tolist())
        return ([samples[i] for i in train_idx], [samples[i] for i in val_idx],
                [samples[i] for i in test_idx])
    n = len(samples)
    perm = rng.permutation(n)
    n_train = int(n * perc_train)
    n_val = int(n * (1.0 - perc_train) / 2.0)
    train = [samples[i] for i in perm[:n_train]]
    val = [samples[i] for i in perm[n_train : n_train + n_val]]
    test = [samples[i] for i in perm[n_train + n_val :]]
    return train, val, test


def create_dataloaders(trainset, valset, testset, batch_size: int,
                       pad: PadSpec | None = None, seed: int = 0, buckets: int | None = None,
                       attn_cap: int = 0, rank: int = 0, world: int = 1):
    """Three loaders over one shared pad-bucket table; the train loader
    shuffles and drops the last partial batch. ``attn_cap``: see
    ``PadSpec``. With ``world`` > 1 (one process per GPU of a data-parallel
    run), every loader yields rank ``rank``'s slot of each group of
    ``world`` consecutive batches (``GraphLoader.set_group``)."""
    all_samples = list(trainset) + list(valset) + list(testset)
    # a dataset smaller than the batch still yields one (smaller) batch
    batch_size = max(1, min(batch_size, len(trainset) or 1))
    bucket_list = (
        compute_pad_buckets(all_samples, batch_size, max_buckets=buckets, attn_cap=attn_cap)
        if buckets and buckets > 1 else None
    )
    pad = pad or compute_pad_spec(all_samples, batch_size, attn_cap=attn_cap)
    train_loader = GraphLoader(trainset, batch_size, pad=pad, shuffle=True, seed=seed,
                               buckets=bucket_list)
    val_loader = GraphLoader(valset, batch_size, pad=pad, drop_last=False, buckets=bucket_list)
    test_loader = GraphLoader(testset, batch_size, pad=pad, drop_last=False,
                              buckets=bucket_list)
    if world > 1:
        for ld in (train_loader, val_loader, test_loader):
            ld.set_group(world, rank)
    return train_loader, val_loader, test_loader


def dataset_loading_and_splitting(config: dict, samples=None, rank: int = 0, world: int = 1):
    """raw -> selected/normalised -> split -> loaders. Without ``samples``,
    ``Dataset.path`` is read by ``Dataset.format``. Mutates the samples and
    records the min-max tables in ``config``, as the JAX package does.
    ``rank``/``world``: the loaders of one rank of a data-parallel run (see
    :func:`create_dataloaders`); every rank reads and splits every
    sample."""
    if samples is None:
        from ..datasets import load_raw_dataset

        samples = load_raw_dataset(config)
    ds_cfg = config["Dataset"]
    training = config.setdefault("NeuralNetwork", {}).setdefault("Training", {})
    arch = config["NeuralNetwork"].get("Architecture", {})
    voi = config["NeuralNetwork"].get("Variables_of_interest", {})
    if ds_cfg.get("rotational_invariance"):
        # before the radius graph, as the reference rotates before it
        # builds the edges
        from .transforms import normalize_rotation

        samples = [normalize_rotation(s) for s in samples]
    radius = arch.get("radius")
    if radius and any(s.num_edges == 0 and s.num_nodes > 1 for s in samples):
        from ..graphs.radius import build_radius_graph

        for s in samples:
            if s.num_edges == 0 and s.num_nodes > 1:
                build_radius_graph(
                    s, float(radius), max_neighbours=arch.get("max_neighbours"),
                    ensure_connected=bool(arch.get("ensure_connected", True)),
                )
    # edge_attr columns: the length (normalised by the dataset's largest
    # entry), then the spherical and point-pair descriptors
    desc_cfg = ds_cfg.get("Descriptors", {}) or {}
    if ds_cfg.get("compute_edge_lengths"):
        from .transforms import attach_edge_lengths, normalize_edge_lengths_global

        for s in samples:
            attach_edge_lengths(s)
        normalize_edge_lengths_global(samples)
    if desc_cfg.get("spherical_coordinates"):
        from .transforms import spherical_features

        for s in samples:
            spherical_features(s)
    if desc_cfg.get("point_pair_features"):
        from .transforms import point_pair_features

        for s in samples:
            point_pair_features(s)
    samples = apply_variables_of_interest(samples, config)
    if voi.get("subsample_percentage"):
        from .transforms import stratified_subsample

        samples = stratified_subsample(samples, float(voi["subsample_percentage"]))
    if arch.get("mpnn_type") == "DimeNet":
        # DimeNet reads the angle (triplet) indices, computed on the host
        from ..graphs.triplets import attach_triplets

        for s in samples:
            if "idx_kj" not in s.extras:
                attach_triplets(s)
    if arch.get("global_attn_engine") == "GPS":
        # GPS reads Laplacian positional encodings; nothing else does, so
        # only GPS pays the per-sample eigendecomposition
        from .encodings import attach_lap_pe

        k = int(arch.get("pe_dim") or 1)
        for s in samples:
            attach_lap_pe(s, k)
    if voi.get("denormalize_output") or ds_cfg.get("normalize", True):
        node_minmax, graph_minmax = normalize_features(samples)
        voi["minmax_node_feature"] = node_minmax.tolist()
        voi["minmax_graph_feature"] = graph_minmax.tolist()
    train, val, test = split_dataset(
        samples,
        perc_train=float(training.get("perc_train", 0.7)),
        stratify_splitting=ds_cfg.get("compositional_stratified_splitting", False),
    )
    return create_dataloaders(
        train, val, test, int(training.get("batch_size", 32)),
        buckets=int(training.get("pad_buckets", 0) or 0) or None,
        # a user-set GPS max_graph_nodes below the dataset max: collate
        # certifies against it so fitting batches keep the dense path
        attn_cap=(int(arch.get("max_graph_nodes") or 0)
                  if arch.get("global_attn_engine") else 0),
        rank=rank, world=world,
    )


__all__ = [
    "apply_variables_of_interest",
    "create_dataloaders",
    "dataset_loading_and_splitting",
    "normalize_features",
    "split_dataset",
]
