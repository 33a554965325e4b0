#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``hydragnn_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--quant-diagnostics] [--kernels-only]

Three configurations of ``examples/qm9/qm9.json`` at its published widths
(hidden 64, 4 conv layers, 2 shared layers of 64, graph head [64, 64], mean
pooling, bf16, batch 64, AdamW lr 1e-3), random weights from ``--seed``:
the GIN itself, its GAT variant (``mpnn_type`` GAT: 6 heads, layers 0-2
concatenated to 384 features) and its GPS-GIN variant (GPS multihead
attention, 4 heads, Laplacian positional encodings of width 4); and its
variants on the six invariant stacks, with the knobs of ``bench.py``'s
arch sweep: SAGE, MFC (``max_neighbours`` 20), SchNet (20 Gaussians, 64
filters), PNA, PNAPlus (5 radial functions, envelope exponent 5) and
CGCNN (its width the input's, 1, as the reference forces it); and on the
four geometric stacks, the same way: PAINN and PNAEq (hidden 32, 6 radial
functions), DimeNet (hidden 64, 6 radial x 7 spherical, interaction 64,
basis 8, output 64; triplets attached in preprocessing) and MACE (hidden
32, ``max_ell`` 1, correlation 2, Bessel basis). Then the interatomic
potential of ``bench.py``'s ``oc20`` row (EGNN, hidden 64, 3 conv layers,
equivariance on, add pooling, energy + 10 x force loss, fp32, batch 64),
PAINN and MACE on the same data with ``examples/oc20/train.py``'s block
(hidden 32 x 3, ``max_ell`` 2, energy + 25 x force loss, a node head) and
molecular dynamics: that EGNN on a 1,000-atom LJ cell, and
an analytic LJ potential on ``bench.py``'s 8,000-atom MD lattice. Each
trained qm9 model also serves int8 (``Serving.quantize``), the three
trained MLIPs serve their head outputs, the trained GIN's Dense layers go
through the experimental fp8 layer, and the trained GIN is registered from
its checkpoint and served by the multi-process fleet. Three more qm9.json
configurations train, serve and serve int8 the same way
(``EDGE_KINDS``): GAT with the edge lengths as edge features
(``Dataset.compute_edge_lengths``), GPS-PNA with the edge lengths and
relative-PE edge encodings, and GPS-GIN with performer attention; and
eighteen more combinations at 2 conv layers (``VARIANTS``: seven edge
stacks with the edge lengths, GPS around eleven more convs) each take a
captured train step bit-equal to eager on the card, with the CPU route's
launches and fp32 answers. The skeleton's options (PR 14) the same way:
qm9.json's GIN with ``GaussianNLLLoss`` and its GAT with
``conv_checkpointing`` (``QM9_OPTIONS``), ``examples/multidataset/train.py``'s
two-branch GIN on its two BCC datasets (``MULTIBRANCH_KINDS``) and
``examples/mptrj/train.py``'s EGNN MLIP with film conditioning on
(charge, spin), the six optax optimizers on the GIN, eight more
``VARIANTS`` (conditioning, node branches) and two node-head canaries.

Phases (any failure exits non-zero; the last line of standard output is the
device JSON only when every phase passed):

1. device: name, count, power limit; TF32 off for matmuls and cuDNN;
2. build: nvcc builds each ``hydragnn_tpu_torch/csrc/*.cu`` from this
   checkout, one process per source, all started together;
3. kernels: each CUDA kernel's wrapper against its plain PyTorch version at
   the main paths' shapes (a collated QM9-like batch at the top pad
   bucket), fp32 and bf16: the gather-scatter sum (scalar and per-channel
   weights, unsorted ids, empty rows) and its transposed launch (the
   backward) over the senders' CSR view; the segment sum; the segment
   softmax over GAT's extended edge layout (6 heads; the dummy row's many
   pieces, unsorted ids, empty segments); the masked row softmax over GPS's
   dense attention blocks (65 graphs, 4 heads, 32 x 32, fully masked rows;
   also m = 1, 5, 31, 33, 64 and a misaligned view, which must give the
   aligned copy's bits). B1 and B2 bit for bit: every row of at most
   ``PIECE_EDGES`` entries equal to the plain version on the CPU (one
   thread), every row equal to a fixed-order emulation of the kernels'
   pieces and combine chains (``csr_sum_emulation``), at B2's main shapes
   (pooling, GAT's aggregation and softmax backward, the oc20 MLIP batch's
   message sum and pooling), fp32 and bf16, sorted and shuffled ids, and
   at B1's forward and transposed launch; B1 at SchNet's sum (a weight per
   edge and channel, [E, 64]), forward, transposed launch and the filters'
   gradient through autograd, fp32 and bf16; B1 in the same mode over
   DimeNet's triplets (``idx_kj`` gathered onto ``idx_ji``'s E rows, the
   transposed launch over ``idx_kj``'s view; in fp32 also bit-equal to
   ``gather_rows`` + B2) and B2 on the geometric stacks' flattened
   ``[E, 3, 32]`` messages (``geometric_kernel_phase``); B2 at the
   performer's per-graph ``kv`` ``[N, 1024]`` and ``z`` ``[N, 64]`` and at
   GAT's self-loop mean ``[E, 1]`` (``edge_kernel_phase``). Device times per call
   (CUDA-graph replay between CUDA events) beside the plain version, a
   one-call PyTorch yardstick (``torch.sparse.softmax``, which synchronises
   with the host, timed by events around back-to-back calls) and the bound
   (B1 also at SchNet's shape; B2 at its five main shapes beside
   ``index_add_``; B4 in fp32 and bf16 beside ``torch.softmax``); then (3b) the int8 dense kernel B6 against its
   plain version at every Dense call of the GIN's served forward (fp32 and
   bf16 inputs, K = 1 and N = 1 layers included), GAT's 384 x 384 lin_l and
   a ragged row count (codes, int32 sums and y bit-equal), and the
   fp8 kernel B7 at the GIN's shapes in e4m3 and e5m2, saturated too, and on
   adversarial inputs (codes over the format's whole range, sums that
   cancel) (codes bit-equal, y within the summation-order bound); their
   times beside the plain versions, quantize + ``torch._int_mm`` /
   ``torch._scaled_mm`` yardsticks and the bounds; B6 also at GAT's 384 x
   384, GIN conv layer 0 (K = 1) and a head's output Dense (N = 1), fp32
   and bf16, B7 also at K = 1, N = 1 and the oc20 EGNN's [E, 129] x [129,
   64], both kernels' device operations under ``torch.profiler``, and
   ``cuobjdump -sass`` of both libraries (tensor-core instructions, no
   scalar tile kernel). B3 is also held bit for bit on every entry against
   its fixed-order emulation (``segment_softmax_emulation``, torch on the
   card);
Every main path runs the port's CUDA graphs (``capture.py``: the served
predict steps per bucket, the train and eval steps, supersteps, the MD
trajectory segments), and each phase also runs the eager step it captures
as the comparator, in the same call: the answers or states bit-equal, the
launch records of the graphs equal to the eager counts, and both sides'
p50/p99, throughput, step times, device busy share and device operations
logged (the last is a ``capture summary`` line).

4. serving, per model: ``PredictionServer`` (every bucket captured at
   warm-up) with 512 requests as one closed burst through
   ``serve.traffic.run_traffic`` (every serving burst of the script goes
   through it, so latency is measured one way) under ``no_new_captures``;
   served answers against ``Predictor.outputs`` on the same padded batches;
   launch counts per served batch; the same burst through a server whose
   endpoint answers eagerly (the comparator); the card's fp32 answers
   against the port's CPU route on one batch; one ``run_prediction`` pass;
5. training, per model: ``run_training`` in bf16 for a few epochs (the only
   cut of the configuration: ``num_epoch``), with checkpoints in a
   temporary directory; the train loss falls; launch counts per train step;
   captured train and eval steps against the eager ones on copies of the
   trained state (four steps, the learning rate halved before the last;
   every parameter, moment, statistic and the generator bit-equal); one
   fp32 train step on the card against the CPU route (dropout 0 for this
   check only: the two routes draw other masks); the final checkpoint
   reloaded into a fresh model gives the trained model's
   ``run_prediction``; where a train step's time goes, and the device's busy
   share under ``torch.profiler``, eager and captured; then (5b) the GIN
   with ``Training.steps_per_dispatch: 4``: its losses and final state
   bit-equal to one step per dispatch over the same bucket-major plan;
5c. the three ``EDGE_KINDS`` through phases 4, 5 and 10 as the
   models above (int8 without the eager comparators), and each of the
   eighteen ``VARIANTS`` through ``variant_phase``: one captured bf16 train
   step bit-equal to its eager step, the eager step's launches and the
   graph's launch record equal to the CPU route's launcher calls
   (``cpu_route_calls``), the fp32 forward against the CPU route;
5d. the options (PR 14): ``gin_nll``, ``gat_ckpt`` and ``gfm_branches``
   through phases 4, 5 and 10 (int8 without the eager comparators; the
   branch kind's requests come from both datasets); the two trained GATs
   bit-equal, and from one state one captured step with and one without
   checkpointing bit-equal, their peak memory and step times
   (``conv_checkpointing_phase``); the MPTrj film MLIP through phases 8
   and 13, its energies and forces against the CPU route, and int8
   (refused at its pinned bound); each optax optimizer's ten captured
   steps bit-equal to eager and one fp32 step against the CPU route
   (``optimizer_phase``); the new ``VARIANTS`` through ``step_checks``;
6. canaries: the tier-1 convergence canaries on the deterministic BCC
   dataset through ``run_training`` and ``run_prediction`` on the card, at
   the reference thresholds: GIN with one head and with four heads (head
   RMSE < 0.25, sample MAE < 0.20), GAT (< 0.60 / < 0.70), GPS-GIN (RMSE of
   the graph head < 0.35), and the six invariant and four geometric
   stacks in the 4-head configuration of ``tests/test_training_e2e.py``'s
   arch sweep (``CANARY_OVERRIDES``) at its ``THRESHOLDS`` on every head;
   GAT with the edge lengths at GAT's thresholds, GPS-PNA with
   the edge lengths and the GPS performer at GPS-GIN's; the 4-head GIN
   with ``mlp_per_node`` node heads (on graphs of one size) at its
   thresholds and with ``conv`` node heads at 1.25 x the JAX package's CPU
   readings (which miss the thresholds), both also through
   ``step_checks``;
7. the repaired backwards (phase 3, right after the kernels): second
   derivatives through ``fused_segment_sum``, ``gather_rows``,
   ``gather_scatter_sum`` and ``segment_softmax``, kernels against plain
   versions on the card;
8. MLIP training: ``run_training`` of the oc20 EGNN for a few epochs (the
   only cut: ``num_epoch``); the train loss falls; exact launch counts per
   MLIP train step (all ``segment_sum``); one fp32 MLIP step on the card
   held per tensor against an fp64 CPU step (what a dropped second
   derivative would miss); where the step's time goes; the busy share;
   then PAINN and MACE as MLIPs the same way (captured steps bit-equal to
   eager, exact launches), with their forces through the kernels against
   the plain versions on the same state;
9. the cell-list kernel B5 against its plain version at both MD systems'
   shapes (ids identical, shifts within 1e-6), a slab, an overflowing
   capacity, two launches bit-identical, the edge set against the dense
   build, whether the shifts are bit-equal, its time, plain time and
   bound, the whole build's time, and the device operations of the pair
   test and of the whole build under ``torch.profiler``; then MD: the analytic LJ
   lattice (8,000 atoms, 100 NVE steps) and the trained EGNN on the
   1,000-atom cell (200 NVE steps): each system's first forces through the
   kernels against the plain versions at the path's shapes (within 1e-5 of
   the largest force); ``run_md``'s captured trajectory bit-equal to the
   eager steps one by one; finite, no overflow, drift, exact launches per
   step, ms per step (captured and eager) and its parts; the EGNN's first
   forces, and its velocities and positions after 10 steps from nonzero
   velocities, against the port's CPU route; two runs bit for bit;
10. quantized serving, per trained qm9 model, the ten newer stacks (SAGE
   to MACE) too (right after its training; those without the eager
   comparators):
   the model behind an fp32 server and a ``Serving.quantize: true`` server
   (default quant_tol 0.1 and 4 calibration batches, calibrated on the
   training samples), 512 requests each (one closed burst) under
   ``no_new_captures``, and an eager comparator burst each: the certified per-head
   bounds within quant_tol (the one known exception, the GIN, must be
   refused at its pinned bound, ``QUANT_KNOWN_REFUSALS``, and then serves
   int8 at that bound), served int8 answers equal to
   ``Predictor.outputs(batch, step=<int8 step>)``, one ``quant_dense``
   launch per Dense call per batch, batch independence (the calibration
   samples served among the traffic keep their certified answers), the
   card's int8 step against the CPU route's with the same tables (no code
   flips, answers within the fp32 parity tolerance), the fp32 answers
   unchanged; p50/p99 and throughput of both; the int8 error over the
   whole traffic against the bounds is logged (the reference's 4-sample
   certificate does not bound it: an unmet gate, ROADMAP queue C). The
   pinned refusals: GIN, PAINN, PNAEq, DimeNet; the code-flip gate counts
   the ten newer stacks' and the three edge kinds' real rows and takes
   SchNet's and PNAEq's flips from inputs that CUDA and the CPU round
   apart (``INT8_INPUT_FLIPS``), GPS-PNA's and the performer's likewise but
   with every flipped code one step from the CPU's and the answers within
   the certified bounds (``INT8_GPS_INPUT_FLIPS``);
11. fp8: B7 at the oc20 EGNN's first edge-MLP Dense on its training batch,
   then ``certify_fp8_dense`` on every Dense call of the trained GIN, both
   formats (max-abs and relative-Frobenius error);
12. (in phase 3) B6 bit for bit at every distinct Dense shape of the ten
   stacks', the three MLIPs' and the three edge kinds' served forwards
   (GAT's ``lin_edge`` at K = 1, GPS's ``edge_lin`` at K = 128; DimeNet's ``lin_sbf1``
   over 197,504 triplet slots, ``lin_rbf1`` at K = 6, bias-free layers,
   N = 1 heads, PAINN's and PNAEq's ``[E, 3, F]`` inputs), timed at the new
   kinds of shape (``quant_stack_kernel_phase``);
13. MLIP serving: the trained EGNN, PAINN and MACE potentials behind
   ``PredictionServer`` (head outputs, no forces), 512 requests each, the
   captured answers bit-equal to the eager predict step, exact launches;
14. the trained GIN written as a training run writes it and registered
   with ``add_model_from_checkpoint``: bit-equal to the live endpoint
   (``checkpoint_phase``); then the fleet (``fleet_phase``), fp32 and int8:
   two replica processes on the card booted from that checkpoint behind a
   ``FleetRouter``, answers bit-equal to one in-process server's, cache
   hits byte-identical, 0 captures after ready, the canary accepting an
   identical model and refusing a perturbed one, 512 requests through the
   router with one replica killed mid-stream and none lost, p50/p99 and
   graphs/s beside the one server's.

The script imports only ``hydragnn_tpu_torch``, torch and numpy, and needs no
network. ``--quant-diagnostics`` adds to phase 10, for every model, the
certified bound with one Dense quantized at a time and the feature norms'
running variances, and the int8 step calibrated and certified on the whole
training split against the whole traffic (measured, not gated).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
QM9_CONFIG = ROOT / "examples" / "qm9" / "qm9.json"

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# dense int8 TOP/s and fp8 TFLOP/s of the tensor cores (kernels B6 and B7)
INT8_OPS = 1979e12

# tolerances of the kernel-vs-plain comparison: fp32 sums differ only in
# the order of additions (the plain version's index_add_ uses atomics on
# the card); bf16 outputs may differ by one bf16 rounding of those sums
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=1e-2, atol=1e-2)}
# the served answers must equal Predictor.outputs on the same padded batch:
# the kernels use no atomics and run in the same order on the same inputs
SERVE_ATOL = 0.0
# the card's fp32 forward against the port's CPU route on the same batch:
# float32 sums in another order across four conv layers and the heads
CPU_PARITY = dict(rtol=1e-4, atol=1e-5)
# quantized serving: warm-up certifies per-head bounds on its calibration
# batches (the largest training samples each bucket admits, one per batch).
# Batch independence: a sample's answers do not depend on the other graphs
# of its batch, so the calibration samples, served among the traffic, keep
# within the bounds; 1e-6 absorbs fp32 rounding of answers of size ~1
QUANT_CALIB_ATOL = 1e-6
# a certified bound above the config's quant_tol (0.1) must be refused: no
# int8 step kept, start() raises. One trained model is refused under the
# reference's contract (one per-tensor activation scale per Dense, 4
# single-sample calibration batches; ROADMAP queue C): the qm9 GIN, certified
# at 0.372717 on an H100 in every run (its training on the card is
# deterministic). Its refusal is accepted on the card only within
# QUANT_REFUSAL_RTOL of that bound, and it then serves int8 at quant_tol =
# that bound x (1 + QUANT_REFUSAL_RTOL). Any other refusal fails the run.
# The others pinned the same way: PAINN, PNAEq, DimeNet (PR 12) and the
# MPTrj EGNN with film (PR 14, its per-atom energy head)
QUANT_KNOWN_REFUSALS = {"gin": 0.372717, "painn": 0.446247, "pnaeq": 0.439453,
                        "dimenet": 58111.42, "mptrj_film": 0.708577}
# int8 codes card against CPU (quant_serving_phase): the GIN, GAT and
# GPS-GIN flip none, the ten newer stacks none on real rows, except these,
# whose Dense inputs pass through functions that CUDA and the CPU round
# ulps apart before any int8 layer (SchNet's Gaussian exp and shifted
# softplus, PNAEq's log-degree scalers and std): a code on a rounding
# boundary moves,
# and the moved layer's output moves the codes after it. For them the gate
# is the answers within CPU_PARITY, the fp32 forward's own card-vs-CPU
# tolerance, and the flips are counted in the log
INT8_INPUT_FLIPS = {"schnet", "pnaeq"}
# the same cause through GPS's four layers of attention: GPS-PNA's
# std and log-degree scalers (layer 0's post_nn is the first Dense whose
# input differs) and the performer's exp features. A moved code there moves
# the answers by more than CPU_PARITY (GPS-PNA's by 5.1e-3 on an H100), so
# their gate is every flipped code on real rows one step from
# the CPU's (a rounding boundary, not a kernel fault) and the answers within
# the certified per-head int8 bounds; the flips are logged
INT8_GPS_INPUT_FLIPS = {"gps_pna_edge", "gps_performer"}
QUANT_REFUSAL_RTOL = 0.02
# one fp32 train step on the card, held tensor by tensor against an fp64 run
# of the same step on the CPU: each parameter's gradient may miss the fp64
# one by at most 8 x the fp32 rounding of that tensor, the larger of what
# the CPU's fp32 route and the card's own step with the plain versions in
# place of the kernels miss it by, or, where both land closer, by 8 x 1e-5
# of the tensor's largest fp64 gradient. Gradients are sums in another
# order through four conv layers, batch norm and the heads, and one that
# nearly cancels carries the rounding of the large terms it cancels: GAT's
# attention gradients sum s * (dy - sum_seg s * dy) over ~20k entries, and
# on the H100 the card's fp32 step misses the fp64 one there by up to 5e-4
# of the tensor's largest gradient with the kernels or without them, the
# CPU's by 1e-6; one draw of such rounding is a loose estimate of its size
# (the card with the kernels misses GAT's layer-2 lin_l.bias gradient by
# 3.6 x what it misses it by with the plain versions). The plain versions
# on the card sum with atomics (index_add_), so their rounding varies from
# call to call (GAT's layer-2 attention vector: 5.3e-7 in one call, over
# 1.5e-6 in others, against the kernels' fixed 5.6e-6): the card's plain
# step is drawn STEP_PLAIN_DRAWS times and each tensor takes the largest
# of its errors. The parameters after the first AdamW step, which moves each by
# lr * g / (|g| + 1e-8), agree with the CPU route's to 1e-3 * lr wherever
# |g| exceeds ten times the largest card-vs-CPU gradient difference, and
# elsewhere (gradients at the noise level, which that step follows in sign)
# to 2 * lr, further than one step moves a parameter
STEP_GRAD_TOL = dict(atol_of_max=1e-5, noise_factor=8.0)
STEP_PLAIN_DRAWS = 4
# epochs of the full-width training runs: the one cut of qm9.json's config
TRAIN_EPOCHS = 6
# the three configurations of the main paths: qm9.json, its GAT row
# (bench.py ARCH_SWEEP_OVERRIDES "GAT", no override at hidden 64) and the
# GPS knobs of bench.py's gps_gin_dense; max_graph_nodes is derived from
# the data as update_config derives it (32 for molecules of 9-29 atoms)
MODELS = {
    "gin": {},
    "gat": {"mpnn_type": "GAT"},
    "gps": {"global_attn_engine": "GPS", "global_attn_type": "multihead",
            "global_attn_heads": 4, "pe_dim": 4},
}
# the six invariant stacks at qm9.json's widths, with the per-stack knobs of
# bench.py's arch sweep (ARCH_SWEEP_OVERRIDES); CGCNN's width is its input's
# (update_config, as the reference forces it without GPS). They train and
# serve like the three above, without the int8 phase
STACKS = {
    "sage": {"mpnn_type": "SAGE"},
    "mfc": {"mpnn_type": "MFC", "max_neighbours": 20},
    "schnet": {"mpnn_type": "SchNet", "num_gaussians": 20, "num_filters": 64},
    "pna": {"mpnn_type": "PNA"},
    "pnaplus": {"mpnn_type": "PNAPlus", "num_radial": 5, "envelope_exponent": 5},
    "cgcnn": {"mpnn_type": "CGCNN"},
}
# the four geometric stacks at qm9.json's widths with bench.py's arch-sweep
# knobs (ARCH_SWEEP_OVERRIDES): PAINN and PNAEq at hidden 32, DimeNet at 64
# (its samples get their triplets in preprocessing), MACE at hidden 32.
# They train and serve like the stacks above
GEOMETRIC = {
    "painn": {"mpnn_type": "PAINN", "num_radial": 6, "hidden_dim": 32},
    "pnaeq": {"mpnn_type": "PNAEq", "num_radial": 6, "hidden_dim": 32},
    "dimenet": {"mpnn_type": "DimeNet", "num_radial": 6, "num_spherical": 7,
                "int_emb_size": 64, "basis_emb_size": 8, "out_emb_size": 64,
                "num_before_skip": 1, "num_after_skip": 2, "envelope_exponent": 5},
    "mace": {"mpnn_type": "MACE", "max_ell": 1, "node_max_ell": 1, "correlation": 2,
             "num_radial": 6, "radial_type": "bessel", "hidden_dim": 32},
}
# edge features and the GPS variants at qm9.json's widths: GAT with
# the edge lengths (Dataset.compute_edge_lengths) as its edge feature
# (lin_edge, the self loops' mean edge feature); GPS-PNA with the edge
# lengths and relative-PE edge encodings (rel_pos_emb, edge_emb,
# edge_lin) and GPS-GIN's attention knobs; GPS-GIN with performer
# attention. They train, serve and serve int8 like the three above
EDGE_KINDS = {
    "gat_edge": {"mpnn_type": "GAT", "edge_features": ["length"]},
    "gps_pna_edge": {"mpnn_type": "PNA", "edge_features": ["length"],
                     **MODELS["gps"]},
    "gps_performer": {**MODELS["gps"], "global_attn_type": "performer"},
}
# the skeleton's options (PR 14) on qm9.json at its published widths:
# the GIN with GaussianNLLLoss (variance outputs), the GAT with
# conv_checkpointing and its dropout. They train, serve and serve int8 like
# the kinds above (the GAT's checkpointed training must give the GAT's own
# trained model, bit for bit)
QM9_OPTIONS = {"gin_nll": {}, "gat_ckpt": {"mpnn_type": "GAT"}}
TRAINING_KNOBS = {"gin_nll": {"loss_function_type": "GaussianNLLLoss"},
                  "gat_ckpt": {"conv_checkpointing": True}}
# two published blocks on their own data (OWN_DATA: config and samples):
# examples/multidataset/train.py's two-branch GIN, which trains, serves and
# serves int8 like the qm9 kinds, and examples/mptrj/train.py's EGNN MLIP
# with film conditioning, which trains and serves as the MLIPs do, and
# serves int8
MULTIBRANCH_KINDS = {"gfm_branches": {"mpnn_type": "GIN"}}
ARCH_KNOBS = {**MODELS, **STACKS, **GEOMETRIC, **EDGE_KINDS, **QM9_OPTIONS,
              **MULTIBRANCH_KINDS}
# the kind whose launch counts a kind's forward follows
BASE_KIND = {"gin_nll": "gin", "gat_ckpt": "gat", "gfm_branches": "gin"}
# the kinds that recompute each conv layer's forward in the backward
CHECKPOINTED = {"gat_ckpt"}
# the Dataset keys a kind adds to qm9_config's in-memory set
DATASET_KNOBS = {"gat_edge": {"compute_edge_lengths": True},
                 "gps_pna_edge": {"compute_edge_lengths": True}}
# the other new combinations, each at 2 conv layers with its stack's knobs
# above: the seven other edge stacks with the edge lengths, and GPS
# (multihead, GPS-GIN's attention knobs) around eleven more convs. Each is
# checked on the card by variant_phase (a captured train step bit-equal to
# eager, the fp32 forward against the CPU route, launches equal to the CPU
# route's launcher calls), not trained
_STACK_KNOBS = {**STACKS, **GEOMETRIC, "egnn": {"mpnn_type": "EGNN"}, "gat": MODELS["gat"]}
VARIANTS = {
    **{f"edge_{k}": ({**_STACK_KNOBS[k], "edge_features": ["length"], "num_conv_layers": 2},
                     {"compute_edge_lengths": True})
       for k in ("pnaplus", "cgcnn", "schnet", "egnn", "painn", "pnaeq", "dimenet")},
    **{f"gps_{k}": ({**_STACK_KNOBS[k], **MODELS["gps"], "num_conv_layers": 2}, {})
       for k in ("sage", "mfc", "schnet", "pnaplus", "cgcnn", "egnn", "painn", "pnaeq",
                 "dimenet", "mace", "gat")},
    # PR 14: concat_node and fuse_pool conditioning on the GIN, CGCNN (its
    # width rule) and MACE (its collected outputs), film under GPS-GIN, on
    # two graph attributes per molecule; two node-head branches of output
    # dim 3 on molecules of two datasets
    **{f"{m}_{k}": ({**_STACK_KNOBS.get(k, {}), "num_conv_layers": 2,
                     "use_graph_attr_conditioning": True,
                     "graph_attr_conditioning_mode": m.replace("fuse", "fuse_pool")
                     .replace("concat", "concat_node")}, {})
       for m in ("concat", "fuse") for k in ("gin", "cgcnn", "mace")},
    "film_gps": ({**MODELS["gps"], "num_conv_layers": 2, "use_graph_attr_conditioning": True,
                  "graph_attr_conditioning_mode": "film"}, {}),
    "node_branches": ({"num_conv_layers": 2, "task_weights": [1.0], "output_heads": {
        "node": [{"type": f"branch-{i}", "architecture": {
            "num_headlayers": 2, "dim_headlayers": [64, 64], "type": "mlp"}}
                 for i in range(2)]}}, {}),
}
# the variants' graph attributes per molecule (conditioning), and the
# node-branch variant's targets: 3 per node, dataset ids 0 and 1 in turn
VARIANT_GRAPH_ATTR = 2
VARIANT_VOI = {"node_branches": {"input_node_features": [0], "output_index": [0],
                                 "type": ["node"], "output_dim": [3],
                                 "denormalize_output": False}}
# the stacks that gather node rows onto the edges (gather_rows, backward
# B2) and sum the messages with B2: their segment sums per layer (the
# others' neighbour sum is the gather-scatter kernel B1, GAT's aside)
EDGE_SUM_STACKS = {"pna": 3, "pnaplus": 3, "cgcnn": 1}
GAT_HEADS = 6  # the reference GAT stack's fixed head count
# the CSR views a predict step of each model reads (GAT: its extended
# receivers, self loops included), and the ones its backward adds (PAINN
# and PNAEq sum at the senders; DimeNet mixes triplets over idx_ji, its
# backward over idx_kj; MACE gathers its element embedding by z)
CSR_FORWARD = {"gat": ("loop_receivers", "batch"), "painn": ("senders", "batch"),
               "pnaeq": ("senders", "batch"), "dimenet": ("receivers", "idx_ji", "batch"),
               "gat_edge": ("loop_receivers", "receivers", "batch")}
CSR_BACKWARD = {"gat": ("loop_senders",), "painn": ("receivers",), "pnaeq": ("receivers",),
                "dimenet": ("senders", "idx_kj"), "mace": ("senders", "elements"),
                "gat_edge": ("loop_senders",)}
for _kind in ARCH_KNOBS:
    CSR_FORWARD.setdefault(_kind, CSR_FORWARD.get(BASE_KIND.get(_kind), ("receivers", "batch")))
    CSR_BACKWARD.setdefault(_kind, CSR_BACKWARD.get(BASE_KIND.get(_kind), ("senders",)))
# Dense calls per served batch at the configurations above (the GIN, GAT
# and GPS-GIN, the ten stacks, and the oc20 MLIPs of mlip_config): one B6
# launch each on an int8 endpoint. MFC's per-degree banks are not Dense
# (its 5 are the heads'); bias-free, N = 1 and 3-D calls count alike.
# tests/test_torch_quant_stacks.py holds these against the CPU route's
# quant_dense calls
QUANT_DENSE_CALLS = {"gin": 13, "gat": 13, "gps": 40, "sage": 13, "mfc": 5, "schnet": 21,
                     "pna": 17, "pnaplus": 25, "cgcnn": 13, "painn": 44, "pnaeq": 60,
                     "dimenet": 93, "mace": 22, "mlip": 20, "mlip-painn": 32, "mlip-mace": 16,
                     "gat_edge": 17, "gps_pna_edge": 56, "gps_performer": 40,
                     "gin_nll": 13, "gat_ckpt": 13, "gfm_branches": 14, "mptrj_film": 25}
KERNELS = ("gather_scatter_sum", "gather_scatter_sum_bwd", "segment_sum", "segment_softmax",
           "masked_softmax", "cell_list", "quant_dense", "fp8_dense")
# bench.py's oc20 row (bench_oc20: MLIP_CONFIG with radius 5.0 and
# max_neighbours 40; fp32, since bf16 under a gradient of a gradient loses
# force accuracy), the north-star workload of BASELINE.json
MLIP_CONFIG = {
    "Verbosity": {"level": 0},
    "Dataset": {
        "name": "bench_oc20",
        "format": "unit_test",
        "node_features": {"name": ["type"], "dim": [1], "column_index": [0]},
        "graph_features": {"name": ["energy"], "dim": [1], "column_index": [0]},
    },
    "NeuralNetwork": {
        "Architecture": {
            "mpnn_type": "EGNN", "radius": 5.0, "max_neighbours": 40, "hidden_dim": 64,
            "num_conv_layers": 3, "equivariance": True, "enable_interatomic_potential": True,
            "activation_function": "silu", "energy_weight": 1.0, "energy_peratom_weight": 0.0,
            "force_weight": 10.0, "graph_pooling": "add",
            "output_heads": {"graph": {"num_sharedlayers": 1, "dim_sharedlayers": 32,
                                       "num_headlayers": 2, "dim_headlayers": [64, 64]}},
            "task_weights": [1.0],
        },
        "Variables_of_interest": {"input_node_features": [0], "output_index": [0],
                                  "type": ["graph"], "denormalize_output": False},
        "Training": {"num_epoch": 1, "batch_size": 64, "loss_function_type": "mse",
                     "precision": "fp32",
                     "Optimizer": {"type": "AdamW", "learning_rate": 1e-3}},
    },
}
# examples/oc20/train.py's Architecture block (--arch PAINN or MACE): the
# interatomic potentials of the geometric stacks, trained on the oc20 row's
# data (MLIP_SAMPLES cells, max_neighbours 40, fp32, batch 64)
OC20_ARCH = {
    "radius": 5.0, "max_neighbours": 100, "hidden_dim": 32, "num_conv_layers": 3,
    "equivariance": True, "enable_interatomic_potential": True, "activation_function": "silu",
    "energy_weight": 1.0, "energy_peratom_weight": 0.0, "force_weight": 25.0,
    "graph_pooling": "add", "num_gaussians": 32, "num_filters": 32, "num_radial": 6,
    "max_ell": 2, "node_max_ell": 1, "correlation": 2,
    "output_heads": {"node": {"num_headlayers": 2, "dim_headlayers": [32, 32], "type": "mlp"}},
    "task_weights": [1.0],
}
MLIP_ARCHS = ("PAINN", "MACE")
MLIP_SAMPLES = 256  # bench_oc20: max(batch * 4, 128) configurations, seed 11
MLIP_EPOCHS = 8  # the one cut of the MLIP run: num_epoch
# MLIP MD: the trained EGNN on one 1,000-atom LJ cell (box 38 A, the
# training lattice and density); 16 edge slots per atom (~6 are within 5.0)
MLIP_MD_CELLS = 10
MLIP_MD_EDGES_PER_ATOM = 16
MLIP_MD_STEPS = 200
MLIP_MD_DT = 1e-3
MD_CPU_STEPS = 10  # MLIP MD steps held against the port's CPU route
# MLIP MD starts from velocities 0.1 N(0, 1) (k_B T ~ 0.01 epsilon), from the
# seed, so that its first steps move the atoms ~1e-3 A: the comparison with
# the CPU route then sees the forces act
MLIP_MD_V0 = 0.1
# forces held against their plain versions and the CPU route, velocities
# after MD_CPU_STEPS steps against the CPU route: max |difference| within
# this share of the largest |force| or |velocity|
MD_RTOL = 1e-5
MD_POS_TOL = 1e-4  # A, positions after MD_CPU_STEPS steps against the CPU route
# analytic-LJ MD: bench_md's lattice (8,000 atoms, spacing 2.2, cutoff 3.0,
# 60 edge slots per atom, the cell list)
LJ_MD_CUTOFF = 3.0
LJ_MD_EDGES_PER_ATOM = 60
LJ_MD_STEPS = 100
LJ_MD_DT = 1e-3
# the tier-1 canaries' GIN (tests/test_config.py CI_CONFIG, with the
# learning rate and epochs of tests/test_training_e2e.py)
CANARY_CONFIG = {
    "Verbosity": {"level": 0},
    "Dataset": {
        "name": "unit_test_singlehead",
        "format": "unit_test",
        "node_features": {"name": ["type", "x", "x2", "x3"], "dim": [1, 1, 1, 1],
                          "column_index": [0, 1, 2, 3]},
        "graph_features": {"name": ["sum"], "dim": [1], "column_index": [0]},
    },
    "NeuralNetwork": {
        "Architecture": {
            "mpnn_type": "GIN", "radius": 2.0, "max_neighbours": 100, "hidden_dim": 8,
            "num_conv_layers": 2,
            "output_heads": {"graph": {"num_sharedlayers": 2, "dim_sharedlayers": 4,
                                       "num_headlayers": 2, "dim_headlayers": [10, 10]}},
            "task_weights": [1.0],
        },
        "Variables_of_interest": {"input_node_features": [0], "output_names": ["sum"],
                                  "output_index": [0], "type": ["graph"],
                                  "denormalize_output": False},
        "Training": {"num_epoch": 100, "perc_train": 0.7, "loss_function_type": "mse",
                     "batch_size": 16, "Optimizer": {"type": "AdamW", "learning_rate": 0.02}},
    },
}
# the canaries and their reference thresholds: (samples, data seed, epochs,
# head RMSE, sample MAE or None, heads held to them). GIN and GAT:
# tests/test_training_e2e.py (GAT at hidden 8); GPS-GIN:
# tests/test_gps.py::test_gps_end_to_end_training (the graph head's RMSE)
CANARIES = {
    "gin_single_head": (500, 7, 100, 0.25, 0.20, None),
    "gin_four_heads": (500, 7, 100, 0.25, 0.20, None),
    "gat": (500, 7, 100, 0.60, 0.70, None),
    "gps_gin": (200, 19, 30, 0.35, None, 1),
    # tests/test_training_e2e.py::test_invariant_arch_convergence: the 4-head
    # configuration with ARCH_OVERRIDES, at THRESHOLDS on every head
    "sage": (500, 7, 100, 0.20, 0.20, None),
    "mfc": (500, 7, 100, 0.20, 0.30, None),
    "schnet": (500, 7, 100, 0.20, 0.20, None),
    "pna": (500, 7, 100, 0.20, 0.20, None),
    "pnaplus": (500, 7, 100, 0.20, 0.20, None),
    "cgcnn": (500, 7, 100, 0.50, 0.40, None),
    # the geometric stacks, the same way
    "painn": (500, 7, 100, 0.60, 0.60, None),
    "pnaeq": (500, 7, 100, 0.60, 0.60, None),
    "dimenet": (500, 7, 100, 0.50, 0.50, None),
    "mace": (500, 7, 100, 0.60, 0.70, None),
    # GAT with the edge lengths at GAT's thresholds; GPS-PNA with the
    # edge lengths and the GPS performer in the GPS-GIN canary's form
    "gat_edge": (500, 7, 100, 0.60, 0.70, None),
    "gps_pna_edge": (200, 19, 30, 0.35, None, 1),
    "gps_performer": (200, 19, 30, 0.35, None, 1),
    # PR 14: the 4-head GIN with its node heads of type mlp_per_node (on
    # BCC graphs of one size, 2 x 2 x 1 cells: the type needs one), at
    # gin_four_heads' thresholds, and of type conv
    "gin_per_node": (500, 7, 100, 0.25, 0.20, None),
    # the JAX package misses those thresholds with conv node heads on the
    # CPU (RMSE up to 0.2892, MAE up to 0.2468; tests/canary_readings.py):
    # held at 1.25 x its largest CPU readings
    "gin_conv_heads": (500, 7, 100, 0.36, 0.31, None),
}
# deterministic_graph_data's keywords of a canary's data besides the count
# and seed
CANARY_DATA = {"gin_per_node": {"unit_cell_x_range": (2, 3), "unit_cell_y_range": (2, 3)}}
# the node-head type of the 4-head GIN's canaries
CANARY_NODE_TYPE = {"gin_per_node": "mlp_per_node", "gin_conv_heads": "conv"}
# tests/test_training_e2e.py ARCH_OVERRIDES of those ten canaries
CANARY_OVERRIDES = {
    "sage": {"mpnn_type": "SAGE"},
    "mfc": {"mpnn_type": "MFC", "max_neighbours": 20},
    "schnet": {"mpnn_type": "SchNet", "num_gaussians": 20, "num_filters": 16},
    "pna": {"mpnn_type": "PNA"},
    "pnaplus": {"mpnn_type": "PNAPlus", "num_radial": 5, "envelope_exponent": 5},
    "cgcnn": {"mpnn_type": "CGCNN"},
    "painn": {"mpnn_type": "PAINN", "num_radial": 6, "hidden_dim": 8},
    "pnaeq": {"mpnn_type": "PNAEq", "num_radial": 6, "hidden_dim": 8},
    "dimenet": {"mpnn_type": "DimeNet", "num_radial": 6, "num_spherical": 7, "int_emb_size": 32,
                "basis_emb_size": 8, "out_emb_size": 16, "num_before_skip": 1,
                "num_after_skip": 2, "envelope_exponent": 5},
    "mace": {"mpnn_type": "MACE", "max_ell": 1, "node_max_ell": 1, "correlation": 2,
             "num_radial": 6, "radial_type": "bessel", "hidden_dim": 8},
}


def log(msg: str) -> None:
    print(msg, flush=True)


# the geometric stacks' segment sums per conv layer of a forward: PAINN's
# scalar and vector messages at the senders; PNAEq's mean, the std's two
# means and the vector messages; DimeNet's output sum at the receivers (its
# triplet mixing is one gather-scatter launch); MACE's l = 0 and l = 1
# message sums (qm9's node_max_ell 1)
GEOMETRIC_SUMS = {"painn": 2, "pnaeq": 4, "dimenet": 1, "mace": 2}


def launches_per_forward(kind: str, layers: int) -> dict:
    """Kernel launches of one predict step (a served or evaluated batch):
    the mean pooling's segment sum, and per conv layer GAT's softmax and
    aggregation (with edge features also the self loops' mean edge
    feature), one gather-scatter (the B1 stacks; GPS adds its masked
    softmax, the performer its two per-graph sums), or the segment sums of
    the edge-message stacks (PNA and PNAPlus: the mean and the std's two
    means; CGCNN: the sum). A kind of ``BASE_KIND`` launches as its base:
    variance outputs, checkpointing and branches add no kernel to a
    forward."""
    kind = BASE_KIND.get(kind, kind)
    if kind == "mptrj_film":
        return mlip_launches_per_predict(layers, "EGNN")
    want = dict.fromkeys(KERNELS, 0)
    want["segment_sum"] = 1  # the mean pooling
    if kind in GEOMETRIC_SUMS:
        want["segment_sum"] += GEOMETRIC_SUMS[kind] * layers
        want["gather_scatter_sum"] = layers if kind == "dimenet" else 0
    elif kind in ("gat", "gat_edge"):
        want["segment_softmax"] = layers
        # each layer's [E', 6, F] aggregation; with edge features also the
        # self loops' mean edge feature: its [E, 1] sum and the degree
        want["segment_sum"] += layers * (3 if kind == "gat_edge" else 1)
    elif kind == "gps_pna_edge":
        want["segment_sum"] += EDGE_SUM_STACKS["pna"] * layers
        want["masked_softmax"] = layers
    elif kind == "gps_performer":
        # the GIN's neighbour sum, and the performer's per-graph kv and z
        want["gather_scatter_sum"] = layers
        want["segment_sum"] += 2 * layers
    elif kind in EDGE_SUM_STACKS:
        want["segment_sum"] += EDGE_SUM_STACKS[kind] * layers
    else:
        want["gather_scatter_sum"] = layers
        if kind == "gps":
            want["masked_softmax"] = layers
    return want


def launches_per_train_step(kind: str, layers: int) -> dict:
    """Kernel launches of one train step: the forward's, plus the backward's
    segment sums (GAT: one per softmax and one per gather of node features
    onto the entries; PNA, PNAPlus, CGCNN: one per gather of node rows onto
    the edges, by receiver and by sender, in each layer whose input needs a
    gradient) or transposed gather-scatter of each conv layer whose input
    needs a gradient (GIN, SAGE, MFC: not layer 0, which reads the raw
    features; GPS-GIN: every layer, layer 0 reads the learned embedding;
    SchNet: every layer, whose sum reads lin1 of its input). The backward
    of a segment sum is a gather, no launch. Under ``conv_checkpointing``
    (``CHECKPOINTED``) the backward recomputes every conv layer's forward
    first: its launches once more (all but the pooling's)."""
    if kind in CHECKPOINTED:
        base = BASE_KIND[kind]
        recompute = launches_per_forward(base, layers)
        recompute["segment_sum"] -= 1  # the pooling is no conv's
        return _added(launches_per_train_step(base, layers), recompute)
    kind = BASE_KIND.get(kind, kind)
    want = launches_per_forward(kind, layers)
    if kind in GEOMETRIC_SUMS:
        # the gathers' backward sums: PAINN's scalar MLP by receiver (every
        # layer) and vector channel (not layer 0's, which starts at 0);
        # PNAEq's features by sender and receiver and its vector channel
        # (not layer 0's); DimeNet's embedded nodes by sender and receiver
        # (every layer: lin_node sits in front) and the triplet mixing's
        # transposed launch; MACE's sender features (one block on layer 0,
        # l = 0 and 1 later) and element embedding (every layer)
        want["segment_sum"] += {"painn": 2 * layers - 1, "pnaeq": 3 * (layers - 1),
                                "dimenet": 2 * layers, "mace": 3 * layers - 1}[kind]
        if kind == "dimenet":
            want["gather_scatter_sum_bwd"] = layers
    elif kind in ("gat", "gat_edge"):
        # each softmax's backward sum, and the backward of the two gathers
        # (by sender, by receiver) of each layer (the self loops' edge
        # feature reads the batch: no gradient)
        want["segment_sum"] += 3 * layers
    elif kind == "gps_pna_edge":
        # the two gathers of node rows onto the edges, in every layer: GPS's
        # embedding is learned, so layer 0's input needs a gradient too
        want["segment_sum"] += 2 * layers
    elif kind == "gps_performer":
        # the transposed gather-scatter of every layer, and the backward of
        # the gathers of kv and z back to the nodes
        want["gather_scatter_sum_bwd"] = layers
        want["segment_sum"] += 2 * layers
    elif kind in EDGE_SUM_STACKS:
        want["segment_sum"] += 2 * (layers - 1)
    else:
        want["gather_scatter_sum_bwd"] = layers if kind in ("gps", "schnet") else layers - 1
    return want


def _scaled(counts: dict, k: int) -> dict:
    return {name: n * k for name, n in counts.items()}


def _added(*counts: dict) -> dict:
    return {name: sum(c[name] for c in counts) for name in KERNELS}


def qm9_like_samples(n: int, seed: int, radius: float, max_neighbours: int, pe_dim: int = 0):
    """``n`` QM9-sized molecules: 9-29 atoms uniform in a 6 Å box, ``Z`` in
    1..9 as the one node feature (and as the raw atomic numbers collate
    keeps before the features are normalised: MACE's element embedding), a
    random graph target, radius graphs from the port's ``radius_graph``;
    with ``pe_dim``, the Laplacian positional encodings a GPS request
    carries."""
    from hydragnn_tpu_torch.graphs.graph import GraphSample
    from hydragnn_tpu_torch.graphs.radius import radius_graph
    from hydragnn_tpu_torch.preprocess.encodings import attach_lap_pe

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        na = int(rng.integers(9, 30))
        pos = rng.uniform(0.0, 6.0, size=(na, 3))
        z = rng.integers(1, 10, size=(na, 1)).astype(np.float32)
        s, r, sh = radius_graph(pos, radius=radius, max_neighbours=max_neighbours)
        sample = GraphSample(x=z, pos=pos, senders=s, receivers=r, edge_shifts=sh,
                             graph_y=rng.normal(size=(1,)),
                             extras={"atomic_numbers": z[:, 0].copy()})
        out.append(attach_lap_pe(sample, pe_dim) if pe_dim else sample)
    return out


# examples/multidataset/train.py's data: make_synthetic's stores at
# --configs GFM_CONFIGS (branch b: GFM_CONFIGS // (b + 1) BCC graphs of
# seed 100 + b, targets times 1 + b); --epochs' default; batch 64 where the
# example's --batch default is 4 (a CPU dry run's), the batch of the qm9
# kinds, whose step checks collate 64 graphs
GFM_CONFIGS = 512
GFM_EPOCHS = 3
GFM_BATCH = 64
# examples/mptrj/train.py's data: make_synthetic at its --configs default
# (150 periodic LJ crystals of 2 x 2 x 2 cells, displacement 0.05, seed 13,
# O/Al/Si/Fe-like labels), its --epochs and --batch defaults (no cut); the
# (charge, spin) graph attributes drawn per structure (charge -1, 0 or 1,
# spin 1 or 2) where MPTrj's are all (0, 1): a spread gives film something
# to act on
MPTRJ_CONFIGS = 150
MPTRJ_EPOCHS = 10
MPTRJ_BATCH = 8


def gfm_config() -> dict:
    """``examples/multidataset/train.py``'s block (lines 99-140): GIN,
    radius 2.0, hidden 32, 3 conv layers, two graph branches of 1 x 16
    shared and 2 x 32 head layers, mse, AdamW lr 5e-3; fp32."""
    branch = {"num_sharedlayers": 1, "dim_sharedlayers": 16, "num_headlayers": 2,
              "dim_headlayers": [32, 32]}
    return {
        "Verbosity": {"level": 0},
        "Dataset": {"name": "multidataset_gfm", "format": "in_memory",
                    "node_features": {"name": ["type", "x", "x2", "x3"], "dim": [1, 1, 1, 1],
                                      "column_index": [0, 1, 2, 3]},
                    "graph_features": {"name": ["sum"], "dim": [1], "column_index": [0]}},
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "GIN", "radius": 2.0, "hidden_dim": 32, "num_conv_layers": 3,
                "output_heads": {"graph": [{"type": f"branch-{i}", "architecture": dict(branch)}
                                           for i in range(2)]},
                "task_weights": [1.0],
            },
            "Variables_of_interest": {"input_node_features": [0], "output_index": [0],
                                      "type": ["graph"]},
            "Training": {"num_epoch": GFM_EPOCHS, "batch_size": GFM_BATCH,
                         "loss_function_type": "mse",
                         "Optimizer": {"type": "AdamW", "learning_rate": 0.005}},
        },
    }


def gfm_samples(seed: int = 0):
    """``make_synthetic``'s two branch datasets, tagged by
    ``concat_multidataset`` (fixed seeds, as the example's)."""
    from hydragnn_tpu_torch.datasets import deterministic_graph_data
    from hydragnn_tpu_torch.train.multibranch import concat_multidataset

    sets = []
    for b in range(2):
        ds = deterministic_graph_data(number_configurations=max(4, GFM_CONFIGS // (b + 1)),
                                      seed=100 + b)
        for s in ds:
            s.graph_y = (1.0 + b) * s.graph_y
            s.extras["graph_table"] = (1.0 + b) * np.asarray(s.extras["graph_table"])
        sets.append(ds)
    return concat_multidataset(sets)


def mptrj_config() -> dict:
    """``examples/mptrj/train.py``'s block (lines 119-178, ``--arch EGNN``,
    energy per atom): EGNN, radius 5.0, 100 neighbours, hidden 32, 3 conv
    layers, equivariance, silu, add pooling, a node head of 2 x 32, energy
    per atom weight 1 and force weight 25, film conditioning on the graph
    attributes, AdamW lr 5e-3, batch 8, fp32."""
    return {
        "Verbosity": {"level": 0},
        "Dataset": {"name": "mptrj", "format": "in_memory", "normalize": False,
                    "node_features": {"name": ["atomic_number"], "dim": [1],
                                      "column_index": [0]},
                    "graph_features": {"name": ["energy"], "dim": [1], "column_index": [0]}},
        "NeuralNetwork": {
            "Architecture": {
                "mpnn_type": "EGNN", "radius": 5.0, "max_neighbours": 100, "hidden_dim": 32,
                "num_conv_layers": 3, "equivariance": True,
                "enable_interatomic_potential": True, "activation_function": "silu",
                "energy_weight": 0.0, "energy_peratom_weight": 1.0, "force_weight": 25.0,
                "graph_pooling": "add", "use_graph_attr_conditioning": True,
                "graph_attr_conditioning_mode": "film", "num_gaussians": 32,
                "num_filters": 32, "num_radial": 6, "max_ell": 2, "node_max_ell": 1,
                "correlation": 2,
                "output_heads": {"node": {"num_headlayers": 2, "dim_headlayers": [32, 32],
                                          "type": "mlp"}},
                "task_weights": [1.0],
            },
            "Variables_of_interest": {"input_node_features": [0], "output_index": [0],
                                      "type": ["node"], "output_dim": [1],
                                      "denormalize_output": False},
            "Training": {"num_epoch": MPTRJ_EPOCHS, "batch_size": MPTRJ_BATCH,
                         "perc_train": 0.8, "loss_function_type": "mse", "prefetch": 2,
                         "Optimizer": {"type": "AdamW", "learning_rate": 0.005}},
        },
    }


def mptrj_samples(seed: int = 0, n: int = MPTRJ_CONFIGS):
    """``make_synthetic``'s crystals: LJ geometry and energetics, element
    labels O/Al/Si/Fe drawn per site (seed 13, as the example), and (charge,
    spin) graph attributes drawn per structure from ``seed``."""
    from hydragnn_tpu_torch.datasets import lennard_jones_data

    samples = lennard_jones_data(number_configurations=n, cells_per_dim=2, seed=13,
                                 relative_maximum_atomic_displacement=0.05)
    rng = np.random.default_rng(13)
    elements = np.array([8, 13, 14, 26], np.float32)
    attrs = np.random.default_rng(seed + 1000)
    for s in samples:
        z = rng.choice(elements, size=(s.x.shape[0], 1))
        s.x = np.concatenate([z, s.x[:, 1:]], axis=1).astype(np.float32)
        nt = np.asarray(s.extras["node_table"], np.float32)
        s.extras["node_table"] = np.concatenate([z, nt[:, 1:]], axis=1)
        s.graph_attr = np.array([attrs.integers(-1, 2), attrs.integers(1, 3)], np.float32)
    return samples


# the kinds on their own data: (config, samples of a seed)
OWN_DATA = {"gfm_branches": (gfm_config, gfm_samples),
            "mptrj_film": (mptrj_config, mptrj_samples)}


def qm9_config(kind: str = "gin") -> dict:
    """``examples/qm9/qm9.json`` with the ``kind``'s architecture overrides
    (``ARCH_KNOBS`` or ``VARIANTS``) and its dataset replaced by the
    in-memory QM9-like set (same node and graph features), with the kind's
    ``DATASET_KNOBS`` (the edge lengths) and ``TRAINING_KNOBS``; a kind of
    ``OWN_DATA`` has its own block."""
    from hydragnn_tpu_torch.config import load_config

    if kind in OWN_DATA:
        return OWN_DATA[kind][0]()
    cfg = load_config(str(QM9_CONFIG))
    cfg["Dataset"] = {
        "name": f"qm9_like_in_memory_{kind}",
        "format": "in_memory",
        "node_features": cfg["Dataset"]["node_features"],
        "graph_features": cfg["Dataset"]["graph_features"],
    }
    if kind in VARIANTS:
        arch_knobs, dataset_knobs = VARIANTS[kind]
    else:
        arch_knobs, dataset_knobs = ARCH_KNOBS[kind], DATASET_KNOBS.get(kind, {})
    cfg["Dataset"].update(dataset_knobs)
    cfg["NeuralNetwork"]["Architecture"].update(arch_knobs)
    cfg["NeuralNetwork"]["Training"].update(TRAINING_KNOBS.get(kind, {}))
    if kind in VARIANT_VOI:
        cfg["NeuralNetwork"]["Variables_of_interest"] = copy.deepcopy(VARIANT_VOI[kind])
    return cfg


def raw_samples(seed: int, kind: str = "gin", n_samples: int = 512):
    """The kind's molecules as a user hands them over, before preprocessing
    (with GPS's encodings, which requests carry; with graph attributes
    where the kind conditions on them; with three targets per node and
    dataset ids 0 and 1 in turn for the node-branch variant); a kind of
    ``OWN_DATA``'s own samples."""
    if kind in OWN_DATA:
        return OWN_DATA[kind][1](seed)
    arch = qm9_config(kind)["NeuralNetwork"]["Architecture"]
    samples = qm9_like_samples(n_samples, seed, float(arch["radius"]),
                               int(arch["max_neighbours"]), int(arch.get("pe_dim") or 0))
    rng = np.random.default_rng(seed + 2000)
    for i, s in enumerate(samples):
        if arch.get("use_graph_attr_conditioning"):
            s.graph_attr = rng.normal(size=(VARIANT_GRAPH_ATTR,)).astype(np.float32)
        if kind in VARIANT_VOI:
            s.node_y = rng.normal(size=(s.num_nodes, 3)).astype(np.float32)
            s.dataset_id = i % 2
    return samples


def prepare(seed: int, kind: str = "gin", n_samples: int = 512):
    """(raw config, augmented config, loaders, samples) of one model."""
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

    cfg = qm9_config(kind)
    samples = raw_samples(seed, kind, n_samples)
    loaders = dataset_loading_and_splitting(copy.deepcopy(cfg), samples=samples)
    aug = update_config(copy.deepcopy(cfg), *(ld.samples for ld in loaders))
    return cfg, aug, loaders, samples


# -- phase 1: device -----------------------------------------------------------


def device_phase(torch) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {name} x{count}; nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"float32_matmul_precision={torch.get_float32_matmul_precision()} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return {"kind": name, "count": count, "smi": smi}


# -- phase 2: build ----------------------------------------------------------


def build_phase() -> None:
    from hydragnn_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.2f} s wall, one nvcc per source, started together")
    for source in _build.SOURCES:
        rec = _build.BUILD_LOG[source]
        log(f"  {source}: {rec['seconds']:.2f} s ({'cached' if rec['cached'] else 'built'}) "
            f"-> {rec['path']}")
        if not rec["cached"]:
            log(f"  nvcc: {rec['command']}")
            for line in rec["ptxas"].splitlines():
                log(f"  ptxas: {line}")


# -- phase 3: kernels against their plain versions ----------------------------


def graph_time_ms(torch, fn, iters: int = 50, reps: int = 5) -> float:
    """Device time of one ``fn()`` call: ``iters`` calls captured in a CUDA
    graph, the graph replayed between CUDA events; the median of ``reps``
    replays divided by ``iters``. No host launch cost is in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def event_time_ms(torch, fn, iters: int = 50, reps: int = 5) -> float:
    """Time of one ``fn()`` call where ``fn`` synchronises with the host and
    so cannot be captured in a CUDA graph: ``iters`` calls back to back
    between CUDA events, the median of ``reps`` windows divided by
    ``iters``. The host's work between launches is in the number."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def device_ops(torch, fn, reps: int = 100):
    """The device operations of one ``fn()`` call under ``torch.profiler``
    (after one warm-up call): ``(operations per call, device-busy µs per
    call, [(name, calls per fn() call, mean µs), ...] largest total first)``,
    or ``(None, None, [])`` where the profiler traced no device event. A
    profiling session after the process's first may drop its first events
    (seen on the card: up to ~20), so counts per call are rounded over
    ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        return None, None, []
    by_name: dict = {}
    for e in events:
        count, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (count + 1, us + e.time_range.elapsed_us())
    rows = sorted(((name, round(count / reps), us / count) for name, (count, us)
                   in by_name.items() if round(count / reps)), key=lambda r: -r[1] * r[2])
    return sum(c for _, c, _ in rows), sum(c * us for _, c, us in rows), rows


def log_device_ops(label: str, ops, busy_us, rows, graph_us: float) -> None:
    """One line per device operation of :func:`device_ops`, beside the
    call's CUDA-graph replay time (what is not busy there is launch gaps)."""
    if ops is None:
        log(f"  {label}: the profiler traced no device event; operations not measured")
        return
    log(f"  {label}: {ops:g} device operations per call, device busy {busy_us:.2f} us of the "
        f"{graph_us:.2f} us CUDA-graph replay time per call")
    for name, count, us in rows:
        log(f"    {count:g} x {us:.2f} us  {name[:110]}")


def bucket_batches(loaders, samples, batch_size: int = 64):
    """Two collated batches of ``batch_size`` training samples: at the top
    pad bucket of the serving table (the path's largest N and E) and, for
    the log, the first training batch that fits the smallest bucket (the
    common case), or None."""
    from hydragnn_tpu_torch.graphs.batching import collate, compute_pad_buckets, pick_bucket

    buckets = compute_pad_buckets(samples, batch_size, max_buckets=4)
    train = loaders[0].samples
    top = collate(train[:batch_size], buckets[-1])
    for k in range(0, len(train) - batch_size + 1, batch_size):
        chunk = train[k : k + batch_size]
        tot = (sum(x.num_nodes for x in chunk), sum(x.num_edges for x in chunk))
        if pick_bucket(buckets, *tot) == buckets[0]:
            return top, collate(chunk, buckets[0])
    return top, None


def _compare(torch, name, got, want, rows, dtype_name) -> float:
    """``got`` against ``want`` on their first ``rows`` rows (an int) or on
    the rows a boolean mask selects."""
    tol = TOL[dtype_name]
    g = (got[:rows] if isinstance(rows, int) else got[rows]).float()
    w = (want[:rows] if isinstance(rows, int) else want[rows]).float()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: kernel output not finite")
    err = float((g - w).abs().max()) if g.numel() else 0.0
    ok = bool(torch.allclose(g, w, **tol))
    log(f"  {name}: max|kernel-plain|={err:.3e} (rtol={tol['rtol']}, atol={tol['atol']}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the plain version")
    return err


def _bit_stable(torch, name, fn) -> None:
    a, b = fn(), fn()
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: two launches on the same inputs differ")


# -- the CSR kernels' order of additions (B1, B2) ---------------------------------

# the CSR kernels add a row of several pieces as this many strided chains
# (chain w: the row's pieces w, w + 8, w + 16, ...), then the chain sums in
# chain order
CSR_CHAINS = 8


def _bits(torch, t):
    """The raw bits of a float tensor, so -0.0 and NaN compare exactly."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


@contextlib.contextmanager
def _one_thread(torch):
    """One CPU thread: the CPU's ``index_add_`` then adds in index order."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def csr_sum_emulation(torch, terms, ids, num_segments: int):
    """The CSR kernels' sum of the fp32 per-entry ``terms [E, C]`` by ``ids``
    into ``num_segments`` rows, emulated in fp32 on the CPU in the kernels'
    fixed order. Each row's entries, in stable-sorted order, are cut into
    pieces of ``PIECE_EDGES`` counted from the row's first entry; each piece
    adds its entries left to right from +0. A row of one piece (empty rows
    included) is that sum; a row of more adds its pieces in ``CSR_CHAINS``
    strided chains, each left to right from +0, then the chain sums left to
    right from +0. Zeros added for padding change nothing: a sum that starts
    at +0 is never -0. Returns fp32 ``[num_segments, C]``."""
    from hydragnn_tpu_torch.ops.fused_scatter import PIECE_EDGES

    terms, ids = terms.float().cpu(), ids.long().cpu()
    e, c = terms.shape
    order = torch.argsort(ids, stable=True)
    t = terms[order]
    ptr = torch.searchsorted(ids[order], torch.arange(num_segments + 1))
    lens = ptr[1:] - ptr[:-1]
    pieces = torch.clamp((lens + PIECE_EDGES - 1) // PIECE_EDGES, min=1)
    piece_ptr = torch.cat([torch.zeros(1, dtype=torch.long), torch.cumsum(pieces, 0)])
    row = torch.repeat_interleave(torch.arange(num_segments), pieces)
    k = torch.arange(row.shape[0]) - piece_ptr[row]
    beg = ptr[row] + k * PIECE_EDGES
    end = torch.minimum(ptr[row + 1], beg + PIECE_EDGES)
    part = torch.zeros(row.shape[0], c)
    zero = torch.zeros(())
    for j in range(PIECE_EDGES):
        pos = beg + j
        live = (pos < end)[:, None]
        part = part + torch.where(live, t[pos.clamp(max=max(e - 1, 0))] if e else zero, zero)
    out = part[piece_ptr[:-1]].clone()  # rows of one piece: their only piece's sum
    multi = torch.nonzero(pieces > 1).flatten()
    if multi.numel():
        p0, n = piece_ptr[multi], pieces[multi]
        chains = torch.zeros(multi.shape[0], CSR_CHAINS, c)
        w = torch.arange(CSR_CHAINS)
        for step in range(-(-int(n.max()) // CSR_CHAINS)):
            idx = step * CSR_CHAINS + w[None, :]  # [M, chains]
            live = (idx < n[:, None])[..., None]
            src = part[(p0[:, None] + idx).clamp(max=part.shape[0] - 1)]
            chains = chains + torch.where(live, src, zero)
        total = torch.zeros(multi.shape[0], c)
        for k_ in range(CSR_CHAINS):
            total = total + chains[:, k_]
        out[multi] = total
    return out


def check_csr_exact(torch, label: str, got, plain, terms, ids, num_segments: int,
                    failures: list) -> None:
    """A CSR kernel's output ``got`` (on the card) held bit for bit against
    ``plain``, the port's plain version on the CPU with one thread, on every
    row of at most ``PIECE_EDGES`` entries, and against
    :func:`csr_sum_emulation` of the fp32 ``terms`` on every row. A mismatch
    is logged and appended to ``failures``."""
    from hydragnn_tpu_torch.ops.fused_scatter import PIECE_EDGES

    got = got.cpu()
    counts = torch.bincount(ids.long().cpu(), minlength=num_segments)[:num_segments]
    single = counts <= PIECE_EDGES
    emu = csr_sum_emulation(torch, terms, ids, num_segments).to(got.dtype)
    eq_plain = (_bits(torch, got) == _bits(torch, plain.cpu())).all(dim=-1)
    eq_emu = (_bits(torch, got) == _bits(torch, emu)).all(dim=-1)
    ok_single = bool(eq_plain[single].all())
    ok_multi = bool(eq_emu.all())
    log(f"  {label}: {int(single.sum())} rows of <= {PIECE_EDGES} entries "
        f"{'bit-equal' if ok_single else 'DIFFER'} to the CPU plain version "
        f"({int((~eq_plain[single]).sum())} differ); all {num_segments} rows "
        f"({int((~single).sum())} of several pieces, longest {int(counts.max())} entries) "
        f"{'bit-equal' if ok_multi else 'DIFFER'} to the fixed-order emulation "
        f"({int((~eq_emu).sum())} differ)")
    if not (ok_single and ok_multi):
        failures.append(label)


def csr_exact_checks(torch, b, mlip_b, gen, failures: list) -> None:
    """B2 (every shape of its main paths) and B1 (forward and transposed
    launch), fp32 and bf16, over the path's CSR views and over the same
    entries shuffled (the wrapper argsorts), bit for bit (:func:`check_csr_exact`)."""
    from hydragnn_tpu_torch.ops import fused_scatter as fs

    dev = b.x.device
    n, g = b.num_nodes, b.num_graphs
    _, loop_recv = b.self_loop_edges()
    mn, mg = mlip_b.num_nodes, mlip_b.num_graphs
    shapes = (
        ("pooling [N,64] -> G", lambda: torch.randn(n, 64, generator=gen), b.batch, g,
         b.csr("batch")),
        (f"GAT aggregation [E'={loop_recv.shape[0]},{GAT_HEADS * 64}] -> N",
         lambda: torch.randn(loop_recv.shape[0], GAT_HEADS * 64, generator=gen), loop_recv, n,
         b.csr("loop_receivers")),
        (f"softmax backward [E',{GAT_HEADS}] -> N",
         lambda: torch.randn(loop_recv.shape[0], GAT_HEADS, generator=gen), loop_recv, n,
         b.csr("loop_receivers")),
        (f"MLIP message sum [{mlip_b.num_edges},64] -> {mn}",
         lambda: torch.randn(mlip_b.num_edges, 64, generator=gen), mlip_b.receivers, mn,
         mlip_b.csr("receivers")),
        (f"MLIP pooling [{mn},64] -> {mg}", lambda: torch.randn(mn, 64, generator=gen),
         mlip_b.batch, mg, mlip_b.csr("batch")),
    )
    log(f"segment_sum bit for bit: rows of <= {fs.PIECE_EDGES} entries against the CPU plain "
        f"version (one thread), every row against the fixed-order emulation:")
    for label, make, ids, rows, index in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            x = make().to(dtype)
            got = fs.fused_segment_sum(x.to(dev), ids, rows, index=index)
            with _one_thread(torch):
                plain = fs.plain_segment_sum(x, ids.cpu(), rows)
            check_csr_exact(torch, f"{dname} {label}", got, plain, x.float(), ids, rows,
                            failures)
            p = torch.randperm(x.shape[0], generator=gen)
            xs, ids_s = x[p], ids.cpu()[p]
            got = fs.fused_segment_sum(xs.to(dev), ids_s.to(dev), rows)
            with _one_thread(torch):
                plain = fs.plain_segment_sum(xs, ids_s, rows)
            check_csr_exact(torch, f"{dname} {label}, shuffled", got, plain, xs.float(), ids_s,
                            rows, failures)

    log("gather_scatter_sum (forward and transposed launch) bit for bit, the same way:")
    s_c, r_c = b.senders.cpu(), b.receivers.cpu()
    m_c = b.edge_mask.cpu()
    e = s_c.shape[0]
    for label, c, dtype, wk in (("fp32 C=64 edge-mask weight", 64, torch.float32, "mask"),
                                ("fp32 C=64 per-channel weight", 64, torch.float32, "chan"),
                                ("fp32 C=64 no weight", 64, torch.float32, None),
                                ("bf16 C=1 edge-mask weight", 1, torch.bfloat16, "mask"),
                                ("bf16 C=64 edge-mask weight", 64, torch.bfloat16, "mask")):
        h = torch.randn(n, c, generator=gen).to(dtype)
        w = (m_c.to(dtype) if wk == "mask" else None if wk is None
             else (torch.rand(e, c, generator=gen) * m_c[:, None]).to(dtype))
        wf = None if w is None else (w.float() if w.dim() == 2 else w.float()[:, None])
        for transposed in (False, True):
            src, dst = (r_c, s_c) if transposed else (s_c, r_c)
            terms = h.float()[src.long()]
            if wf is not None:
                terms = terms * wf
            w_d = None if w is None else w.to(dev)
            if transposed:
                got = fs.gather_scatter_sum_bwd(h.to(dev), b.senders, b.receivers, n, w_d,
                                                b.csr("senders"))
            else:
                got = fs.gather_scatter_sum(h.to(dev), b.senders, b.receivers, n, weight=w_d,
                                            index=b.csr("receivers"))
            with _one_thread(torch):
                plain = fs.plain_gather_scatter_sum(h, src, dst, n, w)
            check_csr_exact(torch, f"{label}{', transposed (senders view)' if transposed else ''}",
                            got, plain, terms, dst, n, failures)
    p = torch.randperm(e, generator=gen)
    h = torch.randn(n, 64, generator=gen)
    got = fs.gather_scatter_sum(h.to(dev), b.senders[p.to(dev)], b.receivers[p.to(dev)], n,
                                weight=b.edge_mask[p.to(dev)])
    with _one_thread(torch):
        plain = fs.plain_gather_scatter_sum(h, s_c[p], r_c[p], n, m_c[p])
    check_csr_exact(torch, "fp32 C=64 edge-mask weight, shuffled", got, plain,
                    h[s_c[p].long()] * m_c[p][:, None], r_c[p], n, failures)


def _xor_butterfly_sum(t):
    """A warp's xor butterfly sum (offsets 16, 8, 4, 2, 1) of ``t [..., 32,
    ...]`` over dim 1, as every lane ends it: lane l adds lane l ^ o to its
    value at each step, and fp32 addition commutes, so lanes l and l ^ o
    hold the same bits and the first o lanes carry the sum."""
    for o in (16, 8, 4, 2, 1):
        t = t[:, :o] + t[:, o:2 * o]
    return t[:, 0]


def segment_softmax_emulation(torch, logits, ids, num_segments: int):
    """Kernel B3's segment softmax in its fixed order, emulated with torch
    on ``logits``' device (the card's ``torch.exp`` must give nvcc's
    ``expf`` bits for it to match). Each segment's entries, in stable-sorted
    order, are cut into pieces of ``PIECE_EDGES`` counted from its first
    entry. A piece takes, per head, its max ``m`` (-inf for an empty
    piece), ``ex = exp(x - fz(m))`` with ``fz`` the not-finite-to-0 rule,
    and the xor butterfly sum ``s`` of its ``ex``. A segment of one piece
    writes ``ex / max(s, 1e-12)``. A longer segment takes ``M = fz(max_p
    m_p)``; lane l adds ``s_p * exp(fz(m_p) - M)`` (each product rounded,
    ``s_p > 0`` only) over its pieces l, l + 32, ... left to right from +0,
    the lanes are summed by the butterfly, and every entry writes ``exp(x -
    M) / max(S, 1e-12)``. fp32 inside; returns ``logits.dtype``."""
    from hydragnn_tpu_torch.ops.fused_scatter import PIECE_EDGES

    dev = logits.device
    x = logits.float()
    e, h = x.shape
    ids = ids.long().to(dev)
    order = torch.argsort(ids, stable=True)
    ptr = torch.searchsorted(ids[order], torch.arange(num_segments + 1, device=dev))
    lens = ptr[1:] - ptr[:-1]
    pieces = torch.clamp((lens + PIECE_EDGES - 1) // PIECE_EDGES, min=1)
    piece_ptr = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                           torch.cumsum(pieces, 0)])
    row = torch.repeat_interleave(torch.arange(num_segments, device=dev), pieces)
    beg = ptr[row] + (torch.arange(row.shape[0], device=dev) - piece_ptr[row]) * PIECE_EDGES
    pos = beg[:, None] + torch.arange(PIECE_EDGES, device=dev)[None, :]  # [P, 32]
    live = pos < torch.minimum(ptr[row + 1], beg + PIECE_EDGES)[:, None]
    entry = order[pos.clamp(max=max(e - 1, 0))]  # [P, 32]
    inf = torch.tensor(float("inf"), device=dev)
    zero = torch.zeros((), device=dev)

    def fz(m):
        return torch.where(m.abs() < inf, m, zero)

    xp = torch.where(live[..., None], x[entry], -inf)  # [P, 32, H]
    m_p = xp.amax(dim=1)  # [P, H]
    ex = torch.where(live[..., None], torch.exp(xp - fz(m_p)[:, None]), zero)
    s_p = _xor_butterfly_sum(ex)
    out = torch.empty_like(x)
    single = pieces[row] == 1  # [P]
    vals = ex / torch.clamp(s_p, min=1e-12)[:, None]
    out[entry[single][live[single]]] = vals[single][live[single]]
    multi = torch.nonzero(pieces > 1).flatten()
    if multi.numel():
        p0, n = piece_ptr[multi], pieces[multi]
        row_max = torch.full((num_segments, h), -float("inf"), device=dev).scatter_reduce(
            0, row[:, None].expand(-1, h), m_p, reduce="amax")
        shift = fz(row_max[multi])  # [R, H]
        lanes = torch.zeros(multi.shape[0], 32, h, device=dev)
        lane = torch.arange(32, device=dev)
        for step in range(-(-int(n.max()) // 32)):
            j = step * 32 + lane[None, :]  # [R, 32]: the piece lane l adds now
            p = (p0[:, None] + j).clamp(max=m_p.shape[0] - 1)
            term = s_p[p] * torch.exp(fz(m_p[p]) - shift[:, None])
            keep = (j < n[:, None])[..., None] & (s_p[p] > 0)
            lanes = lanes + torch.where(keep, term, zero)
        denom = torch.clamp(_xor_butterfly_sum(lanes), min=1e-12)  # [R, H]
        slot = torch.full((num_segments,), -1, dtype=torch.long, device=dev)
        slot[multi] = torch.arange(multi.shape[0], device=dev)
        sel = torch.nonzero(slot[ids] >= 0).flatten()  # the entries of those segments
        r = slot[ids[sel]]
        out[sel] = torch.exp(x[sel] - shift[r]) / denom[r]
    return out.to(logits.dtype)


def segment_softmax_cases(torch, b, gen):
    """B3's inputs at every shape the kernel phase checks, on ``b``'s
    device: ``[(label, logits, ids, num_segments, index or None)]``: GAT's
    self-loop layout in fp32 and bf16 (the dummy row N-1 owns every pad
    edge and alignment slot, at logit -1e9), the same entries shuffled (the
    wrapper argsorts), and odd segments folded onto the even ones below them
    (real segments of two rows, so of several pieces where they are long)
    beside a segment of only -inf logits."""
    dev = b.x.device
    n, e = b.num_nodes, b.num_edges
    _, loop_recv = b.self_loop_edges()
    e_ext = loop_recv.shape[0]
    e_mask = torch.cat([b.edge_mask, b.edge_mask.new_zeros(e_ext - e - n),
                        b.edge_mask.new_ones(n)])

    def gat_logits(dtype):
        x = torch.randn(e_ext, GAT_HEADS, generator=gen).to(dev) * 3.0
        return torch.where(e_mask[:, None] > 0, x, -1e9).to(dtype)

    cases = [(f"{str(dtype).split('.')[1]} GAT layout", gat_logits(dtype), loop_recv, n,
              b.csr("loop_receivers")) for dtype in (torch.float32, torch.bfloat16)]
    p = torch.randperm(e_ext, generator=gen).to(dev)
    cases.append(("float32 shuffled entries", gat_logits(torch.float32)[p], loop_recv[p], n,
                  None))
    ids_e = (loop_recv // 2) * 2
    x_e = torch.where((ids_e == 10)[:, None], float("-inf"), gat_logits(torch.float32))
    cases.append(("float32 empty odd segments and an all -inf segment", x_e, ids_e, n, None))
    return cases


def segment_softmax_exact_checks(torch, cases, failures: list) -> None:
    """B3 bit for bit on every entry (the dummy row included) of ``cases``
    (:func:`segment_softmax_cases`) against :func:`segment_softmax_emulation`
    on the card. A mismatch is logged and appended to ``failures``."""
    from hydragnn_tpu_torch.ops import fused_softmax as fsm

    log("segment_softmax bit for bit on every entry against its fixed-order emulation (torch "
        "on the card):")
    for label, x, ids, n, index in cases:
        got = fsm.segment_softmax(x, ids, n, index=index)
        emu = segment_softmax_emulation(torch, x, ids, n)
        diff = int((_bits(torch, got) != _bits(torch, emu)).sum())
        log(f"  {label} [{x.shape[0]},{x.shape[1]}] -> {n}: {diff} of {got.numel()} values "
            f"differ from the emulation {'ok' if diff == 0 else 'MISMATCH'}")
        if diff:
            failures.append(f"segment_softmax {label}")


def _check_masked_softmax(torch, label: str, x, valid, errs: list) -> None:
    """B4 against its plain version on ``x [G, ..., m]`` with the per-graph
    mask ``valid [G, m]``: within ``TOL``, masked entries of rows with any
    valid entry exactly 0, the rows of fully masked graphs uniform ``1/m``,
    two launches bit-identical."""
    from hydragnn_tpu_torch.ops import fused_softmax as fsm

    dname = str(x.dtype).split(".")[1]
    m = x.shape[-1]
    got = fsm.masked_softmax(x, valid)
    want = fsm.plain_masked_softmax(x, valid)
    errs.append(_compare(torch, label, got, want, x.shape[0], dname))
    live = valid.any(dim=1)
    masked = (~valid)[:, None, None, :].expand_as(got)
    if bool(got[live][masked[live]].any()):
        raise AssertionError(f"masked_softmax {label}: a masked entry of a real row is not 0")
    if not torch.allclose(got[~live].float(), torch.full_like(got[~live].float(), 1 / m),
                          **TOL[dname]):
        raise AssertionError(f"masked_softmax {label}: fully masked rows are not uniform")
    _bit_stable(torch, f"masked_softmax {label}", lambda: fsm.masked_softmax(x, valid))


def kernel_phase(torch, batch, small=None, n_max: int = 32, timing: bool = True,
                 mlip_batch=None):
    """Every kernel of the serving and training paths against its plain
    version on the card, at ``batch``'s shapes (timed there and, for the
    log, at the ``small`` batch of the smallest bucket); ``n_max`` is GPS's
    dense-attention width; ``mlip_batch`` is the oc20 MLIP training batch,
    whose segment sums the CSR kernels' bit-for-bit checks and times cover
    too (on the card). Returns
    the kernels' JSON entries and their device times per call (ms), or
    ``([], {})`` without ``timing``."""
    from hydragnn_tpu_torch.ops import fused_scatter as fs
    from hydragnn_tpu_torch.ops import fused_softmax as fsm

    dev = torch.device("cuda") if timing else torch.device("cpu")
    # the bit-for-bit checks of B1 and B2 (failures collected, raised after
    # the times)
    exact_failures: list = []
    b = batch.to(dev)
    n, e, g = b.num_nodes, b.num_edges, b.num_graphs
    gen = torch.Generator(device="cpu").manual_seed(1234)
    real_e, real_n = int(b.edge_mask.sum()), int(b.node_mask.sum())
    log(f"kernels at N={n} E={e} G={g} (top pad bucket, collated receivers sorted="
        f"{b.meta.recv_sorted}): {real_e} real edges, {e - real_e} pad edges on row N-1, "
        f"{real_n} real nodes, {n - real_n} pad nodes in the dummy graph")
    recv_idx = b.csr("receivers")
    batch_idx = b.csr("batch")
    mask = b.edge_mask
    real_rows = n - 1  # row N-1 is the reserved dummy row of the pad edges

    def feats(c, dtype):
        return torch.randn(n, c, generator=gen).to(dev, dtype)

    results = {}

    # kernel 1: gather -> scale -> scatter-add over the receiver CSR
    cases = [
        ("fp32 C=64 edge-mask weight", 64, torch.float32, "mask"),
        ("fp32 C=64 per-channel weight", 64, torch.float32, "chan"),
        ("fp32 C=64 no weight", 64, torch.float32, None),
        ("bf16 C=1 edge-mask weight", 1, torch.bfloat16, "mask"),
        ("bf16 C=64 edge-mask weight", 64, torch.bfloat16, "mask"),
    ]
    log("gather_scatter_sum (replaces ops/fused_scatter.py:87 _kernel):")
    errs = []
    for label, c, dtype, wk in cases:
        h = feats(c, dtype)
        if wk == "mask":
            w = mask.to(dtype)
        elif wk == "chan":
            w = (torch.rand(e, c, generator=gen).to(dev) * mask[:, None]).to(dtype)
        else:
            w = None
        got = fs.gather_scatter_sum(h, b.senders, b.receivers, n, weight=w, index=recv_idx)
        want = fs.plain_gather_scatter_sum(h, b.senders, b.receivers, n, w)
        errs.append(_compare(torch, label, got, want, real_rows, str(dtype).split(".")[1]))
    # unsorted ids: the same edges in a random order (the wrapper argsorts)
    perm = torch.randperm(e, generator=gen).to(dev)
    h = feats(64, torch.float32)
    s_u, r_u, w_u = b.senders[perm], b.receivers[perm], mask[perm]
    got = fs.gather_scatter_sum(h, s_u, r_u, n, weight=w_u)
    want = fs.plain_gather_scatter_sum(h, s_u, r_u, n, w_u)
    errs.append(_compare(torch, "fp32 C=64 unsorted receivers", got, want, real_rows,
                         "float32"))
    # empty rows: every fourth node loses its incoming edges
    keep = (b.receivers % 4) != 0
    s_k, r_k, w_k = b.senders[keep], b.receivers[keep], mask[keep]
    got = fs.gather_scatter_sum(h, s_k, r_k, n, weight=w_k)
    want = fs.plain_gather_scatter_sum(h, s_k, r_k, n, w_k)
    errs.append(_compare(torch, "fp32 C=64 empty rows", got, want, real_rows, "float32"))
    if not bool((got[0::4][: real_rows // 4] == 0).all()):
        raise AssertionError("gather_scatter_sum: a row without edges is not 0")
    # long rows: the same edges onto 8 receivers (~2,200 edges, ~70 pieces
    # each), every row compared with an fp64 sum. The kernel's additions
    # nest at most 32 + 9 + 8 deep (piece, strided partials, warp sums), so
    # its fp32 error is below 49 * 2^-24 (3e-6) of the row's sum of |terms|
    # and 1e-5 of it is a safe bound
    r_long = torch.sort(torch.randint(0, 8, (e,), generator=gen).to(dev)).values.int()
    w_l = torch.rand(e, generator=gen).to(dev)
    got = fs.gather_scatter_sum(h, b.senders, r_long, n, weight=w_l)
    terms = h.double()[b.senders.long()] * w_l.double()[:, None]
    ref = torch.zeros(n, 64, dtype=torch.float64, device=dev).index_add_(0, r_long.long(), terms)
    scale = torch.zeros_like(ref).index_add_(0, r_long.long(), terms.abs())
    err = float((got.double() - ref).abs().max())
    ok = bool(((got.double() - ref).abs() <= 1e-5 * scale + 1e-6).all())
    log(f"  fp32 C=64 long rows (8 rows x ~{e // 8} edges) vs fp64: max|err|={err:.3e} "
        f"(bound 1e-5 * sum|terms| + 1e-6) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError("gather_scatter_sum: long rows disagree with the fp64 sum")
    results["gather_scatter_sum"] = max(errs)

    # kernel 1's transposed launch (the backward of conv layers 1-3): dout
    # gathered by receiver, scaled by the edge mask, summed onto senders over
    # the senders' CSR view, whose permutation the kernel follows and whose
    # row N-1 owns every pad edge
    send_idx = b.csr("senders")
    log(f"gather_scatter_sum_bwd (replaces the second launch of ops/fused_scatter.py:87 "
        f"_kernel, from _fused_bwd): senders sorted={b.meta.send_sorted}, "
        f"permutation {'yes' if send_idx.perm is not None else 'no'}, "
        f"{int(send_idx.piece_ptr[-1])} pieces")
    dout = feats(64, torch.float32)
    dh = fs.gather_scatter_sum_bwd(dout, b.senders, b.receivers, n, mask, send_idx)
    want = fs.plain_gather_scatter_sum(dout, b.receivers, b.senders, n, mask)
    results["gather_scatter_sum_bwd"] = _compare(
        torch, "fp32 C=64 edge-mask weight, senders' view", dh, want, real_rows, "float32")
    _bit_stable(torch, "gather_scatter_sum_bwd", lambda: fs.gather_scatter_sum_bwd(
        dout, b.senders, b.receivers, n, mask, send_idx))
    log("  two launches on the same inputs: bit-identical")
    schnet_gather_scatter_checks(torch, b, gen, real_rows)

    # kernel 2: segment sum over the graph CSR (pooling), the node CSR and
    # GAT's extended receivers (its [E', 6 * 64] aggregation)
    log("segment_sum (replaces ops/fused_scatter.py:378 _scatter_kernel):")
    errs = []
    nmask = b.node_mask[:, None]
    for label, c, dtype in (("fp32 [N,64] -> G", 64, torch.float32),
                            ("bf16 [N,64] -> G", 64, torch.bfloat16),
                            ("fp32 [N,1] -> G", 1, torch.float32)):
        x = (feats(c, torch.float32) * nmask).to(dtype)
        got = fs.fused_segment_sum(x, b.batch, g, index=batch_idx)
        want = fs.plain_segment_sum(x, b.batch, g)
        errs.append(_compare(torch, label, got, want, g - 1, str(dtype).split(".")[1]))
    x_e = torch.randn(e, 64, generator=gen).to(dev)
    got = fs.fused_segment_sum(x_e, b.receivers, n, index=recv_idx)
    want = fs.plain_segment_sum(x_e, b.receivers, n)
    errs.append(_compare(torch, "fp32 [E,64] -> N", got, want, real_rows, "float32"))
    ids_u = b.batch[torch.randperm(n, generator=gen).to(dev)]
    x = feats(64, torch.float32)
    got = fs.fused_segment_sum(x, ids_u, g)
    want = fs.plain_segment_sum(x, ids_u, g)
    errs.append(_compare(torch, "fp32 [N,64] -> G unsorted ids", got, want, g - 1,
                         "float32"))
    _, loop_recv = b.self_loop_edges()
    loop_idx = b.csr("loop_receivers")
    e_ext = loop_recv.shape[0]
    msgs = torch.randn(e_ext, GAT_HEADS * 64, generator=gen).to(dev)
    got = fs.fused_segment_sum(msgs, loop_recv, n, index=loop_idx)
    want = fs.plain_segment_sum(msgs, loop_recv, n)
    errs.append(_compare(torch, f"fp32 [E'={e_ext},{GAT_HEADS}x64] -> N (GAT aggregation, "
                         f"self-loop receivers)", got, want, real_rows, "float32"))
    results["segment_sum"] = max(errs)
    if dev.type == "cuda" and mlip_batch is not None:
        csr_exact_checks(torch, b, mlip_batch.to(dev), gen, exact_failures)

    # kernel 3: segment softmax over GAT's extended layout: real edges, the
    # alignment slots and the pad edges (logit -1e9, all on the dummy row
    # N-1), then one self loop per node; the receivers are not sorted
    sl_pad = e_ext - e - n
    e_mask = torch.cat([mask, mask.new_zeros(sl_pad), mask.new_ones(n)])
    real_entries = loop_recv != n - 1
    log(f"segment_softmax (replaces ops/fused_softmax.py:116 _softmax_kernel): E'={e_ext} "
        f"entries x {GAT_HEADS} heads ({e} edges, {sl_pad} alignment slots, {n} self loops), "
        f"{int(loop_idx.piece_ptr[-1])} pieces, the dummy row "
        f"{int(loop_idx.ptr[n] - loop_idx.ptr[n - 1])} entries in "
        f"{int(loop_idx.piece_ptr[n] - loop_idx.piece_ptr[n - 1])} pieces")

    def gat_logits(dtype):
        x = torch.randn(e_ext, GAT_HEADS, generator=gen).to(dev) * 3.0
        return torch.where(e_mask[:, None] > 0, x, -1e9).to(dtype)

    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        x = gat_logits(dtype)
        got = fsm.segment_softmax(x, loop_recv, n, index=loop_idx)
        want = fsm.plain_segment_softmax(x, loop_recv, n)
        errs.append(_compare(torch, f"{dname} GAT layout, entries of rows 0..N-2", got, want,
                             real_entries, dname))
        dummy = float((got[~real_entries].float() - want[~real_entries].float()).abs().max())
        log(f"    the dummy row's entries (not gated): max|kernel-plain|={dummy:.3e}")
        _bit_stable(torch, "segment_softmax", lambda: fsm.segment_softmax(
            x, loop_recv, n, index=loop_idx))
    log("  two launches on the same inputs: bit-identical")
    p = torch.randperm(e_ext, generator=gen).to(dev)
    x_u, ids_su = gat_logits(torch.float32)[p], loop_recv[p]
    got = fsm.segment_softmax(x_u, ids_su, n)
    want = fsm.plain_segment_softmax(x_u, ids_su, n)
    errs.append(_compare(torch, "fp32 shuffled entries (the wrapper argsorts)", got, want,
                         ids_su != n - 1, "float32"))
    # empty segments: odd ids fold onto the even ones below them (the dummy
    # row N-1 onto N-2), and segment 10 has only -inf logits (all 0 out)
    ids_e = (loop_recv // 2) * 2
    x_e6 = torch.where((ids_e == 10)[:, None], float("-inf"), gat_logits(torch.float32))
    got = fsm.segment_softmax(x_e6, ids_e, n)
    want = fsm.plain_segment_softmax(x_e6, ids_e, n)
    errs.append(_compare(torch, "fp32 empty odd segments and an all -inf segment", got, want,
                         ids_e < n - 2, "float32"))
    if bool(got[ids_e == 10].any()):
        raise AssertionError("segment_softmax: a segment of -inf logits is not 0")
    results["segment_softmax"] = max(errs)
    if dev.type == "cuda":
        segment_softmax_exact_checks(
            torch, segment_softmax_cases(torch, b, torch.Generator(device="cpu").manual_seed(1235)),
            exact_failures)

    # kernel 4: masked row softmax over GPS's dense blocks [G, heads, n, m]
    # with the per-graph validity mask [G, m]; the dummy graph (n_node 0)
    # gives fully masked rows
    valid = torch.arange(n_max, device=dev)[None, :] < b.n_node[:, None]
    log(f"masked_softmax (replaces ops/fused_softmax.py:334 _row_softmax_kernel): "
        f"[G={g}, heads=4, {n_max}, {n_max}], mask [G, {n_max}], "
        f"{int((b.n_node == 0).sum())} fully masked graph(s)")
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        x = (torch.randn(g, 4, n_max, n_max, generator=gen) * 3.0).to(dev, dtype)
        _check_masked_softmax(torch, f"{dname} all rows", x, valid, errs)
    log(f"  masked entries of real rows exactly 0; fully masked rows 1/{n_max}; two launches "
        f"on the same inputs bit-identical")
    # other widths (GPS's max_graph_nodes comes from the data), and a view
    # that starts 4 bytes past an aligned address
    for m_ in (1, 5, 31, 33, 64):
        lens = torch.randint(0, m_ + 1, (g,), generator=gen)
        lens[0], lens[-1] = m_, 0
        valid_m = (torch.arange(m_)[None, :] < lens[:, None]).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(g, 4, m_, m_, generator=gen) * 3.0).to(dev, dtype)
            _check_masked_softmax(torch, f"{str(dtype).split('.')[1]} m={m_}", x, valid_m, errs)
    # the view takes the kernel's general path, an aligned copy of it the
    # vectorised one where m allows: both add in one order, so the bits agree
    for dtype in (torch.float32, torch.bfloat16):
        flat = (torch.randn(g * 4 * n_max * n_max + 1, generator=gen) * 3.0).to(dev, dtype)
        view = flat[1:].view(g, 4, n_max, n_max)
        _check_masked_softmax(torch, f"{str(dtype).split('.')[1]} m={n_max}, view 1 element "
                              f"past an aligned start", view, valid, errs)
        if not torch.equal(fsm.masked_softmax(view, valid),
                           fsm.masked_softmax(view.clone(), valid)):
            raise AssertionError("masked_softmax: the aligned and the misaligned paths differ")
    log("  the misaligned view and its aligned copy: bit-identical")
    results["masked_softmax"] = max(errs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if not timing:
        return [], {}
    times = {}

    # times at the path's main shapes: conv layers 1-3 (fp32, C=64) for
    # kernel 1, the mean pooling (fp32 [N,64] -> G) for kernel 2
    h = feats(64, torch.float32)
    w = mask
    k1 = dict(
        ms=graph_time_ms(torch, lambda: fs.gather_scatter_sum(
            h, b.senders, b.receivers, n, weight=w, index=recv_idx)),
        plain_ms=graph_time_ms(torch, lambda: fs.plain_gather_scatter_sum(
            h, b.senders, b.receivers, n, w)),
    )
    # one-call yardstick: the same sum as a CSR sparse product A @ h with
    # A[r, s] = w over the receiver-sorted edges
    a_csr = torch.sparse_csr_tensor(recv_idx.ptr.long(), b.senders.long(), w.float(),
                                    size=(n, n))
    k1["library_ms"] = graph_time_ms(torch, lambda: torch.sparse.mm(a_csr, h))
    lib_err = float((torch.sparse.mm(a_csr, h) - fs.gather_scatter_sum(
        h, b.senders, b.receivers, n, weight=w, index=recv_idx))[:real_rows].abs().max())
    log(f"  yardstick torch.sparse.mm(CSR, h) max|diff| vs kernel = {lib_err:.3e}")
    k1_bytes = (n * 64 * 4) + (2 * e * 4) + (e * 4) + (n * 64 * 4)
    k1_ops = 2 * e * 64
    k1.update(shape=f"h[{n},64] f32, E={e}, w[E]", bytes=k1_bytes, ops=k1_ops)

    pooled_in = (feats(64, torch.float32) * nmask).contiguous()
    ids_long = b.batch.long()
    k2 = dict(
        ms=graph_time_ms(torch, lambda: fs.fused_segment_sum(
            pooled_in, b.batch, g, index=batch_idx)),
        plain_ms=graph_time_ms(torch, lambda: fs.plain_segment_sum(pooled_in, b.batch, g)),
        library_ms=graph_time_ms(torch, lambda: torch.zeros(
            g, 64, device=dev).index_add_(0, ids_long, pooled_in)),
    )
    k2_bytes = (n * 64 * 4) + (n * 4) + (g * 64 * 4)
    k2_ops = n * 64
    k2.update(shape=f"data[{n},64] f32 -> G={g}", bytes=k2_bytes, ops=k2_ops)
    # the other main shapes' times go beside the pooling row (filled below)

    # the transposed launch at conv layers 1-3's backward shapes
    kb = dict(
        ms=graph_time_ms(torch, lambda: fs.gather_scatter_sum_bwd(
            dout, b.senders, b.receivers, n, w, send_idx)),
        plain_ms=graph_time_ms(torch, lambda: fs.plain_gather_scatter_sum(
            dout, b.receivers, b.senders, n, w)),
    )
    # one-call yardsticks: the transposed CSR product A^T @ dout (rows =
    # senders), and index_add_ of the already gathered, scaled messages
    perm_l = send_idx.perm.long()
    at_csr = torch.sparse_csr_tensor(send_idx.ptr.long(), b.receivers.long()[perm_l],
                                     w.float()[perm_l], size=(n, n))
    kb["library_ms"] = graph_time_ms(torch, lambda: torch.sparse.mm(at_csr, dout))
    gathered = dout[b.receivers.long()] * w[:, None]
    send_long = b.senders.long()
    kb["index_add_ms"] = graph_time_ms(torch, lambda: torch.zeros(
        n, 64, device=dev).index_add_(0, send_long, gathered))
    lib_err = float((torch.sparse.mm(at_csr, dout) - dh)[:real_rows].abs().max())
    log(f"  yardstick torch.sparse.mm(transposed CSR, dout) max|diff| vs kernel = {lib_err:.3e}; "
        f"index_add_ of gathered messages {kb['index_add_ms'] * 1e3:.2f} us")
    kb.update(shape=f"dout[{n},64] f32, E={e}, w[E], senders' view", bytes=k1_bytes, ops=k1_ops)

    # B1 at SchNet's sum (fp32 h[N,64], weight per edge and channel [E,64]),
    # forward and its transposed launch; no one PyTorch call computes a sum
    # weighted per edge and channel
    w_ch = (torch.rand(e, 64, generator=gen).to(dev) * mask[:, None]).contiguous()
    ch_bytes = k1_bytes + e * 64 * 4 - e * 4
    for key, entry, fn, plain in (
        ("gather_scatter_sum_schnet", k1,
         lambda: fs.gather_scatter_sum(h, b.senders, b.receivers, n, weight=w_ch,
                                       index=recv_idx),
         lambda: fs.plain_gather_scatter_sum(h, b.senders, b.receivers, n, w_ch)),
        ("gather_scatter_sum_bwd_schnet", kb,
         lambda: fs.gather_scatter_sum_bwd(dout, b.senders, b.receivers, n, w_ch, send_idx),
         lambda: fs.plain_gather_scatter_sum(dout, b.receivers, b.senders, n, w_ch)),
    ):
        t_b = max(ch_bytes / HBM_BYTES_PER_S, k1_ops / FP32_FLOPS) * 1e3
        entry["schnet"] = dict(shape=f"[{n},64] f32, w[E={e},64]", ms=graph_time_ms(torch, fn),
                               plain_ms=graph_time_ms(torch, plain), bound_ms=t_b,
                               bound_by="bytes", library_ms=None)
        times[key + "_ms"] = entry["schnet"]["ms"]
        log(f"  {key} @ {entry['schnet']['shape']}: kernel {entry['schnet']['ms'] * 1e3:.2f} us, "
            f"plain {entry['schnet']['plain_ms'] * 1e3:.2f} us, bound {t_b * 1e3:.3f} us "
            f"({ch_bytes} B); no one-call yardstick")

    # kernel 3 at GAT's conv layers 1-3 (fp32 logits [E', 6])
    x_sm = gat_logits(torch.float32)
    loop_long = loop_recv.long()
    # one-call yardstick: torch.sparse.softmax over a COO tensor [N, E', 6]
    # that holds entry e at (receiver, e); unspecified entries count as
    # -inf, so each row's softmax over dim 1 is its segment's softmax. The
    # tensor is built and coalesced once, outside the timed call. The call
    # synchronises with the host (the card refuses it inside a CUDA graph
    # capture), so it is timed by CUDA events around back-to-back calls,
    # and the kernel's wrapper is timed that way beside it
    sp = torch.sparse_coo_tensor(torch.stack([loop_long, torch.arange(e_ext, device=dev)]),
                                 x_sm, (n, e_ext, GAT_HEADS)).coalesce()
    k3 = dict(
        ms=graph_time_ms(torch, lambda: fsm.segment_softmax(x_sm, loop_recv, n, index=loop_idx)),
        plain_ms=graph_time_ms(torch, lambda: fsm.plain_segment_softmax(x_sm, loop_recv, n)),
        # ~32 ms a call on the H100 (the dummy row's ~11.5k entries)
        library_ms=event_time_ms(torch, lambda: torch.sparse.softmax(sp, 1), iters=10, reps=3),
    )
    t_k3_events = event_time_ms(torch, lambda: fsm.segment_softmax(x_sm, loop_recv, n,
                                                                   index=loop_idx),
                                iters=10, reps=3)
    ops, busy, rows = device_ops(torch, lambda: fsm.segment_softmax(x_sm, loop_recv, n,
                                                                     index=loop_idx))
    log_device_ops(f"one segment_softmax call at [{e_ext},{GAT_HEADS}] f32 under torch.profiler",
                   ops, busy, rows, k3["ms"] * 1e3)
    k3["device_ops"] = ops
    lib = torch.sparse.softmax(sp, 1)
    lib_rows, lib_entries = lib.indices()
    lib_diff = lib.values() - fsm.segment_softmax(x_sm, loop_recv, n, index=loop_idx)[lib_entries]
    log(f"  yardstick torch.sparse.softmax(COO [N, E', {GAT_HEADS}], dim=1) max|diff| vs kernel "
        f"on the entries of rows 0..N-2 = {float(lib_diff[lib_rows != n - 1].abs().max()):.3e}; "
        f"timed by events around back-to-back calls: {k3['library_ms'] * 1e3:.2f} us, the "
        f"kernel's wrapper {t_k3_events * 1e3:.2f} us")
    k3_bytes = 2 * e_ext * GAT_HEADS * 4 + e_ext * 4
    k3_ops = 5 * e_ext * GAT_HEADS  # max, subtract, exp, add, divide per entry
    k3.update(shape=f"logits[{e_ext},{GAT_HEADS}] f32, N={n} segments (GAT self-loop layout)",
              bytes=k3_bytes, ops=k3_ops)
    # the segment sums around it: the [E', 6, 64] aggregation and the
    # softmax backward's [E', 6] sum, both over the same CSR view
    times["segment_sum_gat_agg_ms"] = graph_time_ms(torch, lambda: fs.fused_segment_sum(
        msgs, loop_recv, n, index=loop_idx))
    sdy = torch.randn(e_ext, GAT_HEADS, generator=gen).to(dev)
    times["segment_sum_gat_bwd_ms"] = graph_time_ms(torch, lambda: fs.fused_segment_sum(
        sdy, loop_recv, n, index=loop_idx))
    t_agg_lib = graph_time_ms(torch, lambda: torch.zeros(
        n, GAT_HEADS * 64, device=dev).index_add_(0, loop_long, msgs))
    x_sm16 = gat_logits(torch.bfloat16)
    t_sm16 = graph_time_ms(torch, lambda: fsm.segment_softmax(x_sm16, loop_recv, n,
                                                              index=loop_idx))
    log(f"  segment_sum @ [E'={e_ext},384] f32 -> N (GAT aggregation): kernel "
        f"{times['segment_sum_gat_agg_ms'] * 1e3:.2f} us, index_add_ {t_agg_lib * 1e3:.2f} us; "
        f"@ [E',6] (softmax backward): kernel {times['segment_sum_gat_bwd_ms'] * 1e3:.2f} us; "
        f"segment_softmax bf16 (GAT layer 0): {t_sm16 * 1e3:.2f} us")

    # kernel 2 at its four main shapes (fp32), each beside its one-call
    # yardstick (a zeroed output and index_add_) and its bound (data and ids
    # read once, the output written once); the pooling shape is the table's
    b2_cases = [("pooling", pooled_in, b.batch, g, batch_idx),
                ("GAT aggregation", msgs, loop_recv, n, loop_idx),
                ("softmax backward", sdy, loop_recv, n, loop_idx),
                ("edge messages (PNA, PNAPlus, CGCNN)", x_e, b.receivers, n, recv_idx)]
    if mlip_batch is not None:
        m_b = mlip_batch.to(dev)
        m_x = torch.randn(m_b.num_edges, 64, generator=gen).to(dev)
        b2_cases.append(("MLIP message sum", m_x, m_b.receivers, m_b.num_nodes,
                         m_b.csr("receivers")))
    b2_shapes = []
    for label, x, ids, n_rows, index in b2_cases:
        ids_l = ids.long()
        t_k = graph_time_ms(torch, lambda: fs.fused_segment_sum(x, ids, n_rows, index=index))
        t_lib = graph_time_ms(torch, lambda: torch.zeros(
            n_rows, x.shape[1], device=dev).index_add_(0, ids_l, x))
        nbytes = x.numel() * 4 + ids.shape[0] * 4 + n_rows * x.shape[1] * 4
        bound = max(nbytes / HBM_BYTES_PER_S, x.numel() / FP32_FLOPS) * 1e3
        b2_shapes.append(dict(shape=f"{label} [{x.shape[0]},{x.shape[1]}] f32 -> {n_rows}",
                              ms=t_k, library_ms=t_lib, bound_ms=bound,
                              pieces=int(index.piece_ptr[-1]),
                              longest_row=int((index.ptr[1:] - index.ptr[:-1]).max())))
        if label.startswith("edge messages"):
            times["segment_sum_edges_ms"] = t_k
        log(f"  segment_sum @ {b2_shapes[-1]['shape']}: kernel {t_k * 1e3:.2f} us, index_add_ "
            f"{t_lib * 1e3:.2f} us, bound {bound * 1e3:.3f} us ({nbytes} B); "
            f"{b2_shapes[-1]['pieces']} pieces, longest row {b2_shapes[-1]['longest_row']} "
            f"entries")

    # kernel 4 at GPS's layers 1-3 (fp32 logits [G, 4, n_max, n_max]); the
    # one-call yardstick is torch.softmax of the already masked logits
    x_ms = (torch.randn(g, 4, n_max, n_max, generator=gen) * 3.0).to(dev)
    premasked = torch.where(valid[:, None, None, :], x_ms, -1e9)
    k4 = dict(
        ms=graph_time_ms(torch, lambda: fsm.masked_softmax(x_ms, valid)),
        plain_ms=graph_time_ms(torch, lambda: fsm.plain_masked_softmax(x_ms, valid)),
        library_ms=graph_time_ms(torch, lambda: torch.softmax(premasked, dim=-1)),
    )
    rows = g * 4 * n_max
    k4_bytes = 2 * rows * n_max * 4 + g * n_max
    k4_ops = 5 * rows * n_max
    k4.update(shape=f"logits[{g},4,{n_max},{n_max}] f32, mask[{g},{n_max}]", bytes=k4_bytes,
              ops=k4_ops)
    lib_err = float((torch.softmax(premasked, dim=-1) - fsm.masked_softmax(x_ms, valid))
                    .abs().max())
    x_ms16 = x_ms.to(torch.bfloat16)
    premasked16 = premasked.to(torch.bfloat16)
    t_ms16 = graph_time_ms(torch, lambda: fsm.masked_softmax(x_ms16, valid))
    t_lib16 = graph_time_ms(torch, lambda: torch.softmax(premasked16, dim=-1))
    k4["bf16"] = dict(ms=t_ms16, library_ms=t_lib16,
                      bound_ms=(2 * rows * n_max * 2 + g * n_max) / HBM_BYTES_PER_S * 1e3)
    log(f"  yardstick torch.softmax(pre-masked logits) max|diff| vs kernel = {lib_err:.3e}; "
        f"masked_softmax bf16 (GPS layer 0): kernel {t_ms16 * 1e3:.2f} us, torch.softmax of "
        f"the pre-masked bf16 logits {t_lib16 * 1e3:.2f} us, bound "
        f"{k4['bf16']['bound_ms'] * 1e3:.3f} us")

    # conv layer 0 of the bf16 predict step: bf16, C = 1
    h0 = feats(1, torch.bfloat16)
    w0 = mask.to(torch.bfloat16)
    t_k = graph_time_ms(torch, lambda: fs.gather_scatter_sum(
        h0, b.senders, b.receivers, n, weight=w0, index=recv_idx))
    t_p = graph_time_ms(torch, lambda: fs.plain_gather_scatter_sum(
        h0, b.senders, b.receivers, n, w0))
    log(f"  gather_scatter_sum @ h[{n},1] bf16 (GIN conv layer 0): kernel {t_k * 1e3:.2f} us, "
        f"plain {t_p * 1e3:.2f} us")
    times["gather_scatter_sum_layer0_ms"] = t_k
    if small is not None:
        s_b = small.to(dev)
        sn, sg = s_b.num_nodes, s_b.num_graphs
        s_h = torch.randn(sn, 64, generator=gen).to(dev)
        s_idx, s_bidx = s_b.csr("receivers"), s_b.csr("batch")
        t_k = graph_time_ms(torch, lambda: fs.gather_scatter_sum(
            s_h, s_b.senders, s_b.receivers, sn, weight=s_b.edge_mask, index=s_idx))
        t_p = graph_time_ms(torch, lambda: fs.plain_gather_scatter_sum(
            s_h, s_b.senders, s_b.receivers, sn, s_b.edge_mask))
        t_k2 = graph_time_ms(torch, lambda: fs.fused_segment_sum(
            s_h, s_b.batch, sg, index=s_bidx))
        t_p2 = graph_time_ms(torch, lambda: fs.plain_segment_sum(s_h, s_b.batch, sg))
        _, s_loop = s_b.self_loop_edges()
        s_lidx = s_b.csr("loop_receivers")
        s_x = torch.randn(s_loop.shape[0], GAT_HEADS, generator=gen).to(dev)
        t_k3 = graph_time_ms(torch, lambda: fsm.segment_softmax(s_x, s_loop, sn, index=s_lidx))
        t_p3 = graph_time_ms(torch, lambda: fsm.plain_segment_softmax(s_x, s_loop, sn))
        log(f"  smallest bucket N={sn} E={s_b.num_edges}: gather_scatter_sum kernel "
            f"{t_k * 1e3:.2f} us / plain {t_p * 1e3:.2f} us; segment_sum kernel "
            f"{t_k2 * 1e3:.2f} us / plain {t_p2 * 1e3:.2f} us; segment_softmax kernel "
            f"{t_k3 * 1e3:.2f} us / plain {t_p3 * 1e3:.2f} us")

    entries = []
    for name, source, src_line, k in (
        ("gather_scatter_sum", "segment_reduce.cu", "hydragnn_tpu/ops/fused_scatter.py:87", k1),
        ("gather_scatter_sum_bwd", "segment_reduce.cu", "hydragnn_tpu/ops/fused_scatter.py:87",
         kb),
        ("segment_sum", "segment_reduce.cu", "hydragnn_tpu/ops/fused_scatter.py:378", k2),
        ("segment_softmax", "segment_softmax.cu", "hydragnn_tpu/ops/fused_softmax.py:116", k3),
        ("masked_softmax", "segment_softmax.cu", "hydragnn_tpu/ops/fused_softmax.py:334", k4),
    ):
        t_bytes = k["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = k["ops"] / FP32_FLOPS * 1e3
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"hydragnn_tpu_torch/csrc/{source}",
            "replaces": src_line,
            "launches": 0,
            "max_abs_err": results[name],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": k["library_ms"],
            "shape": k["shape"],
        })
        for extra in ("index_add_ms", "bf16", "device_ops", "schnet"):
            if extra in k:
                entries[-1][extra] = k[extra]
        if name == "segment_sum":
            entries[-1]["shapes"] = b2_shapes
        log(f"  {name} @ {k['shape']}: kernel {k['ms'] * 1e3:.2f} us, plain "
            f"{k['plain_ms'] * 1e3:.2f} us, one-call yardstick {k['library_ms'] * 1e3:.2f} us, "
            f"bound {max(t_bytes, t_ops) * 1e3:.3f} us ({k['bytes']} B at 3.35 TB/s)")
    for e_ in entries:
        times[e_["name"] + "_ms"] = e_["ms"]
    if exact_failures:
        raise AssertionError(f"kernels not bit for bit: {exact_failures}")
    return entries, times


def geometric_kernel_phase(torch, seed: int, entries: list, failures: list,
                           timing: bool = True) -> dict:
    """B1 and B2 at the geometric stacks' shapes (the qm9 top bucket), fp32
    and bf16, bit for bit (:func:`check_csr_exact`), with their times:

    * B1 in weight mode 2 over DimeNet's triplets: ``x_kj [E, 64]`` gathered
      by ``idx_kj``, weighted per triplet and channel, summed onto
      ``idx_ji``'s E rows over its certified-sorted CSR view, and the
      transposed launch over ``idx_kj``'s view; in fp32 the forward, ``dh``
      and ``dw`` through autograd also bit-equal to the plain
      gather-then-sum (``gather_rows`` and B2 over the same views);
    * B2 on the flattened 3-D messages: PAINN's and PNAEq's vector channel
      ``[E, 3, 32]`` at the senders, MACE's ``l = 1`` block ``[E, 3, 32]``
      at the receivers, and the oc20 MLIPs' ``[E, 3, 32]``, each beside
      ``index_add_``.

    Appends the times to ``entries`` (B1's and its transposed launch's under
    ``dimenet``, B2's under ``shapes``) and returns B1's per-call times by
    name (``gather_scatter_sum_dimenet_ms``, ...)."""
    from hydragnn_tpu_torch.ops import fused_scatter as fs

    times: dict = {}
    dev = torch.device("cuda") if timing else torch.device("cpu")
    gen = torch.Generator(device="cpu").manual_seed(4321)
    _, _, loaders, samples = prepare(seed, "dimenet")
    top, _ = bucket_batches(loaders, samples)
    b = top.to(dev)
    n, e, t = b.num_nodes, b.num_edges, b.idx_kj.shape[0]
    real_t = int(b.triplet_mask.sum())
    ji_idx, kj_idx = b.csr("idx_ji"), b.csr("idx_kj")
    log(f"DimeNet's triplets at the qm9 top bucket N={n} E={e}: T={t} triplet slots, {real_t} "
        f"real ({real_t / max(int(b.edge_mask.sum()), 1):.2f} per real edge), idx_ji certified "
        f"sorted={b.meta.ji_sorted} (permutation {'yes' if ji_idx.perm is not None else 'no'}), "
        f"idx_kj argsorted")
    if not b.meta.ji_sorted or ji_idx.perm is not None:
        raise AssertionError("DimeNet: collate did not certify idx_ji sorted")
    kj_c, ji_c, tm_c = b.idx_kj.cpu(), b.idx_ji.cpu(), b.triplet_mask.cpu()
    c = 64  # int_emb_size
    log("gather_scatter_sum in weight mode 2 over DimeNet's triplets (x_kj [E, 64] by idx_kj, "
        "w [T, 64], onto idx_ji's E rows) and its transposed launch over idx_kj's view, bit for "
        "bit:")
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        h = torch.randn(e, c, generator=gen).to(dtype)
        w = (torch.randn(t, c, generator=gen) * tm_c[:, None]).to(dtype)
        got = fs.gather_scatter_sum(h.to(dev), b.idx_kj, b.idx_ji, e, weight=w.to(dev),
                                    index=ji_idx, send_index=kj_idx)
        with _one_thread(torch):
            plain = fs.plain_gather_scatter_sum(h, kj_c, ji_c, e, w)
        check_csr_exact(torch, f"{dname} triplet mixing [T={t},{c}] -> E={e}", got, plain,
                        h.float()[kj_c.long()] * w.float(), ji_c, e, failures)
        got = fs.gather_scatter_sum_bwd(h.to(dev), b.idx_kj, b.idx_ji, e, w.to(dev),
                                        send_index=kj_idx, index=ji_idx)
        with _one_thread(torch):
            plain = fs.plain_gather_scatter_sum(h, ji_c, kj_c, e, w)
        check_csr_exact(torch, f"{dname} its transposed launch over idx_kj's view", got, plain,
                        h.float()[ji_c.long()] * w.float(), kj_c, e, failures)
    # fp32: B1 against the gather-then-sum it replaces (gather_rows and B2
    # over the same views), forward and gradients, bit for bit
    h = torch.randn(e, c, generator=gen).to(dev).requires_grad_()
    w = (torch.randn(t, c, generator=gen).to(dev) * b.triplet_mask[:, None]).requires_grad_()
    dout = torch.randn(e, c, generator=gen).to(dev)
    out_k = fs.gather_scatter_sum(h, b.idx_kj, b.idx_ji, e, weight=w, index=ji_idx,
                                  send_index=kj_idx)
    dh_k, dw_k = torch.autograd.grad(out_k, (h, w), dout)
    out_g = fs.fused_segment_sum(fs.gather_rows(h, b.idx_kj, kj_idx) * w, b.idx_ji, e,
                                 index=ji_idx)
    dh_g, dw_g = torch.autograd.grad(out_g, (h, w), dout)
    same = [bool(torch.equal(x, y)) for x, y in ((out_k, out_g), (dh_k, dh_g), (dw_k, dw_g))]
    log(f"  fp32 B1 vs gather_rows + B2 over the same views: forward, dh, dw bit-equal {same}")
    if not all(same):
        failures.append("B1 vs gather-then-sum over DimeNet's triplets")
    if timing:
        hd, wd = h.detach(), w.detach()
        nbytes = e * c * 4 + 2 * t * 4 + t * c * 4 + e * c * 4
        bound = max(nbytes / HBM_BYTES_PER_S, 2 * t * c / FP32_FLOPS) * 1e3
        for name, fn, plain_fn in (
            ("gather_scatter_sum",
             lambda: fs.gather_scatter_sum(hd, b.idx_kj, b.idx_ji, e, weight=wd, index=ji_idx),
             lambda: fs.plain_gather_scatter_sum(hd, b.idx_kj, b.idx_ji, e, wd)),
            ("gather_scatter_sum_bwd",
             lambda: fs.gather_scatter_sum_bwd(dout, b.idx_kj, b.idx_ji, e, wd,
                                               send_index=kj_idx),
             lambda: fs.plain_gather_scatter_sum(dout, b.idx_ji, b.idx_kj, e, wd)),
        ):
            d = dict(shape=f"[{e},{c}] f32, w[T={t},{c}] (DimeNet's triplet mixing)",
                     ms=graph_time_ms(torch, fn), plain_ms=graph_time_ms(torch, plain_fn),
                     bound_ms=bound, bound_by="bytes", library_ms=None, bytes=nbytes)
            next(x for x in entries if x["name"] == name)["dimenet"] = d
            times[f"{name}_dimenet_ms"] = d["ms"]
            log(f"  {name} @ {d['shape']}: kernel {d['ms'] * 1e3:.2f} us, plain "
                f"{d['plain_ms'] * 1e3:.2f} us, bound {bound * 1e3:.3f} us ({nbytes} B); no "
                f"one-call yardstick (a weight per triplet and channel)")

    # B2 on the flattened [E, 3, F] messages
    mlip_b = mlip_train_batch().to(dev)
    log("segment_sum on the flattened 3-D messages ([E, 3, 32] as [E, 96]), bit for bit:")
    cases = (("PAINN/PNAEq vector messages at the senders", b.senders, n, b.csr("senders"),
              e),
             ("MACE l=1 messages at the receivers", b.receivers, n, b.csr("receivers"), e),
             ("oc20 MLIP (PAINN/MACE) [E,3,32] at the senders", mlip_b.senders,
              mlip_b.num_nodes, mlip_b.csr("senders"), mlip_b.num_edges))
    shapes = []
    for label, ids, rows, index, n_ids in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(n_ids, 3, 32, generator=gen).to(dtype)
            got = fs.fused_segment_sum(x.reshape(n_ids, 96).to(dev), ids, rows, index=index)
            with _one_thread(torch):
                plain = fs.plain_segment_sum(x.reshape(n_ids, 96), ids.cpu(), rows)
            check_csr_exact(torch, f"{str(dtype).split('.')[1]} {label} [{n_ids},3,32]", got,
                            plain, x.reshape(n_ids, 96).float(), ids, rows, failures)
        if timing:
            xd = torch.randn(n_ids, 96, generator=gen).to(dev)
            ids_l = ids.long()
            t_k = graph_time_ms(torch, lambda: fs.fused_segment_sum(xd, ids, rows, index=index))
            t_lib = graph_time_ms(torch, lambda: torch.zeros(rows, 96, device=dev).index_add_(
                0, ids_l, xd))
            nbytes = xd.numel() * 4 + n_ids * 4 + rows * 96 * 4
            bound = max(nbytes / HBM_BYTES_PER_S, xd.numel() / FP32_FLOPS) * 1e3
            shapes.append(dict(shape=f"{label} [{n_ids},3*32] f32 -> {rows}", ms=t_k,
                               library_ms=t_lib, bound_ms=bound,
                               pieces=int(index.piece_ptr[-1]),
                               longest_row=int((index.ptr[1:] - index.ptr[:-1]).max())))
            log(f"  segment_sum @ {shapes[-1]['shape']}: kernel {t_k * 1e3:.2f} us, index_add_ "
                f"{t_lib * 1e3:.2f} us, bound {bound * 1e3:.3f} us ({nbytes} B)")
    if timing:
        next(x for x in entries if x["name"] == "segment_sum")["shapes"].extend(shapes)
    return times


def edge_kernel_phase(torch, seed: int, entries: list, failures: list,
                      timing: bool = True) -> None:
    """B2 at the shapes edge features and the performer give it (the qm9
    top bucket), fp32 and bf16, bit for bit (:func:`check_csr_exact`), each
    timed in fp32 beside ``index_add_`` and its bound: the performer's
    per-graph ``kv`` (``[N, heads m Dh]`` by graph) and ``z`` (``[N, heads
    m]``), and GAT's self-loop mean (``[E, 1]`` by receiver, the masked
    edge lengths; the degree is the same sum of the edge mask). The timed
    shapes go under B2's ``shapes``."""
    from hydragnn_tpu_torch.ops import fused_scatter as fs

    dev = torch.device("cuda") if timing else torch.device("cpu")
    gen = torch.Generator(device="cpu").manual_seed(5678)
    arch = qm9_config("gps_performer")["NeuralNetwork"]["Architecture"]
    heads = int(arch["global_attn_heads"])
    dh = int(arch["hidden_dim"]) // heads
    m = max(8, (dh + 7) // 8 * 8)
    _, _, loaders, samples = prepare(seed, "gps_performer")
    top, _ = bucket_batches(loaders, samples)
    _, _, e_loaders, e_samples = prepare(seed, "gat_edge")
    e_top, _ = bucket_batches(e_loaders, e_samples)
    b, eb = top.to(dev), e_top.to(dev)
    n, g = b.num_nodes, b.num_graphs
    cases = (
        (f"performer kv [N, {heads}*{m}*{dh}] by graph", b.batch, g, b.csr("batch"), n,
         heads * m * dh),
        (f"performer z [N, {heads}*{m}] by graph", b.batch, g, b.csr("batch"), n, heads * m),
        ("GAT self-loop mean edge feature [E, 1] by receiver", eb.receivers, eb.num_nodes,
         eb.csr("receivers"), eb.num_edges, 1),
    )
    log("segment_sum (B2) at the edge-feature and performer shapes, bit for bit:")
    shapes = []
    for label, ids, rows, index, n_ids, c in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(n_ids, c, generator=gen).to(dtype)
            got = fs.fused_segment_sum(x.to(dev), ids, rows, index=index)
            with _one_thread(torch):
                plain = fs.plain_segment_sum(x, ids.cpu(), rows)
            check_csr_exact(torch, f"{str(dtype).split('.')[1]} {label} [{n_ids},{c}] -> {rows}",
                            got, plain, x.float(), ids, rows, failures)
        if timing:
            xd = torch.randn(n_ids, c, generator=gen).to(dev)
            ids_l = ids.long()
            t_k = graph_time_ms(torch, lambda: fs.fused_segment_sum(xd, ids, rows, index=index))
            t_p = graph_time_ms(torch, lambda: fs.plain_segment_sum(xd, ids, rows))
            t_lib = graph_time_ms(torch, lambda: torch.zeros(rows, c, device=dev).index_add_(
                0, ids_l, xd))
            nbytes = xd.numel() * 4 + n_ids * 4 + rows * c * 4
            bound = max(nbytes / HBM_BYTES_PER_S, xd.numel() / FP32_FLOPS) * 1e3
            shapes.append(dict(shape=f"{label} [{n_ids},{c}] f32 -> {rows}", ms=t_k,
                               plain_ms=t_p, library_ms=t_lib, bound_ms=bound,
                               bound_by="bytes", bytes=nbytes,
                               pieces=int(index.piece_ptr[-1]),
                               longest_row=int((index.ptr[1:] - index.ptr[:-1]).max())))
            log(f"  segment_sum @ {shapes[-1]['shape']}: kernel {t_k * 1e3:.2f} us, plain "
                f"{t_p * 1e3:.2f} us, index_add_ {t_lib * 1e3:.2f} us, bound "
                f"{bound * 1e3:.3f} us ({nbytes} B)")
    if timing:
        next(x for x in entries if x["name"] == "segment_sum")["shapes"].extend(shapes)


def schnet_gather_scatter_checks(torch, b, gen, real_rows: int) -> None:
    """Kernel B1 at SchNet's sum: lin1 features ``[N, 64]`` times filters
    per edge and channel ``[E, 64]`` (the filters times the edge mask), fp32
    and bf16, through autograd: the forward over the receivers' view, the
    transposed launch over the senders' view (weight mode 2) for ``dh`` and
    the filters' gradient ``dw = h[s] * dout[r]``. The reference is the
    plain version's autograd in fp32 on the same (rounded) inputs; the
    kernel's results are in the input type, so bf16 ones may differ by one
    bf16 rounding."""
    from hydragnn_tpu_torch.ops import fused_scatter as fs

    n, e, dev = b.num_nodes, b.num_edges, b.device
    recv_idx, send_idx = b.csr("receivers"), b.csr("senders")
    h0 = torch.randn(n, 64, generator=gen).to(dev)
    w0 = torch.rand(e, 64, generator=gen).to(dev) * b.edge_mask[:, None]
    g0 = torch.randn(n, 64, generator=gen).to(dev)
    log("gather_scatter_sum at SchNet's per-channel weight [E, 64], forward and backward "
        "(dh: the transposed launch; dw = h[s] * dout[r]):")
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        results = []
        before = dict(fs.LAUNCHES)
        for fn, t in ((lambda h, w: fs.gather_scatter_sum(
                h, b.senders, b.receivers, n, weight=w, index=recv_idx, send_index=send_idx),
                dtype), (lambda h, w: fs.plain_gather_scatter_sum(
                    h, b.senders, b.receivers, n, w), torch.float32)):
            h = h0.to(dtype).to(t).clone().requires_grad_()
            w = w0.to(dtype).to(t).clone().requires_grad_()
            out = fn(h, w)
            out.backward(g0.to(dtype).to(t))
            results.append((out.detach(), h.grad, w.grad))
        (out, dh, dw), (r_out, r_dh, r_dw) = results
        launched = {k: fs.LAUNCHES[k] - before[k] for k in ("gather_scatter_sum",
                                                             "gather_scatter_sum_bwd")}
        if dev.type == "cuda" and launched != {"gather_scatter_sum": 1,
                                               "gather_scatter_sum_bwd": 1}:
            raise AssertionError(f"gather_scatter_sum per-channel {dname}: launched {launched}")
        if (out.dtype, dh.dtype, dw.dtype) != (dtype,) * 3:
            raise AssertionError(f"gather_scatter_sum per-channel {dname}: result types "
                                 f"{out.dtype}, {dh.dtype}, {dw.dtype}")
        _compare(torch, f"{dname} out[N,64]", out, r_out, real_rows, dname)
        _compare(torch, f"{dname} dh[N,64] (transposed launch, weight per edge and channel)",
                 dh, r_dh, real_rows, dname)
        _compare(torch, f"{dname} dw[E,64]", dw, r_dw, e, dname)


def step_kernel_ms(kind: str, layers: int, kt: dict) -> float:
    """Device time of one train step's kernel launches from the kernel
    phase's times (fp32 shapes; GIN's conv layer 0 at its bf16 C = 1)."""
    per = launches_per_train_step(kind, layers)
    if kind in GEOMETRIC_SUMS:
        # segment sums at about the edge messages' shape (PAINN, PNAEq, MACE
        # sum [E, 32] to [E, 96] rows), DimeNet's B1 at its triplets' shape
        return (per["segment_sum"] * kt.get("segment_sum_edges_ms", 0.0)
                + per["gather_scatter_sum"] * kt.get("gather_scatter_sum_dimenet_ms", 0.0)
                + per["gather_scatter_sum_bwd"] * kt.get("gather_scatter_sum_bwd_dimenet_ms",
                                                         0.0))
    if kind == "gat":
        # aggregation and the two gathers' backward sums at [E', 6 * 64]
        return (per["segment_softmax"] * kt.get("segment_softmax_ms", 0.0)
                + 3 * layers * kt.get("segment_sum_gat_agg_ms", 0.0)
                + layers * kt.get("segment_sum_gat_bwd_ms", 0.0)
                + kt.get("segment_sum_ms", 0.0))
    if kind in EDGE_SUM_STACKS:
        # the edge messages' sums and the gathers' backward sums at [E, F]
        return ((per["segment_sum"] - 1) * kt.get("segment_sum_edges_ms", 0.0)
                + kt.get("segment_sum_ms", 0.0))
    gs_ms = kt.get("gather_scatter_sum_schnet_ms" if kind == "schnet" else
                   "gather_scatter_sum_ms", 0.0)
    bwd_ms = kt.get("gather_scatter_sum_bwd_schnet_ms" if kind == "schnet" else
                    "gather_scatter_sum_bwd_ms", 0.0)
    gs = (kt.get("gather_scatter_sum_layer0_ms", 0.0) + (layers - 1) * gs_ms
          if kind == "gin" else layers * gs_ms)
    return (gs + per["gather_scatter_sum_bwd"] * bwd_ms + kt.get("segment_sum_ms", 0.0)
            + per["masked_softmax"] * kt.get("masked_softmax_ms", 0.0))


# -- phase 3b: kernels B6 and B7, the int8 and fp8 dense layers -------------------


def dense_inputs(torch, model, batch, dtype):
    """Every Dense call of one eval forward of ``model`` on ``batch`` with
    the predict step's casts to ``dtype``: ``[(name, module, x [rows, in])]``
    in call order (the real activations at the path's shapes)."""
    from hydragnn_tpu_torch.models.common import intercept_dense
    from hydragnn_tpu_torch.serve.quant import dense_names
    from hydragnn_tpu_torch.train.step import cast_forward

    names = dense_names(model)
    calls = []

    def record(module, x):
        calls.append((names[module], module, x.reshape(-1, x.shape[-1]).clone()))
        return None

    with torch.inference_mode(), intercept_dense(record):
        cast_forward(model, batch.to(next(model.parameters()).device), dtype, train=False)
    return calls


def _ulps(torch, got, want):
    """|got - want| in units of the last place of |want| (fp32)."""
    a = want.abs()
    return (got - want).abs() / (torch.nextafter(a, torch.full_like(a, float("inf"))) - a)


def check_quant_dense(torch, label: str, x, w, b) -> float:
    """Kernel B6 against its plain version on ``x [M, K]`` and the weight
    ``w [K, N]`` quantized as the serving tier quantizes it: int8 codes and
    int32 accumulators equal, ``y`` bit-equal (0 ulp: the kernel's
    dequantisation is the plain version's fused multiply-add), finite, two
    launches bit-identical. Returns max |kernel - plain|."""
    from hydragnn_tpu_torch.ops import quant_matmul as qm

    w_q, s_w = qm.quantize_weight(w)
    s_x = max(float(x.float().abs().max()), 1e-8) / 127.0
    x_q, acc, y = qm.quant_dense_parts(x, w_q, s_w, s_x, b)
    p_q, p_acc, p_y = qm.reference_quant_parts(x, w_q, s_w, s_x, b)
    codes, sums = torch.equal(x_q, p_q), torch.equal(acc, p_acc)
    ulps = _ulps(torch, y, p_y)
    n_diff = int((y != p_y).sum())
    ok = codes and sums and n_diff == 0 and bool(torch.isfinite(y).all())
    log(f"  {label}: x[{x.shape[0]},{x.shape[1]}] {str(x.dtype).split('.')[1]} x "
        f"W_q[{w_q.shape[0]},{w_q.shape[1]}]{'' if b is not None else ' (no bias)'}: codes "
        f"{'equal' if codes else 'DIFFER'}, int32 sums {'equal' if sums else 'DIFFER'}, y "
        f"{n_diff} of {y.numel()} entries differ, by at most {float(ulps.max()):.0f} ulp "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"quant_dense {label}: the kernel disagrees with the plain version")
    _bit_stable(torch, "quant_dense", lambda: qm.quant_dense(x, w_q, s_w, s_x, b))
    return float((y - p_y).abs().max())


def fp8_quantized(torch, x, w, fmt: str, s_x=None):
    """``(w_q, s_w, s_x)``: ``w [K, N]`` quantized as ``fp8_dense`` quantizes
    it, and the activation scale as an fp32 0-d tensor (default from ``x``)."""
    from hydragnn_tpu_torch.ops import fp8_matmul as f8

    w_q, s_w = f8.quantize_weight_fp8(w, fmt)
    s_x = f8.activation_scale_fp8(x, fmt) if s_x is None else f8._scalar(s_x, x.device)
    return w_q, s_w, s_x


def fp8_bound_ratio(torch, x, w_q, s_w, s_x, b, fmt: str, bits: int | None = None,
                    promote: bool = False):
    """Kernel B7 on ``x [M, K]`` and the quantized weight (:func:`fp8_quantized`)
    against its plain version: ``(codes bit-equal, max |y - plain| / bound,
    max |y - plain|, saturated share of the codes, y finite)``, the bound
    being the summation-order bound ``K 2^-23 sum |x_q| |w_q| s_x s_w`` plus
    one ulp of ``|y|`` (the products are exact in fp32; only the order and
    rounding of the fp32 sum may differ). With ``bits`` (and ``promote``),
    ``y`` is :func:`fp8_accumulator_emulation`'s instead of the kernel's."""
    from hydragnn_tpu_torch.ops import fp8_matmul as f8

    x_q, y = f8.fp8_matmul_parts(x, w_q, s_w, s_x, b, fmt, debug=True)
    p_q, p_y = f8.reference_fp8_parts(x, w_q, s_w, s_x, b, fmt)
    if bits is not None:
        y = fp8_accumulator_emulation(torch, p_q, w_q, s_x, s_w, b, bits, promote)
    codes = torch.equal(x_q.view(torch.uint8), p_q.view(torch.uint8))
    mag = x_q.float().abs().double() @ w_q.float().abs().double()
    bound = (x.shape[1] * 2.0 ** -23 * mag * s_x.double() * s_w.double()[None, :]
             + (torch.nextafter(p_y.abs(), torch.full_like(p_y, float("inf"))) - p_y.abs()))
    d = (y.double() - p_y.double()).abs()
    saturated = float((x_q.float().abs() == f8.FP8_MAX[fmt]).float().mean())
    return (codes, float((d / bound).max()), float(d.max()), saturated,
            bool(torch.isfinite(y).all()))


def check_fp8_dense(torch, label: str, x, w, b, fmt: str, s_x=None) -> float:
    """Kernel B7 against its plain version (:func:`fp8_bound_ratio`): the
    fp8 codes of ``x`` bit-equal, ``y`` within the summation-order bound,
    finite (saturation makes no inf), two launches bit-identical. Returns
    max |kernel - plain|."""
    from hydragnn_tpu_torch.ops import fp8_matmul as f8

    w_q, s_w, s_x = fp8_quantized(torch, x, w, fmt, s_x)
    codes, ratio, err, saturated, finite = fp8_bound_ratio(torch, x, w_q, s_w, s_x, b, fmt)
    ok = codes and ratio <= 1.0 and finite
    log(f"  {label} {fmt}: x[{x.shape[0]},{x.shape[1]}] x W[{w.shape[0]},{w.shape[1]}]: codes "
        f"{'bit-equal' if codes else 'DIFFER'} ({100 * saturated:.1f}% saturated), max|y - "
        f"plain| {err:.3e} = {ratio:.3f} of the summation-order bound "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"fp8_dense {label} {fmt}: the kernel disagrees with the plain "
                             "version")
    _bit_stable(torch, "fp8_dense", lambda: f8.fp8_matmul_parts(x, w_q, s_w, s_x, b, fmt)[1])
    return err


# shapes of B7's adversarial accumulation check: the qm9 Dense depth, the
# oc20 EGNN's K = 129, and a deep K
FP8_ADVERSARIAL_SHAPES = ((256, 64, 64), (256, 129, 64), (64, 1200, 300))
# where a 14-bit accumulator must miss the bound on those inputs, carried
# through k or promoted to fp32 per 32-wide k step: at deep K the bound
# K 2^-23 is looser than a promoted 14-bit accumulator's error
FP8_CONTROL_SHAPES = FP8_ADVERSARIAL_SHAPES[:2]
# log2 of the smallest and the largest magnitude of each fp8 format
FP8_RANGE = {"e4m3": (-9.0, 8.807), "e5m2": (-16.0, 15.807)}


def fp8_adversarial_inputs(torch, fmt: str, m: int, k: int, n: int, gen):
    """``x [m, k]`` and ``w [k, n]`` (fp32, on the CPU) for B7's accumulation
    at ``s_x = 1``: magnitudes log-uniform over the format's whole range
    (e4m3 2^-9 .. 448, e5m2 2^-16 .. 57344) with random signs, so the
    products span 2^35 (e4m3) or 2^63 (e5m2) and one product can dwarf the
    rest of its sum, and half of k repeats the other half with w negated, so
    each sum cancels to (nearly) 0 while its terms stay large. One
    permutation of k scatters each term's negated copy, so that no 32-wide
    k step of the tensor cores cancels a whole other step exactly."""
    lo, hi = FP8_RANGE[fmt]

    def draw(*shape):
        mag = torch.exp2(torch.rand(*shape, generator=gen, dtype=torch.float64) * (hi - lo) + lo)
        sign = torch.where(torch.rand(*shape, generator=gen) < 0.5, -1.0, 1.0)
        return (mag * sign).float()

    x, w = draw(m, k), draw(k, n)
    h = k // 2
    x[:, h:2 * h] = x[:, :h]
    w[h:2 * h] = -w[:h]
    p = torch.randperm(k, generator=gen)
    return x[:, p].contiguous(), w[p].contiguous()


def fp8_accumulator_emulation(torch, x_q, w_q, s_x, s_w, b, bits: int,
                              promote: bool = False):
    """B7's ``y`` from the codes ``x_q [M, K]`` and ``w_q [K, N]`` as an
    accumulator of ``bits`` significant bits would give it: the exact
    products added in k order, each partial sum rounded to nearest at
    ``bits`` bits (in float64), then the kernel's epilogue ``acc * (s_x *
    s_w) + b`` rounded once. With ``promote``, each 32-wide k step of the
    tensor cores starts from 0 and its sum is added to an fp32 accumulator.
    At 24 bits this is an fp32 accumulator; at 14, the accumulation reported
    for Hopper's fp8 tensor-core path (DeepSeek-V3 technical report, section
    3.3.2): the control of B7's adversarial gate."""
    xs, ws = x_q.float().double(), w_q.float().double()
    k = xs.shape[1]
    step = 32 if promote else k

    def rounded(v, keep):
        mant, exp = torch.frexp(v)
        return torch.ldexp(torch.round(mant * 2.0 ** keep), exp - keep)

    acc = torch.zeros(xs.shape[0], ws.shape[1], dtype=torch.float64, device=xs.device)
    for k0 in range(0, k, step):
        part = torch.zeros_like(acc)
        for j in range(k0, min(k0 + step, k)):
            part = rounded(part + xs[:, j, None] * ws[None, j, :], bits)
        acc = rounded(acc + part, 24)
    y = acc * (s_x * s_w.float()).double()[None, :]
    if b is not None:
        y = y + b.float().double()[None, :]
    return y.float()


def _kernel_entry(name: str, source: str, replaces: str, k: dict, err: float,
                  ops_per_s: float) -> dict:
    """One entry of the kernels line; the bound is the larger of the bytes
    at the HBM rate and the operations at ``ops_per_s``."""
    t_bytes = k["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = k["ops"] / ops_per_s * 1e3
    lib = "none" if k["library_ms"] is None else f"{k['library_ms'] * 1e3:.2f} us"
    log(f"  {name} @ {k['shape']}: kernel {k['ms'] * 1e3:.2f} us, plain "
        f"{k['plain_ms'] * 1e3:.2f} us, one-call yardstick {lib}, bound "
        f"{max(t_bytes, t_ops) * 1e3:.3f} us ({k['bytes']} B, {k['ops']} operations)")
    return {"name": name, "route": "cuda", "source": f"hydragnn_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": k["library_ms"], "shape": k["shape"]}


def _time_quant_dense(torch, label: str, x, w, b, plain: bool = False) -> dict:
    """Kernel B6's device time on ``x [M, K]`` and ``w [K, N]`` quantized as
    the serving tier quantizes it, beside quantize + ``torch._int_mm`` +
    ``addcmul`` (the one-call yardstick, None where ``_int_mm`` refuses the
    shape) and, with ``plain``, the plain version. Logged with the bound."""
    from hydragnn_tpu_torch.ops import quant_matmul as qm

    w_q, s_w = qm.quantize_weight(w)
    s_x = max(float(x.float().abs().max()), 1e-8) / 127.0
    s_x_t = torch.full((), s_x, device=x.device)
    scale = s_x_t * s_w
    m, k = x.shape
    n = w_q.shape[1]
    dtype = {torch.float32: "f32", torch.bfloat16: "bf16"}[x.dtype]

    def kernel():
        return qm.quant_dense(x, w_q, s_w, s_x, b)

    w_cols = w_q.t().contiguous().t()  # torch._int_mm (cuBLASLt) takes B column-major

    def int_mm_dequant():
        x_q = torch.clamp(torch.round(x.float() / s_x_t), -127, 127).to(torch.int8)
        acc = torch._int_mm(x_q, w_cols).float()
        return acc * scale if b is None else torch.addcmul(b, acc, scale)

    t = dict(ms=graph_time_ms(torch, kernel), plain_ms=None, library_ms=None,
             bytes=m * k * x.element_size() + k * n + (1 if b is None else 2) * n * 4 + m * n * 4,
             ops=2 * m * k * n, shape=f"x[{m},{k}] {dtype}, W_q[{k},{n}] int8 ({label})")
    if plain:
        t["plain_ms"] = graph_time_ms(torch, lambda: qm.reference_quant_dense(x, w_q, s_w, s_x,
                                                                              b))
    try:
        lib_err = float((int_mm_dequant() - kernel()).abs().max())
        t["library_ms"] = graph_time_ms(torch, int_mm_dequant)
        x_q = qm.quantize_acts(x, s_x)
        t["int_mm_ms"] = graph_time_ms(torch, lambda: torch._int_mm(x_q, w_cols))
        note = (f"yardstick max|diff| vs kernel {lib_err:.3e} (addcmul rounds twice); "
                f"torch._int_mm alone {t['int_mm_ms'] * 1e3:.2f} us")
    except RuntimeError as exc:  # the yardstick only; the port never calls it
        note = f"torch._int_mm refused this shape: {str(exc).splitlines()[0][:100]}"
    t["bound_ms"] = max(t["bytes"] / HBM_BYTES_PER_S, t["ops"] / INT8_OPS) * 1e3
    lib = "none" if t["library_ms"] is None else f"{t['library_ms'] * 1e3:.2f} us"
    log(f"    {t['shape']}: kernel {t['ms'] * 1e3:.2f} us, yardstick {lib}, bound "
        f"{t['bound_ms'] * 1e3:.3f} us; {note}")
    return t


def _time_fp8_dense(torch, label: str, x, w, b, plain: bool = False) -> dict:
    """Kernel B7's device time (e4m3) on ``x [M, K]`` and ``w [K, N]``
    quantized as ``fp8_dense`` quantizes them, beside quantize +
    ``torch._scaled_mm`` + ``addcmul`` (the one-call yardstick, with x's K
    zero-padded to the multiple of 16 that ``_scaled_mm`` needs; None where
    it refuses the shape) and, with ``plain``, the plain version. Logged
    with the bound."""
    from hydragnn_tpu_torch.ops import fp8_matmul as f8

    fmt = "e4m3"
    w8, s_w8 = f8.quantize_weight_fp8(w, fmt)
    s_x8 = f8.activation_scale_fp8(x, fmt)
    scale8 = s_x8 * s_w8
    m, k = x.shape
    n = w8.shape[1]

    def kernel():
        return f8.fp8_matmul_parts(x, w8, s_w8, s_x8, b, fmt)[1]

    t = dict(ms=graph_time_ms(torch, kernel), plain_ms=None, library_ms=None,
             bytes=m * k * 4 + k * n + (1 if b is None else 2) * n * 4 + 4 + m * n * 4,
             ops=2 * m * k * n, shape=f"x[{m},{k}] f32, W_q[{k},{n}] e4m3 ({label})")
    if plain:
        t["plain_ms"] = graph_time_ms(torch, lambda: f8.reference_fp8_dense(x, w8, s_w8, s_x8,
                                                                            b, fmt))
    one = torch.ones((), device=x.device)
    pad = -k % 16
    w8_cols = torch.nn.functional.pad(w8.view(torch.uint8), (0, 0, 0, pad)).view(
        w8.dtype).t().contiguous().t()  # torch._scaled_mm takes B column-major

    def scaled_mm():
        xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
        xq = torch.clamp(xp / s_x8, -448.0, 448.0).to(torch.float8_e4m3fn)
        acc = torch._scaled_mm(xq, w8_cols, scale_a=one, scale_b=one, out_dtype=torch.float32)
        return acc * scale8 if b is None else torch.addcmul(b, acc, scale8)

    try:
        lib_err = float((scaled_mm() - kernel()).abs().max())
        t["library_ms"] = graph_time_ms(torch, scaled_mm)
        note = (f"yardstick max|diff| vs kernel {lib_err:.3e}"
                + (f" (K padded {k} -> {k + pad})" if pad else ""))
    except RuntimeError as exc:  # the yardstick only; the port never calls it
        note = f"torch._scaled_mm refused this shape: {str(exc).splitlines()[0][:100]}"
    t["bound_ms"] = max(t["bytes"] / HBM_BYTES_PER_S, t["ops"] / INT8_OPS) * 1e3
    lib = "none" if t["library_ms"] is None else f"{t['library_ms'] * 1e3:.2f} us"
    log(f"    {t['shape']}: kernel {t['ms'] * 1e3:.2f} us, yardstick {lib}, bound "
        f"{t['bound_ms'] * 1e3:.3f} us; {note}")
    return t


# the tensor-core instructions each quantized library must hold: int8
# mma.sync lowers to IMMA; the fp8 layer's form to HMMA (fp16 or fp8
# operands) or QMMA (fp8)
TENSOR_CORE_SASS = {"quant_matmul.cu": ("IMMA",), "fp8_matmul.cu": ("HMMA", "QMMA")}


def check_tensor_cores(torch) -> None:
    """B6's and B7's libraries run on the tensor cores: ``cuobjdump -sass``
    of each built library holds the tensor-core instructions of
    ``TENSOR_CORE_SASS``, and no function of the scalar tile kernel
    (``tile_kernel``) is left in it."""
    import re

    from hydragnn_tpu_torch.ops import _build

    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    for source, wanted in TENSOR_CORE_SASS.items():
        lib = _build.BUILD_LOG[source]["path"]
        sass = subprocess.run([str(tool), "-sass", lib], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        functions = re.findall(r"Function : (\S+)", sass)
        ops = re.findall(r"\b((?:[A-Z]+)MMA(?:\.[A-Z0-9]+)*)\b", sass)
        kinds = sorted(set(ops))
        found = [o for o in ops if o.split(".")[0] in wanted]
        scalar = [f for f in functions if "tile_kernel" in f]
        ok = bool(found) and not scalar
        log(f"  {source} SASS (cuobjdump -sass {Path(lib).name}): {len(functions)} functions, "
            f"{len(found)} {'/'.join(wanted)} instructions ({', '.join(kinds) or 'none'}), "
            f"scalar tile-kernel functions {len(scalar)} "
            f"{'ok' if ok else 'NOT ON THE TENSOR CORES'}")
        if not ok:
            raise AssertionError(f"{source}: the built library does not run on the tensor cores "
                                 f"(no {'/'.join(wanted)}, or the scalar tile kernel is in it)")


def quant_kernel_phase(torch, model, batch, timing: bool = True,
                       egnn_rows: int | None = None):
    """Kernel B6 against its plain version at every Dense call of the qm9
    GIN's served forward on ``batch`` (the top bucket, with the served bf16
    casts: conv layer 0 takes bf16, the rest fp32; each also as a copy in
    the other type), GAT's 384 x 384 ``lin_l`` and a ragged row count; then
    kernel B7 at the GIN's shapes in both formats, and saturated. With
    ``timing``, B6 and B7 at a conv layer's hidden Dense ([N, 64] x [64,
    64], fp32: the most frequent call) beside their plain versions, the
    library yardsticks and the bounds; B6 also at GAT's lin_l, K = 1 and
    N = 1, in fp32 and bf16, B7 at K = 1, N = 1 and (given ``egnn_rows``)
    the oc20 EGNN's [egnn_rows, 129] x [129, 64] edge-MLP Dense, both
    kernels' device operations, and their SASS, which must hold
    tensor-core instructions (:func:`check_tensor_cores`). Returns the two
    JSON entries (B7's max error is completed by the fp8 phase) or
    ``[]``."""
    from hydragnn_tpu_torch.ops import fp8_matmul as f8
    from hydragnn_tpu_torch.ops import quant_matmul as qm

    dev = next(model.parameters()).device
    gen = torch.Generator(device="cpu").manual_seed(4321)
    calls = dense_inputs(torch, model, batch, torch.bfloat16)
    cases = []
    for name, module, x in calls:
        w = module.weight.detach().float().t()
        b = None if module.bias is None else module.bias.detach().float()
        other = x.float() if x.dtype == torch.bfloat16 else x.to(torch.bfloat16)
        cases += [(name, x, w, b), (f"{name} ({str(other.dtype).split('.')[1]} copy)", other,
                                    w, b)]
    n = batch.num_nodes
    cases.append(("GAT lin_l (384 x 384)", torch.randn(n, 384, generator=gen).to(dev),
                  torch.randn(384, 384, generator=gen).to(dev) / 20,
                  torch.randn(384, generator=gen).to(dev)))
    cases.append(("ragged M = 37", torch.randn(37, 64, generator=gen).to(dev),
                  torch.randn(64, 64, generator=gen).to(dev), None))
    log(f"quant_dense (replaces ops/quant_matmul.py:80 _quant_kernel): {len(calls)} Dense calls "
        f"of the GIN's served forward at N={n} rows (conv) and {batch.num_graphs} (heads), "
        f"each in fp32 and bf16, GAT's lin_l, a ragged M")
    err6 = max(check_quant_dense(torch, *case) for case in cases)
    log(f"fp8_dense (replaces ops/fp8_matmul.py:111 _fp8_kernel): the GIN's Dense shapes, "
        f"e4m3 and e5m2, and an activation scale 1000x too small (saturation)")
    err7 = 0.0
    for fmt in ("e4m3", "e5m2"):
        for name, module, x in calls:
            w = module.weight.detach().float().t()
            b = None if module.bias is None else module.bias.detach().float()
            err7 = max(err7, check_fp8_dense(torch, name, x.float(), w, b, fmt))
        name, module, x = calls[1]
        w = module.weight.detach().float().t()
        err7 = max(err7, check_fp8_dense(torch, f"{name} saturated", x.float(), w, None, fmt,
                                         s_x=f8.activation_scale_fp8(x, fmt) / 1000))
    log("fp8_dense accumulation on adversarial inputs (s_x = 1, codes over the format's whole "
        "range, sums that cancel; not in the entry's max_abs_err), each with the gate's control, "
        "a 14-bit accumulator (fp8_accumulator_emulation), which must miss the bound at the "
        "qm9 and EGNN depths, carried and promoted:")
    for fmt in ("e4m3", "e5m2"):
        for shape in FP8_ADVERSARIAL_SHAPES:
            x_a, w_a = (t.to(dev) for t in fp8_adversarial_inputs(torch, fmt, *shape, gen))
            check_fp8_dense(torch, "adversarial", x_a, w_a, None, fmt, s_x=1.0)
            q = fp8_quantized(torch, x_a, w_a, fmt, 1.0)
            control = [fp8_bound_ratio(torch, x_a, *q, None, fmt, bits=14, promote=p)[1]
                       for p in (False, True)]
            caught = min(control) > 1.0 or shape not in FP8_CONTROL_SHAPES
            log(f"    control: a 14-bit accumulator reads {control[0]:.3f} of the bound, "
                f"{control[1]:.3f} promoted to fp32 per 32-wide k step "
                f"{'ok' if caught else 'NOT CAUGHT'}")
            if not caught:
                raise AssertionError(f"fp8_dense adversarial {fmt} {shape}: the inputs cannot "
                                     "tell a 14-bit accumulator from an fp32 one")
    _sync(torch, dev.type)
    if not timing:
        return []

    # B6 as served: a conv layer's hidden Dense (fp32 [N, 64] x [64, 64], the
    # most frequent call; the JSON row), then GAT's 384 x 384 lin_l, GIN conv
    # layer 0 (K = 1) and a head's output Dense (N = 1), each in fp32 and bf16
    name, module, x = next(c for c in calls if c[0] == "graph_convs.1.nn.dense_1")
    m, k = x.shape
    w = module.weight.detach().float().t()
    b = module.bias.detach().float()
    nb = w.shape[1]
    log("  quant_dense device times (CUDA-graph replay; yardstick: quantize + torch._int_mm + "
        "addcmul; bound: the bytes at 3.35 TB/s or the int8 operations at 1,979 TOP/s):")
    k6 = _time_quant_dense(torch, name, x, w, b, plain=True)
    k6["bf16"] = _time_quant_dense(torch, name, x.to(torch.bfloat16), w, b)
    k_one = next(c for c in calls if c[2].shape[1] == 1)
    n_one = next(c for c in calls if c[1].weight.shape[0] == 1)
    gat = (torch.randn(m, 384, generator=gen).to(dev), torch.randn(384, 384, generator=gen).to(dev)
           / 20, torch.randn(384, generator=gen).to(dev))
    shapes = []
    for label, xs, ws, bs in (
            ("GAT lin_l", *gat),
            (f"{k_one[0]}, K = 1", k_one[2].float(), k_one[1].weight.detach().float().t(),
             None if k_one[1].bias is None else k_one[1].bias.detach().float()),
            (f"{n_one[0]}, N = 1", n_one[2].float(), n_one[1].weight.detach().float().t(),
             None if n_one[1].bias is None else n_one[1].bias.detach().float())):
        for dtype in (torch.float32, torch.bfloat16):
            shapes.append(_time_quant_dense(torch, label, xs.to(dtype), ws, bs))
    k6["shapes"] = shapes
    w_q, s_w = qm.quantize_weight(w)
    s_x = float(x.abs().max()) / 127.0
    ops, busy, rows = device_ops(torch, lambda: qm.quant_dense(x, w_q, s_w, s_x, b))
    log_device_ops(f"one quant_dense call at x[{m},{k}] f32 x W_q[{k},{nb}] under torch.profiler",
                   ops, busy, rows, k6["ms"] * 1e3)
    k6["device_ops"] = ops
    entries = [_kernel_entry("quant_dense", "quant_matmul.cu",
                             "hydragnn_tpu/ops/quant_matmul.py:80", k6, err6, INT8_OPS)]
    for extra in ("bf16", "shapes", "device_ops"):
        if extra in k6:
            entries[-1][extra] = k6[extra]

    # B7 at the same conv Dense (the JSON row), GIN conv layer 0 (K = 1), a
    # head's output Dense (N = 1) and the oc20 EGNN's edge-MLP Dense of
    # layer 1 (K = 2 * 64 + 1 = 129 over every edge of its training batch)
    log("  fp8_dense device times (CUDA-graph replay, e4m3; yardstick: quantize + "
        "torch._scaled_mm + addcmul; bound: the bytes at 3.35 TB/s or the fp8 operations at "
        "1,979 TFLOP/s):")
    k7 = _time_fp8_dense(torch, name, x, w, b, plain=True)
    shapes = [_time_fp8_dense(torch, label, xs.float(), ws, bs) for label, xs, ws, bs in (
        (f"{k_one[0]}, K = 1", k_one[2], k_one[1].weight.detach().float().t(),
         None if k_one[1].bias is None else k_one[1].bias.detach().float()),
        (f"{n_one[0]}, N = 1", n_one[2], n_one[1].weight.detach().float().t(),
         None if n_one[1].bias is None else n_one[1].bias.detach().float()))]
    if egnn_rows:
        shapes.append(_time_fp8_dense(
            torch, "EGNN edge MLP, layer 1", torch.randn(egnn_rows, 129, generator=gen).to(dev),
            torch.randn(129, 64, generator=gen).to(dev) / 11, torch.randn(64, generator=gen)
            .to(dev)))
    k7["shapes"] = shapes
    w8, s_w8 = f8.quantize_weight_fp8(w, "e4m3")
    s_x8 = f8.activation_scale_fp8(x, "e4m3")
    ops, busy, rows = device_ops(torch, lambda: f8.fp8_matmul_parts(x, w8, s_w8, s_x8, b)[1])
    log_device_ops(f"one fp8_dense call at x[{m},{k}] f32 x W_q[{k},{nb}] e4m3 under "
                   f"torch.profiler", ops, busy, rows, k7["ms"] * 1e3)
    k7["device_ops"] = ops
    entries.append(_kernel_entry("fp8_dense", "fp8_matmul.cu",
                                 "hydragnn_tpu/ops/fp8_matmul.py:111", k7, err7, INT8_OPS))
    for extra in ("shapes", "device_ops"):
        entries[-1][extra] = k7[extra]
    check_tensor_cores(torch)
    return entries


# -- phase 4: serving --------------------------------------------------------


class _Recorded:
    """``target`` (a server or a router) whose ``submit`` keeps each
    admitted request's future in submission order: ``run_traffic`` reports
    latencies, the phases also hold the answers."""

    def __init__(self, target):
        self.target = target
        self.futures: list = []

    def submit(self, model, sample, **kw):
        fut = self.target.submit(model, sample, **kw)
        self.futures.append(fut)
        return fut


def _serve_burst(torch, server, name: str, samples, device: str):
    """Start ``server``, send every sample to endpoint ``name`` in order as
    a closed burst through ``serve.traffic.run_traffic`` (the one latency
    measurement of the serving tier: submit to result available, on the
    client's clock), wait for every answer, stop. The launch counts are set
    to 0 just before the first request and read after the last answer.
    Returns (results in sample order, the traffic report, launches,
    stats)."""
    from hydragnn_tpu_torch.ops import fused_scatter as fs
    from hydragnn_tpu_torch.serve import run_traffic

    server.start()
    rec = _Recorded(server)
    try:
        fs.reset_launches()
        report = run_traffic(rec, name, samples, len(samples), order=np.arange(len(samples)),
                             timeout_s=300.0)
        if device == "cuda":
            torch.cuda.synchronize()
        launches = dict(fs.LAUNCHES)
        stats = server.stats()[name]
    finally:
        server.stop()
    if report.n_served != len(samples) or len(rec.futures) != len(samples):
        raise AssertionError(f"serving: {report.summary()}")
    return [f.result() for f in rec.futures], report, launches, stats


def _traffic_line(report) -> str:
    """p50, p99 and graphs/s of a traffic report, for the log."""
    sm = report.summary()
    return (f"p50 {sm['p50_ms']:.2f} ms, p99 {sm['p99_ms']:.2f} ms, "
            f"{sm['graphs_per_sec']:.1f} graphs/s")


@contextlib.contextmanager
def _eager_answers(server):
    """Inside, ``server``'s endpoints answer through their eager steps
    (``Predictor.outputs``), not their graphs: the comparator bursts. The
    port itself has no such switch."""
    preds = [ep.predictor for ep in server._models.values()]
    for pred in preds:
        pred.answer = pred.outputs
    try:
        yield
    finally:
        for pred in preds:
            del pred.answer


def _eager_burst(torch, config, model, aug, requests, name: str, tag: str, **add_kw):
    """The comparator of a served burst: the same model behind a server of
    ``config`` (``add_model`` with ``add_kw``) whose endpoint answers
    through the eager step, ``requests`` sent as the captured burst sent
    them; returns (p50, p99, graphs/s, launches, batches)."""
    from hydragnn_tpu_torch.serve import PredictionServer

    server = PredictionServer(config, device="cuda")
    server.add_model(name, model, aug, **add_kw)
    with _eager_answers(server):
        server.warmup()
        _, report, launches, stats = _serve_burst(torch, server, name, requests, "cuda")
    if stats["served"] != len(requests) or stats["failed"] or stats["captures"]:
        raise AssertionError(f"{tag} eager comparator burst: {stats}")
    sm = report.summary()
    return (sm["p50_ms"], sm["p99_ms"], sm["graphs_per_sec"], launches, stats["batches"])


def _served_vs_outputs(buckets, predictor, samples, results, step_for=None):
    """Each served batch recollated as the server collated it and run
    through ``predictor.outputs`` (with ``step_for(pad)`` as its step, if
    given): ``(head, sample index, served, recomputed)`` numpy rows per
    request and head."""
    from hydragnn_tpu_torch.serve.batcher import serving_collate

    by_batch: dict = {}
    for i, r in enumerate(results):
        by_batch.setdefault(r["batch"], []).append((r["slot"], i, r))
    rows = []
    for _, members in sorted(by_batch.items()):
        members.sort(key=lambda m: m[0])
        pad = next(b for b in buckets if b.as_tuple() == tuple(members[0][2]["bucket"]))
        chunk = [samples[i] for _, i, _ in members]
        step = step_for(pad) if step_for is not None else None
        out = predictor.outputs(serving_collate(chunk, pad), step=step)
        per_graph = predictor.split_graphs(out, [s.num_nodes for s in chunk])
        for (_, i, r), heads in zip(members, per_graph):
            for ihead, (a, b) in enumerate(zip(r["heads"], heads)):
                rows.append((ihead, i, np.asarray(a), np.asarray(b)))
    return rows


def serving_phase(torch, device: str, seed: int, kind: str = "gin", card: str = "") -> dict:
    """One model behind ``PredictionServer``: warm-up, a closed burst of requests,
    served answers against ``Predictor.outputs``, launch counts."""
    from hydragnn_tpu_torch import run_prediction
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.ops import fused_scatter as fs
    from hydragnn_tpu_torch.serve import PredictionServer, Predictor, ServingConfig
    from hydragnn_tpu_torch.serve.batcher import serving_collate

    cfg, aug, loaders, samples = prepare(seed, kind)
    spec_arch = aug["NeuralNetwork"]["Architecture"]
    n_layers = int(spec_arch["num_conv_layers"])
    model = create_model_config(aug, device=device, seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    extra = {k: spec_arch.get(k) for k in ARCH_KNOBS[kind]}
    if spec_arch.get("global_attn_engine"):
        extra["max_graph_nodes"] = spec_arch["max_graph_nodes"]
    log(f"[{kind}] model: {spec_arch['mpnn_type']} hidden {spec_arch['hidden_dim']} x "
        f"{n_layers} conv layers {extra or ''}, {n_params} parameters, precision "
        f"{aug['NeuralNetwork']['Training']['precision']}, seed {seed}")

    from hydragnn_tpu_torch import capture

    name = f"qm9_{kind}"
    config = ServingConfig(queue_depth=2048, flush_ms=5.0)
    server = PredictionServer(config, device=device)
    ep = server.add_model(name, model, aug, samples=samples)
    log(f"[{kind}] buckets (n_node, n_edge, n_graph, n_triplet): "
        f"{[b.as_tuple() for b in ep.buckets]}")
    t0 = time.perf_counter()
    server.warmup()
    captures = server.stats()[name]["captures"]
    log(f"[{kind}] warm-up: {time.perf_counter() - t0:.3f} s over {len(ep.buckets)} buckets, "
        f"{captures} CUDA graphs captured (one per bucket), then every bucket replayed under "
        f"no_new_captures")
    if device == "cuda" and captures != len(ep.buckets):
        raise AssertionError(f"serving: {captures} graphs captured for {len(ep.buckets)} buckets")
    with capture.no_new_captures(f"[{kind}] serving burst"):
        results, report, launches, stats = _serve_burst(torch, server, name, samples, device)
    n_batches = stats["batches"]
    log(f"[{kind}] served {stats['served']} requests in {n_batches} batches under "
        f"no_new_captures, failed {stats['failed']}, shed {stats['shed']}, occupancy "
        f"{stats['occupancy']:.3f}, graphs captured {stats['captures']}")
    if stats["served"] != len(samples) or stats["failed"] or stats["captures"] != captures:
        raise AssertionError(f"serving: {stats}")
    for r in results:
        if not all(np.isfinite(np.asarray(h)).all() for h in r["heads"]):
            raise AssertionError("serving: non-finite answer")
    per_batch = launches_per_forward(kind, n_layers)
    want = _scaled(per_batch, n_batches)
    log(f"[{kind}] launches during serving: {launches} (expected {want}: "
        f"{ {k: v for k, v in per_batch.items() if v} } per batch, no backward)")
    if device == "cuda" and launches != want:
        raise AssertionError(f"serving: launch counts {launches} != {want}")

    # served answers == Predictor.outputs on the same padded batch
    predictor = Predictor(model, aug, device=device)
    rows = _served_vs_outputs(ep.buckets, predictor, samples, results)
    worst = max(np.max(np.abs(a - b)) for _, _, a, b in rows)
    log(f"[{kind}] served vs Predictor.outputs on the same padded batches: "
        f"max|diff|={worst:.3e} (allowed {SERVE_ATOL})")
    if worst > SERVE_ATOL:
        raise AssertionError("serving: served answers differ from Predictor.outputs")
    if kind in MULTIBRANCH_KINDS:
        # each branch's requests, answered by its own heads
        per_branch: dict = {}
        for _, i, a, b in rows:
            n, d = per_branch.get(samples[i].dataset_id, (0, 0.0))
            per_branch[samples[i].dataset_id] = (n + 1, max(d, float(np.max(np.abs(a - b)))))
        log(f"[{kind}] served requests per branch (dataset_id: head answers, max|diff| vs "
            f"Predictor.outputs): {per_branch}")
        if sorted(per_branch) != [0, 1] or any(d > SERVE_ATOL for _, d in per_branch.values()):
            raise AssertionError(f"serving: branches {per_branch}")

    sm = report.summary()
    log(f"[{card}] [{kind}] serving, captured: {len(samples)} requests as a closed burst "
        f"(serve.traffic), {n_batches} batches, {_traffic_line(report)} (wall "
        f"{sm['wall_s']:.3f} s)")
    summary = {"captured": [sm["p50_ms"], sm["p99_ms"], sm["graphs_per_sec"]]}
    if device == "cuda":
        p50, p99, gps_, e_launches, e_batches = _eager_burst(
            torch, config, model, aug, samples, name, f"[{kind}]", samples=samples)
        summary["eager"] = [p50, p99, gps_]
        log(f"[{card}] [{kind}] serving, eager comparator (the endpoint's Predictor.outputs): "
            f"{e_batches} batches, p50 {p50:.2f} ms, p99 {p99:.2f} ms, {gps_:.1f} graphs/s")
        if e_launches != _scaled(per_batch, e_batches):
            raise AssertionError(f"serving: eager comparator launched {e_launches}")

    # the card against the port's CPU route (fp32 both), one batch
    fp32_cfg = copy.deepcopy(aug)
    fp32_cfg["NeuralNetwork"]["Training"]["precision"] = "fp32"
    test_batch = next(iter(loaders[2]))
    dev_out = Predictor(model, fp32_cfg, device=device).outputs(test_batch)
    cpu_model = copy.deepcopy(model).to("cpu")
    cpu_out = Predictor(cpu_model, fp32_cfg, device="cpu").outputs(test_batch)
    gm = test_batch.graph_mask > 0
    d = float((dev_out[0].cpu()[gm] - cpu_out[0][gm]).abs().max())
    ok = torch.allclose(dev_out[0].cpu()[gm], cpu_out[0][gm], **CPU_PARITY)
    log(f"[{kind}] {device} fp32 forward vs the CPU route on one test batch: max|diff|={d:.3e} "
        f"(rtol={CPU_PARITY['rtol']}, atol={CPU_PARITY['atol']}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError("the card's forward disagrees with the CPU route")

    # where a served batch's time goes (top bucket, as served: bf16 step;
    # each predict step gets a fresh device batch, so it builds the batch's
    # CSR views as a served batch does)
    chunk = loaders[0].samples[:64]
    pad = ep.buckets[-1]
    host_batch = serving_collate(chunk, pad)
    reps = 20
    fresh = iter([host_batch.to(device) for _ in range(reps)])
    fresh_csr = iter([host_batch.to(device) for _ in range(reps)])

    def wall_ms(fn):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            if device == "cuda":
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    t_collate = wall_ms(lambda: serving_collate(chunk, pad))
    t_h2d = wall_ms(lambda: host_batch.to(device))
    t_fwd = wall_ms(lambda: predictor.outputs(next(fresh)))
    t_cap = wall_ms(lambda: predictor.answer(host_batch))

    def build_csr():
        b = next(fresh_csr)
        for field in CSR_FORWARD[kind]:
            b.csr(field)

    t_csr = wall_ms(build_csr)
    out = predictor.outputs(host_batch)
    t_split = wall_ms(lambda: predictor.split_graphs(out, [s.num_nodes for s in chunk]))
    log(f"[{card}] [{kind}] one served batch at the top bucket (median of 20, host clock): "
        f"collate {t_collate:.3f} ms, to device {t_h2d:.3f} ms, eager predict step "
        f"{t_fwd:.3f} ms (of which building the CSR views {'+'.join(CSR_FORWARD[kind])} "
        f"{t_csr:.3f} ms); captured: the host batch copied into the graph's inputs, replay, "
        f"outputs cloned {t_cap:.3f} ms; split to numpy {t_split:.3f} ms")
    summary.update(predict_ms={"eager": t_fwd, "captured": t_cap})
    if device == "cuda":
        dev_batches = [host_batch.to(device) for _ in range(11)]
        summary["busy"] = {
            "eager": busy_share(torch, [lambda b=b: predictor.outputs(b) for b in dev_batches],
                                f"[{card}] [{kind}] eager:", "predict steps"),
            "captured": busy_share(torch, [lambda b=b: predictor.answer(b) for b in dev_batches],
                                   f"[{card}] [{kind}] captured:", "predict replays")}
        log_op_diff(f"[{card}] [{kind}] predict step:", summary["busy"]["captured"],
                    summary["busy"]["eager"])
        summary["busy"] = {k: _lean(v) for k, v in summary["busy"].items()}

    # the batch evaluator over the same molecules, which it preprocesses
    # itself (the edge lengths are appended once)
    fs.reset_launches()
    t0 = time.perf_counter()
    error, _, trues, preds = run_prediction(copy.deepcopy(cfg), model,
                                            samples=raw_samples(seed, kind), device=device)
    rp_s = time.perf_counter() - t0
    rp_launches = dict(fs.LAUNCHES)
    n_rp = len(loaders[2])
    log(f"[{kind}] run_prediction: {preds[0].shape[0]} test graphs in {n_rp} batches, mse "
        f"{error:.6f}, {rp_s:.3f} s, launches {rp_launches}")
    if not np.isfinite(error) or preds[0].shape != trues[0].shape:
        raise AssertionError("run_prediction: bad result")
    if device == "cuda" and rp_launches != _scaled(per_batch, n_rp):
        raise AssertionError(f"run_prediction: launch counts {rp_launches}")
    return {"launches": launches, "batches": n_batches, "summary": summary}


# -- phase 5: training -----------------------------------------------------------


def _sync(torch, device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def _plain_versions_on_card():
    """Inside, the ops' wrappers take their plain PyTorch versions for CUDA
    tensors too: the fp32 step check's measure of the card's own rounding
    without the kernels. The port itself routes by device only."""
    from hydragnn_tpu_torch.ops import fused_scatter as fs
    from hydragnn_tpu_torch.ops import fused_softmax as fsm

    from hydragnn_tpu_torch.ops import fused_cell_list as fcl

    saved = fs._route, fsm._route, fcl._route
    fs._route = fsm._route = fcl._route = lambda name, t: False
    try:
        yield
    finally:
        fs._route, fsm._route, fcl._route = saved


def _step_vs_cpu(torch, aug: dict, host_batch, device: str, seed: int,
                 mlip: bool = False) -> None:
    """One fp32 train step from the same parameters on the same batch, on
    ``device`` and on the port's CPU route, each held against an fp64 run of
    the step on the CPU: gradients, then updated parameters and running
    statistics against the CPU route's. Dropout is 0 here: the card's
    generator and the CPU's draw different masks from the same seed.
    ``mlip``: the MLIP step (energy + force loss, a gradient of the force
    gradient), where a second derivative the card dropped would show."""
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.models.mlip import make_mlip_train_step
    from hydragnn_tpu_torch.train.step import create_train_state
    from hydragnn_tpu_torch.train.step import make_train_step as plain_train_step

    def make_train_step(dtype, model):
        return make_mlip_train_step(model, dtype) if mlip else plain_train_step(dtype)

    aug = copy.deepcopy(aug)
    aug["NeuralNetwork"]["Architecture"]["dropout"] = 0.0
    opt_cfg = aug["NeuralNetwork"]["Training"]["Optimizer"]
    lr = float(opt_cfg["learning_rate"])
    card = create_model_config(aug, device=device, seed=seed)
    plains = [copy.deepcopy(card) for _ in range(STEP_PLAIN_DRAWS if device == "cuda" else 0)]
    host = copy.deepcopy(card).to("cpu")
    ref = copy.deepcopy(host).double()
    s_card, s_host = create_train_state(card, opt_cfg), create_train_state(host, opt_cfg)
    make_train_step(torch.float32, card)(s_card, host_batch.to(device))
    make_train_step(torch.float32, host)(s_host, host_batch)
    # the same step on the card with every kernel replaced by its plain
    # version, drawn several times: the rounding of the card's other
    # operations (matrix products, reductions) on each tensor, which the
    # kernels must not make worse
    with _plain_versions_on_card():
        for plain in plains:
            make_train_step(torch.float32, plain)(create_train_state(plain, opt_cfg),
                                                  host_batch.to(device))
    # an fp64 run of the same step (the plain versions sum fp64 input in
    # fp64)
    make_train_step(torch.float64, ref)(create_train_state(ref, opt_cfg),
                                        host_batch.map_floats(lambda t: t.double()))
    _sync(torch, device)
    grads = {n: (p.grad.cpu(), dict(host.named_parameters())[n].grad)
             for n, p in card.named_parameters()}
    plain_grads = [dict(plain.named_parameters()) for plain in plains]
    ref_grads = {n: p.grad for n, p in ref.named_parameters()}
    worst = (-1.0, "", 0.0, 0.0, 0.0, 0.0)  # (error / bound, name, card, cpu, plain, bound)
    # card, cpu and plain errors over the tensor's largest gradient (at
    # least 1e-3 of the model's: a gradient that is 0 in exact arithmetic
    # is all rounding)
    loosest = (-1.0, "", 0.0, 0.0)
    model_max = max(float(g.abs().max()) for g in ref_grads.values())
    for name, (c, h) in grads.items():
        r64 = ref_grads[name]
        g_max = float(r64.abs().max())
        card_err = float((c.double() - r64).abs().max())
        cpu_err = float((h.double() - r64).abs().max())
        plain_err = max((float((pg[name].grad.cpu().double() - r64).abs().max())
                         for pg in plain_grads), default=0.0)
        bound = STEP_GRAD_TOL["noise_factor"] * max(
            cpu_err, plain_err, STEP_GRAD_TOL["atol_of_max"] * g_max)
        if card_err > bound:
            raise AssertionError(
                f"fp32 train step: the {device} gradient of {name} misses the fp64 step by "
                f"{card_err:.3e}; the CPU route's by {cpu_err:.3e}, the {device}'s plain "
                f"versions' by {plain_err:.3e} (allowed {bound:.3e})")
        ratio = card_err / bound if bound > 0 else 0.0
        if ratio > worst[0]:
            worst = (ratio, name, card_err, cpu_err, plain_err, bound)
        scale = max(g_max, 1e-3 * model_max)
        if card_err / scale > loosest[0]:
            loosest = (card_err / scale, name, cpu_err / scale, plain_err / scale)
    worst_g = max(float((c - h).abs().max()) for c, h in grads.values())
    floor = 10 * worst_g
    worst_p = worst_noise = 0.0
    noise_room = float("-inf")  # largest (diff - 2 lr) / (eps |p|) on noise-level gradients
    noise_over = False
    n_noise = 0
    eps32 = torch.finfo(torch.float32).eps
    for (name, p), q in zip(card.named_parameters(), host.parameters()):
        g = grads[name][1]
        diff = (p.detach().cpu() - q.detach()).abs()
        noise = g.abs() <= floor
        n_noise += int(noise.sum())
        worst_p = max(worst_p, float(diff[~noise].max()) if bool((~noise).any()) else 0.0)
        worst_noise = max(worst_noise, float(diff[noise].max()) if bool(noise.any()) else 0.0)
        # opposite steps of lr each land 2 lr apart, give or take the fp32
        # rounding of the two parameters they land on
        noise_over |= bool((diff[noise] > 2 * lr + 2 * eps32 * q.detach().abs()[noise]).any())
        if bool(noise.any()):
            ulp = (eps32 * q.detach().abs()[noise]).clamp_min(torch.finfo(torch.float32).tiny)
            noise_room = max(noise_room, float(((diff[noise] - 2 * lr) / ulp).max()))
    for (name, a), b in zip(card.named_buffers(), host.buffers()):
        if not torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-6):
            raise AssertionError(f"fp32 train step: running statistic {name} differs")
    what = "fp32 MLIP train step" if mlip else "fp32 train step (dropout 0)"
    log(f"{what}, {device} vs the CPU route: max|grad diff| {worst_g:.3e}; "
        f"per tensor against an fp64 step, {device}'s error within "
        f"{STEP_GRAD_TOL['noise_factor']} x the largest of the CPU route's, the {device}'s with "
        f"the plain versions in place of the kernels (the largest of {len(plains)} draws) and "
        f"{STEP_GRAD_TOL['atol_of_max']} x the "
        f"tensor's largest gradient; closest to its bound {worst[1]}: {device} {worst[2]:.3e}, "
        f"CPU {worst[3]:.3e}, plain versions {worst[4]:.3e}, bound {worst[5]:.3e} "
        f"({100 * worst[0]:.1f}% of it); largest error relative to its tensor's largest "
        f"gradient (at least 1e-3 of the model's) {loosest[1]}: {device} {loosest[0]:.2e}, CPU "
        f"{loosest[2]:.2e}, plain versions "
        f"{loosest[3]:.2e}; parameters after AdamW max|diff| {worst_p:.3e} (allowed "
        f"{1e-3 * lr:.1e} = 1e-3 lr) and {worst_noise:.3e} on {n_noise} noise-level gradients "
        f"(allowed {2 * lr:.1e} = 2 lr, and the fp32 rounding of the parameters: the "
        f"largest (diff - 2 lr) / (eps |p|) is {noise_room:.3f}, allowed 2)")
    if worst_p > 1e-3 * lr or noise_over:
        raise AssertionError("fp32 train step: updated parameters differ from the CPU route")


def training_phase(torch, device: str, seed: int, kind: str = "gin",
                   kernel_times: dict | None = None, card: str = "",
                   epochs: int = TRAIN_EPOCHS) -> dict:
    """``run_training`` on one qm9.json model (bf16, its published widths;
    ``num_epoch`` cut to ``epochs``): falling train loss, launch counts,
    checkpoint reload, the fp32 step against the CPU route, and where a
    train step's time goes."""
    from hydragnn_tpu_torch import run_prediction, run_training
    from hydragnn_tpu_torch.config import get_log_name_config
    from hydragnn_tpu_torch.graphs.batching import collate
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.ops import fused_scatter as fs
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting
    from hydragnn_tpu_torch.train.checkpoint import load_checkpoint
    from hydragnn_tpu_torch.train.step import cast_forward, create_train_state, make_train_step

    cfg = qm9_config(kind)
    published = cfg["NeuralNetwork"]["Training"]["num_epoch"]
    cfg["NeuralNetwork"]["Training"]["num_epoch"] = epochs
    arch = cfg["NeuralNetwork"]["Architecture"]
    n_layers = int(arch["num_conv_layers"])

    def samples():
        # no encodings attached here: run_training's preprocessing attaches
        # GPS's, as it does for its users' samples
        if kind in OWN_DATA:
            return raw_samples(seed, kind)
        return qm9_like_samples(512, seed, float(arch["radius"]), int(arch["max_neighbours"]))

    loaders = dataset_loading_and_splitting(copy.deepcopy(cfg), samples=samples())
    n_train, n_val, n_test = (len(ld) for ld in loaders)
    training = cfg["NeuralNetwork"]["Training"]
    source = (f"the {cfg['Dataset']['name']} block" if kind in OWN_DATA else "the qm9.json")
    log(f"[{kind}] training: run_training on {source} {arch['mpnn_type']}"
        f"{' + GPS' if arch.get('global_attn_engine') else ''} at its published widths, "
        f"edge features {arch.get('edge_features') or 'none'}, precision "
        f"{training.get('precision', 'fp32')}, dropout "
        f"{arch.get('dropout', 0.25)} (default), loss {training['loss_function_type']}, "
        f"conv_checkpointing {bool(training.get('conv_checkpointing'))}, num_epoch "
        f"{'cut from ' + str(published) + ' ' if published != epochs else ''}to {epochs}, "
        f"{sum(len(ld.samples) for ld in loaders)} samples: {n_train} train / {n_val} val / "
        f"{n_test} test batches per epoch, seed {seed}")
    from hydragnn_tpu_torch import capture
    from hydragnn_tpu_torch.train.step import make_eval_step

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        history: list = []
        fs.reset_launches()
        captures0 = capture.total_captures()
        t0 = time.perf_counter()
        state, model, aug = run_training(copy.deepcopy(cfg), samples=samples(),
                                         device=device, path=tmp, seed=seed, history=history)
        _sync(torch, device)
        wall = time.perf_counter() - t0
        launches = dict(fs.LAUNCHES)
        losses = [h["train_loss"] for h in history]
        log(f"[{card}] [{kind}] run_training: {len(history)} epochs, {state.step} train steps "
            f"in {wall:.3f} s (epochs {[round(h['seconds'], 3) for h in history]} s, each with "
            f"its evaluations and checkpoint; the rest is set-up and the final save; "
            f"{capture.total_captures() - captures0} CUDA graphs captured: train and eval "
            f"steps per bucket); train loss per epoch {[round(x, 6) for x in losses]}; val loss "
            f"{[round(h['val_loss'], 6) for h in history]}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"training: the train loss did not fall: {losses}")
        steps, evals = state.step, len(history) * (n_val + n_test)
        per_step = launches_per_train_step(kind, n_layers)
        per_eval = launches_per_forward(kind, n_layers)
        want = _added(_scaled(per_step, steps), _scaled(per_eval, evals))
        log(f"[{kind}] launches during run_training: {launches} (expected {want}: per train "
            f"step { {k: v for k, v in per_step.items() if v} }, per eval batch "
            f"{ {k: v for k, v in per_eval.items() if v} })")
        if device == "cuda" and launches != want:
            raise AssertionError(f"training: launch counts {launches} != {want}")

        # the final checkpoint, reloaded into a fresh model (other random
        # weights), gives the trained model's run_prediction
        fresh = create_model_config(aug, device=device, seed=seed + 1)
        meta = load_checkpoint(create_train_state(fresh, aug["NeuralNetwork"]["Training"]
                                                  ["Optimizer"]),
                               get_log_name_config(aug), path=tmp)
        ref = run_prediction(copy.deepcopy(cfg), state, samples=samples(), device=device)
        got = run_prediction(copy.deepcopy(cfg), fresh, samples=samples(), device=device)
        diff = max(float(np.max(np.abs(a - b))) for a, b in zip(ref[3], got[3]))
        log(f"[{kind}] checkpoint {meta}: reloaded model's run_prediction vs the trained "
            f"model's: mse {got[0]:.6f} vs {ref[0]:.6f}, max|diff| {diff:.3e} (allowed 0)")
        if diff != 0.0 or got[0] != ref[0]:
            raise AssertionError("training: the reloaded checkpoint predicts differently")

    # one train step at the top bucket, alone: its launches
    train_ld = loaders[0]
    chunk = train_ld.samples[:64]
    host = collate(chunk, train_ld.pad)
    from hydragnn_tpu_torch.train.step import resolve_precision

    dtype = resolve_precision(str(aug["NeuralNetwork"]["Training"]["precision"]), device)
    step = make_train_step(dtype)
    fs.reset_launches()
    step(state, host.to(device))
    _sync(torch, device)
    one_step = dict(fs.LAUNCHES)
    log(f"[{kind}] launches of one eager train step: {one_step} (expected {per_step})")
    if device == "cuda" and one_step != per_step:
        raise AssertionError(f"training: one step launched {one_step} != {per_step}")
    captured = None
    if device == "cuda":
        hosts = [collate(train_ld.samples[i:i + 64], train_ld.pad) for i in range(0, 256, 64)]
        captured = captured_vs_eager(torch, state, step, make_eval_step(dtype), hosts,
                                     f"[{card}] [{kind}]", per_step, per_eval)

    _step_vs_cpu(torch, aug, host, device, seed)

    # where a bf16 train step's time goes (top bucket, median of 20, host
    # clock after a synchronise; each step on a fresh device batch, so it
    # builds the batch's CSR views as a training step does)
    reps = 20
    fresh_batches = [host.to(device) for _ in range(reps)]
    optimizer = state.optimizer
    parts: dict = {k: [] for k in ("collate", "to_device", "csr_forward", "csr_backward",
                                   "forward", "backward", "optimizer", "step")}

    def timed(key, fn):
        t = time.perf_counter()
        out = fn()
        _sync(torch, device)
        parts[key].append((time.perf_counter() - t) * 1e3)
        return out

    for b in fresh_batches:
        timed("collate", lambda: collate(chunk, train_ld.pad))
        timed("to_device", lambda: host.to(device))
        timed("csr_forward", lambda: [b.csr(f) for f in CSR_FORWARD[kind]])
        timed("csr_backward", lambda: [b.csr(f) for f in CSR_BACKWARD[kind]])
        tot = timed("forward", lambda: model.loss(
            cast_forward(model, b, dtype, train=True, generator=state.generator),
            b)[0])
        timed("backward", lambda: (optimizer.zero_grad(), tot.backward()))
        timed("optimizer", optimizer.step)
    for b in [host.to(device) for _ in range(reps)]:
        timed("step", lambda: step(state, b))
    med = {k: float(np.median(v)) for k, v in parts.items()}
    kernel_ms = step_kernel_ms(kind, n_layers, kernel_times or {})
    log(f"[{card}] [{kind}] one eager {str(dtype).split('.')[-1]} train step at the top bucket (median of {reps}, host "
        f"clock): collate {med['collate']:.3f} ms, to device {med['to_device']:.3f} ms, CSR "
        f"views {'+'.join(CSR_FORWARD[kind])} {med['csr_forward']:.3f} ms, backward CSR views "
        f"{'+'.join(CSR_BACKWARD[kind]) or '(none)'} {med['csr_backward']:.3f} ms, forward "
        f"{med['forward']:.3f} ms, backward {med['backward']:.3f} ms, optimizer "
        f"{med['optimizer']:.3f} ms; whole train step {med['step']:.3f} ms, of which kernels "
        f"~{kernel_ms * 1e3:.2f} us of device time ({100 * kernel_ms / med['step']:.2f}%)")
    eager_busy = None
    if device == "cuda":
        eager_busy = _profile_steps(torch, step, state, host, device, f"[{card}] [{kind}] eager:")
        log_op_diff(f"[{card}] [{kind}] train step:", captured["busy"], eager_busy)
    return {"launches": launches, "per_step": one_step, "breakdown": med, "layers": n_layers,
            "model": model, "aug": aug, "captured": captured, "eager_busy": eager_busy}


def busy_share(torch, calls, tag: str, what: str) -> dict | None:
    """The device's busy share over ``calls`` (functions of no argument,
    each one step; the first runs untraced) under ``torch.profiler``: the
    summed time of the device kernels and copies over the window's
    host-clock wall (the tracing slows the host, so the share is a lower
    bound), and device operations per call. Logged under ``tag``; None when
    the profiler traced no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls[0]()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for fn in calls[1:]:
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        log(f"{tag} profiler: no device events traced; busy share not measured")
        return None
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    n = len(calls) - 1
    names: dict = {}
    for e in dev:
        names[e.name[:80]] = names.get(e.name[:80], 0) + 1
    out = {"busy_us": busy_us / n, "wall_ms": wall_us / n / 1e3,
           "busy_pct": 100 * busy_us / wall_us, "ops": len(dev) / n,
           "by_name": {k: v / n for k, v in names.items()}}
    log(f"{tag} profiler over {n} {what}: device busy {out['busy_us']:.1f} us per call of "
        f"{out['wall_ms']:.3f} ms wall ({out['busy_pct']:.2f}% busy, "
        f"{100 - out['busy_pct']:.2f}% idle), {out['ops']:.0f} device operations per call")
    return out


def log_op_diff(tag: str, captured: dict | None, eager: dict | None) -> dict:
    """Log, and return, the device operations whose count per call differs
    between a captured path and its eager step (:func:`busy_share`'s
    ``by_name``): ``{name: [captured, eager]}``."""
    if not captured or not eager:
        return {}
    a, b = captured["by_name"], eager["by_name"]
    diff = {k: [round(a.get(k, 0), 2), round(b.get(k, 0), 2)] for k in sorted(set(a) | set(b))
            if round(a.get(k, 0)) != round(b.get(k, 0))}
    log(f"{tag} device operations per call that differ, [captured, eager]: {json.dumps(diff)}")
    return diff


def _lean(busy: dict | None) -> dict | None:
    """:func:`busy_share`'s result without its per-name counts."""
    return None if busy is None else {k: v for k, v in busy.items() if k != "by_name"}


def superstep_phase(torch, seed: int, card: str = "", epochs: int = 2) -> dict:
    """``run_training`` of the qm9.json GIN (bf16) with
    ``Training.steps_per_dispatch: 4`` (``num_epoch`` cut to ``epochs``):
    its epoch losses and final state bit-equal to one step per dispatch over
    the same bucket-major plan (the epoch loop with the loader's
    ``set_superstep(4)``), its launch counts those of its train steps and
    evaluations; returns both runs' seconds."""
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.ops import fused_scatter as fs
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting
    from hydragnn_tpu_torch.train.loop import train_validate_test
    from hydragnn_tpu_torch.train.step import create_train_state, resolve_precision

    cfg = qm9_config("gin")
    training = cfg["NeuralNetwork"]["Training"]
    training.update(num_epoch=epochs, steps_per_dispatch=4)
    arch = cfg["NeuralNetwork"]["Architecture"]
    layers = int(arch["num_conv_layers"])

    def samples():
        return qm9_like_samples(512, seed, float(arch["radius"]), int(arch["max_neighbours"]))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        h4: list = []
        fs.reset_launches()
        t0 = time.perf_counter()
        s4, _, aug = run_training(copy.deepcopy(cfg), samples=samples(), device="cuda",
                                  path=tmp, seed=seed, history=h4)
        torch.cuda.synchronize()
        wall4 = time.perf_counter() - t0
        launches = dict(fs.LAUNCHES)
        one = copy.deepcopy(cfg)
        one["NeuralNetwork"]["Training"]["steps_per_dispatch"] = 1
        # as run_training prepares them (the loading writes into the config)
        loaders = dataset_loading_and_splitting(one, samples=samples())
        aug1 = update_config(one, *(ld.samples for ld in loaders))
        s1 = create_train_state(create_model_config(aug1, device="cuda", seed=seed),
                                aug1["NeuralNetwork"]["Training"]["Optimizer"], seed)
        loaders[0].set_superstep(4)
        h1: list = []
        t0 = time.perf_counter()
        train_validate_test(s1, *loaders, aug1["NeuralNetwork"], "k1",
                            compute_dtype=resolve_precision(str(training["precision"]), "cuda"),
                            path=tmp, history=h1)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
    keys = ("train_loss", "val_loss", "test_loss")
    same_losses = [[h[k] for k in keys] for h in h4] == [[h[k] for k in keys] for h in h1]
    diffs = _state_diffs(torch, s4, s1)
    n_val, n_test = len(loaders[1]), len(loaders[2])
    want = _added(_scaled(launches_per_train_step("gin", layers), s4.step),
                  _scaled(launches_per_forward("gin", layers), epochs * (n_val + n_test)))
    out = {"k4_s": wall4, "k1_s": wall1}
    log(f"[{card}] [gin] run_training with steps_per_dispatch 4: {len(h4)} epochs, {s4.step} "
        f"train steps in {wall4:.3f} s (one step per dispatch over the same bucket-major plan: "
        f"{wall1:.3f} s); epoch losses {'bit-equal' if same_losses else 'DIFFERENT'} "
        f"({[round(h['train_loss'], 6) for h in h4]}), final state "
        f"{'bit-equal' if not diffs else 'DIFFERENT: ' + ', '.join(diffs[:6])}; launches "
        f"{launches} (expected {want})")
    if not same_losses or diffs:
        raise AssertionError("supersteps: K = 4 differs from K = 1 over the same plan")
    if launches != want:
        raise AssertionError(f"supersteps: launch counts {launches} != {want}")
    return out


def _profile_steps(torch, step, state, host, device: str, tag: str, n_steps: int = 10):
    """:func:`busy_share` of ``n_steps`` calls of ``step`` (the eager train
    step, or a captured one) on fresh device copies of ``host``."""
    batches = [host.to(device) for _ in range(n_steps)]
    return busy_share(torch, [lambda b=b: step(state, b) for b in batches], tag, "train steps")


# -- the captured steps against the eager ones ------------------------------------------


def _twin(torch, state):
    """A copy of a train state: its model and optimizer copied together (the
    copy's optimizer steps the copy's parameters), its generator at the
    same state."""
    from hydragnn_tpu_torch.train.step import TrainState

    model, optimizer = copy.deepcopy((state.model, state.optimizer))
    gen = None
    if state.generator is not None:
        gen = torch.Generator(device=state.generator.device)
        gen.set_state(state.generator.get_state())
    return TrainState(model=model, optimizer=optimizer, step=state.step, generator=gen)


def _state_diffs(torch, a, b) -> list[str]:
    """What differs, bit for bit, between two train states: parameters,
    buffers, optimizer state, learning rate, step count, generator."""
    out = [name for (name, x), y in zip(a.model.state_dict().items(),
                                        b.model.state_dict().values()) if not torch.equal(x, y)]
    for i, (sa, sb) in enumerate(zip(a.optimizer.state.values(), b.optimizer.state.values())):
        out += [f"optimizer[{i}].{k}" for k in sa if not torch.equal(sa[k], sb[k])]
    la, lb = a.optimizer.param_groups[0]["lr"], b.optimizer.param_groups[0]["lr"]
    if not torch.equal(torch.as_tensor(la), torch.as_tensor(lb)):
        out.append("lr")
    if a.step != b.step:
        out.append("step")
    if a.generator is not None and not torch.equal(a.generator.get_state(),
                                                    b.generator.get_state()):
        out.append("generator")
    return out


def _same_tree(torch, x, y) -> bool:
    if torch.is_tensor(x):
        return torch.equal(x, y)
    if isinstance(x, dict):
        return all(_same_tree(torch, x[k], y[k]) for k in x)
    return all(_same_tree(torch, u, v) for u, v in zip(x, y, strict=True))


def captured_vs_eager(torch, state, step, eval_step, hosts, tag: str, per_step: dict,
                      per_eval: dict, reps: int = 20) -> dict:
    """The captured train and eval steps (``capture.Dispatch``, as the epoch
    loop runs them) against the eager steps they capture, from two copies
    of ``state``: four train steps on four host batches of one bucket (the
    learning rate halved before the last), every metric and the whole state
    (parameters, running statistics, AdamW moments, step counts, dropout
    generator) bit-equal; two eval batches bit-equal; the launch record of
    one replay equal to ``per_step`` and ``per_eval``. Then the captured
    step's time (median of ``reps``, host clock after a synchronise, each
    on a fresh device batch: copy into the graph's inputs, replay, clone the
    metrics) and its device busy share. Gates raise; returns the times."""
    from hydragnn_tpu_torch import capture
    from hydragnn_tpu_torch.train.optimizer import get_learning_rate, set_learning_rate

    captured, eager = _twin(torch, state), _twin(torch, state)
    train = capture.Dispatch(step, "train", train=True)
    lr = get_learning_rate(eager.optimizer)
    for i, host in enumerate(hosts[:4]):
        if i == 3:
            for s_ in (captured, eager):
                set_learning_rate(s_.optimizer, lr / 2)
        b = host.to("cuda")
        got, want = train(captured, b), step(eager, b)
        diffs = _state_diffs(torch, captured, eager)
        if not _same_tree(torch, got, want) or diffs:
            raise AssertionError(f"{tag} captured train step {i} differs from the eager step: "
                                 f"metrics equal {_same_tree(torch, got, want)}, state {diffs[:8]}")
    evals = capture.Dispatch(eval_step, "eval")
    for host in hosts[:2]:
        b = host.to("cuda")
        if not _same_tree(torch, evals(captured, b), eval_step(eager, b)):
            raise AssertionError(f"{tag} captured eval step differs from the eager step")
    (g_train,) = train.graphs.graphs.values()
    (g_eval,) = evals.graphs.graphs.values()
    want_step, want_eval = dict(per_step), dict(per_eval)
    if g_train.launches != want_step or g_eval.launches != want_eval:
        raise AssertionError(f"{tag} launch records per replay: train {g_train.launches} "
                             f"(eager {want_step}), eval {g_eval.launches} (eager {want_eval})")
    fresh = [hosts[0].to("cuda") for _ in range(reps)]
    times = []
    for b in fresh:
        t0 = time.perf_counter()
        train(captured, b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    busy = busy_share(torch, [lambda b=b: train(captured, b) for b in fresh[:10]],
                      f"{tag} captured:", "train-step replays")
    out = {"step_ms": float(np.median(times)), "busy": busy}
    log(f"{tag} captured train steps: 4 steps (the learning rate halved before the last) and 2 "
        f"eval batches bit-equal to the eager steps (parameters, running statistics, AdamW "
        f"moments, step count, generator, metrics); launches per replay {g_train.launches} "
        f"train, {g_eval.launches} eval, equal to the eager steps'; one captured train step "
        f"(copy into the graph's inputs, replay, metrics cloned out; median of {reps}, host "
        f"clock) {out['step_ms']:.3f} ms")
    return out


# molecules each smaller-depth combination is prepared from: enough for a
# top-bucket batch of 64 training samples
VARIANT_SAMPLES = 160
# graphs of the batch the CPU route runs (fp32 parity, launch counts)
VARIANT_CPU_GRAPHS = 16


@contextlib.contextmanager
def cpu_route_calls():
    """Inside, the calls of the kernels' launchers with CPU tensors, where
    the wrappers take their plain versions, count into the yielded dict by
    ``fused_scatter.LAUNCHES``'s names: what the card launches on the same
    step."""
    from hydragnn_tpu_torch.ops import fused_scatter as fs
    from hydragnn_tpu_torch.ops import fused_softmax as fsm

    counts = dict.fromkeys(KERNELS, 0)
    saved = {(fs, "_segment_sum"): fs._segment_sum, (fs, "_gather_scatter"): fs._gather_scatter,
             (fsm, "_segment_softmax"): fsm._segment_softmax,
             (fsm, "_masked_softmax"): fsm._masked_softmax}

    def counted(attr, fn):
        def call(*args, **kwargs):
            if not args[0].is_cuda:
                name = args[-1] if attr == "_gather_scatter" else attr.lstrip("_")
                counts[name] += 1
            return fn(*args, **kwargs)
        return call

    for (module, attr), fn in saved.items():
        setattr(module, attr, counted(attr, fn))
    try:
        yield counts
    finally:
        for (module, attr), fn in saved.items():
            setattr(module, attr, fn)


def variant_phase(torch, seed: int, name: str, card: str = "", device: str = "cuda") -> dict:
    """One smaller-depth combination of ``VARIANTS`` (2 conv layers, random
    weights from ``seed``, bf16 steps), not trained: :func:`step_checks` on
    a batch of 64 of its training molecules. Returns the launches."""
    _, aug, loaders, _ = prepare(seed, name, n_samples=VARIANT_SAMPLES)
    return step_checks(torch, seed, name, aug, loaders[0], card, device)


def _heads_close(torch, got, want, batch, cols) -> tuple[float, bool]:
    """(max |got - want| over every head's real rows, all within
    ``CPU_PARITY``): graph heads on the real graphs, node heads on the
    real nodes."""
    worst, ok = 0.0, True
    for (kind, _, _), g, w in zip(cols, got, want):
        rows = (batch.graph_mask if kind == "graph" else batch.node_mask) > 0
        g, w = g.cpu()[rows], w[rows]
        worst = max(worst, float((g - w).abs().max()))
        ok &= bool(torch.allclose(g, w, **CPU_PARITY))
    return worst, ok


def step_checks(torch, seed: int, name: str, aug: dict, train_ld, card: str = "",
                device: str = "cuda", dtype=None) -> dict:
    """A model of ``aug`` (random weights from ``seed``) on its training
    loader ``train_ld``: one captured train step bit-equal to its eager
    step (parameters, running statistics, optimizer moments, generator,
    metrics) on a batch of up to 64 samples; the eager step's launches and
    the captured graph's launch record equal to the CPU route's launcher
    calls on the same step; the card's fp32 forward against the CPU route
    on every head's real rows (``CPU_PARITY``), with the predict step's
    launches equal to the CPU route's. ``dtype``: the train steps'
    (default bf16). Returns the launches."""
    from hydragnn_tpu_torch import capture
    from hydragnn_tpu_torch.graphs.batching import collate
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.ops import fused_scatter as fs
    from hydragnn_tpu_torch.serve import Predictor
    from hydragnn_tpu_torch.train.step import create_train_state, make_train_step

    t0 = time.perf_counter()
    arch = aug["NeuralNetwork"]["Architecture"]
    chunk = min(64, int(aug["NeuralNetwork"]["Training"]["batch_size"]))
    host = collate(train_ld.samples[:chunk], train_ld.pad)
    small = train_ld.samples[:min(VARIANT_CPU_GRAPHS, chunk)]
    model = create_model_config(aug, device=device, seed=seed)
    state = create_train_state(model, aug["NeuralNetwork"]["Training"]["Optimizer"], seed=seed)
    step = make_train_step(dtype or torch.bfloat16)

    # the CPU route's launcher calls: one train step and one fp32 predict
    # step (launch counts depend on the layout, not on the rows)
    cpu_state = create_train_state(copy.deepcopy(model).to("cpu"),
                                   aug["NeuralNetwork"]["Training"]["Optimizer"], seed=seed)
    with cpu_route_calls() as want_step:
        step(cpu_state, collate(small, train_ld.pad))
    fp32_cfg = copy.deepcopy(aug)
    fp32_cfg["NeuralNetwork"]["Training"]["precision"] = "fp32"
    test_host = collate(small, train_ld.pad)
    with cpu_route_calls() as want_fwd:
        cpu_out = Predictor(copy.deepcopy(model).to("cpu"), fp32_cfg, device="cpu").outputs(
            test_host)

    # the card: eager and captured train step from the same state
    captured, eager = _twin(torch, state), _twin(torch, state)
    train = capture.Dispatch(step, "train", train=True)
    b = host.to(device)
    got = train(captured, b)
    fs.reset_launches()
    want = step(eager, b)
    _sync(torch, device)
    eager_launches = dict(fs.LAUNCHES)
    diffs = _state_diffs(torch, captured, eager)
    # the CPU runs the eager step for both and counts no launch: the launch
    # gates hold on the card
    record = (next(iter(train.graphs.graphs.values())).launches if device == "cuda"
              else dict(want_step))
    loss = float(want["loss"])
    fs.reset_launches()
    predictor = Predictor(model, fp32_cfg, device=device)
    dev_out = predictor.outputs(test_host)
    _sync(torch, device)
    fwd_launches = dict(fs.LAUNCHES)
    d, ok_cpu = _heads_close(torch, dev_out, cpu_out, test_host, predictor.cols)
    options = [f"{k} {arch[k]}" for k in ("graph_attr_conditioning_mode",)
               if arch.get("use_graph_attr_conditioning")]
    options += [f"{len(v)} {k} branches" for k, v in arch["output_heads"].items() if len(v) > 1]
    log(f"[{card}] [{name}] {arch['mpnn_type']}{' + GPS' if arch.get('global_attn_engine') else ''}"
        f" x {arch['num_conv_layers']} layers, edge_dim {arch.get('edge_dim') or 0}"
        f"{', ' + ', '.join(options) if options else ''}: captured train step vs eager: metrics "
        f"equal {_same_tree(torch, got, want)}, state differs in "
        f"{diffs[:6] or 'nothing'} (loss {loss:.6g}); launches: eager step "
        f"{ {k: v for k, v in eager_launches.items() if v} }, graph record "
        f"{ {k: v for k, v in record.items() if v} }, CPU route "
        f"{ {k: v for k, v in want_step.items() if v} }; fp32 forward vs the CPU route "
        f"max|diff| {d:.3e} ({'ok' if ok_cpu else 'MISMATCH'}), launches "
        f"{ {k: v for k, v in fwd_launches.items() if v} } (CPU route "
        f"{ {k: v for k, v in want_fwd.items() if v} }); {time.perf_counter() - t0:.2f} s")
    if not _same_tree(torch, got, want) or diffs or not np.isfinite(loss):
        raise AssertionError(f"{name}: the captured train step differs from the eager step")
    if not ok_cpu:
        raise AssertionError(f"{name}: the fp32 forward disagrees with the CPU route")
    if device == "cuda" and (eager_launches != want_step or record != want_step
                             or fwd_launches != want_fwd or not any(want_step.values())):
        raise AssertionError(f"{name}: launches: train step {eager_launches} (graph {record}), "
                             f"forward {fwd_launches}; the CPU route's {want_step}, {want_fwd}")
    return {"per_step": eager_launches, "per_forward": fwd_launches}


# -- phase 5d: the options of the skeleton (PR 14) ------------------------------

# the six optax optimizers the port computes itself (train/optimizer.py)
OPTAX_TYPES = ("RMSProp", "Adagrad", "Adadelta", "Adamax", "LAMB", "FusedLAMB")
OPTIMIZER_STEPS = 10


def optimizer_phase(torch, seed: int, card: str = "", device: str = "cuda") -> dict:
    """Each of ``OPTAX_TYPES`` on the qm9.json GIN at its published widths
    (random weights from ``seed``, bf16 steps at the top bucket, four
    batches of 64 in turn): ``OPTIMIZER_STEPS`` captured train steps
    bit-equal to as many eager steps from copies of one state (parameters,
    running statistics, the optimizer's state, the learning rate halved
    before the eighth step on both), the graph's launch record the GIN's per
    train step; then one fp32 train step on the card against the CPU route
    from the same parameters (:func:`optimizer_step_vs_cpu`). Returns the
    captured steps' times."""
    from hydragnn_tpu_torch import capture
    from hydragnn_tpu_torch.graphs.batching import collate
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.train.optimizer import get_learning_rate, set_learning_rate
    from hydragnn_tpu_torch.train.step import create_train_state, make_train_step

    _, aug, loaders, _ = prepare(seed, "gin")
    train_ld = loaders[0]
    hosts = [collate(train_ld.samples[i:i + 64], train_ld.pad) for i in range(0, 256, 64)]
    layers = int(aug["NeuralNetwork"]["Architecture"]["num_conv_layers"])
    per_step = launches_per_train_step("gin", layers)
    out = {}
    for opt_type in OPTAX_TYPES:
        t0 = time.perf_counter()
        cfg = copy.deepcopy(aug)
        opt_cfg = cfg["NeuralNetwork"]["Training"]["Optimizer"]
        opt_cfg["type"] = opt_type
        model = create_model_config(cfg, device=device, seed=seed)
        state = create_train_state(model, opt_cfg, seed=seed)
        step = make_train_step(torch.bfloat16)
        captured, eager = _twin(torch, state), _twin(torch, state)
        train = capture.Dispatch(step, f"train {opt_type}", train=True)
        lr = get_learning_rate(eager.optimizer)
        for i in range(OPTIMIZER_STEPS):
            if i == 7:
                for s_ in (captured, eager):
                    set_learning_rate(s_.optimizer, lr / 2)
            b = hosts[i % len(hosts)].to(device)
            got, want = train(captured, b), step(eager, b)
            diffs = _state_diffs(torch, captured, eager)
            if not _same_tree(torch, got, want) or diffs:
                raise AssertionError(f"{opt_type}: captured train step {i} differs from the "
                                     f"eager step: {diffs[:8]}")
        record = (next(iter(train.graphs.graphs.values())).launches if device == "cuda"
                  else dict(per_step))
        if record != per_step:
            raise AssertionError(f"{opt_type}: launch record {record} != {per_step}")
        times = []
        if device == "cuda":
            fresh = [hosts[0].to(device) for _ in range(10)]
            for b in fresh:
                t1 = time.perf_counter()
                train(captured, b)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
        cmp = optimizer_step_vs_cpu(torch, cfg, hosts[0], device, seed)
        med = float(np.median(times)) if times else float("nan")
        log(f"[{card}] [optimizer {opt_type}] qm9.json GIN: {OPTIMIZER_STEPS} captured bf16 train "
            f"steps bit-equal to the eager steps (the learning rate halved before the eighth), "
            f"launches per replay {record}; one captured step (median of {len(times)}, host "
            f"clock) {med:.3f} ms; one fp32 step {device} vs the CPU route: {cmp['line']}; "
            f"{time.perf_counter() - t0:.2f} s")
        out[opt_type] = {"step_ms": med, "cpu_max_diff": cmp["signal"]}
    return out


def optimizer_step_vs_cpu(torch, cfg: dict, host, device: str, seed: int) -> dict:
    """One fp32 train step of ``cfg``'s model and optimizer (random weights
    from ``seed``) on ``device`` and on the port's CPU route from the same
    parameters. The updated parameters agree within ``CPU_PARITY`` wherever
    the gradient exceeds ten times the largest card-vs-CPU gradient
    difference; elsewhere the gradient is fp32 noise (a bias in front of a
    batch norm: 0 in exact arithmetic), whose sign each side's step
    follows, and Adamax and LAMB step by up to ~0.1 and ~1e-3 of the rate on
    it, so there the two differ by at most both steps together (plus
    ``CPU_PARITY``'s atol). Raises otherwise; returns the largest
    differences and a log line."""
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.train.step import create_train_state, make_train_step

    opt_cfg = cfg["NeuralNetwork"]["Training"]["Optimizer"]
    fp32 = make_train_step(torch.float32)
    start = create_model_config(cfg, device="cpu", seed=seed)
    dev = create_train_state(create_model_config(cfg, device=device, seed=seed), opt_cfg)
    cpu = create_train_state(create_model_config(cfg, device="cpu", seed=seed), opt_cfg)
    fp32(dev, host.to(device))
    fp32(cpu, host)
    params = list(zip(dev.model.named_parameters(), cpu.model.parameters(), start.parameters()))
    floor = 10 * max(float((p.grad.cpu() - q.grad).abs().max()) for (_, p), q, _ in params)
    signal = noise = moved = 0.0
    n_noise, bad = 0, []
    for (name, p), q, p0 in params:
        a, c, a0 = p.detach().cpu(), q.detach(), p0.detach()
        diff = (a - c).abs()
        is_noise = q.grad.abs() <= floor
        n_noise += int(is_noise.sum())
        moved = max(moved, float((c - a0).abs().max()))
        room = CPU_PARITY["atol"] + CPU_PARITY["rtol"] * c.abs()
        steps = (a - a0).abs() + (c - a0).abs() + CPU_PARITY["atol"]
        if bool((~is_noise).any()):
            signal = max(signal, float(diff[~is_noise].max()))
        if bool(is_noise.any()):
            noise = max(noise, float(diff[is_noise].max()))
        if bool((diff > torch.where(is_noise, steps, room)).any()):
            bad.append(name)
    line = (f"parameters max|diff| {signal:.3e} where the gradient is signal (rtol "
            f"{CPU_PARITY['rtol']}, atol {CPU_PARITY['atol']}), {noise:.3e} on {n_noise} "
            f"noise-level gradients (|g| <= {floor:.1e}, allowed both steps); the step moved "
            f"them by up to {moved:.3e}")
    if bad or moved <= 0.0:
        raise AssertionError(f"the {device} optimizer step disagrees with the CPU route: {bad}; "
                             f"{line}")
    return {"signal": signal, "noise": noise, "line": line}


def conv_checkpointing_phase(torch, seed: int, gat: dict, gat_ckpt: dict, card: str = "",
                             device: str = "cuda") -> dict:
    """The qm9.json GAT trained with and without ``conv_checkpointing``
    (``training_phase``, same seed, data and dropout generator): the two
    trained models bit-equal. Then, from the trained GAT's state and one
    generator state, one captured bf16 train step of each on the same top
    bucket batch: gradients, parameters, running statistics, metrics and
    generator bit-equal, the launch records ``launches_per_train_step``'s
    (the checkpointed one recomputes each layer's softmax and aggregation);
    each eager step's peak device memory above the state's
    (``torch.cuda.max_memory_allocated``) and each captured step's time
    (median of 20, host clock), logged."""
    from hydragnn_tpu_torch import capture
    from hydragnn_tpu_torch.graphs.batching import collate
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.train.step import create_train_state, make_train_step

    trained = [n for (n, a), b in zip(gat["model"].state_dict().items(),
                                      gat_ckpt["model"].state_dict().values())
               if not torch.equal(a, b)]
    if trained:
        raise AssertionError(f"gat_ckpt: the checkpointed training gave another model: {trained}")
    _, _, loaders, _ = prepare(seed, "gat")
    host = collate(loaders[0].samples[:64], loaders[0].pad)
    layers = gat["layers"]
    states = []
    for entry in (gat, gat_ckpt):
        aug = entry["aug"]
        model = create_model_config(aug, device=device, seed=seed)
        model.load_state_dict(gat["model"].state_dict())
        states.append(create_train_state(model, aug["NeuralNetwork"]["Training"]["Optimizer"],
                                         seed=seed))
    step = make_train_step(torch.bfloat16)
    peaks, times, outs, twins, records = [], [], [], [], []
    for name, st in zip(("plain", "checkpointed"), states):
        tw = _twin(torch, st)
        b = host.to(device)
        if device == "cuda":
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        step(tw, b)
        _sync(torch, device)
        peaks.append((torch.cuda.max_memory_allocated() - base) / 2**20
                     if device == "cuda" else float("nan"))
        tw = _twin(torch, st)
        disp = capture.Dispatch(step, f"train {name}", train=True)
        outs.append(disp(tw, host.to(device)))
        # the captured step's gradients and the state after it, before the
        # timing replays move it on
        twins.append(([p.grad.clone() for p in tw.model.parameters()], _twin(torch, tw)))
        records.append(next(iter(disp.graphs.graphs.values())).launches
                       if device == "cuda" else None)
        if device == "cuda":
            ts = []
            for b in [host.to(device) for _ in range(20)]:
                t0 = time.perf_counter()
                disp(tw, b)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            times.append(float(np.median(ts)))
    (g_a, a), (g_c, c) = twins
    names = [n for n, _ in a.model.named_parameters()]
    grads = [n for n, p, q in zip(names, g_a, g_c) if not torch.equal(p, q)]
    diffs = _state_diffs(torch, a, c)
    want = [launches_per_train_step("gat", layers), launches_per_train_step("gat_ckpt", layers)]
    log(f"[{card}] [gat_ckpt] the trained GAT with and without conv_checkpointing: models "
        f"bit-equal; from one state and generator, one captured bf16 train step each at the "
        f"top bucket (N={host.num_nodes}, E={host.num_edges}): metrics equal "
        f"{_same_tree(torch, outs[0], outs[1])}, gradients differ in {grads[:6] or 'nothing'}, "
        f"state in {diffs[:6] or 'nothing'}; launch records plain "
        f"{ {k: v for k, v in (records[0] or {}).items() if v} }, checkpointed "
        f"{ {k: v for k, v in (records[1] or {}).items() if v} }; peak device memory of an "
        f"eager step above the state's: plain {peaks[0]:.1f} MiB, checkpointed "
        f"{peaks[1]:.1f} MiB; captured step (median of 20, host clock): plain "
        f"{times[0] if times else float('nan'):.3f} ms, checkpointed "
        f"{times[1] if times else float('nan'):.3f} ms")
    if grads or diffs or not _same_tree(torch, outs[0], outs[1]):
        raise AssertionError("gat_ckpt: the checkpointed step differs from the plain step")
    if device == "cuda" and records != want:
        raise AssertionError(f"gat_ckpt: launch records {records} != {want}")
    return {"peak_mib": peaks, "step_ms": times}


# -- phase 10: quantized serving ----------------------------------------------------


def _real_rows(torch, batch, rows: int):
    """The mask of a Dense input's real rows by its row count: nodes,
    edges, graphs or triplets of ``batch`` (three rows per node or edge
    where a ``[N, 3, F]`` vector channel reaches the layer flat); all rows
    when the count names none of them."""
    masks = {}
    for field in ("triplet_mask", "graph_mask", "edge_mask", "node_mask"):
        m = getattr(batch, field, None)
        if m is not None and m.numel():
            m = m.detach().cpu() > 0
            masks[m.numel()] = m
            masks.setdefault(3 * m.numel(), m.repeat_interleave(3))
    return masks.get(rows, torch.ones(rows, dtype=torch.bool))


def _count_code_flips(torch, steps, run, batch) -> dict:
    """Run ``run(step)`` for each of two quantized steps and compare, per
    Dense call, the int8 codes of the two (recomputed from each call's
    input with the plain quantizer, so they differ only where the inputs
    do): ``flips`` (codes that differ), ``real`` (of those, on the real
    rows of ``batch``: a pad row carries no answer), ``far`` (codes more
    than one step apart on real rows), ``inputs`` (input entries that
    differ), ``names`` (the calls' layers) and ``n_codes``."""
    from hydragnn_tpu_torch.ops.quant_matmul import quantize_acts

    seen = [[], []]
    for i, step in enumerate(steps):
        inner = step._dense

        def spy(module, x, _i=i, _step=step, _inner=inner):
            name = _step._names.get(module)
            if name in _step.scales:
                x2 = x.reshape(-1, x.shape[-1])
                seen[_i].append((name, x2.float().cpu(),
                                 quantize_acts(x2, _step.scales[name]).cpu()))
            return _inner(module, x)

        step._dense = spy
        try:
            run(step)
        finally:
            del step._dense
    out = {"flips": [], "real": [], "far": [], "inputs": [], "names": [], "n_codes": 0}
    for (name, xa, ca), (_, xb, cb) in zip(*seen):
        diff = ca != cb
        real = _real_rows(torch, batch, ca.shape[0])[:, None]
        out["names"].append(name)
        out["flips"].append(int(diff.sum()))
        out["real"].append(int((diff & real).sum()))
        out["far"].append(int((((ca.int() - cb.int()).abs() > 1) & real).sum()))
        out["inputs"].append(int((xa != xb).sum()))
        out["n_codes"] += ca.numel()
    return out


def _whole_split_calibration(torch, kind: str, pred, train, samples, pad) -> None:
    """Measured, not gated: the int8 step calibrated and certified on the
    whole training split (collated 64 to a batch at the top bucket; a
    sample's activations do not depend on its batch), and its error on all
    requests: the bound a certificate that covers the traffic gives."""
    from hydragnn_tpu_torch.serve import quant as sq
    from hydragnn_tpu_torch.serve.batcher import serving_collate

    n = min(64, pad.n_graph - 1)
    cal = [serving_collate(train[i:i + n], pad) for i in range(0, len(train), n)]
    scales = sq.collect_activation_scales(pred.model, cal, pred.compute_dtype)
    step = sq.make_quantized_predict_step(pred.model, scales,
                                          sq.quantize_dense_weights(pred.model, scales),
                                          pred.compute_dtype)
    bounds = sq.certify_quant_error(pred, step, cal)
    traffic = [serving_collate(samples[i:i + n], pad) for i in range(0, len(samples), n)]
    worst = sq.certify_quant_error(pred, step, traffic)
    log(f"[{kind}] int8 step calibrated on all {len(train)} training samples (measured, not "
        f"gated): bounds {[f'{b:.6f}' for b in bounds]}; on all {len(samples)} requests "
        f"{[f'{w:.6f}' for w in worst]}")


def _refusal_attribution(torch, kind: str, pred, train, pad, k: int) -> None:
    """Measured, not gated (for a refusal outside its pin, and under
    ``--quant-diagnostics``): the certified bound with one Dense quantized
    at a time (the warm-up's calibration batches at the top bucket), and
    the running variances of the feature norms, which scale the
    quantization noise of the Dense outputs they normalise by
    ``|scale| / sqrt(var + eps)``."""
    from hydragnn_tpu_torch.serve import quant as sq
    from hydragnn_tpu_torch.serve.batcher import serving_collate

    cal = [serving_collate([s], pad) for s in sorted(train, key=lambda s: -s.num_nodes)[:k]]
    scales = sq.collect_activation_scales(pred.model, cal, pred.compute_dtype)
    weights = sq.quantize_dense_weights(pred.model, scales)
    alone = {name: sq.certify_quant_error(pred, sq.make_quantized_predict_step(
        pred.model, {name: scales[name]}, {name: weights[name]}, pred.compute_dtype), cal)
        for name in scales}
    norms = [(float(n.var.min()), float(n.var.max()),
              float((n.scale.detach().abs() / torch.sqrt(n.var + n.epsilon)).max()))
             for n in getattr(pred.model, "feature_layers", [])]
    log(f"[{kind}] the certified bound by layer, one Dense quantized at a time: "
        + "; ".join(f"{name} {max(b):.4f}" for name, b in alone.items())
        + "; feature norms (running var min, max, max |scale| / sqrt(var + eps)): "
        + "; ".join(f"{i}: {lo:.4g}, {hi:.4g}, {g:.3f}" for i, (lo, hi, g) in enumerate(norms)))


def _check_refusal(kind: str, device: str, qserver, epq, name: str, cfg,
                   bounds: list[float]) -> float:
    """A refused int8 warm-up: no int8 step kept and ``start()`` raises
    again. Returns the ``quant_tol`` the model then serves at, if its
    refusal is the known one (``QUANT_KNOWN_REFUSALS``, at its pinned bound
    on the card); raises otherwise."""
    from hydragnn_tpu_torch.serve import QuantizationError

    if epq.quant_steps or qserver.stats()[name]["quantized"]:
        raise AssertionError("quantized serving: a refused endpoint kept an int8 step")
    if device == "cuda" and list(epq.predictor.dispatches) != [epq.predictor.predict_step]:
        raise AssertionError("quantized serving: a refused endpoint kept an int8 graph")
    try:
        qserver.start()
    except QuantizationError:
        pass
    else:
        qserver.stop()
        raise AssertionError("quantized serving: a refused endpoint started (fp32)")
    pinned = QUANT_KNOWN_REFUSALS.get(kind)
    worst = max(bounds)
    log(f"[{kind}] int8 warm-up REFUSED at quant_tol {cfg.quant_tol}: certified per-head "
        f"bounds {[round(x, 6) for x in bounds]}; no int8 step kept, start() raises again; "
        f"known refusal: {pinned} (+-{QUANT_REFUSAL_RTOL:.0%} on the card)")
    if pinned is None:
        raise AssertionError(f"quantized serving: {kind} refused at quant_tol {cfg.quant_tol}")
    # the pin is a card measurement: a CPU rehearsal trains another model
    if device == "cuda" and abs(worst - pinned) > QUANT_REFUSAL_RTOL * pinned:
        raise AssertionError(f"quantized serving: {kind} refused at bound {worst:.6f}, not at "
                             f"its pinned {pinned} +- {QUANT_REFUSAL_RTOL:.0%}")
    return (pinned if device == "cuda" else worst) * (1 + QUANT_REFUSAL_RTOL)


def quant_serving_phase(torch, device: str, seed: int, kind: str, model, aug: dict,
                        card: str = "", diagnostics: bool = False,
                        comparators: bool = True) -> dict:
    """The model that the training phase just trained, behind two servers
    in one run: fp32, then ``Serving.quantize: true`` at the config's
    default ``quant_tol``, calibrated on the training samples; 512
    requests each (a closed burst). The certified bounds must lie within
    ``quant_tol``, but for the known refusals (``_check_refusal``: refused
    at the pinned bound, then served at that bound). Gates: served int8
    answers equal ``Predictor.outputs(batch, step=<the bucket's int8
    step>)`` bit for bit; per served batch one ``quant_dense`` launch per
    Dense call and the fp32 path's other launches; batch independence (the
    calibration samples among the served requests keep within their
    certified bounds of the fp32 answers); the card's int8 step against the
    CPU route's with the same tables; the fp32 answers unchanged. The
    whole traffic's int8 error against the bounds is logged: the
    certificate does not cover it (ROADMAP queue C). ``diagnostics`` adds
    ``_refusal_attribution`` and ``_whole_split_calibration``;
    ``comparators`` the eager comparator bursts (the GIN, GAT and GPS-GIN:
    the ten newer stacks keep their serving phase's)."""
    from hydragnn_tpu_torch.graphs.batching import pick_bucket
    from hydragnn_tpu_torch.models.common import intercept_dense
    from hydragnn_tpu_torch.serve import (PredictionServer, Predictor, QuantizationError,
                                          ServingConfig)
    from hydragnn_tpu_torch.serve import quant as sq
    from hydragnn_tpu_torch.serve.batcher import serving_collate

    _, _, loaders, samples = prepare(seed, kind)  # requests carry GPS's encodings
    train = loaders[0].samples
    layers = int(aug["NeuralNetwork"]["Architecture"]["num_conv_layers"])
    name = f"qm9_{kind}_trained"
    from hydragnn_tpu_torch import capture

    fp32_cfg = ServingConfig(queue_depth=2048, flush_ms=5.0)
    fp32 = PredictionServer(fp32_cfg, device=device)
    ep32 = fp32.add_model(name, model, aug, samples=samples)
    fp32.warmup()
    pred = ep32.predictor
    probe = serving_collate(train[:min(64, ep32.buckets[-1].n_graph - 1)], ep32.buckets[-1])
    before = [t.clone() for t in pred.outputs(probe)]
    with capture.no_new_captures(f"[{kind}] trained fp32 serving burst"):
        res32, rep32, _, stats32 = _serve_burst(torch, fp32, name, samples, device)
    if stats32["failed"]:
        raise AssertionError(f"serving: {stats32}")
    worst32 = max(np.max(np.abs(a - b)) for _, _, a, b in
                  _served_vs_outputs(ep32.buckets, pred, samples, res32))

    cfg = ServingConfig(queue_depth=2048, flush_ms=5.0, quantize=True)
    qserver = PredictionServer(cfg, device=device)
    epq = qserver.add_model(name, model, aug, samples=train, buckets=ep32.buckets)
    t0 = time.perf_counter()
    try:
        report = qserver.warmup()[name]["quant"]
        refused = None
    except QuantizationError as exc:
        if exc.bounds is None:
            raise
        refused = exc.bounds
        try:
            tol = _check_refusal(kind, device, qserver, epq, name, cfg, refused)
        except AssertionError:
            _refusal_attribution(torch, kind, pred, train, ep32.buckets[-1],
                                 cfg.quant_calib_batches)
            raise
        cfg = dataclasses.replace(cfg, quant_tol=tol)
        qserver = PredictionServer(cfg, device=device)
        epq = qserver.add_model(name, model, aug, samples=train, buckets=ep32.buckets)
        t0 = time.perf_counter()
        report = qserver.warmup()[name]["quant"]
    warm_s = time.perf_counter() - t0
    bounds = epq.quant_bounds
    n_dense = {b: rep["n_dense_layers"] for b, rep in report["buckets"].items()}
    log(f"[{kind}] int8 warm-up: {warm_s:.3f} s over {len(epq.buckets)} buckets, "
        f"{cfg.quant_calib_batches} calibration batches each (the largest training samples "
        f"each bucket admits), Dense layers per bucket {sorted(set(n_dense.values()))}; "
        f"certified per-head bounds {[round(x, 6) for x in bounds]} (quant_tol "
        f"{cfg.quant_tol}); per bucket "
        f"{ {b: [round(x, 6) for x in r['error_bounds']] for b, r in report['buckets'].items()} }")
    after = pred.outputs(probe)
    if not all(torch.equal(a, b) for a, b in zip(before, after)):
        raise AssertionError("quantized serving: the int8 half changed the fp32 answers")

    calls = []
    with intercept_dense(lambda m, x: calls.append(m)):
        pred.outputs(probe)
    # a layer called more than once per forward (film's conditioner, once
    # per conv layer) has one table entry and launches at every call
    layers_called = len({id(m) for m in calls})
    if any(n != layers_called for n in n_dense.values()) or \
            len(calls) != QUANT_DENSE_CALLS[kind]:
        raise AssertionError(f"quantized serving: {n_dense} Dense layers calibrated, "
                             f"{layers_called} called, {len(calls)} Dense calls per forward, "
                             f"{QUANT_DENSE_CALLS[kind]} derived on the CPU route")
    with capture.no_new_captures(f"[{kind}] int8 serving burst"):
        resq, repq, launches, statsq = _serve_burst(torch, qserver, name, samples, device)
    n_batches = statsq["batches"]
    want = _scaled(dict(launches_per_forward(kind, layers), quant_dense=len(calls)), n_batches)
    log(f"[{kind}] int8 serving: {statsq['served']} requests in {n_batches} batches, "
        f"quantized buckets {statsq['quantized']}, launches {launches} (expected {want}: "
        f"{len(calls)} quant_dense per batch, one per Dense call, and the fp32 path's others)")
    if statsq["served"] != len(samples) or statsq["failed"] or statsq["quantized"] != len(
            epq.buckets):
        raise AssertionError(f"quantized serving: {statsq}")
    if device == "cuda" and launches != want:
        raise AssertionError(f"quantized serving: launch counts {launches} != {want}")

    rows = _served_vs_outputs(epq.buckets, pred, samples, resq,
                              step_for=lambda pad: epq.quant_steps[pad.as_tuple()])
    worst = max(float(np.max(np.abs(a - b))) for _, _, a, b in rows)
    # against the fp32 answers of the same padded batches: the calibration
    # samples (what the certificate covers) and the whole traffic
    calib = set()
    for pad in epq.buckets:
        fitting = [s for s in train if pick_bucket([pad], s.num_nodes, s.num_edges, 0, 1)]
        calib |= {id(s) for s in sorted(fitting, key=lambda s: -s.num_nodes)[
            :cfg.quant_calib_batches]}
    dev_cal, dev_all = [0.0] * len(bounds), [0.0] * len(bounds)
    over = 0  # head answers of the traffic outside their certified bound
    for (ihead, i, a, _), (_, _, _, f) in zip(
            rows, _served_vs_outputs(epq.buckets, pred, samples, resq)):
        d = float(np.max(np.abs(a - f)))
        dev_all[ihead] = max(dev_all[ihead], d)
        over += d > bounds[ihead]
        if id(samples[i]) in calib:
            dev_cal[ihead] = max(dev_cal[ihead], d)
    n_cal = sum(id(s) in calib for s in samples)
    log(f"[{kind}] served int8 vs Predictor.outputs(step=int8 step) on the same padded "
        f"batches: max|diff| {worst:.3e} (allowed 0); vs the fp32 answers of those batches, "
        f"per head: batch independence, the {n_cal} calibration samples served among the "
        f"traffic {[f'{x:.6f}' for x in dev_cal]} (allowed the bounds + {QUANT_CALIB_ATOL}); "
        f"the issue's traffic gate, all {len(samples)} requests "
        f"{[f'{x:.6f}' for x in dev_all]} = "
        f"{[round(d / b, 3) if b else None for d, b in zip(dev_all, bounds)]}"
        f" of the bounds, {over} head answers over their bound "
        f"({'met' if not over else 'NOT MET: the 4-sample certificate does not bound the traffic, ROADMAP queue C'})")
    if worst > 0:
        raise AssertionError("quantized serving: served answers differ from outputs(step=...)")
    if n_cal == 0 or any(d > b + QUANT_CALIB_ATOL for d, b in zip(dev_cal, bounds)):
        raise AssertionError("quantized serving: batch independence: a calibration sample "
                             "served among the traffic is outside its certified bound")
    if diagnostics:
        _refusal_attribution(torch, kind, pred, train, epq.buckets[-1], cfg.quant_calib_batches)
        _whole_split_calibration(torch, kind, pred, train, samples, epq.buckets[-1])

    # the card's int8 step against the CPU route's, with the same tables
    top = epq.buckets[-1]
    step = epq.quant_steps[top.as_tuple()]
    cpu_model = copy.deepcopy(model).to("cpu")
    cpu_weights = {k: tuple(None if t is None else t.cpu() for t in v)
                   for k, v in step.weights.items()}
    cpu_step = sq.make_quantized_predict_step(cpu_model, step.scales, cpu_weights,
                                              step.compute_dtype)
    cpu_pred = Predictor(cpu_model, aug, device="cpu")
    cmp = _count_code_flips(torch, (step, cpu_step),
                            lambda s: (pred if s is step else cpu_pred).outputs(probe, step=s),
                            probe)
    flips = cmp["flips"]
    _, dev_rows = pred.gather(probe, out=pred.outputs(probe, step=step))
    _, cpu_rows = cpu_pred.gather(probe, out=cpu_pred.outputs(probe, step=cpu_step))
    # with the same codes every int8 layer is exact, so the two steps differ
    # only as their fp32 forwards do (CPU_PARITY); a flipped code would move
    # the heads by a share of the int8 error. The GIN, GAT and GPS-GIN flip
    # none, pad rows included (every run so far). The ten newer stacks
    # (SAGE to MACE) are held on the real rows (PNA's std over the dummy pad
    # node's thousands of equal pad messages is fp32 noise that differs
    # between the two, ROADMAP queue C item 13), but for INT8_INPUT_FLIPS
    # (ROADMAP queue C item 16)
    first = next((n for n, k in zip(cmp["names"], cmp["inputs"]) if k), None)
    answer_tol = [CPU_PARITY["atol"]] * len(bounds)
    if kind in MODELS:
        bad, allowed = sum(flips), "0, pad rows included"
    elif kind in INT8_INPUT_FLIPS:
        bad, allowed = 0, "any: inputs the card and the CPU round apart, INT8_INPUT_FLIPS"
    elif kind in INT8_GPS_INPUT_FLIPS:
        bad, allowed = sum(cmp["far"]), ("one step from the CPU's on real rows, answers within "
                                         "the certified bounds: INT8_GPS_INPUT_FLIPS")
        answer_tol = list(bounds)
    else:
        bad, allowed = sum(cmp["real"]), "0 on real rows"
    diffs = [float(np.max(np.abs(a - b) - CPU_PARITY["rtol"] * np.abs(b)))
             for a, b in zip(dev_rows, cpu_rows)]
    log(f"[{kind}] int8 step at the top bucket, {device} vs the CPU route with the same scales "
        f"and weights: int8 codes that differ per Dense call {flips} of {cmp['n_codes']}, on "
        f"real rows {cmp['real']} (allowed {allowed}), more than one step apart on real rows "
        f"{sum(cmp['far'])}; Dense inputs that differ per call {cmp['inputs']} (first at "
        f"{first}); per head max(|diff| - {CPU_PARITY['rtol']} |CPU answer|) "
        f"{[f'{d:.3e}' for d in diffs]} (allowed {[f'{t:.3e}' for t in answer_tol]})")
    if bad or any(d > t for d, t in zip(diffs, answer_tol)):
        raise AssertionError("quantized serving: the card's int8 step disagrees with the CPU's")

    log(f"[{card}] [{kind}] trained model, {len(samples)} requests as a closed burst "
        f"(serve.traffic), captured: fp32 {_traffic_line(rep32)} ({stats32['batches']} "
        f"batches; served vs Predictor.outputs {worst32:.1e}); int8 {_traffic_line(repq)} "
        f"({n_batches} batches); graphs captured fp32 {stats32['captures']}, int8 server "
        f"{statsq['captures']}")
    summary = {"fp32": [rep32.summary()[k] for k in ("p50_ms", "p99_ms", "graphs_per_sec")],
               "int8": [repq.summary()[k] for k in ("p50_ms", "p99_ms", "graphs_per_sec")]}
    if device == "cuda" and comparators:
        e32 = _eager_burst(torch, fp32_cfg, model, aug, samples, name, f"[{kind}]",
                           samples=samples)
        eq = _eager_burst(torch, cfg, model, aug, samples, name, f"[{kind}]",
                          samples=train, buckets=ep32.buckets)
        log(f"[{card}] [{kind}] trained model, eager comparators (Predictor.outputs): fp32 p50 "
            f"{e32[0]:.2f} ms, p99 {e32[1]:.2f} ms, {e32[2]:.1f} graphs/s; int8 p50 "
            f"{eq[0]:.2f} ms, p99 {eq[1]:.2f} ms, {eq[2]:.1f} graphs/s")
        if eq[3] != _scaled(dict(launches_per_forward(kind, layers), quant_dense=len(calls)),
                            eq[4]):
            raise AssertionError(f"quantized serving: eager comparator launched {eq[3]}")
    if worst32 > SERVE_ATOL:
        raise AssertionError("serving: fp32 served answers differ from Predictor.outputs")
    return {"launches": launches, "batches": n_batches, "dense_calls": len(calls),
            "bounds": bounds, "refused": refused, "quant_tol": cfg.quant_tol,
            "flips": sum(flips), "real_flips": sum(cmp["real"]), "n_codes": cmp["n_codes"],
            "summary": summary}


# -- phase 6: the convergence canaries ------------------------------------------


def canary_config(name: str, epochs: int | None = None) -> dict:
    """``CANARY_CONFIG`` for one canary: the GIN with one graph head, or
    the 4-head variant of ``tests/test_training_e2e.py`` (graph sum + nodal
    x, x2, x3; graph head weighted 20x; node heads 2 x 10; batch 16; lr
    0.01), the GIN's or an invariant stack's with its ``CANARY_OVERRIDES``;
    GAT at hidden 8; GPS-GIN with 2 heads and encodings of width 2
    (``tests/test_gps.py``); ``gat_edge`` and ``gps_pna_edge``: GAT and
    GPS-PNA in those forms with the edge lengths as edge features;
    ``gps_performer``: GPS-GIN with performer attention; ``gin_per_node``
    and ``gin_conv_heads``: the 4-head GIN with node heads of type
    ``mlp_per_node`` and ``conv`` (``CANARY_NODE_TYPE``)."""
    cfg = copy.deepcopy(CANARY_CONFIG)
    cfg["NeuralNetwork"]["Training"]["num_epoch"] = epochs or CANARIES[name][2]
    arch = cfg["NeuralNetwork"]["Architecture"]
    if name == "gin_four_heads" or name in CANARY_OVERRIDES or name in CANARY_NODE_TYPE:
        arch.update(CANARY_OVERRIDES.get(name, {}))
        cfg["NeuralNetwork"]["Variables_of_interest"] = {
            "input_node_features": [0], "output_names": ["sum", "x", "x2", "x3"],
            "output_index": [0, 1, 2, 3], "type": ["graph", "node", "node", "node"],
            "denormalize_output": False,
        }
        arch["task_weights"] = [20.0, 1.0, 1.0, 1.0]
        arch["output_heads"]["graph"]["dim_sharedlayers"] = 10
        arch["output_heads"]["node"] = {"num_headlayers": 2, "dim_headlayers": [10, 10],
                                        "type": CANARY_NODE_TYPE.get(name, "mlp")}
        cfg["NeuralNetwork"]["Training"]["Optimizer"]["learning_rate"] = 0.01
    elif name in ("gat", "gat_edge"):
        arch.update(mpnn_type="GAT", hidden_dim=8)
    elif name in ("gps_gin", "gps_pna_edge", "gps_performer"):
        arch.update(global_attn_engine="GPS", global_attn_heads=2, pe_dim=2)
        if name == "gps_pna_edge":
            arch["mpnn_type"] = "PNA"
        if name == "gps_performer":
            arch["global_attn_type"] = "performer"
    if name in ("gat_edge", "gps_pna_edge"):
        cfg["Dataset"]["compute_edge_lengths"] = True
        arch["edge_features"] = ["length"]
    return cfg


def _model_kind(cfg: dict) -> str:
    """The key of ``ARCH_KNOBS`` whose launch counts a config's model
    follows."""
    arch = cfg["NeuralNetwork"]["Architecture"]
    if arch.get("global_attn_engine"):
        if arch.get("global_attn_type") == "performer":
            return "gps_performer"
        return "gps_pna_edge" if arch["mpnn_type"] == "PNA" else "gps"
    if arch.get("edge_features") and arch["mpnn_type"] == "GAT":
        return "gat_edge"
    return {v["mpnn_type"]: k for k, v in {**MODELS, **STACKS, **GEOMETRIC}.items()
            if "mpnn_type" in v}.get(arch["mpnn_type"], "gin")


def canary_phase(torch, device: str, card: str = "", epochs: int | None = None,
                 n_samples: int | None = None, check: bool = True,
                 names=tuple(CANARIES)) -> dict:
    """The canaries through run_training and run_prediction on the BCC
    data, every held head below the reference thresholds; the node-head
    canaries (``CANARY_NODE_TYPE``) also through :func:`step_checks`
    (captured against eager, the CPU route)."""
    from hydragnn_tpu_torch import run_prediction, run_training
    from hydragnn_tpu_torch.datasets import deterministic_graph_data
    from hydragnn_tpu_torch.ops import fused_scatter as fs

    out = {}
    for name in names:
        n_default, data_seed, _, rmse_max, mae_max, held = CANARIES[name]
        n = n_samples or n_default
        cfg = canary_config(name, epochs)

        def data():
            return deterministic_graph_data(n, seed=data_seed, **CANARY_DATA.get(name, {}))

        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            fs.reset_launches()
            t0 = time.perf_counter()
            state, _, aug = run_training(copy.deepcopy(cfg), device=device, path=tmp,
                                         samples=data())
            _, _, trues, preds = run_prediction(copy.deepcopy(cfg), state, device=device,
                                                samples=data())
            _sync(torch, device)
            wall = time.perf_counter() - t0
        launches = dict(fs.LAUNCHES)
        pairs = list(zip(trues, preds))[:held]
        rmse = [float(np.sqrt(np.mean((t - p) ** 2))) for t, p in pairs]
        mae = [float(np.mean(np.abs(t - p))) for t, p in pairs]
        log(f"[{card}] canary {name}: {cfg['NeuralNetwork']['Training']['num_epoch']} epochs, "
            f"{n} samples (seed {data_seed}), {state.step} steps, run_training + "
            f"run_prediction {wall:.3f} s; head RMSE {[round(x, 4) for x in rmse]} (< "
            f"{rmse_max}), sample MAE {[round(x, 4) for x in mae]}"
            f"{f' (< {mae_max})' if mae_max is not None else ' (not held)'}; launches "
            f"{launches}")
        if check and (max(rmse) >= rmse_max or (mae_max is not None and max(mae) >= mae_max)):
            raise AssertionError(f"canary {name} missed the reference thresholds")
        per_step = launches_per_train_step(
            _model_kind(cfg), int(cfg["NeuralNetwork"]["Architecture"]["num_conv_layers"]))
        missing = [k for k, v in per_step.items() if v and launches[k] <= 0]
        if device == "cuda" and missing:
            raise AssertionError(f"canary {name}: {missing} not launched: {launches}")
        out[name] = {"seconds": wall, "rmse": rmse, "mae": mae}
        if name in CANARY_NODE_TYPE:
            from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

            loaders = dataset_loading_and_splitting(copy.deepcopy(cfg), samples=data())
            out[name]["steps"] = step_checks(torch, 0, f"canary {name}", aug, loaders[0], card,
                                             device, dtype=torch.float32)
    return out


# -- phase 7: kernel B5 and the repaired backwards ------------------------------


def second_derivative_phase(torch, batch, device: str = "cuda") -> float:
    """The repaired backwards on the card: the second derivatives (the
    gradient of a gradient taken with ``create_graph=True``, in the inputs
    and in the upstream gradient) of ``fused_segment_sum``,
    ``gather_rows``, ``gather_scatter_sum`` (in ``h`` and its per-edge
    weight) and ``segment_softmax``, with the kernels against the plain
    versions on the same inputs, at the top QM9 bucket's shapes. Pad rows
    carry zero data, as the models mask them. Returns the largest
    difference."""
    from hydragnn_tpu_torch.ops import fused_scatter as fs
    from hydragnn_tpu_torch.ops import fused_softmax as fsm

    dev = torch.device(device)
    b = batch.to(dev)
    n, e = b.num_nodes, b.num_edges
    gen = torch.Generator(device="cpu").manual_seed(77)
    mask = b.edge_mask
    recv_idx, send_idx = b.csr("receivers"), b.csr("senders")
    loop_send, loop_recv = b.self_loop_edges()
    loop_idx = b.csr("loop_receivers")
    e_ext = loop_recv.shape[0]
    e_mask = torch.cat([mask, mask.new_zeros(e_ext - e - n), mask.new_ones(n)])
    real_nodes = (torch.arange(n, device=dev) < n - 1).float()

    def rand(*shape, rows=None):
        x = torch.randn(*shape, generator=gen).to(dev)
        return x * rows.reshape((-1,) + (1,) * (len(shape) - 1)) if rows is not None else x

    # (function, inputs, the row masks of its inputs and of its output):
    # the directions v of the second derivative are masked like the inputs
    cases = {
        "fused_segment_sum": (lambda x: fs.fused_segment_sum(x, b.receivers, n, index=recv_idx),
                              [rand(e, 64, rows=mask)], [mask], real_nodes),
        "gather_rows": (lambda x: fs.gather_rows(x, b.senders, send_idx),
                        [rand(n, 64, rows=real_nodes)], [real_nodes], mask),
        "gather_scatter_sum": (
            lambda h, w: fs.gather_scatter_sum(h, b.senders, b.receivers, n, weight=w,
                                               index=recv_idx, send_index=send_idx),
            [rand(n, 64, rows=real_nodes), rand(e, rows=mask).abs()], [real_nodes, mask],
            real_nodes),
        "segment_softmax": (lambda x: fsm.segment_softmax(
            torch.where(e_mask[:, None] > 0, x, -1e9), loop_recv, n, index=loop_idx),
            [rand(e_ext, 6)], [e_mask], e_mask),
    }

    def second(fn, inputs, dy, v):
        xs = [x.clone().requires_grad_(True) for x in inputs]
        dy = dy.clone().requires_grad_(True)
        grads = torch.autograd.grad(fn(*xs), xs, dy, create_graph=True)
        inner = sum((g * vi).sum() for g, vi in zip(grads, v))
        return torch.autograd.grad(inner, xs + [dy], allow_unused=True)

    worst = 0.0
    log("repaired backwards: second derivatives, kernels against the plain versions on the "
        "card (every backward is the port's own Functions; none calls a raw launcher):")
    for name, (fn, inputs, in_rows, out_rows) in cases.items():
        dy = rand(*fn(*inputs).shape, rows=out_rows)
        v = [rand(*x.shape, rows=r) for x, r in zip(inputs, in_rows)]
        before = dict(fs.LAUNCHES)
        got = second(fn, inputs, dy, v)
        _sync(torch, device)
        launched = {k: fs.LAUNCHES[k] - before[k] for k in KERNELS if fs.LAUNCHES[k] != before[k]}
        with _plain_versions_on_card():
            want = second(fn, inputs, dy, v)
        errs = []
        for k, (g, w) in enumerate(zip(got, want)):
            if g is None and w is None:
                continue
            g = torch.zeros_like(w) if g is None else g
            w = torch.zeros_like(g) if w is None else w
            errs.append(_compare(torch, f"{name} d2[{k}] {tuple(g.shape)}", g, w, g.shape[0],
                                 "float32"))
        log(f"    {name}: launches in the double backward {launched}")
        if device == "cuda" and not launched:
            raise AssertionError(f"{name}: the double backward launched no kernel")
        worst = max([worst] + errs)
    return worst


def lj_lattice(k: int = 20, a: float = 2.2, seed: int = 0):
    """The analytic-LJ MD system of ``bench.py``'s ``bench_md`` and
    ``md_rollout.py --big``: a ``k**3`` simple-cubic lattice of spacing
    ``a`` (8,000 atoms at k = 20), jittered 0.05, velocities 0.02, from
    ``seed``."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*([np.arange(k)] * 3), indexing="ij"), -1)
    pos = (g.reshape(-1, 3) * a + a / 2 + 0.05 * rng.normal(size=(k**3, 3))).astype(np.float32)
    vel = (0.02 * rng.normal(size=(k**3, 3))).astype(np.float32)
    return pos, vel, np.eye(3, dtype=np.float32) * (k * a)


def lj_energy(torch):
    """``bench_md``'s LJ pair energy (sigma 2.0, epsilon 0.02), each pair
    counted once over the directed edges. The positions are gathered onto
    the edges with ``gather_rows``: autograd's own backward of ``p[r]`` on
    the card would walk the ~420k pad slots, all at one atom, one by one
    (or sum them with atomics); this one is the segment-sum kernel."""
    from hydragnn_tpu_torch.ops.fused_scatter import gather_rows

    def lj(p, s, r, sh, em):
        d = gather_rows(p, r) - gather_rows(p, s) + sh
        d2 = (d * d).sum(-1) + (1.0 - em)
        inv6 = (2.0**2 / d2) ** 3
        return 0.5 * torch.sum(em * 4.0 * 0.02 * (inv6 * inv6 - inv6))
    return lj


def mlip_md_sample(aug: dict, cells_per_dim: int = MLIP_MD_CELLS, seed: int = 0):
    """The MLIP MD system: one periodic LJ cell of ``cells_per_dim**3``
    atoms (1,000, box 38 Å) with the training data's lattice and density,
    its node features min-max normalised as the training set's were."""
    from hydragnn_tpu_torch.datasets import lennard_jones_data
    from hydragnn_tpu_torch.preprocess.load_data import apply_variables_of_interest

    arch = aug["NeuralNetwork"]["Architecture"]
    (sample,) = apply_variables_of_interest(lennard_jones_data(
        number_configurations=1, cells_per_dim=cells_per_dim, radius=float(arch["radius"]),
        max_neighbours=int(arch["max_neighbours"]), relative_maximum_atomic_displacement=0.05,
        seed=seed), copy.deepcopy(aug))
    lo, hi = (np.asarray(v, np.float32) for v in
              aug["NeuralNetwork"]["Variables_of_interest"]["minmax_node_feature"])
    fx = sample.x.shape[1]
    sample.x = ((sample.x - lo[:fx]) / (hi[:fx] - lo[:fx])).astype(np.float32)
    return sample


def md_systems(aug: dict, seed: int, lj_k: int = 20, mlip_cells: int = MLIP_MD_CELLS) -> dict:
    """Both MD systems' positions, cells and neighbour plans."""
    from hydragnn_tpu_torch.md import plan_cell_grid

    sample = mlip_md_sample(aug, cells_per_dim=mlip_cells, seed=seed + 100)
    cutoff = float(aug["NeuralNetwork"]["Architecture"]["radius"])
    n = sample.num_nodes
    pos, vel, cell = lj_lattice(lj_k, seed=seed)
    mlip_vel = (MLIP_MD_V0 * np.random.default_rng(seed + 200).normal(size=(n, 3))).astype(
        np.float32)
    out = {
        "mlip": dict(pos=sample.pos.astype(np.float32), vel=mlip_vel,
                     cell=sample.cell.astype(np.float32), pbc=np.ones(3, bool), cutoff=cutoff,
                     max_edges=MLIP_MD_EDGES_PER_ATOM * n, sample=sample),
        "lj": dict(pos=pos, vel=vel, cell=cell, pbc=np.ones(3, bool), cutoff=LJ_MD_CUTOFF,
                   max_edges=LJ_MD_EDGES_PER_ATOM * pos.shape[0]),
    }
    for sys_ in out.values():
        sys_["plan"] = plan_cell_grid(sys_["cell"], sys_["cutoff"], sys_["pos"].shape[0],
                                      pbc=sys_["pbc"])
    return out


def cell_list_phase(torch, systems: dict, device: str = "cuda", timing: bool = True):
    """Kernel B5 against its plain version on the card at both MD systems'
    shapes (ids, masks and ``n_edges`` identical, shifts within 1e-6 and
    reported bit-equal or not), a slab with one open axis, an overflowing
    capacity (``n_edges`` equal), two launches bit-identical, the edge set
    against the dense build, then its device time beside the plain
    version's and its bound, the whole build's time, and the device
    operations of both. Returns the kernel's JSON entry (``launches``
    filled in later)."""
    from hydragnn_tpu_torch.md import dynamic_radius_graph, plan_cell_grid
    from hydragnn_tpu_torch.ops import fused_cell_list as fcl
    from hydragnn_tpu_torch.ops import fused_scatter as fs

    dev = torch.device(device)
    log("cell_list (replaces ops/fused_cell_list.py:90 _cell_kernel): kernel vs plain version "
        "(the XLA build transliterated) on the card")

    def build(sys_, plan=None, pbc=None):
        grid, cap = plan or sys_["plan"]
        pos = torch.from_numpy(sys_["pos"]).to(dev)
        cell = torch.from_numpy(sys_["cell"]).to(dev)
        pbc_t = torch.from_numpy(np.asarray(sys_["pbc"] if pbc is None else pbc)).to(dev)
        return lambda: fcl.binned_radius_graph(pos, sys_["cutoff"], sys_["max_edges"],
                                                     cell, pbc_t, grid, cap,
                                                     pad_id=sys_["pos"].shape[0] - 1)

    def compare(label, fn, poisoned=False):
        before = fs.LAUNCHES["cell_list"]
        got = fn()
        _sync(torch, device)
        if device == "cuda" and fs.LAUNCHES["cell_list"] != before + 1:
            raise AssertionError(f"cell_list {label}: the kernel did not launch once")
        with _plain_versions_on_card():
            want = fn()
        s, r, sh, m, ne = got
        ws, wr, wsh, wm, wne = want
        ok = int(ne) == int(wne)
        err = 0.0
        if not poisoned:
            ok = ok and torch.equal(s, ws) and torch.equal(r, wr) and torch.equal(m, wm)
            err = float((sh - wsh).abs().max())
            ok = ok and err <= 1e-6
            live = m > 0
            bits.append(torch.equal(sh[live].view(torch.int32), wsh[live].view(torch.int32)))
        log(f"  {label}: n_edges {int(ne)} (plain {int(wne)}), "
            f"{'n_edges only (poisoned)' if poisoned else 'ids, mask identical'}, "
            f"max|shift diff| {err:.3e} (allowed 1e-6"
            f"{'' if poisoned else '; live shifts bit-equal' if bits[-1] else '; bits differ'}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"cell_list {label}: kernel disagrees with the plain version")
        return got, err

    bits: list = []

    errs = []
    outs = {}
    for key, label in (("mlip", "MLIP MD cell"), ("lj", "analytic-LJ lattice")):
        sys_ = systems[key]
        grid, cap = sys_["plan"]
        outs[key], err = compare(
            f"{label}: {sys_['pos'].shape[0]} atoms, cutoff {sys_['cutoff']}, grid {grid}, "
            f"capacity {cap}, max_edges {sys_['max_edges']}", build(sys_))
        errs.append(err)
    slab = systems["mlip"]
    slab_pbc = np.array([True, True, False])
    slab_plan = plan_cell_grid(slab["cell"], slab["cutoff"], slab["pos"].shape[0], pbc=slab_pbc)
    errs.append(compare(f"slab (z open): grid {slab_plan[0]}, capacity {slab_plan[1]}",
                        build(slab, slab_plan, slab_pbc))[1])
    lj = systems["lj"]
    tight = plan_cell_grid(lj["cell"], lj["cutoff"], lj["pos"].shape[0], capacity_factor=1.05)
    (_, _, _, _, ne), _ = compare(f"overflow (capacity_factor 1.05, capacity {tight[1]})",
                                  build(lj, tight), poisoned=True)
    if int(ne) <= lj["max_edges"]:
        raise AssertionError("cell_list: an overflowing cell did not poison n_edges")
    _bit_stable(torch, "cell_list", lambda: torch.cat(
        [t.reshape(-1).float() for t in build(systems["lj"])()]))
    log("  two launches on the same inputs: bit-identical")
    # the same edges as the dense build on the MLIP MD cell
    m = systems["mlip"]
    s, r, sh, em, ne = outs["mlip"]
    ds, dr, dsh, dem, dne = dynamic_radius_graph(
        torch.from_numpy(m["pos"]).to(dev), m["cutoff"], m["max_edges"],
        cell=torch.from_numpy(m["cell"]).to(dev), pbc=torch.from_numpy(m["pbc"]).to(dev))
    k = int(ne)
    cell_pairs = {(a, b): i for i, (a, b) in enumerate(zip(s[:k].tolist(), r[:k].tolist()))}
    dense_pairs = {(a, b): i for i, (a, b) in enumerate(zip(ds[:k].tolist(), dr[:k].tolist()))}
    same = int(dne) == k and set(cell_pairs) == set(dense_pairs)
    if same:
        order = torch.tensor([cell_pairs[p] for p in dense_pairs], device=dev)
        shift_err = float((sh[order] - dsh[:k]).abs().max())
        same = shift_err <= 1e-6
    log(f"  edge set vs the dense build ({m['pos'].shape[0]}-atom MLIP cell): {k} edges, "
        f"{'equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("cell_list: the edge set differs from the dense build's")
    entry = {"name": "cell_list", "route": "cuda",
             "source": "hydragnn_tpu_torch/csrc/cell_list.cu",
             "replaces": "hydragnn_tpu/ops/fused_cell_list.py:90", "launches": 0,
             "max_abs_err": max(errs), "library_ms": None, "shifts_bit_equal": all(bits)}
    if not timing:
        return entry
    # device time per call at both systems: the pair test (the kernel and
    # what its wrapper launches around it), against the plain version's
    # candidate matrix and nonzero (which waits for the host: timed by
    # events around back-to-back calls); the whole build (prelude, pairs,
    # epilogue) beside them; each one's device operations under the profiler
    times = {}
    for key in ("lj", "mlip"):
        sys_ = systems[key]
        grid, cap = sys_["plan"]
        pos = torch.from_numpy(sys_["pos"]).to(dev)
        cellm, inv, pbcf = fcl.geometry(torch.from_numpy(sys_["cell"]).to(dev),
                                        torch.from_numpy(sys_["pbc"]).to(dev), pos.dtype, dev)
        n_cells = grid[0] * grid[1] * grid[2]
        idx3, order, cs, start, occ = fcl._prelude(pos, cellm, inv, pbcf, grid, n_cells)
        args = (pos, sys_["cutoff"], sys_["max_edges"], cellm, inv, pbcf, grid, cap, idx3,
                order)

        def md_build(pos=pos, sys_=sys_, geo=(cellm, inv, pbcf), grid=grid, cap=cap):
            # the whole build as an MD loop runs it, the cell's geometry
            # computed once beforehand
            return fcl.cell_list_edges(pos, sys_["cutoff"], sys_["max_edges"], geo, grid, cap,
                                       pad_id=pos.shape[0] - 1)
        t = dict(
            ms=graph_time_ms(torch, lambda: fcl._kernel_cell_pairs(*args, start, occ)),
            plain_ms=event_time_ms(torch, lambda: fcl.plain_cell_pairs(*args, cs),
                                   iters=10, reps=3),
            build_ms=graph_time_ms(torch, md_build),
        )
        with _plain_versions_on_card():
            t["plain_build_ms"] = event_time_ms(torch, md_build, iters=10, reps=3)
        # the work this run's data needs: every candidate pair tested once
        # (~48 fp32 operations: two 3 x 3 products, three roundings, the
        # displacement and d^2), each input read once (positions, cell
        # coordinates, sort order: 28 B per atom; the cell table: 8 B per
        # cell), each edge written once (8 B)
        n = pos.shape[0]
        offs = torch.as_tensor(fcl._CELL_OFFSETS, device=dev)
        g = torch.tensor(grid, device=dev)
        nbr = idx3[:, None, :] + offs[None]
        valid = ((pbcf > 0) | ((nbr >= 0) & (nbr < g))).all(-1)
        w = torch.remainder(nbr, g)
        ncid = (w[..., 0] * grid[1] + w[..., 1]) * grid[2] + w[..., 2]
        candidates = int((torch.clamp(occ[ncid.long()], max=cap) * valid).sum())
        edges = min(int(outs[key][4]), sys_["max_edges"])
        t["bytes"] = 28 * n + 8 * n_cells + 8 * edges + 21 * 4
        t["ops"] = 48 * candidates
        t["shape"] = (f"{n} atoms, grid {grid}, capacity {cap}, {candidates} candidate pairs, "
                      f"{edges} edges")
        times[key] = t
        kernel_ops = device_ops(torch, lambda: fcl._kernel_cell_pairs(*args, start, occ))
        build_ops = device_ops(torch, md_build)
        t["pair_test_ops"], t["build_ops"] = kernel_ops[0], build_ops[0]
        log(f"  {key} @ {t['shape']}: pair test {t['ms'] * 1e3:.2f} us, "
            f"plain (candidate matrix + nonzero, host-synchronising) {t['plain_ms'] * 1e3:.2f} "
            f"us; whole build: kernel route {t['build_ms'] * 1e3:.2f} us (CUDA-graph replay: "
            f"nothing waits for the host), plain route {t['plain_build_ms'] * 1e3:.2f} us; "
            f"bound {max(t['bytes'] / HBM_BYTES_PER_S, t['ops'] / FP32_FLOPS) * 1e6:.3f} us "
            f"({t['bytes']} B, {t['ops']} fp32 operations); one-call PyTorch: none (no single "
            f"call builds a periodic radius graph)")
        log_device_ops(f"{key}: the pair test (_kernel_cell_pairs)", *kernel_ops, t["ms"] * 1e3)
        log_device_ops(f"{key}: the whole build (cell_list_edges)", *build_ops,
                       t["build_ms"] * 1e3)
    t = times["lj"]  # the JSON row: the larger system
    t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = t["ops"] / FP32_FLOPS * 1e3
    entry.update(ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations", shape=t["shape"],
                 build_ms=t["build_ms"], plain_build_ms=t["plain_build_ms"],
                 build_ops=t["build_ops"], pair_test_ops=t["pair_test_ops"],
                 mlip_system={k: times["mlip"][k] for k in ("ms", "plain_ms", "build_ms",
                                                            "plain_build_ms", "build_ops",
                                                            "pair_test_ops", "shape")})
    return entry


# -- phase 8: MLIP training --------------------------------------------------------


def mlip_config(epochs: int, arch: str = "EGNN") -> dict:
    """``bench.py``'s ``oc20`` row: ``MLIP_CONFIG`` with radius 5.0 and
    ``max_neighbours`` 40, fp32, batch 64, ``num_epoch`` cut to ``epochs``;
    for ``arch`` PAINN or MACE, its ``Architecture`` block and head are
    ``examples/oc20/train.py``'s (``OC20_ARCH``) on the same data."""
    cfg = copy.deepcopy(MLIP_CONFIG)
    cfg["NeuralNetwork"]["Training"]["num_epoch"] = epochs
    if arch != "EGNN":
        cfg["NeuralNetwork"]["Architecture"] = dict(copy.deepcopy(OC20_ARCH), mpnn_type=arch)
        cfg["NeuralNetwork"]["Variables_of_interest"].update(type=["node"], output_dim=[1])
    return cfg


def mlip_samples(n: int = MLIP_SAMPLES, seed: int = 11):
    """``bench_oc20``'s data: periodic 64-atom LJ cells."""
    from hydragnn_tpu_torch.datasets import lennard_jones_data

    return lennard_jones_data(number_configurations=n, cells_per_dim=4, radius=5.0,
                              max_neighbours=40, relative_maximum_atomic_displacement=0.05,
                              seed=seed)


def mlip_train_batch(n_samples: int = MLIP_SAMPLES):
    """The first training batch of the oc20 MLIP run (64 cells, the loader's
    pad bucket), collated on the host: the shapes of its segment sums."""
    from hydragnn_tpu_torch.graphs.batching import collate
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

    loaders = dataset_loading_and_splitting(mlip_config(MLIP_EPOCHS),
                                            samples=mlip_samples(n_samples))
    return collate(loaders[0].samples[:64], loaders[0].pad)


def mlip_launches_per_step(layers: int, arch: str = "EGNN", kind: str | None = None) -> dict:
    """Kernel launches of one MLIP train step with ``layers`` conv layers,
    all segment sums: those of the eval step (:func:`mlip_launches_per_eval`)
    and the loss backward's. The EGNN's loss backward repeats the forward's
    and the force backward's (the forward's gathers, and the gathers that
    are the force backward's segment sums): ``2 (2 L + 4 L - 2)`` in all.
    PAINN's loss backward sums the gathers of the forward that depend on
    the parameters (positions two per layer, scalar messages one per layer,
    vector channel on layers 1..L-1: ``4 L - 1``) and differentiates the
    two message sums per layer once more (``2 L``): ``12 L - 1`` in all.
    MACE's: positions two per layer, sender features one on layer 0 and two
    later, the element embedding one per layer (``5 L - 1``), and the two
    message sums per layer: ``13 L - 1``. ``kind`` ``mptrj_film``: the
    MPTrj EGNN, node head and film (one more per layer)."""
    want = dict.fromkeys(KERNELS, 0)
    want["segment_sum"] = {"EGNN": 2 * (2 * layers + 4 * layers - 2),
                           "PAINN": 12 * layers - 1, "MACE": 13 * layers - 1}[arch]
    if kind == "mptrj_film":
        # film's per-graph scale and shift gathered to the nodes in every
        # layer: its backward, one segment sum a layer (the node head's
        # energy sum counts as the graph head's pooling does)
        want["segment_sum"] += layers
    return want


def mlip_launches_per_eval(layers: int, arch: str = "EGNN", kind: str | None = None) -> dict:
    """One MLIP eval step: the energy forward and the force backward (no
    second derivative). EGNN: ``2 L + 4 L - 2``. PAINN and MACE: the
    forward's ``2 L + 2`` (two message sums per layer, the pooling the node
    head does not read, the node energies' sum per graph) and the force
    backward's ``4 L - 2``: the position gathers' two per layer and, on
    layers 1..L-1 (layer 0's features do not depend on the positions),
    PAINN's scalar and vector gathers, MACE's two sender-feature blocks.
    ``kind`` ``mptrj_film`` (node head): one more, its energies' sum per
    graph beside the pooling it does not read."""
    want = dict.fromkeys(KERNELS, 0)
    want["segment_sum"] = 6 * layers - (2 if arch == "EGNN" else 0)
    if kind == "mptrj_film":
        want["segment_sum"] += 1  # the node head's energies summed per graph
    return want


def mlip_launches_per_md_step(layers: int) -> dict:
    """One MLIP MD step: one cell-list build, the energy's ``2 L`` segment
    sums and the force backward's ``4 L - 2``."""
    want = dict.fromkeys(KERNELS, 0)
    want["segment_sum"] = 6 * layers - 2
    want["cell_list"] = 1
    return want


def mlip_training_phase(torch, device: str, seed: int, epochs: int = MLIP_EPOCHS,
                        n_samples: int = MLIP_SAMPLES, card: str = "",
                        arch: str = "EGNN", kind: str | None = None) -> dict:
    """``run_training`` of the oc20 MLIP (fp32; ``arch`` EGNN, or PAINN or
    MACE with ``examples/oc20/train.py``'s block), or of ``kind``'s block
    on its own data (``OWN_DATA``: ``mptrj_film``, the MPTrj EGNN with film
    conditioning, its ``num_epoch`` not cut): falling train loss, launch
    counts, the captured steps against the eager ones, one fp32 MLIP step
    against the fp64 CPU step, the forces through the kernels against the
    plain versions on the same state (PAINN, MACE, the MPTrj EGNN), where
    a step's time goes and the device's busy share."""
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.graphs.batching import collate
    from hydragnn_tpu_torch.models.mlip import (energy_force_loss, graph_energy,
                                                make_mlip_train_step)
    from hydragnn_tpu_torch.ops import fused_scatter as fs
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting
    from hydragnn_tpu_torch.train.step import cast_forward, optimizer_step

    if kind is None:
        cfg = mlip_config(epochs, arch)
        tag = "mlip" if arch == "EGNN" else f"mlip-{arch.lower()}"

        def samples():
            return mlip_samples(n_samples)
    else:
        cfg, tag = qm9_config(kind), kind
        arch = cfg["NeuralNetwork"]["Architecture"]["mpnn_type"]

        def samples():
            return raw_samples(seed, kind)
    a_cfg = cfg["NeuralNetwork"]["Architecture"]
    t_cfg = cfg["NeuralNetwork"]["Training"]
    layers = int(a_cfg["num_conv_layers"])
    bs = int(t_cfg["batch_size"])
    loaders = dataset_loading_and_splitting(copy.deepcopy(cfg), samples=samples())
    n_train, n_val, n_test = (len(ld) for ld in loaders)
    source = (f"the {cfg['Dataset']['name']} block" if kind is not None else
              "bench.py's oc20 EGNN MLIP" if arch == "EGNN" else
              f"examples/oc20/train.py's --arch {arch} block")
    conditioning = (f", {a_cfg['graph_attr_conditioning_mode']} conditioning"
                    if a_cfg.get("use_graph_attr_conditioning") else "")
    log(f"[{tag}] training: run_training on {source} (hidden {a_cfg['hidden_dim']} x {layers} "
        f"conv layers, equivariance on, silu, add pooling, energy weight "
        f"{a_cfg['energy_weight']}, per-atom energy weight {a_cfg['energy_peratom_weight']}, "
        f"force weight {a_cfg['force_weight']}{conditioning}, fp32, batch {bs}, AdamW lr "
        f"{t_cfg['Optimizer']['learning_rate']}), num_epoch {t_cfg['num_epoch']}"
        f"{' (cut: the only cut)' if kind is None else ' (not cut)'}, "
        f"{sum(len(ld.samples) for ld in loaders)} periodic LJ cells of "
        f"{loaders[0].samples[0].num_nodes} atoms: {n_train} train / {n_val} val / {n_test} "
        f"test batches per epoch, seed {seed}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        history: list = []
        fs.reset_launches()
        t0 = time.perf_counter()
        state, model, aug = run_training(copy.deepcopy(cfg), samples=samples(),
                                         device=device, path=tmp, seed=seed, history=history)
        _sync(torch, device)
        wall = time.perf_counter() - t0
    launches = dict(fs.LAUNCHES)
    losses = [h["train_loss"] for h in history]
    log(f"[{card}] [{tag}] run_training: {len(history)} epochs, {state.step} train steps in "
        f"{wall:.3f} s (epochs {[round(h['seconds'], 3) for h in history]} s); train loss per "
        f"epoch {[round(x, 3) for x in losses]}; val loss "
        f"{[round(h['val_loss'], 3) for h in history]}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"MLIP training: the train loss did not fall: {losses}")
    per_step = mlip_launches_per_step(layers, arch, kind)
    per_eval = mlip_launches_per_eval(layers, arch, kind)
    want = _added(_scaled(per_step, state.step), _scaled(per_eval, len(history) * (n_val + n_test)))
    log(f"[{tag}] launches during run_training: {launches} (expected {want}: per train step "
        f"{ {k: v for k, v in per_step.items() if v} }, per eval batch "
        f"{ {k: v for k, v in per_eval.items() if v} })")
    if device == "cuda" and launches != want:
        raise AssertionError(f"MLIP training: launch counts {launches} != {want}")

    train_ld = loaders[0]
    host = collate(train_ld.samples[:bs], train_ld.pad)
    step = make_mlip_train_step(model, torch.float32)
    fs.reset_launches()
    step(state, host.to(device))
    _sync(torch, device)
    one_step = dict(fs.LAUNCHES)
    log(f"[{tag}] launches of one eager MLIP train step: {one_step} (expected {per_step})")
    if device == "cuda" and one_step != per_step:
        raise AssertionError(f"MLIP training: one step launched {one_step} != {per_step}")
    captured = None
    if device == "cuda":
        from hydragnn_tpu_torch.models.mlip import make_mlip_eval_step

        # two batches of the split: each twice
        hosts = [collate(train_ld.samples[bs * (i % 2):bs * (i % 2) + bs], train_ld.pad)
                 for i in range(4)]
        captured = captured_vs_eager(torch, state, step, make_mlip_eval_step(model, torch.float32),
                                     hosts, f"[{card}] [{tag}]", per_step, per_eval)

    _step_vs_cpu(torch, aug, host, device, seed, mlip=True)
    if arch != "EGNN" or kind is not None:
        mlip_forces_vs_plain(torch, model, host, device, tag)

    # where an MLIP train step's time goes (median of 10, host clock after a
    # synchronise, each step on a fresh device batch)
    reps = 10
    parts: dict = {k: [] for k in ("to_device", "forward", "force_backward", "loss_backward",
                                   "step")}

    def timed(key, fn):
        t = time.perf_counter()
        out = fn()
        _sync(torch, device)
        parts[key].append((time.perf_counter() - t) * 1e3)
        return out

    spec = model.spec
    for _ in range(reps):
        b = timed("to_device", lambda: host.to(device))
        pos = b.pos.detach().requires_grad_(True)
        bp = b.replace(pos=pos)
        ge = timed("forward", lambda: graph_energy(spec, cast_forward(
            model, bp, torch.float32, train=True)[0], b))
        (gp,) = timed("force_backward", lambda: torch.autograd.grad(ge.sum(), pos,
                                                                     create_graph=True))
        tot, tasks = energy_force_loss(spec, ge, -gp * b.node_mask[:, None], b)
        timed("loss_backward", lambda: optimizer_step(state, b, tot, tasks))
    for b in [host.to(device) for _ in range(reps)]:
        timed("step", lambda: step(state, b))
    med = {k: float(np.median(v)) for k, v in parts.items()}
    log(f"[{card}] [{tag}] one eager fp32 MLIP train step ({bs} cells, N={host.num_nodes}, "
        f"E={host.num_edges}; median of {reps}, host clock): to device {med['to_device']:.3f} ms, "
        f"forward (energy) {med['forward']:.3f} ms, force backward (create_graph) "
        f"{med['force_backward']:.3f} ms, loss backward + AdamW {med['loss_backward']:.3f} ms; "
        f"whole train step {med['step']:.3f} ms")
    eager_busy = None
    if device == "cuda":
        eager_busy = _profile_steps(torch, step, state, host, device, f"[{card}] [{tag}] eager:")
        log_op_diff(f"[{card}] [{tag}] train step:", captured["busy"], eager_busy)
    return {"launches": launches, "per_step": one_step, "breakdown": med, "model": model,
            "aug": aug, "layers": layers, "batch": host, "captured": captured,
            "eager_busy": eager_busy}


def mlip_forces_vs_plain(torch, model, host, device: str, tag: str) -> float:
    """The trained MLIP's energies and forces on one training batch through
    the kernels (every segment sum of the energy and of the force backward
    on B2) against the same state's with the plain versions in their place:
    max |dF| within ``MD_RTOL`` of max |F|, and the kernels launched."""
    from hydragnn_tpu_torch.models.mlip import make_energy_and_forces
    from hydragnn_tpu_torch.ops import fused_scatter as fs

    ef = make_energy_and_forces(model)
    b = host.to(device)
    before = dict(fs.LAUNCHES)
    e_k, f_k = ef(b)
    _sync(torch, device)
    launched = fs.LAUNCHES["segment_sum"] - before["segment_sum"]
    with _plain_versions_on_card():
        e_p, f_p = ef(b)
    scale = float(f_p.abs().max())
    err = float((f_k - f_p).abs().max())
    ratio = err / scale if scale > 0 else float("inf")
    log(f"[{tag}] forces through the kernels ({launched} segment sums) vs the plain versions on "
        f"the same state and batch: max|dF| {err:.3e} of max|F| {scale:.3e} ({ratio:.2e}; allowed "
        f"{MD_RTOL:.0e}), max|dE| {float((e_k - e_p).abs().max()):.3e}")
    if device == "cuda" and launched <= 0:
        raise AssertionError(f"{tag}: the forces did not go through B2")
    if not ratio <= MD_RTOL:
        raise AssertionError(f"{tag}: the forces through the kernels miss the plain versions'")
    return ratio


# -- phase 9: molecular dynamics ----------------------------------------------------


def _drift(traj, init_state, masses) -> float:
    from hydragnn_tpu_torch.md import kinetic_energy

    e = [float(init_state.energy) + float(kinetic_energy(init_state.vel, masses))]
    e += [float(p) + float(kinetic_energy(v, masses)) for p, v in zip(traj.energy, traj.vel)]
    return abs(e[-1] - e[0]) / max(abs(e[0]), 1e-9)


def _md_breakdown(torch, device, potential, energy_fn, state, step, masses, dt, reps=10):
    """ms of one MD step's parts (median of ``reps``, host clock after a
    synchronise): the neighbour build, the energy, the force backward and
    the integration; and of whole steps back to back."""
    from hydragnn_tpu_torch.md import _wrap_positions

    parts: dict = {k: [] for k in ("build", "energy", "force_backward", "integration")}

    def timed(key, fn):
        t = time.perf_counter()
        out = fn()
        _sync(torch, device)
        parts[key].append((time.perf_counter() - t) * 1e3)
        return out

    m = torch.as_tensor(masses, device=state.pos.device).reshape(-1, 1)
    for _ in range(reps):
        graph = timed("build", lambda: potential.build(state.pos))
        p = state.pos.detach().requires_grad_(True)
        with torch.enable_grad():
            e = timed("energy", lambda: energy_fn(p, *graph[:4]))
            timed("force_backward", lambda: torch.autograd.grad(e, p))
        with torch.no_grad():
            timed("integration", lambda: _wrap_positions(
                state.pos + dt * (state.vel + 0.5 * dt * state.forces / m),
                potential.geometry(state.pos)))
    med = {k: float(np.median(v)) for k, v in parts.items()}
    _sync(torch, device)
    t0 = time.perf_counter()
    s = state
    for _ in range(reps):
        s = step(s)
    _sync(torch, device)
    med["step"] = (time.perf_counter() - t0) * 1e3 / reps
    return med


def _forces_vs_plain(torch, device: str, potential, init, pos, vel, n_rows: int,
                     label: str) -> float:
    """One MD state's forces on ``device`` through the kernels (B5's
    neighbour build, B2 in the energy and the force backward) against the
    same state's with every kernel swapped for its plain version, on the
    same positions at the path's own shapes: ``n_edges`` equal, max |dF|
    within ``MD_RTOL`` of max |F|. Before that, B2 alone over the build's
    sender and receiver ids (pad slots included) into ``n_rows`` rows, on
    random fp32 ``[max_edges, 3]`` rows, against its plain version on the
    same rows in fp64: the plain version's fp32 sums go through
    ``index_add_``'s atomics, which over the LJ pad row's ~427k terms miss
    the exact sum by ~1e-2 of ~650 (more than the fp32 tolerance), from
    call to call. Returns the forces' ratio."""
    from hydragnn_tpu_torch.ops import fused_scatter as fs

    s, r = potential.build(pos)[:2]
    gen = torch.Generator(device=pos.device).manual_seed(0)
    data = torch.randn((s.shape[0], 3), generator=gen, device=pos.device)
    for ids_name, ids in (("senders", s), ("receivers", r)):
        got = fs.fused_segment_sum(data, ids, n_rows)
        with _plain_versions_on_card():
            want = fs.fused_segment_sum(data.double(), ids, n_rows)
        _compare(torch, f"{label}: segment_sum over the build's {ids_name} ({s.shape[0]} ids "
                 f"into {n_rows} rows)", got, want, n_rows, "float32")
    before = dict(fs.LAUNCHES)
    got = init(pos, vel)
    _sync(torch, device)
    if device == "cuda" and any(fs.LAUNCHES[k] <= before[k] for k in ("cell_list",
                                                                        "segment_sum")):
        raise AssertionError(f"{label}: the forces did not go through B5 and B2")
    with _plain_versions_on_card():
        want = init(pos, vel)
    scale = float(want.forces.abs().max())
    err = float((got.forces - want.forces).abs().max())
    ratio = err / scale if scale > 0 else float("inf")
    same_edges = int(got.n_edges) == int(want.n_edges)
    log(f"  {label}: forces through the kernels vs the plain versions on the same state: "
        f"n_edges {int(got.n_edges)} (plain {int(want.n_edges)}), max|dF| {err:.3e} of max|F| "
        f"{scale:.3e} ({ratio:.2e}; allowed {MD_RTOL:.0e}), |dE| "
        f"{abs(float(got.energy) - float(want.energy)):.3e} of |E| {abs(float(want.energy)):.3e}")
    if not same_edges or not ratio <= MD_RTOL:
        raise AssertionError(f"{label}: the forces through the kernels miss the plain versions'")
    return ratio


def _eager_trajectory(torch, step, state, n_steps: int, every: int = 10):
    """The comparator of a captured ``run_md``: the same steps one by one
    (``make_md_step``'s eager step), every ``every``-th state recorded;
    returns (final state, recorded states, ms per step on the host clock)."""
    _sync(torch, state.pos.device.type)
    t0 = time.perf_counter()
    recorded = []
    for k in range(n_steps):
        state = step(state)
        if (k + 1) % every == 0:
            recorded.append(state)
    _sync(torch, state.pos.device.type)
    return state, recorded, (time.perf_counter() - t0) * 1e3 / n_steps


def _check_trajectory(torch, label: str, final, traj, eager_final, eager_recorded) -> None:
    """The captured trajectory (``run_md``'s) bit-equal to the eager one."""
    from hydragnn_tpu_torch.md import MDState

    bad = [name for name, got, want in zip(MDState._fields, traj,
                                            (torch.stack(f) for f in zip(*eager_recorded)))
           if not torch.equal(got, want)]
    bad += [f"final {name}" for name, a, b in zip(MDState._fields, final, eager_final)
            if not torch.equal(a, b)]
    log(f"  {label}: run_md's captured trajectory vs the eager steps: "
        f"{'bit-equal' if not bad else 'DIFFERENT: ' + ', '.join(bad)}")
    if bad:
        raise AssertionError(f"{label}: the captured trajectory differs from the eager one")


def _md_captured_times(torch, step, state, tag: str, every: int = 10, reps: int = 5) -> dict:
    """A trajectory segment of ``every`` steps captured from ``state`` (as
    ``run_md`` captures it): ms per step over ``reps`` replays (host clock
    after a synchronise), and the device busy share of the replays beside
    the eager steps'."""
    from hydragnn_tpu_torch.capture import SegmentGraph

    segment = SegmentGraph(step, state, every, name="md timing")
    segment.run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        segment.run()
    torch.cuda.synchronize()
    out = {"step_ms": (time.perf_counter() - t0) * 1e3 / (reps * every)}
    out["busy"] = busy_share(torch, [segment.run] * 4, f"{tag} captured:",
                             f"replays of {every}-step segments")
    out["eager_busy"] = busy_share(torch, [lambda: step(state)] * (every + 1), f"{tag} eager:",
                                   "MD steps")
    return out


def md_phase(torch, device: str, systems: dict, model, layers: int, card: str = "",
             lj_steps: int = LJ_MD_STEPS, mlip_steps: int = MLIP_MD_STEPS,
             cpu_steps: int = MD_CPU_STEPS) -> dict:
    """Both MD systems through ``md.run_md`` (NVE, neighbour list rebuilt
    every step): the first forces against the plain versions', finite, no
    overflow, drift, ms per step and its parts, launches per step; MLIP MD
    also against the port's CPU route (the first forces; velocities and
    positions after the first steps, which must move the atoms) and
    bit-identical over two runs."""
    from hydragnn_tpu_torch import md
    from hydragnn_tpu_torch.graphs.batching import PadSpec, collate
    from hydragnn_tpu_torch.ops import fused_scatter as fs

    dev = torch.device(device)
    out = {}

    # analytic LJ, 8,000 atoms, the cell list
    lj = systems["lj"]
    n = lj["pos"].shape[0]
    masses = np.ones(n, np.float32)
    kw = dict(cell=lj["cell"], pbc=lj["pbc"], neighbor="cell")
    init, step = md.make_md_step(lj_energy(torch), masses, LJ_MD_DT, lj["cutoff"],
                                 lj["max_edges"], **kw)
    pos0, vel0 = torch.from_numpy(lj["pos"]).to(dev), torch.from_numpy(lj["vel"]).to(dev)
    state0 = init(pos0, vel0)
    potential, pinit = md._make_potential_and_init(lj_energy(torch), lj["cutoff"],
                                                   lj["max_edges"], lj["cell"], lj["pbc"], n - 1,
                                                   neighbor="cell")
    _forces_vs_plain(torch, device, potential, pinit, pos0, vel0, n,
                     f"[md] analytic LJ ({n} atoms)")
    fs.reset_launches()
    step(state0)
    _sync(torch, device)
    per_step = dict(fs.LAUNCHES)
    want = dict.fromkeys(KERNELS, 0)
    want.update(cell_list=1, segment_sum=2)  # the build; the two gathers' backward
    if device == "cuda" and per_step != want:
        raise AssertionError(f"LJ MD: one step launched {per_step} != {want}")
    fs.reset_launches()
    t0 = time.perf_counter()
    final, traj = md.run_md(lj_energy(torch), pos0, vel0, masses, LJ_MD_DT, lj_steps,
                            lj["cutoff"], lj["max_edges"], record_every=10, **kw)
    _sync(torch, device)
    wall = time.perf_counter() - t0
    launches_lj = dict(fs.LAUNCHES)
    finite = bool(torch.isfinite(traj.pos).all()) and bool(torch.isfinite(traj.energy).all())
    peak = int(final.max_n_edges)
    drift = _drift(traj, state0, masses)
    eager_final, eager_rec, eager_ms = _eager_trajectory(torch, step, state0, lj_steps)
    _check_trajectory(torch, f"[md] analytic LJ ({n} atoms)", final, traj, eager_final,
                      eager_rec)
    med = _md_breakdown(torch, device, potential, lj_energy(torch), final, step, masses,
                        LJ_MD_DT)
    captured = (_md_captured_times(torch, step, final, f"[{card}] [md] LJ")
                if device == "cuda" else None)
    log(f"[{card}] [md] analytic LJ: {n} atoms (spacing 2.2, cutoff {lj['cutoff']}, grid "
        f"{lj['plan'][0]}, capacity {lj['plan'][1]}, max_edges {lj['max_edges']}), {lj_steps} "
        f"NVE steps (dt {LJ_MD_DT}) in {wall:.3f} s = {1e3 * wall / lj_steps:.3f} ms per step "
        f"(run_md: on the card one 10-step segment captured, with its warm-up, and replayed; "
        f"the launch-count step and set-up excluded); the same steps eager one by one "
        f"{eager_ms:.3f} ms per step; a replayed segment "
        f"{captured['step_ms'] if captured else float('nan'):.3f} ms per step; "
        f"finite {finite}, peak neighbours {peak} <= {lj['max_edges']}, relative total-energy "
        f"drift {drift:.3e}; launches per step {per_step}, in the run {launches_lj}; one step's "
        f"parts (median of 10, host clock): build {med['build']:.3f} ms, energy "
        f"{med['energy']:.3f} ms, force backward {med['force_backward']:.3f} ms, integration "
        f"{med['integration']:.3f} ms; steps back to back {med['step']:.3f} ms each")
    if not finite or peak > lj["max_edges"]:
        raise AssertionError("LJ MD: trajectory not finite or the edge buffer overflowed")
    out["lj"] = {"launches": launches_lj, "ms_per_step": 1e3 * wall / lj_steps, "drift": drift,
                 "breakdown": med, "eager_ms": eager_ms, "captured": captured}

    # the trained EGNN on the 1,000-atom cell
    m = systems["mlip"]
    n = m["pos"].shape[0]
    masses = np.ones(n, np.float32)
    pad = PadSpec(n_node=n + 8, n_edge=m["max_edges"], n_graph=2)
    host_template = collate([m["sample"]], pad)
    kw = dict(cell=m["cell"], pbc=m["pbc"], pad_id=pad.n_node - 1)

    def roll(model_, dev_, steps):
        energy_fn = md.mlip_energy_fn(model_, host_template.to(dev_))
        init_, _ = md.make_md_step(energy_fn, masses, MLIP_MD_DT, m["cutoff"], m["max_edges"],
                                   **kw)
        p0 = torch.from_numpy(m["pos"]).to(dev_)
        v0 = torch.from_numpy(m["vel"]).to(dev_)
        s0 = init_(p0, v0)
        final_, traj_ = md.run_md(energy_fn, p0, v0, masses, MLIP_MD_DT, steps, m["cutoff"],
                                  m["max_edges"], record_every=10 if steps % 10 == 0 else 1,
                                  **kw)
        return s0, final_, traj_, energy_fn

    model.eval()
    energy_fn = md.mlip_energy_fn(model, host_template.to(dev))
    init, step = md.make_md_step(energy_fn, masses, MLIP_MD_DT, m["cutoff"], m["max_edges"],
                                 **kw)
    pos0, vel0 = torch.from_numpy(m["pos"]).to(dev), torch.from_numpy(m["vel"]).to(dev)
    state0 = init(pos0, vel0)
    potential, pinit = md._make_potential_and_init(energy_fn, m["cutoff"], m["max_edges"],
                                                   m["cell"], m["pbc"], pad.n_node - 1)
    _forces_vs_plain(torch, device, potential, pinit, pos0, vel0, pad.n_node,
                     f"[md] MLIP ({n} atoms)")
    fs.reset_launches()
    step(state0)
    _sync(torch, device)
    per_step = dict(fs.LAUNCHES)
    want = mlip_launches_per_md_step(layers)
    if device == "cuda" and per_step != want:
        raise AssertionError(f"MLIP MD: one step launched {per_step} != {want}")
    fs.reset_launches()
    t0 = time.perf_counter()
    s0, final, traj, _ = roll(model, dev, mlip_steps)
    _sync(torch, device)
    wall = time.perf_counter() - t0
    launches_mlip = dict(fs.LAUNCHES)
    finite = bool(torch.isfinite(traj.pos).all()) and bool(torch.isfinite(traj.energy).all())
    peak = int(final.max_n_edges)
    drift = _drift(traj, s0, masses)
    eager_final, eager_rec, eager_ms = _eager_trajectory(torch, step, state0, mlip_steps)
    _check_trajectory(torch, f"[md] MLIP ({n} atoms)", final, traj, eager_final, eager_rec)
    # a second run: bit for bit the same trajectory (no atomics anywhere)
    _, final2, traj2, _ = roll(model, dev, mlip_steps)
    identical = torch.equal(final.pos, final2.pos) and torch.equal(traj.energy, traj2.energy)
    # the port's CPU route from the same weights: the first state's forces,
    # then the velocities and positions after the first steps
    cpu_s0, cpu_final, _, _ = roll(copy.deepcopy(model).cpu(), torch.device("cpu"), cpu_steps)
    dev_s0, dev_final, _, _ = roll(model, dev, cpu_steps)

    def rel(a, b):
        scale = float(b.abs().max())
        return float((a.cpu() - b).abs().max()) / scale if scale > 0 else float("inf")

    force_rel = rel(dev_s0.forces, cpu_s0.forces)
    vel_rel = rel(dev_final.vel, cpu_final.vel)
    cpu_err = float((dev_final.pos.cpu() - cpu_final.pos).abs().max())
    # how far the atoms moved, by minimum image (the integrator wraps them)
    step_disp = dev_final.pos.cpu() - torch.from_numpy(m["pos"])
    box = torch.from_numpy(m["cell"]).diagonal()
    moved = float((step_disp - box * torch.round(step_disp / box)).abs().max())
    med = _md_breakdown(torch, device, potential, energy_fn, final, step, masses, MLIP_MD_DT)
    captured = (_md_captured_times(torch, step, final, f"[{card}] [md] MLIP")
                if device == "cuda" else None)
    log(f"[{card}] [md] MLIP: the trained EGNN on {n} atoms (box {m['cell'][0, 0]:.1f} A, "
        f"cutoff {m['cutoff']}, grid {m['plan'][0]}, capacity {m['plan'][1]}, template "
        f"{pad!r}), {mlip_steps} NVE steps (dt {MLIP_MD_DT}) in {wall:.3f} s = "
        f"{1e3 * wall / mlip_steps:.3f} ms per step (run_md, captured segments); eager one by "
        f"one {eager_ms:.3f} ms per step; a replayed segment "
        f"{captured['step_ms'] if captured else float('nan'):.3f} ms per step; finite {finite}, "
        f"peak neighbours {peak} <= "
        f"{m['max_edges']}, relative total-energy drift {drift:.3e}; two runs bit-identical "
        f"{identical}; vs the CPU route: first state's max|dF| {force_rel:.2e} of max|F| "
        f"(allowed {MD_RTOL:.0e}), after {cpu_steps} steps max|dv| {vel_rel:.2e} of max|v| "
        f"(allowed {MD_RTOL:.0e}) and max|pos diff| {cpu_err:.3e} A (allowed {MD_POS_TOL:.0e}; "
        f"the atoms moved up to {moved:.3e} A, at least {10 * MD_POS_TOL:.0e} required); "
        f"launches per step {per_step} (expected {want}), in the run "
        f"{launches_mlip}; one step's parts (median of 10, host clock): build "
        f"{med['build']:.3f} ms, energy {med['energy']:.3f} ms, force backward "
        f"{med['force_backward']:.3f} ms, integration {med['integration']:.3f} ms; steps back "
        f"to back {med['step']:.3f} ms each")
    if not finite or peak > m["max_edges"]:
        raise AssertionError("MLIP MD: trajectory not finite or the edge buffer overflowed")
    if not identical:
        raise AssertionError("MLIP MD: two runs from the same state differ")
    if not (force_rel <= MD_RTOL and vel_rel <= MD_RTOL and cpu_err <= MD_POS_TOL):
        raise AssertionError(f"MLIP MD: the card's forces or first {cpu_steps} steps miss the "
                             f"CPU route's (forces {force_rel:.2e}, velocities {vel_rel:.2e} "
                             f"relative, positions {cpu_err:.3e} A)")
    if not moved >= 10 * MD_POS_TOL:
        raise AssertionError(f"MLIP MD: the atoms moved {moved:.3e} A in {cpu_steps} steps, too "
                             f"little for the {MD_POS_TOL:.0e} A comparison to see the forces")
    out["mlip"] = {"launches": launches_mlip, "ms_per_step": 1e3 * wall / mlip_steps,
                   "drift": drift, "breakdown": med, "eager_ms": eager_ms, "captured": captured}
    return out


# -- phase 11: fp8 ------------------------------------------------------------------


def fp8_phase(torch, gin_model, gin_batch, mlip_model, mlip_batch, card: str = "") -> dict:
    """Kernel B7 against its plain version at the oc20 EGNN's edge-MLP
    Dense of layers 0 and 1 on the EGNN's training batch (their real
    inputs), both formats, and its time there; then ``certify_fp8_dense`` (the fp8
    layer's own entry point, the kernel on the card) on each Dense call of
    the trained GIN's fp32 forward at the top bucket, both formats:
    max-abs and relative-Frobenius error against the fp32 product. The
    launch counts are set to 0 just before the certification and read after
    it."""
    from hydragnn_tpu_torch.ops import fp8_matmul as f8
    from hydragnn_tpu_torch.ops import fused_scatter as fs

    edge = {c[0]: c for c in dense_inputs(torch, mlip_model, mlip_batch, torch.float32)}
    err, out = 0.0, {}
    for layer in (0, 1):  # K = 2 F + 1: 3 on layer 0 (one node feature), 129 on layer 1
        name, module, x = edge[f"graph_convs.{layer}.edge_mlp.dense_0"]
        w = module.weight.detach().float().t()
        b = module.bias.detach().float()
        log(f"fp8_dense at the oc20 EGNN's edge-MLP Dense {name} on its training batch "
            f"(N={mlip_batch.num_nodes}, E={mlip_batch.num_edges}): x[{x.shape[0]},"
            f"{x.shape[1]}] x W[{w.shape[0]},{w.shape[1]}]")
        err = max(err, *(check_fp8_dense(torch, name, x, w, b, fmt) for fmt in ("e4m3", "e5m2")))
        if not x.is_cuda:
            continue
        w8, s_w8 = f8.quantize_weight_fp8(w, "e4m3")
        s_x8 = f8.activation_scale_fp8(x, "e4m3")
        ms = graph_time_ms(torch, lambda: f8.fp8_matmul_parts(x, w8, s_w8, s_x8, b, "e4m3")[1])
        plain_ms = graph_time_ms(torch, lambda: f8.reference_fp8_dense(x, w8, s_w8, s_x8, b,
                                                                       "e4m3"))
        m, k = x.shape
        n = w.shape[1]
        bound_ms = max((m * k * 4 + k * n + 2 * n * 4 + 4 + m * n * 4) / HBM_BYTES_PER_S,
                       2 * m * k * n / INT8_OPS) * 1e3
        log(f"[{card}]   fp8_dense e4m3 @ x[{m},{k}] f32, W_q[{k},{n}]: kernel "
            f"{ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} us")
        out[layer] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, shape=f"x[{m},{k}]")

    calls = dense_inputs(torch, gin_model, gin_batch, torch.float32)
    fs.reset_launches()
    report = {fmt: [(cname, f8.certify_fp8_dense(
        xc, mod.weight.detach().t(), None if mod.bias is None else mod.bias.detach(), fmt))
        for cname, mod, xc in calls] for fmt in ("e4m3", "e5m2")}
    on_card = next(gin_model.parameters()).is_cuda
    _sync(torch, "cuda" if on_card else "cpu")
    launches = dict(fs.LAUNCHES)
    want = dict(dict.fromkeys(KERNELS, 0), fp8_dense=2 * len(calls))
    log(f"certify_fp8_dense on the trained GIN's {len(calls)} Dense calls at the top bucket "
        f"(fp32 forward), launches {launches} (expected {want}):")
    for fmt, rows in report.items():
        log(f"  {fmt}: " + "; ".join(
            f"{cname} {r['max_abs_err']:.3e} / {r['rel_fro_err']:.3e}" for cname, r in rows)
            + " (max-abs / relative-Frobenius error)")
    if on_card and launches != want:
        raise AssertionError(f"fp8: launch counts {launches} != {want}")
    if not all(np.isfinite([r["max_abs_err"], r["rel_fro_err"]]).all()
               for rows in report.values() for _, r in rows):
        raise AssertionError("fp8: a certified error is not finite")
    return {"launches": launches, "max_abs_err": err, "egnn": out, "report": report}


# -- phase 12: B6 at the new int8 stacks' shapes ------------------------------------


def _top_batch(kind: str, seed: int):
    """(model config, top-bucket batch of 64 training samples, dtype) of a
    qm9 stack (``prepare``) or, for ``mlip`` / ``mlip-painn`` /
    ``mlip-mace``, of the oc20 MLIP (its loader's pad bucket, fp32)."""
    import torch

    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.graphs.batching import collate
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

    if kind.startswith("mlip"):
        arch = "EGNN" if kind == "mlip" else kind.split("-")[1].upper()
        cfg = mlip_config(MLIP_EPOCHS, arch)
        loaders = dataset_loading_and_splitting(copy.deepcopy(cfg), samples=mlip_samples())
        aug = update_config(copy.deepcopy(cfg), *(ld.samples for ld in loaders))
        return aug, collate(loaders[0].samples[:64], loaders[0].pad), torch.float32
    _, aug, loaders, samples = prepare(seed, kind)
    top, _ = bucket_batches(loaders, samples)
    return aug, top, torch.bfloat16


QUANT_STACK_KINDS = (tuple(STACKS) + tuple(GEOMETRIC) + ("mlip", "mlip-painn", "mlip-mace")
                     + tuple(EDGE_KINDS))


def quant_stack_kernel_phase(torch, seed: int, entry: dict | None,
                             kinds=QUANT_STACK_KINDS, device: str = "cuda") -> float:
    """Kernel B6 against its plain version, bit for bit (codes, int32 sums,
    ``y`` at 0 ulp), at every distinct shape the int8 endpoints of the ten
    newer stacks (SAGE to MACE), of the three oc20 MLIPs and of the edge and
    GPS kinds (``EDGE_KINDS``: GAT's ``lin_edge`` at K = 1, GPS's
    ``rel_pos_emb``, ``edge_emb`` and ``edge_lin`` at K = 128, the
    performer's q/k/v/out) give it: each
    Dense call of the served forward (random weights from ``seed``, the
    top bucket; bf16 qm9 stacks as served, fp32 MLIPs), among them
    DimeNet's ``lin_sbf1`` over every triplet slot (4/5 of them pads) and
    ``lin_rbf1`` at K = ``num_radial``, the bias-free layers, N = 1 heads
    and PAINN's and PNAEq's ``[E, 3, F]`` inputs reshaped to 2-D. With
    ``entry`` (B6's kernels-line entry), the kernel's device time at the
    new kinds of shape beside its plain version, the quantize +
    ``_int_mm`` + ``addcmul`` yardstick and the bound, under
    ``entry["stack_shapes"]``. Returns the largest |kernel - plain|."""
    from hydragnn_tpu_torch.models import create_model_config

    err, timed, n_checked = 0.0, [], 0
    picks = {"dimenet": ("lin_sbf1", "lin_rbf1", "out_lin"), "painn": ("update_U", "vec_embed"),
             "mace": ("radial_out",), "cgcnn": ("lin_f",), "mlip-painn": ("update_U",),
             "gat_edge": ("lin_edge",), "gps_pna_edge": ("edge_lin",),
             "gps_performer": ("attn.q",)}
    log("quant_dense (B6) at the int8 stacks' served shapes, bit for bit (0 ulp), each distinct "
        "(rows, K, N, bias, dtype) once:")
    for kind in kinds:
        aug, batch, dtype = _top_batch(kind, seed)
        model = create_model_config(aug, device=device, seed=seed)
        seen = set()
        for name, module, x in dense_inputs(torch, model, batch, dtype):
            w = module.weight.detach().float().t()
            b = None if module.bias is None else module.bias.detach().float()
            key = (x.shape[0], x.shape[1], w.shape[1], b is None, x.dtype)
            if key in seen:
                continue
            seen.add(key)
            n_checked += 1
            err = max(err, check_quant_dense(torch, f"[{kind}] {name}", x, w, b))
            if entry is not None and any(name.endswith(p) for p in picks.get(kind, ())):
                t = _time_quant_dense(torch, f"{kind} {name}", x, w, b, plain=True)
                timed.append({k: t[k] for k in ("shape", "ms", "plain_ms", "library_ms",
                                                "bound_ms", "bytes", "ops")})
        del model
    _sync(torch, device)
    log(f"quant_dense at the int8 stacks' shapes: {n_checked} distinct shapes over "
        f"{len(kinds)} models, all bit-equal to the plain version (max|diff| {err:.1e})")
    if entry is not None:
        entry["stack_shapes"] = timed
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    return err


# -- phase 13: MLIP serving ----------------------------------------------------------

MLIP_SERVE_REQUESTS = 512


def mlip_launches_per_predict(layers: int, arch: str = "EGNN") -> dict:
    """One served MLIP predict step (head outputs, no forces), all segment
    sums: the EGNN's (graph head) one message sum per layer, one
    coordinate sum on layers 0..L-2 and the pooling, ``2 L``; PAINN's and
    MACE's (node head) two message sums per layer and the pooling the node
    head does not read, ``2 L + 1``."""
    want = dict.fromkeys(KERNELS, 0)
    want["segment_sum"] = 2 * layers + (0 if arch == "EGNN" else 1)
    return want


def mlip_serving_phase(torch, seed: int, m: dict, arch: str = "EGNN", card: str = "",
                       device: str = "cuda", kind: str | None = None) -> dict:
    """A trained oc20 MLIP (``mlip_training_phase``'s) behind
    ``PredictionServer``: its head outputs, no forces, as the JAX
    ``Predictor`` serves them. Every bucket captured at warm-up, then
    ``MLIP_SERVE_REQUESTS`` requests (the 256 cells, each twice) as a
    closed burst (``serve.traffic``) under ``no_new_captures``; each served
    answer bit-equal to ``Predictor.outputs`` (the eager predict step) on
    the same padded batch, i.e. the captured step replays the eager one bit
    for bit; exact launches per batch; finite answers. ``kind``: a block of
    ``OWN_DATA`` (the MPTrj EGNN) on its own cells."""
    from hydragnn_tpu_torch import capture
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting
    from hydragnn_tpu_torch.serve import PredictionServer, Predictor, ServingConfig

    tag = kind or ("mlip" if arch == "EGNN" else f"mlip-{arch.lower()}")
    model, aug, layers = m["model"], m["aug"], m["layers"]
    if kind is None:
        loaders = dataset_loading_and_splitting(mlip_config(MLIP_EPOCHS, arch),
                                                samples=mlip_samples())
    else:
        loaders = dataset_loading_and_splitting(qm9_config(kind), samples=raw_samples(seed, kind))
    cells = [s for ld in loaders for s in ld.samples]
    requests = [cells[i % len(cells)] for i in range(MLIP_SERVE_REQUESTS)]
    server = PredictionServer(ServingConfig(queue_depth=2048, flush_ms=5.0), device=device)
    ep = server.add_model(tag, model, aug, samples=cells)
    t0 = time.perf_counter()
    server.warmup()
    captures = server.stats()[tag]["captures"]
    log(f"[{tag}] serving the trained {arch} MLIP (head outputs, no forces): buckets "
        f"{[b.as_tuple() for b in ep.buckets]}, warm-up {time.perf_counter() - t0:.3f} s, "
        f"{captures} CUDA graphs captured")
    if device == "cuda" and captures != len(ep.buckets):
        raise AssertionError(f"MLIP serving: {captures} graphs for {len(ep.buckets)} buckets")
    with capture.no_new_captures(f"[{tag}] serving burst"):
        results, report, launches, stats = _serve_burst(torch, server, tag, requests, device)
    n_batches = stats["batches"]
    want = _scaled(mlip_launches_per_predict(layers, arch), n_batches)
    predictor = Predictor(model, aug, device=device)
    worst = max(float(np.max(np.abs(a - b))) for _, _, a, b in
                _served_vs_outputs(ep.buckets, predictor, requests, results))
    finite = all(np.isfinite(np.asarray(h)).all() for r in results for h in r["heads"])
    log(f"[{card}] [{tag}] served {stats['served']} requests in {n_batches} batches, "
        f"{_traffic_line(report)}; launches {launches} (expected {want}); captured answers vs "
        f"Predictor.outputs (the eager step) on the same padded batches: max|diff| {worst:.3e} "
        f"(allowed 0); graphs captured {stats['captures']}")
    if stats["served"] != len(requests) or stats["failed"] or stats["captures"] != captures:
        raise AssertionError(f"MLIP serving: {stats}")
    if (device == "cuda" and launches != want) or worst != 0.0 or not finite:
        raise AssertionError(f"MLIP serving [{tag}]: launches {launches} != {want}, or served "
                             f"answers differ from the eager step ({worst}), or not finite")
    sm = report.summary()
    return {"launches": launches, "batches": n_batches,
            "summary": [sm["p50_ms"], sm["p99_ms"], sm["graphs_per_sec"]]}


def mlip_cpu_parity(torch, model, host, device: str, tag: str) -> None:
    """A trained MLIP's energies and forces on one batch, on the card
    against the port's CPU route from the same state: energies within
    ``CPU_PARITY``, forces within ``MD_RTOL`` x 10 of the largest force
    (fp32 sums in other orders through the layers, the heads and the
    position gradient)."""
    from hydragnn_tpu_torch.models.mlip import make_energy_and_forces

    e_dev, f_dev = make_energy_and_forces(model)(host.to(device))
    cpu = copy.deepcopy(model).to("cpu")
    e_cpu, f_cpu = make_energy_and_forces(cpu)(host)
    gm = host.graph_mask > 0
    de = float((e_dev.cpu()[gm] - e_cpu[gm]).abs().max())
    ok_e = torch.allclose(e_dev.cpu()[gm], e_cpu[gm], **CPU_PARITY)
    f_max = float(f_cpu.abs().max())
    df = float((f_dev.cpu() - f_cpu).abs().max())
    log(f"[{tag}] energies and forces, {device} vs the CPU route on one batch: max|dE| "
        f"{de:.3e} (rtol {CPU_PARITY['rtol']}, atol {CPU_PARITY['atol']}), max|dF| {df:.3e} of "
        f"max|F| {f_max:.3e} (allowed {10 * MD_RTOL} of it)")
    if not ok_e or df > 10 * MD_RTOL * f_max:
        raise AssertionError(f"[{tag}] the card's energies or forces disagree with the CPU route")


# -- phase 14: registration from a checkpoint, and the fleet -------------------------

FLEET_PROBES = 32           # requests sent one at a time (each served alone)
FLEET_REQUESTS = 512        # the traffic through the router and the one server
FLEET_KILL_AFTER = 128      # answered requests before one replica is killed
FLEET_BOOT_S = 300.0
# a second traffic router's window per replica (logged, not gated): the
# default, Serving.fleet.inflight_per_replica 2, keeps the replicas' batches
# at 2 requests; at 32 the router's pool, which keeps 4 idle sockets per
# replica, opens and closes connections under load
FLEET_INFLIGHT = 32
# the fleet's int8 replicas certify at this Serving.quant_tol: the trained
# GIN refuses the default 0.1 (phase 10 pins its bound), and this phase
# holds the replicas' int8 answers to the in-process int8 server's bit for
# bit, not to an error bound
FLEET_INT8_TOL = 1.0


def checkpoint_phase(torch, kind: str, model, aug: dict, samples, tmp: str,
                     card: str = "", device: str = "cuda") -> dict:
    """The trained model written as a training run writes it
    (``config.json`` and a checkpoint under ``tmp``), registered with
    ``add_model_from_checkpoint`` beside ``add_model`` of the live model:
    the restored weights bit-equal, and 512 requests to the registered
    endpoint answered bit-equal to the live model's ``Predictor.outputs``
    (its eager step) on the same padded batches. Returns the run's
    ``path`` and ``log_name``."""
    from hydragnn_tpu_torch import capture
    from hydragnn_tpu_torch.config.schema import get_log_name_config, save_config
    from hydragnn_tpu_torch.serve import PredictionServer, ServingConfig
    from hydragnn_tpu_torch.train.checkpoint import save_checkpoint
    from hydragnn_tpu_torch.train.step import create_train_state

    log_name = get_log_name_config(aug)
    save_config(aug, log_name, tmp)
    state = create_train_state(copy.deepcopy(model), aug["NeuralNetwork"]["Training"]["Optimizer"])
    save_checkpoint(state, log_name, epoch=int(aug["NeuralNetwork"]["Training"]["num_epoch"]),
                    path=tmp)
    server = PredictionServer(ServingConfig(queue_depth=2048, flush_ms=5.0), device=device)
    live = server.add_model("live", model, aug, samples=samples)
    ep = server.add_model_from_checkpoint("ckpt", log_name, path=tmp, samples=samples)
    same = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 ep.predictor.model.state_dict().values()))
    server.warmup()
    with capture.no_new_captures(f"[{kind}] checkpoint-registered serving burst"):
        results, report, _, stats = _serve_burst(torch, server, "ckpt", samples, device)
    worst = max(float(np.max(np.abs(a - b))) for _, _, a, b in
                _served_vs_outputs(ep.buckets, live.predictor, samples, results))
    log(f"[{card}] [{kind}] add_model_from_checkpoint ({tmp}/{log_name}): weights "
        f"{'bit-equal' if same else 'DIFFER'} to the live model's, buckets "
        f"{'equal' if ep.buckets == live.buckets else 'DIFFER'}; {stats['served']} requests, "
        f"{_traffic_line(report)}; answers vs the live model's Predictor.outputs on the same "
        f"padded batches: max|diff| {worst:.3e} (allowed 0)")
    if not same or ep.buckets != live.buckets or worst != 0.0 or stats["failed"]:
        raise AssertionError("checkpoint registration: not bit-equal to the live endpoint")
    return {"path": tmp, "log_name": log_name}


def _spawn_replicas(spec: dict, n: int) -> list:
    """``n`` replica workers booted at once (each ``spawn_replica`` waits
    for its ready file); all or none."""
    from hydragnn_tpu_torch.serve.fleet.replica import spawn_replica

    out, errors = [None] * n, []

    def boot(i):
        try:
            out[i] = spawn_replica(spec, timeout_s=FLEET_BOOT_S)
        except Exception as exc:  # noqa: BLE001 (re-raised below)
            errors.append(exc)

    threads = [threading.Thread(target=boot, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        for w in out:
            if w is not None:
                w.terminate()
        raise errors[0]
    return out


def _heads_equal(a, b) -> bool:
    return len(a) == len(b) and all(
        np.asarray(x).dtype == np.asarray(y).dtype and np.asarray(x).tobytes()
        == np.asarray(y).tobytes() for x, y in zip(a, b))


def fleet_phase(torch, kind: str, model, aug: dict, samples, ckpt: dict, tmp: str,
                card: str = "", device: str = "cuda") -> dict:
    """The multi-process fleet on the card: for fp32, then int8
    (``Serving.quantize`` at ``FLEET_INT8_TOL``), two replica processes
    (``python -m hydragnn_tpu_torch.serve.fleet.replica``) booted from the
    checkpoint paths alone (``add_model_from_checkpoint``; the kernels were
    built by this process before the spawn) behind a ``FleetRouter``, and
    one in-process server registered from the same checkpoint. Gates:
    ``FLEET_PROBES`` requests sent one at a time (each served alone, a
    batch of one) answered through the router bit-equal to the in-process
    server, whose answers equal its ``Predictor.outputs`` on that padded
    batch; the same requests again are cache hits, byte-identical; each
    replica's ``stats`` reads 0 captures since ready; fp32: the canary
    accepts an identical model (the in-process server behind a wire host)
    and refuses a perturbed one (weights + 1e-3); then ``FLEET_REQUESTS``
    requests (``serve.traffic``) through the one server, through a router
    without the cache at ``FLEET_INFLIGHT`` requests in flight per replica
    (logged), and through one at the default window (its interactive
    budget the whole burst), one replica killed (SIGKILL) in it after
    ``FLEET_KILL_AFTER`` answers in the fp32 run, every request answered.
    Logs p50/p99 and graphs/s of each."""
    from hydragnn_tpu_torch.serve import (CanaryMismatchError, FleetRouter, PredictionServer,
                                          ReplicaHost, ServingConfig, run_traffic)
    from hydragnn_tpu_torch.serve.batcher import serving_collate
    from hydragnn_tpu_torch.serve.fleet.config import RolloutConfig
    from hydragnn_tpu_torch.serve.fleet.replica import write_samples_file
    from hydragnn_tpu_torch.serve.fleet.rollout import run_canary

    name = f"qm9_{kind}"
    samples_file = write_samples_file(samples, str(Path(tmp) / "fleet_samples.wire"))
    out = {}
    for mode, extra in (("fp32", {}), ("int8", {"quantize": True, "quant_tol": FLEET_INT8_TOL})):
        serving = dict(queue_depth=2048, flush_ms=5.0, **extra)
        spec = {"models": [{"name": name, "log_name": ckpt["log_name"], "path": ckpt["path"],
                            "samples_file": samples_file}], "serving": serving,
                "device": device}
        t0 = time.perf_counter()
        workers = _spawn_replicas(spec, 2)
        boot_s = time.perf_counter() - t0
        local = PredictionServer(ServingConfig(**serving), device=device)
        ep = local.add_model_from_checkpoint(name, ckpt["log_name"], path=ckpt["path"],
                                             samples=samples)
        local.warmup()
        local.start()
        router = FleetRouter({"peer_timeout": 60.0, "cache_bytes": 1 << 26})
        traffic_router = FleetRouter({"peer_timeout": 60.0, "cache_bytes": 0,
                                      "budget_interactive": FLEET_REQUESTS})
        wide_router = FleetRouter({"peer_timeout": 60.0, "cache_bytes": 0,
                                   "budget_interactive": FLEET_REQUESTS,
                                   "inflight_per_replica": FLEET_INFLIGHT})
        hosts = []
        try:
            for w in workers:
                for r in (router, traffic_router, wide_router):
                    r.attach("127.0.0.1", w.port)
            router.start()
            probes = samples[:FLEET_PROBES]
            bad, routed = 0, []
            for s in probes:
                got = router.submit(name, s).result(timeout=120)
                routed.append(got["heads"])
                ref = local.submit(name, s).result(timeout=120)
                pad = next(b for b in ep.buckets if b.as_tuple() == tuple(ref["bucket"]))
                want = ep.predictor.split_graphs(
                    ep.predictor.outputs(serving_collate([s], pad), step=ep._step_for(pad)),
                    [s.num_nodes])[0]
                bad += not (_heads_equal(got["heads"], ref["heads"])
                            and _heads_equal(ref["heads"], want) and ref["batch_graphs"] == 1)
            hits = [router.submit(name, s).result(timeout=60) for s in probes]
            hit_bad = sum(not (h.get("cached") and _heads_equal(h["heads"], r))
                          for h, r in zip(hits, routed))
            steady = [router.replica_stats(i)["steady_captures"] for i in range(2)]
            quant = [router.replica_stats(i)["models"][name]["quantized"] for i in range(2)]
            log(f"[{card}] [fleet {mode}] 2 replica processes booted from {ckpt['log_name']} in "
                f"{boot_s:.1f} s (warm-up included, int8 buckets per replica {quant}); "
                f"{len(probes)} requests one at a time through the router vs the in-process "
                f"server and its Predictor.outputs: {len(probes) - bad} bit-equal (allowed "
                f"all); again: {len(hits) - hit_bad} cache hits byte-identical; captures since "
                f"ready per replica {steady} (allowed 0)")
            if bad or hit_bad or any(steady) or (mode == "int8") != all(q > 0 for q in quant):
                raise AssertionError(f"fleet {mode}: {bad} probes differ, {hit_bad} cache hits "
                                     f"not byte-identical, captures since ready {steady}, "
                                     f"int8 buckets {quant}")
            if mode == "fp32":
                twin = ReplicaHost(local)
                hosts.append(twin)
                verdict = run_canary(router, [("127.0.0.1", twin.port)],
                                     [(name, s) for s in probes[:4]], RolloutConfig())
                perturbed = copy.deepcopy(ep.predictor.model)
                with torch.no_grad():
                    for p in perturbed.parameters():
                        p.add_(1e-3)
                other = PredictionServer(ServingConfig(**serving), device=device)
                other.add_model(name, perturbed, aug, samples=samples)
                other.warmup()
                other.start()
                wrong = ReplicaHost(other)
                hosts.append(wrong)
                try:
                    run_canary(router, [("127.0.0.1", wrong.port)],
                               [(name, s) for s in probes[:4]], RolloutConfig())
                    refused = None
                except CanaryMismatchError as exc:
                    refused = str(exc).splitlines()[0][:160]
                finally:
                    other.stop()
                log(f"[fleet {mode}] canary: identical model {verdict}; perturbed model "
                    f"{'refused: ' + refused if refused else 'ACCEPTED'}")
                if verdict != {0: "ok"} or refused is None:
                    raise AssertionError("fleet: the canary did not accept the identical model "
                                         "and refuse the perturbed one")
            # the traffic: the one in-process server, the router at a window
            # of FLEET_INFLIGHT (logged), then the router at the default
            # window (gated; in fp32 a replica dies in it)
            order = np.arange(FLEET_REQUESTS) % len(samples)
            local_rep = run_traffic(local, name, samples, FLEET_REQUESTS, order=order)
            wide_router.start()
            wide = run_traffic(wide_router, name, samples, FLEET_REQUESTS, order=order,
                               timeout_s=300.0)
            wide_router.stop()
            traffic_router.start()
            killed = {}
            if mode == "fp32":
                def killer():
                    while traffic_router.stats()["served"] < FLEET_KILL_AFTER:
                        time.sleep(0.001)
                    killed["served"] = traffic_router.stats()["served"]
                    workers[0].kill()
                    killed["at"] = time.perf_counter()

                kt = threading.Thread(target=killer, daemon=True)
                kt.start()
            rec = _Recorded(traffic_router)
            rep = run_traffic(rec, name, samples, FLEET_REQUESTS, order=order, timeout_s=300.0)
            st = traffic_router.stats()
            finite = all(np.isfinite(np.asarray(h)).all() for f in rec.futures
                         for h in f.result()["heads"])
            log(f"[{card}] [fleet {mode}] {FLEET_REQUESTS} requests (serve.traffic, closed "
                f"burst): one in-process server {_traffic_line(local_rep)}; router over 2 "
                f"replicas at {FLEET_INFLIGHT} in flight per replica {_traffic_line(wide)} "
                f"(served {wide.n_served}); router over 2 replicas at the default window "
                f"{_traffic_line(rep)}; served {rep.n_served}, shed {rep.n_shed}, "
                f"failed {st['failed']}, failovers {st['failovers']}, requeues {st['requeues']}"
                + (f"; replica 0 killed after {killed.get('served')} answers" if killed else ""))
            if rep.n_served != FLEET_REQUESTS or st["failed"] or not finite:
                raise AssertionError(f"fleet {mode}: requests lost or failed: {rep.summary()}, "
                                     f"{st['failed']} failed")
            if mode == "fp32" and not (killed.get("served", FLEET_REQUESTS) < FLEET_REQUESTS
                                       and st["failovers"] >= 1):
                raise AssertionError(f"fleet: the replica kill did not land mid-stream: {killed}, "
                                     f"failovers {st['failovers']}")
            out[mode] = {"local": [local_rep.summary()[k] for k in
                                   ("p50_ms", "p99_ms", "graphs_per_sec")],
                         "router": [rep.summary()[k] for k in
                                    ("p50_ms", "p99_ms", "graphs_per_sec")],
                         "router_wide": [wide.summary()[k] for k in
                                         ("p50_ms", "p99_ms", "graphs_per_sec")],
                         "boot_s": boot_s, "failovers": st["failovers"]}
        finally:
            for r in (router, wide_router, traffic_router):
                r.stop()
            for h in hosts:
                h.close()
            for w in workers:
                w.terminate()
            local.stop()
    return out


def kernels_only(torch, seed: int, dev: dict) -> int:
    """``--kernels-only``: every kernel against its plain version with its
    times, at the main paths' shapes: phase 3, the cell-list checks and
    times (on both MD systems, the MLIP one made from the untrained oc20
    configuration), then phase 3b (which ends with B6's and B7's tensor-core
    check). Prints the entries under ``kernels_only``, not as the kernels line, with
    ``launches`` null (no main path ran, so nothing counted them), and
    returns 3."""
    from hydragnn_tpu_torch.config import update_config
    from hydragnn_tpu_torch.models import create_model_config
    from hydragnn_tpu_torch.preprocess.load_data import dataset_loading_and_splitting

    t_start = time.perf_counter()
    _, aug_gin, loaders, samples = prepare(seed)
    n_max = update_config(qm9_config("gps"), loaders[0].samples)[
        "NeuralNetwork"]["Architecture"]["max_graph_nodes"]
    top, small = bucket_batches(loaders, samples)
    mlip_b = mlip_train_batch()
    entries, _ = kernel_phase(torch, top, small, n_max=n_max, mlip_batch=mlip_b)
    geometric_failures: list = []
    geometric_kernel_phase(torch, seed, entries, geometric_failures)
    edge_kernel_phase(torch, seed, entries, geometric_failures)
    if geometric_failures:
        raise AssertionError(f"kernels not bit for bit: {geometric_failures}")
    cfg = mlip_config(MLIP_EPOCHS)  # augmented as run_training augments it
    mlip_loaders = dataset_loading_and_splitting(cfg, samples=mlip_samples())
    aug = update_config(cfg, *(ld.samples for ld in mlip_loaders))
    entries.append(cell_list_phase(torch, md_systems(aug, seed)))
    entries += quant_kernel_phase(torch, create_model_config(aug_gin, device="cuda", seed=seed),
                                  top, egnn_rows=mlip_b.num_edges)
    log(f"chip_smoke --kernels-only: {time.perf_counter() - t_start:.1f} s; no main path was "
        f"driven, so no result line")
    log(dev["smi"])
    for e in entries:
        e["launches"] = None
    print(json.dumps({"kernels_only": entries}), flush=True)
    return 3


@contextlib.contextmanager
def timed_phase(times: dict, name: str):
    """Adds the block's wall seconds to ``times[name]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quant-diagnostics", action="store_true",
                        help="phase 10 also attributes each model's int8 bound to its Dense "
                             "layers and calibrates on the whole training split (logged only)")
    parser.add_argument("--kernels-only", action="store_true",
                        help="only build the kernels and hold each against its plain version "
                             "with its times (phases 3, 3b and the cell-list checks of 9, on "
                             "untrained models); prints their entries under kernels_only "
                             "(launches null), no result line, and exits 3: no main path is "
                             "driven")
    args = parser.parse_args(argv)

    import torch

    t_start = time.perf_counter()
    phase_s: dict[str, float] = {}  # wall seconds per phase, logged before the result lines
    dev = device_phase(torch)
    import hydragnn_tpu_torch
    from hydragnn_tpu_torch.config import update_config

    pkg = Path(hydragnn_tpu_torch.__file__).resolve().parent
    if pkg.parent != ROOT:
        raise SystemExit(f"chip_smoke: hydragnn_tpu_torch imported from {pkg}, not this checkout")
    with timed_phase(phase_s, "build"):
        build_phase()
    if args.kernels_only:
        return kernels_only(torch, args.seed, dev)
    with timed_phase(phase_s, "data"):
        _, aug_gin, loaders, samples = prepare(args.seed)
        n_max = update_config(qm9_config("gps"), loaders[0].samples)[
            "NeuralNetwork"]["Architecture"]["max_graph_nodes"]
        top, small = bucket_batches(loaders, samples)
        mlip_b = mlip_train_batch()
    with timed_phase(phase_s, "kernels"):
        entries, kernel_times = kernel_phase(torch, top, small, n_max=n_max, mlip_batch=mlip_b)
        geometric_failures: list = []
        kernel_times.update(geometric_kernel_phase(torch, args.seed, entries,
                                                   geometric_failures))
        edge_kernel_phase(torch, args.seed, entries, geometric_failures)
        if geometric_failures:
            raise AssertionError(f"kernels not bit for bit: {geometric_failures}")
        from hydragnn_tpu_torch.models import create_model_config

        entries += quant_kernel_phase(torch, create_model_config(aug_gin, device="cuda",
                                                                 seed=args.seed), top,
                                      egnn_rows=mlip_b.num_edges)
        quant_stack_kernel_phase(torch, args.seed,
                                 next(e for e in entries if e["name"] == "quant_dense"))
        second_derivative_phase(torch, top)
    served, trained, quantized = {}, {}, {}
    for kind in MODELS:
        with timed_phase(phase_s, kind):
            served[kind] = serving_phase(torch, "cuda", args.seed, kind, card=dev["smi"])
            trained[kind] = training_phase(torch, "cuda", args.seed, kind, kernel_times,
                                           card=dev["smi"])
            quantized[kind] = quant_serving_phase(torch, "cuda", args.seed, kind,
                                                  trained[kind]["model"], trained[kind]["aug"],
                                                  card=dev["smi"],
                                                  diagnostics=args.quant_diagnostics)
    for kind in {**STACKS, **GEOMETRIC}:
        with timed_phase(phase_s, kind):
            served[kind] = serving_phase(torch, "cuda", args.seed, kind, card=dev["smi"])
            trained[kind] = training_phase(torch, "cuda", args.seed, kind, kernel_times,
                                           card=dev["smi"])
            quantized[kind] = quant_serving_phase(torch, "cuda", args.seed, kind,
                                                  trained[kind]["model"], trained[kind]["aug"],
                                                  card=dev["smi"],
                                                  diagnostics=args.quant_diagnostics,
                                                  comparators=False)
    for kind in EDGE_KINDS:
        with timed_phase(phase_s, kind):
            served[kind] = serving_phase(torch, "cuda", args.seed, kind, card=dev["smi"])
            trained[kind] = training_phase(torch, "cuda", args.seed, kind, kernel_times,
                                           card=dev["smi"])
            quantized[kind] = quant_serving_phase(torch, "cuda", args.seed, kind,
                                                  trained[kind]["model"], trained[kind]["aug"],
                                                  card=dev["smi"],
                                                  diagnostics=args.quant_diagnostics,
                                                  comparators=False)
    for kind in (*QM9_OPTIONS, *MULTIBRANCH_KINDS):
        with timed_phase(phase_s, kind):
            served[kind] = serving_phase(torch, "cuda", args.seed, kind, card=dev["smi"])
            trained[kind] = training_phase(torch, "cuda", args.seed, kind, kernel_times,
                                           card=dev["smi"],
                                           epochs=GFM_EPOCHS if kind in OWN_DATA
                                           else TRAIN_EPOCHS)
            quantized[kind] = quant_serving_phase(torch, "cuda", args.seed, kind,
                                                  trained[kind]["model"], trained[kind]["aug"],
                                                  card=dev["smi"],
                                                  diagnostics=args.quant_diagnostics,
                                                  comparators=False)
    with timed_phase(phase_s, "conv_checkpointing"):
        ckpt_report = conv_checkpointing_phase(torch, args.seed, trained["gat"],
                                               trained["gat_ckpt"], card=dev["smi"])
    with timed_phase(phase_s, "mptrj_film"):
        film = mlip_training_phase(torch, "cuda", args.seed, card=dev["smi"], kind="mptrj_film")
        film_served = mlip_serving_phase(torch, args.seed, film, card=dev["smi"],
                                         kind="mptrj_film")
        mlip_cpu_parity(torch, film["model"], film["batch"], "cuda", "mptrj_film")
        quantized["mptrj_film"] = quant_serving_phase(
            torch, "cuda", args.seed, "mptrj_film", film["model"], film["aug"], card=dev["smi"],
            diagnostics=args.quant_diagnostics, comparators=False)
    with timed_phase(phase_s, "optimizers"):
        optimizers = optimizer_phase(torch, args.seed, card=dev["smi"])
    with timed_phase(phase_s, "variants"):
        variants = {name: variant_phase(torch, args.seed, name, card=dev["smi"])
                    for name in VARIANTS}
    with timed_phase(phase_s, "superstep"):
        superstep = superstep_phase(torch, args.seed, card=dev["smi"])
    with timed_phase(phase_s, "canaries"):
        canary_phase(torch, "cuda", card=dev["smi"])
    with timed_phase(phase_s, "mlip"):
        mlip = mlip_training_phase(torch, "cuda", args.seed, card=dev["smi"])
    mlips, mlip_served = {}, {}
    for arch in MLIP_ARCHS:
        with timed_phase(phase_s, f"mlip-{arch.lower()}"):
            mlips[arch] = mlip_training_phase(torch, "cuda", args.seed, card=dev["smi"],
                                              arch=arch)
    with timed_phase(phase_s, "mlip-serving"):
        for arch, m in dict(EGNN=mlip, **mlips).items():
            mlip_served[arch] = mlip_serving_phase(torch, args.seed, m, arch, card=dev["smi"])
    with timed_phase(phase_s, "md"):
        systems = md_systems(mlip["aug"], args.seed)
        entries.append(cell_list_phase(torch, systems))
        ran_md = md_phase(torch, "cuda", systems, mlip["model"], mlip["layers"],
                          card=dev["smi"])
    with timed_phase(phase_s, "fp8"):
        fp8 = fp8_phase(torch, trained["gin"]["model"], top, mlip["model"], mlip["batch"],
                        card=dev["smi"])
    with timed_phase(phase_s, "fleet"), tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        gin_samples = [s for ld in prepare(args.seed, "gin")[2] for s in ld.samples]
        ckpt = checkpoint_phase(torch, "gin", trained["gin"]["model"], trained["gin"]["aug"],
                                gin_samples, tmp, card=dev["smi"])
        fleet = fleet_phase(torch, "gin", trained["gin"]["model"], trained["gin"]["aug"],
                            gin_samples, ckpt, tmp, card=dev["smi"])
    for e in entries:
        name = e["name"]
        if name == "quant_dense":
            # launches: the quantized serving runs of the sixteen trained
            # qm9 models
            e["launches"] = sum(q["launches"][name] for q in quantized.values())
            e["launches_per_served_batch"] = {
                k: q["launches"][name] / q["batches"] for k, q in quantized.items()}
            if any(q["launches"][name] <= 0 for q in quantized.values()):
                raise AssertionError("quant_dense was not launched on a quantized serving path")
            continue
        if name == "fp8_dense":
            # launches: certify_fp8_dense over the trained GIN's Dense calls
            e["launches"] = fp8["launches"][name]
            e["max_abs_err"] = max(e["max_abs_err"], fp8["max_abs_err"])
            e["egnn_edge_mlp"] = fp8["egnn"]
            if e["launches"] <= 0:
                raise AssertionError("fp8_dense was not launched by certify_fp8_dense")
            continue
        # launches: the main paths' runs together (the sixteen qm9.json
        # run_training runs, the three MLIP run_training runs, the two MD
        # rollouts); the serving runs' counts, the per-model rates and the
        # smaller-depth variants' steps beside them
        e["launches"] = (sum(trained[k]["launches"][name] for k in ARCH_KNOBS)
                         + mlip["launches"][name] + film["launches"][name]
                         + sum(m["launches"][name] for m in mlips.values())
                         + sum(r["launches"][name] for r in ran_md.values()))
        e["launches_variants"] = sum(v["per_step"][name] + v["per_forward"][name]
                                     for v in variants.values())
        e["launches_mlip_run_training"] = mlip["launches"][name]
        e["launches_mlip_run_training_geometric"] = {
            a: m["launches"][name] for a, m in mlips.items()}
        e["launches_md"] = {k: r["launches"][name] for k, r in ran_md.items()}
        if name == "cell_list":
            if any(r["launches"][name] <= 0 for r in ran_md.values()):
                raise AssertionError("cell_list was not launched on an MD path")
            continue
        e["launches_serving"] = (sum(served[k]["launches"][name] for k in ARCH_KNOBS)
                                 + sum(m["launches"][name] for m in mlip_served.values())
                                 + film_served["launches"][name])
        e["launches_per_served_batch"] = {
            k: served[k]["launches"][name] / served[k]["batches"] for k in ARCH_KNOBS}
        e["launches_per_served_batch"].update({
            f"mlip-{a.lower()}": m["launches"][name] / m["batches"]
            for a, m in mlip_served.items()})
        if name == "segment_sum" and any(m["launches"][name] <= 0
                                         for m in mlip_served.values()):
            raise AssertionError("segment_sum was not launched on an MLIP serving path")
        e["launches_per_train_step"] = {k: trained[k]["per_step"][name] for k in ARCH_KNOBS}
        e["launches_per_train_step"]["mlip"] = mlip["per_step"][name]
        e["launches_per_train_step"]["mptrj_film"] = film["per_step"][name]
        for a, m in mlips.items():
            e["launches_per_train_step"][f"mlip-{a.lower()}"] = m["per_step"][name]
            if name == "segment_sum" and m["launches"][name] <= 0:
                raise AssertionError(f"segment_sum was not launched on the {a} MLIP's path")
        for kind in ARCH_KNOBS:
            layers = trained[kind]["layers"]
            if launches_per_train_step(kind, layers)[name] and \
                    trained[kind]["launches"][name] <= 0:
                raise AssertionError(f"{name} was not launched on {kind}'s training path")
            if launches_per_forward(kind, layers)[name] and served[kind]["launches"][name] <= 0:
                raise AssertionError(f"{name} was not launched on {kind}'s serving path")
    log("quantized serving, certified per-head bounds at the default quant_tol 0.1, and int8 "
        "code flips card vs CPU: " + "; ".join(
        f"{k} {[round(b, 6) for b in (q['refused'] or q['bounds'])]} "
        f"({'REFUSED at its pinned bound, served at ' + str(q['quant_tol']) if q['refused'] else 'certified'}"
        f", {q['flips']} codes flipped, {q['real_flips']} on real rows)"
        for k, q in quantized.items()))
    summary = {
        "serving": {k: served[k]["summary"] for k in ARCH_KNOBS},
        "train_step_ms": {k: {"eager": t["breakdown"]["step"],
                              "captured": t["captured"]["step_ms"],
                              "busy_eager": _lean(t["eager_busy"]),
                              "busy_captured": _lean(t["captured"]["busy"])}
                          for k, t in dict(trained, mlip=mlip, mptrj_film=film, **{
                              f"mlip-{a.lower()}": m for a, m in mlips.items()}).items()},
        "optimizers": optimizers,
        "conv_checkpointing": ckpt_report,
        "superstep_gin_s": superstep,
        "int8_serving": {k: q["summary"] for k, q in quantized.items()},
        "mlip_serving": {**{a: m["summary"] for a, m in mlip_served.items()},
                         "mptrj_film": film_served["summary"]},
        "fleet": fleet,
        "md_ms_per_step": {k: {"eager": r["eager_ms"], "captured": r["captured"]["step_ms"],
                               "busy_eager": _lean(r["captured"]["eager_busy"]),
                               "busy_captured": _lean(r["captured"]["busy"])}
                           for k, r in ran_md.items()},
    }
    log("capture summary (captured against eager, this run): " + json.dumps(summary))
    log("phase wall times (s): " + json.dumps({k: round(v, 3) for k, v in phase_s.items()}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start to the result lines")
    log(dev["smi"])  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                              "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
