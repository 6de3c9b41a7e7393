#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (polymer_chemprop_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100 (Hopper) and
the CUDA toolkit:

    python3 chip_smoke.py

or, on a machine with four cards of one host (the last section below;
the count is fixed at four, whose 2-D steps are dp 2 x ep 2):

    python3 chip_smoke.py --cards 4

Phases (any failure raises and exits non-zero; nothing is caught):

1. Print the card (``nvidia-smi`` name and power limit, torch's device
   name) and build every CUDA kernel with ``nvcc`` (one process per
   source, started together) and, beside them, the C++ host featurizer
   with ``g++`` (``native_ext.py``). The ``[host]`` lines then featurize
   and batch the bench batch's 1,024 SMILES with the Python path and
   with the C++ library at 1, 4 and 8 threads (median of 5 calls, host
   clock), every array of the C++ batch equal to the Python batch's bit
   for bit on this host, and time the dst-sorted CSR that either path's
   batches get and serving's CSV read and Python SMILES validity parse.
2. Hold each kernel against its plain PyTorch version on the card, on a
   featurized batch of 1024 molecules (about 28k dst-sorted bonds) at
   hidden 300, with unit and polymer (0.25/0.5/0.75) bond weights and
   several activations (and rows 1-3, the layer at every precision, on
   the EA/IP benchmark's weights 0.075/0.125/0.375/0.85 too, of which
   0.075 and 0.85 are not bf16-exact; their largest errors printed): the
   layer (and its ``z`` output), the layer's VJP kernel ``band_rev_bwd``
   and the readout. Tolerance: FP32 with another
   summation order, so max|kernel - plain| <= 1e-5 * max|plain| + 1e-6.
   The gradients (dm, dW_h, dinp and the readout's dm) of the two
   ``torch.autograd.Function``s are held against PyTorch's autograd
   through the plain versions, with the same tolerance relative to each
   gradient's largest entry; padding rows must give dm = -g exactly and
   add exactly nothing to dW_h. These hold the layer's FP32 entry
   (``band_precision`` "highest"); its tensor-core entry ("high" and
   "default") goes through the checks of ``band_matmul_act``'s below, at
   hidden 300, 37 and 1,495 (padding rows exactly 0, z bit for bit the
   FP32 entry's). The four plain-band kernels (``band_agg``,
   ``band_bwd``, ``band_matmul_act`` with ``z`` on and off,
   ``band_matmul``) go through the same checks on operands that are not
   zero on padding rows (``z = -m`` and ``dm = -g`` there, bit for bit),
   their three Functions' gradients too, and ``band_agg`` / ``band_bwd``
   once more at hidden 1,600; the Python arithmetic that picks the layer
   form by shape must equal the libraries' shared-memory answer. The two
   CSR-row kernels must equal the FP32 stage bit for bit (the same
   ``fmaf`` chain in CSR order): ``band_agg``'s z is ``band_matmul``'s
   FP32 z, ``atom_readout`` composed with ``a[src] - m[srev]`` is the FP32
   ``band_rev_layer``'s z on real rows, and atom 0 reads exactly 0; with
   unit weights the two VJP kernels must equal the readout bit for bit:
   ``band_bwd(g)`` is ``atom_readout(g)[dst] - g`` and ``band_rev_bwd(g)``
   is ``atom_readout(g[srev])[dst] - g[srev]`` on real rows.
   ``band_matmul_act`` and ``band_matmul`` also run on their tensor-core
   stage (``band_precision`` "high" and "default") at hidden 300, 37 and
   1,495, held against their plain versions at the same precision: the
   product and relu within the kernel tolerance, tanh and selu within the
   pre-activation's kernel tolerance times the activation's steepest slope
   (the tensor cores sum the pre-activation; tanh and selu squeeze it); z
   bit for bit the FP32 stage's; "high" within 3e-5 of the largest entry
   against FP64; the Functions' gradients (FP32 backward) against
   autograd through the plain versions with the split product's value.
   Time kernel, plain version and a PyTorch library yardstick with CUDA
   events, each launch after an L2 flush long enough for the host to run
   ahead of the device (and each kernel once more from an idle stream,
   where the time includes the host's way through the wrapper), and
   compute each kernel's bound from this batch; ``band_matmul_act`` and
   ``band_matmul`` at "high" and "highest" in turn, the yardstick with and
   without TF32; ``band_rev_layer`` likewise (its ``ms`` at "high"); the
   three once more at "default". All
   seven kernels are timed once more at the training batch's own shape
   (batch 50), each beside its bound from that batch. For the four
   CSR-row kernels (``atom_readout``, ``band_agg``, ``band_bwd``,
   ``band_rev_bwd``): the achieved GB/s at the three shapes (bench,
   training batch, hidden 1,600; ``band_rev_bwd`` not at 1,600, where its
   layer form never runs), and the CSR-row probe
   (``probes/csr_rows_probe.py``) in-process: the run-length histograms of
   the bench and training batches, and a copy of the same bytes and a
   one-float launch as yardsticks. Last, the ``atom_messages`` ops on the
   gather entry of ``atom_readout.cu`` (``atom_neighbor_sum_sorted``,
   ``src_readout_sorted``) at the bench shape with unit and polymer
   weights (which differ from their reverses'), at the training batch's
   shape and at hidden 37 and 1,600: each within 1e-5 of its plain
   version, equal bit for bit to the composed form ``atom_readout(h[src])``
   (the same ``fmaf`` chain), atom 0 exactly 0, and its VJP (the readout's
   with ``w[srev]``) against autograd through the plain version; timed at
   the bench shape beside the plain version, the composed form and
   ``index_add_``, at the training batch and at hidden 1,600, each beside
   its bound. Then the two sums the single-device encoder runs on row 3's
   entries (``readout_checks``): the one-launch molecule readout
   (``molecule_readout_f32``) over the molecule CSR of the bench batch
   (13,696 atoms into 1,024 molecules) at hidden 300, 37 and 1,600 and of
   the first training batch (768 into 50), at unit and polymer atom
   weights and each aggregation: within the kernel tolerance of its
   ``index_add_`` plain version (output and VJP), output and VJP bit for
   bit the composition it replaced (the gather entry on the gathered
   weights, then ``aggregate_molecules`` and autograd through it), its sum
   bit for bit the composed ``atom_readout(h[idx], w[idx])``; timed at the
   bench and training batches, the kernel alone and the whole op, each
   cold (after a flush) and warm (launches back to back with the inputs
   in L2), beside its bound, the composition and the plain version; and
   ``atom_messages``' ``f_sum`` at the bond-feature width, bit for bit its
   plain version (sums of 0/1 features). The gather ops are timed warm
   too.
3. Serving path: write full-width checkpoints (hidden 300, depth 3, FFN
   2 x 300, seeded random weights) in the JAX package's ``.ckpt`` format,
   one for regression and one for polymer regression, and run the port's
   ``make_predictions`` on the card on tests/data/regression.csv (500
   molecules) and on 200 synthetic copolymer strings, timing each run end
   to end (host featurization included), at the default
   ``band_precision`` "high", once with the C++ featurizer (the default)
   and once with ``use_native_featurizer=False`` (the Python one, graph
   cache emptied first); then 100 molecules from the regression
   checkpoint written at "highest". The kernels' launch counts must equal
   (depth - 1) x batches of the layer, and batches of the atom readout and
   of the molecule readout (its own counter), the same for either featurizer,
   every layer launch on the tensor cores at "high" and none at
   "highest"; the predictions must be finite, agree between the
   featurizers, and match the same run on the CPU (plain versions, at
   the same precision) within rtol 1e-4, atol 1e-5 (sums in another order
   on each side through five layers). The fingerprint entry point
   (``molecule_fingerprint``, "MPN" and "last_FFN") runs on the card from
   the regression checkpoint with the same exact launch counts, and its
   fingerprints match the CPU's within rtol 1e-4, atol 1e-5.

4. Training path: ``cross_validate`` on the card at full width (hidden
   300, depth 3, FFN 2 x 300, relu, mean, f32, dropout 0, Noam, Adam,
   batch 50): 3 epochs on tests/data/regression.csv (500 molecules,
   400/50/50 split) and 2 epochs on 200 synthetic copolymers. The launch
   counts of all three kernels must equal what the code implies (forward
   layer = (depth - 1) x (train steps + evaluation batches), all on the
   tensor cores at the default "high", backward = (depth - 1) x train
   steps, the atom readout and the molecule readout (its own counter)
   one per forward; the molecule readout's VJP is a gather); every logged
   loss is finite and the training loss falls. One optimizer step from the
   same initial weights on the same batch gives the same loss and gradient
   norm on the card as on the CPU (rtol 1e-4: FP32, other summation
   orders); the same whole run on the CPU (plain versions) gives the same
   test score within rtol 1e-2 (three epochs of FP32 differences passed
   through Adam's normalisation). The checkpoint the run wrote is then
   predicted from on the card. Each card run is made twice, with the C++
   featurizer and with ``use_native_featurizer=False``: the launch counts
   must be equal and the test scores agree within rtol 1e-2. Steps/s and
   molecules/s of the first (featurizing) and last (cached) epoch are
   printed with the card for both, and so is a cached epoch's time by
   part (loader, H2D, forward, backward, optimizer) with the device's
   busy time from torch.profiler.

5. Plain-band path: at the same width, ``cross_validate`` for 3 epochs on
   regression.csv and ``make_predictions`` from the checkpoint it wrote,
   once with ``bias=True`` (layer = ``band_agg`` + W_h in PyTorch) and once
   with ``undirected=True`` (layer = ``band_matmul_act`` at the default
   ``band_precision`` "high": the tensor-core stage), each with exact
   launch counts (per forward depth - 1 launches of the layer's kernel and
   one readout, per training step depth - 1 of ``band_bwd``, none of the
   rev-fused kernels; every ``band_matmul_act`` launch on the tensor
   cores), the first step's loss and gradient norm against the CPU (rtol
   1e-4), the test score against the CPU (rtol 1e-2) and the predictions
   against the CPU (rtol 1e-4, atol 1e-5); the CPU runs at "high" too. One
   prediction run with bfloat16 linear layers (rtol 2e-3, atol 1e-3
   against the CPU: both round the same operands to bfloat16 and
   accumulate in FP32, and differ where another summation order crosses a
   rounding boundary), one at hidden 1,600 (too wide for the fused
   kernels: ``band_agg``; 100 molecules; rtol 1e-4, atol 1e-5) and one
   ``undirected`` at ``band_precision="highest"`` (the FP32 stage; rtol
   1e-4, atol 1e-5). ``band_matmul``, which no encoder configuration
   reaches, is driven through its public op ``band_matmul_step_sorted``,
   forward and backward, at "highest" and at "high", on the bench batch
   and held against ``band_message_step_sorted`` followed by a product.

6. Probe path: both kernel probes' entry points
   (``polymer_chemprop_tpu_torch.probes.band_layer_probe`` and
   ``fused_matmul_probe``) in-process, on phase 2's featurized batch at
   hidden 300: the layer against its control (``band_ctrl``, modes
   ``noq`` and ``pure``) and cuBLAS, the layer's build / epilogue /
   product split (which must add up to the layer's time), and the
   split-bf16 tensor-core product (``fused_matmul``) against cuBLAS FP32
   and TF32 at (B, 300) x (300, 300) and (28,672, 384) x (384, 384). Both
   kernels must launch in that run. Then ``band_ctrl`` in both modes, at
   unit and polymer weights, with each block's range its own rows and
   with 512-row windows, and ``fused_matmul`` at both shapes and at the
   non-square (B, 300) x (300, 96), are held against their plain versions
   (1e-5 x max|plain| + 1e-6), ``fused_matmul`` also against FP64 (3e-5 x
   max). Both report their times beside their library calls (row 8
   ``relu(addmm)`` and, for ``pure``, ``mm``; row 10 ``mm`` in FP32 and
   TF32) and their bounds.

7. ``atom_messages`` path: at the same width, serving regression.csv and
   the 200 copolymers from written ``atom_messages`` checkpoints (C++
   featurizer), ``fingerprint`` MPN and a bfloat16 run from the regression
   one (rtol 1e-4, atol 1e-5 against the CPU; bf16 2e-3 / 1e-3), then
   ``cross_validate`` 3 epochs on regression.csv and 2 on the copolymers
   (first step's loss and gradient norm 1e-4, test score 1e-2 against the
   CPU; the regression run's epoch breakdown and idle share). Exact launch
   counts: per forward depth - 1 neighbour sums, the atom and the molecule
   readout (its own counter) and ``f_sum`` (row 3 at unit weights); per
   training step one more launch of the neighbour sums and the atom
   readout (their VJPs); no other kernel.

8. Extra features: at the same width, with the C++ featurizer, the C++
   descriptor engine's ``rdkit_2d_normalized`` time for the 500 molecules
   of regression.csv (caches emptied), then ``cross_validate`` (3 epochs,
   ``rdkit_2d_normalized``, ``no_features_scaling``; its cached epoch's
   breakdown and idle share) and serving from its checkpoint, every
   molecule's descriptors from the C++ engine (none from the Python one);
   serving from a written checkpoint with ``features_path``
   (tests/data/regression.npz) plus ``morgan`` and a features scaler;
   ``cross_validate`` (2 epochs) with ``atom_descriptors="descriptor"``
   (W_d) and bond features from seeded ``.npz`` files, and serving from
   it; serving the ``"feature"`` mode with atom and bond extras (the C++
   loader's ``_apply_extras``, counted) and ``atom_messages`` with
   descriptors from written checkpoints; ``cross_validate`` (2 epochs) on
   spectra with phase features and a phase mask, and serving from it; and
   serving ``features_only`` (no kernel launch). Each card run against the
   same run on the CPU: predictions rtol 1e-4, atol 1e-5; the first
   step's loss and gradient norm 1e-4; test scores and per-epoch losses
   1e-2. Exact launch counts as in phases 3, 4 and 7.

9. Entry points: at the same width, in torch's default mode (every float
   sum of the port runs in a fixed order, so two card runs compare bit
   for bit). ``.pt``: a
   ``best_model_full.pt`` exported with ``export_reference_checkpoint``
   from a written checkpoint, beside a stale ``model_0.pt``, serves the
   500 molecules equal to the ``.ckpt``'s bit for bit; a 1-epoch
   ``cross_validate`` takes ``model_0.pt`` (the SSL script's
   weights-only shape) as ``checkpoint_frzn`` with a frozen encoder,
   which stays unchanged bit for bit. A 2-epoch ``cross_validate`` with
   ``tensorboard`` and ``profile_dir`` gives the same score bit for bit
   as without them, its trace names rows 1, 2 and 3 (``tensorboard``'s
   presence is printed, not required). ``ssl_pretrain`` on the 200
   copolymers (2 + 2 epochs, ``val_frac`` 0.1, graph embeddings) with
   exact launch counts; its first masked step on the card against the CPU
   on the same draws and weights (loss and gradient norm 1e-4); a cached
   stage-1 epoch's steps/s and idle share; the transfer into a frozen
   encoder. ``hyperopt`` (3 start-up trials, 1 epoch, the first 100
   molecules; seed 0 draws hidden 1,500, so rows 5 and 6 run) on the card
   and the CPU: the same trials, each trial's seconds. A classifier
   trained 2 epochs on classification.csv, then ``interpret`` on 5 of its
   molecules with rollout 20 on the card and the CPU: scores 1e-4, the
   rationales compared, seconds a molecule and ``make_predictions``
   calls. The web app in a thread: upload regression.csv, train 2 epochs
   and predict 10 SMILES through HTTP (``/progress`` read, ``"error"``
   raises), equal to ``make_predictions`` bit for bit.

10. parallel/ under ``torchrun --standalone`` (this script with
   ``--parallel-rank``, one process a rank, all on the one card, so gloo
   by the backend rule; counts from each rank, which runs the main path
   only), at hidden 300, depth 3, FFN 2 x 300, relu, mean, the layer on
   its FP32 entry. First rows 3, 3a and 3b (and the gather VJP: the gather
   entry over bond rows with index srev) against their plain versions at
   the shapes of an ep-2 shard of the bench batch. Two ranks: dp, 3 SGD
   steps on regression.csv's first training batches (a micro-batch of 25
   of each 50 a rank) against one rank on the batches of 50 (loss and
   gradient norm 1e-4; parameters 1e-4 of each tensor's largest entry,
   the JAX dry run's elementwise measure printed beside it; equal on both
   ranks bit for bit); the four edge-parallel forwards at ep 2 on the
   bench batch against the single-device encoder (rtol 1e-4, atol 1e-5;
   overlapped against whole-window 1e-6); the halo exchange's ms a layer
   at the bench window, the dp step's gradient all-reduce alone, and the
   host partition of the bench batch (windows and CSRs); a cached dp
   epoch's and a cached gp epoch's steps/s; a gp step under the
   profiler, which must show no
   ``index_add_``. Four ranks: the 2-D halo step (dp 2 x ep 2), bonds and
   ``atom_messages``, 3 steps against one rank on the batches of 100
   (1e-4 as above; equal on all ranks). The dp step and both 2-D steps
   run twice from the seed, and each run's parameters' SHA-256 must be
   equal. Between the two launches, ``polymer_chemprop_tpu_torch.multichip``
   (the counterpart of ``__graft_entry__.py``'s ``dryrun_multichip``) at
   2 ranks on the card, every check of its sections passing, every rank
   on gloo. Then ``cli train`` under 2-rank
   torchrun, ``--data_parallel`` and ``--graph_parallel``, 3 epochs, on
   regression.csv and the 200 copolymers, each test score within 1e-3 of
   the same run on one rank in this call. The ``[parallel]`` lines name
   the backend they measured.

11. ``sklearn_train`` / ``sklearn_predict`` (no kernel of the port's: the
   forests and SVMs of ``baselines/`` are tensor code on the card; every
   fit's tensors must lie on it). (a) ``cli sklearn_train``: the random
   forest on regression.csv, 3 folds, seed 0, 500 trees, its mean test
   RMSE within 5% of the reference golden 1.582733; (b) the SVR on
   regression.csv, then the random forest (also with ``class_weight``
   "balanced") and the SVC on classification.csv (12 tasks with missing
   labels: the per-task path), each score printed beside the JAX
   package's; (c) a 50-tree forest of each kind, an SVR and an SVC fitted
   on the card and on the CPU from one seed: identical node arrays,
   predictions within 1e-9 relative, decision values within 1e-6; (d)
   ``cli sklearn_predict`` from (a)'s fold-0 model.pkl equal to the fold's
   own test predictions (1e-12); (e) the committed JAX-written pickles
   (``tests/data/sklearn_jax/``) read with no sklearn loaded, their
   predictions within 1e-9 relative of sklearn's; (f) 500 trees on
   regression.csv x 8 (4,000 rows, targets + seeded N(0, 0.1)): fit
   seconds, trees/s, predict molecules/s. The ``[sklearn]`` lines give fit
   seconds a fold, SMO iterations and seconds, Platt seconds and the host
   Morgan time of the 500 molecules.

12. The reference's golden-score configurations
   (``polymer_chemprop_tpu_torch/goldens.py``: the JAX package's
   ``TestGoldenScores``, chemprop v1.4's CI goldens) through the module's
   ``run_golden`` at full width, nothing cut: 10 epochs, 3 folds, seed 0,
   hidden 300, depth 3, batch 50, at the default ``band_precision``
   "high" (MPNN configurations, round trips through ``make_predictions``,
   the graph-parallel one through ``cli train`` under 2-rank torchrun on
   the one card, the forests and SVMs through ``baselines/``). Each score
   must lie inside its band: 5% of the reference value, or the round
   trips' two-sided bands and upper limits. Then the regression golden at
   ``band_precision="highest"`` (the FP32 entry alone) inside 5%, and the
   same run on the host's CPU (plain versions): fold by fold, every
   epoch's train loss and validation score on the card within 1e-2
   relative of the CPU's, and so the test score of the model each keeps,
   unless the two keep different epochs of a near-tie (the two epochs'
   validation scores within 1e-2 of each other on both devices); the mean
   test scores and the "high" minus "highest" difference are printed.
   The phase runs the 8 goldens of ``GOLDEN_NAMES`` (the whole set takes
   over 400 s; the module runs all 25). Each golden's launches of rows 1,
   2, 3, 3a and 3b are printed and counted.

13. The fork's polymer checks (``polymer_chemprop_tpu_torch/
   polymer_goldens.py``: the JAX package's ``tests/test_eaip_benchmark.py``
   and ``tests/test_polymer_learning.py``) at their own configurations,
   nothing cut. The reconstructed EA/IP benchmark (``eaip.py``, 972
   copolymers) through ``cross_validate`` at hidden 300, depth 3, batch
   50, 60 epochs, seed 0, "high", on the weighted ensemble strings and on
   the architecture-blind copy: the weighted arm's R² must exceed 0.90 and
   its RMSE lie below 0.85 x the blind arm's (the JAX package's CPU values
   printed beside them); the 240-copolymer learning check (hidden 64, 15
   epochs) must reach R² > 0.8. Both must launch rows 1-3, every row-1
   launch on the tensor cores. Then the weighted arm at
   ``band_precision="highest"`` for 10 epochs on the card (row 1 on its
   FP32 entry alone) and on the host's CPU (plain versions), held epoch
   by epoch within 1e-2 (as phase 12); and the weighted arm's model served
   on its test split on the card and the CPU (rtol 1e-4, atol 1e-5).

14. One seed, one model (``determinism_path``), in torch's default mode:
   every case runs twice on the card and must agree bit for bit. Serving
   regression.csv and the 200 copolymers from phase 3's checkpoints, and
   both fingerprint types; the EA/IP weighted arm at its full
   configuration (phase 13's run the first): every epoch's train loss and
   validation scores, the test RMSE and R² and the best model's
   parameters' SHA-256; the regression golden (phase 12's run the first)
   likewise fold by fold; ``atom_messages``, multiclass (3 classes, the
   JAX package's integration dataset) and an ``ssl_pretrain`` stage, 2
   epochs each (scores, parameters; SSL's graph embeddings). Then one
   training step (default, polymer, ``atom_messages``, multiclass, SSL)
   and one serving batch (default, ``atom_messages``, multiclass, polymer,
   fingerprint) each under torch.profiler and a dispatch log: no device
   kernel that adds floats with atomics (``probes/determinism_probe.py``
   ``atomic_kernel``: ``index_add_``'s ``indexFunc*``, ``scatter_add``,
   accumulating ``index_put_``), no float atomic dispatched.

15. The benchmark and the batch-scaling probe (``bench_path``): the
   entry points ``polymer_chemprop_tpu_torch/bench.py`` and
   ``probes/batch_scaling_probe.py``, called in-process at full width
   (1,024 molecules, hidden 300, depth 3; ``--wide`` hidden 2,400, depth
   6): the default, ``--fastband``, ``--polymer``, ``--bf16``, ``--wide``,
   ``--predict`` and ``--compare`` lines (``BENCH_TRIALS`` trials each),
   each of which fails unless its layer form's kernels launched in its
   timed window; then the scaling probe at 50, 1,024, 2,048 and 4,096
   molecules. Each training line's first step is held against the same
   step on the host's CPU from the same parameters: the default and
   ``--polymer`` lines at full size within 1e-4 (phase 4's first step),
   ``--bf16`` (2e-3), ``--fastband`` (``"default"``, 1e-2, as
   tests/test_torch_band_tc.py holds it) and ``--wide`` (1e-4) at 64
   molecules on the same code path; ``--compare``'s port line repeats the
   default line's first step bit for bit.

``--cards 4``: phases 1 and 2 (the build, and every kernel held against
its plain version on card 0, which the ``kernels`` line reports), then
the four-card phase, one rank a card, so every rank on NCCL (raises with
fewer than four cards, and unless every rank reports NCCL on a card of
its own). ``nvidia-smi topo -m`` (and ``nvlink --status``) printed; rows
3, 3a, 3b and the gather VJP at an ep-4 shard's shapes against their
plain versions; ``multichip`` at 4 and at 2 ranks (4's with
``NCCL_DEBUG=INFO``, whose channel lines name the transport); then 4
ranks of this script: dp, 3 steps of a micro-batch of 25 a rank against
one card at batch 100; the four edge-parallel forwards at ep 4 on the
bench batch (overlapped against whole-window 1e-6); the bench batch's
halo step at ep 4 (about 7,000 real bonds a shard) and its 2-D step (dp 2
x ep 2, a half of the batch a dp row), 3 SGD steps each against one
card's on the whole batch (loss 1e-4, parameters 1e-4 of each tensor's
largest entry), then each step's ms at four cards and one card's; the
2-D step on training batches with bond and atom messages (as phase 10);
each of these five run twice from the seed, every rank's and both runs'
parameters' SHA-256 equal; the halo exchange a layer at the bench
window, the gradient all-reduce, and cached dp (a micro-batch of 13 a
rank), gp (ep 4) and one-card epochs at batch 50. Phase 10's ranks and
these are checked and logged by one function (``check_ranks``). Last,
``cli train`` under 4-rank torchrun at the default ``band_precision``:
dp at batch 100 and gp at ep 4 (batch 50) on regression.csv and the 200
copolymers, and gp with ``--graph_parallel_dp 2`` on regression.csv, each
test score within 1e-3 of one card's run at the batch a step takes, and
the gp runs' count of batches that fell back to the single-device step
printed (all of them is a failure; phase 10 allows none). The
``kernels`` line counts every rank's launches.

The second-to-last line of output is a JSON object with each kernel's
numbers; the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import csv
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from polymer_chemprop_tpu_torch.probes.bench_batch import (bench_batch,
                                                            bench_smiles,
                                                            copolymer_csv)
from polymer_chemprop_tpu_torch.probes.readout_probe import (
    composed_readout, readout_bytes, warm_ms)
from polymer_chemprop_tpu_torch.probes.timing import flush_buffer, timed_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")   # git-ignored
HIDDEN, DEPTH, SEED = 300, 3, 0
BATCH_SIZE = 50          # the CLIs' default
N_POLYMERS = 200
TRAIN_EPOCHS = {"regression": 3, "polymer": 2}
PLAIN_BAND_EPOCHS = 3
WIDE_HIDDEN, WIDE_MOLECULES = 1600, 100
HIGHEST_MOLECULES = 100   # serving at band_precision "highest"
HOST_THREADS = (1, 4, 8)  # the C++ featurizer's threads in the [host] phase
HOST_REPS = 5
GRAPH_FIELDS = ("f_atoms", "f_bonds", "w_atoms", "w_bonds", "b2a", "b2dst",
                "b2revb", "a2mol", "degree_of_polym", "mol_mask")
FEATURIZERS = (("C++", None), ("Python", False))   # use_native_featurizer
REV_KERNELS = ("band_rev_layer", "band_rev_bwd")
CSR_KERNELS = ("atom_readout", "band_agg", "band_bwd",   # csrc/csr_rows.cuh
               "band_rev_bwd")
PLAIN_BAND_KERNELS = ("band_agg", "band_bwd", "band_matmul_act",
                      "band_matmul")
# the atom_messages ops (the gather entry of csrc/atom_readout.cu): the JSON
# name of each and its wrapper in ops/band_mpnn.py
GATHER_OPS = {"atom_neighbor_sum": "atom_neighbor_sum_sorted",
              "src_readout": "src_readout_sorted"}
# the kernels line's entries whose launch count is another wrapper's
COUNTED_AS = dict(GATHER_OPS, molecule_readout="molecule_readout_sorted")
GATHER_WIDTHS = (37, 1600)      # beside HIDDEN: one float a thread, wide
WARM_CALLS = 50                 # launches back to back in a warm time
PROBE_REPS = 10
JAX_PROBE_SHAPE = (28672, 384)   # scripts/fused_matmul_probe.py's (B, H)
# NVIDIA H100 SXM data sheet (dense, at the 700 W limit): FP32 without
# tensor cores, bf16 on the tensor cores and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
TC_PRECISIONS = ("high", "default")     # band_precision on the tensor cores
TC_WIDTHS = (37, 1495)                  # beside HIDDEN: ragged, the widest
# the kernel phase's bond weights beside unit ones, drawn for every real
# bond: multiples of 1/4, and the EA/IP benchmark's (polymer_chemprop_tpu_
# torch/eaip.py: block chains 0.075 and 0.85, random ones 0.125 and 0.375)
WEIGHT_SETS = {"polymer": (0.25, 0.5, 0.75),
               "eaip": (0.075, 0.125, 0.375, 0.85)}
REV_ROWS = ("band_rev_layer", "band_rev_bwd", "atom_readout")   # rows 1-3
# |act(a) - act(b)| <= slope |a - b|; selu's steepest slope is scale x alpha
ACT_SLOPE = {"relu": 1.0, "tanh": 1.0,
             "selu": 1.0507009873554805 * 1.6732632423543772}


def log(*args):
    print(*args, flush=True)


def check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def kernel_tolerance(ref: torch.Tensor) -> float:
    return 1e-5 * ref.abs().max().item() + 1e-6


def act_tolerance(pre: torch.Tensor, act: str) -> float:
    """The kernel tolerance of the pre-activation carried through ``act``:
    what the tensor cores sum is the pre-activation, and tanh and selu
    squeeze it to about 1 where it is large, not where it is small."""
    return ACT_SLOPE[act] * kernel_tolerance(pre)


def straight_through(x, wh, precision, bm):
    """``x @ W_h`` at ``precision`` in value, with the FP32 product's
    gradient: the reference for the autograd Functions, whose backward is
    FP32 at every precision (autograd through the split itself would
    round the gradient to bfloat16)."""
    fp32 = x @ wh
    return fp32 + (bm.band_product(x.detach(), wh.detach(), precision)
                   - fp32.detach())


# -- phase 1 ----------------------------------------------------------------

def card_and_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    import threading

    from polymer_chemprop_tpu_torch import native_ext
    from polymer_chemprop_tpu_torch.kernels import build
    host = {}      # the C++ featurizer builds (g++) while nvcc runs

    def build_host():
        try:
            host["seconds"] = native_ext.build()
        except Exception as e:           # raised again below
            host["error"] = e
    thread = threading.Thread(target=build_host)
    thread.start()
    seconds = build.build()
    log(f"[build] {len(build.KERNELS)} kernels built in {seconds:.2f} s")
    thread.join()
    if "error" in host:
        raise host["error"]
    log(f"[build] C++ featurizer {native_ext.library_path().name} built in "
        f"{host['seconds']:.2f} s (g++, beside nvcc)")
    return card


def host_phase(gb, card):
    """The C++ featurizer on the card's host, on the bench batch's 1,024
    SMILES: featurize and batch at 1, 4 and 8 threads (median of
    HOST_REPS calls on the host clock) against the Python path once more,
    every array equal to the Python path's (``gb``) bit for bit; then the
    dst-sorted CSR that every batch of either path gets."""
    from polymer_chemprop_tpu_torch import native_ext
    from polymer_chemprop_tpu_torch.features import (FeaturizationConfig,
                                                      mol2graph)
    smiles = bench_smiles(gb.mol_mask.shape[0])
    A, B = gb.f_atoms.shape[0], gb.f_bonds.shape[0]
    t0 = time.perf_counter()
    mol2graph(smiles)
    python_s = time.perf_counter() - t0
    log(f"[host] {len(smiles)} molecules, Python featurize and batch "
        f"{1e3 * python_s:.1f} ms (one thread, second call) on the host of "
        f"{card}: {native_ext.cpu_model()}, {os.cpu_count()} cores")
    for threads in HOST_THREADS:
        times = []
        for _ in range(HOST_REPS):
            t0 = time.perf_counter()
            got, valid = native_ext.featurize_batch_native(
                smiles, pad_atoms=A, pad_bonds=B, n_threads=threads)
            times.append(time.perf_counter() - t0)
        check(valid.all(), "a bench SMILES is invalid to the C++ featurizer")
        for k in GRAPH_FIELDS:
            a, b = getattr(got, k), getattr(gb, k)
            check(a.dtype == b.dtype and np.array_equal(a, b),
                  f"C++ featurizer's {k} differs from the Python path's")
        check((got.n_atoms_real, got.n_bonds_real)
              == (gb.n_atoms_real, gb.n_bonds_real), "real counts differ")
        ms = 1e3 * float(np.median(times))
        log(f"[host] C++ featurize and batch at {threads} threads: "
            f"{ms:.2f} ms (min {1e3 * min(times):.2f}), "
            f"{1e3 * python_s / ms:.1f}x the Python path; all "
            f"{len(GRAPH_FIELDS)} arrays equal to the Python path's bit "
            "for bit")
    times = []
    for _ in range(HOST_REPS):
        t0 = time.perf_counter()
        gb.arrays(sorted_aux=True)
        times.append(time.perf_counter() - t0)
    log(f"[host] dst-sorted CSR and f_bonds permute of the bench batch "
        f"(either path): {1e3 * float(np.median(times)):.2f} ms")
    # what serving does before the loader, whichever the featurizer
    from polymer_chemprop_tpu_torch.data import get_data, partition_valid
    fcfg = FeaturizationConfig()
    t0 = time.perf_counter()
    data = get_data(os.path.join(ROOT, "tests", "data", "regression.csv"),
                    target_columns=[], config=fcfg,
                    skip_invalid_smiles=False, store_row=True)
    t1 = time.perf_counter()
    _, valid = partition_valid(data, fcfg)
    t2 = time.perf_counter()
    log(f"[host] serving's CSV read {1e3 * (t1 - t0):.1f} ms and Python "
        f"SMILES validity parse {1e3 * (t2 - t1):.1f} ms of regression.csv "
        f"({len(valid)} molecules)")


# -- phase 2 ----------------------------------------------------------------

def read_smiles(path):
    import csv
    with open(path) as f:
        return [row[0] for row in csv.reader(f)][1:]


def kernel_ms(r: dict, name: str, fn, flush: torch.Tensor,
              key: str = "ms") -> None:
    """Both times of one kernel into ``r``: ``key`` with the host running
    ahead (device time) and ``key + "_idle_start"`` from an idle stream."""
    r[key] = timed_ms(f"{name} kernel", fn, flush)
    r[key + "_idle_start"] = timed_ms(f"{name} kernel from an idle stream",
                                      fn, flush, run_ahead=False)


def bound(bytes_moved: float, ops: float,
          peak_flops: float = PEAK_FP32_FLOPS):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def work(name: str, B: int, A: int, H: int, n_real: int, run_len: int = 0,
         precision: str = "high", mols: int = 0):
    """``(bytes, operations, peak)`` of one call of kernel ``name`` on a
    batch of B bonds (n_real of them real), A atoms and hidden H: each
    input read once, each output written once; the operations this
    batch's runs need (``run_len``: the rev layer's summed run lengths of
    src(t)); the peak for their type. The W_h-fused rows at "high" count
    three bf16 passes on the tensor cores, at "highest" the FP32
    product. Rows 2, 3, 5 and 6 take their bytes from the CSR-row probe's
    ``kernel_bytes``. The molecule readout (``molecule_readout``, ``mols``
    molecules, ``n_real`` atoms in runs, the only atom rows it reads)
    takes its bytes from ``probes/readout_probe.py``: an fma per atom
    element, then the ``mean``'s division, select and scale per output
    element."""
    csr = B + (A + 1)                      # w and rowptr
    if name == "molecule_readout":
        return (readout_bytes(n_real, mols, H),
                2 * n_real * H + 3 * mols * H, PEAK_FP32_FLOPS)
    if name in ("band_rev_layer", "band_matmul_act", "band_matmul"):
        # m, inp (or z) and out, W_h; the rev layer also reads src, srev
        nbytes = 4 * (3 * B * H + H * H + csr
                      + (2 * B if name == "band_rev_layer" else 0))
        if precision != "highest":
            return nbytes, 3 * 2 * B * H * H, PEAK_BF16_TC_FLOPS
        agg = {"band_rev_layer": 2 * run_len * H + B * H,
               "band_matmul_act": 2 * n_real * H + 2 * B * H,
               "band_matmul": 2 * n_real * H + B * H}[name]
        return nbytes, 2 * B * H * H + agg, PEAK_FP32_FLOPS
    if name in GATHER_OPS:
        # the (A, H) table read once (its rows gathered about B / A times
        # each come out of L2) and the (A, H) output written once;
        # src_sorted and rowptr, and the readout's weights; one add (the
        # neighbour sum) or fma (the readout) per run element
        nbytes = 4 * (2 * A * H + B + (A + 1)
                      + (B if name == "src_readout" else 0))
        per = 1 if name == "atom_neighbor_sum" else 2
        return nbytes, per * n_real * H, PEAK_FP32_FLOPS
    from polymer_chemprop_tpu_torch.probes.csr_rows_probe import (
        kernel_bytes,
    )
    if name in ("atom_readout", "band_agg"):
        # one fma per run element, and one subtraction per element of z
        ops = 2 * n_real * H + (B * H if name == "band_agg" else 0)
    else:
        # band_bwd, band_rev_bwd: one add per run element, one fma per
        # real and one negation per padding element
        ops = 3 * n_real * H + (B - n_real) * H
    return kernel_bytes(name, B, A, H, n_real), ops, PEAK_FP32_FLOPS


def gbps(nbytes: float, ms: float) -> float:
    return nbytes / ms * 1e-6


def csr_gbps(r: dict, name: str, shape) -> None:
    """A CSR-row kernel's achieved GB/s at the bench shape into ``r``."""
    r["gbps"] = gbps(work(name, *shape)[0], r["ms"])
    log(f"[time] {name} at B={shape[0]} A={shape[1]} H={shape[2]}: "
        f"{r['gbps']:.1f} GB/s, {100 * r['bound_ms'] / r['ms']:.1f}% of the "
        "bytes bound")


def time_against(r, name, kern, plain, lib, nbytes, ops, flush, shape,
                 peak_flops=PEAK_FP32_FLOPS):
    """Kernel, plain version and library yardstick timed in turn, and the
    kernel's bound from ``nbytes`` and ``ops``, into ``r``."""
    kernel_ms(r, name, kern, flush)
    r["plain_ms"] = timed_ms(f"{name} plain", plain, flush)
    r["library_ms"] = timed_ms(f"{name} library", lib, flush)
    r["bound_ms"], r["bound_by"] = bound(nbytes, ops, peak_flops)
    log(f"[time] {name} at {shape}: kernel_ms {r['ms']:.4f} (from an idle "
        f"stream {r['ms_idle_start']:.4f}) plain_ms {r['plain_ms']:.4f} "
        f"library_ms {r['library_ms']:.4f} bound_ms {r['bound_ms']:.4f} "
        f"({r['bound_by']}: {nbytes} bytes, {ops} operations)")


def unit_weight_vjps(bm, g, ws, srev, rp, dst, n_real):
    """With unit weights both VJP kernels are the atom readout of g (or of
    g[srev]) less the row, bit for bit on real rows: the same sum from 0
    in CSR order, and fmaf(1, G, -x) is G - x."""
    ones = torch.ones_like(ws)
    g_rev = g[srev.long()]
    d = dst[:n_real]
    for name, got, want in (
            ("band_bwd", bm.band_bwd(g, ones, rp),
             bm.atom_readout(g, ones, rp)[d] - g[:n_real]),
            ("band_rev_bwd", bm.band_rev_bwd(g, ones, srev, rp),
             bm.atom_readout(g_rev, ones, rp)[d] - g_rev[:n_real])):
        torch.cuda.synchronize()
        check(torch.equal(got[:n_real], want),
              f"{name} with unit weights is not the readout less the row")
        log(f"[kernel] {name} with unit weights equals the readout less the "
            f"row bit for bit on {n_real} real rows")


def kernel_phase(dev, gb):
    from polymer_chemprop_tpu_torch.models.nn import get_activation
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    from polymer_chemprop_tpu_torch.probes.bench_batch import bench_aux

    A, B = gb.f_atoms.shape[0], gb.f_bonds.shape[0]
    H = HIDDEN
    rng = np.random.default_rng(SEED)
    flush = flush_buffer(dev)   # 1 GiB, 20x the L2
    results = {}
    for weights in ("unit", *WEIGHT_SETS):
        w = gb.w_bonds
        if weights != "unit":
            w = np.where(w > 0, rng.choice(WEIGHT_SETS[weights], w.shape),
                         0.0).astype(np.float32)
        aux = bench_aux(gb, w)
        n_real = int(aux.rowptr[-1])
        real = np.zeros((B, 1), np.float32)
        real[:n_real] = 1.0
        T = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)
        m = T(rng.normal(size=(B, H)).astype(np.float32) * real)
        inp = T(rng.normal(size=(B, H)).astype(np.float32) * real)
        wh = T((rng.normal(size=(H, H)) * (2.0 / (2 * H)) ** 0.5)
               .astype(np.float32))
        ws, src, srev, rp = (T(aux.w_sorted), T(aux.src_sorted),
                             T(aux.srev), T(aux.rowptr))
        dst = T(aux.dst_sorted.astype(np.int64))
        for act in ("relu", "tanh", "selu"):
            got = bm.band_rev_layer(m, inp, wh, ws, src, srev, rp, act)
            ref = bm.band_rev_layer_plain(m, inp, wh, ws, src, srev, rp, act)
            torch.cuda.synchronize()
            err, tol = (got - ref).abs().max().item(), kernel_tolerance(ref)
            pad_max = got[n_real:].abs().max().item() if n_real < B else 0.0
            log(f"[kernel] band_rev_layer {weights} {act}: max_abs_err "
                f"{err:.3e} (tol {tol:.3e}), padding rows max {pad_max}")
            check(err <= tol, "band_rev_layer disagrees with its plain version")
            check(pad_max == 0.0, "padding rows must stay exactly zero")
            note_error(results, "band_rev_layer", err, weights)
        got = bm.atom_readout(m, ws, rp)
        ref = bm.atom_readout_plain(m, ws, rp)
        torch.cuda.synchronize()
        err, tol = (got - ref).abs().max().item(), kernel_tolerance(ref)
        log(f"[kernel] atom_readout {weights}: max_abs_err {err:.3e} "
            f"(tol {tol:.3e})")
        check(err <= tol, "atom_readout disagrees with its plain version")
        note_error(results, "atom_readout", err, weights)

        # the VJP kernel, on a cotangent that is not zero on padding rows
        g = T(rng.normal(size=(B, H)).astype(np.float32))
        got = bm.band_rev_bwd(g, ws, srev, rp)
        ref = bm.band_rev_bwd_plain(g, ws, srev, rp)
        torch.cuda.synchronize()
        err, tol = (got - ref).abs().max().item(), kernel_tolerance(ref)
        log(f"[kernel] band_rev_bwd {weights}: max_abs_err {err:.3e} "
            f"(tol {tol:.3e}), {B - n_real} padding rows")
        check(err <= tol, "band_rev_bwd disagrees with its plain version")
        check(torch.equal(got[n_real:], -g[n_real:]),
              "dm of padding rows must equal -g")
        note_error(results, "band_rev_bwd", err, weights)
        if weights == "unit":
            unit_weight_vjps(bm, g, ws, srev, rp, dst, n_real)

        # the forward kernel's z output (written only in training)
        _, z = bm.band_rev_layer_forward(m, inp, wh, ws, src, srev, rp,
                                         "relu", want_z=True)
        z_ref = bm.band_rev_z_plain(m, ws, src, srev, rp)
        torch.cuda.synchronize()
        err, tol = (z - z_ref).abs().max().item(), kernel_tolerance(z_ref)
        log(f"[kernel] band_rev_layer z {weights}: max_abs_err {err:.3e} "
            f"(tol {tol:.3e})")
        check(err <= tol, "band_rev_layer's z disagrees with the plain z")
        check(n_real == B or z[n_real:].abs().max().item() == 0.0,
              "z of padding rows must be exactly zero")
        # atom_readout composed with a[src] - m[srev] is that z bit for bit
        # on the real rows (the same fmaf chain in CSR order), and atom 0,
        # whose run is empty, reads exactly 0
        atoms = bm.atom_readout(m, ws, rp)
        composed = atoms[src.long()] - m[srev.long()]
        torch.cuda.synchronize()
        check(torch.equal(composed[:n_real], z[:n_real]),
              "atom_readout[src] - m[srev] is not the FP32 layer's z")
        check(bool((atoms[0] == 0).all()), "atom 0 must read exactly 0")
        log(f"[kernel] atom_readout {weights}: a[src] - m[srev] equals the "
            f"FP32 band_rev_layer z bit for bit on {n_real} real rows; "
            "atom 0 reads exactly 0")

        # the two Functions' gradients against autograd through the plain
        # versions, on the card
        g_out = T(rng.normal(size=(B, H)).astype(np.float32))
        g_atoms = T(rng.normal(size=(A, H)).astype(np.float32))
        # keep every pre-activation 1e-3 away from 0, where relu's
        # derivative would hang on the forward's last rounding
        pre = inp + z_ref @ wh
        inp_g = torch.where(pre.abs() < 1e-3,
                            inp + torch.where(pre >= 0, 2e-3, -2e-3), inp)
        for act in ("relu", "tanh"):
            def grads(layer, readout):
                leaves = [t.clone().requires_grad_(True)
                          for t in (m, wh, inp_g)]
                out = layer(leaves[0], leaves[2], leaves[1], ws, src, srev,
                            rp, act)
                return out, torch.autograd.grad(
                    [out, readout(out)], leaves, [g_out, g_atoms])

            out, got_g = grads(bm.band_rev_layer,
                               lambda x: bm.atom_readout(x, ws, rp, dst))
            _, want_g = grads(bm.band_rev_layer_plain,
                              lambda x: bm.atom_readout_plain(x, ws, rp))
            torch.cuda.synchronize()
            for name, a, b in zip(("dm", "dW_h", "dinp"), got_g, want_g):
                err, tol = (a - b).abs().max().item(), kernel_tolerance(b)
                log(f"[grad] {name} {weights} {act}: max_abs_err {err:.3e} "
                    f"(tol {tol:.3e})")
                check(err <= tol, f"{name} disagrees with autograd through "
                                  "the plain versions")
            # padding rows have z == 0 exactly, so dW_h = z^T g_pre is
            # what the real rows alone give
            g_pre = (g_out + ws[:, None] * g_atoms[dst]) \
                * bm.act_grad_from_output(act, out.detach())
            dwh_real = z[:n_real].t() @ g_pre[:n_real]
            err = (got_g[1] - dwh_real).abs().max().item()
            tol = kernel_tolerance(dwh_real)
            log(f"[grad] dW_h {weights} {act} without padding rows: "
                f"max_abs_err {err:.3e} (tol {tol:.3e})")
            check(err <= tol, "padding rows moved dW_h")

        rev_tc_checks(bm, results, weights, T, rng, aux, B, H)
        if weights == "eaip":
            # rows 4-7 do not run on the polymer benchmark's path
            log(f"[kernel] EA/IP weights {WEIGHT_SETS[weights]} (not "
                "bf16-exact: 0.075, 0.85): max_abs_err row 1 (highest, "
                "high, default) {:.3e}, row 2 {:.3e}, row 3 {:.3e}".format(
                    *(results[k]["by_weights"][weights] for k in REV_ROWS)))
            continue
        if weights == "unit":
            for width in TC_WIDTHS:
                rev_tc_checks(bm, results, weights, T, rng, aux, B, width)
        plain_band_checks(bm, results, weights, T, rng, aux, A, B, H)

        if weights != "unit":
            continue
        # timings and bounds at the bench shape, relu, unit weights
        relu = get_activation("relu")

        def library_layer():
            a = m.new_zeros((A, H)).index_add_(0, dst, m * ws[:, None])
            z = a[src.long()] - m[srev.long()]
            return relu(torch.addmm(inp, z, wh))

        def library_readout():
            return m.new_zeros((A, H)).index_add_(0, dst, m * ws[:, None])

        def library_bwd():
            g_rev = g[srev.long()]
            s = g.new_zeros((A, H)).index_add_(0, dst, g_rev)
            return ws[:, None] * s[dst] - g_rev

        run_len = int((aux.rowptr[aux.src_sorted + 1]
                       - aux.rowptr[aux.src_sorted]).astype(np.int64).sum())
        shape = (B, A, H, n_real, run_len)
        for name, kern, plain, lib in (
                ("band_rev_layer",
                 lambda: bm.band_rev_layer(m, inp, wh, ws, src, srev, rp,
                                           "relu", "high"),
                 lambda: bm.band_rev_layer_plain(m, inp, wh, ws, src, srev,
                                                 rp, "relu", "high"),
                 library_layer),
                ("band_rev_bwd", lambda: bm.band_rev_bwd(g, ws, srev, rp),
                 lambda: bm.band_rev_bwd_plain(g, ws, srev, rp),
                 library_bwd),
                ("atom_readout", lambda: bm.atom_readout(m, ws, rp),
                 lambda: bm.atom_readout_plain(m, ws, rp),
                 library_readout)):
            nbytes, ops, peak = work(name, *shape)
            time_against(results[name], name, kern, plain, lib, nbytes, ops,
                         flush, f"B={B} A={A} H={H}", peak)
        for name in ("atom_readout", "band_rev_bwd"):
            csr_gbps(results[name], name, shape)
        # row 1 at "highest" (the FP32 entry) beside "high", with z written
        # and not, and the yardstick with TF32 on
        from polymer_chemprop_tpu_torch.ops.band_mpnn import (
            float32_matmul_precision,
        )
        r = results["band_rev_layer"]
        layer = lambda p, z: bm.band_rev_layer_forward(
            m, inp, wh, ws, src, srev, rp, "relu", z, p)
        for key, p in (("ms_highest", "highest"), ("ms_default", "default")):
            r[key] = timed_ms(f"band_rev_layer kernel {p}",
                              lambda p=p: layer(p, False), flush)
        for key, p in (("ms_with_z", "high"), ("ms_with_z_highest",
                                               "highest")):
            r[key] = timed_ms(f"band_rev_layer kernel {p} with z",
                              lambda p=p: layer(p, True), flush)
        with float32_matmul_precision("high"):
            r["library_tf32_ms"] = timed_ms("band_rev_layer library TF32",
                                            library_layer, flush)
        r["bound_ms_highest"] = bound(
            *work("band_rev_layer", *shape, "highest")[:2])[0]
        log(f"[time] band_rev_layer at B={B} H={H}: high {r['ms']:.4f} ms "
            f"(bound {r['bound_ms']:.4f}, {r['bound_by']}), default "
            f"{r['ms_default']:.4f} ms, highest "
            f"{r['ms_highest']:.4f} ms (bound {r['bound_ms_highest']:.4f}), "
            f"with z high {r['ms_with_z']:.4f} highest "
            f"{r['ms_with_z_highest']:.4f}, library FP32 "
            f"{r['library_ms']:.4f} TF32 {r['library_tf32_ms']:.4f}")
        plain_band_timings(bm, results, flush, T, rng, aux, A, B, H)
        csr_probe(results, gb)
    train_batch_timings(bm, results, flush, dev)
    gather_checks(bm, results, flush, dev, gb)
    readout_checks(bm, results, flush, dev, gb)
    return results, B, A


def csr_probe(results, gb):
    """The CSR-row probe in-process on the bench batch: the run-length
    histograms (printed by the probe), the four kernels' GB/s and output
    hashes, and a copy of the same bytes and a one-float launch as
    yardsticks, at the bench shape, the training batch's shape and hidden
    1,600 (there without band_rev_bwd)."""
    from polymer_chemprop_tpu_torch.probes import csr_rows_probe
    out = csr_rows_probe.main(["--hidden", str(HIDDEN), "--wide", "1600"],
                              batch=gb)
    for shape, row in out.items():
        log(f"[csr] {shape}: longest run {len(row['hist']) - 1} rows")
        for name in CSR_KERNELS:
            if name not in row:     # band_rev_bwd is not run at hidden 1,600
                continue
            r = results[name]
            r.setdefault("copy_ms", {})[shape] = row[name]["copy"]["ms"]
            r.setdefault("launch_ms", {})[shape] = row[name]["launch"]["ms"]


def rev_tc_checks(bm, results, weights, T, rng, aux, B, H):
    """``band_rev_layer`` on the tensor-core stage at "high" and "default"
    against its plain version at the same precision: relu within the
    kernel tolerance, tanh and selu within the pre-activation's
    (:func:`act_tolerance`); z bit for bit the FP32 entry's; padding rows
    (zero m and inp, as the encoder keeps them) exactly 0; "high" against
    FP64 of the float32 operands within 3e-5 of the largest entry; the
    plain product on the kernel's own z and, at "high", on the plain z
    (see :func:`tc_checks`); at the bench width the Function's gradients
    (FP32 backward) against autograd through the plain version."""
    from polymer_chemprop_tpu_torch.models.nn import get_activation
    n_real = int(aux.rowptr[-1])
    real = np.zeros((B, 1), np.float32)
    real[:n_real] = 1.0
    normal = lambda *shape: rng.normal(size=shape).astype(np.float32)
    m, inp, g = T(normal(B, H) * real), T(normal(B, H) * real), \
        T(normal(B, H))
    wh = T((rng.normal(size=(H, H)) * (1.0 / H) ** 0.5).astype(np.float32))
    idx = (T(aux.w_sorted), T(aux.src_sorted), T(aux.srev), T(aux.rowptr))
    z_ref = bm.band_rev_z_plain(m, *idx)
    exact = bm.band_rev_z_plain(m.double(), idx[0].double(), *idx[1:]) \
        @ wh.double()
    z_f32 = bm.band_rev_layer_forward(m, inp, wh, *idx, "relu", True)[1]

    def hold(what, err, tol):
        log(f"[kernel] {what} {weights} H={H}: max_abs_err {err:.3e} "
            f"(tol {tol:.3e})")
        check(err <= tol, f"{what} disagrees with its plain version")
        note_error(results, "band_rev_layer", err,
                   weights if H == HIDDEN else None)

    for precision in TC_PRECISIONS:
        for act in ("relu", "tanh", "selu"):
            what = f"band_rev_layer {precision} {act}"
            before = bm.tc_launch_counts()["band_rev_layer"]
            out, z = bm.band_rev_layer_forward(m, inp, wh, *idx, act, True,
                                               precision)
            torch.cuda.synchronize()
            check(bm.tc_launch_counts()["band_rev_layer"] == before + 1,
                  f"{what}: not on the tensor cores")
            check(torch.equal(z, z_f32), f"{what}: z is not the FP32 entry's")
            check(n_real == B or (out[n_real:].abs().max().item() == 0.0
                                  and z[n_real:].abs().max().item() == 0.0),
                  f"{what}: padding rows must stay exactly zero")
            refs = [("", inp + bm.band_product(z, wh, precision))]
            if precision == "high":
                refs.append((" (plain z)",
                             inp + bm.band_product(z_ref, wh, precision)))
            for label, pre in refs:
                want = get_activation(act)(pre)
                torch.cuda.synchronize()
                hold(what + label, (out - want).abs().max().item(),
                     kernel_tolerance(want) if act == "relu"
                     else act_tolerance(pre, act))
            out_only, none = bm.band_rev_layer_forward(
                m, inp, wh, *idx, act, False, precision)
            torch.cuda.synchronize()
            check(none is None and torch.equal(out_only, out),
                  f"{what} differs with z off")
            if precision == "high" and act == "relu":
                hold_fp64(results, "band_rev_layer", f"{what} {weights} H={H}",
                          out, torch.relu(inp.double() + exact))
    if H != HIDDEN:
        return

    # the Function at "high": tensor-core forward, FP32 backward;
    # pre-activations kept 1e-3 away from 0 (see kernel_phase)
    pre = inp + z_ref @ wh
    inp_g = torch.where(pre.abs() < 1e-3,
                        inp + torch.where(pre >= 0, 2e-3, -2e-3), inp)
    for act in ("relu", "tanh"):
        def grads(f):
            leaves = [t.clone().requires_grad_(True) for t in (m, wh, inp_g)]
            return torch.autograd.grad(f(*leaves), leaves, g)

        before = bm.tc_launch_counts()
        got_g = grads(lambda x, w, i: bm.band_rev_layer(x, i, w, *idx, act,
                                                        "high"))
        want_g = grads(lambda x, w, i: get_activation(act)(
            i + straight_through(bm.band_rev_z_plain(x, *idx), w, "high",
                                 bm)))
        torch.cuda.synchronize()
        check(bm.tc_launch_counts() != before,
              f"band_rev_layer {act}: no tensor-core launch")
        for name, a, b in zip(("dm", "dW_h", "dinp"), got_g, want_g):
            err, tol = (a - b).abs().max().item(), kernel_tolerance(b)
            log(f"[grad] band_rev_layer {act} high {name} {weights}: "
                f"max_abs_err {err:.3e} (tol {tol:.3e})")
            check(err <= tol, f"band_rev_layer {act} high: {name} disagrees "
                              "with autograd through the plain version")


def hold_fp64(results, name, what, got, want):
    """The split product at "high" against FP64 of the float32 operands:
    within 3e-5 of the largest entry (the dropped lo x lo term is about
    1e-5)."""
    err = ((got.double() - want).abs().max() / want.abs().max()).item()
    log(f"[kernel] {what} against FP64: max_rel_err {err:.3e} (limit 3e-5)")
    check(err <= 3e-5, f"{what}: the split is off against FP64")
    r = results.setdefault(name, {"max_abs_err": 0.0})
    r["max_rel_err_fp64"] = max(r.get("max_rel_err_fp64", 0.0), err)


def note_error(results, name, err, weights=None):
    """The kernel's largest error so far, and with ``weights`` named also
    that weight set's at the bench width."""
    r = results.setdefault(name, {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    if weights is not None:
        by = r.setdefault("by_weights", {})
        by[weights] = max(by.get(weights, 0.0), err)


def plain_band_checks(bm, results, weights, T, rng, aux, A, B, H):
    """The four plain-band kernels and their three Functions against the
    plain versions, on operands that are not zero on padding rows."""
    from polymer_chemprop_tpu_torch.kernels.build import load
    n_real = int(aux.rowptr[-1])
    check(n_real < B, "the bench batch has no padding rows")
    normal = lambda *shape: T(rng.normal(size=shape).astype(np.float32))
    m, inp, g = normal(B, H), normal(B, H), normal(B, H)
    wh = T((rng.normal(size=(H, H)) * (2.0 / (2 * H)) ** 0.5)
           .astype(np.float32))
    ws, rp = T(aux.w_sorted), T(aux.rowptr)

    def hold(name, what, got, ref):
        torch.cuda.synchronize()
        err, tol = (got - ref).abs().max().item(), kernel_tolerance(ref)
        log(f"[kernel] {what} {weights}: max_abs_err {err:.3e} "
            f"(tol {tol:.3e})")
        check(err <= tol, f"{what} disagrees with its plain version")
        note_error(results, name, err)

    z_ref = bm.band_agg_plain(m, ws, rp)
    z = bm.band_agg(m, ws, rp)
    hold("band_agg", "band_agg", z, z_ref)
    check(torch.equal(z[n_real:], -m[n_real:]),
          "z of padding rows must equal -m")
    z_f32 = bm.band_matmul_forward(m, wh, ws, rp, "highest")[1]
    torch.cuda.synchronize()
    check(torch.equal(z, z_f32), "band_agg's z is not band_matmul's FP32 z")
    log(f"[kernel] band_agg {weights}: z equals the FP32 band_matmul z bit "
        f"for bit on all {B} rows")
    dm = bm.band_bwd(g, ws, rp)
    hold("band_bwd", "band_bwd", dm, bm.band_bwd_plain(g, ws, rp))
    check(torch.equal(dm[n_real:], -g[n_real:]),
          "dm of padding rows must equal -g")
    for act in ("relu", "tanh", "selu"):
        out, z = bm.band_matmul_act_forward(m, inp, wh, ws, rp, act,
                                            want_z=True)
        hold("band_matmul_act", f"band_matmul_act {act}", out,
             bm.band_matmul_act_plain(m, inp, wh, ws, rp, act))
        hold("band_matmul_act", f"band_matmul_act {act} z", z, z_ref)
        check(torch.equal(z[n_real:], -m[n_real:]),
              "band_matmul_act's z of padding rows must equal -m")
        out_only, none = bm.band_matmul_act_forward(m, inp, wh, ws, rp, act,
                                                    want_z=False)
        torch.cuda.synchronize()
        check(none is None and torch.equal(out_only, out),
              "band_matmul_act differs with z off")
    out, z = bm.band_matmul_forward(m, wh, ws, rp)
    out_ref, _ = bm.band_matmul_plain(m, wh, ws, rp)
    hold("band_matmul", "band_matmul", out, out_ref)
    hold("band_matmul", "band_matmul z", z, z_ref)
    check(torch.equal(z[n_real:], -m[n_real:]),
          "band_matmul's z of padding rows must equal -m")

    # the three Functions' gradients against autograd through the plain
    # versions; pre-activations kept 1e-3 away from 0 (see above)
    pre = inp + z_ref @ wh
    inp_g = torch.where(pre.abs() < 1e-3,
                        inp + torch.where(pre >= 0, 2e-3, -2e-3), inp)
    cases = [("band_agg", (m,), lambda x: bm.band_agg(x, ws, rp),
              lambda x: bm.band_agg_plain(x, ws, rp)),
             ("band_matmul", (m, wh), lambda x, w: bm.band_matmul(x, w, ws, rp),
              lambda x, w: bm.band_matmul_plain(x, w, ws, rp)[0])]
    for act in ("relu", "tanh"):
        cases.append((
            f"band_matmul_act {act}", (m, wh, inp_g),
            lambda x, w, i, act=act: bm.band_matmul_act(x, i, w, ws, rp, act),
            lambda x, w, i, act=act: bm.band_matmul_act_plain(x, i, w, ws, rp,
                                                              act)))
    for what, operands, fn, plain in cases:
        def grads(f):
            leaves = [t.clone().requires_grad_(True) for t in operands]
            return torch.autograd.grad(f(*leaves), leaves, g)

        got_g, want_g = grads(fn), grads(plain)
        torch.cuda.synchronize()
        for name, a, b in zip(("dm", "dW_h", "dinp"), got_g, want_g):
            err, tol = (a - b).abs().max().item(), kernel_tolerance(b)
            log(f"[grad] {what} {name} {weights}: max_abs_err {err:.3e} "
                f"(tol {tol:.3e})")
            check(err <= tol, f"{what}: {name} disagrees with autograd "
                              "through the plain version")

    tc_checks(bm, results, weights, T, rng, aux, B, H)
    if weights != "unit":
        return
    for width in TC_WIDTHS:
        tc_checks(bm, results, weights, T, rng, aux, B, width)
    # the two unfused kernels once at a width the fused ones cannot take
    wide = 1600
    mw, gw = normal(B, wide), normal(B, wide)
    hold("band_agg", f"band_agg H={wide}", bm.band_agg(mw, ws, rp),
         bm.band_agg_plain(mw, ws, rp))
    hold("band_bwd", f"band_bwd H={wide}", bm.band_bwd(gw, ws, rp),
         bm.band_bwd_plain(gw, ws, rp))
    # the layer form is chosen in Python from the shape alone: that
    # arithmetic must be the FP32 stage's (band_tile.cuh); the tensor-core
    # stage (band_tile_sm90.cuh) takes a fixed budget at every width and a
    # W_h scratch that grows with it
    lib = load("band_matmul")
    check(lib.band_matmul_tc_smem_bytes() == bm.TC_SMEM_BYTES
          <= bm.SMEM_PER_BLOCK,
          f"tensor-core stage: the library says "
          f"{lib.band_matmul_tc_smem_bytes()} bytes, Python "
          f"{bm.TC_SMEM_BYTES}")
    for width in (32, 37, 300, 1495, 1496, wide, 2400):
        want = bm.fused_layer_smem_bytes(width)
        got = (load("band_rev_layer").band_rev_layer_smem_bytes(width),
               lib.band_matmul_smem_bytes(width))
        check(got == (want, want), f"shared memory at H={width}: the "
              f"libraries say {got}, Python says {want}")
        check(bm.fused_layer_fits(width) == (got[0] <= 227 * 1024),
              f"fused_layer_fits({width})")
        check(lib.band_matmul_tc_scratch_bytes(width)
              == bm.tc_scratch_bytes(width), f"W_h scratch at H={width}")
    log(f"[kernel] shared-memory arithmetic agrees with the libraries; the "
        f"fused kernels fit up to H=1495, H={wide} takes band_agg; the "
        f"tensor-core stage takes {bm.TC_SMEM_BYTES} bytes at every width")


def tc_checks(bm, results, weights, T, rng, aux, B, H):
    """``band_matmul_act`` and ``band_matmul`` on the tensor-core stage at
    "high" and "default" against their plain versions at the same
    precision: the product (``band_matmul``, ``relu``) within the kernel
    tolerance, ``tanh`` and ``selu`` within the pre-activation's
    (:func:`act_tolerance`); z bit for bit the FP32 stage's, ``-m`` on
    padding rows; "high" against FP64 of the float32 operands within 3e-5
    of the largest entry; at the bench width the Functions' gradients
    (FP32 backward) against autograd through the plain versions.

    The plain product is taken on the kernel's own z (the FP32 stage's,
    bit for bit), and at "high" also on the plain z: "default" rounds z
    to bfloat16 once, so where the two float32 sums of a z entry differ
    in the last place across a rounding boundary, z_hi moves by a whole
    bfloat16 step (2^-8 of it) and with it the product; "high" carries
    that remainder in z_lo."""
    n_real = int(aux.rowptr[-1])
    normal = lambda *shape: T(rng.normal(size=shape).astype(np.float32))
    m, inp, g = normal(B, H), normal(B, H), normal(B, H)
    wh = T((rng.normal(size=(H, H)) * (1.0 / H) ** 0.5).astype(np.float32))
    ws, rp = T(aux.w_sorted), T(aux.rowptr)
    z_ref = bm.band_agg_plain(m, ws, rp)
    exact = bm.band_agg_plain(m.double(), ws.double(), rp) @ wh.double()

    def hold(name, what, err, tol):
        log(f"[kernel] {what} {weights} H={H}: max_abs_err {err:.3e} "
            f"(tol {tol:.3e})")
        check(err <= tol, f"{what} disagrees with its plain version")
        note_error(results, name, err)

    def fp64(name, what, got, want):
        hold_fp64(results, name, f"{what} {weights} H={H}", got, want)

    def hold_z(what, z):
        torch.cuda.synchronize()
        z_f32 = bm.band_matmul_forward(m, wh, ws, rp)[1]
        torch.cuda.synchronize()
        check(torch.equal(z, z_f32), f"{what}: z is not the FP32 stage's")
        check(torch.equal(z[n_real:], -m[n_real:]),
              f"{what}: z of padding rows must equal -m")

    from polymer_chemprop_tpu_torch.models.nn import get_activation
    for precision in TC_PRECISIONS:
        for act in ("relu", "tanh", "selu"):
            what = f"band_matmul_act {precision} {act}"
            out, z = bm.band_matmul_act_forward(m, inp, wh, ws, rp, act,
                                                True, precision)
            hold_z(what, z)
            refs = [("", inp + bm.band_product(z, wh, precision))]
            if precision == "high":
                refs.append((" (plain z)",
                             inp + bm.band_product(z_ref, wh, precision)))
            for label, pre in refs:
                want = get_activation(act)(pre)
                torch.cuda.synchronize()
                err = (out - want).abs().max().item()
                hold("band_matmul_act", what + label, err,
                     kernel_tolerance(want) if act == "relu"
                     else act_tolerance(pre, act))
            out_only, none = bm.band_matmul_act_forward(
                m, inp, wh, ws, rp, act, False, precision)
            torch.cuda.synchronize()
            check(none is None and torch.equal(out_only, out),
                  f"{what} differs with z off")
            if precision == "high" and act == "relu":
                fp64("band_matmul_act", what, out,
                     torch.relu(inp.double() + exact))
        what = f"band_matmul {precision}"
        out, z = bm.band_matmul_forward(m, wh, ws, rp, precision)
        hold_z(what, z)
        wants = [("", bm.band_product(z, wh, precision))]
        if precision == "high":
            wants.append((" (plain z)",
                          bm.band_matmul_plain(m, wh, ws, rp, precision)[0]))
        for label, want in wants:
            torch.cuda.synchronize()
            hold("band_matmul", what + label, (out - want).abs().max().item(),
                 kernel_tolerance(want))
        if precision == "high":
            fp64("band_matmul", what, out, exact)
    if H != HIDDEN:
        return

    # the Functions at "high": tensor-core forward, FP32 backward
    pre = inp + z_ref @ wh
    inp_g = torch.where(pre.abs() < 1e-3,
                        inp + torch.where(pre >= 0, 2e-3, -2e-3), inp)
    cases = [("band_matmul", (m, wh),
              lambda x, w: bm.band_matmul(x, w, ws, rp, "high"),
              lambda x, w: straight_through(bm.band_agg_plain(x, ws, rp), w,
                                            "high", bm))]
    for act in ("relu", "tanh"):
        cases.append((
            f"band_matmul_act {act}", (m, wh, inp_g),
            lambda x, w, i, act=act: bm.band_matmul_act(x, i, w, ws, rp, act,
                                                        "high"),
            lambda x, w, i, act=act: get_activation(act)(i + straight_through(
                bm.band_agg_plain(x, ws, rp), w, "high", bm))))
    for what, operands, fn, plain in cases:
        def grads(f):
            leaves = [t.clone().requires_grad_(True) for t in operands]
            return torch.autograd.grad(f(*leaves), leaves, g)

        before = bm.tc_launch_counts()
        got_g, want_g = grads(fn), grads(plain)
        torch.cuda.synchronize()
        check(bm.tc_launch_counts() != before, f"{what}: no tensor-core launch")
        for name, a, b in zip(("dm", "dW_h", "dinp"), got_g, want_g):
            err, tol = (a - b).abs().max().item(), kernel_tolerance(b)
            log(f"[grad] {what} high {name} {weights}: max_abs_err {err:.3e} "
                f"(tol {tol:.3e})")
            check(err <= tol, f"{what} high: {name} disagrees with autograd "
                              "through the plain version")


def plain_band_timings(bm, results, flush, T, rng, aux, A, B, H):
    """Times and bounds of the four plain-band kernels at the bench shape,
    relu, unit weights."""
    n_real = int(aux.rowptr[-1])
    normal = lambda *shape: T(rng.normal(size=shape).astype(np.float32))
    m, inp, g = normal(B, H), normal(B, H), normal(B, H)
    wh = T((rng.normal(size=(H, H)) * (2.0 / (2 * H)) ** 0.5)
           .astype(np.float32))
    ws, rp = T(aux.w_sorted), T(aux.rowptr)
    dst = T(aux.dst_sorted.astype(np.int64))

    def library_agg():
        a = m.new_zeros((A, H)).index_add_(0, dst, m * ws[:, None])
        return a[dst] - m

    def library_bwd():
        s = g.new_zeros((A, H)).index_add_(0, dst, g)
        return ws[:, None] * s[dst] - g

    shape = (B, A, H, n_real)
    for name, kern, plain, lib in (
            ("band_agg", lambda: bm.band_agg(m, ws, rp),
             lambda: bm.band_agg_plain(m, ws, rp), library_agg),
            ("band_bwd", lambda: bm.band_bwd(g, ws, rp),
             lambda: bm.band_bwd_plain(g, ws, rp), library_bwd),
            ("band_matmul_act",
             lambda: bm.band_matmul_act(m, inp, wh, ws, rp, "relu", "high"),
             lambda: bm.band_matmul_act_plain(m, inp, wh, ws, rp, "relu",
                                              "high"),
             lambda: torch.relu(torch.addmm(inp, library_agg(), wh))),
            ("band_matmul",
             lambda: bm.band_matmul_forward(m, wh, ws, rp, "high"),
             lambda: bm.band_matmul_plain(m, wh, ws, rp, "high"),
             lambda: torch.mm(library_agg(), wh))):
        nbytes, ops, peak = work(name, *shape)
        time_against(results[name], name, kern, plain, lib, nbytes, ops,
                     flush, f"B={B} A={A} H={H}", peak)
    for name in ("band_agg", "band_bwd"):
        csr_gbps(results[name], name, shape)
    # rows 4 and 7 at "highest" (the FP32 stage) beside "high", with z
    # written and not, and the yardstick with TF32 on
    from polymer_chemprop_tpu_torch.ops.band_mpnn import (
        float32_matmul_precision,
    )
    fused = {
        "band_matmul_act": (
            lambda p, z: bm.band_matmul_act_forward(m, inp, wh, ws, rp,
                                                    "relu", z, p),
            lambda: torch.relu(torch.addmm(inp, library_agg(), wh))),
        "band_matmul": (
            lambda p, z: bm.band_matmul_forward(m, wh, ws, rp, p),
            lambda: torch.mm(library_agg(), wh))}
    for name, (fn, lib) in fused.items():
        r = results[name]
        for key, p in (("ms_highest", "highest"), ("ms_default", "default")):
            r[key] = timed_ms(f"{name} kernel {p}",
                              lambda p=p: fn(p, False), flush)
        if name == "band_matmul_act":
            for key, p in (("ms_with_z", "high"),
                           ("ms_with_z_highest", "highest")):
                r[key] = timed_ms(f"{name} kernel {p} with z",
                                  lambda p=p: fn(p, True), flush)
        with float32_matmul_precision("high"):
            r["library_tf32_ms"] = timed_ms(f"{name} library TF32", lib,
                                            flush)
        nbytes, ops, _ = work(name, *shape, 0, "highest")
        r["bound_ms_highest"] = bound(nbytes, ops)[0]
        log(f"[time] {name} at B={B} H={H}: high {r['ms']:.4f} ms (bound "
            f"{r['bound_ms']:.4f}, {r['bound_by']}), default "
            f"{r['ms_default']:.4f} ms, highest "
            f"{r['ms_highest']:.4f} ms (bound {r['bound_ms_highest']:.4f}), "
            + (f"with z high {r['ms_with_z']:.4f} highest "
               f"{r['ms_with_z_highest']:.4f}, "
               if name == "band_matmul_act" else "")
            + f"library FP32 {r['library_ms']:.4f} TF32 "
            f"{r['library_tf32_ms']:.4f}")
    wide = 1600
    mw = normal(B, wide)
    for name, fn in (("atom_readout", bm.atom_readout),
                     ("band_agg", bm.band_agg), ("band_bwd", bm.band_bwd)):
        r = results[name]
        r["ms_h1600"] = timed_ms(f"{name} kernel H={wide}",
                                 lambda: fn(mw, ws, rp), flush)
        nbytes = work(name, B, A, wide, n_real)[0]
        r["bound_ms_h1600"] = bound(nbytes, 0)[0]
        r["gbps_h1600"] = gbps(nbytes, r["ms_h1600"])
        log(f"[time] {name} at B={B} H={wide}: kernel_ms "
            f"{r['ms_h1600']:.4f} bound_ms {r['bound_ms_h1600']:.4f} (bytes), "
            f"{r['gbps_h1600']:.1f} GB/s")


def train_batch_timings(bm, results, flush, dev):
    """All seven kernels once more at the shape a training step gives them
    (the three W_h-fused ones at "high" and "highest"), each with its bound
    from this batch: the first batch of 50 molecules of regression.csv as
    the trainer's loader pads it."""
    from polymer_chemprop_tpu_torch.probes.csr_rows_probe import (
        training_graph,
    )
    graph = training_graph(dev)
    aux = graph["sorted_aux"]
    B, A, H = graph["f_bonds"].shape[0], graph["f_atoms"].shape[0], HIDDEN
    gen = torch.Generator(dev).manual_seed(SEED)
    m, inp, g = (torch.randn((B, H), device=dev, generator=gen)
                 for _ in range(3))
    wh = torch.randn((H, H), device=dev, generator=gen) * (1.0 / H) ** 0.5
    ws, src, srev, rp = (aux["w_sorted"], aux["src_sorted"], aux["srev"],
                         aux["rowptr"])
    n_real = int(rp[-1])
    src_l = src.long()
    run_len = int((rp[src_l + 1] - rp[src_l]).sum())
    shape = (B, A, H, n_real, run_len)
    for name, key, fn in (
            ("band_rev_layer", "ms_train_batch",
             lambda: bm.band_rev_layer(m, inp, wh, ws, src, srev, rp, "relu",
                                       "high")),
            ("band_rev_layer", "ms_train_batch_highest",
             lambda: bm.band_rev_layer(m, inp, wh, ws, src, srev, rp, "relu")),
            ("band_rev_bwd", "ms_train_batch",
             lambda: bm.band_rev_bwd(g, ws, srev, rp)),
            ("atom_readout", "ms_train_batch",
             lambda: bm.atom_readout(m, ws, rp)),
            ("band_agg", "ms_train_batch", lambda: bm.band_agg(m, ws, rp)),
            ("band_bwd", "ms_train_batch", lambda: bm.band_bwd(g, ws, rp)),
            ("band_matmul_act", "ms_train_batch",
             lambda: bm.band_matmul_act(m, inp, wh, ws, rp, "relu", "high")),
            ("band_matmul_act", "ms_train_batch_highest",
             lambda: bm.band_matmul_act(m, inp, wh, ws, rp, "relu")),
            ("band_matmul", "ms_train_batch",
             lambda: bm.band_matmul_forward(m, wh, ws, rp, "high")),
            ("band_matmul", "ms_train_batch_highest",
             lambda: bm.band_matmul_forward(m, wh, ws, rp))):
        r = results[name]
        kernel_ms(r, f"{name} at B={B}", fn, flush, key=key)
        precision = "highest" if key.endswith("highest") else "high"
        nbytes, ops, peak = work(name, *shape, precision)
        bound_key = "bound_" + key
        r[bound_key] = bound(nbytes, ops, peak)[0]
        line = (f"[time] {name} at the training batch's shape B={B} A={A} "
                f"H={H} ({key}): kernel_ms {r[key]:.4f} (from an idle "
                f"stream {r[key + '_idle_start']:.4f}) bound_ms "
                f"{r[bound_key]:.4f}")
        if name in CSR_KERNELS:
            r["gbps_train_batch"] = gbps(nbytes, r[key])
            line += f", {r['gbps_train_batch']:.1f} GB/s"
        log(line)


def gather_plain(bm, name, h, w, aux):
    """The plain version of op ``name`` (``w`` is the readout's weights)."""
    if name == "atom_neighbor_sum":
        return bm.atom_neighbor_sum_plain(h, aux["src_sorted"], aux["rowptr"])
    return bm.src_readout_plain(h, w, aux["src_sorted"], aux["rowptr"])


def gather_checks(bm, results, flush, dev, gb):
    """The atom_messages ops on the gather entry of atom_readout.cu at the
    bench shape (unit and polymer weights), the first training batch's
    shape, and hidden 37 and 1,600: against their plain versions, their
    VJPs against autograd through the plain versions (the readout's with
    w[srev]; polymer weights differ from their reverses'), and against the
    composed form ``atom_readout(h[src_sorted], w)`` bit for bit. Then the
    times at the bench shape (kernel, plain version, composed form and the
    ``index_add_`` yardstick), at the training batch and at hidden 1,600,
    each beside its bound, cold and warm."""
    from polymer_chemprop_tpu_torch.models.encoder import batch_to_tensors
    from polymer_chemprop_tpu_torch.probes.csr_rows_probe import (
        training_graph,
    )
    bench = batch_to_tensors(gb.arrays(sorted_aux=True), dev)["sorted_aux"]
    gen = torch.Generator(dev).manual_seed(SEED)
    real = bench["w_sorted"] > 0
    choice = torch.tensor([0.25, 0.5, 0.75], device=dev)[torch.randint(
        0, 3, real.shape, device=dev, generator=gen)]
    polymer = dict(bench, w_sorted=torch.where(real, choice, 0.0))
    srev = polymer["srev"].long()
    check(not torch.equal(polymer["w_sorted"], polymer["w_sorted"][srev]),
          "the polymer weights must differ from their reverses'")
    train = training_graph(dev)["sorted_aux"]
    cases = [("bench", bench, HIDDEN), ("bench polymer", polymer, HIDDEN),
             ("training batch", train, HIDDEN)]
    cases += [(f"bench H={w}", bench, w) for w in GATHER_WIDTHS]
    tables = {}
    for label, aux, H in cases:
        src, rp = aux["src_sorted"], aux["rowptr"]
        A, B = rp.shape[0] - 1, src.shape[0]
        h, g = (torch.randn((A, H), device=dev, generator=gen)
                for _ in range(2))
        tables[label] = h
        for name, wrapper_name in GATHER_OPS.items():
            wrapper = getattr(bm, wrapper_name)
            w = (torch.ones_like(aux["w_sorted"])
                 if name == "atom_neighbor_sum" else aux["w_sorted"])
            got = wrapper(h, aux)
            plain = gather_plain(bm, name, h, w, aux)
            composed = bm.atom_readout(h.index_select(0, src.long()), w, rp)
            x, y = (h.clone().requires_grad_(True) for _ in range(2))
            dh = torch.autograd.grad(wrapper(x, aux), x, g)[0]
            dh_plain = torch.autograd.grad(
                gather_plain(bm, name, y, w, aux), y, g)[0]
            torch.cuda.synchronize()
            for what, a, b in (("out", got, plain), ("dh", dh, dh_plain)):
                err, tol = (a - b).abs().max().item(), kernel_tolerance(b)
                log(f"[kernel] {name} {label} A={A} B={B} H={H} {what}: "
                    f"max_abs_err {err:.3e} (tol {min(tol, 1e-5):.3e})")
                check(err <= min(tol, 1e-5),
                      f"{name} {what} disagrees with its plain version")
                note_error(results, name, err)
            check(torch.equal(got, composed),
                  f"{name} is not the composed gather + readout bit for bit")
            check(bool((got[0] == 0).all()), "atom 0 must read exactly 0")
            log(f"[kernel] {name} {label}: equals atom_readout(h[src]) bit "
                "for bit; atom 0 reads exactly 0")

    # times: the bench shape (unit weights), the training batch, hidden 1,600
    for label, key in (("bench", "ms"), ("training batch", "ms_train_batch"),
                       (f"bench H={GATHER_WIDTHS[-1]}", "ms_h1600")):
        aux = train if label == "training batch" else bench
        h = tables[label]
        src, rp = aux["src_sorted"], aux["rowptr"]
        A, H, B = h.shape[0], h.shape[1], src.shape[0]
        n_real = int(rp[-1])
        src_l, dst = src.long(), aux["dst_sorted"].long()
        for name, wrapper_name in GATHER_OPS.items():
            r = results[name]
            wrapper = getattr(bm, wrapper_name)
            nbytes, ops, peak = work(name, B, A, H, n_real)
            kernel_ms(r, f"{name} {label}", lambda: wrapper(h, aux), flush,
                      key=key)
            r[key + "_warm"] = warm_ms(f"{name} {label}",
                                       lambda: wrapper(h, aux), WARM_CALLS,
                                       dev)
            bound_key, gbps_key = "bound_" + key, "gbps" + key[2:]
            r[bound_key], by = bound(nbytes, ops, peak)
            r[gbps_key] = gbps(nbytes, r[key])
            line = (f"[time] {name} at {label} B={B} A={A} H={H}: kernel_ms "
                    f"{r[key]:.4f} (from an idle stream "
                    f"{r[key + '_idle_start']:.4f}, warm "
                    f"{r[key + '_warm']:.4f}) bound_ms "
                    f"{r[bound_key]:.4f}, {r[gbps_key]:.1f} GB/s")
            if key == "ms":
                w = (torch.ones_like(aux["w_sorted"])
                     if name == "atom_neighbor_sum" else aux["w_sorted"])
                r["bound_by"] = by
                r["plain_ms"] = timed_ms(
                    f"{name} plain", lambda: gather_plain(bm, name, h, w, aux),
                    flush)
                r["composed_ms"] = timed_ms(
                    f"{name} composed", lambda: bm.atom_readout(
                        h.index_select(0, src_l), w, rp), flush)
                if name == "atom_neighbor_sum":
                    lib = lambda: h.new_zeros((A, H)).index_add_(
                        0, dst, h[src_l])
                else:
                    lib = lambda: h.new_zeros((A, H)).index_add_(
                        0, dst, h[src_l] * w[:, None])
                r["library_ms"] = timed_ms(f"{name} library", lib, flush)
                line += (f"; plain_ms {r['plain_ms']:.4f} composed_ms "
                         f"{r['composed_ms']:.4f} library_ms "
                         f"{r['library_ms']:.4f} ({r['bound_by']}: {nbytes} "
                         f"bytes, {ops} operations)")
            log(line)


def readout_checks(bm, results, flush, dev, gb):
    """The two sums the single-device encoder adds on row 3's entries: the
    one-launch molecule readout (``molecule_readout_sorted`` on
    ``molecule_readout_f32``, its own entry of the ``kernels`` line) over
    the molecule CSR of the bench batch (A = 13,696 atoms into M = 1,024
    molecules) at hidden 300, 37 and 1,600, and of the first training
    batch (768 into 50) at hidden 300, at unit and polymer atom weights,
    for each aggregation: against its plain version (ops/segment.py
    ``molecule_readout``: ``index_add_``) within the kernel tolerance,
    output and VJP; output and VJP bit for bit the composition it replaced
    (probes/readout_probe.py ``composed_readout``); its sum
    (``molecule_sum``, the gather entry with the weight index) bit for bit
    the composed ``atom_readout(h[idx], w[idx])`` (the same ``fmaf``
    chain). Times at the bench and training batches: the kernel alone and
    the whole op, cold and warm, beside their bound, the composition, the
    plain version and one ``index_add_`` of the weighted rows. Then
    ``atom_messages``' ``f_sum`` (row 3 at unit weights over the
    dst-sorted bond features, at their width), which sums 0/1 features
    and so equals its plain version bit for bit."""
    from polymer_chemprop_tpu_torch.models.encoder import batch_to_tensors
    from polymer_chemprop_tpu_torch.ops import segment
    from polymer_chemprop_tpu_torch.probes.csr_rows_probe import (
        training_graph,
    )
    t = batch_to_tensors(gb.arrays(sorted_aux=True), dev)
    train = training_graph(dev)
    gen = torch.Generator(dev).manual_seed(SEED)
    cases = [("bench", t, HIDDEN), ("training batch", train, HIDDEN)]
    cases += [(f"bench H={w}", t, w) for w in GATHER_WIDTHS]
    for label, graph, H in cases:
        aux, a2mol, dop = (graph["sorted_aux"], graph["a2mol"],
                           graph["degree_of_polym"])
        A, M = a2mol.shape[0], dop.shape[0]
        idx, rp = aux["mol_idx"], aux["mol_rowptr"]
        real = graph["w_atoms"] > 0
        polymer_w = torch.where(real, torch.tensor(
            [0.25, 0.5, 0.75], device=dev)[torch.randint(
                0, 3, real.shape, device=dev, generator=gen)], 0.0)
        h = torch.randn((A, H), device=dev, generator=gen)
        g = torch.randn((M, H), device=dev, generator=gen)
        for weights, w in (("unit", graph["w_atoms"]), ("polymer", polymer_w)):
            denom = torch.zeros(M, device=dev)
            denom.index_add_(0, a2mol, w)
            mol_aux = dict(aux, mol_denom=denom)
            for agg in ("mean", "sum", "norm"):
                x, y = (h.clone().requires_grad_(True) for _ in range(2))
                got = bm.molecule_readout_sorted(x, w, a2mol, mol_aux, dop,
                                                 agg)
                plain = segment.molecule_readout(y, w, a2mol, M, dop, agg)
                dh = torch.autograd.grad(got, x, g)[0]
                dh_plain = torch.autograd.grad(plain, y, g)[0]
                want, dh_want = composed_readout(h, w, a2mol, mol_aux, dop,
                                                 agg, g)
                torch.cuda.synchronize()
                for what, a, b in (("out", got, plain), ("dh", dh, dh_plain)):
                    err, tol = (a - b).abs().max().item(), kernel_tolerance(b)
                    check(err <= tol, f"molecule readout {label} {weights} "
                                      f"{agg} {what} disagrees with its "
                                      "plain version")
                    if what == "out":
                        note_error(results, "molecule_readout", err)
                check(torch.equal(got, want) and torch.equal(dh, dh_want),
                      f"molecule readout {label} {weights} {agg}: output or "
                      "VJP differs from the composition it replaced")
                log(f"[kernel] molecule readout {label} {weights} weights "
                    f"{agg} A={A} M={M} H={H}: max_abs_err out "
                    f"{(got - plain).abs().max().item():.3e}, dh "
                    f"{(dh - dh_plain).abs().max().item():.3e}; output and "
                    "VJP equal the composition bit for bit")
            wi = w[idx.long()]
            check(torch.equal(bm.molecule_sum(h, w, a2mol, idx, rp),
                              bm.atom_readout(h.index_select(0, idx.long()),
                                              wi, rp)),
                  "the molecule sum is not atom_readout(h[idx], w[idx])")
        log(f"[kernel] molecule readout {label}: the sum equals "
            "atom_readout(h[idx], w[idx]) bit for bit at both weights")
        if H != HIDDEN:
            continue
        # times: the kernel alone (one launch, mean), the whole op, the
        # composition it replaced (and its gather alone), its plain version
        # and one index_add_ of the weighted rows; cold and warm
        r = results["molecule_readout"]
        w, denom = graph["w_atoms"], aux["mol_denom"]
        wi = w[idx.long()].contiguous()
        key = "" if label == "bench" else "_train_batch"
        nbytes, ops, peak = work("molecule_readout", aux["src_sorted"]
                                 .shape[0], A, H, int(rp[-1]), mols=M)
        r["bound_ms" + key], by = bound(nbytes, ops, peak)
        if not key:
            r["bound_by"] = by
        timed = {
            "ms": lambda: bm._molecule_readout_launch(h, w, idx, rp, denom,
                                                      dop),
            "op_ms": lambda: bm.molecule_readout_sorted(h, w, a2mol, aux,
                                                        dop),
            "composed_ms": lambda: bm.aggregate_molecules(
                bm.csr_gather_sum(h, idx, w[idx.long()].contiguous(), rp),
                denom, dop),
            "gather_ms": lambda: bm.csr_gather_sum(h, idx, wi, rp),
            "plain_ms": lambda: segment.molecule_readout(h, w, a2mol, M,
                                                         dop),
            "library_ms": lambda: h.new_zeros((M, H)).index_add_(
                0, a2mol, h * w[:, None])}
        for name, fn in timed.items():
            r[name + key] = timed_ms(f"molecule_readout {name} {label}", fn,
                                     flush)
            r[name + key + "_warm"] = warm_ms(
                f"molecule_readout {name} {label}", fn, WARM_CALLS, dev)
        log(f"[time] molecule readout {label} A={A} M={M} H={H} (cold, warm "
            f"ms): kernel alone {r['ms' + key]:.4f}, "
            f"{r['ms' + key + '_warm']:.4f}; whole op "
            f"{r['op_ms' + key]:.4f}, {r['op_ms' + key + '_warm']:.4f}; "
            f"bound_ms {r['bound_ms' + key]:.4f} ({by}: {nbytes} bytes, "
            f"{ops} operations); the composition it replaced "
            f"{r['composed_ms' + key]:.4f}, "
            f"{r['composed_ms' + key + '_warm']:.4f} (its gather alone "
            f"{r['gather_ms' + key]:.4f}, "
            f"{r['gather_ms' + key + '_warm']:.4f}); plain (two index_add_) "
            f"{r['plain_ms' + key]:.4f}, {r['plain_ms' + key + '_warm']:.4f};"
            f" one index_add_ of h w {r['library_ms' + key]:.4f}, "
            f"{r['library_ms' + key + '_warm']:.4f}")

    # the bond features without the source atom's, as the encoder reads
    aux, A = t["sorted_aux"], t["a2mol"].shape[0]
    f_bonds = t["f_bonds"][:, t["f_atoms"].shape[1]:].contiguous()
    ones = torch.ones_like(aux["w_sorted"])
    got = bm.atom_readout(f_bonds, ones, aux["rowptr"])
    plain = bm.atom_readout_plain(f_bonds, ones, aux["rowptr"])
    torch.cuda.synchronize()
    check(torch.equal(got, plain) and got.abs().max() > 0,
          "f_sum differs from its plain version")
    log(f"[kernel] atom_messages f_sum (atom_readout, unit weights) B="
        f"{f_bonds.shape[0]} A={A} H={f_bonds.shape[1]}: equal to its plain "
        f"version bit for bit (sums of 0/1 features)")


# -- phase 3 ----------------------------------------------------------------

def write_checkpoint(path, polymer: bool, hidden: int = HIDDEN,
                     features_size: int = 0, descriptors_size: int = 0,
                     atom_extra: int = 0, bond_extra: int = 0,
                     scalers=None, copy_seed=None, **options):
    """A full-width checkpoint in the JAX package's .ckpt format, from
    seeded numpy weights (Xavier-normal, as the JAX init draws them).
    ``options`` are further TrainConfig fields (``param_dtype``,
    ``atom_messages``, the extra inputs, ``number_of_molecules``). The
    extra widths: molecule features (the FFN's input), atom descriptors
    (W_d and the FFN's input), extra atom and bond features (W_i, W_h,
    W_o); ``features_only`` leaves the encoder out. The encoder is listed
    once per molecule position; with ``copy_seed`` the copies after the
    first are drawn from that seed, as the copies of a shared encoder differ
    in a file the JAX package trained. ``scalers`` are saved beside the
    target scaler."""
    from polymer_chemprop_tpu_torch.config import TrainConfig
    from polymer_chemprop_tpu_torch.data import StandardScaler
    from polymer_chemprop_tpu_torch.features import FeaturizationConfig
    from polymer_chemprop_tpu_torch.utils.checkpoint import save_checkpoint

    rng = np.random.default_rng(SEED + (1 if polymer else 0))

    def linear(i, o, bias=True, gen=rng):
        p = {"w": (gen.normal(size=(i, o)) * (2.0 / (i + o)) ** 0.5)
             .astype(np.float32)}
        if bias:
            p["b"] = (gen.normal(size=(o,)) * 0.01).astype(np.float32)
        return p

    fc = FeaturizationConfig(polymer=polymer, extra_atom_fdim=atom_extra,
                             extra_bond_fdim=bond_extra)
    H, D = hidden, descriptors_size
    # atom_messages: W_i on the atom features, W_h on the messages and the
    # bond features
    am = options.get("atom_messages", False)

    def encoder(gen=rng):
        enc = {"W_i": linear(fc.atom_fdim if am else fc.bond_fdim(), H,
                             bias=False, gen=gen),
               "W_h": linear(H + (fc.bond_fdim(True) if am else 0), H,
                             bias=False, gen=gen),
               "W_o": linear(fc.atom_fdim + H, H, gen=gen)}
        if D:
            enc["W_d"] = linear(H + D, H + D, gen=gen)
        return enc

    n_mols = options.get("number_of_molecules", 1)
    copies = [encoder()] * n_mols
    if copy_seed is not None:
        other = np.random.default_rng(copy_seed)
        copies[1:] = [encoder(other) for _ in range(n_mols - 1)]
    if options.get("features_only"):
        params = {"ffn": [linear(features_size, H), linear(H, 1)]}
    else:
        params = {"encoders": copies,
                  "ffn": [linear(H * n_mols + features_size + D, H),
                          linear(H, 1)]}
    tcfg = TrainConfig(hidden_size=H, depth=DEPTH, ffn_num_layers=2,
                       ffn_hidden_size=H, polymer=polymer,
                       target_columns=["target"], seed=SEED, **options)
    scaler = StandardScaler(np.array([0.0]), np.array([2.0]))
    save_checkpoint(path, params, tcfg.to_dict(),
                    scalers=dict(scalers or {}, data_scaler=scaler))


def polymer_csv(path, with_target: bool = False):
    """The N_POLYMERS synthetic copolymers (``probes/bench_batch.py``
    ``copolymer_csv``, seed SEED); ``with_target`` adds a column to train
    on."""
    copolymer_csv(path, N_POLYMERS, SEED, with_target)


def main_path(card):
    from polymer_chemprop_tpu_torch.config import PredictConfig
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    from polymer_chemprop_tpu_torch.train.make_predictions import (
        make_predictions,
    )
    os.makedirs(OUT_DIR, exist_ok=True)
    jobs = []   # (name, CSV, checkpoint, molecules a row)
    reg_ckpt = os.path.join(OUT_DIR, "regression", "model.ckpt")
    write_checkpoint(reg_ckpt, polymer=False)
    jobs.append(("regression", os.path.join(ROOT, "tests", "data",
                                            "regression.csv"), reg_ckpt, 1))
    poly_ckpt = os.path.join(OUT_DIR, "polymer", "model.ckpt")
    write_checkpoint(poly_ckpt, polymer=True)
    poly_csv = os.path.join(OUT_DIR, "polymers.csv")
    polymer_csv(poly_csv)
    jobs.append(("polymer", poly_csv, poly_ckpt, 1))

    # the regression checkpoint once more at band_precision "highest" (the
    # rev layer's FP32 entry), on its first molecules
    hi_ckpt = os.path.join(OUT_DIR, "regression_highest", "model.ckpt")
    write_checkpoint(hi_ckpt, polymer=False, band_precision="highest")
    hi_csv = os.path.join(OUT_DIR, "regression_highest.csv")
    smiles = read_smiles(jobs[0][1])[:HIGHEST_MOLECULES]
    with open(hi_csv, "w") as f:
        f.write("smiles\n" + "\n".join(smiles) + "\n")
    jobs.append(("regression_highest", hi_csv, hi_ckpt, 1))

    # a two-molecule mpn_shared file whose second encoder copy differs, as
    # one the JAX package trained leaves it: served one encoder a position.
    # Its copy-0 twin (copy 0 at both positions, the same FFN) is the model
    # a single shared encoder would serve from it.
    shared_ckpt = os.path.join(OUT_DIR, "mpn_shared", "model.ckpt")
    copy0_ckpt = os.path.join(OUT_DIR, "mpn_shared_copy0", "model.ckpt")
    for path, seed in ((shared_ckpt, SEED + 2), (copy0_ckpt, None)):
        write_checkpoint(path, polymer=False, copy_seed=seed,
                         number_of_molecules=2, mpn_shared=True)
    pairs_csv = os.path.join(OUT_DIR, "pairs.csv")
    pairs = smiles[:BATCH_SIZE]          # one batch: a few seconds on the CPU
    with open(pairs_csv, "w") as f:
        f.write("solvent,solute\n" + "".join(
            f"{a},{b}\n" for a, b in zip(pairs, pairs[::-1])))
    jobs.append(("mpn_shared", pairs_csv, shared_ckpt, 2))

    from polymer_chemprop_tpu_torch.data import empty_cache
    launches = dict.fromkeys(bm.launch_counts(), 0)
    tc_launches = dict.fromkeys(bm.tc_launch_counts(), 0)
    for name, test_path, ckpt, molecules in jobs:
        def run(device, tag, native=None, path=ckpt):
            return np.asarray(make_predictions(PredictConfig(
                test_path=test_path, checkpoint_path=path,
                preds_path=os.path.join(OUT_DIR, f"{name}_{tag}.csv"),
                batch_size=BATCH_SIZE, num_workers=4, device=device,
                use_native_featurizer=native,
                number_of_molecules=molecules)), dtype=float)

        # each featurizer cold (featurization included; the Python path's
        # graph cache emptied first), counts from 0 before each run
        runs = {}
        for featurizer, native in FEATURIZERS:
            if name in ("regression_highest", "mpn_shared") and \
                    native is False:
                continue
            empty_cache()
            bm.reset_launch_counts()
            t0 = time.perf_counter()
            got = run("cuda", f"gpu_{featurizer}", native)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts, tc = bm.launch_counts(), bm.tc_launch_counts()
            runs[featurizer] = got, counts, tc
            n = got.shape[0]
            batches = math.ceil(n / BATCH_SIZE)
            log(f"[main] {name}, {featurizer} featurizer: {n} molecules, "
                f"{batches} batches, launches {counts} (tensor cores {tc}), "
                f"{n / seconds:.1f} molecules/s end to end ({seconds:.3f} s, "
                f"featurization included) on {card}")
        got, counts, tc = runs["C++"]
        if "Python" in runs:
            # the featurizer changes no launch and no bit of the input
            py_got, py_counts, py_tc = runs["Python"]
            check((py_counts, py_tc) == (counts, tc),
                  f"launches differ by featurizer: {py_counts} {counts}")
            log(f"[main] {name}: max |C++ - Python featurizer| "
                f"{np.abs(py_got - got).max():.3e}")
            np.testing.assert_allclose(py_got, got, rtol=1e-4, atol=1e-5)
            for k in launches:
                launches[k] += py_counts[k]
            for k in tc_launches:
                tc_launches[k] += py_tc[k]
        want = run("cpu", "cpu")          # the plain versions on the CPU
        check(counts["band_rev_layer"] == (DEPTH - 1) * batches * molecules,
              counts)
        check(counts["atom_readout"] == batches * molecules, counts)
        # the molecule readout: one launch a forward
        check(counts["molecule_readout_sorted"] == batches * molecules,
              counts)
        check(counts["band_rev_bwd"] == counts[GATHER_OPS[
            "atom_neighbor_sum"]] == 0, counts)
        check(all(counts[k] == 0 for k in PLAIN_BAND_KERNELS), counts)
        # every layer on the tensor cores at the default "high"; none at
        # "highest"
        rev_tc = 0 if name == "regression_highest" else counts["band_rev_layer"]
        check(tc == dict(dict.fromkeys(tc, 0), band_rev_layer=rev_tc),
              f"tensor-core launches {tc}")
        for k in launches:
            launches[k] += counts[k]
        for k in tc_launches:
            tc_launches[k] += tc[k]
        check(got.shape == want.shape == (n, 1), (got.shape, want.shape))
        check(np.isfinite(got).all(), "non-finite predictions")
        err = np.abs(got - want).max()
        log(f"[main] {name}: max |gpu - cpu| {err:.3e}")
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        if name == "mpn_shared":
            # the second copy is served: copy 0 at both positions is
            # another model, far outside the tolerance above
            gap = np.abs(run("cuda", "gpu_copy0", path=copy0_ckpt)
                         - got).max()
            log(f"[main] mpn_shared: max |served - copy 0 at both "
                f"positions| {gap:.3e}")
            check(gap > 100 * (1e-5 + 1e-4 * np.abs(want).max()),
                  f"the second encoder copy changed nothing ({gap:.3e})")
    return launches, tc_launches


def fingerprint_path(card):
    """The fingerprint entry point on the card from the regression
    checkpoint ``main_path`` wrote, "MPN" and "last_FFN", with exact
    launch counts, held against the same run on the CPU."""
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    from polymer_chemprop_tpu_torch.train.molecule_fingerprint import (
        FingerprintConfig,
        molecule_fingerprint,
    )
    launches = dict.fromkeys(bm.launch_counts(), 0)
    tc_launches = dict.fromkeys(bm.tc_launch_counts(), 0)
    for fp_type in ("MPN", "last_FFN"):
        def run(device):
            return molecule_fingerprint(FingerprintConfig(
                test_path=os.path.join(ROOT, "tests", "data",
                                       "regression.csv"),
                checkpoint_path=os.path.join(OUT_DIR, "regression",
                                             "model.ckpt"),
                preds_path=os.path.join(OUT_DIR,
                                        f"fingerprint_{fp_type}_{device}.csv"),
                fingerprint_type=fp_type, batch_size=BATCH_SIZE,
                num_workers=4, device=device))

        bm.reset_launch_counts()
        t0 = time.perf_counter()
        got = run("cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts, tc = bm.launch_counts(), bm.tc_launch_counts()
        n = got.shape[0]
        batches = math.ceil(n / BATCH_SIZE)
        log(f"[fingerprint] {fp_type}: {n} molecules x {got.shape[1]}, "
            f"{batches} batches, launches {counts} (tensor cores {tc}), "
            f"{n / seconds:.1f} molecules/s end to end ({seconds:.3f} s) on "
            f"{card}")
        check(counts == dict(dict.fromkeys(counts, 0),
                             band_rev_layer=(DEPTH - 1) * batches,
                             atom_readout=batches,
                             molecule_readout_sorted=batches), counts)
        check(tc == dict(dict.fromkeys(tc, 0),
                         band_rev_layer=(DEPTH - 1) * batches),
              f"tensor-core launches {tc}")
        for k in launches:
            launches[k] += counts[k]
        for k in tc_launches:
            tc_launches[k] += tc[k]
        want = run("cpu")
        check(got.shape == want.shape == (n, HIDDEN), (got.shape, want.shape))
        check(np.isfinite(got).all() and np.abs(got).max() > 0,
              "fingerprints not finite or all 0")
        log(f"[fingerprint] {fp_type}: max |gpu - cpu| "
            f"{np.abs(got - want).max():.3e}")
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    return launches, tc_launches


# -- phase 4 ----------------------------------------------------------------

def train_setup(cfg, device):
    """``(train step, shuffled train loader)`` of ``cfg``'s run as the
    trainer builds them (reference-stream init, serial batching), with the
    run's extra inputs, feature scalers and spectra normalization."""
    from polymer_chemprop_tpu_torch.data import (MoleculeDataLoader,
                                                  get_data, split_data)
    from polymer_chemprop_tpu_torch.models.init import reference_init_model
    from polymer_chemprop_tpu_torch.models.model import (
        build_model_config, widened_featurization)
    from polymer_chemprop_tpu_torch.train.scheduler import (build_optimizer,
                                                            build_schedule)
    from polymer_chemprop_tpu_torch.train.step import TrainStep, make_loss_fn
    from polymer_chemprop_tpu_torch.train.trainer import (
        _normalize_spectra_targets, _scale_features)
    data = get_data(cfg.data_path, config=cfg.featurization(),
                    features_path=cfg.features_path,
                    features_generators=cfg.features_generator,
                    atom_descriptors=cfg.atom_descriptors,
                    atom_descriptors_path=cfg.atom_descriptors_path,
                    bond_features_path=cfg.bond_features_path,
                    phase_features_path=cfg.phase_features_path)
    fcfg = widened_featurization(cfg, data)
    train, val, test = split_data(data, cfg.split_type, cfg.split_sizes,
                                  cfg.seed)
    _scale_features(cfg, train, val, test)
    if cfg.dataset_type == "spectra":
        _normalize_spectra_targets(train, val, test, cfg)
    else:
        train.normalize_targets()
    loader = MoleculeDataLoader(
        train, fcfg, batch_size=cfg.batch_size, shuffle=True, seed=cfg.seed,
        num_workers=1, use_native=cfg.use_native_featurizer)
    mcfg = build_model_config(cfg, data.num_tasks, data=train)
    model = reference_init_model(mcfg, cfg.pytorch_seed).to(device)
    step = TrainStep(
        model, build_optimizer(cfg.optimizer, model.parameters()),
        build_schedule(cfg.scheduler, init_lr=cfg.init_lr, max_lr=cfg.max_lr,
                       final_lr=cfg.final_lr, warmup_epochs=cfg.warmup_epochs,
                       epochs=cfg.epochs,
                       steps_per_epoch=max(1, len(train) // cfg.batch_size)),
        make_loss_fn(mcfg))
    return step, loader


def first_step(cfg, device):
    """Loss and gradient norm of the first optimizer step of ``cfg``'s
    run (first shuffled batch) on ``device``."""
    from polymer_chemprop_tpu_torch.train.step import batch_tensors
    step, loader = train_setup(cfg, device)
    loss, gnorm = step(batch_tensors(next(iter(loader)), device))
    return float(loss), float(gnorm)


def epoch_breakdown(name, cfg, card, device="cuda"):
    """Where a training epoch's time goes on the card, graphs cached.

    Epoch 1 featurizes and warms up. Epoch 2 runs with a device sync after
    every part and sums the host clock per part. Epoch 3 runs as the
    trainer does (no sync until its end); epoch 4 the same under
    torch.profiler, whose kernel times give the device's busy time."""
    from polymer_chemprop_tpu_torch.train.step import batch_tensors
    step, loader = train_setup(cfg, device)
    model, optimizer = step.model, step.optimizer

    def plain_epoch():
        t0 = time.perf_counter()
        out = [step(batch_tensors(b, device)) for b in loader]
        torch.cuda.synchronize()
        return time.perf_counter() - t0, len(out)

    plain_epoch()
    parts = dict.fromkeys(("loader", "h2d", "forward", "backward",
                           "optimizer"), 0.0)

    def lap(part, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        parts[part] += t1 - t0
        return t1

    model.train()
    batches = iter(loader)
    t = time.perf_counter()
    while True:
        host_batch = next(batches, None)
        t = lap("loader", t)
        if host_batch is None:
            break
        batch = batch_tensors(host_batch, device)
        t = lap("h2d", t)
        optimizer.zero_grad(set_to_none=True)
        loss = step.loss_fn(model, batch, None)
        t = lap("forward", t)
        loss.backward()
        t = lap("backward", t)
        for group in optimizer.param_groups:
            group["lr"] = step.schedule(step.count)
        optimizer.step()
        step.count += 1
        t = lap("optimizer", t)
    total = sum(parts.values())
    log(f"[train] {name} cached epoch, synced after every part: "
        + ", ".join(f"{k} {1e3 * v:.1f} ms ({100 * v / total:.0f}%)"
                    for k, v in parts.items())
        + f", total {1e3 * total:.1f} ms on {card}")

    wall, steps = plain_epoch()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        plain_epoch()
    events = prof.key_averages()
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
               for e in events) * 1e-6
    n_kernels = sum(e.count for e in events
                    if str(getattr(e, "device_type", "")).endswith("CUDA"))
    if busy > 0:
        log(f"[train] {name} cached epoch as the trainer runs it: {steps} "
            f"steps in {1e3 * wall:.1f} ms ({steps / wall:.1f} steps/s); "
            f"device busy {1e3 * busy:.2f} ms in the profiled epoch "
            f"({n_kernels / steps:.0f} device operations per step), idle "
            f"share {100 * (1 - busy / wall):.1f}% on {card}")
    else:
        log(f"[train] {name} cached epoch as the trainer runs it: {steps} "
            f"steps in {1e3 * wall:.1f} ms ({steps / wall:.1f} steps/s); "
            "device busy time not measured (the profiler gave no device "
            "time)")


def training_path(card):
    import csv
    import re

    from polymer_chemprop_tpu_torch.config import PredictConfig, TrainConfig
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    from polymer_chemprop_tpu_torch.train.cross_validate import cross_validate
    from polymer_chemprop_tpu_torch.train.make_predictions import (
        make_predictions,
    )
    poly_csv = os.path.join(OUT_DIR, "polymers_train.csv")
    polymer_csv(poly_csv, with_target=True)
    jobs = [("regression", os.path.join(ROOT, "tests", "data",
                                        "regression.csv"), False),
            ("polymer", poly_csv, True)]
    launches = dict.fromkeys(bm.launch_counts(), 0)
    tc_launches = dict.fromkeys(bm.tc_launch_counts(), 0)
    for name, data_path, polymer in jobs:
        epochs = TRAIN_EPOCHS[name]

        def config(device, native=None):
            return TrainConfig(
                data_path=data_path, dataset_type="regression",
                polymer=polymer, hidden_size=HIDDEN, depth=DEPTH,
                ffn_num_layers=2, ffn_hidden_size=HIDDEN, dropout=0.0,
                epochs=epochs, batch_size=BATCH_SIZE, seed=SEED,
                num_workers=4, quiet=True, device=device,
                use_native_featurizer=native,
                # drop the graphs the serving phase cached, so that the
                # first epoch featurizes as a fresh run does
                empty_cache=True,
                save_dir=os.path.join(
                    OUT_DIR, f"train_{name}_{device}"
                    + ("_python" if native is False else "")))

        with open(data_path) as f:
            n = sum(1 for _ in f) - 1
        n_train, n_val = int(0.8 * n), int(0.9 * n) - int(0.8 * n)
        n_test = n - int(0.9 * n)
        batches = lambda k: math.ceil(k / BATCH_SIZE)
        steps = epochs * batches(n_train)
        forwards = steps + epochs * (batches(n_val) + batches(n_train)) \
            + batches(n_test)
        # one run a featurizer, counts from 0 before each; the featurizer
        # changes no launch and no bit of the input
        scores, run_counts = {}, {}
        for featurizer, native in FEATURIZERS:
            cfg = config("cuda", native)
            bm.reset_launch_counts()
            t0 = time.perf_counter()
            score, _ = cross_validate(cfg)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = bm.launch_counts()
            log(f"[train] {name}, {featurizer} featurizer: {n} molecules "
                f"({n_train}/{n_val}/{n_test}), {epochs} epochs, {steps} "
                f"steps, {forwards} forwards, launches {counts}, test rmse "
                f"{score:.6f}, {seconds:.3f} s end to end")
            check(counts["band_rev_layer"] == (DEPTH - 1) * forwards, counts)
            check(counts["band_rev_bwd"] == (DEPTH - 1) * steps, counts)
            check(counts["atom_readout"] == forwards, counts)
            # the molecule readout, whose VJP is a gather
            check(counts["molecule_readout_sorted"] == forwards, counts)
            check(all(counts[k] == 0 for k in PLAIN_BAND_KERNELS)
                  and counts[GATHER_OPS["atom_neighbor_sum"]] == 0, counts)
            # the default band_precision "high": every layer on the tensor
            # cores
            tc = bm.tc_launch_counts()
            check(tc == dict(dict.fromkeys(tc, 0),
                             band_rev_layer=counts["band_rev_layer"]),
                  f"tensor-core launches {tc}")
            for k in launches:
                launches[k] += counts[k]
            for k in tc_launches:
                tc_launches[k] += tc[k]

            model_dir = os.path.join(cfg.save_dir, "fold_0", "model_0")
            with open(os.path.join(model_dir,
                                   "train_val_loss_log.csv")) as f:
                rows = list(csv.DictReader(f))
            losses = [float(r["train_loss"]) for r in rows]
            check(len(rows) == epochs, rows)
            check(all(np.isfinite(float(v))
                      for r in rows for v in r.values()), rows)
            check(np.isfinite(score), score)
            log(f"[train] {name}, {featurizer} featurizer: train loss by "
                f"epoch {losses}")
            check(losses[-1] < losses[0], "the training loss did not fall")
            with open(os.path.join(cfg.save_dir, "verbose.log")) as f:
                rates = [float(x) for x in
                         re.findall(r"([0-9.]+) steps/s", f.read())]
            rates = rates[-epochs:]   # the log grows if the script reruns
            check(len(rates) == epochs, rates)
            for tag, rate in (("first epoch (featurizing)", rates[0]),
                              ("last epoch (graphs cached)", rates[-1])):
                log(f"[train] {name}, {featurizer} featurizer, {tag}: "
                    f"{rate:.1f} steps/s, "
                    f"{rate * n_train / batches(n_train):.1f} molecules/s "
                    f"on {card}")

            scores[featurizer] = score
            run_counts[featurizer] = counts, tc
        check(run_counts["C++"] == run_counts["Python"],
              f"launches differ by featurizer: {run_counts}")
        log(f"[train] {name}: test rmse C++ featurizer {scores['C++']:.6f}, "
            f"Python {scores['Python']:.6f}")
        np.testing.assert_allclose(scores["Python"], scores["C++"], rtol=1e-2)
        cfg, score = config("cuda"), scores["C++"]
        model_dir = os.path.join(cfg.save_dir, "fold_0", "model_0")

        # the same first step and the same whole run on the CPU
        got, want = first_step(cfg, "cuda"), first_step(config("cpu"), "cpu")
        log(f"[train] {name}: first step (loss, gnorm) gpu {got} cpu {want}")
        np.testing.assert_allclose(got, want, rtol=1e-4)
        for featurizer, native in FEATURIZERS:
            epoch_breakdown(f"{name}, {featurizer} featurizer,",
                            config("cuda", native), card)
        cpu_score, _ = cross_validate(config("cpu"))
        log(f"[train] {name}: test rmse gpu {score:.6f} cpu {cpu_score:.6f}")
        np.testing.assert_allclose(score, cpu_score, rtol=1e-2)

        # serve from the checkpoint the run wrote, on the card
        preds = np.asarray(make_predictions(PredictConfig(
            test_path=data_path,
            checkpoint_path=os.path.join(model_dir, "best_model.ckpt"),
            preds_path=os.path.join(OUT_DIR, f"train_{name}_preds.csv"),
            batch_size=BATCH_SIZE, num_workers=4, device="cuda")),
            dtype=float)
        check(preds.shape == (n, 1) and np.isfinite(preds).all(),
              "predictions from the trained checkpoint")
    return launches, tc_launches


# -- phase 5 ----------------------------------------------------------------

def plain_band_path(card, dev):
    """The encoder configurations whose layer is a plain-band kernel,
    through the entry points; returns the kernels' launches."""
    import re

    from polymer_chemprop_tpu_torch.config import PredictConfig, TrainConfig
    from polymer_chemprop_tpu_torch.features import mol2graph
    from polymer_chemprop_tpu_torch.models.encoder import batch_to_tensors
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    from polymer_chemprop_tpu_torch.train.cross_validate import cross_validate
    from polymer_chemprop_tpu_torch.train.make_predictions import (
        make_predictions,
    )
    data_path = os.path.join(ROOT, "tests", "data", "regression.csv")
    smiles = read_smiles(data_path)
    n = len(smiles)
    batches = lambda k: math.ceil(k / BATCH_SIZE)
    launches = dict.fromkeys(bm.launch_counts(), 0)
    tc_launches = dict.fromkeys(bm.tc_launch_counts(), 0)

    def tally(counts, expected, tc_expected=()):
        """Exact launch counts: ``expected`` for the kernels it names, 0
        for every other; of those, the tensor-core stage's launches are
        ``expected``'s for the kernels in ``tc_expected``, 0 for others."""
        want = dict(dict.fromkeys(counts, 0), **expected)
        check(counts == want, f"launches {counts}, expected {want}")
        tc = bm.tc_launch_counts()
        tc_want = {k: want[k] if k in tc_expected else 0 for k in tc}
        check(tc == tc_want, f"tensor-core launches {tc}, expected {tc_want}")
        for k in launches:
            launches[k] += counts[k]
        for k in tc_launches:
            tc_launches[k] += tc[k]

    def predict(ckpt, test_path, tag, device):
        return np.asarray(make_predictions(PredictConfig(
            test_path=test_path, checkpoint_path=ckpt,
            preds_path=os.path.join(OUT_DIR, f"{tag}_{device}.csv"),
            batch_size=BATCH_SIZE, num_workers=4, device=device)),
            dtype=float)

    # training and serving with bias (band_agg) and undirected
    # (band_matmul_act at the default band_precision "high": the tensor-core
    # stage); band_bwd is the VJP of both
    for option, layer_kernel in (("bias", "band_agg"),
                                 ("undirected", "band_matmul_act")):
        tc = (layer_kernel,) if option == "undirected" else ()
        epochs = PLAIN_BAND_EPOCHS

        def config(device):
            return TrainConfig(
                data_path=data_path, dataset_type="regression",
                hidden_size=HIDDEN, depth=DEPTH, ffn_num_layers=2,
                ffn_hidden_size=HIDDEN, dropout=0.0, epochs=epochs,
                batch_size=BATCH_SIZE, seed=SEED, num_workers=4, quiet=True,
                device=device,
                save_dir=os.path.join(OUT_DIR, f"train_{option}_{device}"),
                **{option: True})

        cfg = config("cuda")
        bm.reset_launch_counts()
        t0 = time.perf_counter()
        score, _ = cross_validate(cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = bm.launch_counts()
        n_train, n_val = int(0.8 * n), int(0.9 * n) - int(0.8 * n)
        n_test = n - int(0.9 * n)
        steps = epochs * batches(n_train)
        forwards = steps + epochs * (batches(n_val) + batches(n_train)) \
            + batches(n_test)
        log(f"[plain-band] {option}: {epochs} epochs, {steps} steps, "
            f"{forwards} forwards, launches {counts}, test rmse "
            f"{score:.6f}, {seconds:.3f} s end to end on {card}")
        tally(counts, {layer_kernel: (DEPTH - 1) * forwards,
                       "band_bwd": (DEPTH - 1) * steps,
                       "atom_readout": forwards,
                       "molecule_readout_sorted": forwards}, tc)
        check(np.isfinite(score), score)
        with open(os.path.join(cfg.save_dir, "verbose.log")) as f:
            rates = [float(x) for x in
                     re.findall(r"([0-9.]+) steps/s", f.read())][-epochs:]
        check(len(rates) == epochs, rates)
        log(f"[plain-band] {option} last epoch (graphs cached): "
            f"{rates[-1]:.1f} steps/s, "
            f"{rates[-1] * n_train / batches(n_train):.1f} molecules/s "
            f"on {card}")

        got, want = first_step(cfg, "cuda"), first_step(config("cpu"), "cpu")
        log(f"[plain-band] {option}: first step (loss, gnorm) gpu {got} "
            f"cpu {want}")
        np.testing.assert_allclose(got, want, rtol=1e-4)
        cpu_score, _ = cross_validate(config("cpu"))
        log(f"[plain-band] {option}: test rmse gpu {score:.6f} cpu "
            f"{cpu_score:.6f}")
        np.testing.assert_allclose(score, cpu_score, rtol=1e-2)

        ckpt = os.path.join(cfg.save_dir, "fold_0", "model_0",
                            "best_model.ckpt")
        bm.reset_launch_counts()
        t0 = time.perf_counter()
        preds = predict(ckpt, data_path, f"plain_band_{option}", "cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = bm.launch_counts()
        log(f"[plain-band] {option}: predicted {n} molecules, launches "
            f"{counts}, {n / seconds:.1f} molecules/s end to end "
            f"(graphs cached) on {card}")
        tally(counts, {layer_kernel: (DEPTH - 1) * batches(n),
                       "atom_readout": batches(n),
                       "molecule_readout_sorted": batches(n)}, tc)
        want = predict(ckpt, data_path, f"plain_band_{option}", "cpu")
        check(preds.shape == want.shape == (n, 1), preds.shape)
        check(np.isfinite(preds).all(), "non-finite predictions")
        log(f"[plain-band] {option}: predictions max |gpu - cpu| "
            f"{np.abs(preds - want).max():.3e}")
        np.testing.assert_allclose(preds, want, rtol=1e-4, atol=1e-5)

    # serving with bfloat16 linear layers, and at a hidden size too wide
    # for the fused kernels: both take band_agg; undirected at
    # band_precision "highest": band_matmul_act on the FP32 stage
    wide_csv = os.path.join(OUT_DIR, "wide.csv")
    with open(wide_csv, "w") as f:
        f.write("smiles\n" + "\n".join(smiles[:WIDE_MOLECULES]) + "\n")
    for tag, test_path, kw, layer_kernel, rtol, atol in (
            ("bf16", data_path, dict(param_dtype="bf16"), "band_agg", 2e-3,
             1e-3),
            ("wide", wide_csv, dict(hidden=WIDE_HIDDEN), "band_agg", 1e-4,
             1e-5),
            ("undirected_highest", data_path,
             dict(undirected=True, band_precision="highest"),
             "band_matmul_act", 1e-4, 1e-5)):
        ckpt = os.path.join(OUT_DIR, tag, "model.ckpt")
        write_checkpoint(ckpt, polymer=False, **kw)
        bm.reset_launch_counts()
        preds = predict(ckpt, test_path, tag, "cuda")
        torch.cuda.synchronize()
        counts = bm.launch_counts()
        k = preds.shape[0]
        tally(counts, {layer_kernel: (DEPTH - 1) * batches(k),
                       "atom_readout": batches(k),
                       "molecule_readout_sorted": batches(k)})
        want = predict(ckpt, test_path, tag, "cpu")
        check(np.isfinite(preds).all(), "non-finite predictions")
        log(f"[plain-band] {tag}: {k} molecules, launches {counts}, "
            f"max |gpu - cpu| {np.abs(preds - want).max():.3e} (rtol {rtol}, "
            f"atol {atol})")
        np.testing.assert_allclose(preds, want, rtol=rtol, atol=atol)

    # band_matmul through its public op, forward and backward, on a
    # featurized batch at full width
    gb = mol2graph((smiles * 3)[:1024])
    graph = batch_to_tensors(gb.arrays(sorted_aux=True), dev)
    aux = graph["sorted_aux"]
    B = graph["f_bonds"].shape[0]
    gen = torch.Generator(dev).manual_seed(SEED)
    m, g = (torch.randn((B, HIDDEN), device=dev, generator=gen)
            for _ in range(2))
    wh = torch.randn((HIDDEN, HIDDEN), device=dev, generator=gen) \
        * (1.0 / HIDDEN) ** 0.5

    def run(op):
        leaves = [t.clone().requires_grad_(True) for t in (m, wh)]
        out = op(*leaves)
        return (out, *torch.autograd.grad(out, leaves, g))

    # at the op's default "highest" (the FP32 stage) and at "high" (the
    # tensor-core stage, against the split product's value with the FP32
    # product's gradient)
    for precision, tc in (("highest", ()), ("high", ("band_matmul",))):
        bm.reset_launch_counts()
        got = run(lambda x, w: bm.band_matmul_step_sorted(x, w, aux,
                                                          precision))
        torch.cuda.synchronize()
        tally(bm.launch_counts(), {"band_matmul": 1, "band_bwd": 1}, tc)
        want = run(lambda x, w: straight_through(
            bm.band_message_step_sorted(x, aux), w, precision, bm))
        torch.cuda.synchronize()
        for name, a, b in zip(("out", "dm", "dW_h"), got, want):
            err, tol = (a - b).abs().max().item(), kernel_tolerance(b)
            log(f"[plain-band] band_matmul_step_sorted {precision} {name} "
                f"against band_agg + product: max_abs_err {err:.3e} (tol "
                f"{tol:.3e})")
            check(err <= tol, f"band_matmul_step_sorted {precision} {name}")
    return launches, tc_launches


# -- phase 6 ----------------------------------------------------------------

def probe_path(card, dev, gb, results):
    """Both kernel probes through their entry points on phase 2's batch,
    then ``band_ctrl`` and ``fused_matmul`` against their plain versions;
    the probes' numbers go into ``results``. Returns the launches of the
    probe run."""
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    from polymer_chemprop_tpu_torch.ops import probe_kernels as pk
    from polymer_chemprop_tpu_torch.probes import (band_layer_probe,
                                                   fused_matmul_probe)
    from polymer_chemprop_tpu_torch.probes.bench_batch import bench_aux

    argv = ["--device", "cuda", "--hidden", str(HIDDEN), "--reps",
            str(PROBE_REPS)]
    bm.reset_launch_counts()
    pk.reset_launch_counts()
    t0 = time.perf_counter()
    layer = band_layer_probe.main(argv, batch=gb)
    fused = fused_matmul_probe.main(argv, batch=gb)
    torch.cuda.synchronize()
    launches = {**bm.launch_counts(), **pk.launch_counts()}
    log(f"[probe] both probes in {time.perf_counter() - t0:.1f} s, launches "
        f"{launches} on {card}")
    rows, split = layer["rows"], layer["split"]
    check(all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in rows.values()),
          rows)
    full = rows["full"]["ms"]
    parts = sum(split.values())
    log(f"[probe] the layer's split adds up: build + epilogue + product "
        f"{parts:.4f} ms, full {full:.4f} ms")
    check(abs(parts - full) <= 1e-9 * full, "the split does not add up")
    for shape in fused.values():
        err = shape["errors"]
        check(all(math.isfinite(v) for v in err.values()), err)
        # the split drops the lo x lo term: about 1e-5 of the largest entry
        check(err["kernel_vs_fp64"] <= 1e-4, f"fused_matmul's split: {err}")

    B, H = gb.f_bonds.shape[0], HIDDEN
    aux = bench_aux(gb)
    rng = np.random.default_rng(SEED)
    T = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=dev)
    normal = lambda *shape: T(rng.normal(size=shape).astype(np.float32))
    m, inp = normal(B, H), normal(B, H)
    wh = T((rng.normal(size=(H, H)) * (2.0 / (2 * H)) ** 0.5)
           .astype(np.float32))

    def hold(name, what, got, ref):
        torch.cuda.synchronize()
        err, tol = (got - ref).abs().max().item(), kernel_tolerance(ref)
        log(f"[kernel] {what}: max_abs_err {err:.3e} (tol {tol:.3e})")
        check(err <= tol, f"{what} disagrees with its plain version")
        note_error(results, name, err)

    # the control's ranges: each block's own rows, and 512-row windows
    # from 256-row tiles as the TPU control reads them
    starts = np.minimum(np.arange(0, B, pk.TPU_TILE), B - pk.TPU_WINDOW)
    ranges = {"own rows": pk.own_row_ranges(B, dev),
              "512-row windows": pk.window_ranges(starts, B, dev)}
    for weights in ("unit", "polymer"):
        w = aux.w_sorted
        if weights == "polymer":
            w = np.where(w > 0, rng.choice([0.25, 0.5, 0.75], w.shape),
                         0.0).astype(np.float32)
        w = T(w)
        for label, (lo, hi) in ranges.items():
            for mode in ("noq", "pure"):
                hold("band_ctrl", f"band_ctrl {mode} {weights} {label}",
                     pk.band_ctrl(m, inp, wh, w, lo, hi, mode),
                     pk.band_ctrl_plain(m, inp, wh, w, lo, hi, mode))
    for n, k, cols in ((B, H, H), (*JAX_PROBE_SHAPE, JAX_PROBE_SHAPE[1]),
                       (B, H, 96)):
        x, b = normal(n, k), normal(k, cols) * 0.05
        b_hi, b_lo = pk.split_bf16(b)
        got = pk.fused_matmul(x, b_hi, b_lo)
        what = f"fused_matmul ({n}, {k}) x ({k}, {cols})"
        hold("fused_matmul", what, got, pk.fused_matmul_plain(x, b_hi, b_lo))
        exact = x.double() @ b.double()
        hold_fp64(results, "fused_matmul", what, got, exact)

    # the JSON entries: the probes' own times at the bench shape; bounds
    # from this batch. band_ctrl (noq, own rows): z @ W_h, the z sums (one
    # fma per row of each block's range) and the epilogue's add; m, inp
    # and out once, W_h, w, lo and hi once
    nblk = -(-B // 32)
    r = results["band_ctrl"]
    r.update(ms=rows["noq"]["ms"], ms_pure=rows["pure"]["ms"],
             plain_ms=rows["noq_plain"]["ms"],
             library_ms=rows["library_same"]["ms"],
             library_ms_pure=rows["library_same_pure"]["ms"],
             ms_layer_full=full, ms_split=split)
    c_bytes = 4 * (3 * B * H + H * H + B + 2 * nblk)
    c_ops = 2 * B * H * H + 2 * B * H + B * H
    r["bound_ms"], r["bound_by"] = bound(c_bytes, c_ops)
    # pure: no inp read, no epilogue add
    r["bound_ms_pure"] = bound(c_bytes - 4 * B * H, c_ops - B * H)[0]
    # fused_matmul: three bf16 passes on the tensor cores; x read and out
    # written once, b_hi and b_lo once
    bench, jax_shape = fused["bench"], fused["jax_shape"]
    r = results["fused_matmul"]
    r.update(ms=bench["rows"]["fused_matmul"]["ms"],
             plain_ms=bench["rows"]["plain"]["ms"],
             library_ms=bench["rows"]["mm_fp32"]["ms"],
             library_tf32_ms=bench["rows"]["mm_tf32"]["ms"],
             max_rel_err_fp64=bench["errors"]["kernel_vs_fp64"],
             ms_jax_shape=jax_shape["rows"]["fused_matmul"]["ms"],
             library_ms_jax_shape=jax_shape["rows"]["mm_fp32"]["ms"],
             library_tf32_ms_jax_shape=jax_shape["rows"]["mm_tf32"]["ms"])

    def matmul_bound(n, k):
        return bound(4 * n * k + 4 * n * k + 2 * 2 * k * k, 3 * 2 * n * k * k,
                     PEAK_BF16_TC_FLOPS)
    r["bound_ms"], r["bound_by"] = matmul_bound(B, H)
    r["bound_ms_jax_shape"] = matmul_bound(*JAX_PROBE_SHAPE)[0]
    for name in ("band_ctrl", "fused_matmul"):
        r = results[name]
        log(f"[time] {name} at B={B} H={H}: kernel_ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} library_ms {r['library_ms']:.4f} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) on {card}")
    r = results["band_ctrl"]
    log(f"[time] band_ctrl pure: kernel_ms {r['ms_pure']:.4f} library_ms "
        f"(mm) {r['library_ms_pure']:.4f} bound_ms {r['bound_ms_pure']:.4f} "
        f"on {card}")
    r = results["fused_matmul"]
    log(f"[time] fused_matmul at {JAX_PROBE_SHAPE}: kernel_ms "
        f"{r['ms_jax_shape']:.4f} library_ms {r['library_ms_jax_shape']:.4f} "
        f"(TF32 {r['library_tf32_ms_jax_shape']:.4f}) bound_ms "
        f"{r['bound_ms_jax_shape']:.4f} on {card}")
    return launches


# -- phase 7 ----------------------------------------------------------------

def atom_messages_path(card):
    """``atom_messages`` through the entry points at full width: serving
    regression.csv and the copolymers from written checkpoints (C++
    featurizer), ``fingerprint`` MPN and a bfloat16 run from the regression
    one, then ``cross_validate`` on both data sets; each run with exact
    launch counts (per forward depth - 1 neighbour sums and one readout;
    per training step each once more in the backward; no other kernel)
    and held against the same run on the CPU. Returns the launches."""
    import csv
    import re

    from polymer_chemprop_tpu_torch.config import PredictConfig, TrainConfig
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    from polymer_chemprop_tpu_torch.train.cross_validate import cross_validate
    from polymer_chemprop_tpu_torch.train.make_predictions import (
        make_predictions,
    )
    from polymer_chemprop_tpu_torch.train.molecule_fingerprint import (
        FingerprintConfig,
        molecule_fingerprint,
    )
    os.makedirs(OUT_DIR, exist_ok=True)
    reg_csv = os.path.join(ROOT, "tests", "data", "regression.csv")
    poly_csv = os.path.join(OUT_DIR, "polymers_am.csv")
    polymer_csv(poly_csv)
    batches = lambda k: math.ceil(k / BATCH_SIZE)
    launches = dict.fromkeys(bm.launch_counts(), 0)
    neighbor, readout = GATHER_OPS.values()

    def tally(forwards, steps=0):
        """The counts since the last reset, exactly as the code implies: a
        forward's neighbour sums, its atom and molecule readouts and its
        ``f_sum`` (row 3 at unit weights); a step's VJPs of the first two
        (the molecule readout's is a gather)."""
        counts = bm.launch_counts()
        want = dict.fromkeys(counts, 0)
        want[neighbor] = (DEPTH - 1) * (forwards + steps)
        want[readout] = forwards + steps
        want["molecule_readout_sorted"] = forwards
        want["atom_readout"] = forwards
        check(counts == want, f"launches {counts}, expected {want}")
        tc = bm.tc_launch_counts()
        check(not any(tc.values()), f"tensor-core launches {tc}")
        for k in launches:
            launches[k] += counts[k]
        return counts

    def serve(tag, fn, rtol, atol, width):
        """``fn(device)`` on the card (counts from 0) and on the CPU."""
        bm.reset_launch_counts()
        t0 = time.perf_counter()
        got = np.asarray(fn("cuda"), dtype=float)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n = got.shape[0]
        counts = tally(batches(n))
        want = np.asarray(fn("cpu"), dtype=float)
        check(got.shape == want.shape == (n, width), (got.shape, want.shape))
        check(np.isfinite(got).all() and np.abs(got).max() > 0,
              "outputs not finite or all 0")
        log(f"[atom_messages] {tag}: {n} molecules, launches {counts}, "
            f"{n / seconds:.1f} molecules/s end to end ({seconds:.3f} s, "
            f"C++ featurizer) on {card}; max |gpu - cpu| "
            f"{np.abs(got - want).max():.3e} (rtol {rtol}, atol {atol})")
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)

    ckpts = {}
    for name, test_path, polymer, kw in (
            ("regression", reg_csv, False, {}),
            ("polymer", poly_csv, True, {}),
            ("bf16", reg_csv, False, dict(param_dtype="bf16"))):
        ckpt = os.path.join(OUT_DIR, f"am_{name}", "model.ckpt")
        write_checkpoint(ckpt, polymer=polymer, atom_messages=True, **kw)
        ckpts[name] = ckpt
        tol = (2e-3, 1e-3) if name == "bf16" else (1e-4, 1e-5)
        serve(f"serving {name}", lambda device: make_predictions(
            PredictConfig(test_path=test_path, checkpoint_path=ckpt,
                          preds_path=os.path.join(
                              OUT_DIR, f"am_{name}_{device}.csv"),
                          batch_size=BATCH_SIZE, num_workers=4,
                          device=device)), *tol, 1)
    serve("fingerprint MPN", lambda device: molecule_fingerprint(
        FingerprintConfig(test_path=reg_csv,
                          checkpoint_path=ckpts["regression"],
                          preds_path=os.path.join(
                              OUT_DIR, f"am_fingerprint_{device}.csv"),
                          fingerprint_type="MPN", batch_size=BATCH_SIZE,
                          num_workers=4, device=device)), 1e-4, 1e-5, HIDDEN)

    poly_train = os.path.join(OUT_DIR, "polymers_am_train.csv")
    polymer_csv(poly_train, with_target=True)
    for name, data_path, polymer in (("regression", reg_csv, False),
                                     ("polymer", poly_train, True)):
        epochs = TRAIN_EPOCHS[name]

        def config(device):
            return TrainConfig(
                data_path=data_path, dataset_type="regression",
                polymer=polymer, atom_messages=True, hidden_size=HIDDEN,
                depth=DEPTH, ffn_num_layers=2, ffn_hidden_size=HIDDEN,
                dropout=0.0, epochs=epochs, batch_size=BATCH_SIZE, seed=SEED,
                num_workers=4, quiet=True, device=device, empty_cache=True,
                save_dir=os.path.join(OUT_DIR, f"train_am_{name}_{device}"))

        with open(data_path) as f:
            n = sum(1 for _ in f) - 1
        n_train, n_val = int(0.8 * n), int(0.9 * n) - int(0.8 * n)
        n_test = n - int(0.9 * n)
        steps = epochs * batches(n_train)
        forwards = steps + epochs * (batches(n_val) + batches(n_train)) \
            + batches(n_test)
        cfg = config("cuda")
        bm.reset_launch_counts()
        t0 = time.perf_counter()
        score, _ = cross_validate(cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = tally(forwards, steps)
        log(f"[atom_messages] train {name}: {n} molecules "
            f"({n_train}/{n_val}/{n_test}), {epochs} epochs, {steps} steps, "
            f"{forwards} forwards, launches {counts}, test rmse {score:.6f}, "
            f"{seconds:.3f} s end to end on {card}")
        def train_losses(save_dir):
            path = os.path.join(save_dir, "fold_0", "model_0",
                                "train_val_loss_log.csv")
            with open(path) as f:
                rows = list(csv.DictReader(f))
            check(len(rows) == epochs, rows)
            check(all(np.isfinite(float(v)) for r in rows
                      for v in r.values()), rows)
            return [float(r["train_loss"]) for r in rows]

        losses = train_losses(cfg.save_dir)
        check(np.isfinite(score), score)
        # the copolymers' loss rises in the second of two 4-step epochs at
        # this width, in the JAX package too (a CPU run: 1.2353 -> 1.3553);
        # every epoch's loss is held against the CPU run's below
        if name == "regression":
            check(losses[-1] < losses[0], "the training loss did not fall")
        with open(os.path.join(cfg.save_dir, "verbose.log")) as f:
            rates = [float(x) for x in
                     re.findall(r"([0-9.]+) steps/s", f.read())][-epochs:]
        check(len(rates) == epochs, rates)
        log(f"[atom_messages] train {name}: train loss by epoch {losses}; "
            f"first epoch (featurizing) {rates[0]:.1f} steps/s, last epoch "
            f"(graphs cached) {rates[-1]:.1f} steps/s on {card}")
        got, want = first_step(cfg, "cuda"), first_step(config("cpu"), "cpu")
        log(f"[atom_messages] train {name}: first step (loss, gnorm) gpu "
            f"{got} cpu {want}")
        np.testing.assert_allclose(got, want, rtol=1e-4)
        if name == "regression":
            epoch_breakdown("atom_messages regression,", config("cuda"), card)
        cpu_cfg = config("cpu")
        cpu_score, _ = cross_validate(cpu_cfg)
        cpu_losses = train_losses(cpu_cfg.save_dir)
        log(f"[atom_messages] train {name}: test rmse gpu {score:.6f} cpu "
            f"{cpu_score:.6f}; train loss by epoch cpu {cpu_losses}")
        np.testing.assert_allclose(score, cpu_score, rtol=1e-2)
        np.testing.assert_allclose(losses, cpu_losses, rtol=1e-2)
    return launches


# -- phase 8 ----------------------------------------------------------------

def descriptor_files(csv_path, out_dir):
    """Per-atom (atoms, 3) and per-bond (bonds, 2) descriptor files for
    every molecule of ``csv_path``, from a numpy seed, sized from the
    port's own parser (as tests/test_integration.py:441-467)."""
    from polymer_chemprop_tpu_torch.chem import parse_smiles
    rng = np.random.default_rng(SEED)
    atoms, bonds = [], []
    for smi in read_smiles(csv_path):
        m = parse_smiles(smi)
        atoms.append(rng.normal(size=(m.n_atoms, 3)))
        bonds.append(rng.normal(size=(m.n_bonds, 2)))
    paths = (os.path.join(out_dir, "atom_descriptors.npz"),
             os.path.join(out_dir, "bond_features.npz"))
    np.savez(paths[0], *atoms)
    np.savez(paths[1], *bonds)
    return paths


def extra_features_path(card):
    """The extra features through the entry points at full width (hidden
    300, depth 3, FFN 2 x 300, relu, mean, batch 50, C++ featurizer), each
    card run held against the same run on the CPU: ``cross_validate`` with
    ``rdkit_2d_normalized``, with atom descriptors and bond features, and
    on spectra with phase features and a phase mask, each served from its
    checkpoint; serving from written checkpoints with a feature file plus
    ``morgan``, with atom and bond features in the ``"feature"`` mode (the
    C++ loader's ``_apply_extras``), with ``atom_messages`` and
    descriptors, and ``features_only``. Exact launch counts. Returns the
    launches and the tensor-core launches."""
    import csv
    import re

    from polymer_chemprop_tpu_torch.config import PredictConfig, TrainConfig
    from polymer_chemprop_tpu_torch.data import MoleculeDataLoader
    from polymer_chemprop_tpu_torch.data import StandardScaler
    from polymer_chemprop_tpu_torch.features import generators
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    from polymer_chemprop_tpu_torch.train.cross_validate import cross_validate
    from polymer_chemprop_tpu_torch.train.make_predictions import (
        make_predictions,
    )
    out = os.path.join(OUT_DIR, "features")
    os.makedirs(out, exist_ok=True)
    data_dir = os.path.join(ROOT, "tests", "data")
    reg_csv = os.path.join(data_dir, "regression.csv")
    spectra_csv = os.path.join(data_dir, "spectra.csv")
    phases = os.path.join(data_dir, "spectra_features.csv")
    atoms_npz, bonds_npz = descriptor_files(reg_csv, out)
    batches = lambda k: math.ceil(k / BATCH_SIZE)
    launches = dict.fromkeys(bm.launch_counts(), 0)
    tc_launches = dict.fromkeys(bm.tc_launch_counts(), 0)
    neighbor, readout = GATHER_OPS.values()
    rng = np.random.default_rng(SEED)

    def tally(forwards, steps=0, atom_messages=False):
        """The counts since the last reset, exactly as the code implies
        (the bond-message layers all on the tensor cores at "high")."""
        counts = bm.launch_counts()
        want = dict.fromkeys(counts, 0)
        want["molecule_readout_sorted"] = forwards
        if atom_messages:
            want[neighbor] = (DEPTH - 1) * (forwards + steps)
            want[readout] = forwards + steps
            want["atom_readout"] = forwards
        elif forwards:
            want["band_rev_layer"] = (DEPTH - 1) * forwards
            want["band_rev_bwd"] = (DEPTH - 1) * steps
            want["atom_readout"] = forwards
        check(counts == want, f"launches {counts}, expected {want}")
        tc = bm.tc_launch_counts()
        check(tc == dict(dict.fromkeys(tc, 0),
                         band_rev_layer=want["band_rev_layer"]),
              f"tensor-core launches {tc}")
        for k in launches:
            launches[k] += counts[k]
        for k in tc_launches:
            tc_launches[k] += tc[k]
        return counts

    def serve(tag, ckpt, test_path, width=1, atom_messages=False,
              uses_encoder=True, **kw):
        """make_predictions on the card (counts from 0) and on the CPU."""
        def run(device):
            return np.asarray(make_predictions(PredictConfig(
                test_path=test_path, checkpoint_path=ckpt,
                preds_path=os.path.join(out, f"{tag}_{device}.csv"),
                batch_size=BATCH_SIZE, num_workers=4, device=device, **kw)),
                dtype=float)

        bm.reset_launch_counts()
        t0 = time.perf_counter()
        got = run("cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        n = got.shape[0]
        counts = tally(batches(n) if uses_encoder else 0,
                       atom_messages=atom_messages)
        want = run("cpu")
        check(got.shape == want.shape == (n, width), (got.shape, want.shape))
        check(np.isfinite(got).all(), "non-finite predictions")
        log(f"[features] serving {tag}: {n} molecules, launches {counts}, "
            f"{n / seconds:.1f} molecules/s end to end ({seconds:.3f} s, "
            f"C++ featurizer) on {card}; max |gpu - cpu| "
            f"{np.abs(got - want).max():.3e}")
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        return n

    def train(tag, data_path, epochs, **kw):
        """cross_validate on the card (counts from 0) and on the CPU, the
        first step on both; returns the card run's config."""
        def config(device):
            return TrainConfig(
                data_path=data_path, hidden_size=HIDDEN, depth=DEPTH,
                ffn_num_layers=2, ffn_hidden_size=HIDDEN, dropout=0.0,
                epochs=epochs, batch_size=BATCH_SIZE, seed=SEED,
                num_workers=4, quiet=True, device=device, empty_cache=True,
                save_dir=os.path.join(out, f"train_{tag}_{device}"), **kw)

        n = len(read_smiles(data_path))
        n_train, n_val = int(0.8 * n), int(0.9 * n) - int(0.8 * n)
        n_test = n - int(0.9 * n)
        steps = epochs * batches(n_train)
        forwards = steps + epochs * (batches(n_val) + batches(n_train)) \
            + batches(n_test)
        cfg = config("cuda")
        bm.reset_launch_counts()
        t0 = time.perf_counter()
        score, _ = cross_validate(cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = tally(forwards, steps)

        def losses_of(save_dir):
            path = os.path.join(save_dir, "fold_0", "model_0",
                                "train_val_loss_log.csv")
            with open(path) as f:
                rows = list(csv.DictReader(f))
            check(len(rows) == epochs, rows)
            # spectra rows are shorter than their header (one sid a set,
            # not one a task), as in the JAX package: None past the end
            check(all(np.isfinite(float(v)) for r in rows
                      for v in r.values() if v is not None), rows)
            return [float(r["train_loss"]) for r in rows]

        losses = losses_of(cfg.save_dir)
        check(np.isfinite(score), score)
        with open(os.path.join(cfg.save_dir, "verbose.log")) as f:
            rates = [float(x) for x in
                     re.findall(r"([0-9.]+) steps/s", f.read())][-epochs:]
        check(len(rates) == epochs, rates)
        log(f"[features] train {tag}: {n} molecules "
            f"({n_train}/{n_val}/{n_test}), {epochs} epochs, {steps} steps, "
            f"{forwards} forwards, launches {counts}, test {cfg.metric} "
            f"{score:.6f}, {seconds:.3f} s end to end; train loss by epoch "
            f"{losses}; first epoch {rates[0]:.1f} steps/s, last "
            f"{rates[-1]:.1f} steps/s on {card}")
        got, want = first_step(cfg, "cuda"), first_step(config("cpu"), "cpu")
        log(f"[features] train {tag}: first step (loss, gnorm) gpu {got} "
            f"cpu {want}")
        np.testing.assert_allclose(got, want, rtol=1e-4)
        cpu_cfg = config("cpu")
        cpu_score, _ = cross_validate(cpu_cfg)
        cpu_losses = losses_of(cpu_cfg.save_dir)
        log(f"[features] train {tag}: test {cfg.metric} gpu {score:.6f} cpu "
            f"{cpu_score:.6f}; train loss by epoch cpu {cpu_losses}")
        np.testing.assert_allclose(score, cpu_score, rtol=1e-2)
        np.testing.assert_allclose(losses, cpu_losses, rtol=1e-2)
        return cfg

    def best(cfg):
        return os.path.join(cfg.save_dir, "fold_0", "model_0",
                            "best_model.ckpt")

    # 1. rdkit_2d_normalized, the reference's documented recipe: the C++
    # engine on the 500 molecules (caches emptied), then train and serve
    smiles = read_smiles(reg_csv)
    generators._PRECOMPUTED_RDKIT2D.clear()
    generators._PRECOMPUTED_RDKIT2D_NORM.clear()
    generators.python_engine_count(reset=True)
    t0 = time.perf_counter()
    n_new = generators.precompute_rdkit2d_batch(smiles)
    seconds = time.perf_counter() - t0
    check(n_new == len(set(smiles)), f"{n_new} of {len(set(smiles))} "
          "molecules cached by the C++ engine")
    log(f"[features] rdkit_2d_normalized, C++ engine: {len(smiles)} "
        f"molecules in {1e3 * seconds:.2f} ms ({len(smiles) / seconds:.1f} "
        f"molecules/s, {min(os.cpu_count() or 1, 8)} threads, raw "
        f"descriptors and CDF normalization) on the host of {card}")
    rdkit = dict(features_generator=["rdkit_2d_normalized"],
                 no_features_scaling=True)
    cfg = train("rdkit_2d_normalized", reg_csv, TRAIN_EPOCHS["regression"],
                **rdkit)
    epoch_breakdown("rdkit_2d_normalized,", cfg, card)
    serve("rdkit_2d_normalized", best(cfg), reg_csv)
    check(generators.python_engine_count() == 0,
          f"{generators.python_engine_count()} molecules went to the "
          "Python descriptor engine")
    check(all(s in generators._PRECOMPUTED_RDKIT2D_NORM for s in smiles),
          "a molecule was not served by the C++ descriptor engine")

    # 2. a feature file (500 x 200) plus morgan, with a features scaler
    npz = os.path.join(data_dir, "regression.npz")
    F = 200 + 2048
    ckpt = os.path.join(out, "file_morgan", "model.ckpt")
    write_checkpoint(ckpt, polymer=False, features_size=F,
                     features_path=[npz], features_generator=["morgan"],
                     scalers={"features_scaler": StandardScaler(
                         rng.normal(size=F) * 0.1,
                         rng.uniform(0.5, 2.0, size=F))})
    serve("features_path + morgan", ckpt, reg_csv, features_path=[npz])

    # 3. atom descriptors and bond features: train and serve; then the
    # "feature" mode on the C++ loader's extras, and atom_messages
    files = dict(atom_descriptors_path=atoms_npz,
                 bond_features_path=bonds_npz)
    cfg = train("descriptor + bond features", reg_csv, 2,
                atom_descriptors="descriptor", **files)
    serve("descriptor + bond features", best(cfg), reg_csv, **files)
    ckpt = os.path.join(out, "feature_mode", "model.ckpt")
    write_checkpoint(ckpt, polymer=False, atom_extra=3, bond_extra=2,
                     atom_descriptors="feature", **files, scalers={
                         "atom_descriptor_scaler": StandardScaler(
                             np.full(3, 0.1), np.full(3, 1.5)),
                         "bond_feature_scaler": StandardScaler(
                             np.full(2, -0.1), np.full(2, 0.5))})
    extras_calls = [0]
    apply_extras = MoleculeDataLoader._apply_extras

    def counted(self, *args, **kwargs):
        extras_calls[0] += 1
        return apply_extras(self, *args, **kwargs)

    MoleculeDataLoader._apply_extras = counted
    try:
        n = serve("feature mode + bond features", ckpt, reg_csv, **files)
    finally:
        MoleculeDataLoader._apply_extras = apply_extras
    # the card run and the CPU run each widen every batch on the host
    check(extras_calls[0] == 2 * batches(n),
          f"_apply_extras ran {extras_calls[0]} times")
    ckpt = os.path.join(out, "am_descriptor", "model.ckpt")
    write_checkpoint(ckpt, polymer=False, descriptors_size=3,
                     atom_messages=True, atom_descriptors="descriptor",
                     atom_descriptors_path=atoms_npz)
    serve("atom_messages + descriptor", ckpt, reg_csv, atom_messages=True,
          atom_descriptors_path=atoms_npz)

    # 4. spectra with phase features and a phase mask: train and serve
    cfg = train("spectra", spectra_csv, 2, dataset_type="spectra",
                phase_features_path=phases,
                spectra_phase_mask_path=os.path.join(data_dir,
                                                     "spectra_mask.csv"))
    serve("spectra", best(cfg), spectra_csv, width=6,
          phase_features_path=phases)

    # 5. features_only: the FFN on the features alone, no kernel
    ckpt = os.path.join(out, "features_only", "model.ckpt")
    write_checkpoint(ckpt, polymer=False, features_size=200,
                     features_only=True, **rdkit)
    serve("features_only", ckpt, reg_csv, uses_encoder=False)
    return launches, tc_launches


# -- phase 9 ----------------------------------------------------------------

def _tally(total, counts):
    for k in total:
        total[k] += counts[k]


def _encoder_leaves(ckpt):
    from polymer_chemprop_tpu_torch.utils.checkpoint import load_checkpoint
    enc = load_checkpoint(ckpt)[0]["encoders"][0]
    return {f"{name}/{k}": v for name in sorted(enc)
            for k, v in enc[name].items()}


def _check_frozen(ckpt, frzn, what):
    trained, want = _encoder_leaves(ckpt), _encoder_leaves(frzn)
    check(trained.keys() == want.keys(), f"{what}: encoder keys")
    check(all(np.array_equal(trained[k], want[k]) for k in want),
          f"{what}: the frozen encoder changed")


def pt_runs(card, reg_csv, reg_ckpt, launches, tc_launches):
    """Serve from a reference ``.pt`` directory and warm-start from the
    SSL script's weights-only shape."""
    import shutil

    from polymer_chemprop_tpu_torch.config import PredictConfig, TrainConfig
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    from polymer_chemprop_tpu_torch.train.cross_validate import cross_validate
    from polymer_chemprop_tpu_torch.train.make_predictions import (
        make_predictions,
    )
    from polymer_chemprop_tpu_torch.utils.checkpoint import load_checkpoint
    from polymer_chemprop_tpu_torch.utils.torch_import import (
        export_reference_checkpoint,
    )
    out = os.path.join(OUT_DIR, "entry", "pt")
    shutil.rmtree(out, ignore_errors=True)
    pt_dir = os.path.join(out, "fold_0")
    os.makedirs(pt_dir, exist_ok=True)
    params, config, scalers, _ = load_checkpoint(reg_ckpt)
    export_reference_checkpoint(os.path.join(pt_dir, "best_model_full.pt"),
                                params, config, scalers)
    # a stale resume file beside it, with other weights and no args
    enc = params["encoders"][0]
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a.T)) * 0.5
    torch.save({"model_state_dict": {
        "W_initial.weight": T(enc["W_i"]["w"]),
        "W_message.weight": T(enc["W_h"]["w"]),
        "W_node.weight": T(enc["W_o"]["w"]),
        "W_node.bias": torch.from_numpy(enc["W_o"]["b"].copy())},
        "epoch": 3}, os.path.join(pt_dir, "model_0.pt"))

    def serve(tag, **where):
        bm.reset_launch_counts()
        t0 = time.perf_counter()
        got = np.asarray(make_predictions(PredictConfig(
            test_path=reg_csv, preds_path=os.path.join(out, f"{tag}.csv"),
            batch_size=BATCH_SIZE, num_workers=4, device="cuda", **where)))
        torch.cuda.synchronize()
        return got, bm.launch_counts(), bm.tc_launch_counts(), \
            time.perf_counter() - t0

    want, _, _, _ = serve("ckpt", checkpoint_path=reg_ckpt)
    got, counts, tc, seconds = serve("pt", checkpoint_dir=out)
    _tally(launches, counts)
    _tally(tc_launches, tc)
    n = got.shape[0]
    check(counts["band_rev_layer"] == (DEPTH - 1) * math.ceil(n / BATCH_SIZE)
          and counts["atom_readout"] == counts["molecule_readout_sorted"]
          == math.ceil(n / BATCH_SIZE), counts)
    check(got.shape == want.shape == (n, 1) and np.isfinite(got).all(),
          (got.shape, want.shape))
    check(np.array_equal(got, want),
          f".pt predictions differ from the .ckpt's: max "
          f"{np.abs(got - want).max():.3e}")
    log(f"[entry] .pt: {n} molecules served from best_model_full.pt (a "
        f"stale model_0.pt beside it), equal to the .ckpt's bit for bit, "
        f"launches {counts}, {seconds:.3f} s end to end on {card}")

    # warm start from the SSL script's shape: a frozen encoder
    frzn = os.path.join(pt_dir, "model_0.pt")
    cfg = TrainConfig(data_path=reg_csv, dataset_type="regression",
                      hidden_size=HIDDEN, depth=DEPTH, ffn_num_layers=2,
                      ffn_hidden_size=HIDDEN, epochs=1, batch_size=BATCH_SIZE,
                      seed=SEED, num_workers=4, quiet=True, device="cuda",
                      checkpoint_frzn=frzn, frzn_encoder=True,
                      save_dir=os.path.join(out, "warm"))
    bm.reset_launch_counts()
    score, _ = cross_validate(cfg)
    counts = bm.launch_counts()
    _tally(launches, counts)
    _tally(tc_launches, bm.tc_launch_counts())
    check(np.isfinite(score) and counts["band_rev_bwd"] > 0, counts)
    _check_frozen(os.path.join(cfg.save_dir, "fold_0", "model_0",
                               "best_model.ckpt"), frzn, ".pt checkpoint_frzn")
    log(f"[entry] .pt: 1-epoch cross_validate from checkpoint_frzn "
        f"model_0.pt (SSL script shape, frozen encoder unchanged bit for "
        f"bit): test rmse {score:.6f}, launches {counts}")


def tensorboard_profile_runs(card, reg_csv, launches, tc_launches):
    """A 2-epoch run with ``tensorboard`` and ``profile_dir``, against the
    same run without either."""
    import importlib.util
    import shutil

    from polymer_chemprop_tpu_torch.config import TrainConfig
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    from polymer_chemprop_tpu_torch.train.cross_validate import cross_validate
    out = os.path.join(OUT_DIR, "entry", "tb")
    profile_dir = os.path.join(out, "profile")
    shutil.rmtree(out, ignore_errors=True)
    tb_importable = importlib.util.find_spec("tensorboard") is not None
    log(f"[entry] tensorboard importable: {tb_importable}")
    scores = {}
    for sub, extra in (("with", dict(tensorboard=True,
                                     profile_dir=profile_dir)),
                       ("without", {})):
        cfg = TrainConfig(data_path=reg_csv, dataset_type="regression",
                          hidden_size=HIDDEN, depth=DEPTH, ffn_num_layers=2,
                          ffn_hidden_size=HIDDEN, epochs=2,
                          batch_size=BATCH_SIZE, seed=SEED, num_workers=4,
                          quiet=True, device="cuda",
                          save_dir=os.path.join(out, sub), **extra)
        bm.reset_launch_counts()
        t0 = time.perf_counter()
        scores[sub], _ = cross_validate(cfg)
        seconds = time.perf_counter() - t0
        counts = bm.launch_counts()
        _tally(launches, counts)
        _tally(tc_launches, bm.tc_launch_counts())
        log(f"[entry] 2-epoch cross_validate {sub} tensorboard and "
            f"profile_dir: test rmse {scores[sub]!r}, {seconds:.3f} s end to "
            f"end, launches {counts} on {card}")
    check(scores["with"] == scores["without"],
          f"the profiler changed the score: {scores}")
    model_dir = os.path.join(out, "with", "fold_0", "model_0")
    events = [f for f in os.listdir(model_dir)
              if f.startswith("events.out.tfevents")]
    check(bool(events) == tb_importable, f"event files {events}")
    traces = sorted(os.listdir(profile_dir))
    check(len(traces) == 1, f"traces {traces}")
    with open(os.path.join(profile_dir, traces[0])) as f:
        trace = json.load(f)["traceEvents"]
    kernels = {e.get("name", "") for e in trace
               if str(e.get("cat", "")).lower() == "kernel"}
    named = {k: sum(k in name for name in kernels) for k in
             ("band_rev_layer", "band_rev_bwd", "atom_readout")}
    check(all(named.values()),
          f"the trace names no kernel of rows 1-3: {sorted(kernels)[:20]}")
    log(f"[entry] profile_dir trace {traces[0]}: {len(kernels)} distinct "
        f"kernels, rows 1-3 named {named}; scores with and without equal "
        f"bit for bit; {len(events)} TensorBoard event file(s)")


def ssl_runs(card, poly_csv, poly_train_csv, launches, tc_launches):
    """``ssl_pretrain`` on the card, its first masked step against the
    CPU, a stage-1 epoch's rate and idle share, and the transfer into a
    frozen encoder."""
    import shutil

    from polymer_chemprop_tpu_torch import ssl as ssl_mod
    from polymer_chemprop_tpu_torch.config import TrainConfig
    from polymer_chemprop_tpu_torch.data import MoleculeDataLoader
    from polymer_chemprop_tpu_torch.models.encoder import batch_to_tensors
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    from polymer_chemprop_tpu_torch.train.cross_validate import cross_validate
    out = os.path.join(OUT_DIR, "entry", "ssl")
    shutil.rmtree(out, ignore_errors=True)
    cfg = ssl_mod.SSLConfig(
        data_path=poly_csv, save_dir=out, hidden_size=HIDDEN, depth=DEPTH,
        epochs_stage1=2, epochs_stage2=2, batch_size=BATCH_SIZE,
        val_frac=0.1, save_graph_embeddings=True, seed=SEED, quiet=True,
        device="cuda")
    bm.reset_launch_counts()
    t0 = time.perf_counter()
    ckpt = ssl_mod.ssl_pretrain(cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, tc = bm.launch_counts(), bm.tc_launch_counts()
    _tally(launches, counts)
    _tally(tc_launches, tc)
    n_val = int(N_POLYMERS * cfg.val_frac)
    train_batches = math.ceil((N_POLYMERS - n_val) / BATCH_SIZE)
    val_batches = math.ceil(n_val / BATCH_SIZE)
    epochs = cfg.epochs_stage1 + cfg.epochs_stage2
    steps = epochs * train_batches
    forwards = steps + epochs * val_batches + train_batches  # + embeddings
    # every forward reads its molecules out on the gather entry: the graph
    # head's sum in the masked steps, the embeddings' readout
    check(counts["band_rev_layer"] == (DEPTH - 1) * forwards
          and counts["band_rev_bwd"] == (DEPTH - 1) * steps
          and counts["atom_readout"] == counts["molecule_readout_sorted"]
          == forwards, counts)
    # the masked steps on the FP32 entry, the embeddings at "high"
    check(tc["band_rev_layer"] == (DEPTH - 1) * train_batches, tc)
    emb = np.load(os.path.join(out, "ssl_graph_embeddings.npy"))
    check(emb.shape == (N_POLYMERS - n_val, HIDDEN)
          and np.isfinite(emb).all(), f"embeddings {emb.shape}")
    log(f"[entry] ssl_pretrain: {N_POLYMERS} copolymers ({n_val} held "
        f"out), {epochs} epochs, {steps} steps, launches {counts} "
        f"(tensor cores {tc}), {seconds:.3f} s end to end on {card}")

    # the first masked step, card against CPU, same draws and weights
    fcfg, data, _ = ssl_mod.load_ssl_data(cfg)
    labels_all = ssl_mod.molecular_weight_label(data, fcfg)
    enc_cfg = ssl_mod.ssl_encoder_config(cfg, fcfg)
    init = ssl_mod.init_ssl_model(enc_cfg, cfg.seed)
    loader = MoleculeDataLoader(data, fcfg, batch_size=BATCH_SIZE,
                                num_workers=4)
    first = next(iter(loader))
    labels = np.zeros(BATCH_SIZE, np.float32)
    labels[:first.size] = labels_all[:first.size]
    arrays = first.graph_arrays[0]
    draws = ssl_mod.draw_masks(torch.Generator().manual_seed(1),
                               arrays["f_atoms"].shape[0],
                               arrays["f_bonds"].shape[0], False)
    results, grads = {}, {}
    for device in ("cuda", "cpu"):
        model = ssl_mod.SSLModel(enc_cfg).to(device)
        model.load_state_dict(init.state_dict())
        step = ssl_mod.make_ssl_step(cfg, model)
        bm.reset_launch_counts()
        loss, gnorm = step(batch_to_tensors(arrays, device),
                           torch.as_tensor(labels, device=device),
                           {k: v.to(device) for k, v in draws.items()},
                           False)
        results[device] = (float(loss), float(gnorm))
        grads[device] = {n: p.grad.cpu() for n, p in model.named_parameters()}
        step_counts = bm.launch_counts()
        check(step_counts["band_rev_layer"] == step_counts["band_rev_bwd"]
              == (DEPTH - 1 if device == "cuda" else 0), step_counts)
    grad_err = max(((grads["cuda"][n] - g).abs().max()
                    / g.abs().max().clamp(min=1e-30)).item()
                   for n, g in grads["cpu"].items())
    log(f"[entry] ssl first masked step (loss, gnorm) gpu {results['cuda']!r}"
        f" cpu {results['cpu']!r}; gradients within {grad_err:.3e} of each "
        f"one's largest entry")
    np.testing.assert_allclose(results["cuda"], results["cpu"], rtol=1e-4)

    # a stage-1 epoch, graphs cached: rate and the device's idle share
    model = ssl_mod.SSLModel(enc_cfg).to("cuda")
    model.load_state_dict(init.state_dict())
    step = ssl_mod.make_ssl_step(cfg, model)
    gen = torch.Generator(device="cuda").manual_seed(cfg.seed)

    def epoch():
        t0 = time.perf_counter()
        _, n = ssl_mod.ssl_epoch(step, loader, labels_all, "cuda", gen,
                                 False, 1.0)
        return time.perf_counter() - t0, n

    epoch()
    wall, n = epoch()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        epoch()
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
               for e in prof.key_averages()) * 1e-6
    idle = f"idle share {100 * (1 - busy / wall):.1f}%" if busy > 0 else \
        "device busy time not measured (the profiler gave no device time)"
    log(f"[entry] ssl stage-1 epoch, graphs cached: {n} steps in "
        f"{1e3 * wall:.1f} ms ({n / wall:.1f} steps/s); device busy "
        f"{1e3 * busy:.2f} ms in the profiled epoch, {idle} on {card}")

    # the transfer: a frozen encoder, unchanged bit for bit
    tcfg = TrainConfig(data_path=poly_train_csv, dataset_type="regression",
                       polymer=True, hidden_size=HIDDEN, depth=DEPTH,
                       ffn_num_layers=2, ffn_hidden_size=HIDDEN, epochs=1,
                       batch_size=BATCH_SIZE, seed=SEED, num_workers=4,
                       quiet=True, device="cuda", checkpoint_frzn=ckpt,
                       frzn_encoder=True,
                       save_dir=os.path.join(out, "downstream"))
    bm.reset_launch_counts()
    score, _ = cross_validate(tcfg)
    counts = bm.launch_counts()
    _tally(launches, counts)
    _tally(tc_launches, bm.tc_launch_counts())
    check(np.isfinite(score), score)
    _check_frozen(os.path.join(tcfg.save_dir, "fold_0", "model_0",
                               "best_model.ckpt"), ckpt, "SSL transfer")
    log(f"[entry] ssl transfer: 1-epoch cross_validate with checkpoint_frzn "
        f"and frzn_encoder, encoder unchanged bit for bit, test rmse "
        f"{score:.6f}, launches {counts}")


def hyperopt_runs(card, reg_csv, launches, tc_launches):
    """``hyperopt`` (3 start-up trials, 1 epoch, 100 molecules) on the card
    and on the CPU: the same trials; seed 0 draws a trial of hidden 1,500,
    above the fused layer's 1,495, so rows 5 and 6 run here."""
    import shutil

    from polymer_chemprop_tpu_torch import hyperparameter_optimization as hopt
    from polymer_chemprop_tpu_torch.config import TrainConfig
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    out = os.path.join(OUT_DIR, "entry", "hyperopt")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    data = os.path.join(out, "data.csv")
    with open(reg_csv) as f:
        lines = f.readlines()[:101]
    with open(data, "w") as f:
        f.writelines(lines)
    trial_s = []
    cross_validate = hopt.cross_validate

    def timed(cfg):
        t0 = time.perf_counter()
        result = cross_validate(cfg)
        if cfg.device == "cuda":
            torch.cuda.synchronize()
        trial_s.append((cfg.device, cfg.hidden_size, cfg.depth,
                        time.perf_counter() - t0))
        return result

    hopt.cross_validate = timed
    trials = {}
    try:
        for device in ("cuda", "cpu"):
            cfg = TrainConfig(data_path=data, dataset_type="regression",
                              epochs=1, seed=SEED, batch_size=BATCH_SIZE,
                              num_workers=4, quiet=True, device=device,
                              save_dir=os.path.join(out, device))
            bm.reset_launch_counts()
            hopt.hyperopt(cfg, num_iters=3)
            counts = bm.launch_counts()
            if device == "cuda":
                _tally(launches, counts)
                _tally(tc_launches, bm.tc_launch_counts())
                cuda_counts = counts
            trials[device] = [t["params"] for t in hopt.load_trials(
                os.path.join(cfg.save_dir, "hyperopt_trials"))]
    finally:
        hopt.cross_validate = cross_validate
    check(len(trials["cuda"]) == 3 and trials["cuda"] == trials["cpu"],
          f"trials differ: {trials}")
    check(any(p["hidden_size"] > 1495 for p in trials["cuda"]),
          "no trial wider than the fused layer")
    check(all(cuda_counts[k] > 0 for k in ("band_agg", "band_bwd",
                                           "band_rev_layer", "band_rev_bwd",
                                           "atom_readout")), cuda_counts)
    for device, hidden, depth, seconds in trial_s:
        log(f"[entry] hyperopt trial on {device}: hidden {hidden}, depth "
            f"{depth}, {seconds:.3f} s (1 epoch, 100 molecules)"
            + (f" on {card}" if device == "cuda" else ""))
    log(f"[entry] hyperopt: trials equal on card and CPU {trials['cuda']}; "
        f"card launches {cuda_counts}")


def interpret_runs(card, launches, tc_launches):
    """Train a classifier (2 epochs), then interpret 5 molecules with
    rollout 20 on the card and on the CPU."""
    import shutil

    from polymer_chemprop_tpu_torch import interpret as interp
    from polymer_chemprop_tpu_torch.config import PredictConfig, TrainConfig
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    from polymer_chemprop_tpu_torch.train.cross_validate import cross_validate
    out = os.path.join(OUT_DIR, "entry", "interpret")
    shutil.rmtree(out, ignore_errors=True)
    cls_csv = os.path.join(ROOT, "tests", "data", "classification.csv")
    cfg = TrainConfig(data_path=cls_csv, dataset_type="classification",
                      hidden_size=HIDDEN, depth=DEPTH, ffn_num_layers=2,
                      ffn_hidden_size=HIDDEN, epochs=2, batch_size=BATCH_SIZE,
                      seed=SEED, num_workers=4, quiet=True, device="cuda",
                      save_dir=os.path.join(out, "train"))
    bm.reset_launch_counts()
    score, _ = cross_validate(cfg)
    counts = bm.launch_counts()
    _tally(launches, counts)
    _tally(tc_launches, bm.tc_launch_counts())
    check(np.isfinite(score), score)
    test_csv = os.path.join(out, "interpret.csv")
    with open(test_csv, "w") as f:
        f.write("smiles\n" + "\n".join(read_smiles(cls_csv)[:5]) + "\n")
    calls = [0]
    make_predictions = interp.make_predictions

    def counted(*args, **kwargs):
        calls[0] += 1
        return make_predictions(*args, **kwargs)

    interp.make_predictions = counted
    results = {}
    try:
        for device in ("cuda", "cpu"):
            calls[0] = 0
            bm.reset_launch_counts()
            t0 = time.perf_counter()
            results[device] = interp.interpret(
                PredictConfig(checkpoint_dir=cfg.save_dir, device=device),
                test_csv, property_id=1, rollout=20, prop_delta=0.0,
                writer=lambda line: None)
            seconds = time.perf_counter() - t0
            if device == "cuda":
                counts = bm.launch_counts()
                _tally(launches, counts)
                _tally(tc_launches, bm.tc_launch_counts())
                check(counts["band_rev_layer"] > 0, counts)
            log(f"[entry] interpret on {device}: 5 molecules, rollout 20, "
                f"{seconds / 5:.3f} s per molecule, {calls[0]} "
                f"make_predictions calls"
                + (f", launches {counts} on {card}" if device == "cuda"
                   else ""))
    finally:
        interp.make_predictions = make_predictions
    got, want = results["cuda"], results["cpu"]
    check(len(got) == len(want) == 5, (got, want))
    np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want],
                               rtol=1e-4)
    same = [g[2] == w[2] for g, w in zip(got, want)]
    log(f"[entry] interpret: scores within 1e-4 of the CPU's; rationales "
        f"equal for {sum(same)} of 5: {[r[2] for r in got]}")


def web_runs(card, reg_csv, launches, tc_launches):
    """The web app on the card: upload, train 2 epochs and predict 10
    SMILES through HTTP."""
    import http.client
    import re
    import shutil
    import threading
    from http.server import ThreadingHTTPServer

    from polymer_chemprop_tpu_torch.config import PredictConfig
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    from polymer_chemprop_tpu_torch.train.make_predictions import (
        make_predictions,
    )
    from polymer_chemprop_tpu_torch.web.app import build_app
    root = os.path.join(OUT_DIR, "entry", "web")
    shutil.rmtree(root, ignore_errors=True)
    handler, state = build_app(root)
    check(state.device == "cuda", state.device)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port = srv.server_address[1]

    def request(method, path, fields=None):
        body, headers = None, {}
        if fields is not None:
            parts = [f"--XxX\r\nContent-Disposition: form-data; "
                     f'name="{k}"\r\n\r\n'.encode()
                     + (v if isinstance(v, bytes) else str(v).encode())
                     + b"\r\n" for k, v in fields.items()]
            body = b"".join(parts) + b"--XxX--\r\n"
            headers["Content-Type"] = "multipart/form-data; boundary=XxX"
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        return resp.status, data

    smiles = read_smiles(reg_csv)[:10]
    try:
        bm.reset_launch_counts()
        t0 = time.perf_counter()
        with open(reg_csv, "rb") as f:
            status, _ = request("POST", "/upload_data", {
                "name": "regression", "class": "regression",
                "file": f.read()})
        check(status == 303, f"upload: HTTP {status}")
        ds = state.db.datasets()[0]
        status, body = request("POST", "/train", {
            "dataset_id": ds["id"], "ckpt_name": "smoke",
            "dataset_type": "regression", "epochs": 2})
        check(status == 200, f"train: HTTP {status}")
        ckpt_id = json.loads(body)["ckpt_id"]
        while True:
            status, body = request("GET", f"/progress/{ckpt_id}")
            progress = json.loads(body)
            if progress["state"] == "error":
                raise RuntimeError(f"web training failed: {progress}")
            if progress["state"] == "done":
                break
            time.sleep(0.5)
        train_s = time.perf_counter() - t0
        status, body = request("POST", "/predict", {
            "ckpt_id": ckpt_id, "smiles": "\n".join(smiles)})
        check(status == 200, f"predict: HTTP {status}")
        counts = bm.launch_counts()
        _tally(launches, counts)
        _tally(tc_launches, bm.tc_launch_counts())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()
    cells = re.findall(r"<td>\[([^\]]*)\]</td>", body.decode())
    got = [[float(x) for x in c.split(",")] for c in cells]
    want = make_predictions(PredictConfig(
        checkpoint_dir=state.db.ckpt(ckpt_id)["save_dir"], device="cuda"),
        smiles=[[s] for s in smiles])
    check(len(got) == 10 and got == want,
          f"web predictions differ from make_predictions: {got} {want}")
    check(counts["band_rev_bwd"] > 0 and counts["band_rev_layer"] > 0,
          counts)
    log(f"[entry] web: upload + 2-epoch training through HTTP in "
        f"{train_s:.3f} s (mean score {progress['mean_score']:.6f}); 10 "
        f"SMILES predicted through HTTP equal make_predictions bit for bit; "
        f"launches {counts} on {card}")


def entry_points_path(card):
    """Phase 9: the remaining entry points on the card at full width
    (hidden 300, depth 3, FFN 2 x 300, relu, mean, batch 50, C++
    featurizer), in torch's default mode: every float sum of the port
    runs in a fixed order, so two card runs compare bit for bit. Returns
    the launches and the tensor-core launches."""
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    t0 = time.perf_counter()
    launches = dict.fromkeys(bm.launch_counts(), 0)
    tc_launches = dict.fromkeys(bm.tc_launch_counts(), 0)
    reg_csv = os.path.join(ROOT, "tests", "data", "regression.csv")
    poly_csv = os.path.join(OUT_DIR, "polymers.csv")
    poly_train_csv = os.path.join(OUT_DIR, "polymers_train.csv")
    polymer_csv(poly_csv)
    polymer_csv(poly_train_csv, with_target=True)
    reg_ckpt = os.path.join(OUT_DIR, "entry", "regression", "model.ckpt")
    write_checkpoint(reg_ckpt, polymer=False, hidden=HIDDEN)
    pt_runs(card, reg_csv, reg_ckpt, launches, tc_launches)
    tensorboard_profile_runs(card, reg_csv, launches, tc_launches)
    ssl_runs(card, poly_csv, poly_train_csv, launches, tc_launches)
    hyperopt_runs(card, reg_csv, launches, tc_launches)
    interpret_runs(card, launches, tc_launches)
    web_runs(card, reg_csv, launches, tc_launches)
    log(f"[entry] phase 9 launches {launches} (tensor cores {tc_launches}), "
        f"{time.perf_counter() - t0:.1f} s")
    return launches, tc_launches


# -- phase 10 ---------------------------------------------------------------

PAR_STEPS, PAR_LR = 3, 0.01      # SGD steps held against one rank
PAR_EPOCHS = 3                   # cli train under torchrun
PAR_TIMEOUT = 300                # seconds a launch may take
PAR_DEVICE = "cuda"              # every rank's device (a rehearsal: "cpu")
CARDS = 4                        # --cards: ranks, one a card (2-D: 2 x 2)


def par_model(dev, atom_messages=False):
    """The full-width model of phase 10 (hidden 300, depth 3, FFN 2 x 300,
    relu, mean, FP32 layer), weights from SEED: the same on every rank."""
    from polymer_chemprop_tpu_torch.models.encoder import EncoderConfig
    from polymer_chemprop_tpu_torch.models.init import init_model
    from polymer_chemprop_tpu_torch.models.model import (ModelConfig,
                                                        MoleculeModel)
    enc = EncoderConfig(atom_fdim=133, bond_fdim=14 if atom_messages
                        else 147, hidden_size=HIDDEN, depth=DEPTH,
                        atom_messages=atom_messages,
                        band_precision="highest")
    cfg = ModelConfig(encoder=enc, dataset_type="regression", num_tasks=1,
                      ffn_hidden_size=HIDDEN)
    model = init_model(MoleculeModel(cfg),
                       torch.Generator().manual_seed(SEED))
    return model.to(dev)


def par_loader(batch_size, sorted_aux=True):
    """The shuffled training loader of regression.csv (split and target
    scaling as the trainer's, seed SEED): one order whatever the batch
    size, so ``k`` batches of 25 are the molecules of ``k / 2`` of 50."""
    from polymer_chemprop_tpu_torch.data import (MoleculeDataLoader,
                                                  get_data, split_data)
    from polymer_chemprop_tpu_torch.features import FeaturizationConfig
    data = get_data(os.path.join(ROOT, "tests", "data", "regression.csv"))
    train, _, _ = split_data(data, "random", (0.8, 0.1, 0.1), SEED)
    train.normalize_targets()
    return MoleculeDataLoader(train, FeaturizationConfig(),
                              batch_size=batch_size, shuffle=True, seed=SEED,
                              num_workers=4, sorted_aux=sorted_aux)


def par_first(batch_size, n, sorted_aux=True):
    import itertools
    loader = par_loader(batch_size, sorted_aux)
    return list(itertools.islice(iter(loader), n)), loader


def sgd(model):
    """``(optimizer, schedule)``: SGD at PAR_LR."""
    from polymer_chemprop_tpu_torch.train.scheduler import (
        build_optimizer, constant_schedule)
    return (build_optimizer("sgd", model.parameters()),
            constant_schedule(PAR_LR))


def param_sha(model) -> str:
    import hashlib
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def reference_steps(dev, batches, atom_messages=False):
    """PAR_STEPS single-device SGD steps on ``batches``: the model, and each
    step's loss and gradient norm."""
    from polymer_chemprop_tpu_torch.train.step import (TrainStep,
                                                       batch_tensors,
                                                       make_loss_fn)
    ref = par_model(dev, atom_messages)
    step = TrainStep(ref, *sgd(ref), make_loss_fn(ref.cfg))
    out = [step(batch_tensors(b, dev) if hasattr(b, "graph_arrays") else b)
           for b in batches[:PAR_STEPS]]
    return ref, [(float(l), float(g)) for l, g in out]


def rank_dp(dev, rank, out, n=2):
    """dp at ``n`` ranks: PAR_STEPS steps on the first training batches,
    each rank one micro-batch of 25 of each batch of 25 n, against one
    rank on the batches of 25 n, run twice from the seed (both runs'
    parameter SHA-256); then a cached dp epoch's steps/s and the step's
    gradient all-reduce alone."""
    from polymer_chemprop_tpu_torch import multichip as mc
    from polymer_chemprop_tpu_torch.parallel import (make_dp_train_step,
                                                     make_mesh)
    from polymer_chemprop_tpu_torch.parallel.mesh import all_reduce_sum
    from polymer_chemprop_tpu_torch.train.step import batch_tensors
    mesh = make_mesh(n, ("dp",))
    micro = par_first(25, n * PAR_STEPS)[0]
    shas = []
    for _ in range(2):
        model = par_model(dev)
        step = make_dp_train_step(model, *sgd(model), mesh)
        out["dp_steps"] = [
            [float(x) for x in step([batch_tensors(micro[n * k + rank],
                                                   dev)])]
            for k in range(PAR_STEPS)]
        shas.append(param_sha(model))
    out["dp_sha"], out["dp_sha_repeat"] = shas
    if rank == 0:
        ref, out["dp_ref_steps"] = reference_steps(dev, par_first(
            25 * n, PAR_STEPS)[0])
        out["dp_rel_err"] = mc.param_errors(model.parameters(),
                                            ref.parameters())
    # a cached epoch at batch 50, a micro-batch of ceil(50 / n) a rank (the
    # trainer's split), and on one card (rank 0, the others waiting)
    loader = par_loader(math.ceil(50 / n))
    out["dp_epoch"] = cached_epoch(
        lambda: loader.iter_rank(rank, n),
        lambda b: step([batch_tensors(b, dev)]))
    if rank == 0:
        from polymer_chemprop_tpu_torch.train.step import (TrainStep,
                                                           make_loss_fn)
        one = TrainStep(ref, *sgd(ref), make_loss_fn(ref.cfg))
        out["one_card_epoch"] = cached_epoch(
            par_loader(50).__iter__, lambda b: one(batch_tensors(b, dev)))
    # the step's gradient all-reduce alone: every parameter and the loss
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()]
                     + [torch.zeros(1, device=dev)])

    def reduce():
        all_reduce_sum(flat, mesh.group("dp"))

    out["allreduce"] = (flat.numel(),
                        mc.synced_ms(reduce, PAR_DEVICE, 20, warm=3),
                        mc.back_to_back_ms(reduce, PAR_DEVICE))


def cached_epoch(batches, step):
    """``(steps, seconds)`` of the second of two epochs of ``step`` over
    ``batches()`` (the first featurizes and warms up), synced."""
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = 0
        for b in batches():
            step(b)
            steps += 1
        torch.cuda.synchronize()
    return steps, time.perf_counter() - t0


def rank_gp_epoch(dev, rank, out, n=2):
    """A cached gp epoch (ep ``n``, the strip exchange) on regression.csv's
    batches of 50, host partitioning included."""
    from polymer_chemprop_tpu_torch.parallel import (
        build_edge_shards_halo_dp, make_halo_dp_train_step, make_mesh)
    from polymer_chemprop_tpu_torch.train.step import batch_pytree
    mesh = make_mesh(n, ("dp", "ep"), shape=(1, n))
    loader = par_loader(50, sorted_aux=False)
    model = par_model(dev)
    step = make_halo_dp_train_step(model, *sgd(model), mesh,
                                   overlap=True)
    aw = (loader.estimated_pad_atoms() + 7) // 8 * 8

    def run(b):
        t = batch_pytree(b)
        sh, rep = build_edge_shards_halo_dp([t["graphs"]], n, aw)
        step(sh, rep, t["targets"][None], t["mask"][None],
             t["weights"][None])

    out["gp_epoch"] = cached_epoch(loader.__iter__, run)
    # one more step under the profiler: the operators it ran
    from torch.profiler import ProfilerActivity, profile
    b = next(iter(loader))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(b)
    out["gp_index_add"] = sum(e.count for e in prof.key_averages()
                              if "index_add" in e.key)


def rank_forwards(dev, rank, out, arrays, n=2):
    """The four edge-parallel forwards at ep ``n`` on the bench batch
    against the single-device encoder; the halo exchange's ms per
    layer."""
    from polymer_chemprop_tpu_torch.models.encoder import batch_to_tensors
    from polymer_chemprop_tpu_torch import parallel as tpar
    from polymer_chemprop_tpu_torch.multichip import exchange_ms
    from polymer_chemprop_tpu_torch.ops.sorted_aux import sorted_batch
    enc = par_model(dev).encoders[0]
    cfg = enc.cfg
    single = sorted_batch(arrays)
    mesh = tpar.make_mesh(n, ("ep",))
    with torch.no_grad():
        want = enc(batch_to_tensors(single, dev))
        got = {}
        sh, rep = tpar.build_edge_shards(arrays, n)
        got["psum"] = tpar.make_edge_parallel_forward(cfg, mesh)(enc, sh,
                                                                 rep)
        sh, rep = tpar.build_edge_shards_halo(arrays, n)
        got["halo"] = tpar.make_edge_parallel_forward_halo(cfg, mesh)(
            enc, sh, rep)
        shb, repb = tpar.build_edge_shards_halo_band(arrays, n)
        got["band"] = tpar.make_edge_parallel_forward_halo_band(cfg, mesh)(
            enc, shb, repb)
        sw = tpar.halo_strip_width(sh)
        got["overlap"] = tpar.make_edge_parallel_forward_halo_overlap(
            cfg, mesh, sw)(enc, sh, rep)
    out["forwards"] = {
        k: [float((v - want).abs().max()),
            bool(((v - want).abs() <= 1e-5 + 1e-4 * want.abs()).all())]
        for k, v in got.items()}
    out["overlap_vs_halo"] = float((got["overlap"] - got["halo"]).abs()
                                   .max())
    # the exchange alone at the bench window: a layer's whole-window
    # combine, and its strip form (post, then wait)
    ex = exchange_ms(sh, rep, mesh, "ep", HIDDEN, dev)
    out["halo_ms"], out["strip_ms"] = ex["whole_ms"], ex["strip_ms"]
    out["halo_ms_b2b"] = ex["whole_ms_back_to_back"]
    out["strip_ms_b2b"] = ex["strip_ms_back_to_back"]
    out["window"] = (ex["window"], ex["strip_width"],
                     int(sh["f_bonds"].shape[1]))


def rank_2d(dev, rank, out):
    """The 2-D halo step (dp 2 x ep 2) with bond and atom messages:
    PAR_STEPS steps, each on two batches of 50 (one a dp row), against one
    rank on the batches of 100, each run twice from the seed (both runs'
    parameter SHA-256)."""
    from polymer_chemprop_tpu_torch.multichip import param_errors
    from polymer_chemprop_tpu_torch.parallel import (
        build_edge_shards_halo_dp, make_halo_dp_train_step, make_mesh)
    from polymer_chemprop_tpu_torch.train.step import batch_pytree
    mesh = make_mesh(4, ("dp", "ep"), shape=(2, 2))
    batches, loader = par_first(50, 2 * PAR_STEPS, sorted_aux=False)
    aw = (loader.estimated_pad_atoms() + 7) // 8 * 8
    refs = par_first(100, PAR_STEPS)[0] if rank == 0 else None
    for am in (False, True):
        key = "atom_messages" if am else "bonds"
        shas = []
        for _ in range(2):
            model = par_model(dev, am)
            step = make_halo_dp_train_step(model, *sgd(model), mesh)
            steps = []
            for k in range(PAR_STEPS):
                trees = [batch_pytree(b) for b in batches[2 * k:2 * k + 2]]
                sh, rep = build_edge_shards_halo_dp(
                    [t["graphs"] for t in trees], 2, aw)
                stack = lambda f: np.stack([t[f] for t in trees])
                steps.append([float(x) for x in step(
                    sh, rep, stack("targets"), stack("mask"),
                    stack("weights"))])
            shas.append(param_sha(model))
        out[f"{key}_steps"] = steps
        out[f"{key}_sha"], out[f"{key}_sha_repeat"] = shas
        if rank == 0:
            ref, out[f"{key}_ref_steps"] = reference_steps(dev, refs, am)
            out[f"{key}_rel_err"] = param_errors(model.parameters(),
                                                 ref.parameters())


def rank_bench_steps(dev, rank, out, arrays, n):
    """The bench batch's training steps at ``n`` ranks: the 1-D halo step
    at ep ``n`` on the whole batch, and the 2-D step (dp 2 x ep n/2), each
    dp row on one half (512 molecules); PAR_STEPS SGD steps each, run
    twice from the seed (both runs' parameter SHA-256), against one rank's
    steps on the whole batch (the loss of either is the masked mean over
    all 1,024 molecules). Then each step's synced median ms at ``n`` ranks
    (each call builds its shard's CSR on the host and copies the shard),
    and on rank 0 one card's step on the whole batch (each call copies the
    sorted batch); and the real bonds of each ep-``n`` shard."""
    from polymer_chemprop_tpu_torch.features import mol2graph
    from polymer_chemprop_tpu_torch.multichip import param_errors, synced_ms
    from polymer_chemprop_tpu_torch.ops.sorted_aux import sorted_batch
    from polymer_chemprop_tpu_torch.parallel import (
        build_edge_shards_halo, build_edge_shards_halo_dp,
        make_halo_dp_train_step, make_halo_train_step, make_mesh)
    from polymer_chemprop_tpu_torch.train.step import (TrainStep,
                                                       make_loss_fn,
                                                       pytree_tensors)
    M = arrays["degree_of_polym"].shape[0]
    targets = np.random.default_rng(SEED).normal(size=(M, 1)).astype(
        np.float32)
    ones = np.ones_like(targets)
    smiles = bench_smiles(M)
    halves = [mol2graph(smiles[:M // 2]), mol2graph(smiles[M // 2:])]
    pads = dict(pad_atoms=max(g.f_atoms.shape[0] for g in halves),
                pad_bonds=max(g.f_bonds.shape[0] for g in halves),
                pad_mols=M // 2)
    halves = [mol2graph(smiles[:M // 2], **pads).arrays(),
              mol2graph(smiles[M // 2:], **pads).arrays()]
    n_ep = n // 2
    aw = max(build_edge_shards_halo(h, n_ep)[0]["f_atoms_win"].shape[1]
             for h in halves)
    sh2, rep2 = build_edge_shards_halo_dp(halves, n_ep, aw)
    t2, m2 = targets.reshape(2, M // 2, 1), ones.reshape(2, M // 2, 1)
    sh1, rep1 = build_edge_shards_halo(arrays, n)
    out["bench_real_bonds"] = [
        int(k) for k in (np.abs(sh1["f_bonds"]).sum(-1) > 0).sum(1)]
    mesh1 = make_mesh(n, ("ep",))
    mesh2 = make_mesh(n, ("dp", "ep"), shape=(2, n_ep))
    params = {}
    for key in ("halo", "2d"):
        shas = []
        for _ in range(2):
            model = par_model(dev)
            if key == "halo":
                step = make_halo_train_step(model, *sgd(model), mesh1)
                call = lambda: step(sh1, rep1, targets, ones, ones)
            else:
                step = make_halo_dp_train_step(model, *sgd(model), mesh2)
                call = lambda: step(sh2, rep2, t2, m2, m2)
            steps = [[float(x) for x in call()] for _ in range(PAR_STEPS)]
            shas.append(param_sha(model))
        out[f"bench_{key}_steps"] = steps
        out[f"bench_{key}_sha"], out[f"bench_{key}_sha_repeat"] = shas
        params[key] = [p.detach().clone() for p in model.parameters()]
        torch.distributed.barrier()
        out[f"bench_{key}_ms"] = synced_ms(call, PAR_DEVICE, 10, warm=2)
    if rank == 0:
        batch = {"graphs": [sorted_batch(arrays)], "targets": targets,
                 "mask": ones, "weights": ones}
        ref, out["bench_ref_steps"] = reference_steps(
            dev, [pytree_tensors(batch, dev)] * PAR_STEPS)
        for key in ("halo", "2d"):
            out[f"bench_{key}_rel_err"] = param_errors(params[key],
                                                       ref.parameters())
        one = TrainStep(ref, *sgd(ref), make_loss_fn(ref.cfg))
        out["bench_one_card_ms"] = synced_ms(
            lambda: one(pytree_tensors(batch, dev)), PAR_DEVICE, 10, warm=2)


def rank_main(argv) -> int:
    """One rank of a phase-10 or four-card launch: ``chip_smoke.py
    --parallel-rank TASK OUT_DIR [cli arguments]`` under torchrun. Writes
    its results, its backend and card, and its kernel launch counts (all
    of them: this process runs the main path only) to
    ``OUT_DIR/rank<r>.json``."""
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    from polymer_chemprop_tpu_torch.parallel import initialize_multihost
    from polymer_chemprop_tpu_torch.parallel.mesh import world
    from polymer_chemprop_tpu_torch.parallel.multihost import rank_device
    warnings.filterwarnings("ignore", message="sum of weights of incoming")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    task, out_dir = argv[0], argv[1]
    out = {"task": task}
    if task == "cli":
        from polymer_chemprop_tpu_torch import cli
        bm.reset_launch_counts()
        cli.main(["train", *argv[2:]])
        rank = int(os.environ["RANK"])
    else:
        out["backend"] = initialize_multihost(device=PAR_DEVICE)
        rank, n = world()
        dev = rank_device(PAR_DEVICE)
        out["device"] = str(dev)
        bm.reset_launch_counts()
        arrays = dict(np.load(os.path.join(OUT_DIR, "bench_arrays.npz")))
        if task == "ranks2":
            rank_dp(dev, rank, out)
            rank_forwards(dev, rank, out, arrays)
            rank_gp_epoch(dev, rank, out)
        elif task == "ranks4":
            rank_2d(dev, rank, out)
        else:                               # "cards": one rank a card
            rank_dp(dev, rank, out, n)
            rank_forwards(dev, rank, out, arrays, n)
            rank_bench_steps(dev, rank, out, arrays, n)
            rank_gp_epoch(dev, rank, out, n)
            rank_2d(dev, rank, out)
        torch.distributed.destroy_process_group()
    out["launches"] = bm.launch_counts()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def torchrun(n, out_dir, *argv, env=None):
    """Start ``n`` ranks of ``argv`` (a script and its arguments, or ``-m``
    and a module) with ``torchrun --standalone``, output to
    ``out_dir/log.txt``; ``env`` adds to the environment."""
    os.makedirs(out_dir, exist_ok=True)
    log_file = open(os.path.join(out_dir, "log.txt"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(n), *argv],
        cwd=ROOT, env=dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT,
                           **(env or {})),
        stdout=log_file, stderr=subprocess.STDOUT)
    proc.log_file = log_file
    proc.out_dir, proc.n = out_dir, n
    return proc


def rank_task(n, task, out_dir, *args):
    """``n`` ranks of this script's ``task`` (:func:`rank_main`)."""
    return torchrun(n, out_dir, os.path.join(ROOT, "chip_smoke.py"),
                    "--parallel-rank", task, out_dir, *args)


def multichip_launch(n, out_dir, env=None):
    """``n`` ranks of ``polymer_chemprop_tpu_torch.multichip``."""
    return torchrun(n, out_dir, "-m", "polymer_chemprop_tpu_torch.multichip",
                    "--out", os.path.join(out_dir, "summary.json"), env=env)


def launch_done(proc):
    """Wait for a launch; a failed one prints its log's tail and raises."""
    try:
        rc = proc.wait(timeout=PAR_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    proc.log_file.close()
    if rc != 0:
        with open(os.path.join(proc.out_dir, "log.txt")) as f:
            log(f.read()[-6000:])
        raise RuntimeError(f"chip_smoke: the launch in {proc.out_dir} "
                           f"failed ({rc})")


def rank_results(proc):
    """Wait for a launch; its ranks' results, rank order."""
    launch_done(proc)
    results = []
    for r in range(proc.n):
        with open(os.path.join(proc.out_dir, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def placement(n, one_card):
    """``(backend, devices, words)`` that ``n`` ranks must report: all on
    the one card, so gloo by the backend rule, or one a card, so NCCL on
    cuda:0 to cuda:n-1 (a rehearsal on the CPU: gloo, every rank on the
    CPU); the devices sorted."""
    if PAR_DEVICE != "cuda":
        backend, devices = "gloo", ["cpu"] * n
    elif one_card:
        backend, devices = "gloo", ["cuda:0"] * n
    else:
        backend, devices = "nccl", [f"cuda:{r}" for r in range(n)]
    return backend, devices, (f"{n} ranks sharing one card" if one_card
                              else f"{n} cards, one rank a card")


def multichip_summary(proc, one_card):
    """Wait for a ``multichip`` launch; its summary, after the checks that
    every rank took the backend and card of its :func:`placement`."""
    backend, expect, what = placement(proc.n, one_card)
    launch_done(proc)
    with open(os.path.join(proc.out_dir, "summary.json")) as f:
        summary = json.load(f)
    with open(os.path.join(proc.out_dir, "log.txt")) as f:
        # NCCL_DEBUG=INFO names the transport of every channel it sets up
        via = sorted(set(re.findall(r" via (\S+)", f.read())))
    if via:
        log(f"[parallel] NCCL's channels at {proc.n} ranks go via "
            f"{', '.join(via)}")
    ranks = summary["ranks"]
    devices = [r["device"] for r in ranks]
    check(summary["ok"] and len(ranks) == proc.n,
          f"multichip.py at {proc.n} ranks ({what})")
    check(all(r["backend"] == backend for r in ranks)
          and sorted(devices) == expect,
          f"multichip.py ranks must take {backend} on {expect} ({what}): "
          f"{ranks}")
    log(f"[parallel] multichip.py at {proc.n} ranks, {what}: every check "
        f"passed ({', '.join(summary['checks'])}); rank devices {devices}")
    log(f"[parallel] multichip.py {proc.n} ranks ({backend}; synced, back "
        f"to back): halo exchange a layer at the bench-scale window "
        f"(Aw={summary['atom_window']}, H={summary['bench_hidden']}, "
        f"{summary['bench_bonds_per_shard']} bond rows a shard, of them "
        f"real {summary['bench_real_bonds_per_shard']}): "
        f"whole window {summary['halo_exchange_ms_per_layer']:.4f}, "
        f"{summary['halo_exchange_ms_per_layer_back_to_back']:.4f} ms, "
        f"strips of {summary['bench_strip_width']} rows "
        f"{summary['strip_exchange_ms_per_layer']:.4f}, "
        f"{summary['strip_exchange_ms_per_layer_back_to_back']:.4f} ms; "
        f"gradient all-reduce ({summary['dp_allreduce_floats']} floats) "
        f"{summary['dp_allreduce_ms']:.4f}, "
        f"{summary['dp_allreduce_ms_back_to_back']:.4f} ms; the bench-scale "
        f"gp step "
        f"{summary['bench_gp_step_ms']:.3f} ms at {proc.n} ranks, one card "
        f"{summary['bench_single_step_ms']:.3f} ms; loss "
        f"{summary['bench_halo_loss']:.6f} (one card "
        f"{summary['bench_single_loss']:.6f}, elementwise param rel err "
        f"{summary['bench_max_param_rel_err']:.2e}); init_process_group "
        f"{summary['init_ms']:.0f} ms, first dp step "
        f"{summary['dp_first_step_ms']:.0f} ms, first halo step "
        f"{summary['halo_first_step_ms']:.0f} ms"
        + (f", first 2-D step (its mesh lines' groups new) "
           f"{summary['2d_unoverlapped_first_step_ms']:.0f} ms, the next "
           f"{summary['2d_overlap_first_step_ms']:.0f} ms"
           if "mesh_2d" in summary else ""))
    return summary


def host_partition_ms(gb, reps=5) -> float:
    """Median host ms of the ep-2 partition of the bench batch: the
    windows (``build_edge_shards_halo``), then each shard's dst-sorted CSR
    and molecule CSR, as a gp step builds them (numpy, one thread)."""
    from polymer_chemprop_tpu_torch.ops.sorted_aux import build_molecule_csr
    from polymer_chemprop_tpu_torch.parallel import partition
    arrays = gb.arrays()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sh, rep = partition.build_edge_shards_halo(arrays, 2)
        for s in range(2):
            one = partition.shard_csr(partition._take(sh, s))
            own_w = one["w_atoms_win"] * one["own_mask"]
            build_molecule_csr(one["a2mol_win"], own_w,
                               rep["degree_of_polym"].shape[0],
                               rows=np.nonzero(own_w != 0)[0])
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def shard_kernel_checks(bm, results, dev, gb, n=2):
    """Rows 3, 3a and 3b at the shapes a shard of the bench batch gives
    them (ep ``n``, shard 0's window CSR) against their plain versions: the
    aggregation, the atom_messages neighbour sum and readout over the
    window table, and the gather's VJP (the gather entry over bond rows
    with index srev). Not counted: the counts are reset after."""
    from polymer_chemprop_tpu_torch.parallel import partition
    sh, rep = partition.build_edge_shards_halo(gb.arrays(), n)
    t = partition._prepare_halo(partition._take(sh, 0), rep, dev)
    rp, w, src, srev = t["rowptr"], t["w_sorted"], t["src_sorted"], t["srev"]
    gen = torch.Generator(dev).manual_seed(SEED)
    B, A1 = src.shape[0], rp.shape[0] - 1
    m = torch.randn((B, HIDDEN), device=dev, generator=gen)
    h = torch.randn((A1, HIDDEN), device=dev, generator=gen)
    aux = {"src_sorted": src, "srev": srev, "rowptr": rp, "w_sorted": w}
    cases = [("atom_readout", "aggregation", bm.atom_readout(m, w, rp),
              bm.atom_readout_plain(m, w, rp)),
             ("atom_neighbor_sum", "neighbour sum",
              bm.atom_neighbor_sum_sorted(h, aux),
              bm.atom_neighbor_sum_plain(h, src, rp)),
             ("src_readout", "readout", bm.src_readout_sorted(h, aux),
              bm.src_readout_plain(h, w, src, rp)),
             ("atom_neighbor_sum", "gather VJP (srev)",
              bm.csr_gather_sum(m, srev, None, rp),
              bm.atom_neighbor_sum_plain(m, srev, rp))]
    torch.cuda.synchronize()
    for name, what, got, plain in cases:
        err, tol = (got - plain).abs().max().item(), kernel_tolerance(plain)
        log(f"[parallel] {name} {what} at the shard shape (ep {n}) B={B} "
            f"A={A1} H={HIDDEN}: max_abs_err {err:.3e} (tol {tol:.3e})")
        check(err <= tol, f"{name} {what} disagrees with its plain version "
                          "at the shard shape")
        note_error(results, name, err)
    bm.reset_launch_counts()


def check_ranks(rs, tag, one_card, card):
    """Check and log one launch's rank results, whichever parts its task
    ran (:func:`rank_main`), for phase 10 (``one_card``) and the four-card
    phase alike: every rank's backend and card (:func:`placement`); each
    sharded step against one card (loss, and dp's gradient norm, within
    1e-4 of its size; parameters within 1e-4 of each tensor's largest
    entry, the JAX dry run's elementwise measure printed beside it); both
    runs of each and every rank one parameter SHA-256; the forwards
    (rtol 1e-4, atol 1e-5; strips against the whole window 1e-6); no
    ``index_add_`` in a gp step; then the timings."""
    r0, n = rs[0], len(rs)
    backend, devices, where = placement(n, one_card)
    check(all(r["backend"] == backend for r in rs)
          and sorted(r["device"] for r in rs) == devices,
          f"{where}: every rank must take {backend} on {devices}: "
          f"{[(r['backend'], r['device']) for r in rs]}")
    steps = [("dp", "dp", f"dp {n} ranks, a micro-batch of 25 a rank "
                          f"(one card at batch {25 * n})"),
             ("bench_halo", "bench", f"bench batch halo step ep {n}"),
             ("bench_2d", "bench", f"bench batch 2-D step dp 2 x ep {n // 2}"),
             ("bonds", "bonds", "2-D halo step (dp 2 x ep 2) bonds, training "
                                "batches (one card at batch 100)"),
             ("atom_messages", "atom_messages", "2-D halo step (dp 2 x ep 2) "
                                                "atom_messages, training "
                                                "batches")]
    for key, ref, what in steps:
        if f"{key}_steps" not in r0:
            continue
        got, want = r0[f"{key}_steps"], r0[f"{ref}_ref_steps"]
        for (l, g), (rl, rg) in zip(got, want):
            check(abs(l - rl) <= 1e-4 * abs(rl) and (
                key != "dp" or abs(g - rg) <= 1e-4 * abs(rg)),
                f"{what}: loss or gradient norm against one card")
        of_max, elem = r0[f"{key}_rel_err"]
        shas = ({r[f"{key}_sha"] for r in rs}
                | {r[f"{key}_sha_repeat"] for r in rs})
        log(f"{tag} {what}, {where} ({backend}), {PAR_STEPS} steps against "
            f"one card: losses {[round(x[0], 7) for x in got]}, one card "
            f"{[round(x[0], 7) for x in want]}; max param rel err "
            f"{of_max:.3e} of each tensor's max (elementwise {elem:.3e}); "
            f"two runs from one seed: parameters' SHA-256 "
            f"{sorted(shas)[0][:16]}" + (" both times, on every rank"
                                         if len(shas) == 1
                                         else f": {len(shas)} different"))
        check(of_max <= 1e-4, f"{what}: parameters against one card")
        check(len(shas) == 1, f"two {backend} runs of {what} from one seed "
                              "differ, or the ranks do")
    if "forwards" in r0:
        for name, (err, ok) in r0["forwards"].items():
            log(f"{tag} forward {name} ep {n} on the bench batch: max abs "
                f"err {err:.3e} against one card")
            check(ok and all(r["forwards"][name][1] for r in rs),
                  f"forward {name} outside rtol 1e-4 atol 1e-5")
        log(f"{tag} overlapped against whole-window exchange: "
            f"{r0['overlap_vs_halo']:.3e}")
        check(r0["overlap_vs_halo"] <= 1e-6, "overlap is not row-exact")
        Aw, sw, Bs = r0["window"]
        log(f"{tag} halo exchange per layer at the bench window ep {n} "
            f"(Aw={Aw}, H={HIDDEN}, {Bs} bonds a shard), {where} "
            f"({backend}; synced, back to back): whole window "
            f"{r0['halo_ms']:.4f}, {r0['halo_ms_b2b']:.4f} ms, strips of "
            f"{sw} rows {r0['strip_ms']:.4f}, {r0['strip_ms_b2b']:.4f} ms "
            f"(every rank, synced: {[round(r['halo_ms'], 4) for r in rs]} / "
            f"{[round(r['strip_ms'], 4) for r in rs]}) on {card}")
    if "bench_halo_ms" in r0:
        log(f"{tag} bench batch training step (1,024 molecules, "
            f"{r0['bench_real_bonds']} real bonds a shard at ep {n}; synced "
            f"median of 10): halo ep {n} {r0['bench_halo_ms']:.3f} ms, 2-D "
            f"dp 2 x ep {n // 2} {r0['bench_2d_ms']:.3f} ms at {where} "
            f"({backend}; every rank: "
            f"{[round(r['bench_halo_ms'], 3) for r in rs]} / "
            f"{[round(r['bench_2d_ms'], 3) for r in rs]}); one card "
            f"{r0['bench_one_card_ms']:.3f} ms, on {card}")
    if "allreduce" in r0:
        floats, ms, b2b = r0["allreduce"]
        log(f"{tag} gradient all-reduce of a dp step ({floats} floats: "
            f"every parameter and the loss), {where} ({backend}): "
            f"{ms:.4f} ms synced, {b2b:.4f} ms back to back (every rank, "
            f"synced: {[round(r['allreduce'][1], 4) for r in rs]}) on "
            f"{card}")
    for key, what in (("dp_epoch", f"dp epoch, {where}, a micro-batch of "
                                   f"{math.ceil(50 / n)} a rank"),
                      ("gp_epoch", f"gp epoch, {where}, ep {n}, the strip "
                                   "exchange"),
                      ("one_card_epoch", "epoch on one card, the other "
                                         "ranks waiting")):
        if key in r0:
            steps_, sec = r0[key]
            log(f"{tag} cached {what} (batch 50): {steps_} steps in "
                f"{1e3 * sec:.1f} ms ({steps_ / sec:.1f} steps/s) on {card}")
    if "gp_index_add" in r0:
        check(all(r["gp_index_add"] == 0 for r in rs),
              "the gp step ran index_add_ on a card")
        log(f"{tag} a gp step under the profiler: no index_add_ on any rank "
            "(aggregation, its gather VJP and the molecule readout on rows "
            "3, 3a, 3b)")


CLI_ARGS = []         # further cli train flags (a rehearsal: a size, cpu)
FELL_BACK = re.compile(r"graph_parallel: (\d+) of (\d+) batches fell back")


def cli_argv(kind, save_dir, *flags):
    """``cli train`` arguments: regression.csv, or the 200 copolymers with
    targets (``kind`` "polymer"), PAR_EPOCHS epochs, seed SEED, then
    ``flags``."""
    data = os.path.join(ROOT, "tests", "data", "regression.csv")
    if kind == "polymer":
        data = os.path.join(OUT_DIR, "polymers_train.csv")
        polymer_csv(data, with_target=True)
    return ["--data_path", data, "--dataset_type", "regression",
            "--save_dir", save_dir, "--epochs", str(PAR_EPOCHS), "--seed",
            str(SEED), "--quiet", *CLI_ARGS, *flags] + (
                ["--polymer"] if kind == "polymer" else [])


def check_cli(proc, kind, flags, one_card, ref, tag, card,
              ref_what="one card"):
    """Wait for a ``cli train`` launch (its save dir ``proc.out_dir``);
    check that its ranks took the backend and cards of their
    :func:`placement`, trained in the mode ``flags`` asks for over all of
    them, that no gp batch fell back to the single-device step (across
    cards: not every one), and that its test score is within 1e-3 of
    ``ref``, the same run on one card (``ref_what``). Returns the ranks'
    results."""
    res = rank_results(proc)
    n = proc.n
    backend, expect, where = placement(n, one_card)
    d = proc.out_dir
    with open(os.path.join(d, "log.txt")) as f:
        devices = re.findall(rf"backend {backend} \(by rule\), device "
                             r"(\S+)", f.read())
    with open(os.path.join(d, "test_scores.csv")) as f:
        score = float(next(csv.DictReader(f))["Mean rmse"])
    with open(os.path.join(d, "verbose.log")) as f:
        verbose = f.read()
    what = f"cli train {kind} {' '.join(flags)}"
    check(sorted(devices) == expect,
          f"{what}: the ranks did not take {backend} on {expect} "
          f"({devices})")
    mode = "Data" if "--data_parallel" in flags else "Graph"
    check(f"{mode}-parallel training" in verbose
          and f"over {n} devices" in verbose,
          f"{what} did not train in parallel")
    fell = ""
    if mode == "Graph":
        fallen, total = map(int, FELL_BACK.search(verbose).groups())
        check(fallen == 0 if one_card else fallen < total,
              f"{what}: {fallen} of {total} batches fell back to the "
              "single-device step")
        fell = f", {fallen} of {total} batches fell back"
    rel = abs(score - ref) / abs(ref)
    log(f"{tag} {what} under torchrun ({where}, {backend}, {PAR_EPOCHS} "
        f"epochs{fell}): test rmse {score:.6f}, {ref_what} {ref:.6f}, rel "
        f"{rel:.2e} on {card}")
    check(rel <= 1e-3, f"{what}: test score against one card")
    return res


def stop(procs) -> None:
    """Kill whatever of ``procs`` still runs."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def parallel_path(card, dev, gb, results):
    """Phase 10: parallel/ under torchrun on the card (module docstring).
    Returns the ranks' kernel launches."""
    from polymer_chemprop_tpu_torch.config import parse_train_args
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    from polymer_chemprop_tpu_torch.train.cross_validate import cross_validate
    t0 = time.perf_counter()
    shard_kernel_checks(bm, results, dev, gb)
    log(f"[parallel] host partition of the bench batch for ep 2 (windows, "
        f"2 shard CSRs, 2 molecule CSRs): {host_partition_ms(gb):.2f} ms "
        f"(median of 5, one thread) on the host of {card}")
    out_dir = os.path.join(OUT_DIR, "parallel")
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(OUT_DIR, "bench_arrays.npz"), **gb.arrays())
    launches = dict.fromkeys(bm.launch_counts(), 0)
    procs = []

    def tally(res):
        for r in res:
            for k, v in r["launches"].items():
                launches[k] += v

    try:
        # 1-2: dp, the forwards and the timings, two ranks alone on the card
        procs.append(rank_task(2, "ranks2", os.path.join(out_dir, "ranks2")))
        r2 = rank_results(procs[-1])
        tally(r2)
        # the counterpart of the JAX dry run, alone on the card too
        procs.append(multichip_launch(2, os.path.join(out_dir, "multichip")))
        tally([multichip_summary(procs[-1], one_card=True)])
        # then, together (no timings among them): the 2-D step on four
        # ranks, and cli train under torchrun against one rank here
        procs.append(rank_task(4, "ranks4", os.path.join(out_dir, "ranks4")))
        ranks4 = procs[-1]
        same = ["--hidden_size", str(HIDDEN), "--band_precision", "highest",
                "--device", PAR_DEVICE]
        runs = []
        for kind in ("regression", "polymer"):
            for flag in ("--data_parallel", "--graph_parallel"):
                d = os.path.join(out_dir, f"cli_{kind}_{flag[2:]}")
                procs.append(rank_task(2, "cli", d,
                                       *cli_argv(kind, d, *same), flag))
                runs.append((kind, [flag], procs[-1]))
        single = {kind: cross_validate(parse_train_args(cli_argv(
            kind, os.path.join(out_dir, f"cli_{kind}_single"), *same)))[0]
            for kind in ("regression", "polymer")}
        r4 = rank_results(ranks4)
        tally(r4)
        check_ranks(r2, "[parallel]", True, card)
        check_ranks(r4, "[parallel]", True, card)
        for kind, flags, proc in runs:
            tally(check_cli(proc, kind, flags, True, single[kind],
                            "[parallel]", card))
    finally:
        stop(procs)
    log(f"[parallel] phase 10 launches {launches}, "
        f"{time.perf_counter() - t0:.1f} s")
    return launches


# -- the four-card phase (--cards 4) ----------------------------------------

CARD_PATH_KERNELS = ("band_rev_layer", "band_rev_bwd", "atom_readout",
                     "atom_neighbor_sum_sorted", "src_readout_sorted",
                     "molecule_readout_sorted")


def four_card_path(card, dev, gb, results):
    """``--cards 4``: parallel/ one rank a card over NCCL on CARDS cards
    (module docstring). Returns the ranks' kernel launches."""
    from polymer_chemprop_tpu_torch.config import parse_train_args
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    from polymer_chemprop_tpu_torch.train.cross_validate import cross_validate
    t0 = time.perf_counter()
    n = CARDS
    found = torch.cuda.device_count()
    if found < n:
        raise RuntimeError(f"chip_smoke --cards {n}: this machine has "
                           f"{found} CUDA devices")
    for cmd in (["nvidia-smi", "topo", "-m"],
                ["nvidia-smi", "nvlink", "--status", "-i", "0"]):
        try:
            got = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=60)
            text = (got.stdout + got.stderr).rstrip()
        except OSError as e:
            text = str(e)
        log(f"[cards] {' '.join(cmd)}:\n{text}")
    shard_kernel_checks(bm, results, dev, gb, n)
    out_dir = os.path.join(OUT_DIR, "cards")
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(OUT_DIR, "bench_arrays.npz"), **gb.arrays())
    launches = dict.fromkeys(bm.launch_counts(), 0)
    procs = []

    def tally(res):
        for r in res:
            for k, v in r["launches"].items():
                launches[k] += v

    try:
        for k in (n, 2):
            procs.append(multichip_launch(
                k, os.path.join(out_dir, f"multichip{k}"),
                env={"NCCL_DEBUG": "INFO"} if k == n else None))
            tally([multichip_summary(procs[-1], one_card=False)])
        procs.append(rank_task(n, "cards", os.path.join(out_dir, "ranks")))
        rs = rank_results(procs[-1])
        tally(rs)
        check_ranks(rs, "[cards]", False, card)
        # cli train at the default band_precision "high" (compared by test
        # score only): dp at batch 100 (25 a rank) and gp at ep 4 (batch
        # 50) on both datasets, gp with --graph_parallel_dp 2 (two batches
        # of 50 a step) on regression.csv; each against one card at the
        # batch a step takes (for the 2-D run also its Noam horizon)
        runs = [("regression", ["--data_parallel"], 100, 100),
                ("regression", ["--graph_parallel"], 50, 50),
                ("regression", ["--graph_parallel", "--graph_parallel_dp",
                                "2"], 50, 100),
                ("polymer", ["--data_parallel"], 100, 100),
                ("polymer", ["--graph_parallel"], 50, 50)]
        single = {}
        for i, (kind, flags, batch, same) in enumerate(runs):
            d = os.path.join(out_dir, f"cli_{i}_{kind}")
            procs.append(rank_task(n, "cli", d, *cli_argv(
                kind, d, "--batch_size", str(batch)), *flags))
            if i == 0:
                # one card, in this process, while the first launch runs
                for key in sorted({(k, b) for k, _, _, b in runs}):
                    sd = os.path.join(out_dir, f"cli_single_{key[0]}_"
                                               f"{key[1]}")
                    single[key] = cross_validate(parse_train_args(cli_argv(
                        key[0], sd, "--batch_size", str(key[1]))))[0]
            tally(check_cli(procs[-1], kind, flags + ["--batch_size",
                                                      str(batch)],
                            False, single[(kind, same)], "[cards]", card,
                            f"one card at batch {same}"))
    finally:
        stop(procs)
    log(f"[cards] launches {launches}, {time.perf_counter() - t0:.1f} s")
    return launches


# -- phase 11 ---------------------------------------------------------------

SK_DEVICE = "cuda"               # every fit's device (a rehearsal: "cpu")
SK_TREES = 500                   # the JAX package's num_trees
SK_CPU_TREES = 50                # the forests fitted on both devices
SK_FOLDS = 3
SK_GOLDEN_RMSE = 1.582733        # tests/test_integration.py test_rf_golden
SK_SCALE_COPIES = 8              # regression.csv x 8 for the timing line
# the JAX package's scores (scikit-learn 1.9.0 on a CPU, seed 0, one fold
# unless named), printed beside the port's; its SVC is unseeded
SK_JAX_SCORES = {"rf_regression": "RMSE 1.553778 (3 folds)",
                 "svr": "RMSE 1.856614",
                 "rf_classification": "AUC 0.709334",
                 "rf_classification_balanced": "not measured",
                 "svc": "AUC 0.689754 and 0.728665 on two identical runs"}
FOREST_NODE_FIELDS = ("offsets", "left", "right", "feature", "threshold",
                      "n_node_samples")


def _sk_sync():
    if SK_DEVICE == "cuda":
        torch.cuda.synchronize()


def _sk_on_device(model, what):
    check(all(t.device.type == SK_DEVICE for t in model.tensors()),
          f"{what}: a fitted tensor is not on {SK_DEVICE}")


def _sk_cli(name, argv, built):
    """``cli sklearn_train`` in-process, recording every estimator that
    ``_build_model`` makes and timing its ``fit`` (synced); returns (mean
    score, seconds end to end, seconds in ``fit``)."""
    from polymer_chemprop_tpu_torch import cli
    from polymer_chemprop_tpu_torch import sklearn_train as sk
    build = sk._build_model
    made, fit_seconds = [], []

    def recording(cfg, single=False):
        model = build(cfg, single)
        fit = model.fit

        def timed_fit(X, y):
            t0 = time.perf_counter()
            out = fit(X, y)
            _sk_sync()
            fit_seconds.append(time.perf_counter() - t0)
            return out
        model.fit = timed_fit
        made.append(model)
        return model

    save = os.path.join(OUT_DIR, "sklearn", name)
    shutil.rmtree(save, ignore_errors=True)
    sk._build_model = recording
    t0 = time.perf_counter()
    try:
        cli.main(["sklearn_train", *argv, "--save_dir", save,
                  "--device", SK_DEVICE, "--quiet"])
        _sk_sync()
    finally:
        sk._build_model = build
    seconds = time.perf_counter() - t0
    for m in made:
        _sk_on_device(m, name)
    built[name] = made
    # the mean over the tasks of each task's mean over the folds
    with open(os.path.join(save, "test_scores.csv")) as f:
        rows = list(csv.reader(f))[1:]
    score = float(np.nanmean([float(r[1]) for r in rows]))
    return score, seconds, sum(fit_seconds)


def _svm_line(name, models, card):
    iters = [m.n_iter_ for m in models]
    smo = sum(m.smo_seconds_ for m in models)
    line = (f"[sklearn] {name}: {len(models)} fits, SMO iterations "
            f"{min(iters)}-{max(iters)} (total {sum(iters)}), SMO "
            f"{smo:.3f} s ({1e3 * smo / max(1, sum(iters)):.3f} ms an "
            "iteration)")
    if getattr(models[0], "probability", False):
        platt = sum(m.platt_seconds_ for m in models)
        line += (f", Platt (5 folds batched + sigmoid fit) {platt:.3f} s, "
                 f"its SMO iterations {max(m.platt_n_iter_ for m in models)}"
                 " at most")
    log(line + f" on {card}")


def _sk_forest_pair(make, X, y, card, what):
    """The same forest fitted on SK_DEVICE and on the CPU: identical node
    arrays, predictions within 1e-9 relative."""
    t0 = time.perf_counter()
    dev_model = make(SK_DEVICE).fit(X[:400], y[:400])
    _sk_sync()
    t1 = time.perf_counter()
    cpu_model = make("cpu").fit(X[:400], y[:400])
    t2 = time.perf_counter()
    _sk_on_device(dev_model, what)
    a, b = dev_model.forest_, cpu_model.forest_
    for f in FOREST_NODE_FIELDS:
        check(torch.equal(getattr(a, f).cpu(), getattr(b, f)),
              f"{what}: {f} differs between {SK_DEVICE} and cpu")
    for f in ("value", "weighted_n_node_samples", "impurity"):
        np.testing.assert_allclose(getattr(a, f).cpu().numpy(),
                                   getattr(b, f).numpy(), rtol=1e-12,
                                   atol=1e-15)
    predict = getattr(dev_model, "predict_proba", dev_model.predict)
    got = np.asarray(predict(X[400:]))
    want = np.asarray(getattr(cpu_model, "predict_proba",
                              cpu_model.predict)(X[400:]))
    err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300)))
    log(f"[sklearn] (c) {what}: {int(a.offsets[-1])} nodes, node arrays "
        f"equal on {SK_DEVICE} and cpu, predictions max rel diff "
        f"{err:.3e}; fit {t1 - t0:.3f} s on {card}, {t2 - t1:.3f} s on the "
        "host's CPU")
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-15)


def _sk_svm_pair(make, X, y, card, what):
    """The same SVM fitted on SK_DEVICE and on the CPU: decision values
    within 1e-6."""
    dev_model = make(SK_DEVICE).fit(X[:400], y[:400])
    cpu_model = make("cpu").fit(X[:400], y[:400])
    _sk_on_device(dev_model, what)
    got = dev_model.decision_values(X[400:]).cpu().numpy()
    want = cpu_model.decision_values(X[400:]).numpy()
    log(f"[sklearn] (c) {what}: SMO iterations {dev_model.n_iter_} on "
        f"{SK_DEVICE}, {cpu_model.n_iter_} on cpu; decision values max "
        f"|diff| {np.abs(got - want).max():.3e}; SMO "
        f"{dev_model.smo_seconds_:.3f} s on {card}, "
        f"{cpu_model.smo_seconds_:.3f} s on the host's CPU")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if getattr(dev_model, "probability", False):
        np.testing.assert_allclose(dev_model.predict_proba(X[400:]),
                                   cpu_model.predict_proba(X[400:]), rtol=0,
                                   atol=1e-6)


def sklearn_path(card):
    """Phase 11: ``sklearn_train`` / ``sklearn_predict`` on the card (no
    kernel of the port's: the forests and SVMs of baselines/ are tensor
    code). (a) the CLI's random forest on regression.csv, 3 folds, seed 0,
    500 trees, against the reference golden; (b) SVR, then the random
    forest (also with class_weight "balanced") and the SVC on
    classification.csv's 12 tasks; (c) a 50-tree forest of each kind and
    an SVR and SVC fitted on the card and on the CPU; (d) ``cli
    sklearn_predict`` from (a)'s model.pkl against the fold's own test
    predictions; (e) the committed JAX-written pickles read with no
    sklearn; (f) 500 trees on 4,000 rows."""
    from polymer_chemprop_tpu_torch import cli
    from polymer_chemprop_tpu_torch.baselines import forest, svm
    from polymer_chemprop_tpu_torch.config import PredictConfig
    from polymer_chemprop_tpu_torch.data import get_data
    from polymer_chemprop_tpu_torch.sklearn_predict import predict_sklearn
    from polymer_chemprop_tpu_torch.sklearn_train import (
        compute_morgan_features)
    t_phase = time.perf_counter()
    data_dir = os.path.join(ROOT, "tests", "data")
    reg_csv = os.path.join(data_dir, "regression.csv")
    cls_csv = os.path.join(data_dir, "classification.csv")
    reg = get_data(reg_csv)
    t0 = time.perf_counter()
    X = compute_morgan_features(reg, 2, 2048)
    morgan_ms = 1e3 * (time.perf_counter() - t0)
    y = np.array([d.targets[0] for d in reg], dtype=np.float64)
    log(f"[sklearn] host Morgan (radius 2, 2,048 bits) of the "
        f"{len(reg)} molecules of regression.csv: {morgan_ms:.1f} ms "
        f"(Python, one thread) on the host of {card}")
    built = {}

    # (a) the golden
    rmse, seconds, fit_s = _sk_cli("rf_regression", [
        "--data_path", reg_csv, "--dataset_type", "regression",
        "--num_folds", str(SK_FOLDS), "--seed", "0",
        "--num_trees", str(SK_TREES), "--save_preds"], built)
    forests = built["rf_regression"]
    log(f"[sklearn] (a) random forest, regression.csv, {SK_FOLDS} folds, "
        f"{SK_TREES} trees: test RMSE {rmse:.6f}, golden {SK_GOLDEN_RMSE} "
        f"({100 * (rmse / SK_GOLDEN_RMSE - 1):+.2f}%), the JAX package "
        f"{SK_JAX_SCORES['rf_regression']}; fit {fit_s / SK_FOLDS:.3f} s a "
        f"fold ({len(forests) * SK_TREES / fit_s:.1f} trees/s), "
        f"{seconds / SK_FOLDS:.3f} s a fold end to end (Morgan, fit, "
        f"predict, files) on {card}")
    check(abs(rmse / SK_GOLDEN_RMSE - 1) < 0.05,
          f"RF RMSE {rmse} not within 5% of {SK_GOLDEN_RMSE}")

    # (b) the other estimators and the per-task path
    for name, argv in (
            ("svr", ["--data_path", reg_csv, "--dataset_type", "regression",
                     "--model_type", "svm"]),
            ("rf_classification", ["--data_path", cls_csv,
                                   "--dataset_type", "classification"]),
            ("rf_classification_balanced", [
                "--data_path", cls_csv, "--dataset_type", "classification",
                "--class_weight", "balanced"]),
            ("svc", ["--data_path", cls_csv, "--dataset_type",
                     "classification", "--model_type", "svm"])):
        score, seconds, fit_s = _sk_cli(name, argv, built)
        check(math.isfinite(score), f"{name} score {score}")
        metric = "RMSE" if name == "svr" else "AUC"
        log(f"[sklearn] (b) {name}: test {metric} {score:.6f} (the JAX "
            f"package: {SK_JAX_SCORES[name]}); {len(built[name])} models, "
            f"fit {fit_s:.3f} s, {seconds:.3f} s the fold end to end on "
            f"{card}")
        if name in ("svr", "svc"):
            _svm_line(name, built[name], card)
    check(len(built["rf_classification"]) == 12,
          "classification.csv did not take the per-task path")

    # (c) the same fits on the card and on the CPU
    yc = (y > np.median(y)).astype(np.float64)
    _sk_forest_pair(lambda d: forest.RandomForestRegressor(
        SK_CPU_TREES, random_state=0, device=d), X, y, card,
        f"{SK_CPU_TREES}-tree regressor")
    _sk_forest_pair(lambda d: forest.RandomForestClassifier(
        SK_CPU_TREES, random_state=0, class_weight="balanced_subsample",
        device=d), X, yc, card,
        f"{SK_CPU_TREES}-tree classifier (balanced_subsample)")
    _sk_svm_pair(lambda d: svm.SVR(device=d), X, y, card, "SVR")
    _sk_svm_pair(lambda d: svm.SVC(probability=True, random_state=0,
                                   device=d), X, yc, card, "SVC")

    # (d) sklearn_predict from the port's model.pkl
    fold = os.path.join(OUT_DIR, "sklearn", "rf_regression", "fold_0")
    preds_csv = os.path.join(OUT_DIR, "sklearn", "rf_regression_preds.csv")
    t0 = time.perf_counter()
    cli.main(["sklearn_predict", "--test_path",
              os.path.join(fold, "test_preds.csv"), "--checkpoint_path",
              os.path.join(fold, "model.pkl"), "--preds_path", preds_csv,
              "--device", SK_DEVICE])
    _sk_sync()
    seconds = time.perf_counter() - t0
    with open(os.path.join(fold, "test_preds.csv")) as f:
        want = np.array([float(r[1]) for r in list(csv.reader(f))[1:]])
    with open(preds_csv) as f:
        got = np.array([float(r[1]) for r in list(csv.reader(f))[1:]])
    log(f"[sklearn] (d) sklearn_predict of fold 0 ({len(got)} molecules) "
        f"from the port's model.pkl: max |diff| from the fold's own test "
        f"predictions {np.abs(got - want).max():.3e}; {seconds:.3f} s end "
        f"to end (read, Morgan, {SK_TREES} trees) on {card}")
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)

    # (e) the JAX package's pickles, read without sklearn
    fixtures = os.path.join(data_dir, "sklearn_jax")
    for name in ("rf_regression", "svr", "rf_classification", "svc"):
        csv_path = os.path.join(fixtures, f"{name}_preds.csv")
        with open(csv_path) as f:
            want = np.array([[float(v) for v in r[1:]]
                             for r in list(csv.reader(f))[1:]])
        got = np.array(predict_sklearn(PredictConfig(
            test_path=csv_path,
            checkpoint_path=os.path.join(fixtures, f"{name}.pkl"),
            device=SK_DEVICE)))
        err = float(np.max(np.abs(got - want)
                           / np.maximum(np.abs(want), 1e-300)))
        log(f"[sklearn] (e) JAX-written {name}.pkl: {got.shape[0]} x "
            f"{got.shape[1]} predictions, max rel diff from sklearn's "
            f"{err:.3e}")
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-15)
    loaded = [m for m in sys.modules if m.split(".")[0] == "sklearn"]
    check(not loaded, f"reading the pickles loaded {loaded}")

    # (f) one timing line at scale
    rng = np.random.default_rng(0)
    Xs = np.tile(X, (SK_SCALE_COPIES, 1))
    ys = np.tile(y, SK_SCALE_COPIES) + rng.normal(0, 0.1, len(Xs))
    model = forest.RandomForestRegressor(SK_TREES, random_state=0,
                                         device=SK_DEVICE)
    t0 = time.perf_counter()
    model.fit(Xs, ys)
    _sk_sync()
    fit_s = time.perf_counter() - t0
    _sk_on_device(model, "the forest at scale")
    t0 = time.perf_counter()
    preds = model.predict(Xs)
    predict_s = time.perf_counter() - t0
    check(np.isfinite(preds).all() and preds.shape == ys.shape,
          "forest predictions at scale")
    f = model.forest_
    log(f"[sklearn] (f) {len(Xs):,} rows (regression.csv x "
        f"{SK_SCALE_COPIES}, targets + N(0, 0.1)), {SK_TREES} trees: fit "
        f"{fit_s:.3f} s ({SK_TREES / fit_s:.1f} trees/s, "
        f"{int(f.offsets[-1]):,} nodes, depth {f.max_depth}), predict "
        f"{len(Xs) / predict_s:,.0f} molecules/s ({predict_s:.3f} s) on "
        f"{card}")
    log(f"[sklearn] phase 11 {time.perf_counter() - t_phase:.1f} s")


# -- phase 12 ---------------------------------------------------------------

GOLDEN_DEVICE = "cuda"           # every golden's device (a rehearsal: "cpu")
# the goldens of the phase, by the module's names: the whole set took 442.1
# s through the module on the card (NVIDIA H100 80GB HBM3, 700.00 W), over
# the phase's 400 s, so the phase runs these 8 (scripts/tpu_goldens.py's
# four and four more); ``python -m polymer_chemprop_tpu_torch.goldens``
# runs all 25
GOLDEN_NAMES = ("reg_rdkit", "cls_morgan", "reaction_morgan",
                "spectra_exclusions", "regression", "classification",
                "regression_roundtrip", "regression_graph_parallel")
GOLDEN_CPU_RTOL = 1e-2           # phase 4's test-score tolerance, card vs CPU
GOLDEN_ROWS = {"row 1": "band_rev_layer", "row 2": "band_rev_bwd",
               "row 3": "atom_readout", "row 3a": "atom_neighbor_sum_sorted",
               "row 3b": "src_readout_sorted",
               "molecule readout": "molecule_readout_sorted"}


def _golden_counts(r) -> str:
    rows = ", ".join(f"{row} {r.launches[name]}"
                     for row, name in GOLDEN_ROWS.items())
    fp32 = r.launches["band_rev_layer"] - r.tc_launches["band_rev_layer"]
    return f"launches {rows} (row 1 on the FP32 entry {fp32})"


def _fold_run(save_dir, fold, metric="rmse"):
    """One fold of a run: each epoch's train loss and validation score
    (``train_val_loss_log.csv``) and the fold's test score."""
    fold_dir = os.path.join(save_dir, f"fold_{fold}")
    with open(os.path.join(fold_dir, "model_0",
                           "train_val_loss_log.csv")) as f:
        rows = list(csv.DictReader(f))
    loss = np.array([float(r["train_loss"]) for r in rows])
    val = np.array([float(r[f"val_avg_{metric}"]) for r in rows])
    with open(os.path.join(fold_dir, "test_scores.json")) as f:
        test = float(np.mean(json.load(f)[metric]))
    return loss, val, test


def hold_folds_to_cpu(card_dir, cpu_dir, card, tag="golden"):
    """The card's run against the CPU's, fold by fold, within
    GOLDEN_CPU_RTOL: every epoch's train loss and validation score, and the
    test score of the model each keeps. Each keeps its best validation
    epoch; where two epochs' validation scores lie closer than the runs
    differ, the two may keep different epochs (a near-tie of the
    selection, which moves the fold's test score by the two epochs'
    difference). Then each device's two epochs must lie within the
    tolerance of each other, and the fold's test score is printed, not
    held."""
    folds = sorted(d for d in os.listdir(card_dir) if d.startswith("fold_"))
    check(folds and folds == sorted(d for d in os.listdir(cpu_dir)
                                    if d.startswith("fold_")),
          f"the card's folds {folds} and the CPU's differ")
    for fold in range(len(folds)):
        loss, val, test = _fold_run(card_dir, fold)
        c_loss, c_val, c_test = _fold_run(cpu_dir, fold)
        err_loss = float(np.max(np.abs(loss - c_loss) / np.abs(c_loss)))
        err_val = float(np.max(np.abs(val - c_val) / np.abs(c_val)))
        best, c_best = int(np.argmin(val)), int(np.argmin(c_val))
        rel = abs(test - c_test) / abs(c_test)
        log(f"[{tag}] highest, fold {fold}, card against CPU over "
            f"{len(val)} epochs: train loss max rel {err_loss:.2e}, "
            f"validation rmse max rel {err_val:.2e}; best epoch {best} / "
            f"{c_best}; test rmse {test:.6f} / {c_test:.6f} (rel "
            f"{rel:.2e}) on {card}")
        check(len(val) == len(c_val) and err_loss <= GOLDEN_CPU_RTOL
              and err_val <= GOLDEN_CPU_RTOL,
              f"fold {fold}: the card's epochs left the CPU's")
        if best == c_best:
            check(rel <= GOLDEN_CPU_RTOL, f"fold {fold}: test score")
            continue
        gaps = [abs(v[best] - v[c_best]) / v[c_best] for v in (val, c_val)]
        log(f"[{tag}] highest, fold {fold}: the card keeps epoch {best}, "
            f"the CPU epoch {c_best}; their validation rmse {val[best]:.6f}"
            f" / {val[c_best]:.6f} on the card, {c_val[best]:.6f} / "
            f"{c_val[c_best]:.6f} on the CPU (apart {gaps[0]:.2e} and "
            f"{gaps[1]:.2e}): a near-tie of the selection")
        check(max(gaps) <= GOLDEN_CPU_RTOL,
              f"fold {fold}: the selected epochs are no near-tie")


def golden_path(card):
    """Phase 12: the reference's golden-score configurations
    (``polymer_chemprop_tpu_torch/goldens.py``, the JAX package's
    ``TestGoldenScores``) on the card at full width, each inside its band;
    then the regression golden at ``band_precision="highest"`` on the card
    (inside 5%) and on the card's host CPU (the plain versions), held fold
    by fold (:func:`hold_folds_to_cpu`). Returns the kernels' launches and
    those on the tensor cores."""
    from polymer_chemprop_tpu_torch import goldens
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    t_phase = time.perf_counter()
    root = os.path.join(OUT_DIR, "goldens")
    shutil.rmtree(root, ignore_errors=True)
    launches = dict.fromkeys(bm.launch_counts(), 0)
    tc_launches = dict.fromkeys(bm.tc_launch_counts(), 0)

    def run(g, device, name, **overrides):
        r = goldens.run_golden(g, device, os.path.join(root, name),
                               **overrides)
        if device == GOLDEN_DEVICE:
            for k, v in r.launches.items():
                launches[k] += v
            for k, v in r.tc_launches.items():
                tc_launches[k] += v
        return r

    names = GOLDEN_NAMES or list(goldens.GOLDENS)
    results = []
    for name in names:
        g = goldens.resolve(name)
        r = run(g, GOLDEN_DEVICE, g.name)
        log(f"[golden] {r.line()} on {card}; {_golden_counts(r)}")
        check(GOLDEN_DEVICE != "cuda" or g.sklearn
              or r.launches["band_rev_layer"] > 0,
              f"{g.name} launched no layer kernel")
        results.append(r)
    failed = [r.line() for r in results if not r.ok]
    log(f"[golden] {len(results) - len(failed)} of {len(results)} inside "
        f"their bands in {sum(r.seconds for r in results):.1f} s on {card}")
    check(not failed, f"goldens outside their bands: {failed}")

    reg = goldens.GOLDENS["regression"]
    high = next(r for r in results if r.name == reg.name)
    highest = run(reg, GOLDEN_DEVICE, "regression_highest",
                  band_precision="highest")
    log(f"[golden] regression at band_precision highest: "
        f"{highest.line()} on {card}; {_golden_counts(highest)}")
    check(highest.ok, f"regression at highest: {highest.line()}")
    check(highest.tc_launches["band_rev_layer"] == 0
          and (GOLDEN_DEVICE != "cuda"
               or highest.launches["band_rev_layer"] > 0),
          "highest did not run the FP32 entry alone")
    cpu = run(reg, "cpu", "regression_highest_cpu", band_precision="highest")
    rel_cpu = abs(highest.score - cpu.score) / abs(cpu.score)
    log(f"[golden] regression at highest on the host's CPU (plain "
        f"versions): {cpu.score:.6f} in {cpu.seconds:.1f} s; the card "
        f"{highest.score:.6f}, rel {rel_cpu:.2e}; high - highest on the card "
        f"{high.score - highest.score:+.6f} "
        f"({100 * (high.score - highest.score) / highest.score:+.2f}%)")
    hold_folds_to_cpu(os.path.join(root, "regression_highest"),
                      os.path.join(root, "regression_highest_cpu"), card)
    log(f"[golden] phase 12 launches {launches} (tensor cores "
        f"{tc_launches}), {time.perf_counter() - t_phase:.1f} s")
    return launches, tc_launches


# -- phase 13 ---------------------------------------------------------------

POLYMER_DEVICE = "cuda"          # the checks' device (a rehearsal: "cpu")
POLYMER_HOLD_EPOCHS = 10         # the weighted arm at "highest", card vs CPU
POLYMER_OVERRIDES = {}           # none on the card (a rehearsal: a small size)


def _rows_launched(counts, tc, what, on_tc):
    """Rows 1-3 launched in a run's ``counts``; row 1 every time on the
    tensor cores (``on_tc``, "high") or never ("highest")."""
    if POLYMER_DEVICE != "cuda":
        return
    check(all(counts[k] > 0 for k in REV_ROWS),
          f"{what}: rows 1-3 did not all launch: {counts}")
    want = counts["band_rev_layer"] if on_tc else 0
    check(tc["band_rev_layer"] == want,
          f"{what}: row 1 on the tensor cores {tc} of {counts}")


def polymer_path(card):
    """Phase 13: the fork's polymer checks
    (``polymer_chemprop_tpu_torch/polymer_goldens.py``: the JAX package's
    ``tests/test_eaip_benchmark.py`` and ``tests/test_polymer_learning.py``)
    on the card at their own configurations, nothing cut; the weighted
    EA/IP arm at ``band_precision="highest"`` for ``POLYMER_HOLD_EPOCHS``
    epochs on the card and on the host CPU, held epoch by epoch
    (:func:`hold_folds_to_cpu`); and the weighted arm's model served on its
    test split on the card and the CPU. Returns the kernels' launches and
    those on the tensor cores."""
    from polymer_chemprop_tpu_torch import eaip
    from polymer_chemprop_tpu_torch import polymer_goldens as pg
    from polymer_chemprop_tpu_torch.config import PredictConfig
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    from polymer_chemprop_tpu_torch.train.make_predictions import (
        make_predictions,
    )
    t_phase = time.perf_counter()
    root = os.path.join(OUT_DIR, "polymer_goldens")
    shutil.rmtree(root, ignore_errors=True)
    launches = dict.fromkeys(bm.launch_counts(), 0)
    tc_launches = dict.fromkeys(bm.tc_launch_counts(), 0)

    def tally(counts, tc):
        for k, v in counts.items():
            launches[k] += v
        for k, v in tc.items():
            tc_launches[k] += v

    def counted(device, fn):
        """``fn()`` with its seconds (host clock, synced) and launches;
        the card's added to the phase's."""
        bm.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts, tc = bm.launch_counts(), bm.tc_launch_counts()
        if device == POLYMER_DEVICE:
            tally(counts, tc)
        return out, seconds, counts, tc

    # 1. EA/IP, both arms at the JAX test's configuration (the weighted
    # arm's splits kept for serving)
    r = pg.run_eaip(POLYMER_DEVICE, os.path.join(root, "eaip"),
                    save_smiles_splits=True, **POLYMER_OVERRIDES)
    tally(r.launches, r.tc_launches)
    log(f"[polymer] {r.line()} on {card}")
    (jw_rmse, jw_r2), (jb_rmse, jb_r2) = (pg.JAX_CPU[a] for a in pg.ARMS)
    log(f"[polymer] eaip: the JAX package's CPU path (docs/parity.md) "
        f"weighted rmse {jw_rmse} r2 {jw_r2}, blind rmse {jb_rmse} r2 "
        f"{jb_r2}; the checks: weighted r2 > {pg.EAIP_R2_MIN}, rmse < "
        f"{pg.EAIP_RMSE_RATIO_MAX} x blind")
    check(r.ok, f"eaip: {r.line()}")
    _rows_launched(r.launches, r.tc_launches, "eaip", on_tc=True)

    # 2. the polymer learning check
    r = pg.run_polymer_learning(POLYMER_DEVICE,
                                os.path.join(root, "polymer_learning"),
                                **POLYMER_OVERRIDES)
    tally(r.launches, r.tc_launches)
    log(f"[polymer] {r.line()} on {card}")
    check(r.ok, f"polymer_learning: {r.line()}")
    _rows_launched(r.launches, r.tc_launches, "polymer_learning", on_tc=True)

    # 3. the weighted arm at "highest" on the card and the host CPU (plain
    # versions), held epoch by epoch
    rows = eaip.generate(blind_weights=False)
    hold = dict(POLYMER_OVERRIDES, epochs=POLYMER_HOLD_EPOCHS,
                band_precision="highest")
    dirs = {d: os.path.join(root, f"weighted_highest_{d}")
            for d in (POLYMER_DEVICE, "cpu")}
    for device, save_dir in dirs.items():
        (rmse, r2), seconds, counts, tc = counted(
            device, lambda: pg.run_arm(rows, save_dir, device, **hold))
        if device == POLYMER_DEVICE:
            _rows_launched(counts, tc, "eaip weighted highest", on_tc=False)
        log(f"[polymer] eaip weighted at band_precision highest, "
            f"{POLYMER_HOLD_EPOCHS} epochs, on {device}: rmse {rmse:.6f} r2 "
            f"{r2:.6f} in {seconds:.1f} s; launches rows 1-3 "
            f"{[counts[k] for k in REV_ROWS]}")
    hold_folds_to_cpu(dirs[POLYMER_DEVICE], dirs["cpu"], card, tag="polymer")

    # 4. the weighted arm's model served on its test split
    weighted = os.path.join(root, "eaip", "weighted")
    test_csv = os.path.join(weighted, "fold_0", "test_smiles.csv")
    ckpt = os.path.join(weighted, "fold_0", "model_0", "best_model.ckpt")
    preds = {}
    for device in (POLYMER_DEVICE, "cpu"):
        out, seconds, counts, tc = counted(device, lambda: make_predictions(
            PredictConfig(test_path=test_csv, checkpoint_path=ckpt,
                          preds_path=os.path.join(root,
                                                  f"preds_{device}.csv"),
                          batch_size=BATCH_SIZE, num_workers=4,
                          device=device)))
        preds[device] = np.asarray(out, dtype=float)
        check(device != "cuda" or (
            counts["atom_readout"] > 0
            and tc["band_rev_layer"] == counts["band_rev_layer"] > 0),
            f"serving: row 1 not on the tensor cores, or no readout: "
            f"{counts} {tc}")
        log(f"[polymer] serving the weighted arm's model on its test split "
            f"({preds[device].shape[0]} copolymers) on {device}: "
            f"{seconds:.3f} s, launches {counts} (tensor cores {tc})")
    got, want = preds[POLYMER_DEVICE], preds["cpu"]
    n_test = len(read_smiles(test_csv))
    check(got.shape == want.shape == (n_test, 2), (got.shape, want.shape))
    check(np.isfinite(got).all(), "non-finite predictions")
    log(f"[polymer] serving: max |card - CPU| {np.abs(got - want).max():.3e}"
        f" (largest |prediction| {np.abs(want).max():.3f})")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    log(f"[polymer] phase 13 launches {launches} (tensor cores "
        f"{tc_launches}), {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches, tc_launches


# -- phase 14 ---------------------------------------------------------------

DETERMINISM_DEVICE = "cuda"      # the phase's device (a rehearsal: "cpu")
DETERMINISM_EPOCHS = 2           # atom_messages, multiclass, SSL's stage


def _equal(what, a, b, card):
    """Two card runs' results ``a`` and ``b`` (nested lists, dicts, floats,
    strings and arrays) equal in every value; a line that says so."""
    def norm(x):
        if isinstance(x, np.ndarray):
            return ("array", x.shape, x.tobytes())
        if isinstance(x, dict):
            return {k: norm(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [norm(v) for v in x]
        return x
    check(norm(a) == norm(b), f"{what}: two runs on the card differ")
    log(f"[determinism] {what}: two runs equal bit for bit on {card}")


def determinism_path(card):
    """Phase 14: one seed gives one model on the card, in torch's default
    mode. Each case runs twice and must agree bit for bit: serving
    regression.csv and the 200 copolymers (phase 3's checkpoints) through
    ``make_predictions``, and ``molecule_fingerprint``'s two types; the
    EA/IP weighted arm at its full configuration (60 epochs, "high", seed
    0; phase 13's run is the first) in every epoch's train loss and
    validation scores, its test RMSE and R² and its best model's
    parameters (SHA-256); the regression golden (3 folds, 10 epochs;
    phase 12's run is the first) likewise, fold by fold; and
    ``atom_messages``, multiclass (3 classes) and an ``ssl_pretrain``
    stage, ``DETERMINISM_EPOCHS`` epochs each (scores, parameters; SSL's
    graph embeddings). Then one training step and one serving batch of
    each configuration run under the profiler and a dispatch log: no
    device kernel may add floats with atomics (``probes/
    determinism_probe.py`` ``atomic_kernel``), and no float atomic may be
    dispatched. Returns the kernels' launches and those on the tensor
    cores."""
    from polymer_chemprop_tpu_torch import eaip, goldens
    from polymer_chemprop_tpu_torch import polymer_goldens as pg
    from polymer_chemprop_tpu_torch.config import PredictConfig, TrainConfig
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    from polymer_chemprop_tpu_torch.probes.determinism_probe import (
        OpLog, atomic_kernel, multiclass_csv, params_sha, profile_kernels,
        run_record)
    from polymer_chemprop_tpu_torch.ssl import SSLConfig, ssl_pretrain
    from polymer_chemprop_tpu_torch.train.cross_validate import cross_validate
    from polymer_chemprop_tpu_torch.train.make_predictions import (
        make_predictions,
    )
    from polymer_chemprop_tpu_torch.train.molecule_fingerprint import (
        FingerprintConfig,
        molecule_fingerprint,
    )
    t_phase = time.perf_counter()
    dev = DETERMINISM_DEVICE
    root = os.path.join(OUT_DIR, "determinism")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    launches = dict.fromkeys(bm.launch_counts(), 0)
    tc_launches = dict.fromkeys(bm.tc_launch_counts(), 0)

    def counted(fn):
        bm.reset_launch_counts()
        out = fn()
        for k, v in bm.launch_counts().items():
            launches[k] += v
        for k, v in bm.tc_launch_counts().items():
            tc_launches[k] += v
        return out

    reg_csv = os.path.join(ROOT, "tests", "data", "regression.csv")
    poly_csv = os.path.join(OUT_DIR, "polymers.csv")
    ckpts = {"regression": os.path.join(OUT_DIR, "regression", "model.ckpt"),
             "polymer": os.path.join(OUT_DIR, "polymer", "model.ckpt")}

    def serve(name, test_path, tag):
        return np.asarray(make_predictions(PredictConfig(
            test_path=test_path, checkpoint_path=ckpts[name],
            preds_path=os.path.join(root, f"{name}_{tag}.csv"),
            batch_size=BATCH_SIZE, num_workers=4, device=dev)), dtype=float)

    def fingerprint(fp_type, tag, test_path=reg_csv):
        return np.asarray(molecule_fingerprint(FingerprintConfig(
            test_path=test_path, checkpoint_path=ckpts["regression"],
            preds_path=os.path.join(root, f"fp_{fp_type}_{tag}.csv"),
            fingerprint_type=fp_type, batch_size=BATCH_SIZE, num_workers=4,
            device=dev)))

    # 1. serving and fingerprints
    for name, test_path in (("regression", reg_csv), ("polymer", poly_csv)):
        a, b = (counted(lambda: serve(name, test_path, k)) for k in "ab")
        _equal(f"serving {name} ({a.shape[0]} molecules)", a, b, card)
    for fp_type in ("MPN", "last_FFN"):
        a, b = (counted(lambda: fingerprint(fp_type, k)) for k in "ab")
        _equal(f"fingerprint {fp_type} ({a.shape[0]} x {a.shape[1]})", a, b,
               card)

    # 2. the EA/IP weighted arm, phase 13's run the first
    first = run_record(os.path.join(OUT_DIR, "polymer_goldens", "eaip",
                                    "weighted"))
    t0 = time.perf_counter()
    rmse, r2 = counted(lambda: pg.run_arm(
        eaip.generate(blind_weights=False), os.path.join(root, "eaip"), dev,
        save_smiles_splits=True, **POLYMER_OVERRIDES))
    second = run_record(os.path.join(root, "eaip"))
    log(f"[determinism] eaip weighted, {len(second['fold_0']['epochs'])} "
        f"epochs, \"high\", seed 0: test rmse {rmse!r} r2 {r2!r} (means "
        f"over EA and IP), parameters sha256 "
        f"{second['fold_0']['param_sha']} ({time.perf_counter() - t0:.1f} s)")
    _equal("eaip weighted: every epoch's losses and scores, test rmse and "
           "r2, parameters", first, second, card)

    # 3. the regression golden, phase 12's run the first
    reg = goldens.GOLDENS["regression"]
    first = run_record(os.path.join(OUT_DIR, "goldens", reg.name))
    r = counted(lambda: goldens.run_golden(
        reg, GOLDEN_DEVICE, os.path.join(root, "golden_regression")))
    second = run_record(os.path.join(root, "golden_regression"))
    log(f"[determinism] regression golden: mean test rmse {r.score!r}, folds "
        + ", ".join(f"{f['test']['rmse'][0]!r}" for f in second.values())
        + f" ({r.seconds:.1f} s)")
    _equal(f"regression golden: {len(second)} folds' epochs, test scores "
           "and parameters", first, second, card)

    # 4. atom_messages, multiclass and an SSL stage, twice each
    mc_csv = os.path.join(root, "multiclass.csv")
    multiclass_csv(mc_csv)
    base = dict(hidden_size=HIDDEN, ffn_hidden_size=HIDDEN, depth=DEPTH,
                batch_size=BATCH_SIZE, seed=SEED, num_folds=1, quiet=True,
                num_workers=4, device=dev)
    configs = {
        "default": dict(data_path=reg_csv),
        "polymer": dict(data_path=os.path.join(OUT_DIR,
                                               "polymers_train.csv"),
                        polymer=True),
        "atom_messages": dict(data_path=reg_csv, atom_messages=True),
        "multiclass": dict(data_path=mc_csv, dataset_type="multiclass",
                           multiclass_num_classes=3)}

    def train(name, tag, **kw):
        save_dir = os.path.join(root, f"{name}_{tag}")
        cross_validate(TrainConfig(**{
            **base, "epochs": DETERMINISM_EPOCHS, "save_dir": save_dir,
            **configs[name], **kw}))
        return save_dir

    def ssl(tag, **kw):
        save_dir = os.path.join(root, f"ssl_{tag}")
        path = ssl_pretrain(SSLConfig(**dict(dict(
            data_path=poly_csv, save_dir=save_dir, hidden_size=HIDDEN,
            depth=DEPTH, epochs_stage1=0,
            epochs_stage2=DETERMINISM_EPOCHS, batch_size=BATCH_SIZE,
            save_graph_embeddings=True, seed=SEED, quiet=True, device=dev),
            **kw)))
        return {"param_sha": params_sha(path), "embeddings": np.load(
            os.path.join(save_dir, "ssl_graph_embeddings.npy"))}

    for name in ("atom_messages", "multiclass"):
        a, b = (run_record(counted(lambda: train(name, k))) for k in "ab")
        _equal(f"{name}, {DETERMINISM_EPOCHS} epochs: epochs, test "
               f"{a['fold_0']['test']}, parameters "
               f"{a['fold_0']['param_sha'][:16]}", a, b, card)
    a, b = (counted(lambda: ssl(k)) for k in "ab")
    _equal(f"ssl_pretrain stage 2, {DETERMINISM_EPOCHS} epochs: parameters "
           f"{a['param_sha'][:16]}, graph embeddings {a['embeddings'].shape}",
           a, b, card)

    # 5. one training step and one serving batch of each, profiled
    batch_csv = os.path.join(root, "batch.csv")
    with open(poly_csv) as f:
        lines = f.readlines()[:BATCH_SIZE + 1]
    with open(batch_csv, "w") as f:
        f.writelines(lines)
    steps = {name: (lambda name=name: train(name, "step", epochs=1,
                                            max_data_size=60))
             for name in configs}
    steps["ssl"] = lambda: ssl("step", epochs_stage2=1, max_data_size=50)
    reg_batch = os.path.join(root, "batch_reg.csv")
    with open(reg_csv) as f:
        lines = f.readlines()[:BATCH_SIZE + 1]
    with open(reg_batch, "w") as f:
        f.writelines(lines)
    # the atom_messages and multiclass models of step 4
    for name in ("atom_messages", "multiclass"):
        ckpts[name] = os.path.join(root, f"{name}_a", "fold_0", "model_0",
                                   "best_model.ckpt")
    serving = {name: (lambda name=name: serve(name, reg_batch, "batch"))
               for name in ("regression", "atom_messages", "multiclass")}
    serving["polymer"] = lambda: serve("polymer", batch_csv, "batch")
    serving["fingerprint"] = lambda: fingerprint("MPN", "batch", reg_batch)
    # one profile over every case, serving first: a short profile may miss
    # the kernels of its last calls; each case under its own dispatch log
    cases = ([(f"{k} serving batch", v) for k, v in serving.items()]
             + [(f"{k} training step", v) for k, v in steps.items()])
    logs = {}

    def run_cases():
        for what, fn in cases:
            logs[what] = OpLog(dev, hashes=False)
            with logs[what]:
                counted(fn)
    kernels = profile_kernels(run_cases, dev)
    for what, op_log in logs.items():
        # the kernels' plain versions dispatch index_add_ where the device
        # is the CPU (a rehearsal); on the card none runs
        atomics = {k: n for k, n in op_log.atomics.items()
                   if "_plain" not in k[1]}
        log(f"[determinism] {what}: {op_log.ops} operators dispatched, "
            f"float atomics among them {atomics or 'none'}")
        check(op_log.ops > 0 and not atomics,
              f"{what}: a float sum in no fixed order: {atomics}")
    bad = sorted(k for k in kernels if atomic_kernel(k))
    ours = {name: sum(kernels[k] for k in kernels if name in k)
            for name in ("band_rev_layer", "band_rev_bwd", "atom_readout")}
    log(f"[determinism] the profile of the {len(cases)} cases: "
        f"{len(kernels)} distinct kernels, {sum(kernels.values())} launches "
        f"(rows 1-3 {ours}); atomic float kernels {bad or 'none'}")
    check(dev != "cuda" or all(ours.values()),
          f"the profile missed the port's kernels: {ours}")
    check(not bad, f"kernels that add floats with atomics: {bad}")
    log(f"[determinism] phase 14 launches {launches} (tensor cores "
        f"{tc_launches}), {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches, tc_launches


# -- phase 15 ---------------------------------------------------------------

BENCH_DEVICE = "cuda"            # the lines' device (a rehearsal: "cpu")
BENCH_TRIALS = 3                 # trials a line (the module's default: 5)
BENCH_ARGS = []                  # further bench flags (a rehearsal: a size)
BENCH_SIZES = (1024, 2048, 4096, 50)   # the scaling probe's, vs the first
BENCH_PROBE_ARGS = ["--reps", "10", "--warm", "20"]
BENCH_HOLD_MOLECULES = 64
# flags, then (molecules the first step is held at, None: the line's own;
# rtol) of each training line
BENCH_LINES = {"default": ([], (None, 1e-4)),
               "fastband": (["--fastband"], (BENCH_HOLD_MOLECULES, 1e-2)),
               "polymer": (["--polymer"], (None, 1e-4)),
               "bf16": (["--bf16"], (BENCH_HOLD_MOLECULES, 2e-3)),
               "wide": (["--wide"], (BENCH_HOLD_MOLECULES, 1e-4)),
               "predict": (["--predict"], None),
               "compare": (["--compare"], None)}


def _bench_first_step(bench, flags, gb, device):
    """(loss, gnorm) of the first step of the bench line of ``flags`` on
    the batch ``gb`` on ``device``, from the line's own parameters."""
    _, kw = bench.line_config(bench.parse_args(flags))
    step, batch = bench.train_setup(gb, device, **kw)
    loss, gnorm = step(batch)
    return float(loss), float(gnorm)


def bench_path(card, gb):
    """Phase 15; ``gb`` is phase 1's bench batch (the bench's default
    batch: the same molecules, featurizer and padding)."""
    from polymer_chemprop_tpu_torch import bench
    from polymer_chemprop_tpu_torch.ops import band_mpnn as bm
    from polymer_chemprop_tpu_torch.probes import batch_scaling_probe
    t_phase = time.perf_counter()
    launches = dict.fromkeys(bm.launch_counts(), 0)
    tc_launches = dict.fromkeys(bm.tc_launch_counts(), 0)

    def counted(fn):
        bm.reset_launch_counts()
        out = fn()
        for k, v in bm.launch_counts().items():
            launches[k] += v
        for k, v in bm.tc_launch_counts().items():
            tc_launches[k] += v
        return out

    trials = ["--device", BENCH_DEVICE, "--trials", str(BENCH_TRIALS)]
    n_full = bench.parse_args(BENCH_ARGS).molecules
    full = {False: gb if gb.n_mols == n_full else bench.load_batch(n_full),
            True: bench.load_batch(n_full, polymer=True)}
    lines = {}
    for name, (flags, hold) in BENCH_LINES.items():
        t0 = time.perf_counter()
        batch = full["--polymer" in flags]
        out = counted(lambda: bench.main(flags + trials + BENCH_ARGS, batch))
        lines[name] = out
        for line in out:
            check(np.isfinite(line["value"]) and line["value"] > 0
                  and line["step_ms"] > 0, line)
        log(f"[bench] {name}: {out[-1]['value']:.1f} {out[-1]['unit']}, "
            f"{out[-1]['step_ms']:.4f} ms a step, vs_baseline "
            f"{out[-1]['vs_baseline']} ({time.perf_counter() - t0:.1f} s "
            f"on {card})")
        if hold is None:
            continue
        n, rtol = hold
        argv = flags + BENCH_ARGS
        if n is None:
            got = (out[-1]["first_loss"], out[-1]["first_gnorm"])
            n = n_full
        else:
            batch = bench.load_batch(n, "--polymer" in flags)
            got = counted(lambda: _bench_first_step(bench, argv, batch,
                                                    BENCH_DEVICE))
        want = _bench_first_step(bench, argv, batch, "cpu")
        log(f"[bench] {name}: first step (loss, gnorm) at {n} molecules, "
            f"{BENCH_DEVICE} {got} cpu {want}")
        np.testing.assert_allclose(got, want, rtol=rtol)
    yard, port = lines["compare"]
    check(yard["unit"] == "edges/s" and yard["vs_baseline"] == 1.0, yard)
    check((port["first_loss"], port["first_gnorm"])
          == (lines["default"][0]["first_loss"],
              lines["default"][0]["first_gnorm"]),
          f"--compare's first step differs from the default line's: "
          f"{port} {lines['default'][0]}")
    check(lines["predict"][0]["vs_baseline"] is None, lines["predict"])

    rows = counted(lambda: batch_scaling_probe.main(
        [str(n) for n in BENCH_SIZES] + ["--device", BENCH_DEVICE,
                                         "--trials", str(BENCH_TRIALS)]
        + BENCH_PROBE_ARGS, {n_full: full[False]}))
    for n, row in rows.items():
        check(all(v > 0 for p in batch_scaling_probe.PARTS
                  for v in row[p].values()), (n, row))
    log(f"[bench] phase 15 launches {launches} (tensor cores "
        f"{tc_launches}), {time.perf_counter() - t_phase:.1f} s on {card}")
    return launches, tc_launches


def main(argv) -> int:
    """The one-card run (no arguments), or ``--cards 4``: phases 1 and 2,
    then the four-card phase."""
    if argv not in ([], ["--cards", str(CARDS)]):
        print(f"usage: chip_smoke.py [--cards {CARDS}]", file=sys.stderr)
        return 2
    # the synthetic edge rules (as in the integration tests) sum to 0.5
    warnings.filterwarnings("ignore", message="sum of weights of incoming")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is available; this script runs only "
              "on the GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()
    card = card_and_build()
    gb = bench_batch()
    if argv:
        results, B, A = kernel_phase(dev, gb)
        launches = four_card_path(card, dev, gb, results)
        check(all(launches[k] > 0 for k in CARD_PATH_KERNELS),
              f"a kernel of the {CARDS}-card path never launched: "
              f"{launches}")
        # the probes' kernels (rows 8 and 10) are phase 6's alone
        print_kernels(results, launches, skip=("band_ctrl", "fused_matmul"))
    else:
        results, B, A, launches = one_card_phases(card, dev, gb)
        print_kernels(results, launches)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s "
        f"(kernel shape B={B} A={A} H={HIDDEN})")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def one_card_phases(card, dev, gb):
    """Phases 1 (the [host] lines) to 15 on the one card: the kernel
    results, the bench shape and every main path's launches."""
    host_phase(gb, card)
    results, B, A = kernel_phase(dev, gb)
    launches, tc_launches = main_path(card)
    fingerprint, fingerprint_tc = fingerprint_path(card)
    training, training_tc = training_path(card)
    plain_band, plain_band_tc = plain_band_path(card, dev)
    atom_messages = atom_messages_path(card)
    features, features_tc = extra_features_path(card)
    entry, entry_tc = entry_points_path(card)
    parallel = parallel_path(card, dev, gb, results)
    sklearn_path(card)
    goldens, goldens_tc = golden_path(card)
    polymer, polymer_tc = polymer_path(card)
    determinism, determinism_tc = determinism_path(card)
    bench_counts, bench_tc = bench_path(card, gb)
    for counts in (fingerprint, training, plain_band, atom_messages,
                   features, entry, parallel, goldens, polymer, determinism,
                   bench_counts, probe_path(card, dev, gb, results)):
        for name, count in counts.items():
            launches[name] = launches.get(name, 0) + count
    for counts in (fingerprint_tc, training_tc, plain_band_tc, features_tc,
                   entry_tc, goldens_tc, polymer_tc, determinism_tc,
                   bench_tc):
        for name, count in counts.items():
            tc_launches[name] += count
    check(all(count > 0 for count in launches.values()),
          f"a kernel was never launched by a main path: {launches}")
    check(all(count > 0 for count in tc_launches.values()),
          f"the tensor-core stage never ran on a main path: {tc_launches}")
    for name, count in tc_launches.items():
        results[name]["tc_launches"] = count
    return results, B, A, launches


def print_kernels(results, launches, skip=()) -> None:
    """The contract's ``kernels`` line: every kernel's numbers of this run
    (but those in ``skip``), its launches those of the main paths (every
    rank's)."""
    sources = {
        "band_rev_layer": ("polymer_chemprop_tpu_torch/csrc/band_rev_layer.cu",
                           "polymer_chemprop_tpu/ops/pallas_mpnn.py:1009"),
        "band_rev_bwd": ("polymer_chemprop_tpu_torch/csrc/band_rev_bwd.cu",
                         "polymer_chemprop_tpu/ops/pallas_mpnn.py:1074"),
        "atom_readout": ("polymer_chemprop_tpu_torch/csrc/atom_readout.cu",
                         "polymer_chemprop_tpu/ops/pallas_mpnn.py:1278"),
        "band_matmul_act": ("polymer_chemprop_tpu_torch/csrc/band_matmul.cu",
                            "polymer_chemprop_tpu/ops/pallas_mpnn.py:834"),
        "band_bwd": ("polymer_chemprop_tpu_torch/csrc/band_bwd.cu",
                     "polymer_chemprop_tpu/ops/pallas_mpnn.py:514"),
        "band_agg": ("polymer_chemprop_tpu_torch/csrc/band_agg.cu",
                     "polymer_chemprop_tpu/ops/pallas_mpnn.py:455"),
        "band_matmul": ("polymer_chemprop_tpu_torch/csrc/band_matmul.cu",
                        "polymer_chemprop_tpu/ops/pallas_mpnn.py:395"),
        "band_ctrl": ("polymer_chemprop_tpu_torch/csrc/band_ctrl.cu",
                      "scripts/band_mxu_probe.py:45"),
        "fused_matmul": ("polymer_chemprop_tpu_torch/csrc/fused_matmul.cu",
                         "scripts/fused_matmul_probe.py:30"),
        "atom_neighbor_sum": (
            "polymer_chemprop_tpu_torch/csrc/atom_readout.cu",
            "polymer_chemprop_tpu/ops/pallas_mpnn.py:1456"),
        "src_readout": ("polymer_chemprop_tpu_torch/csrc/atom_readout.cu",
                        "polymer_chemprop_tpu/ops/pallas_mpnn.py:1499"),
        # the JAX package's molecule readout is a segment sum, no kernel
        "molecule_readout": (
            "polymer_chemprop_tpu_torch/csrc/atom_readout.cu",
            "polymer_chemprop_tpu/ops/segment.py:66"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        if name in skip:
            continue
        r = results[name]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[COUNTED_AS.get(name, name)],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        # further timings of this run: launched from an idle stream, with z
        # written, at hidden 1,600, at the training batch's shape; the
        # probes' other rows
        entry.update({k: r[k] for k in (
            "ms_idle_start", "ms_with_z", "ms_h1600", "bound_ms_h1600",
            "ms_train_batch", "ms_train_batch_idle_start", "ms_pure",
            "library_ms_pure", "bound_ms_pure",
            "ms_layer_full", "ms_split", "library_tf32_ms",
            "max_rel_err_fp64", "ms_jax_shape", "library_ms_jax_shape",
            "library_tf32_ms_jax_shape", "bound_ms_jax_shape",
            "ms_highest", "ms_default", "bound_ms_highest",
            "ms_with_z_highest",
            "ms_train_batch_highest", "tc_launches", "bound_ms_train_batch",
            "bound_ms_train_batch_highest", "gbps", "gbps_train_batch",
            "gbps_h1600", "copy_ms", "launch_ms", "composed_ms",
            "ms_h1600_idle_start", "ms_warm", "ms_train_batch_warm",
            "ms_h1600_warm")
            if k in r})
        if name == "molecule_readout":
            # the whole op, the composition it replaced, its gather alone,
            # at the training batch, warm
            entry.update({k: v for k, v in r.items() if k not in entry})
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(rank_main(sys.argv[2:]))
    sys.exit(main(sys.argv[1:]))
