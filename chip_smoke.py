#!/usr/bin/env python3
"""Smoke run of mdbn_tpu_torch's training path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from mdbn_tpu_torch/csrc (nvcc, sm_90a: cd_train.cu,
cd_train_wide.cu, cd_train_resident.cu (its plain variant, its estimator
modes without and with a tempering ladder, and the data-parallel step of
each: six libraries), cd_train_wide_modes.cu, cd_grads.cu and
cd_grads_wide.cu, each at float32 and bfloat16 storage, in parallel) and
runs twenty-nine phases, one line each (25 to 28 run after 4, 23 and 24
after 5, 29 last):

1. device: torch and CUDA versions, the card's name and power limit, build time,
   and each compiled function's registers, stack and spill bytes (ptxas -v);
2. cd_train.cu against its plain PyTorch version on the card, inject mode with
   hardened uniforms: the whole run at c1's width (784x500, B 20, CD-1,
   2 epochs), and every update of a run at c5's tower recipe on c2's width
   (Gaussian 2000x400, k=2, PCD, momentum 0.5, L2 1e-4, mean-field visibles,
   2 epochs) replayed one at a time;
3. c1 through RBM.train (configs/c1_bernoulli_rbm_mnist.json, 10 epochs,
   engine "pallas"): the kernel select_kernel names (the resident kernel,
   csrc/cd_train_resident.cu) ran and no other, and the final error is
   within 0.001 of 0.0744 (GRADED_RUNS.md);
4. c4 through MDBN.train (configs/c4_mdbn_3modality.json): every layer on the
   kernel select_kernel names for it (the resident kernel), finite [400, 100]
   codes, each layer's error falls;
5. cd_train.cu, called directly, and plain updates/s at c1's shape, and the
   kernel's median time per phase of an update (its own clock stamps, each
   phase with its barrier);
6. the estimator modes, each kernel against plain at full width for 2 epochs
   with hardened draws, on the resident kernel (its kModes variant, which
   select_kernel names for all four) and on cd_train.cu: tempering (pt5:
   784x500, 5 rungs) and learned variance (lv: Gaussian 2000x200 on
   scale-corrupted GE) replayed one update at a time, the enhanced gradient
   (784x500) and the pseudo-likelihood monitor (c1) as whole runs; the
   counters show that the kernel compared alone ran;
7. each mode trained for 10 epochs through RBM.train (engine "pallas"): the
   kernel select_kernel names launched once and no other, final errors
   inside PARITY.md's bands, the pseudo monitor falls;
8. time per epoch of each mode in turns (plain, resident, cd_train.cu,
   cd_train.cu, resident, plain), each kernel's steps from its trace and the
   resident kernel's barriers an update;
9. the wide slice (scripts/bench_wide.py's shapes, Gaussian, batch 20:
   20000x400 plain, x512, learned variance, momentum, momentum at bf16
   storage, enhanced, 3-rung tempering at bf16 on cd_train.cu; 28000x400,
   40000x1000 bf16 and 20000x400 at batch 64 on the W-blocked kernel):
   each kernel against its plain version at full width for 2 epochs, whole
   runs at float32, one update at a time for PCD, tempering, momentum and
   bf16 storage (one bf16 ulp); a 20000-wide row that the admission rule
   gives to another kernel (the W-blocked kernel, or the strip-split kernel
   of the estimator modes, cd_train_wide_modes.cu, for learned variance, the
   enhanced gradient and tempering) is compared on both kernels; which
   kernel launched, by the counters; identical bits on grids of 1, 7 and 132
   blocks and the default (w20k, w20k_pt3_bf16, w28k, w40k_bf16 on the row's
   kernel; w20k_pt3_bf16, w20k_enh and w20k_lv on cd_train_wide_modes.cu);
10. 20000x400, 20000x400 with momentum at bf16, 28000x400 and 40000x1000 bf16
    (W-blocked kernel), 20000x400 enhanced, with learned variance and with
    3-rung tempering at bf16 (cd_train_wide_modes.cu) for 10 epochs through
    RBM.train (engine "pallas"): the kernel the admission rule picks
    launched and no other, parameters finite, the monitor falls;
11. kernel and plain time per epoch of each wide row (on both kernels, in
    turns, where phase 9 compared both), each kernel's phases (the median of
    each trace stamp), and the bound (what of W and its velocity the L2
    cannot hold moves once per update; the velocity is read only under
    momentum);
12. the data-parallel path's per-step kernels, the resident kernel's step
    variant (cd_train_resident.cu, the route select_dp_kernel gives where a
    rank's tiles fit) and cd_grads.cu, each against their plain version on
    the same hardened draws, one step each, at full width: c1 (784x500,
    batch 20), c1's third shard of a 3-way split of 20 (7 rows, one pad row
    masked, norm 20/3) with mse and with xent and sparsity, and c5's tower
    recipe at c2's width (Gaussian 2000x400, PCD k=2, sparsity); identical
    bits on grids of 1, 7 and 132 blocks (cd_grads.cu) and on two cluster
    counts (the step variant); each one's device time per launch, the plain
    version's and the bound;
13. the update after the all-reduce (cd_grads.cu's second kernel) against its
    plain version on the summed statistics of 3 ranks, at c1's settings and at
    c5's tower recipe with momentum, decay and clipping: the same bits; its
    time per launch, the plain version's, one fused torch.optim.SGD step's
    (the same update, for comparison only) and the bound;
14. dp_world1: train_rbm_shard_map(pallas_step=True) on a one-rank NCCL mesh,
    c1 for 10 epochs as a captured epoch replayed (a CUDA graph of 100 x step
    kernel, all-reduce, update kernel): 1000 launches of the step variant and
    of the update kernel, none of cd_grads.cu's, the final error within 0.001
    of 0.0744, the same bits as the eager loop of the same launches; then
    ms an epoch captured and eager (a 21-epoch call against a 1-epoch call,
    each way), five one-epoch calls one at a time, and the card's busy share
    over a 21-epoch call's device time, each way (torch.profiler);
15. dp_ranks: RBM.train with a mesh of 3 gloo ranks, one process each, all on
    the one card, c1 for 10 epochs: the engine is cuda_dp on every rank, 1000
    launches of the route's step kernel (the step variant: 7 rows a rank)
    and of the update kernel on each, the parameters bit-identical across
    ranks, the error in the band; then 2 epochs on injected per-rank draws
    held against a replay in this process (per-shard plain step, mean,
    update) at rtol 2e-4 / atol 2e-6; then 2 epochs of PCD k=2, whose chain
    is gathered from the ranks and must agree on every rank;
16. the data-parallel path in every mode (DP_MODES: pt5, enhanced, lv and
    pseudo of phase 6, lv with 3 rungs, c1 at bf16 storage and compute,
    w20k_mom_bf16 of the wide slice): the step kernels (cd_grads.cu, and the
    step variant wherever its tiles fit: not at w20k_mom_bf16, nor pt3_lv's
    whole batch) against their plain version at full width,
    the whole flat buffer (the enhanced gradient's mean sums and learned
    variance's raw z statistic included; at bf16 compute to one operand
    ulp, _stats_close) and the chain, on the whole batch and on the third
    shard of a 3-way split (7 rows, one pad row, norm 20/3); identical bits
    on grids of 1, 7 and 132 blocks and on two cluster counts; each step
    kernel's time per step, the plain version's and the bound;
17. the update kernel against its plain version on 3 ranks' summed
    statistics for lv, enhanced and the two bf16 rows: every elementwise
    result bit for bit, the enhanced gradient's b and c and learned
    variance's z at the replay tolerance; the times, and the enhanced
    gradient's matvec pass (cd_enhance_kernel) on its own;
18. dp_world1_modes: each mode for 10 epochs through
    train_rbm_shard_map(pallas_step=True) on a one-rank NCCL mesh, captured
    on every route: the kernels of the route select_dp_kernel
    gives launched once a step and the other routes' never (pt3_lv at
    2000x200 fits no cluster and takes cd_grads.cu, w20k_mom_bf16
    cd_grads_wide.cu, the others the step variant), the final error in the
    mode's PARITY.md band (pt3_lv, pseudo and bf16: the monitor falls);
    the eager loop's bits, ms an epoch captured and eager, and the busy
    share;
19. dp_ranks_modes: each mode but w20k_mom_bf16 (phase 22) over 3 gloo ranks
    through RBM.train(mesh=...) for 2 epochs: engine cuda_dp, the route's
    kernels launched, bit-identical parameters across ranks; then an
    injected run held against a replay in this process (float32: 2 epochs
    at rtol 2e-4 / atol 2e-6; bf16: one update at a time, one ulp);
20. kernel_vs_plain_wide_dp: the W-blocked kernel's data-parallel mode
    (cd_grads_wide.cu, its update in cd_wide_update.cuh) at w20k,
    w20k_mom_bf16, w28k and w40k_bf16: the step against its plain version on
    the whole batch and on a 7-row shard with a pad row; the update on 3
    ranks' gathered slots (uneven) and 4 ranks' (even), at the row's
    momentum and under a schedule from 0 (m = 0 on the velocity variant,
    then 0.5); identical bits and monitor on grids 1, 7, 132 and the
    default; device time per launch of both kernels (and of the step on a
    shard of B / 4 rows), their plain versions', bounds, the update's
    library form (one addmm into the velocity, then W += vW) and its trace;
    cd_grads.cu's step and update at the same shapes; the bytes a rank sends
    on each route;
21. dp_world1_wide: the same rows for 10 epochs through
    train_rbm_shard_map(pallas_step=True) on a one-rank NCCL mesh, each
    epoch a replayed CUDA graph (step, all-gather, update, nb times): the
    cd_grads_wide kernels once a step, cd_grads never, the monitor falls, the
    eager loop's bits, ms an epoch captured and eager and the busy share (at
    least 90% captured); w20k_mom_bf16 across a momentum switch from 0,
    captured against eager; then three updates one at a time against
    cd_train_wide.cu on the same injected draws (whether the bits match);
22. dp_ranks_wide: w20k_mom_bf16 over 3 gloo ranks through
    RBM.train(mesh=...): the cd_grads_wide kernels launched, bit-identical
    parameters across ranks, an injected run against the W-blocked route's
    plain replay one update at a time to one bf16 ulp;
23. kernel_vs_plain_resident: the resident kernel against its plain version
    (cd_train_run_plain) at c1, c2, c4's GE tower's second layer (400x100),
    c5's tower recipe at c2's width (PCD, k=2, momentum 0.5, L2 1e-4) and c1
    at bf16 storage and compute, 2 epochs on hardened draws (the last two one
    update at a time, bf16 to one ulp), the counters showing that it alone
    ran; the same bits on the default cluster count and the smallest that
    holds the tiles (where only one count holds them, as at c2's width, on
    two counts of the same config at batch 4);
24. timing_resident: one epoch per call of each of those shapes, in the
    order plain, resident, cd_train.cu, cd_train.cu, resident, plain; the
    resident kernel's median time per step of an update from its trace (k +
    1 tile barriers an update), and the bound;
25. analysis_cli: the CLI's analysis path through mdbn_tpu_torch.run.main:
    configs/c5_pcd_kmeans.json as committed (every layer on the resident
    kernel by the counters; the kmeans record's ARI against the planted
    clusters at least 0.99 and, at ARI 1, its log-rank p equal to
    GRADED_RUNS.md's 9.0e-20 to two digits), then on c5's saved model
    (--load) an impute block holding out meth (its MSE under the
    row-shuffled control's) and consensus k selection at 10 resamples, then
    c1_real_mnist_idx and c4_real_omics_csv on fixture files written to a
    temporary directory (scripts/torch_run_graded_configs.py's recipe): each
    exits 0 on the resident kernel, c4_real with a kmeans record of three
    non-empty clusters;
26. k300: each kernel source at k = 300 against its plain version on
    hardened injected draws (cd_train.cu, the resident kernel's three
    variants and the two wide kernels over 2 updates at the run tolerance,
    cd_grads.cu's step and cd_grads_wide.cu's step on a 7-row shard at the
    replay tolerance, cd_grads.cu's update bit for bit), with the largest
    difference of each; then RBM.train(engine="pallas") at k = 300 launches
    the kernel select_kernel names, and no other.
27. finetune: the phase-2 trainers (no kernel of their own: eager PyTorch on
    the card). c3's DBN and c4's MDBN trained as committed (their layers on
    the kernel select_kernel names, the resident kernel, by the counters),
    then each mode (classifier, autoencoder, label_top, updown,
    updown_labeled) for 10 epochs through the models' methods: every
    parameter, head, decoder and generative tensor on the card and finite,
    the losses falling, the planted classes recovered (accuracy >= 0.9);
    c3 with a labeled up-down block at label_fraction 0.3 and c4 with a
    classifier block through the CLI (mdbn_tpu_torch.run.main), their
    records; the first epoch of each mode on the card against the same call
    on the CPU on the draws the CPU run made, at rtol = atol = 1e-4, TF32
    off (every tensor; the autoencoder by its codes and reconstructions, as
    Adam moves a weight whose gradient is at rounding level by up to lr
    either way, and the count of its weights past the tolerance is
    printed); save -> load on the card keeping predict, predict_generative,
    reconstruct and generate bit for bit; one epoch of each mode at 784 ->
    500 -> 500 (mnist_like, 2000 rows, batch 20) timed with CUDA events, and
    the card's busy share over one up-down epoch from a torch.profiler trace.
28. ais: AIS on the card (no kernel of its own: eager PyTorch, float32, TF32
    off). c1, c2 and c3 trained as committed (the resident kernel, by the
    counters); c1's log-likelihood at the CLI's defaults (1,000 rows, 256
    chains, 1,000 betas) and its SMC bracket (resample init, resample_ess
    0.5), c2's log-likelihood, c3's DBN bound and, after labeled up-down,
    its labeled bound, all finite; the anneal's tensors and recorded draws on
    the card; the anneals (plain, SMC, Gaussian, labeled) at 10 betas under
    torch.cuda.set_sync_debug_mode("error"); the card against the CPU's
    replay of its recorded draws at c1's width (32 chains, 100 betas: the
    chains whose states agree at 1e-4, log Z too where none parted, and the
    95% t-intervals of five seeds on each device overlapping); 12x8 within
    0.15 of exact enumeration; c1's default anneal timed plain and SMC, and
    the card's busy share over one from a torch.profiler trace; the CLI's
    ais block on c1 (then --load), c3 and c3 after labeled up-down (then
    --load), each record with the reference's keys; one training with
    runtime profile on writes a trace holding the kernel's launch.
29. dp_tp_ranks: the dp x tp mesh (parallel.mesh.make_mesh_2d, 2 x 2: 4 gloo
    ranks, one process each, all on the one card), the tensor-parallel route
    (parallel.tp, no kernel of its own: the eager engine with W, c and the
    chain split over the hidden units, the tp row's all-reduces of the sums
    over hidden units, the dp column's of the statistics). c1 for 10 epochs
    through RBM.train(mesh=...): engine eager_tp on every rank, no kernel
    counter moved, the same whole state on every rank (the gather checks
    that the dp replicas of each shard hold the same bits), the final error
    within 0.001 of the single-device eager run on the card and of 0.0744;
    w20k for 2 epochs on hardened injected draws against the single-device
    eager run on the same draws at rtol 1e-4 / atol 1e-5; the same mesh
    through the CLI (torchrun --nproc-per-node 4, --dp 2 --tp 2, 2 epochs);
    ms an epoch of the tp route at c1 and w20k (CUDA events over a 2-epoch
    call, less its gather of the state; the better of two calls; rank 0's
    and each rank's) and the share of it in the tp and dp collectives
    (parallel.tp.CollectiveTimer), beside the single-device eager run's and
    the kernel's (train_rbm, 10 epochs against 1, the least of three
    pairs).

Then a JSON line describing the kernels, and last
{"ok": true, "device": ...}. Exits non-zero, printing no result, when there
is no CUDA device, when the package is missing, or when any phase fails.
Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
C1 = os.path.join(HERE, "configs", "c1_bernoulli_rbm_mnist.json")
C2 = os.path.join(HERE, "configs", "c2_gaussian_rbm_ge.json")
C4 = os.path.join(HERE, "configs", "c4_mdbn_3modality.json")
C5 = os.path.join(HERE, "configs", "c5_pcd_kmeans.json")
C3 = os.path.join(HERE, "configs", "c3_dbn_3layer.json")
# The phase-2 trainers (phase 27): each mode for FT_EPOCHS epochs on c3's
# DBN and c4's MDBN; the first epoch on the card against the CPU on the same
# injected draws at FT_RTOL / FT_ATOL (TF32 off); the planted classes must be
# recovered to FT_ACC_MIN by the label modes
FT_MODES = ("classifier", "autoencoder", "label_top", "updown", "updown_labeled")
FT_EPOCHS, FT_RTOL, FT_ATOL, FT_ACC_MIN = 10, 1e-4, 1e-4, 0.9
AIS_CARD_RTOL = 1e-4  # the card's anneal against the CPU's replay of its draws
AIS_EXACT_TOL = 0.15  # tests/test_ais.py: |AIS - exact| at 12x8, 256 chains, 2,000 betas
C5_ARI_MIN = 0.99  # c5's kmeans record against its planted clusters
C5_LOGRANK_P = 9.0e-20  # GRADED_RUNS.md: the same planted times on the same partition
K300 = 300  # Gibbs steps past the 255 the Philox counter word once held
C1_FINAL_ERR, C1_ERR_TOL = 0.0744, 0.001  # GRADED_RUNS.md, --epochs 10
# kernel vs plain, same inputs and draws: the two differ only in the order of
# fp32 sums (the kernel's fixed-order FMAs vs cuBLAS). Over c1's 200 CD-1
# updates that stays far below RTOL/ATOL; one flipped sample would show as
# ~lr/B = 5e-3. One update replayed from the same state agrees to ~1e-8.
RTOL, ATOL = 1e-4, 1e-4
REPLAY_RTOL, REPLAY_ATOL = 1e-5, 1e-6
# The estimator modes (scripts/parity_harness.py:150-190): the final error
# after 10 epochs must lie in PARITY.md's band (5 seeds of each side); the
# pseudo monitor has no PARITY row, and must fall over the run.
MODE_BANDS = {"pt5": (0.0741, 0.001), "enhanced": (0.0746, 0.001),
              "lv": (0.9553, 0.005), "pseudo": None}
MODE_REPLACES = {"pt5": 995, "enhanced": 1568, "lv": 980, "pseudo": 654}
REPLAYED_MODES = ("pt5", "lv")  # PCD-like dynamics: compared one update at a time
# NVIDIA H100 SXM peaks (NVIDIA's data sheet): f32 on CUDA cores, bf16 on the
# tensor cores (dense), HBM
PEAK_F32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 67e12, 989e12, 3.35e12
# The wide slice (scripts/bench_wide.py's shapes): name -> (config fields on
# top of WIDE_BASE, data rows, the kernel the row is compared and timed on,
# compared one update at a time). cd_train.cu is asked for on the 20000-wide
# rows that the admission rule gives to the W-blocked kernel (WIDE_ADMITTED)
# or to the strip-split kernel of the estimator modes (WIDE_MODES_ADMITTED):
# those rows are held against their plain version on both kernels.
WIDE_BASE = dict(visible="gaussian", lr=0.001, batch_size=20, k=1, seed=0)
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
WIDE_ROWS = {
    "w20k": (dict(n_visible=20000, n_hidden=400), 400, "cd_train", False),
    "w20k_h512": (dict(n_visible=20000, n_hidden=512), 400, "cd_train", False),
    "w20k_lv": (dict(n_visible=20000, n_hidden=400, learn_variance=True), 400, "cd_train",
                False),
    "w20k_mom": (dict(n_visible=20000, n_hidden=400, momentum=0.5), 400, "cd_train", True),
    "w20k_mom_bf16": (dict(n_visible=20000, n_hidden=400, momentum=0.5, **BF16), 400,
                      "cd_train", True),
    "w20k_enh": (dict(n_visible=20000, n_hidden=400, gradient="enhanced"), 400, "cd_train",
                 False),
    "w20k_pt3_bf16": (dict(n_visible=20000, n_hidden=400, persistent=True, pt_temps=3,
                           pt_beta_min=0.3, **BF16), 400, "cd_train", True),
    "w28k": (dict(n_visible=28000, n_hidden=400), 400, "cd_train_wide", False),
    "w40k_bf16": (dict(n_visible=40000, n_hidden=1000, **BF16), 200, "cd_train_wide", True),
    "w20k_b64": (dict(n_visible=20000, n_hidden=400, batch_size=64), 640, "cd_train_wide",
                 False),
}
WIDE_ADMITTED = ("w20k", "w20k_h512", "w20k_mom", "w20k_mom_bf16", "w28k", "w40k_bf16",
                 "w20k_b64")  # select_kernel gives these to cd_train_wide.cu
WIDE_MODES_ADMITTED = ("w20k_lv", "w20k_enh", "w20k_pt3_bf16")  # ... to cd_train_wide_modes.cu
# through RBM.train: four rows in the W-blocked kernel's scope, and the three
# estimator-mode rows, which the strip-split kernel of the modes takes
WIDE_TRAINED = ("w20k", "w20k_mom_bf16", "w28k", "w40k_bf16", "w20k_enh", "w20k_pt3_bf16",
                "w20k_lv")
GRID_ROWS = ("w20k", "w20k_pt3_bf16", "w28k", "w40k_bf16")  # run on grids 1, 7, 132 too
GRID_MODES_ROWS = ("w20k_pt3_bf16", "w20k_enh", "w20k_lv")  # the same on cd_train_wide_modes.cu
# The data-parallel path: 3 ranks on the one card split c1's batch of 20 into
# shards of 7 rows, the last with one pad row. Its replay is held at the
# tolerance of tests/test_pallas_dp.py: the all-reduce adds the shards in
# another order than the replay's mean, norm 20/3 is not an integer, and 200
# updates carry the differences on.
DP_RANKS, DP_RTOL, DP_ATOL = 3, 2e-4, 2e-6
DP_RANKS_LIMIT_S = 240.0  # the spawned ranks' whole run (34 s on an H100)
GRADS_GRIDS = (1, 7, 132)
# The data-parallel path in every mode (phases 16-19): the estimator modes at
# full width (mode_configs), learned variance with 3 rungs, c1 at bf16
# storage and compute, and the wide slice's w20k_mom_bf16; pt3_lv, the
# pseudo monitor and the bf16 runs have no band and must fall. The update kernel is compared where its arithmetic differs
# from the plain CD/PCD update of phase 13.
DP_MODES = ("pt5", "enhanced", "lv", "pt3_lv", "pseudo", "c1_bf16", "w20k_mom_bf16")
DP_MODE_BANDS = {**MODE_BANDS, "pt3_lv": None, "c1_bf16": None, "w20k_mom_bf16": None}
DP_UPDATE_MODES = ("lv", "enhanced", "c1_bf16", "w20k_mom_bf16")
DP_RANK_ROWS = 400  # rows each mode trains on over the 3 gloo ranks (20 steps an epoch)
# The dp x tp mesh (phase 29): 4 gloo ranks on the one card as a 2 x 2 grid
# (NCCL refuses two ranks on one device). A tp run is the single-device eager
# run up to the order of the sums, held at the tolerance of
# tests/test_distributed.py:140-151; c1's final error within TP_ERR_TOL of the
# single-device eager run's.
DP_TP, DP_TP_LIMIT_S = (2, 2), 600.0
TP_TOL = dict(rtol=1e-4, atol=1e-5)
TP_ERR_TOL, TP_W20K_EPOCHS, TP_EPOCHS_TIMED, SINGLE_EPOCHS_TIMED = 0.001, 2, 2, 10
PSEUDO_BIT = 5
STEP_KERNELS = ("cd_train_resident_kernel", "cd_grads_kernel",
                "cd_wide_step_kernel")  # the DP step kernels' names


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def ptxas_summary(log: str) -> list:
    """nvcc -Xptxas -v's report, one entry per compiled function (a kernel,
    or a phase compiled as a function of its own): its name with its leading
    bool or int template arguments (a kernel's or phase's first is bf16
    compute; update_units' second is momentum, the resident kernel's its
    variant, kModes), registers (kernels), stack frame and spill bytes."""
    import re

    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            mangled, name = m.group(1), None
            # <length><name>I<args>; a length may follow a hash's digits
            for d in re.finditer(r"(\d+)(?=[A-Za-z_])", mangled):
                for k in range(1, min(3, len(d.group(1))) + 1):
                    end = d.end() + int(d.group(1)[-k:])
                    if mangled[end:end + 1] == "I":
                        args = re.match(r"I((?:L[bi]\d+E)*)", mangled[end:]).group(1)
                        name = (f"{mangled[d.end():end]}"
                                f"<{','.join(re.findall(r'L[bi](\d+)E', args))}>")
            cur = {"function": name or mangled[-40:]}
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def mode_configs(c1, c1_data, ge_lv):
    """name -> (config, data) of the estimator modes at full width; ge_lv is
    the learned-variance mode's data (ge_scaled)."""
    from mdbn_tpu_torch.config import RBMConfig

    base = dict(n_visible=784, n_hidden=500, k=1, lr=0.1, batch_size=20)
    return {"pt5": (RBMConfig(**base, persistent=True, pt_temps=5, pt_beta_min=0.2), c1_data),
            "enhanced": (RBMConfig(**base, gradient="enhanced"), c1_data),
            "lv": (RBMConfig(n_visible=2000, n_hidden=200, visible="gaussian",
                             learn_variance=True, lr=0.005, batch_size=20), ge_lv),
            "pseudo": (c1.replace(error_metric="pseudo"), c1_data)}


def ge_scaled(ge):
    """GE with a planted per-gene scale (scripts/parity_harness.py:176-179),
    the learned-variance mode's data."""
    import numpy as np
    import torch

    sig = np.exp(np.random.default_rng(0).uniform(-1.0, 1.0, ge.shape[1])).astype(np.float32)
    return ge * torch.as_tensor(sig, device=ge.device)


def update_flops(cfg) -> float:
    """Operations of one update: 2*rows*V*H for every product the run needs
    (the hidden phase from the data, a visible and a hidden phase per Gibbs
    step on all chain rows, the data chain's reconstruction under PCD, the
    ladder's log p*(h) inputs under tempering, learned variance's W h0p and
    W hmean, the two gradient products). The swap rounds' and the monitors'
    elementwise work is under 2% of it and left out."""
    B, V, H = cfg.batch_size, cfg.n_visible, cfg.n_hidden
    CR = B * max(cfg.pt_temps, 1)
    rows = B + 2 * cfg.k * CR + 2 * B
    rows += B if cfg.persistent and cfg.error_metric != "pseudo" else 0
    rows += CR if cfg.pt_temps > 1 else 0
    rows += 2 * B if cfg.learn_variance else 0
    return 2.0 * rows * V * H


def bound(cfg, nb: int, l2_bytes: int):
    """(ms, what bounds it): the least time the card needs for one epoch of
    nb updates, the larger of its operations at the peak rate of the compute
    dtype and of its bytes at the memory rate. Bytes, at the storage width:
    the data read once; b, c, z, their velocities and the chain read and
    written once; W read and written once; W's velocity written once, and
    read once only under momentum (at momentum 0 the run stores lr*g and
    never needs the old value). What of W, and then of its velocity, the L2
    cannot hold between updates moves once per update instead."""
    B, V, H = cfg.batch_size, cfg.n_visible, cfg.n_hidden
    width = 2 if cfg.param_dtype == "bfloat16" else 4
    w = V * H * width
    vel_moves = 2 if cfg.momentum != 0 or cfg.initial_momentum is not None else 1
    rest = (2 * (V + H) + (2 * V if cfg.learn_variance else 0)
            + B * max(cfg.pt_temps, 1) * H) * width
    keep_w = min(w, l2_bytes)
    keep_vel = min(w, l2_bytes - keep_w)
    once = 2 * keep_w + vel_moves * keep_vel + 2 * rest
    per_update = 2 * (w - keep_w) + vel_moves * (w - keep_vel)
    moved = nb * B * V * width + once + nb * per_update
    peak = PEAK_BF16_FLOPS if cfg.compute_dtype == "bfloat16" else PEAK_F32_FLOPS
    ops_s = update_flops(cfg) * nb / peak
    bytes_s = moved / PEAK_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def _inputs(cfg, data, n_epochs, device, seed, harden=True, wide=False):
    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.ops import cd_epoch_cuda as K

    import torch

    nb = data.shape[0] // cfg.batch_size
    st = init_train_state(cfg, device=device)
    u = K.draw_uniform_blocks(cfg, torch.Generator(device=device).manual_seed(seed),
                              n_epochs, nb)
    if harden:
        u = K.harden_uniform_blocks(cfg, st.params, st.velocity, st.chain_h, data, u,
                                    n_epochs, wide=wide)
    return st, u, nb


def _max_diff(got, want, rtol, atol, off=None) -> float:
    """Assert kernel output ``got`` matches ``want``; return the largest |diff|.
    float32 state: rtol and atol. bf16 state: both sides round float32
    results into bf16, so they agree except where the two results straddle a
    rounding boundary. A velocity is rounded once: it may differ by one bf16
    ulp (at most 2^-7 of its value). A parameter is old + rounded velocity,
    rounded once more: it may differ by the velocity's ulp and one of its
    own. atol covers values near zero, where the float32 results themselves
    differ by more than a bf16 ulp. ``off`` counts the bf16 elements that
    differ."""
    import torch

    names = [(i, n) for i in (1, 0) for n in ("W", "b", "c", "z")
             if getattr(want[i], n) is not None]
    err = 0.0
    for i, n in names:
        a, b = getattr(got[i], n), getattr(want[i], n)
        if not bool(torch.isfinite(a).all()):
            raise AssertionError("kernel output is not finite")
        if b.dtype == torch.bfloat16:
            a, b = a.float(), b.float()
            big = torch.maximum(a.abs(), b.abs())
            if i == 0:  # a parameter: its velocity's ulp carries into it
                big = big + torch.maximum(getattr(got[1], n).float().abs(),
                                          getattr(want[1], n).float().abs())
            d = (a - b).abs()
            over = d > big * 2.0 ** -7 + atol
            if bool(over.any()):
                at = int((d - big * 2.0 ** -7).argmax())
                raise AssertionError(
                    f"{'v' * i}{n}: {int(over.sum())} bf16 values differ by over one ulp; the "
                    f"worst: kernel {float(a.flatten()[at])}, plain {float(b.flatten()[at])}")
            if off is not None:
                off[0] += int((d > 0).sum())
                off[1] += d.numel()
        else:
            torch.testing.assert_close(a, b, rtol=rtol, atol=atol)
        err = max(err, float((a - b).abs().max()))
    torch.testing.assert_close(got[3], want[3], rtol=rtol, atol=atol)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)  # chain: identical samples
    return max(err, float((got[3] - want[3]).abs().max()))


def _runners(wide, clusters=None, modes=False):
    """(kernel, plain) of a comparison: the W-blocked pair when ``wide``; the
    resident kernel on ``clusters`` clusters (0: its default) when that is
    not None; the strip-split kernel of the estimator modes
    (csrc/cd_train_wide_modes.cu) when ``modes``."""
    from mdbn_tpu_torch.ops import cd_epoch_cuda as K
    from mdbn_tpu_torch.ops import cd_epoch_resident_cuda as R
    from mdbn_tpu_torch.ops import cd_epoch_wide_cuda as KW
    from mdbn_tpu_torch.ops import cd_epoch_wide_modes_cuda as WMC

    def kernel(*args):
        if clusters is not None:
            return R.cd_train_resident_run(*args, grid=clusters)
        if modes:
            return WMC.cd_train_wide_modes_run(*args)
        return K.cd_train_run(*args, wide=wide)

    return kernel, KW.cd_train_wide_run_plain if wide else K.cd_train_run_plain


def compare_run(cfg, data, n_epochs, device, seed, wide=False, clusters=None,
                modes=False) -> float:
    """The whole n_epochs run on the kernel and on the plain version, from the
    same state with the same hardened draws (``clusters``, ``modes``: see
    _runners)."""
    from mdbn_tpu_torch.ops import cd_epoch_cuda as K

    import torch

    st, u, nb = _inputs(cfg, data, n_epochs, device, seed, wide=wide)
    order = K.batch_order(cfg, nb, n_epochs, None)
    kernel, plain = _runners(wide, clusters, modes)
    got = kernel(cfg, st.params, st.velocity, st.chain_h, data, order, 0, u)
    want = plain(cfg, st.params, st.velocity, st.chain_h, data, order, 0, u)
    torch.cuda.synchronize()
    return _max_diff(got, want, RTOL, ATOL)


def compare_replay(cfg, data, n_epochs, device, seed, wide=False, off=None,
                   clusters=None, modes=False) -> float:
    """Every update of the kernel's own n_epochs trajectory, replayed by the
    plain version from the same state. PCD with momentum amplifies fp32
    rounding differences from update to update (the plain version on the CPU
    and on the GPU drift apart the same way), and a bf16 state that differs
    by one ulp stays apart, so the run is compared one update at a time; the
    per-epoch errors are the means of the updates'.
    Each update's draws are hardened against the state that update starts
    from, so no draw sits on a knife edge however far the run has gone."""
    from mdbn_tpu_torch.ops import cd_epoch_cuda as K

    import torch

    st, u, nb = _inputs(cfg, data, n_epochs, device, seed, harden=False)
    B = cfg.batch_size
    one = torch.zeros((1, 1), dtype=torch.int32)
    p, v, chain = st.params, st.velocity, st.chain_h
    kernel, plain = _runners(wide, clusters, modes)
    err, errs_k, errs_p = 0.0, [], []
    for e in range(n_epochs):
        for i in range(nb):
            d = data[i * B:(i + 1) * B]
            ui = K.harden_uniform_blocks(
                cfg, p, v, chain, d, {k: x[e:e + 1, i:i + 1] for k, x in u.items()}, 1,
                start_epoch=e, wide=wide)
            got = kernel(cfg, p, v, chain, d, one, e, ui)
            want = plain(cfg, p, v, chain, d, one, e, ui)
            err = max(err, _max_diff(got, want, REPLAY_RTOL, REPLAY_ATOL, off=off))
            errs_k.append(got[3])
            errs_p.append(want[3])
            p, v, chain = got[:3]
    ek = torch.cat(errs_k).view(n_epochs, nb).mean(1)
    ep = torch.cat(errs_p).view(n_epochs, nb).mean(1)
    torch.testing.assert_close(ek, ep, rtol=REPLAY_RTOL, atol=REPLAY_ATOL)
    return max(err, float((ek - ep).abs().max()))


def time_runs(fn, reps: int) -> float:
    """Mean seconds per call of ``fn`` on the card, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


# device_us calls in which torch.profiler saw no kernel of the names asked
# for, with the time queued_device_us took instead and whether the card ran
# the calls back to back; printed as the "device_timing" phase before the
# kernels line
PROFILER_MISSES: list = []
PROFILER_TRIES = 3
# device_us sessions in which the profiler saw fewer (or more) events of the
# named kernels than the calls launched; the time is per event seen
PROFILER_SHORT: list = []


def device_us(fn, reps: int, names=None) -> float:
    """Device time per call of ``fn`` in us: torch.profiler's CUDA activity
    over ``reps`` calls after one warm-up call. With ``names``, each named
    kernel (a kernel whose name contains the name) launched once a call,
    its time per event seen, summed over the names seen: a session in a long
    process can drop events (recorded in PROFILER_SHORT), so a total over
    the calls reads low. Without, every kernel's device time over ``reps``.
    A loop of launches timed with CUDA events measures the host's launch
    rate instead whenever the host takes longer per launch than the kernel
    runs. The profiler now and then reports no CUDA activity for a session;
    such a session is profiled again, and after PROFILER_TRIES empty
    sessions the calls are timed by ``queued_device_us`` (recorded in
    PROFILER_MISSES)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        keys = list(names) if names is not None else [None]
        total, seen = dict.fromkeys(keys, 0.0), dict.fromkeys(keys, 0)
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            if not ev.count:
                continue
            for n in keys:
                # None: the kernels, device time and no CPU time of their own
                if (us > 0 and ev.self_cpu_time_total == 0) if n is None else n in ev.key:
                    total[n] += us
                    seen[n] += ev.count
                    break
        if names is None and seen[None]:
            return total[None] / reps
        if names is not None and any(seen.values()):
            short = {n: c for n, c in seen.items() if c and c != reps}
            if short:
                PROFILER_SHORT.append({"names": list(names), "events": short, "launched": reps})
            return sum(total[n] / seen[n] for n in names if seen[n])
    us, queued = queued_device_us(fn, reps)
    PROFILER_MISSES.append({"names": list(names or ["any"]), "sessions": PROFILER_TRIES,
                            "events_us": us, "back_to_back": queued})
    return us


def queued_device_us(fn, reps: int) -> tuple:
    """(device time per call of ``fn`` in us, whether the card ran the calls
    back to back), by CUDA events around ``reps`` calls that the host queues
    while the card runs a sleep kernel, so the card runs them back to back
    whatever the host's launch rate. The sleep is lengthened until the card
    is still in it when the last call is queued; if it never is, the last
    try's time, which then holds the host's gaps too. Counts every kernel
    ``fn`` launches."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 50_000_000  # about 25 ms at the H100's clock
    for _ in range(5):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()  # the card has not reached the first call yet
        torch.cuda.synchronize()
        if queued:
            break
        cycles *= 4
    return start.elapsed_time(end) * 1e3 / reps, queued


def run_modes(dev, smi, c1, c1_data, ge) -> list:
    """Phases 6-8, the estimator modes on the kernel select_kernel names (the
    resident kernel) and on cd_train.cu; returns their entries of the kernel
    line."""
    import numpy as np
    import torch

    from mdbn_tpu_torch import RBM
    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.ops import cd_epoch_cuda as K
    from mdbn_tpu_torch.ops import cd_epoch_resident_cuda as R

    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    modes = mode_configs(c1, c1_data, ge_scaled(ge))
    kernels = {name: K.select_kernel(cfg, R.device_limits(cfg, dev))
               for name, (cfg, _) in modes.items()}
    if set(kernels.values()) != {"cd_train_resident"}:
        raise AssertionError(f"the modes do not all take the resident kernel: {kernels}")

    # 6. each kernel against plain, 2 epochs each, hardened draws; the
    # counters show that the kernel compared alone ran
    errs = {"cd_train_resident": {}, "cd_train": {}}
    for name, (cfg, data) in modes.items():
        compare = compare_replay if name in REPLAYED_MODES else compare_run
        for kern, clusters in (("cd_train_resident", 0), ("cd_train", None)):
            zero_train_counts()
            errs[kern][name] = compare(cfg, data, 2, dev, seed=2, clusters=clusters)
            check_counts(f"{name}@{kern}", {kern: train_counts()[kern]})
    phase("kernel_vs_plain_modes", max_abs_err=errs, replayed=list(REPLAYED_MODES),
          run_rtol=RTOL, run_atol=ATOL, replay_rtol=REPLAY_RTOL, replay_atol=REPLAY_ATOL)

    # 7. each mode through RBM.train; the kernel select_kernel names launched
    # once and no other
    trained, launches = {}, {}
    for name, (cfg, data) in modes.items():
        zero_train_counts()
        rbm = RBM(cfg.replace(epochs=10, engine="pallas"), device=dev).train(data)
        launches[name] = check_counts(name, {kernels[name]: 1})
        hist = rbm.history
        if rbm.metrics.engine != "cuda" or rbm.metrics.kernel != kernels[name]:
            raise AssertionError(f"{name} did not run on {kernels[name]}: engine "
                                 f"{rbm.metrics.engine}, kernel {rbm.metrics.kernel}")
        if len(hist) != 10 or not all(np.isfinite(hist)):
            raise AssertionError(f"{name}: errors {hist}")
        band = MODE_BANDS[name]
        if band is None and not hist[-1] < hist[0]:
            raise AssertionError(f"{name}: the monitor did not fall: {hist}")
        if band is not None and abs(hist[-1] - band[0]) > band[1]:
            raise AssertionError(f"{name}: final error {hist[-1]} not within {band[1]} of "
                                 f"{band[0]}")
        trained[name] = {"kernel": kernels[name], "first_err": hist[0], "final_err": hist[-1],
                         "band": band}
    phase("modes_train", launches=launches, errors=trained)

    # 8. one epoch of each mode per call: plain, resident, cd_train.cu,
    # cd_train.cu, resident, plain; each kernel's steps from its trace
    timing, entries = {}, []
    for name, (cfg, data) in modes.items():
        st = init_train_state(cfg, device=dev)
        nb = data.shape[0] // cfg.batch_size
        order = K.batch_order(cfg, nb, 1, None)
        gen = torch.Generator().manual_seed(0)
        args = (cfg, st.params, st.velocity, st.chain_h, data, order, 0, None, gen)

        def resident(trace=None):
            R.cd_train_resident_run(*args, trace=trace)

        def cd_train(trace=None):
            K.cd_train_run(*args, trace=trace)

        def plain():
            K.cd_train_run_plain(*args)

        t = {}
        for key, fn, reps in (("plain1", plain, 2), ("resident1", resident, 10),
                              ("cd_train1", cd_train, 10), ("cd_train2", cd_train, 10),
                              ("resident2", resident, 10), ("plain2", plain, 2)):
            t[key] = time_runs(fn, reps) * 1e3
        t_res, t_old = min(t["resident1"], t["resident2"]), min(t["cd_train1"], t["cd_train2"])
        t_plain = min(t["plain1"], t["plain2"])
        steps = {}
        for kern, fn, names in (("cd_train_resident", resident, R.resident_trace_phases(cfg)),
                                ("cd_train", cd_train, K.trace_phases(cfg))):
            trace = torch.zeros((1, nb, len(names) + 1), dtype=torch.int64, device=dev)
            fn(trace=trace)
            torch.cuda.synchronize()
            spans = (trace[0, :, 1:] - trace[0, :, :-1]).double().median(0).values / 1e3
            steps[kern] = dict(zip(names, spans.tolist()))
        res_steps = R.resident_trace_phases(cfg)
        bound_ms, bound_by = bound(cfg, nb, l2)
        timing[name] = {
            "updates_per_run": nb, "resident_ms": t_res, "cd_train_ms": t_old,
            "plain_ms": t_plain, "calls_ms": t,
            "resident_us_per_update": t_res * 1e3 / nb,
            "cd_train_us_per_update": t_old * 1e3 / nb, "bound_ms": bound_ms,
            "bound_by": bound_by, "flops_per_update": update_flops(cfg),
            "resident_barriers_per_update": {
                b: sum(p.endswith(f":{b}") for p in res_steps)
                for b in ("tile_barrier", "cluster_barrier")},
            "resident_phase_us_median": steps["cd_train_resident"],
            "cd_train_phase_us_median": steps["cd_train"]}
        for kern, source, ms, launched in (
                ("cd_train_resident", "cd_train_resident.cu", t_res,
                 launches[name]["cd_train_resident"]),
                ("cd_train", "cd_train.cu", t_old, launches[name]["cd_train"])):
            entries.append({
                "name": f"{kern}[{name}]", "route": "cuda",
                "source": f"mdbn_tpu_torch/csrc/{source}",
                "replaces": f"mdbn_tpu/ops/cd_epoch_pallas.py:{MODE_REPLACES[name]}",
                "launches": launched, "max_abs_err": errs[kern][name], "ms": ms,
                "plain_ms": t_plain, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "ms_per": f"one epoch of {name} ({nb} updates)"})
    phase("timing_modes", order="plain, resident, cd_train, cd_train, resident, plain",
          nvidia_smi=smi, modes=timing)
    return entries


def wide_row(name, dev):
    """(config, data) of the wide row ``name``: standard normal data [n, V]
    from a seeded generator, at the storage dtype."""
    import torch

    from mdbn_tpu_torch.config import RBMConfig
    from mdbn_tpu_torch.core.rbm_math import torch_dtype

    fields, n = WIDE_ROWS[name][:2]
    cfg = RBMConfig(**{**WIDE_BASE, **fields})
    gen = torch.Generator(device=dev).manual_seed(0)
    data = torch.randn((n, cfg.n_visible), generator=gen, device=dev)
    return cfg, data.to(torch_dtype(cfg.param_dtype))


def wide_rows(dev):
    """name -> (config, data, kernel, replayed) of the wide slice."""
    return {name: (*wide_row(name, dev), kernel, replayed)
            for name, (_, _, kernel, replayed) in WIDE_ROWS.items()}


def wide_admitted(name) -> str:
    """The kernel select_kernel gives the wide row ``name``."""
    return ("cd_train_wide" if name in WIDE_ADMITTED else
            "cd_train_wide_modes" if name in WIDE_MODES_ADMITTED else "cd_train")


def trace_phases_of(kernel, cfg) -> list:
    """The phases a trace of ``kernel`` stamps for one update of ``cfg``."""
    from mdbn_tpu_torch.ops import cd_epoch_cuda as K
    from mdbn_tpu_torch.ops import cd_epoch_wide_cuda as KW
    from mdbn_tpu_torch.ops import cd_epoch_wide_modes_cuda as WMC

    return {"cd_train": K.trace_phases, "cd_train_wide": KW.wide_trace_phases,
            "cd_train_wide_modes": WMC.wide_modes_trace_phases}[kernel](cfg)


def run_wide(dev, smi) -> list:
    """The wide slice's phases; returns its entries of the kernel line."""
    import numpy as np
    import torch

    from mdbn_tpu_torch import RBM
    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.ops import cd_epoch_cuda as K
    from mdbn_tpu_torch.ops import cd_epoch_wide_modes_cuda as WMC

    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    rows = wide_rows(dev)

    def only(kernel, name):
        """Assert that ``kernel`` alone of the train kernels was launched
        since the counts were set to 0; how often."""
        return check_counts(name, {kernel: train_counts()[kernel]})[kernel]

    # kernel against plain at full width, 2 epochs, hardened draws, on the
    # row's kernel and, where the admission rule picks the other one, on that
    # too (keyed "<row>@cd_train_wide")
    errs, off = {}, {}
    for name, (cfg, data, kernel, replayed) in rows.items():
        admitted = K.select_kernel(cfg)
        if admitted != wide_admitted(name):
            raise AssertionError(f"{name}: the admission rule picks {admitted}")
        for kern in dict.fromkeys((kernel, admitted)):
            key = name if kern == kernel else f"{name}@{kern}"
            wide, modes = kern == "cd_train_wide", kern == "cd_train_wide_modes"
            zero_train_counts()
            if replayed:
                n_off = [0, 0]
                errs[key] = compare_replay(cfg, data, 2, dev, seed=3, wide=wide, off=n_off,
                                           modes=modes)
                if n_off[1]:
                    off[key] = {"differ": n_off[0], "of": n_off[1]}
            else:
                errs[key] = compare_run(cfg, data, 2, dev, seed=3, wide=wide, modes=modes)
            only(kern, key)
    # identical bits whatever the grid: 1, 7 and 132 blocks against the default,
    # two updates with the kernel's own draws; the GRID_ROWS on the row's
    # kernel, the GRID_MODES_ROWS on cd_train_wide_modes.cu
    grid_checks = [(n, rows[n][2]) for n in GRID_ROWS] + [(n, "cd_train_wide_modes")
                                                         for n in GRID_MODES_ROWS]
    for name, kern in grid_checks:
        cfg, data = rows[name][:2]
        st = init_train_state(cfg, device=dev)
        order = K.batch_order(cfg, 2, 1, None)
        runs = [K.kernel_run(kern)(cfg, st.params, st.velocity, st.chain_h,
                                   data[: 2 * cfg.batch_size], order, 0, None,
                                   torch.Generator().manual_seed(7), grid=g)
                for g in (0, 1, 7, 132)]
        for r in runs[1:]:
            same = all(torch.equal(x, y) for i in (0, 1) for x, y in
                       zip(r[i].as_dict().values(), runs[0][i].as_dict().values()))
            if not (same and torch.equal(r[2], runs[0][2]) and torch.equal(r[3], runs[0][3])):
                raise AssertionError(f"{name}: the result of {kern} depends on the grid")
    # asking for the W-blocked kernel outside its scope raises
    cfg_lv, data_lv = rows["w20k_lv"][:2]
    st = init_train_state(cfg_lv, device=dev)
    try:
        K.cd_train_run(cfg_lv, st.params, st.velocity, st.chain_h, data_lv,
                       K.batch_order(cfg_lv, data_lv.shape[0] // cfg_lv.batch_size, 1, None),
                       0, None, torch.Generator().manual_seed(0), wide=True)
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("the W-blocked kernel took a learned-variance config")
    # and so does asking for the strip-split kernel of the modes on the plain estimator
    cfg_w, data_w = rows["w20k"][:2]
    st = init_train_state(cfg_w, device=dev)
    try:
        WMC.cd_train_wide_modes_run(
            cfg_w, st.params, st.velocity, st.chain_h, data_w,
            K.batch_order(cfg_w, data_w.shape[0] // cfg_w.batch_size, 1, None), 0, None,
            torch.Generator().manual_seed(0))
    except ValueError as e:
        modes_refusal = str(e)
    else:
        raise AssertionError("the strip-split kernel of the modes took a plain config")
    phase("kernel_vs_plain_wide", max_abs_err=errs, bf16_elements_one_ulp_apart=off,
          replayed=[n for n, r in rows.items() if r[3]], run_rtol=RTOL, run_atol=ATOL,
          replay_rtol=REPLAY_RTOL, replay_atol=REPLAY_ATOL,
          bf16_tolerance="a velocity one bf16 ulp (2^-7 of its value), a parameter its "
                         "velocity's ulp and one of its own, + replay_atol",
          identical_bits_on_grids={"grids": [1, 7, 132, "default"],
                                   "rows": [f"{n}@{k}" for n, k in grid_checks]},
          outside_scope_raises=[refusal, modes_refusal])

    # wide_train: through RBM.train on the kernel the admission rule picks
    trained, launches = {}, {}
    for name in WIDE_TRAINED:
        cfg, data = rows[name][:2]
        kernel = wide_admitted(name)
        zero_train_counts()
        t0 = time.perf_counter()
        rbm = RBM(cfg.replace(epochs=10, engine="pallas"), device=dev).train(data)
        seconds = time.perf_counter() - t0
        launches[name] = {kernel: only(kernel, name)}
        hist = rbm.history
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in rbm.params.as_dict().values())
        if rbm.metrics.engine != "cuda" or not finite:
            raise AssertionError(f"{name}: engine {rbm.metrics.engine}, finite {finite}")
        if len(hist) != 10 or not all(np.isfinite(hist)) or not hist[-1] < hist[0]:
            raise AssertionError(f"{name}: the monitor did not fall: {hist}")
        trained[name] = {"kernel": kernel, "launches": launches[name][kernel],
                         "first_err": hist[0],
                         "final_err": hist[-1], "seconds": round(seconds, 3)}
    phase("wide_train", runs=trained)

    # timing_wide: one epoch per call; a row that the admission rule gives to
    # another kernel is timed on both, in turns: plain, each kernel, each
    # kernel in reverse order, plain (the better of each side's two times)
    timing = {}
    for name, (cfg, data, kernel, _) in rows.items():
        st = init_train_state(cfg, device=dev)
        nb = data.shape[0] // cfg.batch_size
        order = K.batch_order(cfg, nb, 1, None)
        gen = torch.Generator().manual_seed(0)
        bound_ms, bound_by = bound(cfg, nb, l2)
        kerns = list(dict.fromkeys((kernel, K.select_kernel(cfg))))
        plains = list(dict.fromkeys(k == "cd_train_wide" for k in kerns))

        def kernel_fn(kern, trace=None):
            K.kernel_run(kern)(cfg, st.params, st.velocity, st.chain_h, data, order, 0, None,
                               gen, trace=trace)

        def plain_fn(wide):
            _runners(wide)[1](cfg, st.params, st.velocity, st.chain_h, data, order, 0, None,
                              gen)

        t_plain = {w: [time_runs(lambda w=w: plain_fn(w), 2)] for w in plains}
        t_kern = {k: [] for k in kerns}
        for kern in kerns + kerns[::-1]:
            t_kern[kern].append(time_runs(lambda kern=kern: kernel_fn(kern), 5))
        for w in plains[::-1]:
            t_plain[w].append(time_runs(lambda w=w: plain_fn(w), 2))
        for kern in kerns:
            phases = trace_phases_of(kern, cfg)
            trace = torch.zeros((1, nb, len(phases) + 1), dtype=torch.int64, device=dev)
            kernel_fn(kern, trace=trace)
            torch.cuda.synchronize()
            spans = (trace[0, :, 1:] - trace[0, :, :-1]).double().median(0).values / 1e3
            tk, tp = t_kern[kern], t_plain[kern == "cd_train_wide"]
            t_kernel, t_plain_min = min(tk), min(tp)
            timing[name if kern == kernel else f"{name}@{kern}"] = {
                "kernel": kern, "updates_per_run": nb, "kernel_ms": t_kernel * 1e3,
                "plain_ms": t_plain_min * 1e3,
                "kernel_ms_calls": [t * 1e3 for t in tk],
                "plain_ms_calls": [t * 1e3 for t in tp],
                "kernel_us_per_update": t_kernel * 1e6 / nb,
                "plain_us_per_update": t_plain_min * 1e6 / nb,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "flops_per_update": update_flops(cfg),
                "kernel_phase_us_median": dict(zip(phases, spans.tolist()))}
    phase("timing_wide", order="plain, each kernel, each kernel in reverse, plain",
          nvidia_smi=smi, l2_bytes=l2, rows=timing)

    def entry(name, row, line, what, key=None):
        t = timing[key or row]
        return {"name": name, "route": "cuda",
                "source": f"mdbn_tpu_torch/csrc/{t['kernel']}.cu",
                "replaces": f"mdbn_tpu/ops/cd_epoch_pallas.py:{line}",
                "launches": launches[row].get(t["kernel"], 0), "max_abs_err": errs[key or row],
                "ms": t["kernel_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None,
                "ms_per": f"one epoch of {row} ({t['updates_per_run']} updates): {what}"}

    return [entry("cd_train[w20k_enh]", "w20k_enh", 755,
                  "a wide-state mode's shape outside the W-blocked kernel's scope, float32"),
            entry("cd_train_bf16", "w20k_pt3_bf16", 970, "bf16 storage"),
            entry("cd_train_wide", "w28k", 1981, "the W-blocked kernel, float32"),
            entry("cd_train_wide[w40k_bf16]", "w40k_bf16", 1981,
                  "the W-blocked kernel, bf16 storage and compute"),
            entry("cd_train_wide[w20k]", "w20k", 1981,
                  "the W-blocked kernel where cd_train.cu was timed too",
                  key="w20k@cd_train_wide"),
            entry("cd_train_wide[w20k_mom_bf16]", "w20k_mom_bf16", 1981,
                  "the W-blocked kernel under momentum at bf16",
                  key="w20k_mom_bf16@cd_train_wide"),
            entry("cd_train_wide_modes[w20k_pt3_bf16]", "w20k_pt3_bf16", 995,
                  "the strip-split kernel of the modes: tempering (3 rungs), bf16 storage and "
                  "compute", key="w20k_pt3_bf16@cd_train_wide_modes"),
            entry("cd_train_wide_modes[w20k_enh]", "w20k_enh", 1568,
                  "the strip-split kernel of the modes: the enhanced gradient, float32",
                  key="w20k_enh@cd_train_wide_modes"),
            entry("cd_train_wide_modes[w20k_lv]", "w20k_lv", 980,
                  "the strip-split kernel of the modes: learned variance, float32",
                  key="w20k_lv@cd_train_wide_modes")]


def train_counts() -> dict:
    """The single-device train kernels' launch counters."""
    from mdbn_tpu_torch.ops import cd_epoch_cuda as K
    from mdbn_tpu_torch.ops import cd_epoch_resident_cuda as R
    from mdbn_tpu_torch.ops import cd_epoch_wide_cuda as KW
    from mdbn_tpu_torch.ops import cd_epoch_wide_modes_cuda as WMC

    return {"cd_train": K.cd_train_launches, "cd_train_wide": KW.cd_train_wide_launches,
            "cd_train_resident": R.cd_train_resident_launches,
            "cd_train_wide_modes": WMC.cd_train_wide_modes_launches}


def zero_train_counts() -> None:
    from mdbn_tpu_torch.ops import cd_epoch_cuda as K
    from mdbn_tpu_torch.ops import cd_epoch_resident_cuda as R
    from mdbn_tpu_torch.ops import cd_epoch_wide_cuda as KW
    from mdbn_tpu_torch.ops import cd_epoch_wide_modes_cuda as WMC

    K.cd_train_launches = KW.cd_train_wide_launches = R.cd_train_resident_launches = 0
    WMC.cd_train_wide_modes_launches = 0


def check_counts(name, expected: dict) -> dict:
    """Assert that the train kernels launched as often as ``expected`` says
    ({kernel: launches}, every other kernel never) since the counts were set
    to 0; the counts."""
    got = train_counts()
    want = {k: expected.get(k, 0) for k in got}
    if got != want or not any(want.values()):
        raise AssertionError(f"{name}: expected the launches {want}, got {got}")
    return got


def resident_shapes(dev, c1, c1_data, ge):
    """name -> (config, data, replayed) of the resident kernel's phases: c1;
    c2 (Gaussian 2000x400, mean-field visibles); c4's GE tower's second layer
    (400x100, on seeded probabilities); c5's tower recipe at c2's width (PCD,
    k=2, momentum 0.5, L2 1e-4) and c1 at bf16 storage and compute, both one
    update at a time (compare_replay; bf16 to one ulp)."""
    import torch

    from mdbn_tpu_torch.config import load_config

    c2 = load_config(C2)["model"]
    ge_tower = load_config(C4)["model"].towers["ge"]
    c4_ge1 = ge_tower.rbm_config(1, ge_tower.layer_sizes[0])
    gen = torch.Generator(device=dev).manual_seed(4)
    probs = torch.rand((400, c4_ge1.n_visible), generator=gen, device=dev)
    return {"c1": (c1, c1_data, False), "c2": (c2, ge, False),
            "c4_ge1": (c4_ge1, probs, False),
            "c5_tower": (c2.replace(k=2, persistent=True, momentum=0.5, l2=1e-4), ge, True),
            "c1_bf16": (c1.replace(**BF16), c1_data.to(torch.bfloat16), True)}


def resident_cluster_counts(cfg, dev) -> list:
    """The default cluster count of ``cfg`` and the smallest that still
    holds its tiles (most strips a block), when there is one."""
    from mdbn_tpu_torch.ops import cd_epoch_resident_cuda as R

    smem, maxc = R.device_limits(cfg, dev)
    first = R.resident_tiles(cfg, smem, maxc).clusters
    for g in range(1, first):
        try:
            R.resident_tiles(cfg, smem, maxc, clusters=g)
        except ValueError:
            continue
        return [first, g]
    return [first]


def run_resident(dev, smi, c1, c1_data, ge, main_launches: int) -> list:
    """Phases 23-24, the resident kernel; returns its entries of the kernel
    line (``main_launches``: its launches on the main path, phases 3-4)."""
    import torch

    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.ops import cd_epoch_cuda as K
    from mdbn_tpu_torch.ops import cd_epoch_resident_cuda as R

    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    shapes = resident_shapes(dev, c1, c1_data, ge)

    # 23. against the plain version on hardened draws (2 epochs); the same
    # bits on two cluster counts (one epoch, the kernel's own draws)
    errs, counts, same, off = {}, {}, {}, {}
    for name, (cfg, data, replayed) in shapes.items():
        if K.select_kernel(cfg, R.device_limits(cfg, dev)) != "cd_train_resident":
            raise AssertionError(f"{name}: select_kernel does not give the resident kernel")
        zero_train_counts()
        if replayed:
            n_off = [0, 0]
            errs[name] = compare_replay(cfg, data, 2, dev, seed=5, off=n_off, clusters=0)
            if n_off[1]:
                off[name] = {"differ": n_off[0], "of": n_off[1]}
        else:
            errs[name] = compare_run(cfg, data, 2, dev, seed=5, clusters=0)
        check_counts(name, {"cd_train_resident": train_counts()["cd_train_resident"]})
        counts[name] = resident_cluster_counts(cfg, dev)
        checks = [(name, cfg)]
        if len(counts[name]) == 1:  # two strips fit one block at batch 4: two counts there
            checks.append((f"{name}@B4", cfg.replace(batch_size=4)))
            counts[checks[1][0]] = resident_cluster_counts(checks[1][1], dev)
        for key, c in checks:
            st = init_train_state(c, device=dev)
            order = K.batch_order(c, data.shape[0] // c.batch_size, 1, None)
            runs = [R.cd_train_resident_run(c, st.params, st.velocity, st.chain_h, data,
                                            order, 0, None, torch.Generator().manual_seed(9),
                                            grid=g)
                    for g in counts[key]]
            same[key] = None if len(runs) < 2 else all(torch.equal(x, y) for x, y in zip(
                [*runs[1][0].as_dict().values(), *runs[1][1].as_dict().values(), runs[1][2],
                 runs[1][3]],
                [*runs[0][0].as_dict().values(), *runs[0][1].as_dict().values(), runs[0][2],
                 runs[0][3]]))
            if same[key] is False:
                raise AssertionError(f"{key}: the bits depend on the cluster count "
                                     f"({counts[key]})")
        if not any(same[key] for key, _ in checks):
            raise AssertionError(f"{name}: no two cluster counts hold the tiles ({counts})")
    phase("kernel_vs_plain_resident", max_abs_err=errs, bf16_elements_one_ulp_apart=off,
          replayed=[n for n, x in shapes.items() if x[2]], run_rtol=RTOL, run_atol=ATOL,
          replay_rtol=REPLAY_RTOL, replay_atol=REPLAY_ATOL, cluster_counts=counts,
          identical_bits_across_cluster_counts=same,
          tiles={n: dataclasses.asdict(R.resident_tiles(c, *R.device_limits(c, dev)))
                 for n, (c, _, _) in shapes.items()})

    # 24. one epoch per call: plain, resident, cd_train.cu, cd_train.cu,
    # resident, plain; the resident kernel's steps from its trace
    timing, entries = {}, []
    for name, (cfg, data, _) in shapes.items():
        st = init_train_state(cfg, device=dev)
        nb = data.shape[0] // cfg.batch_size
        order = K.batch_order(cfg, nb, 1, None)
        gen = torch.Generator().manual_seed(0)
        args = (cfg, st.params, st.velocity, st.chain_h, data, order, 0, None, gen)

        def resident(trace=None):
            R.cd_train_resident_run(*args, trace=trace)

        def cd_train():
            K.cd_train_run(*args, wide=False)

        def plain():
            K.cd_train_run_plain(*args)

        t = {}
        for key, fn, reps in (("plain1", plain, 2), ("resident1", resident, 20),
                              ("cd_train1", cd_train, 20), ("cd_train2", cd_train, 20),
                              ("resident2", resident, 20), ("plain2", plain, 2)):
            t[key] = time_runs(fn, reps) * 1e3
        t_res, t_old = min(t["resident1"], t["resident2"]), min(t["cd_train1"], t["cd_train2"])
        t_plain = min(t["plain1"], t["plain2"])
        phases = R.resident_trace_phases(cfg)
        trace = torch.zeros((1, nb, len(phases) + 1), dtype=torch.int64, device=dev)
        resident(trace)
        torch.cuda.synchronize()
        spans = (trace[0, :, 1:] - trace[0, :, :-1]).double().median(0).values / 1e3
        bound_ms, bound_by = bound(cfg, nb, l2)
        timing[name] = {
            "updates_per_run": nb, "resident_ms": t_res, "cd_train_ms": t_old,
            "plain_ms": t_plain, "calls_ms": t,
            "resident_us_per_update": t_res * 1e3 / nb,
            "cd_train_us_per_update": t_old * 1e3 / nb, "bound_ms": bound_ms,
            "bound_by": bound_by, "tile_barriers_per_update": sum(
                p.endswith(":tile_barrier") for p in phases),
            "resident_phase_us_median": dict(zip(phases, spans.tolist()))}
        entries.append({
            "name": f"cd_train_resident[{name}]", "route": "cuda",
            "source": "mdbn_tpu_torch/csrc/cd_train_resident.cu",
            "replaces": "mdbn_tpu/ops/cd_epoch_pallas.py:692", "launches": main_launches,
            "max_abs_err": errs[name], "ms": t_res, "plain_ms": t_plain,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "ms_per": f"one epoch of {name} ({nb} updates); launches: the kernel's on the "
                      "main path (c1 and c4 through the API, c5, c1_real and c4_real "
                      "through the CLI; phase 27's pretraining of c3 and c4 through the "
                      "API and through the CLI)"})
    phase("timing_resident", order="plain, resident, cd_train, cd_train, resident, plain",
          nvidia_smi=smi, l2_bytes=l2, shapes=timing)
    return entries


def grads_bound(cfg):
    """(ms, what bounds it) of one step of the per-step kernel: operations
    2*rows*V*H for the hidden phase from the data, a visible and a hidden
    phase per Gibbs step on all chain rows, the data chain's reconstruction
    under PCD (not under pseudo), the ladder's h W^T under tempering,
    learned variance's W h0p and W hmean, and the gradient's 2B rows, at the
    peak of the compute dtype; bytes: W, b, c (z), v0 read and the chain read
    and written once at the storage width, the flat statistics written once
    (f32)."""
    from mdbn_tpu_torch.ops.cd_grads_cuda import flat_size

    B, V, H = cfg.batch_size, cfg.n_visible, cfg.n_hidden
    CR = B * max(cfg.pt_temps, 1)
    rows = 3 * B + 2 * cfg.k * CR
    rows += B if cfg.persistent and cfg.error_metric != "pseudo" else 0
    rows += CR if cfg.pt_temps > 1 else 0
    rows += 2 * B if cfg.learn_variance else 0
    peak = PEAK_BF16_FLOPS if cfg.compute_dtype == "bfloat16" else PEAK_F32_FLOPS
    ops_s = 2.0 * rows * V * H / peak
    width = 2 if cfg.param_dtype == "bfloat16" else 4
    state = V * H + V + H + (V if cfg.learn_variance else 0) + B * V + 2 * CR * H
    bytes_s = (width * state + 4.0 * flat_size(cfg)) / PEAK_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def grads_cases(dev, c1, c1_data, ge):
    """name -> (config at the shard's rows, v0, mask, norm) of the per-step
    kernel's comparison, at full width."""
    import torch

    from mdbn_tpu_torch.config import RBMConfig

    shard = torch.cat([c1_data[14:20], torch.zeros_like(c1_data[:1])])  # rank 2 of 3, one pad
    mask = torch.tensor([1.0] * 6 + [0.0], device=dev)[:, None]
    c5_tower = RBMConfig(n_visible=2000, n_hidden=400, visible="gaussian", k=2, persistent=True,
                         lr=0.005, batch_size=20, sparsity_target=0.1, sparsity_cost=0.1)
    return {"c1": (c1, c1_data[:20], None, None),
            "c1_rank2_of_3": (c1.replace(batch_size=7), shard, mask, 20 / 3),
            "c1_xent_sparsity_rank2_of_3": (
                c1.replace(batch_size=7, error_metric="xent", sparsity_target=0.1,
                           sparsity_cost=0.1), shard, mask, 20 / 3),
            "c5_tower_c2": (c5_tower, ge[:20], None, None)}


def _grads_state(cfg, dev, seed):
    """Parameters with some structure (W at 10x its init scale, small biases)
    and a random 0/1 chain."""
    import torch

    from mdbn_tpu_torch.core.rbm_math import RBMParams
    from mdbn_tpu_torch.core.state import init_train_state

    st = init_train_state(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = RBMParams(W=st.params.W * 10.0,
                  b=0.1 * torch.randn(cfg.n_visible, generator=gen, device=dev),
                  c=0.1 * torch.randn(cfg.n_hidden, generator=gen, device=dev))
    chain = (torch.rand((cfg.batch_size, cfg.n_hidden), generator=gen, device=dev) < 0.5).float()
    return p, st.velocity, chain


def step_cluster_counts(cfg, dev) -> list:
    """The resident step variant's default cluster count for ``cfg`` and the
    smallest that still holds its tiles, when there is one."""
    from mdbn_tpu_torch.ops import cd_epoch_resident_cuda as R
    from mdbn_tpu_torch.ops import cd_grads_resident_cuda as GR

    smem, maxc = GR.step_limits(cfg, dev)
    first = R.resident_tiles(cfg, smem, maxc).clusters
    for g in range(1, first):
        try:
            R.resident_tiles(cfg, smem, maxc, clusters=g)
        except ValueError:
            continue
        return [first, g]
    return [first]


def _same_steps(runs) -> bool:
    """Whether every (grads, chain, err) of ``runs`` has the first's bits."""
    import torch

    return all(all(torch.equal(x, y) for x, y in zip(r[0].as_dict().values(),
                                                     runs[0][0].as_dict().values()))
               and torch.equal(r[1], runs[0][1]) and torch.equal(r[2], runs[0][2])
               for r in runs[1:])


def run_grads(dev, smi, c1, c1_data, ge):
    """Phase 12: the per-step kernels, the resident kernel's step variant and
    cd_grads.cu, against their plain version; their timing. Returns
    {kernel: (max abs diff, timing dict)}."""
    import torch

    from mdbn_tpu_torch.ops import cd_grads_cuda as G
    from mdbn_tpu_torch.ops import cd_grads_resident_cuda as GR
    from mdbn_tpu_torch.ops.cd_step import draw_uniforms

    errs, grids, clusters = {}, {}, {}
    steps = {"cd_grads": G.cd_grads_step, "cd_grads_resident": GR.cd_grads_resident_step}
    for n, (name, (cfg, v0, mask, norm)) in enumerate(grads_cases(dev, c1, c1_data, ge).items()):
        p, vel, chain = _grads_state(cfg, dev, n)
        u = draw_uniforms(cfg, cfg.batch_size, torch.Generator(device=dev).manual_seed(n))
        u = G.harden_step(cfg, p, chain, v0, u)
        want = G.cd_grads_step_plain(cfg, p, v0, chain, uniforms=u, mask=mask, norm=norm)
        for kernel, step in steps.items():
            got = step(cfg, p, v0, chain, uniforms=u, mask=mask, norm=norm)
            torch.cuda.synchronize()
            diff = {}
            for part, a, b in (("gW", got[0].W, want[0].W), ("gb", got[0].b, want[0].b),
                               ("gc", got[0].c, want[0].c), ("err", got[2], want[2])):
                if not bool(torch.isfinite(a).all()):
                    raise AssertionError(f"{kernel} {name}: {part} is not finite")
                torch.testing.assert_close(a, b, rtol=REPLAY_RTOL, atol=REPLAY_ATOL)
                diff[part] = float((a - b).abs().max())
            torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)  # the same samples
            diff["chain"] = float((got[1] - want[1]).abs().max())
            errs[f"{kernel}@{name}"] = diff
        if name in ("c1", "c1_rank2_of_3"):  # the kernels' own draws on several grids
            runs = [G.cd_grads_step(cfg, p, v0, chain, seed=11, mask=mask, norm=norm, grid=g)
                    for g in (0,) + GRADS_GRIDS]
            if not _same_steps(runs):
                raise AssertionError(f"{name}: the step depends on the grid")
            grids[name] = list(GRADS_GRIDS) + ["default"]
            counts = step_cluster_counts(cfg, dev)
            runs = [GR.cd_grads_resident_step(cfg, p, v0, chain, seed=11, mask=mask, norm=norm,
                                              grid=g) for g in counts]
            if len(counts) < 2 or not _same_steps(runs):
                raise AssertionError(f"{name}: the step variant depends on the cluster count "
                                     f"(counts {counts})")
            clusters[name] = counts
    max_err = {k: max(max(d.values()) for n, d in errs.items() if n.startswith(k + "@"))
               for k in steps}

    # timing at c1's shape: each kernel alone (its launch on fixed buffers),
    # the wrappers, and the plain version; plain, kernels, kernels in
    # reverse, plain; device time per launch from torch.profiler
    cfg, v0 = c1, c1_data[:20]
    p, _, chain = _grads_state(cfg, dev, 0)
    launch = {"cd_grads": G.step_launcher(cfg, p, v0, chain, seed=5)[0],
              "cd_grads_resident": GR.step_launcher(cfg, p, v0, chain, seed=5)[0]}
    names = {"cd_grads": ("cd_grads_kernel",), "cd_grads_resident": ("cd_train_resident_kernel",)}

    def plain():
        G.cd_grads_step_plain(cfg, p, v0, chain, seed=5)

    t_plain1 = time_runs(plain, 50)
    t_k = {k: [time_runs(launch[k], 500)] for k in steps}
    for k in reversed(list(steps)):
        t_k[k].append(time_runs(launch[k], 500))
    t_plain2 = time_runs(plain, 50)
    bound_ms, bound_by = grads_bound(cfg)
    timing = {}
    for k, step in steps.items():
        t_wrapper = time_runs(lambda: step(cfg, p, v0, chain, seed=5), 500)
        timing[k] = {"kernel_device_us": device_us(launch[k], 200, names[k]),
                     "kernel_us": min(t_k[k]) * 1e6, "kernel_us_calls": [t * 1e6 for t in t_k[k]],
                     "wrapper_us": t_wrapper * 1e6, "plain_us": min(t_plain1, t_plain2) * 1e6,
                     "plain_us_calls": [t_plain1 * 1e6, t_plain2 * 1e6],
                     "bound_us": bound_ms * 1e3, "bound_by": bound_by}
    phase("kernel_vs_plain_grads", max_abs_diff=errs, rtol=REPLAY_RTOL, atol=REPLAY_ATOL,
          chain="identical samples", identical_bits_on_grids=grids,
          identical_bits_on_cluster_counts=clusters, timing_c1=timing,
          order="plain, cd_grads, cd_grads_resident, cd_grads_resident, cd_grads, plain",
          nvidia_smi=smi)
    return {k: (max_err[k], timing[k]) for k in steps}


def update_bound(cfg):
    """(ms, what bounds it) of one update after the all-reduce under ``cfg``:
    bytes: the flat sums read once (f32), W, b, c (z) and their velocities
    read and written once at the storage width; operations: per element the
    scale, the velocity's two products and sum, and the parameter's sum (two
    more under decay on W; learned variance: the precision's exp, product
    and the 1/2; the enhanced gradient: gW_e's two products and two
    differences, and the two matvecs over it, 2 V H each), at the f32 peak."""
    from mdbn_tpu_torch.ops.cd_grads_cuda import flat_size

    V, H = cfg.n_visible, cfg.n_hidden
    width = 2 if cfg.param_dtype == "bfloat16" else 4
    n = V * H + V + H + (V if cfg.learn_variance else 0)
    bytes_s = (4.0 * (flat_size(cfg) + 1) + width * 4.0 * n) / PEAK_BYTES_PER_S
    ops = 5.0 * n + (2.0 * V * H if cfg.l2 else 0.0) + (3.0 * V if cfg.learn_variance else 0.0)
    ops += 8.0 * V * H if cfg.gradient == "enhanced" else 0.0
    ops_s = ops / PEAK_F32_FLOPS
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def run_update(dev, smi, c1):
    """Phase 13: the update kernel against its plain version, bit for bit;
    its timing. Returns (max abs diff, timing dict)."""
    import torch

    from mdbn_tpu_torch.config import RBMConfig
    from mdbn_tpu_torch.core.rbm_math import RBMParams
    from mdbn_tpu_torch.ops import cd_grads_cuda as G
    from mdbn_tpu_torch.parallel.dp import world_scale

    cases = {"c1": c1,
             "c5_tower_c2_momentum_l2_clip": RBMConfig(
                 n_visible=2000, n_hidden=400, visible="gaussian", k=2, persistent=True,
                 lr=0.005, batch_size=20, momentum=0.9, initial_momentum=0.5, l2=1e-3,
                 grad_clip=0.05)}
    gen = torch.Generator(device=dev).manual_seed(13)
    scale = world_scale(DP_RANKS)

    def state(cfg):
        rand = lambda *shape: 0.1 * torch.randn(shape, generator=gen, device=dev)
        V, H = cfg.n_visible, cfg.n_hidden
        return (RBMParams(W=rand(V, H), b=rand(V), c=rand(H)),
                RBMParams(W=rand(V, H), b=rand(V), c=rand(H)), DP_RANKS * rand(G.flat_size(cfg)))

    errs = {}
    for name, cfg in cases.items():
        for epoch in (0, 5):  # either side of the momentum switch
            p, vel, sums = state(cfg)
            want = G.cd_update_plain(cfg, p, vel, sums, scale, epoch)
            got = G.cd_update(cfg, p.map(torch.clone), vel.map(torch.clone), sums, scale, epoch)
            torch.cuda.synchronize()
            pairs = (list(zip(got[0].as_dict().values(), want[0].as_dict().values()))
                     + list(zip(got[1].as_dict().values(), want[1].as_dict().values()))
                     + [(got[2], want[2])])
            for a, b in pairs:
                if not bool(torch.isfinite(a).all()) or not torch.equal(a, b):
                    raise AssertionError(f"update {name} epoch {epoch}: the kernel and its "
                                         "plain version differ")
            errs[f"{name}@{epoch}"] = max(float((a - b).abs().max()) for a, b in pairs)
    max_err = max(errs.values())

    # timing at c1's shape on fixed buffers (the kernel updates in place);
    # plain, kernel, kernel, plain; then one fused SGD step on the same sizes
    cfg = c1
    p, vel, sums = state(cfg)
    kernel = G.update_launcher(cfg, p, vel, sums, scale, 0)[0]  # the launch alone
    wrapper = lambda: G.cd_update(cfg, p, vel, sums, scale, 0)
    plain = lambda: G.cd_update_plain(cfg, p, vel, sums, scale, 0)
    t_plain1 = time_runs(plain, 200)
    t_kernel1 = time_runs(kernel, 500)
    t_kernel2 = time_runs(kernel, 500)
    t_plain2 = time_runs(plain, 200)
    t_wrapper = time_runs(wrapper, 500)
    # torch.optim.SGD(maximize=True) is the same rule: its buffer is -vel / lr
    leaves = [torch.nn.Parameter(t.clone()) for t in (p.W, p.b, p.c)]
    grads, _, _ = G.flat_views(cfg, sums * scale)
    for leaf, g in zip(leaves, (grads.W, grads.b, grads.c)):
        leaf.grad = g.clone()
    opt = torch.optim.SGD(leaves, lr=cfg.lr, momentum=cfg.momentum, weight_decay=cfg.l2,
                          maximize=True, fused=True)
    t_library = time_runs(opt.step, 500)
    bound_ms, bound_by = update_bound(cfg)
    timing = {"kernel_device_us": device_us(kernel, 300, ("cd_update_kernel",)),
              "library_device_us": device_us(opt.step, 300),
              "kernel_us": min(t_kernel1, t_kernel2) * 1e6,
              "kernel_us_calls": [t_kernel1 * 1e6, t_kernel2 * 1e6],
              "wrapper_us": t_wrapper * 1e6, "plain_us": min(t_plain1, t_plain2) * 1e6,
              "plain_us_calls": [t_plain1 * 1e6, t_plain2 * 1e6],
              "library_us": t_library * 1e6, "library": "torch.optim.SGD(fused=True).step",
              "bound_us": bound_ms * 1e3, "bound_by": bound_by}
    phase("kernel_vs_plain_update", max_abs_diff=errs, identical_bits=True, ranks=DP_RANKS,
          timing_c1=timing, order="plain, kernel, kernel, plain, wrapper, library",
          nvidia_smi=smi)
    return max_err, timing


def zero_dp_launches() -> None:
    """Sets the launch counts of the data-parallel kernels of every route to 0."""
    from mdbn_tpu_torch.ops import cd_grads_cuda as G
    from mdbn_tpu_torch.ops import cd_grads_resident_cuda as GR
    from mdbn_tpu_torch.ops import cd_grads_wide_cuda as GW

    G.cd_grads_launches = G.cd_update_launches = GR.cd_grads_resident_launches = 0
    GW.cd_wide_step_launches = GW.cd_wide_update_launches = 0


def dp_launches() -> dict:
    """{kernel: launches} of the data-parallel kernels of every route since
    their counts were set to 0."""
    from mdbn_tpu_torch.ops import cd_grads_cuda as G
    from mdbn_tpu_torch.ops import cd_grads_resident_cuda as GR
    from mdbn_tpu_torch.ops import cd_grads_wide_cuda as GW

    return {"cd_grads_resident": GR.cd_grads_resident_launches,
            "cd_grads": G.cd_grads_launches, "cd_dp_update": G.cd_update_launches,
            "cd_grads_wide_step": GW.cd_wide_step_launches,
            "cd_grads_wide_update": GW.cd_wide_update_launches}


def dp_route(cfg, ndev: int = 1) -> str:
    """The route select_dp_kernel gives ``cfg`` over ``ndev`` ranks on this
    card (its limits for a rank's step)."""
    import torch

    from mdbn_tpu_torch.ops.cd_epoch_cuda import select_dp_kernel
    from mdbn_tpu_torch.ops.cd_grads_resident_cuda import step_limits

    local = cfg.replace(batch_size=-(-cfg.batch_size // ndev))
    return select_dp_kernel(cfg, ndev, step_limits(local, torch.device("cuda", 0)))


def expected_dp_launches(cfg, steps: int, ndev: int = 1) -> dict:
    """The counts a data-parallel run of ``steps`` steps of ``cfg`` over
    ``ndev`` ranks shows: each kernel of the route select_dp_kernel gives
    once a step, the other routes' kernels never."""
    route = dp_route(cfg, ndev)
    wide = route == "cd_grads_wide"
    return {"cd_grads_resident": steps if route == "cd_grads_resident" else 0,
            "cd_grads": steps if route == "cd_grads" else 0,
            "cd_dp_update": 0 if wide else steps,
            "cd_grads_wide_step": steps if wide else 0,
            "cd_grads_wide_update": steps if wide else 0}


def _dp_rank(rank, world, port, out_dir, cfg, data, uniforms, inject_epochs):
    """One rank of phase 15, in a process of its own on the one card."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from mdbn_tpu_torch import RBM
    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.parallel.dp import train_rbm_shard_map
    from mdbn_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(world, backend="gloo")
        dev = torch.device("cuda", 0)
        data = torch.as_tensor(data, device=dev)
        zero_dp_launches()
        t0 = time.perf_counter()
        rbm = RBM(cfg.replace(epochs=10), device=dev).train(data, mesh=mesh)
        torch.cuda.synchronize()
        res = {"engine": rbm.metrics.engine, "kernel": rbm.metrics.kernel,
               "launches": dp_launches(),
               "seconds": time.perf_counter() - t0, "history": rbm.history,
               "params": {k: v.cpu() for k, v in rbm.params.as_dict().items()},
               "mesh": [mesh.rank, mesh.size, str(mesh.device), mesh.backend]}
        zero_dp_launches()
        st, errs = train_rbm_shard_map(init_train_state(cfg, device=dev), data, cfg, mesh,
                                       inject_epochs, pallas_step=True, uniforms=uniforms)
        torch.cuda.synchronize()
        res["inject"] = {"launches": dp_launches(), "errs": errs.cpu(),
                         "params": {k: v.cpu() for k, v in st.params.as_dict().items()},
                         "velocity": {k: v.cpu() for k, v in st.velocity.as_dict().items()}}
        # PCD, k = 2: each rank's chain rows stay with it; the result's chain is
        # gathered from all ranks (through the host under gloo)
        zero_dp_launches()
        pcd = RBM(cfg.replace(persistent=True, k=2, epochs=2), device=dev).train(data, mesh=mesh)
        res["pcd"] = {"engine": pcd.metrics.engine, "launches": dp_launches(),
                      "history": pcd.history, "chain": pcd.state.chain_h.cpu(),
                      "W": pcd.params.W.cpu()}
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _shard(batch, d, lb):
    """Rows [d * lb, (d + 1) * lb) of ``batch`` padded with zero rows to
    lb * ndev, and their mask."""
    import torch

    B = batch.shape[0]
    v0 = batch[d * lb:(d + 1) * lb]
    v0 = torch.cat([v0, torch.zeros_like(batch[: lb - v0.shape[0]])])
    mask = ((d * lb + torch.arange(lb, device=batch.device)) < B).float()[:, None]
    return v0, mask


def dp_step_plain(cfg, params, vel, chains, batch, us, ndev, epoch, step, nb):
    """One data-parallel update on the plain versions of the route the config
    takes, in this process: each shard's step (masked, norm B / ndev) into a
    flat buffer, their sum, the update (cd_update_plain); or, on the
    W-blocked route, each shard's step into its slot of a gather buffer and
    the update on the gathered slots (cd_wide_update_plain). ``chains``: each
    shard's chain rows, replaced in place. Returns (params, velocity, err)."""
    import torch

    from mdbn_tpu_torch.ops import cd_grads_cuda as G
    from mdbn_tpu_torch.ops import cd_grads_wide_cuda as GW
    from mdbn_tpu_torch.ops.cd_epoch_cuda import select_dp_kernel
    from mdbn_tpu_torch.parallel.dp import world_scale

    B = cfg.batch_size
    lb = -(-B // ndev)
    local = cfg.replace(batch_size=lb)
    if select_dp_kernel(cfg) == "cd_grads_wide":
        n = GW.wide_factor_size(local)
        gathered = torch.zeros(ndev * n, dtype=torch.uint8, device=batch.device)
        for d in range(ndev):
            _, chains[d] = GW.cd_wide_step_plain(
                local, params, _shard(batch, d, lb)[0], chains[d], uniforms=us[d],
                n_valid=min(lb, B - d * lb), norm=B / ndev, out=gathered[d * n:(d + 1) * n])
        return GW.cd_wide_update_plain(cfg, params, vel, batch, gathered, ndev,
                                       world_scale(ndev), epoch)
    bit = (epoch * nb + step) % cfg.n_visible if cfg.error_metric == "pseudo" else None
    total = torch.zeros(G.flat_size(cfg), device=batch.device)
    for d in range(ndev):
        v0, mask = _shard(batch, d, lb)
        flat = torch.empty_like(total)
        _, chains[d], _ = G.cd_grads_step_plain(local, params, v0, chains[d], uniforms=us[d],
                                                mask=mask, norm=B / ndev, out=flat,
                                                pseudo_bit=bit)
        total += flat
    return G.cd_update_plain(cfg, params, vel, total, world_scale(ndev), epoch)


def dp_replay(cfg, data, ndev, n_epochs, dev, seed):
    """Per-rank draws for an injected run of n_epochs, hardened step by step
    against the replay's own state, and the replay (dp_step_plain from the
    initial state). Returns (uniforms {name: [E, nb, ndev, ...]} on the CPU,
    params, velocity, errs)."""
    import torch

    from mdbn_tpu_torch.core.state import chain_rows, init_train_state
    from mdbn_tpu_torch.ops import cd_grads_cuda as G
    from mdbn_tpu_torch.ops.cd_epoch_cuda import select_dp_kernel
    from mdbn_tpu_torch.ops.cd_step import draw_pt_uniforms, draw_uniforms

    B = cfg.batch_size
    lb = -(-B // ndev)
    local = cfg.replace(batch_size=lb)
    wide = select_dp_kernel(cfg) == "cd_grads_wide"
    nb = data.shape[0] // B
    st = init_train_state(cfg, device=dev)
    params, vel = st.params, st.velocity
    chains = [torch.zeros((chain_rows(local), cfg.n_hidden), device=dev,
                          dtype=st.chain_h.dtype) for _ in range(ndev)]
    draw = draw_pt_uniforms if cfg.pt_temps > 1 else draw_uniforms
    gen = torch.Generator(device=dev).manual_seed(seed)
    steps, errs = [], []
    for e in range(n_epochs):
        step_errs = []
        for i in range(nb):
            batch = data[i * B:(i + 1) * B]
            us = [G.harden_step(local, params, chains[d], _shard(batch, d, lb)[0],
                                draw(local, lb, gen), wide=wide) for d in range(ndev)]
            params, vel, err = dp_step_plain(cfg, params, vel, chains, batch, us, ndev, e, i, nb)
            step_errs.append(err)
            steps.append([{k: x.cpu() for k, x in u.items()} for u in us])
        errs.append(torch.stack(step_errs).mean())
    uniforms = {k: torch.stack([torch.stack([u[k] for u in s]) for s in steps])
                .reshape(n_epochs, nb, ndev, *steps[0][0][k].shape) for k in steps[0][0]}
    return uniforms, params, vel, torch.stack(errs)


def device_busy(fn, first: tuple, epochs: int) -> dict:
    """The card's busy share over the device time of one call of ``fn``
    (``epochs`` epochs) under torch.profiler, from the start of the first
    kernel whose name holds one of ``first`` (a step kernel: a capture, made
    on the host before it, drops out) to the end of the last: the union of
    the device activity inside that window over the window; and the window
    an epoch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    start = min(e.time_range.start for e in evs if any(n in e.name for n in first))
    spans = sorted((max(e.time_range.start, start), e.time_range.end) for e in evs
                   if e.time_range.end > start)
    busy, lo, hi = 0.0, None, None
    for a, b in spans:  # the union of the intervals
        if hi is None or a > hi:
            busy += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    window = max(b for _, b in spans) - start
    return {"window_ms": window / 1e3, "window_ms_per_epoch": window / 1e3 / epochs,
            "busy_ms": busy / 1e3, "busy_share": busy / window, "device_events": len(spans)}


def dp_epoch_timing(st, data, cfg, mesh, nb, epochs: int = 21) -> dict:
    """ms an epoch of train_rbm_shard_map(pallas_step=True) from ``st``,
    captured and eager: a call of ``epochs`` epochs against a call of one,
    each way, in turns (captured, eager, eager, captured; the capture and a
    call's set-up drop out of the difference); five one-epoch calls of each
    timed one at a time; the busy share over the device time of a call of
    ``epochs`` epochs, each way (device_busy)."""
    import torch

    from mdbn_tpu_torch.parallel import dp

    def call(n, capture=True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dp.train_rbm_shard_map(st, data, cfg, mesh, n, pallas_step=True, capture=capture)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    call(1), call(1, False)  # warm-up
    per = {True: [], False: []}
    for capture in (True, False, False, True):
        one = call(1, capture)
        per[capture].append((call(epochs, capture) - one) / (epochs - 1))
    calls = {c: [call(1, c) for _ in range(5)] for c in (True, False)}
    med = lambda xs: sorted(xs)[len(xs) // 2]
    captured, eager = min(per[True]), min(per[False])
    return {"epoch_ms_captured": captured, "epoch_ms_captured_runs": per[True],
            "epoch_ms_eager": eager, "epoch_ms_eager_runs": per[False],
            "step_us_captured": captured * 1e3 / nb, "step_us_eager": eager * 1e3 / nb,
            "updates_per_s_captured": nb / captured * 1e3,
            "one_epoch_call_ms": {"captured": calls[True], "eager": calls[False],
                                  "captured_median": med(calls[True]),
                                  "eager_median": med(calls[False])},
            "busy_captured": device_busy(lambda: call(epochs), STEP_KERNELS, epochs),
            "busy_eager": device_busy(lambda: call(epochs, False), STEP_KERNELS, epochs),
            "order": "captured, eager, eager, captured"}


def run_dp(dev, smi, c1, t_cd_train_ms):
    """Phases 14 and 15: the data-parallel path through its entry points.
    Returns {kernel: launches in dp_world1}."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from mdbn_tpu_torch.config import load_config
    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.parallel import dp
    from mdbn_tpu_torch.parallel.mesh import _free_port, make_mesh
    from mdbn_tpu_torch.run import build_data

    c1_train, _, _ = build_data(load_config(C1)["data"])
    data = torch.as_tensor(c1_train, device=dev)
    cfg = c1.replace(engine="pallas")
    nb = data.shape[0] // cfg.batch_size

    # 14. one rank, NCCL, through train_rbm_shard_map on the kernels: the
    # captured epoch on the route's step kernel, then the eager loop of the
    # same launches from the same state, which must give the same bits
    mesh = make_mesh(1, backend="nccl")
    route = dp_route(cfg)
    zero_dp_launches()
    t0 = time.perf_counter()
    st, errs = dp.train_rbm_shard_map(init_train_state(cfg, device=dev), data, cfg, mesh, 10,
                                      pallas_step=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dp_launches()
    final = float(errs[-1])
    if route != "cd_grads_resident" or launches != expected_dp_launches(cfg, 10 * nb):
        raise AssertionError(f"dp_world1: route {route}, launches {launches}, expected "
                             f"{expected_dp_launches(cfg, 10 * nb)}")
    if abs(final - C1_FINAL_ERR) > C1_ERR_TOL:
        raise AssertionError(f"dp_world1: final error {final} not within {C1_ERR_TOL} of "
                             f"{C1_FINAL_ERR}")
    eager, errs_e = dp.train_rbm_shard_map(init_train_state(cfg, device=dev), data, cfg, mesh,
                                           10, pallas_step=True, capture=False)
    torch.cuda.synchronize()
    pairs = (list(zip(st.params.as_dict().values(), eager.params.as_dict().values()))
             + list(zip(st.velocity.as_dict().values(), eager.velocity.as_dict().values()))
             + [(errs, errs_e)])
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError("dp_world1: the captured epochs and the eager loop differ")
    timing = dp_epoch_timing(st, data, cfg, mesh, nb)
    timing.update(cd_train_epoch_ms=t_cd_train_ms,
                  vs_cd_train=timing["epoch_ms_captured"] / t_cd_train_ms)
    phase("dp_world1", route=route, launches=launches, first_err=float(errs[0]),
          final_err=final, seconds=round(seconds, 3), captured_equals_eager="identical bits",
          nvidia_smi=smi, **timing)
    dist.destroy_process_group()

    # 15. three ranks on the one card over gloo, one process each
    E_INJ = 2
    uniforms, params, vel, errs_r = dp_replay(c1, data, DP_RANKS, E_INJ, dev, seed=9)
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        ranks = mp.spawn(_dp_rank, args=(DP_RANKS, _free_port(), out, cfg, c1_train, uniforms,
                                         E_INJ), nprocs=DP_RANKS, join=False)
        while not ranks.join(timeout=1.0):  # a failed rank raises here, the others stopped
            if time.perf_counter() - t0 > DP_RANKS_LIMIT_S:
                for proc in ranks.processes:
                    proc.kill()
                raise AssertionError(f"dp_ranks: the ranks did not finish in "
                                     f"{DP_RANKS_LIMIT_S} s")
        spawn_s = time.perf_counter() - t0
        got = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(DP_RANKS)]
    for r, g in enumerate(got):
        if (g["engine"] != "cuda_dp" or g["kernel"] != dp_route(cfg, DP_RANKS)
                or g["launches"] != expected_dp_launches(cfg, 10 * nb, DP_RANKS)):
            raise AssertionError(f"dp_ranks rank {r}: engine {g['engine']}, kernel "
                                 f"{g['kernel']}, {g['launches']} launches")
        if g["inject"]["launches"] != expected_dp_launches(cfg, E_INJ * nb, DP_RANKS):
            raise AssertionError(f"dp_ranks rank {r}: {g['inject']['launches']} launches in "
                                 "the injected run")
        for k, x in g["params"].items():
            if not torch.equal(x, got[0]["params"][k]):
                raise AssertionError(f"dp_ranks: rank {r}'s {k} differs from rank 0's")
        for part in ("params", "velocity"):
            for k, x in g["inject"][part].items():
                if not torch.equal(x, got[0]["inject"][part][k]):
                    raise AssertionError(f"dp_ranks (injected): rank {r}'s {part} {k} differs")
    for r, g in enumerate(got):  # PCD: the gathered chain and W agree on every rank
        p = g["pcd"]
        pcd_cfg = cfg.replace(persistent=True, k=2)
        if (p["engine"] != "cuda_dp"
                or p["launches"] != expected_dp_launches(pcd_cfg, 2 * nb, DP_RANKS)
                or not torch.equal(p["chain"], got[0]["pcd"]["chain"])
                or not torch.equal(p["W"], got[0]["pcd"]["W"])):
            raise AssertionError(f"dp_ranks (PCD) rank {r}: engine {p['engine']}, "
                                 f"{p['launches']} launches, or its chain or W differs")
    pcd_chain, pcd_hist = got[0]["pcd"]["chain"], got[0]["pcd"]["history"]
    if (tuple(pcd_chain.shape) != (cfg.batch_size, cfg.n_hidden)
            or not bool(((pcd_chain == 0) | (pcd_chain == 1)).all())
            or not pcd_hist[-1] < pcd_hist[0]):
        raise AssertionError(f"dp_ranks (PCD): chain {tuple(pcd_chain.shape)}, errors {pcd_hist}")
    hist = got[0]["history"]
    if len(hist) != 10 or not all(np.isfinite(hist)) or abs(hist[-1] - C1_FINAL_ERR) > C1_ERR_TOL:
        raise AssertionError(f"dp_ranks: final error {hist[-1]} not within {C1_ERR_TOL} of "
                             f"{C1_FINAL_ERR}")
    inj = got[0]["inject"]
    diff = {}
    for name, a, b in (("W", inj["params"]["W"], params.W), ("b", inj["params"]["b"], params.b),
                       ("c", inj["params"]["c"], params.c),
                       ("vW", inj["velocity"]["W"], vel.W), ("errs", inj["errs"], errs_r)):
        torch.testing.assert_close(a, b.cpu(), rtol=DP_RTOL, atol=DP_ATOL)
        diff[name] = float((a - b.cpu()).abs().max())
    phase("dp_ranks", ranks=DP_RANKS, backend="gloo", mesh=[g["mesh"] for g in got],
          engine=[g["engine"] for g in got], kernel=got[0]["kernel"],
          launches=[g["launches"] for g in got],
          first_err=hist[0], final_err=hist[-1],
          train_seconds=[round(g["seconds"], 3) for g in got], spawn_seconds=round(spawn_s, 3),
          identical_bits_across_ranks=True, injected_epochs=E_INJ,
          injected_vs_replay_max_abs_diff=diff, rtol=DP_RTOL, atol=DP_ATOL,
          pcd_k2_2_epochs={"errors": pcd_hist, "chain_gathered": list(pcd_chain.shape),
                           "identical_across_ranks": True}, nvidia_smi=smi)
    return launches


def dp_mode_configs(dev, c1, c1_data, ge):
    """name -> (config, data) of the data-parallel modes at full width: the
    estimator modes (mode_configs), c1 at bf16 storage and compute, and the
    wide slice's w20k_mom_bf16."""
    import torch

    modes = mode_configs(c1, c1_data, ge_scaled(ge))
    lv_cfg, lv_data = modes["lv"]
    modes["pt3_lv"] = (lv_cfg.replace(persistent=True, pt_temps=3, pt_beta_min=0.4), lv_data)
    modes["c1_bf16"] = (c1.replace(**BF16), c1_data.to(torch.bfloat16))
    modes["w20k_mom_bf16"] = wide_row("w20k_mom_bf16", dev)
    return modes


def _mode_state(cfg, dev, seed):
    """A step's parameters at the storage dtype (the initial W, small random
    biases, and z ~ 0.2 N(0, 1) under learned variance) and a random 0/1
    chain of all its rows."""
    import torch

    from mdbn_tpu_torch.core.rbm_math import RBMParams
    from mdbn_tpu_torch.core.state import chain_rows, init_train_state

    st = init_train_state(cfg, device=dev)
    sdt, V, H = st.params.W.dtype, cfg.n_visible, cfg.n_hidden
    gen = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    p = RBMParams(W=st.params.W, b=(0.1 * rand(V)).to(sdt), c=(0.1 * rand(H)).to(sdt),
                  z=(0.2 * rand(V)).to(sdt) if cfg.learn_variance else None)
    chain = (torch.rand((chain_rows(cfg), H), generator=gen, device=dev) < 0.5).to(sdt)
    return p, chain


def _within_ulp(got, want, vel_got=None, vel_want=None, atol=REPLAY_ATOL) -> float:
    """Assert bf16 ``got`` lies within one bf16 ulp of ``want`` (a parameter:
    within its velocity's ulp and one of its own), + atol; the largest
    |diff|."""
    import torch

    a, b = got.float(), want.float()
    big = torch.maximum(a.abs(), b.abs())
    if vel_got is not None:
        big = big + torch.maximum(vel_got.float().abs(), vel_want.float().abs())
    d = (a - b).abs()
    if not bool((d <= big * 2.0 ** -7 + atol).all()):
        raise AssertionError(f"bf16 values differ by over one ulp: {float(d.max())}")
    return float(d.max())


def _stats_close(cfg, got, want) -> float:
    """Assert the step's flat statistics ``got`` agree with ``want``; the
    largest |diff|. At float32 compute: the replay tolerance. At bf16
    compute the operands of every product round to bf16, and an operand
    that the two versions compute in float32 in other orders (a mean-field
    visible, a hidden probability) can round to the neighbouring bf16 value,
    2^-8 of it apart; so each part of the buffer (gW, gb, gc, ...) is held to
    2^-7 of each value plus 2^-8 of the part's largest, + the replay atol."""
    import torch

    from mdbn_tpu_torch.ops.cd_grads_cuda import flat_views

    if cfg.compute_dtype != "bfloat16":
        torch.testing.assert_close(got, want, rtol=REPLAY_RTOL, atol=REPLAY_ATOL)
        return float((got - want).abs().max())

    def parts(flat):
        grads, sums, err = flat_views(cfg, flat)
        return ([t for t in grads.as_dict().values()]
                + ([sums.mu, sums.lam, sums.h0] if sums is not None else []) + [err.reshape(1)])

    for a, b in zip(parts(got), parts(want)):
        tol = 2.0 ** -7 * b.abs() + 2.0 ** -8 * b.abs().max() + REPLAY_ATOL
        if bool(((a - b).abs() > tol).any()):
            raise AssertionError(f"bf16-compute statistics differ beyond one operand ulp: "
                                 f"{float((a - b).abs().max())}")
    return float((got - want).abs().max())


def run_grads_modes(dev, smi, modes):
    """Phase 16: the step kernels against their plain version in each mode
    at full width, on the whole batch and on the third shard of a 3-way
    split (7 rows, the last a pad row, norm 20/3): cd_grads.cu, and the
    resident kernel's step variant wherever its tiles fit; the same bits on
    grids 1, 7 and 132 (cd_grads.cu) and on two cluster counts (the step
    variant); each kernel's, the plain version's and the bound's time per
    step on the whole batch. Returns {kernel: {mode: (max abs diff,
    timing)}}."""
    import torch

    from mdbn_tpu_torch.ops import cd_epoch_resident_cuda as R
    from mdbn_tpu_torch.ops import cd_grads_cuda as G
    from mdbn_tpu_torch.ops import cd_grads_resident_cuda as GR
    from mdbn_tpu_torch.ops.cd_step import draw_pt_uniforms, draw_uniforms

    fits = lambda c: R.resident_tiles(c, *GR.step_limits(c, dev)).fits
    kernels = {"cd_grads": (G.cd_grads_step, G.step_launcher, ("cd_grads_kernel",)),
               "cd_grads_resident": (GR.cd_grads_resident_step, GR.step_launcher,
                                     ("cd_train_resident_kernel",))}
    out, errs, same = {k: {} for k in kernels}, {}, {}
    for n, (name, (cfg, data)) in enumerate(modes.items()):
        B = cfg.batch_size
        bit = PSEUDO_BIT if cfg.error_metric == "pseudo" else None
        mask = torch.tensor([1.0] * 6 + [0.0], device=dev)[:, None]
        shard = torch.cat([data[14:20], torch.zeros_like(data[:1])])
        worst = {k: 0.0 for k in kernels}
        for case, (c, v0, m, norm) in (("whole", (cfg, data[:B], None, None)),
                                       ("rank2_of_3", (cfg.replace(batch_size=7), shard, mask,
                                                       B / 3))):
            p, chain = _mode_state(c, dev, n)
            draw = draw_pt_uniforms if c.pt_temps > 1 else draw_uniforms
            u = G.harden_step(c, p, chain, v0, draw(c, c.batch_size,
                                                    torch.Generator(device=dev).manual_seed(n)))
            kw = dict(mask=m, norm=norm, pseudo_bit=bit)
            want = torch.empty(G.flat_size(c), device=dev)
            _, c_want, _ = G.cd_grads_step_plain(c, p, v0, chain, uniforms=u, out=want, **kw)
            for k, (step, _, _) in kernels.items():
                if k == "cd_grads_resident" and not fits(c):
                    continue
                got = torch.empty(G.flat_size(c), device=dev)
                _, c_got, _ = step(c, p, v0, chain, uniforms=u, out=got, **kw)
                torch.cuda.synchronize()
                if not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"{k} {name}@{case}: the step's statistics are not "
                                         "finite")
                errs[f"{k}:{name}@{case}"] = _stats_close(c, got, want)
                torch.testing.assert_close(c_got, c_want, rtol=0, atol=0)  # the same samples
                worst[k] = max(worst[k], errs[f"{k}:{name}@{case}"])
            if case == "rank2_of_3":  # the kernels' own draws on several grids
                runs = []
                for g in (0,) + GRADS_GRIDS:
                    flat = torch.empty(G.flat_size(c), device=dev)
                    _, ch, _ = G.cd_grads_step(c, p, v0, chain, seed=11, out=flat, grid=g, **kw)
                    runs.append((flat, ch))
                if fits(c):
                    counts = step_cluster_counts(c, dev)
                    for g in counts:
                        flat = torch.empty(G.flat_size(c), device=dev)
                        _, ch, _ = GR.cd_grads_resident_step(c, p, v0, chain, seed=11, out=flat,
                                                             grid=g, **kw)
                        runs.append((flat, ch))
                    same[name] = counts  # one count where only one holds the tiles (pt3_lv)
                ref = runs[0], runs[len(GRADS_GRIDS) + 1] if fits(c) else None
                for i, (flat, ch) in enumerate(runs):
                    base = ref[0] if i <= len(GRADS_GRIDS) else ref[1]
                    if not (torch.equal(flat, base[0]) and torch.equal(ch, base[1])):
                        raise AssertionError(f"{name}: the step depends on the grid or the "
                                             "cluster count")
        # timing on the whole batch: each kernel's launch alone and the plain
        # version: plain, kernels, kernels in reverse, plain
        p, chain = _mode_state(cfg, dev, 0)
        v0 = data[:B]
        timed = [k for k in kernels if k == "cd_grads" or fits(cfg)]
        launch = {k: kernels[k][1](cfg, p, v0, chain, seed=5, pseudo_bit=bit)[0] for k in timed}

        def plain(cfg=cfg, p=p, v0=v0, chain=chain, bit=bit):
            G.cd_grads_step_plain(cfg, p, v0, chain, seed=5, pseudo_bit=bit)

        t_plain1 = time_runs(plain, 10)
        t_k = {k: [time_runs(launch[k], 200)] for k in timed}
        for k in reversed(timed):
            t_k[k].append(time_runs(launch[k], 200))
        t_plain2 = time_runs(plain, 10)
        bound_ms, bound_by = grads_bound(cfg)
        for k in timed:
            out[k][name] = (worst[k], {
                "kernel_device_us": device_us(launch[k], 100, kernels[k][2]),
                "kernel_us": min(t_k[k]) * 1e6, "kernel_us_calls": [t * 1e6 for t in t_k[k]],
                "plain_us": min(t_plain1, t_plain2) * 1e6,
                "plain_us_calls": [t_plain1 * 1e6, t_plain2 * 1e6],
                "bound_us": bound_ms * 1e3, "bound_by": bound_by})
    phase("kernel_vs_plain_grads_modes", max_abs_diff=errs, rtol=REPLAY_RTOL, atol=REPLAY_ATOL,
          chain="identical samples", identical_bits_on_grids=list(GRADS_GRIDS) + ["default"],
          identical_bits_on_cluster_counts=same,
          timing={k: {m: v[1] for m, v in d.items()} for k, d in out.items()},
          order="plain, cd_grads, cd_grads_resident, cd_grads_resident, cd_grads, plain",
          nvidia_smi=smi)
    return out


def run_update_modes(dev, smi, modes):
    """Phase 17: the update kernel against its plain version on 3 ranks'
    summed statistics, for learned variance, the enhanced gradient and bf16
    storage: every elementwise result bit for bit; the enhanced gradient's b
    and c (its matvecs are summed in another order by cuBLAS) and z (e^{-z})
    at the replay tolerance; the times. Returns {mode: (max abs diff,
    timing)}."""
    import torch

    from mdbn_tpu_torch.core.rbm_math import RBMParams
    from mdbn_tpu_torch.ops import cd_grads_cuda as G
    from mdbn_tpu_torch.parallel.dp import world_scale

    scale = world_scale(DP_RANKS)
    out, bits = {}, {}
    for n, name in enumerate(DP_UPDATE_MODES):
        cfg = modes[name][0]
        gen = torch.Generator(device=dev).manual_seed(13 + n)
        sdt = torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32
        rand = lambda *shape: (0.1 * torch.randn(shape, generator=gen, device=dev)).to(sdt)
        V, H, z = cfg.n_visible, cfg.n_hidden, cfg.learn_variance

        def state():
            return RBMParams(W=rand(V, H), b=rand(V), c=rand(H), z=rand(V) if z else None)

        p, vel = state(), state()
        sums = DP_RANKS * 0.1 * torch.randn(G.flat_size(cfg), generator=gen, device=dev)
        want = G.cd_update_plain(cfg, p, vel, sums, scale, 0)
        got = G.cd_update(cfg, p.map(torch.clone), vel.map(torch.clone), sums, scale, 0)
        torch.cuda.synchronize()
        loose = ({"b", "c"} if cfg.gradient == "enhanced" else set()) | ({"z"} if z else set())
        worst, same = 0.0, {}
        for i, part in ((0, "params"), (1, "velocity")):
            for k, a in got[i].as_dict().items():
                b = getattr(want[i], k)
                if not bool(torch.isfinite(a.float()).all()):
                    raise AssertionError(f"update {name}: {part}.{k} is not finite")
                same[f"{part}.{k}"] = bool(torch.equal(a, b))
                if k in loose:
                    torch.testing.assert_close(a.float(), b.float(), rtol=REPLAY_RTOL,
                                               atol=REPLAY_ATOL)
                elif not same[f"{part}.{k}"]:
                    raise AssertionError(f"update {name}: {part}.{k} differs from the plain "
                                         "version's bits")
                worst = max(worst, float((a.float() - b.float()).abs().max()))
        bits[name] = same
        p, vel = state(), state()
        kernel = G.update_launcher(cfg, p, vel, sums, scale, 0)[0]  # the launch alone

        def plain(cfg=cfg, p=p, vel=vel, sums=sums):
            G.cd_update_plain(cfg, p, vel, sums, scale, 0)

        t_plain1 = time_runs(plain, 50)
        t_kernel1 = time_runs(kernel, 300)
        t_kernel2 = time_runs(kernel, 300)
        t_plain2 = time_runs(plain, 50)
        bound_ms, bound_by = update_bound(cfg)
        extra = {}
        if cfg.gradient == "enhanced":  # the matvec pass and the update on their own
            extra = {"enhance_device_us": device_us(kernel, 300, ("cd_enhance_kernel",)),
                     "update_device_us": device_us(kernel, 300, ("cd_update_kernel",))}
        out[name] = (worst, {"kernel_device_us": device_us(
                                 kernel, 300, ("cd_update_kernel", "cd_enhance_kernel")),
                             **extra,
                             "kernel_us": min(t_kernel1, t_kernel2) * 1e6,
                             "kernel_us_calls": [t_kernel1 * 1e6, t_kernel2 * 1e6],
                             "plain_us": min(t_plain1, t_plain2) * 1e6,
                             "plain_us_calls": [t_plain1 * 1e6, t_plain2 * 1e6],
                             "bound_us": bound_ms * 1e3, "bound_by": bound_by})
    phase("kernel_vs_plain_update_modes", ranks=DP_RANKS, identical_bits=bits,
          max_abs_diff={k: v[0] for k, v in out.items()}, loose_rtol=REPLAY_RTOL,
          loose_atol=REPLAY_ATOL, timing={k: v[1] for k, v in out.items()},
          order="plain, kernel, kernel, plain", nvidia_smi=smi)
    return out


def run_dp_world1_modes(dev, modes, names, phase_name):
    """Phase 18 (and 21's runs): each mode of ``names`` for 10 epochs through
    train_rbm_shard_map(pallas_step=True) on a one-rank NCCL mesh (captured,
    on every route): the kernels of the route select_dp_kernel gives
    launched once a step and the other routes' never, the final error in the
    mode's PARITY.md band (or, without a band, below the first); the same
    bits as the eager loop from the same state, ms an epoch captured and
    eager and the busy share (dp_epoch_timing). Returns ({mode: {kernel:
    launches}}, {mode: run})."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.parallel import dp
    from mdbn_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, backend="nccl")
    launches, runs = {}, {}
    try:
        for name in names:
            cfg, data = modes[name]
            cfg = cfg.replace(engine="pallas")
            nb = data.shape[0] // cfg.batch_size
            zero_dp_launches()
            st, errs = dp.train_rbm_shard_map(init_train_state(cfg, device=dev), data, cfg, mesh,
                                              10, pallas_step=True)
            torch.cuda.synchronize()
            launches[name] = dp_launches()
            if launches[name] != expected_dp_launches(cfg, 10 * nb):
                raise AssertionError(f"{phase_name} {name}: launches {launches[name]}, expected "
                                     f"{expected_dp_launches(cfg, 10 * nb)}")
            hist = errs.tolist()
            finite = all(bool(torch.isfinite(t.float()).all())
                         for t in st.params.as_dict().values())
            if not finite or not all(np.isfinite(hist)):
                raise AssertionError(f"{phase_name} {name}: not finite: {hist}")
            band = DP_MODE_BANDS.get(name)
            if band is None and not hist[-1] < hist[0]:
                raise AssertionError(f"{phase_name} {name}: the monitor did not fall: {hist}")
            if band is not None and abs(hist[-1] - band[0]) > band[1]:
                raise AssertionError(f"{phase_name} {name}: final error {hist[-1]} not within "
                                     f"{band[1]} of {band[0]}")
            route = dp_route(cfg)
            runs[name] = {"route": route, "first_err": hist[0], "final_err": hist[-1],
                          "band": band, "steps_per_epoch": nb}
            # captured: the eager loop's bits, both timed
            _captured_equals_eager(cfg, data, mesh, dev, 10, (st, errs), f"{phase_name} {name}")
            runs[name].update(captured_equals_eager="identical bits",
                              **dp_epoch_timing(st, data, cfg, mesh, nb))
    finally:
        dist.destroy_process_group()
    return launches, runs


def _captured_equals_eager(cfg, data, mesh, dev, epochs, captured, what):
    """Assert that ``captured`` = (state, errors), train_rbm_shard_map's
    captured run of ``epochs`` epochs from a fresh state, has the bits of
    the eager loop of the same launches (capture=False) from the same
    state."""
    import torch

    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.parallel import dp

    st, errs = captured
    eager, errs_e = dp.train_rbm_shard_map(init_train_state(cfg, device=dev), data, cfg, mesh,
                                           epochs, pallas_step=True, capture=False)
    torch.cuda.synchronize()
    if not (all(torch.equal(a, b) for part in ("params", "velocity")
                for a, b in zip(getattr(st, part).as_dict().values(),
                                getattr(eager, part).as_dict().values()))
            and torch.equal(st.chain_h, eager.chain_h) and torch.equal(errs, errs_e)):
        raise AssertionError(f"{what}: the captured epochs and the eager loop differ")


def _dp_modes_rank(rank, world, port, out_dir, runs):
    """One rank of phase 19, in a process of its own on the one card: for
    each mode, RBM.train with the mesh for 2 epochs, then the injected run
    (``each``: one call per epoch, keeping each state)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from mdbn_tpu_torch import RBM
    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.parallel.dp import train_rbm_shard_map
    from mdbn_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    cpu = lambda p: {k: v.cpu() for k, v in p.as_dict().items()}
    try:
        mesh = make_mesh(world, backend="gloo")
        dev = torch.device("cuda", 0)
        res = {}
        for name, (cfg, data, inj, uniforms, each) in runs.items():
            zero_dp_launches()
            t0 = time.perf_counter()
            rbm = RBM(cfg.replace(epochs=2), device=dev).train(data.to(dev), mesh=mesh)
            torch.cuda.synchronize()
            r = {"engine": rbm.metrics.engine, "kernel": rbm.metrics.kernel,
                 "launches": dp_launches(), "seconds": time.perf_counter() - t0,
                 "history": rbm.history, "params": cpu(rbm.params)}
            zero_dp_launches()
            st, states, errs = init_train_state(cfg, device=dev), [], []
            for lo, hi in ([(0, 1), (1, 2)] if each else [(0, 2)]):
                st, e = train_rbm_shard_map(st, inj.to(dev), cfg, mesh, hi - lo,
                                            pallas_step=True,
                                            uniforms={k: u[lo:hi] for k, u in uniforms.items()})
                errs.append(e.cpu())
                states.append({"params": cpu(st.params), "velocity": cpu(st.velocity)})
            torch.cuda.synchronize()
            r["inject"] = {"launches": dp_launches(), "errs": torch.cat(errs), "states": states}
            res[name] = r
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_dp_ranks_modes(dev, smi, modes, names, phase_name):
    """Phase 19 (and 22): each mode of ``names`` over 3 gloo ranks spawned on
    the one card, through RBM.train(mesh=...) for 2 epochs on DP_RANK_ROWS
    rows: engine cuda_dp on every rank, the two kernels of the route
    select_dp_kernel gives launched once a step and the other route's never,
    the parameters bit-identical across ranks; then 2 epochs on injected
    per-rank draws held against a replay in this process (dp_step_plain, on
    the route's plain versions): float32 runs over two minibatches an epoch
    at rtol 2e-4 / atol 2e-6, bf16 runs one update at a time (one minibatch
    an epoch) to one bf16 ulp."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from mdbn_tpu_torch.core.rbm_math import RBMParams
    from mdbn_tpu_torch.core.state import chain_rows, init_train_state
    from mdbn_tpu_torch.parallel.mesh import _free_port

    runs, replays = {}, {}
    for n, name in enumerate(names):
        cfg, data = modes[name]
        cfg = cfg.replace(engine="pallas")
        each = cfg.param_dtype == "bfloat16"
        inj = data[: (1 if each else 2) * cfg.batch_size]
        uniforms, params, vel, errs = dp_replay(cfg, inj, DP_RANKS, 2, dev, seed=20 + n)
        replays[name] = (params, vel, errs, uniforms)
        runs[name] = (cfg, data[:DP_RANK_ROWS].cpu(), inj.cpu(), uniforms, each)
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        ranks = mp.spawn(_dp_modes_rank, args=(DP_RANKS, _free_port(), out, runs),
                         nprocs=DP_RANKS, join=False)
        while not ranks.join(timeout=1.0):  # a failed rank raises here, the others stopped
            if time.perf_counter() - t0 > DP_RANKS_LIMIT_S:
                for proc in ranks.processes:
                    proc.kill()
                raise AssertionError(f"{phase_name}: the ranks did not finish in "
                                     f"{DP_RANKS_LIMIT_S} s")
        spawn_s = time.perf_counter() - t0
        got = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(DP_RANKS)]
    report = {}
    for name in names:
        cfg, data, inj, uniforms, each = runs[name]
        nb = data.shape[0] // cfg.batch_size
        r0 = got[0][name]
        for r, g in enumerate(x[name] for x in got):
            if (g["engine"] != "cuda_dp" or g["kernel"] != dp_route(cfg, DP_RANKS)
                    or g["launches"] != expected_dp_launches(cfg, 2 * nb, DP_RANKS)):
                raise AssertionError(f"{phase_name} {name} rank {r}: engine {g['engine']}, "
                                     f"kernel {g['kernel']}, {g['launches']} launches")
            if g["inject"]["launches"] != expected_dp_launches(
                    cfg, 2 * (inj.shape[0] // cfg.batch_size), DP_RANKS):
                raise AssertionError(f"{phase_name} {name} rank {r}: "
                                     f"{g['inject']['launches']} launches in the injected run")
            same = all(torch.equal(x, r0["params"][k]) for k, x in g["params"].items())
            for s0, s in zip(r0["inject"]["states"], g["inject"]["states"]):
                same = same and all(torch.equal(x, s0[part][k]) for part in ("params", "velocity")
                                    for k, x in s[part].items())
            if not same:
                raise AssertionError(f"{phase_name} {name}: rank {r}'s state differs from "
                                     "rank 0's")
        if not all(np.isfinite(r0["history"])):
            raise AssertionError(f"{phase_name} {name}: errors {r0['history']}")
        states = r0["inject"]["states"]
        if each:  # bf16: one update at a time from the ranks' own states
            worst = 0.0
            st0 = init_train_state(cfg, device=dev)
            prev = (st0.params, st0.velocity)
            for t, st in enumerate(states):
                us = [{k: u[t, 0, d].to(dev) for k, u in uniforms.items()}
                      for d in range(DP_RANKS)]
                lb = -(-cfg.batch_size // DP_RANKS)
                chains = [torch.zeros((chain_rows(cfg.replace(batch_size=lb)), cfg.n_hidden),
                                      device=dev, dtype=prev[0].W.dtype)
                          for _ in range(DP_RANKS)]
                pw, vw, _ = dp_step_plain(cfg, prev[0], prev[1], chains, inj.to(dev), us,
                                          DP_RANKS, t, 0, 1)
                for k in pw.as_dict():
                    gv, gp = st["velocity"][k].to(dev), st["params"][k].to(dev)
                    worst = max(worst, _within_ulp(gv, getattr(vw, k)),
                                _within_ulp(gp, getattr(pw, k), gv, getattr(vw, k)))
                prev = (RBMParams(**{k: x.to(dev) for k, x in st["params"].items()}),
                        RBMParams(**{k: x.to(dev) for k, x in st["velocity"].items()}))
            report[name] = {"vs_replay": "one update at a time, one bf16 ulp",
                            "max_abs_diff": worst}
            continue
        params, vel, errs_r = replays[name][:3]
        diff = {}
        for part, want in (("params", params), ("velocity", vel)):
            for k, x in states[-1][part].items():
                torch.testing.assert_close(x, getattr(want, k).cpu(), rtol=DP_RTOL, atol=DP_ATOL)
                diff[f"{part}.{k}"] = float((x - getattr(want, k).cpu()).abs().max())
        torch.testing.assert_close(r0["inject"]["errs"], errs_r.cpu(), rtol=DP_RTOL,
                                   atol=DP_ATOL)
        report[name] = {"vs_replay": f"rtol {DP_RTOL}, atol {DP_ATOL}",
                        "max_abs_diff": max(diff.values())}
        report[name].update(first_err=r0["history"][0], final_err=r0["history"][-1])
    phase(phase_name, ranks=DP_RANKS, backend="gloo", rows=DP_RANK_ROWS,
          kernel={n: got[0][n]["kernel"] for n in names},
          launches={n: got[0][n]["launches"] for n in names},
          injected_launches={n: got[0][n]["inject"]["launches"] for n in names},
          train_seconds={n: [round(g[n]["seconds"], 3) for g in got] for n in names},
          spawn_seconds=round(spawn_s, 3), identical_bits_across_ranks=True,
          injected=report, nvidia_smi=smi)


# The W-blocked kernel's data-parallel mode (phases 20-22,
# csrc/cd_grads_wide.cu): the wide rows in its scope at full width. One card
# times the kernels and counts the bytes a rank sends; the exchange's time
# needs two or more cards.
WIDE_DP_ROWS = ("w20k", "w20k_mom_bf16", "w28k", "w40k_bf16")
WIDE_DP_RANK_ROWS = ("w20k_mom_bf16",)  # phase 22; phase 19 runs the other DP modes
WIDE_DP_REPLAYED = 3  # updates held one at a time against cd_train_wide.cu (phase 21)
WIDE_DP_SHARD_RANKS = 4  # the step is also timed on a shard of B / 4 rows


def wide_step_bound(cfg):
    """(ms, what bounds it) of one W-blocked DP step on a shard of
    cfg.batch_size rows: operations 2*rows*V*H for the hidden phase from the
    data, a visible and a hidden phase per Gibbs step and, under PCD, the
    data chain's reconstruction, at the peak of the compute dtype; bytes: W,
    b, c and v0 read (the chain read and written under PCD) at the storage
    width, and the rank's slot written."""
    from mdbn_tpu_torch.ops.cd_grads_wide_cuda import wide_factor_size

    B, V, H, k = cfg.batch_size, cfg.n_visible, cfg.n_hidden, cfg.k
    rows = B + 2 * k * B + (B if cfg.persistent else 0)
    peak = PEAK_BF16_FLOPS if cfg.compute_dtype == "bfloat16" else PEAK_F32_FLOPS
    ops_s = 2.0 * rows * V * H / peak
    width = 2 if cfg.param_dtype == "bfloat16" else 4
    moved = width * (V * H + V + H + B * V + (2 * B * H if cfg.persistent else 0))
    bytes_s = (moved + wide_factor_size(cfg)) / PEAK_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def wide_update_bound(cfg, ndev):
    """(ms, what bounds it) of one W-blocked DP update over ndev ranks' slots:
    operations 4*B*V*H for gW's two products at the peak of the compute
    dtype, and six per element of W, b and c for the update at the f32
    peak; bytes: W, b and c read and written and their velocities written
    (and read under momentum) at the storage width, v0 read, every rank's
    slot read."""
    from mdbn_tpu_torch.ops.cd_grads_wide_cuda import wide_factor_size

    B, V, H = cfg.batch_size, cfg.n_visible, cfg.n_hidden
    n = V * H + V + H
    peak = PEAK_BF16_FLOPS if cfg.compute_dtype == "bfloat16" else PEAK_F32_FLOPS
    ops_s = 4.0 * B * V * H / peak + 6.0 * n / PEAK_F32_FLOPS
    width = 2 if cfg.param_dtype == "bfloat16" else 4
    vel_moves = 2 if cfg.momentum != 0 or cfg.initial_momentum is not None else 1
    local = cfg.replace(batch_size=-(-B // ndev))
    moved = width * ((2 + vel_moves) * n + B * V) + ndev * wide_factor_size(local)
    bytes_s = moved / PEAK_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def _slot_close(cfg, got, want) -> float:
    """Assert a W-blocked DP step's slot ``got`` agrees with ``want``; the
    largest |diff|. float32: vs, the h-matrix and err at the replay
    tolerance. bf16 compute: every product's operands round to bf16, so vs
    (itself bf16) and the h-matrix are held to one bf16 ulp (2^-7 of each
    value) plus 2^-8 absolute for the probabilities, err to 1e-3 of itself."""
    import torch

    from mdbn_tpu_torch.ops.cd_grads_wide_cuda import slot_views

    worst = 0.0
    for part, a, b in zip(("vs", "h-matrix", "err"), slot_views(cfg, got), slot_views(cfg, want)):
        a, b = a.float(), b.float()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"the step's {part} is not finite")
        if cfg.compute_dtype != "bfloat16":
            torch.testing.assert_close(a, b, rtol=REPLAY_RTOL, atol=REPLAY_ATOL)
        else:
            atol = {"vs": REPLAY_ATOL, "h-matrix": 2.0 ** -8, "err": REPLAY_ATOL}[part]
            rtol = 1e-3 if part == "err" else 2.0 ** -7
            if bool(((a - b).abs() > rtol * torch.maximum(a.abs(), b.abs()) + atol).any()):
                raise AssertionError(f"bf16-compute {part} differs beyond one operand ulp: "
                                     f"{float((a - b).abs().max())}")
        worst = max(worst, float((a - b).abs().max()))
    return worst


def _params_close(cfg, got, want) -> float:
    """Assert an update's (params, velocity) ``got`` agree with ``want``
    (float32 at the replay tolerance; bf16 a velocity to one ulp, a parameter
    to its velocity's ulp and one of its own); the largest |diff|."""
    import torch

    worst = 0.0
    for k in ("W", "b", "c"):
        gp, gv, wp, wv = (getattr(x, k) for x in (got[0], got[1], want[0], want[1]))
        if not bool(torch.isfinite(gp.float()).all()):
            raise AssertionError(f"the update's {k} is not finite")
        if gp.dtype == torch.bfloat16:
            worst = max(worst, _within_ulp(gv, wv), _within_ulp(gp, wp, gv, wv))
        else:
            for a, b in ((gp, wp), (gv, wv)):
                torch.testing.assert_close(a, b, rtol=REPLAY_RTOL, atol=REPLAY_ATOL)
                worst = max(worst, float((a - b).abs().max()))
    return worst


def _wide_gathered(cfg, data, p, chain, gen, ndev, dev):
    """ndev ranks' slots of the first minibatch from plain steps on random
    draws, in rank order: the update's gathered input."""
    import torch

    from mdbn_tpu_torch.ops import cd_grads_wide_cuda as GW
    from mdbn_tpu_torch.ops.cd_step import draw_uniforms

    B = cfg.batch_size
    lb = -(-B // ndev)
    local = cfg.replace(batch_size=lb)
    nbytes = GW.wide_factor_size(local)
    gathered = torch.zeros(ndev * nbytes, dtype=torch.uint8, device=dev)
    for d in range(ndev):
        GW.cd_wide_step_plain(local, p, _shard(data[:B], d, lb)[0], chain[:lb],
                              uniforms=draw_uniforms(local, lb, gen),
                              n_valid=min(lb, B - d * lb), norm=B / ndev,
                              out=gathered[d * nbytes:(d + 1) * nbytes])
    return gathered


def wide_update_library_us(cfg, p, vel, v0, gathered, ndev) -> float:
    """Device us of the W-blocked update's nearest library form (timed for
    comparison only): gW by one torch.addmm of the gathered operands [v0;
    vs]^T [h0p; -hmean] into the velocity (momentum 0.5, lr / B), then W +=
    vW, at the storage dtype; the operands assembled before the timing."""
    import torch

    from mdbn_tpu_torch.ops import cd_grads_wide_cuda as GW

    B = cfg.batch_size
    views = GW.gathered_views(cfg.replace(batch_size=-(-B // ndev)), gathered, ndev)
    sdt = p.W.dtype
    X = torch.cat([v0[:B], torch.cat([v[0] for v in views])[:B]]).to(sdt)
    Y = torch.cat([torch.cat([v[1][0] for v in views])[:B],
                   torch.cat([v[1][1] for v in views])[:B]]).to(sdt)
    W, vW = p.W.clone(), vel.W.clone()

    def library():
        vW.addmm_(X.t(), Y, beta=0.5, alpha=cfg.lr / B)
        W.add_(vW)

    return device_us(library, 30)


def run_wide_dp_kernels(dev, smi, modes):
    """Phase 20: both W-blocked DP kernels against their plain versions at
    full width (WIDE_DP_ROWS): the step on the whole batch and on the third
    shard of a 3-way split (7 rows, one pad row, norm 20/3), same bits on
    grids 1, 7, 132; the update (csrc/cd_wide_update.cuh) on 3 ranks'
    gathered slots (uneven) and on 4 ranks' (even), at the row's momentum and
    under a schedule from 0 to 0.5 (epoch 0: m = 0 on the velocity variant;
    epoch 1: m = 0.5), same bits and the same monitor on grids 1, 7, 132 and
    the default. Their device times per launch (torch.profiler), the plain
    versions' and the bounds, the update's library form and its trace (block
    0's phases); the step also on a shard of B / 4 rows; the old route's step
    and update (csrc/cd_grads.cu) at the same shapes for comparison, and the
    bytes a rank sends on each route. Returns {row: (step err, update err,
    timing)}."""
    import torch

    from mdbn_tpu_torch.core.rbm_math import RBMParams
    from mdbn_tpu_torch.ops import cd_grads_cuda as G
    from mdbn_tpu_torch.ops import cd_grads_wide_cuda as GW
    from mdbn_tpu_torch.ops.cd_step import draw_uniforms
    from mdbn_tpu_torch.parallel.dp import world_scale

    scale = world_scale(DP_RANKS)
    out, errs = {}, {}
    for n, name in enumerate(WIDE_DP_ROWS):
        cfg, data = modes[name]
        B, sdt = cfg.batch_size, data.dtype
        lb = -(-B // DP_RANKS)
        gen = torch.Generator(device=dev).manual_seed(30 + n)
        shard = _shard(data[:B], DP_RANKS - 1, lb)[0]
        step_err = 0.0
        for case, (c, v0, nv, norm) in (
                ("whole", (cfg, data[:B], B, None)),
                ("rank2_of_3", (cfg.replace(batch_size=lb), shard, B - (DP_RANKS - 1) * lb,
                                B / DP_RANKS))):
            p, chain = _mode_state(c, dev, n)
            u = G.harden_step(c, p, chain, v0, draw_uniforms(c, c.batch_size, gen), wide=True)
            got, c_got = GW.cd_wide_step(c, p, v0, chain, uniforms=u, n_valid=nv, norm=norm)
            want, c_want = GW.cd_wide_step_plain(c, p, v0, chain, uniforms=u, n_valid=nv,
                                                 norm=norm)
            torch.cuda.synchronize()
            errs[f"{name}@step_{case}"] = _slot_close(c, got, want)
            torch.testing.assert_close(c_got, c_want, rtol=0, atol=0)  # the same samples
            step_err = max(step_err, errs[f"{name}@step_{case}"])
            if case == "rank2_of_3":  # the kernel's own draws on several grids
                runs = [GW.cd_wide_step(c, p, v0, chain, seed=11, n_valid=nv, norm=norm, grid=g)
                        for g in (0,) + GRADS_GRIDS]
                for slot, ch in runs[1:]:
                    if not (torch.equal(slot, runs[0][0]) and torch.equal(ch, runs[0][1])):
                        raise AssertionError(f"{name}: the W-blocked DP step depends on the grid")
        # the update on 3 ranks' slots of the first minibatch (and 4 ranks'),
        # from plain steps, at the row's momentum and under a schedule from 0
        local = cfg.replace(batch_size=lb)
        p, chain = _mode_state(local, dev, n)
        rand = lambda *shape: (1e-3 * torch.randn(shape, generator=gen, device=dev)).to(sdt)
        vel = RBMParams(W=rand(*p.W.shape), b=rand(*p.b.shape), c=rand(*p.c.shape))
        gathered = _wide_gathered(cfg, data, p, chain, gen, DP_RANKS, dev)
        even = _wide_gathered(cfg, data, p, chain, gen, WIDE_DP_SHARD_RANKS, dev)
        sched = cfg.replace(initial_momentum=0.0, momentum=0.5, momentum_switch_epoch=1)
        update_err = 0.0
        for case, (c, ranks, slots, epoch) in {
                "3_ranks": (cfg, DP_RANKS, gathered, 0),
                f"{WIDE_DP_SHARD_RANKS}_ranks": (cfg, WIDE_DP_SHARD_RANKS, even, 0),
                "schedule_m0": (sched, DP_RANKS, gathered, 0),
                "schedule_m0.5": (sched, DP_RANKS, gathered, 1)}.items():
            sc = world_scale(ranks)
            want = GW.cd_wide_update_plain(c, p, vel, data[:B], slots, ranks, sc, epoch)
            runs = [GW.cd_wide_update(c, p.map(torch.clone), vel.map(torch.clone), data[:B],
                                      slots, ranks, sc, epoch, grid=g)
                    for g in (0,) + GRADS_GRIDS]
            torch.cuda.synchronize()
            for r in runs[1:]:
                if not (all(torch.equal(x, y) for i in (0, 1) for x, y in
                            zip(r[i].as_dict().values(), runs[0][i].as_dict().values()))
                        and torch.equal(r[2], runs[0][2])):
                    raise AssertionError(f"{name} {case}: the W-blocked DP update depends on "
                                         "the grid")
            if not torch.equal(runs[0][2], want[2]):
                raise AssertionError(f"{name} {case}: the update's monitor differs from the "
                                     "plain version's")
            errs[f"{name}@update_{case}"] = _params_close(c, runs[0], want)
            update_err = max(update_err, errs[f"{name}@update_{case}"])

        # timing: the launches alone on fixed buffers, the plain versions;
        # plain, kernel, kernel, plain; then device time by torch.profiler
        p, chain = _mode_state(cfg, dev, 0)
        v0 = data[:B]
        step = GW.step_launcher(cfg, p, v0, chain, seed=5)[0]
        c4 = cfg.replace(batch_size=B // WIDE_DP_SHARD_RANKS)
        step4 = GW.step_launcher(c4, p, data[:c4.batch_size], chain[:c4.batch_size], seed=5)[0]
        pu, vu = p.map(torch.clone), vel.map(torch.clone)
        update = GW.update_launcher(cfg, pu, vu, v0, gathered, DP_RANKS, scale, 0)[0]

        def step_plain(cfg=cfg, p=p, v0=v0, chain=chain):
            GW.cd_wide_step_plain(cfg, p, v0, chain, seed=5)

        def update_plain(cfg=cfg, p=p, vel=vel, v0=v0, gathered=gathered):
            GW.cd_wide_update_plain(cfg, p, vel, v0, gathered, DP_RANKS, scale, 0)

        t = [time_runs(step_plain, 5), time_runs(step, 50), time_runs(step, 50),
             time_runs(step_plain, 5), time_runs(update_plain, 5), time_runs(update, 50),
             time_runs(update, 50), time_runs(update_plain, 5)]
        flat = torch.empty(G.flat_size(cfg), device=dev)
        old_step = G.step_launcher(cfg, p, v0, chain, seed=5, out=flat)[0]
        old_update = G.update_launcher(cfg, p.map(torch.clone), vel.map(torch.clone), flat,
                                       1.0, 0)[0]
        s_ms, s_by = wide_step_bound(cfg)
        s4_ms, s4_by = wide_step_bound(c4)
        u_ms, u_by = wide_update_bound(cfg, DP_RANKS)
        local4 = cfg.replace(batch_size=-(-B // WIDE_DP_SHARD_RANKS))
        nbytes = GW.wide_factor_size(cfg.replace(batch_size=lb))
        trace = torch.zeros(len(GW.UPDATE_TRACE), dtype=torch.int64, device=dev)
        GW.update_launcher(cfg, pu, vu, v0, gathered, DP_RANKS, scale, 0, trace=trace)[0]()
        torch.cuda.synchronize()
        tr = dict(zip(GW.UPDATE_TRACE, trace.tolist()))
        out[name] = (step_err, update_err, {
            "step_device_us": device_us(step, 30, ("cd_wide_step_kernel",)),
            "step_us_calls": [t[1] * 1e6, t[2] * 1e6],
            "step_plain_us": min(t[0], t[3]) * 1e6, "step_bound_us": s_ms * 1e3,
            "step_bound_by": s_by,
            f"step_{WIDE_DP_SHARD_RANKS}_ranks_device_us": device_us(step4, 30,
                                                                    ("cd_wide_step_kernel",)),
            f"step_{WIDE_DP_SHARD_RANKS}_ranks_bound_us": s4_ms * 1e3,
            "update_device_us": device_us(update, 30, ("cd_wide_update_kernel",)),
            "update_us_calls": [t[5] * 1e6, t[6] * 1e6],
            "update_plain_us": min(t[4], t[7]) * 1e6, "update_bound_us": u_ms * 1e3,
            "update_bound_by": u_by,
            "update_library_us": wide_update_library_us(cfg, p, vel, v0, gathered, DP_RANKS),
            "update_plan": GW.update_plan(cfg)._asdict(),
            "update_trace_us": {  # block 0's, one launch
                "y_staged": (tr["y_staged"] - tr["entry"]) / 1e3,
                "ring_wait": tr["ring_wait_ns"] / 1e3, "sums": tr["sums_ns"] / 1e3,
                "update": tr["update_ns"] / 1e3, "c_after": (tr["exit"] - tr["tiles_done"]) / 1e3,
                "total": (tr["exit"] - tr["entry"]) / 1e3, "tiles": tr["tiles"]},
            "cd_grads_step_device_us": device_us(old_step, 30, ("cd_grads_kernel",)),
            "cd_grads_update_device_us": device_us(old_update, 30, ("cd_update_kernel",)),
            "bytes_sent_per_rank": {
                "cd_grads_all_reduce": 4 * G.flat_size(cfg),
                f"cd_grads_wide_gather_{DP_RANKS}_ranks": nbytes,
                f"cd_grads_wide_gather_{WIDE_DP_SHARD_RANKS}_ranks":
                    GW.wide_factor_size(local4)}})
    phase("kernel_vs_plain_wide_dp", max_abs_diff=errs, rtol=REPLAY_RTOL, atol=REPLAY_ATOL,
          chain="identical samples", identical_bits_on_grids=list(GRADS_GRIDS) + ["default"],
          timing={k: v[2] for k, v in out.items()}, order="plain, kernel, kernel, plain",
          nvidia_smi=smi)
    return out


WIDE_DP_BUSY = 0.9  # the least busy share of a captured W-blocked DP epoch's device time


def run_wide_dp_world1(dev, smi, modes):
    """Phase 21: each row of WIDE_DP_ROWS for 10 epochs through
    train_rbm_shard_map(pallas_step=True) on a one-rank NCCL mesh, as a
    captured epoch replayed (a CUDA graph of nb x step, all-gather, update):
    the cd_grads_wide kernels nb times an epoch, cd_grads never; the monitor
    falls; the eager loop's bits; ms an epoch captured and eager and the busy
    share (at least WIDE_DP_BUSY captured); w20k_mom_bf16 under a momentum
    schedule switching from 0 to 0.5 between epochs, captured against eager
    over 3 epochs; then WIDE_DP_REPLAYED updates one at a time against the
    single-device W-blocked kernel (cd_train_wide.cu) on the same injected
    draws: whether the bits match (the update sums in another order), and
    the largest difference. Returns {row: {kernel: launches}}."""
    import torch
    import torch.distributed as dist

    from mdbn_tpu_torch.core.state import TrainState, init_train_state
    from mdbn_tpu_torch.ops import cd_epoch_cuda as K
    from mdbn_tpu_torch.parallel import dp
    from mdbn_tpu_torch.parallel.mesh import make_mesh

    launches, runs = run_dp_world1_modes(dev, modes, WIDE_DP_ROWS, "dp_world1_wide")
    for name in WIDE_DP_ROWS:
        busy = runs[name]["busy_captured"]["busy_share"]
        if busy < WIDE_DP_BUSY:
            raise AssertionError(f"dp_world1_wide {name}: the card busy {busy:.3f} of a "
                                 f"captured epoch's device time, under {WIDE_DP_BUSY}")
    one = torch.zeros((1, 1), dtype=torch.int32)
    mesh = make_mesh(1, backend="nccl")
    try:
        cfg, data = modes["w20k_mom_bf16"]
        cfg = cfg.replace(engine="pallas", initial_momentum=0.0, momentum=0.5,
                          momentum_switch_epoch=1)
        zero_dp_launches()
        captured = dp.train_rbm_shard_map(init_train_state(cfg, device=dev), data, cfg, mesh, 3,
                                          pallas_step=True)
        torch.cuda.synchronize()
        nb = data.shape[0] // cfg.batch_size
        if dp_launches() != expected_dp_launches(cfg, 3 * nb):
            raise AssertionError(f"dp_world1_wide momentum switch: launches {dp_launches()}")
        _captured_equals_eager(cfg, data, mesh, dev, 3, captured, "dp_world1_wide switch")
        switch = {"row": "w20k_mom_bf16", "initial_momentum": 0.0, "momentum": 0.5,
                  "momentum_switch_epoch": 1, "epochs": 3,
                  "captured_equals_eager": "identical bits", "errors": captured[1].tolist()}
        for name in WIDE_DP_ROWS:
            cfg, data = modes[name]
            cfg = cfg.replace(engine="pallas")
            B = cfg.batch_size
            st = init_train_state(cfg, device=dev)
            gen = torch.Generator(device=dev).manual_seed(40)
            same, worst = [], 0.0
            for t in range(WIDE_DP_REPLAYED):
                batch = data[t * B:(t + 1) * B]
                u = K.draw_uniform_blocks(cfg, gen, 1, 1)
                single = K.cd_train_run(cfg, st.params, st.velocity, st.chain_h, batch, one, t,
                                        u, wide=True)
                st, errs = dp.train_rbm_shard_map(
                    TrainState(st.params, st.velocity, st.chain_h, st.generator, t), batch, cfg,
                    mesh, 1, pallas_step=True, uniforms={k: x[:, :, None] for k, x in u.items()})
                torch.cuda.synchronize()
                same.append(all(torch.equal(a, b) for part in (0, 1) for a, b in zip(
                    single[part].as_dict().values(),
                    (st.params, st.velocity)[part].as_dict().values())))
                worst = max(worst, _params_close(cfg, (st.params, st.velocity), single))
                torch.testing.assert_close(errs, single[3], rtol=REPLAY_RTOL, atol=REPLAY_ATOL)
            runs[name]["vs_cd_train_wide"] = {"updates": WIDE_DP_REPLAYED, "identical_bits": same,
                                              "max_abs_diff": worst}
    finally:
        dist.destroy_process_group()
    phase("dp_world1_wide", launches=launches, runs=runs, momentum_switch=switch,
          busy_at_least=WIDE_DP_BUSY, nvidia_smi=smi)
    return launches


DP_MODE_REPLACES = {"pt5": 2760, "enhanced": 1535, "lv": 1542, "pt3_lv": 1542, "pseudo": 1604,
                    "c1_bf16": 1622, "w20k_mom_bf16": 1622}
DP_UPDATE_REPLACES = {"lv": 1588, "enhanced": 1568, "c1_bf16": 1622, "w20k_mom_bf16": 1622}


def enhance_bound(cfg) -> float:
    """ms of the enhanced gradient's matvec pass at the memory rate: the
    flat sums it reads (gW, gb, gc and the mean sums, f32) once and its
    shares written once (csrc/cd_grads.cu's cd_enhance_scratch_floats); its
    4 V H operations at the f32 peak take less."""
    from mdbn_tpu_torch._build import load_library
    from mdbn_tpu_torch.ops.cd_grads_cuda import flat_size

    lib = load_library("cd_grads", cfg.param_dtype).lib
    shares = lib.cd_enhance_scratch_floats(cfg.n_visible, cfg.n_hidden)
    return 4.0 * (flat_size(cfg) + shares) / PEAK_BYTES_PER_S * 1e3


def run_dp_modes(dev, smi, c1, c1_data, ge) -> list:
    """Phases 16-22, the data-parallel path in every mode and the W-blocked
    kernel's data-parallel mode; returns their entries of the kernel line.
    Phase 16 calls cd_grads.cu at every row (the old route of the rows the
    step variant takes, and of w20k_mom_bf16, for comparison); from phase 18
    on each row takes the route select_dp_kernel gives, and the kernel line
    counts the launches there."""
    modes = dp_mode_configs(dev, c1, c1_data, ge)
    grads = run_grads_modes(dev, smi, modes)
    updates = run_update_modes(dev, smi, modes)
    launches, runs = run_dp_world1_modes(dev, modes, DP_MODES, "dp_world1_modes")
    phase("dp_world1_modes", launches=launches, runs=runs, nvidia_smi=smi)
    run_dp_ranks_modes(dev, smi, modes, [n for n in DP_MODES if n not in WIDE_DP_RANK_ROWS],
                       "dp_ranks_modes")
    modes.update({name: wide_row(name, dev) for name in WIDE_DP_ROWS})
    wide = run_wide_dp_kernels(dev, smi, modes)
    wide_launches = run_wide_dp_world1(dev, smi, modes)
    run_dp_ranks_modes(dev, smi, modes, WIDE_DP_RANK_ROWS, "dp_ranks_wide")
    entries = []
    sources = {"cd_grads": "mdbn_tpu_torch/csrc/cd_grads.cu",
               "cd_grads_resident": "mdbn_tpu_torch/csrc/cd_train_resident.cu"}
    for name in DP_MODES:
        route = runs[name]["route"]
        if route not in sources:
            continue  # its launches are the W-blocked DP kernels' (below)
        err, t = grads[route][name]
        entries.append({
            "name": f"{route}[{name}]", "route": "cuda", "source": sources[route],
            "replaces": f"mdbn_tpu/ops/cd_epoch_pallas.py:{DP_MODE_REPLACES[name]}",
            "launches": launches[name][route], "max_abs_err": err,
            "ms": t["kernel_device_us"] / 1e3, "plain_ms": t["plain_us"] / 1e3,
            "bound_ms": t["bound_us"] / 1e3, "bound_by": t["bound_by"], "library_ms": None,
            "ms_per": f"one step of {name} on the whole batch"})
    for name in DP_UPDATE_MODES:
        if runs[name]["route"] not in sources:
            continue
        err, t = updates[name]
        extra = {}
        if "enhance_device_us" in t:  # the matvec pass, launched before the update
            extra = {"enhance_ms": t["enhance_device_us"] / 1e3,
                     "enhance_bound_ms": enhance_bound(modes[name][0]),
                     "update_alone_ms": t["update_device_us"] / 1e3}
        entries.append({
            "name": f"cd_dp_update[{name}]", "route": "cuda",
            "source": "mdbn_tpu_torch/csrc/cd_grads.cu",
            "replaces": f"mdbn_tpu/ops/cd_epoch_pallas.py:{DP_UPDATE_REPLACES[name]}",
            "launches": launches[name]["cd_dp_update"], "max_abs_err": err,
            "ms": t["kernel_device_us"] / 1e3, "plain_ms": t["plain_us"] / 1e3,
            "bound_ms": t["bound_us"] / 1e3, "bound_by": t["bound_by"], "library_ms": None,
            "ms_per": f"one update of {name} after the all-reduce", **extra})
    for name in WIDE_DP_ROWS:
        step_err, update_err, t = wide[name]
        for kernel, err, what, source, replaces, library in (
                ("step", step_err, f"one step of {name} on the whole batch (one rank)",
                 "mdbn_tpu_torch/csrc/cd_grads_wide.cu", 1981, None),
                ("update", update_err, f"one update of {name} over {DP_RANKS} ranks' slots",
                 "mdbn_tpu_torch/csrc/cd_wide_update.cuh", 2298,
                 t["update_library_us"] / 1e3)):
            entries.append({
                "name": f"cd_grads_wide_{kernel}[{name}]", "route": "cuda", "source": source,
                "replaces": f"mdbn_tpu/ops/cd_epoch_pallas.py:{replaces}",
                "launches": wide_launches[name][f"cd_grads_wide_{kernel}"],
                "max_abs_err": err, "ms": t[f"{kernel}_device_us"] / 1e3,
                "plain_ms": t[f"{kernel}_plain_us"] / 1e3,
                "bound_ms": t[f"{kernel}_bound_us"] / 1e3, "bound_by": t[f"{kernel}_bound_by"],
                "library_ms": library, "ms_per": what})
    return entries


def _tp_rank(rank, world, port, out_dir, c1, c1_train, w20k, w20k_data, w20k_uniforms):
    """One rank of phase 29, in a process of its own on the one card: c1
    through RBM.train with the dp x tp mesh, w20k through train_rbm on the
    injected draws, then ms an epoch of the tp route at both widths (CUDA
    events) and the collectives' share of a timed call."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from mdbn_tpu_torch import RBM
    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.parallel.mesh import make_mesh_2d
    from mdbn_tpu_torch.parallel.tp import CollectiveTimer, train_rbm_tp
    from mdbn_tpu_torch.train.trainer import train_rbm

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh_2d(*DP_TP, backend="gloo")
        dev = torch.device("cuda", 0)
        c1_data = torch.as_tensor(c1_train, device=dev)
        w_data = w20k_data.to(dev)
        res = {"mesh": [mesh.rank, mesh.size, mesh.dp, mesh.tp, mesh.dp_rank, mesh.tp_rank,
                        str(mesh.device), mesh.backend]}

        def counts():
            return {**train_counts(), **dp_launches()}

        def zero():
            zero_train_counts()
            zero_dp_launches()

        # the main path: c1 through RBM.train with the mesh, the counts set to
        # 0 just before and read just after
        zero()
        t0 = time.perf_counter()
        rbm = RBM(c1.replace(epochs=10), device=dev).train(c1_data, mesh=mesh)
        torch.cuda.synchronize()
        res["c1"] = {"engine": rbm.metrics.engine, "kernel": rbm.metrics.kernel,
                     "launches": counts(), "seconds": time.perf_counter() - t0,
                     "history": rbm.history,
                     "params": {k: v.cpu() for k, v in rbm.params.as_dict().items()}}
        zero()
        st, m = train_rbm(w_data, w20k.replace(epochs=TP_W20K_EPOCHS), mesh=mesh,
                          uniforms={k: u.to(dev) for k, u in w20k_uniforms.items()})
        torch.cuda.synchronize()
        res["w20k"] = {"engine": m.engine, "kernel": m.kernel, "launches": counts(),
                       "errors": m.errors,
                       "params": {k: v.cpu() for k, v in st.params.as_dict().items()}}

        # ms an epoch: a call of TP_EPOCHS_TIMED epochs (CUDA events), less
        # the gather of the state at its end (its host time by the timer);
        # the collectives' share of the rest. Twice each.
        timing = {}  # each width warmed up by its run above
        for name, cfg, data in (("c1", c1, c1_data), ("w20k", w20k, w_data)):
            runs = []
            for _ in range(2):
                st = init_train_state(cfg, device=dev)  # made outside the timing
                timer = CollectiveTimer(dev)
                dist.barrier()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                train_rbm_tp(st, data, cfg, mesh, TP_EPOCHS_TIMED, timer=timer)
                end.record()
                torch.cuda.synchronize()
                call = start.elapsed_time(end)
                ms = {k: v * 1e3 for k, v in timer.seconds.items()}
                loop = call - ms["gather"]
                runs.append({"call_ms": call, "collective_ms": ms, "collectives": timer.calls,
                             "epoch_ms": loop / TP_EPOCHS_TIMED,
                             "collective_share": (ms["tp"] + ms.get("dp", 0.0)) / loop})
            best = min(runs, key=lambda r: r["epoch_ms"])
            timing[name] = {"epoch_ms": best["epoch_ms"],
                            "collective_share": best["collective_share"], "runs": runs}
        res["timing"] = timing
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_dp_tp(dev, smi, c1) -> None:
    """Phase 29, dp_tp_ranks: the dp x tp mesh (DP_TP, 4 gloo ranks on the one
    card), the tensor-parallel route (no kernel of its own: the eager engine
    with W, c and the chain split over the hidden units). c1 for 10 epochs
    through RBM.train(mesh=...): engine eager_tp on every rank, no kernel
    counter moved, the same whole state on every rank (and inside the run
    the dp replicas of each shard and the replicated b the same bits: the
    gather checks them), the final error within TP_ERR_TOL of the
    single-device eager run on the card and within C1_ERR_TOL of 0.0744;
    w20k for TP_W20K_EPOCHS epochs on hardened injected draws against the
    single-device eager run on the same draws at TP_TOL; the same mesh
    through the CLI (torchrun, --dp 2 --tp 2); ms an epoch of the tp route,
    the single-device eager run and the kernel run at c1 and w20k (CUDA
    events), and the collectives' share of the tp route's time."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from mdbn_tpu_torch import RBM
    from mdbn_tpu_torch.config import load_config
    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.ops import cd_epoch_cuda as K
    from mdbn_tpu_torch.parallel.mesh import _free_port
    from mdbn_tpu_torch.run import build_data
    from mdbn_tpu_torch.train.trainer import train_rbm

    c1_train, _, _ = build_data(load_config(C1)["data"])
    w20k, w_data = wide_row("w20k", dev)
    nb = w_data.shape[0] // w20k.batch_size
    st = init_train_state(w20k, device=dev)
    u = K.draw_uniform_blocks(w20k, torch.Generator(device=dev).manual_seed(29), TP_W20K_EPOCHS,
                              nb)
    hard = K.harden_uniform_blocks(w20k, st.params, st.velocity, st.chain_h, w_data, u,
                                   TP_W20K_EPOCHS)
    # the single-device eager runs on the card the tp route is held against
    eager_c1 = RBM(c1.replace(epochs=10, engine="xla"), device=dev).train(c1_train)
    eager_w, eager_wm = train_rbm(w_data, w20k.replace(epochs=TP_W20K_EPOCHS, engine="xla"),
                                  uniforms=hard, device=dev)
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        world = DP_TP[0] * DP_TP[1]
        ranks = mp.spawn(_tp_rank, args=(world, _free_port(), out, c1, c1_train, w20k,
                                         w_data.cpu(), {k: x.cpu() for k, x in hard.items()}),
                         nprocs=world, join=False)
        while not ranks.join(timeout=1.0):  # a failed rank raises here, the others stopped
            if time.perf_counter() - t0 > DP_TP_LIMIT_S:
                for proc in ranks.processes:
                    proc.kill()
                raise AssertionError(f"dp_tp_ranks: the ranks did not finish in "
                                     f"{DP_TP_LIMIT_S} s")
        spawn_s = time.perf_counter() - t0
        got = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(world)]
    tp = DP_TP[1]
    want_mesh = [[r, world, DP_TP[0], tp, r // tp, r % tp, "cuda:0", "gloo"]
                 for r in range(world)]
    if [g["mesh"] for g in got] != want_mesh:
        raise AssertionError(f"dp_tp_ranks: meshes {[g['mesh'] for g in got]}")
    for r, g in enumerate(got):
        for run in ("c1", "w20k"):
            x = g[run]
            if (x["engine"], x["kernel"]) != ("eager_tp", None) or any(x["launches"].values()):
                raise AssertionError(f"dp_tp_ranks rank {r} ({run}): engine {x['engine']}, "
                                     f"kernel {x['kernel']}, launches {x['launches']}")
            for k, v in x["params"].items():
                if not torch.equal(v, got[0][run]["params"][k]):
                    raise AssertionError(f"dp_tp_ranks ({run}): rank {r}'s {k} differs")
    hist, eager_hist = got[0]["c1"]["history"], eager_c1.history
    if (len(hist) != 10 or not all(np.isfinite(hist))
            or abs(hist[-1] - eager_hist[-1]) > TP_ERR_TOL
            or abs(hist[-1] - C1_FINAL_ERR) > C1_ERR_TOL):
        raise AssertionError(f"dp_tp_ranks: c1's final error {hist[-1]}, the single-device "
                             f"eager run's {eager_hist[-1]}, the band {C1_FINAL_ERR}")
    diff = {}
    w = got[0]["w20k"]
    for name, a, b in (("W", w["params"]["W"], eager_w.params.W),
                       ("b", w["params"]["b"], eager_w.params.b),
                       ("c", w["params"]["c"], eager_w.params.c),
                       ("errors", torch.tensor(w["errors"]), torch.tensor(eager_wm.errors))):
        torch.testing.assert_close(a, b.cpu(), **TP_TOL)
        diff[name] = float((a - b.cpu()).abs().max())
    # the CLI: torchrun, --dp 2 --tp 2 on the one card (gloo)
    with tempfile.TemporaryDirectory() as out:
        metrics = os.path.join(out, "m.jsonl")
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
             str(world), "-m", "mdbn_tpu_torch.run", "--config", C1, "--dp", str(DP_TP[0]),
             "--tp", str(tp), "--epochs", "2", "--metrics", metrics],
            cwd=HERE, capture_output=True, text=True, timeout=DP_TP_LIMIT_S)
        cli_s = time.perf_counter() - t0
        if cli.returncode != 0:
            raise AssertionError(f"dp_tp_ranks: the CLI exited {cli.returncode}: "
                                 f"{cli.stderr[-2000:]}")
        recs = [json.loads(line) for line in open(metrics)]
    if ([(x["engine"], x["kernel"]) for x in recs] != [("eager_tp", None)] * 2
            or not recs[-1]["recon_error"] < recs[0]["recon_error"]):
        raise AssertionError(f"dp_tp_ranks: the CLI's records {recs}")

    # single-device ms an epoch at the same configs: the eager engine and the
    # kernel select_kernel names, a SINGLE_EPOCHS_TIMED-epoch call of train_rbm
    # against a 1-epoch call (CUDA events; the state made outside the timing),
    # the least of three such pairs
    def epoch_ms(cfg, data):
        st = init_train_state(cfg, device=dev)

        def call(n):
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            train_rbm(data, cfg.replace(epochs=n), state=st)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end)

        call(1)
        return min((call(SINGLE_EPOCHS_TIMED) - call(1)) / (SINGLE_EPOCHS_TIMED - 1)
                   for _ in range(3))

    c1_dev = torch.as_tensor(c1_train, device=dev)
    timing = {}
    for name, cfg, data in (("c1", c1, c1_dev), ("w20k", w20k, w_data)):
        t = got[0]["timing"][name]
        zero_train_counts()
        kernel_ms = epoch_ms(cfg.replace(engine="pallas"), data)
        kernel = [k for k, n in train_counts().items() if n]
        timing[name] = {"tp_epoch_ms": t["epoch_ms"],
                        "tp_epoch_ms_by_rank": [g["timing"][name]["epoch_ms"] for g in got],
                        "tp_collective_share": t["collective_share"], "tp_runs": t["runs"],
                        "eager_epoch_ms": epoch_ms(cfg.replace(engine="xla"), data),
                        "kernel_epoch_ms": kernel_ms, "kernel": kernel}
    phase("dp_tp_ranks", mesh=list(DP_TP), ranks=world, backend="gloo",
          engine=[g["c1"]["engine"] for g in got], kernel=got[0]["c1"]["kernel"],
          launches=[g["c1"]["launches"] for g in got], first_err=hist[0], final_err=hist[-1],
          eager_final_err=eager_hist[-1], train_seconds=[round(g["c1"]["seconds"], 3)
                                                        for g in got],
          spawn_seconds=round(spawn_s, 3), identical_state_across_ranks=True,
          w20k_epochs=TP_W20K_EPOCHS, w20k_vs_eager_max_abs_diff=diff, **TP_TOL,
          cli={"records": len(recs), "errors": [x["recon_error"] for x in recs],
               "seconds": round(cli_s, 3)},
          epochs_timed={"tp": TP_EPOCHS_TIMED, "single_device": SINGLE_EPOCHS_TIMED},
          timing=timing, nvidia_smi=smi,
          nccl="not measured: NCCL refuses two ranks on one device")


def _cli(argv) -> list:
    """``mdbn_tpu_torch.run.main(argv)`` in this process; the JSON records it
    prints (its stdout is kept out of the smoke's)."""
    import contextlib
    import io

    from mdbn_tpu_torch.run import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(list(argv))
    if rc != 0:
        raise AssertionError(f"the CLI exited {rc}: {argv}")
    return [json.loads(l) for l in out.getvalue().splitlines() if l.startswith("{")]


def run_analysis_cli(smi) -> int:
    """The analysis_cli phase: the CLI's analysis path on the card. c5 as
    committed (every layer on the resident kernel by its counter; the kmeans
    record's ARI against the planted clusters and its log-rank p), then on
    c5's saved model an impute block (meth held out) and consensus k
    selection at 10 resamples, then c1_real_mnist_idx and c4_real_omics_csv
    on fixture files (scripts/torch_run_graded_configs.py's recipe) written
    to a temporary directory. Returns the resident kernel's launches."""
    import numpy as np

    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from torch_run_graded_configs import make_real_data_fixtures, rewrite_real_config

    from mdbn_tpu_torch.config import MDBNConfig, load_config

    t0 = time.perf_counter()
    launches, out = 0, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        exp5 = load_config(C5)
        n5 = sum(len(t.layer_sizes) for t in exp5["model"].towers.values()) + 1
        zero_train_counts()
        t = time.perf_counter()
        recs = _cli(["--config", C5, "--save", os.path.join(tmp, "c5")])
        counts = check_counts("c5", {"cd_train_resident": n5})
        launches += counts["cd_train_resident"]
        (km,) = [r for r in recs if r["kind"] == "kmeans"]
        ari, p = km["ari_vs_planted"], km["logrank"]["p_value"]
        if ari < C5_ARI_MIN:
            raise AssertionError(f"c5: ARI {ari} below {C5_ARI_MIN}")
        if ari == 1.0 and f"{p:.1e}" != f"{C5_LOGRANK_P:.1e}":
            raise AssertionError(f"c5: log-rank p {p:.3e} is not {C5_LOGRANK_P:.1e} at ARI 1")
        out["c5"] = {"seconds": round(time.perf_counter() - t, 3), "launches": counts,
                     "k": km["k"], "cluster_sizes": km["cluster_sizes"],
                     "ari_vs_planted": ari, "logrank_p": p}
        # inference on the saved model: imputation and consensus k selection
        more = dict(json.load(open(C5)), analysis={
            "kmeans": "consensus", "consensus_resamples": 10,
            "impute": {"holdout": "meth"}})
        path = os.path.join(tmp, "c5_inference.json")
        with open(path, "w") as f:
            json.dump(more, f)
        zero_train_counts()
        t = time.perf_counter()
        recs = _cli(["--config", path, "--load", os.path.join(tmp, "c5")])
        if any(train_counts().values()):
            raise AssertionError(f"--load trained: {train_counts()}")
        (imp,) = [r for r in recs if r["kind"] == "impute"]
        (km,) = [r for r in recs if r["kind"] == "kmeans"]
        if not (np.isfinite(imp["mse"]) and imp["ratio"] < 1.0):
            raise AssertionError(f"c5 impute: {imp}")
        if len(km["pac_scores"]) != 7 or km["ari_vs_planted"] < C5_ARI_MIN:
            raise AssertionError(f"c5 consensus: {km}")
        out["c5_load_impute_consensus"] = {
            "seconds": round(time.perf_counter() - t, 3), "impute": imp, "k": km["k"],
            "pac_scores": km["pac_scores"], "ari_vs_planted": km["ari_vs_planted"]}
        fixtures = make_real_data_fixtures(tmp)
        for name in ("c1_real_mnist_idx", "c4_real_omics_csv"):
            cfg_path = rewrite_real_config(os.path.join(HERE, "configs", f"{name}.json"),
                                           fixtures, tmp)
            model = load_config(cfg_path)["model"]
            n = (sum(len(t.layer_sizes) for t in model.towers.values()) + 1
                 if isinstance(model, MDBNConfig) else 1)
            metrics = os.path.join(tmp, f"{name}.jsonl")
            zero_train_counts()
            t = time.perf_counter()
            recs = _cli(["--config", cfg_path, "--metrics", metrics])
            counts = check_counts(name, {"cd_train_resident": n})
            launches += counts["cd_train_resident"]
            with open(metrics) as f:
                logged = [json.loads(l) for l in f]
            row = {"seconds": round(time.perf_counter() - t, 3), "launches": counts}
            epochs = [r for r in logged if r["kind"] == "epoch"]
            if epochs:
                row["err"] = [epochs[0]["recon_error"], epochs[-1]["recon_error"]]
            kms = [r for r in recs if r["kind"] == "kmeans"]
            if name.startswith("c4"):
                if len(kms) != 1 or min(kms[0]["cluster_sizes"]) == 0 or kms[0]["k"] != 3:
                    raise AssertionError(f"{name}: kmeans records {kms}")
                row["cluster_sizes"] = kms[0]["cluster_sizes"]
            out[name] = row
    phase("analysis_cli", runs=out, seconds=round(time.perf_counter() - t0, 3),
          ari_min=C5_ARI_MIN, logrank_p_reference=C5_LOGRANK_P, nvidia_smi=smi)
    return launches


def busy_share(fn, unprofiled_ms: float | None = None) -> dict:
    """One call of ``fn`` under torch.profiler: its wall time on the card (CUDA
    events), the kernels' device time and their share of the wall time. The
    profiler slows the host, so ``unprofiled_ms``, the same call's time
    without it, gives the kernels' share of that time too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    busy_us = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if us > 0 and ev.self_cpu_time_total == 0:  # kernels: device time, no CPU time
            busy_us += us
    wall_us = start.elapsed_time(end) * 1e3
    out = {"wall_ms": wall_us / 1e3, "kernel_ms": busy_us / 1e3,
           "busy_share": busy_us / wall_us if wall_us else None}
    if unprofiled_ms:
        out["unprofiled_ms"] = unprofiled_ms
        out["busy_share_unprofiled"] = busy_us / 1e3 / unprofiled_ms
    return out


def _ft_mode(model, mode: str, x, y, n_classes: int, epochs: int, draws=None) -> list:
    """One phase-2 mode through the model's own method; its history. For
    updown_labeled a label top is fitted first where there is none (same
    epochs). ``draws``: the mode's draws, passed to the trainer (the
    autoencoder draws nothing; updown_labeled's are {"label_top", "updown"})."""
    kw = dict(epochs=epochs)
    if mode == "classifier":
        return model.finetune(x, y, n_classes, **kw, draws=draws)
    if mode == "autoencoder":
        return model.finetune_autoencoder(x, **kw)
    if mode == "updown":
        return model.finetune_updown(x, **kw, draws=draws)
    if mode == "label_top":
        return model.fit_label_top(x, y, n_classes, **kw, draws=draws)
    if model._label_top is None:
        model.fit_label_top(x, y, n_classes, **kw, draws=None if draws is None else draws["label_top"])
    return model.finetune_updown_labeled(x, y, **kw, draws=None if draws is None else draws["updown"])


def _ft_tensors(model) -> dict:
    """Every parameter and fine-tuned tensor of a DBN or MDBN, by name."""
    from mdbn_tpu_torch.models.mdbn import MDBN

    out = {}
    dbns = (model.towers.items() if isinstance(model, MDBN) else [("", model)])
    for name, dbn in dbns:
        for l, r in enumerate(dbn.layers):
            out.update({f"{name}/layer{l}.{k}": t for k, t in r.params.as_dict().items()})
        for l, pair in enumerate(dbn._gen or []):
            out.update({f"{name}/gen{l}.{k}": t for k, t in zip("Wb", pair)})
        if isinstance(dbn._decoder, list):
            out.update({f"{name}/decoder{l}": t for l, t in enumerate(dbn._decoder)})
    if isinstance(model, MDBN):
        out.update({f"joint.{k}": t for k, t in model.joint.params.as_dict().items()})
        if model._decoder is not None:
            out.update({f"decoder/{m}{l}": t for m, Ds in model._decoder.items()
                        for l, t in enumerate(Ds)})
        for k, t in zip("Wb", model._joint_gen or ()):
            out[f"joint_gen.{k}"] = t
    for k, t in zip(("head.W", "head.b"), model._head or ()):
        out[k] = t
    if model._label_top is not None:
        out.update({f"label_top.{k}": t for k, t in model._label_top[0].as_dict().items()})
    return out


def _ft_draws(mode: str, epochs_steps: int):
    """Empty draw dicts for one epoch of ``epochs_steps`` minibatches: the
    CPU run fills them with the draws it makes, the card's run is fed them."""
    steps = lambda: {"steps": [[{} for _ in range(epochs_steps)]]}  # noqa: E731
    if mode == "classifier":
        return {}
    if mode == "updown_labeled":
        return {"label_top": steps(), "updown": steps()}
    return steps()


def run_finetune_phase(dev, smi) -> int:
    """The finetune phase (27): the phase-2 trainers on the card.

    (a) c3's DBN and c4's MDBN trained as committed (their layers on the
    kernel select_kernel names, by the counters), then each of FT_MODES for
    FT_EPOCHS epochs through the models' methods on a copy of each: every
    parameter, head, decoder and generative tensor on the card, the losses
    falling, the planted classes recovered; (b) two CLI runs
    (mdbn_tpu_torch.run.main, as ``python -m mdbn_tpu_torch.run``) of c3 with
    a labeled up-down block at label_fraction 0.3 and c4 with a classifier
    block, their records checked; (c) the first epoch of each mode on the
    card against the same call on the CPU on the draws the CPU run made, at
    FT_RTOL / FT_ATOL with TF32 off (the autoencoder by its codes and
    reconstructions); (d) save -> load on the card keeps
    predict, predict_generative, reconstruct and generate bit for bit; (e)
    one epoch of each mode at 784 -> 500 -> 500 (mnist_like, 2000 rows,
    batch 20, 100 steps) timed with CUDA events, and the card's busy share
    over one up-down epoch from a torch.profiler trace. Returns the resident
    kernel's launches of the main path (the pretraining of c3, c4 and the
    CLI runs)."""
    import copy

    import numpy as np
    import torch

    from mdbn_tpu_torch import DBN, MDBN
    from mdbn_tpu_torch.config import DBNConfig, MDBNConfig, load_config
    from mdbn_tpu_torch.data.synthetic import mnist_like
    from mdbn_tpu_torch.ops import cd_epoch_cuda as K
    from mdbn_tpu_torch.ops import cd_epoch_resident_cuda as R
    from mdbn_tpu_torch.run import build_data

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the phase-2 trainers' matmuls must be full f32")
    t0 = time.perf_counter()
    launches, out = 0, {}
    # a process's first torch.optim.Adam imports its compile machinery (seconds
    # on the host): done here, outside the autoencoder's times
    torch.optim.Adam([torch.zeros(1, device=dev, requires_grad=True)])
    # (a) pretraining as committed, then each mode for FT_EPOCHS epochs
    exp3, exp4 = load_config(C3), load_config(C4)
    d3, y3, _ = build_data(exp3["data"])
    x3 = d3[exp3["modality"]]
    x4, y4, _ = build_data(exp4["data"])
    cases = {}
    for name, cls, cfg, x, y in (("c3", DBN, exp3["model"], x3, y3),
                                 ("c4", MDBN, exp4["model"], x4, y4)):
        zero_train_counts()
        t = time.perf_counter()
        model = cls(cfg, device=dev).train(x)
        pre_s = time.perf_counter() - t
        rbms = ([r for tw in model.towers.values() for r in tw.layers] + [model.joint]
                if cls is MDBN else model.layers)
        kernels = [K.select_kernel(r.cfg, R.device_limits(r.cfg, dev)) for r in rbms]
        counts = check_counts(f"{name}_pretrain", {k: kernels.count(k) for k in set(kernels)})
        launches += counts.get("cd_train_resident", 0)
        n_classes = int(np.max(y)) + 1
        cases[name] = (model, x, np.asarray(y), n_classes)
        row = {"pretrain_s": round(pre_s, 3), "launches": counts}
        for mode in FT_MODES:
            m = copy.deepcopy(model)
            if mode == "updown_labeled":  # its label top first, outside the time
                m.fit_label_top(x, y, n_classes, epochs=FT_EPOCHS)
            torch.cuda.synchronize()
            t = time.perf_counter()
            hist = _ft_mode(m, mode, x, y, n_classes, FT_EPOCHS)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t
            tensors = _ft_tensors(m)
            off = [k for k, v in tensors.items() if v.device.type != "cuda"]
            bad = [k for k, v in tensors.items() if not bool(torch.isfinite(v).all())]
            if off or bad:
                raise AssertionError(f"{name} {mode}: off the card {off}, not finite {bad}")
            if not hist[-1] < hist[0]:
                raise AssertionError(f"{name} {mode}: the loss did not fall: {hist}")
            rec = {"s_per_epoch": sec / FT_EPOCHS, "first": hist[0], "last": hist[-1],
                   "tensors_on_cuda": len(tensors)}
            if mode in ("classifier", "label_top", "updown_labeled"):
                pred = (m.predict(x) if mode == "classifier" else m.predict_generative(x))
                rec["train_accuracy"] = float((pred.cpu().numpy() == y[:len(pred)]).mean())
                if rec["train_accuracy"] < FT_ACC_MIN:
                    raise AssertionError(f"{name} {mode}: accuracy {rec}")
            row[mode] = rec
        out[name] = row
    # (b) two CLI runs with a finetune block
    cli = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ft_") as tmp:
        for name, path, spec in (
                ("c3_updown_labeled", C3, {"mode": "updown_labeled", "label_fraction": 0.3}),
                ("c4_classifier", C4, {"mode": "classifier"})):
            cfg_path = os.path.join(tmp, f"{name}.json")
            with open(cfg_path, "w") as f:
                json.dump(dict(json.load(open(path)), finetune=spec), f)
            zero_train_counts()
            t = time.perf_counter()
            recs = _cli(["--config", cfg_path])
            counts = train_counts()
            launches += counts["cd_train_resident"]
            (ft,) = [r for r in recs if r["kind"] == "finetune"]
            accs = [ft.get("train_accuracy", 0.0)] + (
                [ft["accuracy_unlabeled"]] if spec["mode"] == "updown_labeled" else [])
            if ft["mode"] != spec["mode"] or min(accs) < FT_ACC_MIN:
                raise AssertionError(f"{name}: finetune record {ft}")
            cli[name] = {"seconds": round(time.perf_counter() - t, 3), "launches": counts,
                         "record": ft}
    # (c) the first epoch of each mode on the card against the CPU, same draws
    errs, off = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ftsave_") as tmp:
        for name, (model, x, y, n_classes) in cases.items():
            path = os.path.join(tmp, name)
            model.save(path)
            cls = type(model)
            for mode in FT_MODES:
                cpu, gpu = cls.load(path, device="cpu"), cls.load(path, device=dev)
                draws = _ft_draws(mode, len(y) // 20)  # c3's and c4's batch: 20
                hc = _ft_mode(cpu, mode, x, y, n_classes, 1, draws=draws)
                hg = _ft_mode(gpu, mode, x, y, n_classes, 1, draws=draws)
                tc, tg = _ft_tensors(cpu), _ft_tensors(gpu)
                if sorted(tc) != sorted(tg):
                    raise AssertionError(f"{name} {mode}: {sorted(tc)} vs {sorted(tg)}")
                worst = max(float((tg[k].cpu() - tc[k]).abs().max()) for k in tc)
                if mode == "autoencoder":
                    # Adam divides each gradient by its own root mean square, so a
                    # weight whose gradient is at rounding level (a hidden unit off
                    # for every row) moves by up to lr either way on two devices;
                    # the autoencoder is held by what it computes, its codes and
                    # reconstructions, and the weights' spread is reported
                    off[f"{name}_{mode}"] = sum(int((~torch.isclose(
                        tg[k].cpu(), tc[k], rtol=FT_RTOL, atol=FT_ATOL)).sum()) for k in tc)
                    tc = {"transform": cpu.transform(x), "reconstruct": cpu.reconstruct(x)}
                    tg = {"transform": gpu.transform(x), "reconstruct": gpu.reconstruct(x)}
                    tc, tg = ({f"{k}/{m}": v for k, d in t.items()
                               for m, v in (d.items() if isinstance(d, dict) else [("", d)])}
                              for t in (tc, tg))
                for k in tc:
                    torch.testing.assert_close(tg[k].cpu(), tc[k], rtol=FT_RTOL, atol=FT_ATOL,
                                               msg=lambda m, k=k: f"{name} {mode} {k}: {m}")
                torch.testing.assert_close(torch.tensor(hg), torch.tensor(hc), rtol=FT_RTOL,
                                           atol=FT_ATOL)
                errs[f"{name}_{mode}"] = worst
        # (d) save -> load on the card: the same outputs, bit for bit
        for name, (model, x, y, n_classes) in cases.items():
            m = copy.deepcopy(model)
            for mode in ("classifier", "autoencoder", "updown_labeled"):
                _ft_mode(m, mode, x, y, n_classes, 2)
            path = os.path.join(tmp, f"{name}_tuned")
            m.save(path)
            back = type(m).load(path, device=dev)
            outs = lambda mm: {"predict": mm.predict(x),  # noqa: E731
                               "predict_generative": mm.predict_generative(x),
                               "reconstruct": mm.reconstruct(x),
                               "generate": mm.generate(n_samples=8, n_gibbs=20, seed=3)}
            a, b = outs(m), outs(back)
            for k in a:
                pairs = ([(a[k][t], b[k][t]) for t in a[k]] if isinstance(a[k], dict)
                         else [(a[k], b[k])])
                if not all(torch.equal(aa, bb) for aa, bb in pairs):
                    raise AssertionError(f"{name}: save -> load changed {k}")
    # (e) one epoch of each mode at 784 -> 500 -> 500, and the busy share
    data = mnist_like(2000, seed=0, return_labels=True)
    xm, ym = data[0], np.asarray(data[1])
    cm = int(ym.max()) + 1
    big = DBN(DBNConfig(layer_sizes=[500, 500], epochs=2, lr=0.1, batch_size=20, seed=0),
              device=dev).train(xm)
    timing = {}
    for mode in FT_MODES:
        m = copy.deepcopy(big)
        if mode == "updown_labeled":
            m.fit_label_top(xm, ym, cm, epochs=1)  # timed below: labeled up-down alone
        timing[mode] = {"ms_per_epoch": time_runs(
            lambda m=m, mode=mode: _ft_mode(m, mode, xm, ym, cm, 1), 3) * 1e3}
    m = copy.deepcopy(big)
    m.finetune_updown(xm, epochs=1)
    timing["updown_profiled"] = busy_share(lambda: m.finetune_updown(xm, epochs=1))
    phase("finetune", epochs=FT_EPOCHS, runs=out, cli=cli, card_vs_cpu_max_abs_err=errs,
          autoencoder_weights_past_tolerance=off, rtol=FT_RTOL, atol=FT_ATOL, save_load_identical_bits=True,
          timing_784_500_500=timing, seconds=round(time.perf_counter() - t0, 3),
          nvidia_smi=smi)
    return launches


def _t_interval(xs) -> tuple:
    """The 95% t-interval of the mean of five values (t(0.975, 4) = 2.776)."""
    import numpy as np

    xs = np.asarray(xs, np.float64)
    half = 2.776 * xs.std(ddof=1) / np.sqrt(len(xs))
    return float(xs.mean() - half), float(xs.mean() + half)


def run_ais_phase(dev, smi) -> int:
    """The ais phase (28): AIS on the card, eager PyTorch (the reference has
    no kernel here). (a) c1, c2 and c3 trained as committed (their layers on
    the kernel select_kernel names, by the counters); (b) through the API at
    their full widths: c1's log-likelihood at the CLI's defaults (1,000 rows,
    256 chains, 1,000 betas, 1 sweep, uniform) and its bracket (resample
    init, resample_ess 0.5), c2's log-likelihood, c3's DBN bound, and after
    labeled up-down (FT_EPOCHS of the label top, then of up-down) its labeled
    bound: every value finite, every anneal tensor and recorded draw on the
    card; (c) the anneals (plain, SMC, Gaussian, labeled) at 10 betas under
    torch.cuda.set_sync_debug_mode("error"): no synchronising call; (d) the
    card against the CPU at c1's width, 32 chains, 100 betas: the card's
    draws recorded and replayed on the CPU (TF32 off), the chains whose
    final states agree held at AIS_CARD_RTOL, log Z too where none parted,
    and over five seeds each on its own generator the card's and the CPU's
    95% t-intervals overlapping; (e) 12x8 against exact enumeration; (f) c1's
    default anneal, plain and SMC, timed with CUDA events, and the card's
    busy share over one anneal from a torch.profiler trace; (g) the CLI's ais
    block: c1 (then under --load), c3, c3 after labeled up-down (then under
    --load); (h) one training with runtime profile on writes its trace.
    Returns the resident kernel's launches (the pretraining and the CLI
    runs)."""
    import copy

    import numpy as np
    import torch

    from mdbn_tpu_torch import DBN, RBM
    from mdbn_tpu_torch.analysis import ais as A
    from mdbn_tpu_torch.config import TrainRuntimeConfig, load_config
    from mdbn_tpu_torch.convert import params_from_numpy
    from mdbn_tpu_torch.ops import cd_epoch_cuda as K
    from mdbn_tpu_torch.ops import cd_epoch_resident_cuda as R
    from mdbn_tpu_torch.run import build_data

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the anneal's matmuls must be full f32")
    t0 = time.perf_counter()
    launches, runs = 0, {}
    # (a) c1, c2, c3 as committed
    models = {}
    for name, path, cls in (("c1", C1, RBM), ("c2", C2, RBM), ("c3", C3, DBN)):
        exp = load_config(path)
        x, y, _ = build_data(exp["data"])
        x = x[exp["modality"]] if "modality" in exp else x
        zero_train_counts()
        t = time.perf_counter()
        model = cls(exp["model"], device=dev).train(x)
        rbms = model.layers if cls is DBN else [model]
        kernels = [K.select_kernel(r.cfg, R.device_limits(r.cfg, dev)) for r in rbms]
        counts = check_counts(f"{name}_pretrain", {k: kernels.count(k) for k in set(kernels)})
        launches += counts.get("cd_train_resident", 0)
        models[name] = (model, x, None if y is None else np.asarray(y))
        runs[name] = {"pretrain_s": round(time.perf_counter() - t, 3), "launches": counts}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, round(time.perf_counter() - t, 3)

    # (b) the API at full width
    c1, x1, _ = models["c1"]
    c2, x2, _ = models["c2"]
    c3, x3, y3 = models["c3"]
    x1k = x1[:1000]
    api = {}
    api["c1_log_likelihood"] = timed(lambda: A.log_likelihood(c1.params, c1.cfg, x1k))
    api["c1_bracket_smc"] = timed(lambda: A.log_z_bracket(c1.params, c1.cfg, x1k,
                                                          init="resample", resample_ess=0.5))
    api["c2_log_likelihood"] = timed(lambda: A.log_likelihood(c2.params, c2.cfg, x2))
    stack = [(r.params, r.cfg) for r in c3.layers]
    api["c3_dbn_bound"] = timed(lambda: A.dbn_log_likelihood_bound(stack, x3))
    lab = copy.deepcopy(c3)
    n_classes = int(y3.max()) + 1
    lab.fit_label_top(x3, y3, n_classes, epochs=FT_EPOCHS)
    lab.finetune_updown_labeled(x3, y3, epochs=FT_EPOCHS)
    top, C = lab._label_top
    lab_stack = [(r.params, r.cfg) for r in lab.layers]
    api["c3_labeled_bound"] = timed(lambda: A.labeled_dbn_log_likelihood_bound(
        lab_stack, top, C, x3, gen=lab._gen))
    for name, (rec, sec) in api.items():
        if not all(np.isfinite(v) for v in rec.values()):
            raise AssertionError(f"ais {name}: not finite: {rec}")
        api[name] = {"seconds": sec, **rec}
    # placement: every anneal tensor and every recorded draw on the card
    a1 = A.base_rate_biases(torch.as_tensor(x1k, device=dev))
    draws = {}
    out = A._ais_forward_bernoulli(c1.params, a1, 32, 20, 1, "uniform", 0.5,
                                   generator=torch.Generator(device=dev).manual_seed(0),
                                   draws=draws)
    placed = list(out) + [draws["init"]] + [u for st in draws["steps"] for u in st.values()]
    off = [tuple(t.shape) for t in placed if t.device.type != "cuda"]
    if off or a1.device.type != "cuda":
        raise AssertionError(f"ais: anneal tensors off the card: {off}")
    # (c) no synchronising call inside the anneal
    b2 = torch.as_tensor(x2, device=dev).mean(0)
    a_lab = torch.cat([A.base_rate_biases(torch.rand(50, top.W.shape[0] - C, device=dev)),
                       torch.zeros(C, device=dev)])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for ess in (0.0, 0.5):
            A.ais_log_z(c1.params, a1, 0, 256, 10, resample_ess=ess)
            A.ais_log_z_gaussian(c2.params, b2, 0, 256, 10, resample_ess=ess)
        A.ais_log_z_labeled(top, a_lab, top.W.shape[0] - C, 0, 256, 10)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    # (d) the card against the CPU at c1's width
    draws = {}
    lz_g, lw_g, v_g, _ = A._ais_forward_bernoulli(
        c1.params, a1, 32, 100, 1, "uniform", generator=torch.Generator(device=dev).manual_seed(5),
        draws=draws)
    cpu_params = c1.params.map(lambda t: t.cpu())
    lz_c, lw_c, v_c, _ = A._ais_forward_bernoulli(cpu_params, a1.cpu(), 32, 100, 1, "uniform",
                                                  generator=None, draws=draws)
    agree = (v_g.cpu() == v_c).all(dim=1)
    parted = int((~agree).sum())
    if parted > 3:
        raise AssertionError(f"ais card vs CPU: {parted} of 32 chains parted")
    torch.testing.assert_close(lw_g.cpu()[agree], lw_c[agree], rtol=AIS_CARD_RTOL,
                               atol=AIS_CARD_RTOL)
    if parted == 0 and abs(float(lz_g) - float(lz_c)) > AIS_CARD_RTOL * abs(float(lz_c)):
        raise AssertionError(f"ais card vs CPU: log Z {float(lz_g)} vs {float(lz_c)}")
    seeds = {"cuda": [], "cpu": []}
    for seed in range(5):
        seeds["cuda"].append(float(A.ais_log_z(c1.params, a1, seed, 32, 100)[0]))
        seeds["cpu"].append(float(A.ais_log_z(cpu_params, a1.cpu(), seed, 32, 100)[0]))
    ci = {k: _t_interval(v) for k, v in seeds.items()}
    if ci["cuda"][0] > ci["cpu"][1] or ci["cpu"][0] > ci["cuda"][1]:
        raise AssertionError(f"ais card vs CPU: the 95% t-intervals do not overlap: {ci}")
    card_vs_cpu = {"chains": 32, "betas": 100, "chains_parted": parted,
                   "log_z_card": float(lz_g), "log_z_cpu": float(lz_c),
                   "logw_max_abs_err_agreeing": float((lw_g.cpu() - lw_c)[agree].abs().max()),
                   "rtol": AIS_CARD_RTOL, "log_z_5_seeds": seeds, "t_intervals_95": ci}
    # (e) against exact enumeration at 12x8
    rng = np.random.default_rng(0)
    small = params_from_numpy({"W": (rng.standard_normal((12, 8)) * 0.5).astype(np.float32),
                               "b": (rng.standard_normal(12) * 0.2).astype(np.float32),
                               "c": (rng.standard_normal(8) * 0.2).astype(np.float32)},
                              device=dev)
    exact = A.exact_log_z(small)
    est = float(A.ais_log_z(small, torch.zeros(12, device=dev), 1, 256, 2000)[0])
    if abs(est - exact) >= AIS_EXACT_TOL:
        raise AssertionError(f"ais 12x8: {est} vs exact {exact}")
    # (f) c1's default anneal timed, plain and SMC; the busy share
    timing = {}
    for name, ess in (("plain", 0.0), ("smc_0.5", 0.5)):
        fn = lambda ess=ess: A.ais_log_z(c1.params, a1, 0, 256, 1000, resample_ess=ess)  # noqa: E731
        timing[name] = {"ms": time_runs(fn, 2) * 1e3, "n_resamples": int(
            A._ais_forward_bernoulli(c1.params, a1, 256, 1000, 1, "uniform", ess,
                                     generator=torch.Generator(device=dev).manual_seed(0))[3])}
    timing["plain_profiled"] = busy_share(lambda: A.ais_log_z(c1.params, a1, 0, 256, 1000),
                                          timing["plain"]["ms"])
    # (g) the CLI's ais block
    cli = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ais_") as tmp:
        for name, path, extra, argv in (
                ("c1", C1, {}, ["--save", os.path.join(tmp, "c1")]),
                ("c1_load", C1, {}, ["--load", os.path.join(tmp, "c1")]),
                ("c3", C3, {}, []),
                ("c3_updown_labeled", C3, {"finetune": {"mode": "updown_labeled"}},
                 ["--save", os.path.join(tmp, "c3l")]),
                ("c3_labeled_load", C3, {}, ["--load", os.path.join(tmp, "c3l")])):
            cfg_path = os.path.join(tmp, f"{name}.json")
            with open(cfg_path, "w") as f:
                json.dump(dict(json.load(open(path)), analysis={"ais": True}, **extra), f)
            zero_train_counts()
            t = time.perf_counter()
            recs = _cli(["--config", cfg_path] + argv)
            counts = train_counts()
            launches += counts["cd_train_resident"]
            (rec,) = [r for r in recs if r["kind"] == "ais"]
            keys = ({"log_z", "mean_log_likelihood", "logw_std"} if name.startswith("c1")
                    else {"log_z_top", "mean_log_likelihood_bound", "logw_std", "mc_std"})
            if set(rec) != {"kind", "n_rows"} | keys or not all(
                    np.isfinite(rec[k]) for k in keys):
                raise AssertionError(f"ais CLI {name}: record {rec}")
            cli[name] = {"seconds": round(time.perf_counter() - t, 3), "launches": counts,
                         "record": rec}
        # (h) a training run traced by torch.profiler
        prof_dir = os.path.join(tmp, "profile")
        zero_train_counts()
        RBM(c1.cfg.replace(epochs=1), device=dev).train(
            x1, runtime=TrainRuntimeConfig(profile=True, profile_dir=prof_dir))
        launches += train_counts()["cd_train_resident"]
        traces = [f for f in os.listdir(prof_dir) if f.endswith(".pt.trace.json")]
        with open(os.path.join(prof_dir, traces[0])) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        if len(traces) != 1 or not any("cd_train" in k for k in kernels):
            raise AssertionError(f"profile: traces {traces}, kernels {sorted(set(kernels))}")
        profile_trace = {"files": len(traces), "events": len(events),
                         "kernel_events": len(kernels)}
    phase("ais", runs=runs, api=api, sync_debug_mode="error: no synchronising call at 10 betas",
          card_vs_cpu=card_vs_cpu, exact_12x8={"ais": est, "exact": exact, "tol": AIS_EXACT_TOL},
          timing_c1_default_anneal=timing, cli=cli, profile_trace=profile_trace,
          seconds=round(time.perf_counter() - t0, 3), nvidia_smi=smi)
    return launches


def run_k300(dev, smi) -> None:
    """The k300 phase: every kernel source at k = 300 against its plain
    version on hardened injected draws (2 updates at c4's GE second layer,
    400x100; the wide kernels called directly at 2000x100, as the admission
    rule does not pick them there; the DP kernels one step on a 7-row shard
    with a pad row), with the largest difference of each; then
    RBM.train(engine="pallas") at k = 300 launches the kernel select_kernel
    names."""
    import numpy as np
    import torch

    from mdbn_tpu_torch import RBM
    from mdbn_tpu_torch.config import RBMConfig
    from mdbn_tpu_torch.core.rbm_math import RBMParams
    from mdbn_tpu_torch.ops import cd_epoch_cuda as K
    from mdbn_tpu_torch.ops import cd_epoch_resident_cuda as R
    from mdbn_tpu_torch.ops import cd_grads_cuda as G
    from mdbn_tpu_torch.ops import cd_grads_wide_cuda as W
    from mdbn_tpu_torch.ops.cd_step import draw_uniforms
    from mdbn_tpu_torch.parallel.dp import world_scale

    t0 = time.perf_counter()
    base = RBMConfig(n_visible=400, n_hidden=100, batch_size=20, k=K300, lr=0.05)
    wide = RBMConfig(n_visible=2000, n_hidden=100, batch_size=20, k=K300, lr=0.005,
                     visible="gaussian", sample_visible=False)
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = lambda cfg: (torch.rand((40, cfg.n_visible), generator=gen, device=dev) < 0.3).float() \
        if cfg.visible == "bernoulli" else torch.randn((40, cfg.n_visible), generator=gen,
                                                        device=dev)
    runs = {"cd_train": (base.replace(persistent=True, momentum=0.5), False, None, False),
            "cd_train_resident": (base, False, 0, False),
            "cd_train_resident_modes[enhanced]": (base.replace(gradient="enhanced"), False, 0,
                                                  False),
            "cd_train_resident_ladder[pt3]": (base.replace(persistent=True, pt_temps=3,
                                                           pt_beta_min=0.3), False, 0, False),
            "cd_train_wide": (wide, True, None, False),
            "cd_train_wide_modes[lv]": (wide.replace(learn_variance=True), False, None, True)}
    errs = {}
    for name, (cfg, is_wide, clusters, modes) in runs.items():
        errs[name] = compare_run(cfg, rows(cfg), 1, dev, seed=7, wide=is_wide,
                                 clusters=clusters, modes=modes)
    # the DP kernels: cd_grads.cu's step and update, cd_grads_wide.cu's step
    shard = base.replace(batch_size=7, persistent=True)
    p, vel, chain = _grads_state(shard, dev, seed=8)
    v0 = rows(shard)[:7]
    v0[-1] = 0.0
    mask = torch.ones((7, 1), device=dev)
    mask[-1] = 0.0
    u = G.harden_step(shard, p, chain, v0, draw_uniforms(shard, 7, gen))
    got = G.cd_grads_step(shard, p, v0, chain, uniforms=u, mask=mask, norm=20 / 3)
    want = G.cd_grads_step_plain(shard, p, v0, chain, uniforms=u, mask=mask, norm=20 / 3)
    for a, b in zip((got[0].W, got[0].b, got[0].c, got[2]), (want[0].W, want[0].b, want[0].c,
                                                             want[2])):
        torch.testing.assert_close(a, b, rtol=REPLAY_RTOL, atol=REPLAY_ATOL)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    errs["cd_grads[step]"] = max(float((a - b).abs().max()) for a, b in zip(
        (got[0].W, got[0].b, got[0].c, got[2]), (want[0].W, want[0].b, want[0].c, want[2])))
    rand = lambda *shape: 0.1 * torch.randn(shape, generator=gen, device=dev)
    V, H = base.n_visible, base.n_hidden
    sp, sv = (RBMParams(W=rand(V, H), b=rand(V), c=rand(H)) for _ in range(2))
    sums = 3 * rand(G.flat_size(shard))
    want = G.cd_update_plain(shard, sp, sv, sums, world_scale(3), 0)
    got = G.cd_update(shard, sp.map(torch.clone), sv.map(torch.clone), sums, world_scale(3), 0)
    if not all(torch.equal(a, b) for a, b in zip(
            [*got[0].as_dict().values(), *got[1].as_dict().values()],
            [*want[0].as_dict().values(), *want[1].as_dict().values()])):
        raise AssertionError("cd_grads.cu's update at k = 300 is not its plain version's bits")
    errs["cd_grads[update]"] = 0.0
    wshard = wide.replace(batch_size=7)
    wp, _, wchain = _grads_state(wshard, dev, seed=9)
    wv0 = rows(wshard)[:7]
    wv0[6:] = 0.0
    wu = G.harden_step(wshard, wp, wchain, wv0, draw_uniforms(wshard, 7, gen), wide=True)
    got = W.cd_wide_step(wshard, wp, wv0, wchain, uniforms=wu, n_valid=6, norm=20 / 3)
    want = W.cd_wide_step_plain(wshard, wp, wv0, wchain, uniforms=wu, n_valid=6, norm=20 / 3)
    for a, b in zip(W.slot_views(wshard, got[0]), W.slot_views(wshard, want[0])):
        torch.testing.assert_close(a, b, rtol=REPLAY_RTOL, atol=REPLAY_ATOL)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    errs["cd_grads_wide[step]"] = max(float((a - b).abs().max()) for a, b in zip(
        W.slot_views(wshard, got[0]), W.slot_views(wshard, want[0])))
    # the entry point: RBM.train on the kernel select_kernel names
    cfg = base.replace(epochs=2, engine="pallas")
    kernel = K.select_kernel(cfg, R.device_limits(cfg, dev))
    data = rows(cfg)
    zero_train_counts()
    rbm = RBM(cfg, device=dev).train(torch.cat([data] * 5))
    counts = check_counts("k300_train", {kernel: 1})
    if rbm.metrics.kernel != kernel or not all(np.isfinite(rbm.history)):
        raise AssertionError(f"k = 300 through RBM.train: kernel {rbm.metrics.kernel}, "
                             f"errors {rbm.history}")
    phase("k300", k=K300, max_abs_err=errs, run_rtol=RTOL, run_atol=ATOL,
          step_rtol=REPLAY_RTOL, step_atol=REPLAY_ATOL, train_kernel=kernel,
          train_launches=counts, train_errors=rbm.history,
          seconds=round(time.perf_counter() - t0, 3), nvidia_smi=smi)


def run() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "mdbn_tpu_torch")) or not os.path.exists(C1):
        print("chip_smoke: run it from a checkout of the repository "
              "(mdbn_tpu_torch/ and configs/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from mdbn_tpu_torch import MDBN, RBM
    from mdbn_tpu_torch._build import build_all
    from mdbn_tpu_torch.config import load_config
    from mdbn_tpu_torch.data.synthetic import mnist_like, tcga_like
    from mdbn_tpu_torch.ops import cd_epoch_cuda as K
    from mdbn_tpu_torch.ops import cd_epoch_resident_cuda as R
    from mdbn_tpu_torch.core.state import init_train_state
    from mdbn_tpu_torch.run import build_data

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    libs = build_all()  # one nvcc per kernel and storage dtype, all at once
    phase("device", torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=smi,
          kind=torch.cuda.get_device_name(0), build_s=round(time.perf_counter() - t0, 3),
          nvcc_s={f"{k}_{dt}": round(lib.seconds, 3) for (k, dt), lib in libs.items()},
          ptxas={f"{k}_{dt}": ptxas_summary(lib.log) for (k, dt), lib in libs.items()})

    # 2. kernel against its plain version
    c1 = load_config(C1)["model"]
    c1_data = torch.as_tensor(mnist_like(2000, seed=2), device=dev)
    err_c1 = compare_run(c1, c1_data, 2, dev, seed=0)
    c5_tower = load_config(C2)["model"].replace(k=2, persistent=True, momentum=0.5, l2=1e-4)
    ge = torch.as_tensor(tcga_like(400, seed=1)[0]["ge"], device=dev)
    err_c5 = compare_replay(c5_tower, ge, 2, dev, seed=1)
    max_err = max(err_c1, err_c5)
    phase("kernel_vs_plain", c1_run_max_abs_err=err_c1, c1_rtol=RTOL, c1_atol=ATOL,
          c5_tower_replay_max_abs_err=err_c5, c5_rtol=REPLAY_RTOL, c5_atol=REPLAY_ATOL)

    # 3 + 4. the main path through the normal entry points; count the launches
    # of the kernel select_kernel names for each layer (the resident kernel)
    c1_cfg = c1.replace(epochs=10, engine="pallas")
    c1_kernel = K.select_kernel(c1_cfg, R.device_limits(c1_cfg, dev))
    c1_train, _, _ = build_data(load_config(C1)["data"])
    zero_train_counts()
    t0 = time.perf_counter()
    rbm = RBM(c1_cfg, device=dev).train(c1_train)
    c1_s = time.perf_counter() - t0
    c1_counts = check_counts("c1", {c1_kernel: 1})
    c1_launches = c1_counts[c1_kernel]
    final = rbm.history[-1]
    codes = rbm.transform(c1_train)
    if rbm.metrics.engine != "cuda" or rbm.metrics.kernel != c1_kernel:
        raise AssertionError(f"c1 did not run on {c1_kernel}: engine {rbm.metrics.engine}, "
                             f"kernel {rbm.metrics.kernel}")
    if abs(final - C1_FINAL_ERR) > C1_ERR_TOL:
        raise AssertionError(f"c1 final error {final} not within {C1_ERR_TOL} of {C1_FINAL_ERR}")
    if codes.shape != (2000, 500) or not bool(torch.isfinite(codes).all()):
        raise AssertionError("c1 codes are not finite [2000, 500]")
    phase("c1_rbm_train", engine=rbm.metrics.engine, kernel=c1_kernel, launches=c1_counts,
          first_err=rbm.history[0], final_err=final, seconds=round(c1_s, 3))

    exp4 = load_config(C4)
    m4 = exp4["model"]
    m4 = dataclasses.replace(m4, towers={k: dataclasses.replace(t, engine="pallas")
                                         for k, t in m4.towers.items()},
                             joint=m4.joint.replace(engine="pallas"))
    mods, _, _ = build_data(exp4["data"])
    zero_train_counts()
    t0 = time.perf_counter()
    mdbn = MDBN(m4, device=dev).train(mods)
    c4_s = time.perf_counter() - t0
    n_layers = sum(len(t.layer_sizes) for t in m4.towers.values()) + 1
    layers = [r for t in mdbn.towers.values() for r in t.layers] + [mdbn.joint]
    c4_kernels = [K.select_kernel(r.cfg, R.device_limits(r.cfg, dev)) for r in layers]
    c4_counts = check_counts("c4", {k: c4_kernels.count(k) for k in set(c4_kernels)})
    c4_launches = c4_counts["cd_train_resident"]
    if (len(layers) != n_layers or any(r.metrics.engine != "cuda" for r in layers)
            or [r.metrics.kernel for r in layers] != c4_kernels):
        raise AssertionError(f"c4: layers ran on {[r.metrics.kernel for r in layers]}, "
                             f"select_kernel gives {c4_kernels}")
    z = mdbn.transform(mods)
    if z.shape != (400, 100) or not bool(torch.isfinite(z).all()):
        raise AssertionError(f"c4 codes: shape {tuple(z.shape)} or not finite")
    for r in layers:
        if not r.history[-1] < r.history[0]:
            raise AssertionError(f"c4 layer error did not fall: {r.history}")
    phase("c4_mdbn_train", kernels=c4_kernels, launches=c4_counts, layers=n_layers,
          seconds=round(c4_s, 3),
          errors={name: [[h[0], h[-1]] for h in hist] if name != "joint" else [hist[0], hist[-1]]
                  for name, hist in mdbn.history.items()})
    # 25-26. the CLI's analysis path (c5, imputation and consensus on its
    # saved model, the real-data configs on fixtures), then k = 300
    cli_launches = run_analysis_cli(smi)
    run_k300(dev, smi)
    # 27. the phase-2 trainers (their pretraining on the resident kernel)
    ft_launches = run_finetune_phase(dev, smi)
    # 28. AIS after training (its pretraining on the resident kernel)
    ais_launches = run_ais_phase(dev, smi)
    resident_main = (c1_counts["cd_train_resident"] + c4_counts["cd_train_resident"]
                     + cli_launches + ft_launches + ais_launches)

    # 5. timing at c1's shape: one epoch (100 updates) per call
    st = init_train_state(c1, device=dev)
    nb = c1_data.shape[0] // c1.batch_size
    order = K.batch_order(c1, nb, 1, None)
    gen = torch.Generator().manual_seed(0)

    def kernel():  # cd_train.cu, called directly
        K.cd_train_run(c1, st.params, st.velocity, st.chain_h, c1_data, order, 0, None, gen,
                       wide=False)

    def plain():
        K.cd_train_run_plain(c1, st.params, st.velocity, st.chain_h, c1_data, order, 0,
                             None, gen)

    t_plain1 = time_runs(plain, 3)
    t_kernel1 = time_runs(kernel, 20)
    t_kernel2 = time_runs(kernel, 20)
    t_plain2 = time_runs(plain, 3)
    t_kernel, t_plain = min(t_kernel1, t_kernel2), min(t_plain1, t_plain2)
    # where one update's time goes: the kernel's own per-phase clock stamps
    trace = torch.zeros((1, nb, 3 + 2 * c1.k), dtype=torch.int64, device=dev)
    K.cd_train_run(c1, st.params, st.velocity, st.chain_h, c1_data, order, 0, None, gen,
                   trace=trace, wide=False)
    torch.cuda.synchronize()
    spans = (trace[0, :, 1:] - trace[0, :, :-1]).double().median(0).values / 1e3
    phase("timing_c1", updates_per_run=nb, kernel_ms=t_kernel * 1e3, plain_ms=t_plain * 1e3,
          kernel_updates_per_s=nb / t_kernel, plain_updates_per_s=nb / t_plain,
          order="plain, kernel, kernel, plain", nvidia_smi=smi,
          kernel_phase_us_median=dict(zip(["hidden_from_data", "visible", "hidden",
                                           "update_and_monitor"], spans.tolist())))

    bound_ms, bound_by = bound(c1, nb, torch.cuda.get_device_properties(dev).L2_cache_size)
    resident_entries = run_resident(dev, smi, c1, c1_data, ge, resident_main)
    mode_entries = run_modes(dev, smi, c1, c1_data, ge)
    wide_entries = run_wide(dev, smi)
    # cd_train.cu's launches on the main path: the runs through RBM.train
    # that take it (phases 7 and 10); c1, c4 and the narrow estimator modes
    # take the resident kernel, the wide rows the W-blocked and modes kernels
    modes_main = sum(e["launches"] for e in mode_entries + wide_entries
                     if e["source"].endswith("/cd_train.cu"))
    entries = [{
        "name": "cd_train", "route": "cuda", "source": "mdbn_tpu_torch/csrc/cd_train.cu",
        "replaces": "mdbn_tpu/ops/cd_epoch_pallas.py:692", "launches": modes_main,
        "max_abs_err": max_err, "ms": t_kernel * 1e3, "plain_ms": t_plain * 1e3,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "ms_per": f"one epoch at c1's shape ({nb} updates), called directly; launches: "
                  "its runs through the API on the main path"}]
    entries += resident_entries + mode_entries + wide_entries
    grads = run_grads(dev, smi, c1, c1_data, ge)
    update_err, update_t = run_update(dev, smi, c1)
    dp_launches = run_dp(dev, smi, c1, t_kernel * 1e3)
    dp_mode_entries = run_dp_modes(dev, smi, c1, c1_data, ge)
    # c1's step on the route dp_world1 takes (the step variant; cd_grads.cu's
    # own entry is pt3_lv's, the mode on its route, below)
    grads_err, grads_t = grads["cd_grads_resident"]
    entries.append({
        "name": "cd_grads_resident", "route": "cuda",
        "source": "mdbn_tpu_torch/csrc/cd_train_resident.cu",
        "replaces": "mdbn_tpu/ops/cd_epoch_pallas.py:3184",
        "launches": dp_launches["cd_grads_resident"],
        "max_abs_err": grads_err, "ms": grads_t["kernel_device_us"] / 1e3,
        "plain_ms": grads_t["plain_us"] / 1e3, "bound_ms": grads_t["bound_us"] / 1e3,
        "bound_by": grads_t["bound_by"], "library_ms": None,
        "ms_per": "one step at c1's shape (784x500, batch 20, CD-1); cd_grads.cu's "
                  f"{grads['cd_grads'][1]['kernel_device_us'] / 1e3} ms in the same run"})
    entries.append({
        "name": "cd_dp_update", "route": "cuda", "source": "mdbn_tpu_torch/csrc/cd_grads.cu",
        "replaces": "mdbn_tpu/ops/cd_epoch_pallas.py:3039",
        "launches": dp_launches["cd_dp_update"],
        "max_abs_err": update_err, "ms": update_t["kernel_device_us"] / 1e3,
        "plain_ms": update_t["plain_us"] / 1e3, "bound_ms": update_t["bound_us"] / 1e3,
        "bound_by": update_t["bound_by"], "library_ms": update_t["library_device_us"] / 1e3,
        "ms_per": "one update after the all-reduce at c1's shape (784x500, the DP "
                  "mega-kernel's update, its exchange an NCCL all-reduce between launches)"})
    entries += dp_mode_entries
    # 29. the dp x tp mesh: the tensor-parallel route (no kernel of its own)
    run_dp_tp(dev, smi, c1)
    phase("device_timing", method="torch.profiler", profiler_tries=PROFILER_TRIES,
          timed_by_queued_events=PROFILER_MISSES, events_short=PROFILER_SHORT)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    try:
        return run()
    except ImportError as e:
        print(f"chip_smoke: {e} (needs torch and a checkout of the repository)",
              file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
