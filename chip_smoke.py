#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``sequential_monte_carlo_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each or more; any failure raises and exits non-zero:
  1. device  — a CUDA device is required (no CPU fallback); prints the card's
     name and power limit as nvidia-smi reports them;
  2. build   — compiles the CUDA kernels from the package's csrc/ with nvcc;
  3. K1      — the systematic resample + gather kernel against its plain
     version at 512×1024, 512×8192 and 512×1000, and at 256×1024 and
     256×8192 (a θ-shard's rows), under flat, skewed and point-mass
     weights, on C=3 normal planes and on the auxiliary filter's
     clouds with the lookahead plane (UC-SV C=4, LG C=2; also its
     first-stage weights; no ancestor may differ);
  4. K2      — the fused propagate + reweight + normalize kernel, UC-SV
     instance, against its plain version at the same shapes, and the
     moments of the normals recovered from its state deltas; rows 256.. of
     each 512-row call equal the 256-row call at row_offset 256 (the
     θ-sharded filter's rows);
  5. K3      — the sorted-grid resample + gather kernel against its plain
     version on stratified grids at 512×1024 (C=1), 512×8192 (C=3),
     512×1000 (C=1, a shape the TPU walk cannot tile) and 256×8192 (C=3, a
     θ-shard's rows), flat, skewed and point-mass weights;
  6. K2 instances — LG dx=1, LG dx=1 with carried log-weights, LG dx=2 (a
     model with a non-singular Q, so that the normals can be recovered) and
     SV against the plain version at 512×1024 and 512×8192, and the moments
     of each instance's recovered normals;
  7. slice   — online SMC² on UC-SV at the benchmark's configuration
     (M=512, N=1024, T=241, chain=5), whose launch counts show that every
     inner filter step ran both kernels, and whose posterior mean is held
     against the JAX package's; then the 512×8192 run, timed once, whose
     launch counts are checked the same way;
  8. dt      — density-tempered SMC on the LG model at BASELINE config 4
     (M=512, N=1024, T=100, chain=3), (a) systematic inner filter at every
     step (K1 + K2-LG), (b) stratified inner filter triggered at ESS < N/2
     (K3 + K2-LG with carry): launch counts, and posterior means held
     against the JAX package's;
  9. filters — 512 parallel filters (BASELINE config 3): LG at θ* (K1 +
     K2-LG) and Hodrick–Prescott (K3 + K2-LG dx=2), whose log Z is held
     against the Kalman filter's, and SV (K1 + K2-SV), whose log Z is held
     against a point-mass grid filter's;
 10. K6      — the hand-written UC-SV propagate + reweight kernel against
     its plain version at 512×1024 and 512×8192, without and with the
     normalize, on the strided cloud view the auxiliary filter hands it: the
     moments of the normals recovered from its state deltas, its log-weights
     against the density at the returned state, the normalize against a
     torch normalize of the raw log-weights, γ = 0, the row_offset
     (θ-sharding) property raw and normalized (rows 256.. of each 512-row
     call equal the 256-row call at row_offset 256), and against K2's UC-SV
     instance at the same seed
     (within 1e-5; the line says per route whether bitwise), all four timed;
 11. K2 raw  — K2's route without the normalize, per instance (UC-SV, LG
     dx 1 and 2, SV), against the plain version, with the recovered normals'
     moments;
 12. K3 grids — the sorted-grid kernel on the systematic grid
     u = (i + u0)/N that K9's v7 builds in-kernel (512×8192, 0 ancestor
     mismatches) and at K8's and K9's tilings (512×2048, 512×4096): K3
     carries the ablation kernels K7–K9, which compute its function;
 13. apf     — the auxiliary particle filter: (a) SMC² on UC-SV at the
     benchmark's configuration (K1 + K6 at every inner step, no K2-UC-SV),
     posterior held against the JAX package's APF and bootstrap means; (b) the README's APF
     SMC² on LG (K1 + K2-LG raw), posterior against the JAX package's and
     log Z against the Kalman filter's; (c) 512 APF filters on LG at θ*
     (K1 + K2-LG raw), Hodrick–Prescott (K3 + K2-LG dx=2 raw) and SV (K1 +
     K2-SV raw), log Z against the exact, and 512 UC-SV filters, bootstrap
     (K1 + K2-UC-SV) and APF (K1 + K6), log Z against the JAX package's;
 14. exchange — online SMC² on UC-SV with the exchange step armed (M=512,
     N from 1024, T=241, chain=5, acc_threshold 1.1, exchange_max_n 4096):
     (a) "grow" through step + maybe_exchange (K1 + K2-UC-SV at N = 1024 …
     8192), (b) "full" padding (arrays 512×8192 from the init; K3 on the
     live-prefix grid + K6 raw, the dead tail at exactly −inf; replayed
     from the online and masked routes of each live count), (c)
     run_segmented with a collect_fn (captured into the replayed step, t and
     the pending flag device tensors): N doubling to 8192 and never above,
     launch counts equal to the schedule's, posteriors against the JAX
     package's bootstrap mean; (d) K3 on the elastic grid at 512×8192 against
     its plain version; walls per inner step printed, and of (a) and (b)
     again, warm, at seed 1;
 15. large_n — K1 and K3 at 64×65,536 (their large route) against their
     plain versions, timed; 64 LG filters at θ*, N=65,536, systematic (K1)
     and stratified at ESS < N/2 (K3), against the Kalman log Z, K2-LG on
     its split route; then k2_split — K2's split route at 64×65,536,
     1×65,536 and 3×40,000, with and without the carry, against the route
     without the normalize at the same seed (the new cloud bit for bit,
     log_norm, lse and ess within 1e-5 of the plain normalize), half the
     rows against a call on them alone bit for bit, a CUDA graph of the call
     replayed twice bit for bit the eager call, one ``_split`` launch a
     call;
 16. lg_dx  — K2's generated LG instances at dx = 3, 4, 5, normalized and
     raw, against their plain versions with the recovered normals' moments;
     512 filters of dx = 3, 4, 5 models (a local linear trend plus AR
     components), bootstrap (K1 + K2-lgX) and APF (K1 + K2-lgX raw), against
     the Kalman log Z;
 17. ibis   — IBIS (no kernel) on the dt phase's prior and series, M=512,
     chain=3, replayed (its online route, one flag read a step, and each
     rejuvenation's Kalman passes on the live route, their graph launches
     held against the count), against the exact prior-IS posterior mean;
 18. routes — 512 LG filters at θ*, N=1024, T=100, with the
     residual_systematic (K1), multinomial and residual inner schemes and a
     guided proposal (the transition widened 1.5-fold; K1, no propagate
     kernel), each against the Kalman log Z, each replayed from graphs
     (its graph launches held against the masked filter's count);
 19. one_row — the kernels at M = 1 (K1 C = 1, 3 and the APF's C = 2, 4;
     K3; K2 UC-SV, LG dx=1 with and without carry, LG dx=1 raw; K6 raw) at
     1×1024 and 1×8192, on a contiguous row, on unsqueezed and expanded
     views and on a cloud with stride 1 on its length-1 axes, against their
     plain versions, timed; then bank_shapes — the kernels at the banks'
     shapes of phases 21 and 22 (K1 C=3, K2-UC-SV and K6 at 8×8192, K2-LG
     normalized and raw at 8×128, K2-LG raw at 1×256), likewise;
 20. per_theta — the per-θ filters (the batched layer at one row):
     log_likelihood on LG at θ* (T=100, N=1024) systematic (K1 + K2-LG),
     stratified at ESS < N/2 (K3 + K2-LG carry) and the APF (K1 + K2-LG raw),
     32 runs each against the Kalman log Z; filter_sequence on UC-SV at
     N=8192 with a weighted_quantile summarize (K1 + K2-UC-SV at 1×8192)
     and apf_log_likelihood on UC-SV at N=1024 (K1 + K6), against the JAX
     package's log Z;
 21. smoothing — kalman_smooth and smoothed_marginals on LG at θ*
     (N=1024, dense) against RTS; smoothed_marginals on UC-SV at N=8192 at
     θ = JAX_MEAN (blocked) against the JAX package's smoothed means and
     log Z; posterior_smoothed_paths (n_theta=8, n_paths=64, N=8192) from
     the 512×8192 SMC² state, an 8-row bank through K1 + K2-UC-SV; walls
     and the backward passes' times;
 22. pg — particle Gibbs on UC-SV at benchmarks/bench_pg.py's configuration
     (T=241, N=8192, 50 sweeps, chain=3), "bs" and "as" (K6 at every CSMC
     step), acceptance and θ-chain mean against the JAX package's seeds, one
     chain through particle_gibbs and 8 as one bank, pooled; on LG at
     the JAX test's configuration (T=60, N=128, 400 sweeps, chain=3), 8
     chains as one bank, pooled against the Kalman prior-IS oracle; iterated
     CSMC (N=256, 120 sweeps, both methods) against RTS; graphed (one
     replay a PG or CSMC sweep, the initial multinomial bank on its store
     route), each line with its graph launches and the host syncs torch's
     sync debug mode reports;
 23. dsl — UC-SV written with the model DSL (ssm_model, no fused kernel: its
     propagate is plain tensor code) in online SMC² at the slice's
     configuration (K1 at every inner step of the schedule, no K2 or K6),
     posterior against JAX_MEAN; 512 DSL UC-SV filters at θ = JAX_MEAN,
     bootstrap and APF (K1), against UCSV_BANK_JAX; density-tempered SMC on
     the dt configuration with the AR(1) declared by linear_ssm_model (K1 +
     K2-LG), against DT_JAX_MEAN; 512 filters of the AR(1) written with
     ssm_model, systematic (K1) and stratified at ESS < N/2 (K3), against the
     Kalman log Z; all replayed from graphs (the plain propagate route
     captured), each line with its graph launches, held against the
     schedule's; the wall per inner step, DSL against native;
 24. inflation — the port's inflation example at --full sizes (UC
     512×1024 chain 3, UC-SV 512×8192 chain 5) without figures: launch
     counts, θ̂ of both models against the JAX package's 8-seed means, the
     UC model's filtered quartiles and FFBS trend at θ̂ against the Kalman
     filter and smoother; K1 C=1 and K2-LG at the UC posterior mixture's
     8×1024 against their plain versions; the loader, rejuvenations and
     walls of each part;
 25. utils — a UC-SV run_segmented run at 512×1024 split at t=120 through
     save_checkpoint/load_checkpoint (a file, the generator's state
     included) ends bitwise equal to two uninterrupted runs, which agree
     bitwise, with the restored cloud's storage planar; debug_nans raises
     on a NaN made on the card, naming the op; profiling.trace writes a
     trace holding K1's and K2's launches.
 26. parallel — θ-sharded SMC² (``parallel.ShardedSMC2``) in worker
     processes of this script, each on cuda:0: (a) one NCCL rank at
     512×1024 and 512×8192 (T=241, chain=5); (b) two gloo ranks (NCCL
     refuses two ranks on one card) at 512×1024 and 512×8192, K1 and
     K2-UC-SV launched per shard at 256 rows with row_offset 0 and 256, the
     launch counts equal to the schedule; (c) two ranks with the exchange
     armed, grow (K1 + K2-UC-SV, N 1024 … 8192) and full padding (K3 on the
     live-prefix grid + K6 raw per shard); (d) ShardedIBIS on two ranks on
     the ibis phase's configuration; two NCCL ranks on the one card are
     refused at initialization with the remedy named. Every rank's θ, log ω,
     log Z and ESS equal the one-process run's of phases 7, 14 and 17 bit for
     bit. Every run replays the mesh's routes (``ops/graphs.py``:
     the masked filter uncut, S steps a launch; the online step as two
     segments around the θ group's gather, run eagerly between them — with
     NCCL in (a)) and is held against its ``disable_graphs()`` twin on the
     same ranks bit for bit (the same launches and collectives); each line
     adds the graph and segment launches (held against the schedule), the
     cuts a step of each route, the graph pool of the rank and the wall per
     inner step graphed against eager (two gloo ranks time-slice one card:
     no multi-card figure); the wall per inner step against one rank's, the
     collectives' calls, bytes and host seconds, and the θ-resample's cloud
     gather timed alone;
 27. animations — the two animation programs at their defaults (SV T=150,
     N=4096; UC-SV on the PCE series at θ̂, N=4096), 4 seeds each, without
     figures: launch counts of T − 1 a run for K1 and K2-SV or K2-UC-SV, the
     SV log Z against the grid filter and the UC-SV log Z against the JAX
     program's (ANIMATION_UCSV_JAX), walls;
 28. particle — particle-axis sharding (a (θ, particle) mesh with
     particle > 1): (a) the kernels alone: K1 with a slot window and K3 on a
     window of the grid at 512×8192 (C=3) over 2 and 4 particle shards and
     at 64×65,536 over 2, against the whole launch's slots and ancestors bit
     for bit; K2-UC-SV, K2-LG dx=1 and K6 on particles 4096.. of 512×8192
     rows at particle_offset 4096 against the whole launch's columns at the
     same seed bit for bit; each timed. Then worker processes of this
     script on cuda:0 (gloo): (b) the slice's SMC² at 512×8192 on a (1, 2)
     mesh over its first P_STEPS observations (at least one rejuvenation):
     K1 writing each rank's 4096 slots and K6 at 512×4096 with
     particle_offset 0 and 4096, launch counts equal to the schedule, the
     ranks bit for bit alike, the posterior mean against P_SEEDS
     one-process runs at the same cut (the whole rows are normalized in
     torch, where one process normalizes inside K2: the runs part at ties,
     so the check is statistical), walls per inner step and the
     collectives' calls, bytes and host seconds; (c) the slice at 512×1024
     on a (2, 2) mesh of four ranks, the whole T, posterior against
     JAX_MEAN; (d) LG SMC² with the exchange armed in full padding (N 256 …
     1024, the live prefix at first wholly in rank 0's slice) and a
     stratified inner filter at ESS < N/2 on (1, 2) (K3 on the live-prefix
     grid's window + K2-LG raw with particle_offset), bit for bit the
     one-process run; (e) ShardedIBIS on (1, 2), bit for bit phase 17's;
     (f) phase 13's UC-SV SMC² with the APF inside on (1, 2) over its first
     P_STEPS observations (K1 on the cloud with the lookahead plane, K6 raw
     with particle_offset), bit for bit the one-process run (both normalize
     in torch). Every run replays, its inner step as segments
     around the particle group's gathers (cuts), one step a launch; each
     is split at P_TWIN_T observations (a split run is bitwise the whole)
     and held there bit for bit against its ``disable_graphs()`` twin run
     eagerly to P_TWIN_T (the twin's depth cut, never the replayed run's);
     IBIS's twin runs whole. Each line adds graph and segment launches (the
     schedule's), cuts a step, the graph pool and the wall per inner step
     graphed against eager.
 29. dt_mesh — (a) K6 on particle slices of 512×1000 rows off a multiple
     of 16 (particles 0.. and 500.. of 500, 8.. of 992) at their
     particle_offset, on a contiguous slice, the sharded APF's split-off
     planes and a view into the whole rows: bit for bit the whole-row
     call's columns, within 1e-5 of K2-UC-SV raw's, against the plain
     version, the recovered normals' moments; the slice at 500 timed. Then
     worker processes of this script on cuda:0 (gloo): (b) the dt phase's
     runs (a) and (b) through ``density_tempered(ShardedSMC2(sampler,
     mesh).sampler, ...)`` on (2, 1), bit for bit phase 8's one-process
     runs, and on (1, 2) and (2, 2) (K1 slot windows or K3 grid windows +
     K2-LG raw with particle_offset) within TOL_Z of DT_JAX_MEAN; launch
     counts equal to each schedule, the ranks alike, stage counts and walls
     per inner step beside phase 8's; (c) the slice's SMC² at 512×1000 on
     (1, 2), the whole T (K6 at 512×500, particle_offset 0 and 500),
     posterior against JAX_MEAN; (d) phase 13's UC-SV APF SMC² at 512×1000
     on (1, 2) over its first P_STEPS observations, bit for bit the
     one-process run. Every run replays; DT's warm-up over the
     first DT_TWIN_T observations, replayed, is held bit for bit against
     its ``disable_graphs()`` twin on every mesh, (c) and (d) as phase 28's
     runs (split at P_TWIN_T, the twin eager to there); the lines add what
     phase 28's do.
 30. graphs — the compiled loops (``ops/graphs.py``; every phase above
     replays them where its route is captured: any model, proposal, scheme,
     live count and mesh (phases 26, 28, 29)): the masked
     filter (STEPS_PER_GRAPH steps a launch), SMC²'s online
     step (one replay and one flag read a step), filter_sequence and the
     forward bank (store routes), each against its eager loop under
     ``disable_graphs()`` from the same seeds: the slice's SMC² at 512×1024
     and 512×8192 (θ, log Z, log ω, particles, log-weights and every
     StepInfo bit for bit), the dt phase's runs (a) and (b), phase 13's
     UC-SV APF SMC² over its first GRAPH_APF_T observations, the per-θ LG
     filter at 1×1024 (PER_THETA_SEEDS runs), run_segmented with the
     inflation example's collector (UC 512×1024, chain 3; its series too),
     filter_sequence with a quantile summary, FFBS's forward pass
     (forward_clouds) at 1×8192 and the posterior mixture's 8×8192 bank
     from phase 7's flagship state; launch counts equal between the two and
     to each schedule; walls (the better of two warm runs each, taken in
     turns), wall per inner step, the device's busy share (one profiled run
     each of every cell but DT (a) and the per-θ filter: the profiler's
     events of K1, K3, K2 and K6 must number as their launch counters
     count) and peak memory (allocated; the graphs' pool beside it); the
     slice's graphed SMC² at 512×1024 under the profiler with the host's
     activity, whose graph launches must be one an online step plus each
     rejuvenation's masked filters' ⌊(t−1)/S⌋ + (t−1) mod S, and whose host
     syncs one an online step plus a rejuvenation's own; and a replayed
     filter's wall split into its fixed cost and its cost a step, at S
     steps a launch and at one, and into the host's issue and the device's
     run. Then particle Gibbs and conditional SMC (one graph a PG
     sweep, one a CSMC sweep, the multinomial forward bank on the store
     route): phase 22's UC-SV chain at 241×8192, "bs" and "as", one chain
     cut to GRAPH_PG_SWEEPS sweeps, its LG bank of 8 chains at 60×128 cut
     to GRAPH_PG_LG_SWEEPS, and its iterated csmc_sweep, both methods, cut
     to GRAPH_CSMC_SWEEPS, each against its eager twin (θ chain, acceptances, final path, paths,
     launch counts bit for bit), with walls, busy share, the graph pool and
     the routes' warm-up, capture and instantiate seconds; and under the
     profiler with the host's activity, one graph launch a sweep (beside
     the initial bank's replays) and no host sync but the run's closing
     synchronize, for PG at two sweep counts and for iterated CSMC. Then the
     inner routes beyond the fused kernels, each against its eager twin the
     same way: the DSL UC-SV SMC² at 512×1024, chain 5, cut to its first
     GRAPH_APF_T observations; the DSL UC-SV bank at 512×1024, bootstrap
     and APF; the residual, metropolis and guided LG banks at 512×1024,
     T=100; particle Gibbs on the DSL AR(1), 8 chains at 60×128, cut to
     GRAPH_PG_DSL_SWEEPS sweeps. Then IBIS (phase 17's run: its online route
     and the rejuvenations' Kalman passes) and kalman_filter at a 512-θ bank
     (the Kalman store route), each against its eager twin the same way; the
     inflation collector's run_segmented (UC 512×1024, captured collector)
     and the same run without a collector under the profiler with the host's
     activity: the same graph launches and the same host launches between
     each two (no collector launch between replays); and phase 17's run under
     the profiler: its graph launches one an online step plus the Kalman
     passes' ⌊t/S⌋ + t mod S each, its host syncs one an online step plus a
     rejuvenation's own, and a Kalman pass alone none. Then "full" padding
     (the exchange phase's run (b), the live count 1024 → 8192 in arrays
     512×8192, driven by run): against its eager twin the same way (K3 and
     K6 launches equal to the schedule with each doubling's refilter), and
     from cleared graphs once more graphed and through run_segmented with a
     captured collector, graphed and eager: one capture per (kind,
     collector, live count), the series (the live count at every step, the
     dead tail exactly −inf) bit for bit.
The line before the last but one is the kernels' JSON line, the line before
the last the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Nothing here imports JAX.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import json
import math
import subprocess
import sys
import time

import numpy as np

SEED = 0  # the slice's torch.Generator seed
T, CHAIN = 241, 5

# Posterior mean of θ = (γ, x0, log σε0, log ση0) from the JAX package at
# this configuration (M=512, N=1024, T=241, chain=5, same prior and series),
# on the CPU, over seeds jax.random.key(0..7): the mean of the 8 runs' means
# and their standard deviation.
JAX_MEAN = [0.189923, 3.431845, 0.226644, 0.28478]
JAX_SD = [0.009306, 0.206255, 0.033334, 0.043362]
JAX_SEEDS = 8
# The port's mean from one run differs from JAX_MEAN by a draw of the seed
# spread plus the error of an 8-run mean: sd·√(1 + 1/8). Allow 5 of those.
TOL_Z = 5.0

PRIOR_SPEC = [("uniform", 0.0, 1.0), ("normal", 3.0, 2.0),
              ("uniform", 0.0, 2.0), ("uniform", 0.0, 2.0)]  # bench.py:105-112

# Density-tempered SMC on the univariate LG model at BASELINE config 4
# (benchmarks/run_benchmarks.py:128-153): M=512, N=1024, T=100, chain=3.
DT_T, DT_CHAIN, DT_M, DT_N = 100, 3, 512, 1024
# (a) a systematic inner filter at every step, (b) stratified at ESS < N/2
DT_INNER = {"dta": ("systematic", 1.0), "dtb": ("stratified", 0.5)}
LG_THETA = (0.5, 0.9, 0.8)  # θ* = (A, Q, R), the reference README's
LG_PRIOR_SPEC = [("truncated_normal", 0.0, 1.0, -1.0, 1.0), ("lognormal", 0.0, 1.0),
                 ("lognormal", 0.0, 1.0)]  # run_benchmarks.py:42-50
# Posterior mean of θ = (A, Q, R) from the JAX package at this configuration
# (inner filter systematic at every step, same prior and series), on the CPU,
# over seeds jax.random.key(0..7): the mean of the 8 runs' means and their
# standard deviation (tools/jax_reference.py).
DT_JAX_MEAN = [0.535525, 0.996489, 0.535857]
DT_JAX_SD = [0.012255, 0.036463, 0.032133]

# Posterior means and seed spreads of the JAX package with the auxiliary
# particle filter inside SMC² (PFConfig("systematic", 1.0, algorithm="apf")),
# on the CPU over seeds jax.random.key(0..7) (tools/jax_reference.py --run
# apf_ucsv / apf_lg): UC-SV at the slice's configuration, and the LG model at
# M=512, N=1024, chain=3 on the dt phase's prior and series (T=100).
# The UC-SV runs spread widely: two of the 8 seeds end near γ = 0.5–0.75,
# x0 ≈ 1.85, far from the other six and from the bootstrap's posterior.
APF_JAX_MEAN = [0.298121, 3.144286, 0.446609, 0.297007]
APF_JAX_SD = [0.214815, 0.904442, 0.482713, 0.27428]
APF_LG_JAX_MEAN = [0.543813, 0.947238, 0.578904]
APF_LG_JAX_SD = [0.012337, 0.038053, 0.025969]
APF = ("systematic", 1.0, None, "apf")  # PFConfig(*APF)
# log Ẑ of 512 UC-SV filters at θ = JAX_MEAN on the slice's series (N=1024,
# T=241) in the JAX package on the CPU, pooled over jax.random.key(0..3):
# (mean, variance, rows) per filter (tools/jax_reference.py --run ucsv_bank).
UCSV_BANK_JAX = {"bootstrap": (-262.597221, 0.676004, 2048),
                 "apf": (-263.338226, 1.226307, 2048)}

# The inflation phase: θ̂ of the port's inflation example against the JAX
# package's (examples/inflation_example.py's configuration on the vendored PCE
# series, ess_threshold 0.5) on the CPU over seeds jax.random.key(0..7): the
# mean of the 8 runs' posterior means and their standard deviation, UC at
# 512×1024 chain 3 (tools/jax_reference.py --run inflation_uc) and UC-SV at
# 512×1024 chain 5 (--run inflation_ucsv; the example runs N=8192: SMC² with
# PMMH moves targets the same posterior at every N, and its spread at N=8192
# is no wider than at 1024). Held as the slice's, within TOL_Z·sd·√(1 + 1/8).
INFLATION_UC_JAX_MEAN = [1.525395, 0.198121, 0.050582]
INFLATION_UC_JAX_SD = [0.309163, 0.033618, 0.017842]
INFLATION_UCSV_JAX_MEAN = [0.412027, 2.001368, 0.342319, 0.387831]
INFLATION_UCSV_JAX_SD = [0.020751, 0.326096, 0.066759, 0.069967]
# The UC model at θ̂ against the exact filter and smoother of its target: the
# mean over t of |PF − Kalman| in sd units, of the filtered quartiles and of
# the FFBS smoothed trend, as tests/test_torch_examples.py holds them at
# N=512 (about twice the largest of 8 CPU seeds' there).
INFLATION_FILTER_TOL, INFLATION_SMOOTH_TOL = 0.2, 0.15
INFLATION_Z_QUARTILES = np.array([-0.6744897501960817, 0.0, 0.6744897501960817])

# The exchange phase: the slice's UC-SV run with the exchange step armed.
# acc_threshold 1.1 fires it after every rejuvenation while N ≤ 4096, so N
# runs 1024 → 2048 → 4096 → 8192 (the reference's cap, smc_samplers.jl:166).
EXCHANGE_ACC, EXCHANGE_MAX_N, N_CAP = 1.1, 4096, 8192
# log Ẑ of examples/ucsv_animation.py's filter (UC-SV at its THETA_HAT,
# N=4096, the PCE series) from the JAX package on the CPU over
# jax.random.key(0..63), fused_resample="off": the mean and variance over
# the seeds (tools/jax_reference.py --run ucsv_animation --seeds 64).
ANIMATION_UCSV_JAX = (-167.235905, 1.468378, 64)
ANIMATION_SEEDS = 4
PARALLEL_WORKER = "--parallel-worker"
# The particle phase. (b) the slice's UC-SV SMC² at 512×8192 on a (1, 2)
# mesh, cut to its first P_STEPS observations (gloo moves each row's whole
# cloud through host memory at every inner step: about 90 ms of the 0.4 ms
# of a one-rank inner step, so the whole T would take minutes; the whole T
# runs in tools/profile_parallel.py), held against P_SEEDS one-process runs
# at the same cut; (d) LG SMC² on the dt phase's prior and series with the
# exchange armed in full padding, N from P_LG_N to the cap 4·P_LG_N, and a
# stratified inner filter at ESS < N/2.
P_STEPS, P_SEEDS, P_LG_N = 60, 8, 256
# The mesh runs' disable_graphs() twins (phases 28-29): a run held against
# the one-process runs statistically, or whose whole eager twin would cost
# the gather-bound eager loop again, replays split at P_TWIN_T observations
# (run_segmented's split is bitwise the whole run) and its twin runs eagerly
# to P_TWIN_T only; density-tempered SMC's twin is its warm-up run over the
# first DT_TWIN_T observations, replayed and eager.
P_TWIN_T, DT_TWIN_T = 20, 20
P_SLICE_B, P_SLICE_C = (512, 8192), (512, 1024)  # (M, N) of (b) and (c)
# The dt_mesh phase: N of its UC-SV runs on (1, 2), which splits into two
# slices of 500 particles (no multiple of 16), and K6's slices, (first
# particle, width), of a 512×MESH_N row bank
MESH_N = 1000
K6_SLICES = ((0, 500), (500, 500), (8, 992))
# K2's LG instances generated for dx ≥ 3 (the lg_dx phase), and the rows and
# particles of the large_n phase (the reference ran SMC² at M=64, N=65,536,
# BASELINE.md:72)
LG_DX = (3, 4, 5)
LG_DX_INSTANCES = tuple(f"lg{dx}{route}" for dx in LG_DX for route in ("", "_raw"))
LARGE_M, LARGE_N = 64, 65536

# The per_theta, smoothing and pg phases. Particle Gibbs on UC-SV at
# benchmarks/bench_pg.py's configuration (T=241, N=8192, 50 sweeps, chain=3,
# bench.py's prior and series), its θ-chain averaged after PG_BURN sweeps;
# on LG at tests/test_particle_gibbs.py's (T=60, N=128, 400 sweeps, chain=3,
# the dt phase's prior, burn-in 150). FFBS on UC-SV at N=8192 at θ =
# JAX_MEAN, its smoothed means averaged over FFBS_WINDOWS windows of t.
PG_N, PG_SWEEPS, PG_CHAIN, PG_BURN = 8192, 50, 3, 20
PG_LG_T, PG_LG_N, PG_LG_SWEEPS, PG_LG_BURN = 60, 128, 400, 150
# iterated CSMC at LG θ* against RTS, at tests/test_particle_gibbs.py's N
CSMC_N, CSMC_T, CSMC_SWEEPS, CSMC_BURN = 256, 40, 120, 40
FFBS_N, FFBS_WINDOWS = 8192, 8
# The JAX package on the CPU (tools/jax_reference.py, seeds jax.random.key(0..)):
# --run ffbs_ucsv --seeds 24: smoothed_marginals on UC-SV at θ = JAX_MEAN, N=8192, on
# ucsv_series — the mean and sd over the seeds of the smoothed means'
# window averages (window_means: rows x, log σε, log ση) and of log Ẑ;
# --run pg_ucsv --seeds 8: particle_gibbs at PG_N, PG_SWEEPS, PG_CHAIN on ucsv_series
# with bench.py's prior — per method the mean and sd over the seeds of the
# θ-chain means after PG_BURN sweeps and of the acceptance.
FFBS_JAX_SEEDS = 24
FFBS_JAX = {
    "windows_mean": [[2.440484, 1.291665, -0.371528, -1.47573, -2.021628, -0.720789, 1.300778,
                      3.126617],
                     [-1.225523, -2.366631, -2.618566, -2.452679, -1.976276, -2.131238,
                      -2.377695, -2.96883],
                     [-0.659466, -1.267057, -1.298312, -1.611191, -2.014097, -1.806846,
                      -1.491383, -1.559947]],
    "windows_sd": [[0.003896, 0.003296, 0.00385, 0.002752, 0.002092, 0.002673, 0.004431,
                    0.002817],
                   [0.0493, 0.03545, 0.044521, 0.045735, 0.029726, 0.037189, 0.045606, 0.057867],
                   [0.021993, 0.013959, 0.01612, 0.029274, 0.046032, 0.02932, 0.027363,
                    0.021283]],
    "log_z_mean": -262.401667, "log_z_var": 0.065717}
PG_JAX_SEEDS = 8
PG_JAX = {"bs": {"mean": [0.393357, 3.663497, 0.388623, 0.593793],
                 "sd": [0.148199, 1.36242, 0.21683, 0.427078],
                 "acc_mean": 0.2, "acc_sd": 0.032071},
          "as": {"mean": [0.398265, 3.214692, 0.54777, 0.799667],
                 "sd": [0.122016, 1.349002, 0.340284, 0.446555],
                 "acc_mean": 0.2125, "acc_sd": 0.027007}}
# Runs per check: per-θ LG filters (per_theta), UC-SV filter_sequence runs
# at N=8192 and UC-SV APF filters at N=1024, LG FFBS runs (smoothing), LG and
# UC-SV particle-Gibbs chains pooled (pg, one bank each); the posterior
# mixture's θ draws and paths each (inflation_example.py:176-215).
PER_THETA_SEEDS, FFBS_SEEDS, FFBS_LG_SEEDS, PG_LG_CHAINS, PG_CHAINS = 32, 16, 16, 8, 8
MIX_THETA, MIX_PATHS = 8, 64
# A sleep kernel of this many cycles (about 50 ms on an H100) holds the
# device while time_ms queues the calls it times.
SLEEP_CYCLES = 100_000_000
# time_ms queues at most this much of the host's issuing behind the sleep:
# at about 10 µs a launch, a few hundred launches
ISSUE_BUDGET_S = 0.002

# Card rates for the bound. NVIDIA's H100 SXM data sheet, at 700 W: HBM
# bytes/s and f32 operations/s outside the tensor cores. Per SM and clock at
# compute capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput): 4 warp instructions issued (128 thread instructions), 64
# 32-bit integer multiplies (a product's low or high half) and 16 MUFU
# operations (ex2, lg2, sqrt, rsqrt, rcp, sin, cos); 132 SMs at the SM clock
# that nvidia-smi reports as clocks.max.sm.
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
SMS, INSTR_PER_CLOCK, IMAD_PER_CLOCK, MUFU_PER_CLOCK = 132, 128, 64, 16

# Work per particle that a propagate function needs, whatever kernel computes
# it: issued instructions, 32-bit integer multiplies and MUFU operations, with
# what is the same for a whole row (Philox's key schedule, the row's counter
# word and its products, the parameters) done once a row.
#  - Philox-4x32-10 at counter (i, row, 0, 0), by the words the model uses:
#    round 0 has one product (the other is of a zero word), round 1 one (the
#    other is of a word fixed by the row), rounds 2-9 two. All four words
#    (UC-SV): 18 products of 32x32 -> 64 bits, 19 three-way XORs and the
#    counter, 38 issued; r0 and r1 only (LG, SV): the last three rounds drop
#    the halves no output needs, 17 products, 17 XORs, 35 issued. Multiplies,
#    a half each: round 0's product is of the particle index, so for
#    neighbouring particles it can be the last one's plus the round constant,
#    a 64-bit add; the others 34 (four words) and 29 (two).
#  - A uniform from a word: sign fold, int to float, scale (3). Box-Muller:
#    the math library's accurate log of max(1e-7, u1), whose argument in
#    [1e-7, 1] needs no special case (exponent split and conversion 5, 13
#    multiply-adds), the max, -2x and the sqrt (MUFU): 21; 2 pi u2: 1; sin and
#    cos of it in [0, 2 pi) (reduction 5, the square 1, both polynomials 8,
#    quadrant selects and signs 5): 19, or 17 for cos alone; the radius times
#    each: 1 a normal. Both normals of a pair 6 + 21 + 1 + 19 + 2 = 49; the
#    cos one alone 46 (LG dx=1, SV, UC-SV's third).
#  - The update op for op, an exp as a scale and an ex2 (MUFU): UC-SV 14 with
#    2 exps, SV 8 with 1, LG dx=1 6, dx=2 13; the carry's add 1.
#  - 16-byte loads and stores of the planes, log-weights and carry.
#  - The normalize: max, exp(logw - max) (scale, subtract, ex2), two sums,
#    logw - lse: 7 with 1 MUFU; above 1024 the log-weights' second pass.
# tools/sass_count.py holds these against the kernels' machine code.
#  - More than four normals (LG at dx ≥ 5): one more Philox call per four, at
#    the counters (i, row, k, 0), whose words 2 and 3 are fixed by the row
#    as word 1 is, so each costs what the first does by the words it uses.
#  - The LG update at dx: x′_i = Σ_j A_ij x_j + Σ_j F_ij z_j is a multiply
#    and 2dx − 1 multiply-adds a row i, B·x′ subtracted from y in dx
#    multiply-adds, then (δ² times −1/(2R)) plus the row's constant, 3:
#    2dx² + dx + 3 (6 at dx = 1, 13 at dx = 2).
PHILOX_WORK = {4: (38, 34), 2: (35, 29)}  # words used: (issued, multiplies)
BOX_MULLER_PAIR, BOX_MULLER_ONE = 49, 46  # uniforms included
# model: (normals drawn, the update's issued instructions, its exps)
UPDATE_WORK = {"ucsv": (3, 14, 2), "sv": (1, 8, 1),
               **{f"lg{dx}": (dx, 2 * dx * dx + dx + 3, 0) for dx in (1, 2, 3, 4, 5)}}


def lg_series(t: int = DT_T) -> np.ndarray:
    """The LG series at θ*, made with numpy from default_rng(1998):
    x₁ ~ N(0, 1), x_t = A x_{t−1} + N(0, Q), y_t = x_t + N(0, R)."""
    a, q, r = LG_THETA
    rng = np.random.default_rng(1998)
    x, y = rng.normal(0.0, 1.0), np.empty(t)
    for i in range(t):
        if i:
            x = a * x + rng.normal(0.0, math.sqrt(q))
        y[i] = x + rng.normal(0.0, math.sqrt(r))
    return y.astype(np.float32)


def window_means(m: np.ndarray, windows: int = FFBS_WINDOWS) -> np.ndarray:
    """(T, dx) smoothed means → (dx, windows): each component's mean over
    ``windows`` consecutive, near-equal spans of t."""
    return np.stack([w.mean(0) for w in np.array_split(np.asarray(m, np.float64), windows)], 1)


def say(phase: str, **fields) -> None:
    print(f"{phase}: " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def ucsv_series(t: int = T) -> np.ndarray:
    """bench.py's synthetic inflation-like series (bench.py:178-182)."""
    rng = np.random.default_rng(1998)
    return (3.0 + np.cumsum(rng.normal(0, 0.3, t)) + rng.normal(0, 0.5, t)).astype(np.float32)


def series(torch, device):
    """:func:`ucsv_series` as a tensor on ``device``."""
    return torch.tensor(ucsv_series(), device=device)


def time_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time per call over ``iters`` calls, after one warm call.

    The calls are queued behind a sleep kernel long enough for the host to
    issue them all, so they run back to back on the device and the host's
    cost of issuing them (Python, the launchers) does not enter: at 512×1024
    that cost is larger than the kernels' (PERF.md §5). The launches queued
    behind the sleep must stay within the device's launch queue (about a
    thousand; past it the host blocks until the sleep ends): a call of many
    launches (the plain versions of K2's LG dx ≥ 3 instances: about 60) is
    timed over fewer calls, ISSUE_BUDGET_S of the host's issuing at the
    rate of one call timed once, and the sleep lasts at least three times
    that. Fails if the host did not finish issuing before the device reached
    the first call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    iters = max(2, min(iters, int(ISSUE_BUDGET_S / issue_s)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(max(SLEEP_CYCLES, int(3 * iters * issue_s * sm_clock_hz())))
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    issued_ms = 1e3 * (time.perf_counter() - t0)
    started = start.query()  # the sleep must still be running
    end.synchronize()
    if started:
        raise AssertionError(f"time_ms: issuing took {issued_ms:.1f} ms, longer than the sleep")
    return start.elapsed_time(end) / iters


def weight_profiles(torch, gen, m: int, n: int) -> dict:
    """Flat, skewed (softmax of 2·N(0, 1)) and point-mass (one random slot
    per row) weights, (m, n) each, on the card."""
    point = torch.zeros((m, n), device="cuda")
    point[torch.arange(m, device="cuda"),
          torch.randint(0, n, (m,), generator=gen, device="cuda")] = 1.0
    return {
        "flat": torch.ones((m, n), device="cuda"),
        "skewed": torch.softmax(2.0 * torch.randn((m, n), generator=gen, device="cuda"), -1),
        "point": point,
    }


def k1_cloud(torch, gen, m: int, n: int, c: int):
    """K1's input cloud (M, C, N): the auxiliary filter's, built as it
    builds it, a UC-SV (C=4) or LG (C=2) cloud with the lookahead
    log g(y | E[x′|x]) as the last plane, log-densities down to about −120;
    normal planes for any other C. Returns (cloud, the APF's first-stage
    weights or None)."""
    if c not in (2, 4):
        return torch.randn((m, c, n), generator=gen, device="cuda"), None
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.ops.batched_filter import apf_lookahead, as_cloud
    from sequential_monte_carlo_tpu_torch.ops.weights import log_normalize

    if c == 4:
        model = smc.ucsv_model(torch.tensor(JAX_MEAN, device="cuda").expand(m, 4))
        particles = torch.randn((m, n, 3), generator=gen, device="cuda")
        particles[..., 0] += 3.0
        particles[..., 1:] *= 0.5
        y = torch.tensor(8.0, device="cuda")
    else:
        model = _lg_cloud(torch, smc, m, 1)
        particles = torch.randn((m, n, 1), generator=gen, device="cuda")
        y = torch.tensor(4.0, device="cuda")
    log_g = apf_lookahead(model, particles, y)
    cloud = torch.cat([as_cloud(particles), log_g[:, None, :]], dim=1)
    log_w = torch.full((m, n), -math.log(n), device="cuda")  # weights after a resample
    return cloud, torch.exp(log_normalize(log_w + log_g)[1])


def check_k1(torch, cases, gen):
    """K1 against its plain version on (M, N, C) cases, under flat, skewed
    and point-mass weights and, on the auxiliary filter's clouds, its
    first-stage weights: no ancestor may differ; each case timed."""
    from sequential_monte_carlo_tpu_torch.kernels.resample_walk import (
        resample_gather,
        resample_gather_plain,
    )

    out = {"max_abs_err": 0.0}
    for m, n, c in cases:
        xs, w_apf = k1_cloud(torch, gen, m, n, c)
        u0 = torch.rand((m, 1), generator=gen, device="cuda")
        profiles = weight_profiles(torch, gen, m, n)
        if w_apf is not None:
            profiles["apf"] = w_apf
        for name, w in profiles.items():
            got, anc = resample_gather(u0, w, xs, return_ancestors=True)
            ref, anc_ref = resample_gather_plain(u0, w, xs)
            torch.cuda.synchronize()
            agree = anc == anc_ref
            frac = 1.0 - agree.float().mean().item()
            if frac > 0.0:
                raise AssertionError(f"K1 {m}x{n} C={c} {name}: ancestors differ on {frac:.2e}"
                                     " of slots")
            idx = anc.long()[:, None, :].expand(xs.shape)
            if not torch.equal(got, torch.gather(xs, 2, idx)):
                raise AssertionError(f"K1 {m}x{n} {name}: output != xs gathered by its ancestors")
            counts = torch.zeros((m, n), device="cuda").scatter_add_(1, anc.long(), torch.ones_like(w))
            if not (torch.all(counts.sum(1) == n) and torch.all(anc[:, 1:] >= anc[:, :-1])
                    and torch.all((anc >= 0) & (anc < n))):
                raise AssertionError(f"K1 {m}x{n} {name}: ancestors are not a systematic draw")
            err = (got - ref).abs()[agree[:, None, :].expand(xs.shape)].max().item()
            out["max_abs_err"] = max(out["max_abs_err"], err)
            say("K1", shape=f"{m}x{n}", c=c, weights=name, anc_mismatch=f"{frac:.2e}",
                max_abs_err_on_agreeing=err)
        w = profiles["apf" if w_apf is not None else "skewed"]
        key = f"{m}x{n}" if c == 3 else f"c{c}_{m}x{n}"
        out[key] = (time_ms(torch, lambda: resample_gather(u0, w, xs)),
                    time_ms(torch, lambda: resample_gather_plain(u0, w, xs)),
                    *bound_ms(**resample_cost(m, n, c, grid=False)))
        say("K1", shape=f"{m}x{n}", c=c, ms=out[key][0], plain_ms=out[key][1],
            bound_ms=out[key][2])
    return out


def _moments(torch, z) -> tuple:
    """The normals z (K, ...): the largest |mean|, |var − 1| and |corr|
    over their K kinds."""
    flat = z.reshape(z.shape[0], -1).double()
    mean = flat.mean(1).abs().max().item()
    var = (flat.var(1) - 1.0).abs().max().item()
    rho = 0.0
    if flat.shape[0] > 1:
        corr = torch.corrcoef(flat)
        rho = (corr - torch.diag(torch.diag(corr))).abs().max().item()
    return mean, var, rho


def check_normals(torch, label: str, z) -> dict:
    """Fail unless the normals ``z`` (K, ...) a kernel drew, recovered from
    its state deltas, look standard and independent over their ≥ 5·10⁵
    draws each: |mean| < 5e-3, |var − 1| < 1e-2 and |corr| < 5e-3 (about
    3.5, 5 and 3.5 standard errors). A kernel that scales or mixes its
    draws wrongly in the update (Fᵀ in place of F, σ² in place of σ) gives
    recovered normals of another covariance."""
    mean, var, rho = _moments(torch, z)
    if not (mean < 5e-3 and var < 1e-2 and rho < 5e-3):
        raise AssertionError(f"{label}: normals off: |mean| {mean}, |var-1| {var}, |corr| {rho}")
    return {"normals_abs_mean": mean, "normals_abs_var_dev": var, "normals_abs_corr": rho}


def check_k2(torch, shapes, gen):
    from sequential_monte_carlo_tpu_torch.kernels.propagate import (
        fused_elementwise_step,
        fused_elementwise_step_plain,
    )
    from sequential_monte_carlo_tpu_torch.models.ucsv import UCSV_UPDATE, ucsv_update
    from sequential_monte_carlo_tpu_torch.ops.weights import log_normalize

    out = {"max_abs_err": 0.0}
    y = torch.tensor(1.3, device="cuda")
    for m, n in shapes:
        state = torch.randn((m, 3, n), generator=gen, device="cuda")
        state[:, 1:] *= 0.5
        seed = torch.randint(0, 2**31 - 1, (1,), generator=gen, device="cuda")
        zeros = torch.zeros((m, 2), device="cuda")
        new0, *_ = fused_elementwise_step(UCSV_UPDATE, zeros, state, y, seed=seed)
        if not torch.equal(new0[:, 1:], state[:, 1:]):
            raise AssertionError(f"K2 {m}x{n}: with γ=0 the log-vol planes moved")

        gamma = (0.3, 0.2)
        params = torch.tensor(gamma, device="cuda").expand(m, 2).contiguous()
        new, log_norm, lse, ess = fused_elementwise_step(UCSV_UPDATE, params, state, y, seed=seed)
        # θ-sharding: rows r.. at row_offset r are rows r.. of the full call
        r = m // 2
        half = fused_elementwise_step(UCSV_UPDATE, params[r:], state[r:], y, seed=seed,
                                      row_offset=r)
        if not all(torch.equal(a, b[r:]) for a, b in zip(half, (new, log_norm, lse, ess))):
            raise AssertionError(f"K2 {m}x{n}: rows at row_offset {r} differ from the full call's")
        # logw from the plain UC-SV density at the returned state, normalized
        # by the plain log_normalize
        zcol = torch.zeros((m, 1), device="cuda")
        planes = tuple(new[:, s] for s in range(3))
        _, logw_ref = ucsv_update((zcol, zcol), y, planes, (0.0, 0.0, 0.0))
        log_mean_ref, log_norm_ref, ess_ref = log_normalize(logw_ref)
        tol = dict(rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(log_norm + lse, logw_ref, **tol)
        torch.testing.assert_close(log_norm, log_norm_ref, **tol)
        torch.testing.assert_close(lse[:, 0], log_mean_ref + math.log(n), **tol)
        torch.testing.assert_close(ess[:, 0], ess_ref, **tol)
        # the normals the kernel drew, recovered from the state deltas, into
        # the plain version: it must give the kernel's outputs
        z = _recover_normals(torch, "ucsv", params, state, new)
        ref = fused_elementwise_step_plain(UCSV_UPDATE, params, state, y, z)
        for got, want in zip((new, log_norm, lse, ess), ref):
            torch.testing.assert_close(got, want, **tol)
        err = max((new - ref[0]).abs().max().item(), (log_norm - ref[1]).abs().max().item())
        out["max_abs_err"] = max(out["max_abs_err"], err)
        say("K2", shape=f"{m}x{n}", max_abs_err=err,
            **check_normals(torch, f"K2 {m}x{n}", z))

        def plain():
            zz = torch.randn((3, m, n), generator=gen, device="cuda")
            return fused_elementwise_step_plain(UCSV_UPDATE, params, state, y, zz)

        out[f"{m}x{n}"] = (
            time_ms(torch, lambda: fused_elementwise_step(UCSV_UPDATE, params, state, y, seed=seed)),
            time_ms(torch, plain),
        )
        say("K2", shape=f"{m}x{n}", ms=out[f"{m}x{n}"][0], plain_ms=out[f"{m}x{n}"][1])
    return out


@functools.lru_cache(maxsize=None)
def sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout.split()[0]
    return 1e6 * float(mhz)


def bound_ms(nbytes: float, f32: float = 0.0, issue: float = 0.0, imad: float = 0.0,
             mufu: float = 0.0):
    """(least time in ms, "bytes" or "operations", what bounds it): the
    bytes a call must move over the card's memory rate, or the longest of
    its operations on one pipe at that pipe's rate: f32 operations at the
    f32 peak; issued thread instructions, 32-bit integer multiplies and
    MUFU operations at their per-SM rates."""
    clock = SMS * sm_clock_hz()
    times = {"bytes": nbytes / PEAK_BYTES, "f32": f32 / PEAK_F32,
             "issue": issue / (INSTR_PER_CLOCK * clock), "imad": imad / (IMAD_PER_CLOCK * clock),
             "mufu": mufu / (MUFU_PER_CLOCK * clock)}
    limit = max(times, key=times.get)
    return 1e3 * times[limit], "bytes" if limit == "bytes" else "operations", limit


def resample_cost(m: int, n: int, c: int, grid: bool) -> dict:
    """Bytes and operations of one resample + gather call: weights and the
    cloud read, the cloud written, and the grid u read (K3) or the offsets
    u0 (K1); per slot a scan step, a divide and a log2(N)-step search, as f32
    operations (an estimate: these kernels are bound by bytes)."""
    nbytes = 4 * m * n * (2 * c + 1 + (1 if grid else 0)) + (0 if grid else 4 * m)
    return {"nbytes": nbytes, "f32": m * n * (math.log2(n) + 3)}


def propagate_work(model: str, s: int, carry: bool, normalize: bool, n: int) -> tuple:
    """(issued instructions, 32-bit multiplies, MUFU operations) per particle
    that the propagate function of ``model`` (S state planes) needs: the
    constants above."""
    normals, upd_issue, exps = UPDATE_WORK[model]
    issue = imad = 0
    for first in range(0, normals, 4):  # a Philox call per four normals
        call = PHILOX_WORK[4 if normals - first > 2 else 2]
        issue, imad = issue + call[0], imad + call[1]
    issue += (BOX_MULLER_PAIR * (normals // 2) + BOX_MULLER_ONE * (normals % 2) + upd_issue
              + carry + (2 * s + 1 + carry) / 4)
    mufu = (normals + 1) // 2 + exps  # a sqrt a pair, an ex2 an exp
    if normalize:
        issue += 7 + (0.5 if n > 1024 else 0)
        mufu += 1
    return issue, imad, mufu


def propagate_cost(m: int, n: int, s: int, p: int, carry: bool, model: str,
                   normalize: bool) -> dict:
    """Bytes and operations of one fused propagate call: the cloud (S planes)
    and the carry read, the new cloud and log_norm written, (M, P)
    parameters read and lse, ess written; :func:`propagate_work`'s
    operations for every particle."""
    nbytes = 4 * m * n * (2 * s + 1 + (1 if carry else 0)) + 4 * m * (p + 2)
    issue, imad, mufu = propagate_work(model, s, carry, normalize, n)
    return {"nbytes": nbytes, "issue": m * n * issue, "imad": m * n * imad, "mufu": m * n * mufu}


def check_k3_case(torch, label: str, u, w, xs, limit: float, out) -> tuple:
    """K3 on the sorted grid u against its plain version: at most ``limit``
    ancestors differ, the ancestors are in range and sorted, and the output
    is xs gathered by them. Folds the largest error on agreeing slots and
    the mismatch share into ``out``; returns (mismatches, that error)."""
    from sequential_monte_carlo_tpu_torch.kernels.resample_sorted import (
        resample_gather_sorted,
        resample_gather_sorted_plain,
    )

    m, _, n = xs.shape
    got, anc = resample_gather_sorted(u, w, xs, return_ancestors=True)
    ref, anc_ref = resample_gather_sorted_plain(u, w, xs)
    torch.cuda.synchronize()
    agree = anc == anc_ref
    mismatches = int((~agree).sum().item())
    if mismatches > limit:
        raise AssertionError(f"K3 {label}: {mismatches} ancestors differ")
    if not torch.equal(got, torch.gather(xs, 2, anc.long()[:, None, :].expand(xs.shape))):
        raise AssertionError(f"K3 {label}: output != xs gathered by its ancestors")
    if not (torch.all((anc >= 0) & (anc < n)) and torch.all(anc[:, 1:] >= anc[:, :-1])):
        raise AssertionError(f"K3 {label}: ancestors out of range or unsorted")
    err = (got - ref).abs()[agree[:, None, :].expand(xs.shape)].max().item()
    out["max_abs_err"] = max(out["max_abs_err"], err)
    out["anc_mismatch"] = max(out["anc_mismatch"], mismatches / (m * n))
    return mismatches, err


def check_k3(torch, shapes, gen):
    from sequential_monte_carlo_tpu_torch.kernels.resample_sorted import (
        resample_gather_sorted,
        resample_gather_sorted_plain,
        stratified_uniforms,
    )

    out = {"max_abs_err": 0.0, "anc_mismatch": 0.0}
    for m, n, c in shapes:
        xs = torch.randn((m, c, n), generator=gen, device="cuda")
        u = stratified_uniforms(gen, m, n, device="cuda")
        profiles = weight_profiles(torch, gen, m, n)
        for name, w in profiles.items():
            mismatches, err = check_k3_case(torch, f"{m}x{n} {name}", u, w, xs, 1e-3 * m * n, out)
            say("K3", shape=f"{m}x{n}", c=c, weights=name,
                anc_mismatch=f"{mismatches / (m * n):.2e}", max_abs_err_on_agreeing=err)
        w = profiles["skewed"]
        out[f"{m}x{n}"] = (time_ms(torch, lambda: resample_gather_sorted(u, w, xs)),
                           time_ms(torch, lambda: resample_gather_sorted_plain(u, w, xs)),
                           *bound_ms(**resample_cost(m, n, c, grid=True)))
        say("K3", shape=f"{m}x{n}", c=c, ms=out[f"{m}x{n}"][0], plain_ms=out[f"{m}x{n}"][1],
            bound_ms=out[f"{m}x{n}"][2])
    return out


def _lg_cloud(torch, smc, m: int, dx: int):
    """A θ-cloud LG model of m rows for the kernel checks: the LG at θ*
    (dx = 1), or a dx-dimensional one with a non-singular Q, so that the
    kernel's normals can be recovered from the state deltas (dx ≥ 2; the
    filters phase runs Hodrick–Prescott, whose Q is singular)."""
    if dx == 1:
        return smc.lg_model(torch.tensor(LG_THETA, device="cuda").expand(m, 3))
    if dx == 2:
        one = smc.multivariate_linear_gaussian(A=[[0.9, 0.1], [0.0, 0.8]], B=[1.0, 0.5],
                                               Q=[[0.5, 0.1], [0.1, 0.3]], R=0.8)
    else:
        eye = np.eye(dx)
        one = smc.multivariate_linear_gaussian(
            A=0.8 * eye + 0.1 * np.eye(dx, k=1), B=np.linspace(1.0, 0.5, dx),
            Q=0.3 * eye + 0.05 * np.ones((dx, dx)), R=0.8)
    return smc.broadcast_model(one, m)


def _recover_normals(torch, name, params, state, new):
    """The normals the kernel drew, from its state deltas."""
    m = params.shape[0]
    if name.startswith("ucsv"):
        return torch.stack([(new[:, 0] - state[:, 0]) / torch.exp(0.5 * state[:, 1]),
                            (new[:, 1] - state[:, 1]) / params[:, :1],
                            (new[:, 2] - state[:, 2]) / params[:, 1:]])
    if name.startswith("sv"):
        mu, phi, sig = (params[:, i:i + 1] for i in range(3))
        return ((new[:, 0] - mu - phi * (state[:, 0] - mu)) / sig)[None]
    dx = int(name[2])
    a = params[:, :dx * dx].reshape(m, dx, dx)
    f = params[:, dx * dx:2 * dx * dx].reshape(m, dx, dx)
    return torch.linalg.solve(f, new - a @ state).transpose(0, 1)


def check_k2_instances(torch, shapes, gen, names=("lg1", "lg1_carry", "lg2", "sv")):
    """K2's LG and SV instances and the carry route against the plain
    version, fed the normals recovered from the kernel's state deltas, and
    those normals' moments (the plain version, given them, reproduces the
    kernel whatever its update does; the moments show the update right).
    A name ending in ``_raw`` runs the route without the normalize on a
    strided view of a wider cloud, as the auxiliary filter calls it."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.kernels.propagate import (
        fused_elementwise_step,
        fused_elementwise_step_plain,
    )

    out = {}
    y = torch.tensor(0.6, device="cuda")
    for name in names:
        res = out[name] = {"max_abs_err": 0.0}
        raw = name.endswith("_raw")
        for m, n in shapes:
            if name.startswith("sv"):
                model = smc.sv_model(torch.tensor([-1.0, 0.95, 0.3], device="cuda").expand(m, 3))
            elif name.startswith("ucsv"):
                model = smc.ucsv_model(torch.tensor([0.3, 3.0, 0.2, 0.3], device="cuda").expand(m, 4))
            else:
                model = _lg_cloud(torch, smc, m, int(name[2]))
            update, params = model.update, model.fused_params()
            s = 3 if name.startswith("ucsv") else update.n_normals
            state = torch.randn((m, s + raw, n), generator=gen, device="cuda")[:, :s]
            if name.startswith("ucsv"):
                state[:, 1:] *= 0.5
            carry = None
            if name.endswith("_carry"):
                carry = torch.log_softmax(3.0 * torch.randn((m, n), generator=gen, device="cuda"), -1)
                carry[1] = -60.0  # a row carrying very negative log-weights
            seed = torch.randint(0, 2**31 - 1, (1,), generator=gen, device="cuda")
            got = fused_elementwise_step(update, params, state, y, seed=seed, carry_logw=carry,
                                         normalize=not raw)
            z = _recover_normals(torch, name, params, state, got[0])
            ref = fused_elementwise_step_plain(update, params, state, y, z, carry, not raw)
            for a, b in zip(got, ref):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
            if not torch.all(torch.isfinite(got[1 if raw else 2])):
                raise AssertionError(f"K2 {name} {m}x{n}: log-weights not finite")
            err = max((a - b).abs().max().item() for a, b in zip(got, ref))
            res["max_abs_err"] = max(res["max_abs_err"], err)
            moments = check_normals(torch, f"K2 {name} {m}x{n}", z)

            def plain():
                zz = torch.randn((update.n_normals, m, n), generator=gen, device="cuda")
                return fused_elementwise_step_plain(update, params, state, y, zz, carry, not raw)

            res[f"{m}x{n}"] = (
                time_ms(torch, lambda: fused_elementwise_step(update, params, state, y, seed=seed,
                                                              carry_logw=carry,
                                                              normalize=not raw)),
                time_ms(torch, plain),
                *bound_ms(**propagate_cost(m, n, s, params.shape[1], carry is not None,
                                           name.split("_")[0], not raw)))
            say("K2", instance=name, shape=f"{m}x{n}", max_abs_err=err, ms=res[f"{m}x{n}"][0],
                plain_ms=res[f"{m}x{n}"][1], bound_ms=res[f"{m}x{n}"][2], **moments)
    return out


def run_slice(torch, n: int, seed: int):
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec

    prior = prior_from_spec(PRIOR_SPEC, device="cuda")
    cfg = smc.SMCConfig(n_particles=n, n_theta=512, chain=CHAIN, ess_threshold=0.5,
                        inner=smc.PFConfig("systematic", 1.0))
    sampler = smc.SMC2(smc.ucsv_model, prior, cfg)
    y = series(torch, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, infos = sampler.run(gen, y)
    torch.cuda.synchronize()
    return state, infos, time.perf_counter() - t0


def launch_counts():
    """Every kernel's launch count: K1, K3, and K2 per instance."""
    from sequential_monte_carlo_tpu_torch.kernels.propagate import fused_elementwise_step
    from sequential_monte_carlo_tpu_torch.kernels.resample_sorted import resample_gather_sorted
    from sequential_monte_carlo_tpu_torch.kernels.resample_walk import resample_gather
    from sequential_monte_carlo_tpu_torch.kernels.ucsv import ucsv_propagate_reweight

    counts = {"resample_count": resample_gather.launches,
              "resample_sorted": resample_gather_sorted.launches,
              "ucsv_propagate": ucsv_propagate_reweight.launches}
    for inst in ("ucsv", "lg1", "lg1_carry", "lg2", "lg2_carry", "sv", "sv_carry",
                 "ucsv_raw", "lg1_raw", "lg2_raw", "sv_raw", "lg1_split", "lg1_carry_split",
                 *LG_DX_INSTANCES):
        counts[f"fused_propagate_{inst}"] = fused_elementwise_step.instance_launches[inst]
    return counts


def reset_counts():
    from sequential_monte_carlo_tpu_torch.kernels.propagate import fused_elementwise_step
    from sequential_monte_carlo_tpu_torch.kernels.resample_sorted import resample_gather_sorted
    from sequential_monte_carlo_tpu_torch.kernels.resample_walk import resample_gather
    from sequential_monte_carlo_tpu_torch.kernels.ucsv import ucsv_propagate_reweight

    resample_gather.launches = 0
    resample_gather_sorted.launches = 0
    ucsv_propagate_reweight.launches = 0
    fused_elementwise_step.instance_launches.clear()


def expect_counts(phase: str, counts, expected):
    """Fail unless the run launched exactly the expected kernels."""
    want = {k: expected.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{phase}: launches {counts}, expected {want}")


def dt_sampler(inner, device="cuda", model_fn=None):
    """The density-tempered runs' sampler: LG at config 4 (``model_fn``,
    lg_model unless given) with the inner filter ``PFConfig(*inner)``."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec

    cfg = smc.SMCConfig(n_particles=DT_N, n_theta=DT_M, chain=DT_CHAIN, ess_threshold=0.5,
                        inner=smc.PFConfig(*inner))
    return smc.SMC2(model_fn or smc.lg_model, prior_from_spec(LG_PRIOR_SPEC, device=device), cfg)


def dt_fields(state, trace) -> dict:
    """A density-tempered run's θ-level fields and every stage's (ξ, ess,
    acc_ratio), as numpy arrays."""
    return {**_theta_fields(state),
            **{f"stage_{k}": np.asarray([getattr(s, k) for s in trace])
               for k in ("xi", "ess", "acc_ratio")}}


def run_dt(torch, inner, seed: int, model_fn=None):
    """Density-tempered SMC on LG at config 4 (``model_fn``, lg_model unless
    given), through the public entry points. Returns (state, trace,
    wall-clock s, launch counts)."""
    import sequential_monte_carlo_tpu_torch as smc

    sampler = dt_sampler(inner, model_fn=model_fn)
    y = torch.tensor(lg_series(), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state, trace = smc.density_tempered(sampler, gen, y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return state, trace, wall, launch_counts()


def check_dt(torch, label, inner, k_resample, k_propagate, model_fn=None, phase="dt"):
    """One checked run (seed 0), then a warm run of seed 1, timed. Returns
    the checked run's launch counts and its fields (:func:`dt_fields`) with
    its stage count and wall per inner step."""
    import sequential_monte_carlo_tpu_torch as smc

    state, trace, wall, counts = run_dt(torch, inner, SEED, model_fn)
    moves = sum(stage.xi < 1.0 for stage in trace)
    expected = (DT_T - 1) * (1 + DT_CHAIN * moves)
    expect_counts(f"{phase} ({label})", counts, {k_resample: expected, k_propagate: expected})
    mean = smc.expected_parameters(state).cpu().numpy()
    tol = TOL_Z * np.asarray(DT_JAX_SD) * math.sqrt(1.0 + 1.0 / JAX_SEEDS)
    if not np.all(np.abs(mean - np.asarray(DT_JAX_MEAN)) <= tol):
        raise AssertionError(f"{phase} ({label}): posterior mean {mean} vs JAX {DT_JAX_MEAN}"
                             f" beyond {tol}")
    say(phase, run=label, inner=list(inner), shape=f"{DT_M}x{DT_N}", T=DT_T, chain=DT_CHAIN,
        wall_s=round(wall, 4), schedule=[round(s.xi, 5) for s in trace], rejuvenations=moves,
        launches=expected, posterior_mean=np.round(mean, 5).tolist(), jax_mean=DT_JAX_MEAN,
        tolerance=np.round(tol, 5).tolist())
    _, trace2, wall2, _ = run_dt(torch, inner, SEED + 1, model_fn)
    steps2 = (DT_T - 1) * (1 + DT_CHAIN * sum(stage.xi < 1.0 for stage in trace2))
    say(phase, run=label, seed=SEED + 1, warm_wall_s=round(wall2, 4), stages=len(trace2),
        warm_ms_per_inner_step=round(1e3 * wall2 / steps2, 4))
    return counts, {"fields": dt_fields(state, trace), "stages": len(trace),
                    "warm_ms_per_inner_step": 1e3 * wall2 / steps2}


def kalman_is_oracle(torch):
    """The posterior mean by importance sampling from the prior, weighted
    by the exact Kalman likelihood (for information)."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec

    prior = prior_from_spec(LG_PRIOR_SPEC, device="cuda")
    theta = prior.sample(torch.Generator(device="cuda").manual_seed(77), (200_000,))
    _, lz = smc.kalman_log_likelihood(smc.lg_model(theta), torch.tensor(lg_series(), device="cuda"))
    w = torch.softmax(lz.double(), 0)
    return (w @ theta.double()).cpu().numpy(), (1.0 / torch.sum(w * w)).item()


def run_filters(torch, models, y, inner, seed: int, n: int = DT_N, m: int = DT_M,
                calls=None):
    """m parallel filters of n particles through ``batched_log_likelihood``,
    after a warm-up run: (log Z, wall-clock s, launch counts) of the second
    run. ``inner``: PFConfig's fields. ``calls``: a dict that gets the
    second run's graph launches and host syncs (:func:`graph_calls`)."""
    import sequential_monte_carlo_tpu_torch as smc

    smc.batched_log_likelihood(torch.Generator(device="cuda").manual_seed(seed + 100), models,
                               n, m, y, smc.PFConfig(*inner))  # warm-up, not counted
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    reset_counts()
    with graph_calls(torch) if calls is not None else contextlib.nullcontext({}) as seen:
        t0 = time.perf_counter()
        _, log_w, log_z = smc.batched_log_likelihood(gen, models, n, m, y, smc.PFConfig(*inner))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if calls is not None:
        calls.update(seen)
    if not (torch.all(torch.isfinite(log_z))
            and torch.allclose(torch.logsumexp(log_w, 1), torch.zeros(m, device="cuda"),
                               atol=1e-4)):
        raise AssertionError("filters: log Z not finite or weights not normalized")
    return log_z.double(), wall, launch_counts()


def sv_grid_log_z(ys, mu: float, phi: float, sigma: float, points: int = 2001) -> float:
    """log Z of the series ``ys`` under the SV model, by a point-mass filter
    in f64 on a grid of ±10 stationary sd around mu: x₁ from the stationary
    law, then per step predict through the Gaussian transition matrix and
    weight by N(y; 0, exp(x)). Independent of the port. At (−1, 0.95, 0.3)
    the grid step is a 30th of the innovation sd, and 4001 points give the
    same log Z to 1e-8 (tests/test_torch_density_tempered.py)."""
    sd0 = sigma / math.sqrt(1.0 - phi**2)
    x = np.linspace(mu - 10.0 * sd0, mu + 10.0 * sd0, points)
    h = x[1] - x[0]

    def pdf(v, loc, scale):
        return np.exp(-0.5 * ((v - loc) / scale) ** 2) / (scale * math.sqrt(2.0 * math.pi))

    p = pdf(x, mu, sd0) * h
    kernel = pdf(x[None, :], mu + phi * (x[:, None] - mu), sigma) * h  # [from, to]
    log_z = 0.0
    for t, y in enumerate(np.asarray(ys, dtype=np.float64)):
        if t:
            p = p @ kernel
        q = p * pdf(y, 0.0, np.exp(0.5 * x))
        s = q.sum()
        log_z += math.log(s)
        p = q / s
    return log_z


def sv_series(mu: float, phi: float, sigma: float, t: int = DT_T) -> np.ndarray:
    """An SV series drawn with numpy from default_rng(1), x₁ stationary."""
    rng = np.random.default_rng(1)
    x, ys = rng.normal(mu, sigma / math.sqrt(1 - phi**2)), np.empty(t)
    for i in range(t):
        if i:
            x = mu + phi * (x - mu) + rng.normal(0.0, sigma)
        ys[i] = rng.normal(0.0, math.exp(0.5 * x))
    return ys.astype(np.float32)


def check_delta(model: str, lz, kz: float, wall: float, steps: int,
                phase: str = "filters", n: int = DT_N, **extra) -> None:
    """Hold the rows' PF log Z against the exact log Z of the filter's
    target: E[Ẑ] = Z gives mean + var/2 ≈ log Z (delta method), within 5
    standard errors of that estimate from the rows' mean and variance (the
    bank's rows, ``lz``'s length; ``n`` particles a row, printed; ``extra``
    printed after the line's fields)."""
    rows = lz.shape[0]
    mean, var = lz.mean().item(), lz.var().item()
    se = math.sqrt(var / rows + var**2 / (2 * (rows - 1)))
    if abs(mean + var / 2 - kz) > 5 * se:
        raise AssertionError(f"{phase} ({model}): mean {mean} + var/2 {var / 2} vs exact {kz}"
                             f" beyond 5·{se}")
    say(phase, model=model, rows=rows, n=n, T=DT_T, wall_s=round(wall, 4),
        logz_mean=round(mean, 5), logz_var=round(var, 5), exact_logz=round(kz, 5),
        delta=round(mean + var / 2 - kz, 5), five_se=round(5 * se, 5), launches=steps, **extra)


def filter_graph_launches(live: int) -> int:
    """The graph launches of a masked filter over ``live`` live times:
    ⌊live/S⌋ of the S-step graph, then one a step."""
    from sequential_monte_carlo_tpu_torch.ops import graphs

    s = graphs.STEPS_PER_GRAPH
    return live // s + live % s


def expect_graph_launches(phase: str, calls: dict, want: int) -> None:
    """Fail unless the run launched ``want`` CUDA graphs."""
    if calls["graph_launches"] != want:
        raise AssertionError(f"{phase}: {calls}, expected {want} graph launches")


def check_filters(torch, algorithm: str = "bootstrap", seed: int = 3):
    """BASELINE config 3 (512 parallel LG filters at θ*) and Hodrick–Prescott
    (the sorted-grid kernel and K2's dx = 2 instance) against the Kalman
    filter; SV filters (K2's SV instance) against the grid filter. With
    ``algorithm="apf"`` the auxiliary particle filter, whose second stage
    is K2's route without the normalize. Returns the runs' launch counts."""
    import sequential_monte_carlo_tpu_torch as smc

    phase, raw = ("apf", "_raw") if algorithm == "apf" else ("filters", "")
    y = torch.tensor(lg_series(), device="cuda")
    steps = DT_T - 1
    # LG at θ*, systematic at every step (run_benchmarks.py:109-126). The
    # Kalman filter predicts x₁ from (x0, Σ0) while the particle filter
    # draws x₁ ~ N(x0, Σ0): the filter's own target is the Kalman log Z
    # from Σ0' = (Σ0 − Q)/A², whose prediction is N(0, 1).
    lz, wall, total = run_filters(torch, _lg_cloud(torch, smc, DT_M, 1), y,
                                  ("systematic", 1.0, None, algorithm), seed)
    expect_counts(f"{phase} (lg)", total, {"resample_count": steps,
                                           f"fused_propagate_lg1{raw}": steps})
    a, q, r = LG_THETA
    target = smc.univariate_linear_gaussian(a, 1.0, q, r, x0=0.0, sigma0=(1.0 - q) / a**2)
    check_delta("lg", lz, smc.kalman_log_likelihood(target, y)[1].item(), wall, steps, phase)

    # Hodrick–Prescott (λ = 1600, singular Q) on the same series, stratified;
    # its target likewise, from x0' = A⁻¹x0 and Σ0' = A⁻¹(Σ0 − Q)A⁻ᵀ. The
    # initial covariance is 1·I, not the diffuse 1000·I that suits the
    # Kalman filter: from that, a bootstrap filter of 1024 particles
    # collapses in its first two weightings, and its log Z is no estimate.
    hp = smc.hodrick_prescott(1600.0, y, init_cov=1.0)
    lz, wall, counts = run_filters(torch, smc.broadcast_model(hp, DT_M), y,
                                   ("stratified", 1.0, None, algorithm), seed + 1)
    expect_counts(f"{phase} (hp)", counts, {"resample_sorted": steps,
                                            f"fused_propagate_lg2{raw}": steps})
    total = {k: v + counts[k] for k, v in total.items()}
    a_inv = torch.linalg.inv(hp.A)
    target = smc.multivariate_linear_gaussian(hp.A, hp.B, hp.Q, hp.R, X0=a_inv @ hp.x0,
                                              Sigma0=a_inv @ (hp.sigma0 - hp.Q) @ a_inv.T)
    check_delta("hp", lz, smc.kalman_log_likelihood(target, y)[1].item(), wall, steps, phase)

    # SV at (mu, phi, sigma) = (−1, 0.95, 0.3) on a series drawn from it;
    # x₁ is drawn from the stationary law, so the grid filter's target is
    # the filter's own
    mu, phi, sig = -1.0, 0.95, 0.3
    ys = sv_series(mu, phi, sig)
    sv = smc.sv_model(torch.tensor([mu, phi, sig], device="cuda").expand(DT_M, 3))
    lz, wall, counts = run_filters(torch, sv, torch.tensor(ys, device="cuda"),
                                   ("systematic", 1.0, None, algorithm), seed + 2)
    expect_counts(f"{phase} (sv)", counts, {"resample_count": steps,
                                            f"fused_propagate_sv{raw}": steps})
    check_delta("sv", lz, sv_grid_log_z(ys, mu, phi, sig), wall, steps, phase)
    return {k: v + counts[k] for k, v in total.items()}


def check_k6(torch, shapes, gen):
    """K6, the hand-written UC-SV kernel, on the (M, 3, N) strided view of a
    (M, 4, N) cloud (the auxiliary filter's split-off planes): against its
    plain version fed the normals recovered from its state deltas (and those
    normals' moments), its log-weights against the density at the returned
    state, the normalize against a torch normalize of the raw log-weights at
    the same seed, γ = 0, the row_offset property, and K2's UC-SV instance
    at the same seed within 1e-5. Times K6 and K2-UC-SV, raw and normalized."""
    from sequential_monte_carlo_tpu_torch.kernels.propagate import fused_elementwise_step
    from sequential_monte_carlo_tpu_torch.kernels.ucsv import (
        ucsv_propagate_reweight,
        ucsv_propagate_reweight_plain,
    )
    from sequential_monte_carlo_tpu_torch.models.ucsv import UCSV_UPDATE
    from sequential_monte_carlo_tpu_torch.ops.weights import log_normalize

    out = {"max_abs_err": 0.0, "k2_max_abs_diff": 0.0, "k2_bitwise_raw": True,
           "k2_bitwise_normalized": True}
    tol = dict(rtol=1e-5, atol=1e-5)
    y = torch.tensor(1.3, device="cuda")
    for m, n in shapes:
        wide = torch.randn((m, 4, n), generator=gen, device="cuda")
        wide[:, 1:3] *= 0.5
        cloud = wide[:, :3]
        seed = torch.randint(0, 2**31 - 1, (1,), generator=gen, device="cuda")
        zero = torch.zeros(m, device="cuda")
        new0, _ = ucsv_propagate_reweight(seed, y, zero, zero, cloud)
        if not torch.equal(new0[:, 1:], cloud[:, 1:]):
            raise AssertionError(f"K6 {m}x{n}: with γ=0 the log-vol planes moved")

        params = torch.tensor((0.3, 0.2), device="cuda").expand(m, 2).contiguous()
        ge, gn = params[:, 0], params[:, 1]
        raw = ucsv_propagate_reweight(seed, y, ge, gn, cloud)
        norm = ucsv_propagate_reweight(seed, y, ge, gn, cloud, normalize=True)
        new, logw = raw
        if not torch.equal(norm[0], new):
            raise AssertionError(f"K6 {m}x{n}: the normalize moved the state")
        # the normalize ≡ a torch normalize of the raw log-weights
        log_mean_ref, log_norm_ref, ess_ref = log_normalize(logw)
        torch.testing.assert_close(norm[1], log_norm_ref, **tol)
        torch.testing.assert_close(norm[2][:, 0], log_mean_ref + math.log(n), **tol)
        torch.testing.assert_close(norm[3][:, 0], ess_ref, **tol)
        # logw is the observation density at the returned state
        zz = (y - new[:, 0]) * torch.exp(-0.5 * new[:, 2])
        torch.testing.assert_close(logw, -0.5 * zz * zz - 0.5 * new[:, 2] - 0.5 * math.log(2 * math.pi),
                                   **tol)
        # the normals it drew, recovered from the state deltas, into the
        # plain version; their moments show the update right
        z = _recover_normals(torch, "ucsv", params, cloud, new)
        err = 0.0
        for normalize, got in ((False, raw), (True, norm)):
            ref = ucsv_propagate_reweight_plain(y, ge, gn, cloud, z, normalize)
            for a, b in zip(got, ref):
                torch.testing.assert_close(a, b, **tol)
                err = max(err, (a - b).abs().max().item())
        out["max_abs_err"] = max(out["max_abs_err"], err)
        moments = check_normals(torch, f"K6 {m}x{n}", z)
        # θ-sharding: rows r.. at row_offset r are rows r.. of the full call,
        # raw (the sharded exchange's route) and normalized
        r = m // 2
        for normalize, full in ((False, raw), (True, norm)):
            half = ucsv_propagate_reweight(seed, y, ge[r:], gn[r:], cloud[r:], row_offset=r,
                                           normalize=normalize)
            if not all(torch.equal(a, b[r:]) for a, b in zip(half, full)):
                raise AssertionError(f"K6 {m}x{n} normalize={normalize}: rows at row_offset {r}"
                                     " differ from the full call's")
        # against K2's UC-SV instance at the same seed, per route
        diff, bitwise = 0.0, {}
        for route, k6 in (("raw", raw), ("normalized", norm)):
            k2 = fused_elementwise_step(UCSV_UPDATE, params, cloud, y, seed=seed,
                                        normalize=route == "normalized")
            for a, b in zip(k6, k2):
                torch.testing.assert_close(a, b, **tol)
                diff = max(diff, (a - b).abs().max().item())
            bitwise[route] = all(torch.equal(a, b) for a, b in zip(k6, k2))
            out[f"k2_bitwise_{route}"] = out[f"k2_bitwise_{route}"] and bitwise[route]
        out["k2_max_abs_diff"] = max(out["k2_max_abs_diff"], diff)
        say("K6", shape=f"{m}x{n}", max_abs_err=err, k2_max_abs_diff=diff,
            k2_bitwise_raw=bitwise["raw"], k2_bitwise_normalized=bitwise["normalized"], **moments)

        def plain(normalize):
            zz = torch.randn((3, m, n), generator=gen, device="cuda")
            return ucsv_propagate_reweight_plain(y, ge, gn, cloud, zz, normalize)

        for label, normalize in (("", False), ("normalized_", True)):
            bound = bound_ms(**propagate_cost(m, n, 3, 2, False, "ucsv", normalize))  # K2's too
            out[f"{label}{m}x{n}"] = (
                time_ms(torch, lambda: ucsv_propagate_reweight(seed, y, ge, gn, cloud,
                                                               normalize=normalize)),
                time_ms(torch, lambda: plain(normalize)), *bound)
            out[f"k2_{label}{m}x{n}"] = (
                time_ms(torch, lambda: fused_elementwise_step(UCSV_UPDATE, params, cloud, y,
                                                              seed=seed, normalize=normalize)),
                out[f"{label}{m}x{n}"][1], *bound)
        say("K6", shape=f"{m}x{n}", ms=out[f"{m}x{n}"][0],
            ms_normalized=out[f"normalized_{m}x{n}"][0], k2_ucsv_raw_ms=out[f"k2_{m}x{n}"][0],
            k2_ucsv_normalized_ms=out[f"k2_normalized_{m}x{n}"][0],
            plain_ms=out[f"{m}x{n}"][1], bound_ms=out[f"{m}x{n}"][2],
            bound_ms_normalized=out[f"normalized_{m}x{n}"][2])
    return out


def check_k3_grids(torch, gen, res):
    """K3 on the systematic grid u = (i + u0)/N in f32 that K9's v7 builds
    in-kernel (512×8192, C=3: no ancestor may differ from the plain
    version's), and at K8's and K9's default tilings (512×2048, 512×4096,
    C=3), under flat, skewed and point-mass weights; the latter two timed
    into ``res``."""
    from sequential_monte_carlo_tpu_torch.kernels.resample_sorted import (
        resample_gather_sorted,
        resample_gather_sorted_plain,
    )

    for label, m, n in (("v7", 512, 8192), ("K8/K9 tiling", 512, 2048),
                        ("K8/K9 tiling", 512, 4096)):
        xs = torch.randn((m, 3, n), generator=gen, device="cuda")
        u0 = torch.rand((m, 1), generator=gen, device="cuda")
        u = (torch.arange(n, device="cuda", dtype=torch.float32) + u0) / n
        profiles = weight_profiles(torch, gen, m, n)
        for name, w in profiles.items():
            limit = 0 if label == "v7" else 1e-3 * m * n
            mismatches, err = check_k3_case(torch, f"{label} {m}x{n} {name}", u, w, xs, limit, res)
            say("K3", grid=label, shape=f"{m}x{n}", c=3, weights=name,
                anc_mismatches=mismatches, max_abs_err_on_agreeing=err)
        if label != "v7":
            w = profiles["skewed"]
            res[f"{m}x{n}"] = (time_ms(torch, lambda: resample_gather_sorted(u, w, xs)),
                               time_ms(torch, lambda: resample_gather_sorted_plain(u, w, xs)),
                               *bound_ms(**resample_cost(m, n, 3, grid=True)))
            say("K3", grid=label, shape=f"{m}x{n}", c=3, ms=res[f"{m}x{n}"][0],
                plain_ms=res[f"{m}x{n}"][1], bound_ms=res[f"{m}x{n}"][2])


def run_apf_smc2(torch, model_fn, prior_spec, y, chain: int, seed: int):
    """Online SMC² (M=512, N=1024) with APF inner filters through the public
    entry points: (state, infos, wall-clock s, launch counts)."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec

    cfg = smc.SMCConfig(n_particles=DT_N, n_theta=DT_M, chain=chain, ess_threshold=0.5,
                        inner=smc.PFConfig(*APF))
    sampler = smc.SMC2(model_fn, prior_from_spec(prior_spec, device="cuda"), cfg)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state, infos = sampler.run(gen, y)
    torch.cuda.synchronize()
    return state, infos, time.perf_counter() - t0, launch_counts()


def check_apf_smc2(torch, label, model_fn, prior_spec, y, chain, k_propagate, ref_mean, ref_sd):
    """One checked APF SMC² run (seed 0): launch counts (one resample and
    one propagate launch per inner step, T − 1 online steps plus
    chain·(t_r − 1) per rejuvenation at t_r), a finite θ-ESS and the
    posterior mean within 5·sd·√(1 + 1/8) of the JAX package's; then a warm
    run of seed 1, timed. Returns (state, counts, posterior mean)."""
    import sequential_monte_carlo_tpu_torch as smc

    state, infos, wall, counts = run_apf_smc2(torch, model_fn, prior_spec, y, chain, SEED)
    rejuv_t = (torch.nonzero(infos.rejuvenated).flatten() + 1).tolist()
    expected = (y.shape[0] - 1) + sum(chain * (t - 1) for t in rejuv_t)
    expect_counts(f"apf ({label})", counts, {"resample_count": expected, k_propagate: expected})
    ess = state.ess.item()
    if not math.isfinite(ess):
        raise AssertionError(f"apf ({label}): θ-ESS is {ess}")
    mean = smc.expected_parameters(state).cpu().numpy()
    tol = TOL_Z * np.asarray(ref_sd) * math.sqrt(1.0 + 1.0 / JAX_SEEDS)
    if not np.all(np.abs(mean - np.asarray(ref_mean)) <= tol):
        raise AssertionError(f"apf ({label}): posterior mean {mean} vs JAX {ref_mean} beyond {tol}")
    _, _, wall2, _ = run_apf_smc2(torch, model_fn, prior_spec, y, chain, SEED + 1)
    say("apf", run=label, shape=f"{DT_M}x{DT_N}", T=y.shape[0], chain=chain,
        wall_s=round(wall, 4), warm_wall_s_seed1=round(wall2, 4), rejuvenations=len(rejuv_t),
        launches=expected, ess=round(ess, 3), posterior_mean=np.round(mean, 5).tolist(),
        jax_apf_mean=list(ref_mean), tolerance=np.round(tol, 5).tolist())
    return state, counts, mean


def check_apf(torch):
    """The auxiliary particle filter on the main paths: (a) SMC² on UC-SV
    at the slice's configuration (K1 + K6), (b) the README's APF SMC² on LG
    (K1 + K2-LG raw), (c) 512 parallel APF filters on LG, Hodrick–Prescott,
    SV and UC-SV. Returns the launch counts of the runs."""
    import sequential_monte_carlo_tpu_torch as smc

    # (a) the same posterior as the slice's bootstrap run, so also held
    # against the bootstrap's JAX mean with the slice's tolerance (the JAX
    # APF's 8 seeds spread too widely to gate much: PERF.md §7)
    _, total, mean = check_apf_smc2(torch, "ucsv", smc.ucsv_model, PRIOR_SPEC,
                                    series(torch, "cuda"), CHAIN, "ucsv_propagate",
                                    APF_JAX_MEAN, APF_JAX_SD)
    boot_tol = TOL_Z * np.asarray(JAX_SD) * math.sqrt(1.0 + 1.0 / JAX_SEEDS)
    distance = np.abs(mean - np.asarray(JAX_MEAN)) / boot_tol
    if not np.all(distance <= 1.0):
        raise AssertionError(f"apf (ucsv): posterior mean {mean} vs the bootstrap's JAX mean"
                             f" {JAX_MEAN} beyond {boot_tol}")
    say("apf", run="ucsv", bootstrap_jax_mean=JAX_MEAN,
        distance_in_bootstrap_tolerances=np.round(distance, 4).tolist())

    # (b) LG: the posterior, and the final θ-cloud's log Z against the Kalman filter's
    y = torch.tensor(lg_series(), device="cuda")
    state, counts, _ = check_apf_smc2(torch, "lg", smc.lg_model, LG_PRIOR_SPEC, y, DT_CHAIN,
                                      "fused_propagate_lg1_raw", APF_LG_JAX_MEAN, APF_LG_JAX_SD)
    total = {k: v + counts[k] for k, v in total.items()}
    dz = state.log_z - smc.kalman_log_likelihood(smc.lg_model(state.theta), y)[1]
    median = dz.median().item()
    if not (torch.all(torch.isfinite(dz)) and abs(median) < 2.0):
        raise AssertionError(f"apf (lg): median log Z − Kalman {median}")
    say("apf", run="lg", median_logz_minus_kalman=round(median, 5))

    # (c) 512 parallel APF filters, as the filters phase, and on UC-SV
    counts = check_filters(torch, "apf", seed=6)
    total = {k: v + counts[k] for k, v in total.items()}
    counts = check_ucsv_banks(torch, seed=9)
    return {k: v + counts[k] for k, v in total.items()}


def check_ucsv_banks(torch, seed: int):
    """512 UC-SV filters at θ = JAX_MEAN on the slice's series (N=1024,
    T=241), bootstrap (K1 + K2-UC-SV) and APF (K1 on the cloud with the
    lookahead plane + K6): each bank's mean log Ẑ against the JAX package's
    bank at the same θ (UCSV_BANK_JAX) within 5 combined standard errors.
    Both filters are unbiased for the same Z, but the APF's correction
    weights are heavy-tailed on UC-SV (its lookahead at the transition mean
    is narrower than the predictive), so the delta method's mean + var/2
    understates its log E[Ẑ], by about 0.4–0.5 here as in the JAX
    package's APF: that difference is printed, not gated (PERF.md §7).
    Returns the runs' launch counts."""
    import sequential_monte_carlo_tpu_torch as smc

    models = smc.ucsv_model(torch.tensor(JAX_MEAN, device="cuda").expand(DT_M, 4))
    y, steps = series(torch, "cuda"), T - 1
    total, delta = None, {}
    for i, (alg, k_propagate) in enumerate((("bootstrap", "fused_propagate_ucsv"),
                                            ("apf", "ucsv_propagate"))):
        lz, wall, counts = run_filters(torch, models, y, ("systematic", 1.0, None, alg), seed + i)
        expect_counts(f"apf (ucsv bank, {alg})", counts, {"resample_count": steps,
                                                          k_propagate: steps})
        mean, var = lz.mean().item(), lz.var().item()
        ref_mean, ref_var, ref_rows = UCSV_BANK_JAX[alg]
        se = math.sqrt(var / DT_M + ref_var / ref_rows)
        if abs(mean - ref_mean) > 5 * se:
            raise AssertionError(f"apf (ucsv bank, {alg}): mean log Z {mean} vs JAX {ref_mean}"
                                 f" beyond 5·{se}")
        delta[alg] = (mean + var / 2, var / DT_M + var**2 / (2 * (DT_M - 1)))
        say("apf", model="ucsv", filter=alg, rows=DT_M, n=DT_N, T=T, wall_s=round(wall, 4),
            logz_mean=round(mean, 5), logz_var=round(var, 5), jax_logz_mean=ref_mean,
            jax_logz_var=ref_var, five_se=round(5 * se, 5), launches=steps)
        total = counts if total is None else {k: v + counts[k] for k, v in total.items()}
    diff = delta["apf"][0] - delta["bootstrap"][0]
    say("apf", model="ucsv", apf_minus_bootstrap_delta_method=round(diff, 5),
        combined_se=round(math.sqrt(delta["apf"][1] + delta["bootstrap"][1]), 5))
    return total


def _schedule(infos, chain: int, doubled_at) -> int:
    """Inner steps of an online SMC² run: one per online step, chain·(t − 1)
    per rejuvenation at step t, and t_d − 1 per refilter of the history
    y[0:t_d] at a doubling."""
    rejuv_t = (infos.rejuvenated.nonzero().flatten() + 1).tolist()
    return len(infos.ess) + sum(chain * (t - 1) for t in rejuv_t) + sum(t - 1 for t in doubled_at)


def exchange_sampler(torch, pad: str):
    """The exchange phase's SMC² (UC-SV, M=512, N from 1024, chain=5, the
    exchange armed with acc_threshold 1.1 and exchange_max_n 4096, a
    systematic inner filter) with ``elastic_pad=pad``."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec

    cfg = smc.SMCConfig(n_particles=DT_N, n_theta=DT_M, chain=CHAIN, ess_threshold=0.5,
                        acc_threshold=EXCHANGE_ACC, exchange_max_n=EXCHANGE_MAX_N,
                        elastic_pad=pad, inner=smc.PFConfig("systematic", 1.0))
    return smc.SMC2(smc.ucsv_model, prior_from_spec(PRIOR_SPEC, device="cuda"), cfg)


def run_exchange(torch, pad: str, via: str, seed: int = SEED):
    """Online SMC² on UC-SV (M=512, N from 1024, T=241, chain=5) with the
    exchange step armed, ``elastic_pad=pad``, driven by ``step`` +
    ``maybe_exchange`` (``via="step"``) or ``run_segmented`` with a
    collect_fn (``via="segmented"``). Returns (state, infos, the
    observation counts t at which a refilter ran, N after every step, the
    collected series, wall-clock s, launch counts, a step's state with
    0 < active_n < N under "full" padding)."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.samplers.smc2 import _stack

    sampler = exchange_sampler(torch, pad)
    y = series(torch, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    sizes, doubled_at, partial, series_out = [], [], None, None
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    if via == "segmented":
        # per step, before a doubling's service: the posterior mean, and t
        # and the pending flag, which give the doublings' refilters (device
        # tensors: the collector runs inside the replayed step)
        def collect(st):
            return smc.expected_parameters(st), st.t, st.exchange_pending

        state, (infos, (series_out, ts, pending)) = sampler.run_segmented(
            gen, y, segment_size=16, collect_fn=collect)
        doubled_at = ts[pending].tolist()
    else:
        state, infos = sampler.init(gen, y), []
        if state.particles.shape[1] != (N_CAP if pad == "full" else DT_N):
            raise AssertionError(f"exchange ({pad}): arrays {tuple(state.particles.shape)}")
        for _ in range(1, T):
            t0_step, n0 = state.t, state.active_n
            state, info = sampler.step(gen, state, y)
            if state.active_n != n0:  # "full": doubled inside the step at t0
                doubled_at.append(t0_step)
            if state.exchange_pending:  # "grow": serviced over y[0:t]
                doubled_at.append(state.t)
            state = sampler.maybe_exchange(gen, state, y, info)
            infos.append(info)
            sizes.append(state.active_n)
            width = state.particles.shape[1]
            if width != (N_CAP if pad == "full" else state.active_n):
                raise AssertionError(f"exchange ({pad}): arrays of {width} at N={state.active_n}")
            if partial is None and pad == "full" and state.active_n < N_CAP:
                lw = state.log_w
                partial = state.active_n
                if not (torch.all(lw[:, state.active_n:] == -torch.inf)
                        and torch.all(torch.isfinite(lw[:, :state.active_n]))):
                    raise AssertionError(f"exchange (full): the tail past {state.active_n}"
                                         " is not exactly −inf, or a live slot is not finite")
        infos = _stack(infos)
    torch.cuda.synchronize()
    return (state, infos, doubled_at, sizes, series_out, time.perf_counter() - t0,
            launch_counts(), partial)


def check_exchange(torch, gen):
    """The exchange phase: (a) grow, (b) full padding, (c) run_segmented,
    each checked for its N schedule, launch counts and posterior; (d) K3 on
    the elastic grid. Returns the runs' launch counts, K3's elastic
    mismatch count and the final states of (a) and (b) by padding."""
    import sequential_monte_carlo_tpu_torch as smc

    tol = TOL_Z * np.asarray(JAX_SD) * math.sqrt(1.0 + 1.0 / JAX_SEEDS)
    total, grow_state, states = None, None, {}
    for run, pad, via, kernels in (
            ("a", "grow", "step", ("resample_count", "fused_propagate_ucsv")),
            ("b", "full", "step", ("resample_sorted", "ucsv_propagate")),
            ("c", "grow", "segmented", ("resample_count", "fused_propagate_ucsv"))):
        state, infos, doubled_at, sizes, ser, wall, counts, partial = run_exchange(torch, pad,
                                                                                   via)
        label = f"exchange ({run}, {pad}, {via})"
        if via == "segmented":
            if ser.shape != (T - 1, 4) or not torch.all(torch.isfinite(ser)):
                raise AssertionError(f"{label}: collected series {tuple(ser.shape)}")
        else:
            steps = sorted(set(sizes))
            if steps != [2 * DT_N, 4 * DT_N, N_CAP] and steps != [DT_N, 2 * DT_N, 4 * DT_N, N_CAP]:
                raise AssertionError(f"{label}: N ran through {steps}, not 1024 … 8192")
            if sizes != sorted(sizes) or max(sizes) > N_CAP:
                raise AssertionError(f"{label}: N went {sizes}")
        if state.active_n != N_CAP or len(doubled_at) != 3:
            raise AssertionError(f"{label}: ended at N={state.active_n} after doublings at"
                                 f" {doubled_at}")
        expected = _schedule(infos, CHAIN, doubled_at)
        expect_counts(label, counts, {k: expected for k in kernels})
        lw = state.log_w
        if not torch.all(torch.isfinite(lw[:, :state.active_n])):
            raise AssertionError(f"{label}: a live log-weight is not finite")
        if pad == "full" and partial is None:
            raise AssertionError(f"{label}: no step ran with 0 < active_n < {N_CAP}")
        mean = smc.expected_parameters(state).cpu().numpy()
        if not np.all(np.abs(mean - np.asarray(JAX_MEAN)) <= tol):
            raise AssertionError(f"{label}: posterior mean {mean} vs JAX {JAX_MEAN} beyond {tol}")
        extra = {}
        if via == "step":
            states[pad] = state
        if via == "step" and pad == "grow":
            grow_state = state
        if via == "segmented":
            extra["bitwise_as_run_a"] = all(torch.equal(getattr(state, f), getattr(grow_state, f))
                                            for f in ("theta", "log_omega", "log_z"))
        if pad == "full":
            extra["tail_checked_at_active_n"] = partial
        say("exchange", run=run, pad=pad, via=via, shape=f"{DT_M}x{DT_N}..{N_CAP}",
            T=T, chain=CHAIN, wall_s=round(wall, 4), inner_steps=expected,
            wall_ms_per_inner_step=round(1e3 * wall / expected, 4),
            rejuvenations=int(infos.rejuvenated.sum()), doubled_at_t=doubled_at,
            final_n=state.active_n, posterior_mean=np.round(mean, 5).tolist(),
            jax_mean=JAX_MEAN, tolerance=np.round(tol, 5).tolist(), **extra)
        total = counts if total is None else {k: v + counts[k] for k, v in total.items()}
        if via == "step":  # a warm run of seed 1 (run a's wall carries Triton's compiles at
            # N = 2048 and 4096): its wall per inner step, by its own schedule
            _, infos2, doubled2, _, _, wall2, _, _ = run_exchange(torch, pad, via, SEED + 1)
            steps2 = _schedule(infos2, CHAIN, doubled2)
            say("exchange", run=run, pad=pad, seed=SEED + 1, warm_wall_s=round(wall2, 4),
                inner_steps=steps2, wall_ms_per_inner_step=round(1e3 * wall2 / steps2, 4))
    return total, check_k3_elastic(torch, gen), states


def check_k3_elastic(torch, gen) -> int:
    """K3 on the elastic filter's live-prefix grids at 512×8192, C=3: the
    systematic grid (i + u0)/active_n clamped at 1 − 1e-7 (a dead tail of
    equal u), weights 0 past active_n, active_n ∈ {1024, 4096, 8191}: no
    ancestor may differ from the plain version's or reach active_n."""
    from sequential_monte_carlo_tpu_torch.kernels.resample_sorted import resample_gather_sorted
    from sequential_monte_carlo_tpu_torch.ops.batched_filter import _elastic_sorted_u

    m, n, res = DT_M, N_CAP, {"max_abs_err": 0.0, "anc_mismatch": 0.0}
    for active in (1024, 4096, 8191):
        xs = torch.randn((m, 3, n), generator=gen, device="cuda")
        w = weight_profiles(torch, gen, m, n)["skewed"]
        w[:, active:] = 0.0
        u = _elastic_sorted_u(torch.rand((m, 1), generator=gen, device="cuda"), n, active)
        mismatches, err = check_k3_case(torch, f"elastic {m}x{n} active_n={active}", u, w, xs,
                                        0, res)
        top = int(resample_gather_sorted(u, w, xs, return_ancestors=True)[1].max())
        if top >= active:
            raise AssertionError(f"K3 elastic: ancestor {top} ≥ active_n {active}")
        say("exchange", run="d", kernel="K3", grid="elastic", shape=f"{m}x{n}", c=3,
            active_n=active, anc_mismatches=mismatches, max_ancestor=top,
            max_abs_err_on_agreeing=err)
    return int(res["anc_mismatch"] * m * n)


def check_large_n(torch, gen, k1, k3, k2i):
    """K1 and K3 at 64×65,536 (their large route) against their plain
    versions under flat, skewed and point-mass weights, C=1 and 3 (no
    ancestor may differ), timed at C=3 into ``k1``/``k3``; K2-LG and its
    carry route, which the banks run, against their plain version at that
    shape (``check_k2_instances``, into ``k2i``); then 64 LG filters at θ*,
    N=65,536, systematic (K1 + K2-LG) and stratified at ESS < N/2 (K3 +
    K2-LG with carry), against the Kalman log Z. Returns the banks' launch
    counts."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.kernels.resample_sorted import (
        resample_gather_sorted,
        resample_gather_sorted_plain,
        stratified_uniforms,
    )
    from sequential_monte_carlo_tpu_torch.kernels.resample_walk import (
        resample_gather,
        resample_gather_plain,
    )

    m, n = LARGE_M, LARGE_N
    key = f"{m}x{n}"
    for c in (1, 3):
        xs = torch.randn((m, c, n), generator=gen, device="cuda")
        u0 = torch.rand((m, 1), generator=gen, device="cuda")
        u = stratified_uniforms(gen, m, n, device="cuda")
        profiles = weight_profiles(torch, gen, m, n)
        for name, w in profiles.items():
            got, anc = resample_gather(u0, w, xs, return_ancestors=True)
            ref, anc_ref = resample_gather_plain(u0, w, xs)
            if not (torch.equal(anc, anc_ref) and torch.equal(got, ref)):
                raise AssertionError(f"large_n K1 {key} C={c} {name}: "
                                     f"{int((anc != anc_ref).sum())} ancestors differ")
            mismatches, err = check_k3_case(torch, f"{key} C={c} {name}", u, w, xs, 0, k3)
            say("large_n", shape=key, c=c, weights=name, k1_anc_mismatches=0,
                k3_anc_mismatches=mismatches)
        w = profiles["skewed"]
        if c == 3:
            k1[key] = (time_ms(torch, lambda: resample_gather(u0, w, xs)),
                       time_ms(torch, lambda: resample_gather_plain(u0, w, xs)),
                       *bound_ms(**resample_cost(m, n, c, grid=False)))
            k3[key] = (time_ms(torch, lambda: resample_gather_sorted(u, w, xs)),
                       time_ms(torch, lambda: resample_gather_sorted_plain(u, w, xs)),
                       *bound_ms(**resample_cost(m, n, c, grid=True)))
            say("large_n", shape=key, c=3, k1_ms=k1[key][0], k1_plain_ms=k1[key][1],
                k1_bound_ms=k1[key][2], k3_ms=k3[key][0], k3_plain_ms=k3[key][1],
                k3_bound_ms=k3[key][2])

    for inst, res in check_k2_instances(torch, [(m, n)], gen, names=("lg1", "lg1_carry")).items():
        k2i[inst]["max_abs_err"] = max(k2i[inst]["max_abs_err"], res.pop("max_abs_err"))
        k2i[inst].update(res)

    y = torch.tensor(lg_series(), device="cuda")
    a, q, r = LG_THETA
    target = smc.univariate_linear_gaussian(a, 1.0, q, r, x0=0.0, sigma0=(1.0 - q) / a**2)
    kz = smc.kalman_log_likelihood(target, y)[1].item()
    models, steps, total = _lg_cloud(torch, smc, m, 1), DT_T - 1, None
    for i, (inner, kernels) in enumerate(((("systematic", 1.0),
                                           ("resample_count", "fused_propagate_lg1_split")),
                                          (("stratified", 0.5),
                                           ("resample_sorted", "fused_propagate_lg1_carry_split")))):
        lz, wall, counts = run_filters(torch, models, y, inner, 11 + i, n=n, m=m)
        expect_counts(f"large_n ({inner[0]})", counts, {k: steps for k in kernels})
        check_delta(f"lg {inner[0]} ess<{inner[1]}N", lz, kz, wall, steps, "large_n", n=n)
        total = counts if total is None else {k: v + counts[k] for k, v in total.items()}
    return total


def check_k2_split(torch, gen):
    """K2's split route (a normalized row over several programs in one
    launch, finished by its last program) at 64×65,536, 1×65,536 and a
    ragged 3×40,000, LG dx=1 with and without the carry, distinct θ a row:
    against the route without the normalize at the same seed (the same
    Philox stream), the new cloud bit for bit and log_norm, lse and ess
    within 1e-5 of the plain normalize of its log-weights (plus the carry);
    rows 0..M/2 − 1 of the call bit for bit an M/2-row call; a CUDA graph
    of the call, replayed twice, bit for bit the eager call; the ``_split``
    launch count one a call."""
    from sequential_monte_carlo_tpu_torch.kernels.propagate import (
        _launch_config,
        fused_elementwise_step,
        normalize_rows,
    )
    from sequential_monte_carlo_tpu_torch.models.linear_gaussian import LG_UPDATES

    update, y = LG_UPDATES[1], torch.tensor(0.6, device="cuda")
    counts = fused_elementwise_step.instance_launches
    for m, n in ((64, 65536), (1, 65536), (3, 40000)):
        tiles = _launch_config(n, True)[2]
        if tiles < 2:
            raise AssertionError(f"K2 split: rows of {n} do not take the split route")
        params = torch.cat([0.2 + 0.7 * torch.rand((m, 1), generator=gen, device="cuda"),
                            0.5 + torch.rand((m, 1), generator=gen, device="cuda"),
                            torch.ones((m, 1), device="cuda"),
                            0.5 + torch.rand((m, 1), generator=gen, device="cuda")], 1)
        state = torch.randn((m, 1, n), generator=gen, device="cuda")
        seed = torch.randint(0, 2**31 - 1, (1,), generator=gen, device="cuda")
        carries = (None, torch.log_softmax(3.0 * torch.randn((m, n), generator=gen,
                                                             device="cuda"), -1))
        for carry in carries:
            name = "lg1" + ("" if carry is None else "_carry")
            label = f"K2 {name} {m}x{n}"

            def step(rows=m, out=None, carry=carry):
                return fused_elementwise_step(update, params[:rows], state[:rows], y, seed=seed,
                                              carry_logw=None if carry is None else carry[:rows],
                                              out=out)

            before = counts[f"{name}_split"]
            got = step()
            if counts[f"{name}_split"] != before + 1:
                raise AssertionError(f"{label}: {counts[f'{name}_split'] - before} launches "
                                     f"counted under {name}_split, not 1")
            new, logw = fused_elementwise_step(update, params, state, y, seed=seed,
                                               normalize=False)
            if not torch.equal(got[0], new):
                raise AssertionError(f"{label}: the new cloud is not the raw route's")
            ref = normalize_rows(logw if carry is None else logw + carry)
            for g, r in zip(got[1:], ref):
                torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)
            err = max((g - r).abs().max().item() for g, r in zip(got[1:], ref))
            if m > 1 and not all(torch.equal(p, g[:m // 2]) for p, g in zip(step(m // 2), got)):
                raise AssertionError(f"{label}: rows 0..{m // 2 - 1} differ from a "
                                     f"{m // 2}-row call's")
            out = (torch.empty_like(state), torch.empty((m, n), device="cuda"))
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                step(out=out)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                replayed = step(out=out)
            for _ in range(2):
                for t in replayed:
                    t.zero_()
                graph.replay()
                torch.cuda.synchronize()
                if not all(torch.equal(r, g) for r, g in zip(replayed, got)):
                    raise AssertionError(f"{label}: the replay differs from the eager call")
            say("k2_split", case=label, tiles=tiles, cloud_bitwise=True, max_abs_err=err,
                half_rows_bitwise=m > 1, replays_bitwise=2)


def lg_dx_model(smc, dx: int):
    """A dx = 3, 4 or 5 LG model of trend and cycles (Harvey's structural
    form), stable enough for a bootstrap filter: a local linear trend (level,
    slope), then an AR(1) cycle (dx = 3), an AR(2) cycle in companion form
    (dx = 4), or an AR(2) cycle and an AR(1) component (dx = 5); y the level
    plus the cycles' first states with noise variance 1, x₁ ~ N(0, Σ0) with
    the slope's variance 0.01 and the others' 1."""
    a = np.zeros((dx, dx))
    a[0, :2] = 1.0
    a[1, 1] = 1.0
    q = [0.05, 0.005]
    if dx == 3:
        a[2, 2] = 0.8
        q += [0.3]
    else:
        a[2, 2:4] = (1.2, -0.4)
        a[3, 2] = 1.0
        q += [0.1, 0.0]
        if dx == 5:
            a[4, 4] = 0.5
            q += [0.2]
    b = np.zeros(dx)
    b[[0, 2] + ([4] if dx == 5 else [])] = 1.0
    return smc.multivariate_linear_gaussian(A=a, B=b, Q=np.diag(q), R=1.0, X0=np.zeros(dx),
                                            Sigma0=np.diag([1.0, 0.01] + [1.0] * (dx - 2)))


def lg_dx_series(a, b, q, r, sigma0, t: int = DT_T) -> np.ndarray:
    """A series drawn from the LG model (numpy, default_rng(dx)), x₁ ~ N(0, Σ0)
    for a diagonal Σ0."""
    dx = a.shape[0]
    rng = np.random.default_rng(dx)
    x, ys = rng.normal(0.0, 1.0, dx) * np.sqrt(np.diag(sigma0)), np.empty(t)
    for i in range(t):
        if i:
            x = a @ x + rng.normal(0.0, 1.0, dx) * np.sqrt(np.diag(q))
        ys[i] = b @ x + rng.normal(0.0, math.sqrt(r))
    return ys.astype(np.float32)


def check_lg_dx(torch, shapes, gen):
    """K2's generated LG instances (dx = 3, 4, 5), normalized and raw,
    against their plain versions (``check_k2_instances``); then 512 filters
    of each ``lg_dx_model``, bootstrap (K1 + K2-lgX) and APF (K1 + K2-lgX
    raw), against the Kalman log Z of the filter's target. Returns (the
    instances' results, the banks' launch counts)."""
    import sequential_monte_carlo_tpu_torch as smc

    res = check_k2_instances(torch, shapes, gen, names=LG_DX_INSTANCES)
    steps, total = DT_T - 1, None
    for dx in LG_DX:
        one = lg_dx_model(smc, dx)
        a, b, q, sigma0 = (getattr(one, k).cpu().double().numpy()
                           for k in ("A", "B", "Q", "sigma0"))
        ys = lg_dx_series(a, b, q, one.R.item(), sigma0)
        y = torch.tensor(ys, device="cuda")
        # the filter draws x₁ ~ N(x0, Σ0); the Kalman filter predicts x₁ from
        # its prior, so its target starts from x0' = A⁻¹x0, Σ0' = A⁻¹(Σ0 − Q)A⁻ᵀ
        a_inv = torch.linalg.inv(one.A)
        target = smc.multivariate_linear_gaussian(one.A, one.B, one.Q, one.R, X0=a_inv @ one.x0,
                                                  Sigma0=a_inv @ (one.sigma0 - one.Q) @ a_inv.T)
        kz = smc.kalman_log_likelihood(target, y)[1].item()
        for alg, route in (("bootstrap", ""), ("apf", "_raw")):
            lz, wall, counts = run_filters(torch, smc.broadcast_model(one, DT_M), y,
                                           ("systematic", 1.0, None, alg), 20 + dx)
            expect_counts(f"lg_dx (dx={dx}, {alg})", counts,
                          {"resample_count": steps, f"fused_propagate_lg{dx}{route}": steps})
            check_delta(f"lg dx={dx} {alg}", lz, kz, wall, steps, "lg_dx")
            total = counts if total is None else {k: v + counts[k] for k, v in total.items()}
    return res, total


def ibis_sampler(torch):
    """The ibis phase's sampler (M=512, chain=3, ESS threshold 0.5, the dt
    phase's prior) and series (T=100)."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec

    return (smc.IBIS(smc.lg_model, prior_from_spec(LG_PRIOR_SPEC, device="cuda"),
                     smc.SMCConfig(n_theta=DT_M, chain=DT_CHAIN, ess_threshold=0.5)),
            torch.tensor(lg_series(), device="cuda"))


def kalman_graph_launches(infos, chain: int) -> int:
    """The Kalman route's graph launches of an IBIS run: at each
    rejuvenation at t, ``chain`` passes over y[0:t], ⌊t/S⌋ + t mod S each."""
    from sequential_monte_carlo_tpu_torch.ops import graphs

    s = graphs.STEPS_PER_GRAPH
    # step i runs at t = i + 1
    ts = [i + 1 for i, fired in enumerate(infos.rejuvenated.tolist()) if fired]
    return sum(chain * (t // s + t % s) for t in ts)


def check_ibis(torch):
    """IBIS on the dt phase's prior and series (M=512, chain=3, T=100),
    replayed (its online route and its rejuvenations' Kalman passes): the
    posterior mean against the exact prior-IS oracle, within the dt phase's
    tolerance; no kernel launches; one replay and one flag read an online
    step, and the Kalman route's replays as counted."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.ops import graphs

    ibis, y = ibis_sampler(torch)
    smc.clear_graphs()  # so that the cache's routes of these kinds are this run's
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state, infos = ibis.run(torch.Generator(device="cuda").manual_seed(SEED), y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    expect_counts("ibis", launch_counts(), {})
    (route,) = [r for key, r in graphs._cache.items() if key[0] == "ibis"]
    online, reads = route.replays, route.buffers.reads
    kalman = sum(r.replays for key, r in graphs._cache.items() if key[0] == "kalman")
    want = kalman_graph_launches(infos, DT_CHAIN)
    if not (online == reads == DT_T - 1 and kalman == want):
        raise AssertionError(f"ibis: {online} online replays and {reads} flag reads for"
                             f" {DT_T - 1} steps, {kalman} Kalman replays for {want}")
    mean = smc.expected_parameters(state).cpu().numpy()
    oracle, _ = kalman_is_oracle(torch)
    tol = TOL_Z * np.asarray(DT_JAX_SD) * math.sqrt(1.0 + 1.0 / JAX_SEEDS)
    if not np.all(np.abs(mean - oracle) <= tol):
        raise AssertionError(f"ibis: posterior mean {mean} vs the oracle {oracle} beyond {tol}")
    say("ibis", shape=f"{DT_M} θ", T=DT_T, chain=DT_CHAIN, wall_s=round(wall, 4),
        rejuvenations=int(infos.rejuvenated.sum()), online_replays=online, flag_reads=reads,
        kalman_replays=kalman, posterior_mean=np.round(mean, 5).tolist(),
        oracle=np.round(oracle, 5).tolist(), tolerance=np.round(tol, 5).tolist())
    return state


def widened_proposal(smc, torch):
    """The guided proposal of the routes: an LG bank's transition widened
    1.5-fold, a ``Product(Normal)``."""
    return smc.Proposal(
        initial=lambda mm: mm.initial_distribution(),
        step=lambda mm, xp: smc.Product(smc.Normal(mm.A[..., 0, :] * xp,
                                                   1.5 * torch.sqrt(mm.Q[..., 0, :]))))


def check_routes(torch):
    """512 LG filters at θ* (N=1024, T=100) with the residual_systematic
    (K1), multinomial and residual inner schemes (K2-LG after each), and a
    guided proposal (the transition widened 1.5-fold: K1, no propagate
    kernel): each bank's log Z against the Kalman filter's; each replayed
    from graphs, ⌊99/S⌋ + 99 mod S launches (its host syncs printed).
    Returns the banks' launch counts."""
    import sequential_monte_carlo_tpu_torch as smc

    y = torch.tensor(lg_series(), device="cuda")
    a, q, r = LG_THETA
    target = smc.univariate_linear_gaussian(a, 1.0, q, r, x0=0.0, sigma0=(1.0 - q) / a**2)
    kz = smc.kalman_log_likelihood(target, y)[1].item()
    widened = widened_proposal(smc, torch)
    steps, total = DT_T - 1, None
    for i, (label, inner, kernels) in enumerate((
            ("residual_systematic", ("residual_systematic", 1.0),
             ("resample_count", "fused_propagate_lg1")),
            ("multinomial", ("multinomial", 1.0), ("fused_propagate_lg1",)),
            ("residual", ("residual", 1.0), ("fused_propagate_lg1",)),
            ("guided", ("systematic", 1.0, widened), ("resample_count",)))):
        calls = {}
        lz, wall, counts = run_filters(torch, _lg_cloud(torch, smc, DT_M, 1), y, inner, 30 + i,
                                       calls=calls)
        expect_counts(f"routes ({label})", counts, {k: steps for k in kernels})
        expect_graph_launches(f"routes ({label})", calls, filter_graph_launches(steps))
        check_delta(f"lg {label}", lz, kz, wall, steps, "routes",
                    graph_launches=calls["graph_launches"], host_syncs=calls["host_syncs"])
        total = counts if total is None else {k: v + counts[k] for k, v in total.items()}
    return total


def _normals_ok(torch, label: str, z) -> dict:
    """check_normals' moments for a one-row kernel's few draws: each within
    5 standard errors of its count n (|mean| < 5/√n, |var − 1| < 5·√(2/n),
    |corr| < 5/√n)."""
    n = z[0].numel()
    mean, var, rho = _moments(torch, z)
    if not (mean < 5 / math.sqrt(n) and var < 5 * math.sqrt(2 / n) and rho < 5 / math.sqrt(n)):
        raise AssertionError(f"{label}: normals off: |mean| {mean}, |var-1| {var}, |corr| {rho}")
    return {"normals_abs_mean": round(mean, 5), "normals_abs_var_dev": round(var, 5)}


def _as_row(t, layout: str):
    """The tensor ``t`` as a one-row (1, *t.shape) tensor: contiguous, a row
    of a wider tensor seen through ``unsqueeze`` (at an offset, stride(0)
    that of the wider rows), through ``expand`` (stride(0) 0), or dense with
    stride 1 on every axis of length 1 (as the resample kernels return a
    one-row cloud)."""
    if layout == "contiguous":
        return t[None].clone()
    if layout == "unsqueeze":
        wide = t.new_zeros((3,) + tuple(t.shape))
        wide[1] = t
        return wide[1].unsqueeze(0)
    if layout == "size1_strides":  # the resample kernels' output for a one-row, one-plane cloud
        shape = (1,) + tuple(t.shape)
        strides = [1 if d == 1 else st for d, st in zip(shape, t[None].contiguous().stride())]
        out = t.new_empty_strided(shape, strides)
        out.copy_(t[None])
        return out
    return t.expand((1,) + tuple(t.shape))


def _k2_case(torch, gen, name: str, model, res, state, y, label: str, key=None, **kw):
    """K2 on one cloud ``state`` (M, S, N) of ``model``'s bank against its
    plain version fed the normals recovered from its state deltas (within
    1e-5), those normals' moments within 5 standard errors of their count;
    timed into ``res[key]`` where a key is given. Returns the moments."""
    from sequential_monte_carlo_tpu_torch.kernels.propagate import (
        fused_elementwise_step,
        fused_elementwise_step_plain,
    )

    update, params = model.update, model.fused_params()
    m, s, n = state.shape
    carry, normalize = kw.get("carry_logw"), kw.get("normalize", True)
    seed = torch.randint(0, 2**31 - 1, (1,), generator=gen, device="cuda")
    got = fused_elementwise_step(update, params, state, y, seed=seed, **kw)
    z = _recover_normals(torch, name, params, state, got[0])
    ref = fused_elementwise_step_plain(update, params, state, y, z, carry, normalize)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    res["max_abs_err"] = max(res["max_abs_err"],
                             max((a - b).abs().max().item() for a, b in zip(got, ref)))
    moments = _normals_ok(torch, label, z)
    if key is not None:
        def plain():
            zz = torch.randn((update.n_normals, m, n), generator=gen, device="cuda")
            return fused_elementwise_step_plain(update, params, state, y, zz, carry, normalize)
        res[key] = (time_ms(torch, lambda: fused_elementwise_step(update, params, state, y,
                                                                  seed=seed, **kw)),
                    time_ms(torch, plain),
                    *bound_ms(**propagate_cost(m, n, s, params.shape[1], carry is not None,
                                               name.split("_")[0], normalize)))
    return moments


def _k6_case(torch, gen, ucsv, cloud, y, res, label: str, key=None) -> dict:
    """K6 on one UC-SV cloud (M, 3, N) of the bank ``ucsv`` against its
    plain version fed the recovered normals and against K2-UC-SV raw at the
    same seed, both within 1e-5, the normals' moments within 5 standard
    errors; timed into ``res[key]`` where a key is given. Returns the
    moments."""
    from sequential_monte_carlo_tpu_torch.kernels.propagate import fused_elementwise_step
    from sequential_monte_carlo_tpu_torch.kernels.ucsv import (
        ucsv_propagate_reweight,
        ucsv_propagate_reweight_plain,
    )

    tol = dict(rtol=1e-5, atol=1e-5)
    m, _, n = cloud.shape
    params = ucsv.fused_params()
    ge, gn = params[:, 0], params[:, 1]
    seed = torch.randint(0, 2**31 - 1, (1,), generator=gen, device="cuda")
    raw = ucsv_propagate_reweight(seed, y, ge, gn, cloud)
    z = _recover_normals(torch, "ucsv", params, cloud, raw[0])
    for a, b in zip(raw, ucsv_propagate_reweight_plain(y, ge, gn, cloud, z)):
        torch.testing.assert_close(a, b, **tol)
        res["max_abs_err"] = max(res["max_abs_err"], (a - b).abs().max().item())
    for a, b in zip(raw, fused_elementwise_step(ucsv.update, params, cloud, y, seed=seed,
                                                normalize=False)):
        torch.testing.assert_close(a, b, **tol)
    moments = _normals_ok(torch, label, z)
    if key is not None:
        def plain():
            zz = torch.randn((3, m, n), generator=gen, device="cuda")
            return ucsv_propagate_reweight_plain(y, ge, gn, cloud, zz)
        res[key] = (time_ms(torch, lambda: ucsv_propagate_reweight(seed, y, ge, gn, cloud)),
                    time_ms(torch, plain),
                    *bound_ms(**propagate_cost(m, n, 3, 2, False, "ucsv", False)))
    return moments


def _k1_case(torch, u0, w, xs, label: str) -> None:
    """K1 on one cloud: ancestors and output bitwise its plain version's."""
    from sequential_monte_carlo_tpu_torch.kernels.resample_walk import (
        resample_gather,
        resample_gather_plain,
    )

    got, anc = resample_gather(u0, w, xs, return_ancestors=True)
    ref, anc_ref = resample_gather_plain(u0, w, xs)
    if not (torch.equal(anc, anc_ref) and torch.equal(got, ref)):
        raise AssertionError(f"{label}: differs from plain")


def check_one_row(torch, gen, k1, k3, k2, k2i, k2r, k6):
    """The kernels at M = 1, the rows of the per-θ filters, smoothers and
    CSMC: K1 (C = 1, 3, and the APF's C = 2 LG and C = 4 UC-SV clouds with
    their first-stage weights), K3 (C = 1), K2 normalized (UC-SV, LG dx=1
    with and without carry), K2 raw (LG dx=1) and K6 raw, at 1×1024 and
    1×8192, on a contiguous row, on unsqueezed and expanded views and on
    length-1 axes of stride 1 (as K1 returns a one-row cloud): ancestors
    bitwise the plain versions', K2 and K6 within 1e-5 of their plain
    versions fed the normals recovered from their state deltas (moments
    within 5 standard errors), K6 within 1e-5 of K2-UC-SV raw at the same
    seed. The contiguous row's times go into the kernels' results under
    "1xN" ("cC_1xN" for K1 at C ≠ 3)."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.kernels.resample_sorted import (
        resample_gather_sorted,
        resample_gather_sorted_plain,
    )
    from sequential_monte_carlo_tpu_torch.kernels.resample_walk import (
        resample_gather,
        resample_gather_plain,
    )

    y = torch.tensor(1.3, device="cuda")
    lg = smc.broadcast_model(smc.lg_model(torch.tensor(LG_THETA, device="cuda")))
    ucsv = smc.broadcast_model(smc.ucsv_model(torch.tensor(JAX_MEAN, device="cuda")))
    for n in (1024, 8192):
        key = f"1x{n}"
        for layout in ("contiguous", "unsqueeze", "expand", "size1_strides"):
            timed = layout == "contiguous"
            w = _as_row(torch.softmax(2.0 * torch.randn(n, generator=gen, device="cuda"), -1),
                        layout)
            u0 = torch.rand((1, 1), generator=gen, device="cuda")
            u = torch.sort(torch.rand((1, n), generator=gen, device="cuda"), -1).values
            for c in (3, 1, 2, 4):
                cloud, w_apf = k1_cloud(torch, gen, 1, n, c)
                xs = _as_row(cloud[0], layout)
                wc = w if w_apf is None else _as_row(w_apf[0], layout)
                _k1_case(torch, u0, wc, xs, f"one_row K1 {key} C={c} {layout}")
                if timed:
                    k1[key if c == 3 else f"c{c}_{key}"] = (
                        time_ms(torch, lambda: resample_gather(u0, wc, xs)),
                        time_ms(torch, lambda: resample_gather_plain(u0, wc, xs)),
                        *bound_ms(**resample_cost(1, n, c, grid=False)))
            xs = _as_row(torch.randn((1, n), generator=gen, device="cuda"), layout)
            got, anc = resample_gather_sorted(u, w, xs, return_ancestors=True)
            ref, anc_ref = resample_gather_sorted_plain(u, w, xs)
            if not (torch.equal(anc, anc_ref) and torch.equal(got, ref)):
                raise AssertionError(f"one_row K3 {key} {layout}: differs from plain")
            if timed:
                k3[key] = (time_ms(torch, lambda: resample_gather_sorted(u, w, xs)),
                           time_ms(torch, lambda: resample_gather_sorted_plain(u, w, xs)),
                           *bound_ms(**resample_cost(1, n, 1, grid=True)))
            carry = _as_row(torch.log_softmax(torch.randn(n, generator=gen, device="cuda"), -1),
                            layout)
            moments = {}
            for name, model, res, s, kw in (
                    ("ucsv", ucsv, k2, 3, {}), ("lg1", lg, k2i["lg1"], 1, {}),
                    ("lg1_carry", lg, k2i["lg1_carry"], 1, {"carry_logw": carry}),
                    ("lg1_raw", lg, k2r["lg1_raw"], 1, {"normalize": False})):
                state = torch.randn((s, n), generator=gen, device="cuda")
                state = _as_row(state * torch.tensor([1.0, 0.5, 0.5], device="cuda")[:s, None]
                                if name == "ucsv" else state, layout)
                moments[name] = _k2_case(torch, gen, name, model, res, state, y,
                                         f"one_row K2 {name} {key} {layout}",
                                         key if timed else None, **kw)
            cloud = _as_row(torch.randn((3, n), generator=gen, device="cuda")
                            * torch.tensor([1.0, 0.5, 0.5], device="cuda")[:, None], layout)
            moments["k6"] = _k6_case(torch, gen, ucsv, cloud, y, k6,
                                     f"one_row K6 {key} {layout}", key if timed else None)
            say("one_row", shape=key, layout=layout, k1="bitwise", k3="bitwise",
                k2_k6="within 1e-5", **{f"{k}_normals": v for k, v in moments.items()})
        say("one_row", shape=key, **{f"{name}_ms": round(res[k][0], 5) for name, res, k in (
            ("k1_c3", k1, key), ("k1_c1", k1, f"c1_{key}"), ("k1_c2", k1, f"c2_{key}"),
            ("k1_c4", k1, f"c4_{key}"), ("k3_c1", k3, key), ("k2_ucsv", k2, key),
            ("k2_lg1", k2i["lg1"], key), ("k2_lg1_carry", k2i["lg1_carry"], key),
            ("k2_lg1_raw", k2r["lg1_raw"], key), ("k6", k6, key))})


def check_bank_shapes(torch, gen, k1, k2, k2i, k2r, k6):
    """The kernels at the bank shapes the smoothing and pg phases give them:
    K1 C=3, K2-UC-SV normalized and K6 at 8×8192 (the posterior mixture's
    n_theta=8 bank, the pooled UC-SV particle-Gibbs chains), K2-LG
    normalized and raw at 8×128 (the pooled LG chains) and K2-LG raw at
    1×256 (the CSMC invariance runs): K1 bitwise its plain version under
    flat, skewed and point-mass weights (check_k1), K2 and K6 as in
    check_one_row, on θ-clouds of distinct rows. Times go into the kernels'
    results under "MxN"."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec

    key = f"{MIX_THETA}x{PG_N}"
    res = check_k1(torch, [(MIX_THETA, PG_N, 3)], gen)
    k1[key] = res[key]
    k1["max_abs_err"] = max(k1["max_abs_err"], res["max_abs_err"])
    theta = prior_from_spec(PRIOR_SPEC, device="cuda").sample(gen, (MIX_THETA,))
    theta[:, 0] = theta[:, 0].clamp(min=0.05)  # no row with a vol-of-vol too small to recover z
    ucsv = smc.ucsv_model(theta)
    y = torch.tensor(1.3, device="cuda")
    cloud = torch.randn((MIX_THETA, 3, PG_N), generator=gen, device="cuda")
    cloud[:, 0] += 3.0
    cloud[:, 1:] *= 0.5
    moments = {"k2_ucsv": _k2_case(torch, gen, "ucsv", ucsv, k2, cloud, y,
                                   f"bank K2 ucsv {key}", key),
               "k6": _k6_case(torch, gen, ucsv, cloud, y, k6, f"bank K6 {key}", key)}
    say("bank_shapes", shape=key, k1_c3="bitwise", k2_ucsv_k6="within 1e-5",
        k1_ms=round(k1[key][0], 5), k2_ucsv_ms=round(k2[key][0], 5), k6_ms=round(k6[key][0], 5),
        **{f"{k}_normals": v for k, v in moments.items()})
    lg = smc.lg_model(prior_from_spec(LG_PRIOR_SPEC, device="cuda").sample(gen, (PG_LG_CHAINS,)))
    y = torch.tensor(0.6, device="cuda")
    raw = ("lg1_raw", k2r["lg1_raw"], {"normalize": False})
    for m, n, cases in ((PG_LG_CHAINS, PG_LG_N, (("lg1", k2i["lg1"], {}), raw)),
                        (1, CSMC_N, (raw,))):
        model = lg if m > 1 else smc.broadcast_model(
            smc.lg_model(torch.tensor(LG_THETA, device="cuda")))
        moments = {}
        for name, out, kw in cases:
            state = torch.randn((m, 1, n), generator=gen, device="cuda")
            moments[name] = _k2_case(torch, gen, name, model, out, state, y,
                                     f"bank K2 {name} {m}x{n}", f"{m}x{n}", **kw)
        say("bank_shapes", shape=f"{m}x{n}", k2="within 1e-5",
            **{f"k2_{name}_ms": round(out[f"{m}x{n}"][0], 5) for name, out, _ in cases},
            **{f"{k}_normals": v for k, v in moments.items()})


def _counted(torch, fn):
    """(fn()'s result, wall-clock s, launch counts) of one run from counts
    at 0."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, launch_counts()


def _add(total, counts):
    return counts if total is None else {k: v + counts[k] for k, v in total.items()}


def check_per_theta(torch):
    """The per-θ filters (the batched layer at one row): log_likelihood on LG
    at θ* (T=100, N=1024) systematic (K1 + K2-LG), stratified at ESS < N/2
    (K3 + K2-LG carry) and apf_log_likelihood (K1 + K2-LG raw), PER_THETA_SEEDS
    runs each, log Z against the Kalman filter's by the delta method;
    filter_sequence on UC-SV at N=8192 (K1 + K2-UC-SV) with a
    weighted_quantile summarize, log Z against the JAX package's (FFBS_JAX);
    apf_log_likelihood on UC-SV at N=1024 (K1 + K6) against the JAX
    package's APF bank (UCSV_BANK_JAX); FFBS_SEEDS runs each of the UC-SV
    ones. Returns the runs' launch counts."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.analysis import weighted_quantile

    y = torch.tensor(lg_series(), device="cuda")
    a, q, r = LG_THETA
    target = smc.univariate_linear_gaussian(a, 1.0, q, r, x0=0.0, sigma0=(1.0 - q) / a**2)
    kz = smc.kalman_log_likelihood(target, y)[1].item()
    model = smc.lg_model(torch.tensor(LG_THETA, device="cuda"))
    seeds, total, steps = PER_THETA_SEEDS, None, DT_T - 1
    for label, fn, cfg, kernels in (
            ("systematic", smc.log_likelihood, smc.PFConfig("systematic", 1.0),
             ("resample_count", "fused_propagate_lg1")),
            ("stratified", smc.log_likelihood, smc.PFConfig("stratified", 0.5),
             ("resample_sorted", "fused_propagate_lg1_carry")),
            ("apf", smc.apf_log_likelihood, smc.PFConfig("systematic", 1.0),
             ("resample_count", "fused_propagate_lg1_raw"))):
        fn(torch.Generator(device="cuda").manual_seed(500), model, DT_N, y, cfg)  # warm-up
        lz, wall, counts = _counted(torch, lambda: torch.stack([
            fn(torch.Generator(device="cuda").manual_seed(600 + s), model, DT_N, y, cfg)[1]
            for s in range(seeds)]))
        expect_counts(f"per_theta (lg {label})", counts, {k: steps * seeds for k in kernels})
        check_delta(f"lg {label}", lz.double(), kz, wall, steps * seeds, "per_theta")
        total = _add(total, counts)

    # UC-SV at θ = JAX_MEAN, N = 8192: filter_sequence with a summarize
    ys, ps = series(torch, "cuda"), [0.05, 0.5, 0.95]
    ucsv = smc.ucsv_model(torch.tensor(JAX_MEAN, device="cuda"))

    def summarize(state):
        return weighted_quantile(state.particles[:, 0], torch.exp(state.log_weights), ps)

    def run_seq(seed):
        return smc.filter_sequence(torch.Generator(device="cuda").manual_seed(seed), ucsv,
                                   FFBS_N, ys, summarize=summarize)

    run_seq(700)  # warm-up
    outs, wall, counts = _counted(torch, lambda: [run_seq(800 + s) for s in range(FFBS_SEEDS)])
    expect_counts("per_theta (ucsv filter_sequence)", counts,
                  {k: (T - 1) * FFBS_SEEDS for k in ("resample_count", "fused_propagate_ucsv")})
    total = _add(total, counts)
    summary = torch.stack([o[2]["summary"] for o in outs])
    if summary.shape != (FFBS_SEEDS, T, 3) or not (torch.isfinite(summary).all() and torch.all(
            summary[..., 0] <= summary[..., 2])):
        raise AssertionError(f"per_theta (ucsv): summaries {tuple(summary.shape)} not finite"
                             " ordered quantiles")
    lz = torch.stack([o[1] for o in outs]).double()
    mean, var = lz.mean().item(), lz.var().item()
    se = math.sqrt(var / FFBS_SEEDS + FFBS_JAX["log_z_var"] / FFBS_JAX_SEEDS)
    if abs(mean - FFBS_JAX["log_z_mean"]) > 5 * se:
        raise AssertionError(f"per_theta (ucsv): mean log Z {mean} vs JAX"
                             f" {FFBS_JAX['log_z_mean']} beyond 5·{se}")
    say("per_theta", model="ucsv filter_sequence", n=FFBS_N, T=T, runs=FFBS_SEEDS,
        wall_s_per_run=round(wall / FFBS_SEEDS, 4), logz_mean=round(mean, 5),
        logz_var=round(var, 5), jax_logz_mean=FFBS_JAX["log_z_mean"], five_se=round(5 * se, 5),
        median_quantiles_last_t=np.round(summary[:, -1].median(0).values.cpu().numpy(), 4).tolist(),
        launches=(T - 1) * FFBS_SEEDS)

    # UC-SV APF at N = 1024 (K1 on the cloud with the lookahead plane + K6)
    def run_apf(seed):
        return smc.apf_log_likelihood(torch.Generator(device="cuda").manual_seed(seed), ucsv,
                                      DT_N, ys)[1]

    run_apf(900)  # warm-up
    seeds = FFBS_SEEDS
    lz, wall, counts = _counted(torch, lambda: torch.stack([run_apf(1000 + s)
                                                            for s in range(seeds)]))
    expect_counts("per_theta (ucsv apf)", counts,
                  {k: (T - 1) * seeds for k in ("resample_count", "ucsv_propagate")})
    total = _add(total, counts)
    lz = lz.double()
    mean, var = lz.mean().item(), lz.var().item()
    ref_mean, ref_var, ref_rows = UCSV_BANK_JAX["apf"]
    se = math.sqrt(var / seeds + ref_var / ref_rows)
    if abs(mean - ref_mean) > 5 * se:
        raise AssertionError(f"per_theta (ucsv apf): mean log Z {mean} vs JAX {ref_mean}"
                             f" beyond 5·{se}")
    say("per_theta", model="ucsv apf_log_likelihood", n=DT_N, T=T, runs=seeds,
        wall_s_per_run=round(wall / seeds, 4), logz_mean=round(mean, 5), logz_var=round(var, 5),
        jax_logz_mean=ref_mean, five_se=round(5 * se, 5), launches=(T - 1) * seeds)
    return total


def check_smoothing(torch, flagship):
    """(a) kalman_smooth and smoothed_marginals on LG at θ* (T=100, N=1024,
    the dense backward pass; K1 + K2-LG): FFBS_LG_SEEDS runs' smoothed means
    against RTS of the filter's target, within 5 standard errors of their
    mean at every t; (b) smoothed_marginals on UC-SV at θ = JAX_MEAN, N=8192
    (the blocked backward pass; K1 + K2-UC-SV): the smoothed means' window
    averages and log Z against the JAX package's (FFBS_JAX); (c)
    posterior_smoothed_paths from the 512×8192 SMC² state ``flagship``
    (n_theta=8, n_paths=64, N=8192: an 8-row bank through K1 + K2-UC-SV).
    Walls, and each backward pass timed alone. Returns the launch counts."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.ops.smoothing import backward_reweight

    def timed_backward(model, out):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lw = backward_reweight(model, out.particles, out.filter_log_weights)
        torch.cuda.synchronize()
        if not torch.equal(lw, out.log_weights):
            raise AssertionError("smoothing: the backward pass alone gave other weights")
        return time.perf_counter() - t0

    # (a) LG, dense
    y = torch.tensor(lg_series(), device="cuda")
    a, q, r = LG_THETA
    target = smc.univariate_linear_gaussian(a, 1.0, q, r, x0=0.0, sigma0=(1.0 - q) / a**2)
    ms, ps = smc.kalman_smooth(target, y)
    model = smc.lg_model(torch.tensor(LG_THETA, device="cuda"))
    smc.smoothed_marginals(torch.Generator(device="cuda").manual_seed(1100), model, DT_N, y)
    outs, wall, counts = _counted(torch, lambda: [smc.smoothed_marginals(
        torch.Generator(device="cuda").manual_seed(1200 + s), model, DT_N, y)
        for s in range(FFBS_LG_SEEDS)])
    steps = DT_T - 1
    expect_counts("smoothing (lg)", counts, {"resample_count": steps * FFBS_LG_SEEDS,
                                             "fused_propagate_lg1": steps * FFBS_LG_SEEDS})
    total = counts
    means = torch.stack([smc.smoothed_mean(o)[:, 0] for o in outs]).double()
    err = (means.mean(0) - ms[:, 0].double()).abs()
    se = means.std(0) / math.sqrt(FFBS_LG_SEEDS)
    if not torch.all(err <= 5 * se):
        raise AssertionError(f"smoothing (lg): smoothed mean off RTS by {err.max().item()}"
                             f" where 5 se is {(5 * se)[err.argmax()].item()}")
    say("smoothing", model="lg", route="dense", n=DT_N, T=DT_T, runs=FFBS_LG_SEEDS,
        wall_s_per_run=round(wall / FFBS_LG_SEEDS, 4),
        backward_s=round(timed_backward(model, outs[0]), 4),
        max_abs_err_vs_rts=round(err.max().item(), 5), max_err_in_se=round((err / se).max().item(), 3),
        rts_sd_mean=round(torch.sqrt(ps[:, 0, 0]).mean().item(), 4),
        launches=steps * FFBS_LG_SEEDS)

    # (b) UC-SV at N = 8192, blocked
    ys = series(torch, "cuda")
    ucsv = smc.ucsv_model(torch.tensor(JAX_MEAN, device="cuda"))
    out, wall, counts = _counted(torch, lambda: smc.smoothed_marginals(
        torch.Generator(device="cuda").manual_seed(1300), ucsv, FFBS_N, ys))
    expect_counts("smoothing (ucsv)", counts, {"resample_count": T - 1,
                                               "fused_propagate_ucsv": T - 1})
    total = _add(total, counts)
    smoothed = smc.smoothed_mean(out)
    win = window_means(smoothed.cpu().numpy())
    ref, ref_sd = np.asarray(FFBS_JAX["windows_mean"]), np.asarray(FFBS_JAX["windows_sd"])
    tol = TOL_Z * ref_sd * math.sqrt(1.0 + 1.0 / FFBS_JAX_SEEDS)
    lz_se = math.sqrt(FFBS_JAX["log_z_var"] * (1.0 + 1.0 / FFBS_JAX_SEEDS))
    if not (np.all(np.abs(win - ref) <= tol) and torch.isfinite(out.log_weights).any(-1).all()
            and abs(out.log_z.item() - FFBS_JAX["log_z_mean"]) <= TOL_Z * lz_se):
        raise AssertionError(f"smoothing (ucsv): windows {np.round(win, 4).tolist()}, log Z"
                             f" {out.log_z.item()} vs JAX {ref.tolist()} beyond {tol.tolist()}")
    say("smoothing", model="ucsv", route="blocked", n=FFBS_N, T=T, wall_s=round(wall, 4),
        backward_s=round(timed_backward(ucsv, out), 4), log_z=round(out.log_z.item(), 4),
        jax_log_z=FFBS_JAX["log_z_mean"],
        max_window_dev_in_tol=round(float((np.abs(win - ref) / tol).max()), 4), launches=T - 1)

    # (c) the posterior mixture from the flagship's θ-cloud: one 8-row bank
    paths, wall, counts = _counted(torch, lambda: smc.posterior_smoothed_paths(
        torch.Generator(device="cuda").manual_seed(1400), smc.ucsv_model, flagship.theta,
        flagship.log_omega, ys, FFBS_N, n_theta=MIX_THETA, n_paths=MIX_PATHS))
    expect_counts("smoothing (posterior paths)", counts, {"resample_count": T - 1,
                                                          "fused_propagate_ucsv": T - 1})
    total = _add(total, counts)
    dev = (paths[:, :, 0].mean(1) - smoothed[:, 0]).abs().mean().item()
    if paths.shape != (T, MIX_THETA * MIX_PATHS, 3) or not torch.isfinite(paths).all() or dev > 0.25:
        raise AssertionError(f"smoothing (posterior paths): shape {tuple(paths.shape)}, mean"
                             f" |path mean − smoothed mean at θ = JAX_MEAN| {dev}")
    say("smoothing", run="posterior_smoothed_paths", n_theta=MIX_THETA, n_paths=MIX_PATHS,
        n=FFBS_N, T=T, wall_s=round(wall, 4), mean_abs_dev_from_ucsv_smoothed_mean=round(dev, 4),
        launches=T - 1)
    return total


@contextlib.contextmanager
def graph_calls(torch):
    """Counts, into the dict it yields, the CUDA graphs the block launches
    (``CUDAGraph.replay``) and the host syncs that torch's sync debug mode
    reports in it: a torch op that waits for the device (a host read, a copy
    from pageable host memory); an explicit ``torch.cuda.synchronize`` is
    not counted."""
    import warnings

    calls = {"graph_launches": 0, "host_syncs": 0}
    replay = torch.cuda.CUDAGraph.replay

    def counted(self):
        calls["graph_launches"] += 1
        return replay(self)

    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.CUDAGraph.replay = counted
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            yield calls
        calls["host_syncs"] = sum("synchroniz" in str(w.message) for w in seen)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.CUDAGraph.replay = replay


def run_pg(torch, model_fn, prior_spec, y, cfg, seed: int, chains: int = 0):
    """One particle-Gibbs run from counts at 0: (result, wall s, counts, its
    graph launches and host syncs). With ``chains`` it runs that many chains
    as the rows of one bank (``model_fn`` then the θ-cloud's constructor),
    θ0 drawn from the prior first."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec
    from sequential_monte_carlo_tpu_torch.samplers.particle_gibbs import _particle_gibbs_bank

    prior = prior_from_spec(prior_spec, device="cuda")  # copied from the host: outside the run
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with graph_calls(torch) as calls:
        if not chains:
            out = _counted(torch, lambda: smc.particle_gibbs(gen, model_fn, prior, y, cfg))
        else:
            out = _counted(torch, lambda: _particle_gibbs_bank(gen, model_fn, prior, y, cfg,
                                                               prior.sample(gen, (chains,))))
    return out + (calls,)


def iterate_csmc(torch, model, y, method: str, sweeps: int = CSMC_SWEEPS):
    """Iterated csmc_sweep at fixed θ from the zero path, ``sweeps`` sweeps
    of CSMC_N particles: the path after each, stacked (sweeps, T) on the
    card."""
    import sequential_monte_carlo_tpu_torch as smc

    gen, paths = torch.Generator(device="cuda").manual_seed(1700), []
    path = torch.zeros((y.shape[0], 1), device="cuda")
    for _ in range(sweeps):
        path = smc.csmc_sweep(gen, model, CSMC_N, y, path, method=method).path
        paths.append(path[:, 0])
    return torch.stack(paths)


def check_pg(torch):
    """Particle Gibbs: (a) UC-SV at bench_pg.py's configuration (T=241,
    N=8192, 50 sweeps, chain=3), "bs" and "as": K6 at every CSMC step, the
    initial multinomial filter's K2-UC-SV. One chain through particle_gibbs:
    its acceptance within TOL_Z of the JAX package's seeds' (PG_JAX), its
    θ-chain mean after PG_BURN sweeps too (a tolerance near the prior's
    width: one chain of 50 sweeps from a prior draw spreads so widely, in
    the JAX package too). Then PG_CHAINS chains as one bank: their mean
    acceptance and pooled chain mean within TOL_Z standard errors of the
    difference from the JAX seeds' (sd·√(1/PG_CHAINS + 1/PG_JAX_SEEDS)).
    (b) LG at the JAX test's configuration (T=60, N=128, 400 sweeps,
    chain=3), PG_LG_CHAINS chains as one bank, their means pooled against the
    Kalman prior-IS oracle within the JAX test's 0.3 (one chain's mean
    spreads too widely for it, in the JAX package too: tools/jax_reference.py
    --run pg_lg); (c) iterated CSMC at θ* (N=256, 120 sweeps, "bs" and "as")
    against RTS. Returns the launch counts."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec

    ys, total = series(torch, "cuda"), None
    for method in ("bs", "as"):
        cfg = smc.PGConfig(n_particles=PG_N, sweeps=PG_SWEEPS, chain=PG_CHAIN, method=method)
        ref_stats = PG_JAX[method]
        ref, ref_sd = np.asarray(ref_stats["mean"]), np.asarray(ref_stats["sd"])
        for chains in (0, PG_CHAINS):
            res, wall, counts, calls = run_pg(torch, smc.ucsv_model, PRIOR_SPEC, ys, cfg, 1500,
                                              chains)
            expect_counts(f"pg (ucsv {method}, {max(chains, 1)} chains)", counts,
                          {"ucsv_propagate": (T - 1) * PG_SWEEPS, "fused_propagate_ucsv": T - 1})
            total = _add(total, counts)
            accs = res.acc_ratio.reshape(-1).cpu().numpy()
            means = res.theta[PG_BURN:].mean(0).reshape(-1, len(ref)).cpu().numpy()
            acc, mean = float(accs.mean()), means.mean(0)
            se = math.sqrt(1.0 / max(chains, 1) + 1.0 / PG_JAX_SEEDS)
            tol, acc_tol = TOL_Z * ref_sd * se, TOL_Z * ref_stats["acc_sd"] * se
            if not (abs(acc - ref_stats["acc_mean"]) <= acc_tol and torch.isfinite(res.theta).all()
                    and np.all(np.abs(mean - ref) <= tol)):
                raise AssertionError(
                    f"pg (ucsv {method}, {max(chains, 1)} chains): acceptance {accs} vs JAX"
                    f" {ref_stats['acc_mean']} ± {acc_tol}, chain mean {mean} vs JAX"
                    f" {ref.tolist()} beyond {tol.tolist()}")
            say("pg", model="ucsv", method=method, chains=max(chains, 1), n=PG_N, T=T,
                sweeps=PG_SWEEPS, chain=PG_CHAIN, wall_s=round(wall, 4),
                sweeps_per_s=round(PG_SWEEPS / wall, 3),
                particle_steps_per_s=round(max(chains, 1) * PG_SWEEPS * T * PG_N / wall),
                acc_ratio=round(acc, 4), acc_ratios=np.round(accs, 4).tolist(),
                jax_acc=ref_stats["acc_mean"], acc_tolerance=round(acc_tol, 5),
                chain_mean=np.round(mean, 5).tolist(), jax_mean=ref.tolist(),
                tolerance=np.round(tol, 5).tolist(), launches_k6=(T - 1) * PG_SWEEPS, **calls)

    # (b) LG: chains pooled against the prior-IS oracle
    y = torch.tensor(lg_series(PG_LG_T), device="cuda")
    prior = prior_from_spec(LG_PRIOR_SPEC, device="cuda")
    theta = prior.sample(torch.Generator(device="cuda").manual_seed(77), (100_000,))
    _, lz = smc.kalman_log_likelihood(smc.lg_model(theta), y)
    oracle = (torch.softmax(lz.double(), 0) @ theta.double()).cpu().numpy()
    cfg = smc.PGConfig(n_particles=PG_LG_N, sweeps=PG_LG_SWEEPS, chain=PG_CHAIN)
    res, wall, counts, calls = run_pg(torch, smc.lg_model, LG_PRIOR_SPEC, y, cfg, 1600,
                                      PG_LG_CHAINS)
    expect_counts("pg (lg)", counts, {"fused_propagate_lg1_raw": (PG_LG_T - 1) * PG_LG_SWEEPS,
                                      "fused_propagate_lg1": PG_LG_T - 1})
    total = _add(total, counts)
    means = res.theta[PG_LG_BURN:].mean(0).cpu().numpy()
    accs = res.acc_ratio.cpu().numpy()
    pooled = means.mean(0)
    if not (np.all(np.abs(pooled - oracle) < 0.3) and np.all((0.1 < accs) & (accs < 0.6))):
        raise AssertionError(f"pg (lg): pooled chain mean {pooled} vs oracle {oracle},"
                             f" acceptances {accs}")
    say("pg", model="lg", n=PG_LG_N, T=PG_LG_T, sweeps=PG_LG_SWEEPS, chains=PG_LG_CHAINS,
        wall_s=round(wall, 4), acc=np.round(accs, 4).tolist(),
        chain_means=np.round(means, 4).tolist(), pooled=np.round(pooled, 4).tolist(),
        oracle=np.round(oracle, 4).tolist(), **calls)

    # (c) CSMC invariance at θ* against RTS of the filter's target
    y = torch.tensor(lg_series(CSMC_T), device="cuda")
    a, q, r = LG_THETA
    target = smc.univariate_linear_gaussian(a, 1.0, q, r, x0=0.0, sigma0=(1.0 - q) / a**2)
    ms, ps = smc.kalman_smooth(target, y)
    ms, sd = ms[:, 0].cpu().numpy(), torch.sqrt(ps[:, 0, 0]).cpu().numpy()
    model = smc.lg_model(torch.tensor(LG_THETA, device="cuda"))
    for method in ("bs", "as"):
        with graph_calls(torch) as calls:
            paths, wall, counts = _counted(torch, lambda: iterate_csmc(torch, model, y, method))
        expect_counts(f"pg (csmc {method})", counts, {"fused_propagate_lg1_raw": (CSMC_T - 1) * CSMC_SWEEPS})
        total = _add(total, counts)
        pooled = paths[CSMC_BURN:].mean(0).cpu().numpy()
        err = np.abs(pooled - ms) / sd
        if not (err.max() < 0.75 and err.mean() < 0.3):
            raise AssertionError(f"pg (csmc {method}): pooled path mean off RTS by"
                                 f" {err.max()} sd (mean {err.mean()})")
        say("pg", run="csmc invariance", method=method, n=CSMC_N, T=CSMC_T, sweeps=CSMC_SWEEPS,
            wall_s=round(wall, 4), max_err_sd=round(float(err.max()), 4),
            mean_err_sd=round(float(err.mean()), 4), **calls)
    return total


# -- phases 23 to 25: the DSL, the inflation example, the utils ---------------

def ucsv_dsl(smc, torch):
    """UC-SV written with ``ssm_model`` in ucsv_model's θ layout (γ shared,
    x0, log σε0, log ση0; sequential_monte_carlo_tpu/models/ucsv.py:141-152):
    no fused kernel, so the filters propagate it by plain tensor code."""
    normal = smc.Normal
    return smc.ssm_model(
        "ucsv_dsl", params=("gamma", "x0", "lse0", "lsn0"),
        init=lambda p: dict(x=normal(p["x0"], torch.exp(0.5 * p["lse0"])),
                            lse=normal(p["lse0"], p["gamma"]),
                            lsn=normal(p["lsn0"], p["gamma"])),
        transition=lambda p, prev: dict(x=normal(prev["x"], torch.exp(0.5 * prev["lse"])),
                                        lse=normal(prev["lse"], p["gamma"]),
                                        lsn=normal(prev["lsn"], p["gamma"])),
        observe=lambda p, s: normal(s["x"], torch.exp(0.5 * s["lsn"])))


def ar1_dsl(smc, torch):
    """lg_model's AR(1) written with ``ssm_model`` (no fused kernel)."""
    normal = smc.Normal
    return smc.ssm_model(
        "ar1_dsl", params=("a", "q", "r"),
        init=lambda p: dict(x=normal(0.0, 1.0)),
        transition=lambda p, prev: dict(x=normal(p["a"] * prev["x"], torch.sqrt(p["q"]))),
        observe=lambda p, s: normal(s["x"], torch.sqrt(p["r"])))


def ar1_linear(smc):
    """lg_model's AR(1) declared with ``linear_ssm_model``: the port's
    LinearGaussianModel, with K2-LG and the Kalman filter."""
    return smc.linear_ssm_model(
        "ar1_linear", params=("a", "q", "r"), A=lambda p: p["a"], B=lambda p: 1.0,
        Q=lambda p: p["q"], R=lambda p: p["r"], x0=lambda p: 0.0, sigma0=lambda p: 1.0)


def check_dsl(torch, native_ms_per_step: float, kind: str):
    """(a) online SMC² on UC-SV written with the DSL at the slice's
    configuration (512×1024, T=241, chain=5, bench.py's prior and series):
    K1 at every inner step of the schedule, no propagate kernel, posterior
    mean against JAX_MEAN as the slice's; (b) 512 DSL UC-SV filters at θ =
    JAX_MEAN, bootstrap and APF (K1 on the cloud with the lookahead plane),
    log Z against UCSV_BANK_JAX; (c) density-tempered SMC on the dt phase's
    configuration with the AR(1) declared by linear_ssm_model (K1 + K2-LG),
    posterior against DT_JAX_MEAN; (d) 512 filters of the AR(1) written with
    ssm_model, systematic (K1) and stratified at ESS < N/2 (K3), log Z
    against the Kalman filter's. Each replays graphs (the DSL's plain
    propagate route captured): (a) one an online step plus each
    rejuvenation's masked filters', (b) and (d) a masked filter's; each
    line with its graph launches, held against that count, and host syncs.
    The wall per inner step of (a) is printed beside the native UC-SV
    slice's (``native_ms_per_step``) and the card's name. Returns the runs'
    launch counts."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec

    # (a) SMC² on the DSL UC-SV
    y = series(torch, "cuda")
    cfg = smc.SMCConfig(n_particles=1024, n_theta=512, chain=CHAIN, ess_threshold=0.5,
                        inner=smc.PFConfig("systematic", 1.0))
    sampler = smc.SMC2(ucsv_dsl(smc, torch), prior_from_spec(PRIOR_SPEC, device="cuda"), cfg)
    with graph_calls(torch) as calls:
        (state, infos), wall, counts = _counted(
            torch, lambda: sampler.run(torch.Generator(device="cuda").manual_seed(SEED), y))
    steps = _schedule(infos, CHAIN, [])
    expect_counts("dsl (ucsv smc2)", counts, {"resample_count": steps})
    rejuv_t = (torch.nonzero(infos.rejuvenated).flatten() + 1).tolist()
    expect_graph_launches("dsl (ucsv smc2)", calls, len(infos.ess) + sum(
        CHAIN * filter_graph_launches(t - 1) for t in rejuv_t))
    total = counts
    mean = smc.expected_parameters(state).cpu().numpy()
    tol = TOL_Z * np.asarray(JAX_SD) * math.sqrt(1.0 + 1.0 / JAX_SEEDS)
    if not (math.isfinite(state.ess.item()) and np.all(np.abs(mean - np.asarray(JAX_MEAN)) <= tol)):
        raise AssertionError(f"dsl (ucsv smc2): posterior mean {mean} vs JAX {JAX_MEAN}"
                             f" beyond {tol}")
    say("dsl", model="ucsv via ssm_model", shape="512x1024", T=T, chain=CHAIN,
        wall_s=round(wall, 4), rejuvenations=int(infos.rejuvenated.sum()), launches=steps,
        graph_launches=calls["graph_launches"], host_syncs=calls["host_syncs"],
        posterior_mean=np.round(mean, 5).tolist(), jax_mean=JAX_MEAN,
        tolerance=np.round(tol, 5).tolist())
    say("dsl", wall_ms_per_inner_step=round(1e3 * wall / steps, 5),
        native_wall_ms_per_inner_step=round(native_ms_per_step, 5),
        ratio=round(1e3 * wall / steps / native_ms_per_step, 3), card=repr(kind))

    # (b) 512 DSL UC-SV filters, bootstrap and APF
    models = ucsv_dsl(smc, torch)(torch.tensor(JAX_MEAN, device="cuda").expand(DT_M, 4))
    for i, alg in enumerate(("bootstrap", "apf")):
        calls = {}
        lz, wall, counts = run_filters(torch, models, y, ("systematic", 1.0, None, alg), 40 + i,
                                       calls=calls)
        expect_counts(f"dsl (ucsv bank, {alg})", counts, {"resample_count": T - 1})
        expect_graph_launches(f"dsl (ucsv bank, {alg})", calls, filter_graph_launches(T - 1))
        total = _add(total, counts)
        mean, var = lz.mean().item(), lz.var().item()
        ref_mean, ref_var, ref_rows = UCSV_BANK_JAX[alg]
        se = math.sqrt(var / DT_M + ref_var / ref_rows)
        if abs(mean - ref_mean) > 5 * se:
            raise AssertionError(f"dsl (ucsv bank, {alg}): mean log Z {mean} vs JAX {ref_mean}"
                                 f" beyond 5·{se}")
        say("dsl", model="ucsv via ssm_model", filter=alg, rows=DT_M, n=DT_N, T=T,
            wall_s=round(wall, 4), logz_mean=round(mean, 5), logz_var=round(var, 5),
            jax_logz_mean=ref_mean, five_se=round(5 * se, 5), launches=T - 1,
            graph_launches=calls["graph_launches"], host_syncs=calls["host_syncs"])

    # (c) the AR(1) declared by linear_ssm_model in density-tempered SMC
    total = _add(total, check_dt(torch, "linear_ssm_model", ("systematic", 1.0),
                                 "resample_count", "fused_propagate_lg1", ar1_linear(smc),
                                 "dsl")[0])

    # (d) 512 filters of the AR(1) written with ssm_model
    y = torch.tensor(lg_series(), device="cuda")
    a, q, r = LG_THETA
    target = smc.univariate_linear_gaussian(a, 1.0, q, r, x0=0.0, sigma0=(1.0 - q) / a**2)
    kz = smc.kalman_log_likelihood(target, y)[1].item()
    models = ar1_dsl(smc, torch)(torch.tensor(LG_THETA, device="cuda").expand(DT_M, 3))
    for i, (label, inner, kernel) in enumerate((
            ("systematic", ("systematic", 1.0), "resample_count"),
            ("stratified ess<N/2", ("stratified", 0.5), "resample_sorted"))):
        calls = {}
        lz, wall, counts = run_filters(torch, models, y, inner, 50 + i, calls=calls)
        expect_counts(f"dsl (ar1 {label})", counts, {kernel: DT_T - 1})
        expect_graph_launches(f"dsl (ar1 {label})", calls, filter_graph_launches(DT_T - 1))
        check_delta(f"ar1 via ssm_model, {label}", lz, kz, wall, DT_T - 1, "dsl",
                    graph_launches=calls["graph_launches"], host_syncs=calls["host_syncs"])
        total = _add(total, counts)
    return total


def check_inflation(torch, gen, k1, k2i):
    """The port's inflation example at --full sizes (UC 512×1024 chain 3,
    UC-SV 512×8192 chain 5) without figures, through its public functions:
    launch counts (each model's online schedule plus T − 1 steps each for
    the filter at θ̂, the FFBS forward pass and the posterior mixture's
    8-row bank); θ̂ of both models against the JAX package's 8-seed means
    (INFLATION_*_JAX); at the UC θ̂ the filtered quartiles against the
    Kalman filter's Gaussian quartiles and the FFBS smoothed trend against
    kalman_smooth, within the Monte-Carlo bounds of
    tests/test_torch_examples.py; then K1 (C=1) and K2-LG dx=1 at the UC
    posterior mixture's 8×1024 against their plain versions. Prints the
    loader, the rejuvenations and the walls of each part. Returns the launch
    counts."""
    import tempfile

    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.examples import inflation as ex

    outdir = tempfile.mkdtemp(prefix="smc_inflation_")
    out, wall, counts = _counted(torch, lambda: ex.run_example(ex.FULL_SIZES, outdir,
                                                               figures=False, device="cuda"))
    sched = {name: _schedule(out[name]["online"]["infos"], ex.FULL_SIZES[name][2], [])
             for name in ("uc", "ucsv")}
    expect_counts("inflation", counts, {
        "resample_count": sched["uc"] + sched["ucsv"] + 6 * (T - 1),
        "fused_propagate_lg1": sched["uc"] + 3 * (T - 1),
        "fused_propagate_ucsv": sched["ucsv"] + 3 * (T - 1)})
    for name, ref_mean, ref_sd in (("uc", INFLATION_UC_JAX_MEAN, INFLATION_UC_JAX_SD),
                                   ("ucsv", INFLATION_UCSV_JAX_MEAN, INFLATION_UCSV_JAX_SD)):
        res = out[name]
        th = res["online"]["theta_hat"].cpu().numpy()
        tol = TOL_Z * np.asarray(ref_sd) * math.sqrt(1.0 + 1.0 / JAX_SEEDS)
        if not np.all(np.abs(th - np.asarray(ref_mean)) <= tol):
            raise AssertionError(f"inflation ({name}): θ̂ {th} vs JAX {ref_mean} beyond {tol}")
        n, m, chain = ex.FULL_SIZES[name]
        say("inflation", model=name, shape=f"{m}x{n}", chain=chain, loader=out["loader"],
            rejuvenations=res["online"]["rejuvenations"], inner_steps=sched[name],
            theta_hat=np.round(th, 5).tolist(), jax_mean=ref_mean,
            tolerance=np.round(tol, 5).tolist(), online_wall_s=round(res["online"]["wall_s"], 4),
            filter_wall_s=round(res["pf"]["filter_wall_s"], 4),
            ffbs_wall_s=round(res["pf"]["ffbs_wall_s"], 4),
            postmix_wall_s=round(res["postmix"]["wall_s"], 4), logz_at_theta_hat=round(
                res["pf"]["logz"], 4))
    say("inflation", total_wall_s=round(wall, 4))

    # the UC model at θ̂ against the exact filter and smoother of its target
    x0, se, sn = out["uc"]["online"]["theta_hat"].tolist()
    target = smc.univariate_linear_gaussian(1.0, 1.0, se, sn, x0=x0, sigma0=0.0)
    y = ex.load_pce("cuda")[1]
    ms, ps, _, _ = smc.kalman_filter(target, y)
    m_, s_ = ms[:, 0].cpu().numpy(), torch.sqrt(ps[:, 0, 0]).cpu().numpy()
    pf = out["uc"]["pf"]
    filt = np.abs(pf["xq"] - (m_[:, None] + s_[:, None] * INFLATION_Z_QUARTILES)) / s_[:, None]
    rm, rp = smc.kalman_smooth(target, y)
    smooth = np.abs(pf["trend"] - rm[:, 0].cpu().numpy()) / torch.sqrt(rp[:, 0, 0]).cpu().numpy()
    if not (filt.mean() < INFLATION_FILTER_TOL and smooth.mean() < INFLATION_SMOOTH_TOL):
        raise AssertionError(f"inflation (uc at θ̂): mean |error| {filt.mean()} filtered,"
                             f" {smooth.mean()} smoothed (sd units) beyond"
                             f" {INFLATION_FILTER_TOL}, {INFLATION_SMOOTH_TOL}")
    say("inflation", model="uc at θ̂ vs Kalman", n=ex.FULL_SIZES["uc"][0],
        filtered_quartiles_mean_abs_err_sd=round(float(filt.mean()), 5),
        smoothed_trend_mean_abs_err_sd=round(float(smooth.mean()), 5),
        bounds=[INFLATION_FILTER_TOL, INFLATION_SMOOTH_TOL])

    # K1 C=1 and K2-LG dx=1 at the UC posterior mixture's bank shape
    key = f"{MIX_THETA}x{ex.FULL_SIZES['uc'][0]}"
    res = check_k1(torch, [(MIX_THETA, ex.FULL_SIZES["uc"][0], 1)], gen)
    k1[f"c1_{key}"] = res[f"c1_{key}"]
    k1["max_abs_err"] = max(k1["max_abs_err"], res["max_abs_err"])
    lg = smc.uc_model(out["uc"]["online"]["state"].theta[:MIX_THETA])
    state = torch.randn((MIX_THETA, 1, ex.FULL_SIZES["uc"][0]), generator=gen, device="cuda")
    moments = _k2_case(torch, gen, "lg1", lg, k2i["lg1"], state, torch.tensor(2.0, device="cuda"),
                       f"inflation K2 lg1 {key}", key)
    say("inflation", shape=key, k1_c1="bitwise", k2_lg1="within 1e-5",
        k1_c1_ms=round(k1[f"c1_{key}"][0], 5), k2_lg1_ms=round(k2i["lg1"][key][0], 5),
        k2_lg1_normals=moments)
    return counts


def check_utils(torch):
    """(a) Checkpoint: two uninterrupted run_segmented runs of the UC-SV
    slice at 512×1024 (seed SEED + 2) agree bitwise; a third, split at t=120
    by save_checkpoint/load_checkpoint (a file, the generator's state
    included, the state read back against a fresh template) and resumed,
    ends bitwise equal to them (θ, log ω, log Z, particles, log-weights),
    and the restored cloud's storage is planar. (b) debug_nans raises on a
    NaN made on the card and names the op. (c) profiling.trace of 512 LG
    filters (K1 + K2-LG) writes a trace holding K1's and K2's launches.
    Returns the runs' launch counts."""
    import tempfile

    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec
    from sequential_monte_carlo_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from sequential_monte_carlo_tpu_torch.utils.debug import debug_nans
    from sequential_monte_carlo_tpu_torch.utils.profiling import trace

    y = series(torch, "cuda")
    cfg = smc.SMCConfig(n_particles=1024, n_theta=512, chain=CHAIN, ess_threshold=0.5)
    sampler = smc.SMC2(smc.ucsv_model, prior_from_spec(PRIOR_SPEC, device="cuda"), cfg)
    fields = ("theta", "log_omega", "log_z", "particles", "log_w")
    tmp = tempfile.mkdtemp(prefix="smc_utils_")

    def gen():
        return torch.Generator(device="cuda").manual_seed(SEED + 2)

    def whole():
        return sampler.run_segmented(gen(), y, segment_size=16)[0]

    def split():
        g = gen()
        mid, _ = sampler.run_segmented(g, y, segment_size=16, max_steps=119)
        path = f"{tmp}/mid.pt"
        save_checkpoint(path, mid, g)
        g2 = torch.Generator(device="cuda").manual_seed(987)
        back = load_checkpoint(path, sampler.init(torch.Generator(device="cuda").manual_seed(1),
                                                  y), generator=g2)
        if not back.particles.transpose(1, 2).is_contiguous() or back.t != 120:
            raise AssertionError("utils: the restored state lost its planar storage or its t")
        return sampler.run_segmented(g2, y, segment_size=16, state=back)[0]

    (a, b, c), wall, counts = _counted(torch, lambda: (whole(), whole(), split()))
    same = {f: torch.equal(getattr(a, f), getattr(b, f)) for f in fields}
    if not all(same.values()):
        raise AssertionError(f"utils: two uninterrupted runs at one seed differ: {same}")
    resumed = {f: torch.equal(getattr(a, f), getattr(c, f)) for f in fields}
    if not all(resumed.values()):
        raise AssertionError(f"utils: the checkpointed resume differs: {resumed}")
    say("utils", checkpoint="run_segmented 512x1024 split at t=120, resumed bitwise",
        uninterrupted_runs_bitwise=True, planar=True, wall_s_three_runs=round(wall, 4))

    x = torch.tensor([1.0, -1.0], device="cuda")
    try:
        with debug_nans():
            torch.log(x)
    except FloatingPointError as e:
        if "log" not in str(e):
            raise AssertionError(f"utils: debug_nans raised without naming the op: {e}")
        say("utils", debug_nans=repr(str(e)))
    else:
        raise AssertionError("utils: debug_nans let a NaN from the card through")

    models = smc.lg_model(torch.tensor(LG_THETA, device="cuda").expand(DT_M, 3))
    yl = torch.tensor(lg_series(10), device="cuda")
    reset_counts()
    with trace(f"{tmp}/trace"):
        smc.batched_log_likelihood(torch.Generator(device="cuda").manual_seed(3), models, DT_N,
                                   DT_M, yl)
        torch.cuda.synchronize()
    counts = _add(counts, launch_counts())
    with open(f"{tmp}/trace/trace.json") as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {k: sum(k in name for name in kernels) for k in ("resample_count", "step_kernel")}
    if not all(v >= 9 for v in found.values()):
        raise AssertionError(f"utils: the trace holds {found} launches of K1 and K2, not 9 each")
    say("utils", trace_kernel_events=len(kernels), k1_events=found["resample_count"],
        k2_events=found["step_kernel"])
    return counts


def _record_shards(seen: set) -> None:
    """Wrap the kernel wrappers where the filter calls them so that each
    launch on the card adds (kernel, rows, row_offset, first slot or
    particle, slots or particles) to ``seen``: K1's slot window, K3's grid
    width, and K2's and K6's particle_offset and particles."""
    import sequential_monte_carlo_tpu_torch.models.linear_gaussian as mlg
    import sequential_monte_carlo_tpu_torch.models.ucsv as mucsv
    import sequential_monte_carlo_tpu_torch.ops.batched_filter as bf

    def wrap(module, name, label, rows_of, offset_of):
        fn = getattr(module, name)

        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            rows = rows_of(*args)
            if rows.is_cuda:
                seen.add((label, rows.shape[0], *offset_of(args, kw)))
            return out
        setattr(module, name, wrapped)

    wrap(bf, "resample_gather", "resample_count", lambda u, w, xs, *a: xs,
         lambda a, kw: (None, kw.get("slot_lo", 0), kw.get("n_out") or a[2].shape[2]))
    wrap(bf, "resample_gather_sorted", "resample_sorted", lambda u, w, xs, *a: xs,
         lambda a, kw: (None, None, a[0].shape[1]))
    for module, label in ((mucsv, "fused_propagate_ucsv"), (mlg, "fused_propagate_lg")):
        wrap(module, "fused_elementwise_step", label, lambda up, p, st, *a: st,
             lambda a, kw: (kw.get("row_offset", 0), kw.get("particle_offset", 0),
                            a[2].shape[2]))
    wrap(mucsv, "ucsv_propagate_reweight", "ucsv_propagate", lambda sd, y, ge, gn, c, *a: c,
         lambda a, kw: (kw.get("row_offset", 0), kw.get("particle_offset", 0), a[4].shape[2]))


def _theta_fields(state) -> dict:
    return {k: getattr(state, k).cpu().numpy() for k in ("theta", "log_omega", "log_z", "ess")}


def _routes_now() -> dict:
    """Every cached route (kept alive, so no id is reused) with its kind,
    graph launches, segment launches and cuts a step."""
    from sequential_monte_carlo_tpu_torch.ops import graphs

    return {id(r): (r, key[0], r.replays, r.segment_replays, r.cuts)
            for key, r in graphs._cache.items()}


def _routes_since(before: dict) -> dict:
    """The graph and segment launches of the routes since ``before``
    (:func:`_routes_now`), and the cuts a step of each kind of route that
    launched."""
    graph = segment = 0
    cuts: dict = {}
    for rid, (_, kind, replays, segments, cut) in _routes_now().items():
        _, _, r0, s0, _ = before.get(rid, (None, None, 0, 0, 0))
        graph, segment = graph + replays - r0, segment + segments - s0
        if replays > r0:
            cuts.setdefault(kind, set()).add(cut)
    return {"graph_launches": graph, "segment_launches": segment,
            "cuts": {k: sorted(v) for k, v in sorted(cuts.items())}}


def mesh_graph_launches(rec: dict, online_steps: int, rejuv_t, chain: int, doubled_at=(),
                        filters: int = 0, live: int = 0) -> tuple:
    """(graph, segment) launches of a replayed mesh run: one an online step,
    each masked filter's over its live steps — ⌊L/S⌋ + L mod S where the
    step has no cut, L where it has (one step a launch) — ``chain`` filters
    over t − 1 steps at each rejuvenation at t, one over t − 1 at each
    doubling, and ``filters`` more over ``live`` (density-tempered SMC's);
    each launch one segment more than its cuts."""
    cuts = rec["cuts"]
    masked_cut, online_cut = cuts.get("masked", [0])[0], cuts.get("online", [0])[0]
    per = (lambda n: n) if masked_cut else filter_graph_launches
    masked = (sum(chain * per(t - 1) for t in rejuv_t) + sum(per(t - 1) for t in doubled_at)
              + filters * per(live))
    return (online_steps + masked,
            online_steps * (online_cut + 1) + masked * (masked_cut + 1))


def _twin(label: str, got: dict, want: dict, rec: dict, erec: dict) -> None:
    """Fail unless a replayed run's fields equal its disable_graphs()
    twin's bit for bit, with the same kernel launches and collectives
    (calls and bytes; where the twin ran the whole run)."""
    for k, v in want.items():
        if not np.array_equal(got[k], v):
            raise AssertionError(f"{label}: {k} differs between the replayed run and its "
                                 "disable_graphs() twin")
    if rec is not None:
        plain = {k: v for k, v in rec["collectives"].items() if not k.endswith("_s")}
        if rec["counts"] != erec["counts"] or plain != {
                k: v for k, v in erec["collectives"].items() if not k.endswith("_s")}:
            raise AssertionError(f"{label}: launches or collectives {rec['counts']} "
                                 f"{rec['collectives']} differ from the twin's "
                                 f"{erec['counts']} {erec['collectives']}")


def parallel_worker(argv) -> int:
    """One rank of the parallel phase: ``chip_smoke.py --parallel-worker
    JOBS RANK WORLD BACKEND STORE OUT``. Runs the comma-separated JOBS on
    cuda:0 (LOCAL_RANK unset: rank % the card count) and writes
    OUT/RANK.npz (each job's whole θ-level fields) and OUT/RANK.json (launch
    counts, the shards seen, walls, collectives)."""
    import torch

    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch import parallel
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec
    from sequential_monte_carlo_tpu_torch.ops import graphs
    from sequential_monte_carlo_tpu_torch.ops.batched_filter import as_cloud
    from sequential_monte_carlo_tpu_torch.ops.sharding import (
        all_gather_rows,
        collective_stats,
        theta_rows,
    )

    jobs, rank, world, backend, store, out = argv[0].split(","), int(argv[1]), int(argv[2]), \
        argv[3], argv[4], argv[5]
    torch.backends.cuda.matmul.allow_tf32 = False
    device = parallel.initialize_distributed(init_method=f"file://{store}", num_processes=world,
                                             process_id=rank, backend=backend, timeout_s=300.0)
    mesh = parallel.make_mesh()
    seen: set = set()
    _record_shards(seen)
    arrays, meta = {}, {"device": str(device), "info": parallel.process_info()}
    y = series(torch, device)

    def timed(fn, eager=False):
        """fn() replayed (or, with ``eager``, inside disable_graphs()): its
        wall, launch counts, the shards seen since the job began, the
        collectives, the routes' graph and segment launches and cuts, and
        the graph pool after it."""
        torch.cuda.synchronize()
        reset_counts()
        collective_stats.clear()
        before = _routes_now()
        t0 = time.perf_counter()
        with smc.disable_graphs() if eager else contextlib.nullcontext():
            res = fn()
        torch.cuda.synchronize()
        return res, {"wall_s": time.perf_counter() - t0, "counts": launch_counts(),
                     "seen": sorted(map(list, seen), key=str),
                     "collectives": {k: round(v, 6) for k, v in collective_stats.items()},
                     **_routes_since(before), "pool_mb": round(_graph_pool_mb(torch), 1)}

    def split_run(sh, gen, cut):
        """run_segmented to P_TWIN_T, then on to the bound ``cut`` (None: the
        whole T), bitwise the unsplit run. Returns (state, infos, the θ-level
        fields at P_TWIN_T)."""
        st, infos = sh.run_segmented(gen, y, max_steps=P_TWIN_T - 1)
        mid = _theta_fields(st)
        st, rest = sh.run_segmented(gen, y, state=st,
                                    max_steps=None if cut is None else cut - (P_TWIN_T - 1))
        return st, type(infos)(*(torch.cat([a, b]) for a, b in zip(infos, rest))), mid

    def twin_to(sh, job, mid):
        """The disable_graphs() twin of a split run to P_TWIN_T: bitwise its
        fields there; its record (``<job>_eager``)."""
        (st, infos), erec = timed(lambda: sh.run_segmented(
            torch.Generator(device=device).manual_seed(SEED), y, max_steps=P_TWIN_T - 1),
            eager=True)
        _twin(f"{job} rank {rank}", _theta_fields(st), mid, None, None)
        erec["inner_steps"], erec["t"] = _schedule(infos, CHAIN, []), st.t
        meta[f"{job}_eager"] = erec

    for job in jobs:
        seen.clear()
        graphs.clear_graphs()  # the pool a job reports holds its own routes
        if job.startswith("mesh"):  # the jobs after it run on a (θ, particle) mesh
            mesh = parallel.make_mesh(*map(int, job[len("mesh"):].split("x")))
            meta["mesh"] = list(mesh.shape)
            meta["coords"] = [mesh.get_local_rank(0), mesh.get_local_rank(1)]
        elif job.startswith("pslice"):  # pslice<M>x<N>[:<steps>]
            shape, _, steps = job[len("pslice"):].partition(":")
            m, n = map(int, shape.split("x"))
            cfg = smc.SMCConfig(n_particles=n, n_theta=m, chain=CHAIN,
                                ess_threshold=0.5, inner=smc.PFConfig("systematic", 1.0))
            sh = parallel.ShardedSMC2(smc.SMC2(smc.ucsv_model, prior_from_spec(
                PRIOR_SPEC, device=device), cfg), mesh)
            cut = int(steps) - 1 if steps else None
            # a short run first: the kernels and the collectives warm, and
            # its wall per inner step is the first reading
            (_, infos), rec = timed(lambda: sh.run_segmented(
                torch.Generator(device=device).manual_seed(SEED + 1), y, max_steps=2))
            rec["inner_steps"] = _schedule(infos, CHAIN, [])
            meta[f"{job}_first"] = rec
            gen = torch.Generator(device=device).manual_seed(SEED)
            (state, infos, mid), rec = timed(lambda: split_run(sh, gen, cut))
            rec["inner_steps"] = _schedule(infos, CHAIN, [])
            rec["rejuv_t"] = (infos.rejuvenated.nonzero().flatten() + 1).tolist()
            rec["t"] = state.t
            meta[job] = rec
            arrays.update({f"{job}/{k}": v for k, v in _theta_fields(state).items()})
            twin_to(sh, job, mid)
        elif job.startswith("papf"):  # papf[<N>]: the APF's SMC² on UC-SV, cut at P_STEPS
            sh = parallel.ShardedSMC2(particle_apf_sampler(
                torch, device, int(job[len("papf"):] or DT_N)), mesh)
            (state, infos, mid), rec = timed(lambda: split_run(
                sh, torch.Generator(device=device).manual_seed(SEED), P_STEPS - 1))
            rec["inner_steps"] = _schedule(infos, CHAIN, [])
            rec["rejuv_t"] = (infos.rejuvenated.nonzero().flatten() + 1).tolist()
            meta[job] = rec
            arrays.update({f"{job}/{k}": v for k, v in _theta_fields(state).items()})
            twin_to(sh, job, mid)
        elif job == "plg":
            sh = parallel.ShardedSMC2(particle_lg_sampler(torch, device), mesh)
            y_lg, mid = torch.tensor(lg_series(), device=device), {}
            (state, infos, doubled_at), rec = timed(lambda: drive_exchange(
                sh.sampler, torch.Generator(device=device).manual_seed(SEED), y_lg,
                keep=(P_TWIN_T, mid)))
            rec["inner_steps"] = _schedule(infos, DT_CHAIN, doubled_at)
            rec["rejuv_t"] = (infos.rejuvenated.nonzero().flatten() + 1).tolist()
            rec["doubled_at"], rec["final_n"] = doubled_at, state.active_n
            meta[job] = rec
            arrays.update({f"{job}/{k}": v for k, v in _theta_fields(state).items()})
            # the twin: the same steps to P_TWIN_T (y cut there: the filters
            # read only the consumed prefix), eagerly
            (st, infos, doubled_at), erec = timed(lambda: drive_exchange(
                sh.sampler, torch.Generator(device=device).manual_seed(SEED),
                y_lg[:P_TWIN_T]), eager=True)
            _twin(f"plg rank {rank}", _theta_fields(st), mid, None, None)
            erec["inner_steps"] = _schedule(infos, DT_CHAIN, doubled_at)
            meta[f"{job}_eager"] = erec
        elif job.startswith("slice"):
            n = int(job[len("slice"):])
            cfg = smc.SMCConfig(n_particles=n, n_theta=512, chain=CHAIN, ess_threshold=0.5,
                                inner=smc.PFConfig("systematic", 1.0))
            sh = parallel.ShardedSMC2(smc.SMC2(smc.ucsv_model, prior_from_spec(
                PRIOR_SPEC, device=device), cfg), mesh)
            # the same seed four times: the second is warm, the last two the
            # disable_graphs() twin (its first launches compile the eager
            # path's Triton specializations: the second's wall is the warm one)
            for run in ("cold", "warm", "eager_cold", "eager"):
                gen = torch.Generator(device=device).manual_seed(SEED)
                (state, infos), rec = timed(lambda: sh.run(gen, y),
                                            eager=run.startswith("eager"))
                rec["inner_steps"] = _schedule(infos, CHAIN, [])
                rec["rejuv_t"] = (infos.rejuvenated.nonzero().flatten() + 1).tolist()
                meta[f"{job}_{run}"] = rec
                if run.startswith("eager"):
                    _twin(f"{job} rank {rank}", _theta_fields(state),
                          {k: arrays[f"{job}/{k}"] for k in ("theta", "log_omega", "log_z")},
                          meta[f"{job}_warm"], rec)
                else:
                    arrays.update({f"{job}/{k}": v for k, v in _theta_fields(state).items()})
            # the θ-resample's cloud exchange alone: the planar cloud and log_w
            rows = theta_rows(mesh, 512)
            cloud = as_cloud(state.particles)
            for _ in range(2):
                all_gather_rows(cloud, rows), all_gather_rows(state.log_w, rows)
            _, rec = timed(lambda: [(all_gather_rows(cloud, rows), all_gather_rows(
                state.log_w, rows)) for _ in range(5)])
            meta[f"{job}_resample_gather"] = {
                "ms": 1e3 * rec["wall_s"] / 5, "bytes": (cloud.numel() + state.log_w.numel())
                * 4 * world}
        elif job in ("grow", "full"):
            cfg = smc.SMCConfig(n_particles=DT_N, n_theta=DT_M, chain=CHAIN, ess_threshold=0.5,
                                acc_threshold=EXCHANGE_ACC, exchange_max_n=EXCHANGE_MAX_N,
                                elastic_pad=job, inner=smc.PFConfig("systematic", 1.0))
            sh = parallel.ShardedSMC2(smc.SMC2(smc.ucsv_model, prior_from_spec(
                PRIOR_SPEC, device=device), cfg), mesh)
            gen = torch.Generator(device=device).manual_seed(SEED)

            def drive():
                state, infos, doubled_at = sh.init(gen, y), [], []
                for _ in range(1, T):
                    t0_step, n0 = state.t, state.active_n
                    state, info = sh.step(gen, state, y)
                    if state.active_n != n0:
                        doubled_at.append(t0_step)
                    if state.exchange_pending:
                        doubled_at.append(state.t)
                    state = sh.sampler.maybe_exchange(gen, state, y, info)
                    infos.append(info)
                return state, infos, doubled_at

            from sequential_monte_carlo_tpu_torch.samplers.smc2 import _stack

            for eager in (False, True):  # replayed, then its disable_graphs() twin
                gen = torch.Generator(device=device).manual_seed(SEED)
                (state, infos, doubled_at), rec = timed(drive, eager=eager)
                infos = _stack(infos)
                rec["inner_steps"] = _schedule(infos, CHAIN, doubled_at)
                rec["rejuv_t"] = (infos.rejuvenated.nonzero().flatten() + 1).tolist()
                rec["doubled_at"], rec["final_n"] = doubled_at, state.active_n
                if eager:
                    _twin(f"{job} rank {rank}", _theta_fields(state),
                          {k: arrays[f"{job}/{k}"] for k in ("theta", "log_omega", "log_z")},
                          meta[job], rec)
                    meta[f"{job}_eager"] = rec
                else:
                    meta[job] = rec
                    arrays.update({f"{job}/{k}": v for k, v in _theta_fields(state).items()})
        elif job in DT_INNER:  # density-tempered LG at config 4, the JAX idiom's sampler
            sampler = parallel.ShardedSMC2(dt_sampler(DT_INNER[job], device), mesh).sampler
            y_lg = torch.tensor(lg_series(), device=device)
            key = f"{job}@{mesh.shape[0]}x{mesh.shape[1]}"
            # a short run first (the kernels load, the routes are captured at
            # this mesh's shapes), and its disable_graphs() twin, twice (the
            # first eager launches compile the eager path's Triton
            # specializations: the second's wall is the warm one)
            short = []
            for eager in (False, True, True):
                (st, trace), rec = timed(lambda: smc.density_tempered(
                    sampler, torch.Generator(device=device).manual_seed(SEED + 1),
                    y_lg[:DT_TWIN_T]), eager=eager)
                rec["moves"] = sum(stage.xi < 1.0 for stage in trace)
                rec["inner_steps"] = (DT_TWIN_T - 1) * (1 + DT_CHAIN * rec["moves"])
                short.append((dt_fields(st, trace), rec))
                _twin(f"{key} rank {rank}", short[0][0], short[-1][0], short[0][1], rec)
            meta[f"{key}_short"], meta[f"{key}_eager"] = short[0][1], short[-1][1]
            (state, trace), rec = timed(lambda: smc.density_tempered(
                sampler, torch.Generator(device=device).manual_seed(SEED), y_lg))
            rec["moves"] = sum(stage.xi < 1.0 for stage in trace)
            rec["inner_steps"] = (DT_T - 1) * (1 + DT_CHAIN * rec["moves"])
            rec["coords"] = [mesh.get_local_rank(0), mesh.get_local_rank(1)]
            meta[key] = rec
            arrays.update({f"{key}/{k}": v for k, v in dt_fields(state, trace).items()})
        elif job == "ibis":
            ibis = parallel.ShardedIBIS(smc.IBIS(
                smc.lg_model, prior_from_spec(LG_PRIOR_SPEC, device=device),
                smc.SMCConfig(n_theta=DT_M, chain=DT_CHAIN, ess_threshold=0.5)), mesh)
            for eager in (False, True):  # replayed, then its disable_graphs() twin
                (state, infos), rec = timed(lambda: ibis.run(
                    torch.Generator(device=device).manual_seed(SEED),
                    torch.tensor(lg_series(), device=device)), eager=eager)
                whole = ibis.gather(state)
                got = {k: getattr(whole, k).cpu().numpy()
                       for k in ("theta", "log_omega", "log_z", "ess", "mean", "cov")}
                rec["kalman_graph_launches"] = kalman_graph_launches(infos, DT_CHAIN)
                rec["online_steps"] = len(infos.ess)
                if eager:
                    _twin(f"ibis rank {rank}", got, {k: arrays[f"ibis/{k}"] for k in got},
                          meta["ibis"], rec)
                    meta["ibis_eager"] = rec
                else:
                    arrays.update({f"ibis/{k}": v for k, v in got.items()})
                    meta["ibis"] = rec
        elif job != "init":  # "init": the process group and the mesh only
            raise ValueError(f"unknown job {job!r}")
    torch.distributed.destroy_process_group()
    np.savez(f"{out}/{rank}.npz", **arrays)
    with open(f"{out}/{rank}.json", "w") as f:
        json.dump(meta, f)
    return 0


def run_ranks(jobs: str, world: int, backend: str, timeout_s: float = 900.0):
    """Start ``world`` worker processes of this script on the jobs and wait
    for all; raises if one fails or outlasts ``timeout_s``. Returns
    [(arrays, meta)] per rank."""
    import tempfile

    out = tempfile.mkdtemp(prefix="smc_parallel_")
    store = f"{out}/store"
    procs = [subprocess.Popen([sys.executable, __file__, PARALLEL_WORKER, jobs, str(r),
                               str(world), backend, store, out],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"parallel: rank {r} of {world} ({backend}) exited "
                                 f"{p.returncode}:\n{log[-6000:]}")
    res = []
    for r in range(world):
        with np.load(f"{out}/{r}.npz") as z, open(f"{out}/{r}.json") as f:
            res.append(({k: z[k] for k in z.files}, json.load(f)))
    return res


def _expect_equal(label: str, arrays: dict, prefix: str, ref: dict) -> None:
    for k, want in ref.items():
        got = arrays[f"{prefix}/{k}"]
        if not np.array_equal(got, want):
            diff = np.max(np.abs(got.astype(np.float64) - want)) if got.shape == want.shape \
                else f"shapes {got.shape} {want.shape}"
            raise AssertionError(f"parallel {label}: {prefix}/{k} differs from the one-process "
                                 f"run's (max |Δ| {diff})")


def _expect_replays(label: str, rec: dict, online_steps: int, rejuv_t, chain: int,
                    doubled_at=(), theta_only: bool = False, filters: int = 0,
                    live: int = 0) -> None:
    """Fail unless a replayed mesh run's graph and segment launches are its
    schedule's (:func:`mesh_graph_launches`), each kind of route cut its
    steps one way, and on a θ-only mesh the masked filter not at all and
    the online step once (the θ group's gather of the evidence)."""
    want = mesh_graph_launches(rec, online_steps, rejuv_t, chain, doubled_at, filters, live)
    cuts = rec["cuts"]
    if (rec["graph_launches"], rec["segment_launches"]) != want or any(
            len(c) != 1 for c in cuts.values()) or (theta_only and (
            cuts.get("masked", [0]) != [0] or cuts.get("online", [1]) != [1])):
        raise AssertionError(f"{label}: {rec['graph_launches']} graph and "
                             f"{rec['segment_launches']} segment launches, cuts {cuts}; "
                             f"the schedule's {want}")


def _replay_fields(rec: dict, erec: dict) -> dict:
    """A replayed mesh run's line: its graph and segment launches, cuts a
    step, the graph pool, and its wall per inner step against its
    disable_graphs() twin's (over the twin's own inner steps where the twin
    was cut short)."""
    def ms(r):
        return round(1e3 * r["wall_s"] / r["inner_steps"], 4)

    out = {"graph_launches": rec["graph_launches"], "segment_launches": rec["segment_launches"],
           "cuts_a_step": rec["cuts"], "pool_mb": rec["pool_mb"],
           "wall_ms_per_inner_step": ms(rec), "eager_wall_ms_per_inner_step": ms(erec)}
    if erec["inner_steps"] != rec["inner_steps"]:
        out["eager_twin_inner_steps"] = erec["inner_steps"]
    return out


def _check_ibis_mesh(phase: str, r: int, meta: dict, world: int, **extra) -> None:
    """ShardedIBIS's replayed run (bitwise its twin, in the worker): no
    kernel, one online replay a step cut once (its gather), the Kalman
    passes uncut, S steps a launch; its line."""
    rec, erec = meta["ibis"], meta["ibis_eager"]
    expect_counts(f"{phase} ibis rank {r}", rec["counts"], {})
    steps, kalman = rec["online_steps"], rec["kalman_graph_launches"]
    if (rec["graph_launches"], rec["segment_launches"]) != (steps + kalman, 2 * steps + kalman) \
            or rec["cuts"] != {"ibis": [1], "kalman": [0]}:
        raise AssertionError(f"{phase} ibis rank {r}: {rec['graph_launches']} graph and "
                             f"{rec['segment_launches']} segment launches, cuts {rec['cuts']}")
    say(phase, world=world, backend="gloo", rank=r, **extra, ibis=f"{DT_M} θ",
        bitwise_as_one_process=True, replayed_bitwise_as_eager_twin=True,
        wall_s=round(rec["wall_s"], 4), eager_wall_s=round(erec["wall_s"], 4),
        graph_launches=rec["graph_launches"], segment_launches=rec["segment_launches"],
        cuts_a_step=rec["cuts"], pool_mb=rec["pool_mb"], collectives=rec["collectives"])


def check_parallel(torch, refs: dict, one_rank_ms: dict):
    """Phase 26 (see the module docstring). ``refs``: the one-process runs'
    θ-level fields per job; ``one_rank_ms``: phase 7's walls per inner step.
    Returns the ranks' launch counts summed over every job's runs."""
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    if torch.cuda.device_count() == 1:  # NCCL refuses two ranks on one card, and says so
        try:
            run_ranks("init", 2, "nccl", timeout_s=300.0)
        except AssertionError as e:
            if "ranks that share a card need backend='gloo'" not in str(e):
                raise
        else:
            raise AssertionError("parallel: two NCCL ranks on one card initialized")
        say("parallel", world=2, backend="nccl", refused="Duplicate GPU detected")
    one = run_ranks("slice1024,slice8192", 1, "nccl")
    two = run_ranks("slice1024,slice8192,grow,full,ibis", 2, "gloo")
    for world, ranks in ((1, one), (2, two)):
        for r, (arrays, meta) in enumerate(ranks):
            jobs = [j for j in ("slice1024", "slice8192", "grow", "full", "ibis")
                    if f"{j}/theta" in arrays]
            for job in jobs:
                _expect_equal(f"{world} rank(s), rank {r}", arrays, job, refs[job])
            for key, rec in meta.items():
                if isinstance(rec, dict) and "counts" in rec:
                    add(rec["counts"])
            for n in (1024, 8192):
                for run in ("cold", "warm", "eager_cold", "eager"):
                    rec = meta[f"slice{n}_{run}"]
                    expected = (T - 1) + sum(CHAIN * (t - 1) for t in rec["rejuv_t"])
                    expect_counts(f"parallel {world} rank(s) slice{n}", rec["counts"],
                                  {"resample_count": expected,
                                   "fused_propagate_ucsv": expected})
                    if not run.startswith("eager"):
                        _expect_replays(f"parallel {world} rank(s) slice{n} {run}", rec,
                                        T - 1, rec["rejuv_t"], CHAIN, theta_only=True)
                    want = {("resample_count", 512 // world, None, 0, n),
                            ("fused_propagate_ucsv", 512 // world, r * 512 // world, 0, n)}
                    if {tuple(x) for x in rec["seen"]} != want:
                        raise AssertionError(f"parallel slice{n} rank {r}: launches at "
                                             f"{rec['seen']}, expected {sorted(want, key=str)}")
                g = meta[f"slice{n}_resample_gather"]
                say("parallel", world=world, backend=meta["info"]["backend"], rank=r,
                    shape=f"512x{n}", T=T, chain=CHAIN, bitwise_as_one_process=True,
                    replayed_bitwise_as_eager_twin=True,
                    rows=f"{r * 512 // world}..{(r + 1) * 512 // world}",
                    inner_steps=meta[f"slice{n}_warm"]["inner_steps"],
                    wall_s_cold=round(meta[f"slice{n}_cold"]["wall_s"], 4),
                    wall_s_warm=round(meta[f"slice{n}_warm"]["wall_s"], 4),
                    **_replay_fields(meta[f"slice{n}_warm"], meta[f"slice{n}_eager"]),
                    one_process_ms_per_inner_step=one_rank_ms[n],
                    collectives=meta[f"slice{n}_warm"]["collectives"],
                    resample_gather_ms=round(g["ms"], 4), resample_gather_bytes=g["bytes"])
    for r, (arrays, meta) in enumerate(two):
        for job, kernels in (("grow", ("resample_count", "fused_propagate_ucsv")),
                             ("full", ("resample_sorted", "ucsv_propagate"))):
            rec = meta[job]
            if rec["final_n"] != N_CAP or len(rec["doubled_at"]) != 3:
                raise AssertionError(f"parallel {job} rank {r}: N={rec['final_n']} after "
                                     f"doublings at {rec['doubled_at']}")
            expect_counts(f"parallel {job} rank {r}", rec["counts"],
                          {k: rec["inner_steps"] for k in kernels})
            _expect_replays(f"parallel {job} rank {r}", rec, T - 1, rec["rejuv_t"], CHAIN,
                            rec["doubled_at"], theta_only=True)
            offsets = {x[2] for x in rec["seen"]}
            rows = {x[1] for x in rec["seen"]}
            if {x[0] for x in rec["seen"]} != set(kernels) or rows != {256} \
                    or offsets != {None, 256 * r}:
                raise AssertionError(f"parallel {job} rank {r}: launches at {rec['seen']}")
            say("parallel", world=2, backend="gloo", rank=r, exchange=job,
                shape=f"512x{DT_N}..{N_CAP}", bitwise_as_one_process=True,
                replayed_bitwise_as_eager_twin=True,
                inner_steps=rec["inner_steps"], doubled_at_t=rec["doubled_at"],
                wall_s=round(rec["wall_s"], 4), **_replay_fields(rec, meta[f"{job}_eager"]),
                collectives=rec["collectives"])
        _check_ibis_mesh("parallel", r, meta, world=2)
    for job in refs:  # the ranks agree with each other too (implied; checked once more)
        if not np.array_equal(two[0][0][f"{job}/theta"], two[1][0][f"{job}/theta"]):
            raise AssertionError(f"parallel {job}: the ranks' θ differ")
    return total


def particle_lg_sampler(torch, device):
    """Phase 28 (d)'s sampler: LG SMC² on the dt phase's prior (M=512,
    chain=3), the exchange armed in full padding (N from P_LG_N, the arrays
    at the cap 4·P_LG_N from the init) and a stratified inner filter at
    ESS < N/2: K3 on the live-prefix grid and K2-LG's raw route, the carried
    log-weights added before the normalize."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec

    cfg = smc.SMCConfig(n_particles=P_LG_N, n_theta=DT_M, chain=DT_CHAIN, ess_threshold=0.5,
                        acc_threshold=EXCHANGE_ACC, exchange_max_n=2 * P_LG_N,
                        elastic_pad="full", inner=smc.PFConfig("stratified", 0.5))
    return smc.SMC2(smc.lg_model, prior_from_spec(LG_PRIOR_SPEC, device=device), cfg)


def particle_apf_sampler(torch, device, n: int = DT_N):
    """Phase 28 (f)'s sampler: phase 13's SMC² on UC-SV with the APF inside
    (M=512, N=n, 1024 unless given, chain=5): K1 on the cloud with the
    lookahead plane and K6 raw, the first-stage weights and the correction
    normalized in torch (by one process and by a particle group alike)."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec

    cfg = smc.SMCConfig(n_particles=n, n_theta=DT_M, chain=CHAIN, ess_threshold=0.5,
                        inner=smc.PFConfig(*APF))
    return smc.SMC2(smc.ucsv_model, prior_from_spec(PRIOR_SPEC, device=device), cfg)


def drive_exchange(sampler, gen, y, keep=None):
    """``step`` + ``maybe_exchange`` over the whole series. Returns (state,
    the stacked infos, the observation counts t at which a refilter ran);
    ``keep`` = (t, dict): the θ-level fields at t go into the dict."""
    from sequential_monte_carlo_tpu_torch.samplers.smc2 import _stack

    state, infos, doubled_at = sampler.init(gen, y), [], []
    for _ in range(1, y.shape[0]):
        t0, n0 = state.t, state.active_n
        state, info = sampler.step(gen, state, y)
        if state.active_n != n0 or state.exchange_pending:
            doubled_at.append(t0 if state.active_n != n0 else state.t)
        state = sampler.maybe_exchange(gen, state, y, info)
        infos.append(info)
        if keep is not None and state.t == keep[0]:
            keep[1].update(_theta_fields(state))
    return state, _stack(infos), doubled_at


def window_cost(m: int, n: int, k: int, c: int, grid: bool) -> dict:
    """Bytes and operations of a resample call that writes k of a row's n
    slots: the row's weights read (the cdf is the whole row's), the window's
    grid (K3) or the offsets (K1), the gathered particles read and written
    for the window's slots only; the walk over every weight and a search per
    window slot, as f32 operations (an estimate: bytes bind these kernels)."""
    nbytes = 4 * m * (n + 2 * c * k + (k if grid else 0)) + (0 if grid else 4 * m)
    return {"nbytes": nbytes, "f32": m * n * 3 + m * k * math.log2(n)}


def check_windows(torch, gen, k1, k3, k2, k2r, k6):
    """Phase 28 (a): the kernels' contracts under particle sharding, alone.
    K1 with a slot window and K3 on a window of the grid, at 512×8192 (C=3)
    over 2 and 4 particle shards and at 64×65,536 over 2 (their large
    route), against the whole launch's slots and ancestors bit for bit;
    K2-UC-SV (normalized and raw), K2-LG dx=1 (raw) and K6 (raw) on
    particles 4096.. of 512×8192 rows at particle_offset 4096 against the
    whole launch's columns at the same seed bit for bit (the new cloud, and
    the raw log-weights). Each timed against its plain version and bound;
    the times go into the kernels' dicts."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.kernels.propagate import (
        fused_elementwise_step,
        fused_elementwise_step_plain,
    )
    from sequential_monte_carlo_tpu_torch.kernels.resample_sorted import (
        resample_gather_sorted,
        resample_gather_sorted_plain,
        stratified_uniforms,
    )
    from sequential_monte_carlo_tpu_torch.kernels.resample_walk import (
        resample_gather,
        resample_gather_plain,
    )
    from sequential_monte_carlo_tpu_torch.kernels.ucsv import (
        ucsv_propagate_reweight,
        ucsv_propagate_reweight_plain,
    )
    from sequential_monte_carlo_tpu_torch.models.ucsv import UCSV_UPDATE

    for m, n, shards in ((512, 8192, 2), (512, 8192, 4), (64, 65536, 2)):
        k = n // shards
        w = weight_profiles(torch, gen, m, n)["skewed"]
        xs = torch.randn((m, 3, n), generator=gen, device="cuda")
        u0 = torch.rand((m, 1), generator=gen, device="cuda")
        u = stratified_uniforms(gen, m, n)
        whole1, anc1 = resample_gather(u0, w, xs, return_ancestors=True)
        whole3, anc3 = resample_gather_sorted(u, w, xs, return_ancestors=True)
        for b in range(shards):
            lo, hi = b * k, (b + 1) * k
            out, anc = resample_gather(u0, w, xs, return_ancestors=True, slot_lo=lo, n_out=k)
            if not (torch.equal(out, whole1[:, :, lo:hi]) and torch.equal(anc, anc1[:, lo:hi])):
                raise AssertionError(f"K1 {m}x{n} window {lo}..{hi}: not the whole output's")
            out, anc = resample_gather_sorted(u[:, lo:hi].contiguous(), w, xs,
                                              return_ancestors=True)
            if not (torch.equal(out, whole3[:, :, lo:hi]) and torch.equal(anc, anc3[:, lo:hi])):
                raise AssertionError(f"K3 {m}x{n} window {lo}..{hi}: not the whole output's")
        uw = u[:, k:2 * k].contiguous()
        key = f"window_{shards}_{m}x{n}"
        k1[key] = (time_ms(torch, lambda: resample_gather(u0, w, xs, slot_lo=k, n_out=k)),
                   time_ms(torch, lambda: resample_gather_plain(u0, w, xs, k, k)),
                   *bound_ms(**window_cost(m, n, k, 3, grid=False)))
        k3[key] = (time_ms(torch, lambda: resample_gather_sorted(uw, w, xs)),
                   time_ms(torch, lambda: resample_gather_sorted_plain(uw, w, xs)),
                   *bound_ms(**window_cost(m, n, k, 3, grid=True)))
        say("particle", check="windows", shape=f"{m}x{n}", shards=shards, window=k,
            bitwise_as_whole=True, k1_ms=k1[key][0], k1_plain_ms=k1[key][1],
            k1_bound_ms=k1[key][2], k3_ms=k3[key][0], k3_plain_ms=k3[key][1],
            k3_bound_ms=k3[key][2])

    m, n, k = 512, 8192, 4096
    y = torch.tensor(1.3, device="cuda")
    seed = torch.randint(0, 2**31 - 1, (1,), generator=gen, device="cuda")
    ucsv = torch.randn((m, 3, n), generator=gen, device="cuda")
    ucsv[:, 1:] *= 0.5
    gam = torch.tensor((0.3, 0.2), device="cuda").expand(m, 2).contiguous()
    lg = _lg_cloud(torch, smc, m, 1)
    lg_state = torch.randn((m, 1, n), generator=gen, device="cuda")
    cases = {  # name: (the step on a state, the state, its dict and key, normals, raw)
        "ucsv": (lambda st, **kw: fused_elementwise_step(UCSV_UPDATE, gam, st, y, seed=seed,
                                                         **kw), ucsv, k2, 3, False),
        "ucsv_raw": (lambda st, **kw: fused_elementwise_step(UCSV_UPDATE, gam, st, y, seed=seed,
                                                             normalize=False, **kw),
                     ucsv, k2, 3, True),
        "lg1_raw": (lambda st, **kw: fused_elementwise_step(lg.update, lg.fused_params(), st, y,
                                                            seed=seed, normalize=False, **kw),
                    lg_state, k2r["lg1_raw"], 1, True),
        "k6": (lambda st, **kw: ucsv_propagate_reweight(seed, y, gam[:, 0], gam[:, 1], st, **kw),
               ucsv, k6, 3, True),
    }
    for name, (step, state, res, normals, raw) in cases.items():
        whole = step(state)
        part_state = state[:, :, k:].contiguous()
        part = step(part_state, particle_offset=k)
        if not torch.equal(part[0], whole[0][:, :, k:]) or (
                raw and not torch.equal(part[1], whole[1][:, k:])):
            raise AssertionError(f"particle: {name} at particle_offset {k} differs from the "
                                 f"{m}x{n} launch's columns")

        def plain(name=name, st=part_state, raw=raw, normals=normals):
            zz = torch.randn((normals, m, k), generator=gen, device="cuda")
            if name == "k6":
                return ucsv_propagate_reweight_plain(y, gam[:, 0], gam[:, 1], st, zz)
            if name.startswith("lg"):
                return fused_elementwise_step_plain(lg.update, lg.fused_params(), st, y, zz,
                                                    normalize=not raw)
            return fused_elementwise_step_plain(UCSV_UPDATE, gam, st, y, zz, normalize=not raw)

        model = "lg1" if name.startswith("lg") else "ucsv"
        key = f"offset_{k}{'_raw' if name == 'ucsv_raw' else ''}_{m}x{k}"
        res[key] = (time_ms(torch, lambda: step(part_state, particle_offset=k)),
                    time_ms(torch, plain),
                    *bound_ms(**propagate_cost(m, k, state.shape[1], 4 if model == "lg1" else 2,
                                               False, model, not raw)))
        say("particle", check="offset", kernel=name, shape=f"{m}x{k}", particle_offset=k,
            bitwise_as_whole_columns=True, ms=res[key][0], plain_ms=res[key][1],
            bound_ms=res[key][2])


def _mean(theta, log_omega):
    w = np.exp(log_omega - log_omega.max())
    return (w / w.sum()) @ theta


def _ranks_counts(ranks, total: dict) -> dict:
    """``total`` plus the launch counts of every run of every rank."""
    for _, meta in ranks:
        for rec in meta.values():
            if isinstance(rec, dict) and "counts" in rec:
                for k, v in rec["counts"].items():
                    total[k] = total.get(k, 0) + v
    return total


def _ranks_agree(label: str, ranks, prefix: str) -> None:
    """Fail unless every rank's arrays under ``prefix`` equal rank 0's."""
    for r, (arrays, _) in enumerate(ranks[1:], 1):
        for k, v in arrays.items():
            if k.startswith(prefix + "/") and not np.array_equal(v, ranks[0][0][k]):
                raise AssertionError(f"{label}: rank {r}'s {k} differs from rank 0's")


def _expect_seen(label: str, rec: dict, want: set) -> None:
    """Fail unless a run's kernel launches were at exactly ``want``
    (:func:`_record_shards`'s tuples)."""
    if {tuple(x) for x in rec["seen"]} != want:
        raise AssertionError(f"{label}: launches at {rec['seen']}, expected "
                             f"{sorted(want, key=str)}")


def check_particle(torch, ibis_ref: dict):
    """Phase 28 (b)–(e), see the module docstring. ``ibis_ref``: phase
    17's state. Returns the ranks' launch counts summed over their runs."""
    import sequential_monte_carlo_tpu_torch as smc

    # the one-process references: the slice at 512×8192 over the first
    # P_STEPS observations at P_SEEDS seeds; (d)'s run
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec

    (mb, nb), (mc, nc) = P_SLICE_B, P_SLICE_C
    cfg = smc.SMCConfig(n_particles=nb, n_theta=mb, chain=CHAIN, ess_threshold=0.5,
                        inner=smc.PFConfig("systematic", 1.0))
    one = smc.SMC2(smc.ucsv_model, prior_from_spec(PRIOR_SPEC, device="cuda"), cfg)
    y = series(torch, "cuda")
    means, one_ms = [], []
    for seed in range(P_SEEDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, infos = one.run_segmented(torch.Generator(device="cuda").manual_seed(seed), y,
                                      max_steps=P_STEPS - 1)
        torch.cuda.synchronize()
        one_ms.append(1e3 * (time.perf_counter() - t0) / _schedule(infos, CHAIN, []))
        means.append(smc.expected_parameters(st).cpu().numpy())
        if seed == SEED:
            one_mean = means[-1]
    means = np.asarray(means)
    lg_one, lg_infos, lg_doubled = drive_exchange(
        particle_lg_sampler(torch, "cuda"), torch.Generator(device="cuda").manual_seed(SEED),
        torch.tensor(lg_series(), device="cuda"))
    apf_one, apf_infos = particle_apf_sampler(torch, "cuda").run_segmented(
        torch.Generator(device="cuda").manual_seed(SEED), y, max_steps=P_STEPS - 1)

    job, job_c = f"pslice{mb}x{nb}:{P_STEPS}", f"pslice{mc}x{nc}"
    two = run_ranks(f"mesh1x2,{job},plg,papf,ibis", 2, "gloo")
    four = run_ranks(f"mesh2x2,{job_c}", 4, "gloo")

    # (b) the slice at 512×8192 on (1, 2), cut at P_STEPS
    _ranks_agree("particle (1, 2)", two, job)
    sd = means.std(axis=0, ddof=1)
    tol = TOL_Z * sd * math.sqrt(1.0 + 1.0 / P_SEEDS)
    total = _ranks_counts(two + four, {})
    for r, (arrays, meta) in enumerate(two):
        rec = meta[job]
        if rec["t"] != P_STEPS or not rec["rejuv_t"]:
            raise AssertionError(f"particle (1, 2): t={rec['t']}, rejuvenations at "
                                 f"{rec['rejuv_t']}")
        expect_counts(f"particle (1, 2) rank {r}", rec["counts"],
                      {"resample_count": rec["inner_steps"], "ucsv_propagate": rec["inner_steps"]})
        _expect_replays(f"particle (1, 2) rank {r}", rec, rec["t"] - 1, rec["rejuv_t"], CHAIN)
        k = nb // 2
        _expect_seen("particle (1, 2)", rec, {("resample_count", mb, None, k * r, k),
                                    ("ucsv_propagate", mb, 0, k * r, k)})
    mean = _mean(two[0][0][f"{job}/theta"], two[0][0][f"{job}/log_omega"])
    if not np.all(np.abs(mean - means.mean(axis=0)) <= tol):
        raise AssertionError(f"particle (1, 2): posterior mean at t={P_STEPS} {mean} vs the "
                             f"one-process seeds' {means.mean(axis=0)} beyond {tol}")
    for r, (_, meta) in enumerate(two):
        rec, first = meta[job], meta[f"{job}_first"]
        say("particle", mesh="1x2", backend="gloo", rank=r, shape=f"{mb}x{nb}", T=P_STEPS,
            chain=CHAIN, ranks_bitwise_equal=True, slots=f"{nb // 2 * r}..{nb // 2 * (r + 1)}",
            replayed_bitwise_as_eager_twin_at_t=P_TWIN_T,
            inner_steps=rec["inner_steps"], rejuv_t=rec["rejuv_t"],
            wall_s=round(rec["wall_s"], 4), **_replay_fields(rec, meta[f"{job}_eager"]),
            first_wall_ms_per_inner_step=round(1e3 * first["wall_s"] / first["inner_steps"], 4),
            one_process_ms_per_inner_step=round(float(np.median(one_ms)), 4),
            collectives=rec["collectives"])
    say("particle", mesh="1x2", check="posterior", T=P_STEPS,
        posterior_mean=np.round(mean, 5).tolist(),
        one_process_seed0_mean=np.round(one_mean, 5).tolist(),
        one_process_seeds_mean=np.round(means.mean(axis=0), 5).tolist(),
        one_process_seeds_sd=np.round(sd, 5).tolist(), tolerance=np.round(tol, 5).tolist())

    # (c) the slice at 512×1024 on (2, 2), the whole T
    _ranks_agree("particle (2, 2)", four, job_c)
    tol = TOL_Z * np.asarray(JAX_SD) * math.sqrt(1.0 + 1.0 / JAX_SEEDS)
    rows, k = mc // 2, nc // 2
    for r, (arrays, meta) in enumerate(four):
        rec = meta[job_c]
        a, b = meta["coords"]
        expect_counts(f"particle (2, 2) rank {r}", rec["counts"],
                      {"resample_count": rec["inner_steps"], "ucsv_propagate": rec["inner_steps"]})
        _expect_replays(f"particle (2, 2) rank {r}", rec, rec["t"] - 1, rec["rejuv_t"], CHAIN)
        _expect_seen("particle (2, 2)", rec, {("resample_count", rows, None, k * b, k),
                                    ("ucsv_propagate", rows, rows * a, k * b, k)})
        say("particle", mesh="2x2", backend="gloo", rank=r, coords=[a, b], shape=f"{mc}x{nc}",
            T=T, chain=CHAIN, rows=f"{rows * a}..{rows * (a + 1)}",
            slots=f"{k * b}..{k * (b + 1)}", inner_steps=rec["inner_steps"],
            replayed_bitwise_as_eager_twin_at_t=P_TWIN_T, wall_s=round(rec["wall_s"], 4),
            **_replay_fields(rec, meta[f"{job_c}_eager"]), collectives=rec["collectives"])
    mean = _mean(four[0][0][f"{job_c}/theta"], four[0][0][f"{job_c}/log_omega"])
    if not np.all(np.abs(mean - np.asarray(JAX_MEAN)) <= tol):
        raise AssertionError(f"particle (2, 2): posterior mean {mean} vs JAX {JAX_MEAN} "
                             f"beyond {tol}")
    say("particle", mesh="2x2", check="posterior", ranks_bitwise_equal=True,
        posterior_mean=np.round(mean, 5).tolist(), jax_mean=JAX_MEAN,
        tolerance=np.round(tol, 5).tolist())

    # (d) LG, exchange in full padding, stratified at ESS < N/2, on (1, 2):
    # bitwise the one-process run (the elastic route normalizes whole rows
    # in both)
    ref = _theta_fields(lg_one)
    want_steps = _schedule(lg_infos, DT_CHAIN, lg_doubled)
    for r, (arrays, meta) in enumerate(two):
        rec = meta["plg"]
        _expect_equal(f"particle (1, 2) rank {r}", arrays, "plg", ref)
        if rec["final_n"] != 4 * P_LG_N or rec["doubled_at"] != lg_doubled \
                or rec["inner_steps"] != want_steps:
            raise AssertionError(f"particle plg rank {r}: N={rec['final_n']}, doublings at "
                                 f"{rec['doubled_at']} (one process {lg_doubled})")
        expect_counts(f"particle plg rank {r}", rec["counts"],
                      {"resample_sorted": want_steps, "fused_propagate_lg1_raw": want_steps})
        _expect_replays(f"particle plg rank {r}", rec, DT_T - 1, rec["rejuv_t"], DT_CHAIN,
                        rec["doubled_at"])
        _expect_seen("particle plg", rec, {("resample_sorted", DT_M, None, None, 2 * P_LG_N),
                                 ("fused_propagate_lg", DT_M, 0, 2 * P_LG_N * r, 2 * P_LG_N)})
        say("particle", mesh="1x2", rank=r, run="lg exchange full, stratified ESS<N/2",
            shape=f"{DT_M}x{P_LG_N}..{4 * P_LG_N}", T=DT_T, chain=DT_CHAIN,
            bitwise_as_one_process=True, replayed_bitwise_as_eager_twin_at_t=P_TWIN_T,
            doubled_at_t=rec["doubled_at"], inner_steps=rec["inner_steps"],
            wall_s=round(rec["wall_s"], 4), **_replay_fields(rec, meta["plg_eager"]),
            collectives=rec["collectives"])

    # (f) the APF's SMC² on UC-SV on (1, 2), cut at P_STEPS: bitwise the
    # one-process run (both normalize in torch)
    want_steps = _schedule(apf_infos, CHAIN, [])
    for r, (arrays, meta) in enumerate(two):
        rec = meta["papf"]
        _expect_equal(f"particle (1, 2) rank {r}", arrays, "papf", _theta_fields(apf_one))
        expect_counts(f"particle papf rank {r}", rec["counts"],
                      {"resample_count": want_steps, "ucsv_propagate": want_steps})
        _expect_replays(f"particle papf rank {r}", rec, P_STEPS - 1, rec["rejuv_t"], CHAIN)
        _expect_seen("particle papf", rec, {("resample_count", DT_M, None, DT_N // 2 * r, DT_N // 2),
                                  ("ucsv_propagate", DT_M, 0, DT_N // 2 * r, DT_N // 2)})
        say("particle", mesh="1x2", rank=r, run="ucsv apf", shape=f"{DT_M}x{DT_N}",
            T=P_STEPS, chain=CHAIN, bitwise_as_one_process=True,
            replayed_bitwise_as_eager_twin_at_t=P_TWIN_T, inner_steps=want_steps,
            wall_s=round(rec["wall_s"], 4), **_replay_fields(rec, meta["papf_eager"]),
            collectives=rec["collectives"])

    # (e) ShardedIBIS on (1, 2): bitwise phase 17's
    for r, (arrays, meta) in enumerate(two):
        _expect_equal(f"particle (1, 2) rank {r}", arrays, "ibis", ibis_ref)
        _check_ibis_mesh("particle", r, meta, world=2, mesh="1x2")
    return total


def check_k6_slices(torch, gen, k6):
    """Phase 29 (a): K6 on particle slices of 512×MESH_N rows that start or
    span off a multiple of 16 (K6_SLICES), at their ``particle_offset``, on
    three layouts: a contiguous slice (a particle-sharded bootstrap step's),
    the split-off planes of a contiguous 4-plane slice (the sharded APF's)
    and a view into the whole rows' 4-plane cloud (the pointer off the
    cloud's start). Each against the whole-row call's columns bit for bit,
    against K2-UC-SV raw's columns within 1e-5 and against its plain version
    fed the normals recovered from its state deltas; those normals' moments
    over the whole row. The slice at 500 timed into ``k6``."""
    from sequential_monte_carlo_tpu_torch.kernels.propagate import fused_elementwise_step
    from sequential_monte_carlo_tpu_torch.kernels.ucsv import (
        ucsv_propagate_reweight,
        ucsv_propagate_reweight_plain,
    )
    from sequential_monte_carlo_tpu_torch.models.ucsv import UCSV_UPDATE

    m, n = DT_M, MESH_N
    tol = dict(rtol=1e-5, atol=1e-5)
    y = torch.tensor(1.3, device="cuda")
    seed = torch.randint(0, 2**31 - 1, (1,), generator=gen, device="cuda")
    wide = torch.randn((m, 4, n), generator=gen, device="cuda")
    wide[:, 1:3] *= 0.5
    gam = torch.tensor((0.3, 0.2), device="cuda").expand(m, 2).contiguous()
    ge, gn = gam[:, 0], gam[:, 1]
    whole = ucsv_propagate_reweight(seed, y, ge, gn, wide[:, :3])
    k2 = fused_elementwise_step(UCSV_UPDATE, gam, wide[:, :3], y, seed=seed, normalize=False)
    layouts = {"contiguous": lambda c: wide[:, :3, c].contiguous(),
               "apf": lambda c: wide[:, :, c].contiguous()[:, :3],
               "view": lambda c: wide[:, :3, c]}
    err, k2_diff, z = 0.0, 0.0, {}
    for lo, width in K6_SLICES:
        cols = slice(lo, lo + width)
        for layout, part_of in layouts.items():
            part = part_of(cols)
            new, logw = ucsv_propagate_reweight(seed, y, ge, gn, part, particle_offset=lo)
            if not (torch.equal(new, whole[0][:, :, cols]) and torch.equal(logw, whole[1][:, cols])):
                raise AssertionError(f"K6 slice {lo}..{lo + width} ({layout}): not the "
                                     f"{m}x{n} call's columns")
            for a, b in zip((new, logw), (k2[0][:, :, cols], k2[1][:, cols])):
                torch.testing.assert_close(a, b, **tol)
                k2_diff = max(k2_diff, (a - b).abs().max().item())
        z[lo] = _recover_normals(torch, "ucsv", gam, part, new)
        for a, b in zip((new, logw), ucsv_propagate_reweight_plain(y, ge, gn, part, z[lo])):
            torch.testing.assert_close(a, b, **tol)
            err = max(err, (a - b).abs().max().item())
    moments = check_normals(torch, f"K6 slices of {m}x{n}", torch.cat([z[0], z[500]], dim=-1))
    check_normals(torch, f"K6 slice 8.. of {m}x{n}", z[8])
    k6["max_abs_err"] = max(k6["max_abs_err"], err)
    lo, width = K6_SLICES[1]
    part = wide[:, :3, lo:lo + width].contiguous()
    key = f"slice_{lo}_{m}x{width}"
    k6[key] = (time_ms(torch, lambda: ucsv_propagate_reweight(seed, y, ge, gn, part,
                                                              particle_offset=lo)),
               time_ms(torch, lambda: ucsv_propagate_reweight_plain(
                   y, ge, gn, part, torch.randn((3, m, width), generator=gen, device="cuda"))),
               *bound_ms(**propagate_cost(m, width, 3, 2, False, "ucsv", False)))
    say("dt_mesh", check="k6 slices", shape=f"{m}x{n}", slices=[list(c) for c in K6_SLICES],
        layouts=list(layouts), bitwise_as_whole_columns=True, max_abs_err=err,
        k2_raw_max_abs_diff=k2_diff, ms=k6[key][0], plain_ms=k6[key][1], bound_ms=k6[key][2],
        **moments)


def check_dt_mesh(torch, dt_refs: dict):
    """Phase 29 (b)–(d), see the module docstring. ``dt_refs``: phase 8's
    one-process runs (:func:`check_dt`'s) per job. Returns the launch counts
    of the one-process APF run and of every rank's runs, summed."""
    # the one-process reference of (d): the UC-SV APF at 512×MESH_N, P_STEPS
    y = series(torch, "cuda")
    torch.cuda.synchronize()
    reset_counts()
    apf_one, apf_infos = particle_apf_sampler(torch, "cuda", MESH_N).run_segmented(
        torch.Generator(device="cuda").manual_seed(SEED), y, max_steps=P_STEPS - 1)
    torch.cuda.synchronize()
    apf_counts = launch_counts()

    job_c = f"pslice{DT_M}x{MESH_N}"
    two = run_ranks(f"mesh2x1,dta,dtb,mesh1x2,dta,dtb,{job_c},papf{MESH_N}", 2, "gloo")
    four = run_ranks("mesh2x2,dta,dtb", 4, "gloo")
    total = _ranks_counts(two + four, apf_counts)

    # (b) density-tempered SMC on (2, 1), (1, 2) and (2, 2)
    tol = TOL_Z * np.asarray(DT_JAX_SD) * math.sqrt(1.0 + 1.0 / JAX_SEEDS)
    for shape, ranks in (("2x1", two), ("1x2", two), ("2x2", four)):
        n_theta, n_particle = map(int, shape.split("x"))
        rows, k = DT_M // n_theta, DT_N // n_particle
        for job, (scheme, _) in DT_INNER.items():
            key, ref = f"{job}@{shape}", dt_refs[job]
            _ranks_agree(f"dt_mesh {key}", ranks, key)
            resample = "resample_count" if scheme == "systematic" else "resample_sorted"
            propagate = ("fused_propagate_lg1_raw" if n_particle > 1 else
                         "fused_propagate_lg1" if scheme == "systematic" else
                         "fused_propagate_lg1_carry")
            for r, (arrays, meta) in enumerate(ranks):
                rec = meta[key]
                a, b = rec["coords"]
                steps = (DT_T - 1) * (1 + DT_CHAIN * rec["moves"])
                expect_counts(f"dt_mesh {key} rank {r}", rec["counts"],
                              {resample: steps, propagate: steps})
                _expect_replays(f"dt_mesh {key} rank {r}", rec, 0, [], DT_CHAIN,
                                theta_only=n_particle == 1, filters=1 + DT_CHAIN * rec["moves"],
                                live=DT_T - 1)
                _expect_seen(f"dt_mesh {key} rank {r}", rec, {
                    (resample, rows, None, *((k * b, k) if resample == "resample_count"
                                             else (None, k))),
                    ("fused_propagate_lg", rows, rows * a, k * b, k)})
                mean = _mean(arrays[f"{key}/theta"], arrays[f"{key}/log_omega"])
                if n_particle == 1:  # θ-sharded: bitwise the one-process run
                    _expect_equal(f"dt_mesh {key} rank {r}", arrays, key, ref["fields"])
                elif not np.all(np.abs(mean - np.asarray(DT_JAX_MEAN)) <= tol):
                    raise AssertionError(f"dt_mesh {key}: posterior mean {mean} vs JAX "
                                         f"{DT_JAX_MEAN} beyond {tol}")
                say("dt_mesh", run=job[-1], inner=list(DT_INNER[job]), mesh=shape, rank=r,
                    coords=[a, b], shape=f"{DT_M}x{DT_N}", rows=f"{rows * a}..{rows * (a + 1)}",
                    slots=f"{k * b}..{k * (b + 1)}", bitwise_as_one_process=n_particle == 1,
                    replayed_bitwise_as_eager_twin_at_T=DT_TWIN_T,
                    stages=len(arrays[f"{key}/stage_xi"]), one_process_stages=ref["stages"],
                    schedule=np.round(arrays[f"{key}/stage_xi"], 5).tolist(),
                    inner_steps=steps, wall_s=round(rec["wall_s"], 4),
                    **_replay_fields(rec, meta[f"{key}_eager"]),
                    one_process_warm_ms_per_inner_step=round(ref["warm_ms_per_inner_step"], 4),
                    posterior_mean=np.round(mean, 5).tolist(), jax_mean=DT_JAX_MEAN,
                    tolerance=np.round(tol, 5).tolist(), collectives=rec["collectives"])

    # (c) UC-SV SMC² at 512×MESH_N on (1, 2), the whole T: K6 at 500-particle
    # slices, offsets 0 and 500
    _ranks_agree("dt_mesh (1, 2) ucsv", two, job_c)
    k = MESH_N // 2
    for r, (arrays, meta) in enumerate(two):
        rec = meta[job_c]
        if rec["t"] != T:
            raise AssertionError(f"dt_mesh {job_c} rank {r}: t = {rec['t']}")
        expect_counts(f"dt_mesh {job_c} rank {r}", rec["counts"],
                      {"resample_count": rec["inner_steps"], "ucsv_propagate": rec["inner_steps"]})
        _expect_seen(f"dt_mesh {job_c} rank {r}", rec, {("resample_count", DT_M, None, k * r, k),
                                               ("ucsv_propagate", DT_M, 0, k * r, k)})
        _expect_replays(f"dt_mesh {job_c} rank {r}", rec, T - 1, rec["rejuv_t"], CHAIN)
        say("dt_mesh", run="ucsv smc2", mesh="1x2", rank=r, shape=f"{DT_M}x{MESH_N}", T=T,
            chain=CHAIN, slots=f"{k * r}..{k * (r + 1)}", inner_steps=rec["inner_steps"],
            replayed_bitwise_as_eager_twin_at_t=P_TWIN_T,
            rejuvenations=len(rec["rejuv_t"]), wall_s=round(rec["wall_s"], 4),
            **_replay_fields(rec, meta[f"{job_c}_eager"]), collectives=rec["collectives"])
    mean = _mean(two[0][0][f"{job_c}/theta"], two[0][0][f"{job_c}/log_omega"])
    tol = TOL_Z * np.asarray(JAX_SD) * math.sqrt(1.0 + 1.0 / JAX_SEEDS)
    if not np.all(np.abs(mean - np.asarray(JAX_MEAN)) <= tol):
        raise AssertionError(f"dt_mesh (1, 2) ucsv {DT_M}x{MESH_N}: posterior mean {mean} vs "
                             f"JAX {JAX_MEAN} beyond {tol}")
    say("dt_mesh", run="ucsv smc2", mesh="1x2", check="posterior", ranks_bitwise_equal=True,
        posterior_mean=np.round(mean, 5).tolist(), jax_mean=JAX_MEAN,
        tolerance=np.round(tol, 5).tolist())

    # (d) the UC-SV APF at 512×MESH_N on (1, 2), P_STEPS: bitwise the
    # one-process run (K6 at every slice draws the whole row's columns, and
    # both normalize in torch)
    want_steps = _schedule(apf_infos, CHAIN, [])
    job = f"papf{MESH_N}"
    for r, (arrays, meta) in enumerate(two):
        rec = meta[job]
        _expect_equal(f"dt_mesh (1, 2) rank {r}", arrays, job, _theta_fields(apf_one))
        expect_counts(f"dt_mesh {job} rank {r}", rec["counts"],
                      {"resample_count": want_steps, "ucsv_propagate": want_steps})
        _expect_replays(f"dt_mesh {job} rank {r}", rec, P_STEPS - 1, rec["rejuv_t"], CHAIN)
        _expect_seen(f"dt_mesh {job} rank {r}", rec, {("resample_count", DT_M, None, k * r, k),
                                             ("ucsv_propagate", DT_M, 0, k * r, k)})
        say("dt_mesh", run="ucsv apf", mesh="1x2", rank=r, shape=f"{DT_M}x{MESH_N}",
            T=P_STEPS, chain=CHAIN, bitwise_as_one_process=True,
            replayed_bitwise_as_eager_twin_at_t=P_TWIN_T, inner_steps=want_steps,
            wall_s=round(rec["wall_s"], 4), **_replay_fields(rec, meta[f"{job}_eager"]),
            collectives=rec["collectives"])
    return total


def check_animations(torch):
    """Phase 27: both animation programs at their defaults without figures,
    ANIMATION_SEEDS seeds each. Returns their launch counts."""
    import tempfile

    from sequential_monte_carlo_tpu_torch.examples import sv_animation, ucsv_animation

    outdir = tempfile.mkdtemp(prefix="smc_animations_")
    total = {}
    for name, run, kernel in (
            ("sv", lambda s: sv_animation.run_animation(
                out=f"{outdir}/sv.gif", figures=False, device="cuda", seed=s),
             "fused_propagate_sv"),
            ("ucsv", lambda s: ucsv_animation.run_animation(
                out=f"{outdir}/ucsv.gif", figures=False, device="cuda", seed=s),
             "fused_propagate_ucsv")):
        torch.cuda.synchronize()
        reset_counts()
        res = [run(s) for s in range(ANIMATION_SEEDS)]
        counts = launch_counts()
        t_len = len(res[0]["y"])
        expect_counts(f"animations ({name})", counts,
                      {"resample_count": ANIMATION_SEEDS * (t_len - 1),
                       kernel: ANIMATION_SEEDS * (t_len - 1)})
        total = counts if not total else {k: v + counts[k] for k, v in total.items()}
        lz = np.array([r["log_z"] for r in res])
        with np.load(res[0]["npz"]) as z:
            shapes = {k: z[k].shape for k in z.files}
        if name == "sv":
            ref = sv_grid_log_z(res[0]["y"], *sv_animation.SV_THETA)
            tol = TOL_Z * lz.std(ddof=1) / math.sqrt(ANIMATION_SEEDS)
            extra = {"grid_log_z": round(ref, 4)}
        else:
            ref, var, seeds = ANIMATION_UCSV_JAX
            tol = TOL_Z * math.sqrt(var * (1.0 / ANIMATION_SEEDS + 1.0 / seeds))
            extra = {"jax_log_z": ref}
        if not abs(lz.mean() - ref) <= tol:
            raise AssertionError(f"animations ({name}): mean log Z {lz.mean()} vs {ref} "
                                 f"beyond {tol}")
        say("animations", program=name, T=t_len, N=4096, seeds=ANIMATION_SEEDS,
            log_z=np.round(lz, 4).tolist(), tolerance=round(tol, 4), **extra,
            wall_s=[round(r["wall_s"], 4) for r in res],
            wall_ms_per_step=round(1e3 * res[-1]["wall_s"] / (t_len - 1), 4),
            launches={k: v for k, v in counts.items() if v}, npz=shapes)
    return total


GRAPH_APF_T = 60  # phase 30's APF SMC² cut, as phase 28's and 29's (phase 13 runs the whole T)
# phase 30's particle-Gibbs cells, cut from phase 22's PG_SWEEPS and
# PG_LG_SWEEPS (tools/profile_port.py's cuts), and the sweeps of its
# launch-and-sync counts
GRAPH_PG_SWEEPS, GRAPH_PG_LG_SWEEPS, GRAPH_PG_READ_SWEEPS = 10, 100, (2, 4)
GRAPH_CSMC_SWEEPS = 40  # phase 30's iterated CSMC, cut from phase 22's CSMC_SWEEPS
GRAPH_PG_DSL_SWEEPS = 40  # phase 30's PG on the DSL AR(1), cut from phase 22's PG_LG_SWEEPS
REPLAY_T = 41  # replay_split's short filter: 40 steps, beside the whole T


# A profiled run's trace is whole only where the profiler took in both of
# its ends. On an NVIDIA H100 80GB HBM3 at 700 W, a window closed at once
# lost its tail (the last 200–600 of 60,400 device events) in 6 of 16
# profiled runs of phase 30's APF cell, and in none of 40 that waited 50 ms
# after it or ran one more kernel; inside the whole script, a window that
# waited 50 ms still lost 35 steps' kernels once. The head can go too: in
# some processes a trace drops its first device events, however long the
# window waited before them (the lone marker of an empty run, 3 traces in a
# row on one card; on another, all 4 marker kernels that ran 0.2–1.6 s
# after the window opened in about half of phase 30's traces, and 2–3 of
# the 4 in most others, while the run's own events after them were all
# there), in other processes none in 32 traces; with 64 such markers, a
# process's traces lost 0, 1, 2, … and from its eighth on 8–10 of them.
# So a window opens with a wait of PROFILE_SETTLE_S and HEAD_PADS long
# marker kernels (torch.cuda._sleep: ``spin_kernel``), which a trace may
# lose, and closes with a short marker and the wait; a trace that lost its
# short marker or every long one is taken again with the wait doubled, up
# to PROFILE_ATTEMPTS traces in all. A trace kept is held exactly: it is no
# use to count a trace that lost an end.
PROFILE_SETTLE_S = 0.2
PROFILE_ATTEMPTS = 4
HEAD_PADS = 256
MARKER = "spin_kernel"
HEAD_PAD_CYCLES = 200_000  # ≥ 0.1 ms at the card's 1980 MHz; the short marker's 1000, < 1 µs
RUN_SPAN = "chip_smoke.profiled_run"  # the annotation round the run inside the window


def _trace_ends(prof) -> dict:
    """What a trace kept of its ends: how many of the long head markers and
    of the short tail marker (the two told apart by their durations), and
    where its first and last device events lie, in ms from its start."""
    from torch.autograd import DeviceType

    results = prof.profiler.kineto_results
    start = results.trace_start_ns()
    kernels = sorted((e for e in results.events() if e.device_type() == DeviceType.CUDA),
                     key=lambda e: e.start_ns())
    markers = [e.duration_ns() for e in kernels if MARKER in e.name()]
    long = sum(d >= 20_000 for d in markers)
    return {"head_pads": long, "tail_markers": len(markers) - long,
            "device_events": len(kernels),
            "first_ms": round((kernels[0].start_ns() - start) / 1e6, 3) if kernels else None,
            "last_ms": round((kernels[-1].start_ns() - start) / 1e6, 3) if kernels else None}


def _profiled(torch, activities, fn):
    """(fn()'s result, its wall, the profiler, what the trace kept of its
    ends with the traces taken) of a run traced whole (see
    PROFILE_SETTLE_S). The run lies inside a RUN_SPAN annotation; the
    window's own synchronizes and markers lie outside it; the wall is the
    run's, to the device's end."""
    from torch.profiler import profile, record_function

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        settle = PROFILE_SETTLE_S * 2 ** (attempt - 1)
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            time.sleep(settle)
            for _ in range(HEAD_PADS):
                torch.cuda._sleep(HEAD_PAD_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with record_function(RUN_SPAN):
                out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(settle)
        ends = _trace_ends(prof)
        if ends["tail_markers"] == 1 and ends["head_pads"] > 0:
            kept = {"traces": attempt, "head_pads_lost": HEAD_PADS - ends["head_pads"]}
            return out, wall, prof, kept
        say("graphs", profile_end_lost=attempt, settle_s=settle, **ends)
    raise AssertionError(f"graphs: {PROFILE_ATTEMPTS} traces in a row lost an end")


# The device kernels each launch counter's wrapper launches, by their names
# in torch.profiler's events (the CUDA kernels are templates, K2 is Triton's
# step_kernel); K2's counter is the sum of its instances'.
KERNEL_EVENTS = {"resample_count": ("resample_count_kernel",),
                 "resample_sorted": ("resample_sorted_kernel",),
                 "ucsv_propagate": ("ucsv_raw_kernel", "ucsv_norm_kernel", "ucsv_norm_loop_kernel"),
                 "fused_propagate": ("step_kernel",)}


def _busy(torch, label: str, fn) -> dict:
    """One run of ``fn`` (→ (result, wall, launch counts)) under
    torch.profiler: its wall, the device time of its kernels and copies,
    their count, and the busy share (device time / wall); the device's
    activity only (the host's ops would slow the trace's parsing). Fails
    unless the profiler saw each kernel (KERNEL_EVENTS) run as many times
    as its counter counted: a count that no launch backs, or a launch that
    no counter counts, whether eager or from a graph's replay. The trace is
    taken whole (:func:`_profiled`); the markers are left out of its numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    out, wall, prof, kept = _profiled(torch, [ProfilerActivity.CUDA], fn)
    counts = out[2]
    # the trace's own events, not torch's Python parse of them (minutes for
    # a run of a few hundred thousand kernels)
    events = [(e.name(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0
              and MARKER not in e.name()]
    seen = {k: sum(any(key == name or f"{name}<" in key for name in names)
                   for key, _ in events)
            for k, names in KERNEL_EVENTS.items()}
    counted = {k: sum(v for c, v in counts.items() if c == k or c.startswith(k + "_"))
               for k in KERNEL_EVENTS}
    if seen != counted:
        raise AssertionError(f"graphs ({label}): the profiler saw kernels {seen}, the counters"
                             f" counted {counted}")
    device_s = sum(ns for _, ns in events) / 1e9
    return {"profiled_wall_s": round(wall, 4), "device_s": round(device_s, 4),
            "device_events": len(events), "kernel_events": seen,
            "busy": round(device_s / wall, 4), **kept}


def _graph_pool_mb(torch) -> float:
    """MB that the memory pool the captured graphs share holds (the
    private pools' segments; the port captures into one)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0)) / 2**20


def check_graphs(torch, flagship):
    """Phase 30 (see the module's docstring); ``flagship``, the 512×8192
    SMC² state of phase 7 (the posterior mixture's θ-cloud). Returns the
    runs' launch counts."""
    import sequential_monte_carlo_tpu_torch as smc
    from sequential_monte_carlo_tpu_torch.ops import graphs

    total = None
    state_fields = ("theta", "log_z", "log_omega", "particles", "log_w")

    def bitwise(a, b, names) -> dict:
        return {k: bool(torch.equal(getattr(a, k), getattr(b, k))) for k in names}

    def paired(label, run, compare, expected, steps, profile=False, routes=()):
        """run() → (result, wall s, counts): graphed, then eager from the
        same seed, held bit for bit and by their counts; then two runs each
        in turns (eager, graphed, graphed, eager), the graphs freed before
        each eager run, so that its peak memory holds no graph's buffers
        and the first graphed run captures again: walls (the better of two),
        the peak allocated memory of each mode's last run and the graphs'
        pool after the graphed runs, and the seconds of each route of the
        kinds ``routes`` took to warm up, capture and instantiate; with
        ``profile``, one profiled run each, its kernels' events held against
        the launch counters (_busy)."""
        nonlocal total
        smc.clear_graphs()
        got, wall_g, counts_g = run()
        with smc.disable_graphs():
            ref, wall_e, counts_e = run()
        same = compare(got, ref)
        if not all(same.values()):
            raise AssertionError(f"graphs ({label}): graphed and eager runs differ: {same}")
        if counts_g != counts_e:
            raise AssertionError(f"graphs ({label}): launches {counts_g} graphed, {counts_e}"
                                 " eager")
        expect_counts(f"graphs ({label})", counts_g, expected(got))
        total = _add(_add(total, counts_g), counts_e)
        walls, peak = {"graphed": [], "eager": []}, {}
        for mode in ("eager", "graphed", "graphed", "eager"):
            if mode == "eager":
                smc.clear_graphs()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ctx = smc.disable_graphs() if mode == "eager" else contextlib.nullcontext()
            with ctx:
                walls[mode].append(run()[1])
            peak[mode] = round(torch.cuda.max_memory_allocated() / 2**20, 1)
            if mode == "graphed":
                pool_mb = round(_graph_pool_mb(torch), 1)
                captures = {key[0]: {k: round(v, 4) for k, v in route.timing.items()}
                            for key, route in graphs._cache.items() if key[0] in routes}
        n = steps(got)
        row = {"run": label, "inner_steps": n, "bitwise": True, "launches": counts_g,
               "first_wall_s": {"graphed": round(wall_g, 4), "eager": round(wall_e, 4)}}
        for mode in walls:
            best = min(walls[mode])
            row[mode] = {"wall_s": round(best, 4), "walls_s": [round(w, 4) for w in walls[mode]],
                         "ms_per_inner_step": round(1e3 * best / n, 5),
                         "peak_allocated_mb": peak[mode]}
            if profile:
                if mode == "graphed":
                    run()  # the capture, outside the profiled run
                ctx = smc.disable_graphs() if mode == "eager" else contextlib.nullcontext()
                with ctx:
                    row[mode].update(_busy(torch, f"{label}, {mode}", run))
        row["speedup"] = round(row["eager"]["wall_s"] / row["graphed"]["wall_s"], 3)
        row["graph_pool_mb"] = pool_mb
        if routes:
            row["capture_s"] = captures
        say("graphs", **row)
        return row

    def smc2_same(a, b):
        (sa, ia), (sb, ib) = a, b
        return {**bitwise(sa, sb, state_fields), **bitwise(ia, ib, ia._fields)}

    def smc2_counts(kernel):
        return lambda out: {"resample_count": _schedule(out[1], CHAIN, []),
                            kernel: _schedule(out[1], CHAIN, [])}

    rows = {}
    for n in (1024, 8192):
        def run(n=n):
            return _counted(torch, lambda: run_slice(torch, n, SEED)[:2])

        rows[f"smc2_{n}"] = paired(f"smc2 ucsv 512x{n}", run, smc2_same,
                                   smc2_counts("fused_propagate_ucsv"),
                                   lambda out: _schedule(out[1], CHAIN, []), profile=True)

    for label, kernels in (("dta", ("resample_count", "fused_propagate_lg1")),
                           ("dtb", ("resample_sorted", "fused_propagate_lg1_carry"))):
        def run(label=label):
            state, trace, wall, counts = run_dt(torch, DT_INNER[label], SEED)
            return (state, trace), wall, counts

        def dt_same(a, b):
            same = bitwise(a[0], b[0], state_fields)
            same["stages"] = a[1] == b[1]
            return same

        def dt_steps(out):
            return (DT_T - 1) * (1 + DT_CHAIN * sum(stage.xi < 1.0 for stage in out[1]))

        rows[label] = paired(f"dt ({label[-1]})", run, dt_same,
                             lambda out, k=kernels: {k[0]: dt_steps(out), k[1]: dt_steps(out)},
                             dt_steps, profile=label == "dtb")

    y_apf = series(torch, "cuda")[:GRAPH_APF_T]

    def run_apf():
        state, infos, wall, counts = run_apf_smc2(torch, smc.ucsv_model, PRIOR_SPEC, y_apf, CHAIN,
                                                  SEED)
        return (state, infos), wall, counts

    rows["apf"] = paired(f"smc2 ucsv apf 512x1024, T={GRAPH_APF_T}", run_apf, smc2_same,
                         smc2_counts("ucsv_propagate"), lambda out: _schedule(out[1], CHAIN, []),
                         profile=True)

    y_lg = torch.tensor(lg_series(), device="cuda")
    model = smc.lg_model(torch.tensor(LG_THETA, device="cuda"))

    def run_per_theta():
        return _counted(torch, lambda: [smc.log_likelihood(
            torch.Generator(device="cuda").manual_seed(600 + s), model, DT_N, y_lg)
            for s in range(PER_THETA_SEEDS)])

    def per_theta_same(a, b):
        return {f"run{i}_{k}": bool(torch.equal(x, z)) for i, (ra, rb) in enumerate(zip(a, b))
                for k, x, z in (("particles", ra[0].particles, rb[0].particles),
                                ("log_w", ra[0].log_weights, rb[0].log_weights),
                                ("log_z", ra[1], rb[1]))}

    steps = (DT_T - 1) * PER_THETA_SEEDS
    rows["per_theta"] = paired("per_theta lg 1x1024", run_per_theta, per_theta_same,
                               lambda out: {"resample_count": steps, "fused_propagate_lg1": steps},
                               lambda out: steps)

    # run_segmented with the inflation example's collector, UC 512×1024
    import tempfile

    from sequential_monte_carlo_tpu_torch.examples import inflation as ex

    outdir = tempfile.mkdtemp(prefix="smc_graphs_")
    y_pce = ex.load_pce("cuda")[1]
    n_uc, m_uc, chain_uc = ex.FULL_SIZES["uc"]

    def run_inflation():
        out, _, counts = _counted(torch, lambda: ex.run_online(
            "uc", smc.uc_model, ex.uc_prior("cuda"), y_pce, n_uc, m_uc, chain_uc, outdir,
            figures=False))
        return out, out["wall_s"], counts

    def inflation_same(a, b):
        same = bitwise(a["state"], b["state"], state_fields)
        same.update({f"info_{k}": bool(torch.equal(getattr(a["infos"], k), getattr(b["infos"], k)))
                     for k in a["infos"]._fields})
        same.update({k: bool(np.array_equal(a[k], b[k])) for k in ("xq", "cq", "var")})
        return same

    def inflation_steps(out):
        return _schedule(out["infos"], chain_uc, [])

    rows["inflation_uc"] = paired(
        f"run_segmented uc {m_uc}x{n_uc}, inflation collector", run_inflation, inflation_same,
        lambda out: {"resample_count": inflation_steps(out),
                     "fused_propagate_lg1": inflation_steps(out)}, inflation_steps, profile=True)

    # filter_sequence (quantile summary), FFBS's forward pass, the posterior
    # mixture's 8-row bank: UC-SV at N = 8192 on the store routes
    ys = series(torch, "cuda")
    ucsv = smc.ucsv_model(torch.tensor(JAX_MEAN, device="cuda"))
    ps = [0.05, 0.5, 0.95]

    def summarize(state):
        from sequential_monte_carlo_tpu_torch.analysis import weighted_quantile

        return weighted_quantile(state.particles[:, 0], torch.exp(state.log_weights), ps)

    stored = {
        "filter_sequence": (f"filter_sequence ucsv 1x{FFBS_N}, quantile summary",
                            lambda gen: smc.filter_sequence(gen, ucsv, FFBS_N, ys,
                                                            summarize=summarize),
                            "fused_propagate_ucsv"),
        "ffbs_forward": (f"ffbs forward pass ucsv 1x{FFBS_N}",
                         lambda gen: smc.forward_clouds(gen, ucsv, FFBS_N, ys),
                         "fused_propagate_ucsv"),
        "posterior_mixture": (f"posterior mixture ucsv {MIX_THETA}x{FFBS_N}",
                              lambda gen: smc.posterior_smoothed_paths(
                                  gen, smc.ucsv_model, flagship.theta, flagship.log_omega, ys,
                                  FFBS_N, n_theta=MIX_THETA, n_paths=MIX_PATHS),
                              "fused_propagate_ucsv")}
    for name, (label, fn, kernel) in stored.items():
        def run(fn=fn):
            return _counted(torch, lambda: fn(torch.Generator(device="cuda").manual_seed(1500)))

        def tree_same(a, b):
            from sequential_monte_carlo_tpu_torch.ops.graphs import _leaves

            return {f"leaf{i}": bool(torch.equal(x, z))
                    for i, (x, z) in enumerate(zip(_leaves(a), _leaves(b), strict=True))}

        rows[name] = paired(label, run, tree_same,
                            lambda out, k=kernel: {"resample_count": T - 1, k: T - 1},
                            lambda out: T - 1, profile=True)
    # particle Gibbs (one graph a sweep) and iterated CSMC (one a sweep),
    # phase 22's cells cut in sweeps, and PG's initial multinomial bank
    def pg_same(a, b):
        fields = ("theta", "acc_ratio", "final_path", "paths")
        return {k: (getattr(a, k) is None and getattr(b, k) is None)
                or bool(torch.equal(getattr(a, k), getattr(b, k))) for k in fields}

    y_pg_lg = torch.tensor(lg_series(PG_LG_T), device="cuda")
    pg_cells = {
        "pg_ucsv_bs": (smc.ucsv_model, PRIOR_SPEC, ys, "bs", PG_N, GRAPH_PG_SWEEPS, 0,
                       "ucsv_propagate", "fused_propagate_ucsv"),
        "pg_ucsv_as": (smc.ucsv_model, PRIOR_SPEC, ys, "as", PG_N, GRAPH_PG_SWEEPS, 0,
                       "ucsv_propagate", "fused_propagate_ucsv"),
        "pg_lg": (smc.lg_model, LG_PRIOR_SPEC, y_pg_lg, "bs", PG_LG_N, GRAPH_PG_LG_SWEEPS,
                  PG_LG_CHAINS, "fused_propagate_lg1_raw", "fused_propagate_lg1")}
    for name, (model_fn, spec, y, method, n, sweeps, chains, k_csmc, k_init) in pg_cells.items():
        cfg = smc.PGConfig(n_particles=n, sweeps=sweeps, chain=PG_CHAIN, method=method,
                           collect_paths=True)
        t_len = y.shape[0]

        def run(model_fn=model_fn, spec=spec, y=y, cfg=cfg, chains=chains):
            return run_pg(torch, model_fn, spec, y, cfg, 1500, chains)[:3]

        rows[name] = paired(
            f"pg {name[3:]} {max(chains, 1)}x{n}, T={t_len}, {sweeps} sweeps (cut from"
            f" {PG_SWEEPS if chains == 0 else PG_LG_SWEEPS})", run, pg_same,
            lambda out, k=(k_csmc, k_init), t=t_len, sw=sweeps: {k[0]: (t - 1) * sw,
                                                                 k[1]: t - 1},
            lambda out, t=t_len, sw=sweeps: (t - 1) * (sw + 1), profile=True,
            routes=("pg", "stored"))

    y_csmc = torch.tensor(lg_series(CSMC_T), device="cuda")
    lg_star = smc.lg_model(torch.tensor(LG_THETA, device="cuda"))
    for method in ("bs", "as"):
        def run(method=method):
            return _counted(torch, lambda: iterate_csmc(torch, lg_star, y_csmc, method,
                                                        GRAPH_CSMC_SWEEPS))

        rows[f"csmc_{method}"] = paired(
            f"iterated csmc_sweep {method} lg 1x{CSMC_N}, T={CSMC_T}, {GRAPH_CSMC_SWEEPS} sweeps"
            f" (cut from {CSMC_SWEEPS})", run, lambda a, b: {"paths": bool(torch.equal(a, b))},
            lambda out: {"fused_propagate_lg1_raw": (CSMC_T - 1) * GRAPH_CSMC_SWEEPS},
            lambda out: (CSMC_T - 1) * GRAPH_CSMC_SWEEPS, profile=True, routes=("csmc",))
    rows.update(inner_route_cells(torch, smc, paired, smc2_same))
    rows.update(ibis_cells(torch, smc, paired))
    rows.update(elastic_cells(torch, smc, paired, smc2_same))
    rows["collector_launches"] = collector_launches(torch, smc)
    rows["ibis_replays_and_reads"] = ibis_replays_and_reads(torch, smc)
    rows["replays_and_reads"] = replays_and_reads(torch, smc)
    rows["pg_replays_and_reads"] = pg_replays_and_reads(torch, smc)
    rows["replay_split"] = replay_split(torch, smc)
    return total, rows


def inner_route_cells(torch, smc, paired, smc2_same) -> dict:
    """Phase 30's cells of the inner routes beyond the fused kernels, each
    through ``paired`` (graphed, then its eager twin, bit for bit, launch
    counts, walls, busy share, graph pool, capture seconds): the DSL UC-SV
    SMC² at 512×1024, chain CHAIN, cut to its first GRAPH_APF_T
    observations (K1 only: the plain propagate route); the DSL UC-SV bank
    at 512×1024, bootstrap and APF (K1); the residual and metropolis LG
    banks (K2-LG after their ancestors) and the guided one (K1) at 512×1024,
    T=100; particle Gibbs on the DSL AR(1), PG_LG_CHAINS chains at
    PG_LG_T×PG_LG_N cut to GRAPH_PG_DSL_SWEEPS sweeps (no kernel: the
    multinomial ancestors and the plain propagate route)."""
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec
    from sequential_monte_carlo_tpu_torch.ops.graphs import _leaves

    def tree_same(a, b):
        return {f"leaf{i}": bool(torch.equal(x, z))
                for i, (x, z) in enumerate(zip(_leaves(a), _leaves(b), strict=True))}

    rows = {}
    ucsv = ucsv_dsl(smc, torch)
    sampler = smc.SMC2(ucsv, prior_from_spec(PRIOR_SPEC, device="cuda"), smc.SMCConfig(
        n_particles=1024, n_theta=512, chain=CHAIN, ess_threshold=0.5))
    y = series(torch, "cuda")

    def run_smc2():
        return _counted(torch, lambda: sampler.run(
            torch.Generator(device="cuda").manual_seed(SEED), y[:GRAPH_APF_T]))

    rows["dsl_smc2"] = paired(
        f"smc2 ucsv via ssm_model 512x1024, T={GRAPH_APF_T} (cut from {T})", run_smc2, smc2_same,
        lambda out: {"resample_count": _schedule(out[1], CHAIN, [])},
        lambda out: _schedule(out[1], CHAIN, []), profile=True, routes=("online", "masked"))

    def bank(models, ys, inner, kernels, label):
        def run():
            return _counted(torch, lambda: smc.batched_log_likelihood(
                torch.Generator(device="cuda").manual_seed(1600), models, DT_N, DT_M, ys,
                smc.PFConfig(*inner)))

        steps = ys.shape[0] - 1
        return paired(label, run, tree_same, lambda out: {k: steps for k in kernels},
                      lambda out: steps, profile=True, routes=("masked",))

    models = ucsv(torch.tensor(JAX_MEAN, device="cuda").expand(DT_M, 4))
    for alg in ("bootstrap", "apf"):
        rows[f"dsl_bank_{alg}"] = bank(models, y, ("systematic", 1.0, None, alg),
                                       ("resample_count",),
                                       f"ucsv via ssm_model bank {alg} {DT_M}x{DT_N}, T={T}")
    y_lg, lg = torch.tensor(lg_series(), device="cuda"), _lg_cloud(torch, smc, DT_M, 1)
    for label, inner, kernels in (
            ("residual", ("residual", 1.0), ("fused_propagate_lg1",)),
            ("metropolis", ("metropolis", 1.0), ("fused_propagate_lg1",)),
            ("guided", ("systematic", 1.0, widened_proposal(smc, torch)), ("resample_count",))):
        rows[f"bank_{label}"] = bank(lg, y_lg, inner, kernels,
                                     f"lg bank {label} {DT_M}x{DT_N}, T={DT_T}")

    def pg_same(a, b):
        return tree_same(tuple(a), tuple(b))

    cfg = smc.PGConfig(n_particles=PG_LG_N, sweeps=GRAPH_PG_DSL_SWEEPS, chain=PG_CHAIN,
                       method="bs", collect_paths=True)
    y_pg = torch.tensor(lg_series(PG_LG_T), device="cuda")
    ar1 = ar1_dsl(smc, torch)
    rows["pg_dsl_ar1"] = paired(
        f"pg ar1 via ssm_model {PG_LG_CHAINS}x{PG_LG_N}, T={PG_LG_T}, {GRAPH_PG_DSL_SWEEPS}"
        f" sweeps (cut from {PG_LG_SWEEPS})",
        lambda: run_pg(torch, ar1, LG_PRIOR_SPEC, y_pg, cfg, 1500, PG_LG_CHAINS)[:3], pg_same,
        lambda out: {}, lambda out: (PG_LG_T - 1) * (GRAPH_PG_DSL_SWEEPS + 1), profile=True,
        routes=("pg", "stored"))
    return rows


def _runtime_trace(torch, fn) -> tuple:
    """(fn()'s result, the names of the CUDA API calls (``cuda*``, ``cu*``)
    it made, in the order made), under torch.profiler with the host's
    activity, the trace taken whole (:func:`_profiled`): the calls that lie
    inside its RUN_SPAN annotation, so neither the window's markers nor its
    synchronizes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    out, _, prof, _ = _profiled(torch, [ProfilerActivity.CPU, ProfilerActivity.CUDA], fn)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU]
    (span,) = [e for e in events if e.name() == RUN_SPAN]
    return out, [e.name() for e in sorted(events, key=lambda e: e.start_ns())
                 if e.name().startswith("cu") and span.start_ns() <= e.start_ns()
                 and e.end_ns() <= span.end_ns()]


def _runtime_calls(torch, fn) -> dict:
    """(fn()'s result, counts of the CUDA runtime calls it made, by name;
    :func:`_runtime_trace`)."""
    out, names = _runtime_trace(torch, fn)
    return out, collections.Counter(name for name in names if name.startswith("cuda"))


def _launch_gaps(names) -> list:
    """The host's launches (kernels, copies, fills) between consecutive
    graph launches of a trace's calls: one count before the first, one
    after each."""
    gaps = [0]
    for name in names:
        if name == "cudaGraphLaunch":
            gaps.append(0)
        elif any(k in name for k in ("LaunchKernel", "Memcpy", "Memset")):
            gaps[-1] += 1
    return gaps


def ibis_cells(torch, smc, paired) -> dict:
    """Phase 30's IBIS cells through ``paired`` (graphed, then its eager
    twin, bit for bit, launch counts — none: IBIS runs no kernel of the
    port —, walls, busy share, graph pool, capture seconds): the ibis
    phase's run (LG, 512 θ, T=100, chain 3; its online route and the
    rejuvenations' Kalman passes on the live route), and kalman_filter at a
    512-θ bank of prior draws over the same series (the store route)."""
    ibis, y = ibis_sampler(torch)
    fields = ("theta", "log_omega", "mean", "cov", "log_z", "ess", "acc_ratio")

    def run_ibis():
        return _counted(torch, lambda: ibis.run(torch.Generator(device="cuda").manual_seed(SEED),
                                                y))

    def ibis_same(a, b):
        (sa, ia), (sb, ib) = a, b
        same = {k: bool(torch.equal(getattr(sa, k), getattr(sb, k))) for k in fields}
        same.update({f"info_{k}": bool(torch.equal(getattr(ia, k), getattr(ib, k)))
                     for k in ia._fields})
        return same

    def kalman_steps(out):
        ts = [i + 1 for i, fired in enumerate(out[1].rejuvenated.tolist()) if fired]
        return (DT_T - 1) + sum(DT_CHAIN * t for t in ts)

    rows = {"ibis": paired(f"ibis lg {DT_M} θ, T={DT_T}, chain {DT_CHAIN}", run_ibis, ibis_same,
                           lambda out: {}, kalman_steps, profile=True, routes=("ibis", "kalman"))}
    models = smc.lg_model(ibis.prior.sample(torch.Generator(device="cuda").manual_seed(77),
                                            (DT_M,)))

    def run_kalman_filter():
        return _counted(torch, lambda: smc.kalman_filter(models, y))

    rows["kalman_filter"] = paired(
        f"kalman_filter lg {DT_M} θ, T={DT_T}", run_kalman_filter,
        lambda a, b: {f"out{i}": bool(torch.equal(x, z)) for i, (x, z) in enumerate(zip(a, b))},
        lambda out: {}, lambda out: DT_T, profile=True, routes=("kalman",))
    return rows


def elastic_doublings(infos) -> list:
    """The t at which an exchange-phase run's live count doubled: those of
    its first three rejuvenations (acc_threshold 1.1 fires the exchange
    after every one while the live count is ≤ 4096)."""
    return (infos.rejuvenated.nonzero().flatten() + 1).tolist()[:3]


def _elastic_collect(state):
    """The elastic cell's collector: the posterior mean, t, the live count
    (a fill of the route's host int), and whether the dead tail is exactly
    −inf and the live slots finite on every row."""
    import sequential_monte_carlo_tpu_torch as smc

    lw = state.log_w
    return (smc.expected_parameters(state), state.t, lw.new_full((), state.active_n, dtype=int),
            (lw[:, state.active_n:] == -math.inf).all(),
            lw[:, :state.active_n].isfinite().all())


def elastic_cells(torch, smc, paired, smc2_same) -> dict:
    """Phase 30's "full"-padding cell, the exchange phase's configuration
    (UC-SV, M=512, the arrays 512×8192 from the init, the live count 1024 →
    8192, T=241, chain 5, acc_threshold 1.1, exchange_max_n 4096): ``run``
    through ``paired`` (graphed on the online and masked routes of each
    live count, then its eager twin: θ, log ω, log Z, particles,
    log-weights, the final live count and every StepInfo bit for bit; K3's
    and K6's launches equal to the schedule; walls, busy share with the
    profiler's K3 and K6 events held against their counters, the graph
    pool); then, from cleared graphs, ``run`` graphed once and
    ``run_segmented`` with a captured collector (:func:`_elastic_collect`)
    graphed and eager: one capture per (kind, collector, live count) and no
    more, the routes graphed, the collector's series (the live count at
    every step among them) bitwise, the dead tail exactly −inf and the live
    slots finite after every step."""
    from sequential_monte_carlo_tpu_torch.ops import graphs

    sampler, y = exchange_sampler(torch, "full"), series(torch, "cuda")
    live_counts = [DT_N, 2 * DT_N, 4 * DT_N, N_CAP]

    def gen():
        return torch.Generator(device="cuda").manual_seed(SEED)

    def run():
        return _counted(torch, lambda: sampler.run(gen(), y))

    def steps(out):
        return _schedule(out[1], CHAIN, elastic_doublings(out[1]))

    def same(a, b):
        return {**smc2_same(a, b), "active_n": a[0].active_n == b[0].active_n == N_CAP,
                "doublings": len(elastic_doublings(a[1])) == 3}

    label = f"smc2 ucsv full padding {DT_M}x{N_CAP}, live {DT_N}..{N_CAP}"
    rows = {"elastic_full": paired(label, run, same, lambda out: {
        "resample_sorted": steps(out), "ucsv_propagate": steps(out)}, steps, profile=True)}

    captured, capture = [], graphs._Route.capture

    def counting(route, *args):
        captured.append(route)
        return capture(route, *args)

    smc.clear_graphs()
    graphs._Route.capture = counting
    try:
        got, wall_g, _ = run()
        collected_g, wall_cg, counts_cg = _counted(torch, lambda: sampler.run_segmented(
            gen(), y, collect_fn=_elastic_collect))
    finally:
        graphs._Route.capture = capture
    routes = list(graphs._cache.values())
    pairs = {(type(r.buffers).__name__, getattr(r.buffers, "collect", None) is not None,
              r.buffers.active_n) for r in routes}
    want = {(kind, c, n) for kind, c in (("StepBuffers", False), ("OnlineBuffers", False),
                                         ("OnlineBuffers", True)) for n in live_counts}
    if not (len(captured) == len(routes) == len(pairs) and pairs == want
            and all(r.graphed for r in routes)):
        raise AssertionError(f"graphs ({label}): {len(captured)} captures, routes"
                             f" {sorted(pairs, key=str)}, expected one each of"
                             f" {sorted(want, key=str)}")
    with smc.disable_graphs():
        collected_e, wall_ce, counts_ce = _counted(torch, lambda: sampler.run_segmented(
            gen(), y, collect_fn=_elastic_collect))
    (sg, (ig, series_g)), (se, (ie, series_e)) = collected_g, collected_e
    same_c = {**smc2_same((sg, ig), (se, ie)),
              **{f"series{i}": bool(torch.equal(a, b))
                 for i, (a, b) in enumerate(zip(series_g, series_e, strict=True))}}
    if not all(same_c.values()) or counts_cg != counts_ce:
        raise AssertionError(f"graphs ({label}, collector): graphed and eager runs differ:"
                             f" {same_c}, launches {counts_cg} graphed, {counts_ce} eager")
    _, ts, sizes, tails, finite = series_g
    seen = sorted(set(sizes.tolist()))
    if not (bool(tails.all()) and bool(finite.all()) and seen[-1] == N_CAP
            and set(seen) <= set(live_counts) and bool((sizes[1:] >= sizes[:-1]).all())
            and torch.equal(ts.cpu(), torch.arange(2, y.shape[0] + 1))):
        raise AssertionError(f"graphs ({label}, collector): live counts {seen}, dead tails"
                             f" −inf {bool(tails.all())}, live slots finite {bool(finite.all())}")
    if not all(torch.equal(getattr(sg, k), getattr(got[0], k)) for k in ("theta", "log_z")):
        raise AssertionError(f"graphs ({label}): run_segmented with a collector and run differ")
    timing = collections.defaultdict(float)
    for r in routes:
        for k, v in r.timing.items():
            timing[f"{type(r.buffers).__name__}_{k}"] += v
    rows["elastic_collector"] = {
        "run": f"{label}, routes and run_segmented with a collector", "captures": len(captured),
        "routes": len(routes), "live_counts_stepped": seen, "bitwise": True,
        "launches_equal": True, "inner_steps": _schedule(ig, CHAIN, elastic_doublings(ig)),
        "wall_s": {"run_graphed_first": round(wall_g, 4), "collector_graphed_first":
                   round(wall_cg, 4), "collector_eager": round(wall_ce, 4)},
        "capture_s": {k: round(v, 4) for k, v in sorted(timing.items())},
        "graph_pool_mb": round(_graph_pool_mb(torch), 1)}
    say("graphs", **rows["elastic_collector"])
    return rows


def collector_launches(torch, smc) -> dict:
    """``run_segmented`` on the UC model at the inflation example's FULL
    size (512×1024, chain 3, the PCE series), graphed, with the example's
    collector and without one, each under torch.profiler with the host's
    activity, its routes captured before: the same graph launches, and the
    host's launches between consecutive graph launches (the flag reads and
    the rejuvenations) the same gap for gap — the captured collector adds
    none between replays; only the series' copy-out after the last differs."""
    from sequential_monte_carlo_tpu_torch.examples import inflation as ex

    y = ex.load_pce("cuda")[1]
    n, m, chain = ex.FULL_SIZES["uc"]
    sampler = smc.SMC2(smc.uc_model, ex.uc_prior("cuda"), smc.SMCConfig(
        n_particles=n, n_theta=m, chain=chain, ess_threshold=ex.ESS_THRESHOLD))
    row, gaps = {"run": f"run_segmented uc {m}x{n}, collector launches, graphed"}, {}
    for name, collect in (("collector", ex.online_collector(y)), ("none", None)):
        def run(collect=collect):
            out = sampler.run_segmented(torch.Generator(device="cuda").manual_seed(SEED), y,
                                        segment_size=16, collect_fn=collect)
            torch.cuda.synchronize()
            return out
        run()  # the captures
        _, names = _runtime_trace(torch, run)
        gaps[name] = _launch_gaps(names)
        row[name] = {"graph_launches": len(gaps[name]) - 1,
                     "host_launches_between_replays": sum(gaps[name][1:-1]),
                     "host_launches_before_first": gaps[name][0],
                     "host_launches_after_last": gaps[name][-1]}
    row["gaps_equal"] = gaps["collector"][:-1] == gaps["none"][:-1]
    say("graphs", **row)
    if not row["gaps_equal"]:
        diff = [i for i, (a, b) in enumerate(zip(gaps["collector"], gaps["none"])) if a != b]
        raise AssertionError(f"graphs (collector launches): the gaps differ at {diff[:10]}:"
                             f" {row}")
    return row


def ibis_replays_and_reads(torch, smc) -> dict:
    """The ibis phase's run, graphed, under torch.profiler with the host's
    activity: its graph launches one an online step plus, per rejuvenation
    at t, ``chain`` Kalman passes of ⌊t/S⌋ + t mod S; its host syncs one an
    online step (the flag read) plus a rejuvenation's own (one counted
    alone) each, and one Kalman pass alone none but its closing
    synchronize."""
    from sequential_monte_carlo_tpu_torch.ops import kalman

    ibis, y = ibis_sampler(torch)

    def run():
        out = ibis.run(torch.Generator(device="cuda").manual_seed(SEED), y)
        torch.cuda.synchronize()
        return out

    run()  # the captures
    (state, infos), calls = _runtime_calls(torch, run)
    n_rejuv = int(infos.rejuvenated.sum())
    launches = (DT_T - 1) + kalman_graph_launches(infos, DT_CHAIN)
    gen = torch.Generator(device="cuda").manual_seed(1)
    _, one = _runtime_calls(torch, lambda: ibis._rejuvenate(
        gen, ibis._resample_theta(gen, state), y, DT_T))
    models = ibis.model_fn(state.theta)

    def kalman_pass():
        out = kalman.live_log_likelihood(models, y, DT_T, True)
        torch.cuda.synchronize()
        return out

    _, passed = _runtime_calls(torch, kalman_pass)
    syncs = sum(calls[k] for k in SYNC_CALLS)
    per_rejuv = sum(one[k] for k in SYNC_CALLS)
    want = (DT_T - 1) + n_rejuv * per_rejuv + 1  # and run()'s own synchronize
    row = {"run": f"ibis lg {DT_M} θ, graphed", "online_steps": DT_T - 1,
           "rejuvenations": n_rejuv, "graph_launches": calls["cudaGraphLaunch"],
           "graph_launches_expected": launches, "host_syncs": syncs, "host_syncs_expected": want,
           "syncs_per_rejuvenation": per_rejuv,
           "kalman_pass_host_syncs": sum(passed[k] for k in SYNC_CALLS),
           "kalman_pass_graph_launches": passed["cudaGraphLaunch"],
           "sync_calls": {k: calls[k] for k in SYNC_CALLS}}
    say("graphs", **row)
    if (calls["cudaGraphLaunch"] != launches or syncs != want
            or row["kalman_pass_host_syncs"] != 1):
        raise AssertionError(f"graphs (ibis replays and reads): {row}")
    return row


# the runtime calls by which the host waits for the device: a host read
# (.item(), an event's or a stream's synchronize) or a device synchronize
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize")


def replays_and_reads(torch, smc) -> dict:
    """The slice's SMC² at 512×1024, graphed, under torch.profiler with the
    host's activity: its graph launches (``cudaGraphLaunch``) must be one an
    online step plus, per rejuvenation at t, ``chain`` masked filters of
    ⌊(t−1)/S⌋ + (t−1) mod S launches each; its host syncs one an online
    step (the flag read) plus a rejuvenation's own (counted alone, one
    rejuvenation of the final state under the profiler) each."""
    from sequential_monte_carlo_tpu_torch.ops import graphs

    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec

    s = graphs.STEPS_PER_GRAPH
    # run_slice's run, its prior and series made outside the profiled window
    # (each number copied to the card from host memory is a stream sync)
    sampler = smc.SMC2(smc.ucsv_model, prior_from_spec(PRIOR_SPEC, device="cuda"), smc.SMCConfig(
        n_particles=1024, n_theta=512, chain=CHAIN, ess_threshold=0.5))
    y = series(torch, "cuda")

    def run():
        out = sampler.run(torch.Generator(device="cuda").manual_seed(SEED), y)
        torch.cuda.synchronize()
        return out

    run()  # the captures
    (state, infos), calls = _runtime_calls(torch, run)
    rejuv_t = (torch.nonzero(infos.rejuvenated).flatten() + 1).tolist()
    steps = len(infos.ess)
    launches = steps + sum(CHAIN * filter_graph_launches(t - 1) for t in rejuv_t)
    _, one = _runtime_calls(torch, lambda: sampler._resample_move(
        torch.Generator(device="cuda").manual_seed(1), state, y, torch.arange(T) < T))
    syncs = sum(calls[k] for k in SYNC_CALLS)
    per_rejuv = sum(one[k] for k in SYNC_CALLS)
    want = steps + len(rejuv_t) * per_rejuv + 1  # and run()'s own synchronize
    row = {"run": "smc2 ucsv 512x1024, graphed", "online_steps": steps,
           "rejuvenations": len(rejuv_t), "steps_per_graph": s,
           "graph_launches": calls["cudaGraphLaunch"], "graph_launches_expected": launches,
           "host_syncs": syncs, "host_syncs_expected": want,
           "syncs_per_rejuvenation": per_rejuv,
           "sync_calls": {k: calls[k] for k in SYNC_CALLS}}
    say("graphs", **row)
    if calls["cudaGraphLaunch"] != launches or syncs != want:
        raise AssertionError(f"graphs (replays and reads): {row}")
    return row


def pg_replays_and_reads(torch, smc) -> dict:
    """Particle Gibbs on UC-SV at 241×8192 ("bs", one chain) and iterated
    csmc_sweep, graphed, their routes captured, under torch.profiler with
    the host's activity: the PG run's graph launches must be one a sweep
    beside its initial forward bank's ⌊(T−1)/S⌋ + (T−1) mod S, at two
    sweep counts, and iterated CSMC's one a sweep; the host syncs of each
    run only its own closing synchronize."""
    from sequential_monte_carlo_tpu_torch.interop import prior_from_spec
    from sequential_monte_carlo_tpu_torch.ops import graphs

    s = graphs.STEPS_PER_GRAPH
    prior, ys = prior_from_spec(PRIOR_SPEC, device="cuda"), series(torch, "cuda")
    y_csmc = torch.tensor(lg_series(CSMC_T), device="cuda")
    lg_star = smc.lg_model(torch.tensor(LG_THETA, device="cuda"))
    row, bad = {"run": "pg and csmc replays and reads, graphed", "steps_per_graph": s}, False
    cases = {f"pg_ucsv_bs_{sweeps}sweeps": (
        lambda sweeps=sweeps: smc.particle_gibbs(
            torch.Generator(device="cuda").manual_seed(1500), smc.ucsv_model, prior, ys,
            smc.PGConfig(n_particles=PG_N, sweeps=sweeps, chain=PG_CHAIN)),
        sweeps + filter_graph_launches(T - 1)) for sweeps in GRAPH_PG_READ_SWEEPS}
    cases["csmc_bs_10sweeps"] = (lambda: iterate_csmc(torch, lg_star, y_csmc, "bs", 10), 10)
    for name, (fn, launches) in cases.items():
        def run(fn=fn):
            out = fn()
            torch.cuda.synchronize()
            return out

        run()  # the captures
        _, calls = _runtime_calls(torch, run)
        syncs = sum(calls[k] for k in SYNC_CALLS)
        row[name] = {"graph_launches": calls["cudaGraphLaunch"],
                     "graph_launches_expected": launches, "host_syncs": syncs,
                     "host_syncs_expected": 1, "sync_calls": {k: calls[k] for k in SYNC_CALLS}}
        bad |= calls["cudaGraphLaunch"] != launches or syncs != 1
    say("graphs", **row)
    if bad:
        raise AssertionError(f"graphs (pg replays and reads): {row}")
    return row


def replay_split(torch, smc) -> dict:
    """Where a replayed step's wall goes: 512 UC-SV filters at JAX_MEAN,
    N=1024 (K1 + K2-UC-SV, captured), with STEPS_PER_GRAPH steps a launch
    and with one: the wall of one filter over the series' first REPLAY_T
    observations and over all T, and from the two the fixed cost of a filter
    (init, copy-in, result) apart from the wall per step; of the short
    filter, the host's time to issue it while the device waits behind a
    sleep kernel and the device's time to run it once issued (CUDA events),
    per step, the fixed cost included."""
    from sequential_monte_carlo_tpu_torch.ops import graphs

    models = smc.ucsv_model(torch.tensor(JAX_MEAN, device="cuda").expand(DT_M, 4))
    ys = series(torch, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    row, s_graph = {"run": "replay split, ucsv 512x1024"}, graphs.STEPS_PER_GRAPH
    try:
        for s in (s_graph, 1):
            graphs.STEPS_PER_GRAPH = s
            graphs.clear_graphs()
            walls = {}
            for t_len in (T, REPLAY_T):
                def run(y=ys[:t_len]):
                    return smc.batched_log_likelihood(gen, models, DT_N, DT_M, y)

                run()  # the capture
                best = float("inf")
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize()
                    best = min(best, time.perf_counter() - t0)
                walls[t_len] = best
            # the short filter behind the sleep: under a thousand queued launches
            torch.cuda._sleep(max(SLEEP_CYCLES, int(3 * walls[REPLAY_T] * sm_clock_hz())))
            t0 = time.perf_counter()
            start.record()
            run()
            end.record()
            issue = time.perf_counter() - t0
            started = start.query()  # the sleep must still be running
            end.synchronize()
            if started:
                raise AssertionError(f"graphs: issuing the replays took {issue:.4f} s, past the"
                                     " sleep")
            per_step = (walls[T] - walls[REPLAY_T]) / (T - REPLAY_T)
            row[f"steps_per_graph_{s}"] = {
                "wall_s": {str(k - 1): round(v, 5) for k, v in walls.items()},
                "wall_ms_per_step": round(1e3 * per_step, 5),
                "fixed_ms_per_filter": round(1e3 * (walls[REPLAY_T] - (REPLAY_T - 1) * per_step),
                                             4),
                "whole_call_ms_per_step": round(1e3 * walls[REPLAY_T] / (REPLAY_T - 1), 5),
                "host_issue_ms_per_step": round(1e3 * issue / (REPLAY_T - 1), 5),
                "device_ms_per_step": round(start.elapsed_time(end) / (REPLAY_T - 1), 5)}
    finally:
        graphs.STEPS_PER_GRAPH = s_graph
        graphs.clear_graphs()
    say("graphs", **row)
    return row


def main() -> int:
    import torch

    # -- 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    say("device", name=repr(kind), count=torch.cuda.device_count(), nvidia_smi=repr(smi),
        torch=torch.__version__, cuda=torch.version.cuda)

    t_phase, phase_s = time.perf_counter(), {}

    def mark(name: str) -> None:  # the seconds each group of phases took
        nonlocal t_phase
        now = time.perf_counter()
        phase_s[name] = round(now - t_phase, 2)
        t_phase = now

    # -- 2. build
    from sequential_monte_carlo_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    say("build", seconds=round(time.perf_counter() - t0, 3), library=_build.library_path().name)

    # -- 3 to 6. kernels against their plain versions
    shapes = [(512, 1024), (512, 8192)]
    gen = torch.Generator(device="cuda").manual_seed(1234)
    # the exchange's doublings run K1 and K2-UC-SV at 512×2048 and 512×4096
    # too; the LG banks run K1 at C=1 (dx=1) and C=5, 6 (dx=5, dx=5's APF)
    # the parallel phase's two θ-shards run K1 and K3 at 256 rows
    doubling = [(512, 2048), (512, 4096)]
    k1 = check_k1(torch, [(m, n, c) for c in (3, 4, 2) for m, n in shapes]
                  + [(m, n, 3) for m, n in doubling] + [(512, 1000, 3)]
                  + [(512, 1024, c) for c in (1, 5, 6)] + [(256, 1024, 3), (256, 8192, 3)], gen)
    k2 = check_k2(torch, shapes + doubling, gen)
    k3 = check_k3(torch, [(512, 1024, 1), (512, 8192, 3), (512, 1000, 1), (256, 8192, 3)], gen)
    k2i = check_k2_instances(torch, shapes, gen)

    mark("build_and_kernels")

    # -- 7. the UC-SV slice, through the public entry points
    reset_counts()
    state, infos, wall = run_slice(torch, 1024, SEED)
    slice_counts = launch_counts()
    rejuv_t = (torch.nonzero(infos.rejuvenated).flatten() + 1).tolist()
    expected = (T - 1) + sum(CHAIN * (t - 1) for t in rejuv_t)
    ess = state.ess.item()
    if not math.isfinite(ess):
        raise AssertionError(f"slice: θ-ESS is {ess}")
    expect_counts("slice", slice_counts, {"resample_count": expected,
                                          "fused_propagate_ucsv": expected})
    import sequential_monte_carlo_tpu_torch as smc

    mean = smc.expected_parameters(state).cpu().numpy()
    tol = TOL_Z * np.asarray(JAX_SD) * math.sqrt(1.0 + 1.0 / JAX_SEEDS)
    if not np.all(np.abs(mean - np.asarray(JAX_MEAN)) <= tol):
        raise AssertionError(f"slice: posterior mean {mean} vs JAX {JAX_MEAN} beyond {tol}")
    say("slice", shape="512x1024", T=T, chain=CHAIN, wall_s=round(wall, 4),
        rejuvenations=len(rejuv_t), rejuv_t=rejuv_t, launches=expected,
        ess=round(ess, 3), posterior_mean=np.round(mean, 5).tolist(),
        jax_mean=JAX_MEAN, tolerance=np.round(tol, 5).tolist())
    _, infos2, wall2 = run_slice(torch, 1024, SEED + 1)
    say("slice", shape="512x1024", run="second (warm)", wall_s=round(wall2, 4))
    native_ms_per_step = 1e3 * wall2 / _schedule(infos2, CHAIN, [])
    reset_counts()
    fstate, finfos, fwall = run_slice(torch, 8192, SEED)
    flagship_counts = launch_counts()
    fess = fstate.ess.item()
    if not math.isfinite(fess):
        raise AssertionError(f"flagship: θ-ESS is {fess}")
    rejuv_t = (torch.nonzero(finfos.rejuvenated).flatten() + 1).tolist()
    expected = (T - 1) + sum(CHAIN * (t - 1) for t in rejuv_t)
    expect_counts("flagship", flagship_counts, {"resample_count": expected,
                                                "fused_propagate_ucsv": expected})
    say("slice", shape="512x8192", wall_s=round(fwall, 4), rejuvenations=len(rejuv_t),
        rejuv_t=rejuv_t, launches_resample_count=flagship_counts["resample_count"],
        launches_fused_propagate_ucsv=flagship_counts["fused_propagate_ucsv"], ess=round(fess, 3),
        posterior_mean=np.round(smc.expected_parameters(fstate).cpu().numpy(), 5).tolist())
    slice_counts = {k: v + flagship_counts[k] for k, v in slice_counts.items()}

    mark("slice")

    # -- 8. density-tempered SMC on LG, two inner filters
    dt_counts, dt_ref_a = check_dt(torch, "a", DT_INNER["dta"], "resample_count",
                                   "fused_propagate_lg1")
    counts_b, dt_ref_b = check_dt(torch, "b", DT_INNER["dtb"], "resample_sorted",
                                  "fused_propagate_lg1_carry")
    dt_counts = {k: v + counts_b[k] for k, v in dt_counts.items()}
    oracle, oracle_ess = kalman_is_oracle(torch)
    say("dt", kalman_prior_is_mean=np.round(oracle, 5).tolist(), is_ess=round(oracle_ess, 1))

    mark("dt")

    # -- 9. parallel filters
    filter_counts = check_filters(torch)

    mark("filters")

    # -- 10 to 12. K6, K2's route without the normalize, K3 on K7–K9's grids
    k6 = check_k6(torch, shapes, gen)
    k2r = check_k2_instances(torch, shapes, gen, names=("ucsv_raw", "lg1_raw", "lg2_raw", "sv_raw"))
    check_k3_grids(torch, gen, k3)

    mark("k6_k2raw_k3grids")

    # -- 13. the auxiliary particle filter
    apf_counts = check_apf(torch)

    mark("apf")

    # -- 14 to 18. the exchange step, large N, K2-LG at dx ≥ 3, IBIS, the
    # inner filter's other routes
    exchange_counts, _, exchange_states = check_exchange(torch, gen)
    large_counts = check_large_n(torch, gen, k1, k3, k2i)
    check_k2_split(torch, gen)
    k2dx, lg_dx_counts = check_lg_dx(torch, shapes, gen)
    ibis_state = check_ibis(torch)
    routes_counts = check_routes(torch)

    mark("exchange_to_routes")

    # -- 19 to 22. the kernels at one row, the per-θ filters, the smoothers,
    # particle Gibbs
    check_one_row(torch, gen, k1, k3, k2, k2i, k2r, k6)
    check_bank_shapes(torch, gen, k1, k2, k2i, k2r, k6)
    per_theta_counts = check_per_theta(torch)
    smoothing_counts = check_smoothing(torch, fstate)
    pg_counts = check_pg(torch)

    mark("one_row_to_pg")

    # -- 23 to 25. the DSL, the inflation example, the utils
    dsl_counts = check_dsl(torch, native_ms_per_step, kind)
    inflation_counts = check_inflation(torch, gen, k1, k2i)
    utils_counts = check_utils(torch)

    mark("dsl_inflation_utils")

    # -- 26 and 27. θ-sharded SMC² and IBIS on two ranks of the card, the
    # animations
    refs = {"slice1024": _theta_fields(state), "slice8192": _theta_fields(fstate),
            **{pad: _theta_fields(st) for pad, st in exchange_states.items()},
            "ibis": {**_theta_fields(ibis_state), "mean": ibis_state.mean.cpu().numpy(),
                     "cov": ibis_state.cov.cpu().numpy()}}
    one_rank_ms = {1024: round(native_ms_per_step, 4),
                   8192: round(1e3 * fwall / _schedule(finfos, CHAIN, []), 4)}
    parallel_counts = check_parallel(torch, refs, one_rank_ms)
    animation_counts = check_animations(torch)

    mark("parallel_animations")

    # -- 28. particle-axis sharding: the kernels' windows and offsets, then
    # SMC² and IBIS on (θ, particle) meshes of ranks on the card
    check_windows(torch, gen, k1, k3, k2, k2r, k6)
    particle_counts = check_particle(torch, refs["ibis"])

    mark("particle")

    # -- 29. density-tempered SMC on θ, particle and (θ, particle) meshes,
    # and K6 on particle slices off a multiple of 16
    check_k6_slices(torch, gen, k6)
    dt_mesh_counts = check_dt_mesh(torch, {"dta": dt_ref_a, "dtb": dt_ref_b})

    mark("dt_mesh")

    # -- 30. the masked filter's captured steps against its eager loop
    graph_counts, _ = check_graphs(torch, fstate)

    mark("graphs")

    # launches of each kernel over the main paths (slice at 512×1024 and
    # 512×8192, dt, filters, apf, exchange, large_n, lg_dx, routes,
    # per_theta, smoothing, pg, dsl, inflation, utils, parallel, particle
    # and dt_mesh (every rank's runs), animations, graphs), each read just
    # after its run
    runs = (slice_counts, dt_counts, filter_counts, apf_counts, exchange_counts, large_counts,
            lg_dx_counts, routes_counts, per_theta_counts, smoothing_counts, pg_counts,
            dsl_counts, inflation_counts, utils_counts, parallel_counts, animation_counts,
            particle_counts, dt_mesh_counts, graph_counts)
    launches = {k: sum(run.get(k, 0) for run in runs) for k in slice_counts}
    for name, n in launches.items():
        if name not in ("fused_propagate_lg2_carry", "fused_propagate_sv_carry",
                        "fused_propagate_ucsv_raw") and n == 0:
            raise AssertionError(f"kernel {name} was not launched on any path")

    def entry(name, route, source, replaces, res, key="512x1024"):
        ms, plain_ms, b_ms, b_by, b_limit = res[key]
        e = {"name": name, "route": route, "source": source, "replaces": replaces,
             "launches": launches[name], "max_abs_err": res["max_abs_err"], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "bound_limit": b_limit,
             "library_ms": None}
        for other, val in res.items():
            if other in (key, "max_abs_err", "anc_mismatch"):
                continue
            if isinstance(val, tuple):
                (e[f"ms_{other}"], e[f"plain_ms_{other}"], e[f"bound_ms_{other}"], _,
                 e[f"bound_limit_{other}"]) = val
            else:
                e[other] = val
        return e

    pkg = "sequential_monte_carlo_tpu_torch"
    propagate = "sequential_monte_carlo_tpu/kernels/propagate_pallas.py:48"
    for m, n in shapes + doubling:
        k2[f"{m}x{n}"] += bound_ms(**propagate_cost(m, n, 3, 2, False, "ucsv", True))
    kernels = [
        entry("resample_count", "cuda", f"{pkg}/csrc/resample_count.cu",
              "sequential_monte_carlo_tpu/kernels/resample_walk.py:258", k1),
        entry("resample_sorted", "cuda", f"{pkg}/csrc/resample_sorted.cu",
              "sequential_monte_carlo_tpu/kernels/resample_walk.py:125; "
              "sequential_monte_carlo_tpu/kernels/resample_pallas.py:74; "
              "sequential_monte_carlo_tpu/kernels/resample_pallas.py:180; "
              "benchmarks/ablations/resample_take_walk.py:123; "
              "benchmarks/ablations/resample_banded.py:148; "
              "benchmarks/proto_walk4.py:98; benchmarks/proto_walk4.py:300; "
              "benchmarks/proto_walk4.py:413; benchmarks/proto_walk4.py:531", k3),
        entry("fused_propagate_ucsv", "triton", f"{pkg}/kernels/propagate.py", propagate, k2),
        entry("ucsv_propagate", "cuda", f"{pkg}/csrc/ucsv_propagate.cu",
              "sequential_monte_carlo_tpu/kernels/ucsv_pallas.py:54", k6),
    ]
    for inst in ("lg1", "lg1_carry", "lg2", "sv"):
        kernels.append(entry(f"fused_propagate_{inst}", "triton", f"{pkg}/kernels/propagate.py",
                             propagate, k2i[inst]))
    for inst in ("lg1_raw", "lg2_raw", "sv_raw"):
        kernels.append(entry(f"fused_propagate_{inst}", "triton", f"{pkg}/kernels/propagate.py",
                             propagate, k2r[inst]))
    for inst in LG_DX_INSTANCES:
        kernels.append(entry(f"fused_propagate_{inst}", "triton", f"{pkg}/kernels/propagate.py",
                             propagate, k2dx[inst]))
    say("timing", seconds=phase_s, total=round(sum(phase_s.values()), 2))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [PARALLEL_WORKER]:
        sys.exit(parallel_worker(sys.argv[2:]))
    sys.exit(main())
