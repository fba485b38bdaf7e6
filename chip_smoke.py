#!/usr/bin/env python3
"""Drive the PyTorch port (pcgmix_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Card and build: print the card's name and power limit as nvidia-smi
   gives them; build the CUDA kernels K1–K5 from csrc/ (one nvcc per
   source, started together, one library) and time the build.
2. Kernels against their plain PyTorch versions on the card, at the main
   path's shape (B=64, C=4, T=2500, K=4, fp32, plans from the port's own
   AugmentEngine; K3/K4 get d2 = x[mix] gathered beforehand), in bf16, and
   on a K=27 geometry with zero-length and boundary pieces.  Tolerances:
   K1/K3 1e-6 abs (fp32); K2/K4 1e-5 abs (fp32; the 6-term envelope is
   summed in another order than the plain einsum); K1/K3 bf16 bit-equal to
   the plain version computed in fp32 and cast; K2/K4 bf16 within one bf16
   ulp of it.  K1 is called as the main path calls it,
   ``piecewise_mix_batch`` (no row index).  Each is timed with CUDA events
   (median of 60 launches, queued behind a device sleep so host overhead
   stays out), and so is a one-element ``zero_()``, the launch floor that
   this method reads (no kernel can be timed below it), and a device copy
   of the batch, which moves K1/K2's bytes.  K1–K4 are one kernel body
   with 16-byte vectors (``mix_warp_kernel``), K2/K4 with the envelope.
   K5 (k=3 conv + BatchNorm statistics: wgmma fed by TMA through an
   mbarrier ring, a producer warp and two consumer warpgroups, chunks of
   64 rows that never cross a sample, statistics from the fp32
   accumulator) against its plain version on the card (fp32 matmuls, TF32
   off) at a small odd shape (channels zero-padded to multiples of 8 for
   TMA) and at the full-width ResNet9 layers res2a 64×312×512→512 and
   conv3 64×1250×128→256: y within one bf16 ulp plus the fp32
   accumulation term of ``bench/conv_bn_fused.py::compare``, s1 within
   1e-5·Σ|acc| per column, s2 within 1e-5 relative, y without stats
   bit-equal to y with them.  Then K5's path, the bench harness: every
   arm at both shapes (cuDNN yardsticks, K5 without and with stats, the
   plain version), with the harness's decision rule; K5's launches are
   counted over this run.  The kernels line pairs K5 without stats with
   cuDNN's conv (the function one PyTorch call computes), and K5 with
   stats with cuDNN's conv plus its statistics pass.
   K1 and K3 also run at the spectrogram path's geometry: a batch of 64
   mel spectrograms, 1 × 128 × 128, whose (64, 128, 128) view K1 blends
   with 128 frequency rows as channels (plans from a spectrogram engine,
   ``durratiomixup``), against their plain versions at the same
   tolerances.  And at the concat family's: K1 with an explicit row index
   ``idx1`` and a zero base, on the main path's batch in fp32 and bf16,
   with the engine's ``cutmix`` (K = 2), ``cont-cutmix`` (K = 3) and
   ``swapsysdia`` (K = 4) plans; K3 with a zero base on rows gathered by
   ``idx1``/``idx2`` (``cutmix``); and K1 on a full-width ResNet9 latent
   (depth 2, 64 × 512 × 312) with a ``manifold-cutmix`` plan reckoned for
   T = 2500, whose pieces run past the latent's end (the source index
   clamps).  And at the model-in-the-loop joins': K1 with ``idx1`` and a
   zero base on ``lc-nointrusion``'s candidate pool, 4B = 256 output rows
   gathered from the 64-row batch (the engine's plan), and on
   ``saliency-cutmix``'s 14-piece splice, its bins those of a random
   saliency map through the port's ``bin_training_saliency``.  Each
   bit-equal to its plain version in bf16 and within 1e-6 in fp32; their
   byte bounds count the source steps the pieces read (no base row is
   read) and the whole output.  And at the live gang's pool: K1 with a zero
   base on four members' ``lc-nointrusion`` pools, 1024 × 4 × 2500 joined
   from the 256-row gang batch (``gang_plan``: idx1/idx2 offset by s·B).
   And at the latent plots' batch: K2 on 2048 × 4 × 2500 (phase 3j's
   PCGmix+ batch).
3. The slice end to end: ``train_model`` with full-width ResNet9 and with
   full-width Potes, batch 64, 4 × 2500 inputs, 16 steps, once with
   PCGmix+ ``durmixmagwarp(0.2,4)`` and once with PCGmix ``durratiomixup``;
   each run must launch its kernel (K2, K1) once per augmented step.  Small
   ResNet9 and ``Potes(noDropout)`` runs on the card are also held against
   the same runs on the CPU (plain versions; Potes' dropout masks come from
   a CPU generator on both): equal loss traces.  The host time of a Potes
   step's plan and dropout masks is printed.  Profiled PCGmix+ runs of
   ResNet9 and Potes print device time by kernel and the device's busy
   share.
3b. The paper's two other paths: latentmixup (ManifoldMixup, the split
   forward at a depth drawn per step) on full-width ResNet9 and Potes, 16
   steps each, no kernel launched; and full-width ResNet9-2D on a
   ``synthetic_spectrogram_dict`` corpus of 1 × 128 × 128 spectrograms
   (264 train rows: 4 steps an epoch, 16 steps), batch 64, with PCGmix and
   ``durmixtimemask(0.1)``, each launching K1 once per step.  Steps/s and
   finite losses, as phase 3; a profiled 2-D PCGmix call beside phase 3's.
3c. The rest of the augmentation engine and UMC: full-width ResNet9,
   batch 64, 4 × 2500, 16 steps each with ``cutmix``, ``durratiocutmix``
   (the keep-duration cut), ``(smooth)labelcutmix``, ``swapsysdia``,
   ``cont-cutmix`` and ``manifold-cutmix`` (the split step; K1 on the
   latent), each launching K1 once per step and nothing else; then UMC
   (``synthetic_umc_dict``, 4 × 2000, train fold 1 of the ten: 264 rows)
   with ``(UMC-subset)durratiocutmix`` and PCGmix, and the multi-cycle
   variant (``synthetic_physionet_full_dict``, 4 × 2500, frames padded to
   28, 27 pieces a row) with PCGmix (K1) and PCGmix+ (K2).  Steps/s and
   finite losses, as phase 3.
3d. The model zoo: each of its 17 distinct architectures (FCN,
   FCN(custom), ResCNN, ResNet, Singstad d3/d6/d10, InceptionTime,
   XceptionTime, XResNet1d18, gMLP, XCM, RNN, LSTM, GRU, mWDN,
   OmniScaleCNN) at its published width, batch 64, 4 × 2500, fp32, 8
   steps with PCGmix+ (K2 once per step); FCN, ResCNN and Singstad_d10
   also with PCGmix and ``manifold-cutmix`` (K1 once per step) and
   ``latentmixup`` (no kernel).  Each run prints steps/s, peak memory and
   its losses, each architecture its parameter count beside the JAX
   package's (``JAX_PARAM_COUNTS``; they must be equal); each alias builds
   and runs one forward; the
   phase's wall time is printed.  Profiled PCGmix+ calls of Singstad_d10
   and OmniScaleCNN stand beside phase 3's.  K1 also runs at FCN's depth-2
   latent (64 × 256 × 2500) in phases 2 and 5, under an FCN
   ``manifold-cutmix`` plan.
3e. The model in the loop.  The native displacement scan (g++, one
   library) against its NumPy plain version on 200 random windows; the
   saliency maps of frozen full-width ResNet9 weights (pretrained maps and
   the live training map) on the card against the CPU's, with float64
   gradients, within ``SALIENCY_BAR``, and in float32 beside the CPU's own
   float32 spread.  The runner CLI in a subprocess, as phase 4b (in the
   background during phase 3g's frozen gangs), on the same corpus under
   the robust schedules (full-width ResNet9: 50
   epochs of one step each), with ``(saloptenv)durratiomixup``,
   ``(saloptsum-2)durmixmagwarp(0.2,4)``,
   ``(closestknn=8)durmixmagwarp(0.2,4)`` and
   ``(closestbins=4)durratiomixup``: it first trains their dependencies,
   ``base``, the robust ``durmixmagwarp(0.2,4)+1.0`` and the canonical
   ResCNN embedder (10 epochs at batch 32, n_fraction 1.0, seed_data 3:
   its run dir's name, not cut); each run must launch its kernel (K1 or
   K2) once per step and no other, and print steps/s, finite losses and
   the host ms per step of its saliency pass, displacement search, latent
   embedding and TSP pairing; a rerun must train nothing.  And
   ``lc-nointrusion`` (the candidate forward of 256 rows and
   ``lc_select``) and ``saliency-cutmix`` (the live model's saliency bins)
   through ``train_model``, 16 steps each, K1 once per step.
3f. The runtime extras, full-width ResNet9 and Potes, batch 64, 4 × 2500,
   fp32, on a corpus of 9 steps an epoch (two full chunks of 4 and a
   partial one).  ``steps_per_dispatch=4``, a captured CUDA graph of 4
   steps, against one step per dispatch with PCGmix+ and PCGmix on both
   models and ``durmixmagwarp(0.2,4)+0.5`` (identity plans) on ResNet9:
   with the weights frozen every plot epoch's loss within 1e-5, K1/K2
   once per step (replays counted, the warm-up's launches printed apart;
   the gated method's eager route only on its augmented steps);
   ``lr_per_step`` equal.  Training at lr 0.01 under cuDNN's
   deterministic algorithms, ResNet9 and Potes with Adam and ResNet9 with
   ``op="SGD"`` (``StepLosses`` records every step's loss): step 0 within
   1e-5, step 1 within 1e-3 relative, and every one of the 27 steps
   (replays, partial chunks) within the float32-scalar bar: the largest
   relative gap the eager route itself shows when ``lr_max`` moves by
   one float32 ulp, which moves each scheduled scalar by about its
   float32 rounding, and at most 1e-6 (both routes feed the update the
   same float32 scalars).  SGD's OneCycle momentum cycles 0.95 → 0.85 → 0.95.
   Steps/s of both routes with PCGmix+, each over the epochs after the
   first of a 12-epoch Potes run (99 steps), the routes alternated
   eager, graph, graph, eager (ResNet9's routes are timed in phase 3h).  The
   host ms per step of the eager route's uploads against the chunk's
   staging, each call timed after the card's queue is drained.  Exact
   resume (``resnet9-5k``, 5 steps an epoch, ``checkpoint_every=1``,
   PCGmix+ and ``magnitudewarp(0.2,4)`` one step per dispatch and PCGmix+
   as a graph of 4, cuDNN deterministic): a run crashed after
   its first checkpoint and rerun equals the uninterrupted run within its
   own repeat spread plus 1e-6, and a rerun of the finished config
   launches nothing; checkpoint save and restore ms and
   ``replay_plan_rng``'s.  Serving: the trained full-width ResNet9 and
   Potes exported on the card, ``python -m pcgmix_tpu_torch.serve`` in
   a subprocess with ``--artifact`` and with ``--checkpoint`` on the test
   split: probabilities within 1e-5, the recording predictions equal;
   rows/s of each at batch 256.  Two calls on one corpus: the second
   hits the device cache and its losses equal an uncached call's; the
   ``profile_dir`` trace names the K2 kernel; ``variability.pkl`` is
   written.  Inside phase 4's group the data-parallel route runs the same
   graph check with K3/K4 (the collectives captured in the graph), and
   the same alternated steps/s of both routes; a refused capture is
   printed, not failed.  A profiled graph call stands beside phase 3's
   eager one.
3g. Gang training (``train/gang.py``): gangs of 4 members (seed_data
   1100001…, seed 1…) of full-width ResNet9 and Potes, batch 64, 4 × 2500,
   with ``base``, PCGmix and PCGmix+, 2 epochs of 4 steps, weights frozen:
   each member's train and test losses within 1e-6 relative of its own
   sequential ``train_model`` run, K1/K2 once a gang step (one launch on
   the 256 rows), no other kernel.  At lr 0.01 under cuDNN's
   deterministic algorithms, one step an epoch, 7 steps: each member's
   relative gap printed step by step, step 0 within 1e-5.  The graph gang
   (``steps_per_dispatch=4``) against the eager one, the same launches.  A
   ragged gang of three UMC folds (their own train sizes and test
   patients), frozen, against the folds' runs, K1 once a lockstep step.
   The runner with ``--gang --no-gang-fallback`` in a subprocess, two
   gangs of 4 and their ``gang of 4`` lines, then its rerun, which skips
   all 8.  The runner's calls (these, the salopt grid's below, phase 3e's
   and the grids of phases 4b and 4c) run in the background, four at a
   time, beside the frozen gangs; every rate below is taken after they
   end.  Member-steps/s of gangs of S = 1, 2, 4, 8 against sequential
   runs (PCGmix+ on ``rate_corpus()``, 9 steps an epoch, at least
   ``GANG_RATE_MEMBER_STEPS`` timed after the first epoch), alternated sequential, 1, 2, 4, 8, 8, 4, 2, 1,
   sequential; peak memory per member beside ``estimate_gang_max_size``'s
   per-member bytes and S_max.  Phase 2 checks K1/K2 at the gang's
   geometry, 256 × 4 × 2500 under four members' concatenated plans, and
   the kernels line carries it as ``gang`` with the gang runs' launches;
   two profiled gang calls (ResNet9, Potes) give the busy share.  The
   model in the loop in a gang (``mil_gang_phase``), frozen, under cuDNN's
   deterministic algorithms: gangs of 4 of ``lc-nointrusion`` and
   ``saliency-cutmix`` (the live mode) on ResNet9 and Potes, and of
   ``(saloptenv)durratiomixup`` (one provider a member) and
   ``(closestknn=8)durmixmagwarp(0.2,4)`` on ResNet9, their base run and
   canonical embedder trained in the phase under the same algorithms
   (``frozen_hook_models``), 8 gang steps each: every member within
   ``GANG_BAR`` of its own sequential run, every plan and ``lc_select``
   pick bit-equal, K1 (K2 for the closest PCGmix+) once a gang step and
   nothing else (the pool's one launch on 1024 rows; the picks are
   gathered from it).  The runner with ``--gang --no-gang-fallback`` on a
   ``(saloptenv)durratiomixup`` grid of 4 seed_datas: its ``gang of 4
   (dependency): base`` line and then the hook gang's, and a rerun that
   skips all 4.  Member-steps/s of the ``lc-nointrusion`` gang of 4
   against its sequential runs on Potes and ResNet9, alternated
   sequential, gang, gang, sequential (``LIVE_RATE_MEMBER_STEPS`` timed
   after the first epoch), with the host ms a step of the candidate
   forward and ``lc_select`` (``timing.py``).  The kernels line carries
   the pool as ``gang-pool`` and the other gangs' launches under
   ``gang_model_in_the_loop``.
3h. The bf16 compute mode (``TrainConfig.compute_dtype="bfloat16"``):
   full-width ResNet9, batch 64, 4 × 2500, PCGmix+ and PCGmix in bf16,
   16 steps each (K2/K1 once a step, no other kernel, finite losses), and
   as a CUDA graph of 8 steps (the JAX package's production config) with
   the weights frozen: every plot epoch within 1e-5 of one step per
   dispatch, the launches equal.  ``manifold-cutmix`` in bf16: K1 once a
   step on the bf16 latent (phase 2 holds K1 on the bf16 depth-2 latent,
   64 × 512 × 312, bit-equal to its plain version, and phase 4 K3 on its
   rows).  ResNet9-2D (PCGmix) and Potes (PCGmix+, PCGmix) in bf16, 16
   steps; each dtype-honoring zoo architecture (InceptionTime,
   XceptionTime, XResNet1d18, gMLP, XCM, mWDN, OmniScaleCNN) with PCGmix+,
   8 steps.  A bf16 gang of 4 ResNet9 members with frozen weights against
   their four sequential bf16 runs (relative bar 2e-3: the vmapped
   convolutions round their bf16 outputs elsewhere).  A bf16
   ``torch.export`` artifact of ResNet9 answering a batch within 1e-5 of
   the live model, and the card's bf16 forward of one set of weights
   against the CPU's, within the CPU tests' 3e-2 of the largest logit.
   Steps/s of ResNet9 with PCGmix+, fp32 against bf16, eager and the graph
   of 8, each over 108 steps after the first epoch, alternated fp32, bf16
   (eager, then graph) and back; a bf16 gang's member-steps/s at S = 1
   and 4 against sequential bf16 runs, alternated, with each member's peak
   memory beside ``estimate_gang_max_size``.  A profiled bf16 call stands
   beside phase 3's fp32 one.
3i. The offline builder and ``classical_space``.  Two generated trees in
   the reference layout, written here with scipy: PhysioNet-2016 (subsets
   a–f, 8 recordings each of 10–60 s at 2 kHz, both classes, hand- and
   Springer-annotated, one noise run; band wavs band-passed and
   RMS-normalized) and UMC (16 recordings of 10–30 s at 4 kHz, patient ids
   from the hardcoded folds, noisy and excluded ones among them): a cut of
   the real corpora's scale (about 3,150 PhysioNet recordings of 5–120 s,
   not in the repository).  All six ``--corpus`` builds run through
   ``python -m pcgmix_tpu_torch.data.builder`` on the card, then again with
   ``--device cpu`` (each wave's six together): labels, frames, wavs and
   ``sig_qual`` equal, the 1-D and "full" bands bit-equal, the spectrograms
   within the CPU tests' 1e-2 dB over the builds' smallest std (13.9);
   each build's wall time and its mel part's on the card against the CPU.
   Then ``classical_space`` at full width: ResNet9, batch 64, phase 3's
   corpus as 4 + 1 × 2500, PCGmix+ for 8 steps (K2 16 launches: the step
   and the dump's apply) and PCGmix for 8 (K1 16), one CSV of 64 rows a
   step; the PCGmix+ run's first 4 steps against a CPU run of the same
   config: plans bit-equal, the augmented 5-channel rows within K2's 1e-5
   (CSVs then byte-equal where the rows are), headers and meta columns
   equal, the differing CSV values counted; its steps/s against phase 3's
   PCGmix+ rate and its host ms a step for the features.  The runner
   (in the background from here to the CLI's end) with ``--classical-space`` on the built ``physionet-1d`` .dat (PCGmix+,
   1 epoch at n_frac 0.25): K2 twice a step, a CSV a step; its rerun
   skips.  Phase 2 adds this path's geometry, K1 and K2 at 64 × 5 × 2500.
   The classical CLI (``python -m pcgmix_tpu_torch.classical``) on the
   built ``physionet-1d`` .dat writes features.csv, aggregated.csv and,
   from its own classifier bench on the card, results.csv; the bench
   (``run_experiment``: the mutual-information top 40, then LR, DT, RF,
   KN, GNB, SVC, SGD and GB) runs again in this process on that
   aggregated.csv on the card and on the CPU: the selected features
   identical, each classifier's probabilities within ``BENCH_BARS``
   (1e-9; 1e-4 for LR, SGD and SVC), every metric's largest difference and
   each stage's ms printed.  Its crash story (a refused checkpoint, two
   resumes, the three calls started together) must give back the fresh
   run's three files byte for byte.
3j. (Run beside phase 3i's three resume calls.)  The latent-space plots
   and the loss mixture: the last plot run's full-width ResNet9 (phase 3's
   config) embeds 2048 synthetic rows (``get_hidden_features``,
   ``part="latent_space"``: 39,936 features) and one PCGmix+ batch of
   them through the engine's apply (K2 once, nothing else); on 256 rows of
   each cloud the card's ``dim_reduc_pca`` within 1e-10 of the CPU's and
   its ``dim_reduc_tsne`` within 0.01 trustworthiness (5 neighbours) and
   2 % KL divergence (under one P) of the CPU's; at full size
   ``plot_latent_space`` with PCA and with t-SNE,
   ``plot_latent_space_test`` and ``plot_latent_space_test_train`` (t-SNE,
   256 test rows): each PNG 600 x 600; the wall time of each reduction
   at full size, called on its own, and of each plot call printed;
   ``plot_epoch_loss_gmm`` on the model's per-sample cross-entropy over
   the 2048 rows (its JPEG 600 x 600) and on 1536 + 512 losses of two
   known modes: |μ₁−μ₂| that of the mixture fitted to the same losses,
   whose weights, mean and second moment are the data's within 1e-9, and
   on the two modes its means and weights within 0.01 of theirs.  The
   resume calls' wall is theirs alone, 3j's printed beside it.
4. The data-parallel route: the same two runs inside a 1-rank NCCL process
   group, as ``torchrun`` would start them.  Each must launch K4 (PCGmix+)
   or K3 (PCGmix) once per augmented step and K1/K2 never.  Its loss must
   equal the single-device route's with the weights frozen (every plot
   epoch within 1e-5) and over the first steps at lr 0.01 (step 0 within
   1e-5, step 1 within 1e-3 relative); later steps are chaotic at full
   width, and the script prints how far the single-device route drifts from
   itself there.  Phase 3's profiled PCGmix+ call is repeated on this
   route.  The 2-D PCGmix run of phase 3b runs here too and must launch K3
   once per step.  So do ``cutmix`` (K3 with a zero base on the rows
   ``idx1`` and ``idx2`` name) and ``durratiocutmix`` (K3, base d1): K3
   once per step, K1 never, and with the weights frozen every plot epoch's
   loss within 1e-5 of the single-device route's; and so does ResCNN
   with PCGmix, a zoo model whose BatchNorm takes the global statistics.
   Then every other method on this route (``DP_METHODS``), 12 steps each
   with the weights frozen, each against the same run on the
   single-device route under cuDNN's deterministic algorithms: ``mixup``,
   ``timemask``, ``magnitudewarp``, ``gaussiannoise``, 2-D ``mixup`` and
   ``freqmask``, ``latentmixup``, ``manifold-cutout``, ``manifold-cutmix``
   in fp32 and in bf16, ``(saloptenv)durratiomixup`` on phase 3e's
   pretrained base run, ``(closestknn=8)durmixmagwarp(0.2,4)`` on its
   canonical embedder, ``lc-nointrusion`` and ``saliency-cutmix`` on
   Potes: every plot epoch's loss within 1e-5 (bf16: 2e-3 relative, the
   global BatchNorm's sums under bf16 casts), the plans (and
   ``lc_select``'s picks) bit-equal, K3 once a step on the kernel methods
   (twice on ``lc-nointrusion``: its block of the pool, then of the
   picked rows), K4 on the closest PCGmix+ blend, nothing on the others;
   each method's data-parallel steps/s beside the single-device route's.
4b. (Run in the background during phase 3g, as are 4c's grids.)  The
   experiment grid: a ``synthetic_effect_dict`` corpus (240 train
   recordings × 4 cycles, 40 test recordings, 4 × 2500, seed 7) with a
   ``cvds_map.csv`` for its recordings goes through
   ``python -m pcgmix_tpu_torch.exp.runner`` in a subprocess on the card:
   full-width ResNet9, batch 64, n_fraction 0.1 (96 rows: one step an
   epoch), one seed_data, no '+cp' schedules, 3 epochs (cut from 50; the
   width is not cut), 15 methods: base, PCGmix and PCGmix+, the 1-D
   baselines (mixup, the warps, respiratory scale, time mask, Gaussian
   noise), the four pairings, and the CutMix baselines ``cutmix`` and
   ``durratiocutmix``.  Every run dir must hold
   ``performance.pkl`` and ``model.pth`` with finite losses; every K1 or
   K2 method must launch its kernel once per step and no other (the
   runner's ``done:`` lines report each run's launches), the others none;
   a second identical invocation must train nothing and print
   ``skip (done):`` for each run.  The port's ``exp/results.py`` then
   assembles the grid's table, printed with each run's wall time.
4c. The 2-D table's grid: the same runner call and rerun on a
   ``synthetic_spectrogram_dict`` .dat (240 train recordings × 4 cycles,
   1 × 128 × 128) with ``--dataset "PhysioNet(spec128)"``: full-width
   ResNet9-2D, the paper's seven 2-D methods (Vanilla, FreqMask, TimeMask,
   Cutout, Mixup, ManifoldMixup, PCGmix, named as the robust schedules name
   them) and 2-D ``cutmix`` and ``durratiocutmix``, 3 epochs; PCGmix and
   the two cuts must launch K1 once per step, the other six nothing.
   Then a UMC grid through the runner: ``--dataset UMC --seed-datas 1`` on
   a ``synthetic_umc_dict`` .dat (4 × 2000, 66 train rows of fold 1: one
   step an epoch), ``base`` and ``(UMC-subset)durratiocutmix``, 3 epochs,
   and its rerun, which must train nothing.
5. The profiler's kernel time of K1–K4 over 60 calls of phase 2's
   closures, which has no launch floor (K1 and K3 at the spectrogram,
   concat, latent and model-in-the-loop geometries too), and each kernel's
   share of its bound against it and against the bursts (last, since a profiler
   session leaves host overhead behind it).  Only ``mix_warp_kernel``'s
   events are summed, and only when the trace holds 60 of them (one a
   call): any other count prints "not measured (n of 60 events)" and puts
   null in the kernels line.  Summary: a
   ``{"kernels": [...]}`` line, then the result line
   ``{"ok": true, "device": {...}}`` last.

It needs no network and one card, and exits non-zero without CUDA or
without the package beside it.  An ``elapsed`` line closes each stage
with the script's clock (its limit is 1,200 s); a failed phase kills
every subprocess still running.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

T_START = time.time()
_CHILDREN: set = set()  # the subprocesses started and not yet waited for


def stamp(what):
    """A phase's end on the script's clock."""
    print(f"elapsed {time.time() - T_START:.1f} s: {what}")


def _start(cmd, **kw):
    """``subprocess.Popen(cmd)``, killed at exit if still running."""
    proc = subprocess.Popen(cmd, **kw)
    _CHILDREN.add(proc)
    return proc


def _wait(proc, timeout):
    """``proc.communicate(timeout=...)``; the process is killed at the timeout."""
    try:
        return proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    finally:
        _CHILDREN.discard(proc)


class _ThreadOut:
    """``sys.stdout`` that holds what a background job prints until it is
    joined; the main thread's lines go straight through."""

    def __init__(self, real):
        self.real, self.held = real, {}

    def write(self, s):
        held = self.held.get(threading.get_ident())
        if held is None:
            return self.real.write(s)
        held.append(s)
        return len(s)

    def flush(self):
        self.real.flush()

    def __getattr__(self, name):
        return getattr(self.real, name)


class Background:
    """``fn(*args, **kw)`` in a thread, started now (once one of ``slots``,
    a semaphore, is free).  Only for work that runs in subprocesses and
    reads their files: ``join()`` prints what the job printed, re-raises
    what it raised and returns its result."""

    def __init__(self, fn, *args, slots=None, **kw):
        if not isinstance(sys.stdout, _ThreadOut):
            sys.stdout = _ThreadOut(sys.stdout)
        out, self.lines, self.result, self.error = sys.stdout, [], None, None

        def run():
            out.held[threading.get_ident()] = self.lines
            try:
                with slots or contextlib.nullcontext():
                    self.result = fn(*args, **kw)
            except BaseException as e:  # re-raised by join
                self.error = e

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def join(self):
        self.thread.join()
        sys.stdout.real.write("".join(self.lines))
        sys.stdout.flush()
        self.lines.clear()
        if self.error is not None:
            raise self.error
        return self.result

B, C, T = 64, 4, 2500
MAIN_STEPS = 16
# phase 3e: the most the saliency maps of one set of weights may differ
# between the card and the CPU, gradients in float64 (the maps are smoothed
# and scaled in float32).  In float32 the input gradient of full-width
# ResNet9 at this batch is conditioned at a few 1e-4 of the map (the CPU's
# own float32 maps against its float64 ones); that spread is printed.
SALIENCY_BAR = 1e-6

# Trainable parameters of each registry model at 4 × 2500 in the JAX
# package (``jax.eval_shape`` of its init; the card has no JAX, so they are
# kept here, and tests/test_torch_zoo_ref.py holds them to the package)
JAX_PARAM_COUNTS = {
    "resnet9": 2274626, "resnet9-5k": 4868, "resnet9-15k": 14006, "resnet9-50k": 45098,
    "resnet9-150k": 158546, "resnet9-600k": 590498, "resnet9-1.4m": 1368578,
    "resnet9-2.3m": 2274626, "resnet9-5m": 5052386, "resnet9-9m": 8923778,
    "Potes": 199634, "Potes(noDropout)": 199634, "PotesBig128and64": 3231614,
    "PotesBig64and32": 1605598, "Potes0.1": 49925, "Potes0.02": 49914, "FCN": 267010,
    "FCN(custom)": 67970, "ResCNN": 257859, "ResNet": 480002, "Singstad_d3": 153346,
    "Singstad_d6": 169986, "Singstad_d10": 169986, "ResNetPlus": 480002,
    "XResNet1d18": 3854210, "XResNet1d18Plus": 3854210, "InceptionTime": 455682,
    "InceptionTimePlus": 455682, "XceptionTime": 399700, "XceptionTimePlus": 399700,
    "gMLP": 38707194, "XCM": 3201668, "XCMPlus": 3201668, "FCNPlus": 267010, "RNN": 10702,
    "LSTM": 42202, "GRU": 31802, "mWDN": 16870682, "OmniScaleCNN": 238633,
}

# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet):
# device memory bytes/s, and float32 FLOP/s outside the tensor cores (the
# mix kernels do fp32 FMAs only).  The bounds below are stated against them.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def device_time_ms(torch, fn, n=60, per_burst=10, sleep_cycles=20_000_000):
    """Median device time of ``fn`` over ``n`` launches.  Each burst is queued
    behind a device sleep, so the events bracket back-to-back device work and
    not the host's launch overhead."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n // per_burst):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(per_burst + 1)]
        torch.cuda._sleep(sleep_cycles)
        events[0].record()
        for i in range(per_burst):
            fn()
            events[i + 1].record()
        torch.cuda.synchronize()
        times += [events[i].elapsed_time(events[i + 1]) for i in range(per_burst)]
    return float(sorted(times)[len(times) // 2])


def profile_breakdown(torch, run, card, top=10, label="profile"):
    """Print device time by kernel over ``run`` (torch.profiler) and the
    device's busy share of the wall time, each line led by ``label``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_us = (time.time() - t0) * 1e6
    # kernel and copy events only: a CPU op's self device time repeats its
    # kernels', and a user annotation on the device's timeline (the
    # optimizer's step) spans kernels that are listed themselves
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    busy = sum(t for _, t, _ in kernels)
    if not busy:
        print(f"{label}: device time not measured (the trace holds no kernels)")
        return
    print(f"{label}: device busy {busy:.1f} us of {wall_us:.1f} us wall "
          f"({100 * busy / wall_us:.1f}%) on {card}")
    for name, t, n in sorted(kernels, key=lambda k: -k[1])[:top]:
        print(f"{label}: {100 * t / busy:6.2f}% {t:12.1f} us {n:5d}x {name[:100]}")
    for name, t, n in kernels:
        if "mix_warp_kernel" in name:
            print(f"{label}: {100 * t / busy:6.3f}% {t:12.1f} us {n:5d}x {name[:100]}")


GRID_METHODS = (
    "base", "durratiomixup", "durmixmagwarp(0.2,4)", "mixup(same)",
    "magnitudewarp(0.2,4)", "timewarp(0.05,4)", "respiratoryscale(12,20)",
    "timemask(0.2)", "gaussiannoise(25,40)", "(sameCVD)durratiomixup",
    "(samePCG)durmixmagwarp(0.2,4)", "(sameDataset)durmixmagwarp(0.2,4)",
    "(mixAll)durmixmagwarp(0.2,4)", "cutmix", "durratiocutmix",
)
# the 2-D table's columns (BASELINE.md): Vanilla, FreqMask, TimeMask,
# Cutout, Mixup, ManifoldMixup, PCGmix, named as exp/robust.py names them;
# and the 2-D CutMix baselines
SPEC = "PhysioNet(spec128)"
# phase 3h: the bf16 compute mode (TrainConfig.compute_dtype="bfloat16")
BF16 = {"compute_dtype": "bfloat16"}
BF16_K = 8  # steps_per_dispatch of the JAX package's production config
# the CPU tests' bar (tests/test_torch_bf16*.py): bf16 logits within 3e-2
# of their largest magnitude
BF16_LOGIT_BAR = 3e-2
# a full-width bf16 gang member against its own run, frozen weights: the
# vmapped (grouped) convolutions round their bf16 outputs where the dense
# ones do not (measured 5.3e-4 on an NVIDIA H100 80GB HBM3, 700 W)
BF16_GANG_BAR = 2e-3
BF16_RATE_STEPS = 100  # timed steps of each steps/s run, after the first epoch


def bf16_phase(np, torch, card, mk, drive, ds, spec_ds):
    """Phase 3h: the bf16 compute mode.  Full-width ResNet9 with PCGmix+ and
    PCGmix in bf16, eager (K2/K1 once a step) and as a CUDA graph of 8
    steps (frozen weights: equal to eager); manifold-cutmix (K1 on the bf16
    latent); ResNet9-2D, Potes and each dtype-honoring zoo architecture; a
    bf16 gang of 4 against its members' sequential runs (frozen); a bf16
    ``torch.export`` artifact; the bf16 forward on the card against the
    CPU's; steps/s of fp32 and bf16, eager and graph, alternated; a bf16
    gang's member-steps/s and peak memory per member beside the estimate.
    Returns the bf16 path's K1/K2 launches and a bf16 call to profile."""
    from pcgmix_tpu_torch import serve
    from pcgmix_tpu_torch.data import physionet_split, synthetic_physionet_dict
    from pcgmix_tpu_torch.models import build_model
    from pcgmix_tpu_torch.models.registry import COMPUTE_DTYPE_FAMILIES
    from pcgmix_tpu_torch.train import TrainConfig, gang, train_model
    from pcgmix_tpu_torch.train.convert import seeded_init

    t_phase = time.time()
    launches = {}
    for method, kernel in (("durmixmagwarp(0.2,4)", "pcgmix_plus_fused"),
                           ("durratiomixup", "piecewise_mix_pairs")):
        launches[kernel], _ = drive(method, kernel, "bf16", **BF16)
    # the graph of 8 steps against eager, frozen weights; 9 steps an epoch:
    # one chunk of 8 and a partial one
    rt_ds = synthetic_physionet_dict(num_wavs_train=80, num_wavs_test=12,
                                     segments_per_wav=8, sig_len=T, seed=12)
    run = lambda **kw: rt_train(torch, mk, TrainConfig, train_model, rt_ds, **kw)  # noqa: E731
    for method, kernel in (("durmixmagwarp(0.2,4)", "pcgmix_plus_fused"),
                           ("durratiomixup", "piecewise_mix_pairs")):
        e, g = (run(method=method, k=k, lr_max=0.0, **BF16) for k in (1, BF16_K))
        d = float(np.max(np.abs(np.subtract(g.perf["train_loss"], e.perf["train_loss"]))))
        n_steps = g.perf["steps"][-1]
        print(f"bf16 graph resnet9 {method}: K={BF16_K}, frozen weights, {n_steps} steps, "
              f"plot-epoch max |diff| to one step per dispatch {d:.3e}; {kernel} launches "
              f"{g.launches[kernel]} (graph, replays counted) / {e.launches[kernel]} "
              f"(eager), losses {np.round(g.perf['train_loss'], 5).tolist()} on {card}")
        others = {k: n for k, n in {**g.launches, **e.launches}.items() if k != kernel and n}
        if not (d < 1e-5 and g.launches[kernel] == e.launches[kernel] == n_steps
                and not others and np.isfinite(g.perf["train_loss"]).all()):
            raise AssertionError(f"bf16 graph {method}: differs from one step per dispatch")
        launches["graph", kernel] = g.launches[kernel]
    # K1 on the bf16 latent (phase 2 holds it bit-equal to its plain version)
    launches["bf16-latent"], _ = drive("manifold-cutmix", "piecewise_mix_pairs", "bf16",
                                       **BF16)
    drive("durratiomixup", "piecewise_mix_pairs", "bf16 spec2d", data=spec_ds, dataset=SPEC,
          **BF16)
    for method, kernel in (("durmixmagwarp(0.2,4)", "pcgmix_plus_fused"),
                           ("durratiomixup", "piecewise_mix_pairs")):
        drive(method, kernel, "bf16", model="Potes", **BF16)
    # the zoo's families that honor the dtype; the others run float32
    for name in COMPUTE_DTYPE_FAMILIES:
        drive("durmixmagwarp(0.2,4)", "pcgmix_plus_fused", f"bf16 zoo {name}", model=name,
              epochs=ZOO_EPOCHS, **BF16)

    # a bf16 gang of 4 against its members' sequential bf16 runs, frozen
    cfgs = gang_members(TrainConfig, "resnet9", "durmixmagwarp(0.2,4)", GANG_S, 2,
                        lr_max=0.0, **BF16)
    mk.reset_launch_counts()
    perfs = gang.train_gang(cfgs, ds)
    counts = {k: n for k, n in mk.launch_counts().items() if n}
    gap = gang_gap(np, perfs, cfgs, ds, train_model)
    steps = perfs[0]["steps"][-1]
    print(f"bf16 gang frozen resnet9 durmixmagwarp(0.2,4): S={GANG_S}, {steps} gang steps, "
          f"launches {counts}; members against their sequential runs: max relative gap "
          f"{gap:.3e} (bar {BF16_GANG_BAR:g}) on {card}")
    if counts != {"pcgmix_plus_fused": steps} or not gap <= BF16_GANG_BAR:
        raise AssertionError("the bf16 gang differs from its members' runs")

    # one set of weights: a bf16 torch.export artifact, and the card's bf16
    # forward against the CPU's (plain kernels, oneDNN)
    model = seeded_init(build_model("resnet9", 2, C, T, **BF16), 4)
    cpu_state = {k: v.clone() for k, v in model.state_dict().items()}
    rows = physionet_split(ds, "test").data[:B]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bf16_") as tmp:
        live = serve.Classifier(model, batch_size=B)
        art = os.path.join(tmp, "resnet9_bf16.pcgt")
        live.export_artifact(art, (C, T), model_name="resnet9")
        d_art = float(np.abs(serve.ExportedClassifier(art).predict_proba(rows)
                             - live.predict_proba(rows)).max())
    print(f"bf16 serve resnet9: artifact against live max |diff| {d_art:.3e} over "
          f"{len(rows)} rows on {card}")
    if not d_art <= 1e-5:
        raise AssertionError("the bf16 artifact and the live bf16 model disagree")
    cpu = build_model("resnet9", 2, C, T, **BF16)
    card_model = build_model("resnet9", 2, C, T, **BF16).to("cuda")
    cpu.load_state_dict(cpu_state)
    card_model.load_state_dict(cpu_state)
    x16 = torch.from_numpy(rows[:16])
    with torch.no_grad():
        ref = cpu.train()(x16)
        got = card_model.train()(x16.to("cuda")).cpu()
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    print(f"bf16 forward resnet9 (train mode, 16 rows): card against CPU {rel:.3e} of the "
          f"largest |logit| (bar {BF16_LOGIT_BAR:g}); logits {got.dtype} / {ref.dtype} "
          f"on {card}")
    if not (rel < BF16_LOGIT_BAR and got.dtype == ref.dtype == torch.float32):
        raise AssertionError("the bf16 forward on the card disagrees with the CPU's")

    # steps/s: fp32 and bf16, eager and the graph of 8, alternated, each over
    # BF16_RATE_STEPS steps or more after its first epoch
    rate_ds = rate_corpus()
    spe = len(physionet_split(rate_ds, "train")) // B
    epochs = 1 + -(-BF16_RATE_STEPS // spe)
    routes = [("fp32", 1), ("bf16", 1), ("fp32", BF16_K), ("bf16", BF16_K)]
    rates: dict = {}
    for dtype, k in routes + routes[::-1]:
        r = rt_train(torch, mk, TrainConfig, train_model, rate_ds, epochs=epochs, k=k,
                     compute_dtype="bfloat16" if dtype == "bf16" else "float32")
        rates.setdefault((dtype, k), []).append(steady_rate(r.perf))
    for k in (1, BF16_K):
        f32, b16 = rates["fp32", k], rates["bf16", k]
        route = "eager" if k == 1 else f"graph K={k}"
        print(f"steps/s resnet9 durmixmagwarp(0.2,4) {route}: fp32 {f32[0]:.3f}, {f32[1]:.3f}; "
              f"bf16 {b16[0]:.3f}, {b16[1]:.3f}; bf16 against fp32 {sum(b16) / sum(f32):.3f}x, "
              f"over {(epochs - 1) * spe} steps each (alternated fp32, bf16 eager, then graph, "
              f"and back) on {card}")

    # a bf16 gang of 4 against sequential bf16 runs, member-steps/s, and each
    # member's peak memory beside the estimate
    g_rates: dict = {}
    peaks: dict = {}
    for s in ("seq", 1, GANG_S, GANG_S, 1, "seq"):
        n = 1 if s == "seq" else s
        g_epochs = 1 + max(1, -(-GANG_RATE_MEMBER_STEPS // (n * spe)))
        cfgs = gang_members(TrainConfig, "resnet9", "durmixmagwarp(0.2,4)", n, g_epochs,
                            **BF16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        perfs = ([train_model(cfgs[0], rate_ds)] if s == "seq"
                 else gang.train_gang(cfgs, rate_ds))
        torch.cuda.synchronize()
        g_rates.setdefault(s, []).append(n * steady_rate(perfs[0]))
        peaks[s] = torch.cuda.max_memory_allocated()
    seq = sum(g_rates["seq"]) / 2
    rows_n = len(physionet_split(rate_ds, "train"))
    cfg = gang_members(TrainConfig, "resnet9", "durmixmagwarp(0.2,4)", 1, 1, **BF16)[0]
    saved = gang.activation_bytes(build_model("resnet9", 2, C, T, **BF16), (B, C, T))
    s_max = gang.estimate_gang_max_size(cfg, rows_n, corpus_bytes=rows_n * C * T * 4,
                                        sample_shape=(C, T))
    marginal = (peaks[GANG_S] - peaks[1]) / (GANG_S - 1)
    for s in (1, GANG_S):
        r = g_rates[s]
        print(f"bf16 gang rate resnet9 durmixmagwarp(0.2,4) S={s}: {r[0]:.3f}, {r[1]:.3f} "
              f"member-steps/s (sequential bf16 {g_rates['seq'][0]:.3f}, "
              f"{g_rates['seq'][1]:.3f}); gang against sequential {sum(r) / 2 / seq:.3f}x; "
              f"peak memory {peaks[s] / s / 2**20:.1f} MiB a member ({peaks[s] / 2**30:.3f} "
              f"GiB) on {card}")
    print(f"bf16 gang estimate resnet9: autograd saves {saved / 2**20:.1f} MiB a member, "
          f"each member past the first adds {marginal / 2**20:.1f} MiB to the peak (S=1 to "
          f"{GANG_S}), {marginal / saved:.3f}x the saved bytes (reuse {gang.REUSE['bfloat16']} "
          f"assumed); S_max {s_max} on {card}")
    if not all(np.isfinite(v).all() for v in (*rates.values(), *g_rates.values())):
        raise AssertionError("bf16 rates: not finite")

    profiled = TrainConfig(model="resnet9", method="durmixmagwarp(0.2,4)", num_epochs=2,
                           batch_size=B, num_channels=C, save_artifacts=False, **BF16)
    print(f"bf16 phase: {time.time() - t_phase:.3f} s wall on {card}")
    return launches, (lambda: train_model(profiled, ds))


SPEC_SIZE = 128
GRID_METHODS_2D = ("base", "freqmask(0.1)", "timemask(0.1)", "cutout(0.25,0.25)",
                   "mixup(same)", "latentmixup", "durratiomixup", "cutmix", "durratiocutmix")
# UMC: the cycle length of its recordings, the methods of its grid
UMC_LEN = 2000
GRID_METHODS_UMC = ("base", "(UMC-subset)durratiocutmix")
# phase 3d: each distinct architecture of the zoo, those with a split
# forward, the registry's aliases, and the epochs (4 steps each) a run takes
ZOO = ("FCN", "FCN(custom)", "ResCNN", "ResNet", "Singstad_d3", "Singstad_d6",
       "Singstad_d10", "InceptionTime", "XceptionTime", "XResNet1d18", "gMLP", "XCM",
       "RNN", "LSTM", "GRU", "mWDN", "OmniScaleCNN")
ZOO_SPLIT = ("FCN", "ResCNN", "Singstad_d10")
ZOO_ALIASES = ("InceptionTimePlus", "XceptionTimePlus", "XResNet1d18Plus", "XCMPlus",
               "FCNPlus", "ResNetPlus")
ZOO_EPOCHS = 2
ZOO_PROFILED = ("Singstad_d10", "OmniScaleCNN")


def grid_kernel(method):
    """The kernel a grid method launches once per step (None: none)."""
    if "durmixmagwarp" in method:
        return "pcgmix_plus_fused"
    if any(b in method for b in ("durratiomixup", "cutmix")):
        return "piecewise_mix_pairs"  # PCGmix, the cuts, the concat joins
    return None


def parse_done(line):
    """(run dir, wall s, steps, launches, host ms per step, counts per step)
    of a runner ``done:`` line."""
    run_dir, rest = line[len("done: "):].split(" in ", 1)
    wall, rest = rest.split(" s, ", 1)
    steps, rest = rest.split(" steps, launches ", 1)
    launches, rest = rest.split(", host ms per step ", 1)
    host, counters = rest.split(", counts per step ", 1)
    return (run_dir, float(wall), int(steps), json.loads(launches), json.loads(host),
            json.loads(counters))


def grid_phase(np, card, device="cuda", model="resnet9", batch=B, sig_len=T,
               n_train=240, n_test=40, segments=4, epochs=3, dataset="PhysioNet",
               methods=GRID_METHODS, seed_data=1010001):
    """Phases 4b and 4c: the runner CLI over ``methods`` in a subprocess,
    twice, on a generated corpus (1-D, spectrograms of ``sig_len`` ×
    ``sig_len`` for a spectrogram ``dataset``, or a UMC dict of
    ``segments`` rows a patient); returns {method: (wall s, steps,
    launches)} of the first invocation."""
    from pcgmix_tpu_torch import utils
    from pcgmix_tpu_torch.data import (
        synthetic_effect_dict,
        synthetic_spectrogram_dict,
        synthetic_umc_dict,
    )
    from pcgmix_tpu_torch.exp.dirs import experiment_dir
    from pcgmix_tpu_torch.exp.results import results_table, to_string
    from pcgmix_tpu_torch.train import TrainConfig

    with tempfile.TemporaryDirectory(prefix="chip_smoke_grid_") as tmp:
        extra = []
        if dataset == SPEC:
            corpus = synthetic_spectrogram_dict(num_wavs_train=n_train, num_wavs_test=n_test,
                                                segments_per_wav=segments, size=sig_len,
                                                seed=7)
        elif dataset == "UMC":
            corpus = synthetic_umc_dict(segments_per_patient=segments, sig_len=sig_len,
                                        seed=7)
        else:
            corpus = synthetic_effect_dict(num_wavs_train=n_train, num_wavs_test=n_test,
                                           segments_per_wav=segments, sig_len=sig_len,
                                           seed=7)
            csv_path = os.path.join(tmp, "cvds_map.csv")
            names = sorted({w for split in corpus.values() for w in split["wav"]})
            with open(csv_path, "w") as f:  # normal recordings N, abnormal a valve disease
                f.write("wav,diagnosis\n" + "".join(
                    f"{w},{'N' if int(w[-4:]) % 2 == 0 else ('AS', 'MR', 'MVP')[int(w[-4:]) % 3]}\n"
                    for w in names))
            extra = ["--cvd-map-csv", csv_path]
        dat = os.path.join(tmp, "corpus.dat")
        utils.dict2file(corpus, dat)
        root = os.path.join(tmp, "experiments")
        cmd = ["--dataset-file", dat, "--device", device, "--model", model,
               "--batch-size", str(batch), "--n-fractions", "0.1", "--seed-datas",
               str(seed_data), "--no-robust", "--num-epochs", str(epochs), "--no-plot", *extra,
               "--dataset", dataset, "--experiments-root", root, "--methods", *methods]
        first, wall_first = runner_calls(cmd, 1, "the runner")[0]
        template = TrainConfig(dataset=dataset, model=model, num_epochs=epochs,
                               batch_size=batch, n_fraction=0.1, seed_data=seed_data,
                               experiments_root=root)
        runs, done = {}, [parse_done(ln) for ln in first if ln.startswith("done: ")]
        for method in methods:
            cfg = dataclasses.replace(template, method=method)
            run_dir = experiment_dir(cfg)
            line = [d for d in done if d[0] == run_dir]
            if len(line) != 1:
                raise AssertionError(f"grid {method}: no single done line")
            _, wall, steps, launches, _, _ = line[0]
            kernel = grid_kernel(method)
            on_card = device.startswith("cuda")  # the CPU runs the plain versions
            if launches != ({kernel: steps} if kernel and on_card else {}):
                raise AssertionError(f"grid {method}: {steps} steps but launches {launches}")
            if not all(os.path.exists(os.path.join(run_dir, f))
                       for f in ("performance.pkl", "model.pth")):
                raise AssertionError(f"grid {method}: run dir incomplete")
            perf = utils.load_dict(os.path.join(run_dir, "performance.pkl"))
            if not (np.isfinite(perf["train_loss"]).all() and np.isfinite(perf["test_loss"]).all()):
                raise AssertionError(f"grid {method}: non-finite loss")
            runs[method] = (wall, steps, launches)
        second, wall_second = runner_calls(cmd, 1, "the runner")[0]
        skips = [ln for ln in second if ln.startswith("skip (done): ")]
        if len(skips) != len(methods) or any(
                ln.startswith(("run: ", "done: ")) for ln in second):
            raise AssertionError(f"grid rerun trained: {second}")
        shape = f"1x{sig_len}x{sig_len}" if dataset == SPEC else f"{C}x{sig_len}"
        print(f"grid {dataset}: {len(methods)} runs of {model} batch {batch} x {shape}, "
              f"{epochs} epochs at n_frac 0.1: runner call {wall_first:.3f} s; the rerun "
              f"skipped all {len(skips)} in {wall_second:.3f} s, on {card}")
        for method, (wall, steps, launches) in runs.items():
            print(f"grid {dataset} {method}: {wall:.3f} s, {steps} steps, "
                  f"launches {launches}")
        if dataset != "UMC":  # the reader's seed grids are PhysioNet's
            print(to_string(results_table(template, methods, [0.1], robust=False)))
    return runs


# phase 3e: the model-in-the-loop methods that take a dependency run
MIL_METHODS = ("(saloptenv)durratiomixup", "(saloptsum-2)durmixmagwarp(0.2,4)",
               "(closestknn=8)durmixmagwarp(0.2,4)", "(closestbins=4)durratiomixup")


def dependency_phase(np, card, device="cuda", model="resnet9", batch=B, sig_len=T,
                     n_train=240, n_test=40, segments=4, seed_data=1010001,
                     methods=MIL_METHODS, keep=None):
    """Phase 3e's runner part: ``methods`` through the runner CLI in a
    subprocess under the robust schedules, twice; the first call must train
    each method's dependency before it, each run launching its kernel once
    per step, the second nothing.  The run dirs go under ``keep`` (a
    directory the caller removes) or a temporary one.  Returns {run dir:
    (steps/s, host ms per step)}."""
    from pcgmix_tpu_torch import utils
    from pcgmix_tpu_torch.data import synthetic_effect_dict

    with tempfile.TemporaryDirectory(prefix="chip_smoke_deps_") as tmp:
        corpus = synthetic_effect_dict(num_wavs_train=n_train, num_wavs_test=n_test,
                                       segments_per_wav=segments, sig_len=sig_len, seed=7)
        dat = os.path.join(tmp, "corpus.dat")
        utils.dict2file(corpus, dat)
        root = os.path.join(keep or tmp, "experiments")
        cmd = ["--dataset-file", dat, "--device", device, "--model", model,
               "--batch-size", str(batch), "--n-fractions", "0.1", "--seed-datas",
               str(seed_data), "--experiments-root", root, "--no-plot", "--methods", *methods]
        first, wall_first = runner_calls(cmd, 1, "the runner")[0]
        # each trained run: the line that announced it, then its done line
        order = [ln.split(": ", 1) for ln in first
                 if ln.startswith(("run: ", "run (salopt dependency): ",
                                   "run (latent dependency): "))]
        done = [parse_done(ln) for ln in first if ln.startswith("done: ")]
        if [d for _, d in order] != [d[0] for d in done]:
            raise AssertionError(f"dependency runs out of order: {first}")
        kinds = [k for k, _ in order]
        want = ["run (salopt dependency)", "run", "run (salopt dependency)", "run",
                "run (latent dependency)", "run", "run"]
        if kinds != want:
            raise AssertionError(f"runs {kinds}, expected {want}")
        on_card = device.startswith("cuda")
        runs = {}
        for run_dir, wall, steps, launches, host, _ in done:
            method = os.path.basename(run_dir).split("_")[2]
            kernel = grid_kernel(method)
            if launches != ({kernel: steps} if kernel and on_card else {}):
                raise AssertionError(f"{method}: {steps} steps but launches {launches}")
            perf = utils.load_dict(os.path.join(run_dir, "performance.pkl"))
            if not (np.isfinite(perf["train_loss"]).all()
                    and os.path.exists(os.path.join(run_dir, "model.pth"))):
                raise AssertionError(f"{method}: non-finite loss or no model.pth")
            d_steps = perf["steps"][-1] - perf["steps"][0]
            rate = d_steps / (perf["times"][-1] - perf["times"][0])
            runs[run_dir] = (rate, host)
            print(f"model-in-the-loop {method}: {os.path.basename(run_dir).split('_')[1]} "
                  f"{steps} steps, launches {launches}, {rate:.3f} steps/s after the first "
                  f"plot epoch, {wall:.3f} s wall; host ms per step "
                  f"{json.dumps({k: round(v, 3) for k, v in host.items()})}; losses "
                  f"{[round(float(x), 4) for x in perf['train_loss']]} on {card}")
        second, wall_second = runner_calls(cmd, 1, "the runner")[0]
        skips = [ln for ln in second if ln.startswith("skip (done): ")]
        if len(skips) != len(methods) or any(ln.startswith(("run", "done: ")) for ln in second):
            raise AssertionError(f"dependency rerun trained: {second}")
        print(f"model-in-the-loop runner: {len(done)} runs ({len(done) - len(methods)} "
              f"dependencies) in {wall_first:.3f} s; the rerun skipped all {len(skips)} in "
              f"{wall_second:.3f} s, on {card}")
    return runs


def k27_geometry(np, rng, n, sig_len, k=27):
    """Disjoint pieces covering [0, T) with every fourth empty, pieces at
    both ends, sources running past the row (clamped), random selectors."""
    dst = np.sort(rng.integers(0, sig_len, (n, k)), axis=1)
    dst[:, 0] = 0
    ln = np.diff(np.concatenate([dst, np.full((n, 1), sig_len)], 1), axis=1)
    ln[:, 1::4] = 0
    src = np.clip(dst + rng.integers(-60, 60, (n, k)), -4, sig_len + 4)
    return {"mix": rng.permutation(n), "dst": dst, "src": src, "len": ln,
            "sel": rng.integers(0, 2, (n, k)),
            "alpha": rng.uniform(0, 1, (n, k)).astype(np.float32),
            "knots": rng.normal(1.0, 0.2, (n, 6, C)).astype(np.float32),
            "lam": 1.0}


def source_steps(np, a, t, prepaired):
    """Distinct source steps that a zero-base plan ``a`` (device arrays)
    reads: of one batch's rows (K1: a row may be read as d1 and as d2), or
    of the d1 and d2 buffers apart (K3).  Output steps past ``t`` read
    nothing; a source index past the row clamps to its end."""
    dst, src, ln, sel, i1, i2 = (a[k].cpu().numpy()
                                 for k in ("dst", "src", "len", "sel", "idx1", "idx2"))
    rows = len(i1) if prepaired else int(max(i1.max(), i2.max())) + 1
    need = np.zeros((2, rows, t), bool)
    for i, k in zip(*np.nonzero(ln > 0)):
        out = np.arange(max(dst[i, k], 0), min(dst[i, k] + ln[i, k], t))
        pos = np.clip(out + src[i, k] - dst[i, k], 0, t - 1)
        if prepaired:
            need[int(sel[i, k] != 0), i, pos] = True
        else:
            need[0, (i2 if sel[i, k] else i1)[i], pos] = True
    return int(need.sum())


# phase 3f: the runtime extras
RT_K = 4  # steps_per_dispatch under test
RT_PAIRS = (("resnet9", "durmixmagwarp(0.2,4)", "pcgmix_plus_fused"),
            ("resnet9", "durratiomixup", "piecewise_mix_pairs"),
            ("Potes", "durmixmagwarp(0.2,4)", "pcgmix_plus_fused"),
            ("Potes", "durratiomixup", "piecewise_mix_pairs"),
            ("resnet9", "durmixmagwarp(0.2,4)+0.5", "pcgmix_plus_fused"))
# the epochs of each steps/s run (all but the first timed: 99 steps)
RT_RATE_EPOCHS = {"resnet9": 12, "Potes": 12}


class StepLosses:
    """Within: every step's loss of ``train_model``, eager or chunked, in
    order (the chunk route's per-step losses, which the performance dict
    averages per epoch)."""

    def __init__(self):
        from pcgmix_tpu_torch.train import steps

        self.steps, self.losses = steps, []

    def __enter__(self):
        s, rec = self.steps, self.losses
        self._call, self._run = s.TrainStep.__call__, s.MultiStep.run

        def call(step, *a, **k):
            out = self._call(step, *a, **k)
            rec.append(out["loss"].reshape(1))
            return out

        def run(multi, *a, **k):
            out = self._run(multi, *a, **k)
            rec.append(out["loss"])
            return out

        s.TrainStep.__call__, s.MultiStep.run = call, run
        return self

    def __exit__(self, *exc):
        self.steps.TrainStep.__call__, self.steps.MultiStep.run = self._call, self._run

    def values(self, np, torch):
        return np.asarray(torch.cat(self.losses).cpu().numpy(), np.float64)


class Timed:
    """Within: the host seconds of every call of ``owner.name``.  With
    ``sync`` (the torch module) the card's queue is drained before each
    call, outside the clock, so a copy that waits for the stream is timed
    without that wait."""

    def __init__(self, owner, name, sync=None):
        self.owner, self.name, self.sync, self.seconds = owner, name, sync, []

    def __enter__(self):
        import inspect

        self.raw = inspect.getattr_static(self.owner, self.name)
        orig, seconds, sync = getattr(self.owner, self.name), self.seconds, self.sync

        def timed(*a, **k):
            if sync is not None:
                sync.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return orig(*a, **k)
            finally:
                seconds.append(time.perf_counter() - t0)

        setattr(self.owner, self.name,
                staticmethod(timed) if isinstance(self.raw, staticmethod) else timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.raw)


def rt_train(torch, mk, TrainConfig, train_model, data, *, model="resnet9",
             method="durmixmagwarp(0.2,4)", epochs=3, k=1, **overrides):
    """One full-width ``train_model`` call at batch B: its performance dict,
    launch counts (replays counted), the graph warm-up's launches, every
    step's loss, and the wall seconds."""
    import types

    import numpy as np

    cfg = TrainConfig(model=model, method=method, num_epochs=epochs, batch_size=B,
                      num_channels=C, save_artifacts=False, steps_per_dispatch=k,
                      **overrides)
    torch.cuda.synchronize()
    mk.reset_launch_counts()
    t0 = time.time()
    with StepLosses() as rec:
        perf = train_model(cfg, data)
    torch.cuda.synchronize()
    return types.SimpleNamespace(perf=perf, launches=mk.launch_counts(),
                                 warm_ups=mk.warm_up_counts(), losses=rec.values(np, torch),
                                 wall=time.time() - t0)


def rate_corpus():
    """The corpus of the gang and bf16 rate runs: 602 train rows, 9 steps
    an epoch at batch 64."""
    from pcgmix_tpu_torch.data import synthetic_physionet_dict

    return synthetic_physionet_dict(num_wavs_train=40, num_wavs_test=4, segments_per_wav=16,
                                    sig_len=T, seed=13)


def steady_rate(perf):
    """Steps/s over the plot epochs after the first (synced there)."""
    return ((perf["steps"][-1] - perf["steps"][0])
            / (perf["times"][-1] - perf["times"][0]))


def route_rates(run, epochs, **kw):
    """Steps/s of one step per dispatch (1) and of the graph (RT_K), each
    run twice for ``epochs`` epochs in the order eager, graph, graph, eager;
    the first epoch (the warm-up and capture) is not timed."""
    rates = {1: [], RT_K: []}
    for k in (1, RT_K, RT_K, 1):
        rates[k].append(steady_rate(run(k=k, epochs=epochs, **kw).perf))
    return rates


def relative_gap(np, a, ref):
    """|a − ref| / |ref| step by step; 0 where they are equal (the loss of
    a separated batch may be 0.0 on both)."""
    gap = np.abs(a - ref)
    return np.divide(gap, np.abs(ref), out=np.where(gap > 0, np.inf, 0.0),
                     where=ref != 0)


def print_rates(what, rates, n_steps, card):
    gain = sum(rates[RT_K]) / sum(rates[1]) - 1
    print(f"steps/s {what}: graph {rates[RT_K][0]:.3f}, {rates[RT_K][1]:.3f}; eager "
          f"{rates[1][0]:.3f}, {rates[1][1]:.3f}, over {n_steps} steps each (routes "
          f"alternated eager, graph, graph, eager); graph against eager {100 * gain:+.2f} % "
          f"on {card}")


def runtime_phase(np, torch, card, mk):
    """Phase 3f: steps_per_dispatch as a CUDA graph against one step per
    dispatch, op="SGD", exact resume, serving, the device cache, the
    profiler trace and the variability counter.  Returns the graph route's
    K1/K2 launches by kernel."""
    import pickle

    from pcgmix_tpu_torch import serve, utils
    from pcgmix_tpu_torch.data import device_cache, physionet_split, synthetic_physionet_dict
    from pcgmix_tpu_torch.train import TrainConfig, checkpoint, loop, steps, train_model

    t_phase = time.time()
    # 9 steps an epoch at batch 64: two full chunks of 4 and a partial one
    rt_ds = synthetic_physionet_dict(num_wavs_train=80, num_wavs_test=12,
                                     segments_per_wav=8, sig_len=T, seed=12)
    per_epoch = len(physionet_split(rt_ds, "train")) // B
    if per_epoch < 2 * RT_K + 1 or per_epoch % RT_K == 0:
        raise AssertionError(f"phase 3f: {per_epoch} steps an epoch, not two full chunks "
                             "and a partial one")
    run = lambda **kw: rt_train(torch, mk, TrainConfig, train_model, rt_ds, **kw)  # noqa: E731
    graph_launches = {}
    for model, method, kernel in RT_PAIRS:
        e, g = (run(model=model, method=method, k=k, lr_max=0.0) for k in (1, RT_K))
        d = float(np.max(np.abs(np.subtract(g.perf["train_loss"], e.perf["train_loss"]))))
        n_steps = g.perf["steps"][-1]
        print(f"graph {model} {method}: frozen weights, {n_steps} steps ({per_epoch} an "
              f"epoch), plot-epoch max |diff| to one step per dispatch {d:.3e}; "
              f"{kernel} launches {g.launches[kernel]} (graph, replays counted; "
              f"{g.warm_ups[kernel]} more in the warm-up, undone) / {e.launches[kernel]} "
              f"(eager), on {card}")
        others = {k: n for k, n in g.launches.items() if k != kernel and n}
        gated = "+" in method
        if d >= 1e-5 or g.launches[kernel] != n_steps or others or (
                e.launches[kernel] != n_steps and not gated) or g.perf[
                "lr_per_step"] != e.perf["lr_per_step"]:
            raise AssertionError(f"graph {model} {method}: differs from one step per "
                                 f"dispatch (launches {g.launches} / {e.launches})")
        if model == "resnet9" and not gated:
            graph_launches[kernel] = g.launches[kernel]

    # training: every step's loss of both routes under cuDNN's deterministic
    # algorithms (one step per dispatch is then one run), against how far
    # the eager route moves when every scheduled scalar moves by about its
    # float32 rounding (lr_max one float32 ulp up): the most that the
    # graph's update, reading its scalars as float32 device values, could
    # add
    torch.backends.cudnn.deterministic = True
    nudged = float(np.nextafter(np.float32(0.01), np.float32(1)))
    for model, op in (("resnet9", "adam"), ("Potes", "adam"), ("resnet9", "SGD")):
        e, g, nu = (run(model=model, op=op, k=k, lr_max=lr)
                    for k, lr in ((1, 0.01), (RT_K, 0.01), (1, nudged)))
        rel, f32 = relative_gap(np, g.losses, e.losses), relative_gap(np, nu.losses, e.losses)
        # both routes compute in the same float32 scalars, so the bar is
        # the rounding's own gap, and no wider than 1e-6
        bar = min(float(f32.max()), 1e-6)
        worst = int(np.argmax(rel))
        print(f"graph {model} {op} at lr 0.01, cuDNN deterministic: {len(rel)} steps, step 0 "
              f"|diff| {abs(g.losses[0] - e.losses[0]):.3e}, step 1 relative {rel[1]:.3e}, "
              f"largest relative {rel[worst]:.3e} (step {worst}), bar {bar:.3e} (the "
              f"float32-scalar gap {f32.max():.3e}, at most 1e-6); lr_per_step equal: "
              f"{g.perf['lr_per_step'] == e.perf['lr_per_step']}; losses "
              f"{np.round(e.perf['train_loss'], 4).tolist()}")
        if not (np.isfinite(g.losses).all() and len(g.losses) == len(e.losses)
                and abs(g.losses[0] - e.losses[0]) < 1e-5 and rel[1] < 1e-3
                and rel.max() <= bar and g.perf["lr_per_step"] == e.perf["lr_per_step"]):
            raise AssertionError(f"graph {model} {op}: per-step losses differ from the "
                                 "eager route")
    torch.backends.cudnn.deterministic = False

    from pcgmix_tpu_torch.models import build_model
    from pcgmix_tpu_torch.train.steps import make_optimizer

    opt, sched = make_optimizer(build_model("resnet9-5k"), "SGD", 0.01, 1e-4, 100, True)
    mom = []
    for _ in range(100):
        mom.append(opt.param_groups[0]["momentum"])
        opt.step()
        sched.step()
    print(f"SGD: OneCycle momentum {mom[0]:.4f} -> {min(mom):.4f} -> {mom[-1]:.4f}")
    if not (abs(mom[0] - 0.95) < 1e-9 and abs(min(mom) - 0.85) < 1e-3 and mom[-1] > 0.949):
        raise AssertionError("SGD: momentum not cycled")

    # speed: the routes alternated, each timed over the epochs after its first
    # (ResNet9's are timed in phase 3h, beside its bf16 routes)
    for model, epochs in RT_RATE_EPOCHS.items():
        if model == "resnet9":
            continue
        print_rates(f"{model} durmixmagwarp(0.2,4)", route_rates(run, epochs, model=model),
                    (epochs - 1) * per_epoch, card)

    # the host time of a step's uploads, each call after the card's queue is
    # drained: eager, the indices and each plan array on their own; chunked,
    # one staged buffer for K steps (the warm-up's chunk is staged too)
    with Timed(steps.TrainStep, "upload", torch) as up, Timed(
            loop.AugmentEngine, "device_arrays", torch) as arrs:
        run(k=1, epochs=2)
    with Timed(steps.MultiStep, "_stage", torch) as stage:
        run(k=RT_K, epochs=2)
    eager_ms = (sum(up.seconds) + sum(arrs.seconds)) / len(up.seconds) * 1e3
    chunk_ms = sum(stage.seconds) / (2 * per_epoch + RT_K) * 1e3
    print(f"host ms per step of the uploads, the card's queue drained before each: eager "
          f"{eager_ms:.3f} (indices and plan arrays, {len(up.seconds)} steps), chunked "
          f"{chunk_ms:.3f} (one pinned buffer per {RT_K} steps, {len(stage.seconds)} "
          f"stagings for {2 * per_epoch} steps and the warm-up's {RT_K}); saved "
          f"{eager_ms - chunk_ms:.3f} on {card}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_rt_") as tmp:
        # ---- exact resume ----
        # 5 steps an epoch at batch 16: one chunk of 4 and a partial one
        small = synthetic_physionet_dict(num_wavs_train=24, num_wavs_test=6,
                                         segments_per_wav=4, sig_len=T, seed=5)

        def resume_cfg(method, root, k):
            return TrainConfig(model="resnet9-5k", method=method, num_epochs=3,
                               batch_size=16, num_channels=C, checkpoint_every=1,
                               steps_per_dispatch=k, plot=False,
                               experiments_root=os.path.join(tmp, root))

        # cuDNN's deterministic algorithms: two uninterrupted runs are then
        # the same run, and the resumed one must be it too
        torch.backends.cudnn.deterministic = True
        for method, k in (("durmixmagwarp(0.2,4)", 1), ("magnitudewarp(0.2,4)", 1),
                          ("durmixmagwarp(0.2,4)", RT_K)):
            tag = f"{method.split('(')[0]}_k{k}"
            ref = train_model(resume_cfg(method, f"ref_{tag}", k), small)
            again = train_model(resume_cfg(method, f"again_{tag}", k), small)
            spread = max(float(np.max(np.abs(np.subtract(ref[key], again[key]))))
                         for key in ("train_loss", "test_loss"))
            orig_save = checkpoint.CheckpointManager.save

            def crashing_save(self, *a, **kw):
                orig_save(self, *a, **kw)
                raise RuntimeError("simulated crash")

            checkpoint.CheckpointManager.save = crashing_save
            try:
                train_model(resume_cfg(method, f"run_{tag}", k), small)
                raise AssertionError("the simulated crash did not happen")
            except RuntimeError as err:
                if "simulated crash" not in str(err):
                    raise
            finally:
                checkpoint.CheckpointManager.save = orig_save
            mk.reset_launch_counts()
            with Timed(checkpoint.CheckpointManager, "restore") as rs, Timed(
                    loop, "replay_plan_rng") as rp, Timed(
                    checkpoint.CheckpointManager, "save") as sv:
                t0 = time.time()
                resumed = train_model(resume_cfg(method, f"run_{tag}", k), small)
                resume_wall = time.time() - t0
            resumed_launches = {n: c for n, c in mk.launch_counts().items() if c}
            resumed_warm_ups = {n: c for n, c in mk.warm_up_counts().items() if c}
            diff = max(float(np.max(np.abs(np.subtract(resumed[key], ref[key]))))
                       for key in ("train_loss", "test_loss"))
            mk.reset_launch_counts()
            rerun = train_model(resume_cfg(method, f"run_{tag}", k), small)
            rerun_launches = sum(mk.launch_counts().values()) + sum(
                mk.warm_up_counts().values())
            print(f"resume resnet9-5k {method} steps_per_dispatch={k}: max |diff| to the "
                  f"uninterrupted run {diff:.3e}, the uninterrupted run's own repeat spread "
                  f"{spread:.3e}; the resumed call's launches {resumed_launches} (warm-up "
                  f"{resumed_warm_ups}); checkpoint save {1e3 * np.mean(sv.seconds):.3f} ms, "
                  f"restore {1e3 * np.mean(rs.seconds):.3f} ms, replay_plan_rng "
                  f"{1e3 * sum(rp.seconds):.3f} ms, resumed call {resume_wall:.3f} s; "
                  f"rerun launches {rerun_launches} on {card}")
            if diff > spread + 1e-6 or rerun_launches or rerun["train_loss"] != resumed[
                    "train_loss"] or (k > 1 and not resumed_warm_ups):
                raise AssertionError(f"resume {method} steps_per_dispatch={k}: differs from "
                                     "the uninterrupted run")
        torch.backends.cudnn.deterministic = False

        # ---- serving ----
        dat = os.path.join(tmp, "serve.dat")
        utils.dict2file(rt_ds, dat)
        test = physionet_split(rt_ds, "test")
        served, cli = {}, []
        for model in ("resnet9", "Potes"):
            cfg = TrainConfig(model=model, method="durmixmagwarp(0.2,4)", num_epochs=1,
                              batch_size=B, num_channels=C, plot=False,
                              experiments_root=os.path.join(tmp, "serve_runs"))
            train_model(cfg, rt_ds)
            pth = os.path.join(loop.experiment_dir(cfg), "model.pth")
            art = os.path.join(tmp, f"{model}.pcgt")
            live = serve.Classifier.from_checkpoint(pth, model, sig_len=T)
            t0 = time.time()
            live.export_artifact(art, (C, T), model_name=model)
            export_s = time.time() - t0
            exported = serve.ExportedClassifier(art)
            rates = {}
            rows = np.concatenate([test.data] * (2048 // len(test.data) + 1))[:2048]
            for name, clf in (("live", live), ("artifact", exported)):
                clf.predict_proba(rows)
                t0 = time.perf_counter()
                probs = clf.predict_proba(rows)
                rates[name] = (len(rows) / (time.perf_counter() - t0), probs)
            d = float(np.max(np.abs(rates["live"][1] - rates["artifact"][1])))
            served[model] = (d, rates, export_s, os.path.getsize(art))
            cli += [(model, mode, [*args, "--dataset-file", dat, "--split", "test"])
                    for mode, args in (("artifact", ["--artifact", art]),
                                       ("live", ["--checkpoint", pth, "--model", model]))]
        # the serving CLI, the four calls started together
        cli_out = {(model, mode): [ln.split("\t")[:2] for ln in lines
                                   if not ln.startswith("#")]
                   for (model, mode, _), (lines, _) in zip(cli, _module_calls(
                       "pcgmix_tpu_torch.serve", [args for _, _, args in cli]))}
        for model, (d, rates, export_s, size) in served.items():
            outs = {mode: cli_out[model, mode] for mode in ("live", "artifact")}
            print(f"serve {model}: artifact against live max |diff| {d:.3e} over "
                  f"{len(rows)} rows; {len(outs['live'])} recordings, CLI predictions "
                  f"equal: {outs['live'] == outs['artifact']}; rows/s at batch 256: live "
                  f"{rates['live'][0]:.1f}, artifact {rates['artifact'][0]:.1f}; export "
                  f"{export_s:.3f} s, {size} bytes, on {card}")
            if d > 1e-5 or outs["live"] != outs["artifact"] or not outs["live"]:
                raise AssertionError(f"serve {model}: artifact and live disagree")

        # ---- device cache, profiler, variability ----
        device_cache.clear()
        prof_dir = os.path.join(tmp, "profile")
        # frozen weights: two runs of one config are then bit-equal (cuDNN's
        # backward need not be deterministic)
        base = dict(model="resnet9", method="durmixmagwarp(0.2,4)", num_epochs=2,
                    batch_size=B, num_channels=C, lr_max=0.0)
        first = train_model(TrainConfig(**base, save_artifacts=False), rt_ds)
        before = device_cache.stats()
        cfg = TrainConfig(**base, profile_dir=prof_dir, track_variability=True,
                          experiments_root=os.path.join(tmp, "vary"))
        second = train_model(cfg, rt_ds)
        after = device_cache.stats()
        uncached = train_model(TrainConfig(**base, save_artifacts=False,
                                           device_cache=False), rt_ds)
        traces = os.listdir(prof_dir)
        named = any("mix_warp_kernel" in open(os.path.join(prof_dir, f)).read()
                    for f in traces)
        with open(os.path.join(loop.experiment_dir(cfg), "variability.pkl"), "rb") as f:
            vary = pickle.load(f)
        print(f"device cache: {before} after the first call, {after} after the second; "
              f"losses equal to an uncached call: "
              f"{second['train_loss'] == uncached['train_loss']}; first call "
              f"{first['train_loss'] == second['train_loss']}; profiler trace {traces} "
              f"names the K2 kernel: {named}; variability.pkl keys {sorted(vary)}, "
              f"{vary['steps'][-1] + 1} steps, {vary['pairs'][-1]} pairs")
        if not (after["hits"] > before["hits"] and second["train_loss"] == uncached[
                "train_loss"] and named and vary["steps"]):
            raise AssertionError("device cache, profiler or variability check failed")
    print(f"runtime phase: {time.time() - t_phase:.3f} s wall on {card}")
    return graph_launches


def runtime_dp_phase(np, torch, card, mk):
    """Phase 3f on the data-parallel route (inside a 1-rank NCCL group):
    steps_per_dispatch as a CUDA graph with the collectives inside, K3/K4,
    against one step per dispatch with the weights frozen, and the steps/s
    of both routes alternated.  Returns the graph route's K3/K4 launches,
    empty if the capture is refused (the refusal is printed)."""
    from pcgmix_tpu_torch.data import physionet_split, synthetic_physionet_dict
    from pcgmix_tpu_torch.train import TrainConfig, train_model

    rt_ds = synthetic_physionet_dict(num_wavs_train=80, num_wavs_test=12,
                                     segments_per_wav=8, sig_len=T, seed=12)
    run = lambda **kw: rt_train(torch, mk, TrainConfig, train_model, rt_ds, **kw)  # noqa: E731
    launches = {}
    for method, kernel in (("durmixmagwarp(0.2,4)", "pcgmix_plus_fused_prepaired"),
                           ("durratiomixup", "piecewise_mix_prepaired")):
        e = run(method=method, k=1, lr_max=0.0)
        try:
            g = run(method=method, k=RT_K, lr_max=0.0)
        except RuntimeError as err:
            print(f"data-parallel graph {method}: capture refused: {err}")
            return {}
        d = float(np.max(np.abs(np.subtract(g.perf["train_loss"], e.perf["train_loss"]))))
        print(f"data-parallel graph {method}: frozen weights, plot-epoch max |diff| {d:.3e}; "
              f"{kernel} launches {g.launches[kernel]} (graph; {g.warm_ups[kernel]} more in "
              f"the warm-up, undone) / {e.launches[kernel]} (eager) on {card}")
        if d >= 1e-5 or g.launches[kernel] != g.perf["steps"][-1]:
            raise AssertionError(f"data-parallel graph {method}: differs from one step "
                                 "per dispatch")
        launches[kernel] = g.launches[kernel]
    epochs = RT_RATE_EPOCHS["resnet9"]
    print_rates("data-parallel resnet9 durmixmagwarp(0.2,4)", route_rates(run, epochs),
                (epochs - 1) * (len(physionet_split(rt_ds, "train")) // B), card)
    return launches


# phase 4: the methods the single-device route trains, on the data-parallel
# route (the batch split over the ranks of the 1-rank NCCL group): method,
# model, corpus, the kernel a step of each route launches (None: none) and
# how often a data-parallel step launches it (lc-nointrusion: its block of
# the pool, then its block of the picked rows), config overrides ("salopt":
# phase 3e's pretrained saliency run; "deps": its experiments root, where
# the canonical embedder lies)
K1, K2 = "piecewise_mix_pairs", "pcgmix_plus_fused"
K3, K4 = "piecewise_mix_prepaired", "pcgmix_plus_fused_prepaired"
DP_METHODS = (
    ("mixup(mix)", "resnet9", "1d", None, None, 0, {}),
    ("timemask(0.2)", "resnet9", "1d", None, None, 0, {}),
    ("magnitudewarp(0.2,4)", "resnet9", "1d", None, None, 0, {}),
    ("gaussiannoise", "resnet9", "1d", None, None, 0, {}),
    ("mixup(same)", "resnet9", "2d", None, None, 0, {"dataset": SPEC}),
    ("freqmask(0.1)", "resnet9", "2d", None, None, 0, {"dataset": SPEC}),
    ("latentmixup", "resnet9", "1d", None, None, 0, {}),
    ("manifold-cutout", "resnet9", "1d", None, None, 0, {}),
    ("manifold-cutmix", "resnet9", "1d", K1, K3, 1, {}),
    ("manifold-cutmix", "resnet9", "1d", K1, K3, 1, BF16),
    ("(saloptenv)durratiomixup", "resnet9", "1d", K1, K3, 1, {"salopt": True}),
    ("(closestknn=8)durmixmagwarp(0.2,4)", "resnet9", "1d", K2, K4, 1, {"deps": True}),
    ("lc-nointrusion", "Potes", "1d", K1, K3, 2, {}),
    ("saliency-cutmix", "Potes", "1d", K1, K3, 1, {}),
)
DP_EPOCHS = 3  # 12 steps a run
DP_BAR = 1e-5  # frozen weights: every plot epoch's loss against the single-device route's
# in bf16, relative: the group route's BatchNorm takes its statistics from
# all-reduced sums (E[x²] − E[x]², flax's formula), the single-device route
# from torch's batch_norm; the fp32 results part by ~1e-7, and the bf16 cast
# of BatchNorm's output turns that into whole bf16 ulps here and there
# (4.1e-5 on the CPU at resnet9-5k; 0 with local statistics), as the gang's
# vmapped convolutions do for BF16_GANG_BAR
DP_BF16_BAR = BF16_GANG_BAR


@contextlib.contextmanager
def recorded_plans(plans, picks=None):
    """Within: the arrays of every plan the engine builds (None for a
    gated-off step) and every ``lc_select`` pick, appended to ``plans``
    (the picks to ``picks`` where it is given)."""
    import numpy as np

    from pcgmix_tpu_torch.augment import AugmentEngine

    plan, select = AugmentEngine.plan, AugmentEngine.lc_select

    def recorded_plan(self, *args, **kw):
        p = plan(self, *args, **kw)
        if not kw.get("_force"):
            plans.append(None if p is None else
                         {k: np.array(v, copy=True) for k, v in p.arrays.items()})
        return p

    def recorded_select(*args):
        sel = select(*args)
        (plans if picks is None else picks).append({"lc_select": sel.copy()})
        return sel

    AugmentEngine.plan, AugmentEngine.lc_select = recorded_plan, staticmethod(recorded_select)
    try:
        yield plans
    finally:
        AugmentEngine.plan, AugmentEngine.lc_select = plan, staticmethod(select)


def dp_method_runs(torch, drive, corpora, deps, route):
    """Each of ``DP_METHODS`` through ``drive`` on ``route`` ("single" or
    "data-parallel"), weights frozen, under cuDNN's deterministic
    algorithms (the live and pretrained saliency maps that plans are built
    from then repeat bit for bit); ``deps`` holds phase 3e's experiments
    root and the pretrained saliency provider.  Returns {(method, dtype):
    (losses, plans, steps/s, launches)}."""
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for method, model, corpus, k_one, k_dp, per_step, over in DP_METHODS:
            over, hooks = dict(over), None
            if over.pop("salopt", False):
                hooks = {"saliency_model_provider": deps["provider"]}
            if over.pop("deps", False):
                over["experiments_root"] = deps["root"]
            kernel, n = (k_one, 1) if route == "single" else (k_dp, per_step)
            with recorded_plans([]) as plans:
                launches, losses = drive(method, kernel, f"{route} frozen", model=model,
                                         data=corpora[corpus], epochs=DP_EPOCHS, per_step=n,
                                         hooks=hooks, lr_max=0.0, **over)
            out[method, over.get("compute_dtype", "float32")] = (
                losses, plans, drive.last[1], launches)
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def same_plans(np, a, b):
    """True when two runs' recorded plans are equal, bit for bit."""
    if len(a) != len(b):
        return False
    for p, q in zip(a, b):
        if (p is None) != (q is None):
            return False
        if p is not None and (sorted(p) != sorted(q) or not all(
                p[k].dtype == q[k].dtype and np.array_equal(p[k], q[k]) for k in p)):
            return False
    return True


def dp_methods_check(np, card, single, dp):
    """Phase 4's methods: each data-parallel run's loss at every plot epoch
    within ``DP_BAR`` of the single-device run's (bf16: ``DP_BF16_BAR``
    relative) and its plans bit-equal, with both routes' steps/s.  Returns
    {(kernel, method): launches}."""
    launches = {}
    for (method, dtype), (losses, plans, rate, n) in dp.items():
        ref_losses, ref_plans, ref_rate, _ = single[method, dtype]
        d = np.abs(np.subtract(losses, ref_losses))
        if dtype == "float32":
            d, bar, what = float(d.max()), DP_BAR, "|diff|"
        else:
            d, bar, what = float((d / np.abs(ref_losses)).max()), DP_BF16_BAR, "relative diff"
        same = same_plans(np, plans, ref_plans)
        print(f"data-parallel {method} ({dtype}): frozen weights max {what} {d:.3e} over "
              f"{len(losses)} plot epochs (bar {bar:g}); {len(plans)} plans bit-equal to "
              f"the single-device route's: {same}; {rate:.3f} steps/s against single-device "
              f"{ref_rate:.3f} steps/s ({rate / ref_rate:.3f}x) on {card}")
        if not (d < bar and same):
            raise AssertionError(f"data-parallel {method} ({dtype}): differs from the "
                                 "single-device route")
        kernel = next(k_dp for m, _, _, _, k_dp, _, o in DP_METHODS
                      if m == method and o.get("compute_dtype", "float32") == dtype)
        if kernel:
            launches[kernel, method if dtype == "float32" else f"{method} {dtype}"] = n
    return launches


# phase 3g: gang training
GANG_S = 4  # members of the correctness gangs
GANG_METHODS = (("base", None), ("durratiomixup", "piecewise_mix_pairs"),
                ("durmixmagwarp(0.2,4)", "pcgmix_plus_fused"))
GANG_RATE_S = (1, 2, 4, 8)
GANG_RATE_MEMBER_STEPS = 36  # timed member-steps of each rate measurement
GANG_BAR = 1e-6  # members against their sequential runs, frozen weights
# the model in the loop in a gang: (model, method, the kernel its apply
# launches once a gang step); the hook methods take phase 3e's runs
GANG_MIL = (("resnet9", "lc-nointrusion", "piecewise_mix_pairs"),
            ("resnet9", "saliency-cutmix", "piecewise_mix_pairs"),
            ("Potes", "lc-nointrusion", "piecewise_mix_pairs"),
            ("Potes", "saliency-cutmix", "piecewise_mix_pairs"),
            ("resnet9", "(saloptenv)durratiomixup", "piecewise_mix_pairs"),
            ("resnet9", "(closestknn=8)durmixmagwarp(0.2,4)", "pcgmix_plus_fused"))
LIVE_RATE_MEMBER_STEPS = 36  # timed member-steps of each live-gang rate run


def gang_members(TrainConfig, model, method, n, epochs, **kw):
    """``n`` members of one grid point: seed_data 1100001… and seed 1…."""
    return [TrainConfig(model=model, method=method, num_epochs=epochs, batch_size=B,
                        num_channels=C, save_artifacts=False, seed_data=1100001 + s,
                        seed=s + 1, **kw) for s in range(n)]


def gang_gap(np, perfs, cfgs, data, train_model):
    """The largest relative gap of the members' train and test losses to
    their own sequential ``train_model`` runs."""
    gaps = []
    for perf, cfg in zip(perfs, cfgs):
        ref = train_model(cfg, data)
        for k in ("train_loss", "test_loss"):
            gaps.append(float(np.max(relative_gap(np, np.asarray(perf[k], np.float64),
                                                  np.asarray(ref[k], np.float64)))))
    return max(gaps)


def gang_phase(np, torch, card, mk, get_deps, runners):
    """Phase 3g: gangs of full-width ResNet9 and Potes (batch 64, 4 × 2500)
    against their members' sequential runs (frozen weights; 7 steps at lr
    0.01 under cuDNN's deterministic algorithms), K1/K2 once a gang step, a
    ragged UMC gang, the graph gang against the eager one, the runner with
    --gang and its rerun, the model-in-the-loop gangs (``mil_gang_phase``),
    member-steps/s of S = 1, 2, 4, 8 against sequential runs, and peak
    memory per member beside the estimate.  ``runners``: the background
    jobs of the runner's calls (``gang_runner_check`` and the others the
    caller started), which run beside the frozen gangs and end before any
    rate is taken; ``get_deps()`` waits for phase 3e's runs.  Returns the
    gang path's K1/K2 launches by (kernel, geometry), and the profiled gang
    calls."""
    from pcgmix_tpu_torch.data import (
        physionet_split,
        synthetic_physionet_dict,
        synthetic_umc_dict,
    )
    from pcgmix_tpu_torch.models import build_model
    from pcgmix_tpu_torch.train import TrainConfig, gang, train_model

    t_phase = time.time()
    ds = synthetic_physionet_dict(num_wavs_train=36, num_wavs_test=12,
                                  segments_per_wav=8, sig_len=T, seed=11)

    def ganged(cfgs, data, **kw):
        torch.cuda.synchronize()
        mk.reset_launch_counts()
        t0 = time.time()
        perfs = gang.train_gang(cfgs, data, **kw)
        torch.cuda.synchronize()
        return perfs, mk.launch_counts(), time.time() - t0

    launches = {}
    for model in ("resnet9", "Potes"):
        for method, kernel in GANG_METHODS:
            cfgs = gang_members(TrainConfig, model, method, GANG_S, 2, lr_max=0.0)
            perfs, counts, wall = ganged(cfgs, ds)
            steps = perfs[0]["steps"][-1]
            gap = gang_gap(np, perfs, cfgs, ds, train_model)
            print(f"gang frozen {model} {method}: S={GANG_S}, {steps} gang steps in "
                  f"{wall:.3f} s, launches {counts}; members against their sequential runs: "
                  f"max relative gap {gap:.3e} (bar {GANG_BAR:g}) on {card}")
            if any(n != (steps if k == kernel else 0) for k, n in counts.items()):
                raise AssertionError(f"gang {model} {method}: {steps} steps, launches {counts}")
            if not gap <= GANG_BAR:
                raise AssertionError(f"gang {model} {method}: members differ from their runs "
                                     f"(max relative gap {gap:.3e}, bar {GANG_BAR:g})")
            if kernel:
                launches[kernel, "gang"] = counts[kernel]

    # at lr 0.01, one step an epoch, cuDNN's deterministic algorithms
    ds_steps = synthetic_physionet_dict(num_wavs_train=10, num_wavs_test=4,
                                        segments_per_wav=8, sig_len=T, seed=11)
    torch.backends.cudnn.deterministic = True
    try:
        for model in ("resnet9", "Potes"):
            cfgs = gang_members(TrainConfig, model, "durmixmagwarp(0.2,4)", GANG_S, 7)
            perfs, _, _ = ganged(cfgs, ds_steps)
            for s, (perf, cfg) in enumerate(zip(perfs, cfgs)):
                ref = np.asarray(train_model(cfg, ds_steps)["train_loss"], np.float64)
                got = np.asarray(perf["train_loss"], np.float64)
                print(f"gang lr 0.01 {model} member {s}: relative gap over 7 steps "
                      f"{relative_gap(np, got, ref).tolist()} (step 0 |diff| "
                      f"{abs(got[0] - ref[0]):.3e}, bar 1e-5) on {card}")
                if not abs(got[0] - ref[0]) < 1e-5:
                    raise AssertionError(f"gang {model}: step 0 differs from its run")
        # the graph gang: K gang steps a CUDA graph, against the eager gang
        cfgs = gang_members(TrainConfig, "resnet9", "durmixmagwarp(0.2,4)", GANG_S, 3)
        eager, e_counts, _ = ganged(cfgs, ds)
        graph, g_counts, _ = ganged(
            [dataclasses.replace(c, steps_per_dispatch=RT_K) for c in cfgs], ds)
        gap = max(float(np.max(relative_gap(np, np.asarray(g["train_loss"], np.float64),
                                            np.asarray(e["train_loss"], np.float64))))
                  for g, e in zip(graph, eager))
        print(f"gang graph resnet9 durmixmagwarp(0.2,4): S={GANG_S}, K={RT_K}, lr 0.01, "
              f"cuDNN deterministic: graph against eager max relative gap {gap:.3e}; "
              f"launches {g_counts} (graph, replays counted) / {e_counts} (eager) on {card}")
        if gap > GANG_BAR or g_counts != e_counts:
            raise AssertionError("the graph gang differs from the eager gang")
    finally:
        torch.backends.cudnn.deterministic = False

    # a ragged gang: three UMC folds, each its own train size and test patients
    umc_ds = synthetic_umc_dict(segments_per_patient=4, sig_len=UMC_LEN, seed=11)
    cfgs = [dataclasses.replace(c, dataset="UMC", seed_data=f) for c, f in zip(
        gang_members(TrainConfig, "resnet9", "durratiomixup", 3, 2, lr_max=0.0), (1, 2, 5))]
    perfs, counts, wall = ganged(cfgs, umc_ds)
    sizes = [len(gang.build_splits(c, umc_ds)[0]) for c in cfgs]
    lock = 2 * max(n // B for n in sizes)
    gap = gang_gap(np, perfs, cfgs, umc_ds, train_model)
    print(f"gang ragged UMC folds 1, 2, 5: train rows {sizes}, {lock} lockstep steps in "
          f"{wall:.3f} s, member steps {[p['steps'][-1] for p in perfs]}, launches {counts}; "
          f"frozen weights max relative gap {gap:.3e} (bar {GANG_BAR:g}) on {card}")
    if counts.get("piecewise_mix_pairs") != lock or not gap <= GANG_BAR:
        raise AssertionError("the ragged gang differs from its members' runs")

    launches.update(mil_gang_phase(np, torch, card, mk, ds))
    get_deps()
    for job in runners:
        job.join()
    stamp("phase 3g's frozen gangs beside the runner's calls")
    live_gang_rates(np, torch, card)

    # member-steps/s: sequential runs and gangs of S, alternated in turns;
    # peak memory per member beside the estimate's S_max
    rate_ds = rate_corpus()
    rows = len(physionet_split(rate_ds, "train"))
    spe = rows // B
    for model in ("resnet9", "Potes"):
        rates: dict = {}
        peaks: dict = {}
        # ResNet9 also as a gang of 4 with its convolutions as matmuls
        # ("matmul"), the JAX package's escape from grouped convolutions
        mm = ["matmul"] if model == "resnet9" else []
        order = ["seq", *GANG_RATE_S, *mm, *mm, *GANG_RATE_S[::-1], "seq"]
        for s in order:
            n = {"seq": 1, "matmul": GANG_S}.get(s, s)
            epochs = 1 + max(1, -(-GANG_RATE_MEMBER_STEPS // (n * spe)))
            cfgs = gang_members(TrainConfig, model, "durmixmagwarp(0.2,4)", n, epochs,
                                conv_impl="matmul" if s == "matmul" else "xla")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            perfs = ([train_model(cfgs[0], rate_ds)] if s == "seq"
                     else gang.train_gang(cfgs, rate_ds))
            torch.cuda.synchronize()
            rates.setdefault(s, []).append(n * steady_rate(perfs[0]))
            peaks[s] = torch.cuda.max_memory_allocated()
        seq = sum(rates["seq"]) / 2
        for s in (*GANG_RATE_S, *mm):
            r, n = rates[s], {"matmul": GANG_S}.get(s, s)
            what = f"S={s}" if s != "matmul" else f"S={GANG_S} conv_impl=matmul"
            print(f"gang rate {model} durmixmagwarp(0.2,4) {what}: {r[0]:.3f}, {r[1]:.3f} "
                  f"member-steps/s (sequential {rates['seq'][0]:.3f}, {rates['seq'][1]:.3f}); "
                  f"gang against sequential {sum(r) / 2 / seq:.3f}x; peak memory "
                  f"{peaks[s] / n / 2**20:.1f} MiB a member ({peaks[s] / 2**30:.3f} GiB) "
                  f"on {card}")
        cfg = gang_members(TrainConfig, model, "durmixmagwarp(0.2,4)", 1, 1)[0]
        s_max = gang.estimate_gang_max_size(cfg, rows, corpus_bytes=rows * C * T * 4,
                                            sample_shape=(C, T))
        saved = gang.activation_bytes(build_model(model, 2, C, T), (B, C, T))
        state = gang.gang_state_bytes(cfg, rows, (C, T))
        s_hi, s_lo = GANG_RATE_S[-1], GANG_RATE_S[0]
        marginal = (peaks[s_hi] - peaks[s_lo]) / (s_hi - s_lo)
        print(f"gang estimate {model}: autograd saves {saved / 2**20:.1f} MiB a member, "
              f"state {state / 2**20:.1f} MiB; each member past the first adds "
              f"{marginal / 2**20:.1f} MiB to the peak (S={s_lo} to {s_hi}), "
              f"{marginal / saved:.3f}x the saved bytes (reuse {gang.REUSE['float32']} "
              "assumed); S_max "
              f"{s_max} (timed windows of {GANG_RATE_MEMBER_STEPS} member-steps or more, "
              f"{spe} steps an epoch) on {card}")
        if not all(np.isfinite(v).all() for v in rates.values()):
            raise AssertionError(f"gang rates {model}: not finite")

    profiled = {
        model: (lambda m=model: gang.train_gang(
            gang_members(TrainConfig, m, "durmixmagwarp(0.2,4)", GANG_S, 2), ds))
        for model in ("resnet9", "Potes")}
    # the live gang: where a gang step of lc-nointrusion spends the device
    profiled["resnet9 lc-nointrusion"] = lambda: gang.train_gang(
        gang_members(TrainConfig, "resnet9", "lc-nointrusion", GANG_S, 2), ds)
    print(f"gang phase: {time.time() - t_phase:.3f} s wall on {card}")
    return launches, profiled


def gang_runner_check(card, ds):
    """Phase 3g's runner part: two gangs of four through the runner CLI
    with --gang, then the rerun, which must train nothing."""
    from pcgmix_tpu_torch import utils

    with tempfile.TemporaryDirectory(prefix="chip_smoke_gang_") as tmp:
        dat = os.path.join(tmp, "corpus.dat")
        utils.dict2file(ds, dat)
        cmd = ["--dataset-file", dat, "--model", "resnet9", "--batch-size", str(B),
               "--num-epochs", "2", "--n-fractions", "1.0", "--no-robust", "--no-plot",
               "--experiments-root", os.path.join(tmp, "experiments"), "--gang",
               "--no-gang-fallback", "--methods", "durratiomixup", "durmixmagwarp(0.2,4)",
               "--seed-datas", *[str(1100001 + s) for s in range(GANG_S)]]
        (first, wall_first), (second, wall_second) = runner_calls(cmd, 2, "the gang runner")
        gangs = [ln for ln in first if ln.startswith("gang of ")]
        dones = [ln for ln in first if ln.startswith("gang done: ")]
        for ln in gangs + dones:
            print(f"gang runner: {ln}")
        if (len(gangs) != 2 or len(dones) != 2
                or sum(ln.startswith("done (gang): ") for ln in first) != 2 * GANG_S
                or any('{"piecewise_mix_pairs": 8}' not in d and '{"pcgmix_plus_fused": 8}'
                       not in d for d in dones)):
            raise AssertionError(f"gang runner: {first}")
        skips = sum(ln.startswith("skip (done): ") for ln in second)
        if skips != 2 * GANG_S or any(ln.startswith(("gang of", "run: ")) for ln in second):
            raise AssertionError(f"gang runner rerun trained: {second}")
        print(f"gang runner: 2 gangs of {GANG_S} in {wall_first:.3f} s; the rerun skipped "
              f"all {skips} in {wall_second:.3f} s, on {card}")


def salopt_runner_check(card, ds):
    """Phase 3g's runner part for a hook method: a (saloptenv) grid of four
    trains its 'base' runs as a dependency gang, then the hook gang; the
    rerun trains nothing."""
    from pcgmix_tpu_torch import utils

    with tempfile.TemporaryDirectory(prefix="chip_smoke_gang_deps_") as tmp:
        dat = os.path.join(tmp, "corpus.dat")
        utils.dict2file(ds, dat)
        cmd = ["--dataset-file", dat, "--model", "resnet9", "--batch-size", str(B),
               "--num-epochs", "2", "--n-fractions", "1.0", "--no-robust", "--no-plot",
               "--experiments-root", os.path.join(tmp, "experiments"), "--gang",
               "--no-gang-fallback", "--methods", "(saloptenv)durratiomixup",
               "--seed-datas", *[str(1100001 + s) for s in range(GANG_S)]]
        (first, wall_first), (second, wall_second) = runner_calls(cmd, 2, "the gang runner")
        gangs = [ln for ln in first if ln.startswith(("gang of ", "gang done: "))]
        for ln in gangs:
            print(f"gang runner (salopt): {ln}")
        want = [f"gang of {GANG_S} (dependency): base ", "gang done: ",
                f"gang of {GANG_S}: (saloptenv)durratiomixup ", "gang done: "]
        if (len(gangs) != 4 or not all(g.startswith(w) for g, w in zip(gangs, want))
                or '{"piecewise_mix_pairs": 8}' not in gangs[3]
                or sum(ln.startswith("done (gang): ") for ln in first) != 2 * GANG_S):
            raise AssertionError(f"gang runner (salopt): {first}")
        skips = sum(ln.startswith("skip (done): ") for ln in second)
        if skips != GANG_S or any(ln.startswith(("gang of", "run")) for ln in second):
            raise AssertionError(f"gang runner (salopt) rerun trained: {second}")
        print(f"gang runner (salopt): the dependency gang and the hook gang of {GANG_S} in "
              f"{wall_first:.3f} s; the rerun skipped all {skips} in {wall_second:.3f} s, "
              f"on {card}")


def runner_calls(cmd, n, what):
    """Run the runner CLI ``cmd`` ``n`` times in a subprocess from this
    checkout; returns each call's (stdout lines, wall s)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [here, os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep)}
    outs = []
    for _ in range(n):
        t0 = time.time()
        proc = _start([sys.executable, "-m", "pcgmix_tpu_torch.exp.runner", *cmd], cwd=here,
                      env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        out, err = _wait(proc, 600)
        if proc.returncode:
            print(out[-4000:], err[-4000:], file=sys.stderr)
            raise AssertionError(f"{what} exited {proc.returncode}")
        outs.append((out.splitlines(), time.time() - t0))
    return outs


def frozen_hook_models(TrainConfig, train_model, ds, root):
    """The hook methods' frozen models, trained on ``ds`` into ``root``:
    a ResNet9 base run (the checkpoint a (salopt…) provider loads) and the
    canonical ResCNN embedder that a (closestknn…) method resolves from
    ``root``.  Called under cuDNN's deterministic algorithms, so that the
    hook gangs' plans, and with them the rounding their members' gaps come
    from, are the same on every run, as the other frozen gangs' are.
    Returns the base run's directory."""
    from pcgmix_tpu_torch.exp.dirs import experiment_dir
    from pcgmix_tpu_torch.latent import latent_pretrain_config

    base = TrainConfig(model="resnet9", method="base", num_epochs=2, batch_size=B,
                       num_channels=C, experiments_root=root, plot=False)
    embedder = dataclasses.replace(
        latent_pretrain_config(TrainConfig(num_channels=C, experiments_root=root)),
        plot=False)
    for cfg in (base, embedder):
        train_model(cfg, ds)
    return experiment_dir(base)


def mil_gang_phase(np, torch, card, mk, ds):
    """Phase 3g's model-in-the-loop gangs: each of ``GANG_MIL`` as a gang
    of 4 with frozen weights under cuDNN's deterministic algorithms, every
    member within ``GANG_BAR`` of its own sequential run, every plan and
    pick bit-equal, and the kernel launched once a gang step, nothing else;
    the hook methods take ``frozen_hook_models``.  Returns {(kernel,
    geometry): launches}."""
    from pcgmix_tpu_torch.saliency import make_pretrained_saliency_fn
    from pcgmix_tpu_torch.train import TrainConfig, gang, train_model

    launches = {}
    root = tempfile.mkdtemp(prefix="chip_smoke_hooks_")
    torch.backends.cudnn.deterministic = True
    try:
        base_dir = frozen_hook_models(TrainConfig, train_model, ds, root)
        for model, method, kernel in GANG_MIL:
            over, hooks = {}, {}
            if "closest" in method:  # the canonical embedder of root
                over["experiments_root"] = root
            cfgs = gang_members(TrainConfig, model, method, GANG_S, 2, lr_max=0.0, **over)
            if "salopt" in method:  # one provider a member, on phase 3e's base run
                hooks["saliency_model_providers"] = [
                    make_pretrained_saliency_fn(TrainConfig(model=model), lambda m: base_dir)
                    for _ in cfgs]
            gplans, gpicks = [], []
            torch.cuda.synchronize()
            mk.reset_launch_counts()
            t0 = time.time()
            with recorded_plans(gplans, gpicks):
                perfs = gang.train_gang(cfgs, ds, **hooks)
            torch.cuda.synchronize()
            wall, counts = time.time() - t0, mk.launch_counts()
            gaps, same = [], True
            for s, (perf, cfg) in enumerate(zip(perfs, cfgs)):
                one = ({"saliency_model_provider": hooks["saliency_model_providers"][s]}
                       if hooks else {})
                plans, picks = [], []
                with recorded_plans(plans, picks):
                    ref = train_model(cfg, ds, **one)
                for k in ("train_loss", "test_loss"):
                    gaps.append(float(np.max(relative_gap(
                        np, np.asarray(perf[k], np.float64), np.asarray(ref[k], np.float64)))))
                # the gang plans (and picks) its members in turn, step by step
                same &= (same_plans(np, gplans[s::GANG_S], plans)
                         and same_plans(np, gpicks[s::GANG_S], picks))
            steps = perfs[0]["steps"][-1]
            print(f"gang frozen {model} {method}: S={GANG_S}, {steps} gang steps in "
                  f"{wall:.3f} s, launches {counts}; members against their sequential runs: "
                  f"max relative gap {max(gaps):.3e} (bar {GANG_BAR:g}); {len(gplans)} plans "
                  f"and {len(gpicks)} picks bit-equal: {same} on {card}")
            if any(n != (steps if k == kernel else 0) for k, n in counts.items()):
                raise AssertionError(f"gang {model} {method}: {steps} steps, launches {counts}")
            if not (max(gaps) <= GANG_BAR and same):
                raise AssertionError(f"gang {model} {method}: members differ from their runs "
                                     f"(max relative gap {max(gaps):.3e}, bar {GANG_BAR:g}; "
                                     f"plans and picks bit-equal: {same})")
            if model == "resnet9":
                geometry = "gang-pool" if method == "lc-nointrusion" else f"gang {method}"
                launches[kernel, geometry] = counts[kernel]
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(root, ignore_errors=True)
    return launches


def live_gang_rates(np, torch, card):
    """Member-steps/s of the live gang of 4 (lc-nointrusion) against its
    sequential runs, alternated sequential, gang, gang, sequential, with the
    host ms per step of the live passes."""
    from pcgmix_tpu_torch.timing import host_times, reset_host_times
    from pcgmix_tpu_torch.train import TrainConfig, gang, train_model

    t_phase = time.time()
    rate_ds = rate_corpus()
    spe = len(gang.build_splits(gang_members(TrainConfig, "Potes", "base", 1, 1)[0],
                                rate_ds)[0]) // B
    for model in ("Potes", "resnet9"):
        rates: dict = {}
        host: dict = {}
        for what in ("seq", "gang", "gang", "seq"):
            n = GANG_S if what == "gang" else 1
            epochs = 1 + max(1, -(-LIVE_RATE_MEMBER_STEPS // (n * spe)))
            cfgs = gang_members(TrainConfig, model, "lc-nointrusion", n, epochs)
            torch.cuda.synchronize()
            reset_host_times()
            perf = (gang.train_gang(cfgs, rate_ds)[0] if what == "gang"
                    else train_model(cfgs[0], rate_ds))
            torch.cuda.synchronize()
            rates.setdefault(what, []).append(n * steady_rate(perf))
            host[what] = {k: round(ms / perf["steps"][-1], 3)
                          for k, (ms, _) in host_times().items()}
        seq, ganged_r = rates["seq"], rates["gang"]
        print(f"gang rate {model} lc-nointrusion S={GANG_S}: {ganged_r[0]:.3f}, "
              f"{ganged_r[1]:.3f} member-steps/s (sequential {seq[0]:.3f}, {seq[1]:.3f}); "
              f"gang against sequential {sum(ganged_r) / sum(seq):.3f}x; host ms per gang "
              f"step {json.dumps(host['gang'])}, per sequential step "
              f"{json.dumps(host['seq'])} ({spe} steps an epoch, {LIVE_RATE_MEMBER_STEPS} "
              f"member-steps or more timed after the first) on {card}")
        if not all(np.isfinite(v).all() for v in rates.values()):
            raise AssertionError(f"live gang rates {model}: not finite")
    print(f"gang live rates: {time.time() - t_phase:.3f} s wall on {card}")


# phase 3i: the offline builder on the card and classical_space.  The
# generated corpora: reference-layout PhysioNet-2016 (subsets a-f, 8
# recordings each of 10-60 s at 2 kHz, both classes; test recordings 2 and
# 3 of each subset, recording 3 Springer-annotated, b0000 with a noise run)
# and UMC (16 recordings of 10-30 s at 4 kHz, patient ids from the folds).
# The real corpora (about 3,150 PhysioNet recordings of 5-120 s) are not in
# the repository: these trees are a cut of their scale, not of their
# shapes.  One cycle: (state, samples at 2 kHz), each jittered ±15 %.
CYCLE_2K = (("S1", 280), ("systole", 480), ("S2", 240), ("diastole", 800))
UMC_RECORDINGS = {  # dataset: (patient id field, seconds)
    "DKMP_OLD": (("2", 10), ("19", 14), ("17", 12), ("10", 18)),
    "RKMP_OLD": (("1", 11), ("16", 16), ("3", 13), ("22", 30)),
    "DKMP_UMC": (("002", 20), ("008", 15), ("000", 24), ("010", 12)),
    "RKMP_UMC": (("013", 17), ("003", 22), ("001", 10), ("005", 26)),
}
# the CPU tests' bar (tests/test_torch_builder.py): 1e-2 dB over the
# smallest standardization std of the spectrogram builds
BUILD_SPEC_BAR = 1e-2 / 13.9
CLASSICAL_STEPS = 8  # the full-width classical_space runs (2 epochs of 4)


def _pcg(np, n, label, sr, rng):
    """A synthetic PCG: a 40 Hz carrier over noise, abnormal recordings
    with a 160 Hz murmur."""
    t = np.arange(n) / sr
    y = 0.05 * rng.standard_normal(n) + 0.3 * np.sin(2 * np.pi * 40 * t)
    if label:
        y += 0.4 * np.sin(2 * np.pi * 160 * t)
    return np.clip(y, -0.99, 0.99).astype(np.float32)


def _state_stream(n, rng, scale=1):
    """(frames, states) of the full cycles that fit in ``n`` samples, 1-based
    from sample 101, ending on the S1 that closes the last cycle."""
    frames, states, pos = [], [], 101
    while True:
        cycle = [(s, int(d * scale * rng.uniform(0.85, 1.15))) for s, d in CYCLE_2K]
        if pos + sum(d for _, d in cycle) + 1 >= n:
            break
        for s, d in cycle:
            frames.append(pos)
            states.append(s)
            pos += d
    return frames + [pos], states + ["S1"]


def _band_wavs(np, wavfile, y, sr, bands, path_of):
    """The pre-filtered band wavs: the zero-phase band-pass at ``sr`` and
    unit RMS (the 'raw_filtBandIIR(ZP)4-{band}_normRMS' files), float32."""
    from pcgmix_tpu_torch.data.builder import BANDS
    from pcgmix_tpu_torch.ops.filtering import bandpass_filtfilt, rms_normalize_host

    for band in bands:
        path = path_of(band)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        x = rms_normalize_host(bandpass_filtfilt(y, *BANDS[band], float(sr)))
        wavfile.write(path, sr, x.astype(np.float32))


def write_physionet_tree(np, root, seed=17):
    """The reference-layout PhysioNet-2016 tree (``data/corpus.py``'s
    docstring) under ``root``; returns its number of recordings."""
    from scipy.io import savemat, wavfile

    from pcgmix_tpu_torch.data import corpus

    rng = np.random.default_rng(seed)
    test_rows = []
    for si, subset in enumerate(corpus.PHYSIONET_SUBSETS):
        ref_rows = []
        for r in range(8):
            wav, label = f"{subset}{r:04d}", r % 2
            sig_qual = 0 if r == 3 else 1
            n = 2000 * (10 + (7 * r + 11 * si) % 51)
            y = _pcg(np, n, label, 2000, rng)
            frames, states = _state_stream(n, rng)
            if wav == "b0000":
                states[6] = "(N"  # one noise run: that window is skipped
            sub, key, name = (("hand_corrected", f"training-{subset}_StateAns",
                               f"{wav}_StateAns.mat") if sig_qual else
                              ("springer_alg", f"training-{subset}-Aut", f"{wav}_StateAns0.mat"))
            path = os.path.join(root, "annotations", sub, key, name)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            rows = np.empty((len(frames), 2), dtype=object)
            for k, (f, s) in enumerate(zip(frames, states)):
                rows[k, 0] = np.array([[float(f)]])
                rows[k, 1] = np.array([s], dtype=object)
            savemat(path, {"state_ans" if sig_qual else "state_ans0": rows})
            raw = os.path.join(root, f"training-{subset}", "raw", f"{wav}.wav")
            os.makedirs(os.path.dirname(raw), exist_ok=True)
            wavfile.write(raw, 2000, (y * 32767).astype(np.int16))
            _band_wavs(np, wavfile, y, 2000, corpus.PHYSIONET_BANDS,
                       lambda band: corpus._physionet_band_wav(root, subset, wav, band))
            ref_rows.append(f"{wav},{1 if label else -1},{sig_qual}")
            if r in (2, 3):
                test_rows.append(f"{wav},{1 if label else -1}")
        csv_dir = os.path.join(root, "annotations", "updated", f"training-{subset}")
        os.makedirs(csv_dir, exist_ok=True)
        with open(os.path.join(csv_dir, "REFERENCE_withSQI.csv"), "w") as f:
            f.write("\n".join(ref_rows) + "\n")
    os.makedirs(os.path.join(root, "validation"), exist_ok=True)
    with open(os.path.join(root, "validation", "REFERENCE.csv"), "w") as f:
        f.write("\n".join(test_rows) + "\n")
    return 8 * len(corpus.PHYSIONET_SUBSETS)


def write_umc_tree(np, root, seed=19):
    """The reference-layout UMC tree under ``root``: per-sample state traces
    at 4 kHz, raw and band wavs; returns its number of recordings."""
    from scipy.io import wavfile

    from pcgmix_tpu_torch.data import corpus

    rng = np.random.default_rng(seed)
    code = {"S1": 1, "systole": 2, "S2": 3, "diastole": 4}
    n_recs = 0
    for ds_name, recs in UMC_RECORDINGS.items():
        for pid, seconds in recs:
            n = 4000 * seconds
            frames, states = _state_stream(n, rng, scale=2)
            trace = np.zeros(n, np.int64)
            trace[:frames[0]] = 4  # a diastole lead-in, as a clipped first run
            for j in range(len(frames) - 1):
                trace[frames[j]:frames[j + 1]] = code[states[j]]
            trace[frames[-1]:] = 1
            fname = f"{pid}_1_states.txt" if ds_name.endswith("_OLD") else f"{pid}_1_a_states.txt"
            seg = os.path.join(root, ds_name, "segments", fname)
            os.makedirs(os.path.dirname(seg), exist_ok=True)
            np.savetxt(seg, trace, fmt="%d")
            rec = "_".join(fname.split("_")[:2 if ds_name.endswith("_OLD") else 3])
            y = _pcg(np, n, int(ds_name.startswith("DKMP")), 4000, rng)
            raw = os.path.join(root, ds_name, "raw", f"{rec}.wav")
            os.makedirs(os.path.dirname(raw), exist_ok=True)
            wavfile.write(raw, 4000, (y * 32767).astype(np.int16))
            _band_wavs(np, wavfile, y, 4000, corpus.UMC_BANDS, lambda band: os.path.join(
                root, ds_name, f"raw_filtBandIIR(ZP)4-{band}_normRMS",
                f"{rec}_filtBandIIR(ZP)4-{band}_normRMS.wav"))
            n_recs += 1
    return n_recs


def _module_calls(module, cmds):
    """``python -m module`` with each argument list of ``cmds``, all started
    together from this checkout; each call's (stdout lines, wall s from the
    common start to its exit)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [here, os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep)}
    t0 = time.time()
    logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")) for _ in cmds]
    procs = [_start([sys.executable, "-m", module, *cmd], cwd=here, env=env, stdout=out,
                    stderr=err, text=True)
             for cmd, (out, err) in zip(cmds, logs)]
    ends = [None] * len(procs)
    try:
        while None in ends:
            if time.time() - t0 > 600:
                raise AssertionError(f"{module}: the calls outlasted 600 s")
            for i, proc in enumerate(procs):
                if ends[i] is None and proc.poll() is not None:
                    ends[i] = time.time() - t0
            time.sleep(0.05)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            _CHILDREN.discard(proc)
    outs = []
    for proc, cmd, wall, files in zip(procs, cmds, ends, logs):
        for f in files:
            f.seek(0)
        out, err = (f.read() for f in files)
        for f in files:
            f.close()
        if proc.returncode:
            print(out[-4000:], err[-4000:], file=sys.stderr)
            raise AssertionError(f"{module} {' '.join(cmd)} exited {proc.returncode}")
        outs.append((out.splitlines(), wall))
    return outs


def _same_build(np, got, exp, spec_bar):
    """The largest spectrogram difference of two builds of one kind, after
    checking that everything else is equal (the 1-D bands bit for bit)."""
    if sorted(got) != sorted(exp):
        raise AssertionError(f"build keys differ: {sorted(got)} against {sorted(exp)}")
    if "train" in exp and "test" in exp:
        return max(_same_build(np, got[s], exp[s], spec_bar) for s in exp)
    worst = 0.0
    for key, v in exp.items():
        if key == "data" and not isinstance(v, dict):
            if got[key].shape != v.shape:
                raise AssertionError(f"spectrograms {got[key].shape} against {v.shape}")
            worst = float(np.abs(got[key] - v).max()) if v.size else 0.0
            if worst > spec_bar:
                raise AssertionError(f"spectrograms differ by {worst:.3e} (bar {spec_bar:.3e})")
        elif key == "data":
            for band, a in v.items():
                if not np.array_equal(got[key][band], a):
                    raise AssertionError(f"band {band} differs")
        elif not np.array_equal(got[key], v):
            raise AssertionError(f"build key {key} differs")
    return worst


def build_phase(np, card, tmp, devices=("cuda", "cpu")):
    """Phase 3i's builds: the two trees, all six corpus builds through the
    builder CLI on the card, then again with ``--device cpu`` (each wave's
    builds run together), held equal; returns the built .dat paths of the
    first wave.  ``devices=("cpu", "cpu")`` rehearses it on the CPU."""
    from pcgmix_tpu_torch import utils
    from pcgmix_tpu_torch.data.corpus import BUILDERS, SPECTROGRAM_KINDS

    t0 = time.time()
    roots = {"physionet": os.path.join(tmp, "physionet"), "umc": os.path.join(tmp, "umc")}
    n_phys = write_physionet_tree(np, roots["physionet"])
    n_umc = write_umc_tree(np, roots["umc"])
    print(f"builder trees: PhysioNet {n_phys} recordings of 10-60 s at 2 kHz, UMC {n_umc} "
          f"of 10-30 s at 4 kHz, written in {time.time() - t0:.3f} s (a cut of the real "
          "corpora's scale: about 3,150 PhysioNet recordings of 5-120 s)")
    dats, walls, mel = {}, {}, {}
    for wave, device in zip(("card", "cpu"), devices):
        cmds = [["--corpus", kind, "--root", roots["umc" if kind.startswith("umc") else
                                                     "physionet"],
                 "--out", os.path.join(tmp, f"{kind}-{wave}.dat"), "--device", device]
                for kind in BUILDERS]
        for kind, (lines, wall) in zip(BUILDERS, _module_calls(
                "pcgmix_tpu_torch.data.builder", cmds)):
            dats[kind, wave] = os.path.join(tmp, f"{kind}-{wave}.dat")
            walls[kind, wave] = wall
            timing = [json.loads(ln[len("timing: "):]) for ln in lines
                      if ln.startswith("timing: ")]
            if kind in SPECTROGRAM_KINDS:
                if len(timing) != 1:
                    raise AssertionError(f"build {kind} on {device}: no mel timing line")
                mel[kind, wave] = timing[0]["mel spectrogram"]
            print(f"build {kind} --device {device}: {lines[0]}")
    for kind in BUILDERS:
        got, exp = utils.file2dict(dats[kind, "card"]), utils.file2dict(dats[kind, "cpu"])
        worst = _same_build(np, got, exp, BUILD_SPEC_BAR)
        splits = [got] if "label" in got else [got["train"], got["test"]]
        n = sum(len(s["label"]) for s in splits)
        line = (f"build {kind}: {n} cycles; card {walls[kind, 'card']:.3f} s, CPU "
                f"{walls[kind, 'cpu']:.3f} s wall (the six builds of a device together); "
                "labels, frames, wavs, sig_qual equal")
        if kind in SPECTROGRAM_KINDS:
            (ms_card, n_card), (ms_cpu, _) = mel[kind, "card"], mel[kind, "cpu"]
            line += (f"; spectrograms max |diff| {worst:.3e} (bar {BUILD_SPEC_BAR:.3e}); mel "
                     f"part {ms_card:.3f} ms on the card against {ms_cpu:.3f} ms on the CPU "
                     f"({n_card} recordings)")
        else:
            line += "; bands bit-equal"
        print(f"{line}, on {card}")
        if n == 0:
            raise AssertionError(f"build {kind}: no cycles")
    # the mel part alone in steady state (a build process pays its first
    # call's set-up): one 35 s recording at 2 kHz, 128 mels, hop 34
    from pcgmix_tpu_torch.data.corpus import recording_mel_db

    y = np.random.default_rng(3).standard_normal(70000).astype(np.float32)
    steady = {}
    for wave, device in zip(("card", "CPU"), devices):
        for _ in range(3):
            recording_mel_db(y, 2000, 128, 25.0, 1000.0, 34, device)
        t0 = time.perf_counter()
        for _ in range(20):
            recording_mel_db(y, 2000, 128, 25.0, 1000.0, 34, device)
        steady[wave] = (time.perf_counter() - t0) / 20 * 1e3
    print(f"mel part of one 35 s recording (host to device and back included), steady "
          f"state over 20 calls: card {steady['card']:.3f} ms, CPU {steady['CPU']:.3f} ms, "
          f"on {card}")
    return {kind: dats[kind, "card"] for kind in BUILDERS}


def classical_phase(np, torch, card, drive, ds, plus_rate, dats, tmp, model="resnet9",
                    device="cuda"):
    """Phase 3i's classical_space part: PCGmix+ and PCGmix at full width on
    the card (K2 / K1 twice a step: the step and the dump) and the PCGmix+
    run's first steps against a CPU run of the same config.  Returns the
    launches of the two card runs by kernel.  ``model``, ``device`` and a
    CPU ``drive`` rehearse it on the CPU."""
    import dataclasses as dc

    from pcgmix_tpu_torch.train import TrainConfig, loop, train_model

    t_phase, launches = time.time(), {}
    rows, keep = {}, loop._dump_classical

    def recording(where):
        def dump(data, share, batch, step_count, results_dir):
            if step_count < 4:
                rows[where, step_count] = data.float().cpu().numpy()
            return keep(data, share, batch, step_count, results_dir)
        return dump

    roots = {w: os.path.join(tmp, f"classical_{w}") for w in ("cuda", "cpu", "k1")}
    plans = {"cuda": [], "cpu": []}
    try:
        loop._dump_classical = recording("cuda")
        with recorded_plans(plans["cuda"]):
            launches["pcgmix_plus_fused"], _ = drive(
                "durmixmagwarp(0.2,4)", "pcgmix_plus_fused", "classical", model=model,
                epochs=2, per_step=2, classical_space=True, experiments_root=roots["cuda"])
        rate = drive.last[1]
        loop._dump_classical = recording("cpu")
        cfg = TrainConfig(model=model, method="durmixmagwarp(0.2,4)", num_epochs=1,
                          batch_size=B, num_channels=C, save_artifacts=False,
                          classical_space=True, experiments_root=roots["cpu"], device="cpu")
        t0 = time.time()
        with recorded_plans(plans["cpu"]):
            train_model(cfg, ds)
        cpu_s = time.time() - t0
    finally:
        loop._dump_classical = keep
    launches["piecewise_mix_pairs"], _ = drive(
        "durratiomixup", "piecewise_mix_pairs", "classical", model=model, epochs=2,
        per_step=2, classical_space=True, experiments_root=roots["k1"])
    csvs = {w: sorted(os.listdir(os.path.join(r, "classical_space"))) for w, r in roots.items()}
    if len(csvs["cuda"]) != CLASSICAL_STEPS or len(csvs["k1"]) != CLASSICAL_STEPS:
        raise AssertionError(f"classical_space: {csvs} CSVs, not one a step")
    steps = len(csvs["cpu"])
    for a, b in zip(plans["cuda"][:steps], plans["cpu"]):
        if sorted(a) != sorted(b) or any(not np.array_equal(a[k], b[k]) for k in a):
            raise AssertionError("classical_space: card and CPU plans differ")
    row_err = max(float(np.abs(rows["cuda", i] - rows["cpu", i]).max()) for i in range(steps))
    exact = row_err == 0.0
    worst_rel, n_diff, n_vals = 0.0, 0, 0
    for i in range(steps):
        with open(os.path.join(roots["cuda"], "classical_space", f"train_{i}.csv")) as f:
            got = [line.split(",") for line in f.read().splitlines()]
        with open(os.path.join(roots["cpu"], "classical_space", f"train_{i}.csv")) as f:
            exp = [line.split(",") for line in f.read().splitlines()]
        if got[0] != exp[0] or len(got) != B + 1 or len(got[0]) != 5 + 255:
            raise AssertionError(f"classical_space step {i}: headers or rows differ")
        for g, e in zip(got[1:], exp[1:]):
            if g[:5] != e[:5]:
                raise AssertionError(f"classical_space step {i}: meta columns differ")
            for a, b in zip(g[5:], e[5:]):
                n_vals += 1
                if a != b:
                    n_diff += 1
                    if a and b:
                        fa, fb = float(a), float(b)
                        worst_rel = max(worst_rel, abs(fa - fb) / max(abs(fb), 1e-30))
    print(f"classical_space {model} durmixmagwarp(0.2,4), batch {B} x 5x{T} (the model "
          f"sees {C}): K2 {launches['pcgmix_plus_fused']} launches in {CLASSICAL_STEPS} steps; "
          f"{CLASSICAL_STEPS} CSVs of {B} rows; against a CPU run's first {steps} steps "
          f"({cpu_s:.3f} s): plans bit-equal, augmented 5-channel rows max |diff| "
          f"{row_err:.3e} (K2's bar 1e-5), {n_diff} of {n_vals} CSV values differ, largest "
          f"relative difference {worst_rel:.3e}, on {card}")
    if row_err > 1e-5 or (exact and n_diff):
        raise AssertionError("classical_space: the card's CSVs differ from the CPU's beyond "
                             "what its rows allow")
    print(f"classical_space {model} durmixmagwarp(0.2,4): {rate:.3f} steps/s against "
          f"{plus_rate:.3f} without the dumps (phase 3), {rate / plus_rate:.3f}x; K1 with "
          f"durratiomixup {launches['piecewise_mix_pairs']} launches in {CLASSICAL_STEPS} "
          f"steps, on {card}")
    collectors_phase(np, card, roots, tmp, exact_steps=steps if not n_diff else 0)
    print(f"classical phase: {time.time() - t_phase:.3f} s wall on {card}")
    return launches


def classical_runner_check(card, dats, tmp, model="resnet9", device="cuda"):
    """The runner with ``--classical-space`` end to end on the built
    physionet-1d .dat, then its rerun, which must train nothing."""
    root = os.path.join(tmp, "experiments")
    cmd = ["--dataset-file", dats["physionet-1d"], "--methods", "durmixmagwarp(0.2,4)",
           "--n-fractions", "0.25", "--seed-datas", "1100001", "--model", model,
           "--num-epochs", "1", "--batch-size", str(B), "--no-robust", "--no-plot",
           "--experiments-root", root, "--classical-space", "--device", device]
    (first, wall_first), = runner_calls(cmd, 1, "the classical_space runner")
    done = [parse_done(ln) for ln in first if ln.startswith("done: ")]
    if len(done) != 1:
        raise AssertionError(f"classical_space runner: {first}")
    run_dir, wall, n_steps, run_launches, host, _ = done[0]
    n_csv = len(os.listdir(os.path.join(run_dir, "classical_space")))
    want = {"pcgmix_plus_fused": 2 * n_steps} if device == "cuda" else {}
    if run_launches != want or n_csv != n_steps:
        raise AssertionError(f"classical_space runner: {n_steps} steps, launches "
                             f"{run_launches}, {n_csv} CSVs")
    (second, wall_second), = runner_calls(cmd, 1, "the classical_space runner")
    if not any(ln.startswith("skip (done): ") for ln in second) or any(
            ln.startswith(("run: ", "done: ")) for ln in second):
        raise AssertionError(f"classical_space runner rerun trained: {second}")
    print(f"classical_space runner on the built physionet-1d: {n_steps} steps in {wall:.3f} s, "
          f"launches {run_launches}, {n_csv} CSVs, host ms per step {json.dumps(host)}; call "
          f"{wall_first:.3f} s, the rerun skipped in {wall_second:.3f} s, on {card}")


def collectors_phase(np, card, roots, tmp, exact_steps):
    """The augmentation-feature collectors on the PCGmix+ runs' dumps: every
    row collected, a snapshot an epoch with base + B rows a step, and the
    card's first snapshot byte-equal to the CPU run's where the CPU run
    covers its steps with byte-equal CSVs (``exact_steps``)."""
    from pcgmix_tpu_torch.classical import (Table, collect_augmentation_features,
                                            extract_features, merge_augmentation_features)
    from pcgmix_tpu_torch.data import synthetic_physionet_dict

    t0 = time.time()
    # a base table of extracted segments under the UMC notebook's names
    rows = extract_features(synthetic_physionet_dict(num_wavs_train=6, num_wavs_test=2,
                                                     segments_per_wav=2, sig_len=T, seed=23),
                            splits=["train"])
    base = Table.from_rows([
        {**{k: v for k, v in r.items() if k not in ("wav", "sig_qual", "split")},
         "recording": f"{r['wav']}_filtBandIIR(ZP)4-25-400_normRMS"} for r in rows])
    every = collect_augmentation_features(roots["cuda"])
    per_epoch = CLASSICAL_STEPS // 2
    parts = {w: merge_augmentation_features(roots[w], base, os.path.join(tmp, f"merged_{w}"),
                                            "pcgmix_plus", steps_per_epoch=per_epoch)
             for w in ("cuda", "cpu")}
    counts = [len(Table.read_csv(path)) for path in parts["cuda"]]
    if len(every) != CLASSICAL_STEPS * B or counts != [len(base) + p * per_epoch * B
                                                       for p in range(3)]:
        raise AssertionError(f"collectors: {len(every)} rows collected, snapshots {counts}")
    same = None
    if exact_steps >= per_epoch:
        same = open(parts["cuda"][1], "rb").read() == open(parts["cpu"][1], "rb").read()
        if not same:
            raise AssertionError("collectors: the card's first snapshot differs from the "
                                 "CPU run's, whose CSVs are byte-equal")
    print(f"collectors on the PCGmix+ dumps: {len(every)} rows x {len(every.columns)} "
          f"columns collected; snapshots of {counts} rows (base {len(base)} + {B} a step, one "
          f"an epoch of {per_epoch} steps); first snapshot byte-equal to the CPU run's: "
          f"{same if same is not None else 'not checked (CSVs differ)'}; "
          f"{(time.time() - t0) * 1e3:.3f} ms host, on {card}")


def _classical_cli(args):
    """``python -m pcgmix_tpu_torch.classical`` with ``args`` from this
    checkout, started; ``_cli_result`` waits for it."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [here, os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep)}
    proc = _start([sys.executable, "-m", "pcgmix_tpu_torch.classical", *args], cwd=here,
                  env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    proc.started = time.time()
    return proc


def _cli_result(proc, timeout=600):
    """(exit code, stderr, wall s) of a ``_classical_cli`` call; killed at
    ``timeout``."""
    try:
        _, err = _wait(proc, timeout)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the classical CLI outlasted {timeout} s") from None
    return proc.returncode, err, time.time() - proc.started


# phase 3i: the classifier bench on the card against the CPU.  The mutual
# information, Gaussian NB and k-NN run on the card in float64 (sums in
# another order than the CPU's); the trees, SGD, SVC and logistic
# regression on the host either way.  Bars on the test-row probabilities:
# the closed-form estimators within 1e-9, the iterative ones (L-BFGS, SGD,
# SMO) within 1e-4; the selected features identical.
BENCH_BARS = {"LR": 1e-4, "DT": 1e-9, "RF": 1e-9, "KN": 1e-9, "GNB": 1e-9, "SVC": 1e-4,
              "SGD": 1e-4, "GB": 1e-9}


def bench_phase(np, card, out):
    """``run_experiment`` on the fresh CLI run's aggregated.csv, on the card
    (twice: the first run's times carry the process's first launches) and
    on the CPU: the card's two runs equal, the selection identical, each
    classifier's probabilities within ``BENCH_BARS``, every metric's
    largest difference printed; the card run's table equal to the CLI's
    results.csv; the mutual information's and each classifier's fit +
    predict ms on each run."""
    from pcgmix_tpu_torch.classical.experiment import METRICS, run_experiment
    from pcgmix_tpu_torch.classical.table import Table

    agg = Table.read_csv(os.path.join(out, "aggregated.csv"))
    runs = {}
    # the card twice: its first run pays the process's first cuBLAS and
    # kernel loads (the CLI's own run paid them in its process)
    for label, device in (("card, first run", "cuda"), ("card", "cuda"), ("CPU", "cpu")):
        record, t0 = {}, time.time()
        runs[label] = (run_experiment(agg, device=device, record=record), record,
                       time.time() - t0)
    (gpu, rg, _), (cpu, rc, _) = runs["card"], runs["CPU"]
    first = runs["card, first run"][0]
    if any(not np.array_equal(first[c], gpu[c], equal_nan=c != "Classifier")
           for c in gpu.columns):
        raise AssertionError("bench: the card's two runs differ")
    if list(gpu["Classifier"]) != list(BENCH_BARS) or list(cpu["Classifier"]) != list(BENCH_BARS):
        raise AssertionError(f"bench: classifiers {list(gpu['Classifier'])}")
    if rg["selected"] != rc["selected"]:
        raise AssertionError(f"bench: the card selected {rg['selected'][:5]}..., the CPU "
                             f"{rc['selected'][:5]}...")
    gaps = {}
    for name, bar in BENCH_BARS.items():
        gaps[name] = float(np.abs(rg["proba"][name] - rc["proba"][name]).max())
        if not gaps[name] <= bar:
            raise AssertionError(f"bench: {name}'s probabilities part by {gaps[name]:.3e} "
                                 f"between the card and the CPU (bar {bar:g})")
    metric_gaps = {}
    for m in METRICS:
        a, b = gpu[m], cpu[m]
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            raise AssertionError(f"bench: {m} is NaN on one device only")
        metric_gaps[m] = float(np.where(np.isnan(a), 0.0, np.abs(a - b)).max())
    path = os.path.join(out, "results.bench.csv")
    gpu.to_csv(path)
    with open(path, "rb") as f, open(os.path.join(out, "results.csv"), "rb") as g:
        same = f.read() == g.read()
    os.remove(path)
    if not same:
        cli = Table.read_csv(os.path.join(out, "results.csv"))
        for m in METRICS:
            a, b = cli[m], gpu[m]
            d = np.where(np.isnan(a) & np.isnan(b), 0.0, np.abs(a - b))
            bars = np.array([BENCH_BARS[n] for n in gpu["Classifier"].tolist()])
            if not (d <= bars).all():
                raise AssertionError(f"bench: the CLI's results.csv and the card run part on {m}")
    print(f"classifier bench on the CLI's aggregated.csv ({len(agg)} rows, "
          f"{len(rg['selected'])} features by mutual information): card against CPU "
          f"probabilities {', '.join(f'{k} {v:.3e}' for k, v in gaps.items())}; metrics "
          f"{', '.join(f'{k} {v:.3e}' for k, v in metric_gaps.items())}; the card run "
          f"{'byte-equal to' if same else 'within the bars of'} the CLI's results.csv, on {card}")
    for label, (_, record, wall) in runs.items():
        print(f"classifier bench on the {label}: "
              f"{' '.join(f'{k} {v:.3f}' for k, v in record['ms'].items())} ms (MI: the mutual "
              f"information and its selection; the rest fit + predict), {wall:.3f} s wall, "
              f"on {card}")
    print("classifier bench results (card):\n" + "\n".join(
        "  " + " ".join(f"{c}={v}" if c == "Classifier" else f"{c}={v:.6f}"
                         for c, v in zip(gpu.columns, row))
        for row in zip(*(gpu[c].tolist() for c in gpu.columns))))


def classical_cli_phase(np, card, fresh, dat, tmp, beside=None):
    """The classical CLI on the built physionet-1d .dat: ``fresh`` is its
    fresh run on the card (started by the caller), which writes
    features.csv, aggregated.csv and results.csv and hands nothing off;
    the bench against the CPU (``bench_phase``); then a crash story from
    the fresh features' rows, its three calls started together: a
    checkpoint refused without --start-counter, a resume that re-extracts
    two of its rows, and (after a second crash) a third run that folds
    both checkpoints in; the two runs' features.csv, aggregated.csv and
    results.csv byte-equal to the fresh run's, no checkpoint left.
    ``beside()``, if given, runs while the three calls do; a thread waits
    for the calls, so their wall is theirs and not ``beside``'s."""
    out = os.path.join(tmp, "cli_fresh")
    files = ["aggregated.csv", "features.csv", "results.csv"]
    rc, err, wall = _cli_result(fresh)
    if rc:
        print(err[-4000:], file=sys.stderr)
        raise AssertionError(f"classical CLI exited {rc}")
    with open(os.path.join(out, "features.csv")) as f:
        header, *lines = f.read().splitlines(keepends=True)
    n = len(lines)
    if n < 16 or "pcgmix_tpu.classical" in err or sorted(os.listdir(out)) != files:
        raise AssertionError(f"classical CLI fresh run: {n} segments, files "
                             f"{sorted(os.listdir(out))}, stderr {err[-2000:]}")
    print(f"classical CLI fresh run on the built physionet-1d: {n} segments in {wall:.3f} s "
          f"wall, {wall / n * 1e3:.3f} host ms a segment (the process's start, pruning, the "
          f"rolling aggregation and the classifier bench on the card included), on {card}")
    t0 = time.time()
    bench_phase(np, card, out)
    print(f"bench phase: {time.time() - t0:.3f} s wall on {card}")

    dirs = {w: os.path.join(tmp, f"cli_{w}") for w in ("refused", "resumed", "third")}

    def write(name, rows, where):
        os.makedirs(dirs[where], exist_ok=True)
        with open(os.path.join(dirs[where], name), "w") as f:
            f.write("".join([header] + rows))

    t0 = time.time()
    # the three calls together, each in a dir of its own: the refusal, the
    # resume, and the third run of the story (the resume crashed again
    # after a checkpoint of its own, which holds rows the first one holds)
    write("features.partial.csv", lines[:n - 6], "refused")
    write("features.partial.csv", lines[:n - 6], "resumed")
    write("features.partial.prev.csv", lines[:n - 6], "third")
    write("features.partial.csv", lines[n - 8:n - 3], "third")
    calls = [_classical_cli(["--dataset-file", dat, "--out-dir", dirs[w], *counter])
             for w, counter in (("refused", []), ("resumed", ["--start-counter", str(n - 7)]),
                                ("third", ["--start-counter", str(n - 2)]))]
    waiting = Background(lambda: [_cli_result(p) for p in calls])
    beside_s = 0.0
    if beside is not None:
        t_beside = time.time()
        beside()
        beside_s = time.time() - t_beside
    (rc_refused, err, _), *resumed = results = waiting.join()
    calls_s = max(wall for _, _, wall in results)
    if rc_refused == 0 or "partial extraction" not in err:
        raise AssertionError(f"classical CLI resumed without --start-counter: {err[-2000:]}")
    for w, (rc, _, _) in zip(("resumed", "third"), resumed):
        if rc or sorted(os.listdir(dirs[w])) != files:
            raise AssertionError(f"classical CLI {w} run: exit {rc}, files "
                                 f"{os.listdir(dirs[w])}")
        for name in files:
            with open(os.path.join(dirs[w], name), "rb") as a, open(os.path.join(out, name),
                                                                    "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"classical CLI: the {w} run's {name} differs from "
                                         "the fresh one")
    print(f"classical CLI resume protocol: the checkpoint of {n - 6} segments refused without "
          f"--start-counter; resumed from counter {n - 7}; a third run from {n - 2} folding "
          f"both checkpoints in; the two runs' features.csv, aggregated.csv and results.csv "
          f"byte-equal to the fresh run's; checkpoints removed; the three calls, started "
          f"together, {calls_s:.3f} s wall from their start to the last one's end"
          f"{f' (phase 3j beside them, its own wall {beside_s:.3f} s)' if beside else ''}; "
          f"{time.time() - t0:.3f} s for the story, on {card}")


PLOT_FILES = ("accuracy.jpg", "loss.jpg", "learning_rate.jpg", "times.jpg", "variability.jpg",
              "variability.pkl")


def plot_phase(np, torch, card, mk, ds, tmp, model="resnet9", device="cuda"):
    """Phase 3's config (PCGmix+, 4 epochs of 4 steps, all plot epochs) with
    a run dir and ``track_variability``: with ``plot`` the five JPEGs (each
    read by the port's header parse: SOI, SOF0 at 600 x 600, EOI) and
    variability.pkl, without it none; the host ms of a plot epoch; steps/s
    over epochs 2-4 with and without, in the order on, off, off, on (the
    drawing follows the epoch's ``times`` entry, so the rates should not
    move).  ``model``/``device`` rehearse it on the CPU.  Returns the last
    run's dir (its ``model.pth``: phase 3j's model)."""
    from pcgmix_tpu_torch.exp.raster import jpeg_header
    from pcgmix_tpu_torch.train import TrainConfig, loop, train_model

    keep, ms = loop._plot_epoch, []

    def timed(*args, **kw):
        t0 = time.perf_counter()
        keep(*args, **kw)
        ms.append((time.perf_counter() - t0) * 1e3)

    rates = {True: [], False: []}
    try:
        loop._plot_epoch = timed
        for i, plot in enumerate((True, False, False, True)):
            cfg = TrainConfig(model=model, method="durmixmagwarp(0.2,4)", num_epochs=4,
                              batch_size=B, num_channels=C, track_variability=True, plot=plot,
                              experiments_root=os.path.join(tmp, f"plots_{i}"), device=device)
            if device == "cuda":
                torch.cuda.synchronize()
            mk.reset_launch_counts()
            perf = train_model(cfg, ds)
            counts = mk.launch_counts()
            want = {"pcgmix_plus_fused": 16} if device == "cuda" else {}
            if perf["steps"][-1] != 16 or {k: v for k, v in counts.items() if v} != want:
                raise AssertionError(f"plots: {perf['steps'][-1]} steps, launches {counts}")
            rates[plot].append(steady_rate(perf))
            run_dir = loop.experiment_dir(cfg)
            files = set(os.listdir(run_dir))
            if plot:
                if not set(PLOT_FILES) <= files:
                    raise AssertionError(f"plots: the run dir holds {sorted(files)}")
                for name in PLOT_FILES[:5]:
                    with open(os.path.join(run_dir, name), "rb") as f:
                        frame = jpeg_header(f.read())
                    if (frame["width"], frame["height"]) != (600, 600):
                        raise AssertionError(f"plots: {name} is {frame}")
            elif files & set(PLOT_FILES):
                raise AssertionError(f"plots: plot=False wrote {sorted(files & set(PLOT_FILES))}")
    finally:
        loop._plot_epoch = keep
    if len(ms) != 8:
        raise AssertionError(f"plots: {len(ms)} plot epochs drawn, not 8")
    on, off = rates[True], rates[False]
    print(f"plots {model} durmixmagwarp(0.2,4) batch {B} x {C}x{T}, 4 plot epochs with a run "
          f"dir: 5 JPEGs (SOI, SOF0 600x600, EOI) and variability.pkl with plot, none without; "
          f"a plot epoch's drawing {np.mean(ms):.3f} ms host (min {min(ms):.3f}, max "
          f"{max(ms):.3f}, 8 epochs); steps/s over epochs 2-4 with plot {on[0]:.3f}, "
          f"{on[1]:.3f}, without {off[0]:.3f}, {off[1]:.3f} (on, off, off, on), on {card}")
    return run_dir


# phase 3j: the latent-space plots and the loss-mixture fit.  The card's
# PCA against the CPU's and its t-SNE against the CPU's run on the first
# LATENT_CHECK originals and augmented points: PCA coordinates within
# 1e-10 (both float64, sums in another order); t-SNE, whose float32
# trajectories part, by trustworthiness (5 neighbours) within 0.01 and the
# KL divergence under the CPU's P within 2 %.
LATENT_ROWS, LATENT_CHECK = 2048, 256
LATENT_PCA_BAR, LATENT_TRUST_BAR, LATENT_KL_BAR = 1e-10, 0.01, 0.02


def trustworthiness(np, x, emb, k=5):
    """scikit-learn's ``trustworthiness(x, emb, n_neighbors=k)`` in numpy:
    1 − 2 / (n k (2n − 3k − 1)) Σ max(0, r(i, j) − k) over each point's k
    nearest in ``emb``, r its rank among the point's neighbours in ``x``."""
    x, emb = np.asarray(x, np.float64), np.asarray(emb, np.float64)
    n = len(x)
    sq = (x * x).sum(1)
    dx = sq[:, None] - 2 * (x @ x.T) + sq[None, :]
    np.fill_diagonal(dx, np.inf)
    de = ((emb[:, None, :] - emb[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(de, np.inf)
    rank = np.zeros((n, n), dtype=np.int64)
    rank[np.arange(n)[:, None], np.argsort(dx, axis=1)] = np.arange(1, n + 1)
    r = rank[np.arange(n)[:, None], np.argsort(de, axis=1, kind="stable")[:, :k]] - k
    return 1.0 - r[r > 0].sum() * (2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)))


# the loss mixture's checks: EM's M-step keeps the data's mean and second
# moment (Σ w μ = mean, Σ w (σ² − reg_covar + μ²) = mean of squares, up to
# sklearn's 10·eps on each weight); where the modes are known, the fit's
# means and weights within MIXTURE_MODE_BAR of them
MIXTURE_MOMENT_BAR, MIXTURE_MODE_BAR = 1e-9, 0.01


def mixture_check(np, losses, m1, what, modes=None, weights=None):
    """Holds ``plot_epoch_loss_gmm``'s |μ₁−μ₂| ``m1`` on ``losses`` to the
    mixture fitted to the same normalized losses, and that fit to the
    moments of the data (and to the known ``modes`` and ``weights``,
    if given); returns a line of what was held."""
    from pcgmix_tpu_torch.exp.mixture import REG_COVAR, fit_gaussian_mixture

    x = np.asarray(losses, np.float64)
    x = x / x.max()
    gm = fit_gaussian_mixture(x.reshape(-1, 1))
    means, w = gm.means.ravel(), gm.weights
    var = gm.covariances.ravel() - REG_COVAR
    gaps = (abs(float(abs(means[1] - means[0])) - m1), abs(w.sum() - 1),
            abs(w @ means - x.mean()), abs(w @ (var + means ** 2) - (x * x).mean()))
    line = (f"the fit's means {means[0]:.6f}, {means[1]:.6f}, weights {w[0]:.6f}, "
            f"{w[1]:.6f}, {gm.n_iter} EM iterations; |m1 - the fit's| {gaps[0]:.1e}, its "
            f"weights' sum, mean and second moment against the data's {max(gaps[1:]):.1e} "
            f"(bar {MIXTURE_MOMENT_BAR:g})")
    ok = gaps[0] == 0 and max(gaps[1:]) <= MIXTURE_MOMENT_BAR
    if modes is not None:
        order = np.argsort(means)
        mode_gap = max(np.abs(means[order] - np.asarray(modes)).max(),
                       np.abs(w[order] - np.asarray(weights)).max())
        line += f"; the known modes' means and weights within {mode_gap:.1e} " \
                f"(bar {MIXTURE_MODE_BAR:g})"
        ok = ok and mode_gap <= MIXTURE_MODE_BAR
    if not ok:
        raise AssertionError(f"loss mixture on {what}: {line}")
    return line


def png_size(path):
    """(width, height) from a PNG's IHDR; raises where it is not a PNG."""
    import struct

    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


def latent_phase(np, torch, card, mk, run_dir, split, test_split, out, model="resnet9",
                 device="cuda"):
    """The trained model of ``run_dir`` (phase 3's config) embeds ``split``
    (``part="latent_space"``, with its logits) and one PCGmix+ batch of the
    same rows through the engine's apply (K2 once, and nothing else); the
    card's PCA and t-SNE against the CPU's on LATENT_CHECK points of each
    cloud; then ``plot_latent_space`` with PCA and with t-SNE,
    ``plot_latent_space_test`` and ``plot_latent_space_test_train`` (t-SNE,
    with ``test_split``) at full size, each PNG 600 x 600, the wall time
    of each reduction called on its own and of each plot call;
    ``plot_epoch_loss_gmm`` on the model's per-sample losses over
    ``split`` (cross-entropy, correct and incorrect apart) and on losses
    of two known modes (``mixture_check``).  Returns the phase's
    launches.  ``model``/``device``
    rehearse it on the CPU."""
    from pcgmix_tpu_torch import latent
    from pcgmix_tpu_torch.augment import AugmentConfig, AugmentEngine
    from pcgmix_tpu_torch.exp.plotters import plot_epoch_loss_gmm
    from pcgmix_tpu_torch.exp.raster import jpeg_header
    from pcgmix_tpu_torch.manifold import joint_probabilities, kl_divergence, nearest_neighbors
    from pcgmix_tpu_torch.models import build_model
    from pcgmix_tpu_torch.saliency import load_weights

    t_phase = time.time()
    method = "durmixmagwarp(0.2,4)"
    net = build_model(model, 2, C, split.data.shape[-1])
    net.load_state_dict(load_weights(os.path.join(run_dir, "model.pth")))
    net.to(device).eval()
    fts, trgts, confs, _ = latent.get_hidden_features(net, split, device=device)
    test_fts, test_trgts, _, _ = latent.get_hidden_features(net, test_split, device=device)
    n = len(fts)
    engine = AugmentEngine(AugmentConfig(method, n, C, split.data.shape[-1]))
    plan = engine.plan(7, split.frames, split.label)
    x = torch.from_numpy(split.data).to(device)
    onehot = torch.eye(2, device=device)[torch.as_tensor(split.label, device=device).long()]
    if device == "cuda":
        torch.cuda.synchronize()
    mk.reset_launch_counts()
    with torch.no_grad():
        rows, targets = engine.apply(x, onehot, plan.arrays)
        new_fts = np.concatenate([net(rows[i:i + 256], depth=0, part="latent_space").cpu().numpy()
                                  for i in range(0, n, 256)])
    launches = {k: v for k, v in mk.launch_counts().items() if v}
    if launches != ({"pcgmix_plus_fused": 1} if device == "cuda" else {}):
        raise AssertionError(f"latent plots: the PCGmix+ batch launched {launches}")
    new_trgts = targets.argmax(1).cpu().numpy()
    print(f"latent features {model}: {n} rows and their PCGmix+ batch ({launches}), "
          f"{fts.shape[1]} features each, {len(test_fts)} test rows; {time.time() - t_phase:.3f} "
          f"s wall on {card}")

    # the card against the CPU on LATENT_CHECK points of each cloud
    sub, sub_new = fts[:LATENT_CHECK], new_fts[:LATENT_CHECK]
    pca = {d: latent.dim_reduc_pca(sub, sub_new, device=d) for d in (device, "cpu")}
    pca_gap = max(float(np.abs(a - b).max()) for a, b in zip(pca[device][:2], pca["cpu"][:2]))
    both = np.concatenate([sub, sub_new])
    sqdist, neighbors = nearest_neighbors(torch.from_numpy(both), min(len(both) - 1, 46))
    p = joint_probabilities(sqdist, neighbors, 15)
    checks = {}
    for d in (device, "cpu"):
        t0 = time.time()
        emb = np.concatenate(latent.dim_reduc_tsne(sub, sub_new, device=d)[:2])
        checks[d] = (trustworthiness(np, both, emb), kl_divergence(p, emb), time.time() - t0)
    (t_card, kl_card, s_card), (t_cpu, kl_cpu, s_cpu) = checks[device], checks["cpu"]
    print(f"latent PCA at {2 * LATENT_CHECK} points: card against CPU max |diff| {pca_gap:.3e} "
          f"(coordinates up to {np.abs(pca['cpu'][0]).max():.3e}; bar {LATENT_PCA_BAR:g}), "
          f"explained variance {pca[device][2]:.6f} / {pca['cpu'][2]:.6f}; t-SNE "
          f"trustworthiness {t_card:.4f} / {t_cpu:.4f} (bar {LATENT_TRUST_BAR}), KL "
          f"{kl_card:.4f} / {kl_cpu:.4f} under the CPU's P (bar {100 * LATENT_KL_BAR:g} %), "
          f"{s_card:.3f} / {s_cpu:.3f} s (card / CPU), on {card}")
    if not (pca_gap <= LATENT_PCA_BAR and abs(pca[device][2] - pca["cpu"][2]) <= LATENT_PCA_BAR
            and abs(t_card - t_cpu) <= LATENT_TRUST_BAR
            and abs(kl_card - kl_cpu) <= LATENT_KL_BAR * kl_cpu):
        raise AssertionError("latent plots: the card's reductions disagree with the CPU's")

    # the reductions at full size, then the four plots, each call timed
    train = {"fts": fts, "target": trgts, "fts_new": new_fts, "trgts_new": new_trgts}
    test = {"fts": test_fts, "target": test_trgts}
    timed = []
    for name, reduce in (("PCA", latent.dim_reduc_pca), ("t-SNE", latent.dim_reduc_tsne)):
        t0 = time.time()
        reduce(fts, new_fts, device=device)
        timed.append(f"{name} {2 * n} points {time.time() - t0:.3f} s")
    paths, drawn = [], []
    for what, draw in (
            ("pca", lambda: [latent.plot_latent_space(train, "train", 4, 2, method, out, "pca",
                                                      device=device)]),
            ("tsne", lambda: [latent.plot_latent_space(train, "train", 4, 2, method, out,
                                                       "tsne", device=device)]),
            ("test (t-SNE)", lambda: [latent.plot_latent_space_test(
                test, "test", 4, 2, method, out, device=device)]),
            ("test_train (t-SNE)", lambda: list(latent.plot_latent_space_test_train(
                test, train, "final", 4, 2, method, out, device=device)))):
        t0 = time.time()
        paths += draw()
        drawn.append(f"{what} {time.time() - t0:.3f} s")
    for path in paths:
        if png_size(path) != (600, 600):
            raise AssertionError(f"latent plots: {path} is {png_size(path)}")
    print(f"latent reductions at full size: {'; '.join(timed)}; on {card}")
    print(f"latent plots at full size: {', '.join(os.path.basename(p) for p in paths)} "
          f"(PNG 600x600); each call (its reduction and its drawing): {'; '.join(drawn)}; "
          f"on {card}")

    # the loss mixture on the model's per-sample losses over the split
    logits = confs.astype(np.float64)
    labels = np.asarray(trgts)
    top = logits.max(1)
    losses = top + np.log(np.exp(logits - top[:, None]).sum(1)) - logits[np.arange(n), labels]
    right = logits.argmax(1) == labels
    t0 = time.time()
    m1 = plot_epoch_loss_gmm(losses[right], losses[~right], 4, out)
    gmm_ms = (time.time() - t0) * 1e3
    with open(os.path.join(out, "losses", "epoch_loss_dst_4.jpg"), "rb") as f:
        frame = jpeg_header(f.read())
    if (frame["width"], frame["height"]) != (600, 600):
        raise AssertionError(f"loss mixture: the JPEG is {frame}")
    fit = mixture_check(np, np.append(losses[right], losses[~right]), m1, "the epoch's losses")
    print(f"loss mixture on {n} per-sample losses ({int(right.sum())} correct): |mu1 - mu2| "
          f"{m1:.6f}, {fit}, epoch_loss_dst_4.jpg 600x600, {gmm_ms:.3f} ms host, on {card}")
    # and on losses with both modes populated, whose means are known
    rng = np.random.default_rng(23)
    low, high = np.abs(rng.normal(0.15, 0.03, 1536)), rng.normal(0.7, 0.05, 512)
    m1 = plot_epoch_loss_gmm(low, high, 5, out)
    peak = max(low.max(), high.max())
    fit = mixture_check(np, np.append(low, high), m1, "two populated modes",
                        modes=(low.mean() / peak, high.mean() / peak), weights=(0.75, 0.25))
    print(f"loss mixture on {len(low)} + {len(high)} losses of two modes: |mu1 - mu2| "
          f"{m1:.6f}, {fit}, on {card}")
    print(f"latent phase: {time.time() - t_phase:.3f} s wall on {card}")
    return launches


def make_drive(np, torch, mk, card, ds):
    """``drive(method, kernel, route, ...)``: one main-path ``train_model``
    call on the card with its launches checked and its rates printed
    (phases 3–4 and 3h; ``ds`` is the default corpus)."""
    from pcgmix_tpu_torch.timing import host_times, reset_host_times
    from pcgmix_tpu_torch.train import TrainConfig, train_model

    def drive(method, kernel, route, model="resnet9", data=ds, sig_len=T, epochs=4,
              per_step=1, hooks=None, **overrides):
        """One main-path run of ``epochs`` epochs of 4 steps (16 steps; on
        the spectrogram corpus ``spec_ds`` with ``dataset=SPEC``, on a UMC
        dict with ``dataset="UMC"``); the counts are set to 0 just before it
        and read just after.  ``kernel`` must launch ``per_step`` times a
        step, no other kernel at all (``kernel`` None: nothing).  ``hooks``
        go to ``train_model``.  Returns (launches of ``kernel``, losses);
        ``drive.last`` is the run's (perf, steps/s after the first epoch)."""
        cfg = TrainConfig(model=model, method=method, num_epochs=epochs, batch_size=B,
                          num_channels=C, save_artifacts=False, **overrides)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mk.reset_launch_counts()
        reset_host_times()
        t0 = time.time()
        perf = train_model(cfg, data, **(hooks or {}))
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = mk.launch_counts()
        host = {k: round(ms / perf["steps"][-1], 3) for k, (ms, _) in host_times().items()}
        steps = perf["steps"][-1]
        if steps != 4 * epochs or any(n != (per_step * steps if k == kernel else 0)
                                      for k, n in counts.items()):
            raise AssertionError(f"{route} {method}: {steps} steps but launches {counts}")
        if not (np.isfinite(perf["train_loss"]).all() and perf["test_accuracy"]):
            raise AssertionError(f"{route} {method}: non-finite loss or no eval")
        # steady state: plot epochs after the first (cuDNN picks algorithms
        # in epoch 1); `times` is cumulative and synced at plot epochs
        d_steps = perf["steps"][-1] - perf["steps"][0]
        d_time = perf["times"][-1] - perf["times"][0]
        shape = f"1x{SPEC_SIZE}x{SPEC_SIZE}" if cfg.spectrogram else f"{C}x{sig_len}"
        print(f"{route} {method}: {model} batch {B} x {shape}, {steps} steps, "
              f"launches {counts}, losses {perf['train_loss']}, "
              f"test_accuracy {perf['test_accuracy'][-1]}")
        print(f"{route} {method}: {d_steps / d_time:.3f} steps/s, "
              f"{B * d_steps / d_time:.1f} samples/s (epochs 2-{epochs}), "
              f"{steps / wall:.3f} steps/s over the whole call incl. eval "
              f"({wall:.3f} s), peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB on {card}")
        if host:
            print(f"{route} {method}: host ms per step {json.dumps(host)} on {card}")
        drive.last = perf, d_steps / d_time
        return counts.get(kernel, 0), perf["train_loss"]

    return drive


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import numpy as np

        from pcgmix_tpu_torch import native
        from pcgmix_tpu_torch.augment import AugmentConfig, AugmentEngine
        from pcgmix_tpu_torch.bench import conv_bn_fused as k5
        from pcgmix_tpu_torch.data import (
            physionet_split,
            synthetic_physionet_dict,
            synthetic_physionet_full_dict,
            synthetic_spectrogram_dict,
            synthetic_umc_dict,
        )
        from pcgmix_tpu_torch.models import build_model, count_parameters
        from pcgmix_tpu_torch.models.potes import potes_features
        from pcgmix_tpu_torch.ops import mix_kernels as mk
        from pcgmix_tpu_torch.parallel import init_group
        from pcgmix_tpu_torch.saliency import (
            bin_training_saliency,
            make_pretrained_saliency_fn,
            saliency_maps,
            training_saliency_raw,
        )
        from pcgmix_tpu_torch.train import TrainConfig, train_model
        from pcgmix_tpu_torch.train.convert import seeded_init
    except ImportError as e:
        print(f"chip_smoke: the pcgmix_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2

    # ---- 1. card and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    t0 = time.time()
    mk.build_library(verbose=True)
    print(f"kernel build: {time.time() - t0:.3f} s")
    bw, flops = HBM_BYTES_PER_S, FP32_FLOP_PER_S
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 2. kernels against their plain versions --------------------------
    ds = synthetic_physionet_dict(num_wavs_train=36, num_wavs_test=12,
                                  segments_per_wav=8, sig_len=T, seed=11)
    split = physionet_split(ds, "train")
    x32 = torch.from_numpy(split.data[:B]).to(dev)
    frames, labels = split.frames[:B], split.label[:B]
    rng = np.random.default_rng(11)
    k27 = AugmentEngine.device_arrays(k27_geometry(np, rng, B, T), dev)

    def plan(method, **hooks):
        eng = AugmentEngine(AugmentConfig(method, B, C, T))
        return AugmentEngine.device_arrays(eng.plan(7, frames, labels, **hooks).arrays, dev)

    def pieces(a):
        return a["dst"], a["src"], a["len"], a["sel"], a["alpha"]

    def k1(x, a, plain=False):
        fn = mk.piecewise_mix_batch_plain if plain else mk.piecewise_mix_batch
        return lambda: fn(x, a["mix"], *pieces(a))

    def k2(x, a, plain=False):
        fn = mk.pcgmix_plus_fused_plain if plain else mk.pcgmix_plus_fused
        return lambda: fn(x, a["mix"], *pieces(a), a["knots"])

    def k3(x, a, plain=False):
        fn = mk.piecewise_mix_prepaired_plain if plain else mk.piecewise_mix_prepaired
        d2 = x.index_select(0, a["mix"].long())  # gathered beforehand
        return lambda: fn(x, d2, *pieces(a))

    def k4(x, a, plain=False):
        fn = (mk.pcgmix_plus_fused_prepaired_plain if plain
              else mk.pcgmix_plus_fused_prepaired)
        d2 = x.index_select(0, a["mix"].long())
        return lambda: fn(x, d2, *pieces(a), a["knots"])

    def k1z(x, a, plain=False):  # the concat family's: explicit rows, base 0
        fn = mk.piecewise_mix_pairs_plain if plain else mk.piecewise_mix_pairs
        return lambda: fn(x, a["idx1"], a["idx2"], *pieces(a), base_is_d1=False)

    def k3z(x, a, plain=False):  # on rows gathered by idx1 and idx2, base 0
        fn = mk.piecewise_mix_prepaired_plain if plain else mk.piecewise_mix_prepaired
        d1, d2 = (x.index_select(0, a[k].long()) for k in ("idx1", "idx2"))
        return lambda: fn(d1, d2, *pieces(a), base_is_d1=False)


    def max_err(make, x, a):
        got, ref = make(x, a)(), make(x, a, plain=True)()
        torch.cuda.synchronize()
        return (got.float() - ref.float()).abs().max().item(), got, ref

    def measure(name, geometry, make, x, a, tol, idx_bytes, row_reads, warp, extra=None,
                zero_base=False):
        """Hold ``make``'s kernel against its plain version on rows ``x``
        (fp32 with plan ``a`` and with ``extra`` if given; bf16 with ``a``),
        time both with the bursts, and return the report with the bound.
        ``idx_bytes``: bytes of row indices per output row; ``row_reads``:
        row buffers read (K3/K4 read the partner rows from their own); with
        ``zero_base`` no base row is read, only the source steps of the
        pieces."""
        n, c, t = x.shape
        n_out = a["dst"].shape[0]  # lc-nointrusion: 4n candidate rows
        errs = [max_err(make, x, p)[0] for p in (a, extra) if p is not None]
        _, got16, ref16 = max_err(make, x.bfloat16(), a)
        n_diff16 = int((got16 != ref16).sum().item())
        if not warp:
            bf16_ok = n_diff16 == 0
        else:  # one bf16 ulp: 2^-7 relative to the larger magnitude
            ulp = torch.maximum(got16.float().abs(), ref16.float().abs()) * 2.0 ** -7
            bf16_ok = bool(((got16.float() - ref16.float()).abs() <= ulp).all())
        shape = "x".join(map(str, x.shape)) + (f"->{n_out}" if n_out != n else "")
        label = f"{name} {geometry} {shape}"
        print(f"{label}: max_abs_err {str(x.dtype).replace('torch.', '')} "
              f"{', '.join(f'{e:.3e}' for e in errs)} (tol {tol:g}); bf16 "
              f"{'ok' if bf16_ok else 'MISMATCH'}, {n_diff16} of {got16.numel()} "
              f"elements differ from the plain version")
        if not (max(errs) <= tol and bf16_ok):
            raise AssertionError(f"{label} disagrees with its plain version")
        ms = device_time_ms(torch, make(x, a))
        plain_ms = device_time_ms(torch, make(x, a, plain=True))
        # bytes the function must move: each row buffer read once (with a
        # zero base only the steps the pieces read), the output written
        # once, the row indices and the five piece arrays (and the warp's
        # knots and basis) read once
        K, es = a["dst"].shape[1], x.element_size()  # es: 2 for a bf16 latent
        reads = (source_steps(np, a, t, row_reads == 2) * c * es if zero_base
                 else row_reads * x.numel() * es)
        nbytes = reads + n_out * c * t * es + idx_bytes * n_out + n_out * K * 5 * 4
        nflops = 4 * int(a["len"].sum().item()) * c
        if warp:  # K2/K4 (n_out = n)
            k2n = a["knots"].shape[1]
            nbytes += a["knots"].numel() * 4 + t * k2n * 4
            nflops += (2 * k2n + 1) * x.numel()
        bound_ms = max(nbytes / bw, nflops / flops) * 1e3
        print(f"{label}: kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, bound "
              f"{bound_ms:.6f} ms ({nbytes} B, {100 * bound_ms / ms:.1f} % of it "
              f"reached) on {card}")
        return {"shape": shape, "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": "bytes" if nbytes / bw >= nflops / flops else "operations",
                "library_ms": None}

    pcgmix, pcgmix_plus = plan("durratiomixup"), plan("durmixmagwarp(0.2,4)")
    # the latent plots' geometry (phase 3j): one PCGmix+ batch of
    # LATENT_ROWS rows, 2048 x 4 x 2500
    latent_ds = synthetic_physionet_dict(num_wavs_train=280, num_wavs_test=32,
                                         segments_per_wav=8, sig_len=T, seed=13)
    latent_split = physionet_split(latent_ds, "train").take(np.arange(LATENT_ROWS))
    latent_test = physionet_split(latent_ds, "test")
    x_latent = torch.from_numpy(latent_split.data).to(dev)
    plus_latent = AugmentEngine.device_arrays(AugmentEngine(AugmentConfig(
        "durmixmagwarp(0.2,4)", LATENT_ROWS, C, T)).plan(
            7, latent_split.frames, latent_split.label).arrays, dev)
    # the classical_space path's geometry: the four bands and the wide band,
    # 64 × 5 × 2500, under the plans of a 5-channel engine
    split5 = physionet_split(ds, "train", classical_space=True)
    x5 = torch.from_numpy(split5.data[:B]).to(dev)

    def plan5(method):
        eng = AugmentEngine(AugmentConfig(method, B, 5, T))
        return AugmentEngine.device_arrays(
            eng.plan(7, split5.frames[:B], split5.label[:B]).arrays, dev)

    pcgmix5, pcgmix_plus5 = plan5("durratiomixup"), plan5("durmixmagwarp(0.2,4)")
    # the gang path's geometry: GANG_S members' batches as one (S·B, C, T)
    # batch under their concatenated plans, row indices offset by s·B
    from pcgmix_tpu_torch.train.gang import gang_plan

    g_rows = np.resize(np.arange(len(split)), GANG_S * B)
    xg = torch.from_numpy(split.data[g_rows]).to(dev)

    def gang_plan_of(method):
        arrays = [AugmentEngine(AugmentConfig(method, B, C, T)).plan(
            7, split.frames[g_rows[s * B:(s + 1) * B]],
            split.label[g_rows[s * B:(s + 1) * B]]).arrays for s in range(GANG_S)]
        return AugmentEngine.device_arrays(gang_plan(arrays, B), dev)

    gang_pcgmix, gang_plus = gang_plan_of("durratiomixup"), gang_plan_of("durmixmagwarp(0.2,4)")
    # the live gang's candidate pool: four members' lc-nointrusion pools,
    # 4 × 4B = 1024 rows joined from the 256-row batch (idx1/idx2 offset by s·B)
    gang_pool = gang_plan_of("lc-nointrusion")
    # the spectrogram path's geometry: 64 × (1, 128, 128), the 128
    # frequency rows as channels of K1's (B, C, T) view
    spec_ds = synthetic_spectrogram_dict(num_wavs_train=24, num_wavs_test=8,
                                         segments_per_wav=11, size=SPEC_SIZE, seed=11)
    spec_split = physionet_split(spec_ds, "train", spectrogram=True)
    xs = torch.from_numpy(spec_split.data[:B]).to(dev).reshape(B, SPEC_SIZE, SPEC_SIZE)
    spec_eng = AugmentEngine(AugmentConfig("durratiomixup", B, 1, SPEC_SIZE,
                                           spectrogram=True, spec_freq=SPEC_SIZE))
    pcgmix_2d = AugmentEngine.device_arrays(
        spec_eng.plan(7, spec_split.frames[:B], spec_split.label[:B]).arrays, dev)
    # the concat family's plans, and a full-width ResNet9 latent at depth 2
    # (64 × 512 × 312) under a manifold-cutmix plan reckoned for T = 2500
    concat = {m: plan(m) for m in ("cutmix", "cont-cutmix", "swapsysdia")}
    # the model-in-the-loop joins: lc-nointrusion's pool of 4B = 256
    # candidates from the 64-row batch, saliency-cutmix's 14 pieces from the
    # bins of a random saliency map
    sal = rng.random((B, T)).astype(np.float32)
    live = {"lc-nointrusion": plan("lc-nointrusion"),
            "saliency-cutmix": plan("saliency-cutmix",
                                    saliency_bins_fn=lambda: bin_training_saliency(sal, frames))}
    manifold = plan("manifold-cutmix")
    with torch.no_grad():
        latent = build_model("resnet9", 2, C, T).to(dev).eval()(x32, depth=2, part="first")
        # the same latent of the bf16 compute mode (phase 3h's path), bf16 rows
        latent16 = build_model("resnet9", 2, C, T, compute_dtype="bfloat16").to(
            dev).eval()(x32, depth=2, part="first")
    if latent16.dtype != torch.bfloat16:
        raise AssertionError(f"the bf16 model's latent is {latent16.dtype}")
    past = int(((manifold["dst"] + manifold["len"] > latent.shape[-1])
                & (manifold["len"] > 0)).sum())
    print(f"manifold-cutmix on a latent {tuple(latent.shape)}: {past} of "
          f"{manifold['len'].numel()} pieces run past its end")
    if not past:
        raise AssertionError("the manifold-cutmix geometry has no piece past the latent")
    # the zoo's full-length latent: FCN at depth 2, 64 × 256 × 2500 (164 MB
    # in fp32), under a manifold-cutmix plan of an FCN engine
    fcn_manifold = AugmentEngine.device_arrays(AugmentEngine(AugmentConfig(
        "manifold-cutmix", B, C, T, model="FCN")).plan(7, frames, labels).arrays, dev)
    with torch.no_grad():
        fcn_latent = build_model("FCN", 2, C, T).to(dev).eval()(x32, depth=2, part="first")
    # (name, geometry) -> report, and the closure phase 5 profiles
    report, profiled_closures = {}, {}
    # name, wrapper, geometry, rows, plan, fp32 tolerance, idx_bytes,
    # row_reads, warp, a second fp32 plan, zero base
    for name, make, geometry, x, a, tol, idx_bytes, row_reads, warp, extra, zero in (
        ("piecewise_mix_pairs", k1, "main", x32, pcgmix, 1e-6, 4, 1, False, k27, False),
        ("pcgmix_plus_fused", k2, "main", x32, pcgmix_plus, 1e-5, 4, 1, True, k27, False),
        ("piecewise_mix_prepaired", k3, "main", x32, pcgmix, 1e-6, 0, 2, False, k27, False),
        ("pcgmix_plus_fused_prepaired", k4, "main", x32, pcgmix_plus, 1e-5, 0, 2, True, k27,
         False),
        ("pcgmix_plus_fused", k2, "latent-plots", x_latent, plus_latent, 1e-5, 4, 1, True,
         None, False),
        ("piecewise_mix_pairs", k1, "classical", x5, pcgmix5, 1e-6, 4, 1, False, None, False),
        ("pcgmix_plus_fused", k2, "classical", x5, pcgmix_plus5, 1e-5, 4, 1, True, None,
         False),
        ("piecewise_mix_pairs", k1, "gang", xg, gang_pcgmix, 1e-6, 4, 1, False, None, False),
        ("pcgmix_plus_fused", k2, "gang", xg, gang_plus, 1e-5, 4, 1, True, None, False),
        ("piecewise_mix_pairs", k1z, "gang-pool", xg, gang_pool, 1e-6, 8, 1, False, None,
         True),
        ("piecewise_mix_pairs", k1, "spec2d", xs, pcgmix_2d, 1e-6, 4, 1, False, None, False),
        ("piecewise_mix_prepaired", k3, "spec2d", xs, pcgmix_2d, 1e-6, 0, 2, False, None,
         False),
        *[("piecewise_mix_pairs", k1z, m, x32, concat[m], 1e-6, 8, 1, False, None, True)
          for m in concat],
        ("piecewise_mix_prepaired", k3z, "cutmix", x32, concat["cutmix"], 1e-6, 0, 2, False,
         None, True),
        ("piecewise_mix_pairs", k1z, "manifold-cutmix", latent, manifold, 1e-6, 8, 1, False,
         None, True),
        ("piecewise_mix_pairs", k1z, "fcn-latent", fcn_latent, fcn_manifold, 1e-6, 8, 1,
         False, None, True),
        # bf16 rows: the check is bit-equality (tolerance 0)
        ("piecewise_mix_pairs", k1z, "bf16-latent", latent16, manifold, 0.0, 8, 1, False,
         None, True),
        ("piecewise_mix_prepaired", k3z, "bf16-latent", latent16, manifold, 0.0, 0, 2, False,
         None, True),
        *[("piecewise_mix_pairs", k1z, m, x32, live[m], 1e-6, 8, 1, False, None, True)
          for m in live],
    ):
        report[name, geometry] = measure(name, geometry, make, x, a, tol, idx_bytes,
                                         row_reads, warp, extra, zero)
        profiled_closures[name, geometry] = make(x, a)

    one, copy = torch.zeros(1, device=dev), torch.empty_like(x32)
    floor_ms = device_time_ms(torch, one.zero_)
    copy_ms = device_time_ms(torch, lambda: copy.copy_(x32))
    print(f"launch floor: one-element zero_() {floor_ms:.6f} ms; a copy of the "
          f"batch, K1/K2's bytes ({2 * x32.numel() * 4} B): {copy_ms:.6f} ms on {card}")

    # ---- 2b. K5 against its plain version, then its path: the harness ------
    k5_errs = {}
    for tag, shape in (("small_odd", k5.SMALL_ODD), *k5.SHAPES.items()):
        k5_errs[tag] = k5.check_against_plain(*k5.inputs(*shape, dev))
        print(f"conv3_bn_stats {tag} {shape}: {k5_errs[tag]}")
    torch.cuda.synchronize()
    mk.reset_launch_counts()
    k5_bench = {tag: k5.bench_shape(tag, shape, 5, 20, dev)
                for tag, shape in k5.SHAPES.items()}
    torch.cuda.synchronize()
    k5_launches = mk.launch_counts()["conv3_bn_stats"]
    for tag, b in k5_bench.items():
        a = b["arms"]
        print(f"conv3_bn_stats {tag}: kernel_fused {a['kernel_fused']['ms']:.6f} ms, "
              f"kernel_conv {a['kernel_conv']['ms']:.6f} ms, plain "
              f"{a['plain']['ms']:.6f} ms, cudnn_conv {a['cudnn_conv']['ms']:.6f} ms, "
              f"cudnn_conv_stats {a['cudnn_conv_stats']['ms']:.6f} ms, bound "
              f"{b['bound_ms']:.6f} ms ({b['bound_by']}) on {card}")
    print(f"conv3_bn_stats: {k5_launches} launches on the harness path")
    if k5_launches == 0:
        raise AssertionError("the harness never launched K5")
    stamp("phases 1-2b")

    # ---- 3. the slice end to end -------------------------------------------
    small = synthetic_physionet_dict(num_wavs_train=8, num_wavs_test=4,
                                     segments_per_wav=2, sig_len=512, seed=3)
    for model in ("resnet9-5k", "Potes(noDropout)"):
        for method in ("durmixmagwarp(0.2,4)", "durratiomixup"):
            cfg = dict(model=model, method=method, num_epochs=3, batch_size=8,
                       save_artifacts=False)
            on_card = train_model(TrainConfig(**cfg), small)["train_loss"]
            on_cpu = train_model(TrainConfig(**cfg, device="cpu"), small)["train_loss"]
            diff = float(np.max(np.abs(np.subtract(on_card, on_cpu))))
            print(f"small {model} {method}: card {on_card} cpu {on_cpu} "
                  f"max |diff| {diff:.3e}")
            if not abs(on_card[0] - on_cpu[0]) < 1e-5 or diff > 1e-3:
                raise AssertionError(f"{model} {method}: card and CPU loss traces "
                                     "disagree")

    drive = make_drive(np, torch, mk, card, ds)

    launches, single_losses, train_rates = {}, {}, {}
    for method, kernel in (("durmixmagwarp(0.2,4)", "pcgmix_plus_fused"),
                           ("durratiomixup", "piecewise_mix_pairs")):
        launches[kernel], single_losses[method] = drive(method, kernel, "train")
        train_rates[method] = drive.last[1]
        drive(method, kernel, "train", model="Potes")

    # ---- 3b. latentmixup (the split forward) and the 2-D path ------------
    for model in ("resnet9", "Potes"):
        drive("latentmixup", None, "latent", model=model)
    launches_2d = {}
    for method in ("durratiomixup", "durmixtimemask(0.1)"):
        n, _ = drive(method, "piecewise_mix_pairs", "spec2d", data=spec_ds, dataset=SPEC)
        launches_2d.setdefault("piecewise_mix_pairs", n)

    # ---- 3c. the cut, the concat family, manifold-cutmix; UMC; multi-cycle --
    launches_concat = {}
    for method in ("cutmix", "durratiocutmix", "(smooth)labelcutmix", "swapsysdia",
                   "cont-cutmix", "manifold-cutmix"):
        n, _ = drive(method, "piecewise_mix_pairs", "concat")
        launches_concat["piecewise_mix_pairs", method] = n
    umc_ds = synthetic_umc_dict(segments_per_patient=4, sig_len=UMC_LEN, seed=11)
    for method in ("(UMC-subset)durratiocutmix", "durratiomixup"):
        drive(method, "piecewise_mix_pairs", "umc", data=umc_ds, sig_len=UMC_LEN,
              dataset="UMC", seed_data=1)
    full_ds = synthetic_physionet_full_dict(num_wavs_train=66, num_wavs_test=12,
                                            windows_per_wav=4, sig_len=T, seed=11)
    for method, kernel in (("durratiomixup", "piecewise_mix_pairs"),
                           ("durmixmagwarp(0.2,4)", "pcgmix_plus_fused")):
        drive(method, kernel, "multi-cycle", data=full_ds)

    # ---- 3d. the model zoo: every distinct architecture at its width -------
    t_zoo = time.time()
    for name in ZOO:
        n_params = count_parameters(build_model(name, 2, C, T))
        print(f"zoo {name}: {n_params} parameters (JAX package {JAX_PARAM_COUNTS[name]})")
        if n_params != JAX_PARAM_COUNTS[name]:
            raise AssertionError(f"zoo {name}: the parameter counts differ")
        runs = [("durmixmagwarp(0.2,4)", "pcgmix_plus_fused")]
        if name in ZOO_SPLIT:  # PCGmix, K1 on a latent, and latentmixup (no kernel)
            runs += [("durratiomixup", "piecewise_mix_pairs"),
                     ("manifold-cutmix", "piecewise_mix_pairs"), ("latentmixup", None)]
        for method, kernel in runs:
            n, _ = drive(method, kernel, f"zoo {name}", model=name, epochs=ZOO_EPOCHS)
            if name == "FCN" and method == "manifold-cutmix":
                launches_concat["piecewise_mix_pairs", "fcn-latent"] = n
    for alias in ZOO_ALIASES:  # each alias builds and runs one forward
        with torch.no_grad():
            out = build_model(alias, 2, C, T).to(dev).eval()(x32[:8])
        if out.shape != (8, 2) or not torch.isfinite(out).all():
            raise AssertionError(f"zoo alias {alias}: output {tuple(out.shape)}")
        print(f"zoo alias {alias}: one forward, logits {tuple(out.shape)}, finite")
    print(f"zoo phase: {len(ZOO)} architectures, {time.time() - t_zoo:.3f} s wall on {card}")
    stamp("phases 3-3d")

    # ---- 3e. the model in the loop -----------------------------------------
    t0 = time.time()
    native.build_library()
    build_s, disagree = time.time() - t0, 0
    for _ in range(200):
        n1 = int(rng.integers(20, 1200))
        s1, s2 = rng.random(n1), rng.random(int(rng.integers(1, n1)))
        disagree += native.opt_disp_env(s1, s2) != native.opt_disp_env_plain(s1, s2)
    print(f"native opt_disp_env: built in {build_s:.3f} s; {disagree} of 200 random windows "
          f"disagree with the NumPy scan")
    if disagree:
        raise AssertionError("the native displacement scan disagrees with its plain version")
    frozen_cpu = seeded_init(build_model("resnet9", 2, C, T), 4)
    onehot = torch.from_numpy(np.eye(2, dtype=np.float32)[labels])
    maps = {}  # (what, device, dtype) -> maps
    for dtype in (torch.float64, torch.float32):
        for where in (dev, torch.device("cpu")):
            model = build_model("resnet9", 2, C, T).to(where, dtype)
            model.load_state_dict(frozen_cpu.state_dict())
            x, y = x32.to(where, dtype), onehot.to(where, dtype)
            maps["pretrained", where.type, dtype] = saliency_maps(model, x, y, frames)
            maps["live", where.type, dtype] = training_saliency_raw(
                model, x, y, frames[:, -1]).cpu().numpy()
    f64 = torch.float64

    def diff(what, a, b):
        return float(np.abs(maps[(what, *a)] - maps[(what, *b)]).max())

    errs = {w: diff(w, ("cuda", f64), ("cpu", f64)) for w in ("pretrained", "live")}
    print(f"saliency of frozen full-width ResNet9 weights, {B}x{C}x{T}, float64 gradients: "
          f"card against CPU max |diff| {errs['pretrained']:.3e} (pretrained maps, n=101), "
          f"{errs['live']:.3e} (live map, n=57); bar {SALIENCY_BAR:g}, on {card}")
    f32 = {(w, where): diff(w, (where, torch.float32), ("cpu", f64))
           for w in ("pretrained", "live") for where in ("cuda", "cpu")}
    print(f"saliency in float32 against the float64 maps: card {f32['pretrained', 'cuda']:.3e}"
          f" / {f32['live', 'cuda']:.3e}, CPU {f32['pretrained', 'cpu']:.3e} / "
          f"{f32['live', 'cpu']:.3e} (pretrained / live), on {card}")
    if max(errs.values()) > SALIENCY_BAR:
        raise AssertionError("saliency maps on the card disagree with the CPU's")
    del frozen_cpu, model
    for method in ("lc-nointrusion", "saliency-cutmix"):
        n, _ = drive(method, "piecewise_mix_pairs", "model-in-the-loop")
        launches_concat["piecewise_mix_pairs", method] = n
    stamp("phases 2-3e")

    # ---- 3f. the runtime extras -----------------------------------------
    graph_launches = runtime_phase(np, torch, card, mk)
    stamp("phase 3f")

    # ---- 3g. gang training ------------------------------------------------
    # the runner's calls, four at a time in the background beside the
    # frozen gangs (phase 3g waits for them before it takes a rate): phase
    # 3e's runner part, whose runs stay for phases 3g's and 4's (salopt…)
    # and (closestknn…) runs (the pretrained base run and the canonical
    # embedder), phase 3g's own, and the grids of phases 4b and 4c
    deps_dir, slots = tempfile.mkdtemp(prefix="chip_smoke_deps_"), threading.Semaphore(4)
    deps_job, deps = Background(dependency_phase, np, card, keep=deps_dir, slots=slots), {}
    runners = [
        Background(gang_runner_check, card, ds, slots=slots),
        Background(salopt_runner_check, card, ds, slots=slots),
        Background(grid_phase, np, card, sig_len=SPEC_SIZE, dataset=SPEC,
                   methods=GRID_METHODS_2D, slots=slots),
        Background(grid_phase, np, card, slots=slots),
        Background(grid_phase, np, card, sig_len=UMC_LEN, dataset="UMC",
                   methods=GRID_METHODS_UMC, segments=1, seed_data=1, slots=slots)]

    def get_deps():
        if not deps:
            base_dir = next(d for d in deps_job.join() if os.path.basename(d).split("_")[1:3]
                            == ["resnet9", "base"])
            deps.update(root=os.path.join(deps_dir, "experiments"), base_dir=base_dir,
                        provider=make_pretrained_saliency_fn(TrainConfig(model="resnet9"),
                                                             lambda method: base_dir))
        return deps

    gang_launches, gang_profiled = gang_phase(np, torch, card, mk, get_deps, runners)
    launches_concat.update(gang_launches)
    stamp("phase 3g")

    # ---- 3h. the bf16 compute mode ------------------------------------------
    bf16_launches, bf16_profiled = bf16_phase(np, torch, card, mk, drive, ds, spec_ds)
    launches_concat["piecewise_mix_pairs", "bf16-latent"] = bf16_launches.pop("bf16-latent")
    stamp("phase 3h")

    # ---- 3i. the offline builder on the card; classical_space -----------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_classical_") as tmp:
        t0 = time.time()
        dats = build_phase(np, card, tmp)
        print(f"build phase: {time.time() - t0:.3f} s wall on {card}")
        # the classical CLI's fresh run extracts on the host meanwhile
        t0 = time.time()
        fresh = _classical_cli(["--dataset-file", dats["physionet-1d"], "--out-dir",
                                os.path.join(tmp, "cli_fresh")])
        # and the classical_space runner's two calls
        runner = Background(classical_runner_check, card, dats, tmp)
        try:
            for name, n in classical_phase(np, torch, card, drive, ds,
                                           train_rates["durmixmagwarp(0.2,4)"], dats,
                                           tmp).items():
                launches_concat[name, "classical"] = n
            plot_run = plot_phase(np, torch, card, mk, ds, tmp)

            # ---- 3j. the latent-space plots and the loss mixture, from the
            # last plot run's model, beside the CLI's three resume calls
            def latent_plots():
                n = latent_phase(np, torch, card, mk, plot_run, latent_split, latent_test,
                                 os.path.join(tmp, "latent_plots"))["pcgmix_plus_fused"]
                launches_concat["pcgmix_plus_fused", "latent-plots"] = n
                stamp("phase 3j (beside phase 3i's resume calls)")

            classical_cli_phase(np, card, fresh, dats["physionet-1d"], tmp, beside=latent_plots)
            runner.join()
        finally:
            if fresh.poll() is None:
                fresh.kill()
                fresh.communicate()
        print(f"collectors, classical CLI and plots: {time.time() - t0:.3f} s wall on {card}")
    stamp("phase 3i")

    # host work of a Potes step that the card waits on: the plan, and the
    # dropout masks drawn on the CPU generator and queued for the card
    def host_ms(fn, n=16):
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3

    potes = build_model("Potes", 2, C, T).to(dev).train()
    branch_out = torch.zeros(B, C, 4, potes_features(T), device=dev)
    plan_ms = host_ms(lambda: AugmentEngine(AugmentConfig(
        "durmixmagwarp(0.2,4)", B, C, T)).plan(7, frames, labels))
    drop_ms = host_ms(lambda: potes._drop(branch_out, potes.dropout))
    torch.cuda.synchronize()
    print(f"Potes host work per step: PCGmix+ plan {plan_ms:.3f} ms, branch dropout "
          f"masks ({branch_out.numel()} values) {drop_ms:.3f} ms on {card}")

    # where a PCGmix+ step's device time goes (informational: the profiler's
    # CUDA tracing is the only source, and an empty trace fails nothing)
    profiled = TrainConfig(model="resnet9", method="durmixmagwarp(0.2,4)", num_epochs=2,
                           batch_size=B, num_channels=C, save_artifacts=False)
    profile_breakdown(torch, lambda: train_model(profiled, ds), card)
    profile_breakdown(
        torch, lambda: train_model(dataclasses.replace(profiled, steps_per_dispatch=RT_K),
                                   ds), card, label="profile graph")
    profile_breakdown(torch, bf16_profiled, card, label="profile bf16")
    profile_breakdown(
        torch, lambda: train_model(dataclasses.replace(profiled, model="Potes"), ds),
        card, label="profile Potes")
    profile_breakdown(
        torch, lambda: train_model(dataclasses.replace(
            profiled, dataset=SPEC, method="durratiomixup"), spec_ds),
        card, label="profile spec2d")
    for model, run in gang_profiled.items():  # a gang of GANG_S, 2 epochs
        profile_breakdown(torch, run, card, label=f"profile gang {model}")
    for name in ZOO_PROFILED:  # the zoo's slowest convolutional families
        profile_breakdown(
            torch, lambda: train_model(dataclasses.replace(
                profiled, model=name, num_epochs=ZOO_EPOCHS), ds),
            card, label=f"profile zoo {name}")
    stamp("the profiles")

    # ---- 4. the data-parallel route (1-rank NCCL group) -------------------
    # Full-width training at lr 0.01 is chaotic on this data: the single-
    # device route drifts from itself (cuDNN's default algorithms are not
    # deterministic) past 1e-3 relative within a few steps.  So the route's
    # loss is held where it is defined: (a) the same 16-step runs with the
    # weights frozen (lr_max=0): the same batches, plans, mix kernels and
    # BatchNorm, every plot epoch within 1e-5; (b) the same 16-step lr
    # schedule at one step per epoch (74 train rows), whose plot epochs 1,
    # 2 and 4 are steps 0, 1 and 3: step 0 within 1e-5, step 1 within 1e-3
    # relative, step 3 printed beside the single-device route's spread.
    import torch.distributed as dist

    ds_steps = synthetic_physionet_dict(num_wavs_train=10, num_wavs_test=4,
                                        segments_per_wav=8, sig_len=T, seed=11)

    def first_steps(method):
        cfg = TrainConfig(model="resnet9", method=method, num_epochs=MAIN_STEPS,
                          batch_size=B, num_channels=C, save_artifacts=False)
        return np.asarray(train_model(cfg, ds_steps)["train_loss"][:3])

    pairs = (("durmixmagwarp(0.2,4)", "pcgmix_plus_fused", "pcgmix_plus_fused_prepaired"),
             ("durratiomixup", "piecewise_mix_pairs", "piecewise_mix_prepaired"))
    ref = {}
    for method, kernel, _ in pairs:
        _, ref[method, "frozen"] = drive(method, kernel, "frozen", lr_max=0.0)
        ref[method, "steps"], ref[method, "again"] = first_steps(method), first_steps(method)
    # the keep-duration cut (base d1) and a concat join (base 0): K3 on the
    # rows a rank's block names, held with the weights frozen
    cuts = ("cutmix", "durratiocutmix")
    for method in cuts:
        _, ref[method, "frozen"] = drive(method, "piecewise_mix_pairs", "frozen", lr_max=0.0)
    # a zoo model on this route: ResCNN's BatchNorm takes global statistics
    _, ref["ResCNN", "frozen"] = drive("durratiomixup", "piecewise_mix_pairs", "frozen",
                                       model="ResCNN", epochs=ZOO_EPOCHS, lr_max=0.0)
    # every other method on this route, held against the single-device route
    # with the weights frozen: (salopt…) on phase 3e's pretrained base run,
    # (closestknn…) on its canonical embedder
    corpora = {"1d": ds, "2d": spec_ds}
    single_methods = dp_method_runs(torch, drive, corpora, deps, "single")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        init_group("nccl", 0, 1, os.path.join(tmp, "store"))
        try:
            for method, _, kernel in pairs:
                launches[kernel], losses = drive(method, kernel, "data-parallel")
                diff = np.abs(np.subtract(losses, single_losses[method]))
                print(f"data-parallel {method}: plot-epoch |diff| to the single-device "
                      f"run at lr 0.01 (chaotic, not held): {diff.tolist()}")
                _, frozen = drive(method, kernel, "data-parallel frozen", lr_max=0.0)
                d_frozen = float(np.max(np.abs(np.subtract(frozen, ref[method, "frozen"]))))
                got, one, again = first_steps(method), ref[method, "steps"], ref[method, "again"]
                d0, r1 = abs(got[0] - one[0]), abs(got[1] - one[1]) / abs(one[1])
                print(f"data-parallel {method}: frozen weights max |diff| {d_frozen:.3e} "
                      f"over {len(frozen)} plot epochs; per step at lr 0.01: step 0 "
                      f"|diff| {d0:.3e}, step 1 relative {r1:.3e}, step 3 relative "
                      f"{abs(got[2] - one[2]) / abs(one[2]):.3e} (single-device route "
                      f"against itself: {np.abs(again - one) / np.abs(one)})")
                if not (d_frozen < 1e-5 and d0 < 1e-5 and r1 < 1e-3):
                    raise AssertionError(f"data-parallel {method}: loss differs from "
                                         "the single-device route")
            for method in cuts:
                n, _ = drive(method, "piecewise_mix_prepaired", "data-parallel")
                launches_concat["piecewise_mix_prepaired", method] = n
                _, frozen = drive(method, "piecewise_mix_prepaired", "data-parallel frozen",
                                  lr_max=0.0)
                d_frozen = float(np.max(np.abs(np.subtract(frozen, ref[method, "frozen"]))))
                print(f"data-parallel {method}: frozen weights max |diff| {d_frozen:.3e} "
                      f"over {len(frozen)} plot epochs")
                if not d_frozen < 1e-5:
                    raise AssertionError(f"data-parallel {method}: loss differs from the "
                                         "single-device route")
            drive("durratiomixup", "piecewise_mix_prepaired", "data-parallel zoo",
                  model="ResCNN", epochs=ZOO_EPOCHS)
            _, frozen = drive("durratiomixup", "piecewise_mix_prepaired",
                              "data-parallel zoo frozen", model="ResCNN", epochs=ZOO_EPOCHS,
                              lr_max=0.0)
            d_frozen = float(np.max(np.abs(np.subtract(frozen, ref["ResCNN", "frozen"]))))
            print(f"data-parallel ResCNN durratiomixup: frozen weights max |diff| "
                  f"{d_frozen:.3e} over {len(frozen)} plot epochs")
            if not d_frozen < 1e-5:
                raise AssertionError("data-parallel ResCNN: loss differs from the "
                                     "single-device route")
            # K3 on the bf16 latent's rows that idx1 and idx2 name, as the JAX
            # package's mesh route mixes a latent (manifold-cutmix in bf16
            # below trains through it)
            torch.cuda.synchronize()
            mk.reset_launch_counts()
            k3_latent = k3z(latent16, manifold)()
            torch.cuda.synchronize()
            n_k3 = mk.launch_counts()["piecewise_mix_prepaired"]
            same = torch.equal(k3_latent, k1z(latent16, manifold, plain=True)())
            print(f"data-parallel bf16 latent {tuple(latent16.shape)}: K3 launches {n_k3}, "
                  f"bit-equal to K1's plain version: {same}, on {card}")
            if n_k3 != 1 or not same:
                raise AssertionError("K3 on the bf16 latent differs from K1's plain version")
            launches_concat["piecewise_mix_prepaired", "bf16-latent"] = n_k3
            # the spectrogram path's PCGmix splits its batch too: K3
            launches_2d["piecewise_mix_prepaired"], _ = drive(
                "durratiomixup", "piecewise_mix_prepaired", "data-parallel spec2d",
                data=spec_ds, dataset=SPEC)
            # every other method on this route (baselines, mixup, the masks,
            # the latent methods, the model in the loop)
            launches_dp = dp_methods_check(
                np, card, single_methods, dp_method_runs(torch, drive, corpora, deps,
                                                         "data-parallel"))
            # phase 3f on this route: the step with its collectives in a graph
            graph_launches.update(runtime_dp_phase(np, torch, card, mk))
            # the same profiled PCGmix+ call as phase 3, on this route
            profile_breakdown(torch, lambda: train_model(profiled, ds), card,
                              label="profile data-parallel")
        finally:
            dist.destroy_process_group()
    shutil.rmtree(deps_dir)
    stamp("phase 4")
    # (4b–4c, the grids, ran in the background during phase 3g)

    # ---- 5. the profiler's kernel time of K1–K4, then the summary ----------
    # taken last: the profiler's sessions leave host overhead behind them,
    # which the host-bound runs of phases 3–4 would read
    # each closure launches one mix_warp_kernel a call: a trace with another
    # count of its events is not read (null in the kernels line)
    for (name, geometry), fn in profiled_closures.items():
        r = report[name, geometry]
        r["kernel_us"], events = k5.kernel_reading(k5.kernel_times(fn, 60), "mix_warp_kernel",
                                                   60)
        share = ("the profiler's share not measured" if r["kernel_us"] is None else
                 f"{100 * r['bound_ms'] * 1e3 / r['kernel_us']:.1f} % of it reached by the "
                 "profiler's time")
        print(f"{name} {geometry} {r['shape']}: "
              f"{k5.reading_text(r['kernel_us'], events, 60)} by the profiler over 60 "
              f"calls, {r['ms']:.6f} ms by the bursts; bound {r['bound_ms']:.6f} ms: "
              f"{share}, {100 * r['bound_ms'] / r['ms']:.1f} % by the bursts', on {card}")
    replaces = {"piecewise_mix_pairs": "pcgmix_tpu/ops/pallas_mix.py:74",
                "pcgmix_plus_fused": "pcgmix_tpu/ops/pallas_mix.py:241",
                "piecewise_mix_prepaired": "pcgmix_tpu/ops/pallas_mix.py:146",
                "pcgmix_plus_fused_prepaired": "pcgmix_tpu/ops/pallas_mix.py:288"}
    kernels = [
        {"name": name, "route": "cuda",
         "source": "pcgmix_tpu_torch/ops/csrc/mix_kernels.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "kernel_us": r["kernel_us"],
         "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
         "floor_ms": floor_ms, "graph_launches": graph_launches.get(name)}
        for (name, geometry), r in report.items() if geometry == "main"
    ]
    # the bf16 compute mode's launches of K1/K2 (phase 3h): 16-step eager
    # runs, and the graph of 8 steps (replays counted)
    for k in kernels:
        if k["name"] in bf16_launches:
            k["bf16_launches"] = bf16_launches[k["name"]]
            k["bf16_graph_launches"] = bf16_launches["graph", k["name"]]
    # K1 and K3 on the spectrogram path and at the concat family's
    # geometries, each in a field of its own: their launches in the 16-step
    # runs of those paths (single-device, data-parallel; K3's bf16 latent:
    # the call in the 1-rank group of phase 4)
    for k in kernels:
        for (name, geometry), r in report.items():
            if name != k["name"] or geometry == "main":
                continue
            n = (launches_2d[name] if geometry == "spec2d"
                 else launches_concat.get((name, geometry), 0))
            k[geometry] = {**r, "launches": n}
    # K1/K2 in phase 3g's model-in-the-loop gangs of 4 (8 gang steps each;
    # lc-nointrusion's pool stands under its own geometry, gang-pool)
    for k in kernels:
        runs = {g[len("gang "):]: n for (name, g), n in launches_concat.items()
                if name == k["name"] and g.startswith("gang ")}
        if runs:
            k["gang_model_in_the_loop"] = runs
    # K3/K4 on phase 4's methods: their launches in each 12-step
    # data-parallel run (lc-nointrusion: twice a step)
    for k in kernels:
        runs = {m: n for (name, m), n in launches_dp.items() if name == k["name"]}
        if runs:
            k["data_parallel_methods"] = runs
    # K5 at res2a, conv3 in a field of its own: ms is K5 without stats and
    # library_ms cuDNN's conv, the same function; the fused kernel stands
    # beside cuDNN's conv plus its statistics pass
    def k5_times(b):
        a = b["arms"]
        conv, fused = a["kernel_conv"]["ms"], a["kernel_fused"]["ms"]
        return {"ms": conv, "plain_ms": a["plain"]["ms"], "bound_ms": b["bound_ms"],
                "bound_by": b["bound_by"], "library_ms": a["cudnn_conv"]["ms"],
                "kernel_fused_ms": fused, "cudnn_conv_stats_ms": a["cudnn_conv_stats"]["ms"],
                "tflops": b["flop"] / conv / 1e9, "fused_tflops": b["flop"] / fused / 1e9,
                "bound_share": b["bound_ms"] / conv, "fused_bound_share": b["bound_ms"] / fused}

    kernels.append({
        "name": "conv3_bn_stats", "route": "cuda",
        "source": "pcgmix_tpu_torch/ops/csrc/conv_bn_stats.cu",
        "replaces": "scripts/bench_conv_bn_fused.py:97", "launches": k5_launches,
        "max_abs_err": max(e["y_max_abs_err"] for e in k5_errs.values()),
        "shape": "res2a 64x312x512->512", **k5_times(k5_bench["res2a"]),
        "conv3": {"shape": "64x1250x128->256", **k5_times(k5_bench["conv3"])}})
    stamp("phase 5")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        for child in list(_CHILDREN):  # a failed phase leaves no process running
            if child.poll() is None:
                child.kill()
                child.wait()
    sys.exit(code)
