#!/usr/bin/env python3
"""Drives the PyTorch port (kdip_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the checkout, holds each against its
plain PyTorch version on the card, runs the slice's main path through
`sampling_api.build_posterior_sampler` at the full width of the FFHQ-256
ADM UNet (random weights from a seed), and checks what comes out. Phases,
each printing one JSON line:

1. device and build: the card, versions, the nvcc build (parallel, one
   nvcc per source) with ptxas's register report;
2. kernels: the Haar DWT kernel against its plain version at
   [4, 3, 256, 256] float32, levels 1-3: forward, inverse, round trip, and
   the autograd backward; and its fused CG matvec (s2*v + mask *
   idwt2(theta * dwt2(v))) at [4, 3, 256, 256] and [1, 3, 256, 256],
   levels 1-3, with and without the mask, theta and the mask per sample
   and repeating over the batch, with the bit-equal share; and the DWT
   past the kernel's three levels (chained passes on the approximation
   block) at [1, 3, 256, 256], levels 4-8, forward, inverse and round
   trip, and the chained matvec at level 5 with and without the mask;
3. slice, DWT-Var: ADMUNetV2 (bf16 torso, params pre-cast), p=0.5
   inpainting (configs/inpainting_config.yaml), Type-I guidance with the
   learned DWT covariance, mle threshold 1.0 (the CLI's --v2 default),
   50-step Heun with churn, N_SAMPLES (2) samples against one
   measurement; the DWT launch counts are reset just before and read just
   after, and the fused matvec's must be the CG iterations plus one per
   CG solve;
3a. slice_dwt_var_batched: the same seeds with per_sample_map=False and
   BATCHED_N (4) samples, as one batch through the UNet, the vjp and one
   CG solve per guided call; its ms/NFE beside the per-sample twin's; the
   fused matvec's launches are again the CG iterations plus one per solve;
4. one guided NFE below the threshold, with the kernel DWT and with the
   plain DWT, compared; the kernel run is traced with torch.profiler for
   the device's busy share and its top kernels;
4a. slice_autoI_dwt_var: the same model with autoI guidance (the CLI's
   --v2 --guidance autoI, 8 Hutchinson probes), Heun-50 with churn,
   n=AUTOI_N: every guided call launches the standalone forward DWT 1 + 8
   times and the inverse 8 times, and below the threshold the fused
   no-mask matvec once a CG iteration and once a solve (1 + 8 solves a
   call), counted exactly against the calls recorded as they run; then
   nfe_autoI (one
   autoI NFE below the threshold, kernel DWT against plain DWT on the
   same probes, the kernel run traced) and nfe_loglikelihood
   (`denoise.loglikelihood`, 8 probes of 25 Lanczos steps, kernel
   against plain);
5. slice, Convert: the V1 ADMUNet, Type-I guidance with the Convert
   covariance, the same sampler; 5a. slice_convert_batched, its batched
   twin (per_sample_map=False);
6. kernels_winograd: both entry points of the Winograd F(2,3) kernel
   against its plain version in bf16, with and without the fused
   prologue, at [1,128,256,256]->128, [1,1024,8,8]->512, a C and F that
   are not multiples of 16, B=2, and shapes that reach every launch
   configuration, and through autograd (dx, da, db);
7. slice, Convert with the Winograd torso (`--winograd`): the V1 ADMUNet
   built by `config.make_openai_model` from configs/test_ffhq.json with
   winograd=True, the same guidance and sampler; the Winograd launch counts
   are reset just before and read just after, and must be 65 plain + 55
   fused per guided NFE;
8. one guided NFE below Convert's threshold three ways on the same
   weights: the kernels, their plain versions, and the direct cuDNN torso,
   compared; the kernel run is traced for the device's busy share, its
   time by kind and the Winograd kernels' device time;
9. winograd_shapes: every distinct Winograd launch of one guided NFE
   (the UNet forward and its vjp, recorded from the model as it runs), at
   its own shape: the kernel against its plain version, its device time
   beside cuDNN's direct conv (one torch.profiler trace for all shapes)
   and the bound; then a line that sums them per level (H) and per NFE;
10. slices on the other operators of bench.py's grid, each Heun-50 with
   churn, n=BLUR_SR_N samples against one measurement, operators from
   configs/
   (read by `config.load_yaml`, as every operator file here):
   gaussian deblur with Convert (no DWT or Winograd launch), the same
   with the CG warm start (`cg_warm_start`; its CG iterations and ms/NFE
   beside the cold slice's), motion deblur with Convert (the PSF loaded
   from kdip_tpu_torch/data, as the card has no PIL), 4x super-resolution
   with Convert (y is [1, 3, 64, 64]), gaussian deblur with tmpd (a CG
   solve at every NFE; n=1), and gaussian deblur with
   DWT-Var (the fused matvec's no-mask mode, its launches the CG
   iterations plus one per solve);
11. one tmpd and one DWT-Var gaussian-deblur guided NFE, each traced: its
   device time by kind (the FFTs are cuFFT's), the idle share and the CG
   iterations; and tmpd's variance at a few sigmas: its range and the
   share of it below 0 (the Jacobian's column sums need not be positive);
12. slice_typeII_dwt_var: the DWT-Var model with Type-II guidance, Heun-50
   with churn, n=TYPE_II_DCT_N; its step W^-1(W mat * theta) is one fused
   no-mask matvec at each guided call below the threshold, so the no-mask
   launches
   must equal those calls and the masked ones the CG iterations plus one
   per solve; slice_dct_var: the DCT-Var configuration
   (configs/test_ffhq_dct.json under --v2, Type-I, threshold 1.0), no DWT
   launch;
13. the baselines of quick_start/ on the V1 UNet and inpainting, n=1, as
   their scripts run them: slice_pgdm (--ode), slice_dps (zeta 1, --ode),
   slice_diffpir (lambda 1) and slice_analytic_I (Type-I analytic, --ode,
   a synthetic recon_mse table): closed-form solves, no CG, no DWT;
14. nfe_stsl: one traced stsl NFE (2 Hutchinson probes, 3 UNet forwards
   and their backward), and one pgdm+mle NFE on each side of its
   threshold, each with its device busy share and peak memory;
15. the nonlinear operators with dps (zeta 1, n=1, no CG, no DWT):
   slice_phase_retrieval_dps (Euler-50, oversample 1.0: 320 px FFTs) and
   slice_nonlinear_blur_dps (DPM++(2M)-25, poisson noise on y, a small
   seeded blur network built here);
16. the guided-sampling CLI (`kdip_tpu_torch.cli.sample_condition.main`,
   in-process, at full width, Heun-50, -n 1, bf16, --save-img, LPIPS on
   seeded random VGG16 weights in kdip_tpu's npz), on inpainting from
   configs/inpainting_config.yaml, over seeded 256 px PNGs written by the
   port's writer, with a checkpoint of seeded random weights:
   cli_dwt_var (configs/test_ffhq_dwt.json --v2, a Lightning .ckpt, 2
   images; the fused matvec's launches the CG iterations plus one per
   solve, no standalone DWT) and cli_convert_winograd
   (configs/test_ffhq.json --winograd, a guided-diffusion .pt, 1 image;
   65 plain + 55 fused Winograd launches per NFE). Each checks finite
   metrics, samples in [-1, 1] and the CG summary line, then reruns with
   --resume, which must run no image and reproduce avg_metrics' psnr,
   ssim and lpips bit for bit; it reports the wall time per image, peak
   memory and LPIPS's time per image;
17. bench_torch: `python3 bench_torch.py` (the default workload) as a
   subprocess, its JSON line with bench.py's keys;
18. uncond_cli: the unconditional-sampling CLI
   (`kdip_tpu_torch.cli.sample_uncond.main`, in-process) at full width
   (configs/test_ffhq.json, a guided-diffusion .pt of seeded random
   weights), -n 2, bf16, once per sampler: heun, euler, dpmpp_2m,
   dpmpp_sde, lms and dpm_2 at --steps 10, ancestral --respacing 25, ddim
   --respacing ddim25 with eta 0 and 0.5; each run's s per sample, NFEs
   (counted by a forward hook, held to the sampler's count), ms/NFE, peak
   memory, its two PNGs read back by `data.read_png` at 256x256x3 and
   equal to the samples, no DWT or Winograd launch; heun again with the
   same seed, bit-equal; dpmpp_sde's Brownian tree queries and host ms;
19. samplers_rest: the samplers no CLI flag reaches, through the same
   full-width discrete eps denoiser, n=2, 10 steps: euler_ancestral,
   dpm_2_ancestral, dpmpp_2s_ancestral, dpmpp_2m_sde (midpoint, heun),
   dpm_fast (10 calls) and dpm_adaptive (default tolerances, failing past
   ADAPTIVE_NFE_BUDGET calls); then log_likelihood (4 RK4 steps, 16 fevals
   with a vjp) and log_likelihood_adaptive (LL_ADAPTIVE_MAX_STEPS) at n=1;
20. uncond_cpu_vs_card: a 64 px, 64-channel UNet through the CLI's
   `draw_samples` in float32 (TF32 off) on the CPU and on the card, the
   same weights, initial x and noise (dpmpp_2m 6 steps, ancestral over a
   respacing of 5, dpmpp_sde 4 steps with one Brownian seed: the CPU run
   queries a second tree of that seed on the card), within UNCOND_CPU_TOL
   of the largest |x|;
16a. two more CLI runs as phase 16's: cli_imagenet_winograd
   (configs/test_imagenet.json at full width, 256 channels, --winograd,
   bf16, a guided-diffusion .pt, 1 image; 89 plain + 79 fused Winograd
   launches per NFE, derived from the model and held to
   IMAGENET_WINO_PER_NFE) and cli_kdiff_v2_dwt (an image_v2 config
   written by the phase, KDIFF_CLI_MODEL: the k-diffusion V2 UNet with its
   learned DWT covariance, float32, a k-diffusion .pt, 1 image; the fused
   matvec's launches the CG iterations plus one per solve, no standalone
   DWT and no Winograd launch); each then --resume'd;
16b. nfe_imagenet_winograd: phase 8's guided NFE on the ImageNet-256
   torso, then phase 9's per-shape record of its every Winograd launch
   (`winograd_shapes` / `winograd_levels` lines naming the config);
16c. adm_rest_cpu_vs_card: a class-conditional ADM UNet without
   scale-shift norm or resblock up/down, the attention-pool classifier
   (logits and the classifier-guidance input gradient), the
   super-resolution UNet and the k-diffusion V1 and V2 UNets, 64 px
   float32, CPU against card within ADM_REST_TOL; then
   no_scale_shift_winograd: a 64 px bf16 Winograd torso without
   scale-shift norm, kernels against their plain versions (phase 8's
   drift bound) and its launches exact;
16d. analytic_variance_imagenet: the analytic-variance CLI
   (`kdip_tpu_torch.cli.analytic_variance.main`, in-process) on
   configs/test_imagenet.json at full width, bf16, with
   cli_imagenet_winograd's checkpoint: AV_SIGMAS sigmas over AV_BATCHES
   batches of AV_B (seeded PNGs, two resized without PIL), every UNet
   forward counted and timed, no DWT or Winograd launch; --resume again
   runs no forward and gives the table bit for bit; then the guided CLI on
   one image with the analytic covariance reading that table through the
   config's recon_mse key (AV_CLI_STEPS Heun steps);
16e. train_ffhq_dwt: the fine-tune CLI (`kdip_tpu_torch.cli.train_openai.
   main`, in-process) on configs/train_ffhq_dwt.json at full width, float32
   (TF32 off), batch TRAIN_B, from a seeded torso `.pt`, over seeded PNGs
   (two resized): per_sample_map, batched and --accum 2 runs, then the
   first resumed (the state restored exactly, then two more steps); every
   call of the step launches the forward DWT kernel 2B times and the
   inverse B times per-sample (2 and 1 batched) and no Winograd kernel;
   its s/step (the median after the first) and peak memory; then one
   loss and gradient with the kernel DWT against the plain version's;
16f. train_loop_ffhq_winograd: guided-diffusion's TrainLoop
   (`kdip_tpu_torch.train_loop`) on configs/test_ffhq.json's ADM as it is
   (learn_sigma, dropout 0.1), seeded random float32 masters and the bf16
   Winograd torso, TF32 off: an ImageDataset of seeded PNGs with random
   crops (BOX halvings and BICUBIC without PIL), 8 images a step in 2
   microbatches, rescaled_mse, the loss-second-moment sampler, two EMAs,
   GNS; first one microbatch's loss and gradients through the kernels,
   their plain versions, the direct torso and float32, at dropout 0 and
   0.1 with the same masks (phase 8's drift rule, launches exact forward
   and backward apart, none fused under live dropout); then 4 steps, a
   resume restoring the state bit for bit, and 2 more, every
   microbatch's launches exact; the saved EMA loaded by the guided CLI's
   loader; s/step, images/s, peak memory and the data fetch's share;
16g. evaluate_fid_inception: the FID/KID CLI
   (`kdip_tpu_torch.cli.evaluate.main`, in-process) over two folders of
   2100 seeded 256 px PNGs made on the card ("fake" a noised copy of
   "real") with a full-width InceptionV3 of seeded weights in a
   pt_inception `.pth`, TF32 off: the inception backbone (B=64), pixels on
   256 of each, --paired with LPIPS on 64 pairs, and the refusals of
   --backbone clip (no transformers) and --dp without a process group; the
   card's FID/KID against float64 on the CPU from the same
   features, card against CPU features of 16 images; wall seconds,
   images/s end to end and of the forward alone, the data fetch's share,
   the busy share of one traced batch, ms of sqrtm_eig at D=2048, peak
   memory; no kernel launch;
20a. scale_out: the port's data-parallel paths
   (`kdip_tpu_torch.parallel`) at full width, the ranks processes of this
   script (`chip_smoke.py --scale-out PART PLAN`, under RANK, WORLD_SIZE,
   MASTER_ADDR and MASTER_PORT, the kernels already built), deterministic
   kernels, guided runs at Heun-SCALE_OUT_STEPS, every part side by side.
   Part (a), one rank under NCCL (two processes, sampling and training):
   the guided CLI on configs/test_ffhq_dwt.json --v2 (bf16, a batch
   of 2 images) batched without a group, then with --dp, within
   SCALE_OUT_TOL and the same CG iterations, the fused matvec's launches
   the CG iterations plus one per solve; two TrainLoop steps on
   test_ffhq.json's bf16 Winograd torso (dropout 0.1 live) without and
   with mesh=, the same params and EMAs (Adam's bound of
   tests/test_torch_train_loop.py), every microbatch's Winograd launches
   exact; one train_openai step in the group; FSDP2 (`shard_params_fsdp`)
   on the full-width torso against a replicated copy within FSDP_TOL;
   evaluate --dp against evaluate on two folders of SCALE_OUT_EVAL images,
   FID and KID equal; the NCCL collectives' times. Part (b), beside part
   (a), two ranks on the one card under gloo (CUDA tensors reduced and
   gathered through the host): the guided CLI with --dp, one image a
   rank, both ranks the same CG iterations and the same CG exit residual,
   within SCALE_OUT_RESID_REL of part (a)'s, each its launches exact, the
   gathered samples within an RMS of SCALE_OUT_RANKS_RMS of part (a)'s
   --dp run of the pair (both float32, on the config at sigma_max
   SCALE_OUT_SIGMA_MAX); the gloo collectives' times. Each part's seconds
   and each rank's peak memory;
21. the `kernels` line: per kernel, its launches in its slices (phases 3,
   3a, 4a, 7, 10, 12, 16-16g, 18-20 and 20a), its error, its time against its
   plain version's, its bound and, for the Winograd kernels, cuDNN's
   direct conv, at the slice's hottest shape; for the fused matvec, the six-launch chain it
   replaces and an empty kernel's device time beside it.

Depth cuts to pay for 20a: the per-sample slices of phases 3, 5
and 7 run N_SAMPLES = 2 (their batched twins BATCHED_N = 4), autoI
AUTOI_N = 1 (PERF.md §4). The tmpd slice stays at Heun-50: at Heun-25 its
samples are not finite with random weights.

Each slice's line has its ms/NFE, samples/s, cg_max_residual, CG
iterations, CG warnings (counted, not printed) and DWT launches; the
`done` line has every phase's seconds. Then the card's name and power
limit (nvidia-smi) and, last, the result line. Any failed phase raises, so
the script exits non-zero and prints no result line; without a card, or
without the package beside it, it exits 2.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bandwidth, the
# float32 rate outside the tensor cores, and the dense bf16 tensor rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TENSOR_FLOP_PER_S = 989e12

ROOT = os.path.dirname(os.path.abspath(__file__))
SIZE = 256          # FFHQ-256
STEPS = 50          # SamplerConfig's default: Heun-50
# Depth cut to pay for the scale_out phase (with AUTOI_N's): the
# per-sample slices slice_dwt_var, slice_convert and
# slice_convert_winograd run 2 samples (at 4 they took about 130 s
# together in a whole run on an H100 80GB HBM3 at 700 W); their batched
# twins keep 4
BATCHED_N = 4
N_SAMPLES = 2
CLI_DWT_IMAGES = 2              # cli_dwt_var's test images
CLI_WINO_IMAGES = 1             # cli_convert_winograd's
# phases 18-20, unconditional sampling: n, the Karras steps, the CLI runs
UNCOND_N, UNCOND_STEPS = 2, 10
UNCOND_RUNS = (("heun", ()), ("euler", ()), ("dpmpp_2m", ()),
               ("dpmpp_sde", ()), ("lms", ()), ("dpm_2", ()),
               ("ancestral", ("--respacing", "25")),
               ("ddim", ("--respacing", "ddim25")),
               ("ddim", ("--respacing", "ddim25", "--eta", "0.5")))
# samplers_rest's dpm_adaptive at its default tolerances: a 64 px random
# UNet takes 13 steps, 39 calls, on the CPU; the phase fails past this
ADAPTIVE_NFE_BUDGET = 150
LL_ADAPTIVE_MAX_STEPS = 4       # at most 1 + 6 * 4 = 25 fevals
# CPU vs card, float32 with TF32 off: the same ops summed in other orders,
# carried through a few steps from sigma 80
UNCOND_CPU_TOL = 1e-3
# adm_rest_cpu_vs_card: one forward (and a gradient) a model, the same
# bound as the uncond trajectories'
ADM_REST_TOL = 1e-3
# cli_imagenet_winograd and cli_kdiff_v2_dwt: test images each
CLI_IMAGENET_IMAGES = 1
CLI_KDIFF_IMAGES = 1
# The ImageNet-256 torso's Winograd launches per guided NFE: 42 ResBlocks,
# 5 of them down; the forward runs the plain kernel in the 5 down-blocks'
# in_conv and the fused one in the other 79 convs, the vjp's dx the plain
# kernel in all 84 (winograd_per_nfe derives it from the model; this holds
# the derivation to the count of kdip_tpu/models/adm.py:69-142)
IMAGENET_WINO_PER_NFE = {"winograd_conv3x3": 89,
                         "winograd_conv3x3_fused": 79}
FFHQ_WINO_PER_NFE = {"winograd_conv3x3": 65, "winograd_conv3x3_fused": 55}
# cli_kdiff_v2_dwt's image_v2 config: no image_v2 config ships in the
# repo, so these widths stand in for a published one, taken from the
# repo's FFHQ ADM (channels 128, 128, 256, 256, 512, 512; two layers a
# level; self-attention at 16 px; a mapping width of 4 x 128); the
# learned DWT covariance (has_variance, "ortho_tf_type": "dwt"); the
# k-diffusion defaults for the rest (sigma_data 1.0, augment_wrapper)
KDIFF_CLI_MODEL = {
    "type": "image_v2", "input_channels": 3, "input_size": [256, 256],
    "sigma_min": 1e-2, "sigma_max": 80, "mapping_out": 512,
    "depths": [2, 2, 2, 2, 2, 2], "channels": [128, 128, 256, 256, 512, 512],
    "self_attn_depths": [False, False, False, False, True, False],
    "has_variance": True, "ortho_tf_type": "dwt"}
# train_ffhq_dwt: configs/train_ffhq_dwt.json through the fine-tune CLI at
# batch TRAIN_B over TRAIN_IMAGES 256 px PNGs and TRAIN_RESIZED at 288 x
# 320 (LANCZOS-resized without PIL); each run's steps; the DWT launches of
# one call of the step: two forward (the output and the target) and one
# inverse (the output's backward) a loss evaluation, B of them under
# per_sample_map
TRAIN_B, TRAIN_IMAGES, TRAIN_RESIZED = 4, 6, 2
TRAIN_RUNS = (("per_sample_map", (), 3),
              ("batched", ("--no-per-sample-map",), 3),
              ("accum2", ("--accum", "2"), 4))
TRAIN_RESUME_TO = 5            # the per_sample_map run, resumed at step 3
# the kernel DWT's loss and gradient against the plain version's on the
# card: the forward is the same arithmetic (the kernel is bit-equal to the
# plain version within DWT_TOL); cuDNN's float32 weight gradients sum in
# an order that may change from call to call
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-5, 1e-4
# analytic_variance_imagenet: configs/test_imagenet.json (bf16), AV_SIGMAS
# Karras sigmas over AV_BATCHES batches of AV_B (the same kind of folder),
# then the guided CLI on one image with the written table (--steps
# AV_CLI_STEPS, to keep the phase short)
AV_SIGMAS, AV_B, AV_BATCHES, AV_CLI_STEPS = 10, 4, 2, 10
assert AV_B * AV_BATCHES == TRAIN_IMAGES + TRAIN_RESIZED
# train_loop_ffhq_winograd: guided-diffusion's TrainLoop on
# configs/test_ffhq.json's ADM as it is (learn_sigma, dropout 0.1), float32
# masters and a bf16 Winograd torso: LOOP_B images a step in microbatches
# of LOOP_MB, LOOP_STEPS steps, then a fresh loop resumed from the logdir
# takes LOOP_MORE more; random crops from seeded PNGs, (count, (H, W)):
# the large ones always halved by BOX before BICUBIC (their smaller side
# is at least twice the largest drawn scale, 320), the small ones BICUBIC
# only
LOOP_B, LOOP_MB, LOOP_STEPS, LOOP_MORE = 8, 4, 4, 2
LOOP_PNGS = ((6, (660, 700)), (2, (280, 300)))
LOOP_EMA = "0.9999,0.999"
# the loss of a microbatch through a bf16 torso against float32 (relative)
LOOP_LOSS_RTOL = 2e-2
# tmpd's slice runs one sample: with random weights its CG runs the whole
# 1000-iteration budget at most NFEs, so it took 209 of the script's 762 s
# at n=4 (H100 80GB HBM3, 700 W), and the script aims at half its time
# limit
TMPD_N = 1
# Depth cut to keep the script inside its 1200 s limit with training's two
# phases (H100 80GB HBM3, 700 W): phase 10's other five slices run 1
# sample (at 4 the phase took 298 of 1026 s; at 2, 191 of 1132 s),
# Type-II DWT-Var and DCT-Var 2 (82 s of 1132 s at 4), autoI 2 (62 s);
# autoI at 1, with N_SAMPLES' cut, pays for the scale_out phase
BLUR_SR_N = 1
TYPE_II_DCT_N = 2
AUTOI_N = 1
BLUR_NFE_SIGMA = 0.5            # phase 11's NFEs
TMPD_THETA_SIGMAS = (0.5, 2.0, 10.0, 40.0)  # phase 11's tmpd variances
STSL_NFE_SIGMA = 0.5            # phase 14's stsl NFE
AUTOI_PROBES = 8                # autoI's Hutchinson probes, SLQ's probes
AUTOI_NFE_SIGMA = 0.5           # nfe_autoI and nfe_loglikelihood
LL_LANCZOS = 25                 # SLQ's Lanczos steps a probe
# nfe_loglikelihood, kernel vs plain DWT: |ll_k - ll_p| <= LL_TOL * d, d =
# 196,608 values of y: the value sums three float32 terms of size ~d (the
# quadratic term, the logdet, d log 2 pi); the two runs differ only where
# CG or Lanczos round apart
LL_TOL = 1e-5
NONLINEAR_STEPS = 25            # slice_nonlinear_blur_dps: DPM++(2M)-25
# slice_analytic_I's recon_mse table: the repo holds no measured one
# (configs/test_imagenet.json names one under runs/), so a synthetic one,
# half of mle_var at 64 log-spaced sigmas
_MSE_SIGMAS = np.geomspace(1e-2, 80.0, 64).astype(np.float32)
RECON_MSE = {"sigmas": _MSE_SIGMAS,
             "mse_list": (0.5 * _MSE_SIGMAS ** 2 / (1 + _MSE_SIGMAS ** 2)
                          ).astype(np.float32)}
# evaluate_fid_inception: the FID/KID CLI over two folders of EVAL_IMAGES
# seeded EVAL_SIZE px PNGs each (n - 1 >= 2048, so both covariances are
# full rank, as in a 50k-image FID), "fake" a copy of "real" with
# N(0, EVAL_NOISE) added in 8-bit levels; the pixels run on the first
# EVAL_PIXELS images of each (its 3072 features are rank-deficient at any
# n here, and a run over all of them took 26-37 s, the data fetch 93-96%
# of it; H100 80GB HBM3, 700 W); the paired run on EVAL_PAIRED pairs;
# card against CPU features on EVAL_CPU_IMAGES images within EVAL_CPU_TOL
# of the largest |feature|
EVAL_IMAGES = 2100
EVAL_SIZE = 256
EVAL_BATCH = 64
EVAL_PIXELS = 256
EVAL_PAIRED = 64
EVAL_NOISE = 24.0
EVAL_CALIB = 64                 # images whose statistics set the BN stats
EVAL_CPU_IMAGES = 16
EVAL_CPU_TOL = 1e-3
# ... and those images' features must differ from each other (the least
# max-abs difference of two of them) by at least EVAL_SPREAD of the
# largest |feature|, 10x EVAL_CPU_TOL, so that features that hardly depend
# on the input cannot pass that comparison
EVAL_SPREAD = 1e-2
INCEPTION_FC = (1008, 2048)     # pt_inception's fc.weight (manifest)
# the card's float32 FID / KID against float64 on the CPU from the same
# features: |gap| <= FID_GAP_TRACE * (tr cov_real + tr cov_fake) and
# KID_GAP_KERNEL * the mean kernel value. Set before the first card run
# from a CPU estimate on these images and weights: 1.6e-3 and 5.4e-8 (a
# sample covariance of 2100 in 2048 dimensions has eigenvalues down to
# ~1e-7 of its largest, which float32's eigh resolves only roughly)
FID_GAP_TRACE = 1e-2
KID_GAP_KERNEL = 1e-6
# the scale_out phase: its guided runs at Heun-SCALE_OUT_STEPS
# (they hold --dp against the one-process runs, at any depth)
SCALE_OUT_STEPS = 10
SCALE_OUT_IMAGES = 2            # the guided CLI's: one batch of 2
SCALE_OUT_EVAL = 128            # evaluate --dp: images a folder
SCALE_OUT_LOOP_STEPS = 2        # TrainLoop steps, with and without mesh=
# part (a): --dp at one rank against the batched CLI, bf16, deterministic
# kernels (the same sums but the all_reduce of one rank's partials)
SCALE_OUT_TOL = 1e-5
# part (b): two ranks, a block of 1 each, against part (a)'s batch of 2.
# The UNet's convolutions round otherwise at another batch size (4e-6 of
# an eps of ~1 at 64 px on the CPU), and the random-weight DWT-Var sampler
# amplifies such roundings: a 1e-6 relative perturbation of eps moved the
# samples by an RMS of 2.4e-4 (max 3e-3) over 11 NFEs (64 px, CPU). At a
# high sigma, hat_x0 = x0_mean + sigma^2 * score cancels terms of size
# sigma^2 |mat| and makes whole-pixel differences of them (2.0, the full
# range, from sigma_max 80 in a CPU rehearsal). So part (b) and its
# reference in part (a) run a copy of the config whose sigma_max is
# SCALE_OUT_SIGMA_MAX (as tests/test_torch_sampling.py does). Read on an
# H100 with deterministic kernels, the same in every run: the RMS over
# the images 7.8e-5 (max 1.8e-3). A CG whose inner products are not
# summed across the ranks converges each rank's block to the same
# solution within the CG's tolerance, and read an RMS of 7.9e-5: no RMS
# bound tells it apart, but its exit residual differs between the ranks
# and from part (a)'s joint one by 7-11%, where the sound run's two ranks
# agree bit for bit and within 4.7e-5 of part (a)'s. So part (b) holds
# the ranks' residuals equal and within SCALE_OUT_RESID_REL of part (a)'s,
# and the RMS within SCALE_OUT_RANKS_RMS, 13x the sound reading, against
# a block in the wrong place. (A rank-local iso mean read bit-equal to the
# sound run: this path never takes it; tests/test_torch_parallel_ranks.py
# holds it on the CPU.)
SCALE_OUT_SIGMA_MAX = 2.0
SCALE_OUT_RANKS_RMS = 1e-3
SCALE_OUT_RESID_REL = 2e-3
FSDP_TOL = 1e-5                 # FSDP2 against replicated: loss, gradients
SCALE_OUT_TIMEOUT = 600
DWT_TOL = 1e-6      # kernel vs plain: the same float32 roundings (phase 2)
DWT_EQUAL = 0.999   # least bit-equal share of the fused matvec (phase 2)
CHAIN_LEVELS = (4, 5, 6, 7, 8)  # phase 2: chained passes, up to 1x1 at 256
CHAIN_MATVEC_LEVEL = 5
NFE_TOL = 1e-3      # kernel-DWT vs plain-DWT guided NFE (see phase 4)
NFE_REPS = 5        # timed calls per NFE variant in phases 4 and 8
# Winograd kernel vs its plain version (phase 6), per element:
# |d| <= 2^-7 |plain| + 2^-14 max|plain|, and at least 99% bit-equal. Both
# round the same values at the same places; only the float32 order of the
# 16 products' sums over C differs (tensor cores against a float32 matmul),
# so an output may round to its bf16 neighbour (one ulp, <= 2^-7 of it),
# and where cancellation leaves an output tiny the float32 noise of its
# terms decides (far below 2^-14 of the largest output).
WINO_REL, WINO_ABS, WINO_EQUAL = 2 ** -7, 2 ** -14, 0.99
# (B, C, F, H, W): the hottest FFHQ-256 shape, the deepest, C and F not
# multiples of 16 (H, W not multiples of 16 either), B = 2; then shapes
# that, with those, reach every launch configuration of
# ops.winograd.launch_config (tests/test_torch_winograd_launch.py)
WINO_SHAPES = ((1, 128, 128, 256, 256), (1, 1024, 512, 8, 8),
               (1, 40, 24, 18, 22), (2, 64, 32, 32, 32),
               (1, 64, 64, 256, 256), (1, 128, 128, 128, 128),
               (1, 200, 60, 64, 64), (1, 768, 256, 32, 32),
               (1, 256, 256, 16, 16), (2, 32, 16, 8, 8), (2, 48, 40, 8, 8),
               (4, 256, 64, 8, 8))
# phase 8 (see phase_nfe_winograd): one guided NFE below Convert's 0.2
# threshold; kernels vs plain versions, vs the direct torso
WINO_NFE_SIGMA = 0.1
WINO_DRIFT_RATIO = 3.0   # the kernels' drift from float32 / the others'
WINO_SHAPE_REPS = 50     # timed calls per launch shape in phase 9
LEAD_IN_KERNELS = 200    # run first in every trace (trace_device_events)
# phase 4's and 8's device time by kind, from the kernel's name (first match
# wins: "winograd" before "conv", which would swallow it)
KERNEL_KINDS = (("haar_dwt", ("haar_dwt2",)),
                ("winograd", ("winograd_f23",)),
                ("layout", ("nchwToNhwc", "nhwcToNchw")),
                ("conv_gemm", ("xmma", "cutlass", "gemm", "conv", "sm90_")),
                ("reduction", ("reduce_kernel", "reduce")),
                ("memcpy_memset", ("Memcpy", "Memset")),
                ("fft", ("fft",)),
                ("elementwise", ("elementwise", "copy_kernel", "Functor")))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def load_op_config(fname: str, **overrides) -> dict:
    """An operator yaml of configs/, read by `config.load_yaml` (the YAML
    subset; the card's machine may lack PyYAML), with `overrides`."""
    from kdip_tpu_torch import config
    return dict(config.load_yaml(config_path(fname)), **overrides)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


class PlainDWT:
    """OrthoTransform("dwt") on the plain PyTorch version: the comparison
    side of the kernel-vs-plain NFE phases (the port itself never sends a
    CUDA tensor there). Its type is not "dwt", so ot_covariance composes
    its two transforms around the variance."""
    ortho_tf_type = "plain_dwt"

    def __init__(self, level: int = 3):
        self.level = level

    def __call__(self, x):
        from kdip_tpu_torch.ops.dwt import dwt2_plain
        return dwt2_plain(x, self.level)

    def inv(self, x):
        from kdip_tpu_torch.ops.dwt import idwt2_plain
        return idwt2_plain(x, self.level)

    def masked_cov_matvec(self, v, theta, mask, s2):
        from kdip_tpu_torch.ops.dwt import ot_matvec_plain
        return ot_matvec_plain(v, theta, mask, s2, self.level)


def cuda_time_ms(fn, reps: int = 200, warmup: int = 20) -> float:
    """Mean time per call of fn() over `reps` back-to-back calls, by CUDA
    events: the device time, or the host's launch interval where that is
    longer."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device_and_build():
    import torch
    from kdip_tpu_torch.ops import _build
    t0 = time.perf_counter()
    log = _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {src: [ln.strip() for ln in err.splitlines()
                   if "registers" in ln or "spill" in ln]
             for src, (_, err) in log.items()}
    emit({"phase": "device_and_build", "nvidia_smi": nvidia_smi(),
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_seconds": seconds, "built": sorted(log), "ptxas": ptxas})


def phase_kernels(dev):
    """Kernel vs plain version on the card, within DWT_TOL: both round each
    butterfly's sum, then its product with float32(1/sqrt2), so they should
    agree bit for bit."""
    import torch
    from kdip_tpu_torch.ops import dwt as D
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(4, 3, 256, 256, generator=g, device=dev)
    ct = torch.randn(4, 3, 256, 256, generator=g, device=dev)
    errs = {}
    for level in (1, 2, 3):
        y = D.haar_dwt2_cuda(x, level, inverse=False)
        xi = D.haar_dwt2_cuda(x, level, inverse=True)
        back = D.haar_dwt2_cuda(y, level, inverse=True)
        xr = x.clone().requires_grad_(True)
        g_f, = torch.autograd.grad(D.dwt2(xr, level), xr, grad_outputs=ct)
        g_i, = torch.autograd.grad(D.idwt2(xr, level), xr, grad_outputs=ct)
        torch.cuda.synchronize()
        e = {"fwd": (y - D.dwt2_plain(x, level)).abs().max().item(),
             "inv": (xi - D.idwt2_plain(x, level)).abs().max().item(),
             "round_trip": (back - x).abs().max().item(),
             "bwd_fwd": (g_f - D.idwt2_plain(ct, level)).abs().max().item(),
             "bwd_inv": (g_i - D.dwt2_plain(ct, level)).abs().max().item()}
        errs[level] = e
        for k, v in e.items():
            tol = 2 * DWT_TOL if k == "round_trip" else DWT_TOL
            if not v <= tol:
                raise AssertionError(f"level {level} {k}: |d| {v} > {tol}")
    emit({"phase": "kernels", "shape": [4, 3, 256, 256], "tol": DWT_TOL,
          "round_trip_tol": 2 * DWT_TOL, "max_abs_err": errs,
          "ot_matvec": matvec_compare(dev), "chained": chain_compare(dev)})


def chain_compare(dev):
    """The DWT past the kernel's single-pass levels, at [1, 3, 256, 256]
    float32: dwt2 / idwt2 at CHAIN_LEVELS (passes of up to 3 levels on the
    approximation block) against dwt2_plain / idwt2_plain, within DWT_TOL
    and at least DWT_EQUAL bit-equal, the round trip within 2 * DWT_TOL,
    and the passes launched counted; then the chained ot_matvec at
    CHAIN_MATVEC_LEVEL with and without the mask against ot_matvec_plain."""
    import torch
    from kdip_tpu_torch.ops import dwt as D
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(1, 3, SIZE, SIZE, generator=g, device=dev)
    res = {}

    def held(key, got, want, tol=DWT_TOL, equal_min=DWT_EQUAL):
        err = (got - want).abs().max().item()
        equal = (got == want).float().mean().item()
        res[key] = {"max_abs_err": err, "bit_equal": equal}
        if not (err <= tol and equal >= equal_min):
            raise AssertionError(f"chained {key}: |d| {err}, {equal:.5f} "
                                 f"bit-equal")
    for level in CHAIN_LEVELS:
        D.reset_launch_counts()
        y = D.dwt2(x, level)
        xi = D.idwt2(x, level)
        torch.cuda.synchronize()
        n = len(D.passes(level))
        if D.launch_counts != {"haar_dwt2": n, "haar_idwt2": n,
                               "haar_ot_matvec": 0}:
            raise AssertionError(f"level {level}: launches "
                                 f"{D.launch_counts}, expected {n} a way")
        held(f"L{level} fwd", y, D.dwt2_plain(x, level))
        held(f"L{level} inv", xi, D.idwt2_plain(x, level))
        back = D.idwt2(y, level)
        res[f"L{level} round_trip"] = (back - x).abs().max().item()
        if not res[f"L{level} round_trip"] <= 2 * DWT_TOL:
            raise AssertionError(f"level {level} round trip: "
                                 f"{res[f'L{level} round_trip']}")
    v, theta, mask, s2 = matvec_inputs(dev, 1, seed=12)
    level = CHAIN_MATVEC_LEVEL
    for form, (m, s) in (("masked", (mask, s2)), ("maskless", (None, 0.0))):
        got = D.ot_matvec(v, theta, m, s, level)
        held(f"ot_matvec L{level} {form}", got,
             D.ot_matvec_plain(v, theta, m, s, level))
    return res


def matvec_inputs(dev, B, seed):
    """v ~ N(0, 1), theta in [0.5, 1.5), a 0/1 mask of density 0.5, all
    [B, 3, 256, 256] float32, and s2 = float32(0.05)^2, the inpainting
    solve's sigma_s^2."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (B, 3, SIZE, SIZE)
    v = torch.randn(shape, generator=g, device=dev)
    theta = 0.5 + torch.rand(shape, generator=g, device=dev)
    mask = (torch.rand(shape, generator=g, device=dev) < 0.5).float()
    return v, theta, mask, float(np.float32(0.05) ** 2)


def matvec_compare(dev):
    """The fused matvec against ot_matvec_plain, within DWT_TOL and at
    least DWT_EQUAL bit-equal (the same roundings, so 100% is expected):
    at B = 4 and 1, levels 1-3; theta and the mask per sample, repeating
    over the batch ([1, C, H, W], as the batched path and the inpainting
    mask give them), and no mask (ot_covariance)."""
    import torch
    from kdip_tpu_torch.ops import dwt as D
    res = {}
    for B in (4, 1):
        v, theta, mask, s2 = matvec_inputs(dev, B, seed=B)
        forms = {"masked": (theta, mask, s2),
                 "repeating": (theta[:1].contiguous(), mask[:1].contiguous(),
                               s2),
                 "maskless": (theta, None, 0.0)}
        for level in (1, 2, 3):
            for form, (t, m, s) in forms.items():
                got = D.haar_ot_matvec_cuda(v, t, m, s, level)
                want = D.ot_matvec_plain(v, t, m, s, level)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                equal = (got == want).float().mean().item()
                key = f"B{B} L{level} {form}"
                res[key] = {"max_abs_err": err, "bit_equal": equal}
                if not (err <= DWT_TOL and equal >= DWT_EQUAL):
                    raise AssertionError(f"ot_matvec {key}: |d| {err}, "
                                         f"{equal:.5f} bit-equal")
    return res


def wino_inputs(dev, B, C, F, H, W, seed):
    """bf16 x [B, C, H, W] ~ N(0, 1), a weight [F, C, 3, 3] scaled to unit
    output variance, and the prologue's float32 a ~ 1 + 0.3 N, b ~ 0.3 N."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, C, H, W, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(F, C, 3, 3, generator=g, device=dev)
         / (9 * C) ** 0.5).to(torch.bfloat16)
    a = 1 + 0.3 * torch.randn(B, C, generator=g, device=dev)
    b = 0.3 * torch.randn(B, C, generator=g, device=dev)
    return x, w, a, b


def wino_compare(got, want, what, bit_equal=True):
    """The WINO_* tolerance; returns the record of one comparison."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = int((err > WINO_REL * want.abs()
               + WINO_ABS * want.abs().max()).sum())
    equal = (got == want).float().mean().item()
    if bad or (bit_equal and equal < WINO_EQUAL):
        raise AssertionError(f"{what}: {bad} elements out of tolerance, "
                             f"{equal:.5f} bit-equal")
    return {"max_abs_err": err.max().item(), "bit_equal": equal}


def phase_kernels_winograd(dev):
    """Both entry points against the plain version on the card, bf16, and
    the autograd of both ops (dx runs the kernel on the rotated weight; da,
    db follow from it) against the plain version's autograd."""
    import torch
    from kdip_tpu_torch.ops import winograd as Wg
    res = {}
    for i, shape in enumerate(WINO_SHAPES):
        x, w, a, b = wino_inputs(dev, *shape, seed=i)
        v = Wg.kernel_transform(w)
        key = "x".join(map(str, shape))
        for tag, pro in (("plain", None), ("fused", (a, b))):
            y = Wg.winograd_conv3x3_cuda(x, v, pro)
            torch.cuda.synchronize()
            res[f"{tag} {key}"] = wino_compare(
                y, Wg.winograd_conv3x3_plain(x, v, pro), f"{tag} {key}")
    x, w, a, b = wino_inputs(dev, *WINO_SHAPES[3], seed=9)
    g = torch.Generator(device=dev).manual_seed(10)
    B, _, F, H, W = WINO_SHAPES[3]
    ct = torch.randn(B, F, H, W, generator=g, device=dev).to(x.dtype)
    for tag in ("plain", "fused"):
        grads = []
        for conv in (None, Wg.winograd_conv3x3_plain):
            xs, as_, bs = (t.clone().requires_grad_(True) for t in (x, a, b))
            y = Wg.winograd_conv3x3(
                xs, w, prologue=(as_, bs) if tag == "fused" else None,
                conv=conv)
            wrt = [xs, as_, bs] if tag == "fused" else [xs]
            grads.append(torch.autograd.grad(y, wrt, grad_outputs=ct))
        torch.cuda.synchronize()
        for got, want, name in zip(*grads, ("dx", "da", "db")):
            # da, db are float32 sums of dx's terms: no bit-equal share
            res[f"autograd {tag} {name}"] = wino_compare(
                got, want, f"autograd {tag} {name}", bit_equal=name == "dx")
    emit({"phase": "kernels_winograd", "dtype": "bfloat16",
          "tol": {"rel": WINO_REL, "abs_of_max": WINO_ABS,
                  "min_bit_equal": WINO_EQUAL},
          "shapes_BCFHW": WINO_SHAPES,
          "launch_configs": [Wg.launch_config(*sh)._asdict()
                             for sh in WINO_SHAPES],
          "results": res})


def config_path(name: str) -> str:
    return os.path.join(ROOT, "configs", name)


def guided_nfes_below(thres: float, steps: int = STEPS,
                      sigma_max: float = 80.0) -> int:
    """Guided NFEs of one Heun trajectory of `steps` steps (churn) from
    `sigma_max` at a sigma below `thres`, from the schedule as
    samplers.sample_heun walks it: a call at sigma_hat each step, and at
    sigma_next where that is not 0."""
    from kdip_tpu_torch import sampling_api, samplers, schedules
    c = sampling_api.SamplerConfig(steps=steps, sigma_max=sigma_max)
    sig = schedules.get_sigmas_karras(c.steps, c.sigma_min, c.sigma_max,
                                      c.rho).numpy()
    gammas = samplers._churn_gammas(sig, c.s_churn, c.s_tmin, c.s_tmax)
    calls = [float(sig[i] * (gammas[i] + np.float32(1)))
             for i in range(len(sig) - 1)]
    calls += [float(s) for s in sig[1:] if s != 0]
    return sum(s < thres for s in calls)


def winograd_per_nfe(model):
    """Winograd launches per guided NFE at B=1, from the model's blocks: the
    forward runs the plain kernel in each down-block's in_conv and the fused
    one in every other 3x3 conv of a ResBlock; the vjp runs the plain kernel
    once per conv (dx). FFHQ-256 (30 blocks, 5 down): 65 plain + 55 fused."""
    from kdip_tpu_torch.models.layers import ResBlock
    blocks = [m for m in model.modules() if isinstance(m, ResBlock)]
    down = sum(b.down for b in blocks)
    return {"winograd_conv3x3": down + 2 * len(blocks),
            "winograd_conv3x3_fused": 2 * len(blocks) - down}


def run_slice(name, dev, v2: bool, gcfg, seed: int, n: int,
              winograd: bool = False, op_cfg=None, model_config=None,
              ode: bool = False, recon_mse=None, sampler: str = "heun",
              steps: int = 0, measure=None, per_sample_map: bool = True):
    """`sampler` for `steps` (0: STEPS) steps, Heun-50 by default (with
    churn unless `ode` or dpmpp_2m), n samples against one measurement,
    one at a time (per_sample_map) or as one batch; returns the phase
    record (and the measurement pieces for the NFE phases). The slice is
    built by `bench_torch.build`, the benchmark's own builder (default
    operator: p=0.5 inpainting), so slice_convert and bench_torch.py's
    default row are one workload. CG's non-convergence warnings are
    counted, not printed."""
    import warnings

    import torch

    import bench_torch
    from kdip_tpu_torch import sampling_api
    from kdip_tpu_torch.ops import dwt as D
    from kdip_tpu_torch.ops import winograd as Wg
    scfg = sampling_api.SamplerConfig(steps=steps or STEPS, ode=ode,
                                      sampler=sampler,
                                      per_sample_map=per_sample_map)
    sampler, parts = bench_torch.build(
        dev, gcfg, seed, op_cfg or load_op_config("inpainting_config.yaml"),
        scfg, v2=v2, winograd=winograd, model_config=model_config,
        measure=measure, recon_mse=recon_mse)
    model, tables, op, meas, x_true = parts
    g = torch.Generator(device=dev).manual_seed(seed + 200)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    D.reset_launch_counts()
    Wg.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        t0 = time.perf_counter()
        out, info = sampler(meas, n=n, generator=g, return_info=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(D.launch_counts)
    modes = dict(D.matvec_mode_counts)
    wino_launches = dict(Wg.launch_counts)
    # Heun calls the denoiser twice a step but the last; the others once
    nfe = n * (2 * scfg.steps - 1 if scfg.sampler == "heun" else scfg.steps)
    amax = out.abs().max().item()
    rec = {"phase": name, "guidance": gcfg.guidance,
           "sampler": scfg.sampler,
           "x0_cov_type": None if v2 else gcfg.x0_cov_type,
           "ortho_tf_type": gcfg.ortho_tf_type, "v2": v2, "ode": ode,
           "n": n, "per_sample_map": per_sample_map, "steps": scfg.steps,
           "operator": op.name,
           "y_shape": list(meas.y.shape),
           "wall_s": wall, "samples_per_s": n / wall, "nfe": nfe,
           "ms_per_nfe": 1e3 * wall / nfe,
           "cg_max_residual": info["cg_max_residual"],
           "cg_total_iters": info["cg_total_iters"],
           "cg_warnings": sum("CG did not converge" in str(w.message)
                              for w in caught),
           "dwt_launches": launches, "ot_matvec_by_mode": modes,
           "winograd_launches": wino_launches,
           "max_abs_out": amax,
           "finite": bool(torch.isfinite(out).all()),
           "mse_vs_truth": ((out - x_true) ** 2).mean().item(),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if out.shape != (n, 3, SIZE, SIZE) or not rec["finite"]:
        raise AssertionError(f"{name}: bad output {tuple(out.shape)}")
    # the last Euler step returns x + (x - den)/s * (-s): den in [-1, 1]
    # up to float32 rounding
    if amax > 1 + 1e-5:
        raise AssertionError(f"{name}: output outside [-1, 1]: {amax}")
    if winograd:
        # the per-sample loop calls the UNet once per sample and NFE
        per_nfe = winograd_per_nfe(model)
        rec["winograd_launches_per_nfe"] = {
            k: v / nfe for k, v in wino_launches.items()}
        want = {k: v * nfe for k, v in per_nfe.items()}
        if wino_launches != want:
            raise AssertionError(f"{name}: Winograd launches {wino_launches}"
                                 f", predicted {want}")
    elif sum(wino_launches.values()):
        raise AssertionError(f"{name} launched the Winograd kernel")
    return rec, parts


def phase_nfe_compare(dev, gcfg, parts):
    """One guided NFE at sigma 0.5 (< mle threshold 1.0: a CG solve through
    the DWT covariance), kernel DWT vs plain DWT. Tolerance NFE_TOL: the
    two transforms should agree bit for bit (phase 2), but the UNet's
    convolutions and reductions need not repeat their summation order from
    call to call; a CG that stops at |r| <= 1e-4 |b| may then stop an
    iteration apart, and the difference of the solves reaches the output
    through the UNet vjp times sigma^2."""
    import torch
    from kdip_tpu_torch import guidance as gd
    from kdip_tpu_torch.ops import dwt as D
    model, tables, op, meas, x_true = parts
    sigma = 0.5
    uncond, var_fn = gd.make_openai_v2_uncond(model, tables, gcfg)
    den_k = gd.make_condition_denoiser(uncond, var_fn, op, meas, gcfg, v2=True,
                                       with_info=True)
    den_p = gd.make_condition_denoiser(uncond, var_fn, op, meas, gcfg, v2=True,
                                       with_info=True, ortho_tf=PlainDWT())
    g = torch.Generator(device=dev).manual_seed(7)
    x = x_true + sigma * torch.randn(x_true.shape, generator=g, device=dev)
    # the same NFE above the threshold: the closed-form solve, no CG
    sigma_hi = 2 * gcfg.mle_sigma_thres

    # the three variants in turns, NFE_REPS times after a warm-up, each
    # timed by its median wall: host time varies from call to call
    variants = {"kernel": (den_k, sigma), "plain": (den_p, sigma),
                "closed_form": (den_k, sigma_hi)}
    walls = {k: [] for k in variants}
    res = {}
    for rep in range(NFE_REPS + 1):
        for k, (den, s) in variants.items():
            D.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[k] = den(x, s)
            torch.cuda.synchronize()
            if rep:
                walls[k].append(1e3 * (time.perf_counter() - t0))
            if k == "plain" and sum(D.launch_counts.values()):
                raise AssertionError("the plain-DWT NFE launched the kernel")
    (out_k, info_k), (out_p, info_p) = res["kernel"], res["plain"]
    t_k, t_p, t_hi = (float(np.median(walls[k])) for k in variants)
    diff = (out_k - out_p).abs().max().item()

    walls_prof = []

    def traced_nfe():
        t0 = time.perf_counter()
        den_k(x, sigma)
        torch.cuda.synchronize()
        walls_prof.append(time.perf_counter() - t0)
    kernels = device_events_by_name(trace_device_events(traced_nfe))
    t_prof = walls_prof[0]
    busy_ms = sum(k[0] for k in kernels)
    by_kind = device_ms_by_kind(kernels)
    rec = {"phase": "nfe_kernel_vs_plain_dwt", "sigma": sigma,
           "max_abs_diff": diff, "tol": NFE_TOL,
           "cg_iters": [info_k["cg_iters"], info_p["cg_iters"]],
           "cg_resid": [info_k["cg_resid"], info_p["cg_resid"]],
           "median_wall_ms": [t_k, t_p], "reps": NFE_REPS,
           "closed_form_sigma": sigma_hi, "closed_form_median_wall_ms": t_hi,
           "profiled_wall_ms": 1e3 * t_prof,
           "device_busy_ms": busy_ms if kernels else "not measured",
           "device_ms_by_kind": by_kind,
           # busy time from the traced call, against the untraced calls'
           # median wall time (the tracer slows the host, not the device)
           "device_idle_share": (1 - busy_ms / t_k) if kernels
           else "not measured",
           "top_kernels_ms": [[round(k[0], 4), k[1], k[2][:80]]
                              for k in kernels[:10]]}
    emit(rec)
    if not diff <= NFE_TOL or abs(info_k["cg_iters"] - info_p["cg_iters"]) > 2:
        raise AssertionError(f"kernel vs plain NFE: {diff} > {NFE_TOL} or "
                             f"iterations {rec['cg_iters']}")


def device_ms_by_kind(kernels) -> dict:
    """Device ms of a trace's kernels ([(ms, count, name)]) by KERNEL_KINDS,
    the first kind whose name part a kernel's name holds, else "other"."""
    by_kind = {}
    for ms, _, name in kernels:
        kind = next((k for k, parts in KERNEL_KINDS if any(
            p in name for p in parts)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    return by_kind


def trace_device_events(work):
    """The device's own events (kernels, copies, sets) of work(), in the
    order they ran, from one torch.profiler (CUPTI) trace; None where the
    trace lost them. On the H100 a trace that follows a long one can lose
    the records of its first kernels (1 to 10 seen), so LEAD_IN_KERNELS
    small kernels run first, then a spin kernel (torch.cuda._sleep) that
    marks where work() begins: the first spin kernel of the trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lead = torch.zeros(1, device="cuda")
        for _ in range(LEAD_IN_KERNELS):
            lead.add_(1)
        torch.cuda._sleep(1000)
        work()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [j for j, e in enumerate(events) if "spin_kernel" in e.name]
    return events[marks[0] + 1:] if marks else None


def device_events_by_name(events):
    """[(ms, count, name)] of a trace's device events, longest first; []
    for a lost trace."""
    rows = {}
    for e in events or ():
        ms, n = rows.get(e.name, (0.0, 0))
        rows[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return sorted(((ms, n, name) for name, (ms, n) in rows.items()),
                  reverse=True)


def profiled_kernel_ms(fn, name_part: str, reps: int = 50):
    """Mean device time of the kernel whose name holds `name_part` over
    `reps` calls of fn(), from one torch.profiler (CUPTI) trace; None where
    the trace shows none."""
    return profiled_cases_ms([fn], name_part, reps)[0][0]


def profiled_cases_ms(fns, name_part, reps: int):
    """[(mean device time of the kernel whose name holds `name_part`, of
    the device events that follow it in the same call)] per call of each
    fn in `fns`, all from one torch.profiler (CUPTI) trace. `name_part` is
    one string, or one per fn. Each call of a fn must launch one such
    kernel before its other device work, on one stream: each fn is called
    1 + `reps` times (the first warms up), and the device's events
    (`trace_device_events`), in the order they ran, are cut at each
    `name_part` kernel, so no host timestamp is needed. (None, None) for
    every fn where the trace was lost; a trace that holds some of the
    kernels but not all of them fails."""
    import torch
    parts = [name_part] * len(fns) if isinstance(name_part, str) \
        else list(name_part)

    def work():
        for fn in fns:
            for _ in range(1 + reps):
                fn()
            torch.cuda.synchronize()
    events = trace_device_events(work)
    if events is None:
        return [(None, None)] * len(fns)
    marks = [j for j, e in enumerate(events)
             if any(p in e.name for p in parts)]
    want = [p for p in parts for _ in range(1 + reps)]
    if len(marks) != len(want) or not all(
            p in events[j].name for j, p in zip(marks, want)):
        raise AssertionError(f"the trace holds {len(marks)} {parts} "
                             f"kernels of {len(want)} launched")
    marks.append(len(events))
    out = []
    for i in range(len(fns)):
        parts = [0.0, 0.0]
        for k in range(i * (1 + reps) + 1, (i + 1) * (1 + reps)):
            parts[0] += events[marks[k]].time_range.elapsed_us() / 1e3
            parts[1] += sum(e.time_range.elapsed_us() for e in
                            events[marks[k] + 1:marks[k + 1]]) / 1e3
        out.append(tuple(t / reps if t else None for t in parts))
    return out


def phase_nfe_winograd(dev, gcfg, parts, name: str = "nfe_winograd"):
    """One guided NFE at WINO_NFE_SIGMA (< Convert's threshold: a CG solve)
    on the Winograd slice's weights, three ways: the kernels, their plain
    versions (each conv's `conv_fn`; no launch may be counted), and the
    direct cuDNN torso (winograd off), timed in turns; and a float32 copy
    of the same (bf16-rounded) weights as the reference. Compared: the
    UNet's raw output at the NFE's input and its vjp at a fixed cotangent,
    the unconditional x0_mean and the variance that feeds the Convert
    covariance, and hat_x0.

    A bf16 torso of this depth carries any difference that flips one
    rounding from layer to layer until it reaches its own rounding noise:
    kernels and plain versions, which agree per conv on all but ~0.1% of
    the outputs by one ulp (phase 6), give UNets about as far apart as the
    Winograd and direct torsos are (on an H100 80GB HBM3: 4.4% and 7.1% of
    the largest output, max-relative). So the torso is held
    by its drift from float32 (norm-relative, output and vjp): the
    kernels' at most WINO_DRIFT_RATIO times the plain versions' and the
    direct torso's, the form of kdip_tpu's bf16 drift bound
    (tests/test_winograd.py:61-71 allows 6 times per conv); and the CG
    iterations of kernels and plain versions within 2. The max-relative
    differences between the variants are reported; hat_x0 = x0_mean +
    sigma^2 * vjp(mat) multiplies the vjp's noise where the Convert
    variance of random weights is small. Returns the kernels' launches of
    one NFE (held exactly to winograd_per_nfe)."""
    import copy

    import torch
    from kdip_tpu_torch import guidance as gd
    from kdip_tpu_torch import precond
    from kdip_tpu_torch.models.layers import Conv2d
    from kdip_tpu_torch.ops import winograd as Wg
    model, tables, op, meas, x_true = parts
    sigma = WINO_NFE_SIGMA
    uncond, var_fn = gd.make_openai_uncond(model, tables, gcfg)
    den = gd.make_condition_denoiser(uncond, var_fn, op, meas, gcfg,
                                     with_info=True)
    convs = [m for m in model.modules() if isinstance(m, Conv2d)]
    per_nfe = winograd_per_nfe(model)

    def use(mode):
        model.set_winograd(mode != "direct")
        for m in convs:
            m.conv_fn = Wg.winograd_conv3x3_plain if mode == "plain" else None

    g = torch.Generator(device=dev).manual_seed(8)
    x = x_true + sigma * torch.randn(x_true.shape, generator=g, device=dev)
    ct = torch.randn((1, 6, SIZE, SIZE), generator=g, device=dev)
    torch.cuda.reset_peak_memory_stats()
    x_in = x * float(np.float32(precond.eps_scalings(np.float32(sigma))[1]))
    t_b = precond.sigma_to_t(tables.log_sigmas, torch.tensor(
        sigma, device=dev)).floor().long().reshape(1)

    def torso(m):
        """The raw UNet output at the NFE's input, and its vjp at ct."""
        xg = x_in.detach().requires_grad_(True)
        y = m(xg, t_b)
        vjp, = torch.autograd.grad(y, xg, grad_outputs=ct)
        return {"unet_out": y.detach().float(), "unet_vjp": vjp.float()}

    variants = ("kernel", "plain", "direct")
    walls = {k: [] for k in variants}
    res, outs = {}, {}
    for rep in range(NFE_REPS + 1):
        for k in variants:
            use(k)
            Wg.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[k] = den(x, sigma)
            torch.cuda.synchronize()
            if rep:
                walls[k].append(1e3 * (time.perf_counter() - t0))
            want = per_nfe if k == "kernel" else dict.fromkeys(per_nfe, 0)
            if Wg.launch_counts != want:
                raise AssertionError(f"{k} NFE: Winograd launches "
                                     f"{Wg.launch_counts}, expected {want}")
    for k in variants:
        use(k)
        with torch.no_grad():
            x0m, aux = uncond(x, sigma)
        outs[k] = {"x0_mean": x0m.float(), "variance": aux["variance"].float(),
                   "hat_x0": res[k][0].float(), **torso(model)}
    use("kernel")
    ref = torso(copy.deepcopy(model).float())

    def max_rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    def norm_rel(a, b):
        return ((a - b).norm() / b.norm()).item()
    cmp = {other: {q: max_rel(outs["kernel"][q], outs[other][q])
                   for q in outs["kernel"]} for other in ("plain", "direct")}
    drift = {k: {q: norm_rel(outs[k][q], ref[q]) for q in ref}
             for k in variants}

    walls_prof = []

    def traced_nfe():
        t0 = time.perf_counter()
        den(x, sigma)
        torch.cuda.synchronize()
        walls_prof.append(time.perf_counter() - t0)
    kernels = device_events_by_name(trace_device_events(traced_nfe))
    t_prof = walls_prof[0]
    busy_ms = sum(k[0] for k in kernels)
    by_kind = device_ms_by_kind(kernels)
    t_k = float(np.median(walls["kernel"]))
    iters = {k: res[k][1]["cg_iters"] for k in variants}
    rec = {"phase": name, "sigma": sigma, "t": int(t_b),
           "model_channels": model.model_channels,
           "kernel_vs_max_rel": cmp, "norm_rel_vs_float32": drift,
           "drift_ratio_tol": WINO_DRIFT_RATIO,
           "cg_iters": iters,
           "cg_resid": {k: res[k][1]["cg_resid"] for k in variants},
           "median_wall_ms": {k: float(np.median(walls[k])) for k in variants},
           "reps": NFE_REPS, "winograd_launches_per_nfe": per_nfe,
           "profiled_wall_ms": 1e3 * t_prof,
           "device_busy_ms": busy_ms if kernels else "not measured",
           "device_ms_by_kind": by_kind,
           "winograd_device_ms_per_nfe": by_kind.get("winograd", 0.0)
           if kernels else "not measured",
           "device_idle_share": (1 - busy_ms / t_k) if kernels
           else "not measured",
           "top_kernels_ms": [[round(k[0], 4), k[1], k[2][:80]]
                              for k in kernels[:10]],
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(rec)
    fails = [f"drift {q}: kernels {drift['kernel'][q]}, {k} {drift[k][q]}"
             for q in ref for k in ("plain", "direct")
             if not drift["kernel"][q] <= WINO_DRIFT_RATIO * drift[k][q]]
    if abs(iters["kernel"] - iters["plain"]) > 2:
        fails.append(f"CG iterations {iters}")
    if fails:
        raise AssertionError(f"{name}: {fails}")
    return dict(per_nfe)


def run_blur_sr_slices(dev, n: int = BLUR_SR_N):
    """Phase 10: the slices of bench.py's grid on the blur and SR operators
    (configs/*.yaml), each with its own check beyond run_slice's. Returns
    the DWT launch counts of the DWT-Var deblur slice, and per NFE phase of
    phase 11 its (guidance config, v2, slice pieces)."""
    import torch

    import bench_torch
    from kdip_tpu_torch import guidance as gd
    convert = gd.GuidanceConfig("I", "convert")
    blur = load_op_config("gaussian_deblur_config.yaml")

    rec, _ = run_slice("slice_gaussian_deblur_convert", dev, False, convert,
                       seed=3, n=n, op_cfg=blur)
    emit(rec)
    check_no_dwt(rec)
    # the same slice (weights, measurement, draws) with the CG warm start
    warm, _ = run_slice("slice_gaussian_deblur_convert_warm", dev, False,
                        gd.GuidanceConfig("I", "convert", cg_warm_start=True),
                        seed=3, n=n, op_cfg=blur)
    warm["cold"] = {k: rec[k] for k in ("cg_total_iters", "ms_per_nfe",
                                        "cg_max_residual")}
    warm["cg_iters_warm_over_cold"] = (warm["cg_total_iters"]
                                       / rec["cg_total_iters"])
    emit(warm)
    check_no_dwt(warm)

    rec, parts = run_slice("slice_motion_deblur_convert", dev, False, convert,
                           seed=4, n=n, op_cfg=load_op_config(
                               "motion_deblur_config.yaml",
                               kernel_path=bench_torch.MOTION_PSF))
    k = parts[2].kernel
    rec["psf"] = {"shape": list(k.shape), "sum": float(k.double().sum())}
    emit(rec)
    check_no_dwt(rec)
    if tuple(k.shape) != (61, 61) or abs(rec["psf"]["sum"] - 1) > 1e-5:
        raise AssertionError(f"motion PSF {rec['psf']}")
    del parts

    rec, _ = run_slice("slice_sr4x_convert", dev, False, convert, seed=5, n=n,
                       op_cfg=load_op_config(
                           "super_resolution_4x_config.yaml"))
    emit(rec)
    check_no_dwt(rec)
    if rec["y_shape"] != [1, 3, SIZE // 4, SIZE // 4]:
        raise AssertionError(f"SR measurement {rec['y_shape']}")

    tmpd_cfg = gd.GuidanceConfig("I", "tmpd")
    tmpd_rec, tmpd_parts = run_slice("slice_gaussian_deblur_tmpd", dev,
                                     False, tmpd_cfg, seed=6, n=TMPD_N,
                                     op_cfg=blur)
    emit(tmpd_rec)
    check_no_dwt(tmpd_rec)
    # a CG solve at every NFE, each at least one iteration
    if tmpd_rec["cg_total_iters"] < tmpd_rec["nfe"]:
        raise AssertionError(f"tmpd: {tmpd_rec['cg_total_iters']} CG "
                             f"iterations over {tmpd_rec['nfe']} NFEs")
    torch.cuda.empty_cache()

    dwt_cfg = gd.GuidanceConfig("I", ortho_tf_type="dwt", mle_sigma_thres=1.0)
    rec, dwt_parts = run_slice("slice_gaussian_deblur_dwt_var", dev, True,
                               dwt_cfg, seed=7, n=n, op_cfg=blur)
    emit(rec)
    launches = rec["dwt_launches"]
    want = rec["cg_total_iters"] + n * guided_nfes_below(
        dwt_cfg.mle_sigma_thres)
    if launches != {"haar_dwt2": 0, "haar_idwt2": 0, "haar_ot_matvec": want}:
        raise AssertionError(f"DWT-Var deblur: launches {launches}, "
                             f"expected {want} fused matvecs and no other")
    return launches, {"nfe_tmpd": (tmpd_cfg, False, tmpd_parts),
                      "nfe_deblur_dwt_var": (dwt_cfg, True, dwt_parts)}


def check_no_dwt(rec) -> None:
    if sum(rec["dwt_launches"].values()):
        raise AssertionError(f"{rec['phase']} launched the DWT kernel: "
                             f"{rec['dwt_launches']}")


def run_type_ii_and_dct_slices(dev, n: int = TYPE_II_DCT_N):
    """slice_typeII_dwt_var and slice_dct_var: the DWT-Var model with Type-II
    guidance (its step W^-1(W mat * theta) one fused no-mask matvec at each
    guided call below the threshold, the CG's masked matvec one launch an
    iteration and one a solve), and the DCT-Var configuration
    (configs/test_ffhq_dct.json under --v2: its ortho_tf_type, threshold
    1.0, Type-I), which launches no DWT. Returns {slice: DWT launches}."""
    from kdip_tpu_torch import config
    from kdip_tpu_torch import guidance as gd
    type2 = gd.GuidanceConfig("II", ortho_tf_type="dwt", mle_sigma_thres=1.0)
    rec, _ = run_slice("slice_typeII_dwt_var", dev, True, type2, seed=8, n=n)
    below = n * guided_nfes_below(type2.mle_sigma_thres)
    want = {"mask": rec["cg_total_iters"] + below, "no_mask": below}
    rec["ot_matvec_expected"] = want
    emit(rec)
    launches = rec["dwt_launches"]
    if (rec["ot_matvec_by_mode"] != want or launches["haar_dwt2"]
            or launches["haar_idwt2"]):
        raise AssertionError(f"Type-II DWT-Var: launches {launches}, by mode "
                             f"{rec['ot_matvec_by_mode']}, expected {want}")
    model_cfg = config.load_config(config_path("test_ffhq_dct.json"))["model"]
    dct = gd.GuidanceConfig("I", ortho_tf_type=model_cfg["ortho_tf_type"],
                            mle_sigma_thres=1.0)
    rec_dct, _ = run_slice("slice_dct_var", dev, True, dct, seed=9, n=n,
                           model_config="test_ffhq_dct.json")
    emit(rec_dct)
    check_no_dwt(rec_dct)
    if dct.ortho_tf_type != "dct" or rec_dct["cg_total_iters"] <= 0:
        raise AssertionError(f"DCT-Var: {dct.ortho_tf_type}, "
                             f"{rec_dct['cg_total_iters']} CG iterations")
    return {"slice_typeII_dwt_var": launches,
            "slice_dct_var": rec_dct["dwt_launches"]}


def run_iso_slices(dev, n: int = 1):
    """The baselines of quick_start/ on the V1 UNet and p=0.5 inpainting,
    Heun-50, n samples, each as its script runs it: pgdm (--ode), dps
    (zeta 1, --ode), diffpir (lambda 1, churn) and Type-I with the
    analytic covariance (--ode; RECON_MSE). Every solve is the closed form:
    no CG iteration, no DWT launch. Returns ({slice: DWT launches}, the
    pgdm slice's pieces for nfe_stsl)."""
    from kdip_tpu_torch import guidance as gd
    G = gd.GuidanceConfig
    slices = {
        "slice_pgdm": (G("pgdm", "pgdm"), dict(ode=True)),
        "slice_dps": (G("dps", "dps", zeta=1.0), dict(ode=True)),
        "slice_diffpir": (G("diffpir", "diffpir", lambda_=1.0), {}),
        "slice_analytic_I": (G("I", "analytic"),
                             dict(ode=True, recon_mse=RECON_MSE)),
    }
    launches, keep = {}, None
    for i, (name, (gcfg, kw)) in enumerate(slices.items()):
        rec, parts = run_slice(name, dev, False, gcfg, seed=20 + i, n=n, **kw)
        emit(rec)
        check_no_dwt(rec)
        if rec["cg_total_iters"] or rec["cg_max_residual"]:
            raise AssertionError(f"{name}: a CG ran ({rec['cg_total_iters']}"
                                 f" iterations)")
        launches[name] = rec["dwt_launches"]
        if keep is None:
            keep = parts
    return launches, keep


def phase_nfe_traced(name, dev, gcfg, v2: bool, parts,
                     sigma: float = BLUR_NFE_SIGMA):
    """One guided NFE at `sigma`: phase 11's of a deblur slice at
    BLUR_NFE_SIGMA (below every threshold, so a CG solve whose matvec runs
    four cuFFT transforms; for tmpd also the ones-vjp on the retained
    graph), and nfe_stsl's. Untraced median wall over NFE_REPS calls after
    a warm-up, and the peak memory; then one traced call for the device's
    busy time by kind. For tmpd, its variance's range at
    TMPD_THETA_SIGMAS."""
    import torch
    from kdip_tpu_torch import guidance as gd
    model, tables, op, meas, x_true = parts
    make = gd.make_openai_v2_uncond if v2 else gd.make_openai_uncond
    uncond, var_fn = make(model, tables, gcfg)
    g = torch.Generator(device=dev).manual_seed(9)
    den = gd.make_condition_denoiser(uncond, var_fn, op, meas, gcfg, v2=v2,
                                     with_info=True, generator=g)
    x = x_true + sigma * torch.randn(x_true.shape, generator=g, device=dev)
    walls, iters = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for rep in range(NFE_REPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, info = den(x, sigma)
        torch.cuda.synchronize()
        if rep:
            walls.append(1e3 * (time.perf_counter() - t0))
        iters.append(info["cg_iters"])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if out.shape != x.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{name}: bad output {tuple(out.shape)}")

    def traced_nfe():
        den(x, sigma)
        torch.cuda.synchronize()
    kernels = device_events_by_name(trace_device_events(traced_nfe))
    busy_ms = sum(k[0] for k in kernels)
    t_med = float(np.median(walls))
    rec = {"phase": name, "guidance": gcfg.guidance, "sigma": sigma,
           "operator": op.name,
           "cg_iters": iters, "cg_resid": info["cg_resid"],
           "median_wall_ms": t_med, "reps": NFE_REPS, "peak_mem_gib": peak,
           "device_busy_ms": busy_ms if kernels else "not measured",
           "device_busy_share": busy_ms / t_med if kernels
           else "not measured",
           "device_ms_by_kind": device_ms_by_kind(kernels),
           "fft_launches": sum(n for _, n, k in kernels if "fft" in k),
           "device_idle_share": (1 - busy_ms / t_med) if kernels
           else "not measured",
           "top_kernels_ms": [[round(k[0], 4), k[1], k[2][:80]]
                              for k in kernels[:10]]}
    if gcfg.x0_cov_type == "tmpd" and not v2:
        rec["theta"] = {}
        for s in TMPD_THETA_SIGMAS:
            xs = (x_true + s * torch.randn(x_true.shape, generator=g,
                                           device=dev)).requires_grad_(True)
            with torch.enable_grad():
                m, aux = uncond(xs, s)
                theta = var_fn(aux, s, lambda ct: torch.autograd.grad(
                    m, xs, ct)[0], xs.shape)
            rec["theta"][str(s)] = {
                "min": theta.min().item(), "max": theta.max().item(),
                "negative_share": (theta < 0).float().mean().item()}
    emit(rec)


def run_autoi_slice(dev, n: int = AUTOI_N):
    """slice_autoI_dwt_var: the DWT-Var model (configs/test_ffhq_dwt.json
    under --v2 --guidance autoI: threshold 1.0, AUTOI_PROBES probes),
    Heun-50 with churn, n samples against one measurement. Every guided
    call (one a sample under the per-sample loop) runs the standalone
    forward DWT 1 + P times (the r-solve's W^T A^T alpha, one a probe) and
    the inverse P times (one a probe), above the threshold too; below it
    each of its 1 + P solves launches the fused no-mask matvec once an
    iteration and once for the first residual (above it K is theta * u).
    The calls' sigmas and iterations are recorded from
    autoi.auto_type_I_guidance as it runs, and the launches must equal
    those counts exactly. Returns the launches and (config, pieces)."""
    from kdip_tpu_torch import autoi
    from kdip_tpu_torch import guidance as gd
    gcfg = gd.GuidanceConfig("autoI", ortho_tf_type="dwt",
                             mle_sigma_thres=1.0, num_probes=AUTOI_PROBES)
    calls = []
    orig = autoi.auto_type_I_guidance

    def recorded(*args, **kw):
        out = orig(*args, **kw)
        calls.append((args[6], out[2]))     # (sigma, CG iterations)
        return out
    autoi.auto_type_I_guidance = recorded
    try:
        rec, parts = run_slice("slice_autoI_dwt_var", dev, True, gcfg,
                               seed=30, n=n)
    finally:
        autoi.auto_type_I_guidance = orig
    p = gcfg.num_probes
    below = [k for sig, k in calls if sig < gcfg.mle_sigma_thres]
    want = {"haar_dwt2": len(calls) * (1 + p), "haar_idwt2": len(calls) * p,
            "haar_ot_matvec": sum(k + 1 + p for k in below)}
    rec.update({"num_probes": p, "guided_calls": len(calls),
                "guided_calls_below": len(below),
                "cg_iters_below": sum(below), "dwt_launches_expected": want,
                "dwt_launches_per_call": {k: v / len(calls)
                                          for k, v in want.items()}})
    emit(rec)
    if (len(calls) != rec["nfe"] or rec["dwt_launches"] != want
            or rec["ot_matvec_by_mode"]["mask"]):
        raise AssertionError(f"autoI DWT-Var: {len(calls)} calls of "
                             f"{rec['nfe']}, launches {rec['dwt_launches']}, "
                             f"by mode {rec['ot_matvec_by_mode']}, expected "
                             f"{want}")
    return rec["dwt_launches"], (gcfg, parts)


def autoi_denoisers(gcfg, parts):
    """(the port's autoI denoiser, the same on PlainDWT) of a slice's
    pieces."""
    from kdip_tpu_torch import guidance as gd
    model, tables, op, meas, _ = parts
    uncond, var_fn = gd.make_openai_v2_uncond(model, tables, gcfg)
    return tuple(gd.make_condition_denoiser(
        uncond, var_fn, op, meas, gcfg, v2=True, with_info=True,
        ortho_tf=ot) for ot in (None, PlainDWT()))


def phase_nfe_autoi(dev, gcfg, parts, sigma: float = AUTOI_NFE_SIGMA):
    """nfe_autoI: one autoI NFE below the threshold with the kernel DWT and
    with the plain DWT on the same probes, NFE_REPS times each in turns
    after a warm-up: hat_x0 within NFE_TOL (phase 4's reasons, over 1 + P
    solves), CG iterations within 2 a solve; the kernel call's launches
    exactly 1 + P forward, P inverse and iterations + 1 + P fused no-mask
    matvecs, the plain call's none. The kernel call is then traced: busy
    share, device ms by kind, the Haar DWT's device ms, peak memory."""
    import torch
    from kdip_tpu_torch import autoi
    from kdip_tpu_torch.ops import dwt as D
    _, _, _, _, x_true = parts
    den_k, den_p = autoi_denoisers(gcfg, parts)
    p = gcfg.num_probes
    g = torch.Generator(device=dev).manual_seed(31)
    x = x_true + sigma * torch.randn(x_true.shape, generator=g, device=dev)
    probes = [autoi.rademacher(x.shape, g, dev) for _ in range(p)]
    walls = {"kernel": [], "plain": []}
    res, launches = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for rep in range(NFE_REPS + 1):
        for k, den in (("kernel", den_k), ("plain", den_p)):
            D.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[k] = den(x, sigma, probes=probes)
            torch.cuda.synchronize()
            if rep:
                walls[k].append(1e3 * (time.perf_counter() - t0))
            launches[k] = dict(D.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    (out_k, info_k), (out_p, info_p) = res["kernel"], res["plain"]
    want = {"haar_dwt2": 1 + p, "haar_idwt2": p,
            "haar_ot_matvec": info_k["cg_iters"] + 1 + p}
    diff = (out_k - out_p).abs().max().item()
    t_k = float(np.median(walls["kernel"]))

    def traced_nfe():
        den_k(x, sigma, probes=probes)
        torch.cuda.synchronize()
    kernels = device_events_by_name(trace_device_events(traced_nfe))
    busy_ms = sum(k[0] for k in kernels)
    by_kind = device_ms_by_kind(kernels)
    rec = {"phase": "nfe_autoI", "sigma": sigma, "num_probes": p,
           "max_abs_diff": diff, "tol": NFE_TOL,
           "cg_iters": [info_k["cg_iters"], info_p["cg_iters"]],
           "cg_resid": [info_k["cg_resid"], info_p["cg_resid"]],
           "launches": launches, "launches_expected": want,
           "median_wall_ms": {k: float(np.median(v)) for k, v in
                              walls.items()}, "reps": NFE_REPS,
           "peak_mem_gib": peak,
           "device_busy_ms": busy_ms if kernels else "not measured",
           "device_busy_share": busy_ms / t_k if kernels else "not measured",
           "device_idle_share": (1 - busy_ms / t_k) if kernels
           else "not measured",
           "device_ms_by_kind": by_kind,
           "haar_dwt_device_ms": by_kind.get("haar_dwt", 0.0) if kernels
           else "not measured",
           "top_kernels_ms": [[round(k[0], 4), k[1], k[2][:80]]
                              for k in kernels[:10]]}
    emit(rec)
    fails = []
    if launches["kernel"] != want or sum(launches["plain"].values()):
        fails.append(f"launches {launches}, expected {want} and none")
    if not diff <= NFE_TOL:
        fails.append(f"|kernel - plain| {diff} > {NFE_TOL}")
    if abs(info_k["cg_iters"] - info_p["cg_iters"]) > 2 * (1 + p):
        fails.append(f"CG iterations {rec['cg_iters']}")
    if not max(info_k["cg_resid"], info_p["cg_resid"]) <= gcfg.cg_tol:
        fails.append(f"CG residuals {rec['cg_resid']}")
    if fails:
        raise AssertionError(f"nfe_autoI: {fails}")


def phase_nfe_loglikelihood(dev, gcfg, parts, sigma: float = AUTOI_NFE_SIGMA):
    """nfe_loglikelihood: one denoise.loglikelihood at `sigma` (a CG solve
    for the quadratic term, then SLQ over P probes of LL_LANCZOS Lanczos
    steps, each a fused no-mask matvec), with the kernel DWT and the plain
    DWT on the same probes, in turns: the value, the gap between the two
    within LL_TOL * d, both CG residuals within cg_tol, the wall time, and
    the launches (the kernel's: at least P * LL_LANCZOS + 1 matvecs and no
    standalone transform; the plain's: none)."""
    import torch
    from kdip_tpu_torch import autoi
    from kdip_tpu_torch.ops import dwt as D
    _, _, _, meas, x_true = parts
    den_k, den_p = autoi_denoisers(gcfg, parts)
    p = gcfg.num_probes
    g = torch.Generator(device=dev).manual_seed(32)
    x = x_true + sigma * torch.randn(x_true.shape, generator=g, device=dev)
    probes = [autoi.rademacher(meas.y.shape, g, dev) for _ in range(p)]
    out, walls, launches = {}, {}, {}
    for k, den in (("kernel", den_k), ("plain", den_p), ("kernel", den_k)):
        D.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ll, resid = den.loglikelihood(x, sigma, probes=probes,
                                      lanczos_iters=LL_LANCZOS)
        ll = ll.item()
        walls.setdefault(k, []).append(1e3 * (time.perf_counter() - t0))
        out[k] = (ll, resid)
        launches[k] = dict(D.launch_counts)
    d = meas.y.numel()
    gap = abs(out["kernel"][0] - out["plain"][0])
    rec = {"phase": "nfe_loglikelihood", "sigma": sigma, "num_probes": p,
           "lanczos_iters": LL_LANCZOS, "d": d,
           "ll": {k: v[0] for k, v in out.items()},
           "cg_resid": {k: v[1] for k, v in out.items()},
           "abs_gap": gap, "gap_per_d": gap / d,
           "rel_gap": gap / abs(out["plain"][0]), "tol_per_d": LL_TOL,
           "wall_ms": walls, "launches": launches}
    emit(rec)
    fails = []
    if not all(np.isfinite(v[0]) and v[1] <= gcfg.cg_tol
               for v in out.values()):
        fails.append(f"values {out}")
    if not gap <= LL_TOL * d:
        fails.append(f"gap {gap} > {LL_TOL} * {d}")
    lk = launches["kernel"]
    if (lk["haar_dwt2"] or lk["haar_idwt2"]
            or lk["haar_ot_matvec"] < p * LL_LANCZOS + 1
            or sum(launches["plain"].values())):
        fails.append(f"launches {launches}")
    if fails:
        raise AssertionError(f"nfe_loglikelihood: {fails}")


class BlurNet:
    """The nonlinear blur's network in slice_nonlinear_blur_dps, a small
    seeded stand-in for the external bkse KernelWizard (none is in the
    repo, and the card's machine has no network): a 5x5 box blur of
    x01 plus a residual of two 5x5 convs (3 -> 16 -> 3) whose hidden gains
    a projection of the (1, 512, 2, 2) kernel sets."""

    def __init__(self, dev, seed: int, width: int = 16):
        import torch
        g = torch.Generator(device=dev).manual_seed(seed)

        def draw(*shape, scale):
            return torch.randn(shape, generator=g, device=dev) * scale
        self.w1 = draw(width, 3, 5, 5, scale=75 ** -0.5)
        self.w2 = draw(3, width, 5, 5, scale=0.1 * (25 * width) ** -0.5)
        self.proj = draw(width, 2048, scale=2048 ** -0.5)
        self.box = torch.full((3, 1, 5, 5), 1 / 25, device=dev)

    def __call__(self, x01, kernel):
        import torch
        import torch.nn.functional as F
        gain = 1 + 0.5 * torch.tanh(self.proj @ kernel.reshape(-1))
        h = F.silu(F.conv2d(x01, self.w1, padding=2) * gain[:, None, None])
        return (F.conv2d(x01, self.box, padding=2, groups=3)
                + F.conv2d(h, self.w2, padding=2))


def poisson_measure(op, x, g):
    """y = poisson(A x) (rate 1): the nonlinear blur slice's measurement,
    through the operator's own kernel."""
    from kdip_tpu_torch import operators
    return operators.Measurement(y=operators.get_noise("poisson")(
        op.forward(x), generator=g))


def run_nonlinear_slices(dev):
    """slice_phase_retrieval_dps (the V1 UNet, dps zeta 1, Euler-50 with
    churn, n=1; oversample 1.0, so y and the FFTs are 320 px) and
    slice_nonlinear_blur_dps (dps zeta 1, DPM++(2M)-25, n=1, poisson noise
    on y, BlurNet): no mat solver, so no CG and no DWT. Returns {slice:
    DWT launches}."""
    from kdip_tpu_torch import guidance as gd
    dps = gd.GuidanceConfig("dps", "dps", zeta=1.0)
    pr, _ = run_slice("slice_phase_retrieval_dps", dev, False, dps, seed=40,
                      n=1, sampler="euler",
                      op_cfg=dict(name="phase_retrieval", oversample=1.0,
                                  sigma_s=0.05))
    emit(pr)
    nb, _ = run_slice("slice_nonlinear_blur_dps", dev, False, dps, seed=42,
                      n=1, sampler="dpmpp_2m", steps=NONLINEAR_STEPS,
                      op_cfg=dict(name="nonlinear_blur", sigma_s=0.05,
                                  blur_apply=BlurNet(dev, seed=41)),
                      measure=poisson_measure)
    emit(nb)
    for rec in (pr, nb):
        check_no_dwt(rec)
        if rec["cg_total_iters"]:
            raise AssertionError(f"{rec['phase']}: a CG ran")
    if pr["y_shape"] != [1, 3, SIZE + 64, SIZE + 64]:
        raise AssertionError(f"phase retrieval: y {pr['y_shape']}")
    return {rec["phase"]: rec["dwt_launches"] for rec in (pr, nb)}


def run_batched_twin(name, twin, dev, v2: bool, gcfg, seed: int):
    """The `twin` slice's configuration and seeds with per_sample_map=False
    and BATCHED_N samples: they go through the UNet, the vjp and the CG as
    one batch, one solve per guided call. Emits the record, with the
    per-sample twin's numbers (N_SAMPLES samples) and the batched /
    per-sample ms/NFE ratio beside it."""
    rec, _ = run_slice(name, dev, v2, gcfg, seed=seed, n=BATCHED_N,
                       per_sample_map=False)
    rec["per_sample"] = {k: twin[k] for k in (
        "ms_per_nfe", "samples_per_s", "cg_total_iters", "cg_max_residual",
        "peak_mem_gib")}
    rec["batched_over_per_sample_ms"] = rec["ms_per_nfe"] / twin["ms_per_nfe"]
    emit(rec)
    return rec


def random_lpips_npz(path: str, seed: int = 0) -> None:
    """Seeded random LPIPS-VGG weights in the npz that `kdip_tpu`'s
    --lpips-weights reads: its param tree (HWIO conv kernels, He-scaled;
    non-negative lin weights) under "params"."""
    from kdip_tpu_torch.metrics import VGG16_CFG
    rng = np.random.default_rng(seed)
    params, c_in, i = {}, 3, 0
    for c in VGG16_CFG:
        if c == "M":
            continue
        params[f"conv{i}"] = {
            "kernel": (rng.standard_normal((3, 3, c_in, c), np.float32)
                       * np.float32(np.sqrt(2.0 / (9 * c_in)))),
            "bias": 0.01 * rng.standard_normal(c, np.float32)}
        c_in, i = c, i + 1
    for j, c in enumerate((64, 128, 256, 512, 512)):
        params[f"lin{j}"] = {
            "kernel": np.abs(0.1 * rng.standard_normal(c, np.float32))}
    np.savez(path, params=np.array(params, dtype=object))


def cli_inputs(tmp: str, name: str, config_name, v2: bool, seed: int,
               n_images: int):
    """A run's inputs in `tmp`: n_images seeded 256 px PNGs written by the
    port's writer, a config whose dataset points at them (a copy of
    configs/`config_name`, or, for a dict, that "model" block merged as
    `config.load_config` merges it), and a checkpoint of seeded random
    weights (std 0.02) of the configured model: a guided-diffusion .pt, or
    with v2 a Lightning .ckpt of ADMUNetV2 under `model_ema.`, or for an
    image_v2 config a k-diffusion .pt. Returns (config path, checkpoint
    path, the Winograd launches per guided NFE of that model, the merged
    config's model type)."""
    import torch
    from kdip_tpu_torch import config, data, weights
    from kdip_tpu_torch.models import adm
    root = os.path.join(tmp, name)
    os.makedirs(os.path.join(root, "val"))
    rng = np.random.default_rng(seed)
    for i in range(n_images):
        data.write_png(os.path.join(root, "val", f"{i:05d}.png"),
                       rng.integers(0, 256, (SIZE, SIZE, 3), np.uint8))
    cfg = config.load_config(config_path(config_name)
                             if isinstance(config_name, str)
                             else {"model": config_name})
    cfg["dataset"] = dict(cfg["dataset"], location=os.path.join(root, "val"))
    cfg_path = os.path.join(root, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    if cfg["model"]["type"] == "image_v2":
        torch.manual_seed(seed)  # the Fourier features' buffer
        model = config.make_model(cfg, device="cpu")
        per_nfe = {"winograd_conv3x3": 0, "winograd_conv3x3_fused": 0}
    else:
        model, _ = config.make_openai_model(cfg["model"], device="cpu")
        per_nfe = winograd_per_nfe(model)
    if v2:
        model = adm.ADMUNetV2(model)
    sd = weights.randomize_(model, seed).state_dict()
    if v2:
        ckpt = os.path.join(root, "model.ckpt")
        torch.save({"state_dict": {f"model_ema.{k}": v
                                   for k, v in sd.items()}}, ckpt)
    else:
        ckpt = os.path.join(root, "model.pt")
        torch.save(sd, ckpt)
    del model, sd
    return cfg_path, ckpt, per_nfe, cfg["model"]["type"]


class CliProbe:
    """Records what one in-process CLI run does, with the module functions
    it calls wrapped for the run: every sampler call's CG info and output
    range (sampling_api.build_posterior_sampler; under --dp, each call on
    this rank's block), each scored image's sample as the CLI scores it
    (metrics.compute_metrics: on rank 0, the gathered samples), LPIPS's
    device time (metrics.lpips_vgg, synchronised), the run's stdout, peak
    memory and the kernels' launch counts, reset just before `main`."""

    def __init__(self):
        self.calls, self.lpips_s, self.stdout = [], [], ""
        self.samples = []

    def run(self, argv):
        import contextlib
        import io

        import torch
        from kdip_tpu_torch import metrics, sampling_api
        from kdip_tpu_torch.cli import sample_condition
        from kdip_tpu_torch.ops import dwt as D
        from kdip_tpu_torch.ops import winograd as Wg
        build, lpips = sampling_api.build_posterior_sampler, metrics.lpips_vgg
        score = metrics.compute_metrics

        def built(*a, **kw):
            sample = build(*a, **kw)

            def recorded(*sa, **skw):
                out, info = sample(*sa, **skw)
                self.calls.append({
                    "n": out.shape[0], "cg_total_iters": info["cg_total_iters"],
                    "cg_max_residual": info["cg_max_residual"],
                    "finite": bool(torch.isfinite(out).all()),
                    "max_abs_out": out.abs().max().item()})
                return out, info
            return recorded

        def scored(hat_x0, *a, **kw):
            self.samples.append(hat_x0.detach().float().cpu())
            return score(hat_x0, *a, **kw)

        def timed_lpips(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = lpips(*a, **kw)
            torch.cuda.synchronize()
            self.lpips_s.append(time.perf_counter() - t0)
            return out
        sampling_api.build_posterior_sampler = built
        metrics.lpips_vgg = timed_lpips
        metrics.compute_metrics = scored
        buf = io.StringIO()
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            D.reset_launch_counts()
            Wg.reset_launch_counts()
            with contextlib.redirect_stdout(buf):
                avg = sample_condition.main(argv)
            torch.cuda.synchronize()
        finally:
            sampling_api.build_posterior_sampler = build
            metrics.lpips_vgg = lpips
            metrics.compute_metrics = score
            self.stdout = buf.getvalue()
        self.dwt_launches = dict(D.launch_counts)
        self.winograd_launches = dict(Wg.launch_counts)
        self.peak_mem_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        return avg


def run_cli(name, tmp, lpips_npz, config_name, v2: bool, winograd: bool,
            n_images: int, seed: int, dtype: str = "bfloat16",
            want_per_nfe=None):
    """`kdip_tpu_torch.cli.sample_condition.main` in-process at full width
    on inpainting (configs/inpainting_config.yaml): Heun-50 with churn, -n
    1, a `dtype` torso, --save-img, LPIPS; then the same logdir with
    --resume, which must run no image and reproduce avg_metrics' psnr,
    ssim and lpips bit for bit. `config_name` is a configs/ file, or an
    image_v2 "model" block (cli_inputs). Checks every image's metrics are
    finite and its samples finite and in [-1, 1]; with v2 or an image_v2
    config (both solve through the DWT covariance) the fused matvec's
    launches are the run's CG iterations plus one per solve and no
    standalone DWT launches; with winograd, the model's Winograd launches
    per guided NFE, which must be `want_per_nfe`. The CLI runs on its
    default device, the card. Returns the record and the first run's
    probe."""
    from kdip_tpu_torch import config
    cfg_path, ckpt, per_nfe, model_type = cli_inputs(
        tmp, name, config_name, v2, seed, n_images)
    dwt = v2 or model_type == "image_v2"
    logdir = os.path.join(tmp, name, "logs")
    argv = ["--checkpoint", ckpt, "--config", cfg_path,
            "--operator-config", config_path("inpainting_config.yaml"),
            "--logdir", logdir, "--steps", str(STEPS), "-n", "1",
            "--dtype", dtype, "--save-img", "--lpips-weights",
            lpips_npz, "--seed", str(seed)]
    argv += ["--v2"] if v2 else []
    argv += ["--winograd"] if winograd else []
    probe = CliProbe()
    avg = probe.run(argv)
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        rows = [json.loads(ln) for ln in f][1:]
    pngs = sorted(p for p in os.listdir(logdir) if p.endswith(".png"))
    cg_line = [ln for ln in probe.stdout.splitlines()
               if ln.startswith("CG solves:")]
    iters = sum(c["cg_total_iters"] for c in probe.calls)
    nfe = n_images * (2 * STEPS - 1)
    rec = {"phase": name, "config": config_name, "v2": v2,
           "winograd": winograd, "dtype": dtype, "images": n_images,
           "steps": STEPS,
           "wall_clock_per_image": avg["wall_clock_per_image"],
           "ms_per_nfe": 1e3 * avg["wall_clock_per_image"] * n_images / nfe,
           "avg_metrics": {k: v for k, v in avg.items() if k != "lpips_note"},
           "per_image": rows, "cg_line": cg_line,
           "cg_total_iters": iters, "sampler_calls": probe.calls,
           "peak_mem_gib": probe.peak_mem_gib,
           "lpips_ms_per_image": 1e3 * sum(probe.lpips_s) / n_images,
           "dwt_launches": probe.dwt_launches,
           "winograd_launches": probe.winograd_launches,
           "saved_pngs": len(pngs)}
    if len(rows) != n_images or len(probe.calls) != n_images:
        raise AssertionError(f"{name}: {len(rows)} journal lines, "
                             f"{len(probe.calls)} sampler calls")
    if not all(np.isfinite(r[k]) for r in rows for k in ("psnr", "ssim",
                                                          "lpips")):
        raise AssertionError(f"{name}: a metric is not finite: {rows}")
    for c in probe.calls:
        # the last Euler step's rounding may pass 1 by float32 ulps
        if not c["finite"] or c["max_abs_out"] > 1 + 1e-5:
            raise AssertionError(f"{name}: sample out of [-1, 1]: {c}")
    if len(cg_line) != 1 or len(pngs) != 2 * n_images:
        raise AssertionError(f"{name}: CG line {cg_line}, {len(pngs)} PNGs")
    solves = n_images * guided_nfes_below(1.0) if dwt else 0
    want_dwt = {"haar_dwt2": 0, "haar_idwt2": 0, "haar_ot_matvec":
                iters + solves if dwt else 0}
    want_wino = ({k: v * nfe for k, v in per_nfe.items()} if winograd
                 else {k: 0 for k in probe.winograd_launches})
    rec["cg_solves"] = solves
    if probe.dwt_launches != want_dwt or probe.winograd_launches != want_wino:
        raise AssertionError(f"{name}: launches {probe.dwt_launches} "
                             f"{probe.winograd_launches}, expected "
                             f"{want_dwt} {want_wino}")
    if winograd and per_nfe != want_per_nfe:
        raise AssertionError(f"{name}: {per_nfe} Winograd launches per "
                             f"NFE, expected {want_per_nfe}")
    rec["winograd_launches_per_nfe"] = per_nfe if winograd else None

    again = CliProbe()
    avg2 = again.run(argv + ["--resume"])
    same = {k: avg2[k] == avg[k] for k in ("psnr", "ssim", "lpips")}
    rec["resume"] = {"sampler_calls": len(again.calls),
                     "dwt_launches": again.dwt_launches,
                     "winograd_launches": again.winograd_launches,
                     "bit_equal": same}
    if (again.calls or sum(again.dwt_launches.values())
            or sum(again.winograd_launches.values()) or not all(same.values())
            or "resume: {} images already done".format(n_images)
            not in again.stdout):
        raise AssertionError(f"{name}: --resume {rec['resume']}")
    saved = config.load_yaml(os.path.join(logdir, "avg_metrics.yaml"))
    if saved["psnr"] != avg["psnr"]:
        raise AssertionError(f"{name}: avg_metrics.yaml {saved}")
    emit(rec)
    return rec, probe


def training_folder(root: str, seed: int) -> str:
    """TRAIN_IMAGES seeded 256 px PNGs and TRAIN_RESIZED at 288 x 320 (the
    port's writer), in root/images; returns that folder."""
    from kdip_tpu_torch import data
    folder = os.path.join(root, "images")
    os.makedirs(folder)
    rng = np.random.default_rng(seed)
    for i in range(TRAIN_IMAGES + TRAIN_RESIZED):
        hw = (SIZE, SIZE) if i < TRAIN_IMAGES else (288, 320)
        data.write_png(os.path.join(folder, f"{i:05d}.png"),
                       rng.integers(0, 256, hw + (3,), np.uint8))
    return folder


def write_config(path: str, name: str, location: str, **model) -> str:
    """configs/`name`, merged by `config.load_config`, its dataset at
    `location` and `model`'s keys set in its "model" block, written to
    `path`; returns path."""
    from kdip_tpu_torch import config
    cfg = config.load_config(config_path(name))
    cfg["model"].update(model)
    cfg["dataset"] = dict(cfg["dataset"], location=location)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


class TrainProbe:
    """One in-process run of `cli.train_openai.main`: each call of the
    train step timed (synchronised) with its DWT launches, the run's
    launch counts (reset just before main), peak memory and stdout."""

    def run(self, argv):
        import contextlib
        import io

        import torch
        from kdip_tpu_torch import train
        from kdip_tpu_torch.cli import train_openai
        from kdip_tpu_torch.ops import dwt as D
        from kdip_tpu_torch.ops import winograd as Wg
        make, self.steps = train.make_train_step, []

        def made(*a, **kw):
            step = make(*a, **kw)

            def timed(*sa, **skw):
                before = dict(D.launch_counts)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss = float(step(*sa, **skw))
                self.steps.append({
                    "s": time.perf_counter() - t0, "loss": loss,
                    "dwt": {k: v - before[k]
                            for k, v in D.launch_counts.items()}})
                return loss
            return timed
        train.make_train_step = made
        buf = io.StringIO()
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            D.reset_launch_counts()
            Wg.reset_launch_counts()
            with contextlib.redirect_stdout(buf):
                state = train_openai.main(argv)
            torch.cuda.synchronize()
        finally:
            train.make_train_step = make
            self.stdout = buf.getvalue()
        self.dwt_launches = dict(D.launch_counts)
        self.winograd_launches = dict(Wg.launch_counts)
        self.peak_mem_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        return state


def train_loss_kernel_vs_plain(dev, model, log_sigmas):
    """One openai_v2_loss value and its gradient with respect to every
    parameter at [2, 3, 256, 256], with the kernel DWT and with the plain
    version (PlainDWT, dwt2_plain under autograd), on the same inputs:
    the loss within TRAIN_LOSS_RTOL, each gradient tensor within
    TRAIN_GRAD_RTOL of its largest element."""
    import torch
    from kdip_tpu_torch import train, utils
    from kdip_tpu_torch.ops.transforms import OrthoTransform
    g = torch.Generator(device=dev).manual_seed(11)
    x0 = torch.rand((2, 3, SIZE, SIZE), generator=g, device=dev) * 2 - 1
    sigma = utils.rand_v_diffusion((2,), g, 0.5, 1e-2, 80.0)
    noise = torch.randn(x0.shape, generator=g, device=dev)
    params = [p for p in model.parameters()]

    def loss_and_grads(ortho):
        loss = train.openai_v2_loss(model, x0, noise, sigma, log_sigmas,
                                    ortho).mean()
        return loss.item(), torch.autograd.grad(loss, params)
    lk, gk = loss_and_grads(OrthoTransform("dwt"))
    lp, gp = loss_and_grads(PlainDWT())
    worst = max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(gk, gp))
    rec = {"loss_kernel": lk, "loss_plain": lp,
           "loss_rel_err": abs(lk - lp) / abs(lp),
           "worst_grad_err_of_max": worst, "sigma": sigma.tolist()}
    if not (rec["loss_rel_err"] <= TRAIN_LOSS_RTOL
            and worst <= TRAIN_GRAD_RTOL):
        raise AssertionError(f"train loss, kernel vs plain DWT: {rec}")
    return rec


def phase_train_ffhq_dwt(tmp, dev):
    """train_ffhq_dwt: `cli.train_openai.main` in-process on
    configs/train_ffhq_dwt.json at full width (the 93,563,910-parameter
    torso from a seeded `.pt`, plus out_cov), float32, batch TRAIN_B, over
    a folder of seeded PNGs (two of them resized): each TRAIN_RUNS run,
    then the per_sample_map run resumed (first to its own step: the state
    restored exactly; then on to TRAIN_RESUME_TO). Every call of the step
    must launch the forward DWT kernel 2B and the inverse B times under
    per_sample_map (2 and 1 batched), and no Winograd kernel. Then the
    loss and gradient with the kernel against the plain DWT. Returns the
    DWT and Winograd launches of all the runs."""
    import torch
    from kdip_tpu_torch import config, diffusion, weights
    root = os.path.join(tmp, "train_ffhq_dwt")
    os.makedirs(root)
    cfg_path = write_config(os.path.join(root, "config.json"),
                            "train_ffhq_dwt.json",
                            training_folder(root, seed=30))
    unet, _ = config.make_openai_model(
        config.load_config(cfg_path)["model"], device="cpu")
    n_params = sum(p.numel() for p in unet.parameters())
    ckpt = os.path.join(root, "torso.pt")
    torch.save(weights.randomize_(unet, 30).state_dict(), ckpt)
    del unet
    base = ["--config", cfg_path, "--checkpoint", ckpt, "--batch-size",
            str(TRAIN_B), "--seed", "30"]
    total_dwt = {"haar_dwt2": 0, "haar_idwt2": 0, "haar_ot_matvec": 0}
    total_wino = {"winograd_conv3x3": 0, "winograd_conv3x3_fused": 0}
    runs, states = {}, {}
    # (name, argv, --max-steps, logdir, the steps the run takes)
    plan = [(name, extra, steps, name, steps)
            for name, extra, steps in TRAIN_RUNS]
    first_steps = TRAIN_RUNS[0][2]
    plan += [("restored", ("--resume",), first_steps, "per_sample_map", 0),
             ("resumed", ("--resume",), TRAIN_RESUME_TO, "per_sample_map",
              TRAIN_RESUME_TO - first_steps)]
    for name, extra, steps, logname, n_steps in plan:
        probe = TrainProbe()
        states[name] = probe.run(base + list(extra) + [
            "--max-steps", str(steps), "--save-every", str(steps),
            "--logdir", os.path.join(root, logname)])
        per_sample = "--no-per-sample-map" not in extra
        want = ({"haar_dwt2": 2 * TRAIN_B, "haar_idwt2": TRAIN_B,
                 "haar_ot_matvec": 0} if per_sample else
                {"haar_dwt2": 2, "haar_idwt2": 1, "haar_ot_matvec": 0})
        secs = [st["s"] for st in probe.steps]
        rec = {"steps": len(secs), "step_s": secs,
               "s_per_step": (float(np.median(secs[1:])) if len(secs) > 1
                              else (secs[0] if secs else None)),
               "first_step_s": secs[0] if secs else None,
               "losses": [st["loss"] for st in probe.steps],
               "dwt_launches_per_step": want,
               "dwt_launches": probe.dwt_launches,
               "winograd_launches": probe.winograd_launches,
               "peak_mem_gib": probe.peak_mem_gib}
        runs[name] = rec
        bad = [st for st in probe.steps if st["dwt"] != want]
        if (bad or len(secs) != n_steps
                or probe.dwt_launches != {k: v * n_steps
                                          for k, v in want.items()}
                or any(probe.winograd_launches.values())
                or not all(np.isfinite(rec["losses"]))):
            raise AssertionError(f"train_ffhq_dwt {name}: {rec}, {bad}")
        if name in ("restored", "resumed") and "resumed from" not in \
                probe.stdout:
            raise AssertionError(f"train_ffhq_dwt {name}: not resumed")
        for k in total_dwt:
            total_dwt[k] += probe.dwt_launches[k]
        for k in total_wino:
            total_wino[k] += probe.winograd_launches[k]
        torch.cuda.empty_cache()
    first, back = states["per_sample_map"], states["restored"]
    restored = all(torch.equal(a, b) for a, b in zip(
        list(first.model.parameters()) + list(first.ema.parameters()),
        list(back.model.parameters()) + list(back.ema.parameters())))
    if not restored or states["resumed"].step != TRAIN_RESUME_TO:
        raise AssertionError("train_ffhq_dwt: --resume did not restore the "
                             "state")
    del states["per_sample_map"], states["restored"], first, back
    # the config's tables: OPENAI_MODEL_DEFAULTS' 1000 linear steps
    tables = diffusion.make_diffusion(1000, "linear", device=dev)
    check = train_loss_kernel_vs_plain(dev, states["resumed"].model,
                                       tables.log_sigmas)
    del states
    emit({"phase": "train_ffhq_dwt", "config": "train_ffhq_dwt.json",
          "torso_params": n_params, "batch": TRAIN_B,
          "images": [TRAIN_IMAGES, TRAIN_RESIZED], "runs": runs,
          "restored_bit_equal": restored, "kernel_vs_plain": check,
          "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                   "matmul": torch.backends.cuda.matmul.allow_tf32},
          "nvidia_smi": nvidia_smi()})
    return total_dwt, total_wino


def set_dropout_rate(model, p: float) -> None:
    from kdip_tpu_torch.models.layers import Dropout
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = p


def loop_micro_grads(model, tables, micro, t, w, noise, dev, seed: int):
    """One microbatch's rescaled_mse loss (weighted mean) and the gradient
    of every parameter of `model`, float32, its dropout masks drawn from
    seeded_generator(dev, seed) (so alike on every model of the
    architecture); and the Winograd launches of the forward and of the
    backward (its dx), counted apart."""
    import torch
    from kdip_tpu_torch import ddpm_sampling, utils
    from kdip_tpu_torch.models.layers import set_dropout_generator
    from kdip_tpu_torch.ops import winograd as Wg
    set_dropout_generator(model, utils.seeded_generator(dev, seed))
    Wg.reset_launch_counts()
    terms = ddpm_sampling.training_losses(tables, model, micro, t,
                                          loss_type="rescaled_mse",
                                          noise=noise)
    loss = (terms["loss"] * w).mean()
    fwd = dict(Wg.launch_counts)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    bwd = {k: v - fwd[k] for k, v in Wg.launch_counts.items()}
    return loss.item(), [g.float() for g in grads], fwd, bwd


def winograd_per_microbatch(model, live_dropout: bool):
    """The Winograd launches of a training microbatch, forward and
    backward, from the model's blocks. Without live dropout the forward
    is an NFE's (winograd_per_nfe: the plain kernel in each down-block's
    in_conv, the fused one in every other 3x3 conv of a ResBlock); under
    live dropout no conv fuses (kdip_tpu layers.py:311-313), so both of
    each block's convs run the plain kernel. The backward runs the plain
    kernel once a conv (dx, the fused conv's too). FFHQ-256 (30 blocks, 5
    down): 5 + 55 forward at dropout 0, 60 + 0 under dropout; 60 + 0
    backward."""
    from kdip_tpu_torch.models.layers import ResBlock
    blocks = [m for m in model.modules() if isinstance(m, ResBlock)]
    n, down = len(blocks), sum(b.down for b in blocks)
    fwd = ({"winograd_conv3x3": 2 * n, "winograd_conv3x3_fused": 0}
           if live_dropout else
           {"winograd_conv3x3": down, "winograd_conv3x3_fused": 2 * n - down})
    return fwd, {"winograd_conv3x3": 2 * n, "winograd_conv3x3_fused": 0}


def train_loop_compare(loop, dev, image_size: int):
    """One microbatch's loss and every parameter's gradient through the
    loop's bf16 torso three ways, the kernels, their plain versions (each
    conv's `conv_fn`) and the direct cuDNN torso (winograd off), and
    through the float32 masters, the reference; at dropout 0 (both entry
    points and the fused backward) and at the config's rate (the plain
    entry point only), with the same dropout masks on every side. Held:
    the kernels' launches exact, forward and backward apart (none on the
    other sides); the bf16 drift rule of the NFE phases on the gradients,
    the kernels' norm-relative drift from float32 (all gradients as one
    vector) and their worst drift relative to each tensor's largest
    element both at most WINO_DRIFT_RATIO times the plain versions' and
    the direct torso's; each bf16 loss within LOOP_LOSS_RTOL of float32."""
    import torch
    from kdip_tpu_torch.models.layers import Conv2d, Dropout
    from kdip_tpu_torch.ops import winograd as Wg
    comp, master = loop.compute, loop.model.train()
    rate = next(m.p for m in comp.modules() if isinstance(m, Dropout))
    convs = [m for m in comp.modules() if isinstance(m, Conv2d)]
    g = torch.Generator(device=dev).manual_seed(41)
    micro = torch.rand((LOOP_MB, 3, image_size, image_size), generator=g,
                       device=dev) * 2 - 1
    noise = torch.randn(micro.shape, generator=g, device=dev)
    t = torch.linspace(10, 950, LOOP_MB, device=dev).long()
    w = torch.ones(LOOP_MB, device=dev)
    loop._sync_compute()
    out = {}
    for p in (0.0, rate):
        set_dropout_rate(comp, p)
        set_dropout_rate(master, p)
        want_fwd, want_bwd = winograd_per_microbatch(comp, p > 0)
        res = {}
        for side in ("kernel", "plain", "direct", "float32"):
            comp.set_winograd(side != "direct")
            for m in convs:
                m.conv_fn = (Wg.winograd_conv3x3_plain if side == "plain"
                             else None)
            model = master if side == "float32" else comp
            res[side] = loop_micro_grads(model, loop.tables, micro, t, w,
                                         noise, dev, seed=42)
            torch.cuda.empty_cache()
        comp.set_winograd(True)
        for m in convs:
            m.conv_fn = None
        ref_l, ref_g = res["float32"][:2]
        flat_ref = torch.cat([r.reshape(-1) for r in ref_g])

        def drift(grads):
            flat = torch.cat([x.reshape(-1) for x in grads])
            return {"norm_rel": ((flat - flat_ref).norm()
                                 / flat_ref.norm()).item(),
                    "worst_of_tensor_max": max(
                        ((a - b).abs().max() / b.abs().max()).item()
                        for a, b in zip(grads, ref_g))}
        rec = {"dropout": p, "loss": {k: v[0] for k, v in res.items()},
               "grad_drift_from_float32": {k: drift(res[k][1]) for k in (
                   "kernel", "plain", "direct")},
               "kernel_vs_plain_worst_of_tensor_max": max(
                   ((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(res["kernel"][1], res["plain"][1])),
               "winograd_forward": res["kernel"][2],
               "winograd_backward": res["kernel"][3]}
        fails = []
        if (res["kernel"][2], res["kernel"][3]) != (want_fwd, want_bwd):
            fails.append(f"launches {res['kernel'][2:]}, expected "
                         f"{want_fwd}, {want_bwd}")
        for side in ("plain", "direct"):
            if any(res[side][2].values()) or any(res[side][3].values()):
                fails.append(f"{side} launched {res[side][2:]}")
        d = rec["grad_drift_from_float32"]
        for q in ("norm_rel", "worst_of_tensor_max"):
            for side in ("plain", "direct"):
                if not d["kernel"][q] <= WINO_DRIFT_RATIO * d[side][q]:
                    fails.append(f"drift {q}: {d}")
        for side in ("kernel", "plain", "direct"):
            if not abs(res[side][0] - ref_l) <= LOOP_LOSS_RTOL * abs(ref_l):
                fails.append(f"loss {side}: {rec['loss']}")
        if fails:
            raise AssertionError(f"train_loop compare at dropout {p}: "
                                 f"{fails}")
        out[f"dropout_{p}"] = rec
        del res
    set_dropout_rate(comp, rate)
    set_dropout_rate(master, rate)
    return out


def loop_pngs(root: str, seed: int) -> str:
    """LOOP_PNGS' seeded PNGs (the port's writer) in root/images."""
    from kdip_tpu_torch import data
    folder = os.path.join(root, "images")
    os.makedirs(folder)
    rng = np.random.default_rng(seed)
    i = 0
    for count, hw in LOOP_PNGS:
        for _ in range(count):
            data.write_png(os.path.join(folder, f"{i:05d}.png"),
                           rng.integers(0, 256, hw + (3,), np.uint8))
            i += 1
    return folder


class LoopProbe:
    """A TrainLoop instrumented on the host clock: each step synchronised
    and timed, each data fetch timed, and each microbatch's Winograd
    launches."""

    def __init__(self, loop, data):
        import torch
        from kdip_tpu_torch.ops import winograd as Wg
        self.steps, self.fetch_s, self.micro = [], [], []
        step, micro = loop.run_step, loop.micro_grads

        def run_step(batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            self.steps.append(time.perf_counter() - t0)

        def micro_grads(*a, **kw):
            before = dict(Wg.launch_counts)
            out = micro(*a, **kw)
            self.micro.append({k: v - before[k]
                               for k, v in Wg.launch_counts.items()})
            return out

        def fetched():
            it = iter(data)
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                self.fetch_s.append(time.perf_counter() - t0)
                yield batch
        loop.run_step, loop.micro_grads = run_step, micro_grads
        loop.data = fetched()


def phase_train_loop_ffhq_winograd(tmp, dev):
    """train_loop_ffhq_winograd: `train_loop.TrainLoop` on
    configs/test_ffhq.json's ADM as `config.make_openai_model` builds it
    (93,563,910 parameters, learn_sigma, dropout 0.1, the 1000-step linear
    tables), seeded random float32 masters, the bf16 Winograd torso
    (compute_dtype), TF32 off; an `ImageDataset` of LOOP_PNGS with random
    crops, batches(num_workers=2), a new shuffle each epoch; batch LOOP_B
    in microbatches of LOOP_MB, rescaled_mse, the loss-second-moment
    sampler, EMAs LOOP_EMA, GNS, save_interval 2. First
    train_loop_compare; then LOOP_STEPS steps (the Winograd counts reset
    just before), every microbatch's launches exactly
    winograd_per_microbatch's under live dropout (0 fused); then a fresh
    loop resumes from the logdir (params, Adam state, both EMAs and step
    bit-equal) and takes LOOP_MORE more. Every logged loss finite, gns
    logged; `ema_0.9999_{LOOP_STEPS}.pt` loads strictly through the guided
    CLI's loader. Reports s/step (the median after the first), images/s,
    peak memory and the data fetch's share of the host time. Returns the
    DWT and Winograd launches of the runs."""
    import argparse

    import torch
    from kdip_tpu_torch import config, data, logger, resample, weights
    from kdip_tpu_torch.cli import sample_condition
    from kdip_tpu_torch.models.layers import Dropout
    from kdip_tpu_torch.ops import winograd as Wg
    from kdip_tpu_torch.train_loop import TrainLoop
    root = os.path.join(tmp, "train_loop_ffhq_winograd")
    os.makedirs(root)
    cfg = config.load_config(config_path("test_ffhq.json"))
    size = cfg["model"]["input_size"][0]
    folder = loop_pngs(root, seed=50)
    ds = data.ImageDataset(folder, size, random_crop=True, seed=50)

    def epochs():
        e = 0
        while True:
            yield from ds.batches(LOOP_B, shuffle=True, seed=e,
                                  num_workers=2)
            e += 1

    def make_loop(model, resume):
        return TrainLoop(
            model=model, tables=tables, data=None, batch_size=LOOP_B,
            microbatch=LOOP_MB, lr=1e-4, ema_rate=LOOP_EMA, log_interval=1,
            save_interval=2, logdir=os.path.join(root, "ckpt"),
            schedule_sampler=resample.create_named_schedule_sampler(
                "loss-second-moment", tables.num_timesteps),
            loss_type="rescaled_mse", resume=resume, seed=50,
            measure_gns=True, compute_dtype=torch.bfloat16)
    model, tables = config.make_openai_model(cfg["model"], winograd=True,
                                             device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    weights.randomize_(model, 50)
    loop = make_loop(model, resume=False)
    stream = epochs()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    compare = train_loop_compare(loop, dev, size)
    compare_s = time.perf_counter() - t0
    compare_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fwd, bwd = winograd_per_microbatch(loop.compute, True)
    want_micro = {k: fwd[k] + bwd[k] for k in fwd}
    runs, total = {}, {"winograd_conv3x3": 0, "winograd_conv3x3_fused": 0}
    with logger.scoped_configure(dir=os.path.join(root, "log"),
                                 format_strs=["json"]):
        for name, lp, to in (("first", loop, LOOP_STEPS),
                             ("resumed", None, LOOP_STEPS + LOOP_MORE)):
            if lp is None:
                fresh, _ = config.make_openai_model(
                    cfg["model"], winograd=True, device=dev)
                lp = make_loop(fresh, resume=True)
                restored = {
                    "step": lp.step == LOOP_STEPS,
                    "params": all(torch.equal(a, b) for a, b in zip(
                        loop.params, lp.params)),
                    "emas": all(torch.equal(a, b) for ea, eb in zip(
                        loop.ema_models, lp.ema_models) for a, b in zip(
                        ea.parameters(), eb.parameters())),
                    "opt": all(torch.equal(v, lp.opt.state[pb][k])
                               for pa, pb in zip(loop.params, lp.params)
                               for k, v in loop.opt.state[pa].items())}
                if not all(restored.values()):
                    raise AssertionError(f"train_loop resume: {restored}")
                del loop
                torch.cuda.empty_cache()
            probe = LoopProbe(lp, stream)
            Wg.reset_launch_counts()
            lp.run_loop(max_steps=to)
            launches = dict(Wg.launch_counts)
            secs = probe.steps
            n_steps = len(secs)
            rec = {"steps": n_steps, "step_s": secs,
                   "s_per_step": float(np.median(secs[1:])) if n_steps > 1
                   else secs[0],
                   "fetch_s": probe.fetch_s,
                   # the fetches that fed a step (run_loop draws one more
                   # batch before it sees max_steps)
                   "fetch_share": sum(probe.fetch_s[:n_steps]) / (
                       sum(probe.fetch_s[:n_steps]) + sum(secs)),
                   "winograd_launches": launches,
                   "winograd_per_microbatch": probe.micro[0]}
            rec["images_per_s"] = LOOP_B / rec["s_per_step"]
            runs[name] = rec
            bad = [m for m in probe.micro if m != want_micro]
            micro_n = n_steps * (LOOP_B // LOOP_MB)
            if (bad or lp.step != to or len(probe.micro) != micro_n
                    or launches != {k: v * micro_n
                                    for k, v in want_micro.items()}):
                raise AssertionError(f"train_loop {name}: {rec}, step "
                                     f"{lp.step}, want {want_micro}")
            for k in total:
                total[k] += launches[k]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    logs = [json.loads(line) for line in open(
        os.path.join(root, "log", "progress.json"))]
    if (len(logs) != LOOP_STEPS + LOOP_MORE
            or not all(np.isfinite(r[k]) for r in logs
                       for k in ("loss", "mse", "vb", "gns"))):
        raise AssertionError(f"train_loop logs: {logs}")
    ckpt = os.path.join(root, "ckpt", f"ema_0.9999_{LOOP_STEPS}.pt")
    cli_model, _ = sample_condition._load_model(argparse.Namespace(
        checkpoint=ckpt, winograd=True, v2=False, dtype="bfloat16"), cfg,
        dev)
    saved = sorted(os.listdir(os.path.join(root, "ckpt")))
    del cli_model, lp
    torch.cuda.empty_cache()
    emit({"phase": "train_loop_ffhq_winograd", "config": "test_ffhq.json",
          "params": n_params, "batch": LOOP_B, "microbatch": LOOP_MB,
          "dropout": next(m.p for m in model.modules()
                          if isinstance(m, Dropout)),
          "pngs": [[c, list(hw)] for c, hw in LOOP_PNGS],
          "compare": compare, "compare_s": compare_s,
          "compare_peak_mem_gib": compare_peak, "runs": runs,
          "winograd_per_microbatch_expected": want_micro,
          "restored_bit_equal": restored, "logged": logs,
          "checkpoints": saved, "ema_loads_in_cli": True,
          "peak_mem_gib": peak,
          "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                   "matmul": torch.backends.cuda.matmul.allow_tf32},
          "nvidia_smi": nvidia_smi()})
    return {"haar_dwt2": 0, "haar_idwt2": 0, "haar_ot_matvec": 0}, total


def phase_analytic_variance_imagenet(tmp, ckpt, lpips_npz):
    """analytic_variance_imagenet: `cli.analytic_variance.main` in-process
    on configs/test_imagenet.json at full width (bf16, the seeded `.pt` at
    `ckpt`), AV_SIGMAS sigmas over AV_BATCHES batches of AV_B from a
    folder of seeded PNGs (two resized), with --resume's journal: each
    UNet forward counted and timed (synchronised), no DWT or Winograd
    launch; then --resume again: no forward and the table bit for bit.
    Then the guided CLI on one image with the analytic covariance reading
    that table through the config's recon_mse key (AV_CLI_STEPS Heun
    steps): finite metrics, samples in [-1, 1]. Returns the DWT and
    Winograd launches of the three runs."""
    import torch
    from kdip_tpu_torch import data, train
    from kdip_tpu_torch.cli import analytic_variance
    from kdip_tpu_torch.models import adm
    from kdip_tpu_torch.ops import dwt as D
    from kdip_tpu_torch.ops import winograd as Wg
    root = os.path.join(tmp, "analytic_variance_imagenet")
    os.makedirs(root)
    folder = training_folder(root, seed=31)
    cfg_path = write_config(os.path.join(root, "config.json"),
                            "test_imagenet.json", folder)
    logdir = os.path.join(root, "logs")
    argv = ["--config", cfg_path, "--checkpoint", ckpt, "--num-sigmas",
            str(AV_SIGMAS), "--batch-size", str(AV_B),
            # the folder holds AV_B * AV_BATCHES images
            "--data-fraction", "1.0",
            "--logdir", logdir, "--resume", "--seed", "31"]
    forward, job = adm.ADMUNet.forward, train.analytic_variance

    def run():
        calls, job_s = [], []

        def timed_forward(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = forward(self, *a, **kw)
            torch.cuda.synchronize()
            calls.append(time.perf_counter() - t0)
            return out

        def timed_job(*a, **kw):
            t0 = time.perf_counter()
            out = job(*a, **kw)
            job_s.append(time.perf_counter() - t0)
            return out
        adm.ADMUNet.forward = timed_forward
        train.analytic_variance = timed_job
        try:
            torch.cuda.reset_peak_memory_stats()
            D.reset_launch_counts()
            Wg.reset_launch_counts()
            out = analytic_variance.main(argv)
            torch.cuda.synchronize()
        finally:
            adm.ADMUNet.forward, train.analytic_variance = forward, job
        return out, calls, job_s[0], dict(D.launch_counts), dict(
            Wg.launch_counts), torch.cuda.max_memory_allocated() / 2 ** 30
    out, calls, job_s, dwt, wino, peak = run()
    table = {k: v.tolist() for k, v in out.items()}
    rec = {"phase": "analytic_variance_imagenet",
           "config": "test_imagenet.json", "sigmas": AV_SIGMAS,
           "batches": AV_BATCHES, "batch": AV_B,
           "unet_forwards": len(calls),
           "s_per_sigma": job_s / AV_SIGMAS,
           "ms_per_forward": 1e3 * float(np.median(calls)),
           "peak_mem_gib": peak, "table": table, "dwt_launches": dwt,
           "winograd_launches": wino}
    mse = np.asarray(table["mse_list"])
    if (len(calls) != AV_SIGMAS * AV_BATCHES or len(mse) != AV_SIGMAS
            or not np.all(np.isfinite(mse)) or not np.all(mse > 0)
            or any(dwt.values()) or any(wino.values())):
        raise AssertionError(f"analytic_variance_imagenet: {rec}")
    again, calls2, _, dwt2, wino2, _ = run()
    rec["resume"] = {"unet_forwards": len(calls2),
                     "bit_equal": all(torch.equal(again[k], out[k])
                                      for k in out)}
    if calls2 or not rec["resume"]["bit_equal"]:
        raise AssertionError(f"analytic_variance_imagenet: --resume "
                             f"{rec['resume']}")
    # the guided CLI on one 256 px image, the table through recon_mse
    val = os.path.join(root, "val")
    os.makedirs(val)
    data.write_png(os.path.join(val, "00000.png"),
                   data.read_png(os.path.join(folder, "00000.png")))
    guided_cfg = write_config(
        os.path.join(root, "guided.json"), "test_imagenet.json", val,
        recon_mse=os.path.join(logdir, "recon_mse.npz"))
    probe = CliProbe()
    avg = probe.run(["--checkpoint", ckpt, "--config", guided_cfg,
                     "--operator-config",
                     config_path("inpainting_config.yaml"),
                     "--logdir", os.path.join(root, "guided"),
                     "--steps", str(AV_CLI_STEPS), "-n", "1",
                     "--xstart-cov-type", "analytic", "--lpips-weights",
                     lpips_npz, "--seed", "31"])
    nfe = 2 * AV_CLI_STEPS - 1
    rec["guided_analytic"] = {
        "steps": AV_CLI_STEPS, "wall_clock_per_image":
        avg["wall_clock_per_image"],
        "ms_per_nfe": 1e3 * avg["wall_clock_per_image"] / nfe,
        "psnr": avg["psnr"], "peak_mem_gib": probe.peak_mem_gib,
        "sampler_calls": probe.calls, "dwt_launches": probe.dwt_launches,
        "winograd_launches": probe.winograd_launches}
    if (len(probe.calls) != 1 or not probe.calls[0]["finite"]
            or probe.calls[0]["max_abs_out"] > 1 + 1e-5
            or not all(np.isfinite(avg[k]) for k in ("psnr", "ssim",
                                                      "lpips"))
            or any(probe.dwt_launches.values())
            or any(probe.winograd_launches.values())):
        raise AssertionError(f"analytic_variance_imagenet guided: {rec}")
    rec["nvidia_smi"] = nvidia_smi()
    emit(rec)
    return ({k: dwt[k] + dwt2[k] + probe.dwt_launches[k] for k in dwt},
            {k: wino[k] + wino2[k] + probe.winograd_launches[k]
             for k in wino})


def run_imagenet_nfe(dev, gcfg):
    """nfe_imagenet_winograd: the ImageNet-256 Winograd torso
    (configs/test_imagenet.json, 256 channels, built by bench_torch.build
    with seeded weights) through phase_nfe_winograd's one guided NFE, then
    every distinct Winograd launch of its NFE at its own shape beside
    F.conv2d (phase_winograd_shapes). Returns the launch counts of the
    NFE's runs (DWT, Winograd): no DWT kernel is on this path, and the
    Winograd count is one NFE's."""
    import torch

    import bench_torch
    from kdip_tpu_torch.ops import dwt as D
    _, parts = bench_torch.build(
        dev, gcfg, 3, load_op_config("inpainting_config.yaml"),
        winograd=True, model_config="test_imagenet.json")
    D.reset_launch_counts()
    launches = phase_nfe_winograd(dev, gcfg, parts,
                                  name="nfe_imagenet_winograd")
    dwt_launches = dict(D.launch_counts)
    if launches != IMAGENET_WINO_PER_NFE:
        raise AssertionError(f"ImageNet NFE: {launches} Winograd launches")
    if sum(dwt_launches.values()):
        raise AssertionError(f"ImageNet NFE: DWT launches {dwt_launches}")
    phase_winograd_shapes(dev, winograd_launch_shapes(parts[0], dev),
                          config="test_imagenet.json")
    del parts
    torch.cuda.empty_cache()
    return dwt_launches, launches


def phase_adm_rest_cpu_vs_card(dev):
    """The model families that no slice runs at full width, at 64 px in
    float32 (TF32 off) on the CPU and on the card, the same seeded weights
    (std 0.05) and inputs, each within ADM_REST_TOL of the largest |y|: a
    class-conditional ADM UNet without scale-shift norm or resblock
    up/down (conv resampling), the attention-pool classifier's logits and
    the input gradient of log p(y | x) (classifier guidance), the
    super-resolution UNet on a 16 px image, and the k-diffusion V1 and V2
    UNets with their variance outputs. Returns the phase's launch counts
    (DWT, Winograd): no kernel is on these paths."""
    import copy

    import torch
    from kdip_tpu_torch import config, weights
    from kdip_tpu_torch.models import adm, kdiff
    from kdip_tpu_torch.ops import dwt as D
    from kdip_tpu_torch.ops import winograd as Wg
    px, cpu = 64, torch.device("cpu")
    g = torch.Generator().manual_seed(40)
    x = torch.randn(2, 3, px, px, generator=g)
    t = torch.tensor([10.5, 700.25])
    labels = torch.tensor([3, 998])

    def class_cond():
        m, _ = config.make_openai_model({"openai": {
            "num_channels": 64, "image_size": px, "channel_mult": "1,2,2",
            "attention_resolutions": "16", "class_cond": True,
            "use_scale_shift_norm": False, "resblock_updown": False}},
            device=cpu)
        return m, lambda m, d: (m(x.to(d), t.to(d), y=labels.to(d)),)

    def classifier():
        m = adm.create_classifier(image_size=px, classifier_width=32,
                                  classifier_depth=1,
                                  classifier_attention_resolutions="8",
                                  device=cpu)

        def run(m, d):
            z = x.to(d).requires_grad_(True)
            logits = m(z, t.to(d))
            lp = torch.log_softmax(logits, -1)[torch.arange(2), labels.to(d)]
            return logits, torch.autograd.grad(lp.sum(), z)[0]
        return m, run

    def super_res():
        m = adm.SuperResADMUNet(image_size=px, in_channels=6,
                                model_channels=32, channel_mult=(1, 2, 2),
                                attention_resolutions=(4,), num_heads=4,
                                num_head_channels=32, device=cpu)
        low = torch.rand(2, 3, 16, 16, generator=g) * 2 - 1
        return m, lambda m, d: (m(x.to(d), t.to(d), low_res=low.to(d)),)

    def kdiff_model(Model):
        def make():
            torch.manual_seed(41)
            m = Model(c_in=3, feats_in=64, depths=(1, 1, 1),
                      channels=(32, 64, 64),
                      self_attn_depths=(False, True, False),
                      mapping_cond_dim=9, has_variance=True, device=cpu)
            sig = torch.tensor([0.05, 3.0])
            cond = torch.zeros(2, 9)
            return m, lambda m, d: m(x.to(d), sig.to(d),
                                     mapping_cond=cond.to(d),
                                     return_variance=True)
        return make

    cases = {"class_cond_adm": class_cond, "classifier_attention": classifier,
             "super_res": super_res,
             "kdiff_v1": kdiff_model(kdiff.ImageDenoiserModelV1),
             "kdiff_v2": kdiff_model(kdiff.ImageDenoiserModelV2)}
    D.reset_launch_counts()
    Wg.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    recs = {}
    for i, (name, make) in enumerate(cases.items()):
        model, run = make()
        weights.randomize_(model, 50 + i, std=0.05)
        model.eval()
        card = copy.deepcopy(model).to(dev)
        t0 = time.perf_counter()
        want = run(model, cpu)
        cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = run(card, dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        errs = [((a.detach().cpu() - b.detach()).abs().max()
                 / b.detach().abs().max()).item() for a, b in zip(got, want)]
        recs[name] = {"rel_err": errs, "cpu_s": cpu_s, "card_s": card_s,
                      "shapes": [list(a.shape) for a in got],
                      "finite": all(bool(torch.isfinite(a).all())
                                    for a in got)}
        if not (max(errs) <= ADM_REST_TOL and recs[name]["finite"]):
            raise AssertionError(f"adm_rest_cpu_vs_card {name}: "
                                 f"{recs[name]}")
        del model, card
    launches = dict(D.launch_counts), dict(Wg.launch_counts)
    emit({"phase": "adm_rest_cpu_vs_card", "px": px, "tol": ADM_REST_TOL,
          "cases": recs, "dwt_launches": launches[0],
          "winograd_launches": launches[1],
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    if sum(launches[0].values()) or sum(launches[1].values()):
        raise AssertionError(f"adm_rest_cpu_vs_card launched {launches}")
    return launches


def phase_no_scale_shift_winograd(dev):
    """The Winograd kernels under a ResBlock without scale-shift norm (its
    out_conv's fused prologue takes the GroupNorm statistics of h + emb),
    at reduced width: a 64 px, 64-channel bf16 torso with
    use_scale_shift_norm=False and resblock_updown=False, forward and
    x-vjp at B=2 through the kernels and through their plain versions
    (each conv's `conv_fn`), against a float32 copy of the same weights.
    Held as phase 8 holds the full torso: the kernels' drift from float32
    (norm-relative) at most WINO_DRIFT_RATIO times the plain versions',
    and the kernels' launches exactly the model's count (the plain run
    launches none). Returns the launch counts (DWT, Winograd) of the
    kernel run: no DWT kernel is on this path."""
    import copy

    import torch
    from kdip_tpu_torch import config, weights
    from kdip_tpu_torch.models.layers import Conv2d
    from kdip_tpu_torch.ops import dwt as D
    from kdip_tpu_torch.ops import winograd as Wg
    model, _ = config.make_openai_model({"openai": {
        "num_channels": 64, "image_size": 64, "channel_mult": "1,2,2",
        "attention_resolutions": "16", "use_scale_shift_norm": False,
        "resblock_updown": False}}, winograd=True, device=dev)
    weights.randomize_(model, 61, std=0.05)
    ref = copy.deepcopy(model).eval()
    weights.precast_inference(model).eval()
    g = torch.Generator(device=dev).manual_seed(62)
    x = torch.randn(2, 3, 64, 64, generator=g, device=dev)
    ct = torch.randn(2, 6, 64, 64, generator=g, device=dev)
    t = torch.tensor([10.5, 700.25], device=dev)
    convs = [m for m in model.modules() if isinstance(m, Conv2d)]

    def run(m):
        xg = x.clone().requires_grad_(True)
        y = m(xg, t)
        vjp, = torch.autograd.grad(y, xg, grad_outputs=ct)
        return y.detach().float(), vjp.float()
    want = run(ref)
    outs, launches = {}, {}
    D.reset_launch_counts()
    for mode in ("kernel", "plain"):
        for m in convs:
            m.conv_fn = Wg.winograd_conv3x3_plain if mode == "plain" else None
        Wg.reset_launch_counts()
        outs[mode] = run(model)
        torch.cuda.synchronize()
        launches[mode] = dict(Wg.launch_counts)
    dwt_launches = dict(D.launch_counts)
    for m in convs:
        m.conv_fn = None
    drift = {k: [((a - b).norm() / b.norm()).item()
                 for a, b in zip(outs[k], want)] for k in outs}
    per_nfe = winograd_per_nfe(model)
    rec = {"phase": "no_scale_shift_winograd", "px": 64,
           "norm_rel_vs_float32": drift, "drift_ratio_tol": WINO_DRIFT_RATIO,
           "winograd_launches": launches, "expected": per_nfe,
           "dwt_launches": dwt_launches}
    emit(rec)
    if (launches["kernel"] != per_nfe or sum(launches["plain"].values())
            or sum(dwt_launches.values()) or not all(k <= WINO_DRIFT_RATIO * p for k, p in
                       zip(drift["kernel"], drift["plain"]))):
        raise AssertionError(f"no_scale_shift_winograd: {rec}")
    return dwt_launches, launches["kernel"]


def phase_bench_torch(timeout_s: int = 600):
    """`python3 bench_torch.py` (the default workload) as a subprocess; its
    JSON line, which must carry bench.py's keys, becomes this phase's."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")],
                       capture_output=True, text=True, timeout=timeout_s,
                       cwd=ROOT)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    if r.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"bench_torch.py: rc {r.returncode}, "
                             f"{r.stderr[-2000:]}")
    res = json.loads(lines[0])
    keys = {"metric", "value", "unit", "vs_baseline", "baseline_source",
            "tflops_sustained", "mfu", "cg_max_residual", "mfu_method"}
    if not keys <= res.keys() or not res["value"] > 0:
        raise AssertionError(f"bench_torch.py printed {res}")
    emit({"phase": "bench_torch", "wall_s": time.perf_counter() - t0,
          "result": res})
    return res


def uncond_nfe(sampler: str, steps: int, respacing: str) -> int:
    """The UNet calls of one uncond CLI run: Heun, DPM-2 and DPM++ SDE call
    it twice a step but the last; the discrete chains once per kept
    timestep; the others once a step."""
    if sampler in ("ancestral", "ddim"):
        return int(respacing.replace("ddim", ""))
    return 2 * steps - 1 if sampler in ("heun", "dpm_2", "dpmpp_sde") \
        else steps


class UncondProbe:
    """Records one in-process run of the uncond CLI, with the module
    functions it calls wrapped for the run: the sampling's wall time
    (`draw_samples`, synchronised), the UNet's calls (a forward hook on
    the model `load_model` returns), the Brownian tree's calls and host
    time (each call two W queries), peak memory and the kernels' launch
    counts, reset just before `main`."""

    def run(self, argv):
        import contextlib
        import io

        import torch
        from kdip_tpu_torch import brownian
        from kdip_tpu_torch.cli import sample_uncond as U
        from kdip_tpu_torch.ops import dwt as D
        from kdip_tpu_torch.ops import winograd as Wg
        load, draw = U.load_model, U.draw_samples
        tree = brownian.BrownianTreeNoiseSampler.__call__
        self.nfe, self.tree_calls, self.tree_s = 0, 0, 0.0

        def count(*_):
            self.nfe += 1

        def loaded(*a, **kw):
            model, tables = load(*a, **kw)
            model.register_forward_hook(count)
            return model, tables

        def drawn(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = draw(*a, **kw)
            torch.cuda.synchronize()
            self.sample_s = time.perf_counter() - t0
            return out

        def tree_call(sampler, sigma, sigma_next):
            t0 = time.perf_counter()
            out = tree(sampler, sigma, sigma_next)
            self.tree_s += time.perf_counter() - t0
            self.tree_calls += 1
            return out
        U.load_model, U.draw_samples = loaded, drawn
        brownian.BrownianTreeNoiseSampler.__call__ = tree_call
        buf = io.StringIO()
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            D.reset_launch_counts()
            Wg.reset_launch_counts()
            with contextlib.redirect_stdout(buf):
                out = U.main(argv)
            torch.cuda.synchronize()
        finally:
            U.load_model, U.draw_samples = load, draw
            brownian.BrownianTreeNoiseSampler.__call__ = tree
        self.stdout = buf.getvalue()
        self.dwt_launches = dict(D.launch_counts)
        self.winograd_launches = dict(Wg.launch_counts)
        self.peak_mem_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        return out


def run_uncond_cli(tmp):
    """`kdip_tpu_torch.cli.sample_uncond.main` in-process at full width
    (configs/test_ffhq.json, a .pt of seeded random weights), -n 2, bf16,
    on its default device, the card, once per UNCOND_RUNS entry and heun
    once more: each run's samples finite and [2, 3, 256, 256], its two
    PNGs read back equal to them, its UNet calls the sampler's count, no
    DWT or Winograd launch; the two heun runs bit-equal. Returns the runs'
    summed launch counts (DWT, Winograd)."""
    import torch
    from kdip_tpu_torch import config, data, weights
    cfg_path = config_path("test_ffhq.json")
    model, _ = config.make_openai_model(config.load_config(cfg_path)["model"],
                                        device="cpu")
    ckpt = os.path.join(tmp, "uncond_model.pt")
    torch.save(weights.randomize_(model, 30).state_dict(), ckpt)
    del model
    dwt, wino, heun = {}, {}, None
    for i, (sampler, extra) in enumerate(UNCOND_RUNS + (("heun", ()),)):
        logdir = os.path.join(tmp, "uncond", str(i))
        argv = ["--checkpoint", ckpt, "--config", cfg_path, "-n",
                str(UNCOND_N), "--sampler", sampler, "--steps",
                str(UNCOND_STEPS), "--dtype", "bfloat16", "--logdir",
                logdir, "--seed", "31", *extra]
        probe = UncondProbe()
        out = probe.run(argv)
        respacing = extra[1] if extra else ""
        nfe = uncond_nfe(sampler, UNCOND_STEPS, respacing)
        pngs = sorted(os.listdir(logdir))
        png_ok = pngs == [f"sample_{j}.png" for j in range(UNCOND_N)] and all(
            np.array_equal(data.read_png(os.path.join(logdir, p)),
                           data.to_uint8_image(out[j]))
            and data.read_png(os.path.join(logdir, p)).shape
            == (SIZE, SIZE, 3) for j, p in enumerate(pngs))
        rec = {"phase": "uncond_cli", "sampler": sampler, "args": list(extra),
               "n": UNCOND_N, "steps": UNCOND_STEPS, "nfe": probe.nfe,
               "sample_s": probe.sample_s,
               "s_per_sample": probe.sample_s / UNCOND_N,
               "ms_per_nfe": 1e3 * probe.sample_s / max(probe.nfe, 1),
               "peak_mem_gib": probe.peak_mem_gib,
               "finite": bool(torch.isfinite(out).all()),
               "max_abs_out": out.abs().max().item(), "pngs": pngs,
               "pngs_read_back": png_ok,
               "dwt_launches": probe.dwt_launches,
               "winograd_launches": probe.winograd_launches}
        if sampler == "dpmpp_sde":
            rec["tree_queries"] = 2 * probe.tree_calls
            rec["tree_host_ms_per_step"] = 1e3 * probe.tree_s / UNCOND_STEPS
            rec["tree_host_ms_per_query"] = (1e3 * probe.tree_s
                                             / max(2 * probe.tree_calls, 1))
        if i == len(UNCOND_RUNS):
            rec["bit_equal_to_first_heun"] = torch.equal(out, heun)
        elif sampler == "heun":
            heun = out
        emit(rec)
        if (tuple(out.shape) != (UNCOND_N, 3, SIZE, SIZE) or not rec["finite"]
                or not png_ok or probe.nfe != nfe
                or sum(probe.dwt_launches.values())
                or sum(probe.winograd_launches.values())
                or rec.get("bit_equal_to_first_heun") is False
                or (sampler == "dpmpp_sde"
                    and probe.tree_calls != 2 * (UNCOND_STEPS - 1))
                or "wrote" not in probe.stdout):
            raise AssertionError(f"uncond_cli {sampler} {extra}: {rec}, "
                                 f"expected {nfe} UNet calls")
        for total, counts in ((dwt, probe.dwt_launches),
                              (wino, probe.winograd_launches)):
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
        del out
        torch.cuda.empty_cache()
    return dwt, wino


def run_samplers_rest(dev):
    """The samplers no CLI flag reaches, through the full-width discrete
    eps denoiser (configs/test_ffhq.json, seeded random weights, bf16
    torso), n=2 from sigma_max, 10 steps, noise from a seeded generator:
    each one's UNet calls held to its count, its output finite; dpm_adaptive
    stops with an error past ADAPTIVE_NFE_BUDGET calls. Then both
    log-likelihoods at n=1 on a random image: fevals held to the UNet's
    forward calls, values finite. Returns the phase's launch counts (DWT,
    Winograd)."""
    import torch
    from kdip_tpu_torch import config, precond, samplers, schedules, weights
    from kdip_tpu_torch.ops import dwt as D
    from kdip_tpu_torch.ops import winograd as Wg
    mc = config.load_config(config_path("test_ffhq.json"))["model"]
    model, tables = config.make_openai_model(mc, device=dev)
    weights.randomize_(model, 32)
    weights.precast_inference(model).eval().requires_grad_(False)
    den = precond.make_discrete_eps_denoiser(
        lambda x, t: model(x, t)[:, :3], tables.log_sigmas)
    calls = [0]

    def denoise(x, sigma):
        calls[0] += 1
        if calls[0] > budget[0]:
            raise AssertionError(f"more than {budget[0]} denoiser calls")
        return den(x, sigma)
    smin, smax = mc["sigma_min"], mc["sigma_max"]
    sig = schedules.get_sigmas_karras(UNCOND_STEPS, smin, smax)
    g = torch.Generator(device=dev).manual_seed(33)
    x = torch.randn(UNCOND_N, 3, SIZE, SIZE, generator=g, device=dev) * smax
    S, n = samplers, UNCOND_STEPS
    runs = (
        ("euler_ancestral", lambda: S.sample_euler_ancestral(
            denoise, x, sig, generator=g), n),
        ("dpm_2_ancestral", lambda: S.sample_dpm_2_ancestral(
            denoise, x, sig, generator=g), 2 * n - 1),
        ("dpmpp_2s_ancestral", lambda: S.sample_dpmpp_2s_ancestral(
            denoise, x, sig, generator=g), 2 * n - 1),
        ("dpmpp_2m_sde_midpoint", lambda: S.sample_dpmpp_2m_sde(
            denoise, x, sig, generator=g), n),
        ("dpmpp_2m_sde_heun", lambda: S.sample_dpmpp_2m_sde(
            denoise, x, sig, solver_type="heun", generator=g), n),
        ("dpm_fast", lambda: S.sample_dpm_fast(denoise, x, smin, smax, n), n),
        ("dpm_adaptive", lambda: S.sample_dpm_adaptive(
            denoise, x, smin, smax, return_info=True), None))
    budget = [ADAPTIVE_NFE_BUDGET]
    D.reset_launch_counts()
    Wg.reset_launch_counts()
    with torch.no_grad():
        for name, run, want in runs:
            calls[0] = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rec = {"phase": "samplers_rest", "sampler": name, "n": UNCOND_N,
                   "steps": n, "nfe": calls[0], "wall_s": wall,
                   "s_per_sample": wall / UNCOND_N,
                   "ms_per_nfe": 1e3 * wall / calls[0],
                   "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
            if name == "dpm_adaptive":
                out, info = out
                rec.update(info, nfe_budget=ADAPTIVE_NFE_BUDGET)
                want = info["nfe"]
            rec["finite"] = bool(torch.isfinite(out).all())
            rec["max_abs_out"] = out.abs().max().item()
            emit(rec)
            if calls[0] != want or not rec["finite"]:
                raise AssertionError(f"samplers_rest {name}: {rec}, "
                                     f"expected {want} calls")
    x1 = torch.rand(1, 3, SIZE, SIZE, generator=g, device=dev) * 2 - 1
    for name, run in (
            ("log_likelihood", lambda: S.log_likelihood(
                denoise, x1, smin, smax, steps=4, generator=g)),
            ("log_likelihood_adaptive", lambda: S.log_likelihood_adaptive(
                denoise, x1, smin, smax, max_steps=LL_ADAPTIVE_MAX_STEPS,
                generator=g))):
        calls[0] = 0
        budget[0] = 1 + 6 * LL_ADAPTIVE_MAX_STEPS
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ll, info = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rec = {"phase": "samplers_rest", "sampler": name, "n": 1, **info,
               "forward_calls": calls[0], "wall_s": wall,
               "ms_per_feval": 1e3 * wall / info["fevals"],
               "ll": ll.tolist(), "finite": bool(torch.isfinite(ll).all()),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        emit(rec)
        if calls[0] != info["fevals"] or not rec["finite"] or (
                name == "log_likelihood" and info["fevals"] != 16):
            raise AssertionError(f"samplers_rest {name}: {rec}")
    return dict(D.launch_counts), dict(Wg.launch_counts)


def phase_uncond_cpu_vs_card(dev):
    """A 64 px, 64-channel UNet (seeded random weights, std 0.05) through
    the CLI's `draw_samples` in float32 on the CPU and on the card, the
    same initial x and injected noise: dpmpp_2m 6 steps, ancestral over a
    respacing of 5, and dpmpp_sde 4 steps whose noise comes from a
    Brownian tree of one seed on the card, the CPU run querying a second
    tree of that seed (W is a function of the seed and t). Each within
    UNCOND_CPU_TOL of the largest |x| (TF32 is off). Returns the phase's
    launch counts (DWT, Winograd)."""
    import torch
    from kdip_tpu_torch import config, weights
    from kdip_tpu_torch.brownian import BrownianTreeNoiseSampler
    from kdip_tpu_torch.cli import sample_uncond as U
    from kdip_tpu_torch.ops import dwt as D
    from kdip_tpu_torch.ops import winograd as Wg
    px = 64
    mc = {"input_size": [px, px], "sigma_min": 0.01, "sigma_max": 80,
          "openai": {"num_channels": 64, "image_size": px,
                     "channel_mult": "1,2,2", "attention_resolutions": "16",
                     "dropout": 0.0}}
    cpu = torch.device("cpu")
    models = {}
    for d in (cpu, dev):
        model, tables = config.make_openai_model(mc, device=d)
        models[d] = (weights.randomize_(model, 34, std=0.05).eval()
                     .requires_grad_(False), tables)
    shape = (UNCOND_N, 3, px, px)
    gen = torch.Generator().manual_seed(35)
    init = torch.randn(shape, generator=gen)
    steps = [torch.randn(shape, generator=gen) for _ in range(5)]
    recs = []
    D.reset_launch_counts()
    Wg.reset_launch_counts()
    for sampler, n_steps, extra in (("dpmpp_2m", 6, ()),
                                    ("ancestral", 6, ("--respacing", "5")),
                                    ("dpmpp_sde", 4, ())):
        args = U.build_argparser().parse_args(
            ["--checkpoint", "-", "--config", "-", "-n", str(UNCOND_N),
             "--sampler", sampler, "--steps", str(n_steps), "--dtype",
             "float32", *extra])
        outs, secs = {}, {}
        for where, d in (("cpu", cpu), ("card", dev)):
            kw = {"init_noise": init.to(d)}
            if sampler == "ancestral":
                kw["noise_fn"] = lambda i, d=d: steps[i].to(d)
            elif sampler == "dpmpp_sde":
                tree = BrownianTreeNoiseSampler(shape, 0.01, 80.0, 36,
                                                device=dev)
                kw["noise_sampler"] = lambda s, sn, d=d, tree=tree: tree(
                    s, sn).to(d)
            t0 = time.perf_counter()
            outs[where] = U.draw_samples(args, *models[d], mc, d, **kw)
            torch.cuda.synchronize()
            secs[where] = time.perf_counter() - t0
        err = ((outs["card"].cpu() - outs["cpu"]).abs().max()
               / outs["cpu"].abs().max()).item()
        rec = {"sampler": sampler, "steps": n_steps, "args": list(extra),
               "rel_err": err, "cpu_s": secs["cpu"], "card_s": secs["card"],
               "finite": bool(torch.isfinite(outs["card"]).all())}
        recs.append(rec)
        if not (err <= UNCOND_CPU_TOL and rec["finite"]):
            raise AssertionError(f"uncond_cpu_vs_card {rec}")
    emit({"phase": "uncond_cpu_vs_card", "px": px, "tol": UNCOND_CPU_TOL,
          "runs": recs})
    return dict(D.launch_counts), dict(Wg.launch_counts)


def eval_images(seed: int, n: int, dev) -> np.ndarray:
    """n seeded uint8 [EVAL_SIZE, EVAL_SIZE, 3] images, made on dev from a
    torch.Generator there: smooth random fields (9 x 9 x 3 uniform levels,
    bicubic up to EVAL_SIZE) with N(0, 8) grain, so that neighbouring
    pixels correlate as in photographs (in numpy on the host these took
    most of the 20-26 s that writing the folders took; H100 80GB HBM3,
    700 W)."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(dev).manual_seed(seed)
    out = np.empty((n, EVAL_SIZE, EVAL_SIZE, 3), np.uint8)
    for i in range(0, n, 256):
        m = min(256, n - i)
        low = 255 * torch.rand((m, 3, 9, 9), generator=g, device=dev)
        img = F.interpolate(low, size=(EVAL_SIZE, EVAL_SIZE), mode="bicubic",
                            align_corners=False)
        img += 8 * torch.randn(img.shape, generator=g, device=dev)
        out[i:i + m] = img.round().clamp(0, 255).to(torch.uint8).permute(
            0, 2, 3, 1).cpu().numpy()
    return out


def noised(images: np.ndarray, g, dev) -> np.ndarray:
    """uint8 images with N(0, EVAL_NOISE) added on dev (generator g),
    rounded and clipped to 8-bit levels."""
    import torch
    x = torch.from_numpy(images).to(dev, torch.float32)
    x += EVAL_NOISE * torch.randn(x.shape, generator=g, device=dev)
    return x.round().clamp(0, 255).to(torch.uint8).cpu().numpy()


def write_eval_folders(root: str, seed: int, n: int, dev):
    """root/real and root/fake: n eval_images, and each `noised`, written
    by `data.write_png` on 8 threads (zlib releases the GIL). Returns the
    two folders."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from kdip_tpu_torch import data
    real = eval_images(seed, n, dev)
    g = torch.Generator(dev).manual_seed(seed + 1)
    dirs = [os.path.join(root, d) for d in ("real", "fake")]
    for d in dirs:
        os.makedirs(d)
    with ThreadPoolExecutor(8) as pool:
        futures = []
        for i0 in range(0, n, 256):
            chunk = real[i0:i0 + 256]
            fake = noised(chunk, g, dev)
            for j in range(len(chunk)):
                name = f"{i0 + j:05d}.png"
                futures += [pool.submit(data.write_png,
                                        os.path.join(d, name), img[j])
                            for d, img in zip(dirs, (chunk, fake))]
        for f in futures:
            f.result()
    return dirs


def random_inception_state_dict(dev, seed: int):
    """A full-width InceptionV3 (Mixed_5b to Mixed_7c, 2048 features) in
    pt_inception naming: torch's default conv init from
    torch.manual_seed(seed); each BatchNorm's weight U(0.5, 1.5) and bias
    N(0, 0.1), as tests/test_inception_backbone.py draws them; its running
    statistics from one train-mode pass on dev over EVAL_CALIB images of
    `eval_images(seed)`, the second half `noised` (momentum None: the
    batch's mean and unbiased variance), as a trained network's match its
    data (calibrated on clean images alone, the noised ones' features had
    ~50x the variance on the CPU). With the test's random statistics
    instead, the features of different images differ by
    ~4e-8 of their size (measured on the CPU), and an FID of them is
    float32 noise. Plus an `fc.weight` / `fc.bias` of the manifest's
    shapes, which the extractor must drop. On the CPU."""
    import torch
    from kdip_tpu_torch.models.inception import InceptionV3Features
    torch.manual_seed(seed)
    model = InceptionV3Features()
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, torch.nn.BatchNorm2d):
                bn.weight.uniform_(0.5, 1.5)
                bn.bias.normal_(0, 0.1)
                bn.momentum = None
                bn.reset_running_stats()
        calib = eval_images(seed, EVAL_CALIB, dev)
        half = EVAL_CALIB // 2
        calib[half:] = noised(calib[half:], torch.Generator(dev).manual_seed(
            seed), dev)
        model.to(dev).train()(torch.from_numpy(
            calib.transpose(0, 3, 1, 2) / 127.5 - 1).to(dev, torch.float32))
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    g = torch.Generator().manual_seed(seed)
    sd["fc.weight"] = 0.01 * torch.randn(INCEPTION_FC, generator=g)
    sd["fc.bias"] = torch.zeros(INCEPTION_FC[0])
    return sd


class EvalProbe:
    """`cli.evaluate.main` instrumented on the host clock: the time spent
    waiting for each batch of `FolderOfImages.batches`, and each folder's
    features as `folder_features` returns them."""

    def __init__(self):
        self.fetch_s, self.features = [], []

    @contextlib.contextmanager
    def patched(self):
        from kdip_tpu_torch import data
        from kdip_tpu_torch.cli import evaluate
        batches, features = data.FolderOfImages.batches, \
            evaluate.folder_features
        fetch_s, recorded = self.fetch_s, self.features

        def timed_batches(ds, *a, **kw):
            it = batches(ds, *a, **kw)
            try:
                while True:
                    t0 = time.perf_counter()
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    fetch_s.append(time.perf_counter() - t0)
                    yield batch
            finally:
                it.close()

        def folder_features(*a, **kw):
            out = features(*a, **kw)
            recorded.append(out)
            return out
        data.FolderOfImages.batches = timed_batches
        evaluate.folder_features = folder_features
        try:
            yield self
        finally:
            data.FolderOfImages.batches = batches
            evaluate.folder_features = features


def conv_flops(model, x) -> int:
    """The multiply-adds x2 of every Conv2d of model(x), from the shapes a
    forward hook sees."""
    import torch
    total = [0]

    def hook(m, _, out):
        k = m.weight[0].numel()  # C_in / groups * kh * kw
        total[0] += 2 * k * out.numel()
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def feature_spread(feats) -> float:
    """The least max-abs difference between two rows of feats, over the
    largest |feature|: how far the features of different images part."""
    d = (feats[:, None] - feats[None]).abs().amax(-1)
    d.fill_diagonal_(float("inf"))
    return float(d.min() / feats.abs().max())


def refused(argv, hide_transformers: bool = False) -> str:
    """The message of the SystemExit that `cli.evaluate.main(argv)` must
    raise; with hide_transformers, as if transformers were not installed
    (sys.modules' None entry makes its import fail)."""
    from kdip_tpu_torch.cli import evaluate
    saved = sys.modules.get("transformers", False)
    if hide_transformers:
        sys.modules["transformers"] = None
    try:
        evaluate.main(argv)
    except SystemExit as e:
        return str(e)
    finally:
        if hide_transformers:
            if saved is False:
                del sys.modules["transformers"]
            else:
                sys.modules["transformers"] = saved
    raise AssertionError(f"evaluate {argv} was not refused")


def phase_evaluate_fid_inception(tmp, dev, lpips_npz):
    """evaluate_fid_inception: the FID/KID CLI (`kdip_tpu_torch.cli.
    evaluate.main`, in-process) on two folders of EVAL_IMAGES seeded
    EVAL_SIZE px PNGs (`write_eval_folders`), with a full-width InceptionV3
    of seeded weights in a pt_inception `.pth`
    (`random_inception_state_dict`; its fc.* dropped by the loader), TF32
    off: the inception backbone at --batch-size EVAL_BATCH, the pixels
    backbone on EVAL_PIXELS images of each folder, --paired with LPIPS on
    EVAL_PAIRED pairs, then --backbone clip with transformers hidden
    (refused, naming it) and --dp without a process group (refused,
    naming torchrun; the scale_out phase runs it under one).
    Checks each run's n_real = n_fake, finite metrics, the inception
    fid >= 0; the card's FID and KID against float64 on the CPU
    from the same card features within FID_GAP_TRACE of the covariances'
    traces and KID_GAP_KERNEL of the mean kernel value; and the card's
    features of EVAL_CPU_IMAGES images against the CPU port's within
    EVAL_CPU_TOL of the largest |feature|, those features parting by at
    least EVAL_SPREAD (`feature_spread`). Reports each run's wall
    seconds, images/s end to end and of the forward alone
    (`profiling.timeit`, B=EVAL_BATCH), the data fetch's share of the
    host time, the device busy share of one traced batch
    (`profiling.trace`), ms of `sqrtm_eig` at D=2048, peak memory; no
    DWT or Winograd launch. Returns those (zero) launch counts."""
    import torch
    from torch.autograd import DeviceType

    from kdip_tpu_torch import data, evaluation, profiling
    from kdip_tpu_torch.models.inception import make_inception_extractor
    from kdip_tpu_torch.ops import dwt as D
    from kdip_tpu_torch.ops import winograd as Wg
    root = os.path.join(tmp, "evaluate_fid_inception")
    os.makedirs(root)
    t0 = time.perf_counter()
    real, fake = write_eval_folders(root, seed=61, n=EVAL_IMAGES, dev=dev)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sd = random_inception_state_dict(dev, seed=60)
    pth = os.path.join(root, "pt_inception_random.pth")
    torch.save(sd, pth)
    weights_s = time.perf_counter() - t0
    for counts in (D.launch_counts, Wg.launch_counts):
        counts.update({k: 0 for k in counts})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    walls, probes = {}, {}

    def cli(name, *argv):
        from kdip_tpu_torch.cli import evaluate
        probes[name] = probe = EvalProbe()
        with probe.patched():
            t = time.perf_counter()
            out = evaluate.main([real, fake, *argv, "--out",
                                 os.path.join(root, f"{name}.json")])
            walls[name] = time.perf_counter() - t
        return out

    common = ("--size", str(EVAL_SIZE), "--batch-size", str(EVAL_BATCH))
    inc = cli("inception", "--backbone", "inception", "--weights", pth,
              *common)
    pix = cli("pixels", "--backbone", "pixels", *common, "--max-images",
              str(EVAL_PIXELS))
    paired = cli("paired", "--paired", "--lpips-weights", lpips_npz,
                 "--size", str(EVAL_SIZE), "--max-images", str(EVAL_PAIRED))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the pixels backbone's 3072 features of EVAL_PIXELS images have
    # rank-deficient covariances, whose float32 FID may round below 0
    for name, out, n in (("inception", inc, EVAL_IMAGES),
                         ("pixels", pix, EVAL_PIXELS)):
        if (out["n_real"], out["n_fake"]) != (n, n) or \
                not (np.isfinite(out["fid"]) and np.isfinite(out["kid"])) \
                or (name == "inception" and out["fid"] < 0):
            raise AssertionError(f"evaluate --backbone {name}: {out}")
    if paired["n"] != EVAL_PAIRED or not all(
            np.isfinite(paired[k]) for k in ("psnr", "ssim", "lpips")):
        raise AssertionError(f"evaluate --paired: {paired}")

    # float32 on the card against float64 on the CPU, the same features
    f_real, f_fake = probes["inception"].features
    if tuple(f_real.shape) != (EVAL_IMAGES, 2048) or not bool(
            torch.isfinite(f_real).all() & torch.isfinite(f_fake).all()):
        raise AssertionError(f"inception features {tuple(f_real.shape)}")
    r64, f64 = f_real.double().cpu(), f_fake.double().cpu()
    fid64 = float(evaluation.fid(r64, f64))
    kid64 = float(evaluation.kid(r64, f64))
    trace_sum = float(torch.trace(torch.cov(r64.T))
                      + torch.trace(torch.cov(f64.T)))
    kernel_mean = float(evaluation.polynomial_kernel(r64, r64).mean())
    fid_gap, kid_gap = abs(inc["fid"] - fid64), abs(inc["kid"] - kid64)
    if fid_gap > FID_GAP_TRACE * trace_sum or \
            kid_gap > KID_GAP_KERNEL * kernel_mean:
        raise AssertionError(
            f"card FID {inc['fid']} / KID {inc['kid']} against float64 "
            f"{fid64} / {kid64}: gaps {fid_gap} > {FID_GAP_TRACE} x "
            f"{trace_sum} or {kid_gap} > {KID_GAP_KERNEL} x {kernel_mean}")

    # card against the CPU port on the first images of real/
    ds = data.FolderOfImages(real, size=EVAL_SIZE)
    first = torch.from_numpy(np.stack([ds[i][0] for i in range(EVAL_BATCH)]))
    cpu = make_inception_extractor(sd, "cpu")(first[:EVAL_CPU_IMAGES])
    card = f_real[:EVAL_CPU_IMAGES].cpu()
    cpu_err = float((cpu - card).abs().max() / card.abs().max())
    spread = feature_spread(card)
    if not cpu_err <= EVAL_CPU_TOL or not spread >= EVAL_SPREAD:
        raise AssertionError(f"inception features, card vs CPU: {cpu_err} "
                             f"of the largest (<= {EVAL_CPU_TOL}); spread "
                             f"{spread} (>= {EVAL_SPREAD})")

    # the forward alone, one traced batch, sqrtm_eig at D = 2048
    extract = make_inception_extractor(sd, dev)
    x = first.to(dev)
    forward_s = profiling.timeit(extract, x, iters=10, warmup=2)
    flops = conv_flops(extract.model, x[:1])
    # a trace that follows a long one can lose its first kernels
    # (trace_device_events): a batch and a spin kernel lead in, and the
    # events after the spin are the traced batch's
    with profiling.trace(os.path.join(root, "trace")) as prof:
        extract(x)
        torch.cuda._sleep(1000)
        extract(x)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [j for j, e in enumerate(events) if "spin_kernel" in e.name]
    kernels = device_events_by_name(events[marks[0] + 1:] if marks else None)
    busy_ms = sum(k[0] for k in kernels)
    cov = torch.cov(f_real.T)
    sqrtm_s = profiling.timeit(evaluation.sqrtm_eig, cov, iters=5, warmup=1)
    del extract, x, cov

    clip_msg = refused([real, fake, "--backbone", "clip", "--weights", root],
                       hide_transformers=True)
    dp_msg = refused([real, fake, "--dp"])
    if "transformers" not in clip_msg or "torchrun" not in dp_msg:
        raise AssertionError(f"refusals: {clip_msg!r} / {dp_msg!r}")
    launches = dict(D.launch_counts), dict(Wg.launch_counts)
    if any(v for c in launches for v in c.values()):
        raise AssertionError(f"evaluation launched a kernel: {launches}")
    # --paired reads items one by one, not through batches
    fetch = {k: sum(probes[k].fetch_s) for k in ("inception", "pixels")}
    emit({"phase": "evaluate_fid_inception", "nvidia_smi": nvidia_smi(),
          "images": EVAL_IMAGES, "size": EVAL_SIZE, "batch": EVAL_BATCH,
          "write_pngs_s": write_s, "weights_s": weights_s,
          "cli_wall_s": walls,
          "pixels_images": EVAL_PIXELS,
          "images_per_s_end_to_end": {
              "inception": 2 * EVAL_IMAGES / walls["inception"],
              "pixels": 2 * EVAL_PIXELS / walls["pixels"]},
          "fetch_s": fetch,
          "fetch_share": {k: fetch[k] / walls[k] for k in fetch},
          "forward_ms_b64": 1e3 * forward_s,
          "forward_images_per_s": EVAL_BATCH / forward_s,
          "gflop_per_image": flops / 1e9,
          "forward_tflops": flops * EVAL_BATCH / forward_s / 1e12,
          "device_busy_ms_b64": busy_ms if kernels else "not measured",
          "device_busy_share": (busy_ms / (1e3 * forward_s) if kernels
                                else "not measured"),
          "device_ms_by_kind": device_ms_by_kind(kernels),
          "top_kernels_ms": [[round(k[0], 4), k[1], k[2][:80]]
                             for k in kernels[:6]],
          "sqrtm_eig_ms_d2048": 1e3 * sqrtm_s,
          "fid": inc["fid"], "kid": inc["kid"], "fid_f64_cpu": fid64,
          "kid_f64_cpu": kid64, "fid_gap": fid_gap, "kid_gap": kid_gap,
          "fid_gap_bound": FID_GAP_TRACE * trace_sum,
          "kid_gap_bound": KID_GAP_KERNEL * kernel_mean,
          "cov_trace_sum": trace_sum, "kernel_mean": kernel_mean,
          "pixels": {k: pix[k] for k in ("fid", "kid")}, "paired": paired,
          "cpu_vs_card_rel_err": cpu_err, "feature_spread": spread,
          "peak_mem_gib": peak,
          "clip_refusal": clip_msg, "dp_refusal": dp_msg,
          "dwt_launches": launches[0], "winograd_launches": launches[1]})
    return launches


def winograd_launch_shapes(model, dev):
    """{(entry point, B, C, F, H, W): launches} of one UNet forward and its
    vjp at B = 1, as a guided NFE runs them under the per-sample loop,
    recorded from the model as it runs: every 3x3 conv's `conv_fn` becomes
    a recorder, so the forward and the vjp's dx are both seen. On a CUDA
    device the recorder launches the kernel; on the meta device (the CPU
    test of the launch choice) it only makes the output. Their sum must be
    winograd_per_nfe's count."""
    import torch
    from kdip_tpu_torch.models.layers import Conv2d
    from kdip_tpu_torch.ops import winograd as Wg
    cases = {}

    def record(x, v, prologue=None):
        entry = ("winograd_conv3x3" if prologue is None
                 else "winograd_conv3x3_fused")
        key = (entry, x.shape[0], x.shape[1], v.shape[2], *x.shape[2:])
        cases[key] = cases.get(key, 0) + 1
        if x.device.type == "meta":
            return x.new_empty(x.shape[0], v.shape[2], *x.shape[2:])
        return Wg.winograd_conv3x3_cuda(x, v, prologue)
    convs = [m for m in model.modules() if isinstance(m, Conv2d)]
    g = torch.Generator(device=dev).manual_seed(8) if dev.type != "meta" \
        else None
    x = torch.randn(1, 3, SIZE, SIZE, generator=g, device=dev,
                    requires_grad=True)
    t = torch.full((1,), 20, dtype=torch.long, device=dev)
    for m in convs:
        m.conv_fn = record
    training = model.training
    model.eval()  # a guided NFE: no live dropout
    try:
        y = model(x, t)
        torch.autograd.grad(y, x, grad_outputs=torch.ones_like(y))
    finally:
        model.train(training)
        for m in convs:
            m.conv_fn = None
    per_nfe = winograd_per_nfe(model)
    got = {k: sum(n for c, n in cases.items() if c[0] == k) for k in per_nfe}
    if got != per_nfe:
        raise AssertionError(f"recorded launches {got}, expected {per_nfe}")
    return cases


def phase_winograd_shapes(dev, cases, config: str = "test_ffhq.json"):
    """Each distinct Winograd launch of the NFE (`winograd_launch_shapes`)
    at its own shape, bf16: the kernel against its plain version (the
    WINO_* tolerance); then, in one torch.profiler trace for all shapes,
    WINO_SHAPE_REPS calls a shape of the kernel followed by F.conv2d on the
    same x and weight (cuDNN; all of its kernels, layout copies included):
    their device times beside the bound. One line per case, then one line that
    sums launches x time per level (H) and over the NFE; each names the
    model's `config`."""
    import torch
    import torch.nn.functional as F
    from kdip_tpu_torch.ops import winograd as Wg
    order = sorted(cases.items(), key=lambda kv: (-kv[0][4], kv[0]))

    def inputs(i, entry, B, C, Fo, H, W):
        x, w, a, b = wino_inputs(dev, B, C, Fo, H, W, seed=100 + i)
        pro = (a, b) if entry == "winograd_conv3x3_fused" else None
        return x, w, Wg.kernel_transform(w), pro

    cmps = []
    for i, (case, _) in enumerate(order):
        x, _, v, pro = inputs(i, *case)
        y = Wg.winograd_conv3x3_cuda(x, v, pro)
        torch.cuda.synchronize()
        cmps.append(wino_compare(y, Wg.winograd_conv3x3_plain(x, v, pro),
                                 "{} {}x{}x{}x{}x{}".format(*case)))
        del x, v, pro, y

    def both(i, case):
        x, w, v, pro = inputs(i, *case)

        def fn():  # the kernel's events, and cuDNN's (the rest)
            Wg.winograd_conv3x3_cuda(x, v, pro)
            F.conv2d(x, w, padding=1)
        return fn
    times = profiled_cases_ms([both(i, case) for i, (case, _) in
                               enumerate(order)], "winograd_f23",
                              WINO_SHAPE_REPS)
    levels = {}
    for ((entry, B, C, Fo, H, W), n), cmp, (ms, conv_ms) in zip(
            order, cmps, times):
        if ms is None or conv_ms is None:
            raise AssertionError(f"{entry} {B}x{C}x{Fo}x{H}x{W}: the trace "
                                 f"shows no device time")
        v_numel = 16 * C * Fo
        flops = 2 * 16 * B * (H // 2) * (W // 2) * C * Fo
        nbytes = 2 * (B * C * H * W + B * Fo * H * W + v_numel) + (
            2 * 4 * B * C if entry == "winograd_conv3x3_fused" else 0)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / BF16_TENSOR_FLOP_PER_S
        bound = 1e3 * max(t_bytes, t_ops)
        emit({"phase": "winograd_shapes", "config": config, "entry": entry,
              "shape_BCFHW": [B, C, Fo, H, W], "launches_per_nfe": n,
              "launch_config": Wg.launch_config(B, C, Fo, H, W)._asdict(),
              "device_ms": ms, "conv2d_device_ms": conv_ms, "bound_ms": bound,
              "bound_by": "bytes" if t_bytes >= t_ops else "operations",
              **cmp})
        lv = levels.setdefault(H, dict.fromkeys(
            ("launches", "device_ms", "conv2d_device_ms", "bound_ms"), 0.0))
        lv["launches"] += n
        lv["device_ms"] += n * ms
        lv["conv2d_device_ms"] += n * conv_ms
        lv["bound_ms"] += n * bound
    total = {k: sum(lv[k] for lv in levels.values()) for k in (
        "launches", "device_ms", "conv2d_device_ms", "bound_ms")}
    emit({"phase": "winograd_levels", "config": config,
          "cases": len(cases),
          "per_nfe_by_H": levels, "per_nfe": total})


def wino_kernel_rows(dev, launches):
    """The kernels line's Winograd rows, at the hottest shape of the slice
    ([1,128,256,256] -> 128 bf16, B=1 under the per-sample loop). The bound:
    2*16*(H/2)*(W/2)*C*F tensor-core flops at the dense bf16 rate, against
    x + y + V (+ a, b) bytes at the HBM rate. The library yardstick is
    cuDNN's direct conv (F.conv2d, bf16), which computes the plain kernel's
    function; no single call computes the fused one (conv2d of
    silu(x*a + b)), so its row gives conv2d's time alone."""
    import torch
    import torch.nn.functional as F
    from kdip_tpu_torch.ops import winograd as Wg
    B, C, Fo, H, W = WINO_SHAPES[0]
    x, w, a, b = wino_inputs(dev, B, C, Fo, H, W, seed=3)
    v = Wg.kernel_transform(w)
    flops = 2 * 16 * (H // 2) * (W // 2) * C * Fo
    lib_ms = cuda_time_ms(lambda: F.conv2d(x, w, padding=1))
    rows = []
    for name, pro in (("winograd_conv3x3", None),
                      ("winograd_conv3x3_fused", (a, b))):
        nbytes = 2 * (x.numel() + B * Fo * H * W + v.numel()) + (
            2 * 4 * B * C if pro else 0)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / BF16_TENSOR_FLOP_PER_S
        err = (Wg.winograd_conv3x3_cuda(x, v, pro).float()
               - Wg.winograd_conv3x3_plain(x, v, pro).float()).abs().max()

        def kern():
            return Wg.winograd_conv3x3_cuda(x, v, pro)
        ms = cuda_time_ms(kern)
        plain_ms = cuda_time_ms(lambda: Wg.winograd_conv3x3_plain(x, v, pro),
                                reps=20, warmup=3)
        ms2 = cuda_time_ms(kern)
        rows.append({
            "name": name, "route": "cuda",
            "source": "kdip_tpu_torch/csrc/winograd_f23.cu",
            "replaces": "kdip_tpu/ops/experimental/winograd_pallas.py:60",
            "launches": launches[name], "max_abs_err": err.item(),
            "ms": min(ms, ms2), "ms_runs": [ms, ms2],
            "device_ms": profiled_kernel_ms(kern, "winograd_f23"),
            "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "library_call": "torch.nn.functional.conv2d, bf16 (cuDNN)" + (
                "; no single call fuses silu(x*a+b): conv2d alone"
                if pro else ""),
            "shape_BCFHW": [B, C, Fo, H, W]})
    return rows


def kernel_rows(dev, launches):
    """The kernels line: each kernel at the slice's shape [1, 3, 256, 256]
    float32, level 3 (one sample under the per-sample loop)."""
    import torch
    from kdip_tpu_torch.ops import dwt as D
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(1, 3, 256, 256, generator=g, device=dev)
    n = x.numel()
    nbytes = 2 * 4 * n                      # read once, write once
    flops = 4 * n * (1 + 1 / 4 + 1 / 16)    # 16 add/sub/mul per 2x2, 3 levels
    bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)
    bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / F32_FLOP_PER_S
                else "operations")
    rows = []
    for name, inverse, plain in (("haar_dwt2", False, D.dwt2_plain),
                                 ("haar_idwt2", True, D.idwt2_plain)):
        err = (D.haar_dwt2_cuda(x, 3, inverse) - plain(x, 3)).abs().max().item()
        ms = cuda_time_ms(lambda: D.haar_dwt2_cuda(x, 3, inverse))
        plain_ms = cuda_time_ms(lambda: plain(x, 3))
        ms2 = cuda_time_ms(lambda: D.haar_dwt2_cuda(x, 3, inverse))
        kname = "haar_dwt2_inv" if inverse else "haar_dwt2_fwd"
        rows.append({"name": name, "route": "cuda",
                     "source": "kdip_tpu_torch/csrc/haar_dwt.cu",
                     "replaces": "kdip_tpu/ops/pallas_dwt.py:49",
                     "launches": launches[name], "max_abs_err": err,
                     "ms": min(ms, ms2), "ms_runs": [ms, ms2],
                     "device_ms": profiled_kernel_ms(
                         lambda: D.haar_dwt2_cuda(x, 3, inverse), kname),
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": None})
        if not err <= DWT_TOL:
            raise AssertionError(f"{name} at the slice's shape: {err}")
    return rows + [matvec_row(dev, launches["haar_ot_matvec"])]


def matvec_row(dev, launches):
    """The fused matvec's row, at the slice's [1, 3, 256, 256], level 3,
    with the inpainting mask's [1, C, H, W] and s2 = sigma_s^2, through
    `OrthoTransform.masked_cov_matvec` as the CG calls it. The bound: v,
    theta and the mask read once, y written once. No single PyTorch call
    computes this function, so the yardstick is the six-launch chain it
    replaces, timed the same way on the same inputs: s2*v + mask *
    inv(theta * ot(v)) with the standalone kernels. launch_floor_ms is an
    empty kernel's (torch.cuda._sleep(0)) device time in the same trace."""
    import torch
    from kdip_tpu_torch.ops import dwt as D
    from kdip_tpu_torch.ops import transforms as T
    v, theta, mask, s2 = matvec_inputs(dev, 1, seed=5)
    ot = T.OrthoTransform("dwt")
    n = v.numel()
    nbytes = 4 * 4 * n
    # two transforms (5.25 flops a value), theta*, s2*v, mask*w, the add
    flops = 2 * 4 * n * (1 + 1 / 4 + 1 / 16) + 4 * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S

    def fused():
        return ot.masked_cov_matvec(v, theta, mask, s2)

    def composed():
        return s2 * v + mask * ot.inv(theta * ot(v))
    got, want = fused(), D.ot_matvec_plain(v, theta, mask, s2)
    err = (got - want).abs().max().item()
    equal = (got == want).float().mean().item()
    if not (err <= DWT_TOL and equal >= DWT_EQUAL):
        raise AssertionError(f"haar_ot_matvec at the slice's shape: {err}, "
                             f"{equal:.5f} bit-equal")
    if not torch.equal(composed(), want):
        raise AssertionError("the composed chain differs from the plain one")
    ms = cuda_time_ms(fused)
    composed_ms = cuda_time_ms(composed)
    plain_ms = cuda_time_ms(lambda: D.ot_matvec_plain(v, theta, mask, s2))
    ms2 = cuda_time_ms(fused)
    (dev_ms, _), (c_first, c_rest), (floor_ms, _) = profiled_cases_ms(
        [fused, composed, lambda: torch.cuda._sleep(0)],
        ("haar_dwt2_matvec", "haar_dwt2_fwd", "spin_kernel"), 50)
    return {"name": "haar_ot_matvec", "route": "cuda",
            "source": "kdip_tpu_torch/csrc/haar_dwt.cu",
            "replaces": "kdip_tpu/ops/pallas_dwt.py:49",
            "launches": launches, "max_abs_err": err, "bit_equal": equal,
            "ms": min(ms, ms2), "ms_runs": [ms, ms2], "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "composed_ms": composed_ms,
            "composed_device_ms": None if c_first is None
            else c_first + (c_rest or 0.0),
            "launch_floor_ms": floor_ms,
            "launch_config": D.launch_config(3, SIZE, SIZE)._asdict()}


# ---------------------------------------------------------------------------
# scale_out: the --dp paths over torch.distributed ranks
# ---------------------------------------------------------------------------

def _cuda(dev) -> bool:
    return dev.type == "cuda"


def _sync(dev) -> None:
    import torch
    if _cuda(dev):
        torch.cuda.synchronize()


def _peak_gib(dev):
    import torch
    return (torch.cuda.max_memory_allocated() / 2 ** 30 if _cuda(dev)
            else "not measured")


def _reset_peak(dev) -> None:
    import torch
    if _cuda(dev):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def adam_close(got: dict, want: dict) -> dict:
    """Two state dicts after the same Adam steps: the largest
    |a - b| - 1e-6 |b| over the elements and the share of elements past
    1e-4 of the lr (1e-4), and whether they hold tests/test_torch_train_
    loop.py's bound (every element within 1 lr, at most 0.1% past 1e-4 lr:
    Adam divides each gradient by its own RMS, so a gradient near 0 that
    rounds otherwise steps otherwise)."""
    lr, worst, beyond, total = 1e-4, 0.0, 0, 0
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        d = (got[k].float() - w.float()).abs() - 1e-6 * w.float().abs()
        worst = max(worst, float(d.max()))
        beyond += int((d > 1e-4 * lr).sum())
        total += w.numel()
    return {"max_excess": worst, "share_past_1e-4_lr": beyond / total,
            "ok": worst <= lr and beyond <= 1e-3 * total}


def scale_out_cli_argv(plan, dev, logdir, ranks: bool = False):
    """The guided CLI on the phase's DWT-Var checkpoint (--v2, TF32 off),
    one batch of SCALE_OUT_IMAGES, Heun-plan["steps"]: on
    configs/test_ffhq_dwt.json's copy, bf16; with `ranks`, part (b)'s
    pair, on the copy at sigma_max SCALE_OUT_SIGMA_MAX, float32."""
    c = plan["cli"]
    return ["--checkpoint", c["ckpt"], "--config",
            c["config_ranks" if ranks else "config"],
            "--operator-config", c["op"], "--logdir", logdir, "--steps",
            str(plan["steps"]), "-n", "1",
            "--batch-size", str(c["images"]), "--v2", "--dtype",
            "float32" if ranks else "bfloat16", "--seed", "70",
            "--device", dev.type]


def scale_out_cli_record(probe, steps: int, sigma_max: float = 80.0
                         ) -> dict:
    """One CLI run's sampler calls on this rank, CG iterations, launches
    and peak memory; raises unless the fused matvec launched exactly once
    a CG iteration and once a solve (one solve a guided call below the
    threshold, for the rank's block) and no other DWT entry point."""
    iters = sum(c["cg_total_iters"] for c in probe.calls)
    solves = len(probe.calls) * guided_nfes_below(1.0, steps, sigma_max)
    want = {"haar_dwt2": 0, "haar_idwt2": 0, "haar_ot_matvec": iters + solves}
    rec = {"calls": probe.calls, "cg_total_iters": iters, "cg_solves": solves,
           "dwt_launches": probe.dwt_launches,
           "winograd_launches": probe.winograd_launches,
           "peak_mem_gib": probe.peak_mem_gib}
    bad = [c for c in probe.calls
           if not c["finite"] or c["max_abs_out"] > 1 + 1e-5]
    if probe.dwt_launches != want or bad or sum(
            probe.winograd_launches.values()):
        raise AssertionError(f"scale_out CLI: launches {probe.dwt_launches}"
                             f", expected {want}; calls {probe.calls}")
    return rec


def scale_out_collectives(dev, numel: int, reps: int) -> dict:
    """ms of the group's all_reduce of `numel` float32 (a gradient's size)
    and of one float (a CG inner product), and of the all_gather of one
    [1, 3, SIZE, SIZE] block, on dev (under gloo on the card, through the
    host): CUDA events on the card, the host clock on the CPU."""
    import torch
    from kdip_tpu_torch.parallel import dist as pdist
    from kdip_tpu_torch.parallel import sharding
    big = torch.ones(numel, device=dev)
    one = torch.ones(1, device=dev)
    block = torch.ones((1, 3, SIZE, SIZE), device=dev)
    world = torch.distributed.group.WORLD
    fns = {"all_reduce_grad_ms": lambda: pdist.all_reduce(big, world),
           "all_reduce_scalar_ms": lambda: pdist.all_reduce(one, world),
           "all_gather_block_ms": lambda: sharding.all_gather_blocks(
               block, world)}
    out = {}
    for name, fn in fns.items():
        n = 3 if name == "all_reduce_grad_ms" else reps
        if _cuda(dev):
            out[name] = cuda_time_ms(fn, reps=n, warmup=1)
        else:
            fn()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            out[name] = 1e3 * (time.perf_counter() - t0) / n
    out["grad_numel"] = numel
    out["backend"] = str(torch.distributed.get_backend())
    return out


def scale_out_one_rank(plan, dev) -> dict:
    """Part (a)'s sampling and scoring, one rank under the launcher's
    environment (WORLD_SIZE 1; NCCL on the card): the guided CLI batched
    without a group, then with --dp (which joins the group): samples
    within SCALE_OUT_TOL, the same CG iterations, launches exact; the same
    --dp run on the config at sigma_max SCALE_OUT_SIGMA_MAX, part (b)'s
    reference; evaluate --dp against evaluate on two folders, FID / KID
    equal; then the collectives' times, the all_reduce at a gradient's
    size."""
    import torch
    from kdip_tpu_torch.cli import evaluate
    from kdip_tpu_torch.ops import dwt as D
    from kdip_tpu_torch.ops import winograd as Wg
    out, secs, peak = plan["out"], {}, {}
    res = {"seconds": secs, "peak_mem_gib": peak}

    t0 = time.perf_counter()
    one, dp = CliProbe(), CliProbe()
    one.run(scale_out_cli_argv(plan, dev, os.path.join(out, "cli_one")))
    if torch.distributed.is_initialized():
        raise AssertionError("the batched CLI joined a process group")
    dp.run(scale_out_cli_argv(plan, dev, os.path.join(out, "cli_dp"))
           + ["--dp"])
    if (not torch.distributed.is_initialized()
            or torch.distributed.get_world_size() != 1):
        raise AssertionError("--dp did not join the launcher's group")
    rec_one = scale_out_cli_record(one, plan["steps"])
    rec_dp = scale_out_cli_record(dp, plan["steps"])
    n = plan["cli"]["images"]
    if len(one.samples) != n or len(dp.samples) != n:
        raise AssertionError(f"{len(one.samples)} / {len(dp.samples)} "
                             f"scored samples, expected {n}")
    err = max(float((a - b).abs().max())
              for a, b in zip(dp.samples, one.samples))
    # part (b)'s reference: --dp on the config whose sigma_max is
    # SCALE_OUT_SIGMA_MAX
    ref = CliProbe()
    ref.run(scale_out_cli_argv(plan, dev, os.path.join(out, "cli_ref"),
                               True) + ["--dp"])
    rec_ref = scale_out_cli_record(ref, plan["steps"], SCALE_OUT_SIGMA_MAX)
    torch.save(ref.samples, os.path.join(out, "a_samples.pt"))
    res["cli"] = {"one_process": rec_one, "dp": rec_dp, "ranks_ref": rec_ref,
                  "dp_vs_batched_max_abs": err, "bound": SCALE_OUT_TOL,
                  "backend": str(torch.distributed.get_backend())}
    if err > SCALE_OUT_TOL or rec_dp["cg_total_iters"] != \
            rec_one["cg_total_iters"]:
        raise AssertionError(f"--dp against the batched CLI: {err} "
                             f"(> {SCALE_OUT_TOL}) or CG iterations "
                             f"{rec_dp['cg_total_iters']} / "
                             f"{rec_one['cg_total_iters']}")
    peak["cli"] = max(rec_one["peak_mem_gib"], rec_dp["peak_mem_gib"])
    secs["cli"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ev = plan["eval"]
    argv = [ev["real"], ev["fake"], "--backbone", "inception", "--weights",
            ev["weights"], "--size", str(ev["size"]), "--batch-size",
            str(ev["batch"]), "--device", dev.type]
    D.reset_launch_counts()
    Wg.reset_launch_counts()
    _reset_peak(dev)
    e_one = evaluate.main(argv)
    e_dp = evaluate.main(argv + ["--dp"])
    res["evaluate"] = {"one_process": e_one, "dp": e_dp,
                       "peak_mem_gib": _peak_gib(dev)}
    if (e_dp != e_one or e_dp["n_real"] != ev["n"] or e_dp["n_fake"] != ev["n"]
            or not (np.isfinite(e_dp["fid"]) and np.isfinite(e_dp["kid"]))
            or sum(D.launch_counts.values()) + sum(Wg.launch_counts.values())):
        raise AssertionError(f"evaluate --dp: {res['evaluate']}")
    peak["evaluate"] = res["evaluate"]["peak_mem_gib"]
    secs["evaluate"] = time.perf_counter() - t0

    res["collectives"] = scale_out_collectives(dev, plan["train"]["params"],
                                               50)
    dwt = {k: rec_one["dwt_launches"][k] + rec_dp["dwt_launches"][k]
           + rec_ref["dwt_launches"][k] for k in rec_one["dwt_launches"]}
    res["launches"] = {"dwt": dwt, "winograd": rec_one["winograd_launches"]}
    return res


def scale_out_train_rank(plan, dev) -> dict:
    """Part (a)'s training, one rank under the launcher's environment
    (WORLD_SIZE 1; NCCL on the card), beside the sampling rank: two
    TrainLoop steps without and with mesh= on test_ffhq.json's bf16
    Winograd torso (dropout 0.1 live), params and EMAs as adam_close holds
    them, every microbatch's Winograd launches as
    winograd_per_microbatch's, rank 0's checkpoints; one train_openai step
    in the group (the gradients all-reduced before Adam), its DWT launches
    exact and rank 0's checkpoints; FSDP2 (shard_params_fsdp) on the
    full-width torso against a replicated copy, loss and gradients."""
    import copy

    import torch
    from kdip_tpu_torch import config, logger, resample, weights
    from kdip_tpu_torch.ops import winograd as Wg
    from kdip_tpu_torch.parallel import dist as pdist
    from kdip_tpu_torch.parallel import sharding
    from kdip_tpu_torch.train_loop import TrainLoop
    out, secs, peak = plan["out"], {}, {}
    res = {"seconds": secs, "peak_mem_gib": peak}
    pdist.setup_dist(device=dev.type)

    t0 = time.perf_counter()
    lp = plan["loop"]
    cfg = config.load_config(lp["config"])
    size = cfg["model"]["input_size"][0]
    g = torch.Generator(dev).manual_seed(75)
    batches = [torch.rand((lp["B"], 3, size, size), generator=g, device=dev)
               * 2 - 1 for _ in range(lp["steps"])]
    loops, init = {}, None
    for name, mesh in (("one_process", None), ("mesh", sharding.make_mesh())):
        model, tables = config.make_openai_model(cfg["model"], winograd=True,
                                                 device=dev)
        if init is None:  # seeded random masters, drawn once
            init = weights.randomize_(model, 74).state_dict()
            init = {k: v.clone() for k, v in init.items()}
        else:
            model.load_state_dict(init)
        _reset_peak(dev)
        loop = TrainLoop(
            model=model, tables=tables, data=iter(batches),
            batch_size=lp["B"], microbatch=lp["MB"], lr=1e-4,
            ema_rate=LOOP_EMA, log_interval=1, save_interval=lp["steps"],
            logdir=os.path.join(out, f"loop_{name}"),
            schedule_sampler=resample.create_named_schedule_sampler(
                "loss-second-moment", tables.num_timesteps),
            loss_type="rescaled_mse", resume=False, seed=74,
            measure_gns=True, compute_dtype=torch.bfloat16, mesh=mesh)
        fwd, bwd = winograd_per_microbatch(loop.compute, True)
        Wg.reset_launch_counts()
        _sync(dev)
        t = time.perf_counter()
        with logger.scoped_configure(dir=os.path.join(out, f"log_{name}"),
                                     format_strs=["json"]):
            if mesh is None:  # the reference: its steps, no checkpoint
                for batch in batches:
                    loop.run_step(batch)
            else:  # rank 0 writes the checkpoints at the last step
                loop.run_loop(max_steps=lp["steps"])
        _sync(dev)
        micro_n = lp["steps"] * (lp["B"] // lp["MB"])
        want = {k: (fwd[k] + bwd[k]) * micro_n for k in fwd}
        launches = dict(Wg.launch_counts)
        if launches != want or loop.step != lp["steps"]:
            raise AssertionError(f"TrainLoop {name}: Winograd launches "
                                 f"{launches}, expected {want}")
        loops[name] = {
            "s": time.perf_counter() - t, "winograd_launches": launches,
            "peak_mem_gib": _peak_gib(dev),
            "state": [{k: v.detach().cpu() for k, v in m.state_dict().items()}
                      for m in [loop.model] + loop.ema_models],
            "files": sorted(os.listdir(loop.logdir)) if mesh is not None
            else []}
        del loop, model
        if _cuda(dev):
            torch.cuda.empty_cache()
    del init
    close = [adam_close(a, b) for a, b in zip(loops["mesh"].pop("state"),
                                              loops["one_process"].pop(
                                                  "state"))]
    res["train_loop"] = dict(loops, close=close)
    n = lp["steps"]
    saved = sorted(f"{k}_{n}.pt" for k in ["model", "opt"] + [
        f"ema_{r}" for r in LOOP_EMA.split(",")])
    if not all(c["ok"] for c in close) or loops["mesh"]["files"] != saved:
        raise AssertionError(f"TrainLoop with mesh= against one process: "
                             f"{res['train_loop']}")
    peak["train_loop"] = max(v["peak_mem_gib"] for v in loops.values()) \
        if _cuda(dev) else "not measured"
    secs["train_loop"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    tr = plan["train"]
    probe = TrainProbe()
    probe.run(["--config", tr["config"], "--checkpoint", tr["ckpt"],
               "--batch-size", str(tr["B"]), "--max-steps", "1",
               "--logdir", tr["logdir"], "--seed", "76", "--num-workers",
               "2", "--device", dev.type])
    step = probe.steps[0] if probe.steps else {}
    want = {"haar_dwt2": 2 * tr["B"], "haar_idwt2": tr["B"],
            "haar_ot_matvec": 0}
    files = sorted(os.listdir(tr["logdir"]))
    res["train_openai"] = {"steps": probe.steps,
                           "dwt_launches": probe.dwt_launches,
                           "peak_mem_gib": probe.peak_mem_gib,
                           "files": files}
    if (len(probe.steps) != 1 or not np.isfinite(step["loss"])
            or step["dwt"] != want or probe.dwt_launches != want
            or not {"state_1.pt", "train_state_latest.pt"} <= set(files)):
        raise AssertionError(f"train_openai in the group: "
                             f"{res['train_openai']}, want {want}")
    peak["train_openai"] = probe.peak_mem_gib
    secs["train_openai"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ref, _ = config.make_openai_model(cfg["model"], device=dev)
    weights.randomize_(ref, 77)
    ref.eval()
    sharded = copy.deepcopy(ref)
    sharding.shard_params_fsdp(sharded, sharding.make_mesh(
        axis_names=("fsdp",)))
    g = torch.Generator(dev).manual_seed(78)
    x = torch.randn((2, 3, size, size), generator=g, device=dev)
    tt = torch.tensor([10.0, 600.0], device=dev)
    _reset_peak(dev)
    loss_ref = ref(x, tt).square().mean()
    loss_ref.backward()
    world = torch.distributed.group.WORLD
    loss = sharded(sharding.shard_batch(x, world),
                   sharding.shard_batch(tt, world)).square().mean()
    loss.backward()
    grad_err = max(
        float((p.grad.full_tensor() - q.grad).abs().max())
        / max(float(q.grad.abs().max()), 1e-30)
        for p, q in zip(sharded.parameters(), ref.parameters()))
    res["fsdp"] = {"loss": float(loss), "ref_loss": float(loss_ref),
                   "loss_rel_err": abs(float(loss) / float(loss_ref) - 1),
                   "grad_rel_err": grad_err, "bound": FSDP_TOL,
                   "params": sum(p.numel() for p in ref.parameters()),
                   "peak_mem_gib": _peak_gib(dev)}
    if res["fsdp"]["loss_rel_err"] > FSDP_TOL or grad_err > FSDP_TOL:
        raise AssertionError(f"FSDP2 against replicated: {res['fsdp']}")
    del ref, sharded, x, loss, loss_ref
    if _cuda(dev):
        torch.cuda.empty_cache()
    peak["fsdp"] = res["fsdp"]["peak_mem_gib"]
    secs["fsdp"] = time.perf_counter() - t0

    res["launches"] = {
        "dwt": dict(probe.dwt_launches),
        "winograd": {k: sum(v["winograd_launches"][k]
                            for v in loops.values())
                     for k in loops["mesh"]["winograd_launches"]}}
    return res


def scale_out_two_ranks(plan, dev) -> dict:
    """Part (b), one of two ranks on the one card, in a gloo group (NCCL
    refuses two ranks on one device): the guided CLI with --dp, one image a
    rank; this rank's CG iterations and launches (exact, as part (a)'s);
    rank 0 keeps the gathered samples; then the gloo collectives' times,
    CUDA tensors through the host."""
    import torch
    probe = CliProbe()
    t0 = time.perf_counter()
    probe.run(scale_out_cli_argv(plan, dev, os.path.join(plan["out"],
                                                         "cli_ranks"), True)
              + ["--dp"])
    res = {"cli": scale_out_cli_record(probe, plan["steps"],
                                       SCALE_OUT_SIGMA_MAX),
           "cli_s": time.perf_counter() - t0,
           "rank": torch.distributed.get_rank(),
           "world": torch.distributed.get_world_size()}
    if torch.distributed.get_rank() == 0:
        torch.save(probe.samples, os.path.join(plan["out"], "b_samples.pt"))
    res["collectives"] = scale_out_collectives(dev, 1 << 20, 50)
    res["launches"] = {"dwt": probe.dwt_launches,
                       "winograd": probe.winograd_launches}
    return res


def scale_out_rank(part: str, plan_path: str) -> int:
    """A rank of the scale_out phase (chip_smoke.py --scale-out PART PLAN,
    under the environment phase_scale_out gives it), started while the
    inputs are written: it waits for PLAN to appear. Part "a" joins the
    launcher's group through the CLI's --dp, part "t" (part (a)'s
    training) through setup_dist, part "b" a gloo group first.
    Writes its record to PLAN's folder as {part}{rank}.json."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # deterministic kernels (cuDNN's, cuBLAS's with the workspace the
    # launcher set): a nondeterministic backward's roundings, scaled by
    # sigma^2 at a high sigma, part two runs of one batch by whole pixels
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    from kdip_tpu_torch.parallel import dist as pdist
    deadline = time.time() + SCALE_OUT_TIMEOUT
    while not os.path.exists(plan_path):  # the inputs are being written
        if time.time() > deadline:
            raise TimeoutError(f"no {plan_path}")
        time.sleep(0.2)
    with open(plan_path) as f:
        plan = json.load(f)
    dev = torch.device(plan["device"], 0) if plan["device"] == "cuda" \
        else torch.device("cpu")
    t0 = time.perf_counter()
    if part == "b":
        pdist.setup_dist(device=plan["device"], backend="gloo")
        res = scale_out_two_ranks(plan, dev)
    elif part == "t":
        res = scale_out_train_rank(plan, dev)
    else:
        res = scale_out_one_rank(plan, dev)
    res["total_s"] = time.perf_counter() - t0
    rank = torch.distributed.get_rank()
    with open(os.path.join(plan["out"], f"{part}{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


def scale_out_start(plan_path: str, part: str, world: int, log_dir: str):
    """Starts `world` ranks of this script's part `part` on a free port of
    localhost (RANK, WORLD_SIZE, LOCAL_RANK 0: every rank on the one card,
    MASTER_ADDR, MASTER_PORT; cuBLAS's deterministic workspace), each
    logging to log_dir/{part}{rank}.log; returns (part, processes, logs)
    for scale_out_wait."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK="0", MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), CUBLAS_WORKSPACE_CONFIG=":4096:8")
        logs.append(os.path.join(log_dir, f"{part}{r}.log"))
        with open(logs[-1], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--scale-out",
                 part, plan_path], env=env, stdout=f,
                stderr=subprocess.STDOUT, cwd=ROOT))
    return part, procs, logs


def scale_out_stop(started) -> None:
    """Kills every rank of `started` that is still running."""
    for _, procs, _ in started:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def scale_out_wait(started, plan_path: str, deadline: float):
    """Waits for every rank of every (part, processes, logs) in `started`
    until `deadline` (time.time()) and returns each part's records;
    raises with a rank's log tail if one failed."""
    for _, procs, _ in started:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    return [_scale_out_records(plan_path, *s) for s in started]


def _scale_out_records(plan_path, part, procs, logs):
    out = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            with open(log) as f:
                tail = f.read()[-4000:]
            raise AssertionError(f"scale_out part {part} rank {r} exited "
                                 f"{p.returncode}:\n{tail}")
        with open(os.path.join(os.path.dirname(plan_path),
                               f"{part}{r}.json")) as f:
            out.append(json.load(f))
    return out


def scale_out_run(root, plan_path, started, deadline, dev):
    """The phase's inputs (written while the ranks start), the plan that
    sets the ranks to work, and their records: (part (a)'s, part (b)'s,
    the seconds)."""
    import torch
    from kdip_tpu_torch import config, weights
    t0 = time.perf_counter()
    cfg_path, ckpt, _, _ = cli_inputs(root, "cli", "test_ffhq_dwt.json",
                                      True, 70, SCALE_OUT_IMAGES)
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["model"]["sigma_max"] = SCALE_OUT_SIGMA_MAX
    cfg_ranks = os.path.join(root, "cli", "config_ranks.json")
    with open(cfg_ranks, "w") as f:
        json.dump(cfg, f)
    train_root = os.path.join(root, "train")
    os.makedirs(train_root)
    train_cfg = write_config(os.path.join(train_root, "config.json"),
                             "train_ffhq_dwt.json",
                             training_folder(train_root, seed=71))
    unet, _ = config.make_openai_model(
        config.load_config(train_cfg)["model"], device="cpu")
    torso = os.path.join(train_root, "torso.pt")
    torch.save(weights.randomize_(unet, 71).state_dict(), torso)
    n_params = sum(p.numel() for p in unet.parameters())
    del unet
    real, fake = write_eval_folders(os.path.join(root, "eval"), seed=72,
                                    n=SCALE_OUT_EVAL, dev=dev)
    pth = os.path.join(root, "pt_inception_random.pth")
    torch.save(random_inception_state_dict(dev, seed=73), pth)
    plan = {"device": dev.type, "steps": SCALE_OUT_STEPS, "out": root,
            "cli": {"config": cfg_path, "config_ranks": cfg_ranks,
                    "ckpt": ckpt, "images": SCALE_OUT_IMAGES,
                    "op": config_path("inpainting_config.yaml")},
            "loop": {"config": config_path("test_ffhq.json"),
                     "B": LOOP_B, "MB": LOOP_MB,
                     "steps": SCALE_OUT_LOOP_STEPS},
            "train": {"config": train_cfg, "ckpt": torso, "B": 2,
                      "params": n_params,
                      "logdir": os.path.join(train_root, "logs")},
            "eval": {"real": real, "fake": fake, "weights": pth,
                     "size": EVAL_SIZE, "batch": EVAL_BATCH,
                     "n": SCALE_OUT_EVAL}}
    with open(plan_path + ".tmp", "w") as f:
        json.dump(plan, f)
    os.replace(plan_path + ".tmp", plan_path)  # the ranks start their work
    parts_s = {"inputs": time.perf_counter() - t0}
    if _cuda(dev):
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    (a,), (t,), b = scale_out_wait(started, plan_path, deadline)
    parts_s.update(ranks_wall=time.perf_counter() - t0, a=a["total_s"],
                   a_training=t["total_s"], b=max(r["total_s"] for r in b))
    return a, t, b, parts_s


def phase_scale_out(tmp, dev):
    """scale_out: the port's data-parallel paths (`kdip_tpu_torch.parallel`)
    at full width, each rank a process of this script. Part (a): one rank
    under NCCL (WORLD_SIZE 1), through the entry points a user calls, as
    two processes side by side: sampling and scoring (scale_out_one_rank)
    and training (scale_out_train_rank). Part (b): two ranks on the one
    card under gloo,
    the guided CLI with --dp, one image a rank: the only run on the card
    where blocks are split, reduced and gathered across ranks; both ranks
    take the same CG iterations and exit at the same residual, within
    SCALE_OUT_RESID_REL of part (a)'s, their fused matvec launches exact,
    and the gathered samples within an RMS of SCALE_OUT_RANKS_RMS of part
    (a)'s (both at sigma_max SCALE_OUT_SIGMA_MAX). The parts run side by
    side, started while scale_out_run writes the inputs: the CLI's
    Lightning checkpoint of seeded random ADMUNetV2 weights and
    SCALE_OUT_IMAGES PNGs (cli_inputs), the fine-tune's torso and folder,
    two folders of SCALE_OUT_EVAL images and a seeded Inception; every
    rank is stopped when the phase ends, whatever ends it. Prints the
    phase's and each part's seconds, the per-rank peak memory and the
    collectives' times. Returns the DWT and Winograd launches of every run
    in the phase."""
    import torch
    root = os.path.join(tmp, "scale_out")
    os.makedirs(root)
    # both parts start now, their processes' start-up beside the inputs'
    # writing; part (b)'s two ranks run beside part (a)'s one
    plan_path = os.path.join(root, "plan.json")
    started = [scale_out_start(plan_path, "a", 1, root),
               scale_out_start(plan_path, "t", 1, root),
               scale_out_start(plan_path, "b", 2, root)]
    deadline = time.time() + SCALE_OUT_TIMEOUT
    try:
        a, t, b, parts_s = scale_out_run(root, plan_path, started,
                                         deadline, dev)
    finally:
        scale_out_stop(started)

    want = torch.cat(torch.load(os.path.join(root, "a_samples.pt")))
    got = torch.cat(torch.load(os.path.join(root, "b_samples.pt")))
    err = float((got - want).abs().max())
    rms = float((got - want).square().mean().sqrt())
    iters = [r["cli"]["cg_total_iters"] for r in b]
    # each sampler call's CG exit residual: the joint one on both ranks
    resid = [[c["cg_max_residual"] for c in r["cli"]["calls"]] for r in b]
    ref = [c["cg_max_residual"]
           for c in a["cli"]["ranks_ref"]["calls"]]
    resid_rel = max(abs(x / y - 1) for rr in resid for x, y in zip(rr, ref))
    if got.shape != want.shape or not rms <= SCALE_OUT_RANKS_RMS or \
            iters[0] != iters[1] or resid[0] != resid[1] or \
            not resid_rel <= SCALE_OUT_RESID_REL or \
            any(r["world"] != 2 for r in b):
        raise AssertionError(f"two ranks on one card against part (a): RMS "
                             f"{rms} (bound {SCALE_OUT_RANKS_RMS}), max "
                             f"{err}, CG iterations {iters}, CG residuals "
                             f"{resid} against {ref} (relative {resid_rel},"
                             f" bound {SCALE_OUT_RESID_REL})")
    runs = [a, t] + b
    dwt = {k: sum(r["launches"]["dwt"][k] for r in runs)
           for k in a["launches"]["dwt"]}
    wino = {k: sum(r["launches"]["winograd"][k] for r in runs)
            for k in t["launches"]["winograd"]}
    emit({"phase": "scale_out", "steps": SCALE_OUT_STEPS,
          "images": SCALE_OUT_IMAGES, "parts_s": parts_s,
          "a": {k: v for k, v in a.items() if k != "launches"},
          "a_training": {k: v for k, v in t.items() if k != "launches"},
          "b": [{k: v for k, v in r.items() if k != "launches"} for r in b],
          "b_vs_a_rms": rms, "b_vs_a_rms_bound": SCALE_OUT_RANKS_RMS,
          "b_vs_a_max_abs": err, "sigma_max_b": SCALE_OUT_SIGMA_MAX,
          "b_cg_total_iters": iters, "b_cg_max_residual": resid,
          "a_ref_cg_max_residual": ref, "b_vs_a_resid_rel": resid_rel,
          "b_vs_a_resid_rel_bound": SCALE_OUT_RESID_REL,
          "a_ref_cg_total_iters": a["cli"]["ranks_ref"]["cg_total_iters"],
          "peak_mem_gib": {"a_rank0": a["peak_mem_gib"],
                           "a_training_rank0": t["peak_mem_gib"],
                           **{f"b_rank{r['rank']}":
                              r["cli"]["peak_mem_gib"] for r in b}},
          "dwt_launches": dwt, "winograd_launches": wino,
          "nvidia_smi": nvidia_smi() if _cuda(dev) else None})
    return dwt, wino


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    try:
        import kdip_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the kdip_tpu_torch package is not beside this "
              f"script: {e}", file=sys.stderr)
        return 2
    from kdip_tpu_torch import guidance as gd
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args, **kw):
        """fn(*args, **kw), its seconds recorded under `name`."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t0
        return out

    timed("device_and_build", phase_device_and_build)
    timed("kernels", phase_kernels, dev)

    dwt_cfg = gd.GuidanceConfig("I", ortho_tf_type="dwt", mle_sigma_thres=1.0)
    rec, parts = timed("slice_dwt_var", run_slice, "slice_dwt_var", dev, True,
                       dwt_cfg, seed=0, n=N_SAMPLES)
    emit(rec)
    launches = rec["dwt_launches"]
    # one matvec per CG iteration, and the initial residual's of each solve
    solves = N_SAMPLES * guided_nfes_below(dwt_cfg.mle_sigma_thres)
    want = rec["cg_total_iters"] + solves
    emit({"phase": "slice_dwt_var_launches", "cg_solves": solves,
          "haar_ot_matvec_expected": want, "dwt_launches": launches})
    if (launches["haar_ot_matvec"] != want or launches["haar_dwt2"]
            or launches["haar_idwt2"]):
        raise AssertionError(f"DWT-Var: {launches['haar_ot_matvec']} fused "
                             f"matvec launches, expected {want}")
    batched = timed("slice_dwt_var_batched", run_batched_twin,
                    "slice_dwt_var_batched", rec, dev, True, dwt_cfg, seed=0)
    batched_launches = batched["dwt_launches"]
    # one solve per guided call below the threshold for the whole batch
    want = batched["cg_total_iters"] + guided_nfes_below(
        dwt_cfg.mle_sigma_thres)
    if batched_launches != {"haar_dwt2": 0, "haar_idwt2": 0,
                            "haar_ot_matvec": want}:
        raise AssertionError(f"batched DWT-Var: launches {batched_launches}"
                             f", expected {want} fused matvecs")

    timed("nfe_kernel_vs_plain_dwt", phase_nfe_compare, dev, dwt_cfg, parts)
    del parts
    torch.cuda.empty_cache()

    autoi_launches, (autoi_cfg, parts) = timed(
        "slice_autoI_dwt_var", run_autoi_slice, dev)
    timed("nfe_autoI", phase_nfe_autoi, dev, autoi_cfg, parts)
    timed("nfe_loglikelihood", phase_nfe_loglikelihood, dev, autoi_cfg,
          parts)
    del parts
    torch.cuda.empty_cache()

    convert_cfg = gd.GuidanceConfig("I", "convert")
    rec, _ = timed("slice_convert", run_slice, "slice_convert", dev, False,
                   convert_cfg, seed=1, n=N_SAMPLES)
    emit(rec)
    batched = timed("slice_convert_batched", run_batched_twin,
                    "slice_convert_batched", rec, dev, False, convert_cfg,
                    seed=1)
    check_no_dwt(batched)

    timed("kernels_winograd", phase_kernels_winograd, dev)
    rec, parts = timed("slice_convert_winograd", run_slice,
                       "slice_convert_winograd", dev, False, convert_cfg,
                       seed=2, n=N_SAMPLES, winograd=True)
    emit(rec)
    wino_launches = rec["winograd_launches"]
    if not all(v > 0 for v in wino_launches.values()):
        raise AssertionError(f"the Winograd run launched no kernel: "
                             f"{wino_launches}")
    timed("nfe_winograd", phase_nfe_winograd, dev, convert_cfg, parts)
    timed("winograd_shapes", lambda: phase_winograd_shapes(
        dev, winograd_launch_shapes(parts[0], dev)))
    del parts
    torch.cuda.empty_cache()

    deblur_launches, nfes = timed("blur_sr_slices", run_blur_sr_slices, dev)
    for name, (gcfg, v2, parts) in nfes.items():
        timed(name, phase_nfe_traced, name, dev, gcfg, v2, parts)
    del nfes, parts
    torch.cuda.empty_cache()

    by_slice = {"slice_dwt_var": launches,
                "slice_dwt_var_batched": batched_launches,
                "slice_autoI_dwt_var": autoi_launches,
                "slice_gaussian_deblur_dwt_var": deblur_launches}
    by_slice.update(timed("type_ii_and_dct_slices",
                          run_type_ii_and_dct_slices, dev))
    iso_launches, parts = timed("iso_slices", run_iso_slices, dev)
    by_slice.update(iso_launches)
    G = gd.GuidanceConfig
    stsl = G("stsl", "pgdm", zeta=1.0, eta=1.0, num_hutchinson_samples=2)
    timed("nfe_stsl", phase_nfe_traced, "nfe_stsl", dev, stsl, False, parts,
          sigma=STSL_NFE_SIGMA)
    mle = G("pgdm+mle", "convert")
    for side, sigma in (("below", 0.5 * mle.mle_sigma_thres),
                        ("above", 2.0 * mle.mle_sigma_thres)):
        timed(f"nfe_pgdm+mle_{side}", phase_nfe_traced,
              f"nfe_pgdm+mle_{side}", dev, mle, False, parts, sigma=sigma)
    del parts
    torch.cuda.empty_cache()
    by_slice.update(timed("nonlinear_slices", run_nonlinear_slices, dev))
    torch.cuda.empty_cache()

    wino_by_slice = {"slice_convert_winograd": wino_launches}
    with tempfile.TemporaryDirectory() as tmp:
        lpips_npz = os.path.join(tmp, "lpips_vgg.npz")
        random_lpips_npz(lpips_npz)
        for name, cfg_name, v2, wino, n_images, seed, kw in (
                ("cli_dwt_var", "test_ffhq_dwt.json", True, False,
                 CLI_DWT_IMAGES, 20, {}),
                ("cli_convert_winograd", "test_ffhq.json", False, True,
                 CLI_WINO_IMAGES, 21, {"want_per_nfe": FFHQ_WINO_PER_NFE}),
                ("cli_imagenet_winograd", "test_imagenet.json", False, True,
                 CLI_IMAGENET_IMAGES, 22,
                 {"want_per_nfe": IMAGENET_WINO_PER_NFE}),
                ("cli_kdiff_v2_dwt", KDIFF_CLI_MODEL, False, False,
                 CLI_KDIFF_IMAGES, 23, {"dtype": "float32"})):
            _, probe = timed(name, run_cli, name, tmp, lpips_npz, cfg_name,
                             v2, wino, n_images, seed, **kw)
            by_slice[name] = probe.dwt_launches
            wino_by_slice[name] = probe.winograd_launches
            torch.cuda.empty_cache()
        # the ImageNet checkpoint of cli_imagenet_winograd (seeded random
        # weights), rather than writing its 2.2 GB again
        name = "analytic_variance_imagenet"
        by_slice[name], wino_by_slice[name] = timed(
            name, phase_analytic_variance_imagenet, tmp, os.path.join(
                tmp, "cli_imagenet_winograd", "model.pt"), lpips_npz)
        torch.cuda.empty_cache()
        name = "train_ffhq_dwt"
        by_slice[name], wino_by_slice[name] = timed(
            name, phase_train_ffhq_dwt, tmp, dev)
        torch.cuda.empty_cache()
        name = "train_loop_ffhq_winograd"
        by_slice[name], wino_by_slice[name] = timed(
            name, phase_train_loop_ffhq_winograd, tmp, dev)
        torch.cuda.empty_cache()
        name = "evaluate_fid_inception"
        by_slice[name], wino_by_slice[name] = timed(
            name, phase_evaluate_fid_inception, tmp, dev, lpips_npz)
        torch.cuda.empty_cache()
    name = "nfe_imagenet_winograd"
    by_slice[name], wino_by_slice[name] = timed(name, run_imagenet_nfe, dev,
                                                convert_cfg)
    for name, phase in (("adm_rest_cpu_vs_card", phase_adm_rest_cpu_vs_card),
                        ("no_scale_shift_winograd",
                         phase_no_scale_shift_winograd)):
        by_slice[name], wino_by_slice[name] = timed(name, phase, dev)
    torch.cuda.empty_cache()
    timed("bench_torch", phase_bench_torch)
    with tempfile.TemporaryDirectory() as tmp:
        by_slice["uncond_cli"], wino_by_slice["uncond_cli"] = timed(
            "uncond_cli", run_uncond_cli, tmp)
    torch.cuda.empty_cache()
    by_slice["samplers_rest"], wino_by_slice["samplers_rest"] = timed(
        "samplers_rest", run_samplers_rest, dev)
    torch.cuda.empty_cache()
    by_slice["uncond_cpu_vs_card"], wino_by_slice["uncond_cpu_vs_card"] = \
        timed("uncond_cpu_vs_card", phase_uncond_cpu_vs_card, dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        by_slice["scale_out"], wino_by_slice["scale_out"] = timed(
            "scale_out", phase_scale_out, tmp, dev)

    rows = timed("kernel_rows", kernel_rows, dev, {
        k: sum(c[k] for c in by_slice.values()) for k in launches})
    for row in rows:
        row["launches_by_slice"] = {s: c[row["name"]]
                                    for s, c in by_slice.items()}
    wrows = timed("wino_kernel_rows", wino_kernel_rows, dev, {
        k: sum(c[k] for c in wino_by_slice.values()) for k in wino_launches})
    for row in wrows:
        row["launches_by_slice"] = {s: c[row["name"]]
                                    for s, c in wino_by_slice.items()}
    emit({"kernels": rows + wrows})
    emit({"phase": "done", "total_s": time.perf_counter() - t_start,
          "phase_seconds": seconds})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--scale-out"]:
        sys.exit(scale_out_rank(sys.argv[2], sys.argv[3]))
    sys.exit(main())
