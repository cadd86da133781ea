#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100 (sm_90a).

Drives the port's paths with random weights from a seed, each at its
model's full width, and checks every hand-written kernel on them against
its plain PyTorch version:

- eval-mode MannequinChallenge depth serving through
  ``consistent_depth_tpu_torch.serving.DepthServer`` on 224x384 frames
  (kernels: ``csrc/same_conv_tc.cu`` for bf16 and ``csrc/same_conv_tf32.cu``
  for f32, both on the tensor cores; ``csrc/same_conv.cu``, the FMA
  template, for the shapes they do not take);
- full FlowNet2 optical flow (C->S->S + SD + fusion) in f32 through
  ``consistent_depth_tpu_torch.flow.runner.TorchFlowBackend`` at the flow
  stage's 448x1024 feed, then the flow stage's masks and visualisation
  (kernel: ``csrc/correlation.cu``, the banded route; the generic route,
  for arguments the banded kernel does not take, is checked beside it);
- the ``mc`` fine-tune stage through
  ``consistent_depth_tpu_torch.training``: ``TrainingEngine.train_step``,
  ``train_epoch`` and ``eval_epoch`` on the reference demo workload of
  ``bench.py::make_workload`` (244 frames at 224x384, the hierarchical2
  pair set of 715 pairs, batch 4 pairs), in bf16 and f32, f32 being the
  fine-tune's default precision, then the driver ``DepthFineTuner``
  (epochs, eval passes, checkpoints, resume, ``save_depth``) on a scratch
  dataset directory of 24 such frames (the same kernels, forward and
  grad-input);
- the whole pipeline through the port's CLI, ``python -m
  consistent_depth_tpu_torch`` (``cli.main.main``): downscaling, initial
  depth, scale calibration, FlowNet2 on the missing pairs, masks, pair
  filter, visualisations, fine-tuning and final depth, on a scratch
  dataset of 24 frames of a synthetic plane scene (every kernel above);
- the midas2 and monodepth2 backbones at full width and depth: their conv
  classes, the train step, the engine's passes, serving and the CLI (the
  k x k conv kernel on their stride-1 3x3 convs, forward and grad-input);
- the data mesh (``consistent_depth_tpu_torch.parallel``): the ``mc`` train
  step, the paired eval and serving on two ranks that share the card over
  gloo, and the train step on one NCCL rank (the k x k conv kernel, forward
  and grad-input, in every rank).

Phases, each printing one JSON line:

1. device: a CUDA card of compute capability 9.0, its name and power limit;
2. build: compile the CUDA sources of the checkout into ``build/cuda/``;
3. kernels: for every conv shape the main path launches (recorded from one
   batch-8 forward at 224x384), the kernel of the plan's route against
   ``same_conv_reference`` in f32 (TF32 off) and bf16, both times from
   CUDA events (in f32 also the FMA template's, the design the 3xTF32
   kernel replaced), the class's GFLOP, its bound by route (the larger of
   its operations over the route's peak and its bytes over 3.35 TB/s; f32
   rows give the 3xTF32 and the FMA bound), TFLOP/s and share of the
   bound; then, untimed, ragged cases (1x7x13 k=11 64->16, 2x14x24
   32->64), the stem's grad-input (2x64x96, which takes the FMA template
   in both dtypes) and every class of the train phase's 64x96 check, in
   both directions;
4. serve: two interleaved 224x384 videos of 32 frames plus three 230x380
   frames (the 240x384 bucket) at batch 8 in bf16: shapes, finite depths,
   the kernels' launch counts by route, agreement with an f32 server,
   frames/s; and the f32 path on the card against the same model on the
   CPU;
5. correlation: the kernel of the route ``flow/correlation.py::_plan``
   gives against ``correlation_reference`` in f32 at the shape recorded
   from one FlowNet2 forward at 448x1024 (1x56x128x256), at
   2x56x128x256, at 1x72x128x256 (the 576x1024 feed), at a ragged
   1x7x13x64, with max displacement 4, at a ragged 1x28x130x256 and at
   1x56x96x256, phase 11's 448x768 feed (banded), with stride 1 and with
   C = 66 (generic); each row with its route, the times from CUDA events
   and the kernel's device time from events around calls queued behind a
   sleep kernel; then at 1x56x128x256 the banded kernel with each dy-group
   size G of ``GROUPS`` and the generic kernel (the first port's design) on
   the same inputs;
6. flow: FlowNet2 on four directed pairs of 448x1024 frames: shapes,
   finite flow, one correlation launch per pair, all on the banded route,
   agreement with the same
   network using ``correlation_reference``, the card against the CPU on a
   64x128 pair, ms per pair; then ``consistent_flow_masks`` and
   ``flow_to_image_torch`` on those flows against the CPU, and the flow
   stage's mask and visualisation passes (``pipeline.flow_stage.Flow``) on
   the card, whose masks must match the CPU's;
7. grad-input kernel: for every (cotangent, weight) shape that one bf16
   train step sends through ``same_conv_grad_input``, the kernel of the
   plan's route against ``same_conv_grad_input_reference`` in f32 (TF32
   off) and bf16, its time, the plain version's and cuDNN's dgrad's from
   CUDA events (f32: the FMA template's too), and the numbers of phase 3;
8. train: the workload resident on the card; 68 forward and 67 grad-input
   launches per step, by the routes the plan gives; a finite loss and a
   finite gradient for every parameter (non-zero except the confidence
   head's, which the loss does not read); the f32 step with the kernels
   against the same step with their plain versions; the f32 step on the
   card against the CPU at
   64x96 (loss, BN running stats, and gradients with eval-mode BN); the
   bf16 step's loss against the f32 step's; the NaN-skip; ms per step in
   bf16 and f32 (CUDA events, host clock, and the host's time to queue the
   steps), the peak memory, and the device idle share and kernel split from
   ``torch.profiler``;
9. epoch: on phase 8's resident data and engines, the first 8 batches of a
   paired f32 eval with the kernels against the same with
   ``same_conv_reference`` (per-pair losses, depth buffer); then per
   precision (f32, bf16) one full ``train_epoch`` of 179 steps with the
   driver's capture slots at display_freq 100 and one ``eval_epoch``
   (paired in f32, deduplicated in bf16), each under the sync debug mode
   "error", so that any hidden host read raises: ms per step and per pass
   by CUDA events and host clock, the host's issue time, the launches by
   route (68 x 179 forward and 67 x 179 grad-input per epoch; 68 x 179 or
   68 x 31 forward per eval pass), no skipped step, the captured slots, all
   frames seen; and the device idle share over a profiled epoch of 12
   steps;
10. driver: ``DepthFineTuner`` in f32 on a scratch dataset directory under
   ``build/chip_smoke_ft/`` (24 frames at 224x384, 60 pairs), 2 epochs with
   an eval pass before training and after each epoch, checkpoints and
   ``--resume``, then ``save_depth``, then a resumed run to a third epoch:
   the tag directory, the eval loss JSONs and depth dumps, ``0001.pth`` and
   ``0002.pth`` loading strict=True (``0002.pth`` equal to the final
   weights), 24 final depths, a TensorBoard event file, the launches of
   each run, wall seconds per epoch and per eval; the directory is then
   deleted and the driver's console output kept in
   ``build/chip_smoke_driver.log``;
11. cli: under ``build/chip_smoke_cli/`` a reference-layout dataset of the
   plane scene of ``tests/synthetic.py::make_scene`` (rebuilt here with
   numpy and the port's geometry): 24 frames at 224x384, ``color_full`` at
   448x768, COLMAP's poses and inverse depth, exact flows for every
   two-way hierarchical2 pair but those within frames 0-3; the tamed
   seeded ``mc`` weights and the seeded FlowNet2 as ``mc.pth`` and
   ``flownet2.pth`` under a scratch ``CDTPU_CHECKPOINT_DIR``. Then
   ``cli.main.main(["--path", d, "--num_epochs", "2", "--resume"])``
   in-process at the CLI's defaults: the artifact tree of
   ``tests/test_pipeline_e2e.py::test_full_pipeline`` with the tag
   ``B0.1_R1.0_PL1-0_LR0.0004_BS4_Oadam``, every exact pair in
   ``flow_list.json``, the scales against numpy's ``nanmedian`` of the same
   files (1e-6), ``0001.pth`` and ``0002.pth`` loading strict, finite final
   depths, one banded correlation per FlowNet2 pair at phase 5's
   1x56x96x256 case, finite FlowNet2 flows of the depth size, the first
   FlowNet2 pair against the same pair through ``correlation_reference``,
   68 forward launches per forward and 67 grad-input launches per step by
   the plan's route, the first two initial depths against the port on the
   CPU, and seconds per stage; then ``python -m consistent_depth_tpu_torch`` again on the
   directory: exit 0, every stage before fine-tuning finding its outputs
   (no file outside the tag directory touched), no train step; and the
   same command under ``CUDA_VISIBLE_DEVICES=""`` exiting non-zero with
   the port's no-card message before it writes. The CLI's console is kept
   in ``build/chip_smoke_cli.log`` and the directory kept for phases 12-13;
12-13. backbone, for midas2 (MiDaS v2: ResNeXt-101 32x8d 3-4-23-3 with the
   256-wide decoder) and monodepth2 (ResNet-18 at the released 320x1024
   feed), each at full width and depth from seed 0 (midas2's output conv
   tamed: weight x 0.05, bias + 5), written as its default checkpoint
   (``midas2.pth``; the ``monodepth2_mono+stereo_1024x320/`` directory with
   ``encoder.pth`` and ``depth.pth``) in phase 11's
   ``CDTPU_CHECKPOINT_DIR``, from which every model below is built: every
   conv class that ``same_conv`` and ``same_conv_grad_input`` see in one
   batch-8 forward and one train step at 224x384, against plain in f32 and
   bf16 with the bands of phases 3 and 7, timed against cuDNN; 20 and 20
   (midas2) or 13 and 13 (monodepth2) launches per forward and per step, by
   the plan's routes; on phase 8's resident data the f32 step with the
   kernels against plain, the card against the CPU at 64x96 (in f64 within
   phase 8's bands; in f32 within the card's own gap with the plain
   version in the kernels' place plus phase 8's bands; every conv class of
   that step against plain with the bands of phases 3 and 7) and, for
   midas2, the NaN-skip with the untamed output conv, bitwise; 3 warm-up
   and 20 timed ``train_step``s in f32 (profiled) and bf16; 8 paired eval
   batches and an ``infer`` under the sync debug mode "error"; serving
   through ``DepthServer(ServeConfig(model_type=...))`` in bf16 at batch 8
   (32 frames at 224x384 and three 230x380 frames): frames/s, launches,
   bf16 against f32; then the CLI, ``--model_type`` with one epoch on phase
   11's directory (its flows and frames reused): the tag, the range and
   initial-depth directories, finite depths and losses, the launches by
   route, frame 0's initial depth against the CPU. midas2's outputs are
   compared less its output bias, the network's own part of its disparity.
   The directory is deleted after phase 13.
14. mesh: (a) two ranks spawned on cuda:0 with gloo (NCCL refuses two
   ranks on one GPU) and (c) the same ranks serving, against the
   one-process engine and server run meanwhile on the same inputs: phase
   8's recipe at global batch 4 (2 per rank), the paired f32 eval's first 4
   batches from the initial weights, then 3 ``train_step``s in f32 and in
   bf16: the first f32 loss within phase 8's band, the later ones within
   tests/test_torch_epoch.py's band for the step after an Adam update, bf16
   within phase 8's bf16 band, the parameters within tests/test_engine.py's
   band for the JAX mesh step, both ranks' states bitwise equal, each rank's k x k launches and
   routes equal to the one-process run's; 35 frames served at batch 8 in
   bf16, the ranks' depths equal and within serving's bf16 band of the
   one-process server. (b) ``make_mesh()`` under a one-rank environment
   (NCCL on cuda:0, the global BN path): its f32 step against the engine
   without a mesh (loss and gradients), then 20 interleaved timed steps of
   each, medians from CUDA events, the NCCL step's extra ms, and each
   engine's device time and idle share over 5 profiled steps; seconds of
   the phase.
15. aux: under ``build/chip_smoke_aux/`` (deleted after), ``mc`` at full
   width from phase 8's init: ``DepthModel.save``, a reload bitwise equal,
   ``forward`` with ``metadata["scales"]`` bitwise ``apply``, the reloaded
   model's forward bitwise the original's, a train-mode ``forward`` moving
   the running stats, on one video of 8 frames at 224x384 in f32 (272 k x k
   launches by the plan's routes), and the kernels' forward against plain;
   ``ops.geometry.calibrate_scale`` on two plane-scene pairs and the
   weighted MSE and RMSE losses (values and gradients) on the card against
   the CPU (1e-5); ``visualize_calibration_pair`` on the card against the
   CPU (1 level); ``calibrate_w_sparse_colmap`` on a sparse model of the
   plane scene at 1/2.75 its size written by the port's ``write_model``,
   recovering 2.75 (1e-5) for the frames that have a depth file.

Then the card's name and power limit as nvidia-smi prints them, a
``{"kernels": [...]}`` line, whose launches add up each path's run
(``launches_by_path`` splits them): for the conv's mc entries one phase-9
epoch per precision, phase 11, phase 14's mesh ranks (``mesh``) and
phase 15's forwards (``aux``), with the times of mc's classes; for each
backbone's entries (``same_conv_midas2``, ...) its timed steps and CLI run,
with the times of its own classes; phase 6 and phase 11 for the
correlation. Last comes ``{"ok": true, "device": {...}}``.
Any failure raises and exits non-zero.

Usage, from the root of a checkout: ``python3 chip_smoke.py``
"""

import io
import json
import math
import os
import shutil
import subprocess
import sys
import time
from collections import Counter
from contextlib import contextmanager, nullcontext, redirect_stdout
from itertools import islice

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SIZE = (224, 384)
ODD_SIZE = (230, 380)      # lands in the 240x384 bucket
FRAMES_PER_VIDEO = 32
ODD_FRAMES = 3
BATCH = 8
# kernel against plain, max |kernel - reference| / max |reference|:
# f32 differs only by summation order (up to 7744 terms at k=11, Ci=64);
# bf16 output is rounded once to 8 mantissa bits (2^-8 relative), against
# an f32 reference on the same bf16-rounded inputs
TOL_F32 = 1e-4
TOL_BF16 = 2 ** -7
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): bf16 and
# TF32 on the tensor cores, f32 on the FMA pipes, and the HBM rate; each
# kernel's bound is the larger of its operations over the peak and its
# bytes over the rate
PEAK_TFLOPS = {"bf16": 989.0, "tf32": 495.0, "f32": 67.0}
HBM_BYTES_PER_S = 3.35e12
# each conv route's peak and its operations per FLOP of the conv: the
# 3xTF32 kernel does three TF32 products for each product
ROUTE_PEAK = {"tc": ("bf16", 1), "tf32": ("tf32", 3), "fma": ("f32", 1)}
CONV_SOURCES = {r: f"consistent_depth_tpu_torch/csrc/{f}" for r, f in (
    ("tc", "same_conv_tc.cu"), ("tf32", "same_conv_tf32.cu"),
    ("fma", "same_conv.cu"))}
# bf16 server against f32 server: relative L2 error of the depth, the band
# of the JAX package's bf16 test (tests/test_bf16.py)
TOL_SERVE_BF16 = 0.05
# f32 on the card against the plain path on the CPU: the hourglass parity
# band of the JAX package's twin test (tests/test_hourglass.py)
TOL_CPU_REF = 1e-4
# flow path: the FlowNet2 feed of the pipeline (process.py aligns frames to
# 64, at most 1024 wide), one pair per forward, f32
FLOW_SIZE = (448, 1024)
FLOW_PAIRS = [(0, 1), (1, 0), (1, 2), (2, 1)]
# correlation against plain, max |kernel - reference| / max |reference|:
# one f32 sum over C = 256 channels taken in another order
TOL_CORR = 1e-5
# a sleep kernel of 2e7 clocks (>= 10 ms at the H100's 1.98 GHz) lets the
# host enqueue a kernel's timed calls before the first starts; a try whose
# enqueueing outlasts it is repeated behind a sleep twice as long
QUEUE_SLEEP_CYCLES = 20_000_000
QUEUE_MAX_HOST_S = 0.008
QUEUE_TRIES = 4
# (name, (B, H, W, C), max_displacement, stride, route); the first is
# checked against the shape recorded from the FlowNet2 forward of phase 6,
# CLI_CORR_CASE against those of phase 11
CORR_CASES = [
    ("flownet2_448x1024", (1, 56, 128, 256), 20, 2, "banded"),
    ("bench_2x56x128", (2, 56, 128, 256), 20, 2, "banded"),
    ("feed_576x1024", (1, 72, 128, 256), 20, 2, "banded"),
    ("ragged", (1, 7, 13, 64), 20, 2, "banded"),
    ("max_disp_4", (1, 56, 128, 256), 4, 2, "banded"),
    ("stride_1", (1, 28, 64, 64), 4, 1, "generic"),
    ("channels_66", (1, 28, 64, 66), 20, 2, "generic"),
    ("ragged_w130", (1, 28, 130, 256), 20, 2, "banded"),
    ("cli_448x768", (1, 56, 96, 256), 20, 2, "banded"),
]
# the case of phase 11's FlowNet2 calls (its 448x768 feed)
CLI_CORR_CASE = "cli_448x768"
# FlowNet2 with the kernel against FlowNet2 with correlation_reference, and
# the card against the CPU: max |d| / max |flow|, the cascade band of
# tests/test_torch_flownet.py (only summation orders differ)
TOL_FLOW = 1e-4
# masks may differ where an f32 sum lies within rounding of its threshold;
# colours by one level where floor() meets a rounding difference
TOL_MASK_FRACTION = 1e-3
TOL_COLOUR_LEVELS = 1.0
# train path: bench.py::make_workload's reference demo workload, the mc
# settings of the reference demo (B0.1_R1.0, Adam, LR 4e-4, BS 4 pairs)
TRAIN_FRAMES = 244
TRAIN_PAIRS = 715           # hierarchical2 over 244 frames
TRAIN_BATCH = 4
TRAIN_LR = 4e-4
WARMUP_STEPS = 3
TIMED_STEPS = 20
PROFILED_STEPS = 5
# a random init emits extreme log-depths and exp() then blows up the 1/z
# gradients; a pretrained net predicts O(1) depths. Scale the prediction
# head as tests/test_bf16.py does.
TAME_HEAD = 0.05
# kernel against plain, f32 step: the loss; the gradients (relative L2
# over all parameters), whose band covers train-mode BN dividing by the
# batch sigma at each of ~70 layers at random init, which amplifies
# summation-order differences (the port's own f32 gradients differ from
# its f64 gradients by 2.4e-3 relative on the CPU at 32x48)
TOL_STEP_LOSS = 1e-5
TOL_STEP_GRADS = 1e-2
# card against CPU, f32, two pairs of the same recipe's data at 64x96: the
# loss and the BN running stats after the step (max |d| / max |ref| per
# tensor), and the gradients with eval-mode BN (relative L2), where no batch
# statistics amplify anything (measured 6.1e-7). A 64x96 crop of the
# 224x384 data would keep intrinsics whose principal point lies outside
# the crop; its f32 gradients differ from f64 by 1.5e-5 on the CPU alone.
TRAIN_SMALL_SIZE = (64, 96)
TOL_CPU_LOSS = 1e-5
TOL_CPU_STATS = 1e-4
TOL_CPU_GRADS = 1e-5
# bf16 step against f32 step: relative loss difference (tests/test_bf16.py)
TOL_TRAIN_BF16 = 0.05
# the parameters the loss does not read: the confidence head
NO_GRAD_PARAMS = ("uncertainty_layer.",)
# epoch path (phase 9): the driver's display-freq capture rule at the
# default display_freq, which picks 7 of the 179 steps (715 pairs: the
# count of pairs reaches 100, ..., 700); the profiled window; the paired f32
# eval's first batches with the kernels against plain, per-pair losses
# (relative) and the depth buffer (over max |plain|)
DISPLAY_FREQ = 100
EXPECTED_CAPTURES = 7
PROFILED_EPOCH_STEPS = 12
DEBUG_COST_STEPS = 20
EVAL_CHECK_BATCHES = 8
TOL_EVAL_PLAIN = 1e-4
# driver path (phase 10): the same recipe at 224x384 over 24 frames (60
# hierarchical2 pairs, 15 steps of 4), two epochs, then a resumed third;
# display_freq 20 captures three steps per epoch
FT_FRAMES = 24
FT_EPOCHS = 2
FT_DISPLAY_FREQ = 20
FT_TAG = "B0.1_R1.0_PL1-0_LR0.0004_BS4_Oadam"
# CLI path (phase 11): the plane scene of tests/synthetic.py::make_scene at
# the demo's depth size, its colour frames at twice that; the CLI's
# defaults (mc, --size 384, hierarchical2, f32, batch 4, lr 4e-4) with two
# epochs and --resume; FlowNet2 computes the flows of the pairs within
# frames 0-3, the others are exact. The scales against numpy's nanmedian of
# the same files: one f32 ratio per pixel, the median of an even count
# being the mean of two.
CLI_FRAMES = 24
CLI_SIZE = (224, 384)
CLI_FULL_SIZE = (448, 768)
CLI_FLOWNET_FRAMES = (0, 1, 2, 3)
CLI_EPOCHS = 2
CLI_ARGS = ["--num_epochs", str(CLI_EPOCHS), "--resume"]
CLI_TAG = "B0.1_R1.0_PL1-0_LR0.0004_BS4_Oadam"
TOL_CLI_SCALES = 1e-6
# backbone paths (phases 12-13): midas2 (ResNeXt-101 32x8d 3-4-23-3 with
# the 256-wide decoder) and monodepth2 (ResNet-18 at the released 320x1024
# feed), each at full width and depth from seed 0, written as the default
# checkpoint under phase 11's CDTPU_CHECKPOINT_DIR. A seeded MiDaS emits
# ReLU'd ~zero disparity and depth = 1/disparity NaNs the loss, so its
# output bias is raised by 5 (tests/test_engine_backbones.py) and, as its
# decoder has no BN and one Adam step at lr 1e-4 then drives some pixel's
# disparity to 0 again, its output weight scaled by TAME_HEAD; the
# NaN-skip runs with the untamed output conv. Routed convs per forward and
# grad-inputs per step, as the plan routes them: midas2's 4 transition
# convs, 14 residual-unit convs and 2 output convs; monodepth2's 13
# stride-1 3x3 convs of ResNet-18 (its reflect-padded decoder stays on
# cuDNN)
BACKBONES = ("midas2", "monodepth2")
MIDAS_TAME = 5.0
# the card against the CPU at 64x96 (phase 8's bands, TOL_CPU_*): in f64,
# where rounding hides nothing; in f32, the card with the kernels against
# the card with the plain version in their place, each against the CPU.
# midas2's f32 gradients are rounding-limited at this size: on an H100 the
# card's f32 reads 1.2e-3 from f64 with the kernels and with cuDNN in
# their place alike, 2.8e-4 with cuDNN disabled, as the CPU's own f32
# (2.7e-4); cuDNN's f32 1x1 convs carry it (tools/
# torch_backbone_precision.py, PERF.md section 6)
BACKBONE_CONVS = {"midas2": (20, 20), "monodepth2": (13, 13)}
MONODEPTH2_DIR = "monodepth2_mono+stereo_1024x320"
MONODEPTH2_FEED = (320, 1024)
# the CLI on phase 11's directory, one epoch, at each backbone's defaults
BACKBONE_CLI_EPOCHS = 1
BACKBONE_TAGS = {"midas2": "B0.0001_R1.0_PL1-0_LR0.0001_BS4_Oadam",
                 "monodepth2": "B1_R1.0_PL1-0_LR4e-05_BS4_Oadam"}


# mesh path (phase 14): two ranks on the one card over gloo (NCCL refuses
# two ranks on one GPU), phase 8's recipe at global batch TRAIN_BATCH (2 per
# rank): MESH_STEPS train steps per precision, the paired f32 eval's first
# MESH_EVAL_BATCHES batches, and MESH_SERVE_FRAMES frames served at batch
# BATCH in bf16; against the one-process engine and server on the same
# inputs. A step after the first Adam update moves every parameter by about
# lr times the sign of its gradient, so gradients near zero whose sign
# differs by rounding move by the whole lr: the later steps' losses take
# tests/test_torch_epoch.py's band for that step. Then one rank over NCCL
# (make_mesh's defaults) against the engine without a mesh, and
# MESH_TIMED_STEPS timed f32 steps of each, interleaved
MESH_RANKS = 2
MESH_STEPS = 3
MESH_EVAL_BATCHES = 4
MESH_SERVE_FRAMES = 35
MESH_TIMED_STEPS = 20
TOL_MESH_LATER_LOSS = 1e-3
# the parameters after the steps: tests/test_engine.py's band for the JAX
# mesh step against the one-device step (the sharded BN reductions
# reassociate, and train-mode BN amplifies that through ~70 layers)
TOL_MESH_PARAMS = 5e-2
MESH_DIR = os.path.join(REPO, "build", "chip_smoke_mesh")


def require(cond, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, reps=20, warmup=3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events after warm-up."""
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


@contextmanager
def recording_convs(s2d_conv, fwd, gx):
    """Inside the block every same_conv and same_conv_grad_input call adds
    its (x or ct shape, w shape[, has bias]) to the Counters ``fwd`` and
    ``gx``."""
    orig = (s2d_conv.same_conv, s2d_conv.same_conv_grad_input)

    def conv(x, w, bias=None):
        fwd[(tuple(x.shape), tuple(w.shape), bias is not None)] += 1
        return orig[0](x, w, bias)

    def grad_input(ct, w):
        gx[(tuple(ct.shape), tuple(w.shape))] += 1
        return orig[1](ct, w)

    s2d_conv.same_conv, s2d_conv.same_conv_grad_input = conv, grad_input
    try:
        yield
    finally:
        s2d_conv.same_conv, s2d_conv.same_conv_grad_input = orig


@contextmanager
def plain_convs(s2d_conv):
    """Inside the block the routed convs take their plain versions
    (``same_conv_reference`` and its grad-input) in place of the
    kernels."""
    orig = (s2d_conv.same_conv, s2d_conv.same_conv_grad_input)
    s2d_conv.same_conv = s2d_conv.same_conv_reference
    s2d_conv.same_conv_grad_input = s2d_conv.same_conv_grad_input_reference
    try:
        yield
    finally:
        s2d_conv.same_conv, s2d_conv.same_conv_grad_input = orig


def record_conv_classes(torch, s2d_conv, model, batch=BATCH, size=SIZE):
    """The (x shape, w shape, has bias) of every same_conv call of one
    forward of ``batch`` frames at ``size`` (batch 8 at 224x384 by
    default), with its count."""
    seen = Counter()
    with recording_convs(s2d_conv, seen, Counter()), torch.inference_mode():
        model.apply(torch.rand((batch, 1, *size, 3), device=model.device))
    return seen


def conv_bound(direction, N, H, W, k, Ci, Co, elem_bytes, route):
    """GFLOP of one conv call, 2 N H W k^2 Ci Co, and the least time the
    card could take for it on ``route``: the larger of the operations
    (ROUTE_PEAK) over the route's peak and the bytes (each input read once,
    each output written once) over the memory rate. Returns (gflop,
    bound_ms, bound_by)."""
    flop = 2 * N * H * W * k * k * Ci * Co
    # forward: x, w, bias in, out; grad-input: ct, w in, dx out
    elems = N * H * W * (Ci + Co) + k * k * Ci * Co + (
        Co if direction == "forward" else 0)
    peak, per_flop = ROUTE_PEAK[route]
    t_ops = per_flop * flop / (PEAK_TFLOPS[peak] * 1e12)
    t_bytes = elems * elem_bytes / HBM_BYTES_PER_S
    return (flop / 1e9, 1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


@contextmanager
def fma_route(s2d_conv):
    """The conv wrappers take the FMA template (csrc/same_conv.cu) for
    every shape inside the block: the design the tensor-core kernels
    replaced, timed beside them on the same inputs."""
    orig = s2d_conv._plan
    s2d_conv._plan = lambda *args, **kwargs: ("fma", 0, 1)
    try:
        yield
    finally:
        s2d_conv._plan = orig


def check_conv(torch, s2d_conv, direction, ashape, wshape, has_bias, seed,
               timed=True):
    """One conv class in both directions' sense: ``direction`` "forward"
    checks same_conv on x = ``ashape`` (N, H, W, Ci), "grad_input" checks
    same_conv_grad_input on the cotangent ``ashape`` (N, H, W, Co); w is
    ``wshape`` (k, k, Ci, Co). In f32 (TF32 off) and bf16: the route the
    plan gives, the error against the plain version on the same rounded
    inputs, the bound of the route (f32: both the 3xTF32 and the FMA
    bound), and when ``timed`` the times of the kernel, the plain version,
    (grad-input) cuDNN's dgrad and (f32) the FMA template from CUDA
    events."""
    N, H, W, C = ashape
    k, _, Ci, Co = wshape
    g = torch.Generator(device="cuda").manual_seed(seed)
    # the strides of the main path: activations and cotangents NHWC views
    # of channels_last tensors, w an HWIO view of an OIHW channels_last
    # weight
    a = torch.randn((N, C, H, W), generator=g, device="cuda").to(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)
    w = (torch.randn((Co, Ci, k, k), generator=g, device="cuda")
         / math.sqrt(k * k * Ci)).to(
             memory_format=torch.channels_last).permute(2, 3, 1, 0)
    b = (0.1 * torch.randn((Co,), generator=g, device="cuda")
         if has_bias else None)
    grad = direction == "grad_input"
    row = {"direction": direction, "ct" if grad else "x": list(ashape),
           "w": list(wshape)}
    ok = True
    for name, dt, tol in (("f32", torch.float32, TOL_F32),
                          ("bf16", torch.bfloat16, TOL_BF16)):
        ad, wd = a.to(dt), w.to(dt)
        bd = b.to(dt) if b is not None else None
        if grad:
            def kernel():
                return s2d_conv.same_conv_grad_input(ad, wd)

            def plain():
                return s2d_conv.same_conv_grad_input_reference(ad, wd)

            def library():
                return torch.nn.grad.conv2d_input(
                    (N, Ci, H, W), wd.permute(3, 2, 0, 1),
                    ad.permute(0, 3, 1, 2), padding=(k - 1) // 2)

            ref = s2d_conv.same_conv_grad_input_reference(ad.float(),
                                                          wd.float())
        else:
            def kernel():
                return s2d_conv.same_conv(ad, wd, bd)

            def plain():
                return s2d_conv.same_conv_reference(ad, wd, bd)

            library = plain    # the plain version is one cuDNN call
            ref = s2d_conv.same_conv_reference(
                ad.float(), wd.float(), bd.float() if bd is not None else None)
        got = kernel().float()
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        rel = err / max(ref.abs().max().item(), 1e-30)
        route, tile_h, split = s2d_conv._plan(dt, N, H, W, Ci, Co, k,
                                              grad_input=grad)
        gflop, bound_ms, bound_by = conv_bound(
            direction, N, H, W, k, Ci, Co, ad.element_size(), route)
        r = {"route": route, "tile_h": tile_h, "split": split,
             "max_abs_err": err, "max_rel_err": rel, "tol_rel": tol,
             "bound_ms": bound_ms, "bound_by": bound_by}
        if name == "f32":
            for key, rt in (("bound_ms_3xtf32", "tf32"),
                            ("bound_ms_fma", "fma")):
                r[key] = conv_bound(direction, N, H, W, k, Ci, Co, 4, rt)[1]
        if timed:
            t = [cuda_ms(torch, plain), cuda_ms(torch, kernel),
                 cuda_ms(torch, kernel), cuda_ms(torch, plain)]
            r["ms"] = (t[1] + t[2]) / 2
            r["plain_ms"] = (t[0] + t[3]) / 2
            if name == "f32":
                with fma_route(s2d_conv):
                    r["fma_ms"] = (cuda_ms(torch, kernel)
                                   + cuda_ms(torch, kernel)) / 2
            r["library_ms"] = (r["plain_ms"] if library is plain else
                               (cuda_ms(torch, library)
                                + cuda_ms(torch, library)) / 2)
            r["tflops"] = gflop / r["ms"]
            r["bound_share"] = bound_ms / r["ms"]
        row[name] = r
        ok = ok and math.isfinite(rel) and rel <= tol
    row["gflop"] = gflop
    row["pass"] = ok
    return row


# the timed numbers of a class that add up over classes; f32 rows carry
# the FMA template's time and both bounds as well
SUMMED = ("ms", "plain_ms", "library_ms", "bound_ms", "fma_ms",
          "bound_ms_3xtf32", "bound_ms_fma")


def conv_totals(rows, count_key):
    """Per-dtype sums over classes times their counts: ms, plain, library
    and bound ms (f32: the FMA template's ms and both bounds too), GFLOP,
    the achieved TFLOP/s and the share of the bound."""
    totals = {}
    for dt in ("f32", "bf16"):
        t = {key: sum(r[dt][key] * r[count_key] for r in rows)
             for key in SUMMED if key in rows[0][dt]}
        t["gflop"] = sum(r["gflop"] * r[count_key] for r in rows)
        t["tflops"] = t["gflop"] / t["ms"]
        t["bound_share"] = t["bound_ms"] / t["ms"]
        totals[dt] = t
    return totals


def conv_entry(name, replaces, launches, rows, count_key, dt, route):
    """One entry of the ``kernels`` line, or None where the plan gives
    ``route`` no class of ``rows`` in ``dt``: those classes' times and
    bounds summed with their counts (ms, the plain version's, the library
    call's: cuDNN's fprop for the forward, whose plain version it is, and
    its dgrad for the grad-input; f32: the FMA template's ms and both
    bounds), the largest error against plain."""
    mine = [r for r in rows if r[dt]["route"] == route]
    if not mine:
        return None
    by = Counter()
    for r in mine:
        by[r[dt]["bound_by"]] += r[dt]["bound_ms"] * r[count_key]
    entry = {"name": name, "route": "cuda", "source": CONV_SOURCES[route],
             "replaces": replaces, "launches": launches,
             "max_abs_err": max(r[dt]["max_abs_err"] for r in mine)}
    for key in SUMMED:
        if key in mine[0][dt]:
            entry[key] = sum(r[dt][key] * r[count_key] for r in mine)
    entry["bound_by"] = by.most_common(1)[0][0]
    return entry


def expected_routes(s2d_conv, classes, dtype, grad_input):
    """{route: launches} that ``classes`` ({(x or ct shape, w shape, ...):
    count}) should make in ``dtype`` by the plan."""
    routes = Counter()
    for key, count in classes.items():
        (N, H, W, _), (k, _, Ci, Co) = key[0], key[1]
        routes[s2d_conv._plan(dtype, N, H, W, Ci, Co, k,
                              grad_input=grad_input)[0]] += count
    return routes


def check_added_cases(torch, s2d_conv, create_depth_model):
    """The ragged cases, the stem's class (whose grad-input, into 3
    channels, takes the FMA template in both dtypes), and every forward and
    grad-input class of the train phase's card-against-CPU check (4 frames
    at 64x96), in f32 and bf16 against plain with the bands of phases 3
    and 7 (untimed)."""
    model = create_depth_model("mc", checkpoint="", device="cuda")
    classes = record_conv_classes(torch, s2d_conv, model, 4,
                                  TRAIN_SMALL_SIZE)
    del model
    cases = [(("ragged_1x7x13", (1, 7, 13, 64), (11, 11, 64, 16), True))]
    cases += [(f"ragged_2x14x24_k{k}", (2, 14, 24, 32), (k, k, 32, 64), True)
              for k in (3, 7)]
    cases += [("stem_2x64x96", (2, 64, 96, 3), (7, 7, 3, 128), True)]
    cases += [(f"train_64x96_{i}", xs, ws, hb)
              for i, (xs, ws, hb) in enumerate(sorted(classes))]
    rows, seed = [], 1000
    for name, xs, ws, hb in cases:
        k, _, Ci, Co = ws
        for direction in ("forward", "grad_input"):
            ashape = xs if direction == "forward" else (*xs[:3], Co)
            row = check_conv(torch, s2d_conv, direction, ashape, ws, hb,
                             seed, timed=False)
            seed += 1
            row["case"] = name
            rows.append(row)
    return rows


def queued_ms(torch, fn, reps=20, warmup=3):
    """Mean device time of ``fn`` in ms, from CUDA events around ``reps``
    calls queued behind a sleep kernel (QUEUE_SLEEP_CYCLES): the host has
    enqueued every call before the first one starts, so its launch rate,
    which events around back-to-back calls of a kernel this short also
    measure, stays out. ``fn`` must launch nothing but the kernel. A try in
    which the host took longer than the sleep (a pause of its own) is
    repeated behind a sleep twice as long, up to QUEUE_TRIES tries.
    Returns (ms, hidden): ``hidden`` is False when no try hid the host,
    and the ms is then the last try's, the host's time in it."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for i in range(QUEUE_TRIES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES << i)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        hidden = time.perf_counter() - t0 < QUEUE_MAX_HOST_S * 2 ** i
        end.synchronize()
        if hidden:
            break
    return start.elapsed_time(end) / reps, hidden


def correlation_bound(B, H, W, C, r, stride):
    """GFLOP of one cost volume and the least time the card could take for
    it. Only an output whose f2 pixel lies in the image needs its 2 C FLOPs
    (the rest are zero by padding): for each of H and W, the (position,
    displacement) pairs whose partner is inside, multiplied. The operations
    over the f32 FMA peak, or f1 and f2 read once and the volume written
    once over the memory rate, whichever is larger. Returns (gflop,
    bound_ms, bound_by)."""
    def inside(n):
        return sum(max(0, n - stride * abs(d)) for d in range(-r, r + 1))

    flop = 2 * B * C * inside(H) * inside(W)
    t_ops = flop / (PEAK_TFLOPS["f32"] * 1e12)
    t_bytes = B * H * W * (2 * C + (2 * r + 1) ** 2) * 4 / HBM_BYTES_PER_S
    return (flop / 1e9, 1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def check_correlation(torch, corr, name, shape, max_disp, stride, seed,
                      group=None, route=None):
    """One correlation case: error against the plain version, its route and
    the times (plain and kernel by CUDA events around back-to-back calls,
    the kernel's device time by :func:`queued_ms`), from inputs with the strides the flow path gives them (NHWC
    views of channels_last NCHW activations). By default the call goes
    through ``corr.correlation`` as the flow path's does; ``group`` names
    the banded kernel's G and ``route="generic"`` launches the generic
    kernel on arguments the banded one takes."""
    B, H, W, C = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    f1, f2 = (torch.randn((B, C, H, W), generator=g, device="cuda").to(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)
        for _ in range(2))
    r = max_disp // stride
    plan = (corr.Plan("generic") if route == "generic" else corr._plan(
        f1.shape, r, stride, f1.stride(), f2.stride(),
        (f1.data_ptr(), f2.data_ptr()), group=group))
    if group is None and route is None:
        def run():
            return corr.correlation(f1, f2, max_disp, stride)
    else:
        def run():
            return corr._launch(f1, f2, r, stride, plan)
    ref = corr.correlation_reference(f1, f2, max_disp, stride)
    before = dict(corr.route_counts)
    got = run()
    torch.cuda.synchronize()
    took = [k for k, v in corr.route_counts.items() if v != before[k]]
    err = (got - ref).abs().max().item()
    rel = err / max(ref.abs().max().item(), 1e-30)
    t = [cuda_ms(torch, lambda: corr.correlation_reference(
            f1, f2, max_disp, stride)),
         cuda_ms(torch, run), cuda_ms(torch, run),
         cuda_ms(torch, lambda: corr.correlation_reference(
             f1, f2, max_disp, stride))]
    kernel_ms, hidden = queued_ms(torch, run)
    gflop, bound_ms, bound_by = correlation_bound(B, H, W, C, r, stride)
    return {"case": name, "shape": list(shape), "max_displacement": max_disp,
            "stride": stride, "route": plan.route, "group": plan.group,
            "took": took, "out": list(got.shape), "max_abs_err": err,
            "max_rel_err": rel, "tol_rel": TOL_CORR,
            "ms": kernel_ms, "queue_hid_host": hidden,
            "event_ms": [t[1], t[2]],
            "plain_ms": (t[0] + t[3]) / 2, "gflop": gflop,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / kernel_ms,
            "pass": (math.isfinite(rel) and rel <= TOL_CORR
                     and took == [plan.route])}


def record_correlation_shapes(torch, corr, backend, frames):
    """The (f1 shape, max_displacement, stride) of every correlation call
    of one FlowNet2 forward on ``frames``."""
    seen = []
    orig = corr.correlation

    def recording(f1, f2, max_displacement=20, stride=2):
        seen.append((tuple(f1.shape), max_displacement, stride))
        return orig(f1, f2, max_displacement, stride)

    corr.correlation = recording
    try:
        backend.compute_pair(*frames)
    finally:
        corr.correlation = orig
    return seen


def rel_err(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def drive_flow_stage(image_io, Flow, flows, frames, work_dir):
    """The flow stage's mask and visualisation passes on the card, over
    flow/ and color_down/ files holding ``flows`` and ``frames``. Returns
    the masks it wrote, by pair, and the panel and warped-frame files."""
    import cv2

    shutil.rmtree(work_dir, ignore_errors=True)
    for sub in ("flow", "color_down"):
        os.makedirs(os.path.join(work_dir, sub))
    for i, frame in enumerate(frames):
        image_io.save_raw_float32_image(
            os.path.join(work_dir, "color_down", f"frame_{i:06d}.raw"), frame)
    for (i, j), flow in zip(FLOW_PAIRS, flows):
        image_io.save_raw_float32_image(
            os.path.join(work_dir, "flow", f"flow_{i:06d}_{j:06d}.raw"), flow)
    stage = Flow(work_dir, work_dir, device="cuda")
    stage.mask_valid_correspondences(batch_pairs=1)
    stage.visualize_flow(warp=True, batch_pairs=1)
    masks = {p: cv2.imread(os.path.join(
        work_dir, "mask", "mask_{:06d}_{:06d}.png".format(*p)), 0)
        for p in FLOW_PAIRS}
    panels = sorted(os.listdir(os.path.join(work_dir, "vis_flow")))
    warped = sorted(os.listdir(os.path.join(work_dir, "vis_flow_warped")))
    shutil.rmtree(work_dir)
    return masks, panels, warped


def make_train_workload(training, size, n_frames=TRAIN_FRAMES):
    """bench.py::make_workload's data, from the same seeded recipe: frames
    U[0, 1), the hierarchical2 pair set, flows N(0, 2^2), masks U > 0.2,
    intrinsics (1.2 W, 1.2 W, W / 2, H / 2), identity extrinsics."""
    fr, fs = training.frame_range, training.frame_sampling
    rng_frames = fr.FrameRange(fr.OptionalSet(), num_frames=n_frames)
    opts = [fs.SamplePairsOptions(fs.SamplePairsMode.HIERARCHICAL2)]
    pairs = sorted(fs.SamplePairs.to_one_way(
        fs.SamplePairs.sample(opts, rng_frames, two_way=True)))
    H, W = size
    rng = np.random.default_rng(0)
    P = len(pairs)
    pair_arr = np.array(pairs, np.int32)
    return {
        "frames": rng.random((n_frames, H, W, 3), np.float32),
        "pair_slots": pair_arr,
        "pair_ids": pair_arr,
        "flows": (rng.standard_normal((P, 2, H, W, 2)) * 2).astype(
            np.float32),
        "masks": (rng.random((P, 2, H, W)) > 0.2).astype(np.float32),
        "intrinsics": np.tile(
            np.array([W * 1.2, W * 1.2, W / 2, H / 2], np.float32), (P, 2, 1)),
        "extrinsics": np.tile(
            np.concatenate([np.eye(3, dtype=np.float32),
                            np.zeros((3, 1), np.float32)], 1), (P, 2, 1, 1)),
    }


def rel_l2(a, b) -> float:
    """Relative L2 distance of two {name: tensor} maps over all names."""
    num = sum(float((a[k] - b[k]).double().square().sum()) for k in b)
    den = sum(float(b[k].double().square().sum()) for k in b)
    return math.sqrt(num / max(den, 1e-300))


def grads_of(engine):
    """The parameters' gradients in f64 on the host; a parameter outside the
    loss has none after a bare ``backward`` and counts as zero, as the
    engine's step makes it."""
    return {k: (p.grad if p.grad is not None
                else p.new_zeros(p.shape)).detach().double().cpu()
            for k, p in engine.params.items()}


def trace_summary(prof, window: str, ranges):
    """From a ``torch.profiler`` trace: the device idle share over the
    profiled range ``window`` (one minus the union of the kernels'
    intervals inside it over its length; None when the trace holds no
    kernels), the device time by kernel name, and for each named range in
    ``ranges`` the device time of the kernels that ran inside the
    device-side spans the profiler draws for it. Those spans place the
    kernels of a range whatever launched them: the conv kernels go out
    through ctypes, not through a torch op."""
    from bisect import bisect_left

    from torch.autograd import DeviceType

    events = prof.events()
    win = [e for e in events
           if e.name == window and e.device_type == DeviceType.CPU]
    # device activity only: kernels, copies and sets, not the device-side
    # spans the profiler draws for the named ranges
    labels = {e.name for e in events if e.device_type == DeviceType.CPU
              and getattr(e, "is_user_annotation", False)}
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    device = [e for e in on_device
              if not getattr(e, "is_user_annotation", False)
              and e.name not in labels and e.name != window
              and not e.name.startswith("Optimizer.")]
    kernels = sorted((e.time_range.start, e.time_range.end) for e in device)
    if not win or not kernels:
        return None, {}, {}
    lo, hi = win[0].time_range.start, win[0].time_range.end
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in kernels:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name = Counter()
    for e in device:
        by_name[e.name] += e.time_range.end - e.time_range.start
    starts = [s for s, _ in kernels]
    in_ranges = dict.fromkeys(ranges, 0.0)
    for e in on_device:
        if e.name not in in_ranges:
            continue
        lo_r, hi_r = e.time_range.start, e.time_range.end
        i = max(bisect_left(starts, lo_r) - 1, 0)
        while i < len(kernels) and kernels[i][0] < hi_r:
            in_ranges[e.name] += max(
                0.0, min(kernels[i][1], hi_r) - max(kernels[i][0], lo_r))
            i += 1
    return 1.0 - busy / (hi - lo), by_name, in_ranges


def drive_train(torch, engine, data, batches, s2d_conv):
    """The train path's timed run: warm-up steps, then the timed steps
    with the launch counts zeroed just before and read just after."""
    for idx, valid in batches[:WARMUP_STEPS]:
        engine.train_step(data, idx, valid)
    timed = batches[WARMUP_STEPS:WARMUP_STEPS + TIMED_STEPS]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    skipped = []
    s2d_conv.reset_counts()
    t0 = time.perf_counter()
    start.record()
    for idx, valid in timed:
        skipped.append(engine.train_step(data, idx, valid)["skipped_nan"])
    issued = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = (s2d_conv.launches, s2d_conv.grad_input_launches)
    return {
        "steps": len(timed),
        "ms_per_step": start.elapsed_time(end) / len(timed),
        "host_ms_per_step": 1e3 * host_s / len(timed),
        # the host's time to queue the steps (no step reads the device;
        # the host waits only where the launch queue is full)
        "host_issue_ms_per_step": 1e3 * issued / len(timed),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "skipped": int(sum(bool(s) for s in skipped)),
        "same_conv_launches": launches[0],
        "grad_input_launches": launches[1],
        "route_counts": dict(s2d_conv.route_counts),
    }


def profile_train(torch, engine, data, batches, s2d_conv):
    """``torch.profiler`` over PROFILED_STEPS steps: the device idle share,
    the device time of the forward + loss, the backward, the optimizer,
    the conv kernel's two directions, and the top kernels by name. The
    conv wrappers are wrapped in named ranges for the window only (the
    forward and the grad-input run the same kernel template)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def named(label, fn):
        def wrapper(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return wrapper

    orig = (s2d_conv._forward, s2d_conv.same_conv_grad_input, engine._loss)
    s2d_conv._forward = named("same_conv_forward", orig[0])
    s2d_conv.same_conv_grad_input = named("same_conv_grad_input", orig[1])
    engine._loss = named("forward_and_loss", orig[2])
    steps = batches[-PROFILED_STEPS:]
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("train_window"):
                for idx, valid in steps:
                    engine.train_step(data, idx, valid)
                torch.cuda.synchronize()
    finally:
        s2d_conv._forward, s2d_conv.same_conv_grad_input = orig[:2]
        del engine._loss
    opt_label = f"Optimizer.step#{type(engine.optimizer).__name__}.step"
    idle, by_name, in_ranges = trace_summary(
        prof, "train_window", ("forward_and_loss", "same_conv_forward",
                               "same_conv_grad_input", opt_label))
    ranges = {k: v / 1e3 / len(steps) for k, v in in_ranges.items()}
    total = sum(by_name.values()) / 1e3 / len(steps)
    # the backward (and the NaN check after it) is what the forward, the
    # loss and the optimizer leave: autograd runs it in its own thread
    ranges["backward_and_nan_check"] = (
        total - ranges["forward_and_loss"] - ranges[opt_label])
    top = [[name[:120], t / 1e3 / len(steps)]
           for name, t in by_name.most_common(25)]
    return {"steps": len(steps), "device_idle_share": idle,
            "device_ms_per_step": total, "ranges_ms_per_step": ranges,
            "top_kernels_ms_per_step": top}


def train_path(torch, smi, classes, training, s2d_conv,
               create_depth_model, LossWeights):
    """Phases 7 and 8 on the reference demo workload; ``classes`` are the
    forward's conv classes of phase 3. Returns the grad-input rows and what
    phases 9 and 10 reuse: the engines, the resident data, the routes per
    step, the pair count and the tamed initial weights."""
    per_forward = sum(classes.values())
    # -- 7. grad-input kernel against plain, per backward conv class ------
    t_data = time.perf_counter()
    workload = make_train_workload(training, SIZE)
    n_pairs = len(workload["pair_ids"])
    require(n_pairs == TRAIN_PAIRS,
            f"hierarchical2 over {TRAIN_FRAMES} frames gave {n_pairs} pairs")
    init = create_depth_model("mc", checkpoint="", seed=0, device="cuda")
    with torch.no_grad():
        init.net.pred_layer.weight.mul_(TAME_HEAD)
        init.net.pred_layer.bias.mul_(TAME_HEAD)
    init_sd = {k: v.clone() for k, v in init.net.state_dict().items()}
    del init

    def make_engine(precision, device="cuda"):
        model = create_depth_model("mc", checkpoint="", device=device)
        model.net.load_state_dict(init_sd)
        return training.TrainingEngine(
            model, training.create_optimizer("Adam", TRAIN_LR),
            LossWeights(lambda_view_baseline=0.1, lambda_reprojection=1.0),
            precision=precision)

    eng16 = make_engine("bf16")
    data = eng16.put_data(workload)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t_data
    batches = list(islice(training.PairBatchIterator(
        n_pairs, TRAIN_BATCH, seed=0).epoch(0),
        1 + WARMUP_STEPS + TIMED_STEPS + PROFILED_STEPS))
    idx0, valid0 = batches[0]

    # one bf16 step: the grad-input classes, the launches, the health
    gx_classes = Counter()
    orig_gx = s2d_conv.same_conv_grad_input

    def recording_gx(ct, w):
        gx_classes[(tuple(ct.shape), tuple(w.shape))] += 1
        return orig_gx(ct, w)

    s2d_conv.same_conv_grad_input = recording_gx
    s2d_conv.reset_counts()
    try:
        first16 = eng16.train_step(data, idx0, valid0)
        torch.cuda.synchronize()
    finally:
        s2d_conv.same_conv_grad_input = orig_gx
    first_launches = (s2d_conv.launches, s2d_conv.grad_input_launches)
    first_routes = dict(s2d_conv.route_counts)
    first_grads = grads_of(eng16)
    loss16 = float(first16["loss"])

    gx_rows = []
    for i, ((cts, ws), count) in enumerate(sorted(gx_classes.items())):
        row = check_conv(torch, s2d_conv, "grad_input", cts, ws, False,
                         seed=100 + i)
        row["per_step"] = count
        gx_rows.append(row)
        emit({"phase": "grad_input", **row, "nvidia_smi": smi})
    gx_totals = conv_totals(gx_rows, "per_step")
    emit({"phase": "grad_inputs", "classes": len(gx_rows),
          "launches_per_step": sum(gx_classes.values()),
          "expected_per_step": per_forward - 1,
          "per_step_ms": gx_totals, "nvidia_smi": smi,
          "pass": all(r["pass"] for r in gx_rows)})
    require(all(r["pass"] for r in gx_rows),
            "grad-input kernel disagrees with plain")
    # the routes each precision's step must take, by the plan
    routes = {}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        fwd = expected_routes(s2d_conv, classes, dt, False)
        bwd = expected_routes(s2d_conv, gx_classes, dt, True)
        routes[name] = {f"forward_{r}": fwd[r] for r in s2d_conv.ROUTES}
        routes[name].update(
            {f"grad_input_{r}": bwd[r] for r in s2d_conv.ROUTES})

    # -- 8. the train path ------------------------------------------------
    nonzero_ok = all(bool(g.abs().max() > 0) for k, g in first_grads.items()
                     if not k.startswith(NO_GRAD_PARAMS))
    finite_ok = all(bool(torch.isfinite(g).all())
                    for g in first_grads.values())
    no_grad_zero = all(bool(g.abs().max() == 0)
                       for k, g in first_grads.items()
                       if k.startswith(NO_GRAD_PARAMS))

    # the f32 step with the kernels against the same step with their plain
    # versions: same weights, same batch
    eng32 = make_engine("f32")
    first32 = eng32.train_step(data, idx0, valid0)
    grads32 = grads_of(eng32)
    loss32 = float(first32["loss"])
    plain = make_engine("f32")
    with plain_convs(s2d_conv):
        plain_out = plain.train_step(data, idx0, valid0)
        plain_loss = float(plain_out["loss"])
    plain_loss_err = abs(loss32 - plain_loss) / abs(plain_loss)
    plain_grad_err = rel_l2(grads32, grads_of(plain))
    del plain

    # the card against the CPU, f32, two pairs at 64x96
    small = {k: v[:2] if k != "frames" else v for k, v in
             make_train_workload(training, TRAIN_SMALL_SIZE).items()}
    sides = {}
    for device in ("cuda", "cpu"):
        eng = make_engine("f32", device)
        d = eng.put_data(small)
        idx, valid = eng._indices([0, 1], [1.0, 1.0])
        loss, _, _ = eng._loss(training.gather_batch(d, idx), valid,
                               train=False)
        loss.backward()
        eval_grads, eval_loss = grads_of(eng), loss.item()
        out = eng.train_step(d, [0, 1], [1.0, 1.0])
        stats = {k: v.double().cpu()
                 for k, v in eng.model.net.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        sides[device] = (float(out["loss"]), stats, eval_grads, eval_loss)
    cpu_loss_err = abs(sides["cuda"][0] - sides["cpu"][0]) / abs(
        sides["cpu"][0])
    cpu_stats_err = max(
        float((sides["cuda"][1][k] - v).abs().max() / v.abs().max())
        for k, v in sides["cpu"][1].items())
    cpu_eval_loss_err = abs(sides["cuda"][3] - sides["cpu"][3]) / abs(
        sides["cpu"][3])
    cpu_grad_err = rel_l2(sides["cuda"][2], sides["cpu"][2])
    bf16_loss_err = abs(loss16 - loss32) / abs(loss32)

    # NaN-skip on the card: params and Adam's state stay bitwise
    bad = {k: data[k][:TRAIN_BATCH] for k in data if k != "frames"}
    bad["frames"] = data["frames"]
    bad["flows"] = bad["flows"].clone()
    bad["flows"][0] = float("nan")
    params_before = {k: p.detach().clone() for k, p in eng16.params.items()}
    opt_before = {k: {n: v.clone() if torch.is_tensor(v) else v
                      for n, v in st.items()}
                  for k, st in eng16.optimizer.state_dict()["state"].items()}
    bn_before = eng16.model.net.seq[1].running_mean.clone()
    step_before = eng16.step
    nan_out = eng16.train_step(bad, np.arange(TRAIN_BATCH), np.ones(
        TRAIN_BATCH, np.float32))
    opt_after = eng16.optimizer.state_dict()["state"]
    nan_skip = {
        "skipped": bool(nan_out["skipped_nan"]),
        "params_unchanged": all(torch.equal(p.detach(), params_before[k])
                                for k, p in eng16.params.items()),
        "optimizer_unchanged": opt_after.keys() == opt_before.keys() and all(
            all(torch.equal(v, opt_before[k][n]) if torch.is_tensor(v)
                else v == opt_before[k][n] for n, v in st.items())
            for k, st in opt_after.items()),
        "bn_stats_moved": not torch.equal(
            eng16.model.net.seq[1].running_mean, bn_before),
        "step_advanced": eng16.step == step_before + 1,
    }
    emit({
        "phase": "train_checks", "frames": TRAIN_FRAMES, "pairs": n_pairs,
        "size": list(SIZE), "batch_pairs": TRAIN_BATCH,
        "resident_gib": sum(v.numel() * v.element_size()
                            for v in data.values()) / 2 ** 30,
        "workload_seconds": data_s,
        "first_step_launches": list(first_launches),
        "expected_launches": [per_forward, per_forward - 1],
        "first_step_routes": first_routes,
        "expected_routes": routes["bf16"],
        "loss_bf16": loss16, "loss_f32": loss32,
        "skipped_first": [bool(first16["skipped_nan"]),
                          bool(first32["skipped_nan"])],
        "grads_finite": finite_ok, "grads_nonzero": nonzero_ok,
        "confidence_head_grad_zero": no_grad_zero,
        "kernel_vs_plain_loss_rel": plain_loss_err,
        "tol_loss": TOL_STEP_LOSS,
        "kernel_vs_plain_grads_rel_l2": plain_grad_err,
        "tol_grads": TOL_STEP_GRADS,
        "card_vs_cpu_loss_rel": cpu_loss_err, "tol_cpu_loss": TOL_CPU_LOSS,
        "card_vs_cpu_bn_stats_rel": cpu_stats_err,
        "tol_cpu_stats": TOL_CPU_STATS,
        "card_vs_cpu_eval_loss_rel": cpu_eval_loss_err,
        "card_vs_cpu_eval_grads_rel_l2": cpu_grad_err,
        "tol_cpu_grads": TOL_CPU_GRADS,
        "bf16_vs_f32_loss_rel": bf16_loss_err, "tol_bf16": TOL_TRAIN_BF16,
        "nan_skip": nan_skip, "nvidia_smi": smi,
    })
    require(first_launches == (per_forward, per_forward - 1),
            f"one train step made {first_launches} same_conv / grad-input "
            f"launches, expected {(per_forward, per_forward - 1)}")
    require(all(first_routes[k] == v for k, v in routes["bf16"].items()),
            f"one bf16 train step took routes {first_routes}, expected "
            f"{routes['bf16']}")
    require(math.isfinite(loss16) and math.isfinite(loss32),
            "non-finite train loss")
    require(not bool(first16["skipped_nan"])
            and not bool(first32["skipped_nan"]), "first train step skipped")
    require(finite_ok and nonzero_ok, "a parameter got a non-finite or zero "
            "gradient")
    require(plain_loss_err <= TOL_STEP_LOSS,
            f"f32 step loss, kernels vs plain {plain_loss_err}")
    require(plain_grad_err <= TOL_STEP_GRADS,
            f"f32 step gradients, kernels vs plain {plain_grad_err}")
    require(cpu_loss_err <= TOL_CPU_LOSS, f"train loss card vs CPU "
            f"{cpu_loss_err}")
    require(cpu_stats_err <= TOL_CPU_STATS, f"BN stats card vs CPU "
            f"{cpu_stats_err}")
    require(cpu_eval_loss_err <= TOL_CPU_LOSS and cpu_grad_err
            <= TOL_CPU_GRADS, f"eval-mode loss/gradients card vs CPU "
            f"{cpu_eval_loss_err} / {cpu_grad_err}")
    require(bf16_loss_err <= TOL_TRAIN_BF16,
            f"bf16 step loss vs f32 {bf16_loss_err}")
    require(all(nan_skip.values()), f"NaN-skip on the card {nan_skip}")

    # the main path: timed train steps in bf16 and in f32, the fine-tune's
    # default precision
    for name, eng in (("bf16", eng16), ("f32", eng32)):
        run = drive_train(torch, eng, data, batches[1:], s2d_conv)
        run["profile"] = profile_train(torch, eng, data, batches[1:],
                                       s2d_conv)
        # the profiler slows the host, so its idle share is an upper bound;
        # the profiled device time over the unprofiled step is the estimate
        run["device_idle_share_unprofiled"] = (
            1.0 - run["profile"]["device_ms_per_step"] / run["ms_per_step"])
        emit({"phase": "train", "precision": name, **run,
              "workload": f"{TRAIN_FRAMES} frames {SIZE[0]}x{SIZE[1]}, "
                          f"{n_pairs} pairs, batch {TRAIN_BATCH}",
              "nvidia_smi": smi})
        require(run["skipped"] == 0, f"{name}: {run['skipped']} timed steps "
                "skipped")
        require(run["same_conv_launches"] == per_forward * run["steps"]
                and run["grad_input_launches"]
                == (per_forward - 1) * run["steps"],
                f"{name}: {run['same_conv_launches']} / "
                f"{run['grad_input_launches']} launches in "
                f"{run['steps']} steps")
        require(all(run["route_counts"][k] == v * run["steps"]
                    for k, v in routes[name].items()),
                f"{name}: routes {run['route_counts']} in {run['steps']} "
                f"steps, expected {routes[name]} per step")
    context = {"engines": {"bf16": eng16, "f32": eng32}, "data": data,
               "routes": routes, "n_pairs": n_pairs, "init_sd": init_sd}
    return gx_rows, context


@contextmanager
def sync_errors(torch):
    """Any operation inside the block that synchronises the host with the
    card raises (``torch.cuda.set_sync_debug_mode("error")``): ``.item()``,
    ``bool()`` of a device tensor, a boolean-mask index, ``nonzero``, a
    blocking copy between host and card."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def timed_pass(torch, s2d_conv, steps, fn, checked=True):
    """Run ``fn`` (an epoch or an eval pass) once, under :func:`sync_errors`
    when ``checked``, with the conv launch counts zeroed just before and
    read just after. Returns its result and the CUDA-event, host and
    host-issue times (ms per step over ``steps``), the launches and the
    routes."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    s2d_conv.reset_counts()
    t0 = time.perf_counter()
    with sync_errors(torch) if checked else nullcontext():
        start.record()
        out = fn()
        issued = time.perf_counter() - t0
        end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    return out, {
        "steps": steps, "ms": start.elapsed_time(end),
        "ms_per_step": start.elapsed_time(end) / steps,
        "host_ms_per_step": 1e3 * host_s / steps,
        "host_issue_ms_per_step": 1e3 * issued / steps,
        "same_conv_launches": s2d_conv.launches,
        "grad_input_launches": s2d_conv.grad_input_launches,
        "route_counts": dict(s2d_conv.route_counts)}


def profile_epoch(torch, engine, data, idx, valid):
    """``torch.profiler`` over one ``train_epoch`` of ``len(idx)`` steps:
    the device idle share over the window and the device ms per step."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("epoch_window"):
            engine.train_epoch(data, idx, valid)
            torch.cuda.synchronize()
    idle, by_name, _ = trace_summary(prof, "epoch_window", ())
    return {"steps": len(idx), "device_idle_share": idle,
            "device_ms_per_step": sum(by_name.values()) / 1e3 / len(idx)}


def eval_kernel_vs_plain(torch, s2d_conv, engine, data, idx, valid):
    """The first EVAL_CHECK_BATCHES batches of a paired f32 eval with the
    kernels, then from the same state with ``same_conv_reference``: the
    largest relative difference of the per-pair losses, and of the depth
    buffer over max |plain|. The engine's state is put back after."""
    state = {k: v.clone() for k, v in engine.model.net.state_dict().items()}
    n = EVAL_CHECK_BATCHES
    out = {}
    for name in ("kernel", "plain"):
        engine.model.net.load_state_dict(state)
        with plain_convs(s2d_conv) if name == "plain" else nullcontext():
            m = engine.eval_epoch(data, idx[:n], valid[:n])
            out[name] = {k: v.double().cpu() for k, v in m.items()}
    engine.model.net.load_state_dict(state)
    k, p = out["kernel"], out["plain"]
    # padding pairs have zero losses on both sides
    loss_rel = max(float(((k[x] - p[x]).abs()
                          / p[x].abs().clamp_min(1e-30)).max())
                   for x in ("reprojection", "disparity"))
    depth_rel = float((k["depth_frames"] - p["depth_frames"]).abs().max()
                      / p["depth_frames"].abs().max())
    return {"batches": n, "pair_loss_rel": loss_rel,
            "depth_rel_of_max": depth_rel,
            "frames_seen": int(p["frames_seen"].sum()),
            "seen_equal": bool(torch.equal(k["frames_seen"],
                                           p["frames_seen"]))}


def epoch_path(torch, smi, training, s2d_conv, per_forward, context):
    """Phase 9: ``train_epoch`` and ``eval_epoch`` on phase 8's resident
    data and engines, one full epoch and one eval pass per precision, each
    under :func:`sync_errors`. Returns the runs by precision."""
    data, routes = context["data"], context["routes"]
    n_pairs = context["n_pairs"]
    frames = data["frames"].shape[0]
    steps = list(training.PairBatchIterator(
        n_pairs, TRAIN_BATCH, seed=0).epoch(0))
    idx = np.stack([s[0] for s in steps])
    valid = np.stack([s[1] for s in steps])
    n_steps = len(steps)
    capture = training.capture_slots(
        valid, 0, DISPLAY_FREQ, training.TrainingEngine.CAPTURE_SLOTS)
    n_captured = int((capture >= 0).sum())
    eidx, evalid = training.eval_batches(n_pairs, TRAIN_BATCH)
    dedup_forwards = -(-frames // (2 * TRAIN_BATCH))

    check = eval_kernel_vs_plain(torch, s2d_conv, context["engines"]["f32"],
                                 data, eidx, evalid)
    emit({"phase": "eval_kernel_vs_plain", "precision": "f32", **check,
          "tol_rel": TOL_EVAL_PLAIN, "nvidia_smi": smi})
    require(check["pair_loss_rel"] <= TOL_EVAL_PLAIN
            and check["depth_rel_of_max"] <= TOL_EVAL_PLAIN
            and check["seen_equal"],
            f"paired eval, kernels vs plain: {check}")

    runs = {}
    for name in ("f32", "bf16"):
        eng = context["engines"][name]
        # warm-up outside the timed window: two steps and two eval batches
        eng.train_epoch(data, idx[:2], valid[:2])
        eng.eval_epoch(data, eidx[:2], evalid[:2])
        m, train = timed_pass(
            torch, s2d_conv, n_steps,
            lambda: eng.train_epoch(data, idx, valid, capture))
        cap = m["captured_depth"].float()
        filled = [bool(torch.isfinite(cap[j]).all() and (cap[j] > 0).all())
                  for j in range(n_captured)]
        train.update({
            "skipped": int(m["skipped_nan"].sum()),
            "loss_first_last": [float(m["loss"][0]), float(m["loss"][-1])],
            "loss_finite": bool(torch.isfinite(m["loss"]).all()),
            "captured_slots": n_captured,
            "captured_steps": np.nonzero(capture >= 0)[0].tolist(),
            "captured_filled": all(filled),
            "captured_rest_empty": not bool(cap[n_captured:].any()),
            "captured_dtype": str(m["captured_depth"].dtype)})
        # what the sync check itself costs the host: a short epoch without
        # it and one with it
        short = [timed_pass(torch, s2d_conv, DEBUG_COST_STEPS,
                            lambda: eng.train_epoch(
                                data, idx[:DEBUG_COST_STEPS],
                                valid[:DEBUG_COST_STEPS]),
                            checked=checked)[1]["ms_per_step"]
                 for checked in (False, True)]
        train["ms_per_step_unchecked_vs_checked"] = short
        train["profile"] = profile_epoch(torch, eng, data,
                                         idx[:PROFILED_EPOCH_STEPS],
                                         valid[:PROFILED_EPOCH_STEPS])
        train["device_idle_share_unprofiled"] = (
            1.0 - train["profile"]["device_ms_per_step"]
            / train["ms_per_step"])
        em, ev = timed_pass(torch, s2d_conv, len(eidx),
                            lambda: eng.eval_epoch(data, eidx, evalid))
        forwards = dedup_forwards if eng.eval_dedup else len(eidx)
        ev.update({
            "kind": "dedup" if eng.eval_dedup else "paired",
            "forwards": forwards,
            "frames_seen_all": bool(em["frames_seen"].all()),
            "losses_finite": bool(torch.isfinite(em["loss"]).all()),
            "depth_positive": bool((em["depth_frames"] > 0).all()),
            "depth_dtype": str(em["depth_frames"].dtype)})
        runs[name] = {"train_epoch": train, "eval_epoch": ev}
        emit({"phase": "epoch", "precision": name, **runs[name],
              "workload": f"{frames} frames {SIZE[0]}x{SIZE[1]}, {n_pairs} "
                          f"pairs, batch {TRAIN_BATCH}, {n_steps} steps",
              "nvidia_smi": smi})
        want_fwd = {f"forward_{r}": routes[name][f"forward_{r}"]
                    for r in s2d_conv.ROUTES}
        require(train["same_conv_launches"] == per_forward * n_steps
                and train["grad_input_launches"]
                == (per_forward - 1) * n_steps,
                f"{name} epoch: {train['same_conv_launches']} / "
                f"{train['grad_input_launches']} launches in {n_steps} steps")
        require(all(train["route_counts"][k] == v * n_steps
                    for k, v in routes[name].items()),
                f"{name} epoch: routes {train['route_counts']}, expected "
                f"{routes[name]} per step")
        require(train["skipped"] == 0 and train["loss_finite"],
                f"{name} epoch: {train['skipped']} skipped steps or a "
                "non-finite loss")
        require(n_captured == EXPECTED_CAPTURES and train["captured_filled"]
                and train["captured_rest_empty"],
                f"{name} epoch: capture slots {train['captured_steps']}")
        require(ev["same_conv_launches"] == per_forward * forwards
                and ev["grad_input_launches"] == 0,
                f"{name} eval ({ev['kind']}): {ev['same_conv_launches']} "
                f"launches, expected {per_forward * forwards}")
        require(all(ev["route_counts"][k] == v * forwards
                    for k, v in want_fwd.items()),
                f"{name} eval: routes {ev['route_counts']}")
        require(ev["frames_seen_all"] and ev["losses_finite"]
                and ev["depth_positive"], f"{name} eval: {ev}")
        require(ev["kind"] == ("dedup" if name == "bf16" else "paired"),
                f"{name} eval took the {ev['kind']} pass")
    return runs, check


def write_ft_dataset(training, image_io, work_dir, init_sd, torch_import):
    """A reference-layout dataset directory of FT_FRAMES frames at SIZE from
    the train phase's recipe (``make_train_workload``): color_down/*.raw,
    flow/*.raw and mask/*.png for both directions of each hierarchical2
    pair, flow_list.json, R_hierarchical2_mc/metadata_scaled.npz, and the
    tamed seeded weights as init.pth. Returns the range directory, the
    checkpoint path and the number of one-way pairs."""
    import cv2

    w = make_train_workload(training, SIZE, n_frames=FT_FRAMES)
    for sub in ("color_down", "flow", "mask"):
        os.makedirs(os.path.join(work_dir, sub))
    for i, frame in enumerate(w["frames"]):
        # .raw colour is stored RGB; the loader swizzles it to BGR
        image_io.save_raw_float32_image(
            os.path.join(work_dir, "color_down", f"frame_{i:06d}.raw"),
            frame[..., ::-1])
    two_way = []
    for p, (i, j) in enumerate(w["pair_ids"].tolist()):
        for side, (a, b) in enumerate(((i, j), (j, i))):
            image_io.save_raw_float32_image(
                os.path.join(work_dir, "flow", f"flow_{a:06d}_{b:06d}.raw"),
                w["flows"][p, side])
            cv2.imwrite(os.path.join(work_dir, "mask",
                                     f"mask_{a:06d}_{b:06d}.png"),
                        (w["masks"][p, side] * 255).astype(np.uint8))
            two_way.append([a, b])
    with open(os.path.join(work_dir, "flow_list.json"), "w") as f:
        json.dump(two_way, f)
    range_dir = os.path.join(work_dir, "R_hierarchical2_mc")
    os.makedirs(range_dir)
    np.savez(os.path.join(range_dir, "metadata_scaled.npz"),
             intrinsics=w["intrinsics"][0, :1].repeat(FT_FRAMES, 0),
             extrinsics=w["extrinsics"][0, :1].repeat(FT_FRAMES, 0))
    checkpoint = os.path.join(work_dir, "init.pth")
    torch_import.save_checkpoint(checkpoint, init_sd)
    return range_dir, checkpoint, len(w["pair_ids"])


def run_driver(training, range_dir, checkpoint, epochs, log,
               save_depth=False):
    """One ``DepthFineTuner`` run in f32 on the card with the demo's
    settings and ``--resume``, then ``save_depth`` if asked; its console
    output goes to ``log``. Returns the driver, its wall seconds, its
    console text and the seconds of save_depth (or None)."""
    import argparse

    parser = training.DepthFineTuningParams.add_arguments(
        argparse.ArgumentParser())
    params = parser.parse_args([
        "--lambda_view_baseline", "0.1", "--learning_rate", str(TRAIN_LR),
        "--batch_size", str(TRAIN_BATCH), "--num_epochs", str(epochs),
        "--val_epoch_freq", "1", "--save_epoch_freq", "1",
        "--display_freq", str(FT_DISPLAY_FREQ), "--resume"])
    params.path = os.path.dirname(range_dir)
    params.model_type = "mc"
    params.model_checkpoint = checkpoint
    out = io.StringIO()
    save_s = None
    t0 = time.perf_counter()
    with redirect_stdout(out):
        ft = training.DepthFineTuner(range_dir, list(range(FT_FRAMES)),
                                     params)
        ft.fine_tune()
        if save_depth:
            t1 = time.perf_counter()
            ft.save_depth()
            save_s = time.perf_counter() - t1
    wall = time.perf_counter() - t0
    log.write(out.getvalue())
    return ft, wall, out.getvalue(), save_s


def driver_path(torch, smi, training, s2d_conv, image_io, torch_import,
                create_depth_model, per_forward, context):
    """Phase 10: the fine-tune driver on a scratch dataset directory: two
    epochs with eval passes, checkpoints and save_depth, then a resumed run
    to a third epoch; the artifacts checked, the directory deleted."""
    work_dir = os.path.join(REPO, "build", "chip_smoke_ft")
    shutil.rmtree(work_dir, ignore_errors=True)
    os.makedirs(work_dir)
    try:
        return _driver_checks(torch, smi, training, s2d_conv, image_io,
                              torch_import, create_depth_model, per_forward,
                              context, work_dir)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)


def _driver_checks(torch, smi, training, s2d_conv, image_io, torch_import,
                   create_depth_model, per_forward, context, work_dir):
    t0 = time.perf_counter()
    range_dir, checkpoint, n_pairs = write_ft_dataset(
        training, image_io, work_dir, context["init_sd"], torch_import)
    write_s = time.perf_counter() - t0
    steps = -(-n_pairs // TRAIN_BATCH)
    log_path = os.path.join(REPO, "build", "chip_smoke_driver.log")
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    with open(log_path, "w") as log:
        s2d_conv.reset_counts()
        ft, wall, _, save_s = run_driver(training, range_dir, checkpoint,
                                         FT_EPOCHS, log, save_depth=True)
        launches = (s2d_conv.launches, s2d_conv.grad_input_launches)
        routes = dict(s2d_conv.route_counts)
        out_dir = ft.out_dir
        ck = ft.checkpoints_dir
        evals = sorted(f for f in os.listdir(os.path.join(out_dir, "eval"))
                       if f.startswith("loss_e"))
        losses_ok = True
        for name in evals:
            with open(os.path.join(out_dir, "eval", name)) as f:
                d = json.load(f)
            losses_ok &= set(d) == {"reprojection", "disparity", "mean"}
            losses_ok &= all(math.isfinite(v) for sub in d.values()
                             for v in sub.values())
        eval_files = os.listdir(os.path.join(out_dir, "eval"))
        depth_files = os.listdir(os.path.join(out_dir, "depth"))
        final = {k: v.cpu() for k, v in ft.model.net.state_dict().items()}
        loaded = {}
        for e in (1, 2):
            m = create_depth_model(
                "mc", checkpoint=os.path.join(ck, f"{e:04d}.pth"),
                device="cpu")
            loaded[e] = m.net.state_dict()
        pth_equal = all(torch.equal(loaded[2][k], v)
                        for k, v in final.items())
        events = os.listdir(os.path.join(out_dir, "tensorboard"))
        full = sorted(f for f in os.listdir(ck) if f.startswith("full_"))
        first = {"wall_s": wall, "epoch_s": ft.epoch_seconds,
                 "eval_s": ft.eval_seconds,
                 "save_depth_s": save_s,
                 "launches": list(launches), "route_counts": routes,
                 "step": ft.engine.step}

        s2d_conv.reset_counts()
        ft2, wall2, text2, _ = run_driver(training, range_dir, checkpoint,
                                          FT_EPOCHS + 1, log)
        launches2 = (s2d_conv.launches, s2d_conv.grad_input_launches)
        full2 = sorted(f for f in os.listdir(ck) if f.startswith("full_"))
        evals2 = sorted(f for f in os.listdir(os.path.join(out_dir, "eval"))
                        if f.startswith("loss_e"))
    resumed = {"wall_s": wall2, "epoch_s": ft2.epoch_seconds,
               "eval_s": ft2.eval_seconds, "launches": list(launches2),
               "step": ft2.engine.step,
               "resumed_at_epoch_2": "(epoch 2)" in text2
               and "Resumed from" in text2,
               "full_checkpoints": full2, "eval_jsons": len(evals2)}
    n_eval = FT_EPOCHS + 1
    want_first = (per_forward * (FT_EPOCHS * steps + n_eval * steps
                                 + -(-FT_FRAMES // TRAIN_BATCH)),
                  (per_forward - 1) * FT_EPOCHS * steps)
    want_resumed = (per_forward * 2 * steps, (per_forward - 1) * steps)
    result = {
        "phase": "driver", "frames": FT_FRAMES, "pairs": n_pairs,
        "size": list(SIZE), "batch_pairs": TRAIN_BATCH, "precision": "f32",
        "dataset_write_s": write_s, "tag": os.path.basename(out_dir),
        "eval_jsons": evals, "eval_losses_finite": losses_ok,
        "eval_depth_raw": sum(f.endswith(".raw") for f in eval_files),
        "eval_depth_png": sum(f.endswith(".png") for f in eval_files),
        "depth_raw": sum(f.endswith(".raw") for f in depth_files),
        "depth_png": sum(f.endswith(".png") for f in depth_files),
        "pth_0002_equals_final": pth_equal, "event_files": len(events),
        "full_checkpoints": full, "first": first,
        "expected_launches": list(want_first), "resumed": resumed,
        "expected_resumed_launches": list(want_resumed),
        "log": os.path.relpath(log_path, REPO), "nvidia_smi": smi}
    emit(result)
    require(result["tag"] == FT_TAG, f"driver tag {result['tag']}")
    require(len(evals) == n_eval and losses_ok,
            f"driver eval JSONs {evals}, finite {losses_ok}")
    require(result["eval_depth_raw"] == result["eval_depth_png"]
            == n_eval * FT_FRAMES, "driver eval depth files")
    require(result["depth_raw"] == result["depth_png"] == FT_FRAMES,
            "driver final depth files")
    require(pth_equal, "0002.pth differs from the final parameters")
    require(len(events) >= 1, "no TensorBoard event file")
    require(full == ["full_0001", "full_0002"], f"full states {full}")
    require(tuple(launches) == want_first,
            f"driver launches {launches}, expected {want_first}")
    require(routes["forward_fma"] == 0 and routes["grad_input_fma"] == 0,
            f"driver routes {routes}")
    require(resumed["resumed_at_epoch_2"] and len(ft2.epoch_seconds) == 1
            and full2 == ["full_0001", "full_0002", "full_0003"]
            and len(evals2) == n_eval + 1
            and ft2.engine.step == (FT_EPOCHS + 1) * steps,
            f"resumed run {resumed}")
    require(tuple(launches2) == want_resumed,
            f"resumed launches {launches2}, expected {want_resumed}")
    return result


def make_plane_scene(torch, geometry, n, size, seed=0):
    """``tests/synthetic.py::make_scene`` rebuilt on the port's geometry: a
    textured plane at world z = -2 seen by a camera that translates along x
    and turns about y. Frames (n, H, W, 3) RGB in [0, 1], depths (n, H, W),
    intrinsics (n, 4), extrinsics (n, 3, 4). The texture and the poses do
    not depend on the size, so one seed gives the same scene at any
    size."""
    H, W = size
    rng = np.random.default_rng(seed)
    intrinsics = np.tile(np.array([W * 1.2, W * 1.2, (W - 1) / 2,
                                   (H - 1) / 2], np.float32), (n, 1))
    n1 = max(n - 1, 1)
    rot_step, tx_step, ty_step = (min(0.02, 0.4 / n1), min(0.08, 1.2 / n1),
                                  min(0.01, 0.15 / n1))
    extrinsics = []
    for i in range(n):
        a = rot_step * i
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        t = np.array([tx_step * i, ty_step * i, 0.0])
        extrinsics.append(np.concatenate([R, t[:, None]], 1))
    extrinsics = np.stack(extrinsics).astype(np.float32)
    coefs = rng.standard_normal((3, 6))
    freqs = rng.uniform(0.5, 3.0, (2, 6))
    phases = rng.uniform(0, 2 * np.pi, 6)
    pixels = geometry.pixel_grid((H, W))
    frames, depths = [], []
    for i in range(n):
        rays = geometry.pixels_to_rays(
            pixels, torch.from_numpy(intrinsics[i])).numpy()
        R, t = extrinsics[i][:, :3], extrinsics[i][:, 3]
        dirs = rays @ R.T
        lam = (-2.0 - t[2]) / dirs[..., 2]
        pts = t + lam[..., None] * dirs
        arg = (pts[..., :1] * freqs[0] + pts[..., 1:2] * freqs[1] + phases)
        tex = 0.5 + 0.25 * np.einsum("...k,ck->...c", np.sin(arg), coefs)
        frames.append(np.clip(tex, 0, 1).astype(np.float32))
        depths.append(lam.astype(np.float32))
    return {"frames": np.stack(frames), "depths": np.stack(depths),
            "intrinsics": intrinsics, "extrinsics": extrinsics}


def write_cli_dataset(torch, mods, work_dir, init_sd):
    """A reference-layout dataset for the CLI, as ``tests/synthetic.py::
    build_e2e_dataset`` writes one, at CLI_SIZE with colour frames at
    CLI_FULL_SIZE: frames.txt, color_full/*.png, COLMAP's poses and inverse
    depth, and exact flows for every two-way hierarchical2 pair except those
    within CLI_FLOWNET_FRAMES, which FlowNet2 computes. The tamed seeded
    ``mc`` weights and the seeded FlowNet2 go into a checkpoint directory.
    Returns the exact pairs, the FlowNet2 pairs and the checkpoint
    directory."""
    import cv2

    geometry, image_io, fs, fr = (mods["geometry"], mods["image_io"],
                                  mods["frame_sampling"], mods["frame_range"])
    n = CLI_FRAMES
    full = make_plane_scene(torch, geometry, n, CLI_FULL_SIZE)["frames"]
    scene = make_plane_scene(torch, geometry, n, CLI_SIZE)
    H, W = CLI_FULL_SIZE
    with open(os.path.join(work_dir, "frames.txt"), "w") as f:
        f.write(f"{n}\n{W}\n{H}\n" + "".join(f"{i / 30:.6f}\n"
                                             for i in range(n)))
    for sub in ("color_full", "colmap_dense", "flow",
                os.path.join("depth_colmap_dense", "depth")):
        os.makedirs(os.path.join(work_dir, sub))
    for i in range(n):
        cv2.imwrite(os.path.join(work_dir, "color_full", f"frame_{i:06d}.png"),
                    (full[i][..., ::-1] * 255).astype(np.uint8))
        image_io.save_raw_float32_image(
            os.path.join(work_dir, "depth_colmap_dense", "depth",
                         f"frame_{i:06d}.raw"), 1.0 / scene["depths"][i])
    np.savez(os.path.join(work_dir, "colmap_dense", "metadata.npz"),
             intrinsics=scene["intrinsics"], extrinsics=scene["extrinsics"])
    pairs = fs.SamplePairs.sample(
        [fs.SamplePairsOptions(fs.SamplePairsMode.HIERARCHICAL2)],
        fr.FrameRange(fr.OptionalSet(), num_frames=n), two_way=True)
    exact = sorted(p for p in map(tuple, pairs)
                   if not set(p) <= set(CLI_FLOWNET_FRAMES))
    flownet = sorted(set(map(tuple, pairs)) - set(exact))
    pixels = geometry.pixel_grid(CLI_SIZE).numpy()
    for i, j in exact:
        idx = [i, j]
        uv = geometry.warping_field(
            *(torch.from_numpy(scene[k][idx])
              for k in ("extrinsics", "intrinsics", "depths")), [1, 0])
        image_io.save_raw_float32_image(
            os.path.join(work_dir, "flow", f"flow_{i:06d}_{j:06d}.raw"),
            uv[0].numpy() - pixels)
    ckpt_dir = os.path.join(work_dir, "checkpoints")
    os.makedirs(ckpt_dir)
    mods["torch_import"].save_checkpoint(os.path.join(ckpt_dir, "mc.pth"),
                                         init_sd)
    flownet2 = mods["TorchFlowBackend"](checkpoint=None, full=True,
                                        homography=False, seed=0,
                                        device="cpu")
    mods["torch_import"].save_checkpoint(
        os.path.join(ckpt_dir, "flownet2.pth"), flownet2.net.state_dict())
    return exact, flownet, ckpt_dir


def tree_mtimes(root, skip=None):
    """Every file under ``root`` (outside ``skip``) with its mtime in ns."""
    out = {}
    for dirpath, _, files in os.walk(root):
        if skip is not None and (dirpath + os.sep).startswith(skip + os.sep):
            continue
        for f in files:
            p = os.path.join(dirpath, f)
            out[p] = os.stat(p).st_mtime_ns
    return out


def run_cli_module(work_dir, ckpt_dir, env_extra):
    """``python -m consistent_depth_tpu_torch`` on ``work_dir`` in a process
    of its own, from the checkout's root; returns it after it ends."""
    env = dict(os.environ, CDTPU_CHECKPOINT_DIR=ckpt_dir, **env_extra)
    return subprocess.run(
        [sys.executable, "-m", "consistent_depth_tpu_torch", "--path",
         work_dir, *CLI_ARGS], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=600)


def cli_modules(training):
    """The port's modules that phase 11 drives and reads, by name."""
    from consistent_depth_tpu_torch.cli import main as cli_main
    from consistent_depth_tpu_torch.data.video_dataset import (
        VideoFrameDataset)
    from consistent_depth_tpu_torch.flow.runner import TorchFlowBackend
    from consistent_depth_tpu_torch.io import image_io, metadata_io
    from consistent_depth_tpu_torch.models import torch_import
    from consistent_depth_tpu_torch.models.registry import (
        create_depth_model, get_depth_model)
    from consistent_depth_tpu_torch.ops import geometry
    from consistent_depth_tpu_torch.pipeline import process

    return {"cli_main": cli_main, "process": process, "geometry": geometry,
            "image_io": image_io, "metadata_io": metadata_io,
            "torch_import": torch_import,
            "frame_range": training.frame_range,
            "frame_sampling": training.frame_sampling,
            "TorchFlowBackend": TorchFlowBackend,
            "VideoFrameDataset": VideoFrameDataset,
            "create_depth_model": create_depth_model,
            "get_depth_model": get_depth_model}


CLI_DIR = os.path.join(REPO, "build", "chip_smoke_cli")


def cli_path(torch, smi, mods, s2d_conv, corr, per_forward, init_sd,
             device="cuda", keep=False):
    """Phase 11: the whole pipeline through the port's CLI on a scratch
    dataset directory (CLI_DIR), run in-process and then again as ``python
    -m``; the artifacts, the scales and the launches checked, the CLI's
    console kept in ``build/chip_smoke_cli.log``. The directory is deleted
    unless ``keep`` (the backbone phases run their CLI on it; the caller
    deletes it then)."""
    work_dir = CLI_DIR
    shutil.rmtree(work_dir, ignore_errors=True)
    os.makedirs(work_dir)
    try:
        return _cli_checks(torch, smi, mods, s2d_conv, corr, per_forward,
                           init_sd, device, work_dir)
    finally:
        if not keep:
            shutil.rmtree(work_dir, ignore_errors=True)


def _cli_checks(torch, smi, mods, s2d_conv, corr, per_forward, init_sd,
                device, work_dir):
    import cv2

    image_io, metadata_io, process = (mods["image_io"], mods["metadata_io"],
                                      mods["process"])
    t0 = time.perf_counter()
    exact, flownet, ckpt_dir = write_cli_dataset(torch, mods, work_dir,
                                                 init_sd)
    write_s = time.perf_counter() - t0
    log_path = os.path.join(REPO, "build", "chip_smoke_cli.log")

    stage_s = {}
    orig_execute = process.Stage.execute

    def timed_execute(stage, state):
        t = time.perf_counter()
        orig_execute(stage, state)
        stage_s[stage.name] = time.perf_counter() - t

    corr_calls = []
    orig_corr = corr.correlation

    def recording(f1, f2, max_displacement=20, stride=2):
        corr_calls.append((tuple(f1.shape), max_displacement, stride))
        return orig_corr(f1, f2, max_displacement, stride)

    process.Stage.execute = timed_execute
    corr.correlation = recording
    s2d_conv.reset_counts()
    corr.launches = 0
    corr.route_counts.update(dict.fromkeys(corr.route_counts, 0))
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with env_var("CDTPU_CHECKPOINT_DIR", ckpt_dir), redirect_stdout(out):
            initial_dir, tag_dir, frames = mods["cli_main"].main(
                ["--path", work_dir, *CLI_ARGS], device=device)
    finally:
        process.Stage.execute = orig_execute
        corr.correlation = orig_corr
        with open(log_path, "w") as log:
            log.write(out.getvalue())
    wall = time.perf_counter() - t0
    launches = (s2d_conv.launches, s2d_conv.grad_input_launches)
    conv_routes = dict(s2d_conv.route_counts)
    corr_launches, corr_routes = corr.launches, dict(corr.route_counts)

    # the artifact tree of tests/test_pipeline_e2e.py::test_full_pipeline
    range_dir = os.path.dirname(tag_dir)
    n = CLI_FRAMES
    missing = [p for i in range(n) for p in (
        os.path.join(initial_dir, "depth", f"frame_{i:06d}.raw"),
        os.path.join(tag_dir, "depth", f"frame_{i:06d}.raw"))
        if not os.path.isfile(p)]
    scales = metadata_io.read_scales_csv(os.path.join(range_dir,
                                                      "scales.csv"))
    meta = metadata_io.read_metadata(os.path.join(range_dir,
                                                  "metadata_scaled.npz"))
    flow_list = set(map(tuple, metadata_io.read_flow_list(
        os.path.join(work_dir, "flow_list.json"))))
    evals = sorted(f for f in os.listdir(os.path.join(tag_dir, "eval"))
                   if f.startswith("loss_e") and f.endswith(".json"))
    losses_ok = True
    for name in evals:
        with open(os.path.join(tag_dir, "eval", name)) as f:
            d = json.load(f)
        losses_ok &= set(d) == {"reprojection", "disparity", "mean"}
        losses_ok &= all(math.isfinite(v) for sub in d.values()
                         for v in sub.values())
    vis = {sub: len(os.listdir(os.path.join(base, sub)))
           for base, sub in ((work_dir, "vis_flow"),
                             (work_dir, "vis_flow_warped"),
                             (range_dir, "vis_calibration_dense"))}
    pth_ok = True
    for e in (1, 2):
        # strict=True inside the model's constructor
        m = mods["create_depth_model"](
            "mc", checkpoint=os.path.join(tag_dir, "checkpoints",
                                          f"{e:04d}.pth"), device="cpu")
        pth_ok &= len(m.net.state_dict()) > 0
    final = [image_io.load_raw_float32_image(
        os.path.join(tag_dir, "depth", f"frame_{i:06d}.raw"))
        for i in range(n)]
    final_finite = all(bool(np.isfinite(d).all()) for d in final)

    # the scales against numpy's nanmedian of the same files
    src = [image_io.load_raw_float32_image(os.path.join(
        initial_dir, "depth", f"frame_{i:06d}.raw")) for i in range(n)]
    want_scales = []
    for i in range(n):
        cmp = cv2.resize(image_io.load_raw_float32_image(os.path.join(
            work_dir, "depth_colmap_dense", "depth", f"frame_{i:06d}.raw")),
            src[i].shape[::-1], interpolation=cv2.INTER_NEAREST)
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = src[i] / cmp
        want_scales.append(np.nanmedian(np.where(np.isfinite(ratio), ratio,
                                                 np.nan)))
    scale_err = float(np.max(np.abs(scales[:, 1] - want_scales)
                             / np.abs(want_scales)))

    # the first two initial depths on the card against the port on the CPU
    dataset = mods["VideoFrameDataset"](
        os.path.join(work_dir, "color_down", "frame_{:06d}.raw"), [0, 1])
    images, _ = dataset.load_batch([0, 1])
    cpu_model = mods["create_depth_model"](
        "mc", checkpoint=os.path.join(ckpt_dir, "mc.pth"), device="cpu")
    with torch.inference_mode():
        d_cpu = 1.0 / cpu_model.apply(torch.from_numpy(images[:, None]))[
            :, 0].numpy()
    cpu_err = rel_err(np.stack(src[:2]), d_cpu)
    del cpu_model

    # the FlowNet2 flows of the run: finite, at the depth size; the first
    # pair against the same pair through correlation_reference (the backend
    # the flow stage builds for "FlowNet2", the same frames and resize)
    def flow_file(d, p):
        return os.path.join(d, "flow_{:06d}_{:06d}.raw".format(*p))

    net_flows = [image_io.load_raw_float32_image(
        flow_file(os.path.join(work_dir, "flow"), p)) for p in flownet]
    net_flows_ok = all(f.shape == (*CLI_SIZE, 2) and bool(np.isfinite(f).all())
                       for f in net_flows)
    ref_dir = os.path.join(work_dir, "flow_reference")
    os.makedirs(ref_dir)
    ref_backend = mods["TorchFlowBackend"](
        checkpoint=os.path.join(ckpt_dir, "flownet2.pth"), homography=True,
        device=device)
    corr.correlation = corr.correlation_reference
    try:
        ref_backend.process_pairs(
            frame_dir=os.path.join(work_dir, "color_flow"), pairs=flownet[:1],
            out_fmt=os.path.join(ref_dir, "flow_{:06d}_{:06d}.raw"),
            out_size=CLI_SIZE[::-1])
    finally:
        corr.correlation = orig_corr
    del ref_backend
    flow_plain_err = rel_err(net_flows[0], image_io.load_raw_float32_image(
        flow_file(ref_dir, flownet[0])))
    shutil.rmtree(ref_dir)
    cli_corr_shape = next(c[1:4] for c in CORR_CASES if c[0] == CLI_CORR_CASE)

    # the launches each stage makes: save_depth's batches of 4 frames for
    # the initial and final depth, one forward per train step and per eval
    # batch (an eval before training and after each epoch), a grad-input
    # per train step but for the stem's
    n_pairs = len(flow_list) // 2
    steps = -(-n_pairs // TRAIN_BATCH)
    forwards = 2 * -(-n // TRAIN_BATCH) + (CLI_EPOCHS + CLI_EPOCHS + 1) * steps
    want = (per_forward * forwards, (per_forward - 1) * CLI_EPOCHS * steps)
    tc = "tf32"             # the CLI's default precision, f32
    want_routes = {"forward_" + tc: want[0], "grad_input_" + tc: want[1]}

    # again as a process of its own: every stage before fine-tuning finds its
    # outputs, and --resume finds the last epoch's full state
    before = tree_mtimes(work_dir, skip=tag_dir)
    t0 = time.perf_counter()
    rerun = run_cli_module(work_dir, ckpt_dir, {})
    rerun_s = time.perf_counter() - t0
    after = tree_mtimes(work_dir, skip=tag_dir)
    probed = ("Extracting PTS", "Extracting frames",
              "Downscaling frames (raw)", "Downscaling frames (png)",
              "Downscaling frames (for flow)", "Compute initial depth",
              "Filter flow pairs", "Compute final depth")
    rerun_text = rerun.stdout
    rerun_ok = {
        "exit_0": rerun.returncode == 0,
        "probed_stages_up_to_date": all(
            f"[{s}] outputs up to date, skipping." in rerun_text
            for s in probed),
        "scales_loaded": "Existing scales file loaded." in rerun_text
        and "Scaled metadata file exists." in rerun_text,
        "no_file_changed_before_fine_tuning": before == after,
        "resumed": "Resumed from" in rerun_text
        and f"(epoch {CLI_EPOCHS})" in rerun_text,
        "no_train_step": "Epoch = " not in rerun_text,
    }
    # and with no card: refused before anything is written
    before_all = tree_mtimes(work_dir)
    refused = run_cli_module(work_dir, ckpt_dir, {"CUDA_VISIBLE_DEVICES": ""})
    refused_ok = (refused.returncode != 0
                  and "no CUDA device" in refused.stderr
                  and tree_mtimes(work_dir) == before_all)
    with open(log_path, "a") as log:
        log.write(rerun.stdout + rerun.stderr + refused.stdout
                  + refused.stderr)

    result = {
        "phase": "cli", "frames": n, "size": list(CLI_SIZE),
        "full_size": list(CLI_FULL_SIZE), "args": CLI_ARGS,
        "precision": "f32", "dataset_write_s": write_s, "wall_s": wall,
        "stage_s": stage_s, "tag": os.path.basename(tag_dir),
        "frames_returned": frames == list(range(n)),
        "missing_depth_files": missing[:4],
        "scales_rows": int(scales.shape[0]),
        "scales_vs_numpy_nanmedian_rel_err": scale_err,
        "tol_scales": TOL_CLI_SCALES,
        "metadata_scaled_keys": sorted(meta),
        "exact_pairs": len(exact), "flownet2_pairs": len(flownet),
        "flow_list_pairs": len(flow_list),
        "flow_list_holds_exact_pairs": set(exact) <= flow_list,
        "eval_jsons": evals, "eval_losses_finite": losses_ok,
        "vis_files": vis, "pth_strict_loads": pth_ok,
        "final_depth_finite": final_finite,
        "initial_depth_card_vs_cpu_rel_err": cpu_err, "tol_cpu": TOL_CPU_REF,
        "launches": list(launches), "expected_launches": list(want),
        "route_counts": conv_routes, "expected_routes": want_routes,
        "correlation_launches": corr_launches,
        "correlation_routes": corr_routes,
        "correlation_calls": [list(c) for c in sorted(set(corr_calls))],
        "correlation_case": CLI_CORR_CASE,
        "flownet2_flows_finite": net_flows_ok,
        "flownet2_pair": list(flownet[0]),
        "flownet2_kernel_vs_plain_rel_err": flow_plain_err,
        "tol_flow": TOL_FLOW,
        "rerun": {**rerun_ok, "wall_s": rerun_s},
        "refused_without_card": refused_ok,
        "refused_stderr_tail": refused.stderr[-300:],
        "log": os.path.relpath(log_path, REPO), "nvidia_smi": smi}
    emit(result)
    require(result["tag"] == CLI_TAG, f"CLI tag {result['tag']}")
    require(result["frames_returned"] and not missing,
            f"CLI depth files missing: {missing[:4]}")
    require(scales.shape == (n, 2)
            and set(meta) == {"intrinsics", "extrinsics", "scales"},
            f"CLI calibration: scales {scales.shape}, metadata {sorted(meta)}")
    require(scale_err < TOL_CLI_SCALES, f"CLI scales vs numpy {scale_err}")
    require(set(exact) <= flow_list, "flow_list.json lost an exact pair")
    require(len(evals) == CLI_EPOCHS + 1 and losses_ok,
            f"CLI eval JSONs {evals}, finite {losses_ok}")
    require(all(vis.values()), f"CLI visualisations {vis}")
    require(pth_ok and final_finite, "CLI checkpoints or final depth")
    require(cpu_err < TOL_CPU_REF, f"CLI initial depth card vs CPU {cpu_err}")
    require(corr_launches == len(flownet)
            and corr_routes == {"banded": len(flownet), "generic": 0},
            f"CLI correlation launches {corr_routes}, expected "
            f"{len(flownet)} banded")
    require(corr_calls == [cli_corr_shape] * len(flownet),
            f"CLI correlation calls {sorted(set(corr_calls))}, expected "
            f"{len(flownet)} at {CLI_CORR_CASE} {cli_corr_shape}")
    require(net_flows_ok, "CLI FlowNet2 flows not finite or of another size")
    require(flow_plain_err < TOL_FLOW,
            f"CLI FlowNet2 pair with kernel vs plain {flow_plain_err}")
    require(tuple(launches) == want,
            f"CLI conv launches {launches}, expected {want}")
    require(all(conv_routes[k] == v for k, v in want_routes.items()),
            f"CLI conv routes {conv_routes}, expected {want_routes}")
    require(all(rerun_ok.values()), f"CLI re-run {rerun_ok}")
    require(refused_ok, "the CLI without a card did not refuse cleanly")
    return result


def seed_backbone(torch, name, create_depth_model, torch_import, ckpt_dir):
    """The backbone's seed-0 weights (midas2's output conv tamed: its weight
    scaled by TAME_HEAD and its bias raised by MIDAS_TAME), written under
    ``ckpt_dir`` where the adapter looks for its default checkpoint:
    ``midas2.pth``, or monodepth2's released layout, a directory of
    ``encoder.pth`` (with the feed size) and ``depth.pth``. Returns the
    untamed output conv's weight and bias (midas2) or None."""
    model = create_depth_model(name, checkpoint="", seed=0, device="cpu")
    if name == "midas2":
        head = model.net.scratch.output_conv[4]
        untamed = (head.weight.detach().clone(), head.bias.detach().clone())
        with torch.no_grad():
            head.weight.mul_(TAME_HEAD)
            head.bias.add_(MIDAS_TAME)
        torch_import.save_checkpoint(os.path.join(ckpt_dir, "midas2.pth"),
                                     model.net.state_dict())
        return untamed
    sd = dict(model.net.state_dict())
    d = os.path.join(ckpt_dir, MONODEPTH2_DIR)
    os.makedirs(d, exist_ok=True)
    height, width = MONODEPTH2_FEED
    torch.save({**{k: v for k, v in sd.items() if k.startswith("encoder.")},
                "height": height, "width": width, "use_stereo": False},
               os.path.join(d, "encoder.pth"))
    torch.save({k: v for k, v in sd.items() if k.startswith("decoder.")},
               os.path.join(d, "depth.pth"))
    return None


def network_part(name, bias, depth):
    """What the network itself computes of a depth map (numpy): for midas2
    the disparity 1/depth less ``bias``, its output conv's bias, which
    MIDAS_TAME makes most of a seeded MiDaS's disparity, so that a check
    sees the network and not the constant; for monodepth2 the depth."""
    if name == "midas2":
        return 1.0 / depth.astype(np.float64) - bias
    return depth


def output_bias(name, model):
    """midas2's output conv bias (a float), else None."""
    if name == "midas2":
        return float(model.net.scratch.output_conv[4].bias.detach().float())
    return None


@contextmanager
def env_var(key, value):
    saved = os.environ.get(key)
    os.environ[key] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(key)
        else:
            os.environ[key] = saved


def route_counts_of(s2d_conv, classes, dtype, grad_input, per=1):
    """{forward_<route> or grad_input_<route>: launches} for ``classes``
    run ``per`` times, by the plan."""
    prefix = "grad_input_" if grad_input else "forward_"
    got = expected_routes(s2d_conv, classes, dtype, grad_input)
    return {prefix + r: got[r] * per for r in s2d_conv.ROUTES}


def backbone_path(torch, smi, name, training, s2d_conv, mods, LossWeights,
                  DepthServer, ServeConfig, data, cli_dir, device="cuda"):
    """Phases 12-13 for one backbone at full width and depth: its conv
    classes against plain, the train path (timed steps, kernels vs plain,
    card vs CPU, the NaN-skip), the engine's eval and infer passes, serving
    and the CLI, every model built by the adapter from its default
    checkpoint under phase 11's checkpoint directory. Returns the phase's
    record, the launches by route of its main-path runs (timed steps by
    precision, ``f32_cli``) and its conv classes' rows (``check_conv``
    with their ``count`` per batch-8 forward or per step)."""
    create = mods["create_depth_model"]
    ckpt_dir = os.path.join(cli_dir, "checkpoints")
    t0 = time.perf_counter()
    untamed = seed_backbone(torch, name, create, mods["torch_import"],
                            ckpt_dir)
    with env_var("CDTPU_CHECKPOINT_DIR", ckpt_dir):
        return _backbone_checks(torch, smi, name, training, s2d_conv, mods,
                                LossWeights, DepthServer, ServeConfig, data,
                                cli_dir, device, time.perf_counter() - t0,
                                untamed)


def _backbone_checks(torch, smi, name, training, s2d_conv, mods, LossWeights,
                     DepthServer, ServeConfig, data, cli_dir, device,
                     seed_s, untamed):
    create = mods["create_depth_model"]
    cls = mods["get_depth_model"](name)
    n_fwd, n_gx = BACKBONE_CONVS[name]
    record = {"phase": "backbone", "backbone": name, "weights_s": seed_s,
              "nvidia_smi": smi}

    def make_engine(precision, dev=device):
        model = create(name, device=dev)
        return training.TrainingEngine(
            model, training.create_optimizer("Adam", cls.learning_rate),
            LossWeights(lambda_view_baseline=cls.lambda_view_baseline,
                        lambda_reprojection=1.0), precision=precision)

    # -- the conv classes of a batch-8 forward and of one train step -------
    t0 = time.perf_counter()
    probe = create(name, device=device)
    record["build_s"] = time.perf_counter() - t0
    record["parameters"] = sum(p.numel() for p in probe.net.parameters())
    fwd_classes = record_conv_classes(torch, s2d_conv, probe)
    del probe
    n_pairs = len(data["pair_ids"])
    batches = list(islice(training.PairBatchIterator(
        n_pairs, TRAIN_BATCH, seed=0).epoch(0),
        1 + WARMUP_STEPS + TIMED_STEPS + PROFILED_STEPS))
    idx0, valid0 = batches[0]
    eng32 = make_engine("f32")
    bias0 = output_bias(name, eng32.model)
    step_fwd, gx_classes = Counter(), Counter()
    s2d_conv.reset_counts()
    with recording_convs(s2d_conv, step_fwd, gx_classes):
        first32, depth32 = eng32._step(data, *eng32._indices(idx0, valid0))
        torch.cuda.synchronize()
    first_launches = (s2d_conv.launches, s2d_conv.grad_input_launches)
    first_routes = dict(s2d_conv.route_counts)
    grads32 = grads_of(eng32)
    loss32 = float(first32["loss"])
    routes = {}
    for dt_name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        routes[dt_name] = {
            **route_counts_of(s2d_conv, fwd_classes, dt, False),
            **route_counts_of(s2d_conv, gx_classes, dt, True)}
    rows = []
    classes = [("forward", k[0], k[1], k[2], c)
               for k, c in sorted(fwd_classes.items())]
    classes += [("grad_input", k[0], k[1], False, c)
                for k, c in sorted(gx_classes.items())]
    for i, (direction, ashape, wshape, has_bias, count) in enumerate(classes):
        row = check_conv(torch, s2d_conv, direction, ashape, wshape, has_bias,
                         seed=2000 + i)
        row["count"] = count
        rows.append(row)
        emit({"phase": "backbone_kernel", "backbone": name, **row,
              "nvidia_smi": smi})
    record.update({
        "classes": len(rows), "forward_classes": len(fwd_classes),
        "grad_input_classes": len(gx_classes),
        "launches_per_forward": sum(fwd_classes.values()),
        "step_forward_classes_equal": step_fwd == fwd_classes,
        "first_step_launches": list(first_launches),
        "expected_launches": [n_fwd, n_gx],
        "first_step_routes": first_routes, "expected_routes": routes["f32"],
        "per_forward_ms": conv_totals(
            [r for r in rows if r["direction"] == "forward"], "count"),
        "per_step_grad_input_ms": conv_totals(
            [r for r in rows if r["direction"] == "grad_input"], "count"),
        "kernel_slower_than_cudnn": [
            {"direction": r["direction"], "shape": r.get("x", r.get("ct")),
             "w": r["w"], "dtype": dt, "ms": r[dt]["ms"],
             "library_ms": r[dt]["library_ms"]}
            for r in rows for dt in ("f32", "bf16")
            if r[dt]["ms"] > r[dt]["library_ms"]]})
    require(all(r["pass"] for r in rows),
            f"{name}: a conv class disagrees with plain")
    require(sum(fwd_classes.values()) == n_fwd and step_fwd == fwd_classes,
            f"{name}: {sum(fwd_classes.values())} routed convs per forward, "
            f"expected {n_fwd}; a step's classes {dict(step_fwd)}, a "
            f"forward's {dict(fwd_classes)}")
    require(first_launches == (n_fwd, n_gx),
            f"{name}: one step made {first_launches} launches, expected "
            f"{(n_fwd, n_gx)}")
    require(all(first_routes[k] == v for k, v in routes["f32"].items()),
            f"{name}: one f32 step took routes {first_routes}")

    # -- the f32 step with the kernels against plain -----------------------
    # (and the step's forward: midas2's disparity less its output bias)
    plain = make_engine("f32")
    with plain_convs(s2d_conv):
        plain_out, plain_depth = plain._step(
            data, *plain._indices(idx0, valid0))
    plain_loss = float(plain_out["loss"])
    plain_loss_err = abs(loss32 - plain_loss) / abs(plain_loss)
    plain_grad_err = rel_l2(grads32, grads_of(plain))
    part32, part_plain = (network_part(name, bias0,
                                       d.detach().double().cpu().numpy())
                          for d in (depth32, plain_depth))
    plain_out_err = float(np.linalg.norm(part32 - part_plain)
                          / np.linalg.norm(part_plain))
    del plain, plain_out, plain_depth, depth32

    # -- the card against the CPU, two pairs at 64x96 ----------------------
    # f64 on both sides (the convs on cuDNN and the plain version, which
    # the kernels do not take): every other op of the port, card against
    # CPU, within phase 8's bands. f32: the card with the kernels no
    # further from the CPU than the card with the plain version in their
    # place (cuDNN), plus phase 8's band; cuDNN's own f32 rounding is
    # what separates the card from the CPU here (tools/
    # torch_backbone_precision.py). The classes of the card's f32 run,
    # against plain with the bands of phases 3 and 7.
    small = {k: v[:2] if k != "frames" else v for k, v in
             make_train_workload(training, TRAIN_SMALL_SIZE).items()}
    small_fwd, small_gx = Counter(), Counter()
    sides = {}
    for side, dev, dt, convs in (
            ("card", device, torch.float32,
             recording_convs(s2d_conv, small_fwd, small_gx)),
            ("card_plain", device, torch.float32, plain_convs(s2d_conv)),
            ("card_f64", device, torch.float64, plain_convs(s2d_conv)),
            ("cpu", "cpu", torch.float32, nullcontext()),
            ("cpu_f64", "cpu", torch.float64, nullcontext())):
        eng = make_engine("f32", dev)
        d = eng.put_data(small)
        if dt == torch.float64:
            eng.model.net.double()
            eng.model.compute_dtype = dt
            d = {k: v.double() if v.is_floating_point() else v
                 for k, v in d.items()}
        idx, valid = eng._indices([0, 1], [1.0, 1.0])
        batch, valid = training.gather_batch(d, idx), valid.to(dt)
        with convs:
            loss, _, depth = eng._loss(batch, valid, train=False)
            loss.backward()
            # a train-mode forward: the step's loss and BN running stats
            with torch.no_grad():
                train_loss = eng._loss(batch, valid, train=True)[0].item()
        eval_grads, eval_loss = grads_of(eng), loss.item()
        stats = {k: v.double().cpu()
                 for k, v in eng.model.net.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        out = network_part(name, output_bias(name, eng.model),
                           depth.detach().double().cpu().numpy())
        sides[side] = (train_loss, stats, eval_grads, eval_loss, out)
        del eng

    def gaps(a, b):
        return {"loss_rel": abs(a[0] - b[0]) / abs(b[0]),
                "bn_stats_rel": max(
                    float((a[1][k] - v).abs().max() / v.abs().max())
                    for k, v in b[1].items()),
                "eval_loss_rel": abs(a[3] - b[3]) / abs(b[3]),
                "eval_grads_rel_l2": rel_l2(a[2], b[2]),
                "output_rel_l2": float(np.linalg.norm(a[4] - b[4])
                                       / np.linalg.norm(b[4]))}

    tols = {"loss_rel": TOL_CPU_LOSS, "bn_stats_rel": TOL_CPU_STATS,
            "eval_loss_rel": TOL_CPU_LOSS,
            "eval_grads_rel_l2": TOL_CPU_GRADS,
            "output_rel_l2": TOL_CPU_LOSS}
    f64_gap = gaps(sides["card_f64"], sides["cpu_f64"])
    card_gap = gaps(sides["card"], sides["cpu"])
    plain_gap = gaps(sides["card_plain"], sides["cpu"])
    f32_bands = {k: plain_gap[k] + tol for k, tol in tols.items()}
    small_classes = [("forward", *key) for key in sorted(small_fwd)]
    small_classes += [("grad_input", *key, False) for key in sorted(small_gx)]
    small_rows = [check_conv(torch, s2d_conv, *c, seed=3000 + i, timed=False)
                  for i, c in enumerate(small_classes)]
    cpu_checks = {
        "card_f64_vs_cpu_f64": f64_gap, "tol_f64": tols,
        "card_vs_cpu": card_gap, "card_plain_vs_cpu": plain_gap,
        "f32_bands": f32_bands,
        "card_vs_cpu_f64": gaps(sides["card"], sides["cpu_f64"]),
        "card_plain_vs_cpu_f64": gaps(sides["card_plain"],
                                      sides["cpu_f64"]),
        "cpu_f32_vs_f64": gaps(sides["cpu"], sides["cpu_f64"]),
        "classes": len(small_rows),
        "classes_max_rel_err": {dt: max(r[dt]["max_rel_err"]
                                        for r in small_rows)
                                for dt in ("f32", "bf16")},
        "classes_failed": [r for r in small_rows if not r["pass"]]}
    del sides

    # -- the NaN-skip: midas2 with its untamed output conv -----------------
    nan_skip = None
    if name == "midas2":
        head = eng32.model.net.scratch.output_conv[4]
        tamed = (head.weight.detach().clone(), head.bias.detach().clone())
        with torch.no_grad():
            head.weight.copy_(untamed[0])
            head.bias.copy_(untamed[1])
        params_before = {k: p.detach().clone()
                         for k, p in eng32.params.items()}
        opt_state = eng32.optimizer.state_dict()["state"]
        opt_before = {k: {n: v.clone() if torch.is_tensor(v) else v
                          for n, v in st.items()}
                      for k, st in opt_state.items()}
        nan_out = eng32.train_step(data, batches[1][0], batches[1][1])
        opt_after = eng32.optimizer.state_dict()["state"]
        nan_skip = {
            "loss_finite": bool(torch.isfinite(nan_out["loss"])),
            "skipped": bool(nan_out["skipped_nan"]),
            "params_unchanged": all(torch.equal(p.detach(), params_before[k])
                                    for k, p in eng32.params.items()),
            "optimizer_unchanged": opt_after.keys() == opt_before.keys()
            and all(all(torch.equal(v, opt_before[k][n]) if torch.is_tensor(v)
                        else v == opt_before[k][n] for n, v in st.items())
                    for k, st in opt_after.items())}
        with torch.no_grad():
            head.weight.copy_(tamed[0])
            head.bias.copy_(tamed[1])
    record.update({
        "loss_f32": loss32, "skipped_first": bool(first32["skipped_nan"]),
        "grads_finite": all(bool(torch.isfinite(g).all())
                            for g in grads32.values()),
        "kernel_vs_plain_loss_rel": plain_loss_err,
        "tol_loss": TOL_STEP_LOSS,
        "kernel_vs_plain_grads_rel_l2": plain_grad_err,
        "kernel_vs_plain_output_rel_l2": plain_out_err,
        "tol_grads": TOL_STEP_GRADS, "card_vs_cpu_64x96": cpu_checks,
        "nan_skip": nan_skip})
    require(math.isfinite(loss32) and not record["skipped_first"]
            and record["grads_finite"], f"{name}: first f32 step")
    require(plain_loss_err <= TOL_STEP_LOSS
            and plain_out_err <= TOL_STEP_LOSS
            and plain_grad_err <= TOL_STEP_GRADS,
            f"{name}: f32 step kernels vs plain {plain_loss_err} / "
            f"{plain_out_err} / {plain_grad_err}")
    require(all(f64_gap[k] <= tol for k, tol in tols.items())
            and all(card_gap[k] <= band for k, band in f32_bands.items()),
            f"{name}: card vs CPU {cpu_checks}")
    require(all(r["pass"] for r in small_rows),
            f"{name}: a 64x96 conv class disagrees with plain "
            f"{cpu_checks['classes_failed']}")
    require(nan_skip is None or (not nan_skip["loss_finite"] and all(
        v for k, v in nan_skip.items() if k != "loss_finite")),
        f"{name}: NaN-skip {nan_skip}")

    # -- the main path: timed train steps, f32 and bf16 ----------------------
    train = {}
    main_routes = {}
    for dt_name in ("f32", "bf16"):
        eng = eng32 if dt_name == "f32" else make_engine("bf16")
        run = drive_train(torch, eng, data, batches[1:], s2d_conv)
        if dt_name == "f32":
            run["profile"] = profile_train(torch, eng, data, batches[1:],
                                           s2d_conv)
            run["device_idle_share_unprofiled"] = (
                1.0 - run["profile"]["device_ms_per_step"]
                / run["ms_per_step"])
        train[dt_name] = run
        main_routes[dt_name] = run["route_counts"]
        require(run["skipped"] == 0, f"{name} {dt_name}: skipped steps")
        require(run["same_conv_launches"] == n_fwd * run["steps"]
                and run["grad_input_launches"] == n_gx * run["steps"],
                f"{name} {dt_name}: {run['same_conv_launches']} / "
                f"{run['grad_input_launches']} launches in {run['steps']} "
                "steps")
        require(all(run["route_counts"][k] == v * run["steps"]
                    for k, v in routes[dt_name].items()),
                f"{name} {dt_name}: routes {run['route_counts']}")
        if dt_name == "bf16":
            del eng
    record["train"] = train

    # -- the engine's eval pass and infer, no host read --------------------
    eidx, evalid = training.eval_batches(n_pairs, TRAIN_BATCH)
    eidx, evalid = eidx[:EVAL_CHECK_BATCHES], evalid[:EVAL_CHECK_BATCHES]
    eng32.eval_epoch(data, eidx[:1], evalid[:1])           # warm-up
    em, ev = timed_pass(torch, s2d_conv, len(eidx),
                        lambda: eng32.eval_epoch(data, eidx, evalid))
    frames8 = data["frames"][:BATCH][:, None]
    depth, inf = timed_pass(torch, s2d_conv, 1, lambda: eng32.infer(frames8))
    seen = em["frames_seen"]
    record["engine"] = {
        "eval": {**ev, "losses_finite": bool(torch.isfinite(em["loss"]).all()),
                 "depth_positive": bool((em["depth_frames"][seen] > 0).all())},
        "infer": {**inf, "shape": list(depth.shape),
                  "finite_positive": bool(torch.isfinite(depth).all()
                                          and (depth > 0).all())}}
    require(ev["same_conv_launches"] == n_fwd * len(eidx)
            and ev["grad_input_launches"] == 0
            and inf["same_conv_launches"] == n_fwd,
            f"{name}: engine passes launched {ev['same_conv_launches']} / "
            f"{inf['same_conv_launches']}")
    require(record["engine"]["eval"]["losses_finite"]
            and record["engine"]["eval"]["depth_positive"]
            and record["engine"]["infer"]["finite_positive"],
            f"{name}: engine passes {record['engine']}")
    del eng32
    torch.cuda.empty_cache()

    # -- serving: bf16 frames/s, bf16 against f32 --------------------------
    rng = np.random.default_rng(3)
    videos = {"a": rng.random((FRAMES_PER_VIDEO, *SIZE, 3), dtype=np.float32),
              "c": rng.random((ODD_FRAMES, *ODD_SIZE, 3), dtype=np.float32)}
    n_frames = FRAMES_PER_VIDEO + ODD_FRAMES
    n_batches = FRAMES_PER_VIDEO // BATCH + math.ceil(ODD_FRAMES / BATCH)
    server = DepthServer(ServeConfig(model_type=name, precision="bf16",
                                     batch_size=BATCH, device=device))
    server.infer_videos(videos)                                # warm-up
    torch.cuda.synchronize()
    s2d_conv.reset_counts()
    t0 = time.perf_counter()
    out16 = server.infer_videos(videos)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = s2d_conv.launches
    del server
    server32 = DepthServer(ServeConfig(model_type=name, precision="f32",
                                       batch_size=BATCH, device=device))
    out32 = server32.infer_videos(videos)
    bias = output_bias(name, server32.model)
    del server32
    # midas2: the disparity less the output bias, the network's own part
    part = {v: (network_part(name, bias, out16[v]),
                network_part(name, bias, out32[v])) for v in videos}
    rel = {v: float(np.linalg.norm(a - b) / np.linalg.norm(b))
           for v, (a, b) in part.items()}
    record["serve"] = {
        "frames": n_frames, "batches": n_batches, "batch_size": BATCH,
        "seconds": serve_s, "fps": n_frames / serve_s,
        "launches": serve_launches, "expected_launches": n_fwd * n_batches,
        "shapes_ok": all(out16[v].shape == videos[v].shape[:3]
                         for v in videos),
        "finite": all(bool(np.isfinite(out16[v]).all()) for v in videos),
        "bf16_vs_f32_rel_l2": rel, "compared": (
            "disparity less the output bias" if bias is not None
            else "depth"), "tol_rel_l2": TOL_SERVE_BF16}
    require(record["serve"]["shapes_ok"] and record["serve"]["finite"],
            f"{name}: served depths {record['serve']}")
    require(serve_launches == n_fwd * n_batches,
            f"{name}: serving launched {serve_launches}")
    require(max(rel.values()) < TOL_SERVE_BF16,
            f"{name}: bf16 against f32 depth {rel}")

    # -- the CLI on phase 11's directory, one epoch ---------------------------
    record["cli"], cli_routes = backbone_cli(torch, name, s2d_conv, mods,
                                             cli_dir, n_fwd, n_gx, device)
    main_routes["f32_cli"] = cli_routes
    emit(record)
    return record, main_routes, rows


def backbone_cli(torch, name, s2d_conv, mods, cli_dir, n_fwd, n_gx, device):
    """``--model_type name`` on phase 11's directory for BACKBONE_CLI_EPOCHS
    epoch(s), in-process: the tag, the output tree, finite artifacts, a
    checkpoint loading strict, the launches by route, and frame 0's initial
    depth against the same adapter on the CPU. Its flows, masks and
    downscaled frames are phase 11's, so those stages are skipped."""
    image_io = mods["image_io"]
    args = ["--path", cli_dir, "--model_type", name, "--num_epochs",
            str(BACKBONE_CLI_EPOCHS)]
    out = io.StringIO()
    s2d_conv.reset_counts()
    t0 = time.perf_counter()
    try:
        with redirect_stdout(out):
            initial_dir, tag_dir, frames = mods["cli_main"].main(
                args, device=device)
    finally:
        with open(os.path.join(REPO, "build",
                               f"chip_smoke_cli_{name}.log"), "w") as log:
            log.write(out.getvalue())
    wall = time.perf_counter() - t0
    launches = (s2d_conv.launches, s2d_conv.grad_input_launches)
    routes = dict(s2d_conv.route_counts)
    n = CLI_FRAMES
    range_dir = os.path.dirname(tag_dir)
    depth_files = [os.path.join(d, "depth", f"frame_{i:06d}.raw")
                   for d in (initial_dir, tag_dir) for i in range(n)]
    missing = [p for p in depth_files if not os.path.isfile(p)]
    finite = not missing and all(
        bool(np.isfinite(image_io.load_raw_float32_image(p)).all())
        for p in depth_files)
    evals = sorted(f for f in os.listdir(os.path.join(tag_dir, "eval"))
                   if f.startswith("loss_e") and f.endswith(".json"))
    losses_ok = True
    for f in evals:
        with open(os.path.join(tag_dir, "eval", f)) as fh:
            d = json.load(fh)
        losses_ok &= all(math.isfinite(v) for sub in d.values()
                         for v in sub.values())
    ckpt = os.path.join(tag_dir, "checkpoints",
                        f"{BACKBONE_CLI_EPOCHS:04d}.pth")
    # strict=True inside the adapter's constructor
    cpu_model = mods["create_depth_model"](name, checkpoint=ckpt,
                                           device="cpu")
    del cpu_model
    # frame 0's initial depth against the adapter on the CPU, from the
    # default checkpoint the CLI read
    images, _ = mods["VideoFrameDataset"](
        os.path.join(cli_dir, "color_down", "frame_{:06d}.raw"),
        [0]).load_batch([0])
    cpu_model = mods["create_depth_model"](name, device="cpu")
    with torch.inference_mode():
        d_cpu = 1.0 / cpu_model.apply(torch.from_numpy(images[:, None]))[
            :, 0].numpy()
    bias = output_bias(name, cpu_model)
    del cpu_model
    # the files hold 1/depth; midas2's less its output bias (the network's
    # own part), held as the depth is
    d_card = image_io.load_raw_float32_image(depth_files[0])[None]
    if bias is not None:
        d_card, d_cpu = d_card - np.float64(bias), d_cpu - np.float64(bias)
    cpu_err = rel_err(d_card, d_cpu)
    pairs = len(mods["metadata_io"].read_flow_list(
        os.path.join(cli_dir, "flow_list.json"))) // 2
    steps = -(-pairs // TRAIN_BATCH)
    forwards = (2 * -(-n // TRAIN_BATCH)
                + (2 * BACKBONE_CLI_EPOCHS + 1) * steps)
    want = (n_fwd * forwards, n_gx * BACKBONE_CLI_EPOCHS * steps)
    result = {
        "tag": os.path.basename(tag_dir), "wall_s": wall,
        "range_dir": os.path.basename(range_dir),
        "initial_dir": os.path.basename(initial_dir),
        "frames_returned": frames == list(range(n)),
        "missing_depth_files": missing[:4], "depth_finite": finite,
        "eval_jsons": evals, "eval_losses_finite": losses_ok,
        "scales_csv": os.path.isfile(os.path.join(range_dir, "scales.csv")),
        "launches": list(launches), "expected_launches": list(want),
        "route_counts": routes,
        "initial_depth_card_vs_cpu_rel_err": cpu_err, "tol_cpu": TOL_CPU_REF}
    require(result["tag"] == BACKBONE_TAGS[name]
            and result["range_dir"] == f"R_hierarchical2_{name}"
            and result["initial_dir"] == f"depth_{name}",
            f"{name} CLI tree {result}")
    require(result["frames_returned"] and finite and result["scales_csv"],
            f"{name} CLI artifacts {result}")
    require(len(evals) == BACKBONE_CLI_EPOCHS + 1 and losses_ok,
            f"{name} CLI eval JSONs {evals}")
    require(tuple(launches) == want
            and routes["forward_tf32"] == want[0]
            and routes["grad_input_tf32"] == want[1],
            f"{name} CLI launches {launches} {routes}, expected {want}")
    require(cpu_err < TOL_CPU_REF, f"{name} CLI initial depth card vs CPU "
            f"{cpu_err}")
    return result, routes


def mesh_work(torch, mods, init_sd, workload, mesh, device):
    """Phase 14's run on ``device``: per precision an engine (over ``mesh``
    when given) from ``init_sd``; in f32 the paired eval's first
    MESH_EVAL_BATCHES batches, then MESH_STEPS train steps, with the conv
    wrappers' counts zeroed just before the steps and read just after; then
    MESH_SERVE_FRAMES frames served in bf16. Returns host copies."""
    training, s2d_conv = mods["training"], mods["s2d_conv"]
    n_pairs = len(workload["pair_ids"])
    batches = list(islice(training.PairBatchIterator(
        n_pairs, TRAIN_BATCH, seed=0).epoch(0), MESH_STEPS))
    eidx, evalid = training.eval_batches(n_pairs, TRAIN_BATCH)
    out = {}
    for precision in ("f32", "bf16"):
        model = mods["create_depth_model"]("mc", checkpoint="", device=device)
        model.net.load_state_dict(init_sd)
        eng = training.TrainingEngine(
            model, training.create_optimizer("Adam", TRAIN_LR),
            mods["LossWeights"](lambda_view_baseline=0.1,
                                lambda_reprojection=1.0),
            precision=precision, mesh=mesh)
        data = eng.put_data(workload)
        run = {}
        if precision == "f32":
            m = eng.eval_epoch(data, eidx[:MESH_EVAL_BATCHES],
                               evalid[:MESH_EVAL_BATCHES])
            run["eval"] = {k: m[k].double().cpu() for k in
                           ("loss", "reprojection", "disparity")}
        torch.cuda.synchronize(device)
        s2d_conv.reset_counts()
        steps = [eng.train_step(data, idx, valid) for idx, valid in batches]
        torch.cuda.synchronize(device)
        run["launches"] = [s2d_conv.launches, s2d_conv.grad_input_launches]
        run["routes"] = dict(s2d_conv.route_counts)
        run["losses"] = [float(m["loss"]) for m in steps]
        run["skipped"] = sum(bool(m["skipped_nan"]) for m in steps)
        run["state"] = {k: v.detach().cpu() for k, v in
                        model.net.state_dict().items()}
        out[precision] = run
        del eng, data, model
    frames = np.random.default_rng(2).random(
        (MESH_SERVE_FRAMES, *SIZE, 3), dtype=np.float32)
    server = mods["DepthServer"](mods["ServeConfig"](
        model_type="mc", checkpoint="", precision="bf16", batch_size=BATCH,
        device=str(device), mesh=mesh))
    out["serve"] = server.infer_frames(frames)
    return out


def mesh_rank(rank, store, init_path):
    """One of phase 14's gloo ranks, both on cuda:0; writes its results
    beside ``store``."""
    import pickle

    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(MESH_RANKS),
                      LOCAL_RANK=str(rank))
    from consistent_depth_tpu_torch.parallel import make_mesh

    mods = mesh_modules()
    mesh = make_mesh(device="cuda:0", backend="gloo",
                     init_method="file://" + store)
    try:
        init_sd = torch.load(init_path, map_location="cuda:0")
        workload = make_train_workload(mods["training"], SIZE)
        out = mesh_work(torch, mods, init_sd, workload, mesh, mesh.device)
    finally:
        dist.destroy_process_group()
    with open(f"{store}_rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def mesh_modules():
    """The port's modules that phase 14 calls, by name."""
    from consistent_depth_tpu_torch import training
    from consistent_depth_tpu_torch.models.registry import create_depth_model
    from consistent_depth_tpu_torch.ops import s2d_conv
    from consistent_depth_tpu_torch.ops.losses import LossWeights
    from consistent_depth_tpu_torch.serving import DepthServer, ServeConfig

    return {"training": training, "create_depth_model": create_depth_model,
            "s2d_conv": s2d_conv, "LossWeights": LossWeights,
            "DepthServer": DepthServer, "ServeConfig": ServeConfig}


def routes_of(counts):
    """The launches by route of a ``route_counts`` copy."""
    return {k: v for k, v in counts.items()
            if k.startswith(("forward_", "grad_input_"))}


def mesh_checks(torch, got, ref, init_sd, per_forward):
    """Phase 14's gloo ranks (``got``, one per rank) against the one-process
    run (``ref``), both from :func:`mesh_work`: per precision (a) the
    losses, the parameters, the ranks' states and launches; the eval
    batches; (c) the served depths."""
    checks = {}
    param_keys = [k for k in init_sd
                  if not k.endswith(("running_mean", "running_var",
                                     "num_batches_tracked"))]
    for dt in ("f32", "bf16"):
        want = ref[dt]
        c = checks[dt] = {
            "losses": [g[dt]["losses"] for g in got],
            "ref_losses": want["losses"],
            "loss_rel": [max(abs(a - b) / abs(b) for a, b in
                             zip(g[dt]["losses"], want["losses"]))
                         for g in got],
            "first_loss_rel": max(abs(g[dt]["losses"][0] - want["losses"][0])
                                  / abs(want["losses"][0]) for g in got),
            "params_rel_l2": max(rel_l2(
                {k: g[dt]["state"][k] for k in param_keys},
                {k: want["state"][k] for k in param_keys}) for g in got),
            "replicas_bitwise": all(
                torch.equal(got[0][dt]["state"][k], got[1][dt]["state"][k])
                for k in init_sd),
            "launches_per_rank": [g[dt]["launches"] for g in got],
            "ref_launches": want["launches"],
            # by route; the split of the reduction depends on the batch
            "routes_equal": all(routes_of(g[dt]["routes"])
                                == routes_of(want["routes"]) for g in got),
            "skipped": [g[dt]["skipped"] for g in got] + [want["skipped"]]}
    checks["per_forward"] = per_forward
    e, want = [g["f32"]["eval"] for g in got], ref["f32"]["eval"]
    checks["eval_f32"] = {
        "batches": MESH_EVAL_BATCHES,
        "loss_rel": max(float(((x["loss"] - want["loss"]).abs()
                               / want["loss"].abs()).max()) for x in e),
        "pair_loss_rel": max(float(((x[k] - want[k]).abs()
                                    / want[k].abs().clamp_min(1e-30)).max())
                             for x in e for k in ("reprojection",
                                                  "disparity"))}
    serve_rel = max(float(np.linalg.norm(g["serve"] - ref["serve"])
                          / np.linalg.norm(ref["serve"])) for g in got)
    serve = {"frames": MESH_SERVE_FRAMES, "batch_size": BATCH,
             "precision": "bf16",
             "shape_ok": all(g["serve"].shape == (MESH_SERVE_FRAMES, *SIZE)
                             for g in got),
             "finite": all(bool(np.isfinite(g["serve"]).all()) for g in got),
             "ranks_equal": bool(np.array_equal(got[0]["serve"],
                                                got[1]["serve"])),
             "vs_one_process_rel_l2": serve_rel, "tol": TOL_SERVE_BF16}
    return checks, serve


def mesh_require(checks, serve):
    """Fail unless phase 14's gloo ranks held against the one-process run."""
    per_forward = checks["per_forward"]
    for dt in ("f32", "bf16"):
        c = checks[dt]
        require(c["replicas_bitwise"], f"mesh {dt}: the ranks' states differ")
        require(all(n == c["ref_launches"] for n in c["launches_per_rank"])
                and c["routes_equal"],
                f"mesh {dt}: launches {c['launches_per_rank']} per rank, "
                f"{c['ref_launches']} in one process")
        require(c["ref_launches"] == [MESH_STEPS * per_forward,
                                      MESH_STEPS * (per_forward - 1)],
                f"mesh {dt}: {c['ref_launches']} launches in one process")
        require(not any(c["skipped"]), f"mesh {dt}: skipped steps")
        require(c["params_rel_l2"] <= TOL_MESH_PARAMS,
                f"mesh {dt}: params {c['params_rel_l2']}")
    f32, bf16 = checks["f32"], checks["bf16"]
    require(f32["first_loss_rel"] <= TOL_STEP_LOSS,
            f"mesh f32 first loss {f32['first_loss_rel']}")
    require(max(f32["loss_rel"]) <= TOL_MESH_LATER_LOSS,
            f"mesh f32 losses {f32['loss_rel']}")
    require(max(bf16["loss_rel"]) <= TOL_TRAIN_BF16,
            f"mesh bf16 losses {bf16['loss_rel']}")
    require(checks["eval_f32"]["loss_rel"] <= TOL_STEP_LOSS
            and checks["eval_f32"]["pair_loss_rel"] <= TOL_EVAL_PLAIN,
            f"mesh eval {checks['eval_f32']}")
    require(serve["shape_ok"] and serve["finite"] and serve["ranks_equal"]
            and serve["vs_one_process_rel_l2"] <= TOL_SERVE_BF16,
            f"mesh serving {serve}")


def mesh_path(torch, smi, init_sd, per_forward):
    """Phase 14: the data mesh on the card. (a) and (c): two gloo ranks on
    cuda:0, spawned, against the one-process engine and server run here
    meanwhile; (b): one NCCL rank from make_mesh's defaults against the
    engine without a mesh, with both step times. Returns the mesh ranks'
    launches by route, summed over the ranks, per precision."""
    import pickle
    import socket

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from consistent_depth_tpu_torch.parallel import make_mesh

    t0 = time.perf_counter()
    mods = mesh_modules()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    init_path = os.path.join(MESH_DIR, "init.pt")
    torch.save({k: v.cpu() for k, v in init_sd.items()}, init_path)
    store = os.path.join(MESH_DIR, "store")
    ranks = mp.start_processes(mesh_rank, args=(store, init_path),
                               nprocs=MESH_RANKS, join=False,
                               start_method="spawn")
    try:
        workload = make_train_workload(mods["training"], SIZE)
        ref = mesh_work(torch, mods, init_sd, workload, None,
                        torch.device("cuda:0"))
        while not ranks.join():
            pass
    finally:
        for proc in ranks.processes:
            if proc.is_alive():
                proc.terminate()
            proc.join()
    got = []
    for r in range(MESH_RANKS):
        with open(f"{store}_rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    spawned_s = time.perf_counter() - t0

    checks, serve = mesh_checks(torch, got, ref, init_sd, per_forward)
    emit({"phase": "mesh_gloo", "ranks": MESH_RANKS, "device": "cuda:0",
          "backend": "gloo", "steps": MESH_STEPS, **checks,
          "tol_first_loss": TOL_STEP_LOSS,
          "tol_later_loss": TOL_MESH_LATER_LOSS,
          "tol_bf16_loss": TOL_TRAIN_BF16, "tol_params": TOL_MESH_PARAMS,
          "tol_eval_loss": TOL_STEP_LOSS, "tol_eval_pairs": TOL_EVAL_PLAIN,
          "serve": serve, "seconds": spawned_s, "nvidia_smi": smi})
    mesh_require(checks, serve)

    # (b) one rank over NCCL, make_mesh's defaults
    t1 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    with env_var("RANK", "0"), env_var("WORLD_SIZE", "1"), \
            env_var("LOCAL_RANK", "0"), env_var("MASTER_ADDR", "127.0.0.1"), \
            env_var("MASTER_PORT", port):
        mesh = make_mesh()
    try:
        training = mods["training"]
        engines = {}
        for name, m in (("plain", None), ("nccl", mesh)):
            model = mods["create_depth_model"]("mc", checkpoint="",
                                               device=mesh.device)
            model.net.load_state_dict(init_sd)
            engines[name] = training.TrainingEngine(
                model, training.create_optimizer("Adam", TRAIN_LR),
                mods["LossWeights"](lambda_view_baseline=0.1,
                                    lambda_reprojection=1.0), mesh=m)
        data = engines["plain"].put_data(workload)
        del workload
        n_pairs = len(data["pair_ids"])
        batches = list(islice(training.PairBatchIterator(
            n_pairs, TRAIN_BATCH, seed=1).epoch(0),
            1 + WARMUP_STEPS + MESH_TIMED_STEPS))
        first = {n: float(e.train_step(data, *batches[0])["loss"])
                 for n, e in engines.items()}
        grads = {n: grads_of(e) for n, e in engines.items()}
        for idx, valid in batches[1:1 + WARMUP_STEPS]:
            for e in engines.values():
                e.train_step(data, idx, valid)
        times = {n: [] for n in engines}
        for idx, valid in batches[1 + WARMUP_STEPS:]:
            for n, e in engines.items():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                e.train_step(data, idx, valid)
                end.record()
                times[n].append((start, end))
        torch.cuda.synchronize()
        ms = {n: float(np.median([a.elapsed_time(b) for a, b in t]))
              for n, t in times.items()}
        # where the NCCL step's extra time goes: device time and idle share
        # of each engine over PROFILED_STEPS more steps
        profiles = {}
        for n, e in engines.items():
            prof = profile_train(torch, e, data, batches, mods["s2d_conv"])
            profiles[n] = {k: prof[k] for k in (
                "device_ms_per_step", "device_idle_share",
                "ranges_ms_per_step")}
            profiles[n]["top_kernels_ms_per_step"] = \
                prof["top_kernels_ms_per_step"][:12]
        nccl = {
            "phase": "mesh_nccl", "ranks": mesh.size,
            "backend": mesh.backend, "device": str(mesh.device),
            "loss_rel": abs(first["nccl"] - first["plain"])
            / abs(first["plain"]),
            "grads_rel_l2": rel_l2(grads["nccl"], grads["plain"]),
            "tol_loss": TOL_STEP_LOSS, "tol_grads": TOL_STEP_GRADS,
            "timed_steps": MESH_TIMED_STEPS, "precision": "f32",
            "median_ms_per_step": ms,
            "nccl_extra_ms": ms["nccl"] - ms["plain"], "profiles": profiles,
            "seconds": time.perf_counter() - t1, "nvidia_smi": smi}
    finally:
        dist.destroy_process_group()
    emit(nccl)
    require(mesh.backend == "nccl" and str(mesh.device) == "cuda:0",
            f"make_mesh's defaults gave {mesh.backend} on {mesh.device}")
    require(nccl["loss_rel"] <= TOL_STEP_LOSS
            and nccl["grads_rel_l2"] <= TOL_STEP_GRADS,
            f"NCCL mesh against no mesh {nccl}")
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    emit({"phase": "mesh", "seconds": time.perf_counter() - t0,
          "nvidia_smi": smi})
    return {dt: Counter(sum((Counter(g[dt]["routes"]) for g in got),
                            Counter())) for dt in ("f32", "bf16")}


# aux path (phase 15): DepthModel's forward and save, calibrate_scale, the
# weighted losses, a calibration render and the sparse calibration. The mc
# forwards run on one video of AUX_FRAMES frames at SIZE (phase 3's batch-8
# classes); the sparse model is the plane scene at 1/AUX_SCALE its size
AUX_DIR = os.path.join(REPO, "build", "chip_smoke_aux")
AUX_FRAMES = BATCH
AUX_SCALE = 2.75
AUX_SPARSE_FRAMES = 4
AUX_SPARSE_POINTS = 200
TOL_AUX_CPU = 1e-5
TOL_AUX_LSB = 1


def write_sparse_plane(colmap_io, image_io, geometry_np, scene, work_dir,
                       scale, n_points, seed=0):
    """A COLMAP sparse model of ``scene`` at 1/``scale`` its size under
    ``work_dir/sparse`` (the port's ``write_model``): each frame observes
    its own points, back-projected from integer pixels through its exact
    depth, so that the depth sampled there is the point's (its first three
    keypoints unmatched, id -1); the inverse
    depth of every frame but the last under ``work_dir/depth``. Returns
    the frames that have a depth file."""
    n = len(scene["depths"])
    H, W = scene["depths"].shape[1:]
    rng = np.random.default_rng(seed)
    extr = scene["extrinsics"].astype(np.float64)
    cams = colmap_io.intrinsics_to_camera(scene["intrinsics"],
                                          src_im_size=(W, H))
    images = colmap_io.extrinsics_to_images(
        np.concatenate([extr[..., :3], extr[..., 3:] / scale], -1))
    points, pid = {}, 1
    for i in range(n):
        xy = np.stack([rng.integers(0, W, n_points),
                       rng.integers(0, H, n_points)], -1).astype(np.float64)
        d = scene["depths"][i][xy[:, 1].astype(int), xy[:, 0].astype(int)]
        cam = geometry_np.pixels_to_points(
            scene["intrinsics"][i].astype(np.float64), d.astype(np.float64),
            xy)
        world = cam @ extr[i, :, :3].T + extr[i, :, 3]
        ids = np.arange(pid, pid + n_points)
        for k, p in enumerate(ids):
            points[int(p)] = colmap_io.Point3D(
                id=int(p), xyz=colmap_io.convert_points3D(world[k] / scale),
                rgb=np.zeros(3, np.uint8), error=0.0,
                image_ids=np.array([i + 1], np.int32),
                point2D_idxs=np.array([k], np.int32))
        ids[:3] = -1  # keypoints without a point
        images[i + 1].xys, images[i + 1].point3D_ids = xy, ids
        pid += n_points
    colmap_io.write_model(cams, images, points,
                          os.path.join(work_dir, "sparse"))
    os.makedirs(os.path.join(work_dir, "depth"))
    for i in range(n - 1):
        image_io.save_raw_float32_image(
            os.path.join(work_dir, "depth", f"frame_{i:06d}.raw"),
            1.0 / scene["depths"][i])
    return list(range(n - 1))


def aux_path(torch, smi, s2d_conv, init_sd, classes, per_forward,
             device="cuda"):
    """Phase 15 in a scratch directory, deleted after; returns the
    forwards' launches by route. ``device="cpu"`` rehearses it on the CPU
    (then "card" is the CPU too, and no kernel launches)."""
    shutil.rmtree(AUX_DIR, ignore_errors=True)
    os.makedirs(AUX_DIR)
    try:
        return _aux_checks(torch, smi, s2d_conv, init_sd, classes,
                           per_forward, device)
    finally:
        shutil.rmtree(AUX_DIR, ignore_errors=True)


def _aux_checks(torch, smi, s2d_conv, init_sd, classes, per_forward,
                device):
    import cv2

    from consistent_depth_tpu_torch.io import colmap_io, image_io
    from consistent_depth_tpu_torch.models.registry import (
        create_depth_model)
    from consistent_depth_tpu_torch.ops import geometry, geometry_np, losses
    from consistent_depth_tpu_torch.pipeline.scale_calibration import (
        visualize_calibration_pair)
    from consistent_depth_tpu_torch.utils.calibration import (
        calibrate_w_sparse_colmap)

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    # -- DepthModel: save, reload, forward with scales, train-mode forward
    model = create_depth_model("mc", checkpoint="", device=device)
    model.net.load_state_dict(init_sd)
    pth = os.path.join(AUX_DIR, "mc.pth")
    model.save(pth)
    back = create_depth_model("mc", checkpoint=pth, device=device)
    reload_bitwise = all(torch.equal(v, init_sd[k])
                         for k, v in back.net.state_dict().items())
    rng = np.random.default_rng(15)
    images = rng.random((1, AUX_FRAMES, *SIZE, 3), dtype=np.float32)
    scales = rng.uniform(0.5, 2.0, (1, AUX_FRAMES)).astype(np.float32)
    bn = "seq.1.running_mean"
    sync()
    s2d_conv.reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        d_fwd = model.forward(images, {"scales": scales}, train=False)
        d_apply = model.apply(torch.from_numpy(images).to(device),
                              torch.from_numpy(scales).to(device),
                              train=False)
        d_back = back.forward(images, {"scales": scales}, train=False)
        d_train = model.forward(images)
    sync()
    forward_s = time.perf_counter() - t0
    launches = s2d_conv.launches
    routes = dict(s2d_conv.route_counts)
    n_fwd = 4
    want_routes = {f"forward_{r}": n * n_fwd for r, n in expected_routes(
        s2d_conv, classes, torch.float32, False).items()}
    stats_moved = not torch.equal(model.net.state_dict()[bn], init_sd[bn])
    with torch.no_grad(), plain_convs(s2d_conv):
        d_plain = back.forward(images, {"scales": scales}, train=False)
    plain_err = rel_err(d_fwd.cpu().numpy(), d_plain.cpu().numpy())
    finite = all(bool(torch.isfinite(d).all())
                 for d in (d_fwd, d_back, d_train))
    del model, back

    # -- calibrate_scale and the weighted losses, card against CPU
    scene = make_plane_scene(torch, geometry, AUX_SPARSE_FRAMES, SIZE)
    calib_err = 0.0
    for pair in ([0, 1], [2, 0]):
        args = [torch.from_numpy(a) for a in (
            scene["extrinsics"][pair], scene["intrinsics"][pair],
            scene["depths"][pair] * np.float32(1.7))]
        card = geometry.calibrate_scale(*(a.to(device) for a in args))
        cpu = geometry.calibrate_scale(*args)
        calib_err = max(calib_err, abs(float(card) - float(cpu))
                        / abs(float(cpu)))
    x, target = (torch.from_numpy(rng.standard_normal(
        (TRAIN_BATCH, *SIZE, 2)).astype(np.float32)) for _ in range(2))
    weights = torch.from_numpy(rng.random((TRAIN_BATCH, *SIZE),
                                          dtype=np.float32))
    loss_err = 0.0
    for name in ("weighted_mse_loss", "weighted_rmse_loss"):
        outs = []
        for dev in (device, "cpu"):
            xd = x.detach().to(dev).requires_grad_()
            wd = weights.detach().to(dev).requires_grad_()
            val = getattr(losses, name)(xd, target.to(dev), wd)
            val.sum().backward()
            outs.append([t.detach().cpu().numpy()
                         for t in (val, xd.grad, wd.grad)])
        loss_err = max(loss_err, *(rel_err(a, b)
                                   for a, b in zip(*outs)))

    # -- one calibration render, card against CPU
    color_fmt = os.path.join(AUX_DIR, "color_{:06d}.png")
    depth_fmt = os.path.join(AUX_DIR, "inv_depth_{:06d}.raw")
    for i in (0, 1):
        cv2.imwrite(color_fmt.format(i),
                    np.uint8(np.round(scene["frames"][i] * 255)))
        image_io.save_raw_float32_image(depth_fmt.format(i),
                                        1.0 / scene["depths"][i])
    extr = scene["extrinsics"].astype(np.float64)
    intr = scene["intrinsics"].astype(np.float64)
    vis = {}
    for name, dev in (("card", device), ("cpu", "cpu")):
        out_dir = os.path.join(AUX_DIR, f"vis_{name}")
        visualize_calibration_pair(extr, intr, depth_fmt, color_fmt, (1, 0),
                                   out_dir, device=dev)
        vis[name] = {f: cv2.imread(os.path.join(out_dir, f)).astype(int)
                    for f in sorted(os.listdir(out_dir))}
    vis_lsb = max(int(np.abs(vis["card"][f] - vis["cpu"][f]).max())
                  for f in vis["cpu"])
    warped_mean = float(np.mean([v.mean() for f, v in vis["card"].items()
                                 if "warped" in f]))

    # -- the sparse calibration of a model at a known scale
    have = write_sparse_plane(colmap_io, image_io, geometry_np, scene,
                              AUX_DIR, AUX_SCALE, AUX_SPARSE_POINTS)
    sparse = calibrate_w_sparse_colmap(
        os.path.join(AUX_DIR, "sparse"),
        os.path.join(AUX_DIR, "depth", "frame_{:06d}.raw"), SIZE[::-1])
    scale_err = max((abs(v - AUX_SCALE) / AUX_SCALE for v in sparse.values()),
                    default=float("inf"))

    row = {
        "phase": "aux", "size": list(SIZE), "frames": AUX_FRAMES,
        "reload_bitwise": reload_bitwise,
        "forward_scales_is_apply": bool(torch.equal(d_fwd, d_apply)),
        "reloaded_forward_bitwise": bool(torch.equal(d_fwd, d_back)),
        "train_forward_moved_stats": stats_moved, "finite": finite,
        "forward_seconds": forward_s, "launches": launches,
        "expected_launches": n_fwd * per_forward, "route_counts": routes,
        "expected_routes": want_routes,
        "kernel_vs_plain_rel_err": plain_err, "tol_plain": TOL_EVAL_PLAIN,
        "calibrate_scale_card_vs_cpu": calib_err,
        "weighted_losses_card_vs_cpu": loss_err, "tol_cpu": TOL_AUX_CPU,
        "vis_files": sorted(vis["card"]), "vis_card_vs_cpu_lsb": vis_lsb,
        "vis_warped_mean_level": warped_mean, "tol_lsb": TOL_AUX_LSB,
        "sparse_scales": {str(k): v for k, v in sparse.items()},
        "sparse_known_scale": AUX_SCALE, "sparse_scale_rel_err": scale_err,
        "seconds": time.perf_counter() - t_phase, "nvidia_smi": smi}
    emit(row)
    require(reload_bitwise, "DepthModel.save then a reload changed weights")
    require(row["forward_scales_is_apply"], "forward with scales != apply")
    require(row["reloaded_forward_bitwise"],
            "the reloaded model's forward differs")
    require(stats_moved, "a train-mode forward left the running stats")
    require(finite, "non-finite depth")
    require(launches == n_fwd * per_forward,
            f"{launches} kernel launches, expected {n_fwd * per_forward}")
    require(all(routes.get(k, 0) == v for k, v in want_routes.items()),
            f"phase 15 took routes {routes}, expected {want_routes}")
    require(plain_err <= TOL_EVAL_PLAIN, f"forward vs plain {plain_err}")
    require(calib_err <= TOL_AUX_CPU, f"calibrate_scale vs CPU {calib_err}")
    require(loss_err <= TOL_AUX_CPU, f"weighted losses vs CPU {loss_err}")
    require(len(vis["card"]) == 4 and sorted(vis["card"]) == sorted(
        vis["cpu"]), f"calibration renders {sorted(vis['card'])}")
    require(vis_lsb <= TOL_AUX_LSB, f"calibration render {vis_lsb} levels")
    require(sorted(sparse) == have, f"sparse scales for {sorted(sparse)}")
    require(scale_err <= TOL_AUX_CPU, f"sparse scale off by {scale_err}")
    return routes


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA "
              "H100", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from consistent_depth_tpu_torch import training
        from consistent_depth_tpu_torch.flow import correlation as corr
        from consistent_depth_tpu_torch.flow.runner import TorchFlowBackend
        from consistent_depth_tpu_torch.io import image_io
        from consistent_depth_tpu_torch.models import hourglass, torch_import
        from consistent_depth_tpu_torch.models.registry import (
            create_depth_model)
        from consistent_depth_tpu_torch.ops import _cuda, s2d_conv
        from consistent_depth_tpu_torch.ops.consistency import (
            consistent_flow_masks)
        from consistent_depth_tpu_torch.ops.flow_viz import (
            flow_to_image_torch)
        from consistent_depth_tpu_torch.ops.losses import LossWeights
        from consistent_depth_tpu_torch.pipeline.flow_stage import Flow
        from consistent_depth_tpu_torch.serving import (
            DepthServer, ServeConfig)
        mods = cli_modules(training)
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    # -- 1. device --------------------------------------------------------
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "capability": list(cap), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: the kernels are built for sm_90a and "
                         f"need compute capability 9.0, not {cap}")

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = _cuda.build()
    _cuda.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(lib_path, REPO)})

    # -- 3. kernel against plain, per conv class of the main path ---------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    probe = create_depth_model("mc", checkpoint="", device="cuda",
                               dtype=torch.bfloat16)
    classes = record_conv_classes(torch, s2d_conv, probe)
    del probe
    n_incep = sum(1 for m in hourglass.HourglassModel().modules()
                  if isinstance(m, hourglass.Inception))
    per_forward = 1 + 3 * n_incep + 1   # stem, k x k branches, merged heads
    rows = []
    for i, ((xs, ws, has_bias), count) in enumerate(sorted(classes.items())):
        row = check_conv(torch, s2d_conv, "forward", xs, ws, has_bias, seed=i)
        row["per_forward"] = count
        rows.append(row)
        emit({"phase": "kernel", **row})
    totals = conv_totals(rows, "per_forward")
    emit({"phase": "kernels", "classes": len(rows),
          "launches_per_forward": sum(classes.values()),
          "expected_per_forward": per_forward,
          "per_forward_ms": totals, "nvidia_smi": smi,
          "pass": all(r["pass"] for r in rows)})
    require(all(r["pass"] for r in rows), "kernel disagrees with plain")
    require(sum(classes.values()) == per_forward,
            f"{sum(classes.values())} same_conv calls per forward, "
            f"expected {per_forward}")

    # the ragged cases and the train phase's 64x96 classes, both directions
    added = check_added_cases(torch, s2d_conv, create_depth_model)
    emit({"phase": "conv_cases", "cases": len(added),
          "routes": Counter(f"{r['direction']}_{r[dt]['route']}"
                            for r in added for dt in ("f32", "bf16")),
          "max_rel_err": {dt: max(r[dt]["max_rel_err"] for r in added)
                          for dt in ("f32", "bf16")},
          "tol_rel": {"f32": TOL_F32, "bf16": TOL_BF16},
          "failed": [r for r in added if not r["pass"]],
          "pass": all(r["pass"] for r in added)})
    require(all(r["pass"] for r in added),
            "kernel disagrees with plain on an added case")
    require(all(any(r[dt]["route"] == "fma" for r in added)
                for dt in ("f32", "bf16")),
            "no added case took the FMA template in both dtypes")

    # -- 4. the main path: serving ----------------------------------------
    rng = np.random.default_rng(0)
    videos = {
        "a": rng.random((FRAMES_PER_VIDEO, *SIZE, 3), dtype=np.float32),
        "b": rng.random((FRAMES_PER_VIDEO, *SIZE, 3), dtype=np.float32),
        "c": rng.random((ODD_FRAMES, *ODD_SIZE, 3), dtype=np.float32),
    }
    n_frames = 2 * FRAMES_PER_VIDEO + ODD_FRAMES
    n_batches = 2 * FRAMES_PER_VIDEO // BATCH + math.ceil(ODD_FRAMES / BATCH)
    server = DepthServer(ServeConfig(
        model_type="mc", checkpoint="", precision="bf16", batch_size=BATCH))
    server.infer_videos(videos)            # warm-up
    torch.cuda.synchronize()
    s2d_conv.reset_counts()
    corr.launches = 0
    t0 = time.perf_counter()
    out = server.infer_videos(videos)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = s2d_conv.launches
    serve_routes = dict(s2d_conv.route_counts)
    serve_corr_launches = corr.launches
    want_routes = {f"forward_{r}": n * n_batches for r, n in expected_routes(
        s2d_conv, classes, torch.bfloat16, False).items()}

    server32 = DepthServer(ServeConfig(
        model_type="mc", checkpoint="", precision="f32", batch_size=BATCH))
    out32 = server32.infer_videos(videos)
    shapes_ok = all(out[v].shape == videos[v].shape[:3] for v in videos)
    finite = all(bool(np.isfinite(out[v]).all()) for v in videos)
    rel_l2 = {v: float(np.linalg.norm(out[v] - out32[v])
                       / np.linalg.norm(out32[v])) for v in videos}
    log32 = np.concatenate([np.log(out32[v]).ravel() for v in videos])
    max_log_diff = max(float(np.abs(np.log(out[v]) - np.log(out32[v])).max())
                       for v in videos)

    # the f32 path on the card against the plain path on the CPU, same
    # seeded weights, on a small input
    small = torch.from_numpy(videos["a"][:2, :96, :128])[None]
    cpu_model = create_depth_model("mc", checkpoint="", device="cpu")
    with torch.inference_mode():
        d_cpu = cpu_model.apply(small).numpy()
        d_gpu = server32.model.apply(small.cuda()).cpu().numpy()
    cpu_err = float(np.abs(d_gpu - d_cpu).max() / np.abs(d_cpu).max())

    serve = {
        "phase": "serve", "frames": n_frames, "batches": n_batches,
        "batch_size": BATCH, "precision": "bf16", "seconds": dt,
        "fps": n_frames / dt, "ms_per_frame": 1e3 * dt / n_frames,
        "launches": launches, "expected_launches": per_forward * n_batches,
        "route_counts": serve_routes, "expected_routes": want_routes,
        "correlation_launches": serve_corr_launches,
        "shapes_ok": shapes_ok, "finite": finite,
        "init_log_depth_range": [float(log32.min()), float(log32.max())],
        "bf16_vs_f32_rel_l2": rel_l2, "bf16_vs_f32_max_log_diff": max_log_diff,
        "tol_rel_l2": TOL_SERVE_BF16,
        "f32_card_vs_cpu_rel_err": cpu_err, "tol_cpu": TOL_CPU_REF,
        "nvidia_smi": smi,
    }
    emit(serve)
    require(shapes_ok, "wrong output shapes")
    require(finite, "non-finite depth")
    require(launches == per_forward * n_batches,
            f"{launches} kernel launches, expected {per_forward * n_batches}")
    require(all(serve_routes[k] == v for k, v in want_routes.items()),
            f"serving took routes {serve_routes}, expected {want_routes}")
    require(max(rel_l2.values()) < TOL_SERVE_BF16,
            f"bf16 against f32 depth {rel_l2}")
    require(cpu_err < TOL_CPU_REF, f"card against CPU {cpu_err}")

    # -- 5. correlation kernel against plain ------------------------------
    del server, server32, cpu_model
    torch.cuda.empty_cache()
    flow_rng = np.random.default_rng(1)
    frames = [flow_rng.random((*FLOW_SIZE, 3), dtype=np.float32)
              for _ in range(3)]
    backend = TorchFlowBackend(checkpoint=None, full=True, homography=False,
                               seed=0, device="cuda")
    recorded = record_correlation_shapes(torch, corr, backend, frames[:2])
    corr_rows = []
    for i, (name, shape, md, st, route) in enumerate(CORR_CASES):
        row = check_correlation(torch, corr, name, shape, md, st, seed=i)
        row["expected_route"] = route
        row["pass"] = row["pass"] and row["route"] == route
        corr_rows.append(row)
        emit({"phase": "correlation", **row, "nvidia_smi": smi})
    main_row = corr_rows[0]
    # the banded kernel with each G, and the generic kernel, on the main
    # case's inputs (its seed)
    name, shape, md, st, _ = CORR_CASES[0]
    sweep = [check_correlation(torch, corr, f"{name}_G{G}", shape, md, st,
                               seed=0, group=G) for G in corr.GROUPS]
    generic_row = check_correlation(torch, corr, f"{name}_generic", shape,
                                    md, st, seed=0, route="generic")
    for row in (*sweep, generic_row):
        emit({"phase": "correlation_variant", **row, "nvidia_smi": smi})
    corr_rows += [*sweep, generic_row]
    emit({"phase": "correlations", "recorded_per_forward": [
        list(r) for r in recorded],
        "routes": Counter(r["route"] for r in corr_rows),
        "group_ms": {r["group"]: r["ms"] for r in sweep},
        "fastest_group": min(sweep, key=lambda r: r["ms"])["group"],
        "default_group": corr.DEFAULT_GROUP,
        "generic_ms": generic_row["ms"],
        "banded_vs_generic": generic_row["ms"] / main_row["ms"],
        "host_not_hidden": [r["case"] for r in corr_rows
                            if not r["queue_hid_host"]],
        "nvidia_smi": smi, "pass": all(r["pass"] for r in corr_rows)})
    require(recorded == [(CORR_CASES[0][1], 20, 2)],
            f"FlowNet2 at {FLOW_SIZE} made correlation calls {recorded}")
    require(all(r["pass"] for r in corr_rows),
            "correlation kernel disagrees with plain or took another route")

    # -- 6. the flow path: FlowNet2 at 448x1024, masks, visualisation -----
    backend.compute_pair(frames[0], frames[1])        # warm-up
    torch.cuda.synchronize()
    s2d_conv.launches = corr.launches = 0
    corr.route_counts.update(dict.fromkeys(corr.route_counts, 0))
    t0 = time.perf_counter()
    flows = [backend.compute_pair(frames[i], frames[j]) for i, j in FLOW_PAIRS]
    torch.cuda.synchronize()
    flow_dt = time.perf_counter() - t0
    flow_launches = corr.launches
    flow_routes = dict(corr.route_counts)
    flow_conv_launches = s2d_conv.launches

    orig = corr.correlation
    corr.correlation = corr.correlation_reference
    try:
        plain_flows = [backend.compute_pair(frames[i], frames[j])
                       for i, j in FLOW_PAIRS]
    finally:
        corr.correlation = orig
    plain_err = max(rel_err(f, p) for f, p in zip(flows, plain_flows))

    small = [f[:64, :128] for f in frames[:2]]
    cpu_backend = TorchFlowBackend(checkpoint=None, full=True,
                                   homography=False, seed=0, device="cpu")
    flow_cpu_err = rel_err(backend.compute_pair(*small),
                           cpu_backend.compute_pair(*small))
    del cpu_backend

    pair_flows = np.stack([np.stack(flows[0:2]), np.stack(flows[2:4])])
    pair_colors = np.stack([np.stack(frames[0:2]), np.stack(frames[1:3])])
    with torch.inference_mode():
        masks_gpu = consistent_flow_masks(
            torch.from_numpy(pair_flows).cuda(),
            torch.from_numpy(pair_colors).cuda()).cpu().numpy()
        masks_cpu = consistent_flow_masks(
            torch.from_numpy(pair_flows),
            torch.from_numpy(pair_colors)).numpy()
        flat = torch.from_numpy(np.stack(flows))
        colours_gpu = flow_to_image_torch(flat.cuda()).cpu().numpy()
        colours_cpu = flow_to_image_torch(flat).numpy()
    mask_diff = float(np.mean(masks_gpu != masks_cpu))
    colour_diff = float(np.abs(colours_gpu - colours_cpu).max())
    stage_masks, panels, warped = drive_flow_stage(
        image_io, Flow, flows, frames,
        os.path.join(REPO, "build", "chip_smoke_flow"))
    # FLOW_PAIRS in order are pair 0 both ways, then pair 1 both ways
    cpu_by_pair = dict(zip(FLOW_PAIRS, masks_cpu.reshape(4, *FLOW_SIZE)))
    stage_mask_diff = max(float(np.mean((stage_masks[p] > 0)
                                        != cpu_by_pair[p]))
                          for p in FLOW_PAIRS)

    ms_pair = 1e3 * flow_dt / len(FLOW_PAIRS)
    flow_shapes_ok = all(f.shape == (*FLOW_SIZE, 2) for f in flows)
    flow_finite = all(bool(np.isfinite(f).all()) for f in flows)
    emit({
        "phase": "flow", "size": list(FLOW_SIZE), "pairs": len(FLOW_PAIRS),
        "network": type(backend.net).__name__, "precision": "f32",
        "seconds": flow_dt, "ms_per_pair": ms_pair,
        "correlation_ms": main_row["ms"],
        "correlation_share": main_row["ms"] / ms_pair,
        "launches": flow_launches, "expected_launches": len(FLOW_PAIRS),
        "correlation_routes": flow_routes,
        "same_conv_launches": flow_conv_launches,
        "shapes_ok": flow_shapes_ok, "finite": flow_finite,
        "max_abs_flow": max(float(np.abs(f).max()) for f in flows),
        "kernel_vs_plain_rel_err": plain_err, "tol_plain": TOL_FLOW,
        "card_vs_cpu_rel_err": flow_cpu_err, "tol_cpu": TOL_FLOW,
        "mask_kept_fraction": float(masks_cpu.mean()),
        "mask_card_vs_cpu_fraction": mask_diff,
        "stage_mask_vs_cpu_fraction": stage_mask_diff,
        "tol_mask_fraction": TOL_MASK_FRACTION,
        "colour_card_vs_cpu_levels": colour_diff,
        "tol_colour_levels": TOL_COLOUR_LEVELS,
        "stage_panels": len(panels), "stage_warped": len(warped),
        "nvidia_smi": smi,
    })
    require(flow_shapes_ok, "wrong flow shapes")
    require(flow_finite, "non-finite flow")
    require(flow_launches == len(FLOW_PAIRS),
            f"{flow_launches} correlation launches for {len(FLOW_PAIRS)} "
            "pairs")
    require(flow_routes == {"banded": len(FLOW_PAIRS), "generic": 0},
            f"FlowNet2's correlation took routes {flow_routes}")
    require(flow_conv_launches == 0, "FlowNet2 launched same_conv")
    require(plain_err < TOL_FLOW, f"flow with kernel vs plain {plain_err}")
    require(flow_cpu_err < TOL_FLOW, f"flow card vs CPU {flow_cpu_err}")
    require(mask_diff <= TOL_MASK_FRACTION, f"masks card vs CPU {mask_diff}")
    require(stage_mask_diff <= TOL_MASK_FRACTION,
            f"stage masks vs CPU {stage_mask_diff}")
    require(colour_diff <= TOL_COLOUR_LEVELS,
            f"flow colours card vs CPU {colour_diff}")
    require(len(panels) == 2 and len(warped) == 4,
            f"stage wrote {len(panels)} panels, {len(warped)} warped frames")

    # -- 7-8. the train path ---------------------------------------------
    del backend
    torch.cuda.empty_cache()
    gx_rows, context = train_path(
        torch, smi, classes, training, s2d_conv, create_depth_model,
        LossWeights)

    # -- 9. the epoch engine: train_epoch and eval_epoch ------------------
    epochs, _ = epoch_path(torch, smi, training, s2d_conv, per_forward,
                           context)

    # -- 10. the fine-tune driver: epochs, evals, checkpoints, resume -----
    # (phase 8's resident data stays for phases 12-13)
    context["engines"].clear()
    torch.cuda.empty_cache()
    driver_path(torch, smi, training, s2d_conv, image_io, torch_import,
                create_depth_model, per_forward, context)

    # -- 11. the pipeline through the CLI, in-process and as python -m ------
    # -- 12-13. the midas2 and monodepth2 backbones, CLI on phase 11's dir --
    torch.cuda.empty_cache()
    backbones = {}
    try:
        cli = cli_path(torch, smi, mods, s2d_conv, corr, per_forward,
                       context["init_sd"], keep=True)
        for name in BACKBONES:
            torch.cuda.empty_cache()
            _, *backbones[name] = backbone_path(
                torch, smi, name, training, s2d_conv, mods, LossWeights,
                DepthServer, ServeConfig, context["data"], CLI_DIR)
    finally:
        shutil.rmtree(CLI_DIR, ignore_errors=True)
    del context["data"]

    # -- 14. the data mesh: two gloo ranks on the card, one NCCL rank -----
    torch.cuda.empty_cache()
    mesh_routes = mesh_path(torch, smi, context["init_sd"], per_forward)

    # -- 15. aux: DepthModel's save and forward, calibration, renders -----
    torch.cuda.empty_cache()
    aux_routes = aux_path(torch, smi, s2d_conv, context["init_sd"], classes,
                          per_forward)

    # the launches by route of each path that runs the kernel. mc's conv
    # entries: one train epoch of phase 9 (179 steps), by precision, the
    # CLI's run of phase 11 (f32), phase 14's mesh ranks' train steps
    # (both ranks, by precision) and phase 15's four f32 forwards, with the times of mc's classes per
    # batch-8 forward (phase 3) or per train step (phase 7). Each
    # backbone's entries (same_conv_<name>...): its timed train steps (by
    # precision) and CLI run (f32) of phases 12-13, with the times of its
    # own classes per batch-8 forward or per step. One entry per route the
    # plan gives a class of the path (the FMA template, for the shapes the
    # tensor-core kernels do not take, has none at present)
    conv_tpu = "consistent_depth_tpu/ops/s2d_conv.py:168"
    vjp_tpu = "consistent_depth_tpu/models/layers.py:321"
    def mc_runs(dt, key):
        return {"epoch": epochs[dt]["train_epoch"]["route_counts"][key],
                "cli": cli["route_counts"][key] if dt == "f32" else 0,
                "mesh": mesh_routes[dt][key],
                "aux": aux_routes.get(key, 0) if dt == "f32" else 0}

    def backbone_runs(runs):
        return lambda dt, key: {
            "train": runs[dt][key],
            "cli": runs["f32_cli"][key] if dt == "f32" else 0}

    paths = [("", rows, gx_rows, "per_forward", "per_step", mc_runs)]
    for b, (runs, brows) in backbones.items():
        paths.append((
            "_" + b, [r for r in brows if r["direction"] == "forward"],
            [r for r in brows if r["direction"] == "grad_input"], "count",
            "count", backbone_runs(runs)))
    entries = []
    for path, fwd_rows, bwd_rows, fwd_key, bwd_key, runs_of in paths:
        for dt in ("bf16", "f32"):
            for route in s2d_conv.ROUTES:
                suffix = path + ("" if dt == "bf16" else "_f32") + (
                    "_fma" if route == "fma" else "")
                for name, key, rows_of, count_key, replaces in (
                        ("same_conv", "forward_", fwd_rows, fwd_key,
                         conv_tpu),
                        ("same_conv_grad_input", "grad_input_", bwd_rows,
                         bwd_key, vjp_tpu)):
                    by_path = runs_of(dt, key + route)
                    entry = conv_entry(name + suffix, replaces,
                                       sum(by_path.values()), rows_of,
                                       count_key, dt, route)
                    if entry is not None:
                        entry["launches_by_path"] = by_path
                    entries.append(entry)
    # the correlation's two routes: the banded kernel at the main path's
    # shape, and the generic kernel on the same inputs (it has no main-path
    # launches); no one PyTorch call computes a cost volume
    for name, route, row in (("correlation", "banded", main_row),
                             ("correlation_generic", "generic", generic_row)):
        by_path = {"flow": flow_routes[route],
                   "cli": cli["correlation_routes"][route]}
        entries.append(
            {"name": name, "route": "cuda", "kernel_route": route,
             "source": "consistent_depth_tpu_torch/csrc/correlation.cu",
             "replaces": "consistent_depth_tpu/flow/correlation.py:116",
             "launches": sum(by_path.values()), "launches_by_path": by_path,
             "max_abs_err": max(r["max_abs_err"] for r in corr_rows
                                if r["route"] == route),
             "ms": row["ms"], "plain_ms": row["plain_ms"],
             "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
             "library_ms": None})
    print(smi, flush=True)
    emit({"kernels": [e for e in entries if e is not None]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
