"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py [test options...]

Phases, each failing the run (non-zero exit) on the first error:
  1. card: CUDA must be present; prints nvidia-smi's name and power limit.
  2. build: compiles the CUDA kernels from gfla_tpu_torch/csrc with nvcc,
     and csrc/jpeg_nvjpeg.cpp (linked with the toolkit's nvJPEG) beside
     them.
  3. kernel: the warp kernel against its plain torch version at both live
     attention sites of the DeepFashion generator, with far-off flows, at
     the sites of a 64x64 input, at a ragged shape (non-square, C and D
     no multiples of 8), at k=7 and at k = 2, 4, 6, 8 and 9 at the k=5 site
     (every k but 3 and 5 runs the kernels' run-time-k instance), and past
     9 on the wide instances: k = 10, 11, 13 and 14 at the k=5 site, 13
     and 16 at the k=3 site, 17 at Market's k=5 site (a block wider than
     the map), 11 at a ragged shape; k = 0 is refused before any launch; max errors and median
     times of both, and of the kernel storing hpre (the pre-activation
     hidden layer) for the backward, held against the plain hpre.
  4. bwd kernel: both backward kernels (per position, from the forward
     kernel's hpre; dW1s) against their plain versions given that hpre in
     the same cases, each of the six outputs within 1e-4 x its max |value|;
     d_flow, dW1s, dW2 and db2 bitwise equal over two launches; median
     times of both. Both refuse float16, and a bf16 source with f32
     weights.
  4b. bf16 kernels: the three kernels' bf16 instances (warp_fwd_bf16.cu,
     warp_bwd_bf16.cu) against their bf16 plain twins at every KERNEL_CASES
     shape, each output by the bf16 rule (BF16_SLACK) against the f32
     result of the same values; d_flow, d_hidden_bt, dW1s, dW2 and db2
     bitwise equal over two launches; median times, bounds at the bf16
     rate.
  5. serve: the full-width pose generator (ngf 64, img_f 512, attention at
     levels 2/3 with kernels 5/3) serves four batch-8 requests of 256x176
     content in 256x256 tensors through PoseTask.test_step; checks shape,
     range, the kernel launch count, the plain-warp path and a CPU run on a
     small input; median ms per forward of both paths.
  5b. bf16 serving: the same weights and requests under
     --compute_dtype=bfloat16: 2 bf16 warp launches a request and no other
     kernel, shape and range, the image against the plain bf16 path and
     both against the f32 image by the bf16 rule; ms per forward beside the
     f32 path's in turns; then under GFLA_ATTN_PALLAS=1: 2 bf16
     attention-math forward launches a request and no other kernel, the
     image against that route's plain bf16 path and the f32 image by the
     bf16 rule.
  6. train: the full-width pose training step (G as in 5, the 4-layer
     spectral-norm ResDiscriminator, VGG19, six G losses, two Adams) takes
     four batch-8 steps through the kernels: finite losses, every parameter
     moved, u stored by the two D passes and not by the G-loss pass, 2
     launches of each kernel per step; a checkpoint save/resume gives the
     same next step; one step against the plain path from one state and
     one card step against a CPU step at 2x64x64, gradients held against a
     float64 step; median ms per step of both paths and the peak memory.
  6b. bf16 train: four full-width batch-8 steps under
     --compute_dtype=bfloat16 through the bf16 warp kernels (2 launches of
     each a step, nothing else): finite losses, every parameter moved and
     f32, u computed in bf16 by the two D passes and stored in f32; one
     step on the kernel path against the plain bf16 path from one state,
     losses within 1e-2 rel, each tensor's gradient directly against the
     plain path's by cosine and norm ratio (BF16_STEP_HOLD), both paths'
     gradients against the f32 step's by the bf16 rule on each network's
     mean; save/resume; ms per step and peak memory beside the f32 step's.
  7. corr kernel: the max-correlation kernel against its plain scan at both
     sites of the correctness loss, at a ragged shape and with duplicated
     and zero rows (exact ties); cmax also against the float64 maximum;
     median ms of the kernel, the scan and one unchunked torch.bmm + max,
     the yardstick the port never calls.
  8. attn-math kernels: the math-fused forward (also storing hpre) and
     the backward from that hpre against their plain twins at both
     attention sites, a ragged shape and a ReLU; the backward's outputs
     bitwise equal over two launches; median ms of each, the plain
     backward timed given hpre and recomputing it.
  8b. bf16 attn-math kernels: their bf16 instances (attn_math_fwd_bf16.cu,
     attn_math_bwd_bf16.cu) against the bf16 plain twins at both pose
     sites, ShapeNet's, the animation heads' two B=2 sites and a ragged
     shape: each output by the bf16 rule, the
     f32 hpre within 1e-4 x max of the twin's, all six backward outputs
     bitwise equal over two launches; median ms and the bound at the bf16
     rate.
  9. poseflownet: stage-1 flow pretraining at full width, batch 8, with
     GFLA_PALLAS_CORR=1: four steps, 2 max-correlation launches each;
     finite losses; every parameter the losses reach moved; at each
     correctness layer, the rows where the kernel's argmax differs from the
     scan's held to the top-two-gap rule of 7 (near-ties); one step against
     the scan path from one state, both under deterministic algorithms and
     the scan given the kernel's argmax (float64 rule as in 6); a save,
     then the pose task's --continue_train on it starts its flow net from
     it (the two-stage protocol); median ms per step of both paths.
 10. switches: the pose head under GFLA_ATTN_PALLAS=1 (serving, one training
     step) and GFLA_PALLAS_CORR=1 (one training step): the kernels each
     setting selects, and agreement with the default path; one bf16 step
     under GFLA_ATTN_PALLAS=1 (2 + 2 bf16 attention-math launches) from
     6b's state against that route's plain bf16 path (losses within 1e-2,
     BF16_STEP_HOLD; 6b's f32 step for the bf16 rule), its peak memory; one
     f32 step at --kernel_size 2=4,3=9 (k=4 and k=9 on the warp kernels'
     run-time instance) against the plain path by phase 6's rule.
 10a. wide kernel sizes: the pose head at --kernel_size 2=11,3=13 (k=11 on
     64x64x128, k=13 on 32x32x256: the warp kernels' wide instances), full
     width, batch 8, from one state: one f32 step (2 launches of each wide
     kernel, nothing else) against the plain path by phase 6's rule; four
     served 256x176 requests (2 wide forward launches each), the first
     against the plain path; under GFLA_ATTN_PALLAS=1 a request and a step
     through the attention-math kernels at k=11 and 13 against the warp
     route; one bf16 step (2 launches of each wide bf16 kernel) against
     the plain bf16 path by phase 6b's hold.
 10b. data parallel (gfla_tpu_torch.parallel) on phase 6's full-width
     pose task: a world of one under NCCL, from torchrun's variables: the
     kernel-path step timed without a group and with one, then one untimed
     step in which allreduce_grads hands back every gradient bitwise, its
     own ms on G's and D's gradients; two plain-path steps under deterministic algorithms with
     the group and two without, bitwise equal (every loss, parameter, u and
     Adam moment); the training CLI's main with --distributed in a world of
     one, two steps counted as path ddp_train; where the machine has two
     cards, two spawned ranks' batch-8 SGD step held to one card's by
     gfla_tpu's 8-vs-1 device rule and timed (else a line says it did not
     run).
 10c. the data x spatial mode (--spatial) on phase 6's task: on every
     machine the warp route's band form (ops/local_attn._warp_window: the
     forward and both backward kernels on the band's halo window), run as
     each band of an S=2 and an S=4 split of the two pose sites runs it
     (a flow row planted past the halo), and of ShapeNet's k=3 site,
     against its plain twin, and the bands against the halo-gather
     reference on the whole map, and of the animation heads' two sites at
     a frame's batch of 2; the window kernels timed beside the whole
     map's; the window kernels' bf16 instances at both pose sites and both
     animation sites in 2 and 4 bands against the bf16 plain twins by the
     bf16 rule and the whole map's bf16 kernel; where the machine has two
     cards (four: dp 2 x sp 2
     at batch 8, else dp 1 x sp 2 at batch 2), spawned ranks on bands of
     phase 6's batch: a kernel-path step against the plain path's by phase
     6's rule, and against the same step under --remat (u bitwise equal,
     as many collectives on each rank), an SGD step against one card's by
     gfla_tpu's spatial rule with every rank's state bitwise equal, its
     launches counted as path spatial_train (on one card no such count is
     printed), the step's ms, peak memory a card and the halo exchange's
     ms beside one card's; from one state each, a shapenet and a
     shapenetflow (GFLA_PALLAS_CORR=1) SGD step against one card's by
     gfla_tpu's spatial rule and a bf16 pose step against one card's bf16
     step by BF16_STEP_HOLD, every rank's state bitwise equal (paths
     spatial_train_remat, spatial_train_shapenet, spatial_train_corr,
     spatial_train_bf16). After phase 18 (`phase_spatial_anim`), from its
     dance and face states, the ranks' full-width chunk steps (batch 2 x 6
     frames at 256x256): dance and face in f32 and dance with --use_mask
     under GFLA_PALLAS_CORR=1 against one card's by gfla_tpu's spatial
     rule, dance in bf16 against one card's bf16 step by phase 20b's hold
     (its planted faults still failing it), face with --remat against the
     ranks' own face step (as many collectives on every rank), and a
     keypoint step, its batch replicated over the group, bitwise one
     card's; every rank's state bitwise equal, the f32 steps' ms and peak
     a card beside one card's (paths spatial_train_dance,
     spatial_train_face, spatial_train_dance_mask_corr,
     spatial_train_dance_bf16, spatial_train_face_remat,
     spatial_train_keypoint).
 11. disk data: a DeepFashion-layout tree (16 images of 256x176 a phase, 24
     train and 8 test pairs) and a Market-layout one (128x64) written
     through nvJPEG (image_io.encode_jpeg) and decoded back (PSNR >= 35 dB
     each; the same decode queued behind a busy stream bitwise equal;
     nvJPEG's pixels against PIL's on a committed fixture); three
     full-width batch-8 pose steps from each through the training CLI's
     entry point with --eval_iters_freq=2 --display_freq=2 (and
     --profile_iters=1 for fashion): train.py's held-out batch, never in a
     training batch, evaluated (finite SSIM, PSNR, L1), the logs, PNGs
     and trace written, the launches counted; the serving CLI writes the
     test pairs' _vis.jpg through nvJPEG and one decodes back; market
     serving on the kernels against the plain warp; each prepared image
     against its source picture; decode and prepare_batch ms per batch
     beside the step time.
 12. shapenet serve: the full-width ShapeNet generator (the task's defaults:
     ngf 64, img_f 512, layers 3, one attention level, k=3 at 64x64x128;
     the flow net fusing the 21-channel viewpoint code at its bottleneck)
     serves four batch-8 requests of uint8 256x256 images and raw labels in
     the HDF5 dataset's layout through the task's prepare_batch and
     test_step: 1 warp-forward launch a request and nothing else, shape and
     range, the plain-warp path, a layers-1 generator on the card against
     the CPU at 2x64x64; ms per forward of both paths.
 13. shapenet sweep: ShapeNetTask.run_test over two batch-8 test batches
     (P2 (8, 18, 256, 256, 3), BP2 (8, 18, 2), the paths): 288 _vis.jpg
     through nvJPEG, named as gfla_tpu names them, 1 launch a view.
 14. shapenet train: four full-width batch-8 D-then-G steps (as 6, with 1
     launch of each warp kernel a step); the kernel path against the plain
     path from one state, a layers-1 generator's step on the card against
     the CPU's at 2x64x64, both against a float64 step.
 14b. shapenet disk: the committed HDF5 store (tests/fixtures/shapenet_car)
     read through ShapeNetDataset and the port's own reader (no h5py),
     every view held to digests.json; four full-width batch-8 steps from
     phase 14's state on batches from the store through the training
     loader with 2 workers (path shapenet_disk_train, 1 launch of each warp
     kernel a step); one batch of the 18-view test sweep from the store
     (36 _vis.jpg, path shapenet_disk_sweep); the loader's ms a batch and
     the step's ms beside phase 14's.
 15. shapenetflow: four full-width stage-1 steps with GFLA_PALLAS_CORR=1, 1
     max-correlation launch a step; the shapenet task's --continue_train
     then loads every flow_net tensor of that directory.
 16. shapenet bf16: the same weights and requests under
     --compute_dtype=bfloat16 (1 bf16 warp launch a request; the image by
     the bf16 rule), one step (1 launch of each bf16 warp kernel) against
     the plain bf16 path by BF16_STEP_HOLD; ms beside f32.
 17. dance serve, face serve: the full-width animation generator (ngf 64,
     img_f 512, layers 3; per frame 4 ExtractorAttn sites: the previous and
     the reference stream at k=5 on 64x64x128 and k=3 on 32x32x256) through
     the serving CLI's run_test: two consecutive 6-frame chunks of a batch-1
     clip of the synthetic video dataset, the last frame and skeleton
     carried: 24 warp-forward launches a chunk and nothing else, 12 _vis
     and 12 _gt PNGs under gfla_tpu's names; the 12 frames on the kernels
     against the plain path; the same generator on a 64x64 clip on the card
     against the CPU; ms per batch-2 chunk forward of both paths.
 18. dance train, face train: four full-width chunk steps (batch 2 x 6
     frames at 256x256: G over the chunk, D and D_V, the folded losses) as
     in 6, with 24 launches of each warp kernel a step; every parameter of
     G, D and D_V moved; save/resume; one step on the kernel path against
     the plain path from one state (losses within TRAIN_LOSS_REL, each
     network's gradient within ANIM_GRAD_REL in relative L2); ms per step,
     peak memory.
 19. dance switches: one dance step under GFLA_ATTN_PALLAS=1 (24 launches
     of each attention-math kernel) and one under GFLA_PALLAS_CORR=1 (4
     max-correlation launches beside the warp's 24 + 24 + 24), each against
     the default path.
 20. dance disk, face disk: a dance tree (iPER layout, 3 sequences x 14
     frames a phase, 256x256) and a face tree (FaceForensics layout, 240x320
     frames) written through nvJPEG, the skeleton JSONs and landmark files
     from numpy; three full-width batch-2 x 6-frame dance steps through the
     training CLI's entry point (24 launches of each warp kernel a step,
     every parameter of G, D and D_V moved); the serving CLI's run_test over
     each head's test sequences (24 forward launches a chunk, gfla_tpu's
     file names, the carry reset at each sequence's first chunk, the
     stitch's line for each sequence: dance's mp4 where cv2 imports, face's
     with cv2 hidden, the line that says no mp4 was written); each prepared
     frame against its source picture; the face structure, Canny included,
     on the card bitwise equal to the CPU's on the same nvJPEG pixels; on
     the committed
     fixture tests/fixtures/face_q75_240x320, the share of Canny pixels
     nvJPEG's and PIL's decodes disagree on (at most 2% of those either
     marks); host sample ms, device prepare_batch ms a chunk, and the dance
     step from disk beside phase 18's.
 20b. animation bf16 and masks: per head (dance, face) at full width under
     --compute_dtype=bfloat16: four bf16 chunk steps as in 18 (24 launches
     of each bf16 warp kernel a step, D's u computed in bf16 and stored in
     f32, save/resume); the task's serving of a chunk in f32 whatever the
     flag says, as gfla_tpu's (24 f32 warp-forward launches); one step on
     the kernel path against the plain bf16 path from one state and both
     against the f32 step (ANIM_BF16_STEP_HOLD, BF16_L2; the flow nets'
     mask-head biases held as one-element gradients, ANIM_LOOSE), and a fault
     planted in one warp-fed G gradient (scaled by 1.5, then zeroed) failing
     that hold; an f32 and a bf16 step's wall, device-busy ms and idle
     share, peak memory beside 18's. Then
     dance's bf16 step under GFLA_ATTN_PALLAS=1 (24 + 24 bf16
     attention-math launches, against that route's plain twins) and under
     GFLA_PALLAS_CORR=1 (4 max-correlation launches), each against the
     default bf16 step; --remat in bf16 (each frame recomputed in bf16, 48
     bf16 warp-forward launches) against the step without it; and
     --use_mask: a dance tree with iPER masks (grey and RGB PNGs), mask_all
     prepared on the card bitwise the CPU's, one masked full-width step in
     f32 and one in bf16 from it.
 21. keypoint: the Motion Extraction Net at its one width (17 joints, 256
     channels, 4 dilated layers, receptive field 81) on a synthetic
     Human3.6M NPZ pair (scripts/make_synth_h36m_keypoints.py): four
     batch-8 steps through the training CLI's entry point with
     --eval_iters_freq=2 (finite losses, every parameter moved, kp_mse and
     kp_mse_identity in eval_log.txt); save/resume; one step on the card
     against the CPU from one state under the same dropout masks (loss
     within TRAIN_LOSS_REL, each gradient within 1e-4 in relative L2); the
     eval forward on the card against the CPU (1e-4 x max |out|); the
     serving CLI with --write_image over an AlphaPose tree of OpenPose-18
     JSONs (a denoised JSON of 17 joints and a skeleton PNG a frame, under
     gfla_tpu's names; a frame with no person); the denoised JSONs as a
     dance test tree's clean skeletons, read by DanceDataset, and one
     6-frame chunk of them served by the full-width dance generator (24
     warp-forward launches, finite frames). The keypoint head's own path
     launches no hand kernel: its convolutions are cuDNN's, as gfla_tpu's
     are XLA's. ms per batch-8 step, per sequence forward, host ms per
     sample, peak memory.
 22. metrics: with jax, flax, pandas, imageio and PIL unimportable, the
     metrics CLI's main on 64 generated/GT JPEG pairs at DeepFashion's
     256x176 written through nvJPEG (gfla_tpu's columns, finite values,
     metrics.npz and statistics.npz written; a second run reads the
     statistics back and gives the same FID); the card against the CPU
     with the same fallback weights on the same nvJPEG pixels: Inception
     pool3 features within FEATURE_REL x max, FID within FID_REL, LPIPS
     plain and masked (Market-style body masks of seeded skeletons) within
     LPIPS_REL of each pair, the CLI's reconstruction columns equal to
     numpy's on those pixels; 12 animation-size 256x256 PNG pairs: the
     features, LPIPS and the reconstruction columns card against CPU; ms
     per Inception batch of 64 at 299x299 and per LPIPS batch of 32 pairs,
     the CLI's seconds and their parts (decode, resize, sqrtm,
     reconstruction). No hand kernel is on the metrics' path: the networks
     are cuDNN's, as gfla_tpu's are XLA's.
 23. walkthrough: `python -m gfla_tpu_torch.demo --walkthrough` in a
     process of its own (the card line, the build, the assets, a 20-step
     64x64 pose training and its val panels in processes of their own,
     the metrics CLI on them); its CSV holds finite values; each cell's
     seconds.
The card's Python has no h5py: phase 14b reads the HDF5 store through the
port's own reader (gfla_tpu_torch/data/hdf5.py), which the CPU tests hold
to h5py (tests/test_torch_port_hdf5.py); the other ShapeNet phases feed
batches in the dataset's layout made in memory.
The switches are set per phase with mock.patch.dict, so none leaks into the
next; every other phase runs with GFLA_ATTN_PALLAS=auto, GFLA_PALLAS_CORR=0.
Each phase's wall time follows it on a line of its own. A timing takes 20
launches after 3 warm-up ones, or fewer (at least 5) once they add up to
300 ms.
All six f32 kernels multiply on the tensor cores as split-f32 products
(three TF32 products per f32 product): their bound is taken at 495 / 3
TFLOP/s, with the FP32 cores' 67 TFLOP/s bound beside it. The five bf16
instances (the warp's three, the attention math's two) multiply bf16
operands: their bound is taken at the dense bf16 rate, 989 TFLOP/s.
Extra arguments go to the test options, e.g. `--checkpoints_dir DIR --name N
--which_iter latest` to serve an original-GFLA `latest_net_G.pth` instead of
the seeded random init. The last line is the JSON device record.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import re
import statistics
import sys
import tempfile
import time
import types
from unittest import mock

import numpy as np
import torch

KERNEL_ATOL = 1e-4  # f32, TF32 off: the summation order differs, and the
                    # split-f32 products drop ~2^-22 of each term
SLICE_ATOL = 1e-3   # the same, carried through ~20 conv/norm layers
CPU_ATOL = 1e-3     # card vs CPU on a small input: cuDNN vs CPU convs
FLOW_FAR = 2.5      # far-off flows reach +-2.5 H
BWD_REL = 1e-4      # backward: each output within 1e-4 x its max |value|
                    # (f32; summation order and atomicAdd order differ)
TRAIN_STEPS = 4
TRAIN_LOSS_REL = 1e-3  # two steps from one state: each loss, relative
GRAD_F64_REL = 5e-2  # each f32 gradient vs the f64 one, x its tensor's
                     # max: a check for gross faults; the flow net's
                     # gradients are small sums of larger terms, 1.6e-2 off
                     # in f32 at 64x64 on the CPU (2x2 bottleneck)
FLOW_GRAD_F64_REL = 1e-1  # the same for the stage-1 flow net alone: its
                     # deepest encoder weights get gradients of ~1e-6 that
                     # f32 sums 6.9e-2 off the f64 ones on both paths alike
FLOW_PAIR_REL = BWD_REL  # ... so its kernel path is also held to its scan
                     # path, each gradient within this x the tensor's max,
                     # both steps under deterministic algorithms (each path
                     # then repeats bitwise) and the scan given the kernel's
                     # argmax. The paths differ in cmax's last bits (the
                     # kernel's split-f32 products 4.0e-7 off the float64
                     # maximum, cuBLAS's 7.0e-7), which the loss's
                     # subtraction of exp(-1) magnifies to 7.6e-5 of the
                     # loss and the flow net's small gradients to 1.0e-5 of
                     # a tensor's max; without determinism the atomics of
                     # the backward alone part two runs of one path by
                     # 0.8-1.3e-5 (H100, chip runs of the phase alone)
MASK_REL = 1e-3     # the parameters held tight: |grad| > 1e-3 x tensor max
PARAM_ATOL = 1e-6   # how tight
ADAM_FLOOR = 1e-6   # ... and |grad| > 100 x Adam's eps
RESOLVED = 10.0     # ... and |grad| > 10 x the tensor's f32 rounding
CKPT_REL = 1e-5     # the step after a save/resume vs the uninterrupted one
CORR_ATOL = 1e-5    # max-correlation: cmax, and argmax where the top-two
                    # gap of the plain correlation exceeds it
F32_PEAK = 67e12    # H100 SXM: f32 FLOP/s outside the tensor cores
TF32_PEAK = 495e12  # H100 SXM: dense TF32 FLOP/s of the tensor cores
TF32X3_PEAK = TF32_PEAK / 3  # f32 work as split-f32 products: three TF32
                    # products per f32 product (csrc/mma_tf32x3.cuh)
HBM_RATE = 3.35e12  # H100 SXM: device memory bytes/s
BF16_PEAK = 989e12  # H100 SXM: dense bf16 FLOP/s of the tensor cores
TIMING_MS = 300.0   # a timing's launches stop here once there are 5
# bf16: each bf16 kernel against its bf16 plain twin on the same inputs, and
# both against the f32 result of the same values (the plain twin in f32):
# the kernel's error there at most 2x the twin's + BF16_SLACK x max|f32|,
# and kernel vs twin within a tolerance x max|f32|: BF16_OUT_REL for the
# output, hpre and d_source (one bf16 ulp is 3.9e-3 of the largest value;
# the kernel and the twin sum in other orders, so a rounding may land one
# ulp apart), BF16_GRAD_REL for the other gradients, whose sums cancel
BF16_SLACK = 1e-3
BF16_OUT_REL = 1e-2
BF16_GRAD_REL = 3e-2
SERVE_BF16_REL = 5e-2  # the served image, kernel vs plain bf16 path: the
                       # kernels' one-ulp differences carried through the
                       # decoder's bf16 convs and norms (read: 1.96e-2)
BF16_LOSS_REL = 1e-2   # bf16 step, kernel vs plain path: each loss
# bf16 step, kernel vs plain path, each network's gradients tensor by
# tensor: cosine floor, the whole network's cosine floor, norm ratio band.
# A max error cannot hold them: the warp kernels' one-ulp differences
# carried through the rest of the step leave a G tensor up to 38% of its
# max apart on the two paths. Read at the seeded init: G's 172 tensors at
# cosine 0.9587 (attention's W1) and up, median 0.99977, norm ratios
# 0.901-1.039, the whole network 0.999999; D's 26 at 1.00000 (its fake
# images are ~1e-3). G's tensor floor and band stand 2.4x further from 1
# than its readings; the others, read at 1 within 1e-6, at 1e-5 to 1e-3.
BF16_STEP_HOLD = {"G": (0.9, 0.99999, (0.75, 1.33)),
                  "D": (0.9999, 0.99999, (0.999, 1.001)),
                  "D_V": (0.9999, 0.99999, (0.999, 1.001))}
# The animation heads' bf16 chunk step, kernel vs plain path: G's 1-ulp
# differences at the warp compound through six frames, each generated from
# the last, so G's tensors part further than the pose step's. Read on an
# H100 in two runs, where bf16 resolves the gradient: per-tensor cosine
# 0.822 and 0.825 and up (dance), medians 0.993 (dance) and 0.965-0.966
# (face); norm ratios dance 0.695-1.357, face 0.683-1.363, dance under
# GFLA_ATTN_PALLAS=1 0.571 and 0.576 to 1.175, --remat 0.984-1.011; the
# whole network 0.999955-0.999999. D and D_V read 1.000000 as pose's D.
# The floor stands 1.4x further from 1 than the lowest cosine, the band's
# top 2x further than the highest ratio; its foot stays at 0.5, 1.2x
# further than the attention route's lowest ratio, for the ratio a tensor
# bf16 does not resolve takes is not a fault's sign: the band does not
# catch a warp-fed gradient scaled by 1.5 (BF16_L2 does). A one-element
# gradient (each flow net's mask-head biases, a sum over 12 frames x 4096
# positions) is held in the network's cosine and mean only: both bf16
# paths land at 0.24-2.7x of the f32 value, each the nearer in turn.
ANIM_BF16_STEP_HOLD = {"G": (0.75, 0.9999, (0.5, 1.75)),
                       "D": BF16_STEP_HOLD["D"], "D_V": BF16_STEP_HOLD["D_V"]}
# ... and by L2 against the f32 step: a tensor the plain bf16 path resolves
# (its L2 distance to the f32 gradient at most BF16_L2[0] x the f32
# gradient's norm) has the kernel path's distance there at most 2x the
# plain path's + BF16_L2[1] x that norm. Two bf16 computations of a
# gradient land about as far from f32 in L2, a statistic over the whole
# tensor; a scale of 1.5 puts one 0.5 x its norm off.
BF16_L2 = (0.25, 0.05)
# The flow nets' mask-head biases (one value a stream: dance's one-element
# ones above, face's two) are each a sum over 12 frames x 4096 positions
# that cancels to ~3e-6, and both bf16 paths land a few % off it, each the
# nearer in turn: in 20 draws of each path from one state on one H100
# (scripts/chip_bf16_l2_draws.py) face's mask2 bias sat 1.8-2.7% of its
# norm from f32 on the kernel path and 8.0-9.8% on the plain path; in the
# run where BF16_L2 failed, 7.2% and 1.0%. They are held as the
# one-element gradients are, in the network's cosine and mean only. Every
# other tensor read BF16_L2 at -1.1e-3 or below in every draw of face and
# dance (12 of dance), among them the 2- and 4-value flow-head biases that
# planted_faults picks.
ANIM_LOOSE = re.compile(r"flow_net\w*\.mask\d+\.0\.bias$")
# The ShapeNet step's generator has gradients that bf16 rounding dominates:
# the target net grows from the viewpoint code tiled to 8x8, and the biases
# of its first two blocks (and of the flow net's deepest encoder) get
# gradients that sum to nearly 0 over the image. Read on an H100: kernel
# and plain bf16 paths at cosine 0.34-0.75 on those five tensors, every
# other G tensor above the floor of 0.9; the plain path's own at 0.31-0.85
# with the f32 step's on the five. A
# tensor outside BF16_STEP_HOLD whose plain bf16 gradient is itself at a
# cosine below BF16_RESOLVED with the f32 step's is held by the bf16 rule
# against f32 instead (grads_by_rule).
BF16_RESOLVED = 0.9

KERNEL_CASES = [  # name, B, H, W, C, D, k, flow scale (None: far-off)
    ("k=5 site 64x64 C128", 8, 64, 64, 128, 128, 5, 1.5),
    ("k=3 site 32x32 C256", 8, 32, 32, 256, 128, 3, 1.5),
    ("k=5 far-off flows", 8, 64, 64, 128, 128, 5, None),
    ("k=5 site at 64x64 input", 2, 16, 16, 128, 128, 5, 1.5),
    ("k=3 site at 64x64 input", 2, 8, 8, 256, 128, 3, 1.5),
    ("ragged k=3 12x10 C21 D42", 2, 12, 10, 21, 42, 3, 1.5),
    ("ragged k=7 16x12 C22 D40", 2, 16, 12, 22, 40, 7, 1.5),
    ("market k=5 site 32x16 C128", 8, 32, 16, 128, 128, 5, 1.5),
    ("market k=3 site 16x8 C256", 8, 16, 8, 256, 128, 3, 1.5),
    ("shapenet k=3 site 64x64 C128", 8, 64, 64, 128, 128, 3, 1.5),
    ("animation k=5 site 64x64 C128 B2", 2, 64, 64, 128, 128, 5, 1.5),
    ("animation k=3 site 32x32 C256 B2", 2, 32, 32, 256, 128, 3, 1.5),
    # --kernel_size at the pose k=5 site: the kernels' run-time instance
    ("kernel size k=2 at the k=5 site", 8, 64, 64, 128, 128, 2, 1.5),
    ("kernel size k=4 at the k=5 site", 8, 64, 64, 128, 128, 4, 1.5),
    ("kernel size k=6 at the k=5 site", 8, 64, 64, 128, 128, 6, 1.5),
    ("kernel size k=8 at the k=5 site", 8, 64, 64, 128, 128, 8, 1.5),
    ("kernel size k=9 at the k=5 site", 8, 64, 64, 128, 128, 9, 1.5),
    # past 9: the kernels' wide instances, at k up to gfla_tpu's bounds at
    # each site (its Pallas warp takes k <= 14 at 64x64x128, k <= 16 at
    # 32x32x256, k <= 39 at 32x16x128)
    ("wide k=10 at the k=5 site", 8, 64, 64, 128, 128, 10, 1.5),
    ("wide k=11 at the k=5 site", 8, 64, 64, 128, 128, 11, 1.5),
    ("wide k=13 at the k=5 site", 8, 64, 64, 128, 128, 13, 1.5),
    ("wide k=14 at the k=5 site", 8, 64, 64, 128, 128, 14, 1.5),
    ("wide k=13 at the k=3 site", 8, 32, 32, 256, 128, 13, 1.5),
    ("wide k=16 at the k=3 site", 8, 32, 32, 256, 128, 16, 1.5),
    ("wide k=17 at market's k=5 site", 8, 32, 16, 128, 128, 17, 1.5),
    ("wide k=11 ragged 16x12 C22 D40", 2, 16, 12, 22, 40, 11, 1.5),
]
WIDE_K = 10  # the kernels' wide instances take k from here up


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {msg}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of `fn()` by CUDA events, after warm-up: `iters`
    launches, or fewer (never under 5) once they add up to TIMING_MS."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
        if len(times) >= 5 and sum(times) >= TIMING_MS:
            break
    return statistics.median(times)


def timed(phase, *args):
    """`phase(*args)`, and a line with its wall time."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"{phase.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def phase_card():
    from gfla_tpu_torch.runtime import card_line

    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")


def phase_build():
    """The kernel library and the nvJPEG library, every nvcc at once."""
    from gfla_tpu_torch.ops._build import (build, load_jpeg_library,
                                           load_library)

    t0 = time.perf_counter()
    build(verbose=True)
    load_library()
    load_jpeg_library()
    print(f"build: {time.perf_counter() - t0:.2f} s")


def warp_inputs(B, H, W, C, D, k, flow_scale, seed, device):
    from gfla_tpu_torch.ops.local_attn import target_stream

    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    src, tgt = t(rng.randn(B, H, W, C)), t(rng.randn(B, H, W, C))
    if flow_scale is None:  # far-off: uniform in +-FLOW_FAR * H
        flow = t(rng.uniform(-FLOW_FAR * H, FLOW_FAR * H, (B, H, W, 2)))
    else:
        flow = t(rng.randn(B, H, W, 2) * flow_scale)
    w1 = t(rng.randn(k * k, 2 * C, D) * 0.05)
    b1, w2 = t(rng.randn(D) * 0.1), t(rng.randn(D, k * k) * 0.1)
    b2 = t(rng.randn(k * k) * 0.1)
    hidden_bt = target_stream(tgt, w1, b1, k)
    w1s = w1[:, C:, :].reshape(k * k * C, D).contiguous()
    return src, flow, hidden_bt, w1s, w2, b2


def expect_refusals(what, refusals):
    """Each call must raise its exception before any launch."""
    for name, (exc, call) in refusals.items():
        try:
            call()
        except exc:
            continue
        raise RuntimeError(f"FAILED: {what} accepted {name}")
    print(f"{what} refuses: {', '.join(refusals)}")


def phase_kernel(device):
    from gfla_tpu_torch.ops import warp

    results = {}
    for i, (name, B, H, W, C, D, k, scale) in enumerate(KERNEL_CASES):
        args = warp_inputs(B, H, W, C, D, k, scale, i, device)
        got = warp.warp_fwd(*args, k)
        want = warp.warp_fwd_plain(*args, k)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        got_h, hpre = warp.warp_fwd_with_hpre(*args, k)
        want_hpre = warp.warp_fwd_plain(*args, k, with_hpre=True)[1]
        torch.cuda.synchronize()
        err_h = (hpre - want_hpre).abs().max().item()
        tol_h = BWD_REL * want_hpre.abs().max().item()
        ms = cuda_ms(lambda: warp.warp_fwd(*args, k))
        ms_hpre = cuda_ms(lambda: warp.warp_fwd_with_hpre(*args, k))
        plain_ms = cuda_ms(lambda: warp.warp_fwd_plain(*args, k))
        work = warp_work(B, H, W, C, D, k)["warp_fwd"]
        print(f"kernel {name}: B={B} max_abs_err={err:.3e} "
              f"max_rel_err={rel:.3e} (tol {KERNEL_ATOL:g} abs) "
              f"kernel {ms:.4f} ms, storing hpre {ms_hpre:.4f} ms (hpre "
              f"max_abs_err={err_h:.3e}, tol {tol_h:.3e} = {BWD_REL:g} x "
              f"max|value|) plain {plain_ms:.4f} ms bound "
              f"{bound(*work, TF32X3_PEAK)[0]:.4f} ms (tensor cores as 3 "
              f"TF32 products; {bound(*work)[0]:.4f} ms on the FP32 cores)")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        check(err <= KERNEL_ATOL, f"{name}: kernel vs plain {err:.3e}")
        check(torch.equal(got_h, got), f"{name}: the output moved when "
              f"hpre is stored")
        check(err_h <= tol_h, f"{name}: hpre vs plain {err_h:.3e}")
        results[name] = (err, ms, plain_ms)

    # what the wrapper refuses on a CUDA tensor, before any launch
    args = warp_inputs(1, 8, 8, 16, 32, 3, 1.0, 9, device)
    refusals = {
        "k = 0": (ValueError, lambda: warp.warp_fwd(*args, 0)),
        "D > 256": (ValueError, lambda: warp.warp_fwd(
            *warp_inputs(1, 8, 8, 16, 320, 3, 1.0, 9, device), 3)),
        "non-contiguous": (ValueError, lambda: warp.warp_fwd(
            args[0].transpose(1, 2), *args[1:], 3)),
        "float16": (TypeError, lambda: warp.warp_fwd(
            args[0].detach().half(), *args[1:], 3)),
        "a bfloat16 source with float32 weights": (TypeError,
            lambda: warp.warp_fwd(args[0].detach().bfloat16(), *args[1:],
                                  3)),
    }
    expect_refusals("warp_fwd", refusals)

    # an input that requires grad goes through WarpFunction: forward kernel,
    # then both backward kernels
    src = args[0].clone().requires_grad_()
    counts = (warp.launches, warp.bwd_pos_launches, warp.bwd_w1_launches)
    warp.warp_fwd(src, *args[1:], 3).square().sum().backward()
    torch.cuda.synchronize()
    after = (warp.launches, warp.bwd_pos_launches, warp.bwd_w1_launches)
    check([b - a for a, b in zip(counts, after)] == [1, 1, 1],
          f"requires_grad launches {counts} -> {after}")
    check(src.grad is not None and bool(torch.isfinite(src.grad).all()),
          "requires_grad: no finite gradient")
    print("a requires_grad input launched the forward and both backward "
          "kernels")
    return results


BWD_OUTPUTS = ("d_source", "d_flow", "d_hidden_bt", "dW1s", "dW2", "db2")


def phase_bwd_kernel(device):
    """Both backward kernels, the per-position one from the forward
    kernel's hpre, against warp_bwd_pos_plain/warp_bwd_w1_plain given that
    hpre, at the two live sites, with far-off flows and at ragged shapes:
    each of the six outputs within BWD_REL x its max |value|; d_flow,
    dW1s, dW2 and db2 bitwise equal over two launches (d_source is added up
    by vector reductions in no fixed order)."""
    from gfla_tpu_torch.ops import warp

    results = {}
    for i, (name, B, H, W, C, D, k, scale) in enumerate(KERNEL_CASES):
        args = warp_inputs(B, H, W, C, D, k, scale, 20 + i, device)
        src, flow, _, w1s, w2, b2 = args
        g = torch.from_numpy(np.random.RandomState(30 + i).randn(
            B, H, W, C).astype(np.float32)).to(device)
        hpre = warp.warp_fwd_with_hpre(*args, k)[1]
        got = warp.warp_bwd(src, flow, hpre, w1s, w2, b2, g, k)
        again = warp.warp_bwd(src, flow, hpre, w1s, w2, b2, g, k)
        want = warp.warp_bwd_plain(*args, g, k, hpre=hpre)
        torch.cuda.synchronize()
        errs = []
        for out, a, b in zip(BWD_OUTPUTS, got, want):
            err = (a - b).abs().max().item()
            bound = BWD_REL * b.abs().max().item()
            check(bool(torch.isfinite(a).all()), f"{name}: {out} non-finite")
            check(err <= bound, f"{name}: {out} kernel vs plain {err:.3e} > "
                  f"{bound:.3e}")
            errs.append(err)
        fixed = [out for out, a, b in zip(BWD_OUTPUTS, got, again)
                 if out != "d_source"]
        moved = [out for out, a, b in zip(BWD_OUTPUTS, got, again)
                 if out != "d_source" and not torch.equal(a, b)]
        check(not moved, f"{name}: {moved} differ between two launches")
        d_hpre = want[2]
        pos_ms = cuda_ms(lambda: warp.warp_bwd_pos(
            src, flow, hpre, w1s, w2, b2, g, k), iters=10)
        pos_plain = cuda_ms(lambda: warp.warp_bwd_pos_plain(
            *args, g, k, hpre=hpre), iters=10)
        w1_ms = cuda_ms(lambda: warp.warp_bwd_w1(src, flow, d_hpre, k),
                        iters=10)
        w1_plain = cuda_ms(lambda: warp.warp_bwd_w1_plain(
            src, flow, d_hpre, k), iters=10)
        work = warp_work(B, H, W, C, D, k)
        print(f"backward {name}: max_abs_err "
              + " ".join(f"{o}={e:.3e}" for o, e in zip(BWD_OUTPUTS, errs))
              + f" (tol {BWD_REL:g} x max|value|); {', '.join(fixed)} "
              f"bitwise equal over two launches; per-position kernel "
              f"{pos_ms:.4f} ms plain {pos_plain:.4f} ms bound "
              f"{bound_pair(work['warp_bwd_pos'])}; dW1s kernel "
              f"{w1_ms:.4f} ms plain {w1_plain:.4f} ms bound "
              f"{bound_pair(work['warp_bwd_w1'])}")
        results[name] = dict(pos=(max(errs[:3] + errs[4:]), pos_ms, pos_plain),
                             w1=(errs[3], w1_ms, w1_plain))

    args = warp_inputs(1, 8, 8, 16, 32, 3, 1.0, 9, device)
    src, flow, hidden_bt, w1s, w2, b2 = args
    hpre = hidden_bt.reshape(64, 32)
    g = torch.zeros(1, 8, 8, 16, device=device)
    refusals = {
        "g of the wrong shape": (ValueError, lambda: warp.warp_bwd(
            src, flow, hpre, w1s, w2, b2, g[:, :4], 3)),
        "non-contiguous g": (ValueError, lambda: warp.warp_bwd(
            src, flow, hpre, w1s, w2, b2, g.transpose(1, 2), 3)),
        "hpre of the wrong shape": (ValueError, lambda: warp.warp_bwd(
            src, flow, hidden_bt, w1s, w2, b2, g, 3)),
        "float64 d_hpre": (ValueError, lambda: warp.warp_bwd_w1(
            src, flow, hidden_bt.double(), 3)),
        "float16": (TypeError, lambda: warp.warp_bwd(
            src.half(), flow, hpre, w1s.half(), w2.half(), b2, g.half(), 3)),
    }
    expect_refusals("warp_bwd", refusals)
    return results


def bound(flops, nbytes, peak=F32_PEAK):
    """(bound_ms, bound_by): the least time one H100 SXM could take for work
    of `flops` f32 operations that moves `nbytes` bytes, on the unit whose
    rate for that work is `peak`: the FP32 cores, or for the two kernels
    that multiply on the tensor cores, TF32X3_PEAK."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_pair(work):
    """A kernel's bound on the tensor cores as split-f32 products, with
    the FP32 cores' beside it, as text."""
    ms, by = bound(*work, TF32X3_PEAK)
    return (f"{ms:.4f} ms ({by}, tensor cores as 3 TF32 products; "
            f"{bound(*work)[0]:.4f} ms on the FP32 cores)")


def warp_work(B, H, W, C, D, k):
    """(FLOPs, bytes) of each warp kernel at one site. A multiply-add is 2
    FLOPs; the dense products dominate, plus the logits, the weighted sum
    and the bilinear blend (7 per block value); each input is read once and
    each output written once, as 4-byte floats. The per-position backward
    starts from the forward's hpre (an input of hidden_bt's size), so it
    has one dense product, d_block = d_hpre W1s^T; a backward that
    recomputes hpre, as gfla_tpu's does, has a second."""
    N, k2 = B * H * W, k * k
    dense = 2 * N * k2 * C * D
    small = 2 * N * (D * k2 + k2 * C) + 7 * N * k2 * C
    ins = N * C + 2 * N + N * D + k2 * C * D + D * k2 + k2
    return {
        "warp_fwd": (dense + small, 4 * (ins + N * C)),
        "warp_bwd_pos": (dense + 2 * small + 4 * N * D * k2,
                         4 * (ins + N * C + N * C + 2 * N + N * D + D * k2
                              + k2)),
        "warp_bwd_w1": (dense + 7 * N * k2 * C,
                        4 * (N * C + 2 * N + N * D + k2 * C * D)),
    }


def warp_work_bf16(B, H, W, C, D, k):
    """(FLOPs, bytes) of each bf16 warp kernel at one site: warp_work's
    operations, and bytes with the source, g, the output, W1s and W2 in bf16
    and the flow, hidden_bt, hpre, d_hpre, d_source, d_flow and the weight
    gradients in f32."""
    N, k2 = B * H * W, k * k
    ops = {name: w[0] for name, w in warp_work(B, H, W, C, D, k).items()}
    fwd_in = 2 * N * C + 8 * N + 4 * N * D + 2 * k2 * C * D + 2 * D * k2 \
        + 4 * k2
    return {
        "warp_fwd": (ops["warp_fwd"], fwd_in + 2 * N * C),
        "warp_bwd_pos": (ops["warp_bwd_pos"],
                         fwd_in + 2 * N * C + 4 * N * C + 8 * N + 4 * N * D
                         + 4 * D * k2 + 4 * k2),
        "warp_bwd_w1": (ops["warp_bwd_w1"],
                        2 * N * C + 8 * N + 4 * N * D + 4 * k2 * C * D),
    }


def bf16_rule(what, kernel, plain, f32, tol):
    """The bf16 rule (see BF16_SLACK): returns the kernel's max abs error
    against its plain twin and that error x max|f32|^-1."""
    kernel, plain = kernel.float(), plain.float()
    top = max(f32.abs().max().item(), 1e-30)
    e_kernel = (kernel - f32).abs().max().item()
    e_plain = (plain - f32).abs().max().item()
    err = (kernel - plain).abs().max().item()
    check(bool(torch.isfinite(kernel).all()), f"{what}: non-finite")
    check(e_kernel <= 2 * e_plain + BF16_SLACK * top,
          f"{what}: {e_kernel / top:.3e} of max|f32| off the f32 result, "
          f"its plain twin {e_plain / top:.3e}")
    check(err <= tol * top, f"{what}: kernel vs plain {err / top:.3e} > "
          f"{tol:g} x max|f32|")
    return err, err / top


BF16_FWD = ("out", "hpre")


def phase_bf16_kernels(device):
    """The warp's three bf16 kernels (warp_fwd_bf16.cu, warp_bwd_bf16.cu)
    against their bf16 plain twins at every KERNEL_CASES shape, from bf16
    source, W1s, W2 and g: each output by the bf16 rule against the f32
    result of the same values; d_flow, d_hidden_bt, dW1s, dW2 and db2 bitwise
    equal over two launches; median ms of each kernel and twin, and the
    bound at the tensor cores' bf16 rate."""
    from gfla_tpu_torch.ops import warp

    bf = torch.bfloat16
    results = {}
    for i, (name, B, H, W, C, D, k, scale) in enumerate(KERNEL_CASES):
        src, flow, hbt, w1s, w2, b2 = warp_inputs(B, H, W, C, D, k, scale,
                                                  40 + i, device)
        args = (src.to(bf), flow, hbt, w1s.to(bf), w2.to(bf), b2)
        wide = (args[0].float(), flow, hbt, args[3].float(),
                args[4].float(), b2)  # the same values, computed in f32
        g = torch.from_numpy(np.random.RandomState(50 + i).randn(
            B, H, W, C).astype(np.float32)).to(device).to(bf)
        out, hpre = warp.warp_fwd_with_hpre(*args, k)
        plain = warp.warp_fwd_plain(*args, k, with_hpre=True)
        f32 = warp.warp_fwd_plain(*wide, k, with_hpre=True)
        check(out.dtype == bf and hpre.dtype == torch.float32,
              f"{name}: bf16 forward gave {out.dtype}, hpre {hpre.dtype}")
        got = warp.warp_bwd(args[0], flow, hpre, args[3], args[4], b2, g, k)
        again = warp.warp_bwd(args[0], flow, hpre, args[3], args[4], b2, g,
                              k)
        want = warp.warp_bwd_plain(*args, g, k, hpre=hpre)
        f32_bwd = warp.warp_bwd_plain(*wide, g.float(), k, hpre=f32[1])
        torch.cuda.synchronize()
        errs = {}
        for out_name, a, b, f in zip(BF16_FWD + BWD_OUTPUTS,
                                     (out, hpre, *got), (*plain, *want),
                                     (*f32, *f32_bwd)):
            tol = (BF16_OUT_REL if out_name in ("out", "hpre", "d_source")
                   else BF16_GRAD_REL)
            errs[out_name] = bf16_rule(f"bf16 {name} {out_name}", a, b, f,
                                       tol)
        moved = [o for o, a, b in zip(BWD_OUTPUTS, got, again)
                 if o != "d_source" and not torch.equal(a, b)]
        check(not moved, f"bf16 {name}: {moved} differ between two launches")
        d_hpre = got[2]
        ms = {
            "fwd": (cuda_ms(lambda: warp.warp_fwd(*args, k)),
                    cuda_ms(lambda: warp.warp_fwd_plain(*args, k))),
            "pos": (cuda_ms(lambda: warp.warp_bwd_pos(
                args[0], flow, hpre, args[3], args[4], b2, g, k), iters=10),
                    cuda_ms(lambda: warp.warp_bwd_pos_plain(
                        *args, g, k, hpre=hpre), iters=10)),
            "w1": (cuda_ms(lambda: warp.warp_bwd_w1(args[0], flow, d_hpre, k),
                           iters=10),
                   cuda_ms(lambda: warp.warp_bwd_w1_plain(args[0], flow,
                                                          d_hpre, k),
                           iters=10)),
        }
        work = warp_work_bf16(B, H, W, C, D, k)
        bounds = {part: bound(*work[kern], BF16_PEAK) for part, kern in (
            ("fwd", "warp_fwd"), ("pos", "warp_bwd_pos"),
            ("w1", "warp_bwd_w1"))}
        print(f"bf16 kernels {name}: B={B} kernel vs bf16 plain twin, "
              f"x max|f32|: " + " ".join(
                  f"{o}={rel:.3e}" for o, (_, rel) in errs.items())
              + " (tol out, hpre, d_source "
              f"{BF16_OUT_REL:g}, others {BF16_GRAD_REL:g}; each within 2x "
              f"the twin's error against f32 + {BF16_SLACK:g}); "
              + "; ".join(f"{part} kernel {ms[part][0]:.4f} ms plain "
                          f"{ms[part][1]:.4f} ms bound {bounds[part][0]:.4f} "
                          f"ms ({bounds[part][1]}, bf16 989 TFLOP/s)"
                          for part in ms))
        results[name] = {part: (max(errs[o][0] for o in outs), *ms[part])
                         for part, outs in (
                             ("fwd", BF16_FWD),
                             ("pos", ("d_source", "d_flow", "d_hidden_bt",
                                      "dW2", "db2")),
                             ("w1", ("dW1s",)))}
    return results


CORR_CASES = [  # name, B, Ns, Nt, C, exact ties
    ("relu3_1 B=8 4096x4096 C256", 8, 4096, 4096, 256, False),
    ("relu4_1 B=8 1024x1024 C512", 8, 1024, 1024, 512, False),
    ("ragged B=3 Ns=1000 Nt=777 C3", 3, 1000, 777, 3, False),
    ("duplicated and zero rows B=2 4096x4096 C256", 2, 4096, 4096, 256,
     True),
    ("market relu3_1 B=8 512x512 C256", 8, 512, 512, 256, False),
    ("market relu4_1 B=8 128x128 C512", 8, 128, 128, 512, False),
    ("animation relu3_1 B=12 4096x4096 C256", 12, 4096, 4096, 256, False),
    ("animation relu4_1 B=12 1024x1024 C512", 12, 1024, 1024, 512, False),
]


def corr_inputs(B, Ns, Nt, C, ties, seed, device):
    """Unit-norm ReLU features, as the correctness loss feeds the kernel.
    With `ties`, a quarter of the source rows repeat one of 32 rows and
    every 97th is zero; half the target rows copy one of the 32 and every
    7th is zero: equal maxima, as DeepFashion's white side bands give."""
    rng = np.random.RandomState(seed)
    s = np.maximum(rng.randn(B, Ns, C), 0.0)
    t = np.maximum(rng.randn(B, Nt, C), 0.0)
    if ties:
        for b in range(B):
            rows = np.maximum(rng.randn(32, C), 0.0)
            dup = np.flatnonzero(rng.rand(Ns) < 0.25)
            s[b, dup] = rows[rng.randint(0, 32, dup.size)]
            t[b, ::2] = rows[rng.randint(0, 32, t[b, ::2].shape[0])]
        s[:, ::97] = 0.0
        t[:, 1::7] = 0.0

    def unit(x):
        return torch.from_numpy((x / (np.sqrt((x * x).sum(-1, keepdims=True))
                                      + 1e-8)).astype(np.float32)).to(device)

    return unit(s), unit(t)


def corr_work(B, Ns, Nt, C):
    """(FLOPs, bytes): the products and one comparison per pair; reading
    both inputs, writing cmax (4 bytes) and argmax (8 bytes) per target."""
    return (2 * B * Ns * Nt * C + B * Ns * Nt,
            4 * B * (Ns + Nt) * C + 12 * B * Nt)


def phase_corr_kernel(device):
    """The max-correlation kernel against `max_corr_plain`: cmax within
    CORR_ATOL; argmax equal wherever the plain correlation's top two differ
    by more than CORR_ATOL, and everywhere in the tie case; the plain
    correlation at the kernel's argmax within CORR_ATOL of cmax everywhere."""
    from gfla_tpu_torch.ops import max_corr

    results = {}
    for i, (name, B, Ns, Nt, C, ties) in enumerate(CORR_CASES):
        s, t = corr_inputs(B, Ns, Nt, C, ties, 40 + i, device)
        cmax, amax = max_corr.max_corr(s, t)
        want_max, want_idx = max_corr.max_corr_plain(s, t)
        torch.cuda.synchronize()
        check(cmax.dtype == torch.float32 and amax.dtype == torch.int64
              and tuple(amax.shape) == (B, Nt), f"{name}: output types")
        err = (cmax - want_max).abs().max().item()
        check(err <= CORR_ATOL, f"{name}: cmax off by {err:.3e}")
        decided = at_err = err64 = 0
        for b in range(B):
            corr = s[b] @ t[b].T                                  # (Ns, Nt)
            exact = (s[b].double() @ t[b].double().T).max(0).values
            err64 = max(err64, (cmax[b] - exact).abs().max().item())
            top2 = corr.topk(2, dim=0).values
            sure = (top2[0] - top2[1]) > CORR_ATOL
            same = amax[b] == want_idx[b]
            check(bool(same[sure].all()), f"{name}: argmax differs where "
                  f"the top two are more than {CORR_ATOL:g} apart")
            if ties:
                check(bool(same.all()), f"{name}: argmax differs at a tie")
            decided += int(sure.sum())
            at = corr.gather(0, amax[b][None]).squeeze(0)
            at_err = max(at_err, (at - cmax[b]).abs().max().item())
        check(at_err <= CORR_ATOL, f"{name}: the correlation at the kernel's "
              f"argmax is {at_err:.3e} off cmax")
        ms = cuda_ms(lambda: max_corr.max_corr(s, t))
        plain_ms = cuda_ms(lambda: max_corr.max_corr_plain(s, t))
        library_ms = cuda_ms(lambda: torch.bmm(t, s.mT).max(-1))
        bound_ms, bound_by = bound(*corr_work(B, Ns, Nt, C), TF32X3_PEAK)
        fp32_bound_ms = bound(*corr_work(B, Ns, Nt, C))[0]
        print(f"corr kernel {name}: cmax max_abs_err={err:.3e} (tol "
              f"{CORR_ATOL:g}), {err64:.3e} off the float64 maximum; argmax "
              f"equal at all {decided} of {B * Nt} "
              f"rows with a top-two gap > {CORR_ATOL:g}"
              + (" and at every tie" if ties else "")
              + f"; correlation at the kernel's argmax within {at_err:.3e}; "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms bmm+max "
              f"{library_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}, "
              f"tensor cores as 3 TF32 products; {fp32_bound_ms:.4f} ms on "
              f"the FP32 cores)")
        results[name] = dict(err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, work=corr_work(B, Ns, Nt,
                                                                   C))
    s, t = corr_inputs(1, 64, 32, 8, False, 49, device)
    refusals = {
        "bfloat16": (TypeError, lambda: max_corr.max_corr(s.bfloat16(),
                                                          t.bfloat16())),
        "non-contiguous": (ValueError, lambda: max_corr.max_corr(
            s.mT.contiguous().mT, t)),
        "mismatched channels": (ValueError, lambda: max_corr.max_corr(
            s, t[..., :4].contiguous())),
    }
    expect_refusals("max_corr", refusals)
    return results


ATTN_CASES = [  # name, N, k, C, D, negative slope
    ("k=5 site N=32768 C128", 8 * 64 * 64, 5, 128, 128, 0.1),
    ("k=3 site N=8192 C256", 8 * 32 * 32, 3, 256, 128, 0.1),
    ("ragged N=1000 k=3 C21 D42", 1000, 3, 21, 42, 0.1),
    ("ragged N=1000 k=3 C21 D42 ReLU", 1000, 3, 21, 42, 0.0),
    ("shapenet k=3 site N=32768 C128", 8 * 64 * 64, 3, 128, 128, 0.1),
    ("animation k=5 site N=8192 C128", 2 * 64 * 64, 5, 128, 128, 0.1),
    ("animation k=3 site N=2048 C256", 2 * 32 * 32, 3, 256, 128, 0.1),
]
ATTN_OUTPUTS = ("d_bs", "d_bt", "d_hpre", "dW2", "db1", "db2")


def attn_inputs(N, k, C, D, seed, device):
    """Blocks, weights in gfla_tpu's layout, and an output cotangent. b1
    sets every pre-activation 6 sigma to either side of the activation's
    kink, so that f32 rounding cannot put one unit on different branches in
    the kernel and the plain twin: of 4 M units of N(0, sigma^2), one lands
    within the ~1e-6 rounding of 0 in a typical draw, and its d_hpre then
    differs by 0.9 |d_h|, through d_bs, d_bt and db1."""
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    k2 = k * k
    sigma = 0.05 * np.sqrt(2 * k2 * C)  # std of bt.W1t + bs.W1s
    b1 = 6 * sigma * np.where(np.arange(D) % 2 == 0, 1.0, -1.0)
    return ((t(rng.randn(N, k2, C)), t(rng.randn(N, k2, C)),
             t(rng.randn(k2, 2 * C, D) * 0.05), t(b1 + rng.randn(D) * 0.1),
             t(rng.randn(D, k2) * 0.01), t(rng.randn(k2) * 0.1)),
            t(rng.randn(N, C)))


def attn_work(N, k, C, D):
    """(FLOPs, bytes) of the forward kernel, of the backward kernel, and of
    the backward gfla_tpu's kernel computes. Each has the dense layer over
    [bt || bs] once: the forward's product, the backward's d_[bt || bs] =
    d_hpre W1^T, since it starts from the forward's hpre; the recomputing
    backward has it twice. Plus the logits, the weighted sum and their
    gradients on the FP32 cores; each input read once, each output written
    once, as 4-byte floats: the forward reads bs and bt, the backward bs, g
    and hpre (bt only for dW1, outside the kernel) and writes d_bs, d_bt and
    d_hpre."""
    k2 = k * k
    dense = 2 * N * 2 * k2 * C * D
    weights = 2 * k2 * C * D + D + D * k2 + k2
    sums = D * k2 + D + k2
    small = 2 * N * (3 * D * k2 + 2 * k2 * C)
    fwd = (dense + 2 * N * (D * k2 + k2 * C),
           4 * (2 * N * k2 * C + weights + N * C))
    bwd = (dense + small,
           4 * (N * k2 * C + N * C + N * D + weights + 2 * N * k2 * C
                + N * D + sums))
    recompute = (2 * dense + small,
                 4 * (2 * N * k2 * C + N * C + weights + 2 * N * k2 * C
                      + N * D + sums))
    return fwd, bwd, recompute


def phase_attn_kernel(device):
    """Both attention-math kernels against their plain twins, the backward
    from the forward kernel's hpre: the forward, hpre and each of the six
    backward outputs within BWD_REL x its max |value|; the forward's output
    unchanged when it stores hpre; all six backward outputs bitwise equal
    over two launches (the sums over positions are added in a fixed order,
    the rest written once with no atomics). Returns the results, and the
    inputs of the cases ATTN_BF16_CASES names, for phase 8b."""
    from gfla_tpu_torch.ops import attn_math

    results, kept = {}, {}
    for i, (name, N, k, C, D, slope) in enumerate(ATTN_CASES):
        args, g = attn_inputs(N, k, C, D, 50 + i, device)
        if any(name == c[0] for c in ATTN_BF16_CASES):
            kept[name] = (args, g)
        bs, bt, w1, b1, w2, b2 = args
        out = attn_math.attn_math_fwd(*args, slope)
        out_h, hpre = attn_math.attn_math_fwd_with_hpre(*args, slope)
        want, want_h = attn_math.attn_math_plain(*args, slope, with_hpre=True)
        got_b = attn_math.attn_math_bwd(bs, bt, g, w1, b1, w2, b2, slope,
                                        hpre)
        again = attn_math.attn_math_bwd(bs, bt, g, w1, b1, w2, b2, slope,
                                        hpre)
        want_b = attn_math.attn_math_bwd_plain(bs, bt, g, w1, b1, w2, b2,
                                               slope, hpre)
        torch.cuda.synchronize()
        errs, faults = [], []
        for what, a, b in zip(("out", "hpre") + ATTN_OUTPUTS,
                              (out, hpre, *got_b), (want, want_h, *want_b)):
            err = (a - b).abs().max().item()
            tol = BWD_REL * b.abs().max().item()
            if not (bool(torch.isfinite(a).all()) and err <= tol):
                faults.append(f"{what} {err:.3e} > {tol:.3e}")
            errs.append(err)
        check(not faults, f"{name}: kernel vs plain: {', '.join(faults)}")
        check(torch.equal(out_h, out), f"{name}: the output moved when hpre "
              f"is stored")
        moved = [o for o, a, b in zip(ATTN_OUTPUTS, got_b, again)
                 if not torch.equal(a, b)]
        check(not moved, f"{name}: {moved} differ between two launches")
        fwd_ms = cuda_ms(lambda: attn_math.attn_math_fwd(*args, slope),
                         iters=10)
        fwd_hpre_ms = cuda_ms(lambda: attn_math.attn_math_fwd_with_hpre(
            *args, slope), iters=10)
        fwd_plain = cuda_ms(lambda: attn_math.attn_math_plain(*args, slope),
                            iters=10)
        bwd_ms = cuda_ms(lambda: attn_math.attn_math_bwd(
            bs, bt, g, w1, b1, w2, b2, slope, hpre), iters=10)
        bwd_plain = cuda_ms(lambda: attn_math.attn_math_bwd_plain(
            bs, bt, g, w1, b1, w2, b2, slope, hpre), iters=10)
        bwd_recompute = cuda_ms(lambda: attn_math.attn_math_bwd_plain(
            bs, bt, g, w1, b1, w2, b2, slope), iters=10)
        dw1_ms = cuda_ms(lambda: attn_math.attn_math_dw1(bs, bt, want_b[2]),
                         iters=10)
        fwd_work, bwd_work, recompute_work = attn_work(N, k, C, D)
        print(f"attn-math {name}: max_abs_err out={errs[0]:.3e} "
              f"hpre={errs[1]:.3e} "
              + " ".join(f"{o}={e:.3e}" for o, e in zip(ATTN_OUTPUTS,
                                                        errs[2:]))
              + f" (tol {BWD_REL:g} x max|value|); backward outputs bitwise "
              f"equal over two launches; forward kernel {fwd_ms:.4f} ms, "
              f"storing hpre {fwd_hpre_ms:.4f} ms, plain {fwd_plain:.4f} ms, "
              f"bound {bound_pair(fwd_work)}; backward kernel from hpre "
              f"{bwd_ms:.4f} ms, plain given hpre {bwd_plain:.4f} ms, plain "
              f"recomputing hpre {bwd_recompute:.4f} ms, bound "
              f"{bound_pair(bwd_work)} (recomputing: "
              f"{bound_pair(recompute_work)}); dW1 matmul outside "
              f"{dw1_ms:.4f} ms")
        results[name] = dict(
            fwd=dict(err=max(errs[:2]), ms=fwd_ms, plain_ms=fwd_plain,
                     work=fwd_work),
            bwd=dict(err=max(errs[2:]), ms=bwd_ms, plain_ms=bwd_plain,
                     work=bwd_work))
    args, g = attn_inputs(40, 3, 8, 16, 59, device)
    bs, bt, w1, b1, w2, b2 = args
    hpre = attn_math.attn_math_fwd_with_hpre(*args)[1]
    refusals = {
        "C > 512": (ValueError, lambda: attn_math.attn_math_fwd(
            *attn_inputs(4, 3, 520, 16, 59, device)[0])),
        "bfloat16 blocks with float32 weights": (
            TypeError, lambda: attn_math.attn_math_fwd(bs.bfloat16(),
                                                       *args[1:])),
        "non-contiguous": (ValueError, lambda: attn_math.attn_math_fwd(
            bs.transpose(0, 1).contiguous().transpose(0, 1), *args[1:])),
        "g of the wrong shape": (ValueError, lambda: attn_math.attn_math_bwd(
            bs, bt, g[:20], w1, b1, w2, b2, 0.1, hpre)),
        "no hpre": (ValueError, lambda: attn_math.attn_math_bwd(
            bs, bt, g, w1, b1, w2, b2)),
        "hpre of the wrong shape": (ValueError, lambda: attn_math.attn_math_bwd(
            bs, bt, g, w1, b1, w2, b2, 0.1, hpre[:, :8].contiguous())),
    }
    expect_refusals("attn_math", refusals)
    return results, kept


ATTN_BF16_CASES = [  # name, N, k, C, D (LeakyReLU 0.1), cases of ATTN_CASES
    ("k=5 site N=32768 C128", 8 * 64 * 64, 5, 128, 128),
    ("k=3 site N=8192 C256", 8 * 32 * 32, 3, 256, 128),
    ("shapenet k=3 site N=32768 C128", 8 * 64 * 64, 3, 128, 128),
    ("ragged N=1000 k=3 C21 D42", 1000, 3, 21, 42),
    ("animation k=5 site N=8192 C128", 2 * 64 * 64, 5, 128, 128),
    ("animation k=3 site N=2048 C256", 2 * 32 * 32, 3, 256, 128),
]


def attn_work_bf16(N, k, C, D):
    """(FLOPs, bytes) of the bf16 forward (storing hpre) and backward
    kernels: attn_work's operations, and bytes with the blocks, g, the
    weights and d_bs, d_bt, d_hpre in bf16, hpre and the sums in f32."""
    k2 = k * k
    fwd_ops, bwd_ops, _ = (w[0] for w in attn_work(N, k, C, D))
    weights = 2 * (2 * k2 * C * D + D + D * k2 + k2)
    fwd = 2 * (2 * N * k2 * C + N * C) + weights + 4 * N * D
    bwd = (2 * (N * k2 * C + N * C) + 4 * N * D + weights
           + 2 * (2 * N * k2 * C + N * D) + 4 * (D * k2 + D + k2))
    return (fwd_ops, fwd), (bwd_ops, bwd)


def phase_attn_bf16_kernels(inputs):
    """The attention-math kernels' bf16 instances (attn_math_fwd_bf16.cu,
    attn_math_bwd_bf16.cu) against their bf16 plain twins at the pose
    sites, ShapeNet's and a ragged shape, from bf16 blocks, weights and g
    (phase 8's `inputs` of the same cases, rounded): the output by the bf16
    rule, the f32 hpre within BWD_REL x max of the twin's (f32 sums of the
    same bf16 products), the output unchanged when hpre is stored; the
    backward from the kernel's hpre, each of its six outputs by the bf16
    rule and bitwise equal over two launches; median ms of each kernel and
    twin, the bound at the bf16 rate."""
    from gfla_tpu_torch.ops import attn_math

    bf = torch.bfloat16
    results = {}
    for name, N, k, C, D in ATTN_BF16_CASES:
        args32, g32 = inputs.pop(name)
        args = tuple(t.to(bf) for t in args32)
        g = g32.to(bf)
        wide = tuple(t.float() for t in args)  # the same values in f32
        out, hpre = attn_math.attn_math_fwd_with_hpre(*args)
        out_only = attn_math.attn_math_fwd(*args)
        plain, plain_h = attn_math.attn_math_plain(*args, with_hpre=True)
        f32, f32_h = attn_math.attn_math_plain(*wide, with_hpre=True)
        check(out.dtype == bf and hpre.dtype == torch.float32,
              f"bf16 attn-math {name}: forward gave {out.dtype}, hpre "
              f"{hpre.dtype}")
        bs, bt, w1, b1, w2, b2 = args
        got = attn_math.attn_math_bwd(bs, bt, g, w1, b1, w2, b2, 0.1, hpre)
        again = attn_math.attn_math_bwd(bs, bt, g, w1, b1, w2, b2, 0.1, hpre)
        want = attn_math.attn_math_bwd_plain(bs, bt, g, w1, b1, w2, b2, 0.1,
                                             hpre)
        f32_b = attn_math.attn_math_bwd_plain(*wide[:2], g.float(), *wide[2:],
                                              0.1, f32_h)
        torch.cuda.synchronize()
        check(torch.equal(out_only, out), f"bf16 attn-math {name}: the "
              f"output moved when hpre is stored")
        err_h = (hpre - plain_h).abs().max().item()
        tol_h = BWD_REL * plain_h.abs().max().item()
        check(err_h <= tol_h, f"bf16 attn-math {name}: hpre vs plain "
              f"{err_h:.3e} > {tol_h:.3e}")
        errs = {"out": bf16_rule(f"bf16 attn-math {name} out", out, plain,
                                 f32, BF16_OUT_REL)}
        for o, a, b, f in zip(ATTN_OUTPUTS, got, want, f32_b):
            check(a.dtype == b.dtype, f"bf16 attn-math {name}: {o} in "
                  f"{a.dtype}, the twin's {b.dtype}")
            errs[o] = bf16_rule(f"bf16 attn-math {name} {o}", a, b, f,
                                BF16_OUT_REL if o == "d_bs"
                                else BF16_GRAD_REL)
        moved = [o for o, a, b in zip(ATTN_OUTPUTS, got, again)
                 if not torch.equal(a, b)]
        check(not moved, f"bf16 attn-math {name}: {moved} differ between two "
              f"launches")
        ms = {
            "fwd": (cuda_ms(lambda: attn_math.attn_math_fwd_with_hpre(*args),
                            iters=10),
                    cuda_ms(lambda: attn_math.attn_math_plain(
                        *args, with_hpre=True), iters=10)),
            "bwd": (cuda_ms(lambda: attn_math.attn_math_bwd(
                bs, bt, g, w1, b1, w2, b2, 0.1, hpre), iters=10),
                    cuda_ms(lambda: attn_math.attn_math_bwd_plain(
                        bs, bt, g, w1, b1, w2, b2, 0.1, hpre), iters=10)),
        }
        work = dict(zip(("fwd", "bwd"), attn_work_bf16(N, k, C, D)))
        bounds = {part: bound(*work[part], BF16_PEAK) for part in work}
        print(f"bf16 attn-math {name}: kernel vs bf16 plain twin, x "
              f"max|f32|: " + " ".join(
                  f"{o}={rel:.3e}" for o, (_, rel) in errs.items())
              + f" (tol out, d_bs {BF16_OUT_REL:g}, others "
              f"{BF16_GRAD_REL:g}; each within 2x the twin's error against "
              f"f32 + {BF16_SLACK:g}); hpre max_abs_err={err_h:.3e} (tol "
              f"{tol_h:.3e}); backward outputs bitwise equal over two "
              f"launches; "
              + "; ".join(f"{part} kernel {ms[part][0]:.4f} ms plain "
                          f"{ms[part][1]:.4f} ms bound {bounds[part][0]:.4f} "
                          f"ms ({bounds[part][1]}, bf16 989 TFLOP/s)"
                          for part in ms))
        results[name] = {
            "fwd": dict(err=errs["out"][0], ms=ms["fwd"][0],
                        plain_ms=ms["fwd"][1], work=work["fwd"]),
            "bwd": dict(err=max(errs[o][0] for o in ATTN_OUTPUTS),
                        ms=ms["bwd"][0], plain_ms=ms["bwd"][1],
                        work=work["bwd"])}
    return results


def deepfashion_batch(seed, B=8, size=256, content_w=176, structure_nc=18):
    """Random images in the DeepFashion layout: content in a centred
    256x176 band of a 256x256 tensor, white (1.0) side borders; keypoints
    (y, x) inside the band."""
    rng = np.random.RandomState(seed)
    x0 = (size - content_w) // 2
    imgs = np.ones((2, B, size, size, 3), np.float32)
    imgs[:, :, :, x0:x0 + content_w] = rng.rand(
        2, B, size, content_w, 3).astype(np.float32) * 2 - 1
    kp = rng.rand(2, B, structure_nc, 2).astype(np.float32)
    kp[..., 0] *= size - 1
    kp[..., 1] = kp[..., 1] * (content_w - 1) + x0
    return {"P1": imgs[0], "KP1": kp[0], "P2": imgs[1], "KP2": kp[1]}


def phase_slice(extra_args):
    from gfla_tpu_torch.options import TestOptions
    from gfla_tpu_torch.tasks import create_task

    opt = TestOptions().parse(
        ["--model=pose", "--dataset_mode=synthetic", "--load_size=256",
         "--batchSize=8", "--gpu_ids=0", *extra_args], save=False)
    task = create_task(opt)
    task.load_checkpoint()
    g = task.net_g
    check(g.source.block0.model[2].out_channels == 64
          and g.target.attn1.kernel_size == 5
          and g.target.attn0.kernel_size == 3, "not the full-width config")
    print(f"generator: {sum(p.numel() for p in g.parameters())} parameters "
          f"on {task.device}")

    requests = [task.prepare_batch(deepfashion_batch(seed))
                for seed in range(4)]
    reset_launch_counts()
    outs = [task.test_step(batch) for batch in requests]
    torch.cuda.synchronize()
    launches = launch_counts()["warp_fwd"]
    print(f"served {len(requests)} requests: {launches} kernel launches")
    check(launches == 2 * len(requests),
          f"{launches} launches for {len(requests)} forwards, expected 2 each")
    for img, flows, masks in outs:
        check(tuple(img.shape) == (8, 3, 256, 256), f"shape {img.shape}")
        check(bool(torch.isfinite(img).all()), "non-finite output")
        check(img.min().item() >= -1 and img.max().item() <= 1,
              "output outside [-1, 1]")
        check([tuple(f.shape) for f in flows] == [(8, 2, 32, 32),
                                                  (8, 2, 64, 64)],
              "flow shapes")

    not_cl = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=name: not_cl.append(name)
        if isinstance(out, torch.Tensor) and out.dim() == 4
        and not out.is_contiguous(memory_format=torch.channels_last)
        else None) for name, m in g.named_modules()]
    task.test_step(requests[0])
    for h in hooks:
        h.remove()
    print(f"layout: module outputs not channels_last: {not_cl}")

    with plain_warp():
        plain_img = task.test_step(requests[0])[0]
    diff = (outs[0][0] - plain_img).abs().max().item()
    print(f"kernel path vs plain path: max_abs_diff={diff:.3e} "
          f"(bound {SLICE_ATOL:g})")
    check(diff <= SLICE_ATOL, f"kernel path vs plain path {diff:.3e}")

    small = task.prepare_batch(deepfashion_batch(7, B=2, size=64,
                                                 content_w=44))
    card_img = task.test_step(small)[0].cpu()
    cpu_task = copy.copy(task)
    cpu_task.net_g = copy.deepcopy(g).cpu()
    cpu_img = cpu_task.test_step({k: v.cpu() for k, v in small.items()})[0]
    diff_cpu = (card_img - cpu_img).abs().max().item()
    print(f"card vs CPU at 2x64x64: max_abs_diff={diff_cpu:.3e} "
          f"(bound {CPU_ATOL:g})")
    check(diff_cpu <= CPU_ATOL, f"card vs CPU {diff_cpu:.3e}")

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: task.test_step(requests[1]), iters=10)
    peak = torch.cuda.max_memory_allocated() / 2**20
    with plain_warp():
        plain_ms = cuda_ms(lambda: task.test_step(requests[1]), iters=10)
    ms_again = cuda_ms(lambda: task.test_step(requests[1]), iters=10)
    print(f"forward batch 8 at 256x256: kernel path {ms:.3f} ms "
          f"(again {ms_again:.3f}), plain path {plain_ms:.3f} ms, "
          f"peak {peak:.0f} MiB")
    return dict(launches=launches, task=task, request=requests[0],
                requests=requests)


def phase_serve_bf16(serve, extra_args):
    """Serving under --compute_dtype=bfloat16: the same weights and requests
    as phase_slice through PoseTask.test_step, the bf16 warp kernel launched
    twice a request and nothing else; the image against the plain bf16 path
    and both against the f32 output by the bf16 rule; ms per forward beside
    the f32 path's, in turns. Then the same under GFLA_ATTN_PALLAS=1: the
    bf16 attention-math forward launched twice a request and nothing else,
    the image against that route's plain bf16 path and the f32 image, and
    the share of each ExtractorAttn output's values that differ there."""
    from gfla_tpu_torch.options import TestOptions
    from gfla_tpu_torch.tasks import create_task

    opt = TestOptions().parse(
        ["--model=pose", "--dataset_mode=synthetic", "--load_size=256",
         "--batchSize=8", "--gpu_ids=0", "--compute_dtype=bfloat16",
         *extra_args], save=False)
    task, f32_task = create_task(opt), serve["task"]
    task.net_g.load_state_dict(f32_task.net_g.state_dict())
    requests = serve["requests"]
    reset_launch_counts()
    outs = [task.test_step(batch) for batch in requests]
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"bf16 served {len(requests)} requests: launches {counts}")
    check(only(counts, warp_fwd_bf16=2 * len(requests)),
          f"bf16 serving launched {counts}, expected 2 warp_fwd_bf16 a "
          f"request and nothing else")
    for img, flows, masks in outs:
        check(tuple(img.shape) == (8, 3, 256, 256)
              and img.dtype == torch.float32, f"bf16 image {img.shape} "
              f"{img.dtype}")
        check(bool(torch.isfinite(img).all()), "bf16: non-finite output")
        check(img.min().item() >= -1 and img.max().item() <= 1,
              "bf16: output outside [-1, 1]")
    with plain_warp():
        plain_img = task.test_step(requests[0])[0]
    f32_img = f32_task.test_step(requests[0])[0]
    err, rel = bf16_rule("bf16 serving", outs[0][0], plain_img, f32_img,
                         SERVE_BF16_REL)
    top = f32_img.abs().max().item()
    print(f"bf16 serving: kernel vs plain bf16 path max_abs_diff={err:.3e} "
          f"= {rel:.3e} x max|f32 image| (bound {SERVE_BF16_REL:g}); off the "
          f"f32 image by {(outs[0][0] - f32_img).abs().max().item() / top:.3e}"
          f" (kernel) and {(plain_img - f32_img).abs().max().item() / top:.3e}"
          f" (plain) of its max {top:.3e}")
    times = {"f32": [], "bf16": []}
    for path in ("f32", "bf16", "bf16", "f32"):
        run = task if path == "bf16" else f32_task
        times[path].append(cuda_ms(lambda: run.test_step(requests[1]),
                                   iters=10))
    with plain_warp():
        plain_ms = cuda_ms(lambda: task.test_step(requests[1]), iters=10)
    print(f"bf16 forward batch 8 at 256x256: kernel path "
          f"{', '.join(f'{t:.3f}' for t in times['bf16'])} ms, plain bf16 "
          f"path {plain_ms:.3f} ms; f32 kernel path "
          f"{', '.join(f'{t:.3f}' for t in times['f32'])} ms (in turns)")
    with switches(GFLA_ATTN_PALLAS="1"):
        reset_launch_counts()
        attn_outs = [task.test_step(batch)[0] for batch in requests]
        torch.cuda.synchronize()
        attn_counts = launch_counts()
        reset_launch_counts()
        with plain_attn_math():
            attn_plain, sites_plain = attention_outputs(task, requests[0])
        torch.cuda.synchronize()
        plain_counts = launch_counts()
        _, sites = attention_outputs(task, requests[0])
        attn_ms = cuda_ms(lambda: task.test_step(requests[1]), iters=10)
    differ = [(a != b).float().mean().item() for a, b in zip(sites,
                                                              sites_plain)]
    site_rel = [((a.float() - b.float()).abs().max()
                 / b.float().abs().max()).item()
                for a, b in zip(sites, sites_plain)]
    print(f"bf16 served {len(requests)} requests under GFLA_ATTN_PALLAS=1: "
          f"launches {attn_counts}")
    check(only(attn_counts, attn_math_fwd_bf16=2 * len(requests)),
          f"bf16 GFLA_ATTN_PALLAS=1 serving launched {attn_counts}, expected "
          f"2 attn_math_fwd_bf16 a request and nothing else")
    check(only(plain_counts), f"the plain bf16 GFLA_ATTN_PALLAS=1 path "
          f"launched {plain_counts}")
    for img in attn_outs:
        check(tuple(img.shape) == (8, 3, 256, 256)
              and bool(torch.isfinite(img).all())
              and img.min().item() >= -1 and img.max().item() <= 1,
              "bf16 GFLA_ATTN_PALLAS=1: image shape, finiteness or range")
    attn_err, attn_rel = bf16_rule("bf16 GFLA_ATTN_PALLAS=1 serving",
                                   attn_outs[0], attn_plain, f32_img,
                                   SERVE_BF16_REL)
    print(f"bf16 GFLA_ATTN_PALLAS=1 serving: kernel vs plain bf16 path "
          f"max_abs_diff={attn_err:.3e} = {attn_rel:.3e} x max|f32 image| "
          f"(bound {SERVE_BF16_REL:g}); off the f32 image by "
          f"{(attn_outs[0] - f32_img).abs().max().item() / top:.3e} (kernel) "
          f"and {(attn_plain - f32_img).abs().max().item() / top:.3e} "
          f"(plain); {attn_ms:.3f} ms per batch-8 forward; the "
          f"ExtractorAttn outputs, kernel vs plain: "
          + ", ".join(f"{100 * d:.3f}% of values differ, max "
                      f"{r:.3e} x max" for d, r in zip(differ, site_rel)))
    check(len(sites) == len(sites_plain) == 2,
          f"bf16 GFLA_ATTN_PALLAS=1: {len(sites)} ExtractorAttn outputs")
    return dict(launches=counts["warp_fwd_bf16"], err=err,
                ms=statistics.median(times["bf16"]),
                attn_launches=attn_counts["attn_math_fwd_bf16"])


def launch_counts():
    from gfla_tpu_torch.ops import attn_math, max_corr, warp

    return {"warp_fwd": warp.launches, "warp_bwd_pos": warp.bwd_pos_launches,
            "warp_bwd_w1": warp.bwd_w1_launches,
            "warp_fwd_bf16": warp.bf16_launches,
            "warp_bwd_pos_bf16": warp.bf16_bwd_pos_launches,
            "warp_bwd_w1_bf16": warp.bf16_bwd_w1_launches,
            "warp_fwd_wide": warp.wide_launches,
            "warp_bwd_pos_wide": warp.wide_bwd_pos_launches,
            "warp_bwd_w1_wide": warp.wide_bwd_w1_launches,
            "warp_fwd_wide_bf16": warp.bf16_wide_launches,
            "warp_bwd_pos_wide_bf16": warp.bf16_wide_bwd_pos_launches,
            "warp_bwd_w1_wide_bf16": warp.bf16_wide_bwd_w1_launches,
            "max_corr": max_corr.launches,
            "attn_math_fwd": attn_math.fwd_launches,
            "attn_math_bwd": attn_math.bwd_launches,
            "attn_math_fwd_bf16": attn_math.bf16_fwd_launches,
            "attn_math_bwd_bf16": attn_math.bf16_bwd_launches}


def reset_launch_counts():
    from gfla_tpu_torch.ops import attn_math, max_corr, warp

    warp.launches = warp.bwd_pos_launches = warp.bwd_w1_launches = 0
    warp.bf16_launches = warp.bf16_bwd_pos_launches = 0
    warp.bf16_bwd_w1_launches = 0
    warp.wide_launches = warp.wide_bwd_pos_launches = 0
    warp.wide_bwd_w1_launches = warp.bf16_wide_launches = 0
    warp.bf16_wide_bwd_pos_launches = warp.bf16_wide_bwd_w1_launches = 0
    max_corr.launches = 0
    attn_math.fwd_launches = attn_math.bwd_launches = 0
    attn_math.bf16_fwd_launches = attn_math.bf16_bwd_launches = 0


def only(counts, **expected):
    """True if `counts` holds `expected` and 0 for every other kernel."""
    return counts == {name: expected.get(name, 0) for name in counts}


def switches(**env):
    """The GFLA_* switches for one phase, restored when it ends."""
    return mock.patch.dict(os.environ, env)


def plain_warp():
    """The plain path: the warp as `warp_fwd_plain`, differentiated by
    autograd, so neither kernel nor WarpFunction is on it."""
    from gfla_tpu_torch.ops import warp

    return mock.patch.object(warp, "warp_fwd", warp.warp_fwd_plain)


def plain_attn_math():
    """The GFLA_ATTN_PALLAS=1 route's plain path: the attention math as
    `attn_math_plain`, differentiated by autograd."""
    from gfla_tpu_torch.ops import attn_math

    return mock.patch.object(attn_math, "attn_math", attn_math.attn_math_plain)


def nets(task):
    """The task's trained networks: G, and D and D_V where the task has
    them."""
    out = {"G": task.net_g}
    if hasattr(task, "net_d"):
        out["D"] = task.net_d
    if hasattr(task, "net_d_v"):
        out["D_V"] = task.net_d_v
    return out


def snapshot(task):
    """Parameters, gradients and spectral-norm u buffers, cloned."""
    return {tag: dict(
        params={n: p.detach().clone() for n, p in net.named_parameters()},
        grads={n: p.grad.detach().clone() for n, p in net.named_parameters()
               if p.grad is not None},
        u={n: b.clone() for n, b in net.named_buffers()
           if n.endswith("weight_u")})
        for tag, net in nets(task).items()}


def exact_grads(task, batch):
    """Gradients of one step of `task`'s state in float64 on the plain path
    (the kernels take float32 only): the reference that tells the
    gradients f32 resolves from those it does not."""
    task = copy.deepcopy(task)
    for module in (*nets(task).values(), task.vgg):
        module.double()
    with plain_warp():
        task.train_step({k: v.double() if v.is_floating_point() else v
                         for k, v in batch.items()})
    grads = {tag: s["grads"] for tag, s in snapshot(task).items()}
    del task
    torch.cuda.empty_cache()
    return grads


def check_step_pair(what, logs_a, snap_a, logs_b, snap_b, exact, lrs,
                    masked=True, grad_rel=GRAD_F64_REL, pair_rel=None):
    """Two steps from one state, a (kernel path, card) against b (plain path,
    CPU): losses within TRAIN_LOSS_REL; each gradient of a within
    `grad_rel` x its tensor's largest exact |grad| of the exact (float64)
    one (b's is printed: the CPU's f32 is the further off of the two at
    64x64); the updated parameters within 2 lr everywhere
    and, with `masked`, within PARAM_ATOL where |exact grad| > MASK_REL x
    that largest one, where f32 resolves it, and where Adam's step is a
    sign.

    Adam's first step with beta1 = 0 is lr * g / (|g| + 1e-8): lr * sign(g)
    where |g| is well above 1e-8, lr * g / 1e-8 where it is not, and there
    the f32 rounding of g is multiplied by lr / 1e-8 = 1e4. So an entry is
    held tight only where |exact g| > ADAM_FLOOR and > RESOLVED x the
    tensor's f32 rounding (its largest f32-vs-f64 gradient difference on
    either side); the rest are held to 2 lr. A tensor whose exact gradient
    is 0 (a conv bias feeding an instance norm) gets f32 rounding as its
    gradient and is held to 2 lr only. With `pair_rel`, each gradient of a
    that the f64 step does not find 0 is also held to b's, within
    `pair_rel` x that largest exact |grad|."""
    faults = []
    loss_rel = pair_worst = 0.0
    for name, want in logs_b.items():
        got, want = float(logs_a[name]), float(want)
        rel = abs(got - want) / max(abs(want), 1e-30)
        if not (np.isfinite(got) and rel <= TRAIN_LOSS_REL):
            faults.append(f"loss {name} {got} vs {want}")
        loss_rel = max(loss_rel, rel)
    worst = [0.0, 0.0]
    param_err = floored_err = 0.0
    held = skipped = n_big = n_signed = n_resolved = 0
    for tag, lr in lrs.items():
        ex = exact[tag]
        scale = max(g.abs().max().item() for g in ex.values())
        for name, a in snap_a[tag]["params"].items():
            diff = (a - snap_b[tag]["params"][name]).abs()
            if diff.max().item() > 2 * lr:
                faults.append(f"{tag} {name} moved {diff.max().item():.3e} "
                              f"apart, > 2 lr")
            g64 = ex.get(name)  # None: a head the losses do not reach
            top = 0.0 if g64 is None else g64.abs().max().item()
            if top <= 1e-9 * scale:  # exactly 0 in f64
                skipped += 1
                continue
            grads = [side[tag]["grads"][name].double()
                     for side in (snap_a, snap_b)]
            sides = [(g - g64).abs().max().item() for g in grads]
            rounding = max(sides)
            if sides[0] > grad_rel * top:
                faults.append(f"{tag} {name} grad off the f64 one by "
                              f"{sides[0] / top:.3e} of its max {top:.3e}")
            if pair_rel is not None:
                pair_err = (grads[0] - grads[1]).abs().max().item() / top
                pair_worst = max(pair_worst, pair_err)
                if pair_err > pair_rel:
                    faults.append(f"{tag} {name} grad off the other path's by "
                                  f"{pair_err:.3e} of its max {top:.3e}")
            worst = [max(r, e / top) for r, e in zip(worst, sides)]
            held += 1
            if not masked:
                continue
            big = g64.abs() > MASK_REL * top
            signed = big & (g64.abs() > ADAM_FLOOR)
            resolved = signed & (g64.abs() > RESOLVED * rounding)
            n_big += int(big.sum())
            n_signed += int(signed.sum())
            n_resolved += int(resolved.sum())
            if big.any():
                floored_err = max(floored_err, diff[big].max().item())
            if not resolved.any():
                continue
            # read from the masked tensor: where every held entry moved
            # alike (Adam's step is lr sign(g) there), its argmax is entry
            # 0, which need not be held
            held_diff = torch.where(resolved, diff, 0).flatten()
            i = held_diff.argmax()
            err = held_diff[i].item()
            param_err = max(param_err, err)
            if err > PARAM_ATOL:
                faults.append(
                    f"{tag} {name} updated {err:.3e} apart at an entry with "
                    f"grad f64 {g64.flatten()[i].item():.4e}, "
                    f"{grads[0].flatten()[i].item():.4e} vs "
                    f"{grads[1].flatten()[i].item():.4e}")
    rule = (f"updated parameters within {param_err:.3e} (bound {PARAM_ATOL:g})"
            f" at the {n_resolved} of {n_big} entries with |grad| > "
            f"{MASK_REL:g} max that Adam signs ({n_signed}) and f32 "
            f"resolves, within {floored_err:.3e} at all {n_big}" if masked else
            "updated parameters within 2 lr")
    pair_note = ("" if pair_rel is None else
                 f"; path a's gradients within {pair_worst:.3e} of path b's "
                 f"x each tensor's max (bound {pair_rel:g})")
    print(f"{what}: losses within {loss_rel:.3e} rel; gradients within "
          f"{worst[0]:.3e} and {worst[1]:.3e} of each tensor's max of "
          f"the f64 step's{pair_note}; {rule}; "
          f"{held} tensors, {skipped} more with zero f64 gradient held to "
          f"2 lr")
    for fault in faults[:40]:
        print(f"  {what}: {fault}")
    check(not faults, f"{what}: {len(faults)} faults")


def timed_steps(task, batches):
    """One train_step per batch: (CUDA-event milliseconds, logs) of each."""
    times, logs = [], []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        logs.append(task.train_step(batch))
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return times, logs


def off_the_kinks(task):
    """A copy of `task` whose flow heads' biases (of each flow net) are
    seeded fractions in
    [0.3, 0.7]. At the seeded init the flows are nearly 0, so every sample
    of the warp and of the correctness loss's resampler sits on an integer
    coordinate, where floor() makes the gradient jump; the last bits of a
    float32 flow then decide the side, and no two summation orders (f32 vs
    f64, card vs CPU) agree there. Between integers both are smooth."""
    task = copy.deepcopy(task)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, head in task.net_g.named_modules():
            if name.startswith("flow_net") \
                    and name.rsplit(".", 1)[-1].startswith("output"):
                head.bias.copy_(0.3 + 0.4 * torch.rand(
                    head.bias.shape, generator=gen))
    return task


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms (cuDNN's deterministic convolution
    algorithms, sorted scatters in place of atomics) for the block: a step
    then repeats bitwise, so two steps part only where their paths do. An
    operation without a deterministic form raises."""
    cudnn = torch.backends.cudnn.deterministic
    with mock.patch.dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"):
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = True
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = cudnn


def kernel_argmax():
    """The scan path given the max-correlation kernel's argmax: the scan's
    cmax, the kernel's indices, so two steps take the same argmax."""
    from gfla_tpu_torch.losses import perceptual
    from gfla_tpu_torch.ops.max_corr import max_corr, max_corr_plain

    def scan_cmax(source_norm, target_norm, chunk):
        cmax = max_corr_plain(source_norm, target_norm, chunk)[0]
        return cmax, max_corr(source_norm.float().contiguous(),
                              target_norm.float().contiguous())[1]

    return mock.patch.object(perceptual, "_max_corr_fwd", scan_cmax)


def correctness_flips(task, batch):
    """The correctness loss's max-correlation inputs of one step of `task`
    (each attention level's VGG layer), the kernel's (cmax, argmax) against
    the scan's: cmax within CORR_ATOL; the rows whose argmax differs held
    to the top-two-gap rule of phase_corr_kernel (the plain correlation's
    top two within CORR_ATOL: a near-tie that the two summation orders
    break each their way). Returns {layer: (rows, flipped rows, largest
    gap among them)}."""
    from gfla_tpu_torch.losses.perceptual import _EPS, _safe_norm
    from gfla_tpu_torch.ops.max_corr import max_corr, max_corr_plain

    with torch.no_grad():
        flows = task.net_g(batch["P1"], batch["BP1"], batch["BP2"])[0]
        feats = [task.vgg(batch[k]) for k in ("P1", "P2")]
    used = sorted(task.attn_layer, reverse=True)
    out = {}
    for i in range(len(flows)):
        name = task.correctness.layers[used[i]]
        s, t = (f[name].float().permute(0, 2, 3, 1).flatten(1, 2)
                for f in feats)
        s, t = ((x / (_safe_norm(x, 2)[..., None] + _EPS)).contiguous()
                for x in (s, t))
        cmax, amax = max_corr(s, t)
        want_max, want_idx = max_corr_plain(s, t)
        err = (cmax - want_max).abs().max().item()
        check(err <= CORR_ATOL, f"{name}: cmax off the scan's by {err:.3e}")
        flips = gap = 0
        for b in range(s.shape[0]):
            flip = amax[b] != want_idx[b]
            if flip.any():
                top2 = (t[b][flip] @ s[b].T).topk(2, dim=1).values
                gap = max(gap, (top2[:, 0] - top2[:, 1]).max().item())
                flips += int(flip.sum())
        check(gap <= CORR_ATOL, f"{name}: argmax differs at a row whose top "
              f"two are {gap:.3e} apart, more than {CORR_ATOL:g}")
        out[name] = (s.shape[0] * t.shape[1], flips, gap)
    return out


def compare_steps(what, state, batch, lrs, to_cpu=False,
                  path_a=(), path_b=(plain_warp,),
                  grad_rel=GRAD_F64_REL, pair_rel=None):
    """One step of `state` on path a (the kernel path) against one on path b
    (the plain path) or, with `to_cpu`, one on the card against one on the
    CPU, both held against a float64 step by check_step_pair; card and CPU
    convolutions round differently all through G, so that pair is not
    masked. `path_a`/`path_b` give the contexts each step runs in;
    `pair_rel` holds a's gradients to b's (check_step_pair). Returns the
    float64 step's gradients."""
    exact = exact_grads(state, batch)
    a = copy.deepcopy(state)
    with contextlib.ExitStack() as stack:
        for path in path_a:
            stack.enter_context(path())
        logs_a = a.train_step(batch)
    snap_a = snapshot(a)
    del a
    b = copy.deepcopy(state)
    if to_cpu:
        for module in (*nets(b).values(), b.vgg):
            module.cpu()
        logs_b = b.train_step({k: v.cpu() for k, v in batch.items()})
    else:
        with contextlib.ExitStack() as stack:
            for path in path_b:
                stack.enter_context(path())
            logs_b = b.train_step(batch)
    snap_b = {tag: {kind: {n: t.to(batch["P1"].device) for n, t in d.items()}
                    for kind, d in s.items()}
              for tag, s in snapshot(b).items()}
    del b
    check_step_pair(what, logs_a, snap_a, logs_b, snap_b, exact, lrs,
                    masked=not to_cpu, grad_rel=grad_rel, pair_rel=pair_rel)
    return exact


def train_opt(*extra, model="pose", dataset="synthetic", ckpt=None):
    """The training CLI's options at full width, batch 8, checkpoints in
    `ckpt` or a new temporary directory (returned beside them, for the
    caller to clean)."""
    from gfla_tpu_torch.options import TrainOptions

    ckpt = ckpt or tempfile.TemporaryDirectory()
    opt = TrainOptions().parse(
        [f"--model={model}", f"--dataset_mode={dataset}", "--load_size=256",
         "--batchSize=8", "--gpu_ids=0", f"--checkpoints_dir={ckpt.name}",
         *extra], save=False)
    opt.iters_per_epoch = 1000
    return opt, ckpt


def train_main_path(task, opt, batches, what, still_ok=(), **launches):
    """The main path of a training phase: TRAIN_STEPS steps of `task`,
    counted (`launches`, and no other kernel) and timed, with the peak
    memory; finite losses; every parameter moved but those named by a
    prefix in `still_ok` whose gradient is None or exactly 0, every
    parameter and buffer still f32; u computed in the task's dtype by D(real) and D(fake)
    (step 1's D passes, recorded inside each call) and stored, in f32, by
    them alone; the plain path's time per step from the state reached;
    a save, then resume, gives the same next step. Returns (counts, times,
    plain_times, peak)."""
    from gfla_tpu_torch.tasks import create_task

    s0 = snapshot(task)

    def weight_u(mod):
        return {n: b for n, b in mod.named_buffers() if n.endswith("weight_u")}

    # each D call of step 1: (update_stats, the u tensors at its start and
    # at its end, its u values at the end, cloned)
    u_start, u_seen = [], []
    hooks = [task.net_d.register_forward_pre_hook(
        lambda mod, args: u_start.append(weight_u(mod))),
        task.net_d.register_forward_hook(
            lambda mod, args, kwargs, out: u_seen.append(
                (kwargs.get("update_stats"), u_start.pop(), weight_u(mod),
                 {n: b.clone() for n, b in weight_u(mod).items()})),
            with_kwargs=True)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, logs = timed_steps(task, batches[:1])
    for hook in hooks:
        hook.remove()
    u_after = snapshot(task)
    more_times, more_logs = timed_steps(task, batches[1:TRAIN_STEPS])
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    times, logs = times + more_times, logs + more_logs
    print(f"{what}trained {TRAIN_STEPS} steps: kernel launches {counts}")
    check(only(counts, **launches), f"{what}launches {counts} for "
          f"{TRAIN_STEPS} steps, expected {launches} and nothing else")

    for i, step_logs in enumerate(logs):
        check(sorted(step_logs) == sorted(task.loss_names + ["total_G"]),
              f"loss names {sorted(step_logs)}")
        for name, v in step_logs.items():
            check(bool(torch.isfinite(v)),
                  f"{what}step {i + 1}: {name} not finite")
    for i in (0, TRAIN_STEPS - 1):
        print(f"{what}losses, step {i + 1}: " + " ".join(
            f"{k} {float(v):.5f}" for k, v in logs[i].items()))
    for tag, net in nets(task).items():
        still = [n for n, p in net.named_parameters()
                 if torch.equal(p, s0[tag]["params"][n])
                 and not (n.startswith(still_ok)
                          and (p.grad is None or not p.grad.any()))]
        check(not still, f"{what}{tag}: parameters unchanged: {still}")
        kinds = {t.dtype for t in (*net.parameters(), *net.buffers())}
        check(kinds == {torch.float32}, f"{what}{tag}: state in {kinds}")
    flags = [seen[0] for seen in u_seen]
    check(flags == [True, True, False],
          f"{what}D passes of step 1: update_stats {flags}")
    u0 = s0["D"]["u"]
    spectral = [n for n in u0 if u0[n].numel() > 1]  # 1 output: u is 1
    for n in spectral:
        # a store rebinds the buffer inside the call, in either dtype
        stored = [end[n] is not start[n] for _, start, end, _ in u_seen]
        check(stored == [True, True, False], f"{what}{n} stored by D(real), "
              f"D(fake) and the G-loss pass: {stored}")
        u_real, u_fake, u_gen = (values[n] for *_, values in u_seen)
        check(u_real.dtype == task.dtype
              and not torch.equal(u_real.float(), u0[n])
              and (task.dtype != torch.float32
                   or not torch.equal(u_fake, u_real)),
              f"{what}the D step left {n} unchanged, or not in {task.dtype}")
        check(torch.equal(u_gen, u_fake)
              and torch.equal(u_after["D"]["u"][n], u_fake.float()),
              f"{what}the G-loss pass stored {n}")
    print(f"{what}u: D(real) and D(fake) each stored a new u, computed in "
          f"{task.dtype}, in the {len(spectral)} spectral convs with more "
          f"than one output; the G-loss pass stored none")

    # the plain path's time per step, from the state the main path reached
    plain = copy.deepcopy(task)
    with plain_warp():
        plain_times, _ = timed_steps(plain, batches[1:TRAIN_STEPS])
    del plain

    # checkpoint round trip: the resumed task's next step equals this one's
    task.save(TRAIN_STEPS)
    resumed = create_task(opt)
    check(resumed.resume("latest") == TRAIN_STEPS, f"{what}resume step")
    want = task.train_step(batches[TRAIN_STEPS])
    got = resumed.train_step(batches[TRAIN_STEPS])
    ckpt_rel = rel_diff(got, want)
    print(f"{what}checkpoint save/resume at step {TRAIN_STEPS}: next-step "
          f"losses within {ckpt_rel:.3e} rel (bound {CKPT_REL:g})")
    check(ckpt_rel <= CKPT_REL, f"{what}resumed step {got} vs {want}")
    return counts, times, plain_times, peak


def phase_train():
    """The full-width pose training step (D then G) through the kernels."""
    from gfla_tpu_torch.tasks import create_task

    opt, ckpt = train_opt("--name=train_smoke")
    task = create_task(opt)
    check(task.net_g.source.block0.model[2].out_channels == 64
          and task.net_d.block0.model[1].weight_orig.shape[0] == 32
          and task.net_d.layers == 4, "not the full-width train config")
    lrs = {"G": opt.lr, "D": opt.lr * opt.ratio_g2d}
    batches = [task.prepare_batch(deepfashion_batch(100 + s))
               for s in range(TRAIN_STEPS + 1)]
    state0 = copy.deepcopy(task)
    counts, times, plain_times, peak = train_main_path(
        task, opt, batches, "", warp_fwd=2 * TRAIN_STEPS,
        warp_bwd_pos=2 * TRAIN_STEPS, warp_bwd_w1=2 * TRAIN_STEPS)
    del task
    ckpt.cleanup()

    # one step from one state: kernel vs plain path; card vs CPU
    state = off_the_kinks(state0)
    del state0
    exact = compare_steps("kernel vs plain path, batch 8 at 256x256", state,
                          batches[0], lrs)
    exact = {tag: {n: g.cpu() for n, g in d.items()}
             for tag, d in exact.items()}
    small = state.prepare_batch(deepfashion_batch(7, B=2, size=64,
                                                  content_w=44))
    compare_steps("card vs CPU at 2x64x64", state, small, lrs, to_cpu=True)

    ms = statistics.median(times[1:])
    plain_ms = statistics.median(plain_times)
    print(f"train step batch 8 at 256x256: kernel path {ms:.3f} ms (steps "
          f"{', '.join(f'{t:.1f}' for t in times)}), plain path "
          f"{plain_ms:.3f} ms (steps "
          f"{', '.join(f'{t:.1f}' for t in plain_times)}), "
          f"peak {peak:.2f} GiB")
    return dict(counts=counts, state=state, batch=batches[0], ms=ms,
                peak=peak, exact=exact)


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    na, nb = a.norm().item(), b.norm().item()
    return (a @ b).item() / (na * nb) if na and nb else 0.0


def grads_by_rule(what, kernel, plain, f32, resolved=None,
                  hold=BF16_STEP_HOLD, one_element=True, l2=None,
                  loose=None, to_f32=False):
    """One step's gradients on the kernel path against the plain bf16 path
    directly, each tensor by its cosine and norm ratio and each network by
    its concatenated cosine (BF16_STEP_HOLD), the flow net's and the
    attention's printed apart; and both against the f32 step's by the bf16
    rule's first clause on each network's mean over tensors. A tensor whose
    f32 gradient is rounding only (a conv bias feeding an instance norm)
    is left out: of the direct hold where its f32 gradient's norm is below
    1e-2 of the plain path's, of the mean where its max is below 1e-5 of
    the network's. With `resolved`, a cosine: a tensor outside the direct
    hold whose gradient bf16 does not resolve, the plain bf16 path's own at
    a cosine below `resolved` with the f32 step's, is held by the bf16
    rule's first clause on its own instead (the kernel path's max error
    against the f32 gradient at most 2x the plain path's + BF16_SLACK x its
    max): two bf16 computations of a gradient that bf16 rounding dominates
    need not point alike. `hold`: the floors and bands by network; without
    `one_element`, a tensor of one element (its cosine is only its sign) is
    held in the network's cosine and mean only, and so is every tensor
    whose name `loose` (a compiled pattern) matches; with `l2` (BF16_L2),
    each tensor of the direct hold that the plain path resolves is also
    held by its L2 distance to the f32 gradient. With `to_f32`, a tensor
    outside the direct hold passes if the same floor and band hold the
    kernel path's gradient against the f32 step's (two bf16 computations
    that sum a gradient over the image in different parts, as bands do,
    round it apart; each is held to f32 then), its readings printed."""
    for tag in f32:
        grads = {side: s[tag]["grads"] for side, s in (
            ("f32", f32), ("kernel", kernel), ("plain", plain))}
        scale = max(g.abs().max().item() for g in grads["f32"].values())
        rows, errs = {}, []
        for name, g32 in grads["f32"].items():
            gk, gp = grads["kernel"][name], grads["plain"][name]
            if g32.abs().max().item() > 1e-5 * scale:
                top = g32.abs().max().item()
                errs.append([(g - g32).abs().max().item() / top
                             for g in (gk, gp)])
            if g32.norm().item() > 1e-2 * gp.norm().item() and (
                    gk.norm().item() or gp.norm().item()) and (
                    one_element or g32.numel() > 1) and not (
                    loose and loose.search(name)):
                rows[name] = (cosine(gk, gp),
                              gk.norm().item() / max(gp.norm().item(), 1e-30),
                              (gk - gp).abs().max().item()
                              / max(gp.abs().max().item(), 1e-30))
        groups = {"flow net": [n for n in rows if n.startswith("flow_net.")],
                  "attention": [n for n in rows if ".attn" in n],
                  "all": list(rows)}
        for group, names in groups.items():
            if not names:
                continue
            cos = [rows[n][0] for n in names]
            ratio = [rows[n][1] for n in names]
            print(f"{what}: {tag} {group} gradients, kernel vs plain path, "
                  f"{len(names)} tensors: cosine min {min(cos):.5f} "
                  f"({min(names, key=lambda n: rows[n][0])}) median "
                  f"{statistics.median(cos):.5f}, norm ratio "
                  f"{min(ratio):.4f}-{max(ratio):.4f}, max error up to "
                  f"{max(rows[n][2] for n in names):.3e} of the plain "
                  f"path's max")
        floor, whole_floor, band = hold[tag]
        bad = [(n, *rows[n][:2]) for n in rows
               if rows[n][0] < floor or not band[0] <= rows[n][1] <= band[1]]
        for name, c_kernel, ratio in list(bad):
            g32 = grads["f32"][name]
            gk, gp = grads["kernel"][name], grads["plain"][name]
            plain_ratio = gp.norm().item() / max(g32.norm().item(), 1e-30)
            if to_f32:
                c32 = cosine(gk, g32)
                r32 = gk.norm().item() / max(g32.norm().item(), 1e-30)
                print(f"{what}: {tag} {name}: against the other path at "
                      f"cosine {c_kernel:.4f}, norm ratio {ratio:.4f}; "
                      f"against the f32 gradient at cosine {c32:.4f}, norm "
                      f"ratio {r32:.4f} (the other path {cosine(gp, g32):.4f}"
                      f", {plain_ratio:.4f})")
                if c32 >= floor and band[0] <= r32 <= band[1]:
                    bad.remove((name, c_kernel, ratio))
                    continue
            if resolved is None or cosine(gp, g32) >= resolved:
                continue
            top = g32.abs().max().item()
            e_k, e_p = ((g - g32).abs().max().item() / top for g in (gk, gp))
            print(f"{what}: {tag} {name}: kernel vs plain path at cosine "
                  f"{c_kernel:.4f}, norm ratio {ratio:.4f}; bf16 does not "
                  f"resolve it (cosine with the f32 gradient "
                  f"{cosine(gp, g32):.4f} on the plain path, "
                  f"{cosine(gk, g32):.4f} on the kernel path; norm "
                  f"{plain_ratio:.4f} and "
                  f"{gk.norm().item() / max(g32.norm().item(), 1e-30):.4f} "
                  f"x the f32 one's); off the f32 "
                  f"gradient by {e_k:.3e} (kernel path) and {e_p:.3e} (plain "
                  f"path) of its max")
            if e_k <= 2 * e_p + BF16_SLACK:
                bad.remove((name, c_kernel, ratio))
        check(not bad, f"{what}: {tag} gradients unheld {bad}")
        if l2 is not None:
            dist = {}
            for name in rows:
                g32 = grads["f32"][name]
                top = g32.norm().item()
                d_k, d_p = ((grads[side][name] - g32).norm().item() / top
                            for side in ("kernel", "plain"))
                if d_p <= l2[0]:
                    dist[name] = (d_k, d_p)
            if dist:
                worst = max(dist, key=lambda n: dist[n][0] - 2 * dist[n][1])
                print(f"{what}: {tag} L2 to the f32 gradient, {len(dist)} "
                      f"tensors the plain path resolves: the kernel path's "
                      f"less 2x the plain path's at most "
                      f"{dist[worst][0] - 2 * dist[worst][1]:.3e} of the "
                      f"norm ({worst}: {dist[worst][0]:.3e} and "
                      f"{dist[worst][1]:.3e}; bound {l2[1]:g})")
            far = [(n, *d) for n, d in dist.items() if d[0] > 2 * d[1] + l2[1]]
            check(not far, f"{what}: {tag} gradients off f32 in L2 {far}")
        whole = cosine(*(torch.cat([grads[side][n].flatten() for n in rows])
                         for side in ("kernel", "plain")))
        print(f"{what}: {tag} whole network cosine {whole:.6f} (floor "
              f"{whole_floor}, tensor floor {floor}, band {band[0]:.3f}-"
              f"{band[1]:.3f}; {len(grads['f32']) - len(rows)} tensors of "
              f"rounding only left out)")
        check(whole >= whole_floor, f"{what}: {tag} whole cosine {whole}")
        e_kernel, e_plain = np.mean(errs, axis=0)
        print(f"{what}: {tag} gradients off the f32 step's by "
              f"{e_kernel:.3e} (kernel path) and {e_plain:.3e} (plain path) "
              f"of each tensor's max, mean over {len(errs)} tensors")
        check(e_kernel <= 2 * e_plain + BF16_SLACK,
              f"{what}: {tag} gradients {e_kernel:.3e} vs {e_plain:.3e}")


def phase_train_bf16(train):
    """Four full-width batch-8 pose steps under --compute_dtype=bfloat16
    through the bf16 warp kernels (train_main_path's checks, 2 launches of
    each bf16 kernel a step); one step on the kernel path against the plain
    bf16 path from one state, both against the f32 step; ms per step and
    peak memory beside the f32 step's of phase_train. Returns the counts,
    and the state, batch and f32 step's snapshot for attn_bf16_step."""
    from gfla_tpu_torch.tasks import create_task

    opt, ckpt = train_opt("--compute_dtype=bfloat16", "--name=train_bf16")
    task = create_task(opt)
    check(task.vgg.conv1_1.weight.dtype == torch.bfloat16,
          "bf16: VGG19 not cast once at set-up")
    batches = [task.prepare_batch(deepfashion_batch(200 + s))
               for s in range(TRAIN_STEPS + 1)]
    state0 = copy.deepcopy(task)
    counts, times, plain_times, peak = train_main_path(
        task, opt, batches, "bf16 ", warp_fwd_bf16=2 * TRAIN_STEPS,
        warp_bwd_pos_bf16=2 * TRAIN_STEPS, warp_bwd_w1_bf16=2 * TRAIN_STEPS)
    del task
    ckpt.cleanup()

    # one step from one state: kernel vs plain bf16 path, both vs f32
    state = off_the_kinks(state0)
    del state0
    f32 = copy.deepcopy(state)
    f32.dtype = torch.float32
    f32.vgg.float()
    f32.train_step(batches[0])
    snap32 = snapshot(f32)
    del f32
    sides = []
    for path in (contextlib.nullcontext, plain_warp):
        side = copy.deepcopy(state)
        with path():
            side_logs = side.train_step(batches[0])
        sides.append((side_logs, snapshot(side)))
        del side
    loss_rel = rel_diff(sides[0][0], sides[1][0])
    print(f"bf16 kernel vs plain path, batch 8 at 256x256: losses within "
          f"{loss_rel:.3e} rel (bound {BF16_LOSS_REL:g})")
    check(loss_rel <= BF16_LOSS_REL, f"bf16 step losses {sides}")
    grads_by_rule("bf16 kernel vs plain path", sides[0][1], sides[1][1],
                  snap32)
    del sides

    ms = statistics.median(times[1:])
    print(f"bf16 train step batch 8 at 256x256: kernel path {ms:.3f} ms "
          f"(steps {', '.join(f'{t:.1f}' for t in times)}), plain bf16 path "
          f"{statistics.median(plain_times):.3f} ms, peak {peak:.2f} GiB; "
          f"f32 step {train['ms']:.3f} ms, peak {train['peak']:.2f} GiB "
          f"(phase_train)")
    return dict(counts=counts, state=state, batch=batches[0], snap32=snap32,
                peak=peak)


def phase_poseflownet():
    """Stage-1 flow pretraining at full width with GFLA_PALLAS_CORR=1, and
    the two-stage protocol from its checkpoint."""
    from gfla_tpu_torch.options import TrainOptions
    from gfla_tpu_torch.tasks import create_task

    ckpt = tempfile.TemporaryDirectory()
    common = ["--dataset_mode=synthetic", "--load_size=256", "--batchSize=8",
              "--gpu_ids=0", f"--checkpoints_dir={ckpt.name}",
              "--name=flow_smoke"]
    opt = TrainOptions().parse(["--model=poseflownet", *common], save=False)
    opt.iters_per_epoch = 1000
    task = create_task(opt)
    fn = task.net_g.flow_net
    check(fn.block0.model[2].out_channels == 32 and fn.encoder_layer == 5
          and fn.encoder3.model[5].out_channels == 256,
          "not the full-width flow net")
    print(f"poseflownet: {sum(p.numel() for p in task.net_g.parameters())} "
          f"parameters")
    batches = [task.prepare_batch(deepfashion_batch(200 + s))
               for s in range(TRAIN_STEPS)]
    state0 = copy.deepcopy(task)
    s0 = snapshot(state0)

    # the main path: TRAIN_STEPS steps through the max-correlation kernel
    with switches(GFLA_PALLAS_CORR="1"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        times, logs = timed_steps(task, batches)
        torch.cuda.synchronize()
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"poseflownet trained {TRAIN_STEPS} steps: kernel launches {counts}")
    check(only(counts, max_corr=2 * TRAIN_STEPS),
          f"launches {counts}, expected 2 max_corr per step and nothing else")
    for i, step_logs in enumerate(logs):
        check(sorted(step_logs) == sorted(task.loss_names + ["total_G"]),
              f"loss names {sorted(step_logs)}")
        for name, v in step_logs.items():
            check(bool(torch.isfinite(v)), f"step {i + 1}: {name} not finite")
    for i in (0, TRAIN_STEPS - 1):
        print(f"poseflownet losses, step {i + 1}: " + " ".join(
            f"{k} {float(v):.5f}" for k, v in logs[i].items()))
    params = dict(task.net_g.named_parameters())
    unreached = sorted(n for n, p in params.items() if p.grad is None)
    still = [n for n, p in params.items()
             if n not in unreached and torch.equal(p, s0["G"]["params"][n])]
    check(not still, f"parameters unchanged: {still}")
    check(all(n.startswith("flow_net.mask") for n in unreached)
          and all(torch.equal(params[n], s0["G"]["params"][n])
                  for n in unreached),
          f"parameters without a gradient: {unreached}")
    print(f"every parameter the losses reach moved; the {len(unreached)} of "
          f"the mask heads, which no stage-1 loss reaches, did not")
    flows, masks = task.test_step(batches[0])
    check([tuple(f.shape) for f in flows] == [(8, 2, 32, 32), (8, 2, 64, 64)]
          and all(bool(torch.isfinite(f).all()) for f in flows + masks),
          "test_step flows")

    with switches(GFLA_PALLAS_CORR="0"):
        plain = copy.deepcopy(task)
        plain_times, _ = timed_steps(plain, batches[1:])
        del plain

    # the two-stage protocol: stage 2 resumes the stage-1 directory
    task.save(TRAIN_STEPS)
    pose_opt = TrainOptions().parse(["--model=pose", "--continue_train",
                                     *common], save=False)
    pose = create_task(pose_opt)
    init = {n: t.clone() for n, t in pose.net_g.state_dict().items()}
    check(pose.resume(pose_opt.which_iter) == TRAIN_STEPS
          and pose.step == TRAIN_STEPS, "stage 2 did not keep the step")
    saved = task.net_g.state_dict()
    got = pose.net_g.state_dict()
    flow_keys = [n for n in got if n.startswith("flow_net.")]
    check(len(flow_keys) == len(saved)
          and all(torch.equal(got[n], saved[n]) for n in flow_keys),
          "stage 2's flow net is not the saved one")
    check(all(torch.equal(got[n], init[n]) for n in got
              if not n.startswith("flow_net.")),
          "stage 2's source and target nets are not at their init")
    check(not pose.opt_g.state, "stage 2's optimizer is not fresh")
    print(f"two-stage: pose --continue_train loaded the {len(flow_keys)} "
          f"flow_net tensors at step {pose.step}; the other "
          f"{len(got) - len(flow_keys)} kept their init")
    del pose
    ckpt.cleanup()

    state = off_the_kinks(state0)
    del state0
    flips = correctness_flips(state, batches[0])
    print("poseflownet max-correlation, kernel vs scan: argmax differs at "
          + ", ".join(f"{n}: {f} of {r} rows (top two within {g:.3e})"
                      for n, (r, f, g) in flips.items())
          + f", every such row a near-tie (within {CORR_ATOL:g}); the "
          "argmax does not reach this step's gradients (the VGG features "
          "are constants), and the scan below is given the kernel's")
    compare_steps("poseflownet kernel vs scan path, batch 8 at 256x256",
                  state, batches[0], {"G": opt.lr},
                  path_a=(deterministic,
                          lambda: switches(GFLA_PALLAS_CORR="1")),
                  path_b=(deterministic, kernel_argmax),
                  grad_rel=FLOW_GRAD_F64_REL, pair_rel=FLOW_PAIR_REL)
    ms = statistics.median(times[1:])
    plain_ms = statistics.median(plain_times)
    print(f"poseflownet step batch 8 at 256x256: kernel path {ms:.3f} ms "
          f"(steps {', '.join(f'{t:.1f}' for t in times)}), scan path "
          f"{plain_ms:.3f} ms (steps "
          f"{', '.join(f'{t:.1f}' for t in plain_times)}), peak "
          f"{peak:.2f} GiB")
    return counts


def rel_diff(logs_a, logs_b):
    return max(abs(float(logs_a[n]) - float(logs_b[n]))
               / max(abs(float(logs_b[n])), 1e-30) for n in logs_b)


def attention_outputs(task, request):
    """The served image and the output of each ExtractorAttn in it."""
    from gfla_tpu_torch.nn.attention import ExtractorAttn

    outs = []
    hooks = [m.register_forward_hook(lambda mod, args, out: outs.append(out))
             for m in task.net_g.modules() if isinstance(m, ExtractorAttn)]
    img = task.test_step(request)[0]
    for h in hooks:
        h.remove()
    return img, outs


def phase_switches(serve, train, train_bf16):
    """The pose head under GFLA_ATTN_PALLAS=1 and under GFLA_PALLAS_CORR=1:
    the kernels each selects, launched on its path, against the default
    (warp, scan) path."""
    task, request = serve["task"], serve["request"]
    want_img, want_attn = attention_outputs(task, request)
    with switches(GFLA_ATTN_PALLAS="1"):
        reset_launch_counts()
        img, got_attn = attention_outputs(task, request)
        torch.cuda.synchronize()
        serve_counts = launch_counts()
        ms = cuda_ms(lambda: task.test_step(request), iters=10)
    diff = (img - want_img).abs().max().item()
    attn_rel = max((a - b).abs().max().item() / b.abs().max().item()
                   for a, b in zip(got_attn, want_attn))
    print(f"GFLA_ATTN_PALLAS=1 serving: launches {serve_counts}; image vs the "
          f"warp path max_abs_diff={diff:.3e} (bound {SLICE_ATOL:g}); both "
          f"ExtractorAttn outputs within {attn_rel:.3e} x their max (bound "
          f"{BWD_REL:g}); {ms:.3f} ms per batch-8 forward")
    check(only(serve_counts, attn_math_fwd=2),
          f"launches {serve_counts}, expected 2 attn_math_fwd, no warp")
    check(diff <= SLICE_ATOL, f"attn-math serving vs warp {diff:.3e}")
    check(len(got_attn) == 2 and attn_rel <= BWD_REL,
          f"ExtractorAttn outputs {attn_rel:.3e} apart")

    state, batch = train["state"], train["batch"]
    want = copy.deepcopy(state).train_step(batch)  # the default path
    counts, rel, ms = {}, {}, {}
    for name, env in (("attn", dict(GFLA_ATTN_PALLAS="1")),
                      ("corr", dict(GFLA_PALLAS_CORR="1"))):
        task = copy.deepcopy(state)
        with switches(**env):
            reset_launch_counts()
            got = task.train_step(batch)
            torch.cuda.synchronize()
            counts[name] = launch_counts()
            times, _ = timed_steps(task, [batch] * 3)
        rel[name] = rel_diff(got, want)
        ms[name] = statistics.median(times)
        del task
        print(f"{env} pose training step: launches {counts[name]}; losses "
              f"within {rel[name]:.3e} rel of the default path (bound "
              f"{TRAIN_LOSS_REL:g}); {ms[name]:.3f} ms per step (steps "
              f"{', '.join(f'{t:.1f}' for t in times)})")
        check(rel[name] <= TRAIN_LOSS_REL, f"{env}: losses {got} vs {want}")
    check(only(counts["attn"], attn_math_fwd=2, attn_math_bwd=2),
          f"GFLA_ATTN_PALLAS=1 launches {counts['attn']}")
    check(only(counts["corr"], warp_fwd=2, warp_bwd_pos=2, warp_bwd_w1=2,
               max_corr=2), f"GFLA_PALLAS_CORR=1 launches {counts['corr']}")
    return dict(serve_attn=serve_counts, train_attn=counts["attn"],
                train_corr=counts["corr"],
                train_attn_bf16=attn_bf16_step(train_bf16),
                train_kernel_size=kernel_size_step())


def attn_bf16_step(train_bf16):
    """One full-width batch-8 pose step under --compute_dtype=bfloat16 and
    GFLA_ATTN_PALLAS=1 through the bf16 attention-math kernels (2 launches
    of each, nothing else), against that route's plain bf16 path from
    phase_train_bf16's state and batch: losses within BF16_LOSS_REL,
    gradients by BF16_STEP_HOLD and both paths against phase_train_bf16's
    f32 step by the bf16 rule (grads_by_rule; the f32 step ran the f32 warp
    kernels, the same function in f32); the kernel path's peak memory."""
    state = train_bf16.pop("state")
    batch = train_bf16.pop("batch")
    snap32 = train_bf16.pop("snap32")
    sides = []
    with switches(GFLA_ATTN_PALLAS="1"):
        for path in (contextlib.nullcontext, plain_attn_math):
            side = copy.deepcopy(state)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            with path():
                t0 = time.perf_counter()
                side_logs = side.train_step(batch)
                torch.cuda.synchronize()
                step_s = time.perf_counter() - t0
            sides.append((side_logs, snapshot(side), launch_counts(), step_s,
                          torch.cuda.max_memory_allocated() / 2**30))
            del side
    del state
    counts = sides[0][2]
    loss_rel = rel_diff(sides[0][0], sides[1][0])
    print(f"bf16 GFLA_ATTN_PALLAS=1 pose step, batch 8 at 256x256: launches "
          f"{counts}; losses within {loss_rel:.3e} rel of the plain bf16 "
          f"path (bound {BF16_LOSS_REL:g}); first step {sides[0][3]:.3f} s "
          f"(plain path {sides[1][3]:.3f} s); peak {sides[0][4]:.2f} GiB "
          f"(plain path {sides[1][4]:.2f} GiB; the warp route's bf16 step "
          f"{train_bf16['peak']:.2f} GiB, phase_train_bf16)")
    check(only(counts, attn_math_fwd_bf16=2, attn_math_bwd_bf16=2),
          f"bf16 GFLA_ATTN_PALLAS=1 step launches {counts}")
    check(only(sides[1][2]), f"the plain bf16 GFLA_ATTN_PALLAS=1 step "
          f"launched {sides[1][2]}")
    check(loss_rel <= BF16_LOSS_REL, f"bf16 GFLA_ATTN_PALLAS=1 step losses "
          f"{sides[0][0]} vs {sides[1][0]}")
    grads_by_rule("bf16 GFLA_ATTN_PALLAS=1 kernel vs plain path",
                  sides[0][1], sides[1][1], snap32)
    return counts


def kernel_size_step():
    """One full-width batch-8 f32 pose step at --kernel_size 2=4,3=9 (k=4
    on 64x64x128, k=9 on 32x32x256: the warp kernels' run-time instance)
    through the warp kernels (2 launches of each), against the plain path
    from one state by phase 6's rule (compare_steps)."""
    from gfla_tpu_torch.tasks import create_task

    opt, ckpt = train_opt("--kernel_size=2=4,3=9", "--name=kernel_size")
    state = create_task(opt)
    g = state.net_g
    check(g.target.attn1.kernel_size == 4 and g.target.attn0.kernel_size == 9,
          f"--kernel_size 2=4,3=9 gave {g.target.attn1.kernel_size}, "
          f"{g.target.attn0.kernel_size}")
    lrs = {"G": opt.lr, "D": opt.lr * opt.ratio_g2d}
    state = off_the_kinks(state)
    batch = state.prepare_batch(deepfashion_batch(400))
    task = copy.deepcopy(state)
    reset_launch_counts()
    t0 = time.perf_counter()
    logs = task.train_step(batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counts = launch_counts()
    del task
    print(f"--kernel_size 2=4,3=9 pose step, batch 8 at 256x256: launches "
          f"{counts}; losses " + " ".join(f"{n} {float(v):.5f}"
                                          for n, v in logs.items())
          + f"; first step {step_s:.3f} s")
    check(only(counts, warp_fwd=2, warp_bwd_pos=2, warp_bwd_w1=2),
          f"--kernel_size 2=4,3=9 launches {counts}")
    check(all(bool(torch.isfinite(v)) for v in logs.values()),
          f"--kernel_size 2=4,3=9: losses {logs}")
    compare_steps("--kernel_size 2=4,3=9 kernel vs plain path, batch 8 at "
                  "256x256", state, batch, lrs)
    ckpt.cleanup()
    return counts


WIDE_KERNEL_SIZE = "--kernel_size=2=11,3=13"  # the wide instances' step


def phase_wide_kernel_size():
    """The pose head at --kernel_size 2=11,3=13 (k=11 on 64x64x128, k=13 on
    32x32x256: the warp kernels' wide instances) at full width, batch 8,
    from one state off the kinks: one f32 D-then-G step through the wide
    f32 kernels (2 launches of each, nothing else) against the plain path
    by phase 6's rule (compare_steps); four served 256x176 requests from
    the stepped task (2 wide forward launches each, nothing else), shape,
    range, and the first against the plain path; under GFLA_ATTN_PALLAS=1
    one request and one step through the attention-math kernels at k=11
    and 13 (2 launches of each) against the warp route; one bf16 step
    (--compute_dtype=bfloat16: the bf16 wide kernels, 2 launches of each,
    nothing else) against the plain bf16 path by phase 6b's hold (losses
    BF16_LOSS_REL, grads_by_rule against the f32 step). Returns the counts
    by path."""
    from gfla_tpu_torch.tasks import create_task

    opt, ckpt = train_opt(WIDE_KERNEL_SIZE, "--name=kernel_size_wide")
    state = create_task(opt)
    g = state.net_g
    check(g.target.attn1.kernel_size == 11
          and g.target.attn0.kernel_size == 13,
          f"{WIDE_KERNEL_SIZE} gave {g.target.attn1.kernel_size}, "
          f"{g.target.attn0.kernel_size}")
    lrs = {"G": opt.lr, "D": opt.lr * opt.ratio_g2d}
    state = off_the_kinks(state)
    batch = state.prepare_batch(deepfashion_batch(410))
    what = f"{WIDE_KERNEL_SIZE} pose step, batch 8 at 256x256"
    compare_steps(f"{what}, kernel vs plain path", state, batch, lrs)
    ckpt.cleanup()

    counts = {}
    task = copy.deepcopy(state)
    reset_launch_counts()
    t0 = time.perf_counter()
    logs = task.train_step(batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counts["train_kernel_size_wide"] = launch_counts()
    snap32 = snapshot(task)
    print(f"{what}: launches {counts['train_kernel_size_wide']}; losses "
          + " ".join(f"{n} {float(v):.5f}" for n, v in logs.items())
          + f"; first step {step_s:.3f} s")
    check(only(counts["train_kernel_size_wide"], warp_fwd_wide=2,
               warp_bwd_pos_wide=2, warp_bwd_w1_wide=2),
          f"{what}: launches {counts['train_kernel_size_wide']}")
    check(all(bool(torch.isfinite(v)) for v in logs.values()),
          f"{what}: losses {logs}")

    requests = [state.prepare_batch(deepfashion_batch(420 + s))
                for s in range(4)]
    reset_launch_counts()
    outs = [task.test_step(r)[0] for r in requests]
    torch.cuda.synchronize()
    counts["serve_kernel_size_wide"] = launch_counts()
    for img in outs:
        check(tuple(img.shape) == (8, 3, 256, 256)
              and bool(torch.isfinite(img).all())
              and img.min().item() >= -1 and img.max().item() <= 1,
              f"{WIDE_KERNEL_SIZE} serving: image {tuple(img.shape)}")
    with plain_warp():
        plain_img = task.test_step(requests[0])[0]
    diff = (outs[0] - plain_img).abs().max().item()
    with switches(GFLA_ATTN_PALLAS="1"):
        reset_launch_counts()
        attn_img = task.test_step(requests[0])[0]
        torch.cuda.synchronize()
        counts["serve_kernel_size_wide_attn"] = launch_counts()
    attn_diff = (attn_img - outs[0]).abs().max().item()
    print(f"{WIDE_KERNEL_SIZE} served {len(requests)} batch-8 requests: "
          f"launches {counts['serve_kernel_size_wide']}; the first against "
          f"the plain path max_abs_diff={diff:.3e}, under "
          f"GFLA_ATTN_PALLAS=1 (launches "
          f"{counts['serve_kernel_size_wide_attn']}) {attn_diff:.3e} (bound "
          f"{SLICE_ATOL:g})")
    check(only(counts["serve_kernel_size_wide"], warp_fwd_wide=8),
          f"{WIDE_KERNEL_SIZE} serving launches "
          f"{counts['serve_kernel_size_wide']}")
    check(only(counts["serve_kernel_size_wide_attn"], attn_math_fwd=2),
          f"{WIDE_KERNEL_SIZE} GFLA_ATTN_PALLAS=1 serving launches "
          f"{counts['serve_kernel_size_wide_attn']}")
    check(diff <= SLICE_ATOL and attn_diff <= SLICE_ATOL,
          f"{WIDE_KERNEL_SIZE} serving: {diff:.3e}, {attn_diff:.3e}")
    del task, outs

    attn = copy.deepcopy(state)
    with switches(GFLA_ATTN_PALLAS="1"):
        reset_launch_counts()
        attn_logs = attn.train_step(batch)
        torch.cuda.synchronize()
        counts["train_kernel_size_wide_attn"] = launch_counts()
    del attn
    attn_rel = rel_diff(attn_logs, logs)
    print(f"{what} under GFLA_ATTN_PALLAS=1: launches "
          f"{counts['train_kernel_size_wide_attn']}; losses within "
          f"{attn_rel:.3e} rel of the warp route (bound {TRAIN_LOSS_REL:g})")
    check(only(counts["train_kernel_size_wide_attn"], attn_math_fwd=2,
               attn_math_bwd=2) and attn_rel <= TRAIN_LOSS_REL,
          f"{what} under GFLA_ATTN_PALLAS=1: "
          f"{counts['train_kernel_size_wide_attn']}, {attn_rel:.3e}")

    # bf16: the same state in bf16, kernel path against the plain bf16 path
    state.dtype = torch.bfloat16
    state.vgg.to(torch.bfloat16)
    sides = []
    for path in (contextlib.nullcontext, plain_warp):
        side = copy.deepcopy(state)
        reset_launch_counts()
        with path():
            side_logs = side.train_step(batch)
        torch.cuda.synchronize()
        sides.append((side_logs, snapshot(side), launch_counts()))
        del side
    del state
    counts["train_kernel_size_wide_bf16"] = sides[0][2]
    loss_rel = rel_diff(sides[0][0], sides[1][0])
    print(f"{what} in bf16: launches {sides[0][2]}; kernel vs plain bf16 "
          f"path losses within {loss_rel:.3e} rel (bound {BF16_LOSS_REL:g})")
    check(only(sides[0][2], warp_fwd_wide_bf16=2, warp_bwd_pos_wide_bf16=2,
               warp_bwd_w1_wide_bf16=2) and only(sides[1][2]),
          f"{what} in bf16: launches {sides[0][2]}, plain {sides[1][2]}")
    check(loss_rel <= BF16_LOSS_REL, f"{what} in bf16: losses {sides}")
    grads_by_rule(f"{what} in bf16, kernel vs plain path", sides[0][1],
                  sides[1][1], snap32)
    return counts


DP_STEPS = 2      # (a): steps taken with the group of one and without it
DP_TIMED = 5      # (a): kernel-path steps timed each way
DP_RANKS = 2      # (c): ranks, where the machine has the cards
DP_TIMEOUT = 300  # (c): seconds the spawned ranks may take, build included
DP_SGD_LR = 1e-3  # (c): SGD in place of Adam, so that the step is the grad
# (c): gfla_tpu's 8-vs-1 device rule (tests/test_train.py:148-208): under
# DP_SHARE of a network's entries more than DP_DIVERGE x its largest
# |gradient| apart, none more than DP_WORST
DP_DIVERGE, DP_SHARE, DP_WORST = 2e-4, 0.005, 0.1


def torchrun_env():
    """torchrun's variables for a world of one on this host, a fresh
    port."""
    from gfla_tpu_torch.parallel import free_port

    return dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(free_port()))


def replica_state(task):
    """Parameters, buffers (spectral-norm u) and Adam state of the task's
    networks."""
    out = {f"{tag}.{n}": t.detach().clone()
           for tag, net in nets(task).items()
           for n, t in (*net.named_parameters(), *net.named_buffers())}
    for tag in ("opt_g", "opt_d")[:1 + hasattr(task, "opt_d")]:
        for i, state in getattr(task, tag).state_dict()["state"].items():
            out.update({f"{tag}.{i}.{k}": v.clone()
                        for k, v in state.items() if torch.is_tensor(v)})
    return out


def sgd(task):
    """The task's Adams replaced by plain SGD (its step is then the
    gradient, as gfla_tpu's 8-vs-1 device test does)."""
    task.opt_g = torch.optim.SGD(task.net_g.parameters(), lr=DP_SGD_LR)
    if hasattr(task, "opt_d"):
        task.opt_d = torch.optim.SGD(
            [p for g in task.opt_d.param_groups for p in g["params"]],
            lr=DP_SGD_LR)
    return task


def dp_grads(task):
    """{net: {name: gradient}}, copied to the host."""
    return {tag: {n: p.grad.detach().to("cpu", copy=True)
                  for n, p in net.named_parameters() if p.grad is not None}
            for tag, net in nets(task).items()}


def dp_rank(device, state_path, out_dir):
    """(c)'s rank: the full-width pose task loaded from `state_path`, one
    SGD step on its block of the batch-8 batch, then DP_TIMED more, timed;
    its gradients, logs, launches and times to `out_dir`."""
    from gfla_tpu_torch import parallel
    from gfla_tpu_torch.runtime import set_tf32
    from gfla_tpu_torch.tasks import create_task

    set_tf32(False)
    at = parallel.world()
    opt, ckpt = train_opt("--name=dp_rank")
    task = create_task(opt, device)
    for tag, sd in torch.load(state_path, weights_only=True).items():
        nets(task)[tag].load_state_dict(sd)
    sgd(task)
    full = task.prepare_batch(deepfashion_batch(200))
    rows = full["P1"].shape[0] // at.size
    batch = {k: v[at.rank * rows:(at.rank + 1) * rows]
             for k, v in full.items()}
    reset_launch_counts()
    logs = parallel.allreduce_mean(task.train_step(batch))
    torch.cuda.synchronize()
    counts = launch_counts()
    grads = dp_grads(task)
    times, _ = timed_steps(task, [batch] * DP_TIMED)
    torch.save({"grads": grads, "counts": counts, "times": times,
                "rows": rows,
                "logs": {k: float(v) for k, v in logs.items()}},
               os.path.join(out_dir, f"rank{at.rank}.pt"))
    ckpt.cleanup()


def dp_rule(what, one, two):
    """gfla_tpu's 8-vs-1 device rule on one network's gradients; returns
    (share above DP_DIVERGE, max) for the line."""
    g1 = torch.cat([one[k].flatten() for k in sorted(one)]).double()
    g2 = torch.cat([two[k].flatten() for k in sorted(one)]).double()
    d = (g1 - g2).abs() / max(1e-6, g1.abs().max().item())
    share, worst = (d > DP_DIVERGE).double().mean().item(), d.max().item()
    check(one.keys() == two.keys() and share < DP_SHARE and worst < DP_WORST,
          f"{what}: {share:.4%} of entries above {DP_DIVERGE:g} of max "
          f"(bound {DP_SHARE:.1%}), max {worst:.3e} (bound {DP_WORST:g})")
    return share, worst


def phase_data_parallel(train):
    """10b. data parallel (gfla_tpu_torch.parallel) on phase 6's full-width
    pose task: (a) a world of one under NCCL (torchrun's variables, a free
    port): DP_TIMED kernel-path steps without a group and with one, timed,
    then one more with the group, untimed, in which allreduce_grads hands
    back every gradient bitwise as it took it; the all-reduce's own ms on
    G's and D's gradients; DP_STEPS steps with the
    group and DP_STEPS without, each on the plain path under deterministic
    algorithms (the warp backward's scatter adds in no fixed order), bitwise
    equal: every loss, parameter, spectral-norm u and Adam moment. (b) the
    training CLI's main with --distributed in a world of one: two steps,
    counted as path ddp_train (2 launches of each warp kernel a step, as
    train), one checkpoint set and loss log, the group left. (c) where the
    machine has DP_RANKS cards: DP_RANKS spawned ranks each take their 4
    rows of a batch-8 step with SGD in place of Adam, held to the one-rank
    step here by gfla_tpu's 8-vs-1 device rule, the ranks' gradients
    bitwise equal, then time DP_TIMED steps each; else a line says it did
    not run."""
    import gfla_tpu_torch.train.__main__ as train_cli
    from gfla_tpu_torch import parallel
    from gfla_tpu_torch.runtime import card_line

    device = torch.device("cuda", 0)
    state = train["state"]
    batches = [state.prepare_batch(deepfashion_batch(200 + s))
               for s in range(DP_STEPS)]
    check(not parallel.active(), "a process group before phase 10b")

    # (a) no group: the kernel path timed; the plain path's steps
    solo = copy.deepcopy(state)
    solo_ms, _ = timed_steps(solo, [batches[0]] * DP_TIMED)
    del solo
    plain = copy.deepcopy(state)
    with plain_warp(), deterministic():
        logs_solo = [plain.train_step(b) for b in batches]
    want = replica_state(plain)
    del plain

    # (a) a world of one
    with mock.patch.dict(os.environ, torchrun_env()):
        parallel.init_world(parallel.env_world(), device)
    try:
        check(parallel.active() and parallel.world().size == 1,
              "no world of one")
        grouped = copy.deepcopy(state)
        group_ms, _ = timed_steps(grouped, [batches[0]] * DP_TIMED)
        reduce = parallel.allreduce_grads
        calls, moved = [0], []

        def checked_reduce(params):
            params = list(params)
            before = [p.grad.clone() for p in params if p.grad is not None]
            reduce(params)
            after = [p.grad for p in params if p.grad is not None]
            calls[0] += 1
            moved.extend(i for i, (a, b) in enumerate(zip(before, after))
                         if not torch.equal(a, b))

        # one more step, untimed, with every all-reduce's output checked
        with mock.patch.object(parallel, "allreduce_grads", checked_reduce):
            grouped.train_step(batches[0])
        torch.cuda.synchronize()
        check(calls[0] == 2 and not moved,
              f"allreduce_grads: {calls[0]} calls in a step (2 expected), "
              f"{len(moved)} gradients changed")
        reduce_ms = {tag: cuda_ms(lambda net=net: reduce(net.parameters()))
                     for tag, net in nets(grouped).items()}
        grad_mb = {tag: sum(p.numel() for p in net.parameters()) * 4 / 1e6
                   for tag, net in nets(grouped).items()}
        del grouped
        plain = copy.deepcopy(state)
        with plain_warp(), deterministic():
            logs_group = [plain.train_step(b) for b in batches]
        got = replica_state(plain)
        del plain
    finally:
        parallel.close_world()
    same_logs = all(torch.equal(a[k], b[k]) for a, b in
                    zip(logs_group, logs_solo) for k in a)
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    moments = sum(k.endswith(("exp_avg", "exp_avg_sq")) for k in want)
    print(f"world of one under NCCL: {DP_STEPS} plain-path steps with the "
          f"group and without, deterministic: losses "
          f"{'bitwise equal' if same_logs else 'DIFFER'}; {len(want)} "
          f"tensors (parameters, u, {moments} Adam moments), "
          f"{len(differ)} differ; allreduce_grads handed back every kernel-"
          f"path gradient of a step bitwise in its {calls[0]} calls")
    check(same_logs and not differ and got.keys() == want.keys(),
          f"the world of one moved {differ[:8]}")
    print(f"pose step batch 8 at 256x256, kernel path: "
          f"{statistics.median(solo_ms[1:]):.3f} ms without a group, "
          f"{statistics.median(group_ms[1:]):.3f} ms in a world of one "
          f"(steps {', '.join(f'{t:.1f}' for t in solo_ms)}; "
          f"{', '.join(f'{t:.1f}' for t in group_ms)}); the all-reduce "
          + ", ".join(f"{tag} {reduce_ms[tag]:.3f} ms for {grad_mb[tag]:.1f} "
                      f"MB" for tag in reduce_ms))

    # (b) the training CLI, --distributed, in a world of one
    ckpt = tempfile.TemporaryDirectory()
    args = ["--distributed", "--model=pose", "--dataset_mode=synthetic",
            "--load_size=256", "--batchSize=8", "--gpu_ids=0",
            "--max_iters=2", "--print_freq=1", "--nThreads=0",
            f"--checkpoints_dir={ckpt.name}", "--name=ddp"]
    with mock.patch.dict(os.environ, torchrun_env()), \
            cli_run("--distributed training CLI") as lines:
        reset_launch_counts()
        check(train_cli.main(args) == 0, "--distributed: exit code")
        torch.cuda.synchronize()
        counts = launch_counts()
    run = os.path.join(ckpt.name, "ddp")
    with open(os.path.join(run, "loss_log.txt")) as f:
        logged = [line for line in f if line.startswith("(epoch:")]
    print(f"--distributed training CLI, world of one: 2 steps, kernel "
          f"launches {counts}; {len(logged)} loss lines")
    check(only(counts, warp_fwd=4, warp_bwd_pos=4, warp_bwd_w1=4),
          f"ddp_train launches {counts}, expected 2 of each warp kernel a "
          f"step")
    check(len(logged) == 2 and not parallel.active()
          and "training finished at iteration 2" in lines
          and all(os.path.exists(os.path.join(run, f"{tag}_net_G.pth"))
                  for tag in ("2", "latest")),
          f"--distributed: {len(logged)} loss lines, files "
          f"{sorted(os.listdir(run))}")
    ckpt.cleanup()

    # (c) DP_RANKS ranks, where there are the cards
    if torch.cuda.device_count() < DP_RANKS:
        print(f"data_parallel_{DP_RANKS}rank: not run "
              f"({torch.cuda.device_count()} card)")
        return {"ddp_train": counts}
    tmp = tempfile.TemporaryDirectory()
    state_path = os.path.join(tmp.name, "state.pt")
    torch.save({tag: net.state_dict() for tag, net in nets(state).items()},
               state_path)
    one = sgd(copy.deepcopy(state))
    one_logs = one.train_step(state.prepare_batch(deepfashion_batch(200)))
    want = dp_grads(one)
    one_ms, _ = timed_steps(one, [batches[0]] * DP_TIMED)
    del one
    parallel.spawn(dp_rank, [torch.device("cuda", i)
                             for i in range(DP_RANKS)],
                   state_path, tmp.name, timeout=DP_TIMEOUT)
    ranks = [torch.load(os.path.join(tmp.name, f"rank{r}.pt"),
                        weights_only=False) for r in range(DP_RANKS)]
    tmp.cleanup()
    for r in ranks[1:]:
        check(all(torch.equal(r["grads"][tag][n], g)
                  for tag, d in ranks[0]["grads"].items()
                  for n, g in d.items()), "the ranks' gradients differ")
    rules = {tag: dp_rule(f"{DP_RANKS} ranks vs 1, {tag}", want[tag],
                          ranks[0]["grads"][tag]) for tag in want}
    total_rel = abs(ranks[0]["logs"]["total_G"] - float(one_logs["total_G"])) \
        / abs(float(one_logs["total_G"]))
    check(total_rel <= 1e-4, f"total_G {total_rel:.3e} rel apart")
    for r, res in enumerate(ranks):
        check(only(res["counts"], warp_fwd=2, warp_bwd_pos=2, warp_bwd_w1=2),
              f"rank {r} launches {res['counts']}")
    print(f"data_parallel_{DP_RANKS}rank on {card_line()!r}: "
          f"{ranks[0]['rows']} rows a rank; "
          + "; ".join(f"{tag} {100 * s:.4f}% of entries above "
                      f"{DP_DIVERGE:g} of max, max {w:.3e}"
                      for tag, (s, w) in rules.items())
          + f"; total_G {total_rel:.3e} rel; SGD step ms per rank "
          + ", ".join(f"{statistics.median(r['times'][1:]):.3f}"
                      for r in ranks)
          + f" against {statistics.median(one_ms[1:]):.3f} on one card at "
            f"batch 8")
    return {"ddp_train": counts}



SP_SPLITS = (2, 4)  # (a): band splits of the window kernels' sites
# (a): the sites whose window kernels run, in f32: pose's two and
# ShapeNet's; in bf16 (SP_CASES_BF16) pose's two
SP_CASES = [c for c in KERNEL_CASES if c[0] in (
    "k=5 site 64x64 C128", "k=3 site 32x32 C256",
    "shapenet k=3 site 64x64 C128")]
# ... and the animation heads' sites at a frame's batch, B=2 (each stream's
# attention runs on one frame of a clip of 2 at a time), in f32 and bf16
SP_ANIM_CASES = [
    ("animation k=5 site 64x64 C128 B2", 2, 64, 64, 128, 128, 5, 1.5),
    ("animation k=3 site 32x32 C256 B2", 2, 32, 32, 256, 128, 3, 1.5)]
SP_CASES += SP_ANIM_CASES
SP_CASES_BF16 = SP_CASES[:2] + SP_ANIM_CASES
SP_HALO = 8         # --halo's default
SP_FAR_Y = 30.0     # (a): a flow row planted past the halo
SP_RANKS = (4, 2)   # (b): dp 2 x sp 2 on four cards, else dp 1 x sp 2
SP_TOTAL_REL = 2e-3  # (b): total_G, gfla_tpu's spatial rule
# (b): gfla_tpu's rule for its 2 x 4 spatial step against one device
# (tests/test_train.py:334-357): under SP_SHARE_1 of a network's entries
# more than 1e-3 x its largest |gradient| apart, under SP_SHARE_2 more than
# 1e-2
SP_SHARE_1, SP_SHARE_2 = 1e-4, 1e-6
SP_TIMEOUT = 300    # (b): seconds the spawned ranks may take
SP_ITERS = 20       # (b): launches of a timed collective, the same on all
SP_TIMED = 3        # (b): SGD steps timed on each rank and on one card
SP_PATHS = ("spatial_train", "spatial_train_remat", "spatial_train_shapenet",
            "spatial_train_corr", "spatial_train_bf16")  # (b)'s paths
# (b): the bf16 step under --spatial against one card's: BF16_STEP_HOLD,
# its norm bands widened by SP_BF16_ULP on each side. Each band rounds its
# partial sum of a parameter's gradient over its rows to bf16 once, before
# the ranks add the partials in f32, so a gradient's norm moves by up to
# bf16's unit roundoff against one card's, which rounds the whole sum once
# (BF16_STEP_HOLD's bands are readings of the kernel against the plain path
# on one card, where every such sum is rounded alike; D's is 1 +- 1e-3).
SP_BF16_ULP = 2 ** -8
SP_BF16_HOLD = {tag: (floor, whole, (band[0] - SP_BF16_ULP,
                                     band[1] + SP_BF16_ULP))
                for tag, (floor, whole, band) in BF16_STEP_HOLD.items()}


def window_rows(t, s, S, h):
    """Band s of S of `t` (B, H, ...) with h rows above and below, the
    image's first and last rows repeated past its edges: the window the
    port's halo exchange builds (parallel.pad_rows, replicate), cut here
    from the whole map."""
    H = t.shape[1]
    Hl = H // S
    rows = torch.arange(s * Hl - h, (s + 1) * Hl + h, device=t.device)
    return t[:, rows.clamp(0, H - 1)]


def as_band(s, S, h, whole):
    """A context in which `parallel.bands()` is band s of S (halo h) and
    `parallel.pad_rows` cuts that band's window from `whole`, the source's
    whole map (`window_rows`): `ops/local_attn._warp_window` then runs as
    band s's rank runs it, on one card, and the gradient of the window
    goes back into `whole`'s rows as the exchange's adjoint sends it."""
    from gfla_tpu_torch import parallel

    band = parallel.Bands(s, S, h)

    def pad_rows(x, top, bottom, mode="zeros", dim=2):
        Hl = whole.shape[1] // S
        check(x.shape[1] == Hl and (top, bottom, mode, dim)
              == (h, h, "replicate", 1), f"pad_rows: {x.shape[1]} rows of "
              f"a band of {Hl}, {top} and {bottom} rows, {mode}, dim {dim}")
        return window_rows(whole, s, S, h)

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(parallel, "bands", lambda: band))
    stack.enter_context(mock.patch.object(parallel, "pad_rows", pad_rows))
    return stack


def halo_attention(src, flow, hidden_bt, w1s, w2, b2, k, S, h, slope=0.1):
    """The warp's function on the whole map with gfla_tpu's halo-gather
    clamp (block_extract.py:124-147) for S bands of h halo rows, written
    out here: each band's taps clamped to the image, then to the band's
    rows - h ... + h, gathered from the whole map; the reference the
    bands are held to."""
    import torch.nn.functional as F

    B, H, W, C = src.shape
    Hl, D, k2 = H // S, w1s.shape[-1], k * k
    xs = torch.arange(W, device=src.device, dtype=flow.dtype)
    offs = torch.arange(k + 1, device=src.device) - k // 2
    outs = []
    for s in range(S):
        r0 = s * Hl
        ys = torch.arange(r0, r0 + Hl, device=src.device, dtype=flow.dtype)
        dy = flow[:, r0:r0 + Hl, :, 1] + ys[None, :, None]
        dx = flow[:, r0:r0 + Hl, :, 0] + xs[None, None, :]
        fy, fx = torch.floor(dy), torch.floor(dx)
        iy = (fy.long()[..., None] + offs).clamp(0, H - 1).clamp(
            r0 - h, r0 + Hl + h - 1)
        ix = (fx.long()[..., None] + offs).clamp(0, W - 1)
        flat = iy[..., :, None] * W + ix[..., None, :]
        patch = torch.gather(src.reshape(B, H * W, C), 1, flat.reshape(
            B, -1, 1).expand(-1, -1, C)).reshape(B, Hl, W, k + 1, k + 1, C)
        wy = (dy - fy)[..., None, None, None]
        wx = (dx - fx)[..., None, None, None]
        block = ((1 - wy) * (1 - wx) * patch[:, :, :, :k, :k]
                 + (1 - wy) * wx * patch[:, :, :, :k, 1:]
                 + wy * (1 - wx) * patch[:, :, :, 1:, :k]
                 + wy * wx * patch[:, :, :, 1:, 1:]).reshape(B, Hl * W, k2, C)
        hid = hidden_bt.reshape(B, H, W, D)[:, r0:r0 + Hl].reshape(
            B, Hl * W, D) + block.reshape(B, Hl * W, k2 * C) @ w1s
        attn = torch.softmax(F.leaky_relu(hid, slope) @ w2 + b2, -1)
        outs.append(((attn[..., None] * block).sum(2) / k2).reshape(
            B, Hl, W, C))
    return torch.cat(outs, 1)


def band_warp(args, g, k, S, h, s):
    """Band s of S of the warp route's `_warp_window` (ops/local_attn.py),
    on `args` (the whole map's source, flow, hidden_bt, w1s, w2, b2) under
    `as_band`, and its gradients under the cotangent `g`'s band: (the
    band's output, the gradients of BWD_OUTPUTS, the window's kernel
    arguments)."""
    from gfla_tpu_torch.ops import local_attn, warp

    src, flow, hidden_bt, w1s, w2, b2 = args
    B, H, W, C = src.shape
    Hl, D = H // S, hidden_bt.shape[-1]
    rows = slice(s * Hl, (s + 1) * Hl)
    leaves = [src, flow[:, rows], hidden_bt.reshape(B, H, W, D)[:, rows],
              w1s, w2, b2]
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    seen = []
    launch = warp.warp_fwd

    def spy(*a):
        seen.append([t.detach() for t in a[:6]])
        return launch(*a)

    with as_band(s, S, h, leaves[0]), \
            mock.patch.object(warp, "warp_fwd", spy):
        out = local_attn._warp_window(
            leaves[0][:, rows], leaves[1],
            leaves[2].reshape(B, Hl * W, D), *leaves[3:], k, 0.1)
        grads = torch.autograd.grad((out * g[:, rows]).sum(), leaves)
    check(len(seen) == 1 and seen[0][0].shape[1] == Hl + 2 * h,
          f"_warp_window launched {len(seen)} warps")
    return out.detach(), grads, seen[0]


class PlainAtKernelHpre(torch.autograd.Function):
    """The warp's plain twins as phase 4 holds the backward kernels to
    them: forward `warp_fwd_plain`, backward `warp_bwd_plain` from the
    forward kernel's hpre on the same inputs (a pre-activation within
    rounding of 0 would otherwise take LeakyReLU's other slope in one of
    the two)."""

    @staticmethod
    def forward(ctx, source, flow, hidden_bt, w1s, w2, b2, k, slope):
        from gfla_tpu_torch.ops import warp

        ctx.save_for_backward(source, flow, hidden_bt, w1s, w2, b2)
        ctx.k, ctx.slope = k, slope
        return warp.warp_fwd_plain(source, flow, hidden_bt, w1s, w2, b2, k,
                                   slope)

    @staticmethod
    def backward(ctx, g):
        from gfla_tpu_torch.ops import warp

        saved = ctx.saved_tensors
        _, hpre = warp.warp_fwd_with_hpre(*saved, ctx.k, ctx.slope)
        return (*warp.warp_bwd_plain(*saved, g.contiguous(), ctx.k,
                                     ctx.slope, hpre=hpre), None, None)


def spatial_windows(device):
    """(a) The warp route over row bands, `ops/local_attn._warp_window`
    itself (the warp kernels on each band's halo window), for each band of
    an S=2 and an S=4 split of the pose sites (k=5 on 64x64x128, k=3 on
    32x32x256, batch 8), ShapeNet's (k=3 on 64x64x128) and the animation
    heads' (the pose sites at a frame's batch of 2) on one card
    (`as_band`), a flow row planted
    SP_FAR_Y rows down, past the halo: its output and its gradients (the
    whole source's through the exchange's adjoint) against the same call
    on the plain twins (KERNEL_ATOL, BWD_REL x each gradient's
    max |value|); the bands' outputs against `halo_attention` on the whole
    map (KERNEL_ATOL), and the planted row apart from the whole-map
    kernel's (the window's clamp, not the image's); band 0's window
    kernels timed beside the whole map's. The plain twin's backward starts
    from the forward kernel's hpre (`PlainAtKernelHpre`)."""
    import torch.nn.functional as F

    from gfla_tpu_torch.ops import warp

    results = {}
    for i, (name, B, H, W, C, D, k, scale) in enumerate(SP_CASES):
        args = warp_inputs(B, H, W, C, D, k, scale, 60 + i, device)
        src, flow, hidden_bt, w1s, w2, b2 = args
        far = H // 2 - 2
        flow[0, far, :, 1] = SP_FAR_Y
        g = torch.from_numpy(np.random.RandomState(70 + i).randn(
            B, H, W, C).astype(np.float32)).to(device)
        whole, hpre = warp.warp_fwd_with_hpre(*args, k)
        whole_ms = cuda_ms(lambda: warp.warp_fwd(*args, k))
        whole_bwd_ms = cuda_ms(lambda: warp.warp_bwd(
            src, flow, hpre, w1s, w2, b2, g, k), iters=10)
        for S in SP_SPLITS:
            Hl = H // S
            h = min(SP_HALO, Hl)
            bands, errs = [], [0.0, 0.0]
            for s in range(S):
                got, got_g, win = band_warp(args, g, k, S, h, s)
                with mock.patch.object(warp, "warp_fwd",
                                       PlainAtKernelHpre.apply):
                    want, want_g, _ = band_warp(args, g, k, S, h, s)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                check(err <= KERNEL_ATOL, f"{name} S={S} band {s}: window "
                      f"forward kernel vs plain {err:.3e}")
                errs[0] = max(errs[0], err)
                for out, a, b in zip(BWD_OUTPUTS, got_g, want_g):
                    e = (a - b).abs().max().item()
                    check(e <= BWD_REL * b.abs().max().item(),
                          f"{name} S={S} band {s}: window {out} kernel vs "
                          f"plain {e:.3e}")
                    errs[1] = max(errs[1], e)
                bands.append(got)
                if s == 0:
                    gw = F.pad(g[:, :Hl], (0, 0, 0, 0, h, h))
                    _, hp = warp.warp_fwd_with_hpre(*win, k)
                    fwd_ms = cuda_ms(lambda: warp.warp_fwd(*win, k))
                    bwd_ms = cuda_ms(lambda: warp.warp_bwd(
                        *win[:2], hp, *win[3:], gw, k), iters=10)
            full = torch.cat(bands, 1)
            ref = halo_attention(*args, k, S, h)
            ref_err = (full - ref).abs().max().item()
            froze = (full - whole)[0, far].abs().max().item()
            check(ref_err <= KERNEL_ATOL and froze > 1e-3,
                  f"{name} S={S}: bands vs the halo reference {ref_err:.3e},"
                  f" the planted row {froze:.3e} from the whole map's")
            print(f"spatial window kernels {name} S={S} (bands of {Hl} "
                  f"rows, halo {h}, windows of {Hl + 2 * h}), through "
                  f"_warp_window: forward max_abs_err {errs[0]:.3e} (tol "
                  f"{KERNEL_ATOL:g}), gradients {errs[1]:.3e} (tol "
                  f"{BWD_REL:g} x max|value|) against the plain twins on "
                  f"each band; the bands against the halo-gather reference "
                  f"{ref_err:.3e}, the row planted {SP_FAR_Y:g} rows down "
                  f"{froze:.3e} from the whole map's; one band's window: "
                  f"forward {fwd_ms:.4f} ms, backward {bwd_ms:.4f} ms; "
                  f"whole map {whole_ms:.4f} ms and {whole_bwd_ms:.4f} ms; "
                  f"the {S} bands' kernels do {(Hl + 2 * h) * S / H:.2f}x "
                  f"the whole map's work")
            results[(name, S)] = dict(fwd_ms=fwd_ms, bwd_ms=bwd_ms,
                                      whole_ms=whole_ms,
                                      whole_bwd_ms=whole_bwd_ms)
    return results


def spatial_windows_bf16(device):
    """(a) The window kernels' bf16 instances (warp_fwd_bf16.cu,
    warp_bwd_bf16.cu) through `_warp_window`, for each band of an S=2 and
    an S=4 split of the pose sites and the animation heads' (B=2) on one
    card, from bf16 source, W1s, W2
    and g, the flow kept inside the window (|flow_y| <= h - k//2 - 1, so
    that the window's clamp is the image's): each band's output and
    gradients against the same call on the bf16 plain twins (from the
    forward kernel's hpre), by the bf16 rule against the f32 result of the
    same values (BF16_OUT_REL for the output and d_source, BF16_GRAD_REL
    for the others, x max|f32|); the bands' outputs against the whole
    map's bf16 forward kernel within BF16_OUT_REL x max|f32|."""
    from gfla_tpu_torch.ops import warp

    bf = torch.bfloat16
    results = {}
    for i, (name, B, H, W, C, D, k, scale) in enumerate(SP_CASES_BF16):
        src, flow, hbt, w1s, w2, b2 = warp_inputs(B, H, W, C, D, k, scale,
                                                  80 + i, device)
        g = torch.from_numpy(np.random.RandomState(90 + i).randn(
            B, H, W, C).astype(np.float32)).to(device).to(bf)
        for S in SP_SPLITS:
            Hl = H // S
            h = min(SP_HALO, Hl)
            reach = h - k // 2 - 1
            inside = flow.clone()
            inside[..., 1].clamp_(-reach, reach)
            args = (src.to(bf), inside, hbt, w1s.to(bf), w2.to(bf), b2)
            wide = (args[0].float(), inside, hbt, args[3].float(),
                    args[4].float(), b2)  # the same values, in f32
            whole = warp.warp_fwd(*args, k)
            whole32 = warp.warp_fwd(*wide, k)
            errs = {"out": 0.0, "grads": 0.0}
            bands = []
            for s in range(S):
                got, got_g, _ = band_warp(args, g, k, S, h, s)
                with mock.patch.object(warp, "warp_fwd",
                                       PlainAtKernelHpre.apply):
                    want, want_g, _ = band_warp(args, g, k, S, h, s)
                    ref, ref_g, _ = band_warp(wide, g.float(), k, S, h, s)
                torch.cuda.synchronize()
                check(got.dtype == bf, f"bf16 window {name}: {got.dtype}")
                what = f"bf16 window {name} S={S} band {s}"
                errs["out"] = max(errs["out"], bf16_rule(
                    f"{what} out", got, want, ref, BF16_OUT_REL)[1])
                for out, a, b, f in zip(BWD_OUTPUTS, got_g, want_g, ref_g):
                    tol = BF16_OUT_REL if out == "d_source" \
                        else BF16_GRAD_REL
                    errs["grads"] = max(errs["grads"], bf16_rule(
                        f"{what} {out}", a, b, f, tol)[1])
                bands.append(got)
            full = torch.cat(bands, 1).float()
            top = whole32.abs().max().item()
            err = (full - whole.float()).abs().max().item() / top
            check(err <= BF16_OUT_REL, f"bf16 window {name} S={S}: bands "
                  f"vs the whole map's bf16 kernel {err:.3e} x max|f32|")
            print(f"spatial window kernels in bf16 {name} S={S} (bands of "
                  f"{Hl} rows, halo {h}, |flow_y| <= {reach}): against the "
                  f"bf16 plain twins on each band, x max|f32|: output "
                  f"{errs['out']:.3e} (tol {BF16_OUT_REL:g}), gradients "
                  f"{errs['grads']:.3e} (tol {BF16_OUT_REL:g} d_source, "
                  f"{BF16_GRAD_REL:g} the others); the bands against the "
                  f"whole map's bf16 kernel {err:.3e} (tol "
                  f"{BF16_OUT_REL:g})")
            results[(name, S)] = dict(errs, whole=err)
    return results


def _collective_ms(fn):
    """Median CUDA-event ms of `fn()` over SP_ITERS launches after 3, the
    same count on every rank (the ranks must call collectives alike)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(SP_ITERS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def spatial_rank(device, states, out_dir, sp, rows):
    """(b)'s rank: phase 6's state (`states["pose"]`), fresh Adams, on this
    rank's band of its data index's `rows` rows of phase 6's batch: a
    kernel-path and a plain-path Adam step, and the kernel-path one again
    under --remat, its launches and the spatial group's collectives
    counted (rank 0's snapshots kept); an SGD step, its launches counted;
    SP_TIMED more, timed, with the peak memory; the halo exchanges and
    band sums of a step counted, and each timed alone at the pose path's
    largest shapes; then `spatial_heads` (shapenet, shapenetflow under
    GFLA_PALLAS_CORR=1, and pose in bf16)."""
    from gfla_tpu_torch import parallel
    from gfla_tpu_torch.runtime import set_tf32
    from gfla_tpu_torch.tasks import create_task

    start = time.perf_counter()
    # the ranks share the host's cores for their set-up on the CPU
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // parallel.world().size))
    set_tf32(False)
    b = parallel.init_bands(sp, SP_HALO)
    data = parallel.data_world()
    seconds = {"groups": time.perf_counter() - start}
    opt, ckpt = train_opt("--name=spatial_rank", f"--spatial={sp}")
    task = create_task(opt, device)
    seconds["task"] = time.perf_counter() - start
    for tag, sd in torch.load(states["pose"], weights_only=True).items():
        nets(task)[tag].load_state_dict(sd)
    band = task.prepare_batch(deepfashion_batch(100))
    batch = {k: v[data.rank * rows:(data.rank + 1) * rows]
             for k, v in band.items()}
    seconds["state and batch"] = time.perf_counter() - start
    out = {"band": b.index, "data": data.rank, "seconds": seconds,
           "collectives": {}}
    for key, path, remat in (("a", contextlib.nullcontext, False),
                             ("b", plain_warp, False),
                             ("c", contextlib.nullcontext, True)):
        t = copy.deepcopy(task)
        t.opt.remat = remat
        reset_launch_counts()
        before = parallel.band_collectives
        with path():
            logs = t.train_step(batch)
        torch.cuda.synchronize()
        out["collectives"][key] = parallel.band_collectives - before
        if remat:
            out["remat_counts"] = launch_counts()
        if parallel.is_main():
            out[key] = (logs, {tag: {kind: {n: v.cpu() for n, v in d.items()}
                                     for kind, d in snap.items()}
                               for tag, snap in snapshot(t).items()})
        del t
    out["seconds"]["Adam steps"] = time.perf_counter() - start
    task = sgd(task)
    calls = {"halo": 0, "sum": 0}
    halo, band_sum = parallel._Halo.apply, parallel._BandSum.apply

    def counted(kind, fn):
        def call(*args):
            calls[kind] += 1
            return fn(*args)
        return call

    reset_launch_counts()
    with mock.patch.object(parallel._Halo, "apply", counted("halo", halo)), \
            mock.patch.object(parallel._BandSum, "apply",
                              counted("sum", band_sum)):
        logs = task.train_step(batch)
    torch.cuda.synchronize()
    out["counts"] = launch_counts()
    out["calls"] = calls
    out["logs"] = {k: float(v)
                   for k, v in parallel.allreduce_mean(logs).items()}
    out["grads"] = dp_grads(task)
    out["replica"] = {k: v.cpu() for k, v in replica_state(task).items()}
    torch.cuda.reset_peak_memory_stats()
    out["times"], _ = timed_steps(task, [batch] * SP_TIMED)
    out["peak"] = torch.cuda.max_memory_allocated() / 2**30
    out["seconds"]["SGD steps"] = time.perf_counter() - start
    Hl = 256 // sp
    conv = torch.randn(rows, 64, Hl // 2, 128, device=device)
    window = torch.randn(rows, 64 // sp, 64, 128, device=device)
    stats = torch.randn(rows, 256, 1, 1, device=device)
    out["ms"] = {
        "conv halo, 1 row each way of a band of G's (B, 64, 128, 128)":
            _collective_ms(lambda: parallel.pad_rows(conv, 1, 1)),
        "attention window, 8 rows each way of a band of the k=5 site's "
        "(B, 64, 64, 128)":
            _collective_ms(lambda: parallel.pad_rows(window, SP_HALO,
                                                     SP_HALO, dim=1)),
        "instance-norm band sum of (B, 256, 1, 1)":
            _collective_ms(lambda: parallel.band_sum(stats))}
    out["seconds"]["collectives"] = time.perf_counter() - start
    ckpt.cleanup()
    del task, conv, window, stats
    out["heads"] = spatial_heads(device, states, sp, rows, band)
    out["seconds"]["other heads"] = time.perf_counter() - start
    torch.save(out, os.path.join(out_dir, f"rank{parallel.world().rank}.pt"))


SP_HEADS = (  # (b): (name, model, option, seed of the batch, CORR switch)
    ("shapenet", "shapenet", None, 520, "0"),
    ("shapenetflow", "shapenetflow", None, 530, "1"),
    ("bf16", "pose", "--compute_dtype=bfloat16", None, "0"))


def head_batch(task, seed, rows, band=None):
    """The global batch of SP_HEADS' step on this process: ShapeNet's
    (`shapenet_batch(seed)`) or, with `band`, phase 6's prepared batch,
    each this data index's `rows` rows."""
    from gfla_tpu_torch import parallel

    data = parallel.data_world()
    full = band if seed is None else task.prepare_batch(shapenet_batch(seed))
    return {k: v[data.rank * rows:(data.rank + 1) * rows]
            for k, v in full.items()}


def spatial_heads(device, states, sp, rows, band):
    """(b)'s other heads on this rank, each from its state in `states` with
    SGD: one step on the rank's band of its data index's rows (phase 6's
    prepared band `band` for the bf16 pose step), its launches counted,
    its logs (the world's mean), gradients, parameters and u."""
    from gfla_tpu_torch import parallel
    from gfla_tpu_torch.tasks import create_task

    out = {}
    for name, model, option, seed, corr in SP_HEADS:
        opt, ckpt = train_opt(f"--name=spatial_{name}", f"--spatial={sp}",
                              *([option] if option else []), model=model,
                              dataset="synthetic" if model == "pose"
                              else "shapenet")
        task = sgd(create_task(opt, device))
        for tag, sd in torch.load(states[name], weights_only=True).items():
            nets(task)[tag].load_state_dict(sd)
        batch = head_batch(task, seed, rows, band)
        reset_launch_counts()
        with switches(GFLA_PALLAS_CORR=corr):
            logs = task.train_step(batch)
        torch.cuda.synchronize()
        out[name] = dict(
            counts=launch_counts(), grads=dp_grads(task),
            logs={k: float(v)
                  for k, v in parallel.allreduce_mean(logs).items()},
            replica={k: v.cpu() for k, v in replica_state(task).items()})
        del task
        ckpt.cleanup()
    return out


def sp_rule(what, one, two):
    """gfla_tpu's spatial rule (SP_SHARE_1, SP_SHARE_2) on one network's
    gradients; returns the two shares."""
    g1 = torch.cat([one[k].flatten() for k in sorted(one)]).double()
    g2 = torch.cat([two[k].flatten() for k in sorted(one)]).double()
    d = (g1 - g2).abs() / max(1e-6, g1.abs().max().item())
    shares = [(d > bound).double().mean().item() for bound in (1e-3, 1e-2)]
    check(one.keys() == two.keys() and shares[0] < SP_SHARE_1
          and shares[1] < SP_SHARE_2,
          f"{what}: {shares[0]:.2e} of entries above 1e-3 of max (bound "
          f"{SP_SHARE_1:g}), {shares[1]:.2e} above 1e-2 (bound "
          f"{SP_SHARE_2:g}), max {d.max().item():.3e}")
    return shares


def phase_spatial(train):
    """10c. the data x spatial mode (--spatial, gfla_tpu_torch.parallel's
    spatial axis) on phase 6's full-width pose task: (a) on every machine
    the warp kernels' window form (`spatial_windows`); (b) where the
    machine has two cards (four: dp 2 x sp 2 at batch 8; else dp 1 x sp 2
    at batch 2), spawned ranks from phase 6's state on bands of its
    256x256 batch: a kernel-path Adam step against the plain path's under
    --spatial by phase 6's rule (check_step_pair, the f64 step of one card
    the reference: phase 6's own where the batch is its whole batch); an
    SGD step held to one card's on the same global
    batch by gfla_tpu's spatial rule (SP_TOTAL_REL, SP_SHARE_1,
    SP_SHARE_2), every rank's gradients, parameters and u bitwise equal
    after it, its launches counted as path spatial_train (2 of each warp
    kernel a rank); SP_TIMED more timed on each rank with the peak memory
    a card, beside one card's; the halo exchanges and band sums of a step
    counted, each timed alone; the wall time of its parts. Else a line
    says (b) did not run, and no spatial_train count is returned."""
    from gfla_tpu_torch import parallel
    from gfla_tpu_torch.runtime import card_line

    device = train["batch"]["P1"].device
    windows = spatial_windows(device)
    windows_bf16 = spatial_windows_bf16(device)
    n = next((r for r in SP_RANKS if torch.cuda.device_count() >= r), 0)
    if not n:
        print(f"spatial_train: the two-rank steps did not run "
              f"({torch.cuda.device_count()} card); the window kernels ran "
              f"alone")
        return {"windows": windows, "windows_bf16": windows_bf16,
                **{path: None for path in SP_PATHS}}
    start = time.perf_counter()
    sp, dp = 2, n // 2
    rows = (8 if dp == 2 else 2) // dp  # a data index's rows
    state = train["state"]
    batch = {k: v[:rows * dp] for k, v in train["batch"].items()}
    lrs = {"G": state.opt.lr, "D": state.opt.lr * state.opt.ratio_g2d}
    exact = train["exact"]  # phase 6's, of its state on its whole batch
    if rows * dp != len(train["batch"]["P1"]):
        exact = {tag: {k: g.cpu() for k, g in d.items()}
                 for tag, d in exact_grads(state, batch).items()}
    one = sgd(copy.deepcopy(state))
    one_logs = one.train_step(batch)
    want = dp_grads(one)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    one_ms, _ = timed_steps(one, [batch] * SP_TIMED)
    one_peak = torch.cuda.max_memory_allocated() / 2**30
    del one
    tmp = tempfile.TemporaryDirectory()
    states = {name: os.path.join(tmp.name, f"{name}.pt")
              for name in ("pose", "bf16", "shapenet", "shapenetflow")}
    torch.save({tag: net.state_dict() for tag, net in nets(state).items()},
               states["pose"])
    states["bf16"] = states["pose"]
    heads = spatial_head_refs(state, states, batch, rows * dp)
    spawned = time.perf_counter()
    ref_s = spawned - start
    parallel.spawn(spatial_rank, [torch.device("cuda", i) for i in range(n)],
                   states, tmp.name, sp, rows, timeout=SP_TIMEOUT)
    spawned = time.perf_counter() - spawned
    ranks = [torch.load(os.path.join(tmp.name, f"rank{r}.pt"),
                        weights_only=False) for r in range(n)]
    tmp.cleanup()
    check([(r["data"], r["band"]) for r in ranks]
          == [(i // sp, i % sp) for i in range(n)], "the rank layout")
    logs_a, snap_a = ranks[0]["a"]
    logs_b, snap_b = ranks[0]["b"]
    snap_b = {tag: {kind: {k: v.to(device) for k, v in d.items()}
                    for kind, d in s.items()} for tag, s in snap_b.items()}
    snap_a = {tag: {kind: {k: v.to(device) for k, v in d.items()}
                    for kind, d in s.items()} for tag, s in snap_a.items()}
    exact = {tag: {k: g.to(device) for k, g in d.items()}
             for tag, d in exact.items()}
    check_step_pair(f"spatial dp {dp} x sp {sp}: kernel vs plain path",
                    logs_a, snap_a, logs_b, snap_b, exact, lrs)
    for r in ranks[1:]:
        check(r["logs"] == ranks[0]["logs"]
              and all(torch.equal(r["replica"][k], v)
                      for k, v in ranks[0]["replica"].items())
              and all(torch.equal(r["grads"][tag][k], g)
                      for tag, d in ranks[0]["grads"].items()
                      for k, g in d.items()),
              "the ranks' logs, gradients, parameters or u differ")
    rules = {tag: sp_rule(f"spatial vs one card, {tag}", want[tag],
                          ranks[0]["grads"][tag]) for tag in want}
    total_rel = abs(ranks[0]["logs"]["total_G"]
                    - float(one_logs["total_G"])) \
        / abs(float(one_logs["total_G"]))
    check(total_rel <= SP_TOTAL_REL, f"total_G {total_rel:.3e} rel apart")
    for r, res in enumerate(ranks):
        check(only(res["counts"], warp_fwd=2, warp_bwd_pos=2, warp_bwd_w1=2),
              f"rank {r} launches {res['counts']}")
    print(f"spatial dp {dp} x sp {sp} on {card_line()!r}: {rows} rows of "
          f"{256 // sp} lines a rank, global batch {rows * dp}; SGD step "
          + "; ".join(f"{tag} {s1:.2e} of entries above 1e-3 of max, "
                      f"{s2:.2e} above 1e-2" for tag, (s1, s2)
                      in rules.items())
          + f"; total_G {ranks[0]['logs']['total_G']!r} against "
          f"{float(one_logs['total_G'])!r} ({total_rel:.3e} rel); every "
          f"rank's gradients, "
          f"parameters and u bitwise equal; step ms per rank "
          + ", ".join(f"{statistics.median(r['times'][1:]):.3f}"
                      for r in ranks)
          + f" against {statistics.median(one_ms[1:]):.3f} on one card at "
          f"batch {rows * dp}; peak GiB per card "
          + ", ".join(f"{r['peak']:.2f}" for r in ranks)
          + f" against {one_peak:.2f}; the forwards of a step: "
          f"{ranks[0]['calls']['halo']} halo exchanges, "
          f"{ranks[0]['calls']['sum']} band sums (the backward takes each "
          f"again where a gradient flows back); alone: "
          + ", ".join(f"{what} {ms:.4f} ms"
                      for what, ms in ranks[0]["ms"].items()))
    remat = spatial_remat(ranks, exact, lrs, snap_a, logs_a, device, dp,
                          sp)
    head_counts = spatial_heads_held(ranks, heads, want, dp, sp)
    print(f"spatial dp {dp} x sp {sp}, wall: one card's reference "
          f"{ref_s:.1f} s, the ranks {spawned:.1f} s (rank 0's own, from "
          f"its start: "
          + ", ".join(f"{what} done at {t:.1f} s"
                      for what, t in ranks[0]["seconds"].items()) + ")")
    return {"spatial_train": ranks[0]["counts"], "windows": windows,
            "windows_bf16": windows_bf16, "spatial_train_remat": remat,
            **head_counts}


def spatial_head_refs(state, states, batch, rows):
    """(b)'s references on one card: the shapenet and shapenetflow tasks at
    full width from their seeded init, off the kinks (their states saved
    at `states`), and an SGD step of each on ShapeNet's global batch of
    `rows` (shapenetflow under GFLA_PALLAS_CORR=1); phase 6's state in
    bf16, an SGD step on phase 6's global batch `batch`. Each: (logs,
    gradients)."""
    from gfla_tpu_torch.tasks import create_task

    refs = {}
    for name, model, option, seed, corr in SP_HEADS:
        opt, ckpt = train_opt(f"--name=one_{name}",
                              *([option] if option else []), model=model,
                              dataset="synthetic" if model == "pose"
                              else "shapenet")
        task = create_task(opt)
        if model == "pose":
            for tag, net in nets(state).items():
                nets(task)[tag].load_state_dict(net.state_dict())
        else:
            task = off_the_kinks(task)
            torch.save({tag: net.state_dict()
                        for tag, net in nets(task).items()}, states[name])
        task = sgd(task)
        with switches(GFLA_PALLAS_CORR=corr):
            logs = task.train_step(batch if seed is None else
                                   head_batch(task, seed, rows))
        refs[name] = ({k: float(v) for k, v in logs.items()},
                      dp_grads(task))
        del task
        ckpt.cleanup()
    return refs


def spatial_remat(ranks, exact, lrs, snap_a, logs_a, device, dp, sp):
    """(b) --remat: rank 0's kernel-path Adam step under --spatial --remat
    against the same step without it by phase 6's rule (check_step_pair),
    u bitwise equal; each rank's launches (the forward twice) and the
    spatial group's collectives, the same on every rank, more than
    without --remat. Returns rank 0's launches."""
    logs_c, snap_c = ranks[0]["c"]
    snap_c = {tag: {kind: {k: v.to(device) for k, v in d.items()}
                    for kind, d in s.items()} for tag, s in snap_c.items()}
    check_step_pair(f"spatial dp {dp} x sp {sp}: --remat vs without",
                    logs_c, snap_c, logs_a, snap_a, exact, lrs)
    for tag, snap in snap_c.items():
        check(all(torch.equal(u, snap_a[tag]["u"][n])
                  for n, u in snap["u"].items()),
              f"spatial --remat: {tag}'s u differs from the step without")
    counts = [r["collectives"] for r in ranks]
    check(all(c == counts[0] for c in counts)
          and counts[0]["c"] > counts[0]["a"],
          f"spatial --remat: the ranks' collectives {counts}")
    for r, res in enumerate(ranks):
        check(only(res["remat_counts"], warp_fwd=4, warp_bwd_pos=2,
                   warp_bwd_w1=2), f"rank {r} --remat launches "
              f"{res['remat_counts']}")
    print(f"spatial dp {dp} x sp {sp} --remat: the kernel-path Adam step "
          f"held to the same step without --remat (phase 6's rule), u "
          f"bitwise equal; collectives a step on each rank "
          f"{counts[0]['c']} against {counts[0]['a']} without; launches "
          f"{ranks[0]['remat_counts']}")
    return ranks[0]["remat_counts"]


def spatial_heads_held(ranks, refs, f32, dp, sp):
    """(b)'s other heads: each rank's step of SP_HEADS bitwise equal on
    every rank (logs, gradients, parameters, u); shapenet's and
    shapenetflow's against one card's step on the same global batch by
    gfla_tpu's spatial rule (SP_TOTAL_REL, SP_SHARE_1, SP_SHARE_2), the
    bf16 pose step against one card's bf16 step by BF16_STEP_HOLD's
    cosines and its norm bands widened by bf16's unit roundoff
    (`grads_by_rule` with SP_BF16_HOLD, the mean over tensors against f32
    by the bf16 rule's first clause, one-element gradients in the
    network's hold only,
    the f32 step `f32` the reference of what bf16 resolves, BF16_RESOLVED
    as phase 14's bf16 step takes it; a tensor outside the hold passes if
    the hold holds it against the f32 step, `to_f32`: the input norm's
    bias, a 3-value sum over the image that cancels and that the bands sum
    in two parts, read a norm ratio of 1.5735 and 1.5466 against one
    card's in two four-card runs on H100 80GB HBM3 cards at 700 W, and
    1.3080 against f32's, where one card's reads 0.8458); launches
    counted as paths spatial_train_shapenet (one of each warp kernel a
    rank), spatial_train_corr (one max_corr a rank) and spatial_train_bf16
    (two of each bf16 warp kernel a rank)."""
    expected = {"shapenet": dict(warp_fwd=1, warp_bwd_pos=1, warp_bwd_w1=1),
                "shapenetflow": dict(max_corr=1),
                "bf16": dict(warp_fwd_bf16=2, warp_bwd_pos_bf16=2,
                             warp_bwd_w1_bf16=2)}
    for name, _, _, _, _ in SP_HEADS:
        got = [r["heads"][name] for r in ranks]
        for r, res in enumerate(got):
            check(only(res["counts"], **expected[name]),
                  f"spatial {name}: rank {r} launches {res['counts']}")
        for res in got[1:]:
            check(res["logs"] == got[0]["logs"]
                  and all(torch.equal(res["replica"][k], v)
                          for k, v in got[0]["replica"].items())
                  and all(torch.equal(res["grads"][tag][k], g)
                          for tag, d in got[0]["grads"].items()
                          for k, g in d.items()),
                  f"spatial {name}: the ranks differ")
        logs, want = refs[name]
        total_rel = abs(got[0]["logs"]["total_G"] - logs["total_G"]) \
            / abs(logs["total_G"])
        if name == "bf16":
            check(total_rel <= BF16_LOSS_REL, f"spatial bf16: total_G "
                  f"{total_rel:.3e} rel apart")
            grads_by_rule(f"spatial dp {dp} x sp {sp} bf16 vs one card",
                          {t: {"grads": g} for t, g in got[0]["grads"].items()},
                          {t: {"grads": g} for t, g in want.items()},
                          {t: {"grads": g} for t, g in f32.items()},
                          resolved=BF16_RESOLVED, hold=SP_BF16_HOLD,
                          one_element=False, to_f32=True)
            rule = f"BF16_STEP_HOLD, total_G {total_rel:.3e} rel"
        else:
            check(total_rel <= SP_TOTAL_REL, f"spatial {name}: total_G "
                  f"{total_rel:.3e} rel apart")
            shares = {tag: sp_rule(f"spatial {name} vs one card, {tag}",
                                   {k: want[tag][k]
                                    for k in got[0]["grads"][tag]},
                                   got[0]["grads"][tag])
                      for tag in got[0]["grads"]}
            rule = "; ".join(f"{tag} {s1:.2e} of entries above 1e-3 of "
                             f"max, {s2:.2e} above 1e-2"
                             for tag, (s1, s2) in shares.items()) \
                + f"; total_G {total_rel:.3e} rel"
        print(f"spatial dp {dp} x sp {sp} {name} SGD step against one "
              f"card's: {rule}; every rank's gradients, parameters and u "
              f"bitwise equal; launches a rank {got[0]['counts']}")
    return {"spatial_train_shapenet": ranks[0]["heads"]["shapenet"]["counts"],
            "spatial_train_corr":
                ranks[0]["heads"]["shapenetflow"]["counts"],
            "spatial_train_bf16": ranks[0]["heads"]["bf16"]["counts"]}

DISK_PSNR_MIN = 35.0   # dB: nvJPEG encode + decode at quality 75, each image
FIXTURE_MEAN_ABS = 0.1  # levels: nvJPEG's planes, upsampled and converted
FIXTURE_MAX_ABS = 4     # as libjpeg does, vs PIL's pixels on the committed
                        # fixture: only the inverse DCT differs (an H100:
                        # mean 0.0192, max 2, 1.62% of values differ)
PREPARED_MEAN_ABS = 0.05  # a prepared image vs its source picture, mean
                        # |diff| in [-1, 1]: JPEG at quality 75 (>= 35 dB,
                        # <= 0.03); another picture differs by ~0.2-0.4
DISK_IMAGES = 16        # images in each phase of each tree
DISK_PAIRS = {"train": 24, "test": 8}  # 3 batches of 8: 1 held out, 2 trained
DISK_STEPS = 3
DISK_BATCH = 8          # the trainer's and the server's batch
DISK_LOAD = 256         # --load_size (market's apply_defaults sets 128x64)
FIXTURE = "tests/fixtures/pil_q75_96x64"


def disk_images(n, H, W, seed):
    """`n` seeded uint8 (H, W, 3) pictures: a vertical colour gradient and
    one soft-edged ellipse (a ~4 pixel edge), smooth as photographs are."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    out = []
    for _ in range(n):
        c0, c1 = rng.uniform(40, 215, 3), rng.uniform(40, 215, 3)
        t = (yy / H)[..., None]
        img = c0 * (1 - t) + c1 * t
        cy, cx = rng.uniform(0.35, 0.65) * H, rng.uniform(0.35, 0.65) * W
        ry, rx = rng.uniform(0.2, 0.35) * H, rng.uniform(0.15, 0.3) * W
        r = np.sqrt(((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2)
        a = np.clip((1.0 - r) * min(ry, rx) / 4.0, 0, 1)[..., None]
        img = img * (1 - a) + rng.uniform(40, 215, 3) * a
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def write_disk_tree(root, prefix, H, W, seed, device):
    """A DeepFashion- (prefix fasion) or Market-layout (market) tree of
    DISK_IMAGES images a phase, encoded on the card by image_io.encode_jpeg;
    keypoints in the image's own frame (a sixth missing); DISK_PAIRS
    distinct pairs. Returns {path: source array}."""
    import csv

    from gfla_tpu_torch.data.image_io import encode_jpeg

    rng = np.random.RandomState(seed)
    sources = {}
    for p, phase in enumerate(("train", "test")):
        os.makedirs(os.path.join(root, phase))
        names, rows = [], []
        for i, img in enumerate(disk_images(DISK_IMAGES, H, W, seed + p)):
            name = f"{phase}{i:02d}.jpg"
            path = os.path.join(root, phase, name)
            with open(path, "wb") as f:
                f.write(encode_jpeg(torch.from_numpy(img).to(device)))
            sources[path] = img
            kp = np.stack([rng.randint(0, H, 18), rng.randint(0, W, 18)], 1)
            kp[rng.rand(18) < 1 / 6] = -1
            names.append(name)
            rows.append([name, str(kp[:, 0].tolist()),
                         str(kp[:, 1].tolist())])
        with open(os.path.join(root, f"{prefix}-annotation-{phase}.csv"),
                  "w", newline="") as f:
            writer = csv.writer(f, delimiter=":")
            writer.writerow(["name", "keypoints_y", "keypoints_x"])
            writer.writerows(rows)
        every = [(a, b) for a in range(DISK_IMAGES) for b in range(DISK_IMAGES)
                 if a != b]
        chosen = rng.permutation(len(every))[:DISK_PAIRS[phase]]
        with open(os.path.join(root, f"{prefix}-pairs-{phase}.csv"), "w",
                  newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["from", "to"])
            writer.writerows([names[every[c][0]], names[every[c][1]]]
                             for c in chosen)
    return sources


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0**2 / mse)


def host_ms(fn, iters=10, warmup=2):
    """Median milliseconds of `fn()` by the host clock, synchronised: for
    work that is partly on the host (nvJPEG's Huffman decode)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@contextlib.contextmanager
def cli_run(what):
    """Run a CLI in-process with its stdout captured: its lines are
    returned; on a failure they are printed before the error."""
    import io

    buf = io.StringIO()
    lines = []
    try:
        with contextlib.redirect_stdout(buf):
            yield lines
    except BaseException:
        print(f"{what} output:\n{buf.getvalue()[-6000:]}")
        raise
    finally:
        lines.extend(buf.getvalue().splitlines())


def pair_paths(batch):
    return list(zip(batch["P1_path"], batch["P2_path"]))


def train_from_disk(what, args, steps, task_cls=None, paths=pair_paths,
                    initial=None):
    """`python -m gfla_tpu_torch.train` in-process on a tree: returns its
    output lines, the launch counts, the task, the paths of each batch it
    prepared in order (`paths` of the host batch; (P1, P2) pairs for the
    pose task, the default `task_cls`), and each step's synchronised
    ms. A list given as `initial` receives the new task's snapshot."""
    import gfla_tpu_torch.train.__main__ as train_cli
    from gfla_tpu_torch.tasks.pose import PoseTask
    from gfla_tpu_torch.train import loop

    task_cls = task_cls or PoseTask
    tasks, prepared, step_ms = [], [], []
    prepare, train_step = task_cls.prepare_batch, task_cls.train_step
    create_task = loop.create_task

    def recording_prepare(self, batch):
        prepared.append(paths(batch))
        return prepare(self, batch)

    def timed_step(self, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_step(self, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def capture(opt, device=None):
        tasks.append(create_task(opt, device))
        if initial is not None:
            initial.append(snapshot(tasks[-1]))
        return tasks[-1]

    with mock.patch.object(task_cls, "prepare_batch", recording_prepare), \
            mock.patch.object(task_cls, "train_step", timed_step), \
            mock.patch.object(loop, "create_task", capture), \
            cli_run(what) as lines:
        reset_launch_counts()
        check(train_cli.main(args) == 0, f"{what}: exit code")
        torch.cuda.synchronize()
        counts = launch_counts()
    check(len(step_ms) == steps, f"{what}: {len(step_ms)} steps")
    return lines, counts, tasks[0], prepared, step_ms


def serve_from_disk(what, args):
    """`python -m gfla_tpu_torch.test` in-process: output lines, counts."""
    import gfla_tpu_torch.test as test_cli

    with cli_run(what) as lines:
        reset_launch_counts()
        test_cli.main(args)
        torch.cuda.synchronize()
        counts = launch_counts()
    return lines, counts


def eval_lines(lines, metric="ssim"):
    """{iteration: {metric: value}} of the trainer's held-out lines, those
    that hold `metric`."""
    out = {}
    for line in lines:
        if line.startswith("(epoch:") and f" {metric}:" in line:
            head, tail = line.split(") ", 1)
            fields = tail.split()
            out[int(head.split("iters: ")[1])] = {
                k.rstrip(":"): float(v)
                for k, v in zip(fields[::2], fields[1::2])}
    return out


def phase_disk_data(device):
    """The pose head from files: DeepFashion- and Market-layout trees
    written here through nvJPEG, decoded back, trained and served through
    the two CLIs' entry points (in-process, so the launches are counted)."""
    from gfla_tpu_torch.data import collate, get_dataset_class
    from gfla_tpu_torch.data import image_io
    from gfla_tpu_torch.data.resample import resample_images
    from gfla_tpu_torch.options import TestOptions
    from gfla_tpu_torch.tasks import create_task
    from gfla_tpu_torch.train.evaluate import holdout_indices

    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.TemporaryDirectory()
    trees = {"fashion": (os.path.join(work.name, "fashion"), "fasion",
                         256, 176),
             "market": (os.path.join(work.name, "market"), "market",
                        128, 64)}
    t0 = time.perf_counter()
    sources = {}
    for i, (root, prefix, H, W) in enumerate(trees.values()):
        sources.update(write_disk_tree(root, prefix, H, W, 70 + 10 * i,
                                       device))
    check(image_io.nvjpeg_encodes == len(sources), "encodes not on nvJPEG")

    # the round trip, and nvJPEG's pixels against PIL's
    paths = sorted(sources)
    datas = [np.fromfile(p, np.uint8) for p in paths]
    decoded = image_io.decode_jpeg_batch(datas, device, paths)
    torch.cuda.synchronize()
    psnrs = [psnr(img.cpu().numpy(), sources[p])
             for img, p in zip(decoded, paths)]
    fixture = np.fromfile(os.path.join(here, FIXTURE + ".jpg"), np.uint8)
    want = np.load(os.path.join(here, FIXTURE + ".npy")).astype(np.int16)
    got = image_io.decode_jpeg_batch([fixture], device, [FIXTURE])[0]
    diff = np.abs(got.cpu().numpy().astype(np.int16) - want)
    print(f"disk: wrote {len(sources)} JPEGs through nvJPEG in "
          f"{time.perf_counter() - t0:.2f} s; encode+decode PSNR min "
          f"{min(psnrs):.2f} dB mean {np.mean(psnrs):.2f} (bound "
          f"{DISK_PSNR_MIN:g} per image); nvJPEG vs PIL on {FIXTURE}.jpg: "
          f"mean |diff| {diff.mean():.4f} levels, max {diff.max()}, "
          f"{(diff > 0).mean() * 100:.2f}% of values differ (bounds: mean "
          f"{FIXTURE_MEAN_ABS:g}, max {FIXTURE_MAX_ABS})")
    check(min(psnrs) >= DISK_PSNR_MIN, f"round-trip PSNR {min(psnrs):.2f}")
    # the same decode queued behind ~0.1 s of work on the caller's stream,
    # as a batch is decoded while the previous training step runs
    x = torch.randn(4096, 4096, device=device)
    y = torch.empty_like(x)
    for _ in range(40):
        torch.mm(x, x, out=y)
    behind = image_io.decode_jpeg_batch(datas, device, paths)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(behind, decoded)),
          "the decode behind a busy stream differs from the decode alone")
    print(f"disk: the {len(paths)} images decoded behind ~40 queued 4096^3 "
          f"products equal the ones decoded alone")
    del x, y, behind
    try:
        image_io.decode_jpeg_batch([np.zeros(64, np.uint8)], device,
                                   ["broken.jpg"])
        refused = ""
    except ValueError as err:
        refused = str(err)
    check("nvJPEG" in refused and "broken.jpg" in refused,
          f"64 zero bytes: {refused or 'decoded'}")
    print(f"decode_jpeg_batch refuses a file that is no JPEG: {refused}")
    check(got.shape == want.shape and diff.mean() <= FIXTURE_MEAN_ABS
          and diff.max() <= FIXTURE_MAX_ABS,
          f"nvJPEG vs PIL |diff| mean {diff.mean():.4f} max {diff.max()}")

    counts = {}
    for mode, (root, prefix, H, W) in trees.items():
        name = f"disk_{mode}"
        ckpt = os.path.join(work.name, "ckpt")
        common = [f"--dataset_mode={mode}", f"--dataroot={root}",
                  "--gpu_ids=0", f"--batchSize={DISK_BATCH}",
                  f"--load_size={DISK_LOAD}", f"--checkpoints_dir={ckpt}",
                  f"--name={name}"]
        train_args = [*common, "--model=pose",
                      f"--max_iters={DISK_STEPS}", "--eval_iters_freq=2",
                      "--display_freq=2", "--print_freq=1"]
        if mode == "fashion":  # the trace, and the loader's two workers
            train_args += ["--profile_iters=1"]
        else:
            train_args += ["--nThreads=0"]
        decodes = image_io.nvjpeg_decodes
        lines, train_counts, task, prepared, step_ms = train_from_disk(
            f"{mode} train", train_args, DISK_STEPS)
        decodes = image_io.nvjpeg_decodes - decodes
        print(f"{mode} train from disk: launches {train_counts}; nvJPEG "
              f"decodes {decodes}")
        for line in lines:
            if line.startswith(("held out", "dataset [", "(epoch:",
                                "profiler trace")):
                print(f"  {line}")
        # held out: train.py's indices, evaluated, never trained on
        pairs = list(task_pairs(root, prefix))
        held = holdout_indices(len(pairs), DISK_BATCH, 0)
        check(f"held out {DISK_BATCH} samples for eval (indices "
              f"{held.tolist()})"
              in lines, f"{mode}: held-out line")
        held_pairs = [pairs[i] for i in held]
        check(prepared.count(held_pairs) == 1,
              f"{mode}: the held-out batch was prepared "
              f"{prepared.count(held_pairs)} times")
        trained = [b for b in prepared if b != held_pairs]
        check(len(trained) == DISK_STEPS and not any(
            set(b) & set(held_pairs) for b in trained),
            f"{mode}: a held-out pair reached a training batch")
        evals = eval_lines(lines)
        check(list(evals) == [2] and all(
            np.isfinite(v) for v in evals[2].values())
            and sorted(evals[2]) == ["l1", "psnr", "ssim"],
            f"{mode}: held-out evaluation {evals}")
        run = os.path.join(ckpt, name)
        images = sorted(os.listdir(os.path.join(run, "web", "images")))
        check(os.path.exists(os.path.join(run, "eval_log.txt"))
              and len(images) == 8
              and all(n.startswith("iter00000002_") for n in images)
              and os.path.exists(os.path.join(run, "web", "index.html")),
              f"{mode}: logs and visuals {images}")
        check(decodes == 2 * DISK_BATCH * (DISK_STEPS + 1),
              f"{mode}: {decodes} nvJPEG decodes")
        if mode == "fashion":
            trace = os.path.join(run, "profile", "trace_3.json")
            check(os.path.getsize(trace) > 0, "no profiler trace")
            check(task.net_d.layers == 4, "fashion: not the 4-layer D")
        else:
            check(task.net_d.layers == 3 and task.opt.load_size == (128, 64)
                  and task.opt.angle == (-5, 5), "market: not its config")
        check(only(train_counts, warp_fwd=2 * DISK_STEPS + 2 * 2,
                   warp_bwd_pos=2 * DISK_STEPS, warp_bwd_w1=2 * DISK_STEPS),
              f"{mode} train launches {train_counts}: expected 2 forward "
              f"and 2 of each backward a step, 2 forwards for the "
              f"evaluation and 2 for the visuals")
        counts[f"{'disk' if mode == 'fashion' else mode}_train"] = \
            train_counts

        # serve the test pairs from the last checkpoint
        results = os.path.join(work.name, "results")
        encodes = image_io.nvjpeg_encodes
        lines, serve_counts = serve_from_disk(
            f"{mode} serve", [*common, "--model=pose", "--which_iter=3",
                              f"--results_dir={results}", "--nThreads=0"])
        encodes = image_io.nvjpeg_encodes - encodes
        vis = sorted(n for n in os.listdir(os.path.join(results, name))
                     if n.endswith("_vis.jpg"))
        back = image_io.decode_jpeg_batch(
            [np.fromfile(os.path.join(results, name, vis[0]), np.uint8)],
            device, [vis[0]])[0]
        hw = (DISK_LOAD, DISK_LOAD) if mode == "fashion" else (128, 64)
        n_test = DISK_PAIRS["test"]
        print(f"{mode} serve from disk: launches {serve_counts}; "
              f"{len(vis)} _vis.jpg by nvJPEG ({encodes} encodes); "
              f"{vis[0]} decodes to {tuple(back.shape)}")
        check(f"wrote {n_test} results to {os.path.join(results, name)}"
              in lines and len(vis) == n_test and encodes == n_test
              and tuple(back.shape) == (*hw, 3), f"{mode}: served files")
        check(only(serve_counts, warp_fwd=2 * n_test // DISK_BATCH),
              f"{mode} serve launches {serve_counts}")
        counts[f"{'disk' if mode == 'fashion' else mode}_serve"] = \
            serve_counts

        # the host's share: decode and prepare_batch against the step
        opt = TestOptions().parse(common[:3] + ["--gpu_ids=0"], save=False)
        dataset = get_dataset_class(mode)(opt)
        batch = collate([dataset[i] for i in range(DISK_BATCH)])
        decode_ms = host_ms(lambda: image_io.decode_jpeg_batch(
            batch["P1"], device, batch["P1_path"]))  # DISK_BATCH images
        prepare_ms = host_ms(lambda: task.prepare_batch(batch))
        # each prepared image against its source array, warped the same way
        prepared = task.prepare_batch(batch)
        for key in ("P1", "P2"):
            src = torch.stack([torch.from_numpy(sources[os.path.join(
                root, "test", name)]) for name in batch[f"{key}_path"]])
            want = resample_images(
                list(src.to(device)), prepared[key].shape[2:],
                torch.from_numpy(batch[f"{key}_inv"]).to(device))
            err = (prepared[key].permute(0, 2, 3, 1) - want).abs().mean(
                dim=(1, 2, 3))
            check(err.max().item() <= PREPARED_MEAN_ABS,
                  f"{mode}: prepared {key} off its sources by "
                  f"{err.max().item():.4f} mean")
        print(f"{mode}: each prepared P1 and P2 within "
              f"{err.max().item():.4f} mean |diff| of its source picture, "
              f"warped alike (bound {PREPARED_MEAN_ABS:g})")
        step = statistics.median(step_ms[1:])
        print(f"{mode} from disk: decode {decode_ms:.3f} ms per batch of 8 "
              f"images, prepare_batch {prepare_ms:.3f} ms per batch "
              f"({2 * DISK_BATCH} decodes, warp-resize, heatmaps), train step {step:.3f} ms "
              f"(steps {', '.join(f'{t:.1f}' for t in step_ms)}): the host "
              f"pass is {prepare_ms / (prepare_ms + step) * 100:.1f}% of a "
              f"step from disk if not overlapped")
        if mode == "market":  # kernel path vs plain warp, serving
            serve_task = create_task(opt)
            serve_task.net_g.load_state_dict(task.net_g.state_dict())
            request = serve_task.prepare_batch(batch)
            img = serve_task.test_step(request)[0]
            with plain_warp():
                plain_img = serve_task.test_step(request)[0]
            diff = (img - plain_img).abs().max().item()
            print(f"market serving, kernel path vs plain path: "
                  f"max_abs_diff={diff:.3e} (bound {SLICE_ATOL:g})")
            check(diff <= SLICE_ATOL, f"market kernel vs plain {diff:.3e}")
            del serve_task
        del task
    work.cleanup()
    return counts


SHAPENET = ["--model=shapenet", "--dataset_mode=shapenet", "--load_size=256",
            "--batchSize=8", "--gpu_ids=0"]
# the smallest ShapeNet generator: its target grows from an 8x8 seed to
# 8 * 2^(layers + 2) pixels, so a 64x64 input takes one layer, attending at
# 32x32
SHAPENET_SMALL = ["--load_size=64", "--layers=1", "--attn_layer=1",
                  "--kernel_size=1=3"]
SHAPENET_B, SHAPENET_SIZE, SHAPENET_SITE = 8, 256, 64
SWEEP_VIEWS, SWEEP_BATCHES = 18, 2
# Parameters a ShapeNet step leaves as they are, in gfla_tpu as here: the
# source net's last encoder, whose 32x32 features no attention level reads
# at --attn_layer=2 (no gradient), and the scale of the instance norm over
# the target code tiled to 8x8, whose normalised input is exactly 0 (a
# gradient of exactly 0, so Adam's step is 0)
SHAPENET_STILL = ("source.encoder1.", "target.block0.model.0.weight")


def shapenet_batch(seed, B=None, size=None, views=0):
    """A batch in the ShapeNet dataset's layout: random uint8 images as the
    HDF5 store holds them, and viewpoint labels (azimuth / 10, elevation)
    drawn as gfla_tpu's bench.py draws them (bench.py:154-163). With
    `views`, a test batch: each source's sweep of `views` azimuths as
    targets, P2 (B, views, H, W, 3), BP2 (B, views, 2), and the paths."""
    B, size = B or SHAPENET_B, size or SHAPENET_SIZE
    rng = np.random.RandomState(seed)

    def images(*lead):
        return rng.randint(0, 256, (*lead, size, size, 3)).astype(np.uint8)

    def labels(n):
        return np.stack([rng.randint(0, 18, n) * 2,
                         rng.randint(0, 3, n) * 10], axis=1).astype(np.int32)

    if not views:
        return {"P1": images(B), "P2": images(B), "BP1": labels(B),
                "BP2": labels(B)}
    names = [f"car{seed}x{i}" for i in range(B)]
    azimuths = [2 * v for v in range(views)]  # range(0, 360, 20) / 10
    return {"P1": images(B), "BP1": labels(B), "P2": images(B, views),
            "BP2": np.array([[[a, 0] for a in azimuths]] * B, np.int32),
            "P1_path": [f"{n}_0_0" for n in names],
            "P2_path": [[f"{n}_{a}_0" for a in azimuths] for n in names]}


def shapenet_full_width(g):
    """The task's own defaults: ngf 64, one attention level (2) of kernel 3
    over 128 channels, the flow net's bottleneck fusing 256 + 21."""
    attn = getattr(g.target, "attn1", None)
    return (g.source.block0.model[2].out_channels == 64
            and attn is not None and attn.kernel_size == 3
            and attn.fully_connect_layer[0].in_channels == 2 * 128
            and not hasattr(g.target, "attn0")
            and g.flow_net.cat.model[0].model[2].in_channels == 256 + 21)


def check_images(what, outs, B, size, site):
    for img, flows, masks in outs:
        check(tuple(img.shape) == (B, 3, size, size)
              and img.dtype == torch.float32, f"{what}: image {img.shape}")
        check(bool(torch.isfinite(img).all()), f"{what}: non-finite image")
        check(img.min().item() >= -1 and img.max().item() <= 1,
              f"{what}: image outside [-1, 1]")
        check([tuple(f.shape) for f in flows] == [(B, 2, site, site)]
              and [tuple(m.shape) for m in masks] == [(B, 1, site, site)],
              f"{what}: flow shapes {[f.shape for f in flows]}")


def phase_shapenet_serve():
    """The full-width ShapeNet generator serves four batch-8 requests at
    256x256 through ShapeNetTask.test_step: one warp-forward launch a
    request and nothing else; shape and range; the image against the plain
    warp path, and a small generator's on the card against the CPU's;
    ms per forward of both paths."""
    from gfla_tpu_torch.options import TestOptions
    from gfla_tpu_torch.tasks import create_task

    torch.cuda.empty_cache()  # start from an empty allocator cache
    task = create_task(TestOptions().parse(SHAPENET, save=False))
    g = task.net_g
    check(shapenet_full_width(g), "not the full-width shapenet config")
    print(f"shapenet generator: {sum(p.numel() for p in g.parameters())} "
          f"parameters on {task.device}")
    requests = [task.prepare_batch(shapenet_batch(seed)) for seed in range(4)]
    reset_launch_counts()
    outs = [task.test_step(batch) for batch in requests]
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"shapenet served {len(requests)} requests: launches {counts}")
    check(only(counts, warp_fwd=len(requests)),
          f"shapenet serving launched {counts}, expected 1 warp_fwd a "
          f"request and nothing else")
    check_images("shapenet serving", outs, SHAPENET_B, SHAPENET_SIZE,
                 SHAPENET_SITE)
    with plain_warp():
        plain_img = task.test_step(requests[0])[0]
    diff = (outs[0][0] - plain_img).abs().max().item()
    print(f"shapenet kernel path vs plain path: max_abs_diff={diff:.3e} "
          f"(bound {SLICE_ATOL:g})")
    check(diff <= SLICE_ATOL, f"shapenet kernel path vs plain path {diff:.3e}")

    small = create_task(TestOptions().parse(SHAPENET + SHAPENET_SMALL,
                                            save=False))
    request = small.prepare_batch(shapenet_batch(7, B=2, size=64))
    card_img = small.test_step(request)[0].cpu()
    cpu = copy.copy(small)
    cpu.net_g = copy.deepcopy(small.net_g).cpu()
    cpu_img = cpu.test_step({k: v.cpu() for k, v in request.items()})[0]
    diff_cpu = (card_img - cpu_img).abs().max().item()
    print(f"shapenet card vs CPU at 2x64x64 (layers 1): max_abs_diff="
          f"{diff_cpu:.3e} (bound {CPU_ATOL:g})")
    check(diff_cpu <= CPU_ATOL, f"shapenet card vs CPU {diff_cpu:.3e}")

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: task.test_step(requests[1]), iters=10)
    peak = torch.cuda.max_memory_allocated() / 2**20
    with plain_warp():
        plain_ms = cuda_ms(lambda: task.test_step(requests[1]), iters=10)
    ms_again = cuda_ms(lambda: task.test_step(requests[1]), iters=10)
    print(f"shapenet forward batch 8 at 256x256: kernel path {ms:.3f} ms "
          f"(again {ms_again:.3f}), plain path {plain_ms:.3f} ms, peak "
          f"{peak:.0f} MiB")
    return dict(task=task, requests=requests, launches=counts["warp_fwd"],
                ms=ms)


def phase_shapenet_sweep(serve):
    """ShapeNetTask.run_test, the serving CLI's pass, over two batch-8
    test batches in the dataset's test layout: every source at all 18
    azimuths of its sweep, 288 _vis.jpg through nvJPEG, named as gfla_tpu
    names them; one warp-forward launch a view of a batch."""
    from gfla_tpu_torch.data import image_io

    task = serve["task"]
    work = tempfile.TemporaryDirectory()
    opt = copy.copy(task.opt)
    opt.results_dir, opt.name = work.name, "sweep"
    loader = [shapenet_batch(300 + i, views=SWEEP_VIEWS)
              for i in range(SWEEP_BATCHES)]
    want = sorted(f"{src}_2_{tgt}_vis.jpg" for batch in loader
                  for src, tgts in zip(batch["P1_path"], batch["P2_path"])
                  for tgt in tgts)
    encodes = image_io.nvjpeg_encodes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_launch_counts()
    n = task.run_test(opt, loader)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    encodes = image_io.nvjpeg_encodes - encodes
    out = os.path.join(work.name, "sweep")
    names = sorted(os.listdir(out))
    back = image_io.decode_jpeg_batch(
        [np.fromfile(os.path.join(out, names[0]), np.uint8)], task.device,
        [names[0]])[0]
    views = SWEEP_VIEWS * SWEEP_BATCHES
    print(f"shapenet sweep: run_test wrote {n} _vis.jpg ({encodes} nvJPEG "
          f"encodes) for {SWEEP_BATCHES} batches of {SHAPENET_B} sources at "
          f"{SWEEP_VIEWS} azimuths in {seconds:.2f} s; launches {counts}; "
          f"{names[0]} decodes to {tuple(back.shape)}")
    check(n == len(want) == views * SHAPENET_B and names == want
          and encodes == n, f"shapenet sweep wrote {n}: {names[:3]}")
    check(tuple(back.shape) == (SHAPENET_SIZE, SHAPENET_SIZE, 3),
          f"shapenet sweep image {tuple(back.shape)}")
    check(only(counts, warp_fwd=views),
          f"shapenet sweep launched {counts}, expected {views} warp_fwd")
    work.cleanup()
    return counts["warp_fwd"]


def phase_shapenet_train():
    """Four full-width batch-8 ShapeNet D-then-G steps through the kernels
    (train_main_path: one launch of each warp kernel a step); one step on
    the kernel path against the plain path from one state, and a small
    generator's step on the card against the CPU's, both held against a
    float64 step."""
    from gfla_tpu_torch.tasks import create_task

    opt, ckpt = train_opt("--name=shapenet_train", model="shapenet",
                          dataset="shapenet")
    task = create_task(opt)
    check(shapenet_full_width(task.net_g) and task.net_d.layers == 4,
          "not the full-width shapenet config")
    lrs = {"G": opt.lr, "D": opt.lr * opt.ratio_g2d}
    batches = [task.prepare_batch(shapenet_batch(100 + s))
               for s in range(TRAIN_STEPS + 1)]
    state0 = copy.deepcopy(task)
    counts, times, plain_times, peak = train_main_path(
        task, opt, batches, "shapenet ", still_ok=SHAPENET_STILL,
        warp_fwd=TRAIN_STEPS, warp_bwd_pos=TRAIN_STEPS,
        warp_bwd_w1=TRAIN_STEPS)
    still = [n for n, p in task.net_g.named_parameters()
             if torch.equal(p, state0.net_g.get_parameter(n))]
    print(f"shapenet: left unmoved (no gradient, or exactly 0): {still}")
    del task
    ckpt.cleanup()

    state = off_the_kinks(state0)
    del state0
    compare_steps("shapenet kernel vs plain path, batch 8 at 256x256", state,
                  batches[0], lrs)
    small_opt, small_ckpt = train_opt(
        "--name=shapenet_small", *SHAPENET_SMALL, model="shapenet",
        dataset="shapenet")
    small = off_the_kinks(create_task(small_opt))
    compare_steps("shapenet card vs CPU at 2x64x64 (layers 1)", small,
                  small.prepare_batch(shapenet_batch(7, B=2, size=64)), lrs,
                  to_cpu=True)
    del small
    small_ckpt.cleanup()
    ms = statistics.median(times[1:])
    print(f"shapenet train step batch 8 at 256x256: kernel path {ms:.3f} ms "
          f"(steps {', '.join(f'{t:.1f}' for t in times)}), plain path "
          f"{statistics.median(plain_times):.3f} ms (steps "
          f"{', '.join(f'{t:.1f}' for t in plain_times)}), peak "
          f"{peak:.2f} GiB")
    return dict(counts=counts, state=state, batch=batches[0], ms=ms,
                peak=peak)


def phase_shapenetflow():
    """Stage 1 of the two-stage protocol: four full-width batch-8
    shapenetflow steps with GFLA_PALLAS_CORR=1, one max-correlation launch
    a step; then the shapenet task resumes that directory and loads every
    flow_net tensor, the rest at its init and the optimizers fresh."""
    from gfla_tpu_torch.tasks import create_task

    opt, ckpt = train_opt("--name=views", model="shapenetflow",
                          dataset="shapenet")
    task = create_task(opt)
    fn = task.net_g.flow_net
    check(fn.block0.model[2].out_channels == 32 and fn.encoder_layer == 5
          and fn.cat.model[0].model[2].in_channels == 256 + 21,
          "not the full-width shapenet flow net")
    print(f"shapenetflow: {sum(p.numel() for p in task.net_g.parameters())} "
          f"parameters")
    batches = [task.prepare_batch(shapenet_batch(400 + s))
               for s in range(TRAIN_STEPS)]
    s0 = snapshot(task)
    with switches(GFLA_PALLAS_CORR="1"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        times, logs = timed_steps(task, batches)
        torch.cuda.synchronize()
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"shapenetflow trained {TRAIN_STEPS} steps: launches {counts}")
    check(only(counts, max_corr=TRAIN_STEPS),
          f"launches {counts}, expected 1 max_corr a step and nothing else")
    for i, step_logs in enumerate(logs):
        check(sorted(step_logs) == sorted(task.loss_names + ["total_G"])
              and all(bool(torch.isfinite(v)) for v in step_logs.values()),
              f"shapenetflow step {i + 1}: losses {step_logs}")
    print("shapenetflow losses, step 1: " + " ".join(
        f"{k} {float(v):.5f}" for k, v in logs[0].items()))
    params = dict(task.net_g.named_parameters())
    unreached = sorted(n for n, p in params.items() if p.grad is None)
    still = [n for n, p in params.items()
             if n not in unreached and torch.equal(p, s0["G"]["params"][n])]
    check(not still and all(n.startswith("flow_net.mask")
                            for n in unreached),
          f"shapenetflow: unchanged {still}, no gradient {unreached}")
    with switches(GFLA_PALLAS_CORR="0"):
        plain = copy.deepcopy(task)
        plain_times, _ = timed_steps(plain, batches[1:])
        del plain

    task.save(TRAIN_STEPS)
    stage2_opt, _ = train_opt("--name=views", "--continue_train",
                              model="shapenet", dataset="shapenet",
                              ckpt=ckpt)
    stage2 = create_task(stage2_opt)
    init = {n: t.clone() for n, t in stage2.net_g.state_dict().items()}
    check(stage2.resume(stage2_opt.which_iter) == TRAIN_STEPS,
          "stage 2 did not keep the step")
    saved, got = task.net_g.state_dict(), stage2.net_g.state_dict()
    flow_keys = [n for n in got if n.startswith("flow_net.")]
    check(sorted(flow_keys) == sorted(saved)
          and all(torch.equal(got[n], saved[n]) for n in flow_keys),
          "stage 2's flow net is not the saved one")
    check(all(torch.equal(got[n], init[n]) for n in got
              if not n.startswith("flow_net.")),
          "stage 2's source and target nets are not at their init")
    check(not stage2.opt_g.state and not stage2.opt_d.state,
          "stage 2's optimizers are not fresh")
    print(f"two-stage: shapenet --continue_train loaded the "
          f"{len(flow_keys)} flow_net tensors at step {stage2.step}; the "
          f"other {len(got) - len(flow_keys)} kept their init")
    del stage2
    ckpt.cleanup()
    print(f"shapenetflow step batch 8 at 256x256: kernel path "
          f"{statistics.median(times[1:]):.3f} ms (steps "
          f"{', '.join(f'{t:.1f}' for t in times)}), scan path "
          f"{statistics.median(plain_times):.3f} ms, peak {peak:.2f} GiB")
    return counts


def phase_shapenet_bf16(serve, train):
    """The ShapeNet head under --compute_dtype=bfloat16: the f32 weights
    serve the same four requests (one bf16 warp-forward launch a request
    and nothing else; the image against the plain bf16 path and the f32
    image by the bf16 rule; ms beside f32, in turns), and one training
    step on the kernel path (one launch of each bf16 warp kernel) against
    the plain bf16 path from one state by BF16_STEP_HOLD, both against the
    f32 step; ms per step beside the f32 step's."""
    from gfla_tpu_torch.options import TestOptions
    from gfla_tpu_torch.tasks import create_task

    task = create_task(TestOptions().parse(
        SHAPENET + ["--compute_dtype=bfloat16"], save=False))
    f32_task, requests = serve["task"], serve["requests"]
    task.net_g.load_state_dict(f32_task.net_g.state_dict())
    reset_launch_counts()
    outs = [task.test_step(batch) for batch in requests]
    torch.cuda.synchronize()
    serve_counts = launch_counts()
    print(f"shapenet bf16 served {len(requests)} requests: launches "
          f"{serve_counts}")
    check(only(serve_counts, warp_fwd_bf16=len(requests)),
          f"shapenet bf16 serving launched {serve_counts}")
    check_images("shapenet bf16 serving", outs, SHAPENET_B, SHAPENET_SIZE,
                 SHAPENET_SITE)
    with plain_warp():
        plain_img = task.test_step(requests[0])[0]
    f32_img = f32_task.test_step(requests[0])[0]
    err, rel = bf16_rule("shapenet bf16 serving", outs[0][0], plain_img,
                         f32_img, SERVE_BF16_REL)
    times = {"f32": [], "bf16": []}
    for path in ("f32", "bf16", "bf16", "f32"):
        run = task if path == "bf16" else f32_task
        times[path].append(cuda_ms(lambda: run.test_step(requests[1]),
                                   iters=10))
    print(f"shapenet bf16 serving: kernel vs plain bf16 path "
          f"{rel:.3e} x max|f32 image| (bound {SERVE_BF16_REL:g}); forward "
          f"batch 8 at 256x256: bf16 "
          f"{', '.join(f'{t:.3f}' for t in times['bf16'])} ms, f32 "
          f"{', '.join(f'{t:.3f}' for t in times['f32'])} ms (in turns)")
    del task

    opt, ckpt = train_opt("--compute_dtype=bfloat16", "--name=shapenet_bf16",
                          model="shapenet", dataset="shapenet")
    state = off_the_kinks(create_task(opt))
    ckpt.cleanup()
    batch = state.prepare_batch(shapenet_batch(500))
    f32 = copy.deepcopy(state)
    f32.dtype = torch.float32
    f32.vgg.float()
    f32.train_step(batch)
    snap32 = snapshot(f32)
    del f32
    sides = []
    for path in (contextlib.nullcontext, plain_warp):
        side = copy.deepcopy(state)
        reset_launch_counts()
        with path():
            side_logs = side.train_step(batch)
        torch.cuda.synchronize()
        sides.append((side_logs, snapshot(side), launch_counts()))
        del side
    train_counts = sides[0][2]
    print(f"shapenet bf16 step: launches {train_counts}")
    check(only(train_counts, warp_fwd_bf16=1, warp_bwd_pos_bf16=1,
               warp_bwd_w1_bf16=1), f"shapenet bf16 step launched "
          f"{train_counts}")
    check(only(sides[1][2]), f"plain bf16 step launched {sides[1][2]}")
    loss_rel = rel_diff(sides[0][0], sides[1][0])
    print(f"shapenet bf16 kernel vs plain path, batch 8 at 256x256: losses "
          f"within {loss_rel:.3e} rel (bound {BF16_LOSS_REL:g})")
    check(loss_rel <= BF16_LOSS_REL, f"shapenet bf16 step losses {sides}")
    grads_by_rule("shapenet bf16 kernel vs plain path", sides[0][1],
                  sides[1][1], snap32, resolved=BF16_RESOLVED)
    step_times, _ = timed_steps(state, [batch] * 3)
    ms = statistics.median(step_times)
    print(f"shapenet bf16 train step batch 8 at 256x256: {ms:.3f} ms (steps "
          f"{', '.join(f'{t:.1f}' for t in step_times)}); f32 step "
          f"{train['ms']:.3f} ms, peak {train['peak']:.2f} GiB "
          f"(phase_shapenet_train)")
    return dict(serve=serve_counts["warp_fwd_bf16"], train=train_counts)


SHAPENET_STORE = "tests/fixtures/shapenet_car"  # 2 objects x 18 azimuths
DISK_SN_STEPS = 4   # 14b: steps from the store
DISK_SN_WORKERS = 2  # 14b: the training loader's spawned workers


def phase_shapenet_disk(serve, train):
    """14b. ShapeNet from its HDF5 store, through the port's own reader
    (gfla_tpu_torch/data/hdf5.py: the card's Python has no h5py): whether
    h5py imports here, printed; every view of the committed store
    (SHAPENET_STORE, 64x64: car0's images contiguous, car1's chunked with
    gzip) read through ShapeNetDataset and held to its digests.json;
    DISK_SN_STEPS full-width batch-8 D-then-G steps at 256x256 from the
    store through the training loader with DISK_SN_WORKERS spawned
    workers, from phase 14's state (path shapenet_disk_train: one launch of
    each warp kernel a step, and no other), finite losses; the loader's ms
    a batch and the step's ms beside phase 14's step on batches made in
    memory; one batch of the 18-view test sweep from the store through the
    serving task's run_test (path shapenet_disk_sweep: 2 sources x 18
    azimuths, one warp forward a view, each _vis.jpg through nvJPEG, named
    as gfla_tpu names them)."""
    import hashlib
    import importlib.util

    from gfla_tpu_torch.data import image_io, infinite, make_loader
    from gfla_tpu_torch.data.shapenet_data import ShapeNetDataset
    from gfla_tpu_torch.options import TestOptions
    from gfla_tpu_torch.runtime import card_line

    print(f"shapenet store: h5py importable here: "
          f"{importlib.util.find_spec('h5py') is not None}; the store is "
          f"read by gfla_tpu_torch/data/hdf5.py")
    root = os.path.abspath(SHAPENET_STORE)
    with open(os.path.join(root, "digests.json")) as f:
        digests = json.load(f)
    opt, ckpt = train_opt("--name=shapenet_disk", f"--dataroot={root}",
                          f"--nThreads={DISK_SN_WORKERS}", model="shapenet",
                          dataset="shapenet")
    dataset = ShapeNetDataset(opt)
    t0 = time.perf_counter()
    for key, want in digests.items():
        image, pose = dataset._image(key), dataset._pose(key)
        check(hashlib.sha256(image.tobytes()).hexdigest() == want["sha256"]
              and list(image.shape) == want["shape"]
              and str(image.dtype) == want["dtype"]
              and pose.tolist() == want["pose"],
              f"shapenet store: view {key} is not its digest")
    read_ms = (time.perf_counter() - t0) * 1e3 / len(digests)
    reader = type(dataset._data())
    check(reader.__module__ == "gfla_tpu_torch.data.hdf5",
          f"the store was read by {reader.__module__}")
    print(f"shapenet store: {len(digests)} views read through "
          f"ShapeNetDataset, each image's sha256, shape, dtype and pose "
          f"its digest's; {read_ms:.3f} ms a view (image and pose)")

    task = copy.deepcopy(train["state"])
    loader = make_loader(dataset, opt, train=True)
    batches = infinite(loader)
    load_ms, step_ms, logs = [], [], []
    reset_launch_counts()
    for _ in range(DISK_SN_STEPS):
        t0 = time.perf_counter()
        host = next(batches)
        load_ms.append((time.perf_counter() - t0) * 1e3)
        batch = task.prepare_batch(host)
        check(tuple(batch["P1"].shape) == (SHAPENET_B, 3, SHAPENET_SIZE,
                                           SHAPENET_SIZE)
              and tuple(batch["BP1"].shape) == (SHAPENET_B, 2),
              f"shapenet store batch {batch['P1'].shape}")
        times, step_logs = timed_steps(task, [batch])
        step_ms += times
        logs += step_logs
    torch.cuda.synchronize()
    counts = launch_counts()
    batches.close()
    if loader._iterator is not None:  # the persistent workers
        loader._iterator._shutdown_workers()
    del loader, batches
    print(f"shapenet from the store: {DISK_SN_STEPS} steps, launches "
          f"{counts}")
    check(only(counts, warp_fwd=DISK_SN_STEPS, warp_bwd_pos=DISK_SN_STEPS,
               warp_bwd_w1=DISK_SN_STEPS),
          f"shapenet from the store launched {counts}")
    for i, step_logs in enumerate(logs):
        check(sorted(step_logs) == sorted(task.loss_names + ["total_G"])
              and all(bool(torch.isfinite(v)) for v in step_logs.values()),
              f"shapenet from the store, step {i + 1}: losses {step_logs}")
    del task
    ckpt.cleanup()

    stask = serve["task"]
    topt = TestOptions().parse(SHAPENET + [f"--dataroot={root}",
                                           "--nThreads=0", "--batchSize=2"],
                               save=False)
    tset = ShapeNetDataset(topt)
    work = tempfile.TemporaryDirectory()
    sopt = copy.copy(stask.opt)
    sopt.results_dir, sopt.name = work.name, "disk_sweep"
    sources = [tset[i]["P1_path"] for i in range(len(tset))]
    want = sorted(f"{src}_2_{src.split('_')[0]}_{a // 10}_0_vis.jpg"
                  for src in sources for a in range(0, 360, 20))
    encodes = image_io.nvjpeg_encodes
    reset_launch_counts()
    t0 = time.perf_counter()
    n = stask.run_test(sopt, make_loader(tset, topt, train=False))
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    sweep = launch_counts()
    encodes = image_io.nvjpeg_encodes - encodes
    names = sorted(os.listdir(os.path.join(work.name, "disk_sweep")))
    work.cleanup()
    print(f"shapenet sweep from the store: run_test wrote {n} _vis.jpg "
          f"({encodes} nvJPEG encodes) for {len(sources)} sources at 18 "
          f"azimuths in {sweep_s:.2f} s; launches {sweep}")
    check(n == len(want) == 36 and names == want,
          f"shapenet sweep from the store wrote {n}: {names[:3]}")
    check(encodes == n, f"the sweep's {n} images took {encodes} nvJPEG "
          f"encodes")
    check(only(sweep, warp_fwd=18), f"the sweep launched {sweep}")
    print(f"shapenet from the store, batch 8 at 256x256 on "
          f"{card_line()!r}: loader {load_ms[0]:.1f} ms for the first "
          f"batch (its {DISK_SN_WORKERS} workers start), then "
          f"{statistics.median(load_ms[1:]):.3f} ms a batch (median; "
          f"{', '.join(f'{t:.2f}' for t in load_ms[1:])}); step "
          f"{statistics.median(step_ms[1:]):.3f} ms (median of the last "
          f"{DISK_SN_STEPS - 1}; steps "
          f"{', '.join(f'{t:.1f}' for t in step_ms)}) against "
          f"{train['ms']:.3f} ms on batches made in memory "
          f"(phase_shapenet_train)")
    return {"shapenet_disk_train": counts, "shapenet_disk_sweep": sweep}


ANIM_T = 6         # frames a chunk (--max_frames_per_gpu)
ANIM_SITES = 4     # ExtractorAttn sites a frame: 2 levels x (previous,
                   # reference)
ANIM_LAUNCHES = ANIM_SITES * ANIM_T  # each warp kernel's launches a chunk
ANIM_SIZE, ANIM_SMALL = 256, 64
ANIM_GRAD_REL = 1e-2  # kernel vs plain path, one step from one state: each
                      # network's gradient, relative L2 difference (a check
                      # for gross faults; the losses are held at
                      # TRAIN_LOSS_REL)


def anim_args(kind, *extra):
    """The CLIs' options for an animation head at full width, 256x256."""
    return [f"--model={kind}", "--dataset_mode=synthetic_video",
            f"--load_size={ANIM_SIZE}", "--gpu_ids=0",
            f"--n_frames_pre_load_test={ANIM_T}",
            f"--n_frames_total={ANIM_T}", *extra]


def anim_clips(opt, B, first=0):
    """Host batches of B clips each of the synthetic video dataset."""
    from gfla_tpu_torch.data import collate, get_dataset_class

    dataset = get_dataset_class(opt.dataset_mode)(opt)
    return [collate([dataset[(first + b * B + i) % len(dataset)]
                     for i in range(B)]) for b in range(4)]


def anim_full_width(g, kind):
    """The task's defaults: ngf 64, attention at levels 2 and 3 (k=5 over
    128 channels at 64x64, k=3 over 256 at 32x32), two streams a level."""
    t = g.target
    flow = g.flow_net if kind == "face" else g.flow_net_reference
    return (g.source_previous.block0.model[2].out_channels == 64
            and all(getattr(t, f"attn{s}{i}").kernel_size == k
                    and getattr(t, f"attn{s}{i}").fully_connect_layer[0]
                    .in_channels == 2 * c
                    for s in ("_p", "_r")
                    for i, k, c in ((0, 3, 256), (1, 5, 128)))
            and flow.output1.out_channels == (4 if kind == "face" else 2))


def check_clip(what, frames, B, T, size):
    check(tuple(frames.shape) == (B, T, 3, size, size)
          and frames.dtype == torch.float32, f"{what}: frames {frames.shape}")
    check(bool(torch.isfinite(frames).all()), f"{what}: non-finite frames")
    check(frames.min().item() >= -1 and frames.max().item() <= 1,
          f"{what}: frames outside [-1, 1]")


def stream(task, batches, path=contextlib.nullcontext):
    """test_step over prepared chunks, the carry passed along."""
    carry, frames = None, []
    with path():
        for batch in batches:
            gen, carry = task.test_step(batch, *(carry or (None, None)))
            frames.append(gen)
    return torch.cat(frames, dim=1)


def phase_anim_serve(kind):
    """The serving CLI's path of an animation head at full width: run_test
    over two consecutive 6-frame chunks of one batch-1 clip, the last frame
    and skeleton carried into the second; 24 warp-forward launches a chunk
    and nothing else; 12 _vis and 12 _gt PNGs under gfla_tpu's names; the
    frames on the kernels against the plain path; a 64x64 clip on the card
    against the CPU; ms per batch-2 chunk forward of both paths."""
    from gfla_tpu_torch.options import TestOptions
    from gfla_tpu_torch.tasks import create_task

    torch.cuda.empty_cache()
    work = tempfile.TemporaryDirectory()
    opt = TestOptions().parse(anim_args(
        kind, f"--results_dir={work.name}", f"--name={kind}_serve"),
        save=False)
    task = create_task(opt)
    check(anim_full_width(task.net_g, kind), f"not the full-width {kind}")
    print(f"{kind} generator: {sum(p.numel() for p in task.net_g.parameters())}"
          f" parameters on {task.device}")
    loader = anim_clips(opt, 1)[:2]
    reset_launch_counts()
    n = task.run_test(opt, loader)
    torch.cuda.synchronize()
    counts = launch_counts()
    out = os.path.join(work.name, f"{kind}_serve", "seq")
    names = sorted(os.listdir(out))
    want = sorted(f"{os.path.splitext(p)[0]}_{s}.png" for b in loader
                  for p in b["gen_paths"][0] for s in ("vis", "gt"))
    print(f"{kind} served 2 chunks of {ANIM_T} frames (batch 1): {n} frames, "
          f"launches {counts}, {len(names)} files")
    check(only(counts, warp_fwd=2 * ANIM_LAUNCHES),
          f"{kind} serving launched {counts}, expected "
          f"{ANIM_LAUNCHES} warp_fwd a chunk and nothing else")
    check(n == 2 * ANIM_T and names == want, f"{kind} wrote {names[:4]}")
    work.cleanup()

    chunks = [task.prepare_batch(b) for b in loader]
    frames = stream(task, chunks)
    check_clip(f"{kind} serving", frames, 1, 2 * ANIM_T, ANIM_SIZE)
    plain = stream(task, chunks, plain_warp)
    diff = (frames - plain).abs().max().item()
    print(f"{kind} 12 streamed frames, kernel path vs plain path: "
          f"max_abs_diff={diff:.3e} (bound {SLICE_ATOL:g})")
    check(diff <= SLICE_ATOL, f"{kind} kernel path vs plain path {diff:.3e}")

    small_opt = TestOptions().parse(anim_args(
        kind, f"--load_size={ANIM_SMALL}", "--n_frames_pre_load_test=3"),
        save=False)
    small = [task.prepare_batch(b) for b in anim_clips(small_opt, 2)[:2]]
    card = stream(task, small).cpu()
    cpu = copy.copy(task)
    cpu.net_g = copy.deepcopy(task.net_g).cpu()
    cpu_frames = stream(cpu, [{k: v.cpu() for k, v in b.items()}
                              for b in small])
    diff_cpu = (card - cpu_frames).abs().max().item()
    print(f"{kind} card vs CPU, 2 chunks of 3 frames at 2x{ANIM_SMALL}x"
          f"{ANIM_SMALL}: "
          f"max_abs_diff={diff_cpu:.3e} (bound {CPU_ATOL:g})")
    check(diff_cpu <= CPU_ATOL, f"{kind} card vs CPU {diff_cpu:.3e}")
    del cpu

    request = task.prepare_batch(anim_clips(opt, 2)[0])
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: task.test_step(request), iters=5, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2**20
    with plain_warp():
        plain_ms = cuda_ms(lambda: task.test_step(request), iters=5,
                           warmup=2)
    ms_again = cuda_ms(lambda: task.test_step(request), iters=5, warmup=1)
    print(f"{kind} chunk forward batch 2 x {ANIM_T} frames at 256x256: "
          f"kernel path {ms:.3f} ms (again {ms_again:.3f}), plain path "
          f"{plain_ms:.3f} ms, peak {peak:.0f} MiB")
    return dict(task=task, launches=counts["warp_fwd"], ms=ms)


def phase_anim_train(kind):
    """Four full-width chunk steps (batch 2 x 6 frames at 256x256) through
    train_main_path (24 launches of each warp kernel a step; finite losses;
    every parameter of G, D and D_V moved; D's u; save/resume; the plain
    path's time), then one step on the kernel path against the plain path
    from one state: losses within TRAIN_LOSS_REL, each network's gradient
    within ANIM_GRAD_REL in relative L2."""
    from gfla_tpu_torch.tasks import create_task

    opt, ckpt = train_opt(f"--name={kind}_train", "--batchSize=2",
                          f"--n_frames_total={ANIM_T}", model=kind,
                          dataset="synthetic_video")
    task = create_task(opt)
    check(anim_full_width(task.net_g, kind) and task.net_d.layers == 4,
          f"not the full-width {kind} config")
    batches = [task.prepare_batch(b) for b in anim_clips(opt, 2)]
    batches.append(batches[0])
    state0 = copy.deepcopy(task)
    counts, times, plain_times, peak = train_main_path(
        task, opt, batches, f"{kind} ", warp_fwd=ANIM_LAUNCHES * TRAIN_STEPS,
        warp_bwd_pos=ANIM_LAUNCHES * TRAIN_STEPS,
        warp_bwd_w1=ANIM_LAUNCHES * TRAIN_STEPS)
    del task
    ckpt.cleanup()

    state = off_the_kinks(state0)
    del state0
    sides = []
    for path in (contextlib.nullcontext, plain_warp):
        side = copy.deepcopy(state)
        with path():
            logs = side.train_step(batches[0])
        sides.append((logs, snapshot(side)))
        del side
    loss_rel = rel_diff(*(logs for logs, _ in sides))
    grad_rel = {}
    for tag in sides[0][1]:
        a, b = (torch.cat([g.flatten() for g in snap[tag]["grads"].values()])
                for _, snap in sides)
        grad_rel[tag] = ((a - b).norm() / b.norm()).item()
    print(f"{kind} kernel vs plain path, one step b2 x {ANIM_T} frames at "
          f"256x256: losses within {loss_rel:.3e} rel (bound "
          f"{TRAIN_LOSS_REL:g}); gradients within "
          + ", ".join(f"{t} {r:.3e}" for t, r in grad_rel.items())
          + f" in relative L2 (bound {ANIM_GRAD_REL:g})")
    check(loss_rel <= TRAIN_LOSS_REL, f"{kind} step losses {sides[0][0]} vs "
          f"{sides[1][0]}")
    check(max(grad_rel.values()) <= ANIM_GRAD_REL,
          f"{kind} step gradients {grad_rel}")
    ms = statistics.median(times[1:])
    print(f"{kind} train step b2 x {ANIM_T} frames at 256x256: kernel path "
          f"{ms:.3f} ms (steps {', '.join(f'{t:.1f}' for t in times)}), "
          f"plain path {statistics.median(plain_times):.3f} ms (steps "
          f"{', '.join(f'{t:.1f}' for t in plain_times)}), peak "
          f"{peak:.2f} GiB")
    return dict(counts=counts, state=state, batch=batches[0], ms=ms,
                peak=peak)


def phase_anim_switches(train):
    """One dance step under GFLA_ATTN_PALLAS=1 (24 launches of each
    attention-math kernel, no warp) and one under GFLA_PALLAS_CORR=1 (the
    warp's 24 + 24 + 24, and 4 max-correlation launches: the previous and
    the reference stream's correctness at two layers), each against the
    default path's step from the same state."""
    state, batch = train["state"], train["batch"]
    want = copy.deepcopy(state).train_step(batch)
    opt = state.opt
    # the correctness losses are, per level, mean(exp(-cs / cmax)) - 1/e,
    # near 0 at the init: each is held relative to the size of the terms
    # that the - 1/e cancels, lambda_correct / e per level (the kernel's
    # cmax moves them by ~1e-6 of that); every other loss to its own value
    scale = {name: opt.lambda_correct * len(opt.attn_layer) / np.e
             for name in ("correctness_p", "correctness_r")}
    counts = {}
    for name, env in (("attn", dict(GFLA_ATTN_PALLAS="1")),
                      ("corr", dict(GFLA_PALLAS_CORR="1"))):
        task = copy.deepcopy(state)
        with switches(**env):
            reset_launch_counts()
            got = task.train_step(batch)
            torch.cuda.synchronize()
            counts[name] = launch_counts()
            times, _ = timed_steps(task, [batch] * 2)
        rel = {n: abs(float(got[n]) - float(w))
               / max(abs(float(w)), scale.get(n, 0.0), 1e-30)
               for n, w in want.items()}
        worst = max(rel, key=rel.get)
        del task
        print(f"{env} dance step: launches {counts[name]}; losses within "
              f"{rel[worst]:.3e} rel of the default path ({worst}; bound "
              f"{TRAIN_LOSS_REL:g}; correctness_p {rel['correctness_p']:.3e},"
              f" correctness_r {rel['correctness_r']:.3e} of "
              f"{scale['correctness_p']:.3f}); "
              f"{statistics.median(times):.3f} ms per step (steps "
              f"{', '.join(f'{t:.1f}' for t in times)})")
        check(rel[worst] <= TRAIN_LOSS_REL,
              f"{env}: losses {got} vs {want}")
    check(only(counts["attn"], attn_math_fwd=ANIM_LAUNCHES,
               attn_math_bwd=ANIM_LAUNCHES),
          f"GFLA_ATTN_PALLAS=1 dance launches {counts['attn']}")
    check(only(counts["corr"], warp_fwd=ANIM_LAUNCHES,
               warp_bwd_pos=ANIM_LAUNCHES, warp_bwd_w1=ANIM_LAUNCHES,
               max_corr=4),
          f"GFLA_PALLAS_CORR=1 dance launches {counts['corr']}")
    return dict(dance_train_attn=counts["attn"],
                dance_train_corr=counts["corr"])


VIDEO_SEQS, VIDEO_FRAMES = 3, 14   # sequences and frames a phase of a tree
FACE_FRAME = (240, 320)            # the face tree's frames: not 256x256


def face_landmarks(rng, H, W):
    """68 iBUG-ordered landmarks (x, y) of a frontal cartoon face filling
    about half of an H x W frame, jittered: the jaw, brows, nose, eyes and
    the outer and inner lips."""
    cx, cy = W * rng.uniform(0.45, 0.55), H * rng.uniform(0.5, 0.58)
    s = min(H, W) / 256.0 * rng.uniform(0.9, 1.1)
    pts = np.zeros((68, 2))
    a = np.pi - np.pi * np.arange(17) / 16.0
    pts[:17] = np.stack([cx + 70 * s * np.cos(a), cy + 93 * s * np.sin(a)], 1)
    pts[[0, 16], 1] = cy - 5 * s
    for k, sign in ((17, -1.0), (22, 1.0)):
        t = np.linspace(0, 1, 5)
        x0, x1 = cx + sign * 52 * s, cx + sign * 14 * s
        xs = x0 + (x1 - x0) * t if sign < 0 else x1 + (x0 - x1) * t
        pts[k:k + 5] = np.stack([xs, cy - (48 + 5 * np.sin(np.pi * t)) * s],
                                1)
    pts[27:31] = np.stack([np.full(4, cx), cy + (-25 + 13 * np.arange(4)) * s],
                          1)
    pts[31:36] = np.stack([cx + (-12 + 6 * np.arange(5)) * s,
                           np.full(5, cy + 20 * s)], 1)
    ang = np.array([np.pi, 2, 1, 0, -1, -2]) * np.pi / 3
    ang[0] = np.pi
    for k, ex in ((36, cx - 32 * s), (42, cx + 32 * s)):
        pts[k:k + 6] = np.stack([ex + 14 * s * np.cos(ang),
                                 cy - 22 * s - 6 * s * np.sin(ang)], 1)
    a = np.pi + 2 * np.pi * np.arange(12) / 12
    pts[48:60] = np.stack([cx + 24 * s * np.cos(a),
                           cy + 45 * s - 10 * s * np.sin(a)], 1)
    a = np.array([4, 3, 2, 1, 0, -1, -2, -3]) * np.pi / 4
    pts[60:68] = np.stack([cx + 17 * s * np.cos(a),
                           cy + 45 * s - 5 * s * np.sin(a)], 1)
    return pts + rng.uniform(-1.5, 1.5, pts.shape)


def face_frame(rng, pts, H, W):
    """uint8 (H, W, 3): a background gradient, the face's skin, eyes and
    lips as hard-edged polygons (the port's fill_poly), and noise."""
    from gfla_tpu_torch.data.raster import fill_poly

    yy = np.mgrid[:H, :W][0][..., None] / H
    img = rng.uniform(30, 220, 3) * (1 - yy) + rng.uniform(30, 220, 3) * yy
    img = img.astype(np.uint8)
    for idx, colour in ((range(17), rng.uniform(140, 230, 3)),
                        (range(36, 42), (40, 40, 60)),
                        (range(42, 48), (40, 40, 60)),
                        (range(48, 60), rng.uniform(120, 220, 3))):
        mask = np.zeros((H, W), np.uint8)
        fill_poly(mask, pts[list(idx)].astype(np.int32), 1)
        img[mask > 0] = np.asarray(colour, np.uint8)
    noise = rng.randint(-6, 7, img.shape)
    return np.clip(img.astype(np.int32) + noise, 0, 255).astype(np.uint8)


def dance_joints(rng, H, W, k):
    """(k, 3) OpenPose rows (x, y, confidence) of a standing figure in an
    H x W frame, jittered; one joint in six missing (all 0) and one past
    the frame's edge."""
    y = np.linspace(0.15, 0.9, k) * H + rng.uniform(-8, 8, k)
    x = W / 2 + rng.uniform(-0.3, 0.3, k) * W
    rows = np.stack([x, y, np.ones(k)], 1)
    rows[rng.rand(k) < 1 / 6] = 0
    rows[rng.randint(k), 0] = W + rng.uniform(2, 20)
    return rows


MASK_FORMATS = ("L", "RGB")  # the dance trees' masks, sequence by sequence


def dance_mask(rows, H, W, fmt):
    """A person mask around an OpenPose skeleton (k, 3): disks of radius
    max(2, H // 12) at the joints and along each limb, 255 inside, as a
    grey (H, W) picture ("L"), or RGB with each channel its own share of it
    ("RGB", "JPEG": PIL's grey conversion mixes them)."""
    from gfla_tpu_torch.data import openpose_utils
    from gfla_tpu_torch.data.raster import circle_filled

    mask = np.zeros((H, W), np.uint8)
    r = max(2, H // 12)
    for f, t in openpose_utils.LIMB_SEQ_HUMAN36M_17:
        if rows[f, 2] and rows[t, 2]:
            for a in np.linspace(0, 1, 6):
                x, y = rows[f, :2] + a * (rows[t, :2] - rows[f, :2])
                circle_filled(mask, (int(x), int(y)), r, 255)
    if fmt == "L":
        return mask
    return (mask[..., None].astype(np.float32)
            * np.array([1.0, 0.8, 0.6], np.float32)).astype(np.uint8)


def write_video_tree(root, kind, H, W, seed, device, seqs=VIDEO_SEQS,
                     frames=VIDEO_FRAMES, mask_formats=MASK_FORMATS):
    """A dance (iPER layout: `{phase}_256/train_A`, `train_video2d` with
    17-joint and `train_alphapose` with 18-joint skeleton JSONs, `train_C`
    the person masks, sequence s in `mask_formats[s % len]`: a grey or RGB
    PNG or a JPEG) or face (FaceForensics layout: `{phase}_data`,
    `{phase}_keypoints` with 68-point txt files) tree of H x W frames,
    train and test, encoded by image_io.encode_jpeg on `device` (nvJPEG on
    the card, PIL on the CPU). A dance frame now and then has no person.
    Returns {path: picture} of the frames."""
    from gfla_tpu_torch.data import openpose_utils
    from gfla_tpu_torch.data.image_io import encode_jpeg, write_png

    rng = np.random.RandomState(seed)
    sources = {}
    for phase in ("train", "test"):
        for s in range(seqs):
            seq = f"seq_{s:03d}"
            if kind == "dance":
                base = os.path.join(root, f"{phase}_256")
                dirs = [os.path.join(base, d, seq) for d in
                        ("train_A", "train_video2d", "train_alphapose",
                         "train_C")]
                fmt = mask_formats[s % len(mask_formats)]
            else:
                dirs = [os.path.join(root, f"{phase}_{d}", seq)
                        for d in ("data", "keypoints")]
            for d in dirs:
                os.makedirs(d)
            for t in range(frames):
                name = f"frame_{t:05d}"
                if kind == "dance":
                    clean = dance_joints(rng, H, W, 17)
                    noise = dance_joints(rng, H, W, 18)
                    img = disk_images(1, H, W, seed * 1000 + s * 100 + t)[0]
                    pose = clean[:, 1::-1].T.astype(int)  # (2, 17) (y, x)
                    openpose_utils.draw_joint(
                        img, np.clip(pose, 0, [[H - 1], [W - 1]]),
                        openpose_utils.LIMB_SEQ_HUMAN36M_17, radius=4)
                    empty = rng.rand() < 0.1
                    for d, rows in ((dirs[1], clean), (dirs[2], noise)):
                        people = [] if empty else [
                            {"pose_keypoints_2d": rows.ravel().tolist()}]
                        with open(os.path.join(d, name + ".json"), "w") as f:
                            json.dump({"people": people}, f)
                    mask = dance_mask(clean, H, W, fmt)
                    if fmt == "JPEG":
                        with open(os.path.join(dirs[3], name + ".jpg"),
                                  "wb") as f:
                            f.write(encode_jpeg(
                                torch.from_numpy(mask).to(device)))
                    else:
                        write_png(os.path.join(dirs[3], name + ".png"), mask)
                else:
                    pts = face_landmarks(rng, H, W)
                    img = face_frame(rng, pts, H, W)
                    np.savetxt(os.path.join(dirs[1], name + ".txt"), pts,
                               delimiter=",", fmt="%.3f")
                path = os.path.join(dirs[0], name + ".jpg")
                with open(path, "wb") as f:
                    f.write(encode_jpeg(torch.from_numpy(img).to(device)))
                sources[path] = img
    return sources


VIDEO_STEPS = 3         # dance steps from disk: one 6-frame chunk each
FACE_FIXTURE = "tests/fixtures/face_q75_240x320"
CANNY_SHARE_MAX = 0.02  # Canny pixels nvJPEG's and PIL's decodes disagree
                        # on, of those either marks as edge, on the fixture


def video_paths(batch):
    return [list(paths) for paths in batch["gen_paths"]]


def video_serve(kind, args):
    """The serving CLI's `main` in-process over a tree's test sequences:
    its output lines, the launch counts, and each chunk's (first frame,
    whether the carry was reset) in order."""
    from gfla_tpu_torch.tasks.animation import AnimationTaskBase

    test_step = AnimationTaskBase.test_step
    chunks = []

    def recording_step(self, batch, pre_image=None, pre_skeleton=None):
        chunks.append(pre_image is None)
        return test_step(self, batch, pre_image, pre_skeleton)

    with mock.patch.object(AnimationTaskBase, "test_step", recording_step):
        lines, counts = serve_from_disk(f"{kind} serve from disk", args)
    return lines, counts, chunks


def check_streamed(kind, results, tree_root, lines, counts, resets,
                   has_cv2):
    """gfla_tpu's file names for every frame of every test sequence, one
    ref_ref each, the carry reset at each sequence's first chunk only, 24
    warp-forward launches a chunk and nothing else, and the stitch's line
    for each sequence (an mp4 where cv2 imports, else the line saying it
    was not written) after its frames."""
    frames_dir = os.path.join(tree_root, "test_256", "train_A") \
        if kind == "dance" else os.path.join(tree_root, "test_data")
    seqs = sorted(os.listdir(frames_dir))
    chunks = -(-VIDEO_FRAMES // ANIM_T)
    for seq in seqs:
        names = sorted(os.listdir(os.path.join(results, seq)))
        want = sorted([f"frame_{t:05d}_{s}.png" for t in range(VIDEO_FRAMES)
                       for s in ("vis", "gt")] + ["ref_ref.png"])
        check(names == want, f"{kind} {seq}: wrote {names[:5]}...")
    check(resets == ([True] + [False] * (chunks - 1)) * len(seqs),
          f"{kind}: carry resets {resets}")
    check(only(counts, warp_fwd=ANIM_LAUNCHES * chunks * len(seqs)),
          f"{kind} serving from disk launched {counts}")
    stitched = [line for line in lines if line.startswith(
        "write video" if has_cv2 else "write2video: no cv2 here")]
    check(len(stitched) == len(seqs) and all(
        os.path.join(results, seq) in line
        for seq, line in zip(seqs, stitched)),
        f"{kind}: the stitch printed {stitched}")
    done = [i for i, line in enumerate(lines) if line.startswith("wrote ")]
    check(done and lines.index(stitched[-1]) < done[0],
          f"{kind}: the stitch's line is not before the frame count")
    print(f"{kind} streamed {len(seqs)} test sequences of {VIDEO_FRAMES} "
          f"frames from disk ({chunks} chunks of {ANIM_T} each, padded): "
          f"launches {counts}; {len(resets)} chunks, the carry reset at "
          f"each sequence's first; {2 * VIDEO_FRAMES + 1} files a sequence; "
          f"the stitch said: {stitched[0]}")


def phase_video_disk(device, synthetic_ms):
    """dance disk, face disk: the animation heads from trees on disk,
    written here through nvJPEG (numpy skeletons and landmarks), trained
    (dance) and served (both) through the two CLIs' entry points; the
    prepared frames against their sources; the device face structure, Canny
    included, bitwise against the CPU's on the same decoded pixels; nvJPEG
    against PIL under Canny on a committed fixture; host sample, device
    prepare and step times. `synthetic_ms`: phase 18's ms per chunk step
    on the synthetic clips."""
    from gfla_tpu_torch.data import collate, get_dataset_class, image_io
    from gfla_tpu_torch.data.raster import canny_l1
    from gfla_tpu_torch.data.resample import (
        convert_l,
        pil_resize,
        resample_images,
    )
    from gfla_tpu_torch.options import TestOptions, TrainOptions
    from gfla_tpu_torch.tasks.animation import (
        CANNY_HIGH,
        CANNY_LOW,
        AnimationTaskBase,
        face_structure,
    )
    from gfla_tpu_torch.tasks.animation import prepare_batch as prepare

    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.TemporaryDirectory()
    trees = {"dance": (os.path.join(work.name, "dance"), ANIM_SIZE,
                       ANIM_SIZE),
             "face": (os.path.join(work.name, "face"), *FACE_FRAME)}
    t0 = time.perf_counter()
    encodes = image_io.nvjpeg_encodes
    sources = {}
    for i, (kind, (root, H, W)) in enumerate(trees.items()):
        sources.update(write_video_tree(root, kind, H, W, 90 + i, device))
    check(image_io.nvjpeg_encodes - encodes == len(sources),
          "video frames not encoded on nvJPEG")
    print(f"video disk: wrote a dance tree ({ANIM_SIZE}x{ANIM_SIZE}) and a "
          f"face tree ({FACE_FRAME[0]}x{FACE_FRAME[1]}), {VIDEO_SEQS} "
          f"sequences x {VIDEO_FRAMES} frames a phase each, {len(sources)} "
          f"JPEGs through nvJPEG, in {time.perf_counter() - t0:.2f} s")
    ckpt = os.path.join(work.name, "ckpt")
    common = {kind: [f"--model={kind}", f"--dataset_mode={kind}",
                     f"--dataroot={root}", "--gpu_ids=0",
                     f"--load_size={ANIM_SIZE}", f"--checkpoints_dir={ckpt}",
                     f"--name={kind}_disk",
                     f"--n_frames_pre_load_test={ANIM_T}"]
              for kind, (root, _, _) in trees.items()}
    counts = {}

    # dance: three full-width batch-2 chunk steps through the training CLI
    initial = []
    lines, train_counts, task, prepared, step_ms = train_from_disk(
        "dance train from disk",
        [*common["dance"], "--batchSize=2", f"--n_frames_total={ANIM_T}",
         f"--max_iters={VIDEO_STEPS}", "--print_freq=1"], VIDEO_STEPS,
        task_cls=AnimationTaskBase, paths=video_paths, initial=initial)
    for line in lines:
        if line.startswith(("dataset [", "(epoch:")):
            print(f"  {line}")
    check(only(train_counts, warp_fwd=ANIM_LAUNCHES * VIDEO_STEPS,
               warp_bwd_pos=ANIM_LAUNCHES * VIDEO_STEPS,
               warp_bwd_w1=ANIM_LAUNCHES * VIDEO_STEPS),
          f"dance train from disk launched {train_counts}, expected "
          f"{ANIM_LAUNCHES} of each warp kernel a step")
    check(anim_full_width(task.net_g, "dance") and task.net_d.layers == 4,
          "dance from disk: not the full-width configuration")
    for tag, net in nets(task).items():
        still = [n for n, p in net.named_parameters()
                 if torch.equal(p, initial[0][tag]["params"][n])]
        check(not still, f"dance from disk {tag}: parameters unchanged: "
                         f"{still}")
    losses = [line for line in lines if line.startswith("(epoch:")]
    check(len(losses) == VIDEO_STEPS and "nan" not in " ".join(losses),
          f"dance from disk: loss lines {losses}")
    check(len(prepared) == VIDEO_STEPS and all(
        len(b) == 2 and all(len(clip) == ANIM_T for clip in b)
        for b in prepared), f"dance from disk prepared {prepared}")
    counts["dance_disk_train"] = train_counts
    print(f"dance from disk: {VIDEO_STEPS} steps, launches {train_counts}; "
          f"every parameter of G, D and D_V moved")

    # both heads: the serving CLI over the test sequences
    # (face's with cv2 hidden: the line a machine without cv2 prints)
    import importlib.util

    has_cv2 = importlib.util.find_spec("cv2") is not None
    print(f"cv2 {'imports' if has_cv2 else 'does not import'} here")
    results = os.path.join(work.name, "results")
    for kind, (root, _, _) in trees.items():
        args = [*common[kind], f"--results_dir={results}", "--nThreads=0"]
        if kind == "dance":
            args.append(f"--which_iter={VIDEO_STEPS}")
        hide = mock.patch.dict(sys.modules, {"cv2": None}) \
            if kind == "face" else contextlib.nullcontext()
        with hide:
            lines, serve_counts, resets = video_serve(kind, args)
        check_streamed(kind, os.path.join(results, f"{kind}_disk"), root,
                       lines, serve_counts, resets,
                       has_cv2 and kind == "dance")
        counts[f"{kind}_disk_serve"] = serve_counts

    # each prepared frame against its source picture (phase 11's rule),
    # and the face structure on the card against the CPU's
    for kind, (root, _, _) in trees.items():
        opt = TestOptions().parse(common[kind], save=False)
        dataset = get_dataset_class(kind)(opt)
        batch = collate([dataset[0]])
        dev = prepare(batch, device, opt)
        src = torch.stack([torch.from_numpy(sources[p])
                           for p in batch["gen_paths"][0]]).to(device)
        want = resample_images(list(src), (ANIM_SIZE, ANIM_SIZE),
                               torch.from_numpy(batch["P_all_inv"][0])
                               .to(device))
        err = (dev["P_all"][0].permute(0, 2, 3, 1) - want).abs().mean(
            dim=(1, 2, 3)).max().item()
        print(f"{kind}: each prepared frame within {err:.4f} mean |diff| "
              f"of its source picture (bound {PREPARED_MEAN_ABS:g})")
        check(err <= PREPARED_MEAN_ABS, f"{kind}: prepared frames {err:.4f}")
        if kind != "face":
            continue
        decoded = image_io.decode_jpeg_batch(batch["P_all"][0], device,
                                             batch["gen_paths"][0])
        args = [torch.from_numpy(batch[k][0]) for k in
                ("edges", "labels", "dist")]
        on_card = face_structure(*(a.to(device) for a in args), decoded,
                                 True).cpu()
        on_cpu = face_structure(*args, [d.cpu() for d in decoded], True)
        background = (on_card[..., 0] > 0).sum() - (args[0] > 0).sum()
        apart = (on_card != on_cpu).flatten(0, -2).sum(0).tolist()
        print(f"face structure {tuple(on_card.shape)} on the card vs the "
              f"CPU on the same nvJPEG pixels: values apart by channel "
              f"{apart} (bitwise: all 0); {int(background)} Canny pixels "
              f"beyond the curves")
        check(torch.equal(on_card, on_cpu) and background > 0,
              f"face structure: card and CPU differ in {apart}")
    fixture = np.fromfile(os.path.join(here, FACE_FIXTURE + ".jpg"),
                          np.uint8)
    pil = torch.from_numpy(np.load(os.path.join(here, FACE_FIXTURE +
                                                ".npy"))).to(device)
    nv = image_io.decode_jpeg_batch([fixture], device, [FACE_FIXTURE])[0]
    edges = [canny_l1(pil_resize(convert_l(img)[..., None],
                                 (ANIM_SIZE, ANIM_SIZE), "bicubic")[..., 0],
                      CANNY_LOW, CANNY_HIGH) for img in (nv, pil)]
    union = (edges[0] | edges[1]).sum().item()
    share = (edges[0] ^ edges[1]).sum().item() / max(union, 1)
    print(f"Canny on {FACE_FIXTURE}.jpg, nvJPEG's decode vs PIL's: "
          f"{share * 100:.3f}% of the {union} pixels either marks as edge "
          f"differ (bound {CANNY_SHARE_MAX * 100:g}%)")
    check(union > 0 and share <= CANNY_SHARE_MAX,
          f"Canny nvJPEG vs PIL {share:.4f}")

    # times: a worker's sample, the device prepare, the step from disk
    for kind in trees:
        opt = TrainOptions().parse(
            [*common[kind], "--batchSize=2", f"--n_frames_total={ANIM_T}"],
            save=False)
        dataset = get_dataset_class(kind)(opt)
        t0 = time.perf_counter()
        samples = [dataset[i % len(dataset)] for i in range(4)]
        sample_ms = (time.perf_counter() - t0) * 1e3 / len(samples)
        batch = collate(samples[:2])
        prepare_ms = host_ms(lambda: prepare(batch, device, opt))
        print(f"{kind} from disk: host sample {sample_ms:.1f} ms (one "
              f"{ANIM_T}-frame clip, a loader worker's __getitem__), device "
              f"prepare_batch {prepare_ms:.3f} ms per batch-2 chunk ("
              f"{2 * ANIM_T + (2 if kind == 'dance' else 0)} decodes, "
              f"warp-resize, "
              f"{'heatmaps' if kind == 'dance' else 'grey, bicubic, Canny'})")
    step = statistics.median(step_ms[1:])
    print(f"dance chunk step from disk {step:.3f} ms (steps "
          f"{', '.join(f'{t:.1f}' for t in step_ms)}) beside the synthetic "
          f"clips' {synthetic_ms:.3f} ms (phase 18)")
    del task
    work.cleanup()
    return counts


ANIM_BF16 = "--compute_dtype=bfloat16"
MASK_SEQS, MASK_FRAMES = 2, ANIM_T + 1  # the --use_mask tree: sequences,
                                        # frames a phase


def device_busy_ms(fn):
    """Device-busy milliseconds of one call of `fn`, warm, under
    torch.profiler (the card's activity only): the card's kernels and
    copies summed, without the ranges drawn around them
    (tools/serve_profile.py's rule), from the profiler's raw events
    (building its event tree costs seconds for a chunk step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gfla_tpu_torch.tools.serve_profile import is_annotation

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and not is_annotation(types.SimpleNamespace(
                   is_user_annotation=e.is_user_annotation(),
                   name=e.name())))
    check(busy > 0, "the profiler recorded no device time")
    return busy / 1e6


ANIM_RULE = dict(resolved=BF16_RESOLVED, hold=ANIM_BF16_STEP_HOLD,
                 one_element=False, l2=BF16_L2, loose=ANIM_LOOSE)


def planted_faults(what, kernel, plain, f32, rule=ANIM_RULE):
    """The animation hold (`rule`, ANIM_RULE by default) read on the kernel
    path's step with a fault planted in one warp-fed G gradient, scaled by
    1.5 and then zeroed: each must fail it. The tensor: of the flow nets' and the
    attention's that the hold holds tensor by tensor, the one the plain
    bf16 path resolves best (the least L2 distance to the f32 gradient, x
    its norm)."""
    g32, gp = f32["G"]["grads"], plain["G"]["grads"]
    fed = [n for n in g32 if (n.startswith("flow_net") or ".attn" in n)
           and g32[n].numel() > 1 and not ANIM_LOOSE.search(n)
           and g32[n].norm().item() > 0]
    name = min(fed, key=lambda n: (gp[n] - g32[n]).norm().item()
               / g32[n].norm().item())
    for scale in (1.5, 0.0):
        grads = dict(kernel["G"]["grads"])
        grads[name] = grads[name] * scale
        try:
            grads_by_rule(f"{what}, {name} x {scale:g} planted",
                          {"G": {"grads": grads}}, plain, {"G": f32["G"]},
                          **rule)
        except RuntimeError as fault:
            print(f"{what}: the hold fails {name} x {scale:g}: {fault}")
            continue
        check(False, f"{what}: the hold let {name} x {scale:g} pass")


def anim_bf16_train(kind, f32_train):
    """Four full-width bf16 chunk steps of one head through
    train_main_path (24 launches of each bf16 warp kernel a step and
    nothing else; finite losses; every parameter moved, in f32; D's u
    computed in bf16, stored in f32; save/resume); the task's test_step in
    f32 (24 f32 warp-forward launches), as gfla_tpu serves whatever the
    flag; one step on the kernel path against the plain bf16 path from one
    state, both against the f32 step (grads_by_rule), D_V's convolutions
    (dance's 3-D ones on cuDNN) taking and giving bf16 there, and a fault
    planted in that step (planted_faults); the wall ms of an f32 and a
    bf16 step, the device-busy ms of one of each under the profiler and the
    idle share, and peak memory beside phase 18's f32 step's
    (`f32_train`). Returns the counts, and for dance the state, batch and
    f32 snapshot the switches and --remat start from."""
    from gfla_tpu_torch.tasks import create_task

    opt, ckpt = train_opt(f"--name={kind}_train_bf16", "--batchSize=2",
                          f"--n_frames_total={ANIM_T}", ANIM_BF16,
                          model=kind, dataset="synthetic_video")
    task = create_task(opt)
    check(anim_full_width(task.net_g, kind)
          and task.vgg.conv1_1.weight.dtype == torch.bfloat16,
          f"{kind} bf16: not the full width, or VGG19 not cast once")
    batches = [task.prepare_batch(b) for b in anim_clips(opt, 2)]
    batches.append(batches[0])
    state0 = copy.deepcopy(task)
    counts, times, plain_times, peak = train_main_path(
        task, opt, batches, f"{kind} bf16 ",
        warp_fwd_bf16=ANIM_LAUNCHES * TRAIN_STEPS,
        warp_bwd_pos_bf16=ANIM_LAUNCHES * TRAIN_STEPS,
        warp_bwd_w1_bf16=ANIM_LAUNCHES * TRAIN_STEPS)
    for tag, net in nets(task).items():
        u = [b for n, b in net.named_buffers() if n.endswith("weight_u")]
        check(all(b.dtype == torch.float32 for b in u),
              f"{kind} bf16 {tag}: u not stored in f32")
    reset_launch_counts()
    frames = task.test_step(batches[0])[0]
    torch.cuda.synchronize()
    served = launch_counts()
    print(f"{kind} bf16 task served a chunk: launches {served}")
    check(only(served, warp_fwd=ANIM_LAUNCHES), f"{kind} bf16 task's "
          f"test_step launched {served}, expected {ANIM_LAUNCHES} warp_fwd "
          f"(G's f32 parameters) and nothing else")
    check_clip(f"{kind} bf16 task serving", frames, 2, ANIM_T, ANIM_SIZE)
    del task
    ckpt.cleanup()

    state = off_the_kinks(state0)
    del state0
    f32 = copy.deepcopy(state)
    f32.dtype = torch.float32
    f32.vgg.float()
    f32.train_step(batches[0])
    snap32 = snapshot(f32)
    sides, d_v_convs = [], []
    for path in (contextlib.nullcontext, plain_warp):
        side = copy.deepcopy(state)
        hooks = [m.register_forward_hook(
            lambda mod, args, out: d_v_convs.append(
                (args[0].dtype, out.dtype)))
            for m in side.net_d_v.modules()
            if isinstance(m, (torch.nn.Conv3d, torch.nn.Conv2d))
            or type(m).__name__.startswith("SpectralConv")]
        with path():
            side_logs = side.train_step(batches[0])
        for hook in hooks:
            hook.remove()
        sides.append((side_logs, snapshot(side)))
        if path is contextlib.nullcontext:
            bf16 = side  # the kernel path's task, timed below
        del side
    kinds = sorted({f"{a} -> {b}" for a, b in d_v_convs})
    print(f"{kind} bf16 D_V: {len(d_v_convs)} convolutions "
          f"({'3-D and 2-D' if kind == 'dance' else '2-D'}) in the two "
          f"steps, each {', '.join(kinds)}")
    check(kinds == ["torch.bfloat16 -> torch.bfloat16"],
          f"{kind} bf16 D_V convolutions ran {kinds}")
    loss_rel = rel_diff(sides[0][0], sides[1][0])
    print(f"{kind} bf16 kernel vs plain path, b2 x {ANIM_T} frames at "
          f"256x256: losses within {loss_rel:.3e} rel (bound "
          f"{BF16_LOSS_REL:g})")
    check(loss_rel <= BF16_LOSS_REL, f"{kind} bf16 step losses {sides}")
    grads_by_rule(f"{kind} bf16 kernel vs plain path", sides[0][1],
                  sides[1][1], snap32, **ANIM_RULE)
    planted_faults(f"{kind} bf16 kernel vs plain path", sides[0][1],
                   sides[1][1], snap32)
    del sides

    # an f32 and a bf16 step, each from a state one step on (warm)
    walls, busy = {}, {}
    for side, work in (("f32", f32), ("bf16", bf16)):
        walls[side] = timed_steps(work, batches[1:2])[0][0]
        busy[side] = device_busy_ms(lambda: work.train_step(batches[2]))
    del f32, bf16
    ms = statistics.median(times[1:])
    print(f"{kind} bf16 train step b2 x {ANIM_T} frames at 256x256: kernel "
          f"path {ms:.3f} ms (steps {', '.join(f'{t:.1f}' for t in times)})"
          f", plain bf16 path {statistics.median(plain_times):.3f} ms, peak "
          f"{peak:.2f} GiB; f32 step {f32_train['ms']:.3f} ms, peak "
          f"{f32_train['peak']:.2f} GiB (phase 18)")
    for side, wall in walls.items():
        print(f"{kind} {side} chunk step: wall {wall:.3f} ms, device busy "
              f"{busy[side]:.3f} ms under the profiler, idle share "
              f"{1 - busy[side] / wall:.3f}")
    if kind != "dance":
        return dict(counts=counts)
    return dict(counts=counts, state=state, batch=batches[0], snap32=snap32)


def anim_bf16_switches(train):
    """One bf16 dance chunk step under GFLA_ATTN_PALLAS=1 (24 + 24 bf16
    attention-math launches, no warp) held against its plain twins' step
    (grads_by_rule), and one under GFLA_PALLAS_CORR=1 (the bf16 warp's
    24 + 24 + 24 and 4 max-correlation launches on the widened f32
    features); each step's losses against the default path's bf16 step
    (BF16_LOSS_REL; the correctness losses relative to the size of the
    terms their - 1/e cancels, as phase 19 holds them)."""
    state, batch = train["state"], train["batch"]
    want = copy.deepcopy(state).train_step(batch)
    opt = state.opt
    scale = {name: opt.lambda_correct * len(opt.attn_layer) / np.e
             for name in ("correctness_p", "correctness_r")}
    counts = {}
    for name, env in (("attn", dict(GFLA_ATTN_PALLAS="1")),
                      ("corr", dict(GFLA_PALLAS_CORR="1"))):
        task = copy.deepcopy(state)
        with switches(**env):
            reset_launch_counts()
            got = task.train_step(batch)
            torch.cuda.synchronize()
            counts[name] = launch_counts()
            if name == "attn":
                kernel_snap = snapshot(task)
                plain = copy.deepcopy(state)
                with plain_attn_math():
                    plain_logs = plain.train_step(batch)
                grads_by_rule("bf16 GFLA_ATTN_PALLAS=1 dance kernel vs plain "
                              "path", kernel_snap, snapshot(plain),
                              train["snap32"], **ANIM_RULE)
                check(rel_diff(got, plain_logs) <= BF16_LOSS_REL,
                      f"bf16 GFLA_ATTN_PALLAS=1 dance losses {got} vs "
                      f"{plain_logs}")
                del plain, kernel_snap
            times, _ = timed_steps(task, [batch] * 2)
        rel = {n: abs(float(got[n]) - float(w))
               / max(abs(float(w)), scale.get(n, 0.0), 1e-30)
               for n, w in want.items()}
        worst = max(rel, key=rel.get)
        del task
        print(f"bf16 {env} dance step: launches {counts[name]}; losses "
              f"within {rel[worst]:.3e} rel of the default bf16 path "
              f"({worst}; bound {BF16_LOSS_REL:g}); "
              f"{statistics.median(times):.3f} ms per step (steps "
              f"{', '.join(f'{t:.1f}' for t in times)})")
        check(rel[worst] <= BF16_LOSS_REL, f"bf16 {env}: losses {got} vs "
              f"{want}")
    check(only(counts["attn"], attn_math_fwd_bf16=ANIM_LAUNCHES,
               attn_math_bwd_bf16=ANIM_LAUNCHES),
          f"bf16 GFLA_ATTN_PALLAS=1 dance launches {counts['attn']}")
    check(only(counts["corr"], warp_fwd_bf16=ANIM_LAUNCHES,
               warp_bwd_pos_bf16=ANIM_LAUNCHES,
               warp_bwd_w1_bf16=ANIM_LAUNCHES, max_corr=4),
          f"bf16 GFLA_PALLAS_CORR=1 dance launches {counts['corr']}")
    return dict(dance_train_bf16_attn=counts["attn"],
                dance_train_bf16_corr=counts["corr"])


def anim_bf16_remat(train):
    """One bf16 dance chunk step with --remat against the step without it
    from one state: each frame recomputed in the backward on the bf16
    copies of the parameters (the target net's forward runs 2 x 6 times,
    in bf16; the bf16 warp forward 48 times), the losses bitwise, the
    gradients held as the kernel and plain paths are (grads_by_rule)."""
    state, batch = train["state"], train["batch"]
    want = copy.deepcopy(state)
    want_logs = want.train_step(batch)
    task = copy.deepcopy(state)
    task.opt = copy.copy(state.opt)
    task.opt.remat = True
    dtypes = []
    target = task.net_g.target.forward
    task.net_g.target.forward = lambda *a: dtypes.append(
        a[1][0].dtype) or target(*a)
    reset_launch_counts()
    logs = task.train_step(batch)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"bf16 --remat dance step: launches {counts}; the target net ran "
          f"{len(dtypes)} times, in {sorted({str(d) for d in dtypes})}")
    check(dtypes == [torch.bfloat16] * (2 * ANIM_T),
          f"--remat: the target net ran in {dtypes}")
    check(only(counts, warp_fwd_bf16=2 * ANIM_LAUNCHES,
               warp_bwd_pos_bf16=ANIM_LAUNCHES,
               warp_bwd_w1_bf16=ANIM_LAUNCHES),
          f"bf16 --remat dance launches {counts}")
    check(all(torch.equal(logs[n], v) for n, v in want_logs.items()),
          f"bf16 --remat losses {logs} vs {want_logs}")
    grads_by_rule("bf16 --remat vs plain dance step", snapshot(task),
                  snapshot(want), train["snap32"], **ANIM_RULE)
    return counts


def anim_masks(device):
    """--use_mask: a dance tree with iPER masks (grey and RGB PNGs, the
    frames through nvJPEG); each training sample's mask_all prepared on the
    card bitwise the CPU's (its own PNG reader, PIL's grey, bicubic and
    bilinear affine as the port's code, float64 on both); one masked
    full-width dance chunk step in f32 and one in bf16 from the tree (24
    launches of each warp kernel of the type, finite losses,
    lambda_correct 2.0), from the seeded init (the bf16 task a copy of the
    f32 one, its VGG19 cast as a bf16 task casts it)."""
    from gfla_tpu_torch.data import collate, get_dataset_class
    from gfla_tpu_torch.tasks import create_task
    from gfla_tpu_torch.tasks.animation import prepare_batch as prepare

    work = tempfile.TemporaryDirectory()
    root = os.path.join(work.name, "dance")
    t0 = time.perf_counter()
    write_video_tree(root, "dance", ANIM_SIZE, ANIM_SIZE, 95, device,
                     seqs=MASK_SEQS, frames=MASK_FRAMES)
    write_s = time.perf_counter() - t0
    opt, ckpt = train_opt(
        f"--dataroot={root}", "--use_mask", "--batchSize=2",
        f"--n_frames_total={ANIM_T}", "--name=mask", model="dance",
        dataset="dance")
    f32 = create_task(opt)
    check(f32.use_mask and opt.lambda_correct == 2.0,
          "--use_mask: the dance task's mask or lambda_correct")
    bf16 = copy.deepcopy(f32)
    bf16.dtype = torch.bfloat16
    bf16.vgg.to(torch.bfloat16)
    dataset = get_dataset_class("dance")(opt)
    batch = collate([dataset[i] for i in range(2)])
    on_card = prepare(batch, device, opt)["mask_all"]
    on_cpu = prepare(batch, torch.device("cpu"), opt)["mask_all"]
    apart = (on_card.cpu() != on_cpu).sum().item()
    # the masks' cost: a loader worker's sample and the device's
    # prepare_batch with them and without
    plain = copy.copy(opt)
    plain.use_mask = False
    without = get_dataset_class("dance")(plain)
    sample_ms = [host_ms(lambda: ds[0], iters=4, warmup=1)
                 for ds in (dataset, without)]
    bare = {k: v for k, v in batch.items() if not k.startswith("mask_")}
    prepare_ms = [host_ms(lambda: prepare(b, device, opt))
                  for b in (batch, bare)]
    print(f"--use_mask: mask_all {tuple(on_card.shape)} {on_card.dtype} "
          f"prepared on the card vs the CPU: {apart} values apart "
          f"(bitwise: 0); mean {on_cpu.mean().item():.4f}, "
          f"{on_cpu.unique().numel()} levels; the tree ({MASK_SEQS} "
          f"sequences x {MASK_FRAMES} frames a phase, masks as "
          f"{', '.join(MASK_FORMATS)} PNGs) in {write_s:.2f} s; a loader "
          f"worker's {ANIM_T}-frame sample {sample_ms[0]:.1f} ms with the "
          f"masks, {sample_ms[1]:.1f} without; the device's prepare_batch "
          f"of the batch-2 chunk {prepare_ms[0]:.3f} ms with them, "
          f"{prepare_ms[1]:.3f} without")
    check(apart == 0 and 0 < on_cpu.mean().item() < 1,
          f"--use_mask: card and CPU masks {apart} apart")
    prepared = f32.prepare_batch(batch)
    counts = {}
    for dtype, task in (("float32", f32), ("bfloat16", bf16)):
        reset_launch_counts()
        logs = task.train_step(prepared)
        torch.cuda.synchronize()
        counts[dtype] = launch_counts()
        sfx = "_bf16" if dtype == "bfloat16" else ""
        check(only(counts[dtype], **{f"warp_{k}{sfx}": ANIM_LAUNCHES
                                     for k in ("fwd", "bwd_pos", "bwd_w1")}),
              f"--use_mask {dtype} step launched {counts[dtype]}")
        check(all(bool(torch.isfinite(v)) for v in logs.values()),
              f"--use_mask {dtype} step losses {logs}")
        print(f"--use_mask dance step in {dtype} from the tree: launches "
              f"{counts[dtype]}; correctness_p "
              f"{float(logs['correctness_p']):.5f} correctness_r "
              f"{float(logs['correctness_r']):.5f} total_G "
              f"{float(logs['total_G']):.5f}")
    del f32, bf16
    ckpt.cleanup()
    work.cleanup()
    return dict(dance_mask_train=counts["float32"],
                dance_mask_train_bf16=counts["bfloat16"])


def phase_anim_bf16(device, f32_train):
    """The animation heads as users train them: bf16 chunk training of
    dance and face, the switches and --remat in bf16, and
    --use_mask with the iPER masks. `f32_train`: phase 18's f32 step
    ({kind: dict(ms, peak)}). Returns the launch counts by path."""
    counts = {}
    for kind in ("dance", "face"):
        train = timed(anim_bf16_train, kind, f32_train[kind])
        counts[f"{kind}_train_bf16"] = train["counts"]
        if kind == "dance":
            dance = train
        del train
    counts.update(timed(anim_bf16_switches, dance))
    counts["dance_train_bf16_remat"] = timed(anim_bf16_remat, dance)
    del dance
    counts.update(timed(anim_masks, device))
    torch.cuda.empty_cache()
    return counts


# 10c(b), the animation heads and keypoint over row bands, where the
# machine has two or four cards (dp 1 x sp 2, or dp 2 x sp 2): one
# full-width chunk step (batch SP_ANIM_B x ANIM_T frames at 256x256, a data
# index's rows of it) of each path from phase 18's states (dance's and
# face's, off the kinks), SGD, beside one card's step on the same global
# batch; keypoint's step on a seeded batch of KP_BATCH windows
SP_ANIM = (  # (path, head, options, GFLA_PALLAS_CORR)
    ("spatial_train_dance", "dance", (), "0"),
    ("spatial_train_face", "face", (), "0"),
    ("spatial_train_dance_mask_corr", "dance", ("--use_mask",), "1"),
    ("spatial_train_dance_bf16", "dance", (ANIM_BF16,), "0"),
    ("spatial_train_face_remat", "face", ("--remat",), "0"))
SP_ANIM_PATHS = (*(path for path, _, _, _ in SP_ANIM),
                 "spatial_train_keypoint")
SP_ANIM_B = 2       # the animation steps' global batch of clips
SP_ANIM_TIMED = ("spatial_train_dance", "spatial_train_face")  # ms, peak
# the bf16 chunk step under --spatial against one card's: phase 20b's hold
# (ANIM_BF16_STEP_HOLD, BF16_L2), its norm bands widened by SP_BF16_ULP on
# each side, and a tensor outside it held to the f32 step, as the pose
# head's bf16 step under --spatial is held (SP_BF16_HOLD, its reason)
SP_ANIM_BF16_HOLD = {tag: (floor, whole, (band[0] - SP_BF16_ULP,
                                          band[1] + SP_BF16_ULP))
                     for tag, (floor, whole, band)
                     in ANIM_BF16_STEP_HOLD.items()}
SP_ANIM_BF16_RULE = dict(ANIM_RULE, hold=SP_ANIM_BF16_HOLD, to_f32=True)


def anim_person_mask(B, T, H, W, seed):
    """(B, T, 1, H, W) float32 --use_mask masks that differ between the
    batch rows: a block whose width grows with the row, soft values around
    it, and zeros (tests/torch_port_ranks.py's)."""
    rng = np.random.RandomState(seed)
    mask = np.clip(rng.rand(B, T, 1, H, W) * 1.5 - 0.25, 0, 1)
    for b in range(B):
        mask[b, :, :, H // 4:3 * H // 4, :(b + 1) * W // (B + 1)] = 1.0
        mask[b, :, :, :, (b + 2) * W // (B + 2):] *= 0.1 * b
    return torch.from_numpy(mask.astype(np.float32))


def sp_anim_task(path, kind, options, device, spatial=None):
    """The full-width task of one SP_ANIM path (phase 18's options, batch
    SP_ANIM_B), with SGD: under `--spatial=spatial` on a rank, or on one
    card; and its checkpoint directory."""
    from gfla_tpu_torch.tasks import create_task

    opt, ckpt = train_opt(f"--name={path}", f"--batchSize={SP_ANIM_B}",
                          f"--n_frames_total={ANIM_T}", *options,
                          *([f"--spatial={spatial}"] if spatial else []),
                          model=kind, dataset="synthetic_video")
    return sgd(create_task(opt, device)), ckpt


def sp_anim_batch(task, host, mask, first, rows):
    """The task's prepared batch of the host clips' `rows` rows from
    `first` (each rank's band of them under --spatial), with `mask`'s same
    rows (their band) as mask_all where given."""
    from gfla_tpu_torch import parallel

    take = {k: v[first:first + rows] for k, v in host.items()}
    batch = task.prepare_batch(take)
    if mask is not None:
        m = mask[first:first + rows].to(task.device)
        b = parallel.bands()
        if b is not None:
            h = m.shape[-2] // b.size
            m = m[..., b.first_row(h):b.first_row(h) + h, :]
        batch["mask_all"] = m
    return batch


def sp_kp_task(device):
    """The keypoint head at its one width from its seeded init, SGD, and a
    seeded batch of KP_BATCH windows of 86 frames on `device`."""
    from gfla_tpu_torch.tasks.keypoint import KeypointTask

    opt = types.SimpleNamespace(
        model="keypoint", isTrain=True, batchSize=KP_BATCH, structure_nc=17,
        lr=1e-4, lr_policy="lambda", niter=100, niter_decay=0, iter_count=1,
        iters_per_epoch=1000, seed=0, gpu_ids="0")
    rng = np.random.RandomState(560)
    batch = {"input_data": rng.randn(KP_BATCH, 86, 34) * 0.5,
             "gt_data": rng.randn(KP_BATCH, 6, 34) * 0.5}
    return sgd(KeypointTask(opt, device)), {
        k: torch.from_numpy(v.astype(np.float32)).to(device)
        for k, v in batch.items()}


def sp_anim_result(task, logs, counts, collectives=None):
    from gfla_tpu_torch import parallel

    return dict(counts=counts, collectives=collectives,
                logs={k: float(v)
                      for k, v in parallel.allreduce_mean(logs).items()},
                grads=dp_grads(task),
                replica={k: v.cpu() for k, v in replica_state(task).items()})


def spatial_anim_rank(device, states, out_dir, sp, rows):
    """(b)'s rank for the animation heads and keypoint: each SP_ANIM path's
    chunk step from its head's state on this rank's band of its data
    index's `rows` clips, its launches and the spatial group's collectives
    counted; SP_TIMED more of dance's and face's f32 steps, timed, with the
    peak memory; then keypoint's step (its batch replicated over the
    group: the data index's rows of it, whole) under deterministic()."""
    from gfla_tpu_torch import parallel
    from gfla_tpu_torch.runtime import set_tf32

    start = time.perf_counter()
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // parallel.world().size))
    set_tf32(False)
    b = parallel.init_bands(sp, SP_HALO)
    data = parallel.data_world()
    host = torch.load(states["host"], weights_only=False)
    out = {"band": b.index, "data": data.rank, "seconds": {}}
    for path, kind, options, corr in SP_ANIM:
        task, ckpt = sp_anim_task(path, kind, options, device, sp)
        for tag, sd in torch.load(states[kind], weights_only=True).items():
            nets(task)[tag].load_state_dict(sd)
        batch = sp_anim_batch(task, host[kind], host["mask"]
                              if "--use_mask" in options else None,
                              data.rank * rows, rows)
        reset_launch_counts()
        before = parallel.band_collectives
        with switches(GFLA_PALLAS_CORR=corr):
            logs = task.train_step(batch)
        torch.cuda.synchronize()
        out[path] = sp_anim_result(task, logs, launch_counts(),
                                   parallel.band_collectives - before)
        if path in SP_ANIM_TIMED:
            torch.cuda.reset_peak_memory_stats()
            out[path]["times"], _ = timed_steps(task, [batch] * SP_TIMED)
            out[path]["peak"] = torch.cuda.max_memory_allocated() / 2**30
        del task, batch
        ckpt.cleanup()
        out["seconds"][path] = time.perf_counter() - start
    task, batch = sp_kp_task(device)
    batch = {k: v[data.rank * (KP_BATCH // data.size):]
             [:KP_BATCH // data.size] for k, v in batch.items()}
    with deterministic():
        reset_launch_counts()
        logs = task.train_step(batch)
        torch.cuda.synchronize()
        out["spatial_train_keypoint"] = sp_anim_result(task, logs,
                                                       launch_counts())
    out["seconds"]["spatial_train_keypoint"] = time.perf_counter() - start
    torch.save(out, os.path.join(out_dir, f"rank{parallel.world().rank}.pt"))


def spatial_anim_refs(states, host, mask, dp):
    """(b)'s references on one card, each from the same state on the
    global batch: the f32 SP_ANIM paths' SGD chunk steps (dance's and
    face's timed as the ranks' are, with the peak memory), the bf16 one,
    and keypoint's data-parallel step over `dp` data indices under
    deterministic(): each index's step on its rows, its dropouts drawn as
    that index's (`tasks.keypoint.dropout_seed`), the gradients averaged.
    --remat is held to the ranks' own face step. Each: dict(logs,
    grads[, times, peak, replica])."""

    device = states["dance"].device
    refs = {}
    for path, kind, options, corr in SP_ANIM:
        if "--remat" in options:
            continue
        task, ckpt = sp_anim_task(f"one_{path}", kind, options, device)
        for tag, net in nets(states[kind]).items():
            nets(task)[tag].load_state_dict(net.state_dict())
        batch = sp_anim_batch(task, host[kind], mask if "--use_mask"
                              in options else None, 0, SP_ANIM_B)
        with switches(GFLA_PALLAS_CORR=corr):
            logs = task.train_step(batch)
        refs[path] = dict(logs={k: float(v) for k, v in logs.items()},
                          grads=dp_grads(task))
        if path in SP_ANIM_TIMED:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            refs[path]["times"], _ = timed_steps(task, [batch] * SP_TIMED)
            refs[path]["peak"] = torch.cuda.max_memory_allocated() / 2**30
        del task, batch
        ckpt.cleanup()
    steps, rows = [], KP_BATCH // dp
    for i in range(dp):
        task, batch = sp_kp_task(device)
        task.data_index = i  # its dropouts draw as data index i's
        with deterministic():
            logs = task.train_step({k: v[i * rows:(i + 1) * rows]
                                    for k, v in batch.items()})
        steps.append(dict(
            logs={k: float(v) for k, v in logs.items()},
            grads=dp_grads(task),
            replica={k: v.cpu() for k, v in replica_state(task).items()}))
        del task
    refs["spatial_train_keypoint"] = steps[0] if dp == 1 else dict(
        grads={"G": {n: sum(s["grads"]["G"][n] for s in steps) / dp
                     for n in steps[0]["grads"]["G"]}})
    torch.cuda.empty_cache()
    return refs


def phase_spatial_anim(anim):
    """10c(b) for the animation heads and keypoint (the data x spatial
    mode's last heads), where the machine has two cards (four: dp 2 x sp
    2, else dp 1 x sp 2): spawned ranks take, from `anim`'s states (phase
    18's full-width dance and face tasks, off the kinks), one SGD chunk
    step on their band of each data index's rows of a global batch of
    SP_ANIM_B clips x ANIM_T frames at 256x256: dance and face in f32, and
    dance with --use_mask (seeded masks) under GFLA_PALLAS_CORR=1, each
    held to one card's step on the same global batch by gfla_tpu's spatial
    rule (SP_TOTAL_REL, SP_SHARE_1, SP_SHARE_2); dance in bf16, held to
    one card's bf16 step by phase 20b's hold (SP_ANIM_BF16_RULE, one
    card's f32 step the reference of what bf16 resolves), both of phase
    20b's planted faults failing it; face with --remat, held to the ranks'
    own face step by phase 18's kernel-vs-plain rule (losses within
    TRAIN_LOSS_REL, each network's gradient within ANIM_GRAD_REL in
    relative L2), u bitwise equal, as many collectives on every rank, more
    than without; and keypoint's step, its batch replicated over the
    group, bitwise one card's step on dp 1 (under deterministic()), by the
    8-vs-1 rule on dp 2. Every rank's gradients, parameters and u bitwise
    equal after each; the launches of each path counted, and the f32
    steps' ms and peak memory a card beside one card's. On one card a line
    says the ranks did not run and no count is returned."""
    from gfla_tpu_torch import parallel
    from gfla_tpu_torch.runtime import card_line

    n = next((r for r in SP_RANKS if torch.cuda.device_count() >= r), 0)
    if not n:
        print(f"spatial_train_dance, _face, _dance_mask_corr, _dance_bf16, "
              f"_face_remat, _keypoint: the ranks did not run "
              f"({torch.cuda.device_count()} card)")
        return {path: None for path in SP_ANIM_PATHS}
    start = time.perf_counter()
    sp, dp = 2, n // 2
    rows = SP_ANIM_B // dp
    states = {kind: anim[kind]["state"] for kind in ("dance", "face")}
    host = {kind: anim_clips(states[kind].opt, SP_ANIM_B)[0]
            for kind in ("dance", "face")}
    mask = anim_person_mask(SP_ANIM_B, ANIM_T, ANIM_SIZE, ANIM_SIZE, 570)
    refs = spatial_anim_refs(states, host, mask, dp)
    tmp = tempfile.TemporaryDirectory()
    files = {"host": os.path.join(tmp.name, "host.pt")}
    torch.save({**host, "mask": mask}, files["host"])
    for kind, state in states.items():
        files[kind] = os.path.join(tmp.name, f"{kind}.pt")
        torch.save({tag: net.state_dict() for tag, net in nets(state).items()},
                   files[kind])
    ref_s = time.perf_counter() - start
    spawned = time.perf_counter()
    parallel.spawn(spatial_anim_rank,
                   [torch.device("cuda", i) for i in range(n)], files,
                   tmp.name, sp, rows, timeout=SP_TIMEOUT)
    spawned = time.perf_counter() - spawned
    ranks = [torch.load(os.path.join(tmp.name, f"rank{r}.pt"),
                        weights_only=False) for r in range(n)]
    tmp.cleanup()
    check([(r["data"], r["band"]) for r in ranks]
          == [(i // sp, i % sp) for i in range(n)], "the rank layout")
    what = f"spatial dp {dp} x sp {sp}"
    expected = {
        "spatial_train_dance": dict(warp_fwd=ANIM_LAUNCHES,
                                    warp_bwd_pos=ANIM_LAUNCHES,
                                    warp_bwd_w1=ANIM_LAUNCHES),
        "spatial_train_dance_mask_corr": dict(
            warp_fwd=ANIM_LAUNCHES, warp_bwd_pos=ANIM_LAUNCHES,
            warp_bwd_w1=ANIM_LAUNCHES, max_corr=4),
        "spatial_train_dance_bf16": dict(
            warp_fwd_bf16=ANIM_LAUNCHES, warp_bwd_pos_bf16=ANIM_LAUNCHES,
            warp_bwd_w1_bf16=ANIM_LAUNCHES),
        "spatial_train_face_remat": dict(warp_fwd=2 * ANIM_LAUNCHES,
                                         warp_bwd_pos=ANIM_LAUNCHES,
                                         warp_bwd_w1=ANIM_LAUNCHES),
        "spatial_train_keypoint": {}}
    expected["spatial_train_face"] = expected["spatial_train_dance"]
    for path in SP_ANIM_PATHS:
        got = [r[path] for r in ranks]
        for r, res in enumerate(got):
            check(only(res["counts"], **expected[path]),
                  f"{what} {path}: rank {r} launches {res['counts']}")
        for res in got[1:]:
            check(res["logs"] == got[0]["logs"]
                  and all(torch.equal(res["replica"][k], v)
                          for k, v in got[0]["replica"].items())
                  and all(torch.equal(res["grads"][tag][k], g)
                          for tag, d in got[0]["grads"].items()
                          for k, g in d.items()),
                  f"{what} {path}: the ranks' logs, gradients, parameters "
                  f"or u differ")
    print(f"{what} on {card_line()!r}, animation heads at {ANIM_SIZE}x"
          f"{ANIM_SIZE}, global batch {SP_ANIM_B} x {ANIM_T} frames ({rows} "
          f"clip(s) of {ANIM_SIZE // sp} rows a rank) and keypoint at batch "
          f"{KP_BATCH}; every rank's gradients, parameters and u bitwise "
          f"equal after each step; the launches a rank "
          + "; ".join(f"{path} "
                      f"{ {k: v for k, v in ranks[0][path]['counts'].items() if v} }"
                      for path in SP_ANIM_PATHS))
    for path in SP_ANIM_TIMED:
        print(f"  {path}: step ms per rank "
              + ", ".join(f"{statistics.median(r[path]['times'][1:]):.3f}"
                          for r in ranks)
              + f" against {statistics.median(refs[path]['times'][1:]):.3f}"
              f" on one card at batch {SP_ANIM_B}; peak GiB per card "
              + ", ".join(f"{r[path]['peak']:.2f}" for r in ranks)
              + f" against {refs[path]['peak']:.2f}")
    print(f"{what} animation and keypoint, wall: one card's references "
          f"{ref_s:.1f} s, the ranks {spawned:.1f} s (rank 0's own, from "
          f"its start: "
          + ", ".join(f"{p} done at {t:.1f} s"
                      for p, t in ranks[0]["seconds"].items()) + ")")
    for path in ("spatial_train_dance", "spatial_train_face",
                 "spatial_train_dance_mask_corr"):
        got, ref = ranks[0][path], refs[path]
        total_rel = abs(got["logs"]["total_G"] - ref["logs"]["total_G"]) \
            / abs(ref["logs"]["total_G"])
        check(total_rel <= SP_TOTAL_REL, f"{what} {path}: total_G "
              f"{total_rel:.3e} rel apart")
        shares = {tag: sp_rule(f"{what} {path} vs one card, {tag}",
                               ref["grads"][tag], got["grads"][tag])
                  for tag in ref["grads"]}
        print(f"  {path} against one card's: " + "; ".join(
            f"{tag} {s1:.2e} of entries above 1e-3 of max, {s2:.2e} above "
            f"1e-2" for tag, (s1, s2) in shares.items())
            + f"; total_G {total_rel:.3e} rel")
    path = "spatial_train_dance_bf16"
    got, ref = ranks[0][path], refs[path]
    total_rel = abs(got["logs"]["total_G"] - ref["logs"]["total_G"]) \
        / abs(ref["logs"]["total_G"])
    check(total_rel <= BF16_LOSS_REL, f"{what} {path}: total_G "
          f"{total_rel:.3e} rel apart")

    def snaps(res):
        return {t: {"grads": g} for t, g in res["grads"].items()}

    f32 = snaps(refs["spatial_train_dance"])
    grads_by_rule(f"{what} bf16 dance chunk step vs one card", snaps(got),
                  snaps(ref), f32, **SP_ANIM_BF16_RULE)
    planted_faults(f"{what} bf16 dance chunk step vs one card", snaps(got),
                   snaps(ref), f32, SP_ANIM_BF16_RULE)
    print(f"  {path} against one card's: phase 20b's hold (norm bands "
          f"widened by {SP_BF16_ULP:g}), both planted faults failing it; "
          f"total_G {total_rel:.3e} rel")
    counts = [r["spatial_train_face_remat"]["collectives"] for r in ranks]
    plain = [r["spatial_train_face"]["collectives"] for r in ranks]
    check(all(c == counts[0] for c in counts)
          and all(c == plain[0] for c in plain) and counts[0] > plain[0],
          f"{what} face --remat: the ranks' collectives {counts}, without "
          f"--remat {plain}")
    for r, res in enumerate(ranks):
        remat, face = res["spatial_train_face_remat"], \
            res["spatial_train_face"]
        loss_rel = rel_diff(remat["logs"], face["logs"])
        grad_rel = {}
        for tag, want in face["grads"].items():
            a, b = (torch.cat([g[k].flatten() for k in sorted(want)])
                    for g in (remat["grads"][tag], want))
            grad_rel[tag] = ((a - b).norm() / b.norm()).item()
        check(loss_rel <= TRAIN_LOSS_REL
              and max(grad_rel.values()) <= ANIM_GRAD_REL,
              f"{what} face --remat vs without on rank {r}: losses "
              f"{loss_rel:.3e} rel, gradients {grad_rel}")
        us = [k for k in face["replica"] if k.endswith("weight_u")]
        check(len(us) == 2 * (3 * 4 + 1)
              and all(torch.equal(remat["replica"][k], face["replica"][k])
                      for k in us), f"{what} face --remat: rank {r}'s u")
        print(f"  spatial_train_face_remat on rank {r} against its face "
              f"step: losses within {loss_rel:.3e} rel, gradients "
              + ", ".join(f"{t} {v:.3e}" for t, v in grad_rel.items())
              + " in relative L2, u bitwise equal")
    print(f"  spatial_train_face_remat: collectives a chunk step on each "
          f"rank {counts[0]} against {plain[0]} without")
    path = "spatial_train_keypoint"
    got, ref = ranks[0][path], refs[path]
    if dp == 1:
        check(got["logs"] == ref["logs"]
              and all(torch.equal(got["grads"]["G"][k], g)
                      for k, g in ref["grads"]["G"].items())
              and all(torch.equal(got["replica"][k], v)
                      for k, v in ref["replica"].items()),
              f"{what} keypoint: not bitwise one card's step")
        rule = "bitwise one card's step"
    else:
        share, worst = dp_rule(f"{what} keypoint vs one card",
                               ref["grads"]["G"], got["grads"]["G"])
        rule = (f"one card's data-parallel step over {dp} data indices "
                f"(each its rows and its dropouts' generator, the gradients "
                f"averaged) by the 8-vs-1 rule: {share:.4%} of entries "
                f"above {DP_DIVERGE:g} of max, max {worst:.3e}")
    print(f"  {path}: the batch replicated over the group, {rule}")
    return {path: ranks[0][path]["counts"] for path in SP_ANIM_PATHS}


def anim_spatial_states():
    """phase_spatial_anim's states where phase 18 has not run (the
    scripts' own phases): each head's full-width task, off the kinks."""
    from gfla_tpu_torch.tasks import create_task

    states = {}
    for kind in ("dance", "face"):
        opt, ckpt = train_opt(f"--name={kind}_state", "--batchSize=2",
                              f"--n_frames_total={ANIM_T}", model=kind,
                              dataset="synthetic_video")
        task = create_task(opt)
        states[kind] = {"state": off_the_kinks(task)}
        del task
        ckpt.cleanup()
    return states


KP_STEPS = 4           # keypoint steps through the training CLI
KP_BATCH = 8           # windows a batch: 6 gt frames, 86 input frames
KP_SEQS, KP_FRAMES = 2, 40  # the AlphaPose test tree: sequences, frames
KP_GRAD_REL = 1e-4     # card vs CPU step: each gradient, relative L2
KP_FWD_REL = 1e-4      # card vs CPU eval forward: x max |out|


def kp_dropout_masks(B, T, rng, C=256, p=0.15, k=3, layers=4):
    """0/1 float32 masks (B, C, t) of the keypoint net's 7 dropouts in the
    order its forward calls them, at input length T: the expand layer's,
    then each dilated layer's two (keep probability 1 - p)."""
    lengths = [T - (k - 1)]
    dilation = k
    for _ in range(layers - 1):
        lengths += [lengths[-1] - (k - 1) * dilation] * 2
        dilation *= k
    return [(rng.rand(B, C, t) >= p).astype(np.float32) for t in lengths]


class MaskedDropout(torch.nn.Module):
    """x * mask / keep: a dropout whose mask is given."""

    def __init__(self, mask, keep):
        super().__init__()
        self.mask, self.keep = mask, keep

    def forward(self, x):
        return x * self.mask / self.keep


@contextlib.contextmanager
def fixed_dropout(net, masks):
    """The net's dropouts, in call order, replaced by MaskedDropouts of the
    given numpy masks (moved to the net's device) until the block ends: two
    devices, or torch and flax, then drop the same entries. The net's
    modules are listed in the order its forward calls its dropouts."""
    device = next(net.parameters()).device
    drops = [(name, module) for name, module in net.named_modules()
             if isinstance(module, torch.nn.Dropout)]
    check(len(drops) == len(masks), f"{len(drops)} dropouts, {len(masks)} "
                                    f"masks")
    for (name, module), mask in zip(drops, masks):
        parent, attr = name.rsplit(".", 1)
        setattr(net.get_submodule(parent), attr, MaskedDropout(
            torch.from_numpy(mask).to(device), 1.0 - module.p))
    try:
        yield
    finally:
        for name, module in drops:
            parent, attr = name.rsplit(".", 1)
            setattr(net.get_submodule(parent), attr, module)


def write_keypoint_trees(root, seed, device, seqs=KP_SEQS, frames=KP_FRAMES,
                         size=ANIM_SIZE, npz_frames=300):
    """The keypoint head's data under `root`: a synthetic Human3.6M NPZ
    pair (scripts/make_synth_h36m_keypoints.py, 5 training and 1 held-out
    subject x 2 actions x 2 cameras), a dance tree (write_video_tree,
    size x size frames, `seqs` sequences of `frames` a phase), and an
    AlphaPose tree, `{root}/alphapose/test_alphapose/<seq>/`, the dance
    tree's test OpenPose-18 JSONs renamed `<seq>_<frame>.json` (so that
    the server's flat output keeps every frame) with one frame of each
    sequence emptied of its person. Returns {gt_path, input_path,
    kp_root, dance_root}."""
    import shutil
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    npz = os.path.join(root, "h36m")
    subprocess.run([sys.executable, os.path.join(
        here, "scripts", "make_synth_h36m_keypoints.py"), "--out", npz,
        "--frames", str(npz_frames), "--seed", str(seed)], check=True,
        capture_output=True, timeout=300)
    dance = os.path.join(root, "dance")
    write_video_tree(dance, "dance", size, size, seed, device, seqs=seqs,
                     frames=frames)
    kp_root = os.path.join(root, "alphapose")
    src = os.path.join(dance, "test_256", "train_alphapose")
    for s, seq in enumerate(sorted(os.listdir(src))):
        out = os.path.join(kp_root, "test_alphapose", seq)
        os.makedirs(out)
        for t, name in enumerate(sorted(os.listdir(os.path.join(src, seq)))):
            dst = os.path.join(out, f"{seq}_{name}")
            shutil.copyfile(os.path.join(src, seq, name), dst)
            if t == 3 + s:
                with open(dst, "w") as f:
                    json.dump({"people": []}, f)
    return {"gt_path": os.path.join(npz, "data_2d_h36m_gt.npz"),
            "input_path": os.path.join(npz, "data_2d_h36m_synth_noisy.npz"),
            "kp_root": kp_root, "dance_root": dance}


def png_size(path):
    """(width, height) from a PNG's IHDR."""
    import struct

    with open(path, "rb") as f:
        head = f.read(24)
    check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR",
          f"{path}: not a PNG")
    return struct.unpack(">II", head[16:24])


def kp_step_pair(task, batch, masks):
    """One train_step of `task` under the given dropout masks: (logs,
    {name: grad}, {name: param after})."""
    with fixed_dropout(task.net_g, masks):
        logs = task.train_step(batch)
    named = dict(task.net_g.named_parameters())
    return ({k: float(v) for k, v in logs.items()},
            {n: p.grad.detach().cpu() for n, p in named.items()},
            {n: p.detach().cpu() for n, p in named.items()})


def phase_keypoint(device):
    """keypoint: the Motion Extraction Net at its one width (17 joints, 256
    channels, 4 layers, receptive field 81) from a synthetic Human3.6M NPZ
    pair: four batch-8 steps through the training CLI's entry point with
    the held-out kp_mse evaluated, save/resume, one step on the card
    against the CPU from one state under the same dropout masks, the eval
    forward on the card against the CPU; the serving CLI over an AlphaPose
    tree (a JSON a frame, --write_image's PNGs); the denoised JSONs read
    by DanceDataset as a dance test tree's clean skeletons, and the dance
    generator serving one 6-frame chunk of them. The hand kernels are
    launched on none of the keypoint head's own path."""
    from gfla_tpu_torch.data import collate, get_dataset_class
    from gfla_tpu_torch.options import TestOptions, TrainOptions
    from gfla_tpu_torch.runtime import card_line
    from gfla_tpu_torch.tasks import create_task
    from gfla_tpu_torch.tasks.keypoint import KeypointTask

    work = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    trees = write_keypoint_trees(work.name, 21, device)
    print(f"keypoint: wrote the NPZ pair, a dance tree and an AlphaPose tree "
          f"({KP_SEQS} sequences x {KP_FRAMES} frames) in "
          f"{time.perf_counter() - t0:.2f} s")
    ckpt = os.path.join(work.name, "ckpt")
    common = ["--model=keypoint", "--gpu_ids=0", f"--checkpoints_dir={ckpt}",
              "--name=kp", "--nThreads=0"]
    train_args = [*common, "--dataset_mode=keypoint",
                  f"--gt_path={trees['gt_path']}",
                  f"--input_path={trees['input_path']}",
                  f"--batchSize={KP_BATCH}", f"--max_iters={KP_STEPS}",
                  "--eval_iters_freq=2", "--print_freq=1"]
    counts = {}

    # four steps through the training CLI
    initial = []
    lines, counts["keypoint_train"], task, prepared, step_ms = \
        train_from_disk("keypoint train", train_args, KP_STEPS,
                        task_cls=KeypointTask,
                        paths=lambda b: b["input_data"].shape,
                        initial=initial)
    for line in lines:
        if line.startswith(("held out", "dataset [", "(epoch:")):
            print(f"  {line}")
    check(only(counts["keypoint_train"]),
          f"keypoint training launched {counts['keypoint_train']}")
    g = task.net_g.kp_input
    check(g.expand_conv.out_channels == 256 and len(g.layers_conv) == 6
          and g.shrink.out_channels == 34,
          "keypoint: not the full-width configuration")
    check(all(s == (KP_BATCH, 86, 34) for s in prepared),
          f"keypoint prepared {prepared}")
    still = [n for n, p in task.net_g.named_parameters()
             if torch.equal(p, initial[0]["G"]["params"][n])]
    check(not still, f"keypoint: parameters unchanged: {still}")
    losses = [line for line in lines if line.startswith("(epoch:")
              and "mpjpe:" in line]
    check(len(losses) == KP_STEPS and "nan" not in " ".join(losses),
          f"keypoint: loss lines {losses}")
    evals = eval_lines(lines, "kp_mse")
    check(sorted(evals) == [2, 4] and all(
        np.isfinite([e["kp_mse"], e["kp_mse_identity"]]).all()
        for e in evals.values()), f"keypoint: eval lines {evals}")
    with open(os.path.join(ckpt, "kp", "eval_log.txt")) as f:
        check(f.read().count("kp_mse_identity:") == 2,
              "keypoint: eval_log.txt")

    # save/resume: the trainer's task and one resumed from its last save
    # take the same step (the same step draws the same dropout)
    opt = TrainOptions().parse(train_args, save=False)
    dataset = get_dataset_class("keypoint")(opt)
    batch = task.prepare_batch(collate([dataset[i] for i in range(KP_BATCH)]))
    resumed = KeypointTask(opt, device)
    check(resumed.resume() == KP_STEPS, "keypoint: resume step")
    logs = []
    for t in (task, resumed):
        logs.append(float(t.train_step(batch)["mpjpe"]))
    diff = max((a - b).abs().max().item() / max(a.abs().max().item(), 1e-30)
               for a, b in zip(task.net_g.parameters(),
                               resumed.net_g.parameters()))
    rel = abs(logs[0] - logs[1]) / abs(logs[0])
    print(f"keypoint save/resume: the next step's loss {rel:.2e} apart, "
          f"parameters {diff:.2e} x max apart (bound {CKPT_REL:g})")
    check(rel <= CKPT_REL and diff <= CKPT_REL, "keypoint save/resume")
    del resumed

    # one step on the card against the CPU from one state, the same masks
    cpu = KeypointTask(opt, torch.device("cpu"))
    cpu.net_g.load_state_dict(task.net_g.state_dict())
    cpu.opt_g.load_state_dict(task.opt_g.state_dict())
    cpu.sched_g.load_state_dict(task.sched_g.state_dict())
    masks = kp_dropout_masks(KP_BATCH, 86, np.random.RandomState(3))
    card_logs, card_grads, _ = kp_step_pair(task, batch, masks)
    cpu_logs, cpu_grads, _ = kp_step_pair(
        cpu, {k: v.cpu() for k, v in batch.items()}, masks)
    rel = abs(card_logs["mpjpe"] - cpu_logs["mpjpe"]) / cpu_logs["mpjpe"]
    grad_rel = {n: ((card_grads[n] - g).norm() / g.norm()).item()
                for n, g in cpu_grads.items()}
    worst = max(grad_rel, key=grad_rel.get)
    print(f"keypoint step card vs CPU under the same dropout masks: loss "
          f"{rel:.2e} apart (bound {TRAIN_LOSS_REL:g}); gradients at most "
          f"{grad_rel[worst]:.2e} apart in relative L2 ({worst}; bound "
          f"{KP_GRAD_REL:g})")
    check(rel <= TRAIN_LOSS_REL and grad_rel[worst] <= KP_GRAD_REL,
          "keypoint card vs CPU step")

    # the eval forward on the card against the CPU, a whole test sequence
    test_opt = TestOptions().parse(
        [*common, "--dataset_mode=keypointtest",
         f"--dataroot={trees['kp_root']}", "--load_size=256"], save=False)
    test_set = get_dataset_class("keypointtest")(test_opt)
    seq = task.prepare_batch(collate([test_set[0]]))
    out = task.test_step(seq).cpu()
    cpu.net_g.load_state_dict(task.net_g.state_dict())
    out_cpu = cpu.test_step({k: v.cpu() for k, v in seq.items()})
    diff = (out - out_cpu).abs().max().item()
    bound = KP_FWD_REL * out_cpu.abs().max().item()
    print(f"keypoint eval forward card vs CPU, 1 sequence of {KP_FRAMES} "
          f"frames: max_abs_diff={diff:.3e} (bound {bound:.3e})")
    check(tuple(out.shape) == (1, KP_FRAMES, 34) and diff <= bound,
          f"keypoint eval forward {tuple(out.shape)} {diff:.3e}")
    del cpu

    # the serving CLI over the AlphaPose tree
    results = os.path.join(work.name, "results")
    serve_args = [*common, "--dataset_mode=keypointtest",
                  f"--dataroot={trees['kp_root']}", "--load_size=256",
                  f"--results_dir={results}", "--write_image",
                  f"--which_iter={KP_STEPS}"]
    lines, counts["keypoint_serve"] = serve_from_disk("keypoint serve",
                                                      serve_args)
    check(only(counts["keypoint_serve"]),
          f"keypoint serving launched {counts['keypoint_serve']}")
    out_dir = os.path.join(results, "kp")
    inputs = sorted(os.path.splitext(f)[0] for _, _, files in os.walk(
        os.path.join(trees["kp_root"], "test_alphapose")) for f in files)
    names = sorted(os.listdir(out_dir))
    want = sorted([f"{s}_keypoints.json" for s in inputs]
                  + [f"{s}_skeleton_out.png" for s in inputs])
    check(names == want and f"wrote {len(inputs)} keypoint JSONs to "
          f"{out_dir}" in lines, f"keypoint serving wrote {names[:4]}...")
    for s in inputs:
        with open(os.path.join(out_dir, f"{s}_keypoints.json")) as f:
            people = json.load(f)["people"]
        kp = np.asarray(people[0]["pose_keypoints_2d"])
        check(len(people) == 1 and kp.shape == (51,)
              and np.isfinite(kp).all() and (kp[2::3] == 1).all(),
              f"keypoint JSON {s}: {kp.shape}")
        check(png_size(os.path.join(out_dir, f"{s}_skeleton_out.png"))
              == (256, 256), f"keypoint PNG {s}")
    print(f"keypoint served {len(test_set)} sequences: {len(inputs)} JSONs "
          f"of 17 joints and {len(inputs)} skeleton PNGs under gfla_tpu's "
          f"names, launches {counts['keypoint_serve']}")

    # the chain: the denoised JSONs as the dance test tree's clean
    # skeletons, one chunk of them served by the dance generator
    import shutil

    clean = os.path.join(trees["dance_root"], "test_256", "train_video2d")
    seq0 = sorted(os.listdir(clean))[0]
    shutil.rmtree(os.path.join(clean, seq0))
    os.makedirs(os.path.join(clean, seq0))
    denoised = [s for s in inputs if s.startswith(seq0 + "_")]
    for s in denoised:
        shutil.copyfile(os.path.join(out_dir, f"{s}_keypoints.json"),
                        os.path.join(clean, seq0, f"{s}_keypoints.json"))
    dance_opt = TestOptions().parse(
        ["--model=dance", "--dataset_mode=dance", "--gpu_ids=0",
         f"--dataroot={trees['dance_root']}", f"--load_size={ANIM_SIZE}",
         f"--n_frames_pre_load_test={ANIM_T}", "--nThreads=0"], save=False)
    dance_set = get_dataset_class("dance")(dance_opt)
    sample = dance_set[0]
    want_kp = []
    for s in denoised[:ANIM_T]:
        with open(os.path.join(out_dir, f"{s}_keypoints.json")) as f:
            xy = np.asarray(json.load(f)["people"][0]["pose_keypoints_2d"]
                            ).reshape(17, 3)[:, :2]
        want_kp.append((2 * xy[:, ::-1].T.reshape(34) / ANIM_SIZE - 1))
    got_kp = sample["gen_kps_clean"].T
    kp_diff = np.abs(got_kp - np.stack(want_kp)).max()
    check(os.path.dirname(sample["gen_paths"][0]).endswith(seq0)
          and kp_diff <= 1e-5,
          f"dance read the denoised skeletons {kp_diff:.2e} apart")
    dance = create_task(dance_opt)
    chunk = dance.prepare_batch(collate([sample]))
    reset_launch_counts()
    frames, _ = dance.test_step(chunk)
    torch.cuda.synchronize()
    counts["keypoint_chain_dance"] = launch_counts()
    check_clip("dance on the denoised skeletons", frames, 1, ANIM_T,
               ANIM_SIZE)
    check(only(counts["keypoint_chain_dance"], warp_fwd=ANIM_LAUNCHES),
          f"dance chunk launched {counts['keypoint_chain_dance']}")
    print(f"chain: DanceDataset read {len(denoised)} denoised H36M-17 JSONs "
          f"as {seq0}'s clean skeletons ({kp_diff:.1e} off the JSONs), and "
          f"the full-width dance generator served one {ANIM_T}-frame chunk: "
          f"finite frames in [-1, 1], launches "
          f"{counts['keypoint_chain_dance']}")
    del dance

    # times
    torch.cuda.reset_peak_memory_stats()
    step = cuda_ms(lambda: task.train_step(batch), iters=20, warmup=3)
    peak = torch.cuda.max_memory_allocated() / 2**20
    fwd = cuda_ms(lambda: task.test_step(seq), iters=20, warmup=3)
    t0 = time.perf_counter()
    for i in range(64):
        dataset[i % len(dataset)]
    sample_ms = (time.perf_counter() - t0) * 1e3 / 64
    print(f"keypoint (f32, TF32 off) on {card_line()}: {step:.3f} ms per "
          f"batch-8 training step (86 input frames), {fwd:.3f} ms per "
          f"eval forward of a {KP_FRAMES}-frame sequence ({KP_FRAMES + 80} "
          f"input frames), host {sample_ms:.3f} ms per training "
          f"__getitem__, peak {peak:.0f} MiB over the steps; the CLI's "
          f"steps {', '.join(f'{t:.1f}' for t in step_ms)} ms")
    del task
    work.cleanup()
    return counts


METRIC_PAIRS = 64    # DeepFashion-size generated/GT JPEG pairs
METRIC_SIZE = (256, 176)
METRIC_ANIM = 12     # the animation heads' 256x256 _vis/_gt PNG pairs
FEATURE_REL = 1e-3   # Inception pool3, card vs CPU: x max |feature|
LPIPS_REL = 1e-4     # LPIPS, plain and masked, card vs CPU, each pair
FID_REL = 1e-3       # FID from the card's features vs the CPU's
PIL_GAP_REL = 5e-2   # the card's CSV vs the same columns from PIL's decode
METRIC_NEVER = ("jax", "flax", "pandas", "imageio")  # not on the card
METRIC_BLOCKED = METRIC_NEVER + ("PIL",)  # ... and no JPEG or PNG through it


def metric_pairs(n, H, W, seed):
    """`n` (real, generated) uint8 pictures: disk_images' and a shifted
    distribution of each (contrast 0.55, +40, noise of 15 levels), so that
    FID is far from zero and stable."""
    rng = np.random.RandomState(seed + 1)
    real = disk_images(n, H, W, seed)
    gen = [np.clip(a * 0.55 + 40.0 + rng.randn(H, W, 3) * 15, 0,
                   255).astype(np.uint8) for a in real]
    return real, gen


def write_metric_trees(root, device):
    """gt/p{i}.jpg and gen/s{i}_2_p{i}_vis.jpg (METRIC_PAIRS at
    METRIC_SIZE, through nvJPEG), and anim/gt/{i}_gt.png,
    anim/vis/{i}_vis.png (METRIC_ANIM at ANIM_SIZE, the port's PNG
    writer); body masks of seeded skeletons at METRIC_SIZE."""
    from gfla_tpu_torch.data.image_io import write_jpeg, write_png
    from gfla_tpu_torch.data.pose_utils import produce_ma_mask

    H, W = METRIC_SIZE
    real, gen = metric_pairs(METRIC_PAIRS, H, W, 22)
    for i, (a, b) in enumerate(zip(real, gen)):
        write_jpeg(os.path.join(root, "gt", f"p{i:02d}.jpg"),
                   torch.from_numpy(a).to(device))
        write_jpeg(os.path.join(root, "gen", f"s{i:02d}_2_p{i:02d}_vis.jpg"),
                   torch.from_numpy(b).to(device))
    real, gen = metric_pairs(METRIC_ANIM, ANIM_SIZE, ANIM_SIZE, 23)
    for i, (a, b) in enumerate(zip(real, gen)):
        write_png(os.path.join(root, "anim", "gt", f"{i:03d}_gt.png"), a)
        write_png(os.path.join(root, "anim", "vis", f"{i:03d}_vis.png"), b)
    rng = np.random.RandomState(22)
    masks = []
    for _ in range(METRIC_PAIRS):
        kp = np.stack([rng.uniform(8, H - 8, 18), rng.uniform(8, W - 8, 18)],
                      1)
        kp[rng.rand(18) < 1 / 6] = -1
        masks.append(produce_ma_mask(kp, (H, W)))
    return masks


def read_csv_row(path):
    import csv

    with open(path) as f:
        header, row = list(csv.reader(f))
    return dict(zip(header, row))


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def phase_metrics(device):
    """metrics: the evaluation path on the card with jax, flax, pandas,
    imageio and PIL unimportable. The metrics CLI's main on 64 DeepFashion-
    size JPEG pairs (statistics.npz written, then read back by a second run
    that gives the same FID); the card against the CPU with the same
    fallback weights on the same decoded pixels: Inception pool3 features,
    FID, LPIPS plain and masked (Market's body masks), the CLI's
    reconstruction columns against numpy on those pixels; the animation
    heads' 256x256 PNGs on both devices (Inception features, LPIPS, and
    the reconstruction columns equal, the PNG reader being the host's).
    The card's CSV against the same columns from PIL's decode of the same
    files (the reference's reader). ms per Inception batch of 64 at
    299x299, per LPIPS batch of 32 at 256x176, with their FLOPs and f32
    bounds, and where the CLI's seconds go."""
    from gfla_tpu_torch.data.image_io import read_images
    from gfla_tpu_torch.data.resample import pil_resize
    from gfla_tpu_torch.metrics import (FID, LPIPS, ReconstructionMetrics,
                                        calculate_frechet_distance,
                                        compare_l1, compare_mae, compare_psnr,
                                        compare_ssim,
                                        preprocess_path_for_deform_task)
    from gfla_tpu_torch.metrics import __main__ as metrics_cli
    from gfla_tpu_torch.metrics.lpips import lpips_distance
    from gfla_tpu_torch.runtime import card_line, set_tf32

    work = tempfile.TemporaryDirectory()
    root = work.name
    t0 = time.perf_counter()
    masks = write_metric_trees(root, device)
    print(f"metrics: wrote {METRIC_PAIRS} JPEG pairs at {METRIC_SIZE} and "
          f"{METRIC_ANIM} PNG pairs at {ANIM_SIZE}x{ANIM_SIZE} in "
          f"{time.perf_counter() - t0:.2f} s")
    gt, gen = os.path.join(root, "gt"), os.path.join(root, "gen")
    out = os.path.join(root, "eval")
    args = [f"--gt_path={gt}", f"--distorated_path={gen}",
            f"--fid_real_path={gt}", "--name=smoke", f"--out_dir={out}",
            "--allow_fallback_weights", "--gpu_ids=0"]
    hide = mock.patch.dict(sys.modules, {m: None for m in METRIC_BLOCKED})
    with hide, warnings_off():
        t0 = time.perf_counter()
        with cli_run("metrics CLI"):
            metrics_cli.main(args)
        cli_s = time.perf_counter() - t0
        csvs = os.listdir(out)
        check(len(csvs) == 1, f"the CLI wrote {csvs}")
        row = read_csv_row(os.path.join(out, csvs[0]))
        stats = os.path.join(gt, "statistics.npz")
        check(os.path.exists(stats)
              and os.path.exists(os.path.join(gen, "metrics.npz")),
              "statistics.npz or metrics.npz not written")
        mtime = os.stat(stats).st_mtime_ns
        columns = ["", "name", "psnr", "psnr_variance", "ssim",
                   "ssim_variance", "ssim_256", "ssim_256_variance", "mae",
                   "mae_variance", "l1", "l1_variance", "fid", "lpips"]
        fallback = csvs[0] == "smoke_FALLBACK-WEIGHTS.csv"
        check(list(row) == columns + ["FALLBACK_WEIGHTS"] * fallback,
              f"CSV columns {list(row)}")
        values = {k: float(v) for k, v in row.items() if k in columns[2:]}
        check(all(np.isfinite(v) for v in values.values())
              and values["fid"] > 0, f"CSV values {values}")
        t0 = time.perf_counter()
        with cli_run("metrics CLI, second run"):
            metrics_cli.main(args)
        cli2_s = time.perf_counter() - t0
        again = float(read_csv_row(os.path.join(out, csvs[0]))["fid"])
        check(os.stat(stats).st_mtime_ns == mtime,
              "the second run rewrote statistics.npz")
        check(rel(again, values["fid"]) <= 1e-9,
              f"FID {again!r} from the cache vs {values['fid']!r}")
        print(f"metrics CLI: {csvs[0]}: {values}; a second run read "
              f"statistics.npz back, FID {again!r}")

        # the card against the CPU on the same pixels, with the caller's
        # TF32 on: the classes turn it off around their networks
        set_tf32(True)
        fid_card = FID(allow_fallback=True, device=device)
        fid_cpu = FID(allow_fallback=True, device="cpu")
        lp_card = LPIPS(allow_fallback=True, device=device)
        lp_cpu = LPIPS(allow_fallback=True, device="cpu")
        gt_list, gen_list = preprocess_path_for_deform_task(gt, gen)
        check(len(gen_list) == METRIC_PAIRS, f"{len(gen_list)} pairs")
        imgs = {"gt": read_images(gt_list, device),
                "gen": read_images(gen_list, device)}
        feats, errs = {}, []
        for key, batch in imgs.items():
            card = fid_card.features(batch).cpu().numpy()
            cpu = fid_cpu.features([i.cpu() for i in batch]).numpy()
            errs.append(np.abs(card - cpu).max() / np.abs(cpu).max())
            feats[key] = (card, cpu)
        check(max(errs) <= FEATURE_REL,
              f"Inception features card vs CPU {max(errs):.2e} x max")
        t0 = time.perf_counter()
        fid_cpu_value = calculate_frechet_distance(
            feats["gt"][1].mean(0), np.cov(feats["gt"][1], rowvar=False),
            feats["gen"][1].mean(0), np.cov(feats["gen"][1], rowvar=False))
        sqrtm_s = time.perf_counter() - t0
        fids = (values["fid"], fid_cpu_value)
        check(rel(fids[1], fids[0]) <= FID_REL,
              f"FID card {fids[0]!r} vs CPU {fids[1]!r}")
        m = torch.from_numpy(np.stack(masks).astype(np.float32))
        lp = {}
        for name, mask in (("plain", None), ("masked", m)):
            a = torch.cat([lp_card.distance(imgs["gen"][s:s + 32],
                                            imgs["gt"][s:s + 32],
                                            None if mask is None
                                            else mask[s:s + 32])
                           for s in range(0, METRIC_PAIRS, 32)]).cpu()
            b = torch.cat([lp_cpu.distance(
                [i.cpu() for i in imgs["gen"][s:s + 32]],
                [i.cpu() for i in imgs["gt"][s:s + 32]],
                None if mask is None else mask[s:s + 32])
                for s in range(0, METRIC_PAIRS, 32)])
            err = ((a - b).abs() / b.abs()).max().item()
            check(err <= LPIPS_REL, f"LPIPS {name} card vs CPU {err:.2e}")
            lp[name] = (a.mean().item(), err)
        check(torch.backends.cudnn.allow_tf32, "the classes left TF32 off")
        set_tf32(False)
        check(rel(lp["plain"][0], values["lpips"]) <= 1e-6,
              f"LPIPS {lp['plain'][0]!r} vs the CLI's {values['lpips']!r}")
        # the CLI's reconstruction columns, by numpy on the same pixels
        pix = [(p.cpu().numpy().astype(np.float32) / 255.0,
                g.cpu().numpy().astype(np.float32) / 255.0)
               for p, g in zip(imgs["gen"], imgs["gt"])]
        by_hand = {
            "psnr": np.mean([compare_psnr(g, p) for p, g in pix]),
            "ssim": np.mean([compare_ssim(g, p) for p, g in pix]),
            "mae": np.mean([compare_mae(g, p) for p, g in pix]),
            "l1": np.mean([compare_l1(g, p) for p, g in pix])}
        for key, value in by_hand.items():
            check(values[key] == round(float(value), 6),
                  f"{key}: CLI {values[key]!r} vs numpy {value!r}")
        print(f"card vs CPU, fallback weights, TF32 off, the card's nvJPEG "
              f"pixels: Inception features {max(errs):.2e} x max, FID "
              f"{fids[0]!r} vs {fids[1]!r} ({rel(fids[1], fids[0]):.2e}), "
              f"LPIPS plain {lp['plain'][0]:.6f} ({lp['plain'][1]:.2e}), "
              f"masked {lp['masked'][0]:.6f} ({lp['masked'][1]:.2e}); the "
              f"CLI's psnr, ssim, mae, l1 = numpy's on those pixels")

        # the animation heads' PNGs: features, LPIPS and the reconstruction
        # columns through the API on both devices (FID's sqrtm is the
        # JPEG set's, on the host either way)
        vis = sorted(os.path.join(root, "anim", "vis", f)
                     for f in os.listdir(os.path.join(root, "anim", "vis")))
        agt = sorted(os.path.join(root, "anim", "gt", f)
                     for f in os.listdir(os.path.join(root, "anim", "gt")))
        pngs = read_images(vis, device)
        card = fid_card.features(pngs).cpu().numpy()
        cpu = fid_cpu.features([i.cpu() for i in pngs]).numpy()
        png_err = np.abs(card - cpu).max() / np.abs(cpu).max()
        runs = [(net.calculate_from_disk(vis, agt, verbose=False),
                 ReconstructionMetrics(device=net.device).calculate_from_disk(
                     vis, agt))
                for net in (lp_card, lp_cpu)]
        (l1_, r1), (l2, r2) = runs
        check(png_err <= FEATURE_REL and rel(l2, l1_) <= LPIPS_REL
              and r1 == r2, f"PNG set card {runs[0]} vs CPU {runs[1]}, "
              f"features {png_err:.2e} x max")
        print(f"animation PNGs ({METRIC_ANIM} at {ANIM_SIZE}x{ANIM_SIZE}): "
              f"Inception features {png_err:.2e} x max, LPIPS {l1_!r} vs "
              f"CPU {l2!r}, the reconstruction columns equal: {r1}")

        # where the CLI's time goes; the networks' FLOPs (2 a multiply-add)
        # as FlopCounterMode counts their convolutions
        from torch.utils.flop_counter import FlopCounterMode

        x = torch.stack([pil_resize(i, (299, 299)) for i in imgs["gen"]])
        x = (x.float() / 255.0).permute(0, 3, 1, 2)
        a = torch.stack(imgs["gen"][:32]).float() / 127.5 - 1
        b = torch.stack(imgs["gt"][:32]).float() / 127.5 - 1
        a, b = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)
        with torch.no_grad():
            inc_ms = cuda_ms(lambda: fid_card.net(x), iters=10)
            lp_ms = cuda_ms(lambda: lpips_distance(lp_card.net, a, b),
                            iters=10)
            flops = []
            for run in (lambda: fid_card.net(x),
                        lambda: lpips_distance(lp_card.net, a, b)):
                with FlopCounterMode(display=False) as counter:
                    run()
                flops.append(counter.get_total_flops())
        decode_ms = host_ms(lambda: read_images(gen_list, device), iters=5)
        resize_ms = cuda_ms(lambda: [pil_resize(i, (299, 299))
                                     for i in imgs["gen"]], iters=5)
        t0 = time.perf_counter()
        ReconstructionMetrics(device=device).calculate_from_disk(
            gen_list, gt_list, sort=False)
        rec_s = time.perf_counter() - t0
    # PIL was unimportable inside, so no JPEG or PNG went through it
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in METRIC_NEVER)
    check(not loaded, f"{loaded} imported by the end of the metrics phase")

    # the card's CSV against the reference's decode: the same files through
    # PIL (read_images on the CPU), the same networks on the card
    pil = {k: read_images(v, "cpu") for k, v in (("gt", gt_list),
                                                  ("gen", gen_list))}
    diffs = torch.cat([(a.cpu().int() - b.int()).abs().flatten()
                       for k in imgs for a, b in zip(imgs[k], pil[k])])
    pil = {k: [i.to(device) for i in v] for k, v in pil.items()}
    f_gt, f_gen = (fid_card.features(pil[k]).cpu().numpy()
                   for k in ("gt", "gen"))
    ref = ReconstructionMetrics(device="cpu").calculate_from_disk(
        gen_list, gt_list, sort=False)
    ref = {k: v[0] for k, v in ref.items()}
    ref["fid"] = calculate_frechet_distance(
        f_gt.mean(0), np.cov(f_gt, rowvar=False), f_gen.mean(0),
        np.cov(f_gen, rowvar=False))
    ref["lpips"] = torch.cat([
        lp_card.distance(pil["gen"][s:s + 32], pil["gt"][s:s + 32])
        for s in range(0, METRIC_PAIRS, 32)]).mean().item()
    gaps = {k: rel(values[k], ref[k]) for k in values}
    means = ("psnr", "ssim", "ssim_256", "mae", "l1", "fid", "lpips")
    worst = max(means, key=gaps.get)
    check(gaps[worst] <= PIL_GAP_REL,
          f"{worst}: the card's CSV {values[worst]!r} vs PIL's decode "
          f"{ref[worst]!r} ({gaps[worst]:.2e})")
    print(f"the card's CSV vs PIL's decode of the same files (nvJPEG "
          f"{diffs.max().item()} levels off at most, "
          f"{(diffs > 0).float().mean().item():.4f} of the values differ): "
          + ", ".join(f"{k} {values[k]!r} vs {ref[k]!r} ({gaps[k]:.2e})"
                      for k in values))

    n = METRIC_PAIRS
    print(f"metrics (f32, TF32 off) on {card_line()}: Inception "
          f"{inc_ms:.3f} ms per batch of {n} at 299x299 ({flops[0] / 1e9:.1f}"
          f" GFLOP, bound {flops[0] / F32_PEAK * 1e3:.2f} ms at f32 peak, "
          f"{flops[0] / inc_ms / 1e9:.2f} TFLOP/s), AlexNet LPIPS "
          f"{lp_ms:.3f} ms per batch of 32 pairs at {METRIC_SIZE[0]}x"
          f"{METRIC_SIZE[1]} ({flops[1] / 1e9:.1f} GFLOP, bound "
          f"{flops[1] / F32_PEAK * 1e3:.2f} ms, "
          f"{flops[1] / lp_ms / 1e9:.2f} TFLOP/s); the CLI {cli_s:.2f} s "
          f"for {n} pairs (first "
          f"run, the networks' set-up included; {cli2_s:.2f} s reading "
          f"statistics.npz back): nvJPEG decode "
          f"{decode_ms:.2f} ms per {n} images, PIL-bilinear resize to 299 "
          f"{resize_ms:.2f} ms per {n}, host sqrtm of 2048x2048 "
          f"{sqrtm_s:.2f} s a FID, reconstruction metrics on the host "
          f"{rec_s:.2f} s per {n} pairs")
    work.cleanup()


@contextlib.contextmanager
def warnings_off():
    """The fallback weights' warnings, said once by the CLI's banner."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def phase_walkthrough():
    """walkthrough: `python -m gfla_tpu_torch.demo --walkthrough` on the
    card, a process of its own: the card, the build, the assets, a tiny
    pose training, its val panels and the metrics CLI on them; its CSV
    holds finite values."""
    import subprocess

    work = tempfile.TemporaryDirectory()
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gfla_tpu_torch.demo", "--walkthrough",
         "--gpu_ids=0", f"--work={work.name}"], cwd=here,
        capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or "walkthrough OK" not in proc.stdout:
        print(proc.stdout[-6000:], proc.stderr[-6000:])
    check(proc.returncode == 0 and "walkthrough OK" in proc.stdout,
          f"walkthrough exited {proc.returncode}")
    out = os.path.join(work.name, "eval")
    csvs = os.listdir(out)
    check(len(csvs) == 1, f"walkthrough wrote {csvs}")
    row = read_csv_row(os.path.join(out, csvs[0]))
    values = {k: float(row[k]) for k in ("psnr", "ssim", "ssim_256", "mae",
                                         "l1", "fid", "lpips")}
    check(all(np.isfinite(v) for v in values.values()),
          f"walkthrough CSV {values}")
    cells = [ln.strip() for ln in proc.stdout.splitlines()
             if ln.startswith("[") and ln[1:2].isdigit()
             or ln.startswith("    (cell")]
    print(f"walkthrough: {wall:.1f} s, {csvs[0]}: {values}; "
          f"{' '.join(cells)}")
    work.cleanup()


def task_pairs(root, prefix):
    """The (from, to) names of a tree's training pairs, in file order."""
    import csv

    with open(os.path.join(root, f"{prefix}-pairs-train.csv")) as f:
        return [(row["from"], row["to"]) for row in csv.DictReader(f)]


def site_cases(head, cases, results, unpack, work_of, peak=TF32X3_PEAK):
    """{case: max_abs_err, ms, plain_ms, bound_ms} of the cases in `cases`
    whose name starts with `head` (a dataset's attention sites), from each
    case's result as `unpack` reads it: (err, ms, plain_ms)."""
    out = {}
    for case in cases:
        if case[0].startswith(head):
            err, ms, plain_ms = unpack(results[case[0]])
            out[case[0]] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                            "bound_ms": bound(*work_of(case), peak)[0]}
    return out


def both_cases(cases, results, unpack, work_of, peak=TF32X3_PEAK):
    """site_cases of market's, ShapeNet's and the animation heads' sites,
    and of the other kernel sizes at the pose k=5 site."""
    return {head: site_cases(head, cases, results, unpack, work_of, peak)
            for head in ("market", "shapenet", "animation", "kernel size")}


UNITS = {TF32X3_PEAK: "tensor cores, 3 TF32 products per f32 product: "
                      "165 TFLOP/s",
         BF16_PEAK: "tensor cores, dense bf16: 989 TFLOP/s"}


def if_ran(path, counts, name):
    """{path: counts[name]} where the path ran (its counts not None), else
    {}: a path that did not run prints no count."""
    return {} if counts is None else {path: counts[name]}


def kernel_entry(name, source, replaces, by_path, err, tolerance, ms,
                 plain_ms, work, library_ms, shape, cases=None,
                 peak=TF32X3_PEAK):
    """One entry of the `kernels` line. The f32 kernels multiply by
    split-f32 products, so their bound is taken at TF32X3_PEAK, the bf16
    instances' at BF16_PEAK; the bound on the FP32 cores stands beside it.
    `cases`: both_cases' times at market's, ShapeNet's and the animation
    heads' shapes."""
    cases = cases or {}
    bound_ms, bound_by = bound(*work, peak)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": err,
            "tolerance": tolerance, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_unit": UNITS[peak],
            "bound_ms_fp32_cores": bound(*work)[0],
            "library_ms": library_ms, "ms_shape": shape,
            "market_cases": cases.get("market", {}),
            "shapenet_cases": cases.get("shapenet", {}),
            "animation_cases": cases.get("animation", {}),
            "kernel_size_cases": cases.get("kernel size", {}),
            **{f"{head}_cases": cases[head] for head in ("pose_k3", "wide")
               if head in cases}}


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    from gfla_tpu_torch.runtime import set_tf32

    set_tf32(False)
    with switches(GFLA_ATTN_PALLAS="auto", GFLA_PALLAS_CORR="0"):
        timed(phase_card)
        timed(phase_build)
        kernel = timed(phase_kernel, device)
        bwd = timed(phase_bwd_kernel, device)
        bf16 = timed(phase_bf16_kernels, device)
        corr = timed(phase_corr_kernel, device)
        attn, attn_inputs_kept = timed(phase_attn_kernel, device)
        attn_bf16 = timed(phase_attn_bf16_kernels, attn_inputs_kept)
        del attn_inputs_kept
        serve = timed(phase_slice, argv)
        serve_bf16 = timed(phase_serve_bf16, serve, argv)
        train = timed(phase_train)
        train_bf16 = timed(phase_train_bf16, train)
        flow = timed(phase_poseflownet)
        switched = timed(phase_switches, serve, train, train_bf16)
        wide = timed(phase_wide_kernel_size)
        data_parallel = timed(phase_data_parallel, train)
        spatial = timed(phase_spatial, train)
        disk = timed(phase_disk_data, device)
        sn_serve = timed(phase_shapenet_serve)
        sn_sweep = timed(phase_shapenet_sweep, sn_serve)
        sn_train = timed(phase_shapenet_train)
        sn_disk = timed(phase_shapenet_disk, sn_serve, sn_train)
        sn_flow = timed(phase_shapenetflow)
        sn_bf16 = timed(phase_shapenet_bf16, sn_serve, sn_train)
        anim, anim_f32, anim_states = {}, {}, {}
        for kind in ("dance", "face"):
            anim[f"{kind}_serve"] = timed(phase_anim_serve, kind)["launches"]
            anim_train = timed(phase_anim_train, kind)
            anim[f"{kind}_train"] = anim_train["counts"]
            anim_f32[kind] = {k: anim_train[k] for k in ("ms", "peak")}
            anim_states[kind] = {"state": anim_train["state"]}
            if kind == "dance":
                anim_switched = timed(phase_anim_switches, anim_train)
            del anim_train
        spatial.update(timed(phase_spatial_anim, anim_states))
        del anim_states
        video = timed(phase_video_disk, device, anim_f32["dance"]["ms"])
        anim_bf16 = timed(phase_anim_bf16, device, anim_f32)
        keypoint = timed(phase_keypoint, device)
        timed(phase_metrics, device)
        timed(phase_walkthrough)
    train = train["counts"]
    shapenet = {"shapenet_serve": sn_serve["launches"],
                "shapenet_sweep": sn_sweep}
    site = KERNEL_CASES[0]
    work = warp_work(*site[1:7])
    shape = "k=5 B=8 64x64 C=128 D=128"
    # the k <= 9 instances' entries read their cases, the wide entries theirs
    wide_names = {c[0] for c in KERNEL_CASES if c[6] >= WIDE_K}
    kernel_wide = {n: r for n, r in kernel.items() if n in wide_names}
    bwd_wide = {n: r for n, r in bwd.items() if n in wide_names}
    bf16_wide = {n: r for n, r in bf16.items() if n in wide_names}
    kernel = {n: r for n, r in kernel.items() if n not in wide_names}
    bwd = {n: r for n, r in bwd.items() if n not in wide_names}
    bf16 = {n: r for n, r in bf16.items() if n not in wide_names}
    _, ms, plain_ms = kernel[site[0]]
    none = None  # no single PyTorch call computes these
    entries = [kernel_entry(
        "warp_fwd", "gfla_tpu_torch/csrc/warp_fwd.cu",
        "gfla_tpu/ops/pallas_warp.py:166",
        {"serve": serve["launches"], "train": train["warp_fwd"],
         "train_corr": switched["train_corr"]["warp_fwd"],
         "ddp_train": data_parallel["ddp_train"]["warp_fwd"],
         **{path: c["warp_fwd"] for path, c in disk.items()},
         **shapenet, "shapenet_train": sn_train["counts"]["warp_fwd"],
         **{path: c["warp_fwd"] for path, c in sn_disk.items()},
         "dance_serve": anim["dance_serve"],
         "face_serve": anim["face_serve"],
         **{path: anim[path]["warp_fwd"]
            for path in ("dance_train", "face_train")},
         "dance_train_corr": anim_switched["dance_train_corr"]["warp_fwd"],
         "train_kernel_size": switched["train_kernel_size"]["warp_fwd"],
         **{path: c["warp_fwd"] for path, c in video.items()},
         "dance_mask_train": anim_bf16["dance_mask_train"]["warp_fwd"]},
        max(e for e, _, _ in kernel.values()), f"{KERNEL_ATOL:g} abs", ms,
        plain_ms, work["warp_fwd"], none, shape,
        both_cases(KERNEL_CASES, kernel, lambda r: r,
                   lambda c: warp_work(*c[1:7])["warp_fwd"]))]
    for name, part in (("warp_bwd_pos", "pos"), ("warp_bwd_w1", "w1")):
        entries.append(kernel_entry(
            name, "gfla_tpu_torch/csrc/warp_bwd.cu",
            "gfla_tpu/ops/pallas_warp.py:243",
            {"train": train[name],
             "train_corr": switched["train_corr"][name],
             "ddp_train": data_parallel["ddp_train"][name],
             **{path: c[name] for path, c in disk.items()
                if path.endswith("_train")},
             "shapenet_train": sn_train["counts"][name],
             "shapenet_disk_train": sn_disk["shapenet_disk_train"][name],
             **{path: anim[path][name]
                for path in ("dance_train", "face_train")},
             "dance_train_corr": anim_switched["dance_train_corr"][name],
             "train_kernel_size": switched["train_kernel_size"][name],
             "dance_disk_train": video["dance_disk_train"][name],
             "dance_mask_train": anim_bf16["dance_mask_train"][name]},
            max(r[part][0] for r in bwd.values()),
            f"{BWD_REL:g} x max|value| of each output",
            bwd[site[0]][part][1], bwd[site[0]][part][2], work[name], none,
            shape, both_cases(
                KERNEL_CASES, bwd, lambda r, part=part: r[part],
                lambda c, name=name: warp_work(*c[1:7])[name])))
    for entry in entries:  # (b)'s paths, where the ranks ran
        for path in ("spatial_train", "spatial_train_remat",
                     "spatial_train_shapenet", "spatial_train_dance",
                     "spatial_train_face", "spatial_train_dance_mask_corr",
                     "spatial_train_face_remat", "spatial_train_keypoint"):
            ran = if_ran(path, spatial[path], entry["name"])
            entry["launches_by_path"].update(ran)
            entry["launches"] += sum(ran.values())
    work16 = warp_work_bf16(*site[1:7])
    anim_paths = ("dance_train_bf16", "face_train_bf16",
                  "dance_train_bf16_corr", "dance_train_bf16_remat",
                  "dance_mask_train_bf16")
    for name, part, source, replaces, paths in (
            ("warp_fwd_bf16", "fwd", "warp_fwd_bf16.cu", "166",
             {"serve_bf16": serve_bf16["launches"],
              "train_bf16": train_bf16["counts"]["warp_fwd_bf16"],
              "shapenet_serve_bf16": sn_bf16["serve"],
              "shapenet_train_bf16": sn_bf16["train"]["warp_fwd_bf16"]}),
            ("warp_bwd_pos_bf16", "pos", "warp_bwd_bf16.cu", "243",
             {"train_bf16": train_bf16["counts"]["warp_bwd_pos_bf16"],
              "shapenet_train_bf16": sn_bf16["train"]["warp_bwd_pos_bf16"]}),
            ("warp_bwd_w1_bf16", "w1", "warp_bwd_bf16.cu", "243",
             {"train_bf16": train_bf16["counts"]["warp_bwd_w1_bf16"],
              "shapenet_train_bf16": sn_bf16["train"]["warp_bwd_w1_bf16"]})):
        paths.update({path: anim_bf16[path][name] for path in anim_paths})
        for path in ("spatial_train_bf16", "spatial_train_dance_bf16"):
            paths.update(if_ran(path, spatial[path], name))
        kern = name.removesuffix("_bf16")
        entries.append(kernel_entry(
            name, f"gfla_tpu_torch/csrc/{source}",
            f"gfla_tpu/ops/pallas_warp.py:{replaces}", paths,
            max(r[part][0] for r in bf16.values()),
            f"{BF16_OUT_REL:g} (out, hpre, d_source), {BF16_GRAD_REL:g} "
            f"(other gradients) x max|f32 value| against the bf16 plain twin",
            bf16[site[0]][part][1], bf16[site[0]][part][2], work16[kern],
            none, shape, both_cases(
                KERNEL_CASES, bf16, lambda r, part=part: r[part],
                lambda c, kern=kern: warp_work_bf16(*c[1:7])[kern],
                BF16_PEAK), peak=BF16_PEAK))
    # the wide instances, at the k=11 site of --kernel_size 2=11,3=13
    site_w = next(c for c in KERNEL_CASES
                  if c[0] == "wide k=11 at the k=5 site")
    shape_w = "k=11 B=8 64x64 C=128 D=128"
    for name, source, replaces, results, unpack, works, peak, tol, paths in (
            ("warp_fwd_wide", "warp_fwd.cu", "166", kernel_wide,
             lambda r: r, warp_work, TF32X3_PEAK, f"{KERNEL_ATOL:g} abs",
             ("train_kernel_size_wide", "serve_kernel_size_wide")),
            ("warp_bwd_pos_wide", "warp_bwd.cu", "243", bwd_wide,
             lambda r: r["pos"], warp_work, TF32X3_PEAK,
             f"{BWD_REL:g} x max|value| of each output",
             ("train_kernel_size_wide",)),
            ("warp_bwd_w1_wide", "warp_bwd.cu", "243", bwd_wide,
             lambda r: r["w1"], warp_work, TF32X3_PEAK,
             f"{BWD_REL:g} x max|value| of each output",
             ("train_kernel_size_wide",)),
            ("warp_fwd_wide_bf16", "warp_fwd_bf16.cu", "166", bf16_wide,
             lambda r: r["fwd"], warp_work_bf16, BF16_PEAK, None,
             ("train_kernel_size_wide_bf16",)),
            ("warp_bwd_pos_wide_bf16", "warp_bwd_bf16.cu", "243", bf16_wide,
             lambda r: r["pos"], warp_work_bf16, BF16_PEAK, None,
             ("train_kernel_size_wide_bf16",)),
            ("warp_bwd_w1_wide_bf16", "warp_bwd_bf16.cu", "243", bf16_wide,
             lambda r: r["w1"], warp_work_bf16, BF16_PEAK, None,
             ("train_kernel_size_wide_bf16",))):
        kern = name.removesuffix("_bf16").removesuffix("_wide")
        err, ms_w, plain_w = unpack(results[site_w[0]])
        entries.append(kernel_entry(
            name, f"gfla_tpu_torch/csrc/{source}",
            f"gfla_tpu/ops/pallas_warp.py:{replaces}",
            {path: wide[path][name] for path in paths},
            max(unpack(r)[0] for r in results.values()),
            tol or f"{BF16_OUT_REL:g} (out, hpre, d_source), "
                   f"{BF16_GRAD_REL:g} (other gradients) x max|f32 value| "
                   f"against the bf16 plain twin",
            ms_w, plain_w, works(*site_w[1:7])[kern], none, shape_w,
            {"wide": site_cases(
                "wide", KERNEL_CASES, results, unpack,
                lambda c, works=works, kern=kern: works(*c[1:7])[kern],
                peak)}, peak=peak))
    c = corr[CORR_CASES[0][0]]
    entries.append(kernel_entry(
        "max_corr", "gfla_tpu_torch/csrc/max_corr.cu",
        "gfla_tpu/ops/pallas_corr.py:36",
        {"poseflownet": flow["max_corr"],
         "train_corr": switched["train_corr"]["max_corr"],
         "shapenetflow": sn_flow["max_corr"],
         "dance_train_corr": anim_switched["dance_train_corr"]["max_corr"],
         "dance_train_bf16_corr":
             anim_bf16["dance_train_bf16_corr"]["max_corr"],
         **if_ran("spatial_train_corr", spatial["spatial_train_corr"],
                  "max_corr"),
         **if_ran("spatial_train_dance_mask_corr",
                  spatial["spatial_train_dance_mask_corr"], "max_corr")},
        max(r["err"] for r in corr.values()), f"{CORR_ATOL:g} abs (cmax)",
        c["ms"], c["plain_ms"], c["work"], c["library_ms"],
        "B=8 Ns=Nt=4096 C=256",
        {"market": site_cases(
            "market", CORR_CASES, corr,
            lambda r: (r["err"], r["ms"], r["plain_ms"]),
            lambda c: corr_work(*c[1:5])),
         # ShapeNet's correctness loss reads relu3_1 at 256x256, the shape
         # of the first case
         "shapenet": {CORR_CASES[0][0]: dict(
             max_abs_err=c["err"], ms=c["ms"], plain_ms=c["plain_ms"],
             bound_ms=bound(*c["work"], TF32X3_PEAK)[0])},
         # the animation heads' loss reads both layers over B * T = 12
         # frames
         "animation": site_cases(
             "animation", CORR_CASES, corr,
             lambda r: (r["err"], r["ms"], r["plain_ms"]),
             lambda c: corr_work(*c[1:5]))}))
    a = attn[ATTN_CASES[0][0]]
    for name, part, paths in (
            ("attn_math_fwd", "fwd", ("serve_attn", "train_attn")),
            ("attn_math_bwd", "bwd", ("train_attn",))):
        entries.append(kernel_entry(
            name, f"gfla_tpu_torch/csrc/{name}.cu",
            "gfla_tpu/ops/pallas_attn.py:"
            + ("64" if part == "fwd" else "155"),
            {**{path: switched[path][name] for path in paths},
             "dance_train_attn": anim_switched["dance_train_attn"][name],
             **{path: wide[path][name] for path in (
                 "serve_kernel_size_wide_attn", "train_kernel_size_wide_attn")
                if part == "fwd" or path.startswith("train")}},
            max(r[part]["err"] for r in attn.values()),
            f"{BWD_REL:g} x max|value| of each output", a[part]["ms"],
            a[part]["plain_ms"], a[part]["work"], none,
            "N=32768 k=5 C=128 D=128",
            {head: site_cases(
                head, ATTN_CASES, attn,
                lambda r, part=part: (r[part]["err"], r[part]["ms"],
                                      r[part]["plain_ms"]),
                lambda c, part=part: attn_work(*c[1:5])[
                    0 if part == "fwd" else 1])
             for head in ("shapenet", "animation")}))
    a = attn_bf16[ATTN_BF16_CASES[0][0]]
    for name, part, paths in (
            ("attn_math_fwd_bf16", "fwd",
             {"serve_bf16_attn": serve_bf16["attn_launches"],
              "train_bf16_attn":
                  switched["train_attn_bf16"]["attn_math_fwd_bf16"],
              "dance_train_bf16_attn":
                  anim_bf16["dance_train_bf16_attn"]["attn_math_fwd_bf16"]}),
            ("attn_math_bwd_bf16", "bwd",
             {"train_bf16_attn":
                  switched["train_attn_bf16"]["attn_math_bwd_bf16"],
              "dance_train_bf16_attn":
                  anim_bf16["dance_train_bf16_attn"]["attn_math_bwd_bf16"]})):
        entries.append(kernel_entry(
            name, f"gfla_tpu_torch/csrc/{name}.cu",
            "gfla_tpu/ops/pallas_attn.py:"
            + ("64" if part == "fwd" else "155"), paths,
            max(r[part]["err"] for r in attn_bf16.values()),
            f"{BF16_OUT_REL:g} (out, d_bs), {BF16_GRAD_REL:g} (other "
            f"gradients) x max|f32 value| against the bf16 plain twin",
            a[part]["ms"], a[part]["plain_ms"], a[part]["work"], none,
            "N=32768 k=5 C=128 D=128",
            {"pose_k3": site_cases(
                "k=3", ATTN_BF16_CASES, attn_bf16,
                lambda r, part=part: (r[part]["err"], r[part]["ms"],
                                      r[part]["plain_ms"]),
                lambda c, part=part: attn_work_bf16(*c[1:5])[
                    0 if part == "fwd" else 1], BF16_PEAK),
             **{head: site_cases(
                head, ATTN_BF16_CASES, attn_bf16,
                lambda r, part=part: (r[part]["err"], r[part]["ms"],
                                      r[part]["plain_ms"]),
                lambda c, part=part: attn_work_bf16(*c[1:5])[
                    0 if part == "fwd" else 1], BF16_PEAK)
                for head in ("shapenet", "animation")}},
            peak=BF16_PEAK))
    # the keypoint head's own path (training and serving) launches none of
    # them, the dance chunk served on its JSONs the warp forward's 24
    for entry in entries:
        own = sum(keypoint[path][entry["name"]]
                  for path in ("keypoint_train", "keypoint_serve"))
        chain = keypoint["keypoint_chain_dance"][entry["name"]]
        entry["launches_by_path"].update(keypoint=own,
                                         keypoint_chain_dance=chain)
        entry["launches"] += own + chain
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
