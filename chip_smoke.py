#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`horopose_tpu_torch`) on one CUDA card.

Run from the repository root on a machine with an H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. the card: its name and power limit (nvidia-smi), and what the data
     path and a flax-checkpoint reader could use on the machine (PIL,
     yaml, cv2, msgpack, libjpeg's header, and whether the port's native
     library, built here with g++, decodes with libjpeg or leaves it to
     PIL);
  2. build every hand-written kernel from `horopose_tpu_torch/csrc/` with
     nvcc for sm_90a, one nvcc per source, all started together;
  3. each kernel against its plain PyTorch version on the card, at the
     serving and training shapes in float32 and bfloat16 and at ragged
     shapes (odd W, whole splits and rows of -inf logits, logits one
     element past a 16-byte boundary): the soft-argmax forward (with the
     (max, sum) it saves) and backward (each dx entry against a bound
     scaled to that entry, and in L2), both dtypes at every ragged shape;
  3c. the 3x3 conv kernel against its plain version (element by element)
     and against cuDNN's `F.conv2d`, TF32 off, in float32 and bfloat16 at
     the HRNet branch-0 shapes (128 and 64, 64, 64, 32 -> 32), at the two
     test shapes, at odd channel counts, F not a multiple of 32, a deep C
     and 65536 images of 2x2; then its path, the `tools/bench_conv` entry
     point, once.
     Every kernel is timed three ways (`timings`): `ms`, the median of
     single calls between CUDA events (host dispatch included); `device_ms`,
     back-to-back launches over a ring of inputs larger than twice the L2
     cache, on the device alone (`tools/timing.py`); `host_ms`, the
     wrapper's host time. The bound share is bound_ms / device_ms;
  4. serving end to end at full width: the panda flagship FullNet (resnet50
     reg + hrnet32 rootnet backbones, 256x256 crops, depth_dim 64) with
     random weights from a seed, answering requests of synthetic 480x640
     frames at b=1, 8 and 128 in float32 and bfloat16; the forward
     kernel's launch count must rise by one per forward; a breakdown of
     one request's time (host clock and a torch.profiler trace);
  5. training end to end at full width: the same model's stage-2 train
     step (`core.engine.build_full_train_step`) at b=64 on a synthetic
     DREAM-layout batch, 12 steps each in float32 and bfloat16 (autocast);
     both kernels' launch counts must rise by one per step; a
     torch.profiler breakdown of one step;
  6. with TF32 off: the float32 forward with the kernel against the same
     forward with the plain soft-argmax and against the CPU's; one float32
     train step with the kernels against the same step with the plain
     soft-argmax under autograd; one train step on the card against the
     same step on the CPU at b=2;
  8. stage 1 at full width: `configs/panda/depthnet.yaml` read by the
     port's `config.make_cfg` (hrnet32 DepthNet, 256x256 crops, b=64),
     `pipelines.train_depthnet` for one epoch of 8 steps on synthetic
     batches and a validation of 2, in float32 and bfloat16, its
     checkpoint written and reloaded; step time, a torch.profiler
     breakdown and the cuDNN time of the hrnet32 branch-0 3x3 convs in a
     step beside the conv kernel's time at that shape; the checkpoint
     handed to a stage-2 FullNet (`configs/panda/full.yaml`,
     `pipelines.train_full.init_fullnet_state`) that takes two steps with
     both soft-argmax kernels; one float32 DepthNet step on the card
     against the CPU at b=2, TF32 off;
  9. stage 2 from files at full width: the port's DREAM writer puts a
     384-frame train set and a 150-frame test set of 480x640 JPEGs in a
     temporary directory; the train loader of `configs/panda/full.yaml`
     (its augmentations and loader workers) is timed alone for an epoch;
     `pipelines.train_full.train_full` trains one epoch of 6 steps at
     b=64 from them through pinned batches copied ahead on a side stream,
     and validates the test set (64 + 64 + 22); the soft-argmax forward
     must launch once a step and once a validation batch, the backward
     once a step, and the best-AUC keeper must save exactly when the ADD
     AUC is above 0; then the H2D time of one batch, a profiled step (its
     idle share against the step time with the loader), a timed
     validation, and `pipelines.test.test_network` at b=128 (128 + 22
     padded) from the trained weights, whose summary.txt must hold every
     field; it launches the forward once a batch and once a timed
     forward of `measure_forward_fps`;
  10. stage 3 (sim2real) at full width: the writer puts a real-named set
     (`real/panda-3cam_azure`) of 128 480x640 JPEGs beside phase 9's;
     `configs/panda/self_supervised/azure.yaml` as read (b=32, the tiled
     renderer, a teacher at 240x320) but for train_ds_names, a random
     teacher (allow_random_teacher), phase 9's checkpoint as
     pretrained_weight_on_synth and an epoch of 4 steps;
     `pipelines.train_sim2real.train_sim2real` runs the tracked-view pass,
     the steps, a validation with PnP and the tracked renders, the
     soft-argmax launch counts checked; then the step time, peak memory,
     device busy and idle share, the dense and tiled renders at the
     step's shapes, the teacher, PnP of 32 frames (its residual, the
     calls that synchronise, R against the CPU), a timed validation, and
     one b=2 step on the card against the CPU with TF32 off;
  11. two variant FullNets at the flagship's full width with random
     weights from a seed: V1 (add_fc, multi_kp over the 7 keypoints,
     reg_joint_map with 256-wide joint convs, rot_iterative_matmul) and
     V2 (direct_reg_rot, quaternion rotations). Each is served through
     Predictor at b=1 and 128 in float32 beside phase 4's flagship,
     trains the stage-2 step at b=64 on phase 5's batch (2 warm-ups, the
     median of 5, one traced step for the device's busy time), and holds
     its forward with TF32 off as phase 6 holds the flagship's (the
     kernel against the plain soft-argmax, 2 rows against the CPU), every
     output; V1 also one b=2 train step against the CPU. The soft-argmax kernels must
     launch once a forward and once a backward on both paths. Then
     `test_network` on phase 9's test set with the plots
     (`visualization=True`; a missing matplotlib makes them no-ops, which
     is said and is no failure) and a torch.profiler trace
     (`profile_dir`), and one frame of the synthetic writer's shaded
     render (`render_images=True`);
  12. the weight files and the serving artifact, at the flagship's full
     width: the built-in panda URDF written as the user's under a
     temporary data directory with one link's visual a `<mesh>` OBJ,
     which `make_robot` must read (its path, `build_robot_mesh`'s faces,
     FK on the card against the built-in robot); phase 4's seeded weights
     saved as a reference `.pk` ({model_state_dict, epoch, auc_add}),
     converted by `python -m horopose_tpu_torch.tools.convert fullnet` in
     a subprocess, both files read by `Predictor.from_experiment` (weights
     bitwise equal to the seeded ones, b=128 outputs against the seeded
     Predictor's); a seeded CtRNet teacher under the
     reference's names converted by `tools.convert ctrnet_seg` and read by
     the stage-3 teacher loader (weights and b=32 masks equal); the
     serving forward exported at b=128 in float32 (`tools/export.py`),
     saved, loaded and run: its outputs against the eager forward, the
     soft-argmax launches inside the program (one a call), its export
     seconds, size, and median time beside the eager forward's, one call
     of each traced on the device; the host time of a soft-argmax call
     through the wrapper and through the registered operator. Its
     comparisons run with TF32 off and cuDNN's deterministic algorithms
     (the transposed convs' sums otherwise change order between calls);
  13. data parallelism over torch.distributed, on phase 9's files and
     phase 5's batch and weights: (a) `torchrun --standalone
     --nproc_per_node=1 -m horopose_tpu_torch.scripts.train` with
     HOROPOSE_DISTRIBUTED=auto trains an epoch of phase 9's config at one
     NCCL rank (its scalars written, the keeper's decision checked), and
     in this process `train_full` in a world-1 NCCL group must give the
     losses of the run without a group, step for step, under
     `deterministic_convs`, each kernel launched once a step, with the
     gradient all-reduce timed once the CLI child has ended; (b) two
     ranks spawned on the one card over gloo (`chip_smoke.py --dp-rank
     <dir>`), 32 rows each of phase 5's batch, 3 stage-2 steps with
     dropout and TF32 off, against the same steps on the 64 rows in this
     process: the losses at 1e-4, and the weights and the BatchNorm
     statistics after every step within 1e-4 or twice the distance of
     the same steps on the rows in reverse order, each rank's soft-argmax
     launches once a step,
     and a validation of phase 9's 150 frames (75 a rank) against the
     single-process one at 1e-5; each rank's step and gradient
     all-reduce times are printed, which say nothing about scaling; (c)
     under two ranks `train_sim2real` and a `mesh_shape` of [1] must be
     refused. Every child has a timeout and is killed on a failure;
  14. the learning demo's slice: (a) the memorization regression of
     `tests/test_auc_regression.py` (`memorization_run`: 4 noise frames
     with eval = train, resnet18 backbones at 64x64, b=4, up to 450
     one-step epochs from the port's loader with no workers, in float32
     with TF32 off and cuDNN's deterministic algorithms, as the JAX test
     runs on the CPU): the ADD AUC with batch statistics must reach 0.70
     and with running statistics 0.15, every loss finite, the kernels
     launched once a step and once an evaluation forward; (b)
     `cfg.remat` at the flagship's width on phase 5's batch and weights,
     f32 and bf16: one step with remat and one without from the same
     state under `deterministic_convs`, their losses, gradients and
     BatchNorm statistics (each counter at 1) at the CPU test's
     tolerances; then each one's step ms, peak memory (and in f32 a
     profiled step) and the largest batch up to 256 that steps; (c) the native C++ crop
     against `data/crop.py` on the host over 256 random 480x640 frames
     and bboxes (some partly outside) to 256^2, at most one level apart
     on at most 0.1% of values, which library decodes the JPEGs, and
     phase 9's loader rate beside it; (d) `python -m
     horopose_tpu_torch.scripts.demo_learn` with 128 + 32 rendered frames,
     10 epochs at b=32, at full width in a child process (`chip_smoke.py
     --demo`, deterministic convs): it must exit 0, print a progression row with a finite
     loss for every epoch, end with a lower mean training loss than it
     began, and launch the kernels once a step, a validation batch and a
     harness forward; its ADD AUC is printed, not gated;
  7. one JSON line describing every kernel, and as the last line
     {"ok": true, "device": {...}}.

They run in the order 1-5, 8, 9, 10, 11, 12, 13, 14, 6, 7: phases 8-12 keep
cuDNN's default TF32 for float32, as phases 4 and 5 do (phases 11-13
turn it off for their comparisons), and phase 8's b=2 comparison runs
with phase 6's. Each phase prints its wall time. Phases 9 and 10 close their
loaders and print each close()'s time. Each path's kernel launch counts
are set to 0 just before it and read just after it; launches made to
compare a kernel with its plain version are not counted.

It exits non-zero with no result when no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet), at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# float32 operations per logit in the soft-argmax: compare, subtract, exp,
# and a multiply-add into each of the four running sums
SAM_OPS_PER_ELEMENT = 11
# ... in its backward: subtract, exp, scale by 1/s, three (idx - E) and
# their three multiply-adds, the product with p
SAM_BWD_OPS_PER_ELEMENT = 12

UVD_TOL = 1e-5          # |uvd| is at most 0.5; f32 sums in another order
E_TOL = 1e-3            # index units, up to 63
S_REL_TOL = 1e-4        # the saved sum of exp(x - m): 262,144 f32 terms
# the backward's dx against its plain version, element by element:
#   |dx - dx_plain| <= DX_TERMS_RTOL * p * T + DX_ROUND_RTOL * |dx_plain|,
# p the element's softmax weight and T = sum_axis |g_axis / dim_axis *
# (idx_axis - E_axis)| the size of the three terms its sum cancels. The
# first part is a few f32 roundings of the element (expf against torch.exp,
# the three products and their sum, the product with p); the second, in
# bf16, is one bf16 ulp of the element, as two f32 values that differ in
# their last bits may round to neighbouring bf16 values. The L2-relative
# error of the whole dx is held to the larger of the two rates.
DX_TERMS_RTOL = 2e-6
DX_ROUND_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}
SAME_DEVICE_REL = 1e-4  # kernel forward vs plain forward, one card, f32
CROSS_DEVICE_REL = 1e-3  # card vs CPU: other conv algorithms, 150+ layers
# train step, kernels vs plain soft-argmax on one card, f32, TF32 off:
STEP_LOSS_REL = 1e-4    # the loss dict
HEAD_GRAD_REL = 1e-3    # final_layer.weight's gradient, right after dx
STEP_GRAD_COSINE = 0.99999
# train step, card vs CPU (train-mode BatchNorm sums in another order)
CROSS_LOSS_REL = 1e-3
CROSS_GRAD_COSINE = 0.9999
# the 3x3 conv kernel against its plain version (both accumulate in f32,
# in another order, and round once to the output's dtype): float32 max
# |dy| <= CONV_F32_REL * max |y|; bfloat16 each entry within one bf16 ulp
# of its own magnitude (2^-7 |y| is at least one ulp) plus
# CONV_F32_REL * max |y|
CONV_F32_REL = 1e-5
CONV_ROUND_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}
# ... and against cuDNN (TF32 off), as max |dy| / max |y|: cuDNN rounds its
# own output, so in bf16 the two may differ by one ulp of the largest entry
CONV_LIB_REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7 + 1e-5}
# hrnet32's branch 0 (stride 4 of a 256x256 crop): 32 channels at 64x64
BRANCH0_CHANNELS, BRANCH0_HW = 32, 64
SEED = 0
# configs/panda/full.yaml: epoch_size 104950 images at batch 64
STEPS_PER_EPOCH = 104950 // 64
STAGE1_CONFIG = os.path.join("configs", "panda", "depthnet.yaml")
STAGE2_CONFIG = os.path.join("configs", "panda", "full.yaml")
STAGE1_STEPS, STAGE1_WARMUP, STAGE1_VAL_BATCHES = 8, 2, 2
# phase 9: DREAM-layout sets written from a seed, 480x640 noise JPEGs; the
# train set is one epoch of 6 steps at b=64, the test set 150 frames, so
# its last batch is partial at b=64 (64 + 64 + 22) and at b=128 (128 + 22)
STAGE2_TRAIN_FRAMES, STAGE2_TEST_FRAMES, TEST_BATCH = 384, 150, 128
# test_network's forward timing (pipelines/test.py::measure_forward_fps,
# 10 calls after one warm-up): "all" and "other" each launch the
# soft-argmax forward once a call
FPS_ITERS = 10
# libjpeg's header, which the native JPEG decode builds against
JPEG_HEADER = "/usr/include/jpeglib.h"


CELL = (7, 64, 64, 64)            # 7 keypoints, a 64^3 heatmap each


# ragged (shape, kind) cases of both soft-argmax kernels: odd W with D*H*W
# not a multiple of 8, whole splits and rows of -inf logits, logits one
# element past a 16-byte boundary
SAM_RAGGED = (((2, 3, 5, 7, 9), None), ((3, 7, 33, 65, 31), None),
              ((2, 3, 16, 32, 64), "minus_inf"),
              ((2, 3, 16, 32, 64), "offset"))


def sam_fwd_cases(b_train: int) -> list:
    """Phase 3's forward cases (shape, dtype, kind): the serving and
    training shapes, and the ragged ones, in both dtypes."""
    both = (torch.float32, torch.bfloat16)
    return ([((b, *CELL), dt, None) for b in (1, 128, b_train) for dt in both]
            + [(shape, dt, kind) for shape, kind in SAM_RAGGED
               for dt in both])


def sam_bwd_cases(b_train: int) -> list:
    """Phase 3's backward cases (shape, dtype, kind), each in both dtypes:
    b=1 and the training shape, a -inf row at (2, 3, 5, 7, 9), and the
    other ragged ones, W = 31 also with -inf rows: W = 31 and logits off 16
    bytes take the kernel's scalar path."""
    both = (torch.float32, torch.bfloat16)
    return ([((b, *CELL), dt, None) for b in (1, b_train) for dt in both]
            + [((2, 3, 5, 7, 9), dt, "row_inf") for dt in both]
            + [(shape, dt, kind) for shape, kind in
               (*SAM_RAGGED[1:], ((3, 7, 33, 65, 31), "minus_inf"))
               for dt in both])


def conv_cases(b_train: int) -> list:
    """Phase 3c's conv cases (shape, dtype): the HRNet branch-0 shapes at
    b=128 and at the training batch, the two test shapes, odd channel
    counts, F not a multiple of 32, a deep C and more images than a grid
    dimension's 65535, in both dtypes."""
    return [(shape, dt) for shape in (
        (128, BRANCH0_HW, BRANCH0_HW, BRANCH0_CHANNELS, BRANCH0_CHANNELS),
        (b_train, BRANCH0_HW, BRANCH0_HW, BRANCH0_CHANNELS, BRANCH0_CHANNELS),
        (2, 8, 8, 32, 32), (4, 16, 12, 8, 16), (3, 10, 14, 5, 7),
        (2, 6, 6, 32, 48), (1, 8, 8, 224, 16), (65536, 2, 2, 8, 8))
        for dt in (torch.float32, torch.bfloat16)]


def time_ms(fn, reps: int) -> float:
    """Median of `reps` single-call CUDA-event timings, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def soft_argmax_bound_ms(x: torch.Tensor) -> tuple:
    """(bound in ms, what bounds it): each logit read once, (uvd, E) written
    once, against the ~11 f32 operations per logit."""
    bytes_moved = x.numel() * x.element_size() + x.shape[0] * (3 + 3 + 2) * 4
    byte_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    op_ms = x.numel() * SAM_OPS_PER_ELEMENT / F32_FLOPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def sam_logits(shape, dtype, kind, gen, device) -> torch.Tensor:
    """(B*K, D, H, W) logits 3 * N(0, 1) in `dtype`. kind "minus_inf" sets
    the first half of cell 0's rows (whole splits) and the last row of the
    last cell to -inf; "row_inf" the first row of cell 0; "offset" puts the
    tensor one element past a 16-byte boundary, as a slice of a larger
    buffer."""
    B, K, D, H, W = shape
    x = (3 * torch.randn(B * K, D, H, W, generator=gen, device=device)
         ).to(dtype)
    if kind == "offset":
        buf = torch.empty(x.numel() + 1, dtype=dtype, device=device)
        buf[1:].copy_(x.flatten())
        x = buf[1:].view(x.shape)
    elif kind == "minus_inf":
        x[0, :D // 2] = float("-inf")
        x[-1, -1, -1] = float("-inf")
    elif kind == "row_inf":
        x[0, 0, 0] = float("-inf")
    return x


def timings(fn, ring: list, reps: int) -> dict:
    """ms (median single call, host dispatch included), device_ms (over
    `ring`, distinct inputs larger than twice the L2 cache together) and
    host_ms of fn(input)."""
    from horopose_tpu_torch.tools.timing import device_ms, host_ms
    out = dict(ms=time_ms(lambda: fn(ring[-1]), reps),
               host_ms=host_ms(fn, ring[-1], reps))
    out["device_ms"] = device_ms(fn, ring, per_call_host_ms=out["host_ms"])
    return out


def ring_of(x: torch.Tensor, make) -> list:
    """A timing ring of inputs like x: `make(n)` gives n of them stacked
    along the first axis (or a tuple of such stacks), larger than twice the
    L2 cache together, which are cut apart in the order they were
    written."""
    from horopose_tpu_torch.tools.timing import ring_size, ring_slices
    n = ring_size(x.numel() * x.element_size())
    return ring_slices(make(n), n)


def check_soft_argmax(device, cases, reps: int, card: str = ""):
    """Kernel against plain on the same inputs, case (shape, dtype, kind)
    with kind None, "minus_inf" or "offset" (`sam_logits`); returns one row
    per case."""
    from horopose_tpu_torch.ops.integral import soft_argmax_3d_fwd_plain
    from horopose_tpu_torch.ops.integral_cuda import soft_argmax_3d_fwd
    g = torch.Generator(device=device).manual_seed(SEED)
    rows = []
    for shape, dtype, kind in cases:
        x = sam_logits(shape, dtype, kind, g, device)
        uvd, e, st = soft_argmax_3d_fwd(x)
        uvd_p, e_p, st_p = soft_argmax_3d_fwd_plain(x)  # reads the same values
        torch.cuda.synchronize()
        err_uvd = float((uvd - uvd_p).abs().max())
        err_e = float((e - e_p).abs().max())
        err_m = float((st[:, 0] - st_p[:, 0]).abs().max())
        rel_s = float(((st[:, 1] - st_p[:, 1]).abs() / st_p[:, 1]).max())
        if not (err_uvd <= UVD_TOL and err_e <= E_TOL and err_m == 0.0
                and rel_s <= S_REL_TOL):
            raise AssertionError(f"soft_argmax {shape} {dtype} {kind}: "
                                 f"|duvd| {err_uvd} |dE| {err_e} |dm| "
                                 f"{err_m} rel ds {rel_s}")
        bound, bound_by = soft_argmax_bound_ms(x)
        ring = ring_of(x, lambda n: sam_logits((n * shape[0], *shape[1:]),
                                               dtype, kind, g, device))
        t = timings(soft_argmax_3d_fwd, ring, reps)
        del ring
        row = dict(shape=list(shape), dtype=str(dtype).split(".")[-1],
                   kind=kind, max_abs_err=err_uvd, max_abs_err_E=err_e,
                   max_abs_err_m=err_m, max_rel_err_s=rel_s, **t,
                   plain_ms=time_ms(lambda: soft_argmax_3d_fwd_plain(x), reps),
                   bound_ms=bound, bound_by=bound_by,
                   bound_share=bound / t["device_ms"])
        rows.append(row)
        print("soft_argmax_3d_fwd", json.dumps(row), f"({card})", flush=True)
        del x, uvd, e, st, uvd_p, e_p, st_p
    return rows


def soft_argmax_bwd_bound_ms(x: torch.Tensor) -> tuple:
    """(bound in ms, what bounds it) of the backward: each logit read once
    and dx written once, E, (m, s) and g read once, against ~12 f32
    operations per logit."""
    bytes_moved = (2 * x.numel() * x.element_size()
                   + x.shape[0] * (3 + 2 + 3) * 4)
    byte_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    op_ms = x.numel() * SAM_BWD_OPS_PER_ELEMENT / F32_FLOPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def dx_tolerance(x, e, st, g, dx_p) -> torch.Tensor:
    """The per-element bound on |dx - dx_p| described at DX_TERMS_RTOL;
    0 where p is 0 (a -inf logit), so dx must be exactly 0 there."""
    BK, D, H, W = x.shape
    m, s = st[:, 0, None, None, None], st[:, 1, None, None, None]
    p = torch.exp(x.float() - m) / s

    def terms(axis, dim, shape):
        idx = torch.arange(dim, dtype=torch.float32, device=x.device)
        return ((g[:, axis, None] / dim) * (idx[None] - e[:, axis, None])
                ).abs().reshape(shape)

    T = (terms(0, W, (BK, 1, 1, W)) + terms(1, H, (BK, 1, H, 1))
         + terms(2, D, (BK, D, 1, 1)))
    return (DX_TERMS_RTOL * p * T
            + DX_ROUND_RTOL[x.dtype] * dx_p.float().abs())


def compare_dx(x, e, st, g, dx, dx_p, label: str) -> dict:
    """Hold dx against dx_p element by element and in L2; raises if they
    disagree, else returns the errors."""
    if dx.dtype != x.dtype or not bool(torch.isfinite(dx).all()):
        raise AssertionError(f"{label}: dtype {dx.dtype} or non-finite "
                             f"values")
    err = (dx.float() - dx_p.float()).abs()
    tol = dx_tolerance(x, e, st, g, dx_p)
    over = torch.where(tol > 0, err / tol,
                       torch.where(err > 0, float("inf"), 0.0))
    l2_tol = max(DX_TERMS_RTOL, DX_ROUND_RTOL[x.dtype])
    out = dict(max_abs_err=float(err.max()),
               max_err_over_tol=float(over.max()),
               n_over_tol=int((over > 1).sum()),
               l2_rel_err=float(torch.linalg.vector_norm(err)
                                / torch.linalg.vector_norm(dx_p.float())),
               max_abs_dx=float(dx_p.float().abs().max()),
               tol_terms_rtol=DX_TERMS_RTOL,
               tol_round_rtol=DX_ROUND_RTOL[x.dtype], tol_l2_rel=l2_tol)
    if not (out["max_err_over_tol"] <= 1.0 and out["l2_rel_err"] <= l2_tol):
        raise AssertionError(f"{label}: {out}")
    return out


def check_soft_argmax_bwd(device, cases, reps: int, card: str = ""):
    """The backward kernel against its plain version on the same (x, E,
    (m, s), g), case (shape, dtype, kind) with kind as in `sam_logits`.
    Returns one row per case."""
    from horopose_tpu_torch.ops.integral import soft_argmax_3d_bwd_plain
    from horopose_tpu_torch.ops.integral_cuda import (soft_argmax_3d_bwd,
                                                      soft_argmax_3d_fwd)
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    rows = []
    for shape, dtype, kind in cases:
        B, K, D, H, W = shape
        x = sam_logits(shape, dtype, kind, gen, device)
        g = torch.randn(B * K, 3, generator=gen, device=device)
        _, e, st = soft_argmax_3d_fwd(x)
        dx = soft_argmax_3d_bwd(x, e, st, g)
        dx_p = soft_argmax_3d_bwd_plain(x, e, st, g)
        torch.cuda.synchronize()
        errs = compare_dx(x, e, st, g, dx, dx_p,
                          f"soft_argmax_3d_bwd {shape} {dtype} {kind}")
        bound, bound_by = soft_argmax_bwd_bound_ms(x)

        def make(n):
            xs = sam_logits((n * B, *shape[1:]), dtype, kind, gen, device)
            _, es, sts = soft_argmax_3d_fwd(xs)
            gs = torch.randn(n * x.shape[0], 3, generator=gen, device=device)
            return xs, es, sts, gs

        ring = ring_of(x, make)
        t = timings(lambda a: soft_argmax_3d_bwd(*a), ring, reps)
        del ring
        row = dict(shape=list(shape), dtype=str(dtype).split(".")[-1],
                   kind=kind, **errs, **t,
                   plain_ms=time_ms(
                       lambda: soft_argmax_3d_bwd_plain(x, e, st, g), reps),
                   bound_ms=bound, bound_by=bound_by,
                   bound_share=bound / t["device_ms"])
        rows.append(row)
        print("soft_argmax_3d_bwd", json.dumps(row), f"({card})", flush=True)
        del x, g, e, st, dx, dx_p
    return rows


def compare_conv(y, y_plain, y_lib, label: str) -> dict:
    """Hold the conv kernel's y against the plain version's element by
    element (CONV_F32_REL, CONV_ROUND_RTOL) and against cuDNN's as max
    |dy| / max |y| (CONV_LIB_REL); raises if they disagree, else returns
    the errors."""
    if (y.dtype != y_plain.dtype or y.shape != y_plain.shape
            or not bool(torch.isfinite(y).all())):
        raise AssertionError(f"{label}: {y.dtype} {tuple(y.shape)} against "
                             f"{y_plain.dtype} {tuple(y_plain.shape)}, or "
                             f"non-finite values")
    yp = y_plain.float()
    y_max = float(yp.abs().max())
    err = (y.float() - yp).abs()
    tol = CONV_ROUND_RTOL[y.dtype] * yp.abs() + CONV_F32_REL * y_max
    lib_rel = float((y.float() - y_lib.float()).abs().max()
                    / max(float(y_lib.float().abs().max()), 1e-6))
    out = dict(max_abs_err=float(err.max()), max_abs_y=y_max,
               max_err_over_tol=float((err / tol).max()),
               n_over_tol=int((err > tol).sum()), library_rel_err=lib_rel,
               tol_rel_max=CONV_F32_REL,
               tol_round_rtol=CONV_ROUND_RTOL[y.dtype],
               tol_library_rel=CONV_LIB_REL[y.dtype])
    if not (out["n_over_tol"] == 0 and lib_rel <= CONV_LIB_REL[y.dtype]):
        raise AssertionError(f"{label}: {out}")
    return out


def check_conv(device, cases, reps: int, card: str = ""):
    """The conv kernel against its plain version and cuDNN on the same x
    and w, TF32 off, both timed on the device alone over a ring of inputs
    larger than twice the L2 cache; returns one row per case."""
    from horopose_tpu_torch.ops.conv3x3 import conv3x3_s2d_plain
    from horopose_tpu_torch.ops.conv3x3_cuda import conv3x3_nhwc
    from horopose_tpu_torch.tools.bench_conv import bound_ms, library_conv
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    rows = []
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for shape, dtype in cases:
            B, H, W, C, Fo = shape
            x = torch.randn(B, H, W, C, generator=gen, device=device).to(dtype)
            w = (0.1 * torch.randn(3, 3, C, Fo, generator=gen, device=device)
                 ).to(dtype)
            library = library_conv(w)
            y = conv3x3_nhwc(x, w)
            y_plain = conv3x3_s2d_plain(x, w)
            y_lib = library(x)
            torch.cuda.synchronize()
            errs = compare_conv(y, y_plain, y_lib, f"conv3x3 {shape} {dtype}")
            bound, bound_by = bound_ms(*shape, dtype)
            ring = ring_of(x, lambda n: torch.randn(
                n * B, H, W, C, generator=gen, device=device).to(dtype))
            t = timings(lambda a: conv3x3_nhwc(a, w), ring, reps)
            lib = timings(library, ring, reps)
            del ring
            row = dict(shape=list(shape), dtype=str(dtype).split(".")[-1],
                       **errs, **t,
                       plain_ms=time_ms(lambda: conv3x3_s2d_plain(x, w), reps),
                       library_ms=lib["ms"],
                       library_device_ms=lib["device_ms"],
                       bound_ms=bound, bound_by=bound_by,
                       bound_share=bound / t["device_ms"])
            rows.append(row)
            print("conv3x3_nhwc", json.dumps(row), f"({card})", flush=True)
            del x, w, y, y_plain, y_lib
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    return rows


def synthetic_requests(n: int, seed: int):
    """n synthetic 480x640 uint8 frames with DREAM-like intrinsics
    (RealSense) and robot-sized bboxes."""
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 256, (n, 480, 640, 3), dtype=np.uint8)
    K = np.tile(np.asarray([[615.52, 0.0, 328.26], [0.0, 615.22, 251.79],
                            [0.0, 0.0, 1.0]], np.float32)[None], (n, 1, 1))
    w = rng.uniform(150, 350, n)
    h = rng.uniform(200, 400, n)
    x0 = rng.uniform(0, 640 - w)
    y0 = rng.uniform(0, 480 - h)
    bboxes = np.stack([x0, y0, x0 + w, y0 + h], -1).astype(np.float32)
    return frames, K, bboxes


def check_outputs(out, B, dof, nkp):
    shapes = dict(joints=(B, dof), rotation=(B, 3, 3), translation=(B, 3),
                  root_depth=(B, 1), keypoints_3d=(B, nkp, 3),
                  keypoints_3d_integral=(B, nkp, 3), keypoints_2d=(B, nkp, 2))
    for key, shape in shapes.items():
        if out[key].shape != shape or not np.isfinite(out[key]).all():
            raise AssertionError(f"{key}: shape {out[key].shape} (want "
                                 f"{shape}) or non-finite values")


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-6))


def serve(predictors, batches, reps, card):
    """Answer requests through Predictor.__call__; returns the timings and
    the number of forwards run."""
    frames, K, bboxes = synthetic_requests(max(batches), SEED)
    forwards, timings = 0, {}
    for name, pred in predictors.items():
        dof, nkp = pred.model.dof, pred.model.num_keypoints
        for b in batches:
            times = []
            for _ in range(reps[b] + 1):          # the first is a warm-up
                t0 = time.perf_counter()
                out = pred(frames[:b], K[:b], bboxes[:b])  # ends on the host
                times.append(time.perf_counter() - t0)
                forwards += 1
                check_outputs(out, b, dof, nkp)
            ms = 1e3 * statistics.median(times[1:])
            timings[(name, b)] = ms
            print(f"serve {name} b={b}: {ms:.3f} ms/request, "
                  f"{1e3 * b / ms:.1f} img/s (median of {reps[b]}; {card})",
                  flush=True)
    return timings, forwards


def breakdown(pred, b: int, card: str, label: str = "") -> dict:
    """Where one request's time goes: host clock around preprocess and
    forward (each ending in a synchronise), and a torch.profiler trace of
    the same request for the device's busy time and its top kernels."""
    frames, K, bboxes = synthetic_requests(b, SEED + 2)
    sync = torch.cuda.synchronize
    for _ in range(2):                      # warm-up, then the timed run
        t0 = time.perf_counter()
        crops, crops_root, K_crops, k_values = pred.preprocess(frames, K,
                                                               bboxes)
        sync()
        t1 = time.perf_counter()
        pred.forward(crops, crops_root, k_values, K_crops)
        sync()
        t2 = time.perf_counter()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        inputs = pred.preprocess(frames, K, bboxes)
        pred.forward(inputs[0], inputs[1], inputs[3], inputs[2])
        sync()
    # device-side events only (kernels, copies): the host ops that launch
    # them carry the same time again
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    wall_ms = 1e3 * (t2 - t0)
    sam_ms = sum(e.self_device_time_total for e in events
                 if "soft_argmax" in e.key) / 1e3
    print(f"breakdown {label}{pred.model.dtype} b={b}: preprocess "
          f"{1e3 * (t1 - t0):.3f} ms, forward {1e3 * (t2 - t1):.3f} ms "
          f"(host clock); device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f}); soft_argmax kernel "
          f"{sam_ms:.3f} ms; {len(events)} distinct kernels ({card})")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5} "
              f"{e.key[:90]}")
    return dict(preprocess_ms=1e3 * (t1 - t0), forward_ms=1e3 * (t2 - t1),
                device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms)


def compare_forwards(pred, cpu_pred, keys=("uvd", "xyz_int", "xyz_fk"),
                     label: str = "") -> dict:
    """The same float32 forward three ways: with the kernel, with the plain
    soft-argmax (use_kernel=False), and on the CPU (2 of the 8 rows);
    returns the largest rel_err of each comparison over `keys`."""
    frames, K, bboxes = synthetic_requests(8, SEED + 1)
    crops, crops_root, K_crops, k_values = pred.preprocess(frames, K, bboxes)
    args = (crops, crops_root, k_values, K_crops)
    out_kernel = pred.forward(*args)
    pred.model.use_kernel = False
    try:
        out_plain = pred.forward(*args)
    finally:
        pred.model.use_kernel = None
    out_cpu = cpu_pred.forward(*[t[:2].cpu() for t in args])
    worst = dict(kernel_vs_plain=0.0, card_vs_cpu=0.0)
    for key in keys:
        same = rel_err(out_kernel[key], out_plain[key])
        cross = rel_err(out_kernel[key][:2], out_cpu[key])
        print(f"{label}f32 forward {key}: kernel vs plain rel_err "
              f"{same:.3e} (<= {SAME_DEVICE_REL}), card vs CPU rel_err "
              f"{cross:.3e} (<= {CROSS_DEVICE_REL})", flush=True)
        if not (same <= SAME_DEVICE_REL and cross <= CROSS_DEVICE_REL):
            raise AssertionError(f"{label}f32 forward {key} disagrees")
        worst = dict(kernel_vs_plain=max(worst["kernel_vs_plain"], same),
                     card_vs_cpu=max(worst["card_vs_cpu"], cross))
    return worst


def training_state_dict(model, cfg, robot, batch, seed: int):
    """Random weights from `seed` (random_state_dict), conditioned so that
    rounding is not amplified past the comparisons' bounds: the last
    BatchNorm scale of each residual branch times 0.1 (as torchvision's
    zero_init_residual damps it; at the usual ~0.5 train-mode BatchNorm
    explodes the gradients backwards through the depth of the net), and
    the root depth head set to predict about the batch's own root depths
    (a random one puts the FK keypoints near or behind the camera plane,
    where the 2-D projection losses are ill-conditioned)."""
    from horopose_tpu_torch.core.engine import prepare_gt
    return conditioned_state_dict(model, prepare_gt(cfg, robot, batch), seed)


def conditioned_state_dict(model, gts, seed: int):
    """`random_state_dict(model, seed)` with each residual branch's last
    BatchNorm scale damped x0.1 and `depth_layer` predicting about the
    mean root depth of the ground truth `gts` (FullNet or DepthNet)."""
    from horopose_tpu_torch.models.resnet import BasicBlock, Bottleneck
    from horopose_tpu_torch.pipelines.common import random_state_dict
    sd = random_state_dict(model, seed)
    for name, m in model.named_modules():
        if isinstance(m, (Bottleneck, BasicBlock)):
            last = "bn3" if isinstance(m, Bottleneck) else "bn2"
            sd[f"{name}.{last}.weight"] *= 0.1
    gamma = float((gts["gt_root_depth"][:, 0] * 1000.0
                   / gts["k_values"]).mean())
    sd["depth_layer.weight"] *= 1e-3
    sd["depth_layer.bias"].fill_(gamma)
    return sd


def make_train_step(cfg, sd, device, dtype=torch.float32, use_kernel=None):
    """A fresh model on `device` with weights `sd`, its optimizer, and the
    port's train step over them."""
    from horopose_tpu_torch.core.engine import (build_full_train_step,
                                                make_optimizer)
    from horopose_tpu_torch.pipelines.common import build_fullnet, make_robot
    model = build_fullnet(cfg, dtype=dtype)
    model.load_state_dict(sd)
    model.to(device).use_kernel = use_kernel
    opt, sched = make_optimizer(cfg, model.parameters(), STEPS_PER_EPOCH)
    return model, build_full_train_step(cfg, model,
                                        make_robot(cfg, device=device),
                                        opt, sched)


def train(cfg, sd, batch, device, card, warmup: int = 2, reps: int = 10,
          dtypes=(torch.float32, torch.bfloat16), label: str = ""):
    """Train steps through `build_full_train_step` in each of `dtypes`:
    timed on the host clock, each ending in a synchronise, then one traced
    step; every loss must be finite. Returns ({dtype name: ms per step},
    steps run, {dtype name: the traced step's device busy ms})."""
    timings, steps, busy = {}, 0, {}
    b = batch["TCO"].shape[0]
    for dtype in dtypes:
        name = str(dtype).split(".")[-1]
        model, step = make_train_step(cfg, sd, device, dtype)
        gen = torch.Generator(device=device).manual_seed(SEED)
        torch.cuda.reset_peak_memory_stats(device)
        times, logs = [], []
        for _ in range(warmup + reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logs.append(step(batch, gen))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            steps += 1
        losses = torch.stack([torch.stack(list(lg.values())) for lg in logs])
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"{label}train {name}: non-finite losses "
                                 f"{losses}")
        ms = 1e3 * statistics.median(times[warmup:])
        timings[name] = ms
        print(f"{label}train {name} b={b}: {ms:.3f} ms/step, "
              f"{1e3 * b / ms:.1f} img/s (median of {reps} after "
              f"{warmup} warm-up); loss {float(losses[0, 0]):.4f} -> "
              f"{float(losses[-1, 0]):.4f}; peak memory "
              f"{torch.cuda.max_memory_allocated(device) / 2 ** 30:.2f} GiB "
              f"({card})", flush=True)
        prof = train_breakdown(lambda: step(batch, gen),
                               f"{label}{name} b={b}", ms, card)
        busy[name] = sum(e.self_device_time_total
                         for e in device_events(prof)) / 1e3
        steps += 1
        del model, step, logs, losses
    return timings, steps, busy


def device_events(prof) -> list:
    """A trace's device-side events, without the user-annotated ranges
    (such as Optimizer.step) that span the kernels they launch."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")]


def train_breakdown(run_step, label: str, step_ms: float, card: str,
                    record_shapes: bool = False,
                    named=("soft_argmax_3d_fwd", "soft_argmax_3d_bwd")):
    """torch.profiler trace of one train step, `run_step()`: the device's
    busy time against the unprofiled median step time and against the
    profiled step's wall time, the top kernels and the `named` kernels.
    Returns the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts,
                                record_shapes=record_shapes) as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = device_events(prof)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3

    def kernel_ms(name):
        return sum(e.self_device_time_total for e in events
                   if name in e.key) / 1e3

    mine = "".join(f"{name} {kernel_ms(name):.3f} ms, " for name in named)
    print(f"train breakdown {label}: device busy {busy_ms:.3f} ms of a "
          f"{step_ms:.3f} ms step (idle share {1 - busy_ms / step_ms:.3f}; "
          f"{wall_ms:.3f} ms under the profiler); {mine}{len(events)} "
          f"distinct kernels ({card})", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5} "
              f"{e.key[:90]}")
    return prof


def _batch_to(batch: dict, device) -> dict:
    return {k: _batch_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in batch.items()}


def _grads(model):
    return {k: p.grad.detach().double().cpu()
            for k, p in model.named_parameters()}


def _cosine(a: dict, b: dict) -> float:
    va = torch.cat([a[k].flatten() for k in a])
    vb = torch.cat([b[k].flatten() for k in a])
    return float(va @ vb / (va.norm() * vb.norm()))


def _loss_rel(a: dict, b: dict) -> float:
    return max(abs(float(a[k]) - float(b[k])) / max(abs(float(b[k])), 1e-3)
               for k in b)


def compare_train_steps(cfg, sd, batch, device):
    """One float32 train step with the kernels (forward and backward)
    against the same step with the plain soft-argmax under autograd: same
    weights, batch and dropout seed. The gradient of final_layer, which
    only the soft-argmax backward feeds, shows the heatmap branch gets its
    gradient through the kernels."""
    out = {}
    for use_kernel in (None, False):
        model, step = make_train_step(cfg, sd, device, use_kernel=use_kernel)
        logs = step(batch, torch.Generator(device=device).manual_seed(SEED))
        out[use_kernel] = ({k: float(v) for k, v in logs.items()},
                           _grads(model))
        del model, step
    (lk, gk), (lp, gp) = out[None], out[False]
    loss_rel = _loss_rel(lk, lp)
    head_rel = rel_err(gk["final_layer.weight"], gp["final_layer.weight"])
    cos = _cosine(gk, gp)
    print(f"f32 train step b={batch['TCO'].shape[0]}: kernels vs plain "
          f"soft-argmax: "
          f"losses rel_err {loss_rel:.3e} (<= {STEP_LOSS_REL}), "
          f"final_layer.weight grad rel_err {head_rel:.3e} "
          f"(<= {HEAD_GRAD_REL}), |grad| {float(gk['final_layer.weight'].norm()):.4e},"
          f" gradient cosine {cos:.8f} (> {STEP_GRAD_COSINE})", flush=True)
    if not (loss_rel <= STEP_LOSS_REL and head_rel <= HEAD_GRAD_REL
            and cos > STEP_GRAD_COSINE
            and float(gk["final_layer.weight"].abs().max()) > 0):
        raise AssertionError("train step with the kernels disagrees with "
                             "the plain soft-argmax")


def compare_train_card_cpu(cfg, device, seed: int, label: str = "") -> dict:
    """One float32 train step at b=2 with dropout off on the card and on
    the CPU, same weights and batch; returns the loss rel_err and the
    gradient cosine."""
    from horopose_tpu_torch.data.synthetic import synthetic_dream_batch
    from horopose_tpu_torch.pipelines.common import (build_fullnet,
                                                     crop_sizes, make_robot)
    cfg = dataclasses.replace(cfg, p_dropout=0.0)
    root, size = crop_sizes(cfg)
    robot = make_robot(cfg, device="cpu")
    batch = synthetic_dream_batch(robot, 2, size, root, seed, device="cpu")
    sd = training_state_dict(build_fullnet(cfg), cfg, robot, batch, seed)
    out = []
    for dev in (device, torch.device("cpu")):
        model, step = make_train_step(cfg, sd, dev)
        logs = step(_batch_to(batch, dev), None)
        out.append(({k: float(v) for k, v in logs.items()}, _grads(model)))
        del model, step
    (card_logs, card_grads), (cpu_logs, cpu_grads) = out
    loss_rel = _loss_rel(card_logs, cpu_logs)
    cos = _cosine(card_grads, cpu_grads)
    print(f"{label}f32 train step b=2: card vs CPU: losses rel_err "
          f"{loss_rel:.3e} (<= {CROSS_LOSS_REL}), gradient cosine {cos:.8f} "
          f"(> {CROSS_GRAD_COSINE})", flush=True)
    if not (loss_rel <= CROSS_LOSS_REL and cos > CROSS_GRAD_COSINE):
        raise AssertionError(f"{label}train step on the card disagrees with "
                             f"the CPU")
    return dict(loss_rel_err=loss_rel, grad_cosine=cos)


class TimedLoader:
    """A sized loader around `source` (a list of batches or a loader)
    whose iteration synchronises the card and stamps the host clock before
    each request for a batch, the final one that ends the pass included,
    and records how long each request waited. With no prefetch the gaps
    are the consumer's step times; under `prefetch_to_device` of depth p
    the gap between requests k and k + 1 (k >= p) is one train step as the
    loop sees it: the wait for a batch, its copy and the step."""

    def __init__(self, source):
        self.source = source
        self.stamps, self.waits = [], []

    def __len__(self):
        return len(self.source)

    def __iter__(self):
        self.stamps, self.waits = [], []
        it = None
        while True:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.stamps.append(t0)
            try:
                if it is None:           # the epoch starts at its first request
                    it = iter(self.source)
                batch = next(it)
            except StopIteration:
                return
            self.waits.append(time.perf_counter() - t0)
            yield batch

    def step_ms(self):
        return [1e3 * (b - a) for a, b in zip(self.stamps, self.stamps[1:])]


def branch0_conv_ms(prof, b: int) -> dict:
    """cuDNN's share of a profiled step spent in hrnet32's 3x3 convs of
    branch 0's shape, stride 1, input (b, 32, 64, 64) and weight
    (32, 32, 3, 3): the 64 of branch 0's basic blocks and the one of the
    first feature-head bottleneck. The device time of each
    `aten::convolution` (forward) and `aten::convolution_backward` (data
    and weight gradients) with those shapes and stride, kernels of their
    children included, and their count. The stride-2 fuse convs out of
    branch 0 share the shapes and are left out by their stride."""
    act = [b, BRANCH0_CHANNELS, BRANCH0_HW, BRANCH0_HW]
    wt = [BRANCH0_CHANNELS, BRANCH0_CHANNELS, 3, 3]
    out = {"forward": [0.0, 0], "backward": [0.0, 0]}
    for e in prof.events():
        shapes = list(e.input_shapes or [])
        args = list(e.concrete_inputs or [])
        if (e.name == "aten::convolution" and shapes[:2] == [act, wt]
                and len(args) > 3 and list(args[3]) == [1, 1]):
            key = "forward"
        elif (e.name == "aten::convolution_backward"
              and shapes[:3] == [act, act, wt] and len(args) > 4
              and list(args[4]) == [1, 1]):
            key = "backward"
        else:
            continue
        out[key][0] += e.device_time_total / 1e3
        out[key][1] += 1
    return {k: dict(ms=v[0], count=v[1]) for k, v in out.items()}


def stage1(cfg, device, dtype, card: str, exp_root: str) -> dict:
    """One epoch of `train_depthnet` (STAGE1_STEPS steps on synthetic
    batches of the root crop, a validation of STAGE1_VAL_BATCHES), its
    scalars and checkpoint read back, the step time and a profiled step
    with the branch-0 conv rows. Returns the readings."""
    from horopose_tpu_torch.core.checkpoint import (TrainState,
                                                    load_checkpoint_file,
                                                    restore_state)
    from horopose_tpu_torch.core.engine import build_depthnet_train_step
    from horopose_tpu_torch.data.synthetic import synthetic_dream_batch
    from horopose_tpu_torch.kinematics.robot import Robot
    from horopose_tpu_torch.pipelines.train_depthnet import (CKPT_TEMPLATE,
                                                             build_rootnet,
                                                             train_depthnet)
    name = str(dtype).split(".")[-1]
    b, size = int(cfg.batch_size), int(cfg.image_size)
    robot = Robot(cfg.urdf_robot_name, device=device)
    loader = TimedLoader([synthetic_dream_batch(robot, b, size, size,
                                                SEED + 20 + i, device=device)
                          for i in range(STAGE1_STEPS)])
    val = [synthetic_dream_batch(robot, b, size, size, SEED + 40 + i,
                                 device=device)
           for i in range(STAGE1_VAL_BATCHES)]
    torch.cuda.reset_peak_memory_stats(device)
    state = train_depthnet(cfg, {"train": loader, "test": {"dr": val}},
                           max_epochs=1, device=device, dtype=dtype,
                           exp_root=exp_root)
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    times = loader.step_ms()
    ms = statistics.median(times[STAGE1_WARMUP:])

    folder = os.path.join(exp_root, cfg.exp_name)
    with open(os.path.join(folder, "log", "scalars.jsonl"),
              encoding="utf-8") as f:
        scalars = {r["tag"]: r["value"] for r in map(json.loads, f)}
    want = ("Train/loss_epoch", "Val/rootz_loss_dr", "Val/mean_depth_error_dr")
    if not all(np.isfinite(scalars.get(t, np.nan)) for t in want):
        raise AssertionError(f"stage 1 {name}: scalars {scalars}")
    ckpt = os.path.join(folder, "ckpt", CKPT_TEMPLATE.replace("_DATASET", ""))
    reloaded = build_rootnet(cfg, dtype)
    restore_state(TrainState(reloaded), load_checkpoint_file(ckpt))
    trained = state.model.state_dict()
    if any(not torch.equal(v, trained[k].cpu())
           for k, v in reloaded.state_dict().items()):
        raise AssertionError(f"stage 1 {name}: the reloaded checkpoint "
                             f"differs from the trained model")
    print(f"stage 1 {name} b={b}: {ms:.3f} ms/step, {1e3 * b / ms:.1f} "
          f"img/s (median of {len(times) - STAGE1_WARMUP} after "
          f"{STAGE1_WARMUP} warm-up; steps {[round(t, 1) for t in times]}); "
          f"peak memory {peak:.2f} GiB; scalars "
          f"{ {t: round(scalars[t], 5) for t in want} }; checkpoint "
          f"{os.path.basename(ckpt)} reloaded ({card})", flush=True)

    step = build_depthnet_train_step(cfg, state.model, state.optimizer,
                                     state.scheduler)
    prof = train_breakdown(lambda: step(loader.source[0]),
                           f"stage 1 {name} b={b}", ms, card,
                           record_shapes=True, named=())
    convs = branch0_conv_ms(prof, b)
    del state, step, prof, reloaded
    return dict(ms=ms, img_s=1e3 * b / ms, peak_gib=peak, ckpt=ckpt,
                branch0=convs)


def handoff(ckpt: str, device, card: str, n_steps: int = 2):
    """A stage-2 FullNet (`configs/panda/full.yaml`) started from the
    stage-1 checkpoint by `init_fullnet_state`, taking `n_steps` train steps
    at full width on a synthetic batch."""
    from horopose_tpu_torch.config import make_cfg
    from horopose_tpu_torch.core.checkpoint import load_checkpoint_file
    from horopose_tpu_torch.core.engine import (build_full_train_step,
                                                make_optimizer)
    from horopose_tpu_torch.data.synthetic import synthetic_dream_batch
    from horopose_tpu_torch.pipelines.common import (FullNetConfig,
                                                     build_fullnet,
                                                     crop_sizes, make_robot)
    from horopose_tpu_torch.pipelines.train_full import init_fullnet_state
    cfg = dataclasses.replace(FullNetConfig.from_cfg(make_cfg(STAGE2_CONFIG)),
                              pretrained_rootnet=ckpt)
    model = init_fullnet_state(cfg, build_fullnet(cfg))
    pre = load_checkpoint_file(ckpt)["model"]
    for src, dst in (("backbone.conv1.weight",
                      "rootnet_backbone.conv1.weight"),
                     ("depth_layer.weight", "depth_layer.weight")):
        if not torch.equal(pre[src], model.state_dict()[dst]):
            raise AssertionError(f"hand-off: {dst} is not the stage-1 {src}")
    model.to(device)
    robot = make_robot(cfg, device=device)
    root, size = crop_sizes(cfg)
    batch = synthetic_dream_batch(robot, cfg.batch_size, size, root,
                                  SEED + 50, device=device)
    opt, sched = make_optimizer(cfg, model.parameters(), STEPS_PER_EPOCH)
    step = build_full_train_step(cfg, model, robot, opt, sched)
    gen = torch.Generator(device=device).manual_seed(SEED)
    losses = [float(step(batch, gen)["loss"]) for _ in range(n_steps)]
    if not np.isfinite(losses).all():
        raise AssertionError(f"hand-off: stage-2 losses {losses}")
    print(f"hand-off: stage-2 FullNet from {os.path.basename(ckpt)}, "
          f"{n_steps} steps at b={cfg.batch_size}, loss {losses} ({card})",
          flush=True)
    del model, step, opt


def compare_depthnet_card_cpu(cfg, device, seed: int):
    """One float32 DepthNet train step at b=2 on the card and on the CPU,
    same conditioned weights and batch."""
    from horopose_tpu_torch.core.engine import (build_depthnet_train_step,
                                                make_optimizer,
                                                prepare_depth_gt)
    from horopose_tpu_torch.data.synthetic import synthetic_dream_batch
    from horopose_tpu_torch.kinematics.robot import Robot
    from horopose_tpu_torch.pipelines.train_depthnet import build_rootnet
    size = int(cfg.image_size)
    batch = synthetic_dream_batch(Robot(cfg.urdf_robot_name, device="cpu"),
                                  2, size, size, seed, device="cpu")
    sd = conditioned_state_dict(build_rootnet(cfg),
                                prepare_depth_gt(cfg, batch), seed)
    out = []
    for dev in (device, torch.device("cpu")):
        model = build_rootnet(cfg)
        model.load_state_dict(sd)
        model.to(dev)
        opt, sched = make_optimizer(cfg, model.parameters(), 1)
        logs = build_depthnet_train_step(cfg, model, opt, sched)(
            _batch_to(batch, dev))
        out.append(({k: float(v) for k, v in logs.items()}, _grads(model)))
        del model, opt
    (card_logs, card_grads), (cpu_logs, cpu_grads) = out
    loss_rel = _loss_rel(card_logs, cpu_logs)
    cos = _cosine(card_grads, cpu_grads)
    print(f"f32 DepthNet step b=2: card vs CPU: loss rel_err {loss_rel:.3e} "
          f"(<= {CROSS_LOSS_REL}), gradient cosine {cos:.8f} "
          f"(> {CROSS_GRAD_COSINE})", flush=True)
    if not (loss_rel <= CROSS_LOSS_REL and cos > CROSS_GRAD_COSINE):
        raise AssertionError("DepthNet step on the card disagrees with the "
                             "CPU")


def write_dream_sets(base: str, card: str):
    """The port's DREAM writer: panda train and test sets of 480x640 noise
    JPEGs (quality 85) under base/synthetic/."""
    from horopose_tpu_torch.tools.synth_dream import \
        make_synthetic_dream_dataset
    t0 = time.perf_counter()
    train = make_synthetic_dream_dataset(base, "panda", STAGE2_TRAIN_FRAMES,
                                         seed=SEED + 60, split="train_dr")
    test = make_synthetic_dream_dataset(base, "panda", STAGE2_TEST_FRAMES,
                                        seed=SEED + 61, split="test_dr")
    mb = sum(os.path.getsize(os.path.join(d, f)) for d in (train, test)
             for f in os.listdir(d)) / 2 ** 20
    print(f"stage 2 from files: wrote {STAGE2_TRAIN_FRAMES} + "
          f"{STAGE2_TEST_FRAMES} frames ({mb:.1f} MiB) in "
          f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
    return str(train), str(test)


def time_loader(loader, card: str, epochs: int = 2) -> dict:
    """`epochs` passes over `loader` alone, host clock; the last one (its
    workers started by the first) is reported: images per second and ms
    per batch over the whole pass, and each batch's arrival. Each worker
    makes whole batches, so with as many batches as workers an epoch's
    batches arrive together: the pass's rate, not the gaps, is the
    loader's throughput."""
    for _ in range(epochs):
        stamps, rows = [time.perf_counter()], 0
        for batch in loader:
            stamps.append(time.perf_counter())
            rows += int(batch["TCO"].shape[0])
    wall_ms = 1e3 * (stamps[-1] - stamps[0])
    gaps = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    out = dict(img_s=1e3 * rows / wall_ms, ms_per_batch=wall_ms / len(gaps),
               batch_gaps_ms=gaps, images=rows, workers=loader.num_workers)
    print(f"loader alone (pass {epochs}, workers started): {rows} images "
          f"in {wall_ms:.1f} ms, {out['img_s']:.1f} img/s, "
          f"{out['ms_per_batch']:.1f} ms per batch of {loader.batch_size}; "
          f"arrival gaps {[round(g, 1) for g in gaps]} ms; "
          f"{loader.num_workers} worker processes, host clock ({card})",
          flush=True)
    return out


def h2d_ms(batch, device, reps: int = 5) -> tuple:
    """(median ms, bytes) of one pinned batch's copy to the card on a side
    stream, non_blocking, between CUDA events on that stream."""
    from horopose_tpu_torch.parallel.prefetch import batch_tensors, to_device
    tensors = batch_tensors(batch)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    if not all(t.is_pinned() for t in tensors):
        raise AssertionError("the loader's batch is not pinned")
    side = torch.cuda.Stream(device)
    times = []
    for _ in range(reps + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side):
            start.record(side)
            staged = to_device(batch, device, non_blocking=True)
            end.record(side)
        end.synchronize()
        times.append(start.elapsed_time(end))
        del staged
    return statistics.median(times[1:]), nbytes


def stage2_train(cfg, loaders, device, card: str, exp_root: str) -> dict:
    """`train_full` for one epoch from the files (the caller resets the
    launch counts around it): the step time with the loader and the
    prefetch from TimedLoader, the host's wait per step, the scalars,
    and the keeper's decision against the logged ADD AUC."""
    from horopose_tpu_torch.pipelines.train_full import train_full
    timed = TimedLoader(loaders["train"])
    val = TimedLoader(loaders["test"]["dr"])
    t0 = time.perf_counter()
    state = train_full(cfg, {"train": timed, "test": {"dr": val}},
                       max_epochs=1, device=device, exp_root=exp_root)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    ahead = int(cfg.prefetch_batches)
    steps = timed.step_ms()[ahead:]      # gap k >= ahead holds step k - ahead
    waits = [1e3 * w for w in timed.waits]
    # the validation's first request synchronises after the last step: the
    # train loop's wall time, the epoch's first wait for batches included
    loop_ms = 1e3 * (val.stamps[0] - timed.stamps[0])
    n_steps = len(timed)
    folder = os.path.join(exp_root, cfg.exp_name)
    with open(os.path.join(folder, "log", "scalars.jsonl"),
              encoding="utf-8") as f:
        scalars = {r["tag"]: r["value"] for r in map(json.loads, f)}
    if len(scalars) < 54 or not all(np.isfinite(v)
                                    for v in scalars.values()):
        raise AssertionError(f"stage 2 from files: scalars {scalars}")
    auc = scalars["Val/AUC_ADD_dr"]
    ckpt = os.path.join(folder, "ckpt", "curr_best_auc(add)_model.pk")
    if os.path.exists(ckpt) != (auc > 0.0):
        raise AssertionError(f"the best-AUC keeper's decision: ADD AUC "
                             f"{auc}, checkpoint on disk "
                             f"{os.path.exists(ckpt)}")
    ms = statistics.median(steps[1:])
    print(f"stage 2 from files, float32 b={cfg.batch_size}: {ms:.3f} "
          f"ms/step with the loader and the prefetch ({ahead} ahead), "
          f"{1e3 * cfg.batch_size / ms:.1f} img/s (median of "
          f"{len(steps) - 1} after the first; steps "
          f"{[round(t, 1) for t in steps]}); the host waited "
          f"{statistics.median(waits[1:]):.3f} ms per request for a batch "
          f"after the first, which waited {waits[0]:.1f} ms (median; "
          f"{[round(w, 1) for w in waits]}); the train loop took "
          f"{loop_ms:.1f} ms, {loop_ms / n_steps:.3f} ms per step, "
          f"{1e3 * n_steps * cfg.batch_size / loop_ms:.1f} img/s; epoch with "
          f"its validation {epoch_s:.1f} s; {len(scalars)} scalars, "
          f"Val/AUC_ADD_dr {auc}, Val/AUC_PCK_dr "
          f"{scalars['Val/AUC_PCK_dr']}; best-AUC checkpoint "
          f"{'written' if auc > 0 else 'not written (AUC 0)'} ({card})",
          flush=True)
    return dict(state=state, step_ms=ms, steps_ms=steps, wait_ms=waits,
                loop_ms_per_step=loop_ms / n_steps, epoch_s=epoch_s, auc=auc,
                ckpt=ckpt, folder=folder)


def stage2_measure(cfg, run, loaders, device, card: str,
                   synthetic_ms: float) -> dict:
    """After the epoch: one pinned batch's copy to the card, one profiled
    train step on a loader batch against the step time with the loader
    (its device idle share), and a timed validation of the test set."""
    from horopose_tpu_torch.core.engine import (build_full_eval_step,
                                                build_full_train_step)
    from horopose_tpu_torch.core.loggers import NullWriter
    from horopose_tpu_torch.parallel.prefetch import (prefetch_to_device,
                                                      to_device)
    from horopose_tpu_torch.pipelines.common import FullNetConfig, make_robot
    from horopose_tpu_torch.pipelines.train_full import validate_full
    fcfg = FullNetConfig.from_cfg(cfg)
    state, robot = run["state"], make_robot(fcfg, device=device)
    host = next(iter(loaders["train"]))
    copy_ms, nbytes = h2d_ms(host, device)
    print(f"H2D of one pinned b={cfg.batch_size} batch on a side stream: "
          f"{copy_ms:.3f} ms for {nbytes / 2 ** 20:.1f} MiB, "
          f"{nbytes / copy_ms / 1e6:.2f} GB/s ({card})", flush=True)
    batch = to_device(host, device)
    step = build_full_train_step(fcfg, state.model, robot, state.optimizer,
                                 state.scheduler)
    gen = torch.Generator(device=device).manual_seed(SEED)
    step(batch, gen)
    prof = train_breakdown(lambda: step(batch, gen),
                           f"stage 2 from files float32 b={cfg.batch_size}",
                           run["step_ms"], card)
    busy_ms = sum(e.self_device_time_total
                  for e in device_events(prof)) / 1e3
    print(f"stage 2 step at b={cfg.batch_size}, float32: "
          f"{run['step_ms']:.3f} ms from files (loader, prefetch, copy; "
          f"{run['loop_ms_per_step']:.3f} ms over the whole loop) against "
          f"{synthetic_ms:.3f} ms on a batch already on the card (phase 5, "
          f"same call) ({card})", flush=True)
    eval_step = build_full_eval_step(fcfg, state.model, robot)
    test_loader = loaders["test"]["dr"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    validate_full(fcfg, robot, eval_step,
                  prefetch_to_device(test_loader, device,
                                     int(cfg.prefetch_batches)),
                  NullWriter(), 0, "dr")
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    print(f"validation of {STAGE2_TEST_FRAMES} frames at "
          f"b={test_loader.batch_size} ({len(test_loader)} batches, the "
          f"last partial): {val_s:.3f} s, {STAGE2_TEST_FRAMES / val_s:.1f} "
          f"img/s, loader and metrics included ({card})", flush=True)
    return dict(step_ms=run["step_ms"],
                loop_ms_per_step=run["loop_ms_per_step"],
                first_wait_ms=run["wait_ms"][0],
                wait_ms=statistics.median(run["wait_ms"][1:]),
                synthetic_step_ms=synthetic_ms, device_busy_ms=busy_ms,
                idle_share=1 - busy_ms / run["step_ms"], h2d_ms=copy_ms,
                h2d_bytes=nbytes, val_img_s=STAGE2_TEST_FRAMES / val_s)


SUMMARY_NUMBERS = ("ADD/AUC", "PCK/AUC", "Runtime of rootnet",
                   "Runtime of regression+integral", "Runtime of all", "FPS")


def stage2_test(run, test_dir: str, device, card: str) -> dict:
    """`test_network` at b=TEST_BATCH on the test set (128 + 22 padded)
    from the trained weights, written as a weights-only checkpoint; its
    summary.txt must hold every field."""
    from horopose_tpu_torch.core.checkpoint import (TrainState,
                                                    save_checkpoint_file)
    from horopose_tpu_torch.pipelines import test as harness
    weights = os.path.join(run["folder"], "ckpt", "trained_weights.pk")
    save_checkpoint_file(weights, epoch=0, metric=run["auc"],
                         state=TrainState(run["state"].model))
    cfg = harness.make_test_cfg(run["folder"], test_dir)
    t0 = time.perf_counter()
    harness.test_network(cfg, ckpt_name=weights, batch_size=TEST_BATCH,
                         device=device)
    wall_s = time.perf_counter() - t0
    with open(os.path.join(run["folder"], "result", "summary.txt"),
              encoding="utf-8") as f:
        lines = f.read().rstrip("\n").split("\n")
    dof = 8
    fields = dict(line.split(": ", 1) for line in lines if ": " in line)
    if (len(lines) != 15 + 8 + 8 + dof + 8
            or lines[2] != "This model was saved from epoch:0"
            or not all(np.isfinite(float(fields[k]))
                       for k in SUMMARY_NUMBERS)
            or float(fields["Runtime of all"]) <= 0):
        raise AssertionError(f"summary.txt: {lines}")
    print(f"test_network b={TEST_BATCH}: {STAGE2_TEST_FRAMES} frames in "
          f"{wall_s:.1f} s (model build, loader start, metrics and forward "
          f"timing included); summary.txt {len(lines)} lines: "
          + ", ".join(f"{k} {fields[k]}" for k in SUMMARY_NUMBERS)
          + f" (s per image; {card})", flush=True)
    return {k: float(fields[k]) for k in SUMMARY_NUMBERS}


STAGE3_CONFIG = os.path.join("configs", "panda", "self_supervised",
                             "azure.yaml")
# phase 10: a real-named set of 480x640 noise JPEGs; one epoch of 4 steps
# at the config's b=32, validated on the set itself (4 batches)
STAGE3_FRAMES, STAGE3_STEPS, STAGE3_WARMUP = 128, 6, 2
S2R_LOSS_REL, S2R_GRAD_COSINE = 1e-3, 0.9999   # b=2 step, card vs CPU
PNP_CROSS_ATOL = 1e-4                         # R, card vs CPU


def held_device_ms(fn, hold_s: float = 0.5) -> tuple:
    """(device ms of fn()'s work, its result), timed between CUDA events
    queued behind a sleep kernel that holds the stream for hold_s while
    the host enqueues the work: from the sleep's end the device runs it
    back to back for as long as the host stays ahead (a full launch queue
    blocks the host, not the device), so the time leaves out host stalls."""
    torch.cuda.synchronize()
    torch.cuda._sleep(int(hold_s * 2e9))       # cycles at about 2 GHz
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def profile_device(fn) -> tuple:
    """({device activity name: [ms, count]}, fn()'s result) of one fn()
    traced on the device alone. The times are read from the raw kineto
    events: the profiler's own event list takes minutes to build for the
    ~20,000 kernels of a stage-3 step."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    times = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation()):
            row = times.setdefault(e.name(), [0.0, 0])
            row[0] += e.duration_ns() / 1e6
            row[1] += 1
    return times, out


def collect_garbage(label: str, card: str):
    """A full garbage collection, timed, so that none lands inside a
    timed region. Until the loader's reference cycle was broken the
    port's loaders were freed in one, and each of their worker processes
    then took torch's 5 s join timeout to stop; now `close_loaders` stops
    them first and the collection finds little."""
    t0 = time.perf_counter()
    gc.collect()
    print(f"gc.collect {label}: {time.perf_counter() - t0:.2f} s ({card})",
          flush=True)


# a loader's close() must not sit out torch's 5 s join timeout per worker
CLOSE_S_MAX = 5.0


def close_loaders(loaders: dict, label: str, card: str) -> dict:
    """close() each loader of `loaders` (get_dataloaders' layout), timed:
    each sends its workers their stop sentinel and joins them."""
    flat = {"train": loaders["train"],
            **{f"test/{k}": v for k, v in loaders["test"].items()}}
    out = {}
    for name, loader in flat.items():
        t0 = time.perf_counter()
        loader.close()
        out[name] = time.perf_counter() - t0
        print(f"{label}: {name} loader close() {out[name]:.3f} s "
              f"({loader.num_workers} workers; {card})", flush=True)
        if out[name] > CLOSE_S_MAX:
            raise AssertionError(f"{label}: closing the {name} loader took "
                                 f"{out[name]:.1f} s")
    return out


def _rows(batch: dict, n: int) -> dict:
    return {k: _rows(v, n) if isinstance(v, dict) else v[:n]
            for k, v in batch.items()}


def stage3_setup(tmp: str, stage2_ckpt: str, device, card: str):
    """The real-named set, the azure config as read with the phase's four
    changes, its loaders (the train set carrying the full frames) and the
    random teacher."""
    from horopose_tpu_torch.config import make_cfg
    from horopose_tpu_torch.pipelines.common import get_dataloaders
    from horopose_tpu_torch.pipelines.train_sim2real import load_seg_teacher
    from horopose_tpu_torch.tools.synth_dream import \
        make_synthetic_dream_dataset
    t0 = time.perf_counter()
    real = make_synthetic_dream_dataset(tmp, "panda", STAGE3_FRAMES,
                                        seed=SEED + 70, synthetic=False,
                                        split="azure")
    print(f"stage 3: wrote {STAGE3_FRAMES} frames of {real} in "
          f"{time.perf_counter() - t0:.1f} s ({card})", flush=True)
    cfg = make_cfg(STAGE3_CONFIG)
    cfg.train_ds_names = str(real)
    cfg.allow_random_teacher = True
    cfg.pretrained_weight_on_synth = stage2_ckpt
    cfg.epoch_size = STAGE3_FRAMES
    loaders = get_dataloaders(cfg, device)
    loaders["train"].dataset.return_original_image = True
    teacher = load_seg_teacher(cfg, device=device)
    print(f"stage 3: {STAGE3_CONFIG} read by make_cfg, "
          f"{cfg.backbone_name} + {cfg.rootnet_backbone_name}, "
          f"{int(cfg.image_size)}^2 crops, b={cfg.batch_size}, lr {cfg.lr}, "
          f"mask loss {cfg.mask_loss_func} x{cfg.mask_loss_weight}, IoU "
          f"x{cfg.iou_loss_weight}, scale x{cfg.scale_loss_weight}, align "
          f"x{cfg.align_3d_loss_weight}, raster_faces_per_tile "
          f"{cfg.raster_faces_per_tile}, teacher at {teacher.out_hw}; changed: "
          f"train_ds_names, allow_random_teacher, pretrained_weight_on_synth "
          f"(phase 9's checkpoint), epoch_size {STAGE3_FRAMES} "
          f"({len(loaders['train'])} steps); float32 with "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    return cfg, loaders, teacher


def stage3_train(cfg, loaders, teacher, device, card: str,
                 exp_root: str) -> dict:
    """`train_sim2real` for one epoch (the caller resets the launch counts
    around it): the tracked-view pass, the steps, the validation with PnP,
    the tracked renders; its scalars must be finite."""
    from horopose_tpu_torch.pipelines.train_sim2real import train_sim2real
    t0 = time.perf_counter()
    state = train_sim2real(cfg, loaders, max_epochs=1, seg_teacher=teacher,
                           device=device, exp_root=exp_root)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    folder = os.path.join(exp_root, cfg.exp_name)
    with open(os.path.join(folder, "log", "scalars.jsonl"),
              encoding="utf-8") as f:
        scalars = {r["tag"]: r["value"] for r in map(json.loads, f)}
    tracked = [n for n in os.listdir(os.path.join(folder, "track"))
               if n.endswith(".jpg")]
    if (not all(np.isfinite(v) for v in scalars.values())
            or "Val/AUC_ADD_azure" not in scalars or not tracked):
        raise AssertionError(f"stage 3: scalars {scalars}, tracked views "
                             f"{tracked}")
    print(f"stage 3 epoch ({len(loaders['train'])} steps, the tracked-view "
          f"pass and a validation with PnP): {epoch_s:.1f} s; "
          + ", ".join(f"{t} {scalars[t]:.5g}" for t in (
              "Train/loss", "Train/loss_iou", "Train/loss_error3d_align",
              "Train/cull_overflow", "Val/AUC_ADD_azure",
              "Val/rot_diff_azure"))
          + f"; {len(tracked)} tracked views written ({card})", flush=True)
    return dict(state=state, epoch_s=epoch_s, n_tracked=len(tracked))


def stage3_measure(cfg, run, loaders, teacher, device, card: str,
                   lap=lambda part: None) -> dict:
    """After the epoch, on a loader batch on the card: the step time, its
    device busy, idle share and peak memory; the dense and tiled renders
    (forward and backward) at the step's shapes; the teacher; PnP of the
    batch's keypoints and which of its calls synchronise; a validation."""
    import warnings
    from horopose_tpu_torch.core.engine import build_full_eval_step
    from horopose_tpu_torch.core.loggers import NullWriter
    from horopose_tpu_torch.kinematics.meshes import build_robot_mesh
    from horopose_tpu_torch.ops.pnp import batch_project, pnp
    from horopose_tpu_torch.ops.rasterizer import (render_robot_silhouette,
                                                   resolve_faces_per_tile)
    from horopose_tpu_torch.ops.rotations import (rotmat_to_axis_angle,
                                                  rotmat_to_rot6d)
    from horopose_tpu_torch.parallel.prefetch import (prefetch_to_device,
                                                      to_device)
    from horopose_tpu_torch.pipelines.common import FullNetConfig, make_robot
    from horopose_tpu_torch.pipelines.train_full import validate_full
    from horopose_tpu_torch.pipelines import train_sim2real as S
    fcfg = FullNetConfig.from_cfg(cfg)
    state, robot = run["state"], make_robot(fcfg, device=device)
    mesh = build_robot_mesh(robot.model, {n: i for i, n in
                                          enumerate(robot.plan.link_names)})
    batch = to_device(next(iter(loaders["train"])), device)
    b = int(batch["TCO"].shape[0])
    out = {}

    # the step
    step = S.build_sim2real_train_step(cfg, state.model, robot, mesh, teacher,
                                       state.optimizer, state.scheduler)
    gen = torch.Generator(device=device).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats(device)
    times = []
    for _ in range(STAGE3_WARMUP + STAGE3_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = step(batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not all(bool(torch.isfinite(v)) for v in logs.values()):
        raise AssertionError(f"stage 3 step: {logs}")
    ms = 1e3 * statistics.median(times[STAGE3_WARMUP:])
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    print(f"stage 3 step f32 b={b}: {ms:.3f} ms/step, {1e3 * b / ms:.1f} "
          f"img/s (median of {STAGE3_STEPS} after {STAGE3_WARMUP} warm-up; "
          f"steps {[round(1e3 * t, 1) for t in times]}); peak memory "
          f"{peak:.2f} GiB; cull_overflow {float(logs['cull_overflow'])} "
          f"({card})", flush=True)
    out.update(step_ms=ms, peak_gib=peak)
    lap("10 step")

    # the renders at the step's shapes: the batch's own poses at root 0,
    # after a collection (one that landed in a timed dense render took
    # 91 s on an H100, the render 1.2 s on the device)
    collect_garbage("before the renders", card)
    out_hw = teacher.out_hw
    K = batch["K_original"].float() * (out_hw[0] / 480.0)
    K[:, 2, 2] = 1.0
    TCO = batch["TCO"].float()
    rot, trans = rotmat_to_rot6d(TCO[:, :3, :3]), TCO[:, :3, 3]
    pose = batch["jointpose"].float()
    for name, budget in (("dense", 0), ("tiled", resolve_faces_per_tile(
            cfg.raster_faces_per_tile, mesh.num_faces))):
        def render(budget=budget):
            r = rot.clone().requires_grad_()
            t = trans.clone().requires_grad_()
            alpha, ov = render_robot_silhouette(
                robot, mesh, pose, r, t, K, out_hw, root=0,
                faces_per_tile=budget, return_overflow=True)
            alpha.sum().backward()
            return alpha, ov
        r_ms = time_ms(render, reps=2)
        r_busy, (alpha, ov) = held_device_ms(render)
        out[f"raster_{name}"] = dict(ms=r_ms, device_busy_ms=r_busy,
                                     faces_per_tile=budget,
                                     overflow=float(ov),
                                     mean_alpha=float(alpha.detach().mean()))
        print(f"rasterizer {name} (faces_per_tile {budget}) forward + "
              f"backward at ({b}, {out_hw[0]}x{out_hw[1]}, {mesh.num_faces} "
              f"faces): {r_ms:.3f} ms (CUDA events, median of 2), "
              f"{r_busy:.3f} ms with the host ahead; overflow {float(ov)}, "
              f"mean alpha {float(alpha.detach().mean()):.4f} ({card})",
              flush=True)

    lap("10 renders")

    # the teacher
    images = batch["images_original"]
    with torch.no_grad():
        t_ms = time_ms(lambda: teacher(images), reps=5)
    out["teacher_ms"] = t_ms
    print(f"teacher forward b={b} ({images.shape[1]}x{images.shape[2]} -> "
          f"{out_hw[0]}x{out_hw[1]}): {t_ms:.3f} ms (median of 5) ({card})",
          flush=True)

    # PnP of the annotated keypoints against FK, as prepare_gt runs it
    pts2d = batch["keypoints_2d_original"].float()
    pts3d = robot.get_keypoints_only_fk(pose)
    K0 = batch["K_original"].float()
    with torch.no_grad():
        p_ms = time_ms(lambda: pnp(pts2d, pts3d, K0), reps=3)
        t0 = time.perf_counter()
        pnp(pts2d, pts3d, K0)
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                Rp, tp = pnp(pts2d, pts3d, K0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        syncs = sorted({f"{os.path.basename(w.filename)}:{w.lineno}"
                        for w in caught if "synchroniz" in str(w.message)})
        theta = torch.cat([rotmat_to_axis_angle(Rp), tp], -1)
        resid = float((batch_project(theta, pts3d, K0) - pts2d)
                      .norm(dim=-1).max())
        Rc, _ = pnp(pts2d.cpu(), pts3d.cpu(), K0.cpu())
    cross = float((Rp.cpu() - Rc).abs().max())
    out.update(pnp_ms=p_ms, pnp_host_ms=host_ms, pnp_max_residual_px=resid,
               pnp_syncs=syncs, pnp_card_vs_cpu_R=cross)
    print(f"PnP b={b} (N=7): {p_ms:.3f} ms (CUDA events, median of 3; "
          f"{host_ms:.3f} ms on the host clock); largest "
          f"reprojection residual {resid:.3e} px; synchronising calls "
          f"{syncs}; R card vs CPU max |dR| {cross:.3e} (<= "
          f"{PNP_CROSS_ATOL}) ({card})", flush=True)
    if not (cross <= PNP_CROSS_ATOL and resid < 1.0):
        raise AssertionError("PnP on the card disagrees with the CPU or "
                             "misses the keypoints")

    lap("10 teacher, PnP")

    # validation with PnP on the real set
    eval_loader = S._eval_loaders(cfg, {"test": {}}, device)["azure"]
    eval_step = build_full_eval_step(fcfg, state.model, robot,
                                     pnp_fn=pnp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    validate_full(fcfg, robot, eval_step,
                  prefetch_to_device(eval_loader, device,
                                     int(cfg.prefetch_batches)),
                  NullWriter(), 0, "azure")
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    out["val_img_s"] = STAGE3_FRAMES / val_s
    lap("10 validation")

    # the step's device busy from one traced step, last: on an H100, work
    # on the card after a trace of this many kernels ran slow until the
    # next trace started (a render's forward and backward took 47 s, not
    # 1.2 s), so an empty trace follows it
    times, _ = profile_device(lambda: step(batch, gen))
    profile_device(lambda: None)
    busy = sum(t for t, _ in times.values())
    mine = ", ".join(
        f"{name} {sum(t for k, (t, _) in times.items() if name in k):.3f} ms"
        for name in ("soft_argmax_3d_fwd", "soft_argmax_3d_bwd"))
    print(f"stage 3 step breakdown f32 b={b}: device busy {busy:.3f} ms of "
          f"a {ms:.3f} ms step (idle share {1 - busy / ms:.3f}); {mine}; "
          f"{len(times)} distinct kernels ({card})", flush=True)
    for name, (t, n) in sorted(times.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"  {t:9.3f} ms x{n:<5} {name[:90]}")
    out.update(device_busy_ms=busy, idle_share=1 - busy / ms)
    lap("10 step trace")
    print(f"stage 3 validation of {STAGE3_FRAMES} frames at b={b} with PnP: "
          f"{val_s:.3f} s, {out['val_img_s']:.1f} img/s, loader and metrics "
          f"included ({card})", flush=True)
    return out


def compare_sim2real_card_cpu(cfg, loaders, stage2_ckpt: str, device,
                              card: str):
    """One stage-3 step at b=2 on the card and on the CPU, TF32 off,
    dropout off: the phase-9 weights, the random teacher, the first two
    frames of the real set."""
    from horopose_tpu_torch.core.checkpoint import (load_checkpoint_file,
                                                    model_state_dict)
    from horopose_tpu_torch.core.engine import make_optimizer
    from horopose_tpu_torch.kinematics.meshes import build_robot_mesh
    from horopose_tpu_torch.models.deeplab import SegTeacher
    from horopose_tpu_torch.pipelines import train_sim2real as S
    from horopose_tpu_torch.pipelines.common import FullNetConfig, make_robot
    from horopose_tpu_torch.pipelines.train_full import seeded_fullnet
    fcfg = FullNetConfig.from_cfg(cfg)
    batch = _rows(next(iter(loaders["train"])), 2)
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    try:
        for dev in (device, torch.device("cpu")):
            model = seeded_fullnet(fcfg)
            model.load_state_dict(model_state_dict(
                load_checkpoint_file(stage2_ckpt), model))
            model.p_dropout = 0.0
            model.to(dev)
            robot = make_robot(fcfg, device=dev)
            mesh = build_robot_mesh(robot.model, {
                n: i for i, n in enumerate(robot.plan.link_names)})
            teacher = SegTeacher.init_random(0).to(dev)
            opt, sched = make_optimizer(fcfg, model.parameters(), 1)
            step = S.build_sim2real_train_step(cfg, model, robot, mesh,
                                               teacher, opt, sched)
            logs = step(_batch_to(batch, dev), None)
            out.append(({k: float(v) for k, v in logs.items()},
                        _grads(model)))
            del model, teacher, step
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    (card_logs, card_grads), (cpu_logs, cpu_grads) = out
    loss_rel = _loss_rel(card_logs, cpu_logs)
    cos = _cosine(card_grads, cpu_grads)
    print(f"stage 3 step f32 b=2: card vs CPU, TF32 off: losses rel_err "
          f"{loss_rel:.3e} (<= {S2R_LOSS_REL}), gradient cosine {cos:.8f} "
          f"(>= {S2R_GRAD_COSINE}); card {card_logs}, CPU {cpu_logs} "
          f"({card})", flush=True)
    if not (loss_rel <= S2R_LOSS_REL and cos >= S2R_GRAD_COSINE):
        raise AssertionError("stage 3 step on the card disagrees with the "
                             "CPU")
    return dict(loss_rel=loss_rel, grad_cosine=cos)


# phase 11: two variant FullNets at the flagship's full width (the flags
# no shipped config sets; models/full_net.py)
VARIANTS = {
    "V1": dict(add_fc=True, multi_kp=True, kps_need_depth=tuple(range(7)),
               reg_joint_map=True, joint_conv_dim=(256, 256, 256),
               rot_iterative_matmul=True),
    "V2": dict(direct_reg_rot=True, rotation_dim=4),
}
VARIANT_SERVE_REPS = {1: 10, 128: 3}
VARIANT_WARMUP, VARIANT_STEPS = 2, 5      # the b=64 step, float32


@contextlib.contextmanager
def tf32_off():
    """float32 convs and matmuls without TF32 inside, as phase 6 runs its
    comparisons; the previous settings after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def phase11_variant(name, base_cfg, flags, batch, device, card, flagship,
                    counts):
    """Serve variant `name` (`base_cfg` with `flags`) through Predictor at
    b=1 and 128, step it at the batch's size, and compare it with the
    CPU; `counts` resets and reads the launch counts around each path."""
    from horopose_tpu_torch.pipelines.common import (build_fullnet,
                                                     make_robot,
                                                     random_state_dict)
    from horopose_tpu_torch.predictor import Predictor
    reset, read = counts
    cfg = dataclasses.replace(base_cfg, **flags)
    print(f"{name}: panda FullNet {cfg.backbone_name} + "
          f"{cfg.rootnet_backbone_name}, {cfg.image_size}^2 crops, depth_dim "
          f"{cfg.depth_dim}, {flags}", flush=True)
    sd = random_state_dict(build_fullnet(cfg), SEED)
    pred = Predictor(cfg, sd, device=device)
    reset()
    timings, forwards = serve({f"{name} float32": pred},
                              tuple(VARIANT_SERVE_REPS), VARIANT_SERVE_REPS,
                              card)
    launches = read(f"{name} serving")
    if launches["soft_argmax_3d_fwd"] != forwards:
        raise AssertionError(f"{name}: {forwards} forwards launched "
                             f"{launches}")
    big = max(VARIANT_SERVE_REPS)
    out = {f"b{b}_ms": timings[(f"{name} float32", b)]
           for b in VARIANT_SERVE_REPS}
    out[f"b{big}_img_s"] = 1e3 * big / out[f"b{big}_ms"]
    out["breakdown"] = {f"b{b}": breakdown(pred, b, card, f"{name} ")
                        for b in VARIANT_SERVE_REPS}
    print(f"{name} float32: b=1 latency {out['b1_ms']:.3f} ms against the "
          f"flagship's {flagship[1]:.3f} ms; b={big} "
          f"{out[f'b{big}_img_s']:.1f} img/s against "
          f"{1e3 * big / flagship[big]:.1f} (phase 4; {card})", flush=True)

    robot = make_robot(cfg, device=device)
    train_sd = training_state_dict(build_fullnet(cfg), cfg, robot, batch,
                                   SEED)
    reset()
    ms, steps, busy = train(cfg, train_sd, batch, device, card,
                            VARIANT_WARMUP, VARIANT_STEPS, (torch.float32,),
                            label=f"{name} ")
    launches = read(f"{name} stage-2 training")
    out["train"] = dict(step_ms=ms["float32"],
                        device_busy_ms=busy["float32"],
                        idle_share=1 - busy["float32"] / ms["float32"])
    if not (launches["soft_argmax_3d_fwd"] == launches["soft_argmax_3d_bwd"]
            == steps):
        raise AssertionError(f"{name}: {steps} train steps launched "
                             f"{launches}")

    keys = ("pose", "rot", "trans", "depth", "uvd", "xyz_int", "xyz_fk") \
        + (("depths",) if cfg.multi_kp else ())
    with tf32_off():
        out["forward_card_vs_cpu"] = compare_forwards(
            pred, Predictor(cfg, sd, device="cpu"), keys, label=f"{name} ")
        if cfg.reg_joint_map:    # V1: the step too, as phase 6 does
            out["train_card_vs_cpu"] = compare_train_card_cpu(
                cfg, device, SEED + 8, label=f"{name} ")
    del pred
    return out


def phase11_harness(folder: str, weights: str, test_dir: str, tmp: str,
                    device, card: str) -> dict:
    """test_network on phase 9's test set with the plots and a profile,
    and one synthetic frame rendered by the shaded renderer."""
    from horopose_tpu_torch.pipelines import test as harness
    from horopose_tpu_torch.tools.synth_dream import \
        make_synthetic_dream_dataset
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    cfg = harness.make_test_cfg(folder, test_dir)
    cfg.profile_dir = os.path.join(tmp, "profile")
    result = os.path.join(folder, "result")
    before = set(os.listdir(result))
    t0 = time.perf_counter()
    harness.test_network(cfg, ckpt_name=weights, batch_size=TEST_BATCH,
                         visualization=True, device=device)
    wall_s = time.perf_counter() - t0
    written = {f: os.path.getsize(os.path.join(d, f))
               for d in (result, cfg.profile_dir) for f in os.listdir(d)
               if f not in before}
    print(f"test_network with --visualization and profile_dir: "
          f"{wall_s:.1f} s; wrote {written} (bytes); matplotlib "
          f"{'found' if has_mpl else 'missing: the plots are no-ops, not a failure'}"
          f" ({card})", flush=True)
    plots = {"vis_best_cases.jpg", "vis_worst_cases.jpg",
             f"add_distribution_curve_{os.path.basename(test_dir)}.jpg"}
    if "trace.json" not in written or (has_mpl and not plots <= set(written)):
        raise AssertionError(f"test_network wrote {sorted(written)}")

    t0 = time.perf_counter()
    d = make_synthetic_dream_dataset(os.path.join(tmp, "rendered"), "panda",
                                     n_images=1, seed=SEED + 9,
                                     render_images=True, view_mode="upright")
    render_s = time.perf_counter() - t0
    from PIL import Image
    img = np.asarray(Image.open(os.path.join(d, "000000.jpg")), np.float32)
    with open(os.path.join(d, "000000.json"), encoding="utf-8") as f:
        box = json.load(f)["objects"][0]["bounding_box"]
    roughness = float(np.abs(np.diff(img, axis=1)).mean())
    print(f"render_images=True: one 480x640 frame of the URDF's primitive "
          f"geometry in {render_s:.2f} s (host numpy); bbox {box}; mean "
          f"|horizontal step| {roughness:.2f} levels (noise frames ~85; "
          f"{card})", flush=True)
    if img.shape != (480, 640, 3) or roughness > 20:
        raise AssertionError("the rendered frame looks like noise")
    return dict(test_network_s=wall_s, files=written, matplotlib=has_mpl,
                render_s=render_s)


# phase 12: the weight files and the serving artifact, at the flagship's
# full width
URDF_FK_ATOL = 1e-6     # a user URDF with the built-in's joints, f32 FK
CONVERTED_REL = 1e-6    # the same weights read from another file
EXPORT_REL = 1e-5       # exported program vs eager forward, TF32 off
EXPORT_BATCH, EXPORT_REPS = 128, 5
TEACHER_BATCH = 32
USER_MESH_LINK = "panda_link3"
CKPT_NAME = "curr_best_auc(add)_model.pk"
ROOT = os.path.dirname(os.path.abspath(__file__))


def write_user_urdf(data_dir: str) -> str:
    """The built-in panda description written as a user's, at
    `<data_dir>/deps/panda-description/panda.urdf` (the path
    `config.URDF_PATHS` names for HOROPOSE_DATA_DIR=<data_dir>), with the
    visual of USER_MESH_LINK a `<mesh>` of an OBJ written beside it (a box
    of 8 vertices and 12 triangles). Returns the URDF's path."""
    from horopose_tpu_torch.kinematics.robot import BUILTIN_URDF
    folder = os.path.join(data_dir, "deps", "panda-description")
    os.makedirs(os.path.join(folder, "meshes"), exist_ok=True)
    with open(BUILTIN_URDF["panda"]) as f:
        text = f.read()
    start = text.index(f'<link name="{USER_MESH_LINK}">')
    g0 = text.index("<geometry>", start)
    g1 = text.index("</geometry>", g0) + len("</geometry>")
    text = (text[:g0] + '<geometry><mesh filename="meshes/link.obj"/>'
            '</geometry>' + text[g1:])
    corners = [(x, y, z) for x in (-0.05, 0.05) for y in (-0.05, 0.05)
               for z in (-0.1, 0.05)]
    quads = ((1, 2, 4, 3), (5, 7, 8, 6), (1, 5, 6, 2), (3, 4, 8, 7),
             (1, 3, 7, 5), (2, 6, 8, 4))
    lines = [f"v {x} {y} {z}" for x, y, z in corners]
    for a, b, c, d in quads:
        lines += [f"f {a} {b} {c}", f"f {a} {c} {d}"]
    with open(os.path.join(folder, "meshes", "link.obj"), "w") as f:
        f.write("\n".join(lines) + "\n")
    path = os.path.join(folder, "panda.urdf")
    with open(path, "w") as f:
        f.write(text)
    return path


@contextlib.contextmanager
def deterministic_convs():
    """`tf32_off`, and cuDNN's deterministic algorithms: its transposed
    convs may otherwise sum in another order from call to call, so two
    runs of the same weights agree only to rounding, which the near-zero
    uvd of random weights magnifies in a relative error (phase 12 prints
    it)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tf32_off():
            yield
    finally:
        torch.backends.cudnn.deterministic = saved


def phase12_urdf(cfg, device, card: str, tmp: str) -> dict:
    """`make_robot` with the user's URDF under the data directory: the
    path it read, the mesh `build_robot_mesh` builds from it, and its FK
    on the card against the built-in robot's."""
    from horopose_tpu_torch import config
    from horopose_tpu_torch import constants as C
    from horopose_tpu_torch.kinematics.meshes import build_robot_mesh
    from horopose_tpu_torch.kinematics.robot import Robot
    from horopose_tpu_torch.pipelines.common import make_robot
    path = write_user_urdf(tmp)
    saved = dict(config.URDF_PATHS)
    config.URDF_PATHS["panda"] = path
    try:
        robot = make_robot(cfg, device=device)
    finally:
        config.URDF_PATHS.update(saved)
    builtin = Robot(cfg.urdf_robot_name, device=device)
    meshes = [build_robot_mesh(r.model, {n: i for i, n in
                                         enumerate(r.plan.link_names)})
              for r in (robot, builtin)]
    rng = np.random.RandomState(SEED + 12)
    lo, hi = np.asarray(C.JOINT_BOUNDS["panda"], np.float32).T
    n = 256
    f32 = dict(dtype=torch.float32, device=device)
    q = torch.tensor(rng.uniform(lo, hi, (n, len(lo))), **f32)
    rot = torch.tensor(rng.randn(n, 6), **f32)
    trans = torch.tensor(rng.randn(n, 3) * 0.2 + [0.0, 0.0, 1.5], **f32)
    kp = [r.get_keypoints_root(q, rot, trans, root=cfg.reference_keypoint_id)
          for r in (robot, builtin)]
    poses = [r.plan.link_poses(q) for r in (robot, builtin)]
    fk_err = max(float((kp[0] - kp[1]).abs().max()),
                 float((poses[0] - poses[1]).abs().max()))
    print(f"phase 12 URDF: make_robot read {robot.urdf_path}; "
          f"build_robot_mesh: {meshes[0].num_faces} faces "
          f"({meshes[0].n_file_geoms} from mesh files, "
          f"{meshes[0].n_primitive_geoms} primitives), the built-in "
          f"{meshes[1].num_faces} ({meshes[1].n_file_geoms} from files); "
          f"FK on the card against the built-in robot over {n} poses: max "
          f"|d| {fk_err:.3e} (<= {URDF_FK_ATOL}) ({card})", flush=True)
    if robot.urdf_path != path or meshes[0].n_file_geoms != 1 \
            or meshes[0].missing_meshes or meshes[1].n_file_geoms != 0:
        raise AssertionError("make_robot did not build from the user URDF")
    if not fk_err <= URDF_FK_ATOL:
        raise AssertionError(f"user-URDF FK differs by {fk_err:.3e}")
    return dict(urdf_path=robot.urdf_path, faces=meshes[0].num_faces,
                builtin_faces=meshes[1].num_faces, fk_max_abs=fk_err)


def run_convert(args) -> float:
    """`python -m horopose_tpu_torch.tools.convert <args>` in a
    subprocess; returns its wall seconds."""
    import subprocess
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "horopose_tpu_torch.tools.convert", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    lines = done.stdout.strip().splitlines()
    print(f"  convert {args[0]}: rc {done.returncode} in {seconds:.1f} s: "
          f"{lines[0] if lines else ''} ... {lines[-1] if lines else ''}",
          flush=True)
    if done.returncode != 0:
        raise RuntimeError(f"convert {args[0]} failed:\n{done.stderr[-3000:]}")
    return seconds


def _same_tensors(got: dict, want: dict, what: str) -> int:
    """Raise unless `got` holds exactly `want`'s keys with bitwise equal
    tensors; returns the number of tensors."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: keys differ")
    for k, v in want.items():
        if not torch.equal(got[k].cpu(), v.cpu()):
            raise AssertionError(f"{what}: {k} differs")
    return len(want)


def phase12_convert(cfg, sd, seeded_pred, device, card: str, tmp: str
                    ) -> dict:
    """The flagship's seeded weights as a reference `.pk`, read raw and
    after `tools.convert fullnet` by `Predictor.from_experiment` (bitwise
    equal weights, b=128 outputs against the seeded Predictor's), and a
    reference-named CtRNet teacher converted by `tools.convert ctrnet_seg`
    and read by the stage-3 teacher loader (bitwise equal weights and
    masks). The comparisons run with TF32 off and cuDNN deterministic."""
    import shutil
    from horopose_tpu_torch.config import make_cfg
    from horopose_tpu_torch.models.deeplab import SegTeacher
    from horopose_tpu_torch.pipelines.train_sim2real import load_seg_teacher
    from horopose_tpu_torch.predictor import Predictor
    from horopose_tpu_torch.tools.torch_weights import ctrnet_seg_prefixes
    exps = {name: os.path.join(tmp, name) for name in ("reference .pk",
                                                        "converted")}
    for exp in exps.values():
        os.makedirs(os.path.join(exp, "ckpt"))
        shutil.copy(os.path.join(ROOT, STAGE2_CONFIG),
                    os.path.join(exp, "config.yaml"))
    src = os.path.join(exps["reference .pk"], "ckpt", CKPT_NAME)
    torch.save({"model_state_dict": sd, "epoch": 0, "auc_add": 0.0}, src)
    fullnet_s = run_convert([
        "fullnet", src, os.path.join(exps["converted"], "ckpt", CKPT_NAME),
        "--backbone", cfg.backbone_name, "--rootnet_backbone",
        cfg.rootnet_backbone_name, "--image_size", str(cfg.image_size)])
    frames, K, bboxes = synthetic_requests(EXPORT_BATCH, SEED + 12)
    with deterministic_convs():
        want = seeded_pred(frames, K, bboxes)
        errs = {}
        for name, exp in exps.items():
            pred = Predictor.from_experiment(exp, device=device)
            n = _same_tensors(pred.model.state_dict(), sd, name)
            out = pred(frames, K, bboxes)
            errs[name] = max(rel_err(torch.from_numpy(out[k]),
                                     torch.from_numpy(want[k])) for k in want)
            print(f"phase 12 convert: {name} through "
                  f"Predictor.from_experiment: {n} tensors bitwise equal to "
                  f"the seeded model's; b={EXPORT_BATCH} outputs rel_err "
                  f"{errs[name]:.3e} (<= {CONVERTED_REL}) ({card})",
                  flush=True)
            if not errs[name] <= CONVERTED_REL:
                raise AssertionError(f"{name}: outputs differ")
            del pred

    # the teacher: the seeded one's weights under the reference's names
    seeded = SegTeacher.init_random(SEED + 12)
    table = [(port, ref) for ref, port in ctrnet_seg_prefixes()]
    ref_sd = {}
    for key, value in seeded.model.state_dict().items():
        port, ref = next(p for p in table if key.startswith(p[0]))
        ref_sd[ref + key[len(port):]] = value
    src = os.path.join(tmp, "azure.pth")
    torch.save(ref_sd, src)
    folder = os.path.join(tmp, "models", "panda_segmentation")
    os.makedirs(folder)
    teacher_s = run_convert(["ctrnet_seg", src,
                             os.path.join(folder, "azure.pt")])
    with contextlib.chdir(tmp):
        teacher = load_seg_teacher(make_cfg(os.path.join(ROOT, STAGE3_CONFIG)),
                                   device=device)
    n = _same_tensors(teacher.model.state_dict(), seeded.model.state_dict(),
                      "teacher")
    seeded.to(device)
    images = torch.from_numpy(synthetic_requests(TEACHER_BATCH,
                                                 SEED + 13)[0]).to(device)
    with deterministic_convs(), torch.no_grad():
        masks, masks_seeded = teacher(images), seeded(images)
    mask_diff = float((masks - masks_seeded).abs().max())
    print(f"phase 12 convert: CtRNet teacher under the reference's names "
          f"({len(ref_sd)} tensors) -> tools.convert ctrnet_seg -> "
          f"load_seg_teacher: {n} tensors bitwise equal; b={TEACHER_BATCH} "
          f"masks {tuple(masks.shape)} max |d| {mask_diff:.3e} (== 0) "
          f"({card})", flush=True)
    if not torch.equal(masks, masks_seeded):
        raise AssertionError("the converted teacher's masks differ")
    return dict(fullnet_convert_s=fullnet_s, teacher_convert_s=teacher_s,
                outputs_rel_err=errs, teacher_mask_max_abs=mask_diff)


def phase12_export(cfg, sd, seeded_pred, device, card: str, tmp: str,
                   counts, phase4_ms: float) -> dict:
    """The flagship's serving forward exported at b=128 in float32, saved,
    loaded and run: its outputs against the eager `Predictor.forward` on
    the same crops (TF32 off and cuDNN deterministic for both), the
    soft-argmax launches inside the program, and its median time against
    the eager forward's."""
    from horopose_tpu_torch.tools.export import (OUTPUTS, export_serving,
                                                 load_serving)
    reset_counts, read_counts = counts
    path = os.path.join(tmp, "flagship.pt2")
    t0 = time.perf_counter()
    export_serving(cfg, sd, path, batch_size=EXPORT_BATCH, device=device)
    export_s = time.perf_counter() - t0
    mb = os.path.getsize(path) / 1e6
    weights_mb = sum(v.numel() * v.element_size() for v in sd.values()) / 1e6
    t0 = time.perf_counter()
    fn, meta = load_serving(path, device=device)
    load_s = time.perf_counter() - t0
    frames, K, bboxes = synthetic_requests(EXPORT_BATCH, SEED + 14)
    crops, crops_root, K_crops, k_values = seeded_pred.preprocess(frames, K,
                                                                  bboxes)
    args = (crops, crops_root, k_values, K_crops)
    with deterministic_convs():
        out, ref = fn(*args), seeded_pred.forward(*args)
        errs = {k: rel_err(out[k], ref[k]) for k in OUTPUTS}
        uvd_abs = float((out["uvd"] - ref["uvd"]).abs().max())
        uvd_max = float(ref["uvd"].abs().max())
    with tf32_off():         # cuDNN free to pick its summation order
        loose = rel_err(fn(*args)["uvd"], seeded_pred.forward(*args)["uvd"])
    worst = max(errs.values())
    print(f"phase 12 export: b={EXPORT_BATCH} float32 on {meta['device']}: "
          f"export {export_s:.1f} s, artifact {mb:.1f} MB (the state dict "
          f"{weights_mb:.1f} MB), load {load_s:.1f} s; outputs against the eager Predictor.forward, TF32 off and "
          f"cuDNN deterministic: "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} "
          f"(<= {EXPORT_REL}; uvd max |d| {uvd_abs:.3e} of max |uvd| "
          f"{uvd_max:.3e}); uvd with TF32 off alone (not checked) "
          f"{loose:.3e} ({card})", flush=True)
    if not worst <= EXPORT_REL:
        raise AssertionError(f"the exported program differs: {errs}")

    def timed(f) -> list:
        times = []
        for _ in range(EXPORT_REPS + 1):       # the first is a warm-up
            t0 = time.perf_counter()
            f(*args)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return times[1:]

    eager_before = timed(seeded_pred.forward)
    reset_counts()
    exported = timed(fn)
    launches = read_counts("exported serving")
    eager_after = timed(seeded_pred.forward)
    calls = EXPORT_REPS + 1
    if launches["soft_argmax_3d_fwd"] != calls \
            or launches["soft_argmax_3d_bwd"] != 0:
        raise AssertionError(f"{calls} calls of the exported program "
                             f"launched {launches}")
    exp_ms = statistics.median(exported)
    eager_ms = statistics.median(eager_before + eager_after)
    # one call of each traced on the device: busy time and launches
    traced = {}
    for name, f in (("exported", fn), ("eager", seeded_pred.forward)):
        rows, _ = profile_device(lambda: f(*args))
        traced[name] = dict(busy_ms=sum(r[0] for r in rows.values()),
                            launches=sum(r[1] for r in rows.values()))
        print(f"phase 12 export: {name} b={EXPORT_BATCH} forward traced: "
              f"device busy {traced[name]['busy_ms']:.3f} ms, "
              f"{traced[name]['launches']} device activities ({card})",
              flush=True)
    print(f"phase 12 export: {launches['soft_argmax_3d_fwd']} "
          f"soft_argmax_3d_fwd launches in {calls} calls (1 a call); "
          f"b={EXPORT_BATCH} forward median of {EXPORT_REPS}: exported "
          f"{exp_ms:.3f} ms ({1e3 * EXPORT_BATCH / exp_ms:.1f} img/s), eager "
          f"Predictor.forward {eager_ms:.3f} ms on the same crops before and "
          f"after; phase 4's b={EXPORT_BATCH} request (preprocessing "
          f"included) {phase4_ms:.3f} ms; TF32 as phase 4 ({card})",
          flush=True)
    return dict(export_s=export_s, artifact_mb=mb, weights_mb=weights_mb,
                load_s=load_s,
                rel_err=errs, launches=launches, exported_ms=exp_ms,
                exported_ms_all=exported, eager_forward_ms=eager_ms,
                eager_forward_ms_all=eager_before + eager_after,
                phase4_request_ms=phase4_ms, traced=traced,
                uvd_rel_err_nondeterministic=loose)


def phase12_dispatch(device, card: str, calls: int = 200) -> dict:
    """Host microseconds a call of the soft-argmax forward at the b=1
    serving shape (7 cells of 64^3, float32): the wrapper alone, the
    registered operator, and the operator on logits that need a gradient
    (its autograd node too). Each is enqueued `calls` times between two
    host stamps, a kernel taking ~0.01 ms, so the queue never blocks."""
    from horopose_tpu_torch.ops.integral import soft_argmax_3d_op
    from horopose_tpu_torch.ops.integral_cuda import soft_argmax_3d_fwd
    x = torch.randn(7, 64, 64, 64, device=device)
    xg = x.clone().requires_grad_()
    ways = {"wrapper": lambda: soft_argmax_3d_fwd(x),
            "operator": lambda: soft_argmax_3d_op(x),
            "operator with autograd": lambda: soft_argmax_3d_op(xg)}
    us = {}
    for _ in range(2):                  # the first round warms up
        for name, f in ways.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                f()
            us[name] = 1e6 * (time.perf_counter() - t0) / calls
            torch.cuda.synchronize()
    print(f"phase 12 dispatch: soft-argmax forward at (7, 64, 64, 64) "
          f"float32, host us a call over {calls}: "
          f"{json.dumps({k: round(v, 2) for k, v in us.items()})} ({card})",
          flush=True)
    return us


# phase 13: data parallelism over torch.distributed on the card. (a) the
# CLI under torchrun at one NCCL rank, and train_full in this process at a
# world-1 NCCL group against no group; (b) two ranks sharing the card over
# gloo (NCCL refuses two ranks on one device), spawned from this script,
# against one process; (c) what two ranks refuse
DP_RANKS = 2
DP_STEPS = 3
DP_WORLD1_REL = 1e-6    # one NCCL rank vs no group, deterministic convs
# two gloo ranks vs one process: the losses, the weights and the
# BatchNorm statistics after every step, each within DP_REL or within
# DP_FLOOR_MARGIN times the distance of the plain step on the batch's
# rows in reverse order, whichever is larger. The reversed rows give the
# same loss in exact arithmetic and sum the same terms in another order,
# as the ranks do; Adam's normalised first steps turn the rounding of
# small gradients into weight moves, so that distance grows to about
# 1.1e-4 by step 3 on the H100. The margin leaves room for the ranks'
# own orders (the gradient all-reduce, the synchronised BatchNorm's sums)
DP_REL = 1e-4
DP_FLOOR_MARGIN = 2.0
DP_VAL_REL = 1e-5       # their validation vs the single-process one
DP_SAMPLE_STRIDE = 997  # the fixed sample of the weights compared
DP_TIMEOUT_S = 300      # a child's bound; the phase aims at under 150 s
DP_GROUP_TIMEOUT_S = 120
DP_VAL_TAGS = ("loss", "pose_loss", "rot_loss", "rot_diff", "trans_loss",
               "uv_loss", "depth_loss", "error2d_loss", "error3d_loss",
               "error3d_align_loss", "mean_joint_error", "distance3D_keypoint",
               "distance2D_keypoint", "l1error_joint")


def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def child_env(**extra) -> dict:
    """This process's environment for a child: the repo on the path, no
    process-group variables but `extra`."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROPOSE_") and k not in
           ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)
    env["PYTHONUNBUFFERED"] = "1"
    env.update({k: str(v) for k, v in extra.items()})
    return env


def start_child(cmd, env, log_path: str, cwd: str = ROOT):
    """Popen of `cmd` in its own session (so a timeout kills its whole
    tree), its output to `log_path`."""
    import subprocess
    with open(log_path, "w") as log:
        return subprocess.Popen(cmd, env=env, cwd=cwd, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)


def kill_children(procs):
    """SIGKILL each running child's session (its whole tree), and reap."""
    import signal
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()


def join_children(procs, logs, label: str, timeout_s: float = DP_TIMEOUT_S):
    """Wait for every child within `timeout_s` in all; on expiry or a
    failure kill them all and raise with the logs' tails."""
    import subprocess
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        kill_children(procs)
        raise AssertionError(f"{label}: a child ran past {timeout_s} s and "
                             f"was killed:\n" + "\n".join(
                                 tail(path) for path in logs))
    bad = [(p.returncode, path) for p, path in zip(procs, logs)
           if p.returncode != 0]
    if bad:
        kill_children(procs)
        raise AssertionError(f"{label}: exit codes {[b[0] for b in bad]}\n"
                             + "\n".join(tail(b[1]) for b in bad))


def tail(path: str, n: int = 4000) -> str:
    with open(path, errors="replace") as f:
        return f"--- {path}:\n" + f.read()[-n:]


def phase13_config(tmp: str, train_dir: str) -> str:
    """Phase 9's config as a file for the CLI: configs/panda/full.yaml with
    phase 9's train set, its epoch size, one epoch and its own name."""
    override = {"train_ds_names": f'"{train_dir}"',
                "epoch_size": str(STAGE2_TRAIN_FRAMES), "n_epochs": "1",
                "exp_name": '"panda_full_dp"'}
    with open(os.path.join(ROOT, STAGE2_CONFIG)) as f:
        lines = [ln for ln in f.read().splitlines()
                 if ln.split(":")[0].strip() not in override]
    lines += [f"{k} : {v}" for k, v in override.items()]
    path = os.path.join(tmp, "full_dp.yaml")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def phase13_torchrun(config: str, tmp: str):
    """Start `torchrun --standalone --nproc_per_node=1 -m
    horopose_tpu_torch.scripts.train --config <config>` (as `python -m
    torch.distributed.run`) with HOROPOSE_DISTRIBUTED=auto, its experiment
    folder under tmp/cli; returns (Popen, log path, folder)."""
    cwd = os.path.join(tmp, "cli")
    os.makedirs(cwd, exist_ok=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=1", "-m", "horopose_tpu_torch.scripts.train",
           "--config", config]
    log = os.path.join(tmp, "torchrun.log")
    proc = start_child(cmd, child_env(HOROPOSE_DISTRIBUTED="auto"), log, cwd)
    print(f"phase 13 (a): started {' '.join(cmd[1:])} with "
          f"HOROPOSE_DISTRIBUTED=auto", flush=True)
    return proc, log, os.path.join(cwd, "experiments", "panda_full_dp")


def phase13_check_torchrun(proc, log: str, folder: str, card: str,
                           t0: float) -> dict:
    """The CLI child's end: exit 0 within the bound, one NCCL rank on
    cuda:0, its scalars written, and the best-AUC keeper's decision."""
    join_children([proc], [log], "phase 13 (a) torchrun")
    with open(log, errors="replace") as f:
        text = f.read()
    if "backend nccl" not in text or "process 0/1" not in text:
        raise AssertionError("phase 13 (a): the CLI child did not report one "
                             "NCCL rank:\n" + tail(log))
    with open(os.path.join(folder, "log", "scalars.jsonl")) as f:
        scalars = {r["tag"]: r["value"] for r in map(json.loads, f)}
    if not all(np.isfinite(v) for v in scalars.values()) or \
            "Train/loss_epoch" not in scalars:
        raise AssertionError(f"phase 13 (a): CLI scalars {scalars}")
    auc = scalars["Val/AUC_ADD_dr"]
    ckpt = os.path.join(folder, "ckpt", "curr_best_auc(add)_model.pk")
    if os.path.exists(ckpt) != (auc > 0.0):
        raise AssertionError(f"phase 13 (a): ADD AUC {auc}, checkpoint "
                             f"written {os.path.exists(ckpt)}")
    line = next(ln for ln in text.splitlines() if "[multihost]" in ln)
    wall = time.perf_counter() - t0
    print(f"phase 13 (a) CLI under torchrun: {line.strip()}; one epoch "
          f"with its validation, exit 0 in {wall:.1f} s (process start "
          f"included; the card shared with this process's train_full runs "
          f"for most of it); {len(scalars)} scalars, Train/loss_epoch "
          f"{scalars['Train/loss_epoch']:.6f}, Val/AUC_ADD_dr {auc}; "
          f"checkpoint {'written' if auc > 0 else 'not written (AUC 0)'} "
          f"({card})", flush=True)
    return dict(wall_s=wall, loss_epoch=scalars["Train/loss_epoch"],
                auc=auc, n_scalars=len(scalars))


def phase13_train_losses(cfg2, device, exp_root: str):
    """train_full for one epoch of phase 9's train set under
    deterministic_convs, from fresh loaders, no validation: (each step's
    loss, the TrainState)."""
    from horopose_tpu_torch.pipelines import train_full as TF
    from horopose_tpu_torch.pipelines.common import get_dataloaders
    build, losses = TF.build_full_train_step, []

    def recording(*args, **kwargs):
        step = build(*args, **kwargs)

        def run(batch, generator):
            logs = step(batch, generator)
            losses.append(logs["loss"])
            return logs
        return run

    loaders = get_dataloaders(cfg2, device)
    TF.build_full_train_step = recording
    try:
        with deterministic_convs():
            state = TF.train_full(cfg2, {"train": loaders["train"],
                                         "test": {}}, max_epochs=1,
                                  device=device, exp_root=exp_root)
    finally:
        TF.build_full_train_step = build
        loaders["train"].close()
        for loader in loaders["test"].values():
            loader.close()
    return torch.stack(losses).double().cpu(), state


def sync(device):
    """Wait for `device`'s queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def allreduce_ms(params, device, reps: int = 5) -> dict:
    """Median ms, host clock, synchronised, of the step's gradient mean
    (`average_gradients`) on the current gradients (`whole`), and of two
    of its parts alone: the flatten of the gradients into one buffer, and
    the all-reduce of that buffer. Every rank calls it."""
    import torch.distributed as dist
    from horopose_tpu_torch.parallel.multihost import average_gradients
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])

    def median_ms(fn):
        times = []
        for _ in range(reps + 1):
            sync(device)
            t0 = time.perf_counter()
            fn()
            sync(device)
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times[1:])
    return dict(whole=median_ms(lambda: average_gradients(params)),
                flatten=median_ms(
                    lambda: torch.cat([g.reshape(-1) for g in grads])),
                all_reduce=median_ms(lambda: dist.all_reduce(flat)))


def ms_parts(ar: dict) -> str:
    return (f"{ar['whole']:.3f} ms (flatten alone {ar['flatten']:.3f} ms, "
            f"all-reduce of the flat buffer alone {ar['all_reduce']:.3f} ms; "
            f"medians of 5, host clock)")


def phase13_world1(cfg2, device, card: str, tmp: str, counts,
                   join_cli) -> dict:
    """train_full on phase 9's files without a process group, then in a
    world-1 NCCL group (`maybe_initialize` from the HOROPOSE_COORDINATOR
    trio at a free localhost port): the same losses step by step, each
    kernel launched once a step, and the gradient all-reduce's time,
    taken after `join_cli()` has waited for the CLI child, which trains
    on the same card."""
    import torch.distributed as dist
    from horopose_tpu_torch.parallel import multihost
    reset, read = counts
    plain, _ = phase13_train_losses(cfg2, device,
                                    os.path.join(tmp, "world1_plain"))
    env = dict(HOROPOSE_COORDINATOR=f"localhost:{free_port()}",
               HOROPOSE_NUM_PROCESSES="1", HOROPOSE_PROCESS_ID="0")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        if not multihost.maybe_initialize(device="cuda",
                                          timeout_s=DP_GROUP_TIMEOUT_S):
            raise AssertionError("phase 13 (a): no process group")
        backend = dist.get_backend()
        reset()
        nccl, state = phase13_train_losses(cfg2, device,
                                           os.path.join(tmp, "world1_nccl"))
        launches = read("data-parallel, one NCCL rank (train_full)")
        params = [p for p in state.model.parameters() if p.requires_grad]
        grad_mb = sum(p.grad.numel() * p.grad.element_size()
                      for p in params) / 1e6
        join_cli()
        ar_ms = allreduce_ms(params, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    n = len(plain)
    if not launches["soft_argmax_3d_fwd"] == launches["soft_argmax_3d_bwd"] \
            == n:
        raise AssertionError(f"phase 13 (a): {n} steps in the NCCL group "
                             f"launched {launches}")
    rel = float(((nccl - plain).abs() / plain.abs()).max())
    print(f"phase 13 (a) train_full at one {backend} rank against no process "
          f"group, deterministic convs, TF32 off: {n} steps, losses "
          f"{[round(float(v), 6) for v in nccl]}, max rel_err {rel:.3e} "
          f"(bound {DP_WORLD1_REL:.0e}); the gradient all-reduce of "
          f"{len(params)} tensors, {grad_mb:.1f} MB f32, at world size 1, "
          f"the card to itself: {ms_parts(ar_ms)} ({card})", flush=True)
    if not rel <= DP_WORLD1_REL:
        raise AssertionError(f"phase 13 (a): NCCL rank vs no group rel_err "
                             f"{rel}")
    return dict(backend=backend, steps=n, rel_err=rel, launches=launches,
                grad_mb=grad_mb, allreduce_ms=ar_ms)


def is_bn_stat(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


def weight_sample(model) -> dict:
    """A fixed sample of each parameter and each BatchNorm running
    statistic, by state-dict name: every DP_SAMPLE_STRIDE-th element of
    the leaf, from its first."""
    sd = model.state_dict()
    names = [k for k, _ in model.named_parameters()] + [
        k for k in sd if is_bn_stat(k)]
    return {k: sd[k].detach().float().reshape(-1)[::DP_SAMPLE_STRIDE].to(
        "cpu", copy=True) for k in names}


def l2_rel(got: dict, want: dict, keys) -> float:
    """‖got − want‖ / ‖want‖ over the leaves `keys` of two samples."""
    num = sum(float((got[k] - want[k]).double().pow(2).sum()) for k in keys)
    den = sum(float(want[k].double().pow(2).sum()) for k in keys)
    return (num / max(den, 1e-300)) ** 0.5


def _reverse_rows(batch: dict) -> dict:
    return {k: _reverse_rows(v) if isinstance(v, dict) else v.flip(0)
            for k, v in batch.items()}


class RecordingWriter:
    """A scalar writer that keeps the last value of each tag."""

    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars[tag] = float(value)

    def close(self):
        pass


def phase13_validate(cfg, sd, config: str, device) -> dict:
    """validate_full of the weights `sd` on the test set of `config` as
    get_dataloaders gives it (this rank's share under a process group),
    TF32 off: the scalars it logs."""
    from horopose_tpu_torch.config import make_cfg
    from horopose_tpu_torch.core.engine import build_full_eval_step
    from horopose_tpu_torch.models.common import convert_sync_batchnorm
    from horopose_tpu_torch.parallel.multihost import process_count
    from horopose_tpu_torch.parallel.prefetch import prefetch_to_device
    from horopose_tpu_torch.pipelines.common import (build_fullnet,
                                                     get_dataloaders,
                                                     make_robot)
    from horopose_tpu_torch.pipelines.train_full import validate_full
    model = build_fullnet(cfg)
    model.load_state_dict(sd)
    model = model.to(device)
    if process_count() > 1:
        model = convert_sync_batchnorm(model)
    robot = make_robot(cfg, device=device)
    loaders = get_dataloaders(make_cfg(config), device)
    writer = RecordingWriter()
    try:
        with tf32_off():
            validate_full(cfg, robot, build_full_eval_step(cfg, model, robot),
                          prefetch_to_device(loaders["test"]["dr"], device, 2),
                          writer, 0, "dr")
    finally:
        loaders["train"].close()
        for loader in loaders["test"].values():
            loader.close()
    return dict(scalars=writer.scalars,
                batches=len(loaders["test"]["dr"]),
                batch_size=loaders["test"]["dr"].batch_size)


def dp_rank_main(tmp: str) -> int:
    """One of phase 13 (b)'s ranks (`chip_smoke.py --dp-rank TMP`, the
    HOROPOSE_COORDINATOR trio in its environment): gloo on cuda:0 (on the
    CPU when the inputs say so, for a rehearsal), its rows of phase 5's
    batch for DP_STEPS stage-2 steps with TF32 off, a validation of its
    share of phase 9's test set, the refusals; saves what it measured to
    TMP/dp_rank<r>.pt."""
    import torch.distributed as dist
    from horopose_tpu_torch.config import make_cfg
    from horopose_tpu_torch.core.engine import (build_full_train_step,
                                                make_optimizer)
    from horopose_tpu_torch.models.common import convert_sync_batchnorm
    from horopose_tpu_torch.ops import integral_cuda
    from horopose_tpu_torch.parallel import (maybe_initialize,
                                             process_count, process_index,
                                             replicate, train_mesh)
    from horopose_tpu_torch.parallel.multihost import rank_device
    from horopose_tpu_torch.pipelines.common import build_fullnet, make_robot
    from horopose_tpu_torch.pipelines.train_sim2real import train_sim2real
    spec = torch.load(os.path.join(tmp, "dp_inputs.pt"), weights_only=False)
    kind = spec["device"]
    if not maybe_initialize(device=kind, backend="gloo",
                            timeout_s=DP_GROUP_TIMEOUT_S):
        raise SystemExit("no process group")
    try:
        rank, n = process_index(), process_count()
        device = rank_device() if kind == "cuda" else torch.device(kind)
        cfg = spec["cfg"]
        b = int(spec["batch"]["TCO"].shape[0]) // n
        local = _batch_to({k: _slice_rows(v, rank * b, b)
                           for k, v in spec["batch"].items()}, device)
        wrappers = (integral_cuda.soft_argmax_3d_fwd,
                    integral_cuda.soft_argmax_3d_bwd)
        with tf32_off():
            model = build_fullnet(cfg)
            model.load_state_dict(spec["sd"])
            model = replicate(convert_sync_batchnorm(model.to(device)))
            opt, sched = make_optimizer(cfg, model.parameters(),
                                        STEPS_PER_EPOCH)
            step = build_full_train_step(cfg, model,
                                         make_robot(cfg, device=device),
                                         opt, sched)
            logs, step_ms, launches, samples = [], [], [], []
            for _ in range(DP_STEPS):
                before = [w.launches for w in wrappers]
                sync(device)
                t0 = time.perf_counter()
                logs.append({k: float(v) for k, v in
                             step(local, None).items()})
                sync(device)
                step_ms.append(1e3 * (time.perf_counter() - t0))
                launches.append([w.launches - c for w, c in
                                 zip(wrappers, before)])
                samples.append(weight_sample(model))
            params = [p for p in model.parameters() if p.requires_grad]
            ar_ms = allreduce_ms(params, device)
            del opt, sched, step, params, model
            before = wrappers[0].launches
            val = phase13_validate(cfg, spec["sd"], spec["config"], device)
            val["launches"] = wrappers[0].launches - before
        refusals = {}
        try:
            train_sim2real(None)
        except NotImplementedError as e:
            refusals["sim2real"] = str(e)
        mesh_cfg = make_cfg(spec["config"])
        mesh_cfg.mesh_shape = [1]
        try:
            train_mesh(mesh_cfg)
        except ValueError as e:
            refusals["mesh"] = str(e)
        dist.barrier()
        from horopose_tpu_torch.ops import conv3x3_cuda
        # this process's path: the steps and the validation
        totals = {fn.__name__: fn.launches for fn in
                  (*wrappers, conv3x3_cuda.conv3x3_nhwc)}
        out = dict(rank=rank, count=n, backend=dist.get_backend(),
                   device=str(device), logs=logs, step_ms=step_ms,
                   totals=totals,
                   launches=launches, allreduce_ms=ar_ms, samples=samples,
                   val=val, refusals=refusals)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"dp_rank{rank}.pt"))
    print(f"[dp rank {rank}] done", flush=True)
    return 0


def _slice_rows(x, start: int, n: int):
    if isinstance(x, dict):
        return {k: _slice_rows(v, start, n) for k, v in x.items()}
    return x[start:start + n]


def phase13_two_ranks(cfg, train_sd, batch, config: str, device, card: str,
                      tmp: str) -> dict:
    """Phase 13 (b) and (c): run the steps and the validation in this
    process, then spawn DP_RANKS gloo ranks on the card (this process's
    cached memory handed back first: three training processes at once do
    not fit the card) and hold them against it."""
    cfg = dataclasses.replace(cfg, p_dropout=0.0)
    # the same DP_STEPS steps on the whole batch, and the validation, in
    # this process: the plain single-card path, then the same on the rows
    # in reverse order (the weights' noise floor)
    runs = []
    with tf32_off():
        for rows in (batch, _reverse_rows(batch)):
            model, step = make_train_step(cfg, train_sd, device)
            logs, samples = [], []
            for _ in range(DP_STEPS):
                logs.append({k: float(v) for k, v in step(rows, None).items()})
                samples.append(weight_sample(model))
            runs.append((logs, samples))
            del model, step
    (plain, want), (_, again) = runs
    stats = [k for k in want[0] if is_bn_stat(k)]
    params = [k for k in want[0] if not is_bn_stat(k)]
    world1_val = phase13_validate(cfg, train_sd, config, device)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    torch.save(dict(cfg=cfg, sd=train_sd, config=config,
                    device=torch.device(device).type,
                    batch=_batch_to(batch, "cpu")),
               os.path.join(tmp, "dp_inputs.pt"))
    port = free_port()
    logs = [os.path.join(tmp, f"dp_rank{r}.log") for r in range(DP_RANKS)]
    t0 = time.perf_counter()
    procs = [start_child(
        [sys.executable, os.path.abspath(__file__), "--dp-rank", tmp],
        child_env(HOROPOSE_COORDINATOR=f"localhost:{port}",
                  HOROPOSE_NUM_PROCESSES=DP_RANKS, HOROPOSE_PROCESS_ID=r,
                  LOCAL_RANK=0), logs[r]) for r in range(DP_RANKS)]
    join_children(procs, logs, "phase 13 (b) gloo ranks")
    wall = time.perf_counter() - t0
    outs = [torch.load(os.path.join(tmp, f"dp_rank{r}.pt"),
                       weights_only=False) for r in range(DP_RANKS)]
    # (b) the ranks against the single process
    loss_rel = max(abs(np.mean([o["logs"][i][k] for o in outs]) - v)
                   / max(abs(v), 1e-12)
                   for i, lg in enumerate(plain) for k, v in lg.items())
    # [step][params or stats]: the ranks, and the plain path on the
    # reversed rows; the bound of each
    def rels(got, ref):
        return [dict(params=l2_rel(g, w, params), stats=l2_rel(g, w, stats))
                for g, w in zip(got, ref)]
    w_rel, floor = rels(outs[0]["samples"], want), rels(again, want)
    bound = [{k: max(DP_REL, DP_FLOOR_MARGIN * v) for k, v in f.items()}
             for f in floor]
    got, ref = outs[0]["samples"][-1], want[-1]
    farthest = sorted(params, key=lambda k: -float(
        (got[k] - ref[k]).double().pow(2).sum()))[:3]
    same = all(torch.equal(a[k], b[k]) for o in outs
               for a, b in zip(outs[0]["samples"], o["samples"]) for k in a)
    val_rel, worst = 0.0, ""
    for o in outs:
        got, ref = o["val"]["scalars"], world1_val["scalars"]
        if sorted(got) != sorted(ref):
            raise AssertionError("phase 13 (b): validation tags differ")
        for tag, v in ref.items():
            if not tag.split("/")[-1].startswith(DP_VAL_TAGS):
                continue
            e = abs(got[tag] - v) / max(abs(v), 1e-6)
            if e > val_rel:
                val_rel, worst = e, tag
    def steps(key, rows):
        return [float(f"{w[key]:.4e}") for w in rows]
    print(f"phase 13 (b) {DP_RANKS} ranks over gloo on one card "
          f"({', '.join(o['device'] for o in outs)}; backend "
          f"{outs[0]['backend']}), full.yaml's FullNet at global b="
          f"{batch['TCO'].shape[0]}, {batch['TCO'].shape[0] // DP_RANKS} a "
          f"rank, dropout off, TF32 off, {DP_STEPS} steps against one "
          f"process on the same rows: losses rel_err {loss_rel:.3e} (bound "
          f"{DP_REL:.0e}); after each step, the weights (every "
          f"{DP_SAMPLE_STRIDE}th element of each leaf) rel_err "
          f"{steps('params', w_rel)}, BatchNorm running statistics "
          f"{steps('stats', w_rel)}; the plain path on the reversed rows "
          f"{steps('params', floor)} and {steps('stats', floor)}; bounds "
          f"max({DP_REL:.0e}, {DP_FLOOR_MARGIN:g} x the reversed rows') "
          f"{steps('params', bound)} and {steps('stats', bound)}; the "
          f"leaves farthest apart after step {DP_STEPS}: {farthest}; the ranks' samples identical {same}; "
          f"the ranks' processes ran {wall:.1f} s from start to exit "
          f"({card})", flush=True)
    print(f"phase 13 (b) validation of {STAGE2_TEST_FRAMES} frames, "
          f"{outs[0]['val']['batches']} batches of "
          f"{outs[0]['val']['batch_size']} a rank, against one process "
          f"({world1_val['batches']} of {world1_val['batch_size']}): max "
          f"rel_err {val_rel:.3e} ({worst}; bound {DP_VAL_REL:.0e}) over "
          f"the loss means, mean joint error, per-keypoint distances and "
          f"per-joint errors ({card})", flush=True)
    for o in outs:
        print(f"phase 13 (b) rank {o['rank']}: step ms "
              f"{[round(t, 1) for t in o['step_ms']]}, the gradient "
              f"all-reduce over gloo {ms_parts(o['allreduce_ms'])}; "
              f"soft-argmax launches a step (fwd, bwd) "
              f"{o['launches']}, validation {o['val']['launches']}. Two "
              f"ranks share one card through host-side gloo: these times "
              f"say nothing about scaling ({card})", flush=True)
    fails = []
    if not (loss_rel <= DP_REL and all(w[k] <= b[k] for w, b in
                                       zip(w_rel, bound) for k in b)):
        fails.append(f"steps: losses {loss_rel}, weights {w_rel}, bounds "
                     f"{bound}")
    if not same:
        fails.append("the ranks' weights differ")
    if not val_rel <= DP_VAL_REL:
        fails.append(f"validation {worst} rel_err {val_rel}")
    if any(c != [1, 1] for o in outs for c in o["launches"]):
        fails.append(f"launches a step {[o['launches'] for o in outs]}")
    if any(o["val"]["launches"] != o["val"]["batches"] for o in outs):
        fails.append("validation launches "
                     f"{[o['val']['launches'] for o in outs]}")
    # (c) the refusals
    for o in outs:
        r = o["refusals"]
        if "single-process" not in r.get("sim2real", "") or \
                f"covers 1 of {DP_RANKS} ranks" not in r.get("mesh", ""):
            fails.append(f"rank {o['rank']} refusals {r}")
    print(f"phase 13 (c) under {DP_RANKS} ranks: train_sim2real raised "
          f"NotImplementedError ({outs[0]['refusals'].get('sim2real')!r}); "
          f"mesh_shape [1] raised ({outs[0]['refusals'].get('mesh')!r})",
          flush=True)
    if fails:
        raise AssertionError("phase 13: " + "; ".join(fails))
    return dict(wall_s=wall, loss_rel=loss_rel, weight_rel=w_rel,
                weight_rel_reversed_rows=floor, weight_bound=bound,
                val_rel=val_rel, step_ms=[o["step_ms"] for o in outs],
                allreduce_ms=[o["allreduce_ms"] for o in outs],
                launches_per_rank={f"rank {o['rank']}": o["totals"]
                                   for o in outs})


# phase 14: the learning demo's slice. (a) the memorization regression of
# tests/test_auc_regression.py: 4 noise frames at 480x640 with eval =
# train, resnet18 backbones at 64x64, b=4, lr 1e-3 with the exponential
# schedule, up to 450 one-step epochs, evaluated every 50 from epoch 300
# with running statistics (validate_full) and with batch statistics
MEMO_EPOCHS, MEMO_EVAL_EVERY, MEMO_EVAL_FROM = 450, 50, 300
MEMO_BATCH_STATS_AUC, MEMO_RUNNING_AUC = 0.70, 0.15
MEMO_STOP = (0.75, 0.20)   # both bars passed with room: stop early
MEMO_CONFIG = dict(
    exp_name="aucreg", urdf_robot_name="panda", batch_size=4, epoch_size=4,
    n_epochs=MEMO_EPOCHS, n_dataloader_workers=0, image_size=64.0, lr=1e-3,
    clip_gradient=5.0, use_schedule=True, schedule_type="exponential",
    n_epochs_warmup=5, start_decay=150, end_decay=400, exponent=0.99,
    jitter=False, other_aug=False, occlusion=False, rootnet_flip=False,
    use_rootnet_with_reg_int_shared_backbone=True, backbone_name="resnet18",
    rootnet_backbone_name="resnet18", pose_loss_weight=1.0,
    rot_loss_weight=1.0, trans_loss_weight=1.0, uv_loss_weight=1.0,
    depth_loss_weight=10.0, kp2d_loss_weight=10.0, kp3d_loss_weight=10.0,
    kp2d_int_loss_weight=10.0, kp3d_int_loss_weight=10.0,
    align_3d_loss_weight=0.0, reference_keypoint_id=3, fix_root=True,
    p_dropout=0.0)
# (b) cfg.remat at the flagship's width: the CPU test's tolerances
# (tests/test_torch_port_remat.py, from tests/test_remat.py)
REMAT_LOSS_RTOL = 1e-6
REMAT_GRAD_ATOL, REMAT_GRAD_RTOL = 2e-5, 1e-4
REMAT_STAT_TOL = 1e-6
REMAT_TIMED_STEPS = 3
REMAT_PROBE_BATCHES = (128, 256)     # after b=64, doubling up to 256
# (c) the native crop against data/crop.py over frames of phase 9's size
CROP_FRAMES, CROP_SIZE = 256, 256
CROP_MAX_OFF_BY_ONE = 1e-3
# (d) the demo, short, at full width on the card. 10 epochs of 4 steps:
# the JAX initialisers start the root depth at about 0, where the 2-D
# keypoint losses are singular, and over 4 epochs the mean loss rose in
# 2 of 4 runs before it fell (PERF.md §6)
DEMO_ARGS = ("--n-train", "128", "--n-test", "32", "--epochs", "10",
             "--batch-size", "32")
DEMO_TIMEOUT_S = 300


def write_yaml(path: str, values: dict) -> str:
    """`values` as `key : value` lines, the subset config.make_cfg reads."""
    with open(path, "w") as f:
        for k, v in values.items():
            f.write(f"{k} : {json.dumps(v) if isinstance(v, str) else v}\n")
    return path


def memorization_run(tmp: str, device, card: str = "") -> dict:
    """The memorization regression (MEMO_*): trains through
    `build_full_train_step` from the port's DREAM loader and evaluates
    the held-out (= train) set with the running statistics
    (`validate_full`) and with batch statistics (train-mode BatchNorm on
    copies of its statistics, `batchnorm_statistics_on_copies`). Returns
    both AUCs by epoch, the losses, the steps and the eval forwards."""
    from collections import defaultdict
    from horopose_tpu_torch import constants as C
    from horopose_tpu_torch.config import make_cfg
    from horopose_tpu_torch.core.engine import (_forward,
                                                build_full_eval_step,
                                                build_full_train_step,
                                                make_optimizer, prepare_gt)
    from horopose_tpu_torch.core.loggers import create_logger
    from horopose_tpu_torch.core.metrics import (compute_metrics_batch,
                                                 summary_add_pck)
    from horopose_tpu_torch.models.common import \
        batchnorm_statistics_on_copies
    from horopose_tpu_torch.parallel.prefetch import prefetch_to_device
    from horopose_tpu_torch.pipelines.common import (FullNetConfig,
                                                     get_dataloaders,
                                                     make_robot)
    from horopose_tpu_torch.pipelines.train_full import (host_numpy,
                                                         init_fullnet_state,
                                                         seeded_fullnet,
                                                         validate_full)
    from horopose_tpu_torch.tools.synth_dream import \
        make_synthetic_dream_dataset
    t0 = time.perf_counter()
    data = os.path.join(tmp, "dream")
    train_dir = make_synthetic_dream_dataset(data, "panda", n_images=4,
                                             split="train_dr", seed=0)
    # the same seed: the same frames, so eval = train
    make_synthetic_dream_dataset(data, "panda", n_images=4, split="test_dr",
                                 seed=0)
    cfg = make_cfg(write_yaml(os.path.join(tmp, "memo.yaml"), MEMO_CONFIG))
    cfg.train_ds_names = str(train_dir)
    fcfg = FullNetConfig.from_cfg(cfg)
    _, _, _, writer = create_logger(cfg, os.path.join(tmp, "experiments"))
    robot = make_robot(fcfg, device=device)
    loaders = get_dataloaders(cfg, device)
    model = init_fullnet_state(fcfg, seeded_fullnet(fcfg)).to(device)
    optimizer, scheduler = make_optimizer(fcfg, model.parameters(), 1)
    train_step = build_full_train_step(fcfg, model, robot, optimizer,
                                       scheduler)
    eval_step = build_full_eval_step(fcfg, model, robot)
    generator = torch.Generator(device=device).manual_seed(C.GLOBAL_SEED)
    test = loaders["test"]["dr"]
    evals = 0

    def batch_stats_auc() -> float:
        nonlocal evals
        dis = defaultdict(list)
        model.train()
        with torch.no_grad(), batchnorm_statistics_on_copies(model):
            for batch in prefetch_to_device(test, device, 0):
                gts = prepare_gt(fcfg, robot, batch)
                preds, _ = _forward(fcfg, model, robot, batch, gts)
                evals += 1
                m = compute_metrics_batch(
                    robot=robot,
                    gt_keypoints3d=host_numpy(gts["gt_keypoints3d"]),
                    gt_keypoints2d=host_numpy(batch["keypoints_2d_original"]),
                    K_original=host_numpy(batch["K_original"]),
                    gt_joint=host_numpy(gts["gt_pose_before_mask"]),
                    pred_keypoints3d=host_numpy(preds["xyz_fk"]),
                    pred_joint=host_numpy(preds["pose"]),
                    reference_keypoint_id=int(fcfg.reference_keypoint_id))
                dis["dis3d"].extend(m["image_dis3d_avg"])
                dis["dis2d"].extend(m["image_dis2d_avg"])
        return summary_add_pck(dis)["ADD/AUC"]

    def evaluate(epoch: int, when: str):
        nonlocal evals
        aucs[epoch] = validate_full(fcfg, robot, eval_step,
                                    prefetch_to_device(test, device, 0),
                                    writer, epoch, "dr")
        evals += len(test)
        aucs_bs[epoch] = batch_stats_auc()
        print(f"phase 14 (a) {when}: ADD AUC running statistics "
              f"{aucs[epoch]:.4f}, batch statistics {aucs_bs[epoch]:.4f} "
              f"({time.perf_counter() - t0:.1f} s; {card})", flush=True)

    aucs, aucs_bs, losses, steps = {}, {}, [], 0
    try:
        for epoch in range(MEMO_EPOCHS + 1):
            if epoch % MEMO_EVAL_EVERY == 0 and epoch >= MEMO_EVAL_FROM:
                evaluate(epoch, f"epoch {epoch}")
                if aucs_bs[epoch] >= MEMO_STOP[0] and \
                        aucs[epoch] >= MEMO_STOP[1]:
                    break
            for batch in prefetch_to_device(loaders["train"], device, 0):
                logs = train_step(batch, generator)
                steps += 1
            losses.append(float(logs["loss"]))
            if not math.isfinite(losses[-1]):
                raise AssertionError(f"phase 14 (a): loss {losses[-1]} at "
                                     f"epoch {epoch}")
        else:
            # as the JAX test: after the last epoch's step, under its key
            evaluate(MEMO_EPOCHS, f"after epoch {MEMO_EPOCHS}'s step")
    finally:
        writer.close()
        for loader in [loaders["train"], *loaders["test"].values()]:
            loader.close()
    return dict(aucs=aucs, aucs_batch_stats=aucs_bs, steps=steps,
                eval_forwards=evals, loss_first=losses[0],
                loss_last=losses[-1], wall_s=time.perf_counter() - t0)


def _bn_buffers(model) -> dict:
    """The BatchNorm running statistics and counters, on the host."""
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
            if is_bn_stat(k) or k.endswith("num_batches_tracked")}


def _allclose_report(got: dict, want: dict, atol: float, rtol: float
                     ) -> tuple:
    """(the largest |got - want| / (atol + rtol |want|) over every entry,
    its key); at most 1 is within the bound."""
    worst, where = 0.0, None
    for k, w in want.items():
        g, w = got[k].double(), w.double()
        diff = (g - w).abs()
        if not bool(torch.isfinite(g).all() and torch.isfinite(w).all()):
            return math.inf, k
        r = float(torch.where(diff == 0, torch.zeros_like(diff),
                              diff / (atol + rtol * w.abs())).max())
        if r > worst:
            worst, where = r, k
    return worst, where


def phase14_remat(cfg, sd, batch, device, card: str, counts) -> dict:
    """cfg.remat at the flagship's width: for each dtype, one stage-2 step
    with remat and one without from the same weights, batch and dropout
    seed under `deterministic_convs`, held at the CPU test's tolerances
    (losses, gradients, BatchNorm statistics and their counters); then
    REMAT_TIMED_STEPS steps of each timed with the default TF32, their
    peak memory, and the largest batch of REMAT_PROBE_BATCHES (on rows of
    one 256-row batch) at which each steps without running out of
    memory."""
    from horopose_tpu_torch.data.synthetic import synthetic_dream_batch
    from horopose_tpu_torch.pipelines.common import crop_sizes, make_robot
    reset, read = counts
    b = int(batch["TCO"].shape[0])
    out, steps = {}, 0
    reset()
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        runs = {}
        for remat in (False, True):
            model, step = make_train_step(
                dataclasses.replace(cfg, remat=remat), sd, device, dtype)
            gen = torch.Generator(device=device).manual_seed(SEED)
            with deterministic_convs():
                logs = step(batch, gen)
            steps += 1
            run = dict(losses={k: v.detach().cpu() for k, v in logs.items()},
                       grads=_grads(model), stats=_bn_buffers(model))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            times = []
            for _ in range(REMAT_TIMED_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(batch, gen)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                steps += 1
            run.update(ms=1e3 * statistics.median(times),
                       peak_gib=torch.cuda.max_memory_allocated(device)
                       / 2 ** 30)
            if dtype == torch.float32:     # where the recompute's time goes
                prof = train_breakdown(
                    lambda: step(batch, gen),
                    f"{'remat' if remat else 'plain'} {name} b={b}",
                    run["ms"], card)
                run["busy_ms"] = sum(e.self_device_time_total
                                     for e in device_events(prof)) / 1e3
                steps += 1
                del prof
            runs[remat] = run
            del model, step, logs
        off, on = runs[False], runs[True]
        loss_r = _allclose_report(on["losses"], off["losses"], 0.0,
                                  REMAT_LOSS_RTOL)
        grad_r = _allclose_report(on["grads"], off["grads"], REMAT_GRAD_ATOL,
                                  REMAT_GRAD_RTOL)
        stats = {k: v for k, v in off["stats"].items()
                 if not k.endswith("num_batches_tracked")}
        stat_r = _allclose_report(on["stats"], stats, REMAT_STAT_TOL,
                                  REMAT_STAT_TOL)
        tracked = {k for k in off["stats"]
                   if k.endswith("num_batches_tracked")}
        once = all(int(on["stats"][k]) == int(off["stats"][k]) == 1
                   for k in tracked)
        print(f"phase 14 (b) remat {name} b={b}, one step from the same "
              f"state, deterministic convs, TF32 off: losses at "
              f"{loss_r[0]:.3g} of the bound (rtol {REMAT_LOSS_RTOL}), "
              f"gradients {grad_r[0]:.3g} of theirs (atol {REMAT_GRAD_ATOL}, "
              f"rtol {REMAT_GRAD_RTOL}; worst {grad_r[1]}), BatchNorm "
              f"statistics {stat_r[0]:.3g} of theirs ({REMAT_STAT_TOL}), "
              f"{len(tracked)} counters each at 1: {once} ({card})",
              flush=True)
        if not (loss_r[0] <= 1 and grad_r[0] <= 1 and stat_r[0] <= 1
                and once):
            raise AssertionError(f"phase 14 (b): the {name} step with remat "
                                 f"disagrees with the step without it")
        print(f"phase 14 (b) remat {name} b={b}: step "
              f"{on['ms']:.3f} ms with remat against {off['ms']:.3f} ms "
              f"without ({on['ms'] / off['ms']:.3f}x), peak memory "
              f"{on['peak_gib']:.2f} GiB against {off['peak_gib']:.2f} GiB "
              f"(median of {REMAT_TIMED_STEPS}; TF32 as phase 5; {card})",
              flush=True)
        out[name] = {("remat" if k else "plain"): dict(
            ms=r["ms"], peak_gib=r["peak_gib"], busy_ms=r.get("busy_ms"))
            for k, r in runs.items()}
        out[name]["agreement"] = dict(loss=loss_r[0], grads=grad_r[0],
                                      stats=stat_r[0])
        del runs, off, on
    launches = read("remat training")
    if not launches["soft_argmax_3d_fwd"] == launches[
            "soft_argmax_3d_bwd"] == steps:
        raise AssertionError(f"phase 14 (b): {steps} steps launched "
                             f"{launches} (the heads are not recomputed)")
    out["launches"] = launches
    # the largest power-of-two batch that steps, on rows of one big batch
    root_size, size = crop_sizes(cfg)
    big = synthetic_dream_batch(make_robot(cfg, device=device),
                                REMAT_PROBE_BATCHES[-1], size, root_size,
                                SEED + 14, device=device)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for remat in (False, True):
            model, step = make_train_step(
                dataclasses.replace(cfg, remat=remat), sd, device, dtype)
            fits, t0 = b, time.perf_counter()
            gen = torch.Generator(device=device).manual_seed(SEED)
            for n in REMAT_PROBE_BATCHES:
                oom = False
                try:
                    step(_rows(big, n), gen)
                    torch.cuda.synchronize()
                except torch.OutOfMemoryError:
                    oom = True
                if oom:
                    break
                fits = n
            del model, step
            gc.collect()
            torch.cuda.empty_cache()
            key = "remat" if remat else "plain"
            out[name][key]["max_batch"] = fits
            print(f"phase 14 (b) {name} {key}: the largest batch of "
                  f"{(b,) + REMAT_PROBE_BATCHES} that steps: {fits} "
                  f"({time.perf_counter() - t0:.1f} s; {card})", flush=True)
    del big
    return out


def phase14_crop(device, card: str, loader_img_s: float) -> dict:
    """The native crop against data/crop.py over CROP_FRAMES random 480x640
    frames and bboxes (inside the frame and partly outside it) to
    CROP_SIZE^2, both on the host: at most one level apart on at most
    CROP_MAX_OFF_BY_ONE of values; each one's time a frame; which library
    decodes; phase 9's loader rate beside it."""
    from horopose_tpu_torch import native
    from horopose_tpu_torch.data.crop import crop_resize_bilinear
    rng = np.random.RandomState(SEED + 140)
    frames = rng.randint(0, 256, (CROP_FRAMES, 480, 640, 3), dtype=np.uint8)
    boxes = []
    for i in range(CROP_FRAMES):
        w, h = rng.randint(40, 700), rng.randint(40, 520)
        x0, y0 = rng.randint(-w // 2, 640 - w // 2), rng.randint(
            -h // 2, 480 - h // 2)
        boxes.append([x0, y0, x0 + w, y0 + h])
    t0 = time.perf_counter()
    ours = np.stack([native.crop_resize_bilinear(f, bb, CROP_SIZE)
                     for f, bb in zip(frames, boxes)])
    native_ms = 1e3 * (time.perf_counter() - t0) / CROP_FRAMES
    t0 = time.perf_counter()
    plain = np.stack([crop_resize_bilinear(
        torch.from_numpy(f)[None], torch.tensor([bb]), CROP_SIZE)[0].numpy()
        for f, bb in zip(frames, boxes)])
    plain_ms = 1e3 * (time.perf_counter() - t0) / CROP_FRAMES
    diff = np.abs(ours.astype(np.int16) - plain)
    off = float((diff > 0).mean())
    outside = sum(bb[0] < 0 or bb[1] < 0 or bb[2] > 640 or bb[3] > 480
                  for bb in boxes)
    decoder = native.decoder()
    print(f"phase 14 (c) native crop vs data/crop.py, {CROP_FRAMES} frames "
          f"480x640 -> {CROP_SIZE}^2 ({outside} bboxes partly outside): max "
          f"{int(diff.max())} level(s), {off:.2e} of values off (<= "
          f"{CROP_MAX_OFF_BY_ONE}); host ms a frame: native {native_ms:.3f}, "
          f"data/crop.py {plain_ms:.3f}; JPEG decode by {decoder}; phase "
          f"9's loader with the native crop {loader_img_s:.1f} img/s "
          f"({card})", flush=True)
    if diff.max() > 1 or off > CROP_MAX_OFF_BY_ONE:
        raise AssertionError("phase 14 (c): the native crop disagrees with "
                             "data/crop.py")
    return dict(max_levels=int(diff.max()), off_share=off,
                native_ms=native_ms, plain_ms=plain_ms, decoder=decoder,
                loader_img_s=loader_img_s)


def demo_child_main(workdir: str, args) -> int:
    """Phase 14 (d)'s child (`chip_smoke.py --demo WORKDIR ARGS...`): the
    demo with ARGS under `deterministic_convs` (its first steps, from the
    JAX initialisers' zero root depth, are ill-conditioned: with cuDNN's
    defaults the same seed's loss fell in one run and rose in the next),
    then the soft-argmax wrappers' launches as one `demo launches {...}`
    line."""
    from horopose_tpu_torch.ops import integral_cuda
    from horopose_tpu_torch.scripts import demo_learn
    wrappers = {"soft_argmax_3d_fwd": integral_cuda.soft_argmax_3d_fwd,
                "soft_argmax_3d_bwd": integral_cuda.soft_argmax_3d_bwd}
    for fn in wrappers.values():
        fn.launches = 0
    with deterministic_convs():
        demo_learn.main(["--workdir", workdir, *args])
    print("demo launches " + json.dumps(
        {k: fn.launches for k, fn in wrappers.items()}), flush=True)
    return 0


def phase14_demo(tmp: str, card: str) -> dict:
    """`python -m horopose_tpu_torch.scripts.demo_learn` at DEMO_ARGS in a
    child process at full width on the card: it exits 0, prints a
    progression row for every epoch with a finite loss, the last epoch's
    mean training loss below the first's, and the soft-argmax launches its
    steps, validations and harness replay need."""
    import re
    workdir = os.path.join(tmp, "demo")
    log = os.path.join(tmp, "demo.log")
    t0 = time.perf_counter()
    proc = start_child([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                        "--demo", workdir, *DEMO_ARGS], child_env(), log)
    join_children([proc], [log], "phase 14 (d) demo", DEMO_TIMEOUT_S)
    wall = time.perf_counter() - t0
    with open(log, errors="replace") as f:
        text = f.read()
    rows = {int(m.group(1)): m.group(2) for m in re.finditer(
        r"^\s+epoch\s+(\d+): loss=(\S+)\s*(.*)$", text, re.M)}
    lines = [m.group(0).strip() for m in re.finditer(
        r"^\s+epoch\s+\d+: .*$", text, re.M)]
    epochs = int(DEMO_ARGS[DEMO_ARGS.index("--epochs") + 1])
    steps = epochs * (int(DEMO_ARGS[DEMO_ARGS.index("--n-train") + 1])
                      // int(DEMO_ARGS[DEMO_ARGS.index("--batch-size") + 1]))
    losses = [float(rows[e]) for e in sorted(rows)]
    replayed = "[demo] result/summary.txt:" in text
    launches = json.loads(text.rsplit("demo launches ", 1)[1].splitlines()[0])
    n_val = epochs          # 32 test frames: one batch of 32 an epoch
    want_fwd = steps + n_val + (1 + 2 * (FPS_ITERS + 1) if replayed else 0)
    for line in lines:
        print(f"phase 14 (d) {line}")
    print(f"phase 14 (d) demo {' '.join(DEMO_ARGS)} at full width: "
          f"{wall:.1f} s in its process, harness replayed: {replayed}, "
          f"launches {launches} (want fwd {want_fwd}, bwd {steps}) "
          f"({card})", flush=True)
    if replayed:
        summary = text.split("[demo] result/summary.txt:", 1)[1]
        print("phase 14 (d) summary.txt: " + " | ".join(
            line.strip() for line in summary.splitlines()[:12]
            if line.strip()), flush=True)
    elif "no best checkpoint was saved" not in text:
        raise AssertionError("phase 14 (d): neither a summary nor the "
                             "no-best-checkpoint line\n" + tail(log))
    if sorted(rows) != list(range(epochs)):
        raise AssertionError(f"phase 14 (d): progression rows for epochs "
                             f"{sorted(rows)}\n" + tail(log))
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"phase 14 (d): training losses {losses}")
    if launches != dict(soft_argmax_3d_fwd=want_fwd,
                        soft_argmax_3d_bwd=steps):
        raise AssertionError(f"phase 14 (d): launches {launches}")
    return dict(wall_s=wall, rows=lines, losses=losses, replayed=replayed,
                launches=launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "script runs on a CUDA card", file=sys.stderr)
        return 2
    from horopose_tpu_torch import cuda_build
    from horopose_tpu_torch.config import make_cfg
    from horopose_tpu_torch.data.synthetic import synthetic_dream_batch
    from horopose_tpu_torch.ops import conv3x3_cuda, integral_cuda
    from horopose_tpu_torch.pipelines.common import (FullNetConfig,
                                                     build_fullnet,
                                                     crop_sizes, make_robot,
                                                     random_state_dict)
    from horopose_tpu_torch.predictor import Predictor
    from horopose_tpu_torch.tools import bench_conv
    from horopose_tpu_torch.tools.bench_conv import card_info

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_info()
    print(card)                       # nvidia-smi's name, power limit
    print(f"device: {kind}, torch {torch.__version__}, cuda "
          f"{torch.version.cuda}", flush=True)
    # what the DREAM data path and a flax-checkpoint reader (msgpack)
    # could use on this machine
    found = {m: importlib.util.find_spec(m) is not None
             for m in ("PIL", "yaml", "cv2", "msgpack")}
    from horopose_tpu_torch import native
    t0 = time.perf_counter()
    decoder = native.decoder()
    print(f"machine: python {sys.version.split()[0]}, modules {found}, "
          f"{JPEG_HEADER} {os.path.exists(JPEG_HEADER)}; the native crop "
          f"built with g++ into {native.build()} "
          f"({time.perf_counter() - t0:.1f} s), JPEG decode by {decoder}",
          flush=True)

    # each phase's wall time, host clock
    laps = [time.perf_counter()]

    def lap(phase: str):
        now = time.perf_counter()
        print(f"phase {phase}: {now - laps[-1]:.1f} s (total "
              f"{now - laps[0]:.1f} s)", flush=True)
        laps.append(now)

    # every wrapper's launch count, set to 0 just before a path and read
    # just after it
    wrappers = {"soft_argmax_3d_fwd": integral_cuda.soft_argmax_3d_fwd,
                "soft_argmax_3d_bwd": integral_cuda.soft_argmax_3d_bwd,
                "conv3x3_nhwc": conv3x3_cuda.conv3x3_nhwc}
    path_launches = {}

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts(path: str) -> dict:
        path_launches[path] = {name: fn.launches
                               for name, fn in wrappers.items()}
        print(f"{path} path: launches {json.dumps(path_launches[path])}",
              flush=True)
        return path_launches[path]

    # ---- 2. build ----
    t0 = time.perf_counter()
    reports = cuda_build.build([integral_cuda.SOURCE, conv3x3_cuda.SOURCE])
    print(f"built {sorted(reports) or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    lap("1-2")

    # ---- 3. kernels against plain ----
    cfg = FullNetConfig()
    b_train = cfg.batch_size
    cell = CELL
    fwd_rows = check_soft_argmax(device, sam_fwd_cases(b_train), reps=20,
                                 card=card)
    bwd_rows = check_soft_argmax_bwd(device, sam_bwd_cases(b_train), reps=20,
                                     card=card)

    lap("3")

    # ---- 3c. the conv kernel, then its path: the bench entry point ----
    branch0 = (BRANCH0_HW, BRANCH0_HW, BRANCH0_CHANNELS, BRANCH0_CHANNELS)
    conv_target = list(bench_conv.SHAPE)
    conv_rows = check_conv(device, conv_cases(b_train), reps=20, card=card)
    reset_counts()
    bench = bench_conv.run(device=device, card=card)
    print(json.dumps(bench), flush=True)
    if read_counts("conv bench")["conv3x3_nhwc"] == 0:
        raise AssertionError("the conv bench launched no conv3x3_nhwc")

    lap("3c")

    # ---- 4. serving end to end at full width ----
    sd = random_state_dict(build_fullnet(cfg), SEED)
    predictors = {"float32": Predictor(cfg, sd, device=device),
                  "bfloat16": Predictor(cfg, sd, device=device,
                                        dtype=torch.bfloat16)}
    print(f"serving panda FullNet {cfg.backbone_name} + "
          f"{cfg.rootnet_backbone_name}, {cfg.image_size}^2 crops, depth_dim "
          f"{cfg.depth_dim}; cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}"
          f" (the default) for float32", flush=True)
    batches = (1, 8, 128)
    reset_counts()
    timings, forwards = serve(predictors, batches, {1: 20, 8: 5, 128: 5},
                              card)
    serve_launches = read_counts("serving")["soft_argmax_3d_fwd"]
    if serve_launches != forwards:
        raise AssertionError(f"soft_argmax_3d_fwd launched {serve_launches} "
                             f"times in {forwards} forwards")
    for name in predictors:
        print(f"{name}: b=1 latency {timings[(name, 1)]:.3f} ms, b=128 "
              f"throughput {128e3 / timings[(name, 128)]:.1f} img/s ({card})")
    for pred in predictors.values():
        for b in (1, 128):
            breakdown(pred, b, card)

    lap("4")

    # ---- 5. training end to end at full width ----
    root_size, size = crop_sizes(cfg)
    robot = make_robot(cfg, device=device)
    batch = synthetic_dream_batch(robot, b_train, size, root_size,
                                  SEED + 3, device=device)
    train_sd = training_state_dict(build_fullnet(cfg), cfg, robot, batch,
                                   SEED)
    print(f"training panda FullNet stage 2 at b={b_train}: lr {cfg.lr}, "
          f"{cfg.schedule_type} schedule, clip {cfg.clip_gradient}, dropout "
          f"{cfg.p_dropout}; cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} for float32", flush=True)
    reset_counts()
    train_ms, steps, _ = train(cfg, train_sd, batch, device, card)
    counts = read_counts("stage-2 training")
    fwd_launches = counts["soft_argmax_3d_fwd"]
    bwd_launches = counts["soft_argmax_3d_bwd"]
    if not fwd_launches == bwd_launches == steps:
        raise AssertionError(f"{steps} train steps launched "
                             f"soft_argmax_3d_fwd {fwd_launches} and "
                             f"soft_argmax_3d_bwd {bwd_launches} times")
    for name, ms in train_ms.items():
        print(f"train {name}: {ms:.3f} ms/step, "
              f"{1e3 * b_train / ms:.1f} img/s at b={b_train} "
              f"({card})")

    lap("5")

    # ---- 8. stage 1 at full width and its hand-off into stage 2 ----
    cfg1 = make_cfg(STAGE1_CONFIG)
    # the synthetic batches are made on the card: no copy to stage ahead,
    # so each gap of TimedLoader's stamps stays one step
    cfg1.prefetch_batches = 0
    print(f"stage 1: {STAGE1_CONFIG} read by the port's make_cfg: "
          f"{cfg1.backbone_name} DepthNet, {int(cfg1.image_size)}^2 crops, "
          f"b={cfg1.batch_size}, lr {cfg1.lr}, clip {cfg1.clip_gradient}, "
          f"use_schedule {cfg1.use_schedule}; cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} for float32", flush=True)
    stage1_runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            stage1_runs[name] = stage1(cfg1, device, dtype, card,
                                       os.path.join(tmp, name))
        read_counts("stage-1 training")
        for name, run in stage1_runs.items():
            row = next(r for r in conv_rows if r["dtype"] == name and
                       r["shape"] == [cfg1.batch_size, *branch0])
            fwd, bwd = run["branch0"]["forward"], run["branch0"]["backward"]
            print(f"stage 1 {name}: hrnet32 branch-0 3x3 convs "
                  f"[{cfg1.batch_size}, {BRANCH0_CHANNELS}, {BRANCH0_HW}, "
                  f"{BRANCH0_HW}] in one step, cuDNN: forward {fwd['ms']:.3f} "
                  f"ms over {fwd['count']} convs, backward {bwd['ms']:.3f} ms "
                  f"over {bwd['count']}; the conv kernel at that shape "
                  f"{row['device_ms']:.4f} ms a forward conv on the device "
                  f"(phase 3c; cuDNN alone {row['library_device_ms']:.4f} "
                  f"ms), {fwd['count'] * row['device_ms']:.3f} ms for the "
                  f"{fwd['count']} forwards ({card})", flush=True)
            if fwd["count"] == 0 or bwd["count"] == 0:
                raise AssertionError("no branch-0 conv rows in the profile")
        reset_counts()
        handoff(stage1_runs["float32"]["ckpt"], device, card)
        counts = read_counts("stage-1 to stage-2 hand-off")
        if not (counts["soft_argmax_3d_fwd"] == counts["soft_argmax_3d_bwd"]
                == 2):
            raise AssertionError(f"2 stage-2 steps after the hand-off "
                                 f"launched {counts}")

    lap("8")

    # ---- 9. stage 2 from DREAM-layout files at full width ----
    from horopose_tpu_torch.pipelines.common import get_dataloaders
    cfg2 = make_cfg(STAGE2_CONFIG)
    # phase 9's files stay for phase 13
    phase9_dir = tempfile.TemporaryDirectory()
    tmp = phase9_dir.name
    train_dir, test_dir = write_dream_sets(tmp, card)
    cfg2.train_ds_names = train_dir
    cfg2.epoch_size = STAGE2_TRAIN_FRAMES
    loaders = get_dataloaders(cfg2, device)
    print(f"stage 2 from files: {STAGE2_CONFIG} read by make_cfg, "
          f"{cfg2.backbone_name} + {cfg2.rootnet_backbone_name}, "
          f"{int(cfg2.image_size)}^2 crops, b={cfg2.batch_size}, "
          f"{cfg2.n_dataloader_workers} loader workers, prefetch "
          f"{cfg2.prefetch_batches}, augmentations jitter "
          f"{cfg2.jitter} occlusion {cfg2.occlusion} pillow "
          f"{cfg2.other_aug}; float32 with cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    loader_alone = time_loader(loaders["train"], card)
    period = 1e3 * cfg2.batch_size / loader_alone["img_s"]
    print(f"steady state at b={cfg2.batch_size}: the loader makes a "
          f"batch every {period:.1f} ms, a step on a batch already on "
          f"the card takes {train_ms['float32']:.1f} ms (phase 5): "
          f"{'loader' if period > train_ms['float32'] else 'step'}-"
          f"bound ({card})", flush=True)
    reset_counts()
    run = stage2_train(cfg2, loaders, device, card,
                       os.path.join(tmp, "experiments"))
    counts = read_counts("stage-2 from files")
    n_steps = len(loaders["train"])
    n_val = len(loaders["test"]["dr"])
    if not (counts["soft_argmax_3d_fwd"] == n_steps + n_val
            and counts["soft_argmax_3d_bwd"] == n_steps):
        raise AssertionError(f"{n_steps} train steps and {n_val} "
                             f"validation batches launched {counts}")
    files = stage2_measure(cfg2, run, loaders, device, card,
                           train_ms["float32"])
    reset_counts()
    harness = stage2_test(run, test_dir, device, card)
    counts = read_counts("test harness")
    n_test = -(-STAGE2_TEST_FRAMES // TEST_BATCH)
    want = n_test + 2 * (FPS_ITERS + 1)
    if not (counts["soft_argmax_3d_fwd"] == want
            and counts["soft_argmax_3d_bwd"] == 0):
        raise AssertionError(f"test_network: {n_test} batches and "
                             f"2 x {FPS_ITERS + 1} timed forwards "
                             f"launched {counts}")
    stage2_folder = run["folder"]
    stage2_ckpt = os.path.join(stage2_folder, "ckpt",
                               "trained_weights.pk")
    loader_close_s = {"phase 9": close_loaders(loaders, "phase 9", card)}
    del run, loaders
    collect_garbage("after phase 9", card)

    lap("9")

    # ---- 10. stage 3 (sim2real) at full width ----
    cfg3, loaders3, teacher = stage3_setup(tmp, stage2_ckpt, device,
                                           card)
    lap("10 set-up")
    reset_counts()
    run3 = stage3_train(cfg3, loaders3, teacher, device, card,
                        os.path.join(tmp, "experiments"))
    counts = read_counts("stage 3")
    lap("10 epoch")
    n_steps3 = len(loaders3["train"])
    n_val3 = -(-STAGE3_FRAMES // int(cfg3.batch_size))
    # the tracked-view pass and the validation each run the forward
    # once a batch; the tracked renders once for the <= 20 views
    want3 = dict(soft_argmax_3d_fwd=n_steps3 + 2 * n_val3 + 1,
                 soft_argmax_3d_bwd=n_steps3)
    if any(counts[k] != v for k, v in want3.items()):
        raise AssertionError(f"stage 3: {n_steps3} steps, {n_val3} "
                             f"validation batches: launches {counts}, "
                             f"want {want3}")
    stage3 = stage3_measure(cfg3, run3, loaders3, teacher, device, card,
                            lap)
    cross = compare_sim2real_card_cpu(cfg3, loaders3, stage2_ckpt,
                                      device, card)
    lap("10 card vs CPU")
    stage3.update(epoch_s=run3["epoch_s"], launches=counts, cross=cross)
    loader_close_s["phase 10"] = close_loaders(loaders3, "phase 10", card)
    del run3, loaders3, teacher
    collect_garbage("after phase 10", card)

    lap("10")

    # ---- 11. the variant FullNets at full width, the harness's plots
    # and profile, a rendered frame ----
    flagship_ms = {b: timings[("float32", b)] for b in (1, 128)}
    variants = {}
    for name, flags in VARIANTS.items():
        variants[name] = phase11_variant(
            name, cfg, flags, batch, device, card, flagship_ms,
            (reset_counts, read_counts))
        lap(f"11 {name}")
    reset_counts()
    plots = phase11_harness(stage2_folder, stage2_ckpt, test_dir, tmp,
                            device, card)
    counts = read_counts("test harness with plots")
    # the batches, the timed forwards, and the best and worst cases
    want = n_test + 2 * (FPS_ITERS + 1) + 2
    if counts["soft_argmax_3d_fwd"] != want:
        raise AssertionError(f"test_network with the plots launched "
                             f"{counts}, want {want} forwards")
    collect_garbage("after phase 11", card)

    lap("11")

    # ---- 12. the user URDF, the reference's weight files through the
    # converter, and the exported serving forward, at full width ----
    with tempfile.TemporaryDirectory() as tmp12:
        phase12 = dict(urdf=phase12_urdf(cfg, device, card, tmp12))
        lap("12 URDF")
        phase12.update(convert=phase12_convert(
            cfg, sd, predictors["float32"], device, card, tmp12))
        lap("12 convert")
        phase12.update(export=phase12_export(
            cfg, sd, predictors["float32"], device, card, tmp12,
            (reset_counts, read_counts), timings[("float32", 128)]))
        phase12.update(dispatch_us=phase12_dispatch(device, card))
    collect_garbage("after phase 12", card)

    lap("12")

    # ---- 13. data parallelism over torch.distributed, on phase 9's files
    # and phase 5's batch and weights ----
    t13 = time.perf_counter()
    config13 = phase13_config(tmp, train_dir)
    cli, cli_out = phase13_torchrun(config13, tmp), {}
    try:
        world1 = phase13_world1(
            make_cfg(config13), device, card, tmp, (reset_counts, read_counts),
            lambda: cli_out.update(phase13_check_torchrun(*cli, card, t13)))
    except BaseException:
        kill_children([cli[0]])
        raise
    phase13 = dict(cli=cli_out, world1=world1)
    lap("13 (a)")
    phase13.update(two_ranks=phase13_two_ranks(
        cfg, train_sd, batch, config13, device, card, tmp))
    path_launches.update({f"data-parallel gloo {k}": v for k, v in
                          phase13["two_ranks"]["launches_per_rank"].items()})
    phase9_dir.cleanup()
    collect_garbage("after phase 13", card)
    phase13["wall_s"] = time.perf_counter() - t13
    print(f"phase 13 took {phase13['wall_s']:.1f} s ({card})", flush=True)

    lap("13")

    # ---- 14. the learning demo's slice: the memorization regression,
    # cfg.remat at full width, the native crop, the demo ----
    t14 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp14:
        memo_dir = os.path.join(tmp14, "memo")
        os.makedirs(memo_dir)
        reset_counts()
        # float32 as the JAX test's CPU run: TF32 off, and cuDNN's
        # deterministic algorithms, without which the same seed gives
        # another trajectory each run (PERF.md §6)
        with deterministic_convs():
            memo = memorization_run(memo_dir, device, card)
        counts = read_counts("memorization regression")
        want = dict(soft_argmax_3d_fwd=memo["steps"] + memo["eval_forwards"],
                    soft_argmax_3d_bwd=memo["steps"])
        best, best_bs = max(memo["aucs"].values()), max(
            memo["aucs_batch_stats"].values())
        print(f"phase 14 (a) memorization regression: {memo['steps']} steps "
              f"in {memo['wall_s']:.1f} s, loss {memo['loss_first']:.4f} -> "
              f"{memo['loss_last']:.4f}; best ADD AUC with batch statistics "
              f"{best_bs:.4f} (>= {MEMO_BATCH_STATS_AUC}), with running "
              f"statistics {best:.4f} (>= {MEMO_RUNNING_AUC}) ({card})",
              flush=True)
        if any(counts[k] != v for k, v in want.items()):
            raise AssertionError(f"phase 14 (a): launches {counts}, want "
                                 f"{want}")
        if best_bs < MEMO_BATCH_STATS_AUC or best < MEMO_RUNNING_AUC:
            raise AssertionError(f"phase 14 (a): ADD AUC {memo['aucs']} "
                                 f"(running), {memo['aucs_batch_stats']} "
                                 f"(batch statistics)")
        lap("14 (a)")
        remat = phase14_remat(cfg, train_sd, batch, device, card,
                              (reset_counts, read_counts))
        lap("14 (b)")
        crop = phase14_crop(device, card, loader_alone["img_s"])
        lap("14 (c)")
        demo = phase14_demo(tmp14, card)
        path_launches["demo_learn (its process)"] = dict(
            demo["launches"], conv3x3_nhwc=0)
        lap("14 (d)")
    collect_garbage("after phase 14", card)
    phase14 = dict(memorization=memo, remat=remat, native_crop=crop,
                   demo=demo, wall_s=time.perf_counter() - t14)
    print(f"phase 14 took {phase14['wall_s']:.1f} s ({card})", flush=True)

    lap("14")

    # ---- 6. float32 comparisons, TF32 off everywhere ----
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    # the forward with the kernel against the plain soft-argmax and the CPU
    compare_forwards(predictors["float32"], Predictor(cfg, sd, device="cpu"))
    del predictors
    compare_train_steps(cfg, train_sd, batch, device)
    compare_train_card_cpu(cfg, device, SEED + 4)
    compare_depthnet_card_cpu(cfg1, device, SEED + 5)

    lap("6")

    # ---- 7. summary ----
    def kernel_line(name, source, replaces, rows, launches, shape, tol,
                    **extra):
        """The kernel's row at `shape` in bfloat16, its errors per dtype
        beside their tolerances, and its timings at the other shapes."""
        row = next(r for r in rows if r["shape"] == shape
                   and r["dtype"] == "bfloat16" and not r.get("kind"))
        errors = {}
        for dt in ("float32", "bfloat16"):
            rs = [r for r in rows if r["dtype"] == dt]
            errors[dt] = dict(tol[dt], **{
                k: max(r[k] for r in rs) for k in
                ("max_abs_err", "max_err_over_tol", "l2_rel_err",
                 "library_rel_err") if k in row})
        timed = ("shape", "dtype", "kind", "ms", "device_ms", "host_ms",
                 "plain_ms", "library_ms", "library_device_ms", "bound_ms",
                 "bound_share")
        timings = [{k: r[k] for k in timed if k in r}
                   for r in rows if r is not row]
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches,
                    max_abs_err=row["max_abs_err"], ms=row["ms"],
                    device_ms=row["device_ms"], host_ms=row["host_ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], bound_share=row["bound_share"],
                    library_ms=row.get("library_ms"),
                    library_device_ms=row.get("library_device_ms"),
                    shape=row["shape"], dtype=row["dtype"],
                    errors_by_dtype=errors, other_shapes=timings,
                    launches_by_path={path: c[name] for path, c
                                      in path_launches.items()},
                    card=card, **extra)

    sam_src = "horopose_tpu_torch/csrc/soft_argmax.cu"
    uvd_tol = {dt: dict(tol_abs=UVD_TOL) for dt in ("float32", "bfloat16")}
    dx_tol = {str(dt).split(".")[-1]: dict(tol_terms_rtol=DX_TERMS_RTOL,
                                           tol_round_rtol=r)
              for dt, r in DX_ROUND_RTOL.items()}
    conv_tol = {str(dt).split(".")[-1]: dict(
        tol_rel_max=CONV_F32_REL, tol_round_rtol=r,
        tol_library_rel=CONV_LIB_REL[dt]) for dt, r in CONV_ROUND_RTOL.items()}
    b0_row = next(r for r in conv_rows if r["dtype"] == "bfloat16"
                  and r["shape"] == [b_train, *branch0])
    print(json.dumps({"kernels": [
        kernel_line("soft_argmax_3d_fwd", sam_src,
                    "horopose_tpu/ops/integral_pallas.py:25", fwd_rows,
                    fwd_launches, [128, *cell], uvd_tol,
                    device_kernels=["soft_argmax_3d_fwd_kernel",
                                    "soft_argmax_3d_merge_kernel"],
                    stage2_from_files=dict(loader_alone=loader_alone,
                                           **files, test=harness),
                    stage3=stage3, variants=variants,
                    harness_with_plots=plots,
                    loader_close_s=loader_close_s, weights_and_export=phase12,
                    data_parallel=phase13, learning_slice=phase14),
        kernel_line("soft_argmax_3d_bwd", sam_src,
                    "horopose_tpu/ops/integral_pallas.py:56", bwd_rows,
                    bwd_launches, [b_train, *cell], dx_tol),
        kernel_line("conv3x3_nhwc", "horopose_tpu_torch/csrc/conv3x3.cu",
                    "horopose_tpu/ops/conv_pallas.py:50", conv_rows,
                    path_launches["conv bench"]["conv3x3_nhwc"], conv_target,
                    conv_tol, bench=bench,
                    branch0_vs_cudnn=dict(
                        shape=b0_row["shape"], dtype="bfloat16",
                        device_ms=b0_row["device_ms"],
                        cudnn_device_ms=b0_row["library_device_ms"],
                        speedup=b0_row["library_device_ms"]
                        / b0_row["device_ms"]),
                    stage1_branch0_cudnn={n: r["branch0"]
                                          for n, r in stage1_runs.items()})]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--dp-rank":
        sys.exit(dp_rank_main(sys.argv[2]))
    if len(sys.argv) >= 3 and sys.argv[1] == "--demo":
        sys.exit(demo_child_main(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
