#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`horopose_tpu_torch`) on one CUDA card.

Run from the repository root on a machine with an H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. the card: its name and power limit (nvidia-smi), and what the data
     path and a flax-checkpoint reader could use on the machine (PIL,
     yaml, cv2, msgpack, libjpeg's header);
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
     `pipelines.train_depthnet` for one epoch of 12 steps on synthetic
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
  7. one JSON line describing every kernel, and as the last line
     {"ok": true, "device": {...}}.

They run in the order 1-5, 8, 9, 10, 11, 6, 7: phases 8-11 keep cuDNN's
default TF32 for float32, as phases 4 and 5 do (phase 11's comparisons
turn it off for themselves), and phase 8's b=2 comparison runs with
phase 6's. Each phase prints its wall time. Phases 9 and 10 close their
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
STAGE1_STEPS, STAGE1_WARMUP, STAGE1_VAL_BATCHES = 12, 2, 2
# phase 9: DREAM-layout sets written from a seed, 480x640 noise JPEGs; the
# train set is one epoch of 6 steps at b=64, the test set 150 frames, so
# its last batch is partial at b=64 (64 + 64 + 22) and at b=128 (128 + 22)
STAGE2_TRAIN_FRAMES, STAGE2_TEST_FRAMES, TEST_BATCH = 384, 150, 128
# test_network's forward timing (pipelines/test.py::measure_forward_fps,
# 10 calls after one warm-up): "all" and "other" each launch the
# soft-argmax forward once a call
FPS_ITERS = 10
# libjpeg's header, which the JAX package's native decoder builds against
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
VARIANT_SERVE_REPS = {1: 20, 128: 5}
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
    print(f"machine: python {sys.version.split()[0]}, modules {found}, "
          f"{JPEG_HEADER} {os.path.exists(JPEG_HEADER)}", flush=True)

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
    with tempfile.TemporaryDirectory() as tmp:
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
                    loader_close_s=loader_close_s),
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
    sys.exit(main())
