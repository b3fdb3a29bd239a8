#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`horopose_tpu_torch`) on one CUDA card.

Run from the repository root on a machine with an H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. the card: its name and power limit (nvidia-smi);
  2. build every hand-written kernel from `horopose_tpu_torch/csrc/` with
     nvcc for sm_90a, one nvcc per source, all started together;
  3. each kernel against its plain PyTorch version on the card, at the
     serving and training shapes in float32 and bfloat16 and at a ragged
     shape, timed with CUDA events beside its bound: the soft-argmax
     forward (with the (max, sum) it saves) and backward (each dx entry
     against a bound scaled to that entry, and in L2);
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
  7. one JSON line describing every kernel, and as the last line
     {"ok": true, "device": {...}}.

It exits non-zero with no result when no CUDA device is present.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
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
SEED = 0
# configs/panda/full.yaml: epoch_size 104950 images at batch 64
STEPS_PER_EPOCH = 104950 // 64


def card_info() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


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


def check_soft_argmax(device, shapes, reps: int):
    """Kernel against plain on the same inputs; returns one row per case."""
    from horopose_tpu_torch.ops.integral import soft_argmax_3d_fwd_plain
    from horopose_tpu_torch.ops.integral_cuda import soft_argmax_3d_fwd
    g = torch.Generator(device=device).manual_seed(SEED)
    rows = []
    for shape, dtype in shapes:
        B, K, D, H, W = shape
        x = (3 * torch.randn(B * K, D, H, W, generator=g, device=device)
             ).to(dtype)
        uvd, e, st = soft_argmax_3d_fwd(x)
        uvd_p, e_p, st_p = soft_argmax_3d_fwd_plain(x)  # reads the same values
        torch.cuda.synchronize()
        err_uvd = float((uvd - uvd_p).abs().max())
        err_e = float((e - e_p).abs().max())
        err_m = float((st[:, 0] - st_p[:, 0]).abs().max())
        rel_s = float(((st[:, 1] - st_p[:, 1]).abs() / st_p[:, 1]).max())
        if not (err_uvd <= UVD_TOL and err_e <= E_TOL and err_m == 0.0
                and rel_s <= S_REL_TOL):
            raise AssertionError(f"soft_argmax {shape} {dtype}: |duvd| "
                                 f"{err_uvd} |dE| {err_e} |dm| {err_m} "
                                 f"rel ds {rel_s}")
        bound, bound_by = soft_argmax_bound_ms(x)
        row = dict(shape=list(shape), dtype=str(dtype).split(".")[-1],
                   max_abs_err=err_uvd, max_abs_err_E=err_e,
                   max_abs_err_m=err_m, max_rel_err_s=rel_s,
                   ms=time_ms(lambda: soft_argmax_3d_fwd(x), reps),
                   plain_ms=time_ms(lambda: soft_argmax_3d_fwd_plain(x), reps),
                   bound_ms=bound, bound_by=bound_by)
        rows.append(row)
        print("soft_argmax_3d_fwd", json.dumps(row), flush=True)
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


def check_soft_argmax_bwd(device, cases, reps: int):
    """The backward kernel against its plain version on the same (x, E,
    (m, s), g); a case may put a row of -inf logits in its first cell.
    Returns one row per case."""
    from horopose_tpu_torch.ops.integral import soft_argmax_3d_bwd_plain
    from horopose_tpu_torch.ops.integral_cuda import (soft_argmax_3d_bwd,
                                                      soft_argmax_3d_fwd)
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    rows = []
    for shape, dtype, with_inf in cases:
        B, K, D, H, W = shape
        x = (3 * torch.randn(B * K, D, H, W, generator=gen, device=device)
             ).to(dtype)
        if with_inf:
            x[0, 0, 0] = float("-inf")
        g = torch.randn(B * K, 3, generator=gen, device=device)
        _, e, st = soft_argmax_3d_fwd(x)
        dx = soft_argmax_3d_bwd(x, e, st, g)
        dx_p = soft_argmax_3d_bwd_plain(x, e, st, g)
        torch.cuda.synchronize()
        errs = compare_dx(x, e, st, g, dx, dx_p,
                          f"soft_argmax_3d_bwd {shape} {dtype}")
        bound, bound_by = soft_argmax_bwd_bound_ms(x)
        row = dict(shape=list(shape), dtype=str(dtype).split(".")[-1],
                   minus_inf=with_inf, **errs,
                   ms=time_ms(lambda: soft_argmax_3d_bwd(x, e, st, g), reps),
                   plain_ms=time_ms(
                       lambda: soft_argmax_3d_bwd_plain(x, e, st, g), reps),
                   bound_ms=bound, bound_by=bound_by)
        rows.append(row)
        print("soft_argmax_3d_bwd", json.dumps(row), flush=True)
        del x, g, e, st, dx, dx_p
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


def breakdown(pred, b: int, card: str):
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
    print(f"breakdown {pred.model.dtype} b={b}: preprocess "
          f"{1e3 * (t1 - t0):.3f} ms, forward {1e3 * (t2 - t1):.3f} ms "
          f"(host clock); device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f}); soft_argmax kernel "
          f"{sam_ms:.3f} ms; {len(events)} distinct kernels ({card})")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5} "
              f"{e.key[:90]}")


def compare_forwards(pred, cpu_pred):
    """The same float32 forward three ways: with the kernel, with the plain
    soft-argmax (use_kernel=False), and on the CPU (2 of the 8 rows)."""
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
    for key in ("uvd", "xyz_int", "xyz_fk"):
        same = rel_err(out_kernel[key], out_plain[key])
        cross = rel_err(out_kernel[key][:2], out_cpu[key])
        print(f"f32 forward {key}: kernel vs plain rel_err {same:.3e} "
              f"(<= {SAME_DEVICE_REL}), card vs CPU rel_err {cross:.3e} "
              f"(<= {CROSS_DEVICE_REL})", flush=True)
        if not (same <= SAME_DEVICE_REL and cross <= CROSS_DEVICE_REL):
            raise AssertionError(f"f32 forward {key} disagrees")


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
    from horopose_tpu_torch.models.resnet import BasicBlock, Bottleneck
    from horopose_tpu_torch.pipelines.common import random_state_dict
    sd = random_state_dict(model, seed)
    for name, m in model.named_modules():
        if isinstance(m, (Bottleneck, BasicBlock)):
            last = "bn3" if isinstance(m, Bottleneck) else "bn2"
            sd[f"{name}.{last}.weight"] *= 0.1
    gts = prepare_gt(cfg, robot, batch)
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


def train(cfg, sd, batch, device, card, warmup: int = 2, reps: int = 10):
    """Train steps through `build_full_train_step` in float32 and bfloat16:
    timed on the host clock, each ending in a synchronise; every loss must
    be finite. Returns ({dtype name: ms per step}, steps run)."""
    timings, steps = {}, 0
    b = batch["TCO"].shape[0]
    for dtype in (torch.float32, torch.bfloat16):
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
            raise AssertionError(f"train {name}: non-finite losses {losses}")
        ms = 1e3 * statistics.median(times[warmup:])
        timings[name] = ms
        print(f"train {name} b={b}: {ms:.3f} ms/step, "
              f"{1e3 * b / ms:.1f} img/s (median of {reps} after "
              f"{warmup} warm-up); loss {float(losses[0, 0]):.4f} -> "
              f"{float(losses[-1, 0]):.4f}; peak memory "
              f"{torch.cuda.max_memory_allocated(device) / 2 ** 30:.2f} GiB "
              f"({card})", flush=True)
        steps += train_breakdown(step, batch, gen, f"{name} b={b}", ms, card)
        del model, step, logs, losses
    return timings, steps


def train_breakdown(step, batch, gen, label: str, step_ms: float,
                    card: str) -> int:
    """torch.profiler trace of one train step: the device's busy time
    against the unprofiled median step time and against the profiled
    step's wall time, the top kernels and both soft-argmax kernels.
    Returns the number of steps it ran (1)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(batch, gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side events only, and not the user-annotated ranges (such as
    # Optimizer.step) that span the kernels they launch
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3

    def kernel_ms(name):
        return sum(e.self_device_time_total for e in events
                   if name in e.key) / 1e3

    print(f"train breakdown {label}: device busy {busy_ms:.3f} ms of a "
          f"{step_ms:.3f} ms step (idle share {1 - busy_ms / step_ms:.3f}; "
          f"{wall_ms:.3f} ms under the profiler); soft_argmax_3d_fwd "
          f"{kernel_ms('soft_argmax_3d_fwd'):.3f} ms, soft_argmax_3d_bwd "
          f"{kernel_ms('soft_argmax_3d_bwd'):.3f} ms; {len(events)} distinct "
          f"kernels ({card})", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5} "
              f"{e.key[:90]}")
    return 1


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


def compare_train_card_cpu(cfg, device, seed: int):
    """One float32 train step at b=2 with dropout off on the card and on
    the CPU, same weights and batch."""
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
        on_dev = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.to(dev))
                  for k, v in batch.items()}
        model, step = make_train_step(cfg, sd, dev)
        logs = step(on_dev, None)
        out.append(({k: float(v) for k, v in logs.items()}, _grads(model)))
        del model, step
    (card_logs, card_grads), (cpu_logs, cpu_grads) = out
    loss_rel = _loss_rel(card_logs, cpu_logs)
    cos = _cosine(card_grads, cpu_grads)
    print(f"f32 train step b=2: card vs CPU: losses rel_err {loss_rel:.3e} "
          f"(<= {CROSS_LOSS_REL}), gradient cosine {cos:.8f} "
          f"(> {CROSS_GRAD_COSINE})", flush=True)
    if not (loss_rel <= CROSS_LOSS_REL and cos > CROSS_GRAD_COSINE):
        raise AssertionError("train step on the card disagrees with the CPU")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "script runs on a CUDA card", file=sys.stderr)
        return 2
    from horopose_tpu_torch import cuda_build
    from horopose_tpu_torch.data.synthetic import synthetic_dream_batch
    from horopose_tpu_torch.ops import integral_cuda
    from horopose_tpu_torch.pipelines.common import (FullNetConfig,
                                                     build_fullnet,
                                                     crop_sizes, make_robot,
                                                     random_state_dict)
    from horopose_tpu_torch.predictor import Predictor

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_info()
    print(card)                       # nvidia-smi's name, power limit
    print(f"device: {kind}, torch {torch.__version__}, cuda "
          f"{torch.version.cuda}", flush=True)

    # ---- 2. build ----
    t0 = time.perf_counter()
    reports = cuda_build.build([integral_cuda.SOURCE])
    print(f"built {sorted(reports) or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # ---- 3. kernels against plain ----
    cfg = FullNetConfig()
    b_train = cfg.batch_size
    cell = (7, 64, 64, 64)            # 7 keypoints, a 64^3 heatmap each
    fwd_rows = check_soft_argmax(device, [
        ((1, *cell), torch.float32), ((1, *cell), torch.bfloat16),
        ((128, *cell), torch.float32), ((128, *cell), torch.bfloat16),
        ((b_train, *cell), torch.float32),
        ((b_train, *cell), torch.bfloat16),
        ((2, 3, 5, 7, 9), torch.float32)], reps=20)
    bwd_rows = check_soft_argmax_bwd(device, [
        ((1, *cell), torch.float32, False),
        ((1, *cell), torch.bfloat16, False),
        ((b_train, *cell), torch.float32, False),
        ((b_train, *cell), torch.bfloat16, False),
        ((2, 3, 5, 7, 9), torch.float32, True)], reps=20)

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
    integral_cuda.soft_argmax_3d_fwd.launches = 0
    timings, forwards = serve(predictors, batches, {1: 20, 8: 5, 128: 5},
                              card)
    serve_launches = integral_cuda.soft_argmax_3d_fwd.launches
    if serve_launches != forwards:
        raise AssertionError(f"soft_argmax_3d_fwd launched {serve_launches} "
                             f"times in {forwards} forwards")
    print(f"serving path: {forwards} forwards, soft_argmax_3d_fwd launches "
          f"{serve_launches}", flush=True)
    for name in predictors:
        print(f"{name}: b=1 latency {timings[(name, 1)]:.3f} ms, b=128 "
              f"throughput {128e3 / timings[(name, 128)]:.1f} img/s ({card})")
    for pred in predictors.values():
        for b in (1, 128):
            breakdown(pred, b, card)

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
    integral_cuda.soft_argmax_3d_fwd.launches = 0
    integral_cuda.soft_argmax_3d_bwd.launches = 0
    train_ms, steps = train(cfg, train_sd, batch, device, card)
    fwd_launches = integral_cuda.soft_argmax_3d_fwd.launches
    bwd_launches = integral_cuda.soft_argmax_3d_bwd.launches
    if not fwd_launches == bwd_launches == steps:
        raise AssertionError(f"{steps} train steps launched "
                             f"soft_argmax_3d_fwd {fwd_launches} and "
                             f"soft_argmax_3d_bwd {bwd_launches} times")
    print(f"training path: {steps} steps, soft_argmax_3d_fwd launches "
          f"{fwd_launches}, soft_argmax_3d_bwd launches {bwd_launches}",
          flush=True)
    for name, ms in train_ms.items():
        print(f"train {name}: {ms:.3f} ms/step, "
              f"{1e3 * b_train / ms:.1f} img/s at b={b_train} "
              f"({card})")

    # ---- 6. float32 comparisons, TF32 off everywhere ----
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    # the forward with the kernel against the plain soft-argmax and the CPU
    compare_forwards(predictors["float32"], Predictor(cfg, sd, device="cpu"))
    del predictors
    compare_train_steps(cfg, train_sd, batch, device)
    compare_train_card_cpu(cfg, device, SEED + 4)

    # ---- 7. summary ----
    def kernel_line(name, replaces, rows, launches, shape, tol, **extra):
        """The kernel's row at `shape` in bfloat16 (the forward's serving
        shape, the backward's training shape), its errors per dtype beside
        their tolerances, and its timings at the other shapes."""
        row = next(r for r in rows
                   if r["shape"] == shape and r["dtype"] == "bfloat16")
        errors = {}
        for dt in ("float32", "bfloat16"):
            rs = [r for r in rows if r["dtype"] == dt]
            errors[dt] = dict(tol[dt], **{
                k: max(r[k] for r in rs) for k in
                ("max_abs_err", "max_err_over_tol", "l2_rel_err") if k in row})
        timings = [{k: r[k] for k in ("shape", "dtype", "ms", "plain_ms",
                                      "bound_ms")}
                   for r in rows if r is not row]
        return dict(name=name, route="cuda",
                    source="horopose_tpu_torch/csrc/soft_argmax.cu",
                    replaces=replaces, launches=launches,
                    max_abs_err=row["max_abs_err"], ms=row["ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], library_ms=None,
                    shape=row["shape"], dtype=row["dtype"],
                    errors_by_dtype=errors, other_shapes=timings, **extra)

    uvd_tol = {dt: dict(tol_abs=UVD_TOL) for dt in ("float32", "bfloat16")}
    dx_tol = {str(dt).split(".")[-1]: dict(tol_terms_rtol=DX_TERMS_RTOL,
                                           tol_round_rtol=r)
              for dt, r in DX_ROUND_RTOL.items()}
    print(json.dumps({"kernels": [
        kernel_line("soft_argmax_3d_fwd",
                    "horopose_tpu/ops/integral_pallas.py:25", fwd_rows,
                    fwd_launches, [128, *cell], uvd_tol,
                    launches_serving=serve_launches),
        kernel_line("soft_argmax_3d_bwd",
                    "horopose_tpu/ops/integral_pallas.py:56", bwd_rows,
                    bwd_launches, [b_train, *cell], dx_tol)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
