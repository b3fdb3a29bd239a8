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
     serving shapes in float32 and bfloat16 and at a ragged shape, timed
     with CUDA events beside its bound;
  4. serving end to end at full width: the panda flagship FullNet (resnet50
     reg + hrnet32 rootnet backbones, 256x256 crops, depth_dim 64) with
     random weights from a seed, answering requests of synthetic 480x640
     frames at b=1, 8 and 128 in float32 and bfloat16; the kernel's launch
     count must rise by one per forward; a breakdown of one request's time
     (host clock and a torch.profiler trace); then the float32 forward with
     the kernel against the same forward with the plain soft-argmax, and
     the card's forward against the CPU's;
  5. one JSON line describing every kernel, and as the last line
     {"ok": true, "device": {...}}.

It exits non-zero with no result when no CUDA device is present.
"""

from __future__ import annotations

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

UVD_TOL = 1e-5          # |uvd| is at most 0.5; f32 sums in another order
E_TOL = 1e-3            # index units, up to 63
SAME_DEVICE_REL = 1e-4  # kernel forward vs plain forward, one card, f32
CROSS_DEVICE_REL = 1e-3  # card vs CPU: other conv algorithms, 150+ layers
SEED = 0


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
    bytes_moved = x.numel() * x.element_size() + 2 * x.shape[0] * 3 * 4
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
        uvd, e = soft_argmax_3d_fwd(x)
        uvd_p, e_p = soft_argmax_3d_fwd_plain(x)   # reads the same values
        torch.cuda.synchronize()
        err_uvd = float((uvd - uvd_p).abs().max())
        err_e = float((e - e_p).abs().max())
        if not (err_uvd <= UVD_TOL and err_e <= E_TOL):
            raise AssertionError(f"soft_argmax {shape} {dtype}: |duvd| "
                                 f"{err_uvd} |dE| {err_e}")
        bound, bound_by = soft_argmax_bound_ms(x)
        row = dict(shape=list(shape), dtype=str(dtype).split(".")[-1],
                   max_abs_err=err_uvd, max_abs_err_E=err_e,
                   ms=time_ms(lambda: soft_argmax_3d_fwd(x), reps),
                   plain_ms=time_ms(lambda: soft_argmax_3d_fwd_plain(x), reps),
                   bound_ms=bound, bound_by=bound_by)
        rows.append(row)
        print("soft_argmax_3d_fwd", json.dumps(row), flush=True)
        del x, uvd, e, uvd_p, e_p
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "script runs on a CUDA card", file=sys.stderr)
        return 2
    from horopose_tpu_torch import cuda_build
    from horopose_tpu_torch.ops import integral_cuda
    from horopose_tpu_torch.pipelines.common import (FullNetConfig,
                                                     build_fullnet,
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

    # ---- 3. kernel against plain ----
    serving = (7, 64, 64, 64)
    rows = check_soft_argmax(device, [
        ((1, *serving), torch.float32), ((1, *serving), torch.bfloat16),
        ((128, *serving), torch.float32), ((128, *serving), torch.bfloat16),
        ((2, 3, 5, 7, 9), torch.float32)], reps=20)

    # ---- 4. serving end to end at full width ----
    cfg = FullNetConfig()
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
    launches = integral_cuda.soft_argmax_3d_fwd.launches
    if launches != forwards:
        raise AssertionError(f"soft_argmax_3d_fwd launched {launches} times "
                             f"in {forwards} forwards")
    print(f"main path: {forwards} forwards, soft_argmax_3d_fwd launches "
          f"{launches}", flush=True)
    for name in predictors:
        print(f"{name}: b=1 latency {timings[(name, 1)]:.3f} ms, b=128 "
              f"throughput {128e3 / timings[(name, 128)]:.1f} img/s ({card})")
    for pred in predictors.values():
        for b in (1, 128):
            breakdown(pred, b, card)

    # float32 forward with the kernel against the same forward with the
    # plain soft-argmax, and against the CPU, with TF32 off everywhere
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    compare_forwards(predictors["float32"], Predictor(cfg, sd, device="cpu"))

    # ---- 5. summary ----
    main_row = next(r for r in rows if r["shape"] == [128, *serving]
                    and r["dtype"] == "bfloat16")
    print(json.dumps({"kernels": [{
        "name": "soft_argmax_3d_fwd", "route": "cuda",
        "source": "horopose_tpu_torch/csrc/soft_argmax.cu",
        "replaces": "horopose_tpu/ops/integral_pallas.py:25",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shape": main_row["shape"], "dtype": main_row["dtype"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
