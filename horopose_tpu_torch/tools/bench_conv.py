"""Micro-benchmark: the CUDA 3x3 conv kernel against cuDNN (`F.conv2d`) at
the HRNet branch-0 shape.

Port of `scripts/bench_pallas_conv.py`. Same shape, (B, H, W, C, F) =
(128, 64, 64, 32, 32), bfloat16, the same `RandomState(0)` inputs with the
weights scaled by 0.1. Correctness first (the kernel against `F.conv2d`),
then the time per convolution of DEPTH chained convolutions (32 -> 32
channels compose) per iteration over 20 iterations, CUDA events, the first
(building) iteration excluded. The JAX script's scan fed a 1e-9 perturbation
back between iterations so that XLA could not hoist them; eager PyTorch
runs every launch, so each iteration restarts from x.

Run on a machine with an NVIDIA card:

    python -m horopose_tpu_torch.tools.bench_conv

It prints one JSON line, with the card's name and power limit from
nvidia-smi. Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from horopose_tpu_torch.ops.conv3x3 import conv3x3

DEPTH = 8
ITERS = 20
SHAPE = (128, 64, 64, 32, 32)       # B, H, W, C, F: HRNet branch 0 at b=128
# H100 SXM published peaks (NVIDIA data sheet), at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12,    # dense bf16 tensor cores
              torch.float32: 67e12}      # the float32 units


def card_info() -> str:
    """nvidia-smi's name and power limit of the first card."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def conv_flops(B: int, H: int, W: int, C: int, Fo: int) -> int:
    return 2 * B * H * W * 9 * C * Fo


def bound_ms(B: int, H: int, W: int, C: int, Fo: int,
             dtype: torch.dtype) -> tuple:
    """(least time in ms, "bytes" or "operations"): x read once, w read
    once and y written once at the HBM rate, against the convolution's
    operations at the dtype's peak rate."""
    size = torch.finfo(dtype).bits // 8
    byte_ms = (B * H * W * (C + Fo) + 9 * C * Fo) * size / HBM_BYTES_PER_S * 1e3
    op_ms = conv_flops(B, H, W, C, Fo) / PEAK_FLOPS[dtype] * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def library_conv(w: torch.Tensor):
    """cuDNN's 3x3 SAME conv on NHWC tensors: `F.conv2d` of the
    channels_last NCHW view of a contiguous NHWC tensor, no copy; the OIHW
    weights are made once, outside the timed calls."""
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def conv(x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, padding=1)
        return y.permute(0, 2, 3, 1)          # NHWC view of channels_last
    return conv


def time_chained_ms(fn, x: torch.Tensor, iters: int = ITERS,
                    depth: int = DEPTH) -> float:
    """ms per call of `fn` over `iters` iterations of `depth` chained calls,
    after one untimed iteration (which builds the kernel)."""
    def chain():
        y = x
        for _ in range(depth):
            y = fn(y)
        return y

    chain()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        chain()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * depth)


def run(shape=SHAPE, dtype: torch.dtype = torch.bfloat16, device="cuda",
        card: str = "") -> dict:
    """The benchmark at `shape` in `dtype` on a CUDA `device`; returns the
    JSON line's fields."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"bench_conv measures a CUDA card, not {device}")
    B, H, W, C, Fo = shape
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randn(B, H, W, C), dtype=dtype, device=device)
    w = torch.as_tensor(rng.randn(3, 3, C, Fo) * 0.1, dtype=dtype,
                        device=device)
    library = library_conv(w)

    def kernel(t):
        return conv3x3(t, w)

    ref = library(x).float()
    got = kernel(x).float()
    err = float((got - ref).abs().max() / ref.abs().max().clamp(min=1e-6))
    t_lib = time_chained_ms(library, x)
    t_kernel = time_chained_ms(kernel, x)
    flops = conv_flops(*shape)
    peak = PEAK_FLOPS[torch.bfloat16]
    bound, bound_by = bound_ms(*shape, dtype)
    return dict(metric=f"conv3x3_{H}x{W}x{C}to{Fo}_b{B}",
                dtype=str(dtype).split(".")[-1], kernel_ms=t_kernel,
                cudnn_ms=t_lib, speedup=t_lib / t_kernel, rel_err=err,
                bound_ms=bound, bound_by=bound_by,
                kernel_bf16_peak_share=flops / peak / (t_kernel * 1e-3),
                cudnn_bf16_peak_share=flops / peak / (t_lib * 1e-3),
                depth=DEPTH, iters=ITERS, card=card)


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_conv: torch.cuda.is_available() is False; this "
              "benchmark runs on a CUDA card", file=sys.stderr)
        return 2
    print(json.dumps(run(card=card_info())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
