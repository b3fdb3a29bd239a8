"""Time build-time variants of the bf16 3x3 conv kernel on the card.

`csrc/conv3x3.cu` takes three macros: CONV_BF16_ROWS (output rows a
tile, one warp each), CONV_BF16_STAGES (halo buffers in the ring) and
CONV_BF16_SKIP (1 leaves out the products, 2 the halo copies after the
first, so that each half of the kernel is timed alone; their outputs are
wrong). This builds each variant with nvcc into `_build/variants/` (one
nvcc each, all at once), checks the full variants' output against the
plain version, and times every variant and cuDNN's `F.conv2d` at the HRNet
branch-0 shape (128, 64, 64, 32 -> 32) in bfloat16 on the device alone,
in turns, ROUNDS times, over a ring of inputs larger than twice the L2
cache. One JSON line a variant, with the card's name and power limit.

    python -m horopose_tpu_torch.tools.conv_variants

Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

import torch

from horopose_tpu_torch import cuda_build
from horopose_tpu_torch.ops import conv3x3_cuda
from horopose_tpu_torch.ops.conv3x3 import conv3x3_s2d_plain
from horopose_tpu_torch.tools.bench_conv import (SHAPE, bound_ms, card_info,
                                                 library_conv)
from horopose_tpu_torch.tools.timing import device_ms, ring_size, ring_slices

# (rows, stages, skip); the first is the kernel's default build
VARIANTS = ((8, 3, 0), (8, 2, 0), (4, 3, 0), (4, 2, 0), (8, 3, 1), (8, 3, 2))
ROUNDS = 3
SMEM_PER_SM = 232448       # H100: shared memory a block may use, bytes


def smem_bytes(rows: int, stages: int) -> int:
    """The kernel's dynamic shared memory (csrc/conv3x3.cu kMmaSmem)."""
    cs = 40                 # padded pixel stride, bf16
    return 2 * (stages * (rows + 2) * 66 * cs + 9 * 32 * cs + rows * 64 * cs)


def build(variants=VARIANTS) -> dict:
    """{variant: ctypes function}, each built from csrc/conv3x3.cu."""
    out_dir = os.path.join(cuda_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for rows, stages, skip in variants:
        out = os.path.join(out_dir, f"conv3x3_r{rows}_s{stages}_k{skip}.so")
        cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS,
               f"-DCONV_BF16_ROWS={rows}", f"-DCONV_BF16_STAGES={stages}",
               f"-DCONV_BF16_SKIP={skip}", "-o", out,
               os.path.join(cuda_build.CSRC, f"{conv3x3_cuda.SOURCE}.cu")]
        procs[(rows, stages, skip)] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), out)
    fns = {}
    for v, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {v}:\n{log}")
        fn = ctypes.CDLL(out).conv3x3_nhwc
        fn.argtypes = conv3x3_cuda._ARGTYPES
        fn.restype = ctypes.c_int
        fns[v] = fn
    return fns


def run(device="cuda", card: str = "") -> list:
    """The variants' rows: errors against the plain version and device
    times over ROUNDS turns."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"conv_variants measures a CUDA card, not {device}")
    B, H, W, C, Fo = SHAPE
    fns = build()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    gen = torch.Generator(device=device).manual_seed(0)
    n = ring_size(B * H * W * C * 2)
    ring = ring_slices(torch.randn(n * B, H, W, C, generator=gen,
                                   device=device).to(torch.bfloat16), n)
    w = (0.1 * torch.randn(3, 3, C, Fo, generator=gen, device=device)
         ).to(torch.bfloat16)
    stream = torch.cuda.current_stream(device).cuda_stream

    def launcher(v):
        rows, stages, _ = v
        tiles = -(-H // rows) * B * -(-W // 64) * -(-Fo // 32)
        per_sm = SMEM_PER_SM // (smem_bytes(rows, stages) + 1024)
        blocks = min(tiles, per_sm * sms)

        def conv(x):
            y = torch.empty(B, H, W, Fo, dtype=x.dtype, device=device)
            err = fns[v](x.data_ptr(), w.data_ptr(), 1, B, H, W, C, Fo,
                         blocks, y.data_ptr(), stream, device.index or 0)
            if err != 0:
                raise RuntimeError(f"variant {v}: CUDA error {err}")
            return y
        return conv, per_sm

    calls = {v: launcher(v) for v in fns}
    ref = conv3x3_s2d_plain(ring[0], w).float()
    errs = {v: float((conv(ring[0]).float() - ref).abs().max())
            for v, (conv, _) in calls.items()}
    lib = library_conv(w)
    t0 = time.perf_counter()      # bring the card to its working clocks
    while time.perf_counter() - t0 < 1.0:
        for x in ring:
            calls[VARIANTS[0]][0](x)
    torch.cuda.synchronize(device)
    times = {v: [] for v in (*calls, "cudnn")}
    for _ in range(ROUNDS):
        for v, (conv, _) in calls.items():
            times[v].append(device_ms(conv, ring, per_call_host_ms=0.1))
        times["cudnn"].append(device_ms(lib, ring, per_call_host_ms=0.1))
    bound, bound_by = bound_ms(*SHAPE, torch.bfloat16)
    rows = []
    for v, ms in times.items():
        row = dict(shape=list(SHAPE), dtype="bfloat16", device_ms=ms,
                   bound_ms=bound, bound_by=bound_by,
                   bound_share=[bound / t for t in ms], card=card)
        if v != "cudnn":
            row.update(rows=v[0], stages=v[1], skip=v[2],
                       blocks_per_sm=calls[v][1],
                       max_abs_err_vs_plain=errs[v])
        else:
            row.update(variant="cudnn F.conv2d")
        rows.append(row)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_variants: torch.cuda.is_available() is False; this runs "
              "on a CUDA card", file=sys.stderr)
        return 2
    for row in run(card=card_info()):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
