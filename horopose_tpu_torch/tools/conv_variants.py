"""Time build-time variants of the 3x3 conv kernels on the card.

`csrc/conv3x3.cu` takes five macros. bfloat16: CONV_BF16_ROWS (output
rows a tile, one warp each), CONV_BF16_STAGES (halo buffers in the ring)
and CONV_BF16_SKIP. float32: CONV_F32_STAGES (staged chunks in the ring)
and CONV_F32_SKIP. A SKIP of 1 leaves out the products, 2 the input copies
after the first steps, so that each half of a kernel is timed alone; their
outputs are wrong. `tools/conv3x3_f32_direct.cu`, the earlier direct
float32 kernel (4 pixels x 4 channels a thread, synchronous staging), takes
CONV_F32_SKIP too and is timed beside the float32 kernel as its baseline.

This builds each variant with nvcc into `_build/variants/` (one nvcc each,
all at once), checks the full variants' output against the plain version,
and times every variant and cuDNN's `F.conv2d` (TF32 off) at the HRNet
branch-0 shape (128, 64, 64, 32 -> 32), in bfloat16 and in float32, on the
device alone, in turns, ROUNDS times, over a ring of inputs larger than
twice the L2 cache. One JSON line a variant, with the card's name and power
limit, and the median SM clock and power draw that nvidia-smi sampled
while the dtype's variants ran: the float32 units' rate is 132 SMs x 128
lanes x 2 FLOP a cycle at that clock (67 TFLOP/s is the rate at 1980 MHz).

    python -m horopose_tpu_torch.tools.conv_variants

Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

import torch

from horopose_tpu_torch import cuda_build
from horopose_tpu_torch.ops import conv3x3_cuda
from horopose_tpu_torch.ops.conv3x3 import conv3x3_s2d_plain
from horopose_tpu_torch.tools.bench_conv import (SHAPE, bound_ms, card_info,
                                                 library_conv)
from horopose_tpu_torch.tools.timing import device_ms, ring_size, ring_slices

ROUNDS = 3
SMEM_PER_SM = 232448       # H100: shared memory a block may use, bytes
DIRECT_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "conv3x3_f32_direct.cu")


class Variant(NamedTuple):
    dtype: torch.dtype
    kernel: str            # "mma" (bf16), "tiled" (f32) or "direct" (f32)
    rows: int = 8          # bf16: output rows a tile
    stages: int = 3        # ring depth (not read by "direct")
    skip: int = 0          # 1: no products, 2: no copies after the first


# the first of each dtype is the kernel's default build
VARIANTS = (
    Variant(torch.bfloat16, "mma"), Variant(torch.bfloat16, "mma", stages=2),
    Variant(torch.bfloat16, "mma", rows=4),
    Variant(torch.bfloat16, "mma", rows=4, stages=2),
    Variant(torch.bfloat16, "mma", skip=1),
    Variant(torch.bfloat16, "mma", skip=2),
    Variant(torch.float32, "tiled"), Variant(torch.float32, "tiled", stages=2),
    Variant(torch.float32, "tiled", skip=1),
    Variant(torch.float32, "tiled", skip=2),
    Variant(torch.float32, "direct"), Variant(torch.float32, "direct", skip=1),
    Variant(torch.float32, "direct", skip=2))


def smem_bytes(rows: int, stages: int) -> int:
    """The bf16 kernel's dynamic shared memory (csrc/conv3x3.cu kMmaSmem)."""
    cs = 40                 # padded pixel stride, bf16
    return 2 * (stages * (rows + 2) * 66 * cs + 9 * 32 * cs + rows * 64 * cs)


def blocks_per_sm(v: Variant) -> int:
    """Persistent blocks an SM (the direct kernel takes its own grid)."""
    if v.kernel == "mma":
        return SMEM_PER_SM // (smem_bytes(v.rows, v.stages) + 1024)
    return conv3x3_cuda.F32_BLOCKS_PER_SM


def nvcc_command(v: Variant, out: str) -> list:
    if v.kernel == "direct":
        return [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS,
                f"-DCONV_F32_SKIP={v.skip}", "-o", out, DIRECT_SOURCE]
    bf16 = v.kernel == "mma"
    macros = ([f"-DCONV_BF16_ROWS={v.rows}", f"-DCONV_BF16_STAGES={v.stages}",
               f"-DCONV_BF16_SKIP={v.skip}"] if bf16 else
              [f"-DCONV_F32_STAGES={v.stages}", f"-DCONV_F32_SKIP={v.skip}"])
    return [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, *macros, "-o", out,
            os.path.join(cuda_build.CSRC, f"{conv3x3_cuda.SOURCE}.cu")]


class ClockSampler:
    """nvidia-smi sampling the first card's SM clock (MHz) and power draw
    (W) every 100 ms between start() and stop(); stop() returns their
    medians, or (None, None) without nvidia-smi."""

    def start(self) -> "ClockSampler":
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits", "-i", "0", "-lms", "100"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
        return self

    def stop(self) -> tuple:
        if self.proc is None:
            return None, None
        self.proc.terminate()
        out, _ = self.proc.communicate()
        pairs = []
        for line in out.splitlines():
            try:
                pairs.append(tuple(float(v) for v in line.split(",")))
            except ValueError:
                continue
        if not pairs:
            return None, None
        return (statistics.median(p[0] for p in pairs),
                statistics.median(p[1] for p in pairs))


def build(variants=VARIANTS) -> dict:
    """{variant: ctypes function}, each built by its own nvcc."""
    out_dir = os.path.join(cuda_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for v in variants:
        out = os.path.join(out_dir, f"conv3x3_{v.kernel}_r{v.rows}_s{v.stages}"
                                    f"_k{v.skip}.so")
        procs[v] = (subprocess.Popen(
            nvcc_command(v, out), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out)
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
    times over ROUNDS turns, per dtype."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"conv_variants measures a CUDA card, not {device}")
    fns = build()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    stream = torch.cuda.current_stream(device).cuda_stream
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    try:
        for dtype in (torch.bfloat16, torch.float32):
            mine = [v for v in fns if v.dtype == dtype]
            rows += _run_dtype(dtype, {v: fns[v] for v in mine}, device,
                               stream, sms, card)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    return rows


def _run_dtype(dtype, fns: dict, device, stream: int, sms: int,
               card: str) -> list:
    B, H, W, C, Fo = SHAPE
    gen = torch.Generator(device=device).manual_seed(0)
    n = ring_size(B * H * W * C * torch.finfo(dtype).bits // 8)
    ring = ring_slices(torch.randn(n * B, H, W, C, generator=gen,
                                   device=device).to(dtype), n)
    w = (0.1 * torch.randn(3, 3, C, Fo, generator=gen, device=device)
         ).to(dtype)

    def launcher(v: Variant):
        tiles = -(-H // v.rows) * B * -(-W // 64) * -(-Fo // 32)
        blocks = min(tiles, blocks_per_sm(v) * sms)

        def conv(x):
            y = torch.empty(B, H, W, Fo, dtype=x.dtype, device=device)
            err = fns[v](x.data_ptr(), w.data_ptr(),
                         int(dtype == torch.bfloat16), B, H, W, C, Fo,
                         blocks, y.data_ptr(), stream, device.index or 0)
            if err != 0:
                raise RuntimeError(f"variant {v}: CUDA error {err}")
            return y
        return conv

    calls = {v: launcher(v) for v in fns}
    ref = conv3x3_s2d_plain(ring[0], w).float()
    errs = {v: float((conv(ring[0]).float() - ref).abs().max())
            for v, conv in calls.items()}
    lib = library_conv(w)
    first = next(iter(calls.values()))
    t0 = time.perf_counter()      # bring the card to its working clocks
    while time.perf_counter() - t0 < 1.0:
        for x in ring:
            first(x)
    torch.cuda.synchronize(device)
    times = {v: [] for v in (*calls, "cudnn")}
    sampler = ClockSampler().start()
    try:
        for _ in range(ROUNDS):
            for v, conv in calls.items():
                times[v].append(device_ms(conv, ring, per_call_host_ms=0.1))
            times["cudnn"].append(device_ms(lib, ring, per_call_host_ms=0.1))
        torch.cuda.synchronize(device)
    finally:
        clock_mhz, power_w = sampler.stop()
    bound, bound_by = bound_ms(*SHAPE, dtype)
    name = str(dtype).split(".")[-1]
    rows = []
    for v, ms in times.items():
        row = dict(shape=list(SHAPE), dtype=name, device_ms=ms,
                   bound_ms=bound, bound_by=bound_by,
                   bound_share=[bound / t for t in ms], card=card,
                   sm_clock_mhz=clock_mhz, power_draw_w=power_w)
        if v != "cudnn":
            row.update(kernel=v.kernel, rows=v.rows, stages=v.stages,
                       skip=v.skip, blocks_per_sm=blocks_per_sm(v),
                       max_abs_err_vs_plain=errs[v])
        else:
            row.update(variant="cudnn F.conv2d, TF32 off")
        rows.append(row)
    del ring
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
