"""Work counts and the chip's peaks: the arithmetic the utilisation and
roofline metrics divide by, counted from shapes by the benchmark itself.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 495 TFLOP/s in TF32 on the tensor cores, 67 TFLOP/s in float32
outside them, 989 TFLOP/s in bfloat16, 3.35 TB/s of HBM3.

The soft-argmax bounds (copied from `chip_smoke.py`): the forward reads
each logit once and writes (uvd, E, m, s) once, against 11 float32
operations a logit (compare, subtract, exp, a multiply-add into each of
four running sums); the backward reads each logit once and writes dx once,
reads E, (m, s) and the incoming gradient once, against 12 operations a
logit. The bound is the larger of bytes / bandwidth and operations / the
float32 peak.

A model's FLOPs an image (forward, and forward plus backward) are counted
once by `torch.utils.flop_counter` over the plain reference at the
configuration's sizes and frozen in the configuration's `work`;
`benchmark/tests/test_bench_work.py` counts them again.
"""

from __future__ import annotations

TF32_FLOPS = 495e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
SAM_FWD_OPS = 11
SAM_BWD_OPS = 12


def soft_argmax_fwd_bound_s(cells: int, volume: int, itemsize: int = 4
                            ) -> float:
    """cells (B x K) heatmaps of `volume` (D x H x W) logits."""
    bytes_moved = cells * volume * itemsize + cells * (3 + 3 + 2) * 4
    return max(bytes_moved / HBM_BYTES_PER_S,
               cells * volume * SAM_FWD_OPS / F32_FLOPS)


def soft_argmax_bwd_bound_s(cells: int, volume: int, itemsize: int = 4
                            ) -> float:
    bytes_moved = 2 * cells * volume * itemsize + cells * (3 + 2 + 3) * 4
    return max(bytes_moved / HBM_BYTES_PER_S,
               cells * volume * SAM_BWD_OPS / F32_FLOPS)


def heatmap_cells(run) -> tuple:
    """(B x K cells, D x H x W logits a cell) of the cell's heatmap."""
    from benchmark.reference.robot import RobotFK
    config, traffic = run["config"], run["traffic"]
    K = RobotFK(config["urdf_robot_name"]).num_keypoints
    n = int(config["image_size"]) // 4
    return int(traffic["batch"]) * K, int(config["depth_dim"]) * n * n
