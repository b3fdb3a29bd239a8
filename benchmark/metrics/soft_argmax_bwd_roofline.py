"""soft_argmax_bwd_roofline (device trace): the soft-argmax backward's
least time at the heatmap's shape (B x K cells of D x H x W float32
logits; `benchmark/work.py`), once for every step of the profiled
stretch, over the device time of its kernel there, in %. The kernel is
found by name: `soft_argmax_3d_bwd_kernel` (`csrc/soft_argmax.cu`, the
`horopose::soft_argmax_3d_bwd` operator). None found, no reading."""

from benchmark.work import heatmap_cells, soft_argmax_bwd_bound_s

KERNELS = ("soft_argmax_3d_bwd_kernel",)


def read(run):
    t = run.get("trace")
    steps = run.get("trace_steps")
    if t is None or not steps:
        return None
    seconds, launches = t.kernel_s(KERNELS)
    if not launches or seconds <= 0:
        return None
    cells, volume = heatmap_cells(run)
    return 100.0 * steps * soft_argmax_bwd_bound_s(cells, volume) / seconds
