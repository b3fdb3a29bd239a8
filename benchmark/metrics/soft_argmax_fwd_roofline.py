"""soft_argmax_fwd_roofline (device trace): the soft-argmax forward's
least time at the heatmap's shape (B x K cells of D x H x W float32
logits; `benchmark/work.py`), once for every forward of the profiled
stretch, over the device time of its kernels there, in %. The kernels are
found by name: `soft_argmax_3d_fwd_kernel` and
`soft_argmax_3d_merge_kernel` (`csrc/soft_argmax.cu`, reached through the
`horopose::soft_argmax_3d_fwd` operator). The work is the shape's,
whatever kernel computes it; none found, no reading."""

from benchmark.work import heatmap_cells, soft_argmax_fwd_bound_s

KERNELS = ("soft_argmax_3d_fwd_kernel", "soft_argmax_3d_merge_kernel")


def read(run):
    t = run.get("trace")
    forwards = run.get("trace_calls") or run.get("trace_steps")
    if t is None or not forwards:
        return None
    seconds, launches = t.kernel_s(KERNELS)
    if not launches or seconds <= 0:
        return None
    cells, volume = heatmap_cells(run)
    return 100.0 * forwards * soft_argmax_fwd_bound_s(cells, volume) / seconds
