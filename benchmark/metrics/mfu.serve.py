"""mfu.serve (host clock over counted work): the forward FLOPs of every
frame the window served (the configuration's `work`, counted over the
plain reference), over the window's seconds, as a share of the H100's
495 TFLOP/s TF32 peak, in %."""

from benchmark.work import TF32_FLOPS


def read(run):
    if "frames" not in run:
        return None
    flops = run["frames"] * run["config"]["work"]["forward_flop_per_image"]
    return 100.0 * flops / run["window_s"] / TF32_FLOPS
