"""mfu.train (host clock over counted work): the forward and backward FLOPs
of every image the window trained on (the configuration's `work`, counted
over the plain reference), over the window's seconds, as a share of the
H100's 495 TFLOP/s TF32 peak, in %."""

from benchmark.work import TF32_FLOPS


def read(run):
    if "images" not in run:
        return None
    flops = run["images"] * run["config"]["work"]["train_flop_per_image"]
    return 100.0 * flops / run["window_s"] / TF32_FLOPS
