"""serve_img_per_s (host clock): frames of every call in the window, whose
outputs reached the host as numpy arrays, over the window's seconds (from
the first call's start to the last call's end)."""


def read(run):
    if "frames" not in run:
        return None
    return run["frames"] / run["window_s"]
