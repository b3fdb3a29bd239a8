"""train_img_per_s (host clock): images of every step in the window over
its seconds, from a synchronise before the first step to the one after
the card finished the last."""


def read(run):
    if "images" not in run:
        return None
    return run["images"] / run["window_s"]
