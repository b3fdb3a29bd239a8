"""prep_ms.serve (host clock, a harness span): the mean of `prep_calls`
calls' `Predictor.preprocess` (the per-frame bbox and crop-intrinsics loop
on the host, the frames' upload, the crops and the k prior on the card),
each timed from its call to a synchronise after it; the rest of the call
runs as usual. Read in the traced run, after the profiled stretch."""


def read(run):
    ms = run.get("prep_ms")
    return sum(ms) / len(ms) if ms else None
