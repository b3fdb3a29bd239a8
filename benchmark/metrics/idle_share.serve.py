"""idle_share.serve (device trace): the share of the profiled stretch of
whole serving calls, bounded by synchronises, in which no kernel, copy or
memset ran on the card (the union of their intervals), in %."""


def read(run):
    t = run.get("trace")
    if t is None or "frames" not in run or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
