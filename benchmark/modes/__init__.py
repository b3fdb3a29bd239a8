"""One loop a traffic `mode`: `serve` (a closed loop of requests) and
`train` (stage-2 steps)."""
