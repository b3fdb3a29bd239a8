"""A throwaway copy of the benchmark's data in a temporary directory, with
small cells added by name: the harness finds them as it finds its own."""

from __future__ import annotations

import json
import os
import shutil

from benchmark import run as bench_run

TINY_SERVE = "panda_tiny.serve"
TINY_TRAIN = "baxter_tiny.train"
KINDS = ("configs", "traffic", "metrics", "limits")


def tiny_root(tmp_path) -> tuple:
    """(root, bench): the benchmark's files copied under tmp_path, plus
    two configurations at 64 x 64 crops and 8 heatmap depths, a serving
    mix of 2 frames of 120 x 160 and a training mix of 4 rows, their cells
    and limits; the cells report every metric their mode has."""
    root = str(tmp_path / "bench")
    for kind in KINDS:
        shutil.copytree(os.path.join(bench_run.HERE, kind),
                        os.path.join(root, kind))

    def write(kind, name, obj):
        with open(os.path.join(root, kind, f"{name}.json"), "w") as f:
            json.dump(obj, f)

    for robot in ("panda", "baxter"):
        c = bench_run.load_json(root, "configs", f"{robot}_full")
        c.update(image_size=64, depth_dim=8)
        write("configs", f"{robot}_tiny", c)
    t = bench_run.load_json(root, "traffic", "serve_b128")
    t.update(batch=2, pool=2, frame_hw=[120, 160], bbox_w=[40, 80],
             bbox_h=[40, 80], trace_calls=2, prep_calls=2)
    write("traffic", "serve_tiny", t)
    t = bench_run.load_json(root, "traffic", "train_b64")
    t.update(batch=4, pool=4, trace_steps=2)
    write("traffic", "train_tiny", t)
    serve = bench_run.load_json(root, "limits", "panda_full.serve_b128")
    train = bench_run.load_json(root, "limits", "baxter_full.train_b64")
    write("limits", TINY_SERVE, serve)
    write("limits", TINY_TRAIN, train)
    bench = bench_run.load_benchmark()
    bench["workloads"] += [
        dict(name=TINY_SERVE, config="panda_tiny", traffic="serve_tiny",
             chips=1, why="test"),
        dict(name=TINY_TRAIN, config="baxter_tiny", traffic="train_tiny",
             chips=1, why="test")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            serve_metric = "panda_full.serve_b128" in m["workloads"]
            m["workloads"].append(TINY_SERVE if serve_metric else TINY_TRAIN)
    return root, bench
