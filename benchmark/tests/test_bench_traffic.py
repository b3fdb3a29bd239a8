"""The traffic generator: the same seed gives the same inputs, another
seed others, the batches keep the program's layout, and the program and
the reference are handed the same inputs and weights."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark import generate
from benchmark import run as bench_run
from benchmark.modes import serve as serve_mode
from benchmark.modes import train as train_mode
from benchmark.reference import serve as ref_serve
from benchmark.reference import train as ref_train
from benchmark.tests.helpers import TINY_SERVE, TINY_TRAIN, tiny_root

SEED = 2 ** 31 + 12345


def _serve(seed):
    t = bench_run.load_json(bench_run.HERE, "traffic", "serve_b128")
    t.update(batch=3, pool=2)
    return generate.serve_requests(t, seed, "cpu")


def _train(seed, robot="baxter"):
    t = bench_run.load_json(bench_run.HERE, "traffic", "train_b64")
    t.update(batch=5, pool=2)
    return t, generate.train_batches(t, robot, 256, seed, "cpu")


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_serve_requests_follow_the_seed():
    a, b, c = _serve(SEED), _serve(SEED), _serve(SEED + 1)
    for ra, rb, rc in zip(a, b, c):
        for key in ("frames", "K", "bboxes"):
            np.testing.assert_array_equal(ra[key], rb[key])
        assert not np.array_equal(ra["frames"], rc["frames"])
        assert not np.array_equal(ra["bboxes"], rc["bboxes"])
    r = a[0]
    assert r["frames"].shape == (3, 480, 640, 3)
    assert r["frames"].dtype == np.uint8
    w = r["bboxes"][:, 2] - r["bboxes"][:, 0]
    h = r["bboxes"][:, 3] - r["bboxes"][:, 1]
    assert (w >= 150).all() and (w <= 350).all()
    assert (h >= 200).all() and (h <= 400).all()
    assert (r["bboxes"][:, 2] <= 640).all() and (r["bboxes"][:, 3] <= 480).all()


@pytest.mark.parametrize("robot", ["panda", "baxter"])
def test_train_batches_follow_the_seed(robot):
    t, a = _train(SEED, robot)
    _, b = _train(SEED, robot)
    _, c = _train(SEED + 1, robot)
    for ba, bb, bc in zip(a, b, c):
        fa, fb, fc = dict(_flat(ba)), dict(_flat(bb)), dict(_flat(bc))
        assert set(fa) == set(fb)
        for k in fa:
            assert torch.equal(fa[k], fb[k]), k
        assert not torch.equal(fa["jointpose"], fc["jointpose"])
        assert not torch.equal(fa["other.images"], fc["other.images"])
        assert float(fa["other.keypoints_3d"][..., 2].min()) >= \
            t["min_keypoint_depth_m"]
    assert not torch.equal(a[0]["jointpose"], a[1]["jointpose"])


def test_train_batches_have_the_programs_layout():
    from horopose_tpu_torch.data.synthetic import synthetic_dream_batch
    from horopose_tpu_torch.kinematics.robot import Robot
    _, ours = _train(SEED)
    theirs = synthetic_dream_batch(Robot("baxter", device="cpu"), 5, 256,
                                   256, 0, device="cpu")
    fo, ft = dict(_flat(ours[0])), dict(_flat(theirs))
    assert set(fo) == set(ft)
    for k in ft:
        assert fo[k].shape == ft[k].shape and fo[k].dtype == ft[k].dtype, k


def test_the_keypoints_are_the_programs_fk():
    from horopose_tpu_torch.kinematics.robot import Robot
    from horopose_tpu_torch.ops.rotations import rotmat_to_rot6d
    _, batches = _train(SEED)
    b = batches[0]
    robot = Robot("baxter", device="cpu")
    TCO = b["TCO"]
    kp = robot.get_keypoints(b["jointpose"], rotmat_to_rot6d(TCO[:, :3, :3]),
                             TCO[:, :3, 3])
    assert float((kp - b["other"]["keypoints_3d"]).abs().max()) < 1e-5


def _spy(monkeypatch, owner, name, seen):
    fn = getattr(owner, name)

    def wrapper(*args, **kwargs):
        seen.append(args)
        return fn(*args, **kwargs)
    monkeypatch.setattr(owner, name, wrapper)


def test_serving_sides_get_the_same_inputs(tmp_path, monkeypatch):
    root, bench = tiny_root(tmp_path)
    program, reference, weights = [], [], []
    build = serve_mode.build_program

    def spying_build(config, state_dict, device, dtype=torch.float32):
        weights.append({k: v.clone() for k, v in state_dict.items()})
        pred = build(config, state_dict, device, dtype)

        def call(frames, K, bboxes=None):
            program.append((frames, K, bboxes))
            return pred(frames, K, bboxes)
        return call
    monkeypatch.setattr(serve_mode, "build_program", spying_build)
    _spy(monkeypatch, ref_serve, "serve", reference)
    load = torch.nn.Module.load_state_dict

    def spying_load(self, sd, *args, **kwargs):
        weights.append({k: v.clone() for k, v in sd.items()})
        return load(self, sd, *args, **kwargs)
    monkeypatch.setattr(torch.nn.Module, "load_state_dict", spying_load)
    bench_run.run_cell(bench, TINY_SERVE, SEED, 0.2, False, device="cpu",
                       root=root, t_start=time.perf_counter())
    seen = {p[0].tobytes(): p for p in program}
    assert len(reference) >= 1
    for _, _, frames, K, bboxes in reference:
        p = seen[frames.tobytes()]
        np.testing.assert_array_equal(p[1], K)
        np.testing.assert_array_equal(p[2], bboxes)
    first = weights[0]
    for w in weights[1:]:
        assert set(w) == set(first)
        for k in first:
            assert torch.equal(w[k], first[k]), k


def test_training_sides_get_the_same_inputs(tmp_path, monkeypatch):
    root, bench = tiny_root(tmp_path)
    program, reference = [], []
    build = train_mode.build_program

    def spying_build(*args, **kwargs):
        model, opt, step = build(*args, **kwargs)

        def spied(batch, gen):
            program.append((batch, gen.initial_seed()))
            return step(batch, gen)
        return model, opt, spied
    monkeypatch.setattr(train_mode, "build_program", spying_build)
    step = ref_train.TrainReference.step

    def spying_step(self, batch, gen):
        reference.append((batch, gen.initial_seed()))
        return step(self, batch, gen)
    monkeypatch.setattr(ref_train.TrainReference, "step", spying_step)
    bench_run.run_cell(bench, TINY_TRAIN, SEED, 0.0, False, device="cpu",
                       root=root, t_start=time.perf_counter())
    assert len(reference) == 3
    for (pb, ps), (rb, rs) in zip(program, reference):
        assert pb is rb and ps == rs
    assert len({id(b) for b, _ in reference}) == 3
