"""Port serving path against the JAX package: the crop, the preprocessing,
the `Predictor` end to end, and the port's import isolation."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from horopose_tpu import native
from horopose_tpu.config import make_default_cfg
from horopose_tpu.data import roboutils as JRU
from horopose_tpu.predictor import Predictor as JaxPredictor
from horopose_tpu_torch.core.profiling import record
from horopose_tpu_torch.data.crop import crop_resize_bilinear
from horopose_tpu_torch.pipelines.common import (FullNetConfig, build_fullnet,
                                                 random_state_dict)
from horopose_tpu_torch.predictor import Predictor
from horopose_tpu_torch.tools.jax_weights import fullnet_state_dict_from_jax

from test_torch_port_models import random_jax_variables, rel_err
from _torch_port_threads import one_intra_op_thread  # noqa: F401


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 1e-4
OUTPUT_KEYS = ["joints", "rotation", "translation", "root_depth",
               "keypoints_3d", "keypoints_3d_integral", "keypoints_2d"]
# the C++ crop may fuse multiply-adds (g++ -O3), the port does not: allow
# one level of difference on at most 0.1% of the values
MAX_OFF_BY_ONE = 1e-3


def _crops_agree(a, b):
    diff = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= MAX_OFF_BY_ONE


def _needs_native():
    if native.get_lib() is None:
        pytest.skip("the JAX package's native crop did not build (no g++)")


@pytest.mark.parametrize("bbox,size", [
    ((100, 80, 420, 400), 64),       # square-ish, downscale
    ((0, 0, 640, 480), 96),          # full frame, wide
    ((300, 10, 380, 470), 64),       # tall, padded left and right
    ((600, 440, 640, 480), 128),     # small corner crop, upscale
    ((13, 7, 221, 133), 256),        # odd offsets, upscale
])
def test_crop_matches_native(bbox, size, rng):
    _needs_native()
    frame = rng.randint(0, 256, (480, 640, 3), dtype=np.uint8)
    ref = native.crop_resize_bilinear(frame, bbox, size)
    out = crop_resize_bilinear(torch.from_numpy(frame)[None],
                               torch.tensor([bbox]), size)[0].numpy()
    assert out.shape == ref.shape == (size, size, 3)
    _crops_agree(out, ref)


def test_crop_batches_frames_with_their_own_bboxes(rng):
    frames = torch.from_numpy(rng.randint(0, 256, (3, 48, 64, 3),
                                          dtype=np.uint8))
    boxes = torch.tensor([[0, 0, 64, 48], [10, 5, 30, 45], [40, 0, 64, 20]])
    batched = crop_resize_bilinear(frames, boxes, 32)
    for i in range(3):
        one = crop_resize_bilinear(frames[i:i + 1], boxes[i:i + 1], 32)
        assert torch.equal(batched[i:i + 1], one)


def _jax_cfg():
    cfg = make_default_cfg()
    cfg.image_size = 64.0
    cfg.backbone_name = "resnet18"
    cfg.rootnet_backbone_name = "resnet18"
    cfg.urdf_robot_name = "panda"
    cfg.reference_keypoint_id = 3
    return cfg


@pytest.fixture(scope="module")
def predictors():
    """The JAX Predictor and the port's, on the same numpy-random weights
    (resnet18 backbones, 64x64 crops, depth_dim 64)."""
    jpred = JaxPredictor(_jax_cfg(), None)
    s = jpred.size
    args = (np.zeros((1, s, s, 3), np.float32),
            np.zeros((1, s, s, 3), np.float32), np.ones((1,), np.float32),
            np.eye(3, dtype=np.float32)[None])
    jpred.variables = random_jax_variables(jpred.model, args, seed=5)
    sd = fullnet_state_dict_from_jax(jpred.variables["params"],
                                     jpred.variables["batch_stats"],
                                     "resnet18", "resnet18")
    cfg = FullNetConfig(backbone_name="resnet18",
                        rootnet_backbone_name="resnet18", image_size=64)
    return jpred, Predictor(cfg, sd, device="cpu")


def _request():
    """Two 64x64 frames and their intrinsics."""
    rng = np.random.RandomState(808)
    B = 2
    images = rng.randint(0, 256, (B, 64, 64, 3), dtype=np.uint8)
    K = np.tile(np.asarray([[60.0, 0, 31.5], [0, 62.0, 32.5], [0, 0, 1]],
                           np.float32)[None], (B, 1, 1))
    return images, K


@pytest.fixture(scope="module")
def outputs(predictors):
    """A 64x64 frame with a full-frame bbox crops at scale 1, so both
    packages feed the network identical crops."""
    jpred, pred = predictors
    images, K = _request()
    crops, _, _, _ = pred.preprocess(images, K)
    assert np.array_equal(crops.numpy(), images)
    return jpred(images, K), pred(images, K)


@pytest.mark.parametrize("key", OUTPUT_KEYS)
def test_predictor_matches_jax(outputs, key):
    ref, out = outputs
    assert out[key].shape == ref[key].shape
    assert out[key].dtype == np.float32
    assert rel_err(out[key], ref[key]) <= REL_TOL, key


def test_preprocess_matches_jax(predictors, rng):
    """Full 480x640 frames with detector bboxes: crops within the crop
    tolerance, crop intrinsics and the k prior equal to f32 rounding."""
    _needs_native()
    jpred, pred = predictors
    B = 3
    images = rng.randint(0, 256, (B, 480, 640, 3), dtype=np.uint8)
    K = np.tile(np.asarray([[615.5, 0, 328.3], [0, 615.2, 251.8],
                            [0, 0, 1]], np.float32)[None], (B, 1, 1))
    bboxes = np.asarray([[150, 100, 450, 380], [200, 150, 330, 390],
                         [0, 0, 640, 480]], np.float32)
    jc, jcr, jK, jk = jpred.preprocess(images, K, bboxes)
    c, cr, Kc, k = pred.preprocess(images, K, bboxes)
    _crops_agree(c.numpy(), jc)
    _crops_agree(cr.numpy(), jcr)
    np.testing.assert_allclose(Kc.numpy(), jK, rtol=1e-6)
    np.testing.assert_allclose(k.numpy(), jk, rtol=1e-6)
    side = [max(b[2] - b[0], b[3] - b[1])
            for b in (JRU.get_bbox(bb, 640, 480) for bb in bboxes)]
    np.testing.assert_allclose(k.numpy(), np.sqrt(615.5 * 615.2 * 1e6) /
                               np.asarray(side), rtol=1e-5)


def test_predictor_empty_batch(predictors):
    _, pred = predictors
    out = pred(np.zeros((0, 480, 640, 3), np.uint8),
               np.zeros((0, 3, 3), np.float32))
    assert out["joints"].shape == (0, 8)
    assert out["rotation"].shape == (0, 3, 3)
    assert out["keypoints_3d"].shape == (0, 7, 3)
    assert out["keypoints_2d"].shape == (0, 7, 2)


# (span, its parent) of one call, in the order they open
SERVE_SPANS = [("serve.call", None), ("serve.prep", "serve.call"),
               ("serve.prep.boxes", "serve.prep"),
               ("serve.prep.upload", "serve.prep"),
               ("serve.prep.crop", "serve.prep"),
               ("serve.forward", "serve.call"),
               ("serve.return", "serve.call"),
               ("serve.post", "serve.return"),
               ("serve.copy_back", "serve.return")]


def test_predictor_call_records_its_stages_in_order(predictors, outputs):
    """One call inside `record`: `serve.call` over its stages, opened in
    order, each closed before the next sibling opens, all of one root;
    the outputs bit for bit those of the call made outside `record`."""
    _, pred = predictors
    images, K = _request()
    with record() as rec:
        out = pred(images, K)
    spans = rec.spans
    assert [(s[2], None if s[3] is None else spans[s[3]][2])
            for s in spans] == SERVE_SPANS
    assert {s[4] for s in spans} == {0}
    for i, (start, end, _, parent, _) in enumerate(spans):
        later = [t for t in spans[i + 1:] if t[3] == parent]
        assert start <= end and (not later or end <= later[0][0])
    for key in OUTPUT_KEYS:
        assert np.array_equal(out[key], outputs[1][key]), key


def test_predictor_counts_the_bytes_it_uploads(predictors):
    """`serve.upload_bytes` grows by the frames, the int64 boxes, the
    float32 K (in `preprocess` and again for the projection) and the
    float32 crop intrinsics."""
    _, pred = predictors
    images, K = _request()
    B = len(images)
    with record() as rec:
        pred(images, K)
    assert rec.counts["serve.upload_bytes"] == \
        images.nbytes + B * 4 * 8 + 3 * B * 9 * 4


def test_predictor_rootnet_crop_size(rng):
    """rootnet_image_size below image_size: the root crop is a second,
    smaller resize of the same bbox."""
    cfg = FullNetConfig(backbone_name="resnet18",
                        rootnet_backbone_name="resnet18", image_size=64,
                        rootnet_image_size=32)
    model = build_fullnet(cfg)
    small = Predictor(cfg, random_state_dict(model, 0), device="cpu")
    images = rng.randint(0, 256, (2, 120, 160, 3), dtype=np.uint8)
    K = np.tile(np.eye(3, dtype=np.float32)[None], (2, 1, 1))
    crops, crops_root, _, _ = small.preprocess(images, K)
    assert crops.shape == (2, 64, 64, 3)
    assert crops_root.shape == (2, 32, 32, 3)
    out = small(images, K)
    assert np.isfinite(out["keypoints_3d"]).all()


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every port module and chip_smoke.py, imported in a fresh process,
    load none of jax, flax or horopose_tpu; no import line of
    chip_smoke.py (most sit inside its functions) names them."""
    code = (
        "import pkgutil, sys\n"
        "import horopose_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: __import__(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'horopose_tpu'))\n"
        "assert len(names) >= 59, names\n"
        "assert {'horopose_tpu_torch.core.engine', "
        "'horopose_tpu_torch.core.losses', 'horopose_tpu_torch.config', "
        "'horopose_tpu_torch.core.checkpoint', "
        "'horopose_tpu_torch.core.loggers', "
        "'horopose_tpu_torch.models.depth_net', "
        "'horopose_tpu_torch.ops.conv3x3', "
        "'horopose_tpu_torch.ops.conv3x3_cuda', "
        "'horopose_tpu_torch.pipelines.train_depthnet', "
        "'horopose_tpu_torch.pipelines.train_full', "
        "'horopose_tpu_torch.tools.bench_conv', "
        "'horopose_tpu_torch.core.metrics', "
        "'horopose_tpu_torch.data.augmentations', "
        "'horopose_tpu_torch.data.cache', "
        "'horopose_tpu_torch.data.dream', "
        "'horopose_tpu_torch.data.samplers', "
        "'horopose_tpu_torch.parallel.prefetch', "
        "'horopose_tpu_torch.parallel.spatial', "
        "'horopose_tpu_torch.pipelines.test', "
        "'horopose_tpu_torch.scripts.train', "
        "'horopose_tpu_torch.scripts.test', "
        "'horopose_tpu_torch.tools.synth_dream', "
        "'horopose_tpu_torch.tools.warm_cache', "
        "'horopose_tpu_torch.core.vis', "
        "'horopose_tpu_torch.kinematics.meshes', "
        "'horopose_tpu_torch.models.common', "
        "'horopose_tpu_torch.models.deeplab', "
        "'horopose_tpu_torch.ops.pnp', "
        "'horopose_tpu_torch.ops.rasterizer', "
        "'horopose_tpu_torch.pipelines.train_sim2real', "
        "'horopose_tpu_torch.core.profiling', "
        "'horopose_tpu_torch.core.shaded_render', "
        "'horopose_tpu_torch.tools.torch_weights', "
        "'horopose_tpu_torch.tools.convert', "
        "'horopose_tpu_torch.tools.export', "
        "'horopose_tpu_torch.native', "
        "'horopose_tpu_torch.scripts.demo_learn', "
        "'horopose_tpu_torch.ops.integral', "
        "'horopose_tpu_torch.parallel.multihost', "
        "'horopose_tpu_torch.parallel.mesh'} <= set(names), "
        "names\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as f:
        imports = [line for line in f
                   if re.match(r"\s*(import|from)\s+(jax|flax|horopose_tpu)"
                               r"(\s|\.|,|$)", line)]
    assert not imports, imports


def test_synthetic_writer_has_no_rendered_images_yet(tmp_path):
    """render_images=True is ported (the name is kept from when it
    raised): each frame is the shaded render of the robot over a smooth
    background, not noise, and the bbox holds the rendered silhouette.
    tests/test_torch_port_vis.py holds the frames against the JAX
    writer's."""
    from horopose_tpu_torch.tools.synth_dream import \
        make_synthetic_dream_dataset
    d = make_synthetic_dream_dataset(tmp_path, n_images=1, image_hw=(96, 128),
                                     render_images=True, view_mode="upright")
    img = np.asarray(Image.open(d / "000000.jpg"), np.float32)
    noise = np.abs(np.diff(img, axis=1)).mean()
    assert img.shape == (96, 128, 3) and noise < 20, noise
    with open(d / "000000.json") as f:
        box = json.load(f)["objects"][0]["bounding_box"]
    assert box["max"][0] - box["min"][0] > 10


def test_test_network_rejects_a_jax_checkpoint(tmp_path):
    """A JAX checkpoint (flax msgpack) whose weights do not fit the
    experiment's model raises, rather than leaving the model at random
    weights. (One that fits loads: tests/test_torch_port_pnp.py.)"""
    import yaml
    from flax import serialization
    from horopose_tpu_torch.pipelines import test as port_test
    exp = tmp_path / "exp"
    (exp / "ckpt").mkdir(parents=True)
    (exp / "config.yaml").write_text(yaml.safe_dump(dict(
        urdf_robot_name="panda", image_size=64.0, backbone_name="resnet18",
        rootnet_backbone_name="resnet18")))
    (exp / "ckpt" / "model.pk").write_bytes(serialization.msgpack_serialize(
        dict(epoch=np.int64(1), params={}, batch_stats={})))
    cfg = port_test.make_test_cfg(str(exp), str(tmp_path / "panda_test"))
    with pytest.raises(RuntimeError, match="Missing key"):
        port_test.test_network(cfg, ckpt_name="model.pk", batch_size=2,
                               device="cpu")
