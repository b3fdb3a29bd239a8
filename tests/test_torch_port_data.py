"""The port's DREAM data path and metrics against the JAX package, on the
CPU.

A 7-frame panda set at 480x640 is written by the JAX package's writer
(`tests/fixtures.py`) into a temporary directory, and the JAX dataset reads
it as the JAX tests read it, native decode and crop included. The port's
`DreamDataset` must give the same geometry (rtol 1e-6, atol 1e-4 px) with
augmentations off, for both crops and with padding, truncation handling,
the flip and the bbox jitter under a seed; the crops equal bit for bit
(both packages crop with their copy of the same native C++); each
augmentation function the same output bit for bit at three seeds, with
`random.Random(s)` / `RandomState(s)` in place of `random.seed(s)` /
`np.random.seed(s)`. Also: samplers, `collate`, `pad_batch`,
`get_dataloaders`, the loader's independence of its worker count, the
metrics (rtol 1e-6), `euler_from_rotmat` (atol 1e-5), the decode cache, FK
of the base-frame keypoints and the port's DREAM writer.
"""

import json
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from fixtures import make_synthetic_dream_dataset
from horopose_tpu import native
from horopose_tpu.config import make_cfg as jax_make_cfg
from horopose_tpu.core import metrics as JM
from horopose_tpu.data import augmentations as JA
from horopose_tpu.data import roboutils as JRU
from horopose_tpu.data import samplers as JS
from horopose_tpu.data.dream import DreamDataset as JaxDreamDataset
from horopose_tpu.kinematics import Robot as JaxRobot
from horopose_tpu.ops.rotations import euler_from_rotmat as jax_euler
from horopose_tpu.pipelines.common import get_dataloaders as jax_loaders
from horopose_tpu_torch.config import make_cfg
from horopose_tpu_torch.core import metrics as PM
from horopose_tpu_torch.data import augmentations as PA
from horopose_tpu_torch.data import roboutils as PRU
from horopose_tpu_torch.data import samplers as PS
from horopose_tpu_torch.data.cache import DecodedImageCache
from horopose_tpu_torch.data.dream import DreamDataset, sample_generators
from horopose_tpu_torch.kinematics import Robot
from horopose_tpu_torch.ops.rotations import euler_from_rotmat
from horopose_tpu_torch.parallel.prefetch import prefetch_to_device
from horopose_tpu_torch.pipelines.common import get_dataloaders
from horopose_tpu_torch.tools import synth_dream, warm_cache

N_FRAMES = 7
RTOL, ATOL = 1e-6, 1e-4
SEEDS = (0, 1, 2)
HW = dict(rootnet_resize_hw=(64, 64), other_resize_hw=(96, 96))
NO_AUGS = dict(color_jitter=False, rgb_augmentation=False,
               occlusion_augmentation=False)
OPTIONS = {
    "plain": {},
    "padding": dict(padding=True),
    "truncation": dict(process_truncation=True),
    "flip": dict(flip=True),
    "bbox_jitter": dict(strict_crop=False),
}


@pytest.fixture(scope="module")
def dream_dir(tmp_path_factory):
    return str(make_synthetic_dream_dataset(
        tmp_path_factory.mktemp("dream"), "panda", n_images=N_FRAMES,
        seed=4, split="train_dr"))


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _needs_native():
    if native.get_lib() is None:
        pytest.skip("the JAX package's native crop did not build (no g++)")


def _jax_sample(ds, idx, seed):
    random.seed(seed)
    np.random.seed(seed)
    return ds[idx]


def _port_sample(ds, idx, seed):
    return ds.get(idx, random.Random(seed), np.random.RandomState(seed))


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}{k}/")
        else:
            yield f"{path}{k}", v


def _compare_samples(ref, ours):
    """Same keys, shapes and dtypes; geometry at RTOL/ATOL; the uint8
    crops equal."""
    ref, ours = dict(_leaves(ref)), dict(_leaves(ours))
    assert sorted(ref) == sorted(ours)
    for key, a in ref.items():
        a, b = np.asarray(a), np.asarray(ours[key])
        assert a.shape == b.shape and a.dtype == b.dtype, key
        if a.dtype == np.uint8:
            assert np.array_equal(a, b), key
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                       err_msg=key)


# ---- the dataset ----

@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_dataset_geometry_matches_jax(dream_dir, option, one_thread):
    """K, keypoints, bboxes, masks, TCO, jointpose and image_id of every
    sample, both crops, augmentations off, equal JAX's."""
    _needs_native()
    kw = dict(HW, **NO_AUGS, **OPTIONS[option])
    ref, ours = JaxDreamDataset(dream_dir, **kw), DreamDataset(dream_dir, **kw)
    assert len(ref) == len(ours) == N_FRAMES
    for i in range(N_FRAMES):
        a, b = _jax_sample(ref, i, seed=i), _port_sample(ours, i, seed=i)
        for key in ("K", "keypoints_2d", "keypoints_3d", "valid_mask_crop",
                    "bbox_strict_bounded", "bbox_gt2d_extended"):
            for crop in ("root", "other"):
                np.testing.assert_allclose(b[crop][key], a[crop][key],
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=f"{crop}/{key}")
        for key in ("valid_mask", "TCO", "jointpose", "image_id",
                    "K_original", "keypoints_2d_original",
                    "bbox_strict_bounded_original",
                    "bbox_gt2d_extended_original"):
            np.testing.assert_allclose(b[key], a[key], rtol=RTOL,
                                       atol=ATOL, err_msg=key)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_dataset_pixels_and_layout_match_jax(dream_dir, option, one_thread):
    """Every key, shape and dtype; the uint8 crops bit for bit."""
    _needs_native()
    kw = dict(HW, **NO_AUGS, **OPTIONS[option])
    ref, ours = JaxDreamDataset(dream_dir, **kw), DreamDataset(dream_dir, **kw)
    for i in range(N_FRAMES):
        _compare_samples(_jax_sample(ref, i, seed=10 + i),
                         _port_sample(ours, i, seed=10 + i))


@pytest.mark.parametrize("seed", SEEDS)
def test_dataset_with_every_augmentation_matches_jax(dream_dir, seed,
                                                     one_thread):
    """Color jitter, occlusion, the Pillow enhancers, bbox jitter, flip and
    zoom-out padding on: the same draws in the same order give the same
    samples."""
    _needs_native()
    kw = dict(HW, strict_crop=False, flip=True, padding=True)
    ref, ours = JaxDreamDataset(dream_dir, **kw), DreamDataset(dream_dir, **kw)
    for i in range(N_FRAMES):
        _compare_samples(_jax_sample(ref, i, seed=100 * seed + i),
                         _port_sample(ours, i, seed=100 * seed + i))


def test_dataset_keys_seed_the_draws(dream_dir, one_thread):
    """dataset[(seed, epoch, idx)] draws from sample_generators(seed, epoch,
    idx); dataset[idx] is epoch 0 of the default seed."""
    ds = DreamDataset(dream_dir, **HW)
    a = ds[(5, 2, 3)]
    b = ds.get(3, *sample_generators(5, 2, 3))
    c = ds[(5, 3, 3)]
    assert np.array_equal(a["other"]["images"], b["other"]["images"])
    assert not np.array_equal(a["other"]["images"], c["other"]["images"])
    d = ds[3]
    e = ds[(808, 0, 3)]
    assert np.array_equal(d["root"]["images"], e["root"]["images"])


# ---- augmentations and bbox bookkeeping, bit for bit ----

def _frame(seed):
    return np.random.RandomState(seed).randint(0, 256, (120, 160, 3),
                                               dtype=np.uint8)


AUGMENTATIONS = {
    "occlusion_aug": (
        lambda s: JA.occlusion_aug((10, 20, 150, 110), (120, 160)),
        lambda s, r, n: PA.occlusion_aug((10, 20, 150, 110), (120, 160), r)),
    "apply_occlusion": (
        lambda s: JA.apply_occlusion(_frame(s), (10, 20, 150, 110), p=0.9),
        lambda s, r, n: PA.apply_occlusion(_frame(s), (10, 20, 150, 110),
                                           0.9, r, n)),
    "apply_color_jitter": (
        lambda s: JA.apply_color_jitter(_frame(s), p=0.9),
        lambda s, r, n: PA.apply_color_jitter(_frame(s), r, p=0.9)),
    "apply_pillow_augs": (
        lambda s: JA.apply_pillow_augs(_frame(s)),
        lambda s, r, n: PA.apply_pillow_augs(_frame(s), r)),
    "get_bbox_jitter": (
        lambda s: JRU.get_bbox((40.5, 30.2, 90.7, 70.1), 160, 120,
                               strict=False),
        lambda s, r, n: PRU.get_bbox((40.5, 30.2, 90.7, 70.1), 160, 120,
                                     strict=False, rng=r)),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(AUGMENTATIONS))
def test_augmentation_matches_jax_bit_for_bit(name, seed):
    jax_fn, port_fn = AUGMENTATIONS[name]
    random.seed(seed)
    np.random.seed(seed)
    ref = jax_fn(seed)
    ours = port_fn(seed, random.Random(seed), np.random.RandomState(seed))
    ref, ours = np.asarray(ref), np.asarray(ours)
    assert ref.dtype == ours.dtype and ref.shape == ours.shape
    assert np.array_equal(ref, ours)


@pytest.mark.parametrize("seed", SEEDS)
def test_deterministic_geometry_helpers_match_jax(seed):
    """resize_image, crop_resize_to_aspect, the flip, get_bbox_raw,
    get_extended_bbox and bbox_transform: equal outputs."""
    rng = np.random.RandomState(seed)
    img = _frame(seed)
    K = np.array([[300.0, 0, 80.5], [0, 310.0, 60.2], [0, 0, 1]])
    kp2d = rng.uniform(0, 100, (7, 2))
    kp3d = np.concatenate([rng.uniform(-0.3, 0.3, (7, 2)),
                           rng.uniform(1, 2, (7, 1))], -1)
    bbox = (12, 9, 131, 97)
    pairs = [(ja, pa) for ja, pa in [
        (JRU.resize_image(img, bbox, kp2d, K),
         PRU.resize_image(img, bbox, kp2d, K)),
        (JA.crop_resize_to_aspect(img[:100, :100], K, kp3d, (64, 64)),
         PA.crop_resize_to_aspect(img[:100, :100], K, kp3d, (64, 64))),
        (JA.flip_image_and_annotations(img, kp2d, K, [[1, 2], [3, 4]]),
         PA.flip_image_and_annotations(img, kp2d, K, [[1, 2], [3, 4]])),
        ((JRU.get_bbox_raw(kp2d.ravel()[:4]),),
         (PRU.get_bbox_raw(kp2d.ravel()[:4]),)),
        ((JRU.get_extended_bbox(bbox, 3, 4, 5, 6, True, (100, 90)),),
         (PRU.get_extended_bbox(bbox, 3, 4, 5, 6, True, (100, 90)),)),
        ((JRU.bbox_transform(bbox, np.linalg.inv(K), 2 * K, (64, 64)),),
         (PRU.bbox_transform(bbox, np.linalg.inv(K), 2 * K, (64, 64)),)),
    ]]
    for ja, pa in pairs:
        for a, b in zip(ja, pa):
            assert np.array_equal(np.asarray(a), np.asarray(b))


# ---- samplers, collate, pad_batch, loaders ----

def test_samplers_match_jax():
    class Sized:
        def __len__(self):
            return 50
    for _ in range(2):      # the second epoch draws a new permutation too
        ref, ours = JS.PartialSampler(Sized(), 20), PS.PartialSampler(
            Sized(), 20)
        assert len(ref) == len(ours) == 20
        assert [list(ref), list(ref)] == [list(ours), list(ours)]
    w = np.arange(1.0, 11.0)
    assert list(JS.WeightedRandomSampler(w, 30)) == \
        list(PS.WeightedRandomSampler(w, 30))
    assert list(PS.ListSampler([4, 1, 3])) == [4, 1, 3]


def test_collate_and_pad_batch_match_jax(dream_dir, one_thread):
    ds = DreamDataset(dream_dir, **HW, **NO_AUGS)
    samples = [ds[i] for i in range(3)]
    ref, ours = JS.collate(samples), PS.collate(samples)
    ref_pad, n_ref = JS.pad_batch(ref, 5)
    ours_pad, n_ours = PS.pad_batch(ours, 5)
    assert n_ref == n_ours == 3
    for a_tree, b_tree in ((ref, ours), (ref_pad, ours_pad)):
        a, b = dict(_leaves(a_tree)), dict(_leaves(b_tree))
        assert sorted(a) == sorted(b)
        for key in a:
            assert isinstance(b[key], torch.Tensor), key
            assert b[key].numpy().dtype == a[key].dtype, key
            assert np.array_equal(b[key].numpy(), a[key]), key


def _write_cfg(tmp_path, dream_dir, **extra):
    values = dict(exp_name="data", urdf_robot_name="panda", batch_size=3,
                  epoch_size=5, n_dataloader_workers=0, image_size=64.0,
                  train_ds_names=dream_dir)
    values.update(extra)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(values))
    return str(path)


def test_get_dataloaders_matches_jax(dream_dir, tmp_path, one_thread):
    """The train loader and the test loaders found by the train_dr ->
    test_dr rule: keys, len, batch_size, drop_last; an eval loader keeps
    its partial batch."""
    test_dir = make_synthetic_dream_dataset(
        os.path.dirname(os.path.dirname(dream_dir)), "panda", n_images=4,
        seed=9, split="test_dr")
    try:
        path = _write_cfg(tmp_path, dream_dir)
        ref, ours = jax_loaders(jax_make_cfg(path)), get_dataloaders(
            make_cfg(path), device="cpu")
        assert sorted(ref) == sorted(ours) == ["test", "train",
                                               "train_dataset"]
        assert sorted(ref["test"]) == sorted(ours["test"]) == ["dr"]
        for a, b in ((ref["train"], ours["train"]),
                     (ref["test"]["dr"], ours["test"]["dr"])):
            assert (len(a), a.batch_size, a.drop_last) == \
                (len(b), b.batch_size, b.drop_last)
        assert len(ours["train"]) == 1 and len(ours["test"]["dr"]) == 2
        sizes = [int(b["TCO"].shape[0]) for b in ours["test"]["dr"]]
        assert sizes == [3, 1]
        assert len(ours["train_dataset"]) == N_FRAMES
    finally:
        for name in os.listdir(test_dir):
            os.remove(os.path.join(test_dir, name))
        os.rmdir(test_dir)


def test_loader_batches_match_the_jax_loader(dream_dir, tmp_path,
                                             one_thread):
    """Augmentations off: the same sampler order and the same samples, so
    one epoch of the port's train loader is the JAX loader's epoch."""
    _needs_native()
    path = _write_cfg(tmp_path, dream_dir, jitter=False, other_aug=False,
                      occlusion=False, batch_size=2, epoch_size=6)
    ref = jax_loaders(jax_make_cfg(path))["train"]
    ours = get_dataloaders(make_cfg(path), device="cpu")["train"]
    n = 0
    for a, b in zip(ref, ours):
        _compare_samples(a, {k: v.numpy() if isinstance(v, torch.Tensor)
                             else {kk: vv.numpy() for kk, vv in v.items()}
                             for k, v in b.items()})
        n += 1
    assert n == len(ours) == 3


def _epoch(loader):
    return [dict(_leaves(b)) for b in loader]


def test_loader_batches_do_not_depend_on_the_worker_count(dream_dir,
                                                          tmp_path,
                                                          one_thread):
    """Every augmentation on: 0 and 2 worker processes give the same
    batches, epoch for epoch, and the second epoch differs from the
    first."""
    path = _write_cfg(tmp_path, dream_dir, rootnet_flip=True, batch_size=2,
                      epoch_size=4)
    epochs = {}
    for workers in (0, 2):
        cfg = make_cfg(path)
        cfg.n_dataloader_workers = workers
        loader = get_dataloaders(cfg, device="cpu")["train"]
        epochs[workers] = [_epoch(loader), _epoch(loader)]
        loader.close()
    for e0, e2 in zip(epochs[0], epochs[2]):
        assert len(e0) == len(e2) == 2
        for a, b in zip(e0, e2):
            assert sorted(a) == sorted(b)
            for key in a:
                assert torch.equal(a[key], b[key]), key
    first, second = epochs[0]
    assert not torch.equal(first[0]["other/images"],
                           second[0]["other/images"])


def test_prefetch_takes_batches_ahead_on_the_cpu():
    """The consumer's first batch arrives after `size` more were taken
    from the loader; every batch arrives, in order, unchanged."""
    batches = [{"a": torch.arange(3) + i, "n": {"b": torch.ones(2) * i}}
               for i in range(4)]
    for size in (0, 2):
        taken = []

        def source():
            for i, b in enumerate(batches):
                taken.append(i)
                yield b

        it = prefetch_to_device(source(), "cpu", size)
        first = next(it)
        assert len(taken) == size + 1
        out = [first] + list(it)
        assert len(out) == 4
        assert all(torch.equal(o["a"], b["a"]) and
                   torch.equal(o["n"]["b"], b["n"]["b"])
                   for o, b in zip(out, batches))


# ---- metrics ----

def _metric_inputs(seed, robot_type):
    rng = np.random.RandomState(seed)
    B, nk, dof = 5, (7 if robot_type == "panda" else 8), \
        (8 if robot_type == "panda" else 7)
    gt3 = np.concatenate([rng.uniform(-0.5, 0.5, (B, nk, 2)),
                          rng.uniform(1, 2, (B, nk, 1))], -1)
    K = np.tile(np.array([[320.0, 0, 320], [0, 320, 240], [0, 0, 1]]),
                (B, 1, 1))
    gt2 = np.einsum("bij,bnj->bni", K, gt3)
    gt2 = gt2[..., :2] / gt2[..., 2:]
    gt2[0, 0] = (700.0, 20.0)          # outside the 640x480 frame mask
    return dict(gt_keypoints3d=gt3.astype(np.float32),
                gt_keypoints2d=gt2.astype(np.float32),
                K_original=K.astype(np.float32),
                gt_joint=rng.uniform(-1, 1, (B, dof)).astype(np.float32),
                pred_keypoints3d=(gt3 + rng.normal(0, 0.03, gt3.shape)
                                  ).astype(np.float32),
                pred_joint=rng.uniform(-1, 1, (B, dof)).astype(np.float32))


@pytest.mark.parametrize("robot_type", ["panda", "kuka"])
@pytest.mark.parametrize("with_joints", [True, False])
def test_compute_metrics_batch_matches_jax(robot_type, with_joints):
    kw = _metric_inputs(3, robot_type)
    if not with_joints:
        kw["pred_joint"] = None

    class R:
        dof = kw["gt_joint"].shape[1]
    R.robot_type = robot_type
    ref = JM.compute_metrics_batch(robot=R, reference_keypoint_id=3, **kw)
    ours = PM.compute_metrics_batch(robot=R, reference_keypoint_id=3, **kw)
    assert sorted(ref) == sorted(ours)
    for key in ref:
        np.testing.assert_allclose(np.asarray(ours[key], np.float64),
                                   np.asarray(ref[key], np.float64),
                                   rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("seed", SEEDS)
def test_auc_and_summary_match_jax(seed):
    rng = np.random.RandomState(seed)
    alldis = dict(dis3d=list(rng.uniform(0, 0.15, 40)),
                  dis2d=list(rng.uniform(0, 30, 40)))
    assert PM._auc(alldis["dis3d"], 0.1, 1e-5) == pytest.approx(
        JM._auc(alldis["dis3d"], 0.1, 1e-5), rel=1e-6)
    ref, ours = JM.summary_add_pck(alldis), PM.summary_add_pck(alldis)
    assert sorted(ref) == sorted(ours)
    for key in ref:
        assert ours[key] == pytest.approx(ref[key], rel=1e-6), key
    assert PM.ADD_THRESHOLDS_MM == JM.ADD_THRESHOLDS_MM
    assert PM.PCK_THRESHOLDS_PX == JM.PCK_THRESHOLDS_PX


# ---- rotations, FK, the cache, the writer ----

def _random_rotations(rng, n):
    q, r = np.linalg.qr(rng.randn(n, 3, 3))
    q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q


def _rot_y(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rot_x(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


@pytest.mark.parametrize("case", ["random", "gimbal_lock"])
def test_euler_from_rotmat_matches_jax(case):
    """At random rotations, and at a pitch of +-90 degrees, 1e-7 off it
    (both the singular branch) and 1e-3 off it, after a roll."""
    if case == "random":
        R = _random_rotations(np.random.RandomState(7), 64)
    else:
        R = np.stack([_rot_y(s * (np.pi / 2 - d)) @ _rot_x(a)
                      for s in (1, -1) for d in (0.0, 1e-7, 1e-3)
                      for a in (0.3, -1.2)])
    R = R.astype(np.float32)
    ref = np.asarray(jax_euler(jnp.asarray(R)))
    ours = euler_from_rotmat(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_base_frame_keypoints_match_jax(rng):
    q = rng.uniform(-1, 1, (4, 8)).astype(np.float32)
    ref = np.asarray(JaxRobot("panda").get_keypoints_only_fk(jnp.asarray(q)))
    ours = Robot("panda", device="cpu").get_keypoints_only_fk(
        torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_decode_cache_round_trips(dream_dir, tmp_path):
    """A port cache in tmp_path: misses, then the decoded frame back
    bit for bit, across a reopen; warm_cache fills the rest."""
    ds = DreamDataset(dream_dir, **HW)
    rgb = np.asarray(__import__("PIL.Image", fromlist=["Image"]).open(
        ds.frame_index[2]["rgb_path"]).convert("RGB"))
    cache = DecodedImageCache(tmp_path / "cache", N_FRAMES, fingerprint="x")
    assert cache.get(2) is None
    cache.put(2, rgb)
    assert np.array_equal(cache.get(2), rgb)
    again = DecodedImageCache(tmp_path / "cache", N_FRAMES, fingerprint="x")
    assert np.array_equal(again.get(2), rgb) and again.hit_count() == 1
    n = warm_cache.warm(dream_dir, str(tmp_path / "warm"), workers=2)
    assert n == N_FRAMES
    cached = DreamDataset(dream_dir, **HW, **NO_AUGS,
                          decode_cache_dir=str(tmp_path / "warm"))
    plain = DreamDataset(dream_dir, **HW, **NO_AUGS)
    assert np.array_equal(cached[2]["other"]["images"],
                          plain[2]["other"]["images"])


def test_port_writer_matches_the_jax_writer(tmp_path):
    """Same seed: the same jpg bytes and the same annotations (up to
    float32 FK rounding)."""
    ref = make_synthetic_dream_dataset(tmp_path / "jax", "panda",
                                       n_images=2, seed=6, split="test_dr")
    ours = synth_dream.make_synthetic_dream_dataset(
        tmp_path / "port", "panda", n_images=2, seed=6, split="test_dr")
    assert sorted(os.listdir(ref)) == sorted(os.listdir(ours))
    for name in sorted(os.listdir(ref)):
        a, b = (ref / name).read_bytes(), (ours / name).read_bytes()
        if name.endswith(".jpg") or name.startswith("_"):
            assert a == b, name
            continue
        ja, jb = json.loads(a), json.loads(b)
        oa, ob = ja["objects"][0], jb["objects"][0]
        assert oa["quaternion_xyzw"] == ob["quaternion_xyzw"]
        assert ja["sim_state"] == jb["sim_state"]
        for ka, kb in zip(oa["keypoints"], ob["keypoints"]):
            assert ka["name"] == kb["name"]
            np.testing.assert_allclose(kb["location"], ka["location"],
                                       atol=1e-3)          # cm
            np.testing.assert_allclose(kb["projected_location"],
                                       ka["projected_location"], atol=1e-3)
