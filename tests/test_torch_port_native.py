"""The port's native host C++ (`horopose_tpu_torch/native/`) against the
JAX package's and against the plain versions, on the CPU.

- `crop_resize_bilinear` equals the JAX `horopose_tpu.native` crop byte
  for byte over seeded frames and bboxes inside the frame, partly outside
  it, tall, wide and 1 pixel; `crop_resize_bilinear_batch` equals the
  single call frame by frame;
- the native crop against `data/crop.py` (the plain version, which the
  serving path runs on the card): at most one level apart, on at most
  0.1% of values (the native build may fuse multiply-adds);
- `decode_jpeg` equals PIL byte for byte (skipped only where the build
  had no libjpeg, and the skip says so), and the dataset decodes with it;
- a build from an empty build directory raises, naming g++, when no
  compiler is on PATH, and raises with the compiler's message when the
  source does not compile; there is no fallback;
- a loader with 2 worker processes over a dataset whose build directory
  is empty builds the library once, in the parent.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from fixtures import make_synthetic_dream_dataset
from horopose_tpu import native as jax_native
from horopose_tpu_torch import native
from horopose_tpu_torch.data.crop import crop_resize_bilinear as plain_crop
from horopose_tpu_torch.data.dream import DreamDataset, decode_rgb
from horopose_tpu_torch.data.samplers import DataLoader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_OFF_BY_ONE = 1e-3
N_CASES = 24


def _bbox(rng, kind, H, W):
    """[wmin, hmin, wmax, hmax] of one kind of crop window."""
    if kind == "inside":
        x0, y0 = rng.randint(0, W // 2), rng.randint(0, H // 2)
        return [x0, y0, rng.randint(x0 + 1, W + 1), rng.randint(y0 + 1, H + 1)]
    if kind == "partly_outside":
        x0, y0 = rng.randint(-W // 2, W), rng.randint(-H // 2, H)
        return [x0, y0, x0 + rng.randint(W // 4, W + 40),
                y0 + rng.randint(H // 4, H + 40)]
    if kind == "tall":
        x0, y0 = rng.randint(0, W - 4), rng.randint(-10, 10)
        return [x0, y0, x0 + rng.randint(1, 4), y0 + rng.randint(H // 2, H)]
    if kind == "wide":
        x0, y0 = rng.randint(-10, 10), rng.randint(0, H - 4)
        return [x0, y0, x0 + rng.randint(W // 2, W), y0 + rng.randint(1, 4)]
    x0, y0 = rng.randint(0, W), rng.randint(0, H)       # 1 pixel
    return [x0, y0, x0 + 1, y0 + 1]


KINDS = ("inside", "partly_outside", "tall", "wide", "one_pixel")


def _cases(kind, seed):
    """N_CASES (frame, bbox, size) triples of one kind."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(N_CASES):
        H, W = rng.randint(8, 160), rng.randint(8, 200)
        frame = rng.randint(0, 256, (H, W, 3), dtype=np.uint8)
        out.append((frame, _bbox(rng, kind, H, W),
                    int(rng.choice([1, 7, 32, 64]))))
    return out


@pytest.fixture(scope="module", autouse=True)
def jax_native_built():
    if jax_native.get_lib() is None:
        pytest.skip("the JAX package's native crop did not build (no g++)")


@pytest.mark.parametrize("kind", KINDS)
def test_crop_equals_the_jax_native_crop(kind):
    for i, (frame, bbox, size) in enumerate(_cases(kind, KINDS.index(kind))):
        ours = native.crop_resize_bilinear(frame, bbox, size)
        ref = jax_native.crop_resize_bilinear(frame, bbox, size)
        assert ours.shape == (size, size, 3) and ours.dtype == np.uint8
        assert np.array_equal(ours, ref), (kind, i, bbox, size)


def test_float_bboxes_truncate_as_the_jax_crop():
    rng = np.random.RandomState(5)
    frame = rng.randint(0, 256, (120, 160, 3), dtype=np.uint8)
    bbox = np.array([10.7, -3.2, 131.9, 99.5])
    assert np.array_equal(native.crop_resize_bilinear(frame, bbox, 48),
                          jax_native.crop_resize_bilinear(frame, bbox, 48))


def test_batch_equals_single_calls():
    rng = np.random.RandomState(6)
    frames = rng.randint(0, 256, (5, 90, 120, 3), dtype=np.uint8)
    boxes = np.stack([_bbox(rng, KINDS[i], 90, 120) for i in range(5)])
    batch = native.crop_resize_bilinear_batch(frames, boxes, 40)
    assert batch.shape == (5, 40, 40, 3)
    for i in range(5):
        assert np.array_equal(
            batch[i], native.crop_resize_bilinear(frames[i], boxes[i], 40)), i


@pytest.mark.parametrize("kind", KINDS)
def test_crop_against_the_plain_crop(kind):
    """data/crop.py computes without fused multiply-adds: one level at
    most, on at most 0.1% of values."""
    cases = _cases(kind, 10 + KINDS.index(kind))
    diffs = []
    for frame, bbox, size in cases:
        ours = native.crop_resize_bilinear(frame, bbox, size)
        plain = plain_crop(torch.from_numpy(frame)[None],
                           torch.tensor([bbox]), size)[0].numpy()
        diffs.append(np.abs(ours.astype(np.int16) - plain).ravel())
    diff = np.concatenate(diffs)
    assert diff.max() <= 1, kind
    assert (diff > 0).mean() <= MAX_OFF_BY_ONE, kind


def _jpeg(seed, shape=(48, 64, 3), quality=90):
    arr = np.random.RandomState(seed).randint(0, 256, shape, dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _needs_libjpeg():
    if native.decoder() != "libjpeg":
        pytest.skip("the native library was built without libjpeg (no "
                    "jpeglib.h for g++): PIL decodes")


@pytest.mark.parametrize("seed,shape,quality", [
    (0, (48, 64, 3), 90), (1, (61, 37, 3), 75), (2, (480, 640, 3), 95)])
def test_decode_equals_pil(seed, shape, quality, tmp_path):
    _needs_libjpeg()
    data = _jpeg(seed, shape, quality)
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert np.array_equal(native.decode_jpeg(data), ref)
    path = tmp_path / "f.jpg"
    path.write_bytes(data)
    assert np.array_equal(native.decode_jpeg(str(path)), ref)
    assert np.array_equal(decode_rgb(path), ref)


def test_decode_refuses_what_is_not_a_jpeg():
    _needs_libjpeg()
    buf = io.BytesIO()
    Image.new("RGB", (8, 8)).save(buf, format="PNG")
    assert native.decode_jpeg(buf.getvalue()) is None
    assert native.decode_jpeg(b"not an image") is None


def test_no_compiler_raises_naming_it(tmp_path):
    """No g++ on PATH and nothing built: load() raises, no fallback."""
    code = ("import sys\n"
            "import horopose_tpu_torch.native as n\n"
            "n.BUILD_DIR = sys.argv[1]\n"
            "n.load()\n")
    res = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "_build")],
                         env=dict(os.environ, PATH="", PYTHONPATH=REPO),
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert "g++ not found" in res.stderr, res.stderr
    assert not (tmp_path / "_build").exists()


def test_a_failed_compile_raises_with_the_compiler_message(tmp_path,
                                                          monkeypatch):
    bad = tmp_path / "dream_ops.cpp"
    bad.write_text("extern \"C\" void crop_resize_bilinear( {\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="error"):
        native.load()
    assert not [f for f in os.listdir(tmp_path / "_build")
                if f.endswith(".so")]


def test_loader_with_workers_builds_once_in_the_parent(tmp_path,
                                                       monkeypatch):
    """An empty build directory: the dataset's constructor builds, the 2
    forked workers reuse the parent's library, every crop is native."""
    calls = tmp_path / "compiles.txt"
    compile_ = native._compile

    def counted(*args):
        with open(calls, "a") as f:
            f.write(f"{os.getpid()}\n")
        compile_(*args)
    monkeypatch.setattr(native, "_compile", counted)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_lib", None)
    data = make_synthetic_dream_dataset(tmp_path / "dream", "panda",
                                        n_images=4, seed=3, split="train_dr")
    ds = DreamDataset(str(data), rootnet_resize_hw=(32, 32),
                      other_resize_hw=(48, 48), color_jitter=False,
                      rgb_augmentation=False, occlusion_augmentation=False)
    assert calls.read_text().split() == [str(os.getpid())]
    loader = DataLoader(ds, batch_size=2, num_workers=2)
    try:
        batches = list(loader)
    finally:
        loader.close()
    assert calls.read_text().split() == [str(os.getpid())]
    assert [f for f in os.listdir(tmp_path / "_build")
            if f.endswith(".so")] == [os.path.basename(native.build())]
    images = torch.cat([b["other"]["images"] for b in batches])
    assert images.shape == (4, 48, 48, 3)
    for i in range(4):
        assert np.array_equal(images[i].numpy(),
                              ds[i]["other"]["images"]), i
