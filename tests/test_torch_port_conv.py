"""Port 3x3 conv against `horopose_tpu.ops.conv_pallas` on the CPU.

`pack_weights` and the plain version `conv3x3_s2d_plain` against the JAX
`pack_weights` and `conv3x3_s2d_pallas` (interpret mode, as
tests/test_conv_pallas.py runs it) and against `F.conv2d`, at that test's
two shapes; the public `conv3x3` dispatch on a CPU tensor; and the card
check of `chip_smoke.py` (`compare_conv`), which must fail a wrong output.
The CUDA kernel itself runs on the card only (`chip_smoke.py` phase 3c).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from horopose_tpu.ops.conv_pallas import conv3x3_s2d_pallas
from horopose_tpu.ops.conv_pallas import pack_weights as jax_pack_weights
from horopose_tpu_torch.ops import conv3x3_cuda
from horopose_tpu_torch.ops.conv3x3 import (conv3x3, conv3x3_s2d_plain,
                                            pack_weights)

# tests/test_conv_pallas.py's shapes and its f32 tolerance
SHAPES = [(2, 8, 8, 32, 32), (4, 16, 12, 8, 16)]
F32_TOL = 1e-4
# bf16 outputs of two f32 accumulations in another order may round to
# neighbouring bf16 values: one bf16 ulp of the entry (2^-7 |y| is at
# least one) on top of the f32 tolerance
BF16_RTOL = 2.0 ** -7


def _inputs(rng, shape, dtype=np.float32):
    B, H, W, C, Fo = shape
    return (rng.randn(B, H, W, C).astype(dtype),
            (rng.randn(3, 3, C, Fo) * 0.1).astype(dtype))


def _lib(x, w):
    """F.conv2d in float64 on NHWC / HWIO tensors -> NHWC."""
    y = F.conv2d(x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
                 padding=1)
    return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize("C,Fo", [(32, 32), (8, 16), (5, 7)])
def test_pack_weights_equals_jax(C, Fo, rng):
    w = (rng.randn(3, 3, C, Fo) * 0.1).astype(np.float32)
    ref = np.asarray(jax_pack_weights(jnp.asarray(w)))
    out = pack_weights(torch.from_numpy(w)).numpy()
    assert out.shape == ref.shape == (16 * C, 4 * Fo)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_and_conv2d(shape, rng):
    x, w = _inputs(rng, shape)
    ref = np.asarray(conv3x3_s2d_pallas(jnp.asarray(x), jnp.asarray(w),
                                        block_b=2))
    out = conv3x3_s2d_plain(torch.from_numpy(x), torch.from_numpy(w))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(
        out.numpy(), _lib(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_bf16_matches_pallas_bf16(shape, rng):
    """bf16 in and out, f32 accumulation in both packages."""
    x, w = _inputs(rng, shape)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    ref = np.asarray(conv3x3_s2d_pallas(xb, wb, block_b=2), np.float32)
    xt = torch.from_numpy(x).bfloat16()
    wt = torch.from_numpy(w).bfloat16()
    out = conv3x3_s2d_plain(xt, wt)
    assert out.dtype == torch.bfloat16
    out = out.float().numpy()
    tol = BF16_RTOL * np.abs(ref) + F32_TOL
    assert (np.abs(out - ref) <= tol).all()
    # against F.conv2d on the same bf16 values, rounded once
    lib = _lib(xt.float(), wt.float()).bfloat16().float().numpy()
    assert (np.abs(out - lib) <= BF16_RTOL * np.abs(lib) + F32_TOL).all()


def test_plain_rejects_odd_sizes():
    with pytest.raises(ValueError, match="even"):
        conv3x3_s2d_plain(torch.zeros(1, 5, 4, 3), torch.zeros(3, 3, 3, 2))


def test_conv3x3_takes_the_plain_version_on_the_cpu(rng):
    """A CPU tensor never reaches the kernel: no launch is counted."""
    x, w = (torch.from_numpy(a) for a in _inputs(rng, SHAPES[1]))
    before = conv3x3_cuda.conv3x3_nhwc.launches
    want = conv3x3_s2d_plain(x, w)
    for out in (conv3x3(x, w), conv3x3(x, w, use_kernel=False),
                conv3x3_cuda.conv3x3_nhwc(x, w)):
        assert torch.equal(out, want)
    assert conv3x3_cuda.conv3x3_nhwc.launches == before


def test_wrapper_raises_for_a_device_without_kernel():
    x = torch.zeros(1, 4, 4, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        conv3x3_cuda.conv3x3_nhwc(x, torch.zeros(3, 3, 3, 2, device="meta"))


def _mutations(x, w):
    """Outputs with one deliberate fault each: a tap dropped, w transposed
    in (C, F), the halo read one pixel off along W."""
    no_tap = w.clone()
    no_tap[1, 2] = 0
    shifted = torch.zeros_like(x)
    shifted[:, :, :-1] = x[:, :, 1:]
    return {"tap dropped": conv3x3_s2d_plain(x, no_tap),
            "w transposed": conv3x3_s2d_plain(x, w.transpose(2, 3)),
            "halo off by one": conv3x3_s2d_plain(shifted, w)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_check_passes_a_right_output_and_fails_wrong_ones(dtype, rng):
    """chip_smoke.compare_conv, rehearsed on the CPU: an output rounded
    once from float64 passes; each fault fails it."""
    x, w = (torch.from_numpy(a).to(dtype) for a in
            _inputs(rng, (2, 8, 8, 16, 16)))
    y_plain = conv3x3_s2d_plain(x, w)
    y_lib = _lib(x, w).to(dtype)
    errs = chip_smoke.compare_conv(y_lib, y_plain, y_lib, "rounded once")
    assert errs["n_over_tol"] == 0
    for name, bad in _mutations(x, w).items():
        with pytest.raises(AssertionError):
            chip_smoke.compare_conv(bad, y_plain, y_lib, name)


def test_bound_counts_bytes_and_operations():
    """The bench's bound at the target shape: bytes bound bf16 (input and
    output, 67.1 MB), the float32 units bound float32."""
    from horopose_tpu_torch.tools.bench_conv import SHAPE, bound_ms
    ms, by = bound_ms(*SHAPE, torch.bfloat16)
    assert by == "bytes"
    assert ms == pytest.approx((2 * 128 * 64 * 64 * 32 + 9 * 32 * 32) * 2
                               / 3.35e12 * 1e3)
    ms, by = bound_ms(*SHAPE, torch.float32)
    assert by == "operations"
    assert ms == pytest.approx(2 * 128 * 64 * 64 * 9 * 32 * 32 / 67e12 * 1e3)


@pytest.mark.parametrize("per_sm", [conv3x3_cuda.BLOCKS_PER_SM,
                                    conv3x3_cuda.F32_BLOCKS_PER_SM])
@pytest.mark.parametrize("H,W,Fo", [(64, 64, 32), (10, 14, 7), (6, 6, 48),
                                    (2, 130, 33)])
def test_conv_tiles_cover_every_output_once(H, W, Fo, per_sm):
    """Either kernel's persistent blocks (one an SM in bf16, two in
    float32), each walking tiles i, i + blocks, ..., write every output
    (b, y, x, f) exactly once, for 1 to 1024 images and ragged H, W and
    F."""
    from horopose_tpu_torch.ops.conv3x3_cuda import (TILE_COLS, TILE_F,
                                                     TILE_ROWS, conv_tiles,
                                                     plan_blocks, tile_origin)
    for B in ((1, 2, 5) if H * W > 1000 else (1, 2, 5, 128, 1024)):
        n = conv_tiles(B, H, W, Fo)
        blocks = plan_blocks(n, 132, per_sm)
        cover = np.zeros((B, H, W, Fo), np.int32)
        for block in range(blocks):
            for t in range(block, n, blocks):
                fc, b, y0, x0 = tile_origin(t, B, H, W)
                cover[b, y0:y0 + TILE_ROWS, x0:x0 + TILE_COLS,
                      fc * TILE_F:(fc + 1) * TILE_F] += 1
        assert (cover == 1).all()


def _one_ulp_off(y: torch.Tensor) -> torch.Tensor:
    """y with every entry moved one ulp of its dtype away from zero."""
    if y.dtype == torch.float32:
        return torch.nextafter(y, y.sign() * float("inf"))
    yf = y.float()
    ulp = torch.exp2(torch.floor(torch.log2(yf.abs().clamp(min=1e-30))) - 7)
    return (yf + yf.sign() * ulp).to(y.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_check_at_a_ragged_shape(dtype, rng):
    """chip_smoke.compare_conv at C = 5, F = 7, where the bf16 kernel stages
    its halo with scalar loads and stores scalars: an output rounded once
    from float64 and one a ulp off pass; a dropped tap, w transposed in
    (C, F) (on its 5 x 5 square) and a halo one pixel off fail."""
    x, w = (torch.from_numpy(a).to(dtype) for a in
            _inputs(rng, (2, 8, 8, 5, 7)))
    y_plain = conv3x3_s2d_plain(x, w)
    y_lib = _lib(x, w).to(dtype)
    off = _one_ulp_off(y_plain)
    assert not torch.equal(off, y_plain)
    for name, good in (("rounded once", y_lib), ("one ulp off", off)):
        errs = chip_smoke.compare_conv(good, y_plain, y_lib, name)
        assert errs["n_over_tol"] == 0
    no_tap, square = w.clone(), w.clone()
    no_tap[1, 2] = 0
    square[:, :, :, :5] = w[:, :, :, :5].transpose(2, 3)
    shifted = torch.zeros_like(x)
    shifted[:, :, :-1] = x[:, :, 1:]
    for name, y in (("tap dropped", conv3x3_s2d_plain(x, no_tap)),
                    ("w transposed", conv3x3_s2d_plain(x, square)),
                    ("halo off by one", conv3x3_s2d_plain(shifted, w))):
        with pytest.raises(AssertionError):
            chip_smoke.compare_conv(y, y_plain, y_lib, name)


# csrc/conv3x3.cu's float32 kernel: kFK input channels a staged chunk, a
# patch of (TILE_ROWS + 2) x (TILE_COLS + 2) pixels
F32_CHUNK = 8


def _f32_tile_mirror(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain mirror of the float32 kernel: for every tile (`tile_origin`)
    and chunk of F32_CHUNK input channels, the zero-filled patch and weight
    slab it stages (zeros outside the image, past C and past F), each
    output row's 8-pixel segments taking all three kx taps from one row of
    the patch, float32 sums over the chunks, and the write-back masked to
    the image and to F."""
    from horopose_tpu_torch.ops.conv3x3_cuda import (TILE_COLS, TILE_F,
                                                     TILE_ROWS, conv_tiles,
                                                     tile_origin)
    B, H, W, C = x.shape
    Fo = w.shape[3]
    xp = F.pad(x.float(), (0, 0, 1, TILE_COLS + 1, 1, TILE_ROWS + 1))
    y = torch.full((B, H, W, Fo), float("nan"))
    for t in range(conv_tiles(B, H, W, Fo)):
        fc, b, oy0, ox0 = tile_origin(t, B, H, W)
        f0 = fc * TILE_F
        acc = torch.zeros(TILE_ROWS, TILE_COLS, TILE_F)
        for c0 in range(0, C, F32_CHUNK):
            patch = torch.zeros(TILE_ROWS + 2, TILE_COLS + 2, F32_CHUNK)
            got = xp[b, oy0:oy0 + TILE_ROWS + 2, ox0:ox0 + TILE_COLS + 2,
                     c0:c0 + F32_CHUNK]
            patch[:, :, :got.shape[2]] = got
            slab = torch.zeros(3, 3, F32_CHUNK, TILE_F)
            part = w[:, :, c0:c0 + F32_CHUNK, f0:f0 + TILE_F].float()
            slab[:, :, :part.shape[2], :part.shape[3]] = part
            for ky in range(3):
                seg = patch[ky:ky + TILE_ROWS]      # the rows of this ky
                for kx in range(3):
                    acc += seg[:, kx:kx + TILE_COLS] @ slab[ky, kx]
        rows, cols = min(TILE_ROWS, H - oy0), min(TILE_COLS, W - ox0)
        fs = min(TILE_F, Fo - f0)
        y[b, oy0:oy0 + rows, ox0:ox0 + cols, f0:f0 + fs] = \
            acc[:rows, :cols, :fs]
    return y.to(x.dtype)


@pytest.mark.parametrize("shape", [*SHAPES, (3, 10, 14, 5, 7),
                                   (2, 6, 6, 32, 48), (1, 8, 8, 20, 16),
                                   (1, 10, 66, 3, 33)])
def test_f32_tile_mirror_matches_plain_and_pallas(shape, rng):
    """The float32 kernel's tiles, chunks and zero fills, mirrored, pass
    the card's own check against the plain version and float64 F.conv2d
    (`chip_smoke.compare_conv`, CONV_F32_REL of max |y|) and agree with
    the Pallas kernel (interpret mode) at F32_TOL, at ragged C (5, 20, 3),
    F (7, 48, 33) and H, W past one tile (10 rows, 66 columns)."""
    x, w = _inputs(rng, shape)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    y = _f32_tile_mirror(xt, wt)
    errs = chip_smoke.compare_conv(y, conv3x3_s2d_plain(xt, wt),
                                   _lib(xt, wt).float(), f"mirror {shape}")
    assert errs["n_over_tol"] == 0
    ref = np.asarray(conv3x3_s2d_pallas(jnp.asarray(x), jnp.asarray(w),
                                        block_b=1))
    np.testing.assert_allclose(y.numpy(), ref, rtol=F32_TOL, atol=F32_TOL)
