"""Port ops against the JAX package: rotations, transforms, soft-argmax.

Inputs come from numpy seeds and go through the JAX function and its
horopose_tpu_torch counterpart on the CPU. The JAX soft-argmax runs both as
its plain jnp version and as the Pallas kernel in interpret mode, as
tests/test_integral_pallas.py runs it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horopose_tpu.ops import integral as JI
from horopose_tpu.ops import rotations as JR
from horopose_tpu.ops import transforms as JT
from horopose_tpu.ops.integral_pallas import soft_argmax_3d_pallas
from horopose_tpu_torch import cuda_build
from horopose_tpu_torch.ops import integral as TI
from horopose_tpu_torch.ops import integral_cuda
from horopose_tpu_torch.ops import rotations as TR
from horopose_tpu_torch.ops import transforms as TT

# f32 geometry: 1e-6 absolute; projections, whose outputs are pixels
# (hundreds, where one f32 ulp is ~3e-5), also get a 1e-6 relative term
ATOL = 1e-6
PIXEL_RTOL = 1e-6
# soft-argmax: f32 sums over up to 2048 terms in different orders
SAM_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _rotmats(rng, n):
    a = rng.randn(n, 3, 3)
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q.astype(np.float32)


def _K(rng, n):
    fx = rng.uniform(200, 600, n)
    fy = rng.uniform(200, 600, n)
    cx = rng.uniform(20, 60, n)
    cy = rng.uniform(20, 60, n)
    return np.stack([np.stack([fx, 0 * fx, cx], -1),
                     np.stack([0 * fx, fy, cy], -1),
                     np.stack([0 * fx, 0 * fx, 1 + 0 * fx], -1)],
                    -2).astype(np.float32)


ROTATION_CASES = {
    "rot6d_to_rotmat": (lambda rng: (rng.randn(4, 5, 6),),
                        JR.rot6d_to_rotmat, TR.rot6d_to_rotmat),
    "rotmat_to_rot6d": (lambda rng: (_rotmats(rng, 8),),
                        JR.rotmat_to_rot6d, TR.rotmat_to_rot6d),
    "quat_to_rotmat": (lambda rng: (rng.randn(3, 4),),
                       JR.quat_to_rotmat, TR.quat_to_rotmat),
    "rot_to_rotmat_6": (lambda rng: (rng.randn(6, 6),),
                        JR.rot_to_rotmat, TR.rot_to_rotmat),
    "rot_to_rotmat_4": (lambda rng: (rng.randn(6, 4),),
                        JR.rot_to_rotmat, TR.rot_to_rotmat),
    "rotmat_to_rot_6": (lambda rng: (_rotmats(rng, 5),),
                        lambda m: JR.rotmat_to_rot(m, 6),
                        lambda m: TR.rotmat_to_rot(m, 6)),
    "rotmat_to_rot_9": (lambda rng: (_rotmats(rng, 5),),
                        lambda m: JR.rotmat_to_rot(m, 9),
                        lambda m: TR.rotmat_to_rot(m, 9)),
    "geodesic_distance": (lambda rng: (_rotmats(rng, 6), _rotmats(rng, 6)),
                          JR.geodesic_distance, TR.geodesic_distance),
    "make_T": (lambda rng: (_rotmats(rng, 6), rng.randn(6, 3)),
               JR.make_T, TR.make_T),
    "make_T_broadcast": (lambda rng: (_rotmats(rng, 1)[0], rng.randn(4, 3)),
                         JR.make_T, TR.make_T),
    "invert_T": (lambda rng: (np.asarray(JR.make_T(_rotmats(rng, 6),
                                                   rng.randn(6, 3))),),
                 JR.invert_T, TR.invert_T),
}

TRANSFORM_CASES = {
    "make_K": (lambda rng: tuple(rng.uniform(10, 500, (4, 3))
                                 for _ in range(4)),
               JT.make_K, TT.make_K),
    "invert_K": (lambda rng: (_K(rng, 5),), JT.invert_K, TT.invert_K),
    "project_points": (lambda rng: (_K(rng, 3), rng.randn(3, 7, 3) * 0.3
                                    + np.array([0, 0, 1.5])),
                       JT.project_points, TT.project_points),
    "project_points_degenerate": (
        lambda rng: (_K(rng, 2), np.zeros((2, 4, 3))),
        JT.project_points, TT.project_points),
    "uvd_to_xyz": (lambda rng: (rng.uniform(-0.5, 0.5, (3, 7, 3)), 64.0,
                                np.asarray(JT.invert_K(_K(rng, 3))),
                                rng.uniform(0.5, 2.0, (3, 3)), 1.3),
                   JT.uvd_to_xyz, TT.uvd_to_xyz),
    "uvz_to_xyz_singlepoint": (lambda rng: (rng.uniform(0, 64, (4, 2)),
                                            rng.uniform(0.5, 2.0, (4, 1)),
                                            _K(rng, 4)),
                               JT.uvz_to_xyz_singlepoint,
                               TT.uvz_to_xyz_singlepoint),
    "k_value_from_bbox": (lambda rng: (np.sort(rng.uniform(0, 640, (5, 4)),
                                               axis=-1),
                                       rng.uniform(300, 600, 5),
                                       rng.uniform(300, 600, 5)),
                          JT.k_value_from_bbox, TT.k_value_from_bbox),
}


def _f32(args):
    return tuple(np.asarray(a, np.float32) if isinstance(a, np.ndarray)
                 else a for a in args)


@pytest.mark.parametrize("name", sorted(ROTATION_CASES) +
                         sorted(TRANSFORM_CASES))
def test_geometry_matches_jax(name, rng):
    make, jax_fn, torch_fn = {**ROTATION_CASES, **TRANSFORM_CASES}[name]
    args = _f32(make(rng))
    ref = np.asarray(jax_fn(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                              else a for a in args]))
    out = torch_fn(*[_t(a) if isinstance(a, np.ndarray) else a
                     for a in args]).numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    rtol = PIXEL_RTOL if name.startswith("project_points") else 0.0
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=rtol)


def test_unported_rotation_dims_raise():
    """The 9-D and quaternion maps are ported (the name is kept from when
    they raised; tests/test_torch_port_variants.py holds them against
    JAX); an unknown dimension still raises."""
    r9 = torch.eye(3).reshape(1, 9) + 0.1
    R = TR.rot_to_rotmat(r9)
    torch.testing.assert_close(R @ R.transpose(-1, -2),
                               torch.eye(3)[None], atol=1e-5, rtol=0)
    torch.testing.assert_close(TR.rotmat_to_rot(torch.eye(3)[None], 4),
                               torch.tensor([[1.0, 0, 0, 0]]))
    with pytest.raises(ValueError):
        TR.rot_to_rotmat(torch.zeros(2, 5))
    with pytest.raises(ValueError):
        TR.rotmat_to_rot(torch.eye(3)[None], 5)


# the shapes of tests/test_integral_pallas.py, plus D != H != W
SAM_SHAPES = [(2, 3, 4, 8, 8), (1, 2, 4, 8, 8), (2, 2, 4, 4, 8),
              (2, 7, 8, 16, 16), (2, 3, 5, 7, 9)]


@pytest.mark.parametrize("shape", SAM_SHAPES)
def test_soft_argmax_3d_matches_jax_and_pallas(shape, rng):
    B, K, D, H, W = shape
    logits = (rng.randn(B, K, D * H * W) * 3).astype(np.float32)
    ref = np.asarray(JI.soft_argmax_3d(jnp.asarray(logits), D, H, W))
    pallas = np.asarray(soft_argmax_3d_pallas(jnp.asarray(logits), D, H, W))
    out = TI.soft_argmax_3d(_t(logits), D, H, W).numpy()
    np.testing.assert_allclose(out, ref, atol=SAM_ATOL)
    np.testing.assert_allclose(out, pallas, atol=SAM_ATOL)
    # the kernel's CPU entry returns the same uvd and E = (uvd + 0.5) * dim
    uvd, e, _ = integral_cuda.soft_argmax_3d_fwd(
        _t(logits).reshape(B * K, D, H, W))
    np.testing.assert_allclose(uvd.numpy().reshape(B, K, 3), pallas,
                               atol=SAM_ATOL)
    dims = np.array([W, H, D], np.float32)
    np.testing.assert_allclose(e.numpy(), (uvd.numpy() + 0.5) * dims,
                               atol=SAM_ATOL * max(dims))


@pytest.mark.parametrize("use_kernel", [None, False])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_heatmap_integral_pose_fixroot_matches_jax(use_kernel, use_pallas,
                                                   rng):
    B, K, D, S = 2, 7, 8, 16
    out = (rng.randn(B, K * D, S, S) * 2).astype(np.float32)
    Kmat = _K(rng, B)
    root = np.concatenate([np.zeros((B, 2)), rng.uniform(0.5, 2, (B, 1))],
                          -1).astype(np.float32)
    kw = dict(num_joints=K, depth_dim=D, height_dim=S, width_dim=S,
              image_size=64.0, bbox_3d_shape=(1300, 1300, 1300), rootid=3,
              fixroot=True)
    ref_uvd, ref_xyz = JI.heatmap_integral_pose(
        jnp.asarray(out), K=jnp.asarray(Kmat), root_trans=jnp.asarray(root),
        use_pallas=use_pallas, **kw)
    uvd, xyz = TI.heatmap_integral_pose(_t(out), K=_t(Kmat),
                                        root_trans=_t(root),
                                        use_kernel=use_kernel, **kw)
    assert float(uvd[:, 3, 2].abs().max()) == 0.0
    np.testing.assert_allclose(uvd.numpy(), np.asarray(ref_uvd),
                               atol=SAM_ATOL)
    np.testing.assert_allclose(xyz.numpy(), np.asarray(ref_xyz),
                               atol=SAM_ATOL)


def test_heatmap_integral_joint_matches_jax(rng):
    B, dof, R = 3, 8, 32
    out = (rng.randn(B, dof, R) * 2).astype(np.float32)
    bounds = np.sort(rng.uniform(-3, 3, (dof, 2)), -1).astype(np.float32)
    ref = JI.heatmap_integral_joint(jnp.asarray(out), dof=dof,
                                    joint_bounds=jnp.asarray(bounds))
    got = TI.heatmap_integral_joint(_t(out), dof=dof,
                                    joint_bounds=_t(bounds))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=SAM_ATOL)


def test_bf16_logits_decode_as_their_f32_values(rng):
    x = torch.from_numpy(rng.randn(6, 4, 8, 8).astype(np.float32))
    xb = x.to(torch.bfloat16)
    uvd_b, e_b, st_b = integral_cuda.soft_argmax_3d_fwd(xb)
    uvd_f, e_f, st_f = TI.soft_argmax_3d_fwd_plain(xb.float())
    assert uvd_b.dtype == torch.float32 and st_b.dtype == torch.float32
    torch.testing.assert_close(uvd_b, uvd_f, rtol=0, atol=0)
    torch.testing.assert_close(e_b, e_f, rtol=0, atol=0)
    torch.testing.assert_close(st_b, st_f, rtol=0, atol=0)


def test_cpu_dispatch_never_touches_cuda_library(monkeypatch, rng):
    def no_library(*_a, **_k):
        raise AssertionError("CPU path reached the CUDA library")

    monkeypatch.setattr(cuda_build, "load", no_library)
    monkeypatch.setattr(cuda_build, "build", no_library)
    monkeypatch.setattr(integral_cuda.soft_argmax_3d_fwd, "launches", 0)
    monkeypatch.setattr(integral_cuda.soft_argmax_3d_bwd, "launches", 0)
    B, K, D, S = 2, 3, 4, 8
    out = _t(rng.randn(B, K * D, S, S).astype(np.float32)).requires_grad_()
    kw = dict(num_joints=K, depth_dim=D, height_dim=S, width_dim=S,
              image_size=32.0, bbox_3d_shape=(1300, 1300, 1300),
              K=torch.eye(3).expand(B, 3, 3), root_trans=torch.ones(B, 3))
    for use_kernel in (None, True, False):
        uvd, xyz = TI.heatmap_integral_pose(out, use_kernel=use_kernel, **kw)
        (uvd.sum() + xyz.sum()).backward()
    x = out.detach().reshape(B * K, D, S, S)
    _, e, stats = integral_cuda.soft_argmax_3d_fwd(x)
    integral_cuda.soft_argmax_3d_bwd(x, e, stats, torch.ones(B * K, 3))
    assert integral_cuda.soft_argmax_3d_fwd.launches == 0
    assert integral_cuda.soft_argmax_3d_bwd.launches == 0


def test_kernel_wrapper_rejects_devices_without_a_kernel():
    with pytest.raises(ValueError, match="no kernel"):
        integral_cuda.soft_argmax_3d_fwd(torch.empty(2, 4, 4, 4,
                                                     device="meta"))
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        integral_cuda.soft_argmax_3d_bwd(
            torch.empty(2, 4, 4, 4, **meta), torch.empty(2, 3, **meta),
            torch.empty(2, 2, **meta), torch.empty(2, 3, **meta))


# ---- the backward: closed form, autograd Function, JAX gradients ----

# f32 gradients, as tests/test_integral_pallas.py holds the Pallas backward
GRAD_ATOL = 1e-6
GRAD_SHAPES = [(1, 2, 4, 8, 8), (2, 2, 4, 4, 8), (2, 3, 5, 7, 9)]


def _jax_grads(logits, w, D, H, W):
    """jax.grad of sum(uvd * w) through the plain jnp soft-argmax and
    through the Pallas kernel (interpret mode on the CPU)."""
    import jax

    def loss(fn):
        return lambda l: jnp.sum(fn(l, D, H, W) * w)

    return [np.asarray(jax.grad(loss(fn))(jnp.asarray(logits)))
            for fn in (JI.soft_argmax_3d, soft_argmax_3d_pallas)]


@pytest.mark.parametrize("shape", GRAD_SHAPES)
def test_soft_argmax_backward_matches_jax_grad(shape, rng):
    B, K, D, H, W = shape
    logits = (rng.randn(B, K, D * H * W) * 3).astype(np.float32)
    w = rng.randn(B, K, 3).astype(np.float32)
    ref_plain, ref_pallas = _jax_grads(logits, w, D, H, W)
    x = _t(logits).reshape(B * K, D, H, W)
    g = _t(w).reshape(B * K, 3)
    _, e, stats = TI.soft_argmax_3d_fwd_plain(x)
    closed = TI.soft_argmax_3d_bwd_plain(x, e, stats, g).reshape(logits.shape)
    xf = x.clone().requires_grad_()
    (TI.SoftArgmax3d.apply(xf) * g).sum().backward()
    xa = x.clone().requires_grad_()
    (TI.soft_argmax_3d_fwd_plain(xa)[0] * g).sum().backward()
    for got in (closed, xf.grad.reshape(logits.shape),
                xa.grad.reshape(logits.shape)):
        np.testing.assert_allclose(got.numpy(), ref_pallas, atol=GRAD_ATOL)
        np.testing.assert_allclose(got.numpy(), ref_plain, atol=GRAD_ATOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_heatmap_integral_pose_gradient_matches_jax(use_pallas, rng):
    """The decode with fixroot: the masked root depth hands the backward a
    g with a zero, and uvd_to_xyz a dense one."""
    import jax
    B, K, D, S = 2, 7, 8, 16
    out = (rng.randn(B, K * D, S, S) * 2).astype(np.float32)
    Kmat = _K(rng, B)
    root = np.concatenate([np.zeros((B, 2)), rng.uniform(0.5, 2, (B, 1))],
                          -1).astype(np.float32)
    w_uvd = rng.randn(B, K, 3).astype(np.float32)
    w_xyz = rng.randn(B, K, 3).astype(np.float32)
    kw = dict(num_joints=K, depth_dim=D, height_dim=S, width_dim=S,
              image_size=64.0, bbox_3d_shape=(1300, 1300, 1300), rootid=3,
              fixroot=True)

    def jloss(o):
        uvd, xyz = JI.heatmap_integral_pose(
            o, K=jnp.asarray(Kmat), root_trans=jnp.asarray(root),
            use_pallas=use_pallas, **kw)
        return jnp.sum(uvd * w_uvd) + jnp.sum(xyz * w_xyz)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(out)))
    for use_kernel in (None, False):
        o = _t(out).requires_grad_()
        uvd, xyz = TI.heatmap_integral_pose(o, K=_t(Kmat), root_trans=_t(root),
                                            use_kernel=use_kernel, **kw)
        ((uvd * _t(w_uvd)).sum() + (xyz * _t(w_xyz)).sum()).backward()
        np.testing.assert_allclose(o.grad.numpy(), ref, atol=GRAD_ATOL)


def test_soft_argmax_stats_are_the_cells_max_and_sum(rng):
    x = (rng.randn(6, 3, 5, 7) * 4).astype(np.float32)
    x[1, 0, 0, :3] = -np.inf                       # -inf logits in a cell
    _, _, stats = TI.soft_argmax_3d_fwd_plain(_t(x))
    flat = x.reshape(6, -1).astype(np.float64)
    m = flat.max(-1)
    np.testing.assert_array_equal(stats[:, 0].numpy(), m.astype(np.float32))
    np.testing.assert_allclose(stats[:, 1].numpy(),
                               np.exp(flat - m[:, None]).sum(-1), rtol=1e-6)


def test_soft_argmax_backward_gives_zero_at_minus_inf(rng):
    x = _t(rng.randn(2, 4, 4, 4).astype(np.float32))
    x[0, 1, 2, :] = -np.inf
    uvd, e, stats = TI.soft_argmax_3d_fwd_plain(x)
    dx = TI.soft_argmax_3d_bwd_plain(x, e, stats, torch.ones(2, 3))
    assert torch.isfinite(uvd).all() and torch.isfinite(dx).all()
    assert float(dx[0, 1, 2].abs().max()) == 0.0


def test_bf16_backward_returns_bf16_of_the_f32_gradient(rng):
    """Under autocast the head emits bf16 logits: the Function saves them
    and hands back a bf16 gradient, the f32 closed form rounded once."""
    x = torch.from_numpy(rng.randn(6, 4, 8, 8).astype(np.float32)
                         ).to(torch.bfloat16)
    g = _t(rng.randn(6, 3).astype(np.float32))
    xb = x.clone().requires_grad_()
    (TI.SoftArgmax3d.apply(xb) * g).sum().backward()
    assert xb.grad.dtype == torch.bfloat16
    _, e, stats = TI.soft_argmax_3d_fwd_plain(x.float())
    ref = TI.soft_argmax_3d_bwd_plain(x.float(), e, stats, g)
    torch.testing.assert_close(xb.grad, ref.to(torch.bfloat16), rtol=0,
                               atol=0)


# ---- the split forward: its plan, and a plain mirror of its merge ----

@pytest.mark.parametrize("rows", [1, 7, 35, 33 * 65, 64 * 64])
def test_split_plan_covers_every_row_once(rows):
    """For 1 to 1024 cells, the splits of a cell's rows are contiguous,
    none is empty, each row falls in exactly one, and the grid reaches
    BLOCKS_PER_SM blocks an SM where the rows allow it."""
    sm = 132
    for bk in range(1, 1025):
        splits, per = integral_cuda.plan_splits(bk, rows, sm)
        assert 1 <= splits <= rows
        assert (splits - 1) * per < rows <= splits * per
        starts = np.arange(splits) * per
        counts = np.zeros(rows, np.int64)
        for a, b in zip(starts, np.minimum(starts + per, rows)):
            counts[a:b] += 1
        assert (counts == 1).all()
        assert bk * splits >= min(integral_cuda.BLOCKS_PER_SM * sm,
                                  bk * rows)


def test_vector_loads_need_alignment_and_whole_vectors():
    assert integral_cuda.vector_loads(256, 64, 2)
    assert integral_cuda.vector_loads(256, 64, 4)
    assert not integral_cuda.vector_loads(258, 64, 2)   # one bf16 past 16 B
    assert not integral_cuda.vector_loads(260, 64, 4)
    assert not integral_cuda.vector_loads(256, 31, 2)   # odd W
    assert not integral_cuda.vector_loads(256, 12, 2)   # 24-byte rows
    assert integral_cuda.vector_loads(256, 12, 4)       # 48-byte rows


_F32_EMPTY = float(np.finfo(np.float32).min)   # the kernel's empty max


def _split_forward(x: torch.Tensor, splits: int):
    """Plain mirror of the CUDA split forward in float32: each split of a
    cell's D*H rows folds its logits into (m, s, s_w, s_h, s_d), with
    -FLT_MAX as the empty max, then the splits merge by rescaling with
    exp(m_i - m). Returns (uvd, E, stats) as the wrapper does."""
    BK, D, H, W = x.shape
    rows = D * H
    per = -(-rows // splits)
    flat = x.float().reshape(BK, rows, W)
    r = torch.arange(rows)
    idx_w = torch.arange(W, dtype=torch.float32)
    idx_h, idx_d = (r % H).float(), (r // H).float()
    parts = []
    for a in range(0, rows, per):
        seg = flat[:, a:a + per]
        m = seg.amax(dim=(1, 2)).clamp(min=_F32_EMPTY)
        e = torch.exp(seg - m[:, None, None])
        row_s = e.sum(2)
        parts.append(torch.stack([m, row_s.sum(1), (e * idx_w).sum((1, 2)),
                                  (row_s * idx_h[a:a + per]).sum(1),
                                  (row_s * idx_d[a:a + per]).sum(1)], -1))
    p = torch.stack(parts, 1)                 # (BK, splits, 5)
    m = p[..., 0].amax(1)
    c = torch.exp(p[..., 0] - m[:, None])
    s, sw, sh, sd = ((p[..., k] * c).sum(1) for k in range(1, 5))
    ex = torch.stack([sw / s, sh / s, sd / s], -1)
    uvd = ex / torch.tensor([W, H, D], dtype=torch.float32) - 0.5
    return uvd, ex, torch.stack([m, s], -1)


SPLIT_ATOL = 1e-6


@pytest.mark.parametrize("kind", ["plain", "minus_inf_split", "max_in_last"])
@pytest.mark.parametrize("splits", [1, 2, 3, 7, "rows"])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7, 9), (1, 2, 4, 6, 8)])
def test_split_mirror_matches_pallas_and_plain(shape, splits, kind, rng):
    """D != H != W. minus_inf_split: the first split's logits are all -inf
    (it must merge as a no-op; with one split, the first half of the
    rows); max_in_last: the cell's max lies in its last split."""
    B, K, D, H, W = shape
    rows = D * H
    n = rows if splits == "rows" else splits
    per = -(-rows // n)
    logits = (rng.randn(B, K, D, H, W) * 3).astype(np.float32)
    if kind == "minus_inf_split":
        logits.reshape(B * K, rows, W)[0, :min(per, rows // 2)] = -np.inf
    elif kind == "max_in_last":
        logits.reshape(B * K, rows, W)[:, -1, -1] = 20.0
    x = _t(logits).reshape(B * K, D, H, W)
    uvd, ex, stats = _split_forward(x, n)
    pallas = np.asarray(soft_argmax_3d_pallas(
        jnp.asarray(logits.reshape(B, K, -1)), D, H, W)).reshape(B * K, 3)
    uvd_p, ex_p, stats_p = TI.soft_argmax_3d_fwd_plain(x)
    np.testing.assert_allclose(uvd.numpy(), pallas, atol=SPLIT_ATOL)
    np.testing.assert_allclose(uvd.numpy(), uvd_p.numpy(), atol=SPLIT_ATOL)
    np.testing.assert_allclose(ex.numpy(), ex_p.numpy(),
                               atol=SPLIT_ATOL * max(D, H, W))
    np.testing.assert_array_equal(stats[:, 0].numpy(), stats_p[:, 0].numpy())
    np.testing.assert_allclose(stats[:, 1].numpy(), stats_p[:, 1].numpy(),
                               rtol=1e-6)


def test_split_mirror_at_the_planned_splits(rng):
    """The mirror at the split counts `plan_splits` picks for small and
    large cell counts agrees with the plain version."""
    D, H, W = 4, 6, 8
    for bk in (1, 7, 64):
        splits, _ = integral_cuda.plan_splits(bk, D * H, 132)
        x = _t((rng.randn(bk, D, H, W) * 3).astype(np.float32))
        uvd, _, _ = _split_forward(x, splits)
        np.testing.assert_allclose(uvd.numpy(),
                                   TI.soft_argmax_3d_fwd_plain(x)[0].numpy(),
                                   atol=SPLIT_ATOL)


def test_timing_ring_exceeds_l2_and_slices_in_order():
    """The device timing ring: more than twice the L2 cache in all, cut
    from one tensor (or a tuple of tensors) in the order it was written."""
    from horopose_tpu_torch.tools.timing import (RING_BYTES, ring_size,
                                                 ring_slices)
    for nbytes in (7560, 3_670_016, 33_554_432, 234_881_024):
        n = ring_size(nbytes)
        assert n >= 2 and n * nbytes > RING_BYTES
    big = torch.arange(12).reshape(6, 2)
    parts = ring_slices(big, 3)
    assert [p.tolist() for p in parts] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]],
                                           [[8, 9], [10, 11]]]
    pairs = ring_slices((big, big[:, 0]), 2)
    assert len(pairs) == 2 and torch.equal(pairs[1][1], torch.tensor([6, 8,
                                                                      10]))


# ---- the backward's walk: a plain mirror of the kernel's arithmetic ----

_THREADS, _UNROLL = 256, 8        # csrc/soft_argmax.cu: kThreads, kBwdUnroll


def _kernel_walk(D, H, W, N, splits, per):
    """The vectors one cell's blocks visit, as the backward kernel walks
    them: split (blockIdx.y) takes rows [split * per, ...), tpr threads a
    row, each thread its columns tx, tx + tpr, ... and rows row0 + ty,
    + rpp, ..., kUnroll rows at a time, (d, h) advanced by a constant step.
    Yields (row, d, h, first column) per vector."""
    vpr = W // N
    tpr = 1
    while tpr < vpr and tpr < _THREADS:
        tpr <<= 1
    rpp = _THREADS // tpr
    dd, dh = divmod(rpp, H)
    for split in range(splits):
        row0, row1 = split * per, min((split + 1) * per, D * H)
        for tid in range(_THREADS):
            tx, ty = tid % tpr, tid // tpr
            for c in range(tx, vpr, tpr):
                r = row0 + ty
                d, h = divmod(r, H)
                while r < row1:
                    for k in range(_UNROLL):
                        if r + k * rpp < row1:
                            yield r + k * rpp, d, h, c * N
                        h, d = h + dh, d + dd
                        if h >= H:
                            h, d = h - H, d + 1
                    r += _UNROLL * rpp


def _vector_backward(x, ex, stats, g, splits=None, vec=True):
    """Plain mirror of the backward kernel in float32: the vectors of
    `_kernel_walk` (16-byte vectors when `vector_loads` allows them and
    `vec`, else the scalar path's one logit a vector), each with its
    column terms g_w/W (w - E_w) and its row's hoisted term g_h/H (h -
    E_h) + g_d/D (d - E_d), dx = exp(x - m) * (1/s) * (column + row term),
    rounded once to x's dtype. Also checks that every logit is written
    once, at the (d, h) its row stands for."""
    BK, D, H, W = x.shape
    rows = D * H
    if splits is None:
        splits, per = integral_cuda.plan_splits(BK, rows, 132)
    else:
        per = -(-rows // splits)
        splits = -(-rows // per)
    N = (16 // x.element_size()
         if vec and integral_cuda.vector_loads(0, W, x.element_size()) else 1)
    xf = x.float()
    m, inv_s = stats[:, 0], 1.0 / stats[:, 1]
    g_w, g_h, g_d = g[:, 0] / W, g[:, 1] / H, g[:, 2] / D
    tw = g_w[:, None] * (torch.arange(W, dtype=torch.float32)[None]
                         - ex[:, 0, None])
    dx = torch.full((BK, D, H, W), float("nan"))
    seen = np.zeros((D, H, W), np.int64)
    for r, d, h, w0 in _kernel_walk(D, H, W, N, splits, per):
        assert (d, h) == divmod(r, H)
        seen[d, h, w0:w0 + N] += 1
        tr = g_h * (h - ex[:, 1]) + g_d * (d - ex[:, 2])
        p = torch.exp(xf[:, d, h, w0:w0 + N] - m[:, None]) * inv_s[:, None]
        dx[:, d, h, w0:w0 + N] = p * (tw[:, w0:w0 + N] + tr[:, None])
    assert (seen == 1).all()
    return dx.to(x.dtype)


# D != H != W; W = 9 takes the scalar path in both dtypes, W = 8 and 16
# whole 16-byte vectors (2 or 1 a row in float32, 1 in bf16)
WALK_SHAPES = [(2, 3, 5, 7, 9), (1, 2, 4, 6, 8), (2, 2, 3, 5, 16)]


def _walk_inputs(shape, dtype, rng):
    """Logits 3 * N(0, 1) in `dtype` with a row of -inf in the first cell,
    g ~ N(0, 1), and the plain forward's E and (m, s)."""
    B, K, D, H, W = shape
    logits = (rng.randn(B * K, D, H, W) * 3).astype(np.float32)
    logits[0, 1, 0] = -np.inf
    x = _t(logits).to(dtype)
    g = _t(rng.randn(B * K, 3).astype(np.float32))
    _, e, stats = TI.soft_argmax_3d_fwd_plain(x)
    return x, g, e, stats


@pytest.mark.parametrize("splits", [1, 3, "rows", None])
@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_vector_backward_mirror_matches_pallas_grad_and_plain(shape, splits,
                                                              rng):
    """float32 logits: the mirror against jax.grad through the Pallas
    kernel (interpret mode) and the plain jnp soft-argmax at GRAD_ATOL,
    and against `soft_argmax_3d_bwd_plain` (the same operations in another
    order: a few float32 roundings of terms up to ~1, so within 1e-6),
    with the scalar path forced too. splits None takes `plan_splits`'s."""
    B, K, D, H, W = shape
    x, g, e, stats = _walk_inputs(shape, torch.float32, rng)
    n = D * H if splits == "rows" else splits
    ref_plain, ref_pallas = _jax_grads(x.numpy().reshape(B, K, -1),
                                       g.numpy().reshape(B, K, 3), D, H, W)
    plain = TI.soft_argmax_3d_bwd_plain(x, e, stats, g)
    assert float(plain[0, 1, 0].abs().max()) == 0.0
    for vec in (True, False):
        dx = _vector_backward(x, e, stats, g, n, vec)
        assert float(dx[0, 1, 0].abs().max()) == 0.0    # exactly, at -inf
        got = dx.numpy().reshape(B, K, -1)
        np.testing.assert_allclose(got, ref_pallas, atol=GRAD_ATOL)
        np.testing.assert_allclose(got, ref_plain, atol=GRAD_ATOL)
        np.testing.assert_allclose(dx.numpy(), plain.numpy(), atol=GRAD_ATOL)


@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_vector_backward_mirror_in_bf16_passes_the_card_check(shape, rng):
    """bf16 logits: the mirror's bf16 dx against the plain version's under
    the card's own check (`chip_smoke.compare_dx`: DX_TERMS_RTOL of the
    terms plus one bf16 ulp of the entry, exactly 0 at -inf), and its
    float32 arithmetic on the same bf16 values against jax.grad through
    the Pallas kernel at GRAD_ATOL."""
    import chip_smoke
    B, K, D, H, W = shape
    x, g, e, stats = _walk_inputs(shape, torch.bfloat16, rng)
    dx = _vector_backward(x, e, stats, g)
    assert dx.dtype == torch.bfloat16
    plain = TI.soft_argmax_3d_bwd_plain(x, e, stats, g)
    chip_smoke.compare_dx(x, e, stats, g, dx, plain, f"mirror {shape}")
    _, ref_pallas = _jax_grads(x.float().numpy().reshape(B, K, -1),
                               g.numpy().reshape(B, K, 3), D, H, W)
    dx32 = _vector_backward(x.float(), e, stats, g)
    np.testing.assert_allclose(dx32.numpy().reshape(B, K, -1), ref_pallas,
                               atol=GRAD_ATOL)


def test_card_check_of_dx_fails_a_wrong_index_walk(rng):
    """compare_dx catches a walk that is one row off in h, or one that
    takes g_h for g_d and g_d for g_h, at the mirror's own inputs."""
    import chip_smoke
    x, g, e, stats = _walk_inputs((2, 3, 5, 7, 9), torch.float32, rng)
    dx = _vector_backward(x, e, stats, g)
    chip_smoke.compare_dx(x, e, stats, g, dx, dx, "same")
    wrong_h = torch.cat([dx[:, :, 1:], dx[:, :, :1]], 2)
    swapped = _vector_backward(x, e, stats, g[:, [0, 2, 1]])
    for name, bad in (("h off by one", wrong_h),
                      ("g_h and g_d swapped", swapped)):
        with pytest.raises(AssertionError):
            chip_smoke.compare_dx(x, e, stats, g, bad, dx, name)
