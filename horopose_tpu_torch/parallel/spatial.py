"""Row-sharded execution of the serving forward: an image's rows split over
the devices of a mesh's `spatial` axis.

The JAX package gets this from XLA's SPMD partitioner: it shards the H of
the image batch (`horopose_tpu/parallel/mesh.py::image_sharding`) and XLA
splits every conv and inserts the halo exchanges. PyTorch has no such
partitioner, so the port writes it out once, for the ops a FullNet's eval
forward reaches.

A `RowSharded` value is an NCHW tensor held as row shards: for each device
of the group, a local (N, C, h_i, W) tensor holding the global rows
[r0_i, r1_i). Every op's output is laid out by `mesh.split_rows`: as even
as possible, the larger shards first; a shard may own zero rows (a 1-row
map over 8 devices). The model code stays the only definition of each
backbone: a `RowSharded` carries a `__torch_function__`, so
`model(x_sharded, ...)` runs the model's own forward and each functional
call on a sharded value dispatches to this module's rule for it. That
keeps every variant and option of the models without a second copy of
their forwards; a walker over the module tree would have to restate each
forward's wiring (residuals, HRNet's fuse sums, the heads' pooling).

The rules:

| Op | Rule |
|---|---|
| conv2d (any kernel, stride, padding, dilation, groups) | each output shard's rows [o0, o1) read the input rows [o0 s - p, (o1 - 1) s - p + d (k - 1) + 1) from whichever shards hold them, zero rows past the global edges; W padded as before |
| max_pool2d | the same window, -inf past the edges |
| conv_transpose2d | the input rows that reach [o0, o1) by the transposed arithmetic (one row a side for k4 s2 p1) |
| interpolate (nearest, integer scale) | output row r reads input row r // f |
| batch_norm (eval), relu, leaky_relu | local |
| `a + b` | local once both share a row layout; `b` is resharded to `a`'s otherwise |
| `.mean(dim=(2, 3))` | per-shard float32 sums, added on the group's first device, divided by the global H W, in the shards' dtype |
| `.reshape` keeping the rows (the heads' (B, K*D, H, W) -> (B*K, D, H, W)), `.contiguous()`, `.is_contiguous()` (in any memory format) | per shard |
| `ops/integral.py::heatmap_integral_joint` (reg_joint_map's 1-D soft-argmax, whose flatten mixes the rows) | the (B, dof, h, w) joint maps gathered whole onto the group's first device (`RowSharded.gathered`; 256 channels at 8x8 at full width), then the plain function |
| the soft-argmax operator `horopose::soft_argmax_3d_fwd` | each shard's partial tuples (`ops/integral_cuda.py::soft_argmax_3d_partials`, its global row offset in the h index), copied to the group's first device and merged with the global H (`soft_argmax_3d_merge`); the heatmap never moves |

After pooling, the features are plain tensors on the group's first device,
where the heads run.

What the path refuses, each with a `NotImplementedError` or `ValueError`
naming it: any other op on a sharded value (nothing else is
gathered); a BatchNorm in training mode (serving and evaluation only); a
tensor that requires grad while grad is enabled.

Weights: each shard's op uses the copy of the module's parameters on the
shard's device, from `parallel/mesh.py::Replicas`, one copy of the model
per distinct device
(a device that repeats holds one). Every halo row and every copy goes
through `Tensor.to(device)`, also where the device is the same, so the
code that runs on one device repeated is the code a machine with several
cards runs.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.nn.modules.utils import _pair

# ops.integral registers the soft-argmax operator that _RULES names
from horopose_tpu_torch.ops import integral, integral_cuda  # noqa: F401
from horopose_tpu_torch.parallel.mesh import Replicas, split_rows


def _name(func) -> str:
    return getattr(func, "__qualname__", None) or getattr(
        func, "__name__", None) or str(func)


def _check_no_grad(args, kwargs) -> None:
    if not torch.is_grad_enabled():
        return
    for a in list(args) + list(kwargs.values()):
        ts = a.shards if isinstance(a, RowSharded) else [a]
        if any(isinstance(t, torch.Tensor) and t.requires_grad for t in ts):
            raise ValueError("row-sharded execution is for serving and "
                             "evaluation: a tensor requires grad; run under "
                             "torch.no_grad() or torch.inference_mode()")


class RowSharded:
    """An (N, C, H, W) value held as row shards on the devices of a
    `spatial` group (module docstring). `shards[i]` is a local
    (N, C, r1 - r0, W) tensor holding the global rows `rows[i] = (r0,
    r1)`, consecutive from 0 to H; `replicas` gives each shard's op the
    weights on its device."""

    __slots__ = ("shards", "rows", "replicas")

    def __init__(self, shards: Sequence[torch.Tensor], replicas: Replicas):
        shards = list(shards)
        n, c, _, w = shards[0].shape
        rows, start = [], 0
        for s in shards:
            if s.dim() != 4 or (s.shape[0], s.shape[1], s.shape[3]) != \
                    (n, c, w):
                raise ValueError(f"row shards of one (N, C, H, W) value, got "
                                 f"{[tuple(t.shape) for t in shards]}")
            rows.append((start, start + s.shape[2]))
            start += s.shape[2]
        if any(s.requires_grad for s in shards):
            raise ValueError("row-sharded execution is for serving and "
                             "evaluation: a shard requires grad")
        self.shards = shards
        self.rows = rows
        self.replicas = replicas

    @property
    def devices(self) -> List[torch.device]:
        return [s.device for s in self.shards]

    @property
    def shape(self) -> torch.Size:
        n, c, _, w = self.shards[0].shape
        return torch.Size((n, c, self.rows[-1][1], w))

    @property
    def device(self) -> torch.device:
        """The group's first device, where pooled features and the heads
        go (and the device type that autocast reads)."""
        return self.shards[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def dim(self) -> int:
        return 4

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rule = _RULES.get(func)
        if rule is None:
            raise NotImplementedError(
                f"row-sharded execution has no rule for {_name(func)}; its "
                "ops are conv2d, conv_transpose2d, max_pool2d, nearest "
                "interpolate, eval batch_norm, relu, leaky_relu, add, "
                "mean over (H, W), reshape and the soft-argmax")
        _check_no_grad(args, kwargs)
        return rule(*args, **kwargs)

    def __getattr__(self, name):
        if name.startswith("__"):   # protocols probe with getattr
            raise AttributeError(name)
        raise NotImplementedError(f"row-sharded execution has no rule for "
                                  f"Tensor.{name}")

    def __add__(self, other):
        if not isinstance(other, RowSharded) or other.shape != self.shape:
            raise NotImplementedError(
                "row-sharded execution adds two row-sharded values of one "
                f"shape, got {self.shape} + {getattr(other, 'shape', other)}")
        if other.rows != self.rows:
            other = RowSharded([_rows_on(other, r0, r1, d)
                                for (r0, r1), d in zip(self.rows,
                                                       self.devices)],
                               self.replicas)
        return RowSharded([a + b for a, b in zip(self.shards, other.shards)],
                          self.replicas)

    def mean(self, dim=None, keepdim: bool = False, *, dtype=None):
        """The mean over (H, W): float32 sums a shard, added on the first
        device, over the global H * W, in the shards' dtype."""
        dims = (dim,) if isinstance(dim, int) else tuple(dim or ())
        if sorted(int(d) % 4 for d in dims) != [2, 3] or keepdim or \
                dtype is not None:
            raise NotImplementedError(
                f"row-sharded execution takes the mean over dim=(2, 3), not "
                f"dim={dim}, keepdim={keepdim}, dtype={dtype}")
        total = None
        for s in self.shards:
            part = s.float().sum(dim=(2, 3)).to(self.device)
            total = part if total is None else total + part
        _, _, h, w = self.shape
        return (total / float(h * w)).to(self.dtype)

    def reshape(self, *shape):
        """A reshape that keeps the rows: (N, C, H, W) -> (N', C', H, W)
        with N' C' = N C."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        n, c, h, w = self.shape
        if len(shape) != 4 or tuple(shape[2:]) != (h, w) or \
                shape[0] * shape[1] != n * c:
            raise NotImplementedError(
                f"row-sharded execution reshapes {tuple(self.shape)} only to "
                f"another (N, C) over the same rows, not to {tuple(shape)}")
        return RowSharded([s.reshape(shape[0], shape[1], s.shape[2], w)
                           for s in self.shards], self.replicas)

    def is_contiguous(self, memory_format=torch.contiguous_format) -> bool:
        return all(s.is_contiguous(memory_format=memory_format)
                   for s in self.shards)

    def contiguous(self, memory_format=torch.contiguous_format):
        return RowSharded([s.contiguous(memory_format=memory_format)
                           for s in self.shards], self.replicas)

    def gathered(self) -> torch.Tensor:
        """The whole value as one tensor on the group's first device."""
        return _rows_on(self, 0, self.shape[2], self.device)


def _rows_on(x: RowSharded, lo: int, hi: int, device: torch.device,
             fill: float = 0.0) -> torch.Tensor:
    """The global rows [lo, hi) of `x` as one tensor on `device`, copied
    from whichever shards hold them; rows outside [0, H) are `fill`."""
    n, c, h, w = x.shape
    if hi <= lo:
        return x.shards[0].new_empty((n, c, 0, w), device=device)
    parts = []
    top = min(hi, 0) - lo
    if top > 0:
        parts.append(torch.full((n, c, top, w), fill, dtype=x.dtype,
                                device=device))
    for s, (r0, r1) in zip(x.shards, x.rows):
        a, b = max(lo, r0), min(hi, r1)
        if a < b:
            parts.append(s[:, :, a - r0:b - r0].to(device))
    bottom = hi - max(lo, h)
    if bottom > 0:
        parts.append(torch.full((n, c, bottom, w), fill, dtype=x.dtype,
                                device=device))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)


def _assemble(outs: List[Optional[torch.Tensor]], devices, replicas
              ) -> RowSharded:
    """Shards from per-shard results, None where a shard owns no rows
    (made empty, in the dtype and widths of a computed one)."""
    like = next(y for y in outs if y is not None)
    n, c, _, w = like.shape
    return RowSharded([like.new_empty((n, c, 0, w), device=d) if y is None
                       else y for y, d in zip(outs, devices)], replicas)


def _windowed(x: RowSharded, out_h: int,
              window: Callable[[int, int], Tuple[int, int, int]],
              op: Callable[[torch.Tensor, torch.device], torch.Tensor],
              fill: float = 0.0) -> RowSharded:
    """An op whose output rows read a window of input rows: output shard i
    takes the rows [o0, o1) of `split_rows(out_h, n)`; `window(o0, o1)`
    gives (lo, hi, skip): `op` runs on the input rows [lo, hi) on the
    shard's device, and its rows [skip, skip + o1 - o0) are the shard."""
    outs = []
    for (o0, o1), d in zip(split_rows(out_h, len(x.shards)), x.devices):
        if o1 == o0:
            outs.append(None)
            continue
        lo, hi, skip = window(o0, o1)
        y = op(_rows_on(x, lo, hi, d, fill), d)
        if skip or y.shape[2] != o1 - o0:
            y = y[:, :, skip:skip + o1 - o0]
        outs.append(y)
    return _assemble(outs, x.devices, x.replicas)


def _local(x: RowSharded, op: Callable[[torch.Tensor, torch.device],
                                       torch.Tensor]) -> RowSharded:
    """An op that maps each row to itself, on each shard that has rows."""
    return _assemble([op(s, d) if s.shape[2] else None
                      for s, d in zip(x.shards, x.devices)],
                     x.devices, x.replicas)


def _pads(padding) -> Tuple[int, int]:
    if isinstance(padding, str):
        raise NotImplementedError(f"row-sharded execution takes numeric "
                                  f"padding, not {padding!r}")
    return _pair(padding)


def _conv2d(input, weight, bias=None, stride=1, padding=0, dilation=1,
            groups=1):
    (s, sw), (p, pw), (d, dw) = _pair(stride), _pads(padding), \
        _pair(dilation)
    span = d * (weight.shape[2] - 1) + 1
    out_h = (input.shape[2] + 2 * p - span) // s + 1
    R = input.replicas.tensor
    return _windowed(
        input, out_h,
        lambda o0, o1: (o0 * s - p, (o1 - 1) * s - p + span, 0),
        lambda t, dev: F.conv2d(t, R(weight, dev), R(bias, dev), (s, sw),
                                (0, pw), (d, dw), groups))


def _max_pool2d(input, kernel_size, stride=None, padding=0, dilation=1,
                ceil_mode=False, return_indices=False):
    if ceil_mode or return_indices:
        raise NotImplementedError("row-sharded max_pool2d: no ceil_mode or "
                                  "return_indices")
    (k, kw), (p, pw), (d, dw) = _pair(kernel_size), _pads(padding), \
        _pair(dilation)
    s, sw = _pair(stride if stride not in (None, []) else kernel_size)
    span = d * (k - 1) + 1
    out_h = (input.shape[2] + 2 * p - span) // s + 1
    return _windowed(
        input, out_h,
        lambda o0, o1: (o0 * s - p, (o1 - 1) * s - p + span, 0),
        lambda t, dev: F.max_pool2d(t, (k, kw), (s, sw), (0, pw), (d, dw)),
        fill=float("-inf"))


def _conv_transpose2d(input, weight, bias=None, stride=1, padding=0,
                      output_padding=0, groups=1, dilation=1):
    (s, sw), (p, pw), (d, dw) = _pair(stride), _pads(padding), \
        _pair(dilation)
    op_h, op_w = _pair(output_padding)
    span = d * (weight.shape[2] - 1) + 1
    if op_h or span < s:
        raise NotImplementedError(
            "row-sharded conv_transpose2d: no output_padding along H, and a "
            "kernel that covers its stride")
    out_h = (input.shape[2] - 1) * s - 2 * p + span
    R = input.replicas.tensor

    def window(o0, o1):
        # input row i reaches output rows i s - p .. i s - p + span - 1
        lo = -((span - 1 - o0 - p) // s)          # ceil((o0 + p - span + 1) / s)
        hi = (o1 - 1 + p) // s + 1
        return lo, hi, o0 - (lo * s - p)

    return _windowed(
        input, out_h, window,
        lambda t, dev: F.conv_transpose2d(t, R(weight, dev), R(bias, dev),
                                          (s, sw), (0, pw), (0, op_w),
                                          groups, (d, dw)))


def _interpolate(input, size=None, scale_factor=None, mode="nearest",
                 align_corners=None, recompute_scale_factor=None,
                 antialias=False):
    factors = _pair(scale_factor) if scale_factor is not None else None
    if mode != "nearest" or size is not None or factors is None or \
            any(float(f) != int(f) or f < 1 for f in factors) or antialias:
        raise NotImplementedError(
            f"row-sharded interpolate: nearest with whole scale factors, not "
            f"mode={mode!r} size={size} scale_factor={scale_factor}")
    fh, fw = (int(f) for f in factors)
    return _windowed(
        input, input.shape[2] * fh,
        lambda o0, o1: (o0 // fh, (o1 - 1) // fh + 1, o0 - (o0 // fh) * fh),
        lambda t, dev: F.interpolate(t, scale_factor=(fh, fw),
                                     mode="nearest"))


def _batch_norm(input, running_mean, running_var, weight=None, bias=None,
                training=False, momentum=0.1, eps=1e-5):
    if training:
        raise ValueError("row-sharded execution is for serving and "
                         "evaluation: a BatchNorm is in training mode "
                         "(model.eval() first)")
    R = input.replicas.tensor
    return _local(input, lambda t, dev: F.batch_norm(
        t, R(running_mean, dev), R(running_var, dev), R(weight, dev),
        R(bias, dev), False, momentum, eps))


def _relu(input, inplace=False):
    return _local(input, lambda t, dev: F.relu(t, inplace=inplace))


def _leaky_relu(input, negative_slope=0.01, inplace=False):
    return _local(input, lambda t, dev: F.leaky_relu(t, negative_slope,
                                                     inplace=inplace))


def _soft_argmax(x: RowSharded):
    """(uvd, E, stats) of the (BK, D, H, W) logits, on the group's first
    device (see `ops/integral.py::soft_argmax_3d_op`)."""
    _, d, h, w = x.shape
    partials = torch.cat([
        integral_cuda.soft_argmax_3d_partials(s.contiguous(), r0)
        .to(x.device) for s, (r0, _) in zip(x.shards, x.rows)], dim=1)
    return integral_cuda.soft_argmax_3d_merge(partials, d, h, w)


# the functional calls a row-sharded value dispatches (module docstring);
# its methods (add, mean, reshape, contiguous) are RowSharded's own
_RULES: Dict[Callable, Callable] = {
    F.conv2d: _conv2d,
    F.conv_transpose2d: _conv_transpose2d,
    F.max_pool2d: _max_pool2d,
    F.interpolate: _interpolate,
    F.batch_norm: _batch_norm,
    F.relu: _relu,
    F.leaky_relu: _leaky_relu,
    torch.ops.horopose.soft_argmax_3d_fwd.default: _soft_argmax,
}

