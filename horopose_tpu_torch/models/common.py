"""Shared model utilities: the JAX package's weight initialisation,
training with BatchNorm frozen, BatchNorm synchronised over the ranks of a
data-parallel run, and per-unit recomputation (`cfg.remat`).

`init_like_flax_` draws a fresh model's weights as flax's defaults draw
the JAX models': every conv, transposed conv and linear weight from a
truncated normal of variance 1/fan_in (flax's `lecun_normal`, fan_in the
input channels times the kernel area), every bias 0; BatchNorm scale 1,
shift 0, torch's own defaults. FullNet and the DepthNet then give their
heads the JAX models' own initialisers. torch's defaults (kaiming uniform
with a = sqrt(5) and uniform biases) draw a third of that variance and
non-zero biases.

Port of `horopose_tpu/models/common.py`. `train_with_frozen_batchnorm`
is the counterpart of `frozen_batchnorm`: the sim2real stage trains with
every BatchNorm normalising by its running statistics, which it never
updates, while dropout stays live and BatchNorm's scale and bias still
train (the reference sets m.eval() on each BN module after model.train()).
The JAX package bakes that in at trace time; here it is the modules'
modes.

`SyncBatchNorm` is what the JAX `BatchNorm` computes on a global batch
that spans processes: train-mode statistics over every rank's rows, the
variance as E[x²] − E[x]² (flax's fast variance) in float32, and the
running variance with the Bessel factor of the global count (JAX
:91-100). Each rank's sums go through one all-reduce whose backward
all-reduces the incoming gradient, so autograd gives every rank its part
of the global batch's gradient. `convert_sync_batchnorm` swaps it in for a
model's BatchNorm modules; the trainers do that only at world size > 1,
so the single-card path keeps cuDNN's BatchNorm.

`remat_call` runs a backbone unit's forward under
`torch.utils.checkpoint` (non-reentrant): the backward recomputes the
unit's activations instead of keeping them, the counterpart of the JAX
package's `nn.remat`, which trades forward work for the activation memory
that caps the training batch. flax returns the BatchNorm statistics rather
than mutating them, so its recompute leaves them alone; here the
recompute runs each train-mode BatchNorm of the unit on copies of its
running statistics and counter, which are dropped, so they are updated
once a step. A SyncBatchNorm's recompute repeats its all-reduce, which
every rank does, since every rank recomputes the same units.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from horopose_tpu_torch.parallel.multihost import all_sum, process_count

# the scale of a standard normal truncated to [-2, 2]: flax divides by it
# so that the truncated draws keep the asked-for variance
_TRUNC_STD = 0.87962566103423978


def _truncated_normal(n: int, device) -> torch.Tensor:
    """n draws of a standard normal truncated to +-2, by redrawing the
    draws outside (about 5%) until none is."""
    x = torch.randn(n, device=device)
    redraw = torch.nonzero(x.abs() > 2.0).view(-1)
    while redraw.numel():
        new = torch.randn(redraw.numel(), device=device)
        inside = new.abs() <= 2.0
        x[redraw[inside]] = new[inside]
        redraw = redraw[~inside]
    return x


def init_like_flax_(model: nn.Module) -> nn.Module:
    """Every Conv2d / ConvTranspose2d / Linear of a fresh `model` re-drawn
    as flax's defaults draw them (module docstring), from torch's global
    generator; its BatchNorms keep torch's scale 1 and shift 0, which are
    flax's too. One draw serves every layer: a few tensor operations a
    layer, each of which costs milliseconds on a busy host. Returns
    `model`."""
    layers = [m for m in model.modules()
              if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))]
    if not layers:
        return model
    draws = _truncated_normal(sum(m.weight.numel() for m in layers),
                              layers[0].weight.device)
    start = 0
    with torch.no_grad():
        for m in layers:
            w = m.weight
            # flax's kernels are (..., in, out): fan_in = in x kernel area
            in_ch = w.shape[0] if isinstance(m, nn.ConvTranspose2d) \
                else w.shape[1]
            fan_in = in_ch * (w[0, 0].numel() if w.dim() > 2 else 1)
            torch.mul(draws[start:start + w.numel()].view_as(w),
                      (1.0 / fan_in) ** 0.5 / _TRUNC_STD, out=w)
            start += w.numel()
            if m.bias is not None:
                m.bias.zero_()
    return model


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d, every backbone's (`resnet.batch_norm`), with the
    port's one choice of layout by platform: a channels_last train-mode
    batch on the CPU is normalised in NCHW between two copies. ATen's CPU
    kernel sums a channels_last batch's statistics in float32, where its
    NCHW kernel sums in float64: about ten times the rounding of the
    normalised output at a 4 x 64 x 32 x 32 batch, which a step amplifies
    past the CPU tests' bounds. cuDNN on the card, every eval-mode call and
    an NCHW input (the DepthNet's) take the input as it is."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and x.device.type == "cpu") or \
                x.is_contiguous():
            return super().forward(x)
        return super().forward(x.contiguous()).contiguous(
            memory_format=torch.channels_last)


def train_with_frozen_batchnorm(model: nn.Module) -> nn.Module:
    """`model` in train mode (dropout on) with every BatchNorm module in
    eval mode; returns it."""
    model.train()
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.eval()
    return model


class _AllReduceSum(torch.autograd.Function):
    """Σ over the ranks. Its backward sums the incoming gradient over the
    ranks too: each rank's sum feeds every rank's loss."""

    @staticmethod
    def forward(ctx, x):
        return all_sum(x)

    @staticmethod
    def backward(ctx, grad):
        return all_sum(grad.contiguous())


class SyncBatchNorm(nn.modules.batchnorm._BatchNorm):
    """BatchNorm over the global batch of a process group (any input of
    shape (N, C, ...)); eval mode is nn.BatchNorm's. The state dict's keys
    are nn.BatchNorm's."""

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"expected (N, C, ...) input, got {x.dim()}-D")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        xf = x.float()
        stats = torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                           xf.new_full((1,), float(x.numel() // c))])
        if process_count() > 1:
            stats = _AllReduceSum.apply(stats)
        count = stats[2 * c]
        mean = stats[:c] / count
        var = torch.clamp(stats[c:2 * c] / count - mean * mean, min=0.0)
        shape = (1, c) + (1,) * (x.dim() - 2)
        y = (xf - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
        if self.affine:
            y = y * self.weight.view(shape) + self.bias.view(shape)
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                m = self.momentum if self.momentum is not None \
                    else 1.0 / float(self.num_batches_tracked)
                n = count.detach()
                self.running_mean.mul_(1 - m).add_(m * mean.detach())
                self.running_var.mul_(1 - m).add_(
                    m * var.detach() * n / torch.clamp(n - 1, min=1.0))
        return y.to(x.dtype)


def convert_sync_batchnorm(module: nn.Module) -> nn.Module:
    """`module` with every BatchNorm replaced by a SyncBatchNorm that holds
    the same parameter and buffer tensors (an optimizer built on the old
    parameters still steps them), in the same mode; returns the new root.
    Modules that are already SyncBatchNorm stay."""
    out = module
    if isinstance(module, nn.modules.batchnorm._BatchNorm) and \
            not isinstance(module, SyncBatchNorm):
        out = SyncBatchNorm(module.num_features, module.eps, module.momentum,
                            module.affine, module.track_running_stats)
        if module.affine:
            out.weight, out.bias = module.weight, module.bias
        if module.track_running_stats:
            out.running_mean = module.running_mean
            out.running_var = module.running_var
            out.num_batches_tracked = module.num_batches_tracked
        out.train(module.training)
    for name, child in module.named_children():
        out.add_module(name, convert_sync_batchnorm(child))
    return out


@contextlib.contextmanager
def batchnorm_statistics_on_copies(unit: nn.Module):
    """Each train-mode BatchNorm of `unit` updates copies of its running
    statistics and counter, dropped on exit; the originals stay as they
    were, the same tensor objects."""
    saved = []
    for m in unit.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm) and m.training \
                and m.track_running_stats:
            names = ("running_mean", "running_var", "num_batches_tracked")
            saved.append((m, {k: getattr(m, k) for k in names}))
            for k in names:
                setattr(m, k, getattr(m, k).clone())
    try:
        yield
    finally:
        for m, buffers in saved:
            for k, v in buffers.items():
                setattr(m, k, v)


def remat_call(unit: nn.Module, fn, *args):
    """`fn(*args)`, the forward of `unit`, recomputed in the backward when
    `unit.remat` is set and `unit` trains with grad enabled (module
    docstring); otherwise called as it is. The units draw no random
    numbers, so the RNG state is not kept."""
    if not (unit.remat and unit.training and torch.is_grad_enabled()):
        return fn(*args)

    def contexts():    # (the forward's, the recompute's)
        return contextlib.nullcontext(), batchnorm_statistics_on_copies(unit)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, context_fn=contexts)
