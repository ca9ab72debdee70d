"""Shared building blocks (counterpart of ``calciumgan_tpu/models/base.py``).

Keras-parity choices kept from the JAX package (``base.py:3-9``):

- glorot_uniform kernel init and zero bias, drawn from an explicit
  ``torch.Generator`` (this overrides PyTorch's default Kaiming init); a
  conv kernel's fans count its receptive field (``K*Cin``, ``K*Cout``),
- LeakyReLU slope 0.3 (:func:`leaky_relu` takes another: WaveGAN's critic
  has 0.2),
- LayerNorm epsilon 1e-3 over the channel axis with Flax's fast variance
  ``E[x^2] - E[x]^2``, skipped when that axis has size 1 (``base.py:45-70``),
- BatchNorm before it (Flax's ``nn.BatchNorm``, momentum 0.99, epsilon
  1e-3), never skipped.

Mixed precision follows Flax, not autocast: each module carries its compute
``dtype`` as an attribute, keeps float32 parameters and casts inputs and
parameters to ``dtype`` on use. Norm statistics are float32.

Layout: modules compute channels-first, NCW (batch, channel, time) or NCHW
(batch, channel, time, neuron); the models' public boundary is channels-last
(:mod:`calciumgan_tpu_torch.models.calciumgan`,
:mod:`calciumgan_tpu_torch.models.calciumgan2d`). The convolutions take one
or two spatial axes: an ``int`` kernel size and stride are 1-D, a pair 2-D,
with SAME padding worked out per axis. Flax kernel layouts are converted by
:mod:`calciumgan_tpu_torch.convert`.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from calciumgan_tpu_torch.parallel import mesh as mesh_lib
from calciumgan_tpu_torch.utils import tracing

LAYER_NORM_EPS = 1e-3
BATCH_NORM_EPS = 1e-3
BATCH_NORM_MOMENTUM = 0.99


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX rounds a Python scalar that
    meets an array of that dtype (0.3 is 0.30078125 in bfloat16)."""
    return float(torch.tensor(value, dtype=dtype))


def leaky_relu(slope: float) -> Callable[[torch.Tensor], torch.Tensor]:
    """LeakyReLU with ``slope`` rounded to the input's dtype."""
    return lambda x: F.leaky_relu(
        x, negative_slope=_in_dtype(slope, x.dtype))


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "leakyrelu":
        return leaky_relu(0.3)
    if name == "linear":
        return lambda x: x
    return getattr(F, name)


def noise_width(sequence_length: int, strides: int,
                num_convolutions: int = 5) -> int:
    """Validated initial temporal width of the transpose-conv stack
    (``calciumgan_tpu/models/base.py:73-83``)."""
    w = sequence_length / (strides ** num_convolutions)
    if not float(w).is_integer():
        raise ValueError(
            f"sequence_length {sequence_length} not divisible by "
            f"strides**{num_convolutions} ({strides ** num_convolutions}); "
            f"w={w} is not an integer")
    return int(w)


def glorot_uniform_(weight: torch.Tensor, fan_in: int, fan_out: int,
                    rng: torch.Generator) -> torch.Tensor:
    """In-place U(-a, a), a = sqrt(6 / (fan_in + fan_out)), drawn on the
    generator's device and copied to the weight's."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    draw = torch.rand(weight.shape, generator=rng, device=rng.device)
    with torch.no_grad():
        weight.copy_(draw * (2.0 * limit) - limit)
    return weight


class Dense(nn.Module):
    """``nn.Dense`` over the last axis; weight stored ``(out, in)``. A
    model-parallel run cuts the weight of a sequence-sized layer into
    shards (:func:`calciumgan_tpu_torch.parallel.mesh.shard_models`, which
    sets :attr:`model_shard`), and the layer then computes through
    :func:`~calciumgan_tpu_torch.parallel.mesh.sharded_dense`."""

    # (weight dim the shards join on, the model group), or None
    model_shard = None

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, rng: torch.Generator, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))
        glorot_uniform_(self.weight, in_features, out_features, rng)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.model_shard is not None:
            return mesh_lib.sharded_dense(x, self.weight, self.bias,
                                          self.dtype, *self.model_shard)
        # bias added after the product, as Flax does (two roundings in bf16)
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return y + self.bias.to(self.dtype)


def same_conv_padding(width: int, kernel_size: int, stride: int) -> tuple:
    """(pad_lo, pad_hi) of XLA's SAME convolution on one axis: the output
    has ``ceil(W/s)`` frames, the padding totals ``max((ceil(W/s)-1)*s + K -
    W, 0)`` and its floor half goes on the left, so it is asymmetric when
    the total is odd."""
    out = -(-width // stride)
    total = max((out - 1) * stride + kernel_size - width, 0)
    return total // 2, total - total // 2


def _spatial(kernel_size, stride) -> tuple:
    """``(kernel, stride)`` as tuples with one entry per spatial axis."""
    kernel = tuple(kernel_size) if isinstance(kernel_size, (tuple, list)) \
        else (kernel_size,)
    stride = tuple(stride) if isinstance(stride, (tuple, list)) \
        else (stride,) * len(kernel)
    return kernel, stride


def _per_channel(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A ``(C,)`` tensor shaped to broadcast over channels-first input of
    ``ndim`` axes."""
    return t.view(-1, *([1] * (ndim - 2)))


class Conv(nn.Module):
    """Flax ``nn.Conv`` with padding SAME, channels-first; weight stored
    ``(Cout, Cin, *K)``. ``F.conv1d``/``F.conv2d`` are correlations, as
    ``lax.conv`` is, so the Flax kernel is not flipped. Torch's
    ``padding="same"`` rejects stride > 1, so the SAME padding of
    :func:`same_conv_padding` is given explicitly. Where an axis pads
    asymmetrically (an odd total: the extra frame on the right):

    - a 1-D layer prepends ``hi - lo`` zero taps to its kernel and pads
      ``hi`` frames on both sides, the same sums at the input's own width
      with no copy of the input. At WaveGAN's K 25, stride 4 (pads 10 and
      11) cuDNN took 4.38 ms forward and backward for the widest critic
      layer (128 x 102 x 16,384 in bf16) this way, 10.35 ms on a padded
      copy, and 0.42-0.52 against 2.80-2.98 ms at layers 4-5;
    - a 2-D layer pads a copy of the input with ``F.pad`` first. A zero tap
      on the conv2d recipe's neuron axis (pads 7 and 8) took its training
      step from 3.28 to 2.63 samples/s at batch 4: forward and backward of
      its third critic layer at 8 rows 4.15 ms on the copy, 78.5 ms with
      the zero tap (NVIDIA H100 80GB HBM3, 700 W, CUDA events).

    A 1-D layer computes through :class:`_Conv1d`: ``F.conv1d``'s forward
    and first backward, and a double backward of its own where a pass
    records the backward's graph (the gradient penalty's
    ``create_graph=True``). That takes the weight gradient from ``ggI``
    as cuDNN's backward-weight convolution (wgrad) on the tensor cores.
    Autograd's own rule correlates the transposed ``ggI`` with the
    transposed output gradient as a kernel of its frames dilated by the
    stride, which cuDNN runs on its legacy ``implicit_convolve_sgemm``,
    a quarter of WaveGAN's step. A penalty pass (forward, the input's
    gradient with its graph, the weight's gradient of the penalty) of
    WaveGAN's critic layers 1-5 at 64 rows in bf16 took 6.54, 2.06, 1.96,
    1.57 and 1.72 ms this way, 10.01, 12.16, 3.83, 2.57 and 1.38 ms by
    autograd's rule (NVIDIA H100 80GB HBM3, 700 W, CUDA events, medians
    of 10); at layer 5 the host sets the pace, and the device worked 1.41
    ms this way against 1.49 (torch.profiler).

    Each call counts, under ``conv`` (:func:`tracing.count`), the
    ``products`` it multiplies, zero taps included, and the
    ``work_products`` of the convolution itself: each output position by
    each tap of the layer's kernel, for each input and output channel;
    the second route also counts the bytes of its copy, ``pad_bytes``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride, dtype: torch.dtype, rng: torch.Generator,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel_size, self.stride = _spatial(kernel_size, stride)
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, *self.kernel_size, device=device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        area = math.prod(self.kernel_size)
        glorot_uniform_(self.weight, area * in_channels, area * out_channels,
                        rng)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        pads = [same_conv_padding(w, k, s) for w, k, s in
                zip(x.shape[2:], self.kernel_size, self.stride)]
        w = self.weight.to(self.dtype)
        if len(pads) == 1:
            (lo, hi), = pads
            if lo != hi:
                w = F.pad(w, (hi - lo, 0))
            y = _Conv1d.apply(x, w, self.stride[0], hi)
        elif all(lo == hi for lo, hi in pads):
            y = F.conv2d(x, w, stride=self.stride,
                         padding=tuple(lo for lo, _ in pads))
        else:  # F.pad lists the last axis first
            x = F.pad(x, [p for pair in reversed(pads) for p in pair])
            tracing.count("conv", pad_bytes=x.numel() * x.element_size())
            y = F.conv2d(x, w, stride=self.stride)
        n = x.shape[0] * math.prod(y.shape[1:]) * w.shape[1]
        tracing.count("conv", products=n * math.prod(w.shape[2:]),
                      work_products=n * math.prod(self.kernel_size))
        # bias added after the convolution, as Flax does
        return y + _per_channel(self.bias.to(self.dtype), y.ndim)


def _wanted(ctx, i: int) -> bool:
    """Whether the backward that runs wants the gradient of the node
    ``ctx``'s tensor input ``i``: the input needs one and the engine will
    run the node it flows to, the test autograd's own convolution makes
    before it computes a term."""
    if not ctx.needs_input_grad[i]:
        return False
    try:
        return torch._C._will_engine_execute_node(ctx.next_functions[i][0])
    except RuntimeError:  # a leaf that torch.autograd.grad captures
        return True


def _conv1d_backward(g, x, w, stride: int, padding: int, mask) -> tuple:
    """``(grad_input, grad_weight)`` of ``F.conv1d(x, w)`` for the output
    gradient ``g``, by the call autograd's backward of a convolution makes
    (cuDNN's dgrad and wgrad on the card); a term is None where ``mask``
    leaves it out."""
    gx, gw, _ = torch.ops.aten.convolution_backward(
        g, x, w, None, (stride,), (padding,), (1,), False, (0,), 1,
        (*mask, False))
    return gx, gw


class _Conv1d(torch.autograd.Function):
    """``F.conv1d(x, w, stride, padding)``, whose backward is
    :class:`_Conv1dGrads`, so that a pass that records the backward's graph
    differentiates it by that class's rule."""

    @staticmethod
    def forward(ctx, x, w, stride: int, padding: int):
        ctx.save_for_backward(x, w)
        ctx.conv = stride, padding
        ctx.set_materialize_grads(False)
        return F.conv1d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        if g is None:  # as autograd's convolution, no work for no gradient
            return None, None, None, None
        x, w = ctx.saved_tensors
        mask = _wanted(ctx, 0), _wanted(ctx, 1)
        return (*_Conv1dGrads.apply(g, x, w, *ctx.conv, mask), None, None)


class _Conv1dGrads(torch.autograd.Function):
    """The input and weight gradients of a 1-D convolution, and their own
    backward: for the gradients ``ggx`` and ``ggw`` arriving at them,

    - the output gradient's, ``conv1d(ggx, w) + conv1d(x, ggw)``;
    - the input's, from ``ggw``: the input gradient of ``conv1d(x, ggw)``;
    - the weight's, from ``ggx``: ``gw[o,i,k] = sum_b,t g[b,o,t] *
      ggx[b,i,t*s+k-pad]``, the weight gradient of ``conv1d(ggx, w)``,
      which cuDNN computes as a wgrad on the tensor cores. Autograd's own
      rule correlates ``ggx`` with ``g`` as a kernel dilated by the stride,
      which cuDNN runs on its legacy sgemm (see :class:`Conv`). Each such
      term counts ``conv/wgrad_double_backward`` and the products it
      multiplies, ``conv/wgrad_double_backward_products``."""

    @staticmethod
    def forward(ctx, g, x, w, stride: int, padding: int, mask):
        ctx.save_for_backward(g, x, w)
        ctx.conv = stride, padding
        ctx.set_materialize_grads(False)
        return _conv1d_backward(g, x, w, stride, padding, mask)

    @staticmethod
    def backward(ctx, ggx, ggw):
        g, x, w = ctx.saved_tensors
        stride, padding = ctx.conv
        want_g, want_x, want_w = (_wanted(ctx, i) for i in range(3))
        gg = gx = gw = None
        if ggx is not None:
            if want_g:
                gg = F.conv1d(ggx, w, stride=stride, padding=padding)
            if want_w:
                gw = _conv1d_backward(g, ggx, w, stride, padding,
                                      (False, True))[1]
                tracing.count("conv", wgrad_double_backward=1,
                              wgrad_double_backward_products=g.numel()
                              * math.prod(w.shape[1:]))
        if ggw is not None:
            if want_g:
                term = F.conv1d(x, ggw, stride=stride, padding=padding)
                gg = term if gg is None else gg + term
            if want_x:
                gx = _conv1d_backward(g, x, ggw, stride, padding,
                                      (True, False))[0]
        return gg, gx, gw, None, None, None


def same_transpose_padding(kernel_size: int, stride: int) -> tuple:
    """(pad_a, pad_b) that ``lax.conv_transpose`` gives padding SAME on the
    dilated input of one axis: ``pad_len = K+s-2``, ``pad_a = K-1`` if ``s >
    K-1`` else ``ceil(pad_len/2)``. The output length is ``W*s``."""
    pad_len = kernel_size + stride - 2
    pad_a = (kernel_size - 1 if stride > kernel_size - 1
             else -(-pad_len // 2))
    return pad_a, pad_len - pad_a


def _conv_transpose1d(x, w, stride, pads) -> torch.Tensor:
    """``F.conv_transpose1d`` with the weight K-flipped. Flax's output frame
    ``o`` is PyTorch's frame ``o`` at ``padding = K-1-pad_a``; the end gets
    ``output_padding = pad_b - pad_a`` frames (``s-K`` when ``s > K-1``,
    else 0 or -1). Where that is -1 (odd ``K+s``), PyTorch's padding would
    take the frame from the wrong side, so the full (padding 0) output is
    cropped."""
    (s,), ((pad_a, pad_b),) = stride, pads
    padding, output_padding = w.shape[-1] - 1 - pad_a, pad_b - pad_a
    if output_padding < 0:
        return F.conv_transpose1d(x, w, stride=s).narrow(
            -1, padding, x.shape[-1] * s)
    return F.conv_transpose1d(x, w, stride=s, padding=padding,
                              output_padding=output_padding)


def _kept_taps(width: int, kernel: int, stride: int, start: int) -> int:
    """The (input frame, tap) pairs of a 1-D transposed convolution, whose
    pair ``(i, k)`` adds to frame ``i*stride + k`` of its whole output,
    that land in the output frames ``[start, start + width*stride)``."""
    left = sum(max(0, min(kernel, start - i * stride))
               for i in range(min(width, -(-start // stride))))
    right = sum(max(0, kernel - start - j * stride)
                for j in range(1, width + 1) if j * stride < kernel - start)
    return width * kernel - left - right


def _dilated_conv2d(x, w, stride, pads) -> torch.Tensor:
    """``lax.conv_transpose`` as XLA defines it: the input dilated by the
    strides (zeros between frames), padded ``(pad_a, pad_b)`` on each axis
    and correlated at stride 1 with Flax's kernel, which is the stored
    K-flipped weight flipped back. cuDNN runs ``F.conv_transpose2d`` at the
    conv2d recipe's first two layers as a strided backward-data convolution
    off the tensor cores, 4.54 and 6.13 s at batch 64, and this form as a
    forward convolution on them, 23 and 158 ms (NVIDIA H100 80GB HBM3,
    700 W; ``chip_smoke.py`` phase 10); the dilation's zeros cost
    ``sh*sw`` times the products, which makes layers 2-3 slower this way
    (218 and 147 ms against 70 and 90)."""
    if any(s > 1 for s in stride):
        size = [(n - 1) * s + 1 for n, s in zip(x.shape[2:], stride)]
        dilated = x.new_zeros(*x.shape[:2], *size)
        dilated[(..., *(slice(None, None, s) for s in stride))] = x
        x = dilated
    kernel = w.flip((2, 3)).transpose(0, 1)  # Flax's (Cout, Cin, kh, kw)
    if all(a == b for a, b in pads):
        return F.conv2d(x, kernel, padding=tuple(a for a, _ in pads))
    return F.conv2d(F.pad(x, [p for pair in reversed(pads) for p in pair]),
                    kernel)


class ConvTranspose(nn.Module):
    """Flax ``nn.ConvTranspose`` with padding SAME, channels-first; weight
    stored ``(Cin, Cout, *K)`` flipped on every spatial axis, the layout of
    ``F.conv_transpose1d``/``2d`` (Flax does not flip its kernel,
    ``transpose_kernel=False``; see :mod:`calciumgan_tpu_torch.convert`).
    ``pads`` holds each axis's ``(pad_a, pad_b)``
    (:func:`same_transpose_padding`). One spatial axis runs
    ``F.conv_transpose1d`` (:func:`_conv_transpose1d`), two run XLA's own
    form of the transposed convolution (:func:`_dilated_conv2d`).

    Each call counts, under ``conv_transpose1d`` or ``conv_transpose2d``
    (:func:`tracing.count`), the ``products`` its route multiplies and the
    ``work_products`` of the transposed convolution itself, once for each
    input and output channel:

    - two axes: each input element by each tap. The dilated route
      multiplies the zeros between frames too, ``sh*sw`` times the work;
    - one axis: the (input frame, tap) pairs that land in the layer's
      output frames (:func:`_kept_taps`). Where ``K+s`` is odd the route
      multiplies every pair of the whole output, the cropped frames'
      too."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride, dtype: torch.dtype, rng: torch.Generator,
                 device=None):
        super().__init__()
        self.dtype = dtype
        kernel, self.stride = _spatial(kernel_size, stride)
        self.weight = nn.Parameter(torch.empty(
            in_channels, out_channels, *kernel, device=device))
        self.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        area = math.prod(kernel)
        glorot_uniform_(self.weight, area * in_channels, area * out_channels,
                        rng)
        self.pads = tuple(same_transpose_padding(k, s)
                          for k, s in zip(kernel, self.stride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if len(self.stride) == 1:
            (s,), ((pad_a, pad_b),), k = self.stride, self.pads, w.shape[-1]
            kept = _kept_taps(x.shape[-1], k, s, k - 1 - pad_a)
            every = x.shape[-1] * k if pad_b < pad_a else kept
            n = x.shape[0] * math.prod(w.shape[:2])
            tracing.count("conv_transpose1d", products=n * every,
                          work_products=n * kept)
            y = _conv_transpose1d(x, w, self.stride, self.pads)
        else:
            work = math.prod(x.shape) * math.prod(w.shape[1:])
            tracing.count("conv_transpose2d",
                          products=work * math.prod(self.stride),
                          work_products=work)
            y = _dilated_conv2d(x, w, self.stride, self.pads)
        # bias added after the convolution, as Flax does
        return y + _per_channel(self.bias.to(self.dtype), y.ndim)


def _global_moments(x32: torch.Tensor, dims, count: int):
    """The batch mean and fast biased variance over every rank's rows, as
    XLA takes a float32 mean (the sum times the float32 ``1/n``): one
    all-reduce of ``(sum, sum of squares, row count)``, differentiable when
    the pass records a graph, and none in a process without a group.

    The all-reduce spans every rank, not the data group: model peers hold
    the same rows, so each row is counted once by each peer in the sums
    and the counts alike, which leaves the moments (and, the counts being
    summed too, their gradients) the data group's; but every rank then
    gets the same bytes. Over the data group alone, model peers whose
    activations differ in the last bit (cuDNN's algorithm choice on
    another GPU) would keep diverging running statistics."""
    c = x32.shape[1]
    local = torch.cat([x32.sum(dims), (x32 * x32).sum(dims),
                       torch.full((1,), float(count), device=x32.device)])
    total = mesh_lib.metric_sum(
        local, differentiable=torch.is_grad_enabled())
    inv = torch.reciprocal(total[2 * c:])
    mean = total[:c] * inv
    return mean, (total[c:2 * c] * inv - mean * mean).clamp_min(0.0)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(momentum=0.99, epsilon=1e-3)`` over the channel
    axis of channels-first input (``flax/linen/normalization.py``):

    - in training the statistics are the batch's, over every axis but the
      channel, in float32 whatever the dtype, with the fast biased variance
      ``max(0, E[x^2] - E[x]^2)``; gradients flow through them. Each training
      pass then moves the running statistics ``r = 0.99 r + 0.01 batch``
      (the biased variance, float32);
    - in evaluation the running statistics normalise;
    - ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32,
      cast to the compute dtype.

    ``scale``/``bias`` are parameters (Flax's ``params``), ``mean``/``var``
    buffers (Flax's ``batch_stats``), starting at 1, 0, 0 and 1. No module
    state says whether a pass trains: the caller passes ``training``.

    In a data-parallel rank the statistics are the global batch's, as
    Flax's are over a batch sharded on a JAX mesh: the float32 sums, sums
    of squares and row counts are summed over every rank (model peers
    included: :func:`_global_moments`), through autograd where the pass
    backpropagates. Every rank makes the same training passes in the same
    order, so each one's all-reduce meets its peers'."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor, training: bool) -> torch.Tensor:
        x32 = x.float()
        if training:
            dims = [0, *range(2, x.ndim)]
            n = x.numel() // x.shape[1]
            mean, var = _global_moments(x32, dims, n)
            with torch.no_grad():
                for running, batch in ((self.mean, mean), (self.var, var)):
                    running.mul_(BATCH_NORM_MOMENTUM).add_(
                        batch * (1.0 - BATCH_NORM_MOMENTUM))
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + BATCH_NORM_EPS) * self.scale
        y = ((x32 - _per_channel(mean, x.ndim)) * _per_channel(mul, x.ndim)
             + _per_channel(self.bias, x.ndim))
        return y.to(self.dtype)


class Norm(nn.Module):
    """Optional BatchNorm then LayerNorm over the channel axis of
    channels-first input (``base.py:45-70``). The LayerNorm is skipped on a
    size-1 channel axis, the BatchNorm never. ``training`` selects the
    BatchNorm's batch statistics (and moves its running ones) over its
    running statistics; the LayerNorm does not read it."""

    def __init__(self, channels: int, batch_norm: bool = False,
                 layer_norm: bool = False, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.batch_norm = (BatchNorm(channels, dtype, device)
                           if batch_norm else None)
        self.layer_norm = layer_norm and channels > 1
        if self.layer_norm:
            self.scale = nn.Parameter(torch.ones(channels, device=device))
            self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor, training: bool = False
                ) -> torch.Tensor:
        if self.batch_norm is not None:
            x = self.batch_norm(x, training)
        if not self.layer_norm:
            return x
        x32 = x.float()
        inv_n = float(torch.tensor(1.0 / x.shape[1]))  # XLA's mean: sum*(1/n)
        mean = x32.sum(1, keepdim=True) * inv_n
        var = ((x32 * x32).sum(1, keepdim=True) * inv_n
               - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + LAYER_NORM_EPS) * _per_channel(self.scale,
                                                               x.ndim)
        y = (x32 - mean) * mul + _per_channel(self.bias, x.ndim)
        return y.to(self.dtype)
