"""The FLOPs of a call, counted on the reference nets on the `meta` device
(no kernel runs; seconds, not a forward at size).

The count is the JAX package's definition, which the port's MFU used
before the benchmark existed: 2·MACs of every convolution and matrix
product, forward and backward; elementwise, sort, gather and reduction work
counts nothing. torch's FlopCounterMode counts the forward convolutions;
three rules of pmf_tpu's replace or add to its own:

  * a convolution's input gradient is a convolution over the stride-dilated
    output gradient: each input element is a dot of kh·kw·cout/groups;
  * its weight gradient is 2·|w|·N·Ho·Wo, whatever the groups;
  * a bilinear resize is two matrix products with the interpolation weights
    (along W, then H), and so is each one's transpose in the backward pass.
    `F.interpolate` reaches `upsample_bilinear2d.vec`, which the counter
    would otherwise decompose into ops that count nothing.

The count depends on the shapes only: it is the same whatever kernels the
port runs, so a roofline or MFU that divides by it reads the same work.
"""
from __future__ import annotations

from math import prod

import torch
from torch.utils.flop_counter import FlopCounterMode

from .nets import NETS

aten = torch.ops.aten


def _conv_backward(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation,
                   _transposed, _output_padding, groups, output_mask, out_shape=None) -> int:
    n = 0
    if output_mask[0]:
        n += 2 * prod(x_shape) * prod(w_shape[2:]) * (w_shape[0] // groups)
    if output_mask[1]:
        n += 2 * prod(w_shape) * grad_out_shape[0] * prod(grad_out_shape[2:])
    return n


def _resize(n, c, h, w, ho, wo) -> int:
    return 2 * n * c * h * w * wo + 2 * n * c * h * wo * ho


def _upsample(x_shape, *_args, out_shape=None, **_kwargs) -> int:
    return _resize(*x_shape, *out_shape[2:])


def _upsample_backward(grad_out_shape, _output_size, input_size, *_args, out_shape=None,
                       **_kwargs) -> int:
    return _resize(*input_size, *grad_out_shape[2:])


RULES = {aten.convolution_backward: _conv_backward,
         aten.upsample_bilinear2d: _upsample,
         aten.upsample_bilinear2d.vec: _upsample,
         aten.upsample_bilinear2d_backward: _upsample_backward}


def count(net: str, batch: int, h: int, w: int, nclasses: int, base_channels: int,
          train: bool) -> int:
    """The FLOPs of one forward (eval) or one forward and backward (train)
    of `net` on a [batch, h, w] view. The backward is seeded by the sum of
    both streams' outputs: the losses hold no convolution or matrix
    product, and every parameter of the nets gets its gradient either way."""
    with torch.device("meta"):
        model = NETS[net](nclasses, base_channels)
        pcd = torch.zeros(batch, h, w, 5)
        img = torch.zeros(batch, h, w, 3)
    model.train(train)
    with FlopCounterMode(display=False, custom_mapping=RULES) as counter:
        with torch.set_grad_enabled(train):
            lidar, cam = model(pcd, img)
            if train:
                (lidar.sum() + cam.sum()).backward()
    return counter.get_total_flops()
