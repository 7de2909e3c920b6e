"""Analytic FLOP accounting (counterpart of `pmf_tpu/utils/flops.py`).

An efficiency claim is the model FLOP utilization: the matmul and
convolution FLOPs a function needs, over its time, over the card's peak.
The count is pmf_tpu's definition, so that the two packages' MFUs count
the same work: 2·MACs of every convolution (2 · out_elems · kh·kw ·
cin_per_group) and every matrix product (2 · batch · M·N·K), forward and
backward; elementwise, sort, gather, scatter and reduction work counts
nothing (on these conv nets it is bound by memory, not by the tensor
cores).

`count_flops` runs the function once under torch's `FlopCounterMode`,
whose forward convolution and matmul rules are pmf_tpu's, with three
rules of its own where pmf_tpu's jaxpr counts otherwise:

  * the gradient of a convolution's input: pmf_tpu differentiates a conv
    into a conv over the stride-dilated output gradient that produces the
    input's shape, so each of the input's elements is a dot of kh·kw ·
    cout/groups (4x the forward for a stride-2 conv; torch's own rule
    counts the forward's);
  * the gradient of the weights: 2 · |w| · N·Ho·Wo, whatever the groups
    (torch's rule counts a grouped conv `groups` times);
  * the bilinear resize: `jax.image.resize` is two matrix products with the
    interpolation weights, along W and then H, each counted as a matmul,
    and so is each one's transpose in the backward pass.

On tensors of the `meta` device (a module moved there with `.to("meta")`)
the count runs no kernel. A function whose work depends on the data (the
losses' sorts, the confusion matrices) runs on its device.

The confusion matrices are the one term the two counts leave apart:
pmf_tpu computes each as a one-hot matrix product, 2·C²·P FLOPs, the port
as a scatter-add, which counts nothing (tests/test_torch_flops.py).
"""
from __future__ import annotations

from math import prod

import torch
from torch.utils.flop_counter import FlopCounterMode

aten = torch.ops.aten

# NVIDIA's data sheet for the H100 SXM, dense, at the 700 W power limit
H100_BF16_PEAK_FLOPS = 989e12


def _conv_backward(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation,
                   transposed, _output_padding, groups, output_mask, out_shape=None) -> int:
    if transposed:
        raise NotImplementedError("count_flops: no port model has a transposed convolution")
    n = 0
    if output_mask[0]:
        n += 2 * prod(x_shape) * prod(w_shape[2:]) * (w_shape[0] // groups)
    if output_mask[1]:
        n += 2 * prod(w_shape) * grad_out_shape[0] * prod(grad_out_shape[2:])
    return n


def _resize(n: int, c: int, h: int, w: int, ho: int, wo: int) -> int:
    """The two matmuls of jax.image.resize [N, H, W, C] → [N, Ho, Wo, C]:
    along W first, then along H."""
    return 2 * n * c * h * w * wo + 2 * n * c * h * wo * ho


def _upsample_bilinear(x_shape, *_args, out_shape=None, **_kwargs) -> int:
    return _resize(*x_shape, *out_shape[2:])


def _upsample_bilinear_backward(grad_out_shape, _output_size, input_size, *_args,
                                out_shape=None, **_kwargs) -> int:
    return _resize(*input_size, *grad_out_shape[2:])


# F.interpolate reaches the `vec` overload; under torch.inference_mode no
# autograd layer turns it into the default one first, and FlopCounterMode
# would decompose it into ops that count nothing
_RULES = {aten.convolution_backward: _conv_backward,
          aten.upsample_bilinear2d: _upsample_bilinear,
          aten.upsample_bilinear2d.vec: _upsample_bilinear,
          aten.upsample_bilinear2d_backward: _upsample_bilinear_backward}


def count_flops(fn, *args, **kwargs) -> int:
    """Run fn(*args, **kwargs) once and return its matmul and convolution
    FLOPs, forward and backward, as pmf_tpu counts them."""
    with FlopCounterMode(display=False, custom_mapping=_RULES) as counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()


def mfu(flops_per_sec: float, peak: float = H100_BF16_PEAK_FLOPS) -> float:
    return flops_per_sec / peak
