"""The epilogue of an inference conv in one pass: its bias, activation, the
eval BN that follows the activation, a residual and a closing ReLU.

    out = post(act(y + bias) · a + b [+ residual])

computed in float32 and rounded once, over the conv's output y in place.
`act` is None, "relu", "leaky_relu" (max(x, 0.01x), as `layers.leaky_relu`)
or "sigmoid"; a, b are the eval BN's coefficients (`BatchNorm2d.fold`), or
absent; `post` is None or "relu", as in relu(out + x).

The CUDA kernel is `csrc/conv_epilogue.cu`. It replaces no TPU kernel: XLA
fuses these ops into the conv there. It was added because PyTorch runs them
on the card as 3-6 passes of their own after each cuDNN conv (the bias as a
[C, 1, 1] broadcast over a channels-last map, on its unvectorized
elementwise kernel), which took more than half of a PMF eval call's device
time. Bound: bytes, one read and one write of y and one read of the
residual, at 3.35 TB/s.

The nets call it through `models/layers.py: conv_block` and `conv_bn`, which
take it for a conv whose input (and residual) is a CUDA bf16 tensor
contiguous in channels_last, with grad off, BN in eval mode and no row
split; the conv then runs without its bias. Everything else (training,
float32, the CPU, the split) keeps PyTorch's chain of ops.

`conv_epilogue_plain` is the same function in plain PyTorch, the same float32
ops in the same order: the CPU path and what the kernel is held to on the
card.
"""
from __future__ import annotations

import torch

from . import kernels

ACTS = {None: 0, "relu": 1, "leaky_relu": 2, "sigmoid": 3}
POSTS = {None: 0, "relu": 1}
# (act, BN, residual, post): the variants the nets call, each a kernel of its own
VARIANTS = {
    (None, False, False, None),          # the bias alone: logits, ASPP's merge, downsamples
    ("relu", False, False, None),        # conv_bn with relu
    ("sigmoid", False, False, None),     # the fusion block's attention
    ("leaky_relu", False, False, None),  # SalsaNext's shortcuts
    ("leaky_relu", True, False, None),   # SalsaNext's blocks, fusion, the decoders' stages
    ("leaky_relu", True, True, None),    # the blocks' last convs
    (None, False, True, "relu"),         # BasicBlock's, Bottleneck's last conv_bn
}
MAX_C = 2048  # 256 threads of 8 channels; 256 channels where C is not a multiple of 8


def conv_epilogue_plain(y: torch.Tensor, bias: torch.Tensor, act: str | None = None,
                        a: torch.Tensor | None = None, b: torch.Tensor | None = None,
                        residual: torch.Tensor | None = None,
                        post: str | None = None) -> torch.Tensor:
    """y [N, C, H, W] ← post(act(y + bias) · a + b [+ residual]), each op in
    float32 (float64 for a float64 y), rounded once to y's dtype; in place,
    returns y."""
    t = y.to(torch.promote_types(y.dtype, torch.float32)) + bias[:, None, None]
    if act == "relu":
        t = torch.relu(t)
    elif act == "leaky_relu":
        t = torch.maximum(t, t * 0.01)
    elif act == "sigmoid":
        t = torch.sigmoid(t)
    if a is not None:
        t = t * a[:, None, None] + b[:, None, None]
    if residual is not None:
        t = t + residual.to(t.dtype)
    if post == "relu":
        t = torch.relu(t)
    return y.copy_(t)


def epilogue_takes(t: torch.Tensor) -> bool:
    """Whether the kernel takes t (a conv's input, output or residual): a
    CUDA bf16 [N, C, H, W] contiguous in channels_last."""
    return (t.is_cuda and t.dtype == torch.bfloat16 and t.dim() == 4
            and t.is_contiguous(memory_format=torch.channels_last))


def _check_vector(v, name: str, c: int, device) -> None:
    if v is None or v.dtype != torch.float32 or v.shape != (c,) or v.device != device \
            or not v.is_contiguous():
        raise ValueError(f"conv_epilogue: {name} must be a contiguous float32 [{c}] on "
                         f"{device}; got {None if v is None else (v.dtype, tuple(v.shape))}")


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, act: str | None = None,
                  a: torch.Tensor | None = None, b: torch.Tensor | None = None,
                  residual: torch.Tensor | None = None, post: str | None = None) -> torch.Tensor:
    """`conv_epilogue_plain` on y in place, which must be a bf16 [N, C, H, W]
    contiguous in channels_last (C ≤ 2048, or ≤ 256 where C is not a multiple
    of 8); bias, a and b float32 [C]; the residual as y. On the CPU the plain
    version runs; on CUDA tensors one launch of the kernel, and anything else
    raises (it does not fall back); so does a variant not in VARIANTS. Counts
    its kernel's launches in `launches`."""
    if (y.dtype != torch.bfloat16 or y.dim() != 4
            or not y.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"conv_epilogue takes a bf16 [N, C, H, W] contiguous in channels_last; "
                         f"got {y.dtype} {tuple(y.shape)} strides {y.stride()}")
    c = y.shape[1]
    if c > (MAX_C if c % 8 == 0 else MAX_C // 8):
        raise ValueError(f"conv_epilogue takes at most {MAX_C} channels (256 unless a multiple "
                         f"of 8); got {c}")
    if (a is None) != (b is None):
        raise ValueError("conv_epilogue: BN's a and b go together")
    if (act, a is not None, residual is not None, post) not in VARIANTS:
        raise ValueError(f"conv_epilogue: no kernel for act {act!r}, BN {a is not None}, "
                         f"residual {residual is not None}, post {post!r}")
    _check_vector(bias, "bias", c, y.device)
    if a is not None:
        _check_vector(a, "a", c, y.device)
        _check_vector(b, "b", c, y.device)
    if residual is not None and (
            residual.dtype != y.dtype or residual.shape != y.shape
            or residual.device != y.device
            or not residual.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(f"conv_epilogue: the residual must be laid out as y; got "
                         f"{residual.dtype} {tuple(residual.shape)} strides {residual.stride()}")
    if y.is_cpu:
        conv_epilogue_plain(y, bias, act, a, b, residual, post)
    else:
        ptr = lambda t: None if t is None else t.data_ptr()
        kernels.launch("pmf_conv_epilogue", y.device, y.data_ptr(), ptr(residual),
                       bias.data_ptr(), ptr(a), ptr(b), y.numel() // c, c, ACTS[act],
                       POSTS[post], kernels.sms(y.device))
        conv_epilogue.launches += 1
    return y


conv_epilogue.launches = 0
