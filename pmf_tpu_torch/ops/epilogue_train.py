"""The epilogue of a train-mode conv: BN with the batch's statistics, its
activation and a residual, in two passes over the map forward and two
backward (the train side of `ops/epilogue.py`).

Two families, as the nets call them (`models/layers.py`):

    "act_bn":  out = BN(act(y + bias)) [+ residual]         conv_block with a BN
    "bn_act":  out = post(act(BN(y + bias)) [+ residual])   conv_bn

y is the conv's output without its bias. BN is `layers.BatchNorm2d` in train
mode: its input t as it is, μ = E[t] and the biased σ² = E[t²] − E[t]² in
float32, a = γ/√(σ²+ε), b = β − μ·a, and the running statistics move by the
momentum towards (μ, σ²) unless `running` is None (a remat recompute). The
output is computed in float32 and rounded once; so is each gradient.
LeakyReLU is max(x, 0.01x), its subgradient 0.505 at 0, as `layers.leaky_relu`.
The gradients reach y, the bias, γ, β and the residual as autograd of
`layers._chain` gives them.

`bn_epilogue` is one autograd Function. On CUDA each of its four passes is a
call into `csrc/conv_epilogue_train.cu` (the sums' passes end with a small
kernel that adds the per-block partials in a fixed order, so runs repeat);
`bn_epilogue.launches` counts those calls. It saves y, the [4, C] statistics
and, for a closing relu's mask, the output: no float32 copy of a map. It
replaces no TPU kernel (XLA fuses BN into the convs there); on the card
PyTorch ran these ops as some 25 passes a BN, forward and backward, half of a
PMF train step's device time. Bound: bytes, about 16 an element (20 with a
residual) at 3.35 TB/s.

On CPU tensors, or with `plain=True` (`bn_epilogue_plain`, the twin), every
pass is the same float32 computation in plain PyTorch (float64 for a float64
y): what the kernels are held to on the card, and what the CPU tests hold to
`layers._chain`.
"""
from __future__ import annotations

import torch

from . import kernels
from .epilogue import ACTS

FAMILIES = {"act_bn": 0, "bn_act": 1}
# (family, act, residual, post): the variants the nets call
VARIANTS = {
    ("act_bn", "leaky_relu", False, None),  # SalsaNext's blocks, fuse_conv, the RGB decoders
    ("act_bn", "leaky_relu", True, None),   # the blocks' last convs
    ("bn_act", "relu", False, None),        # ResNet's stem and first convs, the attention's
    ("bn_act", "sigmoid", False, None),     # the fusion attention's second conv
    ("bn_act", None, False, None),          # ResNet's downsamples
    ("bn_act", None, True, "relu"),         # BasicBlock's, Bottleneck's last conv_bn
}
MAX_C = 2048  # 256 threads of 8 channels


def takes(c: int, family: str, act, residual: bool, post) -> bool:
    """Whether the kernels hold this variant at C channels."""
    return c % 8 == 0 and c <= MAX_C and (family, act, residual, post) in VARIANTS


def _act(t, act):
    if act == "relu":
        return torch.relu(t)
    if act == "leaky_relu":
        return torch.maximum(t, t * 0.01)
    if act == "sigmoid":
        return torch.sigmoid(t)
    return t


def _col(v):
    return v[:, None, None]


def _bn_input(y, bias, family, act):
    """(t, s): BN's input, in float32 (float64 for a float64 y), and in
    act_bn the slope of act at y + bias (None in bn_act)."""
    t = y.to(torch.promote_types(y.dtype, torch.float32))
    if bias is not None:
        t = t + _col(bias)
    if family == "bn_act":
        return t, None
    one = torch.ones_like(t)
    return _act(t, act), torch.where(t > 0, one, torch.where(t < 0, one * 0.01, one * 0.505))


def _output_grad(gv, t, stats, family, act):
    """gz, the gradient of BN's output, from that of act's output (bn_act)."""
    if family == "act_bn" or act is None:
        return gv
    z = t * _col(stats[2]) + _col(stats[3])
    if act == "relu":
        return torch.where(z > 0, gv, 0.0)
    u = torch.sigmoid(z)
    return gv * (u * (1.0 - u))


# ---- the passes in plain PyTorch ---------------------------------------------

def _stats_plain(y, bias, weight, beta, running, eps, momentum, family, act):
    t, _ = _bn_input(y, bias, family, act)
    n = t.numel() // t.shape[1]
    dims = (0, 2, 3)
    mean = t.sum(dims) / n
    var = (t * t).sum(dims) / n - mean * mean
    rstd = 1.0 / torch.sqrt(var + eps)
    a = weight * rstd
    if running is not None:
        m = 1.0 - momentum
        running[0].copy_(m * running[0] + momentum * mean)
        running[1].copy_(m * running[1] + momentum * var)
    return torch.stack([mean, rstd, a, beta - mean * a])


def _apply_plain(y, residual, bias, stats, family, act, post):
    t, _ = _bn_input(y, bias, family, act)
    z = t * _col(stats[2]) + _col(stats[3])
    if family == "bn_act":
        z = _act(z, act)
    if residual is not None:
        z = z + residual.to(z.dtype)
    if post == "relu":
        z = torch.relu(z)
    return z.to(y.dtype)


def _grad_terms(g, y, bias, stats, family, act):
    t, s = _bn_input(y, bias, family, act)
    gz = _output_grad(g.to(t.dtype), t, stats, family, act)
    return gz, (t - _col(stats[0])) * _col(stats[1]), s


def _grad_sums_plain(g, y, out, bias, stats, family, act, post):
    """(grads [5, C]: dγ, dβ, d bias, k2, k3; the residual's gradient with a
    closing relu)."""
    gres = torch.where(out > 0, g, 0.0).to(g.dtype) if post else None
    gz, xh, s = _grad_terms(g if gres is None else gres, y, bias, stats, family, act)
    dims = (0, 2, 3)
    n = y.numel() // y.shape[1]
    sum_g, sum_gx = gz.sum(dims), (gz * xh).sum(dims)
    if s is None:
        sum_s, sum_gs, sum_xs = n, sum_g, xh.sum(dims)
    else:
        sum_s, sum_gs, sum_xs = s.sum(dims), (gz * s).sum(dims), (xh * s).sum(dims)
    a = stats[2]
    k2, k3 = -(a * sum_g) / n, -(a * sum_gx) / n
    dbias = a * sum_gs + k2 * sum_s + k3 * sum_xs
    return torch.stack([sum_gx, sum_g, dbias, k2, k3]), gres


def _grad_apply_plain(g, y, bias, stats, grads, family, act):
    gz, xh, s = _grad_terms(g, y, bias, stats, family, act)
    dt = _col(stats[2]) * gz + _col(grads[3]) + _col(grads[4]) * xh
    return (dt if s is None else dt * s).to(y.dtype)


# ---- the passes on the card --------------------------------------------------

def _ptr(t):
    return None if t is None else t.data_ptr()


def _shape(y):
    c = y.shape[1]
    return y.numel() // c, c


def _launch(entry, y, *args):
    kernels.launch(entry, y.device, *args, kernels.sms(y.device))
    bn_epilogue.launches += 1


def _workspace(y):
    """The per-block partials of a pass that sums: 10 floats a channel for each
    SM. Freed after its launch: the caching allocator hands it out again only
    to work queued behind it on the same stream."""
    return torch.empty(10 * kernels.sms(y.device) * y.shape[1], dtype=torch.float32,
                       device=y.device)


def _stats_kernel(y, bias, weight, beta, running, eps, momentum, family, act):
    m, c = _shape(y)
    stats = torch.empty(4, c, dtype=torch.float32, device=y.device)
    rm, rv = (None, None) if running is None else running
    _launch("pmf_bn_train_stats", y, y.data_ptr(), _ptr(bias), weight.data_ptr(),
            beta.data_ptr(), _ptr(rm), _ptr(rv), _workspace(y).data_ptr(), stats.data_ptr(), m,
            c, FAMILIES[family], float(eps), float(momentum))
    return stats


def _apply_kernel(y, residual, bias, stats, family, act, post):
    m, c = _shape(y)
    out = torch.empty_like(y)
    _launch("pmf_bn_train_apply", y, y.data_ptr(), _ptr(residual), _ptr(bias), stats.data_ptr(),
            out.data_ptr(), m, c, FAMILIES[family], ACTS[act], int(post == "relu"))
    return out


def _pixel_rows(g):
    """(g, its pixel stride): g as it is where its pixels are rows of C at
    one stride, 16-byte aligned (a channels-last tensor, or a channel slice
    of one: the gradient of a concatenation's part); else a channels-last
    copy."""
    n, c, h, w = g.shape
    ld = g.stride(3) if w > 1 else c
    want = (h * w * ld, 1, w * ld, ld)
    if (g.data_ptr() % 16 == 0 and ld >= c and ld % 8 == 0
            and all(size == 1 or st == wt for size, st, wt in zip(g.shape, g.stride(), want))):
        return g, ld
    return g.contiguous(memory_format=torch.channels_last), c


def _grad_sums_kernel(g, ldg, y, out, bias, stats, family, act, post):
    m, c = _shape(y)
    grads = torch.empty(5, c, dtype=torch.float32, device=y.device)
    gres = torch.empty_like(y) if post else None
    _launch("pmf_bn_train_grad_sums", y, g.data_ptr(), ldg, y.data_ptr(), _ptr(out), _ptr(bias),
            stats.data_ptr(), _ptr(gres), _workspace(y).data_ptr(), grads.data_ptr(), m, c,
            FAMILIES[family], ACTS[act], int(post == "relu"))
    return grads, gres


def _grad_apply_kernel(g, ldg, y, bias, stats, grads, family, act):
    m, c = _shape(y)
    dy = torch.empty_like(y)
    _launch("pmf_bn_train_grad_apply", y, g.data_ptr(), ldg, y.data_ptr(), _ptr(bias),
            stats.data_ptr(), grads.data_ptr(), dy.data_ptr(), m, c, FAMILIES[family], ACTS[act])
    return dy


class _BNEpilogue(torch.autograd.Function):

    @staticmethod
    def forward(ctx, y, bias, weight, beta, residual, running, eps, momentum, family, act, post,
                plain):
        kernel = y.is_cuda and not plain
        stats = (_stats_kernel if kernel else _stats_plain)(y, bias, weight, beta, running, eps,
                                                            momentum, family, act)
        out = (_apply_kernel if kernel else _apply_plain)(y, residual, bias, stats, family, act,
                                                          post)
        ctx.save_for_backward(y, bias, stats, out if post else None)
        ctx.variant = (family, act, post, residual is not None, kernel)
        return out

    @staticmethod
    def backward(ctx, g):
        y, bias, stats, out = ctx.saved_tensors
        family, act, post, has_residual, kernel = ctx.variant
        if kernel:
            g, ldg = _pixel_rows(g)
            grads, gres = _grad_sums_kernel(g, ldg, y, out, bias, stats, family, act, post)
            dy = (_grad_apply_kernel(g, ldg, y, bias, stats, grads, family, act) if gres is None
                  else _grad_apply_kernel(gres, y.shape[1], y, bias, stats, grads, family, act))
        else:
            grads, gres = _grad_sums_plain(g, y, out, bias, stats, family, act, post)
            dy = _grad_apply_plain(g if gres is None else gres, y, bias, stats, grads, family, act)
        dres = (g if gres is None else gres) if has_residual else None
        return (dy, None if bias is None else grads[2], grads[0], grads[1], dres,
                None, None, None, None, None, None, None)


def bn_epilogue(y: torch.Tensor, bias, weight: torch.Tensor, beta: torch.Tensor, family: str,
                act: str | None = None, residual: torch.Tensor | None = None,
                post: str | None = None, running=None, eps: float = 1e-5,
                momentum: float = 0.1, plain: bool = False) -> torch.Tensor:
    """The family's epilogue of y [N, C, H, W] (module docstring), differentiable
    in y, bias, weight (γ), beta (β) and the residual. bias, weight and beta
    float32 [C] (bias may be None); `running` the (mean, var) float32 [C]
    buffers to move, or None; the residual laid out as y. On CUDA y must be
    a bf16 contiguous in channels_last with C a multiple of 8 up to 2048 and
    the variant one of VARIANTS: four calls into the kernels, counted in
    `launches`. On the CPU, or with `plain`, the same in plain PyTorch."""
    if family not in FAMILIES or act not in ACTS or post not in (None, "relu"):
        raise ValueError(f"bn_epilogue: no family {family!r}, act {act!r} or post {post!r}")
    c = y.shape[1]
    if y.is_cuda and not plain:
        if (y.dtype != torch.bfloat16 or y.dim() != 4
                or not y.is_contiguous(memory_format=torch.channels_last)):
            raise ValueError(f"bn_epilogue takes a bf16 [N, C, H, W] contiguous in "
                             f"channels_last; got {y.dtype} {tuple(y.shape)} strides {y.stride()}")
        if not takes(c, family, act, residual is not None, post):
            raise ValueError(f"bn_epilogue: no kernel for {family} with act {act!r}, residual "
                             f"{residual is not None}, post {post!r} at {c} channels")
        if residual is not None and (
                residual.dtype != y.dtype or residual.shape != y.shape
                or residual.device != y.device
                or not residual.is_contiguous(memory_format=torch.channels_last)):
            raise ValueError(f"bn_epilogue: the residual must be laid out as y; got "
                             f"{residual.dtype} {tuple(residual.shape)} strides "
                             f"{residual.stride()}")
        vectors = {"weight": weight, "beta": beta, "bias": bias,
                   **({} if running is None else dict(zip(("running mean", "running var"),
                                                          running)))}
        for name, v in vectors.items():
            if v is not None:
                kernels.check(v, f"bn_epilogue: {name}", torch.float32, (c,), y.device)
    return _BNEpilogue.apply(y, bias, weight, beta, residual, running, eps, momentum, family,
                             act, post, plain)


bn_epilogue.launches = 0


def bn_epilogue_plain(*args, **kwargs) -> torch.Tensor:
    """`bn_epilogue` with every pass in plain PyTorch, on any device: the twin."""
    return bn_epilogue(*args, **kwargs, plain=True)
