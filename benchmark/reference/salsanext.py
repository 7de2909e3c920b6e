"""SalsaNext's train step in plain PyTorch, float32 with TF32 off: the net
(Cortinhal et al., arXiv:2003.03653) on the range view, its losses, AdamW
and the FLOP count of a step.

The net is built from `nets.py`'s `ResContextBlock`, `ResBlock` and
`UpBlock` (conv → LeakyReLU → BN, channel dropout drawn from the generator
that `forward` takes, in the port's order), with the port's module names,
so one state_dict loads into both. It returns the class probabilities
[B, H, W, C] (softmax over the logits).

  loss = focal(p, label; masked to label > 0) + λ·lovász(p, label; ignore 0)

Lovász-softmax over every pixel of the batch, `classes='present'`, its
Jaccard weights detached; AdamW with betas 0.9 / 0.999, eps 1e-8 and
weight decay 0.01 on every parameter, its rate read from a warm-up cosine
at the optimizer's step count. The weight decay departs from the yaml's
`weight_decay: 0.0001`: the JAX package's `train/optim.py: adamw` and the
port's fix it at 0.01 on this path, and the yaml's is not read there.

`set_bf16(model)` rounds every convolution's input, weight and output to
bfloat16, and the gradients flowing back through them: the control, the
convolutions one precision below the configuration's float32.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from . import flops
from .nets import Conv2d, ResBlock, ResContextBlock, UpBlock
from .train import _jaccard_weights, focal, one_hot


@contextlib.contextmanager
def float32():
    """Both TF32 flags off inside (the reference's float32 is float32);
    their settings before it restored after."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn


class SalsaNext(nn.Module):
    def __init__(self, nclasses=20, base_channels=32, dropout_rate=0.2, in_channels=5):
        super().__init__()
        bc, p = base_channels, dropout_rate
        self.downCntx = ResContextBlock(in_channels, bc)
        self.downCntx2 = ResContextBlock(bc, bc)
        self.downCntx3 = ResContextBlock(bc, bc)
        self.resBlock1 = ResBlock(bc, 2 * bc, p, drop_out=False)
        self.resBlock2 = ResBlock(2 * bc, 4 * bc, p)
        self.resBlock3 = ResBlock(4 * bc, 8 * bc, p)
        self.resBlock4 = ResBlock(8 * bc, 8 * bc, p)
        self.resBlock5 = ResBlock(8 * bc, 8 * bc, p, pooling=False)
        self.upBlock1 = UpBlock(8 * bc, 8 * bc, 4 * bc, p)
        self.upBlock2 = UpBlock(4 * bc, 8 * bc, 4 * bc, p)
        self.upBlock3 = UpBlock(4 * bc, 4 * bc, 2 * bc, p)
        self.upBlock4 = UpBlock(2 * bc, 2 * bc, bc, p, drop_out=False)
        self.logits = Conv2d(bc, nclasses, 1)

    def forward(self, x, g=None):
        c = x.permute(0, 3, 1, 2)
        c = self.downCntx3(self.downCntx2(self.downCntx(c)))
        d0, s0 = self.resBlock1(c, g)
        d1, s1 = self.resBlock2(d0, g)
        d2, s2 = self.resBlock3(d1, g)
        d3, s3 = self.resBlock4(d2, g)
        up = self.upBlock1(self.resBlock5(d3, g), s3, g)
        up = self.upBlock2(up, s2, g)
        up = self.upBlock3(up, s1, g)
        up = self.upBlock4(up, s0, g)
        return torch.softmax(self.logits(up), dim=1).permute(0, 2, 3, 1)


class _Bf16(torch.autograd.Function):
    """Rounds a tensor to bfloat16, and the gradient flowing back through it."""

    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def _bf16_conv(conv: Conv2d, x):
    r = _Bf16.apply
    return r(F.conv2d(r(x), r(conv.weight), conv.bias, conv.stride, conv.padding, conv.dilation,
                      conv.groups))


def set_bf16(model: nn.Module) -> nn.Module:
    """Every convolution of `model` with its operands rounded to bfloat16."""
    for m in model.modules():
        if isinstance(m, Conv2d):
            m.forward = lambda x, conv=m: _bf16_conv(conv, x)
    return model


def lovasz_softmax(probs, labels, ignore=0):
    """The mean over the classes present in `labels` of the Lovász
    extension of each class's Jaccard loss over all pixels (those labelled
    `ignore` left out)."""
    C = probs.shape[-1]
    p, y = probs.reshape(-1, C), labels.reshape(-1)
    ok = y != ignore
    okf = ok.float()[:, None]
    fg = one_hot(y, C) * okf
    err = ((fg - p).abs() * okf).T
    with torch.no_grad():
        w = _jaccard_weights(err.detach(), one_hot(torch.where(ok, y, -1), C).T)
    present = (fg.sum(dim=0) > 0).float()
    return ((err * w).sum(dim=1) * present).sum() / present.sum().clamp(min=1.0)


def losses(probs, label, loss: dict):
    """focal + λ·Lovász of the probabilities against the range image's
    labels."""
    alpha = torch.tensor(loss["alpha"], dtype=torch.float32, device=label.device)
    foc = focal(probs, label, alpha, loss["gamma_focal"], label > 0)
    return foc + loss["lambda"] * lovasz_softmax(probs, label, ignore=0)


class AdamW:
    """torch's AdamW on every parameter, its rate read from `schedule` at
    the step count, which starts at `start_step`."""

    def __init__(self, model, schedule, start_step=0):
        self.schedule, self.steps = schedule, start_step
        self.opt = torch.optim.AdamW(model.parameters(), lr=schedule(start_step),
                                     betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def step(self):
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.steps)
        self.opt.step()
        self.steps += 1


def train_step(model, opt, feature, label, g, loss: dict):
    """One update of `model` by `opt` from the view (feature [B, H, W, 5],
    label [B, H, W]), dropout drawn from `g`, in float32: (the loss, each
    leaf's gradient norm)."""
    with float32():
        opt.zero_grad()
        total = losses(model(feature, g), label, loss)
        total.backward()
        grad = {k: float(t.grad.norm()) if t.grad is not None else 0.0
                for k, t in model.named_parameters()}
        opt.step()
    return float(total.detach()), grad


def count(batch: int, h: int, w: int, nclasses: int, base_channels: int) -> int:
    """The FLOPs of a train step on a [batch, h, w] range view:
    the forward and the backward of the parameters, counted on `meta`
    with `flops.py`'s rules (the losses and the update hold no
    convolution or matrix product)."""
    with torch.device("meta"):
        model = SalsaNext(nclasses, base_channels)
        x = torch.zeros(batch, h, w, 5)
    with FlopCounterMode(display=False, custom_mapping=flops.RULES) as counter:
        model.train()(x).sum().backward()
    return counter.get_total_flops()
