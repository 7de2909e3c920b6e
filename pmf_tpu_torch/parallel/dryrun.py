"""Data parallelism and the spatial split rehearsed on the CPU: n gloo
processes run one PMF train step and one validation pass at tiny shapes,
held against the same work in one process (counterpart of
`__graft_entry__.py: dryrun_multichip`).

    python -m pmf_tpu_torch.parallel.dryrun [n [model]]

n processes form a (data, model) grid (`parallel.make_mesh`): model 1 (data
parallelism alone) unless given; `dryrun 4` runs data 2 × model 2, each
data group's scans split by rows over its 2 model ranks.

The train step is the whole of it: the train view with its draws (point
Lovász flags included), PMFNet in train mode with dropout, `pmf_losses`,
backward, the gradient average, the hybrid optimizer's update and the
confusion matrices, in float64, where the order of the sums moves nothing
that a tolerance has to hide. Data group d holds rows [d·b, (d+1)·b) of the
global batch; the one-process step takes all of it. The validation pass
runs the Trainer over `n_val` samples, a number the data groups do not
divide, so that one of them runs an all-invalid batch.

`Grid` is the harness: it spawns the processes, each of which runs a job
(a module-level function, so that it pickles) that joins the group when it
is ready, and collects what each returns, with timeouts on the group and on
the whole. `spatial_job` is the row split's check at tiny shapes
(tests/test_torch_spatial.py).
"""
from __future__ import annotations

import contextlib
import datetime
import queue
import socket
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from . import spatial
from .mesh import make_mesh, shutdown

# tolerances of the n-process step against the one-process step
LOSS_RTOL = 1e-5        # each loss term, relative
STATS_ATOL = 1e-5       # BN running statistics
PARAM_RTOL = 1e-5       # each parameter after the update, of its norm

H, W, N = 48, 64, 2048  # the tiny scans: image, points
TH, TW, PAD = 32, 48, 2  # the train view and its padding
ROWS = 2                 # scans a process
N_VAL, VAL_BS = 5, 2     # validation samples and batch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def tiny_inputs(seed: int, batch: int):
    """`data.synthetic.make_inputs` scans at H x W with a wide-angle camera
    (fx 40), which lands most points in the tiny image."""
    from ..data.synthetic import make_inputs

    raw = list(make_inputs(np.random.default_rng(seed), batch, N, H, W))
    raw[3][:, 0, 1] = raw[3][:, 1, 2] = -40.0
    return raw


def tiny_cfg():
    from ..data import PVConfig

    return PVConfig(canvas_h=H, canvas_w=W + 16, proj_h=H, proj_w=W, proj_ht=TH, proj_wt=TW,
                    h_pad=PAD, w_pad=PAD, n_points=N, img_jitter=(0.4, 0.4, 0.4))


def tiny_model(dtype=torch.float64):
    """PMFNet (base 8) with random weights from a seed, computing in
    `dtype`."""
    from ..models import PMFNet, random_weights

    model = random_weights(PMFNet(nclasses=20, base_channels=8), seed=5).to(dtype)
    model.dtype = dtype
    return model


def train_step(rows: slice, global_batch: int, seed: int = 0, dtype=torch.float64,
               device=torch.device("cpu"), steps: int = 1, mesh=None) -> dict:
    """`steps` PMF train steps (view and step, each with new draws) on rows
    `rows` of the global batch of `global_batch` scans, on `device`: the
    last step's loss terms and confusion matrices, and the BN running
    statistics and parameters after the updates, as numpy. Under a `mesh`
    of model size > 1 each step runs on this rank's block of the view's
    rows."""
    from ..data import build_batch
    from ..train import HybridOptimizer, LossConfig, make_pmf_train_step

    batch = [torch.from_numpy(a[rows]).to(device) for a in tiny_inputs(seed, global_batch)]
    model = tiny_model(dtype).to(device)
    optimizer = HybridOptimizer(model, lambda step: 0.01, 0.9, 1e-5)
    alpha = tuple(np.random.default_rng(seed + 1).uniform(0.2, 1, 20).tolist())
    step = make_pmf_train_step(model, optimizer, LossConfig(alpha=alpha))
    generator = torch.Generator(device=device).manual_seed(seed)
    for _ in range(steps):
        with _split(mesh):
            feature, _, label, points = build_batch(*batch, tiny_cfg(), train=True,
                                                    generator=generator, return_points=True)
            aux = step(spatial.split_rows(feature.to(dtype)), spatial.split_rows(label),
                       generator, points)
    sd = model.state_dict()
    return {"aux": {k: v.cpu().numpy() for k, v in aux.items()},
            "stats": {k: v.cpu().numpy() for k, v in sd.items() if "running" in k},
            "params": {k: p.detach().cpu().numpy() for k, p in model.named_parameters()}}


def _split(mesh):
    """The mesh's row split for one step, or nothing."""
    return mesh.split() if mesh is not None and mesh.model > 1 else contextlib.nullcontext()


def validation(seed: int = 0, mesh=None) -> dict:
    """The Trainer's validation pass over N_VAL in-memory scans in batches
    of VAL_BS (float32), under `mesh`: its confusion matrices and batch
    count."""
    from ..config import Options
    from ..train import Trainer

    raw = tiny_inputs(seed + 2, N_VAL)
    keys = ("points", "labels", "valid", "proj_matrix", "image", "img_h", "img_w")
    reader = lambda i: {k: a[i] for k, a in zip(keys, raw)}
    cfg = tiny_cfg()
    sensor = {k: getattr(cfg, k) for k in ("canvas_h", "canvas_w", "proj_h", "proj_w",
                                           "proj_ht", "proj_wt", "h_pad", "w_pad", "n_points")}
    opts = Options(config={"sensor": sensor}, batch_size=(ROWS, VAL_BS), n_threads=2)
    trainer = Trainer(opts, tiny_model(torch.float32), reader, N_VAL, reader, N_VAL,
                      torch.device("cpu"), [0.0] + [1.0] * 19, mesh=mesh)
    trainer.run(0, "Validation")
    return {"conf": trainer.metrics.conf, "conf_cam": trainer.metrics_img.conf,
            "batches": trainer.n_batches("Validation")}


def _compare(ref: dict, got: dict) -> dict:
    """The largest deviations of `got`'s train step from `ref`'s."""
    loss = max(abs(float(got["aux"][k]) - float(v)) / max(abs(float(v)), 1e-30)
               for k, v in ref["aux"].items() if k not in ("conf", "conf_cam"))
    stats = max(float(np.abs(got["stats"][k] - v).max()) for k, v in ref["stats"].items())
    params = max(float(np.linalg.norm(got["params"][k] - v) / max(np.linalg.norm(v), 1e-30))
                 for k, v in ref["params"].items())
    conf = all(np.array_equal(got["aux"][k], ref["aux"][k])
               for k in ("conf", "conf_cam") if k in ref["aux"])
    return {"loss_rel_err": loss, "stats_abs_err": stats, "param_rel_err": params,
            "conf_equal": conf, "losses": {k: float(v) for k, v in got["aux"].items()
                                           if k not in ("conf", "conf_cam")}}


class Grid:
    """`n` spawned processes as a (data, model) grid, each running
    `job(rank, join, *args)`, where `join()` starts the gloo group
    (timeout `timeout_s` / 2) and returns `make_mesh(-1, model)`; a job may
    do work alone before it joins. `results()` waits for every job and
    returns what each returned, in rank order; it raises RuntimeError when
    a job fails and TimeoutError when the jobs do not end within
    `timeout_s` of the start (the processes are then terminated, as they
    are on leaving a `with` block)."""

    def __init__(self, n: int, model: int, job, args=(), timeout_s: float = 240.0):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.n, self.timeout_s = n, timeout_s
        self.queue = ctx.Queue()
        port = free_port()
        self.procs = [ctx.Process(target=_run, args=(r, n, model, port, timeout_s / 2,
                                                     self.queue, job, args))
                      for r in range(n)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout_s

    def results(self) -> list:
        reports: dict = {}
        try:
            while len(reports) < self.n:
                try:
                    rank, status, out = self.queue.get(
                        timeout=max(self.deadline - time.monotonic(), 0.1))
                except queue.Empty:
                    raise TimeoutError(f"{self.n - len(reports)} of {self.n} process(es) "
                                       f"unfinished after {self.timeout_s:.0f} s") from None
                if status != "ok":
                    raise RuntimeError(f"rank {rank} of {self.n} failed:\n{out}")
                reports[rank] = out
            for p in self.procs:
                p.join(timeout=max(self.deadline - time.monotonic(), 1.0))
        finally:
            self.close()
        return [reports[r] for r in range(self.n)]

    def close(self) -> None:
        """Terminate the processes still running."""
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _run(rank, n, model, port, timeout_s, results, job, args):
    """One process of a Grid."""
    try:
        torch.set_num_threads(1)

        def join():
            dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                    world_size=n, timeout=datetime.timedelta(seconds=timeout_s))
            return make_mesh(-1, model)

        results.put((rank, "ok", job(rank, join, *args)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        shutdown()


def _dryrun_job(rank: int, join, data: int, seed: int) -> dict:
    """Rank 0 first runs the one-process references (no group up yet), then
    every process joins and runs its data group's share; rank 0 compares."""
    if rank == 0:
        ref = train_step(slice(0, ROWS * data), ROWS * data, seed)
        val_ref = validation(seed)
    mesh = join()
    d = mesh.data_index
    t0 = time.perf_counter()
    got = train_step(slice(d * ROWS, (d + 1) * ROWS), ROWS * data, seed, mesh=mesh)
    val = validation(seed, mesh)
    out = {"seconds": time.perf_counter() - t0, "batches": val["batches"],
           "losses": {k: float(v) for k, v in got["aux"].items()
                      if k not in ("conf", "conf_cam")}}
    if rank == 0:
        out["train"] = _compare(ref, got)
        out["validation"] = {
            "conf_equal": all(np.array_equal(val[k], val_ref[k]) for k in ("conf", "conf_cam")),
            "labelled": float(val["conf"].sum()), "reference_batches": val_ref["batches"]}
    return out


def dryrun_multichip(n: int = 2, seed: int = 0, timeout_s: float = 240.0,
                     model: int = 1) -> dict:
    """Run `n` gloo processes (spawned; a grid of n / model data groups of
    `model` ranks) through one train step and one validation pass, and check them against one process: every loss term within
    LOSS_RTOL, the confusion matrices equal, the BN running statistics
    within STATS_ATOL, each parameter within PARAM_RTOL of its norm, the
    validation confusion equal. Returns rank 0's report with each process's
    losses; raises RuntimeError when a process fails or a check does not
    hold, TimeoutError when the processes do not finish in `timeout_s`
    (they are then terminated)."""
    try:
        ranks = Grid(n, model, _dryrun_job, (n // model, seed), timeout_s).results()
    except (RuntimeError, TimeoutError) as e:
        raise type(e)(f"dryrun_multichip({n}, model={model}): {e}") from None
    report = dict(ranks[0], ranks=ranks)
    tr, va = report["train"], report["validation"]
    if not (tr["loss_rel_err"] <= LOSS_RTOL and tr["conf_equal"]
            and tr["stats_abs_err"] <= STATS_ATOL and tr["param_rel_err"] <= PARAM_RTOL
            and va["conf_equal"]):
        raise RuntimeError(f"dryrun_multichip({n}, model={model}): {n} processes differ from "
                           f"one: {report}")
    return report


def split_forward(model, inputs, mesh) -> list:
    """The eval forward of `model` on the [B, H, W, C] `inputs` under the
    mesh's row split, each output gathered whole (every rank of the model
    group gets the data group's full outputs)."""
    with mesh.split(), torch.no_grad():
        outs = model(*(spatial.split_rows(x) for x in inputs))
        outs = outs if isinstance(outs, tuple) else (outs,)
        return [spatial.gather_rows(o) for o in outs]


# spatial_job's nets and inputs: tests/test_parallel.py's 4 x 32x48, base 8
# (EPMFNet takes widths that are multiples of 32: 64)
SPLIT_NETS = {"PMFNet": 48, "EPMFNet": 64, "SalsaNext": 48}
SPLIT_B, SPLIT_H = 4, 32


def split_model(net: str, dtype=torch.float32):
    """The random-weight net (base 8, 20 classes) of the spatial checks,
    computing in `dtype`."""
    from .. import models

    model = models.random_weights(getattr(models, net)(nclasses=20, base_channels=8), seed=7)
    model = model.to(dtype)
    model.dtype = dtype
    return model


def split_inputs(net: str, seed: int = 0) -> list:
    """The nets' numpy inputs [B, H, W, C]: lidar features with 60 % of the
    pixels empty (EPMF's sparse masks then change along the rows), and an
    RGB image for the fusion nets."""
    rng = np.random.default_rng(seed)
    shape = (SPLIT_B, SPLIT_H, SPLIT_NETS[net])
    pcd = rng.normal(size=shape + (5,)).astype(np.float32)
    pcd[rng.random(shape) < 0.6] = 0.0
    if net == "SalsaNext":
        return [pcd]
    return [pcd, rng.random(shape + (3,)).astype(np.float32)]


def exchange_chain(x, convs):
    """A chain of the split ops with wide and uneven windows: a 3×3
    dilation-18 conv (its window spans a neighbour's whole block on 20 rows
    split in two), the -inf-padded max pool, the average pool, SalsaNext's
    2×2 dilation-2 conv, a strided conv, the bilinear upsample and the pixel
    shuffle. Every stage has a width of its own (12, 6, 3, 2, 4, 8), as the
    row split needs (parallel/spatial.py)."""
    from ..models.layers import avg_pool_3x3_s2, max_pool_3x3_s2
    from ..ops.resize import pixel_shuffle, upsample_bilinear

    y = convs[1](max_pool_3x3_s2(convs[0](x)))
    y = upsample_bilinear(convs[2](avg_pool_3x3_s2(y)))
    return pixel_shuffle(convs[3](y), 2)


def _exchange_check(mesh, seed: int) -> dict:
    """The split chain's values and gradients (of the input rows and the
    conv weights, float64) against the one-process chain on the same rank,
    at 20 rows and at 6 (whose last stage has fewer rows than ranks)."""
    from ..models.layers import Conv2d

    torch.manual_seed(seed)
    convs = [Conv2d(3, 4, 3, padding=18, dilation=18), Conv2d(4, 4, 2, padding=1, dilation=2),
             Conv2d(4, 8, 3, stride=2, padding=1), Conv2d(8, 16, 1)]
    convs = [c.double() for c in convs]
    params = [p for c in convs for p in c.parameters()]
    out = {}
    for h in (20, 6):
        g = torch.Generator().manual_seed(seed + h)
        x = torch.randn(2, 3, h, 12, generator=g, dtype=torch.float64, requires_grad=True)
        want = exchange_chain(x, convs)
        r = torch.randn(want.shape, generator=g, dtype=torch.float64)
        want_g = torch.autograd.grad((want * r).sum(), [x] + params)
        with mesh.split() as split:
            xs = spatial.split_rows(x.detach(), 2).requires_grad_()
            got = exchange_chain(xs, convs)
            lo, hi = split.rows(want.shape[2])
            got_g = torch.autograd.grad((got * r[:, :, lo:hi]).sum(), [xs] + params)
            full = spatial.gather_rows(got, 2)
            gx = spatial.gather_rows(got_g[0], 2)
            gw = [spatial.model_sum(t) for t in got_g[1:]]
        rel = lambda a, b: float((a - b).norm() / max(float(b.norm()), 1e-300))
        out[h] = {"value": rel(full, want), "grad_input": rel(gx, want_g[0]),
                  "grad_weights": max(rel(a, b) for a, b in zip(gw, want_g[1:]))}
    return out


def net_step(net: str, rows: slice, seed: int = 0, mesh=None) -> dict:
    """One float64 train step of `net` on random inputs (split_inputs'
    shapes, labels with a fifth unlabelled), rows `rows` of their 4 samples,
    under `mesh`'s row split: PMFNet with the image-domain Lovász
    (SensatUrban's and the configs' without `point_lovasz`), EPMFNet with
    the multi-task loss and σ, SalsaNext's loss with AdamW. Its loss terms,
    confusion matrix and parameters after the update."""
    from ..losses import init_multi_task_params
    from ..train import (HybridOptimizer, LossConfig, adamw, make_pmf_train_step,
                         make_salsanext_train_step)

    rng = np.random.default_rng(seed + 1)
    shape = (SPLIT_B, SPLIT_H, SPLIT_NETS[net])
    feature = torch.from_numpy(rng.normal(size=shape + (8,)))[rows]
    label = torch.from_numpy(np.where(rng.random(shape) < 0.2, 0,
                                      rng.integers(1, 20, shape)))[rows]
    model = split_model(net, torch.float64).train()
    cfg = LossConfig(alpha=tuple(rng.uniform(0.2, 1, 20).tolist()), use_mtloss=net == "EPMFNet")
    generator = torch.Generator().manual_seed(seed)
    with _split(mesh):
        feature, label = spatial.split_rows(feature), spatial.split_rows(label)
        if net == "SalsaNext":
            step = make_salsanext_train_step(model, adamw(model, lambda step: 0.01), cfg)
            aux = step(feature[..., :5], label, generator)
        else:
            sigma = torch.nn.Parameter(init_multi_task_params(6)) if cfg.use_mtloss else None
            opt = HybridOptimizer(model, lambda step: 0.01, 0.9, 1e-5,
                                  extra=[sigma] if sigma is not None else [])
            aux = make_pmf_train_step(model, opt, cfg, sigma)(feature, label, generator)
    return {"aux": {k: v.numpy() for k, v in aux.items()},
            "stats": {k: v.numpy() for k, v in model.state_dict().items() if "running" in k},
            "params": {k: p.detach().numpy() for k, p in model.named_parameters()}}


def spatial_job(rank: int, join, seed: int, cli_argv=None) -> dict:
    """The row split's check on a (data, model) grid: the split eval
    forwards of SPLIT_NETS in float64 and float32 (each data group its
    samples of split_inputs, gathered whole), the exchange chain's values
    and gradients against one process, the PMF train step (train_step on
    the data group's rows of the global batch, as one process would take
    all of them), each net's `net_step`, and, given `cli_argv`,
    `tools/train.py: main` on them (TensorBoard left out). Model rank 0 of
    each data group returns its results; the other ranks run their share
    and return nothing."""
    mesh = join()
    d, D = mesh.data_index, mesh.data
    rows = slice(d * SPLIT_B // D, (d + 1) * SPLIT_B // D)
    out = {"forward": {}}
    for net in SPLIT_NETS:
        inputs = split_inputs(net, seed)
        for dtype in (torch.float64, torch.float32):
            outs = split_forward(split_model(net, dtype),
                                 [torch.from_numpy(a[rows]).to(dtype) for a in inputs], mesh)
            out["forward"][net, str(dtype)[6:]] = [o.numpy() for o in outs]
    out["exchange"] = _exchange_check(mesh, seed)
    out["train"] = train_step(slice(d * ROWS, (d + 1) * ROWS), ROWS * D, seed, mesh=mesh)
    out["steps"] = {net: net_step(net, rows, seed, mesh) for net in SPLIT_NETS}
    if cli_argv is not None:
        from ..tools import train as train_cli

        sys.modules["torch.utils.tensorboard"] = None     # it pulls in TensorFlow here
        out["cli"] = train_cli.main(cli_argv)
    return out if mesh.model_index == 0 else None


if __name__ == "__main__":
    world_size = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    model_size = int(sys.argv[2]) if len(sys.argv) > 2 else 2 if world_size == 4 else 1
    r = dryrun_multichip(world_size, model=model_size)
    print(f"dryrun_multichip({world_size}): data {world_size // model_size} x model "
          f"{model_size} ok; train step loss rel err "
          f"{r['train']['loss_rel_err']:.2e}, BN stats abs err {r['train']['stats_abs_err']:.2e}, "
          f"parameter rel err {r['train']['param_rel_err']:.2e}, confusion equal; validation "
          f"{r['batches']} batches a process, confusion equal to one process's")
