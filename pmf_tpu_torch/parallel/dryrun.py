"""Data parallelism rehearsed on the CPU: n gloo processes run one PMF
train step and one validation pass at tiny shapes, held against the same
work in one process (counterpart of `__graft_entry__.py: dryrun_multichip`).

    python -m pmf_tpu_torch.parallel.dryrun [n]

The train step is the whole of it: the train view with its draws (point
Lovász flags included), PMFNet in train mode with dropout, `pmf_losses`,
backward, the gradient average, the hybrid optimizer's update and the
confusion matrices, in float64, where the order of the sums moves nothing
that a tolerance has to hide. Process r holds rows [r·b, (r+1)·b) of the
global batch; the one-process step takes all of it. The validation pass
runs the Trainer over `n_val` samples, a number the processes do not
divide, so that one of them runs an all-invalid batch.
"""
from __future__ import annotations

import datetime
import queue
import socket
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .mesh import shutdown

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
               device=torch.device("cpu"), steps: int = 1) -> dict:
    """`steps` PMF train steps (view and step, each with new draws) on rows
    `rows` of the global batch of `global_batch` scans, on `device`: the
    last step's loss terms and confusion matrices, and the BN running
    statistics and parameters after the updates, as numpy."""
    from ..data import build_batch
    from ..train import HybridOptimizer, LossConfig, make_pmf_train_step

    batch = [torch.from_numpy(a[rows]).to(device) for a in tiny_inputs(seed, global_batch)]
    model = tiny_model(dtype).to(device)
    optimizer = HybridOptimizer(model, lambda step: 0.01, 0.9, 1e-5)
    alpha = tuple(np.random.default_rng(seed + 1).uniform(0.2, 1, 20).tolist())
    step = make_pmf_train_step(model, optimizer, LossConfig(alpha=alpha))
    generator = torch.Generator(device=device).manual_seed(seed)
    for _ in range(steps):
        feature, _, label, points = build_batch(*batch, tiny_cfg(), train=True,
                                                generator=generator, return_points=True)
        aux = step(feature.to(dtype), label, generator, points)
    sd = model.state_dict()
    return {"aux": {k: v.cpu().numpy() for k, v in aux.items()},
            "stats": {k: v.cpu().numpy() for k, v in sd.items() if "running" in k},
            "params": {k: p.detach().cpu().numpy() for k, p in model.named_parameters()}}


def validation(seed: int = 0) -> dict:
    """The Trainer's validation pass over N_VAL in-memory scans in batches
    of VAL_BS (float32): its confusion matrices and batch count."""
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
                      torch.device("cpu"), [0.0] + [1.0] * 19)
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
    conf = all(np.array_equal(got["aux"][k], ref["aux"][k]) for k in ("conf", "conf_cam"))
    return {"loss_rel_err": loss, "stats_abs_err": stats, "param_rel_err": params,
            "conf_equal": conf, "losses": {k: float(v) for k, v in got["aux"].items()
                                           if k not in ("conf", "conf_cam")}}


def _worker(rank: int, world_size: int, port: int, seed: int, timeout_s: float, results):
    """Process `rank`: rank 0 first runs the one-process references (no
    group up yet), then every process joins the gloo group and runs its
    share; rank 0 compares."""
    try:
        torch.set_num_threads(1)
        ref = val_ref = None
        if rank == 0:
            ref = train_step(slice(0, ROWS * world_size), ROWS * world_size, seed)
            val_ref = validation(seed)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout_s))
        t0 = time.perf_counter()
        got = train_step(slice(rank * ROWS, (rank + 1) * ROWS), ROWS * world_size, seed)
        val = validation(seed)
        out = {"seconds": time.perf_counter() - t0, "batches": val["batches"],
               "losses": {k: float(v) for k, v in got["aux"].items()
                          if k not in ("conf", "conf_cam")}}
        if rank == 0:
            out["train"] = _compare(ref, got)
            out["validation"] = {
                "conf_equal": all(np.array_equal(val[k], val_ref[k])
                                  for k in ("conf", "conf_cam")),
                "labelled": float(val["conf"].sum()), "reference_batches": val_ref["batches"]}
        results.put((rank, "ok", out))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
    finally:
        shutdown()


def dryrun_multichip(n: int = 2, seed: int = 0, timeout_s: float = 240.0) -> dict:
    """Run `n` gloo processes (spawned) through one train step and one
    validation pass, and check them against one process: every loss term
    within LOSS_RTOL, the confusion matrices equal, the BN running
    statistics within STATS_ATOL, each parameter within PARAM_RTOL of its
    norm, the validation confusion equal. Returns rank 0's report with each
    process's losses; raises RuntimeError when a process fails or a check
    does not hold, TimeoutError when the processes do not finish in
    `timeout_s` (they are then terminated)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, args=(r, n, port, seed, timeout_s / 2, results))
             for r in range(n)]
    for p in procs:
        p.start()
    reports: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(reports) < n:
            try:
                rank, status, out = results.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise TimeoutError(f"dryrun_multichip({n}): {n - len(reports)} process(es) "
                                   f"unfinished after {timeout_s:.0f} s") from None
            if status != "ok":
                raise RuntimeError(f"dryrun_multichip({n}): rank {rank} failed:\n{out}")
            reports[rank] = out
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
    report = dict(reports[0], ranks=[reports[r] for r in range(n)])
    tr, va = report["train"], report["validation"]
    if not (tr["loss_rel_err"] <= LOSS_RTOL and tr["conf_equal"]
            and tr["stats_abs_err"] <= STATS_ATOL and tr["param_rel_err"] <= PARAM_RTOL
            and va["conf_equal"]):
        raise RuntimeError(f"dryrun_multichip({n}): {n} processes differ from one: {report}")
    return report


if __name__ == "__main__":
    world_size = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    r = dryrun_multichip(world_size)
    print(f"dryrun_multichip({world_size}): ok; train step loss rel err "
          f"{r['train']['loss_rel_err']:.2e}, BN stats abs err {r['train']['stats_abs_err']:.2e}, "
          f"parameter rel err {r['train']['param_rel_err']:.2e}, confusion equal; validation "
          f"{r['batches']} batches a process, confusion equal to one process's")
