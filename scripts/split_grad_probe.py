"""Where the float32 gradients of the PMF train step under the row split
move, on the CPU: the port's split step (data 1 x model 2, two gloo
processes) and pmf_tpu's H-sharded step (its `model` mesh axis on 2 of 8
CPU devices), each against its own unsplit step and beside the unsplit step
on the features times 1 + 2^-23, and the two packages against each other.

    JAX_PLATFORMS=cpu python scripts/split_grad_probe.py [--no-lovasz]

The step is parallel/dryrun.py's (2 tiny scans, the train view with the
points' winner flags) with dropout 0, so that both packages compute the
same function; --no-lovasz sets λ = 0 and drops the points. Distances are
‖Δg‖ / ‖g‖ over all parameters together; a parameter "moves past
pmf_tpu's noise" when ‖Δg‖ > max(1e-4 ‖g‖, 10 x the largest move of
pmf_tpu's own gradient between its unsplit, nudged and H-sharded steps),
the rule of tests/test_torch_train.py.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NUDGE = 1 + 2 ** -23


def batch():
    """The train view of dryrun's 2 tiny scans with fixed draws: (feature,
    label, points) as torch tensors. With a process group up it is built
    under the row split, whose ranks draw as one process (each rank of a
    group of two would otherwise keep its half of the draws of 4 scans)."""
    from pmf_tpu_torch.data import build_batch
    from pmf_tpu_torch.parallel import dryrun

    raw = dryrun.tiny_inputs(0, dryrun.ROWS)
    with torch.no_grad():
        f, _, lab, pts = build_batch(*map(torch.from_numpy, raw), dryrun.tiny_cfg(), train=True,
                                     generator=torch.Generator().manual_seed(0),
                                     return_points=True)
    return f, lab, pts


def model():
    from pmf_tpu_torch.models import PMFNet, random_weights

    return random_weights(PMFNet(nclasses=20, base_channels=8, dropout_rate=0.0), seed=5)


def alpha() -> tuple:
    return tuple(np.random.default_rng(1).uniform(0.2, 1, 20).astype(np.float32).tolist())


def port_grads(f, lab, pts, lovasz: bool, mesh=None) -> dict:
    """The port's float32 step (under `mesh`'s row split when given): the
    parameter gradients by name."""
    import contextlib

    from pmf_tpu_torch.parallel import spatial
    from pmf_tpu_torch.train import HybridOptimizer, LossConfig, make_pmf_train_step

    net = model()
    step = make_pmf_train_step(net, HybridOptimizer(net, lambda s: 1e-3, 0.9, 1e-5),
                               LossConfig(alpha=alpha(), lambda_=1.0 if lovasz else 0.0))
    with mesh.split() if mesh is not None else contextlib.nullcontext():
        step(spatial.split_rows(f), spatial.split_rows(lab), None, pts if lovasz else None)
    return {k: p.grad.detach().numpy().copy() for k, p in net.named_parameters()}


def split_job(rank: int, join, lovasz: bool):
    torch.set_num_threads(1)
    mesh = join()
    with mesh.split():
        view = batch()
    grads = port_grads(*view, lovasz, mesh)
    return grads if rank == 0 else None


def jax_grads(f, lab, pts, lovasz: bool, sharded: bool) -> dict:
    """pmf_tpu's float32 step of the same weights (its gradients kept as its
    optimizer's state), the features' rows over its `model` axis when
    `sharded`: the gradients by the port's names."""
    import jax
    import jax.numpy as jnp
    import optax

    from pmf_tpu import models as jmodels
    from pmf_tpu import train as jtrain
    from pmf_tpu.models.torch_convert import convert_pmf_state_dict
    from pmf_tpu.parallel import make_mesh, shard_batch

    net = model()
    params, stats = convert_pmf_state_dict({k: v.numpy() for k, v in net.state_dict().items()})
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    state = jtrain.TrainState.create({"params": params, "batch_stats": stats}, keep)
    step = jtrain.make_pmf_train_step(jmodels.PMFNet(nclasses=20, base_channels=8,
                                                     dropout_rate=0.0), keep,
                                      jtrain.LossConfig(alpha=alpha(),
                                                        lambda_=1.0 if lovasz else 0.0),
                                      donate=False)
    args = {"f": f.numpy(), "l": lab.numpy(), "p": tuple(p.numpy() for p in pts)}
    if sharded:
        args = shard_batch(make_mesh(data=1, model=2), args, spatial=True)
    new_state, _ = step(state, args["f"], args["l"], jax.random.PRNGKey(0),
                        args["p"] if lovasz else None)
    # the port's names: the converter is linear, so it maps gradients back as
    # it maps weights (its inverse is the port's converter)
    from pmf_tpu_torch.models.convert import state_dict_from_flax

    flat = state_dict_from_flax(net, jax.tree_util.tree_map(np.asarray, new_state.opt_state),
                                jax.tree_util.tree_map(np.asarray, stats))
    return {k: np.asarray(flat[k]) for k, _ in net.named_parameters()}


def distance(a: dict, b: dict) -> float:
    num = sum(float(np.linalg.norm(a[k].astype(np.float64) - v)) ** 2 for k, v in b.items())
    den = sum(float(np.linalg.norm(v.astype(np.float64))) ** 2 for v in b.values())
    return (num / den) ** 0.5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-lovasz", action="store_true")
    lovasz = not ap.parse_args(argv).no_lovasz
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    from pmf_tpu_torch.parallel import dryrun

    torch.set_num_threads(1)
    with dryrun.Grid(2, 2, split_job, (lovasz,), timeout_s=600.0) as grid:
        f, lab, pts = batch()
        port = {"unsplit": port_grads(f, lab, pts, lovasz),
                "nudged": port_grads(f * NUDGE, lab, pts, lovasz)}
        jx = {"unsplit": jax_grads(f, lab, pts, lovasz, False),
              "nudged": jax_grads(f * NUDGE, lab, pts, lovasz, False),
              "sharded": jax_grads(f, lab, pts, lovasz, True)}
        port["split"] = grid.results()[0]
    print(f"PMF train step, float32, {'with' if lovasz else 'without'} the Lovász terms, "
          f"2 x {tuple(f.shape[1:3])}, on the CPU; gradients' distance of their norm:")
    for name, g in (("port", port), ("pmf_tpu", jx)):
        moved = "split" if name == "port" else "sharded"
        print(f"  {name}: {moved} from unsplit {distance(g[moved], g['unsplit']):.3g}, "
              f"nudged from unsplit {distance(g['nudged'], g['unsplit']):.3g}")
    print(f"  port against pmf_tpu: unsplit {distance(port['unsplit'], jx['unsplit']):.3g}, "
          f"split against H-sharded {distance(port['split'], jx['sharded']):.3g}")
    for mine, theirs in (("unsplit", "unsplit"), ("split", "sharded")):
        past = []
        for k, w in jx[theirs].items():
            noise = max(np.linalg.norm(jx[o][k] - w) for o in jx if o != theirs)
            err = np.linalg.norm(port[mine][k] - w)
            if err > max(1e-4 * np.linalg.norm(w), 10 * noise) + 1e-7:
                past.append(f"{k} (|dg| {err:.3g}, noise {noise:.3g}, |g| "
                            f"{np.linalg.norm(w):.3g})")
        print(f"  port {mine} against pmf_tpu {theirs}: {len(past)} of {len(jx[theirs])} "
              f"parameters move past pmf_tpu's noise {past}")


if __name__ == "__main__":
    main()
