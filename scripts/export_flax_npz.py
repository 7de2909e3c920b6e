"""Export a pmf_tpu orbax snapshot to the flat `.npz` that the PyTorch port loads.

    python scripts/export_flax_npz.py <run_dir>/checkpoint/best_IOU_model out.npz
    python scripts/export_flax_npz.py <run_dir>/checkpoint/checkpoint out.npz

The input is a directory that pmf_tpu's CheckpointManager wrote: a
`best_{metric}_model` snapshot ({params, batch_stats}) or the resume
`checkpoint` ({state: {params, batch_stats, opt_state, step}, epoch}, whose
model trees are taken from under `state`). It is restored with orbax's
StandardCheckpointer and no target, so no model is built. The output holds
one array per leaf of `params` and `batch_stats`, keyed by its '/'-joined
path ('params/lidar_stream/.../Conv_0/kernel', 'batch_stats/.../mean'), as
`pmf_tpu_torch.models.convert.read_flax_npz` reads it; then

    python -m pmf_tpu_torch.tools.infer_kitti <config.yaml> --weights out.npz

and the port's other CLIs load it. A multi-task run's `params/mt_sigma` is
written too; the port's `load_weights` leaves it out.

This script imports orbax (and so JAX), which the port itself never does.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def flatten(tree, prefix: str, out: dict) -> dict:
    """The leaves of nested dicts `tree` into `out`, keyed by '/'-joined paths."""
    for key, value in tree.items():
        path = f"{prefix}/{key}"
        if isinstance(value, dict):
            flatten(value, path, out)
        else:
            out[path] = np.asarray(value)
    return out


def model_trees(restored: dict) -> dict:
    """{params, batch_stats} of a restored snapshot or resume checkpoint."""
    if "state" in restored:
        restored = restored["state"]
    missing = {"params", "batch_stats"} - set(restored)
    if missing:
        raise ValueError(f"not a pmf_tpu snapshot: no {sorted(missing)} among {sorted(restored)}")
    return {k: restored[k] for k in ("params", "batch_stats")}


def export(snapshot: str, out_path: str) -> dict:
    """Restore `snapshot` and write its model trees to `out_path`; returns the
    flat arrays written."""
    import orbax.checkpoint as ocp

    restored = ocp.StandardCheckpointer().restore(os.path.abspath(snapshot))
    flat: dict = {}
    for top, tree in model_trees(restored).items():
        flatten(tree, top, flat)
    np.savez(out_path, **flat)
    return flat


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("snapshot", help="best_{metric}_model or checkpoint directory")
    parser.add_argument("out", help="the .npz to write")
    args = parser.parse_args(argv)
    flat = export(args.snapshot, args.out)
    print(f"wrote {len(flat)} arrays to {args.out}")


if __name__ == "__main__":
    main()
