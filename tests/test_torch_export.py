"""Weights from a pmf_tpu run into the port (ROADMAP C2):
`scripts/export_flax_npz.py` restores a snapshot that pmf_tpu's
CheckpointManager wrote (a best-model snapshot, or the resume checkpoint
with its optimizer state) and writes the flat `.npz` that the port's
`load_weights` reads; the loaded model equals the converter's state_dict
of the same trees exactly."""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pmf_tpu.models.torch_convert import convert_pmf_state_dict
from pmf_tpu.train.checkpoint import CheckpointManager
from pmf_tpu.train.state import TrainState
from pmf_tpu_torch import models as tmodels
from tests.test_torch_models import _numpy_sd
from tests.torch_threads import one_torch_thread  # noqa: F401

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts", "export_flax_npz.py")


def _exporter():
    spec = importlib.util.spec_from_file_location("export_flax_npz", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("net,snapshot", [("PMFNet", "best_IOU_model"),
                                          ("EPMFNet", "checkpoint")])
def test_orbax_snapshot_exports_to_load_weights(tmp_path, net, snapshot):
    """A base-8 net's flax trees saved by pmf_tpu's CheckpointManager
    (EPMF's with the multi-task `mt_sigma` among its params, in a resume
    checkpoint with an optimizer state), exported, loaded through
    `load_weights`: every tensor equal to `state_dict_from_flax` of the same
    trees, and to the port model they were made from."""
    cls = getattr(tmodels, net)
    source = tmodels.random_weights(cls(nclasses=17, base_channels=8), seed=31)
    params, stats = convert_pmf_state_dict(_numpy_sd(source))
    variables = {"params": params, "batch_stats": stats}
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    if snapshot == "checkpoint":
        variables["params"] = dict(params, mt_sigma=jnp.linspace(0.5, 1.5, 6))
        ckpt.save(TrainState.create(variables, optax.adamw(1e-3)), epoch=4)
    else:
        ckpt.save_best(variables, "IOU")
    out = str(tmp_path / "w.npz")
    _exporter().main([os.path.join(ckpt.directory, snapshot), out])

    with np.load(out) as z:
        assert ("params/mt_sigma" in z.files) == (snapshot == "checkpoint")
        assert not any(k.startswith(("opt_state", "step", "state")) for k in z.files)
    got = tmodels.load_weights(cls(nclasses=17, base_channels=8), out).state_dict()
    want = tmodels.state_dict_from_flax(cls(nclasses=17, base_channels=8), params, stats)
    assert got.keys() == want.keys() == source.state_dict().keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        assert torch.equal(got[k], source.state_dict()[k]), k


def test_export_refuses_a_tree_without_model_weights(tmp_path):
    """A directory whose tree holds no params/batch_stats is not a
    snapshot: the exporter says so and writes nothing."""
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save_best({"weights": {"w": np.ones(3, np.float32)}}, "IOU")
    out = str(tmp_path / "w.npz")
    with pytest.raises(ValueError, match="not a pmf_tpu snapshot"):
        _exporter().export(os.path.join(ckpt.directory, "best_IOU_model"), out)
    assert not os.path.exists(out)
