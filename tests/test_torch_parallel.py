"""Data parallelism over torch.distributed, on the CPU over gloo: two
spawned processes against one (parallel/dryrun.py), with timeouts on the
group and on the join, so that a hang fails instead of stalling."""
import numpy as np
import pytest
import torch

from pmf_tpu_torch import parallel
from pmf_tpu_torch.parallel import dryrun, mesh
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def report():
    """dryrun_multichip(2): one PMF train step (base 8, 2 scans of a 32x48
    view a process, the global batch 4, point Lovász and dropout on, in
    float64) and one validation pass over 5 samples, each against the same
    work in one process. It raises when a check fails; the tests below
    hold its numbers to their tolerances."""
    return dryrun.dryrun_multichip(2, timeout_s=240.0)


def test_pmf_train_step_at_world_2_equals_world_1(report):
    """The port's counterpart of tests/test_parallel.py::
    test_sharded_train_step_matches_single_device: losses to 1e-5
    relative, confusion matrices exact, BN running statistics to 1e-5,
    parameters after the update within 1e-5 of their norm."""
    train = report["train"]
    assert train["loss_rel_err"] <= 1e-5
    assert train["conf_equal"]
    assert train["stats_abs_err"] <= 1e-5
    assert train["param_rel_err"] <= 1e-5
    assert np.isfinite(list(train["losses"].values())).all()


def test_validation_at_world_2_with_odd_n_val(report):
    """5 samples in batches of 2 on 2 processes: rank 0 reads 3 (2
    batches), rank 1 reads 2 and runs an all-invalid second batch; no hang,
    and the confusion matrices equal the one-process run's (3 batches)."""
    val = report["validation"]
    assert val["conf_equal"] and val["labelled"] > 0
    assert [r["batches"] for r in report["ranks"]] == [2, 2]
    assert val["reference_batches"] == 3


def test_dryrun_multichip_runs_to_its_end(report):
    """Both processes finish and compute the same global loss."""
    assert len(report["ranks"]) == 2
    assert report["ranks"][0]["losses"] == report["ranks"][1]["losses"]
    assert all(r["seconds"] > 0 for r in report["ranks"])


def test_launch_environments_and_mesh(monkeypatch):
    """torchrun's and pmf_tpu's launch variables, no group without them,
    and the mesh the config may ask for."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "COORDINATOR_ADDRESS", "PROCESS_COUNT",
              "PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert mesh._launch_env() is None
    assert parallel.init_distributed("cpu") == (0, 1) and not parallel.data_parallel()
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("PROCESS_COUNT", "4")
    monkeypatch.setenv("PROCESS_ID", "2")
    assert mesh._launch_env() == ("tcp://10.0.0.1:1234", 2, 4, 0)
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mesh._launch_env() == ("env://", 3, 8, 1)
    parallel.check_mesh(-1, 1, 4)
    parallel.check_mesh(4, 1, 4)
    with pytest.raises(ValueError):
        parallel.check_mesh(2, 1, 4)
    parallel.check_mesh(-1, 2, 4)
    parallel.check_mesh(2, 2, 4)
    with pytest.raises(ValueError):
        parallel.check_mesh(-1, 3, 4)
    with pytest.raises(ValueError):
        parallel.check_mesh(4, 2, 4)


def test_collectives_are_the_one_process_computation_without_a_group():
    g = torch.Generator().manual_seed(0)
    want = torch.rand((3, 2), generator=torch.Generator().manual_seed(0))
    assert torch.equal(parallel.rand_rows((3, 2), g), want)
    x = torch.arange(6.0).reshape(2, 3)
    assert parallel.global_sum(x) is x and parallel.gather_cols(x) is x
    assert parallel.global_count(7) == 7
