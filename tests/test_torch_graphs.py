"""The CUDA graphs' gate (`models/graphs.py`) on the CPU: every condition
that keeps a call on the eager path keeps it there, and the eager forward
of both fusion nets is the three streams composed as before. The graphs
themselves run on the card (tests/test_torch_cuda.py)."""
from types import SimpleNamespace

import pytest
import torch

from pmf_tpu_torch.models import EPMFNet, PMFNet, random_weights
from pmf_tpu_torch.parallel import spatial
from tests.torch_threads import one_torch_thread  # noqa: F401

NETS = {"PMFNet": PMFNet, "EPMFNet": EPMFNet}
# each case closes the gate by one condition; "cpu" by the inputs' device alone
CASES = ("cpu", "batch2", "train", "grad", "split", "generator", "remat")


def composed(model, pcd, img, generator, remat):
    """The nets' forward as their three streams composed by hand."""
    p = pcd.permute(0, 3, 1, 2).to(model.dtype)
    feats = model.camera_stream_encoder(img.permute(0, 3, 1, 2).to(model.dtype), generator,
                                        remat)
    if isinstance(model, EPMFNet):
        lidar, bottleneck = model.lidar_stream(p, feats, generator, remat)
        camera = model.camera_stream_decoder(feats, bottleneck, remat)
    else:
        lidar = model.lidar_stream(p, feats, generator, remat)
        camera = model.camera_stream_decoder(feats, remat)
    return lidar.permute(0, 2, 3, 1), camera.permute(0, 2, 3, 1)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("net", NETS)
def test_graph_gate_stays_closed(net, case, monkeypatch):
    """The gate reads closed under each case where it reads open without
    it (the device taken as a card's); the CPU forward then equals the
    streams composed by hand, and no signature is recorded, captured or
    replayed."""
    torch.manual_seed(0)
    model = random_weights(NETS[net](nclasses=5, base_channels=8, dropout_rate=0.0), seed=1)
    feat = torch.randn(2 if case == "batch2" else 1, 32, 64, 8,
                       generator=torch.Generator().manual_seed(2))
    pcd, img = feat[..., :5], feat[..., 5:8]
    card = lambda t, on=True: SimpleNamespace(is_cuda=on, shape=(1, *t.shape[1:]))
    with torch.inference_mode():
        assert model.graphable(card(pcd), card(img), None, False)

    generator = torch.Generator().manual_seed(3) if case == "generator" else None
    remat = case == "remat"
    if case == "train":
        model.train()
    grad = torch.enable_grad() if case == "grad" else torch.inference_mode()
    with grad:
        with monkeypatch.context() as m:
            if case == "split":
                m.setattr(spatial, "active", lambda: object())
            shown = (card(pcd, case != "cpu"), card(img, case != "cpu"))
            if case == "batch2":
                shown = (SimpleNamespace(is_cuda=True, shape=pcd.shape), shown[1])
            assert not model.graphable(*shown, generator, remat)
        got = model(pcd, img, generator, remat)
        want = composed(model, pcd, img, generator, remat)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.stride() == w.stride()
        assert torch.equal(g.detach(), w.detach())
    assert not model._graphs
    assert NETS[net].graph_captures == 0 and NETS[net].graph_replays == 0
