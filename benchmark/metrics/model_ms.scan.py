"""The host wall time of the net's forward at batch 1 (the span `pmf.model`: the host issuing the net's launches), a scan (`pmf.scan`), ms. Against `model_device_ms.scan`: above it, the net is bound by its launches."""
from benchmark import program_spans as ps


def read(t: dict):
    w = t["window"]
    return ps.per(w, ps.host_us(w, "pmf.model"), "pmf.scan")
