"""`pmf_losses`' mean time a step (CUDA events), ms."""


def read(t: dict):
    return t["spans"].get("loss")
