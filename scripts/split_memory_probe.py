"""Where the peak device memory of PMF-ResNet34's nuScenes eval forward
(chip_smoke.py phase 12(a): batch 4, 896x1600, random weights) goes, in
float32 (TF32 off) and bf16, unsplit and on rank 0 of a 2-rank row split
(two processes sharing the card over gloo).

For every conv, other leaf module, upsample and stem pool the script
records the memory live when the call starts and the most it allocates
above that before it returns (its output, a fetched block of rows under the
split, cuDNN's workspace), and prints the calls where live + transient is
largest: the forward's peak is the first of them.

    python scripts/split_memory_probe.py        # on one NVIDIA card
"""
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

TOP = 6


def leaf_peaks(model, run) -> tuple[float, list]:
    """(the peak of `run()` in GiB, the TOP calls by live + transient GiB,
    with the input's shape). The calls measured: every conv (also those
    that conv_bn runs with the BN folded in), every other leaf module, the
    bilinear upsample and the stem's max pool."""
    from pmf_tpu_torch.models import layers, pmf, resnet

    seen = []

    def measured(name, x, fn, *args):
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args)
        torch.cuda.synchronize()
        seen.append(((torch.cuda.max_memory_allocated() - live) / 2 ** 30, live / 2 ** 30, name,
                     tuple(x.shape)))
        return out

    names = {id(m): n for n, m in model.named_modules()}
    conv, up, pool = layers.Conv2d._conv_forward, pmf.upsample_bilinear, resnet.max_pool_3x3_s2
    layers.Conv2d._conv_forward = lambda self, x, w, b: measured(names[id(self)], x, conv, self,
                                                                 x, w, b)
    pmf.upsample_bilinear = lambda x, *a: measured("upsample_bilinear", x, up, x, *a)
    resnet.max_pool_3x3_s2 = lambda x: measured("max_pool_3x3_s2", x, pool, x)
    hooks = []
    for name, m in model.named_modules():
        if not list(m.children()) and not isinstance(m, layers.Conv2d):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, inp: setattr(mod, "_probe", (torch.cuda.memory_allocated(),
                                                          torch.cuda.reset_peak_memory_stats()))))
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, name=name: seen.append((
                    (torch.cuda.max_memory_allocated() - mod._probe[0]) / 2 ** 30,
                    mod._probe[0] / 2 ** 30, name, tuple(inp[0].shape)))))
    try:
        run()
    finally:
        layers.Conv2d._conv_forward, pmf.upsample_bilinear, resnet.max_pool_3x3_s2 = conv, up, pool
        for h in hooks:
            h.remove()
    top = sorted(seen, key=lambda s: s[0] + s[1], reverse=True)[:TOP]
    return max(s[0] + s[1] for s in seen), top


def probe(rank: int, join, device: str = "cuda") -> dict:
    """The unsplit forward's leaf peaks on rank 0 alone, then the split
    forward's on both ranks."""
    import numpy as np

    from pmf_tpu_torch.data.synthetic import make_nuscenes_inputs
    from pmf_tpu_torch.utils import disable_tf32

    disable_tf32()
    dev = torch.device(device)
    raw = make_nuscenes_inputs(np.random.default_rng(21), 1, cs.NN, 34720, cs.NCH, cs.NCW)
    out = {}
    for mesh in ([None] if rank == 0 else []) + ["split"]:
        if mesh == "split":
            mesh = join()
        f, _, _ = cs.split_view(dev, raw, train=False)
        model = cs.nusc_model("PMFNet", dev)
        for dtype in (torch.float32, torch.bfloat16):
            model.dtype = dtype
            cs.split_eval(model, f, mesh, gather=False)
            out["split" if mesh else "unsplit", str(dtype)[6:]] = leaf_peaks(
                model, lambda: cs.split_eval(model, f, mesh, gather=False))
        del model, f
        torch.cuda.empty_cache()
    return out


def main():
    from pmf_tpu_torch.parallel import dryrun

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi)
    ranks = dryrun.Grid(2, 2, probe, (), timeout_s=600.0).results()
    for (where, dtype), (peak, top) in sorted(ranks[0].items()):
        print(f"{where} {dtype} (rank 0): peak {peak:.2f} GiB on {smi}; live + transient by "
              "leaf module:")
        for transient, live, name, shape in top:
            print(f"  {live + transient:7.2f} GiB = live {live:6.2f} + transient "
                  f"{transient:6.2f}  {name} input {list(shape)}")


if __name__ == "__main__":
    main()
