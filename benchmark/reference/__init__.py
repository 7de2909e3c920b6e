"""The benchmark's frozen plain reference: PMF's and EPMF's views, nets,
losses and optimizer in plain PyTorch, float32 with TF32 off.

It is a copy of the port's plain code as it stood when the benchmark was
defined, with the row split, remat and process-group hooks taken out, and
it imports nothing of the port: a later change to the port cannot move the
yardstick it is judged by. `nets.set_fp8` holds every convolution's
input, weight and output and every BN output in float8 (e4m3; gradients
e5m2), which makes it the benchmark's control.
"""
