// Makes a CUDA device current for the guard's lifetime and restores the
// previous one after, as torch.cuda.device does around a call from Python.
// The C entries take the tensors' device index and open one of these, so the
// wrapper need not ask which device is current.
#pragma once
#include <cuda_runtime.h>

struct DeviceGuard {
  int previous = -1;  // the device to restore, -1 if none was changed
  int error;          // a cudaError_t; 0 when `device` is current

  explicit DeviceGuard(int device) {
    int current;
    error = (int)cudaGetDevice(&current);
    if (!error && current != device) {
      error = (int)cudaSetDevice(device);
      if (!error) previous = current;
    }
  }
  ~DeviceGuard() {
    if (previous >= 0) cudaSetDevice(previous);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};
