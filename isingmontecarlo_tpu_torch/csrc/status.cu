// Names a status code that an entry point of the kernel library returned.

#include <cuda_runtime.h>

#include "status.cuh"

extern "C" const char* ising_error_string(int status) {
  if (status == kStatusClusterUnschedulable)
    return "the thread-block cluster cannot be scheduled on this device "
           "(cudaOccupancyMaxActiveClusters is 0)";
  if (status == kStatusNotCoResident)
    return "the cooperative grid exceeds the CTAs the device can hold at once "
           "(occupancy x SMs); nothing was launched";
  return cudaGetErrorString((cudaError_t)status);
}
