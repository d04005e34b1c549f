// Status codes of the kernel library. An entry point returns 0, a
// cudaError_t, or one of the codes below, which ising_error_string names.
#pragma once

// K1: cudaOccupancyMaxActiveClusters found no SM group that can hold one
// thread-block cluster of the requested size; nothing was launched.
constexpr int kStatusClusterUnschedulable = 100001;
// K1's banded variant: occupancy x SMs is below the CTAs of one cooperative
// launch, whose CTAs wait on each other; nothing was launched.
constexpr int kStatusNotCoResident = 100002;
