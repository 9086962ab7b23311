// The star's instantiations of the replica race kernel (replica_race.cuh;
// rejfree_replica.cu holds the ring's and the C entry points), compiled
// apart so that nvcc builds the two halves in parallel.
#include "replica_race.cuh"

namespace rrrmc {
namespace replica {
template Kern kernel_of<true>(int, int, int);
}  // namespace replica
}  // namespace rrrmc
