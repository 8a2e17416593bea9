// Stage configuration WITH_AFF=false, WITH_CONS=false of the fused kernel
// (fused_topk.cuh), every layout and K bucket; its own translation unit so
// the stage builds run in parallel.

#include "fused_topk.cuh"

namespace k8s {
template cudaError_t launch_stage<false, false>(const Args&, bool, int, int, cudaStream_t,
                                                  int*);
}  // namespace k8s
