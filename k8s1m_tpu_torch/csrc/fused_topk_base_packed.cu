// Stage configuration WITH_AFF=false, WITH_CONS=false of the fused kernel
// (fused_topk.cuh) in the packed table layout, every K bucket; its own
// translation unit so the builds run in parallel.

#include "fused_topk.cuh"

namespace k8s {
template cudaError_t launch_layout<true, false, false>(const Args&, dim3, int, cudaStream_t,
                                                    int*);
}  // namespace k8s
