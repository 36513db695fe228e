// The bf16 instances of the local-attention warp's forward kernel: warp_fwd.cu
// built with GFLA_WARP_BF16 = 1 (its header says what changes), by an nvcc
// process of its own, beside the f32 one. Entry: gfla_warp_fwd_bf16.
#define GFLA_WARP_BF16 1
#include "warp_fwd.cu"
