// The bf16 instances of the local-attention warp's two backward kernels:
// warp_bwd.cu built with GFLA_WARP_BF16 = 1 (its header says what changes),
// by an nvcc process of its own, beside the f32 one. Entries:
// gfla_warp_bwd_pos_bf16, gfla_warp_bwd_w1_bf16.
#define GFLA_WARP_BF16 1
#include "warp_bwd.cu"
