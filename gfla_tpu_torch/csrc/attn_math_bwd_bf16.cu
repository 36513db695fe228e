// The bf16 instance of the attention-math backward: attn_math_bwd.cu built
// with GFLA_ATTN_BF16 = 1 (its header says what changes), by an nvcc process
// of its own, beside the f32 one. Entry: gfla_attn_math_bwd_bf16.
#define GFLA_ATTN_BF16 1
#include "attn_math_bwd.cu"
