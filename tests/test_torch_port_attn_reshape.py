"""`local_attn_reshape` and its inverse against gfla_tpu's, on the CPU.

gfla_tpu/ops/attn_reshape.py turns per-position k^2 attention coefficients
(B, H, W, k^2) into k x k spatial tiles (B, k*H, k*W, 1) and back; the
port's gfla_tpu_torch/ops/attn_reshape.py does the same with torch's
reshape and permute. Pure layout: the results are bitwise equal, and the
inverse undoes the forward.
"""

import numpy as np
import pytest
import torch

from gfla_tpu.ops.attn_reshape import (
    local_attn_reshape as gfla_reshape,
    local_attn_reshape_inverse as gfla_inverse,
)
from gfla_tpu_torch.ops.attn_reshape import (
    local_attn_reshape,
    local_attn_reshape_inverse,
)


@pytest.mark.parametrize("k,shape", [(3, (2, 5, 7)), (4, (1, 6, 3)),
                                     (13, (2, 3, 2))])
def test_local_attn_reshape_matches_gfla_tpu(k, shape):
    x = np.random.RandomState(k).randn(*shape, k * k).astype(np.float32)
    tiles = local_attn_reshape(torch.from_numpy(x), k)
    want = np.asarray(gfla_reshape(x, k))
    assert tiles.shape == want.shape == (shape[0], k * shape[1],
                                         k * shape[2], 1)
    np.testing.assert_array_equal(tiles.numpy(), want)
    back = local_attn_reshape_inverse(tiles, k)
    np.testing.assert_array_equal(back.numpy(), np.asarray(gfla_inverse(
        want, k)))
    np.testing.assert_array_equal(back.numpy(), x)
    # channel i*k + j of position (y, x) is tile pixel (k*y + i, k*x + j)
    assert tiles[1 % shape[0], k + 1, k - 1, 0] == torch.from_numpy(x)[
        1 % shape[0], 1, 0, k + k - 1]


def test_local_attn_reshape_refuses_a_wrong_channel_count():
    with pytest.raises(ValueError, match="k\\^2"):
        local_attn_reshape(torch.zeros(1, 2, 2, 8), 3)
