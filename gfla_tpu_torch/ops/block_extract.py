"""Flow-guided k x k block extraction in plain torch (NHWC).

Counterpart of gfla_tpu/ops/block_extract.py:40-72,155-217: every flow cell
(y, x) takes the k x k neighbourhood of `source` around (y + flow_y,
x + flow_x), each tap bilinear between edge-clamped integer reads. All k^2
offsets share the same fractional weights, so one (k+1) x (k+1) integer
footprint per cell feeds every offset. Taps clamp to the image edge, which is
why `grid_sample` (zero or border padding per sample point) is not used.
Flow is (B, H, W, 2) with channel 0 = x; `source` is at flow resolution.

Over row bands (the data x spatial mode, `gfla_tpu_torch.parallel.bands`)
the gather is gfla_tpu's `_patch_gather_halo` (block_extract.py:75-153):
each band takes h = min(halo, band rows) rows from each neighbour, counts
its positions from its first global row, clamps the taps to the image and
then to that window, so a flow with |flow_y| + k//2 > h freezes at the
window's edge, as gfla_tpu's does (`halo_block_extract`);
`extract_patches` pads the band's rows with its neighbours' (`edge_pad`).
`GFLA_HALO_DEBUG=1` prints a line where a flow leaves the window
(`halo_debug`).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from gfla_tpu_torch import parallel


def patch_index(flow, H: int, W: int, kernel_size: int, row0: int = 0,
                window=None):
    """Pixel index iy * W + ix of each edge-clamped (k+1)x(k+1) footprint tap
    of an H x W source, (B,Hf,Wf,k+1,k+1), and the fractional weights wy, wx
    (B,Hf,Wf) that all k^2 offsets share. The flow's rows are the source's
    rows from `row0`; with `window` = (first, rows) the taps clamp to the
    image, then to source rows first ... first + rows - 1, and count from
    `first` (the halo gather's window)."""
    k = kernel_size
    r = k // 2
    Hf, Wf = flow.shape[1:3]
    ys = torch.arange(row0, row0 + Hf, device=flow.device, dtype=flow.dtype)
    xs = torch.arange(Wf, device=flow.device, dtype=flow.dtype)
    dy = flow[..., 1] + ys[None, :, None]
    dx = flow[..., 0] + xs[None, None, :]
    fy = torch.floor(dy)
    fx = torch.floor(dx)
    offs = torch.arange(k + 1, device=flow.device) - r
    iy = (fy.long()[..., None] + offs).clamp(0, H - 1)      # (B,Hf,Wf,k+1)
    if window is not None:
        iy = (iy - window[0]).clamp(0, window[1] - 1)
    ix = (fx.long()[..., None] + offs).clamp(0, W - 1)
    return iy[..., :, None] * W + ix[..., None, :], dy - fy, dx - fx


def halo_rows(rows: int) -> int:
    """The rows a band of `rows` rows takes from each neighbour for the
    attention's gather: min(--halo, rows), as gfla_tpu's."""
    return min(parallel.bands().halo, rows)


def halo_debug(flow, kernel_size: int, h: int) -> None:
    """With GFLA_HALO_DEBUG=1 (gfla_tpu's switch, block_extract.py:107-121),
    one line where max|flow_y| + k//2 exceeds the halo h, so that a gather
    clamped at the window's edge shows; unset, nothing reads the flow."""
    if os.environ.get("GFLA_HALO_DEBUG", "0") != "1":
        return
    over = float(flow[..., 1].abs().max()) + kernel_size // 2 - h
    if over > 0:
        print(f"WARNING: halo-sharded gather clamped: max|flow_y|+k//2 "
              f"exceeds halo={h} by {over:.1f} rows (raise --halo)")


def _gather(source, flat, kernel_size: int):
    """The (k+1)x(k+1) footprints (B,Hf,Wf,k+1,k+1,C) of `source` at the
    pixel indices `flat` (patch_index's)."""
    B, H, W, C = source.shape
    k = kernel_size
    patch = torch.gather(source.reshape(B, H * W, C), 1,
                         flat.reshape(B, -1, 1).expand(-1, -1, C))
    return patch.reshape(B, *flat.shape[1:3], k + 1, k + 1, C)


def _blend(patch, wy, wx, kernel_size: int):
    """(B,H,W,k+1,k+1,C) footprints and their fractional weights ->
    (B,H,W,k*k,C) bilinear blocks."""
    k = kernel_size
    wy = wy[..., None, None, None]
    wx = wx[..., None, None, None]
    block = ((1.0 - wy) * (1.0 - wx) * patch[:, :, :, :k, :k]
             + (1.0 - wy) * wx * patch[:, :, :, :k, 1:]
             + wy * (1.0 - wx) * patch[:, :, :, 1:, :k]
             + wy * wx * patch[:, :, :, 1:, 1:])
    B, H, W = block.shape[:3]
    return block.reshape(B, H, W, k * k, -1)


def block_extract(source, flow, kernel_size: int):
    """(B,H,W,C) source, (B,H,W,2) flow -> (B,H,W,k*k,C) blocks; offset index
    i*k + j samples source at (y + flow_y + i - k//2, x + flow_x + j - k//2)."""
    H, W = source.shape[1:3]
    flat, wy, wx = patch_index(flow, H, W, kernel_size)
    return _blend(_gather(source, flat, kernel_size), wy, wx, kernel_size)


def halo_block_extract(source, flow, kernel_size: int):
    """`block_extract` on this rank's row band (gfla_tpu's
    `_patch_gather_halo`): the band's source with h = min(halo, band rows)
    rows from each neighbour, the taps clamped to the image and then to
    that window."""
    b = parallel.bands()
    k = kernel_size
    if source.shape[1:3] != flow.shape[1:3]:
        raise NotImplementedError(
            "block_extract over row bands takes source and flow at the same "
            f"resolution (gfla_tpu's halo gather), got {tuple(source.shape)} "
            f"and {tuple(flow.shape)}")
    H, W = source.shape[1:3]
    h = halo_rows(H)
    halo_debug(flow, k, h)
    r0 = b.first_row(H)
    flat, wy, wx = patch_index(flow, H * b.size, W, k, r0,
                               (r0 - h, H + 2 * h))
    window = parallel.pad_rows(source, h, h, "replicate", dim=1)
    return _blend(_gather(window, flat, k), wy, wx, k)


def edge_pad(x, kernel_size: int):
    """(B,C,H,W) edge-padded by r = k//2 before and k - 1 - r after, in
    rows and columns; over bands the rows come from the neighbouring
    bands, and the edge rows repeat at the image's top and bottom only."""
    k = kernel_size
    r = k // 2
    if parallel.bands() is None:
        return F.pad(x, (r, k - 1 - r, r, k - 1 - r), mode="replicate")
    x = F.pad(x, (r, k - 1 - r, 0, 0), mode="replicate")
    return parallel.pad_rows(x, r, k - 1 - r, "replicate")


def extract_patches(x, kernel_size: int):
    """Zero-flow blocks: edge-padded k x k patches by pad and shift, no gather.
    (B,H,W,C) -> (B,H,W,k*k,C)."""
    k = kernel_size
    B, H, W, C = x.shape
    xp = edge_pad(x.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)
    return torch.stack([xp[:, i:i + H, j:j + W, :]
                        for i in range(k) for j in range(k)], dim=3)
