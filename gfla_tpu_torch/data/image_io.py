"""Image files of the port: JPEG decode and encode, and a PNG writer.

gfla_tpu reads and writes every image through PIL and imageio
(gfla_tpu/data/paired_dataset.py:79-83,97-101, tasks/testing.py:27-31,
utils/visualizer.py:83); the card's machine has no image library to run
them. So:
- on the card, `decode_jpeg_batch` and `encode_jpeg` go through nvJPEG
  (csrc/jpeg_nvjpeg.cpp, built at first use by ops/_build.py). The decode
  writes each image's component planes into tensors on the device, and the
  chroma upsampling and the YCbCr -> RGB conversion follow in torch with
  libjpeg's integer arithmetic (`ycc_to_rgb`), as PIL, the reference's
  decoder, runs them; only the inverse DCT is nvJPEG's own. It all runs on
  a stream of the decoder's own, which the caller's stream then waits for,
  so a batch decodes while the previous training step still runs (nvJPEG
  has to finish each image before it takes the next, see the source).
  It takes 4:4:4, 4:2:2 and 4:2:0 colour and grey, which is what cameras,
  PIL and DeepFashion and Market-1501 write, and raises on any other
  layout. The encoder reads a uint8 tensor on the device;
- on the CPU (`--gpu_ids=-1`, the tests) both use PIL, imported inside the
  function: the reference's own decoder, so the CPU path gives gfla_tpu's
  pixels exactly;
- `write_png` is the port's own writer on zlib and struct, for both, and
  `read_png` its reader: 8-bit grey, RGB and RGBA, not interlaced, every
  PNG row filter, the pixels PIL gives.
`read_images`, the metrics' reader, takes a JPEG to `decode_jpeg_batch`
and a PNG of those layouts to `read_png`, by the file's first bytes; any
other file (BMP, WEBP, the PNG layouts no head writes) goes to PIL,
imported in the function, the reader gfla_tpu's metrics use for all.
`decode_images` does the same from the files' bytes, also to PIL's grey
(the dance masks).
A JPEG that does not decode, or a missing nvJPEG, raises with the file's
name; nothing falls back to another decoder.
"""

from __future__ import annotations

import ctypes
import functools
import io
import os
import struct
import zlib
from typing import List, Optional, Sequence

import numpy as np
import torch

from gfla_tpu_torch.data.resample import convert_l

QUALITY = 75  # PIL's and imageio's JPEG default, with 4:2:0 chroma

# calls that went through nvJPEG, one per image; the CPU path counts nothing
nvjpeg_decodes = 0
nvjpeg_encodes = 0

_NVJPEG_STATUS = {
    1: "NOT_INITIALIZED", 2: "INVALID_PARAMETER", 3: "BAD_JPEG",
    4: "JPEG_NOT_SUPPORTED", 5: "ALLOCATOR_FAILURE", 6: "EXECUTION_FAILED",
    7: "ARCH_MISMATCH", 8: "INTERNAL_ERROR",
    9: "IMPLEMENTATION_NOT_SUPPORTED", 10: "INCOMPLETE_BITSTREAM",
}


_BAD_FILE = (3, 4, 10)  # BAD_JPEG, JPEG_NOT_SUPPORTED, INCOMPLETE_BITSTREAM


def _check(lib, status: int, what: str) -> None:
    """Raise for a non-zero status: ValueError for a file nvJPEG cannot
    read (as PIL's path raises), RuntimeError for anything else."""
    if status == 0:
        return
    if status >= 1000:
        reason = "CUDA " + lib.gfla_jpeg_cuda_error_string(
            status - 1000).decode()
    else:
        reason = "nvjpeg " + _NVJPEG_STATUS.get(status, f"status {status}")
    raise (ValueError if status in _BAD_FILE else RuntimeError)(
        f"{what}: {reason}")


@functools.cache
def _nvjpeg(device_index: int):
    """(library, context, constants, decode stream) for one card, made
    once; the constants map nvJPEG's enumerators: "YUV" and "Y" to output
    formats, "css" from a subsampling to its name."""
    from gfla_tpu_torch.ops._build import load_jpeg_library

    lib = load_jpeg_library()
    ctx = ctypes.c_void_p()
    with torch.cuda.device(device_index):
        _check(lib, lib.gfla_jpeg_create(ctypes.byref(ctx)),
               "nvJPEG: cannot create a decoder")
    values = (ctypes.c_int * 6)()
    lib.gfla_jpeg_constants(values)
    yuv, y, *css = list(values)
    return lib, ctx, {"YUV": yuv, "Y": y,
                      "css": dict(zip(css, ("444", "422", "420", "gray")))}, \
        torch.cuda.Stream(device_index)


def _as_bytes(data) -> np.ndarray:
    buf = np.frombuffer(data, np.uint8) if isinstance(data, bytes) else data
    if buf.dtype != np.uint8 or buf.ndim != 1:
        raise ValueError(f"want JPEG bytes as a 1-D uint8 array, got "
                         f"{buf.dtype} {buf.shape}")
    return np.ascontiguousarray(buf)


def _pil_decode(buf: np.ndarray, name: str) -> torch.Tensor:
    from PIL import Image

    try:
        with Image.open(io.BytesIO(buf.tobytes())) as img:
            return torch.from_numpy(np.array(img.convert("RGB")))
    except OSError as err:  # PIL's UnidentifiedImageError among them
        raise ValueError(f"cannot decode {name}: {err}") from err


def _replicate_shift(x: torch.Tensor, step: int, dim: int) -> torch.Tensor:
    """x moved by one along `dim` (step -1: each entry's left neighbour,
    +1: its right one), the edge entry repeated."""
    n = x.shape[dim]
    if step < 0:
        return torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    return torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)


def _fancy_h2(x: torch.Tensor, scale: int, even_round: int,
              odd_round: int) -> torch.Tensor:
    """libjpeg's triangular horizontal doubling (jdsample.c): output column
    2c is (3 x[c] + x[c-1] + even_round) >> scale and 2c+1 is
    (3 x[c] + x[c+1] + odd_round) >> scale, the edge sample repeated."""
    even = (3 * x + _replicate_shift(x, -1, -1) + even_round) >> scale
    odd = (3 * x + _replicate_shift(x, 1, -1) + odd_round) >> scale
    return torch.stack([even, odd], -1).flatten(-2)


def upsample_chroma(plane: torch.Tensor, subsampling: str) -> torch.Tensor:
    """(N, hc, wc) chroma samples -> libjpeg's fancy upsampling
    (h2v2_fancy_upsample / h2v1_fancy_upsample) as int32, (N, 2hc, 2wc) for
    "420", (N, hc, 2wc) for "422", as is for "444"."""
    x = plane.to(torch.int32)
    if subsampling == "444":
        return x
    if subsampling == "422":
        return _fancy_h2(x, 2, 1, 2)
    if subsampling != "420":
        raise ValueError(f"upsample_chroma: no upsampling for {subsampling}")
    upper = 3 * x + _replicate_shift(x, -1, -2)   # nearest row, row above
    lower = 3 * x + _replicate_shift(x, 1, -2)    # nearest row, row below
    rows = torch.stack([_fancy_h2(upper, 4, 8, 7), _fancy_h2(lower, 4, 8, 7)],
                       -2)
    return rows.flatten(-3, -2)


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor,
               cr: torch.Tensor) -> torch.Tensor:
    """Full-size Y, Cb, Cr samples (any integer type) -> uint8 (..., 3) RGB
    by libjpeg's fixed-point tables (jdcolor.c, 16 fraction bits)."""
    y = y.to(torch.int32)
    cb, cr = cb.to(torch.int32) - 128, cr.to(torch.int32) - 128
    r = y + ((_fix(1.40200) * cr + 32768) >> 16)
    g = y + ((-_fix(0.34414) * cb + 32768 - _fix(0.71414) * cr) >> 16)
    b = y + ((_fix(1.77200) * cb + 32768) >> 16)
    return torch.stack([r, g, b], -1).clamp_(0, 255).to(torch.uint8)


def decode_jpeg_batch(datas: Sequence, device,
                      names: Optional[Sequence[str]] = None
                      ) -> List[torch.Tensor]:
    """JPEG files' bytes (uint8 arrays or bytes) -> a list of uint8
    (H0, W0, 3) RGB tensors on `device`: nvJPEG on a CUDA device, PIL on
    the CPU. `names` label the errors."""
    device = torch.device(device)
    names = list(names) if names is not None else [
        f"image {i}" for i in range(len(datas))]
    bufs = [_as_bytes(d) for d in datas]
    if device.type == "cpu":
        return [_pil_decode(b, n) for b, n in zip(bufs, names)]
    if device.type != "cuda":
        raise ValueError(f"decode_jpeg_batch: no decoder for {device}")
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _nvjpeg_decode(bufs, names, index)


def _nvjpeg_decode(bufs, names, index: int) -> List[torch.Tensor]:
    """The images on the decoder's stream; the caller's stream waits for
    them."""
    lib, ctx, const, side = _nvjpeg(index)
    current = torch.cuda.current_stream(index)
    with torch.cuda.stream(side):
        out = _decode_planes(lib, ctx, const, side, bufs, names, index)
    current.wait_stream(side)
    for img in out:
        img.record_stream(current)
    return out


def _decode_planes(lib, ctx, const, side, bufs, names,
                   index: int) -> List[torch.Tensor]:
    """Each image's planes by nvJPEG, then one upsampling and conversion
    for each group of images that share their plane sizes, all on `side`,
    the current stream."""
    global nvjpeg_decodes
    stream = side.cuda_stream
    dev = torch.device("cuda", index)
    comps, css = ctypes.c_int(), ctypes.c_int()
    heights, widths = (ctypes.c_int * 4)(), (ctypes.c_int * 4)()
    out: List[Optional[torch.Tensor]] = [None] * len(bufs)
    groups = {}
    for i, (buf, name) in enumerate(zip(bufs, names)):
        ptr = buf.ctypes.data_as(ctypes.c_void_p)
        _check(lib, lib.gfla_jpeg_info(ctx, ptr, buf.size, ctypes.byref(comps),
                                       ctypes.byref(css), heights, widths),
               f"nvJPEG cannot read the header of {name}")
        sub = const["css"].get(css.value)
        n = 1 if sub == "gray" else 3
        if sub is None or comps.value != n:
            raise ValueError(f"{name}: {comps.value} components with nvJPEG "
                             f"subsampling {css.value}; the decoder takes "
                             "4:4:4, 4:2:2 or 4:2:0 colour, or grey")
        planes = [torch.empty((heights[c], widths[c]), dtype=torch.uint8,
                              device=dev) for c in range(n)]
        ptrs = [t.data_ptr() for t in planes] + [None] * (3 - n)
        pitches = [widths[c] for c in range(n)] + [0] * (3 - n)
        fmt = const["Y"] if sub == "gray" else const["YUV"]
        _check(lib, lib.gfla_jpeg_decode(ctx, ptr, buf.size, fmt, *ptrs,
                                         *pitches, stream),
               f"nvJPEG cannot decode {name}")
        nvjpeg_decodes += 1
        shape = (sub, *(tuple(t.shape) for t in planes))
        groups.setdefault(shape, []).append((i, planes))
    for (sub, *_), members in groups.items():
        y = torch.stack([planes[0] for _, planes in members])
        if sub == "gray":
            rgb = y[..., None].expand(-1, -1, -1, 3)
        else:
            H, W = y.shape[1:]
            cb, cr = (upsample_chroma(torch.stack(
                [planes[c] for _, planes in members]), sub)[:, :H, :W]
                for c in (1, 2))
            rgb = ycc_to_rgb(y, cb, cr)
        for (i, _), img in zip(members, rgb.unbind(0)):
            out[i] = img.contiguous()
    return out


def encode_jpeg(image: torch.Tensor, quality: int = QUALITY) -> bytes:
    """uint8 (H, W, 3) RGB -> JPEG bytes at `quality`, 4:2:0 chroma: nvJPEG
    for a CUDA tensor, PIL for a CPU one (or a numpy array)."""
    global nvjpeg_encodes
    if isinstance(image, np.ndarray):
        image = torch.from_numpy(image)
    if image.dtype != torch.uint8 or image.dim() != 3 or image.shape[2] != 3:
        raise ValueError(f"encode_jpeg: want uint8 (H, W, 3), got "
                         f"{image.dtype} {tuple(image.shape)}")
    if image.device.type == "cpu":
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(image.numpy()).save(buf, format="JPEG",
                                            quality=quality)
        return buf.getvalue()
    if image.device.type != "cuda":
        raise ValueError(f"encode_jpeg: no encoder for {image.device}")
    image = image.contiguous()
    index = image.device.index
    lib, ctx, _, _ = _nvjpeg(index)
    stream = torch.cuda.current_stream(index).cuda_stream
    length = ctypes.c_size_t()
    H, W, _ = image.shape
    _check(lib, lib.gfla_jpeg_encode(ctx, image.data_ptr(), H, W, quality,
                                     stream, ctypes.byref(length)),
           f"nvJPEG cannot encode a {H}x{W} image")
    out = (ctypes.c_ubyte * length.value)()
    _check(lib, lib.gfla_jpeg_encode_fetch(ctx, out, ctypes.byref(length),
                                           stream),
           "nvJPEG cannot fetch the encoded image")
    nvjpeg_encodes += 1
    return bytes(out)[:length.value]


def write_jpeg(path: str, image: torch.Tensor,
               quality: int = QUALITY) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_jpeg(image, quality))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, array) -> None:
    """uint8 (H, W, 3), (H, W, 1) or (H, W) -> an 8-bit RGB or grey PNG
    (filter 0 on every row, zlib level 6)."""
    arr = np.asarray(array.cpu() if isinstance(array, torch.Tensor)
                     else array)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (
            arr.ndim == 3 and arr.shape[2] != 3):
        raise ValueError(f"write_png: want uint8 (H, W[, 3]), got "
                         f"{arr.dtype} {arr.shape}")
    H, W = arr.shape[:2]
    colour = 2 if arr.ndim == 3 else 0
    rows = np.ascontiguousarray(arr).reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1)
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, colour, 0, 0,
                                         0))
           + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
           + _chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


# start-of-frame markers: SOF0-SOF15 but DHT, JPG and DAC
_SOF = set(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def jpeg_size(data) -> tuple:
    """(height, width) of a JPEG from its start-of-frame segment, read
    without decoding (the size PIL's `Image.open(...).size` gives)."""
    return _jpeg_frame(data)[:2]


def _jpeg_frame(data) -> tuple:
    """(height, width, components) from a JPEG's start-of-frame segment."""
    buf = _as_bytes(data)
    if buf.size < 4 or buf[0] != 0xFF or buf[1] != 0xD8:
        raise ValueError("jpeg_size: not a JPEG (no SOI marker)")
    i = 2
    while i + 3 < buf.size:
        if buf[i] != 0xFF:
            raise ValueError(f"jpeg_size: no marker at byte {i}")
        marker = int(buf[i + 1])
        if marker == 0xFF:  # fill byte
            i += 1
            continue
        if marker in (0x01, *range(0xD0, 0xD8)):  # no length
            i += 2
            continue
        length = (int(buf[i + 2]) << 8) | int(buf[i + 3])
        if marker in _SOF:
            if i + 9 >= buf.size:
                break
            return ((int(buf[i + 5]) << 8) | int(buf[i + 6]),
                    (int(buf[i + 7]) << 8) | int(buf[i + 8]), int(buf[i + 9]))
        i += 2 + length
    raise ValueError("jpeg_size: no start-of-frame segment")


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> channels: grey, RGB, RGBA


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, H: int, stride: int, bpp: int) -> np.ndarray:
    """The PNG row filters undone: raw is (H, 1 + stride) filter bytes and
    filtered rows; returns uint8 (H, stride). None and Sub and Up are numpy
    on the whole row; Average and Paeth depend on the byte just decoded to
    the left, so they walk the row."""
    out = np.zeros((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        kind, row = int(raw[y, 0]), raw[y, 1:]
        if kind == 0:
            cur = row.copy()
        elif kind == 1:
            cur = np.cumsum(row.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = row + prev
        elif kind in (3, 4):
            r, up, cur_l = row.tolist(), prev.tolist(), [0] * stride
            for i in range(stride):
                left = cur_l[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur_l[i] = (r[i] + pred) & 0xFF
            cur = np.asarray(cur_l, np.uint8)
        else:
            raise ValueError(f"read_png: row {y} has filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(data) -> Optional[np.ndarray]:
    """PNG bytes -> uint8 (H, W), (H, W, 3) or (H, W, 4) as stored, for an
    8-bit grey, RGB or RGBA image that is not interlaced; None for any other
    PNG layout (palette, 16-bit, grey with alpha, interlaced). Raises
    ValueError for bytes that are not a well-formed PNG."""
    buf = bytes(data)
    if not buf.startswith(PNG_SIGNATURE):
        raise ValueError("read_png: no PNG signature")
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while pos + 8 <= len(buf):
        length, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        body = buf[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"read_png: {kind!r} chunk cut short")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError("read_png: no IHDR or no IDAT chunk")
    W, H, depth, colour, compression, filtering, interlace = header
    n = _PNG_CHANNELS.get(colour)
    if depth != 8 or n is None or interlace != 0:
        return None
    if compression != 0 or filtering != 0:
        raise ValueError(f"read_png: compression {compression}, filter "
                         f"method {filtering}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * n):
        raise ValueError(f"read_png: {raw.size} bytes of image data for a "
                         f"{W}x{H}x{n} image")
    img = _unfilter(raw.reshape(H, 1 + W * n), H, W * n, n).reshape(H, W, n)
    return img[..., 0] if n == 1 else img


def _pil_read(path, mode: str) -> np.ndarray:
    """A file (a path or a file object) of a layout no head writes, through
    PIL: `convert(mode)` for mode "RGB" or "L", and for "stored" the
    channels imageio's reader gives (a palette image in its palette's
    mode)."""
    from PIL import Image

    with Image.open(path) as img:
        if mode in ("RGB", "L"):
            img = img.convert(mode)
        elif img.mode == "P":
            img = img.convert(img.palette.mode)
        return np.array(img)


def _as_rgb(arr: np.ndarray) -> np.ndarray:
    """PIL's convert("RGB") of a stored grey, RGB or RGBA array: grey
    repeated, alpha dropped."""
    if arr.ndim == 2:
        return np.repeat(arr[..., None], 3, axis=2)
    return arr[..., :3]


def read_images(paths: Sequence[str], device,
                mode: str = "RGB") -> List[torch.Tensor]:
    """Image files -> uint8 tensors on `device`, in order, as
    `decode_images` gives them from the files' bytes."""
    datas = []
    for path in paths:
        with open(path, "rb") as f:
            datas.append(np.frombuffer(f.read(), np.uint8))
    return decode_images(datas, paths, device, mode)


def decode_images(datas, names: Sequence[str], device,
                  mode: str = "RGB") -> List[torch.Tensor]:
    """Image files' bytes (uint8 arrays) -> uint8 tensors on `device`, in
    order: with mode "RGB" each is (H, W, 3), as PIL's
    `Image.open(f).convert("RGB")` gives (gfla_tpu's FID and LPIPS
    readers); with "L", (H, W), as `convert("L")` gives (the dance masks);
    with "stored", (H, W) for a grey image and (H, W, 4) for RGBA, as
    `imageio.imread` gives (its reconstruction metrics). The JPEGs decode
    in one `decode_jpeg_batch` (nvJPEG on the card, PIL on the CPU); the
    PNGs through `read_png`; "L" then takes PIL's grey conversion
    (`convert_l`, the identity on grey). `names` label the errors."""
    if mode not in ("RGB", "L", "stored"):
        raise ValueError(f"decode_images: mode {mode!r}, want 'RGB', 'L' "
                         "or 'stored'")
    device = torch.device(device)
    out: List[Optional[torch.Tensor]] = [None] * len(datas)
    jpegs = []
    for i, data in enumerate(datas):
        if bytes(data[:2]) == b"\xff\xd8":
            jpegs.append(i)
            continue
        arr = read_png(data) if bytes(data[:8]) == PNG_SIGNATURE else None
        if arr is None:
            arr = _pil_read(io.BytesIO(bytes(data)), mode)
        elif mode == "RGB":
            arr = _as_rgb(arr)
        img = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
        if mode == "L" and img.dim() == 3:
            img = convert_l(img[..., :3])
        out[i] = img
    if jpegs:
        decoded = decode_jpeg_batch([datas[i] for i in jpegs], device,
                                    [names[i] for i in jpegs])
        for i, img in zip(jpegs, decoded):
            if mode == "L":
                img = convert_l(img)
            elif mode == "stored" and _jpeg_frame(datas[i])[2] == 1:
                img = img[..., 0].contiguous()  # grey, as stored
            out[i] = img
    return out
