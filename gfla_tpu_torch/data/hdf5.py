"""A read-only reader of the HDF5 files that h5py writes by default, in numpy
and the standard library's zlib (the ShapeNet store, data/shapenet_data.py;
gfla_tpu reads it with h5py, which the port does not need).

What it reads (HDF5 File Format Specification, version 3.0):
- superblock versions 0 and 1 (h5py's default, libver "earliest");
- symbol-table ("old-style") groups: the group B-tree version 1 (node
  type 0) at any depth, its symbol-table nodes and the group's local heap.
  A name is found by a search down the B-tree on its sorted name keys,
  reading only the nodes on the way: a store of one group per view (the
  original car store holds hundreds of thousands) is never listed;
- version-1 object headers and their continuation blocks;
- the dataspace, datatype (fixed-point and IEEE float of 1 to 8 bytes, either
  byte order), data layout (compact, contiguous, and chunked through a
  B-tree version 1 of node type 1) and filter-pipeline messages;
- the deflate (gzip) and shuffle filters.

Anything else raises `UnsupportedHDF5`, naming what it met: a new-style
group (link messages, a fractal heap, a version-2 B-tree: libver "latest"
or a creation-ordered group), a version-2 object header, another filter
(lzf, szip, ...), virtual or external storage, a datatype it does not
decode. Nothing falls back to h5py.

The file is read with positioned reads (`os.pread`) on a descriptor that
the `File` opens, so that the loader's workers, each with a `File` of its
own, share no file position. A `File` does not pickle: open one in each
process (the dataset opens it lazily and drops it when pickled).

    with File(path) as f:
        image = f["obj0_0_0"]["image"][()]   # numpy, the stored dtype
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = (1 << 64) - 1

# message types (specification IV.A.2)
MSG_DATASPACE, MSG_LINK_INFO, MSG_DATATYPE = 0x1, 0x2, 0x3
MSG_LINK, MSG_EXTERNAL, MSG_LAYOUT, MSG_GROUP_INFO = 0x6, 0x7, 0x8, 0xA
MSG_FILTERS, MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0xB, 0x10, 0x11
NEW_STYLE = {MSG_LINK_INFO, MSG_LINK, MSG_GROUP_INFO}  # a new-style group

SHARED_UNREAD = {MSG_DATASPACE: "dataspace", MSG_DATATYPE: "datatype",
                 MSG_FILTERS: "filter pipeline"}

FILTER_DEFLATE, FILTER_SHUFFLE = 1, 2
FILTER_NAMES = {3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset",
                32000: "lzf", 32001: "blosc", 32004: "lz4",
                32008: "bitshuffle", 32015: "zstd"}


class UnsupportedHDF5(ValueError):
    """A structure of the file that this reader does not read."""


class File:
    """An HDF5 file opened for reading; `f[name]` is its root group's member
    (a `Group` or a `Dataset`), `KeyError` if there is none."""

    def __init__(self, path: str):
        self.path = str(path)
        self._fd = os.open(self.path, os.O_RDONLY)
        try:
            self._read_superblock()
        except BaseException:
            self.close()
            raise
        self._heaps: Dict[int, int] = {}
        self.root = Group(self, "/", self._root_header)

    # --- bytes ----------------------------------------------------------
    def _read(self, address: int, size: int) -> bytes:
        """`size` bytes at `address` (relative to the base address)."""
        data = os.pread(self._fd, size, self._base + address)
        if len(data) != size:
            raise UnsupportedHDF5(
                f"{self.path}: {size} bytes at {address} run past the end "
                f"of the file (truncated?)")
        return data

    def _uint(self, data: bytes, at: int, size: int) -> int:
        return int.from_bytes(data[at:at + size], "little")

    def _read_superblock(self) -> None:
        self._base = 0
        for at in (0, 512, 1024, 2048, 4096, 8192, 16384):
            head = os.pread(self._fd, 9, at)
            if head[:8] == SIGNATURE:
                break
        else:
            raise UnsupportedHDF5(f"{self.path}: no HDF5 signature")
        version = head[8]
        sb = os.pread(self._fd, 128, at)
        if version in (2, 3):  # libver="latest": read as far as the root
            self._o, self._l = sb[9], sb[10]
            o = self._o
            self._base = self._uint(sb, 12, o)
            self._root_header = self._uint(sb, 12 + 3 * o, o)
            return
        if version not in (0, 1):
            raise UnsupportedHDF5(f"{self.path}: superblock version "
                                  f"{version}")
        self._o, self._l = sb[13], sb[14]
        if self._o not in (2, 4, 8) or self._l not in (2, 4, 8):
            raise UnsupportedHDF5(f"{self.path}: offsets of {self._o} and "
                                  f"lengths of {self._l} bytes")
        pos = 24 + (4 if version == 1 else 0)
        o = self._o
        self._base = self._uint(sb, pos, o)  # absolute; 0 or the userblock
        pos += 4 * o  # base, free space, end of file, driver info
        # the root group's symbol table entry: name offset, header address
        self._root_header = self._uint(sb, pos + o, o)

    def close(self) -> None:
        if getattr(self, "_fd", None) is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()

    def __getstate__(self):
        raise TypeError("an open HDF5 File does not pickle; open one in "
                        "each process")

    def __getitem__(self, name: str):
        return self.root[name]

    # --- object headers -------------------------------------------------
    def _messages(self, address: int) -> List[Tuple[int, bytes]]:
        """(type, body) of every message of the object header at `address`,
        its continuation blocks followed: a version-1 header, or a
        version-2 one (libver="latest"), whose messages are read only so
        that what they hold can be named and refused."""
        prefix = self._read(address, 16)
        if prefix[:4] == b"OHDR":
            return self._messages_v2(address)
        if prefix[0] != 1:
            raise UnsupportedHDF5(f"{self.path}: object header version "
                                  f"{prefix[0]} at {address}")
        count = self._uint(prefix, 2, 2)
        blocks = [(address + 16, self._uint(prefix, 8, 4))]
        out = []
        while blocks and len(out) < count:
            start, size = blocks.pop(0)
            data = self._read(start, size)
            pos = 0
            while pos + 8 <= size and len(out) < count:
                kind = self._uint(data, pos, 2)
                length = self._uint(data, pos + 2, 2)
                body = data[pos + 8:pos + 8 + length]
                if data[pos + 4] & 0x2 and kind in SHARED_UNREAD:
                    raise UnsupportedHDF5(
                        f"{self.path}: a shared {SHARED_UNREAD[kind]} "
                        f"message (a committed type) at {address}")
                pos += 8 + length
                if kind == MSG_CONTINUATION:
                    blocks.append((self._uint(body, 0, self._o),
                                   self._uint(body, self._o, self._l)))
                out.append((kind, body))
        return out

    def _messages_v2(self, address: int) -> List[Tuple[int, bytes]]:
        head = self._read(address, 6)
        flags = head[5]
        pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        size = self._uint(self._read(address + pos, width), 0, width)
        blocks = [(address + pos + width, size - 4)]  # less the checksum
        out = []
        while blocks:
            start, size = blocks.pop(0)
            data = self._read(start, size)
            at = 0
            while at + 4 <= size:
                kind, length = data[at], self._uint(data, at + 1, 2)
                at += 4 + (2 if data[at + 3] & 0x4 else 0)
                body = data[at:at + length]
                at += length
                if kind == MSG_CONTINUATION:
                    block = self._uint(body, 0, self._o)
                    blocks.append((block + 4,  # past "OCHK"
                                   self._uint(body, self._o, self._l) - 8))
                out.append((kind, body))
        return out

    # --- the group B-tree -------------------------------------------------
    def _heap_data(self, heap: int) -> int:
        """The address of the local heap's data segment."""
        if heap not in self._heaps:
            head = self._read(heap, 8 + 2 * self._l + self._o)
            if head[:4] != b"HEAP":
                raise UnsupportedHDF5(f"{self.path}: no local heap at {heap}")
            self._heaps[heap] = self._uint(head, 8 + 2 * self._l, self._o)
        return self._heaps[heap]

    def _name(self, heap: int, offset: int) -> bytes:
        """The NUL-terminated name at `offset` of the local heap."""
        start = self._heap_data(heap) + offset
        name = b""
        while True:
            chunk = os.pread(self._fd, 256, self._base + start + len(name))
            if not chunk:
                raise UnsupportedHDF5(f"{self.path}: a name at heap offset "
                                      f"{offset} runs past the file")
            end = chunk.find(b"\0")
            if end >= 0:
                return name + chunk[:end]
            name += chunk

    def _node(self, address: int, node_type: int, key_size: int):
        """(level, keys, children) of a version-1 B-tree node."""
        o = self._o
        head = self._read(address, 8 + 2 * o)
        if head[:4] != b"TREE":
            raise UnsupportedHDF5(f"{self.path}: no B-tree node at "
                                  f"{address}")
        if head[4] != node_type:
            raise UnsupportedHDF5(f"{self.path}: a B-tree of node type "
                                  f"{head[4]} where {node_type} belongs")
        level, used = head[5], self._uint(head, 6, 2)
        body = self._read(address + 8 + 2 * o,
                          used * (key_size + o) + key_size)
        step = key_size + o
        keys = [body[i * step:i * step + key_size] for i in range(used + 1)]
        children = [self._uint(body, i * step + key_size, o)
                    for i in range(used)]
        return level, keys, children

    def _lookup(self, btree: int, heap: int, name: bytes) -> Optional[int]:
        """The object header address of `name` in the old-style group of
        the B-tree `btree` and local heap `heap`, or None: each node's key
        i + 1 is the greatest name under its child i, so the search takes
        the first child whose key is not less than `name`."""
        address = btree
        while True:
            level, keys, children = self._node(address, 0, self._l)
            names = [None] * len(keys)

            def key(i):
                if names[i] is None:
                    names[i] = self._name(heap, self._uint(keys[i], 0,
                                                           self._l))
                return names[i]

            lo, hi = 0, len(children)
            while lo < hi:  # the first child i with name <= key(i + 1)
                mid = (lo + hi) // 2
                if key(mid + 1) < name:
                    lo = mid + 1
                else:
                    hi = mid
            if lo == len(children):
                return None
            if level == 0:
                return self._symbol(children[lo], heap, name)
            address = children[lo]

    def _symbol(self, address: int, heap: int, name: bytes) -> Optional[int]:
        """`name`'s object header address in a symbol-table node, by a
        binary search of its sorted entries."""
        o = self._o
        head = self._read(address, 8)
        if head[:4] != b"SNOD":
            raise UnsupportedHDF5(f"{self.path}: no symbol-table node at "
                                  f"{address}")
        used = self._uint(head, 6, 2)
        size = 2 * o + 24
        entries = self._read(address + 8, used * size)
        lo, hi = 0, used
        while lo < hi:
            mid = (lo + hi) // 2
            entry = entries[mid * size:(mid + 1) * size]
            here = self._name(heap, self._uint(entry, 0, o))
            if here == name:
                return self._uint(entry, o, o)
            if here < name:
                lo = mid + 1
            else:
                hi = mid
        return None


class Group:
    """An old-style group: `group[name]` is its member, a Group or a
    Dataset; `KeyError` when it has none of that name."""

    def __init__(self, file: File, name: str, header: int):
        self.file, self.name = file, name
        messages = file._messages(header)
        table = [body for kind, body in messages if kind == MSG_SYMBOL_TABLE]
        if not table:
            info = [body for kind, body in messages if kind == MSG_LINK_INFO]
            o = file._o
            # the link info message: version, flags, [max creation index],
            # then the fractal heap's address, undefined if links are compact
            heap = info and file._uint(info[0], 2 + (8 if info[0][1] & 1
                                                     else 0), o)
            dense = heap and heap != (1 << 8 * o) - 1
            links = ("dense: its links in a fractal heap indexed by a "
                     "version-2 B-tree" if dense
                     else "compact: its links in link messages")
            raise UnsupportedHDF5(
                f"{file.path}: {name} is a new-style group ({links}, as "
                f"libver='latest' or track_order=True write it); this "
                f"reader takes symbol-table groups, h5py's default")
        o = file._o
        self._btree = file._uint(table[0], 0, o)
        self._heap = file._uint(table[0], o, o)

    def _child(self, part: str) -> Optional[int]:
        return self.file._lookup(self._btree, self._heap,
                                 part.encode("utf-8"))

    def __getitem__(self, name: str):
        node: object = self
        path = self.name.rstrip("/")
        for part in (p for p in name.split("/") if p):
            if not isinstance(node, Group):
                raise KeyError(f"{path} is a dataset, not a group")
            header = node._child(part)
            path = f"{path}/{part}"
            if header is None:
                raise KeyError(f"Unable to open object (object '{part}' "
                               f"doesn't exist in {node.name})")
            node = _open(self.file, path, header)
        return node


def _open(file: File, path: str, header: int):
    """The Group or Dataset whose object header is at `header`."""
    messages = file._messages(header)
    kinds = {kind for kind, _ in messages}
    if MSG_LAYOUT in kinds:
        return Dataset(file, path, messages)
    if kinds & ({MSG_SYMBOL_TABLE} | NEW_STYLE):
        return Group(file, path, header)
    raise UnsupportedHDF5(f"{file.path}: {path} is neither a group nor a "
                          f"dataset (a named datatype?)")


def _dtype(body: bytes, path: str) -> np.dtype:
    """The numpy dtype of a datatype message: fixed-point or IEEE float."""
    cls, version = body[0] & 0x0F, body[0] >> 4
    bits = int.from_bytes(body[1:4], "little")
    size = int.from_bytes(body[4:8], "little")
    order = ">" if bits & 1 else "<"
    if cls == 0 and size in (1, 2, 4, 8):
        offset, precision = struct.unpack_from("<HH", body, 8)
        if offset == 0 and precision == 8 * size:
            return np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}")
    if cls == 1 and size in (2, 4, 8) and not bits & 0x40:
        offset, precision = struct.unpack_from("<HH", body, 8)
        if offset == 0 and precision == 8 * size:
            return np.dtype(f"{order}f{size}")
    names = {0: "fixed-point", 1: "floating-point", 2: "time", 3: "string",
             4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
             8: "enumerated", 9: "variable-length", 10: "array"}
    raise UnsupportedHDF5(
        f"{path}: a {size}-byte {names.get(cls, f'class-{cls}')} datatype "
        f"(version {version}, bits {bits:#x}) is not decoded; this reader "
        f"takes whole-byte integers and IEEE floats")


class Dataset:
    """A dataset: `dataset[()]` is its array, in the stored dtype and
    shape."""

    def __init__(self, file: File, path: str, messages):
        self.file, self.name = file, path
        self.shape: Tuple[int, ...] = ()
        self._filters: List[Tuple[int, Tuple[int, ...]]] = []
        dtype = layout = None
        for kind, body in messages:
            if kind == MSG_DATASPACE:
                self.shape = self._dataspace(body)
            elif kind == MSG_DATATYPE:
                dtype = _dtype(body, path)
            elif kind == MSG_LAYOUT:
                layout = body
            elif kind == MSG_FILTERS:
                self._filters = self._pipeline(body)
            elif kind == MSG_EXTERNAL:
                raise UnsupportedHDF5(f"{path}: external storage (its data "
                                      f"lives in other files)")
        if dtype is None:
            raise UnsupportedHDF5(f"{path}: no datatype message")
        self.dtype = dtype
        self._layout(layout)

    def _dataspace(self, body: bytes) -> Tuple[int, ...]:
        version, rank, flags = body[0], body[1], body[2]
        if version == 1:
            at = 8
        elif version == 2:
            at = 4
            if body[3] == 2:
                raise UnsupportedHDF5(f"{self.name}: a null dataspace")
        else:
            raise UnsupportedHDF5(f"{self.name}: dataspace version "
                                  f"{version}")
        l = self.file._l
        return tuple(int.from_bytes(body[at + i * l:at + (i + 1) * l],
                                    "little") for i in range(rank))

    def _pipeline(self, body: bytes):
        version, count = body[0], body[1]
        pos = 8 if version == 1 else 2
        out = []
        for _ in range(count):
            fid, = struct.unpack_from("<H", body, pos)
            pos += 2
            name_len = 0
            if version == 1 or fid >= 256:
                name_len, = struct.unpack_from("<H", body, pos)
                pos += 2
            _, n_values = struct.unpack_from("<HH", body, pos)  # flags
            pos += 4
            if version == 1:
                name_len = (name_len + 7) // 8 * 8
            pos += name_len
            values = struct.unpack_from(f"<{n_values}I", body, pos)
            pos += 4 * n_values
            if version == 1 and n_values % 2:
                pos += 4
            if fid not in (FILTER_DEFLATE, FILTER_SHUFFLE):
                raise UnsupportedHDF5(
                    f"{self.name}: the {FILTER_NAMES.get(fid, 'unknown')} "
                    f"filter (id {fid}); this reader takes deflate (gzip) "
                    f"and shuffle")
            out.append((fid, values))
        return out

    def _layout(self, body: Optional[bytes]) -> None:
        if body is None:
            raise UnsupportedHDF5(f"{self.name}: no layout message")
        version, cls = body[0], body[1]
        o = self.file._o
        if version != 3:
            raise UnsupportedHDF5(
                f"{self.name}: data layout message version {version}"
                f"{' (libver=latest: other chunk indexes)' if version == 4 else ''}"
                f"; this reader takes version 3")
        self._class = cls
        if cls == 0:    # compact: the data in the message
            size = int.from_bytes(body[2:4], "little")
            self._compact = body[4:4 + size]
        elif cls == 1:  # contiguous
            self._address = int.from_bytes(body[2:2 + o], "little")
            self._size = int.from_bytes(body[2 + o:2 + o + self.file._l],
                                        "little")
        elif cls == 2:  # chunked, through a B-tree of node type 1
            rank = body[2]
            self._address = int.from_bytes(body[3:3 + o], "little")
            dims = struct.unpack_from(f"<{rank}I", body, 3 + o)
            self._chunk = tuple(dims[:-1])
        else:
            raise UnsupportedHDF5(f"{self.name}: layout class {cls}"
                                  f"{' (virtual)' if cls == 3 else ''}")

    def __getitem__(self, key) -> np.ndarray:
        """The whole dataset, `dataset[()]`, as a numpy array of its dtype
        and shape."""
        if key != ():
            raise TypeError("a Dataset reads whole: dataset[()]")
        count = int(np.prod(self.shape, dtype=np.int64))
        nbytes = count * self.dtype.itemsize
        if self._class == 0:
            raw = self._compact[:nbytes]
        elif self._class == 1:
            if self._address == UNDEFINED:  # never written: the fill, 0
                return np.zeros(self.shape, self.dtype)
            raw = self.file._read(self._address, nbytes)
        else:
            return self._read_chunked()
        return np.frombuffer(raw, self.dtype, count).reshape(self.shape)

    def _unfilter(self, data: bytes, mask: int) -> bytes:
        """The pipeline undone, last filter first; a filter whose bit is
        set in the chunk's mask was skipped when it was written."""
        for i in reversed(range(len(self._filters))):
            if mask >> i & 1:
                continue
            fid, _ = self._filters[i]
            if fid == FILTER_DEFLATE:
                data = zlib.decompress(data)
            else:  # shuffle: byte j of every element, then byte j + 1
                size = self.dtype.itemsize
                n = len(data) // size
                head = np.frombuffer(data, np.uint8, n * size)
                data = head.reshape(size, n).T.tobytes() + data[n * size:]
        return data

    def _read_chunked(self) -> np.ndarray:
        out = np.zeros(self.shape, self.dtype)  # unwritten chunks: fill 0
        if self._address == UNDEFINED:
            return out
        rank = len(self.shape)
        key_size = 8 + 8 * (rank + 1)
        chunk_elems = int(np.prod(self._chunk, dtype=np.int64))
        stack = [self._address]
        while stack:
            level, keys, children = self.file._node(stack.pop(), 1, key_size)
            if level:
                stack.extend(children)
                continue
            for key, child in zip(keys, children):
                size, mask = struct.unpack_from("<II", key)
                start = struct.unpack_from(f"<{rank}Q", key, 8)
                data = self._unfilter(self.file._read(child, size), mask)
                block = np.frombuffer(data, self.dtype, chunk_elems).reshape(
                    self._chunk)
                where = tuple(slice(s, min(s + c, n)) for s, c, n in
                              zip(start, self._chunk, self.shape))
                out[where] = block[tuple(slice(0, w.stop - w.start)
                                         for w in where)]
        return out
