"""HDF5 utterance store: one .h5 per utterance with named datasets, read
and written by a codec of this package's own (numpy and `struct` only; no
h5py), and Kaldi-style scp files that address them.

The codec reads what h5py writes by default (superblock version 0, the
JAX package's `write_hdf5` and the reference's both write it):

* the root group's symbol table: a version 1 B-tree (`TREE`) of group
  nodes over symbol-table nodes (`SNOD`), the names in a local heap
  (`HEAP`), however many nodes and levels the group has;
* version 1 object headers, their continuation blocks (message 0x10)
  included;
* the dataspace (0x01), datatype (0x03: fixed-point and IEEE float of
  either byte order) and layout (0x08, version 3 or 4, contiguous or
  compact) messages of a dataset; its fill-value messages (0x04, 0x05)
  are passed over (data never written reads as zeros, h5py's fill).

Chunked or compressed layouts, shared or committed datatypes, any other
datatype, nested groups and newer file formats raise a `ValueError` that
names the file (and the dataset). A dataset that was deleted and created
again (what `write_hdf5` of h5py's does to replace one) is read as the
group now lists it.

`write_hdf5` writes the whole file anew in the same layout, so that h5py,
the JAX package and the reference read it: every dataset contiguous and
little-endian, the members in one symbol-table node sorted by their names'
bytes (HDF5 finds a member by binary search), the superblock's group leaf
K raised above 4 where a group holds more than 8 members.
"""

from __future__ import annotations

import os
import struct

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF  # the undefined address
FREE_NULL = 1  # a local heap's empty free list
INTERNAL_K = 16  # the group B-tree's internal node K (HDF5's default)
# IEEE layouts by size: (precision, exponent location, exponent size,
# mantissa location, mantissa size, exponent bias)
IEEE = {2: (16, 10, 5, 0, 10, 15), 4: (32, 23, 8, 0, 23, 127),
        8: (64, 52, 11, 0, 52, 1023)}
FIXED_SIZES = (1, 2, 4, 8)

# message types
DATASPACE, DATATYPE, FILL, LAYOUT, FILTERS = 1, 3, 5, 8, 11
CONTINUATION, SYMBOL_TABLE = 0x10, 0x11


def _u(fmt: str, buf: bytes, off: int = 0):
    return struct.unpack_from("<" + fmt, buf, off)


class _Reader:
    """Random access to the structures of one HDF5 file."""

    def __init__(self, path: str, f):
        self.path, self.f = path, f
        self.base = self._superblock()

    def fail(self, what: str, name: str = None):
        where = f"{self.path}" + (f": dataset {name!r}" if name else "")
        raise ValueError(f"{where}: {what}")

    def read(self, addr: int, n: int) -> bytes:
        self.f.seek(self.base + addr)
        data = self.f.read(n)
        if len(data) != n:
            self.fail(f"truncated: {n} bytes at {addr} past the end")
        return data

    def _superblock(self) -> int:
        sb = self.f.read(100)
        if sb[:8] != SIGNATURE:  # a user block (none by default) included
            raise ValueError(f"{self.path}: not an HDF5 file at offset 0")
        version = sb[8]
        if version not in (0, 1):
            raise ValueError(f"{self.path}: superblock version {version} is "
                             "not supported (only 0 and 1, h5py's default)")
        if sb[13] != 8 or sb[14] != 8:
            raise ValueError(f"{self.path}: offsets of {sb[13]} and lengths "
                             f"of {sb[14]} bytes are not supported")
        off = 24 + (4 if version == 1 else 0)
        (base,) = _u("Q", sb, off)
        (self.root,) = _u("Q", sb, off + 32 + 8)  # the root entry's header
        return base

    # -- object headers ---------------------------------------------------

    def messages(self, addr: int, name: str = None):
        """[(type, flags, data)] of a version 1 object header, the
        continuation blocks followed."""
        head = self.read(addr, 16)
        if head[:4] == b"OHDR" or head[0] != 1:
            self.fail("object header version other than 1 is not "
                      "supported", name)
        (n_msgs,) = _u("H", head, 2)
        (size,) = _u("I", head, 8)
        chunks, out = [(addr + 16, size)], []
        while chunks and len(out) < n_msgs:
            at, length = chunks.pop(0)
            block, pos = self.read(at, length), 0
            while pos + 8 <= length and len(out) < n_msgs:
                mtype, msize, mflags = _u("HHB", block, pos)
                data = block[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if mtype == CONTINUATION:
                    chunks.append(_u("QQ", data))
                out.append((mtype, mflags, data))
        return out

    # -- the root group ---------------------------------------------------

    def members(self) -> dict:
        """name -> object header address of every member of the root
        group."""
        table = [d for t, _, d in self.messages(self.root) if t ==
                 SYMBOL_TABLE]
        if not table:
            self.fail("the root group has no symbol table (a newer group "
                      "format, not supported)")
        btree, heap = _u("QQ", table[0])
        names = self._heap(heap)
        out = {}
        self._walk(btree, names, out)
        return out

    def _heap(self, addr: int):
        head = self.read(addr, 32)
        if head[:4] != b"HEAP":
            self.fail(f"no local heap at {addr}")
        size, _, data_addr = _u("QQQ", head, 8)
        data = self.read(data_addr, size)

        def name(off):
            end = data.index(b"\0", off)
            return data[off:end].decode("utf-8")

        return name

    def _walk(self, addr: int, names, out: dict):
        head = self.read(addr, 24)
        if head[:4] != b"TREE" or head[4] != 0:
            self.fail(f"no group B-tree node at {addr}")
        level, used = head[5], _u("H", head, 6)[0]
        body = self.read(addr + 24, 16 * used + 8)
        for i in range(used):
            (child,) = _u("Q", body, 16 * i + 8)
            if level > 0:
                self._walk(child, names, out)
            else:
                self._snod(child, names, out)

    def _snod(self, addr: int, names, out: dict):
        head = self.read(addr, 8)
        if head[:4] != b"SNOD":
            self.fail(f"no symbol-table node at {addr}")
        (n,) = _u("H", head, 6)
        body = self.read(addr + 8, 40 * n)
        for i in range(n):
            name_off, header = _u("QQ", body, 40 * i)
            out[names(name_off)] = header

    # -- datasets ---------------------------------------------------------

    def dataset(self, name: str, addr: int) -> np.ndarray:
        msgs = {}
        for mtype, mflags, data in self.messages(addr, name):
            if mflags & 0x02 and mtype in (DATASPACE, DATATYPE, LAYOUT):
                self.fail("shared or committed messages are not supported",
                          name)
            msgs.setdefault(mtype, data)
        if SYMBOL_TABLE in msgs:
            self.fail("a group, not a dataset (nested groups are not "
                      "supported)", name)
        if FILTERS in msgs:
            self.fail("a filter pipeline (compression) is not supported",
                      name)
        if not all(t in msgs for t in (DATASPACE, DATATYPE, LAYOUT)):
            self.fail("not a dataset", name)
        shape = self._dataspace(msgs[DATASPACE], name)
        dtype = self._datatype(msgs[DATATYPE], name)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        lay = msgs[LAYOUT]
        if lay[0] not in (3, 4):
            self.fail(f"layout message version {lay[0]} is not supported",
                      name)
        if lay[1] == 0:  # compact: the data in the header
            (size,) = _u("H", lay, 2)
            raw = lay[4:4 + size]
        elif lay[1] == 1:  # contiguous
            data_addr, size = _u("QQ", lay, 2)
            raw = (b"\0" * nbytes if data_addr == UNDEF  # never written:
                   else self.read(data_addr, nbytes))    # the zero fill
        else:
            self.fail(f"layout class {lay[1]} (chunked or virtual) is not "
                      "supported", name)
        if len(raw) < nbytes or (lay[1] == 1 and size < nbytes
                                 and data_addr != UNDEF):
            self.fail(f"{len(raw)} bytes of data for shape {shape} of "
                      f"{dtype}", name)
        arr = np.frombuffer(raw, dtype, count=nbytes // dtype.itemsize)
        arr = arr.reshape(shape).astype(dtype.newbyteorder("="))
        return arr[()]

    def _dataspace(self, d: bytes, name: str):
        version, rank, flags = d[0], d[1], d[2]
        if version == 1:
            start = 8
        elif version == 2:
            if d[3] == 2:
                self.fail("a null dataspace is not supported", name)
            start = 4
        else:
            self.fail(f"dataspace version {version} is not supported", name)
        return tuple(_u(f"{rank}Q", d, start)) if rank else ()

    def _datatype(self, d: bytes, name: str) -> np.dtype:
        cls, bits, (size,) = d[0] & 0x0F, d[1:4], _u("I", d, 4)
        order = ">" if bits[0] & 0x01 else "<"
        if cls == 0 and size in FIXED_SIZES:
            offset, precision = _u("HH", d, 8)
            if offset == 0 and precision == 8 * size:
                kind = "i" if bits[0] & 0x08 else "u"
                return np.dtype(f"{order}{kind}{size}")
        if cls == 1 and size in IEEE and not bits[0] & 0x40:
            props = _u("HHBBBBI", d, 8)
            if (props[0] == 0 and props[1:] == IEEE[size]
                    and bits[1] == 8 * size - 1 and (bits[0] >> 4) & 3 == 2):
                return np.dtype(f"{order}f{size}")
        self.fail(f"datatype class {cls} of {size} bytes (bit fields "
                  f"{bits.hex()}) is not supported: fixed-point of 1-8 bytes "
                  "and IEEE floats of 2, 4 or 8 are", name)


def _open(path: str):
    if not os.path.exists(path):
        raise FileNotFoundError(f"no such hdf5 file: {path}")
    return open(path, "rb")


def read_hdf5(path: str, dataset_name: str):
    """Read one dataset from an hdf5 file (a numpy scalar for rank 0, as
    h5py's `dset[()]`)."""
    with _open(path) as f:
        r = _Reader(path, f)
        members = r.members()
        if dataset_name not in members:
            raise KeyError(f"dataset {dataset_name!r} not in {path}")
        return r.dataset(dataset_name, members[dataset_name])


def read_hdf5_all(path: str) -> dict:
    """Every dataset of an hdf5 file, by name."""
    with _open(path) as f:
        r = _Reader(path, f)
        return {k: r.dataset(k, a) for k, a in r.members().items()}


# -- the writer ---------------------------------------------------------------


def _message(mtype: int, flags: int, data: bytes) -> bytes:
    data += b"\0" * (-len(data) % 8)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _datatype_message(dtype: np.dtype, path: str, name: str) -> bytes:
    size = dtype.itemsize
    if dtype.kind in "iu" and size in FIXED_SIZES:
        signed = 0x08 if dtype.kind == "i" else 0
        return struct.pack("<B3BIHH", 0x10, signed, 0, 0, size, 0, 8 * size)
    if dtype.kind == "f" and size in IEEE:
        # implied mantissa msb (0x20), the sign bit at the top
        return struct.pack("<B3BIHHBBBBI", 0x11, 0x20, 8 * size - 1, 0, size,
                           0, *IEEE[size])
    raise TypeError(f"{path}: dataset {name!r}: dtype {dtype} is not "
                    "supported: integers of 1-8 bytes and floats of 2, 4 "
                    "or 8 are")


def _dataset_header(arr: np.ndarray, data_addr: int, dtype_msg: bytes
                    ) -> bytes:
    rank = arr.ndim
    space = struct.pack("<BBBx4x", 1, rank, 1 if rank else 0)
    space += struct.pack(f"<{2 * rank}Q", *arr.shape, *arr.shape)
    fill = struct.pack("<BBBBI", 2, 2, 2, 1, 0)  # h5py's default: zeros
    layout = struct.pack("<BBQQ", 3, 1,
                         data_addr if arr.nbytes else UNDEF, arr.nbytes)
    msgs = (_message(DATASPACE, 0, space) + _message(DATATYPE, 1, dtype_msg)
            + _message(FILL, 1, fill) + _message(LAYOUT, 0, layout))
    return struct.pack("<BxHII4x", 1, 4, 1, len(msgs)) + msgs


def _encode(members: dict, path: str) -> bytes:
    """The bytes of a superblock-0 file holding `members` (name -> array)."""
    names = sorted(members, key=lambda k: k.encode("utf-8"))
    arrays = []
    for k in names:
        if not k or "/" in k or k == ".":
            raise ValueError(f"{path}: {k!r} is not a dataset name")
        a = np.asarray(members[k])
        a = a.astype(a.dtype.newbyteorder("<"), order="C", copy=False)
        arrays.append((a, _datatype_message(a.dtype, path, k)))
    leaf_k = max(4, -(-len(names) // 2))  # one symbol-table node holds all

    # the local heap's names: "" at 0, then each 8-byte aligned
    heap, name_off = bytearray(8), []
    for k in names:
        name_off.append(len(heap))
        b = k.encode("utf-8") + b"\0"
        heap += b + b"\0" * (-len(b) % 8)

    root_addr = 96
    tree_addr = root_addr + 40
    tree_size = 24 + (2 * INTERNAL_K + 1) * 8 + 2 * INTERNAL_K * 8
    heap_addr = tree_addr + tree_size
    snod_addr = heap_addr + 32 + len(heap)
    at = snod_addr + 8 + 2 * leaf_k * 40
    headers, blobs = [], []
    for a, dmsg in arrays:
        size = len(_dataset_header(a, 0, dmsg))
        data_addr = at + size
        headers.append(at)
        blobs.append(_dataset_header(a, data_addr, dmsg) + a.tobytes()
                     + b"\0" * (-a.nbytes % 8))
        at = data_addr + a.nbytes + (-a.nbytes % 8)
    eof = at

    out = bytearray()
    out += SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
    out += struct.pack("<HHI", leaf_k, INTERNAL_K, 0)
    out += struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
    # the root group's symbol-table entry, its B-tree and heap cached
    out += struct.pack("<QQI4xQQ", 0, root_addr, 1, tree_addr, heap_addr)
    out += struct.pack("<BxHII4x", 1, 1, 1, 24)
    out += _message(SYMBOL_TABLE, 0, struct.pack("<QQ", tree_addr,
                                                 heap_addr))
    tree = bytearray(b"TREE" + struct.pack("<BBHQQ", 0, 0, 1, UNDEF, UNDEF))
    tree += struct.pack("<QQQ", 0, snod_addr, name_off[-1])
    out += tree + bytes(tree_size - len(tree))
    out += b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), FREE_NULL,
                                 heap_addr + 32)
    out += heap
    snod = bytearray(b"SNOD" + struct.pack("<BxH", 1, len(names)))
    for off, header in zip(name_off, headers):
        snod += struct.pack("<QQI4x16x", off, header, 0)
    out += snod + bytes(8 + 2 * leaf_k * 40 - len(snod))
    for blob in blobs:
        out += blob
    assert len(out) == eof
    return bytes(out)


def write_hdf5(path: str, dataset_name: str, data):
    """Write one dataset into an hdf5 file (creating dirs as needed),
    replacing a dataset of that name: the file is read and written anew
    with every dataset it held."""
    members = read_hdf5_all(path) if os.path.exists(path) else {}
    members[dataset_name] = np.asarray(data)
    blob = _encode(members, path)
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)  # a reader never sees half a file


class HDF5ScpLoader:
    """Loader for kaldi-style scp files pointing at hdf5 members, the
    counterpart of the JAX package's. Entry forms:

        utt_a  /path/a.h5                  (uses `default_hdf5_path`)
        utt_b  /path/b.h5:feats
        utt_c  /path/c.h5:feats_1,feats_2  (concatenated on the last axis)
    """

    def __init__(self, feats_scp: str, default_hdf5_path: str = "feats"):
        self.default_hdf5_path = default_hdf5_path
        self.data = {}
        with open(feats_scp) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                key, value = line.split(maxsplit=1)
                self.data[key] = value

    def keys(self):
        return self.data.keys()

    def values(self):
        for key in self.data:
            yield self[key]

    def __len__(self):
        return len(self.data)

    def __iter__(self):
        return iter(self.data)

    def __contains__(self, key):
        return key in self.data

    def __getitem__(self, key):
        p = self.data[key]
        if ":" in p:
            path, dset = p.split(":", 1)
            if "," in dset:
                return np.concatenate(
                    [read_hdf5(path, d) for d in dset.split(",")], axis=-1)
            return read_hdf5(path, dset)
        return read_hdf5(p, self.default_hdf5_path)
