"""
The subset of HDF5 that the feature store needs, in pure Python
(``struct``, numpy, ``zlib``): it reads the tables that h5py writes for
``save_feature_db`` and adds tables that h5py and libhdf5 read and
append to.  The GPU hosts carry no h5py.

What it reads:

- superblock version 0, 8-byte offsets and lengths, at offset 0;
- version-1 object headers and their continuation blocks (NIL, fill
  value, modification-time, comment and attribute messages skipped);
- old-style groups: the symbol-table message, the group B-tree (v1,
  type 0) of any depth, its symbol-table nodes (SNOD), the local heap;
- dataspace messages versions 1 and 2;
- datatypes: IEEE floats (32 and 64 bits, little-endian), fixed-length
  strings, variable-length strings through global heap collections
  (GCOL);
- data layout message version 3: contiguous, or chunked through the
  chunk B-tree (v1, type 1) of any depth, partial edge chunks clipped,
  each chunk's filter mask honoured (a chunk never written reads as 0,
  the default fill value);
- filter pipeline messages versions 1 and 2 holding deflate (id 1)
  alone.

What it writes (``File(path, "a").write_group``): one group of
datasets.  Float arrays are stored as float64, chunked in blocks of
whole rows of at most ``CHUNK_BYTES`` and deflated at level 1.  Strings
are stored as fixed-length null-padded UTF-8.  The new objects are
appended at the end of the file.  The root group's local heap, SNODs
and B-tree are then rebuilt there by bulk loading, with the file's own
K values.  Last, the superblock's end-of-file address, the root's
symbol-table message and the superblock's cached root entry are patched
in place, in that order.  A write cut short therefore leaves every
earlier table readable, by this module and by libhdf5.  Chunks are
deflated on ``THREADS`` threads; they are read and inflated one at a
time, so a read holds one compressed chunk beside the array.
Space that a replaced table or an older root index held is not
reclaimed.

Anything outside this subset raises ``ValueError`` naming it: a
signature, a version, a message type, a datatype class, a layout class
or a filter id.
"""

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
SUFFIXES = (".h5", ".hdf5")
UNDEFINED = 0xFFFFFFFFFFFFFFFF
FREE_NULL = 1            # a local heap's free list when it has no block
CHUNK_BYTES = 1 << 20    # at most this many bytes of rows in a chunk
DEFLATE = 1
THREADS = min(8, os.cpu_count() or 1)   # writing: zlib releases the GIL

# object header message types
DATASPACE, DATATYPE, FILL, LAYOUT, FILTERS = 1, 3, 5, 8, 11
CONTINUATION, SYMBOL_TABLE = 16, 17
SKIPPED = {0, 4, 5, 12, 13, 14, 18}   # NIL, fill values, attribute,
#                                       comment, modification times
MESSAGES = {2: "link info (a new-style group)", 6: "link (a new-style "
            "group)", 7: "external data files", 10: "group info (a "
            "new-style group)", 15: "shared message table", 21: "attribute "
            "info", 22: "object reference count"}
CLASSES = ("fixed-point", "floating-point", "time", "string", "bit field",
           "opaque", "compound", "reference", "enumerated",
           "variable-length", "array")
FILTER_NAMES = {2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
                6: "scaleoffset"}

SUPERBLOCK_V0 = 96                   # bytes, with 8-byte offsets
ISTORE_K = 32      # a chunk B-tree's K: version 0 superblocks hold no other
ENTRY = struct.Struct("<QQII16s")    # symbol-table entry: 40 bytes
HEAP = struct.Struct("<4sB3xQQQ")    # local heap header: 32 bytes
TREE = struct.Struct("<4sBBHQQ")     # v1 B-tree node header: 24 bytes


def is_hdf5_path(path) -> bool:
    return str(path).endswith(SUFFIXES)


def _pad8(data: bytes) -> bytes:
    return data + b"\0" * (-len(data) % 8)


class _Dataset:
    """A dataset's header, parsed: shape, element type, layout, filters."""

    def __init__(self, shape, dtype, strings, layout, filters):
        self.shape = shape
        self.dtype = dtype          # numpy dtype of one element
        self.strings = strings      # None, ("fixed", padding) or
        #                             ("vlen", None)
        self.layout = layout        # ("contiguous", addr, size) or
        #                             ("chunked", btree, chunk shape)
        self.filters = filters      # filter ids in pipeline order


class File:
    """An HDF5 file of the store's subset, opened ``"r"`` (read) or
    ``"a"`` (read and add groups; created where missing)."""

    def __init__(self, path: str, mode: str = "r"):
        if mode not in ("r", "a"):
            raise ValueError(f"mode {mode!r}: 'r' or 'a'")
        self.path = str(path)
        self.mode = mode
        self._heaps: Dict[int, Dict[int, bytes]] = {}
        if mode == "a" and not os.path.exists(self.path):
            self._f = open(self.path, "w+b")
            self._create()
        else:
            self._f = open(self.path, "rb" if mode == "r" else "r+b")
        try:
            self._read_superblock()
            self._root = self._group_entries(self._root_header)
        except BaseException:
            self._f.close()
            raise

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        self._f.close()

    # -- reading -------------------------------------------------------------
    def _read(self, addr: int, size: int) -> bytes:
        self._f.seek(addr)
        data = self._f.read(size)
        if len(data) != size:
            raise ValueError(f"{self.path}: {size} bytes at {addr} run past "
                             "the end of the file")
        return data

    def _read_superblock(self) -> None:
        head = self._read(0, 24)
        if head[:8] != SIGNATURE:
            raise ValueError(f"{self.path}: no HDF5 signature at offset 0")
        version = head[8]
        if version != 0:
            raise ValueError(f"{self.path}: superblock version {version} "
                             "(version 0 is read)")
        if head[13] != 8 or head[14] != 8:
            raise ValueError(f"{self.path}: {head[13]}-byte offsets and "
                             f"{head[14]}-byte lengths (8-byte are read)")
        self.leaf_k, self.internal_k = struct.unpack_from("<HH", head, 16)
        base, _, eof, info = struct.unpack("<4Q", self._read(24, 32))
        if base != 0 or info != UNDEFINED:
            raise ValueError(f"{self.path}: a base address or a file "
                             "access information block in the superblock")
        self._eof_at = 40
        self._entry_at = 56
        _, header, cache, _, _ = ENTRY.unpack(self._read(self._entry_at,
                                                         ENTRY.size))
        self._root_header, self._root_cache = header, cache
        self.eof = eof

    def _messages(self, addr: int) -> List[Tuple[int, bytes, int]]:
        """(type, body, body address) of every message of the object
        header at ``addr``, continuation blocks followed."""
        prefix = self._read(addr, 16)
        if prefix[:4] == b"OHDR":
            raise ValueError(f"{self.path}: object header version 2 at "
                             f"{addr} (version 1 is read)")
        version, _, _, _, size = struct.unpack_from("<BBHII", prefix)
        if version != 1:
            raise ValueError(f"{self.path}: object header version {version} "
                             f"at {addr}")
        blocks, messages = [(addr + 16, size)], []
        while blocks:
            start, length = blocks.pop(0)
            data = self._read(start, length)
            pos = 0
            while pos + 8 <= length:
                mtype, msize, flags = struct.unpack_from("<HHB", data, pos)
                body = data[pos + 8:pos + 8 + msize]
                if mtype == CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", body))
                elif mtype not in SKIPPED:
                    if flags & 2:
                        raise ValueError(f"{self.path}: a shared message "
                                         f"(type {mtype}) at {addr}")
                    messages.append((mtype, body, start + pos + 8))
                pos += 8 + msize
        return messages

    def _local_heap(self, addr: int) -> bytes:
        sig, version, size, _, data = HEAP.unpack(self._read(addr, HEAP.size))
        if sig != b"HEAP" or version != 0:
            raise ValueError(f"{self.path}: no local heap (version 0) at "
                             f"{addr}")
        return self._read(data, size)

    def _btree_leaves(self, addr: int, node_type: int, key_size: int):
        """(key, child) of every leaf entry of the v1 B-tree at ``addr``,
        in order."""
        sig, ntype, level, used, _, _ = TREE.unpack(self._read(addr,
                                                               TREE.size))
        if sig != b"TREE" or ntype != node_type:
            raise ValueError(f"{self.path}: no B-tree node of type "
                             f"{node_type} at {addr}")
        step = key_size + 8
        data = self._read(addr + TREE.size, used * step + key_size)
        for i in range(used):
            key = data[i * step:i * step + key_size]
            child = struct.unpack_from("<Q", data, i * step + key_size)[0]
            if level:
                yield from self._btree_leaves(child, node_type, key_size)
            else:
                yield key, child

    def _group_entries(self, header: int) -> Dict[str, Tuple]:
        """name -> (object header, cache type, scratch pad) of a group's
        members; remembers where the group's symbol-table message sits."""
        stab = [m for m in self._messages(header) if m[0] == SYMBOL_TABLE]
        if not stab:
            raise ValueError(f"{self.path}: the object at {header} holds no "
                             "symbol-table message (no group, or a "
                             "new-style group)")
        btree, heap_addr = struct.unpack_from("<QQ", stab[0][1])
        if header == self._root_header:
            self._root_stab_at = stab[0][2]
        heap = self._local_heap(heap_addr)
        entries = {}
        for _, snod in self._btree_leaves(btree, 0, 8):
            sig, version, _, count = struct.unpack("<4sBBH",
                                                   self._read(snod, 8))
            if sig != b"SNOD" or version != 1:
                raise ValueError(f"{self.path}: no symbol-table node "
                                 f"(version 1) at {snod}")
            data = self._read(snod + 8, count * ENTRY.size)
            for i in range(count):
                name_at, obj, cache, _, scratch = ENTRY.unpack_from(
                    data, i * ENTRY.size)
                name = heap[name_at:heap.index(b"\0", name_at)]
                entries[name.decode("utf-8")] = (obj, cache, scratch)
        return entries

    def keys(self) -> List[str]:
        """The root group's members, sorted."""
        return sorted(self._root)

    def _dataset(self, path: str) -> _Dataset:
        *groups, name = path.strip("/").split("/")
        entries = self._root
        for group in groups:
            entries = self._group_entries(self._member(entries, group, path))
        return self._parse_dataset(self._member(entries, name, path))

    def _member(self, entries, name, path) -> int:
        if name not in entries:
            raise KeyError(f"{path!r} not in {self.path}")
        return entries[name][0]

    def _parse_dataset(self, header: int) -> _Dataset:
        shape = dtype = layout = None
        strings, filters = None, []
        for mtype, body, _ in self._messages(header):
            if mtype == DATASPACE:
                shape = self._dataspace(body)
            elif mtype == DATATYPE:
                dtype, strings = self._datatype(body)
            elif mtype == LAYOUT:
                layout = self._layout(body)
            elif mtype == FILTERS:
                filters = self._filters(body)
            elif mtype != SYMBOL_TABLE:
                raise ValueError(f"{self.path}: object header message type "
                                 f"{mtype} ({MESSAGES.get(mtype, 'unknown')})"
                                 f" at {header}")
        if shape is None or dtype is None or layout is None:
            raise ValueError(f"{self.path}: the object at {header} is no "
                             "dataset")
        return _Dataset(shape, dtype, strings, layout, filters)

    def _dataspace(self, body: bytes) -> Tuple[int, ...]:
        version, rank = body[0], body[1]
        if version == 1:
            pos = 8
        elif version == 2:
            if body[3] == 2:
                return (0,)     # a null dataspace: no element
            pos = 4
        else:
            raise ValueError(f"{self.path}: dataspace message version "
                             f"{version}")
        return struct.unpack_from(f"<{rank}Q", body, pos)

    def _datatype(self, body: bytes):
        cls, bits = body[0] & 0x0F, body[1]
        size = struct.unpack_from("<I", body, 4)[0]
        if cls == 1:
            if bits & 0x41 or size not in (4, 8):
                raise ValueError(f"{self.path}: a {size}-byte float that is "
                                 "not little-endian IEEE")
            return np.dtype(f"<f{size}"), None
        if cls == 3:
            return np.dtype(f"S{size}"), ("fixed", bits & 0x0F)
        if cls == 9:
            if bits & 0x0F != 1:
                raise ValueError(f"{self.path}: a variable-length sequence "
                                 "(variable-length strings are read)")
            return np.dtype("V16"), ("vlen", None)
        raise ValueError(f"{self.path}: datatype class {cls} "
                         f"({CLASSES[cls] if cls < len(CLASSES) else '?'})")

    def _layout(self, body: bytes):
        version, cls = body[0], body[1]
        if version != 3:
            raise ValueError(f"{self.path}: data layout message version "
                             f"{version} (version 3 is read)")
        if cls == 1:
            return ("contiguous",) + struct.unpack_from("<QQ", body, 2)
        if cls == 2:
            ndims = body[2]
            btree = struct.unpack_from("<Q", body, 3)[0]
            dims = struct.unpack_from(f"<{ndims}I", body, 11)
            return "chunked", btree, dims[:-1]
        raise ValueError(f"{self.path}: layout class {cls} ("
                         f"{'compact' if cls == 0 else '?'})")

    def _filters(self, body: bytes) -> List[int]:
        version, count = body[0], body[1]
        if version not in (1, 2):
            raise ValueError(f"{self.path}: filter pipeline message version "
                             f"{version}")
        pos, ids = (8 if version == 1 else 2), []
        for _ in range(count):
            fid = struct.unpack_from("<H", body, pos)[0]
            if version == 1 or fid >= 256:
                name_len = struct.unpack_from("<H", body, pos + 2)[0]
                pos += 4
            else:
                name_len = 0
                pos += 2
            n_values = struct.unpack_from("<H", body, pos + 2)[0]
            pos += 4
            pos += (name_len + 7) // 8 * 8 if version == 1 else name_len
            pos += 4 * n_values + (4 * (n_values % 2) if version == 1 else 0)
            if fid != DEFLATE:
                raise ValueError(f"{self.path}: filter id {fid} ("
                                 f"{FILTER_NAMES.get(fid, 'unknown')}); only "
                                 "deflate (id 1) is read")
            ids.append(fid)
        return ids

    def shape(self, path: str) -> Tuple[int, ...]:
        return tuple(self._dataset(path).shape)

    def read(self, path: str):
        """The dataset at ``path`` ("group/name"): a numpy array of
        floats, or a list of ``str`` for a string dataset."""
        ds = self._dataset(path)
        raw = self._raw(ds)
        if ds.strings is None:
            return raw
        kind, pad = ds.strings
        if kind == "vlen":
            return [self._vlen(item).decode("utf-8")
                    for item in raw.reshape(-1).tolist()]
        items = raw.reshape(-1).tolist()
        if pad == 0:    # null-terminated
            items = [s.split(b"\0", 1)[0] for s in items]
        elif pad == 2:  # space-padded
            items = [s.rstrip(b" ") for s in items]
        return [s.decode("utf-8") for s in items]

    def _raw(self, ds: _Dataset) -> np.ndarray:
        count = int(np.prod(ds.shape, dtype=np.int64))
        if ds.layout[0] == "contiguous":
            _, addr, size = ds.layout
            if addr == UNDEFINED:
                return np.zeros(ds.shape, ds.dtype)
            data = self._read(addr, count * ds.dtype.itemsize)
            return np.frombuffer(data, ds.dtype).reshape(ds.shape).copy()
        _, btree, chunk = ds.layout
        out = np.zeros(ds.shape, ds.dtype)
        if btree == UNDEFINED:
            return out
        rank = len(ds.shape)
        chunk_bytes = int(np.prod(chunk)) * ds.dtype.itemsize
        for key, addr in self._btree_leaves(btree, 1, 8 + 8 * (rank + 1)):
            nbytes, mask = struct.unpack_from("<II", key)
            origin = struct.unpack_from(f"<{rank}Q", key, 8)
            data = self._read(addr, nbytes)
            if ds.filters and not mask & 1:
                data = zlib.decompress(data, bufsize=chunk_bytes)
            block = np.frombuffer(data, ds.dtype).reshape(chunk)
            spans = tuple(slice(o, min(o + c, n))
                          for o, c, n in zip(origin, chunk, ds.shape))
            out[spans] = block[tuple(slice(0, s.stop - s.start)
                                     for s in spans)]
        return out

    def _vlen(self, item: bytes) -> bytes:
        length, collection, index = struct.unpack("<IQI", item)
        if collection not in self._heaps:
            self._heaps[collection] = self._global_heap(collection)
        return self._heaps[collection][index][:length]

    def _global_heap(self, addr: int) -> Dict[int, bytes]:
        sig, version, size = struct.unpack("<4sB3xQ", self._read(addr, 16))
        if sig != b"GCOL" or version != 1:
            raise ValueError(f"{self.path}: no global heap collection "
                             f"(version 1) at {addr}")
        data = self._read(addr, size)
        objects, pos = {}, 16
        while pos + 16 <= size:
            index, _, _, osize = struct.unpack_from("<HHIQ", data, pos)
            if index == 0:      # the free space: the rest of the collection
                break
            objects[index] = data[pos + 16:pos + 16 + osize]
            pos += 16 + (osize + 7) // 8 * 8
        return objects

    # -- writing -------------------------------------------------------------
    def _create(self) -> None:
        """A new file: the superblock and an empty root group."""
        self.leaf_k, self.internal_k = 4, 16
        blob = _Blob(SUPERBLOCK_V0)
        header_at = SUPERBLOCK_V0
        blob.put(_object_header([(SYMBOL_TABLE, b"\0" * 16, 0)]))
        btree, heap = _group_index(blob, [], self.leaf_k, self.internal_k)
        root = ENTRY.pack(0, header_at, 1, 0, struct.pack("<QQ", btree, heap))
        self._f.write(SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                      + struct.pack("<HHI4Q", self.leaf_k, self.internal_k,
                                    0, 0, UNDEFINED, blob.end(), UNDEFINED)
                      + root + blob.data)
        self._f.seek(header_at + 16 + 8)
        self._f.write(struct.pack("<QQ", btree, heap))
        self._f.flush()

    def write_group(self, name: str, datasets: Dict) -> None:
        """Add the group ``name`` holding ``datasets`` (dataset name ->
        a float array, or a sequence of ``str``), replacing a group of
        that name."""
        if self.mode != "a":
            raise ValueError(f"{self.path} is open for reading")
        if not name or "/" in name:
            raise ValueError(f"group name {name!r}: one non-empty link name")
        self._f.seek(0, os.SEEK_END)
        base = max(self._f.tell(), self.eof)
        blob = _Blob(base + (-base % 8))
        members = {}
        for member, value in datasets.items():
            if isinstance(value, np.ndarray) and value.dtype.kind == "f":
                members[member] = (_float_dataset(blob, value), 0,
                                   b"\0" * 16)
            else:
                members[member] = (_string_dataset(blob, value), 0,
                                   b"\0" * 16)
        btree, heap = _group_index(blob, members, self.leaf_k,
                                   self.internal_k)
        scratch = struct.pack("<QQ", btree, heap)
        header = blob.put(_object_header([(SYMBOL_TABLE, scratch, 0)]))
        root = dict(self._root)
        root[name] = (header, 1, scratch)
        btree, heap = _group_index(blob, root, self.leaf_k, self.internal_k)
        self._f.seek(blob.base)
        self._f.write(blob.data)
        self._f.flush()
        self._commit(btree, heap, blob.end())
        self._root = root

    def _commit(self, btree: int, heap: int, eof: int) -> None:
        """The last step of every write, one patch at a time: the
        superblock's end-of-file address (over bytes already written),
        then the root's symbol-table message, then the superblock's
        cached root entry.  After each patch the file reads as before
        the write or as after it."""
        pair = struct.pack("<QQ", btree, heap)
        patches = [(self._eof_at, struct.pack("<Q", eof)),
                   (self._root_stab_at, pair)]
        if self._root_cache == 1:
            patches.append((self._entry_at + 24, pair))
        for addr, data in patches:
            self._patch(addr, data)
        self.eof = eof

    def _patch(self, addr: int, data: bytes) -> None:
        self._f.seek(addr)
        self._f.write(data)
        self._f.flush()


class _Blob:
    """Bytes to append at ``base``, every object aligned to 8 bytes."""

    def __init__(self, base: int):
        self.base = base
        self.data = bytearray()

    def end(self) -> int:
        return self.base + len(self.data)

    def put(self, data: bytes) -> int:
        addr = self.end()
        self.data += _pad8(data)
        return addr


def _object_header(messages) -> bytes:
    """A version-1 object header of (type, body, flags) messages."""
    body = b"".join(struct.pack("<HHB3x", mtype, len(_pad8(data)), flags)
                    + _pad8(data) for mtype, data, flags in messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _btree(blob: _Blob, node_type: int, entries, final_key: bytes,
           k2: int) -> int:
    """Bulk-load a v1 B-tree of at most ``k2`` children a node over
    ``entries`` = [(left key, child)], its last right key ``final_key``;
    each node's right key is the next node's first left key.  Returns
    the root's address."""
    size = TREE.size + k2 * (len(final_key) + 8) + len(final_key)
    level = 0
    while True:
        nodes = [entries[i:i + k2] for i in range(0, len(entries), k2)] or [[]]
        addrs = [blob.end() + i * size for i in range(len(nodes))]
        for i, node in enumerate(nodes):
            last = i + 1 == len(nodes)
            head = TREE.pack(b"TREE", node_type, level, len(node),
                             addrs[i - 1] if i else UNDEFINED,
                             UNDEFINED if last else addrs[i + 1])
            body = b"".join(key + struct.pack("<Q", child)
                            for key, child in node)
            right = final_key if last else nodes[i + 1][0][0]
            blob.put((head + body + right).ljust(size, b"\0"))
        if len(nodes) == 1:
            return addrs[0]
        entries = [(node[0][0], addr) for node, addr in zip(nodes, addrs)]
        level += 1


def _group_index(blob: _Blob, members: Dict, leaf_k: int,
                 internal_k: int) -> Tuple[int, int]:
    """The local heap, symbol-table nodes and B-tree of a group whose
    ``members`` map name -> (object header, cache type, scratch pad).
    Returns (B-tree address, heap address)."""
    names = sorted(name.encode("utf-8") for name in members)
    segment, offsets = bytearray(8), {}     # offset 0: the empty name
    for name in names:
        offsets[name] = len(segment)
        segment += _pad8(name + b"\0")
    heap = blob.end()
    blob.put(HEAP.pack(b"HEAP", 0, len(segment), FREE_NULL, heap + HEAP.size)
             + segment)
    entries, left = [], struct.pack("<Q", 0)
    snod_size = 8 + 2 * leaf_k * ENTRY.size
    for start in range(0, len(names), 2 * leaf_k):
        node = names[start:start + 2 * leaf_k]
        body = b"".join(ENTRY.pack(offsets[n], obj, cache, 0, scratch)
                        for n in node for obj, cache, scratch
                        in [members[n.decode("utf-8")]])
        addr = blob.put((struct.pack("<4sBBH", b"SNOD", 1, 0, len(node))
                         + body).ljust(snod_size, b"\0"))
        entries.append((left, addr))
        left = struct.pack("<Q", offsets[node[-1]])
    return _btree(blob, 0, entries, left, 2 * internal_k), heap


# the datatypes and fill values h5py writes for these datasets
F64 = bytes.fromhex("11203f000800000000004000340b0034ff030000")
FILL_CHUNKED = bytes.fromhex("0203020100000000")
FILL_CONTIGUOUS = bytes.fromhex("0202000100000000")
DEFLATE_LEVEL_1 = struct.pack("<BB6xHHHH8sI4x", 1, 1, DEFLATE, 8, 1, 1,
                              b"deflate\0", 1)


def _dataspace(shape) -> bytes:
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    return struct.pack("<BBB5x", 1, len(shape), 1) + dims + dims


def _float_dataset(blob: _Blob, array: np.ndarray) -> int:
    """A float64 dataset chunked by blocks of whole rows, deflated at
    level 1.  Returns its object header's address."""
    array = np.ascontiguousarray(array, dtype="<f8")
    if array.ndim == 0 or 0 in array.shape[1:]:
        raise ValueError(f"a float dataset of shape {array.shape}: rows of "
                         "at least one element are written")
    shape, rank = array.shape, array.ndim
    flat = array.reshape(shape[0], int(np.prod(shape[1:])))
    rows = max(1, min(shape[0], CHUNK_BYTES // (flat.shape[1] * 8)))
    chunk = (rows,) + shape[1:]
    blocks = [flat[start:start + rows] for start in range(0, shape[0], rows)]
    if blocks and len(blocks[-1]) < rows:   # a whole chunk, zero-padded
        blocks[-1] = np.concatenate([blocks[-1], np.zeros(
            (rows - len(blocks[-1]), flat.shape[1]))])
    entries, zeros = [], (0,) * rank
    with ThreadPoolExecutor(max(1, min(THREADS, len(blocks)))) as pool:
        for j, data in enumerate(pool.map(lambda b: zlib.compress(b, 1),
                                          blocks)):
            entries.append((struct.pack(f"<II{rank + 1}Q", len(data), 0,
                                        j * rows, *zeros[1:], 0),
                            blob.put(data)))
    btree = UNDEFINED
    if entries:     # the last right key: the far corner of the last chunk
        final = struct.pack(f"<II{rank + 1}Q", 0, 0, len(entries) * rows,
                            *shape[1:], 8)
        btree = _btree(blob, 1, entries, final, 2 * ISTORE_K)
    layout = struct.pack(f"<BBBQ{rank + 1}I", 3, 2, rank + 1, btree, *chunk,
                         8)
    return blob.put(_object_header([
        (DATASPACE, _dataspace(shape), 0), (DATATYPE, F64, 1),
        (FILL, FILL_CHUNKED, 1), (FILTERS, DEFLATE_LEVEL_1, 1),
        (LAYOUT, layout, 0)]))


def _string_dataset(blob: _Blob, values) -> int:
    """A 1-D dataset of fixed-length, null-padded UTF-8 strings, stored
    contiguously.  Returns its object header's address."""
    items = [str(v).encode("utf-8") for v in values]
    width = max([len(s) for s in items] + [1])
    data = np.array(items, dtype=f"S{width}").tobytes() if items else b""
    addr = blob.put(data) if data else UNDEFINED
    dtype = struct.pack("<BBBBI", 0x13, 0x11, 0, 0, width)
    layout = struct.pack("<BBQQ", 3, 1, addr, len(data))
    return blob.put(_object_header([
        (DATASPACE, _dataspace((len(items),)), 0), (DATATYPE, dtype, 1),
        (FILL, FILL_CONTIGUOUS, 1), (LAYOUT, layout, 0)]))
