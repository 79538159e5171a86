"""Datasources: lazy readers that yield read tasks.

Copy of `ray_tpu/data/datasource.py` (numpy and the standard library;
pyarrow and PIL are imported only inside the parquet and image readers):
each source is a list of zero-argument callables, so reads run as
parallel runtime tasks. The range and numpy sources make their read tasks
partials of module-level functions (`portable`), so in a cluster their
reads run on node agents too (the port ships a task by reference); a
closure's read (the items source, the file sources) stays on the submitting
node.
"""

from __future__ import annotations

import functools
import glob as _glob
import os
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from .block import Block, block_from_items

ReadTask = Callable[[], Block]


def portable(task: ReadTask) -> bool:
    """Whether a node agent can import `task` by reference: a partial of a
    module-level function of this package."""
    return (isinstance(task, functools.partial)
            and getattr(task.func, "__module__", "").startswith("ray_tpu_torch."))


def _range_block(lo: int, hi: int) -> Block:
    return {"item": np.arange(lo, hi)}


def _same_block(block: Block) -> Block:
    return block


class Datasource:
    def read_tasks(self) -> List[ReadTask]:
        raise NotImplementedError

    def estimated_num_rows(self) -> Optional[int]:
        return None

    def estimated_block_nbytes(self) -> Optional[int]:
        """Declared per-block output size, if this source knows it
        cheaply (no reads). Seeds the byte-budgeted window's in-flight
        estimate so it binds before the first block seals; None means
        the window is count-limited until then."""
        return None


class RangeSource(Datasource):
    def __init__(self, n: int, num_blocks: int = 8):
        self.n = n
        self.num_blocks = max(1, min(num_blocks, n)) if n else 1

    def read_tasks(self) -> List[ReadTask]:
        edges = np.linspace(0, self.n, self.num_blocks + 1, dtype=np.int64)

        return [functools.partial(_range_block, int(lo), int(hi))
                for lo, hi in zip(edges[:-1], edges[1:]) if hi > lo]

    def estimated_num_rows(self) -> Optional[int]:
        return self.n

    def estimated_block_nbytes(self) -> Optional[int]:
        if not self.n:
            return None
        rows = -(-self.n // self.num_blocks)  # ceil: the largest block
        return rows * np.dtype(np.int64).itemsize


class ItemsSource(Datasource):
    def __init__(self, items: Sequence[Any], num_blocks: int = 8):
        self.items = list(items)
        self.num_blocks = max(1, min(num_blocks, len(self.items) or 1))

    def read_tasks(self) -> List[ReadTask]:
        chunks = np.array_split(np.arange(len(self.items)), self.num_blocks)

        def make(idx: np.ndarray) -> ReadTask:
            rows = [self.items[i] for i in idx]
            return lambda: block_from_items(rows)

        # a closure: the items may be anything, and only this process is
        # sure to hold what they reference
        return [make(c) for c in chunks if len(c)]

    def estimated_num_rows(self) -> Optional[int]:
        return len(self.items)


class NumpySource(Datasource):
    def __init__(self, arrays: dict, num_blocks: int = 8):
        self.arrays = {k: np.asarray(v) for k, v in arrays.items()}
        n = len(next(iter(self.arrays.values())))
        self.num_blocks = max(1, min(num_blocks, n or 1))

    def read_tasks(self) -> List[ReadTask]:
        n = len(next(iter(self.arrays.values())))
        edges = np.linspace(0, n, self.num_blocks + 1, dtype=np.int64)

        return [functools.partial(_same_block, {k: v[int(lo):int(hi)] for k, v in self.arrays.items()})
                for lo, hi in zip(edges[:-1], edges[1:]) if hi > lo]

    def estimated_num_rows(self) -> Optional[int]:
        return len(next(iter(self.arrays.values())))

    def estimated_block_nbytes(self) -> Optional[int]:
        n = len(next(iter(self.arrays.values())))
        if not n:
            return None
        total = sum(v.nbytes for v in self.arrays.values())
        return -(-total // self.num_blocks)  # ceil: the largest block


class TextSource(Datasource):
    """One block per file; column 'text' of lines."""

    def __init__(self, paths: Sequence[str]):
        self.paths = _expand(paths)

    def read_tasks(self) -> List[ReadTask]:
        def make(path: str) -> ReadTask:
            def read() -> Block:
                with open(path, "r") as f:
                    lines = [ln.rstrip("\n") for ln in f]
                return {"text": np.asarray(lines, dtype=object)}

            return read

        return [make(p) for p in self.paths]


class NpyFileSource(Datasource):
    """One block per .npy file; column name configurable (token shards)."""

    def __init__(self, paths: Sequence[str], column: str = "tokens"):
        self.paths = _expand(paths)
        self.column = column

    def read_tasks(self) -> List[ReadTask]:
        def make(path: str) -> ReadTask:
            return lambda: {self.column: np.load(path)}

        return [make(p) for p in self.paths]

    def estimated_block_nbytes(self) -> Optional[int]:
        # file size ≈ array nbytes (the .npy header is ~128 bytes)
        try:
            return max(os.path.getsize(p) for p in self.paths)
        except OSError:
            return None


class ParquetSource(Datasource):
    """One block per row-group (pyarrow gated — see read_parquet)."""

    def __init__(self, paths: Sequence[str], columns: Optional[List[str]] = None):
        self.paths = _expand(paths)
        self.columns = columns

    def read_tasks(self) -> List[ReadTask]:
        import pyarrow.parquet as pq  # gated import

        tasks: List[ReadTask] = []
        for path in self.paths:
            num_rgs = pq.ParquetFile(path).metadata.num_row_groups

            def make(path: str, rg: int) -> ReadTask:
                def read() -> Block:
                    table = pq.ParquetFile(path).read_row_group(rg, columns=self.columns)
                    return {
                        name: col.to_numpy(zero_copy_only=False)
                        for name, col in zip(table.column_names, table.columns)
                    }

                return read

            tasks.extend(make(path, rg) for rg in range(num_rgs))
        return tasks


def _expand(paths: Sequence[str]) -> List[str]:
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        p = os.fspath(p)
        if any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p)))
        elif os.path.isdir(p):
            out.extend(sorted(os.path.join(p, f) for f in os.listdir(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths!r}")
    return out


class CsvSource(Datasource):
    """One block per CSV file; columns inferred, numeric where possible
    (reference _internal/datasource/csv_datasource.py)."""

    def __init__(self, paths: Sequence[str]):
        self.paths = _expand(paths)

    def read_tasks(self) -> List[ReadTask]:
        def make(path: str) -> ReadTask:
            def read() -> Block:
                import csv

                with open(path, newline="") as f:
                    rows = list(csv.DictReader(f))
                if not rows:
                    return {}
                block: Block = {}
                for name in rows[0]:
                    col = [r[name] for r in rows]
                    # ints FIRST and directly — a float round trip silently
                    # corrupts integers above 2^53 (snowflake-style ids)
                    try:
                        block[name] = np.asarray(
                            [int(x) for x in col], dtype=np.int64
                        )
                        continue
                    except (ValueError, OverflowError):
                        pass
                    try:
                        block[name] = np.asarray([float(x) for x in col])
                    except ValueError:
                        block[name] = np.asarray(col, dtype=object)
                return block

            return read

        return [make(p) for p in self.paths]


class JsonlSource(Datasource):
    """One block per .jsonl file: each line a JSON object ⇒ one row
    (reference _internal/datasource/json_datasource.py)."""

    def __init__(self, paths: Sequence[str]):
        self.paths = _expand(paths)

    def read_tasks(self) -> List[ReadTask]:
        def make(path: str) -> ReadTask:
            def read() -> Block:
                import json

                rows = []
                with open(path) as f:
                    for line in f:
                        line = line.strip()
                        if line:
                            rows.append(json.loads(line))
                if not rows:
                    return {}
                names: List[str] = []
                for r in rows:  # union over ALL rows: later-appearing keys count
                    for k in r:
                        if k not in names:
                            names.append(k)
                block: Block = {}
                for name in names:
                    col = [r.get(name) for r in rows]
                    try:
                        block[name] = np.asarray(col)
                    except Exception:
                        block[name] = np.asarray(col, dtype=object)
                return block

            return read

        return [make(p) for p in self.paths]


# --------------------------------------------------------------- tfrecord

def _read_uvarint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _walk_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message.
    Length-delimited values yield the raw bytes; varints the int."""
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_uvarint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            value, pos = _read_uvarint(buf, pos)
        elif wire == 1:  # fixed64
            value = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            length, pos = _read_uvarint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire == 5:  # fixed32
            value = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, value


def _parse_example(data: bytes):
    """Minimal tf.train.Example parser over the protobuf wire format —
    no protobuf runtime needed (reference: the tfrecords datasource
    parses Examples via tensorflow; the port needs neither, so the ~60
    lines of TLV walking live here). Schema: Example{1: Features},
    Features{1: map<string, Feature>}, Feature{1: BytesList, 2:
    FloatList, 3: Int64List}, each *List{1: repeated value} (floats
    packed little-endian, ints packed varints)."""
    features = {}
    for field, _, value in _walk_fields(data):
        if field != 1:
            continue
        for f2, _, entry in _walk_fields(value):  # map entries
            if f2 != 1:
                continue
            key = None
            feat = b""
            for f3, _, v3 in _walk_fields(entry):
                if f3 == 1:
                    key = v3.decode("utf-8")
                elif f3 == 2:
                    feat = v3
            if key is None:
                continue
            for f4, wire4, v4 in _walk_fields(feat):  # the oneof list
                if f4 == 1:  # BytesList
                    vals = [v for f5, _, v in _walk_fields(v4) if f5 == 1]
                    features[key] = vals
                elif f4 == 2:  # FloatList
                    floats: List[float] = []
                    for f5, w5, v5 in _walk_fields(v4):
                        if f5 != 1:
                            continue
                        if w5 == 2:  # packed
                            floats.extend(
                                np.frombuffer(v5, dtype="<f4").tolist()
                            )
                        else:  # unpacked fixed32
                            floats.append(
                                float(np.frombuffer(v5, dtype="<f4")[0])
                            )
                    features[key] = np.asarray(floats, dtype=np.float32)
                elif f4 == 3:  # Int64List
                    def _signed(n: int) -> int:
                        # protobuf int64 varints are two's-complement in
                        # 64 bits: fold the unsigned decode back down so
                        # negative labels/offsets round-trip
                        return n - (1 << 64) if n >= (1 << 63) else n

                    ints: List[int] = []
                    for f5, w5, v5 in _walk_fields(v4):
                        if f5 != 1:
                            continue
                        if w5 == 2:  # packed varints
                            p = 0
                            while p < len(v5):
                                n, p = _read_uvarint(v5, p)
                                ints.append(_signed(n))
                        else:
                            ints.append(_signed(v5))
                    features[key] = np.asarray(ints, dtype=np.int64)
    return features


def _tfrecord_records(path: str):
    """Iterate raw record payloads of one TFRecord file: 8-byte LE
    length | 4-byte length crc | payload | 4-byte payload crc. CRCs are
    crc32c; they are skipped rather than verified (no crc32c in the
    stdlib — truncation still surfaces as a short read)."""
    import struct

    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                # mid-header truncation must be as loud as mid-payload
                raise ValueError(f"truncated TFRecord header in {path}")
            (length,) = struct.unpack("<Q", header[:8])
            payload = f.read(length)
            if len(payload) < length:
                raise ValueError(f"truncated TFRecord in {path}")
            f.read(4)  # payload crc
            yield payload


class TFRecordSource(Datasource):
    """One block per TFRecord file (reference
    _internal/datasource/tfrecords_datasource.py). parse=True decodes
    tf.train.Example records into columns; parse=False yields raw
    payload bytes in a 'bytes' column."""

    def __init__(self, paths: Sequence[str], parse: bool = True):
        self.paths = _expand(paths)
        self.parse = parse

    def read_tasks(self) -> List[ReadTask]:
        parse = self.parse

        def make(path: str) -> ReadTask:
            def read() -> Block:
                records = list(_tfrecord_records(path))
                if not parse:
                    return {"bytes": np.asarray(records, dtype=object)}
                rows = [_parse_example(r) for r in records]
                names: List[str] = []
                for r in rows:
                    for k in r:
                        if k not in names:
                            names.append(k)
                block: Block = {}
                for name in names:
                    col = [r.get(name) for r in rows]
                    scalars = [
                        v[0] if v is not None and len(v) == 1 else v
                        for v in col
                    ]
                    try:
                        block[name] = np.asarray(scalars)
                    except Exception:
                        block[name] = np.asarray(scalars, dtype=object)
                return block

            return read

        return [make(p) for p in self.paths]


class ImageDirSource(Datasource):
    """Decode a directory (or glob) of images: columns 'image' (HWC
    uint8) and 'path'; `size` center-resizes so blocks stack densely
    (reference _internal/datasource/image_datasource.py). PIL-gated."""

    def __init__(self, paths: Sequence[str], size=None, mode: str = "RGB",
                 images_per_block: int = 64):
        exts = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp")
        self.paths = [
            p for p in _expand(paths) if p.lower().endswith(exts)
        ]
        if not self.paths:
            raise FileNotFoundError(f"no image files under {paths!r}")
        self.size = size
        self.mode = mode
        self.images_per_block = images_per_block

    def read_tasks(self) -> List[ReadTask]:
        size, mode = self.size, self.mode
        groups = [
            self.paths[i:i + self.images_per_block]
            for i in range(0, len(self.paths), self.images_per_block)
        ]

        def make(group: List[str]) -> ReadTask:
            def read() -> Block:
                from PIL import Image  # gated import

                images = []
                for p in group:
                    with Image.open(p) as im:
                        im = im.convert(mode)
                        if size is not None:
                            im = im.resize(size)
                        images.append(np.asarray(im))
                stackable = size is not None or len(
                    {im.shape for im in images}
                ) == 1
                if stackable:
                    col = np.stack(images)
                else:
                    # elementwise assign: np.asarray(..., dtype=object)
                    # raises on partially-aligned shapes (same height,
                    # different widths)
                    col = np.empty(len(images), dtype=object)
                    for i, im in enumerate(images):
                        col[i] = im
                return {
                    "image": col,
                    "path": np.asarray(group, dtype=object),
                }

            return read

        return [make(g) for g in groups]

    def estimated_num_rows(self) -> Optional[int]:
        return len(self.paths)


class BinaryFilesSource(Datasource):
    """Whole files as rows: columns 'bytes' and 'path' (reference
    _internal/datasource/binary_datasource.py)."""

    def __init__(self, paths: Sequence[str], files_per_block: int = 32):
        self.paths = _expand(paths)
        self.files_per_block = files_per_block

    def read_tasks(self) -> List[ReadTask]:
        groups = [
            self.paths[i:i + self.files_per_block]
            for i in range(0, len(self.paths), self.files_per_block)
        ]

        def make(group: List[str]) -> ReadTask:
            def read() -> Block:
                blobs = []
                for p in group:
                    with open(p, "rb") as f:
                        blobs.append(f.read())
                return {
                    "bytes": np.asarray(blobs, dtype=object),
                    "path": np.asarray(group, dtype=object),
                }

            return read

        return [make(g) for g in groups]

    def estimated_num_rows(self) -> Optional[int]:
        return len(self.paths)
