"""Pure-Python reader for TensorFlow V2 checkpoint bundles (the port's own
copy of audio_style_transfer_tpu/ckpt/bundle_reader.py, which the port does
not import).

The pretrained NSynth weights ship as a TF V2 bundle
(``model.ckpt-200000.index`` + ``model.ckpt-200000.data-00000-of-00001``,
reference nsynth/README.md:29-33).  This module reads that format without
TensorFlow, so checkpoint conversion works on a machine with torch alone:

* the ``.index`` file is a LevelDB-style SSTable ("tensorflow table"):
  256-KiB-target blocks of prefix-compressed key/value records with restart
  arrays, a two-level index, and a fixed 48-byte footer;
* values are ``BundleHeaderProto`` (key "") / ``BundleEntryProto`` records —
  decoded here with a minimal protobuf wire parser (shape, dtype, shard,
  offset, size);
* tensor bytes live at the recorded offsets of the ``.data-*`` shard files.

Only the features TF actually emits for checkpoints are implemented: no
compression (TF writes index blocks uncompressed). The semantics are the JAX
reader's, so both packages read the same bytes the same way: the tensors'
crc32c is not checked, an unknown dtype code reads as float32, and bfloat16
(code 14) comes back as its raw ``uint16`` bits.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from audio_style_transfer_tpu_torch.data.tfrecord import _iter_fields, _read_varint

_FOOTER_SIZE = 48
_TABLE_MAGIC = 0xDB4775248B80FB57

# tensorflow/core/framework/types.proto DataType -> numpy
_DTYPES = {
    1: np.float32,
    2: np.float64,
    3: np.int32,
    4: np.uint8,
    5: np.int16,
    6: np.int8,
    9: np.int64,
    10: np.bool_,
    14: np.uint16,  # bfloat16: numpy has no such type, so its raw bits
    17: np.uint16,
    22: np.uint32,
    23: np.uint64,
}


def _read_block_handle(buf: bytes, pos: int):
    offset, pos = _read_varint(buf, pos)
    size, pos = _read_varint(buf, pos)
    return (offset, size), pos


class _Block:
    """One SSTable block: prefix-compressed records + restart array."""

    def __init__(self, data: bytes):
        (num_restarts,) = struct.unpack("<I", data[-4:])
        self.data = data[: len(data) - 4 * (num_restarts + 1)]

    def items(self):
        data = self.data
        pos = 0
        key = b""
        n = len(data)
        while pos < n:
            shared, pos = _read_varint(data, pos)
            non_shared, pos = _read_varint(data, pos)
            value_len, pos = _read_varint(data, pos)
            key = key[:shared] + data[pos : pos + non_shared]
            pos += non_shared
            value = data[pos : pos + value_len]
            pos += value_len
            yield key, value


def _read_block(raw: bytes, handle) -> _Block:
    offset, size = handle
    block = raw[offset : offset + size]
    # 1-byte compression type + 4-byte crc trailer follows each block
    ctype = raw[offset + size]
    if ctype != 0:  # pragma: no cover - TF writes index files uncompressed
        raise NotImplementedError("compressed checkpoint index blocks")
    return _Block(block)


def read_index(index_path: str) -> dict[str, dict]:
    """Parse a ``.index`` file into {tensor_name: entry dict}.

    Entry keys: dtype (numpy), shape (tuple), shard_id, offset, size.
    """
    with open(index_path, "rb") as f:
        raw = f.read()

    footer = raw[-_FOOTER_SIZE:]
    (magic,) = struct.unpack("<Q", footer[-8:])
    if magic != _TABLE_MAGIC:
        raise IOError(f"{index_path}: not a TensorFlow table (bad magic)")
    # footer: metaindex handle, index handle (varint64 pairs), padding, magic
    pos = 0
    _, pos = _read_block_handle(footer, pos)  # metaindex (unused)
    index_handle, pos = _read_block_handle(footer, pos)

    index_block = _read_block(raw, index_handle)

    entries: dict[str, dict] = {}
    for _, handle_bytes in index_block.items():
        handle, _ = _read_block_handle(handle_bytes, 0)
        for key, value in _read_block(raw, handle).items():
            name = key.decode("utf-8", "replace")
            if name == "":
                continue  # BundleHeaderProto
            entries[name] = _parse_bundle_entry(value)
    return entries


def _parse_bundle_entry(buf: bytes) -> dict:
    """BundleEntryProto: dtype=1, shape=2, shard_id=3, offset=4, size=5, crc=6."""
    entry = {
        "dtype": np.float32,
        "shape": (),
        "shard_id": 0,
        "offset": 0,
        "size": 0,
    }
    for field, wire, value in _iter_fields(buf):
        if field == 1:
            entry["dtype"] = _DTYPES.get(value, np.float32)
        elif field == 2:  # TensorShapeProto { repeated Dim dim = 2 {size=1} }
            dims = []
            for f2, _, v2 in _iter_fields(value):
                if f2 == 2:
                    for f3, _, v3 in _iter_fields(v2):
                        if f3 == 1:
                            dims.append(v3)
            entry["shape"] = tuple(dims)
        elif field == 3:
            entry["shard_id"] = value
        elif field == 4:
            entry["offset"] = value
        elif field == 5:
            entry["size"] = value
    return entry


class BundleReader:
    """TF-free reader over a checkpoint prefix (e.g. ``.../model.ckpt-200000``)."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        index_path = prefix + ".index"
        if not os.path.exists(index_path):
            raise FileNotFoundError(index_path)
        self.entries = read_index(index_path)
        self._num_shards = 1 + max(
            (e["shard_id"] for e in self.entries.values()), default=0
        )

    def _shard_path(self, shard_id: int) -> str:
        return f"{self.prefix}.data-{shard_id:05d}-of-{self._num_shards:05d}"

    def get_variable_to_shape_map(self) -> dict[str, tuple]:
        return {name: e["shape"] for name, e in self.entries.items()}

    def get_tensor(self, name: str) -> np.ndarray:
        entry = self.entries[name]
        with open(self._shard_path(entry["shard_id"]), "rb") as f:
            f.seek(entry["offset"])
            buf = f.read(entry["size"])
        arr = np.frombuffer(buf, dtype=entry["dtype"])
        return arr.reshape(entry["shape"])
