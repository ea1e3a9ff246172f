"""A minimal writer of TensorFlow V2 checkpoint bundles, without TensorFlow.

Test and smoke-run infrastructure: it makes the bundles that
``ckpt/convert.py::convert_tf1_checkpoint`` reads, on a machine where
TensorFlow is not installed. No CLI uses it and ``ckpt`` does not export it.

    from audio_style_transfer_tpu_torch.tools.tf1_bundle import nsynth_variables, write_bundle
    write_bundle(prefix, nsynth_variables(params))

writes ``<prefix>.index`` and ``<prefix>.data-00000-of-00001`` in the layout
TF's ``BundleWriter`` gives them:

* the ``.index`` is a LevelDB-style table: data blocks of the sorted keys,
  prefix-compressed, with a restart point every 16 keys, each block followed
  by its type byte (0: uncompressed) and the masked crc32c of both; an empty
  metaindex block; an index block (a restart point every key) holding each
  data block's last key and handle; the 48-byte footer with the magic;
* key ``""`` holds the ``BundleHeaderProto`` (one shard, little-endian,
  version 1), every other key a tensor's ``BundleEntryProto`` (dtype, shape,
  offset and size in the one data shard, and with ``crc=True`` the masked
  crc32c of its bytes).

TF's reader checks each tensor's crc32c; the port's reader, like the JAX
package's, never reads it. The crc is pure Python (about 10 MB/s), so a
full-size bundle of 247 MB is written with ``crc=False`` where only the
port reads it.
"""

from __future__ import annotations

import struct

import numpy as np

from audio_style_transfer_tpu_torch.data.tfrecord import _write_varint, masked_crc32c

_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER_SIZE = 48
BLOCK_SIZE = 262144  # TF's table::Options().block_size
_RESTART_INTERVAL = 16

# numpy dtype name -> tensorflow/core/framework/types.proto DataType
_CODES = {"float32": 1, "float64": 2, "int32": 3, "uint8": 4, "int16": 5, "int8": 6,
          "int64": 9, "bool": 10, "bfloat16": 14, "uint16": 17, "uint32": 22, "uint64": 23}


def _varint_field(field: int, value: int) -> bytes:
    return _write_varint(field << 3) + _write_varint(value)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _write_varint(field << 3 | 2) + _write_varint(len(data)) + data


def _entry_proto(arr: np.ndarray, offset: int, crc: bool) -> bytes:
    """BundleEntryProto: dtype=1, shape=2 (TensorShapeProto.dim=2, Dim.size=1),
    shard_id=3 (0, left out), offset=4, size=5, crc32c=6 (fixed32)."""
    shape = b"".join(_bytes_field(2, _varint_field(1, d)) for d in arr.shape)
    out = _varint_field(1, _CODES[arr.dtype.name]) + _bytes_field(2, shape)
    if offset:
        out += _varint_field(4, offset)
    out += _varint_field(5, arr.nbytes)
    if crc:
        out += _write_varint(6 << 3 | 5) + struct.pack("<I", masked_crc32c(arr.tobytes()))
    return out


def _block(items: list[tuple[bytes, bytes]], restart_interval: int) -> bytes:
    """Prefix-compressed records (shared, non-shared and value lengths as
    varints, the key's suffix, the value), then the restart offsets and
    their count as little-endian uint32."""
    out, restarts, last = bytearray(), [], b""
    for i, (key, value) in enumerate(items):
        shared = 0
        if i % restart_interval == 0:
            restarts.append(len(out))
        else:
            while shared < min(len(last), len(key)) and last[shared] == key[shared]:
                shared += 1
        out += (_write_varint(shared) + _write_varint(len(key) - shared)
                + _write_varint(len(value)) + key[shared:] + value)
        last = key
    restarts = restarts or [0]
    return bytes(out) + struct.pack(f"<{len(restarts) + 1}I", *restarts, len(restarts))


def _put_block(f, block: bytes) -> bytes:
    """Write ``block`` and its trailer; return its handle (offset, size as varints)."""
    handle = _write_varint(f.tell()) + _write_varint(len(block))
    f.write(block + b"\0" + struct.pack("<I", masked_crc32c(block + b"\0")))
    return handle


def write_bundle(prefix: str, tensors: dict[str, np.ndarray], crc: bool = True,
                 block_size: int = BLOCK_SIZE) -> None:
    """Write ``tensors`` ({name: array}) as the bundle ``prefix``."""
    arrays = {name.encode(): np.asarray(tensors[name], order="C") for name in tensors}
    # BundleHeaderProto: num_shards=1, endianness=2 (LITTLE: 0, left out),
    # version=3 (VersionDef.producer=1).
    items = [(b"", _varint_field(1, 1) + _bytes_field(3, _varint_field(1, 1)))]
    offset = 0
    with open(f"{prefix}.data-00000-of-00001", "wb") as f:
        for key in sorted(arrays):
            arr = arrays[key]
            if arr.dtype.byteorder == ">":
                raise ValueError(f"{key!r}: big-endian arrays are not written")
            f.write(arr.reshape(-1).view(np.uint8))
            items.append((key, _entry_proto(arr, offset, crc)))
            offset += arr.nbytes
    with open(f"{prefix}.index", "wb") as f:
        index, pending, size = [], [], 0
        for key, value in items:
            pending.append((key, value))
            size += len(key) + len(value) + 3
            if size >= block_size:
                index.append((key, _put_block(f, _block(pending, _RESTART_INTERVAL))))
                pending, size = [], 0
        if pending:
            index.append((pending[-1][0], _put_block(f, _block(pending, _RESTART_INTERVAL))))
        meta = _put_block(f, _block([], 1))
        handles = meta + _put_block(f, _block(index, 1))
        f.write(handles + b"\0" * (_FOOTER_SIZE - 8 - len(handles))
                + struct.pack("<Q", _TABLE_MAGIC))


def nsynth_variables(params: dict) -> dict[str, np.ndarray]:
    """The port's params as the reference checkpoint names them:
    ``<layer>/W`` [1, F, Cin, Cout] and ``<layer>/biases``, float32."""
    out = {}
    for layer, entry in params.items():
        out[f"{layer}/W"] = entry["w"].detach().cpu().numpy()[None]
        out[f"{layer}/biases"] = entry["b"].detach().cpu().numpy()
    return out
