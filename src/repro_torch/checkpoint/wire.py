"""The checkpoint wire format, the port's copy of ``repro/checkpoint/wire.py``.

The multi-writer on-disk protocol: a "writer" writes
``writer_NN/leaf_*.npy`` shards and then atomically publishes
``writer_NN/manifest.json``; a coordinator publishes the step's
``MANIFEST.json`` (``checkpoint/manager.py``).  Both packages write the
same bytes for the same state and writer layout, so a checkpoint of
either restores in the other:

  * ``crc`` / ``shards_crc``: the shard checksum and the partial
    manifest's self-checksum over its canonical-json shard table.
  * ``leaf_wire``: the logical->wire lowering of one leaf.  A dtype that
    ``.npy`` cannot round-trip is written as raw ``uint8`` bytes with the
    logical dtype in the manifest (``{"dtype": "bfloat16", "raw": true}``).
    The JAX package meets bfloat16 as an ml_dtypes array; the port has no
    ml_dtypes and hands a bf16 tensor over as its ``uint16`` view with
    ``dtype="bfloat16"``, which lowers to the same bytes and manifest.
  * ``lift``: the inverse on restore, to the array ``np.load`` can hold
    (bf16 as its ``uint16`` view).
  * ``write_leaf`` / ``publish_partial``: shard persistence and the atomic
    (tmp + ``os.replace``) partial-manifest publish, with fsync barriers
    when durable.

numpy and the standard library only.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

MANIFEST = "MANIFEST.json"          # global (coordinator-published) manifest
PARTIAL_MANIFEST = "manifest.json"  # per-writer partial manifest

# raw logical dtypes the port can lift without ml_dtypes: the numpy view
# that carries their bits
RAW_VIEWS = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8, "float8_e5m2": np.uint8}


def crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def shards_crc(shards: Dict[str, Dict]) -> int:
    """Self-checksum of a partial manifest's shard table (canonical json):
    a torn or garbled manifest write fails it."""
    return crc(json.dumps(shards, sort_keys=True).encode())


def npy_safe(dtype: np.dtype) -> bool:
    """Can the ``.npy`` format round-trip this dtype?  Extension types
    (ml_dtypes' bfloat16, float8_*) save but load back as raw void."""
    return np.dtype(dtype).isbuiltin == 1


def fsync_path(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def leaf_wire(arr: np.ndarray, dtype: Optional[str] = None) -> Tuple[np.ndarray, Dict]:
    """Lower one leaf to its wire form: the ndarray that is ``np.save``d
    and the manifest stub ({shape, dtype[, raw]}) that lifts it back.
    ``dtype`` names the logical dtype when ``arr`` is a view of other bits
    (a bf16 tensor as ``uint16``).  The ``raw`` key is present only for
    raw leaves: key presence is part of the format."""
    dtype = str(arr.dtype) if dtype is None else dtype
    info: Dict = {"shape": list(arr.shape), "dtype": dtype}
    if dtype != str(arr.dtype) or not npy_safe(arr.dtype):
        info["raw"] = True
        arr = np.frombuffer(arr.tobytes(), np.uint8)
    else:
        # force C order WITHOUT np.ascontiguousarray: its contract is
        # ndim >= 1, which would promote 0-d leaves (AdamW's ``step``) to
        # shape (1,) and break restore's shape check
        arr = np.asarray(arr, order="C")
    return arr, info


def lift(arr: np.ndarray, info: Dict) -> np.ndarray:
    """Inverse of :func:`leaf_wire` for a loaded shard: a raw leaf comes
    back as its view dtype (bf16 as ``uint16``) in its logical shape."""
    if not info.get("raw"):
        return arr
    view = RAW_VIEWS.get(info["dtype"])
    if view is None:
        raise NotImplementedError(f"raw dtype {info['dtype']!r} has no torch counterpart here")
    return np.ascontiguousarray(arr).view(view).reshape(info["shape"])


def write_leaf(path: str, wire_arr: np.ndarray, durable: bool = False) -> Tuple[int, int]:
    """Persist one wire-form shard; returns (bytes, crc32) of the on-disk
    ``.npy`` container (the checksum covers container bytes, not payload)."""
    np.save(path, wire_arr)
    with open(path, "rb") as f:
        data = f.read()
    if durable:
        fsync_path(path)
    return len(data), crc(data)


def publish_partial(wdir: str, step: int, writer: int, shards: Dict[str, Dict],
                    durable: bool = False):
    """Atomically publish a writer's partial manifest (tmp + ``os.replace``).
    The gap between the last shard write and this publish is the torn-step
    window the coordinator's quorum gate exists for."""
    partial = {"writer": writer, "step": step, "shards": shards, "crc32": shards_crc(shards)}
    mtmp = os.path.join(wdir, PARTIAL_MANIFEST + ".tmp")
    with open(mtmp, "w") as f:
        json.dump(partial, f, sort_keys=True)
        if durable:
            f.flush()
            os.fsync(f.fileno())
    os.replace(mtmp, os.path.join(wdir, PARTIAL_MANIFEST))
    if durable:
        fsync_path(wdir)
