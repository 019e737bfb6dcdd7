"""Sharded checkpointing: multi-writer, quorum-published, crc-verified.

Counterpart of ``repro/checkpoint/manager.py``, writing the same format
(``checkpoint/wire.py``; docs/DESIGN.md §3, §7), so a step directory the
port writes is byte-identical, file for file, to the one the JAX package
writes for the same state and writer layout, and either package restores
the other's checkpoints:

  * **Leaf names** follow JAX's key paths: dict keys (sorted), list and
    tuple indices, and NamedTuple fields with a leading dot, joined by
    "/" with each segment %-escaped (``opt_state/.mu/blocks/attn/wq``,
    ``opt_state/.step``).  The port's ``AdamState`` is a NamedTuple with
    the JAX fields, so the two optimizer states carry the same names.
  * **Writer group**: a save fans out over ``writers`` logical writers,
    each persisting its shards into ``step_K.tmp/writer_KK/`` and then
    atomically publishing a partial manifest (file, shape, logical dtype,
    byte length and crc32 per shard, plus a self-checksum).  Unpinned
    shards are byte-balanced over the group (:func:`partition_shards`).
  * **Two-phase quorum publish**: the coordinator re-reads every partial
    manifest from disk, and only with ``quorum`` of them verified AND
    every shard covered writes the global ``MANIFEST.json`` and renames
    ``step_K.tmp/`` to ``step_K/``.  A writer that dies between its shard
    writes and its manifest (the ``writer_fault`` window) leaves swept
    debris that :meth:`CheckpointManager.all_steps` never lists.
  * **Integrity**: restore checks every shard's byte length and crc32
    against the manifest before its bytes become a tensor, and raises
    :class:`CheckpointCorruptionError` naming the file.
  * **Global leaves**: a leaf is saved whole.  ``placements`` on restore
    (the counterpart of JAX's ``shardings``) maps each global leaf to what
    this process keeps, so a checkpoint written on one card restores as a
    grid rank's blocks and the other way round (``checkpoint/grid.py``).
  * **Tolerant listing**: foreign files, ``.tmp`` debris and half-deleted
    steps are skipped, never fatal; GC renames a step out of the
    namespace before deleting it.

A leaf of the saved state is a tensor (any device), a numpy array or
scalar, or a zero-argument callable returning one: the grid's global
leaves are made one at a time that way, so no second copy of the whole
state exists on the card.  bf16 crosses as its ``uint16`` bits
(``wire.leaf_wire``): no ml_dtypes.

Asynchronous path (:class:`AsyncCheckpointManager`): ``save_async`` runs
only the device->host snapshot on the caller's thread, into a reusable
staging arena of host buffers (pinned for card tensors), and a background
coordinator thread writes and publishes.  The arena copy is needed for
correctness: the port's AdamW updates parameters and moments in place
(the torch analogue of JAX's donated buffers), so the snapshot must own
its bytes before ``save_async`` returns.  ``max_inflight`` slots bound
host memory; acquiring one blocks while every slot holds an unwritten
snapshot (backpressure).  Writer failures are sticky and surface on the
next ``save_async`` / ``check_error`` / ``wait_until_finished``;
``abort`` fences the writer group (queued snapshots dropped, in-flight
writers interrupted between shards, ``.tmp`` swept, the error cleared).

Writer processes (``writer_procs``; ``runtime/procs.py``,
docs/DESIGN.md §9): each logical writer runs in its own OS process of a
:class:`~repro_torch.runtime.procs.WriterFleet`, fed the snapshot's wire
bytes through a shared handover arena, watched by heartbeat leases
(``writer_timeout``); a dead, hung or corrupting writer's range is
reassigned to a survivor (``reassign`` per save) and the commit
criterion is the quorum gate's own disk verification.  A fleet save
publishes the thread writers' step directory byte for byte; after a
reassignment the global manifest also records ``reassigned``
({writer: why}).  ``proc_fault(step, writer)`` is the process-level
injection hook.  ``abort`` fences the fleet (SIGKILL, reap, scratch
swept) before it sweeps the debris; the next save respawns it.
"""

from __future__ import annotations

import io
import json
import os
import queue
import re
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import wire

_WRITE_POOL: Optional[ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()

_STEP_RE = re.compile(r"^step_(\d{8})$")
MANIFEST = wire.MANIFEST
PARTIAL_MANIFEST = wire.PARTIAL_MANIFEST
_FLEET_DIR = ".fleet"               # the writer fleet's scratch (runtime/procs.py)


def _write_pool() -> ThreadPoolExecutor:
    """Shared pool the writer group runs on (``np.save``, the crc read-back
    and the file writes release the GIL)."""
    global _WRITE_POOL
    with _POOL_LOCK:
        if _WRITE_POOL is None:
            _WRITE_POOL = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 2),
                                             thread_name_prefix="ckpt-write")
        return _WRITE_POOL


def _escape(segment: str) -> str:
    """%-escape a path segment so joined names are collision-free (a dict
    key holding "/" must not alias a nested path)."""
    return segment.replace("%", "%25").replace("/", "%2F")


def _walk(tree, fn, prefix: Tuple[str, ...] = ()):
    """Rebuild ``tree`` with ``fn(name, leaf)`` at each leaf, visiting
    leaves in JAX's flatten order: dict keys sorted, sequences by index,
    NamedTuple fields in order (named ``.field``); None holds no leaf."""
    if isinstance(tree, dict):
        return {k: _walk(tree[k], fn, prefix + (str(k),)) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(v, fn, prefix + ("." + f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, prefix + (str(i),)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn("/".join(_escape(s) for s in prefix), tree)


def _leaf_paths(tree) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    _walk(tree, lambda name, leaf: out.__setitem__(name, leaf))
    return out


def _as_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(numpy view of a CPU tensor, logical dtype): bf16 and float8 as the
    unsigned integers that carry their bits."""
    name = str(t.dtype).split(".")[-1]
    if name in wire.RAW_VIEWS:
        view = wire.RAW_VIEWS[name]
        signed = torch.int16 if view == np.uint16 else torch.int8
        return t.view(signed).numpy().view(view), name
    arr = t.numpy()
    return arr, str(arr.dtype)


def _load_npy(data: bytearray) -> np.ndarray:
    """``np.load`` without a copy: the array aliases ``data`` (writable, so
    ``torch.from_numpy`` can take it)."""
    head = io.BytesIO(bytes(memoryview(data)[:1 << 17]))
    version = np.lib.format.read_magic(head)
    read = {(1, 0): np.lib.format.read_array_header_1_0,
            (2, 0): np.lib.format.read_array_header_2_0}[version]
    shape, fortran, dtype = read(head)
    count = int(np.prod(shape, dtype=np.int64))
    arr = np.frombuffer(data, dtype=dtype, count=count, offset=head.tell())
    return arr.reshape(shape, order="F" if fortran else "C")


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype in wire.RAW_VIEWS:
        signed = np.int16 if arr.dtype == np.uint16 else np.int8
        return torch.from_numpy(arr.view(signed)).view(getattr(torch, dtype))
    return torch.from_numpy(arr)


class CheckpointCorruptionError(RuntimeError):
    """A shard file or manifest failed integrity verification on restore;
    the message names the offending file."""


class QuorumError(RuntimeError):
    """The coordinator could not assemble a publishable step: fewer than
    ``quorum`` partial manifests verified, or a shard is uncovered (a
    writer died between its shard writes and its manifest publish)."""


class _Aborted(Exception):
    """Internal: a mid-write save was interrupted by :meth:`abort`."""


def partition_shards(sizes: Dict[str, int], n_writers: int,
                     writer_map: Optional[Callable[[str], Optional[int]]] = None
                     ) -> Dict[str, int]:
    """Deterministic shard -> writer assignment: ``writer_map(name)`` pins a
    shard to a writer; the rest are greedily byte-balanced, largest first.
    A pure function of (names, sizes), so sync and async saves of one
    state lay out identically."""
    assert n_writers >= 1
    owner: Dict[str, int] = {}
    load = [0] * n_writers
    free: List[str] = []
    for name in sorted(sizes):
        w = writer_map(name) if writer_map is not None else None
        if w is not None and 0 <= int(w) < n_writers:
            owner[name] = int(w)
            load[int(w)] += sizes[name]
        else:
            free.append(name)
    for name in sorted(free, key=lambda n: (-sizes[n], n)):
        w = min(range(n_writers), key=lambda i: (load[i], i))
        owner[name] = w
        load[w] += sizes[name]
    return owner


def manifest_complete(step_dir: str) -> bool:
    """Does ``step_dir`` hold a parseable, complete global manifest?  Never
    raises: torn json, a missing file or a non-dict body (a foreign file
    on the name) all mean "not a restorable step"."""
    try:
        with open(os.path.join(step_dir, MANIFEST)) as f:
            meta = json.load(f)
        return isinstance(meta, dict) and bool(meta.get("complete"))
    except (OSError, ValueError):
        return False


def read_step(directory: str, step: int, template, placements=None, verify: bool = True):
    """Restore step ``step`` of ``directory`` into the structure of
    ``template``.  With ``verify`` every shard's byte length and crc32 are
    checked before its bytes become a tensor.  Each global leaf arrives as
    a CPU tensor; ``placements`` (a tree matching ``template``, of
    callables) maps it to what this process keeps, else it goes to the
    template leaf's device.  The result must have the template leaf's
    shape.  Reads only: safe while another process owns the directory."""
    d = os.path.join(directory, f"step_{step:08d}")
    try:
        with open(os.path.join(d, MANIFEST)) as f:
            meta = json.load(f)
    except FileNotFoundError as e:
        raise FileNotFoundError(f"step {step} in {directory} has no global manifest: torn "
                                f"or half-deleted step") from e
    except ValueError as e:
        raise CheckpointCorruptionError(f"global manifest {os.path.join(d, MANIFEST)} is not "
                                        f"valid JSON: {e}") from e
    if not isinstance(meta, dict) or not meta.get("complete"):
        raise CheckpointCorruptionError(f"global manifest of step {step} is not marked "
                                        f"complete: refusing a sub-quorum restore")
    place = _leaf_paths(placements) if placements is not None else {}

    def load(name, leaf):
        info = meta["manifest"][name]
        path = os.path.join(d, info["file"])
        with open(path, "rb") as f:
            data = bytearray(os.fstat(f.fileno()).st_size)
            n = f.readinto(data)
        del data[n:]
        if verify:
            if len(data) != info["bytes"]:
                raise CheckpointCorruptionError(
                    f"checkpoint shard {path} (leaf {name!r}) is truncated: {len(data)}B on "
                    f"disk, manifest records {info['bytes']}B; refusing to load")
            got = wire.crc(data)
            if got != info["crc32"]:
                raise CheckpointCorruptionError(
                    f"checkpoint shard {path} (leaf {name!r}) failed crc32 verification: "
                    f"file 0x{got:08x} != manifest 0x{info['crc32']:08x}; refusing to load "
                    f"a corrupted shard")
        host = _to_tensor(wire.lift(_load_npy(data), info), info["dtype"])
        if name in place:
            out = place[name](host)
        else:
            out = host.to(leaf.device) if isinstance(leaf, torch.Tensor) else host
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
        if tuple(out.shape) != tuple(want):
            raise ValueError(f"{name}: checkpoint gives {tuple(out.shape)}, template "
                             f"{tuple(want)}")
        return out

    return _walk(template, load)


class CheckpointManager:
    """Synchronous multi-writer checkpointing (the blocking path).

    ``writers`` logical writers persist disjoint shard sets in parallel;
    ``quorum`` (default: all) partial manifests must verify before the
    coordinator publishes.  ``verify`` checks every shard's length and
    crc32 on restore.  ``writer_map`` pins shards to writers;
    ``writer_fault(step, writer)`` is a fault-injection hook called
    between a writer's shard writes and its partial-manifest publish.
    ``durable`` fsyncs every shard, both manifest tiers and the
    directories around the atomic publish.  ``writer_procs`` runs the
    writers as processes (module docstring) with a ``writer_timeout``
    lease, ``reassign`` reassignments per save and the ``proc_fault``
    hook.  ``writes`` logs each published save: step, seconds on the host
    clock (start, end) and the bytes on disk."""

    def __init__(self, directory: str, keep: int = 3, *, durable: bool = False,
                 writers: int = 1, quorum: Optional[int] = None, verify: bool = True,
                 writer_map: Optional[Callable[[str], Optional[int]]] = None,
                 writer_fault: Optional[Callable[[int, int], None]] = None,
                 writer_procs: bool = False, writer_timeout: float = 5.0,
                 reassign: int = 1,
                 proc_fault: Optional[Callable[[int, int], Optional[Dict]]] = None):
        assert writers >= 1, f"writers={writers} must be >= 1"
        assert writer_timeout > 0, f"writer_timeout={writer_timeout} must be > 0"
        assert reassign >= 0, f"reassign={reassign} must be >= 0"
        self.dir = directory
        self.keep = keep
        self.durable = durable
        self.writers = writers
        self.quorum = writers if quorum is None else quorum
        assert 1 <= self.quorum <= writers, (
            f"quorum={self.quorum} must be in [1, writers={writers}]")
        self.verify = verify
        self.writer_map = writer_map
        self.writer_fault = writer_fault
        self.writer_procs = writer_procs
        self.writer_timeout = writer_timeout
        self.reassign = reassign
        self.proc_fault = proc_fault
        self._fleet = None
        self.writes: List[Dict] = []
        os.makedirs(directory, exist_ok=True)
        self._clean_stale_tmp()

    def _clean_stale_tmp(self):
        """Sweep torn debris of a dead incarnation: ``step_K.tmp/``,
        published-namespace steps without a complete global manifest, and
        the writer fleet's scratch (heartbeats and spill files of a killed
        coordinator, whose orphaned children exit by themselves).  Safe
        only while no writer is active against this directory (at
        construction, after an abort, which fences the fleet first)."""
        for d in os.listdir(self.dir):
            p = os.path.join(self.dir, d)
            if (d.startswith("step_") and d.endswith(".tmp")) or d == _FLEET_DIR:
                shutil.rmtree(p, ignore_errors=True)
            elif _STEP_RE.match(d) and os.path.isdir(p) and not manifest_complete(p):
                shutil.rmtree(p, ignore_errors=True)

    # ------------------------------------------------------------------
    def save(self, step: int, state, extra_meta: Optional[Dict] = None) -> str:
        """Blocking save: snapshot, fan out the writer group and publish."""
        return self._write(step, self._snapshot_host(state), extra_meta)

    def _snapshot_host(self, state, slot: Optional[Dict] = None):
        """Host snapshot of every leaf, in name order: {name: (numpy array,
        logical dtype)}.  With a ``slot`` (the async staging arena) the
        bytes are copied into the slot's reusable buffers (pinned for card
        tensors; one synchronisation at the end), so the snapshot owns them
        when this returns; without one a CPU leaf may be aliased (the
        blocking path writes before returning)."""
        snap = {}
        on_card = False
        for name, leaf in _leaf_paths(state).items():
            if callable(leaf):
                leaf = leaf()
            if isinstance(leaf, torch.Tensor):
                t = leaf.detach()
                if slot is None:
                    snap[name] = _as_numpy(t.cpu())
                    continue
                pin = t.is_cuda
                buf = slot.get(name)
                if (not isinstance(buf, tuple) or buf[1] != pin or buf[0].shape != t.shape
                        or buf[0].dtype != t.dtype):
                    slot[name] = buf = (torch.empty(t.shape, dtype=t.dtype, pin_memory=pin), pin)
                buf[0].copy_(t, non_blocking=pin)
                on_card |= pin
                snap[name] = _as_numpy(buf[0])
            else:
                arr = np.asarray(leaf)
                if slot is not None:
                    buf = slot.get(name)
                    if (not isinstance(buf, np.ndarray) or buf.shape != arr.shape
                            or buf.dtype != arr.dtype):
                        slot[name] = buf = np.empty(arr.shape, arr.dtype)
                    np.copyto(buf, arr)
                    arr = buf
                snap[name] = (arr, str(arr.dtype))
        if on_card:
            torch.cuda.synchronize()
        return snap

    # -- writer side (phase 1: shards + partial manifest) ---------------
    def _run_writer(self, tmp: str, step: int, writer: int, names: List[str],
                    snap: Dict[str, Tuple[np.ndarray, str]], abort_check) -> Dict[str, Dict]:
        """One logical writer: persist ``names`` into ``writer_KK/``, then
        atomically publish the partial manifest.  ``writer_fault`` injects
        death in the gap between the two (the torn-step window)."""
        wtag = f"writer_{writer:02d}"
        wdir = os.path.join(tmp, wtag)
        os.makedirs(wdir, exist_ok=True)
        shards: Dict[str, Dict] = {}
        for i, name in enumerate(names):
            if abort_check is not None and abort_check():
                raise _Aborted(step)
            wire_arr, info = wire.leaf_wire(*snap[name])
            info["bytes"], info["crc32"] = wire.write_leaf(
                os.path.join(wdir, f"leaf_{i:05d}.npy"), wire_arr, self.durable)
            info["file"] = f"{wtag}/leaf_{i:05d}.npy"
            info["writer"] = writer
            shards[name] = info
        # >>> shards on disk; partial manifest NOT yet published <<<
        if self.writer_fault is not None:
            self.writer_fault(step, writer)
        if abort_check is not None and abort_check():
            raise _Aborted(step)
        wire.publish_partial(wdir, step, writer, shards, self.durable)
        return shards

    # -- coordinator side (phase 2: verify quorum, publish) --------------
    def _verify_partial(self, tmp: str, step: int, writer: int) -> Dict[str, Dict]:
        """Re-read one partial manifest from disk and verify it: parseable,
        its self-checksum, its (step, writer) identity, and every listed
        shard present with the recorded byte length."""
        path = os.path.join(tmp, f"writer_{writer:02d}", PARTIAL_MANIFEST)
        try:
            with open(path) as f:
                partial = json.load(f)
        except (OSError, ValueError) as e:
            raise QuorumError(f"writer {writer} partial manifest {path} unreadable: "
                              f"{type(e).__name__}: {e}") from e
        shards = partial.get("shards", {})
        if partial.get("crc32") != wire.shards_crc(shards):
            raise QuorumError(f"writer {writer} partial manifest {path} failed its "
                              f"self-checksum: torn manifest write")
        if partial.get("step") != step or partial.get("writer") != writer:
            raise QuorumError(f"{path} identifies as step {partial.get('step')} writer "
                              f"{partial.get('writer')}, expected step {step} writer {writer}")
        for name, info in shards.items():
            fpath = os.path.join(tmp, info["file"])
            try:
                size = os.stat(fpath).st_size
            except OSError as e:
                raise QuorumError(f"shard {fpath} (leaf {name!r}) listed by writer {writer} "
                                  f"is missing: {e}") from e
            if size != info["bytes"]:
                raise QuorumError(f"shard {fpath} (leaf {name!r}) is {size}B on disk, writer "
                                  f"{writer} manifest records {info['bytes']}B")
        return shards

    def _fan_out_threads(self, tmp: str, step: int, groups: List[List[str]], snap,
                         abort_check) -> Dict[int, BaseException]:
        """Phase 1: run the writer group on the shared write pool; returns
        the per-writer failures (empty: all committed)."""
        futs = [_write_pool().submit(self._run_writer, tmp, step, w, groups[w], snap,
                                     abort_check)
                for w in range(self.writers)]
        failures: Dict[int, BaseException] = {}
        for w, fut in enumerate(futs):
            try:
                fut.result()
            except BaseException as e:
                failures[w] = e
        return failures

    def fleet(self):
        """The writer fleet of a ``writer_procs`` manager (made on first use)."""
        from repro_torch.runtime.procs import WriterFleet
        if self._fleet is None:
            self._fleet = WriterFleet(self.dir, self.writers, timeout=self.writer_timeout,
                                      reassign=self.reassign)
        return self._fleet

    def _fan_out_procs(self, tmp: str, step: int, groups: List[List[str]], snap,
                       abort_check) -> Tuple[Dict[int, BaseException], Dict[int, str]]:
        """Phase 1 on the writer processes: the fleet supervises the save
        and reassigns orphaned ranges; its commit criterion is the quorum
        gate's disk verification (``verify``), so a writer that corrupted a
        shard after checksumming it is reassigned like a dead one."""
        from repro_torch.runtime.procs import FleetAborted
        try:
            failed, reassigned = self.fleet().run_save(
                tmp, step, groups, snap, durable=self.durable, fault_for=self.proc_fault,
                verify=lambda w: self._verify_partial(tmp, step, w), abort_check=abort_check)
        except FleetAborted:
            raise _Aborted(step) from None
        return {w: RuntimeError(why) for w, why in failed.items()}, reassigned

    def quorum_gate(self, tmp: str, step: int, names: List[str],
                    failures: Dict[int, BaseException]) -> Dict[int, Dict[str, Dict]]:
        """Phase 2 gate: re-verify every surviving writer's partial manifest
        from disk, then demand quorum AND full shard coverage; raises
        :class:`QuorumError` on a torn step."""
        verified: Dict[int, Dict[str, Dict]] = {}
        for w in range(self.writers):
            if w not in failures:
                verified[w] = self._verify_partial(tmp, step, w)
        covered = set()
        for shards in verified.values():
            covered.update(shards)
        missing = [n for n in names if n not in covered]
        if len(verified) < self.quorum or missing:
            why = "; ".join(f"writer {w}: {type(e).__name__}: {e}"
                            for w, e in sorted(failures.items())) or "no writer died"
            raise QuorumError(f"step {step} torn: {len(verified)}/{self.writers} partial "
                              f"manifests verified (quorum {self.quorum}), {len(missing)} "
                              f"shards uncovered — {why}")
        return verified

    def _publish(self, tmp: str, final: str, step: int, verified: Dict[int, Dict[str, Dict]],
                 failures: Dict[int, BaseException], reassigned: Dict[int, str],
                 extra_meta: Optional[Dict] = None) -> str:
        """Phase 2 publish: the global manifest (tmp + ``os.replace``), then
        the step directory's atomic rename.  ``reassigned`` is recorded only
        when not empty, so a clean fleet save is a thread save's bytes."""
        manifest: Dict[str, Dict] = {}
        for w in sorted(verified):
            manifest.update(verified[w])
        meta = {"step": step, "writers": self.writers, "quorum": self.quorum,
                "committed": sorted(verified), "failed_writers": sorted(failures),
                "complete": True, "manifest": manifest, **(extra_meta or {})}
        if reassigned:
            meta["reassigned"] = {str(w): why for w, why in sorted(reassigned.items())}
        gtmp = os.path.join(tmp, MANIFEST + ".tmp")
        with open(gtmp, "w") as f:
            json.dump(meta, f, sort_keys=True)
            if self.durable:
                f.flush()
                os.fsync(f.fileno())
        os.replace(gtmp, os.path.join(tmp, MANIFEST))
        if self.durable:                    # data durable BEFORE the publish
            wire.fsync_path(tmp)
        os.replace(tmp, final)              # atomic publish
        if self.durable:
            wire.fsync_path(self.dir)
        return final

    def _write(self, step: int, snap, extra_meta: Optional[Dict] = None,
               abort_check=None) -> str:
        t0 = time.perf_counter()
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        try:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            names = sorted(snap)
            owner = partition_shards({n: snap[n][0].nbytes for n in names}, self.writers,
                                     self.writer_map)
            groups = [[n for n in names if owner[n] == w] for w in range(self.writers)]
            reassigned: Dict[int, str] = {}
            if self.writer_procs:
                failures, reassigned = self._fan_out_procs(tmp, step, groups, snap,
                                                           abort_check)
            else:
                failures = self._fan_out_threads(tmp, step, groups, snap, abort_check)
            if any(isinstance(e, _Aborted) for e in failures.values()):
                raise _Aborted(step)
            verified = self.quorum_gate(tmp, step, names, failures)
            self._publish(tmp, final, step, verified, failures, reassigned, extra_meta)
        except BaseException:
            # writer death, quorum miss, abort: the torn step is never observable
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self.writes.append({"step": step, "start": t0, "end": time.perf_counter(),
                            "bytes": sum(i["bytes"] for v in verified.values()
                                         for i in v.values())})
        self._gc()
        return final

    def _retire(self, s: int):
        """Rename step ``s`` out of the published namespace, then delete it,
        so a kill mid-rmtree leaves sweepable debris, never a half-step."""
        src = os.path.join(self.dir, f"step_{s:08d}")
        dst = src + ".gc.tmp"
        try:
            os.replace(src, dst)
        except OSError:                     # e.g. a concurrent GC won the rename
            dst = src
        shutil.rmtree(dst, ignore_errors=True)

    def _gc(self):
        """Retire steps beyond ``keep``."""
        for s in self.all_steps()[:-self.keep]:
            self._retire(s)

    def all_steps(self) -> List[int]:
        """Restorable steps only: published (never ``.tmp``) with a complete
        global manifest."""
        try:
            entries = os.listdir(self.dir)
        except FileNotFoundError:
            return []
        out = []
        for d in entries:
            m = _STEP_RE.match(d)
            p = os.path.join(self.dir, d)
            if m and os.path.isdir(p) and manifest_complete(p):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def retire_steps_after(self, step: int) -> List[int]:
        """Retire every published step > ``step`` (the divergence-rollback
        hook: a step saved from poisoned state); returns them."""
        retired = [s for s in self.all_steps() if s > step]
        for s in retired:
            self._retire(s)
        return retired

    # the async surface, trivially satisfied here, so the training loop
    # treats both managers alike
    def save_async(self, step: int, state, extra_meta: Optional[Dict] = None) -> None:
        """On the blocking manager, :meth:`save`."""
        self.save(step, state, extra_meta)

    def wait_until_finished(self):
        pass

    def check_error(self):
        pass

    def abort(self):
        """Fence the writer fleet (when one runs), then sweep torn-step
        debris; the next save respawns the fleet."""
        if self._fleet is not None:
            self._fleet.fence()
        self._clean_stale_tmp()

    def close(self):
        """Shut the writer fleet down (when one runs)."""
        if self._fleet is not None:
            self._fleet.close()
            self._fleet = None

    # ------------------------------------------------------------------
    def restore(self, template, step: Optional[int] = None,
                placements=None) -> Tuple[Any, int]:
        """Restore the newest complete step (or ``step``) into the structure
        of ``template``: :func:`read_step` with this manager's ``verify``.
        Returns (tree, step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return read_step(self.dir, step, template, placements, self.verify), step


class AsyncCheckpointManager(CheckpointManager):
    """Non-blocking checkpointing: snapshot at the step boundary, writer
    group and quorum publish on a background coordinator thread."""

    def __init__(self, directory: str, keep: int = 3, *, max_inflight: int = 2,
                 staging: str = "host", **kw):
        super().__init__(directory, keep, **kw)
        assert staging in ("host", "sync"), staging
        assert max_inflight >= 1, max_inflight
        self.staging = staging
        self._free: "queue.Queue[Dict]" = queue.Queue()
        for _ in range(max_inflight):
            self._free.put({})                   # arena slot: name -> buffer
        self._work: "queue.Queue" = queue.Queue()
        self._cv = threading.Condition()
        self._inflight = 0
        self._error: Optional[BaseException] = None
        self._abort = threading.Event()
        self._closed = False
        self._thread = threading.Thread(target=self._writer_loop, name="ckpt-writer",
                                        daemon=True)
        self._thread.start()

    def save_async(self, step: int, state, extra_meta: Optional[Dict] = None) -> None:
        """Snapshot ``state`` into a staging slot and return; the coordinator
        thread writes and publishes.  Blocks for the device->host copy, or
        while every slot holds an unwritten snapshot.  Raises a prior
        writer-group error."""
        self.check_error()
        if self.staging == "sync" or self._closed:
            self.save(step, state, extra_meta)
            return
        slot = self._free.get()                  # backpressure point
        try:
            snap = self._snapshot_host(state, slot)
        except BaseException:
            self._free.put(slot)
            raise
        with self._cv:
            self._inflight += 1
        self._work.put((step, slot, snap, extra_meta))

    def _writer_loop(self):
        while True:
            item = self._work.get()
            if item is None:
                return
            step, slot, snap, extra_meta = item
            try:
                if not self._abort.is_set():
                    self._write(step, snap, extra_meta, abort_check=self._abort.is_set)
            except _Aborted:
                pass                             # _write swept its debris
            except BaseException as e:           # sticky: surfaced to the caller
                if self._error is None:
                    self._error = e
            finally:
                self._free.put(slot)
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    @property
    def inflight(self) -> int:
        """Snapshots taken and not yet written (or failed)."""
        with self._cv:
            return self._inflight

    def _drain(self):
        with self._cv:
            while self._inflight > 0:
                self._cv.wait()

    def wait_until_finished(self):
        """Drain every queued and in-flight save, then surface writer errors."""
        self._drain()
        self.check_error()

    def check_error(self):
        """Re-raise the first writer-group failure (sticky)."""
        if self._error is not None:
            raise RuntimeError(f"async checkpoint writer failed: {self._error!r}") \
                from self._error

    def abort(self):
        """Fence the writer group: drop queued snapshots, interrupt in-flight
        writers between shards (writer processes are SIGKILLed and reaped),
        sweep ``.tmp`` debris and clear the sticky error.  Published
        checkpoints are untouched."""
        self._abort.set()
        if self._fleet is not None:
            self._fleet.fence()
        self._drain()
        self._abort.clear()
        self._error = None
        self._clean_stale_tmp()

    def close(self):
        """Drain (without raising), stop the coordinator thread and shut the
        writer fleet down."""
        if self._closed:
            return
        self._drain()
        self._closed = True
        self._work.put(None)
        self._thread.join(timeout=60)
        super().close()


def make_manager(directory: str, ccfg=None, *,
                 writer_map: Optional[Callable[[str], Optional[int]]] = None,
                 writer_fault: Optional[Callable[[int, int], None]] = None,
                 proc_fault: Optional[Callable[[int, int], Optional[Dict]]] = None
                 ) -> CheckpointManager:
    """The manager a :class:`repro_torch.config.CheckpointConfig` describes
    (None: the blocking single-writer default).  ``writer_fault`` is the
    thread writers' injection hook, ``proc_fault`` the writer processes'
    (``runtime/fault.FailureInjector``; ``train/loop.py`` wires both from
    an injector)."""
    if ccfg is None:
        return CheckpointManager(directory, writer_map=writer_map, writer_fault=writer_fault,
                                 proc_fault=proc_fault)
    kw = dict(keep=ccfg.keep, durable=ccfg.durable, writers=ccfg.writers, quorum=ccfg.quorum,
              verify=ccfg.verify, writer_map=writer_map, writer_fault=writer_fault,
              writer_procs=ccfg.writer_procs, writer_timeout=ccfg.writer_timeout,
              reassign=ccfg.reassign, proc_fault=proc_fault)
    if ccfg.async_:
        return AsyncCheckpointManager(directory, max_inflight=ccfg.max_inflight,
                                      staging=ccfg.staging, **kw)
    return CheckpointManager(directory, **kw)
