"""Checkpoint writers as OS processes: the writer fleet (docs/DESIGN.md §9).

Counterpart of ``repro/runtime/procs.py``.  Each logical writer of a
save (``checkpoint/manager.py``) runs in its own process, so one
``kill -9`` degrades a save instead of tearing it.  The on-disk protocol
is the thread writers' (``writer_NN/`` shards, partial manifests,
``checkpoint/wire.py``): a step the fleet publishes is byte for byte the
one the thread writers publish, apart from the global manifest's
``reassigned`` record after a reassignment, and the coordinator's
quorum gate decides what publishes.

  * **Spawn**: one child per writer slot through the ``spawn`` context.
    A child imports numpy, ``checkpoint/wire.py`` and the standard
    library, never torch (the package ``__init__`` imports none); under
    ``spawn`` it also re-imports the parent's main module, so a main
    script that imports torch at its top costs each child that import.
    The fleet persists across saves; :attr:`WriterFleet.spawn_s` records
    each slot's seconds from ``start()`` to its first heartbeat.
  * **Handover**: the coordinator packs every leaf's wire bytes into one
    arena, a ``multiprocessing.shared_memory`` segment, or a spill file
    under ``<ckpt_dir>/.fleet/`` when shared memory is unavailable (or
    has less room than the arena: a segment larger than ``/dev/shm``
    would fault when touched) or ``REPRO_CKPT_HANDOVER=spill``; each
    child gets (offset, nbytes, wire dtype and shape) views.  The arena
    is persistent and only grows.  :attr:`WriterFleet.arena_kind` says
    which ran; :attr:`WriterFleet.saves` records each published save's
    seconds: the pack into the arena and each writer's reply.
  * **Leases**: each child bumps a token in ``.fleet/hb_NN`` every
    ``hb_interval``; :class:`LeaseTable` counts a token that changes as
    progress, on the coordinator's monotonic clock.  A slot whose token
    stands still for ``timeout`` is hung and SIGKILL-fenced; a slot whose
    process exited fails at once; a slot that beats but is late is
    logged as slow and never killed.
  * **Reassignment**: a failed writer's range is wiped and re-dispatched
    to a surviving child under the original writer identity, within the
    ``reassign`` budget; a partial counts as committed only once the
    coordinator's ``verify`` callback (its disk verification) passes.
  * **Fence**: :meth:`WriterFleet.fence` SIGKILLs and reaps every child
    and removes the scratch; an in-flight :meth:`WriterFleet.run_save`
    raises :class:`FleetAborted`.  A child whose parent changes
    (``os.getppid()``; the coordinator was killed) exits by itself.
"""

from __future__ import annotations

import mmap
import multiprocessing as mp
import os
import shutil
import signal
import threading
import time
from multiprocessing import connection as mp_connection
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import wire

FLEET_DIR = ".fleet"                 # scratch under the checkpoint root
SHM_ROOT = "/dev/shm"
_SPAWN_WAIT = 60.0                   # cap on waiting for a child's first beat
_ORPHAN_EXIT = 3                     # child exit code: the coordinator vanished


class FleetAborted(Exception):
    """An in-flight fleet save was interrupted by a fence or an abort."""


class FleetError(RuntimeError):
    """The fleet itself is unusable (a spawn failed, every child died)."""


# ---------------------------------------------------------------------------
# heartbeat files (the child writes, the coordinator reads)
# ---------------------------------------------------------------------------

def _beat(path: str, pid: int, seq: int):
    tmp = f"{path}.{pid}.tmp"
    with open(tmp, "w") as f:
        f.write(f"{pid} {seq}")
    os.replace(tmp, path)


def read_heartbeat(path: str) -> Optional[Tuple[int, int]]:
    """(pid, seq), or None for no beat yet (unreadable or garbled)."""
    try:
        with open(path) as f:
            pid_s, seq_s = f.read().split()
        return int(pid_s), int(seq_s)
    except (OSError, ValueError):
        return None


class LeaseTable:
    """The coordinator's liveness ledger.  ``observe(slot, token, now)``
    resets a slot's lease only when the token changes; ``expired`` is True
    once ``timeout`` passes without a change; ``start`` opens a lease at
    dispatch (a child that never beats still expires).  Callers supply
    ``now``, so no clock of another process is ever compared."""

    def __init__(self, timeout: float):
        assert timeout > 0, f"lease timeout={timeout} must be > 0"
        self.timeout = timeout
        self._last: Dict[int, Tuple[Any, float]] = {}

    def start(self, slot: int, now: float):
        self._last.setdefault(slot, (None, now))

    def observe(self, slot: int, token: Any, now: float):
        cur = self._last.get(slot)
        if cur is None or cur[0] != token:
            self._last[slot] = (token, now)

    def expired(self, slot: int, now: float) -> bool:
        cur = self._last.get(slot)
        return cur is not None and (now - cur[1]) > self.timeout

    def drop(self, slot: int):
        self._last.pop(slot, None)


# ---------------------------------------------------------------------------
# the handover arena (the coordinator packs, the children map it read-only)
# ---------------------------------------------------------------------------

class _Arena:
    """One contiguous byte region both sides can map, owned by the fleet
    and reused across saves."""

    def __init__(self, kind: str, ref: str, buf, owner):
        self.kind = kind          # "shm" | "spill"
        self.ref = ref            # segment name | spill file path
        self.buf = buf            # writable memoryview (coordinator side)
        self.capacity = len(buf)
        self._owner = owner       # SharedMemory | file descriptor

    def handle(self) -> Tuple[str, str]:
        return (self.kind, self.ref)

    def close(self):
        try:
            if self.kind == "shm":
                self.buf.release()
                self._owner.close()
                self._owner.unlink()
            else:
                self.buf.release()
                os.close(self._owner)
                os.unlink(self.ref)
        except (OSError, BufferError, ValueError):
            pass                  # already fenced or swept


def shm_room() -> Optional[int]:
    """Free bytes under ``/dev/shm``, or None where it is not a directory."""
    try:
        return shutil.disk_usage(SHM_ROOT).free
    except OSError:
        return None


def make_arena(total: int, scratch: str, handover: str) -> _Arena:
    """Shared memory when it is available and has room for ``total``
    bytes, else a spill file under ``scratch``; ``handover="spill"``
    forces the file."""
    size = max(1, total)
    if handover != "spill":
        room = shm_room()
        if room is None or room >= size:
            try:
                from multiprocessing import shared_memory
                seg = shared_memory.SharedMemory(create=True, size=size)
                return _Arena("shm", seg.name, seg.buf, seg)
            except (ImportError, OSError):
                pass              # no shared memory here: spill below
    os.makedirs(scratch, exist_ok=True)
    path = os.path.join(scratch, f"handover_{os.getpid()}_{time.time_ns()}")
    fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_EXCL, 0o600)
    os.ftruncate(fd, size)
    m = mmap.mmap(fd, size)
    return _Arena("spill", path, memoryview(m), fd)


def attach_arena(handle: Tuple[str, str]):
    """The child's side: map the arena; returns (closer, buffer)."""
    kind, ref = handle
    if kind == "shm":
        from multiprocessing import shared_memory
        # attaching registers the segment with the resource tracker the
        # spawn children share with the coordinator; its cache is a set, so
        # the duplicate collapses and the coordinator's unlink clears it
        seg = shared_memory.SharedMemory(name=ref)
        return seg.close, seg.buf
    mm = np.memmap(ref, dtype=np.uint8, mode="r")
    return (lambda: None), memoryview(mm)


# ---------------------------------------------------------------------------
# the child process
# ---------------------------------------------------------------------------

def inject_fault(spec: Dict[str, Any], wdir: str, shards: Dict[str, Dict]):
    """Run an injected fault in the torn window (shards on disk, partial
    manifest not yet published): ``kill9`` SIGKILLs the child, ``sigstop``
    stops it (its lease expires and the coordinator fences it), ``slow``
    sleeps ``seconds`` with heartbeats flowing, ``corrupt`` truncates the
    last shard by a byte after its checksum was taken."""
    kind = spec.get("kind")
    if kind == "kill9":
        os.kill(os.getpid(), signal.SIGKILL)
    elif kind == "sigstop":
        os.kill(os.getpid(), signal.SIGSTOP)
    elif kind == "slow":
        time.sleep(float(spec.get("seconds", 1.0)))
    elif kind == "corrupt":
        if shards:
            last = sorted(shards)[-1]
            path = os.path.join(os.path.dirname(wdir), shards[last]["file"])
            with open(path, "r+b") as f:
                f.truncate(max(0, os.path.getsize(path) - 1))
    else:
        raise ValueError(f"unknown injected fault kind {kind!r}")


def run_writer_task(task: Dict[str, Any]) -> int:
    """One writer assignment: each arena view persisted as a shard, the
    fault hook in the torn window, then the partial manifest.  Returns
    the shard count; the bytes are the thread writer's."""
    closer, buf = attach_arena(task["arena"])
    try:
        wtag = f"writer_{task['writer']:02d}"
        wdir = os.path.join(task["tmp"], wtag)
        os.makedirs(wdir, exist_ok=True)
        shards: Dict[str, Dict] = {}
        for i, ent in enumerate(task["entries"]):
            view = buf[ent["offset"]:ent["offset"] + ent["nbytes"]]
            arr = np.frombuffer(view, dtype=np.dtype(ent["wire_dtype"])).reshape(
                ent["wire_shape"])
            nbytes, c = wire.write_leaf(os.path.join(wdir, f"leaf_{i:05d}.npy"), arr,
                                        durable=task["durable"])
            info = dict(ent["info"])
            info["bytes"] = nbytes
            info["crc32"] = c
            info["file"] = f"{wtag}/leaf_{i:05d}.npy"
            info["writer"] = task["writer"]
            shards[ent["name"]] = info
            del arr, view          # release the arena's views before closer()
        # >>> shards on disk; partial manifest NOT yet published <<<
        if task.get("fault"):
            inject_fault(task["fault"], wdir, shards)
        wire.publish_partial(wdir, task["step"], task["writer"], shards,
                             durable=task["durable"])
        return len(shards)
    finally:
        closer()


def _writer_child_main(conn, parent_pid: int, hb_path: str, hb_interval: float):
    """The child: a heartbeat thread, which also exits the process once
    ``os.getppid()`` no longer names the coordinator, and a serial task
    loop on the pipe."""
    def beat_loop():
        pid, seq = os.getpid(), 0
        while True:
            if os.getppid() != parent_pid:
                os._exit(_ORPHAN_EXIT)
            seq += 1
            try:
                _beat(hb_path, pid, seq)
            except OSError:
                pass               # scratch swept mid-beat: orphaned soon
            time.sleep(hb_interval)

    threading.Thread(target=beat_loop, daemon=True, name="ckpt-heartbeat").start()
    while True:
        try:
            task = conn.recv()
        except (EOFError, OSError):
            os._exit(0)            # the coordinator closed the pipe
        if task is None:
            os._exit(0)            # graceful shutdown
        try:
            n = run_writer_task(task)
            reply = ("ok", task["writer"], n)
        except BaseException as e:  # noqa: BLE001 — the child reports, never dies
            reply = ("err", task["writer"], f"{type(e).__name__}: {e}")
        try:
            conn.send(reply)
        except (OSError, BrokenPipeError):
            os._exit(0)


# ---------------------------------------------------------------------------
# the coordinator
# ---------------------------------------------------------------------------

class WriterFleet:
    """The writer processes of one checkpoint directory.  One slot per
    logical writer; a slot is respawned between saves, never during one
    (reassignment to a surviving slot covers the work instead)."""

    def __init__(self, directory: str, writers: int, *, timeout: float = 5.0,
                 reassign: int = 1, hb_interval: Optional[float] = None,
                 handover: Optional[str] = None):
        assert writers >= 1, writers
        assert timeout > 0, timeout
        assert reassign >= 0, reassign
        self.dir = directory
        self.writers = writers
        self.timeout = timeout
        self.reassign = reassign
        self.hb_interval = (hb_interval if hb_interval is not None
                            else min(0.5, max(0.02, timeout / 10.0)))
        self.handover = (handover if handover is not None
                         else os.environ.get("REPRO_CKPT_HANDOVER", "shm"))
        self.events: List[str] = []
        self.spawn_s: List[Tuple[int, float]] = []   # (slot, start -> first beat)
        self.arena_kind: Optional[str] = None        # the handover that last ran
        self.saves: List[Dict[str, Any]] = []       # per save: step, pack_s, writer_s, s
        self._ctx = mp.get_context("spawn")
        self._procs: Dict[int, Any] = {}
        self._conns: Dict[int, Any] = {}
        self._fenced = threading.Event()
        self._lock = threading.Lock()
        self._arena: Optional[_Arena] = None          # persistent, grow-only
        self._saving = False

    # -- lifecycle -----------------------------------------------------
    def _scratch(self) -> str:
        return os.path.join(self.dir, FLEET_DIR)

    def _hb_path(self, slot: int) -> str:
        return os.path.join(self._scratch(), f"hb_{slot:02d}")

    def _spawn_slot(self, slot: int):
        parent_conn, child_conn = self._ctx.Pipe()
        hb = self._hb_path(slot)
        try:
            os.remove(hb)
        except OSError:
            pass
        p = self._ctx.Process(target=_writer_child_main,
                              args=(child_conn, os.getpid(), hb, self.hb_interval),
                              name=f"ckpt-writer-{slot:02d}", daemon=True)
        p.start()
        child_conn.close()
        self._procs[slot] = p
        self._conns[slot] = parent_conn

    def _reap_slot(self, slot: int):
        p = self._procs.pop(slot, None)
        conn = self._conns.pop(slot, None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass
        if p is not None:
            if p.exitcode is None:
                try:
                    os.kill(p.pid, signal.SIGKILL)
                except OSError:
                    pass
            p.join(timeout=10)
        try:
            os.remove(self._hb_path(slot))
        except OSError:
            pass

    def ensure_spawned(self):
        """Bring the fleet to full strength (every slot alive, its first
        beat seen); runs at the top of every save, so a save after a fence
        or a death starts with a whole fleet."""
        with self._lock:
            self._fenced.clear()
            started: Dict[int, float] = {}
            for slot in range(self.writers):
                p = self._procs.get(slot)
                if p is None or p.exitcode is not None:
                    if p is not None:
                        self._reap_slot(slot)
                    os.makedirs(self._scratch(), exist_ok=True)
                    started[slot] = time.perf_counter()
                    self._spawn_slot(slot)
            deadline = time.monotonic() + _SPAWN_WAIT
            for slot in range(self.writers):
                while read_heartbeat(self._hb_path(slot)) is None:
                    if self._procs[slot].exitcode is not None:
                        raise FleetError(f"writer slot {slot} died during spawn "
                                         f"(exit {self._procs[slot].exitcode})")
                    if time.monotonic() > deadline:
                        raise FleetError(f"writer slot {slot} produced no heartbeat "
                                         f"within {_SPAWN_WAIT}s of spawn")
                    time.sleep(0.01)
                if slot in started:
                    self.spawn_s.append((slot, time.perf_counter() - started[slot]))

    def fence(self):
        """SIGKILL and reap every child and remove the scratch.  Safe from
        any thread; an in-flight :meth:`run_save` raises
        :class:`FleetAborted` at its next poll."""
        self._fenced.set()
        with self._lock:
            for slot in list(self._procs):
                self._reap_slot(slot)
            # a mid-save fence leaves the arena to run_save's own exit path
            # (its views may still be live in _pack)
            if not self._saving and self._arena is not None:
                self._arena.close()
                self._arena = None
            shutil.rmtree(self._scratch(), ignore_errors=True)

    def close(self):
        """Graceful shutdown: ask the children to exit, then fence."""
        with self._lock:
            for slot, conn in list(self._conns.items()):
                try:
                    conn.send(None)
                except (OSError, BrokenPipeError):
                    pass
            for slot, p in list(self._procs.items()):
                p.join(timeout=10)
        self.fence()

    def alive_slots(self) -> List[int]:
        return [s for s, p in self._procs.items() if p.exitcode is None]

    def pids(self) -> Dict[int, int]:
        return {s: p.pid for s, p in self._procs.items()}

    # -- the save ------------------------------------------------------
    def _ensure_arena(self, total: int) -> _Arena:
        """Reuse the arena while it is large enough, else replace it."""
        a = self._arena
        if a is not None and a.capacity >= total:
            return a
        if a is not None:
            a.close()
            self._arena = None
        self._arena = make_arena(total, self._scratch(), self.handover)
        self.arena_kind = self._arena.kind
        return self._arena

    def _drop_arena(self):
        if self._arena is not None:
            self._arena.close()
            self._arena = None

    def _pack(self, groups: List[List[str]], snap: Dict[str, Tuple[np.ndarray, str]],
              entries: List[List[Dict]],
              on_group: Optional[Callable[[int], None]] = None) -> _Arena:
        """Lower every leaf (``snap``: name -> (array, logical dtype)) to
        wire form in the arena.  Appends writer ``w``'s entries and calls
        ``on_group(w)`` once its slice is packed, so a writer writes while
        later groups are still being copied."""
        wire_arrs: Dict[str, Tuple[np.ndarray, Dict]] = {}
        total = 0
        for g in groups:
            for name in g:
                wa, info = wire.leaf_wire(*snap[name])
                wire_arrs[name] = (wa, info)
                total += wa.nbytes
        arena = self._ensure_arena(total)
        try:
            offset = 0
            for wi, g in enumerate(groups):
                ents = []
                for name in g:
                    wa, info = wire_arrs[name]
                    nb = wa.nbytes
                    if nb:
                        dst = np.frombuffer(arena.buf, dtype=np.uint8, count=nb, offset=offset)
                        # reshape before view: a 0-d leaf cannot change its
                        # itemsize through .view, its (1,) reshape can
                        np.copyto(dst, wa.reshape(-1).view(np.uint8))
                        del dst
                    ents.append({"name": name, "offset": offset, "nbytes": nb,
                                 "wire_dtype": str(wa.dtype), "wire_shape": list(wa.shape),
                                 "info": info})
                    offset += nb
                entries.append(ents)
                if on_group is not None:
                    on_group(wi)
        except BaseException:
            self._drop_arena()
            raise
        return arena

    def run_save(self, tmp: str, step: int, groups: List[List[str]],
                 snap: Dict[str, Tuple[np.ndarray, str]], *, durable: bool = False,
                 fault_for: Optional[Callable[[int, int], Optional[Dict]]] = None,
                 verify: Optional[Callable[[int], Any]] = None,
                 abort_check: Optional[Callable[[], bool]] = None,
                 ) -> Tuple[Dict[int, str], Dict[int, str]]:
        """Fan one save out over the fleet and supervise it to the end.

        Returns ``(failures, reassigned)``: the writers left without a
        verified partial after the reassignment budget, and the writers
        whose range was recovered (value: why the owner failed).  Raises
        :class:`FleetAborted` on a fence or abort, :class:`FleetError`
        when the whole fleet is gone."""
        self.ensure_spawned()
        t_save = time.perf_counter()
        done: Dict[int, float] = {}                  # writer -> seconds to its reply
        self._saving = True       # a fence leaves the arena's teardown to us
        lease = LeaseTable(self.timeout)
        pending: Dict[int, int] = {}        # writer -> the slot running it
        dispatched_at: Dict[int, float] = {}
        failures: Dict[int, str] = {}
        reassigned: Dict[int, str] = {}
        slow_logged: set = set()
        budget = self.reassign
        entries: List[List[Dict]] = []      # filled group by group by _pack

        def dispatch(writer: int, slot: int, fault: Optional[Dict]):
            if self._fenced.is_set():
                raise FleetAborted(step)
            task = {"step": step, "tmp": tmp, "writer": writer, "durable": durable,
                    "arena": self._arena.handle(), "entries": entries[writer],
                    "fault": fault}
            self._conns[slot].send(task)
            pending[writer] = slot
            dispatched_at[writer] = time.monotonic()
            lease.start(slot, time.monotonic())

        def fail_writer(writer: int, why: str):
            """Reassign within the budget, else record the failure."""
            nonlocal budget
            self.events.append(f"step {step}: writer {writer} failed: {why}")
            alive = self.alive_slots()
            if budget > 0 and alive:
                budget -= 1
                # the dead owner may have left torn shards: wipe its range
                shutil.rmtree(os.path.join(tmp, f"writer_{writer:02d}"), ignore_errors=True)
                tgt = min(alive, key=lambda s: sum(1 for sl in pending.values() if sl == s))
                reassigned[writer] = why
                self.events.append(f"step {step}: writer {writer} range reassigned to "
                                   f"slot {tgt}")
                dispatch(writer, tgt, None)
            else:
                failures[writer] = why
                reassigned.pop(writer, None)

        try:
            self._pack(groups, snap, entries,
                       on_group=lambda w: dispatch(
                           w, w, fault_for(step, w) if fault_for is not None else None))
            pack_s = time.perf_counter() - t_save
            while pending:
                if self._fenced.is_set() or (abort_check is not None and abort_check()):
                    raise FleetAborted(step)
                try:
                    conns = {self._conns[s]: s for s in set(pending.values())
                             if s in self._conns}
                    ready = mp_connection.wait(list(conns),
                                               timeout=min(0.05, self.hb_interval / 2))
                except (OSError, KeyError):
                    # a concurrent fence closed the handles under us; the
                    # fence check at the top of the loop exits next pass
                    continue
                now = time.monotonic()
                for conn in ready:
                    slot = conns[conn]
                    try:
                        msg = conn.recv()
                    except (EOFError, OSError):
                        continue        # the liveness scan handles the exit
                    kind, writer, detail = msg
                    if pending.get(writer) != slot:
                        continue        # a stale reply of a superseded task
                    del pending[writer]
                    if kind == "ok" and verify is not None:
                        try:
                            verify(writer)
                        except Exception as e:
                            kind, detail = "err", f"partial failed disk verification: {e}"
                    if kind != "ok":
                        fail_writer(writer, str(detail))
                    else:
                        done[writer] = time.perf_counter() - t_save
                # liveness scan, per slot (a slot may carry several writers)
                for slot in set(pending.values()):
                    hb = read_heartbeat(self._hb_path(slot))
                    if hb is not None:
                        lease.observe(slot, hb, now)
                    p = self._procs.get(slot)
                    dead_why = None
                    if p is None or p.exitcode is not None:
                        code = p.exitcode if p is not None else "?"
                        dead_why = f"writer process exited ({code})"
                    elif lease.expired(slot, now):
                        dead_why = (f"heartbeat lease expired (>{self.timeout}s): "
                                    f"SIGKILL fence")
                    if dead_why is not None:
                        self._reap_slot(slot)
                        lease.drop(slot)
                        for w in [w for w, s in pending.items() if s == slot]:
                            del pending[w]
                            fail_writer(w, dead_why)
                # slow writers: alive and leased, just late; logged once
                for w, t0 in dispatched_at.items():
                    if w in pending and w not in slow_logged and now - t0 > self.timeout:
                        slow_logged.add(w)
                        self.events.append(f"step {step}: writer {w} slow "
                                           f"(>{self.timeout}s, heartbeats healthy)")
        except BaseException:
            # an abort, a fence or the fleet's death: the arena may be swept
            # with the scratch, so drop it rather than reuse it
            self._drop_arena()
            raise
        finally:
            self._saving = False
            if self._fenced.is_set():
                self._drop_arena()
        self.saves.append({"step": step, "pack_s": pack_s, "writer_s": done,
                           "s": time.perf_counter() - t_save})
        return failures, reassigned
