"""The port's checkpoint writer processes (``repro_torch/runtime/procs.py``)
on the CPU: the scenarios of the JAX package's chaos harness
(``tests/_mp/check_writer_procs.py``), small.

* A clean fleet save, blocking or async, publishes the thread writers'
  step directory byte for byte (1 and 3 writers); the thread writers'
  directory is JAX's (``tests/test_torch_checkpoint.py``).
* ``kill9``, ``sigstop`` and ``corrupt`` in the torn window: the step
  publishes with ``reassigned[victim]`` naming JAX's reason, restores
  equal, and differs from the thread save only by that record.
* ``slow``: logged, never killed, nothing reassigned.
* The coordinator killed mid-save: the orphaned writers exit, the next
  manager sweeps the debris and restores the last published step.
* The ``spill`` handover; ``abort()`` during an in-flight save; a writer
  process loads no torch.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from repro_torch.checkpoint import manager as M
from repro_torch.checkpoint.manager import MANIFEST, AsyncCheckpointManager, CheckpointManager
from repro_torch.runtime import procs
from repro_torch.runtime.fault import FailureInjector

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 1.0          # writer lease: short, so a SIGSTOPped writer is fenced fast

# the reason words of tests/_mp/check_writer_procs.py::_FAULT_WHY
FAULT_WHY = {"kill9": "writer process exited (-9)",
             "sigstop": "heartbeat lease expired",
             "corrupt": "partial failed disk verification"}


def _state(seed=0):
    """~200 KB of mixed leaves: fp32, a bf16 tensor (raw on the wire), a
    0-d int32 (AdamW's ``step``) and an int32 vector."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    return {"params": {"embed": r(64, 96), "w_qkv": r(96, 192), "w_out": r(96, 96),
                       "scale": r(96) * 0.1, "ln_bf16": r(96).to(torch.bfloat16)},
            "opt_state": {"mu": r(96, 192), "nu": r(96, 192),
                          "count": torch.full((3,), seed * 100 + 7, dtype=torch.int32),
                          "step": torch.tensor(seed * 10 + 1, dtype=torch.int32)}}


def _assert_trees_equal(a, b):
    la, lb = M._leaf_paths(a), M._leaf_paths(b)
    assert sorted(la) == sorted(lb)
    for name in la:
        assert la[name].dtype == lb[name].dtype and torch.equal(la[name], lb[name]), name


def _files(d):
    out = {}
    for root, _, files in os.walk(d):
        for fn in files:
            p = os.path.join(root, fn)
            out[os.path.relpath(p, d)] = Path(p).read_bytes()
    return out


def _step_dir(d, step):
    return os.path.join(str(d), f"step_{step:08d}")


def _manifest(d, step):
    with open(os.path.join(_step_dir(d, step), MANIFEST)) as f:
        return json.load(f)


def _assert_no_debris(d):
    names = os.listdir(str(d))
    assert not [n for n in names if n.endswith(".tmp")], names
    assert procs.FLEET_DIR not in names, names


def _thread_save(d, writers, step, state):
    CheckpointManager(str(d), writers=writers).save(step, state)
    return _step_dir(d, step)


@pytest.mark.parametrize("writers", [1, 3])
def test_fleet_saves_are_thread_saves_byte_for_byte(tmp_path, writers):
    state = _state(1)
    want = _files(_thread_save(tmp_path / "thr", writers, 3, state))
    sync = CheckpointManager(str(tmp_path / "prc"), writers=writers, writer_procs=True,
                             writer_timeout=TIMEOUT)
    sync.save(3, state)
    asy = AsyncCheckpointManager(str(tmp_path / "asy"), writers=writers, writer_procs=True,
                                 writer_timeout=TIMEOUT)
    asy.save_async(3, state)
    asy.wait_until_finished()
    assert sync.fleet().arena_kind == asy.fleet().arena_kind == "shm"
    assert [s for s, _ in sync.fleet().spawn_s] == list(range(writers))
    sync.close()
    asy.close()
    for d in ("prc", "asy"):
        got = _files(_step_dir(tmp_path / d, 3))
        assert sorted(got) == sorted(want), d
        assert all(got[f] == want[f] for f in want), d
        _assert_no_debris(tmp_path / d)
    _assert_trees_equal(CheckpointManager(str(tmp_path / "prc")).restore(_state(5))[0], state)


@pytest.mark.parametrize("kind,writers", [("kill9", 2), ("sigstop", 2), ("corrupt", 2),
                                          ("kill9", 3)])
def test_writer_fault_reassigned_and_published(tmp_path, kind, writers):
    victim = writers - 1
    inj = FailureInjector(proc_fail_at={2: (victim, kind)})
    d = tmp_path / "fleet"
    mgr = CheckpointManager(str(d), writers=writers, writer_procs=True,
                            writer_timeout=TIMEOUT, proc_fault=inj.proc_fault)
    s1, s2 = _state(1), _state(2)
    mgr.save(1, s1)                             # a clean save: the fleet is healthy
    mgr.save(2, s2)                             # the fault lands in this one
    assert inj.log == [f"step 2: injected proc fault {kind} into writer {victim}"]
    meta = _manifest(d, 2)
    assert list(meta["reassigned"]) == [str(victim)]
    assert FAULT_WHY[kind] in meta["reassigned"][str(victim)]
    assert meta["committed"] == list(range(writers)) and meta["failed_writers"] == []
    assert any(f"writer {victim} range reassigned" in e for e in mgr.fleet().events)
    _assert_trees_equal(mgr.restore(_state(9))[0], s2)
    mgr.close()
    _assert_no_debris(d)
    # apart from the manifest's record, the thread writers' step directory
    want = _files(_thread_save(tmp_path / "thr", writers, 2, s2))
    got = _files(_step_dir(d, 2))
    assert sorted(got) == sorted(want)
    assert all(got[f] == want[f] for f in want if f != MANIFEST)
    meta.pop("reassigned")
    assert meta == json.loads(want[MANIFEST])


def test_slow_writer_logged_never_killed(tmp_path):
    inj = FailureInjector(proc_fail_at={2: (1, "slow", {"seconds": 2.5})})
    d = tmp_path / "fleet"
    mgr = CheckpointManager(str(d), writers=2, writer_procs=True, writer_timeout=TIMEOUT,
                            proc_fault=inj.proc_fault)
    s2 = _state(2)
    mgr.save(2, s2)
    events = mgr.fleet().events
    assert any("slow" in e and "writer 1" in e for e in events), events
    assert not any("reassigned" in e or "failed" in e for e in events), events
    assert "reassigned" not in _manifest(d, 2)
    assert mgr.fleet().alive_slots() == [0, 1]
    _assert_trees_equal(mgr.restore(_state(9))[0], s2)
    mgr.close()
    want = _files(_thread_save(tmp_path / "thr", 2, 2, s2))
    assert _files(_step_dir(d, 2)) == want


def test_spill_handover(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CKPT_HANDOVER", "spill")
    d = tmp_path / "fleet"
    mgr = CheckpointManager(str(d), writers=2, writer_procs=True, writer_timeout=TIMEOUT,
                            proc_fault=lambda s, w: {"kind": "kill9"} if (s, w) == (2, 1)
                            else None)
    s2 = _state(2)
    mgr.save(2, s2)
    assert mgr.fleet().handover == "spill" and mgr.fleet().arena_kind == "spill"
    assert "1" in _manifest(d, 2)["reassigned"]
    _assert_trees_equal(mgr.restore(_state(9))[0], s2)
    mgr.close()
    _assert_no_debris(d)


def test_shm_without_room_spills(tmp_path, monkeypatch):
    """A segment larger than /dev/shm's free room would fault when packed:
    the arena spills to a file instead."""
    monkeypatch.setattr(procs, "shm_room", lambda: 16)
    a = procs.make_arena(1 << 20, str(tmp_path / "scratch"), "shm")
    try:
        assert a.kind == "spill" and a.ref.startswith(str(tmp_path / "scratch"))
    finally:
        a.close()
    monkeypatch.setattr(procs, "shm_room", lambda: 1 << 30)
    a = procs.make_arena(1 << 20, str(tmp_path / "scratch"), "shm")
    try:
        assert a.kind == "shm" and a.capacity >= 1 << 20
    finally:
        a.close()


def _alive(pid):
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    try:                                        # a reaped zombie is not alive
        with open(f"/proc/{pid}/status") as f:
            return not any(line.startswith("State:") and "Z" in line.split()[1] for line in f)
    except OSError:
        return False


def test_abort_fences_an_inflight_fleet_save(tmp_path):
    d = tmp_path / "fleet"
    mgr = AsyncCheckpointManager(str(d), writers=2, writer_procs=True, writer_timeout=5.0,
                                 proc_fault=lambda s, w: {"kind": "slow", "seconds": 60.0}
                                 if (s, w) == (4, 1) else None)
    mgr.save_async(2, _state(2))
    mgr.wait_until_finished()
    pids = list(mgr.fleet().pids().values())
    mgr.save_async(4, _state(4))
    w0 = os.path.join(str(d), "step_00000004.tmp", "writer_00", M.PARTIAL_MANIFEST)
    deadline = time.monotonic() + 30
    while not os.path.exists(w0):                # writer 0 is done, writer 1 sleeps
        assert time.monotonic() < deadline
        time.sleep(0.02)
    t0 = time.monotonic()
    mgr.abort()
    assert time.monotonic() - t0 < 10            # the fence did not wait out the sleep
    assert mgr.all_steps() == [2]
    assert not any(_alive(p) for p in pids)
    _assert_no_debris(d)
    mgr.check_error()                            # an abort is not a writer error
    s6 = _state(6)
    mgr.save_async(6, s6)                        # the next save respawns the fleet
    mgr.wait_until_finished()
    assert mgr.all_steps() == [2, 6]
    assert not set(mgr.fleet().pids().values()) & set(pids)
    _assert_trees_equal(mgr.restore(_state(9))[0], s6)
    mgr.close()


CHILD = r"""
import os, signal, sys, time
sys.path.insert(0, sys.argv[2])
sys.path.insert(0, os.path.dirname(sys.argv[2]) + "/tests")
from repro_torch.checkpoint.manager import AsyncCheckpointManager
from test_torch_fleet import _state
d = sys.argv[1]
mgr = AsyncCheckpointManager(d, writers=2, writer_procs=True, writer_timeout=5.0)
mgr.save_async(4, _state(4))
mgr.wait_until_finished()
mgr.proc_fault = lambda s, w: {"kind": "slow", "seconds": 120.0} if (s, w) == (8, 1) else None
mgr.save_async(8, _state(8))
w0 = os.path.join(d, "step_00000008.tmp", "writer_00", "manifest.json")
while not os.path.exists(w0):
    time.sleep(0.02)
os.kill(os.getpid(), signal.SIGKILL)
"""


def test_coordinator_killed_mid_save(tmp_path):
    d = str(tmp_path / "coord")
    err = tmp_path / "coord.err"
    with open(err, "w") as f:                 # not a pipe: orphans would hold it open
        r = subprocess.run([sys.executable, "-c", CHILD, d, str(ROOT / "src")],
                           stdout=subprocess.DEVNULL, stderr=f, timeout=300,
                           env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == -signal.SIGKILL, (r.returncode, err.read_text()[-2000:])
    names = os.listdir(d)
    assert "step_00000008.tmp" in names and procs.FLEET_DIR in names, names
    pids = [hb[0] for hb in (procs.read_heartbeat(os.path.join(d, procs.FLEET_DIR,
                                                               f"hb_{s:02d}"))
                             for s in range(2)) if hb is not None]
    assert pids
    deadline = time.monotonic() + 15
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not any(_alive(p) for p in pids), "orphaned writers outlived their coordinator"
    mgr = CheckpointManager(d, writers=2, writer_procs=True, writer_timeout=TIMEOUT)
    assert mgr.all_steps() == [4]
    _assert_no_debris(d)
    back, step = mgr.restore(_state(9))
    assert step == 4
    _assert_trees_equal(back, _state(4))
    mgr.close()


NO_TORCH = r"""
import sys
import torch  # the coordinator is a training process
sys.path.insert(0, sys.argv[2])
from repro_torch.runtime.procs import WriterFleet
f = WriterFleet(sys.argv[1], 2, timeout=5.0)
f.ensure_spawned()
def torch_libs(pid):
    with open(f"/proc/{pid}/maps") as m:
        return len({l.split()[-1] for l in m if "libtorch" in l})
print("coordinator", int(torch_libs("self") > 0))
for slot, pid in sorted(f.pids().items()):
    print(slot, torch_libs(pid))
f.close()
"""


def test_writer_process_loads_no_torch(tmp_path):
    r = subprocess.run([sys.executable, "-c", NO_TORCH, str(tmp_path), str(ROOT / "src")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["coordinator", "1", "0", "0", "1", "0"]
