"""What a background checkpoint write costs the training step, on the card.

    python3 tools/ckpt_contention.py        # one H100, ~5 min

Trains full-width qwen3-0.6b as ``chip_smoke.py``'s training cell does
(bf16 over fp32 masters, batch 8 x 512, 2 microbatches, remat fusion)
and times steps with no write in flight, and while the async manager
writes the state (7.15 GB) in the background:

* ``writers2`` / ``writers1``: ``AsyncCheckpointManager`` as it is, with
  2 or 1 logical writers (each shard ``np.save``d, then read back for its
  crc32, as the format's reference does);
* ``writers2_crc_inline``: 2 writers computing each shard's crc32 over the
  bytes as they are written, with no read-back (a what-if: the same bytes
  and the same crc, checked at the end on one leaf);
* ``procs2``: 2 writer processes (``writer_procs``, ``runtime/procs.py``):
  the training process only packs the snapshot into the handover arena,
  and the children write and read back, holding no lock of the training
  process.  One manager serves every ``procs2`` run, so its fleet is
  spawned and its arena touched by a first save that is not timed.

Each save goes through a warm staging arena (a first save, not timed,
has allocated the pinned buffers), so its stall is the device-to-host
copy.  The variants run twice in turns.  Prints one ``contention`` JSON
line per variant and run (stall, write seconds and GB/s, the steps taken
while the write was in flight, their median; for ``procs2`` the pack's
seconds, the handover kind and the fleet's events), the fleet's first
save (``procs2_first_save``: its arena fresh) and the card's name and
power limit.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint import manager as M  # noqa: E402
from repro_torch.checkpoint import wire  # noqa: E402
from repro_torch.config import ParallelConfig, RunConfig, get_config  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

VARIANTS = ("none", "writers2", "writers1", "writers2_crc_inline", "procs2")
NO_WRITE_STEPS = 6


class _CrcFile:
    """A file whose writes also fold into a running crc32."""

    def __init__(self, f):
        self.f, self.crc, self.n = f, 0, 0

    def write(self, b):
        self.crc = zlib.crc32(b, self.crc)
        self.n += len(b)
        return self.f.write(b)


def write_leaf_crc_inline(path, wire_arr, durable=False):
    """``wire.write_leaf`` without the read-back: the same ``.npy`` bytes
    (``np.lib.format.write_array`` is what ``np.save`` calls)."""
    with open(path, "wb") as f:
        w = _CrcFile(f)
        np.lib.format.write_array(w, wire_arr, allow_pickle=False)
        if durable:
            f.flush()
            os.fsync(f.fileno())
    return w.n, w.crc & 0xFFFFFFFF


def main():
    if not torch.cuda.is_available():
        print("ckpt_contention: no CUDA device available", file=sys.stderr)
        return 1
    build.build_all()
    cfg = get_config("qwen3-0.6b")
    params, opt = TS.init_train_state(cfg, device="cuda")
    step = TS.build_train_step(cfg, ParallelConfig(microbatches=2),
                               RunConfig("c", "train", 512, 8), compute_dtype=torch.bfloat16)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in SyntheticLM(cfg.vocab_size, 512, 8).batch_at(0).items()}
    state = {"params": params, "opt_state": opt}

    def one_step():
        t0 = time.perf_counter()
        state["params"], state["opt_state"], m = step(state["params"], state["opt_state"],
                                                      batch)
        float(m["loss"])
        return time.perf_counter() - t0

    root = tempfile.mkdtemp(prefix="ckpt_contention_")
    read_back = wire.write_leaf
    try:
        for _ in range(2):
            one_step()
        warm = M.AsyncCheckpointManager(os.path.join(root, "warm"), max_inflight=1)
        warm.save_async(0, state)                 # allocates the pinned buffers
        warm.close()
        shutil.rmtree(warm.dir)
        fleet = M.AsyncCheckpointManager(os.path.join(root, "procs2"), keep=1, max_inflight=1,
                                         writers=2, writer_procs=True)
        fleet.save_async(0, state)                # spawns the fleet, touches its arena
        fleet.wait_until_finished()
        w, f = fleet.writes[-1], fleet.fleet()
        print("procs2_first_save " + json.dumps(dict(
            write_s=w["end"] - w["start"], pack_s=f.saves[-1]["pack_s"], handover=f.arena_kind,
            spawn_s=[s for _, s in f.spawn_s])), flush=True)
        for run in range(2):
            for variant in VARIANTS:
                if variant == "none":
                    steps = [one_step() for _ in range(NO_WRITE_STEPS)]
                    row = {}
                else:
                    wire.write_leaf = (write_leaf_crc_inline if "inline" in variant
                                       else read_back)
                    procs = variant == "procs2"
                    mgr = fleet if procs else M.AsyncCheckpointManager(
                        os.path.join(root, variant), max_inflight=1,
                        writers=1 if variant == "writers1" else 2)
                    t0 = time.perf_counter()
                    mgr.save_async(run + 1, state)
                    stall = time.perf_counter() - t0
                    steps = []
                    while mgr.inflight:
                        steps.append(one_step())
                    mgr.wait_until_finished()
                    w = mgr.writes[-1]
                    row = dict(stall_ms=1e3 * stall, write_s=w["end"] - w["start"],
                               bytes=w["bytes"],
                               gb_per_s=w["bytes"] / 1e9 / (w["end"] - w["start"]))
                    if procs:
                        f = fleet.fleet()
                        row.update(pack_s=f.saves[-1]["pack_s"], handover=f.arena_kind,
                                   spawn_s=[s for _, s in f.spawn_s], events=f.events[-4:])
                    else:
                        mgr.close()
                        shutil.rmtree(mgr.dir)
                    wire.write_leaf = read_back
                row.update(variant=variant, run=run, step_ms=[1e3 * x for x in steps],
                           median_step_ms=1e3 * float(np.median(steps)) if steps else None)
                print("contention " + json.dumps(row), flush=True)
        arr = state["opt_state"].mu["embed"]["table"].cpu().numpy()
        a, b = os.path.join(root, "a.npy"), os.path.join(root, "b.npy")
        same = read_back(a, arr) == write_leaf_crc_inline(b, arr)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            same &= fa.read() == fb.read()
        print("crc_inline_same_bytes_and_crc " + json.dumps(same))
        fleet.close()
    finally:
        wire.write_leaf = read_back
        shutil.rmtree(root, ignore_errors=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "--id=0"], capture_output=True, text=True).stdout.strip())
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
