"""The port's training runtime (``repro_torch/runtime/``, the loop's hooks
and the launcher's flags) against the JAX package, on the CPU.

* **Every runtime case of ``tests/test_guard.py`` and
  ``tests/test_fault.py``**, replayed on both packages: each case runs a
  trace through JAX's objects and through the port's, asserts what the
  JAX test asserts on both, and the two records (events, exceptions and
  their ``kind``/``first_step``/``data_indices``/``rollback``, counters,
  returned values) must be equal.  ``choose_microbatches`` and
  ``min_microbatches_for_bubble`` are held to JAX's over a grid of
  inputs.
* **End to end against JAX** (one in-process JAX fixture, the qwen3-0.6b
  smoke config, fp32, as ``tests/_mp/check_guard.py`` scenarios A, B2 and
  C on one device): a NaN batch is skipped at its step only and leaves
  the port's state bit-unchanged, the losses within 1e-5 of JAX's and
  bit-equal to the port's run over the stream without that batch; a
  skip-cap rollback through ``run_supervised`` and the port's
  ``AsyncCheckpointManager`` raises JAX's ``DivergenceError``, retires
  JAX's steps, writes JAX's ``blocklist.json`` bytes, ends within 1e-5 of
  JAX and bit-equal to the port's clean run over the filtered stream; a
  step held past ``hang_timeout`` raises ``HangError`` and the restart
  resumes bit-equal.
* **The launcher**: the guard flags build JAX's ``GuardConfig``; a
  blocklist moves a resumed run to ``data_index(s, blocklist)`` (JAX's
  ``blocklisted_stream``), bit-equal to a run over the filtered stream;
  ``--ckpt-procs`` resumes bit-exact; a 1x2x2 gloo world with ``--guard
  --ckpt-procs`` and a blocklist gives equal histories on every rank,
  within 1e-5 of one card, its writers children of rank 0; both
  launchers' learning-rate horizon is 10,000 steps.
"""

import dataclasses
import os
import shutil
import time
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.manager as JM
import repro.core.schedule as JS
import repro.launch.train as jlaunch
import repro.optim.adamw as JA
import repro.runtime.fault as JF
import repro.runtime.guard as JG
import repro.train.loop as JL
from repro.config import GuardConfig as JGuard
from repro.config import ParallelConfig as JParallel
from repro.config import RunConfig as JRun
from repro.config import get_smoke_config as jax_smoke
from repro.data.synthetic import SyntheticLM as JSynthetic
from repro.models import lm as jlm
from repro.train import step as jstep
from repro_torch.bridge import master_params_from_jax
from repro_torch.checkpoint import manager as TM
from repro_torch.config import GuardConfig, ParallelConfig, RunConfig, get_smoke_config
from repro_torch.core import schedule as TS
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as TA
from repro_torch.runtime import fault as TF
from repro_torch.runtime import guard as TG
from repro_torch.train import loop as TL
from repro_torch.train import step as tstep

RC_TREE = (2e-3, 16, 8)          # lr, seq, batch of test_guard.py's RunConfig


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the two packages behind one surface
# ---------------------------------------------------------------------------

def _tmap(fn, tree):
    if isinstance(tree, dict):
        return {k: _tmap(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tmap(fn, v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_tmap(fn, v) for v in tree)
    return fn(tree)


class Impl(NamedTuple):
    name: str
    G: object                   # runtime.guard
    F: object                   # runtime.fault
    S: object                   # core.schedule
    A: object                   # optim.adamw
    M: object                   # checkpoint.manager
    L: object                   # train.loop
    Guard: type
    Run: type
    tree: object                # numpy tree -> native tree (fresh copies)
    np: object                  # native tree -> numpy tree (copies)
    zeros: object
    scalar: object


JAX = Impl("jax", JG, JF, JS, JA, JM, JL, JGuard, JRun,
           lambda t: jax.tree.map(jnp.asarray, t),
           lambda t: jax.tree.map(lambda x: np.array(x), t),
           lambda n: jnp.zeros(n), lambda x: jnp.float32(x))
PORT = Impl("port", TG, TF, TS, TA, TM, TL, GuardConfig, RunConfig,
            lambda t: _tmap(lambda x: torch.tensor(np.array(x)), t),
            lambda t: _tmap(lambda x: np.array(x.detach().numpy() if torch.is_tensor(x) else x), t),
            lambda n: torch.zeros(n), lambda x: torch.tensor(x, dtype=torch.float32))


def _err(e):
    """The fields of an exception both packages must agree on."""
    d = {"type": type(e).__name__}
    if type(e).__name__ != "HangError":
        d["msg"] = str(e)
    for f in ("kind", "first_step", "data_indices", "rollback", "step", "timeout"):
        if hasattr(e, f):
            d[f] = getattr(e, f)
    return d


def _raises(fn):
    try:
        fn()
    except Exception as e:
        return _err(e)
    return None


def _bits_equal(a, b):
    fa = jax.tree.leaves(a) if not isinstance(a, list) else a
    fb = jax.tree.leaves(b) if not isinstance(b, list) else b
    return all(np.array_equal(np.asarray(x), np.asarray(y), equal_nan=True) for x, y in zip(fa, fb))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# tests/test_guard.py, replayed
# ---------------------------------------------------------------------------

def _rc(I):
    lr, seq, batch = RC_TREE
    return I.Run("t", "train", seq, batch, lr=lr)


def _np_tree():
    rng = np.random.default_rng(0)
    return {"a": rng.standard_normal((4, 8)).astype(np.float32),
            "b": {"w": rng.standard_normal((3,)).astype(np.float32)}}


def _np_grads(scale=0.1):
    return _tmap(lambda p: np.full_like(p, scale), _np_tree())


def _update(I, params, grads, st, guard=None):
    kw = {} if guard is None else {"guard": guard}
    return I.A.update(params, I.tree(grads), st, _rc(I), **kw)


def g_guardconfig_defaults_valid(I, _):
    g = I.Guard()
    assert g.grad_spike_factor > 1 and g.loss_spike_factor > 1 and g.rollback
    return dataclasses.asdict(g)


BAD_GUARDS = [{"grad_spike_factor": 1.0}, {"loss_spike_factor": 0.5}, {"grad_ewma_alpha": 0.0},
              {"loss_ewma_alpha": 1.5}, {"patience": 0}, {"skip_cap": 0},
              {"hang_timeout": -1.0}]


def g_guardconfig_rejects_bad_values(I, _):
    out = [_raises(lambda: I.Guard(**kw)) for kw in BAD_GUARDS]
    assert all(r is not None and r["type"] == "AssertionError" for r in out)
    return [r["type"] for r in out]


def g_guarded_update_matches_unguarded_when_ok(I, _):
    params = I.tree(_np_tree())
    p1, s1, _ = _update(I, params, _np_grads(), I.A.init(params))
    p1, s1 = I.np(p1), I.np(s1)
    params = I.tree(_np_tree())
    p2, s2, m2 = _update(I, params, _np_grads(), I.A.init(params), I.Guard())
    rec = dict(params=_bits_equal(_leaves(p1), _leaves(I.np(p2))),
               moments=_bits_equal(_leaves((s1.mu, s1.nu)), _leaves(I.np((s2.mu, s2.nu)))),
               step=int(s2.step), ok=float(m2["update_ok"]),
               skipped=float(m2["update_skipped"]))
    assert rec == dict(params=True, moments=True, step=1, ok=1.0, skipped=0.0)
    return rec


def _nonfinite(I, bad):
    gc = I.Guard()
    params = I.tree(_np_tree())
    params, st, _ = _update(I, params, _np_grads(), I.A.init(params), gc)
    p0, s0 = I.np(params), I.np(st)
    grads = _np_grads()
    grads["b"]["w"][1] = bad                           # one poisoned element
    p2, s2, m = _update(I, params, grads, st, gc)
    rec = dict(skipped=float(m["update_skipped"]), nonfinite=float(m["nonfinite"]),
               params=_bits_equal(_leaves(I.np(p2)), _leaves(p0)),
               moments=_bits_equal(_leaves(I.np((s2.mu, s2.nu))), _leaves((s0.mu, s0.nu))),
               step_frozen=int(s2.step) == int(s0.step),
               ewma_frozen=float(s2.gnorm_ewma) == float(s0.gnorm_ewma))
    assert rec == dict(skipped=1.0, nonfinite=1.0, params=True, moments=True,
                       step_frozen=True, ewma_frozen=True)
    return rec


def g_nonfinite_grad_skips_bit_unchanged_nan(I, _):
    return _nonfinite(I, np.nan)


def g_nonfinite_grad_skips_bit_unchanged_inf(I, _):
    return _nonfinite(I, np.inf)


def g_nonfinite_grad_skips_bit_unchanged_neginf(I, _):
    return _nonfinite(I, -np.inf)


def g_norm_spike_skips_but_finite(I, _):
    gc = I.Guard()
    params = I.tree(_np_tree())
    params, st, _ = _update(I, params, _np_grads(0.1), I.A.init(params), gc)
    p0 = I.np(params)
    p2, _, m = _update(I, params, _np_grads(100.0), st, gc)
    rec = dict(skipped=float(m["update_skipped"]), nonfinite=float(m["nonfinite"]),
               params=_bits_equal(_leaves(I.np(p2)), _leaves(p0)))
    assert rec == dict(skipped=1.0, nonfinite=0.0, params=True)
    return rec


def g_unseeded_ewma_accepts_any_norm(I, _):
    params = I.tree(_np_tree())
    _, s2, m = _update(I, params, _np_grads(100.0), I.A.init(params), I.Guard())
    assert float(m["update_ok"]) == 1.0 and float(s2.gnorm_ewma) > 0.0
    return dict(ok=float(m["update_ok"]), ewma=round(float(s2.gnorm_ewma), 3))


def g_ewma_folds_only_accepted_norms(I, _):
    gc = I.Guard()
    params = I.tree(_np_tree())
    _, s1, _ = _update(I, params, _np_grads(0.1), I.A.init(params), gc)
    seeded = float(s1.gnorm_ewma)
    _, s2, _ = _update(I, params, _np_grads(100.0), s1, gc)
    frozen = float(s2.gnorm_ewma) == seeded
    _, s3, m3 = _update(I, params, _np_grads(0.11), s2, gc)
    rec = dict(frozen=frozen, ok=float(m3["update_ok"]),
               folded=float(s3.gnorm_ewma) != seeded, seeded=round(seeded, 5))
    assert rec["frozen"] and rec["ok"] == 1.0 and rec["folded"]
    return rec


def g_guard_predicate_skips_only_the_poison(I, _):
    """test_guard_predicate_jits_without_retrace's trace (the port has no
    trace to count): a healthy, a NaN and a healthy gradient."""
    gc = I.Guard()
    params = I.tree(_np_tree())
    st = I.A.init(params)
    skipped = []
    for scale in (0.1, np.nan, 0.1):
        params, st, m = _update(I, params, _np_grads(scale), st, gc)
        skipped.append(float(m["update_skipped"]))
    assert skipped == [0.0, 1.0, 0.0]
    return skipped


def _tg(I, **kw):
    base = dict(loss_spike_factor=1.5, patience=2, skip_cap=3)
    base.update(kw)
    return I.G.TrainingGuard(I.Guard(**base))


def g_training_guard_healthy_run_never_raises(I, _):
    tg = _tg(I)
    for s in range(50):
        tg.observe(s, 1.0 - s * 0.01)
    assert tg.spike_streak == 0 and tg.events == []
    return dict(ewma=tg.loss_ewma, events=tg.events)


def g_training_guard_loss_spike_raises_with_window(I, _):
    tg = _tg(I)
    tg.observe(0, 1.0)
    tg.observe(1, 1.0)
    tg.observe(2, 9.0)
    e = _raises(lambda: tg.observe(3, 9.5))
    assert e["kind"] == "loss_spike" and e["first_step"] == 2
    assert e["data_indices"] == (2, 3) and e["rollback"]
    return dict(err=e, events=tg.events)


def g_training_guard_ewma_frozen_while_spiking(I, _):
    tg = _tg(I, patience=5)
    tg.observe(0, 1.0)
    tg.observe(1, 9.0)
    frozen = tg.loss_ewma
    tg.observe(2, 1.0)
    assert frozen == 1.0 and tg.spike_streak == 0 and tg.loss_ewma == pytest.approx(1.0)
    return dict(frozen=frozen, ewma=tg.loss_ewma, streak=tg.spike_streak)


def g_training_guard_nonfinite_loss_counts_as_spike(I, _):
    tg = _tg(I, patience=1)
    tg.observe(0, 1.0)
    e = _raises(lambda: tg.observe(1, float("nan")))
    assert e["type"] == "DivergenceError"
    return dict(err=e, events=tg.events)


def g_training_guard_skip_cap(I, _):
    tg = _tg(I, skip_cap=2, patience=99)
    tg.observe(0, 1.0)
    tg.observe(1, float("nan"), {"update_skipped": 1.0})
    e = _raises(lambda: tg.observe(2, float("nan"), {"update_skipped": 1.0}))
    assert e["kind"] == "skip_cap" and e["data_indices"] == (1, 2) and tg.loss_ewma == 1.0
    return dict(err=e, ewma=tg.loss_ewma, events=tg.events)


def g_training_guard_reports_data_indices_not_steps(I, _):
    tg = _tg(I)
    tg.observe(0, 1.0, data_index=0)
    tg.observe(16, 9.0, data_index=19)
    e = _raises(lambda: tg.observe(17, 9.0, data_index=20))
    assert e["first_step"] == 16 and e["data_indices"] == (19, 20)
    return e


def g_training_guard_spike_detection_monotone_in_factor(I, _):
    losses = [1.0, 1.2, 2.9, 3.1]
    fired = []
    for f in (1.2, 2.0, 2.8):
        tg = _tg(I, loss_spike_factor=f, patience=1)
        try:
            for s, loss in enumerate(losses):
                tg.observe(s, loss)
            fired.append(None)
        except I.G.DivergenceError as e:
            fired.append(e.first_step)
    assert fired == sorted(fired, key=lambda x: (x is None, x)) and fired[0] is not None
    return fired


def g_watchdog_fast_steps_never_trip(I, _):
    wd = I.G.Watchdog(0.5, poll=0.01)
    try:
        for s in range(5):
            wd.arm(s)
            time.sleep(0.01)
            wd.disarm()
            wd.check()
    finally:
        wd.close()
    return wd.tripped


def g_watchdog_trips_on_hung_step_and_clears(I, _):
    wd = I.G.Watchdog(0.05, poll=0.01)
    try:
        wd.arm(7)
        time.sleep(0.2)
        wd.disarm()
        tripped = wd.tripped
        e = _raises(wd.check)
        assert tripped and e["step"] == 7 and e["timeout"] == 0.05
        wd.check()
        wd.arm(8)
        time.sleep(0.01)
        wd.disarm()
        wd.check()
    finally:
        wd.close()
    return dict(tripped=tripped, err=e)


def g_watchdog_on_hang_fires_during_the_hang(I, _):
    fired = []
    wd = I.G.Watchdog(0.05, poll=0.01, on_hang=lambda s, el: fired.append(s))
    try:
        wd.arm(3)
        deadline = time.time() + 2.0
        while not fired and time.time() < deadline:
            time.sleep(0.01)
        assert fired == [3]
    finally:
        wd.close()
    return fired


def g_watchdog_disarmed_never_trips(I, _):
    wd = I.G.Watchdog(0.02, poll=0.01)
    try:
        time.sleep(0.1)
        assert not wd.tripped
    finally:
        wd.close()
    return wd.tripped


def g_blocklist_roundtrip_and_merge(I, d):
    rec = [I.G.load_blocklist(d), I.G.publish_blocklist(d, [18, 17]), I.G.load_blocklist(d),
           I.G.publish_blocklist(d, [18, 40]), I.G.load_blocklist(d)]
    assert rec == [[], [17, 18], [17, 18], [17, 18, 40], [17, 18, 40]]
    return dict(lists=rec, bytes=Path(I.G.blocklist_path(d)).read_bytes())


def g_blocklist_missing_and_torn_are_empty(I, d):
    rec = [I.G.load_blocklist(None), I.G.load_blocklist(os.path.join(d, "nope"))]
    Path(d, I.G.BLOCKLIST).write_text("{torn")
    rec.append(I.G.load_blocklist(d))
    assert rec == [[], [], []]
    return rec


def g_data_index_mapping(I, _):
    rec = [[I.G.data_index(s, []) for s in range(5)],
           [I.G.data_index(s, [17, 18]) for s in (16, 17, 18, 19)],
           I.G.data_index(0, [0]), I.G.data_index(3, [1, 5, 2])]
    assert rec == [[0, 1, 2, 3, 4], [16, 19, 20, 21], 1, 6]
    return rec


def g_data_index_skips_exactly_the_blocklist(I, _):
    bl = [2, 5, 6, 11]
    mapped = [I.G.data_index(s, bl) for s in range(10)]
    assert mapped == [i for i in range(20) if i not in bl][:10]
    return mapped


def g_blocklisted_stream_yields_filtered_batches(I, _):
    stream = I.G.blocklisted_stream(lambda i: i * 10, 1, [2, 3])
    got = [next(stream) for _ in range(4)]
    assert got == [10, 40, 50, 60]
    return got


def g_retire_steps_after(I, d):
    mgr = I.M.CheckpointManager(d, keep=10)
    state = {"w": I.tree({"w": np.arange(4.0, dtype=np.float32)})["w"]}
    for s in (2, 4, 6, 8):
        mgr.save(s, state)
    rec = [mgr.all_steps(), mgr.retire_steps_after(4), mgr.all_steps(),
           mgr.retire_steps_after(4), mgr.restore({"w": state["w"]})[1],
           mgr.retire_steps_after(0), mgr.all_steps()]
    assert rec == [[2, 4, 6, 8], [6, 8], [2, 4], [], 4, [2, 4], []]
    return rec


# ---------------------------------------------------------------------------
# tests/test_fault.py, replayed
# ---------------------------------------------------------------------------

NO_SLEEP = {"sleep_fn": lambda _: None}


def f_injector_fails_each_step_exactly_once(I, _):
    inj = I.F.FailureInjector({3: "chip down", 7: "host unreachable"})
    rec = [_raises(lambda: inj.check(s)) for s in (0, 2, 3, 3, 7)]
    assert rec[2]["msg"].endswith("chip down at step 3") and rec[3] is None and rec[4]
    assert inj.log == ["step 3: injected chip down", "step 7: injected host unreachable"]
    assert inj.fail_at == {}
    return dict(errs=rec, log=inj.log)


def f_injector_writer_kill_is_one_shot_and_targeted(I, _):
    inj = I.F.FailureInjector(writer_fail_at={4: 1})
    rec = [_raises(lambda: inj.check(4))] + [_raises(lambda: inj.check_writer(s, w))
                                            for s, w in ((4, 0), (4, 1), (4, 1), (5, 1))]
    assert [r is None for r in rec] == [True, True, False, True, True]
    assert "writer 1 died at step 4" in rec[2]["msg"]
    assert inj.writer_fail_at == {} and inj.log == ["step 4: injected writer 1 death"]
    return dict(errs=rec, log=inj.log)


def f_steptimer_first_sample_seeds_ewma(I, _):
    t = I.F.StepTimer(warmup_steps=0)
    rec = [t.record(1.0), t.ewma]
    assert rec == [False, 1.0]
    return rec


def f_steptimer_warmup_discards_compile_spike(I, _):
    t = I.F.StepTimer(alpha=0.5, straggler_factor=2.0, patience=1)
    rec = [t.record(100.0), t.ewma, t.record(1.0), t.ewma, t.record(3.0), t.events]
    assert rec[:5] == [False, None, False, 1.0, True] and len(t.events) == 1
    return rec


def f_steptimer_no_warmup_compile_spike_masks_stragglers(I, _):
    t = I.F.StepTimer(alpha=0.5, straggler_factor=2.0, patience=1, warmup_steps=0)
    t.record(100.0)
    rec = [t.record(3.0), t.events]
    assert rec == [False, []]
    return rec


def f_steptimer_warmup_discards_exactly_n_samples(I, _):
    t = I.F.StepTimer(warmup_steps=3)
    rec = [(t.record(dt), t.ewma) for dt in (50.0, 40.0, 30.0)]
    t.record(1.0)
    rec.append(t.ewma)
    assert rec == [(False, None)] * 3 + [1.0]
    return rec


def f_steptimer_ewma_freezes_while_slow(I, _):
    t = I.F.StepTimer(alpha=0.5, straggler_factor=2.0, patience=3, warmup_steps=0)
    t.record(1.0)
    rec = [t.record(10.0), t.record(10.0), t.ewma, t.record(10.0), t.ewma, t.slow_streak,
           t.events]
    assert rec[:6] == [False, False, 1.0, True, 1.0, 0] and len(t.events) == 1
    return rec


def f_steptimer_fast_step_resets_streak_and_updates_ewma(I, _):
    t = I.F.StepTimer(alpha=0.5, straggler_factor=2.0, patience=3, warmup_steps=0)
    t.record(1.0)
    t.record(10.0)
    t.record(10.0)
    rec = [t.record(1.2), t.slow_streak, t.ewma, t.record(10.0), t.slow_streak, t.events]
    assert rec[0] is False and rec[1] == 0 and rec[2] == pytest.approx(1.1)
    assert rec[3:] == [False, 1, []]
    return rec


def f_steptimer_borderline_step_is_not_slow(I, _):
    t = I.F.StepTimer(alpha=0.5, straggler_factor=2.5, patience=1, warmup_steps=0)
    t.record(1.0)
    rec = [t.record(2.5), t.ewma]
    assert rec[0] is False and rec[1] == pytest.approx(1.75)
    return rec


def f_rebalance_moves_one_shard_to_least_loaded_healthy_host(I, _):
    out = I.F.rebalance_data_shards(4, [1], shards_per_host=[2, 2, 1, 2])
    assert out == [2, 1, 2, 2]
    return out


def f_rebalance_all_hosts_slow_is_a_noop(I, _):
    shards = [1, 2, 3]
    out = I.F.rebalance_data_shards(3, [0, 1, 2], shards_per_host=shards)
    assert out == shards and out is not shards
    return out


def f_rebalance_zero_shard_straggler_is_skipped(I, _):
    out = I.F.rebalance_data_shards(3, [0], shards_per_host=[0, 2, 2])
    assert out == [0, 2, 2]
    return out


def f_rebalance_multiple_stragglers_conserve_shards(I, _):
    out = I.F.rebalance_data_shards(5, [0, 1])
    assert sum(out) == 5 and out[:2] == [0, 0] and sorted(out[2:]) == [1, 2, 2]
    return out


class _FlakyRun:
    def __init__(self, fails):
        self.fails, self.calls = fails, 0

    def __call__(self, state, start, inc):
        self.calls += 1
        if self.calls <= self.fails:
            raise RuntimeError(f"boom {self.calls}")
        return {"done": True, "inc": inc.index}


def f_run_supervised_counts_incarnations_and_restarts(I, _):
    restarts = []
    state, n = I.F.run_supervised(lambda _: ({}, 0), _FlakyRun(2), max_restarts=5,
                                  on_restart=restarts.append, **NO_SLEEP)
    rec = [state, n, [i.index for i in restarts],
           all(isinstance(i, I.F.Incarnation) for i in restarts)]
    assert rec == [{"done": True, "inc": 2}, 3, [1, 2], True]
    return rec


def f_run_supervised_exhaustion_raises(I, _):
    run = _FlakyRun(100)
    e = _raises(lambda: I.F.run_supervised(lambda _: ({}, 0), run, max_restarts=2, **NO_SLEEP))
    assert "exceeded 2 restarts" in e["msg"] and run.calls == 3
    return [e, run.calls]


def f_run_supervised_zero_restarts_budget(I, _):
    e = _raises(lambda: I.F.run_supervised(lambda _: ({}, 0), _FlakyRun(1), max_restarts=0,
                                           **NO_SLEEP))
    assert "exceeded 0 restarts" in e["msg"]
    return e


def f_run_supervised_supervises_any_exception(I, _):
    rec = []
    for exc in (OSError("EIO: checkpoint fs gone"), ValueError("runtime broke")):
        calls = {"n": 0}

        def run(state, start, inc):
            calls["n"] += 1
            if calls["n"] == 1:
                raise exc
            return {"done": True}

        state, n = I.F.run_supervised(lambda _: ({}, 0), run, **NO_SLEEP)
        rec.append([state, n])
    assert rec == [[{"done": True}, 2]] * 2
    return rec


def f_run_supervised_non_retryable_errors_propagate(I, _):
    rec = []
    for exc_type in (KeyboardInterrupt, AssertionError):
        calls, slept = {"n": 0}, []

        def run(state, start, inc):
            calls["n"] += 1
            raise exc_type("stop")

        with pytest.raises(exc_type):
            I.F.run_supervised(lambda _: ({}, 0), run, sleep_fn=slept.append)
        rec.append([calls["n"], slept])
    assert rec == [[1, []], [1, []]]
    return rec


def f_run_supervised_backoff_is_exponential_and_capped(I, _):
    slept = []
    e = _raises(lambda: I.F.run_supervised(lambda _: ({}, 0), _FlakyRun(100), max_restarts=5,
                                           backoff_base=0.5, backoff_cap=3.0,
                                           sleep_fn=slept.append))
    assert "exceeded 5 restarts" in e["msg"] and slept == [0.5, 1.0, 2.0, 3.0, 3.0]
    return [e, slept]


class _FakeAsyncCkpt:
    def __init__(self):
        self.aborts = 0

    def abort(self):
        self.aborts += 1


def f_run_supervised_aborts_inflight_saves_per_failure(I, _):
    ckpt, order = _FakeAsyncCkpt(), []

    def make_state(_):
        order.append(("make", ckpt.aborts))
        return {}, 0

    _, n = I.F.run_supervised(make_state, _FlakyRun(2), max_restarts=5, ckpt=ckpt, **NO_SLEEP)
    rec = [n, ckpt.aborts, order]
    assert rec == [3, 2, [("make", 0), ("make", 1), ("make", 2)]]
    return rec


def f_run_supervised_aborts_on_exhaustion_too(I, _):
    ckpt = _FakeAsyncCkpt()
    e = _raises(lambda: I.F.run_supervised(lambda _: ({}, 0), _FlakyRun(100), max_restarts=1,
                                           ckpt=ckpt, **NO_SLEEP))
    assert "exceeded" in e["msg"] and ckpt.aborts == 2
    return [e, ckpt.aborts]


def f_run_supervised_divergence_rollback_policy(I, d):
    class _RollbackCkpt(_FakeAsyncCkpt):
        def __init__(self):
            super().__init__()
            self.dir, self.retired = d, []

        def retire_steps_after(self, step):
            self.retired.append(("after-abort" if self.aborts else "early", step))

    ckpt, calls = _RollbackCkpt(), {"n": 0}

    def run_steps(state, start, inc):
        calls["n"] += 1
        if calls["n"] == 1:
            raise I.G.DivergenceError("poison", kind="loss_spike", first_step=17,
                                      data_indices=(17, 18))
        if calls["n"] == 2:
            raise RuntimeError("ordinary death")
        return state

    _, n = I.F.run_supervised(lambda _: ({}, 0), run_steps, max_restarts=4, ckpt=ckpt,
                              **NO_SLEEP)
    rec = [n, ckpt.aborts, ckpt.retired, I.G.load_blocklist(d)]
    assert rec == [3, 2, [("after-abort", 17)], [17, 18]]
    return rec


def f_run_supervised_divergence_no_rollback_flag(I, d):
    class _RollbackCkpt(_FakeAsyncCkpt):
        dir = d

        def retire_steps_after(self, step):
            raise AssertionError("must not retire with rollback=False")

    fails = {"n": 0}

    def run_steps(state, start, inc):
        if not fails["n"]:
            fails["n"] = 1
            raise I.G.DivergenceError("poison", kind="skip_cap", first_step=3,
                                      data_indices=(3,), rollback=False)
        return state

    _, n = I.F.run_supervised(lambda _: ({}, 0), run_steps, max_restarts=2,
                              ckpt=_RollbackCkpt(), **NO_SLEEP)
    rec = [n, I.G.load_blocklist(d)]
    assert rec == [2, []]
    return rec


def _plus_one(I):
    def ts(params, opt, batch):
        return {"w": params["w"] + 1.0}, opt, {"loss": I.scalar(0.0)}
    return ts


def _supervise_counter(I, mgr, inj, total=8):
    resume_args = []

    def make_state(resume_step):
        resume_args.append(resume_step)
        state, start = {"params": {"w": I.zeros(3)}, "opt_state": {}}, 0
        if mgr.latest_step() is not None:
            state, start = mgr.restore(state)
        return state, start

    def run_steps(state, start, inc):
        return I.L.train(_plus_one(I), state, iter([{}] * total), start_step=start,
                         num_steps=total, ckpt=mgr, ckpt_every=2, log_every=100,
                         injector=inj, log_fn=lambda *a: None)

    state, n = I.F.run_supervised(make_state, run_steps, ckpt=mgr, **NO_SLEEP)
    return state, n, resume_args


def f_supervised_writer_kill_end_to_end(I, d):
    inj = I.F.FailureInjector(writer_fail_at={4: 1})
    mgr = I.M.CheckpointManager(d, writers=2)
    state, n, _ = _supervise_counter(I, mgr, inj)
    rec = [n, inj.log, mgr.all_steps(), np.asarray(state["params"]["w"]).tolist()]
    mgr.close()
    assert rec == [2, ["step 4: injected writer 1 death"], [4, 6, 8], [8.0] * 3]
    return rec


def f_supervised_writer_process_kill_end_to_end(I, d):
    """``tests/_mp/check_writer_procs.py``'s supervised scenario without a
    model: with no reassignment budget a SIGKILLed writer process fails
    step 4's quorum, the supervisor fences the fleet and the restart is
    handed step 2, the last published."""
    inj = I.F.FailureInjector(proc_fail_at={4: (1, "kill9")})
    mgr = I.M.CheckpointManager(d, writers=2, writer_procs=True, writer_timeout=1.0,
                                reassign=0)
    state, n, resume_args = _supervise_counter(I, mgr, inj)
    rec = [n, inj.log, resume_args, mgr.all_steps(), np.asarray(state["params"]["w"]).tolist()]
    mgr.close()
    assert rec == [2, ["step 4: injected proc fault kill9 into writer 1"], [None, 2],
                   [4, 6, 8], [8.0] * 3]
    assert not [n for n in os.listdir(d) if n.endswith(".tmp") or n == ".fleet"]
    return rec


def f_injector_proc_fault_is_one_shot_and_targeted(I, _):
    inj = I.F.FailureInjector(proc_fail_at={4: (1, "slow", {"seconds": 2.0}), 6: (0, "kill9")})
    rec = [inj.proc_fault(4, 0), inj.proc_fault(3, 1), inj.proc_fault(4, 1),
           inj.proc_fault(4, 1), inj.proc_fault(6, 0), inj.proc_fail_at, inj.log]
    assert rec[:6] == [None, None, {"kind": "slow", "seconds": 2.0}, None, {"kind": "kill9"}, {}]
    assert inj.log == ["step 4: injected proc fault slow into writer 1",
                       "step 6: injected proc fault kill9 into writer 0"]
    return rec


def f_injector_proc_fault_rejects_unknown_kind(I, _):
    e = _raises(lambda: I.F.FailureInjector(proc_fail_at={1: (0, "nuke")}))
    assert e["type"] == "AssertionError" and "nuke" in e["msg"]
    return e


def f_run_supervised_pins_resume_step_to_post_fence_view(I, _):
    class _Ckpt(_FakeAsyncCkpt):
        def __init__(self):
            super().__init__()
            self.published = [2]

        def latest_step(self):
            return self.published[-1] if self.published else None

    ckpt, seen, calls = _Ckpt(), [], {"n": 0}

    def make_state(resume_step):
        seen.append(resume_step)
        return {}, 0

    def run(state, start, inc):
        calls["n"] += 1
        if calls["n"] == 1:
            ckpt.published.append(4)
            raise RuntimeError("dead after publishing 4")
        return {"done": True}

    state, n = I.F.run_supervised(make_state, run, ckpt=ckpt, **NO_SLEEP)
    rec = [state, n, seen]
    assert rec == [{"done": True}, 2, [None, 4]]
    return rec


def f_run_supervised_rollback_resume_step_is_post_retire(I, d):
    class _Ckpt(_FakeAsyncCkpt):
        def __init__(self):
            super().__init__()
            self.dir, self.published = d, [2, 4, 6]

        def retire_steps_after(self, step):
            self.published = [s for s in self.published if s <= step]

        def latest_step(self):
            return self.published[-1] if self.published else None

    ckpt, seen, calls = _Ckpt(), [], {"n": 0}

    def make_state(resume_step):
        seen.append(resume_step)
        return {}, 0

    def run(state, start, inc):
        calls["n"] += 1
        if calls["n"] == 1:
            raise I.G.DivergenceError("poison", kind="loss_spike", first_step=5,
                                      data_indices=(5,))
        return {"done": True}

    state, n = I.F.run_supervised(make_state, run, ckpt=ckpt, max_restarts=2, **NO_SLEEP)
    rec = [state, n, ckpt.published, seen]
    assert rec == [{"done": True}, 2, [2, 4], [None, 4]]
    return rec


# tests/test_pipeline.py's microbatch cases, and a grid of inputs

def s_min_microbatches_for_bubble(I, _):
    rec = [I.S.min_microbatches_for_bubble(p, f) for p in (1, 2, 4, 8)
           for f in (0.05, 0.2, 0.25, 0.5)]
    for p in (2, 4, 8):
        m = I.S.min_microbatches_for_bubble(p, 0.25)
        assert (p - 1) / (m + p - 1) <= 0.25 and ((p - 1) / (m + p - 2) > 0.25 or m == 1)
    return rec


def s_choose_microbatches(I, _):
    kw = dict(seq_len=128, d_model=256, n_data_shards=1, n_token_shards=4, num_layers=4,
              vocab=1024, act_budget_bytes=1e9)
    n1, r1 = I.S.choose_microbatches(64, n_stages=1, **kw)
    n4, r4 = I.S.choose_microbatches(64, n_stages=4, max_bubble=0.2, **kw)
    assert r1 == r4 and n4 >= n1 and 3 / (n4 + 3) <= 0.2 and 64 % n4 == 0
    assert I.S.choose_microbatches(2, n_stages=8, max_bubble=0.05, **kw)[0] <= 2
    rec = [(n1, r1), (n4, r4)]
    for gb in (1, 8, 64, 512):
        for seq in (128, 4096):
            for budget in (1e6, 1e8, 4e9):
                for d_shards, stages in ((1, 1), (4, 1), (2, 4)):
                    rec.append(I.S.choose_microbatches(
                        gb, seq, 2048, d_shards, 4, num_layers=24, vocab=152_064,
                        act_budget_bytes=budget, n_stages=stages))
    return rec


CASES = {fn.__name__[2:]: fn for name, fn in sorted(globals().items())
         if name[:2] in ("g_", "f_", "s_") and callable(fn)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_runtime_trace_matches_jax(case, tmp_path):
    got = {}
    for impl in (JAX, PORT):
        d = tmp_path / impl.name
        d.mkdir()
        got[impl.name] = CASES[case](impl, str(d))
    assert got["port"] == got["jax"]


def test_every_runtime_case_is_replayed():
    """Each test of the JAX runtime's test files has a replay here."""
    import ast
    root = Path(__file__).resolve().parent
    names = set()
    for f in ("test_guard.py", "test_fault.py"):
        names |= {n.name[5:] for n in ast.parse((root / f).read_text()).body
                  if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    # the in-graph guard's retrace test becomes a trace of its three steps;
    # the nonfinite test's three parameters are three cases
    renamed = {"guard_predicate_jits_without_retrace": "guard_predicate_skips_only_the_poison",
               "nonfinite_grad_skips_bit_unchanged": "nonfinite_grad_skips_bit_unchanged_nan"}
    missing = {renamed.get(n, n) for n in names} - set(CASES)
    assert not missing, missing


# ---------------------------------------------------------------------------
# end to end against JAX: the one JAX fixture
# ---------------------------------------------------------------------------

B, S = 4, 16
E2E_TOTAL, NAN_AT = 6, 2           # scenario A: a NaN loss_mask at step 2
POISON, RB_TOTAL = (3, 4), 8       # scenario B2: NaN at data 3 and 4, skip_cap 2
HANG_AT, HANG_TOTAL = 3, 6         # scenario C
GC_KW = dict(grad_spike_factor=1e9, skip_cap=2, patience=99)
LOSS_TOL = 1e-5


def _np_batch(vocab, i, nan=False):
    b = SyntheticLM(vocab, S, B, seed=7).batch_at(i)
    b["loss_mask"] = np.full((B, S), np.nan if nan else 1.0, np.float32)
    return b


def _jpcfg():
    return JParallel(strategy="hecaton", data=1, model=1, mx=1, my=1, microbatches=1,
                     grad_reduce_dtype="fp32")


def _jrc():
    return JRun("t", "train", S, B, lr=2e-3)


@pytest.fixture(scope="module")
def jax_e2e(tmp_path_factory):
    """JAX's side of scenarios A and B2 (and the clean runs)."""
    cfg = jax_smoke("qwen3-0.6b")
    p0 = jlm.init_params(cfg, jax.random.PRNGKey(0))
    gc = JGuard(**GC_KW)
    fn = jax.jit(jstep.build_train_step(cfg, _jpcfg(), _jrc(), None,
                                        compute_dtype=jnp.float32, guard=gc))
    jb = lambda i, nan=False: {k: jnp.asarray(v) for k, v in  # noqa: E731
                               _np_batch(cfg.vocab_size, i, nan).items()}
    # the clean stream (scenario C's reference)
    p, s = p0, JA.init(p0)
    clean = []
    for i in range(HANG_TOTAL):
        p, s, m = fn(p, s, jb(i))
        clean.append(float(m["loss"]))
    # A: the poisoned stream
    p, s = p0, JA.init(p0)
    a_losses, a_skipped = [], []
    for i in range(E2E_TOTAL):
        p, s, m = fn(p, s, jb(i, nan=i == NAN_AT))
        a_losses.append(float(m["loss"]))
        a_skipped.append(float(m["update_skipped"]))
    # B2: skip-cap rollback under run_supervised, async 2-writer checkpoints
    d = str(tmp_path_factory.mktemp("jax_rollback"))
    mgr = JM.AsyncCheckpointManager(d, keep=5, writers=2)
    errors, retired, restored_at = [], [], []
    retire = mgr.retire_steps_after
    mgr.retire_steps_after = lambda step: retired.append((step, retire(step)))

    def make_state(resume_step):
        state, start = {"params": p0, "opt_state": JA.init(p0)}, 0
        if resume_step is not None:
            state, start = mgr.restore(state, step=resume_step)
            restored_at.append(start)
        return state, start

    def run_steps(state, start, inc):
        bl = JG.load_blocklist(d)
        stream = JG.blocklisted_stream(lambda i: jb(i, nan=i in POISON), start, bl)
        try:
            return JL.train(fn, state, stream, start_step=start, num_steps=RB_TOTAL, ckpt=mgr,
                            ckpt_every=2, log_every=1000, guard=JG.TrainingGuard(gc),
                            data_index_fn=lambda s_: JG.data_index(s_, bl),
                            log_fn=lambda *a: None)
        except JG.DivergenceError as e:
            mgr.wait_until_finished()         # the poisoned boundary publishes first
            errors.append(_err(e))
            raise

    state, n = JF.run_supervised(make_state, run_steps, ckpt=mgr, sleep_fn=lambda _: None)
    mgr.close()
    return dict(cfg=cfg, p0=jax.tree.map(np.asarray, p0), clean=clean, a_losses=a_losses,
                a_skipped=a_skipped, rb_n=n, rb_errors=errors, rb_retired=retired,
                rb_restored=restored_at, rb_history=state["history"],
                rb_blocklist=Path(JG.blocklist_path(d)).read_bytes())


def _port_setup(jax_e2e):
    cfg = get_smoke_config("qwen3-0.6b")
    step = tstep.build_train_step(cfg, ParallelConfig(microbatches=1, grad_reduce_dtype="fp32"),
                                  RunConfig("t", "train", S, B, lr=2e-3),
                                  compute_dtype=torch.float32, guard=GuardConfig(**GC_KW))

    def fresh():
        params = master_params_from_jax(jax_e2e["p0"], device="cpu")
        return {"params": params, "opt_state": TA.init(params)}

    def tb(i, nan=False):
        return {k: torch.from_numpy(v) for k, v in _np_batch(cfg.vocab_size, i, nan).items()}
    return cfg, step, fresh, tb


def _flat(state):
    return [t.detach().clone() for t in TM._leaf_paths(
        {"params": state["params"], "opt_state": state["opt_state"]}).values()]


def _equal(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _close(a, b):
    return all(abs(x - y) <= LOSS_TOL * abs(y) for x, y in zip(a, b))


def test_nan_batch_skipped_bit_cleanly_as_in_jax(jax_e2e):
    _, step, fresh, tb = _port_setup(jax_e2e)
    st = fresh()
    p, o = st["params"], st["opt_state"]
    losses, skipped = [], []
    for i in range(E2E_TOTAL):
        if i == NAN_AT:
            before = _flat({"params": p, "opt_state": o})
        p, o, m = step(p, o, tb(i, nan=i == NAN_AT))
        losses.append(float(m["loss"]))
        skipped.append(float(m["update_skipped"]))
        if i == NAN_AT:
            assert _equal(_flat({"params": p, "opt_state": o}), before)
    assert skipped == jax_e2e["a_skipped"] == [float(i == NAN_AT) for i in range(E2E_TOTAL)]
    assert np.isnan(losses[NAN_AT]) and np.isnan(jax_e2e["a_losses"][NAN_AT])
    keep = [i for i in range(E2E_TOTAL) if i != NAN_AT]
    assert _close([losses[i] for i in keep], [jax_e2e["a_losses"][i] for i in keep])
    # the port's own run over the stream without that batch: bit-equal
    st = fresh()
    p2, o2 = st["params"], st["opt_state"]
    clean = []
    for i in keep:
        p2, o2, m = step(p2, o2, tb(i))
        clean.append(float(m["loss"]))
    assert [losses[i] for i in keep] == clean
    assert _equal(_flat({"params": p, "opt_state": o}), _flat({"params": p2, "opt_state": o2}))
    assert int(o.step) == E2E_TOTAL - 1


def _restore(mgr, template, step):
    """A port restore as the launcher makes it: the parameters require grad."""
    state, got = mgr.restore(template, step=step)
    for _, t in tlm.flatten(state["params"]):
        t.requires_grad_(True)
    return state, got


def _clean_filtered(step, fresh, tb, total, bl):
    st = fresh()
    p, o = st["params"], st["opt_state"]
    hist = []
    for s in range(total):
        p, o, m = step(p, o, tb(TG.data_index(s, bl)))
        hist.append((s, float(m["loss"])))
    return hist, _flat({"params": p, "opt_state": o})


def test_skip_cap_rollback_matches_jax(jax_e2e, tmp_path):
    _, step, fresh, tb = _port_setup(jax_e2e)
    d = str(tmp_path / "port")
    mgr = TM.AsyncCheckpointManager(d, keep=5, writers=2)
    errors, retired, restored_at = [], [], []
    retire = mgr.retire_steps_after
    mgr.retire_steps_after = lambda s: retired.append((s, retire(s)))

    def make_state(resume_step):
        state, start = fresh(), 0
        if resume_step is not None:
            state, start = _restore(mgr, state, resume_step)
            restored_at.append(start)
        return state, start

    def run_steps(state, start, inc):
        bl = TG.load_blocklist(d)
        stream = TG.blocklisted_stream(lambda i: tb(i, nan=i in POISON), start, bl)
        try:
            return TL.train(step, state, stream, start_step=start, num_steps=RB_TOTAL, ckpt=mgr,
                            ckpt_every=2, log_every=1000,
                            guard=TG.TrainingGuard(GuardConfig(**GC_KW)),
                            data_index_fn=lambda s_: TG.data_index(s_, bl),
                            log_fn=lambda *a: None)
        except TG.DivergenceError as e:
            mgr.wait_until_finished()
            errors.append(_err(e))
            raise

    state, n = TF.run_supervised(make_state, run_steps, ckpt=mgr, sleep_fn=lambda _: None)
    mgr.close()
    assert n == jax_e2e["rb_n"] == 2
    assert errors == jax_e2e["rb_errors"]
    assert errors[0]["kind"] == "skip_cap" and errors[0]["first_step"] == POISON[0]
    assert errors[0]["data_indices"] == POISON
    assert retired == jax_e2e["rb_retired"] == [(POISON[0], [4])]
    assert restored_at == jax_e2e["rb_restored"] == [2]
    assert Path(TG.blocklist_path(d)).read_bytes() == jax_e2e["rb_blocklist"]
    hist = dict(state["history"])
    jhist = dict(jax_e2e["rb_history"])
    assert _close([hist[s] for s in range(2, RB_TOTAL)], [jhist[s] for s in range(2, RB_TOTAL)])
    want, final = _clean_filtered(step, fresh, tb, RB_TOTAL, list(POISON))
    assert [hist[s] for s in range(2, RB_TOTAL)] == [x for s, x in want[2:]]
    assert _equal(_flat(state), final)


def test_hang_restarts_bit_equal(jax_e2e, tmp_path):
    _, step, fresh, tb = _port_setup(jax_e2e)
    st = fresh()
    float(step(st["params"], st["opt_state"], tb(0))[2]["loss"])   # warm up before arming
    hung = {"n": 0, "done": False}

    def hang_once(p, o, b):
        p, o, m = step(p, o, b)
        if hung["n"] == HANG_AT and not hung["done"]:
            hung["done"] = True
            float(m["loss"])
            time.sleep(0.6)                   # the hang (it returns)
        hung["n"] += 1
        return p, o, m

    mgr = TM.CheckpointManager(str(tmp_path / "hang"))
    wd = TG.Watchdog(0.25, poll=0.02)
    errors = []

    def make_state(resume_step):
        state, start = fresh(), 0
        if resume_step is not None:
            state, start = _restore(mgr, state, resume_step)
        return state, start

    def run_steps(state, start, inc):
        try:
            return TL.train(hang_once, state, (tb(s) for s in range(start, HANG_TOTAL)),
                            start_step=start, num_steps=HANG_TOTAL, ckpt=mgr, ckpt_every=2,
                            log_every=1000, watchdog=wd, log_fn=lambda *a: None)
        except TG.HangError as e:
            errors.append(e)
            raise

    try:
        state, n = TF.run_supervised(make_state, run_steps, ckpt=mgr, sleep_fn=lambda _: None)
    finally:
        wd.close()
    assert n == 2 and len(errors) == 1 and errors[0].step == HANG_AT
    assert errors[0].elapsed > errors[0].timeout == 0.25
    want, final = _clean_filtered(step, fresh, tb, HANG_TOTAL, [])
    hist = dict(state["history"])
    assert [hist[s] for s in range(2, HANG_TOTAL)] == [x for s, x in want[2:]]
    assert _equal(_flat(state), final)
    assert _close([hist[s] for s in range(2, HANG_TOTAL)], jax_e2e["clean"][2:])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

SMOKE = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "16", "--microbatches", "2"]


def _run(argv):
    lines = []
    r = launch_train.run(launch_train.parser().parse_args(SMOKE + argv), log_fn=lines.append)
    return r, lines


@pytest.mark.parametrize("flags", [
    [], ["--guard"], ["--guard", "--no-rollback", "--hang-timeout", "2.5"],
    ["--guard", "--guard-spike-factor", "4", "--guard-loss-spike", "1.5",
     "--guard-patience", "5", "--guard-skip-cap", "7"]])
def test_guard_flags_build_jax_guard_config(flags):
    args = launch_train.parser().parse_args(flags)
    ours, theirs = launch_train._guard_cfg(args), jlaunch._guard_cfg(args)
    assert (ours is None) == (theirs is None) == ("--guard" not in flags)
    if ours is not None:
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert (args.ckpt_writer_timeout, args.ckpt_procs) == (5.0, False)


def test_megatron_grid_checkpoint_and_guard_resume_as_jax(tmp_path):
    """``--strategy megatron`` with ``--guard`` and the checkpoint flags: a
    1x2x2 megatron grid saves step 2 through a writer fleet
    (``--ckpt-procs``, two writers); JAX's ``CheckpointManager`` restores
    it on one device and takes steps 2 and 3 with its guarded step; the
    megatron grid resumed from the same directory (writer threads)
    reports the same losses (1e-5) and skips nothing."""
    d = str(tmp_path / "meg")
    grid = ["--mx", "2", "--my", "2", "--strategy", "megatron", "--overlap", "fused", "--guard"]
    _run(["--steps", "2", "--ckpt-dir", d, "--ckpt-every", "2", "--ckpt-procs",
          "--ckpt-writers", "2"] + grid)
    shutil.copytree(d, d + "_jax")                  # JAX reads an untouched copy
    resumed, lines = _run(["--steps", "4", "--ckpt-dir", d, "--ckpt-every", "100"] + grid)
    assert "restored checkpoint at step 2" in lines
    cfg = jax_smoke("qwen3-0.6b")
    p0 = jlm.init_params(cfg, jax.random.PRNGKey(0))
    state, start = JM.CheckpointManager(d + "_jax").restore({"params": p0,
                                                             "opt_state": JA.init(p0)})
    assert start == 2
    fn = jax.jit(jstep.build_train_step(
        cfg, JParallel(strategy="hecaton", data=1, model=1, mx=1, my=1, microbatches=2),
        JRun("custom", "train", 16, 4, lr=3e-4), None, total_steps=launch_train.LR_HORIZON,
        compute_dtype=jnp.float32, guard=JGuard()))
    ds = JSynthetic(cfg.vocab_size, 16, 4)
    p, s, want = state["params"], state["opt_state"], []
    for i in (2, 3):
        p, s, m = fn(p, s, {k: jnp.asarray(v) for k, v in ds.batch_at(i).items()})
        want.append(float(m["loss"]))
    assert [st for st, _ in resumed["history"]] == [2, 3]
    assert _close([x for _, x in resumed["history"]], want), (resumed["history"], want)
    assert all(v == [0.0, 0.0] for v in resumed["skipped"].values())


def test_launcher_blocklist_moves_the_data(tmp_path):
    bl = [2, 3]
    d = str(tmp_path / "ck")
    _run(["--steps", "2", "--ckpt-dir", d, "--ckpt-every", "2"])
    TG.publish_blocklist(d, bl)
    resumed, lines = _run(["--steps", "4", "--ckpt-dir", d, "--ckpt-every", "100", "--guard"])
    assert f"blocklist: skipping poisoned data indices {bl}" in lines
    stream = JG.blocklisted_stream(lambda i: i, 2, bl)
    assert resumed["first_data_index"] == TG.data_index(2, bl) == next(stream) == 4
    # a run over the filtered stream from the start: the same steps 2 and 3
    f = str(tmp_path / "filtered")
    TG.publish_blocklist(f, bl)
    whole, _ = _run(["--steps", "4", "--ckpt-dir", f, "--ckpt-every", "100", "--guard"])
    assert resumed["history"] == whole["history"][2:]


def test_launcher_ckpt_procs_resumes_bit_exact(tmp_path):
    d = str(tmp_path / "ck")
    procs = ["--ckpt-dir", d, "--ckpt-every", "2", "--ckpt-procs", "--ckpt-writers", "2"]
    first, _ = _run(["--steps", "2"] + procs)
    assert first["ckpt"]["handover"] == "shm" and len(first["ckpt"]["spawn_s"]) == 2
    assert [w["step"] for w in first["ckpt"]["writes"]] == [2]
    resumed, lines = _run(["--steps", "4"] + procs)
    assert "restored checkpoint at step 2" in lines
    whole, _ = _run(["--steps", "4"])
    assert resumed["history"] == whole["history"][2:]
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000004"]


def test_grid_guard_ckpt_procs_blocklist_and_lr_horizon(tmp_path):
    """One 1x2x2 gloo world with --guard --ckpt-procs and a blocklist,
    resuming a checkpoint whose optimizer step is 5000 (past warm-up, so
    the rate shows the schedule's horizon)."""
    bl, start = [1, 2], 1
    a = str(tmp_path / "a")
    _run(["--steps", "1", "--ckpt-dir", a, "--ckpt-every", "1", "--ckpt-sync"])
    src = TM.CheckpointManager(a)
    cfg = get_smoke_config("qwen3-0.6b")
    params, opt = tstep.init_train_state(cfg, device="cpu")
    state, _ = src.restore({"params": params, "opt_state": opt})
    state["opt_state"] = state["opt_state"]._replace(step=torch.tensor(5000, dtype=torch.int32))
    g, one = str(tmp_path / "grid"), str(tmp_path / "one")
    TM.CheckpointManager(g).save(start, state)
    TG.publish_blocklist(g, bl)
    shutil.copytree(g, one)
    flags = ["--steps", "3", "--guard", "--ckpt-procs", "--ckpt-writers", "2", "--ckpt-every", "1"]
    grid, lines = _run(flags + ["--ckpt-dir", g, "--mx", "2", "--my", "2"])
    single, _ = _run(flags + ["--ckpt-dir", one])
    assert f"restored checkpoint at step {start}" in lines
    hists = grid["histories"]
    assert len(hists) == 4 and all(h == hists[0] for h in hists.values())
    assert all(s == [0.0, 0.0] for s in grid["skipped"].values())
    assert grid["first_data_index"] == single["first_data_index"] == TG.data_index(start, bl) == 3
    assert [s for s, _ in hists[0]] == [s for s, _ in single["history"]] == [1, 2]
    assert _close([x for _, x in hists[0]], [x for _, x in single["history"]])
    assert set(grid["pids"]["writer_parents"].values()) == {grid["pids"]["rank"]}
    assert grid["ckpt"]["handover"] == "shm"
    assert sorted(os.listdir(g)) == ["blocklist.json", "step_00000001", "step_00000002",
                                     "step_00000003"]
    # the schedule's horizon: 10,000 steps, as the JAX launcher's, not --steps
    rc = RunConfig("custom", "train", 16, 4, lr=3e-4)
    want = [float(TA.lr_schedule(rc, torch.tensor(5000 + i), 10_000)) for i in range(2)]
    assert launch_train.LR_HORIZON == 10_000
    assert grid["lrs"] == single["lrs"] == want
    assert want[0] != float(TA.lr_schedule(rc, torch.tensor(5000), 3))
