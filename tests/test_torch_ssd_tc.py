"""The SSD scan's tensor-core route (``tc::ssd`` in ``csrc/ssd.cu``) on
the CPU: its arithmetic, emulated in plain PyTorch by
``ref.ssd_tc_emulated``, against the plain version and the JAX package,
and the route choice of ``kernels/ssd.py``.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
marker ``cuda``; ``chip_smoke.py``).  The emulation rounds where the
kernel rounds: x, B and C are bf16; the scores, x o w and the carried
state are each split into bf16 hi + lo for the products; every sum and
the carry are fp32.  It is held, from the same numpy inputs made from a
seed (bf16-exact), against ``ref.ssd_plain`` and against JAX on the CPU
(``repro.models.ssm.ssd_chunked``; the Pallas ``repro.kernels.ssd.ssd``
in interpret mode where S is a multiple of the chunk and the state starts
at zero), at mamba2-130m's prefill shapes (24 heads of dh 64, ds 128,
S = 64, 200, 512) and at small cases: a ragged tail, S under the chunk,
S = 2, groups shared by two heads at batch 2, a random initial state.
Bounds are the kernel's own: y (bf16) 2e-2, the final state (fp32) 2e-4.
"""

import jax
import numpy as np
import pytest
import torch

from repro.kernels import ssd as JSSD
from repro.models import ssm as JSSM
from repro_torch.config import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd as kssd

Y_TOL = dict(rtol=2e-2, atol=2e-2)
STATE_TOL = dict(rtol=2e-4, atol=2e-4)
# name: (b, S, nh, g, chunk, random initial state, Pallas reference)
CASES = {
    "130m-S64": (1, 64, 24, 1, 64, False, True),
    "130m-S200": (1, 200, 24, 1, 128, False, False),
    "130m-S512": (1, 512, 24, 1, 128, False, True),
    "130m-S512-state": (1, 512, 24, 1, 128, True, False),
    "ragged-state": (1, 45, 4, 1, 16, True, False),
    "under-chunk": (1, 7, 4, 1, 16, False, False),
    "S2": (1, 2, 4, 1, 2, True, False),
    "groups-b2": (2, 48, 4, 2, 16, False, True),
}


def _inputs(seed, b, S, nh, g, state):
    """mamba2's scan inputs from a numpy seed: x, B, C bf16-exact, dt near
    0.1 (softplus of a normal shifted by -2.5), A = -(1..nh), so cum falls
    to about -300 within a chunk of 128; the state fp32 or None."""
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    x = bf(rng.standard_normal((b, S, nh, 64)))
    B = bf(rng.standard_normal((b, S, g, 128)))
    C = bf(rng.standard_normal((b, S, g, 128)))
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((b, S, nh)) - 2.5))
                          .astype(np.float32))
    A = -torch.arange(1, nh + 1, dtype=torch.float32)
    h0 = (torch.from_numpy(rng.standard_normal((b, nh, 64, 128)).astype(np.float32))
          if state else None)
    return x, dt, A, B, C, h0


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case_data():
    """Per case: the inputs, the emulated route, the plain version, and
    JAX's (y, final state) from ssd_chunked and, where it applies, y from
    the Pallas kernel in interpret mode."""
    out = {}
    for i, (name, (b, S, nh, g, chunk, state, pallas)) in enumerate(CASES.items()):
        x, dt, A, B, C, h0 = _inputs(i, b, S, nh, g, state)
        np32 = [t.float().numpy() for t in (x, dt, A, B, C)]
        chunked = jax.jit(lambda *a, c=chunk: JSSM.ssd_chunked(*a[:5], chunk=c,
                                                               init_state=a[5]))
        jy, jfin = chunked(*np32, None if h0 is None else h0.numpy())
        out[name] = dict(
            inputs=(x, dt, A, B, C, h0), chunk=chunk,
            tc=ref.ssd_tc_emulated(x, dt, A, B, C, chunk=chunk, init_state=h0),
            plain=ref.ssd_plain(x, dt, A, B, C, chunk=chunk, init_state=h0),
            jax=(torch.from_numpy(np.array(jy)), torch.from_numpy(np.array(jfin))),
            pallas=(torch.from_numpy(np.array(JSSD.ssd(*np32, chunk=chunk, interpret=True)))
                    if pallas else None))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_emulated_route_matches_plain(case_data, name):
    """y within 2e-2 and the fp32 final state within 2e-4 of ref.ssd_plain."""
    d = case_data[name]
    (y, fin), (y_p, fin_p) = d["tc"], d["plain"]
    assert y.dtype == torch.bfloat16 and fin.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_p.float(), **Y_TOL)
    torch.testing.assert_close(fin, fin_p, **STATE_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_emulated_route_matches_jax(case_data, name):
    """The same bounds against JAX's ssd_chunked (fp32 from the same
    bf16-exact inputs), and y against the Pallas kernel where it runs."""
    d = case_data[name]
    (y, fin), (jy, jfin) = d["tc"], d["jax"]
    torch.testing.assert_close(y.float(), jy, **Y_TOL)
    torch.testing.assert_close(fin, jfin, **STATE_TOL)
    if d["pallas"] is not None:
        torch.testing.assert_close(y.float(), d["pallas"], **Y_TOL)


def _excess(a, b, tol):
    """The largest |a - b| / (tol + tol |b|): at most 1 passes allclose."""
    a, b = a.float(), b.float()
    return ((a - b).abs() / (tol + tol * b.abs())).max().item()


def test_split_operands_hold_the_state_with_margin(case_data):
    """Why the kernel splits x o w into bf16 hi + lo: with one bf16
    rounding the final state misses 2e-4 by far at S = 512; split, it lies
    within a tenth of it."""
    d = case_data["130m-S512-state"]
    x, dt, A, B, C, h0 = d["inputs"]
    _, fin_p = d["plain"]
    _, fin_once = ref.ssd_tc_emulated(x, dt, A, B, C, chunk=d["chunk"], init_state=h0,
                                      split_state=False)
    assert _excess(fin_once, fin_p, 2e-4) > 2
    assert _excess(d["tc"][1], fin_p, 2e-4) < 0.1


def test_split_operands_tighten_y(case_data):
    """Splitting the scores and the carried state takes y's worst error at
    S = 512 with a random state well inside its bound; one rounding of
    each (the scores are not normalised, unlike attention's P) leaves it
    within reach of 2e-2."""
    d = case_data["130m-S512-state"]
    x, dt, A, B, C, h0 = d["inputs"]
    y_p, _ = d["plain"]
    y_once, _ = ref.ssd_tc_emulated(x, dt, A, B, C, chunk=d["chunk"], init_state=h0,
                                    split_scores=False, split_h=False)
    split = _excess(d["tc"][0], y_p, 2e-2)
    assert split < 0.5
    assert _excess(y_once, y_p, 2e-2) > 1.5 * split


@pytest.mark.parametrize("S", [2, 7, 64, 127, 128, 200, 300, 512, 2100])
def test_every_mamba2_prefill_takes_the_tensor_cores(S):
    """mamba2-130m's scan (dh 64, ds 128, chunk min(128, S)) takes wgmma
    in bf16 at every prefill length, and SIMT in fp32."""
    s = get_config("mamba2-130m").ssm
    chunk = min(s.chunk_size, S)
    assert kssd.ssd_impl(torch.bfloat16, s.head_dim, s.state_dim, chunk) == "wgmma"
    assert kssd.ssd_impl(torch.float32, s.head_dim, s.state_dim, chunk) == "simt"


@pytest.mark.parametrize("dh,ds,chunk", [(32, 128, 128), (128, 128, 64), (64, 64, 128),
                                         (64, 16, 32), (16, 16, 7)])
def test_other_shapes_take_simt(dh, ds, chunk):
    """Heads other than mamba2's dh 64 / ds 128 stay on SIMT in bf16 too."""
    assert kssd.ssd_impl(torch.bfloat16, dh, ds, chunk) == "simt"


def test_cpu_tensors_take_the_plain_version_and_count_no_launch(case_data):
    """ops.ssd on CPU tensors is ref.ssd_plain bit for bit and counts no
    launch on either route."""
    d = case_data["ragged-state"]
    x, dt, A, B, C, h0 = d["inputs"]
    ops.reset_launches()
    y, fin = ops.ssd(x, dt, A, B, C, chunk=d["chunk"], init_state=h0)
    assert torch.equal(y, d["plain"][0]) and torch.equal(fin, d["plain"][1])
    assert ops.LAUNCHES["ssd"] == 0 and kssd.IMPL_LAUNCHES == {"wgmma": 0, "simt": 0}
