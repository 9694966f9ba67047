"""The drift witness (radargnn_tpu_torch.witness, put in place by
smoke._witness_kernels): the fused aggregations' plain versions with their
float32 sums re-associated.

It replaces every kernel wrapper the plain path replaces. On seeded
real-valued float32 inputs each re-associated sum is within rtol 1e-5 of
the plain version's (of the output's scale), with the same routing bits,
and not bitwise equal to it, so the witness really adds it in another
order. Under `_witness_kernels()` the three aggregations and their
gradients agree with the JAX package's fused functions in interpret mode,
on the cases and to the tolerances (rtol/atol 1e-4) of
tests/test_torch_dense_aggregate.py, test_torch_windowed.py and
test_torch_csr.py, whose set-ups these are."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radargnn_tpu_torch import smoke, witness
from radargnn_tpu_torch.ops import csr_aggregate as ca
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.ops import segment_sum as ss
from radargnn_tpu_torch.ops import windowed_aggregate as wa
from tests import test_torch_csr as tc
from tests import test_torch_dense_aggregate as td
from tests import test_torch_windowed as tw

RTOL = ATOL = 1e-4          # the aggregation tests' tolerance against JAX
SUM_RTOL = 1e-5             # a re-associated sum against the plain one
_MODULES = (da, ss, wa, ca)


def _replaced(context) -> set:
    """The module attributes of the aggregation modules that `context`
    replaces, checked to be put back after it."""
    before = {(m.__name__, n): getattr(m, n) for m in _MODULES
              for n in dir(m)}
    with context():
        inside = {k: getattr(m, k[1]) for m in _MODULES for k in before
                  if k[0] == m.__name__}
    assert all(getattr(m, n) is before[m.__name__, n]
               for m in _MODULES for n in dir(m))
    return {k for k, v in before.items() if inside[k] is not v}


def test_witness_replaces_every_wrapper_the_plain_path_replaces():
    """The same eight wrappers, each by the witness of its name (the CSR
    backward through `smoke.without_landing`), none by its plain version."""
    names = {(m.__name__, n) for m, n in smoke.KERNEL_WRAPPERS} \
        | {(ca.__name__, "csr_bwd")}
    assert len(names) == 8
    assert _replaced(smoke._plain_kernels) == names
    assert _replaced(smoke._witness_kernels) == names
    with smoke._witness_kernels():
        for m, n in smoke.KERNEL_WRAPPERS:
            assert getattr(m, n) is getattr(witness, n)
            assert getattr(m, n) is not getattr(m, f"{n}_plain")


def _seeded(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


def _routed_bwd(fwd, bwd, fwd_args, fwd_kw, bwd_layout, bwd_kw, landing,
                e_p, w_e_p, n_ovf):
    """A bits-routed path's gather-max (out, inner, bits) and backward
    (d_e, dW_e, d_ys, d_yo) from `fwd` and `bwd` (the plain versions or
    the witness's): the forward's bits, a seeded g and overflow rows."""
    out, inner, bits = fwd(*fwd_args, emit_inner=True, **fwd_kw)
    g = torch.where(inner > da._NEG / 2, _seeded(3, inner.shape), 0.0)
    d_op_o = _seeded(4, (n_ovf, inner.shape[1]))
    grads = bwd(bits, g, e_p, w_e_p, d_op_o, *bwd_layout, *landing,
                **bwd_kw)
    return dict(zip(("gather-max out", "gather-max inner", "bits",
                     "d_e = d_op @ W_e^T", "dW_e = e_t^T @ d_op",
                     "landing d_ys", "landing d_yo"),
                    (out, inner, bits, *grads)))


def _dense(plain: bool):
    """The dense path on the dense set-up: the projection, B1's gather-max
    and B2's backward, the plain versions or (not `plain`) the witness."""
    geo, a = td._dense_setup()
    x, w_s, e_t, w_e, offset, e_ovf, t_win, sloc, ovf_s, ovf_r = \
        td._port_args(a)
    y_s, _, inner_o, e_p, w_e_p = da.project_operands(
        x, w_s, e_t, w_e, e_ovf, ovf_s, ovf_r, geo["n"])
    res = _routed_bwd(
        da.dense_fwd_plain if plain else witness.dense_fwd,
        da.dense_bwd_plain if plain else witness.dense_bwd,
        (y_s, e_p, w_e_p, sloc, t_win, inner_o, offset),
        dict(r_tile=geo["r_tile"], k=geo["K"], node_block=geo["node_block"]),
        (), dict(r_tile=geo["r_tile"], k=geo["K"]), td._landing(geo, a),
        e_p, w_e_p, ovf_s.shape[0])
    proj = da.dense_proj_plain if plain else witness.dense_proj
    return dict(res, **{"y_s = x @ W_s": proj(x, w_s)})


def _windowed(plain: bool):
    """The windowed path on the windowed set-up: B4's gather-max and its
    backward, the plain versions or (not `plain`) the witness."""
    geo, a = tw._agg_setup()
    t = {k: torch.from_numpy(np.ascontiguousarray(a[k])) for k in a}
    y_s, _, inner_o, e_p, w_e_p = da.project_operands(
        t["x"], t["w_s"], t["e_t"], t["w_e"], t["e_ovf"], t["ovf_s"],
        t["ovf_r"], geo["n"])
    return _routed_bwd(
        wa.windowed_fwd_plain if plain else witness.windowed_fwd,
        wa.windowed_bwd_plain if plain else witness.windowed_bwd,
        (y_s, e_p, w_e_p, t["recv"], t["sloc"], t["tile_win"], t["blocks"],
         inner_o, t["offset"]),
        dict(node_block=geo["node_block"], edge_tile=geo["edge_tile"]),
        (t["recv"],), dict(edge_tile=geo["edge_tile"]), tw._landing(geo, a),
        e_p, w_e_p, t["ovf_s"].shape[0])


def _csr(plain: bool):
    """The CSR path on the CSR set-up (conv width 40): B5's forward and its
    backward's four sums, and B3 over its landing, the plain versions or
    (not `plain`) the witness."""
    geo, a = tc._agg_setup(h=40)
    x, w_s, e_t, w_e = ca.csr_operands(
        *(torch.from_numpy(np.ascontiguousarray(a[k]))
          for k in ("x", "w_s", "e_t", "w_e")))
    lay = [torch.from_numpy(a[k]) for k in ("senders", "recv", "blocks")]
    kw = dict(node_block=geo["node_block"], edge_tile=geo["edge_tile"])
    fwd = ca.csr_fwd_plain if plain else witness.csr_fwd
    bwd = ca.csr_bwd_plain if plain else witness.csr_bwd
    out, inner = fwd(x, w_s, e_t, w_e, *lay, torch.from_numpy(a["offset"]),
                     emit_inner=True, **kw)
    has = inner > da._NEG / 2
    grads = bwd(x, w_s, e_t, w_e, *lay, torch.where(has, inner, 0.0),
                torch.where(has, _seeded(7, inner.shape), 0.0), **kw)
    order, row_ptr = tc._landing(geo, a, True)
    rows = _seeded(5, (int(order.max()) + 1, 24))
    segsum = ss.segment_sum_csr_plain if plain else witness.segment_sum_csr
    return dict(zip(("gather-max out", "gather-max inner",
                     "d_xg = d_op @ W_s^T", "d_e = d_op @ W_e^T",
                     "dW_s = x_g^T @ d_op", "dW_e = e_t^T @ d_op",
                     "segment_sum_csr"),
                    (out, inner, *grads, segsum(rows, order, row_ptr))))


# each path's plain versions or witnesses on seeded real-valued float32
# inputs
_PATHS = {"dense": _dense, "windowed": _windowed, "csr": _csr}


@pytest.mark.parametrize("path", list(_PATHS))
def test_drift_witness_is_the_same_function(path):
    """The witness's forward and backward on each path (the dense and the
    windowed projection, gather-max and routed backward; the CSR forward,
    backward and landing) add their float32 sums in other orders: every
    output within SUM_RTOL of the plain version's (of its scale), the
    routing bits the same."""
    got, want = _PATHS[path](False), _PATHS[path](True)
    assert got.keys() == want.keys()
    if "bits" in want:                       # the routing: exactly equal
        assert torch.equal(got.pop("bits"), want.pop("bits"))
    for name, u in got.items():
        v = want[name]
        assert u.shape == v.shape and u.dtype == v.dtype, name
        assert torch.isfinite(u).all(), name
        scale = float(v.abs().max())
        torch.testing.assert_close(u, v, rtol=SUM_RTOL,
                                   atol=SUM_RTOL * scale, msg=name)


@pytest.mark.parametrize("path", list(_PATHS))
def test_witness_reorders_each_sum(path):
    """Each re-associated sum (the forward products' depths and so the
    maxima; d_e, dW_e and the landings of the routed backward; the CSR
    backward's four products; B3's segments) is not bitwise the plain
    version's on seeded real-valued float32 inputs: the witness really
    adds it in another order."""
    got, want = _PATHS[path](False), _PATHS[path](True)
    same = [n for n, u in got.items()
            if n != "bits" and torch.equal(u, want[n])]
    assert not same, f"{path}: bitwise the plain version's: {same}"


def test_reversed_segments_reverses_each_segment():
    order = torch.tensor([4, 0, 2, 7, 1, 3, 5], dtype=torch.int32)
    row_ptr = torch.tensor([0, 3, 3, 4, 7], dtype=torch.int32)
    assert witness.reversed_segments(order, row_ptr).tolist() == \
        [2, 0, 4, 7, 5, 3, 1]


def _witness_grads(port_grads, *args):
    with smoke._witness_kernels():
        return port_grads(*args)


@pytest.mark.parametrize("variable_degree", [True, False])
def test_dense_witness_matches_jax_interpret(variable_degree):
    """The dense aggregation and its six gradients on the witness against
    `make_fused_dense_aggregate` in interpret mode."""
    geo, a = td._dense_setup(variable_degree=variable_degree)
    fused = td.jpk.make_fused_dense_aggregate(
        geo["n"], geo["K"], geo["r_tile"], geo["node_block"], geo["wb"])
    want = np.asarray(fused(
        *map(jnp.asarray, (a["x"], a["w_s"], a["e_t"], a["w_e"],
                           a["offset"], a["e_ovf"], a["tile_win"],
                           a["sloc"], a["pmask"], a["ovf_s"], a["ovf_r"]))))
    with smoke._witness_kernels():
        got = da.dense_aggregate(*td._port_args(a), r_tile=geo["r_tile"],
                                 k=geo["K"], node_block=geo["node_block"])
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.numpy() == 0, want == 0)
    got = _witness_grads(td._port_grads, geo, a)
    for name, u, v in zip(td._DIFF, got, td._jax_grads(geo, a)):
        np.testing.assert_allclose(u, v, rtol=RTOL, atol=ATOL, err_msg=name)
    assert np.abs(got[5]).max() > 0, "the overflow path should take g"


@pytest.mark.parametrize("run_cap", [None, 2])
def test_windowed_witness_matches_jax_interpret(run_cap):
    """The windowed aggregation and its six gradients on the witness
    against `make_fused_hoisted_aggregate_v3` in interpret mode."""
    geo, a = tw._agg_setup(seed=37, run_cap=run_cap)
    want = np.asarray(tw._jax_fused(geo)(
        *(jnp.asarray(a[k]) for k in tw._DIFF), *tw._jax_consts(a)))
    with smoke._witness_kernels():
        got = tw._port_call(geo, a)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.numpy() == 0, want == 0)
    got = _witness_grads(tw._port_grads, geo, a)
    for name, u, v in zip(tw._DIFF, got, tw._jax_grads(geo, a)):
        np.testing.assert_allclose(u, v, rtol=RTOL, atol=ATOL, err_msg=name)
    assert np.abs(got[5]).max() > 0, "the overflow path should take g"


@pytest.mark.parametrize("hub", [False, True])
def test_csr_witness_matches_jax_interpret(hub):
    """The CSR aggregation and its five gradients on the witness (d_x
    landed through the re-associated segment sum) against
    `make_fused_hoisted_aggregate_v2` in interpret mode."""
    geo, a = tc._agg_setup(seed=17, hub=hub)
    want = np.asarray(tc._jax_fused(geo, a, True)(
        *(jnp.asarray(a[k]) for k in tc._DIFF)))
    with smoke._witness_kernels():
        got = tc._port_call(geo, a)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.numpy() == 0, want == 0)
    got = _witness_grads(tc._port_grads, geo, a)
    for name, u, v in zip(tc._DIFF, got, tc._jax_grads(geo, a)):
        np.testing.assert_allclose(u, v, rtol=RTOL, atol=ATOL, err_msg=name)
    assert np.abs(got[2]).max() > 0
