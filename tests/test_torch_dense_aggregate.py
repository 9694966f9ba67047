"""The port's dense max aggregation (radargnn_tpu_torch.ops.dense_aggregate)
and segment max against the JAX package.

On the CPU the wrapper takes the kernel's plain PyTorch version; the JAX side
runs its Pallas kernel in interpret mode, set up as tests/test_pallas.py's
dense (v4) tests set it up. Both compute in float32 there, so they agree to
float32 summation order (rtol/atol 1e-4, the tolerance of the JAX package's
own kernel-vs-XLA test). The CUDA kernel itself runs only on the card
(tests/test_torch_gpu.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radargnn_tpu.ops import pallas_kernels as jpk
from radargnn_tpu.ops import segment as jseg
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.ops import dense_tiles as tdt
from radargnn_tpu_torch.ops import segment as tseg

RTOL = ATOL = 1e-4


def _dense_setup(seed=7, K=7, variable_degree=True):
    """tests/test_pallas.py's `_dense_setup`: a small graph and its dense
    tiling from the JAX package's host tiler. Variable in-degree exercises
    the over-degree spill and window overflow."""
    rng = np.random.default_rng(seed)
    n, d_in, de, h = 96, 24, 8, 32
    r_tile, node_block, wb = 8, 16, 2
    if variable_degree:
        e = 400
        send = rng.integers(0, 80, e).astype(np.int32)
        recv = rng.integers(0, 80, e).astype(np.int32)
        mask = rng.random(e) < 0.9
    else:
        nv = 80
        recv = np.repeat(np.arange(nv), K).astype(np.int32)
        send = rng.integers(0, nv, nv * K).astype(np.int32)
        e = nv * K
        mask = np.ones(e, bool)
        mask[recv == 3] = ([True, False] * K)[:K]
    x = rng.normal(size=(n, d_in)).astype(np.float32)
    w_s = (rng.normal(size=(d_in, h)) * 0.3).astype(np.float32)
    e_feat = rng.normal(size=(e, de)).astype(np.float32)
    w_e = (rng.normal(size=(de, h)) * 0.3).astype(np.float32)
    offset = rng.normal(size=(n, h)).astype(np.float32)
    te = r_tile * K
    perm, sloc, tile_win, ovf_idx = jpk.prepare_dense_knn_tiles(
        send, recv, mask, n, K, r_tile, node_block, wb,
        ovf_budget=-(-e // te) * te)
    pmask = jpk.window_part_mask(tile_win, -(-n // node_block), wb)
    ovf_valid = ovf_idx >= 0
    ovf_s = np.where(ovf_valid, send[np.maximum(ovf_idx, 0)], 0)
    ovf_r = np.where(ovf_valid, recv[np.maximum(ovf_idx, 0)], -1)
    e_ovf = np.where(ovf_valid[:, None], e_feat[np.maximum(ovf_idx, 0)],
                     0.0).astype(np.float32)
    geo = dict(n=n, K=K, r_tile=r_tile, node_block=node_block, wb=wb)
    arrays = dict(x=x, w_s=w_s, e_feat=e_feat, w_e=w_e, offset=offset,
                  send=send, recv=recv, mask=mask, perm=perm, sloc=sloc,
                  tile_win=tile_win, ovf_idx=ovf_idx, pmask=pmask,
                  ovf_s=ovf_s.astype(np.int32), ovf_r=ovf_r.astype(np.int32),
                  e_t=e_feat[perm], e_ovf=e_ovf)
    return geo, arrays


def _port_args(a):
    t = {k: torch.from_numpy(np.ascontiguousarray(a[k])) for k in
         ("x", "w_s", "e_t", "w_e", "offset", "e_ovf", "tile_win", "sloc",
          "ovf_s", "ovf_r")}
    return (t["x"], t["w_s"], t["e_t"], t["w_e"], t["offset"], t["e_ovf"],
            t["tile_win"], t["sloc"], t["ovf_s"], t["ovf_r"])


@pytest.mark.parametrize("variable_degree", [True, False])
def test_dense_tiler_matches_jax(variable_degree):
    """The port's copy of the host tiler gives the JAX package's plan."""
    geo, a = _dense_setup(variable_degree=variable_degree)
    te = geo["r_tile"] * geo["K"]
    got = tdt.prepare_dense_knn_tiles(
        a["send"], a["recv"], a["mask"], geo["n"], geo["K"], geo["r_tile"],
        geo["node_block"], geo["wb"],
        ovf_budget=-(-a["send"].shape[0] // te) * te)
    for g, w, name in zip(got, (a["perm"], a["sloc"], a["tile_win"],
                                a["ovf_idx"]),
                          ("perm", "sloc", "tile_win", "ovf_idx")):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(
        tdt.window_part_mask(a["tile_win"], -(-geo["n"] // geo["node_block"]),
                             geo["wb"]), a["pmask"])


@pytest.mark.parametrize("variable_degree", [True, False])
@pytest.mark.parametrize("widths", [None, (21, 5)])
def test_dense_aggregate_matches_jax_interpret(variable_degree, widths):
    """`widths` (d_in, d_e) cut the features to widths that are not
    multiples of 8, which the entry point zero-pads for the kernel."""
    geo, a = _dense_setup(variable_degree=variable_degree)
    assert (a["ovf_idx"] >= 0).sum() > 10, "test should exercise overflow"
    if widths is not None:
        d, de = widths
        a = dict(a, x=a["x"][:, :d], w_s=a["w_s"][:d], w_e=a["w_e"][:de],
                 e_t=a["e_t"][:, :de], e_ovf=a["e_ovf"][:, :de])
    fused = jpk.make_fused_dense_aggregate(
        geo["n"], geo["K"], geo["r_tile"], geo["node_block"], geo["wb"])
    want = np.asarray(fused(
        *map(jnp.asarray, (a["x"], a["w_s"], a["e_t"], a["w_e"],
                           a["offset"], a["e_ovf"], a["tile_win"],
                           a["sloc"], a["pmask"], a["ovf_s"], a["ovf_r"]))))
    x, w_s, e_t, w_e, offset, e_ovf, t_win, sloc, ovf_s, ovf_r = \
        _port_args(a)
    launches = da.dense_fwd_cuda.launches
    got = da.dense_aggregate(x, w_s, e_t, w_e, offset, e_ovf, t_win, sloc,
                             ovf_s, ovf_r, r_tile=geo["r_tile"], k=geo["K"],
                             node_block=geo["node_block"])
    assert da.dense_fwd_cuda.launches == launches   # CPU: no kernel launch
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the empty receivers (no valid in-edge) are exactly 0 in both
    np.testing.assert_array_equal(got.numpy() == 0, want == 0)


@pytest.mark.parametrize("variable_degree", [True, False])
def test_dense_overflow_inner_matches_jax(variable_degree):
    """Raw overflow maxima: equal where a receiver has overflow edges; both
    below _NEG/2 (the 'no edge' test the epilogue applies) elsewhere."""
    geo, a = _dense_setup(variable_degree=variable_degree)
    want = np.asarray(jpk.dense_overflow_inner(
        *map(jnp.asarray, (a["x"], a["w_s"], a["e_ovf"], a["w_e"],
                           a["ovf_s"], a["ovf_r"])), geo["n"]))
    t = {k: torch.from_numpy(np.asarray(a[k])) for k in a}
    got = da.dense_overflow_inner(t["x"], t["w_s"], t["e_ovf"], t["w_e"],
                                  t["ovf_s"], t["ovf_r"], geo["n"]).numpy()
    has = want > da._NEG / 2
    assert has.any() and (~has).any()
    np.testing.assert_array_equal(got > da._NEG / 2, has)
    np.testing.assert_allclose(got[has], want[has], rtol=RTOL, atol=ATOL)
    assert np.isfinite(got).all()


def test_dense_fwd_plain_masks_dummy_slots_by_sender():
    """Unused slots point at edge 0 (real features): only senders_local < 0
    may mark them empty. A dummy slot with a huge edge feature must not
    leak into the max."""
    geo, a = _dense_setup(variable_degree=True)
    dummy = np.flatnonzero(a["sloc"] < 0)
    assert dummy.size
    x, w_s, e_t, w_e, offset, e_ovf, t_win, sloc, ovf_s, ovf_r = \
        _port_args(a)
    kw = dict(r_tile=geo["r_tile"], k=geo["K"], node_block=geo["node_block"])
    base = da.dense_aggregate(x, w_s, e_t, w_e, offset, e_ovf, t_win, sloc,
                              ovf_s, ovf_r, **kw)
    e_t = e_t.clone()
    e_t[torch.from_numpy(dummy)] = 1e6
    again = da.dense_aggregate(x, w_s, e_t, w_e, offset, e_ovf, t_win, sloc,
                               ovf_s, ovf_r, **kw)
    torch.testing.assert_close(again, base, rtol=0, atol=0)


def test_dense_aggregate_refuses_grad():
    geo, a = _dense_setup()
    args = list(_port_args(a))
    args[1] = args[1].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="B2"):
        da.dense_aggregate(*args, r_tile=geo["r_tile"], k=geo["K"],
                           node_block=geo["node_block"])
    with torch.no_grad():
        da.dense_aggregate(*args, r_tile=geo["r_tile"], k=geo["K"],
                           node_block=geo["node_block"])


def test_dense_fwd_cuda_refuses_cpu_tensors():
    """The kernel's wrapper checks its inputs before it builds or launches:
    it never falls back to the plain version."""
    geo, a = _dense_setup()
    x, w_s, e_t, w_e, offset, e_ovf, t_win, sloc, ovf_s, ovf_r = \
        _port_args(a)
    inner_o = torch.full_like(offset, da._NEG)
    with pytest.raises(ValueError, match="CUDA"):
        da.dense_fwd_cuda(x.bfloat16(), w_s.bfloat16(), e_t.bfloat16(),
                          w_e.bfloat16(), sloc, t_win, inner_o, offset,
                          r_tile=geo["r_tile"], k=geo["K"],
                          node_block=geo["node_block"])


def test_gather_dtype_follows_the_device():
    assert da.gather_dtype(torch.device("cpu")) == torch.float32
    assert da.gather_dtype(torch.device("cuda", 0)) == torch.bfloat16


@pytest.mark.parametrize("masked", [True, False])
def test_segment_max_matches_jax(masked):
    rng = np.random.default_rng(3)
    e, n, h = 60, 13, 5
    data = (rng.normal(size=(e, h)) - 3.0).astype(np.float32)  # all < 0
    seg = rng.integers(0, n - 2, e).astype(np.int32)            # empties
    mask = rng.random(e) < 0.7 if masked else None
    offset = rng.normal(size=(n, h)).astype(np.float32)
    tm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    got = tseg.segment_max(torch.from_numpy(data), torch.from_numpy(seg), n,
                           tm)
    want = jseg.segment_max(jnp.asarray(data), jnp.asarray(seg), n, jm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = tseg.hoisted_segment_max(torch.from_numpy(data),
                                   torch.from_numpy(seg), n, tm,
                                   torch.from_numpy(offset))
    want = jseg.hoisted_segment_max(jnp.asarray(data), jnp.asarray(seg), n,
                                    jm, False, jnp.asarray(offset))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)

