"""The port's v1 hoisted aggregation (radargnn_tpu_torch.ops.hoisted_aggregate)
and its kernel check (benchmarks.kernel_check) against the JAX package.

The same seeded numpy inputs, set up as tests/test_pallas.py sets them up
for `make_fused_hoisted_aggregate` and
`make_fused_hoisted_aggregate_pallas_bwd`, go through the JAX factories in
interpret mode and through the port's factories, whose wrappers take their
plain versions on the CPU. Both compute in float32 there (interpret mode
gathers y_s in float32); the JAX forward lands a mean of equal maxima,
about 1e-7 relative from the port's exact max, which the backward's 1e-5
routing tolerance covers. So the forward and every gradient agree to
float32 summation order (rtol/atol 1e-4). The CUDA kernels run on the card
only (tests/test_torch_gpu.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radargnn_tpu.ops import pallas_kernels as jpk
from radargnn_tpu_torch.benchmarks import kernel_check
from radargnn_tpu_torch.ops import csr_aggregate as ca
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.ops import hoisted_aggregate as ha
from radargnn_tpu_torch.ops import windowed_tiles as wt

RTOL = ATOL = 1e-4
FACTORIES = ["make_fused_hoisted_aggregate",
             "make_fused_hoisted_aggregate_pallas_bwd"]
_DIFF = ("y_s", "w_e", "b", "offset")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(seed, n=96, e=500, de=8, h=32, node_block=32, edge_tile=32):
    """tests/test_pallas.py's v1 case: random senders and receivers, mask
    0.9, the receiver-CSR tiles (the port's tiler, asserted identical)."""
    rng = np.random.default_rng(seed)
    c = dict(
        y_s=rng.normal(size=(n, h)).astype(np.float32),
        e_feat=rng.normal(size=(e, de)).astype(np.float32),
        w_e=(rng.normal(size=(de, h)) * 0.3).astype(np.float32),
        b=rng.normal(size=(h,)).astype(np.float32),
        offset=rng.normal(size=(n, h)).astype(np.float32),
        senders=rng.integers(0, n, e).astype(np.int32),
        receivers=rng.integers(0, n, e).astype(np.int32),
        mask=rng.random(e) < 0.9, n=n, node_block=node_block,
        edge_tile=edge_tile)
    tiles = wt.prepare_csr_tiles(c["receivers"], c["mask"], n, node_block,
                                 edge_tile)
    for a, j in zip(tiles, jpk.prepare_csr_tiles(
            c["receivers"], c["mask"], n, node_block, edge_tile)):
        np.testing.assert_array_equal(a, j)
    c["perm"], c["tile_blocks"], c["padded_recv"] = tiles
    c["senders_t"] = c["senders"][c["perm"]]
    c["e_t"] = c["e_feat"][c["perm"]]
    return c


def _layout(c, to):
    return tuple(to(c[k]) for k in ("senders_t", "padded_recv",
                                    "tile_blocks"))


def _jax_run(c, factory):
    """The JAX factory in interpret mode: out, the gradients of
    sum(out ** 2) in (y_s, e_t, w_e, b, offset)."""
    fused = getattr(jpk, factory)(c["n"], c["node_block"], c["edge_tile"],
                                  interpret=True)
    layout = _layout(c, jnp.asarray)

    def f(y_s, e_t, w_e, b, offset):
        return fused(y_s, e_t, w_e, b, *layout, offset)

    args = tuple(jnp.asarray(c[k]) for k in ("y_s", "e_t", "w_e", "b",
                                             "offset"))
    out = f(*args)
    grads = jax.grad(lambda *a: (f(*a) ** 2).sum(),
                     argnums=(0, 1, 2, 3, 4))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_run(c, factory):
    fused = getattr(ha, factory)(c["n"], c["node_block"], c["edge_tile"])
    leaves = [_t(c[k]).requires_grad_(True)
              for k in ("y_s", "e_t", "w_e", "b", "offset")]
    out = fused(*leaves[:4], *_layout(c, _t), leaves[4])
    grads = torch.autograd.grad((out ** 2).sum(), leaves)
    return out.detach().numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("factory", FACTORIES)
def test_hoisted_forward_and_gradients_match_jax(factory):
    """Each factory: the output, the gradients of y_s, w_e, b and offset,
    and e_t's gradient both per slot and mapped back through perm to the
    edges (the dummy slots map to edge 0 with a zero cotangent)."""
    c = _case(9 if factory == FACTORIES[0] else 11)
    j_out, j_grads = _jax_run(c, factory)
    t_out, t_grads = _torch_run(c, factory)
    np.testing.assert_allclose(t_out, j_out, rtol=RTOL, atol=ATOL)
    for name, u, v in zip(("y_s", "e_t", "w_e", "b", "offset"), t_grads,
                          j_grads):
        np.testing.assert_allclose(u, v, rtol=RTOL, atol=ATOL, err_msg=name)
    edges_t = np.zeros_like(c["e_feat"])
    np.add.at(edges_t, c["perm"], t_grads[1])
    edges_j = np.zeros_like(c["e_feat"])
    np.add.at(edges_j, c["perm"], j_grads[1])
    np.testing.assert_allclose(edges_t, edges_j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("factory", FACTORIES)
def test_hoisted_matches_the_segment_max_formulation(factory):
    """The port's factory against the XLA formulation of
    tests/test_pallas.py (hoisted_segment_max with b inside the operand),
    run in JAX on the untiled edges."""
    from radargnn_tpu.ops.segment import hoisted_segment_max

    c = _case(12)
    args = tuple(jnp.asarray(c[k]) for k in ("y_s", "e_feat", "w_e", "b",
                                             "offset"))

    def f_xla(y_s, e_feat, w_e, b, offset):
        operand = y_s[jnp.asarray(c["senders"])] + e_feat @ w_e + b
        return hoisted_segment_max(operand, jnp.asarray(c["receivers"]),
                                   c["n"], jnp.asarray(c["mask"]), False,
                                   offset)

    want = np.asarray(f_xla(*args))
    g_want = jax.grad(lambda *a: (f_xla(*a) ** 2).sum(),
                      argnums=(0, 2, 3, 4))(*args)
    t_out, t_grads = _torch_run(c, factory)
    np.testing.assert_allclose(t_out, want, rtol=RTOL, atol=ATOL)
    for name, u, v in zip(_DIFF, [t_grads[i] for i in (0, 2, 3, 4)],
                          g_want):
        np.testing.assert_allclose(u, np.asarray(v), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def _tie_case():
    """Two slots of one receiver with the same sender and edge features:
    equal operands, an exact tie at every column."""
    c = _case(13, n=64, e=200, de=4, h=16, node_block=32, edge_tile=32)
    c["senders"][1] = c["senders"][0]
    c["receivers"][1] = c["receivers"][0]
    c["mask"][:2] = True
    c["e_feat"][1] = c["e_feat"][0]
    c["y_s"][c["senders"][0]] += 50.0      # make the pair the max
    tiles = wt.prepare_csr_tiles(c["receivers"], c["mask"], c["n"], 32, 32)
    c["perm"], c["tile_blocks"], c["padded_recv"] = tiles
    c["senders_t"] = c["senders"][c["perm"]]
    c["e_t"] = c["e_feat"][c["perm"]]
    return c


@pytest.mark.parametrize("factory", FACTORIES)
def test_tied_slots_each_take_the_full_gradient(factory):
    """The full-g tie rule: both tied slots route the whole g (no split),
    in the JAX package and in the port, so e_t's per-slot gradient is the
    same at both and y_s's gradient at the shared sender counts g twice."""
    c = _tie_case()
    slots = np.flatnonzero(np.isin(c["perm"], [0, 1])
                           & (c["padded_recv"] >= 0))
    assert len(slots) == 2
    _, j_grads = _jax_run(c, factory)
    _, t_grads = _torch_run(c, factory)
    for grads in (j_grads, t_grads):
        np.testing.assert_array_equal(grads[1][slots[0]], grads[1][slots[1]])
        assert np.abs(grads[1][slots[0]]).max() > 0
    np.testing.assert_allclose(t_grads[0], j_grads[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_grads[1], j_grads[1], rtol=RTOL, atol=ATOL)


def test_backward_gates_padding_slots():
    """A padding slot whose operand equals receiver 0's inner_z, with a
    nonzero g there: the JAX backward kernel gives it no gradient (its
    one-hot selects no receiver), and the port's gate (a slot counts only
    where its receiver lies in its tile's node block) agrees."""
    c = _case(14)
    recv = c["padded_recv"]
    pad = int(np.flatnonzero(recv < 0)[0])
    op = (c["y_s"][c["senders_t"]] + c["e_t"] @ c["w_e"]) + c["b"]
    inner_z = np.zeros((c["n"], c["y_s"].shape[1]), np.float32)
    inner_z[0] = op[pad]
    g = np.zeros_like(inner_z)
    g[0] = 1.0
    add = c["y_s"][c["senders_t"]]
    d_op, d_e, d_w = jpk._hoisted_bwd_call(
        jnp.asarray(add), jnp.asarray(c["e_t"]), jnp.asarray(c["w_e"]),
        jnp.asarray(c["b"]), jnp.asarray(recv), jnp.asarray(c["tile_blocks"]),
        jnp.asarray(inner_z), jnp.asarray(g), c["n"], c["node_block"],
        c["edge_tile"], True)
    got = ha.hoisted_bwd(*(_t(c[k]) for k in ("y_s", "e_t", "w_e", "b")),
                         *_layout(c, _t), _t(inner_z), _t(g),
                         node_block=c["node_block"],
                         edge_tile=c["edge_tile"])
    assert np.all(np.asarray(d_op)[pad] == 0)
    assert torch.all(got[0][pad] == 0) and torch.all(got[1][pad] == 0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(d_op), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(d_e), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(d_w), rtol=RTOL,
                               atol=ATOL)
    # without the gate the padding slot would take receiver 0's g
    ungated = (np.abs(op[pad] - inner_z[0])
               <= 1e-5 * np.abs(inner_z[0]) + 1e-5)
    assert ungated.all()


@pytest.mark.parametrize("factory", FACTORIES)
def test_hoisted_gradients_match_jax_at_odd_widths(factory):
    """d_e 3 and H 40, the odd widths of the card's v1 tests (features
    padded to eight and a partial 64-column slice in the card's backward):
    the output and the five gradients against the JAX factory."""
    c = _case(16, de=3, h=40)
    j_out, j_grads = _jax_run(c, factory)
    t_out, t_grads = _torch_run(c, factory)
    np.testing.assert_allclose(t_out, j_out, rtol=RTOL, atol=ATOL)
    for name, u, v in zip(("y_s", "e_t", "w_e", "b", "offset"), t_grads,
                          j_grads):
        assert u.shape == v.shape, name
        np.testing.assert_allclose(u, v, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("kernel", ["hoisted_fwd_cuda", "hoisted_bwd_cuda"])
def test_kernel_wrappers_refuse_cpu_tensors(kernel):
    """The v1 kernels' wrappers check their inputs before they build or
    launch: a CPU tensor never falls back to the plain version there."""
    c = _case(17)
    node = _t(np.zeros((c["n"], c["y_s"].shape[1]), np.float32))
    nodes = (node,) if kernel == "hoisted_fwd_cuda" else (node, node)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(ha, kernel)(*(_t(c[k]) for k in ("y_s", "e_t", "w_e", "b")),
                            *_layout(c, _t), *nodes,
                            node_block=c["node_block"],
                            edge_tile=c["edge_tile"])


def test_forward_shared_memory_at_both_tilings():
    """The forward's shared memory, as its wrapper checks it: the CSR
    forward's (the accumulator of the whole node block and the W_e slice)
    plus the 64-column bias slice; it fits at the v1 tiles (128-node
    blocks) and at the CSR tiling's (256), not at 1024 nodes."""
    for de, nb in ((16, 128), (16, 256), (4, 32)):
        assert ha.fwd_smem_bytes(de, nb) == \
            ca.fwd_smem_bytes(de, nb) + 64 * 4
        assert ha.fwd_smem_bytes(de, nb) <= da._MAX_SMEM
    assert ha.fwd_smem_bytes(16, 128) == 128 * 65 * 4 + 16 * 68 * 4 + 256
    assert ha.fwd_smem_bytes(16, 1024) > da._MAX_SMEM


@pytest.mark.parametrize("h,de,edge_tile", [(40, 16, 32), (41, 3, 30)])
def test_walk_operands_keep_the_forward(h, de, edge_tile):
    """What the forward's wrapper hands the walk: y_s with a row stride
    that is a multiple of 4 (zero columns past H), d_e padded to a multiple
    of 4 with zero features and W_e rows, tiles padded to a multiple of 16
    slots with empty ones; the inputs themselves where nothing needs it.
    The plain forward on the padded layout gives the same output."""
    c = _case(18, de=de, h=h, edge_tile=edge_tile)
    ops = [_t(c[k]) for k in ("y_s", "e_t", "w_e")]
    layout = _layout(c, _t)
    y_s, e_t, w_e, send, recv, et = ha.walk_operands(*ops, *layout[:2],
                                                     edge_tile)
    assert y_s.shape == (c["n"], -(-h // 4) * 4) and e_t.shape[1] % 4 == 0
    assert et % 16 == 0 and et - edge_tile < 16
    t = layout[2].shape[0]
    assert e_t.shape[0] == send.shape[0] == recv.shape[0] == t * et
    assert torch.equal(y_s[:, :h], ops[0]) and not y_s[:, h:].any()
    assert torch.equal(w_e[:de], ops[2]) and not w_e[de:].any()
    tiles = e_t.view(t, et, -1)
    assert torch.equal(tiles[:, :edge_tile, :de],
                       ops[1].view(t, edge_tile, de))
    assert not tiles[:, edge_tile:].any() and not tiles[..., de:].any()
    assert torch.equal(recv.view(t, et)[:, :edge_tile],
                       layout[1].view(t, edge_tile))
    assert (recv.view(t, et)[:, edge_tile:] == -1).all()
    if (h % 4, de % 4, edge_tile % 16) == (0, 0, 0):
        assert all(u is v for u, v in zip((y_s, e_t, w_e, send, recv),
                                          (*ops, *layout[:2])))
    b, offset = _t(c["b"]), _t(c["offset"])
    kw = dict(node_block=c["node_block"], emit_inner=True)
    want = ha.hoisted_fwd_plain(*ops, b, *layout, offset,
                                edge_tile=edge_tile, **kw)
    got = ha.hoisted_fwd_plain(y_s[:, :h], e_t, w_e, b, send, recv,
                               layout[2], offset, edge_tile=et, **kw)
    for u, v in zip(got, want):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_factories_refuse_a_mismatched_offset():
    c = _case(15)
    fused = ha.make_fused_hoisted_aggregate(c["n"] + 1, c["node_block"],
                                            c["edge_tile"])
    with pytest.raises(ValueError, match="offset"):
        fused(*(_t(c[k]) for k in ("y_s", "e_t", "w_e", "b")),
              *_layout(c, _t), _t(c["offset"]))


def test_kernel_check_rehearses_on_cpu():
    """kernel_check on the CPU (its checks at pallas_check's shapes, the v1
    pair at the flagship's widest layer): every check passes and the last
    line is KERNEL CHECK OK."""
    lines = []
    res = kernel_check.run("cpu", out=lines.append)
    assert lines[-1] == "KERNEL CHECK OK"
    assert res["linear"] < 1e-3 and res["segmax"] < 1e-3
    assert 0.97 < res["strict_ratio"] < 1.03
    for errs in res["v1"].values():
        assert max(errs.values()) <= kernel_check.V1_RTOL


def test_v1_check_inputs_separate_the_maxima():
    """kernel_check's v1 inputs: distinct senders per receiver and an edge
    part below 0.4, so any two operands of a receiver differ by more than
    the routing tolerance at every column."""
    c = kernel_check.v1_case(np.random.default_rng(1), n=128, k=20, de=16,
                             h=8)
    recv, send = c["recv"], c["send"]
    order = np.lexsort((send, recv))
    same = (np.diff(recv[order]) == 0) & (np.diff(send[order]) == 0)
    assert not same.any()
    edge = np.abs(c["e_feat"] @ c["w_e"]).max()
    assert edge < 0.4
    op = c["y_s"][send] + c["e_feat"] @ c["w_e"]
    for r in range(8):
        rows = np.sort(op[recv == r], axis=0)
        gaps = np.diff(rows, axis=0)
        assert (gaps > 1e-5 * np.abs(rows[1:]) + 1e-5).all()
