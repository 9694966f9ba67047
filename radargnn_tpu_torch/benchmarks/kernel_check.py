"""The kernels' correctness on the card, against plain formulations.

Port of the JAX package's benchmarks/pallas_check.py: its four checks at
their shapes, seeds and limits, on the port's kernels, plus one for the v1
pair.

1. fused linear (csrc/fused_linear.cu) at 4096 x 256 -> 512 with ReLU,
   within 1e-3 of `fused_linear_reference`;
2. fused message segment-max (csrc/msg_segmax.cu) at 20,480 edges,
   1,024 nodes, 64 -> 128, mask 0.9, within 1e-3 of
   `fused_message_segment_max_reference`;
3. the dense aggregation (B1/B2/B3) forward and its w_s / w_e / offset
   gradients against the hoisted formulation at the kernels' operand
   precision (bf16 on the card), within 2e-2 and 5e-2 relative;
4. the windowed aggregation's (B4) strict max routing: the magnitude of the
   x-gradient over that of a float32 formulation, within 0.97-1.03 (a
   rounded landing drops max-gradients);
5. the v1 pair (csrc/hoisted_fwd_v1.cu, csrc/hoisted_bwd_v1.cu) through
   both factories at the flagship's widest layer (H 464, d_e 16, 2,816
   nodes of in-degree 20, mask 0.9, the factories' 128 x 256 tiles): the
   forward against `hoisted_segment_max`, and the gradients of y_s, e_t,
   W_e, b and offset against autograd through it, within V1_RTOL of each
   output's scale. The inputs keep every receiver's maxima further apart
   than the routing tolerance (integer y_s, distinct senders, an edge part
   below 0.4), so the one max-subgradient that autograd takes and the
   kernels' rule (the full g to every slot within the tolerance) coincide;
   on continuous inputs this wide, dozens of near-ties would tell the two
   rules apart.

A failed check raises, and the module exits non-zero; the last line is
`KERNEL CHECK OK`.

    python -m radargnn_tpu_torch.benchmarks.kernel_check [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict

import numpy as np
import torch

from radargnn_tpu_torch.device import DeviceLike, resolve_device
from radargnn_tpu_torch.models.mlp import matmul_f32
from radargnn_tpu_torch.ops import segment_sum as ss
from radargnn_tpu_torch.ops.dense_aggregate import dense_aggregate, \
    gather_dtype
from radargnn_tpu_torch.ops.dense_tiles import prepare_dense_knn_tiles
from radargnn_tpu_torch.ops.fused_linear import fused_linear, \
    fused_linear_reference
from radargnn_tpu_torch.ops.hoisted_aggregate import \
    make_fused_hoisted_aggregate, make_fused_hoisted_aggregate_pallas_bwd
from radargnn_tpu_torch.ops.message_segment_max import \
    fused_message_segment_max, fused_message_segment_max_reference
from radargnn_tpu_torch.ops.segment import hoisted_segment_max
from radargnn_tpu_torch.ops.windowed_aggregate import windowed_aggregate
from radargnn_tpu_torch.ops.windowed_tiles import prepare_csr_tiles, \
    prepare_windowed_csr_tiles

# the v1 pair against the formulation it ports: float32 on both sides,
# different summation orders (the kernels' fma chains, the reference's
# matmuls), so well inside the 1e-4 of the CPU parity tests
V1_RTOL = 1e-4


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(f"kernel_check: {msg}")


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (+1e-9), as pallas_check reads it."""
    diff = (got - want).detach()
    return float(diff.abs().max() / (want.detach().abs().max() + 1e-9))


def check_linear(rng, t, out) -> float:
    x = rng.normal(size=(4096, 256)).astype(np.float32)
    w = rng.normal(size=(256, 512)).astype(np.float32) * 0.05
    b = rng.normal(size=(512,)).astype(np.float32)
    got = fused_linear(t(x), t(w), t(b), relu=True)
    err = float((got - fused_linear_reference(t(x), t(w), t(b), relu=True)
                 ).abs().max())
    out(f"fused_linear max err: {err}")
    _require(err < 1e-3, f"fused_linear max err {err}")
    return err


def check_segmax(rng, t, out) -> float:
    e, n, din, h = 20480, 1024, 64, 128
    m_in = rng.normal(size=(e, din)).astype(np.float32)
    recv = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) < 0.9
    w = rng.normal(size=(din, h)).astype(np.float32) * 0.1
    b = rng.normal(size=(h,)).astype(np.float32)
    perm, tb, padded_recv = prepare_csr_tiles(recv, mask, n, node_block=128,
                                              edge_tile=128)
    got = fused_message_segment_max(
        t(m_in[perm]), t(w), t(b), t(padded_recv), t(tb), num_nodes=n,
        node_block=128, edge_tile=128)
    want = fused_message_segment_max_reference(t(m_in), t(w), t(b), t(recv),
                                               t(mask), n)
    err = float((got - want).abs().max())
    out(f"fused_message_segment_max max err: {err}")
    _require(err < 1e-3, f"fused_message_segment_max max err {err}")
    return err


def _grads(f, args, argnums):
    leaves = [a.clone().requires_grad_(i in argnums)
              for i, a in enumerate(args)]
    return torch.autograd.grad((f(*leaves) ** 2).sum(),
                               [leaves[i] for i in argnums])


def check_dense(rng, t, dev, out) -> Dict:
    n, k, r_tile, node_block, wb = 512, 8, 16, 128, 2
    e = 3000
    send = rng.integers(0, n, e).astype(np.int32)
    recv = rng.integers(0, n, e).astype(np.int32)
    mask = rng.random(e) < 0.9
    d_in, de, h = 64, 8, 128
    x = rng.normal(size=(n, d_in)).astype(np.float32)
    w_s = (rng.normal(size=(d_in, h)) * 0.1).astype(np.float32)
    e_feat = rng.normal(size=(e, de)).astype(np.float32)
    w_e = (rng.normal(size=(de, h)) * 0.1).astype(np.float32)
    off = rng.normal(size=(n, h)).astype(np.float32)
    te = r_tile * k
    perm, sloc, twin, ovf_idx = prepare_dense_knn_tiles(
        send, recv, mask, n, k, r_tile, node_block, wb,
        ovf_budget=-(-e // te) * te)
    ovf_valid = ovf_idx >= 0
    o = np.maximum(ovf_idx, 0)
    ovf_s = np.where(ovf_valid, send[o], 0).astype(np.int32)
    ovf_r = np.where(ovf_valid, recv[o], -1).astype(np.int32)
    e_ovf = np.where(ovf_valid[:, None], e_feat[o], 0.0).astype(np.float32)
    order, row_ptr = ss.sender_landing(sloc, twin, ovf_s, ovf_valid,
                                       slots_per_tile=te,
                                       node_block=node_block, num_nodes=n)
    landing = ss.SenderLanding(t(order), t(row_ptr))
    consts = (t(twin), t(sloc), t(ovf_s), t(ovf_r))
    cd = gather_dtype(dev)

    def f_dense(x_, w_s_, e_t_, w_e_, off_, e_ovf_):
        return dense_aggregate(x_, w_s_, e_t_, w_e_, off_, e_ovf_, *consts,
                               r_tile=r_tile, k=k, node_block=node_block,
                               landing=landing)

    def f_ref(x_, w_s_, e_feat_, w_e_, off_):
        ys = matmul_f32(x_, w_s_, cd)
        ye = matmul_f32(e_feat_, w_e_, cd)
        op = ys.to(cd).float()[t(send).long()] + ye
        return hoisted_segment_max(op, t(recv), n, t(mask), off_)

    args_d = tuple(map(t, (x, w_s, e_feat[perm], w_e, off, e_ovf)))
    args_r = tuple(map(t, (x, w_s, e_feat, w_e, off)))
    err = float((f_dense(*args_d) - f_ref(*args_r)).abs().max())
    out(f"fused_dense_aggregate fwd max err: {err}")
    _require(err < 2e-2, f"dense forward max err {err}")
    rels = {}
    for nm, a, b in zip(("w_s", "w_e", "offset"),
                        _grads(f_dense, args_d, (1, 3, 4)),
                        _grads(f_ref, args_r, (1, 3, 4))):
        rels[nm] = _rel(a, b)
        out(f"fused_dense_aggregate d{nm} max rel err: {rels[nm]}")
        _require(rels[nm] < 5e-2, f"dense d{nm} max rel err {rels[nm]}")
    return {"fwd": err, **rels}


def check_strict_routing(rng, t, out) -> float:
    n, e, d, de, h = 512, 4000, 32, 8, 64
    nb, te, wb = 128, 128, 2
    x = rng.normal(size=(n, d)).astype(np.float32)
    ws = (rng.normal(size=(d, h)) * 0.3).astype(np.float32)
    ef = rng.normal(size=(e, de)).astype(np.float32)
    we = (rng.normal(size=(de, h)) * 0.3).astype(np.float32)
    off = rng.normal(size=(n, h)).astype(np.float32)
    base = rng.integers(0, n, e)
    send = base.astype(np.int32)
    recv = np.clip(base + rng.integers(-40, 40, e), 0, n - 1).astype(np.int32)
    mask = np.ones(e, bool)
    perm, tb, prec, sloc, twin, ovfi = prepare_windowed_csr_tiles(
        send, recv, mask, n, nb, te, wb, ovf_budget=-(-e // te) * te)
    ov = ovfi >= 0
    o = np.maximum(ovfi, 0)
    ovs = np.where(ov, send[o], 0).astype(np.int32)
    ovr = np.where(ov, recv[o], -1).astype(np.int32)
    ove = np.where(ov[:, None], ef[o], 0.0).astype(np.float32)
    order, row_ptr = ss.sender_landing(sloc, twin, ovs, ov,
                                       slots_per_tile=te, node_block=nb,
                                       num_nodes=n)
    landing = ss.SenderLanding(t(order), t(row_ptr))

    def f_xla(x_):
        op = (x_ @ t(ws))[t(send).long()] + t(ef) @ t(we)
        m = torch.where(t(mask)[:, None], op, -3.0e38)
        idx = t(recv).long()[:, None].expand_as(m)
        inner = torch.full((n, h), float("-inf"), device=m.device
                           ).scatter_reduce(0, idx, m, "amax")
        return torch.where(inner > -1.5e38, t(off) + inner, 0.0)

    x_ref = t(x).requires_grad_(True)
    gx_ref = torch.autograd.grad(f_xla(x_ref).sum(), x_ref)[0]
    x_k = t(x).requires_grad_(True)
    y = windowed_aggregate(x_k, t(ws), t(ef[perm]), t(we), t(off), t(ove),
                           t(prec), t(tb), t(twin), t(sloc), t(ovs), t(ovr),
                           node_block=nb, edge_tile=te, landing=landing)
    gx = torch.autograd.grad(y.sum(), x_k)[0]
    ratio = float(gx.abs().sum() / gx_ref.abs().sum())
    out(f"v3 strict x-grad magnitude ratio vs float32: {ratio:.4f}")
    _require(0.97 < ratio < 1.03,
             f"strict routing is dropping max-gradients (ratio {ratio})")
    return ratio


def v1_case(rng, n: int = 2816, k: int = 20, de: int = 16, h: int = 464):
    """A graph of in-degree k with k distinct senders per receiver, mask
    0.9, in a random edge order, and the v1 inputs: y_s integers, a
    permutation of 0..n-1 in each column, so two distinct senders differ
    by at least 1, and an edge part |e @ W_e| <= de / 4 * 0.1 < 0.4, so
    every receiver's maxima lie at least 0.2 apart, beyond the routing
    tolerance (1e-5 |inner| + 1e-5 < 0.03)."""
    recv = np.repeat(np.arange(n), k)
    offs = rng.choice(np.arange(1, n), size=k, replace=False)
    send = (recv + np.tile(offs, n)) % n
    order = rng.permutation(n * k)
    send, recv = send[order].astype(np.int32), recv[order].astype(np.int32)
    mask = rng.random(n * k) < 0.9
    y_s = np.argsort(rng.random((n, h)), axis=0).astype(np.float32)
    e_feat = rng.uniform(-0.5, 0.5, size=(n * k, de)).astype(np.float32)
    w_e = rng.uniform(-0.05, 0.05, size=(de, h)).astype(np.float32)
    b = rng.normal(size=(h,)).astype(np.float32)
    offset = rng.normal(size=(n, h)).astype(np.float32)
    return dict(n=n, send=send, recv=recv, mask=mask, y_s=y_s,
                e_feat=e_feat, w_e=w_e, b=b, offset=offset)


def check_v1(rng, t, out, node_block: int = 128, edge_tile: int = 256
             ) -> Dict:
    c = v1_case(rng)
    n = c["n"]
    perm, tile_blocks, padded_recv = prepare_csr_tiles(
        c["recv"], c["mask"], n, node_block, edge_tile)
    layout = (t(c["send"][perm]), t(padded_recv), t(tile_blocks))
    send, recv, mask = t(c["send"]).long(), t(c["recv"]), t(c["mask"])
    perm_t = t(perm).long()

    def f_ref(y_s, e_feat, w_e, b, offset):
        op = y_s[send] + e_feat @ w_e + b
        return hoisted_segment_max(op, recv, n, mask, offset)

    args = [t(c[k]) for k in ("y_s", "e_feat", "w_e", "b", "offset")]
    leaves = [a.clone().requires_grad_(True) for a in args]
    want = f_ref(*leaves)
    g_want = torch.autograd.grad((want ** 2).sum(), leaves)
    res = {}
    factories = (("xla_bwd", make_fused_hoisted_aggregate),
                 ("kernel_bwd", make_fused_hoisted_aggregate_pallas_bwd))
    for name, make in factories:
        fused = make(n, node_block, edge_tile)
        leaves = [a.clone().requires_grad_(True) for a in args]
        leaves[1] = args[1][perm_t].requires_grad_(True)
        got = fused(leaves[0], leaves[1], leaves[2], leaves[3], *layout,
                    leaves[4])
        g_got = list(torch.autograd.grad((got ** 2).sum(), leaves))
        # e_t's gradient back through perm (dummy slots carry 0)
        g_got[1] = torch.zeros_like(args[1]).index_add_(0, perm_t,
                                                        g_got[1])
        errs = {"out": _rel(got, want)}
        errs.update({f"d_{nm}": _rel(u, v) for nm, u, v in zip(
            ("y_s", "e", "w_e", "b", "offset"), g_got, g_want)})
        out(f"hoisted v1 ({name}) errors relative to each output's scale: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
        _require(max(errs.values()) <= V1_RTOL,
                 f"the v1 pair ({name}) disagrees with hoisted_segment_max "
                 f"and autograd: {errs}")
        res[name] = errs
    return res


def run(device: DeviceLike = None, out: Callable = print) -> Dict:
    """Runs the five checks in pallas_check's order and seeds (one numpy
    generator of seed 0 through the first four); returns their errors."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    rng = np.random.default_rng(0)
    res = {"linear": check_linear(rng, t, out),
           "segmax": check_segmax(rng, t, out)}
    out("KERNEL CHECK: fused linear and segment-max OK")
    res["dense"] = check_dense(rng, t, dev, out)
    out("KERNEL CHECK: dense aggregation OK")
    res["strict_ratio"] = check_strict_routing(rng, t, out)
    out("KERNEL CHECK: strict routing OK")
    res["v1"] = check_v1(np.random.default_rng(1), t, out)
    out("KERNEL CHECK OK")
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    run(parser.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
