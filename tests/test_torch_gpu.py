"""The port's CUDA kernel on the card (marker `gpu`). Each test decides inside
itself whether a card is present and skips without one; the kernel has no
CPU mode. This file imports nothing of JAX, so on a machine with a card and
without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

The kernel and its plain version take the same bf16 inputs and both sum
exact bf16 products in float32; they differ only in summation order, so the
tolerance is 1e-3 relative to the output's scale."""

from unittest import mock

import numpy as np
import pytest
import torch

from radargnn_tpu_torch import smoke
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.ops import dense_tiles as tdt

RTOL = 1e-3


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")


def _case(seed, n, K, r_tile, nb, d, de, h, dtype=torch.bfloat16):
    """A random variable-in-degree graph (spill and window overflow), its
    dense tiling from the port's host tiler, and the aggregation's inputs on
    the card in `dtype`."""
    rng = np.random.default_rng(seed)
    e = n * (K - 2)
    send = rng.integers(0, n, e).astype(np.int32)
    recv = rng.integers(0, n, e).astype(np.int32)
    perm, sloc, t_win, ovf_idx = tdt.prepare_dense_knn_tiles(
        send, recv, np.ones(e, bool), n, K, r_tile, nb, 3, ovf_budget=e)
    ovf = ovf_idx >= 0
    o = np.maximum(ovf_idx, 0)
    e_feat = rng.normal(size=(e, de))

    def t(arr, cast=None):
        out = torch.from_numpy(np.ascontiguousarray(arr)).cuda()
        return out if cast is None else out.to(cast)

    return dict(
        x=t(rng.normal(size=(n, d)), dtype),
        w_s=t(rng.normal(size=(d, h)) * d ** -0.5, dtype),
        e_t=t(e_feat[perm], dtype),
        w_e=t(rng.normal(size=(de, h)) * de ** -0.5, dtype),
        offset=t(rng.normal(size=(n, h)), torch.float32),
        e_ovf=t(np.where(ovf[:, None], e_feat[o], 0.0), dtype),
        tile_win=t(t_win), sloc=t(sloc),
        ovf_s=t(np.where(ovf, send[o], 0).astype(np.int32)),
        ovf_r=t(np.where(ovf, recv[o], -1).astype(np.int32)),
        kw=dict(r_tile=r_tile, k=K, node_block=nb))


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (128, 7, 16, 32, 24, 8, 40),          # small tile, H not a multiple of 64
    (1024, 24, 64, 256, 224, 16, 464),    # the flagship layers' widths
    (1024, 24, 64, 256, 128, 16, 272),
    (1024, 24, 64, 256, 64, 16, 144),
])
def test_dense_fwd_kernel_matches_plain(shape):
    _need_card()
    c = _case(0, *shape)
    inner_o = da.dense_overflow_inner(c["x"], c["w_s"], c["e_ovf"], c["w_e"],
                                      c["ovf_s"], c["ovf_r"], shape[0])
    args = (c["x"], c["w_s"], c["e_t"], c["w_e"], c["sloc"], c["tile_win"],
            inner_o, c["offset"])
    before = da.dense_fwd_cuda.launches
    got = da.dense_fwd(*args, **c["kw"])
    torch.cuda.synchronize()
    assert da.dense_fwd_cuda.launches == before + 1
    want = da.dense_fwd_plain(*args, **c["kw"])
    assert torch.isfinite(got).all()
    assert _rel_err(got, want) <= RTOL
    assert torch.equal(got == 0, want == 0)       # the same empty receivers


@pytest.mark.gpu
def test_dense_aggregate_pads_odd_widths():
    """Widths that are not multiples of 8 (d_in 21, d_e 2: raw edge features
    without an embedding) reach the kernel zero-padded, from float32
    inputs, and give the plain path's result."""
    _need_card()
    c = _case(1, 128, 7, 16, 32, 21, 2, 40, dtype=torch.float32)
    args = (c["x"], c["w_s"], c["e_t"], c["w_e"], c["offset"], c["e_ovf"],
            c["tile_win"], c["sloc"], c["ovf_s"], c["ovf_r"])
    got = da.dense_aggregate(*args, **c["kw"])
    with mock.patch.object(da, "dense_fwd", da.dense_fwd_plain):
        want = da.dense_aggregate(*args, **c["kw"])
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= RTOL


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take():
    _need_card()
    c = _case(2, 128, 7, 16, 32, 24, 8, 40)
    inner_o = torch.full_like(c["offset"], da._NEG)
    args = [c["x"], c["w_s"], c["e_t"], c["w_e"], c["sloc"], c["tile_win"],
            inner_o, c["offset"]]
    with pytest.raises(ValueError, match="bf16"):
        da.dense_fwd(c["x"].float(), *args[1:], **c["kw"])
    with pytest.raises(ValueError, match="contiguous"):
        da.dense_fwd(c["x"].t().contiguous().t(), *args[1:], **c["kw"])
    c = _case(3, 128, 7, 8, 32, 24, 8, 40)          # 8 receivers per tile
    with pytest.raises(ValueError, match="r_tile"):
        da.dense_fwd(c["x"], c["w_s"], c["e_t"], c["w_e"], c["sloc"],
                     c["tile_win"], torch.full_like(c["offset"], da._NEG),
                     c["offset"], **c["kw"])


@pytest.mark.gpu
def test_smoke_on_card():
    """The smoke at a small size: the kernel builds, matches its plain
    version at the model's layer shapes, and every conv layer of each of
    the three requests launches it."""
    _need_card()
    summary = smoke.run("cuda", points=512, graphs=2, batches=3, reps=2,
                        out=lambda *_: None)
    (kernel,) = summary["kernels"]
    assert kernel["launches"] == 5 * 3
    assert kernel["ms"] > 0 and kernel["plain_ms"] > 0
