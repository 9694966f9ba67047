"""The port's padded-bucket loader (radargnn_tpu_torch.data.loader) against
the JAX package's on the same npz files: the shared bucket, the batch
count, the seeded shuffle, the padded last batch, `cache_batches`, the
loader-level roll bound, and every batch's arrays and geometry under no
tiling and the dense, windowed and CSR tilings. Padding and tiling are
numpy in both packages and read the same files, so the arrays must be
equal."""

import os

import numpy as np
import pytest
import torch

from radargnn_tpu.data import loader as jloader
from radargnn_tpu.data import synthetic as jsyn
from radargnn_tpu.graph import batch as jbatch
from radargnn_tpu_torch.data import loader as tloader
from radargnn_tpu_torch.graph import batch as tbatch
from radargnn_tpu_torch.models.layers import (
    FUSED_DENSE_EXTRA_SLOTS, FUSED_DENSE_R_TILE, FUSED_EDGE_TILE,
    FUSED_NODE_BLOCK, FUSED_WINDOW_BLOCKS,
)

K = 20          # the synthetic frames' kNN degree
TILINGS = {
    "none": None,
    "dense": {"mode": "dense", "node_block": FUSED_NODE_BLOCK,
              "r_tile": FUSED_DENSE_R_TILE, "k": K + FUSED_DENSE_EXTRA_SLOTS,
              "window_blocks": FUSED_WINDOW_BLOCKS, "ovf_ssum": False,
              "ovf_frac": 0.08},
    # no run cap: the loader bounds the roll passes over all its samples;
    # the spread tiler overflows ~40 % of a tiny frame's edges, hence 0.5
    "windowed": (FUSED_NODE_BLOCK, FUSED_EDGE_TILE, FUSED_WINDOW_BLOCKS, 0.5),
    "windowed_run_cap": (FUSED_NODE_BLOCK, FUSED_EDGE_TILE,
                         FUSED_WINDOW_BLOCKS, 0.5, 4),
    "csr": (FUSED_NODE_BLOCK, FUSED_EDGE_TILE),
}
TRAIN_POINTS = (150, 210, 120, 260, 180, 90, 230)     # 7 = 3 + 3 + 1
VALIDATE_POINTS = (170, 140)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Synthetic frames of different sizes written by the JAX package."""
    root = tmp_path_factory.mktemp("graphs")
    for split, points in (("train", TRAIN_POINTS),
                          ("validate", VALIDATE_POINTS)):
        os.makedirs(root / split)
        for i, n in enumerate(points):
            sample, = jsyn.make_samples(1, n, seed=100 * len(split) + i)
            sample.save_npz(str(root / split / f"graph_{i}.npz"))
    with open(root / "config.json", "w") as f:
        f.write('{"DATASET_CONFIG": {"seed": 1}}')
    return str(root)


def _assert_same_batch(tb, jb):
    assert tb.device.type == "cpu"
    for name, tensor in tb.tensors().items():
        want = np.asarray(getattr(jb, name))
        got = tensor.numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    absent = [f for f in ("tiled_perm", "ssum_perm", "win_senders_local")
              if getattr(jb, f) is not None and getattr(tb, f) is None]
    assert not absent
    assert tb.tile_geometry == jb.tile_geometry
    assert tb.host_valid_edges == jb.host_valid_edges


def _assert_same_epochs(t_loader, j_loader, epochs: int = 2):
    for _ in range(epochs):
        t_batches, j_batches = list(t_loader), list(j_loader)
        assert len(t_batches) == len(j_batches) == len(t_loader)
        for tb, jb in zip(t_batches, j_batches):
            _assert_same_batch(tb, jb)


@pytest.mark.parametrize("tiling", sorted(TILINGS))
def test_loaders_match_jax(root, tiling):
    """get_data_loaders: one bucket for both splits, the same roll bound,
    and two epochs of the same shuffled batches; the last train batch is
    padded with empty graphs."""
    spec = TILINGS[tiling]
    kw = dict(batch_size=3, shuffle=True, bg_index=5, seed=7,
              csr_tiling=spec)
    j_loaders, j_cfg = jloader.get_data_loaders(["train", "validate"], root,
                                                **kw)
    t_loaders, t_cfg = tloader.get_data_loaders(["train", "validate"], root,
                                                device="cpu", **kw)
    assert t_cfg == j_cfg == {"DATASET_CONFIG": {"seed": 1}}
    for split in ("train", "validate"):
        t, j = t_loaders[split], j_loaders[split]
        assert (t.max_nodes, t.max_edges, t.roll_passes, t.shuffle) == (
            j.max_nodes, j.max_edges, j.roll_passes, j.shuffle)
        _assert_same_epochs(t, j)
    assert len(t_loaders["train"]) == 3
    assert t_loaders["train"].max_nodes % FUSED_NODE_BLOCK == 0 \
        or spec is None
    if spec is not None and not isinstance(spec, dict) and len(spec) >= 3:
        assert t_loaders["train"].roll_passes is not None
    last = list(tloader.GraphDataLoader(
        t_loaders["train"].samples, 3, False, 5, csr_tiling=spec,
        max_nodes=t_loaders["train"].max_nodes,
        max_edges=t_loaders["train"].max_edges, device="cpu"))[-1]
    assert last.node_mask.sum(1).tolist() == [TRAIN_POINTS[-1], 0, 0]
    assert (last.labels[1:] == 5).all() and not last.edge_mask[1:].any()


@pytest.mark.parametrize("tiling", ["dense", "windowed"])
@pytest.mark.parametrize("drop_last", [False, True])
def test_cached_batches_match_jax(root, tiling, drop_last):
    """cache_batches: the batches are stacked once; a shuffle permutes
    their order the JAX package's way, and the cached tensors are reused."""
    samples = tloader.load_split_samples(root, "train")
    j_samples = jloader.load_split_samples(root, "train")
    kw = dict(batch_size=2, shuffle=True, bg_index=5, seed=3,
              csr_tiling=TILINGS[tiling], cache_batches=True,
              drop_last=drop_last)
    t = tloader.GraphDataLoader(samples, device="cpu", **kw)
    j = jloader.GraphDataLoader(j_samples, **kw)
    assert len(t) == len(j) == (3 if drop_last else 4)
    assert (t.max_nodes, t.max_edges, t.roll_passes) == (
        j.max_nodes, j.max_edges, j.roll_passes)
    _assert_same_epochs(t, j, epochs=3)
    first = {id(b) for b in t}
    assert first == {id(b) for b in t}         # the same cached batches


def test_pad_cache_pads_each_sample_once(root, monkeypatch):
    samples = tloader.load_split_samples(root, "train")
    loader = tloader.GraphDataLoader(samples, 3, True, 5, seed=1,
                                     csr_tiling=TILINGS["csr"], device="cpu")
    calls = []
    pad = tbatch.pad_sample
    monkeypatch.setattr(tbatch, "pad_sample",
                        lambda s, *a: calls.append(id(s)) or pad(s, *a))
    for _ in range(3):
        list(loader)
    # every sample once, and the shared empty graph once
    assert sorted(calls) == sorted({id(s) for s in samples}
                                   | {id(loader._empty)})


def test_halo_partition_waits_for_multi_gpu(root):
    """The halo partition (multi-GPU training) is ported: under the dense
    tiling both splits' loaders get one set of dataset budgets and every
    batch equals the JAX loader's, halo plans included; without a dense or
    windowed tiling it raises as the JAX package does."""
    halo = {"dp": 1, "mp": 2, "ovf_frac": 0.5}
    spec = TILINGS["dense"]
    t_loaders, _ = tloader.get_data_loaders(
        ["train", "validate"], root, 2, False, halo_partition=halo,
        csr_tiling=spec, device="cpu")
    j_loaders, _ = jloader.get_data_loaders(
        ["train", "validate"], root, 2, False, halo_partition=halo,
        csr_tiling=spec)
    for split in ("train", "validate"):
        assert t_loaders[split].halo_partition == \
            j_loaders[split].halo_partition
        _assert_same_epochs(t_loaders[split], j_loaders[split], epochs=1)
    assert next(iter(t_loaders["train"])).halo_send_idx.shape[1] == 2
    samples = tloader.load_split_samples(root, "train")
    with pytest.raises(ValueError, match="halo_partition requires"):
        tloader.GraphDataLoader(samples, 2, False, 5, halo_partition=halo,
                                device="cpu")


def test_loader_asks_for_the_card(root):
    """Without a device the loader's batches go to the card, and there is
    none here: it raises rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloader.get_data_loaders(["train"], root, 2, False)
    with pytest.raises(ValueError, match="empty sample list"):
        tloader.GraphDataLoader([], 2, False, 5, device="cpu")


def test_stack_samples_takes_the_loaders_roll_bound(root):
    """A windowed batch records the roll bound it is given, the JAX
    package's way; without one, its own samples' bound; under a run cap,
    the cap's."""
    samples = tloader.load_split_samples(root, "train")[:2]
    j_samples = jloader.load_split_samples(root, "train")[:2]
    for spec, given in ((TILINGS["windowed"], 9), (TILINGS["windowed"], None),
                        (TILINGS["windowed_run_cap"], 9)):
        kw = dict(max_edges=8192, csr_tiling=spec, roll_passes=given)
        tb = tbatch.stack_samples(samples, 512, 5, device="cpu", **kw)
        jb = jbatch.stack_samples(j_samples, 512, 5, **kw)
        assert tb.tile_geometry == jb.tile_geometry
    assert tbatch.stack_samples(samples, 512, 5, max_edges=8192,
                                csr_tiling=TILINGS["windowed"], roll_passes=9,
                                device="cpu").tile_geometry[2] == 9
