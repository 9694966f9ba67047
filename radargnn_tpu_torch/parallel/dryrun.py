"""One sharded training step of each halo path, on `world` local ranks.

Port of the JAX package's multi-device dry run (`__graft_entry__.py`:
`dryrun_multichip`, `_dryrun_dense_halo`). The ranks form a data × model
mesh (model 2 where `world` is even, data the rest), and each path takes
one training step of the flagship DetNet structure at narrow widths (conv
[32, 32]) through the port's loader, halo batch, Trainer and kernels:

  * dense × halo: 96-point frames, k 8, the dense tiling's 16-node blocks
    and 16-receiver tiles (the JAX dry run's 8 is below what the card's
    dense kernels take), 12 slots;
  * windowed × halo at the flagship geometry: 2816-point frames, k 20, the
    windowed tiling (256, 512, 3, 0.5).

    python -m radargnn_tpu_torch.parallel.dryrun --world N [--device cpu]
        [--backend nccl|gloo]

On the card the ranks take one card each (NCCL) where there are enough, and
share card 0 over gloo otherwise; `--device cpu` runs gloo ranks on the
CPU. Each path prints its mesh, halo geometry and the batch's loss, which
must be finite; any rank's failure fails the run.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
from typing import List, Optional

import torch

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FLAGSHIP_CONFIG = os.path.join(_REPO, "configurations",
                               "configuration_radarscenes.yml")
# the JAX dry run's small dense geometry (`__graft_entry__.py`)
DENSE = {"mode": "dense", "node_block": 16, "r_tile": 8, "k": 12,
         "window_blocks": 2, "ovf_frac": 0.6}
WINDOWED = (256, 512, 3, 0.5)


def _arch(node_dim: int, edge_dim: int):
    """The flagship MODEL_ARCHITECTURE at the dry run's widths: conv
    [32, 32], node embedding [16, 32], edge embedding [4, 8], float32."""
    from radargnn_tpu_torch.configs import UserConfigurationReader

    cfg = UserConfigurationReader.read_config_file(FLAGSHIP_CONFIG)
    arch = UserConfigurationReader.get_config_object("MODEL_ARCHITECTURE",
                                                     cfg)
    return dataclasses.replace(
        arch, node_feature_dimension=node_dim,
        edge_feature_dimension=edge_dim, conv_layer_dimensions=[32, 32],
        node_feature_embedding_layer_dimensions=[16, 32],
        edge_feature_embedding_layer_dimensions=[4, 8],
        compute_dtype="float32")


def mesh_axes(world: int) -> dict:
    model = 2 if world % 2 == 0 and world > 1 else 1
    return {"data": world // model, "model": model}


def one_step(rank: int, world: int, device: torch.device, path: str
             ) -> dict:
    """One training step of `path` ("dense" or "windowed") on this rank;
    returns the mesh, the halo geometry and the batch's losses."""
    from radargnn_tpu_torch.configs import TrainingConfig
    from radargnn_tpu_torch.data.loader import GraphDataLoader
    from radargnn_tpu_torch.data.synthetic import (
        DEFAULT_GRAPH_CONFIG, make_samples,
    )
    from radargnn_tpu_torch.models.detnet import DetNet
    from radargnn_tpu_torch.parallel.mesh import make_mesh
    from radargnn_tpu_torch.train.trainer import Trainer

    axes = mesh_axes(world)
    mesh = make_mesh(axes, device=device)
    dp = axes["data"]
    points, k, g, tiling = (96, 8, 2 * dp, DENSE) if path == "dense" \
        else (2816, 20, dp, WINDOWED)
    gcfg = dataclasses.replace(DEFAULT_GRAPH_CONFIG,
                               graph_construction_settings={"k": k, "r": 1.0})
    gcfg.__post_init__()
    samples = make_samples(num_frames=g, num_points=points, seed=0,
                           graph_config=gcfg)
    halo = {"dp": dp, "mp": axes["model"], "ovf_frac": 0.8}
    loader = GraphDataLoader(samples, g, False, 5, csr_tiling=tiling,
                             halo_partition=halo, pad_align=16,
                             device="cpu")
    batch = next(iter(loader))
    model = DetNet(_arch(batch.node_feat.shape[-1],
                         batch.edge_feat.shape[-1]), device=device)
    trainer = Trainer(TrainingConfig(
        dataset="radarscenes", learning_rate=1e-3, epochs=1, batch_size=g,
        shuffle=False, bg_index=5, adapt_orientation_angle=True), model,
        mesh=mesh)
    losses = [float(v) for v in trainer.train_step(batch)]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"non-finite loss in the {path} x halo dry run: "
                           f"{losses}")
    return dict(path=path, mesh=mesh.shape, geometry=batch.halo_geometry,
                losses=losses)


def both_paths(rank: int, world: int, device: torch.device) -> List[dict]:
    return [one_step(rank, world, device, path)
            for path in ("dense", "windowed")]


def run(world: int, device: Optional[str] = None,
        backend: Optional[str] = None, timeout_s: float = 600) -> List[dict]:
    """Both paths' steps on `world` ranks; returns rank 0's results."""
    from radargnn_tpu_torch.parallel.comm import run_ranks

    on_card = device != "cpu"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    cards = torch.cuda.device_count() if on_card else 0
    if backend is None:
        backend = "nccl" if on_card and cards >= world else "gloo"
    devices = [f"cuda:{r % cards}" for r in range(world)] if on_card \
        else ["cpu"]
    return run_ranks(both_paths, world, backend, devices=devices,
                     timeout_s=timeout_s)[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", type=str, default=None,
                    help="cpu for gloo ranks on the CPU (default: the card)")
    ap.add_argument("--backend", type=str, default=None,
                    choices=("nccl", "gloo"))
    args = ap.parse_args(argv)
    for res in run(args.world, args.device, args.backend):
        print(f"dryrun({args.world}) {res['path']} x halo: "
              f"mesh={res['mesh']} halo={res['geometry']} "
              f"loss={res['losses'][0]:.4f} ok")


if __name__ == "__main__":
    main()
