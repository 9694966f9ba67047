"""End-to-end convergence check on synthetic RadarScenes-like data.

Port of `benchmarks/convergence.py`: trains the DetNet (a reduced conv
stack, or the flagship's with --full-arch) on synthetic frames with known
objects, then runs the whole evaluation chain (predict, decode, NMS,
point-IoU mAP and F1). It shows that the graph pipeline, the masked
losses, the schedules, the postprocessing and the metrics learn and
evaluate together, on the card by default.

    python -m radargnn_tpu_torch.benchmarks.convergence [--fused [--dense |
        --windows]] [--epochs N] [--frames N] [--points N] [--device cpu]

The arguments are the JAX tool's, plus --device (the card unless given).
RADARGNN_FUSED_BF16_MAX=1 makes the fused dense and windowed backwards
route by bf16 equality, as in the JAX package. Prints JSON lines: one per
epoch with the train and validation losses, then {"metric":
"synthetic_map"} and {"metric": "synthetic_f1_macro"}.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

from radargnn_tpu_torch.configs import (
    GNNArchitectureConfig, PostProcessingConfiguration, TrainingConfig,
)
from radargnn_tpu_torch.data.loader import GraphDataLoader
from radargnn_tpu_torch.data.synthetic import make_samples
from radargnn_tpu_torch.device import resolve_device
from radargnn_tpu_torch.models import layers
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.postprocess import (
    ObjectDetectionMetrics, Postprocessor, PredictionExtractor, Predictor,
    SegmentationMetrics,
)
from radargnn_tpu_torch.train.trainer import Trainer, set_seeds


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--frames", type=int, default=60)
    parser.add_argument("--points", type=int, default=800)
    parser.add_argument("--bb-invariance", type=str, default="translation",
                        choices=["none", "translation", "en"],
                        help="bounding-box invariance mode, end to end: GT "
                             "encoding -> training -> decode")
    parser.add_argument("--imbalanced", action="store_true",
                        help="RadarScenes-like class profile (~96%% "
                             "background, car-dominated objects) instead "
                             "of the mild near-balanced default")
    parser.add_argument("--protocol", type=str, default="reference",
                        choices=["reference", "soft"],
                        help="eval protocol: 'reference' = point-IoU "
                             "mAP@0.3, per-class min score 0.5, bg cap 0.2, "
                             "NMS IoU 0.01 (configuration_radarscenes.yml); "
                             "'soft' = lenient thresholds")
    parser.add_argument("--epochs", type=int, default=15)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--dtype", type=str, default="bfloat16")
    parser.add_argument("--full-arch", action="store_true",
                        help="flagship conv stack [224,224,128,64,32]")
    parser.add_argument("--fused", action="store_true",
                        help="use the fused aggregation (the card's "
                             "kernels); the CSR tiling unless --windows or "
                             "--dense")
    parser.add_argument("--windows", action="store_true",
                        help="with --fused: the windowed tiling")
    parser.add_argument("--dense", action="store_true",
                        help="with --fused: the dense fixed-degree kNN "
                             "tiling (k+4 slots a receiver, over-degree "
                             "spill to overflow)")
    parser.add_argument("--ovf-frac", type=float, default=0.05,
                        help="overflow-edge budget fraction for --windows "
                             "(--dense takes at least 0.08)")
    parser.add_argument("--no-eval", action="store_true",
                        help="skip the mAP/F1 evaluation stage")
    parser.add_argument("--checkpoint-dir", type=str, default=None,
                        help="save the training state here every epoch")
    parser.add_argument("--no-cache-batches", action="store_true",
                        help="build the batches anew every epoch; cached "
                             "batches fix batch membership across epochs "
                             "(only their order reshuffles)")
    parser.add_argument("--resume", type=str, default=None,
                        help="resume from a checkpoint directory")
    parser.add_argument("--seed", type=int, default=123,
                        help="training seed (init + shuffling); the data "
                             "seed stays fixed")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")
    return parser.parse_args(argv)


def _tiling(args: argparse.Namespace):
    """The loader's tiling of the JAX tool: dense, windowed or CSR."""
    if not args.fused:
        return None
    if args.dense:
        return {"mode": "dense", "node_block": layers.FUSED_NODE_BLOCK,
                "r_tile": layers.FUSED_DENSE_R_TILE,
                "k": 20 + layers.FUSED_DENSE_EXTRA_SLOTS,
                "window_blocks": layers.FUSED_WINDOW_BLOCKS,
                "ovf_frac": max(args.ovf_frac, 0.08)}
    tiling = (layers.FUSED_NODE_BLOCK, layers.FUSED_EDGE_TILE)
    if args.windows:
        tiling += (layers.FUSED_WINDOW_BLOCKS, args.ovf_frac)
    return tiling


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    samples = make_samples(num_frames=args.frames, num_points=args.points,
                           seed=0, bb_invariance=args.bb_invariance,
                           imbalanced=args.imbalanced)
    n_val = max(args.frames // 5, 2)
    train_s, val_s = samples[:-n_val], samples[-n_val:]

    if args.full_arch:
        conv_dims = [224, 224, 128, 64, 32]
        node_emb = [32, 64, 128, 224]
        edge_emb = [4, 8, 16]
    else:
        conv_dims = [64, 64, 32]
        node_emb = [32, 64]
        edge_emb = [4, 8]
    arch = GNNArchitectureConfig(
        node_feature_dimension=train_s[0].node_feat.shape[1],
        edge_feature_dimension=2,
        conv_layer_dimensions=conv_dims,
        classification_head_layer_dimensions=[6],
        regression_head_layer_dimensions=[16, 5],
        initial_node_feature_embedding=True,
        initial_edge_feature_embedding=True,
        node_feature_embedding_layer_dimensions=node_emb,
        edge_feature_embedding_layer_dimensions=edge_emb,
        batch_norm_in_mlps=False, compute_dtype=args.dtype,
        assume_sorted_edges=True, use_fused_aggregation=args.fused)
    # adapt_orientation_angle: sin-encode the angle to [-1, 1], as the
    # reference does for the rotated-box modes
    tcfg = TrainingConfig(
        dataset="radarscenes", learning_rate=2e-3, epochs=args.epochs,
        batch_size=args.batch_size, shuffle=True, bg_index=5,
        deterministic=True, seed=args.seed,
        exponential_lr_decay_factor=0.95,
        bb_loss_weight=0.5, regularization_strength=5e-6,
        adapt_orientation_angle=True,
        set_weights_according_radar_scenes_distribution=args.imbalanced)

    set_seeds(tcfg.seed, tcfg.deterministic)
    csr_tiling = _tiling(args)
    loaders = {
        split: GraphDataLoader(s, args.batch_size, split == "train", 5,
                               seed=1, cache_batches=not args.no_cache_batches,
                               csr_tiling=csr_tiling, device=dev)
        for split, s in (("train", train_s), ("validate", val_s))}
    # one bucket for both splits
    n_bucket = max(ld.max_nodes for ld in loaders.values())
    e_bucket = max(ld.max_edges for ld in loaders.values())
    for ld in loaders.values():
        ld.max_nodes, ld.max_edges = n_bucket, e_bucket

    model = DetNet(arch, device=dev, seed=tcfg.seed)
    trainer = Trainer(tcfg, model)
    if args.checkpoint_dir:
        tcfg.checkpoint_every_epochs = 1
    trainer.fit(loaders, verbose=False, resume_from=args.resume,
                checkpoint_dir=args.checkpoint_dir)
    for ep, (lt, lv) in enumerate(zip(trainer.train_loss,
                                      trainer.valid_loss)):
        print(json.dumps({"epoch": ep + 1, "loss_train": round(float(lt), 4),
                          "loss_valid": round(float(lv), 4)}), flush=True)

    if args.no_eval:
        return

    if args.protocol == "reference":
        # the protocol behind the reference's headline numbers
        # (configuration_radarscenes.yml): point-IoU mAP@0.3, NMS IoU 0.01,
        # per-class min object score 0.5, background-score cap 0.2
        min_score, bg_cap = 0.5, 0.2
    else:
        min_score, bg_cap = 0.4, 0.3
    config = PostProcessingConfiguration(
        split="validate", iou_for_nms=0.01,
        min_object_score={"car": min_score, "pedestrian": min_score,
                          "pedestrian_group": min_score,
                          "two_wheeler": min_score,
                          "large_vehicle": min_score},
        max_score_for_background=bg_cap, iou_for_mAP=0.3, use_point_iou=True,
        bg_index=5, bb_invariance=args.bb_invariance,
        adapt_orientation_angle=True)

    predictions, ground_truth, pos, vel = Predictor(
        model, loaders["validate"], verbose=False).predict()
    bb_pred, bb_gt, cls_pred, cls_gt = Postprocessor(device=dev).process(
        config, pos, vel, predictions, ground_truth)
    cls_pred_label = PredictionExtractor().extract(predictions)
    res = ObjectDetectionMetrics.get_map(config, bb_pred, bb_gt, cls_pred)
    f1 = SegmentationMetrics(cls_pred_label, cls_gt).get_f1(6, "macro")
    print(json.dumps({"metric": "synthetic_map",
                      "value": round(float(res["map"]), 4)}))
    print(json.dumps({"metric": "synthetic_f1_macro",
                      "value": round(float(f1), 4)}))


if __name__ == "__main__":
    main()
