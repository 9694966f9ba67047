"""The smoke's invariance phase (`smoke.run` calls `invariance_phase` on
the card, after the Radar-PointGNN phase).

The paper publishes three RadarScenes DetNets: translation-invariant boxes
(the flagship configuration, which every other phase runs), E(n)-invariant
boxes and boxes without invariance. This phase runs the other two, each
the flagship configuration with the fields of `smoke.INVARIANCES` replaced
(`smoke.flagship_configs(invariance=)`, printed):

  "en": each object point regresses its box relative to the point and its
      nearest neighbour (distance, the box's angles to the connection, in
      radians); node features rcs, velocity_vector_length, time_index,
      degree (4 columns), edge features point_pair_features (4: the
      distance and three angles in degrees, up to 180);
  "none": each object point regresses its box in absolute coordinates;
      node features rcs, velocity_vector, spatial_coordinates, time_index,
      degree (7 columns), the YAML's relative_position edges (2).

The embeddings take those inputs to the flagship's 224 node and 16 edge
columns, so the five convs aggregate at the flagship's layer shapes, (224,
16, 464) three times, (128, 16, 272), (64, 16, 144), on the kNN graph under
the dense tiling: B1 (`dense_proj_v4` + `dense_fwd_v4`) and B2
(`dense_bwd_v4`). For each configuration, on `graphs` x `points` synthetic
frames of seed `seed` built by the port's `make_samples` under it:

  (a) B1 and B2 against their plain versions at the five layer shapes on
      the configuration's batch (`smoke.check_routed_kernels`), the
      real-valued forward's edge rows the batch's own (its edge features
      through the model's edge embedding, rounded to bf16), each kernel
      timed beside its bound;
  (b) the requests through `Predictor` (`smoke._serve_phase`): each
      forward kernel launched once a layer and request, nothing else, and
      the outputs within the model limits of the plain path;
  (c) the training steps through `Trainer` (`smoke._train_phase`, the
      witness on): launches exact, at every step the losses and gradients
      within the training limits of the plain path at the same
      parameters, a second run bitwise equal; every conv's offset bias
      (`pre_mlp.lin_0.bias`, in `x @ W_r + bias`) against the plain
      path's (`smoke_pointgnn.check_offset_grads`);
  (d) the evaluation stage on the card against the CPU under the
      configuration's POSTPROCESSING (`smoke.evaluation_phase`): the real
      predictions and oracle predictions from the frames' ground truth,
      whose mAP must be exactly 1.0 (the "en" decode's nearest-neighbour
      recompute and the "none" decode round-trip the targets);
  (e) for "en", the host's compiled point-pair helper
      (`native.point_pair_features_2d`, which built the frames' edge
      features): it must have built, and its columns on the phase's frames
      must lie within NATIVE_PPF_RTOL of each column's scale of the numpy
      formula's (`graph.features.point_pair_features`).

A check that fails here is repaired, not routed around: nothing is caught.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from radargnn_tpu_torch import native
from radargnn_tpu_torch import smoke as sm
from radargnn_tpu_torch.device import resolve_device
from radargnn_tpu_torch.graph.features import point_pair_features
from radargnn_tpu_torch.models.layers import fused_csr_tiling
from radargnn_tpu_torch.smoke_pointgnn import check_offset_grads, \
    expected_launches

# the configurations, in the phase's order, and their names in its lines
NAMES = {"en": "E(n)-invariant", "none": "non-invariant"}
# the dense path's kernels: the forward's, and the training's other one
FORWARD = ("dense_proj_v4", "dense_fwd_v4")
TRAIN_EXTRA = {"dense_bwd_v4": 1}
# the compiled point-pair helper against the numpy formula on the same
# float64 inputs, by column, relative to the column's largest magnitude:
# the same arithmetic in another order, save arccos near a dot product of
# +-1, where a rounding of the dot moves the angle by about 1e-6 degrees
NATIVE_PPF_RTOL = 1e-5


def check_native_ppf(batch, out: Callable, label: str) -> Dict:
    """(e): `native.point_pair_features_2d` on each frame of `batch` (its
    positions, velocities and valid edges) against the numpy formula;
    raises when the helper did not build or a column leaves
    NATIVE_PPF_RTOL of its scale."""
    lib = native.load()
    out(f"{label}: the compiled point-pair helper (native/geometry.cpp) "
        f"{'built' if lib is not None else 'did not build'}")
    if lib is None:
        raise AssertionError("native.point_pair_features_2d did not build: "
                             "the frames' point-pair features came from the "
                             "numpy formula")
    errs, scales, edges = np.zeros(4), np.zeros(4), 0
    native_s = numpy_s = 0.0
    for g in range(batch.node_mask.shape[0]):
        pos = batch.pos[g].double().cpu().numpy()
        vel = batch.vel[g].double().cpu().numpy()
        mask = batch.edge_mask[g].cpu().numpy()
        s = batch.senders[g].cpu().numpy()[mask].astype(np.int64)
        r = batch.receivers[g].cpu().numpy()[mask].astype(np.int64)
        t0 = time.perf_counter()
        got = native.point_pair_features_2d(pos, vel, np.stack([s, r], -1),
                                            True)
        t1 = time.perf_counter()
        want = point_pair_features(pos[s], pos[r], vel[s], vel[r],
                                   "directed")
        numpy_s += time.perf_counter() - t1
        native_s += t1 - t0
        errs = np.maximum(errs, np.abs(got - want).max(axis=0))
        scales = np.maximum(scales, np.abs(want).max(axis=0))
        edges += len(s)
    rel = (errs / np.maximum(scales, 1e-30)).tolist()
    res = {"built": True, "edges": edges, "max_abs_err": errs.tolist(),
           "scale": scales.tolist(), "rel_err": rel,
           "native_ms": native_s * 1e3, "numpy_ms": numpy_s * 1e3}
    out(f"{label}: point-pair features of {edges} edges, compiled helper "
        f"vs numpy by column (distance, angle(v1, v2), angle(v1, d), "
        f"angle(v2, d)): max abs err {[f'{e:.2e}' for e in errs]} of "
        f"scales {[round(v, 3) for v in scales.tolist()]} (limit "
        f"{NATIVE_PPF_RTOL} of the scale); host ms {res['native_ms']:.2f} "
        f"compiled, {res['numpy_ms']:.2f} numpy")
    if not max(rel) <= NATIVE_PPF_RTOL:
        raise AssertionError(f"{label}: the compiled point-pair helper "
                             f"leaves the numpy formula: {res}")
    return res


def batch_edge_rows(model, tiling):
    """The edge rows B1 reads on `tiling`: its slots' and overflow edges'
    features through the model's edge embedding (as `DetNet.forward`
    gives them to every layer), the kernels' operands before the bf16
    rounding `check_routed_kernels` applies."""
    ovf = tiling.win
    with torch.no_grad():
        e_t = model.edge_emb_mlp(tiling.edge_feat, tiling.receivers >= 0)
        e_ovf = model.edge_emb_mlp(ovf[5], ovf[4] >= 0)
    return e_t, e_ovf


def kernel_times(checked: Dict[str, List[Dict]]) -> Dict[str, Dict]:
    """Each kernel's time and bound summed over the five layer shapes (a
    step's launches), as the kernels line gives the flagship's: B1's
    gather-max in serving mode, its VJP mode beside it."""
    def total(rows, key):
        vals = [r.get(key) for r in rows]
        return None if any(v is None for v in vals) else sum(vals)

    times = {}
    for name, rows in checked.items():
        times[name] = {k: total(rows, k)
                       for k in ("ms", "plain_ms", "bound_ms")}
        if name == "dense_fwd_v4":
            times[name].update(
                vjp_ms=total([r["vjp"] for r in rows], "ms"),
                vjp_bound_ms=total([r["vjp"] for r in rows], "bound_ms"))
        if name == "dense_proj_v4":
            times[name]["library_ms"] = total(rows, "library_ms")
    return times


def invariance_phase(dev, points: int, graphs: int, batches: int, seed: int,
                     reps: int, train_steps: int,
                     out: Callable = print) -> Dict:
    """The phase (module docstring). Returns each configuration's results
    by name, `checked` (each kernel's rows over both, for the kernels
    line's errors), `train_launches` (the training runs' launches over
    both, in the order of KERNEL_NAMES), `kernels` (each configuration's
    kernel times and bounds over the five shapes) and the wall seconds."""
    t0 = time.perf_counter()
    dev = resolve_device(dev)
    on_card = dev.type == "cuda"
    res: Dict = {"configs": {}, "checked": {}, "kernels": {}}
    launches = np.zeros(len(sm.KERNEL_NAMES), dtype=np.int64)
    for inv, name in NAMES.items():
        arch, graph_cfg, _, replaced = sm.flagship_configs(invariance=inv)
        t1 = time.perf_counter()
        _, model, loader = sm.flagship_serving(dev, points, graphs, batches,
                                               seed, invariance=inv)
        shapes = sm._layer_shapes(model)
        layers = len(shapes)
        tiling = loader[0].flat_tiling()
        raw = tiling.edge_feat[tiling.receivers >= 0]
        out(f"{name} model: the flagship configuration with "
            f"{json.dumps(replaced)} replaced; node features "
            f"{graph_cfg.node_features}, edge features "
            f"{graph_cfg.edge_features} (in the first request from "
            f"{raw.min(0).values.tolist()} to {raw.max(0).values.tolist()}); "
            f"fused tiling {fused_csr_tiling(arch, k=graph_cfg.k)}; layer "
            f"shapes (d_in, d_e, H) {shapes}; {batches} requests of "
            f"{graphs} x {points} points; host set-up "
            f"{time.perf_counter() - t1:.2f} s")
        cfg: Dict = {"replaced": replaced, "shapes": shapes}
        if "point_pair_features" in graph_cfg.edge_features:
            cfg["native_ppf"] = check_native_ppf(loader[0], out, name)
        with torch.no_grad():
            proj, fwd, bwd = sm.check_routed_kernels(
                tiling, shapes, seed, reps, out,
                edges=batch_edge_rows(model, tiling))
        cfg["checked"] = {"dense_proj_v4": proj, "dense_fwd_v4": fwd,
                          "dense_bwd_v4": bwd}
        for kernel, rows in cfg["checked"].items():
            res["checked"].setdefault(kernel, []).extend(rows)
        serve, train = expected_launches(FORWARD, TRAIN_EXTRA, layers,
                                         batches, train_steps, on_card)
        cfg.update(sm._serve_phase(dev, arch, model, loader, graphs, points,
                                   serve, name, out))
        cfg.update(sm._train_phase(dev, arch, loader[0], seed, train_steps,
                                   train, name, out, witness=True))
        cfg["bias_grads"] = check_offset_grads(dev, arch, loader[0], seed,
                                               name, out)
        cfg["evaluation"] = sm.evaluation_phase(dev, model, loader, out,
                                                invariance=inv)
        launches += np.asarray(cfg["train_launches"])
        res["kernels"][inv] = kernel_times(cfg["checked"])
        res["configs"][inv] = cfg
    res["train_launches"] = launches.tolist()
    res["wall_s"] = time.perf_counter() - t0
    out("invariance kernels (a step's five layer shapes): " + json.dumps(
        {"card": sm.card_description() if on_card else None,
         **res["kernels"]}))
    out(f"invariance phase: {res['wall_s']:.1f} s wall, training launches "
        f"{res['train_launches']} ({', '.join(sm.KERNEL_NAMES)})")
    return res
