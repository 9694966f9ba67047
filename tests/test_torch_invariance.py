"""The paper's E(n)-invariant ("en") and non-invariant ("none") RadarScenes
models in the port against the JAX package, on the CPU at a small size.

Each configuration is the flagship's with the fields of
`smoke.INVARIANCES` replaced: "en" takes the rotation-invariant node
features (rcs, velocity_vector_length, time_index, degree) and the
point-pair edge features (distance and three angles in degrees), and
regresses each object point's box relative to the point and its nearest
neighbour; "none" takes the absolute positions as node features
(spatial_coordinates) and regresses absolute boxes. Here both run at
tests/test_torch_detnet.py's size, 2 frames x 200 points in a 256-node
bucket, k 20, two MPNNConv layers of width 32 and 16, on the dense tiling
at the small geometry of tests/test_pallas.py (64-node blocks, 16
receivers a tile). (At 128 points in a 128-node bucket, k 8, the JAX
package's dense backward gives non-finite gradients: ROADMAP C7.)

Tolerances. The host arrays (graphs, features, ground-truth boxes) are the
same float64 numpy arithmetic in both packages, from one pair of host
backends (`host_pair`): equal, save the rotated boxes' float64 box algebra
(1e-12). The forward on carried weights: the JAX package's dense Pallas
kernel in interpret mode against the port's plain versions, float32,
summation order only: probabilities and boxes to atol/rtol 1e-4 (bf16
compute: 2e-2, a flipped bf16 rounding of a next-layer input). One
training step's losses to rtol 1e-4 / atol 1e-5 and its gradients to
rtol/atol 1e-4 (tests/test_torch_pointgnn.py's). The evaluation stage on
the same predictions: decoded boxes to 1e-9 of their scale (the adapted
angle with the JAX package in 64-bit mode), mAP to 1e-12, F1 and the
confusion matrix equal (tests/test_torch_postprocess.py's). The "en" round
trip under 360 rotations of 1 degree: the encoding equal to the unrotated
one to 1e-5 (the reference's test_preprocessor.py rounds to 5 decimals),
the decoded corners within 1e-6 m of the translation boxes' corners.

Both packages sin-encode the "en" targets' fifth column under
adapt_orientation_angle (the trainers adapt every 5-column box) while the
"en" decode reads that column in radians without inverting it:
`test_en_angle_encoding_is_the_jax_packages` shows both packages agree on
it (ROADMAP C11)."""

import copy
import functools

import jax
import numpy as np
import pytest
import torch

from radargnn_tpu import configs as jcfg
import radargnn_tpu.postprocess as jpp
from radargnn_tpu.data.ground_truth import create_2d_bounding_boxes as j_boxes
from radargnn_tpu.data.synthetic import make_samples as j_make_samples
from radargnn_tpu.graph import features as jfeat
from radargnn_tpu.graph.batch import stack_samples as j_stack
from radargnn_tpu.graph.build import build_geometric_graph as j_build
from radargnn_tpu.models.detnet import create_detnet_state
from radargnn_tpu.ops.knn import nearest_neighbor_host as j_nn
from radargnn_tpu.postprocess import boxes as jbx
from radargnn_tpu.postprocess.inference import Predictor as JPredictor
from radargnn_tpu.train.losses import adapt_bb_orientation_angle as j_adapt
from radargnn_tpu.train.trainer import Trainer as JTrainer
from radargnn_tpu_torch import configs as tcfg
import radargnn_tpu_torch.postprocess as tpp
from radargnn_tpu_torch import weights
from radargnn_tpu_torch.data.ground_truth import (
    create_2d_bounding_boxes as t_boxes,
)
from radargnn_tpu_torch.data.synthetic import make_samples as t_make_samples
from radargnn_tpu_torch.graph import features as tfeat
from radargnn_tpu_torch.graph.batch import stack_samples as t_stack
from radargnn_tpu_torch.graph.build import build_geometric_graph as t_build
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.models.layers import fused_csr_tiling
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.ops.knn import nearest_neighbor_host as t_nn
from radargnn_tpu_torch.postprocess import boxes as tbx
from radargnn_tpu_torch.postprocess.inference import Predictor
from radargnn_tpu_torch.smoke import INVARIANCES
from radargnn_tpu_torch.train.losses import (
    adapt_bb_orientation_angle as t_adapt,
)
from radargnn_tpu_torch.train.trainer import Trainer

import test_torch_detnet as tdet
import test_torch_postprocess as tpost
from host_backends import host_pair, native_cache  # noqa: F401
from torch_threads import few_threads  # noqa: F401

# the host arrays of both packages from one pair of host backends
pytestmark = pytest.mark.usefixtures("host_pair", "few_threads")

INVS = ("en", "none")
K = 20
POINTS, FRAMES, BUCKET = 200, 2, 256
LR = 1e-3
TRAIN_KW = dict(dataset="radarscenes", learning_rate=LR, epochs=2,
                batch_size=2, shuffle=False, bg_index=5, bb_loss_weight=0.5,
                regularization_strength=5e-6, adapt_orientation_angle=True,
                exponential_lr_decay_factor=0.95)
BOX_ATOL = 1e-12
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
ROUND_TRIP_ATOL = 1e-6


def _graph_kw(inv: str, k: int = K, mode: str = "directed") -> dict:
    """The flagship's GRAPH_CONSTRUCTION with `inv`'s features, at k."""
    fields = INVARIANCES[inv]
    return dict(graph_construction_algorithm="knn",
                graph_construction_settings={"k": k, "r": 1.0},
                node_features=fields["node_features"],
                edge_features=fields.get("edge_features",
                                         ["relative_position"]),
                edge_mode=mode, distance_definition="X")


def _arch_kw(inv: str, dtype: str = "float32") -> dict:
    """A narrow DetNet with `inv`'s node and edge widths."""
    fields = INVARIANCES[inv]
    return dict(tdet._arch_kw(dtype=dtype),
                node_feature_dimension=fields["node_feature_dimension"],
                edge_feature_dimension=fields.get("edge_feature_dimension",
                                                  2),
                conv_layer_dimensions=[32, 16],
                node_feature_embedding_layer_dimensions=[16, 32])


def _cloud(seed: int, n: int = 96):
    """A frame's host arrays: positions, velocities (some zero), rcs,
    timestamps, and track ids of three objects of 7, 5 and 3 points."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-30, 30, (n, 2))
    vel = rng.normal(0, 3, (n, 2))
    vel[::11] = 0.0
    tracks = np.full(n, b"", object)
    for obj, (lo, hi, c) in enumerate([(0, 7, (5, 5)), (7, 12, (-12, 8)),
                                       (12, 15, (9, -14))]):
        pos[lo:hi] = np.asarray(c) + rng.uniform(-2, 2, (hi - lo, 2))
        tracks[lo:hi] = str(obj).encode()
    rcs = rng.normal(0, 5, (n, 1))
    ts = np.repeat(np.arange(4), -(-n // 4))[:n].reshape(-1, 1)
    return pos, vel, rcs, ts, tracks


# -- graph construction and features ------------------------------------------

@pytest.mark.parametrize("mode", ["directed", "undirected"])
@pytest.mark.parametrize("inv", INVS)
def test_graph_and_features_match_jax(inv, mode):
    """`build_geometric_graph` under the configuration's features (the
    point-pair edge features, the velocity length, the absolute
    positions): edges, node and edge features equal to the JAX package's;
    then each feature kind alone, and the compiled point-pair helper
    against the numpy formula."""
    pos, vel, rcs, ts, _ = _cloud(1)
    kw = _graph_kw(inv, mode=mode)
    got = t_build(tcfg.GraphConstructionConfiguration(**kw), pos, vel,
                  rcs=rcs, timestamps=ts)
    want = j_build(jcfg.GraphConstructionConfiguration(**kw), pos, vel,
                   rcs=rcs, timestamps=ts)
    for name in ("edges", "node_feat", "edge_feat"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.node_feat.shape[1] == INVARIANCES[inv][
        "node_feature_dimension"]
    s, r = got.edges[:, 0], got.edges[:, 1]
    ppf = tfeat.point_pair_features(pos[s], pos[r], vel[s], vel[r], mode)
    np.testing.assert_array_equal(ppf, jfeat.point_pair_features(
        pos[s], pos[r], vel[s], vel[r], mode))
    assert ppf[:, 1:].max() > 170.0 and ppf[:, 1:].min() >= 0.0
    native = tfeat.native.point_pair_features_2d(pos, vel, got.edges,
                                                 mode == "directed")
    if native is not None:
        np.testing.assert_allclose(native, ppf, rtol=0, atol=1e-9)
    if inv == "en":
        np.testing.assert_allclose(got.edge_feat, ppf, rtol=0, atol=1e-9)
        np.testing.assert_array_equal(
            got.node_feat[:, 1], np.linalg.norm(vel, axis=-1))
    else:
        np.testing.assert_array_equal(got.node_feat[:, 3:5], pos)
    inv_feats = {"rcs": rcs, "time_index": tfeat.time_index_feature(ts)}
    for feature in ("velocity_vector_length", "spatial_coordinates"):
        np.testing.assert_array_equal(
            tfeat.node_features([feature], pos, vel, inv_feats),
            jfeat.node_features([feature], pos, vel, inv_feats))


def test_nearest_neighbour_matches_jax():
    """The 1-NN index the "en" encoding and decode read, on a cloud with
    duplicated points and ties, equal in both packages."""
    pos, *_ = _cloud(2)
    pos = np.concatenate([pos, pos[:4], [[0.0, 0.0], [1.0, 0.0],
                                         [-1.0, 0.0]]])
    np.testing.assert_array_equal(t_nn(pos), j_nn(pos))


# -- ground truth -------------------------------------------------------------

@pytest.mark.parametrize("inv,aligned", [
    ("en", False), ("none", False), ("translation", False), ("none", True),
    ("translation", True)])
def test_ground_truth_boxes_match_jax(inv, aligned):
    """The three encodings of `create_2d_bounding_boxes` ("en" with its
    nearest-neighbour anchor), rotated and (but "en") axis-aligned, on the
    same cloud: NaN on the background in both, the object rows within
    1e-12."""
    pos, *_, tracks = _cloud(3)
    got, want = t_boxes(pos, tracks, aligned, inv), \
        j_boxes(pos, tracks, aligned, inv)
    assert got.shape == want.shape == (len(pos), 4 if aligned else 5)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=BOX_ATOL)
    assert np.isfinite(got[:15]).all() and np.isnan(got[15:]).all()


def test_rotation_invariant_box_algebra_matches_jax():
    """The "en" box algebra on seeded boxes: the relative-rotated boxes to
    rotation-invariant ones, back, and to absolute corners."""
    rng = np.random.default_rng(4)
    rel = np.stack([rng.uniform(-3, 3, 30), rng.uniform(-3, 3, 30),
                    rng.uniform(0.5, 5, 30), rng.uniform(0.5, 2, 30),
                    rng.uniform(0, 180, 30)], axis=1)
    pts, nn = rng.uniform(-20, 20, (30, 2)), rng.uniform(-20, 20, (30, 2))
    inv = tbx.relative_rotated_to_rotation_invariant(rel, pts, nn)
    np.testing.assert_allclose(
        inv, jbx.relative_rotated_to_rotation_invariant(rel, pts, nn),
        rtol=0, atol=BOX_ATOL)
    np.testing.assert_allclose(
        tbx.rotation_invariant_to_relative_rotated(inv, pts, nn),
        jbx.rotation_invariant_to_relative_rotated(inv, pts, nn), rtol=0,
        atol=BOX_ATOL)
    np.testing.assert_allclose(
        tbx.rotation_invariant_to_absolute_corners(inv, pts, nn),
        jbx.rotation_invariant_to_absolute_corners(inv, pts, nn), rtol=0,
        atol=BOX_ATOL)


def _rot(phi_deg: float) -> np.ndarray:
    phi = np.deg2rad(phi_deg)
    return np.array([[np.cos(phi), -np.sin(phi)],
                     [np.sin(phi), np.cos(phi)]])


def _same_corners(a: np.ndarray, b: np.ndarray, atol: float) -> bool:
    """Each box's four corners equal up to their order."""
    d = np.linalg.norm(a[:, :, None] - b[:, None], axis=-1)
    return bool((d.min(axis=2) <= atol).all()
                and (d.min(axis=1) <= atol).all())


def test_en_round_trip_under_rotations():
    """The cloud rotated by 1 degree at a time through 360 (the reference's
    test_preprocessor.py:101-136): at every angle the port's "en" boxes
    equal the JAX package's and the unrotated encoding (1e-5), and
    `GroundTruthExtractor` decodes them, through each point's nearest
    neighbour, to the corners of the same frame's translation boxes
    (1e-6 m), in both packages."""
    pos0, *_, tracks = _cloud(5, n=40)
    labels = np.where(tracks == b"", 5, 1).astype(float)
    base = t_boxes(pos0, tracks, False, "en")
    for phi in range(360):
        pos = pos0 @ _rot(phi)
        en = t_boxes(pos, tracks, False, "en")
        np.testing.assert_allclose(en, j_boxes(pos, tracks, False, "en"),
                                   rtol=0, atol=BOX_ATOL, err_msg=str(phi))
        np.testing.assert_allclose(en, base, rtol=0, atol=1e-5,
                                   err_msg=str(phi))
        trans = t_boxes(pos, tracks, False, "translation")
        for mod in (tpp, jpp):
            got, _ = mod.GroundTruthExtractor.\
                get_absolute_object_bounding_boxes(labels, en, pos, "en", 5)
            want, _ = mod.GroundTruthExtractor.\
                get_absolute_object_bounding_boxes(labels, trans, pos,
                                                   "translation", 5)
            assert _same_corners(got.corners, want.corners,
                                 ROUND_TRIP_ATOL), (mod.__name__, phi)


# -- the model: forward, one training step ------------------------------------

@functools.lru_cache(maxsize=None)
def _model_pair(inv: str, dtype: str = "float32"):
    """A JAX DetNet of `inv`'s widths and the port's with its weights, and
    one batch of `inv`'s synthetic frames from each package (dense tiling
    at tests/test_pallas.py's geometry); built once a module."""
    kw = _arch_kw(inv, dtype)
    j_arch, t_arch = jcfg.GNNArchitectureConfig(**kw), \
        tcfg.GNNArchitectureConfig(**kw)
    spec = dict(fused_csr_tiling(t_arch, k=K), node_block=64, r_tile=16,
                ovf_frac=0.3)
    stack = dict(max_nodes=BUCKET, bg_index=5, max_edges=BUCKET * K,
                 csr_tiling=spec)
    samples = dict(num_frames=FRAMES, num_points=POINTS, seed=0,
                   bb_invariance=INVARIANCES[inv]["bb_invariance"])
    jb = j_stack(j_make_samples(graph_config=jcfg.
                                GraphConstructionConfiguration(
                                    **_graph_kw(inv)), **samples), **stack)
    tb = t_stack(t_make_samples(graph_config=tcfg.
                                GraphConstructionConfiguration(
                                    **_graph_kw(inv)), **samples),
                 device="cpu", **stack)
    j_model, variables = create_detnet_state(j_arch, jax.random.key(0), jb)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    t_model = DetNet(t_arch, device="cpu")
    t_model.load_state_dict(weights.from_jax_variables(variables))
    return (j_model, variables, jb), (t_model, tb)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inv", INVS)
def test_forward_on_carried_weights_matches_jax(inv, dtype):
    """Both Predictors on the same batch with the JAX package's weights:
    the batch's boxes (the configuration's encoding), labels, positions
    and features equal; probabilities and boxes within atol/rtol 1e-4
    (float32) or 2e-2 (bf16 compute); the port launches nothing here."""
    (j_model, variables, jb), (t_model, tb) = _model_pair(inv, dtype)
    for name in ("node_feat", "edge_feat", "boxes", "labels"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)
    assert tb.node_feat.shape[-1] == INVARIANCES[inv][
        "node_feature_dimension"]
    assert t_model.fused
    launches = da.dense_fwd_cuda.launches
    want = JPredictor(j_model, variables, [jb], verbose=False).predict()
    got = Predictor(t_model, [tb], verbose=False).predict()
    assert da.dense_fwd_cuda.launches == launches
    tol = 1e-4 if dtype == "float32" else 2e-2
    tdet._assert_predictions_close(got, want, dict(rtol=tol, atol=tol))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("inv", INVS)
def test_training_step_matches_jax(inv):
    """One Trainer step from the same weights and batch, the targets
    encoded as the configuration says and, under adapt_orientation_angle,
    their fifth column sin-encoded in both packages: the losses (rtol
    1e-4, atol 1e-5), and the gradients of the detection loss before the
    step, parameter by parameter, against jax.grad of the JAX trainer's
    loss (rtol/atol 1e-4); both on the dense path (the JAX package's
    backward in interpret mode)."""
    (j_model, variables, jb), (t_model, tb) = _model_pair(inv)
    t_model = copy.deepcopy(t_model)
    assert t_model.fused
    jt = JTrainer(jcfg.TrainingConfig(**TRAIN_KW), j_model, variables)
    tt = Trainer(tcfg.TrainingConfig(**TRAIN_KW), t_model)
    params, stats = jt.state.params, jt.state.batch_stats

    def loss(p):
        (logits, bb), _ = jt._forward(p, stats, jb, train=True)
        return jt._loss_terms(logits, bb, jb, jt._weights)[0]

    want = _flat(jax.jit(jax.grad(loss))(params))
    tt.model.zero_grad(set_to_none=True)
    tt.losses(tb)[0].backward()
    got = _flat(weights.to_jax_variables(
        {n: p.grad for n, p in tt.model.named_parameters()})["params"])
    assert sorted(got) == sorted(want)
    for path, u in got.items():
        np.testing.assert_allclose(u, want[path], err_msg=path, **GRAD_TOL)
    _, j_losses = jax.jit(jt.train_step_fn)(jt.state, jb)
    t_losses = [float(v) for v in tt.train_step(tb)]
    np.testing.assert_allclose(t_losses, np.asarray(j_losses), rtol=1e-4,
                               atol=1e-5)
    assert np.isfinite(t_losses).all()


# -- the evaluation stage -----------------------------------------------------

def _predictions(inv: str, adapt: bool, seed: int = 6):
    """Noisy predictions on the batch's frames: every object point regresses
    its box with noise (the fifth column sin-encoded with `adapt`), its
    class likely; the background random."""
    _, (_, tb) = _model_pair(inv)
    rng = np.random.default_rng(seed)
    pos, vel = [], []
    preds = {"bounding_box_predictions": [],
             "class_probability_prediction": []}
    gts = {"bounding_box_true": [], "class_true": []}
    for g in range(FRAMES):
        boxes = tb.boxes[g].double().numpy()
        labels = tb.labels[g].double().numpy()
        bb = np.nan_to_num(boxes, nan=0.0) + rng.normal(scale=0.03,
                                                        size=boxes.shape)
        if adapt:
            bb = t_adapt(torch.from_numpy(bb)).numpy()
        probs = rng.dirichlet(np.full(6, 0.3), size=len(labels))
        obj = labels != 5
        probs[obj] = 0.02
        probs[obj, labels[obj].astype(int)] = 0.9
        pos.append(tb.pos[g].double().numpy())
        vel.append(tb.vel[g].double().numpy())
        preds["bounding_box_predictions"].append(bb)
        preds["class_probability_prediction"].append(probs)
        gts["bounding_box_true"].append(boxes)
        gts["class_true"].append(labels)
    return pos, vel, preds, gts


def _evaluate(module, config_cls, inv: str, adapt: bool, predictions):
    pos, vel, preds, gts = predictions
    config = tpost._config(config_cls, bb_invariance=inv,
                           adapt_orientation_angle=adapt)
    if module is tpp:
        post = tpp.Postprocessor("cpu")
        ev = tpp.RadarscenesEvaluator(config, device="cpu")
    else:
        post, ev = jpp.Postprocessor(), jpp.RadarscenesEvaluator(config)
    out = post.process(config, pos, vel, preds, gts)
    ev.evaluate(*out[:3], module.PredictionExtractor().extract(preds),
                out[3])
    return out, ev


@pytest.mark.parametrize("inv", INVS)
def test_postprocessor_and_evaluator_match_jax(inv):
    """The `Postprocessor` and `RadarscenesEvaluator` under the
    configuration's POSTPROCESSING (the flagship's, bb_invariance
    replaced; the angle adapted where the decode inverts it) on the same
    predictions: the detections and ground-truth boxes within 1e-9 of
    their scale, scores and labels equal; mAP within 1e-12, F1 and the
    confusion matrix equal."""
    adapt = inv != "en"
    predictions = _predictions(inv, adapt)
    got, ev = _evaluate(tpp, tcfg.PostProcessingConfiguration, inv, adapt,
                        predictions)
    with jax.enable_x64(adapt):
        want, j_ev = _evaluate(jpp, jcfg.PostProcessingConfiguration, inv,
                               adapt, predictions)
    kept = 0
    for g, w in zip(got[0], want[0]):
        tpost._assert_boxes_equal(g["boxes"], w["boxes"])
        np.testing.assert_array_equal(g["scores"], w["scores"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
        kept += len(g["boxes"])
    assert kept >= FRAMES
    for g, w in zip(got[1], want[1]):
        tpost._assert_boxes_equal(g["boxes"], w["boxes"])
    assert abs(ev.mAP - j_ev.mAP) <= tpost.MAP_ATOL and 0.0 < ev.mAP
    np.testing.assert_array_equal(ev.f1_segmentation, j_ev.f1_segmentation)
    np.testing.assert_array_equal(ev.confusion_absolute,
                                  j_ev.confusion_absolute)


def test_en_angle_encoding_is_the_jax_packages():
    """Under adapt_orientation_angle both packages' trainers sin-encode the
    fifth column of every 5-column target, the "en" boxes' too, and both
    packages' "en" decode reads that column in radians without inverting
    the encoding (ROADMAP C11): the same losses on "en" targets, the
    decode's corners the same with and without the setting (unlike
    "translation"), and oracle predictions decode to their objects' boxes
    (within 1e-6, mAP 1.0) unencoded and to turned boxes encoded, alike in
    both packages (the point-IoU mAP at 0.3 does not tell them apart
    here)."""
    (j_model, variables, jb), (t_model, tb) = _model_pair("en")
    boxes = tb.boxes.reshape(-1, 5).double()
    np.testing.assert_allclose(t_adapt(boxes).numpy(),
                               np.asarray(j_adapt(np.asarray(boxes))),
                               rtol=0, atol=1e-6, equal_nan=True)
    losses = {}
    for adapt in (True, False):
        kw = dict(TRAIN_KW, adapt_orientation_angle=adapt)
        tt = Trainer(tcfg.TrainingConfig(**kw), t_model)
        jt = JTrainer(jcfg.TrainingConfig(**kw), j_model, variables)
        (logits, bb), _ = jt._forward(jt.state.params, jt.state.batch_stats,
                                      jb, train=True)
        want = float(jt._loss_terms(logits, bb, jb, jt._weights)[2])
        with torch.no_grad():
            got = float(tt.losses(tb)[2])
        np.testing.assert_allclose(got, want, rtol=1e-4)
        losses[adapt] = got
    assert abs(losses[True] - losses[False]) > 1e-3 * losses[False]

    rng = np.random.default_rng(7)
    bb, pts, nn = rng.normal(size=(20, 5)), rng.normal(size=(20, 2)) * 10, \
        rng.normal(size=(20, 2)) * 10
    for mod in (tpp, jpp):
        np.testing.assert_array_equal(
            mod.decode_boxes_to_corners(bb, pts, nn, "en", True),
            mod.decode_boxes_to_corners(bb, pts, nn, "en", False))
        assert not np.allclose(
            mod.decode_boxes_to_corners(bb, pts, None, "translation", True),
            mod.decode_boxes_to_corners(bb, pts, None, "translation", False))

    oracle = {}
    for encoded in (False, True):
        pos, vel, preds, gts = _predictions("en", encoded)
        preds["bounding_box_predictions"] = [
            t_adapt(torch.from_numpy(np.nan_to_num(b, nan=0.0))).numpy()
            if encoded else np.nan_to_num(b, nan=0.0)
            for b in gts["bounding_box_true"]]
        preds["class_probability_prediction"] = [
            tpost._perfect_class_probs(c) for c in gts["class_true"]]
        for mod, cls in ((tpp, tcfg.PostProcessingConfiguration),
                         (jpp, jcfg.PostProcessingConfiguration)):
            config = tpost._config(cls, bb_invariance="en",
                                   adapt_orientation_angle=True)
            # each object point's decoded box against its object's
            shift = 0.0
            for p, b, c, labels, gt in zip(
                    pos, preds["bounding_box_predictions"],
                    preds["class_probability_prediction"], gts["class_true"],
                    gts["bounding_box_true"]):
                got, _, _ = mod.PredictionExtractor.\
                    get_absolute_object_bounding_box_predictions(c, b, p,
                                                                 config)
                want, _ = mod.GroundTruthExtractor.\
                    get_absolute_object_bounding_boxes(labels, gt, p, "en",
                                                       5)
                shift = max(shift, float(np.abs(got.corners
                                                - want.corners).max()))
            _, ev = _evaluate(mod, cls, "en", True, (pos, vel, preds, gts))
            oracle[encoded, mod.__name__] = (shift, ev.mAP)
    assert oracle[False, tpp.__name__] == oracle[False, jpp.__name__]
    assert oracle[False, tpp.__name__][0] <= ROUND_TRIP_ATOL
    assert oracle[False, tpp.__name__][1] == 1.0
    # the encoded angle read as radians turns the boxes in both packages
    assert oracle[True, tpp.__name__] == oracle[True, jpp.__name__]
    assert oracle[True, tpp.__name__][0] > 0.1
