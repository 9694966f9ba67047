"""On-card check of the PyTorch port (radargnn_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

It prints the card's name and power limit and builds the port's eleven CUDA
sources from the checkout (dense forward: the node projection and the
gather-max; dense backward; segment-sum landing; windowed forward and
backward; CSR forward and backward; fused linear; message segment-max; v1
hoisted forward and backward; one nvcc each, in parallel). It holds each of
the twelve kernels against its plain PyTorch version at every layer shape
of the flagship RadarScenes DetNet (the dense kernels on the kNN batch, the
windowed kernels on the radius batch and on the kNN batch under the
windowed tiling: the forward's routing bits on real-valued inputs and,
with the backward, exactly on dyadic ones; the CSR kernels on the kNN
batch and on the radius batch under the CSR tiling; the segment-sum
landing at each of its call sites, the CSR backward's d_x and the H
columns of its d_op sums among them, also on real-valued bf16 and float32
rows, bitwise the float32 sum in listed order), and checks that two
backward runs give the same bits. Then, for three paths, the kNN graph (dense
tiling), the radius graph (windowed tiling; the flagship configuration with
three fields replaced, printed) and the kNN graph under the CSR tiling (the
flagship configuration with fused_tiling "csr", printed), it serves a few
batches of 5 x 2816-point synthetic frames through the port's Predictor and
trains the same DetNet for a few steps through the port's Trainer (the
flagship configuration, deterministic algorithms on), checks that every
conv layer launched the path's kernels, that each path matches the same
model on the plain path and that a second training run gives the same
losses; on the kNN path it also holds each conv's offset bias (MPNNConv's
x @ W_r + bias, whose gradient the BatchNorm after the conv cancels to
rounding, below the step check's floor) to the plain path's within 5e-4
of the sums of the offset gradient's row magnitudes. Then the three paths
run the Radar-PointGNN model: the flagship
configuration with conv_layer_type "RadarPointGNNConv" (printed; its
one-layer pre-MLP and max aggregation keep the fused kernels), five
residual convs of (d_in, d_e, H) = (224, 16, 240), whose offset is the
pre-MLP's bias broadcast over the nodes: on each path the kernels against
their plain versions at that one shape (with the limits above, each
printed with its time and bound, and on one line "pointgnn kernels: "),
three requests (each forward kernel 15 launches, nothing else) and four
training steps (launches exact) against the plain path, the pre-MLP
biases' gradients against the plain path's within 5e-4 of the sums of
their rows' magnitudes (the BatchNorm after each residual update cancels
those sums), and over 8 weight seeds the median free-running loss gap of
the kernel path to the plain path at most 2x the re-associated plain
path's; the phase's wall is printed. Then the paper's two other
RadarScenes models run on the kNN path (dense tiling): the E(n)-invariant
one (the flagship configuration with bb_invariance "en", node features
rcs, velocity_vector_length, time_index, degree and the point-pair edge
features, printed) and the non-invariant one (bb_invariance "none", the
absolute positions among the node features, printed), each on its own
5 x 2816-point frames: B1 and B2 against their plain versions at the five
layer shapes (the forward on the batch's own embedded edge rows, each
printed with its time and bound, and on one line "invariance kernels: "),
three requests and four training steps against the plain path as above
(launches exact, a second run bitwise equal), the offset biases as above,
the evaluation stage on the card against the CPU as in the fifth phase
below (oracle mAP exactly 1.0: the "en" decode's nearest-neighbour
recompute and the "none" decode round-trip their targets), and the host's
compiled point-pair helper, which must have built and agree with the
numpy formula within 1e-5 of each column's scale; the phase's wall is
printed. A fourth phase holds the four kernels
that no model path runs
against their plain versions at the flagship's widths on the kNN batch (the
v1 pair at the five layer shapes under 128 x 256 receiver-CSR tiles, its
backward exact on dyadic inputs and bitwise repeatable; the message
segment-max at 464 -> 464, on seeded and on wide-range messages; the fused
linear at 4096 x 256 -> 512 and over the batch's nodes at 224 -> 464,
timed against torch.addmm in alternating rounds by a child process with
cuBLAS's default workspace), then drives their entry points,
radargnn_tpu_torch.benchmarks.kernel_check (prints KERNEL CHECK OK) and
kernel_bench (two JSON lines at 450,560 edges), and checks that each of the
four launched. A fifth phase runs the evaluation stage on the card: the kNN
requests through Predictor.predict, the Postprocessor (NMS) and the
RadarscenesEvaluator under the flagship configuration's POSTPROCESSING, on
the real predictions and on oracle predictions built from the frames'
ground truth (mAP 1.0), each held to the same chain on the CPU (kept
indices, mAP, F1, confusion matrix), with the rotated IoU of an oracle
frame's boxes on the card against the CPU's. A sixth runs the port's bench
(python -m radargnn_tpu_torch.benchmarks.bench, 4 steps, one pair) in child
processes: train and infer on the dense tiling, train on the CSR and the
windowed tilings. A seventh runs the command-line pipeline,
radargnn_tpu_torch.cli.main, under the flagship configuration with epochs 2
and a checkpoint every epoch (printed): create_dataset from raw
RadarScenes sequences it writes and reads with the port's own HDF5 code
(radargnn_tpu_torch.data.hdf5; no h5py) through the configuration's
spawned workers, train and evaluate, checking that create_dataset launched
no kernel, train the dense path's three kernels and evaluate its two,
exactly as often as the batches ask, and nothing else; then python -m
radargnn_tpu_torch.cli.evaluate --plot 2 as a child process, the model
folder evaluated on the CPU against the card (its two prediction plots
drawn too), and the HDF5 reader timed on one table of 500,000 rows
(printed beside create_dataset's seconds and the raw bytes it read). Every
figure the run writes (loss_curves.png, each evaluation's confusion.png,
the prediction plots) is drawn by the port's own rasteriser and PNG writer
(radargnn_tpu_torch.postprocess.figure; no matplotlib), read back with its
PNG reader, and must have its size and ink on more than 1 % of its
pixels; their bytes and the host's draw seconds are printed. An eighth
runs the nuScenes pipeline the same way, under the nuScenes configuration
with epochs 2 (printed), on nuScenes-format tables and multisweep radar
sweeps it writes (two train scenes of 32 samples, one validation scene of
16; batches of 32 frames of about 1,900 points):
create_dataset, train and evaluate (the NuscenesEvaluator: submission.json
and the native detection eval's mAP and NDS), the launches of the dense
path's kernels counted as above; then the evaluate CLI as a child
process, the model folder evaluated on the CPU against the card, its
figures checked as above, oracle
predictions through the card's and the CPU's NMS and evaluator (equal
metrics, AP above 0.9 for every class present), the dense path's kernels
held against their plain versions on the train CLI's first batch of 32
frames, and last radargnn_tpu_torch.benchmarks.nuscenes_e2e as a child
process, alone. A ninth holds the settings that reach kernel variants:
B1's and B4's bf16 routing test, B4's forward with its maxima landed in
bf16 (RADARGNN_FUSED_BF16_LANDING; serving and VJP mode, equal on dyadic
inputs, within one bf16 ulp of a landed max on real-valued ones) and B1
and B2 at receiver tiles of 8 and 24 against their plain versions at the
five layer shapes; trains the flagship under fused_bf16_max (dense,
windowed, CSR), under the three variant knobs of the windowed kernels
together (2 steps and 1 request against the plain path), at r_tile 8 and
under ovf_ssum; trains the unfused configurations against the CPU; runs
the convergence and preprocessing tools as child processes; and saves and
restores the kNN trainer's state through the orbax backend bit for bit
(the port's own OCDBT, zarr and zstd code: the card's machine has no
tensorstore; the zstd encoder compresses, Huffman-coded literals and
long runs as sequences, and the phase prints each store's bytes beside
its arrays' and fails above 0.95 of them for the trainer's state, 0.75
for the flagship state of `orbax_fixture_state`, which it also saves and
restores bit for bit), resumes a fresh trainer from it whose next step's
losses are the uninterrupted trainer's bit for bit, and reads the JAX
package's committed orbax checkpoint bit for bit. A tenth
trains across ranks: two gloo ranks share the card on a {"model": 2} mesh
and train the flagship DetNet through halo x dense on the kNN batch and
halo x windowed on the radius batch (B1, B2 and B4 per rank, the boundary
exchange between them), each run's aggregate, steps and request held to
the single card, each rank's launches counted (over NCCL too where the
machine has two or four cards); then, in a spawn of their own, the same
two runs with conv_layer_type "RadarPointGNNConv" (H 240, the offset the
pre-MLP bias broadcast over each rank's rows), the aggregate held with
that broadcast bias, and each conv's pre-MLP bias gradient, summed over
the ranks, held to the single card's plain path within 5e-4 of the
offset gradient's magnitudes summed over the ranks, those magnitudes
within 1e-2 of the single card's (the MPNNConv runs' offset biases are
held the same way); the runs' wall is printed beside the
card's name and power limit. Then the scaling tool, the multi-rank dry
run (dense receiver tiles of 8, the JAX dry run's) and the train CLI
under torchrun (mesh_axes {"model": 2}) run as child processes. It prints
the kernels' times beside their bounds (the Radar-PointGNN and the
invariance phases' training launches and errors, and the launches of the
tenth phase's Radar-PointGNN runs over both ranks, join the entries of the
kernels they run; their times stay the MPNN step's). The last line is
one JSON object with "ok" and the device; any failed phase exits
non-zero.
"""

import json
import os
import sys

# cuBLAS reads its workspace setting when it creates its first handle; the
# training phase runs with torch's deterministic algorithms, which need it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from radargnn_tpu_torch import smoke

    summary = smoke.run("cuda")
    print(json.dumps({"kernels": summary["kernels"]}))
    print(summary["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
