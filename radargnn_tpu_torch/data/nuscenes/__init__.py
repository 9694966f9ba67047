"""The nuScenes pipeline: the native table reader, multisweep radar
aggregation, graph-dataset creation, the submission writer and the native
CVPR-2019 detection evaluation (host numpy; no devkit, h5py or matplotlib
needed to import)."""
