from radargnn_tpu_torch.data.radarscenes.dataset_creation import (  # noqa: F401
    RadarScenesGraphDataset,
)
