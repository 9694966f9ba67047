"""nuScenes scene splits.

Port of `radargnn_tpu/data/nuscenes/splits.py`. The official trainval/test
partitions come, in this order of precedence, from a `NUSCENES_SPLITS_JSON`
file (keys train_detect, train_track, val, test), from the nuScenes devkit
where it imports (scene names), or from the scene-token constants in
`splits_vendored.py`, so a clean install needs no devkit.
"""

from __future__ import annotations

import json
import os
from typing import List

# Official v1.0-mini splits (nuScenes devkit `splits.py` mini_train/mini_val).
mini_train: List[str] = [
    "scene-0061", "scene-0553", "scene-0655", "scene-0757",
    "scene-0796", "scene-1077", "scene-1094", "scene-1100",
]
mini_val: List[str] = ["scene-0103", "scene-0916"]


def _load_full_splits():
    path = os.environ.get("NUSCENES_SPLITS_JSON", "")
    if path and os.path.exists(path):
        with open(path) as f:
            d = json.load(f)
        return (d.get("train_detect", []), d.get("train_track", []),
                d.get("val", []), d.get("test", []))
    try:
        from nuscenes.utils import splits as devkit_splits  # type: ignore
        return (devkit_splits.train_detect, devkit_splits.train_track,
                devkit_splits.val, devkit_splits.test)
    except ImportError:
        pass
    from radargnn_tpu_torch.data.nuscenes import splits_vendored as v
    return v.train_detect, v.train_track, v.val, v.test


train_detect, train_track, val, test = _load_full_splits()


def require_full_splits() -> None:
    """Always satisfied on a clean install (vendored constants)."""
    if not (train_detect or train_track or val):
        raise RuntimeError(
            "Full nuScenes trainval splits unavailable — the vendored "
            "constants failed to load and no devkit/NUSCENES_SPLITS_JSON "
            "override is present.")
