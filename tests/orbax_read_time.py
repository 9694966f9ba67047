"""Host-CPU time of the port reading an orbax checkpoint the JAX package
wrote (tensorstore's OCDBT stores and zstd level-1 chunks) at the
flagship trainer's size: the flagship DetNet's weights, statistics and
Adam moments (about 14.6 MB of float32) drawn from a seed
(`smoke_variants.orbax_fixture_state`), written by the JAX package's
`save_train_state(backend="orbax")`, then read by the port's
`load_train_state` (best of `--repeats`); beside it the port's own save
of that state and its read back, and the port's store's bytes over the
JAX package's (`port_to_jax_bytes`). Prints one JSON line.

    JAX_PLATFORMS=cpu python tests/orbax_read_time.py [--repeats 3]
"""

import argparse
import json
import os
import platform
import shutil
import sys
import tempfile
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from radargnn_tpu_torch import smoke as sm  # noqa: E402
from radargnn_tpu_torch import smoke_variants as sv  # noqa: E402
from radargnn_tpu_torch.train import checkpoint as tckpt  # noqa: E402


def _best(fn, repeats):
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return min(times), out


def measure(arch=None, repeats: int = 3, seed: int = 0) -> dict:
    """Writes the state of `arch` (default the flagship's) with the JAX
    package, reads it with the port, and times both the read and the
    port's own save and read of the same state."""
    import jax
    import jax.numpy as jnp
    from radargnn_tpu.train import checkpoint as jckpt

    arch = arch or sm.flagship_configs("knn")[0]
    state = sv.orbax_fixture_state(seed, arch)
    trees = {k: state[k] for k in ("params", "batch_stats", "opt_state")}
    leaves = [v for _, v in sv._flat_leaves(trees)
              if not isinstance(v, dict)]
    root = tempfile.mkdtemp()
    try:
        jax_folder, port_folder = (os.path.join(root, n)
                                   for n in ("jax", "port"))
        jckpt.save_train_state(
            jax_folder, epoch=1, losses={}, scheduler_lr=1e-3,
            backend="orbax", **{k: jax.tree_util.tree_map(jnp.asarray, v)
                                for k, v in trees.items()})
        read_s, got = _best(lambda: tckpt.load_train_state(jax_folder),
                            repeats)
        if not sv._trees_equal({"params": got[0]["params"],
                                "batch_stats": got[0]["batch_stats"],
                                "opt_state": got[1]}, trees):
            raise AssertionError("the port read another state")
        save_s, _ = _best(lambda: tckpt.save_train_state(
            port_folder, epoch=1, losses={}, scheduler_lr=1e-3,
            backend="orbax", **trees), repeats)
        port_read_s, _ = _best(lambda: tckpt.load_train_state(port_folder),
                               repeats)
        res = {"host": f"{platform.processor() or platform.machine()}, "
                       f"{os.cpu_count()} cores",
               "leaves": len(leaves),
               "array_bytes": int(sum(np.asarray(v).nbytes
                                      for v in leaves)),
               "jax_files_bytes": sv._folder_files(jax_folder)[1],
               "read_s": read_s, "port_save_s": save_s,
               "port_files_bytes": sv._folder_files(port_folder)[1],
               "port_read_s": port_read_s}
        res["port_to_jax_bytes"] = res["port_files_bytes"] \
            / res["jax_files_bytes"]
        return res
    finally:
        shutil.rmtree(root)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args()
    print(json.dumps(measure(repeats=args.repeats)))
