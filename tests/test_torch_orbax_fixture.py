"""The committed orbax checkpoint the JAX package wrote
(`radargnn_tpu_torch/testdata/orbax_detnet`, `smoke_variants.ORBAX_FIXTURE`,
which the on-card smoke reads): rebuilt here by the JAX package's
`save_train_state(backend="orbax")` from the state of its seed
(`smoke_variants.orbax_fixture_state`), it holds the values of the
committed files (values, not bytes: uuids, file names and times differ),
so the fixture stays what the JAX package writes; and the port reads the
committed files as that state with tensorstore and zstandard blocked.

To write the fixture anew: `JAX_PLATFORMS=cpu python
tests/test_torch_orbax_fixture.py`.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from radargnn_tpu_torch import smoke_variants as sv  # noqa: E402
from radargnn_tpu_torch.train import ocdbt, zstd  # noqa: E402


def write_fixture(folder: str) -> None:
    """The fixture's checkpoint as the JAX package writes it: the state's
    arrays as jax.Arrays through orbax's PyTreeCheckpointer."""
    import jax
    import jax.numpy as jnp
    from radargnn_tpu.train import checkpoint as jckpt

    state = sv.orbax_fixture_state()
    arrays = {k: jax.tree_util.tree_map(jnp.asarray, state[k])
              for k in ("params", "batch_stats", "opt_state")}
    jckpt.save_train_state(folder, epoch=state["epoch"],
                           losses=state["losses"],
                           scheduler_lr=state["scheduler_lr"],
                           backend="orbax", **arrays)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict) and tree:
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, tree


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, dict):
            assert got[k] == v, k
            continue
        u, v = np.asarray(got[k]), np.asarray(v)
        assert u.dtype == v.dtype and u.shape == v.shape, k
        assert np.array_equal(u, v), k


def test_fixture_is_what_the_jax_package_writes(tmp_path):
    """The JAX package, from the seed's state, writes a checkpoint that
    its own reader and the port's read as the committed one: the same
    trees, meta, tree metadata, keys and array metadata."""
    import jax
    from radargnn_tpu.train import checkpoint as jckpt
    from radargnn_tpu_torch.train import checkpoint as tckpt

    folder = str(tmp_path / "ck")
    write_fixture(folder)
    fresh = jckpt.load_train_state(folder)
    committed = jckpt.load_train_state(sv.ORBAX_FIXTURE)
    for got, want in zip(committed[:2], fresh[:2]):
        _assert_trees_equal(jax.device_get(got), jax.device_get(want))
    assert committed[2] == fresh[2]
    for got, want in zip(tckpt.load_train_state(sv.ORBAX_FIXTURE)[:2],
                         tckpt.load_train_state(folder)[:2]):
        _assert_trees_equal(got, want)
    new, old = (os.path.join(f, "orbax") for f in (folder,
                                                     sv.ORBAX_FIXTURE))
    for name in ("_METADATA", "_sharding",
                 os.path.join("array_metadatas", "process_0")):
        with open(os.path.join(new, name)) as f, \
                open(os.path.join(old, name)) as g:
            assert json.load(f) == json.load(g), name
    assert ocdbt.Store(new).list() == ocdbt.Store(old).list()


def test_fixture_holds_compressed_zstd_blocks():
    """The fixture's chunks are tensorstore's zstd frames: Huffman-coded
    literals and sequences both occur (the on-card read meets them)."""
    store = ocdbt.Store(os.path.join(sv.ORBAX_FIXTURE, "orbax"))
    frames = [store.read(k) for k in store.list() if not k.endswith(
        b".zarray")]
    lanes = zstd._Lanes()
    blocks = [b for f in frames for frame in zstd._parse(f, lanes)
              for b in frame.blocks]
    compressed = [p for kind, p in blocks if kind == zstd._COMPRESSED]
    assert compressed and lanes.lanes
    assert any(seqs for _, seqs in compressed)
    assert any(kind == zstd._RAW for kind, _ in blocks)


def test_port_reads_the_fixture_without_tensorstore():
    """A fresh interpreter where tensorstore and zstandard cannot be
    imported reads the committed checkpoint bit for bit as its seed's
    state and resumes a trainer from it (the smoke's check, on the
    CPU)."""
    code = (
        "import sys\n"
        "sys.modules['tensorstore'] = None\n"
        "sys.modules['zstandard'] = None\n"
        "from radargnn_tpu_torch import smoke_variants as sv\n"
        "res = sv.orbax_fixture_check('cpu', out=lambda *_: None)\n"
        "assert res['bitwise'] and res['meta'] and res['resumed'], res\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
        "'radargnn_tpu', 'orbax', 'tensorstore', 'zstandard', "
        "'google_crc32c', 'crc32c') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(res['bytes'])\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert 10_000 < int(proc.stdout.strip()) < 256 * 1024


if __name__ == "__main__":
    shutil.rmtree(sv.ORBAX_FIXTURE, ignore_errors=True)
    write_fixture(sv.ORBAX_FIXTURE)
    print(f"wrote {sv.ORBAX_FIXTURE}")
