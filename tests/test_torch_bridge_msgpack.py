"""The port's own reader of flax msgpack checkpoints
(`conditioned_nerf_gan_torch/utils/flax_msgpack.py`) against
`flax.serialization.msgpack_restore`: a JAX trainer checkpoint (the JAX
package's `save_checkpoint` of a TrainState) written with a small chunk
limit so that its larger leaves are chunked, and a document of every leaf
kind flax writes (bfloat16, numpy scalars, complex, strings, lists, None).
`bridge.convert_checkpoint` runs in a subprocess with `jax`, `flax`,
`optax` and the JAX package blocked in `sys.modules`.

About 10 s on one CPU process.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import flax.serialization as serialization
import jax
import jax.numpy as jnp
import torch

from conditioned_nerf_gan_tpu.models import ImplicitGenerator3d as JGenerator
from conditioned_nerf_gan_tpu.models import RenderConfig as JRenderConfig
from conditioned_nerf_gan_tpu.models import make_unet as j_make_unet
from conditioned_nerf_gan_tpu.training import checkpoints as jcheckpoints
from conditioned_nerf_gan_tpu.training import train_step as jts
from conditioned_nerf_gan_torch import bridge
from conditioned_nerf_gan_torch.utils import flax_msgpack

REPO = Path(__file__).resolve().parent.parent
UNET = dict(in_channels=4, out_channels=8, f_maps=8, num_levels=2, return_global=True)


def _assert_same_tree(ours, theirs, path="") -> int:
    """Same structure and, leaf for leaf, the same type, dtype, shape and
    bytes; returns the number of array leaves."""
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and list(ours) == list(theirs), path
        return sum(_assert_same_tree(ours[k], theirs[k], f"{path}.{k}") for k in theirs)
    if isinstance(theirs, list):
        assert isinstance(ours, list) and len(ours) == len(theirs), path
        return sum(_assert_same_tree(a, b, f"{path}[{i}]")
                   for i, (a, b) in enumerate(zip(ours, theirs)))
    if isinstance(theirs, np.ndarray) and theirs.dtype.name == "bfloat16":
        assert isinstance(ours, torch.Tensor) and ours.dtype == torch.bfloat16, path
        assert tuple(ours.shape) == theirs.shape, path
        assert ours.view(torch.int16).numpy().tobytes() == theirs.view(np.int16).tobytes(), path
        return 1
    if isinstance(theirs, (np.ndarray, np.generic)):
        assert type(ours) is type(theirs), path
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, path
        assert ours.tobytes() == theirs.tobytes(), path
        return 1
    assert type(ours) is type(theirs) and ours == theirs, path
    return 0


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX trainer checkpoint ({step}.ckpt of a TrainState: G, E, their
    optax states, no D) written with flax's chunk limit at 4 KiB; and the
    JAX params."""
    cfg = jts.TrainStepConfig(render=JRenderConfig(img_size=4, num_steps=4), load_voxel=True,
                              load_pcl=False, enable_discriminator=False)
    gen = JGenerator(siren_type="TALLSIREN_dg", z_dim=16, input_dim=8, hidden_dim=16)
    batch = {"cam2world": np.eye(4, dtype=np.float32)[None],
             "voxel": np.zeros((1, 8, 8, 8, 4), np.float32)}
    state = jts.create_train_state(jax.random.PRNGKey(0), gen, j_make_unet(**UNET), None,
                                   batch, cfg)
    limit = serialization.MAX_CHUNK_SIZE
    serialization.MAX_CHUNK_SIZE = 4096
    try:
        path = jcheckpoints.save_checkpoint(tmp_path_factory.mktemp("run") / "checkpoints", 7,
                                            state)
    finally:
        serialization.MAX_CHUNK_SIZE = limit
    return path, state


def test_reader_is_bit_equal_to_flax_on_a_trainer_checkpoint(jax_checkpoint):
    path, _ = jax_checkpoint
    data = path.read_bytes()
    raw = flax_msgpack.unpackb(data)  # before unchunking: chunked leaves are there
    chunked = []

    def find(tree, prefix=""):
        if isinstance(tree, dict):
            if "__msgpack_chunked_array__" in tree:
                chunked.append(prefix)
            for k, v in tree.items():
                find(v, f"{prefix}.{k}")

    find(raw)
    assert chunked, "no leaf was chunked"
    n = _assert_same_tree(flax_msgpack.msgpack_restore(data),
                          serialization.msgpack_restore(data))
    assert n > 20


def test_reader_takes_every_leaf_kind_flax_writes():
    rng = np.random.default_rng(0)
    tree = {
        "f32": rng.normal(size=(3, 5)).astype(np.float32),
        "f64": rng.normal(size=(2,)),
        "i8": np.arange(-4, 4, dtype=np.int8),
        "u64": np.array([2 ** 63 + 5], np.uint64),
        "bool": np.array([True, False]),
        "bf16": jnp.asarray(rng.normal(size=(4, 3)), jnp.bfloat16),
        "scalar": np.float32(1.5),
        "int_scalar": np.int64(-7),
        "complex": complex(1.5, -2.0),
        "text": "ünïcode" * 40,
        "ints": [0, 1, -1, 127, -32, -33, 255, 65535, 2 ** 32, -(2 ** 40), 2 ** 63],
        "floats": [0.5, -1e300],
        "flags": [True, False, None],
        "empty": {},
        "big": np.zeros((70000,), np.float32),  # a bin 32 payload
        "nested": {str(i): {"x": np.full((2,), i, np.int32)} for i in range(20)},
    }
    data = serialization.msgpack_serialize(tree)
    _assert_same_tree(flax_msgpack.msgpack_restore(data), serialization.msgpack_restore(data))
    out = flax_msgpack.msgpack_restore(data)
    assert out["bf16"].dtype == torch.bfloat16 and isinstance(out["complex"], complex)


def test_reader_refuses_what_it_cannot_read():
    bad_dtype = serialization.msgpack_serialize({"x": np.zeros(2, np.float32)})
    bad_dtype = bad_dtype.replace(b"float32", b"floatXX")
    with pytest.raises(ValueError, match="floatXX"):
        flax_msgpack.msgpack_restore(bad_dtype)
    with pytest.raises(ValueError, match="extension type 9"):
        flax_msgpack.unpackb(b"\xd4\x09\x00", flax_msgpack._ext_hook)
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.unpackb(serialization.msgpack_serialize({"a": 1})[:-1])
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.unpackb(b"\x01\x02")


_BLOCKED_RUN = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "conditioned_nerf_gan_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError
from conditioned_nerf_gan_torch import bridge
print(bridge.convert_checkpoint(sys.argv[1]))
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax")
          and sys.modules[m] is not None]
assert not loaded, loaded
"""


def test_convert_checkpoint_runs_without_jax_or_flax(jax_checkpoint):
    """convert_checkpoint in a process where jax, flax, optax and the JAX
    package cannot be imported: the .pt it writes holds the params the
    bridge maps from the JAX state, bit for bit."""
    path, state = jax_checkpoint
    done = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, str(path)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    out = Path(done.stdout.strip().splitlines()[-1])
    assert out == path.with_suffix(".pt")
    converted = torch.load(out)
    assert converted["step"] == int(state.step)  # the state's own step, as flax wrote it
    for net in ("G", "E"):
        ref = bridge.params_to_state_dict(jax.tree.map(np.asarray,
                                                       getattr(state, f"params_{net}")))
        assert set(converted[f"params_{net}"]) == set(ref)
        for k, v in ref.items():
            assert torch.equal(converted[f"params_{net}"][k], v), k
