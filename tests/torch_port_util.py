"""Shared helpers of the tests that hold mmlspark_tpu_torch against the
JAX package (tests/test_torch_*.py)."""
import numpy as np

import jax
import jax.numpy as jnp

from mmlspark_tpu.models import resnet as JR


def random_flax_variables(name: str, seed: int, num_classes: int = 10,
                          hw: int = 32) -> dict:
    """The flax ResNet's variable tree with every leaf random (numpy):
    He-scaled conv kernels, LeCun-scaled dense kernel, BatchNorm scale and
    var in U(0.5, 1.5), biases and means ~ N(0, 0.1)."""
    module = getattr(JR, name)(num_classes=num_classes, dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda: module.init({"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, hw, hw, 3)), train=False))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            gain = 2.0 if len(s.shape) == 4 else 1.0
            return (rng.standard_normal(s.shape) * np.sqrt(gain / fan_in)
                    ).astype(np.float32)
        if leaf in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree.map(np.asarray, {k: dict(v) for k, v in tree.items()})
