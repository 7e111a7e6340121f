"""Parameters of a flax module drawn with numpy at the shapes its ``init``
would give: the tests that hold the port against the JAX package need the
same weights on both sides, not flax's initializers, and this skips the
XLA compile of ``init`` (seconds a model on the CPU)."""

import jax
import numpy as np


def random_params(module, *args, seed=0):
    """``{"params": ...}`` for ``module.init(key, *args)``: scales about 1,
    biases about 0.1, every other leaf N(0, 1 / fan_in)."""
    shapes = jax.eval_shape(module.init, jax.random.key(0), *args)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name.endswith("scale"):
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name.endswith("bias"):
            v = 0.1 * rng.standard_normal(s.shape)
        else:
            v = rng.standard_normal(s.shape) / np.sqrt(max(int(np.prod(s.shape[:-1])), 1))
        return v.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)
