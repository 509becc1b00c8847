"""Detector weights shared by the port's detection tests.

The weights are drawn with numpy over each module's flax tree (from
`jax.eval_shape`, no JAX init: the reference's `MTCNN()` initialises its
nets op by op, 25 s on this CPU): fan-in normal kernels, small biases,
BatchNorm near the identity, PReLU slopes near 0.25. `cascade_variables`
raises the face-class biases of PNet's `conv4_1`, RNet's `dense5_1` and
ONet's `dense6_1` by FACE_BIAS, so that on `photo()` with min_face
MIN_FACE each stage keeps some of its boxes but not all, at
probabilities below 1 (no ties for `argsort`).
"""

import math

import numpy as np

import jax
import jax.numpy as jnp

from news_image_caption_tpu.models import facenet as jf

FACE_BIAS = (0.35, 1.0, 1.5)
PHOTO = (48, 64)
MIN_FACE = 24


def random_variables(module, shape, seed: int):
    """numpy weights over the flax tree of `module` applied to `shape`."""
    tree = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                              jnp.zeros(shape)))
    rng = np.random.default_rng(seed)

    def leaf(path, spec):
        name = path[-1].key
        s = spec.shape
        if name == "kernel":
            return (rng.standard_normal(s)
                    * math.prod(s[:-1]) ** -0.5).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(s)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, s).astype(np.float32)
        if name.startswith("prelu"):
            return (0.25 + 0.05 * rng.standard_normal(s)).astype(np.float32)
        return (0.1 * rng.standard_normal(s)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def cascade_variables():
    """PNet, RNet and ONet variables with the face biases raised."""
    out = []
    for i, (net, shape, head) in enumerate((
            (jf.PNet(), (1, 12, 12, 3), "conv4_1"),
            (jf.RNet(), (1, 24, 24, 3), "dense5_1"),
            (jf.ONet(), (1, 48, 48, 3), "dense6_1"))):
        v = random_variables(net, shape, seed=10 + i)
        v["params"][head]["bias"][1] += FACE_BIAS[i]
        out.append(v)
    return out


def photo(seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (*PHOTO, 3),
                                                np.uint8)
