"""Shared pieces of the tests that hold the PyTorch port against the JAX
package: the small detector configuration and non-trivial JAX variables
made with numpy from a seed."""
import jax
import jax.numpy as jnp
import numpy as np

# The 2D detector cut to test size: R-50, narrow FPN and box head, 64x128.
TINY = dict(body="R-50", out_channels=32, mlp_head_dim=64, pre_nms_top_n_test=200,
            post_nms_top_n_test=48, max_det=8, detections_per_img=8)
IMG_HW = (64, 128)


def _fill(path, shape, rng):
    leaf = path[-1]
    if leaf == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
    if leaf == "scale":
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if leaf == "var":
        return rng.uniform(0.5, 2.0, shape).astype(np.float32)
    # biases of convs and dense layers, frozen-BN bias and mean: not zero
    return (0.1 * rng.standard_normal(shape)).astype(np.float32)


def draw_variables(model, *args, seed=0, **kwargs):
    """Variables of a Flax model with every leaf drawn by numpy: FrozenBN
    constants and BatchNorm statistics away from 0/1 and non-zero biases,
    so the reference's quirks show. `args`/`kwargs` are what model.init
    takes after the rngs; shapes come from jax.eval_shape (no compile)."""
    shapes = jax.eval_shape(
        lambda: model.init({"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(0)},
                           *args, **kwargs))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _fill(tuple(k.key for k in p), s.shape, rng), shapes)


def jax_variables(model, seed=0, hw=IMG_HW):
    """draw_variables of a model that takes a (left, right) image pair."""
    x = jnp.zeros((1, *hw, 3))
    return draw_variables(model, x, x, seed=seed, train=False)
