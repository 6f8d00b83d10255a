"""The argmax of the FPS kernel (csrc/fps.cu) on the CPU:
`furthest_point_sample_keys_plain` takes each step's winner per warp's
slice of the points by the running minimum's float bits read as an int,
then across slices by packed keys (bits << 32) | (0xffffffff - index), as
the kernel's block route (128 threads, 4 slices) and warp route (one slice)
do. Held to the JAX package's selection (`points._fps_single` and the
Pallas kernel in interpret mode) and to the plain version, exactly, on
tie-heavy clouds: coincident points, one all-coincident cloud, N not a
multiple of the thread count, npoint = N and N = 1. A property test holds
the int order of the bits to the float order over the values a running
minimum takes (0, subnormals, normals up to the 1e10 start) and the
padding's negative sentinel, and the packed keys to (largest distance,
lowest index).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from disprcnn_tpu.ops import points as jpoints
from disprcnn_tpu.ops.pallas.fps import furthest_point_sample_pallas
from disprcnn_tpu_torch.ops.cuda import fps as tfps

SENTINEL = -1.0  # the padded slots' running minimum in csrc/fps.cu


def tie_cloud(seed, b, n):
    """Seeded clouds with coincident points (exact distance ties), a far
    outlier, and a last cloud whose points all coincide."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, n, 3)) * 1.5).astype(np.float32)
    if n > 9:
        x[:, 5] = x[:, 2]
        x[:, 9] = x[:, 2]
        x[:, n - 1] = x[:, 7]
        x[:, 3] = 40.0
    x[-1] = 0.7
    return x


# (B, N, npoint, threads): threads 128 is the block route, 32 the warp route
CASES = [(3, 64, 16, 128), (3, 300, 300, 128), (2, 1, 1, 128), (2, 513, 40, 128),
         (2, 200, 60, 256), (3, 100, 50, 32), (2, 40, 40, 32), (2, 1, 1, 32), (3, 70, 69, 32)]


@pytest.mark.parametrize("b,n,npoint,threads", CASES)
def test_keys_match_jax(b, n, npoint, threads):
    xyz = tie_cloud(n + npoint, b, n)
    want = np.asarray(jax.vmap(lambda p: jpoints._fps_single(p, npoint))(jnp.asarray(xyz)))
    got = tfps.furthest_point_sample_keys_plain(torch.from_numpy(xyz), npoint, threads)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[-1] == 0).all()  # every step ties at 0: index 0


@pytest.mark.parametrize("b,n,npoint,threads", [(9, 48, 20, 128), (4, 300, 64, 128),
                                                (5, 33, 33, 32)])
def test_keys_match_pallas_interpret(b, n, npoint, threads):
    xyz = tie_cloud(b * n, b, n)
    want = np.asarray(furthest_point_sample_pallas(jnp.asarray(xyz), npoint, interpret=True))
    got = tfps.furthest_point_sample_keys_plain(torch.from_numpy(xyz), npoint, threads)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b,n,npoint,threads", CASES)
def test_keys_match_plain(b, n, npoint, threads):
    xyz = torch.from_numpy(tie_cloud(7 * n, b, n))
    assert torch.equal(tfps.furthest_point_sample_keys_plain(xyz, npoint, threads),
                       tfps.furthest_point_sample_plain(xyz, npoint))


def test_route_follows_the_cloud_count():
    """The RPN's 128 clouds take the block route, the RCNN's 2048 and 6400
    the warp route; the threshold is BLOCK_ROUTE_MAX_B's limit for N."""
    assert tfps.fps_route(128, 768) == tfps.fps_route(128, 512) == "block"
    assert tfps.fps_route(128, 256) == tfps.fps_route(128, 128) == "block"
    assert tfps.fps_route(2048, 512) == tfps.fps_route(2048, 128) == "warp"
    assert tfps.fps_route(6400, 512) == tfps.fps_route(6400, 128) == "warp"
    for n in (1, 128, 129, 256, 257, 512, 513, 768, 769, tfps.MAX_N):
        limit = next(lim for n0, lim in tfps.BLOCK_ROUTE_MAX_B if n > n0)
        assert tfps.fps_route(limit, n) == "block"
        assert tfps.fps_route(limit + 1, n) == "warp"


def bits(x: float) -> int:
    return int(np.array([x], np.float32).view(np.int32)[0])


LARGEST_SUBNORMAL = float(np.float32(1.1754942e-38))
MINIMA = st.one_of(
    st.sampled_from([0.0, 1e10, 1e-45, LARGEST_SUBNORMAL, 1.1754944e-38, 3.4028235e38]),
    st.floats(min_value=0.0, max_value=1e10, allow_subnormal=True, width=32),
    st.floats(min_value=0.0, max_value=LARGEST_SUBNORMAL, allow_subnormal=True, width=32))
VALUES = st.one_of(MINIMA, st.just(SENTINEL))


@settings(max_examples=300, deadline=None, database=None)
@given(VALUES, VALUES)
def test_int_order_of_bits_is_float_order(a, b):
    a, b = float(np.float32(a)), float(np.float32(b))
    assert (bits(a) > bits(b)) == (a > b)
    assert (bits(a) == bits(b)) == (a == b)


def key(d: float, i: int) -> int:
    return (bits(d) << 32) | (0xFFFFFFFF - i)


@settings(max_examples=300, deadline=None, database=None)
@given(MINIMA, st.integers(0, 1023), MINIMA, st.integers(0, 1023))
def test_packed_key_orders_distance_then_lowest_index(d1, i1, d2, i2):
    d1, d2 = float(np.float32(d1)), float(np.float32(d2))
    first_wins = d1 > d2 or (d1 == d2 and i1 < i2)
    assert (key(d1, i1) > key(d2, i2)) == first_wins or (d1 == d2 and i1 == i2)
    assert key(d1, i1) > 0  # above a warp with no point, whose key is 0
