"""The port's hashing, cache state and set indexing against the JAX package."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import as_numpy, as_torch

from repro.core import cache_state as jcs
from repro.core import workload as jwl
from repro.utils import hashing as jh
from repro_torch.core import cache_state as tcs
from repro_torch.core import workload as twl
from repro_torch.utils import hashing as th


def _u32(rng, n):
    x = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 2**31, 2**32 - 1]
    return x


def test_splitmix32_bit_equal():
    x = _u32(np.random.default_rng(0), 100_000)
    want = np.asarray(jh.splitmix32(jnp.asarray(x)))
    got = as_numpy(th.splitmix32(as_torch(x)), like=want)
    np.testing.assert_array_equal(got, want)


def test_hash2_u32_bit_equal():
    rng = np.random.default_rng(1)
    a, b = _u32(rng, 100_000), _u32(rng, 100_000)
    want = np.asarray(jh.hash2_u32(jnp.asarray(a), jnp.asarray(b)))
    got = as_numpy(th.hash2_u32(as_torch(a), as_torch(b)), like=want)
    np.testing.assert_array_equal(got, want)


def test_payloads_and_key_hash_bit_equal():
    rng = np.random.default_rng(2)
    keys = _u32(rng, 4_000)
    ts = rng.integers(-1, 1_000, 4_000).astype(np.int32)
    kids = rng.integers(0, 4096, 4_000).astype(np.int32)
    np.testing.assert_array_equal(
        twl.payload_for(as_torch(keys), 8).numpy(),
        np.asarray(jwl.payload_for(jnp.asarray(keys), 8)),
    )
    np.testing.assert_array_equal(
        twl.versioned_payload(as_torch(keys), as_torch(ts), 8).numpy(),
        np.asarray(jwl.versioned_payload(jnp.asarray(keys), jnp.asarray(ts), 8)),
    )
    want = np.asarray(jwl.key_hash(jnp.asarray(kids)))
    np.testing.assert_array_equal(as_numpy(twl.key_hash(as_torch(kids)), like=want), want)


def test_empty_cache_matches():
    want = jcs.empty_cache(5, 4, 3, jnp.float32, batch=(2,))
    got = tcs.empty_cache(5, 4, 3, batch=(2,), device="cpu")
    for f in ("tags", "data_ts", "ins_ts", "origin", "valid", "dirty", "last_use", "data"):
        w = np.asarray(getattr(want, f))
        np.testing.assert_array_equal(as_numpy(getattr(got, f), like=w), w, err_msg=f)
    assert tcs.NULL_TAG == np.asarray(jcs.NULL_TAG).view(np.int32)


@pytest.mark.parametrize("sets", [1, 7, 50, 64])
def test_set_index_uses_unsigned_value(sets):
    keys = _u32(np.random.default_rng(3), 10_000)
    assert (keys >= 2**31).sum() > 1000
    want = np.asarray(jcs.set_index(sets, jnp.asarray(keys)))
    got = tcs.set_index(as_torch(keys), sets).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,k", [(16, 5), (10, 9), (1000, 32)])
def test_neighbor_tables_match(n, k):
    want = jwl.neighbor_table(n, k)
    np.testing.assert_array_equal(twl.neighbor_table(n, k, "cpu").numpy(), want)


@pytest.mark.parametrize("n,k", [(5, 0), (5, 5)])
def test_neighbor_table_rejects_degenerate_k(n, k):
    with pytest.raises(ValueError, match="neighbor_table needs 1 <= k <= n-1"):
        twl.neighbor_table(n, k, "cpu")


def test_hash_of_int32_pattern_equals_hash_of_uint32():
    x = _u32(np.random.default_rng(4), 1_000)
    as_i32 = torch.from_numpy(x.view(np.int32).copy())
    as_i64 = torch.from_numpy(x.astype(np.int64))
    assert torch.equal(th.splitmix32(as_i32), th.splitmix32(as_i64))
