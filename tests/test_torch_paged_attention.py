"""The port's plain ``paged_attention`` against the JAX package's oracle
(``ref.paged_attention_ref``) and its Pallas kernel in interpret mode, on
``tests/test_kernels.py``'s sweep shapes in bfloat16 and float32, with
ragged lengths, length 1, permuted page tables and inactive-slot rows.

Tolerances: float32 to 2e-5 (the sweep's own: a full softmax against an
online one, and two einsum orders); bfloat16 outputs within one bfloat16
ulp of JAX's, plus 2e-5 for the float32 accumulation order (both round one
float32 result to bfloat16, so they can land on neighbouring values).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention_pallas
from repro_torch.kernels import ops, ref

SWEEP = [(2, 2, 4, 64, 16, 32, 6), (1, 4, 1, 128, 8, 16, 4), (4, 1, 8, 32, 32, 64, 3)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(kind, b, hkv, g, d, page, pages_total, max_pages, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    kp = rng.standard_normal((pages_total, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((pages_total, page, hkv, d)).astype(np.float32)
    if kind == "sweep":  # as tests/test_kernels.py draws them
        table = rng.integers(0, pages_total, (b, max_pages)).astype(np.int32)
        lengths = rng.integers(1, max_pages * page, (b,)).astype(np.int32)
    else:
        # a permutation of the pool; ragged lengths with 1 and a full table
        # among them; the last row an inactive slot: page 0 everywhere,
        # length 1 (the serving engine's pos 0 + 1)
        table = rng.permutation(pages_total)[: b * max_pages].reshape(b, max_pages)
        table = table.astype(np.int32)
        lengths = rng.integers(1, max_pages * page + 1, (b,)).astype(np.int32)
        lengths[0] = 1
        if b > 2:
            lengths[1] = max_pages * page
        n_live = -(-lengths // page)
        table[np.arange(max_pages)[None, :] >= n_live[:, None]] = 0
        if b > 1:
            table[-1] = 0
            lengths[-1] = 1
    return q, kp, vp, table, lengths


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("kind", ["sweep", "edges"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SWEEP)
def test_plain_paged_attention_matches_jax(shape, dtype, kind):
    jdt, tdt = DTYPES[dtype]
    q, kp, vp, table, lengths = _inputs(kind, *shape, seed=shape[0] * 100 + shape[2])
    jargs = (jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt), table, lengths)
    want_ref = np.asarray(jref.paged_attention_ref(*jargs), np.float32)
    want_kernel = np.asarray(paged_attention_pallas(*jargs, interpret=True), np.float32)
    targs = [torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(tdt)
             for a in jargs[:3]] + [torch.from_numpy(table), torch.from_numpy(lengths)]
    got_t = ref.paged_attention_ref(*targs)
    assert got_t.dtype == tdt and tuple(got_t.shape) == q.shape
    got = got_t.float().numpy()
    for want in (want_ref, want_kernel):
        err = np.abs(got - want)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        else:
            assert (err <= _bf16_ulp(want) + 2e-5).all(), err.max()


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing():
    q, kp, vp, table, lengths = (torch.from_numpy(a) for a in _inputs("edges", *SWEEP[0], seed=3))
    ops.reset_launches()
    got = ops.paged_attention(q, kp, vp, table, lengths)
    assert torch.equal(got, ref.paged_attention_ref(q, kp, vp, table, lengths))
    assert ops.LAUNCHES["paged_attention"] == 0


def test_plain_paged_attention_equals_dense_decode_attention():
    """Pages that tile a dense cache give the port's contiguous
    ``decode_attention`` (tests/test_kernels.py's check, on the port)."""
    from repro_torch.models.attention import decode_attention

    rng = np.random.default_rng(1)
    b, hq, hkv, d, page, s = 2, 8, 2, 32, 16, 64
    q = torch.from_numpy(rng.standard_normal((b, 1, hq, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s, hkv, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, s, hkv, d)).astype(np.float32))
    lengths = torch.tensor([40, 64], dtype=torch.int32)
    dense = decode_attention(q, k, v, lengths)
    n = s // page
    table = torch.arange(b * n, dtype=torch.int32).reshape(b, n)
    paged = ref.paged_attention_ref(q[:, 0].reshape(b, hkv, hq // hkv, d),
                                    k.reshape(b * n, page, hkv, d),
                                    v.reshape(b * n, page, hkv, d), table, lengths)
    torch.testing.assert_close(paged.reshape(b, 1, hq, d), dense, rtol=2e-5, atol=2e-5)
