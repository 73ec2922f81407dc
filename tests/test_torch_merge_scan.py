"""The plain versions of the ``ssd_scan`` and ``flic_merge`` kernels, and
their wrappers on CPU tensors, against the JAX package's oracles
(``repro.kernels.ref``) and its Pallas kernels in interpret mode, on inputs
made with numpy from a seed.

* ``ssd_scan``: rtol and atol 1e-5, JAX's own (``tests/test_kernels.py``).
  XLA on the CPU contracts the scan step into a fused multiply-add; the port
  rounds the product and then the sum, as its CUDA kernel does (held
  bitwise here against a numpy loop that rounds the same way).
* ``flic_merge``: bitwise; it only selects.

The CUDA kernels are held bitwise to these plain versions on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

SSD_TOL = dict(rtol=1e-5, atol=1e-5)
SSD_SHAPES = [(2, 5, 4, 8, 16), (1, 12, 2, 4, 8), (3, 3, 8, 16, 4)]   # test_kernels.py's


def _scan_inputs(rng, b, c, h, p, n, lo=0.0, hi=1.0):
    st = rng.standard_normal((b, c, h, p, n)).astype(np.float32)
    dec = rng.uniform(lo, hi, (b, c, h)).astype(np.float32)
    init = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return st, dec, init


def _numpy_scan(st, dec, init):
    """The recurrence in numpy float32, the product rounded before the sum."""
    carry = np.zeros(st[:, 0].shape, np.float32) if init is None else init.copy()
    prev = np.empty_like(st)
    for c in range(st.shape[1]):
        prev[:, c] = carry
        carry = (dec[:, c, :, None, None] * carry).astype(np.float32) + st[:, c]
    return prev, carry


@pytest.mark.parametrize("with_init", [True, False])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_scan_ref_matches_jax_and_interpret_kernel(shape, with_init):
    rng = np.random.default_rng(shape[1] * 10 + shape[2])
    st, dec, init = _scan_inputs(rng, *shape)
    init = init if with_init else None
    t = [None if a is None else torch.from_numpy(a) for a in (st, dec, init)]
    prev, final = ref.ssd_scan_ref(*t)
    assert prev.dtype == final.dtype == torch.float32
    assert prev.shape == shape and final.shape == (shape[0], *shape[2:])
    jinit = None if init is None else jnp.asarray(init)
    for want in (jref.ssd_scan_ref(jnp.asarray(st), jnp.asarray(dec), jinit),
                 jops.ssd_scan(st, dec, init, backend="interpret")):
        np.testing.assert_allclose(prev.numpy(), np.asarray(want[0]), **SSD_TOL)
        np.testing.assert_allclose(final.numpy(), np.asarray(want[1]), **SSD_TOL)
    # the wrapper on CPU tensors is the plain version
    wprev, wfinal = ops.ssd_scan(*t)
    assert torch.equal(wprev, prev) and torch.equal(wfinal, final)


@pytest.mark.parametrize("case", ["uniform", "long_memory", "zero_decay"])
def test_ssd_scan_ref_rounds_product_then_sum(case):
    """Bitwise against numpy float32 on the cases the card runs: decay
    uniform in (0, 1); decay in [0.95, 1) over 128 chunks, where error
    accumulates; decay 0 (the served model's, where prev[c] = states[c-1]);
    each with a non-zero init.  Within JAX's tolerance of JAX's oracle."""
    rng = np.random.default_rng(7)
    shape = {"uniform": (2, 8, 4, 8, 16), "long_memory": (1, 128, 2, 4, 8),
             "zero_decay": (2, 8, 4, 8, 16)}[case]
    lo, hi = (0.95, 1.0) if case == "long_memory" else (0.0, 1.0)
    st, dec, init = _scan_inputs(rng, *shape, lo=lo, hi=hi)
    if case == "zero_decay":
        dec[:] = 0.0
    prev, final = ref.ssd_scan_ref(*map(torch.from_numpy, (st, dec, init)))
    want_prev, want_final = _numpy_scan(st, dec, init)
    np.testing.assert_array_equal(prev.numpy(), want_prev)
    np.testing.assert_array_equal(final.numpy(), want_final)
    if case == "zero_decay":
        np.testing.assert_array_equal(prev.numpy()[:, 1:], st[:, :-1])
    jprev, jfinal = jref.ssd_scan_ref(jnp.asarray(st), jnp.asarray(dec), jnp.asarray(init))
    np.testing.assert_allclose(prev.numpy(), np.asarray(jprev), **SSD_TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), **SSD_TOL)


def _mk_cache(rng, s, w, d):
    tags = rng.integers(0, 2**31 - 1, (s, w)).astype(np.int32)
    ts = rng.integers(0, 10_000, (s, w)).astype(np.int32)
    valid = rng.random((s, w)) < 0.7
    data = rng.standard_normal((s, w, d)).astype(np.float32)
    return [tags, ts, valid, data]


def _merge_inputs(rng, s, w, d):
    """Two replicas with forced ties, lines invalid in both, and lines
    where B is newer but invalid."""
    a, b = _mk_cache(rng, s, w, d), _mk_cache(rng, s, w, d)
    tie = rng.random((s, w)) < 0.2
    b[1][tie] = a[1][tie]
    both_invalid = rng.random((s, w)) < 0.1
    a[2][both_invalid] = b[2][both_invalid] = False
    b_newer_invalid = rng.random((s, w)) < 0.1
    b[1][b_newer_invalid] = a[1][b_newer_invalid] + 1
    b[2][b_newer_invalid] = False
    return a, b


def _assert_merge_equal(got, want):
    names = ("tags", "ts", "valid", "data")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        g = g.numpy()
        assert g.dtype == w.dtype, name
        if name == "data":   # bit patterns: a select never rounds
            g, w = g.view(np.uint32), w.view(np.uint32)
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("s,w,d", [(256, 4, 8), (512, 2, 4), (256, 8, 16)])   # test_kernels.py's
def test_flic_merge_ref_equals_jax_and_interpret_kernel(s, w, d):
    a, b = _merge_inputs(np.random.default_rng(s + w + d), s, w, d)
    got = ref.flic_merge_ref(*map(torch.from_numpy, a + b))
    _assert_merge_equal(got, jref.flic_merge_ref(*map(jnp.asarray, a + b)))
    _assert_merge_equal(got, jops.flic_merge(*a, *b, backend="interpret"))
    _assert_merge_equal(ops.flic_merge(*map(torch.from_numpy, a + b)), [t.numpy() for t in got])


def test_flic_merge_any_set_count():
    """S = 50,000 (the dense cell's N*S flattened), which JAX's kernel
    wrapper refuses (S % 256): against JAX's oracle."""
    a, b = _merge_inputs(np.random.default_rng(1), 50_000, 4, 8)
    got = ops.flic_merge(*map(torch.from_numpy, a + b))
    _assert_merge_equal(got, jref.flic_merge_ref(*map(jnp.asarray, a + b)))


def test_flic_merge_rule():
    """Ties keep A; an invalid B never wins, however new; two invalid lines
    give A's fields, invalid; a valid B wins over an invalid A."""
    tags_a, tags_b = torch.tensor([[1, 2, 3, 4, 5]]), torch.tensor([[11, 12, 13, 14, 15]])
    ts_a, ts_b = torch.tensor([[5, 5, 5, 5, 5]]), torch.tensor([[5, 9, 9, 1, 6]])
    va = torch.tensor([[True, True, False, False, True]])
    vb = torch.tensor([[True, False, False, True, True]])
    data_a, data_b = torch.zeros(1, 5, 2), torch.ones(1, 5, 2)
    tags, ts, valid, data = ops.flic_merge(
        tags_a.int(), ts_a.int(), va, data_a, tags_b.int(), ts_b.int(), vb, data_b)
    assert tags.tolist() == [[1, 2, 3, 14, 15]]
    assert ts.tolist() == [[5, 5, 5, 1, 6]]
    assert valid.tolist() == [[True, True, False, True, True]]
    assert data[..., 0].tolist() == [[0.0, 0.0, 0.0, 1.0, 1.0]]


def test_wrappers_refuse_other_devices():
    meta = torch.empty((1, 2, 1, 2, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.ssd_scan(meta, torch.empty((1, 2, 1), device="meta"))
    t = torch.empty((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flic_merge(t, t, t.bool(), t.float()[..., None], t, t, t.bool(), t.float()[..., None])


# The instantiation of the flic_merge kernel (ops.merge_plan): 16-byte
# accesses at compile-time W only on aligned tables with D % 4 == 0.

MERGE_PLANS = {
    "w4_d8_aligned": ((4, 8, True), ops.MergePlan(4, True)),
    "w4_d8_offset": ((4, 8, False), ops.MergePlan(0, False)),
    "w4_d6_aligned": ((4, 6, True), ops.MergePlan(0, False)),
    "w3_d8_aligned": ((3, 8, True), ops.MergePlan(0, False)),
    "w1_d4_aligned": ((1, 4, True), ops.MergePlan(1, True)),
    "w2_d16_aligned": ((2, 16, True), ops.MergePlan(2, True)),
    "w8_d8_aligned": ((8, 8, True), ops.MergePlan(8, True)),
    "w8_d3_aligned": ((8, 3, True), ops.MergePlan(0, False)),
}


def _offset(t, aligned):
    """``t`` itself, or a contiguous copy 4 bytes past a 16-byte boundary."""
    if aligned:
        return t
    skip = 4 // t.element_size()
    buf = torch.zeros(t.numel() + skip, dtype=t.dtype)
    view = buf[skip:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("case", list(MERGE_PLANS))
def test_merge_plan_picks_the_instantiation(case):
    (w, d, aligned), want = MERGE_PLANS[case]
    assert ops.merge_plan(w, d, aligned) == want
    assert want in ops.merge_plans()
    a, b = _merge_inputs(np.random.default_rng(w * 10 + d), 40, w, d)
    args = [_offset(torch.from_numpy(x), aligned) for x in a + b]
    assert all(t.data_ptr() % 16 == 0 for t in args) == aligned
    assert ops.merge_plan_for(*args) == want
    # one table off a boundary is enough to take the line-by-line path
    for i in range(8):
        mixed = list(args)
        mixed[i] = _offset(torch.from_numpy((a + b)[i]), False)
        assert ops.merge_plan_for(*mixed) == ops.MergePlan(0, False)
    # the wrapper on CPU tensors gives the plain result whatever the plan
    _assert_merge_equal(ops.flic_merge(*args), [t.numpy() for t in ref.flic_merge_ref(*args)])


def test_merge_plans_stay_within_the_instantiations():
    plans = set(ops.merge_plans())
    assert len(plans) == 5
    for w in range(1, 41):
        for d in range(0, 17):
            for aligned in (False, True):
                plan = ops.merge_plan(w, d, aligned)
                assert plan in plans
                assert plan.vec == (aligned and d % 4 == 0 and w in ops.TEMPLATE_WAYS)


@pytest.mark.parametrize("n_sets,blocks", [(1, 1), (0, 1), (16, 1), (17, 2), (50_000, 3125),
                                           (100_000, 3168), (10**8, 3168)])
def test_merge_grid_follows_the_sm_count(n_sets, blocks):
    """One-warp blocks of 16 sets, at most 24 an SM of an H100."""
    assert ops.merge_blocks(n_sets, 132) == blocks
