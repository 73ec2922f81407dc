"""The port's plain ``paged_attention`` against the JAX package's oracle
(``ref.paged_attention_ref``) and its Pallas kernel in interpret mode, on
``tests/test_kernels.py``'s sweep shapes in bfloat16 and float32, with
ragged lengths, length 1, permuted page tables and inactive-slot rows.

Also the unit of the kernel's K/V row copies (``ops.paged_row_plan``),
the kernel's split over the KV length: ``ops.paged_split_plan``
covers every page slot once and fills the card, and the rule by which the
kernel merges the splits' partial softmax states, written here in plain
torch, gives the plain version's result.

Tolerances: float32 to 2e-5 (the sweep's own: a full softmax against an
online one, and two einsum orders); bfloat16 outputs within one bfloat16
ulp of JAX's, plus 2e-5 for the float32 accumulation order (both round one
float32 result to bfloat16, so they can land on neighbouring values).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (sizes this worker's torch thread pool)

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention_pallas
from repro_torch.kernels import ops, ref

# (B, Hkv, G, D, page, pool pages, page slots): tests/test_kernels.py's sweep,
# then K/V rows that are not 16-byte multiples in bfloat16: D = 12 at the
# Granite-3 smoke model's Hkv, G and page, and an odd D = 13.
SWEEP = [(2, 2, 4, 64, 16, 32, 6), (1, 4, 1, 128, 8, 16, 4), (4, 1, 8, 32, 32, 64, 3),
         (3, 2, 2, 12, 8, 24, 5), (2, 2, 3, 13, 16, 20, 4)]
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


# The kernel's split over the KV length (ops.paged_split_plan) and the rule
# by which it merges the splits, written here in plain torch.

PLAN_SHAPES = [(4, 8, 35), (16, 8, 2048), (6, 8, 35), (1, 1, 1), (2, 1, 4096), (128, 8, 2048),
               (1, 8, 100_000), (3, 2, 7), (65_535, 1, 3)]


@pytest.mark.parametrize("n_sms", [1, 7, 132])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_split_plan_covers_every_slot_once(shape, n_sms):
    b, hkv, max_pages = shape
    splits, per = ops.paged_split_plan(b, hkv, max_pages, n_sms)
    assert 1 <= per <= ops.SPLIT_MAX_PAGES and 1 <= splits <= max_pages
    covered = np.zeros(max_pages, dtype=int)
    for s in range(splits):
        lo, hi = s * per, min((s + 1) * per, max_pages)
        assert lo < hi, f"split {s} is empty"
        covered[lo:hi] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("shape", [(4, 8, 35), (16, 8, 2048)], ids=["serve_step", "long_context"])
def test_split_plan_fills_the_card(shape):
    """The serve step's and the long context's shapes make at least two
    blocks per SM of an H100 (132 SMs)."""
    b, hkv, max_pages = shape
    splits, _ = ops.paged_split_plan(b, hkv, max_pages, 132)
    assert b * hkv * splits >= 2 * 132


@pytest.mark.parametrize("n_sms", [1, 132])
def test_split_plan_one_page_slot_is_one_split(n_sms):
    assert ops.paged_split_plan(4, 8, 1, n_sms) == (1, 1)


def _split_and_combine(q, kp, vp, table, lengths, splits, per):
    """The kernel's rule: each split's live page slots give a partial
    softmax state (m, l, acc) in float32; a split past the live slots gives
    none; the partials merge in split order."""
    b, hkv, g, d = q.shape
    page, max_pages = kp.shape[1], table.shape[1]
    out = torch.empty((b, hkv, g, d), dtype=torch.float32)
    for bi in range(b):
        n = int(lengths[bi])
        live = min(-(-n // page), max_pages) if n > 0 else max_pages
        parts = []
        for s in range(splits):
            lo, hi = s * per, min((s + 1) * per, live)
            if lo >= hi:
                continue
            ids = table[bi, lo:hi].long()
            k = kp[ids].reshape(-1, hkv, d).float()
            v = vp[ids].reshape(-1, hkv, d).float()
            sc = torch.einsum("hgd,khd->hgk", q[bi].float(), k) * ref.inv_sqrt(d)
            sc = torch.where(torch.arange(lo * page, hi * page) < n, sc, -1e30)
            m = sc.amax(-1)
            p = torch.exp(sc - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("hgk,khd->hgd", p, v)))
        mx = torch.stack([m for m, _, _ in parts]).amax(0)
        acc = torch.zeros((hkv, g, d))
        tot = torch.zeros((hkv, g))
        for m, l, a in parts:
            w = torch.exp(m - mx)
            tot = tot + w * l
            acc = acc + w[..., None] * a
        out[bi] = acc / tot.clamp(min=1e-37)[..., None]
    return out.to(q.dtype)


@pytest.mark.parametrize("per", [1, 2, "plan"])
@pytest.mark.parametrize("kind", ["ragged", "zero"])
@pytest.mark.parametrize("shape", SWEEP)
def test_split_and_combine_matches_plain(shape, kind, per):
    """On the sweep's shapes: ragged lengths (1, a full table, an inactive
    slot), or a length 0 (every slot masked: a uniform softmax over all
    max_pages * page slots, an equal share from every split) beside one
    that ends inside a page; splits of 1 and 2 page slots and the kernel's
    own plan; float32, to the sweep's 2e-5."""
    b, hkv, g, d, page, pages_total, max_pages = shape
    q, kp, vp, table, lengths = (torch.from_numpy(a) for a in _inputs(
        "edges", *shape, seed=7 * shape[0] + shape[3]))
    if kind == "zero":
        if b > 1:
            lengths[-1] = max(1, max_pages * page // 2 - 3)
        lengths[0] = 0
    if per == "plan":
        splits, per = ops.paged_split_plan(b, hkv, max_pages, 132)
    else:
        splits = -(-max_pages // per)
    got = _split_and_combine(q, kp, vp, table, lengths, splits, per)
    want = ref.paged_attention_ref(q, kp, vp, table, lengths)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


# The unit of the kernel's K/V row copies (ops.paged_row_plan): the widest
# of 16, 8, 4 and 2 bytes that divides the row and the pages' alignment.

ROW_UNITS = {   # (D, bytes of a value) -> unit at 16-, 8- and 4-byte alignment
    (12, 2): (8, 8, 4), (13, 2): (2, 2, 2), (16, 2): (16, 8, 4), (20, 2): (8, 8, 4),
    (64, 2): (16, 8, 4), (128, 2): (16, 8, 4), (256, 2): (16, 8, 4),
    (12, 4): (16, 8, 4), (13, 4): (4, 4, 4), (16, 4): (16, 8, 4), (20, 4): (16, 8, 4),
    (64, 4): (16, 8, 4), (128, 4): (16, 8, 4),
}


@pytest.mark.parametrize("align", [16, 8, 4])
@pytest.mark.parametrize("d,itemsize", sorted(ROW_UNITS))
def test_row_plan_takes_the_widest_unit(d, itemsize, align):
    unit = ops.paged_row_plan(d, itemsize, align)
    assert unit == ROW_UNITS[d, itemsize][(16, 8, 4).index(align)]
    assert (d * itemsize) % unit == 0 and align % unit == 0


@pytest.mark.parametrize("d,itemsize", [(257, 2), (129, 4), (256, 4), (0, 2)])
def test_row_plan_refuses_rows_past_512_bytes(d, itemsize):
    with pytest.raises(ValueError, match="K/V rows"):
        ops.paged_row_plan(d, itemsize, 16)


@pytest.mark.parametrize("offset", [0, 2, 4, 8])
def test_row_plan_for_reads_the_pages_alignment(offset):
    """The wrapper's plan follows the pages' addresses: a view ``offset``
    bytes past a 16-byte boundary takes the unit that offset allows."""
    d, page, hkv = 12, 8, 2
    q = torch.zeros((1, hkv, 2, d), dtype=torch.bfloat16)
    base = torch.zeros(4 * page * hkv * d + 8, dtype=torch.bfloat16)
    assert base.data_ptr() % 16 == 0
    kv = base[offset // 2: offset // 2 + 4 * page * hkv * d].view(4, page, hkv, d)
    table, lengths = torch.zeros((1, 2), dtype=torch.int32), torch.ones(1, dtype=torch.int32)
    want = {0: 8, 2: 2, 4: 4, 8: 8}[offset]
    assert ops.paged_row_plan_for(q, kv, kv, table, lengths) == want
    aligned = torch.zeros((4, page, hkv, d), dtype=torch.bfloat16)
    assert ops.paged_row_plan_for(q, aligned, kv, table, lengths) == want


# The kernel's arrival counters: one buffer for each (device, stream).

def test_arrival_counters_are_kept_per_stream(monkeypatch):
    """Stream keys stand in for CUDA stream handles (no stream exists on
    the CPU): one key, one buffer, grown in place of the old; two keys, two
    buffers; each zero when made."""
    monkeypatch.setattr(ops, "_ARRIVALS", {})
    cpu = torch.device("cpu")
    a = ops._arrivals(cpu, 11, 10)
    assert a is ops._arrivals(cpu, 11, 100) and a.numel() >= 100
    b = ops._arrivals(cpu, 22, 10)
    assert b is not a and b.data_ptr() != a.data_ptr()
    assert int(a.abs().sum()) == int(b.abs().sum()) == 0
    big = ops._arrivals(cpu, 11, 10_000)
    assert big is not a and big.numel() >= 10_000 and ops._arrivals(cpu, 11, 5) is big
    assert ops._arrivals(cpu, 22, 5) is b
    assert set(ops._ARRIVALS) == {(0, 11), (0, 22)}
