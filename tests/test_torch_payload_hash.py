"""The payload hash (``kernels/ops.py::payload_hash``), the one kernel of the
port's fog tick that replaces no Pallas kernel.

On the CPU the wrapper returns the plain version (``ref.payload_hash_ref``):
it is held bit for bit against the numpy hash of ``core/workload.py``, and
``payload_for`` / ``versioned_payload`` against digests of what they
returned before the kernel existed.  The tests marked ``card`` hold the CUDA
kernel bit for bit against the plain version on the card and skip without
one; run them there with ``python -m pytest -q -m card
tests/test_torch_payload_hash.py``.  No JAX here: the file runs on the card.
"""
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.core import workload as wl
from repro_torch.kernels import ops, ref

EDGE_KEYS = [0, 1, 0x7FFFFFFF, -1, -(2**31)]
EDGE_TS = [0, 2**31 - 1]
DIMS = (1, 3, 8, 16)
MODES = ("unversioned", "versioned")


def _rows(m: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``m`` int32 keys and timestamps: the edge cases first, then random."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(-(2**31), 2**31, m, dtype=np.int64).astype(np.int32)
    ts = rng.integers(0, 2**31, m, dtype=np.int64).astype(np.int32)
    n = min(m, len(EDGE_KEYS) * len(EDGE_TS))
    keys[:n] = np.repeat(EDGE_KEYS, len(EDGE_TS))[:n]
    ts[:n] = np.tile(EDGE_TS, len(EDGE_KEYS))[:n]
    return keys, ts


def _numpy_payload(keys: np.ndarray, ts, dim: int) -> np.ndarray:
    a = keys.view(np.uint32)
    if ts is not None:
        a = wl._hash2_np(a, ts.view(np.uint32))
    lanes = wl._hash2_np(a[:, None], np.arange(dim, dtype=np.uint32))
    return lanes.astype(np.float32) / np.float32(2**32)


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    return (got.shape == want.shape and got.dtype == want.dtype == torch.float32
            and torch.equal(got.cpu().view(torch.int32), want.cpu().view(torch.int32)))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dim", DIMS)
def test_payload_hash_on_cpu_matches_numpy_hash(dim, mode):
    keys, ts = _rows(2_000, seed=dim)
    ts = ts if mode == "versioned" else None
    got = ops.payload_hash(torch.from_numpy(keys),
                           None if ts is None else torch.from_numpy(ts), dim)
    assert _same_bits(got, torch.from_numpy(_numpy_payload(keys, ts, dim)))
    assert set(ops.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("mode", MODES)
def test_payload_hash_on_cpu_of_no_rows(mode):
    key = torch.zeros((0,), dtype=torch.int32)
    got = ops.payload_hash(key, key if mode == "versioned" else None, 8)
    assert got.shape == (0, 8) and got.dtype == torch.float32


# sha256 of the payloads that payload_for / versioned_payload returned before
# they went through ops.payload_hash (the int64 tensor ops of
# utils/hashing.py), on _digest_rows' inputs.
DIGESTS = {
    "payload_for_d8": "3ba55d4ceb8183620c6f9395b417700be30604448de3c90bd3ec04660eac036a",
    "payload_for_d3": "972a0fbb64d8998155959a28020414790b9a1dea1c825e90d6c57268fcab5ec0",
    "versioned_d8": "2e8378e94d5bef7bc524bb84390aba050f11930439c1a7af24703a7b0bb368fa",
    "versioned_d16_2d": "dd956e79383252f6387ce306de89a2edf134f96ca26ec478aa83a0c5af10a53f",
    "payload_for_i64": "3ba55d4ceb8183620c6f9395b417700be30604448de3c90bd3ec04660eac036a",
}


def _digest_rows():
    rng = np.random.default_rng(27)
    keys = rng.integers(-(2**31), 2**31, 1000, dtype=np.int64).astype(np.int32)
    keys[:5] = EDGE_KEYS
    ts = rng.integers(0, 2**31, 1000, dtype=np.int64).astype(np.int32)
    ts[:2] = EDGE_TS
    return torch.from_numpy(keys), torch.from_numpy(ts)


def _digest_case(name: str, device) -> torch.Tensor:
    k, t = (x.to(device) for x in _digest_rows())
    return {
        "payload_for_d8": lambda: wl.payload_for(k, 8),
        "payload_for_d3": lambda: wl.payload_for(k, 3),
        "versioned_d8": lambda: wl.versioned_payload(k, t, 8),
        "versioned_d16_2d": lambda: wl.versioned_payload(k.view(10, 100), t.view(10, 100), 16),
        # int64 keys: only the low 32 bits count
        "payload_for_i64": lambda: wl.payload_for(k.to(torch.int64) + (3 << 32), 8),
    }[name]()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_workload_payloads_unchanged(name):
    out = _digest_case(name, "cpu")
    assert out.dtype == torch.float32
    assert hashlib.sha256(out.numpy().tobytes()).hexdigest() == DIGESTS[name]


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    ops.reset_launches()
    return torch.device("cuda")


def _on_card(cuda, m: int, dim: int, mode: str, seed: int):
    """Kernel and plain version (on the card and on the CPU) of ``m`` rows."""
    keys, ts = _rows(m, seed)
    k = torch.from_numpy(keys)
    t = torch.from_numpy(ts) if mode == "versioned" else None
    got = ops.payload_hash(k.to(cuda), None if t is None else t.to(cuda), dim)
    torch.cuda.synchronize()
    plain = ref.payload_hash_ref(k.to(cuda), None if t is None else t.to(cuda), dim)
    return got, plain, ref.payload_hash_ref(k, t, dim)


@pytest.mark.card
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dim", DIMS)
def test_kernel_matches_plain_on_edge_cases(cuda, dim, mode):
    got, plain, cpu = _on_card(cuda, 300, dim, mode, seed=dim)
    assert got.device.type == "cuda"
    assert _same_bits(got, plain) and _same_bits(got, cpu)
    assert ops.LAUNCHES["payload_hash"] == 1


@pytest.mark.card
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m", (10_000, 667, 0))
def test_kernel_matches_plain_at_the_ticks_shapes(cuda, m, mode):
    got, plain, cpu = _on_card(cuda, m, 8, mode, seed=m)
    assert got.shape == (m, 8)
    assert _same_bits(got, plain) and _same_bits(got, cpu)


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_workload_payloads_on_the_card(cuda, name):
    out = _digest_case(name, cuda)
    torch.cuda.synchronize()
    assert out.device.type == "cuda" and ops.LAUNCHES["payload_hash"] == 1
    assert hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest() == DIGESTS[name]


@pytest.mark.card
def test_one_call_is_one_launch(cuda):
    k = torch.arange(10_000, dtype=torch.int32, device=cuda)
    for n in (1, 2):
        ops.payload_hash(k, k if n == 2 else None, 8)
        assert ops.LAUNCHES["payload_hash"] == n
        assert sum(ops.LAUNCHES.values()) == n
    with pytest.raises(ValueError, match="data_ts has shape"):
        ops.payload_hash(k, k[:-1], 8)
