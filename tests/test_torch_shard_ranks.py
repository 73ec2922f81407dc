"""The plans on real ranks: one spawned group of 4 gloo ranks on the CPU, a
(2, 2) ``("data", "model")`` mesh, runs the committed JAX training
fixtures in float32 under a plan (parameters, moments and batches as
DTensors; the MoE dispatch, the attention and the Mamba2 chunk scan under
``local_map``), and a decode step of Granite's smoke config under each
decode plan (``tests/torch_shard_ranks.py``).

* Against JAX's run (the fixture): the losses of every step and step 0's
  gradient norm within ``train/replay.py::train_tol(family, "float32")``.
* Against the port's unsharded run of the same case: step 0's loss,
  gradient norm and tracked gradients within ``UNSHARDED_TOL`` of the
  leaf's largest value.  Split contractions and all-reduces add in another
  order (measured: at most 2.2e-5).
* Two microbatches of a batch with an uneven ``loss_mask``: the loss and
  every gradient leaf within ``UNSHARDED_TOL`` of the unsharded run (a
  DTensor batch splits into the same contiguous rows as a plain one).
* Decode: logits and every cache tensor within ``UNSHARDED_TOL`` of the
  unsharded step (measured: at most 8e-7), the int8 rows exactly.
* The chunk scan's kernel entries on DTensors: bitwise equal to whole
  calls.
"""
import numpy as np
import pytest
import torch_threads  # noqa: F401  (sizes this worker's torch thread pool)
from torch_shard_ranks import max_rel, run_ranks

from repro_torch.config import get_smoke_arch
from repro_torch.train.replay import TRACKED, compare_train_case, train_tol

TRAIN_JOBS = [("train", "granite_8b", "train"), ("train", "granite_8b", "train_zero3"),
              ("train", "granite_8b", "train_kvrep"),
              ("train", "deepseek_v2_lite_16b", "train_ep"),
              ("train", "mamba2_370m", "train"), ("train", "seamless_m4t_medium", "train")]
MICROBATCH_JOBS = [("microbatch", "deepseek_v2_lite_16b", "train_ep"),
                   ("microbatch", "granite_8b", "train")]
DECODE_JOBS = [("decode", "decode"), ("decode", "decode_stationary"),
               ("decode", "decode_stationary_int8")]
SCAN_JOBS = [("scan", "train"), ("scan", "train_zero3")]
UNSHARDED_TOL = 1e-4
GROUP_TIMEOUT = 600


@pytest.fixture(scope="module")
def results():
    jobs = TRAIN_JOBS + MICROBATCH_JOBS + DECODE_JOBS + SCAN_JOBS
    return dict(zip(jobs, run_ranks(jobs, world=4, timeout=GROUP_TIMEOUT)))


def _fixture(arch):
    import os

    from torch_shard_ranks import TESTDATA

    from repro_torch.models.replay import load_model_replay

    return load_model_replay(os.path.join(TESTDATA, f"train_{arch}_smoke.npz"))


@pytest.mark.parametrize("job", TRAIN_JOBS, ids=lambda j: f"{j[1]}-{j[2]}")
def test_sharded_training_holds_jax_fixture(results, job):
    _, arch, plan = job
    cfg, _, cases = _fixture(arch)
    want = cases["float32"]
    got = results[job]["sharded"]
    tol = train_tol(cfg.family, "float32")
    res = compare_train_case(want, got)
    assert res["lr_rel"] <= tol["lr_rel"] and res["grad_norm_rel"] <= tol["grad_norm_rel"], res
    assert res["loss_rel"] <= tol["loss_rel"], (plan, res)


@pytest.mark.parametrize("job", TRAIN_JOBS, ids=lambda j: f"{j[1]}-{j[2]}")
def test_sharded_training_step0_matches_unsharded(results, job):
    _, arch, _ = job
    got, plain = results[job]["sharded"], results[job]["plain"]
    fields = ["grad/" + k for k in TRACKED[get_smoke_arch(arch).family]]
    for k in fields:
        assert max_rel(got[k], plain[k]) <= UNSHARDED_TOL, k
    for k in ("loss", "grad_norm"):
        assert max_rel(got[k][:1], plain[k][:1]) <= UNSHARDED_TOL, k


@pytest.mark.parametrize("job", MICROBATCH_JOBS, ids=lambda j: f"{j[1]}-{j[2]}")
def test_sharded_microbatches_match_unsharded(results, job):
    """A plan's microbatches are JAX's contiguous rows: DeepSeek's
    load-balance term (a product of means over a microbatch) and the masked
    CE (a ratio of sums) come out as the unsharded step's."""
    got, plain = results[job]["sharded"], results[job]["plain"]
    assert sorted(got) == sorted(plain) and len(got) > 10
    for k, want in plain.items():
        assert max_rel(got[k], want) <= UNSHARDED_TOL, k


@pytest.mark.parametrize("job", DECODE_JOBS, ids=lambda j: j[1])
def test_sharded_decode_matches_unsharded(results, job):
    got, plain = results[job]["sharded"], results[job]["plain"]
    assert sorted(got) == sorted(plain) and "logits" in got
    for k, want in plain.items():
        if want.dtype == np.int8 or "int8" in job[1] and k.endswith(("/k", "/v")):
            np.testing.assert_array_equal(got[k], want, err_msg=k)
        else:
            assert max_rel(got[k], want) <= UNSHARDED_TOL, k


@pytest.mark.parametrize("job", SCAN_JOBS, ids=lambda j: j[1])
def test_scan_entries_on_dtensors_equal_whole_calls(results, job):
    """``ops.ssd_scan``/``ssd_scan_bwd`` given DTensors run under their
    ``local_map`` on each rank's rows and heads (split on both mesh dims
    under ``train``, rows over all four ranks under ``train_zero3``): the
    scan is independent per row and head, so bitwise equal to whole calls
    (``g_decay``'s sums run over (P, N), which no rank splits)."""
    res = results[job]
    assert res["placements"][0] == (("S(0)", "S(2)") if job[1] == "train" else ("S(0)", "S(0)"))
    for got, want in zip(res["sharded"], res["plain"]):
        np.testing.assert_array_equal(got, want)
