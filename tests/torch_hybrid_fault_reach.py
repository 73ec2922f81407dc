"""Which bfloat16 faults the whole-chain checks of the hybrid family see.

Plants one fault at a time in every bfloat16 block of one kind of Jamba's
smoke period (the residual branch scaled by a factor, or the gradient of
the block's output negated), replays the committed model and training
fixtures on the CPU, and prints one JSON line per fault: the
``compare_model_case`` and ``compare_train_case`` readings and whether
``HYBRID_TOL`` and the hybrid ``train_tol`` pass.  A factor of 1.0 is no
fault but one more bfloat16 rounding of each block's output (x + (y - x)):
it shows the chain's own noise.  Not collected by pytest; run with

    PYTHONPATH=src:tests python tests/torch_hybrid_fault_reach.py
"""
import json

import torch
from torch_parity import MODEL_FIXTURES, TRAIN_FIXTURES

from repro_torch.models import stack as tstack
from repro_torch.models.replay import (
    HYBRID_TOL,
    compare_model_case,
    load_model_replay,
    model_case_ok,
    replay_model_case,
)
from repro_torch.train.replay import (
    compare_train_case,
    replay_train_case,
    train_case_ok,
    train_tol,
)

ARCH = "jamba_1_5_large_398b"
KINDS = (("ssm", "mlp"), ("ssm", "moe"), ("attn", "mlp"))
FAULTS = (1.0, 1.05, 1.25, 1.5, 2.0, 0.5, "negated")


class _NegatedGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -g


def main() -> None:
    plain = tstack._apply_block
    model = load_model_replay(MODEL_FIXTURES[ARCH])
    train = load_model_replay(TRAIN_FIXTURES[ARCH])
    mtol, ttol = HYBRID_TOL["bfloat16"], train_tol("hybrid", "bfloat16")
    for kind in KINDS:
        for fault in FAULTS:
            def apply_block(bp, cfg, bd, x, *args, kind=kind, fault=fault, **kw):
                y, cache, aux = plain(bp, cfg, bd, x, *args, **kw)
                if x.dtype == torch.bfloat16 and (bd.mixer, bd.ffn) == kind:
                    y = _NegatedGrad.apply(y) if fault == "negated" else x + (y - x) * fault
                return y, cache, aux

            tstack._apply_block = apply_block
            try:
                cfg, tree, cases = model
                m = compare_model_case(cases["bfloat16"], replay_model_case(
                    cfg, tree, "bfloat16", cases["bfloat16"], "cpu"), mtol)
                cfg, tree, cases = train
                t = compare_train_case(cases["bfloat16"], replay_train_case(
                    cfg, tree, "bfloat16", cases["bfloat16"], "cpu"))
            finally:
                tstack._apply_block = plain
            print(json.dumps(dict(
                kind="+".join(kind), fault=fault, hybrid_tol_ok=model_case_ok(m, mtol),
                train_tol_ok=train_case_ok(t, ttol),
                model={k: m[k] for k in ("prefill_max_abs_diff", "cache_max_abs_diff",
                                         "decode_max_abs_diff", "conv_outside")},
                train={k: t[k] for k in ("loss_rel", "grad_norm_rel", "grad_of_max", "post_abs",
                                         "update_rel")})), flush=True)


if __name__ == "__main__":
    main()
