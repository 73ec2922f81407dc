"""Top-level model API: param defs, init, forward, prefill, decode.

Port of ``repro.models.model`` for every family (dense GQA, Mamba2 SSM,
the MoE family: GQA or MLA mixers with expert FFNs, the hybrid family:
Mamba2 and GQA mixers with dense or expert FFNs in one group, the VLM: a
dense stack behind a prefix of patch embeddings, and the encoder-decoder:
a non-causal encoder over frame embeddings, read by the decoder's
cross-attention):

  * ``model_param_defs(cfg)``        — ParamDef tree (single source of truth);
  * ``abstract_model`` / ``model_axes`` — its shapes and dtypes as tensors
    on the ``meta`` device (nothing allocated), and its logical axes;
  * ``init_model(cfg, generator, device)`` — random weights from a seed, on
    the card unless ``device`` says otherwise;
  * ``forward(params, cfg, batch)``  — hidden states for train/prefill;
  * ``loss_fn``                       — chunked cross-entropy (``chunked_ce``)
    plus 0.01 x the MoE load-balance loss;
  * ``prefill`` / ``decode_step``    — serving with per-layer caches
    (contiguous K/V for attention, the latent rows for MLA, conv window and
    SSD state for Mamba2; a hybrid group holds both kinds, block by block).

``ssd_scan`` is the Mamba2 chunk scan: by default ``kernels.ops.ssd_scan``
(the CUDA kernel on the card), or ``kernels.ref.ssd_scan_ref``, its plain
version.

Batches: ``{"tokens": (B,S) int32}``, and for the loss ``"labels"`` (B,S)
and an optional ``"loss_mask"``.  A VLM batch adds ``"patches"`` (B,P,d_model),
precomputed patch embeddings: they are cast to the embedding dtype and put
before the text embeddings, positions run over all P+S, ``forward`` returns
P as the text offset (the loss is over the text alone), and decode after
such a prefill starts at position P+S.  An encoder-decoder batch adds
``"frames"`` (B,S_enc,d_model) in the model's dtype (JAX's scan over
layers refuses others: its carry would change dtype): ``_encode`` runs
them through the encoder, and every decoder block attends to its output;
prefill puts each layer's cross K/V in the caches (``cross_k``/
``cross_v``), and ``decode_step`` reads them there.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.config import ModelConfig
from repro_torch.core.simulator import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.layers import embed_defs, embed_tokens, f32, rmsnorm, rmsnorm_defs
from repro_torch.models.params import abstract_params, init_params, logical_axes
from repro_torch.models.ssm import ScanFn
from repro_torch.models.stack import apply_group, cache_specs, group_param_defs, plan_groups


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def model_param_defs(cfg: ModelConfig) -> dict:
    dt = _dtype(cfg)
    enc_groups, dec_groups = plan_groups(cfg)
    defs: dict[str, Any] = {"embed": embed_defs(cfg, dt)}
    if enc_groups:
        defs["enc"] = {f"g{i}": group_param_defs(cfg, g, dt) for i, g in enumerate(enc_groups)}
        defs["enc_norm"] = rmsnorm_defs(cfg.d_model, dt)
    defs["dec"] = {f"g{i}": group_param_defs(cfg, g, dt) for i, g in enumerate(dec_groups)}
    defs["final_norm"] = rmsnorm_defs(cfg.d_model, dt)
    return defs


def init_model(cfg: ModelConfig, generator: torch.Generator, device=None) -> dict:
    """Random weights of ``cfg`` from ``generator``'s seed, on ``device``
    (``None``: the card; raises without one)."""
    return init_params(model_param_defs(cfg), generator, resolve_device(device))


def abstract_model(cfg: ModelConfig) -> dict:
    return abstract_params(model_param_defs(cfg))


def model_axes(cfg: ModelConfig) -> dict:
    return logical_axes(model_param_defs(cfg))


LOSS_CHUNK = 1024


def _encode(params, cfg: ModelConfig, frames: torch.Tensor, remat: bool,
            remat_policy: str = "dots") -> torch.Tensor:
    """The encoder's output (B,S_enc,d_model): the frames through the
    encoder groups in train mode (non-causal attention, positions
    0..S_enc-1), then ``enc_norm``."""
    enc_groups, _ = plan_groups(cfg)
    if frames.dtype != _dtype(cfg):
        raise ValueError(f"frames are {frames.dtype}; the {cfg.dtype} model takes "
                         f"{_dtype(cfg)} frames")
    x = frames
    b, s = x.shape[:2]
    pos = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    for i, g in enumerate(enc_groups):
        x, _, _ = apply_group(params["enc"][f"g{i}"], cfg, g, x, pos, "train", remat=remat,
                              remat_policy=remat_policy)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _decoder_input(params, cfg: ModelConfig, batch: dict):
    """Embed tokens (+ the patch prefix for a VLM). Returns (x, text_offset)."""
    x = embed_tokens(params["embed"], batch["tokens"])
    offset = 0
    if cfg.family == "vlm" and "patches" in batch:
        patches = batch["patches"].to(x.dtype)
        x = torch.cat([patches, x], dim=1)
        offset = patches.shape[1]
    return x, offset


def forward(params, cfg: ModelConfig, batch: dict, mode: str = "train",
            ssd_scan: ScanFn = ops.ssd_scan, remat: bool = False, remat_policy: str = "dots"):
    """Returns (hidden, aux_loss, caches, text_offset). Caches only in
    prefill; ``remat`` (train mode) recomputes each layer in the backward
    pass (``stack.apply_group``).  ``aux`` (0-d float32) is the MoE
    load-balance loss summed over the layers, 0 for a stack without
    experts.  ``text_offset`` is the VLM patch count, else 0."""
    enc_out = None
    if cfg.family == "encdec":
        enc_out = _encode(params, cfg, batch["frames"], remat, remat_policy)
    x, offset = _decoder_input(params, cfg, batch)
    b, s = x.shape[:2]
    pos = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    _, dec_groups = plan_groups(cfg)
    caches = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, g in enumerate(dec_groups):
        x, c, a = apply_group(params["dec"][f"g{i}"], cfg, g, x, pos,
                              "prefill" if mode == "prefill" else "train",
                              ssd_scan=ssd_scan, remat=remat, remat_policy=remat_policy,
                              enc_out=enc_out)
        aux = aux + a
        if mode == "prefill":
            caches.append(c)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x, aux, caches if mode == "prefill" else None, offset


def _lm_head_weight(params, cfg: ModelConfig):
    emb = params["embed"]
    return emb["tok"].T if cfg.tie_embeddings else emb["head"]


def _chunk_ce(h, labels, mask, w):
    """Sum of one chunk's masked CE and of its mask; logits float32 of the
    product in the params' dtype."""
    logits = f32(h @ w)                                         # (B,c,V)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return ((logz - gold) * mask).sum(), mask.sum()


def chunked_ce(params, cfg: ModelConfig, hidden: torch.Tensor, labels: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over (B,S) labels; logits computed per sequence chunk of the
    largest divisor of S that is at most ``LOSS_CHUNK``, each recomputed in
    the backward pass (checkpoint), so no (B, c, V) logits live across
    chunks.  The chunk sums are added in order, as JAX's scan does."""
    w = _lm_head_weight(params, cfg)
    b, s, d = hidden.shape
    chunk = min(LOSS_CHUNK, s)
    while s % chunk:
        chunk -= 1
    mask = (torch.ones((b, s), dtype=torch.float32, device=hidden.device)
            if mask is None else mask.to(torch.float32))
    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(s // chunk):
        part = slice(i * chunk, (i + 1) * chunk)
        t, c = ckpt.checkpoint(_chunk_ce, hidden[:, part], labels[:, part], mask[:, part], w,
                               use_reentrant=False)
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(params, cfg: ModelConfig, batch: dict, remat: bool = False,
            remat_policy: str = "dots", ssd_scan: ScanFn = ops.ssd_scan):
    """(loss, {"ce", "aux"}): the chunked CE plus 0.01 x the auxiliary loss."""
    hidden, aux, _, offset = forward(params, cfg, batch, "train", ssd_scan, remat,
                                     remat_policy)
    if offset:
        hidden = hidden[:, offset:]
    ce = chunked_ce(params, cfg, hidden, batch["labels"], batch.get("loss_mask"))
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def prefill(params, cfg: ModelConfig, batch: dict, ssd_scan: ScanFn = ops.ssd_scan):
    """Full-prompt forward returning per-group caches + last-position logits."""
    hidden, _, caches, _ = forward(params, cfg, batch, "prefill", ssd_scan)
    logits = f32(hidden[:, -1:] @ _lm_head_weight(params, cfg))
    return logits, caches


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, pos: torch.Tensor,
                caches: list):
    """One token for every sequence in the batch.

    token: (B,1) int32; pos: (B,) current lengths (after a VLM prefill,
    patches included); caches: stacked per group (``decode_cache_specs``).
    Attention K/V (int8 ones with their scales) and MLA latent caches are
    updated IN PLACE and returned; an encoder-decoder's cross K/V are read
    and returned as they are; Mamba2 states come back as new tensors.
    Returns (logits (B,1,V) float32, caches).
    """
    x = embed_tokens(params["embed"], token)
    _, dec_groups = plan_groups(cfg)
    new_caches = []
    for i, g in enumerate(dec_groups):
        x, c, _ = apply_group(params["dec"][f"g{i}"], cfg, g, x, None, "decode",
                              cache=caches[i], kv_len=pos)
        new_caches.append(c)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = f32(x @ _lm_head_weight(params, cfg))
    return logits, new_caches


def decode_cache_specs(cfg: ModelConfig, batch: int, seq: int, enc_seq: int = 0,
                       kv_int8: bool = False) -> list[dict]:
    return cache_specs(cfg, batch, seq, enc_seq, kv_int8)
