"""Unified model API: ``build_model(cfg) -> Model`` (PyTorch counterpart
of ``repro/models/model.py``): the dense, moe and vlm families on the
paged KV plane (one-shot and chunked prefill, paged decode) and on the
dense-cache plane (bucketed or exact-length prefill into a (slots,
max_len) cache, a ring under a sliding window, decode at a shared write
index), the hybrid and ssm (xLSTM) families on the dense-cache plane.  As
in JAX, the paged callables are ``None`` for a family without a uniform
KV stack (hybrid, ssm).

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise (``repro_torch.device``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.layers import init_params


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    schema: Any
    prefill: Callable
    # (params, tokens (B, S), max_len=None, valid_len=None, *,
    #   vis_embeds=None, pos_ids=None) -> (logits at the last (valid)
    #   position, cache of lm_init_cache's structure packed to T =
    #   kv_cache_len(max_len or S)); valid_len marks the real length of
    #   right-padded tokens (dense/moe/vlm bucketed prefill); vis_embeds
    #   and pos_ids are a vlm prompt's image rows and M-RoPE positions
    init_cache: Optional[Callable] = None
    # (batch, max_len, device=None) -> dense cache
    decode_step: Optional[Callable] = None
    # (params, cache, tokens (B, 1)) -> (logits, cache)
    init_paged_cache: Optional[Callable] = None
    # (batch, max_len, block_tokens=16, frames=None, device=None)
    #   -> pages {"kp","vp"} (L, P, bt, K, hd)
    paged_decode_step: Optional[Callable] = None
    # (params, pages, tokens, block_tables, seq_lens) -> (logits, pages)
    paged_prefill_chunk: Optional[Callable] = None
    # (params, pages, tokens, block_tables, ctx_lens, valid_lens)
    #   -> (last-valid-position logits, pages)
    paged_prefill_write: Optional[Callable] = None
    # (pages, k_rows, v_rows, block_ids, prompt_len, skip_tokens=0) -> pages
    kv_migrate: Optional[Callable] = None
    # (near, far, dem_src, dem_dst, pro_src, pro_dst) -> (near, far), the
    #   tiered engine's near<->far page copies

    def init(self, generator: Optional[torch.Generator] = None,
             device=None):
        """Random params following the JAX schema (normal * 1/sqrt(fan_in),
        0.02 for ``emb``, zeros for the norm scales), drawn from
        ``generator`` (default: seed 0 on ``device``)."""
        dev = resolve_device(device if device is not None else
                             (generator.device if generator is not None
                              else None))
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return init_params(self.schema, generator,
                           getattr(torch, self.cfg.param_dtype), dev)


def build_model(cfg: ModelConfig) -> Model:
    transformer.require_ported_family(cfg)

    def prefill(p, t, max_len=None, valid_len=None, **vlm_inputs):
        return transformer.lm_prefill(p, cfg, t, max_len, valid_len,
                                      **vlm_inputs)

    dense_plane = dict(
        cfg=cfg,
        schema=transformer.lm_schema(cfg),
        prefill=prefill,
        init_cache=lambda batch, max_len, device=None:
            transformer.lm_init_cache(cfg, batch, max_len,
                                      device=resolve_device(device)),
        decode_step=lambda p, c, t: transformer.lm_decode_step(p, cfg, c, t),
    )
    if cfg.family in ("hybrid", "ssm"):
        return Model(**dense_plane)

    def init_paged_cache(batch, max_len, block_tokens=16, frames=None,
                         device=None):
        return transformer.lm_init_paged_cache(
            cfg, batch, max_len, block_tokens, device=resolve_device(device),
            frames=frames)

    return Model(
        **dense_plane,
        init_paged_cache=init_paged_cache,
        paged_decode_step=lambda p, pages, t, btab, lens:
            transformer.lm_paged_decode_step(p, cfg, pages, t, btab, lens),
        paged_prefill_chunk=lambda p, pages, t, btab, ctx, valid:
            transformer.lm_paged_prefill_chunk(p, cfg, pages, t, btab, ctx,
                                               valid),
        paged_prefill_write=lambda pages, k, v, ids, n, skip=0:
            transformer.lm_paged_prefill_write(cfg, pages, k, v, ids, n,
                                               skip),
        kv_migrate=transformer.lm_kv_migrate,
    )
