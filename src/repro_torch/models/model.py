"""Unified model API: ``build_model(cfg) -> Model`` (PyTorch counterpart
of ``repro/models/model.py``, dense family on the paged KV plane).

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
    init_paged_cache: Callable
    # (batch, max_len, block_tokens=16, frames=None, device=None)
    #   -> pages {"kp","vp"} (L, P, bt, K, hd)
    paged_decode_step: Callable
    # (params, pages, tokens, block_tables, seq_lens) -> (logits, pages)
    paged_prefill_chunk: Callable
    # (params, pages, tokens, block_tables, ctx_lens, valid_lens)
    #   -> (last-valid-position logits, pages)

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
    transformer.require_dense(cfg)

    def init_paged_cache(batch, max_len, block_tokens=16, frames=None,
                         device=None):
        return transformer.lm_init_paged_cache(
            cfg, batch, max_len, block_tokens, device=resolve_device(device),
            frames=frames)

    return Model(
        cfg=cfg,
        schema=transformer.lm_schema(cfg),
        init_paged_cache=init_paged_cache,
        paged_decode_step=lambda p, pages, t, btab, lens:
            transformer.lm_paged_decode_step(p, cfg, pages, t, btab, lens),
        paged_prefill_chunk=lambda p, pages, t, btab, ctx, valid:
            transformer.lm_paged_prefill_chunk(p, cfg, pages, t, btab, ctx,
                                               valid),
    )
