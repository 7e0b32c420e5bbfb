"""Serving steps: prefill + single-token decode against cached state, the
counterpart of ``src/repro/serve/decode.py``.

``prefill_step``: (B, S) prompt -> logits + state; ``serve_step``: one new
token per sequence against a KV cache (or SSM state).  As in the
reference, ``make_prefill_step`` allocates its caches in the default
(bfloat16) dtype; the server (``launch/serve.py``) allocates f32 caches.

Greedy ties: ``torch.argmax`` returns the first maximal index, as
``jnp.argmax`` does.  Under a sharding env the steps take DTensor
parameters and a state placed by ``decode_state_specs``; the caches are
written in place and keep their placements.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models import model as MDL


def sample_greedy(logits):
    return torch.argmax(logits, dim=-1)


def make_prefill_step(cfg, max_len: Optional[int] = None, specs=None):
    """(params, tokens) -> (logits, DecodeState).  tokens: (B, S) or
    (B, S, D) for embed-input archs.  ``specs``: the state's spec tree
    (``launch/shardings.py::decode_state_specs``), under a sharding env
    the caches' placements (the reference's ``out_shardings``)."""

    def prefill_step(params, tokens):
        b, s = tokens.shape[:2]
        state = MDL.init_decode_state(params, cfg, b, max_len or s,
                                      specs=specs)
        return MDL.prefill(params, tokens, cfg, state)

    return prefill_step


def make_serve_step(cfg):
    """(params, tok, state) -> (next_tok, logits, state): one decode step.

    ``tok``: (B,) integer ids — or (B, 1, D) embeddings for frontend-stub
    archs.
    """

    def serve_step(params, tok, state):
        logits, state = MDL.decode_step(params, tok, cfg, state)
        return sample_greedy(logits), logits, state

    return serve_step


def decode_loop(params, cfg, prompt, n_steps: int):
    """Reference autoregressive loop (greedy): (B, n_steps) token ids."""
    prefill_step = make_prefill_step(cfg, max_len=prompt.shape[1] + n_steps)
    serve_step = make_serve_step(cfg)
    logits, state = prefill_step(params, prompt)
    tok = sample_greedy(logits[:, -1])
    out = [tok]
    for _ in range(n_steps - 1):
        tok, _, state = serve_step(params, tok, state)
        out.append(tok)
    return torch.stack(out, dim=1)
