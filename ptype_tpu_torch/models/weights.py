"""Parameters carried across from the reference, and a seeded init.

The reference parameter tree (``ptype_tpu/models/transformer.py``
``init_params``) is a nested dict whose block leaves are stacked on a
leading ``n_layers`` dim: ``wq (L,D,H,Dh)``, ``wk/wv (L,D,K,Dh)``,
``wo (L,H,Dh,D)``, ``w_gate/w_up (L,D,F)``, ``w_down (L,F,D)`` — for
mixture-of-experts ``router (L,D,E)``, ``w_gate/w_up (L,E,D,F)`` and
``w_down (L,E,F,D)`` — the norms, ``embed (V,D)``, ``final_norm (D,)``
and, untied, ``lm_head (D,V)``. The port keeps exactly that layout and
those names, so a tree moves between the packages as numpy arrays, bit
for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ptype_tpu_torch.models.transformer import TransformerConfig


def params_from_numpy(tree: dict, cfg: TransformerConfig,
                      device="cpu") -> dict:
    """A reference parameter tree (numpy arrays, or anything
    ``np.asarray`` takes) → the port's dict of tensors on ``device``,
    in ``cfg.param_dtype``."""

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        t = torch.from_numpy(np.array(x, copy=True))
        return t.to(device=device, dtype=cfg.param_dtype)

    return conv(tree)


def params_to_numpy(params: dict) -> dict:
    """Inverse of :func:`params_from_numpy`: the same nested dict of
    numpy arrays the reference's ``init_params`` returns."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().cpu().numpy()


def param_shapes(cfg: TransformerConfig) -> dict:
    """The parameter tree of ``cfg`` with each leaf's shape in place of
    its value — the layout :func:`init_params` fills (a template for
    reading a checkpoint without drawing weights)."""
    L, D, H, K = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads
    Dh, F, V, E = cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.n_experts
    mlp = ({"router": (L, D, E), "w_gate": (L, E, D, F),
            "w_up": (L, E, D, F), "w_down": (L, E, F, D)} if E else
           {"w_gate": (L, D, F), "w_up": (L, D, F), "w_down": (L, F, D)})
    tree = {"embed": (V, D),
            "blocks": {"attn_norm": (L, D), "wq": (L, D, H, Dh),
                       "wk": (L, D, K, Dh), "wv": (L, D, K, Dh),
                       "wo": (L, H, Dh, D), "mlp_norm": (L, D), **mlp},
            "final_norm": (D,)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = (D, V)
    return tree


def init_params(generator: torch.Generator, cfg: TransformerConfig,
                device=None, place=None) -> dict:
    """Seeded random parameters with the reference's shapes and scales
    (scaled normals: 0.02, and 0.02/sqrt(2L) on the out-projections).
    Draws on ``generator.device``; moves to ``device`` when given. The
    draws are torch's, not JAX's: for identical weights in both
    packages, carry a reference tree across with
    :func:`params_from_numpy`.

    ``place(path, leaf)``, when given, takes each leaf as it is drawn
    (``path`` its key tuple, as ``train.trainer._flatten`` names it)
    and returns what the tree keeps: a mesh rank keeps its block, so
    no more than one whole leaf exists at a time. The draws, and so the
    values, are the same either way."""
    L, D, H, K = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads
    Dh, F, V = cfg.head_dim, cfg.d_ff, cfg.vocab_size
    pd = cfg.param_dtype
    gdev = generator.device
    device = gdev if device is None else torch.device(device)

    def kept(path, x):
        return x if place is None else place(path, x)

    def norm(path, shape, scale):
        x = torch.randn(shape, generator=generator, device=gdev,
                        dtype=torch.float32) * scale
        return kept(path, x).to(device=device, dtype=pd)

    def ones(path, shape):
        return kept(path, torch.ones(shape, device=device, dtype=pd))

    def block(name):
        return ("blocks", name)

    resid = 0.02 / math.sqrt(2.0 * L)
    E = cfg.n_experts
    if E:
        mlp = {
            "mlp_norm": ones(block("mlp_norm"), (L, D)),
            "router": norm(block("router"), (L, D, E), 0.02),
            "w_gate": norm(block("w_gate"), (L, E, D, F), 0.02),
            "w_up": norm(block("w_up"), (L, E, D, F), 0.02),
            "w_down": norm(block("w_down"), (L, E, F, D), resid),
        }
    else:
        mlp = {
            "mlp_norm": ones(block("mlp_norm"), (L, D)),
            "w_gate": norm(block("w_gate"), (L, D, F), 0.02),
            "w_up": norm(block("w_up"), (L, D, F), 0.02),
            "w_down": norm(block("w_down"), (L, F, D), resid),
        }
    params = {
        "embed": norm(("embed",), (V, D), 0.02),
        "blocks": {
            "attn_norm": ones(block("attn_norm"), (L, D)),
            "wq": norm(block("wq"), (L, D, H, Dh), 0.02),
            "wk": norm(block("wk"), (L, D, K, Dh), 0.02),
            "wv": norm(block("wv"), (L, D, K, Dh), 0.02),
            "wo": norm(block("wo"), (L, H, Dh, D), resid),
            **mlp,
        },
        "final_norm": ones(("final_norm",), (D,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = norm(("lm_head",), (D, V), 0.02)
    return params
