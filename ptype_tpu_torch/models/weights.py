"""Parameters carried across from the reference, and a seeded init.

The reference parameter tree (``ptype_tpu/models/transformer.py``
``init_params``) is a nested dict whose block leaves are stacked on a
leading ``n_layers`` dim: ``wq (L,D,H,Dh)``, ``wk/wv (L,D,K,Dh)``,
``wo (L,H,Dh,D)``, ``w_gate/w_up (L,D,F)``, ``w_down (L,F,D)`` — for
mixture-of-experts ``router (L,D,E)``, ``w_gate/w_up (L,E,D,F)`` and
``w_down (L,E,F,D)`` — the norms, ``embed (V,D)``, ``final_norm (D,)``
and, untied, ``lm_head (D,V)``. The port keeps exactly that layout and
those names, so a tree moves between the packages as numpy arrays, bit
for bit. :func:`stage_params_from_numpy` gives one pipeline stage's
share of it (its layers of every block leaf, the rest whole).

A reference ResNet tree (``ptype_tpu/models/resnet.py``) holds HWIO
convolutions; the port's are OIHW (:func:`resnet_params_from_numpy`
and back). Batch-norm scale, bias and running statistics, and the
head, move as they are.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ptype_tpu_torch.models.transformer import TransformerConfig


def params_from_numpy(tree: dict, cfg: TransformerConfig,
                      device="cpu", place=None) -> dict:
    """A reference parameter tree (numpy arrays, or anything
    ``np.asarray`` takes) → the port's dict of tensors on ``device``,
    in ``cfg.param_dtype``. ``place(path, leaf)``, when given, keeps
    what a mesh rank holds of each leaf, as for :func:`init_params`
    (``path`` the leaf's key tuple)."""

    def conv(x, path):
        if isinstance(x, dict):
            return {k: conv(v, path + (k,)) for k, v in x.items()}
        t = torch.from_numpy(np.array(x, copy=True))
        if place is not None:
            t = place(path, t)
        return t.to(device=device, dtype=cfg.param_dtype)

    return conv(tree, ())


def stage_params_from_numpy(tree: dict, cfg: TransformerConfig,
                            stage: int, n_stages: int,
                            device="cpu") -> dict:
    """:func:`params_from_numpy` of one pipeline stage: every block leaf
    cut to the stage's ``L / n_stages`` layers (what a stage rank holds,
    ``parallel/pipeline.py``), the other leaves whole. ``tree`` is the
    reference's tree, its blocks stacked ``(L, ...)`` or already split
    ``(n_stages, L / n_stages, ...)`` by its ``split_stages``."""
    L = cfg.n_layers
    if L % n_stages:
        raise ValueError(f"{L} layers do not split into {n_stages} stages")
    per = L // n_stages
    shapes = param_shapes(cfg)["blocks"]

    def mine(name, x):
        x = np.asarray(x)
        if x.ndim == len(shapes[name]) + 1:  # split: (S, L/S, ...)
            return x[stage]
        return x[stage * per:(stage + 1) * per]

    out = dict(tree)
    out["blocks"] = {k: mine(k, v) for k, v in tree["blocks"].items()}
    return params_from_numpy(out, cfg, device)


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(fn, v) for v in tree]
    return fn(tree)


def resnet_params_from_numpy(tree: dict, cfg, device="cpu") -> dict:
    """A reference ResNet tree (numpy arrays, or anything ``np.asarray``
    takes) → the port's, on ``device`` in ``cfg.param_dtype``: each
    HWIO convolution transposed to OIHW, every other leaf as it is."""

    def conv(x):
        a = np.asarray(x)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(device=device, dtype=cfg.param_dtype)

    return _map_leaves(conv, tree)


def resnet_params_to_numpy(params: dict) -> dict:
    """Inverse of :func:`resnet_params_from_numpy`: the reference's
    tree of numpy arrays (convolutions HWIO)."""

    def conv(t):
        a = t.detach().float().cpu().numpy()
        return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a

    return _map_leaves(conv, params)


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
    values, are the same either way. On the ``meta`` device nothing is
    drawn: the leaves are shapes alone, so the placements of a model no
    host could hold can be checked without allocating it."""
    L, D, H, K = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads
    Dh, F, V = cfg.head_dim, cfg.d_ff, cfg.vocab_size
    pd = cfg.param_dtype
    gdev = generator.device
    device = gdev if device is None else torch.device(device)

    def kept(path, x):
        return x if place is None else place(path, x)

    def norm(path, shape, scale):
        if device.type == "meta":
            return kept(path, torch.empty(shape, device=device, dtype=pd))
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
