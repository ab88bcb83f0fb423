"""ResNet-50 in PyTorch — the port of ``ptype_tpu/models/resnet.py``,
the actor-per-layer pipeline's model family (BASELINE "ResNet-50
actor-per-layer pipeline (registry PID→stage)").

- **Layout**: PyTorch's — NCHW activations held in ``channels_last``
  memory (what cuDNN's tensor-core convolutions read), OIHW weights.
  ``models/weights.py`` carries a reference tree (HWIO) across. The
  reference's "SAME" padding puts the odd pad on the high side; a
  convolution whose pad is uneven (the stride-2 ones) pads explicitly
  first, so the port reads the same pixels as the reference.
- **Precision**: bf16 compute, f32 parameters, batch-norm statistics and
  the head in f32, as the reference.
- **Functional batch norm**: the statistics are explicit state in the
  parameter tree. ``train=True`` normalizes with the batch moments and
  returns the updated running statistics (merge them with
  :func:`update_stats`); ``train=False`` uses the stored ones. No module
  holds hidden state, so every stage stays a plain function the actor
  pipeline can move around.
- **Stage split**: :func:`stage_split` cuts the network into stem / the
  four residual stages / head — the units the registry maps onto actors
  (``train/actor_pipeline.py``).

The convolutions are ``torch.nn.functional.conv2d`` (cuDNN on CUDA): the
reference computes them with ``lax.conv_general_dilated``, outside any
Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class ResNetConfig:
    n_classes: int = 1000
    #: Blocks per stage; (3, 4, 6, 3) = ResNet-50.
    depths: tuple = (3, 4, 6, 3)
    #: Bottleneck output channels per stage.
    widths: tuple = (256, 512, 1024, 2048)
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5


#: The reference's presets, same names and widths.
PRESETS = {
    "resnet-50": ResNetConfig(),
    "resnet-26": ResNetConfig(depths=(2, 2, 2, 2)),
    "tiny": ResNetConfig(n_classes=10, depths=(1, 1), widths=(32, 64)),
}


def preset(name: str, **overrides) -> ResNetConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return replace(PRESETS[name], **overrides)


# ------------------------------------------------------------------ params


def init_params(generator: torch.Generator, cfg: ResNetConfig,
                device=None) -> dict:
    """Seeded parameters with the reference's tree, shapes (convolutions
    OIHW) and scales: He-normal convolutions, a 0.01-normal head, batch
    norms at scale 1, bias 0, running mean 0 and variance 1. Draws on
    ``generator.device`` and moves to ``device`` when given; on the
    ``meta`` device nothing is drawn (shapes only). The draws are
    torch's: for the reference's weights, carry its tree across with
    ``models.weights.resnet_params_from_numpy``."""
    pd = cfg.param_dtype
    gdev = generator.device
    device = gdev if device is None else torch.device(device)

    def normal(shape, std):
        if device.type == "meta":
            return torch.empty(shape, dtype=pd, device=device)
        x = torch.randn(shape, generator=generator, device=gdev,
                        dtype=torch.float32) * std
        return x.to(device=device, dtype=pd)

    def conv(kh, kw, cin, cout):
        return normal((cout, cin, kh, kw), (2.0 / (kh * kw * cin)) ** 0.5)

    def bn(c):
        return {"scale": torch.ones(c, dtype=pd, device=device),
                "bias": torch.zeros(c, dtype=pd, device=device),
                "mean": torch.zeros(c, dtype=pd, device=device),
                "var": torch.ones(c, dtype=pd, device=device)}

    def bottleneck(cin, cout):
        mid = cout // 4
        p = {"conv1": conv(1, 1, cin, mid), "bn1": bn(mid),
             "conv2": conv(3, 3, mid, mid), "bn2": bn(mid),
             "conv3": conv(1, 1, mid, cout), "bn3": bn(cout)}
        if cin != cout:
            p["proj"] = conv(1, 1, cin, cout)
            p["bn_proj"] = bn(cout)
        return p

    params: dict = {
        "stem": {"conv": conv(7, 7, 3, 64), "bn": bn(64)},
        "head": {"w": normal((cfg.widths[-1], cfg.n_classes), 0.01),
                 "b": torch.zeros(cfg.n_classes, dtype=pd, device=device)},
    }
    cin = 64
    for si, (depth, cout) in enumerate(zip(cfg.depths, cfg.widths)):
        params[f"stage{si + 1}"] = [bottleneck(cin if bi == 0 else cout,
                                               cout)
                                    for bi in range(depth)]
        cin = cout
    return params


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def count_params(params) -> int:
    return sum(p.numel() for p in _leaves(params))


# ----------------------------------------------------------------- forward


def _same_pad(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: the output is
    ceil(n / stride), the odd pixel of the pad on the high side."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, kh: int, kw: int, stride: int):
    (t, b), (lft, r) = (_same_pad(x.shape[2], kh, stride),
                        _same_pad(x.shape[3], kw, stride))
    return t, b, lft, r


def _conv(x, w, stride: int = 1, dtype=torch.bfloat16):
    """``x`` (N, C, H, W) by OIHW ``w``, "SAME" padded, operands in
    ``dtype``, channels_last."""
    t, b, lft, r = _pads(x, w.shape[2], w.shape[3], stride)
    x = x.to(dtype)
    w = w.to(dtype=dtype, memory_format=torch.channels_last)
    if t == b and lft == r:
        return F.conv2d(x, w, stride=stride, padding=(t, lft))
    return F.conv2d(F.pad(x, (lft, r, t, b)), w, stride=stride)


def _bn(x, p: dict, cfg: ResNetConfig, train: bool):
    """Returns (y, new_stats); the statistics in f32."""
    x32 = x.float()
    if train:
        mean = x32.mean(dim=(0, 2, 3))
        var = x32.var(dim=(0, 2, 3), unbiased=False)
        m = cfg.bn_momentum
        new = {"mean": (m * p["mean"] + (1 - m) * mean).detach(),
               "var": (m * p["var"] + (1 - m) * var).detach()}
    else:
        mean, var = p["mean"].float(), p["var"].float()
        new = {"mean": p["mean"], "var": p["var"]}

    def c(t):
        return t.reshape(1, -1, 1, 1)

    y = (x32 - c(mean)) * c(torch.rsqrt(var + cfg.bn_eps))
    y = y * c(p["scale"].float()) + c(p["bias"].float())
    return y.to(x.dtype), new


def _bottleneck(x, p: dict, cfg: ResNetConfig, stride: int, train: bool,
                stats_out: dict):
    dt = cfg.dtype
    y, s1 = _bn(_conv(x, p["conv1"], 1, dt), p["bn1"], cfg, train)
    y = F.relu(y)
    y, s2 = _bn(_conv(y, p["conv2"], stride, dt), p["bn2"], cfg, train)
    y = F.relu(y)
    y, s3 = _bn(_conv(y, p["conv3"], 1, dt), p["bn3"], cfg, train)
    stats_out.update({"bn1": s1, "bn2": s2, "bn3": s3})
    if "proj" in p:
        sc, sp = _bn(_conv(x, p["proj"], stride, dt), p["bn_proj"], cfg,
                     train)
        stats_out["bn_proj"] = sp
    else:
        sc = x if stride == 1 else x[:, :, ::stride, ::stride]
    return F.relu(y + sc)


def stem_apply(p: dict, x, cfg: ResNetConfig, train: bool = False):
    """7×7/2 convolution, batch norm, ReLU, 3×3/2 max pool ("SAME", -inf
    padded). ``x``: (B, 3, H, W)."""
    x = x.contiguous(memory_format=torch.channels_last)
    y, s = _bn(_conv(x, p["conv"], 2, cfg.dtype), p["bn"], cfg, train)
    y = F.relu(y)
    t, b, lft, r = _pads(y, 3, 3, 2)
    y = F.max_pool2d(F.pad(y, (lft, r, t, b), value=float("-inf")), 3, 2)
    return y, {"bn": s}


def stage_apply(blocks: list, x, cfg: ResNetConfig, stage_idx: int,
                train: bool = False):
    """One residual stage (a list of bottlenecks); stride 2 on the first
    block of every stage but the first."""
    stats = []
    for bi, p in enumerate(blocks):
        s: dict = {}
        stride = 2 if (bi == 0 and stage_idx > 0) else 1
        x = _bottleneck(x, p, cfg, stride, train, s)
        stats.append(s)
    return x, stats


def head_apply(p: dict, x, cfg: ResNetConfig):
    """Global average pool and the classifier, in f32."""
    x = x.float().mean(dim=(2, 3))
    return x @ p["w"].float() + p["b"].float()


def forward(params: dict, x, cfg: ResNetConfig, train: bool = False):
    """Logits (B, n_classes) of images ``x`` (B, 3, H, W). Returns
    ``(logits, stats)``, ``stats`` mirroring the batch-norm leaves
    (updated running statistics under ``train=True``; merge them with
    :func:`update_stats`)."""
    stats: dict = {}
    y, stats["stem"] = stem_apply(params["stem"], x, cfg, train)
    for si in range(len(cfg.depths)):
        y, stats[f"stage{si + 1}"] = stage_apply(
            params[f"stage{si + 1}"], y, cfg, si, train)
    return head_apply(params["head"], y, cfg), stats


def update_stats(params: dict, stats: dict) -> dict:
    """``params`` with the running statistics of ``stats`` merged in (a
    new tree; the other leaves are shared)."""

    def merge(p, s):
        if isinstance(p, dict):
            out = {}
            for k, v in p.items():
                if k in ("mean", "var") and k in s:
                    out[k] = s[k].detach().to(v.dtype)
                elif isinstance(s, dict) and k in s:
                    out[k] = merge(v, s[k])
                else:
                    out[k] = v
            return out
        if isinstance(p, list):
            return [merge(pi, si) for pi, si in zip(p, s)]
        return p

    merged = dict(params)
    for key in stats:
        merged[key] = merge(params[key], stats[key])
    return merged


def loss_fn(params: dict, batch: dict, cfg: ResNetConfig,
            train: bool = True):
    """Softmax cross-entropy; ``batch``: images (B, 3, H, W), labels
    (B,). Returns (loss, stats)."""
    logits, stats = forward(params, batch["images"], cfg, train)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["labels"][:, None].long())[:, 0]
    return (logz - gold).mean(), stats


# ------------------------------------------------------------ stage split


def stage_split(params: dict, cfg: ResNetConfig, train: bool = False):
    """``[(name, apply_fn, params)]`` — the actor-per-layer pipeline's
    units, each ``apply_fn(params, x) -> y`` a plain function.
    ``train=True`` normalizes with the batch statistics (gradients flow
    through the batch moments) and drops the running-statistic updates;
    recompute those after training (one ``forward(..., train=True)`` +
    :func:`update_stats` sweep) before inference."""
    parts: list = [("stem", lambda p, x: stem_apply(p, x, cfg, train)[0],
                    params["stem"])]
    for si in range(len(cfg.depths)):
        name = f"stage{si + 1}"
        parts.append((name, (lambda i: lambda p, x: stage_apply(
            p, x, cfg, i, train)[0])(si), params[name]))
    parts.append(("head", lambda p, x: head_apply(p, x, cfg),
                  params["head"]))
    return parts
