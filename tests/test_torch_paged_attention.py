"""ptype_tpu_torch.ops.paged_attention against the reference Pallas
kernel (``interpret=True``) and the reference gather path. On the CPU
the wrapper runs the plain PyTorch version; the CUDA kernel is held
against that version on the card (test_torch_kernels_cuda.py and
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptype_tpu.models import generate as jgen
from ptype_tpu.models import transformer as jtfm
from ptype_tpu.ops.paged_attention import paged_attention as jpaged
from ptype_tpu_torch.models import generate as tgen
from ptype_tpu_torch.models import transformer as ttfm
from ptype_tpu_torch.ops.paged_attention import (kernel_geometry_problems,
                                                 paged_attention,
                                                 paged_attention_plain)

#: Paged tolerance of the reference's own tests.
TOL = dict(rtol=1e-5, atol=1e-5)
JCFG = jtfm.preset("tiny", dtype=jnp.float32)
TCFG = ttfm.preset("tiny", dtype=torch.float32)


def _inputs(seed, B=3, H=4, Kh=4, Dh=16, bt=16, nb=8, n_blocks=30,
            pos=(5, 37, 100)):
    rng = np.random.default_rng(seed)
    kc = rng.normal(size=(n_blocks, bt, Kh, Dh)).astype(np.float32)
    vc = rng.normal(size=(n_blocks, bt, Kh, Dh)).astype(np.float32)
    q = rng.normal(size=(B, 1, H, Dh)).astype(np.float32)
    tables = rng.integers(1, n_blocks, (B, nb)).astype(np.int32)
    return q, kc, vc, tables, np.asarray(pos, np.int32)


@pytest.mark.parametrize("H,Kh,pos", [
    (4, 4, (5, 37, 100)), (4, 4, (0, 15, 16)), (4, 2, (127, 64, 1)),
    (8, 2, (3, 31, 32))])
def test_plain_matches_reference_kernel_and_gather(H, Kh, pos):
    q, kc, vc, tables, p = _inputs(H * 10 + Kh, H=H, Kh=Kh, pos=pos)
    j = [jnp.asarray(a) for a in (q, kc, vc, tables, p)]
    want_kernel = jpaged(*j, interpret=True)
    want_gather = jgen._paged_attention_gather(*j[:4], j[4] + 1, JCFG)
    got = paged_attention(*(torch.tensor(a) for a in (q, kc, vc, tables, p)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_gather), **TOL)


def test_port_gather_path_matches_reference_gather():
    q, kc, vc, tables, p = _inputs(11)
    j = [jnp.asarray(a) for a in (q, kc, vc, tables, p)]
    t = [torch.tensor(a) for a in (q, kc, vc, tables, p)]
    want = jgen._paged_attention_gather(*j[:4], j[4] + 1, JCFG)
    got = tgen._paged_attention_gather(*t[:4], t[4] + 1, TCFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # Per-query limits (chunked prefill's form).
    q2 = np.random.default_rng(12).normal(size=(1, 5, 4, 16)).astype(
        np.float32)
    lim = np.array([[3, 4, 5, 6, 0]], np.int32)
    want = jgen._paged_attention_gather(jnp.asarray(q2), j[1], j[2],
                                        j[3][:1], jnp.asarray(lim), JCFG)
    got = tgen._paged_attention_gather(torch.tensor(q2), t[1], t[2],
                                       t[3][:1], torch.tensor(lim), TCFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_tensors_take_the_plain_version_without_counting():
    t = [torch.tensor(a) for a in _inputs(13)]
    before = paged_attention.launches
    assert torch.equal(paged_attention(*t), paged_attention_plain(*t))
    assert paged_attention.launches == before


def test_kernel_geometry_gate():
    assert kernel_geometry_problems(6, 6, 128) == []          # optimus
    assert kernel_geometry_problems(32, 8, 128) == []         # llama GQA
    assert any("head_dim" in p for p in kernel_geometry_problems(4, 4, 16))
    assert any("group" in p for p in kernel_geometry_problems(32, 2, 128))
    assert any("divisible" in p for p in kernel_geometry_problems(6, 4, 64))
    assert any("dtype" in p
               for p in kernel_geometry_problems(6, 6, 128, torch.float16))
