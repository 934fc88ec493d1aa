"""The rounding points of the bf16 flash kernels, emulated on the CPU.

The tensor-core kernels (``csrc/flash_attention.cu``, the dq and dk/dv
kernels of ``csrc/flash_attention_bwd.cu``) feed wgmma bf16 operands: the
forward rounds P to bf16 before ``O += P.V`` (the row sums stay f32), dq
rounds dS before ``dQ += dS.K`` over 64-key tiles, dk/dv rounds P^T before
``dV += P^T.dO`` and dS^T before ``dK += dS^T.Q``.  A plain emulation of
those rounding points, with the forward's online softmax over 128-key tiles,
must stay within the card checks' tolerances of the plain versions
(``chip_smoke.py``: ``OUT_TOL`` elementwise and ``OUT_REL`` in norm for o and
``LSE_TOL`` for the forward, ``BWD_TOL`` elementwise and ``BWD_REL`` in norm
for dq, dk and dv) at S=512, H=12, G=2, hd=128 (dq also at gemma-2b's H=8,
G=1, hd=256), so the design can pass those checks before any card runs it.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention_bwd_plain, flash_attention_plain

torch.set_num_threads(1)
BF16, F32 = torch.bfloat16, torch.float32
OUT_TOL, OUT_REL, LSE_TOL, BWD_TOL, BWD_REL = 2e-2, 1e-2, 1e-4, 2e-2, 1e-2
B, S, H, G, HD, TILE = 1, 512, 12, 2, 128, 128


def _inputs(seed, h=H, g=G, hd=HD):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, S, n, hd)).astype(np.float32)).to(BF16)
            for n in (h, g, g, h)]


def _heads(t, rep=1):
    """(B, S, n, hd) -> (B*n*rep, S, hd) f32, each head repeated ``rep``
    times (a KV head over its group)."""
    b, s, n, hd = t.shape
    return t.to(F32).transpose(1, 2).reshape(b * n, s, hd).repeat_interleave(rep, dim=0)


def _round(x):
    return x.to(BF16).to(F32)


def _forward_emulated(q, k, v, causal):
    """The bf16 forward kernel's arithmetic: online softmax over key tiles,
    P rounded to bf16 for the PV product, f32 sums."""
    qf, kf, vf = _heads(q), _heads(k, H // G), _heads(v, H // G)
    scale = 1.0 / math.sqrt(HD)
    m = torch.full((B * H, S), -1e30)
    l = torch.zeros((B * H, S))
    acc = torch.zeros((B * H, S, HD))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, TILE):
        s = torch.matmul(qf, kf[:, k0:k0 + TILE].transpose(1, 2)) * scale
        if causal:
            s = torch.where(torch.arange(k0, k0 + TILE)[None, :] <= rows, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(_round(p), vf[:, k0:k0 + TILE])
        m = m_new
    lc = torch.clamp(l, min=1e-30)
    o = (acc / lc[..., None]).reshape(B, H, S, HD).transpose(1, 2).to(BF16)
    return o, m + torch.log(lc)


def _dkv_emulated(q, k, v, o, lse, do, causal):
    """The bf16 dk/dv kernel's arithmetic: P^T and dS^T rounded to bf16
    before the dV and dK products, f32 sums, the grouped heads summed."""
    qf, kf, vf, dof = _heads(q), _heads(k, H // G), _heads(v, H // G), _heads(do)
    scale = 1.0 / math.sqrt(HD)
    s = torch.matmul(qf, kf.transpose(1, 2)) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.where(torch.arange(S)[None, :] <= torch.arange(S)[:, None], p, 0.0)
    delta = torch.sum(dof * _heads(o), dim=-1)
    ds = p * (torch.matmul(dof, vf.transpose(1, 2)) - delta[..., None]) * scale
    dv = torch.matmul(_round(p).transpose(1, 2), dof).reshape(B * G, H // G, S, HD).sum(1)
    dk = torch.matmul(_round(ds).transpose(1, 2), qf).reshape(B * G, H // G, S, HD).sum(1)
    back = lambda x: x.reshape(B, G, S, HD).transpose(1, 2).to(BF16)
    return back(dk), back(dv)


def _dq_emulated(q, k, v, o, lse, do, causal):
    """The bf16 dq kernel's arithmetic: f32 S and dP over 64-key tiles, dS
    rounded to bf16 before ``dQ += dS.K``, f32 sums over the tiles."""
    b, s_len, h, hd = q.shape
    rep = h // k.shape[2]
    qf, kf, vf, dof = _heads(q), _heads(k, rep), _heads(v, rep), _heads(do)
    scale = 1.0 / math.sqrt(hd)
    delta = torch.sum(dof * _heads(o), dim=-1)
    rows = torch.arange(s_len)[:, None]
    dq = torch.zeros_like(qf)
    for k0 in range(0, s_len, 64):
        kt, vt = kf[:, k0:k0 + 64], vf[:, k0:k0 + 64]
        p = torch.exp(torch.matmul(qf, kt.transpose(1, 2)) * scale - lse[..., None])
        if causal:
            p = torch.where(torch.arange(k0, k0 + kt.shape[1])[None, :] <= rows, p, 0.0)
        ds = p * (torch.matmul(dof, vt.transpose(1, 2)) - delta[..., None]) * scale
        dq = dq + torch.matmul(_round(ds), kt)
    return dq.reshape(b, h, s_len, hd).transpose(1, 2).to(BF16)


def _within(got, want, tol, what):
    g, w = got.double(), want.double()
    gap = float((g - w).abs().max())
    assert bool(((g - w).abs() <= tol + tol * w.abs()).all()), f"{what}: max gap {gap} (tol {tol})"


def _rel(got, want):
    g, w = got.double(), want.double()
    return float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_forward_rounding_within_the_card_tolerance(causal):
    q, k, v, _ = _inputs(1)
    o, lse = _forward_emulated(q, k, v, causal)
    po, plse = flash_attention_plain(q, k, v, causal=causal)
    _within(o, po, OUT_TOL, "o")
    assert _rel(o, po) <= OUT_REL, ("o", _rel(o, po))
    _within(lse, plse, LSE_TOL, "lse")


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_dkv_rounding_within_the_card_tolerance(causal):
    q, k, v, do = _inputs(2)
    o, lse = flash_attention_plain(q, k, v, causal=causal)
    dk, dv = _dkv_emulated(q, k, v, o, lse, do, causal)
    _, pdk, pdv = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    for name, got, want in (("dk", dk, pdk), ("dv", dv, pdv)):
        _within(got, want, BWD_TOL, name)
        assert _rel(got, want) <= BWD_REL, (name, _rel(got, want))


@pytest.mark.parametrize("causal,h,g,hd", [(True, H, G, HD), (False, H, G, HD), (True, 8, 1, 256)],
                         ids=["causal", "full", "gemma-2b hd256 causal"])
def test_dq_rounding_within_the_card_tolerance(causal, h, g, hd):
    q, k, v, do = _inputs(3, h, g, hd)
    o, lse = flash_attention_plain(q, k, v, causal=causal)
    dq = _dq_emulated(q, k, v, o, lse, do, causal)
    pdq, _, _ = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    _within(dq, pdq, BWD_TOL, "dq")
    assert _rel(dq, pdq) <= BWD_REL, ("dq", _rel(dq, pdq))
