"""The f32 flash forward kernel's summation schedule, emulated on the CPU.

``flash_fwd_f32_kernel`` (``csrc/flash_attention.cu``) walks each tile of 64
query rows (32 at hd 256) over tiles of as many keys: S = Q.Kᵀ scaled after
the dot, keys past a ragged Skv at weight 0 (the tile's missing rows are
zeros, their scores -inf), causal scores above the diagonal -1e30, tiles
wholly above the block's last row never visited; per tile the row max, p =
exp(s - m_new), alpha = exp(m_old - m_new), l and O rescaled by alpha; at the
end o = O / max(l, 1e-30) and lse = m + log(max(l, 1e-30)); at hd 112 the
hd-128 tiling over rows zero padded past 112 (the scale that of 112).  A plain f32
emulation of that schedule must stay within the card checks' f32 tolerances
(``chip_smoke.py``: ``OUT_TOL`` elementwise and ``OUT_REL`` in norm for o,
``LSE_TOL`` for lse) of ``flash_attention_plain`` and of the JAX package's
``_flash_fwd`` (the Pallas kernel in interpret mode), so the design can pass
those checks before any card runs it.  Inputs come from seeded numpy.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import _flash_fwd
from repro_torch.kernels import flash_attention_plain

torch.set_num_threads(1)
OUT_TOL, OUT_REL, LSE_TOL = 2e-5, 1e-5, 1e-4
B = 2


def _heads(t, rep=1):
    """(B, S, n, hd) -> (B*n*rep, S, hd), each head repeated ``rep`` times
    (a KV head over its group)."""
    b, s, n, hd = t.shape
    return t.transpose(1, 2).reshape(b * n, s, hd).repeat_interleave(rep, dim=0)


def _forward_tiled(q, k, v, causal):
    """``(o (B*H, S, hd), lse (B*H, S))`` by the f32 kernel's schedule."""
    _, sq, h, hd = q.shape
    skv, rep = k.shape[1], h // k.shape[2]
    tile = 32 if hd == 256 else 64
    scale = 1.0 / math.sqrt(hd)
    if hd == 112:
        q, k, v = (torch.nn.functional.pad(t, (0, 16)) for t in (q, k, v))
    qf, kf, vf = _heads(q), _heads(k, rep), _heads(v, rep)
    # the streamed tiles' rows past Skv are zeros
    pad = (-skv) % tile
    kf, vf = (torch.cat([t, t.new_zeros(t.shape[0], pad, t.shape[2])], dim=1) for t in (kf, vf))
    o, lse = torch.empty_like(qf), torch.empty(qf.shape[:2])
    for q0 in range(0, sq, tile):
        qt = qf[:, q0:q0 + tile]
        rows = torch.arange(q0, q0 + qt.shape[1])[:, None]
        m = torch.full(qt.shape[:2], -1e30)
        l = torch.zeros(qt.shape[:2])
        acc = torch.zeros_like(qt)
        kv_end = min(skv, q0 + tile) if causal else skv
        for kv0 in range(0, kv_end, tile):
            keys = torch.arange(kv0, kv0 + tile)[None, :]
            s = torch.matmul(qt, kf[:, kv0:kv0 + tile].transpose(1, 2)) * scale
            if causal:
                s = torch.where(keys > rows, -1e30, s)
            s = torch.where(keys >= skv, -math.inf, s)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.matmul(p, vf[:, kv0:kv0 + tile])
            m = m_new
        lc = torch.clamp(l, min=1e-30)
        o[:, q0:q0 + tile] = acc / lc[..., None]
        lse[:, q0:q0 + tile] = m + torch.log(lc)
    return o[..., :hd], lse


def _f64(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def _close(got, want, tol, what):
    g, w = _f64(got), _f64(want)
    gap = float((g - w).abs().max())
    assert bool(((g - w).abs() <= tol + tol * w.abs()).all()), f"{what}: max gap {gap} (tol {tol})"


def _rel(got, want):
    g, w = _f64(got), _f64(want)
    return float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))


@pytest.mark.parametrize("h,g", [(4, 2), (8, 1)], ids=["h4g2", "h8g1"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hd", [32, 64, 112, 128, 256])
@pytest.mark.parametrize("s", [77, 130, 256])
def test_f32_tiling_within_the_card_tolerance(s, hd, causal, h, g):
    rng = np.random.default_rng(1000 * s + hd)
    q, k, v = (rng.standard_normal((B, s, n, hd)).astype(np.float32) for n in (h, g, g))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o, lse = _forward_tiled(tq, tk, tv, causal)

    po, plse = flash_attention_plain(tq, tk, tv, causal=causal)
    po = _heads(po)
    _close(o, po, OUT_TOL, "o against the plain version")
    assert _rel(o, po) <= OUT_REL, ("o against the plain version", _rel(o, po))
    _close(lse, plse, LSE_TOL, "lse against the plain version")

    # the Pallas kernel in interpret mode, one block a head (S is its block)
    flat = [jnp.asarray(x.transpose(0, 2, 1, 3).reshape(-1, s, hd)) for x in (q, k, v)]
    jo, jlse = _flash_fwd(*flat, causal, s, s, True)
    _close(o, jo, OUT_TOL, "o against the JAX kernel")
    assert _rel(o, jo) <= OUT_REL, ("o against the JAX kernel", _rel(o, jo))
    _close(lse, jlse, LSE_TOL, "lse against the JAX kernel")
