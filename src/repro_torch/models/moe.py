"""Mixture-of-experts layer: top-k routing, capacity, dispatch, expert FFN
and combine (port of ``repro.models.moe``).

The JAX package runs the same per-shard math under ``shard_map`` on a mesh
(experts over ``data`` through ``all_to_all``, each expert's d_ff over
``model`` through ``psum``) and locally without one.  The port has no model
mesh, so ``moe_ffn`` always runs the local path; ``_local_moe`` keeps the
mesh's arguments and refuses ``n_peers > 1`` or ``tp > 1`` (ROADMAP §1
item 8).

Every step is plain PyTorch on both devices, as the JAX package computes it
in jnp outside any Pallas kernel.  Each choice of the reference is kept
where the two libraries could differ:

* ``lax.top_k`` puts the lower expert first on a tie, so the top k come
  from a stable descending sort;
* the dispatch sorts the flat choices with a stable argsort;
* the combine adds each token's k contributions in ascending expert order,
  the order in which XLA's scatter-add applies them, gathered into a fixed
  layout and summed left to right (no atomics: two calls give the same
  bits on the card too).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import ParamDef


def moe_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    return {
        "router": ParamDef((d, e)),
        "wg": ParamDef((e, d, f)),
        "wu": ParamDef((e, d, f)),
        "wd": ParamDef((e, f, d)),
    }


def capacity(t: int, cfg: ModelConfig) -> int:
    """Slots an expert for ``t`` tokens, in the JAX package's arithmetic."""
    return max(1, int((t * cfg.top_k * cfg.capacity_factor) / cfg.n_experts + 0.999))


#: where ``capture_routing`` collects each local MoE call's routing
_CAPTURED: Optional[List[Dict[str, torch.Tensor]]] = None


@contextlib.contextmanager
def capture_routing():
    """Collect, for every local MoE call made inside the block, its
    ``probs``, ``top_e`` and ``keep`` (each token's k choices: did it get a
    slot), detached, in call order."""
    global _CAPTURED
    outer, _CAPTURED = _CAPTURED, []
    try:
        yield _CAPTURED
    finally:
        _CAPTURED = outer


def _local_moe(
    x: torch.Tensor,             # (B, S, D)
    router: torch.Tensor,        # (D, E)
    wg: torch.Tensor,            # (E, D, F)
    wu: torch.Tensor,
    wd: torch.Tensor,            # (E, F, D)
    *,
    cfg: ModelConfig,
    n_peers: int,
    tp: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if n_peers > 1 or tp > 1:
        raise NotImplementedError(
            f"MoE over a mesh (n_peers={n_peers}, tp={tp}: experts by all_to_all, "
            "d_ff by psum) is not ported yet (ROADMAP §1 item 8)")
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xf = x.reshape(t, d)

    # ---- routing: the product in x's type, then f32 ------------------------
    probs = torch.softmax((xf @ router).to(torch.float32), dim=-1)         # (T, E)
    top_e = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
    top_p = torch.gather(probs, 1, top_e)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    # Switch-style load-balance loss; one-hot by comparison (F.one_hot reads
    # the ids' range back to the host)
    one_hot = (top_e[..., None] == torch.arange(e, device=x.device)).to(torch.float32)
    aux = e * torch.sum(torch.mean(probs, dim=0) * torch.mean(torch.sum(one_hot, dim=1), dim=0))

    # ---- dispatch: each choice's place among its expert's, in token order --
    cap = capacity(t, cfg)
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    pos = torch.arange(t * k, device=x.device) - torch.searchsorted(sorted_e, sorted_e, side="left")
    keep = pos < cap
    src_tok = order // k
    n_slots = e * cap
    slot = torch.where(keep, sorted_e * cap + pos, n_slots)                 # dropped → overflow
    rows = torch.where(keep[:, None], xf[src_tok], 0.0).to(x.dtype)
    buf = x.new_zeros((n_slots + 1, d)).index_put((slot,), rows)[:-1]

    # ---- expert FFN --------------------------------------------------------
    h = buf.reshape(e, cap, d)
    out = torch.bmm(F.silu(torch.bmm(h, wg)) * torch.bmm(h, wu), wd)

    # ---- combine: each token's k contributions in ascending expert order ---
    contrib = out.reshape(n_slots, d)[torch.clamp(slot, max=n_slots - 1)]
    weight = top_p.reshape(-1)[order].to(x.dtype)
    contrib = contrib * (weight * keep)[:, None]
    inv = torch.argsort(order)                        # flat choice → sorted position
    at = torch.sort(inv.reshape(t, k), dim=1).values
    y = contrib[at[:, 0]]
    for j in range(1, k):
        y = y + contrib[at[:, j]]
    if _CAPTURED is not None:
        _CAPTURED.append(dict(probs=probs.detach(), top_e=top_e, keep=keep[inv].reshape(t, k)))
    return y.reshape(b, s, d), aux.reshape(1)


def moe_ffn(x: torch.Tensor, p, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch → expert FFN → combine, on one device.  Returns (y, aux_loss)."""
    y, aux = _local_moe(x, p.router, p.wg, p.wu, p.wd, cfg=cfg, n_peers=1, tp=1)
    return y, torch.mean(aux)
