"""Model assembly for the dense attention family: parameters, the training
forward, the prefill-style forward, and decode (port of
``repro.models.model``).

Parameters are ``nn.Module``s holding ``nn.Parameter``s named and oriented
as in the JAX parameter tree, with an ``nn.ModuleList`` of L layers where
JAX scans stacked parameters.  The port runs ``block_pattern ==
"attention"`` with text input, no experts and no encoder; every other family
raises ``NotImplementedError`` naming its ROADMAP item.

``forward_train`` is differentiable in the parameters: it casts them to the
compute dtype through autograd (``_cast_tree``) and rematerializes each
layer as ``cfg.remat`` says.  ``forward_logits``, ``prefill`` and
``decode_step`` are inference entry points and run without autograd.
Decode writes the KV caches of a ``DecodeState`` in place (the JAX package
returns updated copies); the state it returns carries the advanced length.
"""
from __future__ import annotations

import types
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.torch_scheduler import resolve_device
from .attention import (
    _project_qkv,
    _sdpa_reference,
    attention,
    attention_decode,
    attn_defs,
)
from .layers import (
    ParamDef,
    cross_entropy_loss,
    glu_mlp,
    init_leaf,
    mlp_defs,
    norm_defs,
    rms_norm,
)

#: weight of the experts' auxiliary loss (0 for the families the port runs)
AUX_LOSS_WEIGHT = 0.01
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port does not run yet."""
    if cfg.block_pattern == "zamba_hybrid":
        raise NotImplementedError(f"{cfg.name}: the SSM hybrid is not ported yet "
                                  "(ROADMAP §1 item 13)")
    if cfg.block_pattern == "xlstm":
        raise NotImplementedError(f"{cfg.name}: xLSTM is not ported yet (ROADMAP §1 item 14)")
    if cfg.block_pattern != "attention":
        raise ValueError(cfg.block_pattern)
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: mixture-of-experts is not ported yet "
                                  "(ROADMAP §1 item 12)")
    if cfg.encoder_decoder or cfg.modality != "text":
        raise NotImplementedError(f"{cfg.name}: encoder-decoder and the vision/audio stubs "
                                  "are not ported yet (ROADMAP §1 item 15)")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class ParamGroup(nn.Module):
    """``nn.Parameter``s named as the leaves of one JAX parameter dict."""

    def __init__(self, defs: Dict[str, ParamDef], device=None, dtype=torch.float32):
        super().__init__()
        for name, d in defs.items():
            self.register_parameter(
                name, nn.Parameter(torch.empty(d.shape, device=device, dtype=dtype)))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None, dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        self.attn_norm = nn.Parameter(torch.empty(d, device=device, dtype=dtype))
        self.attn = ParamGroup(attn_defs(cfg), device, dtype)
        self.mlp_norm = nn.Parameter(torch.empty(d, device=device, dtype=dtype))
        if cfg.mlp_type != "none":
            self.mlp = ParamGroup(mlp_defs(d, cfg.d_ff), device, dtype)


class Model(nn.Module):
    """The parameters of one model: ``embed``, ``final_norm``, ``lm_head``
    (untied only) and ``layers``, uninitialized (``device=None`` is the
    card; ``"meta"`` allocates nothing)."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=torch.float32):
        super().__init__()
        check_supported(cfg)
        if device is None:
            device = resolve_device(device)
        d, v = cfg.d_model, cfg.vocab_padded
        self.embed = nn.Parameter(torch.empty((v, d), device=device, dtype=dtype))
        self.final_norm = nn.Parameter(torch.empty(d, device=device, dtype=dtype))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty((d, v), device=device, dtype=dtype))
        self.layers = nn.ModuleList(DecoderLayer(cfg, device, dtype) for _ in range(cfg.n_layers))


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """ParamDef tree of the JAX package's ``model_defs`` for the attention
    family; ``layers`` holds one layer's definitions (the port keeps L
    layers where JAX stacks them)."""
    check_supported(cfg)
    d, v = cfg.d_model, cfg.vocab_padded
    defs: Dict[str, Any] = {
        "embed": ParamDef((v, d), init="embed", scale=0.02),
        "final_norm": norm_defs(d),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, v), scale=1.0)
    layer: Dict[str, Any] = {"attn_norm": norm_defs(d), "attn": attn_defs(cfg),
                             "mlp_norm": norm_defs(d)}
    if cfg.mlp_type != "none":
        layer["mlp"] = mlp_defs(d, cfg.d_ff)
    defs["layers"] = layer
    return defs


def _leaves(tree: Dict[str, Any], prefix: str = ""):
    for name, x in tree.items():
        if isinstance(x, dict):
            yield from _leaves(x, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", x


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> Model:
    """Random parameters in ``cfg.params_dtype``, drawn from the distributions
    of the JAX package's ``init_params`` (same distributions, not the same
    values: JAX folds Python's randomized ``hash`` of each path into its
    keys).  Normal draws come from ``generator`` on its own device."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.params_dtype)
    model = Model(cfg, device=device, dtype=dtype)
    params = dict(model.named_parameters())
    for name, d in _leaves(model_defs(cfg)):
        if name.startswith("layers."):
            # JAX draws the scanned stack at once: its fan-in is the layer count
            for i in range(cfg.n_layers):
                params[f"layers.{i}.{name[7:]}"].copy_(
                    init_leaf(d, generator, device, dtype, fan_in=cfg.n_layers))
        else:
            params[name].copy_(init_leaf(d, generator, device, dtype))
    return model


# ---------------------------------------------------------------------------
# Forwards
# ---------------------------------------------------------------------------


def _cast(params: Model, cfg: ModelConfig) -> Model:
    """The parameters in the compute dtype (f32 leaves cast, others kept).
    Returns ``params`` itself when nothing needs a cast, so callers may cast
    once and pass the result on."""
    dt = torch_dtype(cfg.dtype)
    state = params.state_dict()
    if dt == torch.float32 or all(t.dtype != torch.float32 for t in state.values()):
        return params
    out = Model(cfg, device="meta")
    out.load_state_dict({k: (t.to(dt) if t.dtype == torch.float32 else t)
                         for k, t in state.items()}, assign=True)
    return out


def _cast_tree(module: nn.Module, dt: torch.dtype):
    """The parameters of ``module`` in ``dt`` (f32 leaves cast, others kept)
    as a tree of namespaces shaped like the module (a ``ModuleList`` becomes
    a list).  Each leaf is a differentiable cast of its parameter, so the
    gradient reaches the f32 master weights.  (A namespace and not
    ``torch.func.functional_call``: the layers' recomputation under
    ``remat="full"`` runs during the backward, after a functional call would
    have put the f32 parameters back.)"""
    out = types.SimpleNamespace()
    for name, p in module.named_parameters(recurse=False):
        setattr(out, name, p.to(dt) if p.dtype == torch.float32 else p)
    for name, child in module.named_children():
        setattr(out, name, [_cast_tree(c, dt) for c in child]
                if isinstance(child, nn.ModuleList) else _cast_tree(child, dt))
    return out


def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding and not ``embed[tokens]``: on the card the backward of an
    # index is an accumulating ``index_put_`` (atomics, nondeterministic),
    # while the embedding backward sorts the ids and sums each id's rows in
    # a fixed order, so gradients repeat bit for bit.
    return F.embedding(tokens.long(), params.embed).to(torch_dtype(cfg.dtype))


def _logits(params: Model, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    return h @ w.to(h.dtype)


def _attn_layer(h, lp: DecoderLayer, cfg: ModelConfig, positions, causal: bool = True):
    """One transformer block.  (The JAX package also returns the experts'
    auxiliary loss, always 0 for the families the port runs.)"""
    a = attention(rms_norm(h, lp.attn_norm, cfg.norm_eps), lp.attn, cfg, positions,
                  causal=causal)
    h = h + a
    hn = rms_norm(h, lp.mlp_norm, cfg.norm_eps)
    y = glu_mlp(hn, lp.mlp, cfg.mlp_type) if cfg.mlp_type != "none" else torch.zeros_like(h)
    return h + y


def _maybe_remat(fn, cfg: ModelConfig):
    """``cfg.remat``: ``"none"`` runs ``fn``; ``"full"`` saves only its
    inputs and recomputes it in the backward (``jax.checkpoint``)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "dots":
        raise NotImplementedError(
            "remat='dots' (save the matmul outputs, recompute the rest) is not ported "
            "yet (ROADMAP §1 item 18); use 'full' or 'none'")
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _decoder_stack(h, params, cfg: ModelConfig, positions):
    layer = _maybe_remat(_attn_layer, cfg)
    for lp in params.layers:
        h = layer(h, lp, cfg, positions)
    return h


def _forward_hidden(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """Embeddings → block stack → final norm."""
    check_supported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = _embed(params, cfg, tokens)
    positions = torch.arange(s, device=h.device).expand(b, s)
    h = _decoder_stack(h, params, cfg, positions)
    return rms_norm(h, params.final_norm, cfg.norm_eps)


def forward_train(cfg: ModelConfig, params: Model, batch: Dict[str, torch.Tensor]):
    """Causal-LM loss of ``batch["tokens"]`` against ``batch["labels"]``
    (token mean, f32, z-loss 1e-4) → ``(loss, {"lm_loss", "aux_loss"})``;
    differentiable in ``params``.  ``aux_loss`` is the experts' loss, 0 for
    the families the port runs."""
    check_supported(cfg)
    pc = _cast_tree(params, torch_dtype(cfg.dtype))
    h = _forward_hidden(cfg, pc, batch)
    loss = cross_entropy_loss(_logits(pc, cfg, h), batch["labels"])
    aux_total = AUX_LOSS_WEIGHT * torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss + aux_total, {"lm_loss": loss.detach(), "aux_loss": aux_total}


@torch.no_grad()
def forward_logits(cfg: ModelConfig, params: Model, batch: Dict[str, torch.Tensor],
                   last_only: bool = True) -> torch.Tensor:
    """Prefill-style forward: logits (last position by default), over the
    padded vocabulary, no loss."""
    params = _cast(params, cfg)
    h = _forward_hidden(cfg, params, batch)
    if last_only:
        h = h[:, -1:]
    return _logits(params, cfg, h)


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------


class DecodeState(NamedTuple):
    length: int                                              # tokens in the cache
    kv_k: Optional[torch.Tensor] = None                      # (L,B,S,G,hd)
    kv_v: Optional[torch.Tensor] = None
    #: per-layer cache layout (serving mode): tuples of L × (B,S,G,hd)
    kv_layers_k: Optional[Tuple[torch.Tensor, ...]] = None
    kv_layers_v: Optional[Tuple[torch.Tensor, ...]] = None


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                      device=None) -> DecodeState:
    check_supported(cfg)
    device = resolve_device(device)
    g, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    if cfg.decode_cache_layout == "per_layer":
        per = (batch, max_len, g, hd)
        return DecodeState(
            length=0,
            kv_layers_k=tuple(torch.zeros(per, dtype=dtype, device=device)
                              for _ in range(cfg.n_layers)),
            kv_layers_v=tuple(torch.zeros(per, dtype=dtype, device=device)
                              for _ in range(cfg.n_layers)),
        )
    kv = (cfg.n_layers, batch, max_len, g, hd)
    return DecodeState(length=0, kv_k=torch.zeros(kv, dtype=dtype, device=device),
                       kv_v=torch.zeros(kv, dtype=dtype, device=device))


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Model, token: torch.Tensor, state: DecodeState):
    """token: (B, 1) ints → (logits (B, 1, vocab_size), state advanced by one)."""
    check_supported(cfg)
    params = _cast(params, cfg)
    h = _embed(params, cfg, token)
    length = state.length
    for i, lp in enumerate(params.layers):
        if state.kv_layers_k is not None:
            kc, vc = state.kv_layers_k[i], state.kv_layers_v[i]
        else:
            kc, vc = state.kv_k[i], state.kv_v[i]
        a, _, _ = attention_decode(rms_norm(h, lp.attn_norm, cfg.norm_eps), lp.attn, cfg,
                                   kc, vc, length)
        h = h + a
        hn = rms_norm(h, lp.mlp_norm, cfg.norm_eps)
        h = h + (glu_mlp(hn, lp.mlp, cfg.mlp_type) if cfg.mlp_type != "none"
                 else torch.zeros_like(h))
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    logits = _logits(params, cfg, h)[..., : cfg.vocab_size]  # drop pad ids
    return logits, state._replace(length=length + 1)


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Model, tokens: torch.Tensor, max_len: int):
    """Full-sequence prefill with reference attention (as the JAX package
    has it), returning the last position's logits (B, 1, vocab_size) and a
    primed stacked ``DecodeState``."""
    check_supported(cfg)
    params_c = _cast(params, cfg)
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"prefill: {s} prompt tokens exceed max_len {max_len}")
    h = _embed(params_c, cfg, tokens)
    positions = torch.arange(s, device=h.device).expand(b, s)
    cache_dt = torch_dtype(cfg.dtype)
    shape = (cfg.n_layers, b, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    ks = torch.zeros(shape, dtype=cache_dt, device=h.device)
    vs = torch.zeros(shape, dtype=cache_dt, device=h.device)
    for i, lp in enumerate(params_c.layers):
        x = rms_norm(h, lp.attn_norm, cfg.norm_eps)
        q, k, v = _project_qkv(x, lp.attn, cfg, positions)
        o = _sdpa_reference(q, k, v, causal=True)
        h = h + o.reshape(b, s, -1) @ lp.attn.wo
        hn = rms_norm(h, lp.mlp_norm, cfg.norm_eps)
        h = h + (glu_mlp(hn, lp.mlp, cfg.mlp_type) if cfg.mlp_type != "none"
                 else torch.zeros_like(h))
        ks[i, :, :s] = k.to(cache_dt)
        vs[i, :, :s] = v.to(cache_dt)
    h = rms_norm(h, params_c.final_norm, cfg.norm_eps)
    logits = _logits(params_c, cfg, h[:, -1:])[..., : cfg.vocab_size]
    return logits, DecodeState(length=s, kv_k=ks, kv_v=vs)
