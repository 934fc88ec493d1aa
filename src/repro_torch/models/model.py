"""Model assembly: parameters, the training forward, the prefill-style
forward, and decode (port of ``repro.models.model``) for the attention
family (dense, or experts: ``moe``, plus ``dense_mlp`` where
``moe_dense_residual``), the Mamba2 hybrid (``zamba_hybrid``: groups of
``shared_attn_every`` Mamba layers, each group followed by ONE shared
attention + MLP block, then a tail of Mamba layers) and xLSTM (``xlstm``:
an sLSTM block every ``slstm_every``-th layer, mLSTM blocks elsewhere).

Two attention-family variants take extra inputs in the batch.  The vision
stub (``modality="vision_stub"``) puts ``batch["patch_embeds"]`` (B,
``n_prefix_tokens``, d) in front of the text embeddings, attends causally
over both and keeps the text positions after the final norm.  The
encoder-decoder (``encoder_decoder``) encodes ``batch["frame_embeds"]`` (B,
S_enc, d) by a non-causal stack (``_encoder_stack``) and gives each decoder
layer a cross-attention between its self-attention and its MLP.  In decode
the cross-attention reads ``DecodeState.cross_k`` / ``cross_v``, which a
caller primes from ``_encoder_stack`` and ``encode_cross_kv``, as the JAX
package's tests do; the vision stub decodes text only.

Parameters are ``nn.Module``s holding ``nn.Parameter``s named and oriented
as in the JAX parameter tree, with an ``nn.ModuleList`` where JAX scans
stacked parameters: ``layers.<i>`` for the L attention layers,
``encoder.layers.<i>`` for the encoder's, ``mamba_groups.<g>.<i>`` for the
hybrid's (groups, every) stack and ``mamba_tail.<i>`` for its tail; xLSTM's
``layers`` is an ``nn.ModuleDict`` keyed ``mlstm_<i>`` / ``slstm_<i>``, as
in the JAX tree.  ``prefill`` and the serving engine take the attention
family but the encoder-decoder, as in the JAX package (the vision stub as
text only); the hybrid and xLSTM serve by ``forward_logits`` and
token-by-token ``decode_step``.

``forward_train`` is differentiable in the parameters: it casts them to the
compute dtype through autograd (``_cast_tree``), rematerializes each layer
as ``cfg.remat`` says, and adds ``AUX_LOSS_WEIGHT`` times the experts'
load-balance loss summed over the layers.  ``forward_logits``, ``prefill`` and
``decode_step`` are inference entry points and run without autograd.
Decode writes the KV caches of a ``DecodeState`` in place (the JAX package
returns updated copies); the state it returns carries the advanced length.
"""
from __future__ import annotations

import functools
import itertools
import types
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..configs.base import ModelConfig
from ..core.torch_scheduler import resolve_device
from .attention import (
    _project_qkv,
    _sdpa_reference,
    attention,
    attention_decode,
    attn_defs,
    cross_attention,
    encode_cross_kv,
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
from . import xlstm as xl
from .moe import moe_defs, moe_ffn
from .ssm import MambaState, mamba_decode_step, mamba_defs, mamba_forward, mamba_init_state

#: weight of the experts' auxiliary loss
AUX_LOSS_WEIGHT = 0.01
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16,
           "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a block pattern the JAX package does not have."""
    if cfg.block_pattern not in ("attention", "zamba_hybrid", "xlstm"):
        raise ValueError(cfg.block_pattern)


def check_prefill(cfg: ModelConfig) -> None:
    """``prefill`` and the serving engine take the attention family but the
    encoder-decoder (the JAX package asserts ``block_pattern == "attention"
    and not cfg.encoder_decoder`` in both)."""
    check_supported(cfg)
    if cfg.block_pattern != "attention":
        raise ValueError(f"{cfg.name}: prefill and the serving engine take the attention "
                         f"family; {cfg.block_pattern} serves by forward_logits and decode_step")
    if cfg.encoder_decoder:
        raise ValueError(f"{cfg.name}: prefill and the serving engine do not take the "
                         "encoder-decoder (its decoder needs the encoder's output); it serves "
                         "by decode_step with primed cross caches")


def _is_slstm(cfg: ModelConfig, i: int) -> bool:
    return i % cfg.slstm_every == cfg.slstm_every - 1


def _xlstm_name(cfg: ModelConfig, i: int) -> str:
    return f"{'slstm' if _is_slstm(cfg, i) else 'mlstm'}_{i}"


#: every subtree any JAX tree stacks, by prefix, and the number of leading
#: axes its stack adds (``stacks`` gives a config's own); a port name
#: ``<prefix>.<i>[.<j>].<rest>`` is entry (i[, j]) of the stacked leaf
#: ``<prefix>.<rest>``.  A prefix may have several parts (``encoder.layers``),
#: so a name is matched by ``stack_prefix``, never split at its first dot.
#: xLSTM's ``layers`` holds ``mlstm_<i>`` / ``slstm_<i>`` subtrees, which
#: the JAX tree keeps unstacked.
STACK_DEPTH = {"layers": 1, "encoder.layers": 1, "mamba_groups": 2, "mamba_tail": 1}


def stack_prefix(name: str, prefixes) -> Optional[str]:
    """The longest of ``prefixes`` that ``name`` begins with, whole parts
    followed by a dot (``encoder.layers.3.attn.wq`` → ``encoder.layers``,
    ``layers.3.attn.wq`` → ``layers``), or None."""
    return max((p for p in prefixes if name.startswith(p + ".")), key=len, default=None)


def stacks(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], int]]:
    """The JAX tree's stacked subtrees: prefix → (its leading stack shape,
    the fan-in the JAX package's init gives a normal leaf there: the outer
    stack count, ``d.shape[0]`` of the stacked definition)."""
    if cfg.block_pattern == "attention":
        out = {"layers": ((cfg.n_layers,), cfg.n_layers)}
        if cfg.encoder_decoder:
            out["encoder.layers"] = ((cfg.n_encoder_layers,), cfg.n_encoder_layers)
    elif cfg.block_pattern == "zamba_hybrid":
        groups, tail = divmod(cfg.n_layers, cfg.shared_attn_every)
        out = {"mamba_groups": ((groups, cfg.shared_attn_every), groups)}
        if tail:
            out["mamba_tail"] = ((tail,), tail)
    else:
        out = {}
    assert all(len(lead) == STACK_DEPTH[prefix] for prefix, (lead, _) in out.items())
    return out


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
    """One transformer block; ``cross`` adds the encoder-decoder's
    ``cross_norm`` and ``cross`` (its cross-attention, no biases)."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=torch.float32, cross: bool = False):
        super().__init__()
        d = cfg.d_model
        self.attn_norm = nn.Parameter(torch.empty(d, device=device, dtype=dtype))
        self.attn = ParamGroup(attn_defs(cfg), device, dtype)
        if cross:
            self.cross_norm = nn.Parameter(torch.empty(d, device=device, dtype=dtype))
            self.cross = ParamGroup(attn_defs(cfg, cross=True), device, dtype)
        self.mlp_norm = nn.Parameter(torch.empty(d, device=device, dtype=dtype))
        if cfg.is_moe:
            self.moe = ParamGroup(moe_defs(cfg), device, dtype)
            if cfg.moe_dense_residual:
                self.dense_mlp = ParamGroup(mlp_defs(d, cfg.d_ff), device, dtype)
        elif cfg.mlp_type != "none":
            self.mlp = ParamGroup(mlp_defs(d, cfg.d_ff), device, dtype)


class EncoderLayer(nn.Module):
    """One layer of the encoder-decoder's encoder: attention and an MLP."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        self.attn_norm = nn.Parameter(torch.empty(d, device=device, dtype=dtype))
        self.attn = ParamGroup(attn_defs(cfg), device, dtype)
        self.mlp_norm = nn.Parameter(torch.empty(d, device=device, dtype=dtype))
        self.mlp = ParamGroup(mlp_defs(d, cfg.d_ff), device, dtype)


class Encoder(nn.Module):
    """The encoder-decoder's encoder: ``layers`` and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(cfg, device, dtype)
                                    for _ in range(cfg.n_encoder_layers))
        self.final_norm = nn.Parameter(torch.empty(cfg.d_model, device=device, dtype=dtype))


class Model(nn.Module):
    """The parameters of one model: ``embed``, ``final_norm``, ``lm_head``
    (untied only), ``layers`` and, for the encoder-decoder, ``encoder``,
    uninitialized (``device=None`` is the card; ``"meta"`` allocates
    nothing)."""

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
        if cfg.block_pattern == "attention":
            self.layers = nn.ModuleList(DecoderLayer(cfg, device, dtype, cross=cfg.encoder_decoder)
                                        for _ in range(cfg.n_layers))
            if cfg.encoder_decoder:
                self.encoder = Encoder(cfg, device, dtype)
        elif cfg.block_pattern == "zamba_hybrid":
            groups, tail = divmod(cfg.n_layers, cfg.shared_attn_every)
            mamba = lambda: ParamGroup(mamba_defs(cfg), device, dtype)  # noqa: E731
            self.mamba_groups = nn.ModuleList(
                nn.ModuleList(mamba() for _ in range(cfg.shared_attn_every))
                for _ in range(groups))
            if tail:
                self.mamba_tail = nn.ModuleList(mamba() for _ in range(tail))
            # the shared block: attention + MLP, one set of weights for every group
            self.shared = DecoderLayer(cfg, device, dtype)
        else:
            self.layers = nn.ModuleDict({
                _xlstm_name(cfg, i): ParamGroup(
                    xl.slstm_defs(cfg) if _is_slstm(cfg, i) else xl.mlstm_defs(cfg), device, dtype)
                for i in range(cfg.n_layers)})


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """ParamDef tree of the JAX package's ``model_defs``, a stacked subtree
    (``stacks``) holding one layer's definitions: the port keeps a module a
    layer where JAX stacks them, so a stacked expert leaf (L, E, D, F) is L
    leaves (E, D, F), and a hybrid leaf (groups, every, ...) groups × every
    leaves."""
    check_supported(cfg)
    d, v = cfg.d_model, cfg.vocab_padded
    defs: Dict[str, Any] = {
        "embed": ParamDef((v, d), init="embed", scale=0.02),
        "final_norm": norm_defs(d),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, v), scale=1.0)
    block: Dict[str, Any] = {"attn_norm": norm_defs(d), "attn": attn_defs(cfg),
                             "mlp_norm": norm_defs(d)}
    if cfg.block_pattern == "zamba_hybrid":
        for prefix in stacks(cfg):
            defs[prefix] = mamba_defs(cfg)
        defs["shared"] = {**block, "mlp": mlp_defs(d, cfg.d_ff)}
    elif cfg.block_pattern == "xlstm":
        defs["layers"] = {_xlstm_name(cfg, i): xl.slstm_defs(cfg) if _is_slstm(cfg, i)
                          else xl.mlstm_defs(cfg) for i in range(cfg.n_layers)}
    else:
        if cfg.encoder_decoder:
            defs["encoder"] = {"layers": {**block, "mlp": mlp_defs(d, cfg.d_ff)},
                               "final_norm": norm_defs(d)}
            block["cross_norm"] = norm_defs(d)
            block["cross"] = attn_defs(cfg, cross=True)
        if cfg.is_moe:
            block["moe"] = moe_defs(cfg)
            if cfg.moe_dense_residual:
                block["dense_mlp"] = mlp_defs(d, cfg.d_ff)
        elif cfg.mlp_type != "none":
            block["mlp"] = mlp_defs(d, cfg.d_ff)
        defs["layers"] = block
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
    stacked = stacks(cfg)
    for name, d in _leaves(model_defs(cfg)):
        prefix = stack_prefix(name, stacked)
        if prefix is not None:
            # JAX draws a scanned stack at once: its fan-in is the outer count
            rest = name[len(prefix) + 1:]
            shape, fan_in = stacked[prefix]
            for index in itertools.product(*map(range, shape)):
                key = ".".join((prefix, *map(str, index), rest))
                params[key].copy_(init_leaf(d, generator, device, dtype, fan_in=fan_in))
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
    if isinstance(module, nn.ModuleList):
        return [_cast_tree(c, dt) for c in module]
    out = types.SimpleNamespace()
    for name, p in module.named_parameters(recurse=False):
        setattr(out, name, p.to(dt) if p.dtype == torch.float32 else p)
    for name, child in module.named_children():
        setattr(out, name, _cast_tree(child, dt))
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


def _ffn(hn, lp, cfg: ModelConfig):
    """The block's feed-forward half → (y, the experts' auxiliary loss)."""
    if cfg.is_moe:
        y, aux = moe_ffn(hn, lp.moe, cfg)
        if cfg.moe_dense_residual:
            y = y + glu_mlp(hn, lp.dense_mlp, cfg.mlp_type)
        return y, aux
    aux = torch.zeros((), dtype=torch.float32, device=hn.device)
    if cfg.mlp_type != "none":
        return glu_mlp(hn, lp.mlp, cfg.mlp_type), aux
    return torch.zeros_like(hn), aux


def _attn_layer(h, lp: DecoderLayer, cfg: ModelConfig, positions, causal: bool = True,
                enc_out=None):
    """One transformer block → (h, the experts' auxiliary loss); with
    ``enc_out`` (the encoder's output), the cross-attention over it between
    the self-attention and the MLP."""
    a = attention(rms_norm(h, lp.attn_norm, cfg.norm_eps), lp.attn, cfg, positions,
                  causal=causal)
    h = h + a
    if enc_out is not None:
        ek, ev = encode_cross_kv(enc_out, lp.cross, cfg)
        h = h + cross_attention(rms_norm(h, lp.cross_norm, cfg.norm_eps), lp.cross, cfg, ek, ev)
    y, aux = _ffn(rms_norm(h, lp.mlp_norm, cfg.norm_eps), lp, cfg)
    return h + y, aux


#: the products ``remat="dots"`` keeps: those without batch dimensions
#: (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``); ``x @ w``
#: with a 2-D ``w`` runs as ``aten.mm``, while the attention einsums and the
#: expert products, which have batch dimensions, run as ``bmm`` and are
#: recomputed with everything else
_SAVED_PRODUCTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn, cfg: ModelConfig):
    """``cfg.remat``: ``"none"`` runs ``fn``; ``"full"`` saves only its
    inputs and recomputes it in the backward (``jax.checkpoint``); ``"dots"``
    also saves the outputs of the products without batch dimensions."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    if cfg.remat == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
        return lambda *args: checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _decoder_stack(h, params, cfg: ModelConfig, positions, enc_out=None):
    """The layers in turn (each attending over ``enc_out`` too, where given)
    → (h, the auxiliary loss summed over them)."""
    layer = _maybe_remat(_attn_layer, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp in params.layers:
        h, a = layer(h, lp, cfg, positions, True, enc_out)
        aux = aux + a
    return h, aux


def _encoder_stack(enc_in, params, cfg: ModelConfig):
    """The encoder-decoder's encoder on ``enc_in`` (B, S_enc, d): its layers
    non-causal over positions 0..S_enc-1 (each rematerialized as
    ``cfg.remat`` says), then ``encoder.final_norm``."""
    b, s = enc_in.shape[:2]
    positions = torch.arange(s, device=enc_in.device).expand(b, s)
    layer = _maybe_remat(_attn_layer, cfg)
    h = enc_in
    for lp in params.encoder.layers:
        h, _ = layer(h, lp, cfg, positions, False)
    return rms_norm(h, params.encoder.final_norm, cfg.norm_eps)


def _zamba_group(h, gp, shared, cfg: ModelConfig, positions):
    """One group of the hybrid: its Mamba layers, then the shared block."""
    for lp in gp:
        h = h + mamba_forward(h, lp, cfg)
    return _attn_layer(h, shared, cfg, positions)[0]


def _zamba_stack(h, params, cfg: ModelConfig, positions):
    """The hybrid's groups (each rematerialized as ``cfg.remat`` says, as the
    JAX package's scanned group body), then its tail."""
    group = _maybe_remat(_zamba_group, cfg)
    for gp in params.mamba_groups:
        h = group(h, gp, params.shared, cfg, positions)
    for lp in getattr(params, "mamba_tail", ()):
        h = h + mamba_forward(h, lp, cfg)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def _xlstm_stack(h, params, cfg: ModelConfig):
    """The xLSTM blocks in turn, unrolled as in the JAX package."""
    for i in range(cfg.n_layers):
        fwd = xl.slstm_forward if _is_slstm(cfg, i) else xl.mlstm_forward
        h = h + fwd(h, getattr(params.layers, _xlstm_name(cfg, i)), cfg)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def _forward_hidden(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """Embeddings (the vision stub's ``patch_embeds`` in front) → block stack
    (over the encoded ``frame_embeds`` for the encoder-decoder) → final norm
    → (h over the text positions, auxiliary loss)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    b, s_text = tokens.shape
    h = _embed(params, cfg, tokens)
    enc_out = None
    if cfg.modality == "vision_stub":
        h = torch.cat([batch["patch_embeds"].to(h.dtype), h], dim=1)
    if cfg.encoder_decoder:
        enc_out = _encoder_stack(batch["frame_embeds"].to(h.dtype), params, cfg)
    s = h.shape[1]
    positions = torch.arange(s, device=h.device).expand(b, s)
    if cfg.block_pattern == "zamba_hybrid":
        h, aux = _zamba_stack(h, params, cfg, positions)
    elif cfg.block_pattern == "xlstm":
        h, aux = _xlstm_stack(h, params, cfg)
    else:
        h, aux = _decoder_stack(h, params, cfg, positions, enc_out)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    if cfg.modality == "vision_stub":       # the text positions only
        h = h[:, -s_text:]
    return h, aux


def forward_train(cfg: ModelConfig, params: Model, batch: Dict[str, torch.Tensor]):
    """Causal-LM loss of ``batch["tokens"]`` against ``batch["labels"]``
    (token mean, f32, z-loss 1e-4) plus ``AUX_LOSS_WEIGHT`` times the
    experts' load-balance loss → ``(loss, {"lm_loss", "aux_loss"})``;
    differentiable in ``params``.  ``aux_loss`` is the weighted term (0
    without experts).  The vision stub also takes ``patch_embeds``, the
    encoder-decoder ``frame_embeds``; the labels cover the text positions."""
    check_supported(cfg)
    pc = _cast_tree(params, torch_dtype(cfg.dtype))
    h, aux = _forward_hidden(cfg, pc, batch)
    loss = cross_entropy_loss(_logits(pc, cfg, h), batch["labels"])
    aux_total = AUX_LOSS_WEIGHT * aux
    return loss + aux_total, {"lm_loss": loss.detach(), "aux_loss": aux_total.detach()}


@torch.no_grad()
def forward_logits(cfg: ModelConfig, params: Model, batch: Dict[str, torch.Tensor],
                   last_only: bool = True) -> torch.Tensor:
    """Prefill-style forward: logits (last position by default), over the
    padded vocabulary, no loss; the text positions only (``batch`` as for
    ``forward_train``, without labels)."""
    params = _cast(params, cfg)
    h, _ = _forward_hidden(cfg, params, batch)
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
    #: the hybrid: ``MambaState``s stacked (groups, every, ...) and (tail, ...)
    mamba_groups: Optional[MambaState] = None
    mamba_tail: Optional[MambaState] = None
    #: the shared block's caches, one per application: (groups,B,S,G,hd)
    shared_k: Optional[torch.Tensor] = None
    shared_v: Optional[torch.Tensor] = None
    #: xLSTM: an ``MLSTMState`` or ``SLSTMState`` a layer
    xlstm: Optional[Tuple] = None
    #: the encoder-decoder's cross-attention keys and values, in both
    #: layouts: (L,B,S_enc,G,hd)
    cross_k: Optional[torch.Tensor] = None
    cross_v: Optional[torch.Tensor] = None


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                      device=None, enc_len: int = 0) -> DecodeState:
    """An empty decode state.  ``dtype`` is the KV caches' type; the
    recurrent states are f32 (the Mamba conv window too), as in the JAX
    package.  The encoder-decoder's ``cross_k`` / ``cross_v`` hold
    ``enc_len`` positions (``max_len`` where 0) and start as zeros, for the
    caller to prime from ``_encoder_stack`` and ``encode_cross_kv``."""
    check_supported(cfg)
    device = resolve_device(device)
    g, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    if cfg.block_pattern == "zamba_hybrid":
        groups, tail = divmod(cfg.n_layers, cfg.shared_attn_every)
        one = mamba_init_state(cfg, batch, device=device)
        stacked = lambda lead: MambaState(*(  # noqa: E731
            x.expand(*lead, *x.shape).clone() for x in one))
        sk = (groups, batch, max_len, g, hd)
        return DecodeState(length=0, mamba_groups=stacked((groups, cfg.shared_attn_every)),
                           mamba_tail=stacked((tail,)) if tail else None,
                           shared_k=torch.zeros(sk, dtype=dtype, device=device),
                           shared_v=torch.zeros(sk, dtype=dtype, device=device))
    if cfg.block_pattern == "xlstm":
        return DecodeState(length=0, xlstm=tuple(
            xl.slstm_init_state(cfg, batch, device=device) if _is_slstm(cfg, i)
            else xl.mlstm_init_state(cfg, batch, device=device) for i in range(cfg.n_layers)))
    if cfg.decode_cache_layout == "per_layer":
        per = (batch, max_len, g, hd)
        state = DecodeState(
            length=0,
            kv_layers_k=tuple(torch.zeros(per, dtype=dtype, device=device)
                              for _ in range(cfg.n_layers)),
            kv_layers_v=tuple(torch.zeros(per, dtype=dtype, device=device)
                              for _ in range(cfg.n_layers)),
        )
    else:
        kv = (cfg.n_layers, batch, max_len, g, hd)
        state = DecodeState(length=0, kv_k=torch.zeros(kv, dtype=dtype, device=device),
                            kv_v=torch.zeros(kv, dtype=dtype, device=device))
    if cfg.encoder_decoder:
        ck = (cfg.n_layers, batch, enc_len or max_len, g, hd)
        state = state._replace(cross_k=torch.zeros(ck, dtype=dtype, device=device),
                               cross_v=torch.zeros(ck, dtype=dtype, device=device))
    return state


def _attn_decode_layer(h, lp, cfg: ModelConfig, kc, vc, length: int, cross=None):
    """One transformer block on one token, its K/V written into kc/vc;
    ``cross``, the layer's (cross_k, cross_v), for the encoder-decoder."""
    a, _, _ = attention_decode(rms_norm(h, lp.attn_norm, cfg.norm_eps), lp.attn, cfg,
                               kc, vc, length)
    h = h + a
    if cross is not None:
        h = h + cross_attention(rms_norm(h, lp.cross_norm, cfg.norm_eps), lp.cross, cfg, *cross)
    y, _ = _ffn(rms_norm(h, lp.mlp_norm, cfg.norm_eps), lp, cfg)
    return h + y


def _mamba_decode_into(h, lp, cfg: ModelConfig, st: MambaState, at) -> torch.Tensor:
    """One Mamba layer on one token, its new state written into ``st[at]``."""
    y, new = mamba_decode_step(h, lp, cfg, MambaState(st.conv[at], st.ssd[at]))
    st.conv[at].copy_(new.conv)
    st.ssd[at].copy_(new.ssd)
    return h + y


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: Model, token: torch.Tensor, state: DecodeState):
    """token: (B, 1) ints → (logits (B, 1, vocab_size), state advanced by
    one).  KV caches and the hybrid's Mamba states are written in place;
    xLSTM's states are replaced."""
    check_supported(cfg)
    params = _cast(params, cfg)
    h = _embed(params, cfg, token)
    length = state.length
    if cfg.block_pattern == "zamba_hybrid":
        for gi, gp in enumerate(params.mamba_groups):
            for i, lp in enumerate(gp):
                h = _mamba_decode_into(h, lp, cfg, state.mamba_groups, (gi, i))
            h = _attn_decode_layer(h, params.shared, cfg, state.shared_k[gi],
                                   state.shared_v[gi], length)
        for i, lp in enumerate(getattr(params, "mamba_tail", ())):
            h = _mamba_decode_into(h, lp, cfg, state.mamba_tail, (i,))
    elif cfg.block_pattern == "xlstm":
        new_states = []
        for i in range(cfg.n_layers):
            step = xl.slstm_decode_step if _is_slstm(cfg, i) else xl.mlstm_decode_step
            y, st = step(h, getattr(params.layers, _xlstm_name(cfg, i)), cfg, state.xlstm[i])
            h = h + y
            new_states.append(st)
        state = state._replace(xlstm=tuple(new_states))
    else:
        for i, lp in enumerate(params.layers):
            if state.kv_layers_k is not None:
                kc, vc = state.kv_layers_k[i], state.kv_layers_v[i]
            else:
                kc, vc = state.kv_k[i], state.kv_v[i]
            cross = (state.cross_k[i], state.cross_v[i]) if cfg.encoder_decoder else None
            h = _attn_decode_layer(h, lp, cfg, kc, vc, length, cross)
    h = rms_norm(h, params.final_norm, cfg.norm_eps)
    logits = _logits(params, cfg, h)[..., : cfg.vocab_size]  # drop pad ids
    return logits, state._replace(length=length + 1)


@torch.no_grad()
def prefill(cfg: ModelConfig, params: Model, tokens: torch.Tensor, max_len: int,
            extras: Optional[Dict[str, torch.Tensor]] = None):
    """Full-sequence prefill with reference attention (as the JAX package
    has it), returning the last position's logits (B, 1, vocab_size) and a
    primed stacked ``DecodeState``.  ``extras`` is accepted and ignored, as
    in the JAX package: the vision stub is prefilled as text only, without
    its patch prefix.  The encoder-decoder is refused (``check_prefill``)."""
    check_prefill(cfg)
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
        y, _ = _ffn(rms_norm(h, lp.mlp_norm, cfg.norm_eps), lp, cfg)   # aux unused, as in JAX
        h = h + y
        ks[i, :, :s] = k.to(cache_dt)
        vs[i, :, :s] = v.to(cache_dt)
    h = rms_norm(h, params_c.final_norm, cfg.norm_eps)
    logits = _logits(params_c, cfg, h[:, -1:])[..., : cfg.vocab_size]
    return logits, DecodeState(length=s, kv_k=ks, kv_v=vs)
