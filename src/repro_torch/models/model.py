"""Model facade of the port, for every family of the JAX package: dense and
MoE decoders (smollm, qwen, gemma3, mixtral, grok), SSM (mamba2), hybrid
(zamba2), encoder-decoder (whisper) and VLM (paligemma).

    model = Model(cfg, rt)                      # random init from a seed
    cache = init_cache(cfg, rt, batch, max_len)
    logits, cache = model.prefill(tokens, cache)       # last-token logits
    # pos: the absolute position of `tokens`, a scalar or per slot (B,);
    # the attention families need it, an SSM cache carries its own state
    logits, cache = model.decode_step(tokens, cache, pos=pos)   # tokens (B, 1)
    logits = model(tokens)                      # full-sequence scoring
    loss, metrics = loss_fn(model, {"tokens": ..., "labels": ...})
    # encdec: frames (B, encoder_len, D) are the precomputed audio frames
    logits, cache = model.prefill(tokens, cache, frames=frames)
    logits = model(tokens, frames=frames)
    # vlm: patches (B, prefix_len, D) are the precomputed image patch
    # embeddings, prepended to the text; the logits cover both
    logits, cache = model.prefill(tokens, cache, patches=patches)
    logits = model(tokens, patches=patches)

Parameters live on `rt.device` in `rt.param_dtype` and are cast to
`rt.compute_dtype` where they are used, as in `repro`. They are created
with requires_grad=False, so scoring and serving build no autograd graph;
the trainer (`train/train_step.py`) turns them on. `forward`,
`forward_with_aux` and `loss_fn` follow torch's grad mode (they are
differentiable once the parameters require grad); `prefill`, `decode_step`
and `reset_parameters` always run under no_grad. The logits are fp32,
against the tied embedding or the separate `unembed`. prefill and
decode_step update `cache` in place and return it.

Under a mesh (`rt.mesh`) the parameters are DTensors laid out by
`repro`'s rules (`dist.sharding.distribute_model`, right after the random
init, which every rank draws alike from the seed), the inputs are DTensors
(`batch_specs`), and every op runs on DTensors: the embedding gather
(vocab over "model"), the fp32 logits and `loss_fn`'s log-softmax, which
DTensor gathers over the vocab.

The model leaves the process-wide TF32 switches alone. The entry points
(`launch/serve.py`, `chip_smoke.py`) set `torch.backends.cuda.matmul.allow_tf32`
and `torch.backends.cudnn.allow_tf32` to False, so that float32 products run
in full fp32 on the card as they do in `repro`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, transformer
from repro_torch.models.layers import embed_init_, rmsnorm
from repro_torch.models.mamba2 import SSMBlock, init_ssm_cache
from repro_torch.models.runtime import Runtime, mesh_ops, remat_block, residual, weight

# the families whose layers are the decoder stack of `models.transformer`
DECODER_FAMILIES = ("dense", "moe", "vlm")


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, rt: Runtime, seed: Optional[int] = 0):
        """Random init from `seed` (a torch.Generator on the device), unless
        `rt.device` is "meta" or `seed` is None (weights loaded later)."""
        super().__init__()
        dev = rt.torch_device()
        self.cfg, self.rt = cfg, rt
        kw = {"device": dev, "dtype": rt.param_dtype}
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model, **kw))
        self.final_ln = nn.Parameter(torch.zeros(cfg.d_model, **kw))
        if not cfg.tied_embeddings:
            self.unembed = nn.Parameter(torch.empty(cfg.d_model, cfg.vocab, **kw))
        if cfg.family in DECODER_FAMILIES:
            self.layers = nn.ModuleList(
                transformer.DecoderLayer(cfg, **kw) for _ in range(cfg.num_layers))
        elif cfg.family == "ssm":
            self.layers = nn.ModuleList(
                SSMBlock(cfg, **kw) for _ in range(cfg.num_layers))
        elif cfg.family == "hybrid":
            self.layers = hybrid.HybridLayers(cfg, **kw)
        else:
            self.enc_layers = nn.ModuleList(
                encdec.EncoderLayer(cfg, **kw) for _ in range(cfg.encoder_layers))
            self.enc_ln = nn.Parameter(torch.zeros(cfg.d_model, **kw))
            self.dec_layers = nn.ModuleList(
                encdec.DecoderLayer(cfg, **kw) for _ in range(cfg.num_layers))
        self.requires_grad_(False)
        if dev.type != "meta" and seed is not None:
            self.reset_parameters(torch.Generator(dev).manual_seed(seed))
        if rt.mesh is not None:
            from repro_torch.dist.sharding import distribute_model
            distribute_model(self, rt.mesh)

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator):
        embed_init_(self.embed, g)
        if not self.cfg.tied_embeddings:
            embed_init_(self.unembed, g)
        self.final_ln.zero_()
        if self.cfg.family == "encdec":
            self.enc_ln.zero_()
        if self.cfg.family == "hybrid":
            layers = [self.layers]
        elif self.cfg.family == "encdec":
            layers = [*self.enc_layers, *self.dec_layers]
        else:
            layers = self.layers
        for layer in layers:
            layer.reset_parameters(g)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        # gather then cast: the same values as repro's cast-then-gather
        # (under a mesh as an embedding op, which DTensor shards over vocab)
        if self.rt.mesh is not None:
            return residual(_embed_mesh(tokens, self.embed).to(self.rt.compute_dtype), self.rt)
        return self.embed[tokens].to(self.rt.compute_dtype)

    def _embed_vlm(self, tokens: torch.Tensor, patches: Optional[torch.Tensor]
                   ) -> torch.Tensor:
        """[patches | text embeddings] (B, prefix_len + S, D)."""
        if patches is None or patches.shape[1] != self.cfg.prefix_len:
            raise ValueError(f"the vlm family needs patches (B, {self.cfg.prefix_len}, "
                             "d_model)")
        return torch.cat([patches.to(self.rt.compute_dtype), self._embed(tokens)], dim=1)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(x, self.final_ln, self.cfg.norm_eps)
        if self.cfg.tied_embeddings:
            return x.float() @ weight(self.embed, self.rt, torch.float32).T
        return x.float() @ weight(self.unembed, self.rt, torch.float32)

    def _encode(self, frames: Optional[torch.Tensor]) -> torch.Tensor:
        if frames is None:
            raise ValueError("the encdec family needs frames (B, encoder_len, d_model)")
        enc_out = encdec.encode(frames, self.enc_layers, self.cfg, self.rt)
        return rmsnorm(enc_out, self.enc_ln, self.cfg.norm_eps)

    def forward(self, tokens: torch.Tensor, frames: Optional[torch.Tensor] = None,
                patches: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence logits (B, S, V), fp32 (`loss_fn` scores them); for
        the vlm (B, prefix_len + S, V)."""
        return self.forward_with_aux(tokens, frames, patches)[0]

    def forward_with_aux(self, tokens: torch.Tensor, frames: Optional[torch.Tensor] = None,
                         patches: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(full-sequence logits, aux loss): the MoE layers' summed
        load-balancing loss, a () fp32 tensor, 0 for the other families."""
        with mesh_ops(self.rt):
            return self._forward_with_aux(tokens, frames, patches)

    def _forward_with_aux(self, tokens, frames, patches):
        fam = self.cfg.family
        x = self._embed_vlm(tokens, patches) if fam == "vlm" else self._embed(tokens)
        B, S = x.shape[:2]
        aux = torch.zeros((), device=tokens.device)
        if fam in DECODER_FAMILIES:
            positions = encdec.iota_positions(B, S, tokens.device)
            x, aux = transformer.decoder_stack(x, self.layers, self.cfg, self.rt, positions,
                                               prefix_len=self.cfg.prefix_len)
        elif fam == "ssm":
            for layer in self.layers:
                x = remat_block(self.rt, layer, x, self.rt, probe=layer.ln)
        elif fam == "hybrid":
            positions = encdec.iota_positions(B, S, tokens.device)
            x = hybrid.hybrid_forward(x, self.layers, self.cfg, self.rt, positions)
        else:
            positions = encdec.iota_positions(B, S, tokens.device)
            x = encdec.decode_stack(x, self.dec_layers, self.cfg, self.rt, positions,
                                    self._encode(frames))
        return self._logits(x), aux

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: Dict,
                frames: Optional[torch.Tensor] = None,
                patches: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict]:
        """Fill `cache` from position 0; returns (last-token logits (B, V), cache).
        The encdec family runs the encoder over `frames`, fills the cross
        K/V and prefills the decoder's self cache with `tokens`; the vlm
        prefills [patches | tokens], so its next position is prefix_len + S."""
        fam = self.cfg.family
        x = self._embed_vlm(tokens, patches) if fam == "vlm" else self._embed(tokens)
        if fam in DECODER_FAMILIES:
            x, cache["attn"] = transformer.decoder_stack_decode(
                x, self.layers, self.cfg, self.rt, cache["attn"], 0,
                prefix_len=self.cfg.prefix_len)
        elif fam == "ssm":
            for i, layer in enumerate(self.layers):
                x, cache["conv"][i], cache["ssd"][i] = layer.prefill(
                    x, self.rt, cache["conv"][i])
        elif fam == "hybrid":
            x, cache = hybrid.hybrid_prefill(x, self.layers, self.cfg, self.rt, cache)
        else:
            encdec.fill_cross_cache(self._encode(frames), self.dec_layers, self.cfg,
                                    self.rt, cache)
            x, cache = encdec.decode_stack_cached(x, self.dec_layers, self.cfg, self.rt,
                                                  cache, 0)
        return self._logits(x[:, -1:])[:, 0], cache

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: Dict, pos=None
                    ) -> Tuple[torch.Tensor, Dict]:
        """One autoregressive step. tokens (B, 1) -> logits (B, V). The
        attention families need `pos`, the absolute position of `tokens`: a
        scalar, or (B,) per slot (an SSM cache carries its own state)."""
        if pos is None and self.cfg.family != "ssm":
            raise ValueError(f"the {self.cfg.family} family's decode_step needs pos")
        x = self._embed(tokens)
        if self.cfg.family in DECODER_FAMILIES:
            x, cache["attn"] = transformer.decoder_stack_decode(
                x, self.layers, self.cfg, self.rt, cache["attn"], pos,
                prefix_len=self.cfg.prefix_len)
        elif self.cfg.family == "ssm":
            for i, layer in enumerate(self.layers):
                x, cache["conv"][i], cache["ssd"][i] = layer.decode(
                    x, self.rt, cache["conv"][i], cache["ssd"][i])
        elif self.cfg.family == "hybrid":
            x, cache = hybrid.hybrid_decode(x, self.layers, self.cfg, self.rt, cache, pos)
        else:
            x, cache = encdec.decode_stack_cached(x, self.dec_layers, self.cfg, self.rt,
                                                  cache, pos)
        return self._logits(x)[:, 0], cache


def _embed_mesh(tokens, w):
    """Vocab-parallel gather on DTensors: the table's d_model shards are
    gathered over the data axes, each rank looks its tokens up in its own
    vocab rows (0 for a token outside them) and the result is a partial sum
    over the mesh dim that shards the vocab. tokens (B, S) keep their
    placements; the table's gradient comes back partial over the data axes
    that shard them, and its redistribution sums it."""
    mesh = w.device_mesh
    w_pl = tuple(pl if pl.is_shard(0) else Replicate() for pl in w.placements)
    w = w.redistribute(mesh, w_pl)
    vocab_dim = next((i for i, pl in enumerate(w_pl) if pl.is_shard(0)), None)
    out_pl = tuple(Partial() if i == vocab_dim else pl for i, pl in enumerate(tokens.placements))
    grad_pl = tuple(Partial() if tp.is_shard() else wp
                    for tp, wp in zip(tokens.placements, w_pl))
    coord = mesh.get_coordinate()

    def lookup(t, w_l):
        if vocab_dim is None:
            return w_l[t]
        rows = w_l.shape[0]
        idx = t - coord[vocab_dim] * rows
        inside = (idx >= 0) & (idx < rows)
        return w_l[idx.clamp(0, rows - 1)] * inside[..., None].to(w_l.dtype)
    return local_map(lookup, out_placements=list(out_pl), in_placements=(tokens.placements, w_pl),
                     in_grad_placements=(tokens.placements, grad_pl), device_mesh=mesh)(tokens, w)


def loss_fn(model: Model, batch: Dict, aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross entropy over the labels >= 0 (fp32 log-softmax)
    plus `aux_weight` times the MoE aux loss. batch: "tokens", "labels"
    (B, S) and, for encdec, "frames", for the vlm "patches" (the labels
    cover the text only). Returns (loss, {"ce", "aux", "tokens"})."""
    logits, aux = model.forward_with_aux(batch["tokens"], batch.get("frames"),
                                         batch.get("patches"))
    if model.cfg.family == "vlm":
        logits = logits[:, model.cfg.prefix_len:]
    labels = batch["labels"]
    mask = (labels >= 0).float()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.clamp_min(0)[..., None].long())[..., 0]
    denom = mask.sum().clamp_min(1.0)
    ce = (nll * mask).sum() / denom
    return ce + aux_weight * aux, {"ce": ce, "aux": aux, "tokens": denom}


def init_cache(cfg: ModelConfig, rt: Runtime, batch: int, max_len: int) -> Dict:
    """dense/moe/vlm: {"attn": the stack's KV cache
    (`transformer.init_decoder_cache`)}; the vlm's `max_len` counts the
    prefix too. SSM: {"conv": (L, B, K-1, C), "ssd": (L, B, H, P, N) fp32};
    an SSM cache does not grow with `max_len`. hybrid: {"ssm": the SSM
    layers' cache, "attn": one KV layer per application of the shared block}
    (`hybrid.init_hybrid_cache`). encdec: the decoder's self cache of
    `max_len` slots and the cross K/V (`encdec.init_encdec_cache`)."""
    if cfg.family in DECODER_FAMILIES:
        return {"attn": transformer.init_decoder_cache(cfg, batch, max_len,
                                                       cfg.num_layers, rt)}
    if cfg.family == "ssm":
        return init_ssm_cache(cfg, batch, cfg.num_layers, rt)
    if cfg.family == "hybrid":
        return hybrid.init_hybrid_cache(cfg, batch, max_len, rt)
    return encdec.init_encdec_cache(cfg, batch, max_len, rt)
