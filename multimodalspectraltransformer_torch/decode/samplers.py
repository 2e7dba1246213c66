"""Samplers over the KV-cached decoder step: greedy, multinomial fan-out and
beam search.

Counterpart of the JAX package's ``decode/samplers.py``. Each sampler is a
Python loop over ``functional.decoder_step`` (beam search: over
``functional.beam_decoder_step``); fan-out lanes and beams are a batch
dimension (sample-major, ``[B, fanout]`` flattened) and share each sample's
cross K/V. Finished lanes (<EOS> or <PAD>) are frozen to <PAD> with
probability 0, so extra steps after every lane has finished change nothing:
the loop tests for early exit every ``EXIT_CHECK_EVERY`` steps, which saves a
device->host sync per step. (A finished beam's only continuation is <PAD> at
no cost, so an extra beam step re-sorts the beams by score, ties to the lower
index: the final stable sort by score gives the same result either way.)

``multinomial_decode`` samples ``argmax(logits / T + gumbel)``, which is what
``jax.random.categorical`` computes; its ``noise`` argument takes the gumbel
draws ([max_len, B*fanout, vocab]) so a test can feed both packages the same
noise. Without it, the draws come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils import vocab
from ..utils.config import ModelConfig
from ..utils.device import DeviceLike, resolve_device
from .functional import (
    CrossKV,
    Params,
    beam_decoder_step,
    decoder_step,
    gather_lanes,
    init_beam_cache,
    init_cache,
    precompute_cross_kv,
    real_data_blend,
)

EXIT_CHECK_EVERY = 4

_DECODE_KEYS = ("decoder.", "embed_trg.", "pe_trg.", "fc_out.", "real_data_linear.")


class DecodeResult(NamedTuple):
    tokens: torch.Tensor  # [B, T] generated ids (no <SOS>), <PAD> after finish
    token_probs: torch.Tensor  # [B, T] probability of each emitted token
    lengths: torch.Tensor  # [B] tokens up to and including the finishing one


def _cast_decode_params(params: Params, dtype) -> dict:
    """Cast the decoder-side tensors for reduced-precision decoding
    (selection math stays float32)."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return {k: (v.to(dtype) if k.startswith(_DECODE_KEYS) else v) for k, v in params.items()}


def _loop_decode(
    params: Params,
    cfg: ModelConfig,
    cross: CrossKV,
    batch: int,
    select_fn: Callable[[torch.Tensor, int], tuple[torch.Tensor, torch.Tensor]],
    max_len: int,
    dtype=torch.float32,
    early_exit: bool = True,
    group_size: int = 1,
    blend: Optional[torch.Tensor] = None,
) -> DecodeResult:
    """Shared loop of greedy and multinomial decoding."""
    assert max_len <= cfg.max_len, (
        f"decode max_len={max_len} exceeds the model's cache/positional size cfg.max_len={cfg.max_len}"
    )
    dev = cross.mask_bias.device
    cache = init_cache(cfg, batch, dtype, dev)
    last = torch.full((batch,), vocab.SOS_ID, dtype=torch.long, device=dev)
    out = torch.zeros(batch, max_len, dtype=torch.long, device=dev)
    probs = torch.zeros(batch, max_len, dtype=torch.float32, device=dev)
    finished = torch.zeros(batch, dtype=torch.bool, device=dev)
    for t in range(max_len):
        logits = decoder_step(params, cfg, cache, last, t, cross, blend=blend, group_size=group_size)
        nxt, prob = select_fn(logits.float(), t)
        nxt = torch.where(finished, vocab.PAD_ID, nxt)
        prob = torch.where(finished, 0.0, prob)
        out[:, t] = nxt
        probs[:, t] = prob
        finished = finished | (nxt == vocab.EOS_ID) | (nxt == vocab.PAD_ID)
        last = nxt
        if early_exit and (t + 1) % EXIT_CHECK_EVERY == 0 and bool(finished.all()):
            break
    is_eos = out == vocab.EOS_ID
    lengths = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1) + 1,
                          (out != vocab.PAD_ID).sum(dim=1))
    return DecodeResult(out, probs, lengths)


def _prepare(params, cfg, memory, memory_kpm, compute_dtype, device):
    dev = resolve_device(device)
    memory, memory_kpm = memory.to(dev), memory_kpm.to(dev)
    params = {k: v.to(dev) for k, v in params.items()}
    if compute_dtype is not None:
        params = _cast_decode_params(params, compute_dtype)
        memory = memory.to(params["fc_out.weight"].dtype)
    cross = precompute_cross_kv(params, cfg, memory, memory_kpm)
    return params, memory, cross


@torch.no_grad()
def greedy_decode(
    params: Params,
    cfg: ModelConfig,
    memory: torch.Tensor,  # [B, S, D]
    memory_kpm: torch.Tensor,  # [B, S] bool
    temperature: float = 1.0,
    max_len: int = 128,
    early_exit: bool = True,
    compute_dtype: Optional[str] = None,  # e.g. "bfloat16"; None = memory dtype
    device: DeviceLike = None,
) -> DecodeResult:
    params, memory, cross = _prepare(params, cfg, memory, memory_kpm, compute_dtype, device)
    blend = real_data_blend(params, memory) if cfg.use_real_data else None

    def select(logits, t):
        p = torch.softmax(logits / temperature, dim=-1)
        nxt = p.argmax(dim=-1)
        return nxt, p.gather(1, nxt[:, None])[:, 0]

    return _loop_decode(params, cfg, cross, memory.shape[0], select, max_len, memory.dtype,
                        early_exit, blend=blend)


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard gumbel draws, -log(-log(u)) with u uniform on [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


@torch.no_grad()
def multinomial_decode(
    params: Params,
    cfg: ModelConfig,
    memory: torch.Tensor,  # [B, S, D]
    memory_kpm: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    temperature: float | torch.Tensor = 1.0,  # scalar or per-lane [B*fanout, 1]
    max_len: int = 128,
    fanout: int = 1,
    early_exit: bool = True,
    compute_dtype: Optional[str] = None,
    noise: Optional[torch.Tensor] = None,  # [max_len, B*fanout, vocab] gumbel draws
    device: DeviceLike = None,
    global_lanes: int = 0,
    lane_rows: Optional[torch.Tensor] = None,  # [B*fanout] rows of the global draw
) -> DecodeResult:
    """Temperature sampling of B*fanout sequences in one loop; the fan-out
    lanes share each sample's cross K/V. With ``global_lanes``, these lanes
    are part of a larger decode (a rank's under a mesh): each step draws the
    Gumbel noise of all ``global_lanes`` lanes, as one process does, and lane
    ``j`` takes row ``lane_rows[j]`` of it."""
    params, memory, cross = _prepare(params, cfg, memory, memory_kpm, compute_dtype, device)
    dev = memory.device
    batch = memory.shape[0] * fanout
    blend = None
    if cfg.use_real_data:
        blend = real_data_blend(params, memory).repeat_interleave(fanout, dim=0)
    if isinstance(temperature, torch.Tensor):
        temperature = temperature.to(dev)
    if noise is None and generator is None:
        raise ValueError("multinomial_decode needs a generator or explicit noise")
    if noise is not None:
        noise = noise.to(dev)

    def select(logits, t):
        scaled = logits / temperature
        if noise is not None:
            g = noise[t]
        elif global_lanes:
            g = gumbel((global_lanes, scaled.shape[1]), generator, dev)[lane_rows]
        else:
            g = gumbel(scaled.shape, generator, dev)
        nxt = (scaled + g).argmax(dim=-1)
        p = torch.softmax(scaled, dim=-1)
        return nxt, p.gather(1, nxt[:, None])[:, 0]

    return _loop_decode(params, cfg, cross, batch, select, max_len, memory.dtype,
                        early_exit, group_size=fanout, blend=blend)


class BeamResult(NamedTuple):
    tokens: torch.Tensor  # [B, K, T] beams sorted best-first
    scores: torch.Tensor  # [B, K] sum of token log-probs
    lengths: torch.Tensor  # [B, K]


NEG = -1e30  # score of an unreachable beam (finite: -inf - -inf would be NaN)


class _BeamSelect:
    """The selection shared by both beam searches: log-softmax of the
    (blended) logits, a zero-cost <PAD> as the only continuation of a
    finished beam, and the best K of the K*V extensions of each sample."""

    def __init__(self, params, memory, cfg: ModelConfig, K: int, temperature: float):
        B, V = memory.shape[0], cfg.smiles_vocab_size
        assert K <= V, f"beam_size={K} exceeds the vocabulary of {V}"
        self.B, self.K, self.V, self.temperature = B, K, V, temperature
        self.blend = None
        if cfg.use_real_data:
            self.blend = real_data_blend(params, memory).float().repeat_interleave(K, dim=0)
        dev = memory.device
        self.pad_only = torch.full((V,), NEG, dtype=torch.float32, device=dev)
        self.pad_only[vocab.PAD_ID] = 0.0

    def __call__(self, logits, scores, finished):
        """-> (top scores [B, K], parent beam [B, K], token [B, K])."""
        B, K, V = self.B, self.K, self.V
        logits = logits.float()
        if self.blend is not None:
            logits = (logits + self.blend) / 2
        logp = torch.log_softmax(logits / self.temperature, dim=-1).reshape(B, K, V)
        logp = torch.where(finished[:, :, None], self.pad_only, logp)
        flat = (scores[:, :, None] + logp).reshape(B, K * V)
        # jax.lax.top_k: descending, ties to the lower index; unreachable
        # extensions (NEG + logp == NEG in float32) are exact ties
        top, idx = torch.sort(flat, dim=1, descending=True, stable=True)
        top, idx = top[:, :K], idx[:, :K]
        return top, idx // V, idx % V


def _beam_init(B: int, K: int, max_len: int, dev):
    last = torch.full((B * K,), vocab.SOS_ID, dtype=torch.long, device=dev)
    out = torch.zeros(B, K, max_len, dtype=torch.long, device=dev)
    scores = torch.full((B, K), NEG, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    finished = torch.zeros(B, K, dtype=torch.bool, device=dev)
    return last, out, scores, finished


def _beam_advance(out, finished, parent, token, t: int):
    """Reorder the per-beam tokens and finished flags by parent, append ``token``."""
    out = out.gather(1, parent[:, :, None].expand(-1, -1, out.shape[2]))
    out[:, :, t] = token
    finished = finished.gather(1, parent) | (token == vocab.EOS_ID) | (token == vocab.PAD_ID)
    return out, finished


def _beam_result(out, scores) -> BeamResult:
    order = torch.argsort(-scores, dim=1, stable=True)
    tokens = out.gather(1, order[:, :, None].expand(-1, -1, out.shape[2]))
    scores = scores.gather(1, order)
    is_eos = tokens == vocab.EOS_ID
    lengths = torch.where(is_eos.any(dim=2), is_eos.int().argmax(dim=2) + 1,
                          (tokens != vocab.PAD_ID).sum(dim=2))
    return BeamResult(tokens, scores, lengths)


@torch.no_grad()
def beam_search_materialized(
    params: Params,
    cfg: ModelConfig,
    memory: torch.Tensor,  # [B, S, D]
    memory_kpm: torch.Tensor,
    beam_size: int = 5,
    temperature: float = 1.0,
    max_len: int = 128,
    early_exit: bool = True,
    compute_dtype: Optional[str] = None,
    device: DeviceLike = None,
) -> BeamResult:
    """Beam search that reorders the whole KV cache by parent beam every step
    (``decoder_step`` and kernel K1 over B*K lanes, ``gather_lanes``). The
    same results as ``beam_search``; kept as its check."""
    assert max_len <= cfg.max_len, (max_len, cfg.max_len)
    params, memory, cross = _prepare(params, cfg, memory, memory_kpm, compute_dtype, device)
    dev = memory.device
    B, K = memory.shape[0], beam_size
    select = _BeamSelect(params, memory, cfg, K, temperature)
    cache = init_cache(cfg, B * K, memory.dtype, dev)
    last, out, scores, finished = _beam_init(B, K, max_len, dev)
    base = torch.arange(B, device=dev)[:, None] * K
    for t in range(max_len):
        logits = decoder_step(params, cfg, cache, last, t, cross, group_size=K)
        scores, parent, token = select(logits, scores, finished)
        out, finished = _beam_advance(out, finished, parent, token, t)
        cache = gather_lanes(cache, (base + parent).reshape(-1))
        last = token.reshape(-1)
        if early_exit and (t + 1) % EXIT_CHECK_EVERY == 0 and bool(finished.all()):
            break
    return _beam_result(out, scores)


@torch.no_grad()
def beam_search(
    params: Params,
    cfg: ModelConfig,
    memory: torch.Tensor,  # [B, S, D]
    memory_kpm: torch.Tensor,
    beam_size: int = 5,
    temperature: float = 1.0,
    max_len: int = 128,
    early_exit: bool = True,
    compute_dtype: Optional[str] = None,
    device: DeviceLike = None,
) -> BeamResult:
    """Batched beam search over an APPEND-ONLY KV cache: lanes never move;
    each step reorders only the [B, K, T] ancestry matrix, and each beam's
    self-attention keeps, per past step, the lane that held its ancestor
    (``beam_decoder_step``, kernel K3). With ``early_exit=False`` the loop
    never waits for the device."""
    assert max_len <= cfg.max_len, (max_len, cfg.max_len)
    params, memory, cross = _prepare(params, cfg, memory, memory_kpm, compute_dtype, device)
    dev = memory.device
    B, K, T = memory.shape[0], beam_size, cfg.max_len
    select = _BeamSelect(params, memory, cfg, K, temperature)
    cache = init_beam_cache(cfg, B, K, memory.dtype, dev)
    last, out, scores, finished = _beam_init(B, K, max_len, dev)
    lane_default = torch.arange(K, device=dev)[None, :, None].expand(B, K, T)
    ancestry = lane_default.clone()
    steps = torch.arange(T, device=dev)[None, None, :]
    for t in range(max_len):
        logits = beam_decoder_step(params, cfg, cache, last, t, cross, ancestry, K)
        scores, parent, token = select(logits, scores, finished)
        out, finished = _beam_advance(out, finished, parent, token, t)
        ancestry = ancestry.gather(1, parent[:, :, None].expand(-1, -1, T))
        # later steps belong to each beam's own lane
        ancestry = torch.where(steps > t, lane_default, ancestry)
        last = token.reshape(-1)
        if early_exit and (t + 1) % EXIT_CHECK_EVERY == 0 and bool(finished.all()):
            break
    return _beam_result(out, scores)
