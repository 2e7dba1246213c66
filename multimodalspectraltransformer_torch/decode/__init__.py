"""KV-cached decoding: the step functions and the samplers."""

from .functional import CrossKV, DecodeState, decoder_step, init_cache, precompute_cross_kv  # noqa: F401
from .samplers import BeamResult, DecodeResult, beam_search, greedy_decode, multinomial_decode  # noqa: F401
