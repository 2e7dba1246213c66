"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The file
imports neither JAX nor the JAX package, so it runs on a machine that has
only the port's packages:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

(``--noconftest``: the suite's conftest sets up JAX.)
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import kernel_timing as kt
from multimodalspectraltransformer_torch.decode import functional as tf
from multimodalspectraltransformer_torch.ops import auction as tk2
from multimodalspectraltransformer_torch.ops import beam_attention as tk3
from multimodalspectraltransformer_torch.ops import decode_attention as tk1
from multimodalspectraltransformer_torch.rank import matching as tm


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_decode_attention_kernel_matches_plain_on_gpu(cuda_device):
    """K1 against its plain version at the decode shapes."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-7)):
        q = torch.randn(1024, 16, 8, generator=gen, device=cuda_device).to(dtype)
        kv = torch.randn(1024, 16, 16, 128, generator=gen, device=cuda_device).to(dtype)
        for pos in (0, 31, 127):
            out = tk1.decode_attention(q, kv, pos)
            ref = tk1.decode_attention_plain(q, kv, pos)
            torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_auction_kernel_matches_plain_on_gpu(cuda_device):
    """K2 against its plain version (1e-4; both sum the total in float64) and
    scipy at the scorer's shapes (within N * eps_last + 1e-4)."""
    rng = np.random.default_rng(2)
    for n_max in (8, 32, 64):
        cost = tm.pairwise_cost(*kt.peak_lists(rng, 80, n_max), device=cuda_device)[0]
        out = tk2.auction_assignment_cost(cost)
        ref = tk2.auction_assignment_cost_plain(cost)
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
        c = cost.cpu().numpy().astype(np.float64)
        opt = np.array([m[linear_sum_assignment(m)].sum() for m in c])
        span = c.max(axis=(1, 2)) - c.min(axis=(1, 2))
        eps_last = np.maximum(1e-5, np.maximum(span, 1e-5) * 0.5 / 6.0**7)
        assert np.all(out.cpu().numpy() - opt <= cost.shape[1] * eps_last + 1e-4)


@pytest.mark.gpu
def test_beam_attention_kernel_matches_plain_on_gpu(cuda_device):
    """K3 against its plain version at beam mode's shape (B=128, H=16, K=5,
    Dh=8, T=128), and at K = 1, 8, 10 and 16 (the ends of its two bodies,
    KMAX 8 and 16), on an ancestry bias at pos 0, 63 and 127:
    1e-5 relative at float32, 2^-7 at bfloat16 (the plain version rounds the
    probabilities to bf16 as the Pallas kernel does, the kernel's online
    softmax cannot)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    T, H, Dh = 128, 16, 8
    for B, K in ((128, 5), (32, 1), (32, 8), (32, 10), (32, 16)):
        q = torch.randn(B, H, K, Dh, generator=gen, device=cuda_device) / Dh**0.5
        kv = torch.randn(B, H, 2 * Dh, T * K, generator=gen, device=cuda_device)
        for pos in (0, 63, 127):
            anc = torch.randint(0, K, (B, K, T), generator=gen, device=cuda_device)
            anc[:, :, pos + 1 :] = torch.arange(K, device=cuda_device)[None, :, None]
            bias = tf.ancestry_bias(anc, pos, torch.float32)
            for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-7)):
                args = [a.to(dtype) for a in (q, kv, bias)]
                out = tk3.beam_attention(*args, n_live=(pos + 1) * K)
                ref = tk3.beam_attention_plain(*args, n_live=(pos + 1) * K)
                torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [8, 16, 31, 32, 33, 64, 224, 225, 300])
def test_auction_kernel_matches_plain_and_scipy_at_every_variant(cuda_device, n):
    """K2 in each of its variants (a warp per problem up to N = 32, a block
    with the cost in shared memory up to 238, in device memory above): the
    plain version's totals (1e-4; both sum in float64) and its rounds per
    problem exactly, and scipy's optimum within N * eps_last + 1e-4, on ties
    and a constant block."""
    rng = np.random.default_rng(n)
    costs = kt.edge_costs(rng, 16 if n <= 64 else 3, n)
    cost = torch.from_numpy(costs).to(cuda_device)
    out, rounds = tk2.auction_assignment_cost(cost, return_iters=True)
    ref, ref_rounds = tk2.auction_assignment_cost_plain(cost, return_iters=True)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    assert torch.equal(rounds, ref_rounds)
    c = costs.astype(np.float64)
    opt = np.array([m[linear_sum_assignment(m)].sum() for m in c])
    span = c.max(axis=(1, 2)) - c.min(axis=(1, 2))
    eps_last = np.maximum(1e-5, np.maximum(span, 1e-5) * 0.5 / 6.0**7)
    gap = out.cpu().numpy() - opt
    assert np.all(gap <= n * eps_last + 1e-4) and np.all(gap >= -1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [8, 16, 32])
def test_decode_attention_kernel_at_head_sizes(cuda_device, dh):
    """K1 at the head sizes a ModelConfig can give (hidden_size / num_heads)."""
    gen = torch.Generator(device=cuda_device).manual_seed(dh)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-7)):
        q = (torch.randn(256, 8, dh, generator=gen, device=cuda_device) / dh**0.5).to(dtype)
        kv = torch.randn(256, 8, 2 * dh, 64, generator=gen, device=cuda_device).to(dtype)
        for pos in (0, 40, 63):
            out = tk1.decode_attention(q, kv, pos)
            ref = tk1.decode_attention_plain(q, kv, pos)
            torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [8, 16])
@pytest.mark.parametrize("k", [1, 5, 8, 16, 17, 20])
def test_beam_attention_kernel_at_beams_and_head_sizes(cuda_device, k, dh):
    """K3 at up to 16 beams (one group), above 16 (two groups, each reading
    the cache again) and at head sizes 8 and 16, on an ancestry bias:
    1e-5 relative at float32, 2^-7 at bfloat16."""
    gen = torch.Generator(device=cuda_device).manual_seed(k * dh)
    B, H, T = 16, 4, 64
    q = torch.randn(B, H, k, dh, generator=gen, device=cuda_device) / dh**0.5
    kv = torch.randn(B, H, 2 * dh, T * k, generator=gen, device=cuda_device)
    for pos in (0, 31, 63):
        anc = torch.randint(0, k, (B, k, T), generator=gen, device=cuda_device)
        anc[:, :, pos + 1 :] = torch.arange(k, device=cuda_device)[None, :, None]
        bias = tf.ancestry_bias(anc, pos, torch.float32)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-7)):
            args = [a.to(dtype) for a in (q, kv, bias)]
            out = tk3.beam_attention(*args, n_live=(pos + 1) * k)
            ref = tk3.beam_attention_plain(*args, n_live=(pos + 1) * k)
            torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [8, 16])
def test_beam_attention_kernel_at_unaligned_cache_rows(cuda_device, dh):
    """K3 at T = 50, K = 5: a cache row of M = 250 columns is 500 bytes in
    bf16 and 1000 in f32, no multiple of 16, so the kernel loads its tiles
    with plain loads in place of cp.async; 1e-5 relative at float32, 2^-7
    at bfloat16."""
    gen = torch.Generator(device=cuda_device).manual_seed(50 + dh)
    B, H, K, T = 8, 4, 5, 50
    q = torch.randn(B, H, K, dh, generator=gen, device=cuda_device) / dh**0.5
    kv = torch.randn(B, H, 2 * dh, T * K, generator=gen, device=cuda_device)
    for pos in (0, 25, 49):
        anc = torch.randint(0, K, (B, K, T), generator=gen, device=cuda_device)
        anc[:, :, pos + 1 :] = torch.arange(K, device=cuda_device)[None, :, None]
        bias = tf.ancestry_bias(anc, pos, torch.float32)
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-7)):
            args = [a.to(dtype) for a in (q, kv, bias)]
            out = tk3.beam_attention(*args, n_live=(pos + 1) * K)
            ref = tk3.beam_attention_plain(*args, n_live=(pos + 1) * K)
            torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_graph_timer_replays_the_eager_launches(cuda_device):
    """The cold timer (kernel_timing.py) captures the wrapper into a CUDA
    graph: every captured launch, over every copy of the inputs, gives the
    eager output, and the timer reads a positive time."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn(128, 16, 5, 8, generator=gen, device=cuda_device).to(torch.bfloat16)
    kv = torch.randn(128, 16, 16, 640, generator=gen, device=cuda_device).to(torch.bfloat16)
    anc = torch.randint(0, 5, (128, 5, 128), generator=gen, device=cuda_device)
    bias = tf.ancestry_bias(anc, 127, torch.bfloat16)
    outs = []
    graph, n = kt.capture(lambda *a: outs.append(tk3.beam_attention(*a, 640)), (q, kv, bias), 8)
    torch.cuda.synchronize()
    eager = outs[0]
    assert len(outs) == n + 1 and n >= 8
    for captured in outs[1:]:
        assert torch.equal(captured, eager)
    assert kt.graph_ms(lambda *a: tk3.beam_attention(*a, 640), (q, kv, bias), 8) > 0
