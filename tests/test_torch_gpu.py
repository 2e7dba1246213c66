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


def _peaks(rng, n_pairs: int, n_max: int):
    qs, cs = [], []
    for _ in range(n_pairs):
        nq, nc = rng.integers(max(1, n_max // 2), n_max + 1, size=2)
        qs.append(np.column_stack([rng.uniform(0, 10, nq), rng.uniform(0, 200, nq)]))
        cs.append(np.column_stack([rng.uniform(0, 10, nc), rng.uniform(0, 200, nc)]))
    return qs, cs


@pytest.mark.gpu
def test_auction_kernel_matches_plain_on_gpu(cuda_device):
    """K2 against its plain version (1e-4: float32 sums in another order) and
    scipy at the scorer's shapes (within N * eps_last + 1e-4)."""
    rng = np.random.default_rng(2)
    for n_max in (8, 32, 64):
        cost = tm.pairwise_cost(*_peaks(rng, 80, n_max), device=cuda_device)[0]
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
