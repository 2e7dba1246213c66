"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The file
imports neither JAX nor the JAX package, so it runs on a machine that has
only the port's packages:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu

(``--noconftest``: the suite's conftest sets up JAX.) The parallel tests at the
end start their ranks with ``parallel/launch.py``; the ranks run
``tests/torch_parallel_ranks.py``, which imports no JAX either.
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
from multimodalspectraltransformer_torch.ops import embedding_grad as te1
from multimodalspectraltransformer_torch.rank import clip as tclip
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


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_clip_scores_on_gpu_match_cpu(cuda_device, compute_dtype):
    """``score_candidates_batch`` with the committed clip_r4 tower on the card
    against the CPU, 2 molecules x 10 candidates, TF32 off: float32 within
    1e-4 * max(1, |x|) (float32 products summed in another order); bfloat16
    within 2^-7 * max|cb| * max|mt|, the bound tests/test_torch_clip.py
    justifies (a bfloat16 rounding that flips moves a logit by up to 2^-8 of
    the embeddings' norm product)."""
    import os

    from multimodalspectraltransformer_torch.data import molrandom
    from multimodalspectraltransformer_torch.train.contrastive import clip_tokenize

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "weights",
                        "clip_r4.msgpack.gz")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model, cfg = tclip.load_bundle(path, device=cuda_device)
        host, _ = tclip.load_bundle(path, device="cpu")
        toks, mask = clip_tokenize(molrandom.random_corpus(20, seed=5), cfg.text_max_len)
        toks = torch.from_numpy(toks).reshape(2, 10, -1)
        mask = torch.from_numpy(mask).reshape(2, 10, -1)
        fps = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 512)).astype(np.float32))
        ours = tclip.score_candidates_batch(model, cfg, toks.to(cuda_device), mask.to(cuda_device),
                                            fps.to(cuda_device), compute_dtype=compute_dtype)
        ref = tclip.score_candidates_batch(host, cfg, toks, mask, fps, compute_dtype=compute_dtype)
        with torch.no_grad():
            cb = host.embed_text(toks.reshape(20, -1), mask.reshape(20, -1))
            scale = float(cb.norm(dim=-1).max() * host.embed_spectrum(fps).norm(dim=-1).max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for a, b in zip(ours, ref):
        a, b = a.cpu().double(), b.double()
        bound = 1e-4 * b.abs().clamp_min(1.0) if compute_dtype is None else 2.0**-7 * scale
        assert bool(((a - b).abs() <= bound).all()), (a - b).abs().max().item()


@pytest.mark.gpu
def test_train_step_on_gpu_matches_cpu(cuda_device):
    """One fp32 train step from phase3 (dropout and TF32 off) on the card
    against the CPU: the loss within 1e-5 relative, the gradients within
    1e-4 of each leaf's largest magnitude, the parameters within 1e-6 where
    the gradient is resolved (chip_smoke.py's check 1 says why not
    everywhere)."""
    import chip_smoke

    chip_smoke.train_step_card_vs_cpu(cuda_device)


@pytest.mark.gpu
def test_checkpoint_resume_exact_on_gpu(cuda_device):
    """Three fp32 steps with dropout on, a checkpoint, two more: a state
    restored from the checkpoint takes the same two steps (parameters and
    loss within 1e-6)."""
    import chip_smoke

    chip_smoke.resume_exact(cuda_device)


@pytest.mark.gpu
def test_evaluate_route_on_gpu(cuda_device):
    """The serving console's evaluate route on the card with phase3 loaded by
    a job: a simulate job, then an evaluate job with sampling and simulated
    errors that launches K1 and K2, each molecule's greedy SMILES and
    corr_sampling_prob (1e-5 relative) equal to a direct
    ``evaluate_molecules`` call on the same records and model."""
    import chip_smoke
    from multimodalspectraltransformer_torch.eval import harness
    from multimodalspectraltransformer_torch.serve import ServerState, make_app
    from multimodalspectraltransformer_torch.utils.config import DecodeConfig, ModelConfig

    state = ServerState(ModelConfig(), device=cuda_device)
    http = chip_smoke._Http(make_app(state))
    try:
        http.wait(http.post("/api/model", {"checkpoint": chip_smoke.PHASE3})["job"]["job_id"])
        smiles = ["CC(=O)Nc1ccc(O)cc1", "CCOC(=O)c1ccccc1", "OCC(Cl)c1ccncc1"]
        http.wait(http.post("/api/simulate", {"smiles": smiles})["job_id"])
        opts = dict(max_len=64, fanout=16, multinom_runs=4, max_temp_rounds=2)
        tk1.reset_launches()
        tk2.reset_launches()
        job = http.post("/api/evaluate", {**opts, "source": "sim", "simulate_errors": True})
        served = http.wait(job["job_id"])["result"]["molecules"]
        assert tk1.launches > 0 and tk2.launches > 0
    finally:
        http.close()
        state.jobs.shutdown()
    model, _ = state.snapshot_model()
    with state.lock:
        records = list(state.sim_records.values())
    results, _ = harness.evaluate_molecules(records, model, DecodeConfig(**opts),
                                            simulate_errors=True, device=cuda_device)
    assert [m["greedy"] for m in served] == [r.greedy for r in results]
    np.testing.assert_allclose([m["corr_sampling_prob"] for m in served],
                               [r.corr_sampling_prob for r in results], rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("tower", ["clip", "blip"])
def test_tower_step_on_gpu_matches_cpu(cuda_device, tower):
    """One contrastive tower step (dropout off, TF32 off) from the same
    tower and float32 encodings on the card and on the CPU: the loss within
    1e-5 relative, the gradients within 1e-4 of each leaf's largest
    magnitude, the parameters within 1e-6 where the gradient is resolved
    (chip_smoke.py's ``compare_steps``)."""
    import chip_smoke
    from multimodalspectraltransformer_torch.rank import qformer as tq
    from multimodalspectraltransformer_torch.train import contrastive as tcon

    cfg = (tclip.CLIPConfig(text_layers=2, text_heads=4, text_hidden=128, text_ffn=256,
                            cb_embedding=96, projection_dim=64) if tower == "clip"
           else tq.QFormerConfig(hidden=128, num_heads=4, ffn_dim=256, num_layers=4,
                                 num_queries=8, encoder_width=128, projection_dim=64))
    model = tcon.make_tower(tower, cfg)[0]
    gen = torch.Generator().manual_seed(3)
    B, S = 16, 40
    kpm = torch.zeros(B, S, dtype=torch.bool)
    kpm[3, 30:] = True
    enc = (torch.randn(B, 512, generator=gen), torch.randn(B, S, 128, generator=gen), kpm)
    toks = torch.randint(4, 43, (B, 32), generator=gen)
    mask = torch.ones(B, 32, dtype=torch.long)
    mask[5, 20:] = 0
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        chip_smoke.tower_step_card_vs_cpu(cuda_device, tower, model, enc, toks, mask, 1e-4,
                                          f"{tower} tower step")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.gpu
def test_lm_generate_greedy_on_gpu_matches_cpu(cuda_device):
    """The Q-Former's cached greedy generation on the card gives the CPU's
    tokens (fp32, TF32 off)."""
    import copy

    from multimodalspectraltransformer_torch.rank import qformer as tq
    from multimodalspectraltransformer_torch.train import contrastive as tcon

    cfg = tq.QFormerConfig(hidden=128, num_heads=4, ffn_dim=256, num_layers=4, num_queries=8,
                           encoder_width=128, projection_dim=64)
    model = tcon.make_tower("blip", cfg)[0].eval()
    gen = torch.Generator().manual_seed(4)
    memory = torch.randn(8, 40, 128, generator=gen)
    kpm = torch.zeros(8, 40, dtype=torch.bool)
    kpm[2, 25:] = True
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = tq.lm_generate_greedy(copy.deepcopy(model).to(cuda_device),
                                     memory.to(cuda_device), kpm.to(cuda_device), 32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu = tq.lm_generate_greedy(model, memory, kpm, 32)
    assert torch.equal(card.cpu(), cpu)


@pytest.mark.gpu
def test_generation_metrics_on_gpu_match_cpu(cuda_device):
    """``generation_metrics`` from phase3 in fp32 on 8 factory molecules: the
    card's greedy generations (K1) are the CPU's, string for string, and
    every metric, the spectral feedback term included, within 1e-6
    relative (chip_smoke.py's check)."""
    import chip_smoke
    from multimodalspectraltransformer_torch.data import molrandom
    from multimodalspectraltransformer_torch.sim import factory

    records = factory.simulate_records(molrandom.random_corpus(8, seed=31), device=cuda_device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        chip_smoke.generation_metrics_card_vs_cpu(cuda_device, records)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.gpu
def test_densify_batch_on_gpu_never_syncs_and_matches_cpu(cuda_device):
    """``densify_batch`` on the card, under ``set_sync_debug_mode("error")``
    (any host sync raises), equals the CPU's on a batch with padded edges,
    repeated edges and a graph with none."""
    from multimodalspectraltransformer_torch.chem.smiles import parse_smiles
    from multimodalspectraltransformer_torch.data import molrandom
    from multimodalspectraltransformer_torch.sim import distill

    cs = [distill.featurize_compact(parse_smiles(s)) for s in molrandom.random_corpus(64, seed=5)]
    nodes, edges, n_at = (torch.from_numpy(np.stack([c[i] for c in cs])) for i in range(3))
    edges[1, :2] = torch.tensor([[3, 3, 2], [3, 3, 2]], dtype=torch.int8)
    edges[2] = -1
    ref = distill.densify_batch(nodes, edges, n_at)
    on_card = [x.to(cuda_device) for x in (nodes, edges, n_at)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = distill.densify_batch(*on_card)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(ref, out):
        assert torch.equal(a, b.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["tanimoto", "cosine", "dot", "euclidean"])
def test_vectordb_topk_on_gpu_matches_cpu_with_ties(cuda_device, metric):
    """The stable top k on the card gives the CPU's indices, equal scores in
    index order, on a Morgan DB where every molecule appears three times."""
    from multimodalspectraltransformer_torch.data import molrandom
    from multimodalspectraltransformer_torch.eval import vectordb

    db = vectordb.build_morgan_db(molrandom.random_corpus(300, seed=8) * 3)
    q = db.vectors[:64]
    s_cpu, i_cpu, _ = vectordb.query(db, q, k=50, metric=metric, device="cpu")
    s_gpu, i_gpu, _ = vectordb.query(db, q, k=50, metric=metric, device=cuda_device)
    np.testing.assert_array_equal(i_gpu, i_cpu)
    np.testing.assert_allclose(s_gpu, s_cpu, rtol=1e-6, atol=1e-6 * np.abs(s_cpu).max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("table", [t[0] for t in kt.E1_TIMED])
def test_embedding_grad_kernel_matches_plain_on_gpu(cuda_device, table, dtype):
    """E1 at a trained table's training shape against its plain version in
    float64: within 1e-6 of each table row's largest magnitude for a float32
    gradient, one bfloat16 rounding more (2^-8 + 1e-6) for a bfloat16 one,
    1e-12 for a float64 one; unreached rows exactly 0; the launch counted."""
    _, V, D, (rows, cols), _, draw = next(t for t in kt.E1_TIMED if t[0] == table)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    ids = kt.e1_ids(gen, V, rows, cols, draw, cuda_device)
    grad = torch.randn(rows, cols, D, generator=gen, device=cuda_device).to(getattr(torch, dtype))
    te1.reset_launches()
    out = te1.embedding_grad(grad, ids, V)
    assert te1.launches == 1 and out.dtype == grad.dtype and out.shape == (V, D)
    ref = te1.embedding_grad_plain(grad.double(), ids, V)
    rtol = {"float32": 1e-6, "bfloat16": 2.0**-8 + 1e-6, "float64": 1e-12}[dtype]
    scale = ref.abs().amax(dim=1, keepdim=True)
    assert bool(((out.double() - ref).abs() <= rtol * scale).all())
    unreached = torch.ones(V, dtype=torch.bool, device=cuda_device)
    unreached[ids.reshape(-1)] = False
    assert bool((out[unreached] == 0).all())


@pytest.mark.gpu
def test_embedding_grad_kernel_repeats_bit_for_bit(cuda_device):
    """E1 twice on the same inputs, at every timed shape: the same bits; so
    is a lookup's parameter gradient taken twice through autograd."""
    for _, grad, ids, V in kt.e1_cases(cuda_device):
        assert torch.equal(te1.embedding_grad(grad, ids, V), te1.embedding_grad(grad, ids, V))
    w = torch.randn(43, 128, device=cuda_device, requires_grad=True)
    ids = torch.randint(0, 43, (64, 63), device=cuda_device)
    g = torch.randn(64, 63, 128, device=cuda_device).bfloat16()
    grads = []
    for _ in range(2):
        w.grad = None
        te1.embedding_lookup(w.bfloat16(), ids).backward(g)
        grads.append(w.grad.clone())
    assert torch.equal(*grads)


@pytest.mark.gpu
def test_run_training_twice_bit_for_bit_on_gpu(cuda_device):
    """``run_training`` at full width from the seeded init, 3 bf16 steps at
    batch 64, twice under PyTorch's default algorithms: the same losses and
    every parameter the same bits; E1 launched 3 times a step."""
    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.train import loop
    from multimodalspectraltransformer_torch.utils.config import MMTConfig, ModelConfig, TrainConfig

    assert not torch.are_deterministic_algorithms_enabled()
    cfg = MMTConfig(model=ModelConfig(), train=TrainConfig(learning_rate=3e-5,
                                                           mixed_precision=True))
    records = dp.synthetic_dataset(192, seed=7)
    runs = []
    for _ in range(2):
        te1.reset_launches()
        res = loop.run_training(cfg, dp.Loader(records, cfg.model, batch_size=64), max_steps=3,
                                device=cuda_device)
        assert te1.launches == 9
        runs.append(([h["train_loss"] for h in res.metrics.history],
                     {k: v.cpu() for k, v in res.state.model.state_dict().items()}))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


# ---------------------------------------------------------------------------
# data parallelism on the card (parallel/): ranks started by parallel/launch.py
# ---------------------------------------------------------------------------

def _parallel_inputs(dropout: float):
    """A small model's parameters, an 8-row batch and the config (the CPU
    parallel tests' width), and the one-process step on the card."""
    import torch_parallel_ranks as ranks
    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.models import mmt
    from multimodalspectraltransformer_torch.train import state as st
    from multimodalspectraltransformer_torch.train import step
    from multimodalspectraltransformer_torch.utils.config import (MMTConfig, ModelConfig,
                                                                  TrainConfig)

    cfg = MMTConfig(model=ModelConfig(num_encoder_layers=1, num_decoder_layers=1, ffn_dim=64,
                                      dropout=dropout), train=TrainConfig(learning_rate=1e-3))
    sd = {k: v.numpy() for k, v in mmt.init_model(cfg.model, 0, "cpu").state_dict().items()}
    batch = dp.collate([dp.featurize(r, cfg.model) for r in dp.synthetic_dataset(8, seed=2)])
    model = ranks._model(cfg.model, sd).cuda()
    state, m = step.train_step(cfg, st.create_state(cfg.train, model),
                               dp.to_device(ranks._rows(batch, slice(None)), "cuda"), 3)
    grads = {n: p.grad.cpu().numpy() for n, p in model.named_parameters() if p.grad is not None}
    return cfg, sd, batch, float(m.loss), grads


@pytest.mark.gpu
def test_one_rank_nccl_mesh_step_equals_no_mesh(cuda_device):
    """A world of one rank over NCCL: the step on a mesh is the step without
    one, bit for bit (the all-reduce over one rank is the identity)."""
    from multimodalspectraltransformer_torch.parallel.launch import launch

    cfg, sd, batch, loss, grads = _parallel_inputs(dropout=0.1)
    got = launch("torch_parallel_ranks:step", 1, args=((None, 1, 1), cfg, sd, batch, 3),
                 kwargs=dict(device="cuda"), device="cuda", backend="nccl")[0]
    assert got["loss"] == loss
    for k, g in grads.items():
        np.testing.assert_array_equal(got["grads"][k], g, err_msg=k)


@pytest.mark.gpu
def test_two_rank_gloo_step_on_the_card_matches_one_process(cuda_device):
    """Two ranks sharing the card over gloo as (data 2), dropout on: loss
    within 2e-5 relative, gradients within 5e-5 of each leaf's largest
    magnitude."""
    from multimodalspectraltransformer_torch.parallel.launch import launch

    cfg, sd, batch, loss, grads = _parallel_inputs(dropout=0.1)
    out = launch("torch_parallel_ranks:step", 2, args=((None, 2, 1), cfg, sd, batch, 3),
                 kwargs=dict(device="cuda"), device="cuda", backend="gloo")
    assert abs(out[0]["loss"] - loss) <= 2e-5 * abs(loss)
    assert out[1]["loss"] == out[0]["loss"]
    for k, g in grads.items():
        scale = max(float(np.abs(g).max()), 1e-3)
        np.testing.assert_allclose(out[0]["grads"][k] / scale, g / scale, atol=5e-5, err_msg=k)


@pytest.mark.gpu
def test_two_ranks_build_the_kernels_at_once(cuda_device, tmp_path):
    """Two processes building the kernels from an empty build directory at the
    same moment each compile to a temporary of their own and move it into
    place: both load the library, and no temporary is left."""
    import os
    import shutil
    import subprocess
    import sys

    from multimodalspectraltransformer_torch.ops import _build

    pkg = os.path.dirname(os.path.dirname(_build.__file__))
    shutil.copytree(pkg, tmp_path / os.path.basename(pkg),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    code = ("from multimodalspectraltransformer_torch.ops import _build; "
            "print(_build.lib()._name)")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=tmp_path, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err for _, err in outs]
    lib = str(tmp_path / os.path.basename(pkg) / "build" / "libmmtkernels.so")
    assert [out.strip() for out, _ in outs] == [lib, lib]
    assert not [f for f in os.listdir(os.path.dirname(lib)) if "tmp" in f]


@pytest.mark.gpu
def test_accuracy_report_with_beam_launches_k3(cuda_device, tmp_path):
    """``scripts/torch_accuracy_report.py`` on the card at n=4 with ``--beam
    2`` (phase3, the pinned list and records): the beam hypotheses go
    through K3, the decodes through K1 and the scorer through K2; a rerun
    resumes both chunks and launches nothing."""
    import importlib.util
    import json
    import os
    import shutil

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_accuracy_report", os.path.join(repo, "scripts", "torch_accuracy_report.py"))
    acc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(acc)
    shutil.copy(os.path.join(repo, "runs", "accuracy_r3", "heldout_smiles.json"), tmp_path)
    argv = ["--n", "4", "--chunk-size", "2", "--fanout", "16", "--multinom-runs", "4",
            "--rounds", "2", "--beam", "2", "--mix", "--out", str(tmp_path),
            "--report-dir", str(tmp_path), "--tag", "gpu",
            "--params", os.path.join(repo, "weights", "mmt_r4_phase3.msgpack.gz"),
            "--records-cache", os.path.join(repo, "runs", "accuracy_r2b", "heldout_csv.tar.gz")]
    for mod in (tk1, tk2, tk3):
        mod.reset_launches()
    first = acc.run(acc.parse_args(argv))["report"]
    counts = (tk1.launches, tk2.launches, tk3.launches)
    assert all(c > 0 for c in counts), counts
    assert first["n"] == 4 and first["beam_candidates"] == 2 and first["greedy_in_pool"]
    for mod in (tk1, tk2, tk3):
        mod.reset_launches()
    again = acc.run(acc.parse_args(argv))["report"]
    assert (tk1.launches, tk2.launches, tk3.launches) == (0, 0, 0)
    drop = ("wall_s_total",)
    assert {k: v for k, v in again.items() if k not in drop} == {
        k: v for k, v in first.items() if k not in drop}
    assert json.load(open(tmp_path / "ACCURACY_gpu.json"))["n"] == 4


def _script(name: str):
    import importlib.util
    import os
    import sys

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
def test_sgnn_adapt_on_gpu_matches_cpu(cuda_device, tmp_path):
    """``torch_sgnn_adapt``'s GNN predictions on the card within 1e-4 ppm of
    the CPU's on a stand-in for the shipped test set; its fine-tune on the
    card lowers the eval half's 13C MAE."""
    import json

    import chip_smoke
    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.sim import factory

    adapt = _script("torch_sgnn_adapt")
    chip_smoke.campaign_testset("cpu", str(tmp_path / "ref"), n=16)
    chc, h1 = dp.load_reference_sets(str(tmp_path / "ref"))
    on_card = adapt.predict_all(chc + h1, *factory.default_shift_model(cuda_device), cuda_device)
    on_cpu = adapt.predict_all(chc + h1, *factory.default_shift_model("cpu"), "cpu")
    assert [r[0].sample_id for r in on_card] == [r[0].sample_id for r in on_cpu] and on_cpu
    for (_, _, sc, sh), (_, _, rc, rh) in zip(on_card, on_cpu):
        np.testing.assert_allclose(sc, rc, rtol=0, atol=1e-4)
        np.testing.assert_allclose(sh, rh, rtol=0, atol=1e-4)
    assert adapt.main(["--ref-dir", str(tmp_path / "ref"), "--steps", "40", "--batch-size", "32",
                       "--out", str(tmp_path / "w"), "--report", str(tmp_path / "r")]) == 0
    report = json.load(open(tmp_path / "r" / "report.json"))
    assert (report["eval_after"]["chc_eval"]["c13_nn_mae_ppm"]
            < report["eval_before"]["chc_eval"]["c13_nn_mae_ppm"])


@pytest.mark.gpu
def test_control_adapted_sim_eval_on_gpu_launches_k1_k2(cuda_device, tmp_path):
    """``torch_control_adapted_sim_eval`` at full width with phase3 on 2
    stand-in molecules, the committed SGNN-adapted weights simulating and
    scoring: the decodes go through K1, the scorer through K2."""
    import json
    import os

    import chip_smoke

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    chip_smoke.campaign_testset(cuda_device, str(tmp_path / "ref"), n=8)
    for mod in (tk1, tk2):
        mod.reset_launches()
    assert _script("torch_control_adapted_sim_eval").main(
        ["--params", os.path.join(repo, "weights", "mmt_r4_phase3.msgpack.gz"), "--n", "2",
         "--chunk-size", "2", "--ref-dir", str(tmp_path / "ref"), "--out",
         str(tmp_path / "control.json"), "--sim-weights",
         os.path.join(repo, "multimodalspectraltransformer_tpu", "sim", "weights_sgnn")]) == 0
    assert tk1.launches > 0 and tk2.launches > 0
    assert json.load(open(tmp_path / "control.json"))["n"] == 2


@pytest.mark.gpu
def test_real_data_fold_on_gpu_trains_only_its_subtrees(cuda_device, tmp_path):
    """A fold of ``torch_real_data_demo``'s arm 2 at full width from phase3 in
    bf16 on the card, 3 steps: ``decoder``, ``fc_out`` and
    ``real_data_linear`` move; every other tensor stays bit-equal."""
    import dataclasses
    import os

    import chip_smoke
    from multimodalspectraltransformer_torch.data import pipeline as dp
    from multimodalspectraltransformer_torch.models.convert import jax_paths
    from multimodalspectraltransformer_torch.sim import factory
    from multimodalspectraltransformer_torch.train import checkpoint
    from multimodalspectraltransformer_torch.utils.config import ModelConfig

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    recs = factory.simulate_records(["CCOC(=O)c1ccccc1", "CC(C)Cc1ccc(C(C)C(=O)O)cc1",
                                     "O=C(O)c1ccccc1O", "CCN(CC)CC(=O)Nc1c(C)cccc1C",
                                     "COc1ccc(CC(C)N)cc1"], device=cuda_device)
    chip_smoke.write_az_example(str(tmp_path / "az"), recs)
    phase3 = checkpoint.import_params_msgpack(os.path.join(repo, "weights",
                                                           "mmt_r4_phase3.msgpack.gz"))
    cfg = dataclasses.replace(ModelConfig(), use_real_data=True)
    result = _script("torch_real_data_demo").train_fold(
        phase3, dp.load_real_example(str(tmp_path / "az")), 0, cfg,
        ("decoder", "fc_out", "real_data_linear"), 3, 5e-5, device=cuda_device,
        jitter_13c_ppm=3.0, jitter_1h_ppm=0.2, jitter_gate_p=0.5, warp_13c_ppm=3.0,
        warp_1h_ppm=0.2)
    named = dict(result.state.model.named_parameters())
    paths = jax_paths(named)
    moved = {paths[n].split("/")[0] for n, p in named.items()
             if not torch.equal(p.detach().cpu(), phase3[n])}
    assert result.steps == 3 and moved == {"decoder", "fc_out", "real_data_linear"}


@pytest.mark.gpu
def test_bench_e2e_on_gpu_prints_its_line_and_launches_k1_k2(cuda_device, capfd):
    """``bench_torch.py``'s e2e mode on the card at 4 molecules, 1 rep (phase3,
    clip_r4): one JSON line on stdout with bench.py's keys, its value
    molecules over the printed rep, and K1 and K2 launched in the rep."""
    import json

    import bench_torch

    line = bench_torch.main_e2e(cuda_device, n_mols=4, reps=1)
    out, err = capfd.readouterr()
    assert out.splitlines() == [json.dumps(line)]
    assert list(line) == ["metric", "value", "unit", "vs_baseline", "mols_per_sec_mean"]
    detail = json.loads([ln for ln in err.splitlines()
                         if ln.startswith("[bench] detail ")][0][len("[bench] detail "):])
    assert line["unit"] == "mols/sec/chip" and line["value"] == round(4 / detail["reps_s"][0], 3)
    assert detail["launches"][0]["K1"] > 0 and detail["launches"][0]["K2"] > 0
    assert detail["max_memory_allocated"] > 0
