"""The port's CUDA kernels and engine on the card.

Every test here needs a CUDA card and skips without one (the kernels build
and run only there). The module imports neither JAX nor the JAX package, so
it also runs on the card's machine, which has no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports JAX). Each kernel is held
against its plain PyTorch version on the same inputs: f32 with TF32 off at
2e-5, bf16 at 2e-2; the engine on the card emits the same greedy tokens as
on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.scheduler.policies import fcfs
from repro_torch.core.scheduler.request import Request
from repro_torch.core.scheduler.scheduler import Scheduler
from repro_torch.kernels.flash_decode.ops import (paged_decode_attention,
                                                  paged_decode_attention_plain)
from repro_torch.kernels.flash_prefill.ops import (flash_attention,
                                                   flash_attention_plain)
from repro_torch.models import transformer as tfm
from repro_torch.serving.engine import Engine

TOL = {"float32": dict(atol=2e-5, rtol=2e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build and run only "
                    "there (chip_smoke.py holds them on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        device=dev, dtype=getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_kernel_matches_plain(cuda, dtype):
    b, kh, g, dh, bs, mb = 4, 8, 3, 128, 16, 8
    rng = np.random.default_rng(7)
    n = b * mb + 1
    tables = torch.as_tensor(np.stack([rng.permutation(n)[:mb]
                                       for _ in range(b)]),
                             dtype=torch.int32, device=cuda)
    lengths = torch.tensor([mb * bs, 1, 0, 77], dtype=torch.int32,
                           device=cuda)
    args = (_randn(rng, (b, kh * g, dh), dtype, cuda),
            _randn(rng, (n, bs, kh, dh), dtype, cuda),
            _randn(rng, (n, bs, kh, dh), dtype, cuda), tables, lengths)
    before = paged_decode_attention.launches
    out = paged_decode_attention(*args)
    assert paged_decode_attention.launches == before + 1
    torch.testing.assert_close(out.float(),
                               paged_decode_attention_plain(*args).float(),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_kernel_matches_plain(cuda, dtype):
    b, h, kh, sq, skv, dh = 3, 24, 8, 40, 104, 128
    rng = np.random.default_rng(4)
    q = _randn(rng, (b, h, sq, dh), dtype, cuda)
    k = _randn(rng, (b, kh, skv, dh), dtype, cuda)
    v = _randn(rng, (b, kh, skv, dh), dtype, cuda)
    starts = torch.tensor([0, 17, 64], dtype=torch.int32, device=cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, starts, starts + sq)
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(
        out.float(), flash_attention_plain(q, k, v, starts,
                                           starts + sq).float(),
        **TOL[dtype])


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 4, 48, device=cuda)           # head_dim 48
    k = torch.zeros(1, 2, 8, 48, device=cuda)
    zero = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[:, :, None].expand(1, 4, 8, 48).contiguous(), k, k,
                        zero, zero + 8)
    with pytest.raises(ValueError, match="int32"):
        flash_attention(torch.zeros(1, 4, 8, 64, device=cuda),
                        torch.zeros(1, 2, 8, 64, device=cuda),
                        torch.zeros(1, 2, 8, 64, device=cuda),
                        zero.long(), zero + 8)


def _words(n, tag):
    return " ".join(f"{tag}w{j}" for j in range(n))


def test_engine_on_the_card_matches_the_cpu(cuda):
    """The smoke model in f32, chunked and prefix-cached: greedy tokens on
    the card (both kernels) equal the CPU run (plain versions)."""
    cfg = get_smoke_config("llama3_2_3b").replace(dtype="float32",
                                                  vocab_size=2048)
    params = tfm.init_params(cfg, 0, device="cpu")

    def run(device, tree):
        shared = _words(24, "sys")
        reqs = [Request(i, shared + " " + _words(6, f"u{i}"), 0.0, 32, 4 + i)
                for i in range(4)]
        eng = Engine(cfg, tree, Scheduler(policy=fcfs(), max_batch=2),
                     cache_len=96, prompt_len=32, prefill_chunk_tokens=16,
                     prefix_caching=True, record_tokens=True, device=device)
        eng.submit(reqs)
        return {r.req_id: r.generated_tokens for r in eng.run()}

    def to(tree, device):
        return {k: to(v, device) if isinstance(v, dict) else v.to(device)
                for k, v in tree.items()}

    before = (paged_decode_attention.launches, flash_attention.launches)
    on_card = run(cuda, to(params, cuda))
    assert paged_decode_attention.launches > before[0]
    assert flash_attention.launches > before[1]
    assert on_card == run("cpu", params)
