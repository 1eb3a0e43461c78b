"""Each hand-written CUDA kernel against its plain torch version, on the card.

These tests need an NVIDIA GPU with nvcc (sm_90a) and skip without one;
they import neither jax nor the reference package, so they also run where
only torch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 sums in another order, so 1e-5 of the largest output; the
k-means labels (ties included) are exact.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref


def cuda_device():
    """The CUDA device, or skip the calling test (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(100, 47571), (7, 300), (130, 1000), (1, 33)])
def test_cuda_gram_matches_plain(m, d):
    dev = cuda_device()
    g = torch.randn(m, d, generator=torch.Generator().manual_seed(m), dtype=torch.float32).to(dev)
    got = ops.gram(g, impl="cuda")
    want = ref.gram(g)
    torch.cuda.synchronize()
    assert torch.equal(got, got.T)
    tol = 1e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("k,m,d", [(100, 100, 47616), (4, 100, 47616), (5, 7, 97), (3, 600, 513)])
def test_cuda_mix_aggregate_matches_plain(k, m, d):
    dev = cuda_device()
    gen = torch.Generator().manual_seed(k + m)
    w = torch.softmax(torch.randn(k, m, generator=gen), dim=1).to(dev)
    th = torch.randn(m, d, generator=gen).to(dev)
    got = ops.mix_aggregate(w, th, impl="cuda")
    want = ref.mix_aggregate(w, th)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("m,f,k", [(100, 100, 4), (100, 100, 100), (37, 5, 3)])
def test_cuda_kmeans_assign_matches_plain(m, f, k):
    dev = cuda_device()
    gen = torch.Generator().manual_seed(m + k)
    p = torch.randn(m, f, generator=gen).to(dev)
    c = torch.randn(k, f, generator=gen).to(dev)
    c[-1] = c[0]  # an exact tie: the lower index wins
    gl, gd = ops.kmeans_assign(p, c, impl="cuda")
    wl, wd = ref.kmeans_assign(p, c)
    torch.cuda.synchronize()
    assert torch.equal(gl, wl)
    assert float((gd - wd).abs().max()) <= 1e-5 * float(wd.abs().max())
