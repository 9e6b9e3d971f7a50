"""CUDA kernels against their plain versions, on the card.

Marked ``gpu``: each test decides inside itself whether a card exists and
skips without one.  The file imports no JAX, so it also runs where JAX is
not installed (without the suite's conftest, which imports it):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances are tests/test_kernels.py's: f32 1e-5, bf16 2e-2, Δ rtol 1e-4 /
atol 1e-2.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU host)")


@pytest.mark.gpu
@pytest.mark.parametrize("k,m,d", [(1, 20, 47571), (4, 20, 47571),
                                   (20, 20, 47571), (100, 100, 4099),
                                   (3, 5, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixing_aggregate_kernel_matches_plain(k, m, d, dtype):
    _require_cuda()
    gen = torch.Generator(device="cuda").manual_seed(k + m)
    w = torch.rand((k, m), generator=gen, device="cuda")
    w = w / w.sum(1, keepdim=True)
    theta = torch.randn((m, d), generator=gen, device="cuda").to(dtype)
    n0 = ops.LAUNCHES["mixing_aggregate"]
    got = ops.mixing_aggregate(w, theta)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mixing_aggregate"] == n0 + 1
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(),
                               ref.mixing_aggregate_ref(w, theta).float(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("m,d", [(20, 47571), (100, 47571), (17, 31)])
def test_gram_kernel_matches_plain(m, d):
    _require_cuda()
    g = torch.randn((m, d), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(m))
    torch.testing.assert_close(ops.gram_matrix(g), ref.gram_ref(g),
                               rtol=1e-4, atol=1e-2)
    got = ops.pairwise_sqdist(g)
    torch.cuda.synchronize()
    # assembled from the plain Gram, as the kernel path is (the separately
    # summed norms of pairwise_sqdist_ref leave ~1e-2 on its diagonal here)
    torch.testing.assert_close(got, ref.sqdist_from_gram(ref.gram_ref(g)),
                               rtol=1e-4, atol=1e-2)
    assert torch.equal(got, got.T)
    assert torch.all(torch.diagonal(got) == 0)


@pytest.mark.gpu
def test_kernels_refuse_what_they_do_not_take():
    _require_cuda()
    theta = torch.randn((4, 9), device="cuda")
    with pytest.raises(TypeError):
        ops.mixing_aggregate(torch.ones(2, 4, device="cuda"),
                             theta.to(torch.float16))
    with pytest.raises(ValueError):
        ops.mixing_aggregate(torch.ones(2, 5, device="cuda"), theta)
    with pytest.raises(ValueError):
        ops.mixing_aggregate(torch.ones(2, 9, device="cuda"), theta.T)
