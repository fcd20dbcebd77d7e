"""The port's `ops/swap_align2nat.swap_align2nat` against the JAX package's
op: forward within atol 1e-5 and the input gradient of sum(out * G) within
1e-5 * max|jax.grad|, at lambda 1, 2 and 3. Each shape has output elements
whose 16 taps reach outside the input, so `pad_val` enters both. Inputs are
numpy from a seed; fp32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagdressing_tpu.ops.swap_align2nat import swap_align2nat as jax_swap
from imagdressing_tpu_torch.ops.swap_align2nat import swap_align2nat


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("lam,v,h,w", [(1, 3, 5, 4), (2, 3, 6, 7),
                                       (3, 2, 7, 5)])
def test_swap_align2nat_matches_jax(lam, v, h, w):
    rng = np.random.default_rng(lam)
    x = rng.standard_normal((2, h, w, v * v)).astype(np.float32)
    want = np.asarray(jax_swap(jnp.asarray(x), lam))
    xt = torch.from_numpy(x).requires_grad_()
    got = swap_align2nat(xt, lam)
    assert got.shape == want.shape == (
        2, -(-h // lam), -(-w // lam), (lam * v) ** 2)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    # pad_val reaches the output: a constant input of 0 gives -6 * (the
    # weight of the outside taps) there, not 0 everywhere
    zero = swap_align2nat(torch.zeros(x.shape), lam)
    np.testing.assert_allclose(zero.numpy(), np.asarray(jax_swap(
        jnp.zeros(x.shape), lam)), atol=1e-5)
    assert float(zero.min()) < -1.0

    g = rng.standard_normal(want.shape).astype(np.float32)
    want_dx = np.asarray(jax.jit(jax.grad(
        lambda a: jnp.sum(jax_swap(a, lam) * g)))(jnp.asarray(x)))
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want_dx,
                               atol=1e-5 * float(np.abs(want_dx).max()),
                               rtol=0)
