"""The torch executor's accumulating scatters against the JAX package's, on the CPU.

``thunder_tpu_torch/executors/torchex.py`` sums the embedding backward and
``scatter_add`` with ops that add in a fixed order on each device: on CUDA
``index_put`` with ``accumulate=True`` (a stable sort, then each run of equal
indices added in order; the ``cuda`` tests in ``test_torch_port_cuda.py``
hold its bits from run to run), on the CPU ``index_add_`` and
``scatter_add``. Here both are held against ``thunder_tpu/executors/jaxex.py``'s
``.at[...].add`` on the same inputs, made with numpy from a seed, with many
duplicate indices (4096 rows into 16, ~256 a row).

Tolerances, against the largest |value| of the JAX result:
- f32: 1e-5, sums of ~256 unit-normal terms added in another order.
- bf16, the CUDA path's ``index_put`` form run on CPU tensors: two bf16
  ulps (2^-6). Both packages add one update at a time into the bf16 output
  in index order.
- bf16, the CPU ops: 2^-3. JAX rounds each of the ~256 adds of a row to
  bf16 (up to 2^-9 of the running sum each, a random walk of ~16 * 2^-9 =
  2^-5 of the sum), where torch's CPU ops keep more precision between adds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.executors import jaxex

from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.executors import torchex

_JDT = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def _pair(a: np.ndarray, dtype):
    """``a`` as a torch tensor of ``dtype`` and the same values as a jnp array."""
    t = torch.from_numpy(a).to(dtype)
    return t, jnp.asarray(t.float().numpy(), dtype=_JDT[dtype])


def _assert_close(got: torch.Tensor, want, rel: float) -> None:
    got, want = got.float().numpy(), np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), err


def _scatter_inputs(dtype, dim):
    rng = np.random.RandomState(1)
    a, ja = _pair(rng.randn(16, 16).astype(np.float32), dtype)
    idx = rng.randint(0, 16, (4096, 16) if dim == 0 else (16, 4096))
    val, jval = _pair(rng.randn(*idx.shape).astype(np.float32), dtype)
    want = jaxex._scatter_add(ja, jnp.asarray(idx), jval, dim)
    return a, torch.from_numpy(idx), val, want


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -3)])
@pytest.mark.parametrize("idx_shape", [(4096,), (2, 2048)])
def test_embedding_backward_matches_jax(dtype, rel, idx_shape):
    rng = np.random.RandomState(0)
    V, E = 16, 48
    idx = rng.randint(0, V, idx_shape)
    g, jg = _pair(rng.randn(*idx_shape, E).astype(np.float32), dtype)
    got = torchex._embedding_backward(g, torch.from_numpy(idx), V, E)
    want = jaxex._embedding_backward(jg, jnp.asarray(idx), V, E)
    assert got.dtype == dtype
    _assert_close(got, want, rel)


def test_embedding_backward_leaves_unused_rows_zero():
    idx = torch.tensor([3, 3, 5, 3])
    g = torch.ones((4, 2))
    got = torchex._embedding_backward(g, idx, 8, 2)
    assert got[:, 0].tolist() == [0, 0, 0, 3, 0, 1, 0, 0]


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -3)])
@pytest.mark.parametrize("dim", [0, 1])
def test_scatter_add_matches_jax(dtype, rel, dim):
    a, idx, val, want = _scatter_inputs(dtype, dim)
    _assert_close(torchex.ex.get_impl(PrimIDs.SCATTER_ADD)(a, idx, val, dim), want, rel)


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("dim", [0, 1])
def test_sorted_scatter_add_matches_jax(dtype, rel, dim):
    """The CUDA path's ``index_put`` form, on CPU tensors."""
    a, idx, val, want = _scatter_inputs(dtype, dim)
    _assert_close(torchex._scatter_add_sorted(a, idx, val, dim), want, rel)


def test_scatter_add_reads_val_over_the_index_extent():
    """torch's ``scatter_add`` reads ``val`` only where ``idx`` has entries;
    so does the ``index_put`` form."""
    a = torch.zeros(4, 3)
    idx = torch.tensor([[0, 1], [0, 3]])
    val = torch.arange(12.0).reshape(3, 4)
    assert torch.equal(torchex._scatter_add_sorted(a, idx, val, 0), a.scatter_add(0, idx, val))


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -6)])
def test_index_put_accumulate_matches_jax(dtype, rel):
    rng = np.random.RandomState(2)
    a, ja = _pair(rng.randn(16, 32).astype(np.float32), dtype)
    idx = rng.randint(0, 16, 4096)
    val, jval = _pair(rng.randn(4096, 32).astype(np.float32), dtype)
    got = torchex.ex.get_impl(PrimIDs.INDEX_PUT)(a, [torch.from_numpy(idx)], val, True)
    want = jaxex._index_put(ja, [jnp.asarray(idx)], jval, True)
    _assert_close(got, want, rel)
