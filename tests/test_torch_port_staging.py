"""Staging (``executors/staging.py``, the seat of ``jax.jit``) on the CPU.

A CUDA graph needs the card (``test_torch_port_cuda.py`` captures and
replays them); here the predicate that decides whether an entry stages is
checked as the JAX package's ``api.py:683-688`` decides it, with the reason
each unstaged entry records, and the repairs that let a program be captured:
a Python scalar beside a tensor becomes a 0-d CPU tensor of the tensor's
dtype, which torch passes to a CUDA kernel as an argument with no copy to
the device, and gives the bits it gave before (JAX's weak typing).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thunder_tpu
import thunder_tpu.torch as jtorch

import thunder_tpu_torch as tt
import thunder_tpu_torch.torch as ttorch
from thunder_tpu_torch.benchmarks import train
from thunder_tpu_torch.core.prims import PrimIDs
from thunder_tpu_torch.executors import fusedex, staging, torchex
from thunder_tpu_torch.models import gpt
from thunder_tpu_torch.parallel import build_train_step

CUDA = torch.device("cuda")  # a device to ask the predicate about; nothing runs on it


def _x(*shape, dtype=torch.float32, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32)).to(dtype)


def _claimed(fn, *args, **jit_kwargs):
    jf = tt.jit(fn, device="cpu", **jit_kwargs)
    out = jf(*args)
    return jf, out, tt.last_traces(jf)[-1]


def _masked_sdpa(q, m):
    return ttorch.scaled_dot_product_attention(q, q, q, attn_mask=m)


def _item(x):
    return x * 2.0, x.sum().item()


# (label, function, arguments, the reason's words)
UNSTAGED = [
    ("item", _item, lambda: (_x(4),), "item syncs the device"),
    ("masked sdpa", _masked_sdpa, lambda: (_x(1, 2, 128, 64, dtype=torch.bfloat16), torch.ones(128, dtype=torch.bool)),
     "flash executor's scaled_dot_product_attention reads a device value on the host"),
]


@pytest.mark.parametrize("label,fn,args,words", UNSTAGED, ids=[c[0] for c in UNSTAGED])
def test_a_host_read_leaves_the_entry_unstaged(label, fn, args, words):
    jf, _, trc = _claimed(fn, *args())
    stats = tt.last_staging(jf)
    assert not stats.staged and words in stats.reason
    # The same reason on the card: the trace decides it, not the device.
    assert words in staging.unstaged_reason([trc], CUDA)


def test_disable_jit_staging_and_the_cpu_device_leave_the_entry_unstaged():
    f = lambda x: x * 2.0 + 1.0  # noqa: E731
    jf, out, trc = _claimed(f, _x(4))
    assert torch.equal(out, _x(4) * 2.0 + 1.0)
    stats = tt.last_staging(jf)
    assert not stats.staged and stats.reason == "the cpu device has no CUDA graphs"
    assert (stats.captures, stats.replays, stats.guard_misses) == (0, 0, 0)
    # On the card the same trace stages, unless staging is disabled.
    assert staging.unstaged_reason([trc], CUDA) is None
    assert staging.unstaged_reason([trc], CUDA, disabled=True) == "disable_jit_staging=True"
    jf, _, _ = _claimed(f, _x(4), disable_jit_staging=True)
    assert tt.last_staging(jf).reason == "disable_jit_staging=True"
    assert jf._lc_cd.disable_jit_staging


def test_grad_and_value_and_grad_pass_disable_jit_staging_on():
    f = lambda x: (x * x).sum()  # noqa: E731
    for transform in (tt.grad, tt.value_and_grad):
        jf = transform(f, device="cpu", disable_jit_staging=True)
        jf(_x(4))
        assert jf._lc_cd.disable_jit_staging and tt.last_staging(jf).reason == "disable_jit_staging=True"


def test_an_unstaged_entry_is_the_trace_callable_itself():
    jf, _, trc = _claimed(lambda x: x + 1.0, _x(3))
    entry = jf._lc_cs.cache_entries[-1]
    assert entry.computation_fn.__thunder_trace__ is trc and entry.staging is tt.last_staging(jf)


def test_the_train_steps_record_their_staging():
    cfg = gpt.name_to_config("llama-hs100-tiny")
    tr = train.build_train(cfg, 1, 64, device="cpu")
    assert tr.staged == tr.run_step and tr.staging.reason == "the cpu device has no CUDA graphs"
    assert staging.unstaged_reason([tr.fw_trace, tr.bw_trace], CUDA) is None
    loss = tr.step()
    assert torch.isfinite(loss)
    params = gpt.init_params(cfg, seed=0, device="cpu")
    idx = torch.zeros((1, 64), dtype=torch.int64)
    step, opt, extrace = build_train_step(cfg, params, idx, idx, return_extrace=True)
    assert step is step.eager and step.staging.reason == "the cpu device has no CUDA graphs"
    assert staging.unstaged_reason([extrace], CUDA) is None


# =============================================================================
# The scalar-operand repair
# =============================================================================


def test_a_number_beside_a_tensor_becomes_a_cpu_scalar_of_its_dtype():
    like = torch.empty(3, dtype=torch.bfloat16, device="meta")
    t = torchex._as_tensor(0.9, like)
    assert t.device.type == "cpu" and t.dtype == torch.bfloat16 and t.ndim == 0
    assert float(t) == 0.8984375  # bf16(0.9), as JAX's weak typing takes it


@pytest.mark.parametrize("prim,jop", [
    (PrimIDs.MUL, lambda a, s: a * s), (PrimIDs.ADD, lambda a, s: a + s), (PrimIDs.SUB, lambda a, s: s - a),
    (PrimIDs.DIV, lambda a, s: a / s), (PrimIDs.MAXIMUM, lambda a, s: jnp.maximum(a, s)),
    (PrimIDs.POW, lambda a, s: a ** s),
])
def test_number_operands_give_jax_weak_typing_bits(prim, jop):
    x = np.abs(np.random.RandomState(0).randn(64).astype(np.float32)) + 0.5
    fn = torchex.ex.get_impl(prim)
    a, s = torch.from_numpy(x).to(torch.bfloat16), 0.9
    got = fn(s, a) if prim == PrimIDs.SUB else fn(a, s)
    want = np.asarray(jop(jnp.asarray(x, jnp.bfloat16), s), np.float32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_number_only_operands_stay_numbers():
    assert torchex.ex.get_impl(PrimIDs.ADD)(2, 3) == 5
    assert torchex.ex.get_impl(PrimIDs.MUL)(0.5, 3.0) == 1.5


def test_copy_and_tensor_from_sequence_of_numbers():
    dst = torch.zeros((2, 3), dtype=torch.bfloat16)
    got = torchex.ex.get_impl(PrimIDs.COPY_)(0.9, dst)
    assert torch.equal(got, torch.full((2, 3), 0.9, dtype=torch.bfloat16))
    seq = [[1.5, 2.0], [3.0, -4.25]]
    got = torchex.ex.get_impl(PrimIDs.TENSOR_FROM_SEQUENCE)(seq, device="cpu", dtype=None)
    assert torch.equal(got, torch.tensor(seq))

    jf = tt.jit(lambda x: x + ttorch.tensor([1.0, 2.0, 3.0]), device="cpu")
    jj = thunder_tpu.jit(lambda x: x + jtorch.tensor([1.0, 2.0, 3.0]))
    x = np.arange(3, dtype=np.float32)
    np.testing.assert_array_equal(jf(torch.from_numpy(x)).numpy(), np.asarray(jj(x)))


def test_ce_row_scale_of_a_number_equals_that_of_a_tensor():
    target = torch.tensor([0, 3, -100, 2])
    for g in (1.0, 0.7):
        by_number = fusedex.ce_row_scale(g, target, -100, "mean")
        by_tensor = fusedex.ce_row_scale(torch.tensor(g), target, -100, "mean")
        assert torch.equal(by_number, by_tensor) and by_number.dtype == torch.float32
