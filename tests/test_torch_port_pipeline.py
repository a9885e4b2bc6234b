"""Context, pipeline and expert parallelism (ROADMAP 11b) in one process,
against the JAX package.

- The ``ppermute`` and ``all_to_all`` VJPs at a group of one (a gloo group
  of one rank on a FileStore): each is the identity there, and the backward
  holds the transposed collective.
- ``_block_attn``, ring and Ulysses attention, ``moe_mlp`` and
  ``moe_mlp_dense_reference``, ``pipeline_apply``,
  ``split_params_for_pp`` and ``merge_pp_grads`` against the JAX package's
  functions on the same numpy inputs (the JAX side under ``shard_map`` over
  one device where it needs an axis).
- ``gpt_pp_loss_and_grads`` at pp=1, n_micro=4, both schedules, against the
  JAX package's at pp=1 (loss rtol 2e-5; grads rtol 1e-2, atol 3e-4,
  ``gpt_pipeline``'s own) and against the port's unpipelined program.
- A mesh naming pp, ep and sp at size 1 gives the one-device step bit for
  bit.

The multi-rank cases are ``tests/test_torch_port_parallel_ranks.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import thunder_tpu_torch as tt
import thunder_tpu_torch.torch as ttorch
from thunder_tpu_torch.core.pytree import tree_flatten
from thunder_tpu_torch.distributed import runtime
from thunder_tpu_torch.models import gpt as tgpt


def _shard_map():
    try:
        from jax.experimental.shard_map import shard_map
    except ImportError:
        from jax.shard_map import shard_map
    return shard_map


def _one_device(fn, in_specs, out_specs):
    """A JAX function of a named axis on a mesh of one device."""
    from thunder_tpu.parallel import make_mesh

    axis = next(a for s in in_specs for a in s if a is not None)
    return jax.jit(_shard_map()(fn, mesh=make_mesh(**{axis: 1}), in_specs=in_specs, out_specs=out_specs,
                                check_rep=False))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jit(fn, axes=("sp", "ep", "pp")):
    """``fn`` jitted on the CPU with ``axes`` bound to one rank and no group."""
    jf = tt.jit(fn, device="cpu")

    def call(*args):
        with runtime.bound_axes({ax: None for ax in axes}):
            return jf(*args)

    call.jfn = jf
    return call


# =============================================================================
# The VJP rules at a group of one
# =============================================================================


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    import thunder_tpu_torch.distributed as td

    store = torch.distributed.FileStore(str(tmp_path_factory.mktemp("store") / "s"), 1)
    info = td.init(device="cpu", store=store, num_processes=1, process_id=0)
    yield info
    td.shutdown()
    assert not td.is_initialized()


@pytest.mark.parametrize("prim", ["ppermute", "all_to_all"])
def test_vjp_is_the_identity_at_one_rank(one_rank, prim):
    """At a group of one, grad of sum(w · prim(x)) is w, through the rule's
    transposed collective: ppermute's pair (0, 0) reversed, all_to_all's
    split and concat dims swapped."""
    from thunder_tpu_torch.distributed import prims as dist
    from thunder_tpu_torch.distributed.runtime import P, compile_with_collectives

    rng = np.random.RandomState(0)
    x, w = (torch.from_numpy(rng.randn(4, 6).astype(np.float32)) for _ in range(2))
    call = {"ppermute": lambda a: dist.ppermute(a, "dp", [(0, 0)]),
            "all_to_all": lambda a: dist.all_to_all(a, "dp", 1, split_dim=1, concat_dim=0)}[prim]
    jf, extrace = compile_with_collectives(lambda x, w: ttorch.sum(w * call(x)), (x, w), None, (P(), P()),
                                           (P(), (P(), P())), grad=True)
    loss, (gx, gw) = jf(x, w)
    assert torch.equal(gx, w) and torch.equal(gw, x)
    torch.testing.assert_close(loss, (w * x).sum())
    sites = [b for b in extrace.bound_symbols if b.sym.name == prim]
    assert len(sites) == 2  # the forward's and its transpose
    if prim == "all_to_all":
        assert [(b.kwargs["split_dim"], b.kwargs["concat_dim"]) for b in sites] == [(1, 0), (0, 1)]


def test_transposed_hop_runs_where_no_cotangent_reaches(one_rank):
    """A hop whose result this rank discards (a pipeline's first stage
    receives from no one) is kept by dce and transposed in the backward
    with a zero cotangent, so that the rank still posts its half of the
    reverse hop."""
    from thunder_tpu_torch.distributed import prims as dist
    from thunder_tpu_torch.distributed.runtime import P, compile_with_collectives

    x = torch.ones(3, 2)

    def f(x):
        dist.ppermute(x, "dp", [])  # discarded
        return ttorch.sum(x * 2.0)

    jf, extrace = compile_with_collectives(f, (x,), None, (P(),), (P(), (P(),)), grad=True)
    loss, (gx,) = jf(x)
    assert float(loss) == 12.0 and torch.equal(gx, torch.full((3, 2), 2.0))
    assert [b.sym.name for b in extrace.bound_symbols].count("ppermute") == 2


# =============================================================================
# Context parallelism
# =============================================================================


@pytest.mark.parametrize("offsets", [(0, 0), (16, 0), (0, 16), (16, 16)])
def test_block_attn_matches_jax(offsets):
    """One causal block at global offsets, including one whose keys are all
    in the future of its queries (q 0..15 against k 16..31: every row fully
    masked, zero weights and no NaN): o, m, l against the JAX package's
    (rtol 1e-5, atol 1e-6)."""
    from thunder_tpu.parallel.context import _block_attn as jax_block
    from thunder_tpu_torch.parallel.context import _block_attn

    q_off, k_off = offsets
    rng = np.random.RandomState(1)
    q, k, v = ((rng.randn(2, 3, 16, 8) * 0.5).astype(np.float32) for _ in range(3))
    kw = dict(scale=0.35, q_offset=q_off, k_offset=k_off, causal=True)
    got = _jit(lambda q, k, v: _block_attn(q, k, v, **kw))(_t(q), _t(k), _t(v))
    want = jax_block(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("which", ["ring", "ulysses"])
def test_sequence_parallel_attention_at_one_rank(which):
    """Ring and Ulysses attention at sp=1 (no collective) against the JAX
    package's on one device, and their grads against the JAX package's
    ring grads (rtol 1e-4, atol 1e-5)."""
    from thunder_tpu.parallel import context as jctx
    from thunder_tpu_torch.parallel import context

    fn = context.ring_attention if which == "ring" else context.ulysses_attention
    rng = np.random.RandomState(2)
    q, k, v = ((rng.randn(2, 4, 32, 16) * 0.5).astype(np.float32) for _ in range(3))
    spec = JP(None, None, "sp", None)
    jf = _one_device(lambda q, k, v: jctx.ring_attention(q, k, v, "sp"), (spec,) * 3, spec)
    got = _jit(lambda q, k, v: fn(q, k, v, "sp"))(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(jf(q, k, v)), rtol=1e-4, atol=1e-5)
    vg = tt.value_and_grad(lambda q, k, v: ttorch.sum(fn(q, k, v, "sp") ** 2), device="cpu")
    with runtime.bound_axes({"sp": None}):
        _, grads = vg(_t(q), _t(k), _t(v))
    want = jax.grad(lambda q, k, v: (jf(q, k, v) ** 2).sum(), argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


def test_ulysses_refuses_heads_that_do_not_split(monkeypatch):
    from thunder_tpu_torch.parallel import context

    monkeypatch.setattr(runtime, "axis_size", lambda axis: 3)
    q = torch.zeros(1, 4, 8, 2)
    with pytest.raises(ValueError, match="4 heads do not split over the 3 ranks"):
        _jit(lambda q: context.ulysses_attention(q, q, q, "sp"))(q)


# =============================================================================
# Expert parallelism
# =============================================================================


def _moe_inputs(seed=0, E=8, d=32, h=64, n=32):
    rng = np.random.RandomState(seed)
    return ((rng.randn(n, d) * 0.5).astype(np.float32), (rng.randn(d, E) * 0.3).astype(np.float32),
            (rng.randn(E, d, h) * 0.2).astype(np.float32), (rng.randn(E, h, d) * 0.2).astype(np.float32))


@pytest.mark.parametrize("largest", [True, False])
def test_topk_breaks_ties_as_lax_top_k(largest):
    """The router's topk: on ties the lower index first, as ``lax.top_k``
    (the JAX package's topk; the smallest through top_k of the negation)
    orders them; the capacity's slot accounting follows this order."""
    import thunder_tpu_torch.torch as ltorch

    x = np.array([[0.25, 0.5, 0.25, 0.5, 0.0, 0.5, 0.0, 0.0], [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]], np.float32)
    values, ids = tt.jit(lambda p: ltorch.topk(p, 3, -1, largest=largest), device="cpu")(_t(x))
    want_v, want_i = jax.lax.top_k(jnp.asarray(x if largest else -x), 3)
    assert ids.tolist() == np.asarray(want_i).tolist()
    np.testing.assert_array_equal(values.numpy(), np.asarray(want_v if largest else -want_v))


def test_moe_dense_reference_matches_jax():
    """The dense oracle (tanh gelu, top-2 of the softmax) against the JAX
    package's, and its grads against ``jax.grad``'s (rtol 1e-4, atol
    1e-5)."""
    from thunder_tpu.parallel.moe import moe_mlp_dense_reference as jax_dense
    from thunder_tpu_torch.parallel.moe import moe_mlp_dense_reference

    args = _moe_inputs()
    got = _jit(moe_mlp_dense_reference)(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_dense(*args)), rtol=1e-4, atol=1e-5)
    _, grads = tt.value_and_grad(lambda *a: ttorch.sum(moe_mlp_dense_reference(*a) ** 2), device="cpu")(
        *map(_t, args))
    want = jax.grad(lambda *a: (jax_dense(*a) ** 2).sum(), argnums=(0, 1, 2, 3))(*args)
    for a, b in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("capacity", [None, 3, 1])
def test_moe_mlp_at_one_rank_matches_jax(capacity):
    """``moe_mlp`` at ep=1 against the JAX package's on one device, with
    the no-drop default and with capacities that drop tokens (rtol 1e-4,
    atol 1e-5), and the kept assignments of ``dispatch_plan`` against the
    host count of slots a (token, choice) in token order."""
    from thunder_tpu.parallel.moe import moe_mlp as jax_moe
    from thunder_tpu_torch.parallel.moe import dispatch_plan, moe_mlp

    x, rw, w1, w2 = args = _moe_inputs(seed=1)
    specs = (JP("ep", None), JP(), JP("ep", None, None), JP("ep", None, None))
    jf = _one_device(lambda *a: jax_moe(*a, "ep", capacity=capacity), specs, JP("ep", None))
    got = _jit(lambda *a: moe_mlp(*a, "ep", capacity=capacity))(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(jf(*args)), rtol=1e-4, atol=1e-5)
    C = capacity or len(x)
    dispatch, _ = _jit(lambda x, rw: dispatch_plan(x, rw, 8, 2, C))(_t(x), _t(rw))
    z = x @ rw
    probs = np.exp(z - z.max(-1, keepdims=True))
    order = np.argsort(-probs, axis=-1, kind="stable")[:, :2]
    used, kept = np.zeros(8, int), 0
    for t in range(len(x)):
        for e in order[t]:
            kept += used[e] < C
            used[e] += 1
    assert int(dispatch.sum()) == kept


# =============================================================================
# Pipeline parallelism
# =============================================================================


def test_pipeline_apply_at_one_stage_matches_jax():
    """GPipe at pp=1 with shape-changing adapters (first_fn scales,
    last_fn reduces each microbatch against its targets): the outputs
    against the JAX package's (rtol 1e-5, atol 1e-6)."""
    from thunder_tpu.parallel.pipeline import pipeline_apply as jax_apply
    from thunder_tpu_torch.parallel.pipeline import pipeline_apply

    rng = np.random.RandomState(3)
    w, xs, tgt = rng.randn(8, 8).astype(np.float32), rng.randn(4, 2, 8).astype(np.float32), \
        rng.randn(4, 2, 8).astype(np.float32)

    def run(lib, stage, first, last):
        return lambda w, xs, tgt: lib(stage, w, {"x": xs, "t": tgt}, "pp", first_fn=first, last_fn=last,
                                      act_shape=(2, 8), act_dtype=xs.dtype)

    got = _jit(run(pipeline_apply, lambda w, a: ttorch.tanh(a @ w), lambda w, mb: mb["x"] * 2.0,
                   lambda w, y, mb: ttorch.mean((y - mb["t"]) ** 2)))(_t(w), _t(xs), _t(tgt))
    jrun = run(jax_apply, lambda w, a: jnp.tanh(a @ w), lambda w, mb: mb["x"] * 2.0,
               lambda w, y, mb: jnp.mean((y - mb["t"]) ** 2))
    jf = _one_device(lambda w, xs, tgt: jrun(w[0], xs, tgt), (JP("pp"), JP(), JP()), JP())
    np.testing.assert_allclose(got.numpy(), np.asarray(jf(w[None], xs, tgt)), rtol=1e-5, atol=1e-6)


def test_pipeline_1f1b_needs_last_fn():
    from thunder_tpu_torch.parallel.pipeline import pipeline_1f1b

    with runtime.bound_axes({"pp": None}), pytest.raises(ValueError, match="requires last_fn"):
        pipeline_1f1b(lambda p, x: x, torch.zeros(2), torch.zeros(4, 2), "pp")


PP_CONFIG = dict(name="pp-test", block_size=64, vocab_size=96, padded_vocab_size=96, n_layer=2, n_head=4, n_embd=32,
                 n_query_groups=2, rotary_percentage=1.0, parallel_residual=False, bias=False, norm_class="RMSNorm",
                 mlp_class="LLaMAMLP", intermediate_size=88)


def _pp_params(n_layer=2):
    cfg = tgpt.GPTConfig(**{**PP_CONFIG, "n_layer": n_layer})
    rng = np.random.RandomState(0)

    def make(shape, init):
        if init == "ones":
            return np.ones(shape, np.float32)
        if init == "zeros":
            return np.zeros(shape, np.float32)
        return (rng.randn(*shape) * init).astype(np.float32)

    return cfg, tgpt._map_spec(tgpt._param_shapes(cfg), make)


def _by_path(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _by_path(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _by_path(sub, f"{path}/{i}").items()}
    return {path: np.asarray(tree.detach() if hasattr(tree, "detach") else tree)}


@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_split_and_merge_match_jax(n_stages):
    """``split_params_for_pp`` stacks each stage's blocks as the JAX
    package's does, leaf for leaf, and ``merge_pp_grads`` undoes it."""
    from thunder_tpu.parallel import gpt_pp as jpp
    from thunder_tpu_torch.parallel import gpt_pp

    _, np_params = _pp_params(n_layer=4)
    got = gpt_pp.split_params_for_pp(tgpt.params_from_jax(np_params, device="cpu"), n_stages)
    want = jpp.split_params_for_pp(jax.tree_util.tree_map(jnp.asarray, np_params), n_stages)
    g, w = _by_path(got), _by_path(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    merged = _by_path(gpt_pp.merge_pp_grads(got, n_stages, 4))
    ref = _by_path(jpp.merge_pp_grads(want, n_stages, 4))
    assert merged.keys() == ref.keys() == _by_path(np_params).keys()
    for k in ref:
        np.testing.assert_array_equal(merged[k], ref[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_pp():
    """The JAX package's pipelined (loss, grads) at pp=1 for each schedule."""
    from thunder_tpu.models import gpt as jgpt
    from thunder_tpu.parallel import make_mesh
    from thunder_tpu.parallel.gpt_pp import gpt_pp_loss_and_grads

    _, np_params = _pp_params()
    cfg = jgpt.GPTConfig(**PP_CONFIG)
    idx, tgt = _pp_tokens()
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    return {s: gpt_pp_loss_and_grads(cfg, params, idx.astype(np.int32), tgt.astype(np.int32), make_mesh(pp=1),
                                     n_micro=4, schedule=s) for s in ("gpipe", "1f1b")}


def _pp_tokens():
    idx = np.random.RandomState(0).randint(0, PP_CONFIG["vocab_size"], (8, 16))
    return idx, np.roll(idx, -1, axis=1)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_gpt_pp_at_one_stage(jax_pp, schedule):
    """``gpt_pp_loss_and_grads`` at pp=1, n_micro=4: the loss within 2e-5
    and every grad leaf within rtol 1e-2, atol 3e-4 of the JAX package's
    and of the port's unpipelined program (``gpt_pipeline``'s limits); a
    second call reuses the built step; 1F1B's stash held one input and,
    the only stage being the last, it ran no stage forward."""
    from thunder_tpu_torch.parallel import make_mesh
    from thunder_tpu_torch.parallel.gpt_pp import gpt_pp_loss_and_grads
    from thunder_tpu_torch.parallel.train import _compile_loss_and_grads

    cfg, np_params = _pp_params()
    params = tgpt.params_from_jax(np_params, device="cpu")
    idx, tgt = map(torch.from_numpy, _pp_tokens())
    mesh = make_mesh(pp=1)
    loss, grads = gpt_pp_loss_and_grads(cfg, params, idx, tgt, mesh, n_micro=4, schedule=schedule)
    lg, _ = _compile_loss_and_grads(cfg, params, idx, tgt, executors=["torch"])
    ref_loss, ref_grads = lg(*tree_flatten(params)[0], idx, tgt)
    jloss, jgrads = jax_pp[schedule]
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-5)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=2e-5)
    got, want = _by_path(grads), _by_path(jgrads)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-2, atol=3e-4, err_msg=k)
    for a, b in zip(tree_flatten(grads)[0], ref_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-2, atol=3e-4)
    step = gpt_pp_loss_and_grads.last_step
    loss2, _ = gpt_pp_loss_and_grads(cfg, params, idx, tgt, mesh, n_micro=4, schedule=schedule)
    assert gpt_pp_loss_and_grads.last_step is step and step.mesh is mesh and torch.equal(loss, loss2)
    assert (step.schedule is None) == (schedule == "gpipe")
    if schedule == "1f1b":
        assert step.schedule.stats == {"ticks": 8, "fwd_calls": 0, "bwd_calls": 4, "stash_peak": 1}
        assert step.schedule.fwd is None and len(step.traces) == 1


def test_gpt_pp_refuses_what_does_not_split():
    from thunder_tpu_torch.parallel import make_mesh
    from thunder_tpu_torch.parallel.gpt_pp import gpt_pp_loss_and_grads, split_params_for_pp

    cfg, np_params = _pp_params()
    params = tgpt.params_from_jax(np_params, device="cpu")
    idx = torch.zeros(6, 16, dtype=torch.int64)
    with pytest.raises(ValueError, match="a batch of 6 does not split into 4 microbatches"):
        gpt_pp_loss_and_grads(cfg, params, idx, idx, make_mesh(pp=1), n_micro=4)
    with pytest.raises(ValueError, match="2 layers do not split over 3 pipeline stages"):
        split_params_for_pp(params, 3)


# =============================================================================
# The sharded step on a mesh naming pp, ep and sp at size 1
# =============================================================================


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_mesh_of_pp_ep_sp_at_one_is_the_one_device_step(optimizer):
    """``make_mesh(pp=1, ep=1, sp=1)`` (no process group): the step's
    program holds no collective and equals the unmeshed one line for line;
    3 steps' losses and the params after them bit for bit."""
    from thunder_tpu_torch.distributed import prims as dist_prims
    from thunder_tpu_torch.parallel import build_train_step, data_spec, make_mesh

    cfg = tgpt.name_to_config("llama-tiny")
    mesh = make_mesh(pp=1, ep=1, sp=1)
    assert tuple(data_spec(mesh)) == (None, None)
    idx = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (4, 16)))
    tgt = torch.roll(idx, -1, 1)
    runs = []
    for m in (None, mesh):
        p = tgpt.init_params(cfg, dtype=torch.float32, seed=2, device="cpu")
        step, opt, ex = build_train_step(cfg, p, idx, tgt, mesh=m, lr=1e-2, optimizer=optimizer,
                                         return_extrace=True)
        losses = []
        for _ in range(3):
            p, opt, loss = step(p, opt, idx, tgt)
            losses.append(loss)
        runs.append((losses, tree_flatten(p)[0], ex))
    (l0, p0, ex0), (l1, p1, ex1) = runs
    assert not [b for b in ex1.bound_symbols if dist_prims.is_collective_bsym(b)]
    assert [b.sym.name for b in ex0.bound_symbols] == [b.sym.name for b in ex1.bound_symbols]
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
