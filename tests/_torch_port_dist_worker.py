"""The multi-rank scenarios of ``tests/test_torch_port_distributed_ranks.py``.

Each scenario of ``tests/_dist_worker.py`` that item 10 of the port covers,
written twice over the same inputs (one numpy seed; torch modules from one
torch seed, which the JAX package's module frontend takes as they are):

    python tests/_torch_port_dist_worker.py torch RANK WORLD STORE OUT [CKPT [SCENARIOS]]
        one gloo rank of the port (``thunder_tpu_torch.distributed``),
        rendezvous on the FileStore STORE; writes OUT/rank<RANK>.json;
        SCENARIOS (comma-separated) runs those in place of the size's list;
    python tests/_torch_port_dist_worker.py jax WORLD OUT [SCENARIOS]
        the JAX package on WORLD virtual CPU devices (run it with
        ``XLA_FLAGS=--xla_force_host_platform_device_count=WORLD``); writes
        OUT/jax.json.

SCENARIOS may name a group: "@train" (the sharded step over dp, fsdp and
tp), "@parallel" (context, pipeline and expert parallelism, and the step
over pp, ep and sp), "@resilience" (the recovery layer: a synced
preemption, the SDC guard, host loss and the elastic resume, reshards, the
collective watchdog).

A scenario returns the numbers the test compares (lists of floats) and its
own checks' verdicts; each runs under a time limit of its own, and after a
failure a rank runs no further scenario (its peers would wait on it).
"""

import json
import os
import signal
import sys
import time
import traceback

import numpy as np

LIMIT_S = 60  # each scenario, each rank
VOCAB, B, T = 64, 8, 16


def _tiny_gpt():
    """The module of ``tests/_dist_worker.py``'s module scenarios: every
    weight's dim 0 divides by 2 and 4."""
    import torch
    import torch.nn as nn
    import torch.nn.functional as F

    class Block(nn.Module):
        def __init__(self, dim=32, heads=4):
            super().__init__()
            self.dim, self.heads = dim, heads
            self.norm1 = nn.LayerNorm(dim)
            self.qkv = nn.Linear(dim, 3 * dim, bias=False)
            self.proj = nn.Linear(dim, dim, bias=False)
            self.norm2 = nn.LayerNorm(dim)
            self.fc = nn.Linear(dim, 4 * dim)
            self.out = nn.Linear(4 * dim, dim)

        def forward(self, x):
            Bx, Tx, C = x.shape
            h = self.norm1(x)
            qkv = self.qkv(h).view(Bx, Tx, 3, self.heads, C // self.heads)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            y = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            x = x + self.proj(y.transpose(1, 2).reshape(Bx, Tx, C))
            return x + self.out(F.gelu(self.fc(self.norm2(x))))

    class TinyGPT(nn.Module):
        def __init__(self, vocab=VOCAB, dim=32, n_layer=2):
            super().__init__()
            self.wte = nn.Embedding(vocab, dim)
            self.blocks = nn.ModuleList([Block(dim) for _ in range(n_layer)])
            self.ln_f = nn.LayerNorm(dim)
            self.head = nn.Linear(dim, vocab, bias=False)

        def forward(self, idx):
            x = self.wte(idx)
            for b in self.blocks:
                x = b(x)
            return self.head(self.ln_f(x))

    torch.manual_seed(0)
    return TinyGPT()


def _tokens(k: int = 1, seed: int = 0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, VOCAB, (k, B, T)), rng.randint(0, VOCAB, (k, B, T))


def _reducers():
    import torch

    class Reducer(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(4, 4, bias=False)

        def forward(self, x):
            return self.lin(x).mean(dim=0)

    class Masked(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(16, 16, bias=False)

        def forward(self, x, mask):
            return self.lin(x) + mask.sum()  # mask is (T, T): not the batch

    torch.manual_seed(0)
    return Reducer(), Masked()


def _grid_input():
    return np.arange(8 * 4, dtype=np.float32).reshape(8, 4)


# The sharded training step's cases: (config, mesh axes, specs), each a JAX
# scenario of tests/_dist_worker.py at the mesh shapes 2 and 4 ranks hold.
TRAIN_CASES = {
    2: {"ddp_train": ("gpt-tiny", {"dp": 2}, "replicated"),
        "fsdp_train": ("llama-tiny", {"fsdp": 2}, "fsdp"),
        "tp_fsdp_train": ("llama-tiny", {"tp": 2}, "full")},
    4: {"ddp_train": ("gpt-tiny", {"dp": 4}, "replicated"),
        "fsdp_train": ("llama-tiny", {"fsdp": 4}, "fsdp"),
        "tp_fsdp_train": ("llama-tiny", {"fsdp": 2, "tp": 2}, "full"),
        "dp_tp_train": ("gpt-tiny", {"dp": 2, "tp": 2}, "full")},
}
TRAIN_B, TRAIN_T, TRAIN_STEPS = 8, 16, 2


def _np_params(cfg_name: str) -> dict:
    """The params of a config as float32 numpy arrays from one seed, in the
    structure both packages' ``init_params`` give."""
    from thunder_tpu_torch.models import gpt as m

    return _np_params_of(m.name_to_config(cfg_name))


def _np_params_of(config) -> dict:
    """:func:`_np_params` of a config (either package's ``GPTConfig``)."""
    from thunder_tpu_torch.models import gpt as m

    rng = np.random.RandomState(0)

    def make(shape, init):
        if init == "ones":
            return np.ones(shape, np.float32)
        if init == "zeros":
            return np.zeros(shape, np.float32)
        return (rng.randn(*shape) * init).astype(np.float32)

    return m._map_spec(m._param_shapes(config), make)


def mlp_extrace(layers=3, d=64, B=16, fsdp=4, tp=2, grad=True):
    """The fsdp x tp explicit-collective MLP's claimed fw(+bw) trace of
    ``tests/test_comm_schedule.py``, through the port (the torch executor)."""
    import torch

    import thunder_tpu_torch.clang as clang
    from thunder_tpu_torch.api import trace_program
    from thunder_tpu_torch.distributed import prims as dist_prims
    from thunder_tpu_torch.executors.passes import transform_for_execution
    from thunder_tpu_torch.extend import resolve_executors
    from thunder_tpu_torch.transforms.autodiff import grad_transform
    from thunder_tpu_torch.transforms.common import dce

    rng = np.random.RandomState(0)
    ws = [torch.from_numpy(rng.randn(d // fsdp, d).astype(np.float32)) for _ in range(layers)]
    x = torch.from_numpy(rng.randn(B, d).astype(np.float32))

    def loss(*flat_in):
        *w_shards, xv = flat_in
        h = xv
        for w_shard in w_shards:
            w_full = dist_prims.synchronize(w_shard, "fsdp", fsdp, "fsdp")
            h = clang.matmul(h, clang.transpose(w_full, 0, 1))
            h = dist_prims.all_reduce(h, "tp", tp, op="avg")
            h = clang.tanh(h)
        return clang.mean(clang.mul(h, h))

    _, comp = trace_program(loss, (*ws, x), {})
    comp = dce(comp)
    if grad:
        comp = grad_transform(comp, return_value=True)
    return transform_for_execution(comp, resolve_executors(["torch"]))


def _train_tokens(vocab: int):
    idx = np.random.RandomState(0).randint(0, vocab, (TRAIN_B, TRAIN_T))
    return idx, np.roll(idx, -1, axis=1)


def _flat(t) -> list:
    t = t.detach() if hasattr(t, "detach") else t
    return np.asarray(t, dtype=np.float64).ravel().tolist()


def _flat_tree(tree, path: str = "") -> dict:
    """{"/blocks/0/attn/qkv_w": flat values, ...} of a params tree, the
    same keys for either package's tree (their flattening orders differ)."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _flat_tree(tree[key], f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat_tree(sub, f"{path}/{i}").items()}
    return {path: _flat(tree)}


# -- the inputs of the context, pipeline and expert scenarios (ROADMAP 11b):
# tests/_dist_worker.py's, at 4 ranks in place of 8 -------------------------

LC_B, LC_H, LC_S, LC_D, LC_V = 2, 2, 128, 8, 32
MOE_E, MOE_D, MOE_H, MOE_N, MOE_TOPK, MOE_CAP = 8, 32, 64, 32, 2, 1
MOE_SEEDS = {False: 0, True: 1}  # moe_ep's seed, moe_capacity's
PP_CONFIG = dict(name="pp-test", block_size=64, vocab_size=96, padded_vocab_size=96, n_layer=4, n_head=4, n_embd=32,
                 n_query_groups=2, rotary_percentage=1.0, parallel_residual=False, bias=False, norm_class="RMSNorm",
                 mlp_class="LLaMAMLP", intermediate_size=88)
PP_B, T_PP = 8, 32
# The sharded SGD step over pp, ep and sp: (config, mesh axes, "full" where
# tp splits the weights too).
PARALLEL_TRAIN_CASES = {
    2: {"sp_train": ("llama-tiny", {"sp": 2}, ""),
        "pp_train": ("gpt-tiny", {"pp": 2}, ""),
        "ep_train": ("gpt-tiny", {"ep": 2}, "")},
    4: {"dp_sp_train": ("llama-tiny", {"dp": 2, "sp": 2}, ""),
        "fsdp_sp_train": ("llama-tiny", {"fsdp": 2, "sp": 2}, ""),
        "sp_tp_train": ("llama-tiny", {"sp": 2, "tp": 2}, "full")},
}


def _qkv(which: str):
    """ring_attention's (B, H, S, D) = (2, 4, 64, 16) from seed 0, or
    ulysses_attention's (2, 8, 64, 16) from seed 1."""
    H, seed = (4, 0) if which == "ring" else (8, 1)
    rng = np.random.RandomState(seed)
    return [(rng.randn(2, H, 64, 16) * 0.5).astype(np.float32) for _ in range(3)]


def _plain_attention(q, k, v):
    """Causal softmax attention in f32 (the scenarios' ``_full_attention``)."""
    import torch

    S = q.shape[-2]
    s = (q @ k.transpose(-1, -2)) / np.sqrt(q.shape[-1])
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), float("-inf"))
    return torch.softmax(s, -1) @ v


def _long_context_inputs():
    rng = np.random.RandomState(2)
    wq = (rng.randn(LC_H * LC_D, LC_H * LC_D) * 0.1).astype(np.float32)
    wo = (rng.randn(LC_V, LC_H * LC_D) * 0.1).astype(np.float32)
    x = rng.randn(LC_B, LC_S, LC_H * LC_D).astype(np.float32)
    return wq, wo, x, rng.randint(0, LC_V, (LC_B, LC_S))


def _moe_np(seed: int):
    rng = np.random.RandomState(seed)
    return ((rng.randn(MOE_N, MOE_D) * 0.5).astype(np.float32), (rng.randn(MOE_D, MOE_E) * 0.3).astype(np.float32),
            (rng.randn(MOE_E, MOE_D, MOE_H) * 0.2).astype(np.float32),
            (rng.randn(MOE_E, MOE_H, MOE_D) * 0.2).astype(np.float32))


def _moe_inputs(seed: int):
    import torch

    return tuple(torch.from_numpy(a) for a in _moe_np(seed))


def _moe_capacity_oracle(x, rw, w1, w2, world: int):
    """moe_capacity's numpy replication of the routing and the slot
    accounting, a source rank at a time (plain loops, not einsums):
    (outputs, dropped assignments, all assignments)."""
    def softmax(z):
        e = np.exp(z - z.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    def expert(z, e):
        h = z @ w1[e]
        h = 0.5 * h * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (h + 0.044715 * h ** 3)))  # gelu, tanh
        return h @ w2[e]

    n_local = len(x) // world
    want, kept = np.zeros_like(x), 0
    for s in range(world):
        xs = x[s * n_local:(s + 1) * n_local]
        probs = softmax(xs @ rw)
        order = np.argsort(-probs, axis=-1, kind="stable")[:, :MOE_TOPK]
        top_p = np.take_along_axis(probs, order, axis=-1)
        used = np.zeros(MOE_E, dtype=int)
        for t in range(n_local):
            acc = np.zeros(MOE_D, dtype=np.float64)
            for k in range(MOE_TOPK):
                e = order[t, k]
                if used[e] < MOE_CAP:
                    used[e] += 1
                    kept += 1
                    acc += top_p[t, k] * expert(xs[t], e)
            want[s * n_local + t] = acc
    return want, len(x) * MOE_TOPK - kept, len(x) * MOE_TOPK


def _pipeline_inputs(n_stages: int):
    """pipeline_pp's W, b, xs and targets: n_micro=4, mb=4, d=16."""
    rng = np.random.RandomState(0)
    W = (rng.randn(n_stages, 16, 16) * 0.3).astype(np.float32)
    b = (rng.randn(n_stages, 16) * 0.1).astype(np.float32)
    xs = rng.randn(4, 4, 16).astype(np.float32)
    return W, b, xs, rng.randn(4, 4, 16).astype(np.float32)


def _pp_config():
    from thunder_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(**PP_CONFIG)


def _pp_params() -> dict:
    return _np_params_of(_pp_config())


def _pp_tokens(B: int):
    idx = np.random.RandomState(0).randint(0, PP_CONFIG["vocab_size"], (B, T_PP))
    return idx, np.roll(idx, -1, axis=1)


# =============================================================================
# The port, one gloo rank
# =============================================================================


SKEW_S = (0.0, 0.12, -0.08, 0.04)  # the clock offset each rank injects


class TorchRank:
    def __init__(self, rank: int, world: int, ckpt: str, out: str = ""):
        self.rank, self.world, self.ckpt, self.out = rank, world, ckpt, out

    def _sharded_train(self, case: str):
        """The sharded step of a TRAIN_CASES case, 2 AdamW steps, beside the
        one-device step from the same weights: the losses, the worst
        relative gap of the gathered params, the gathered params after the
        AdamW and the SGD steps (for the JAX package's), and checks that each rank
        holds 1/n of each split leaf and of its moments, and that no tp
        rank gathers a whole MLP weight."""
        import torch

        from thunder_tpu_torch.core.pytree import tree_flatten
        from thunder_tpu_torch.distributed.runtime import P
        from thunder_tpu_torch.models import gpt as m
        from thunder_tpu_torch.parallel import (build_train_step, gather_pytree, gpt_param_specs, make_mesh,
                                                shard_pytree)
        from thunder_tpu_torch.parallel.sharding import align_specs

        cfg_name, axes, kind = TRAIN_CASES[self.world][case]
        cfg = m.name_to_config(cfg_name)
        full = m.params_from_jax(_np_params(cfg_name), device="cpu")
        idx, tgt = (torch.from_numpy(a) for a in _train_tokens(cfg.vocab_size))
        mesh = make_mesh(**axes)
        if kind == "replicated":
            specs = {k: v for k, v in gpt_param_specs(cfg, None).items()}
        else:
            specs = gpt_param_specs(cfg, mesh, tp=(kind == "full"))
        blocks = shard_pytree(full, mesh, specs)
        flat_specs = tree_flatten(align_specs(specs, full), is_leaf=lambda x: isinstance(x, P))[0]
        for whole, mine, s in zip(tree_flatten(full)[0], tree_flatten(blocks)[0], flat_specs):
            n = int(np.prod([mesh.shape[ax] for ax in s.axes])) if s.axes else 1
            assert mine.numel() * n == whole.numel(), (s, tuple(mine.shape), tuple(whole.shape))
        step, opt, extrace = build_train_step(cfg, blocks, idx, tgt, mesh=mesh, param_specs=specs, lr=1e-2,
                                              donate=False, return_extrace=True)
        losses, p, o = [], blocks, opt
        for _ in range(TRAIN_STEPS):
            p, o, loss = step(p, o, idx, tgt)
            losses.append(float(loss))
        for mom in (o["m"], o["v"]):
            assert [tuple(x.shape) for x in tree_flatten(mom)[0]] == [tuple(x.shape) for x in tree_flatten(p)[0]]
        if mesh.shape["tp"] > 1:
            whole_mlp = {(cfg.mlp_hidden, cfg.n_embd), (cfg.n_embd, cfg.mlp_hidden)}
            for b in extrace.bound_symbols:
                if b.sym.name in ("all_gather", "synchronize"):
                    assert tuple(b.output.shape) not in whole_mlp, b
        gathered = gather_pytree(p, mesh, specs)
        ref_step, ref_opt = build_train_step(cfg, m.params_from_jax(_np_params(cfg_name), device="cpu"), idx, tgt,
                                             lr=1e-2, donate=False)
        ref_losses, rp, ro = [], m.params_from_jax(_np_params(cfg_name), device="cpu"), ref_opt
        for _ in range(TRAIN_STEPS):
            rp, ro, loss = ref_step(rp, ro, idx, tgt)
            ref_losses.append(float(loss))
        worst = max(float((a - b).abs().max() / (b.abs().max() + 1e-12))
                    for a, b in zip(tree_flatten(gathered)[0], tree_flatten(rp)[0]))
        # SGD with donation: the blocks update in place; the params after it
        # against one device's.
        p = shard_pytree(m.params_from_jax(_np_params(cfg_name), device="cpu"), mesh, specs)
        rp = m.params_from_jax(_np_params(cfg_name), device="cpu")
        sgd, sgd_opt = build_train_step(cfg, p, idx, tgt, mesh=mesh, param_specs=specs, lr=1e-2, donate=True,
                                        optimizer="sgd")
        ref_sgd, _ = build_train_step(cfg, rp, idx, tgt, lr=1e-2, donate=True, optimizer="sgd")
        for _ in range(TRAIN_STEPS):
            p2, sgd_opt, _ = sgd(p, sgd_opt, idx, tgt)
            assert all(a is b for a, b in zip(tree_flatten(p2)[0], tree_flatten(p)[0]))
            rp, _, _ = ref_sgd(rp, {"step": 0}, idx, tgt)
        sgd_gathered = gather_pytree(p, mesh, specs)
        sgd_worst = max(float((a - b).abs().max() / (b.abs().max() + 1e-12))
                        for a, b in zip(tree_flatten(sgd_gathered)[0], tree_flatten(rp)[0]))
        return {"losses": losses, "ref_losses": ref_losses, "param_rel": worst, "sgd_param_rel": sgd_worst,
                "params": _flat_tree(gathered), "sgd_params": _flat_tree(sgd_gathered),
                "collectives": sorted({b.sym.name for b in extrace.bound_symbols if b.sym.name in (
                    "all_gather", "all_reduce", "reduce_scatter", "synchronize", "axis_slice")})}

    def ddp_train(self):
        return self._sharded_train("ddp_train")

    def fsdp_train(self):
        return self._sharded_train("fsdp_train")

    def tp_fsdp_train(self):
        return self._sharded_train("tp_fsdp_train")

    def dp_tp_train(self):
        return self._sharded_train("dp_tp_train")

    def scheduled_step(self):
        """The sharded step on the widest mesh of this world with the comm
        scheduler (the default) and without (THUNDER_TPU_COMM_SCHEDULE=0):
        the same losses and params, bit for bit, and the scheduler moved
        at least one gather."""
        import torch

        from thunder_tpu_torch.core.pytree import tree_flatten
        from thunder_tpu_torch.models import gpt as m
        from thunder_tpu_torch.parallel import build_train_step, gpt_param_specs, make_mesh, shard_pytree

        cfg = m.name_to_config("llama-tiny")
        idx, tgt = (torch.from_numpy(a) for a in _train_tokens(cfg.vocab_size))
        mesh = make_mesh(**({"fsdp": 2, "tp": 2} if self.world == 4 else {"fsdp": 2}))
        specs = gpt_param_specs(cfg, mesh)
        runs = []
        for knob in ("0", "1"):
            os.environ["THUNDER_TPU_COMM_SCHEDULE"] = knob
            try:
                blocks = shard_pytree(m.params_from_jax(_np_params("llama-tiny"), device="cpu"), mesh, specs)
                step, opt, extrace = build_train_step(cfg, blocks, idx, tgt, mesh=mesh, param_specs=specs, lr=1e-2,
                                                      donate=False, return_extrace=True)
            finally:
                del os.environ["THUNDER_TPU_COMM_SCHEDULE"]
            losses, p, o = [], blocks, opt
            for _ in range(TRAIN_STEPS):
                p, o, loss = step(p, o, idx, tgt)
                losses.append(loss)
            runs.append((losses, tree_flatten(p)[0], extrace.tags.get("comm_schedule")))
        (l0, p0, tag0), (l1, p1, tag1) = runs
        assert tag0 is None and tag1 is not None and tag1["moves"] >= 1, (tag0, tag1 and tag1["moves"])
        assert all(torch.equal(a, b) for a, b in zip(l0, l1)), (l0, l1)
        assert all(torch.equal(a, b) for a, b in zip(p0, p1))
        return {"moves": tag1["moves"], "losses": [float(x) for x in l1]}

    def comm_schedule(self):
        """``tests/test_comm_schedule.py``'s two multi-device cases on a
        fsdp2 x tp2 grid: the scheduled MLP program computes what the
        unscheduled one does, and ``compile_with_collectives(comm_schedule=
        True)`` schedules and runs."""
        import torch

        import thunder_tpu_torch.clang as clang
        from thunder_tpu_torch.core.pytree import tree_flatten
        from thunder_tpu_torch.distributed import prims as dist_prims
        from thunder_tpu_torch.distributed.runtime import P, compile_with_collectives, stage_collective_trace
        from thunder_tpu_torch.parallel import make_mesh
        from thunder_tpu_torch.transforms.comm_schedule import schedule_collectives

        layers, d, B, fsdp, tp = 2, 32, 8, 2, 2
        extrace = mlp_extrace(layers=layers, d=d, B=B, fsdp=fsdp, tp=tp)
        scheduled, rep = schedule_collectives(extrace, device="cpu")
        assert rep is not None and rep.moves >= 1
        mesh = make_mesh(fsdp=fsdp, tp=tp)
        w_spec = P("fsdp", None)
        in_specs = tuple([w_spec] * layers + [P()])
        out_specs = (P(), tuple([w_spec] * layers + [P()]))
        rng = np.random.RandomState(0)
        flat = [torch.from_numpy(rng.randn(d, d).astype(np.float32)) for _ in range(layers)]
        flat.append(torch.from_numpy(rng.randn(B, d).astype(np.float32)))
        out0 = tree_flatten(stage_collective_trace(extrace, mesh, in_specs, out_specs)(*flat))[0]
        out1 = tree_flatten(stage_collective_trace(scheduled, mesh, in_specs, out_specs)(*flat))[0]
        for a, b in zip(out0, out1):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)

        w1, w2 = (torch.from_numpy(rng.randn(d, d).astype(np.float32)) for _ in range(2))
        x = torch.from_numpy(rng.randn(B, d).astype(np.float32))

        def loss(w1s, w2s, xv):
            a = dist_prims.synchronize(w1s, "fsdp", fsdp, "fsdp")
            h = clang.tanh(clang.matmul(xv, clang.transpose(a, 0, 1)))
            b = dist_prims.synchronize(w2s, "fsdp", fsdp, "fsdp")
            out = clang.matmul(h, clang.transpose(b, 0, 1))
            return clang.mean(clang.mul(out, out))

        specs = (P("fsdp", None), P("fsdp", None), P())
        jf, ex = compile_with_collectives(loss, (w1[: d // fsdp], w2[: d // fsdp], x), mesh, specs, (P(), specs),
                                          grad=True, comm_schedule=True)
        tag = ex.tags.get("comm_schedule")
        assert tag is not None and tag["moves"] >= 1, tag
        value = float(tree_flatten(jf(w1, w2, x))[0][0])
        assert np.isfinite(value)
        return {"moves": rep.moves, "wired_moves": tag["moves"]}

    def reshard(self):
        """gpt-tiny's params as blocks of one mesh resharded onto another
        shape (and back): each rank's blocks equal the direct sharding of
        the whole params, bit for bit."""
        import torch

        from thunder_tpu_torch.core.pytree import tree_flatten
        from thunder_tpu_torch.models import gpt as m
        from thunder_tpu_torch.parallel import gather_pytree, gpt_param_specs, make_mesh, reshard_pytree, shard_pytree

        cfg = m.name_to_config("gpt-tiny")
        full = m.params_from_jax(_np_params("gpt-tiny"), device="cpu")
        shapes = [{"fsdp": 4}, {"dp": 2, "tp": 2}] if self.world == 4 else [{"fsdp": 2}, {"tp": 2}]
        (ma, mb) = (make_mesh(**a) for a in shapes)
        sa, sb = gpt_param_specs(cfg, ma), gpt_param_specs(cfg, mb)
        on_a = shard_pytree(full, ma, sa)
        on_b = reshard_pytree(on_a, mb, sb, src_mesh=ma, src_specs=sa)
        for got, want in zip(tree_flatten(on_b)[0], tree_flatten(shard_pytree(full, mb, sb))[0]):
            assert torch.equal(got, want)
        back = reshard_pytree(on_b, ma, sa, src_mesh=mb, src_specs=sb)
        for got, want in zip(tree_flatten(back)[0], tree_flatten(on_a)[0]):
            assert torch.equal(got, want)
        for got, want in zip(tree_flatten(gather_pytree(on_b, mb, sb))[0], tree_flatten(full)[0]):
            assert torch.equal(got, want)
        # A mesh is a dict of groups: the distributed API takes it as one.
        from thunder_tpu_torch.distributed import ddp, fsdp

        assert torch.equal(fsdp(full, mesh=ma)["wte"], on_a["wte"])
        ddp(torch.nn.Linear(2, 2), mesh=ma, axis="fsdp")
        return {}

    def timeline_skew(self):
        """Each rank notes 12 all-reduce completions and folds 12 steps with
        a recorder whose clock is shifted by SKEW_S[rank]; its events go to
        a log of its own. The merged logs' skew estimates are returned."""
        import torch

        import thunder_tpu_torch.monitor as monitor
        from thunder_tpu_torch.analysis.events import merge_event_logs, replay_events
        from thunder_tpu_torch.observability import events as ev
        from thunder_tpu_torch.observability import timeline as tl

        offs = SKEW_S[:self.world]
        path = os.path.join(self.out, f"timeline{self.rank}.jsonl")
        ev.set_global_path(path)
        rec = monitor.critpath(emulated_skew_s={self.rank: offs[self.rank]})
        sums = []
        try:
            x = torch.ones(1024)
            for step in range(12):
                t0 = time.perf_counter()
                y = x * float(step)
                c0 = time.perf_counter()
                torch.distributed.all_reduce(y)
                coll = time.perf_counter() - c0
                rec.note_collective(self.rank, step, s=coll, step=step)
                spans = [None] * self.world
                torch.distributed.all_gather_object(spans, {"total_s": time.perf_counter() - t0, "ici_s": coll})
                bd = rec.record_step(step, dict(enumerate(spans)))
                sums.append(sum(bd.classes.values()) / bd.total_s)
            torch.distributed.barrier()
        finally:
            ev.set_global_path(None)
            monitor.shutdown_critpath()
        records, _ = merge_event_logs([os.path.join(self.out, f"timeline{r}.jsonl") for r in range(self.world)])
        ests = tl.estimate_skew(records)
        _, diags = replay_events(path)
        return {"injected": list(offs), "offsets": {str(h): e.offset_s for h, e in ests.items()}, "sums": sums,
                "unknown_kinds": sum(d.rule == "events.unknown-kind" for d in diags)}

    def collectives(self):
        import torch

        import thunder_tpu_torch.distributed as td
        from thunder_tpu_torch.distributed import prims as dist
        from thunder_tpu_torch.distributed.runtime import P, compile_with_collectives

        n = self.world
        x = torch.arange(2 * n, dtype=torch.float32).reshape(n, 2)

        def f(a):
            s = dist.all_reduce(a, "dp", n)
            g = dist.all_gather(a, "dp", n)
            rs = dist.reduce_scatter(g, "dp", n)
            return s, g, rs

        jf, extrace = compile_with_collectives(f, (x[:1],), None, (P("dp", None),), (P(), P(), P("dp", None)))
        s, g, rs = jf(x)
        src = extrace.python()
        assert all(k in src for k in ("all_reduce", "all_gather", "reduce_scatter")), src
        assert td.prims.coll_reduce_scatter.launches > 0
        return {"s": _flat(s), "g": _flat(g), "rs": _flat(rs)}

    def calibration(self):
        """Measured collectives for ``calibrate_ici``: an all-reduce and an
        all-gather of 1 MiB a rank, 10 calls each, with ``cost.py``'s wire
        bytes for them."""
        import torch

        from thunder_tpu_torch.analysis.cost import trace_cost
        from thunder_tpu_torch.distributed import prims as dist
        from thunder_tpu_torch.distributed.runtime import P, compile_with_collectives

        n = self.world
        x = torch.ones(n * 256, 256)
        samples = []
        for cls, f in (("all-reduce", lambda a: dist.all_reduce(a, "dp", n)),
                       ("all-gather", lambda a: dist.all_gather(a, "dp", n))):
            jf, extrace = compile_with_collectives(f, (x[:256],), None, (P("dp"),), P("dp") if cls == "all-reduce"
                                                   else P())
            wire = trace_cost(extrace, "cpu").total_comm_bytes
            jf(x)
            torch.distributed.barrier()
            t0 = time.perf_counter()
            for _ in range(10):
                jf(x)
            samples.append((cls, 10 * wire, time.perf_counter() - t0))
        return {"samples": samples}

    def broadcast_grad(self):
        import torch

        import thunder_tpu_torch.torch as ltorch
        from thunder_tpu_torch.distributed import prims as dist
        from thunder_tpu_torch.distributed.runtime import P, compile_with_collectives

        n, root = self.world, min(3, self.world - 1)
        x = (torch.arange(n, dtype=torch.float32) + 1.0).reshape(n, 1)

        def f(a):
            b = dist.broadcast(a, "dp", n, root=root)
            return ltorch.sum(b * b)

        jf, extrace = compile_with_collectives(f, (x[:1],), None, (P("dp", None),), (P(), (P("dp", None),)),
                                               grad=True)
        loss, (g,) = jf(x)
        assert "mask_to_rank" in extrace.python()
        return {"loss": [float(loss)], "grad": _flat(g)}

    def fsdp_api(self):
        import torch

        from thunder_tpu_torch.distributed import fsdp
        from thunder_tpu_torch.models import gpt as m

        cfg = m.name_to_config("gpt-tiny")
        params = m.init_params(cfg, seed=0, device="cpu")
        sharded = fsdp(params, mesh=torch.distributed.group.WORLD)
        full, mine = params["wte"], sharded["wte"]
        rows = full.shape[0] // self.world
        assert mine.shape[0] * self.world == full.shape[0], (mine.shape, full.shape)
        assert (mine == full[self.rank * rows:(self.rank + 1) * rows]).all()
        return {}

    def _module(self, mode: str, strategy=None):
        import thunder_tpu_torch as tt
        from thunder_tpu_torch.distributed import FSDPType, ddp, fsdp

        m = _tiny_gpt()
        if mode == "ddp":
            m = ddp(m)
        elif mode == "fsdp":
            m = fsdp(m, sharding_strategy=strategy or FSDPType.ZERO3)
        return m, tt.jit(m, device="cpu")

    def _full_grads(self, tm) -> dict:
        """Each param's grad, an fsdp shard's all-gathered to the whole."""
        from thunder_tpu_torch.distributed.prims import gather_dim

        out = {}
        for name, p in tm.named_parameters():
            g = p.grad
            if name in tm._sharded and self.world > 1:
                g = gather_dim(g, tm._group(), self.world, 0)
            out[name] = g
        return out

    def _train(self, mode: str):
        import torch
        import torch.nn.functional as F

        import thunder_tpu_torch as tt

        m, tm = self._module(mode)
        ref = _tiny_gpt()
        tm_ref = tt.jit(ref, device="cpu")
        idx, tgt = (torch.from_numpy(a[0]) for a in _tokens())
        opt = torch.optim.SGD(tm.parameters(), lr=0.1)
        opt_ref = torch.optim.SGD(ref.parameters(), lr=0.1)
        losses, ref_losses = [], []
        for step in range(4):
            opt.zero_grad()
            loss = F.cross_entropy(tm(idx).reshape(-1, VOCAB), tgt.reshape(-1))
            loss.backward()
            if step == 3:
                grads = self._full_grads(tm)
            opt.step()
            opt_ref.zero_grad()
            loss_ref = F.cross_entropy(tm_ref(idx).reshape(-1, VOCAB), tgt.reshape(-1))
            loss_ref.backward()
            if step == 3:
                ref_grads = {k: p.grad for k, p in ref.named_parameters()}
            opt_ref.step()
            losses.append(float(loss.detach()))
            ref_losses.append(float(loss_ref.detach()))
        fw, bw = tt.last_traces(tm)[-1].python(), tt.last_backward_traces(tm)[-1].python()
        comp = tt.last_traces(tm)[0]
        assert "synchronize" in fw
        assert ("reduce_scatter" if mode == "fsdp" else "all_reduce") in bw, bw[-2000:]
        # The batch is split: this rank's trace sees B / world rows.
        assert any(tuple(a.shape)[:1] == (B // self.world,) for a in comp.args), [a.shape for a in comp.args]
        if mode == "fsdp":
            assert tm.original_module.wte.weight.shape[0] * self.world == VOCAB
        worst = max(float((grads[k] - ref_grads[k]).abs().max() / (ref_grads[k].abs().max() + 1e-12))
                    for k in grads)
        return {"losses": losses, "ref_losses": ref_losses, "grad_rel_vs_one_device": worst,
                "grads": {k: _flat(v) for k, v in grads.items()}}

    def module_ddp_train(self):
        return self._train("ddp")

    def module_fsdp_train(self):
        return self._train("fsdp")

    def fsdp_zero3(self):
        import torch
        import torch.nn.functional as F

        import thunder_tpu_torch as tt
        from thunder_tpu_torch.core.proxies import TensorProxy
        from thunder_tpu_torch.distributed import FSDPType

        idx, tgt = (torch.from_numpy(a[0]) for a in _tokens())
        out = {}
        for name, strategy in (("zero2", FSDPType.ZERO2), ("zero3", FSDPType.ZERO3)):
            _, tm = self._module("fsdp", strategy)
            loss = F.cross_entropy(tm(idx).reshape(-1, VOCAB), tgt.reshape(-1))
            loss.backward()
            fw = tt.last_traces(tm)[-1]
            saved = sum(p.size_bytes for p in fw.output[1] if isinstance(p, TensorProxy))
            out[name] = {"loss": float(loss.detach()), "saved": saved, "grads": self._full_grads(tm),
                         "bw": tt.last_backward_traces(tm)[-1].python()}
        z2, z3 = out["zero2"], out["zero3"]
        assert "synchronize" in z3["bw"] and "synchronize" not in z2["bw"]
        assert z3["saved"] < z2["saved"], (z3["saved"], z2["saved"])
        for k in z2["grads"]:
            torch.testing.assert_close(z3["grads"][k], z2["grads"][k], rtol=2e-4, atol=1e-5)
        return {"loss2": [z2["loss"]], "loss3": [z3["loss"]], "saved2": z2["saved"], "saved3": z3["saved"]}

    def fsdp_memory(self):
        import torch
        import torch.nn.functional as F

        import thunder_tpu_torch as tt

        full = {k: v.numel() * v.element_size() for k, v in _tiny_gpt().named_parameters()}
        m, tm = self._module("fsdp")
        idx, tgt = (torch.from_numpy(a[0]) for a in _tokens())
        F.cross_entropy(tm(idx).reshape(-1, VOCAB), tgt.reshape(-1)).backward()
        mine = {k: p.numel() * p.element_size() for k, p in tm.named_parameters()}
        total, held = sum(full.values()), sum(mine.values())
        sharded = sum(full[k] for k in tm._sharded)
        assert sharded / total > 0.9, (sharded, total)
        assert held < (1.0 / self.world + 0.1) * total, (held, total)
        for k, p in tm.named_parameters():
            assert p.grad is not None and p.grad.shape == p.shape, k
        bw = tt.last_backward_traces(tm)[-1].python()
        assert "reduce_scatter" in bw
        return {"held_share": held / total}

    def _no_sync(self, mode: str):
        import torch
        import torch.nn.functional as F

        import thunder_tpu_torch as tt

        m, tm = self._module(mode)
        ref = _tiny_gpt()
        K = 3
        idx, tgt = (torch.from_numpy(a) for a in _tokens(K))
        with tm.no_sync():
            for k in range(K):
                (F.cross_entropy(tm(idx[k]).reshape(-1, VOCAB), tgt[k].reshape(-1)) / K).backward()
            bw = tt.last_backward_traces(tm)[-1].python()
            assert "all_reduce" not in bw and "reduce_scatter" not in bw, bw[-2000:]
        assert not tm._nosync_accum
        F.cross_entropy(ref(idx.reshape(K * B, T)).reshape(-1, VOCAB), tgt.reshape(-1)).backward()
        grads = self._full_grads(tm)
        named = dict(ref.named_parameters())
        for k, g in grads.items():
            torch.testing.assert_close(g, named[k].grad, rtol=2e-4, atol=1e-5, msg=k)
        for p in tm.parameters():
            p.grad = None
        with tm.no_sync():
            F.cross_entropy(tm(idx[0]).reshape(-1, VOCAB), tgt[0].reshape(-1)).backward()
        assert all(p.grad is not None for p in tm.parameters())
        return {"grads": {k: _flat(v) for k, v in grads.items()}}

    def no_sync_ddp(self):
        return self._no_sync("ddp")

    def no_sync_fsdp(self):
        return self._no_sync("fsdp")

    def batch_reduced_output(self):
        import torch

        import thunder_tpu_torch as tt
        from thunder_tpu_torch.distributed import ddp

        red, masked = _reducers()
        inp = torch.from_numpy(np.random.RandomState(1).randn(32, 4).astype(np.float32))
        want = red(inp).detach()
        got = tt.jit(ddp(red), device="cpu")(inp)
        assert tuple(got.shape) == (4,)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        x2 = torch.from_numpy(np.random.RandomState(2).randn(24, 16).astype(np.float32))
        mask = torch.from_numpy(np.random.RandomState(3).randn(16, 16).astype(np.float32))
        want2 = masked(x2, mask).detach()
        got2 = tt.jit(ddp(masked), device="cpu")(x2, mask)
        torch.testing.assert_close(got2, want2, rtol=1e-4, atol=1e-5)
        return {"reduced": _flat(got), "masked": _flat(got2)}

    def masked_ddp(self):
        """A padded batch under ddp: the mask's verdict (a value guard of
        the entry) is read on this rank's block of the mask, as traced."""
        import torch
        import torch.nn.functional as F

        import thunder_tpu_torch as tt
        from thunder_tpu_torch.distributed import ddp

        class PadAttention(torch.nn.Module):
            def __init__(self, dim=16):
                super().__init__()
                self.qkv = torch.nn.Linear(dim, 3 * dim, bias=False)

            def forward(self, x, am):
                Bx, Tx, C = x.shape
                q, k, v = self.qkv(x).view(Bx, Tx, 3, 2, C // 2).permute(2, 0, 3, 1, 4).unbind(0)
                keep = torch.tril(torch.ones(Tx, Tx, dtype=torch.bool)) & am[:, None, None, :].bool()
                return F.scaled_dot_product_attention(q, k, v, attn_mask=keep)

        torch.manual_seed(0)
        m = PadAttention()
        x = torch.from_numpy(np.random.RandomState(4).randn(8, 32, 16).astype(np.float32))
        am = torch.ones(8, 32, dtype=torch.int64)
        am[::2, :8] = 0  # every other row left-padded
        x2 = x.clone()
        am2 = am.flip(0)  # the same shapes, other rows padded: the guard decides
        tm = tt.jit(ddp(m), device="cpu")
        for xi, ai in ((x, am), (x2, am2), (x, am)):
            got = tm(xi, ai)
            want = m(xi, ai).detach()
            valid = ai.bool()[:, None, :, None].expand_as(want)
            torch.testing.assert_close(got.detach()[valid], want[valid], rtol=1e-4, atol=1e-5)
        return {"compiles": tt.compile_stats(tm).compile_count}

    def multihost_init(self):
        import thunder_tpu_torch.distributed as td
        from thunder_tpu_torch.observability.events import host_identity

        info = td.init()
        assert info == {"process_id": self.rank, "num_processes": self.world, "devices": self.world,
                        "local_devices": 1}, info
        try:
            td.init(process_id=(self.rank + 1) % self.world)
        except RuntimeError as e:
            assert "conflicts" in str(e)
        else:
            raise AssertionError("a contradicting process_id did not raise")
        assert td.is_initialized()
        ident = host_identity()
        assert ident["host"] == self.rank, ident
        return {}

    def grid(self):
        """ppermute, all_to_all and hier_all_reduce over a 2 x 2 grid."""
        import torch

        from thunder_tpu_torch.distributed import prims as dist
        from thunder_tpu_torch.distributed.runtime import P, compile_with_collectives, grid_groups

        mesh = grid_groups(("outer", "inner"), (2, 2))
        x = torch.from_numpy(_grid_input())

        def f(a):
            p = dist.ppermute(a, "inner", [(0, 1), (1, 0)])
            t = dist.all_to_all(a, "inner", 2, split_dim=1, concat_dim=0)
            h = dist.hier_all_reduce(a, "inner", "outer", 2, 2)
            flat = dist.hier_all_reduce(a[:1], "inner", "outer", 2, 2, op="avg")
            return p, t, h, flat

        both = P(("outer", "inner"))
        jf, _ = compile_with_collectives(f, (x[:2],), mesh, (both,), (both, both, P(), P()))
        p, t, h, flat = jf(x)
        return {"p": _flat(p), "t": _flat(t), "h": _flat(h), "flat": _flat(flat)}

    def checkpoint(self):
        """At 4 ranks: save a dim-0-sharded state; at 2: load it, resharded."""
        import torch

        from thunder_tpu_torch.distributed import checkpoint as ck
        from thunder_tpu_torch.distributed.runtime import P

        w = torch.arange(16 * 8, dtype=torch.float32).reshape(16, 8)
        b = torch.arange(5, dtype=torch.float32)
        rows = 16 // self.world
        specs = {"w": P("fsdp"), "b": P()}
        if self.world == 4:
            state = {"w": w[self.rank * rows:(self.rank + 1) * rows].clone(), "b": b}
            ck.save(state, self.ckpt, specs=specs)
            ck.save(state, self.ckpt + "_full", specs=specs,
                    options=ck.StateDictOptions(full_state_dict=True))
            return {}
        got = ck.load(self.ckpt, specs=specs)
        assert torch.equal(got["w"], w[self.rank * rows:(self.rank + 1) * rows]), got["w"]
        assert torch.equal(got["b"], b)
        whole = ck.load(self.ckpt + "_full")
        assert torch.equal(whole["w"], w) and torch.equal(whole["b"], b)
        return {}


    # -- context, pipeline and expert parallelism (ROADMAP 11b) -------------

    def _vjp_case(self, perm_kind: str):
        """grad of sum(w * ppermute(x)) over a ring or an open chain, and of
        sum(w * all_to_all(x)), against the same done by hand."""
        import torch

        import thunder_tpu_torch.torch as ttorch
        from thunder_tpu_torch.distributed import prims as dist
        from thunder_tpu_torch.distributed.runtime import P, compile_with_collectives
        from thunder_tpu_torch.parallel import make_mesh

        n = self.world
        mesh = make_mesh(dp=n)
        rng = np.random.RandomState(3)
        x = torch.from_numpy(rng.randn(n, n, 3).astype(np.float32))
        w = torch.from_numpy(rng.randn(n, n, 3).astype(np.float32))
        u = torch.from_numpy(rng.randn(n * n, 1, 3).astype(np.float32))
        perm = ([(i, (i + 1) % n) for i in range(n)] if perm_kind == "ring"
                else [(i, i + 1) for i in range(n - 1)])

        def f(x, w, u):
            y = dist.ppermute(x, "dp", perm)
            t = dist.all_to_all(x, "dp", n, split_dim=1, concat_dim=0)
            return dist.all_reduce(ttorch.sum(w * y) + ttorch.sum(u * t), "dp", n, replicated_grad=True)

        spec = P("dp")
        jf, extrace = compile_with_collectives(f, (x[:1], w[:1], u[:n]), mesh, (spec,) * 3, (P(), (spec,) * 3),
                                               grad=True)
        _, (gx, _, _) = jf(x, w, u)
        # By hand: rank s's x reaches rank d of (s, d) and meets w there, so
        # its grad is w's block of d (zeros where s sends nowhere); the
        # all_to_all sends x[s][0, r] to rank r's row s, which meets
        # u[r·n + s].
        want = torch.zeros_like(x)
        for s, d in perm:
            want[s] += w[d]
        want += u.reshape(n, n, 3).permute(1, 0, 2)
        assert torch.allclose(gx, want, rtol=1e-6, atol=1e-6), (gx - want).abs().max()
        names = [b.sym.name for b in extrace.bound_symbols]
        assert names.count("ppermute") == 2 and names.count("all_to_all") == 2, names
        return {"max_err": float((gx - want).abs().max())}

    def vjp_ring(self):
        return self._vjp_case("ring")

    def vjp_chain(self):
        return self._vjp_case("chain")

    def _attention_case(self, which: str):
        """ring (seed 0, H=4) or Ulysses (seed 1, H=8) attention over sp, and
        the grads of sum(out²), against plain attention (rtol 1e-4, atol
        1e-5; grads 1e-3, 1e-4)."""
        import torch

        import thunder_tpu_torch.torch as ttorch
        from thunder_tpu_torch.distributed import prims as dist
        from thunder_tpu_torch.distributed.runtime import P, compile_with_collectives
        from thunder_tpu_torch.parallel import context, make_mesh

        n = self.world
        mesh = make_mesh(sp=n)
        fn = context.ring_attention if which == "ring" else context.ulysses_attention
        q, k, v = (torch.from_numpy(a) for a in _qkv(which))
        spec = P(None, None, "sp", None)
        blk = [a[:, :, :a.shape[2] // n] for a in (q, k, v)]
        jf, _ = compile_with_collectives(lambda q, k, v: fn(q, k, v, "sp"), tuple(blk), mesh, (spec,) * 3, spec)
        got = jf(q, k, v)

        def loss(q, k, v):
            return dist.all_reduce(ttorch.sum(fn(q, k, v, "sp").float() ** 2), "sp", n, replicated_grad=True)

        gf, extrace = compile_with_collectives(loss, tuple(blk), mesh, (spec,) * 3, (P(), (spec,) * 3), grad=True)
        _, grads = gf(q, k, v)
        qr, kr, vr = (a.clone().requires_grad_() for a in (q, k, v))
        want = _plain_attention(qr, kr, vr)
        (want ** 2).sum().backward()
        torch.testing.assert_close(got, want.detach(), rtol=1e-4, atol=1e-5)
        for g, r in zip(grads, (qr, kr, vr)):
            torch.testing.assert_close(g, r.grad, rtol=1e-3, atol=1e-4)
        coll = sorted({b.sym.name for b in extrace.bound_symbols if b.sym.name in ("ppermute", "all_to_all")})
        return {"out": _flat(got), "grads": [_flat(g) for g in grads], "collectives": coll}

    def ring_attention(self):
        return self._attention_case("ring")

    def ulysses_attention(self):
        return self._attention_case("ulysses")

    def long_context_train(self):
        """``long_context_train``: a tiny attention LM, the sequence split
        over sp, ring attention, the loss and the grads of wq and wo against
        one device (rtol 1e-5; grads 1e-3, 1e-5)."""
        import torch
        import torch.nn.functional as F

        import thunder_tpu_torch.torch as ttorch
        from thunder_tpu_torch.distributed import prims as dist
        from thunder_tpu_torch.distributed.runtime import P, compile_with_collectives
        from thunder_tpu_torch.parallel import make_mesh
        from thunder_tpu_torch.parallel.context import ring_attention

        n = self.world
        mesh = make_mesh(sp=n)
        wq, wo, x, tgt = (torch.from_numpy(a) for a in _long_context_inputs())
        B, S = tgt.shape
        H, D = LC_H, LC_D

        def loss(wq, wo, x, tgt):
            wq = dist.synchronize(wq, "sp", n, "replicated", grad_scale=1.0)
            wo = dist.synchronize(wo, "sp", n, "replicated", grad_scale=1.0)
            q = ttorch.permute(ttorch.reshape(ttorch.matmul(x, ttorch.t(wq)), (B, -1, H, D)), (0, 2, 1, 3))
            o = ring_attention(q, q, q, "sp", causal=True)
            h = ttorch.reshape(ttorch.permute(o, (0, 2, 1, 3)), (B, -1, H * D))
            logp = ttorch.log_softmax(ttorch.matmul(h, ttorch.t(wo)).float(), -1)
            nll = -ttorch.mean(ttorch.take_along_dim(logp, ttorch.unsqueeze(tgt, -1), -1)) * (1.0 / n)
            return dist.all_reduce(nll, "sp", n, replicated_grad=True)

        seq = P(None, "sp", None)
        ex = (wq, wo, x[:, :S // n], tgt[:, :S // n])
        gf, _ = compile_with_collectives(loss, ex, mesh, (P(), P(), seq, P(None, "sp")),
                                         (P(), (P(), P(), seq)), grad=True)
        l1, (gq, go, _) = gf(wq, wo, x, tgt)
        wqr, wor = wq.clone().requires_grad_(), wo.clone().requires_grad_()
        q = (x @ wqr.T).reshape(B, S, H, D).permute(0, 2, 1, 3)
        o = _plain_attention(q, q, q).permute(0, 2, 1, 3).reshape(B, S, H * D)
        l2 = -torch.gather(F.log_softmax(o @ wor.T, -1), -1, tgt[..., None]).mean()
        l2.backward()
        np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
        torch.testing.assert_close(gq, wqr.grad, rtol=1e-3, atol=1e-5)
        torch.testing.assert_close(go, wor.grad, rtol=1e-3, atol=1e-5)
        return {"loss": [float(l1)], "grads": [_flat(gq), _flat(go)]}

    def _moe_fns(self, capacity=None):
        """(forward, grad) of moe_mlp over ep: the forward joined by tokens,
        the grad of sum(out²) w.r.t. (x, router, w1, w2)."""
        import thunder_tpu_torch.torch as ttorch
        from thunder_tpu_torch.distributed import prims as dist
        from thunder_tpu_torch.distributed.runtime import P, compile_with_collectives
        from thunder_tpu_torch.parallel import make_mesh
        from thunder_tpu_torch.parallel.moe import moe_mlp

        n = self.world
        mesh = make_mesh(ep=n)
        x, rw, w1, w2 = _moe_inputs(MOE_SEEDS[capacity is not None])
        specs = (P("ep", None), P(), P("ep"), P("ep"))
        ex = (x[:len(x) // n], rw, w1[:len(w1) // n], w2[:len(w2) // n])
        fwd, _ = compile_with_collectives(lambda x, rw, w1, w2: moe_mlp(x, rw, w1, w2, "ep", top_k=MOE_TOPK,
                                                                        capacity=capacity),
                                          ex, mesh, specs, P("ep", None))

        def loss(x, rw, w1, w2):
            rw = dist.synchronize(rw, "ep", n, "replicated", grad_scale=1.0)
            out = moe_mlp(x, rw, w1, w2, "ep", top_k=MOE_TOPK, capacity=capacity)
            return dist.all_reduce(ttorch.sum(out.float() ** 2), "ep", n, replicated_grad=True)

        grad, extrace = compile_with_collectives(loss, ex, mesh, specs, (P(), specs), grad=True)
        assert [b.sym.name for b in extrace.bound_symbols].count("all_to_all") == 4
        return (x, rw, w1, w2), fwd, grad

    def moe_ep(self):
        """``moe_ep`` at ep=4 (E=8, 2 experts and 8 tokens a rank): the
        no-drop capacity against the dense oracle (rtol 1e-4, atol 1e-5),
        the router and expert grads (1e-3, 1e-4); capacity 1 runs finite."""
        import torch

        import thunder_tpu_torch as tt
        from thunder_tpu_torch.parallel.moe import moe_mlp_dense_reference

        args, fwd, grad = self._moe_fns()
        got = fwd(*args)
        want_fn = tt.value_and_grad(lambda x, rw, w1, w2: (moe_mlp_dense_reference(x, rw, w1, w2, top_k=MOE_TOPK)
                                                           .float() ** 2).sum(), device="cpu")
        want = tt.jit(lambda *a: moe_mlp_dense_reference(*a, top_k=MOE_TOPK), device="cpu")(*args)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        _, g_ep = grad(*args)
        _, g_dn = want_fn(*args)
        for a, b in zip(g_ep[1:], g_dn[1:]):
            torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)
        _, tiny, _ = self._moe_fns(capacity=1)
        dropped = tiny(*args)
        assert dropped.shape == got.shape and torch.isfinite(dropped).all()
        return {"out": _flat(got), "grads": [_flat(g) for g in g_ep[1:]], "dropped": _flat(dropped)}

    def moe_capacity(self):
        """``moe_capacity`` at ep=4 (E=8, C=1): the dropped assignments
        against a host replication of the slot accounting, the outputs
        against the drop-aware oracle (rtol 2e-3, atol 2e-4), fully dropped
        tokens exactly zero; 15 SGD steps under drops converge."""
        import torch

        args, fwd, grad = self._moe_fns(capacity=MOE_CAP)
        want, dropped, total = _moe_capacity_oracle(*(a.numpy() for a in args), self.world)
        assert dropped > 0, "capacity below the lossless bound must drop tokens"
        got = fwd(*args)
        np.testing.assert_allclose(got.numpy(), want.astype(np.float32), rtol=2e-3, atol=2e-4)
        zero_rows = int((got.abs().amax(1) < 1e-7).sum())
        assert zero_rows == int((np.abs(want).max(axis=1) == 0.0).sum())
        x, rw, w1, w2 = args
        losses = []
        for _ in range(15):
            loss, (_, g_rw, g_w1, g_w2) = grad(x, rw, w1, w2)
            rw, w1, w2 = rw - 0.02 * g_rw, w1 - 0.02 * g_w1, w2 - 0.02 * g_w2
            losses.append(float(loss))
        assert losses[-1] < 0.4 * losses[0], losses
        return {"out": _flat(got), "dropped": dropped, "total": total, "zero_rows": zero_rows, "losses": losses}

    def pipeline_pp(self):
        """``pipeline_pp`` at pp=4: GPipe against applying the stages in
        sequence (rtol 1e-5, atol 1e-6), its grads (1e-4, 1e-5), and 25
        pipelined SGD steps that take the loss under 0.6 of the first."""
        import torch

        import thunder_tpu_torch.torch as ttorch
        from thunder_tpu_torch.distributed.runtime import P, compile_with_collectives
        from thunder_tpu_torch.parallel import make_mesh, pipeline_apply

        n = self.world
        mesh = make_mesh(pp=n)
        W, b, xs, tgt = (torch.from_numpy(a) for a in _pipeline_inputs(n))

        def stage_fn(params, x):
            w, bb = params
            return ttorch.tanh(ttorch.matmul(x, w) + bb)

        def piped(Wl, bl, xs):
            return pipeline_apply(stage_fn, (Wl[0], bl[0]), xs, "pp")

        def loss(Wl, bl, xs, tgt):
            return ttorch.mean((piped(Wl, bl, xs) - tgt) ** 2)

        specs = (P("pp"), P("pp"), P(), P())
        ex = (W[:1], b[:1], xs, tgt)
        fwd, _ = compile_with_collectives(piped, ex[:3], mesh, specs[:3], P())
        grad, _ = compile_with_collectives(loss, ex, mesh, specs, (P(), (P("pp"), P("pp"), P(), P())), grad=True)
        got = fwd(W, b, xs)
        Wr, br = W.clone().requires_grad_(), b.clone().requires_grad_()
        y = xs
        for i in range(n):
            y = torch.tanh(y @ Wr[i] + br[i])
        torch.testing.assert_close(got, y.detach(), rtol=1e-5, atol=1e-6)
        ((y - tgt) ** 2).mean().backward()
        _, (gW, gb, _, _) = grad(W, b, xs, tgt)
        torch.testing.assert_close(gW, Wr.grad, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(gb, br.grad, rtol=1e-4, atol=1e-5)
        out = {"out": _flat(got), "grads": [_flat(gW), _flat(gb)], "losses": []}
        for _ in range(25):
            l, (gW, gb, _, _) = grad(W, b, xs, tgt)
            W, b = W - 0.5 * gW, b - 0.5 * gb
            out["losses"].append(float(l))
        assert out["losses"][-1] < 0.6 * out["losses"][0], out["losses"]
        return out

    def gpt_pipeline(self):
        """``gpt_pipeline`` at pp=4 (4 layers): both schedules against the
        port's one-device program (loss rtol 2e-5; grads rtol 1e-2, atol
        3e-4); the 1F1B stash never above n_stages inputs; GPipe's planned
        peak (plan_liveness of its joint program) grows from n_micro=4 to
        16 at mb=1 while 1F1B's (its programs' peaks and its stash) does
        not; 8 pipelined SGD steps take the loss down by 0.3."""
        import torch

        from thunder_tpu_torch.analysis.liveness import plan_liveness
        from thunder_tpu_torch.core.pytree import tree_flatten, tree_unflatten
        from thunder_tpu_torch.models import gpt as m
        from thunder_tpu_torch.parallel import make_mesh
        from thunder_tpu_torch.parallel.gpt_pp import build_gpt_pp_step, gpt_pp_loss_and_grads
        from thunder_tpu_torch.parallel.train import _compile_loss_and_grads

        n = self.world
        cfg = _pp_config()
        params = m.params_from_jax(_pp_params(), device="cpu")
        idx, tgt = (torch.from_numpy(a) for a in _pp_tokens(PP_B))
        mesh = make_mesh(pp=n)
        lg, _ = _compile_loss_and_grads(cfg, params, idx, tgt, executors=["torch"])
        want_loss, want_grads = lg(*tree_flatten(params)[0], idx, tgt)
        out = {}
        for sched in ("gpipe", "1f1b"):
            loss, grads = gpt_pp_loss_and_grads(cfg, params, idx, tgt, mesh, n_micro=4, schedule=sched)
            np.testing.assert_allclose(float(loss), float(want_loss), rtol=2e-5, err_msg=sched)
            got = tree_flatten(grads)[0]
            assert [tuple(g.shape) for g in got] == [tuple(g.shape) for g in want_grads]
            for a, w in zip(got, want_grads):
                np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-2, atol=3e-4, err_msg=sched)
            out[sched] = {"loss": [float(loss)], "grads": _flat_tree(grads)}
        peaks = {}
        for n_micro in (4, 16):
            i, t = (torch.from_numpy(a) for a in _pp_tokens(n_micro))
            for sched in ("gpipe", "1f1b"):
                step = build_gpt_pp_step(cfg, params, i, t, mesh, n_micro=n_micro, schedule=sched)
                step(params, i, t)
                plans = [plan_liveness(tr, device="cpu").peak_bytes for tr in step.traces]
                if sched == "1f1b":
                    st = step.schedule.stats
                    last = step.schedule.stage == n - 1  # the last stage runs no stage forward
                    assert st["stash_peak"] <= n and st["bwd_calls"] == n_micro, st
                    assert st["fwd_calls"] == (0 if last else n_micro) and len(step.traces) == (1 if last else 2), st
                    act = cfg.n_embd * T_PP * 4  # one (1, T, n_embd) f32 input a slot
                    peaks[sched, n_micro] = max(plans) + st["stash_peak"] * act
                else:
                    peaks[sched, n_micro] = plans[0]
        assert peaks["gpipe", 16] > peaks["gpipe", 4], peaks
        assert peaks["1f1b", 16] == peaks["1f1b", 4], peaks
        assert peaks["1f1b", 16] < peaks["gpipe", 16], peaks
        p_cur, losses = params, []
        for _ in range(8):
            loss, grads = gpt_pp_loss_and_grads(cfg, p_cur, idx, tgt, mesh, n_micro=4, schedule="1f1b")
            flat_p, spec = tree_flatten(p_cur)
            p_cur = tree_unflatten([p - 0.5 * g.to(p.dtype) for p, g in zip(flat_p, tree_flatten(grads)[0])], spec)
            losses.append(float(loss))
        assert losses[-1] < losses[0] - 0.3, losses
        out["losses"] = losses
        out["peaks"] = {f"{k[0]}{k[1]}": v for k, v in peaks.items()}
        return out

    def _sharded_sgd(self, case: str):
        """The sharded SGD step of a PARALLEL_TRAIN_CASES case (sp, pp, ep,
        and sp beside dp, fsdp or tp), 2 steps from one numpy seed's
        weights: the losses and the gathered params, for the JAX package's
        sharded step's, and against the port's one-device step."""
        import torch

        from thunder_tpu_torch.core.pytree import tree_flatten
        from thunder_tpu_torch.models import gpt as m
        from thunder_tpu_torch.parallel import build_train_step, gather_pytree, gpt_param_specs, make_mesh
        from thunder_tpu_torch.parallel import shard_pytree

        cfg_name, axes, kind = PARALLEL_TRAIN_CASES[self.world][case]
        cfg = m.name_to_config(cfg_name)
        idx, tgt = (torch.from_numpy(a) for a in _train_tokens(cfg.vocab_size))
        mesh = make_mesh(**axes)
        specs = gpt_param_specs(cfg, mesh, tp=(kind == "full"))
        p = shard_pytree(m.params_from_jax(_np_params(cfg_name), device="cpu"), mesh, specs)
        step, opt, extrace = build_train_step(cfg, p, idx, tgt, mesh=mesh, param_specs=specs, lr=1e-2,
                                              optimizer="sgd", return_extrace=True)
        rp = m.params_from_jax(_np_params(cfg_name), device="cpu")
        ref, ref_opt = build_train_step(cfg, rp, idx, tgt, lr=1e-2, optimizer="sgd")
        losses, ref_losses = [], []
        for _ in range(TRAIN_STEPS):
            p, opt, loss = step(p, opt, idx, tgt)
            rp, ref_opt, rloss = ref(rp, ref_opt, idx, tgt)
            losses.append(float(loss))
            ref_losses.append(float(rloss))
        gathered = gather_pytree(p, mesh, specs)
        worst = max(float((a - b).abs().max() / (b.abs().max() + 1e-12))
                    for a, b in zip(tree_flatten(gathered)[0], tree_flatten(rp)[0]))
        names = {b.sym.name for b in extrace.bound_symbols}
        return {"losses": losses, "ref_losses": ref_losses, "param_rel": worst, "params": _flat_tree(gathered),
                "ring": "ppermute" in names, "collectives": sorted(names & {
                    "all_gather", "all_reduce", "reduce_scatter", "synchronize", "axis_slice", "ppermute"})}

    def sp_train(self):
        return self._sharded_sgd("sp_train")

    def pp_train(self):
        return self._sharded_sgd("pp_train")

    def ep_train(self):
        return self._sharded_sgd("ep_train")

    def dp_sp_train(self):
        return self._sharded_sgd("dp_sp_train")

    def fsdp_sp_train(self):
        return self._sharded_sgd("fsdp_sp_train")

    def sp_tp_train(self):
        return self._sharded_sgd("sp_tp_train")


TORCH_SCENARIOS = {
    2: ["multihost_init", "collectives", "calibration", "broadcast_grad", "fsdp_api", "module_ddp_train", "module_fsdp_train",
        "fsdp_zero3", "fsdp_memory", "no_sync_ddp", "no_sync_fsdp", "batch_reduced_output", "masked_ddp", "checkpoint"],
    4: ["multihost_init", "collectives", "calibration", "broadcast_grad", "fsdp_api", "module_ddp_train", "module_fsdp_train",
        "fsdp_zero3", "fsdp_memory", "no_sync_ddp", "no_sync_fsdp", "batch_reduced_output", "masked_ddp", "grid",
        "checkpoint"],
}
# The sharded training step's scenarios: a spawn of their own (SCENARIOS
# "@train"), which runs beside the one above.
TRAIN_SCENARIOS = {
    2: ["ddp_train", "fsdp_train", "tp_fsdp_train", "scheduled_step", "reshard"],
    4: ["ddp_train", "fsdp_train", "tp_fsdp_train", "dp_tp_train", "scheduled_step", "comm_schedule", "reshard"],
}
# Context, pipeline and expert parallelism and the step over pp, ep and sp
# (tests/test_torch_port_parallel_ranks.py): SCENARIOS "@parallel".
PARALLEL_SCENARIOS = {
    2: ["vjp_ring", "vjp_chain", "sp_train", "pp_train", "ep_train"],
    4: ["vjp_ring", "vjp_chain", "ring_attention", "ulysses_attention", "long_context_train", "moe_ep",
        "moe_capacity", "pipeline_pp", "gpt_pipeline", "dp_sp_train", "fsdp_sp_train", "sp_tp_train"],
}


# =============================================================================
# The recovery layer on ranks (tests/test_torch_port_resilience_ranks.py):
# SCENARIOS "@resilience"
# =============================================================================

# The state and step of tests/test_mesh_resilience.py, on a fsdp x tp mesh:
# "b" replicated on every rank, "w" split over both axes (insertion order
# puts "b" first, as the JAX package's sorted keys do: it is leaf0 in both).
RES_STEPS = 6
RES_LOSS_AT = 3


def _res_state_np() -> dict:
    return {"b": np.ones(4, np.float32), "w": np.arange(32, dtype=np.float32).reshape(8, 4) * 0.01}


def _res_layout(axes: dict):
    from thunder_tpu_torch.distributed.runtime import P
    from thunder_tpu_torch.parallel import make_mesh

    mesh = make_mesh(**axes)
    split = tuple(a for a in ("fsdp", "tp") if axes.get(a, 1) > 1)
    w_spec = P(split[0] if split else None, split[1] if len(split) > 1 else None)
    return mesh, {"b": P(), "w": w_spec}


def _res_step(mesh, specs):
    """One SGD step of mean((w @ b)^2) on the whole leaves, gathered from and
    split back to this rank's blocks: a new state each call, never the input
    updated in place (the SDC guard re-runs from the previous state)."""
    import torch

    from thunder_tpu_torch.parallel import gather_pytree, shard_pytree

    def step(state):
        whole = gather_pytree(state, mesh, specs)
        b = whole["b"].detach().clone().requires_grad_()
        w = whole["w"].detach().clone().requires_grad_()
        loss = torch.mean((w @ b) ** 2)
        loss.backward()
        new = {"b": (b - 0.1 * b.grad).detach(), "w": (w - 0.1 * w.grad).detach()}
        return shard_pytree(new, mesh, specs), float(loss)

    return step


class ResilienceRank:
    """The "@resilience" scenarios, a rank each."""

    def _blocks(self, axes):
        import torch

        from thunder_tpu_torch.parallel import shard_pytree

        mesh, specs = _res_layout(axes)
        state = shard_pytree({k: torch.from_numpy(v) for k, v in _res_state_np().items()}, mesh, specs)
        return mesh, specs, state

    def res_synced_preemption(self):
        """SIGTERM's flag on rank 1 only (the chaos preempt seam with a host
        clause): every rank stops at the same step boundary and enters the
        same save; only rank 0 writes META.json and renames the step."""
        from thunder_tpu_torch.resilience import chaos, preemption

        mesh, specs, state = self._blocks(RES_MESH[self.world])
        mgr = preemption.CheckpointManager(os.path.join(self.ckpt, "preempt"), backoff_s=0)
        metas = []
        real_dump = json.dump

        class _Json:
            load = staticmethod(json.load)

            @staticmethod
            def dump(obj, f, **kw):
                metas.append(os.path.basename(f.name))
                return real_dump(obj, f, **kw)

        preemption.json = _Json
        try:
            with chaos.chaos_scope("preempt@2,host=1"):
                try:
                    preemption.run_training(_res_step(mesh, specs), state, RES_STEPS, manager=mgr, mesh=mesh,
                                            specs=specs)
                    stopped = None
                except preemption.Preempted as e:
                    stopped = e.step
        finally:
            preemption.json = json
        import torch.distributed as dist

        dist.barrier()
        return {"stopped": stopped, "meta_writes": metas, "primary": preemption._is_primary(),
                "committed": mgr.latest_complete_step()}

    def _sdc_run(self, spec, guard):
        from thunder_tpu_torch.resilience import chaos, preemption
        from thunder_tpu_torch.observability import events as ev

        mesh, specs, state = self._blocks(RES_MESH[self.world])
        log = os.path.join(self.out, f"sdc{self.rank}-{abs(hash(spec)) % 1000}.jsonl")
        ev.set_global_path(log)
        try:
            with chaos.chaos_scope(spec):
                _, losses = preemption.run_training(
                    _res_step(mesh, specs), state, 5,
                    manager=preemption.CheckpointManager(os.path.join(self.ckpt, f"sdc{abs(hash(spec)) % 1000}"),
                                                         backoff_s=0),
                    mesh=mesh, specs=specs, sdc_guard=guard)
        finally:
            ev.set_global_path(None)
        recs = [json.loads(line) for line in open(log)] if os.path.exists(log) else []
        return losses, recs

    def res_sdc_guard(self):
        """``sdc`` injected into one replica of the replicated leaf on the
        fsdp x tp mesh: the guard names that leaf and that rank, quarantines
        the step and re-runs it; the losses are the uninterrupted run's. A
        corruption that persists raises SDCDetectedError."""
        from thunder_tpu_torch.resilience import preemption, watchdog

        mesh, specs, state = self._blocks(RES_MESH[self.world])
        _, baseline = preemption.run_training(
            _res_step(mesh, specs), state, 5,
            manager=preemption.CheckpointManager(os.path.join(self.ckpt, "sdc-base"), backoff_s=0))
        losses, recs = self._sdc_run("sdc*1", True)
        suspect = [r for r in recs if r["kind"] == "sdc_suspect"]
        rerun = [r for r in recs if r["kind"] == "sdc_rerun"]
        try:
            self._sdc_run("sdc*inf", watchdog.SDCGuard(max_reruns=2))
            persistent = None
        except watchdog.SDCDetectedError as e:
            persistent = e.leaves
        return {"baseline": baseline, "losses": losses, "suspect_leaves": [r["leaves"] for r in suspect],
                "suspect_devices": [r["devices"] for r in suspect], "reruns_ok": [r["ok"] for r in rerun],
                "persistent": persistent}

    def res_host_loss(self):
        """``host_loss`` at step 3 on the fsdp x tp mesh: every rank agrees,
        saves the step with the mesh shape, and raises HostLost; the
        uninterrupted run's losses are returned for the resume to meet."""
        from thunder_tpu_torch.resilience import chaos, preemption

        mesh, specs, state = self._blocks(RES_MESH[self.world])
        _, baseline = preemption.run_training(
            _res_step(mesh, specs), state, RES_STEPS,
            manager=preemption.CheckpointManager(os.path.join(self.ckpt, "loss-base"), backoff_s=0))
        mgr = preemption.CheckpointManager(os.path.join(self.ckpt, "host-loss"), backoff_s=0)
        with chaos.chaos_scope(f"host_loss@{RES_LOSS_AT}"):
            try:
                preemption.run_training(_res_step(mesh, specs), state, RES_STEPS, manager=mgr, mesh=mesh,
                                        specs=specs)
                lost = None
            except preemption.HostLost as e:
                lost = e.step
        import torch.distributed as dist

        dist.barrier()
        meta = json.load(open(os.path.join(mgr._step_dir(RES_LOSS_AT), mgr.META)))
        return {"baseline": baseline, "lost": lost, "mesh": meta["mesh"]}

    def res_elastic_resume(self):
        """The surviving ranks (this spawn, 2 of them) resume the 4-rank
        spawn's host-loss checkpoint onto fsdp2 through the tiered restore
        and continue the run."""
        import torch

        from thunder_tpu_torch.observability import events as ev
        from thunder_tpu_torch.resilience import elastic, preemption

        mesh, specs = _res_layout({"fsdp": 2})
        mgr = preemption.CheckpointManager(os.path.join(self.ckpt, "host-loss"), backoff_s=0)
        log = os.path.join(self.out, f"elastic{self.rank}.jsonl")
        ev.set_global_path(log)
        try:
            init = {k: torch.from_numpy(v) for k, v in _res_state_np().items()}
            state, start = elastic.elastic_resume(mgr, init, mesh=mesh, specs=specs)
        finally:
            ev.set_global_path(None)
        _, cont = preemption.run_training(
            _res_step(mesh, specs), state, RES_STEPS,
            manager=preemption.CheckpointManager(os.path.join(self.ckpt, f"cont{self.rank}"), backoff_s=0),
            start_step=start)
        rec = next(json.loads(line) for line in open(log) if json.loads(line)["kind"] == "elastic_resume")
        return {"start": start, "continued": cont, "event": rec}

    def res_reshard(self):
        """gpt-tiny's params and SGD state: fsdp2·tp2 -> dp2·fsdp2 (fsdp2
        replicated twice over the 4 ranks) -> fsdp4 (4x1) -> fsdp2·tp2, each
        hop bitwise against the whole params, and the reshard to one rank's
        layout (every leaf whole on each rank) bitwise too."""
        import torch

        from thunder_tpu_torch.core.pytree import tree_flatten, tree_map
        from thunder_tpu_torch.distributed.runtime import P
        from thunder_tpu_torch.models import gpt as m
        from thunder_tpu_torch.parallel import gather_pytree, gpt_param_specs, make_mesh, shard_pytree
        from thunder_tpu_torch.parallel.sharding import _is_spec
        from thunder_tpu_torch.resilience import elastic

        cfg = m.name_to_config("gpt-tiny")
        full = m.params_from_jax(_np_params("gpt-tiny"), device="cpu")
        ref = tree_flatten(full)[0]
        hops = [{"fsdp": 2, "tp": 2}, {"dp": 2, "fsdp": 2}, {"fsdp": 4}, {"fsdp": 2, "tp": 2}]
        mesh = make_mesh(**hops[0])
        specs = gpt_param_specs(cfg, mesh)
        current = shard_pytree(full, mesh, specs)
        for axes in hops[1:]:
            to = make_mesh(**axes)
            to_specs = gpt_param_specs(cfg, to)
            current = elastic.reshard_state(current, to, to_specs, src_mesh=mesh, src_specs=specs)
            got = tree_flatten(gather_pytree(current, to, to_specs))[0]
            assert len(got) == len(ref) and all(torch.equal(a, b) for a, b in zip(got, ref)), axes
            mesh, specs = to, to_specs
        one = tree_map(lambda s: P(), specs, is_leaf=_is_spec)
        whole = elastic.reshard_state(current, mesh, one, src_mesh=mesh, src_specs=specs)
        assert all(torch.equal(a, b) for a, b in zip(tree_flatten(whole)[0], ref))
        return {"hops": len(hops) - 1, "leaves": len(ref)}

    def res_watchdog(self):
        """A guarded ``shard_map_callable`` whose collective hangs (the chaos
        seam's sleep, longer than the timeout) raises CollectiveTimeoutError
        within the timeout, naming its collective lines; the next call,
        unguarded, gives the right sum."""
        import torch

        from thunder_tpu_torch.distributed import prims as dist
        from thunder_tpu_torch.distributed.runtime import P, compile_with_collectives
        from thunder_tpu_torch.parallel import make_mesh
        from thunder_tpu_torch.resilience import chaos, watchdog

        n = self.world
        x = torch.arange(4 * n, dtype=torch.float32).reshape(n, 4)
        jf, _ = compile_with_collectives(lambda a: dist.all_reduce(a, "dp", n), (x[:1],), make_mesh(dp=n),
                                         (P("dp", None),), P(None, None))
        watchdog.configure(1.0)
        t0 = time.perf_counter()
        try:
            with chaos.chaos_scope("collective_hang~3.0"):
                jf(x)
            raised = None
        except watchdog.CollectiveTimeoutError as e:
            raised = {"lines": e.trace_lines, "timeout_s": e.timeout_s}
        elapsed = time.perf_counter() - t0
        watchdog.configure(None)
        # The abandoned workers finish their sleep and their collective
        # together, on every rank, before the next call.
        for t in list(watchdog._abandoned):
            t.join(timeout=30)
        out = jf(x)
        ok = bool(torch.equal(out[0], x.sum(0)))
        return {"raised": raised, "elapsed": elapsed, "sum_ok": ok}


RES_MESH = {4: {"fsdp": 2, "tp": 2}, 2: {"fsdp": 2}}
RESILIENCE_SCENARIOS = {
    4: ["res_synced_preemption", "res_sdc_guard", "res_host_loss", "res_reshard", "res_watchdog"],
    2: ["res_elastic_resume", "res_synced_preemption", "res_watchdog"],
}


def _timeout(signum, frame):
    raise TimeoutError(f"scenario exceeded {LIMIT_S} s")


def run_torch(rank: int, world: int, store_path: str, out: str, ckpt: str, scenarios=None) -> None:
    from datetime import timedelta

    import torch

    import thunder_tpu_torch.distributed as td

    torch.set_num_threads(1)
    store = torch.distributed.FileStore(store_path, world)
    td.init(device="cpu", store=store, num_processes=world, process_id=rank, timeout=timedelta(seconds=LIMIT_S))
    runner = TorchRank(rank, world, ckpt, out)
    res_runner = ResilienceRank()
    res_runner.rank, res_runner.world, res_runner.ckpt, res_runner.out = rank, world, ckpt, out
    results = {}
    signal.signal(signal.SIGALRM, _timeout)
    for name in scenarios or TORCH_SCENARIOS[world]:
        t0 = time.perf_counter()
        signal.alarm(LIMIT_S)
        try:
            results[name] = {"ok": True, **getattr(res_runner if name.startswith("res_") else runner, name)()}
            torch.distributed.barrier()
        except BaseException:  # noqa: BLE001 - recorded for the test, and the rank stops here
            results[name] = {"ok": False, "error": traceback.format_exc()[-4000:]}
        finally:
            signal.alarm(0)
        results[name]["seconds"] = time.perf_counter() - t0
        if not results[name]["ok"]:
            break
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(results, f)
    td.shutdown()
    assert not td.is_initialized()


# =============================================================================
# The JAX package, WORLD virtual devices in one process
# =============================================================================


def _jax_module(mode: str, world: int, strategy=None):
    import thunder_tpu
    from thunder_tpu.distributed import FSDPType, ddp, fsdp
    from thunder_tpu.parallel import make_mesh

    m = _tiny_gpt()
    if mode == "ddp":
        m = ddp(m, mesh=make_mesh(dp=world))
    else:
        m = fsdp(m, sharding_strategy=strategy or FSDPType.ZERO3)
    return m, thunder_tpu.jit(m)


def jax_collectives(world: int):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from thunder_tpu.distributed import prims as dist
    from thunder_tpu.distributed.runtime import compile_with_collectives
    from thunder_tpu.parallel import make_mesh

    x = np.arange(2 * world, dtype=np.float32).reshape(world, 2)

    def f(a):
        s = dist.all_reduce(a, "dp", world)
        g = dist.all_gather(a, "dp", world)
        rs = dist.reduce_scatter(g, "dp", world)
        return s, g, rs

    jf, _ = compile_with_collectives(f, (x[:1],), make_mesh(dp=world), (JP("dp", None),),
                                     (JP(), JP(None, None), JP("dp", None)))
    s, g, rs = jf(jnp.asarray(x))
    return {"s": _flat(s), "g": _flat(g), "rs": _flat(rs)}


def jax_broadcast_grad(world: int):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    import thunder_tpu.torch as ttorch
    from thunder_tpu.distributed import prims as dist
    from thunder_tpu.distributed.runtime import compile_with_collectives
    from thunder_tpu.parallel import make_mesh

    root = min(3, world - 1)
    x = (np.arange(world, dtype=np.float32) + 1.0).reshape(world, 1)

    def f(a):
        b = dist.broadcast(a, "dp", world, root=root)
        return ttorch.sum(b * b)

    jf, _ = compile_with_collectives(f, (x[:1],), make_mesh(dp=world), (JP("dp", None),),
                                     (JP(), (JP("dp", None),)), grad=True)
    loss, (g,) = jf(jnp.asarray(x))
    return {"loss": [float(loss)], "grad": _flat(g)}


def _jax_train(mode: str, world: int):
    import torch
    import torch.nn.functional as F

    m, tm = _jax_module(mode, world)
    idx, tgt = (torch.from_numpy(a[0]) for a in _tokens())
    opt = torch.optim.SGD(m.parameters(), lr=0.1)
    losses = []
    for step in range(4):
        opt.zero_grad()
        loss = F.cross_entropy(tm(idx).reshape(-1, VOCAB), tgt.reshape(-1))
        loss.backward()
        if step == 3:
            grads = {k: _flat(p.grad) for k, p in m.named_parameters()}
        opt.step()
        losses.append(float(loss.detach()))
    return {"losses": losses, "grads": grads}


def jax_module_ddp_train(world: int):
    return _jax_train("ddp", world)


def jax_module_fsdp_train(world: int):
    return _jax_train("fsdp", world)


def jax_fsdp_zero3(world: int):
    import torch
    import torch.nn.functional as F

    from thunder_tpu.distributed import FSDPType

    idx, tgt = (torch.from_numpy(a[0]) for a in _tokens())
    out = {}
    for name, strategy in (("loss2", FSDPType.ZERO2), ("loss3", FSDPType.ZERO3)):
        _, tm = _jax_module("fsdp", world, strategy)
        out[name] = [float(F.cross_entropy(tm(idx).reshape(-1, VOCAB), tgt.reshape(-1)).detach())]
    return out


def _jax_no_sync(mode: str, world: int):
    import torch
    import torch.nn.functional as F

    m, tm = _jax_module(mode, world)
    K = 3
    idx, tgt = (torch.from_numpy(a) for a in _tokens(K))
    with tm.no_sync():
        for k in range(K):
            (F.cross_entropy(tm(idx[k]).reshape(-1, VOCAB), tgt[k].reshape(-1)) / K).backward()
    return {"grads": {k: _flat(p.grad) for k, p in m.named_parameters()}}


def jax_no_sync_ddp(world: int):
    return _jax_no_sync("ddp", world)


def jax_no_sync_fsdp(world: int):
    return _jax_no_sync("fsdp", world)


def jax_batch_reduced_output(world: int):
    import torch

    import thunder_tpu
    from thunder_tpu.distributed import ddp
    from thunder_tpu.parallel import make_mesh

    red, masked = _reducers()
    inp = torch.from_numpy(np.random.RandomState(1).randn(32, 4).astype(np.float32))
    got = thunder_tpu.jit(ddp(red, mesh=make_mesh(dp=world)))(inp)
    x2 = torch.from_numpy(np.random.RandomState(2).randn(24, 16).astype(np.float32))
    mask = torch.from_numpy(np.random.RandomState(3).randn(16, 16).astype(np.float32))
    got2 = thunder_tpu.jit(ddp(masked, mesh=make_mesh(dp=world)))(x2, mask)
    return {"reduced": _flat(got.detach()), "masked": _flat(got2.detach())}


def jax_grid(world: int):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as JP

    from thunder_tpu.distributed import prims as dist
    from thunder_tpu.distributed.runtime import compile_with_collectives

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("outer", "inner"))
    x = _grid_input()

    def f(a):
        p = dist.ppermute(a, "inner", [(0, 1), (1, 0)])
        t = dist.all_to_all(a, "inner", 2, split_dim=1, concat_dim=0)
        h = dist.hier_all_reduce(a, "inner", "outer", 2, 2)
        flat = dist.hier_all_reduce(a[:1], "inner", "outer", 2, 2, op="avg")
        return p, t, h, flat

    both = JP(("outer", "inner"), None)
    jf, _ = compile_with_collectives(f, (x[:2],), mesh, (both,), (both, both, JP(), JP()))
    p, t, h, flat = jf(jnp.asarray(x))
    return {"p": _flat(p), "t": _flat(t), "h": _flat(h), "flat": _flat(flat)}


def _jax_sharded_train(world: int, case: str):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from thunder_tpu.core.pytree import tree_map
    from thunder_tpu.models import gpt as jm
    from thunder_tpu.parallel import build_train_step, make_mesh
    from thunder_tpu.parallel.sharding import gpt_param_specs

    cfg_name, axes, kind = TRAIN_CASES[world][case]
    cfg = jm.name_to_config(cfg_name)
    params = tree_map(jnp.asarray, _np_params(cfg_name))
    idx, tgt = (a.astype(np.int32) for a in _train_tokens(cfg.vocab_size))
    mesh = make_mesh(**axes)
    if kind == "replicated":
        specs = tree_map(lambda _: JP(), params)
    else:
        specs = gpt_param_specs(cfg, mesh, tp=(kind == "full"))
    step, opt = build_train_step(cfg, params, idx, tgt, mesh=mesh, param_specs=specs, lr=1e-2, donate=False)
    losses, p, o = [], params, opt
    for _ in range(TRAIN_STEPS):
        p, o, loss = step(p, o, idx, tgt)
        losses.append(float(np.asarray(loss)))
    sgd, sgd_opt = build_train_step(cfg, params, idx, tgt, mesh=mesh, param_specs=specs, lr=1e-2, donate=False,
                                    optimizer="sgd")
    sp = params
    for _ in range(TRAIN_STEPS):
        sp, sgd_opt, _ = sgd(sp, sgd_opt, idx, tgt)
    return {"losses": losses, "params": _flat_tree(p), "sgd_params": _flat_tree(sp)}


def jax_ddp_train(world: int):
    return _jax_sharded_train(world, "ddp_train")


def jax_fsdp_train(world: int):
    return _jax_sharded_train(world, "fsdp_train")


def jax_tp_fsdp_train(world: int):
    return _jax_sharded_train(world, "tp_fsdp_train")


def jax_dp_tp_train(world: int):
    return _jax_sharded_train(world, "dp_tp_train")



def _shard_map():
    try:
        from jax.experimental.shard_map import shard_map
    except ImportError:
        from jax.shard_map import shard_map
    return shard_map


def _jax_attention(world: int, which: str):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from thunder_tpu.parallel import make_mesh
    from thunder_tpu.parallel.context import ring_attention, ulysses_attention

    fn = ring_attention if which == "ring" else ulysses_attention
    mesh = make_mesh(sp=world)
    q, k, v = (jnp.asarray(a) for a in _qkv(which))
    spec = JP(None, None, "sp", None)
    f = jax.jit(_shard_map()(lambda q, k, v: fn(q, k, v, "sp", causal=True), mesh=mesh, in_specs=(spec,) * 3,
                             out_specs=spec, check_rep=False))
    out = {"out": _flat(np.asarray(f(q, k, v)))}
    if which == "ring":
        # jax.grad through Ulysses' tiled=False all_to_all fails in jax 0.9
        # (its transpose's cotangent has the source axis in the wrong
        # place); the ranks hold Ulysses' grads against plain attention.
        grads = jax.grad(lambda q, k, v: (f(q, k, v).astype(jnp.float32) ** 2).sum(), argnums=(0, 1, 2))(q, k, v)
        out["grads"] = [_flat(np.asarray(g)) for g in grads]
    return out


def jax_ring_attention(world: int):
    return _jax_attention(world, "ring")


def jax_ulysses_attention(world: int):
    return _jax_attention(world, "ulysses")


def jax_long_context_train(world: int):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from thunder_tpu.parallel import make_mesh
    from thunder_tpu.parallel.context import ring_attention

    mesh = make_mesh(sp=world)
    wq, wo, x, tgt = (jnp.asarray(a) for a in _long_context_inputs())

    def attn_local(xq, wq):
        q = (xq @ wq.T).reshape(LC_B, -1, LC_H, LC_D).transpose(0, 2, 1, 3)
        o = ring_attention(q, q, q, "sp", causal=True)
        return o.transpose(0, 2, 1, 3).reshape(LC_B, -1, LC_H * LC_D)

    def loss_fn(wq, wo, x, tgt):
        h = _shard_map()(attn_local, mesh=mesh, in_specs=(JP(None, "sp", None), JP()),
                         out_specs=JP(None, "sp", None), check_rep=False)(x, wq)
        logp = jax.nn.log_softmax((h @ wo.T).astype(jnp.float32), axis=-1)
        return -jnp.take_along_axis(logp, tgt[..., None], axis=-1).mean()

    l1, g1 = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(wq, wo, x, tgt)
    return {"loss": [float(l1)], "grads": [_flat(np.asarray(g)) for g in g1]}


def _jax_moe(world: int, capacity=None):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from thunder_tpu.parallel import make_mesh
    from thunder_tpu.parallel.moe import moe_mlp

    mesh = make_mesh(ep=world)
    return jax.jit(_shard_map()(
        lambda x, rw, w1, w2: moe_mlp(x, rw, w1, w2, "ep", top_k=MOE_TOPK, capacity=capacity), mesh=mesh,
        in_specs=(JP("ep", None), JP(), JP("ep", None, None), JP("ep", None, None)), out_specs=JP("ep", None),
        check_rep=False)), jnp


def jax_moe_ep(world: int):
    import jax

    f, jnp = _jax_moe(world)
    x, rw, w1, w2 = (jnp.asarray(a) for a in _moe_np(MOE_SEEDS[False]))
    g = jax.grad(lambda rw, w1, w2: (f(x, rw, w1, w2).astype(jnp.float32) ** 2).sum(), argnums=(0, 1, 2))(rw, w1, w2)
    tiny, _ = _jax_moe(world, capacity=1)
    return {"out": _flat(np.asarray(f(x, rw, w1, w2))), "grads": [_flat(np.asarray(a)) for a in g],
            "dropped": _flat(np.asarray(tiny(x, rw, w1, w2)))}


def jax_moe_capacity(world: int):
    import jax

    f, jnp = _jax_moe(world, capacity=MOE_CAP)
    x, rw, w1, w2 = (jnp.asarray(a) for a in _moe_np(MOE_SEEDS[True]))

    @jax.jit
    def step(rw, w1, w2):
        l, g = jax.value_and_grad(lambda rw, w1, w2: (f(x, rw, w1, w2).astype(jnp.float32) ** 2).sum(),
                                  argnums=(0, 1, 2))(rw, w1, w2)
        return l, tuple(p - 0.02 * gp for p, gp in zip((rw, w1, w2), g))

    out, losses = _flat(np.asarray(f(x, rw, w1, w2))), []
    for _ in range(15):
        loss, (rw, w1, w2) = step(rw, w1, w2)
        losses.append(float(loss))
    return {"out": out, "losses": losses}


def jax_pipeline_pp(world: int):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from thunder_tpu.parallel import make_mesh
    from thunder_tpu.parallel.pipeline import pipeline_apply

    mesh = make_mesh(pp=world)
    W, b, xs, tgt = (jnp.asarray(a) for a in _pipeline_inputs(world))

    def stage_fn(params, x):
        w, bb = params
        return jnp.tanh(x @ w + bb)

    def piped(W, b, xs):
        return _shard_map()(lambda Wl, bl, xs: pipeline_apply(stage_fn, (Wl[0], bl[0]), xs, "pp"), mesh=mesh,
                            in_specs=(JP("pp", None, None), JP("pp", None), JP()), out_specs=JP(),
                            check_rep=False)(W, b, xs)

    loss_p = lambda W, b: ((piped(W, b, xs) - tgt) ** 2).mean()  # noqa: E731
    step = jax.jit(lambda W, b: jax.value_and_grad(loss_p, argnums=(0, 1))(W, b))
    out = _flat(np.asarray(jax.jit(piped)(W, b, xs)))
    grads = [_flat(np.asarray(g)) for g in step(W, b)[1]]
    losses = []
    for _ in range(25):
        loss, (gW, gb) = step(W, b)
        W, b = W - 0.5 * gW, b - 0.5 * gb
        losses.append(float(loss))
    return {"out": out, "grads": grads, "losses": losses}


def jax_gpt_pipeline(world: int):
    import jax.numpy as jnp

    from thunder_tpu.core.pytree import tree_map
    from thunder_tpu.models import gpt as jm
    from thunder_tpu.parallel import make_mesh
    from thunder_tpu.parallel.gpt_pp import gpt_pp_loss_and_grads

    cfg = jm.GPTConfig(**PP_CONFIG)
    params = tree_map(jnp.asarray, _np_params_of(cfg))
    idx, tgt = (a.astype(np.int32) for a in _pp_tokens(PP_B))
    mesh = make_mesh(pp=world)
    out = {}
    for sched in ("gpipe", "1f1b"):
        loss, grads = gpt_pp_loss_and_grads(cfg, params, idx, tgt, mesh, n_micro=4, schedule=sched)
        out[sched] = {"loss": [float(loss)], "grads": _flat_tree(grads)}
    return out


def _jax_sharded_sgd(world: int, case: str):
    import jax.numpy as jnp

    from thunder_tpu.core.pytree import tree_map
    from thunder_tpu.models import gpt as jm
    from thunder_tpu.parallel import build_train_step, make_mesh
    from thunder_tpu.parallel.sharding import gpt_param_specs

    cfg_name, axes, kind = PARALLEL_TRAIN_CASES[world][case]
    cfg = jm.name_to_config(cfg_name)
    params = tree_map(jnp.asarray, _np_params(cfg_name))
    idx, tgt = (a.astype(np.int32) for a in _train_tokens(cfg.vocab_size))
    mesh = make_mesh(**axes)
    specs = gpt_param_specs(cfg, mesh, tp=(kind == "full"))
    step, opt = build_train_step(cfg, params, idx, tgt, mesh=mesh, param_specs=specs, lr=1e-2, donate=False,
                                 optimizer="sgd")
    losses, p = [], params
    for _ in range(TRAIN_STEPS):
        p, opt, loss = step(p, opt, idx, tgt)
        losses.append(float(np.asarray(loss)))
    return {"losses": losses, "params": _flat_tree(p)}


for _case in {c for cases in PARALLEL_TRAIN_CASES.values() for c in cases}:
    globals()[f"jax_{_case}"] = (lambda c: lambda world: _jax_sharded_sgd(world, c))(_case)


JAX_SCENARIOS = {
    2: ["collectives", "broadcast_grad", "module_ddp_train", "module_fsdp_train", "fsdp_zero3", "no_sync_ddp",
        "no_sync_fsdp", "batch_reduced_output", "ddp_train", "fsdp_train", "tp_fsdp_train"],
    4: ["collectives", "broadcast_grad", "module_ddp_train", "module_fsdp_train", "fsdp_zero3", "no_sync_ddp",
        "no_sync_fsdp", "batch_reduced_output", "grid", "ddp_train", "fsdp_train", "tp_fsdp_train", "dp_tp_train"],
}


JAX_PARALLEL_SCENARIOS = {
    2: ["sp_train", "pp_train", "ep_train"],
    4: ["ring_attention", "gpt_pipeline", "ulysses_attention", "long_context_train", "moe_ep", "moe_capacity",
        "pipeline_pp", "dp_sp_train", "fsdp_sp_train", "sp_tp_train"],
}


def _jax_res(world: int):
    """The JAX side of "@resilience": tests/test_mesh_resilience.py's step
    on fsdp2 x tp2 (4 devices), the same state as the ranks'."""
    from jax.sharding import PartitionSpec as JP

    from thunder_tpu.parallel import make_mesh
    from thunder_tpu.parallel.sharding import shard_pytree

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_mesh_resilience import _mesh_step

    mesh = make_mesh(fsdp=2, tp=2)
    specs = {"b": JP(), "w": JP("fsdp", "tp")}
    return mesh, specs, _mesh_step(mesh, specs), shard_pytree(_res_state_np(), mesh, specs)


def jax_res_sdc_guard(world: int):
    import tempfile

    from thunder_tpu.observability import events as ev
    from thunder_tpu.resilience import chaos, watchdog
    from thunder_tpu.resilience.preemption import CheckpointManager, run_training

    mesh, specs, step, state = _jax_res(world)
    root = tempfile.mkdtemp()
    _, baseline = run_training(step, state, 5, manager=CheckpointManager(os.path.join(root, "a")))
    log = os.path.join(root, "ev.jsonl")
    ev.set_global_path(log)
    try:
        with chaos.chaos_scope("sdc*1"):
            _, losses = run_training(step, state, 5, manager=CheckpointManager(os.path.join(root, "b")),
                                     sdc_guard=True)
    finally:
        ev.set_global_path(None)
    recs = [json.loads(line) for line in open(log)]
    try:
        with chaos.chaos_scope("sdc*inf"):
            run_training(step, state, 3, manager=CheckpointManager(os.path.join(root, "c")),
                         sdc_guard=watchdog.SDCGuard(max_reruns=2))
        persistent = None
    except watchdog.SDCDetectedError as e:
        persistent = e.leaves
    suspect = [r for r in recs if r["kind"] == "sdc_suspect"]
    return {"baseline": baseline, "losses": losses, "suspect_leaves": [r["leaves"] for r in suspect],
            "suspect_devices": [r["devices"] for r in suspect],
            "reruns_ok": [r["ok"] for r in recs if r["kind"] == "sdc_rerun"], "persistent": persistent}


def jax_res_host_loss(world: int):
    """Host loss at step 3 on fsdp2 x tp2, then the elastic resume onto
    fsdp2 over the first 2 devices."""
    import tempfile

    from jax.sharding import PartitionSpec as JP

    from thunder_tpu.parallel import make_mesh
    from thunder_tpu.resilience import chaos, elastic
    from thunder_tpu.resilience.preemption import CheckpointManager, HostLost, run_training

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_mesh_resilience import _mesh_step

    mesh, specs, step, state = _jax_res(world)
    root = tempfile.mkdtemp()
    _, baseline = run_training(step, state, RES_STEPS, manager=CheckpointManager(os.path.join(root, "a")))
    mgr = CheckpointManager(os.path.join(root, "ck"))
    with chaos.chaos_scope(f"host_loss@{RES_LOSS_AT}"):
        try:
            run_training(step, state, RES_STEPS, manager=mgr, mesh=mesh)
            lost = None
        except HostLost as e:
            lost = e.step
    mesh2 = make_mesh(fsdp=2)
    specs2 = {"b": JP(), "w": JP("fsdp", None)}
    restored, start = elastic.elastic_resume(mgr, state, mesh=mesh2, specs=specs2)
    _, cont = run_training(_mesh_step(mesh2, specs2), restored, RES_STEPS,
                           manager=CheckpointManager(os.path.join(root, "b")), start_step=start)
    return {"baseline": baseline, "lost": lost, "start": start, "continued": cont}


JAX_RESILIENCE_SCENARIOS = {4: ["res_sdc_guard", "res_host_loss"]}


def run_jax(world: int, out: str, scenarios=None) -> None:
    import jax

    assert len(jax.devices()) == world, jax.devices()
    results = {}
    for name in scenarios or JAX_SCENARIOS[world]:
        t0 = time.perf_counter()
        try:
            results[name] = {"ok": True, **globals()[f"jax_{name}"](world)}
        except Exception:  # noqa: BLE001 - recorded for the test
            results[name] = {"ok": False, "error": traceback.format_exc()[-4000:]}
        results[name]["seconds"] = time.perf_counter() - t0
    with open(os.path.join(out, "jax.json"), "w") as f:
        json.dump(results, f)


GROUPS = {"@train": TRAIN_SCENARIOS, "@parallel": PARALLEL_SCENARIOS, "@resilience": RESILIENCE_SCENARIOS}

if __name__ == "__main__":
    if sys.argv[1] == "torch":
        names = sys.argv[7] if len(sys.argv) > 7 else None
        if names in GROUPS:
            names = ",".join(GROUPS[names][int(sys.argv[3])])
        run_torch(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6],
                  names.split(",") if names else None)
    else:
        names = sys.argv[4] if len(sys.argv) > 4 else None
        if names == "@parallel":
            names = ",".join(JAX_PARALLEL_SCENARIOS[int(sys.argv[2])])
        elif names == "@resilience":
            names = ",".join(JAX_RESILIENCE_SCENARIOS[int(sys.argv[2])])
        run_jax(int(sys.argv[2]), sys.argv[3], names.split(",") if names else None)
