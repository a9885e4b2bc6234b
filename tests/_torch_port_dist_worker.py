"""The multi-rank scenarios of ``tests/test_torch_port_distributed_ranks.py``.

Each scenario of ``tests/_dist_worker.py`` that item 10 of the port covers,
written twice over the same inputs (one numpy seed; torch modules from one
torch seed, which the JAX package's module frontend takes as they are):

    python tests/_torch_port_dist_worker.py torch RANK WORLD STORE OUT [CKPT [SCENARIOS]]
        one gloo rank of the port (``thunder_tpu_torch.distributed``),
        rendezvous on the FileStore STORE; writes OUT/rank<RANK>.json;
        SCENARIOS (comma-separated) runs those in place of the size's list;
    python tests/_torch_port_dist_worker.py jax WORLD OUT
        the JAX package on WORLD virtual CPU devices (run it with
        ``XLA_FLAGS=--xla_force_host_platform_device_count=WORLD``); writes
        OUT/jax.json.

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

    rng = np.random.RandomState(0)

    def make(shape, init):
        if init == "ones":
            return np.ones(shape, np.float32)
        if init == "zeros":
            return np.zeros(shape, np.float32)
        return (rng.randn(*shape) * init).astype(np.float32)

    return m._map_spec(m._param_shapes(m.name_to_config(cfg_name)), make)


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
    results = {}
    signal.signal(signal.SIGALRM, _timeout)
    for name in scenarios or TORCH_SCENARIOS[world]:
        t0 = time.perf_counter()
        signal.alarm(LIMIT_S)
        try:
            results[name] = {"ok": True, **getattr(runner, name)()}
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


JAX_SCENARIOS = {
    2: ["collectives", "broadcast_grad", "module_ddp_train", "module_fsdp_train", "fsdp_zero3", "no_sync_ddp",
        "no_sync_fsdp", "batch_reduced_output", "ddp_train", "fsdp_train", "tp_fsdp_train"],
    4: ["collectives", "broadcast_grad", "module_ddp_train", "module_fsdp_train", "fsdp_zero3", "no_sync_ddp",
        "no_sync_fsdp", "batch_reduced_output", "grid", "ddp_train", "fsdp_train", "tp_fsdp_train", "dp_tp_train"],
}


def run_jax(world: int, out: str) -> None:
    import jax

    assert len(jax.devices()) == world, jax.devices()
    results = {}
    for name in JAX_SCENARIOS[world]:
        t0 = time.perf_counter()
        try:
            results[name] = {"ok": True, **globals()[f"jax_{name}"](world)}
        except Exception:  # noqa: BLE001 - recorded for the test
            results[name] = {"ok": False, "error": traceback.format_exc()[-4000:]}
        results[name]["seconds"] = time.perf_counter() - t0
    with open(os.path.join(out, "jax.json"), "w") as f:
        json.dump(results, f)


if __name__ == "__main__":
    if sys.argv[1] == "torch":
        names = sys.argv[7] if len(sys.argv) > 7 else None
        if names == "@train":
            names = ",".join(TRAIN_SCENARIOS[int(sys.argv[3])])
        run_torch(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6],
                  names.split(",") if names else None)
    else:
        run_jax(int(sys.argv[2]), sys.argv[3])
