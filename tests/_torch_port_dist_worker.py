"""The multi-rank scenarios of ``tests/test_torch_port_distributed_ranks.py``.

Each scenario of ``tests/_dist_worker.py`` that item 10 of the port covers,
written twice over the same inputs (one numpy seed; torch modules from one
torch seed, which the JAX package's module frontend takes as they are):

    python tests/_torch_port_dist_worker.py torch RANK WORLD STORE OUT [CKPT]
        one gloo rank of the port (``thunder_tpu_torch.distributed``),
        rendezvous on the FileStore STORE; writes OUT/rank<RANK>.json;
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


def _flat(t) -> list:
    t = t.detach() if hasattr(t, "detach") else t
    return np.asarray(t, dtype=np.float64).ravel().tolist()


# =============================================================================
# The port, one gloo rank
# =============================================================================


class TorchRank:
    def __init__(self, rank: int, world: int, ckpt: str):
        self.rank, self.world, self.ckpt = rank, world, ckpt

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


def _timeout(signum, frame):
    raise TimeoutError(f"scenario exceeded {LIMIT_S} s")


def run_torch(rank: int, world: int, store_path: str, out: str, ckpt: str) -> None:
    from datetime import timedelta

    import torch

    import thunder_tpu_torch.distributed as td

    torch.set_num_threads(1)
    store = torch.distributed.FileStore(store_path, world)
    td.init(device="cpu", store=store, num_processes=world, process_id=rank, timeout=timedelta(seconds=LIMIT_S))
    runner = TorchRank(rank, world, ckpt)
    results = {}
    signal.signal(signal.SIGALRM, _timeout)
    for name in TORCH_SCENARIOS[world]:
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


JAX_SCENARIOS = {
    2: ["collectives", "broadcast_grad", "module_ddp_train", "module_fsdp_train", "fsdp_zero3", "no_sync_ddp",
        "no_sync_fsdp", "batch_reduced_output"],
    4: ["collectives", "broadcast_grad", "module_ddp_train", "module_fsdp_train", "fsdp_zero3", "no_sync_ddp",
        "no_sync_fsdp", "batch_reduced_output", "grid"],
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
        run_torch(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
    else:
        run_jax(int(sys.argv[2]), sys.argv[3])
