"""The train runner: the port's AdamW step, fed from a pool on the device.

Set-up makes the weights and a pool of token rows from the seed, builds the
step (``parallel.build_train_step``, staged as the program stages it) on two
fixed input buffers, and drives it through its first ``checked_steps`` steps
by the same call and feed as the window: the first runs eagerly, the second
captures the CUDA graph, the third replays it. Those steps are what the
reference follows. Each step's rows differ from every other's in an epoch
of the pool.

The window dispatches steps ahead, reads the loss to the host every
``loss_read_every`` steps as a training loop logs it, and ends with a
synchronize; the rate is the tokens of every step it ran over all its time.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from h100bench import cells

class Runner:
    def __init__(self, cell: cells.Cell, device, executors=None):
        t = cell.traffic
        self.cell, self.device, self.executors = cell, torch.device(device), executors
        self.B, self.T, self.opt_cfg = t["batch"], t["seq_len"], t["optimizer"]
        self.step = self.params = self.opt = None
        self.build_s = None
        self.k = 0

    # -- set-up ---------------------------------------------------------------

    def load(self, seed: int) -> None:
        """Weights, pool and schedule from ``seed``; the step is built on the
        first load and reused after (new values copied into its tensors)."""
        t = self.cell.traffic
        self.seed, self.k = seed, 0
        params = cells.make_params(self.cell, seed, self.device)
        pool = cells.make_pool(self.cell, seed, t["pool_rows"], self.T + 1, self.device)
        rng, per_epoch = cells.host_rng(seed, 3), t["pool_rows"] // self.B
        sched = [rng.permutation(t["pool_rows"])[: per_epoch * self.B].reshape(per_epoch, self.B)
                 for _ in range(max(1, 1024 // per_epoch))]
        sched = torch.as_tensor(np.concatenate(sched), device=self.device)
        if self.step is None:
            self.pool, self.sched, self.params = pool, sched, params
            self.idx = torch.empty(self.B, self.T, dtype=torch.int64, device=self.device)
            self.tgt = torch.empty_like(self.idx)
            self.feed(0)
            self._build()
            return
        self.pool.copy_(pool)
        self.sched.copy_(sched)
        with torch.no_grad():
            for dst, src in zip(cells.flatten(self.params).values(), cells.flatten(params).values()):
                dst.copy_(src)
            for leaf in list(cells.flatten(self.opt["m"]).values()) + list(cells.flatten(self.opt["v"]).values()):
                leaf.zero_()
            self.opt["step"].zero_()

    def _build(self) -> None:
        self.build_on(self.idx, self.tgt)

    def build_on(self, idx: torch.Tensor, tgt: torch.Tensor) -> None:
        """Build the step on the input buffers ``idx`` and ``tgt``."""
        from thunder_tpu_torch.parallel import build_train_step

        o = self.opt_cfg
        if o["name"] != "adamw" or o["eps"] != 1e-8:
            raise ValueError("the port's step is AdamW with eps 1e-8")
        t0 = time.perf_counter()
        self.step, self.opt = build_train_step(
            self.cell.program_config(), self.params, idx, tgt, optimizer="adamw",
            lr=o["lr"], weight_decay=o["weight_decay"], b1=o["b1"], b2=o["b2"], executors=self.executors)
        self.build_s = time.perf_counter() - t0

    def feed(self, k: int) -> None:
        rows = self.sched[k % self.sched.shape[0]]
        torch.index_select(self.pool[:, : self.T], 0, rows, out=self.idx)
        torch.index_select(self.pool[:, 1:], 0, rows, out=self.tgt)

    def rows(self, k: int) -> torch.Tensor:
        return self.sched[k % self.sched.shape[0]]

    def one_step(self):
        """The window's call: feed the next batch, run the step."""
        self.feed(self.k)
        self.k += 1
        self.params, self.opt, loss = self.step(self.params, self.opt, self.idx, self.tgt)
        return loss

    def setup(self) -> dict:
        """The first steps, through the window's call: each loss, the first
        gradient as the optimizer holds it after step 1 (m / (1 − b1); its
        norms, and the moment itself copied to the host for the reference to
        compare element by element), and each parameter's change after the
        last of them. ``check_s`` is the time spent taking these readings,
        which set-up does not count."""
        n = self.cell.traffic["checked_steps"]
        losses, grads, check_s = [], None, 0.0
        for i in range(n):
            losses.append(float(self.one_step()))
            if i == 0:
                t0 = time.perf_counter()
                m = cells.flatten(self.opt["m"])
                grads = cells.unit_norms(self.cell, m.items(), 1 / (1 - self.opt_cfg["b1"]))
                first = {k: v.to("cpu", copy=True) for k, v in m.items()}
                check_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        p0 = cells.flatten(cells.make_params(self.cell, self.seed, self.device))
        change = cells.unit_norms(self.cell, ((k, p.float() - p0[k].float())
                                              for k, p in cells.flatten(self.params).items()))
        del p0
        check_s += time.perf_counter() - t0
        return {"losses": losses, "grad_norms": grads, "first_moment": first, "change_norms": change,
                "check_s": check_s}

    # -- the window -----------------------------------------------------------

    def window(self, seconds: float) -> dict:
        every = self.cell.traffic["loss_read_every"]
        cells.sync(self.device)
        steps, bad = 0, 0
        t0 = time.perf_counter()
        while True:
            loss = self.one_step()
            steps += 1
            if steps % every == 0:
                bad += not torch.isfinite(loss).item()
            if time.perf_counter() - t0 >= seconds:
                break
        bad += not torch.isfinite(loss).item()
        cells.sync(self.device)
        elapsed = time.perf_counter() - t0
        return {"steps": steps, "attempted": steps, "elapsed_s": elapsed, "failed": bad,
                "tokens": steps * self.B * self.T}

    def traced(self):
        from h100bench import devtrace

        from torch.profiler import record_function

        n = self.cell.traffic["traced_steps"]

        def run():
            for _ in range(n):
                with record_function("h100bench.step"):
                    self.one_step()

        return devtrace.capture(run), n

    def spans(self) -> dict:
        return {"build_s": self.build_s, "capture_s": self.step.staging.capture_s}

    def release(self) -> None:
        self.step = self.params = self.opt = self.idx = self.tgt = None
        gc.collect()
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    # -- the reference --------------------------------------------------------

    def reference(self, readings: dict, win: dict) -> dict:
        """The reference over the same first steps, in float32; returns each
        number compared."""
        ref = self.cell.reference()
        o, c = self.opt_cfg, self.cell.config
        params = cells.make_params(self.cell, self.seed, self.device)
        leaves = {k: v.float().requires_grad_(True) for k, v in cells.flatten(params).items()}
        del params
        p0 = {k: v.detach().clone() for k, v in leaves.items()}
        tree = cells.rebuild(self.cell.family.layout(c), leaves)
        opt = ref.AdamW(list(leaves.values()), o["lr"], o["b1"], o["b2"], o["eps"], o["weight_decay"],
                        store=getattr(torch, c["torch_dtype"]))
        losses, grads = [], None
        for k in range(len(readings["losses"])):
            rows = self.rows(k)
            idx, tgt = self.pool[rows, : self.T], self.pool[rows, 1:]
            losses.append(ref.loss_and_grads(tree, idx, tgt, c))
            if k == 0:
                grads = cells.unit_norms(self.cell, ((k, v.grad) for k, v in leaves.items()))
                diff = cells.unit_norms(self.cell, (
                    (k, readings["first_moment"][k].to(self.device).float() / (1 - o["b1"]) - v.grad)
                    for k, v in leaves.items()))
            opt.step()
        with torch.no_grad():
            change = cells.unit_norms(self.cell, ((k, v - p0[k]) for k, v in leaves.items()))
        median = sorted(grads.values())[len(grads) // 2]
        moving = {k for k, g in grads.items() if g >= 1e-3 * median}
        loss_gap = max(abs(a - b) for a, b in zip(readings["losses"], losses))
        grad_gap, grad_leaf = cells.gap_by_leaf(readings["grad_norms"], grads)
        grad_diff, diff_leaf = cells.gap_by_leaf(diff, grads, zero=True)
        change_gap, change_leaf = cells.gap_by_leaf(readings["change_norms"], change, keep=moving)
        return {"loss_gap": loss_gap, "grad_gap": grad_gap, "grad_diff": grad_diff, "change_gap": change_gap,
                "_detail": {"program_losses": readings["losses"], "reference_losses": losses,
                            "grad_leaf": grad_leaf, "diff_leaf": diff_leaf, "change_leaf": change_leaf,
                            "left_out": sorted(set(grads) - moving)}}

    # -- what the metrics read ------------------------------------------------

    def end_to_end(self, win: dict) -> dict:
        return {"train_tokens_per_s": ("tokens/s", win["tokens"] / win["elapsed_s"])}

    def flops_per_step(self) -> int:
        from h100bench import counts

        return counts.train_flops(self.cell.dims, self.B, self.T)
