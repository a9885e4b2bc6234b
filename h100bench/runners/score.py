"""The score runner: the port's jitted per-token loss under symbolic values,
one caller.

Each call scores ``batch`` rows of one length T and answers with each
token's next-token loss, (B, T), as an evaluation harness scores a batch of
requests of one length and reads each request's token log-likelihoods. The lengths come from the
mix's ``length`` entry: ``{"values": [...]}`` lists them outright, and
``{"median", "sigma", "min", "max"}`` takes ``lengths_per_cycle`` quantiles
of a clipped log-normal. They are shuffled anew in each cycle, in an order
that is the same for every seed, so that every seed does the same work. The
seed draws the weights, the tokens and the rows of the pool each call reads.

The entry is ``jit`` of the model's forward and one unreduced cross-entropy
a row,
with ``cache="symbolic values"`` and dim 1 of the ids and targets marked, so
each ``bucket``-wide range of lengths is one compiled entry and one CUDA
graph. Set-up calls every bucket the lengths touch twice (the eager call,
then the capture). In the window every call's answers are read to the host
before the next call, a closed loop; a call's latency runs from the call to
its answers on the host.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from h100bench import cells

ORDER_SEED = 5  # the one order of lengths, the same for every run


def length_set(t: dict) -> list:
    """The mix's lengths, one cycle's worth, in ascending order."""
    L = t["length"]
    if "values" in L:
        return sorted(int(v) for v in L["values"])
    n = t["lengths_per_cycle"]
    dist = statistics.NormalDist(np.log(L["median"]), L["sigma"])
    return [int(min(L["max"], max(L["min"], round(float(np.exp(dist.inv_cdf((i + 0.5) / n))))))) for i in range(n)]


def ceiling(T: int, bucket: int) -> int:
    return -(-T // bucket) * bucket


class Runner:
    def __init__(self, cell: cells.Cell, device, executors=None):
        t = cell.traffic
        self.cell, self.device, self.executors = cell, torch.device(device), executors
        self.B, self.lengths, self.bucket = t["batch"], length_set(t), t["bucket"]
        self.entry = self.params = None

    # -- set-up ---------------------------------------------------------------

    def load(self, seed: int) -> None:
        """Weights and pool from ``seed``; the entry is made on the first
        load and reused after (new values copied into the same tensors)."""
        params = cells.make_params(self.cell, seed, self.device)
        pool = self.inputs(seed)
        if self.entry is None:
            self.params, self.pool = params, pool
            self._make_entry()
            return
        self.pool.copy_(pool)
        with torch.no_grad():
            for dst, src in zip(cells.flatten(self.params).values(), cells.flatten(params).values()):
                dst.copy_(src)

    def inputs(self, seed: int) -> torch.Tensor:
        """Start the calls over (the lengths in their fixed order, rows drawn
        from the seed); return the seed's pool of token rows."""
        self.seed, self.cycle = seed, []
        self.order_rng, self.row_rng = np.random.default_rng(ORDER_SEED), cells.host_rng(seed, 6)
        return cells.make_pool(self.cell, seed, self.cell.traffic["pool_rows"], max(self.lengths) + 1, self.device)

    def _make_entry(self) -> None:
        import thunder_tpu_torch as tt
        import thunder_tpu_torch.torch as ttorch
        from thunder_tpu_torch.models import gpt

        cfg = self.cell.program_config()
        n = len(cells.flatten(self.params))

        def token_losses(p, i, t):
            logits = gpt.forward(p, i, cfg).float()
            return ttorch.stack([ttorch.cross_entropy(logits[b], t[b], reduction="none") for b in range(i.shape[0])])

        self.entry = tt.jit(token_losses, cache="symbolic values", symbolic_dims={n: (1,), n + 1: (1,)},
                            executors=self.executors, device=self.device)

    def next_call(self) -> tuple:
        """The next call's (T, first row): the cycle's next length, and a
        block of ``batch`` rows of the pool drawn from the seed."""
        if not self.cycle:
            self.cycle = [self.lengths[i] for i in self.order_rng.permutation(len(self.lengths))]
        T = self.cycle.pop()
        r = int(self.row_rng.integers(0, self.pool.shape[0] - self.B + 1))
        return T, r

    def batch(self, T: int, r: int) -> tuple:
        return self.pool[r: r + self.B, :T].contiguous(), self.pool[r: r + self.B, 1: T + 1].contiguous()

    def call(self, idx, tgt):
        """The program's call."""
        return self.entry(self.params, idx, tgt)

    def answer(self, losses, T: int) -> torch.Tensor:
        """The call's answers on the host: one loss a token, (B, T) float32.
        Where T is short of its bucket the program returns the bucket's
        width (its cross-entropy reshapes the targets, and the padded dim is
        no longer tracked through that); the first T columns are the
        answers, as a caller takes them."""
        return losses[:, :T].float().cpu()

    def setup(self) -> dict:
        """Every bucket the lengths touch, twice: the eager call and the
        capture."""
        firsts = {}
        for T in self.lengths:
            firsts.setdefault(ceiling(T, self.bucket), T)
        for T in firsts.values():
            for _ in range(2):
                self.answer(self.call(*self.batch(T, 0)), T)
        return {"check_s": 0.0}

    # -- the window -----------------------------------------------------------

    def window(self, seconds: float) -> dict:
        """Closed-loop calls for ``seconds``: records of (T, latency s,
        dispatch s, answers, first row)."""
        from torch.profiler import record_function

        records = []
        cells.sync(self.device)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            T, r = self.next_call()
            idx, tgt = self.batch(T, r)
            with record_function("h100bench.call"):
                a = time.perf_counter()
                losses = self.call(idx, tgt)
                b = time.perf_counter()
            with record_function("h100bench.read_answers"):
                values = self.answer(losses, T)
            records.append((T, time.perf_counter() - a, b - a, values, r))
        elapsed = time.perf_counter() - t0
        return {"records": records, "elapsed_s": elapsed, "attempted": len(records),
                "failed": sum(not bool(torch.isfinite(rec[3]).all()) for rec in records)}

    def traced(self):
        from torch.profiler import record_function

        from h100bench import devtrace

        n = self.cell.traffic["traced_calls"]
        lengths = []

        def run():
            for _ in range(n):
                T, r = self.next_call()
                lengths.append(T)
                idx, tgt = self.batch(T, r)
                with record_function("h100bench.call"):
                    losses = self.call(idx, tgt)
                with record_function("h100bench.read_answers"):
                    self.answer(losses, T)

        return devtrace.capture(run), lengths

    def spans(self) -> dict:
        import thunder_tpu_torch as tt

        return {"capture_s": sum(e.staging.capture_s for e in tt.compile_stats(self.entry).cache_entries)}

    def release(self) -> None:
        self.entry = self.params = None
        gc.collect()
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    # -- the reference --------------------------------------------------------

    def sample(self, records: list) -> list:
        """The calls checked: the longest, and others drawn from the seed."""
        n = self.cell.traffic["checked_calls"]
        longest = max(range(len(records)), key=lambda i: records[i][0])
        rest = [i for i in range(len(records)) if i != longest]
        picked = cells.host_rng(self.seed, 7).choice(len(rest), size=min(n - 1, len(rest)), replace=False)
        return [longest] + [rest[i] for i in sorted(picked)]

    def reference(self, readings: dict, win: dict) -> dict:
        """Each token of each sampled call against the reference's loss of
        that token. The number compared is the root mean square of the gaps:
        the widest gap, and the widest gap of a row's mean, do not separate
        the program's int8 path from its sound runs by three times (PERF.md)."""
        ref = self.cell.reference()
        params = cells.make_params(self.cell, self.seed, self.device)
        tree = cells.rebuild(self.cell.family.layout(self.cell.config),
                              {k: v.float() for k, v in cells.flatten(params).items()})
        del params
        gaps = []
        for i in self.sample(win["records"]):
            T, _, _, values, r = win["records"][i]
            want = ref.token_losses(tree, *self.batch(T, r), self.cell.config)
            if values.shape != want.shape:
                return {"token_gap_rms": float("inf"),
                        "_detail": {"shape": list(values.shape), "reference_shape": list(want.shape)}}
            gaps.append((values - want).double())
        d = torch.cat([g.flatten() for g in gaps])
        rows = torch.cat([g.mean(1) for g in gaps])
        return {"token_gap_rms": d.pow(2).mean().sqrt().item(),
                "_detail": {"tokens_checked": d.numel(), "longest_T": max(g.shape[1] for g in gaps),
                            "token_gap_max": d.abs().max().item(), "row_mean_gap_max": rows.abs().max().item(),
                            "mean_signed_gap": d.mean().item()}}

    # -- what the metrics read ------------------------------------------------

    def end_to_end(self, win: dict) -> dict:
        recs = win["records"]
        tokens = sum(self.B * rec[0] for rec in recs)
        lat = sorted(rec[1] for rec in recs)
        p95 = statistics.quantiles(lat, n=20, method="inclusive")[18] if len(lat) > 1 else lat[0]
        return {"score_tokens_per_s": ("tokens/s", tokens / win["elapsed_s"]),
                "score_p95_ms": ("ms", p95 * 1e3)}
